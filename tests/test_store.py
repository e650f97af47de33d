"""Particle store tests: the bucketed dynamic-range machinery that replaces
the reference's split buffers (modelled on tests/test_split_buffers.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.render.store import (MAX_BUCKET, MIN_BUCKET, ParticleStore,
                                    bucket_size)


def test_bucket_size_rules():
    assert bucket_size(1, 10**9) == MIN_BUCKET
    assert bucket_size(MIN_BUCKET, 10**9) == MIN_BUCKET
    assert bucket_size(MIN_BUCKET + 1, 10**9) == 2 * MIN_BUCKET
    assert bucket_size(10**9, 10**9) == MAX_BUCKET  # per-launch cap
    assert bucket_size(10**9, 5000) == 5000         # clamped to array size


def test_block_piecing_covers_range():
    """Blocks larger than a bucket are pieced; pieces tile the range."""
    l = MAX_BUCKET * 2 + 12345
    bucket = bucket_size(l, 10**9)
    pieces = [(p, min(bucket, l - p)) for p in range(0, l, bucket)]
    assert sum(n for _, n in pieces) == l
    cursor = 0
    for start, n in pieces:
        assert start == cursor
        cursor += n


@pytest.fixture(scope="module")
def store():
    return ParticleStore(TestDataLoader(3000, with_cells=True))


def test_store_padding_and_shapes(store):
    assert store.n == 3000
    assert store.n_pad % 512 == 0 and store.n_pad >= 3000
    assert store.pos_smooth.shape == (store.n_pad, 4)
    assert store.mass_and_quantity.shape == (store.n_pad, 2)
    # padding rows are zero (they mask out anyway)
    assert float(jnp.abs(store.pos_smooth[store.n:]).sum()) == 0.0


def test_quantity_rebuild_and_version(store):
    v0 = store.values_version
    store.quantity_name = "test-quantity"
    assert store.values_version == v0 + 1
    mq = np.asarray(store.mass_and_quantity[:store.n])
    loader = store._loader
    np.testing.assert_allclose(
        mq[:, 1], loader.get_mass() * loader.get_named_quantity("test-quantity"),
        rtol=1e-6)
    store.quantity_name = "test-quantity"  # no-op
    assert store.values_version == v0 + 1
    store.quantity_name = None
    assert np.asarray(store.mass_and_quantity[:store.n, 1]).max() == 0.0


def test_cell_mask_table(store):
    assert store.cell_mask_table(None).shape == (store.n_cells,)
    mask = np.zeros(store.n_cells, dtype=bool)
    mask[0] = True
    table = store.cell_mask_table(mask)
    assert bool(table[0]) and not bool(table[1])
