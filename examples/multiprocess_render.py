"""REAL multi-process distributed rendering (SURVEY.md §2.10 row 8).

Launches N worker processes (default 2) that initialize
``jax.distributed`` over a local coordinator, build a
``DistributedSplatter`` with ``from_process_local`` — each process
contributes only its own particle rows via
``jax.make_array_from_process_local_data`` — and render through the
particle-sharded psum step.  ``ensure_presorted`` runs the AUTOMATIC
multi-host padded-length negotiation (allgather-max over the gloo
backend), the exact code path the hosts of a multi-host cluster take.

The launcher then renders the same scene single-process and checks the
multi-process images match (psum is a sum — exact up to float summation
order for the presorted path, bit-equal for the block path).

Usage:
  python examples/multiprocess_render.py [n_particles] [n_processes]

Run on CPU (multi-process needs one device per process).  Everything here
works unchanged across hosts: replace the local coordinator with the
cluster's; only the slab assembly crosses the host network.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

N_DEFAULT = 200_000
RES = 256
SCALE = 50.0
SEED = 1337
PORT = int(os.environ.get("TOPSY_TPU_MP_PORT", "29871"))
OUT = os.environ.get("TOPSY_TPU_MP_OUT", "/tmp/topsy_tpu_mp_render.npz")
MIP_FLOOR = 1000  # low floor so even small test scenes build a mip tier


def _scene(n):
    from topsy_tpu import camera
    from topsy_tpu.loaders import TestDataLoader
    loader = TestDataLoader(n, seed=SEED)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    vals = np.stack([mass, mass * qty], axis=1)
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), SCALE)
    return ps, vals, matrix


def worker(pid: int, nproc: int, n: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    from topsy_tpu.parallel import DistributedSplatter, make_mesh, strided_shard

    from topsy_tpu import config
    config.COLUMN_MIP_FLOOR_TARGET = MIP_FLOOR  # force >=1 decimation tier

    ps, vals, matrix = _scene(n)
    mesh = make_mesh()
    D = jax.device_count()
    # rows owned by this process's devices: position in the global device
    # order (device .id values are process-scoped ranges, not 0..D-1)
    ps_s = strided_shard(ps, D)
    vals_s = strided_shard(vals, D)
    keep = [i for i, d in enumerate(jax.devices())
            if d.process_index == pid]
    assert keep, "no local devices for this process"
    ds = DistributedSplatter.from_process_local(
        mesh, ps_s[keep].reshape(-1, 4), vals_s[keep].reshape(-1, 2),
        RES, len(ps))

    im_block = np.asarray(ds.render(matrix, SCALE))

    # the sort-free path: per-process (bucket, Morton) slabs; the padded
    # slab length is negotiated automatically over the collective backend
    ds.ensure_presorted()
    assert ds.supports_presorted()
    im_pre, dropped = ds.render_presorted(matrix, SCALE)
    im_pre = np.asarray(im_pre)
    assert int(np.asarray(dropped)) == 0

    # forced decimation-mip tier: deepest tier's whole-column render —
    # exercises the negotiated mip slabs across processes
    mips = ds.presorted_mip_layouts()
    assert mips, "mip floor did not force a decimation tier"
    im_mip, dropped_m = ds.render_columns(matrix, SCALE, 0,
                                          mips[0].pad_group, tier=0)
    im_mip = np.asarray(im_mip)
    # global tier size (per-process subsamples): allgather-sum of the
    # local tier reals, for the launcher's photometric check
    from jax.experimental import multihost_utils
    mip_reals = int(np.sum(multihost_utils.process_allgather(
        np.asarray(mips[0].n_real, dtype=np.int64))))

    if pid == 0:
        np.savez(OUT, block=im_block, pre=im_pre,
                 mip=im_mip, mip_frac=mip_reals / n, n=n, nproc=nproc)
    print(json.dumps({"pid": pid, "devices": D,
                      "block_sum": float(im_block[..., 0].sum()),
                      "pre_sum": float(im_pre[..., 0].sum()),
                      "mip_sum": float(im_mip[..., 0].sum())}), flush=True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT
    nproc = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(pid), str(nproc), str(n)])
        for pid in range(nproc)]
    for p in procs:
        assert p.wait() == 0, "worker failed"

    # single-process reference on an nproc-device mesh (virtual devices)
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={nproc}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from topsy_tpu import config
    from topsy_tpu.parallel import DistributedSplatter, make_mesh
    config.COLUMN_MIP_FLOOR_TARGET = MIP_FLOOR

    ps, vals, matrix = _scene(n)
    ds = DistributedSplatter(make_mesh(nproc), ps, vals, RES)
    ref_block = np.asarray(ds.render(matrix, SCALE))
    got = np.load(OUT)
    # same shards, but the cross-process allreduce (gloo) may sum in a
    # different order than the single-process XLA reduction — float last
    # bits only
    np.testing.assert_allclose(got["block"], ref_block, rtol=1e-5,
                               atol=1e-7 * np.abs(ref_block).max())
    ds.ensure_presorted()
    ref_pre, _ = ds.render_presorted(matrix, SCALE)
    ref_pre = np.asarray(ref_pre)
    np.testing.assert_allclose(got["pre"], ref_pre, rtol=1e-3,
                               atol=1e-5 * np.abs(ref_pre).max())
    # the mip tier is a RANDOM fair subsample per layout build, so the
    # 2-process tier (per-process subsamples) and the single-process tier
    # select different particles — images are not comparable pixelwise.
    # Check photometric consistency instead: the tier holds a known
    # fraction of the snapshot and mass deposition is conserved, so the
    # tier's total mass must match that fraction of the full render.
    mips = ds.presorted_mip_layouts()
    assert mips, "mip floor did not force a decimation tier"
    mip_img = got["mip"]
    assert np.isfinite(mip_img).all() and mip_img[..., 0].sum() > 0
    frac = float(got["mip_frac"])
    assert 0 < frac < 0.5, frac
    got_mass = float(mip_img[..., 0].sum())
    want_mass = float(ref_pre[..., 0].sum()) * frac
    assert abs(got_mass - want_mass) < 0.1 * want_mass, \
        f"mip tier mass {got_mass} vs expected {want_mass}"
    print(f"PASS: {nproc}-process render matches single-process "
          f"({n} particles, {RES}x{RES}; block/presorted + mip tier "
          f"photometry)")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
