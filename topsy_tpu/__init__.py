"""topsy_tpu — an accelerator-native SPH/N-body particle visualization
framework.

A ground-up JAX/XLA rebuild of the capabilities of pynbody/topsy: the
rasterizer pipeline becomes tiled matmul splatting, progressive LOD becomes
contiguous prefix ranges over an interleaved particle order, and multi-chip
scaling shards the particle axis with partial framebuffers reduced over the
device mesh.

CLI/API surface mirrors the reference (reference: src/topsy/__init__.py):
``load()``, ``topsy()``, ``test()``, ``parse_args()`` with ``+``-separated
multi-window batches and the ``test://N`` synthetic-data scheme.
"""

from __future__ import annotations

__version__ = "0.1.0"

import argparse
import logging
import sys
from typing import TYPE_CHECKING

from . import config  # noqa: F401

if TYPE_CHECKING:
    from .visualizer import Visualizer

logger = None


def parse_args(args=None):
    """Parse CLI arguments into per-window batches separated by '+'
    (reference: __init__.py:21-69)."""
    argparser = argparse.ArgumentParser(
        description="Visualize an astrophysics simulation. Multiple "
                    "windows can be opened by separating groups of arguments "
                    "with +.")
    argparser.add_argument("filename",
                           help="Path to a simulation file, or test://N for "
                                "synthetic data with N particles")
    argparser.add_argument("--resolution", "-r", type=int,
                           default=config.DEFAULT_RESOLUTION,
                           help="Resolution of the visualization")
    argparser.add_argument("--colormap", "-m", type=str,
                           default=config.DEFAULT_COLORMAP,
                           help="Matplotlib colormap to use")
    argparser.add_argument("--particle", "-p", type=str, default="dm",
                           help="Particle type to visualise")
    argparser.add_argument("--center", "-c", type=str, default="none",
                           help="Centering method: 'halo-<N>', 'all', 'zoom' "
                                "or 'none'")
    argparser.add_argument("--quantity", "-q", type=str, default=None,
                           help="Quantity to render instead of density")
    argparser.add_argument("--tile", "-t", action="store_true", default=False,
                           help="Wrap and tile the simulation box periodically")
    argparser.add_argument("--render-mode", dest="render_mode",
                           default="univariate",
                           choices=["univariate", "bivariate", "rgb", "rgb-hdr",
                                    "surface"],
                           help="Rendering mode")
    argparser.add_argument("--load-sphere", nargs="+", metavar="_", type=float,
                           default=None,
                           help="Load a sphere of particles: radius "
                                "[, cx cy cz] in simulation units")

    if args is None:
        args = sys.argv[1:]
    arg_batches = []
    while len(args) > 0:
        try:
            split_index = args.index("+")
        except ValueError:
            split_index = len(args)
        this_args = argparser.parse_args(args[:split_index])
        if this_args.load_sphere is not None and len(this_args.load_sphere) not in (1, 4):
            argparser.error("Invalid number of arguments for --load-sphere. "
                            "Must be 1 or 4.")
        arg_batches.append(this_args)
        args = args[split_index + 1:]
    return arg_batches


def setup_logging():
    global logger
    if logger is not None:
        return
    logger = logging.getLogger(__name__)
    logger.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.DEBUG)
    ch.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(ch)


def main():
    all_args = parse_args()
    visualizers = []
    for args in all_args:
        vis = load(args.filename, center=args.center, resolution=args.resolution,
                   particle=args.particle, tile=args.tile,
                   sphere_radius=(args.load_sphere[0]
                                  if args.load_sphere is not None else None),
                   sphere_center=(tuple(args.load_sphere[1:])
                                  if args.load_sphere is not None
                                  and len(args.load_sphere) == 4 else None),
                   render_mode=args.render_mode,
                   colormap_name=args.colormap)
        vis.quantity_name = args.quantity
        vis.canvas.show()
        visualizers.append(vis)

    from .canvas import run_event_loop
    run_event_loop(visualizers)


def topsy(snapshot, quantity: str | None = None, **kwargs) -> "Visualizer":
    """Visualize an already-loaded pynbody snapshot (reference:
    __init__.py:100-107)."""
    from . import loaders, visualizer
    vis = visualizer.Visualizer(data_loader_class=loaders.PynbodyDataInMemory,
                                data_loader_args=(snapshot,), **kwargs)
    vis.quantity_name = quantity
    return vis


def load(filename: str, center: str = "none", particle: str = "gas",
         resolution: int = config.DEFAULT_RESOLUTION, tile: bool = False,
         sphere_radius: float | None = None,
         sphere_center: tuple[float, float, float] | None = None,
         render_mode: str | None = None, **kwargs) -> "Visualizer":
    """Load a simulation file (or test://N synthetic data) into a Visualizer.

    Mirrors the reference loader entry point (reference: __init__.py:109-178).
    """
    from . import loaders, visualizer
    setup_logging()

    if "test://" in filename:
        loader_class = loaders.TestDataLoader
        try:
            n_part = int(float(filename[7:]))
        except ValueError:
            n_part = config.TEST_DATA_NUM_PARTICLES_DEFAULT
        logger.info("Using test data with %d particles", n_part)
        loader_args = (n_part,)
    else:
        import pynbody
        loader_class = loaders.PynbodyDataLoader
        if sphere_radius is not None:
            if sphere_center is not None:
                region = pynbody.filt.Sphere(sphere_radius, sphere_center)
            else:
                region = pynbody.filt.Sphere(sphere_radius)
            loader_args = (filename, center, particle, region)
        else:
            loader_args = (filename, center, particle)

    return visualizer.Visualizer(data_loader_class=loader_class,
                                 data_loader_args=loader_args,
                                 periodic_tiling=tile,
                                 render_resolution=resolution,
                                 render_mode=render_mode, **kwargs)


def test(nparticle=config.TEST_DATA_NUM_PARTICLES_DEFAULT, **kwargs) -> "Visualizer":
    """Synthetic-data visualizer for tests and demos (reference:
    __init__.py:180-187)."""
    from . import loaders, visualizer
    return visualizer.Visualizer(
        data_loader_class=loaders.TestDataLoader,
        data_loader_args=(nparticle,),
        data_loader_kwargs={"with_cells": kwargs.pop("with_cells", False),
                            "periodic": kwargs.get("periodic_tiling", False)},
        **kwargs)


_force_is_jupyter = False


def is_jupyter():
    """Whether we are executing inside a Jupyter notebook/lab."""
    global _force_is_jupyter
    if _force_is_jupyter:
        return True
    from .util import is_jupyter as _isj
    return _isj()


def force_jupyter():
    """Force is_jupyter() to return True (used in testing)."""
    global _force_is_jupyter
    _force_is_jupyter = True
