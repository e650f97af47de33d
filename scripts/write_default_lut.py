"""Write topsy_tpu/color/default_lut.py: the colour table of the default
colormap (config.DEFAULT_COLORMAP), so the default render path needs no
matplotlib.

Usage (needs matplotlib):  python scripts/write_default_lut.py
"""

from __future__ import annotations

import os
import sys

import matplotlib
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from topsy_tpu import config  # noqa: E402

OUT = os.path.join(REPO, "topsy_tpu", "color", "default_lut.py")


def main():
    name = config.DEFAULT_COLORMAP
    cmap = matplotlib.colormaps[name]
    if not isinstance(cmap, matplotlib.colors.ListedColormap):
        raise TypeError(f"{name} is not a ListedColormap")
    colors = np.asarray(cmap.colors, dtype=np.float64)[:, :3]
    lines = [f'"""Colour table of matplotlib\'s {name!r} colormap '
             f'({matplotlib.__version__}).',
             "",
             "Written by scripts/write_default_lut.py; do not edit by hand.",
             '"""',
             "",
             f"NAME = {name!r}",
             "",
             "RGB = ("]
    lines += [f"    ({float(r)!r}, {float(g)!r}, {float(b)!r}),"
              for r, g, b in colors]
    lines += [")", ""]
    with open(OUT, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {OUT}: {len(colors)} colours")


if __name__ == "__main__":
    main()
