"""Write ``gims_tpu_torch/core/viridis.py``: matplotlib's viridis colormap as
256 RGB byte triples, the bytes ``Colormap(x, bytes=True)`` gives for
x = i / 255. The port draws its report's plots without matplotlib
(``gims_tpu_torch/tools/parameter_visualize.py``); this script needs it.

    python scripts/extract_viridis.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from matplotlib import colormaps

OUT = Path(__file__).resolve().parents[1] / "gims_tpu_torch" / "core" / "viridis.py"


def main():
    rgb = colormaps["viridis"](np.arange(256), bytes=True)[:, :3]
    rows = [", ".join(f"({r}, {g}, {b})" for r, g, b in rgb[i:i + 6].tolist())
            for i in range(0, 256, 6)]
    lines = ['"""matplotlib\'s viridis colormap: 256 RGB byte triples, entry i for',
             "x = i / 255 (``Colormap(x, bytes=True)``).",
             "",
             "Written by ``scripts/extract_viridis.py`` from matplotlib; do not edit by",
             'hand."""',
             "",
             "VIRIDIS = ("]
    lines += [f"    {r}," for r in rows]
    lines += [")", ""]
    OUT.write_text("\n".join(lines))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
