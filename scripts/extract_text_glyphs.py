"""Write the text table of ``gims_tpu_torch/core/text_glyphs.py`` from OpenCV.

OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` with its embedded TrueType face
(Rubik), not with Hershey strokes: every glyph is an 8-bit coverage bitmap
placed at an integer pen position, advances carry no kerning, thickness 1 is
one weight and every thickness from 2 up another, and ``LINE_8`` draws the
same coverage as ``LINE_AA``. This script renders each printable ASCII
character alone at ``fontScale`` 1 in both weights, reads its bitmap, its
offset from the pen and its advance (from the pen position of a following
glyph), checks the model on strings against ``cv2.putText`` and
``cv2.getTextSize``, and writes the table. Needs cv2; the port does not.

    python scripts/extract_text_glyphs.py
"""

from __future__ import annotations

import base64
import zlib
from pathlib import Path

import cv2
import numpy as np

FONT = cv2.FONT_HERSHEY_SIMPLEX
CHARS = [chr(c) for c in range(32, 127)]
OX, OY = 40, 60
OUT = Path(__file__).resolve().parents[1] / "gims_tpu_torch" / "core" / "text_glyphs.py"


def render(text, thickness, width=200):
    img = np.zeros((100, width), np.uint8)
    cv2.putText(img, text, (OX, OY), FONT, 1, 255, thickness)
    return img


def weight_table(thickness):
    glyphs = {}
    for c in CHARS:
        img = render(c, thickness)
        ys, xs = np.nonzero(img)
        if len(xs) == 0:
            glyphs[c] = (0, 0, np.zeros((0, 0), np.uint8))
            continue
        glyphs[c] = (int(xs.min()) - OX, int(ys.min()) - OY,
                     img[ys.min():ys.max() + 1, xs.min():xs.max() + 1].copy())
    # the advance of c: where "cX" puts X's bitmap, less where "X" alone puts it
    probe = "H"
    x_alone = OX + glyphs[probe][0]
    advances = []
    for c in CHARS:
        img = render(c + probe, thickness)
        xs = np.nonzero(img.any(0))[0]
        right = xs.max() - (glyphs[probe][2].shape[1] - 1)
        advances.append(int(right - x_alone))
    return advances, glyphs


def main():
    lines = ['"""FONT_HERSHEY_SIMPLEX at fontScale 1 as OpenCV 5 draws it: a coverage',
             "bitmap, its offset from the pen and an advance per printable ASCII",
             "character, for thickness 1 (REGULAR) and 2 and up (BOLD).",
             "",
             "Written by ``scripts/extract_text_glyphs.py`` from ``cv2.putText`` renders;",
             "do not edit by hand. Each entry of ``*_OFFSETS`` is (x, y, height, width)",
             "of the bitmap relative to the pen on the baseline; ``*_BITMAPS`` holds the",
             'bitmaps in order, row-major, zlib-compressed and base64-encoded."""',
             ""]
    for name, thickness in (("REGULAR", 1), ("BOLD", 2)):
        advances, glyphs = weight_table(thickness)
        offsets = [(g[0], g[1], g[2].shape[0], g[2].shape[1]) for g in (glyphs[c] for c in CHARS)]
        blob = b"".join(glyphs[c][2].tobytes() for c in CHARS)
        packed = base64.b64encode(zlib.compress(blob, 9)).decode()
        lines.append(f"{name}_ADVANCES = {advances!r}")
        lines.append(f"{name}_OFFSETS = {offsets!r}")
        chunks = [packed[i:i + 76] for i in range(0, len(packed), 76)]
        lines.append(f"{name}_BITMAPS = (")
        lines.extend(f'    "{c}"' for c in chunks)
        lines.append(")")
        lines.append("")
    OUT.write_text("\n".join(lines))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
