"""Write the text table of ``gims_tpu_torch/core/text_glyphs.py`` from OpenCV.

OpenCV 5 draws ``FONT_HERSHEY_SIMPLEX`` with its embedded TrueType face
(Rubik), not with Hershey strokes: every glyph is an 8-bit coverage bitmap
placed at an integer pen position, advances carry no kerning, thickness 1 is
one weight and every thickness from 2 up another, and ``LINE_8`` draws the
same coverage as ``LINE_AA``. This script renders each printable ASCII
character alone at ``fontScale`` 1 in both weights and at 0.7 in the bold
weight (the image viewer's labels), reads its bitmap, its offset from the
pen and its advance (from the pen position of a following glyph), checks
the model on strings against ``cv2.putText`` and ``cv2.getTextSize``, and
writes the tables. Needs cv2; the port does not.

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


# (fontScale, thickness, table name): the tables the port carries
TABLES = ((1, 1, "REGULAR"), (1, 2, "BOLD"), (0.7, 2, "BOLD_0_7"))


def render(text, thickness, scale=1, width=200):
    img = np.zeros((100, width), np.uint8)
    cv2.putText(img, text, (OX, OY), FONT, scale, 255, thickness)
    return img


def weight_table(thickness, scale=1):
    glyphs = {}
    for c in CHARS:
        img = render(c, thickness, scale)
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
        img = render(c + probe, thickness, scale)
        xs = np.nonzero(img.any(0))[0]
        right = xs.max() - (glyphs[probe][2].shape[1] - 1)
        advances.append(int(right - x_alone))
    return advances, glyphs


def draw(text, advances, glyphs, width=400):
    """The port's model of putText: each glyph blended at its pen position."""
    img = np.zeros((100, width), np.int32)
    pen = OX
    for c in text:
        gx, gy, bitmap = glyphs[c]
        if bitmap.size:
            a = bitmap.astype(np.int32)
            region = img[OY + gy:OY + gy + a.shape[0], pen + gx:pen + gx + a.shape[1]]
            region[...] = (region * (255 - a) + 255 * a + 127) // 255
        pen += advances[ord(c) - 32]
    return img.astype(np.uint8)


def check(advances, glyphs, thickness, scale, height):
    """The model against cv2 on strings, and thickness 3 against 2."""
    rng = np.random.RandomState(0)
    texts = ["f1", "folder_A", "Hello World 0.7!"] + [
        "".join(rng.choice(CHARS[1:], 12)) for _ in range(100)]
    for t in texts:
        assert np.array_equal(render(t, thickness, scale, 400), draw(t, advances, glyphs)), t
        if thickness == 2:
            assert np.array_equal(render(t, 3, scale, 400), render(t, 2, scale, 400)), t
        (w, h), _ = cv2.getTextSize(t, FONT, scale, thickness)
        assert (w, h) == (sum(advances[ord(c) - 32] for c in t) + 1, height), t


def main():
    lines = ['"""FONT_HERSHEY_SIMPLEX as OpenCV 5 draws it: a coverage bitmap, its offset',
             "from the pen and an advance per printable ASCII character, at fontScale 1",
             "for thickness 1 (REGULAR) and 2 and up (BOLD), and at 0.7 for 2 and up",
             "(BOLD_0_7). ``SCALES`` maps a fontScale to cv2.getTextSize's height and",
             "the names of its regular and bold tables (None: not carried).",
             "",
             "Written by ``scripts/extract_text_glyphs.py`` from ``cv2.putText`` renders;",
             "do not edit by hand. Each entry of ``*_OFFSETS`` is (x, y, height, width)",
             "of the bitmap relative to the pen on the baseline; ``*_BITMAPS`` holds the",
             'bitmaps in order, row-major, zlib-compressed and base64-encoded."""',
             ""]
    scales = {}
    for scale, thickness, name in TABLES:
        advances, glyphs = weight_table(thickness, scale)
        height = cv2.getTextSize("H", FONT, scale, thickness)[0][1]
        check(advances, glyphs, thickness, scale, height)
        entry = scales.setdefault(scale, [height, None, None])
        entry[1 if thickness == 1 else 2] = name
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
    lines.append(f"SCALES = {({k: tuple(v) for k, v in scales.items()})!r}")
    lines.append("")
    OUT.write_text("\n".join(lines))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
