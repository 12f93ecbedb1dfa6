"""The drawings (``gims_tpu_torch/core/drawing.py``, ``eval/viz.py``) against
OpenCV and the JAX package's ``gims_tpu/eval/viz.py`` on the CPU.

Each primitive is held to the cv2 call that ``gims_tpu/eval/viz.py`` makes,
pixel for pixel, on seeded endpoints that include points off the image:
``cv2.line`` (thickness 1), ``cv2.circle`` (filled, radius 2; any radius,
filled or of thickness 1), ``cv2.rectangle`` (filled and thickness 1),
``cv2.polylines`` (closed, thickness 3; 2 to 5 open and closed),
``cv2.getTextSize`` for every printable character and the strings the JAX
package draws, and ``cv2.putText`` of FONT_HERSHEY_SIMPLEX at fontScale 1
(LINE_8 and LINE_AA, thickness 1 and 2, on random backgrounds). Then
``draw_matches`` and ``draw_homography_boxes`` against JAX's, whole
images.
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest

from gims_tpu.eval import viz as jviz
from gims_tpu_torch.core import drawing
from gims_tpu_torch.eval import viz as tviz
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINTABLE = "".join(chr(c) for c in range(32, 127))
FONT = cv2.FONT_HERSHEY_SIMPLEX


def canvas(rng, h, w, channels=3):
    return rng.randint(0, 256, (h, w, channels) if channels else (h, w)).astype(np.uint8)


@pytest.mark.parametrize("seed", range(3))
def test_line_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(400):
        h, w = rng.randint(3, 70, 2)
        a = tuple(int(v) for v in rng.randint(-90, 140, 2))
        b = tuple(int(v) for v in rng.randint(-90, 140, 2))
        img = canvas(rng, h, w, int(rng.choice([0, 3])))
        want, got = img.copy(), img.copy()
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        cv2.line(want, a, b, color, 1)
        drawing.line(got, a, b, color, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {a} {b}")


def test_circles_and_rectangles_equal_cv2():
    rng = np.random.RandomState(7)
    for _ in range(600):
        h, w = rng.randint(3, 50, 2)
        img = canvas(rng, h, w)
        c = tuple(int(v) for v in rng.randint(-6, 56, 2))
        r = int(rng.choice([2, 2, rng.randint(0, 9)]))
        th = int(rng.choice([-1, 1]))
        want, got = img.copy(), img.copy()
        cv2.circle(want, c, r, (0, 255, 0), th)
        drawing.circle(got, c, r, (0, 255, 0), th)
        np.testing.assert_array_equal(got, want)
        p, q = (tuple(int(v) for v in rng.randint(-20, 70, 2)) for _ in range(2))
        cv2.rectangle(want, p, q, (255, 255, 255), th)
        drawing.rectangle(got, p, q, (255, 255, 255), th)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness", [2, 3, 4, 5])
def test_polylines_equal_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for _ in range(120):
        h, w = rng.randint(20, 120), rng.randint(20, 160)
        pts = rng.randint(-80, 220, (rng.randint(2, 6), 2)).astype(np.int32)
        closed = bool(rng.randint(2))
        img = canvas(rng, h, w)
        want, got = img.copy(), img.copy()
        cv2.polylines(want, [pts], closed, (255, 0, 0), thickness)
        drawing.polylines(got, [pts], closed, (255, 0, 0), thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_text_size_equals_cv2(thickness):
    strings = list(PRINTABLE) + ["", "Matches: 0", "Matches: 12345", "error_ransac: 1.23",
                                 "error_ransac: 123.45", PRINTABLE]
    for text in strings:
        assert drawing.get_text_size(text, drawing.FONT_HERSHEY_SIMPLEX, 1, thickness) == \
            cv2.getTextSize(text, FONT, 1, thickness), repr(text)


@pytest.mark.parametrize("line_type", [drawing.LINE_8, drawing.LINE_AA])
def test_put_text_equals_cv2(line_type):
    rng = np.random.RandomState(line_type)
    for _ in range(120):
        text = "".join(rng.choice(list(PRINTABLE), rng.randint(1, 24)))
        thickness = int(rng.choice([1, 2, 3]))
        h, w = rng.randint(10, 90), rng.randint(10, 320)
        img = canvas(rng, h, w, int(rng.choice([0, 3])))
        org = (int(rng.randint(-30, w)), int(rng.randint(-10, h + 30)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want, got = img.copy(), img.copy()
        cv2.putText(want, text, org, FONT, 1, color, thickness, line_type)
        drawing.put_text(got, text, org, drawing.FONT_HERSHEY_SIMPLEX, 1, color, thickness,
                         line_type)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))


def test_text_outside_the_table_raises():
    img = np.zeros((40, 40, 3), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        drawing.put_text(img, "x", (0, 30), drawing.FONT_HERSHEY_SIMPLEX, 2, (0, 0, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        drawing.get_text_size("é", drawing.FONT_HERSHEY_SIMPLEX, 1, 1)


def test_glyph_table_is_what_the_script_reads_from_cv2():
    """core/text_glyphs.py holds what scripts/extract_text_glyphs.py reads
    from this cv2's renders."""
    path = os.path.join(REPO, "scripts", "extract_text_glyphs.py")
    spec = importlib.util.spec_from_file_location("extract_text_glyphs", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for thickness in (1, 2):
        advances, glyphs = script.weight_table(thickness)
        t_adv, t_glyphs = drawing._glyph_table(thickness)
        assert advances == list(t_adv)
        for c, (x, y, bitmap) in zip(script.CHARS, t_glyphs):
            gx, gy, gb = glyphs[c]
            assert (gx, gy) == (x, y) and np.array_equal(gb, bitmap), repr(c)


def test_ensure_color_equals_jax():
    gray = np.random.RandomState(1).randint(0, 256, (9, 11)).astype(np.uint8)
    np.testing.assert_array_equal(tviz.ensure_color(gray), jviz.ensure_color(gray))
    colour = np.dstack([gray] * 3)
    assert tviz.ensure_color(colour) is colour


@pytest.mark.parametrize("n", [0, 7, 600])
def test_draw_matches_equals_jax(n):
    rng = np.random.RandomState(n)
    img0 = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    img1 = rng.randint(0, 256, (100, 150)).astype(np.uint8)  # gray, shorter
    p0 = rng.uniform(-5, 165, (n, 2)).astype(np.float32)
    p1 = rng.uniform(-5, 155, (n, 2)).astype(np.float32)
    got = tviz.draw_matches(img0, img1, p0, p1)
    want = jviz.draw_matches(img0, img1, p0, p1)
    np.testing.assert_array_equal(got, want)


def test_draw_homography_boxes_equals_jax(capsys):
    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (120, 320, 3)).astype(np.uint8)
    h_gt = np.array([[1.05, 0.02, 3.0], [-0.01, 0.98, 2.0], [1e-4, 2e-5, 1.0]], np.float32)
    h_est = np.array([[0.9, 0.1, -40.0], [0.05, 1.2, 30.0], [-2e-4, 1e-3, 1.0]])
    for gt, est, text in ((h_gt, h_est, "error_ransac: 1.23"), (h_gt, None, None),
                          (None, h_est, "error_ransac: 99.99")):
        got = tviz.draw_homography_boxes(base.copy(), 160, gt, est, text)
        want = jviz.draw_homography_boxes(base.copy(), 160, gt, est, text)
        np.testing.assert_array_equal(got, want)
    capsys.readouterr()
    # a failure is swallowed with the same warning, the image returned as it is
    tviz.draw_homography_boxes(base.copy(), 160, np.eye(2), None)
    got_out = capsys.readouterr().out
    jviz.draw_homography_boxes(base.copy(), 160, np.eye(2), None)
    want_out = capsys.readouterr().out
    assert got_out.startswith("[warn] drawing homography boxes failed:")
    assert want_out.startswith("[warn] drawing homography boxes failed:")
