"""Match drawings without OpenCV: the port of ``gims_tpu/eval/viz.py``
(reference: eval_homography.py:17-105), drawn with ``core/drawing.py``.

Same signatures and colours as the JAX package: red match lines, green and
blue filled circles of radius 2, the "Matches: N" label on a white bar, the
ground-truth (blue) and estimated (red) homography boxes of thickness 3 and
the error text in green.
"""

from __future__ import annotations

import numpy as np

from gims_tpu_torch.core import drawing
from gims_tpu_torch.core.imgproc import perspective_transform


def ensure_color(img):
    if img.ndim == 2:
        img = drawing.gray_to_bgr(img)
    return img


def draw_matches(img1, img2, matched_points1, matched_points2):
    img1, img2 = ensure_color(img1), ensure_color(img2)
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]
    out = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
    out[:h1, :w1] = img1
    out[:h2, w1:w1 + w2] = img2
    for p1, p2 in zip(matched_points1, matched_points2):
        a = (int(p1[0]), int(p1[1]))
        b = (int(p2[0] + w1), int(p2[1]))
        drawing.line(out, a, b, (0, 0, 255), 1)
        drawing.circle(out, a, 2, (0, 255, 0), -1)
        drawing.circle(out, b, 2, (255, 0, 0), -1)
    text = f"Matches: {len(matched_points1)}"
    (tw, th), _ = drawing.get_text_size(text, drawing.FONT_HERSHEY_SIMPLEX, 1, 2)
    drawing.rectangle(out, (10, 40), (10 + tw, 30 - th - 10), (255, 255, 255), drawing.FILLED)
    drawing.put_text(out, text, (10, 30), drawing.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 0), 2)
    return out


def draw_homography_boxes(result_image, w0, homo_gt, homo_est, error_text=None):
    try:
        h, w = result_image.shape[:2]
        corners = np.array([[0, 0], [0, h], [w - w0, h], [w - w0, 0]], np.float32).reshape(-1, 1, 2)
        offset = np.array([[[w0, 0]]], np.float32)
        if homo_gt is not None:
            box = perspective_transform(corners, homo_gt) + offset
            drawing.polylines(result_image, [box.astype(np.int32)], True, (255, 0, 0), 3)
        if homo_est is not None:
            box = perspective_transform(corners, homo_est) + offset
            drawing.polylines(result_image, [box.astype(np.int32)], True, (0, 0, 255), 3)
        if error_text is not None:
            drawing.put_text(result_image, error_text, (w0 + 10, 30),
                             drawing.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2, drawing.LINE_AA)
    except Exception as e:  # noqa: BLE001
        print(f"[warn] drawing homography boxes failed: {e}")
    return result_image
