"""``gims_tpu_torch/frontend/nms.py`` against ``gims_tpu/frontend/nms.py``:
JAX's cases (``tests/test_utils_extra.py:58-97``) and 200 seeded random
boxes, the kept sets and their order equal (float32 DIoU in both, no
tolerance); rootSIFT within 1e-6 (float32 sums in another order); the
streamer's frames equal to the byte (PNG read, INTER_AREA resize).
"""

import cv2
import numpy as np
import pytest
import torch

from gims_tpu.frontend import nms as jnms
from gims_tpu_torch.frontend import nms
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def test_root_sift_equals_jax():
    d = np.abs(np.random.RandomState(0).rand(5, 128).astype(np.float32))
    for l2 in (False, True):
        want = jnms.root_sift(d.copy(), l2norm=l2)
        np.testing.assert_allclose(nms.root_sift(d.copy(), l2norm=l2), want, atol=1e-6)
        np.testing.assert_allclose(nms.root_sift(torch.from_numpy(d), l2norm=l2).numpy(), want,
                                   atol=1e-6)


def test_diou_nms_jax_case():
    dets = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got = nms.diou_nms(torch.from_numpy(dets), torch.from_numpy(scores), iou_thresh=0.3)
    assert np.array_equal(got.numpy(), jnms.diou_nms(dets, scores, iou_thresh=0.3))
    assert len(got) == 2


@pytest.mark.parametrize("seed,thresh", [(0, 0.3), (1, 0.5), (2, None), (3, 0.1)])
def test_diou_nms_random_boxes_equal_jax(seed, thresh):
    rng = np.random.RandomState(seed)
    xy = rng.rand(200, 2).astype(np.float32) * 300
    wh = rng.rand(200, 2).astype(np.float32) * 40 + 2
    dets = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(200).astype(np.float32)
    want = jnms.diou_nms(dets, scores, iou_thresh=thresh)
    got = nms.diou_nms(torch.from_numpy(dets), torch.from_numpy(scores), iou_thresh=thresh)
    assert np.array_equal(got.numpy(), want)
    assert 0 < len(want) < 200


def _cv_keypoints(xy, size, response):
    out = []
    for (x, y), s, r in zip(xy, size, response):
        k = cv2.KeyPoint(float(x), float(y), float(s))
        k.response = float(r)
        out.append(k)
    return out


def test_nms_keypoints_jax_case():
    xy = np.array([[10.0, 10.0], [11.0, 10.5], [60.0, 60.0]], np.float32)
    size = np.full(3, 8.0, np.float32)
    resp = np.array([0.9, 0.5, 0.7], np.float32)
    kept = nms.nms_keypoints(xy, size, resp, radius=8, iou_thresh=0.3)
    want = jnms.nms_keypoints(_cv_keypoints(xy, size, resp), radius=8, iou_thresh=0.3)
    assert [tuple(xy[i]) for i in kept] == [k.pt for k in want]
    assert len(kept) == 2


@pytest.mark.parametrize("radius", [None, 6, 0])
def test_nms_keypoints_random_equal_jax(radius):
    rng = np.random.RandomState(7)
    xy = (rng.rand(200, 2) * 200).astype(np.float32)
    xy[50:60] = xy[40:50]  # duplicate boxes: JAX maps each to its first row
    size = (rng.rand(200) * 12 + 2).astype(np.float32)
    resp = rng.rand(200).astype(np.float32)
    kept = nms.nms_keypoints(xy, size, resp, radius=radius)
    want = jnms.nms_keypoints(_cv_keypoints(xy, size, resp), radius=radius)
    assert [(tuple(xy[i]), float(size[i])) for i in kept] == [(k.pt, k.size) for k in want]


def test_image_streamer_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i in range(4):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), rng.randint(0, 255, (20, 30, 3), np.uint8))
    for source, resize, skip in ((str(tmp_path), (16, 12), 2), (str(tmp_path / "f*.png"),
                                                                (45, 31), 1)):
        ours, theirs = nms.ImageStreamer(source, resize, skip), jnms.ImageStreamer(source, resize,
                                                                                  skip)
        n = 0
        while True:
            (a, ok_a), (b, ok_b) = ours.next_frame(), theirs.next_frame()
            assert ok_a == ok_b
            if not ok_a:
                break
            assert np.array_equal(a, b)
            n += 1
        assert n == (2 if skip == 2 else 4)
    (tmp_path / "clip.mp4").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nms.ImageStreamer(str(tmp_path / "clip.mp4"))
