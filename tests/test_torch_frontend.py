"""The device detector's frontend: the PyTorch port against the JAX package
on the CPU.

The same numpy images go through ``gims_tpu.frontend`` and
``gims_tpu_torch.frontend``. Tolerances:
- ``upsample2x``: 1e-4 on 0-255 gray levels, border rows and columns
  included (both renormalize the outside tap to the edge pixel);
- ``gray_pyramid`` against JAX's banded-matmul blur (the path
  ``FusedMatching`` takes): 1e-3 on 0-255 gray levels, every octave, down
  to octaves narrower than the blur kernel (``tests/test_blurmat.py`` holds
  the band path to cv2 at 2e-3);
- ``_octave_candidates`` on the same octave: 1e-4 on the score and offset
  maps where the fit is well conditioned, identical rejections elsewhere;
- the selected keypoints: equal wherever the score margin to the k-th
  value exceeds that tolerance.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu import fused as jfused
from gims_tpu.frontend import detect_device as jdet
from gims_tpu.frontend.blurmat import band_matrix
from gims_tpu.frontend import pyramid as jpyr
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.frontend import detect_device as tdet
from gims_tpu_torch.frontend import pyramid as tpyr
from gims_tpu_torch.synthetic import synthetic_image_pair
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FRAME = (96, 128)


@pytest.fixture(scope="module")
def image():
    return synthetic_image_pair(3, FRAME)[0]


@pytest.mark.parametrize("shape", [(7, 9), (24, 31), (96, 128)])
def test_upsample2x_matches_jax_with_borders(shape):
    img = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32) * 255
    want = np.asarray(jpyr.upsample2x(jnp.asarray(img)[..., None]))[..., 0]
    got = tpyr.upsample2x(torch.from_numpy(img)[None])[0].numpy()
    assert got.shape == want.shape == (2 * shape[0], 2 * shape[1])
    for rows in (slice(0, 1), slice(-1, None), slice(None)):
        np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, :1], want[:, :1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, -1:], want[:, -1:], atol=1e-4, rtol=0)


def test_pyramid_constants_match_jax():
    assert tpyr.blur_sigmas() == jpyr.blur_sigmas()
    assert (tpyr.N_OCTAVE_LAYERS, tpyr.SIGMA, tpyr.FIRST_OCTAVE) == (
        jpyr.N_OCTAVE_LAYERS, jpyr.SIGMA, jpyr.FIRST_OCTAVE)
    for h, w in ((600, 800), (96, 128), (1200, 1600), (17, 23)):
        assert tpyr.num_octaves(h, w) == jpyr.num_octaves(h, w)
    for sigma in (0.5, 1.25, 3.09):
        np.testing.assert_array_equal(tpyr.gaussian_kernel_1d(sigma),
                                      jpyr.gaussian_kernel_1d(sigma))
    for up in (False, True):
        for a, b in zip(tdet.gray_kernels(up), jdet.gray_kernels(up)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,half", [(3, 13), (5, 13), (40, 4)])
def test_reflect101_index_matches_band_matrix(n, half):
    """Every padded position folds to the source the JAX band matrix uses,
    also where the row is narrower than the kernel (several folds)."""
    kern = np.arange(1, 2 * half + 2, dtype=np.float32)
    band = np.asarray(band_matrix(n, kern))
    idx = tpyr.reflect101_index(n, half)
    mine = np.zeros((n, n), np.float32)
    for j in range(n):
        for t in range(2 * half + 1):
            mine[idx[j + t], j] += kern[t]
    np.testing.assert_allclose(mine, band, rtol=1e-6)


def jax_pyramid(img, upsample):
    h, w = img.shape
    blur = jdet.build_gray_blur(h, w, upsample)
    return [np.asarray(o) for o in jdet.gray_pyramid(jnp.asarray(img), h, w, blur, upsample)]


@pytest.mark.parametrize("upsample", [False, True])
def test_gray_pyramid_matches_jax_band_path(image, upsample):
    want = jax_pyramid(image, upsample)
    got = tdet.gray_pyramid(torch.from_numpy(np.stack([image, image[::-1].copy()])),
                            upsample)
    assert len(got) == len(want)
    for o, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1:] == w.shape, o
        np.testing.assert_allclose(g[0].numpy(), w, atol=1e-3, rtol=0, err_msg=f"octave {o}")
    # batch items are independent: the flipped image's pyramid is its own
    flipped = jax_pyramid(image[::-1].copy(), upsample)
    np.testing.assert_allclose(got[0][1].numpy(), flipped[0], atol=1e-3, rtol=0)


def test_gray_pyramid_bgr_weights(image):
    """A BGR image goes through the BGR2GRAY weights as in JAX."""
    bgr = np.stack([image, image[::-1], image[:, ::-1]], -1).copy()
    h, w = image.shape
    blur = jdet.build_gray_blur(h, w, False)
    want = np.asarray(jdet.gray_pyramid(jnp.asarray(bgr), h, w, blur, False)[0])
    got = tdet.gray_pyramid(torch.from_numpy(bgr)[None], False)[0][0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("upsample,octave", [(False, 0), (True, 0), (True, 1)])
def test_octave_candidates_match_jax(image, upsample, octave):
    gauss = np.array(jax_pyramid(image, upsample)[octave])
    want = {k: np.asarray(v) for k, v in jdet._octave_candidates(
        jnp.asarray(gauss), 0.001, 80.0).items()}
    got = {k: v[0].numpy() for k, v in tdet._octave_candidates(
        torch.from_numpy(gauss)[None], 0.001, 80.0).items()}
    assert set(got) == set(want) == {"score", "offx", "offy", "offs"}
    ok = want["score"] > 0
    assert ok.sum() > 20
    np.testing.assert_array_equal(got["score"] > 0, ok)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-4, rtol=0)
    for k in ("offx", "offy", "offs"):
        np.testing.assert_allclose(got[k][ok], want[k][ok], atol=1e-4, rtol=0)


def test_top_k_stable_breaks_ties_as_jax():
    rng = np.random.RandomState(0)
    score = rng.randint(-1, 4, (3, 500)).astype(np.float32)  # heavy ties
    for k in (1, 37, 500):
        wv, wi = jax.lax.top_k(jnp.asarray(score), k)
        gv, gi = tdet.top_k_stable(torch.from_numpy(score), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("upsample", [False, True])
def test_selected_keypoints_match_jax(image, upsample):
    """Per octave, the top-k keypoints from the same pyramid: equal
    wherever the score is more than the tolerance away from the k-th."""
    octs = jax_pyramid(image, upsample)
    budgets = jfused.octave_budgets(*FRAME, 256, upsample)
    assert budgets == tfused.octave_budgets(*FRAME, 256, upsample)
    for o, k in enumerate(budgets):
        cand = jdet._octave_candidates(jnp.asarray(octs[o]), 0.001, 80.0)
        score = np.asarray(cand["score"]).reshape(-1)
        k = min(k, score.size)
        _, wi = jax.lax.top_k(jnp.asarray(score), k)
        tc = tdet._octave_candidates(torch.from_numpy(octs[o].copy())[None], 0.001, 80.0)
        _, gi = tdet.top_k_stable(tc["score"].reshape(1, -1), k)
        kth = np.sort(score)[::-1][k - 1]
        sure = np.abs(score - kth) > 1e-4
        want = set(np.asarray(wi)[sure[np.asarray(wi)]])
        got = set(gi[0].numpy()[sure[gi[0].numpy()]])
        assert got == want, o


def test_octave_budgets_match_jax():
    for h, w, total, up in ((600, 800, 6144, False), (600, 800, 12288, True),
                            (96, 128, 256, False), (480, 640, 2048, True)):
        assert tfused.octave_budgets(h, w, total, up) == jfused.octave_budgets(h, w, total, up)
    with pytest.raises(ValueError):
        tfused.octave_budgets(600, 800, 100, True)
