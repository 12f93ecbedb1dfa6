"""Sinkhorn and match extraction: the PyTorch port against the JAX package.

The plain ``log_optimal_transport`` of the port (the plain version of the
CUDA Sinkhorn kernel) is held against JAX ``sinkhorn.log_optimal_transport``
and against the Pallas kernel run in interpret mode, on ragged batches
with one all-masked row. The valid block of Z (plus dustbins) agrees
within 2e-4, the tolerance the JAX package holds its own kernel to (f32
logsumexp sums taken in another order, 15 iterations). Matches are
integers and must be equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gims_tpu.matcher import sinkhorn as jsinkhorn
from gims_tpu.matcher.pallas_sinkhorn import (log_optimal_transport_pallas,
                                              sinkhorn_uv_pallas)
from gims_tpu_torch.matcher import cuda_sinkhorn, sinkhorn as tsinkhorn

ITERS = 15
ALPHA = 0.8


def ragged_batch(seed, b=3, m=128, n=128):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(b, m, n) * 3).astype(np.float32)
    ms, ns = [100, 128, 57], [90, 128, 61]
    row_mask = np.arange(m)[None, :] < np.array(ms)[:, None]
    col_mask = np.arange(n)[None, :] < np.array(ns)[:, None]
    row_mask[2, 30] = False  # an all-masked row inside the valid range
    return scores, row_mask, col_mask


def valid_block(z, row_mask, col_mask, i):
    rows = list(np.nonzero(row_mask[i])[0]) + [row_mask.shape[1]]
    cols = list(np.nonzero(col_mask[i])[0]) + [col_mask.shape[1]]
    return z[i][np.ix_(rows, cols)]


def run_torch(fn, scores, row_mask, col_mask):
    return fn(torch.from_numpy(scores), torch.tensor(ALPHA), ITERS,
              torch.from_numpy(row_mask), torch.from_numpy(col_mask)).numpy()


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_log_optimal_transport_matches_jax(reference):
    scores, row_mask, col_mask = ragged_batch(0)
    args = (jnp.asarray(scores), jnp.float32(ALPHA), ITERS,
            jnp.asarray(row_mask), jnp.asarray(col_mask))
    if reference == "xla":
        want = np.asarray(jsinkhorn.log_optimal_transport(*args))
    else:
        want = np.asarray(log_optimal_transport_pallas(*args, interpret=True))
    got = run_torch(tsinkhorn.log_optimal_transport, scores, row_mask, col_mask)
    assert got.shape == want.shape
    for i in range(scores.shape[0]):
        np.testing.assert_allclose(valid_block(got, row_mask, col_mask, i),
                                   valid_block(want, row_mask, col_mask, i),
                                   rtol=2e-4, atol=2e-4)
    # padded rows/cols carry no mass: ~NEG_INF on both sides
    assert got[0, 100:128, :90].max() < -1e8 and want[0, 100:128, :90].max() < -1e8


def test_cuda_wrapper_on_cpu_is_plain_version():
    """On a CPU tensor the kernel's wrapper takes the plain version and
    launches nothing."""
    scores, row_mask, col_mask = ragged_batch(1)
    before = cuda_sinkhorn.launches
    got = run_torch(cuda_sinkhorn.log_optimal_transport_cuda, scores,
                    row_mask, col_mask)
    want = run_torch(tsinkhorn.log_optimal_transport, scores, row_mask, col_mask)
    np.testing.assert_array_equal(got, want)
    assert cuda_sinkhorn.launches == before


@pytest.mark.parametrize("threshold", [0.0, 0.2])
def test_extract_matches_equal(threshold):
    scores, row_mask, col_mask = ragged_batch(2)
    z = run_torch(tsinkhorn.log_optimal_transport, scores, row_mask, col_mask)
    want = jsinkhorn.extract_matches(jnp.asarray(z), jnp.asarray(row_mask),
                                     jnp.asarray(col_mask), threshold)
    got = tsinkhorn.extract_matches(torch.from_numpy(z),
                                    torch.from_numpy(row_mask),
                                    torch.from_numpy(col_mask), threshold)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(np.asarray(want[key]), got[key].numpy())
    assert (got["matches0"].numpy() >= 0).sum() > 0
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(np.asarray(want[key]), got[key].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_masked_logsumexp_all_absent_slice():
    x = np.full((2, 5), -1e9, np.float32)
    x[0, 2] = 0.5
    got = tsinkhorn.masked_logsumexp(torch.from_numpy(x), 1).numpy()
    want = np.asarray(jsinkhorn.masked_logsumexp(jnp.asarray(x), 1))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _lse_final(m, s):
    return np.maximum(m + np.log(np.maximum(s, np.float32(1e-38))), np.float32(-1e9))


def band_merge_uv(Z, log_mu, log_nu, iters, bands, rows_per_step):
    """numpy mirror of the reduction of csrc/sinkhorn.cu: each batch item's
    rows split into `bands` bands (band g takes rows g*M1//bands up to
    (g+1)*M1//bands); per row, u = log_mu - lse_j(Z + v); Z + u folded, R
    rows at a time, into the band's (reference, sum) per column, where the
    reference (floored at -1e9) moves only when the step's largest value
    passes it by 16; the bands' partials merged per column into
    v = log_nu - lse. f32 throughout."""
    f32 = np.float32
    neg, slack = f32(-1e9), f32(16)
    b, m1, n1 = Z.shape
    u = np.zeros((b, m1), f32)
    v = np.zeros((b, n1), f32)
    for _ in range(iters):
        pm = np.full((b, bands, n1), neg, f32)
        ps = np.zeros((b, bands, n1), f32)
        for i in range(b):
            for g in range(bands):
                m, s = pm[i, g], ps[i, g]
                row0, row_end = g * m1 // bands, (g + 1) * m1 // bands
                for r0 in range(row0, row_end, rows_per_step):
                    rows = range(r0, min(row_end, r0 + rows_per_step))
                    for r in rows:
                        x = Z[i, r] + v[i]
                        mx = max(neg, x.max())
                        u[i, r] = log_mu[i, r] - _lse_final(mx, np.exp(x - mx).sum(dtype=f32))
                    y = Z[i, list(rows)] + u[i, list(rows)][:, None]
                    up = y.max(axis=0) > m + slack
                    mn = np.where(up, y.max(axis=0), m)
                    s[:] = s * np.exp(m - mn) + np.exp(y - mn).sum(axis=0, dtype=f32)
                    m[:] = mn
        m, s = pm[:, 0], ps[:, 0]
        for g in range(1, bands):
            m2, s2 = pm[:, g], ps[:, g]
            up = m2 > m
            with np.errstate(over="ignore"):  # the branch np.where drops
                s = np.where(up, s * np.exp(m - m2) + s2, s + s2 * np.exp(m2 - m))
            m = np.maximum(m, m2)
        v = log_nu - _lse_final(m, s)
    return u, v


@pytest.mark.parametrize("reference", ["torch_plain", "pallas_interpret"])
def test_band_merge_reduction_matches(reference):
    """The CUDA kernels' band-and-merge order, mirrored in numpy, against the
    plain log_sinkhorn_uv and the Pallas kernel in interpret mode, for the
    fused kernel's order (5 bands over 101 rows, 2 rows per step; band 1,
    rows 20-39, made only of masked rows) and the streaming kernel's (3
    bands, 8 rows per load); column 7 fully masked. Z within 2e-4 on the
    valid block plus dustbins."""
    rng = np.random.RandomState(3)
    scores = (rng.randn(2, 100, 100) * 3).astype(np.float32)
    row_mask = np.ones((2, 100), bool)
    col_mask = np.arange(100)[None, :] < np.array([[95], [80]])
    row_mask[0, 20:40] = False
    row_mask[1, 90:] = False
    col_mask[0, 7] = False
    couplings, log_mu, log_nu, norm = (
        x.numpy() for x in tsinkhorn.dustbin_couplings(
            torch.from_numpy(scores), torch.tensor(ALPHA),
            torch.from_numpy(row_mask), torch.from_numpy(col_mask)))
    if reference == "torch_plain":
        uw, vw = (x.numpy() for x in tsinkhorn.log_sinkhorn_uv(
            *(torch.from_numpy(x) for x in (couplings, log_mu, log_nu)), ITERS))
    else:
        uw, vw = (np.asarray(x) for x in sinkhorn_uv_pallas(
            *(jnp.asarray(x) for x in (couplings, log_mu, log_nu)), ITERS,
            interpret=True))
    for bands, rows_per_step in ((5, 2), (3, 8)):
        u, v = band_merge_uv(couplings, log_mu, log_nu, ITERS, bands, rows_per_step)
        for i in range(2):
            got = couplings[i] + u[i][:, None] + v[i][None, :] - norm[i]
            want = couplings[i] + uw[i][:, None] + vw[i][None, :] - norm[i]
            np.testing.assert_allclose(
                valid_block(got[None], row_mask[i:i + 1], col_mask[i:i + 1], 0),
                valid_block(want[None], row_mask[i:i + 1], col_mask[i:i + 1], 0),
                rtol=2e-4, atol=2e-4)


def test_dustbin_couplings_in_row_pitch():
    """The couplings built into a wider row pitch (the CUDA kernel's layout)
    equal the concatenated ones, value for value, with the same marginals."""
    rng = np.random.RandomState(5)
    scores = torch.from_numpy((rng.randn(2, 30, 41) * 3).astype(np.float32))
    row_mask = torch.from_numpy(rng.rand(2, 30) < 0.8)
    col_mask = torch.from_numpy(rng.rand(2, 41) < 0.8)
    want = tsinkhorn.dustbin_couplings(scores, torch.tensor(ALPHA), row_mask, col_mask)
    got = tsinkhorn.dustbin_couplings(scores, torch.tensor(ALPHA), row_mask, col_mask,
                                      row_pitch=44)
    assert got[0].shape == (2, 31, 42) and got[0].stride() == (31 * 44, 44, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
