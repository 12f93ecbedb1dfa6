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
from gims_tpu.matcher.pallas_sinkhorn import log_optimal_transport_pallas
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
