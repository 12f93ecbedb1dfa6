"""Log-domain optimal transport (Sinkhorn) with dustbins, mask-aware.

Port of ``gims_tpu/matcher/sinkhorn.py`` (reference: models/gmatcher.py:
41-69): an (M+1)x(N+1) coupling in log space, dustbin row/col scored by a
learned scalar, marginals from the *valid* counts, ``iters`` alternating
row/col logsumexp normalizations, and a final +log(ms+ns) shift. Padded
rows/cols carry zero transport mass.

``log_sinkhorn_uv`` is the plain version of the CUDA kernel in
``cuda_sinkhorn.py``.
"""

from __future__ import annotations

import torch

from gims_tpu_torch.train import multihost

# Finite stand-in for -inf: avoids (-inf)-(-inf) NaNs inside logsumexp
# while still flushing exp() to exactly 0 in f32.
NEG_INF = -1e9


def masked_logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """logsumexp that treats entries <= NEG_INF/2 as absent.

    Stable even when an entire slice is absent (returns NEG_INF there).
    """
    m = torch.amax(x, dim=dim, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF)
    s = torch.sum(torch.exp(x - m_safe), dim=dim, keepdim=True)
    out = m_safe.squeeze(dim) + torch.log(torch.clamp(s.squeeze(dim), min=1e-38))
    return torch.clamp(out, min=NEG_INF)


def log_sinkhorn_uv(Z: torch.Tensor, log_mu: torch.Tensor,
                    log_nu: torch.Tensor, iters: int):
    """Sinkhorn potentials (u, v) after `iters` row/col updates.

    Z: (B, M1, N1); log_mu: (B, M1); log_nu: (B, N1).
    u = log_mu - lse_j(Z + v), then v = log_nu - lse_i(Z + u).
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - masked_logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - masked_logsumexp(Z + u[:, :, None], dim=1)
    return u, v


def log_sinkhorn_iterations(Z: torch.Tensor, log_mu: torch.Tensor,
                            log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """Alternating row/col normalization in log space; returns Z + u + v."""
    u, v = log_sinkhorn_uv(Z, log_mu, log_nu, iters)
    return Z + u[:, :, None] + v[:, None, :]


def dustbin_couplings(scores: torch.Tensor, alpha, row_mask: torch.Tensor,
                      col_mask: torch.Tensor, row_pitch: int | None = None):
    """Pad scores with dustbins and build the log-marginals.

    Returns (couplings (B, M+1, N+1), log_mu (B, M+1), log_nu (B, N+1),
    norm (B,)), with absent entries at NEG_INF. With ``row_pitch`` (at
    least N+1) the couplings are a view of a (B, M+1, row_pitch) buffer
    whose columns past N are left unset: the layout the CUDA kernel reads.
    """
    b = scores.shape[0]
    dt = scores.dtype
    alpha = torch.as_tensor(alpha, dtype=dt, device=scores.device)
    ms = row_mask.sum(dim=1).to(dt)
    ns = col_mask.sum(dim=1).to(dt)
    # NEG_INF stays a Python scalar: a tensor made from it on the card
    # would be a host-to-device copy, which waits for the whole stream

    pair_ok = row_mask[:, :, None] & col_mask[:, None, :]
    scores = torch.where(pair_ok, scores, NEG_INF)
    bins0 = torch.where(row_mask, alpha, NEG_INF)[:, :, None]      # (B, M, 1)
    bins1 = torch.where(col_mask, alpha, NEG_INF)[:, None, :]      # (B, 1, N)
    if row_pitch is None:
        corner = alpha.reshape(1, 1, 1).expand(b, 1, 1)
        couplings = torch.cat([
            torch.cat([scores, bins0], dim=2),
            torch.cat([bins1, corner], dim=2),
        ], dim=1)
    else:
        m, n = scores.shape[1], scores.shape[2]
        couplings = scores.new_empty((b, m + 1, row_pitch))[:, :, : n + 1]
        couplings[:, :m, :n] = scores
        couplings[:, :m, n:] = bins0
        couplings[:, m:, :n] = bins1
        couplings[:, m, n] = alpha

    norm = -torch.log(ms + ns)
    log_mu = torch.cat([
        torch.where(row_mask, norm[:, None], NEG_INF),
        (torch.log(torch.clamp(ns, min=1e-38)) + norm)[:, None],
    ], dim=1)
    log_nu = torch.cat([
        torch.where(col_mask, norm[:, None], NEG_INF),
        (torch.log(torch.clamp(ms, min=1e-38)) + norm)[:, None],
    ], dim=1)
    return couplings, log_mu, log_nu, norm


def log_optimal_transport(scores: torch.Tensor, alpha, iters: int,
                          row_mask: torch.Tensor,
                          col_mask: torch.Tensor) -> torch.Tensor:
    """Dustbin-padded Sinkhorn honoring validity masks.

    scores: (B, M, N); row_mask (B, M) / col_mask (B, N) bool.
    Returns the (B, M+1, N+1) log-coupling; invalid rows/cols are ~NEG_INF.
    """
    couplings, log_mu, log_nu, norm = dustbin_couplings(
        scores, alpha, row_mask, col_mask)
    Z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return Z - norm[:, None, None]


def extract_matches(Z: torch.Tensor, row_mask: torch.Tensor,
                    col_mask: torch.Tensor, match_threshold: float) -> dict:
    """Mutual-max match extraction with confidence thresholding
    (reference: models/gmatcher.py:284-294).

    Returns (B, M)/(B, N) tensors: matches0, matches1 (int32, -1 = none),
    matching_scores0, matching_scores1 (f32).
    """
    m, n = Z.shape[1] - 1, Z.shape[2] - 1
    pair_ok = row_mask[:, :, None] & col_mask[:, None, :]
    block = torch.where(pair_ok, Z[:, :m, :n], NEG_INF)
    return _mutual_matches(torch.amax(block, dim=2), torch.argmax(block, dim=2),
                           torch.argmax(block, dim=1), row_mask, col_mask, match_threshold)


def _mutual_matches(max0, indices0, indices1, row_mask, col_mask, match_threshold):
    """The mutual test and the thresholds of ``extract_matches`` on each
    row's max and argmax and each column's argmax."""
    m, n = row_mask.shape[1], col_mask.shape[1]
    ar0 = torch.arange(m, device=max0.device)[None, :]
    ar1 = torch.arange(n, device=max0.device)[None, :]
    mutual0 = (ar0 == torch.gather(indices1, 1, indices0)) & row_mask
    mutual1 = (ar1 == torch.gather(indices0, 1, indices1)) & col_mask

    zero = torch.zeros((), dtype=max0.dtype, device=max0.device)
    mscores0 = torch.where(mutual0, torch.exp(max0), zero)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), zero)
    valid0 = mutual0 & (mscores0 > match_threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    return {
        "matches0": torch.where(valid0, indices0, -1).to(torch.int32),
        "matches1": torch.where(valid1, indices1, -1).to(torch.int32),
        "matching_scores0": mscores0.float(),
        "matching_scores1": mscores1.float(),
    }


# ------------------------------------------------ keypoint-sharded forms
# The (B, N, M) scores and the (B, N+1, M+1) coupling split by rows over a
# torch.distributed group of P ranks (matcher/sharded.py): rank r holds rows
# [r0, r0 + N/P) and the dustbin row, the same on every rank. Row updates are
# local; each column update and each column argmax is an all-reduce over
# (B, M+1) through train/multihost.py.

def _column_logsumexp(x: torch.Tensor, group) -> torch.Tensor:
    """``masked_logsumexp(x, dim=1)`` of the whole coupling from each rank's
    rows x (B, R+1, M+1), whose last row (the dustbin row) every rank holds:
    the column max and then the sum of exponentials, each reduced across
    ranks, the dustbin row counted once."""
    body, dust = x[:, :-1], x[:, -1]
    m = multihost.all_reduce(torch.maximum(torch.amax(body, dim=1), dust), "max", group)
    m_safe = torch.clamp(m, min=NEG_INF)
    s = multihost.all_reduce(torch.sum(torch.exp(body - m_safe[:, None, :]), dim=1), "sum",
                             group) + torch.exp(dust - m_safe)
    return torch.clamp(m_safe + torch.log(torch.clamp(s, min=1e-38)), min=NEG_INF)


def log_optimal_transport_rows(scores: torch.Tensor, alpha, iters: int,
                               row_mask: torch.Tensor, col_mask: torch.Tensor,
                               r0: int, group) -> torch.Tensor:
    """``log_optimal_transport`` with the rows split over `group`.

    scores (B, R, M): this rank's rows [r0, r0 + R) of the scores; row_mask
    (B, N) and col_mask (B, M) whole. Returns (B, R+1, M+1): this rank's
    rows of the log-coupling, then the dustbin row."""
    b, rows, _ = scores.shape
    dt = scores.dtype
    alpha = torch.as_tensor(alpha, dtype=dt, device=scores.device)
    ms = row_mask.sum(dim=1).to(dt)
    ns = col_mask.sum(dim=1).to(dt)
    rmask = row_mask[:, r0:r0 + rows]
    scores = torch.where(rmask[:, :, None] & col_mask[:, None, :], scores, NEG_INF)
    bins0 = torch.where(rmask, alpha, NEG_INF)[:, :, None]
    bins1 = torch.where(col_mask, alpha, NEG_INF)[:, None, :]
    corner = alpha.reshape(1, 1, 1).expand(b, 1, 1)
    Z = torch.cat([torch.cat([scores, bins0], dim=2), torch.cat([bins1, corner], dim=2)], dim=1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(rmask, norm[:, None], NEG_INF),
                        (torch.log(torch.clamp(ns, min=1e-38)) + norm)[:, None]], dim=1)
    log_nu = torch.cat([torch.where(col_mask, norm[:, None], NEG_INF),
                        (torch.log(torch.clamp(ms, min=1e-38)) + norm)[:, None]], dim=1)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - masked_logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - _column_logsumexp(Z + u[:, :, None], group)
    return Z + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def extract_matches_rows(Z: torch.Tensor, row_mask: torch.Tensor, col_mask: torch.Tensor,
                         match_threshold: float, r0: int, group) -> dict:
    """``extract_matches`` on this rank's rows Z (B, R+1, M+1) of
    ``log_optimal_transport_rows``: each row's max and argmax are
    all-gathered; each column's max, and its first argmax across ranks (the
    lowest global row that holds the max), are all-reduced. Returns the
    whole dict, the same on every rank."""
    rows, m = Z.shape[1] - 1, Z.shape[2] - 1
    n = row_mask.shape[1]
    rmask = row_mask[:, r0:r0 + rows]
    block = torch.where(rmask[:, :, None] & col_mask[:, None, :], Z[:, :rows, :m], NEG_INF)
    max0 = multihost.all_gather_cat(torch.amax(block, dim=2), 1, group)
    indices0 = multihost.all_gather_cat(torch.argmax(block, dim=2), 1, group)
    col_max = torch.amax(block, dim=1)
    top = multihost.all_reduce(col_max, "max", group)
    indices1 = multihost.all_reduce(
        torch.where(col_max == top, torch.argmax(block, dim=1) + r0, n), "min", group)
    return _mutual_matches(max0, indices0, indices1, row_mask, col_mask, match_threshold)
