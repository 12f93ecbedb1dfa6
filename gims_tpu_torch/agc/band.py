"""Band geometry of AGC's band build, for batches of keypoint sets.

Port of ``_diag_band``, ``_band_shear_bwd``, ``_window_values_fwd`` /
``_bwd`` and ``_band_to_dense`` of ``gims_tpu/agc/graph.py``. After the
keypoints are sorted by x, every candidate pair (i, j > i) within the AGC
radius lies a few sorted positions apart, so the build keeps a forward
band (B, N, Wh) with band[b, i, m] = edge(i, i + 1 + m) instead of (N, N)
matrices. The JAX package builds these views with reshapes laid out for
the TPU's lanes; here they are index arithmetic (``as_strided``,
``unfold``, ``gather``) on the same values. Every function takes a leading
batch axis.
"""

from __future__ import annotations

import torch


def _diag_band(blocks: torch.Tensor) -> torch.Tensor:
    """(B, nb, BR, C) block values -> (B, nb * BR, Wh = C - BR) diagonal
    bands: out[:, b * BR + r, m] = blocks[:, b, r, r + m]."""
    bsz, nb, br, c = blocks.shape
    blocks = blocks.contiguous()
    band = blocks.as_strided((bsz, nb, br, c - br), (nb * br * c, br * c, c + 1, 1),
                             blocks.storage_offset())
    return band.reshape(bsz, nb * br, c - br)


def _window_values_fwd(vec: torch.Tensor, wh: int, fill) -> torch.Tensor:
    """(B, N) -> (B, N, Wh) windows out[:, i, m] = vec[:, i + 1 + m], `fill`
    past N."""
    bsz, n = vec.shape
    pad = torch.cat([vec, vec.new_full((bsz, wh + 1), fill)], dim=1)
    return pad.unfold(1, wh, 1)[:, 1:n + 1]


def _window_values_bwd(vec: torch.Tensor, wh: int, fill) -> torch.Tensor:
    """(B, N) -> (B, N, Wh) windows out[:, j, m] = vec[:, j - 1 - m], `fill`
    before 0."""
    bsz, n = vec.shape
    pad = torch.cat([vec.new_full((bsz, wh), fill), vec], dim=1)
    return pad.unfold(1, wh, 1)[:, :n].flip(-1)


def _band_shear_bwd(band: torch.Tensor) -> torch.Tensor:
    """Backward view of a forward band: bwd[:, j, m] = band[:, j - 1 - m, m],
    False where j - 1 - m < 0. band[i, m] holds edge(i, i + 1 + m); bwd[j, m]
    holds the same edge seen from j."""
    bsz, n, wh = band.shape
    j = torch.arange(n, device=band.device)[:, None]
    m = torch.arange(wh, device=band.device)[None, :]
    src = j - 1 - m
    flat = (src.clamp(min=0) * wh + m).reshape(1, -1).expand(bsz, -1)
    bwd = torch.gather(band.reshape(bsz, -1), 1, flat).view(bsz, n, wh)
    return bwd & (src >= 0)


def _band_to_dense(band: torch.Tensor) -> torch.Tensor:
    """(B, N, Wh) forward band -> (B, N, N) upper-triangular bool, dense[:, i,
    i + 1 + m] = band[:, i, m]. Entries with i + 1 + m >= N must be False
    (they would alias).

    The dense flat position of (i, i + 1 + m) is i * (N + 1) + m + 1: the
    band is written into rows of N + 1 behind one leading zero, and the
    buffer is re-viewed with rows of N (the JAX package's fallback
    construction; its other branch lays the same array out for the TPU's
    lanes)."""
    bsz, n, wh = band.shape
    per_item = n * (n + 1) + 1
    buf = torch.zeros((bsz, per_item), dtype=band.dtype, device=band.device)
    buf[:, 1:].view(bsz, n, n + 1)[:, :, :wh] = band
    return buf.as_strided((bsz, n, n), (per_item, n, 1))
