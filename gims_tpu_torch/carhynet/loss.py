"""HyNet hybrid loss for descriptor training, in PyTorch.

Port of ``gims_tpu/carhynet/loss.py`` (reference carhynet/models.py:520-636
``Loss_HyNet``):
* the hybrid triplet loss over the hardest negative of four distance
  matrices (within L, within R, and across in both directions), with the
  second-order shaping d + d^2/2 * alpha;
* the raw descriptors' norm consistency (x0.1);
* optionally the second-order similarity (SOS) term over the union of kNN
  graphs.

Distances (reference carhynet/util.py:13-18): descriptors are
L2-normalized, d(x, y) = sqrt(|2(1 - x.y)| + eps), the products in full
float32 (TF32 off, as the JAX package asks HIGHEST). The hardest negatives
are picked with a stable sort of the masked distances, as ``jnp.argsort``.
"""

from __future__ import annotations

import numpy as np
import torch

DIST_TH = 8e-3   # reference carhynet/util.py:9
EPS_SQRT = 1e-6


def l2_distance_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M), both inputs L2-normalized."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sim = x @ y.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.sqrt(torch.abs(2.0 * (1.0 - sim)) + EPS_SQRT)


def _mask_sorted(mat, pos_mask):
    """Penalize positives and degenerate tiny distances before sorting
    (reference: models.py:535-549 adds 2x indicators)."""
    return mat + 2.0 * pos_mask + 2.0 * (mat <= DIST_TH).to(mat.dtype)


def hynet_loss(desc_l, desc_r, desc_raw_l, desc_raw_r, margin: float = 1.2,
               alpha: float = 2.0, is_sosr: bool = False, knn_sos: int = 8):
    """Returns (loss, dist_pos_mean, dist_neg_mean); the two means carry no
    gradient. Row i of L pairs with row i of R (positives on the diagonal)."""
    n = desc_l.shape[0]
    eye = torch.eye(n, dtype=desc_l.dtype, device=desc_l.device)
    L = l2_distance_matrix(desc_l, desc_l)
    R = l2_distance_matrix(desc_r, desc_r)
    LR = l2_distance_matrix(desc_l, desc_r)
    Lm, Rm, LRm = (_mask_sorted(m.detach(), eye) for m in (L, R, LR))
    idx_l = torch.argsort(Lm, dim=1, stable=True)
    idx_r = torch.argsort(Rm, dim=0, stable=True)
    idx_lr = torch.argsort(LRm, dim=1, stable=True)
    idx_rl = torch.argsort(LRm, dim=0, stable=True)

    ar = torch.arange(n, device=desc_l.device)
    dist_pos = LR[ar, ar]
    dist_neg = torch.stack([L[ar, idx_l[:, 0]], R[idx_r[0, :], ar],
                            LR[ar, idx_lr[:, 0]], LR[idx_rl[0, :], ar]])
    dist_neg_hard = dist_neg.min(dim=0).values

    def shaped(d):
        return d + d * d / 2.0 * alpha

    loss = torch.clamp(margin + shaped(dist_pos) - shaped(dist_neg_hard), min=0.0).sum()
    norm_l = torch.sqrt((desc_raw_l ** 2).sum(1) + EPS_SQRT)
    norm_r = torch.sqrt((desc_raw_r ** 2).sum(1) + EPS_SQRT)
    loss = loss + 0.1 * ((norm_l - norm_r) ** 2).sum()

    if is_sosr:
        def knn_adj(rows_idx, axis):
            a = torch.zeros((n, n), dtype=desc_l.dtype, device=desc_l.device)
            if axis == 1:
                a[ar[:, None], rows_idx[:, :knn_sos]] = 1.0
            else:
                a[rows_idx[:knn_sos, :], ar[None, :]] = 1.0
            return a

        def sym(a):
            return ((a + a.T) > 0).to(desc_l.dtype)

        adj = (sym(knn_adj(idx_l, 1)) + sym(knn_adj(idx_r, 0))
               + sym(knn_adj(idx_lr, 1) + knn_adj(idx_rl, 0)))
        adj = (adj > 0).to(desc_l.dtype) * (1.0 - eye)
        dif = (L - R) * adj
        loss = loss + torch.sqrt((dif ** 2).sum(1) + EPS_SQRT).sum()

    return loss, dist_pos.mean().detach(), dist_neg_hard.mean().detach()


def cal_fpr95(dist_pos, dist_neg):
    """False positive rate at 95% true-positive recall
    (reference capability: carhynet/util.py:464+)."""
    dist_pos = np.sort(np.asarray(dist_pos))
    thresh = dist_pos[int(0.95 * (len(dist_pos) - 1))]
    return float((np.asarray(dist_neg) <= thresh).mean())
