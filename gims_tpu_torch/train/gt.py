"""Ground-truth correspondence under a known homography, in torch.

Port of ``gims_tpu/train/gt.py`` (reference: utils/preprocess_utils.py:98-132
``torch_find_matches``): project the side-0 keypoints through H, then for
``n_iters`` rounds take the mutual-argmin pairs under ``dist_thresh`` and
remove them from the pools. Fixed shapes and no host question, so it runs
on the caller's device as one queue of work; the integer outputs equal the
JAX package's, ties included (both take the first index of a minimum).
"""

from __future__ import annotations

import torch

# the distance of a pair of which one side is no longer available
BIG = 3.0e38


def warp_keypoints(kpts, H):
    """(N, 2) x (3, 3) -> (N, 2) projective warp
    (reference: preprocess_utils.py:86-96)."""
    ones = torch.ones((kpts.shape[0], 1), dtype=kpts.dtype, device=kpts.device)
    dst = torch.cat([kpts, ones], dim=1) @ H.T
    return dst[:, :2] / dst[:, 2:3]


def find_matches(kpts0, kpts1, H, valid0, valid1,
                 dist_thresh: float = 3.0, n_iters: int = 1):
    """Returns (match0, match1) int32: per-side partner index or -1.

    match0[i] = j means kpts0[i] <-> kpts1[j]; -1 = unmatched (or padded).
    """
    n0, n1 = kpts0.shape[0], kpts1.shape[0]
    dev = kpts0.device
    proj = warp_keypoints(kpts0, H)
    diff = proj[:, None, :] - kpts1[None, :, :]
    d = torch.sqrt((diff * diff).sum(-1))
    ar0 = torch.arange(n0, device=dev)
    match0 = torch.full((n0,), -1, dtype=torch.int32, device=dev)
    match1 = torch.full((n1 + 1,), -1, dtype=torch.int32, device=dev)  # + a drop slot
    avail0, avail1 = valid0.clone(), valid1.clone()
    for _ in range(n_iters):
        dm = torch.where(avail0[:, None] & avail1[None, :], d, BIG)
        min1 = dm.argmin(dim=1)          # (N0,) best j per i
        min0 = dm.argmin(dim=0)          # (N1,) best i per j
        mutual = min0[min1] == ar0
        dmin = dm.gather(1, min1[:, None])[:, 0]
        new = mutual & (dmin < dist_thresh) & avail0
        match0 = torch.where(new, min1.to(torch.int32), match0)
        # mutual matches are injective; the others go to the drop slot
        match1.scatter_(0, torch.where(new, min1, n1), ar0.to(torch.int32))
        avail0 = avail0 & ~new
        taken1 = torch.zeros(n1, dtype=torch.uint8, device=dev).scatter_reduce(
            0, min1, new.to(torch.uint8), reduce="amax")
        avail1 = avail1 & (taken1 == 0)
    return match0, match1[:n1]


def build_gt_rows(match0, match1, valid0, valid1, batch_index: int):
    """Assemble the reference's GT row list for one pair, fixed shape.

    Reference train.py:120-126: one row per side-0 keypoint — matched
    (b, i, j) or missing (b, i, -1) — plus (b, -1, j) for each unmatched
    side-1 keypoint. Returns (N0+N1, 3) int32 rows + (N0+N1,) validity.
    """
    n0, n1 = match0.shape[0], match1.shape[0]
    dev = match0.device
    i32 = torch.int32
    rows0 = torch.stack([torch.full((n0,), batch_index, dtype=i32, device=dev),
                         torch.arange(n0, dtype=i32, device=dev), match0.to(i32)], dim=1)
    rows1 = torch.stack([torch.full((n1,), batch_index, dtype=i32, device=dev),
                         torch.full((n1,), -1, dtype=i32, device=dev),
                         torch.arange(n1, dtype=i32, device=dev)], dim=1)
    rows = torch.cat([rows0, rows1], dim=0)
    valid = torch.cat([valid0, valid1 & (match1 < 0)], dim=0)
    return rows, valid
