"""Bucketed padding of keypoint sets.

Keypoint counts are padded up to a small ladder of bucket sizes, so that
every request of a bucket runs the same shapes; the mask marks the real
entries and every downstream op is mask-aware.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS: Tuple[int, ...] = (
    128, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576,
)

# coordinate of padding keypoints: far from every real one, so that radius
# tests never connect them
PAD_COORD = 1e6


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (last bucket if n exceeds the ladder)."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def pad_to(arr: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad `arr` along `axis` to length `n` with `fill`."""
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"array length {cur} exceeds bucket {n}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, mode="constant", constant_values=fill)


def pad_keypoint_set(
    kpts: np.ndarray,
    descs: np.ndarray,
    scores: np.ndarray,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad (N,2) keypoints, (N,D) descriptors, (N,) scores to a bucket.

    Returns (kpts_p, descs_p, scores_p, mask) with mask (Nb,) bool.
    Padding keypoints sit at PAD_COORD.
    """
    n = kpts.shape[0]
    nb = bucket_size(n, buckets)
    mask = np.zeros((nb,), dtype=bool)
    mask[:n] = True
    kpts_p = pad_to(np.asarray(kpts, np.float32), nb, fill=PAD_COORD)
    descs_p = pad_to(np.asarray(descs, np.float32), nb, fill=0.0)
    scores_p = pad_to(np.asarray(scores, np.float32), nb, fill=0.0)
    return kpts_p, descs_p, scores_p, mask


def compact_indices(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Maps between padded index space and compacted (mask-selected) space.

    Returns (new_of_old, old_of_new):
      new_of_old[i] = compact index of padded slot i (or -1 if masked out)
      old_of_new[j] = padded slot of compact index j
    """
    mask = np.asarray(mask, bool)
    old_of_new = np.nonzero(mask)[0]
    new_of_old = np.full(mask.shape[0], -1, dtype=np.int64)
    new_of_old[old_of_new] = np.arange(old_of_new.shape[0])
    return new_of_old, old_of_new
