"""Evaluation metrics (host numpy) — parity with reference utils/common.py.

A copy of ``gims_tpu/eval/metrics.py``: the port keeps its own.

pose_auc:            trapezoidal recall-vs-error AUC (common.py:500-512)
compute_pixel_error: mean corner-projection error (common.py:477-481)
weighted_score:      checkpoint-selection scalar (common.py:675-680)
"""

from __future__ import annotations

import numpy as np

# numpy 2 renamed trapz to trapezoid; numpy before 2.0 has only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def pose_auc(errors, thresholds):
    sort_idx = np.argsort(errors)
    errors = np.array(errors, dtype=np.float64)[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(_trapezoid(r, x=e) / t)
    return aucs


def compute_pixel_error(pred_points, gt_points):
    diff = gt_points - pred_points
    return float(np.sqrt((diff**2).sum(-1)).mean())


WEIGHTED_SCORE_WEIGHTS = [0.0, 0.1, 0.2, 0.1, 0.2, 0.2, 0.1, 0.1]


def weighted_score(results):
    values = [
        results["dlt_auc"][0], results["dlt_auc"][1], results["dlt_auc"][2],
        results["ransac_auc"][0], results["ransac_auc"][1],
        results["ransac_auc"][2], results["precision"], results["recall"],
    ]
    return float((np.array(WEIGHTED_SCORE_WEIGHTS) * np.array(values)).sum())


def corner_points(h, w):
    """The eval harness's corner convention
    (reference: eval_homography.py:213)."""
    return np.array([[0, 0], [0, h], [w, h], [w, 0]], np.float32)


def match_precision_recall(matches, gt_match_vec, valid, ma_0, ma_1):
    """Reference: eval_homography.py:228-231."""
    match_flag = matches[ma_0] == ma_1
    denom = valid.sum()
    precision = float(match_flag.sum() / denom) if denom else 0.0
    fn_flag = np.logical_and(matches != gt_match_vec, matches == -1)
    rec_denom = match_flag.sum() + fn_flag.sum()
    recall = float(match_flag.sum() / rec_denom) if rec_denom else 0.0
    return precision, recall
