"""AGC parameter grid search.

Port of ``gims_tpu/tools/parameter_search.py`` (reference
tools/parameter_search.py:142-209): sweep (radius, percentile, min_size) on
one image pair with the port's ``Matching`` (on the card unless the caller
names another device; the knobs are per-request values, so the matcher is
built once), count the inliers of each row's matches with the port's
USAC (``eval/usac.py``, as JAX counts them with ``cv2.USAC_DEFAULT``), and
append [r, t, m, correct_matches, total_matches, time] rows to
``record.txt`` (JAX's lines) and ``record.csv`` (the csv module: JAX's
fallback format where it cannot write ``.xlsx``).

    python -m gims_tpu_torch.tools.parameter_search -i0 a.png -i1 b.png \\
        -w weights/gims_tpu_sift_last.npz -r 10,12 -t 0,2 -m 0,2 [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import time

import numpy as np

from gims_tpu_torch.core import image_io
from gims_tpu_torch.eval.usac import find_homography_usac

COLUMNS = ["r", "t", "m", "correct_matches", "total_matches", "time"]


def search_process(matcher, param, image0, image1, image0_name, image1_name, result_path):
    """One row: match the pair at `param` = (radius, percentile, min_size),
    count USAC's inliers, append the row to the records; returns it."""
    radius, percentile, min_size = param
    t1 = time.perf_counter()
    pred = matcher({
        "image0": image0[None], "image1": image1[None],
        "radius": radius, "percentile": percentile, "min_size": min_size,
        "return_descriptors": False,
    })
    t2 = time.perf_counter()
    kpts0 = pred["keypoints0"][0]
    kpts1 = pred["keypoints1"][0]
    matches = pred["matches0"][0]
    valid = matches > -1
    found = find_homography_usac(np.float32(kpts0[valid]), np.float32(kpts1[matches[valid]]),
                                 device=matcher.device)
    if found is None:  # JAX: OpenCV raises
        result_count, total_count = 0, 0
    else:
        result_count, total_count = int((found[1].ravel() == 1).sum()), len(matches)
    print(f"{list(param)}, {image0_name}/{image1_name} => {result_count}/{total_count}")
    row = list(param) + [result_count, total_count, t2 - t1]

    save_file = os.path.join(result_path, "record")
    path = save_file + ".csv"
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(COLUMNS)
        w.writerow(row)
    with open(save_file + ".txt", "a+") as f:
        f.write(f"{row}\n")
    return row


def search(image0_path, image1_path, parameters, weights_path, output_dir,
           max_keypoints=-1, matcher=None, device=None):
    """Every row of `parameters` on the pair; the records go to
    ``output_dir/<name0[:20]>_<name1[:20]>/``. A row that fails is reported
    (``core/notify.py``) and the sweep goes on."""
    if matcher is None:
        from gims_tpu_torch.api import Matching

        matcher = Matching({
            "weights_path": weights_path,
            "sinkhorn_iterations": 20,
            "match_threshold": 0.02,
            "max_keypoints": max_keypoints,
        }, device=device)
    image0 = image_io.imread(image0_path, image_io.IMREAD_COLOR)
    image1 = image_io.imread(image1_path, image_io.IMREAD_COLOR)
    name0 = os.path.splitext(os.path.basename(image0_path))[0]
    name1 = os.path.splitext(os.path.basename(image1_path))[0]
    result_path = os.path.join(output_dir, f"{name0[:20]}_{name1[:20]}")
    os.makedirs(result_path, exist_ok=True)
    rows = []
    for param in parameters:
        try:
            rows.append(search_process(matcher, param, image0, image1, name0, name1,
                                       result_path))
        except Exception as e:  # noqa: BLE001
            # error ping + keep sweeping (reference: tools/parameter_search.py:206-209);
            # no-op unless GIMS_NOTIFY_URL is set
            from gims_tpu_torch.core.notify import send_notify

            send_notify(f"parameter_search error at {list(param)}: {e}")
            print(f"search_process failed at {list(param)}: {e}")
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description="GIMS parameter search")
    parser.add_argument("-i0", "--image0", type=str, required=True)
    parser.add_argument("-i1", "--image1", type=str, required=True)
    parser.add_argument("-r", "--r-range", type=str, default="10,30")
    parser.add_argument("-t", "--t-range", type=str, default="0,10")
    parser.add_argument("-m", "--m-range", type=str, default="0,10")
    parser.add_argument("-k", "--max-keypoints", type=int, default=-1)
    parser.add_argument("-w", "--weights", type=str, default=None)
    parser.add_argument("-o", "--output", type=str, default="./output/search")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    rs = [int(x) for x in args.r_range.split(",")]
    ts = [int(x) for x in args.t_range.split(",")]
    ms = [int(x) for x in args.m_range.split(",")]
    parameters = [list(p) for p in itertools.product(
        range(rs[0], rs[1] + 1), range(ts[0], ts[1] + 1), range(ms[0], ms[1] + 1))]
    return search(args.image0, args.image1, parameters, args.weights, args.output,
                  args.max_keypoints, device=args.device)


if __name__ == "__main__":
    main()
