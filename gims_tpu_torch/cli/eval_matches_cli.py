"""Match-count eval CLI — the flags of the JAX package's
``gims_tpu/cli/eval_matches_cli.py`` (reference eval_matches.py __main__),
plus ``--descriptor_source``, ``--detector``, ``--sift_descriptor`` and
``--device`` as in ``eval_homography_cli``: the JAX defaults run OpenCV's
SIFT as the port computes it (``frontend/sift.py``). Inliers are counted by the port's
RANSAC in place of OpenCV's USAC. ``--save_match`` raises (OpenCV
drawing). Images are PNG.

    python -m gims_tpu_torch.cli.eval_matches_cli --image0 a.png --image1 'dir/*.png' \\
        --weights_path weights/gims_tpu_sift_last.npz --descriptor_source sift
"""

from __future__ import annotations

import argparse


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image0", type=str, required=True)
    parser.add_argument("--image1", type=str, required=True,
                        help="path or glob of comparison image(s)")
    parser.add_argument("--root_path", type=str, default="./output/match/")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--dgims", action="store_true")
    parser.add_argument("--save_match", action="store_true",
                        help="not ported (OpenCV drawing): raises")
    parser.add_argument("--descriptor_source", type=str, default="carhynet",
                        choices=["carhynet", "sift", "dense", "dense_gray"])
    parser.add_argument("--detector", default="host", choices=["host", "device"])
    parser.add_argument("--sift_descriptor", default="host", choices=["host", "device"])
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from gims_tpu_torch.api import Matching
    from gims_tpu_torch.eval.matches import run_match_eval

    matcher = Matching({
        "weights_path": args.weights_path,
        "sinkhorn_iterations": 20,
        "match_threshold": 0.02,
        "max_keypoints": -1,
        "descriptor_source": args.descriptor_source,
        "detector": args.detector,
        "sift_descriptor": args.sift_descriptor,
    }, device=args.device)
    return run_match_eval(
        args.image0, args.image1, root_path=args.root_path,
        dgims=args.dgims, save_match=args.save_match,
        weights_path=args.weights_path, matcher=matcher, device=args.device,
    )


if __name__ == "__main__":
    main()
