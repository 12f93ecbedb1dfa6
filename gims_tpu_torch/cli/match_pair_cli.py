"""Match two images and dump or draw the matches: the port of the JAX
package's ``gims_tpu/cli/match_pair_cli.py`` (its "minimum end-to-end
slice", SURVEY.md §7 'match_pair.py').

The same flags, printed lines, ``--npz`` keys and ``--out`` drawing
(``eval/viz.py``, written as PNG or JPEG by ``core/image_io.py``), plus
``--device``: it runs on ``cuda`` unless ``--device cpu``. Images are PNG,
baseline JPEG or BMP, decoded on the device. The staged ``Matching`` runs
by default, the fused single-program pipeline with ``--fused``. JAX's CLI
first turns on its persistent compilation cache (``core/cache.py``); the
port has no counterpart to call, since its only compiled code, the CUDA
kernels, is built once and cached by ``_build.py``.

    python -m gims_tpu_torch.cli.match_pair_cli a.jpg b.jpg --out m.png --npz m.npz \\
        --weights_path weights/gims_tpu_sift_last.npz --descriptor_source sift
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("image0")
    parser.add_argument("image1")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--out", type=str, default="matches.png")
    parser.add_argument("--npz", type=str, default=None)
    parser.add_argument("--sinkhorn_iterations", type=int, default=20)
    parser.add_argument("--match_threshold", type=float, default=0.02)
    parser.add_argument("--agc_r", type=float, default=15)
    parser.add_argument("--agc_p", type=float, default=2)
    parser.add_argument("--agc_m", type=int, default=7)
    parser.add_argument("--descriptor_source", type=str, default="carhynet",
                        choices=["carhynet", "sift", "dense", "dense_gray", "devsift"])
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="single-program pipeline (gims_tpu_torch/fused.py): "
                             "detection on the device, one dispatch per pair")
    parser.add_argument("--total_keypoints", type=int, default=12288,
                        help="--fused keypoint budget")
    parser.add_argument("--device", default=None, help="torch device (default cuda)")
    return parser


def build_matcher(args):
    """The ``Matching`` or ``FusedMatching`` that the flags configure."""
    fast = ({"attention_dtype": "bfloat16", "use_pallas_sinkhorn": True,
             "fast_frontend": True} if args.fast else {})
    if args.fused:
        from gims_tpu_torch.fused import FusedMatching

        variables = None
        if args.weights_path:
            from gims_tpu_torch.matcher.convert import load_gims_checkpoint

            variables = load_gims_checkpoint(args.weights_path)
        return FusedMatching({
            "sinkhorn_iterations": args.sinkhorn_iterations,
            "match_threshold": args.match_threshold,
            "descriptor_source": args.descriptor_source,
            "radius": args.agc_r, "percentile": args.agc_p, "min_size": args.agc_m,
            **fast,
        }, variables=variables, total_keypoints=args.total_keypoints, device=args.device)
    from gims_tpu_torch.api import Matching

    return Matching({
        "weights_path": args.weights_path,
        "sinkhorn_iterations": args.sinkhorn_iterations,
        "match_threshold": args.match_threshold,
        "max_keypoints": -1,
        "descriptor_source": args.descriptor_source,
        **fast,
    }, device=args.device)


def run(matcher, img0, img1, args):
    """One pair through `matcher` as the flags say; the prediction."""
    if args.fused:
        return matcher(img0, img1)
    return matcher({
        "image0": img0[None], "image1": img1[None],
        "radius": args.agc_r, "percentile": args.agc_p, "min_size": args.agc_m,
    })


def main(argv=None):
    from gims_tpu_torch.core import image_io
    from gims_tpu_torch.eval.viz import draw_matches

    args = build_parser().parse_args(argv)
    matcher = build_matcher(args)
    img0 = image_io.imread(args.image0, image_io.IMREAD_COLOR, device=matcher.device)
    img1 = image_io.imread(args.image1, image_io.IMREAD_COLOR, device=matcher.device)
    pred = run(matcher, img0, img1, args)
    kpts0 = pred["keypoints0"][0]
    kpts1 = pred["keypoints1"][0]
    matches = pred["matches0"][0]
    valid = matches > -1
    print(f"keypoints: {len(kpts0)} / {len(kpts1)}; matches: {int(valid.sum())}")
    print("timings:", {k: round(v, 3) for k, v in matcher.timings.items()})
    if args.npz:
        np.savez(args.npz, keypoints0=kpts0, keypoints1=kpts1, matches=matches,
                 match_confidence=pred["matching_scores0"][0])
    viz = draw_matches(img0, img1, kpts0[valid], kpts1[matches[valid]])
    image_io.imwrite(args.out, viz)
    return pred


if __name__ == "__main__":
    main()
