"""Homography-benchmark CLI — flag parity with the JAX package's
``gims_tpu/cli/eval_homography_cli.py`` (reference eval_homography.py:108-125),
plus ``--detector`` and ``--sift_descriptor`` (the choices of
``scripts/quality_eval.py``) and ``--device``. The JAX defaults
(``--detector host``, ``--sift_descriptor host``) run OpenCV's SIFT as the
port computes it, on the device (``frontend/sift.py``); ``device`` takes
the DoG detector and the sampled-grid SIFT descriptor. ``--save_viz``
raises (OpenCV drawing). Runs on ``cuda`` unless ``--device cpu``.

    python -m gims_tpu_torch.cli.eval_homography_cli --generate 8 --fast \\
        --weights_path weights/gims_tpu_sift_last.npz --descriptor_source sift \\
        --max_keypoints 2048
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_homography", type=str,
                        default="./assets/coco_test_images_homo.txt")
    parser.add_argument("--input_dir", type=str,
                        default="./assets/coco_test_images/")
    parser.add_argument("--output_dir", type=str,
                        default="./output/dump/dump_homo_pairs")
    parser.add_argument("--max_length", type=int, default=-1)
    parser.add_argument("--resize", type=int, nargs="+", default=[800, 600])
    parser.add_argument("--weights_path", default=None)
    parser.add_argument("--max_keypoints", type=int, default=-1)
    parser.add_argument("--sinkhorn_iterations", type=int, default=20)
    parser.add_argument("--min_matches", type=int, default=12)
    parser.add_argument("--match_threshold", type=float, default=0.02)
    parser.add_argument("--no_shuffle", action="store_true")
    parser.add_argument("--name", type=str, default="gims")
    parser.add_argument("--agc_r", type=float, default=15)
    parser.add_argument("--agc_p", type=float, default=2)
    parser.add_argument("--agc_m", type=int, default=7)
    parser.add_argument("--save_viz", action="store_true",
                        help="not ported (OpenCV drawing): raises")
    parser.add_argument("--generate", type=int, default=0,
                        help="synthesize N benchmark pairs if assets missing")
    parser.add_argument("--source_dir", type=str, default=None,
                        help="--generate source images (PNG); procedural "
                             "textures when omitted")
    parser.add_argument("--gen_out", type=str,
                        default="./assets/generated_benchmark",
                        help="--generate output directory")
    parser.add_argument("--delaunay", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="speed path: bf16 attention, the Sinkhorn kernel, "
                             "linear 32x32 patch sampling")
    parser.add_argument("--descriptor_source", type=str, default="carhynet",
                        choices=["carhynet", "sift", "dense", "dense_gray"])
    parser.add_argument("--detector", default="host", choices=["host", "device"],
                        help="keypoint detector: OpenCV's SIFT (computed by the port, "
                             "on the device) or the device DoG detector")
    parser.add_argument("--sift_descriptor", default="host", choices=["host", "device"],
                        help="--descriptor_source sift: OpenCV's SIFT descriptor "
                             "(computed by the port, on the device) or the sampled-grid "
                             "device descriptor")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    return parser


def main(argv=None, dgims=False):
    parser = build_parser()
    parser.set_defaults(delaunay=dgims)
    args = parser.parse_args(argv)

    if args.generate and (args.source_dir
                          or not os.path.exists(args.input_homography)):
        from gims_tpu_torch.eval.homography import generate_benchmark

        txt, images = generate_benchmark(
            args.gen_out, n_pairs=args.generate, source_dir=args.source_dir
        )
        args.input_homography, args.input_dir = txt, images
        print(f"Generated benchmark: {txt}")

    from gims_tpu_torch.api import Matching
    from gims_tpu_torch.eval.homography import run_benchmark

    agc = {"radius": args.agc_r, "percentile": args.agc_p,
           "min_size": args.agc_m}
    if args.delaunay:
        agc["delaunay"] = True
    matcher = Matching({
        "weights_path": args.weights_path,
        "sinkhorn_iterations": args.sinkhorn_iterations,
        "match_threshold": args.match_threshold,
        "max_keypoints": args.max_keypoints,
        "descriptor_source": args.descriptor_source,
        "detector": args.detector,
        "sift_descriptor": args.sift_descriptor,
        **({"attention_dtype": "bfloat16", "use_pallas_sinkhorn": True,
            "fast_frontend": True} if args.fast else {}),
    }, device=args.device)
    results = run_benchmark(
        args.input_homography, args.input_dir,
        args.output_dir + "_" + args.name,
        weights_path=args.weights_path,
        resize=tuple(args.resize),
        sinkhorn_iterations=args.sinkhorn_iterations,
        match_threshold=args.match_threshold,
        max_keypoints=args.max_keypoints,
        agc=agc,
        max_length=args.max_length,
        shuffle=not args.no_shuffle,
        min_matches=args.min_matches,
        save_viz=args.save_viz,
        matcher=matcher,
        device=args.device,
    )
    return results


if __name__ == "__main__":
    main()
