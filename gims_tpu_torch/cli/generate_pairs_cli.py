"""Pair-generation CLI (reference generate_pairs.py), with the flags of the
JAX package's ``gims_tpu/cli/generate_pairs_cli.py``: sample images (PNG),
apply random perspective homographies, write 'name h00..h22' lines plus
side-by-side PNGs. The port's PNG I/O and warp stand in for OpenCV's.

    python -m gims_tpu_torch.cli.generate_pairs_cli --image_dir dir \\
        --txt_path pairs.txt --image_save_path out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gims_tpu_torch.core import image_io, imgproc
from gims_tpu_torch.train.data import get_perspective_mat


def process(image_dir, txt_path, image_save_path, rng=None):
    rng = rng or np.random.RandomState(3)
    os.makedirs(image_save_path, exist_ok=True)
    lines = []
    content = sorted(os.listdir(image_dir))
    for kk, name in enumerate(content):
        if os.path.splitext(name)[-1] not in (".jpg", ".png", ".jpeg"):
            continue
        image = image_io.imread(os.path.join(image_dir, name))
        height, width = image.shape[:2]
        H = get_perspective_mat(
            0.85, center_x=width // 2, center_y=height // 2,
            pers_x=0.0008, pers_y=0.0008, shear_ratio=0.04, shear_angle=10,
            rotation_angle=25, scale=0.6, trans=0.6, rng=rng,
        )
        warped = imgproc.warp_perspective(image.copy(), H, (width, height))
        lines.append(name + " " + " ".join(str(float(v))
                                           for v in H.reshape(-1)))
        image_io.imwrite(os.path.join(image_save_path, f"{kk + 1}.png"),
                         np.concatenate([image, warped], axis=1))
    with open(txt_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--txt_path", type=str, required=True)
    parser.add_argument("--image_save_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=3)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    process(args.image_dir, args.txt_path, args.image_save_path,
            np.random.RandomState(args.seed))


if __name__ == "__main__":
    main()
