"""Guards of the GPU run that can be checked on the CPU.

The machine with the card has torch and numpy but no JAX, flax, OpenCV,
PIL, networkx or scikit-learn, and the port must not import the JAX
package at all. A fresh interpreter with those imports refused must import
every module of ``gims_tpu_torch`` and ``chip_smoke``. ``chip_smoke.py``
without a card must exit non-zero and print no result (no CPU fallback).
The kernels build with nvcc into a plain C library: no PyTorch extension
headers or builder.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gims_tpu_torch")
BLOCKED = ["jax", "jaxlib", "flax", "cv2", "PIL", "networkx", "sklearn", "gims_tpu"]
# modules the staged, fused and evaluation paths run, each imported with the
# blocked packages refused
REQUIRED = ["gims_tpu_torch.agc.band", "gims_tpu_torch.agc.graph", "gims_tpu_torch.agc.labels",
            "gims_tpu_torch.api", "gims_tpu_torch.carhynet.engine",
            "gims_tpu_torch.frontend.dense", "gims_tpu_torch.frontend.detect_device",
            "gims_tpu_torch.frontend.feature", "gims_tpu_torch.frontend.patches",
            "gims_tpu_torch.frontend.sift", "gims_tpu_torch.frontend.sift_descriptor",
            "gims_tpu_torch.fused", "gims_tpu_torch.matcher.pipeline",
            # the evaluation slice
            "gims_tpu_torch.core.image_io", "gims_tpu_torch.core.imgproc",
            "gims_tpu_torch.core.notify", "gims_tpu_torch.train.data", "gims_tpu_torch.train.gt",
            "gims_tpu_torch.eval.metrics", "gims_tpu_torch.eval.ransac",
            "gims_tpu_torch.eval.homography", "gims_tpu_torch.eval.matches",
            "gims_tpu_torch.eval.geometry", "gims_tpu_torch.cli.eval_homography_cli",
            "gims_tpu_torch.cli.eval_matches_cli", "gims_tpu_torch.cli.generate_pairs_cli"]

IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = set(%r)
for name in list(sys.modules):  # a site hook may have imported some already
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in BLOCKED:
            raise ImportError("blocked on the GPU machine: " + fullname)
        return None

sys.meta_path.insert(0, Refuse())
import gims_tpu_torch
names = ["gims_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    gims_tpu_torch.__path__, "gims_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = set(%r) - set(names)
assert not missing, missing
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
""" % (BLOCKED, REQUIRED)


def test_port_and_chip_smoke_import_without_blocked_packages():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 51  # package, subpackages and every module under them


def test_chip_smoke_without_cuda_exits_nonzero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_no_torch_extension_build():
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".h", ".cpp")):
                text = open(os.path.join(root, f), encoding="utf-8").read()
                for needle in ("torch/extension.h", "cpp_extension"):
                    if needle in text:
                        hits.append((f, needle))
    assert hits == []
