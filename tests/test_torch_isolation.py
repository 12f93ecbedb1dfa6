"""Guards of the GPU run that can be checked on the CPU.

The machine with the card has torch and numpy but no JAX, flax, OpenCV,
PIL, PyYAML, networkx, scikit-learn, matplotlib or pandas, and the port must not import the JAX
package at all. A fresh interpreter with those imports refused must import
every module of ``gims_tpu_torch`` and ``chip_smoke``, and run the port's
host SIFT (OpenCV's algorithm, without OpenCV), a JPEG encode and decode,
and the demo's ``find_matches`` with its drawing. ``chip_smoke.py``
without a card must exit non-zero and print no result (no CPU fallback).
The kernels build with nvcc into a plain C library: no PyTorch extension
headers or builder.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gims_tpu_torch")
BLOCKED = ["jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "networkx", "sklearn", "gims_tpu",
           "matplotlib", "pandas"]
# modules the staged, fused, evaluation and training paths run, each imported with the
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
            "gims_tpu_torch.cli.eval_matches_cli", "gims_tpu_torch.cli.generate_pairs_cli",
            # the training slice
            "gims_tpu_torch.core.checkpoint", "gims_tpu_torch.train.step",
            "gims_tpu_torch.train.fused_step", "gims_tpu_torch.train.loop",
            "gims_tpu_torch.cli.train_cli",
            # host SIFT, the classic trainer and CAR-HyNet's trainer
            "gims_tpu_torch.carhynet.model", "gims_tpu_torch.carhynet.loss",
            "gims_tpu_torch.carhynet.train",
            # data parallelism and ring attention
            "gims_tpu_torch.train.multihost", "gims_tpu_torch.train.dp_check",
            "gims_tpu_torch.matcher.ring_attention",
            # keypoint-axis sharding
            "gims_tpu_torch.agc.sharded", "gims_tpu_torch.matcher.sharded",
            "gims_tpu_torch.train.shard_check",
            # the entry points, JPEG, the drawings, profiling
            "gims_tpu_torch.core.jpeg", "gims_tpu_torch.core.drawing",
            "gims_tpu_torch.core.text_glyphs", "gims_tpu_torch.core.profiling",
            "gims_tpu_torch.eval.viz", "gims_tpu_torch.cli.match_pair_cli",
            "gims_tpu_torch.cli.serve_cli",
            # deterministic sums, USAC, NMS, the native library and the tools
            "gims_tpu_torch.core.segsum", "gims_tpu_torch.eval.usac",
            "gims_tpu_torch.frontend.nms", "gims_tpu_torch.native.bridge",
            "gims_tpu_torch.core.viridis", "gims_tpu_torch.tools.parameter_search",
            "gims_tpu_torch.tools.image_viewer", "gims_tpu_torch.tools.parameter_visualize"]

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
# OpenCV's SIFT as the port computes it runs with cv2 refused
import numpy as np
from gims_tpu_torch.config import FrontendConfig
from gims_tpu_torch.frontend.sift import detect_and_describe
img = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
kp, desc = detect_and_describe(img, FrontendConfig(), 64, train_topup=True,
                               rng=np.random.RandomState(0), device="cpu")
assert len(kp) == 64 and desc.shape == (64, 128), (len(kp), desc.shape)
# a JPEG written and read, a drawing and the demo's find_matches, with cv2
# and PIL refused
from gims_tpu_torch.cli.serve_cli import find_matches
from gims_tpu_torch.core import image_io
from gims_tpu_torch.fused import FusedMatching
from gims_tpu_torch.synthetic import synthetic_image_pair
a, b, _ = synthetic_image_pair(1, (96, 128), colour=True)
a = image_io.imdecode(image_io.imencode(".jpg", a)[1])
viz, details = find_matches(FusedMatching({"descriptor_source": "dense_gray"},
                                          total_keypoints=256, device="cpu"),
                            a, b, resize_enabled=False)
assert viz.shape == (96, 256, 3) and details["keypoints0"] > 0, details
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
""" % (BLOCKED, REQUIRED)


def test_port_and_chip_smoke_import_without_blocked_packages():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 55  # package, subpackages and every module under them


SPAWNED = r"""
import importlib.abc, sys, tempfile
BLOCKED = set(%r)
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in BLOCKED:
            raise ImportError("blocked on the GPU machine: " + fullname)
        return None

sys.meta_path.insert(0, Refuse())
import torch
from gims_tpu_torch.train import dp_check, shard_check
case = {"q": torch.randn(1, 8, 2, 4), "k": torch.randn(1, 8, 2, 4),
        "v": torch.randn(1, 8, 2, 4), "mask": torch.ones(1, 8, dtype=torch.bool)}
with tempfile.TemporaryDirectory() as d:
    ranks = dp_check.run(dp_check.ring_rank, ["cpu", "cpu"], "gloo", {"cases": [case]}, d)
# the keypoint-sharded workers: a sharded AGC build
job = {"kind": "agc", "inputs": [torch.rand(1, 16, 2) * 50, torch.rand(1, 16, 8),
                                 torch.ones(1, 16, dtype=torch.bool)],
       "kwargs": {"radius": 20.0, "percentile": 5.0, "min_size": 2}}
with tempfile.TemporaryDirectory() as d:
    ranks += dp_check.run(shard_check.shard_rank, ["cpu", "cpu"], "gloo", {"jobs": [job]}, d)
for r in ranks:
    leaked = sorted(BLOCKED & set(r["modules"]))
    assert not leaked, leaked
print("ranks", len(ranks))
""" % (BLOCKED,)


def test_spawned_ranks_import_no_blocked_packages():
    """The ranks of the port's data-parallel and keypoint-sharded runs are fresh interpreters
    (spawn), where the parent's refusals do not reach: they report their
    modules, and none may be blocked."""
    proc = subprocess.run([sys.executable, "-c", SPAWNED], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ranks 4" in proc.stdout


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
