"""The homography benchmark end to end in both packages on the CPU.

``run_benchmark`` on 3 pairs of the port's ``generate_benchmark`` (120x160,
seed 3) with a ``Matching`` of each package: the first 4 GNN layers of
``weights/gims_tpu_sift_last.npz``, SIFT descriptors from the device
detector (``detector="device"``, ``sift_descriptor="device"``), every
detected keypoint (``max_keypoints=-1``, the harness's default), f32, 20
Sinkhorn iterations, threshold 0.02, AGC 15/2/7. Both harnesses read the
pairs through the port's ``read_image_with_homography`` (patched into the
JAX module): OpenCV's warp differs from the port's by one gray level on a
few pixels, enough to move a detected keypoint, and
``tests/test_torch_eval.py`` holds the two readers to each other.

- The harnesses: the port's ``run_benchmark`` replays the JAX
  ``Matching``'s answers, so both harnesses see the same matches. The
  ``_matches.npz`` artifacts and ``results.txt`` equal; precision and
  recall exact; DLT AUCs to 1e-4 relative; RANSAC AUC@k within
  100 * 0.25 / k points (each pair's RANSAC error within 0.25 px of
  OpenCV's moves AUC@k by at most 0.25 / k); per pair ``error_ransac``
  within 0.25 px and ``error_dlt`` to 1e-4 relative.
- The port's ``Matching`` in the port's harness against JAX's: the device
  detectors may differ by one borderline candidate per image (a score
  within 1e-4 of the contrast threshold, as ``tests/test_torch_staged.py``
  allows; at this size one image of the six does). So: per image the kept
  counts within 1 of JAX's; for pairs whose kept counts agree, matches
  equal, keypoints 1e-3 px and confidences 5e-3 (SIFT descriptors differ
  by one integer step, ~2e-3 here, and 4 trained layers carry that into
  the scores); every pair evaluated.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gims_tpu.api import Matching as JMatching
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import GIMSConfig as JGIMSConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.eval import homography as jhomography
from gims_tpu_torch.api import Matching
from gims_tpu_torch.config import FrontendConfig, GIMSConfig, MatcherConfig
from gims_tpu_torch.eval import homography
from gims_tpu_torch.matcher.convert import load_gims_checkpoint
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
LAYERS = 4
FRAME = (120, 160)


def first_layers(tree, n):
    """The variables tree without the GNN layers from `n` on."""
    out = {}
    for k, v in tree.items():
        if k.startswith("layer_") and int(k.split("_")[1]) >= n:
            continue
        out[k] = first_layers(v, n) if isinstance(v, dict) else v
    return out


class Replay:
    """A matcher that gives the answers another one gave, in order."""

    def __init__(self, answers):
        self.answers = list(answers)

    def __call__(self, data):
        return self.answers.pop(0)


class Recording:
    def __init__(self, matcher):
        self.matcher, self.answers = matcher, []

    def __call__(self, data):
        self.answers.append(self.matcher(data))
        return self.answers[-1]


@pytest.fixture(scope="module")
def benchmark(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    txt, images = homography.generate_benchmark(str(tmp / "set"), n_pairs=3,
                                                height=FRAME[0], width=FRAME[1])
    variables = first_layers(load_gims_checkpoint(WEIGHTS), LAYERS)
    mkw = dict(num_gnn_layers=LAYERS, sinkhorn_iterations=20, match_threshold=0.02)
    fkw = dict(descriptor_source="sift", detector="device", sift_descriptor="device",
               max_keypoints=-1)
    jm = Recording(JMatching(
        JGIMSConfig(matcher=JMatcherConfig(**mkw), frontend=JFrontendConfig(**fkw)),
        variables=jax.tree_util.tree_map(jnp.asarray, variables)))
    tm = Matching(GIMSConfig(matcher=MatcherConfig(**mkw), frontend=FrontendConfig(**fkw)),
                  variables=variables, device="cpu")
    kw = dict(resize=(FRAME[1], FRAME[0]), agc={"radius": 15, "percentile": 2, "min_size": 7})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhomography, "read_image_with_homography",
                   homography.read_image_with_homography)
        jres = jhomography.run_benchmark(txt, images, str(tmp / "jax"), matcher=jm, **kw)
    rres = homography.run_benchmark(txt, images, str(tmp / "replay"),
                                    matcher=Replay(jm.answers), device="cpu", **kw)
    tres = homography.run_benchmark(txt, images, str(tmp / "port"), matcher=tm, device="cpu",
                                    **kw)
    return tmp, jres, rres, tres


def artifacts(tmp, run, suffix):
    return {f: np.load(tmp / run / f) for f in sorted(os.listdir(tmp / run))
            if f.endswith(suffix)}


def test_run_benchmark_harness_matches_jax(benchmark):
    tmp, jres, rres, _ = benchmark
    jm, rm = artifacts(tmp, "jax", "_matches.npz"), artifacts(tmp, "replay", "_matches.npz")
    assert len(jm) == 3 and list(jm) == list(rm)
    for name in jm:
        for k in jm[name].files:
            assert np.array_equal(jm[name][k], rm[name][k])
        assert (jm[name]["matches"] >= 0).sum() >= 12
    assert open(tmp / "jax" / "result" / "results.txt").read() == \
        open(tmp / "replay" / "result" / "results.txt").read()
    assert jres is not None and rres is not None
    assert rres["precision"] == jres["precision"] and rres["recall"] == jres["recall"]
    np.testing.assert_allclose(rres["dlt_auc"], jres["dlt_auc"], rtol=1e-4, atol=1e-9)
    for k, r, j in zip((5, 10, 25), rres["ransac_auc"], jres["ransac_auc"]):
        assert abs(r - j) <= 100 * 0.25 / k, (k, r, j)
    je, re = artifacts(tmp, "jax", "_evaluation.npz"), artifacts(tmp, "replay", "_evaluation.npz")
    assert list(je) == list(re)
    for name in je:
        j, r = je[name], re[name]
        assert sorted(j.files) == sorted(r.files)
        assert float(r["precision"]) == float(j["precision"])
        assert float(r["recall"]) == float(j["recall"])
        assert abs(float(r["error_ransac"]) - float(j["error_ransac"])) <= 0.25
        assert abs(float(r["error_dlt"]) - float(j["error_dlt"])) <= 1e-4 * abs(
            float(j["error_dlt"]))


def test_run_benchmark_port_matching_matches_jax(benchmark):
    tmp, jres, _, tres = benchmark
    jm, tm = artifacts(tmp, "jax", "_matches.npz"), artifacts(tmp, "port", "_matches.npz")
    assert list(jm) == list(tm)
    same = 0
    for name in jm:
        j, t = jm[name], tm[name]
        n = [(len(j[k]), len(t[k])) for k in ("keypoints0", "keypoints1")]
        assert all(abs(a - b) <= 1 for a, b in n), (name, n)
        if all(a == b for a, b in n):
            same += 1
            assert np.array_equal(j["matches"], t["matches"])
            for k in ("keypoints0", "keypoints1"):
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-3)
            np.testing.assert_allclose(t["match_confidence"], j["match_confidence"],
                                       rtol=0, atol=5e-3)
    assert same >= 2
    lines = open(tmp / "port" / "result" / "results.txt").read().split("\n")
    assert len(lines) == 3 and not any(l.endswith("=> 0") for l in lines)
    assert tres is not None and np.isfinite(tres["ransac_auc"]).all()
