"""The port's native library (``gims_tpu_torch/native``) against the JAX
package's bridge, on ``tests/test_native.py``'s four cases: the same inputs
through both, outputs equal to the bit (the same C++ and the same
``mt19937(42)`` samples; no tolerance). The port builds its own copy with
g++ into ``gims_tpu_torch/_build/``; the JAX side loads its own library.
"""

import os

import numpy as np
import pytest

from gims_tpu.native.bridge import CPPbridge as JaxBridge
from gims_tpu.native.bridge import build_library as jax_build
from gims_tpu_torch.native import bridge as port_native
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def bridges():
    jax_build()
    return JaxBridge(), port_native.CPPbridge()


def test_port_builds_its_own_library():
    path = port_native.build_library()
    assert os.path.dirname(path) == os.path.join(os.path.dirname(port_native.__file__)
                                                 .rsplit(os.sep, 1)[0], "_build")
    assert os.path.basename(path).startswith("libgims_native_")


def test_knn_matcher_equals_jax(bridges):
    rng = np.random.RandomState(0)
    nq, nt, d = 40, 50, 16
    qd = rng.randn(nq, d).astype(np.float32)
    td = rng.randn(nt, d).astype(np.float32)
    qk = rng.rand(nq, 2).astype(np.float32) * 100
    tk = rng.rand(nt, 2).astype(np.float32) * 100
    outs = []
    for b in bridges:
        b.CreateMatcher(d, k=1, sim_thres=0.95)
        b.KnnMatch(qk, qd, tk, td)
        outs.append(b.all_matches())
    assert outs[0] == outs[1] and len(outs[1]) > 0


def test_geometric_filter_homography_equals_jax(bridges):
    rng = np.random.RandomState(0)
    n = 200
    H = np.array([[1.1, 0.05, 10.0], [-0.04, 0.95, -5.0], [1e-4, -2e-5, 1.0]])
    src = rng.rand(n, 2) * 300
    proj = np.concatenate([src, np.ones((n, 1))], 1) @ H.T
    dst = proj[:, :2] / proj[:, 2:3]
    dst[:60] = rng.rand(60, 2) * 300 + 400
    im = np.zeros((480, 640, 3), np.uint8)
    outs = [b.GeometricFilter(src.reshape(-1).astype(np.float32), im,
                              dst.reshape(-1).astype(np.float32), im, "ORSA_H", precision=3.0)
            for b in bridges]
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])
    assert outs[1][0][60:].mean() > 0.95 and outs[1][0][:60].mean() < 0.05


def test_geometric_filter_from_matcher_equals_jax(bridges):
    rng = np.random.RandomState(0)
    n, d = 80, 8
    H = np.array([[1.0, 0.02, 5.0], [-0.01, 1.0, -3.0], [0, 0, 1.0]])
    qk = (rng.rand(n, 2) * 200).astype(np.float32)
    proj = np.concatenate([qk, np.ones((n, 1))], 1) @ H.T
    tk = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
    desc = rng.randn(n, d).astype(np.float32)
    noisy = desc + rng.randn(n, d).astype(np.float32) * 0.01
    outs = []
    for b in bridges:
        b.CreateMatcher(d, k=1, sim_thres=1.0)
        b.KnnMatch(qk, desc, tk, noisy)
        outs.append(b.GeometricFilterFromMatcher(np.zeros((240, 320)), np.zeros((240, 320)),
                                                 precision=3.0))
    assert outs[0][0] == outs[1][0] and np.array_equal(outs[0][1], outs[1][1])
    assert len(outs[1][0]) > 0.5 * n


def test_fastmatcombi_equals_jax(bridges):
    rng = np.random.RandomState(0)
    n, m = 6, 32
    ps1 = rng.rand(n, m).astype(np.float32)
    ps2 = rng.rand(n, m).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    outs = []
    for b in bridges:
        bP = np.zeros((n, n), np.float32)
        b.PrepareForFastMatCombi(n)
        b.FastMatCombi(bP, idx, ps1, idx, ps2, m)
        bP2 = bP.copy()
        b.FastMatCombi(bP2, idx, ps1 * 0, idx, ps2 * 0, m)  # cached values survive
        outs.append((bP, bP2))
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])
    np.testing.assert_allclose(outs[1][0], np.linalg.norm(ps1[:, None] - ps2[None], axis=-1),
                               rtol=1e-5, atol=1e-6)
