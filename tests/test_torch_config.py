"""Config, checkpoint reading and bucketing: the PyTorch port against the
JAX package (exact equality: these are plain data)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from gims_tpu import config as jconfig
from gims_tpu.core import bucketing as jbucketing
from gims_tpu.core.checkpoint import unflatten_npz as junflatten
from gims_tpu_torch import config as tconfig
from gims_tpu_torch.core import bucketing as tbucketing
from gims_tpu_torch.core.checkpoint import unflatten_npz as tunflatten
from gims_tpu_torch.core.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["AGCConfig", "MatcherConfig", "FrontendConfig", "DatasetConfig",
           "OptimizerConfig", "TrainConfig", "GIMSConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_equal(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
                         + [None])
def test_load_config_equal(path):
    overrides = {"agc": {"radius": 15.0, "min_size": 7},
                 "train_params": {"tf_layers": 4, "attention_dtype": "bfloat16"}}
    for ov in (None, overrides):
        want = dataclasses.asdict(jconfig.load_config(path, ov))
        got = dataclasses.asdict(tconfig.load_config(path, ov))
        assert got == want


def test_unflatten_npz_equal(tmp_path):
    rng = np.random.RandomState(0)
    flat = {"params::a::kernel": rng.randn(3, 4).astype(np.float32),
            "params::a::bias": rng.randn(4).astype(np.float32),
            "batch_stats::n::mean": rng.randn(2).astype(np.float32),
            "params::bin_score": np.float32(1.5)}
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat)
    want, got = junflatten(path), tunflatten(path)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys()
    for key in w:
        np.testing.assert_array_equal(w[key], g[key])


@pytest.mark.parametrize("n", [0, 1, 128, 129, 2000, 7000, 30000])
def test_bucketing_equal(n):
    assert tbucketing.DEFAULT_BUCKETS == jbucketing.DEFAULT_BUCKETS
    assert tbucketing.bucket_size(n) == jbucketing.bucket_size(n)
    rng = np.random.RandomState(n)
    kpts = rng.rand(min(n, 24576), 2).astype(np.float32) * 100
    descs = rng.rand(len(kpts), 8).astype(np.float32)
    scores = rng.rand(len(kpts)).astype(np.float32)
    for w, g in zip(jbucketing.pad_keypoint_set(kpts, descs, scores),
                    tbucketing.pad_keypoint_set(kpts, descs, scores)):
        np.testing.assert_array_equal(w, g)
    mask = rng.rand(37) < 0.5
    for w, g in zip(jbucketing.compact_indices(mask),
                    tbucketing.compact_indices(mask)):
        np.testing.assert_array_equal(w, g)


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
