"""The classic trainer of the PyTorch port (``train/loop.py`` without
``fused_e2e``) against the JAX package's, on the CPU.

- ``row_seeds``: equal.
- ``build_batch`` with one stub frontend that hands both packages the same
  padded keypoints and descriptors: the ground-truth rows and validity
  equal, the bf16 descriptor halves equal.
- ``build_batch_raw`` on one small pair (OpenCV's SIFT in JAX, the port's in
  torch, same top-up seeds): the tolerances of ``tests/test_torch_sift.py``
  (at least 98% of the keypoints within 1e-3 px, 99% of the descriptor
  bytes within one level).
- ``train()`` on the CPU at 96x128 and 256 keypoints with host SIFT
  descriptors: two epochs of one batch with ``cache_features`` (the second
  epoch takes the cached batch: no data or preprocessing time), finite
  losses, last/minloss checkpoints and the EMA npz; a resume continues the
  step count; the CLI without ``--fused_e2e`` runs; two CPU ranks run
  (``tests/test_torch_distributed.py`` holds them to one rank).
- ``CocoPairDataset`` on a PNG ``train2017/`` folder (with and without the
  annotations json): H equal, images within the tolerance of the other
  datasets (two levels on at most 2% of the pixels); a JPEG raises.
"""

import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import torch

from gims_tpu.config import DatasetConfig as JDatasetConfig
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.train import data as jdata
from gims_tpu.train import loop as jloop
from gims_tpu_torch.cli import train_cli
from gims_tpu_torch.config import DatasetConfig, FrontendConfig, load_config
from gims_tpu_torch.train import data as tdata
from gims_tpu_torch.train import loop as tloop
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"image_height": 96, "image_width": 128}


def test_row_seeds_match_jax():
    idxs = np.array([0, 5, 17, 123456])
    np.testing.assert_array_equal(tloop.row_seeds(idxs, 3), jloop.row_seeds(idxs, 3))


class _Stub:
    """A frontend that returns fixed padded features per image: keypoints
    on a grid of the first image and their homography images on the
    second, so the ground truth has matches."""

    def __init__(self, pairs, nb, to):
        self.table = {}
        rng = np.random.RandomState(0)
        for orig, warped, H in pairs:
            k0 = (rng.rand(nb, 2) * [128, 96]).astype(np.float32)
            p = np.concatenate([k0, np.ones((nb, 1), np.float32)], 1) @ H.T.astype(np.float64)
            k1 = (p[:, :2] / p[:, 2:] + rng.randn(nb, 2) * 0.5).astype(np.float32)
            for img, k in ((orig, k0), (warped, k1)):
                valid = rng.rand(nb) < 0.9
                desc = rng.rand(nb, 128).astype(np.float32)
                self.table[img.tobytes()] = (k, np.concatenate([desc, desc], 1), valid)
        self.to = to

    def extract_padded(self, img, max_keypoints=None, bucket=None, train_topup=False, rng=None):
        k, d, v = self.table[img.tobytes()]
        return {"kpts": self.to(k), "desc": self.to(d), "valid": self.to(v)}


def test_build_batch_gt_matches_jax():
    import jax.numpy as jnp

    ds = tdata.SyntheticPairDataset(DatasetConfig(**SMALL), length=2, seed=1)
    pairs = [ds[0], ds[1]]
    seeds = tloop.row_seeds([0, 1], 0)
    want = jloop.build_batch(_Stub(pairs, 64, jnp.asarray), pairs, 64, None, seeds=seeds)
    got = tloop.build_batch(_Stub(pairs, 64, torch.from_numpy), pairs, 64, None, seeds=seeds)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(jnp.asarray(want[key], jnp.float32) if key.startswith("desc")
                       else want[key])
        g = got[key].float().numpy() if key.startswith("desc") else got[key].numpy()
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert int(np.asarray(want["gt_valid"]).sum()) > 0


def test_build_batch_raw_matches_jax():
    import jax

    ds = tdata.SyntheticPairDataset(DatasetConfig(**SMALL), length=1, seed=3)
    pairs = [ds[0]]
    seeds = tloop.row_seeds([0], 0)
    fe = dict(descriptor_source="sift", max_keypoints=256)
    want = jax.device_get(jloop.build_batch_raw(JFrontendConfig(**fe), pairs, 256, None,
                                                seeds=seeds))
    got = tloop.build_batch_raw(FrontendConfig(**fe), pairs, 256, None, seeds=seeds,
                                device="cpu")
    np.testing.assert_array_equal(got["homography"].numpy(), want["homography"])
    for s in ("0", "1"):
        wk, gk = np.asarray(want["kpts" + s][0]), got["kpts" + s][0].numpy()
        # rows in the same order: the same keypoint at the same index
        same = np.linalg.norm(wk - gk, axis=1) <= 1e-3
        assert same.mean() >= 0.98, same.mean()
        assert got["valid" + s].numpy().sum() == np.asarray(want["valid" + s]).sum() == 256
        wd = np.asarray(want["desc" + s + "_u8"][0]).astype(int)[same]
        gd = got["desc" + s + "_u8"][0].numpy().astype(int)[same]
        assert (np.abs(gd - wd) <= 1).mean() >= 0.99


def _small_cfg(tmp_path, epochs=2):
    cfg = load_config(os.path.join(REPO, "configs", "synth_sift.yaml"))
    return dataclasses.replace(
        cfg, dataset=dataclasses.replace(cfg.dataset, dataset_path=str(tmp_path / "none"),
                                         **SMALL),
        train=dataclasses.replace(cfg.train, max_keypoints=256, val_images_count=1,
                                  num_epochs=epochs, output_dir=str(tmp_path)),
        frontend=dataclasses.replace(cfg.frontend, descriptor_source="sift"))


def test_classic_train_resume_cache_and_cli(tmp_path):
    cfg = _small_cfg(tmp_path)
    logs = []
    state = tloop.train(cfg, save_dir=str(tmp_path / "run"), limit=1, cache_features=True,
                        device="cpu", log_fn=logs.append)
    assert state.step == 2 and state.opt_state["count"] == 2 and state.ema_updates == 2
    recs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert len(recs) == 2 and all(np.isfinite(r["total_loss"]) for r in recs)
    assert recs[0]["preprocess_time"] > 0
    assert recs[1]["data_time"] == recs[1]["preprocess_time"] == 0.0  # the cached batch
    weights = tmp_path / "run" / "weights"
    for name in ("last.pt", "best.pt", "minloss.pt", "last.npz"):
        assert (weights / name).exists() or name == "best.pt", name
    assert sum(str(x).startswith("Validation:") for x in logs) == 2
    resumed = tloop.train(_small_cfg(tmp_path, epochs=3), save_dir=str(tmp_path / "run"),
                          limit=1, restore_path=str(weights / "last"), device="cpu",
                          log_fn=logs.append)
    assert resumed.step == 3 and resumed.opt_state["count"] == 3
    dp = tloop.train(_small_cfg(tmp_path, epochs=1), save_dir=str(tmp_path / "dp"), limit=2,
                     n_devices=2, device="cpu")  # one step of a pair a rank
    assert dp.step == 1 and (tmp_path / "dp" / "weights" / "last.npz").exists()
    yaml = tmp_path / "small.yaml"
    yaml.write_text(f"""train_params:
  output_dir: {tmp_path}
  max_keypoints: 256
  val_images_count: 1
  num_epochs: 1
dataset_params:
  dataset_path: {tmp_path / 'none'}
  image_height: 96
  image_width: 128
""")
    st = train_cli.main(["--config_path", str(yaml), "--name", "cli", "--limit", "1",
                         "--descriptor_source", "sift", "--device", "cpu"])
    assert st.step == 1 and (tmp_path / "cli" / "weights" / "last.npz").exists()


@pytest.mark.parametrize("with_json", [False, True])
def test_coco_pair_dataset_matches_jax(tmp_path, with_json):
    root = tmp_path / "coco"
    (root / "train2017").mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = ["b.png", "a.png", "c.png"]
    for n in names:
        low = rng.randint(0, 255, (30, 40, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "train2017" / n),
                    cv2.GaussianBlur(cv2.resize(low, (160, 120)), (0, 0), 1.5))
    if with_json:
        (root / "annotations").mkdir()
        (root / "annotations" / "instances_train2017.json").write_text(
            json.dumps({"images": [{"file_name": n} for n in names]}))
    kw = dict(dataset_path=str(root), **SMALL)
    jd = jdata.CocoPairDataset(JDatasetConfig(**kw), "train", limit=2, seed=4)
    td = tdata.CocoPairDataset(DatasetConfig(**kw), "train", limit=2, seed=4)
    assert td.files == jd.files and len(td) == 2
    for i in range(2):
        (j0, j1, jh), (t0, t1, th) = jd[i], td[i]
        np.testing.assert_array_equal(th, jh)
        for a, b in ((t0, j0), (t1, j1)):
            assert a.shape == b.shape == (96, 128, 3)
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 2 and (d > 0).mean() <= 2e-2
    # a JPEG image: the port's decoder against JAX's cv2.imread
    low = rng.randint(0, 255, (30, 40, 3)).astype(np.uint8)
    cv2.imwrite(str(root / "train2017" / "d.jpg"),
                cv2.GaussianBlur(cv2.resize(low, (160, 120)), (0, 0), 1.5))
    if with_json:
        (root / "annotations" / "instances_train2017.json").write_text(
            json.dumps({"images": [{"file_name": n} for n in names + ["d.jpg"]]}))
    tjpeg = tdata.CocoPairDataset(DatasetConfig(**kw), "train", seed=4)
    jjpeg = jdata.CocoPairDataset(JDatasetConfig(**kw), "train", seed=4)
    assert tjpeg.files == jjpeg.files
    i = tjpeg.files.index("d.jpg")
    (j0, j1, jh), (t0, t1, th) = jjpeg[i], tjpeg[i]
    np.testing.assert_array_equal(th, jh)
    for a, b in ((t0, j0), (t1, j1)):
        assert a.shape == b.shape == (96, 128, 3)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 2 and (d > 0).mean() <= 2e-2
