"""CAR-HyNet's training in the PyTorch port against the JAX package's
(``gims_tpu/carhynet/loss.py``, ``gims_tpu/carhynet/train.py``), on the CPU.

- ``hynet_loss`` (plain and SOS) and ``cal_fpr95`` equal JAX's within 1e-5.
- One ``make_descriptor_train_step`` of both packages from the same
  variables (``CARHyNet(drop_rate=0.0)``: JAX's dropout bits cannot be drawn
  in torch): the loss within 1e-5, every parameter and running statistic
  after the Adam step within 2e-5.
- The dropout keeps 1 - drop_rate of the head's inputs, scaled by
  1 / (1 - drop_rate), drawn from the caller's generator.
- ``SyntheticPatchPairs`` of one seed: the same crops, angles and noise;
  OpenCV's cubic 8x upscale of the texture differs by one level on ~2% of
  its pixels in the port (``core/imgproc.py``), so patches agree within
  1.5/255.
- ``read_ubc_montages`` of BMP montages that OpenCV wrote: equal.
"""

import numpy as np
import pytest
import torch

from gims_tpu.carhynet import loss as jloss
from gims_tpu.carhynet import train as jtrain
from gims_tpu.carhynet.model import CARHyNet as JCARHyNet
from gims_tpu_torch.carhynet import loss as tloss
from gims_tpu_torch.carhynet import train as ttrain
from gims_tpu_torch.carhynet.convert import load_variables, module_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


def _descs(rng, n, d=128):
    raw = rng.randn(n, d).astype(np.float32)
    return raw / np.linalg.norm(raw, axis=1, keepdims=True), raw


@pytest.mark.parametrize("is_sosr", [False, True])
def test_hynet_loss_matches_jax(is_sosr):
    rng = np.random.RandomState(3)
    dl, rl = _descs(rng, 48)
    dr = dl + 0.3 * rng.randn(48, 128).astype(np.float32)
    rr = dr.copy()
    dr = dr / np.linalg.norm(dr, axis=1, keepdims=True)
    want = jloss.hynet_loss(dl, dr, rl, rr, is_sosr=is_sosr)
    got = tloss.hynet_loss(*(torch.from_numpy(x) for x in (dl, dr, rl, rr)), is_sosr=is_sosr)
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-5)
    dist = np.asarray(jloss.l2_distance_matrix(dl, dr))
    np.testing.assert_allclose(tloss.l2_distance_matrix(torch.from_numpy(dl),
                                                        torch.from_numpy(dr)).numpy(),
                               dist, rtol=1e-5, atol=1e-5)
    pos, neg = np.diag(dist), dist[~np.eye(48, dtype=bool)]
    assert tloss.cal_fpr95(pos, neg) == jloss.cal_fpr95(pos, neg)


def test_descriptor_train_step_matches_jax():
    import jax
    import jax.numpy as jnp
    import optax

    jmodel = JCARHyNet(drop_rate=0.0)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)),
                                           train=False))
    synth = jtrain.SyntheticPatchPairs(seed=4)
    left, right = synth.batch(24)
    jstep = jtrain.make_descriptor_train_step(jmodel, optax.adam(1e-3))
    tx = optax.adam(1e-3)
    params, bs, _, jl, jdp, jdn = jstep(variables["params"], variables["batch_stats"],
                                        tx.init(variables["params"]), jnp.asarray(left),
                                        jnp.asarray(right), jax.random.PRNGKey(1))
    model = CARHyNet(drop_rate=0.0)
    load_variables(model, variables)
    ttx = ttrain.Adam(1e-3)
    step = ttrain.make_descriptor_train_step(model, ttx)
    state, tl, tdp, tdn = step(ttx.init(dict(model.named_parameters())), left, right)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose([float(tdp), float(tdn)], [float(jdp), float(jdn)], rtol=1e-5)
    assert state["count"] == 1
    got = module_variables(model)
    want = {"params": jax.device_get(params), "batch_stats": jax.device_get(bs)}
    moved, off, total = [], 0, 0

    def cmp(g, w, before, path):
        nonlocal off, total
        if isinstance(w, dict):
            for k in w:
                cmp(g[k], w[k], before[k], path + [k])
            return
        w, before = np.asarray(w), np.asarray(before)
        d = np.abs(g - w)
        if path[0] == "batch_stats":
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg="/".join(path))
        else:
            assert d.max() <= 2.1e-3, "/".join(path)
            off += int((d > 2e-5).sum())
            total += d.size
        moved.append(not np.array_equal(w, before))

    before = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    cmp(got, want, before, [])
    assert off <= 0.005 * total
    assert sum(moved) > 0.9 * len(moved)   # the step moved nearly every leaf


def test_dropout_rate_and_generator():
    torch.manual_seed(0)
    model = CARHyNet(drop_rate=0.2)
    seen = []
    model.l7_conv.register_forward_hook(lambda m, i, o: seen.append(i[0].detach()))
    x = torch.rand(16, 3, 32, 32)
    model.drop_rate = 0.0
    model(x, train=True)
    model.drop_rate = 0.2
    gen = torch.Generator().manual_seed(7)
    model(x, train=True, generator=gen)
    gen.manual_seed(7)
    model(x, train=True, generator=gen)
    full, dropped, again = seen
    assert torch.equal(dropped, again)
    kept = dropped != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(dropped[kept], full[kept] / 0.8)
    # inference: no dropout and the running statistics
    assert not isinstance(model(x), tuple)


def test_synthetic_patch_pairs_match_jax():
    jl, jr = jtrain.SyntheticPatchPairs(seed=2).batch(12)
    tl, tr = ttrain.SyntheticPatchPairs(seed=2).batch(12)
    for a, b in ((tl, jl), (tr, jr)):
        assert a.shape == b.shape == (12, 32, 32, 3) and a.dtype == np.float32
        d = np.abs(a - b)
        assert d.max() <= 1.5 / 255 and d.mean() < 1e-3


def test_read_ubc_montages_matches_jax(tmp_path):
    import cv2

    rng = np.random.RandomState(0)
    for k in range(2):
        cv2.imwrite(str(tmp_path / f"patches{k:04d}.bmp"),
                    rng.randint(0, 255, (128, 192)).astype(np.uint8))
    (tmp_path / "info.txt").write_text("".join(f"{i // 3} 0\n" for i in range(12)))
    for color in (True, False):
        jp, jids = jtrain.read_ubc_montages(str(tmp_path), color=color)
        tp, tids = ttrain.read_ubc_montages(str(tmp_path), color=color)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tp, jp)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    a = ttrain.augment_patches(*ttrain.sample_pairs(tp, tids, 4, r1)[:1], r1)
    b = jtrain.augment_patches(*jtrain.sample_pairs(jp, jids, 4, r2)[:1], r2)
    np.testing.assert_array_equal(a, b)
