"""CAR-HyNet: the PyTorch port against the flax model on the CPU.

The flax variables (the joint end-to-end gray weights, or a fresh flax
init) are carried into the port's modules by ``carhynet.convert``; the same
numpy inputs go through both models in f32. Tolerance: 1e-4 absolute on the
L2-normalized descriptors (dense maps and patch descriptors).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu.carhynet import model as jmodel
from gims_tpu_torch.carhynet import convert, model as tmodel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_CAR = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e_car.npz")
TOL = 1e-4


def flax_init(in_channels, seed=0):
    variables = jmodel.CARHyNet(in_channels=in_channels).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, in_channels), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, variables)


def both(variables, x_nhwc, dense, in_channels):
    want = np.asarray(jmodel.CARHyNet(dense=dense, in_channels=in_channels).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x_nhwc), train=False))
    model = tmodel.CARHyNet(dense=dense, in_channels=in_channels).eval()
    convert.load_variables(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).numpy()
    return got, want


def test_dense_gray_e2e_weights_match_flax():
    """The checkpoint the fused path loads, over gray pyramid-like levels
    of odd size (the stride-2 layers and the asymmetric 8x8 head pad)."""
    variables = convert.load_car_checkpoint(E2E_CAR)
    x = np.random.RandomState(0).rand(3, 45, 58, 1).astype(np.float32)
    got, want = both(variables, x, dense=True, in_channels=1)
    assert got.shape == want.shape == (3, 12, 15, 128)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("dense,in_channels,shape", [
    (True, 3, (2, 40, 36)), (False, 3, (5, 32, 32)), (False, 1, (5, 32, 32))])
def test_flax_init_matches(dense, in_channels, shape):
    """A fresh flax init in both modes and both input widths: every leaf
    maps onto a port parameter or buffer (strict load)."""
    variables = flax_init(in_channels, seed=in_channels)
    b, h, w = shape
    x = np.random.RandomState(1).rand(b, h, w, in_channels).astype(np.float32)
    got, want = both(variables, x, dense=dense, in_channels=in_channels)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dense_statistics_are_per_sample():
    """FRN and CoordAtt normalize each image over its whole map, so an
    image's descriptors do not depend on the rest of the batch."""
    model = tmodel.CARHyNet(dense=True, in_channels=1).eval()
    convert.load_variables(model, convert.load_car_checkpoint(E2E_CAR))
    x = torch.from_numpy(np.random.RandomState(2).rand(3, 1, 33, 47).astype(np.float32))
    with torch.no_grad():
        together = model(x)
        alone = torch.cat([model(x[i:i + 1]) for i in range(3)])
    torch.testing.assert_close(together, alone, atol=1e-6, rtol=0)


def test_state_dict_mapping():
    """Depthwise HWIO kernels become (C, 1, 3, 3); BN scale/mean/var become
    weight/running_mean/running_var; an unknown collection raises."""
    variables = convert.load_car_checkpoint(E2E_CAR)
    sd = convert.variables_to_state_dict(variables)
    dw = variables["params"]["l2_sg"]["dw1"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["l2_sg.dw1.conv.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    assert tuple(sd["l2_sg.dw1.conv.weight"].shape) == (32, 1, 3, 3)
    assert tuple(sd["l7_conv.weight"].shape) == (128, 128, 8, 8)
    np.testing.assert_array_equal(sd["l7_bn.running_var"].numpy(),
                                  variables["batch_stats"]["l7_bn"]["var"])
    np.testing.assert_array_equal(sd["l1_coord.bn1.weight"].numpy(),
                                  variables["params"]["l1_coord"]["bn1"]["scale"])
    with pytest.raises(ValueError, match="collections"):
        convert.variables_to_state_dict({**variables, "dropout": {}})
