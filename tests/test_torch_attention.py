"""Masked attention: the PyTorch port's plain versions against the JAX
package, on the CPU.

The port's ``masked_attention_direct`` and ``masked_attention_flash`` (the
plain versions of the CUDA attention kernel) are held against JAX
``masked_attention_direct`` and against the Pallas kernel in interpret mode
(block_k=64, the CUDA kernel's key tile), with masked keys and N, M that
are not multiples of the block. f32 within 2e-5, the bar the JAX package
holds its own kernel to.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gims_tpu.matcher.attention import masked_attention_direct as jdirect
from gims_tpu.matcher.pallas_attention import masked_attention_pallas
from gims_tpu_torch.matcher import attention, cuda_attention
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)


def inputs(seed, b=2, n=100, m=260, h=4, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, h, d).astype(np.float32)
    k = rng.randn(b, m, h, d).astype(np.float32)
    v = rng.randn(b, m, h, d).astype(np.float32)
    mask = rng.rand(b, m) < 0.7
    mask[1, -70:] = False  # a fully masked key tail
    return q, k, v, mask


def torch_args(q, k, v, mask):
    return tuple(torch.from_numpy(x) for x in (q, k, v, mask))


@pytest.mark.parametrize("impl", ["direct", "flash"])
@pytest.mark.parametrize("reference", ["direct", "pallas_interpret"])
def test_plain_versions_match_jax(impl, reference):
    q, k, v, mask = inputs(0)
    if reference == "direct":
        want = np.asarray(jdirect(*(jnp.asarray(x) for x in (q, k, v, mask))))
    else:
        want = np.asarray(masked_attention_pallas(
            *(jnp.asarray(x) for x in (q, k, v, mask)), block_q=64,
            block_k=64, interpret=True))
    if impl == "direct":
        got = attention.masked_attention_direct(*torch_args(q, k, v, mask))
    else:
        got = attention.masked_attention_flash(*torch_args(q, k, v, mask),
                                               block_size=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_dispatch_on_cpu():
    """On the CPU "auto" and "pallas" give the plain versions (the kernel's
    wrapper takes its plain version for CPU tensors and launches nothing);
    "ring" without a group set raises ValueError, as JAX's without a mesh."""
    q, k, v, mask = torch_args(*inputs(1, n=70, m=130))
    want = attention.masked_attention_direct(q, k, v, mask)
    before = cuda_attention.launches
    for impl in ("auto", "pallas", "direct", "flash"):
        got = attention.masked_attention(q, k, v, mask, impl=impl)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    assert cuda_attention.launches == before
    with pytest.raises(ValueError, match="set_ring_group"):
        attention.masked_attention(q, k, v, mask, impl="ring")


def test_bf16_plain_versions_close_to_f32():
    """bf16 inputs, f32 accumulation in flash: within the 5e-2 bf16 bar."""
    q, k, v, mask = torch_args(*inputs(2))
    want = attention.masked_attention_direct(q, k, v, mask)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = attention.masked_attention_flash(qb, kb, vb, mask, block_size=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=5e-2, atol=5e-2)


def kernel_inputs(seed, b=2, n=256, m=200, h=4, d=64):
    """The CUDA kernel's head width, a ragged last key tile (200 = 128 + 72)
    and item 1 with its first 40 keys masked."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, x, h, d).astype(np.float32) for x in (n, m, m))
    mask = np.ones((b, m), bool)
    mask[1, :40] = False
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matches_pallas_interpret(dtype):
    """masked_attention_tiled against the Pallas kernel in interpret mode at
    the CUDA kernel's key tile (block_k=128).

    f32: summation order only, 2e-5. bf16: both round P to bf16 before
    P V, from f32 scores summed in another order, so a p that lies near a
    rounding midpoint may round one bf16 ulp (<= 2**-7 p) apart; over a row
    that is at most 2**-7 * (P |V|) / l. Per element the limit is that term
    plus the output's one rounding (2**-8 |ref|, the tiled version's
    unrounded f32 result) plus 1e-4 for f32 summation order."""
    q, k, v, mask = kernel_inputs(3)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = masked_attention_pallas(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(mask),
        block_k=attention.KERNEL_BLOCK_K, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    qt, kt, vt, mt = (x.to(tdt) if x.is_floating_point() else x
                      for x in torch_args(q, k, v, mask))
    got = attention.masked_attention_tiled(qt, kt, vt, mt, out_dtype=torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        p_abs_v = attention.masked_attention_tiled(qt, kt, vt.abs(), mt,
                                                   out_dtype=torch.float32).numpy()
        limit = 1e-4 + 2.0 ** -8 * np.abs(got) + 2.0 ** -7 * p_abs_v
        assert np.all(np.abs(got - want) <= limit)
        # and the two agree far inside that limit almost everywhere
        assert np.mean(np.abs(got - want) <= 1e-4 + 2.0 ** -8 * np.abs(got)) > 0.999


@pytest.mark.parametrize("d,block_k", [(64, 64), (128, 32)])
def test_split_f32_matches_pallas_interpret(d, block_k):
    """The arithmetic of the CUDA kernel's f32 path on the tensor cores
    (each operand of Q K^T and P V split into two TF32 values, three
    products summed in f32: masked_attention_tiled(split_f32=True)) at its
    key tile (64 keys at D = 64, 32 above) against the Pallas kernel in
    interpret mode in f32: within 2e-5, as the plain f32 product is. One
    TF32 product (hi*hi alone) is far outside that bar, which is why the
    kernel computes three."""
    q, k, v, mask = kernel_inputs(5, d=d)
    want = np.asarray(masked_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), block_k=block_k,
        interpret=True))
    args = torch_args(q, k, v, mask)
    got = attention.masked_attention_tiled(*args, block_k=block_k, split_f32=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    hi = [attention.split_tf32(x)[0] if x.is_floating_point() else x for x in args]
    one_pass = attention.masked_attention_tiled(*hi, block_k=block_k).numpy()
    assert np.abs(one_pass - want).max() > 10 * 2e-5


def test_tiled_equals_direct_f32():
    """In f32 the tiled version is the direct one up to summation order,
    with a fully masked item (the mean of its V) and a ragged key tile."""
    q, k, v, mask = kernel_inputs(4, n=70, m=300)
    mask[0] = False
    args = torch_args(q, k, v, mask)
    want = attention.masked_attention_direct(*args)
    got = attention.masked_attention_tiled(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(v[0].mean(0), got[0].shape),
                               rtol=2e-5, atol=2e-5)
