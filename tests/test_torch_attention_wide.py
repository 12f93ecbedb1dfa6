"""K1 past 256 columns: the plain versions of the port's wide-head kernels
against the JAX package, on the CPU.

The wide-head kernels (``csrc/attention.cu``: ``attn_wide_tc_kernel`` in
bf16, ``attn_wide_f32_kernel`` in f32) split a head's columns over warps,
exchange the partial scores and run the online softmax over key tiles of
``attention.kernel_block_k(d, dtype)`` keys. Their arithmetic on the CPU is
``masked_attention_tiled`` at that tile, with ``split_f32=True`` in f32
(each operand two TF32 values, three products). At D = 320 and 512 it is
held to JAX's ``masked_attention`` in f32 within 1e-5, and in bf16 to
JAX's Pallas kernel in interpret mode at the same key tile under the
rounding rule of ``tests/test_torch_attention.py``. The JAX side is jitted
and small: N = 256 query rows (a p that rounds apart between the two moves
most of its row's D outputs, so the share of elements within the tight
rule is a share of rows, and needs rows by the thousand to be one) and
M = 192 keys (a multiple of both key tiles, so the Pallas kernel pads no
keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gims_tpu.matcher.attention import masked_attention as jmasked_attention
from gims_tpu.matcher.pallas_attention import masked_attention_pallas
from gims_tpu_torch.matcher import attention
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

_jax_attention = jax.jit(jmasked_attention)


def wide_inputs(seed, d, b=2, n=256, m=192, h=2):
    """Item 1 with its first 50 keys and a scattered fifth of the rest masked."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, x, h, d).astype(np.float32) for x in (n, m, m))
    mask = np.ones((b, m), bool)
    mask[1, :50] = False
    mask[1, rng.rand(m) < 0.2] = False
    return q, k, v, mask


@pytest.mark.parametrize("d", [320, 512])
def test_wide_split_f32_matches_jax(d):
    """f32: the wide kernel's arithmetic (32-key tiles, split f32) against
    JAX's masked_attention within 1e-5; a single TF32 product is far
    outside that bar."""
    q, k, v, mask = wide_inputs(d, d)
    want = np.asarray(_jax_attention(*(jnp.asarray(x) for x in (q, k, v, mask))))
    args = tuple(torch.from_numpy(x) for x in (q, k, v, mask))
    block_k = attention.kernel_block_k(d, torch.float32)
    assert block_k == attention.KERNEL_WIDE_F32_BLOCK_K
    got = attention.masked_attention_tiled(*args, block_k=block_k, split_f32=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    hi = [attention.split_tf32(x)[0] if x.is_floating_point() else x for x in args]
    one_pass = attention.masked_attention_tiled(*hi, block_k=block_k).numpy()
    assert np.abs(one_pass - want).max() > 10 * 1e-5


@pytest.mark.parametrize("d", [320, 512])
def test_wide_bf16_tiled_matches_pallas_interpret(d):
    """bf16: masked_attention_tiled at the wide kernel's key tile (48 keys
    at 320 columns, 32 at 512) against the Pallas kernel in interpret mode
    at the same tile. Both round P to bf16 against the running max of each
    tile, from f32 scores summed in another order: per element the output's
    rounding (2**-8 |ref|) plus one bf16 ulp of every rounded p (2**-7 P|V|
    / l) plus 1e-4, and 99.9% of the elements within the first and last."""
    q, k, v, mask = wide_inputs(d + 1, d)
    block_k = attention.kernel_block_k(d, torch.bfloat16)
    want = masked_attention_pallas(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), jnp.asarray(mask),
        block_k=block_k, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    mt = torch.from_numpy(mask)
    got = attention.masked_attention_tiled(qt, kt, vt, mt, out_dtype=torch.float32).numpy()
    p_abs_v = attention.masked_attention_tiled(qt, kt, vt.abs(), mt,
                                               out_dtype=torch.float32).numpy()
    limit = 1e-4 + 2.0 ** -8 * np.abs(got) + 2.0 ** -7 * p_abs_v
    assert np.all(np.abs(got - want) <= limit)
    assert np.mean(np.abs(got - want) <= 1e-4 + 2.0 ** -8 * np.abs(got)) > 0.999


@pytest.mark.parametrize("d,bf16,f32", [(257, 48, 32), (320, 48, 32), (321, 32, 32),
                                        (512, 32, 32), (520, 48, 32), (640, 48, 32),
                                        (641, 32, 32), (1024, 32, 32), (5128, 32, 32),
                                        (8192, 32, 32), (8200, 32, 32), (12288, 32, 32),
                                        (16384, 32, 32)])
def test_wide_key_tile_follows_the_kernels_chunks(d, bf16, f32):
    """The key tile of the plain version past 256 columns is the wide
    kernels': in bf16 a head's ceil(d / 64) column blocks go to
    ceil(blocks / 8) CTAs as evenly as they go, and a CTA of five blocks
    takes tiles of 48 keys, one of six to eight 32 (shared memory); f32
    takes 32 keys at every width. Past a cluster of 16 CTAs (8192 columns
    in bf16, 5120 in f32) a head spans rep clusters of nz CTAs, whose
    chunks of `per` blocks of 64 (bf16) or tiles of 8 (f32) cover it, at
    most 8 or 40 a CTA: every width runs."""
    assert attention.kernel_block_k(d, torch.bfloat16) == bf16
    assert attention.kernel_block_k(d, torch.float32) == f32
    for dtype, unit, cap, widest in ((torch.bfloat16, 64, 8, 8192), (torch.float32, 8, 40, 5120)):
        nz, rep, per = attention.wide_plan(d, dtype)
        assert nz <= 16 and per <= cap and nz * rep * per * unit >= d
        assert (rep > 1) == (d > widest)


@pytest.mark.parametrize("d,dtype", [(8200, torch.bfloat16), (5128, torch.float32)])
def test_wide_tiled_past_one_cluster_matches_jax(d, dtype):
    """One width past a cluster of 16 CTAs in each dtype (the kernel's
    multi-cluster plan): the plain tiled version at the kernel's key tile
    against JAX's jitted masked_attention on the same (bf16-rounded) inputs
    in f32. f32 (split f32) within 1e-5; bf16 (P rounded per key tile) by
    RMS within 2**-8 of the reference's, as the card tests hold the kernel
    to the direct version."""
    q, k, v, mask = wide_inputs(d, d, n=64, m=96, h=1)
    if dtype == torch.bfloat16:
        q, k, v = (torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v))
    want = np.asarray(_jax_attention(*(jnp.asarray(x) for x in (q, k, v, mask))))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    mt = torch.from_numpy(mask)
    if dtype == torch.float32:
        got = attention.masked_attention_tiled(*args, mt, split_f32=True).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        got = attention.masked_attention_tiled(*(x.to(dtype) for x in args), mt,
                                               out_dtype=torch.float32).numpy()
        assert np.sqrt(np.mean((got - want) ** 2)) <= 2.0 ** -8 * np.sqrt(np.mean(want ** 2))
