"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so
they carry the ``cuda`` marker and skip on a machine without a card. On the
card (which has no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, element by element, |out - ref| <= atol + rtol * |ref|:
attention in f32 against the direct version, atol 1e-4; in bf16 against
masked_attention_tiled's unrounded f32 result (which rounds P to bf16 per
key tile, as the kernel and the TPU kernel do), atol 1e-4 and rtol 2**-8,
the output's one rounding (the outputs average v over many keys and are
small, so a flat bf16 limit would pass a wrong kernel). bf16 against the
direct version (P kept in f32): RMS error <= 2**-8 of the output's RMS (the
output's rounding alone gives ~2**-8/sqrt(3)). Sinkhorn Z 2e-4 on the valid
block (f32 sums in another order over the iterations), for both of its
kernels: the fused one (rows up to 14340 columns) and the streaming one.
"""

import numpy as np
import pytest
import torch

from gims_tpu_torch.config import MatcherConfig
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("n,m", [(64, 64), (100, 260), (1000, 2017)])
def test_attention_kernel_vs_plain(cuda, dtype, rtol, n, m):
    g = torch.Generator(device=cuda).manual_seed(n + m)
    q, k, v = (torch.randn((2, x, 4, 64), generator=g, device=cuda).to(dtype)
               for x in (n, m, m))
    mask = torch.rand((2, m), generator=g, device=cuda) < 0.7
    mask[1, -(m // 3):] = False  # fully masked key tail
    before = cuda_attention.launches
    out = cuda_attention.masked_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    direct = attention.masked_attention_direct(q.float(), k.float(), v.float(), mask)
    want = direct if dtype == torch.float32 else attention.masked_attention_tiled(
        q, k, v, mask, out_dtype=torch.float32)
    assert ((out.float() - want).abs() <= 1e-4 + rtol * want.abs()).all()
    if dtype == torch.bfloat16:
        err = out.float() - direct
        assert err.pow(2).mean().sqrt() <= 2.0 ** -8 * direct.pow(2).mean().sqrt()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_strided_layout(cuda, dtype):
    """The wrapper refuses a D stride other than 1 (it never copies), and
    reads a unit-D-stride view with a wider N stride (q, k, v as slices of
    a (B, N, H, 2D) tensor) as it reads its contiguous copy."""
    mask = torch.ones((2, 300), dtype=torch.bool, device=cuda)
    x = torch.randn((2, 300, 64, 4), device=cuda).to(dtype)  # (B, N, D, H)
    q = x.transpose(2, 3)                                   # (B, N, H, D), stride(D) = 4
    with pytest.raises(ValueError, match="unit D stride"):
        cuda_attention.masked_attention_cuda(q, q.contiguous(), q.contiguous(), mask)
    wide = torch.randn((3, 2, 300, 4, 128), device=cuda).to(dtype)
    q, k, v = wide[0, ..., 64:], wide[1, ..., :64], wide[2, ..., 64:]
    before = cuda_attention.launches
    got = cuda_attention.masked_attention_cuda(q, k, v, mask)
    want = cuda_attention.masked_attention_cuda(*(t.contiguous() for t in (q, k, v)), mask)
    assert cuda_attention.launches == before + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_fully_masked_item(cuda, dtype):
    """An item whose keys are all masked gives the mean of its V (the direct
    version's answer), finite, in both kernels."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, x, 4, 64), generator=g, device=cuda).to(dtype)
               for x in (300, 333, 333))
    mask = torch.ones((2, 333), dtype=torch.bool, device=cuda)
    mask[1] = False
    out = cuda_attention.masked_attention_cuda(q, k, v, mask).float()
    mean_v = v[1].float().mean(dim=0)
    assert torch.isfinite(out).all()
    assert ((out[1] - mean_v).abs() <= 1e-4 + 2.0 ** -8 * mean_v.abs()).all()


@pytest.mark.parametrize("nb,ms,ns,iters", [
    (300, [250, 300, 57], [240, 300, 61], 100),
    (2048, [1800, 2000], [1750, 2048], 100),  # B = 2, a masked band and column
    (16384, [15000], [14000], 10),            # Z (1, 16385, 16385), 1.07 GB
    # wider than the fused kernel's 14340 columns: the streaming kernel,
    # Z (1, 24577, 24577), 2.4 GB
    (24576, [22000], [21000], 3),
    # more batch items than the card has blocks: the streaming kernel
    (64, [60] * 140, [50] * 140, 50),
])
def test_sinkhorn_kernel_vs_plain(cuda, nb, ms, ns, iters):
    g = torch.Generator(device=cuda).manual_seed(0)
    b = len(ms)
    scores = 3 * torch.randn((b, nb, nb), generator=g, device=cuda)
    ms, ns = torch.tensor(ms, device=cuda), torch.tensor(ns, device=cuda)
    ar = torch.arange(nb, device=cuda)
    row_mask, col_mask = ar[None] < ms[:, None], ar[None] < ns[:, None]
    if b == 2:
        row_mask[1, 100:400] = False  # a band of masked rows inside the valid range
        col_mask[1, 7] = False        # a fully masked column
    before = cuda_sinkhorn.launches
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, 0.8, iters, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, 0.8, iters, row_mask, col_mask)
    torch.cuda.synchronize()
    assert cuda_sinkhorn.launches == before + 1
    for i in range(b):
        r = torch.cat([torch.nonzero(row_mask[i])[:, 0], torch.tensor([nb], device=cuda)])
        c = torch.cat([torch.nonzero(col_mask[i])[:, 0], torch.tensor([nb], device=cuda)])
        assert (got[i][r][:, c] - want[i][r][:, c]).abs().max().item() <= 2e-4


def test_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.randn((1, 8, 4, 32), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        cuda_attention.masked_attention_cuda(q, q, q, mask)  # head dim 32
    z = torch.randn((1, 9, 9), device=cuda)
    with pytest.raises(TypeError):
        cuda_sinkhorn.sinkhorn_uv_cuda(z.double(), z[:, :, 0].double(), z[:, 0].double(), 3)
    with pytest.raises(ValueError):
        cuda_sinkhorn.sinkhorn_uv_cuda(z.transpose(1, 2), z[:, :, 0].contiguous(),
                                       z[:, 0].contiguous(), 3)


def test_gmatcher_kernels_vs_plain(cuda):
    """A 4-layer GMatcher, random weights, 256 bucket: the kernels' trunk
    and Sinkhorn against the plain versions, f32."""
    rng = np.random.RandomState(0)
    nb = 256
    kpts = torch.from_numpy(rng.rand(1, nb, 2).astype(np.float32) - 0.5).to(cuda)
    desc = torch.from_numpy(rng.rand(1, nb, 256).astype(np.float32)).to(cuda)
    adj = torch.from_numpy(rng.rand(1, nb, nb) < 0.02).to(cuda)
    adj = adj | adj.transpose(1, 2)
    kept = torch.arange(nb, device=cuda)[None] < 200
    outs = []
    for impl, pallas in (("auto", True), ("flash", False)):
        torch.manual_seed(0)
        model = GMatcher(MatcherConfig(num_gnn_layers=4, attention_impl=impl,
                                       use_pallas_sinkhorn=pallas)).to(cuda).eval()
        with torch.no_grad():
            outs.append(model(kpts, desc, adj, kept, kpts, desc, adj, kept)["Z"])
    valid = outs[1] > -1e8
    assert (outs[0][valid] - outs[1][valid]).abs().max().item() <= 1e-3
