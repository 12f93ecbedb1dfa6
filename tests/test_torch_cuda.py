"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode, so
they carry the ``cuda`` marker and skip on a machine without a card. On the
card (which has no JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: attention against the direct version in f32 on the same inputs,
element by element, |out - ref| <= atol + rtol * |ref|: f32 atol 1e-4; bf16
atol 1e-4 and rtol 2**-8, the reference rounded to bf16 (the outputs
average v over many keys and are small, so a flat bf16 limit would pass a
wrong kernel). Sinkhorn Z 2e-4 on the valid block (f32 sums in another
order over 100 iterations).
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
    want = attention.masked_attention_direct(q.float(), k.float(), v.float(), mask)
    assert ((out.float() - want).abs() <= 1e-4 + rtol * want.abs()).all()


def test_attention_kernel_reads_strided_layout(cuda):
    """A non-contiguous (B, N, H, D) view (the reference's head interleave)
    gives the same result as its contiguous copy."""
    x = torch.randn((2, 300, 64, 4), device=cuda)  # (B, N, D, H)
    q = k = v = x.transpose(2, 3)                  # (B, N, H, D), stride(D) = 4
    mask = torch.ones((2, 300), dtype=torch.bool, device=cuda)
    got = cuda_attention.masked_attention_cuda(q, k, v, mask)
    want = cuda_attention.masked_attention_cuda(*(t.contiguous() for t in (q, k, v)), mask)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_sinkhorn_kernel_vs_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, nb = 3, 300
    scores = 3 * torch.randn((b, nb, nb), generator=g, device=cuda)
    ms, ns = torch.tensor([250, 300, 57], device=cuda), torch.tensor([240, 300, 61], device=cuda)
    ar = torch.arange(nb, device=cuda)
    row_mask, col_mask = ar[None] < ms[:, None], ar[None] < ns[:, None]
    before = cuda_sinkhorn.launches
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, 0.8, 100, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, 0.8, 100, row_mask, col_mask)
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
