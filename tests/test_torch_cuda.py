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
The attention kernel's partial mode: its output bit-equal to the default
mode's, its row statistics 1e-4 from the plain version's.
The patch warp on the card against the same warp on the CPU: 1e-3 on the
0..255 scale with TF32 off (the same f32 arithmetic; a sample coordinate may
round differently by an ulp). JPEG decoding on the card: bit-equal to the
CPU's on the six photos of assets/photos. One HTTP round trip through
``serve_cli.make_server`` on the card, held to ``find_matches`` in-process.
The segmented-sum kernel (``csrc/segsum.cu``): equal to the CPU's
sequential ``index_add_`` to the bit on two runs, flat (one row) and by
rows at its three callers' layouts (SIFT's keypoint rows into 361 int16
slots, AGC's image-and-coordinate rows, the loss's four rows over one slot
list), one kernel and no sort per call, and its callers (SIFT
descriptors, AGC's centroid sums, a loss and its gradient) equal on two
runs. The f32 attention kernel (split f32 on the tensor cores) against the
direct version at D = 32, 64, 100, 128 and 256, 1e-4, with a key count off
its tiles, a fully masked item, its partial mode and rows that are not
16-byte aligned. K1 past 256 columns (the wide-head kernels: bf16 on wgmma,
f32 as split TF32, a head's columns split over warps and, past 512 bf16 or
320 f32 columns, over the CTAs of a cluster, and past 8192 bf16 or 5120
f32 columns over several clusters): "auto" and "pallas" launch them,
within the same bars as the narrower heads, at every width (to 16384 here;
the plain version's key tile equal to the launcher's at every width); their
partial mode against attention_partials_tiled; two calls give the same bits
(the partial scores are summed in one fixed order), and unaligned f32 rows
the same bits as aligned ones; a 640-d GMatcher of 2 heads through them.
"""

import os

import numpy as np
import pytest
import torch

from gims_tpu_torch import _build
from gims_tpu_torch.carhynet.convert import load_car_checkpoint, load_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import FrontendConfig, MatcherConfig
from gims_tpu_torch.frontend import patches
from gims_tpu_torch.frontend.detect_device import gray_pyramid
from gims_tpu_torch.frontend.feature import FeatureFrontend
from gims_tpu_torch.frontend.sift import KeypointArrays
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair, synthetic_request

CAR_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "weights", "gims_tpu_dense_gray_e2e_car.npz")

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
@pytest.mark.parametrize("d", [64, 36, 320])
def test_attention_partial_mode_vs_plain(cuda, dtype, d):
    """The kernel's partial mode (ring attention's step): the output
    bit-equal to the default mode's, each row's base-2 max within 1e-4 and
    sum within 1e-4 relative of attention_partials_tiled's (scores summed in
    another order)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, x, 4, d), generator=g, device=cuda).to(dtype)
               for x in (100, 260, 260))
    mask = torch.rand((2, 260), generator=g, device=cuda) < 0.7
    out, stats = cuda_attention.attention_partials_cuda(q, k, v, mask)
    assert torch.equal(out, cuda_attention.masked_attention_cuda(q, k, v, mask))
    _, want = attention.attention_partials_tiled(q, k, v, mask)
    assert stats.shape == (2, 100, 4, 2) and stats.dtype == torch.float32
    assert (stats[..., 0] - want[..., 0]).abs().max().item() <= 1e-4
    assert ((stats[..., 1] - want[..., 1]).abs() / want[..., 1]).max().item() <= 1e-4


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
    # the fused image path: 8 pairs, compacted to 3072, 20 iterations
    (3072, [2900, 3072, 2500, 3000, 2800, 3072, 2700, 2950],
     [2950, 3000, 2600, 3072, 2750, 3050, 2800, 2900], 20),
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
    q = torch.randn((1, 8, 4, 300), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        cuda_attention.masked_attention_cuda(q.double(), q.double(), q.double(), mask)
    for dtype in (torch.float32, torch.bfloat16):  # every width from 1, none below
        empty = torch.zeros((1, 8, 1, 0), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            cuda_attention.masked_attention_cuda(empty, empty, empty, mask)
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


@pytest.mark.parametrize("d", [1, 8, 20, 24, 32, 40, 64, 96, 128, 160, 192, 250, 256,
                               257, 300, 320, 384, 513, 640, 1024, 2304, 5120, 5184, 8192,
                               8256, 16384])
def test_attention_auto_by_head_width(cuda, d):
    """On the card "auto" launches the kernel at every head width: up to 256
    one to four column blocks of 64 (a width short of its last block reads
    zeros past its end, and in bf16 a width that is not a multiple of 8, as
    1, 20, 250, 257 and 513, is zero-padded to one by the wrapper), wider
    heads the wide-head kernels, in f32 and bf16 (384: six blocks of 64 in
    one CTA; 513 and up split a head over the CTAs of a cluster in both
    dtypes: 2304 over 5 (bf16) and 8, 5120 over 10 and 16, the widest f32
    head a cluster holds, and 8192 over 16, the widest bf16 one; wider heads
    span several clusters: 5184 and 8192 in f32 over 2 clusters, 8256 over
    2 in both dtypes, 16384 over 2 in bf16 and 4 in f32; each width past
    one cluster gives the same bits on a second call). f32 against the direct
    version, 1e-4. bf16 against the tiled version: every element within the
    output's rounding rule plus one bf16 ulp of every rounded P (2**-7 times
    the attention of |v|: where a p lies at a rounding boundary the kernel
    and the tiled version, whose f32 p differ in the last bits, round it
    apart), and at least 99.9% of the elements within the rounding rule
    alone, as tests/test_torch_attention.py holds the tiled version to the
    TPU kernel; by RMS against the direct version as above."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, x, 4, d), generator=g, device=cuda) for x in (300, 517, 517))
    mask = torch.rand((2, 517), generator=g, device=cuda) < 0.8
    direct = attention.masked_attention_direct(q, k, v, mask)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        before = cuda_attention.launches
        out = attention.masked_attention(qd, kd, vd, mask, impl="auto")
        torch.cuda.synchronize()
        assert cuda_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        plan = cuda_attention.kernel_wide_plan(d, dtype)
        if plan is not None and plan[1] > 1:
            assert torch.equal(out, attention.masked_attention(qd, kd, vd, mask, impl="auto"))
        if dtype == torch.float32:
            assert (out - direct).abs().max().item() <= 1e-4
        else:
            want = attention.masked_attention_tiled(qd, kd, vd, mask, out_dtype=torch.float32)
            p_abs_v = attention.masked_attention_tiled(qd, kd, vd.abs(), mask,
                                                       out_dtype=torch.float32)
            diff = (out.float() - want).abs()
            tight = 1e-4 + 2.0 ** -8 * want.abs()
            assert (diff <= tight + 2.0 ** -7 * p_abs_v).all()
            assert (diff <= tight).float().mean().item() >= 0.999
            bf_direct = attention.masked_attention_direct(qd.float(), kd.float(), vd.float(), mask)
            err = out.float() - bf_direct
            assert err.pow(2).mean().sqrt() <= 2.0 ** -8 * bf_direct.pow(2).mean().sqrt()


def test_plain_key_tile_is_the_kernels(cuda):
    """attention.kernel_block_k copies the launcher's choice, which the
    plain version needs without a card: equal to gims_attention_key_tile
    (csrc/attention.cu) at every bf16 width and at every f32 width past 256
    (below, P stays f32 and the tile only orders the rescaling), up to
    heads of four clusters of 16 CTAs in both dtypes; no kernel takes a
    head of no columns. attention.wide_plan (nz, rep, per) equals the
    library's wide_plan past 256 columns, which it leaves to the
    column-block kernels at and below."""
    lib = _build.load()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        first = 1 if dtype == torch.bfloat16 else attention.KERNEL_MAX_HEAD_DIM + 1
        widths = range(first, 4 * 16 * 640 + 1)
        got = [lib.gims_attention_key_tile(code, d) for d in widths]
        want = [attention.kernel_block_k(d, dtype) for d in widths]
        assert got == want, [(d, a, b) for d, a, b in zip(widths, got, want) if a != b][:5]
        assert lib.gims_attention_key_tile(code, 0) == 0
        wide = range(attention.KERNEL_MAX_HEAD_DIM + 1, 4 * 16 * 640 + 1)
        got = [cuda_attention.kernel_wide_plan(d, dtype)[:3] for d in wide]
        want = [attention.wide_plan(d, dtype) for d in wide]
        assert got == want, [(d, a, b) for d, a, b in zip(wide, got, want) if a != b][:5]
        assert cuda_attention.kernel_wide_plan(attention.KERNEL_MAX_HEAD_DIM, dtype) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_wide_head_kernel(cuda, dtype):
    """At a head of 320 (past the column-block kernels' 256) "auto" and
    "pallas" both launch the wide-head kernel, once each, with the same
    bits on both calls (``test_attention_auto_by_head_width`` holds its
    values to the plain versions)."""
    g = torch.Generator(device=cuda).manual_seed(320)
    q, k, v = (torch.randn((2, x, 2, 320), generator=g, device=cuda).to(dtype)
               for x in (200, 333, 333))
    mask = torch.rand((2, 333), generator=g, device=cuda) < 0.8
    outs = []
    for impl in ("auto", "pallas"):
        before = cuda_attention.launches
        outs.append(attention.masked_attention(q, k, v, mask, impl=impl))
        torch.cuda.synchronize()
        assert cuda_attention.launches == before + 1
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512, 640, 8256])
def test_attention_wide_partial_mode_vs_plain(cuda, dtype, d):
    """The wide-head kernels' partial mode (640: a cluster of CTAs per head
    in both dtypes; 8256: two clusters per head in both): the output bit-equal to the default mode's, each row's
    base-2 max within 1e-4 and sum within 1e-4 relative of
    attention_partials_tiled's, 333 keys (off every key tile) with masked
    keys and item 1 fully masked (its stats: the max of the masked scores,
    the count of its keys)."""
    g = torch.Generator(device=cuda).manual_seed(d + 7)
    q, k, v = (torch.randn((2, x, 2, d), generator=g, device=cuda).to(dtype)
               for x in (200, 333, 333))
    mask = torch.rand((2, 333), generator=g, device=cuda) < 0.7
    mask[1] = False
    before = cuda_attention.partial_launches
    out, stats = cuda_attention.attention_partials_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert cuda_attention.partial_launches == before + 1
    assert torch.equal(out, cuda_attention.masked_attention_cuda(q, k, v, mask))
    _, want = attention.attention_partials_tiled(q, k, v, mask)
    assert stats.shape == (2, 200, 2, 2) and stats.dtype == torch.float32
    assert (stats[..., 0] - want[..., 0]).abs().max().item() <= 1e-4
    assert ((stats[..., 1] - want[..., 1]).abs() / want[..., 1]).max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 640, 5184, 8256, 16384])
def test_attention_wide_head_same_bits(cuda, dtype, d):
    """Two calls of the wide-head kernels give the same bits, output and
    partial stats (each partial score sum runs in one fixed order, across
    the cluster's CTAs at 640 too, and in every cluster of a head alike
    past one cluster: 5184 in f32, 8256 and 16384 in both); in f32, q, k and v at an offset of one
    float (rows not 16-byte aligned: the kernel's 4-byte copies) give the
    same bits as the aligned call."""
    g = torch.Generator(device=cuda).manual_seed(d + 11)
    q, k, v = (torch.randn((2, x, 2, d), generator=g, device=cuda).to(dtype)
               for x in (300, 517, 517))
    mask = torch.rand((2, 517), generator=g, device=cuda) < 0.8
    runs = [cuda_attention.attention_partials_cuda(q, k, v, mask) for _ in range(2)]
    runs += [(cuda_attention.masked_attention_cuda(q, k, v, mask), None) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[2][0], runs[3][0]) and torch.equal(runs[0][0], runs[2][0])
    if dtype == torch.float32:
        shifted = []
        for t in (q, k, v):
            buf = torch.empty(t.numel() + 1, device=cuda)
            view = buf[1:].view(t.shape)
            view.copy_(t)
            assert view.data_ptr() % 16
            shifted.append(view)
        assert torch.equal(cuda_attention.masked_attention_cuda(*shifted, mask), runs[2][0])


@pytest.mark.parametrize("d", [32, 64, 100, 128, 256])
def test_attention_f32_split_kernel(cuda, d):
    """The f32 kernel at the widths of its three instantiations (64, 128,
    256 padded columns) against the direct version, 1e-4 (chip_smoke's
    ATTN_TOL): 333 keys (off its 64- and 32-key tiles), masked keys, item 1
    fully masked (the mean of its V). Its partial mode: the output
    bit-equal, the row max within 1e-4 and the row sum within 1e-4
    relative of attention_partials_tiled's. q, k and v at an offset of one
    float (rows not 16-byte aligned: the kernel's 4-byte copies) give the
    same bits as the aligned call."""
    g = torch.Generator(device=cuda).manual_seed(d + 1)
    q, k, v = (torch.randn((2, x, 4, d), generator=g, device=cuda) for x in (300, 333, 333))
    mask = torch.rand((2, 333), generator=g, device=cuda) < 0.7
    mask[1] = False
    before = cuda_attention.launches
    out = cuda_attention.masked_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert cuda_attention.launches == before + 1
    direct = attention.masked_attention_direct(q, k, v, mask)
    assert (out - direct).abs().max().item() <= 1e-4
    assert (out[1] - v[1].mean(dim=0)).abs().max().item() <= 1e-4
    part, stats = cuda_attention.attention_partials_cuda(q, k, v, mask)
    assert torch.equal(part, out)
    _, want = attention.attention_partials_tiled(q, k, v, mask)
    assert (stats[..., 0] - want[..., 0]).abs().max().item() <= 1e-4
    assert ((stats[..., 1] - want[..., 1]).abs() / want[..., 1]).max().item() <= 1e-4
    shifted = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        shifted.append(view)
    assert torch.equal(cuda_attention.masked_attention_cuda(*shifted, mask), out)


@pytest.mark.parametrize("layout", ["sift", "agc", "agc_fused", "loss"])
def test_segsum_rows_kernel_vs_cpu(cuda, layout):
    """segment_sum_rows on the card at each caller's row layout (the
    layouts of tests/test_torch_segsum_rows.py at the callers' sizes: 300
    keypoints of 4500 samples; 2 images of 4096 nodes into 4098 slots, by
    lane; the fused paths' 8 images of 3072 nodes into 3073 slots, labels
    spread over all of them, by group with each row's slots split over
    warps; four rows of 12288 entries over one slot list) equal to the CPU's
    sequential sum on two runs; one call, one kernel and no sort."""
    import test_torch_segsum_rows as layouts  # this directory: pytest puts it on sys.path
    from gims_tpu_torch.core import segsum

    rng = np.random.default_rng(17)
    kind, size = {"sift": ("sift", dict(k=300, samples=4500)),
                  "agc": ("agc", dict(b=2, n=4096, c=4097)),
                  "agc_fused": ("agc", dict(b=8, n=3072, c=3072, labels=3000)),
                  "loss": ("loss", dict(rows=12288, batch=3))}[layout]
    vals, slots, num = layouts.LAYOUTS[kind](rng, **size)
    slots = np.ascontiguousarray(slots)
    want = segsum.segment_sum_rows_plain(torch.from_numpy(vals), torch.from_numpy(slots), num)
    v, s = torch.from_numpy(vals).to(cuda), torch.from_numpy(slots).to(cuda)
    if layout == "loss":
        s = s[:1].expand(4, -1)
    before = segsum.launches
    runs = [segsum.segment_sum_rows(v, s, num) for _ in range(2)]
    torch.cuda.synchronize()
    assert segsum.launches == before + 2
    for r in runs:
        assert torch.equal(r.cpu(), want)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        segsum.segment_sum_rows(v, s, num)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "segsum_rows_kernel" in kernels[0], kernels
    assert not [n for n in names if "sort" in n or "searchsorted" in n]


@pytest.mark.parametrize("n,num,dup", [(1, 1, 1), (1000, 37, 5), (300_000, 20_000, 8),
                                       (2_000_000, 50, 1), (400_000, 100_000, 3)])
def test_segsum_kernel_vs_plain(cuda, n, num, dup):
    """csrc/segsum.cu against the CPU's sequential index_add_ (its plain
    version): equal to the bit, on two runs, in the callers' patterns
    (runs of `dup` equal destinations as SIFT's votes give, long segments as
    the loss's pairs give), with slots left empty. The flat form is one
    row: up to 33,792 slots by lane, beyond by group with the row's slots
    split over warps of at most 1280 slots each (100,000 slots)."""
    from gims_tpu_torch.core import segsum

    rng = np.random.default_rng(n)
    idx = np.repeat(rng.integers(0, num, size=(n + dup - 1) // dup), dup)[:n]
    vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, size=n)).astype(np.float32)
    iv, vv = torch.from_numpy(idx), torch.from_numpy(vals)
    want = segsum.segment_sum_plain(vv, iv, num)
    before = segsum.launches
    runs = [segsum.segment_sum(vv.to(cuda), iv.to(cuda), num) for _ in range(2)]
    torch.cuda.synchronize()
    assert segsum.launches == before + 2
    for r in runs:
        assert torch.equal(r.cpu(), want)


def test_segsum_callers_repeat_on_card(cuda):
    """The three callers on the card give the same bits on two runs: SIFT
    descriptors of a synthetic image, AGC's centroid sums, the training
    loss and its gradient through the segment sums."""
    from gims_tpu_torch.agc.graph import _segment_sum
    from gims_tpu_torch.core import segsum
    from gims_tpu_torch.frontend import sift

    img = synthetic_image_pair(3, (240, 320), colour=True)[0]
    card = sift.SIFT(3, 0.001, 80, 1.6, device=cuda)
    kp = sift.filter_top_responses(card.detect_raw(img)[0], 2048)
    before = segsum.launches
    d0, d1 = card.compute(img, kp), card.compute(img, kp)
    assert segsum.launches > before
    assert np.array_equal(d0, d1)
    g = torch.Generator(device=cuda).manual_seed(0)
    data = torch.rand((2, 5000), generator=g, device=cuda) * 800
    seg = torch.randint(0, 64, (2, 5000), generator=g, device=cuda)
    a, b = _segment_sum(data, seg, 65), _segment_sum(data, seg, 65)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), _segment_sum(data.cpu(), seg.cpu(), 65))
    x = torch.rand(40_000, generator=g, device=cuda, requires_grad=True)
    rows = torch.sort(torch.randint(0, 4, (40_000,), generator=g, device=cuda))[0]
    w = torch.rand(40_000, generator=g, device=cuda)
    coef = torch.tensor([1.0, -2.0, 0.5, 3.0], device=cuda)
    runs = []
    for _ in range(2):
        sums = segsum.segment_sum(x * w, rows, 4)
        (grad,) = torch.autograd.grad((sums * coef).sum(), x)
        runs.append((sums.detach(), grad))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][0].cpu(), segsum.segment_sum_plain((x * w).detach().cpu(),
                                                                  rows.cpu(), 4))
    assert torch.equal(runs[0][1], (coef[rows] * w))


def test_kernels_refuse_autograd(cuda):
    """K1 and K2 have no backward: their wrappers raise under autograd
    instead of returning a result without (K1) or with a wrong (K2)
    gradient. "auto" under grad takes the plain versions and launches
    nothing, and its gradient equals the direct version's; "pallas" and
    use_pallas_sinkhorn=True raise. Without grad, "auto" launches K1."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, 100, 4, 64), generator=g, device=cuda, requires_grad=True)
               for _ in range(3))
    mask = torch.rand((1, 100), generator=g, device=cuda) < 0.9
    before = cuda_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_attention.masked_attention_cuda(q, k, v, mask)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.masked_attention(q, k, v, mask, impl="pallas")
    out = attention.masked_attention(q, k, v, mask, impl="auto")
    assert cuda_attention.launches == before
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    want = torch.autograd.grad(attention.masked_attention_direct(q, k, v, mask).square().sum(),
                               (q, k, v))
    for a, b in zip(grads, want):
        assert (a - b).abs().max().item() <= 1e-5
    with torch.no_grad():
        attention.masked_attention(q, k, v, mask, impl="auto")
    assert cuda_attention.launches == before + 1

    scores = torch.randn((1, 50, 60), generator=g, device=cuda, requires_grad=True)
    rows = torch.ones((1, 50), dtype=torch.bool, device=cuda)
    cols = torch.ones((1, 60), dtype=torch.bool, device=cuda)
    before = cuda_sinkhorn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_sinkhorn.log_optimal_transport_cuda(scores, 1.0, 5, rows, cols)
    z = torch.randn((1, 51, 61), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_sinkhorn.sinkhorn_uv_cuda(z, z[:, :, 0].detach().contiguous(),
                                       z[:, 0].detach().contiguous(), 5)
    assert cuda_sinkhorn.launches == before
    model = GMatcher(MatcherConfig(num_gnn_layers=2, use_pallas_sinkhorn=True)).to(cuda)
    kp = torch.rand((1, 64, 2), device=cuda) - 0.5
    de = torch.rand((1, 64, 256), device=cuda)
    adj = torch.zeros((1, 64, 64), dtype=torch.bool, device=cuda)
    kept = torch.ones((1, 64), dtype=torch.bool, device=cuda)
    before = cuda_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        model(kp, de, adj, kept, kp, de, adj, kept)
    assert cuda_attention.launches == before  # the trunk took the plain versions


@pytest.mark.parametrize("dim", [512, 640])
def test_wide_head_gmatcher_kernel_vs_plain(cuda, monkeypatch, dim):
    """A GMatcher of 2 heads, 512-d (head width 256, the column-block
    kernels' widest) and 640-d (head width 320, the wide-head kernels), 4
    GNN layers, random weights, 300 keypoints per side in a 384 bucket: the
    trunk through K1 against the same trunk through the kernel's plain
    version (masked_attention_tiled), Z on the valid block within 5e-2 in
    bf16 (the bf16 bar of tests/test_torch_gmatcher.py) and 1e-3 in f32 (its
    f32 bar)."""
    from gims_tpu_torch.matcher import layers

    rng = np.random.RandomState(1)
    nb = 384
    kpts = torch.from_numpy(rng.rand(1, nb, 2).astype(np.float32) - 0.5).to(cuda)
    desc = torch.from_numpy(rng.rand(1, nb, dim).astype(np.float32)).to(cuda)
    adj = torch.from_numpy(rng.rand(1, nb, nb) < 0.02).to(cuda)
    adj = adj | adj.transpose(1, 2)
    kept = torch.arange(nb, device=cuda)[None] < 300
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        torch.manual_seed(0)
        cfg = MatcherConfig(descriptor_dim=dim, input_dim=dim, num_heads=2, num_gnn_layers=4,
                            attention_dtype=dtype, sinkhorn_iterations=20)
        model = GMatcher(cfg).to(cuda).eval()
        outs = []
        for plain in (False, True):
            if plain:
                monkeypatch.setattr(layers, "masked_attention",
                                    lambda q, k, v, mask, impl: attention.masked_attention_tiled(
                                        q, k, v, mask))
            before = cuda_attention.launches
            with torch.no_grad():
                outs.append(model(kpts, desc, adj, kept, kpts, desc, adj, kept)["Z"])
            assert cuda_attention.launches - before == (0 if plain else 4)
        monkeypatch.undo()
        valid = outs[1] > -1e8
        assert torch.isfinite(outs[0][valid]).all()
        assert (outs[0][valid] - outs[1][valid]).abs().max().item() <= tol


def test_fused_train_step_card_vs_cpu(cuda, monkeypatch):
    """One fused end-to-end train step in f32 (a 2-layer 256-d matcher,
    remat, dense AGC, InfoNCE, a 512-keypoint budget at 120x160) on the card
    against the same step on the CPU, from the same random start, TF32 off:
    the same detections (valid equal, keypoints 1e-3 px) and the same AGC
    graphs (adjacency and kept equal), losses within 1e-4 relative, and
    every gradient at a cosine of at least 0.9999 to the CPU's and within
    2e-2 * max|g_cpu| per tensor (measured: 9.3e-3 at most, on the first
    layer's MLP weight, whose gradient sums the batch norm's cancelling
    terms over every token in another order on each device); a gradient of
    at most 1e-6 (a bias ahead of a batch norm: 0 up to rounding) within
    1e-5. On the card the step launches the label-rounds kernel twice (one
    AGC per side) and neither K1 nor K2."""
    from gims_tpu_torch import fused as tfused
    from gims_tpu_torch.agc import labels
    from gims_tpu_torch.config import (AGCConfig, DatasetConfig, GIMSConfig, OptimizerConfig,
                                       TrainConfig)
    from gims_tpu_torch.fused import octave_budgets
    from gims_tpu_torch.matcher import pipeline
    from gims_tpu_torch.train import data as tdata
    from gims_tpu_torch.train import fused_step, step as tstep
    from gims_tpu_torch.train.loop import build_batch_e2e

    h, w = 120, 160
    cfg = GIMSConfig(
        matcher=MatcherConfig(descriptor_dim=256, input_dim=256, keypoint_encoder=(32, 64),
                              num_gnn_layers=2, sinkhorn_iterations=5, remat=True,
                              neg_cells="dustbin"),
        agc=AGCConfig(radius=40.0, percentile=5.0, min_size=2),
        frontend=FrontendConfig(descriptor_source="dense_gray", dense_dtype="float32"),
        optimizer=OptimizerConfig(), train=TrainConfig(desc_loss_weight=1.0))
    pair = tdata.SyntheticPairDataset(DatasetConfig(image_height=h, image_width=w,
                                                    apply_color_aug=False), 1)[0]
    budgets = octave_budgets(h, w, 512)
    real_extract, real_agc = tfused._extract_side, pipeline.run_agc
    runs = {}
    for dev in ("cpu", cuda):
        seen = {"extract": [], "agc": []}
        monkeypatch.setattr(tfused, "_extract_side", lambda *a: seen["extract"].append(
            real_extract(*a)) or seen["extract"][-1])
        monkeypatch.setattr(pipeline, "run_agc", lambda *a, **k: seen["agc"].append(
            real_agc(*a, **k)) or seen["agc"][-1])
        torch.manual_seed(0)
        joint = fused_step.joint_variables(GMatcher(cfg.matcher, param_dtype=torch.float32),
                                           CARHyNet(dense=True, in_channels=1)).to(dev)
        state, tx = tstep.create_train_state(cfg, joint, num_batches=10)
        step = fused_step.make_fused_e2e_train_step(cfg, tx, (h, w), budgets)
        before = (labels.launches, cuda_attention.launches, cuda_sinkhorn.launches)
        state, metrics = step(state, build_batch_e2e([pair], dev))
        after = (labels.launches, cuda_attention.launches, cuda_sinkhorn.launches)
        runs[str(dev)] = (state, metrics, tuple(a - b for a, b in zip(after, before)), seen)
    (cpu_state, cpu_m, _, cpu_seen), (card_state, card_m, card_launches, card_seen) = (
        runs["cpu"], runs[str(cuda)])
    assert card_launches == (2, 0, 0)
    for (kc, _, vc, _), (kg, _, vg, _) in zip(cpu_seen["extract"], card_seen["extract"]):
        assert torch.equal(vc, vg.cpu()) and vc.sum() > 50
        assert (kc - kg.cpu())[vc].abs().max().item() <= 1e-3
    for (ac, kc, _), (ag, kg, _) in zip(cpu_seen["agc"], card_seen["agc"]):
        assert torch.equal(ac, ag.cpu()) and torch.equal(kc, kg.cpu())
    for key in ("total_loss", "pos_loss", "neg_loss"):
        want = cpu_m[key].item()
        assert abs(card_m[key].item() - want) <= 1e-4 * max(1.0, abs(want)), key
    want = dict(cpu_state.model.named_parameters())
    for name, p in card_state.model.named_parameters():
        g, got = want[name].grad, p.grad.cpu()
        scale = g.abs().max().item()
        if scale <= 1e-6:
            assert (got - g).abs().max().item() <= 1e-5, name
            continue
        assert (got - g).abs().max().item() <= 2e-2 * scale, name
        cos = torch.nn.functional.cosine_similarity(got.flatten(), g.flatten(), dim=0)
        assert cos.item() >= 0.9999, name


def test_dense_cnn_bf16_vs_f32(cuda):
    """The gray CAR-HyNet's dense maps over an 800x600 pyramid's octave 0
    (layers 1-3), bf16 against f32, on the card: mean cosine of the
    descriptors >= 0.995 (the JAX package's bound for its bf16 CNN), so the
    RMS of the difference of the unit descriptors <= 0.1, and the worst
    descriptor's cosine >= 0.97."""
    img, _, _ = synthetic_image_pair(0)
    octs = gray_pyramid(torch.from_numpy(img)[None].to(cuda), upsample=False)
    levels = octs[0][0, 1:4, None] / 255.0                   # (3, 1, 600, 800)
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = CARHyNet(dense=True, in_channels=1)
        load_variables(model, load_car_checkpoint(CAR_WEIGHTS))
        model = model.to(cuda, dtype).eval()
        with torch.no_grad():
            maps[dtype] = model(levels.to(dtype)).reshape(-1, 128)
    cos = (maps[torch.float32] * maps[torch.bfloat16]).sum(dim=1)
    rms = (maps[torch.float32] - maps[torch.bfloat16]).pow(2).sum(dim=1).mean().sqrt()
    assert maps[torch.bfloat16].dtype == torch.float32
    assert cos.mean().item() >= 0.995 and rms.item() <= 0.1
    assert cos.min().item() >= 0.97


def test_sinkhorn_kernel_in_devsift_composition(cuda):
    """K2 at the batched devsift program's shape: 4 pairs, the trunk
    compacted to 6144 keypoints per side, so Z (4, 6145, 6145) with kept
    counts below the bucket, 20 iterations. Inside that composition the
    TPU kernel brought the TPU worker down (the JAX bench runs XLA's
    Sinkhorn there); the port runs K2 and holds it to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    nb, iters = 6144, 20
    ms = torch.tensor([5900, 6144, 5200, 6050], device=cuda)
    ns = torch.tensor([6000, 5800, 6144, 4900], device=cuda)
    scores = 2 * torch.randn((4, nb, nb), generator=g, device=cuda)
    ar = torch.arange(nb, device=cuda)
    row_mask, col_mask = ar[None] < ms[:, None], ar[None] < ns[:, None]
    before = cuda_sinkhorn.launches
    got = cuda_sinkhorn.log_optimal_transport_cuda(scores, 1.0, iters, row_mask, col_mask)
    want = sinkhorn.log_optimal_transport(scores, 1.0, iters, row_mask, col_mask)
    torch.cuda.synchronize()
    assert cuda_sinkhorn.launches == before + 1
    assert cuda_sinkhorn.z_reads_per_iter(4, nb + 1, nb + 1) == 1  # the fused kernel
    for i in range(4):
        r = torch.cat([torch.nonzero(row_mask[i])[:, 0], torch.tensor([nb], device=cuda)])
        c = torch.cat([torch.nonzero(col_mask[i])[:, 0], torch.tensor([nb], device=cuda)])
        assert (got[i][r][:, c] - want[i][r][:, c]).abs().max().item() <= 2e-4


def forward_band(adj, wh):
    """The forward band of a dense adjacency: band[:, i, m] = adj[:, i, i + 1 + m]."""
    b, n, _ = adj.shape
    j = torch.arange(n, device=adj.device)[:, None] + 1 + torch.arange(wh, device=adj.device)
    return (torch.gather(adj, 2, j.clamp(max=n - 1)[None].expand(b, n, wh)) & (j < n)).contiguous()


def random_geometric_graphs(cuda, b, n, wh, seed):
    """Keypoints sorted by x in a strip, edges between points within 12 px
    kept with probability 0.6: the AGC graphs' shape (components of a few
    to a few hundred nodes), as a dense adjacency, a forward band of wh and
    valid masks with a padded tail."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.sort(torch.rand((b, n), generator=g, device=cuda) * 40 * n ** 0.5, dim=1).values
    y = torch.rand((b, n), generator=g, device=cuda) * 600
    d2 = (x[:, :, None] - x[:, None, :]) ** 2 + (y[:, :, None] - y[:, None, :]) ** 2
    keep = torch.rand((b, n, n), generator=g, device=cuda) < 0.6
    keep = torch.triu(keep, 1)
    adj = (d2 <= 144.0) & (keep | keep.transpose(1, 2))
    del d2, keep
    idx = torch.arange(n, device=cuda)
    adj &= (idx[:, None] - idx[None, :]).abs() <= wh
    adj &= idx[:, None] != idx[None, :]
    valid = idx[None] < torch.tensor([n - 17 * i for i in range(b)], device=cuda)[:, None]
    adj &= valid[:, :, None] & valid[:, None, :]
    return adj.contiguous(), forward_band(adj, wh), valid


def mixed_graphs(cuda, n, wh, seed):
    """Graphs that settle at different rounds in one batch: a path over every
    node (cut short by the small caps), two random geometric graphs (which
    settle early), a graph with no valid node, one with a single valid node
    among edges, and one with no edge. Edges touch invalid nodes too."""
    adj, _, valid = random_geometric_graphs(cuda, 6, n, wh, seed)
    idx = torch.arange(n, device=cuda)
    adj[0] = (idx[:, None] - idx[None, :]).abs() == 1
    valid[0] = True
    valid[3] = False
    valid[4] = idx == n // 2
    adj[4] = adj[1]
    adj[5] = False
    return adj.contiguous(), forward_band(adj, wh), valid


def crowded_graphs(cuda, b, n, wh, seed):
    """Random geometric graphs whose first half of nodes is joined with
    probability 0.6 (within the band): the blocks that own those rows hold
    too many neighbours to list them in shared memory. In the dense and band
    layouts they read their rows' bits every round while the others list
    their neighbours."""
    adj, _, valid = random_geometric_graphs(cuda, b, n, wh, seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    h = n // 2
    crowd = torch.triu(torch.rand((b, h, h), generator=g, device=cuda) < 0.6, 1)
    idx = torch.arange(h, device=cuda)
    crowd &= (idx[:, None] - idx[None, :]).abs() <= wh
    adj[:, :h, :h] = (crowd | crowd.transpose(1, 2)) & valid[:, :h, None] & valid[:, None, :h]
    return adj.contiguous(), forward_band(adj, wh), valid


# (graphs, N, band width) per case; N = 1000 is no multiple of 32 (nor 16)
LABEL_CASES = {"random": (3, 1000, 128), "mixed": (6, 1000, 128),
               "more graphs than resident clusters": (40, 2048, 128),
               "crowded": (2, 4096, 1024)}
# (layout, graphs, N, band width, or neighbours a node for sparse): the
# widest buckets, and an N past what shared memory holds in each layout (the
# global route)
BIG_LABEL_CASES = {"dense 2 x 12288": ("dense", 2, 12288, 128),
                   "dense 1 x 24576": ("dense", 1, 24576, 128),
                   "band 1 x 24576": ("band", 1, 24576, 512),
                   "dense global route": ("dense", 1, 29000, 128),
                   "band global route": ("band", 1, 29000, 512),
                   "sparse global route": ("sparse", 1, 29000, 6)}


def neighbour_lists(adj, d):
    """(nbr_ok, nbr_idx) of the sparse layout: each node's first d neighbours."""
    key = torch.where(adj, torch.arange(adj.shape[1], device=adj.device), 10 ** 6)
    nbr = torch.sort(key, dim=2, stable=True).indices[..., :d]
    return torch.gather(adj, 2, nbr), nbr


def check_label_rounds(mode, edges, valid, rounds, nbr=None):
    """The kernel against its plain version: labels bit-equal, one launch,
    and the rounds each graph ran equal to rounds_plain's."""
    from gims_tpu_torch.agc import labels

    before = labels.launches
    got = labels.propagate(mode, edges, valid, rounds, nbr)
    torch.cuda.synchronize()
    assert labels.launches == before + 1
    assert torch.equal(got, labels.propagate_plain(mode, edges, valid, rounds, nbr))
    run = labels.last_rounds
    assert run.shape == (valid.shape[0],)
    assert torch.equal(run, labels.rounds_plain(mode, edges, valid, rounds, nbr))
    return run


@pytest.mark.parametrize("case", list(LABEL_CASES))
@pytest.mark.parametrize("rounds", [0, 1, 2, 20])
@pytest.mark.parametrize("mode", ["dense", "band", "sparse"])
def test_label_rounds_kernel_vs_plain(cuda, mode, rounds, case):
    """The label-rounds kernel (every round on the card, each graph stopping
    at its first round that changes nothing) against its plain version:
    labels equal and rounds run per graph equal, at caps that cut the rounds
    short and at the usual cap; N not a multiple of 32; a batch settling at
    mixed rounds; more graphs than the card holds clusters at once; dense
    and band rows too crowded for the blocks' neighbour lists beside rows
    that fit, as the kernel reports each block's choice."""
    from gims_tpu_torch.agc import labels

    b, n, wh = LABEL_CASES[case]
    if case == "mixed":
        adj, band, valid = mixed_graphs(cuda, n, wh, seed=rounds)
    elif case == "crowded":
        adj, band, valid = crowded_graphs(cuda, b, n, wh, seed=rounds)
    else:
        adj, band, valid = random_geometric_graphs(cuda, b, n, wh, seed=rounds)
    nbr = None
    edges = {"dense": adj, "band": band}.get(mode)
    if mode == "sparse":
        edges, nbr = neighbour_lists(adj, 6)
    p = labels.plan(mode, b, n, edges.shape[2], rounds)
    assert p["cluster"] == 1
    if case == "more graphs than resident clusters":
        assert b > p["resident_clusters"]
    run = check_label_rounds(mode, edges, valid, rounds, nbr)
    if mode != "sparse":  # the blocks' choices, as the kernel wrote them
        listed = labels.last_listed.cpu()
        assert listed.shape == (b, p["cluster_size"])
        if case == "crowded":  # some blocks' lists fit, some do not
            assert (listed == 0).any() and (listed == 1).any()
        else:
            assert (listed == 1).all()
    assert ((1 <= run) & (run <= rounds + 1)).all()
    if rounds == 20 and case not in ("mixed", "crowded"):
        assert (run < 21).all()  # these graphs settle early
    if case == "mixed" and rounds == 20:
        assert len(set(run.tolist())) >= 2  # the graphs settle at different rounds


@pytest.mark.parametrize("rounds", [0, 1, 2, 20])
@pytest.mark.parametrize("case", list(BIG_LABEL_CASES))
def test_label_rounds_kernel_vs_plain_sizes(cuda, case, rounds):
    """Two graphs of 12288 and one of 24576 nodes (the cluster route, clusters
    of 16), and 29000 nodes in each layout, past what shared memory holds
    (27,264 on an H100), where plan() takes the global route."""
    from gims_tpu_torch.agc import labels

    mode, b, n, w = BIG_LABEL_CASES[case]
    adj, band, valid = random_geometric_graphs(cuda, b, n, 128 if mode == "sparse" else w,
                                               seed=rounds)
    nbr = None
    edges = {"dense": adj, "band": band}.get(mode)
    if mode == "sparse":
        edges, nbr = neighbour_lists(adj, w)
    del adj
    p = labels.plan(mode, b, n, edges.shape[2], rounds)
    assert p["cluster"] == (0 if case.endswith("global route") else 1)
    if p["cluster"]:
        assert p["cluster_size"] == 16
    check_label_rounds(mode, edges, valid, rounds, nbr)
    assert (labels.last_listed is None) == (not p["cluster"] or mode == "sparse")


def test_band_build_equals_dense_approx_on_card(cuda):
    """AGC at (16, 6144), keypoints uniform over 800x600 (every radius pair
    within 512 x-sorted positions): the band build equals the dense build
    with the same strided threshold and the centroid reconnect. The band's
    similarities come from block products and the dense ones from one
    (N, N) product, so a candidate pair may move across the threshold by an
    f32 rounding: any differing entry must be such a pair or a link that
    follows from one, at most 16 per set (as tests/test_agc.py holds the JAX
    builds). The label rounds run to convergence: labels cut short by the
    default cap depend on the node order, which the band build changes."""
    from gims_tpu_torch.agc import graph

    g = torch.Generator(device=cuda).manual_seed(3)
    b, n = 16, 6144
    kpts = torch.rand((b, n, 2), generator=g, device=cuda) * torch.tensor([800.0, 600.0],
                                                                       device=cuda)
    descs = torch.rand((b, n, 256), generator=g, device=cuda) ** 4
    valid = torch.ones((b, n), dtype=torch.bool, device=cuda)
    valid[:, n - 300:] = False
    kw = dict(radius=15.0, percentile=2.0, min_size=7, reconnect_impl="centroid",
              reconnect_buckets=1024, cc_rounds=100)
    band = graph.build_graph_band(kpts, descs, valid, band_halfwidth=512,
                                  threshold_stride=4, **kw)
    dense = graph.build_graph(kpts, descs, valid, threshold_impl="approx",
                              threshold_stride=4, **kw)
    for i in range(b):
        assert graph.band_coverage(kpts[i], valid[i], 15.0, 512)["coverage"] == 1.0
    assert torch.equal(band.threshold, dense.threshold)
    diff = band.adj != dense.adj
    assert int(diff.flatten(1).sum(1).max()) <= 16
    if diff.any():
        normed = descs / descs.norm(dim=-1, keepdim=True)
        bi, ii, jj = torch.nonzero(diff, as_tuple=True)
        near = graph.pairwise_sq_dists(kpts)[bi, ii, jj] <= 225.0
        sim = (normed[bi, ii] * normed[bi, jj]).sum(-1)
        # an edge candidate (not below the threshold) differs only on a straddle
        assert ((sim[near] - band.threshold[bi[near]]) < 1e-5).all()
    assert int((band.kept != dense.kept).sum()) <= 16


@pytest.mark.parametrize("interpolation,warp_size", [("cubic", 64), ("linear", 32)])
def test_patch_warp_card_vs_cpu(cuda, interpolation, warp_size):
    """The colour pyramid of an 800x600 image and 3000 keypoints over every
    octave (some on the border): the card's patches against the CPU's, in
    chunks of the card's size (1024 / 4096 keypoints)."""
    img, _, _ = synthetic_image_pair(4, colour=True)
    rng = np.random.RandomState(0)
    n = 3000
    octave = rng.randint(-1, 8, n).astype(np.int32)
    kp = KeypointArrays(
        pt=(rng.rand(n, 2) * [800, 600]).astype(np.float32),
        size=rng.uniform(1.5, 20.0, n).astype(np.float32),
        angle=rng.uniform(0, 360, n).astype(np.float32), response=np.ones(n, np.float32),
        octave=octave, layer=rng.randint(1, 4, n).astype(np.int32),
        scale=np.where(octave >= 0, 1.0 / (1 << np.maximum(octave, 0)), 2.0).astype(np.float32))
    kp.pt[:100] = [[0.0, 0.0], [799.0, 599.0], [-2.0, 300.0], [801.0, 10.0]] * 25
    out = {}
    for dev in ("cpu", cuda):
        from gims_tpu_torch.frontend.pyramid import pyramid_from_uint8

        pyr = [p[0] for p in pyramid_from_uint8(torch.from_numpy(img)[None].to(dev))]
        out[str(dev)] = patches.extract_patches_device(pyr, kp, 4096, interpolation,
                                                       warp_size).cpu()
    assert (out["cuda"] - out["cpu"]).abs().max().item() * 255 <= 1e-3
    assert out["cpu"][:n].abs().sum(1).gt(0).float().mean() > 0.9


def test_carhynet_matching_kernels_vs_plain(cuda):
    """A carhynet Matching request (device detector, seeded random colour
    CAR-HyNet, staged checkpoint, 2048 keypoints, 20 iterations, threshold
    0.02) in f32: through the kernels and through the plain versions on the
    same features, kept and matches identical, matching scores 1e-3."""
    from gims_tpu_torch.api import Matching
    from gims_tpu_torch.matcher.convert import load_gims_checkpoint

    weights = os.path.join(os.path.dirname(CAR_WEIGHTS), "gims_tpu_sift_last.npz")
    img0, img1, _ = synthetic_image_pair(9)
    fe = FeatureFrontend(FrontendConfig(descriptor_source="carhynet", detector="device"),
                         device=cuda)
    variables = load_gims_checkpoint(weights)
    outs = []
    feats = None
    for impl, pallas in (("auto", True), ("flash", False)):
        m = Matching({"attention_dtype": "float32", "attention_impl": impl,
                      "use_pallas_sinkhorn": pallas, "sinkhorn_iterations": 20,
                      "match_threshold": 0.02, "max_keypoints": 2048},
                     variables=variables, frontend=fe, device=cuda)
        feats = feats or m.prepare_features((img0, img1))
        before = cuda_attention.launches
        outs.append(m({"image0": img0, "image1": img1, "radius": 15, "percentile": 2,
                       "min_size": 7, "features": feats}))
        assert cuda_attention.launches - before == (18 if pallas else 0)
    k, p = outs
    for key in ("keypoints0", "keypoints1", "matches0", "matches1"):
        np.testing.assert_array_equal(k[key], p[key], err_msg=key)
    assert (k["matches0"] >= 0).sum() > 0
    for key in ("matching_scores0", "matching_scores1"):
        assert np.abs(k[key] - p[key]).max() <= 1e-3


def test_matching_takes_a_frontend_on_the_same_card(cuda):
    """``cuda`` and ``cuda:0`` name one card: Matching takes a
    FeatureFrontend built on either."""
    from gims_tpu_torch.api import Matching

    fe = FeatureFrontend(FrontendConfig(descriptor_source="sift", detector="device",
                                        sift_descriptor="device"), device="cuda:0")
    m = Matching({"sinkhorn_iterations": 3}, frontend=fe)
    assert m.frontend is fe and m.device == fe.device == torch.device("cuda", 0)


def test_eval_gt_and_ransac_on_card_vs_cpu(cuda):
    """The evaluation's device work, ground-truth matching and RANSAC, on
    the card against the same functions on the CPU. Ground truth: the match
    arrays at least 99% equal (the card's f32 products may round a near tie,
    or a distance next to the 3 px radius, the other way). RANSAC draws another random
    stream on the card: the mean corner error to the true homography within
    0.25 px of the CPU's, inlier masks at least 98% equal."""
    from gims_tpu_torch.core.imgproc import perspective_transform
    from gims_tpu_torch.eval import metrics, ransac
    from gims_tpu_torch.eval.homography import gt_reprojection_matches
    from gims_tpu_torch.train.data import get_perspective_mat

    rng = np.random.RandomState(21)
    H = get_perspective_mat(0.85, 400, 300, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6,
                            rng).astype(np.float32)
    k0 = (rng.rand(3000, 2) * [800, 600]).astype(np.float32)
    k1 = perspective_transform(k0, H) + rng.randn(3000, 2).astype(np.float32)
    k1[2000:] = (rng.rand(1000, 2) * [800, 600]).astype(np.float32)
    card = gt_reprojection_matches(k0, k1[::-1].copy(), H, device="cuda")
    cpu = gt_reprojection_matches(k0, k1[::-1].copy(), H, device="cpu")
    m_card = np.full(len(k0), -1)
    m_cpu = np.full(len(k0), -1)
    m_card[card[0]], m_cpu[cpu[0]] = card[1], cpu[1]
    assert (m_card == m_cpu).mean() >= 0.99 and (m_cpu >= 0).sum() > 1000
    corners = metrics.corner_points(600, 800)

    def corner_error(Hm):
        return metrics.compute_pixel_error(perspective_transform(corners, Hm),
                                           perspective_transform(corners, H))

    src, dst = k0[:2500], perspective_transform(k0[:2500], H)
    dst = dst + rng.randn(2500, 2).astype(np.float32) * 0.5
    dst[1500:] = (rng.rand(1000, 2) * [800, 600]).astype(np.float32)
    (h_card, mask_card), (h_cpu, mask_cpu) = (
        ransac.find_homography(src, dst, device=d) for d in ("cuda", "cpu"))
    assert abs(corner_error(h_card) - corner_error(h_cpu)) <= 0.25
    assert (mask_card == mask_cpu).mean() >= 0.98


def _sift_cols(kp, packed):
    return kp.pt, kp.size, kp.angle, kp.response, packed


def _share_within(a, b):
    """Share of a's keypoints with a counterpart in b within the tolerances
    of tests/test_torch_sift.py: 1e-3 px, the same octave and layer bytes,
    size and response 1e-4 relative, angle 0.05 degrees."""
    pa, sa, aa, ra, oa = a
    pb, sb, ab, rb, ob = b
    order = np.argsort(pb[:, 0], kind="stable")
    lo = np.searchsorted(pb[order, 0], pa[:, 0] - 1e-3, "left")
    hi = np.searchsorted(pb[order, 0], pa[:, 0] + 1e-3, "right")
    ok = 0
    for i in range(len(pa)):
        for j in order[lo[i]:hi[i]]:
            da = abs((float(aa[i]) - float(ab[j]) + 180.0) % 360.0 - 180.0)
            if (abs(float(pa[i, 1]) - float(pb[j, 1])) <= 1e-3
                    and (oa[i] & 0xFFFF) == (ob[j] & 0xFFFF) and da <= 0.05
                    and abs(sb[j] / sa[i] - 1) <= 1e-4
                    and abs(rb[j] - ra[i]) <= 1e-4 * max(abs(float(ra[i])), 1e-12)):
                ok += 1
                break
    return ok / max(len(pa), 1)


@pytest.mark.parametrize("seed,hw", [(3, (240, 320)), (4, (600, 800))])
def test_host_sift_card_vs_cpu(cuda, seed, hw):
    """OpenCV's SIFT as the port computes it (frontend/sift.py) on the card
    against the CPU, under the tolerances that tests/test_torch_sift.py holds
    the CPU to OpenCV with: 98% of each side's keypoints matched, 99% of the
    descriptor bytes within one level, every descriptor at cosine >= 0.99.
    The pyramids are the same to the bit (IEEE float64 sums); the
    descriptors' histograms are summed in source order on both
    (``core/segsum.py``)."""
    from gims_tpu_torch.frontend import sift

    img = synthetic_image_pair(seed, hw, colour=True)[0]
    card, cpu = sift.SIFT(3, 0.001, 80, 1.6, device=cuda), sift.SIFT(3, 0.001, 80, 1.6,
                                                                    device="cpu")
    kg, pg, gauss = card.detect_raw(img)
    kc, pc, gauss_cpu = cpu.detect_raw(img)
    for a, b in zip(gauss, gauss_cpu):
        assert torch.equal(a.cpu(), b)
    assert _share_within(_sift_cols(kg, pg), _sift_cols(kc, pc)) >= 0.98
    assert _share_within(_sift_cols(kc, pc), _sift_cols(kg, pg)) >= 0.98
    top = sift.filter_top_responses(kc, 2048)
    dg = card.compute(img, top).astype(np.int64)
    dc = cpu.compute(img, top).astype(np.int64)
    assert (np.abs(dg - dc) <= 1).mean() >= 0.99
    cos = (dg * dc).sum(1) / np.maximum(np.linalg.norm(dg, axis=1) * np.linalg.norm(dc, axis=1),
                                        1e-9)
    assert cos.min() >= 0.99


def test_matching_host_sift_on_card(cuda):
    """Staged Matching at host/host (SIFT descriptors, the staged
    checkpoint, 2048 keypoints, 20 iterations, threshold 0.02): 18 K1, 1 K2
    and 1 label-rounds launch for a pair whose sides fill the bucket, and at
    least half of the matches within 3 px of the known homography."""
    from gims_tpu_torch.agc import labels
    from gims_tpu_torch.api import Matching
    from gims_tpu_torch.matcher.convert import load_gims_checkpoint
    from gims_tpu_torch.synthetic import correct_share

    weights = os.path.join(os.path.dirname(CAR_WEIGHTS), "gims_tpu_sift_last.npz")
    m = Matching({"descriptor_source": "sift", "max_keypoints": 2048,
                  "sinkhorn_iterations": 20, "match_threshold": 0.02},
                 variables=load_gims_checkpoint(weights), device=cuda)
    assert (m.frontend.cfg.detector, m.frontend.cfg.sift_descriptor) == ("host", "host")
    img0, img1, H = synthetic_image_pair(12)
    feats = m.prepare_features((img0, img1))
    assert feats["0"]["n"] == feats["1"]["n"] == 2048
    before = (cuda_attention.launches, cuda_sinkhorn.launches, labels.launches)
    pred = m({"image0": img0, "image1": img1, "radius": 15, "percentile": 2, "min_size": 7,
              "features": feats})
    after = (cuda_attention.launches, cuda_sinkhorn.launches, labels.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (18, 1, 1)
    assert (pred["matches0"] >= 0).sum() > 0
    assert correct_share(pred, H) >= 0.5


def test_sharded_one_rank_nccl_vs_unsharded(cuda):
    """Keypoint sharding (``matcher/sharded.py``) over a one-rank NCCL group
    on the card against the unsharded port, f32, a 4-layer 256-d matcher
    from the identity warm start, a synthetic request (SIFT-like unit
    descriptors, 900 keypoints a view) in buckets of 1024: the AGC's
    threshold, labels, kept and adjacency equal; Z of the sharded trunk
    (ring attention on K1's partial mode, the row-block Sinkhorn) within
    1e-5 of the unsharded trunk's (K1, the plain Sinkhorn) on the valid rows
    and columns and the dustbins; forward_match's matches and kept equal;
    sharded_memory_analysis reports the call's peak. (The Sinkhorn's sums
    run in another order, so Z's error scales with the potentials: with
    unnormalized descriptors, whose couplings reach Z = -500, it measured
    1.7e-5 relative to |Z| on an H100.)"""
    import socket

    import torch.distributed as dist

    from gims_tpu_torch.agc import graph
    from gims_tpu_torch.agc.sharded import build_graph_sharded
    from gims_tpu_torch.api import init_gmatcher_variables
    from gims_tpu_torch.config import AGCConfig
    from gims_tpu_torch.matcher import pipeline, ring_attention, sharded
    from gims_tpu_torch.matcher.convert import load_variables as load_matcher
    from gims_tpu_torch.matcher.gmatcher import normalize_keypoints
    from gims_tpu_torch.train import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl", device=cuda)
    group = dist.group.WORLD
    try:
        nb, nv, shape = 1024, 900, (600, 800)
        req, _ = synthetic_request(5, nv)
        args = []
        for side in "01":
            kp = np.full((1, nb, 2), 1e6, np.float32)
            kp[0, :nv] = req["keypoints" + side]
            de = np.zeros((1, nb, 256), np.float32)
            de[0, :nv] = req["descriptors" + side]
            args += [kp, de, np.arange(nb)[None] < nv]
        kp0, de0, va0, kp1, de1, va1 = (torch.from_numpy(a).to(cuda) for a in args)
        agc = dict(radius=40.0, percentile=5.0, min_size=3)
        want = graph.build_graph(kp0, de0, va0, **agc)
        got = build_graph_sharded(kp0, de0, va0, group=group, **agc)
        for key in ("adj", "kept", "labels", "threshold"):
            a, b = getattr(got, key), getattr(want, key)
            assert torch.equal(a, b), (key, int((a != b).sum()))

        mcfg = MatcherConfig(keypoint_encoder=(32, 64), num_gnn_layers=4,
                             sinkhorn_iterations=20, match_threshold=0.02,
                             attention_dtype="float32", use_pallas_sinkhorn=False)
        model = GMatcher(mcfg)
        load_matcher(model, init_gmatcher_variables(mcfg, seed=0, scheme="identity"))
        model = model.to(cuda).eval()
        adj1 = graph.build_graph(kp1, de1, va1, **agc)
        inputs = (normalize_keypoints(kp0, *shape), de0, want.adj, want.kept,
                  normalize_keypoints(kp1, *shape), de1, adj1.adj, adj1.kept)
        with torch.no_grad():
            z_want = model(*inputs)["Z"][0]
            ring_attention.set_ring_group(group)
            z_got = sharded.shard_model(model)(*inputs, group=group)["Z"][0]
        rows = torch.cat([torch.nonzero(want.kept[0])[:, 0], torch.tensor([nb], device=cuda)])
        cols = torch.cat([torch.nonzero(adj1.kept[0])[:, 0], torch.tensor([nb], device=cuda)])
        err = (z_got[rows][:, cols] - z_want[rows][:, cols]).abs().max().item()
        assert err <= 1e-5, err

        acfg = AGCConfig(**agc)
        m_want = pipeline.forward_match(model, acfg, kp0, de0, va0, kp1, de1, va1, shape)
        m_got = pipeline.forward_match(model, acfg, kp0, de0, va0, kp1, de1, va1, shape,
                                       shard_axis=group)
        for key in ("kept0", "kept1", "matches0", "matches1"):
            differ = int((m_got[key] != m_want[key]).sum())
            assert differ == 0, (key, differ)
        assert (m_want["matches0"] >= 0).sum() > 100
        mem = sharded.sharded_memory_analysis(model, acfg, group, shape, nb)
        assert 0 < mem["argument_bytes"] < mem["peak_bytes"], mem
    finally:
        ring_attention.set_ring_group(None)
        dist.destroy_process_group()


PHOTOS = sorted(__import__("glob").glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "photos", "*.jpg")))


def test_jpeg_decode_card_equals_cpu(cuda):
    """The six baseline photos: dequantisation, IDCT, upsampling and colour
    conversion on the card give the CPU's bytes, colour and gray."""
    from gims_tpu_torch.core import jpeg

    assert len(PHOTOS) == 6
    for path in PHOTOS:
        with open(path, "rb") as f:
            data = f.read()
        for flags in (jpeg.IMREAD_COLOR, jpeg.IMREAD_GRAYSCALE):
            np.testing.assert_array_equal(jpeg.decode_jpeg(data, flags, device=cuda),
                                          jpeg.decode_jpeg(data, flags, device="cpu"),
                                          err_msg=path)


def test_server_round_trip_on_card(cuda):
    """make_server on the card (the fused configuration, its K1/K2/label
    kernels): a POST of two JPEGs answers the PNG and X-Match-Details of
    find_matches in-process on the same bytes; 404 and 500 as on the CPU."""
    import http.client
    import json
    import threading

    from gims_tpu_torch.cli import serve_cli
    from gims_tpu_torch.core import image_io

    img0, img1, _ = synthetic_image_pair(31, (240, 320), colour=True)
    data = [image_io.encode_jpeg(img0), image_io.encode_jpeg(img1)]
    weights = os.path.join(os.path.dirname(CAR_WEIGHTS), "gims_tpu_dense_gray_e2e.npz")
    server = serve_cli.make_server(0, weights, fused=True, total_keypoints=2048, device=cuda)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(fields, path="/find_matches"):
        body, ctype = serve_cli.encode_multipart(fields)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        try:
            conn.request("POST", path, body=body, headers={"Content-Type": ctype})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    try:
        fields = {"image0": data[0], "image1": data[1], "resize_enabled": b"0"}
        assert post(fields, "/other")[0] == 404
        assert post({"image0": b"garbage", "image1": data[1]})[0] == 500
        status, headers, body = post(fields)
        assert status == 200 and headers["Content-Type"] == "image/png"
        details = json.loads(headers["X-Match-Details"])
        imgs = [image_io.imdecode(d, device=cuda) for d in data]
        viz, want = serve_cli.find_matches(server.matcher, *imgs, resize_enabled=False)
        # keypoints equal; the match count as chip_smoke.py's phase 23 holds it
        # (float atomics in AGC's centroid sums may flip a match near a tie)
        for key in ("keypoints0", "keypoints1"):
            assert details[key] == want[key], key
        assert abs(details["matches"] - want["matches"]) <= 0.01 * want["matches"]
        assert want["matches"] > 20
        got = image_io.decode_png(body)
        assert got.shape == viz.shape
        if details["matches"] == want["matches"]:
            np.testing.assert_array_equal(got, viz)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
