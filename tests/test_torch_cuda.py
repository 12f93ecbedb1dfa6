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
The patch warp on the card against the same warp on the CPU: 1e-3 on the
0..255 scale with TF32 off (the same f32 arithmetic; a sample coordinate may
round differently by an ulp).
"""

import os

import numpy as np
import pytest
import torch

from gims_tpu_torch.carhynet.convert import load_car_checkpoint, load_variables
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.config import FrontendConfig, MatcherConfig
from gims_tpu_torch.frontend import patches
from gims_tpu_torch.frontend.detect_device import gray_pyramid
from gims_tpu_torch.frontend.feature import FeatureFrontend
from gims_tpu_torch.frontend.sift import KeypointArrays
from gims_tpu_torch.matcher import attention, cuda_attention, cuda_sinkhorn, sinkhorn
from gims_tpu_torch.matcher.gmatcher import GMatcher
from gims_tpu_torch.synthetic import synthetic_image_pair

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
    q = torch.randn((1, 8, 4, 160), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        cuda_attention.masked_attention_cuda(q, q, q, mask)  # head dim 160 > 128
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


@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_auto_by_head_width(cuda, d):
    """On the card "auto" launches the kernel at every head width up to 128
    (one or two column blocks of 64; 32 reads zeros past its end), in f32
    and bf16; the wrapper raises at a wider head. f32 against the direct
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
    wide = torch.randn((2, 300, 4, 160), generator=g, device=cuda)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="head dim"):
            attention.masked_attention(wide, wide, wide, torch.ones_like(mask[:, :300]),
                                       impl=impl)


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
    idx = torch.arange(n, device=cuda)
    adj &= (idx[:, None] - idx[None, :]).abs() <= wh
    adj &= idx[:, None] != idx[None, :]
    valid = idx[None] < torch.tensor([n - 17 * i for i in range(b)], device=cuda)[:, None]
    adj &= valid[:, :, None] & valid[:, None, :]
    j = idx[:, None] + 1 + torch.arange(wh, device=cuda)[None, :]
    band = torch.gather(adj, 2, j.clamp(max=n - 1)[None].expand(b, n, wh)) & (j < n)
    return adj.contiguous(), band.contiguous(), valid


@pytest.mark.parametrize("rounds", [0, 1, 2, 20])
@pytest.mark.parametrize("mode", ["dense", "band", "sparse"])
def test_label_rounds_kernel_vs_plain(cuda, mode, rounds):
    """The label-rounds kernel (every round in one launch, stopping at the
    first round that changes nothing) against its plain version: labels
    equal, at caps that cut the rounds short and at the usual cap."""
    from gims_tpu_torch.agc import labels

    adj, band, valid = random_geometric_graphs(cuda, 3, 1000, 128, seed=rounds)
    args = {"dense": (adj,), "band": (band,)}.get(mode)
    nbr = None
    if mode == "sparse":
        key = torch.where(adj, torch.arange(1000, device=cuda), 10 ** 6)
        nbr = torch.sort(key, dim=2, stable=True).indices[..., :6]
        args = (torch.gather(adj, 2, nbr),)
    before = labels.launches
    got = labels.propagate(mode, *args, valid, rounds, nbr)
    torch.cuda.synchronize()
    assert labels.launches == before + 1
    want = labels.propagate_plain(mode, *args, valid, rounds, nbr)
    assert torch.equal(got, want)
    run = int(labels.last_rounds)
    assert 1 <= run <= rounds + 1
    if rounds == 20:
        assert run < 21  # these graphs settle early


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
