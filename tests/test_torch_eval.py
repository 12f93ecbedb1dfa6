"""The evaluation slice: the PyTorch port against the JAX package on the CPU,
with OpenCV, which the JAX package calls, as the reference of the port's
replacements for it. Inputs are seeded numpy arrays and the committed PNG
sets (``assets/quality_photos_heldout``, ``assets/quality_structured``).

Tolerances:
- ``image_io.imread``: bit-equal to ``cv2.imread`` (colour and gray), on
  the committed PNGs and on PNGs written by ``cv2.imwrite`` with each row
  filter (0-4, and OpenCV's adaptive choice per row); ``imwrite`` then
  ``cv2.imread`` gives the image back bit for bit;
- ``imgproc``: ``gaussian_blur`` and ``bgr_to_gray`` bit-equal to OpenCV;
  ``resize`` (linear downscales, cubic at the generator's 4x upscale and a
  4/5 downscale) and ``warp_perspective`` within 1 gray level with at
  least 99.9% of the values equal (OpenCV's fixed-point weights round
  differently on a few pixels); linear upscales of a raw noise texture
  within 1 level with at least 99% equal (OpenCV's vector code for
  upscales rounds otherwise on up to ~0.8% of such pixels); ``perspective_transform``
  bit-equal; ``get_perspective_transform`` within 1e-10 relative;
- ``read_image_with_homography``: images within 1 gray level of JAX's, at
  least 99.99% equal; the scaled homography to 1e-6;
- ``generate_benchmark``: homography lines equal to 1e-12, images within 1
  gray level, at least 99.9% equal;
- the homography synthesis (``train.data``): bit-equal;
- ``find_matches``, ``build_gt_rows``, ``gt_reprojection_matches``:
  bit-equal to JAX's jitted functions, ties and padding included;
- ``metrics``: to 1e-12;
- ``evaluate_pair`` with a stub matcher: precision and recall exact,
  ``error_dlt`` to 1e-4 relative, ``error_ransac`` within 0.25 px of JAX's;
- ``ransac.find_homography`` against ``cv2.findHomography(RANSAC)`` on 20
  seeded sets of 300 true matches (0.5 px noise) and 40% outliers: the
  mean corner error to the true homography within 0.25 px of OpenCV's,
  inlier masks at least 98% equal.
"""

import ast
import os
import struct
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from gims_tpu.eval import geometry as jgeometry
from gims_tpu.eval import homography as jhomography
from gims_tpu.eval import matches as jmatches
from gims_tpu.eval import metrics as jmetrics
from gims_tpu.train import data as jdata
from gims_tpu.train import gt as jgt
from gims_tpu_torch.cli import eval_homography_cli, eval_matches_cli, generate_pairs_cli
from gims_tpu_torch.core import image_io, imgproc
from gims_tpu_torch.eval import geometry, homography, matches, metrics, ransac
from gims_tpu_torch.train import data, gt
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ("quality_photos_heldout", "quality_structured")
FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH", "ALL_FILTERS")


def committed(set_name, i):
    return os.path.join(REPO, "assets", set_name, "images", f"pair_{i:04d}.png")


def homography_line(set_name, i):
    with open(os.path.join(REPO, "assets", set_name, "pairs_homo.txt")) as f:
        parts = f.readlines()[i].split()
    return parts[0], np.array(list(map(float, parts[1:]))).reshape(3, 3).astype(np.float32)


def texture(seed, shape):
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur(rng.randint(0, 255, shape).astype(np.uint8), (0, 0), 1.0)


def png_filters(data):
    """The row filter types of a PNG file's scanlines."""
    w, h, _, colour, _, _, _ = struct.unpack(">IIBBBBB", data[16:29])
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


def within_one(a, b, share):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.shape == b.shape
    assert d.max() <= 1 and (d == 0).mean() >= share, (d.max(), (d == 0).mean())


# ---------------------------------------------------------------- image_io


@pytest.mark.parametrize("set_name", SETS)
@pytest.mark.parametrize("i", range(3))
def test_imread_committed_pngs_equal_cv2(set_name, i):
    path = committed(set_name, i)
    for flag in (image_io.IMREAD_COLOR, image_io.IMREAD_GRAYSCALE):
        got = image_io.imread(path, flag)
        want = cv2.imread(path, flag)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("name", FILTERS)
def test_imread_every_row_filter_equal_cv2(name, tmp_path):
    img = texture(0, (37, 53, 3))
    flag = getattr(cv2, "IMWRITE_PNG_FILTER_" + name) if name != "ALL_FILTERS" \
        else cv2.IMWRITE_PNG_ALL_FILTERS
    for k, im in enumerate((img, img[..., 0], np.concatenate([img, img[..., :1]], 2))):
        path = str(tmp_path / f"f{k}.png")
        assert cv2.imwrite(path, im, [cv2.IMWRITE_PNG_FILTER, flag])
        kinds = png_filters(open(path, "rb").read())
        if name != "ALL_FILTERS":
            assert kinds == {FILTERS.index(name)}, kinds
        for f in (image_io.IMREAD_COLOR, image_io.IMREAD_GRAYSCALE):
            assert np.array_equal(image_io.imread(path, f), cv2.imread(path, f))


def test_imwrite_round_trip_through_cv2(tmp_path):
    img = texture(1, (41, 29, 3))
    for k, im in enumerate((img, img[..., 0], np.concatenate([img, img[..., :1]], 2))):
        path = str(tmp_path / f"w{k}.png")
        assert image_io.imwrite(path, im)
        assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), im)
        assert np.array_equal(image_io.imread(path), cv2.imread(path))
    assert image_io.imread(str(tmp_path / "missing.png")) is None


def test_imread_unported_formats_raise(tmp_path):
    img = texture(2, (16, 16, 3))
    jpg = tmp_path / "a.jpg"
    cv2.imwrite(str(jpg), img)
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), img.astype(np.uint16) * 257)
    bilevel = tmp_path / "bilevel.png"
    cv2.imwrite(str(bilevel), img[..., 0], [cv2.IMWRITE_PNG_BILEVEL, 1])
    data = bytearray(image_io.encode_png(img))  # interlace byte set by hand
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(bytes(data))
    for path in (jpg, deep, bilevel, interlaced):
        with pytest.raises(NotImplementedError, match="OpenCV"):
            image_io.imread(str(path))
    with pytest.raises(NotImplementedError, match="OpenCV"):
        image_io.imwrite(str(tmp_path / "b.jpg"), img)


# ---------------------------------------------------------------- imgproc


def test_imgproc_against_cv2():
    photo = cv2.imread(committed(SETS[0], 0))
    low = np.random.RandomState(3).randint(0, 255, (30, 40, 3)).astype(np.uint8)
    for src, size in ((photo, (640, 480)), (photo, (123, 77))):
        within_one(imgproc.resize(src, size), cv2.resize(src, size), 0.999)
    for src, size in ((low, (160, 120)), (low[..., 0], (97, 61))):  # linear upscales
        within_one(imgproc.resize(src, size), cv2.resize(src, size), 0.99)
    # cubic: the generator's 4x upscale, and a downscale by 4/5
    for src, size in ((low, (160, 120)), (low[..., 0], (160, 120)), (photo, (640, 480))):
        within_one(imgproc.resize(src, size, imgproc.INTER_CUBIC),
                   cv2.resize(src, size, interpolation=cv2.INTER_CUBIC), 0.999)
    same = imgproc.resize(photo, (800, 600))
    assert np.array_equal(same, photo) and same is not photo
    for sigma in (0.8, 1.2, 2.5):
        for src in (photo, photo[..., 1]):
            assert np.array_equal(imgproc.gaussian_blur(src, sigma),
                                  cv2.GaussianBlur(src, (0, 0), sigma))
    assert np.array_equal(imgproc.bgr_to_gray(photo), cv2.cvtColor(photo, cv2.COLOR_BGR2GRAY))
    _, H = homography_line(SETS[0], 0)
    within_one(imgproc.warp_perspective(photo, H, (800, 600)),
               cv2.warpPerspective(photo, H, (800, 600)), 0.999)
    within_one(imgproc.warp_perspective(photo[..., 0], H, (640, 480)),
               cv2.warpPerspective(photo[..., 0], H, (640, 480)), 0.999)
    rng = np.random.RandomState(4)
    pts = (rng.rand(64, 2) * 800).astype(np.float32)
    for Hm in (H, H.astype(np.float64)):
        assert np.array_equal(imgproc.perspective_transform(pts, Hm),
                              cv2.perspectiveTransform(pts[:, None], Hm)[:, 0])
    for _ in range(50):
        s = (rng.rand(4, 2) * 800).astype(np.float32)
        d = (s + rng.randn(4, 2) * 30).astype(np.float32)
        want = cv2.getPerspectiveTransform(s, d)
        np.testing.assert_allclose(imgproc.get_perspective_transform(s, d), want,
                                   rtol=1e-10, atol=1e-12)


def test_get_perspective_transform_collinear_like_cv2():
    """Three collinear points: OpenCV 5 returns a unit null vector of the
    8x9 system (not scaled to H[2, 2] = 1). Where that null space has one
    dimension the vector is unique up to its sign, which does not change
    the homography."""
    rng = np.random.RandomState(5)
    s = np.array([[0, 0], [1, 1], [2, 2], [3, 5]], np.float32)
    for _ in range(3):
        d = (s * 1.5 + 1 + rng.rand(4, 2)).astype(np.float32)
        got, want = imgproc.get_perspective_transform(s, d), cv2.getPerspectiveTransform(s, d)
        assert np.isclose(np.linalg.norm(got), 1.0)
        assert min(np.abs(got - want).max(), np.abs(got + want).max()) < 1e-8


# ------------------------------------------------- homography synthesis, gt


def test_perspective_mats_equal_jax():
    for seed in range(3):
        r0, r1 = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(10):
            args = (0.85, 400, 300, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6)
            assert np.array_equal(jdata.get_perspective_mat(*args, r0),
                                  data.get_perspective_mat(*args, r1))
    H = jdata.get_perspective_mat(0.85, 400, 300, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6,
                                  np.random.RandomState(9))
    assert np.array_equal(jdata.scale_homography(H, 600, 800, 480, 640),
                          data.scale_homography(H, 600, 800, 480, 640))
    assert np.array_equal(jdata.get_rotmat(0.3, True, 1.2, 5, 7),
                          data.get_rotmat(0.3, True, 1.2, 5, 7))


def keypoint_sets(seed, n0, n1):
    rng = np.random.RandomState(seed)
    H = jdata.get_perspective_mat(0.85, 320, 240, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6,
                                  rng).astype(np.float32)
    k0 = (rng.rand(n0, 2) * [640, 480]).astype(np.float32)
    k1 = imgproc.perspective_transform(k0, H) + rng.randn(n0, 2).astype(np.float32) * 1.5
    k1 = np.concatenate([k1, (rng.rand(n1, 2) * [640, 480]).astype(np.float32)])
    k1 = k1[rng.permutation(len(k1))][:n1]
    k1[:6] = k1[6:12]  # equal points: ties in both argmins
    k0[:3] = k0[3:6]
    return k0, k1, H


@pytest.mark.parametrize("seed,n0,n1", [(0, 300, 280), (1, 1100, 700), (2, 64, 900)])
def test_find_matches_and_gt_rows_bit_equal_jax(seed, n0, n1):
    k0, k1, H = keypoint_sets(seed, n0, n1)
    v0 = np.arange(n0) < n0 - 7  # a padded tail on each side
    v1 = np.arange(n1) < n1 - 3
    jm = jax.jit(jgt.find_matches, static_argnames=("n_iters",))(
        k0, k1, H, v0, v1, 3.0, n_iters=3)
    tm = gt.find_matches(*(torch.from_numpy(x) for x in (k0, k1, H, v0, v1)), 3.0, 3)
    for j, t in zip(jm, tm):
        assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())
    jr = jax.jit(jgt.build_gt_rows, static_argnames=("batch_index",))(
        *jm, v0, v1, batch_index=2)
    tr = gt.build_gt_rows(*tm, torch.from_numpy(v0), torch.from_numpy(v1), 2)
    for j, t in zip(jr, tr):
        assert np.array_equal(np.asarray(j), t.numpy())
    assert (np.asarray(jm[0]) >= 0).sum() > 10
    jw = jax.jit(jgt.warp_keypoints)(k0, H)
    assert np.array_equal(np.asarray(jw), gt.warp_keypoints(torch.from_numpy(k0),
                                                            torch.from_numpy(H)).numpy())
    ja = jhomography.gt_reprojection_matches(k0, k1, H)
    ta = homography.gt_reprojection_matches(k0, k1, H, device="cpu")
    for j, t in zip(ja, ta):
        assert np.array_equal(j, t)


# ---------------------------------------------------------------- metrics


def test_metrics_equal_jax():
    rng = np.random.RandomState(6)
    errors = list(rng.gamma(1.0, 6.0, 57)) + [0.0, 25.0, 30.0]
    np.testing.assert_allclose(metrics.pose_auc(errors, (5, 10, 25)),
                               jmetrics.pose_auc(errors, (5, 10, 25)), rtol=0, atol=1e-12)
    a, b = rng.rand(4, 2) * 100, rng.rand(4, 2) * 100
    assert abs(metrics.compute_pixel_error(a, b) - jmetrics.compute_pixel_error(a, b)) <= 1e-12
    res = {"dlt_auc": [1.0, 2.0, 3.0], "ransac_auc": [40.0, 50.0, 60.0],
           "precision": 30.0, "recall": 80.0}
    assert abs(metrics.weighted_score(res) - jmetrics.weighted_score(res)) <= 1e-12
    assert np.array_equal(metrics.corner_points(480, 640), jmetrics.corner_points(480, 640))
    m = np.where(rng.rand(200) < 0.4, rng.randint(0, 150, 200), -1).astype(np.int32)
    gtv = np.where(rng.rand(200) < 0.5, rng.randint(0, 150, 200), -1).astype(np.int32)
    ma_0 = np.nonzero(gtv >= 0)[0]
    args = (m, gtv, m > -1, ma_0, gtv[ma_0])
    np.testing.assert_allclose(metrics.match_precision_recall(*args),
                               jmetrics.match_precision_recall(*args), rtol=0, atol=1e-12)


def test_descriptor_baselines_and_geometry_equal_jax():
    rng = np.random.RandomState(7)
    a, b = rng.rand(140, 32).astype(np.float32), rng.rand(155, 32).astype(np.float32)
    for fn in ("calculate_nndr", "calculate_mnn"):
        for x, y in zip(getattr(matches, fn)(a, b, 0.95), getattr(jmatches, fn)(a, b, 0.95)):
            np.testing.assert_array_equal(x, y)
    assert matches.device_peak_memory_gb("cpu") == 0.0
    K = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    for rot in (1, 2, 3):
        assert np.array_equal(geometry.rotate_intrinsics(K, (480, 640), rot),
                              jgeometry.rotate_intrinsics(K, (480, 640), rot))
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 1.0]
    k0, k1 = rng.rand(20, 2) * 600, rng.rand(20, 2) * 600
    assert np.array_equal(geometry.compute_epipolar_error(k0, k1, T, K, K),
                          jgeometry.compute_epipolar_error(k0, k1, T, K, K))


# ---------------------------------------------------------------- RANSAC


def corner_error(Hm, H_true, h=480, w=640):
    c = metrics.corner_points(h, w)
    return metrics.compute_pixel_error(imgproc.perspective_transform(c, Hm),
                                       imgproc.perspective_transform(c, H_true))


@pytest.mark.parametrize("seed", range(20))
def test_find_homography_against_cv2(seed):
    rng = np.random.RandomState(100 + seed)
    H = data.get_perspective_mat(0.85, 320, 240, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6, rng)
    n_in, n_out = 300, 200  # 40% outliers
    src = (rng.rand(n_in + n_out, 2) * [640, 480]).astype(np.float32)
    dst = imgproc.perspective_transform(src, H) + rng.randn(n_in + n_out, 2).astype(
        np.float32) * 0.5
    dst[n_in:] = (rng.rand(n_out, 2) * [640, 480]).astype(np.float32)
    got, mask = ransac.find_homography(src, dst, 3.0, max_iters=3000, device="cpu")
    want, want_mask = cv2.findHomography(src, dst, cv2.RANSAC, 3.0, maxIters=3000)
    assert got.dtype == np.float64 and got[2, 2] == 1.0
    assert mask.shape == want_mask.shape and mask.dtype == np.uint8
    assert abs(corner_error(got, H) - corner_error(want, H)) <= 0.25
    assert (mask == want_mask).mean() >= 0.98


def test_find_homography_degenerate_inputs():
    pts = np.random.RandomState(8).rand(3, 2).astype(np.float32) * 100
    assert ransac.find_homography(pts, pts, device="cpu") is None
    line = np.stack([np.arange(30), 2 * np.arange(30)], 1).astype(np.float32)
    assert ransac.find_homography(line, line + 1, device="cpu") is None  # every sample collinear
    assert ransac.update_num_iters(0.995, 0.5, 4, 3000) == int(round(
        np.log(0.005) / np.log(1 - 0.5 ** 4)))


# ------------------------------------------------ read, generate, evaluate


@pytest.mark.parametrize("resize", [(800, 600), (640, 480)])
def test_read_image_with_homography_matches_jax(resize):
    name, H = homography_line(SETS[0], 1)
    path = os.path.join(REPO, "assets", SETS[0], "images", name)
    j = jhomography.read_image_with_homography(path, H, resize)
    t = homography.read_image_with_homography(path, H, resize)
    within_one(t[0], j[0], 0.9999)
    within_one(t[1], j[1], 0.9999)
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-6)
    assert homography.read_image_with_homography(path + ".none", H, resize) == (None, None, None)


@pytest.mark.parametrize("n,h,w", [(3, 120, 160), (1, 600, 800)])
def test_generate_benchmark_matches_jax(n, h, w, tmp_path):
    jt, ji = jhomography.generate_benchmark(str(tmp_path / "j"), n_pairs=n, height=h, width=w)
    tt, ti = homography.generate_benchmark(str(tmp_path / "t"), n_pairs=n, height=h, width=w)
    jl, tl = open(jt).read().split(), open(tt).read().split()
    assert len(jl) == len(tl) == 10 * n
    for k in range(n):
        a, b = jl[10 * k:10 * k + 10], tl[10 * k:10 * k + 10]
        assert a[0] == b[0]
        np.testing.assert_allclose(np.array(b[1:], float), np.array(a[1:], float),
                                   rtol=0, atol=1e-12)
        within_one(image_io.imread(os.path.join(ti, b[0])), cv2.imread(os.path.join(ji, a[0])),
                   0.999)


class StubMatcher:
    """Fixed matcher outputs in the reference's dict contract."""

    def __init__(self, seed, H, h=480, w=640, n=260):
        rng = np.random.RandomState(seed)
        k0 = (rng.rand(n, 2) * [w, h]).astype(np.float32)
        k1 = imgproc.perspective_transform(k0, H) + rng.randn(n, 2).astype(np.float32) * 0.7
        bad = rng.rand(n) < 0.3
        k1[bad] = (rng.rand(int(bad.sum()), 2) * [w, h]).astype(np.float32)
        perm = rng.permutation(n)
        k1 = k1[perm]
        inv = np.argsort(perm)
        m0 = np.where(rng.rand(n) < 0.8, inv, -1).astype(np.int32)
        self.pred = {"keypoints0": k0[None], "keypoints1": k1[None], "matches0": m0[None],
                     "matching_scores0": rng.rand(n).astype(np.float32)[None]}

    def __call__(self, data):
        assert data["image0"].ndim == 4 and data["return_descriptors"] is False
        return self.pred


@pytest.mark.parametrize("seed", range(3))
def test_evaluate_pair_stub_matcher_matches_jax(seed):
    rng = np.random.RandomState(200 + seed)
    H = data.get_perspective_mat(0.85, 320, 240, 0.0008, 0.0008, 0.04, 10, 25, 0.6, 0.6,
                                 rng).astype(np.float32)
    stub = StubMatcher(seed, H)
    img = np.zeros((480, 640, 3), np.uint8)
    jr, ja = jhomography.evaluate_pair(stub, img, img, H)
    tr, ta = homography.evaluate_pair(stub, img, img, H, device="cpu")
    assert tr["precision"] == jr["precision"] and tr["recall"] == jr["recall"]
    assert abs(tr["error_dlt"] - jr["error_dlt"]) <= 1e-4 * abs(jr["error_dlt"])
    assert abs(tr["error_ransac"] - jr["error_ransac"]) <= 0.25
    for k in ja["matches_npz"]:
        assert np.array_equal(ta["matches_npz"][k], ja["matches_npz"][k])
    few = StubMatcher(seed, H, n=10)  # under min_matches: skipped in both
    assert homography.evaluate_pair(few, img, img, H, device="cpu")[0] is None
    assert jhomography.evaluate_pair(few, img, img, H)[0] is None


def test_run_benchmark_artifacts_with_stub_matcher(tmp_path):
    txt, images = homography.generate_benchmark(str(tmp_path / "set"), n_pairs=3, height=120,
                                                width=160)
    H = np.eye(3, dtype=np.float32)
    res = homography.run_benchmark(txt, images, str(tmp_path / "out"), resize=(160, 120),
                                   matcher=StubMatcher(0, H, 120, 160, n=200), device="cpu")
    jres = jhomography.run_benchmark(txt, images, str(tmp_path / "jout"), resize=(160, 120),
                                     matcher=StubMatcher(0, H, 120, 160, n=200))
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == sorted(os.listdir(tmp_path / "jout"))
    assert open(tmp_path / "out" / "result" / "results.txt").read() == \
        open(tmp_path / "jout" / "result" / "results.txt").read()
    assert res["precision"] == jres["precision"] and res["recall"] == jres["recall"]
    np.testing.assert_allclose(res["dlt_auc"], jres["dlt_auc"], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- CLIs


def jax_cli_flags(module_file):
    """{flag: argv values} of every add_argument of a JAX CLI source."""
    tree = ast.parse(open(os.path.join(REPO, "gims_tpu", "cli", module_file)).read())
    flags = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            continue
        flag = node.args[0].value
        kw = {k.arg: k.value for k in node.keywords}
        if "action" in kw:
            flags[flag] = []
        elif "choices" in kw:
            flags[flag] = [ast.literal_eval(kw["choices"])[-1]]
        elif "nargs" in kw:
            flags[flag] = ["640", "480"]
        elif getattr(kw.get("type"), "id", "") in ("int", "float"):
            flags[flag] = ["3"]
        else:
            flags[flag] = ["x"]
    return flags


@pytest.mark.parametrize("jax_file,port", [
    ("eval_homography_cli.py", eval_homography_cli),
    ("eval_matches_cli.py", eval_matches_cli),
    ("generate_pairs_cli.py", generate_pairs_cli)])
def test_cli_parsers_accept_every_jax_flag(jax_file, port):
    flags = jax_cli_flags(jax_file)
    assert len(flags) >= 4
    argv = [x for flag, vals in flags.items() for x in [flag] + vals]
    args = port.build_parser().parse_args(argv)
    for flag, vals in flags.items():
        got = getattr(args, flag[2:])
        want = True if not vals else (vals if len(vals) > 1 else vals[0])
        if isinstance(got, list):
            got = [str(v) for v in got]
        elif not isinstance(got, bool):
            got = str(got) if isinstance(got, str) else str(int(got))
        assert got == want, (flag, got, want)


def test_generate_pairs_cli_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        cv2.imwrite(str(src / f"im{i}.png"), texture(10 + i, (90, 120, 3)))
    (src / "notes.txt").write_text("skipped")
    from gims_tpu.cli import generate_pairs_cli as jcli

    jl = jcli.process(str(src), str(tmp_path / "j.txt"), str(tmp_path / "j"),
                      np.random.RandomState(3))
    generate_pairs_cli.main(["--image_dir", str(src), "--txt_path", str(tmp_path / "t.txt"),
                             "--image_save_path", str(tmp_path / "t")])
    tl = open(tmp_path / "t.txt").read().split("\n")[:-1]
    assert [l.split()[0] for l in tl] == [l.split()[0] for l in jl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.array(b.split()[1:], float),
                                   np.array(a.split()[1:], float), rtol=0, atol=1e-12)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        within_one(image_io.imread(str(tmp_path / "t" / name)),
                   cv2.imread(str(tmp_path / "j" / name)), 0.999)


def test_eval_clis_run_on_cpu(tmp_path, capsys):
    weights = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
    common = ["--weights_path", weights, "--descriptor_source", "sift", "--detector", "device",
              "--sift_descriptor", "device", "--device", "cpu"]
    res = eval_homography_cli.main(
        ["--generate", "2", "--gen_out", str(tmp_path / "gen"), "--input_homography",
         str(tmp_path / "none.txt"), "--output_dir", str(tmp_path / "dump"), "--resize", "160",
         "--max_keypoints", "256"] + common)
    out = tmp_path / "dump_gims"
    lines = open(out / "result" / "results.txt").read().split("\n")
    assert len(lines) == 2 and all(" => " in l for l in lines)
    assert len(list(out.glob("*_matches.npz"))) == 2
    assert len(list(out.glob("*_evaluation.npz"))) == 2
    assert res is None or np.isfinite(res["ransac_auc"]).all()
    _, images = homography.generate_benchmark(str(tmp_path / "small"), n_pairs=2, height=120,
                                              width=160)
    found = eval_matches_cli.main(
        ["--image0", os.path.join(images, "pair_0000.png"), "--image1",
         os.path.join(images, "*.png"), "--root_path", str(tmp_path / "match")] + common)
    assert len(found) == 1 and found[0].startswith("pair_0001 => ")
    assert (tmp_path / "match" / "gims" / "result.txt").exists()


def test_opencv_only_paths_raise(tmp_path):
    txt, images = homography.generate_benchmark(str(tmp_path / "s"), n_pairs=1, height=60,
                                                width=80)
    cases = [
        lambda: homography.run_benchmark(txt, images, str(tmp_path / "o"), save_viz=True,
                                         matcher=lambda d: None, device="cpu"),
        lambda: homography.generate_benchmark(str(tmp_path / "g"), 1, style="structured"),
        lambda: geometry.estimate_pose(np.zeros((8, 2)), np.zeros((8, 2)), np.eye(3),
                                       np.eye(3), 1.0),
        lambda: matches.run_match_eval(os.path.join(images, "pair_0000.png"), images + "/*",
                                       str(tmp_path / "m"), save_match=True,
                                       matcher=lambda d: None, device="cpu"),
        lambda: eval_homography_cli.main(["--input_homography", txt, "--input_dir", images,
                                          "--output_dir", str(tmp_path / "c"), "--save_viz",
                                          "--detector", "device", "--device", "cpu"]),
        lambda: image_io.decode_png(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))[1]
                                    .tobytes()),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError, match="OpenCV"):
            case()
    # the JAX defaults (OpenCV's SIFT detector, computed by the port) run
    eval_homography_cli.main(["--input_homography", txt, "--input_dir", images,
                              "--output_dir", str(tmp_path / "d"), "--device", "cpu",
                              "--max_keypoints", "128", "--resize", "80", "60"])
    assert (tmp_path / "d_gims" / "result" / "results.txt").exists()
