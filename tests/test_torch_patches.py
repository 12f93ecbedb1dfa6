"""The affine patch warp, the colour pyramid, the descriptor engine and the
dense descriptor frontends: the PyTorch port against the JAX package on
the CPU, on the same seeded numpy inputs. Tolerances:
- ``inverse_affines`` and ``_device_inverse_affines``: 1e-6 relative (the
  same f32 arithmetic);
- quad rows: equal (a copy with a zero ring);
- ``_warp_chunk`` (bicubic / bilinear x 64 / 32, keypoints at and past the
  level's edge): 1e-3 on the 0..255 scale;
- ``extract_patches_device`` and ``warp_patches_level`` on the same
  pyramid: 1e-2 on the 0..255 scale. Jitted, XLA fuses the sample
  coordinate a*x + b*y + c into multiply-adds, so a coordinate may differ
  by two f32 ulps (levels of up to 128 px here: 2 * 128 * 2^-23) and a
  sample by that times the largest step between neighbouring pixels (255,
  at the zero border): 7.8e-3. Un-jitted ``_warp_chunk`` rounds as the port
  does. Rows past the keypoints, and keypoints of an octave the pyramid
  lacks, exactly 0;
- ``pyramid_from_uint8``: 1e-3 on 0..255 (f32 blurs summed in another
  order);
- ``DescriptorEngine`` and both dense frontends with carried flax
  weights, f32: 1e-4 on the unit descriptors.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gims_tpu import fused as jfused
from gims_tpu.carhynet import engine as jengine
from gims_tpu.carhynet import model as jmodel
from gims_tpu.frontend import dense as jdense
from gims_tpu.frontend import patches as jpatches
from gims_tpu.frontend import pyramid as jpyramid
from gims_tpu.frontend import sift as jsift
from gims_tpu_torch import fused as tfused
from gims_tpu_torch.carhynet import engine as tengine
from gims_tpu_torch.frontend import dense as tdense
from gims_tpu_torch.frontend import patches as tpatches
from gims_tpu_torch.frontend import pyramid as tpyramid
from gims_tpu_torch.frontend.sift import KeypointArrays, unpack_octaves
from gims_tpu_torch.synthetic import synthetic_image_pair
from reference_layouts import carhynet_state_dict
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

FRAME = (48, 64)
JIT_TOL = 1e-2  # 0..255 scale, against the jitted JAX warp (module docstring)


def flax_init(in_channels, seed=0):
    # jitted: the values of the eager init, in a fraction of the time
    variables = jax.jit(jmodel.CARHyNet(in_channels=in_channels).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, in_channels), jnp.float32))
    return jax.tree_util.tree_map(np.asarray, variables)


def keypoints(seed, n, frame, n_oct, edge=True):
    """Keypoints over octaves -1..n_oct-2 with random sizes and angles
    (0 and 360 among them); with `edge`, a quarter of them on or past the
    image border."""
    rng = np.random.RandomState(seed)
    h, w = frame
    pt = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    if edge:
        m = n // 4
        pt[:m] = rng.choice([-3.0, -0.5, 0.0, w - 1.0, w + 2.0], (m, 2)).astype(np.float32)
        pt[:m, 1] = rng.choice([-2.0, 0.0, h - 1.0, h + 3.0], m)
    octave = rng.randint(-1, n_oct - 1, n).astype(np.int32)
    scale = np.where(octave >= 0, 1.0 / (1 << np.maximum(octave, 0)), 2.0).astype(np.float32)
    angle = rng.uniform(0, 360, n).astype(np.float32)
    angle[:3] = [0.0, 360.0, 180.0]
    return KeypointArrays(pt=pt, size=rng.uniform(1.5, 12.0, n).astype(np.float32),
                          angle=angle, response=rng.rand(n).astype(np.float32),
                          octave=octave, layer=rng.randint(1, 4, n).astype(np.int32),
                          scale=scale)


def as_jax_kp(kp):
    return jsift.KeypointArrays(*(getattr(kp, f) for f in
                                  ("pt", "size", "angle", "response", "octave", "layer",
                                   "scale")))


def test_inverse_affines_match_jax():
    kp = keypoints(0, 200, FRAME, 4)
    want = jpatches.inverse_affines(as_jax_kp(kp))
    np.testing.assert_allclose(tpatches.inverse_affines(kp), want, rtol=1e-6, atol=1e-6)
    # the fused path's device version, in octave coordinates
    px, py = kp.pt[:, 0] * kp.scale, kp.pt[:, 1] * kp.scale
    size_oct = kp.size * kp.scale
    want = np.asarray(jfused._device_inverse_affines(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(size_oct), jnp.asarray(kp.angle), 64))
    got = tfused._device_inverse_affines(*(torch.from_numpy(x) for x in
                                           (px, py, size_oct, kp.angle))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_unpack_octaves_matches_jax():
    packed = np.array([0, 1, 255, 254 | (2 << 8), 3 | (1 << 8) | (7 << 16)], np.int64)
    for a, b in zip(unpack_octaves(packed), jsift.unpack_octaves(packed)):
        np.testing.assert_array_equal(a, b)


def test_quad_rows_match_jax():
    levels = np.random.RandomState(1).rand(3, 7, 9, 3).astype(np.float32)
    want = np.asarray(jpatches.quad_rows_from_levels(jnp.asarray(levels)))
    got = tpatches.quad_rows_from_levels(torch.from_numpy(levels)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jpatches.quad_blocks_from_levels(jnp.asarray(levels)))
    np.testing.assert_array_equal(
        tpatches.quad_blocks_from_levels(torch.from_numpy(levels)).numpy(), want)


@pytest.mark.parametrize("interpolation,warp_size", [
    ("cubic", 64), ("cubic", 32), ("linear", 64), ("linear", 32)])
def test_warp_chunk_matches_jax(interpolation, warp_size):
    """Keypoints inside, on and past the edge of a 23x31 level stack."""
    rng = np.random.RandomState(warp_size)
    levels = (rng.rand(6, 23, 31, 3) * 255).astype(np.float32)
    kp = keypoints(warp_size, 24, (23, 31), 1)
    kp.scale[:] = 1.0
    ainv = tpatches.inverse_affines(kp)
    li = kp.layer
    quads = np.array(jpatches.quad_rows_from_levels(jnp.asarray(levels)))
    want = np.asarray(jpatches._warp_chunk(jnp.asarray(quads), 23, 31, 3, jnp.asarray(li),
                                           jnp.asarray(ainv), interpolation, warp_size))
    got = tpatches._warp_chunk(torch.from_numpy(quads), 23, 31, 3, torch.from_numpy(li),
                               torch.from_numpy(ainv), interpolation, warp_size).numpy()
    assert got.shape == want.shape == (24, 32 * 32 * 3)
    assert (want == 0).any() and (want > 0).any()  # the zero border is reached
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    from_levels = tpatches.warp_patches_chunk(torch.from_numpy(levels), torch.from_numpy(li),
                                              torch.from_numpy(ainv), interpolation, warp_size)
    np.testing.assert_array_equal(from_levels.numpy(), got)


@pytest.fixture(scope="module")
def colour_image():
    return synthetic_image_pair(7, FRAME, colour=True)[0]


@pytest.fixture(scope="module")
def jax_pyramid(colour_image):
    h, w = FRAME
    return [np.asarray(p) for p in jpyramid.pyramid_from_uint8(jnp.asarray(colour_image), h, w)]


def test_pyramid_from_uint8_matches_jax(colour_image, jax_pyramid):
    got = tpyramid.pyramid_from_uint8(torch.from_numpy(colour_image)[None])
    assert len(got) == len(jax_pyramid)
    for g, want in zip(got, jax_pyramid):
        assert tuple(g.shape[1:]) == want.shape
        np.testing.assert_allclose(g[0].numpy(), want, atol=1e-3, rtol=0)
    # four layers per octave seed the same chain
    short = tpyramid.pyramid_from_uint8(torch.from_numpy(colour_image)[None], n_layers=4)
    for s, g in zip(short, got):
        np.testing.assert_array_equal(s.numpy(), g[:, :4].numpy())


@pytest.mark.parametrize("interpolation,warp_size", [("cubic", 64), ("linear", 32)])
def test_extract_patches_device_matches_jax(jax_pyramid, interpolation, warp_size):
    """300 keypoints in a bucket of 1024: more than one chunk in octave 0,
    keypoints at the border, one octave past the pyramid; unused rows 0."""
    kp = keypoints(3, 300, FRAME, len(jax_pyramid) + 1)
    want = np.asarray(jpatches.extract_patches_device(
        [jnp.asarray(p) for p in jax_pyramid], as_jax_kp(kp), 1024, interpolation, warp_size))
    got = tpatches.extract_patches_device([torch.from_numpy(p) for p in jax_pyramid], kp,
                                          1024, interpolation, warp_size).numpy()
    assert got.shape == want.shape == (1024, 32 * 32 * 3)
    np.testing.assert_allclose(got, want, atol=JIT_TOL / 255, rtol=0)
    assert not got[300:].any()
    past = kp.octave + 1 >= len(jax_pyramid)
    assert past.any() and not got[:300][past].any()
    if warp_size == 64:  # the host variant warps at 64
        host = tpatches.extract_patches([torch.from_numpy(p) for p in jax_pyramid], kp,
                                        interpolation)
        np.testing.assert_array_equal(host, got[:300].reshape(300, 32, 32, 3))


def test_warp_patches_level_matches_jax(jax_pyramid):
    kp = keypoints(4, 40, FRAME, 1)
    ainv = tpatches.inverse_affines(kp)
    lv = jax_pyramid[0]
    want = np.asarray(jpatches.warp_patches_level(jnp.asarray(lv), jnp.asarray(kp.layer),
                                                  jnp.asarray(ainv)))
    got = tpatches.warp_patches_level(torch.from_numpy(lv), torch.from_numpy(kp.layer),
                                      torch.from_numpy(ainv)).numpy()
    np.testing.assert_allclose(got, want, atol=JIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def engines():
    """One flax init of the colour CAR-HyNet in a JAX engine (compiled once
    per bucket for the module) and in the port's."""
    variables = flax_init(3, seed=2)
    return (jengine.DescriptorEngine(variables=jax.tree_util.tree_map(jnp.asarray, variables)),
            tengine.DescriptorEngine(variables=variables, device="cpu"))


@pytest.mark.parametrize("n", [1, 512, 600])
def test_descriptor_engine_matches_jax(engines, n):
    """Patch buckets 512 and 1024 (n = 512 fills one exactly)."""
    jeng, eng = engines
    patches = np.random.RandomState(n).rand(n, 32, 32, 3).astype(np.float32)
    want = jeng.compute(patches)
    got = eng.compute(patches)
    assert got.shape == want.shape == (n, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    flat = eng.compute_device(torch.from_numpy(patches.reshape(n, -1))).numpy()
    np.testing.assert_allclose(flat, got, atol=1e-6, rtol=0)
    kps, desc = eng.compute_sift(patches, list(range(n)))
    np.testing.assert_array_equal(desc, got)


def test_engine_weights_files(tmp_path):
    # a reference .pth (a torch state_dict) loads through convert_carhynet_torch
    # into JAX's variables for it, and the engine runs on them as JAX's does
    sd = carhynet_state_dict(np.random.RandomState(6))
    path = tmp_path / "car_hynet.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    got = tengine.load_variables(str(path))
    want = jengine.load_variables(str(path))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    for key, leaf in flat:
        node = got
        for k in key:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(key))
    patches = np.random.RandomState(4).rand(5, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(
        tengine.DescriptorEngine(variables=got, device="cpu").compute(patches),
        jengine.DescriptorEngine(variables=jax.tree_util.tree_map(jnp.asarray, want))
        .compute(patches), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="format"):
        tengine.load_variables("car_hynet.bin")


def test_dense_frontend_matches_jax(jax_pyramid):
    """The colour dense descriptors (f32): maps over every octave of at
    least 16 px, keypoints of the octaves past them get 0."""
    variables = flax_init(3, seed=5)
    kp = keypoints(5, 150, FRAME, len(jax_pyramid))
    jfe = jdense.DenseDescriptorFrontend(jax.tree_util.tree_map(jnp.asarray, variables))
    want = np.asarray(jfe.compute([jnp.asarray(p) for p in jax_pyramid], as_jax_kp(kp), 256))
    got = tdense.DenseDescriptorFrontend(variables, device="cpu").compute(
        [torch.from_numpy(p) for p in jax_pyramid], kp, 256).numpy()
    assert got.shape == want.shape == (256, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    shapes = [p.shape[1:3] for p in jax_pyramid]
    offsets, dims, total = tdense.dense_meta(shapes)
    jo, jd, jt = jdense.dense_meta(shapes)
    np.testing.assert_array_equal(offsets, jo)
    assert dims == jd and total == jt
    for a, b in zip(tdense.sample_plan(kp, offsets, dims, 256),
                    jdense.sample_plan(as_jax_kp(kp), jo, jd, 256)):
        np.testing.assert_array_equal(a, b)


def test_dense_gray_frontend_matches_jax(colour_image):
    variables = flax_init(1, seed=6)
    kp = keypoints(6, 150, FRAME, 5)
    jfe = jdense.DenseGrayDescriptorFrontend(jax.tree_util.tree_map(jnp.asarray, variables),
                                             dtype="float32")
    want = np.asarray(jfe.compute(colour_image, as_jax_kp(kp), 256))
    tfe = tdense.DenseGrayDescriptorFrontend(variables, dtype="float32", device="cpu")
    got = tfe.compute(colour_image, kp, 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    offsets, dims, first = tfe.meta(*FRAME)
    jo, jd, jf = jfe.meta(*FRAME)
    np.testing.assert_array_equal(offsets, jo)
    assert dims == jd and first == jf
    for a, b in zip(tdense.sample_plan_gray(kp, offsets, dims, 256, first),
                    jdense.sample_plan_gray(as_jax_kp(kp), jo, jd, 256, jf)):
        np.testing.assert_array_equal(a, b)
