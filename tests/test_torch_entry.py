"""The user entry points and the torch checkpoint import on the CPU, against
the JAX package.

- ``convert_gmatcher_torch`` and ``convert_carhynet_torch`` against JAX's,
  leaf for leaf, on seeded state_dicts in the reference's layout (built as
  ``tests/test_api.py`` and ``tests/test_carhynet.py`` build them), with
  DDP's ``module.`` prefixes and the unconsumed-key error; a ``.pt`` in its
  three forms (``ema``, ``model``, bare) loads the staged checkpoint
  rewritten in the reference's layout, leaf for leaf, and matches as the
  converted variables do.
- ``match_pair_cli.main`` against ``gims_tpu.cli.match_pair_cli.main`` on
  one synthetic 160x120 JPEG pair, the staged checkpoint, SIFT descriptors
  at OpenCV's SIFT keypoints (which the port computes, ``frontend/sift.py``,
  its descriptor bytes within one level of OpenCV's): keypoints within 1e-3
  px, matches equal on 99% of the rows, scores within 1e-2 (stricter than
  ``tests/test_torch_sift.py``'s host-SIFT request rule, 90% of JAX's
  matched pairs; measured: every match equal, one score in 377 1.4e-3
  off); the same printed line; the JPEG written is cv2's encoding of JAX's
  drawing of the port's prediction; ``--fused`` runs too.
- ``find_matches`` against JAX's on one pair resized as the demo resizes,
  and one HTTP round trip through ``make_server(port=0)`` in a thread:
  the PNG and ``X-Match-Details`` of ``find_matches``, 404 on another
  path, 500 on a garbage upload, then the next request answered.
"""

import http.client
import json
import os
import threading

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from gims_tpu.carhynet import convert as jcar_convert
from gims_tpu.cli import match_pair_cli as jcli
from gims_tpu.cli import serve_cli as jserve
from gims_tpu.eval import viz as jviz
from gims_tpu.matcher import convert as jconvert
from gims_tpu_torch.api import Matching
from gims_tpu_torch.carhynet import convert as tcar_convert
from gims_tpu_torch.carhynet import engine as tengine
from gims_tpu_torch.cli import match_pair_cli, serve_cli
from gims_tpu_torch.core import image_io
from gims_tpu_torch.core.checkpoint import flatten_tree
from gims_tpu_torch.matcher import convert as tconvert
from gims_tpu_torch.synthetic import synthetic_image_pair
from reference_layouts import carhynet_state_dict, gmatcher_state_dict
from torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "gims_tpu_sift_last.npz")
E2E = os.path.join(REPO, "weights", "gims_tpu_dense_gray_e2e.npz")
FRAME = (120, 160)
STAGED = ["--descriptor_source", "sift", "--weights_path", WEIGHTS]


def same_leaves(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.asarray(fa[k]).shape == np.asarray(fb[k]).shape, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def test_convert_gmatcher_torch_equals_jax():
    sd = gmatcher_state_dict(np.random.RandomState(0))
    want = jconvert.convert_gmatcher_torch(sd, num_gnn_layers=2)
    same_leaves(tconvert.convert_gmatcher_torch(sd, num_gnn_layers=2), want)
    # torch tensors, DDP prefixes
    ddp = {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    same_leaves(tconvert.convert_gmatcher_torch(ddp, num_gnn_layers=2), want)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        tconvert.convert_gmatcher_torch({**sd, "extra.weight": np.zeros(1)}, num_gnn_layers=2)


def test_convert_carhynet_torch_equals_jax(tmp_path):
    sd = carhynet_state_dict(np.random.RandomState(1))
    want = jcar_convert.convert_carhynet_torch(sd)
    same_leaves(tcar_convert.convert_carhynet_torch(sd), want)
    with pytest.raises(ValueError, match="unconsumed torch keys"):
        tcar_convert.convert_carhynet_torch({**sd, "layer9.weight": np.zeros(1)})
    # the engine loads a .pth through it, and the port's CNN takes the result
    path = tmp_path / "car_hynet.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    loaded = tengine.load_variables(str(path))
    same_leaves(loaded, want)
    tengine.DescriptorEngine(variables=loaded, device="cpu")


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """A synthetic colour pair written as JPEG by cv2 (JAX's CLI reads it
    with cv2, the port with its own decoder: the same pixels)."""
    root = tmp_path_factory.mktemp("pair")
    img0, img1, H = synthetic_image_pair(5, FRAME, colour=True)
    paths = [str(root / "a.jpg"), str(root / "b.jpg")]
    for path, img in zip(paths, (img0, img1)):
        cv2.imwrite(path, img)
    return paths, H


def read_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_pt_checkpoints_in_three_forms(tmp_path, pair_files):
    variables = tconvert.load_gims_checkpoint(WEIGHTS)
    sd = chip_smoke.reference_gmatcher_state_dict(variables)
    forms = {"ema": {"ema": sd, "model": None},
             "model": {"ema": None, "model": {"module." + k: v for k, v in sd.items()}},
             "bare": sd}
    for name, obj in forms.items():
        torch.save(obj, tmp_path / f"{name}.pt")
        same_leaves(tconvert.load_gims_checkpoint(str(tmp_path / f"{name}.pt")), variables)
    # a .pt through the CLI matches as the converted variables passed directly
    paths, _ = pair_files
    npz = str(tmp_path / "m.npz")
    match_pair_cli.main([*paths, "--descriptor_source", "sift", "--weights_path",
                         str(tmp_path / "model.pt"), "--npz", npz,
                         "--out", str(tmp_path / "m.png"), "--device", "cpu"])
    direct = Matching({"sinkhorn_iterations": 20, "match_threshold": 0.02, "max_keypoints": -1,
                       "descriptor_source": "sift"},
                      variables=tconvert.convert_gmatcher_torch(sd), device="cpu")
    imgs = [image_io.imread(p) for p in paths]
    pred = direct({"image0": imgs[0][None], "image1": imgs[1][None], "radius": 15,
                   "percentile": 2, "min_size": 7})
    got = read_npz(npz)
    np.testing.assert_array_equal(got["matches"], pred["matches0"][0])
    np.testing.assert_array_equal(got["keypoints0"], pred["keypoints0"][0])
    assert (got["matches"] > -1).sum() > 20


def test_match_pair_cli_matches_jax(tmp_path, pair_files, capsys):
    paths, H = pair_files
    jnpz, tnpz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcli.main([*paths, *STAGED, "--npz", jnpz, "--out", str(tmp_path / "j.png")])
    jout = capsys.readouterr().out
    pred = match_pair_cli.main([*paths, *STAGED, "--npz", tnpz, "--out",
                                str(tmp_path / "t.jpg"), "--device", "cpu"])
    tout = capsys.readouterr().out
    want, got = read_npz(jnpz), read_npz(tnpz)
    assert sorted(got) == sorted(want) == ["keypoints0", "keypoints1", "match_confidence",
                                           "matches"]
    for key in ("keypoints0", "keypoints1"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, rtol=0, err_msg=key)
    # host SIFT descriptors may differ from OpenCV's by a level in a byte
    # (tests/test_torch_sift.py), which moves a score by ~1e-3
    assert (got["matches"] == want["matches"]).mean() >= 0.99
    np.testing.assert_allclose(got["match_confidence"], want["match_confidence"], atol=1e-2,
                               rtol=0)
    assert (got["matches"] > -1).sum() > 50
    # the same printed lines (timings differ)
    first = [line for line in jout.splitlines() if line.startswith("keypoints:")]
    assert first and first == [line for line in tout.splitlines()
                               if line.startswith("keypoints:")]
    assert any(line.startswith("timings:") for line in tout.splitlines())
    # the drawing written (JPEG): JAX's drawing of the port's prediction, encoded as cv2 does
    valid = got["matches"] > -1
    imgs = [cv2.imread(p) for p in paths]
    viz = jviz.draw_matches(*imgs, got["keypoints0"][valid],
                            got["keypoints1"][got["matches"][valid]])
    assert (tmp_path / "t.jpg").read_bytes() == cv2.imencode(".jpg", viz)[1].tobytes()
    assert pred["matches0"].shape == (1, len(got["keypoints0"]))


def test_match_pair_cli_fused_runs(tmp_path, pair_files):
    paths, _ = pair_files
    argv = [*paths, "--fused", "--fast", "--descriptor_source", "dense_gray",
            "--weights_path", E2E, "--total_keypoints", "256", "--device", "cpu",
            "--npz", str(tmp_path / "f.npz"), "--out", str(tmp_path / "f.png")]
    pred = match_pair_cli.main(argv)
    args = match_pair_cli.build_parser().parse_args(argv)
    direct = match_pair_cli.run(match_pair_cli.build_matcher(args),
                                *[image_io.imread(p) for p in paths], args)
    got = read_npz(str(tmp_path / "f.npz"))
    for key, k in (("keypoints0", "keypoints0"), ("matches", "matches0")):
        np.testing.assert_array_equal(got[key], direct[k][0])
        np.testing.assert_array_equal(got[key], pred[k][0])
    assert (got["matches"] > -1).sum() > 5
    assert image_io.imread(str(tmp_path / "f.png")).shape == (FRAME[0], 2 * FRAME[1], 3)


@pytest.fixture(scope="module")
def matchers():
    """JAX's and the port's staged Matching: the staged checkpoint, SIFT."""
    from gims_tpu.api import Matching as JMatching

    cfg = {"weights_path": WEIGHTS, "sinkhorn_iterations": 20, "match_threshold": 0.02,
           "max_keypoints": -1, "descriptor_source": "sift"}
    return JMatching(cfg), Matching(cfg, device="cpu")


def test_find_matches_matches_jax(pair_files, matchers):
    jm, tm = matchers
    imgs = [cv2.imread(p) for p in pair_files[0]]
    small = [img[:96, :128] for img in imgs]
    jviz_img, jd = jserve.find_matches(jm, *small, resize_enabled=True, resize=(160, 120))
    tviz_img, td = serve_cli.find_matches(tm, *small, resize_enabled=True, resize=(160, 120))
    assert set(td) == set(jd)
    for key in ("keypoints0", "keypoints1", "matches"):
        assert td[key] == jd[key], key
    assert td["matches"] > 20
    assert set(td["timings"]) == set(jd["timings"])
    assert tviz_img.shape == jviz_img.shape == (120, 320, 3)


def post(port, fields=None, path="/find_matches", method="POST"):
    body, ctype = serve_cli.encode_multipart(fields or {})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body if method == "POST" else None,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_server_round_trip(pair_files, matchers):
    _, tm = matchers
    server = serve_cli.make_server(port=0, matcher=tm)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        data = [open(p, "rb").read() for p in pair_files[0]]
        fields = {"image0": data[0], "image1": data[1], "resize_enabled": b"0"}
        assert post(port, fields, "/elsewhere")[0] == 404
        assert post(port, {"image0": b"garbage", "image1": data[1]})[0] == 500
        status, headers, body = post(port, fields)
        assert status == 200 and headers["Content-Type"] == "image/png"
        details = json.loads(headers["X-Match-Details"])
        imgs = [image_io.imdecode(d) for d in data]
        viz, want = serve_cli.find_matches(tm, *imgs, resize_enabled=False)
        for key in ("keypoints0", "keypoints1", "matches"):
            assert details[key] == want[key], key
        np.testing.assert_array_equal(image_io.decode_png(body), viz)
        status, headers, page = post(port, method="GET", path="/")
        assert status == 200 and b"find_matches" in page
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_profiling_matches_jax(tmp_path, monkeypatch, capsys):
    """core/profiling.py: AverageTimer prints what JAX's prints on the same
    clock; Timer, device_trace, the peak-memory probe and the warm-up run."""
    import itertools

    from gims_tpu.core import profiling as jprof
    from gims_tpu_torch.core import profiling as tprof

    outs = []
    for mod in (jprof, tprof):
        clock = itertools.count(0.0, 0.25)
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        timer = mod.AverageTimer(newline=True)
        for _ in range(3):
            timer.update("detect")
            timer.update("match")
            timer.print("pair")
        outs.append(capsys.readouterr().out)
        monkeypatch.undo()
    assert outs[0] == outs[1] and "detect=0.250" in outs[1]
    with tprof.Timer("stage", quiet=True) as t:
        tprof.device_warmup(1)
    assert t.elapsed > 0 and tprof.time_synchronized() > 0
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert tprof.device_peak_memory_gb("cpu") == 0.0
