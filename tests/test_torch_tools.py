"""The port's tools (``gims_tpu_torch/tools``) against the JAX package's
(``gims_tpu/tools``), on the cases of ``tests/test_tools.py:30-107``, on the
CPU.

- ``parameter_search``: both packages' ``search`` on the same PNG pair and
  parameter rows, each with a 4-layer matcher of the same weights (a flax
  identity init, carried to the port) behind the device detector and SIFT
  descriptors: the rows' parameters and total matches equal, the inlier
  counts within the USAC bar of ``tests/test_torch_usac.py``
  (max(3, 2%): the port's USAC draws other samples than OpenCV's);
  ``record.txt`` has JAX's lines up to the counts and times, ``record.csv``
  JAX's header (the CSV fallback JAX writes without openpyxl).
- ``image_viewer``: ``compose_grid`` equal to JAX's to the byte (INTER_LINEAR
  resizes and the label at fontScale 0.7, thickness 2), and the headless
  run writing the same pixels.
- ``parameter_visualize``: ``render_interactive`` writes JAX's file to the
  byte; ``render_report``'s section titles in JAX's order, and the numbers
  behind its plots (each heatmap's grid, read from JAX's ``imshow``, and
  each axis' means, from JAX's ``plot``) equal; ``load_records`` reads
  ``.csv`` as ``.txt`` and refuses ``.xlsx`` naming ROADMAP.md.
"""

import os
import re

import cv2
import jax
import numpy as np
import pytest

from gims_tpu.api import Matching as JMatching
from gims_tpu.api import init_gmatcher_variables
from gims_tpu.config import AGCConfig as JAGCConfig
from gims_tpu.config import FrontendConfig as JFrontendConfig
from gims_tpu.config import GIMSConfig as JGIMSConfig
from gims_tpu.config import MatcherConfig as JMatcherConfig
from gims_tpu.tools import image_viewer as jviewer
from gims_tpu.tools import parameter_search as jsearch
from gims_tpu.tools import parameter_visualize as jvis
from gims_tpu_torch.api import Matching
from gims_tpu_torch.config import AGCConfig, FrontendConfig, GIMSConfig, MatcherConfig
from gims_tpu_torch.tools import image_viewer, parameter_search, parameter_visualize
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

FRONTEND = dict(detector="device", descriptor_source="sift", sift_descriptor="device",
                max_keypoints=256)


def synthetic_image(h=120, w=160, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h // 4, w // 4, 3), np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    return cv2.GaussianBlur(img, (0, 0), 1.0)


@pytest.fixture(scope="module")
def matchers():
    mcfg = dict(sinkhorn_iterations=5, match_threshold=0.02, num_gnn_layers=4)
    agc = dict(radius=30.0, percentile=5.0, min_size=3)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: init_gmatcher_variables(JMatcherConfig(**mcfg), seed=0,
                                                          scheme="identity"))())
    jm = JMatching(JGIMSConfig(matcher=JMatcherConfig(**mcfg), agc=JAGCConfig(**agc),
                               frontend=JFrontendConfig(**FRONTEND)),
                   variables=jax.tree_util.tree_map(jax.numpy.asarray, variables))
    tm = Matching(GIMSConfig(matcher=MatcherConfig(**mcfg), agc=AGCConfig(**agc),
                             frontend=FrontendConfig(**FRONTEND)),
                  variables=variables, device="cpu")
    return jm, tm


def test_parameter_search_rows_equal_jax(tmp_path, matchers):
    img0 = synthetic_image(seed=1)
    H = np.array([[1.0, 0.02, 4.0], [-0.01, 1.0, -3.0], [0, 0, 1.0]], np.float32)
    img1 = cv2.warpPerspective(img0, H, (160, 120))
    p0, p1 = tmp_path / "a.png", tmp_path / "b.png"
    cv2.imwrite(str(p0), img0)
    cv2.imwrite(str(p1), img1)
    params = [[30, 5, 3], [40, 5, 2], [20, 2, 1]]
    want = jsearch.search(str(p0), str(p1), params, None, str(tmp_path / "jout"),
                          matcher=matchers[0])
    got = parameter_search.search(str(p0), str(p1), params, None, str(tmp_path / "out"),
                                  matcher=matchers[1])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == 6 and g[:3] == w[:3] and g[4] == w[4] and g[4] > 0
        assert abs(g[3] - w[3]) <= max(3, 0.02 * w[3])
    rec = tmp_path / "out" / "a_b"
    lines = (rec / "record.txt").read_text().splitlines()
    jlines = (tmp_path / "jout" / "a_b" / "record.txt").read_text().splitlines()
    assert len(lines) == len(jlines) == 3
    assert [l.rsplit(",", 3)[0] for l in lines] == [l.rsplit(",", 3)[0] for l in jlines]
    csv_lines = (rec / "record.csv").read_text().splitlines()
    assert csv_lines[0] == "r,t,m,correct_matches,total_matches,time" and len(csv_lines) == 4
    jcsv = tmp_path / "jout" / "a_b" / "record.csv"
    if jcsv.exists():
        assert jcsv.read_text().splitlines()[0] == csv_lines[0]
    assert parameter_visualize.load_records(rec / "record.csv")[:, :5].tolist() == \
        parameter_visualize.load_records(rec / "record.txt")[:, :5].tolist()


def _records(path):
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for r in range(10, 13):
            for t in range(0, 3):
                for m in range(0, 3):
                    f.write(f"[{r}, {t}, {m}, {rng.randint(100)}, 500, {rng.rand():.3f}]\n")
    return path


def test_render_interactive_equals_jax(tmp_path):
    rec = _records(tmp_path / "record.txt")
    for password in ("pw", None):
        want = jvis.render_interactive([str(rec)], str(tmp_path / "j.html"), password=password)
        got = parameter_visualize.render_interactive([str(rec)], str(tmp_path / "t.html"),
                                                     password=password)
        assert open(got, "rb").read() == open(want, "rb").read()
    np.testing.assert_array_equal(parameter_visualize.load_records(rec), jvis.load_records(rec))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parameter_visualize.load_records(tmp_path / "record.xlsx")


def test_render_report_sections_and_numbers_equal_jax(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.axes import Axes

    rec = _records(tmp_path / "record.txt")
    grids, plots = [], []
    imshow, plot = Axes.imshow, Axes.plot
    monkeypatch.setattr(Axes, "imshow", lambda self, X, *a, **k: (
        grids.append(np.array(X)), imshow(self, X, *a, **k))[1])
    monkeypatch.setattr(Axes, "plot", lambda self, *a, **k: (
        plots.append([list(map(float, a[0])), list(map(float, a[1]))]), plot(self, *a, **k))[1])
    want = open(jvis.render_report([str(rec)], str(tmp_path / "j.html"))).read()
    got = open(parameter_visualize.render_report([str(rec)], str(tmp_path / "t.html"))).read()
    titles = re.compile(r"<h[123]>(.*?)</h[123]>")
    assert titles.findall(got) == titles.findall(want)
    assert got.count("data:image/png;base64,") == want.count("data:image/png;base64,") == 6
    records = parameter_visualize.load_records(rec)
    ours = []
    for axis in (0, 1, 2):
        vals = np.unique(records[:, axis])
        ours.append(parameter_visualize.heatmap_grid(records, axis, vals[len(vals) // 2])[3])
    assert len(grids) == 3
    for g, w in zip(ours, grids):
        np.testing.assert_array_equal(g, w)
    means = [[list(map(float, v)), list(map(float, c))] for v, c, t in
             parameter_visualize.axis_means(records)]
    times = [[list(map(float, v)), list(map(float, t))] for v, c, t in
             parameter_visualize.axis_means(records)]
    assert plots == [x for pair in zip(means, times) for x in pair]


def test_image_viewer_grid_equals_jax(tmp_path):
    for folder, seed in (("f1", 11), ("f2", 12), ("run_A", 13)):
        os.makedirs(tmp_path / folder)
        cv2.imwrite(str(tmp_path / folder / "x.png"), synthetic_image(seed=seed))
        cv2.imwrite(str(tmp_path / folder / "big.png"),
                    synthetic_image(h=600, w=800, seed=seed))
    folders = [str(tmp_path / f) for f in ("f1", "f2", "run_A")]
    assert image_viewer.list_common_images(folders) == jviewer.list_common_images(folders)
    for name in ("x.png", "big.png"):
        got = image_viewer.compose_grid(folders, name)
        want = jviewer.compose_grid(folders, name)
        assert got.shape == want.shape == (720, 960, 3)
        assert got.tobytes() == want.tobytes()
    image_viewer.run_headless(folders[:2], str(tmp_path / "out"))
    jviewer.run_headless(folders[:2], str(tmp_path / "jout"))
    for name in ("x.png", "big.png"):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "out" / name)),
                                      cv2.imread(str(tmp_path / "jout" / name)))
