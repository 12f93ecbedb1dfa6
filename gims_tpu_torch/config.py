"""Configuration tree for the PyTorch port of GIMS.

The same frozen dataclasses, field names and defaults as the JAX package's
``gims_tpu/config.py``, and the same ``load_config`` reading of the
reference's YAML schema. The port keeps its own copy so that it never
imports the JAX package. Knobs whose implementation is not ported yet are
accepted here and refused by the code that would run them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AGCConfig:
    """Adaptive graph construction knobs.

    Reference defaults r=25, p=7, m=8; the published eval harness uses
    r=15, p=2, m=7 (passed per request as ``radius``/``percentile``/
    ``min_size``).
    """

    radius: float = 25.0
    percentile: float = 7.0
    min_size: int = 8
    delaunay: bool = False
    # cap on connected-component label-propagation rounds
    cc_rounds: int = 20
    # "exact" = k-th order statistic of all valid upper-triangle
    # similarities; "approx" = of every threshold_stride-th row
    threshold_impl: str = "exact"
    threshold_stride: int = 4
    # "dense" min-label propagation over (N, N); "sparse" over a
    # cc_degree neighbour list; "band" over the band build's band
    cc_impl: str = "dense"
    cc_degree: int = 32
    # "exact" closest-pair reconnect; "centroid" through the centroids
    reconnect_impl: str = "exact"
    reconnect_buckets: int = 4096
    # "dense" (N, N) build; "band" x-sorted band of band_halfwidth
    agc_impl: str = "dense"
    band_halfwidth: int = 512


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """GMatcher hyper-parameters (reference: models/gmatcher.py:166-176)."""

    descriptor_dim: int = 256
    keypoint_encoder: Tuple[int, ...] = (32, 64, 128, 256)
    num_gnn_layers: int = 18  # ['self','cross'] * 9
    sinkhorn_iterations: int = 100
    match_threshold: float = 0.2
    use_layernorm: bool = False
    input_dim: int = 256
    num_heads: int = 4
    sage_layers: int = 3
    pos_loss_weight: float = 0.45
    neg_loss_weight: float = 1.0
    neg_cells: str = "corner"
    # compute dtype of the attentional trunk ("float32" or "bfloat16")
    attention_dtype: str = "float32"
    # "auto"/"pallas": the hand-written attention kernel on a CUDA tensor;
    # "direct"/"flash": the plain PyTorch versions
    attention_impl: str = "auto"
    # run the Sinkhorn loop through the hand-written CUDA kernel
    use_pallas_sinkhorn: bool = False
    init_scheme: str = "default"
    remat: bool = False
    # "standard" centers/scales by the true (H, W); "gims" replicates the
    # reference's NHWC shape unpacking (see gmatcher.normalize_keypoints)
    normalization: str = "standard"
    # inference: run both sides through the trunk as one batch of 2B
    stack_sides: bool = True


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """SIFT + patch extraction (reference: utils/common.py:838-848)."""

    n_octave_layers: int = 3
    contrast_threshold: float = 0.001
    edge_threshold: float = 80.0
    sigma: float = 1.6
    max_keypoints: int = -1
    patch_size: int = 32
    warp_size: int = 64
    interpolation: str = "cubic"
    descriptor_source: str = "carhynet"
    sift_samples: int = 16
    sift_descriptor: str = "host"
    dense_dtype: str = "bfloat16"
    detector: str = "host"
    topk_impl: str = "exact"
    upsample: bool = True
    dense_layers: Tuple[int, ...] = (1, 2, 3)
    dense_first_map_oct: int = 0


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """COCO self-supervised homography dataset
    (reference: configs/coco_config.yaml:37-53)."""

    dataset_path: str = "./datasets/coco"
    apply_color_aug: bool = True
    image_height: int = 480
    image_width: int = 640
    resize_aspect: bool = False
    patch_ratio: float = 0.85
    perspective_x: float = 0.0
    perspective_y: float = 0.0
    shear_ratio: float = 0.04
    shear_angle: float = 10.0
    rotation_angle: float = 25.0
    scale: float = 0.6
    translation: float = 0.6


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Reference: configs/coco_config.yaml:29-35."""

    opt_type: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 5e-4
    warmup_epochs: int = 1
    step_epoch: int = 25
    step_value: float = 0.9440608762859234


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference: configs/coco_config.yaml:1-26."""

    output_dir: str = "output/train"
    experiment_name: str = "default"
    start_epoch: int = 0
    batch_size: int = 1
    num_epochs: int = 2
    num_workers: int = 0
    log_interval: int = 50
    val_images_count: int = 10
    use_ema: bool = False
    ema_decay: float = 0.9999
    init_seed: int = 10
    max_keypoints: int = 2048
    lastiter_every: int = 2000
    minloss_every: int = 200
    freeze_gmatcher_epochs: int = 0
    desc_loss_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class GIMSConfig:
    """Top-level config."""

    agc: AGCConfig = dataclasses.field(default_factory=AGCConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


# YAML 1.1's int and float forms as PyYAML's safe loader resolves them
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TRUE = ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")
_FALSE = ("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")
_NULL = ("", "~", "null", "Null", "NULL")


def _yaml_scalar(text: str):
    if text in _NULL:
        return None
    if text in _TRUE or text in _FALSE:
        return text in _TRUE
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    return text


def read_yaml(text: str):
    """The block mappings of scalars that the config files are written in,
    read as ``yaml.safe_load`` reads them (the GPU machine has no PyYAML).
    Sequences, flow collections, anchors and block scalars raise."""
    root: dict = {}
    stack = [(-1, root)]
    opened = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        body = line.strip()
        key, sep, value = body.partition(":")
        value = value.strip()
        if (not sep or body.startswith(("- ", "[", "{", "&", "*", "!"))
                or value[:1] in ("[", "{", "&", "*", "|", ">", "!")):
            raise ValueError(f"line {n}: {raw!r} is not a mapping of scalars")
        indent = len(line) - len(line.lstrip(" "))
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if value:
            parent[key.strip()] = _yaml_scalar(value)
        else:
            child: dict = {}
            parent[key.strip()] = child
            stack.append((indent, child))
            opened.append((parent, key.strip()))
    for parent, key in opened:  # "key:" with nothing under it is null
        if parent[key] == {}:
            parent[key] = None
    return root or None


def _update(dc, **kwargs):
    known = {f.name for f in dataclasses.fields(dc)}
    return dataclasses.replace(dc, **{k: v for k, v in kwargs.items() if k in known})


def _section(dc, raw: dict, keys):
    """Replace the fields of `dc` named in `keys` that `raw` sets."""
    return _update(dc, **{k: raw[k] for k in keys if k in raw})


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> GIMSConfig:
    """Load a GIMSConfig from a YAML file in the reference's schema
    (sections train_params / optimizer_params / dataset_params /
    frontend_params / agc), read by ``read_yaml``."""
    cfg = GIMSConfig()
    raw = {}
    if path is not None:
        with open(path, "r", encoding="utf-8") as f:
            raw = read_yaml(f.read()) or {}
    if overrides:
        raw = {**raw, **overrides}

    tp = raw.get("train_params", {})
    op = raw.get("optimizer_params", {})
    dp = raw.get("dataset_params", {})
    ap = dp.get("augmentation_params", {})
    fp = raw.get("frontend_params", {})
    ag = raw.get("agc", {})

    matcher = _section(cfg.matcher, tp, (
        "sinkhorn_iterations", "match_threshold", "use_layernorm",
        "pos_loss_weight", "neg_loss_weight", "neg_cells", "init_scheme",
        "remat", "attention_impl", "attention_dtype"))
    if "tf_layers" in tp:
        matcher = _update(matcher, num_gnn_layers=2 * tp["tf_layers"])
    train = _section(cfg.train, tp, (
        "output_dir", "experiment_name", "start_epoch", "batch_size",
        "num_epochs", "num_workers", "log_interval", "val_images_count",
        "use_ema", "init_seed", "max_keypoints", "lastiter_every",
        "minloss_every", "freeze_gmatcher_epochs", "desc_loss_weight"))
    frontend = _section(cfg.frontend, fp, (
        "descriptor_source", "detector", "dense_dtype", "interpolation",
        "warp_size", "max_keypoints", "upsample", "dense_first_map_oct"))
    if "dense_layers" in fp:
        frontend = _update(frontend, dense_layers=tuple(fp["dense_layers"]))
    optimizer = _section(cfg.optimizer, op, (
        "opt_type", "lr", "weight_decay", "warmup_epochs", "step_epoch",
        "step_value"))
    dataset = _section(cfg.dataset, dp, (
        "dataset_path", "apply_color_aug", "image_height", "image_width",
        "resize_aspect"))
    dataset = _section(dataset, ap, (
        "patch_ratio", "perspective_x", "perspective_y", "shear_ratio",
        "shear_angle", "rotation_angle", "scale", "translation"))
    agc = _section(cfg.agc, ag, (
        "radius", "percentile", "min_size", "delaunay", "agc_impl",
        "band_halfwidth", "threshold_impl", "reconnect_impl",
        "reconnect_buckets"))
    return GIMSConfig(
        agc=agc, matcher=matcher, frontend=frontend, dataset=dataset,
        optimizer=optimizer, train=train,
    )
