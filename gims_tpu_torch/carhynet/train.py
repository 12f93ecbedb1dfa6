"""CAR-HyNet descriptor training on patch-pair datasets, in PyTorch.

Port of ``gims_tpu/carhynet/train.py`` (reference data plumbing:
carhynet/util.py:193-391): a UBC-montage loader, the patch augmentation, a
synthetic patch-pair source, and the training step with the hybrid HyNet
loss and Adam (``optax.adam``: b1 0.9, b2 0.999, eps 1e-8, no weight
decay). OpenCV's reads, resizes and warps are the port's own
(``core/image_io.py``, ``core/imgproc.py``). The network trains in flax's
train mode (``carhynet/model.py``): batch statistics, running statistics
moved by the left then the right half, dropout from a ``torch.Generator``.
Runs on ``cuda`` unless the caller names another device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gims_tpu_torch.carhynet.convert import module_variables
from gims_tpu_torch.carhynet.loss import hynet_loss
from gims_tpu_torch.carhynet.model import CARHyNet
from gims_tpu_torch.core import image_io, imgproc
from gims_tpu_torch.core.device import resolve_device


def read_ubc_montages(root: str, sz_patch: int = 32, color: bool = True,
                      patch_raw: int = 64):
    """Read a UBC-format patch set: sorted .bmp montages of 64x64 patches
    (row-major) and info.txt, whose first column is the 3D point id.

    Returns (patches (N, sz, sz, C) float32 / 255, point_ids (N,))."""
    patches = []
    for name in sorted(os.listdir(root)):
        if not name.endswith(".bmp"):
            continue
        flag = image_io.IMREAD_COLOR if color else image_io.IMREAD_GRAYSCALE
        img = image_io.imread(os.path.join(root, name), flag)
        for r in range(img.shape[0] // patch_raw):
            for c in range(img.shape[1] // patch_raw):
                p = img[r * patch_raw:(r + 1) * patch_raw, c * patch_raw:(c + 1) * patch_raw]
                if sz_patch != patch_raw:
                    p = imgproc.resize(p, (sz_patch, sz_patch))
                patches.append(p)
    info = os.path.join(root, "info.txt")
    ids = []
    if os.path.exists(info):
        with open(info) as f:
            ids = [int(line.split()[0]) for line in f if line.strip()]
    patches = np.asarray(patches, np.float32) / 255.0
    ids = np.asarray(ids[: len(patches)], np.int64)
    patches = patches[: len(ids)] if len(ids) else patches
    if patches.ndim == 3:
        patches = patches[..., None]
    return patches, ids


def sample_pairs(patches, point_ids, n_points, rng):
    """Pick n_points distinct 3D points and two patches of each
    (the reference's per-batch structure: diagonal = positive pairs)."""
    _, inverse, counts = np.unique(point_ids, return_inverse=True, return_counts=True)
    multi = np.nonzero(counts >= 2)[0]
    chosen = rng.choice(multi, size=n_points, replace=len(multi) < n_points)
    left, right = [], []
    for u in chosen:
        idxs = np.nonzero(inverse == u)[0]
        a, b = rng.choice(idxs, size=2, replace=len(idxs) < 2)
        left.append(a)
        right.append(b)
    return patches[left], patches[right]


def augment_patches(batch, rng):
    """Random 90-degree rotations and flips (reference capability:
    carhynet/util.py data_aug)."""
    out = batch.copy()
    for i in range(len(out)):
        out[i] = np.rot90(out[i], rng.randint(4))
        if rng.rand() < 0.5:
            out[i] = out[i][:, ::-1]
    return np.ascontiguousarray(out)


class SyntheticPatchPairs:
    """Stand-in patch-pair source: warped crops of procedural texture."""

    def __init__(self, n_points=20000, sz=32, seed=0):
        rng = np.random.RandomState(seed)
        tex = rng.randint(0, 255, (128, 128, 3)).astype(np.uint8)
        self.canvas = imgproc.resize(tex, (1024, 1024), imgproc.INTER_CUBIC)
        self.sz = sz
        self.n_points = n_points
        self.rng = rng

    def batch(self, n):
        sz = self.sz
        left = np.empty((n, sz, sz, 3), np.float32)
        right = np.empty((n, sz, sz, 3), np.float32)
        for i in range(n):
            x = self.rng.randint(0, 1024 - 2 * sz)
            y = self.rng.randint(0, 1024 - 2 * sz)
            crop = self.canvas[y:y + 2 * sz, x:x + 2 * sz].astype(np.float32)
            left[i] = imgproc.resize(crop, (sz, sz)) / 255.0
            ang = self.rng.uniform(-25, 25)
            m = imgproc.get_rotation_matrix_2d((sz, sz), ang, self.rng.uniform(0.9, 1.1))
            warped = imgproc.warp_affine(crop, m, (2 * sz, 2 * sz))
            right[i] = imgproc.resize(warped, (sz, sz)) / 255.0
            right[i] += self.rng.randn(sz, sz, 3) * 0.02
        return left, np.clip(right, 0, 1)


class Adam:
    """``optax.adam(lr)`` over a dict of tensors keyed by parameter name:
    ``init(params)`` and ``update(grads, state) -> (updates, state)``; the
    bias corrections 1 - b^t in float32, as optax computes them."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]):
        return {"count": 0,
                "mu": {n: torch.zeros_like(p).detach() for n, p in params.items()},
                "nu": {n: torch.zeros_like(p).detach() for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state):
        names = list(grads)
        g = [grads[n] for n in names]
        mu = torch._foreach_mul([state["mu"][n] for n in names], self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        nu = torch._foreach_mul([state["nu"][n] for n in names], self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        t = state["count"] + 1
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        return dict(zip(names, upd)), {"count": t, "mu": dict(zip(names, mu)),
                                       "nu": dict(zip(names, nu))}


def _nchw(x, device):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device, torch.float32).permute(0, 3, 1, 2)


def make_descriptor_train_step(model: CARHyNet, tx: Adam, margin=1.2, alpha=2.0,
                               is_sosr=True, knn_sos=8):
    """step(opt_state, left, right, generator) -> (opt_state, loss, d_pos,
    d_neg): one Adam step of `model` (in place) on (N, sz, sz, C) patch
    pairs. The left half runs first, then the right, each moving the
    running statistics, as the JAX step threads its batch_stats."""
    def step(opt_state, left, right, generator: Optional[torch.Generator] = None):
        dev = next(model.parameters()).device
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        dl, rl = model(_nchw(left, dev), train=True, generator=generator)
        dr, rr = model(_nchw(right, dev), train=True, generator=generator)
        loss, dp, dn = hynet_loss(dl, dr, rl, rr, margin, alpha, is_sosr, knn_sos)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        upd, opt_state = tx.update(grads, opt_state)
        with torch.no_grad():
            torch._foreach_add_([params[n] for n in upd], list(upd.values()))
        return opt_state, loss.detach(), dp, dn

    return step


def train_descriptor(data_root: Optional[str] = None, steps: int = 1000,
                     batch_points: int = 256, lr: float = 1e-3, seed: int = 0,
                     log_every: int = 50, log_fn=print, device=None):
    """Train CAR-HyNet, on UBC montages when data_root is given, else on
    synthetic pairs. Returns the JAX layout's variables tree (params and
    batch_stats, numpy), as the JAX package's ``train_descriptor``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CARHyNet().to(dev)
    tx = Adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))
    step = make_descriptor_train_step(model, tx)
    if data_root:
        patches, ids = read_ubc_montages(data_root)

        def source(n):
            return sample_pairs(patches, ids, n, rng)
    else:
        source = SyntheticPatchPairs(seed=seed).batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for it in range(steps):
        left, right = source(batch_points)
        left = augment_patches(left, rng)
        right = augment_patches(right, rng)
        opt_state, loss, dp, dn = step(opt_state, left, right, gen)
        if (it + 1) % log_every == 0 or it == 0:
            log_fn(f"[{it}] loss={float(loss):.2f} d_pos={float(dp):.3f} "
                   f"d_neg={float(dn):.3f}")
    return module_variables(model)
