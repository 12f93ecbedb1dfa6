"""Building blocks of the GMatcher trunk.

Port of ``gims_tpu/matcher/layers.py``. Layout is tokens, then channels:
(B, N, C) at every public function, as in the JAX package. Submodules carry
the flax module names (``dense_0``, ``norm_0``, ``proj_q``, ``layer_3``...),
so a JAX variables tree maps onto ``state_dict`` keys by path
(``matcher/convert.py``). Linear layers are ``Dense``: they compute in
``dtype``, the compute dtype of the matmuls, as flax ``Dense(dtype=...)``
does. For inference their parameters are held in that dtype (cast once, at
load); for training (``param_dtype=torch.float32``) they stay f32 and are
cast on every use, as flax casts its f32 parameters. Normalization
statistics always run in f32.

Training's batch statistics: ``MaskedBatchNorm`` in train mode normalizes
by the masked batch statistics, and, inside ``batch_stat_updates()``,
records the running-statistics update instead of writing its buffers, as
flax returns its ``batch_stats`` collection as ``updates``. A second call
of the same module in one forward (the other side of the pair) updates
from the first call's result, in call order, as flax does. A forward that
``torch.utils.checkpoint`` runs again in the backward runs outside the
block and records nothing, so each update is taken once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gims_tpu_torch.matcher.attention import masked_attention
from gims_tpu_torch.train import multihost

# the record of this thread's open batch_stat_updates() block (like torch's
# grad mode, per thread)
_local = threading.local()


@contextlib.contextmanager
def batch_stat_updates():
    """Collect the running-statistics updates of the train-mode
    ``MaskedBatchNorm`` calls this thread makes within the block: yields a
    dict that maps each module to its (running_mean, running_var) after the
    block's calls, detached. The buffers themselves are left as they are."""
    outer = getattr(_local, "updates", None)
    _local.updates = {}
    try:
        yield _local.updates
    finally:
        _local.updates = outer


class Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: computes in `dtype`; the parameters are
    held in `param_dtype` (by default `dtype`) and cast to `dtype` at use."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (batch, tokens) with a validity mask.

    Parity with torch.nn.BatchNorm1d as the JAX package has it: biased
    variance for normalization, unbiased variance in the running buffer,
    momentum 0.1, eps 1e-5; padded tokens add nothing to the statistics.
    At eval it reads the running statistics."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            # x (B, N, C), mask (B, N)
            w = mask[..., None].to(x.dtype)
            cnt = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(dim=(0, 1)) / cnt
            var = (torch.square(x - mean) * w).sum(dim=(0, 1)) / cnt
            updates = getattr(_local, "updates", None)
            if updates is not None:
                # from detached values: a checkpointed recomputation saves
                # exactly what the first forward saved
                ra_mean, ra_var = updates.get(self, (self.running_mean, self.running_var))
                mean_d, var_d, cnt_d = mean.detach(), var.detach(), cnt.detach()
                unbiased = var_d * cnt_d / torch.clamp(cnt_d - 1.0, min=1.0)
                m = self.momentum
                updates[self] = ((1 - m) * ra_mean + m * mean_d,
                                 (1 - m) * ra_var + m * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class ChannelLayerNorm(nn.Module):
    """The reference's custom LayerNorm (reference: models/gmatcher.py:74-85)
    over the channel axis: unbiased std, eps added to the std."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(features))
        self.b_2 = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask=None, train: bool = False):
        mean = x.mean(dim=-1, keepdim=True)
        n = x.shape[-1]
        var = torch.square(x - mean).sum(dim=-1, keepdim=True) / max(n - 1, 1)
        std = torch.sqrt(var + 1e-20)
        return self.a_2 * ((x - mean) / (std + self.eps)) + self.b_2


class MLP1d(nn.Module):
    """Per-token MLP: [Dense -> Norm -> ReLU]* -> Dense
    (reference: models/gmatcher.py:11-24)."""

    def __init__(self, in_features: int, channels: Sequence[int],
                 use_layernorm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n = len(channels)
        prev = in_features
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", Dense(prev, ch, dtype=dtype, param_dtype=param_dtype))
            if i < self.n - 1:
                norm = ChannelLayerNorm(ch) if use_layernorm else MaskedBatchNorm(ch)
                self.add_module(f"norm_{i}", norm)
            prev = ch

    def forward(self, x, mask, train: bool = False):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x.to(self.dtype))
            if i < self.n - 1:
                xf = getattr(self, f"norm_{i}")(x.float(), mask, train)
                x = torch.relu(xf).to(self.dtype)
        return x


class KeypointEncoder(nn.Module):
    """MLP over normalized keypoint xy -> feature_dim positional code
    (reference: models/gmatcher.py:87-97, scores not encoded)."""

    def __init__(self, feature_dim: int, layers: Sequence[int],
                 use_layernorm: bool = False):
        super().__init__()
        self.encoder = MLP1d(2, list(layers) + [feature_dim], use_layernorm)

    def forward(self, kpts, mask, train: bool = False):
        return self.encoder(kpts, mask, train)


class MultiHeadedAttention(nn.Module):
    """Reference: models/gmatcher.py:99-114.

    The reference's head interleave is channel c = d*H + h. The port holds
    the q/k/v projection rows (and the merge columns) in head-major order,
    permuted once at load (``convert.head_major_perm``), so q, k and v come
    out as contiguous (B, N, H, D) with the same values and the attention
    kernel reads them with unit stride along D.
    """

    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.d_model = d_model
        self.dtype = dtype
        self.attn_impl = attn_impl
        for name in ("proj_q", "proj_k", "proj_v", "merge"):
            self.add_module(name, Dense(d_model, d_model, dtype=dtype, param_dtype=param_dtype))

    def _heads(self, layer: Dense, x: torch.Tensor) -> torch.Tensor:
        y = layer(x.to(self.dtype))
        return y.view(x.shape[0], x.shape[1], self.num_heads, -1)

    def forward(self, query, key, value, key_mask):
        q = self._heads(self.proj_q, query)
        k = self._heads(self.proj_k, key)
        v = self._heads(self.proj_v, value)
        x = masked_attention(q, k, v, key_mask, impl=self.attn_impl)
        return self.merge(x.reshape(x.shape[0], x.shape[1], self.d_model))


class AttentionalPropagation(nn.Module):
    """Reference: models/gmatcher.py:116-125."""

    def __init__(self, feature_dim: int, num_heads: int,
                 use_layernorm: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, feature_dim, dtype, attn_impl, param_dtype)
        self.mlp = MLP1d(2 * feature_dim, [2 * feature_dim, feature_dim],
                         use_layernorm, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x, source, x_mask, source_mask, train: bool = False):
        message = self.attn(x, source, source, source_mask)
        return self.mlp(torch.cat([x, message], dim=-1), x_mask, train)


class AttentionalGNN(nn.Module):
    """Alternating self/cross attention stack
    (reference: models/gmatcher.py:127-143).

    remat: in training, each layer's call runs under
    ``torch.utils.checkpoint`` (flax ``nn.remat``), so the backward
    recomputes its attention instead of keeping the (B, H, N, M) softmax."""

    def __init__(self, feature_dim: int, layer_names: Sequence[str],
                 num_heads: int = 4, use_layernorm: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 stack_sides: bool = True, remat: bool = False,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_names = list(layer_names)
        self.stack_sides = stack_sides
        self.remat = remat
        for i in range(len(self.layer_names)):
            self.add_module(f"layer_{i}", AttentionalPropagation(
                feature_dim, num_heads, use_layernorm, dtype, attn_impl, param_dtype))

    def _call(self, layer, x, src, x_mask, src_mask, train):
        if self.remat and train and torch.is_grad_enabled():
            return checkpoint(layer, x, src, x_mask, src_mask, train, use_reentrant=False)
        return layer(x, src, x_mask, src_mask, train)

    def forward(self, desc0, desc1, mask0, mask1, train: bool = False):
        layers = [getattr(self, f"layer_{i}") for i in range(len(self.layer_names))]
        if self.stack_sides and not train and desc0.shape == desc1.shape:
            # both sides as one batch of 2B; equal to the per-side loop at
            # eval (normalization reads running statistics)
            b = desc0.shape[0]
            x = torch.cat([desc0, desc1], dim=0)
            masks = torch.cat([mask0, mask1], dim=0)
            masks_sw = torch.cat([mask1, mask0], dim=0)
            for layer, name in zip(layers, self.layer_names):
                if name == "cross":
                    src, sm = torch.cat([x[b:], x[:b]], dim=0), masks_sw
                else:
                    src, sm = x, masks
                x = x + layer(x, src, masks, sm, train).to(x.dtype)
            return x[:b], x[b:]
        for layer, name in zip(layers, self.layer_names):
            if name == "cross":
                src0, src1, sm0, sm1 = desc1, desc0, mask1, mask0
            else:
                src0, src1, sm0, sm1 = desc0, desc1, mask0, mask1
            delta0 = self._call(layer, desc0, src0, mask0, sm0, train)
            delta1 = self._call(layer, desc1, src1, mask1, sm1, train)
            desc0 = desc0 + delta0.to(desc0.dtype)
            desc1 = desc1 + delta1.to(desc1.dtype)
        return desc0, desc1


class SAGEConv(nn.Module):
    """DGL-style GraphSAGE mean aggregation on a dense adjacency:
    fc_self(h) + fc_neigh(mean_{j in N(i)} h_j) + bias; zero-degree nodes
    aggregate zero (reference: models/gmatcher.py:145-162)."""

    def __init__(self, in_feats: int, out_feats: int):
        super().__init__()
        self.fc_self = nn.Linear(in_feats, out_feats, bias=False)
        self.fc_neigh = nn.Linear(in_feats, out_feats, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_feats))

    def forward(self, h, adj, mask=None, group=None):
        """h (B, N, C) whole. With a ``torch.distributed`` `group` of P ranks
        (keypoint sharding, ``matcher/sharded.py``), adj is this rank's rows
        (B, N/P, N): the rank aggregates its rows, and the rows of every
        rank are all-gathered, so each rank returns the whole (B, N, out)."""
        a = adj.to(h.dtype)
        deg = a.sum(dim=-1, keepdim=True)
        neigh = torch.matmul(a, h) / torch.clamp(deg, min=1.0)
        if group is None:
            return self.fc_self(h) + self.fc_neigh(neigh) + self.bias
        r0 = multihost.rank(group) * adj.shape[1]
        mine = self.fc_self(h[:, r0:r0 + adj.shape[1]]) + self.fc_neigh(neigh) + self.bias
        return multihost.all_gather_cat(mine, 1, group)


class GraphSAGE(nn.Module):
    """SAGE encoder 256 -> 128 -> 128 -> 256 with ReLU between layers
    (reference: models/gmatcher.py:145-162, built at 192-197)."""

    def __init__(self, in_feats: int, hidden_feats: int, out_feats: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [hidden_feats] * (num_layers - 1) + [out_feats]
        self.num_layers = len(dims)
        prev = in_feats
        for i, d in enumerate(dims):
            self.add_module(f"layer_{i}", SAGEConv(prev, d))
            prev = d

    def forward(self, h, adj, mask=None, group=None):
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, adj, mask, group)
            if i != self.num_layers - 1:
                h = torch.relu(h)
        return h
