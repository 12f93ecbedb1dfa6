"""GMatcher, the graph-attentional matcher trunk.

Port of ``gims_tpu/matcher/gmatcher.py`` (reference: models/gmatcher.py:
165-307): GraphSAGE(graph features) + KeypointEncoder(normalized xy) ->
18-layer self/cross AttentionalGNN -> final projection -> scaled
inner-product scores -> log-domain Sinkhorn with dustbins. Shapes are
padded and masked; the AGC ``kept`` mask plays the role of the reference's
physical node removal.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from gims_tpu_torch.config import MatcherConfig
from gims_tpu_torch.matcher import sinkhorn
from gims_tpu_torch.matcher.layers import AttentionalGNN, GraphSAGE, KeypointEncoder

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normalize_keypoints(kpts, height: int, width: int, mode: str = "standard"):
    """Center and scale keypoints to about [-0.7, 0.7].

    mode="standard": center (W/2, H/2), scale 0.7*max(H, W).
    mode="gims": the reference as executed, whose NHWC batch unpacks as
    "height"=W and "width"=3: center (1.5, W/2), scale 0.7*W.
    """
    kpts = torch.as_tensor(kpts, dtype=torch.float32)
    if mode == "gims":
        h_eff, w_eff = float(width), 3.0
    else:
        h_eff, w_eff = float(height), float(width)
    # filled on the device by fill kernels: a tensor made from host values,
    # or one indexed and assigned a host scalar, is a copy that waits for
    # the stream. The scale is a device tensor too: CUDA divides by a host
    # scalar as a product with its reciprocal, another rounding than JAX's
    # division. f32(max) * f32(0.7) rounded to f32, as jnp computes it.
    center = torch.stack([kpts.new_full((), w_eff / 2.0), kpts.new_full((), h_eff / 2.0)])
    scaling = kpts.new_full((), float(np.float32(max(w_eff, h_eff)) * np.float32(0.7)))
    return (kpts - center) / scaling


class GMatcher(nn.Module):
    """Inputs are per-pair padded tensors; returns log-couplings and the
    projected descriptors. Extraction lives in pipeline.py."""

    def __init__(self, config: MatcherConfig = MatcherConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.attention_dtype not in _DTYPES:
            raise ValueError(f"attention_dtype {cfg.attention_dtype!r}")
        self.attn_dtype = _DTYPES[cfg.attention_dtype]
        d = cfg.descriptor_dim
        self.gnn_encoder = GraphSAGE(d, d // 2, d, cfg.sage_layers)
        self.kenc = KeypointEncoder(d, cfg.keypoint_encoder, cfg.use_layernorm)
        self.gnn = AttentionalGNN(
            d, ["self", "cross"] * (cfg.num_gnn_layers // 2), cfg.num_heads,
            cfg.use_layernorm, dtype=self.attn_dtype,
            attn_impl=cfg.attention_impl, stack_sides=cfg.stack_sides)
        self.final_proj = nn.Linear(d, d)
        if cfg.input_dim != d:
            self.input_proj = nn.Linear(cfg.input_dim, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def forward(self, kpts0n, desc0, adj0, kept0, kpts1n, desc1, adj1, kept1,
                train: bool = False):
        if train:
            raise NotImplementedError("GMatcher training is not ported yet; "
                                      "see ROADMAP.md")
        cfg = self.config
        attn_dtype = self.attn_dtype
        stack = (cfg.stack_sides and desc0.shape == desc1.shape
                 and kpts0n.shape == kpts1n.shape)

        # Zero pruned/padded tokens first: padding keypoints sit at 1e6,
        # whose activations grow without bound over the residual layers and
        # leak NaN into valid rows through 0 * inf in p @ v. Masked tokens
        # are excluded everywhere downstream, so zeroing them changes
        # nothing else.
        kpts0n = torch.where(kept0[..., None], kpts0n, 0.0)
        kpts1n = torch.where(kept1[..., None], kpts1n, 0.0)
        desc0 = torch.where(kept0[..., None], desc0, 0.0)
        desc1 = torch.where(kept1[..., None], desc1, 0.0)
        project = cfg.input_dim != cfg.descriptor_dim

        # record_function ranges name the stages in a profiler trace
        # (scripts/profile_torch_matching.py)
        if stack:
            bsz = desc0.shape[0]
            with record_function("gims.encoder"):
                desc = torch.cat([desc0, desc1], dim=0)
                if project:
                    desc = self.input_proj(desc)
                d = (self.gnn_encoder(desc, torch.cat([adj0, adj1], dim=0))
                     + self.kenc(torch.cat([kpts0n, kpts1n], dim=0),
                                 torch.cat([kept0, kept1], dim=0)))
            with record_function("gims.trunk"):
                d0, d1 = self.gnn(d[:bsz].to(attn_dtype), d[bsz:].to(attn_dtype),
                                  kept0, kept1)
            md = self.final_proj(torch.cat([d0, d1], dim=0).float())
            mdesc0, mdesc1 = md[:bsz], md[bsz:]
        else:
            with record_function("gims.encoder"):
                if project:
                    desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)
                d0 = self.gnn_encoder(desc0, adj0) + self.kenc(kpts0n, kept0)
                d1 = self.gnn_encoder(desc1, adj1) + self.kenc(kpts1n, kept1)
            with record_function("gims.trunk"):
                d0, d1 = self.gnn(d0.to(attn_dtype), d1.to(attn_dtype), kept0, kept1)
            mdesc0 = self.final_proj(d0.float())
            mdesc1 = self.final_proj(d1.float())

        scores = torch.einsum("bnc,bmc->bnm", mdesc0, mdesc1) / (
            float(cfg.descriptor_dim) ** 0.5)
        with record_function("gims.sinkhorn"):
            if cfg.use_pallas_sinkhorn:
                from gims_tpu_torch.matcher.cuda_sinkhorn import log_optimal_transport_cuda

                Z = log_optimal_transport_cuda(
                    scores, self.bin_score, cfg.sinkhorn_iterations, kept0, kept1)
            else:
                Z = sinkhorn.log_optimal_transport(
                    scores, self.bin_score, cfg.sinkhorn_iterations, kept0, kept1)
        return {"Z": Z, "mdesc0": mdesc0, "mdesc1": mdesc1, "scores": scores}
