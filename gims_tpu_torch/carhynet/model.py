"""CAR-HyNet descriptor CNN as torch modules (NCHW).

Port of ``gims_tpu/carhynet/model.py`` (reference: carhynet/models.py:
311-399): FRN/TLU filter response normalization, coordinate attention and
sand-glass residual blocks, over 32x32 patches or, with ``dense=True``,
fully convolutionally over whole images: a stride-4 map of L2-normalized
128-d descriptors. Submodules carry the flax module names, so a flax leaf's
path is its ``state_dict`` key (``carhynet/convert.py``).

Padding follows the flax model: symmetric ((k-1)//2 on every side) for the
3x3 convolutions, and (3, 4) on each spatial axis for the dense 8x8 head,
which ``padding=`` cannot express, so it is an explicit ``F.pad``. The
statistics of FRN and CoordAtt are per sample and channel over the whole
map, accumulated in f32 when the network runs in bf16.

``forward(x, train=True, generator=...)`` is flax's ``apply(..., train=True,
mutable=["batch_stats"])``: every BatchNorm normalizes by the batch's mean and
its variance E[x^2] - E[x]^2 (clipped at 0, flax's fast variance) and moves
its running statistics by momentum 0.9 (biased variance, as flax keeps it),
in place, in the order the forward reaches them; the dropout before the
head keeps each value with probability 1 - drop_rate, drawn from the
caller's ``torch.Generator``, and scales the kept ones by 1 / (1 -
drop_rate). It returns (descriptors, raw head outputs), as flax's train
mode does. Without ``train`` the module is the inference network, whatever
``nn.Module.training`` says.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

EPS_L2_NORM = 1e-10  # reference carhynet/util.py:10


def _chan(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) parameter as (1, C, 1, 1) in x's dtype."""
    return p.to(x.dtype).view(1, -1, 1, 1)


class FRN(nn.Module):
    """Filter response normalization (reference: carhynet/models.py:23-82)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x):
        nu2 = x.square().mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
        x = x * torch.rsqrt(nu2 + abs(self.eps)).to(x.dtype)
        return _chan(self.weight, x) * x + _chan(self.bias, x)


class TLU(nn.Module):
    """Thresholded linear unit: max(x, tau)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.tau = nn.Parameter(torch.full((num_features,), -1.0))

    def forward(self, x):
        return torch.maximum(x, _chan(self.tau, x))


class BatchNorm(nn.Module):
    """Batch norm with flax's arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias; the running statistics
    in inference, the batch's (and a running update) with ``train``."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, train: bool = False):
        mean, var = self.running_mean, self.running_var
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - _chan(mean, x)) * _chan(mul, x)
        if self.bias is not None:
            y = y + _chan(self.bias, x)
        return y


def h_swish(x):
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


def _conv(cin, cout, kernel, stride=1, groups=1, bias=False):
    """Conv with symmetric padding (k-1)//2, as the flax model's ``_conv``."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                     groups=groups, bias=bias)


class CoordAtt(nn.Module):
    """Coordinate attention (reference: carhynet/models.py:127-153): pools
    over W and over H, mixes through a shared 1x1 bottleneck, and gates
    the input with per-row and per-column sigmoids."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = nn.Conv2d(inp, mip, 1, bias=True)
        self.bn1 = BatchNorm(mip)
        self.conv_h = nn.Conv2d(mip, oup, 1, bias=True)
        self.conv_w = nn.Conv2d(mip, oup, 1, bias=True)

    def forward(self, x, train: bool = False):
        h = x.shape[2]
        x_h = x.mean(dim=3, keepdim=True, dtype=torch.float32).to(x.dtype)  # (B, C, H, 1)
        x_w = x.mean(dim=2, keepdim=True, dtype=torch.float32).to(x.dtype)  # (B, C, 1, W)
        y = torch.cat([x_h, x_w.transpose(2, 3)], dim=2)       # (B, C, H+W, 1)
        y = h_swish(self.bn1(self.conv1(y), train))
        y_h, y_w = y[:, :, :h], y[:, :, h:].transpose(2, 3)
        a_h = torch.sigmoid(self.conv_h(y_h))
        a_w = torch.sigmoid(self.conv_w(y_w))
        return x * a_w * a_h


class ConvBNReLU6(nn.Module):
    """conv (no bias) + BN + ReLU6 (reference: carhynet/models.py:172-180)."""

    def __init__(self, cin, cout, kernel=3, stride=1, groups=1):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, groups)
        self.bn = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        return torch.clamp(self.bn(self.conv(x), train), 0.0, 6.0)


def _make_divisible(v, divisor, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SandGlass(nn.Module):
    """Inverted sand-glass residual block as CAR-HyNet uses it: stride 1,
    inp == oup, expand ratio 6, identity residual (reference:
    carhynet/models.py:182-235)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expand_ratio: int = 6):
        super().__init__()
        if stride != 1 or inp != oup:
            raise NotImplementedError("CAR-HyNet uses SandGlass at stride 1 "
                                      "with inp == oup only")
        hidden = inp // expand_ratio
        if hidden < oup / 6.0:
            hidden = _make_divisible(math.ceil(oup / 6.0), 16)
        self.dw1 = ConvBNReLU6(inp, inp, 3, 1, groups=inp)
        self.coord = CoordAtt(inp, inp)
        self.pw_reduce = _conv(inp, hidden, 1)
        self.pw_reduce_bn = BatchNorm(hidden)
        self.pw_expand = ConvBNReLU6(hidden, oup, 1)
        self.dw2 = _conv(oup, oup, 3, stride, groups=oup)
        self.dw2_bn = BatchNorm(oup)

    def forward(self, x, train: bool = False):
        out = self.coord(self.dw1(x, train), train)
        out = self.pw_expand(self.pw_reduce_bn(self.pw_reduce(out), train), train)
        return x + self.dw2_bn(self.dw2(out), train)


class CARHyNet(nn.Module):
    """Input (B, C, H, W) in [0, 1]. dense=False: 32x32 patches -> (B, 128)
    descriptors. dense=True: the same weights over whole images -> a
    (B, ceil(H/4), ceil(W/4), 128) map of L2-normalized descriptors,
    channels last (the layout the keypoint sampler gathers rows from)."""

    def __init__(self, dim_desc: int = 128, dense: bool = False, in_channels: int = 3,
                 drop_rate: float = 0.2):
        super().__init__()
        self.dense = dense
        self.drop_rate = drop_rate
        self.in_channels = in_channels
        self.l1_frn_in = FRN(in_channels)
        self.l1_tlu_in = TLU(in_channels)
        self.l1_conv = _conv(in_channels, 32, 3, bias=True)
        self.l1_frn = FRN(32)
        self.l1_coord = CoordAtt(32, 32)
        self.l1_tlu = TLU(32)
        self.l2_conv = _conv(32, 32, 3, bias=True)
        self.l2_frn = FRN(32)
        self.l2_coord = CoordAtt(32, 32)
        self.l2_tlu = TLU(32)
        self.l2_sg = SandGlass(32, 32)
        self.l3_conv = _conv(32, 64, 3, stride=2, bias=True)
        self.l3_frn = FRN(64)
        self.l3_tlu = TLU(64)
        self.l4_conv = _conv(64, 64, 3, bias=True)
        self.l4_frn = FRN(64)
        self.l4_tlu = TLU(64)
        self.l4_sg = SandGlass(64, 64)
        self.l5_conv = _conv(64, 128, 3, stride=2, bias=True)
        self.l5_frn = FRN(128)
        self.l5_tlu = TLU(128)
        self.l6_conv = _conv(128, 128, 3, bias=True)
        self.l6_frn = FRN(128)
        self.l6_tlu = TLU(128)
        self.l7_conv = nn.Conv2d(128, dim_desc, 8, bias=False)
        self.l7_bn = BatchNorm(dim_desc, affine=False)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        x = self.l1_tlu_in(self.l1_frn_in(x))
        x = self.l1_tlu(self.l1_coord(self.l1_frn(self.l1_conv(x)), train))
        x1 = self.l2_tlu(self.l2_coord(self.l2_frn(self.l2_conv(x)), train))
        x = x1 + self.l2_sg(x1, train)
        x = self.l3_tlu(self.l3_frn(self.l3_conv(x)))
        x1 = self.l4_tlu(self.l4_frn(self.l4_conv(x)))
        x = x1 + self.l4_sg(x1, train)
        x = self.l5_tlu(self.l5_frn(self.l5_conv(x)))
        x = self.l6_tlu(self.l6_frn(self.l6_conv(x)))
        if train and self.drop_rate > 0:
            keep = 1.0 - self.drop_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        if self.dense:
            x = F.pad(x, (3, 4, 3, 4))  # SAME for an 8x8 kernel: 3 before, 4 after
        raw = self.l7_bn(self.l7_conv(x), train).float()
        if self.dense:
            raw = raw.permute(0, 2, 3, 1)
            x = raw / torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True) + EPS_L2_NORM)
        else:
            raw = raw.reshape(raw.shape[0], -1)
            x = raw / torch.sqrt(torch.sum(raw * raw, dim=1, keepdim=True) + EPS_L2_NORM)
        return (x, raw) if train else x
