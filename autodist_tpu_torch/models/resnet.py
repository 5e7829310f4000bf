"""ResNet family, v1.5 (counterpart of ``autodist_tpu/models/resnet.py``).

Reproduces the flax model's function in PyTorch:

- Layout: the public tensors are NHWC, as in JAX (``x`` is ``(B, H, W,
  C)``).  Activations stay channels-last in memory: a convolution runs on
  the NCHW view ``x.permute(0, 3, 1, 2)`` of that memory (cuDNN keeps the
  layout) and hands back the NHWC view of its result, so every norm sees a
  contiguous ``(rows, C)`` layout.
- :class:`Conv` is flax ``nn.Conv(use_bias=False, dtype=...)``: input and
  kernel cast to ``dtype``; weight ``(out, in, kh, kw)`` f32 (the flax
  kernel is ``(kh, kw, in, out)``; ``models/convert.py`` permutes).
  ``"SAME"`` padding is flax's: ``pad_lo = total // 2``, so a stride-2 conv
  or max-pool on an even input pads (0, 1), where ``padding=1`` would pad
  (1, 1).  Asymmetric padding is an explicit ``F.pad`` (``-inf`` for the
  max-pool).
- Norms (``models/norm.py``): ``norm="bn"`` flax ``nn.BatchNorm`` in plain
  torch, ``"bn_fused"`` the fused batch-norm kernel, ``"gn"`` the fused
  group-norm kernel (32 groups).  A fused norm's ``impl="reference"`` runs
  its plain version instead of the kernel.
- The head is ``Dense(dtype=f32)`` on the bf16 spatial mean.
- Init reproduces flax's distributions: lecun-normal (truncated at two
  std) conv and head kernels, zero head bias, unit norm scale except
  ``scale_init=zeros`` on each block's last norm, zero norm bias, running
  mean 0 and var 1.

Names follow flax's: ``conv_init``, ``bn_init``, ``BottleneckResNetBlock_<k>``
(or ``ResNetBlock_<k>``) numbered across stages, inside each block
``Conv_<i>`` and ``<NormClass>_<i>`` and the explicit ``conv_proj`` /
``norm_proj``, then ``head``; ``h.Conv_0.weight`` <-> ``h/Conv_0/kernel``.

``forward(x, train=True, new_state=None)`` returns f32 logits; in training
a ``new_state`` dict receives every batch norm's new running statistics by
buffer name.  ``bn_f32_stats=False`` computes the ``norm="bn"`` sites'
statistics in the compute dtype (flax's ``force_float32_reductions=False``);
``bn_fused`` and ``gn`` ignore it, as in JAX.
"""
import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.norm import BatchNorm, FusedBatchNorm, FusedGroupNorm

# flax's lecun_normal: truncated normal at +-2 std, std corrected for the cut
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def same_pads(size, kernel, stride):
    """flax/XLA ``"SAME"`` padding of one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, pads, value=0.0):
    """Pads (h, w) of an NCHW view; returns (x, symmetric padding) so that a
    symmetric pad is left to the conv itself."""
    (hl, hh), (wl, wh) = pads
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, padding, use_bias=False,
    dtype)`` over NHWC tensors."""

    def __init__(self, in_features, features, kernel_size, strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size,
                                               device=device))

    def reset_parameters(self, generator=None):
        kh, kw = self.kernel_size
        with torch.no_grad():
            _lecun_normal_(self.weight, kh * kw * self.weight.shape[1], generator)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        if self.padding == "SAME":
            pads = [same_pads(n, k, s) for n, k, s in
                    zip((h, w), self.kernel_size, self.strides)]
        else:
            pads = self.padding
        xn, sym = _pad_nchw(x.permute(0, 3, 1, 2).to(self.dtype), pads)
        y = F.conv2d(xn, self.weight.to(self.dtype), stride=self.strides, padding=sym)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=f32)``: weight (out, in), bias; f32 product."""

    def __init__(self, in_features, features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            _lecun_normal_(self.weight, self.weight.shape[1], generator)
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


def max_pool_same(x, window=3, stride=2):
    """``nn.max_pool(x, (w, w), strides=(s, s), padding="SAME")`` on NHWC."""
    pads = [same_pads(n, window, stride) for n in (x.shape[1], x.shape[2])]
    xn, sym = _pad_nchw(x.permute(0, 3, 1, 2), pads, value=float("-inf"))
    return F.max_pool2d(xn, window, stride, padding=sym).permute(0, 2, 3, 1)


class _Block(nn.Module):
    """Shared by both block kinds: numbered convs and norms, the projection."""

    def __init__(self, in_features, out_features, strides, make_conv, make_norm,
                 convs):
        super().__init__()
        self._n = len(convs)
        self._norm_name = make_norm.func.__name__
        for i, (cin, cout, k, s) in enumerate(convs):
            self.add_module(f"Conv_{i}", make_conv(cin, cout, k, s))
            self.add_module(f"{self._norm_name}_{i}",
                            make_norm(cout, zero_scale=i == len(convs) - 1))
        # flax projects when residual.shape != y.shape
        if in_features != out_features or tuple(strides) != (1, 1):
            self.conv_proj = make_conv(in_features, out_features, (1, 1), strides)
            self.norm_proj = make_norm(out_features)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x, train=True, new_state=None):
        residual = x
        y = x
        for i in range(self._n):
            y = getattr(self, f"Conv_{i}")(y)
            y = getattr(self, f"{self._norm_name}_{i}")(y, train, new_state)
            if i < self._n - 1:
                y = torch.relu(y)
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual), train, new_state)
        return torch.relu(residual + y)


class ResNetBlock(_Block):
    def __init__(self, in_features, filters, make_conv, make_norm, strides=(1, 1)):
        super().__init__(in_features, filters, strides, make_conv, make_norm, [
            (in_features, filters, (3, 3), strides), (filters, filters, (3, 3), (1, 1))])


class BottleneckResNetBlock(_Block):
    def __init__(self, in_features, filters, make_conv, make_norm, strides=(1, 1)):
        super().__init__(in_features, filters * 4, strides, make_conv, make_norm, [
            (in_features, filters, (1, 1), (1, 1)), (filters, filters, (3, 3), strides),
            (filters, filters * 4, (1, 1), (1, 1))])


def space_to_depth(x, block=2):
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel order (dr, dc, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, block * block * c)


def conv7_to_s2d_kernel(w7):
    """The (F, C, 7, 7) stride-2 stem weight (PyTorch layout) as the
    equivalent (F, 4C, 4, 4) weight of the space-to-depth stem: zero-pad to
    8x8 at the top-left, then fold each 2x2 tap block into the channels in
    (dr, dc, c) order (``conv7_to_s2d_kernel`` on the flax layout)."""
    f, c = w7.shape[0], w7.shape[1]
    w8 = F.pad(w7, (1, 0, 1, 0))
    return w8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)


class ResNet(nn.Module):
    """ResNet over NHWC images; returns f32 logits (B, num_classes).

    ``generator`` seeds the initialisation (flax's ``model.init``); an
    ``nn.Module`` made on ``device="meta"`` holds shapes only."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, stem="conv", bn_f32_stats=True,
                 norm="bn", in_channels=3, device=None,
                 generator=None):
        super().__init__()
        if norm == "bn":   # bn_f32_stats applies to flax's nn.BatchNorm only, as in JAX
            make_norm = partial(BatchNorm, momentum=0.9, epsilon=1e-5, dtype=dtype,
                                f32_stats=bn_f32_stats, device=device)
        elif norm == "bn_fused":
            make_norm = partial(FusedBatchNorm, momentum=0.9, epsilon=1e-5, dtype=dtype,
                                device=device)
        elif norm == "gn":
            make_norm = partial(FusedGroupNorm, num_groups=32, epsilon=1e-5, dtype=dtype,
                                device=device)
        else:
            raise ValueError(f"unknown norm {norm!r}")

        def make_conv(cin, cout, kernel, strides=(1, 1), padding="SAME"):
            return Conv(cin, cout, kernel, strides, padding, dtype, device)

        self.dtype = dtype
        self.stem = stem
        self.in_channels = in_channels
        if stem == "space_to_depth":
            self.conv_init = make_conv(4 * in_channels, num_filters, (4, 4), (1, 1),
                                       [(2, 1), (2, 1)])
        elif stem == "conv":
            self.conv_init = make_conv(in_channels, num_filters, (7, 7), (2, 2),
                                       [(3, 3), (3, 3)])
        else:
            raise ValueError(f"unknown stem {stem!r}")
        self.bn_init = make_norm(num_filters)
        self.block_names = []
        features = num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                block = block_cls(features, num_filters * 2 ** i, make_conv, make_norm,
                                  (2, 2) if i > 0 and j == 0 else (1, 1))
                self.add_module(name, block)
                self.block_names.append(name)
                features = num_filters * 2 ** i * (4 if block_cls is BottleneckResNetBlock
                                                   else 1)
        self.head = Dense(features, num_classes, device=device)
        for name, m in self.named_modules():
            if hasattr(m, "path"):
                m.path = name
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Draw every weight anew from ``generator``; running stats reset."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
            if hasattr(m, "reset_running_stats"):
                m.reset_running_stats()

    def forward(self, x, train=True, new_state=None):
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        x = self.conv_init(x)
        x = torch.relu(self.bn_init(x, train, new_state))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train, new_state)
        x = x.mean(dim=(1, 2))
        return self.head(x)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckResNetBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckResNetBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckResNetBlock)
