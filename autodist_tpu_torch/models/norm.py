"""Normalisation modules of the ResNet family (counterpart of
``autodist_tpu/models/norm.py``, plus flax ``nn.BatchNorm``'s math).

Each module takes channels-last ``(..., C)`` activations and is called as
``norm(x, train, new_state)``:

- :class:`BatchNorm`: flax ``nn.BatchNorm`` (``norm="bn"``) in plain torch,
  f32 statistics ``var = max(E[x^2] - mean^2, 0)``, differentiated by
  autograd; no kernel, as in JAX.  With ``f32_stats=False`` (flax's
  ``force_float32_reductions=False``, the ResNet's ``bn_f32_stats=False``)
  the statistics are in the compute dtype, in flax's order
  (:func:`batch_norm_compute_dtype`).
- :class:`FusedBatchNorm`: ``FusedBatchNorm`` (``norm="bn_fused"``); its
  training path is :func:`~autodist_tpu_torch.ops.fused_norm.fused_batch_norm`
  (the Hopper kernel on CUDA) unless ``impl="reference"``, which takes the
  plain version under autograd.
- :class:`FusedGroupNorm`: ``FusedGroupNorm`` (``norm="gn"``) over
  :func:`~autodist_tpu_torch.ops.fused_norm.fused_group_norm`; no running
  statistics, train == eval.

The batch norms hold f32 params ``scale``/``bias`` and f32 buffers ``mean``
(zeros) and ``var`` (ones), the flax ``batch_stats``.  In training they do
not write their buffers: the new running statistics ``momentum * old +
(1 - momentum) * batch`` (batch var biased, as the kernel returns it; flax's
momentum 0.9, not PyTorch's 0.1 with the unbiased var) go into the
``new_state`` dict under ``<path>.mean`` / ``<path>.var``, where ``path`` is
the module's name in its model.  With ``train=False`` they normalise with the
running statistics.  The output is cast to ``dtype`` (default x's).

One difference from JAX: ``FusedBatchNorm`` and ``FusedGroupNorm`` fall back
to the plain path above ``MAX_FUSED_ROWS`` rows there (a VMEM bound of the
TPU kernel; at ResNet-50's B=256 only the nine 7x7 stage-4 sites stay on the
kernel).  The CUDA kernels have no row limit, so here every site runs the
kernel; the function computed is the same.
"""
import torch
from torch import nn

from autodist_tpu_torch.ops.fused_norm import (batch_norm_plain, fused_batch_norm,
                                               fused_group_norm, group_count,
                                               group_norm_plain)


def _check_impl(impl):
    if impl not in ("kernel", "reference"):
        raise ValueError(f"impl must be 'kernel' or 'reference', got {impl!r}")
    return impl


class _Norm(nn.Module):
    """f32 ``scale`` (ones, or zeros with ``zero_scale``) and ``bias``."""

    def __init__(self, features, epsilon, dtype, zero_scale, device):
        super().__init__()
        self.features = features
        self.epsilon = epsilon
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.path = ""   # the module's name in its model, set by the model
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def _out(self, y, x):
        return y.to(self.dtype or x.dtype)


class _RunningNorm(_Norm):
    """A batch norm: running ``mean``/``var`` buffers and their update."""

    def __init__(self, features, momentum=0.9, epsilon=1e-5, dtype=None,
                 zero_scale=False, device=None):
        super().__init__(features, epsilon, dtype, zero_scale, device)
        self.momentum = momentum
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))
        self.reset_running_stats()

    def reset_running_stats(self):
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def _batch_stats(self, x):
        raise NotImplementedError

    def forward(self, x, train=True, new_state=None):
        if not train:
            inv = torch.rsqrt(self.var + self.epsilon) * self.scale
            return self._out((x.float() - self.mean) * inv + self.bias, x)
        y, mean, var = self._batch_stats(x)
        if new_state is not None:
            m = self.momentum
            # 1 - m rounded to the statistics' dtype, as JAX rounds a
            # weakly typed Python float; the product in f32, as XLA runs it
            decay = float(torch.tensor(1 - m, dtype=mean.dtype))
            new_state[self.path + ".mean"] = m * self.mean + decay * mean.detach().float()
            new_state[self.path + ".var"] = m * self.var + decay * var.detach().float()
        return self._out(y, x)


def batch_norm_compute_dtype(x, scale, bias, eps, dtype):
    """flax ``nn.BatchNorm(force_float32_reductions=False)``'s training
    statistics and output, with the roundings of the program XLA compiles
    from it: ``x`` in ``dtype``; each mean an f32 sum times the f32
    reciprocal of the count, rounded to ``dtype`` (``x * x`` summed in f32);
    ``mean^2``, ``var = max(mean2 - mean^2, 0)`` and ``var + eps`` rounded
    to ``dtype``; ``rsqrt``, ``x - mean``, the scale and the bias in f32.
    (The flax source rounds ``x * x``, ``x - mean`` and ``rsqrt`` to
    ``dtype`` as well; XLA drops those f32 -> ``dtype`` -> f32 round trips.)
    Returns (y in f32, mean, var), the statistics in ``dtype``."""
    c = x.shape[-1]
    xf = x.to(dtype).reshape(-1, c).float()
    inv_n = 1.0 / xf.shape[0]
    mean = (xf.sum(dim=0) * inv_n).to(dtype)
    mean2 = ((xf * xf).sum(dim=0) * inv_n).to(dtype)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt((var + float(torch.tensor(eps, dtype=dtype))).float())
    y = (xf - mean.float()) * (inv * scale) + bias
    return y.reshape(x.shape), mean, var


class BatchNorm(_RunningNorm):
    """flax ``nn.BatchNorm`` in plain torch: f32 reductions, or with
    ``f32_stats=False`` reductions in the compute dtype."""

    def __init__(self, features, momentum=0.9, epsilon=1e-5, dtype=None,
                 zero_scale=False, f32_stats=True, device=None):
        super().__init__(features, momentum, epsilon, dtype, zero_scale, device)
        self.f32_stats = f32_stats

    def _batch_stats(self, x):
        if self.f32_stats:
            return batch_norm_plain(x, self.scale, self.bias, eps=self.epsilon)
        return batch_norm_compute_dtype(x, self.scale, self.bias, self.epsilon,
                                        self.dtype or x.dtype)


class FusedBatchNorm(_RunningNorm):
    """``FusedBatchNorm``: the fused kernel in training (``impl="kernel"``)."""

    def __init__(self, features, momentum=0.9, epsilon=1e-5, dtype=None,
                 zero_scale=False, impl="kernel", device=None):
        super().__init__(features, momentum, epsilon, dtype, zero_scale, device)
        self.impl = _check_impl(impl)

    def _batch_stats(self, x):
        if self.impl == "kernel":
            return fused_batch_norm(x, self.scale, self.bias, eps=self.epsilon)
        return batch_norm_plain(x, self.scale, self.bias, eps=self.epsilon)


class FusedGroupNorm(_Norm):
    """``FusedGroupNorm``: per-sample statistics over ``group_count(C, 32)``
    groups; ``train`` and ``new_state`` are accepted and unused."""

    def __init__(self, features, num_groups=32, epsilon=1e-5, dtype=None,
                 zero_scale=False, impl="kernel", device=None):
        super().__init__(features, epsilon, dtype, zero_scale, device)
        self.num_groups = group_count(features, num_groups)
        self.impl = _check_impl(impl)

    def forward(self, x, train=True, new_state=None):
        norm = fused_group_norm if self.impl == "kernel" else group_norm_plain
        return self._out(norm(x, self.scale, self.bias, self.num_groups,
                              eps=self.epsilon), x)
