"""Normalisation modules of the ResNet family (counterpart of
``autodist_tpu/models/norm.py``, plus flax ``nn.BatchNorm``'s math).

Each module takes channels-last ``(..., C)`` activations and is called as
``norm(x, train, new_state)``:

- :class:`BatchNorm`: flax ``nn.BatchNorm`` (``norm="bn"``) in plain torch,
  f32 statistics ``var = max(E[x^2] - mean^2, 0)``, differentiated by
  autograd; no kernel, as in JAX.
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
            new_state[self.path + ".mean"] = m * self.mean + (1 - m) * mean.detach()
            new_state[self.path + ".var"] = m * self.var + (1 - m) * var.detach()
        return self._out(y, x)


class BatchNorm(_RunningNorm):
    """flax ``nn.BatchNorm`` with f32 reductions, in plain torch."""

    def _batch_stats(self, x):
        return batch_norm_plain(x, self.scale, self.bias, eps=self.epsilon)


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
