"""Fused batch norm and group norm: hand-written CUDA kernels for Hopper,
with their plain PyTorch versions.

Counterpart of ``autodist_tpu/ops/pallas/fused_norm.py``.  Over the JAX
layout ``(..., C)`` (channels last):

- :func:`fused_batch_norm` -> ``(y, mean, var)``: training batch norm, the
  statistics over every leading row.  Forward: :func:`bn_fwd` (replaces
  ``_bn_forward``).
- :func:`fused_group_norm` -> ``y``: group norm, the statistics per sample
  and group of ``C // num_groups`` adjacent channels.  Forward:
  :func:`gn_fwd` (replaces ``_gn_forward``).

Both compute ``var = max(E[x^2] - mean^2, 0)`` and ``y = (x - mean) *
(rsqrt(var + eps) * scale) + bias``, then the optional ``residual`` add and
``act="relu"``, in f32, and write ``y`` in x's dtype (bf16 or f32); scale
and bias are f32.  Each wrapper launches ``csrc/fused_norm.cu`` for CUDA
tensors, counting the launch in ``LAUNCHES``, and runs the plain version
beside it (:func:`batch_norm_plain`, :func:`group_norm_plain`, which mirror
``batch_norm_reference`` and ``group_norm_reference``) for CPU tensors; any
other device raises.  The kernels take a contiguous ``(..., C)`` tensor and
raise on any other layout: the caller keeps activations channels-last.

Unlike the TPU kernel there is no row limit (``MAX_FUSED_ROWS`` bounds a
VMEM slab; the CUDA kernel splits rows into chunks and keeps the formula),
so every norm site of a model runs the kernel on the card.

The gradients are a :class:`torch.autograd.Function` each, whose backward
is the closed-form f32 gradient of ``_fused_bn_bwd`` / ``_fused_gn_bwd`` in
plain torch, as the JAX package has it in plain jnp: the relu mask from
the saved output, and for batch norm the cotangents of the returned mean
and var folded in.
"""
import ctypes

import torch

from autodist_tpu_torch.ops import build

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"bn_fwd": 0, "gn_fwd": 0}

# 256-thread blocks an H100 holds at once (132 SMs x 8): the row chunks are
# sized so that one pass fills the card about once
_RESIDENT_BLOCKS = 132 * 8
_MIN_ROWS_PER_CHUNK = 32
_MAX_GRID_Z = 65535


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_act(act):
    if act not in (None, "relu"):
        raise ValueError(f"unsupported fused activation {act!r}")


def _apply_act(y, act):
    return torch.relu(y) if act == "relu" else y


def group_count(channels, num_groups):
    """The group rule of ``FusedGroupNorm`` (``models/norm.py:90-91``):
    ``num_groups`` if it divides C, else C when C < ``num_groups``, else 1."""
    if channels % num_groups == 0:
        return num_groups
    return channels if channels < num_groups else 1


# ------------------------------------------------------------ plain versions --

def batch_norm_plain(x, scale, bias, *, eps=1e-5, act=None, residual=None):
    """``batch_norm_reference``: (y like x, mean (C,) f32, var (C,) f32)."""
    _check_act(act)
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    mean = xf.mean(dim=0)
    var = torch.clamp((xf * xf).mean(dim=0) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    if residual is not None:
        y = y + residual.float().reshape(-1, c)
    y = _apply_act(y, act)
    return y.to(x.dtype).reshape(x.shape), mean, var


def group_norm_plain(x, scale, bias, num_groups, *, eps=1e-5, act=None,
                     residual=None):
    """``group_norm_reference``: y like x."""
    _check_act(act)
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible into {num_groups} groups")
    cg = c // num_groups
    xg = x.float().reshape(b, -1, num_groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    y = (xg - mean) * torch.rsqrt(var + eps)
    y = y * scale.float().reshape(1, 1, num_groups, cg) \
        + bias.float().reshape(1, 1, num_groups, cg)
    y = y.reshape(x.shape)
    if residual is not None:
        y = y + residual.float()
    y = _apply_act(y, act)
    return y.to(x.dtype)


# ------------------------------------------------------------------ kernels --

_PTR, _INT, _LL, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "bn_fwd": [_PTR] * 9 + [_LL, _INT, _INT, _FLOAT, _INT, _INT, _PTR],
    "gn_fwd": [_PTR] * 9 + [_INT, _LL, _INT, _INT, _INT, _FLOAT, _INT, _INT, _PTR],
}


def _library():
    lib = build.load("fused_norm")
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _device_kind(x):
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fused norm runs on cuda (kernels) or cpu (plain "
                           f"versions), not {x.device}")
    return x.device.type


def _check(x, scale, bias, residual):
    """Validate what the kernels take; returns C."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused norm kernels take bf16 or f32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"fused norm kernels take a non-empty (..., C) tensor, "
                         f"got shape {tuple(x.shape)}")
    c = x.shape[-1]
    tensors = (x, scale, bias) + (() if residual is None else (residual,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused norm: all tensors must be on one device")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"fused norm: {name} must be a contiguous f32 ({c},) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"fused norm: residual must match x ({x.dtype} "
                         f"{tuple(x.shape)}), got {residual.dtype} {tuple(residual.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"fused norm kernels take a contiguous (..., C) layout; x "
                         f"strides {x.stride()} (keep activations channels-last)")
    return c


def _chunks(samples, rows, c, dtype):
    """Row chunks per sample: about one resident grid over the card."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    cblocks = -(-c // (32 * vec))
    want = -(-_RESIDENT_BLOCKS // (samples * cblocks))
    return max(1, min(-(-rows // _MIN_ROWS_PER_CHUNK), want))


def _launch(name, x, scale, bias, residual, samples, groups, eps, act):
    """Run one kernel over x as (samples, rows, C); returns (y, mean, var)
    with mean and var (samples * groups,) f32."""
    c = x.shape[-1]
    rows = x.numel() // (samples * c)
    if samples > _MAX_GRID_Z:
        raise ValueError(f"{name}: {samples} samples exceed the grid's {_MAX_GRID_Z}")
    chunks = _chunks(samples, rows, c, x.dtype)
    dev = x.device
    y = torch.empty_like(x)
    partial = torch.empty(2 * samples * chunks * c, dtype=torch.float32, device=dev)
    mean, var, inv = (torch.empty(samples * groups, dtype=torch.float32, device=dev)
                      for _ in range(3))
    ptrs = [x, scale, bias, residual, y, partial, mean, var, inv]
    ptrs = [None if t is None else t.data_ptr() for t in ptrs]
    shape = (rows, c, chunks) if name == "bn_fwd" else (samples, rows, c, groups, chunks)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*ptrs, *shape, float(eps), int(act == "relu"),
                                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return y, mean, var


def bn_fwd(x, scale, bias, eps=1e-5, act=None, residual=None):
    """Training batch norm over x's (..., C) layout: (y like x, mean (C,)
    f32, var (C,) f32).  The kernel on CUDA, :func:`batch_norm_plain` on the
    CPU."""
    _check_act(act)
    if _device_kind(x) == "cpu":
        return batch_norm_plain(x, scale, bias, eps=eps, act=act, residual=residual)
    c = _check(x, scale, bias, residual)
    return _launch("bn_fwd", x, scale, bias, residual, 1, c, eps, act)


def gn_fwd(x, scale, bias, num_groups, eps=1e-5, act=None, residual=None):
    """Group norm over x's (B, ..., C) layout: y like x.  The kernel on
    CUDA, :func:`group_norm_plain` on the CPU."""
    _check_act(act)
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible into {num_groups} groups")
    if _device_kind(x) == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps=eps, act=act,
                                residual=residual)
    _check(x, scale, bias, residual)
    y, _, _ = _launch("gn_fwd", x, scale, bias, residual, x.shape[0], num_groups,
                      eps, act)
    return y


# ---------------------------------------------------------------- gradients --

def _bn_backward(x, scale, mean, var, y, gy, gmean, gvar, eps, act, res_dtype):
    """``_fused_bn_bwd`` in f32: dx = inv/n * (n*dxhat - sum(dxhat) - xhat *
    sum(dxhat*xhat)) with dxhat = g*scale, whose two sums are scale*dbias and
    scale*dscale; plus gmean/n and gvar*2(x - mean)/n."""
    c = x.shape[-1]
    n = x.numel() // c
    xf = x.float().reshape(-1, c)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    g = torch.zeros_like(xf) if gy is None else gy.float().reshape(-1, c)
    if act == "relu":
        g = g * (y.reshape(-1, c) > 0)
    dres = None if res_dtype is None else g.to(res_dtype).reshape(x.shape)
    dbias = g.sum(dim=0)
    dscale = (g * xhat).sum(dim=0)
    dx = (inv * scale.float() / n) * (n * g - dbias - xhat * dscale)
    if gmean is not None:
        dx = dx + gmean.float() / n
    if gvar is not None:
        dx = dx + gvar.float() * 2.0 * (xf - mean) / n
    return (dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype),
            dbias.to(scale.dtype), dres)


def _gn_backward(x, scale, y, gy, num_groups, eps, act, res_dtype):
    """``_fused_gn_bwd`` in f32, the statistics recomputed from x."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.float().reshape(b, -1, num_groups, cg)
    n = xg.shape[1] * cg
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (xg - mean) * inv
    g = gy.float().reshape(xg.shape)
    if act == "relu":
        g = g * (y.reshape(xg.shape) > 0)
    dres = None if res_dtype is None else g.reshape(x.shape).to(res_dtype)
    dbias = g.sum(dim=(0, 1)).reshape(c)
    dscale = (g * xhat).sum(dim=(0, 1)).reshape(c)
    dxhat = g * scale.float().reshape(1, 1, num_groups, cg)
    dx = (inv / n) * (n * dxhat - dxhat.sum(dim=(1, 3), keepdim=True)
                      - xhat * (dxhat * xhat).sum(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype),
            dbias.to(scale.dtype), dres)


class _FusedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, act):
        y, mean, var = bn_fwd(x, scale, bias, eps, act, residual)
        ctx.set_materialize_grads(False)
        # the relu mask is read from y; without relu y is not kept
        ctx.save_for_backward(x, scale, mean, var, y if act == "relu" else None)
        ctx.config = (eps, act, None if residual is None else residual.dtype)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, var, y = ctx.saved_tensors
        dx, dscale, dbias, dres = _bn_backward(x, scale, mean, var, y, gy, gmean,
                                               gvar, *ctx.config)
        return dx, dscale, dbias, dres, None, None


class _FusedGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, num_groups, eps, act):
        y = gn_fwd(x, scale, bias, num_groups, eps, act, residual)
        ctx.save_for_backward(x, scale, y if act == "relu" else None)
        ctx.config = (num_groups, eps, act, None if residual is None else residual.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, y = ctx.saved_tensors
        dx, dscale, dbias, dres = _gn_backward(x, scale, y, gy, *ctx.config)
        return dx, dscale, dbias, dres, None, None, None


def _no_interpret(interpret):
    if interpret is not None:
        raise NotImplementedError(
            "interpret mode is the TPU kernels' CPU mode; the port runs the plain "
            "version for CPU tensors instead")


def fused_batch_norm(x, scale, bias, *, eps=1e-5, act=None, residual=None,
                     interpret=None):
    """Training batch norm: ``(y, mean, var)`` with batch statistics over
    all leading dims of x's ``(..., C)`` layout; differentiable."""
    _no_interpret(interpret)
    _check_act(act)
    return _FusedBatchNorm.apply(x, scale, bias, residual, float(eps), act)


def fused_group_norm(x, scale, bias, num_groups, *, eps=1e-5, act=None,
                     residual=None, interpret=None):
    """Group norm over x's ``(B, ..., C)`` layout (per-sample, per-group
    statistics); C must divide into ``num_groups``; differentiable."""
    _no_interpret(interpret)
    _check_act(act)
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible into {num_groups} groups")
    return _FusedGroupNorm.apply(x, scale, bias, residual, int(num_groups), float(eps),
                                 act)
