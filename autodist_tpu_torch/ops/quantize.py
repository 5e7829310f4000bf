"""Block int8 quantization: hand-written CUDA kernels for Hopper, with their
plain PyTorch versions.

Counterpart of ``autodist_tpu/ops/pallas/quantize.py``, the hot ops of the
int8 all-reduce codecs (``kernel/synchronization/compressor.py``).  Over
blocks of ``BLOCK = 256`` f32 elements, each with one f32 scale:

- :func:`quantize_int8` ``(N, 256) f32 -> ((N, 256) int8, (N, 1) f32)``:
  ``s = absmax / 127`` (a zero scale becomes 1), ``q = clip(round(x / s),
  -127, 127)``;
- :func:`dequant_sum` ``((D, N, 256) int8, (D, N, 1) f32) -> (N, 256) f32``:
  the sum over D peers of ``q * s``;
- :func:`equarx_hop` ``(q, s, n_dev) -> (q, s)``: dequantize, mean over the
  peers and requantize in one pass, bitwise equal to
  ``quantize_int8(dequant_sum(q, s) / n_dev)`` (the EQuARX contract).

Each wrapper launches ``csrc/quantize.cu`` for CUDA tensors, counting the
launch in ``LAUNCHES``, and runs its plain version (``*_plain``) for CPU
tensors; any other device raises.  ``impl="plain"`` runs the plain version
on any device (the tests and ``chip_smoke.py``'s checks).

The kernels and the plain versions agree to the bit: both take IEEE
quotients (:func:`true_divide`: PyTorch's CUDA ``tensor / python_float``
multiplies by the reciprocal; the hop kernel gets the same quotients from
a correctly rounded reciprocal a block and one FMA correction an element,
and its peer mean as :func:`mean_mode` says), round half to even, sum the
peers in order d = 0..D-1 without fusing a multiply into the add, and let
a NaN poison its block's scale as ``jnp.max`` does (the block's q is then
0).  The JAX reference on the CPU differs in one place: XLA folds ``/
127.0`` and ``/ n_dev`` into a multiply by the reciprocal, so a scale can
differ from it by one ulp, and a q by one step where ``x / s`` lies on a
rounding tie.

``ROWS = 128`` is the TPU kernels' row tile: they need N to be a multiple
of it, and the JAX codec pads chunks to ``ROWS * BLOCK`` on TPU only.  The
CUDA kernels take any N >= 1.  Blocks start at multiples of 256 either
way, so every real element of a bucket falls in the same block, with the
same scale, under both paddings.
"""
import ctypes
import math

import torch

from autodist_tpu_torch.ops import build

BLOCK = 256       # quantization block (elements per scale)
ROWS = 128        # the TPU kernels' row tile (not a constraint of the CUDA kernels)

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"quantize_int8": 0, "dequant_sum": 0, "equarx_hop": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def true_divide(x, d):
    """``x / d`` for a Python number ``d`` as an IEEE division on every
    device, as the kernels divide (on CUDA, ``x / d`` would multiply by the
    reciprocal)."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def pad_to_blocks(flat):
    """Zero-pad a flat vector to whole blocks and view it as ``(N, BLOCK)``
    (the JAX function also rounds N up to a multiple of ``ROWS``, the TPU
    tile)."""
    pad = -flat.shape[0] % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


# ------------------------------------------------------------ plain versions --

def quantize_int8_plain(x_blocks):
    """``_quant_kernel`` in torch: ((N, B) int8, (N, 1) f32)."""
    amax = x_blocks.abs().amax(dim=1, keepdim=True)   # propagates NaN
    s = true_divide(amax, 127.0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    # a NaN's q is 0, as the kernel and XLA's conversion give it
    q = torch.nan_to_num(torch.clamp(torch.round(x_blocks / s), -127, 127), nan=0.0)
    return q.to(torch.int8), s


def dequant_sum_plain(q, s):
    """``_dequant_sum_kernel`` in torch, peers summed in order d = 0..D-1."""
    acc = q[0].float() * s[0]
    for d in range(1, q.shape[0]):
        acc = acc + q[d].float() * s[d]
    return acc


def equarx_hop_plain(q, s, n_dev):
    """``_equarx_hop_kernel`` in torch: the unfused expression it equals."""
    return quantize_int8_plain(true_divide(dequant_sum_plain(q, s), n_dev))


# ------------------------------------------------------------------ kernels --

_PTR, _INT, _LL, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "quantize_int8": [_PTR, _PTR, _PTR, _LL, _PTR],
    "dequant_sum": [_PTR, _PTR, _PTR, _INT, _LL, _PTR],
    "equarx_hop": [_PTR, _PTR, _PTR, _PTR, _INT, _LL, _INT, _FLOAT, _PTR],
}


def _library():
    lib = build.load("quantize")
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _use_kernel(t, impl):
    """True to launch the kernel: CUDA tensors unless ``impl="plain"``; CPU
    tensors take the plain version; other devices raise."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if t.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"int8 quantization runs on cuda (kernels) or cpu (plain "
                           f"versions), not {t.device}")
    return t.device.type == "cuda" and impl is None


def _check(name, t, dtype, shape, align=4):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"(contiguous={t.is_contiguous()})")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: the kernel takes {align}-byte aligned tensors")


def mean_mode(n_dev):
    """How the hop kernel takes the peer mean ``x / n_dev``, bitwise as
    :func:`true_divide`: ``(0, 1.0)`` for ``n_dev = 1`` (no operation), ``(1,
    2^-k)`` for ``n_dev = 2^k`` (a multiply by the exact reciprocal gives the
    same correctly rounded value, subnormals included), else ``(2, n_dev)``
    (IEEE division).  ``n_dev`` is taken as the f32 the division uses."""
    n = ctypes.c_float(float(n_dev)).value
    if n == 1.0:
        return 0, 1.0
    mantissa, exponent = math.frexp(n)
    if mantissa == 0.5 and -125 <= exponent <= 127:   # 2^-126 <= n <= 2^126
        return 1, 1.0 / n
    return 2, n


def _check_peers(q, s, align=4):
    if q.dim() != 3 or q.shape[0] < 1 or q.shape[1] < 1 or q.shape[2] != BLOCK:
        raise ValueError(f"expected q of shape (D, N, {BLOCK}) with D, N >= 1, "
                         f"got {tuple(q.shape)}")
    if s.device != q.device:
        raise ValueError("q and s must be on one device")
    d, n, _ = q.shape
    _check("q", q, torch.int8, (d, n, BLOCK), align)
    _check("s", s, torch.float32, (d, n, 1))
    return d, n


def _launch(name, device, *args):
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def quantize_int8(x_blocks, impl=None):
    """Block quantize ``(N, BLOCK) f32 -> ((N, BLOCK) int8, (N, 1) f32)``."""
    if not _use_kernel(x_blocks, impl):
        return quantize_int8_plain(x_blocks)
    if x_blocks.dim() != 2 or x_blocks.shape[0] < 1:
        raise ValueError(f"expected x of shape (N, {BLOCK}) with N >= 1, got "
                         f"{tuple(x_blocks.shape)}")
    n = x_blocks.shape[0]
    _check("x", x_blocks, torch.float32, (n, BLOCK), align=16)
    q = torch.empty((n, BLOCK), dtype=torch.int8, device=x_blocks.device)
    s = torch.empty((n, 1), dtype=torch.float32, device=x_blocks.device)
    _launch("quantize_int8", x_blocks.device, x_blocks.data_ptr(), q.data_ptr(),
            s.data_ptr(), n)
    return q, s


def dequant_sum(q, s, impl=None):
    """Dequantize and sum over the peers: ``((D, N, BLOCK) int8, (D, N, 1)
    f32) -> (N, BLOCK) f32``."""
    if not _use_kernel(q, impl):
        return dequant_sum_plain(q, s)
    d, n = _check_peers(q, s)
    out = torch.empty((n, BLOCK), dtype=torch.float32, device=q.device)
    _launch("dequant_sum", q.device, q.data_ptr(), s.data_ptr(), out.data_ptr(), d, n)
    return out


def equarx_hop(q, s, n_dev, impl=None):
    """Dequantize, mean over ``n_dev`` and requantize in one pass:
    ``((D, N, BLOCK) int8, (D, N, 1) f32) -> ((N, BLOCK) int8, (N, 1) f32)``."""
    if not _use_kernel(q, impl):
        return equarx_hop_plain(q, s, n_dev)
    d, n = _check_peers(q, s, align=16)   # the hop loads 16 bytes a lane
    qo = torch.empty((n, BLOCK), dtype=torch.int8, device=q.device)
    so = torch.empty((n, 1), dtype=torch.float32, device=q.device)
    _launch("equarx_hop", q.device, q.data_ptr(), s.data_ptr(), qo.data_ptr(),
            so.data_ptr(), d, n, *mean_mode(n_dev))
    return qo, so
