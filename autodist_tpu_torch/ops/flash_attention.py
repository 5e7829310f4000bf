"""Flash attention: hand-written CUDA kernels for Hopper, with their plain
PyTorch versions.

Counterpart of ``autodist_tpu/ops/pallas/flash_attention.py``.  The public
:func:`flash_attention` keeps the JAX layout ``(B, S, H, D)``, folds it to
``(B*H, S, D)``, and runs the kernels of ``csrc/flash_attention.cu``
through a :class:`torch.autograd.Function`:

- :func:`flash_fwd` (replaces ``_flash_fwd``): out and per-row logsumexp;
- :func:`flash_dq` (replaces ``_dq_call``): dq from p recomputed from lse;
- :func:`flash_dkdv` (replaces ``_dkdv_call``): dk and dv per q head.

Ring attention (:mod:`autodist_tpu_torch.parallel.ring_attention`) runs a
fourth, :func:`flash_block_update` (replaces ``flash_block_update``): it
folds one visiting K/V block into the unnormalised ``(m, l, o)`` carry.
It and the backward kernels take the blocks' global positions ``q_off``
and ``k_off``; causal keeps ``q_off + row >= k_off + col``.

Each kernel takes bf16 (tensor-core products) or f32 (f32 FMAs) inputs.
In bf16 every kernel is a Hopper kernel, ``wgmma`` fed by TMA tile loads
(the forward and the block update one, dq and dkdv one each); TMA reads
rows whose stride is a multiple of 16 bytes, so for a D that is not a
multiple of 8 the wrappers append zero columns to q, k, v (and dO, and
the carry's o), which change no q.k and no dO.v, keep the scale
1/sqrt(D) of the true D, and cut the extra output columns off.  The
forward's exponent takes a positive scale, so a scale <= 0 is turned
into one with the same scores (:func:`positive_scale`); dq and dkdv take
the scale as it is (flipping k's sign would flip dk).
Each wrapper launches its kernel for CUDA tensors and counts the launch in
``LAUNCHES``; for CPU tensors it runs the plain version beside it
(:func:`flash_fwd_plain`, :func:`flash_block_update_plain`,
:func:`flash_dq_plain`, :func:`flash_dkdv_plain`), which does the same
math in f32 with whole-matrix ops.  Any other device raises.  The kernels
take any S and D <= 128 (the ragged tile is masked in the kernel), so
there is no counterpart of the JAX ``_xla_attention`` fallback.  Without
a key mask there is no bias row: ``bias=None`` reaches the kernels as a
null pointer, and they read none.  As in JAX, delta = rowsum(dO * O),
the fold, the GQA group-sum of the per-q-head dk/dv partials and the zero
bias gradient are plain ops.
"""
import ctypes

import torch

from autodist_tpu_torch.ops import build

_NEG_INF = -1e30   # finite: -inf NaNs under (0 * -inf) in masked-row algebra
_M_FLOOR = -1e20   # running-max floor: a fully masked row gives exact zeros
MAX_HEAD_DIM = 128

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"flash_fwd": 0, "flash_block_update": 0, "flash_dq": 0, "flash_dkdv": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_flash(impl):
    """Resolve a model config's ``attention_impl``: "auto" and "flash" take
    the flash path (the kernels on CUDA, their plain versions on the CPU);
    "xla" takes :func:`attention_plain`, autograd through plain ops."""
    if impl in ("auto", "flash"):
        return True
    if impl == "xla":
        return False
    raise ValueError(f"attention_impl must be auto|flash|xla, got {impl!r}")


# ------------------------------------------------------------ plain versions --

def _expand_kv(t, h, group):
    """(B*H/g, S, D) kv fold -> (B*H, S, D): q head hq reads kv head
    hq // group (the ``_kv_index`` rule), materialised for the plain math."""
    if group == 1:
        return t
    bhk, s, d = t.shape
    return t.view(bhk // (h // group), h // group, s, d).repeat_interleave(
        group, dim=1).reshape(bhk * group, s, d)


def _scores_plain(q, k, bias, h, sm_scale, causal, group, q_off=0, k_off=0):
    """Masked f32 scores (B*H, Sq, Sk), as the kernels compute them; causal
    over the global positions ``q_off + row`` and ``k_off + col``.  No bias
    row (``bias=None``) adds nothing."""
    kx = _expand_kv(k, h, group).float()
    s = torch.matmul(q.float(), kx.transpose(1, 2)) * sm_scale
    if bias is not None:
        s = s + bias.repeat_interleave(h, dim=0)[:, None, :]
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        keep = (q_off + torch.arange(sq, device=s.device)[:, None]
                >= k_off + torch.arange(sk, device=s.device)[None, :])
        s = torch.where(keep[None], s, torch.full_like(s, _NEG_INF))
    return s


def flash_fwd_plain(q, k, v, bias, h, sm_scale, causal, group=1):
    """Plain forward: (out like q, lse f32 (B*H, Sq))."""
    s = _scores_plain(q, k, bias, h, sm_scale, causal, group)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, _expand_kv(v, h, group).float()) / denom
    return out.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_block_update_plain(q, k, v, m, l, o, q_off, k_off, causal=False,
                             sm_scale=None):
    """Plain ring step: fold the block ``k``, ``v`` (BH, Sk, D) into the
    carry of ``q`` (BH, Sq, D): m, l (BH, Sq) f32 and the unnormalised o
    (BH, Sq, D) f32 -> new (m, l, o).  The entering m is clamped at
    ``_M_FLOOR`` (an m of -inf cannot NaN); a block wholly in the future
    returns the carry unchanged but for that clamp."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores_plain(q, k, None, 1, sm_scale, causal, 1, q_off, k_off)
    m_prev = torch.clamp(m, min=_M_FLOOR)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def _probs_and_dscores(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group,
                       q_off, k_off):
    s = _scores_plain(q, k, bias, h, sm_scale, causal, group, q_off, k_off)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), _expand_kv(v, h, group).float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_dq_plain(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group=1,
                   q_off=0, k_off=0):
    """Plain dq: ds . k with p recomputed from lse; like q."""
    _, ds = _probs_and_dscores(q, k, v, bias, do, lse, delta, h, sm_scale,
                               causal, group, q_off, k_off)
    return torch.matmul(ds, _expand_kv(k, h, group).float()).to(q.dtype)


def flash_dkdv_plain(q, k, v, bias, do, lse, delta, h, sm_scale, causal,
                     group=1, q_off=0, k_off=0):
    """Plain dk, dv per q head (B*H, Sk, D): like k when group == 1, f32
    partials when group > 1 (the caller sums each group)."""
    p, ds = _probs_and_dscores(q, k, v, bias, do, lse, delta, h, sm_scale,
                               causal, group, q_off, k_off)
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    out_dtype = torch.float32 if group > 1 else k.dtype
    return dk.to(out_dtype), dv.to(out_dtype)


# ------------------------------------------------------------------ kernels --

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (BH, H, group, Sq, Sk, D), scale, causal[, q_off, k_off], is_bf16, stream
_SHAPE_ARGS = [_INT] * 6 + [_FLOAT, _INT, _INT, _PTR]
_OFFSET_ARGS = [_INT] * 6 + [_FLOAT, _INT, _INT, _INT, _INT, _PTR]
_ARGTYPES = {
    "flash_fwd": [_PTR] * 6 + _SHAPE_ARGS,
    # (BH, Sq, Sk, D), scale, causal, q_off, k_off, is_bf16, stream
    "flash_block_update": [_PTR] * 9 + [_INT] * 4 + [_FLOAT] + [_INT] * 4 + [_PTR],
    "flash_dq": [_PTR] * 8 + _OFFSET_ARGS,
    "flash_dkdv": [_PTR] * 9 + _OFFSET_ARGS,
}


def _library():
    lib = build.load("flash_attention")
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, bias, h, group, rows=(), grads=()):
    """Validate what the kernels take (``bias`` None: the block update,
    which takes none); returns (BH, Sq, Sk, D)."""
    f32 = tuple(t for t in (bias, *rows) if t is not None)
    tensors = (q, k, v, *f32, *grads)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention: all tensors must be on one device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash attention kernels take bf16 or f32, got {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, *grads)):
        raise TypeError("flash attention: q, k, v and dO must share a dtype")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("flash attention: bias, lse, delta, m and l must be f32")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash attention: want q (BH, Sq, D), k = v (BH/g, Sk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if (h < 1 or group < 1 or h % group or bh % h or k.shape[0] * group != bh
            or k.shape[2] != d):
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"do not fold {h} heads in groups of {group}")
    if bias is not None and tuple(bias.shape) != (bh // h, sk):
        raise ValueError(f"flash attention: bias must be (B, Sk) = {(bh // h, sk)}, "
                         f"got {tuple(bias.shape)}")
    if any(tuple(t.shape) != (bh, sq) for t in rows):
        raise ValueError("flash attention: lse, delta, m and l must be (BH, Sq)")
    if any(t.shape != q.shape for t in grads):
        raise ValueError("flash attention: dO must be shaped like q")
    if not 0 < d <= MAX_HEAD_DIM or sq == 0 or sk == 0:
        raise ValueError(f"flash attention kernels take 0 < D <= {MAX_HEAD_DIM} "
                         f"and non-empty S; got D={d}, Sq={sq}, Sk={sk}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention kernels take contiguous tensors")
    return bh, sq, sk, d


def _launch(name, ptrs, dims, sm_scale, causal, q, offsets=()):
    """Launch kernel ``name`` on the current stream; a None among ``ptrs``
    (no bias row) goes as a null pointer."""
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(*[None if t is None else t.data_ptr() for t in ptrs], *dims,
                                 float(sm_scale), int(bool(causal)),
                                 *[int(x) for x in offsets],
                                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def pad_head_dim(tensors, d):
    """The bf16 kernels' operands (and the carry's o) as TMA reads them:
    the head dim padded with zero columns to a multiple of 8 and every base
    16-byte aligned (a misaligned one is copied).  Returns (tensors, padded
    D)."""
    d8 = -(-d // 8) * 8
    out = []
    for t in tensors:
        if d8 != d:
            t = torch.nn.functional.pad(t, (0, d8 - d))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out, d8


def positive_scale(q, k, sm_scale):
    """(q, k, scale) with the same scores and scale > 0, which the bf16
    forward's exponent (one FFMA on the raw dots) needs: a negative scale
    flips k's sign, s * c = (-s) * (-c) bit for bit; a zero scale zeroes q,
    every score 0 as s * 0 is."""
    if sm_scale < 0:
        return q, -k, -sm_scale
    if sm_scale == 0:
        return torch.zeros_like(q), k, 1.0
    return q, k, sm_scale


def _device_kind(q):
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash attention runs on cuda (kernels) or cpu "
                           f"(plain versions), not {q.device}")
    return q.device.type


def flash_fwd(q, k, v, bias, h, sm_scale, causal, group=1):
    """Forward on folded tensors: q (B*H, Sq, D), k/v (B*H/g, Sk, D),
    bias (B, Sk) f32 or None -> (out like q, lse (B*H, Sq) f32)."""
    if _device_kind(q) == "cpu":
        return flash_fwd_plain(q, k, v, bias, h, sm_scale, causal, group)
    bh, sq, sk, d = _check(q, k, v, bias, h, group)
    dk = d
    if q.dtype == torch.bfloat16:
        q, k, sm_scale = positive_scale(q, k, sm_scale)
        (q, k, v), dk = pad_head_dim((q, k, v), d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, bias, out, lse), (bh, h, group, sq, sk, dk),
            sm_scale, causal, q)
    return (out if dk == d else out[..., :d].contiguous()), lse


def flash_block_update(q, k, v, m, l, o, q_off, k_off, causal=False,
                       sm_scale=None):
    """One ring step on folded tensors: q (BH, Sq, D), the visiting block k,
    v (BH, Sk, D), the carry m, l (BH, Sq) f32 and the unnormalised o (BH,
    Sq, D) f32, at global positions ``q_off``, ``k_off`` -> new (m, l, o).
    The inputs are left as they are."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _device_kind(q) == "cpu":
        return flash_block_update_plain(q, k, v, m, l, o, q_off, k_off, causal,
                                        sm_scale)
    bh, sq, sk, d = _check(q, k, v, None, 1, 1, rows=(m, l))
    if (o.dtype != torch.float32 or o.shape != q.shape or o.device != q.device
            or not o.is_contiguous()):
        raise ValueError(f"flash_block_update: o must be contiguous f32 shaped like q "
                         f"{tuple(q.shape)}, got {o.dtype} {tuple(o.shape)}")
    dk = d
    if q.dtype == torch.bfloat16:
        q, k, sm_scale = positive_scale(q, k, sm_scale)
        (q, k, v, o), dk = pad_head_dim((q, k, v, o), d)
    m2, l2, o2 = torch.empty_like(m), torch.empty_like(l), torch.empty_like(o)
    _launch("flash_block_update", (q, k, v, m, l, o, m2, l2, o2), (bh, sq, sk, dk),
            sm_scale, causal, q, offsets=(q_off, k_off))
    return m2, l2, (o2 if dk == d else o2[..., :d].contiguous())


def flash_dq(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group=1,
             q_off=0, k_off=0):
    """dq on folded tensors (see :func:`flash_fwd`); like q.  ``q_off`` and
    ``k_off`` place the blocks globally (ring attention); a block that no
    row sees gives zeros."""
    if _device_kind(q) == "cpu":
        return flash_dq_plain(q, k, v, bias, do, lse, delta, h, sm_scale,
                              causal, group, q_off, k_off)
    bh, sq, sk, d = _check(q, k, v, bias, h, group, rows=(lse, delta), grads=(do,))
    d8 = d
    if q.dtype == torch.bfloat16:
        (q, k, v, do), d8 = pad_head_dim((q, k, v, do), d)
    dq = torch.empty_like(q)
    _launch("flash_dq", (q, k, v, bias, do, lse, delta, dq),
            (bh, h, group, sq, sk, d8), sm_scale, causal, q, offsets=(q_off, k_off))
    return dq if d8 == d else dq[..., :d].contiguous()


def flash_dkdv(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group=1,
               q_off=0, k_off=0):
    """dk, dv per q head (B*H, Sk, D): like k when group == 1, f32 partials
    when group > 1.  Offsets as :func:`flash_dq`; keys that no row sees get
    zeros."""
    if _device_kind(q) == "cpu":
        return flash_dkdv_plain(q, k, v, bias, do, lse, delta, h, sm_scale,
                                causal, group, q_off, k_off)
    bh, sq, sk, d = _check(q, k, v, bias, h, group, rows=(lse, delta), grads=(do,))
    d8 = d
    if q.dtype == torch.bfloat16:   # TMA reads lse and delta too
        (q, k, v, do), d8 = pad_head_dim((q, k, v, do), d)
        lse, delta = (t.clone() if t.data_ptr() % 16 else t for t in (lse, delta))
    out_dtype = torch.float32 if group > 1 else k.dtype
    dk = torch.empty((bh, sk, d8), dtype=out_dtype, device=q.device)
    dv = torch.empty((bh, sk, d8), dtype=out_dtype, device=q.device)
    _launch("flash_dkdv", (q, k, v, bias, do, lse, delta, dk, dv),
            (bh, h, group, sq, sk, d8), sm_scale, causal, q, offsets=(q_off, k_off))
    if d8 != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def flash_bwd(q, k, v, bias, out, lse, do, h, sm_scale, causal, group=1):
    """(dq, dk, dv) on folded tensors, as ``_flash_bwd``."""
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = flash_dq(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group)
    dk, dv = flash_dkdv(q, k, v, bias, do, lse, delta, h, sm_scale, causal, group)
    if group > 1:   # per-q-head partials -> sum each kv-head group
        bh, sk, d = dk.shape
        b = bh // h
        dk = dk.view(b, h // group, group, sk, d).sum(2).view(-1, sk, d).to(k.dtype)
        dv = dv.view(b, h // group, group, sk, d).sum(2).view(-1, sk, d).to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, h, sm_scale, causal, group):
        out, lse = flash_fwd(q, k, v, bias, h, sm_scale, causal, group)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.config = (h, sm_scale, causal, group)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, out, lse, do, *ctx.config)
        # no gradient for a missing bias row (needs_input_grad is False)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None, None, None


def fold_heads(t):
    """(B, S, H', D) -> contiguous (B*H', S, D) (at B = 1 ``reshape`` alone
    can return a strided view)."""
    b, s, hh, d = t.shape
    return t.transpose(1, 2).reshape(b * hh, s, d).contiguous()


def _prepare(q, k, v, kv_mask, sm_scale):
    b, _, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {h_kv}")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    bias = None   # no key mask: no bias row, which the kernels then do not read
    if kv_mask is not None:
        bias = torch.where(kv_mask.to(q.device, torch.bool), 0.0, _NEG_INF).float()
    return bias, h, h // h_kv, float(sm_scale)


def unfold_heads(out, b, h):
    """(B*H, S, D) -> the (B, S, H, D) view."""
    bh, s, d = out.shape
    return out.view(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, causal=False, kv_mask=None, sm_scale=None):
    """Flash attention over (B, S, H, D) tensors; differentiable.

    ``k``/``v`` may carry fewer heads (GQA: H a multiple of their H_kv).
    ``kv_mask``: optional (B, S_k) boolean key-validity mask (False =
    padded key); fully masked rows give exact 0.  ``sm_scale`` defaults to
    1/sqrt(D).  CUDA tensors run the kernels, CPU tensors the plain versions.
    """
    bias, h, group, sm_scale = _prepare(q, k, v, kv_mask, sm_scale)
    out = _FlashAttention.apply(fold_heads(q), fold_heads(k), fold_heads(v), bias,
                                h, sm_scale, bool(causal), group)
    return unfold_heads(out, q.shape[0], h)


def attention_plain(q, k, v, causal=False, kv_mask=None, sm_scale=None):
    """The same function through :func:`flash_fwd_plain` on any device,
    differentiated by autograd: the kernel-free path (``attention_impl=
    "xla"``) that the kernels are held against on the card."""
    bias, h, group, sm_scale = _prepare(q, k, v, kv_mask, sm_scale)
    out, _ = flash_fwd_plain(fold_heads(q), fold_heads(k), fold_heads(v), bias, h,
                             sm_scale, bool(causal), group)
    return unfold_heads(out, q.shape[0], h)
