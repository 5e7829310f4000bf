"""Ring attention and Ulysses attention: sequence parallelism over the seq
axis (counterpart of ``autodist_tpu/parallel/ring_attention.py``).

The sequence dimension is sharded over the ranks of a seq row (the
:class:`~autodist_tpu_torch.parallel.context.SeqAxis` of the current
:func:`~autodist_tpu_torch.parallel.context.seq_axis_context`; none is a
ring of one): rank ``i`` of ``R`` holds positions ``[i * S, (i + 1) * S)``
of q, k and v.  :func:`ring_attention` keeps its q block and streams the
K/V blocks around the ring with
:func:`~autodist_tpu_torch.parallel.collectives.ppermute`, folding each
into a numerically stable online softmax, causal over global positions.

Under ``impl="auto"``/``"flash"`` each ring step is a flash kernel, and the
whole is a :class:`torch.autograd.Function` with the two ring passes of
JAX's ``_make_ring_flash``:

- forward: the ``(m, l, o)`` carry starts at ``(_M_FLOOR, 0, 0)`` and
  takes one :func:`~autodist_tpu_torch.ops.flash_attention.flash_block_update`
  per step, at ``q_off = i * S`` and ``k_off = blk * S`` for the visiting
  block ``blk = (i - step) mod R``; out is ``o * (1 / l)`` and lse
  ``m + log l``;
- backward: a second ring pass in which :func:`flash_dq` and
  :func:`flash_dkdv` take the same offsets; dq accumulates here in f32,
  while each block's dk and dv travel the ring with it and arrive home
  summed after R hops.

The kernels run on CUDA tensors, their plain versions on CPU tensors.
Under ``impl="xla"`` each step is :func:`_online_block` in plain torch and
the ring is differentiated by autograd through
:func:`~autodist_tpu_torch.parallel.collectives.ppermute_ad`.  JAX's
``_pcast_varying`` has no counterpart: it is a device of JAX's type system.
The last hop of the forward brings the K/V blocks home and changes no
result, so neither ring makes it.

:func:`all_to_all_attention` (Ulysses) re-shards sequence -> heads with an
all-to-all, runs full-sequence :func:`flash_attention` on a head subset
and re-shards back; no model uses it, as in JAX.
"""
import torch

from autodist_tpu_torch.ops.flash_attention import (_M_FLOOR, flash_attention,
                                                    flash_block_update, flash_dkdv, flash_dq,
                                                    fold_heads, unfold_heads, use_flash)
from autodist_tpu_torch.parallel.collectives import all_to_all, ppermute, ppermute_ad, ring_perm
from autodist_tpu_torch.parallel.context import SeqAxis, current_seq_axis

_ONE = SeqAxis(group=None, index=0, size=1)


def _seq_axis():
    return current_seq_axis() or _ONE


def _online_block(q, k_blk, v_blk, bias_blk, m, l, o, scale):
    """One block update of the plain ring.  q (B, Sq, H, D), k/v (B, Sk, H,
    D), m/l (B, H, Sq), o (B, Sq, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if bias_blk is not None:
        s = s + bias_blk
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    return m_new, l_new, o_new


def _ring_forward(qf, kf, vf, scale, causal, axis):
    """The flash ring's forward on folded (BH, S, D) blocks: (out, lse)."""
    bh, sq, d = qf.shape
    perm = ring_perm(axis.size)
    m = torch.full((bh, sq), _M_FLOOR, dtype=torch.float32, device=qf.device)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=qf.device)
    o = torch.zeros((bh, sq, d), dtype=torch.float32, device=qf.device)
    k_blk, v_blk = kf, vf
    for step in range(axis.size):
        blk = (axis.index - step) % axis.size
        m, l, o = flash_block_update(qf, k_blk, v_blk, m, l, o, axis.index * sq, blk * sq,
                                     causal=causal, sm_scale=scale)
        if step < axis.size - 1:
            k_blk, v_blk = ppermute((k_blk, v_blk), axis.group, perm)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    # o * (1 / l), as the bf16 forward kernel normalises: a ring of one
    # gives flash_attention's bits
    return (o * (1.0 / denom)[..., None]).to(qf.dtype), m + torch.log(denom)


def _ring_backward(qf, kf, vf, out, lse, do, h, scale, causal, axis):
    """The flash ring's backward: (dq, dk, dv) of this rank's blocks."""
    bh, sq, d = qf.shape
    perm = ring_perm(axis.size)
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = torch.zeros((bh, sq, d), dtype=torch.float32, device=qf.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    k_blk, v_blk = kf, vf
    for step in range(axis.size):
        blk = (axis.index - step) % axis.size
        offsets = dict(q_off=axis.index * sq, k_off=blk * sq)
        # the ring has no key mask: no bias row
        dq_p = flash_dq(qf, k_blk, v_blk, None, do, lse, delta, h, scale, causal, **offsets)
        dk_p, dv_p = flash_dkdv(qf, k_blk, v_blk, None, do, lse, delta, h, scale, causal,
                                **offsets)
        dq += dq_p.float()
        dk += dk_p.float()
        dv += dv_p.float()
        # the gradients travel the ring with their block: home after R hops
        if step < axis.size - 1:
            k_blk, v_blk, dk, dv = ppermute((k_blk, v_blk, dk, dv), axis.group, perm)
        else:
            dk, dv = ppermute((dk, dv), axis.group, perm)
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qf, kf, vf, h, scale, causal, axis):
        out, lse = _ring_forward(qf, kf, vf, scale, causal, axis)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.config = (h, scale, causal, axis)
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        return (*_ring_backward(qf, kf, vf, out, lse, do, *ctx.config),
                None, None, None, None)


def _ring_plain(q, k, v, causal, axis):
    """The plain ring (``impl="xla"``), differentiated by autograd."""
    b, sq, h, d = q.shape
    scale = float(1.0 / torch.tensor(float(d), dtype=q.dtype).sqrt())
    q_pos = axis.index * sq + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    perm = ring_perm(axis.size)
    qf = q.float()
    k_blk, v_blk = k, v
    for step in range(axis.size):
        blk = (axis.index - step) % axis.size
        bias = None
        if causal:
            k_pos = blk * sq + torch.arange(sq, device=q.device)
            bias = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0, float("-inf"))[None, None]
        m, l, o = _online_block(qf, k_blk.float(), v_blk.float(), bias, m, l, o, scale)
        if step < axis.size - 1:
            k_blk = ppermute_ad(k_blk, axis.group, perm)
            v_blk = ppermute_ad(v_blk, axis.group, perm)
    # rows with no visible key have l == 0: their output is 0
    denom = torch.where(l == 0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, causal=False, impl="auto"):
    """Blockwise ring attention over the current seq axis.

    q, k, v: this rank's blocks (B, S_local, H, D), rank i of the seq row
    holding positions ``[i * S_local, (i + 1) * S_local)``; k and v carry
    all H heads.  ``causal`` masks over global positions.  ``impl``:
    "auto"/"flash" (the flash kernels on CUDA, their plain versions on the
    CPU) or "xla" (the plain ring, autograd).  Returns this rank's output
    block (B, S_local, H, D); differentiable.
    """
    axis = _seq_axis()
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape (B, S, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not use_flash(impl):
        return _ring_plain(q, k, v, causal, axis)
    b, _, h, d = q.shape
    out = _RingFlash.apply(fold_heads(q), fold_heads(k), fold_heads(v), h,
                           1.0 / (d ** 0.5), bool(causal), axis)
    return unfold_heads(out, b, h)


def all_to_all_attention(q, k, v, causal=False):
    """Ulysses sequence parallelism over the current seq axis: an all-to-all
    swaps the sharded dim from sequence to heads, each rank runs
    full-sequence :func:`flash_attention` on its H / R heads, and the
    inverse all-to-all restores sequence sharding.  Needs H % R == 0."""
    axis = _seq_axis()
    heads = q.shape[2]
    if heads % axis.size:
        raise ValueError(f"num_heads {heads} must divide by axis size {axis.size}")

    def seq_to_heads(x):   # (B, S_local, H, D) -> (B, S, H / R, D)
        return all_to_all(x, axis.group, split_axis=2, concat_axis=1)

    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal)
    return all_to_all(out, axis.group, split_axis=1, concat_axis=2)
