"""Streaming vocabulary cross entropy: the LM loss without the logits
(counterpart of ``autodist_tpu/ops/losses.py``).

The ``(N, V)`` logits of a decoder LM's output projection are its largest
training allocation (GPT-2 small at B=8, S=1024: 1.65 GB in f32, and its
softmax and gradient as much again).  :func:`streaming_softmax_xent`
never builds them: the projection and the cross entropy run over vocab
chunks with an online log-sum-exp, and the backward recomputes each
chunk's logits from the saved ``(hidden, lse)``, so the peak is one
``(N, chunk)`` block instead of ``(N, V)``, at one more chunk product per
backward step.

A vocab that the chunk does not divide keeps the chunk size: the final
chunk's start is clamped so that it ends at ``V``, and its columns that an
earlier chunk covered are masked to ``-inf``.  The table is used as stored,
``(V, D)`` (``layout="vd"``, a tied embedding) or ``(D, V)``
(``layout="dv"``, a head kernel), and never copied or transposed.

The chunk products are ``torch.matmul`` in f32, as JAX's ``dot_general``
with ``preferred_element_type=f32`` computes them: a bf16 hidden or table
is promoted to f32 first (bf16 x bf16 products are exact in f32).  The
backward's ``dh`` and ``dW`` accumulate in f32 and are cast to the
operands' dtypes at the end; ``dW`` is a full-shape f32 carry into which
each chunk adds its block at the chunk's clamped start (the non-fresh
columns have p = 0 and no target, so the overlapping add is exact).
"""
import torch

_LAYOUTS = ("vd", "dv")


def _vocab_axis(layout):
    return 0 if layout == "vd" else 1


def _n_chunks(v, chunk):
    return -(-v // chunk)


def _chunk_start(c, chunk, v):
    """Clamped start of chunk ``c``: the final chunk of a vocab that the
    chunk does not divide slides back to end at ``v``."""
    return min(c * chunk, v - chunk)


def _chunk_weight(table, c, chunk, v, layout):
    """(start, the chunk's rows of the table as an f32 ``(chunk, D)`` or
    ``(D, chunk)`` view, or copy for a non-f32 table)."""
    start = _chunk_start(c, chunk, v)
    return start, table.narrow(_vocab_axis(layout), start, chunk).float()


def _masked_chunk_logits(hf, w_c, c, chunk, start, layout):
    """(N, chunk) f32 logits of the chunk, the columns an earlier chunk
    covered at -inf (fresh: global column >= c * chunk; chunk 0 is all
    fresh, so the online max never sees a row of -inf only)."""
    logits = hf @ (w_c.t() if layout == "vd" else w_c)
    stale = c * chunk - start
    if stale > 0:
        logits[:, :stale] = float("-inf")
    return logits


def _target_hits(targets, c, chunk, start):
    """((N,) True where the row's target is a fresh column of chunk c,
    (N, 1) that column, clamped into the chunk for the other rows); no
    host synchronisation."""
    fresh = (targets >= c * chunk) & (targets < start + chunk)
    return fresh, (targets - start).clamp(0, chunk - 1)[:, None]


def _forward_scan(hf, table, targets, chunk, layout):
    """(lse, target logit), each (N,) f32: the online log-sum-exp over the
    chunks, and each row's target logit read in its chunk."""
    n, v = hf.shape[0], table.shape[_vocab_axis(layout)]
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=hf.device)
    s = torch.zeros((n,), dtype=torch.float32, device=hf.device)
    tl = torch.zeros((n,), dtype=torch.float32, device=hf.device)
    for c in range(_n_chunks(v, chunk)):
        start, w_c = _chunk_weight(table, c, chunk, v, layout)
        logits = _masked_chunk_logits(hf, w_c, c, chunk, start, layout)
        fresh, col = _target_hits(targets, c, chunk, start)
        tl = torch.where(fresh, logits.gather(1, col)[:, 0], tl)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + logits.sub_(m_new[:, None]).exp_().sum(dim=-1)
        m = m_new
    return m + torch.log(s), tl


class _StreamingLseAndTarget(torch.autograd.Function):
    """(lse, target logit) of ``h @ table^T`` per row; saves ``(h, table,
    targets, lse)``, never the logits."""

    @staticmethod
    def forward(ctx, h, table, targets, chunk, layout):
        lse, tl = _forward_scan(h.float(), table, targets, chunk, layout)
        ctx.save_for_backward(h, table, targets, lse)
        ctx.config = (chunk, layout)
        return lse, tl

    @staticmethod
    def backward(ctx, g_lse, g_tl):
        h, table, targets, lse = ctx.saved_tensors
        chunk, layout = ctx.config
        want_h, want_w = ctx.needs_input_grad[:2]
        hf = h.float()
        axis = _vocab_axis(layout)
        v = table.shape[axis]
        dh = torch.zeros(hf.shape, dtype=torch.float32, device=h.device) if want_h else None
        dw = torch.zeros(table.shape, dtype=torch.float32, device=h.device) if want_w else None
        for c in range(_n_chunks(v, chunk)):
            start, w_c = _chunk_weight(table, c, chunk, v, layout)
            # the softmax block, then dlogits = p * g_lse + onehot * g_tl in place
            dlogits = _masked_chunk_logits(hf, w_c, c, chunk, start, layout)
            dlogits.sub_(lse[:, None]).exp_().mul_(g_lse[:, None])
            fresh, col = _target_hits(targets, c, chunk, start)
            dlogits.scatter_add_(1, col, (g_tl * fresh)[:, None])
            if want_h:
                dh.addmm_(dlogits, w_c if layout == "vd" else w_c.t())
            if want_w:
                block = dw.narrow(axis, start, chunk)
                if layout == "vd":
                    block.addmm_(dlogits.t(), hf)
                else:
                    block.addmm_(hf.t(), dlogits)
        return (None if dh is None else dh.to(h.dtype),
                None if dw is None else dw.to(table.dtype), None, None, None)


def streaming_softmax_xent(hidden, table, targets, valid=None, chunk=8192, bias=None,
                           layout="vd"):
    """Weighted mean next-token cross entropy of the output projection,
    without the logits.

    ``hidden``: (..., D) activations; ``table``: (V, D) for ``layout="vd"``
    or (D, V) for ``"dv"``, as stored; ``targets``: (...,) ids, negative
    ids ignored; ``valid``: optional (...,) weights that multiply the
    target mask in the numerator and the denominator (the dense
    ``gpt_loss``'s semantics); ``bias``: optional (V,) logit bias, folded in
    as a ones column of ``hidden`` and a bias column of the table;
    ``chunk``: vocab rows per step.  Returns the same value as the dense
    computation.
    """
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be 'vd' or 'dv', got {layout!r}")
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    t = targets.reshape(-1)
    weights = (t >= 0).float()
    if valid is not None:
        weights = weights * valid.reshape(-1).float()
    safe_t = torch.where(t >= 0, t, torch.zeros_like(t)).long()
    if bias is not None:
        h = torch.cat([h, torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device)], dim=1)
        column = bias.to(table.dtype)
        table = (torch.cat([table, column[:, None]], dim=1) if layout == "vd"
                 else torch.cat([table, column[None, :]], dim=0))
    chunk = min(int(chunk), table.shape[_vocab_axis(layout)])
    lse, tl = _StreamingLseAndTarget.apply(h, table, safe_t, chunk, layout)
    nll = (lse - tl) * weights
    return nll.sum() / torch.clamp(weights.sum(), min=1.0)
