"""The port's CUDA kernels (flash attention and the ring block update,
fused batch and group norm, int8 quantization) against their plain
versions.

Needs an NVIDIA GPU and nvcc; every test is marked ``cuda`` and skips
without a GPU.  The file imports no JAX, so it also runs on a machine
that has only PyTorch (the repo's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Each case runs ``flash_attention`` forward and backward (the three
kernels) and ``attention_plain`` in f32 on the same inputs, at shapes that
test the bf16 forward's TMA boxes and wgmma layouts (D = 128, 40, 36, 32;
fewer tiles than SMs; a ragged S with GQA; GQA at D = 128, where dkdv
writes f32 partials in two boxes a row); the forward, dq and dkdv also at
a negative and a zero scale.  Tolerance:
relative Frobenius error <= 1e-2 for bf16 inputs (bf16 output and
operand rounding) and <= 1e-5 for f32 inputs (f32 sums in another order).

The ring kernels: ``flash_block_update`` and the offset ``flash_dq`` /
``flash_dkdv`` with the block on the diagonal, in the past and wholly in
the future, against their plain versions on the same inputs (m max-abs
<= 1e-3 in bf16 and 1e-5 in f32, everything else relative Frobenius as
above; a future block leaves the carry bitwise unchanged but for m's clamp
at the floor, and gives exact-zero gradients); and ``ring_attention`` on a
ring of one against ``attention_plain``, forward and backward.

Each norm case runs ``fused_batch_norm`` / ``fused_group_norm`` forward (the
kernel) and backward, and the plain version in f32 on the same inputs.
Tolerance: y max-abs <= 1e-2 * max(1, max|y|) in bf16 (output rounding)
and 1e-4 in f32; mean and var max-abs <= 1e-4 of their largest magnitude;
the gradients (plain closed form on both sides) relative Frobenius error
<= 1e-2 in bf16 and 1e-4 in f32.  A second run gives the same bits.

The quantization kernels (``quantize_int8``, ``dequant_sum``,
``equarx_hop``) are held bitwise against their plain versions (q, scales
and f32 sums equal to the last bit), on blocks with spread magnitudes, an
all-zero block, values on half-step ties and a NaN; ``dequant_sum`` and
``equarx_hop`` at D = 1, 2, 3, 4 and 8 peers (the hop's three mean modes)
with edge blocks that reach both of the hop's division paths (ties of the
mean, subnormal and tiny requantized scales, +-inf, NaN, zeros and -0);
``equarx_hop`` also against the unfused kernels ``quantize_int8(
dequant_sum(q, s) / n)``.
"""
import pytest
import torch

from autodist_tpu_torch.ops import flash_attention as tfa
from autodist_tpu_torch.ops import fused_norm as tfn
from autodist_tpu_torch.ops import quantize as tq
from autodist_tpu_torch.parallel.context import SeqAxis, seq_axis_context
from autodist_tpu_torch.parallel.ring_attention import ring_attention

# (B, S, H, H_kv, D, causal, masked, dtype)
CASES = {
    "bf16_causal_ragged": (2, 200, 4, 4, 64, True, False, "bfloat16"),
    "bf16_gqa_d40": (2, 129, 4, 2, 40, True, False, "bfloat16"),
    "bf16_kv_mask_d128": (2, 96, 2, 2, 128, False, True, "bfloat16"),
    "f32_causal_gqa": (2, 150, 4, 2, 32, True, False, "float32"),
    # the bf16 forward's TMA boxes and wgmma layouts: two boxes a tile,
    # boxes zero-filled past D, D padded to a multiple of 8 by the wrapper,
    # fewer tiles than SMs, a ragged S with GQA
    "bf16_causal_d128": (2, 384, 4, 4, 128, True, False, "bfloat16"),
    "bf16_causal_d32": (2, 256, 4, 4, 32, True, False, "bfloat16"),
    "bf16_full_d40": (2, 256, 4, 4, 40, False, False, "bfloat16"),
    "bf16_causal_d36_padded": (2, 130, 2, 2, 36, True, False, "bfloat16"),
    "bf16_small_grid": (1, 128, 2, 2, 64, True, False, "bfloat16"),
    "bf16_s1000_gqa": (2, 1000, 4, 2, 64, True, False, "bfloat16"),
    # the bias row read together with the causal diagonal's mask
    "bf16_kv_mask_causal_d64": (2, 200, 4, 4, 64, True, True, "bfloat16"),
    # dkdv's f32 GQA partials at two boxes a row
    "bf16_gqa_d128": (2, 300, 4, 2, 128, True, False, "bfloat16"),
}
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, h_kv, d, causal, masked, dtype = CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(heads):
        return torch.randn(b, s, heads, d, device="cuda", generator=g).to(getattr(torch, dtype))

    q, k, v, do = rand(h), rand(h_kv), rand(h_kv), rand(h)
    kv_mask = None
    if masked:
        kv_mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
        kv_mask[0, s // 2:] = False
        kv_mask[1] = False          # a fully masked example
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*inputs, causal=causal, kv_mask=kv_mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_block_update": 0, "flash_dq": 1,
                            "flash_dkdv": 1}
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref_out = tfa.attention_plain(*ref, causal=causal, kv_mask=kv_mask)
    ref_out.backward(do.float())
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out.detach(), *(t.grad for t in inputs)),
                               (ref_out.detach(), *(t.grad for t in ref))):
        assert got.dtype == getattr(torch, dtype) and bool(torch.isfinite(got).all())
        rel = float((got.float() - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= REL_TOL[dtype], (name, rel)
    if masked:
        assert not out[1].any() and not inputs[0].grad[1].any()


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


# (BH, Sq, Sk, D, causal, q_off, k_off, dtype): diagonal, past, future and a
# ragged non-causal block of another length
RING_CASES = {
    "bf16_diagonal": (6, 200, 200, 64, True, 200, 200, "bfloat16"),
    "bf16_past": (6, 200, 200, 64, True, 400, 0, "bfloat16"),
    "bf16_future": (6, 200, 200, 64, True, 0, 200, "bfloat16"),
    "bf16_full_sk77_d40": (6, 130, 77, 40, False, 0, 0, "bfloat16"),
    "bf16_past_d128": (4, 256, 256, 128, True, 256, 0, "bfloat16"),
    "bf16_diagonal_d128": (4, 300, 300, 128, True, 300, 300, "bfloat16"),
    "f32_diagonal_d40": (4, 150, 150, 40, True, 150, 150, "float32"),
    "f32_future": (4, 150, 150, 32, True, 150, 300, "float32"),
}
M_TOL = {"bfloat16": 1e-3, "float32": 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    bh, sq, sk, d, causal, q_off, k_off, dtype = RING_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(bh, sq, d, device="cuda", generator=g).to(dt) for _ in range(2))
    k, v = (torch.randn(bh, sk, d, device="cuda", generator=g).to(dt) for _ in range(2))
    m = torch.rand(bh, sq, device="cuda", generator=g) - 0.5   # an earlier block's carry
    m[0] = float("-inf")                                       # and the plain ring's seed
    l = torch.rand(bh, sq, device="cuda", generator=g) + 0.5
    l[0] = 0.0
    o = torch.randn(bh, sq, d, device="cuda", generator=g)
    o[0] = 0.0
    scale = d ** -0.5
    tfa.reset_launches()
    got = tfa.flash_block_update(q, k, v, m, l, o, q_off, k_off, causal, scale)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_block_update"] == 1
    want = tfa.flash_block_update_plain(q, k, v, m, l, o, q_off, k_off, causal, scale)
    assert float((got[0] - want[0]).abs().max()) <= M_TOL[dtype]
    for a, b in zip(got[1:], want[1:]):
        assert _rel(a, b) <= REL_TOL[dtype]
    future = causal and k_off > q_off + sq - 1
    if future:   # the carry passes through, m clamped at the floor
        assert torch.equal(got[0], m.clamp(min=tfa._M_FLOOR))
        assert torch.equal(got[1], l) and torch.equal(got[2], o)

    lse = torch.randn(bh, sq, device="cuda", generator=g) + 5.0
    delta = torch.randn(bh, sq, device="cuda", generator=g)
    args = (q, k, v, None, do, lse, delta, 2, scale, causal)   # the ring: no bias row
    offsets = dict(q_off=q_off, k_off=k_off)
    dq = tfa.flash_dq(*args, **offsets)
    dk, dv = tfa.flash_dkdv(*args, **offsets)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_dq"] == tfa.LAUNCHES["flash_dkdv"] == 1
    if future:   # outputs come from torch.empty: every row must be written
        assert not dq.any() and not dk.any() and not dv.any()
        return
    ref = (tfa.flash_dq_plain(*args, **offsets), *tfa.flash_dkdv_plain(*args, **offsets))
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert bool(torch.isfinite(a.float()).all()) and _rel(a, b) <= REL_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("sm_scale", [-0.3, 0.0, 0.25])
def test_bf16_forward_takes_any_scale(sm_scale):
    """The kernel's exponent needs a scale > 0; the wrapper turns any other
    into one with the same scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(8, 200, 64, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    out, lse = tfa.flash_fwd(q, k, v, None, 4, sm_scale, True)
    ref_out, ref_lse = tfa.flash_fwd_plain(q.float(), k.float(), v.float(), None, 4, sm_scale,
                                           True)
    assert _rel(out, ref_out) <= REL_TOL["bfloat16"]
    assert float((lse - ref_lse).abs().max()) <= M_TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("sm_scale", [-0.3, 0.0, 0.25])
def test_bf16_backward_takes_any_scale(sm_scale):
    """dq and dkdv take the scale as it is, of any sign: their exponent
    needs no max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn(8, 200, 64, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = tfa.flash_fwd_plain(*f32[:3], None, 4, sm_scale, True)
    delta = (f32[3] * out).sum(-1)
    args = (None, do, lse, delta, 4, sm_scale, True)
    got = (tfa.flash_dq(q, k, v, *args), *tfa.flash_dkdv(q, k, v, *args))
    f32_args = (None, f32[3], lse, delta, 4, sm_scale, True)
    want = (tfa.flash_dq_plain(*f32[:3], *f32_args), *tfa.flash_dkdv_plain(*f32[:3], *f32_args))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        if sm_scale == 0 and name != "dv":   # ds = p (dp - delta) * 0: zeros
            assert not a.any(), name
        else:
            assert _rel(a, b) <= REL_TOL["bfloat16"], (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_of_one_matches_plain_attention(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(2, 300, 4, 64, device="cuda", generator=g).to(
        getattr(torch, dtype)) for _ in range(4))
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.reset_launches()
    with seq_axis_context(SeqAxis(group=None, index=0, size=1)):
        out = ring_attention(*inputs, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_block_update": 1, "flash_dq": 1,
                            "flash_dkdv": 1}
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref_out = tfa.attention_plain(*ref, causal=True)
    ref_out.backward(do.float())
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out.detach(), *(t.grad for t in inputs)),
                               (ref_out.detach(), *(t.grad for t in ref))):
        assert _rel(got, want) <= REL_TOL[dtype], name


# (shape, num_groups (None: batch norm), act, residual, dtype)
NORM_CASES = {
    "bn_bf16_stem_like": ((8, 56, 56, 64), None, None, False, "bfloat16"),
    "bn_bf16_ragged_c100_scalar": ((1000, 100), None, "relu", True, "bfloat16"),
    "bn_f32_odd_relu_residual": ((1000, 100), None, "relu", True, "float32"),
    "bn_f32_c30_scalar": ((7, 9, 30), None, None, False, "float32"),
    "gn_bf16_32_groups": ((4, 28, 28, 256), 32, None, False, "bfloat16"),
    "gn_bf16_2_per_group": ((4, 28, 28, 64), 32, None, False, "bfloat16"),
    "gn_f32_odd_relu_residual": ((3, 37, 30), 10, "relu", True, "float32"),
}
NORM_Y_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
NORM_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _norm_run(x, scale, bias, res, groups, act):
    if groups is None:
        return tfn.fused_batch_norm(x, scale, bias, act=act, residual=res)
    return (tfn.fused_group_norm(x, scale, bias, groups, act=act, residual=res),)


def _norm_plain(x, scale, bias, res, groups, act):
    if groups is None:
        return tfn.batch_norm_plain(x, scale, bias, act=act, residual=res)
    return (tfn.group_norm_plain(x, scale, bias, groups, act=act, residual=res),)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_norm_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    shape, groups, act, has_res, dtype = NORM_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(1)
    c = shape[-1]
    x = (torch.randn(*shape, device="cuda", generator=g) * 2
         + torch.rand(c, device="cuda", generator=g)).to(getattr(torch, dtype))
    res = torch.randn(*shape, device="cuda", generator=g).to(x.dtype) if has_res else None
    scale = torch.rand(c, device="cuda", generator=g) + 0.5
    bias = torch.randn(c, device="cuda", generator=g) * 0.1
    dy = torch.randn(*shape, device="cuda", generator=g).to(x.dtype)
    inputs = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    tfn.reset_launches()
    outs = _norm_run(*inputs, res, groups, act)
    outs[0].backward(dy)
    again = _norm_run(x, scale, bias, res, groups, act)
    torch.cuda.synchronize()
    assert tfn.LAUNCHES == {"bn_fwd": 2 * (groups is None), "gn_fwd": 2 * (groups is not None)}
    for a, b in zip(outs, again):
        assert torch.equal(a.detach(), b), "two runs differ"
    ref = [t.detach().float().requires_grad_(True) for t in (x, scale, bias)]
    ref_outs = _norm_plain(*ref, None if res is None else res.float(), groups, act)
    ref_outs[0].backward(dy.float())
    y, want = outs[0].detach(), ref_outs[0].detach()
    assert y.dtype == x.dtype and bool(torch.isfinite(y).all())
    err = float((y.float() - want).abs().max())
    assert err <= NORM_Y_TOL[dtype] * max(1.0, float(want.abs().max())), err
    for got, w in zip(outs[1:], ref_outs[1:]):
        assert float((got.detach() - w).abs().max()) <= 1e-4 * float(w.abs().max())
    for got, w in zip((t.grad for t in inputs), (t.grad for t in ref)):
        rel = float((got.float() - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= NORM_GRAD_TOL[dtype], rel


def _quant_blocks(n, g):
    """(n, 256) f32 on the card: spread magnitudes, a zero block (row 1) and
    a block of half-step ties whose scale is exactly 1 (row 2)."""
    x = torch.randn(n, tq.BLOCK, device="cuda", generator=g) * torch.exp(
        torch.rand(n, 1, device="cuda", generator=g) * 16 - 8)
    x[1] = 0.0
    x[2] = torch.arange(tq.BLOCK, device="cuda", dtype=torch.float32) % 64 - 31.5
    x[2, 0] = -127.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 1001, 8192])
def test_quantize_kernel_matches_plain_version(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = _quant_blocks(n, torch.Generator(device="cuda").manual_seed(n))
    x[0, 5] = float("nan")
    tq.reset_launches()
    q, s = tq.quantize_int8(x)
    pq, ps = tq.quantize_int8(x, impl="plain")
    torch.cuda.synchronize()
    assert tq.LAUNCHES["quantize_int8"] == 1
    assert torch.isnan(s[0]).all() and torch.isnan(ps[0]).all()   # NaN poisons its block
    assert torch.equal(q, pq) and not q[0].any() and torch.equal(s[1:], ps[1:])
    assert not q[1].any() and float(s[1]) == 1.0 and float(s[2]) == 1.0
    assert torch.equal(q[2].cpu(), torch.round(x[2].cpu()).to(torch.int8))   # half to even


def _hop_peers(d, n, g):
    """Peers (q, s) for the hop: quantized spread blocks, rows 0-9 the edge
    blocks (as ``chip_smoke.hop_case``): half-step ties of the mean at
    requantized scales 1 and 2^-20 (the reciprocal path), subnormal
    requantized scales (one where x / s reaches 190 and clamps), a normal
    scale below 2^-96, +-inf among finite values, a NaN, an inf times a q of
    0 (NaN), all zeros and all -0 (rows 6 and 7 have NaN scales)."""
    q, s = tq.quantize_int8(_quant_blocks(d * n, g))
    q, s = q.view(d, n, tq.BLOCK), s.view(d, n, 1)

    def rand_q(lo, hi):
        return torch.randint(lo, hi + 1, (tq.BLOCK,), device="cuda", generator=g,
                             dtype=torch.int8)

    q[:, :10] = 0
    for row, j in ((0, 0), (1, -20)):   # mean = 63.5 * 2^j * k, scale 2^j
        s[:, row] = 63.5 * d * 2.0 ** j
        q[0, row] = rand_q(-2, 2)
        q[0, row, 0] = 2
        for a in range(1, d - 1, 2):
            x = rand_q(-127, 127)
            q[a, row], q[a + 1, row] = x, -x
    for row, scale, top in ((2, 2.0 ** -149, 127), (3, 2.0 ** -148, 95)):
        s[:, row] = scale
        for a in range(d):
            q[a, row] = rand_q(-top, top)
        q[:, row, 0] = top
    s[:, 4] = 2.0 ** -110
    for a in range(d):
        q[a, 4] = rand_q(-127, 127)
    s[:, 5] = 3e38
    q[0, 5] = rand_q(-1, 1)
    q[0, 5, 7], q[0, 5, 8] = 127, -127
    s[0, 6] = float("nan")
    q[0, 6] = rand_q(1, 127)
    s[0, 7] = float("inf")
    q[0, 7] = rand_q(1, 127)
    q[0, 7, 3] = 0
    s[:, 8] = 1.0
    s[:, 9] = -1.0
    return q, s


def _assert_hop_equal(got, want):
    (q, s), (wq, ws) = got, want
    assert torch.isnan(s[6:8]).all() and torch.isnan(ws[6:8]).all()   # NaN poisons its block
    assert torch.equal(q, wq) and not q[6:8].any()
    keep = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    keep[6:8] = False
    assert torch.equal(s[keep], ws[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_dequant_sum_and_equarx_hop_kernels_match_plain_versions(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(d)
    q, s = _hop_peers(d, 1001, g)
    tq.reset_launches()
    total = tq.dequant_sum(q, s)
    q2, s2 = tq.equarx_hop(q, s, d)
    uq, us = tq.quantize_int8(tq.true_divide(total, d))
    torch.cuda.synchronize()
    assert tq.LAUNCHES == {"quantize_int8": 1, "dequant_sum": 1, "equarx_hop": 1}
    want = tq.dequant_sum(q, s, impl="plain")
    assert torch.equal(total.isnan(), want.isnan())
    assert torch.equal(total.nan_to_num(), want.nan_to_num())
    _assert_hop_equal((q2, s2), tq.equarx_hop(q, s, d, impl="plain"))
    _assert_hop_equal((q2, s2), (uq, us))     # the EQuARX contract
    assert torch.equal(q2[0].cpu(), torch.round(total[0].cpu() / d).to(torch.int8))  # ties
