"""The port's flash attention against the JAX package's Pallas kernel.

The same numpy inputs go through ``autodist_tpu.ops.pallas.flash_attention``
(Pallas interpret mode on the CPU, as its own tests run it) and through
``autodist_tpu_torch.ops.flash_attention`` on CPU tensors, where the
wrappers run the kernels' plain versions.  Forward output, logsumexp and
dq/dk/dv (``jax.grad`` vs ``torch.autograd``) are compared in f32:
out and lse to atol 1e-5, gradients to atol 1e-4 (f32 sums taken in
another order).  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).

Without a key mask the port passes no bias row (``bias=None``): the plain
forward, dq and dkdv give the same bits as with a zero row, and
``flash_attention`` still matches the JAX kernel.  The bf16 forward
kernel's operand rules have CPU-side stand-ins held here to the bit (a
scale <= 0 made positive) or to 1e-6 (D padded to a multiple of 8: the
forward's output and the backward's dq, dk and dv).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_worker as worker
from autodist_tpu.ops.pallas import flash_attention as jfa
from autodist_tpu_torch.ops import flash_attention as tfa

OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4

# (B, Sq, Sk, H, H_kv, D, causal, masked)
CASES = {
    "full": (2, 32, 32, 2, 2, 16, False, False),
    "causal": (2, 48, 48, 4, 4, 16, True, False),
    "kv_mask_fully_masked_example": (2, 32, 32, 2, 2, 16, False, True),
    "gqa_g2_causal": (2, 32, 32, 4, 2, 16, True, False),
    "rectangular_sq_ne_sk": (2, 32, 48, 2, 2, 16, False, False),
    "causal_d24": (2, 40, 40, 2, 2, 24, True, False),
    "gqa_g2_full_d24": (2, 40, 40, 4, 2, 24, False, False),
    "gqa_g4_causal": (1, 48, 48, 4, 1, 16, True, False),
}


def _inputs(b, sq, sk, h, hkv, d, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, sk), bool)
        mask[0, sk // 2:] = False   # ragged padding
        mask[1, :] = False          # a fully padded example
    return q, k, v, do, mask


def _jax_out_and_grads(case):
    """The Pallas kernel's output and gradients (interpret mode) on the
    case's inputs."""
    b, sq, sk, h, hkv, d, causal, masked = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, h, hkv, d, masked)
    kv_mask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, causal=causal, kv_mask=kv_mask,
                                  interpret=True)
        return jnp.sum(out * do), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


worker.submit(*((_jax_out_and_grads, case) for case in sorted(CASES)))


def _torch_out_and_grads(q, k, v, do, mask, causal):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kv_mask = None if mask is None else torch.from_numpy(mask)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, kv_mask=kv_mask)
    (out * torch.from_numpy(do)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_pallas(case):
    b, sq, sk, h, hkv, d, causal, masked = CASES[case]
    q, k, v, do, mask = _inputs(b, sq, sk, h, hkv, d, masked)
    if not masked:   # no key mask, no bias row
        assert tfa._prepare(*(torch.from_numpy(x) for x in (q, k, v)), None, None)[0] is None
    j_out, j_grads = worker.result(_jax_out_and_grads, case)
    t_out, t_grads = _torch_out_and_grads(q, k, v, do, mask, causal)
    np.testing.assert_allclose(t_out, j_out, atol=OUT_ATOL, rtol=0)
    for name, tg, jg in zip("qkv", t_grads, j_grads):
        np.testing.assert_allclose(tg, jg, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")
    if masked:   # the fully padded example is exact zeros, fwd and bwd
        assert not t_out[1].any() and not t_grads[0][1].any()


@pytest.mark.parametrize("causal,group", [(True, 1), (False, 2)])
def test_forward_lse_matches_pallas_fwd(causal, group):
    """The folded forward's logsumexp rows against ``_flash_fwd``."""
    b, s, h, d = 2, 32, 4, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b * h, s, d)).astype(np.float32)
    k = rng.standard_normal((b * h // group, s, d)).astype(np.float32)
    v = rng.standard_normal((b * h // group, s, d)).astype(np.float32)
    bias = np.zeros((b, s), np.float32)
    bias[0, 20:] = -1e30
    scale = d ** -0.5
    j_out, j_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(bias), h, scale, causal, s, s, True,
                                  group=group)
    t_out, t_lse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                                 h, scale, causal, group)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=OUT_ATOL, rtol=0)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    tfa.reset_launches()
    q = torch.randn(4, 8, 16)
    k = torch.randn(2, 8, 16)
    bias = torch.zeros(1, 8)
    out, lse = tfa.flash_fwd(q, k, k, bias, 4, 0.25, True, group=2)
    p_out, p_lse = tfa.flash_fwd_plain(q, k, k, bias, 4, 0.25, True, group=2)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    delta = torch.zeros(4, 8)
    dk, dv = tfa.flash_dkdv(q, k, k, bias, q, lse, delta, 4, 0.25, True, group=2)
    assert dk.shape == (4, 8, 16) and dk.dtype == torch.float32  # per-q-head partials
    assert all(n == 0 for n in tfa.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="cuda"):
        tfa.flash_fwd(q.to("meta"), k.to("meta"), k.to("meta"), bias.to("meta"),
                      4, 0.25, True, group=2)


# Without a key mask there is no bias row (``bias=None``): the kernels read
# none.  A zero row adds exact zeros, so the plain versions give the same
# bits either way; (causal, group) as the model paths use them.
NO_BIAS_CASES = [(False, 1), (True, 1), (False, 2), (True, 2)]


@pytest.mark.parametrize("causal,group", NO_BIAS_CASES)
def test_no_bias_row_is_bitwise_a_zero_row(causal, group):
    b, s, h, d = 2, 24, 4, 16
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((b * h, s, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b * h // group, s, d)).astype(np.float32))
            for _ in range(2))
    zero = torch.zeros(b, s)
    cfg = (h, d ** -0.5, causal, group)
    out, lse = tfa.flash_fwd(q, k, v, None, *cfg)
    z_out, z_lse = tfa.flash_fwd(q, k, v, zero, *cfg)
    assert torch.equal(out, z_out) and torch.equal(lse, z_lse)
    delta = (do * out).sum(-1)
    grads = tfa.flash_bwd(q, k, v, None, out, lse, do, *cfg)
    z_grads = tfa.flash_bwd(q, k, v, zero, out, lse, do, *cfg)
    for name, a, z in zip(("dq", "dk", "dv"), grads, z_grads):
        assert torch.equal(a, z), name
    assert torch.equal(tfa.flash_dq(q, k, v, None, do, lse, delta, *cfg),
                       tfa.flash_dq(q, k, v, zero, do, lse, delta, *cfg))


@pytest.mark.parametrize("sm_scale", [-0.3, 0.0, 0.25])
def test_positive_scale_keeps_the_scores(sm_scale):
    """The bf16 forward kernel takes a scale > 0; the wrapper's stand-in
    (k negated, or q zeroed) gives the same plain forward to the bit."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 20, 16)).astype(np.float32))
               for _ in range(3))
    q2, k2, scale2 = tfa.positive_scale(q, k, sm_scale)
    assert scale2 > 0
    for causal in (False, True):
        want = tfa.flash_fwd_plain(q, k, v, None, 2, sm_scale, causal)
        got = tfa.flash_fwd_plain(q2, k2, v, None, 2, scale2, causal)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [36, 20, 64])
def test_padded_head_dim_keeps_the_output(d):
    """Zero columns appended to q, k, v (D to a multiple of 8, as TMA reads
    rows) change no score: with the true D's scale the output's first D
    columns and the logsumexp are the unpadded ones (f32 sums taken over
    more terms: 1e-6)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 30, d)).astype(np.float32))
               for _ in range(3))
    (qp, kp, vp), d8 = tfa.pad_head_dim((q, k, v), d)
    assert d8 % 8 == 0 and d8 - d < 8 and qp.shape[-1] == d8
    assert not qp[..., d:].any() and torch.equal(qp[..., :d], q)
    out, lse = tfa.flash_fwd_plain(q, k, v, None, 2, d ** -0.5, True)
    p_out, p_lse = tfa.flash_fwd_plain(qp, kp, vp, None, 2, d ** -0.5, True)
    np.testing.assert_allclose(p_out[..., :d].numpy(), out.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(p_lse.numpy(), lse.numpy(), atol=1e-6, rtol=0)
    assert not p_out[..., d:].any()


@pytest.mark.parametrize("d", [36, 20, 64])
def test_padded_head_dim_keeps_the_gradients(d):
    """The bf16 dq and dkdv take the forward's padded operands: zero
    columns appended to q, k, v and dO change no score and no dp, so dq,
    dk and dv of the padded operands, sliced to D, are the unpadded ones
    and their extra columns are zero (f32 sums over more terms: 1e-6).
    The scale goes as it is, negative too (no ``positive_scale``)."""
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, 30, d)).astype(np.float32))
                   for _ in range(4))
    (qp, kp, vp, dop), d8 = tfa.pad_head_dim((q, k, v, do), d)
    for scale in (d ** -0.5, -0.3):
        out, lse = tfa.flash_fwd_plain(q, k, v, None, 2, scale, True)
        delta = (do * out).sum(-1)
        args = (None, do, lse, delta, 2, scale, True)
        p_args = (None, dop, lse, delta, 2, scale, True)
        want = (tfa.flash_dq_plain(q, k, v, *args), *tfa.flash_dkdv_plain(q, k, v, *args))
        got = (tfa.flash_dq_plain(qp, kp, vp, *p_args),
               *tfa.flash_dkdv_plain(qp, kp, vp, *p_args))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape[-1] == d8 and not g[..., d:].any(), name
            np.testing.assert_allclose(g[..., :d].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("b", [1, 2])
def test_fold_heads_is_contiguous(b):
    """The kernels take contiguous folds; at B = 1 a bare reshape of the
    transpose is a strided view."""
    t = torch.randn(b, 8, 3, 4)
    f = tfa.fold_heads(t)
    assert f.is_contiguous() and f.shape == (b * 3, 8, 4)
    assert torch.equal(tfa.unfold_heads(f, b, 3), t)
