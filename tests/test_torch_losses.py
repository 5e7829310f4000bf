"""The port's streaming vocabulary cross entropy against the JAX package's.

``autodist_tpu_torch.ops.losses.streaming_softmax_xent`` and
``autodist_tpu.ops.losses.streaming_softmax_xent`` take the same numpy
inputs (``tests/test_losses.py``'s N=24, D=16, V=96, a fifth of the
targets ignored) at chunks 96, 32, 7 and 50 (7 and 50 do not divide 96:
the clamped, masked final chunk) in both table layouts, with a bias, with
binary and non-binary ``valid`` weights, with every position ignored, and
with a bf16 hidden.  Loss and the gradients with respect to ``hidden`` and
``table`` are compared at ``tests/test_losses.py``'s tolerances: loss rtol
1e-6 (1e-5 for the bf16 hidden), gradients rtol 2e-5, atol 1e-6 (the bf16
hidden's own gradient within one bf16 rounding, rtol 2^-8).  A bf16 table
(the bf16 master's compute copy of a tied embedding), with an f32 or a
bf16 hidden in both layouts, is promoted to f32 as JAX's ``dot_general``
promotes it: the same loss (rtol 1e-6) and gradients, each returned in its
operand's dtype, within one bf16 rounding of JAX's.

GPT-tiny's ``gpt_capture(streaming_loss=True, loss_chunk=128)`` holds the
JAX capture's loss (rtol 1e-5) and every gradient (rtol 5e-4, atol 2e-5)
on the same weights, carried across with ``params_from_jax``, and with the
session's per-example mask (non-binary weights) as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.const import BATCH_MASK_KEY as J_MASK_KEY
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.ops.losses import streaming_softmax_xent as jxent
from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.train_lib import gpt_capture
from autodist_tpu_torch.ops.losses import streaming_softmax_xent as txent

N, D, V = 24, 16, 96
LOSS_RTOL, BF16_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 2e-5, 1e-6
CAPTURE_LOSS_RTOL, CAPTURE_GRAD_RTOL, CAPTURE_GRAD_ATOL = 1e-5, 5e-4, 2e-5
SEQ = 16


@pytest.fixture(scope="module")
def data():
    r = np.random.RandomState(0)
    h = r.randn(N, D).astype(np.float32)
    table = (r.randn(V, D) * 0.3).astype(np.float32)
    t = r.randint(0, V, N)
    t[::5] = -100
    return h, table, t.astype(np.int32)


def _both(h, table, t, **kw):
    """(JAX loss, port loss, JAX (dh, dW), port (dh, dW)) on the same inputs."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jh = jnp.asarray(h)
    jl, jg = jax.value_and_grad(lambda a, w: jxent(a, w, jnp.asarray(t), **jkw),
                                argnums=(0, 1))(jh, jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(table).requires_grad_(True)
    tl = txent(th, tw, torch.from_numpy(t), **tkw)
    tg = torch.autograd.grad(tl, (th, tw))
    return float(jl), tl.item(), jg, tg


def _check_grads(jg, tg):
    for j, t in zip(jg, tg):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("chunk", [V, 32, 7, 50])
def test_loss_and_grads_match_jax(data, chunk, layout):
    h, table, t = data
    if layout == "dv":
        table = np.ascontiguousarray(table.T)
    jl, tl, jg, tg = _both(h, table, t, chunk=chunk, layout=layout)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tg[1].shape == table.shape
    _check_grads(jg, tg)


def test_bias_matches_jax(data):
    h, table, t = data
    bias = np.random.RandomState(1).randn(V).astype(np.float32)
    jl, tl, jg, tg = _both(h, table, t, chunk=32, bias=bias)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _check_grads(jg, tg)


@pytest.mark.parametrize("kind", ["binary", "fractional"])
def test_valid_weights_match_jax(data, kind):
    h, table, t = data
    r = np.random.RandomState(2 if kind == "binary" else 3)
    valid = (r.randint(0, 2, N) if kind == "binary" else r.rand(N)).astype(np.float32)
    jl, tl, jg, tg = _both(h, table, t, chunk=32, valid=valid)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _check_grads(jg, tg)


def test_all_ignored_is_finite_zero(data):
    h, table, _ = data
    t = np.full((N,), -100, np.int32)
    jl, tl, _, tg = _both(h, table, t, chunk=32)
    assert tl == jl == 0.0
    assert all(bool(torch.isfinite(g).all()) and not g.any() for g in tg)


def test_bf16_hidden_matches_jax(data):
    """bf16 activations, the models' dtype: the port promotes to f32 as
    JAX's dot_general does; dh comes back in bf16."""
    h, table, t = data
    jh = jnp.asarray(h, jnp.bfloat16)
    jl, jg = jax.value_and_grad(lambda a, w: jxent(a, w, jnp.asarray(t), chunk=32),
                                argnums=(0, 1))(jh, jnp.asarray(table))
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(torch.bfloat16)
    th.requires_grad_(True)
    tw = torch.from_numpy(table).requires_grad_(True)
    tl = txent(th, tw, torch.from_numpy(t), chunk=32)
    dh, dw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=BF16_LOSS_RTOL)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    # dh: the same f32 sums cast to bf16, so within one bf16 rounding (2^-8)
    np.testing.assert_allclose(dh.float().numpy(), np.asarray(jg[0], np.float32),
                               rtol=2 ** -8, atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jg[1]), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("hidden", ["float32", "bfloat16"])
def test_bf16_table_matches_jax(data, hidden, layout):
    h, table, t = data
    if layout == "dv":
        table = np.ascontiguousarray(table.T)
    jh, jw = jnp.asarray(h, getattr(jnp, hidden)), jnp.asarray(table, jnp.bfloat16)
    jl, jg = jax.value_and_grad(lambda a, w: jxent(a, w, jnp.asarray(t), chunk=32,
                                                   layout=layout), argnums=(0, 1))(jh, jw)
    th = torch.from_numpy(h).to(getattr(torch, hidden)).requires_grad_(True)
    tw = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    tl = txent(th, tw, torch.from_numpy(t), chunk=32, layout=layout)
    dh, dw = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    assert dh.dtype == th.dtype and dw.dtype == torch.bfloat16 and dw.shape == table.shape
    for got, want in ((dh, jg[0]), (dw, jg[1])):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -8, atol=GRAD_ATOL)


def _gpt_batch(r, B):
    toks = r.randint(0, jgpt.GPT_TINY.vocab_size, (B, SEQ))
    tgt = np.roll(toks, -1, axis=1)
    tgt[:, -1] = -100
    return {"tokens": toks.astype(np.int32), "targets": tgt.astype(np.int32)}


@pytest.mark.parametrize("mask", [False, True])
def test_gpt_capture_streaming_matches_jax(mask):
    r = np.random.RandomState(2 if mask else 0)
    batch = _gpt_batch(r, 4 if mask else 2)
    j_loss_fn, j_params, _ = jtrain.gpt_capture(jgpt.GPT_TINY, SEQ, streaming_loss=True,
                                                loss_chunk=128)
    t_loss_fn, t_params, _ = gpt_capture(tgpt.GPT_TINY, SEQ, device="cpu",
                                         streaming_loss=True, loss_chunk=128)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mask:   # the session's per-example weights, non-binary
        weights = np.asarray([1.0, 0.5, 0.25, 0.0], np.float32)
        jb[J_MASK_KEY], tb[BATCH_MASK_KEY] = jnp.asarray(weights), torch.from_numpy(weights)
    jl, jg = jax.value_and_grad(j_loss_fn)(j_params, jb, jax.random.PRNGKey(0))
    loaded = {convert.torch_to_jax_name(n): t.requires_grad_(True)
              for n, t in convert.params_from_jax(j_params).items()}
    assert sorted(loaded) == sorted(t_params)
    tl = t_loss_fn(loaded, tb)
    grads = dict(zip(loaded, torch.autograd.grad(tl, list(loaded.values()))))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=CAPTURE_LOSS_RTOL)
    t_tree, _ = convert.params_to_jax({convert.jax_to_torch_name(n): g
                                       for n, g in grads.items()})
    j_flat = dict(jax.tree_util.tree_leaves_with_path(jg))
    t_flat = jax.tree_util.tree_leaves_with_path(t_tree)
    assert len(t_flat) == len(j_flat) == 28
    for path, g in t_flat:
        np.testing.assert_allclose(g, np.asarray(j_flat[path]), rtol=CAPTURE_GRAD_RTOL,
                                   atol=CAPTURE_GRAD_ATOL, err_msg=jax.tree_util.keystr(path))
