"""The port's GPT against the JAX package's flax GPT on the same weights.

``GPT_TINY`` weights initialised by flax are carried into the PyTorch
module with ``params_from_jax``; the same numpy tokens go through both.
The JAX side runs attention through the Pallas flash kernel in interpret
mode (``attention_impl="flash"``), the port through the flash wrappers'
plain versions (CPU tensors).  In f32, logits and the loss agree to atol
2e-5 and every parameter gradient to atol 2e-5 (f32 sums in another
order); the bf16 forward agrees to atol 3e-2 on logits of magnitude ~0.3
(bf16 rounds at other places in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import gpt as jgpt
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt

SEQ, B = 16, 2
F32_ATOL, BF16_ATOL = 2e-5, 3e-2


def _configs(dtype_j, dtype_t):
    cj = dataclasses.replace(jgpt.GPT_TINY, attention_impl="flash", dtype=dtype_j)
    ct = dataclasses.replace(tgpt.GPT_TINY, attention_impl="flash", dtype=dtype_t)
    return cj, ct


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jgpt.GPT_TINY.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _flax_params():
    # the param tree does not depend on attention_impl or dtype: init on
    # the plain XLA path (params are f32 either way)
    return jgpt.GPT(jgpt.GPT_TINY).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, SEQ), jnp.int32))["params"]


def _torch_model(ct, jparams):
    model = tgpt.GPT(ct, device="cpu")
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def test_f32_logits_loss_and_every_gradient_match_flax():
    cj, ct = _configs(jnp.float32, torch.float32)
    jparams = _flax_params()
    tokens, targets = _tokens()

    def jloss(p):
        logits = jgpt.GPT(cj).apply({"params": p}, jnp.asarray(tokens))
        return jgpt.gpt_loss(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jparams)

    model = _torch_model(ct, jparams)
    logits = model(torch.from_numpy(tokens))
    loss = tgpt.gpt_loss(logits, torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=F32_ATOL, rtol=0)
    grads, _ = convert.params_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    flat_t = jax.tree_util.tree_leaves_with_path(grads)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j_grads))
    assert len(flat_t) == len(flat_j) == 28
    for path, g in flat_t:
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), atol=F32_ATOL,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_bf16_forward_matches_flax():
    cj, ct = _configs(jnp.bfloat16, torch.bfloat16)
    jparams = _flax_params()
    tokens, _ = _tokens(1)
    j_logits = np.asarray(jax.jit(jgpt.GPT(cj).apply)(
        {"params": jparams}, jnp.asarray(tokens)))
    with torch.no_grad():
        t_logits = _torch_model(ct, jparams)(torch.from_numpy(tokens)).numpy()
    assert t_logits.dtype == np.float32 and np.isfinite(t_logits).all()
    np.testing.assert_allclose(t_logits, j_logits, atol=BF16_ATOL, rtol=0)


def test_params_roundtrip_is_identity():
    jparams = jax.tree.map(np.asarray, _flax_params())
    back, _ = convert.params_to_jax(convert.params_from_jax(jparams))
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_seeded_init_follows_flax_initialisers():
    """normal(0.02) embeddings, lecun-normal Dense kernels (truncated at
    2 std, so |w| <= 2 * sqrt(1/fan_in) / 0.8796), zero biases, unit
    LayerNorm scales; the same seed gives the same weights."""
    c = dataclasses.replace(tgpt.GPT_TINY, vocab_size=4096)
    gen = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    a, b = tgpt.GPT(c, generator=gen()), tgpt.GPT(c, generator=gen())
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert abs(a.wte.std().item() - 0.02) < 1e-3
    w = a.h_0.mlp_in.weight
    bound = 2 * (1 / c.hidden_size) ** 0.5 / 0.87962566103423978
    assert w.abs().max().item() <= bound * (1 + 1e-6)
    assert abs(w.std().item() - (1 / c.hidden_size) ** 0.5) < 0.01
    assert not a.h_0.mlp_in.bias.any() and bool((a.ln_f.scale == 1).all())


def test_remat_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.GPT(dataclasses.replace(tgpt.GPT_TINY, remat=True))
