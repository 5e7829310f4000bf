"""The port's GPT against the JAX package's flax GPT on the same weights.

``GPT_TINY`` weights (one block where JAX runs the flash kernel in
interpret mode, whose compile dominates) on flax's variable shapes, drawn by numpy at flax's
scales (``tests/torch_jax_oracle.py``), are carried into the PyTorch
module with ``params_from_jax``; the same numpy tokens go through both.
The JAX side runs attention through the Pallas flash kernel in interpret
mode (``attention_impl="flash"``), the port through the flash wrappers'
plain versions (CPU tensors).  In f32, logits and the loss agree to atol
2e-5 and every parameter gradient to atol 2e-5 (f32 sums in another
order); the bf16 forward agrees to atol 3e-2 on logits of magnitude ~0.3
(bf16 rounds at other places in the two frameworks).  ``return_hidden``
gives flax's f32 ``ln_f`` output (atol 2e-5).

With bf16 parameters (the bf16 master's compute copy), ``gpt_capture``'s
dense and streaming losses and every gradient of a one-block GPT-tiny hold
the JAX capture's on
the same bf16-rounded weights (JAX's value and gradient compiled with
XLA's excess precision off, so each bf16 op rounds as it does eagerly): the embedding lookup and the ``wpe`` add in
bf16, LayerNorm and Dense with bf16 scale and bias, and the head and the
streaming loss promoting the bf16 ``wte`` to f32.  In f32 compute the loss
agrees to rtol 1e-6 and each bf16 gradient to one bf16 rounding of the
same f32 sum (rtol 2^-7, atol 1e-5); in bf16 compute, GPT-2 small's, the
loss to rtol 1e-4 and each gradient to 3e-2 in relative norm (bf16 rounds
at other places in the two frameworks; measured 8e-6 and 1.2e-2).

Remat (``GPTConfig(remat=True)``, ``distribute(remat=True)``) against the
same model without it, as ``tests/test_models.py::test_remat_is_value_exact``
holds flax's: the loss bitwise, the gradients atol 1e-5, rtol 1e-4; with
dropout 0.1 from a seeded generator the recompute draws the first run's
masks (gradients atol 1e-7), and three adamw steps equal three without
remat (atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.models import gpt as jgpt
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.train_lib import gpt_capture

SEQ, B = 16, 2
F32_ATOL, BF16_ATOL = 2e-5, 3e-2
# bf16 parameters: (loss rtol, gradient check) per compute dtype
BF16_PARAM_LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-4}
BF16_PARAM_GRAD_RTOL, BF16_PARAM_GRAD_ATOL, BF16_COMPUTE_GRAD_NORM_RTOL = 2 ** -7, 1e-5, 3e-2


def _configs(dtype_j, dtype_t):
    """One GPT-tiny block (every op of the model, half the JAX compile)."""
    cj = dataclasses.replace(jgpt.GPT_TINY, attention_impl="flash", dtype=dtype_j,
                             num_layers=1)
    ct = dataclasses.replace(tgpt.GPT_TINY, attention_impl="flash", dtype=dtype_t,
                             num_layers=1)
    return cj, ct


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jgpt.GPT_TINY.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _flax_params(num_layers=jgpt.GPT_TINY.num_layers):
    # the param tree does not depend on attention_impl or dtype (params
    # are f32 either way): flax's shapes, drawn by numpy
    return oracle.gpt_capture(dataclasses.replace(jgpt.GPT_TINY, num_layers=num_layers),
                              SEQ)[1]


def _torch_model(ct, jparams):
    model = tgpt.GPT(ct, device="cpu")
    model.load_state_dict(convert.params_from_jax(jparams))
    return model


def _jax_f32():
    """flax's f32 loss, logits and gradient tree on ``_tokens()``."""
    cj, _ = _configs(jnp.float32, torch.float32)
    tokens, targets = _tokens()

    def jloss(p):
        logits = jgpt.GPT(cj).apply({"params": p}, jnp.asarray(tokens))
        return jgpt.gpt_loss(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(_flax_params(1))
    return float(j_loss), np.asarray(j_logits), jax.tree.map(np.asarray, j_grads)


def _jax_bf16_logits():
    """flax's bf16 logits on ``_tokens(1)``."""
    cj, _ = _configs(jnp.bfloat16, torch.bfloat16)
    return np.asarray(jax.jit(jgpt.GPT(cj).apply)(
        {"params": _flax_params(1)}, jnp.asarray(_tokens(1)[0])))


def _jax_hidden():
    """flax's final hidden states (``return_hidden``) on ``_tokens(2)``."""
    cj, _ = _configs(jnp.float32, torch.float32)
    return np.asarray(jax.jit(lambda p, t: jgpt.GPT(cj).apply(
        {"params": p}, t, return_hidden=True))(_flax_params(1), jnp.asarray(_tokens(2)[0])))


def _bf16_params_case(compute, streaming):
    """(JAX config, port config, capture keywords, batch) of the bf16
    parameters case."""
    # one block: every op of the model runs, at half the JAX compile
    cj = dataclasses.replace(jgpt.GPT_TINY, attention_impl="flash", dtype=getattr(jnp, compute),
                             num_layers=1)
    ct = dataclasses.replace(tgpt.GPT_TINY, attention_impl="flash",
                             dtype=getattr(torch, compute), num_layers=1)
    kw = dict(streaming_loss=streaming, loss_chunk=128)
    tokens, targets = _tokens(6)
    targets[:, -1] = -100
    return cj, ct, kw, {"tokens": tokens, "targets": targets}


def _jax_bf16_params(compute, streaming):
    """JAX's capture loss and gradient tree with the parameters in bf16."""
    cj, _, kw, batch = _bf16_params_case(compute, streaming)
    j_loss_fn, jparams = oracle.gpt_capture(cj, SEQ, **kw)
    # compiled with each op rounding as it does eagerly: XLA's excess
    # precision (bf16 intermediates kept in f32) off
    jl, jg = oracle.value_and_grad(
        j_loss_fn, jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return float(jl), jax.tree.map(np.asarray, jg)


worker.submit((_jax_f32,), (_jax_bf16_logits,), (_jax_hidden,),
              *((_jax_bf16_params, compute, streaming) for compute in ("float32", "bfloat16")
                for streaming in (False, True)))


def test_f32_logits_loss_and_every_gradient_match_flax():
    _, ct = _configs(jnp.float32, torch.float32)
    jparams = _flax_params(1)
    tokens, targets = _tokens()
    j_loss, j_logits, j_grads = worker.result(_jax_f32)

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
    assert len(flat_t) == len(flat_j) == 16
    for path, g in flat_t:
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), atol=F32_ATOL,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_bf16_forward_matches_flax():
    _, ct = _configs(jnp.bfloat16, torch.bfloat16)
    jparams = _flax_params(1)
    tokens, _ = _tokens(1)
    j_logits = worker.result(_jax_bf16_logits)
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


def test_return_hidden_matches_flax():
    _, ct = _configs(jnp.float32, torch.float32)
    jparams = _flax_params(1)
    tokens, _ = _tokens(2)
    j_hidden = worker.result(_jax_hidden)
    with torch.no_grad():
        t_hidden = _torch_model(ct, jparams)(torch.from_numpy(tokens), return_hidden=True)
    assert t_hidden.dtype == torch.float32 and t_hidden.shape == (B, SEQ, ct.hidden_size)
    np.testing.assert_allclose(t_hidden.numpy(), j_hidden, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "streaming"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_params_loss_and_gradients_match_jax(compute, streaming):
    cj, ct, kw, batch = _bf16_params_case(compute, streaming)
    jparams = oracle.gpt_capture(cj, SEQ, **kw)[1]
    t_loss_fn, _, _ = gpt_capture(ct, SEQ, device="cpu", **kw)
    jl, jg = worker.result(_jax_bf16_params, compute, streaming)
    # the same round-to-nearest-even cast of the same f32 weights
    loaded = {convert.torch_to_jax_name(n): t.to(torch.bfloat16).requires_grad_(True)
              for n, t in convert.params_from_jax(jparams).items()}
    tl = t_loss_fn(loaded, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, list(loaded.values()))
    assert tl.dtype == torch.float32 and all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=BF16_PARAM_LOSS_RTOL[compute])
    t_tree, _ = convert.params_to_jax({convert.jax_to_torch_name(n): g.float()
                                       for n, g in zip(loaded, grads)})
    j_flat = dict(jax.tree_util.tree_leaves_with_path(jg))
    t_flat = jax.tree_util.tree_leaves_with_path(t_tree)
    assert len(t_flat) == len(j_flat) == 16
    for path, g in t_flat:
        want, what = np.asarray(j_flat[path], np.float32), jax.tree_util.keystr(path)
        if compute == "float32":
            np.testing.assert_allclose(g, want, rtol=BF16_PARAM_GRAD_RTOL,
                                       atol=BF16_PARAM_GRAD_ATOL, err_msg=what)
        else:
            rel = np.linalg.norm(g - want) / np.linalg.norm(want)
            assert rel <= BF16_COMPUTE_GRAD_NORM_RTOL, (what, rel)


def _loss_and_grads(config, jparams, tokens, targets, generator=None):
    model = _torch_model(config, jparams)
    loss = tgpt.gpt_loss(model(torch.from_numpy(tokens), generator=generator),
                         torch.from_numpy(targets))
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def test_remat_is_value_exact():
    """``tests/test_models.py::test_remat_is_value_exact``: the same loss,
    bitwise, and the gradients within atol 1e-5, rtol 1e-4."""
    c0 = dataclasses.replace(tgpt.GPT_TINY, attention_impl="flash")
    jparams = _flax_params()
    tokens, targets = _tokens(3)
    l0, g0 = _loss_and_grads(c0, jparams, tokens, targets)
    l1, g1 = _loss_and_grads(dataclasses.replace(c0, remat=True), jparams, tokens, targets)
    assert l0.item() == l1.item()
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-4)


def test_remat_with_dropout_recomputes_the_same_masks():
    """With dropout 0.1 from one seeded generator, remat's recompute draws
    the masks of the first run: the loss, every gradient and the
    generator's end state equal those without remat."""
    c0 = dataclasses.replace(tgpt.GPT_TINY, dropout_rate=0.1)
    jparams = _flax_params()
    tokens, targets = _tokens(4)
    runs = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        loss, grads = _loss_and_grads(dataclasses.replace(c0, remat=remat), jparams, tokens,
                                      targets, generator=gen)
        runs.append((loss.item(), grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1 and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7, rtol=0)
    # the masks were drawn: another seed gives another loss
    other, _ = _loss_and_grads(c0, jparams, tokens, targets, torch.Generator().manual_seed(8))
    assert other.item() != l0


@pytest.mark.parametrize("where", ["config", "distribute"])
def test_three_remat_steps_equal_three_plain_steps(where):
    """``GPTConfig(remat=True)`` and ``distribute(remat=True)``: three adamw
    steps with dropout equal three steps without remat (losses and final
    parameters within atol 1e-6)."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    toks = np.random.default_rng(5).integers(0, tgpt.GPT_TINY.vocab_size,
                                             (B, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    runs = []
    for remat in (False, True):
        config = dataclasses.replace(tgpt.GPT_TINY, dropout_rate=0.1,
                                     remat=remat and where == "config")
        loss_fn, params, _ = gpt_capture(config, SEQ, device="cpu")
        sess = AutoDist(resource_spec=ResourceSpec(resource_info={"nodes": [
            {"address": "localhost", "cpus": [0], "chief": True}]}),
            strategy_builder=AllReduce(), device="cpu").distribute(
            loss_fn, params, optim.adamw(1e-3), has_rng=True,
            remat=remat and where == "distribute")
        runs.append(([sess.run(batch)["loss"].item() for _ in range(3)], sess.params()))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_allclose(l1, l0, atol=1e-6, rtol=0)
    assert l0[-1] < l0[0]
    for n in p0:
        np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), atol=1e-6, rtol=0, err_msg=n)
