"""The port's sequence parallelism against the JAX package's.

- B7 plain: :func:`flash_block_update_plain` against the Pallas
  ``flash_block_update`` (interpret mode) and against JAX's
  ``ring_attention._online_block``, f32 at (BH=4, Sq=Sk=16, D=8), with the
  K/V block on the diagonal, in the past and wholly in the future, and an
  entering m of -inf.  A future block leaves the carry unchanged but for
  the clamp of m at ``_M_FLOOR``.  ``_online_block`` seeds -inf without
  that clamp, so it is compared only where it is defined (a row that has
  seen no key is NaN there).
- B3 plain with offsets: :func:`flash_dq_plain` / :func:`flash_dkdv_plain`
  against ``_dq_call`` / ``_dkdv_call`` (interpret mode) at the same
  offsets; a future block gives exact zeros in both.
  Tolerance of both: max-abs <= 1e-5 * max(1, max|x|) (f32 sums in another
  order).
- Over the 4-rank gloo world (``tests/torch_gloo_ranks.py``, shared with
  ``tests/test_torch_compressed_sync.py``) against JAX in ``shard_map`` on
  as many CPU devices: ring attention at R_s = 2 (the two seq rows of
  ``{replica: 2, seq: 2}``) and R_s = 4, causal, the port's "flash" and
  "xla" impls against the JAX Pallas ring (``impl="flash"``, interpret
  mode): output to atol 2e-5, the gradients of ``sum(sin(out))`` to atol
  1e-4 (the JAX ring tests' tolerances); Ulysses at R = 2, causal and
  not, to atol 2e-5, and its indivisible-heads error.
- The slice as a whole: GPT-tiny (f32, dropout 0), ``AllReduce()``,
  ``sgd(0.05)``, 3 steps on ``mesh: {replica: 2, seq: 2}`` over the 4
  ranks against the JAX ``AutoDist`` on the same mesh over 4 CPU devices
  with ``attention_impl="flash"`` (the Pallas ring in interpret mode):
  losses to rtol 1e-4, parameters to atol 1e-4; every rank ends with the
  same parameters; the port's seq-parallel run against its flat 4-replica
  run at rtol 5e-4 / atol 1e-3 (the bounds of
  ``tests/test_sequence_parallel.py::test_seq_parallel_matches_data_parallel``);
  a batch whose dim 1 does not divide raises naming ``dim 1``.  The
  one-axis mesh ``{seq: 4}`` is data parallelism in JAX (dim 0 sharded
  over it, no ring): the port's ranks take dim-0 slices there and match
  the JAX ``AutoDist`` on that mesh at the same tolerances.  In one
  process, ``mesh: {replica: 1, seq: 1}`` runs GPT through
  ``ring_attention`` and equals the flat path's steps to 1e-6; a ``model``
  axis raises; the mesh lands in ``graph_config`` as JAX's proto has it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_gloo_ranks as ranks
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.ops.pallas import flash_attention as jfa
from autodist_tpu.parallel import ring_attention as jra
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.train_lib import gpt_capture
from autodist_tpu_torch.ops import flash_attention as tfa
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

BH, S, D, H = 4, 16, 8, 2
OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
# (q_off, k_off) of one K/V block against one q block of S rows
OFFSETS = {"diagonal": (S, S), "past": (2 * S, 0), "future": (0, S)}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max-abs {err} > {bound}"


def _carry(seed, m_neg_inf=False):
    """q, k, v (BH, S, D) and an entering carry: finite (m, l > 0, o) from an
    earlier block, or the XLA ring's seed (-inf, 0, 0)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    if m_neg_inf:
        m = np.full((BH, S), -np.inf, np.float32)
        l = np.zeros((BH, S), np.float32)
        o = np.zeros((BH, S, D), np.float32)
    else:
        m = rng.uniform(-1, 1, (BH, S)).astype(np.float32)
        l = rng.uniform(0.5, 3, (BH, S)).astype(np.float32)
        o = rng.standard_normal((BH, S, D)).astype(np.float32)
    return q, k, v, m, l, o


@functools.lru_cache(maxsize=None)
def _jax_block_update():
    return jax.jit(lambda q, k, v, m, l, o, q_off, k_off: jfa.flash_block_update(
        q, k, v, m, l, o, q_off, k_off, causal=True, interpret=True))


def _online_block(q, k, v, m, l, o, q_off, k_off):
    """JAX ``_online_block`` on the folded inputs, (B, H) = (2, 2)."""
    def unfold(t):   # (BH, S, D) -> (B, S, H, D)
        return jnp.asarray(t).reshape(BH // H, H, S, D).transpose(0, 2, 1, 3)

    keep = (q_off + np.arange(S))[:, None] >= (k_off + np.arange(S))[None, :]
    bias = jnp.where(jnp.asarray(keep), 0.0, -jnp.inf)[None, None]
    m2, l2, o2 = jra._online_block(unfold(q), unfold(k), unfold(v), bias,
                                   jnp.asarray(m).reshape(BH // H, H, S),
                                   jnp.asarray(l).reshape(BH // H, H, S), unfold(o),
                                   1.0 / np.sqrt(D))
    return (np.asarray(m2).reshape(BH, S), np.asarray(l2).reshape(BH, S),
            np.asarray(o2).transpose(0, 2, 1, 3).reshape(BH, S, D))


@pytest.mark.parametrize("where,m_neg_inf", [("diagonal", False), ("past", False),
                                             ("future", False), ("diagonal", True),
                                             ("future", True)])
def test_block_update_plain_matches_pallas(where, m_neg_inf):
    case = where + (" m=-inf" if m_neg_inf else "")
    q_off, k_off = OFFSETS[where]
    q, k, v, m, l, o = _carry(3, m_neg_inf)
    got = [t.numpy() for t in tfa.flash_block_update_plain(
        *(torch.from_numpy(a) for a in (q, k, v, m, l, o)), q_off, k_off, causal=True,
        sm_scale=1.0 / np.sqrt(D))]
    want = _jax_block_update()(q, k, v, m, l, o, q_off, k_off)
    for name, a, b in zip("mlo", got, want):
        _close(a, b, f"{case} {name} vs flash_block_update")
    if where == "future":   # the carry passes through, m clamped at the floor
        np.testing.assert_array_equal(got[0], np.maximum(m, tfa._M_FLOOR))
        np.testing.assert_array_equal(got[1], l)
        np.testing.assert_array_equal(got[2], o)
    if where == "future" and m_neg_inf:   # no key seen yet: m = -1e20, l = 0
        assert (got[0] == np.float32(-1e20)).all() and (got[1] == 0).all()
        assert np.isnan(_online_block(q, k, v, m, l, o, q_off, k_off)[2]).all()
        return
    for name, a, b in zip("mlo", got, _online_block(q, k, v, m, l, o, q_off, k_off)):
        _close(a, b, f"{case} {name} vs _online_block")


@functools.lru_cache(maxsize=None)
def _jax_dq_dkdv():
    def both(q, k, v, bias, do, lse, delta, q_off, k_off):
        args = (q, k, v, bias, do, lse, delta, H, 1.0 / np.sqrt(D), True, S, S, True)
        return (jfa._dq_call(*args, q_off=q_off, k_off=k_off),
                *jfa._dkdv_call(*args, q_off=q_off, k_off=k_off))
    return jax.jit(both)


@pytest.mark.parametrize("where", sorted(OFFSETS))
def test_dq_dkdv_plain_with_offsets_match_pallas(where):
    q_off, k_off = OFFSETS[where]
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(4))
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(D)
    lse = (np.log(np.exp(s).sum(-1)) + 0.5).astype(np.float32)   # as if another block too
    delta = rng.standard_normal((BH, S)).astype(np.float32)
    bias = np.zeros((BH // H, S), np.float32)
    want = _jax_dq_dkdv()(q, k, v, bias, do, lse, delta, q_off, k_off)
    args = [torch.from_numpy(a) for a in (q, k, v, bias, do, lse, delta)]
    cfg = (H, 1.0 / np.sqrt(D), True, 1, q_off, k_off)
    got = (tfa.flash_dq_plain(*args, *cfg), *tfa.flash_dkdv_plain(*args, *cfg))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b, f"{where} {name}")
        if where == "future":
            assert not a.any() and not np.asarray(b).any(), f"{name} not exact zeros"


# -- the 4-rank gloo world ----------------------------------------------------

def _jax_gpt_params():
    _, params, _ = jtrain.gpt_capture(jgpt.GPT_TINY, ranks.GPT_SEQ)
    return params


def _flax_tree(gpt_params):
    """The ranks' GPT weights as a flax tree."""
    tree, _ = convert.params_to_jax({convert.jax_to_torch_name(n): torch.from_numpy(a)
                                     for n, a in gpt_params.items()})
    return tree


@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["seq_parallel"] for res in results]


@functools.lru_cache(maxsize=None)
def _jax_ring(r):
    """JAX's Pallas ring (interpret mode) over ``r`` CPU devices: output and
    the gradients of sum(sin(out))."""
    q, k, v = (jnp.asarray(a) for a in ranks.qkv(ranks.RING_SHAPE, seed=11))
    mesh = Mesh(np.array(jax.devices()[:r]), ("seq",))
    f = jax.shard_map(lambda a, b, c: jra.ring_attention(a, b, c, "seq", causal=True,
                                                         impl="flash"),
                      mesh=mesh, in_specs=(jax.P(None, "seq"),) * 3,
                      out_specs=jax.P(None, "seq"), check_vma=False)

    def loss(a, b, c):
        out = f(a, b, c)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _stitch(results, key, get):
    """Each seq row's blocks ``get(result)`` joined along dim 1, one array
    per row (the rows of a layout hold the same inputs)."""
    rows = {}
    for res in results:
        rows.setdefault(res[key]["row"], {})[res[key]["index"]] = get(res[key])
    return [np.concatenate([row[i] for i in sorted(row)], axis=1) for row in rows.values()]


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("layout", ranks.RING_LAYOUTS)
def test_ring_attention_matches_jax_over_gloo(gloo, layout, impl):
    _, results = gloo
    key = ("ring", layout, impl)
    assert sorted(res[key]["size"] for res in results) == [layout[1]] * ranks.WORLD
    want_out, want_grads = _jax_ring(layout[1])
    rows = _stitch(results, key, lambda r: r["out"])
    assert len(rows) == layout[0]
    for got in rows:
        np.testing.assert_allclose(got, want_out, atol=OUT_ATOL, rtol=0)
    for i, name in enumerate(("dq", "dk", "dv")):
        for got in _stitch(results, key, lambda r: r["grads"][i]):
            np.testing.assert_allclose(got, want_grads[i], atol=GRAD_ATOL, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_over_gloo(gloo, causal):
    _, results = gloo
    r = ranks.RING_LAYOUTS[0][1]
    q, k, v = (jnp.asarray(a) for a in ranks.qkv(
        (ranks.RING_SHAPE[0], ranks.RING_SHAPE[1], ranks.ULYSSES_HEADS, ranks.RING_SHAPE[3]),
        seed=12))
    mesh = Mesh(np.array(jax.devices()[:r]), ("seq",))
    want = jax.jit(jax.shard_map(
        lambda a, b, c: jra.all_to_all_attention(a, b, c, "seq", causal=causal),
        mesh=mesh, in_specs=(jax.P(None, "seq"),) * 3, out_specs=jax.P(None, "seq"),
        check_vma=False))(q, k, v)
    blocks = {}
    for res in results:
        blocks.setdefault(res["ulysses", causal]["index"], []).append(
            res["ulysses", causal]["out"])
    assert sorted(blocks) == list(range(r))
    for i, got in blocks.items():
        for block in got:   # both seq rows hold the same inputs
            np.testing.assert_allclose(block, np.split(np.asarray(want), r, axis=1)[i],
                                       atol=OUT_ATOL, rtol=0)


def test_ulysses_rejects_indivisible_heads(gloo):
    _, results = gloo
    for res in results:
        assert "must divide by axis size 2" in res["ulysses_indivisible"]


def _jax_gpt_run(inputs, mesh, attention_impl):
    """The JAX ``AutoDist`` on ``mesh`` over 4 CPU devices: GPT-tiny sgd
    steps on the ranks' weights and batch; (losses, parameters, the JAX
    transformer's seq axis)."""
    model = jgpt.GPT(dataclasses.replace(jgpt.GPT_TINY, attention_impl=attention_impl))

    def loss_fn(p, batch, step_rng):
        logits = model.apply({"params": p}, batch["tokens"], deterministic=False,
                             rngs={"dropout": step_rng})
        return jgpt.gpt_loss(logits, batch["targets"])

    spec = JResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": list(range(ranks.WORLD))}],
        "mesh": mesh})
    sess = JAutoDist(resource_spec=spec, strategy_builder=JAllReduce()).distribute(
        loss_fn, _flax_tree(inputs["gpt_params"]), optax.sgd(ranks.SP_LR), has_rng=True)
    losses = [float(sess.run(inputs["gpt_batch"])["loss"]) for _ in range(ranks.GPT_STEPS)]
    params = {convert.torch_to_jax_name(n): t.numpy()
              for n, t in convert.params_from_jax(sess.params()).items()}
    return losses, params, sess._t.seq_axis


def test_gpt_tiny_seq_parallel_matches_jax_autodist(gloo):
    inputs, results = gloo
    j_losses, j_params, _ = _jax_gpt_run(inputs, ranks.SP_MESH, "flash")
    for res in results:
        got = res["gpt", "seq"]
        assert got["seq"][1] == ranks.SP_MESH["seq"]
        np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4)
        assert got["losses"][-1] < got["losses"][0]
        for n, a in j_params.items():
            np.testing.assert_allclose(got["params"][n], a, atol=1e-4, rtol=0, err_msg=n)


def test_one_axis_seq_mesh_shards_dim_0_like_jax(gloo):
    inputs, results = gloo
    j_losses, j_params, j_seq = _jax_gpt_run(inputs, ranks.SEQ_ONLY_MESH, "xla")
    assert j_seq is None
    assert sorted(res["gpt", "seq_only"]["data_slice"] for res in results) == [
        (r, ranks.WORLD) for r in range(ranks.WORLD)]
    for res in results:
        got = res["gpt", "seq_only"]
        assert got["seq"] is None
        np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-4)
        for n, a in j_params.items():
            np.testing.assert_allclose(got["params"][n], a, atol=1e-4, rtol=0, err_msg=n)


def test_seq_parallel_ranks_hold_the_same_parameters(gloo):
    _, results = gloo
    assert sorted(res["gpt", "seq"]["seq"] for res in results) == [(0, 2), (0, 2), (1, 2),
                                                                   (1, 2)]
    for name in ("seq", "flat"):
        first = results[0]["gpt", name]
        for res in results[1:]:
            assert res["gpt", name]["strategy_id"] == first["strategy_id"]
            for n, a in first["params"].items():
                np.testing.assert_array_equal(res["gpt", name]["params"][n], a, err_msg=n)


def test_seq_parallel_matches_flat_replicas(gloo):
    _, results = gloo
    sp, dp = results[0]["gpt", "seq"], results[0]["gpt", "flat"]
    assert dp["seq"] is None
    np.testing.assert_allclose(sp["losses"], dp["losses"], rtol=5e-4)
    for n, a in dp["params"].items():
        np.testing.assert_allclose(sp["params"][n], a, atol=1e-3, err_msg=n)


def test_seq_dim_divisibility_checked(gloo):
    _, results = gloo
    for res in results:
        assert "dim 1" in res["dim1_error"]


# -- one process ----------------------------------------------------------------

def _one_process_run(mesh, impl):
    info = dict(CPU_SPEC, mesh=mesh) if mesh else CPU_SPEC
    loss_fn, params, sparse = gpt_capture(
        dataclasses.replace(tgpt.GPT_TINY, attention_impl=impl), ranks.GPT_SEQ, device="cpu")
    sess = AutoDist(resource_spec=ResourceSpec(resource_info=info),
                    strategy_builder=AllReduce(), device="cpu").distribute(
        loss_fn, params, optim.sgd(ranks.SP_LR), sparse_vars=sparse)
    batch = ranks.gpt_batch()
    losses = [sess.run(batch)["loss"].item() for _ in range(ranks.GPT_STEPS)]
    return losses, sess.params()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_ring_of_one_matches_flat_path(monkeypatch, impl):
    calls = []
    ring = tgpt.ring_attention
    monkeypatch.setattr(tgpt, "ring_attention",
                        lambda *a, **kw: calls.append(kw["impl"]) or ring(*a, **kw))
    flat_losses, flat_params = _one_process_run(None, impl)
    assert not calls
    losses, params = _one_process_run({"replica": 1, "seq": 1}, impl)
    assert calls == [impl] * (tgpt.GPT_TINY.num_layers * ranks.GPT_STEPS)
    np.testing.assert_allclose(losses, flat_losses, atol=1e-6, rtol=0)
    for n, a in flat_params.items():
        np.testing.assert_allclose(params[n].numpy(), a.numpy(), atol=1e-6, rtol=0,
                                   err_msg=n)


def test_mesh_with_a_model_axis_raises():
    loss_fn, params, _ = gpt_capture(tgpt.GPT_TINY, ranks.GPT_SEQ, device="cpu")
    ad = AutoDist(resource_spec=ResourceSpec(resource_info=dict(
        CPU_SPEC, mesh={"replica": 1, "model": 1})), strategy_builder=AllReduce(),
        device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        ad.distribute(loss_fn, params, optim.sgd(0.1))


@pytest.mark.parametrize("mesh", [{"replica": 2, "seq": 2}, {"replica": -1, "seq": 4},
                                  {"seq": 2, "replica": -1}])
def test_mesh_request_graph_config_matches_jax(mesh):
    info = {"nodes": [{"address": "localhost", "cpus": [0, 1, 2, 3], "chief": True}],
            "mesh": mesh}
    ts = AllReduce().build(ModelItem(lambda p, b: 0.0, {"w": torch.zeros(3)}),
                           ResourceSpec(resource_info=info))
    js = JAllReduce().build(JModelItem(lambda p, b: 0.0, {"w": np.zeros(3, np.float32)}),
                            JResourceSpec(resource_info=info))
    jg = js.proto.graph_config
    assert ts.graph_config.replicas == list(jg.replicas)
    assert ts.graph_config.mesh.axis_names == list(jg.mesh.axis_names)
    assert ts.graph_config.mesh.axis_sizes == [int(x) for x in jg.mesh.axis_sizes]
