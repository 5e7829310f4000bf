"""The port's PS family and the session's loop methods against the JAX package.

- The builders ``PS()``, ``PS(local_proxy_variable=True)`` and the default
  ``PSLoadBalancing()`` on GPT-tiny, on a one-node spec and on a two-node
  spec of four GPUs: every node's ``reduction_destination``,
  ``local_replication``, ``sync`` and ``staleness``, and
  ``PSLoadBalancing.loads``, equal the JAX builders' (device strings read
  ``GPU`` where JAX's read ``TPU``).
- The plans: a scalar is forced to AllReduce, and ``update_space_shape``
  equals JAX's at R = 1, 3 and 4; each step runs one reduce-scatter and
  one all-gather per dtype group.
- Three GPT-tiny steps under the default builder follow the JAX
  ``AutoDist`` with ``PSLoadBalancing`` at
  ``test_three_steps_match_jax_autodist``'s tolerances.
- The knobs of later slices raise: ``PS(sync=False)`` and
  ``PS(staleness=2)`` at ``distribute`` (Queue A item 6), a ``ps_axes``
  subset at construction (item 6), ``fit(checkpoint_path=...)`` (item 7).
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``, started once
  per test process), against the single-device optax oracles of the JAX
  package's tests on the same numpy inputs:
  ``test_end_to_end.py::test_value_exact_sync``'s linear model under the
  three PS builders x sgd/adam (atol 2e-5), with the Adam moments on the
  flat 1/R shards; ``test_grad_accumulation.py`` (atol 1e-6);
  ``test_clip_global_norm.py`` (atol 1e-5); ``test_uneven_batch.py``
  (atol 2e-5, loss within 1e-4); ``run_steps``, ``fit`` and
  ``check_replication``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import PS as JPS
from autodist_tpu.strategy import PSLoadBalancing as JPSLoadBalancing
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.train_lib import gpt_capture
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import PS, PSLoadBalancing

SEQ, B, STEPS = 16, 4, 3
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
SPECS = {
    "one_node": {"nodes": [{"address": "localhost", "gpus": [0], "chief": True}]},
    "two_nodes": {"nodes": [{"address": "10.0.0.1", "gpus": [0, 1], "chief": True},
                            {"address": "10.0.0.2", "gpus": [0, 1]}]},
}
BUILDERS = {
    "PS": (lambda: JPS(), lambda: PS()),
    "PS_proxy": (lambda: JPS(local_proxy_variable=True),
                 lambda: PS(local_proxy_variable=True)),
    "PSLoadBalancing": (lambda: JPSLoadBalancing(), lambda: PSLoadBalancing()),
}


def _jax_spec(info):
    """The JAX spec of a port spec: ``chips`` for ``gpus``."""
    return JResourceSpec(resource_info={"nodes": [
        {("chips" if k == "gpus" else k): v for k, v in n.items()} for n in info["nodes"]]})


def _gpu(name):
    return name.replace(":TPU:", ":GPU:")


def _gpt_items():
    params = jax.eval_shape(
        lambda: jgpt.GPT(jgpt.GPT_TINY).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, SEQ), jnp.int32))["params"])
    model = tgpt.GPT(tgpt.GPT_TINY, device="meta")
    return (JModelItem(lambda p, b: 0.0, params),
            ModelItem(lambda p, b: 0.0, {convert.torch_to_jax_name(n): p
                                         for n, p in model.named_parameters()}))


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_ps_builders_match_jax(builder, spec):
    make_j, make_t = BUILDERS[builder]
    jitem, titem = _gpt_items()
    jb, tb = make_j(), make_t()
    js = jb.build(jitem, _jax_spec(SPECS[spec]))
    ts = tb.build(titem, ResourceSpec(resource_info=SPECS[spec]))
    assert [n.var_name for n in ts.node_config] == [n.var_name for n in js.node_config]
    for jn, tn in zip(js.node_config, ts.node_config):
        assert tn.WhichOneof("synchronizer") == "PSSynchronizer"
        j, t = jn.PSSynchronizer, tn.PSSynchronizer
        assert (t.reduction_destination, t.local_replication, t.sync, t.staleness) == (
            _gpu(j.reduction_destination), j.local_replication, j.sync, j.staleness)
    assert ts.graph_config.replicas == [_gpu(r) for r in js.graph_config.replicas]
    if builder == "PSLoadBalancing":
        assert tb.loads == {_gpu(k): v for k, v in jb.loads.items()}
        assert len(tb.loads) == len(SPECS[spec]["nodes"]) and min(tb.loads.values()) > 0


@pytest.mark.parametrize("r", [1, 3, 4])
def test_ps_plans_and_update_space_match_jax(r):
    shapes = {"s": (), "w": (5, 7), "b": (3,)}
    rng = np.random.default_rng(0)
    arrays = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    jitem = JModelItem(lambda p, b: 0.0, {n: jnp.asarray(a) for n, a in arrays.items()})
    titem = ModelItem(lambda p, b: 0.0, {n: torch.from_numpy(np.array(a))
                                         for n, a in arrays.items()})
    jplans = jpart.build_var_plans(JPS().build(jitem, JResourceSpec.from_num_chips(r)),
                                   jitem, r)
    tplans = tpart.build_var_plans(PS().build(titem, ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "gpus": list(range(r)), "chief": True}]})), titem, r)
    for name in shapes:
        jp, tp = jplans[name], tplans[name]
        assert tp.sync.value == jp.sync.value and tp.placement.value == jp.placement.value
        assert tpart.flat_shard_update(tp) == jpart.flat_shard_update(jp)
        assert tpart.update_space_shape(tp, r) == jpart.update_space_shape(jp, r)
    assert tplans["s"].sync == tpart.SyncKind.ALL_REDUCE
    assert tplans["w"].sync == tpart.SyncKind.PS
    assert tpart.update_space_shape(tplans["w"], r) == (-(-35 // r) * r,)


_OPTS = {"adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3), STEPS * 1e-3),
         "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1), 1e-5)}


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_default_builder_three_steps_match_jax_autodist(opt):
    make_j, make_t, params_atol = _OPTS[opt]
    toks = np.random.default_rng(0).integers(0, jgpt.GPT_TINY.vocab_size,
                                             (B, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    j_loss_fn, j_params, j_sparse = jtrain.gpt_capture(jgpt.GPT_TINY, SEQ)
    j_sess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(1)).distribute(
        j_loss_fn, j_params, make_j(), sparse_vars=j_sparse, has_rng=True)
    j_losses = [float(j_sess.run(batch)["loss"]) for _ in range(STEPS)]

    t_loss_fn, _, t_sparse = gpt_capture(tgpt.GPT_TINY, SEQ, device="cpu")
    t_params = {convert.torch_to_jax_name(n): t
                for n, t in convert.params_from_jax(j_params).items()}
    t_sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                      device="cpu").distribute(
        t_loss_fn, t_params, make_t(), sparse_vars=t_sparse, has_rng=True)
    assert {n.WhichOneof("synchronizer")
            for n in t_sess.transformer.strategy.node_config} == {"PSSynchronizer"}
    t = t_sess.transformer   # no AllReduce bucket: each bucket a PS group
    assert t.ps_groups and [b.key for b in t.buckets] == [f"ps_{d}" for d in t.ps_groups]
    t_losses = [t_sess.run(batch)["loss"].item() for _ in range(STEPS)]

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0] and t_sess.step == STEPS
    final, _ = convert.params_to_jax(
        {convert.jax_to_torch_name(n): t for n, t in t_sess.params().items()})
    j_final = dict(jax.tree_util.tree_leaves_with_path(j_sess.params()))
    for path, leaf in jax.tree_util.tree_leaves_with_path(final):
        np.testing.assert_allclose(leaf, np.asarray(j_final[path]), atol=params_atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _linear_session(builder, **options):
    params = {"w": torch.ones(6), "b": torch.zeros(())}
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=builder, device="cpu").distribute(
        lambda p, b: torch.mean((b @ p["w"] + p["b"]) ** 2), params, optim.sgd(0.05),
        **options)


@pytest.mark.parametrize("kwargs,item", [({"sync": False}, "item 6"),
                                         ({"staleness": 2}, "item 6")])
def test_async_and_stale_ps_raise_at_distribute(kwargs, item):
    builder = PS(**kwargs)    # builds: the raise comes at distribute
    with pytest.raises(NotImplementedError, match=item):
        _linear_session(builder)


def test_ps_axes_subset_raises_and_whole_axis_runs():
    with pytest.raises(NotImplementedError, match="item 6"):
        PSLoadBalancing(ps_axes=("replica_ici",))
    sess = _linear_session(PS(ps_axes=("replica",)))
    node = sess.transformer.strategy.node_config[0]
    assert node.PSSynchronizer.reduction_destination == "mesh:replica"
    assert sess.transformer.plans["w"].ps_axes is None
    sess.run(np.ones((4, 6), np.float32))
    assert sess.step == 1


def test_session_loops_and_the_scalar_stay_replicated():
    sess = _linear_session(PSLoadBalancing())
    batch = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    assert sess.run_steps([batch] * 3)["step"] == 3
    assert sess.fit(lambda step: batch, steps=5)["step"] == 5 and sess.step == 5
    assert sess.fit(lambda step: batch, steps=5) is None and sess.step == 5
    with pytest.raises(NotImplementedError, match="item 7"):
        sess.fit(lambda step: batch, steps=6, checkpoint_path="ckpt")
    assert sess.check_replication() == []
    t = sess.transformer
    assert list(sess.state["shards"]) == ["w"]
    # the scalar's AllReduce bucket, then the PS group
    assert [(b.var_names, b.key == "ps_float32") for b in t.buckets] == [
        (("b",), False), (("w",), True)] and t.sharded_buckets == t.buckets[1:]
    # the scalar's gradient takes the all-reduce bucket, its update in place
    assert sess.state["opt_state"].param_groups[0]["params"][0] is sess.state["params"]["b"]


def test_ps_sync_is_one_scatter_and_one_gather_per_dtype(monkeypatch):
    from autodist_tpu_torch.parallel import collectives

    calls = []
    for fn in ("psum_scatter", "all_gather_into_tensor"):
        real = getattr(collectives, fn)
        monkeypatch.setattr(collectives, fn, lambda x, group=None, fn=fn, real=real: (
            calls.append((fn, x.dtype)), real(x, group))[1])
    params = {"w": torch.ones(6), "v": torch.ones(3), "d": torch.ones(4, dtype=torch.float64)}
    sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC), device="cpu").distribute(
        lambda p, b: torch.mean((b @ p["w"]) ** 2) + p["v"].sum() ** 2
        + (p["d"] ** 2).sum().float(), params, optim.sgd(0.05))
    assert sess.transformer.ps_groups == {"float64": ["d"], "float32": ["v", "w"]}
    sess.run(np.ones((4, 6), np.float32))
    assert sorted(calls, key=str) == sorted(
        [(fn, dt) for fn in ("psum_scatter", "all_gather_into_tensor")
         for dt in (torch.float32, torch.float64)], key=str)
    assert sess.params()["d"].dtype == torch.float64
    np.testing.assert_allclose(sess.params()["d"].numpy(), np.full(4, 0.9))


def test_accumulation_splits_the_replica_batch():
    sess = _linear_session(PSLoadBalancing(), accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps=3"):
        sess.run(np.ones((4, 6), np.float32))
    with pytest.raises(ValueError, match="accum_steps=3"):
        sess.run(np.ones((2, 6), np.float32))
    assert sess.run(np.ones((6, 6), np.float32))["step"] == 1


# -- the 4-rank gloo world ----------------------------------------------------

def _jax_gpt_params():
    _, params, _ = jtrain.gpt_capture(jgpt.GPT_TINY, ranks.GPT_SEQ)
    return params


@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["ps"] for res in results]


def _oracle(loss, opt, params, batch, steps):
    """Single-device optax on the global batch, as the JAX tests' oracles."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p)
    for _ in range(steps):
        g = jax.grad(loss)(p, batch)
        u, st = opt.update(g, st, p)
        p = optax.apply_updates(p, u)
    return p


def _linear(p, b):
    return jnp.mean((b @ p["w"] + p["b"]) ** 2)


def _masked_mse(p, batch):
    per_ex = jnp.mean((batch["x"] @ p["w"] + p["b"]) ** 2, axis=-1)
    return jnp.mean(per_ex)


def _close(got, want, atol):
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("builder", ranks.PS_BUILDERS)
def test_value_exact_sync_ps_over_four_ranks(gloo, builder, opt):
    inputs, results = gloo
    jopt = optax.sgd(0.1) if opt == "sgd" else optax.adam(0.05)
    exp = _oracle(_linear, jopt, inputs["linear_params"],
                  jnp.asarray(inputs["linear_batch"]), 3)
    for res in results:
        got = res["linear", builder, opt]
        assert got["step"] == 3 and np.isfinite(got["loss"])
        assert got["syncs"] == ["PSSynchronizer"] * 2
        _close(got["params"], exp, 2e-5)
        assert got["strategy_id"] == results[0]["linear", builder, opt]["strategy_id"]
        if opt == "adam":   # the moments live on the flat shards: ceil(n / R)
            assert got["moments"] == {"b": (1,), "w": (9,)}


@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_accumulation_matches_single_shot_over_four_ranks(gloo, builder):
    inputs, results = gloo
    exp = _oracle(lambda p, b: jnp.mean((b @ p["w"]) ** 2), optax.sgd(0.05),
                  {"w": np.ones(6, np.float32)}, jnp.asarray(inputs["accum_batch"]), 3)
    for res in results:
        one = res["accum", builder, 1]
        np.testing.assert_allclose(one["params"]["w"], exp["w"], atol=1e-6)
        for a in ranks.ACCUM_COUNTS[1:]:
            got = res["accum", builder, a]
            np.testing.assert_allclose(got["params"]["w"], one["params"]["w"], atol=1e-6)
            assert abs(got["loss"] - one["loss"]) < 1e-6


def test_accumulation_errors_threads_state_and_takes_rng_aux(gloo):
    _, results = gloo
    for res in results:
        assert "accum_steps=3" in res["accum_error"]
        assert abs(res["ema", 1] - 0.5) < 1e-6 and abs(res["ema", 4] - 0.9375) < 1e-6
        assert np.isfinite(res["rng_aux"]["loss"]) and np.isfinite(res["rng_aux"]["n"])
    # aux is averaged over the replicas: every rank reports the same value
    assert len({res["rng_aux"]["n"] for res in results}) == 1


@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_clip_matches_single_device_over_four_ranks(gloo, builder):
    inputs, results = gloo
    opt = optax.chain(optax.clip_by_global_norm(ranks.CLIP_NORM), optax.sgd(0.1))
    exp = _oracle(_linear, opt, inputs["clip_params"], jnp.asarray(inputs["clip_batch"]), 3)
    g = jax.grad(_linear)({k: jnp.asarray(v) for k, v in inputs["clip_params"].items()},
                          jnp.asarray(inputs["clip_batch"]))
    assert float(optax.global_norm(g)) > 10 * ranks.CLIP_NORM   # clipping engages
    for res in results:
        got = res["clip", builder]
        _close(got["params"], exp, 1e-5)
        assert np.isfinite(got["grad_norm"]) and got["grad_norm"] > ranks.CLIP_NORM


@pytest.mark.parametrize("n", ranks.UNEVEN_SIZES)
@pytest.mark.parametrize("builder", ["AllReduce", "PS"])
def test_uneven_batch_value_exact_over_four_ranks(gloo, builder, n):
    inputs, results = gloo
    batch = {"x": jnp.asarray(inputs["uneven_batches"][n])}
    exp = _oracle(_masked_mse, optax.sgd(0.1), inputs["uneven_params"], batch, 2)
    p1 = _oracle(_masked_mse, optax.sgd(0.1), inputs["uneven_params"], batch, 1)
    exp_loss = float(_masked_mse(p1, batch))
    for res in results:
        got = res["uneven", builder, n]
        _close(got["params"], exp, 2e-5)
        assert abs(got["loss"] - exp_loss) < 1e-4


def test_uneven_accumulation_predict_even_batch_and_optin_over_four_ranks(gloo):
    inputs, results = gloo
    exp = _oracle(_masked_mse, optax.sgd(0.1), inputs["uneven_params"],
                  {"x": jnp.asarray(inputs["uneven_accum_batch"])}, 1)
    for res in results:
        _close(res["uneven_accum"]["params"], exp, 2e-5)
        assert res["predict_shape"] == (10, 3)
        assert res["even_batch"] == (0, ["x"])
        assert "batch_mask=True" in res["uneven_error"]


def test_session_methods_over_four_ranks(gloo):
    _, results = gloo
    for res in results:
        assert res["session_steps"] == [2, 5]
        # healthy, then every rank names the variable rank 1 perturbed
        assert res["replication"] == [[], ["w"]]
