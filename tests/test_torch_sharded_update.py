"""The AllReduce family's sharded weight update and bf16-compute / f32-master
precision, the port against the JAX package.

- ``resolve_sharded_update`` and ``resolve_precision`` take the JAX names,
  aliases and enum values; ``AllReduce(sharded_update=...)`` and
  ``AllReduce(precision="bf16_master")`` (which implies the sharded
  update) build the JAX builder's node configs.
- The plans: a scalar never shards, ``update_space_shape`` is JAX's at
  R = 4, a block codec keeps the replicated update and with it F32, a
  non-f32 variable keeps its dtype; ``plan_buckets`` gives JAX's keys and
  shard plans (``num_shards``, ``shard_sizes``, ``precision``) on GPT-tiny.
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``), on
  ``tests/test_sharded_update.py::_train``'s tanh MLP (2 steps), held
  against the JAX engine's outputs on 4 virtual CPU devices and against
  the port's replicated update, at the JAX tests' tolerances: per
  optimizer atol 1e-5 with the loss within 1e-4; per codec None 1e-5, BF16
  and BF16EF 2e-2; ``accum_steps=2`` 1e-5; the global-norm clip 1e-5 with
  the norm within 1e-5 relative.  ``Int8Compressor`` falls back to the
  replicated update (bitwise equal to it).  bf16 master against f32 at
  ``tests/test_mixed_precision.py``'s parity bounds (2e-2; adam 0.2, steps
  x lr x 2) and the loss within 2e-2; against the JAX engine's bf16 master
  at atol 1e-3 and the loss within 1e-3 (one bf16 rounding at |x| < 1
  is at most 2^-9 = 2e-3; measured 2.8e-4 under adam, 1.5e-6 under sgd and
  momentum, while one adam step moves each parameter by ~lr = 0.05),
  every ``params()`` leaf f32, the
  stored full-shape copy bf16 and the master a flat f32 shard.
  ``check_replication() == []`` on every session, and ``predict`` gives
  the forward of the final f32 parameters (atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.kernel.synchronization import all_reduce as jar
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import base as jbase
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.kernel.synchronization import all_reduce as tar
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.strategy import base as tbase

_C = schema.AllReduceSynchronizer
R = ranks.WORLD
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
GPU4 = {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3], "chief": True}]}
JSPEC4 = JResourceSpec(resource_info={"nodes": [{"address": "localhost",
                                                 "chips": [0, 1, 2, 3]}]})
CODEC_TOL = {"NoneCompressor": 1e-5, "BF16Compressor": 2e-2, "BF16CompressorEF": 2e-2}
BF16_MASTER_TOL = 2e-2
PARITY_ATOL = {"sgd": BF16_MASTER_TOL, "momentum": BF16_MASTER_TOL, "adam": 2 * 0.05 * 2}
JAX_BF16_MASTER_ATOL = 1e-3   # the port's bf16 master against the JAX engine's
_JOPTS = {"sgd": lambda: optax.sgd(0.1), "momentum": lambda: optax.sgd(0.1, momentum=0.9),
          "adam": lambda: optax.adam(0.05)}


# -- knobs, builders, plans and buckets ----------------------------------------

@pytest.mark.parametrize("kind", ["sharded_update", "precision"])
def test_resolvers_take_the_jax_names_and_values(kind):
    jres, tres = getattr(jbase, f"resolve_{kind}"), getattr(tbase, f"resolve_{kind}")
    aliases = getattr(jbase, f"_{kind.upper()}_ALIASES")
    for name in list(aliases) + [n.upper() for n in aliases] + sorted(set(aliases.values())):
        assert int(tres(name)) == int(jres(name)), name
    with pytest.raises(ValueError):
        tres("bogus")


def _mlp_items():
    params, _ = ranks.mlp_inputs()
    return (JModelItem(lambda p, b: 0.0, {k: jnp.asarray(v) for k, v in params.items()}),
            ModelItem(lambda p, b: 0.0, {k: torch.from_numpy(v) for k, v in params.items()}))


@pytest.mark.parametrize("kwargs", [{"sharded_update": "sharded"}, {"precision": "bf16_master"},
                                    {"precision": "mixed", "compressor": "BF16CompressorEF"}])
def test_builder_nodes_match_jax(kwargs):
    jitem, titem = _mlp_items()
    js = JAllReduce(**kwargs).build(jitem, JSPEC4)
    ts = AllReduce(**kwargs).build(titem, ResourceSpec(resource_info=GPU4))
    fields = ("spec", "compressor", "group", "schedule", "hierarchy", "sharded_update",
              "precision")
    assert [n.var_name for n in ts.node_config] == [n.var_name for n in js.node_config]
    for jn, tn in zip(js.node_config, ts.node_config):
        j, t = jn.AllReduceSynchronizer, tn.AllReduceSynchronizer
        assert [int(getattr(t, f)) for f in fields] == [int(getattr(j, f)) for f in fields]
        assert int(t.sharded_update) == _C.SHARDED


def test_scalars_never_shard_and_update_spaces_match_jax():
    shapes = {"w": (32, 8), "temp": (), "v": (7,)}
    jitem = JModelItem(lambda p, b: 0.0, {n: jnp.zeros(s) for n, s in shapes.items()})
    titem = ModelItem(lambda p, b: 0.0, {n: torch.zeros(s) for n, s in shapes.items()})
    jplans = jpart.build_var_plans(JAllReduce(sharded_update="sharded").build(jitem, JSPEC4),
                                   jitem, R)
    tplans = tpart.build_var_plans(AllReduce(sharded_update="sharded").build(
        titem, ResourceSpec(resource_info=GPU4)), titem, R)
    for n in shapes:
        jp, tp = jplans[n], tplans[n]
        assert int(tp.sharded_update) == int(jp.sharded_update)
        assert tpart.plan_sharded_update(tp) == jpart.plan_sharded_update(jp)
        assert tpart.flat_shard_update(tp) == jpart.flat_shard_update(jp)
        assert tpart.update_space_shape(tp, R) == jpart.update_space_shape(jp, R)
    assert tplans["temp"].sharded_update == 0 and tpart.update_space_shape(tplans["w"], R) == (256,)


@pytest.mark.parametrize("kwargs", [{"sharded_update": "sharded"}, {"precision": "bf16_master"},
                                    {"sharded_update": "sharded",
                                     "compressor": "Int8Compressor"}])
def test_buckets_match_jax_on_gpt_tiny(kwargs):
    params = jax.eval_shape(lambda: jgpt.GPT(jgpt.GPT_TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])
    jitem = JModelItem(lambda p, b: 0.0, params)
    model = tgpt.GPT(tgpt.GPT_TINY, device="meta")
    titem = ModelItem(lambda p, b: 0.0, {convert.torch_to_jax_name(n): p
                                         for n, p in model.named_parameters()})
    builder = dict(chunk_size=8, **kwargs)
    jplans = jpart.build_var_plans(JAllReduce(**builder).build(jitem, JSPEC4), jitem, R)
    tplans = tpart.build_var_plans(AllReduce(**builder).build(
        titem, ResourceSpec(resource_info=GPU4)), titem, R)
    jb = jar.plan_buckets(jplans, {v.name: v.shape for v in jitem.var_infos},
                          {v.name: v.dtype for v in jitem.var_infos}, num_replicas=R)
    tb = tar.plan_buckets(tplans, {v.name: v.shape for v in titem.var_infos},
                          {v.name: v.dtype for v in titem.var_infos}, num_replicas=R)
    assert len(tb) == len(jb) == 4
    for j, t in zip(jb, tb):
        assert (t.key, t.var_names, t.sizes, t.num_shards, t.shard_sizes, t.precision,
                t.shard_total, t.padded_total) == (
            j.key, j.var_names, j.sizes, j.num_shards, j.shard_sizes, j.precision,
            j.shard_total, j.padded_total)
        assert tar.bucket_sharded(t) == jar.bucket_sharded(j)
        assert tar.elementwise(t) == jar.elementwise(j)


def _local_session(builder, params, loss):
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC), strategy_builder=builder,
                    device="cpu").distribute(loss, params, optim.sgd(0.1))


def test_block_codec_falls_back_to_replicated_f32_and_bf16_vars_keep_their_dtype():
    def loss(p, b):
        return (b @ p["w"].float()).square().mean() + p["e"].float().square().sum()

    params = {"w": torch.ones(8, 4), "e": torch.ones(3, 4, dtype=torch.bfloat16)}
    sess = _local_session(AllReduce(precision="bf16_master", compressor="Int8Compressor"),
                          params, loss)
    t = sess.transformer
    assert not t.sync_sharded_update and not t.sync_mixed_precision
    assert t.precision_buckets == [] and not sess.state["shards"]
    assert all(p.precision == 0 and p.sharded_update == 0 for p in t.plans.values())
    sess = _local_session(AllReduce(precision="bf16_master"), params, loss)
    t = sess.transformer
    assert t.sync_mixed_precision and not tpart.master_shard_storage(t.plans["e"])
    assert [b.var_names for b in t.precision_buckets] == [("w",)]
    assert sess.state["params"]["w"].dtype == torch.bfloat16
    assert sess.state["shards"]["w"].dtype == torch.float32
    # e: the sharded update in its own dtype, no master
    assert sess.state["params"]["e"].dtype == sess.state["shards"]["e"].dtype == torch.bfloat16
    sess.run(np.ones((2, 8), np.float32))
    out = sess.params()
    assert out["w"].dtype == torch.float32 and out["e"].dtype == torch.bfloat16
    # d/dw mean((1 @ w)^2) = 2 * 8 / 4 = 4 everywhere: w = 1 - 0.1 * 4
    np.testing.assert_allclose(out["w"].numpy(), np.full((8, 4), 0.6), rtol=1e-6)
    summary = t.sharded_update_summary()
    # w's bf16 compute copy (32 x 2 bytes) and e's own bf16 gather (12 x 2)
    assert summary["bf16_master_vars"] == 1 and summary["param_gather_bytes"] == 88.0


# -- the 4-rank gloo world -----------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["sharded"] for res in results]


def _jax_train(inputs, opt="sgd", compressor="NoneCompressor", sharded="replicated",
               precision="f32", accum=1):
    """The JAX engine's run of the same case on 4 virtual CPU devices."""
    def loss(p, b):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] - b["y"]) ** 2)

    ad = JAutoDist(resource_spec=JSPEC4, strategy_builder=JAllReduce(
        compressor=compressor, sharded_update=sharded, precision=precision))
    sess = ad.distribute(loss, {k: jnp.asarray(v) for k, v in inputs["mlp_params"].items()},
                         _JOPTS[opt](), accum_steps=accum)
    for _ in range(ranks.SHARDED_STEPS):
        m = sess.run(inputs["mlp_batch"])
    return {k: np.asarray(v) for k, v in sess.params().items()}, float(m["loss"])


def _jax_runs():
    """The JAX engine's runs of the world's sharded-update cases."""
    inputs = oracle.world_inputs()
    out = {}
    for opt in ranks.SHARDED_OPTS:
        out["opt", opt] = _jax_train(inputs, opt, sharded="sharded")
        out["bf16_master", opt] = _jax_train(inputs, opt, precision="bf16_master")
    for comp in ranks.SHARDED_CODECS[:2]:
        out["codec", comp] = _jax_train(inputs, compressor=comp, sharded="sharded")
    out["accum"] = _jax_train(inputs, "adam", sharded="sharded", accum=2)
    return out


worker.submit((_jax_runs,))


@pytest.fixture(scope="module")
def jax_runs():
    return worker.result(_jax_runs)


def _close(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=f"{what} {k}")


def _mlp_forward(params, batch):
    return np.tanh(batch["x"] @ params["w1"] + params["b1"]) @ params["w2"]


def _same_run_on_every_rank(results, key):
    first = results[0][key]
    for res in results[1:]:
        assert res[key]["strategy_id"] == first["strategy_id"]
        for n, p in res[key]["params"].items():
            assert np.array_equal(p, first["params"][n]), (key, n)
    for res in results:
        assert res[key]["replication"] == [], key


@pytest.mark.parametrize("opt", ranks.SHARDED_OPTS)
def test_sharded_update_per_optimizer_over_four_ranks(gloo, jax_runs, opt):
    inputs, results = gloo
    batch = inputs["mlp_batch"]
    j_params, j_loss = jax_runs["opt", opt]
    _same_run_on_every_rank(results, ("opt", opt, "sharded"))
    for res in results:
        rep, shd = res["opt", opt, "replicated"], res["opt", opt, "sharded"]
        assert shd["sharded"] and not rep["sharded"] and not shd["mixed"]
        np.testing.assert_allclose(shd["predict"], _mlp_forward(shd["params"], batch),
                                   atol=1e-5, rtol=0)
        _close(shd["params"], rep["params"], 1e-5, "sharded vs replicated")
        _close(shd["params"], j_params, 1e-5, "sharded vs the JAX engine")
        assert abs(shd["loss"] - rep["loss"]) < 1e-4 and abs(shd["loss"] - j_loss) < 1e-4
        # the flat 1/R shards and, under adam, the moments on them
        assert shd["shards"] == {"b1": ((4,), "torch.float32"), "w1": ((128,), "torch.float32"),
                                 "w2": ((16,), "torch.float32")}
        if opt == "adam":
            assert shd["moments"] == {"b1": (4,), "w1": (128,), "w2": (16,)}


@pytest.mark.parametrize("comp", ["NoneCompressor", "BF16Compressor", "BF16CompressorEF"])
def test_sharded_update_per_codec_over_four_ranks(gloo, jax_runs, comp):
    _, results = gloo
    key = ("opt", "sgd") if comp == "NoneCompressor" else ("codec", comp)
    j_params, _ = jax_runs[key]
    tol = CODEC_TOL[comp]
    _same_run_on_every_rank(results, key + ("sharded",))
    for res in results:
        rep, shd = res[key + ("replicated",)], res[key + ("sharded",)]
        assert shd["sharded"]
        _close(shd["params"], rep["params"], tol, f"{comp}: sharded vs replicated")
        _close(shd["params"], j_params, tol, f"{comp}: sharded vs the JAX engine")


def test_int8_falls_back_to_the_replicated_update_over_four_ranks(gloo):
    _, results = gloo
    for res in results:
        rep = res["codec", "Int8Compressor", "replicated"]
        shd = res["codec", "Int8Compressor", "sharded"]
        assert not shd["sharded"] and shd["shards"] == {}
        for n, p in rep["params"].items():
            assert np.array_equal(shd["params"][n], p), n


def test_sharded_update_with_accumulation_and_clip_over_four_ranks(gloo, jax_runs):
    _, results = gloo
    j_params, _ = jax_runs["accum"]
    for res in results:
        rep, shd = res["accum", "replicated"], res["accum", "sharded"]
        assert shd["sharded"]
        _close(shd["params"], rep["params"], 1e-5, "accum: sharded vs replicated")
        _close(shd["params"], j_params, 1e-5, "accum: sharded vs the JAX engine")
        rep, shd = res["clip", "replicated"], res["clip", "sharded"]
        assert shd["sharded"] and shd["grad_norm"] > ranks.SHARDED_CLIP   # the clip engages
        assert shd["grad_norm"] == pytest.approx(rep["grad_norm"], rel=1e-5)
        _close(shd["params"], rep["params"], 1e-5, "clip: sharded vs replicated")


def test_sharded_clip_matches_the_jax_engine(gloo):
    inputs, results = gloo

    def loss(p, b):
        return jnp.mean((b["x"] @ p["w"]) ** 2)

    sess = JAutoDist(resource_spec=JSPEC4, strategy_builder=JAllReduce(
        sharded_update="sharded")).distribute(
        loss, {k: jnp.asarray(v) for k, v in inputs["sharded_clip_params"].items()},
        optax.sgd(0.1), clip_global_norm=ranks.SHARDED_CLIP)
    m = sess.run(inputs["sharded_clip_batch"])
    for res in results:
        shd = res["clip", "sharded"]
        assert shd["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
        _close(shd["params"], {k: np.asarray(v) for k, v in sess.params().items()}, 1e-5,
               "clip: sharded vs the JAX engine")


@pytest.mark.parametrize("opt", ranks.SHARDED_OPTS)
def test_bf16_master_per_optimizer_over_four_ranks(gloo, jax_runs, opt):
    inputs, results = gloo
    inputs = inputs["mlp_batch"]
    j_params, j_loss = jax_runs["bf16_master", opt]
    _same_run_on_every_rank(results, ("bf16_master", opt))
    for res in results:
        f32, mixed = res["opt", opt, "replicated"], res["bf16_master", opt]
        assert mixed["mixed"] and mixed["sharded"]
        _close(mixed["params"], f32["params"], PARITY_ATOL[opt], "bf16 master vs f32")
        _close(mixed["params"], j_params, JAX_BF16_MASTER_ATOL, "bf16 master vs the JAX engine")
        assert abs(mixed["loss"] - f32["loss"]) < BF16_MASTER_TOL
        assert abs(mixed["loss"] - j_loss) < JAX_BF16_MASTER_ATOL
        # params() is the f32 master; storage holds a bf16 compute copy and
        # the master lives only as the flat f32 shard
        assert all(p.dtype == np.float32 for p in mixed["params"].values())
        assert mixed["stored"] == {"b1": ((16,), "torch.bfloat16"),
                                   "w1": ((32, 16), "torch.bfloat16"),
                                   "w2": ((16, 4), "torch.bfloat16")}
        assert mixed["shards"] == {"b1": ((4,), "torch.float32"), "w1": ((128,), "torch.float32"),
                                   "w2": ((16,), "torch.float32")}
        # predict runs on the f32 masters, gathered
        np.testing.assert_allclose(mixed["predict"], _mlp_forward(mixed["params"], inputs),
                                   atol=1e-5, rtol=0)
