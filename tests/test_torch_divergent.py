"""The port's DIVERGENT placement (the synchronous reading of bounded
staleness) against the JAX package.

- The plans of ``PS(staleness=2)``, ``PS(sync=False)``,
  ``PSLoadBalancing(staleness=1)``, ``Parallax(staleness=1)`` and
  ``PartitionedPS(sync=False)`` at R = 1 and 4: placement, sync,
  ``sync_period``, ``ps_axes`` and ``storage_spec`` equal JAX's, and a
  rank stores one full copy where JAX stacks R of them (``(R, *shape)``);
  a scalar stays AllReduce and a partitioned variable SHARDED
  (``tests/test_partitioner.py:50-55``).
- At R = 1 the averaging is the identity: ``PS(staleness=2)`` gives
  ``AllReduce()``'s losses and parameters bitwise, and the plan dump
  prints ``staleness=2``.
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``, the ``stale``
  entry), against the JAX engine on 4 of the conftest's virtual CPU
  devices on the same numpy inputs:
  ``tests/test_end_to_end.py::test_staleness_local_updates_then_average``
  and ``::test_divergent_params_mid_window`` (each rank's copy against
  JAX's row of the ``(R, *shape)`` storage, ``params()`` against JAX's
  mean and the closed forms, atol 1e-4), the linear model under adam
  with each rank's moments (atol 2e-5), the clipped norm (rtol 1e-5), a
  sparse table under ``Parallax(staleness=1)``, and ``check_replication``
  passing over copies that differ by design.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.ops.sparse import embedding_lookup as jembedding_lookup
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec

CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
JSPEC4 = JResourceSpec(resource_info={"nodes": [{"address": "localhost",
                                                 "chips": [0, 1, 2, 3]}]})
SHAPES = {"emb": (50, 4), "s": (), "w": (12, 3), "b": (3,)}
BUILDERS = {
    "PS_stale": ("PS", dict(staleness=2)),
    "PS_async": ("PS", dict(sync=False)),
    "PSLoadBalancing_stale": ("PSLoadBalancing", dict(staleness=1)),
    "Parallax_stale": ("Parallax", dict(staleness=1)),
    "PartitionedPS_async": ("PartitionedPS", dict(sync=False, max_shards=8)),
}


@pytest.fixture(autouse=True)
def no_thread_outlives_the_test():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 2.0
    extra = [t for t in threading.enumerate() if t not in before]
    while extra and time.monotonic() < deadline:
        time.sleep(0.01)
        extra = [t for t in threading.enumerate() if t not in before]
    assert not extra, f"threads outlive the test: {[t.name for t in extra]}"


def _items():
    arrays = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    return (JModelItem(lambda p, b: 0.0, {n: jnp.asarray(a) for n, a in arrays.items()},
                       sparse_vars=["emb"]),
            ModelItem(lambda p, b: 0.0, {n: torch.from_numpy(a) for n, a in arrays.items()},
                      sparse_vars=["emb"]))


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_divergent_plans_match_jax(builder, r):
    name, kwargs = BUILDERS[builder]
    jitem, titem = _items()
    info = {"nodes": [{"address": "localhost", "gpus": list(range(r)), "chief": True}]}
    jspec = JResourceSpec(resource_info={"nodes": [{"address": "localhost",
                                                    "chips": list(range(r))}]})
    jplans = jpart.build_var_plans(getattr(jstrategy, name)(**kwargs).build(jitem, jspec),
                                   jitem, r)
    tplans = tpart.build_var_plans(getattr(tstrategy, name)(**kwargs).build(
        titem, ResourceSpec(resource_info=info)), titem, r)
    assert sorted(tplans) == sorted(jplans)
    divergent = set()
    for n, jp in jplans.items():
        tp = tplans[n]
        assert (tp.placement.value, tp.sync.value, tp.sparse, tp.ps_sync, tp.staleness,
                tp.sync_period, tp.ps_axes) == (
            jp.placement.value, jp.sync.value, jp.sparse, jp.ps_sync, jp.staleness,
            jp.sync_period, jp.ps_axes), n
        assert tpart.storage_spec(tp) == tuple(jpart.storage_spec(jp)), n
        shape, ushape = tpart.storage_shape(tp, r), tpart.update_space_shape(tp, r)
        if jp.placement == jpart.Placement.DIVERGENT:
            divergent.add(n)
            # a rank stores its own copy; JAX stacks the R copies
            assert (r,) + shape == jpart.storage_shape(jp, r) and shape == SHAPES[n], n
            assert (r,) + ushape == jpart.update_space_shape(jp, r), n
        else:
            assert shape == jpart.storage_shape(jp, r), n
            assert ushape == jpart.update_space_shape(jp, r), n
    assert tplans["s"].placement == tpart.Placement.REPLICATED   # scalars never diverge
    want = {"PS_stale": {"emb", "w", "b"}, "PS_async": {"emb", "w", "b"},
            "PSLoadBalancing_stale": {"emb", "w", "b"}, "Parallax_stale": {"emb"},
            "PartitionedPS_async": set()}[builder]   # a partitioned variable stays SHARDED
    assert divergent == want


def _session(builder, params, opt, **kw):
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=builder, device="cpu").distribute(
        lambda p, b: torch.mean((torch.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"] - b["y"]) ** 2),
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}, opt, **kw)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_one_replica_staleness_equals_allreduce_bitwise(opt):
    """At R = 1 the period's average is the copy itself and launches nothing:
    the losses and parameters are AllReduce's, bit for bit."""
    params, batch = ranks.mlp_inputs()
    make = (lambda: optim.sgd(0.1)) if opt == "sgd" else (lambda: optim.adam(0.05))
    stale = _session(tstrategy.PS(staleness=2), params, make())
    flat = _session(tstrategy.AllReduce(), params, make())
    t = stale.transformer
    assert t.divergent_names == ["b1", "w1", "w2"] and t.buckets == []
    assert "w1: shape=(32, 16) divergent/ps staleness=2" in t.plan_summary()
    losses = [(stale.run(batch)["loss"].item(), flat.run(batch)["loss"].item())
              for _ in range(4)]
    assert all(a == b for a, b in losses), losses
    for n, v in flat.params().items():
        assert torch.equal(stale.params()[n], v), n
    assert stale.check_replication() == [] and stale.memory_stats() == {"cpu": None}


# -- the 4-rank gloo world -------------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["stale"] for res in results]


def _jax_run(builder, loss, params, opt, batches, **kw):
    """The JAX engine's run on 4 virtual CPU devices, in numpy: its stored
    ``(R, *shape)`` copies (``own``), ``params()``, the metrics of each step
    and, for adam, the stacked and the canonical moments."""
    sess = JAutoDist(resource_spec=JSPEC4, strategy_builder=builder).distribute(
        loss, {k: jnp.asarray(v) for k, v in params.items()}, opt, **kw)
    metrics = [sess.run(b) for b in batches]
    out = {"own": {n: np.asarray(v) for n, v in sess.state["params"].items()},
           "params": {k: np.asarray(v) for k, v in sess.params().items()},
           "metrics": [jax.tree.map(np.asarray, m) for m in metrics]}
    if hasattr(sess.state["opt_state"][0], "mu"):   # adam
        adam = sess.state["opt_state"][0]
        canon = sess._t.canonicalize_opt_state(sess.state["opt_state"])[0]
        out["moments"] = {k: {n: np.asarray(v) for n, v in getattr(adam, k).items()}
                          for k in ("mu", "nu")}
        out["canonical_moments"] = {k: {n: np.asarray(v) for n, v in getattr(canon, k).items()}
                                    for k in ("mu", "nu")}
    return out


def _jax_stale():
    """The JAX engine's runs of the world's stale cases."""
    inputs = oracle.world_inputs()
    b = ranks.STALE_BATCH
    out = {}
    for key, s, steps in (("average", ranks.STALE_AVERAGE, 2), ("mid", ranks.STALE_MID, 1)):
        out[key] = _jax_run(jstrategy.PS(staleness=s), lambda p, x: jnp.mean(x @ p["w"]),
                            {"w": np.zeros(8, np.float32)}, optax.sgd(0.1), [b] * steps)
    out["adam"] = _jax_run(jstrategy.PS(staleness=ranks.STALE_PERIOD_S),
                           lambda p, x: jnp.mean((x @ p["w"] + p["b"]) ** 2),
                           inputs["linear_params"], optax.adam(0.05),
                           [inputs["linear_batch"]] * ranks.STALE_STEPS)
    out["clip"] = _jax_run(jstrategy.PS(staleness=ranks.STALE_PERIOD_S),
                           lambda p, x: jnp.mean((x @ p["w"] + p["b"]) ** 2),
                           inputs["clip_params"], optax.sgd(0.5), [inputs["clip_batch"]] * 2,
                           clip_global_norm=ranks.CLIP_NORM)
    out["parallax"] = _jax_run(
        jstrategy.Parallax(staleness=1),
        lambda p, x: jnp.mean((jembedding_lookup(p["emb"], x["ids"]) @ p["w"])[..., 0] ** 2),
        inputs["parallax_params"], optax.sgd(ranks.SUBSET_LR),
        [{"ids": inputs["parallax_ids"]}] * 2, sparse_vars=["emb"])
    return out


worker.submit((_jax_stale,))


@pytest.fixture(scope="module")
def jax_stale():
    return worker.result(_jax_stale)


def _cases(results, key):
    return [res[key] for res in results]


def _own_copies_match_jax(results, jrun, atol):
    """Each rank's stored copy against its row of JAX's (R, *shape) storage
    (a replicated variable against the whole)."""
    for rank, res in enumerate(results):
        for n, own in res["own"].items():
            j = jrun["own"][n]
            want = j[rank] if res["plans"][n] == "divergent" else j
            np.testing.assert_allclose(own, want, atol=atol, rtol=0, err_msg=f"{rank} {n}")


def _params_match(results, jrun, atol):
    want = jrun["params"]
    for res in results:
        for n, v in want.items():
            np.testing.assert_allclose(res["params"][n], v, atol=atol, rtol=0, err_msg=n)
        assert res["strategy_id"] == results[0]["strategy_id"]


def test_staleness_local_updates_then_average_over_four_ranks(gloo, jax_stale):
    """Two local steps, then the average: for the linear loss that is two
    steps with the global mean gradient, on every rank's copy."""
    results = _cases(gloo[1], "average")
    jsess = jax_stale["average"]
    _own_copies_match_jax(results, jsess, 1e-4)
    _params_match(results, jsess, 1e-4)
    for res in results:
        assert res["plans"] == {"w": "divergent"} and res["step"] == 2
        np.testing.assert_allclose(res["own"]["w"], -0.2 * ranks.STALE_BATCH.mean(0),
                                   atol=1e-4)


def test_divergent_params_mid_window_over_four_ranks(gloo, jax_stale):
    """Inside a period each rank's copy took only its own rows' gradient;
    ``params()`` returns the mean, and ``check_replication`` passes over
    the copies that differ by design."""
    results = _cases(gloo[1], "mid")
    jsess = jax_stale["mid"]
    _own_copies_match_jax(results, jsess, 1e-4)
    _params_match(results, jsess, 1e-4)
    rows = np.split(ranks.STALE_BATCH, ranks.WORLD)
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res["own"]["w"], -0.1 * rows[rank].mean(0), atol=1e-4)
        np.testing.assert_allclose(res["params"]["w"], -0.1 * ranks.STALE_BATCH.mean(0),
                                   atol=1e-4)
        assert res["replication"] == []
    assert len({res["own"]["w"][0] for res in results}) == ranks.WORLD


def test_divergent_adam_moments_stay_per_rank(gloo, jax_stale):
    """The optimizer state is the rank's own and never averaged: each rank's
    moments equal JAX's row of its stacked state, their canonical form the
    mean over the ranks (JAX ``canonicalize_opt_state``)."""
    results = _cases(gloo[1], "adam")
    jsess = jax_stale["adam"]
    _own_copies_match_jax(results, jsess, 2e-5)
    _params_match(results, jsess, 2e-5)
    adam, canon = jsess["moments"], jsess["canonical_moments"]
    for rank, res in enumerate(results):
        for (n, k), v in res["moments"].items():
            key = "mu" if k == "exp_avg" else "nu"
            j, jc = adam[key], canon[key]
            np.testing.assert_allclose(v, np.asarray(j[n])[rank], atol=2e-5, rtol=1e-5,
                                       err_msg=f"{rank} {n} {k}")
            np.testing.assert_allclose(res["canonical_moments"][n, k], np.asarray(jc[n]),
                                       atol=2e-5, rtol=1e-5, err_msg=f"{n} {k}")
    # the moments differ between the ranks (local gradients)
    assert not np.array_equal(results[0]["moments"]["w", "exp_avg"],
                              results[1]["moments"]["w", "exp_avg"])


def test_divergent_clip_norm_over_four_ranks(gloo, jax_stale):
    """Each rank adds its local squared norm over R to the all-reduced total
    (JAX ``graph_transformer.py:1422-1426``): the same norm on every rank,
    JAX's, and the clipped update."""
    results = _cases(gloo[1], "clip")
    jsess = jax_stale["clip"]
    want = [float(m["grad_norm"]) for m in jsess["metrics"]]
    for res in results:
        np.testing.assert_allclose(res["norms"], want, rtol=1e-5)
        assert max(res["norms"]) > ranks.CLIP_NORM   # the clip acted
    _own_copies_match_jax(results, jsess, 1e-5)
    _params_match(results, jsess, 1e-5)


def test_parallax_stale_sparse_table_over_four_ranks(gloo, jax_stale):
    """A sparse table under ``Parallax(staleness=1)``: a DIVERGENT copy whose
    rows arrive summed by the synced lookup, so the copies stay equal; the
    dense variable stays AllReduce."""
    results = _cases(gloo[1], "parallax")
    jsess = jax_stale["parallax"]
    _own_copies_match_jax(results, jsess, 1e-6)
    _params_match(results, jsess, 1e-6)
    for res in results:
        assert res["plans"] == {"emb": "divergent", "w": "replicated"}
        np.testing.assert_array_equal(res["own"]["emb"], results[0]["own"]["emb"])
