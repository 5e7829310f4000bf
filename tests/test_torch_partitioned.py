"""The port's partitioned builders, Parallax and the PS over a subset of the
data axes against the JAX package.

- The builders ``PartitionedPS``, ``UnevenPartitionedPS``,
  ``PartitionedAR``, ``RandomAxisPartitionAR(seed=3)`` and ``Parallax``
  on one model item (a sparse table, a scalar, shapes whose dim 0 is
  even, odd and prime), on a one-node and a two-node spec of four GPUs:
  every node's name, ``partition``, its ``part_config`` names and each
  node's synchronizer (destination, group), as the JAX builders emit them
  (device strings read ``GPU`` where JAX's read ``TPU``); the random axes
  follow JAX's for the same seed.
- The plans at R = 1, 3 and 4: placement, partition axis, padded dim,
  logical shards, ``ps_axes``, ``storage_spec`` (JAX's ``PartitionSpec``
  entries), ``storage_shape`` and ``update_space_shape`` equal JAX's.
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``, started once
  per test process), against the single-device optax oracles of the JAX
  tests on the same numpy inputs:
  ``tests/test_end_to_end.py::test_value_exact_sync``'s linear model under
  the four partitioned builders x sgd/adam (atol 2e-5), each rank storing
  only its block of the padded axis, the Adam moments gathered into the
  variables' shapes equal to optax's (atol 2e-5) and each block's round
  trip through ``canonical_leaf`` / ``uncanonical_leaf`` exact; and ``tests/test_ps_mesh_subset.py``
  on ``{replica_dcn: 2, replica_ici: 2}`` with ``ps_axes=("replica_ici",)``:
  one sgd step of ``PS`` and ``PartitionedPS(max_shards=4)`` value-exact
  (atol 1e-5), the scatter and gather on the ICI groups and only a sum on
  the DCN groups (the whole-axis PS as the control: both on the world),
  Parallax routing its sparse variable to the subset PS, axes the mesh
  lacks raising, and the clipped norm exact under the subset (rtol 1e-5,
  parameters atol 1e-6).
- The world fails fast: a rank that exits non-zero fails the first caller
  with its output, and a second caller at once, without starting ranks.
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
from autodist_tpu import strategy as jstrategy
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec

SPECS = {
    "one_node": {"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3], "chief": True}]},
    "two_nodes": {"nodes": [{"address": "10.0.0.1", "gpus": [0, 1], "chief": True},
                            {"address": "10.0.0.2", "gpus": [0, 1]}]},
}
SHAPES = {"b": (3,), "emb": (50, 4), "odd": (7, 5), "s": (), "w": (12, 3), "wide": (2, 9)}
BUILDERS = {
    "PartitionedPS": dict(max_shards=8),
    "UnevenPartitionedPS": dict(max_shards=8),
    "PartitionedAR": dict(max_shards=8),
    "RandomAxisPartitionAR": dict(max_shards=8, seed=3),
    "Parallax": {},
}


def _jax_spec(info):
    return JResourceSpec(resource_info={"nodes": [
        {("chips" if k == "gpus" else k): v for k, v in n.items()} for n in info["nodes"]]})


def _gpu(name):
    return name.replace(":TPU:", ":GPU:")


def _items():
    arrays = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    return (JModelItem(lambda p, b: 0.0, {n: jnp.asarray(a) for n, a in arrays.items()},
                       sparse_vars=["emb"]),
            ModelItem(lambda p, b: 0.0, {n: torch.from_numpy(a) for n, a in arrays.items()},
                      sparse_vars=["emb"]))


def _sync(node):
    which = node.WhichOneof("synchronizer")
    if which == "PSSynchronizer":
        ps = node.PSSynchronizer
        return which, _gpu(ps.reduction_destination), ps.sync, ps.staleness
    if which == "AllReduceSynchronizer":
        return which, node.AllReduceSynchronizer.group
    return None


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_partitioned_builders_match_jax(builder, spec):
    jitem, titem = _items()
    js = getattr(jstrategy, builder)(**BUILDERS[builder]).build(jitem, _jax_spec(SPECS[spec]))
    ts = getattr(tstrategy, builder)(**BUILDERS[builder]).build(
        titem, ResourceSpec(resource_info=SPECS[spec]))
    assert [n.var_name for n in ts.node_config] == [n.var_name for n in js.node_config]
    for jn, tn in zip(js.node_config, ts.node_config):
        assert (list(tn.partition), tn.sparse) == (list(jn.partition), jn.sparse), jn.var_name
        assert _sync(tn) == _sync(jn), jn.var_name
        assert [(p.var_name, _sync(p)) for p in tn.part_config] == [
            (p.var_name, _sync(p)) for p in jn.part_config], jn.var_name
    assert ts.graph_config.replicas == [_gpu(r) for r in js.graph_config.replicas]
    if builder == "Parallax":   # the sparse table to the PS, the rest to AllReduce
        assert not any(n.part_config for n in ts.node_config)
        assert {n.var_name for n in ts.node_config
                if n.WhichOneof("synchronizer") == "PSSynchronizer"} == {"emb"}
    else:
        assert ts.node_for("w").part_config and not ts.node_for("s").part_config


@pytest.mark.parametrize("r", [1, 3, 4])
@pytest.mark.parametrize("builder", ["PartitionedPS", "UnevenPartitionedPS",
                                     "RandomAxisPartitionAR", "Parallax"])
def test_partitioned_plans_match_jax(builder, r):
    jitem, titem = _items()
    info = {"nodes": [{"address": "localhost", "gpus": list(range(r)), "chief": True}]}
    jplans = jpart.build_var_plans(getattr(jstrategy, builder)(**BUILDERS[builder]).build(
        jitem, _jax_spec(info)), jitem, r)
    tplans = tpart.build_var_plans(getattr(tstrategy, builder)(**BUILDERS[builder]).build(
        titem, ResourceSpec(resource_info=info)), titem, r)
    for name in SHAPES:
        jp, tp = jplans[name], tplans[name]
        assert (tp.placement.value, tp.sync.value, tp.sparse, tp.ps_axes) == (
            jp.placement.value, jp.sync.value, jp.sparse, jp.ps_axes), name
        if jp.placement == jpart.Placement.SHARDED:
            assert (tp.partition_axis, tp.padded_dim, tp.logical_shards) == (
                jp.partition_axis, jp.padded_dim, jp.logical_shards), name
        assert tpart.storage_spec(tp) == tuple(jpart.storage_spec(jp)), name
        assert tpart.storage_shape(tp, r) == jpart.storage_shape(jp, r), name
        assert tpart.update_space_shape(tp, r) == jpart.update_space_shape(jp, r), name


def test_partitioned_async_ps_keeps_the_shards_and_unsplit_raises():
    """JAX places a partitioned variable SHARDED whatever its PS's sync; an
    unsplit non-scalar one under ``sync=False`` is DIVERGENT, as JAX's (the
    async runtime then serves it), and the scalar stays AllReduce."""
    arrays = {n: np.zeros(s, np.float32) for n, s in dict(SHAPES, prime=(11, 2)).items()}
    jitem = JModelItem(lambda p, b: 0.0, {n: jnp.asarray(a) for n, a in arrays.items()})
    titem = ModelItem(lambda p, b: 0.0, {n: torch.from_numpy(a) for n, a in arrays.items()})
    s = tstrategy.PartitionedPS(max_shards=8, sync=False).build(
        titem, ResourceSpec(resource_info=SPECS["one_node"]))
    plans = tpart.build_var_plans(s, titem, 4)
    jplans = jpart.build_var_plans(jstrategy.PartitionedPS(max_shards=8, sync=False).build(
        jitem, _jax_spec(SPECS["one_node"])), jitem, 4)
    assert {n: p.placement.value for n, p in plans.items()} == {
        n: p.placement.value for n, p in jplans.items()}
    split = {n.var_name for n in s.node_config if n.part_config}
    assert {n for n, p in plans.items() if p.placement == tpart.Placement.SHARDED} == split
    # 11 has no divisor up to 8: "prime" stays whole
    assert {n for n, p in plans.items() if p.placement == tpart.Placement.DIVERGENT} == {
        "prime"} == set(arrays) - split - {"s"}
    assert plans["s"].placement == tpart.Placement.REPLICATED


# -- the 4-rank gloo world ----------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["partitioned"] for res in results]


def _linear_oracle(opt, batch, params, steps=3):
    """Single-device optax on the global batch: (parameters, state)."""
    def loss(p, b):
        return jnp.mean((b @ p["w"] + p["b"]) ** 2)

    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p)
    for _ in range(steps):
        g = jax.grad(loss)(p, jnp.asarray(batch))
        u, st = opt.update(g, st, p)
        p = optax.apply_updates(p, u)
    return p, st


def _same_on_every_rank(results, key):
    first = results[0][key]
    for res in results[1:]:
        assert res[key]["strategy_id"] == first["strategy_id"], key
        for n, p in res[key]["params"].items():
            assert np.array_equal(p, first["params"][n]), (key, n)
    for res in results:
        assert res[key]["replication"] == [], key


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("builder", ranks.PART_BUILDERS)
def test_value_exact_sync_partitioned_over_four_ranks(gloo, builder, opt):
    inputs, results = gloo
    key = ("linear", builder, opt)
    exp, st = _linear_oracle(optax.sgd(0.1) if opt == "sgd" else optax.adam(0.05),
                             inputs["linear_batch"], inputs["linear_params"])
    _same_on_every_rank(results, key)
    for res in results:
        got = res[key]
        assert got["step"] == 3 and np.isfinite(got["loss"]) and got["roundtrip"]
        for n in ("w", "b"):
            np.testing.assert_allclose(got["params"][n], exp[n], atol=2e-5, err_msg=n)
            if opt == "adam":   # the moments, gathered into the variables' shapes
                np.testing.assert_allclose(got["moments"][n]["exp_avg"], st[0].mu[n],
                                           atol=2e-5, err_msg=n)
                np.testing.assert_allclose(got["moments"][n]["exp_avg_sq"], st[0].nu[n],
                                           atol=2e-5, err_msg=n)
        for n, (placement, axis, padded, _) in got["plans"].items():
            assert placement == "sharded", (key, n)
            block = list(inputs["linear_params"][n].shape)
            block[axis] = padded // ranks.WORLD
            assert got["stored"][n] == tuple(block), (key, n)


def _mlp_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)


def _subset_grads(inputs):
    p = {k: jnp.asarray(v) for k, v in inputs["subset_params"].items()}
    g = jax.grad(lambda q: _mlp_loss(q, {k: jnp.asarray(v)
                                         for k, v in inputs["subset_batch"].items()}))(p)
    return p, g


@pytest.mark.parametrize("builder", ["PS", "PartitionedPS"])
def test_subset_ps_value_exact_over_four_ranks(gloo, builder):
    inputs, results = gloo
    p, g = _subset_grads(inputs)
    want = jax.tree.map(lambda a, b: a - ranks.SUBSET_LR * b, p, g)
    _same_on_every_rank(results, ("subset", builder))
    got = results[0]["subset", builder]
    for k in want:
        np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), atol=1e-5, err_msg=k)
    placements = {pl for pl, _, _, _ in got["plans"].values()}
    assert placements == ({"replicated"} if builder == "PS" else {"sharded"})


def _groups(rank):
    """(ICI group, DCN group, world) of ``rank`` on {replica_dcn: 2,
    replica_ici: 2}: rank r sits at (dcn, ici) = divmod(r, 2)."""
    dcn, ici = divmod(rank, 2)
    return (2 * dcn, 2 * dcn + 1), (ici, ici + 2), tuple(range(ranks.WORLD))


def test_subset_ps_collectives_name_only_ici(gloo):
    """The subset PS scatters and gathers on its rank's ICI group; the DCN
    group sees only the sum of the scattered shards.  The whole-axis PS,
    the control, scatters and gathers on the world."""
    _, results = gloo
    for rank, res in enumerate(results):
        ici, dcn, everyone = _groups(rank)
        for key in ("PS", "clip"):
            assert res["subset", key]["collectives"] == [
                ("gather", ici), ("psum", dcn), ("scatter", ici)], (rank, key)
        assert res["subset", "full"]["collectives"] == [
            ("gather", everyone), ("scatter", everyone)], rank


def test_parallax_subset_routes_sparse_var(gloo):
    inputs, results = gloo
    got = results[0]["subset", "Parallax"]
    assert got["plans"]["emb"][3] == ranks.SUBSET_AXES
    assert got["plans"]["w"][3] is None   # dense -> AllReduce
    from autodist_tpu.ops.sparse import embedding_lookup

    def loss(p, b):
        return jnp.mean((embedding_lookup(p["emb"], b["ids"]) @ p["w"])[..., 0] ** 2)

    p0 = {k: jnp.asarray(v) for k, v in inputs["parallax_params"].items()}
    g = jax.grad(lambda q: loss(q, {"ids": jnp.asarray(inputs["parallax_ids"])}))(p0)
    want = jax.tree.map(lambda a, b: a - ranks.SUBSET_LR * b, p0, g)
    _same_on_every_rank(results, ("subset", "Parallax"))
    for k in want:
        np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_unknown_ps_axes_raise(gloo):
    _, results = gloo
    for res in results:
        assert "not data axes" in res["subset_unknown_axes"]


def test_grad_norm_clip_exact_under_subset(gloo):
    """Each subset shard counts once despite its copy on the other DCN
    index."""
    inputs, results = gloo
    p, g = _subset_grads(inputs)
    true_norm = float(optax.global_norm(g))
    scale = min(1.0, ranks.SUBSET_CLIP / true_norm)
    want = jax.tree.map(lambda a, b: a - ranks.SUBSET_LR * scale * b, p, g)
    _same_on_every_rank(results, ("subset", "clip"))
    for res in results:
        got = res["subset", "clip"]
        np.testing.assert_allclose(got["grad_norm"], true_norm, rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), atol=1e-6,
                                       err_msg=k)


def test_world_fails_once_and_fast(monkeypatch):
    """A rank that exits non-zero fails the first caller with its output;
    the failure is kept, and a second caller fails in under a second
    without starting a process.  The real world's cache is left as it
    was."""
    real = ranks._WORLD
    monkeypatch.setattr(ranks, "_WORLD", {})
    monkeypatch.setattr(ranks, "make_inputs", lambda params: {})
    monkeypatch.setattr(ranks, "rank_command", lambda workdir: [
        sys.executable, "-c",
        "import os, sys; print('rank', os.environ['RANK'], 'gives up'); "
        "sys.exit(3 if os.environ['RANK'] == '2' else 0)"])
    with pytest.raises(RuntimeError, match=r"rank 2 exited 3:\n.*rank 2 gives up"):
        ranks.world(lambda: None)
    started = []
    monkeypatch.setattr(ranks.subprocess, "Popen",
                        lambda *a, **k: started.append(a) or pytest.fail("a rank started"))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 exited 3"):
        ranks.world(lambda: None)
    assert time.monotonic() - t0 < 1.0 and not started
    monkeypatch.undo()
    assert ranks._WORLD is real and ranks.WORLD_DEADLINE_S <= 90
    assert os.path.basename(ranks.rank_command("d")[1]) == "torch_gloo_ranks.py"
