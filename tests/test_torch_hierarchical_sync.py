"""The two-level sync, the overlap schedule and the schedule-IR executor,
the port against the JAX package.

In the shared 4-rank gloo world (``tests/torch_gloo_ranks.py``), laid out
as ``{replica_dcn: 2, replica_ici: 2}``, held against the JAX package on 4
of the 8 virtual CPU devices reshaped (2, 2):

- each rank's ``AxisGroup`` of every axis tuple is JAX's ``axis_index``
  and size, ``(replica_ici, replica_dcn)`` with its permuted rank order;
- ``sync_hierarchical`` and ``sync_overlapped(hier=...)`` over
  ``tests/test_hierarchical_sync.py``'s buckets and codec cases, two steps
  so that codec state carries: against JAX's ``sync_hierarchical`` and the
  port's flat barrier at that test's tolerances (None 1e-6, bf16 2e-2,
  int8 5e-2).  The overlap at a 64-byte chunk, so that every elementwise
  bucket splits, is bitwise equal to the barrier on the two-level layout
  (every sum there has two terms).  On the flat 4-rank layout the block
  codec is bitwise equal too; the elementwise codecs agree to 1e-6 / one
  bf16 step only, because gloo's ring all-reduce adds a 4-term sum in an
  order that depends on the element's place in the buffer, which the
  chunking moves;
- ``sync_bucketed`` of the schedule-IR programs of
  ``tests/test_schedule_ir.py::test_searched_programs_match_flat`` (bf16
  hops, the ``ppermute_ring`` core, the scatter tree, an int8 core)
  against JAX's, at that test's tolerances;
- the engine on ``tests/test_hierarchical_sync.py::_train``'s tanh MLP (2
  sgd steps): two-level x {barrier, overlap} x the elementwise codecs,
  ``accum_steps=2`` under both schedules, bf16 EF on the DCN hop under
  overlap with accumulation, an int8 DCN codec, two-level with the sharded
  update under both schedules, each IR program, and
  ``distribute(sync_schedule="overlap")``, against the JAX engine's flat
  runs of the same codec (atol 1e-5 for None, 2e-2 for bf16, 5e-3 for the
  stateful DCN codec in the accumulation, 5e-2 for int8, the IR programs
  at their tolerances), with ``check_replication() == []`` and the same
  parameters on every rank; overlap bitwise equal to barrier;
- the overlap's issue record on the flat mesh with ``chunk_size=1`` (three
  buckets): reverse bucket order, the same on every rank, every bucket
  issued before the backward pass returned, and the result bitwise equal
  to the barrier's;
- ``tests/test_wire_dtype.py``'s two cases: bf16 gradients reach
  ``all_reduce`` as bf16, f32 gradients as f32.

At R = 1 in this process: the overlap's hooks on GPT-tiny (its ``wte``
tied between the embedding and the head), under remat, and under the bf16
master (the hook casts the bf16 compute copy's gradient to f32), with the
chunk forced down to 4 KiB so that buckets split: every bucket issued
during the backward pass in reverse order, and two adamw steps bitwise
equal to the barrier's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.kernel.synchronization import all_reduce as jar
from autodist_tpu.parallel.collectives import axis_index as jaxis_index
from autodist_tpu.proto import synchronizers_pb2
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.train_lib import gpt_capture
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

_J = synchronizers_pb2.AllReduceSynchronizer
DCN, ICI = "replica_dcn", "replica_ici"
JSPEC_FLAT4 = JResourceSpec(resource_info={"nodes": [{"address": "localhost",
                                                       "chips": [0, 1, 2, 3]}]})
CASE_TOL = {("NoneCompressor", 0): 1e-6, ("BF16Compressor", 0): 2e-2,
            ("BF16CompressorEF", 0): 2e-2, ("Int8Compressor", 0): 5e-2,
            ("NoneCompressor", 3): 5e-2, ("NoneCompressor", 1): 2e-2}
CODEC_TOL = {"NoneCompressor": 1e-5, "BF16Compressor": 2e-2, "BF16CompressorEF": 2e-2}
IR_TOL = dict(zip(ranks.IR_PROGRAMS, (5e-2, 1e-5, 1e-5, 6e-2)))
EF_SCAN_TOL, INT8_DCN_TOL = 5e-3, 5e-2


def test_cases_are_the_jax_tests():
    import test_hierarchical_sync as ths
    import test_schedule_ir as tsi

    assert ranks.HIER_SHAPES == ths._SHAPES
    assert [(c, d, CASE_TOL[c, d]) for c, d in ranks.HIER_CASES] == ths._CASES
    int8_ir = tsi.SEARCHED_IR.replace(f"all_reduce@{DCN}", f"all_reduce@{DCN}:Int8Compressor")
    assert ranks.IR_PROGRAMS == (tsi.SEARCHED_IR, tsi.RING_IR, tsi.SCATTER_TREE_IR, int8_ir)


# -- the 4-rank gloo world, and the JAX references ------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["hier"] for res in results]


def _jbuckets(comp, hierarchy, dcn=0, schedule_ir=""):
    plans = {name: jpart.VarPlan(name=name, shape=ranks.HIER_SHAPES[name], dtype=np.float32,
                                 placement=jpart.Placement.REPLICATED,
                                 sync=jpart.SyncKind.ALL_REDUCE, group=i // 2, compressor=comp,
                                 hierarchy=hierarchy, dcn_compressor=dcn,
                                 schedule_ir=schedule_ir)
             for i, name in enumerate(sorted(ranks.HIER_SHAPES))}
    return jar.plan_buckets(plans, ranks.HIER_SHAPES,
                            dict.fromkeys(ranks.HIER_SHAPES, np.dtype(np.float32)))


def _jax_sync():
    """JAX's two-level syncs of the codec cases and its syncs of the IR
    programs on the same two steps of gradients, in one shard_map, with
    every device's ``axis_index`` of each axis tuple."""
    inputs = oracle.world_inputs()
    g1, g2 = inputs["hier_grads"]
    hier = jar.HierAxes(ici=ICI, dcn=(DCN,))
    runs = [(_jbuckets(getattr(_J, c), _J.TWO_LEVEL, d), jar.sync_hierarchical, {"hier": hier})
            for c, d in ranks.HIER_CASES]
    runs += [(_jbuckets(0, _J.FLAT, schedule_ir=ir), jar.sync_bucketed, {})
             for ir in ranks.IR_PROGRAMS]
    tuples = ((DCN,), (ICI,), (DCN, ICI), (ICI, DCN))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), (DCN, ICI))

    def body(a, b):
        ga = {n: a[n][0].reshape(s) for n, s in ranks.HIER_SHAPES.items()}
        gb = {n: b[n][0].reshape(s) for n, s in ranks.HIER_SHAPES.items()}
        outs = []
        for buckets, fn, kw in runs:
            states = jar.init_compressor_states(buckets)
            s1, states = fn(ga, buckets, states, (DCN, ICI), **kw)
            s2, _ = fn(gb, buckets, states, (DCN, ICI), **kw)
            outs.append((s1, s2))
        index = jnp.stack([jaxis_index(t if len(t) > 1 else t[0]) for t in tuples])
        return outs, index[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P((DCN, ICI)), P((DCN, ICI))),
                               out_specs=(P(), P((DCN, ICI))), check_vma=False))
    outs, index = fn(g1, g2)
    outs = [[{n: np.asarray(v) for n, v in step.items()} for step in pair] for pair in outs]
    keys = [("sync",) + case for case in ranks.HIER_CASES] + [
        ("ir_sync", ir) for ir in ranks.IR_PROGRAMS]
    return dict(zip(keys, outs)), dict(zip(tuples, np.asarray(index).T.tolist()))


def _mlp_loss(p, b):
    h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] - b["y"]) ** 2)


def _jax_engine():
    """The JAX engine's flat runs on 4 devices (2 sgd steps) that the port's
    two-level, overlap and IR runs are held against."""
    inputs = oracle.world_inputs()
    out = {}
    for name, kw in (("NoneCompressor", {}), ("BF16Compressor", {}), ("BF16CompressorEF", {}),
                     ("accum", {"accum": 2}),
                     ("ef_scan", {"compressor": "BF16CompressorEF", "schedule": "overlap",
                                  "accum": 2})):
        compressor = kw.get("compressor", name if name in CODEC_TOL else "NoneCompressor")
        sess = JAutoDist(resource_spec=JSPEC_FLAT4, strategy_builder=JAllReduce(
            compressor=compressor, schedule=kw.get("schedule", "barrier"))).distribute(
            _mlp_loss, {k: jnp.asarray(v) for k, v in inputs["mlp_params"].items()},
            optax.sgd(0.1), accum_steps=kw.get("accum", 1))
        for _ in range(2):
            m = sess.run(inputs["mlp_batch"])
        out[name] = ({k: np.asarray(v) for k, v in sess.params().items()}, float(m["loss"]))
    return out


worker.submit((_jax_sync,), (_jax_engine,))


@pytest.fixture(scope="module")
def jax_sync():
    return worker.result(_jax_sync)


@pytest.fixture(scope="module")
def jax_engine():
    return worker.result(_jax_engine)


def _close(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=f"{what} {k}")


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert np.array_equal(got[k], want[k]), f"{what} {k}"


def _same_on_every_rank(results, key):
    first = results[0][key]
    for res in results:
        assert res[key]["strategy_id"] == first["strategy_id"]
        _equal(res[key]["params"], first["params"], f"{key}: rank vs rank 0")
        assert res[key]["replication"] == [], key


# -- sync level ----------------------------------------------------------------

def test_axis_groups_index_the_tuple_as_jax(gloo, jax_sync):
    _, results = gloo
    _, index = jax_sync
    for rank, res in enumerate(results):
        for axes, (idx, size, order) in res["axis_groups"].items():
            assert (idx, size) == (index[axes][rank], 2 if len(axes) == 1 else 4), (rank, axes)
            # the process group's ranks in ascending order, by their tuple index
            members = [r for r in range(4) if len(axes) == 2
                       or (r // 2 == rank // 2 if axes == (ICI,) else r % 2 == rank % 2)]
            assert list(order) == [index[axes][r] for r in members], (rank, axes)
    assert results[0]["axis_groups"][ICI, DCN][2] == (0, 2, 1, 3)


@pytest.mark.parametrize("case", ranks.HIER_CASES)
def test_sync_hierarchical_matches_jax(gloo, jax_sync, case):
    _, results = gloo
    refs, _ = jax_sync
    tol = CASE_TOL[case]
    for res in results:
        got = res[("sync",) + case]
        for step in (0, 1):
            _close(got["two"][step], refs[("sync",) + case][step], tol, f"{case} step {step}")
            _close(got["two"][step], got["flat"][step], tol, f"{case} two-level vs flat")


@pytest.mark.parametrize("case", ranks.HIER_CASES)
def test_sync_overlapped_matches_barrier(gloo, case):
    _, results = gloo
    tol = CASE_TOL[case]
    for res in results:
        got = res[("sync",) + case]
        for step in (0, 1):
            _equal(got["two_overlap"][step], got["two"][step], f"{case} two-level overlap")
            if case[0] == "Int8Compressor":   # the block codec reduces whole buckets
                _equal(got["flat_overlap"][step], got["flat"][step], f"{case} flat overlap")
            else:   # gloo's 4-term ring sums in a place-dependent order
                _close(got["flat_overlap"][step], got["flat"][step],
                       1e-6 if case[0] == "NoneCompressor" and not case[1] else tol,
                       f"{case} flat overlap")


@pytest.mark.parametrize("ir", ranks.IR_PROGRAMS)
def test_run_schedule_programs_match_jax(gloo, jax_sync, ir):
    _, results = gloo
    refs, _ = jax_sync
    for res in results:
        for step in (0, 1):
            _close(res["ir_sync", ir][step], refs["ir_sync", ir][step], IR_TOL[ir], ir)
            _equal(res["ir_sync", ir][step], results[0]["ir_sync", ir][step], ir)


# -- engine level ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["barrier", "overlap"])
@pytest.mark.parametrize("codec", ranks.HIER_CODECS)
def test_engine_two_level_matches_jax(gloo, jax_engine, codec, schedule):
    _, results = gloo
    j_params, j_loss = jax_engine[codec]
    key = ("engine", codec, schedule)
    _same_on_every_rank(results, key)
    for res in results:
        run = res[key]
        assert (run["hierarchy"], run["schedule"]) == ("two_level", schedule)
        _close(run["params"], j_params, CODEC_TOL[codec], f"{key} vs the JAX engine")
        assert abs(run["loss"] - j_loss) < max(CODEC_TOL[codec], 1e-4)
        _equal(run["params"], res["engine", codec, "barrier"]["params"], f"{key} vs barrier")


@pytest.mark.parametrize("schedule", ["barrier", "overlap"])
def test_engine_two_level_under_accum(gloo, jax_engine, schedule):
    _, results = gloo
    key = ("engine_accum", schedule)
    _same_on_every_rank(results, key)
    for res in results:
        assert res[key]["hierarchy"] == "two_level"
        _close(res[key]["params"], jax_engine["accum"][0], 1e-5, f"{key} vs the JAX engine")


def test_engine_stateful_dcn_codec_overlap_accum(gloo, jax_engine):
    _, results = gloo
    _same_on_every_rank(results, "engine_ef_scan")
    for res in results:
        run = res["engine_ef_scan"]
        assert (run["hierarchy"], run["schedule"]) == ("two_level", "overlap")
        _close(run["params"], jax_engine["ef_scan"][0], EF_SCAN_TOL, "EF DCN codec in accum")


def test_engine_int8_dcn_codec(gloo, jax_engine):
    _, results = gloo
    _same_on_every_rank(results, "engine_int8_dcn")
    for res in results:
        run = res["engine_int8_dcn"]
        assert run["hierarchy"] == "two_level" and run["keys"] == ["g0_float32_c0_h2_d3"]
        _close(run["params"], jax_engine["NoneCompressor"][0], INT8_DCN_TOL, "int8 DCN codec")


@pytest.mark.parametrize("schedule", ["barrier", "overlap"])
def test_engine_two_level_sharded_update(gloo, jax_engine, schedule):
    _, results = gloo
    key = ("engine_sharded", schedule)
    _same_on_every_rank(results, key)
    for res in results:
        run = res[key]
        assert run["sharded"] and run["hierarchy"] == "two_level"
        assert run["keys"] == ["g0_float32_c0_h2_d0_z1"]
        _close(run["params"], jax_engine["NoneCompressor"][0], 1e-5, f"{key} vs the JAX engine")
        _equal(run["params"], res["engine_sharded", "barrier"]["params"], f"{key} vs barrier")


@pytest.mark.parametrize("ir", ranks.IR_PROGRAMS)
def test_engine_ir_programs_match_flat(gloo, jax_engine, ir):
    _, results = gloo
    j_params, j_loss = jax_engine["NoneCompressor"]
    _same_on_every_rank(results, ("engine_ir", ir))
    for res in results:
        run = res["engine_ir", ir]
        assert run["hierarchy"] == "searched"
        _close(run["params"], j_params, IR_TOL[ir], ir)
        assert abs(run["loss"] - j_loss) < max(IR_TOL[ir], 1e-4)


def test_distribute_sync_schedule_overrides_the_strategy(gloo):
    _, results = gloo
    for res in results:
        run = res["engine_sync_schedule"]
        assert run["schedule"] == "overlap" and run["issued"] is not None
        _equal(run["params"], res["engine", "NoneCompressor", "barrier"]["params"],
               "sync_schedule='overlap' vs barrier")


def test_overlap_issues_in_reverse_bucket_order_on_every_rank(gloo):
    _, results = gloo
    issued = results[0]["engine_flat", "overlap"]["issued"]
    for res in results:
        run, barrier = res["engine_flat", "overlap"], res["engine_flat", "barrier"]
        assert run["issued"] == issued
        keys = run["keys"]
        assert len(keys) == 3 and [k for k, _ in run["issued"][0]] == keys[::-1]
        assert run["issued"][1] == len(keys)   # all issued from hooks, inside the backward
        assert barrier["issued"] is None and run["schedule"] == "overlap"
        _equal(run["params"], barrier["params"], "flat overlap vs barrier")
        assert run["replication"] == []


@pytest.mark.parametrize("dtype", ["torch.bfloat16", "torch.float32"])
def test_wire_dtype_follows_the_gradients(gloo, dtype):
    _, results = gloo
    for res in results:
        assert res["wire_dtypes", dtype] == [dtype]


# -- R = 1: the hooks ------------------------------------------------------------

SEQ, B = 16, 4
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}


@pytest.mark.parametrize("case", ["tied", "remat", "bf16_master"])
def test_overlap_hooks_take_each_total_gradient_once(case):
    config = dataclasses.replace(tgpt.GPT_TINY, remat=case == "remat")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, config.vocab_size, (B, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    runs = {}
    for schedule in ("barrier", "overlap"):
        loss_fn, params, sparse = gpt_capture(config, SEQ, device="cpu")
        builder = AllReduce(chunk_size=4, schedule=schedule,
                            precision="bf16_master" if case == "bf16_master" else "f32")
        sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                        strategy_builder=builder, device="cpu").distribute(
            loss_fn, params, optim.adamw(1e-3), sparse_vars=sparse, has_rng=True)
        t = sess.transformer
        t.max_chunk_bytes = 4096
        losses = [sess.run(batch)["loss"].item() for _ in range(2)]
        runs[schedule] = (losses, {n: p.detach().numpy() for n, p in sess.params().items()}, t)
    losses, params, t = runs["overlap"]
    assert "wte" in t.names and t.sync_schedule == "overlap"   # wte: embedding and head
    issued = t.last_overlap.issued
    assert [k for k, _ in issued] == [b.key for b in reversed(t.buckets)]
    assert t.last_overlap.issued_in_backward == len(t.buckets)
    if case != "bf16_master":   # (sharded buckets scatter whole)
        assert max(c for _, c in issued) > 1   # the 4 KiB chunk splits buckets
    assert losses == runs["barrier"][0]
    _equal(params, runs["barrier"][1], f"{case}: overlap vs barrier")
    if case == "bf16_master":
        assert t.sync_mixed_precision and all(p.dtype == np.float32 for p in params.values())
