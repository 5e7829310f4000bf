"""The schedule IR, the AllReduce knobs of the overlap, two-level and
schedule-IR syncs, and their plans, the port against the JAX package.
None of it compiles JAX.

- ``schedule_ir``: ``loads``/``dumps`` round trips, whitespace and integer
  codecs; the error tables of ``tests/test_schedule_ir.py:103-160`` (the
  same exception class and message); ``canonical_hierarchy``,
  ``core_codec``, ``phase_group_size``, ``block_codec_violations``;
  ``resolve_schedule_ir`` on the JAX test's inputs.
- ``resolve_schedule``, ``resolve_hierarchy`` and ``resolve_compressor``
  take the JAX names, aliases and enum values.
- ``AllReduce(...)`` builds the JAX builder's node fields (``schedule``,
  ``hierarchy``, ``dcn_compressor``, ``schedule_ir`` among them), which
  survive the strategy's JSON, and ``hierarchy="two_level"`` factors a
  2-node spec's mesh into ``{replica_dcn: 2, replica_ici: 4}`` as JAX does.
- ``plan_buckets`` gives JAX's keys and shard plans on GPT-tiny, and
  ``wire_codec``, ``elementwise``, ``bucket_sharded`` and the codec states'
  shapes agree.
- ``{replica_dcn, replica_ici}`` meshes are taken, and ``seq`` beside them
  raises naming Queue A item 9.
- The transformer resolves the hierarchy as JAX's (AUTO by the mesh,
  PowerSGD falling back to FLAT, canonical IR programs pinned back to the
  knobs, the sharded update's eligibility) and raises where JAX raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.kernel.graph_transformer import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel.synchronization import all_reduce as jar
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.proto import synchronizers_pb2
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import base as jbase
from autodist_tpu_torch import optim
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.kernel.synchronization import all_reduce as tar
from autodist_tpu_torch.kernel.synchronization import schedule_ir as tsir
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.parallel.mesh import ReplicaWorld, check_mesh_axes, hierarchical_axes
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.strategy import base as tbase
from autodist_tpu_torch.strategy.base import Strategy

_J = synchronizers_pb2.AllReduceSynchronizer
_T = schema.AllReduceSynchronizer
DCN, ICI = "replica_dcn", "replica_ici"
FLAT_IR = f"all_reduce@{DCN}+{ICI}"
TWO_LEVEL_IR = f"reduce_scatter@{ICI};all_reduce@{DCN};all_gather@{ICI}"
SEARCHED_IR = (f"reduce_scatter@{ICI}:BF16Compressor;all_reduce@{DCN};"
               f"all_gather@{ICI}:BF16Compressor")
RING_IR = f"reduce_scatter@{ICI};ppermute_ring@{DCN};all_gather@{ICI}"
SCATTER_TREE_IR = (f"reduce_scatter@{ICI};reduce_scatter@{DCN};all_gather@{DCN};"
                   f"all_gather@{ICI}")
TEXTS = (FLAT_IR, TWO_LEVEL_IR, SEARCHED_IR, RING_IR, SCATTER_TREE_IR,
         TWO_LEVEL_IR.replace(f"all_reduce@{DCN}", f"all_reduce@{DCN}:Int8Compressor"),
         " reduce_scatter@replica_ici : BF16Compressor ;\n"
         f"all_reduce@replica_dcn:{int(_J.Int8Compressor)};"
         "all_gather@replica_ici:BF16Compressor",
         "all_reduce@replica:equarx_int8")
NODES4 = [{"address": "localhost", "gpus": [0, 1, 2, 3], "chief": True}]
JSPEC_FLAT4 = JResourceSpec(resource_info={"nodes": [{"address": "localhost",
                                                       "chips": [0, 1, 2, 3]}]})
JSPEC_2x2 = JResourceSpec(resource_info={
    "nodes": [{"address": "localhost", "chips": [0, 1, 2, 3]}], "mesh": {DCN: 2, ICI: 2}})
JSPEC_2NODE = JResourceSpec(resource_info={"nodes": [
    {"address": "10.0.0.1", "chips": [0, 1, 2, 3], "chief": True},
    {"address": "10.0.0.2", "chips": [0, 1, 2, 3]}]})
TSPEC = {"flat4": ResourceSpec(resource_info={"nodes": NODES4}),
         "2x2": ResourceSpec(resource_info={"nodes": NODES4, "mesh": {DCN: 2, ICI: 2}}),
         "2node": ResourceSpec(resource_info={"nodes": [
             {"address": "10.0.0.1", "gpus": [0, 1, 2, 3], "chief": True},
             {"address": "10.0.0.2", "gpus": [0, 1, 2, 3]}]})}
JSPEC = {"flat4": JSPEC_FLAT4, "2x2": JSPEC_2x2, "2node": JSPEC_2NODE}
AR_FIELDS = ("spec", "compressor", "group", "schedule", "hierarchy", "dcn_compressor",
             "sharded_update", "schedule_ir", "precision")


def _phases(prog):
    return [(ph.op, ph.axes, int(ph.codec)) for ph in prog.phases]


def _same_error(fn_j, fn_t, *args):
    """Both raise the same exception class with the same message."""
    with pytest.raises(Exception) as je:
        fn_j(*args)
    with pytest.raises(Exception) as te:
        fn_t(*args)
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


# -- the wire format ------------------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_loads_and_dumps_match_jax(text):
    j, t = jsir.loads(text), tsir.loads(text)
    assert _phases(t) == _phases(j)
    assert tsir.dumps(t) == jsir.dumps(j)
    assert tsir.dumps(tsir.loads(tsir.dumps(t))) == tsir.dumps(t)
    assert t.reduced_axes == j.reduced_axes
    assert [(p.op, p.axes) for p in t.split()[0]] == [(p.op, p.axes) for p in j.split()[0]]
    assert tsir.canonical_hierarchy(t) == jsir.canonical_hierarchy(j)
    assert int(tsir.core_codec(t)) == int(jsir.core_codec(j))
    assert [p.dcn for p in t.phases] == [p.dcn for p in j.phases]
    assert [(p.op, p.axes) for p in tsir.block_codec_violations(t)] == \
        [(p.op, p.axes) for p in jsir.block_codec_violations(j)]
    sizes = {DCN: 2, ICI: 4, "replica": 8}
    assert [tsir.phase_group_size(p, sizes) for p in t.phases] == \
        [jsir.phase_group_size(p, sizes) for p in j.phases]


@pytest.mark.parametrize("text", ["all_sum@replica", "all_reduce@replica:GzipCompressor",
                                  "all_reduce@replica:99", "all_reduce", "all_reduce@",
                                  "  ;  "])
def test_loads_errors_match_jax(text):
    _same_error(jsir.loads, tsir.loads, text)


@pytest.mark.parametrize("text", [
    "all_gather@a;reduce_scatter@a", "all_reduce@a;all_reduce@b",
    "reduce_scatter@a;all_reduce@b",
    "reduce_scatter@a;reduce_scatter@b;all_reduce@c;all_gather@a;all_gather@b",
    "reduce_scatter@a;reduce_scatter@a;all_gather@a;all_gather@a",
    "reduce_scatter@a;all_reduce@a;all_gather@a",
    "reduce_scatter@a:Int8Compressor;all_reduce@b;all_gather@a:Int8Compressor",
    "reduce_scatter@a:BF16CompressorEF;all_reduce@b;all_gather@a:BF16CompressorEF",
    "ppermute_ring@a:Int8Compressor", "reduce_scatter@a;ppermute_ring@b+c;all_gather@a"])
def test_structure_errors_match_jax(text):
    _same_error(lambda x: jsir.validate_structure(jsir.loads(x)),
                lambda x: tsir.validate_structure(tsir.loads(x)), text)


@pytest.mark.parametrize("text,mesh", [
    (f"reduce_scatter@{DCN};all_reduce@{ICI}:Int8Compressor;all_gather@{DCN}", False),
    ("all_reduce@replica_xyz", True), (f"all_reduce@{ICI}", True),
    (f"all_reduce@{DCN}+{DCN}", False)])
def test_mesh_and_block_errors_match_jax(text, mesh):
    kw = dict(data_axes=(DCN, ICI), axis_sizes={DCN: 2, ICI: 2}) if mesh else {}
    _same_error(lambda x: jsir.validate(jsir.loads(x), **kw),
                lambda x: tsir.validate(tsir.loads(x), **kw), text)
    tsir.validate(tsir.loads(TWO_LEVEL_IR), data_axes=(DCN, ICI), axis_sizes={DCN: 2, ICI: 2})


@pytest.mark.parametrize("value", [None, "", 0, TWO_LEVEL_IR, TEXTS[-2],
                                   f" all_reduce@replica : {int(_J.BF16Compressor)} ",
                                   f"all_reduce@replica:{int(_J.NoneCompressor)}",
                                   f"all_reduce@{DCN}+{DCN}", "all_reduce@replica:-1",
                                   "all_reduce@replica:999", "reduce_scatter@a;all_reduce@b",
                                   "bogus@x", 7])
def test_resolve_schedule_ir_matches_jax(value):
    try:
        want = jbase.resolve_schedule_ir(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tbase.resolve_schedule_ir(value)
        if not isinstance(value, int):
            assert str(got.value) == str(e)
        return
    assert tbase.resolve_schedule_ir(value) == want
    if value:
        assert tbase.resolve_schedule_ir(tsir.loads(value)) == want


@pytest.mark.parametrize("kind", ["schedule", "hierarchy", "compressor"])
def test_resolvers_take_the_jax_names_and_values(kind):
    jres, tres = getattr(jbase, f"resolve_{kind}"), getattr(tbase, f"resolve_{kind}")
    aliases = getattr(jbase, f"_{kind.upper()}_ALIASES")
    names = list(aliases) + ([] if kind == "compressor" else [n.upper() for n in aliases])
    for value in names + sorted(set(int(v) for v in aliases.values())):
        assert int(tres(value)) == int(jres(value)), value
    for bad in ("bogus", 99):
        with pytest.raises(ValueError, match="accepted names/values"):
            tres(bad)


# -- builders, strategies and plans ----------------------------------------------

def _mlp_items():
    shapes = {"w1": (32, 16), "b1": (16,), "w2": (16, 4)}
    return (JModelItem(lambda p, b: 0.0, {n: jnp.zeros(s) for n, s in shapes.items()}),
            ModelItem(lambda p, b: 0.0, {n: torch.zeros(s) for n, s in shapes.items()},
                      optim.sgd(0.1)))


BUILDS = [
    ("2x2", {"schedule": "overlap"}),
    ("2x2", {"hierarchy": "two_level", "dcn_compressor": "Int8Compressor"}),
    ("2x2", {"hierarchy": "two_level", "dcn_compressor": "equarx_int8",
             "sharded_update": "sharded"}),
    ("2x2", {"schedule_ir": SEARCHED_IR, "hierarchy": "two_level"}),
    ("2x2", {"compressor": "PowerSGDCompressor", "schedule": "overlap"}),
    ("2node", {"hierarchy": "two_level", "compressor": "BF16CompressorEF"}),
    ("2node", {"hierarchy": "auto"}),
    ("flat4", {"hierarchy": "two_level"}),
]


@pytest.mark.parametrize("spec,kwargs", BUILDS)
def test_builder_nodes_and_mesh_match_jax(spec, kwargs, tmp_path):
    jitem, titem = _mlp_items()
    js = JAllReduce(**kwargs).build(jitem, JSPEC[spec])
    ts = AllReduce(**kwargs).build(titem, TSPEC[spec])
    assert list(ts.graph_config.mesh.axis_names) == list(js.graph_config.mesh.axis_names)
    assert list(ts.graph_config.mesh.axis_sizes) == list(js.graph_config.mesh.axis_sizes)
    assert [n.var_name for n in ts.node_config] == [n.var_name for n in js.node_config]
    for jn, tn in zip(js.node_config, ts.node_config):
        j, t = jn.AllReduceSynchronizer, tn.AllReduceSynchronizer
        assert [getattr(t, f) if f == "schedule_ir" else int(getattr(t, f)) for f in AR_FIELDS] \
            == [getattr(j, f) if f == "schedule_ir" else int(getattr(j, f)) for f in AR_FIELDS]
    back = Strategy.deserialize(path=ts.serialize(str(tmp_path / ts.id)))
    assert back.proto == ts.proto
    plans = tpart.build_var_plans(back, titem, 4)
    jplans = jpart.build_var_plans(js, jitem, 4)
    for n, p in plans.items():
        assert (p.schedule_ir, int(p.dcn_compressor), int(p.schedule), int(p.hierarchy)) == (
            jplans[n].schedule_ir, int(jplans[n].dcn_compressor), int(jplans[n].schedule),
            int(jplans[n].hierarchy))


def test_hierarchical_axes_and_hosts_match_jax():
    from autodist_tpu.parallel.mesh import hierarchical_axes as jaxes

    for spec in ("flat4", "2x2", "2node"):
        for n in (4, 7, 8):
            assert hierarchical_axes(TSPEC[spec], n) == jaxes(JSPEC[spec], n), (spec, n)
    assert TSPEC["2node"].num_hosts == 2 and TSPEC["flat4"].num_hosts == 1
    cpu2 = ResourceSpec(resource_info={"nodes": [
        {"address": "10.0.0.1", "cpus": [0], "chief": True},
        {"address": "10.0.0.2", "cpus": [0]}]})
    assert cpu2.num_hosts == 2 and hierarchical_axes(cpu2, 2) == {DCN: 2, ICI: 1}
    check_mesh_axes([DCN, ICI])
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        check_mesh_axes([DCN, ICI, "seq"])


def _gpt_items():
    params = jax.eval_shape(lambda: jgpt.GPT(jgpt.GPT_TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"])
    model = tgpt.GPT(tgpt.GPT_TINY, device="meta")
    return (JModelItem(lambda p, b: 0.0, params),
            ModelItem(lambda p, b: 0.0, {convert.torch_to_jax_name(n): p
                                         for n, p in model.named_parameters()}))


@pytest.mark.parametrize("kwargs", [
    {"hierarchy": "two_level"},
    {"hierarchy": "two_level", "dcn_compressor": "Int8Compressor"},
    {"hierarchy": "two_level", "compressor": "BF16Compressor",
     "dcn_compressor": "BF16CompressorEF", "sharded_update": "sharded"},
    {"schedule_ir": RING_IR}, {"schedule_ir": SEARCHED_IR, "sharded_update": "sharded"},
    {"compressor": "PowerSGDCompressor", "schedule": "overlap"}])
def test_buckets_match_jax_on_gpt_tiny(kwargs):
    jitem, titem = _gpt_items()
    builder = dict(chunk_size=8, **kwargs)
    jplans = jpart.build_var_plans(JAllReduce(**builder).build(jitem, JSPEC_2x2), jitem, 4)
    tplans = tpart.build_var_plans(AllReduce(**builder).build(titem, TSPEC["2x2"]), titem, 4)
    jb = jar.plan_buckets(jplans, {v.name: v.shape for v in jitem.var_infos},
                          {v.name: v.dtype for v in jitem.var_infos}, num_replicas=4)
    tb = tar.plan_buckets(tplans, {v.name: v.shape for v in titem.var_infos},
                          {v.name: v.dtype for v in titem.var_infos}, num_replicas=4)
    assert len(tb) == len(jb) == 4
    jstates, tstates = jar.init_compressor_states(jb), tar.init_compressor_states(tb)
    for j, t in zip(jb, tb):
        assert (t.key, t.var_names, t.sizes, t.hierarchy, t.dcn_compressor, t.schedule_ir,
                t.num_shards, t.shard_sizes) == (
            j.key, j.var_names, j.sizes, j.hierarchy, j.dcn_compressor, j.schedule_ir,
            j.num_shards, j.shard_sizes)
        assert int(tar.wire_codec(t)) == int(jar.wire_codec(j))
        assert tar.elementwise(t) == jar.elementwise(j)
        assert tar.bucket_sharded(t) == jar.bucket_sharded(j)
        jshape = jax.tree.map(lambda a: tuple(a.shape), jstates[j.key])
        tshape = {k: tuple(v.shape) for k, v in tstates[t.key].items()} if isinstance(
            tstates[t.key], dict) else (tuple(tstates[t.key].shape) if tstates[t.key] != ()
                                        else ())
        assert tshape == jshape


# -- the transformer's resolution ------------------------------------------------

def _transformers(spec, kwargs):
    jitem, titem = _mlp_items()
    js = JAllReduce(**kwargs).build(jitem, JSPEC[spec])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(tuple(js.graph_config.mesh.axis_sizes)),
                tuple(js.graph_config.mesh.axis_names))
    jt = JGraphTransformer(js, jitem, mesh)
    ts = AllReduce(**kwargs).build(titem, TSPEC[spec])
    tt = GraphTransformer(ts, titem, "cpu", world=ReplicaWorld(rank=0, size=4))
    return jt, tt


RESOLUTIONS = [
    ("flat4", {}), ("2x2", {}), ("2x2", {"hierarchy": "flat"}),
    ("2x2", {"hierarchy": "two_level", "dcn_compressor": "Int8Compressor"}),
    ("2x2", {"hierarchy": "two_level", "compressor": "PowerSGDCompressor"}),
    ("2x2", {"schedule_ir": FLAT_IR + ":BF16Compressor", "compressor": "BF16Compressor"}),
    ("2x2", {"schedule_ir": TWO_LEVEL_IR.replace(f"all_reduce@{DCN}",
                                                 f"all_reduce@{DCN}:Int8Compressor")}),
    ("2x2", {"schedule_ir": RING_IR, "schedule": "overlap"}),
    ("2x2", {"schedule_ir": TWO_LEVEL_IR, "sharded_update": "sharded"}),
    ("2x2", {"hierarchy": "two_level", "sharded_update": "sharded",
             "dcn_compressor": "Int8Compressor"}),
    ("2x2", {"hierarchy": "two_level", "precision": "bf16_master"}),
]


@pytest.mark.parametrize("spec,kwargs", RESOLUTIONS)
def test_transformer_resolves_the_hierarchy_as_jax(spec, kwargs):
    jt, tt = _transformers(spec, kwargs)
    assert tt.sync_hierarchy == jt.sync_hierarchy
    assert tt.sync_schedule == jt.sync_schedule
    assert (tt.hier_spec is None) == (jt.hier_spec is None)
    assert [(b.key, b.hierarchy, b.dcn_compressor, b.compressor, b.schedule_ir,
             tar.bucket_sharded(b), b.precision) for b in tt.buckets] == \
        [(b.key, b.hierarchy, b.dcn_compressor, b.compressor, b.schedule_ir,
          jar.bucket_sharded(b), b.precision) for b in jt.buckets]
    # the hooked buckets of the overlap schedule: every AllReduce bucket at A = 1
    assert tt.hook_buckets == (tt.buckets if tt.sync_schedule == "overlap" else [])


@pytest.mark.parametrize("spec,kwargs,edit,match", [
    ("flat4", {"hierarchy": "two_level"}, None, "replica_dcn"),
    ("2x2", {"hierarchy": "two_level"}, ("dcn_compressor", _T.PowerSGDCompressor), "DCN-hop"),
    ("2x2", {}, ("schedule_ir", f"all_reduce@{ICI}"), "invalid schedule_ir"),
])
def test_transformer_errors_match_jax(spec, kwargs, edit, match):
    jitem, titem = _mlp_items()
    js = JAllReduce(**kwargs).build(jitem, JSPEC[spec])
    ts = AllReduce(**kwargs).build(titem, TSPEC[spec])
    if edit:
        for n in js.node_config:
            setattr(n.AllReduceSynchronizer, edit[0],
                    edit[1] if isinstance(edit[1], str) else int(edit[1]))
        for n in ts.node_config:
            setattr(n.AllReduceSynchronizer, edit[0], edit[1])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(tuple(js.graph_config.mesh.axis_sizes)),
                tuple(js.graph_config.mesh.axis_names))
    with pytest.raises(ValueError, match=match):
        JGraphTransformer(js, jitem, mesh)
    with pytest.raises(ValueError, match=match):
        GraphTransformer(ts, titem, "cpu", world=ReplicaWorld(rank=0, size=4))
    with pytest.raises(ValueError, match="sync_schedule"):
        GraphTransformer(AllReduce().build(titem, TSPEC["flat4"]), titem, "cpu",
                         world=ReplicaWorld(rank=0, size=4), sync_schedule="eager")
