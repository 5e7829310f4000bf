"""The 4-rank gloo world that the port's multi-rank tests hold against the
JAX package: its rank code and its launcher.  It imports no JAX: the port
has to run where JAX is absent.

:func:`world` starts one process per rank, once per test process (every
test module that needs R > 1 shares the world and its results), unless
:func:`prestart`, which each such module calls at its import, started
them while pytest collected the tests.  The
ranks run against one deadline (``WORLD_DEADLINE_S``): a rank that exits
non-zero, or the deadline passing, kills them all, and the failure, with
the rank's output, is kept, so that every later caller fails at once::

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r AUTODIST_INIT_METHOD=file://DIR/store \\
        AUTODIST_IS_TESTING=1 python tests/torch_gloo_ranks.py DIR

Each rank reads ``DIR/inputs.pkl`` (numpy arrays made from seeds by
:func:`make_inputs`), joins the process group through the port's own
bootstrap (:func:`autodist_tpu_torch.parallel.mesh.replica_world`, gloo for
the CPU), runs the cases below and writes ``DIR/rank<r>.pkl``:

- ``codec``: every codec's ``all_reduce`` on this rank's buffer (and, for
  the error-feedback codecs, its residual state);
- ``linear``: ``tests/test_end_to_end.py::test_value_exact_sync``'s linear
  model, 3 steps under ``AllReduce(chunk_size=1 | 128)`` x sgd/adam;
- ``linear_bare``: the same at chunk 1 under sgd on the bare ndarray batch,
  as that test passes it, and this rank's slice of it from ``shard_batch``
  beside the slice of the ``{"x": ...}`` form;
- ``compressors``: ``test_compressors``' one sgd step under each codec;
- ``gpt``: 3 adamw steps of a one-block GPT-tiny under ``Int8Compressor``
  and ``EquarxInt8Compressor``;
- ``seq_parallel`` (one dict): ring attention on the seq rows of the
  meshes ``{replica: 2, seq: 2}`` and ``{replica: 1, seq: 4}`` under both
  impls, with the gradients of ``sum(sin(out))``; Ulysses attention on the
  first, causal and not, and its indivisible-heads error; 3 sgd steps of
  the one-block GPT-tiny on ``{replica: 2, seq: 2}``, on the flat 4 replicas and on the
  one-axis ``{seq: 4}`` (data parallel, as in JAX), and the error of a
  batch whose dim 1 does not divide;
- ``ps`` (one dict): the PS builders' weight-update sharding on
  ``test_value_exact_sync``'s linear model (``PS``,
  ``PS(local_proxy_variable=True)``, ``PSLoadBalancing`` x sgd/adam, with
  the Adam moments' shapes), ``tests/test_grad_accumulation.py`` (A = 1,
  2, 4 under AllReduce and PS, A = 3's error, the threaded EMA, rng with
  aux), ``tests/test_clip_global_norm.py`` (AllReduce and PS),
  ``tests/test_uneven_batch.py`` (B = 13 and 9 under AllReduce and PS,
  with accumulation, ``predict``'s trim, the even batch, the error without
  the opt-in), ``run_steps``, ``fit`` and ``check_replication`` before and
  after rank 1 perturbs its copy;
- ``sharded`` (one dict): the AllReduce family's sharded update and bf16
  master on ``tests/test_sharded_update.py::_train``'s tanh MLP;
- ``hier`` (one dict), on the 2 x 2 mesh ``{replica_dcn: 2, replica_ici:
  2}``: each rank's ``AxisGroup`` of every axis tuple; the barrier and
  overlap syncs (flat, two-level) of ``tests/test_hierarchical_sync.py``'s
  buckets over its codec cases, two steps so that codec state carries, the
  overlap at a 64-byte chunk; the schedule-IR programs of
  ``tests/test_schedule_ir.py::test_searched_programs_match_flat`` through
  ``sync_bucketed``; PowerSGD's ``all_reduce`` over the 4 ranks; the tanh
  MLP (2 sgd steps) under two-level x barrier/overlap x the elementwise
  codecs, ``accum_steps=2`` under both schedules, bf16 EF on the DCN hop
  under overlap with accumulation, an int8 DCN codec, the sharded update,
  each IR program, and on the flat mesh the overlap schedule's issue
  record and the barrier's run; the dtypes that reach ``all_reduce`` for
  bf16 and f32 gradients (``tests/test_wire_dtype.py``);
- ``partitioned`` (one dict): the linear model under the four partitioned
  builders x sgd/adam, with the Adam moments in the variables' shapes
  (``canonical_leaf``) and each block's round trip through
  ``canonical_leaf`` and ``uncanonical_leaf``; ``test_sparse_embedding_all_strategies``' four
  builders; ``tests/test_sharded_embedding.py``'s row-split table (2 sgd
  steps, the shapes every op of step 1 made, the state's shapes,
  ``predict`` on 2-D ids); on ``{replica_dcn: 2, replica_ici: 2}``
  ``tests/test_ps_mesh_subset.py``'s PS, PartitionedPS, whole-axis PS and
  clipped PS (one sgd step each, with the process groups of their
  collectives), its Parallax with a sparse table and its unknown axes'
  error; a tiny NCF, 2 adam steps under Parallax and PartitionedPS;
- ``stale`` (one dict): bounded staleness.  DIVERGENT copies under
  ``PS(staleness=s)``: ``tests/test_end_to_end.py::
  test_staleness_local_updates_then_average`` (s = 1, two sgd steps) and
  ``::test_divergent_params_mid_window`` (s = 3, one step), each rank's
  own copy beside ``params()``' mean and ``check_replication()``; the
  linear model under adam (s = 1, 3 steps) with each rank's moments and
  their canonical mean; the clipped norm (s = 1, 2 steps); a tiny sparse
  table under ``Parallax(staleness=1)``.  Then the cross-process async
  PS, ``PS(sync=False, staleness=1)`` on the linear model: rank 0 serves
  on an ephemeral port and hands the address over through the world,
  every rank drives one worker for 3 sgd steps on its rows (rank 3 a
  straggler), waits for all, and records the server's stats and
  ``params()``.

- ``elastic`` (one dict): ``ElasticTrainer`` at R = 4 -> 2 on
  ``tests/test_elastic.py``'s linear model (``AllReduce(sharded_update=
  "sharded")``, adam, 5 steps on one batch, ``verify_restore=False``),
  checkpoints under ``DIR/elastic``: one node of 4 CPUs losing its upper
  half at step 2 (``kill_worker@2``), and two nodes of 2 CPUs losing the
  chief's (``kill_worker@2:10.0.0.1``), whose survivors hold global ranks
  2-3.  Each rank records its history, whether it left, its epoch and
  replans and the saved manifest; a survivor its world's place and
  members, the final parameters, and its world placed on ``{replica: 1,
  seq: 2}`` (``mesh_world`` on a subgroup: the seq row's index and size,
  and a ``psum`` of the global ranks over it).  The leaving ranks go on to the next
  entry on the default group while the survivors finish.
- ``checkpoint`` (one dict): checkpoints under ``DIR/ckpt``.  The
  canonical state (``canonical_params``, ``canonical_opt_state``) and the
  manifest after 2 adam steps of ``PSLoadBalancing``,
  ``PartitionedPS(max_shards=8)`` and ``PS(staleness=2)`` on
  ``tests/test_checkpoint.py``'s linear model and on the one-block
  GPT-tiny; that test's single-device save (PartitionedPS, 3 steps, with
  the step after it), same-strategy resume (PS) and cross-strategy resume
  (PartitionedPS -> AllReduce); a same-geometry update-space resume (each
  rank's state before and after, and the next step); the update-space
  saves that ``tests/test_manifest_reshard.py::test_reshard_matrix``
  reshards (adam, sgd with momentum x replicated, sharded update x flat,
  two-level on ``{replica_dcn: 2, replica_ici: 2}``), with their canonical
  state, and its PS flat-shard case; and the grow direction, an R = 1
  save by rank 0 resharded onto the 4 ranks.

Every ``AutoDist`` case records its strategy id and final parameters, so
the test can check that the ranks agree.  Rank 0 ends by importing every
module of ``autodist_tpu_torch`` and records the modules its interpreter
then holds (``imports``): a process that never imported JAX, where the
port's must not pull it in.
"""
import atexit
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD = 4
CODECS = ("NoneCompressor", "BF16Compressor", "BF16CompressorEF", "Int8Compressor",
          "Int8CompressorEF", "EquarxInt8Compressor")
CODEC_SIZES = (1000, 5000)
LINEAR_CASES = ((1, "sgd"), (1, "adam"), (128, "sgd"), (128, "adam"))
COMPRESSOR_CASES = {"NoneCompressor": 1e-6, "HorovodCompressor": 5e-3,
                    "HorovodCompressorEF": 5e-3, "Int8Compressor": 5e-2,
                    "Int8CompressorEF": 5e-2}
GPT_CODECS = ("Int8Compressor", "EquarxInt8Compressor")
GPT_SEQ, GPT_BATCH, GPT_STEPS = 16, 8, 3
GPT_VOCAB = 512   # GPT_TINY's vocabulary
GPT_LAYERS = 1    # one GPT-tiny block: every op of the model, half the JAX compile
SPEC = {"nodes": [{"address": "localhost", "cpus": list(range(WORLD)), "chief": True}]}
BLOCK = 256
# sequence parallelism: (replica, seq) layouts of the ring cases, the ring
# inputs' (B, S, H, D), Ulysses' heads, the GPT mesh and its sgd rate
RING_LAYOUTS = ((2, 2), (1, 4))
RING_SHAPE = (2, 32, 2, 8)
ULYSSES_HEADS, ULYSSES_BAD_HEADS = 4, 3
SP_MESH = {"replica": 2, "seq": 2}
SEQ_ONLY_MESH = {"seq": WORLD}   # one axis: dim 0 sharded over it, no ring
SP_LR = 0.05
# the PS cases: the linear model's builders, accumulation counts, the clip
# bound and the uneven batch sizes
PS_BUILDERS = ("PS", "PS_proxy", "PSLoadBalancing")
ACCUM_COUNTS = (1, 2, 4)
CLIP_NORM = 0.1
UNEVEN_SIZES = (13, 9)
# the sharded-update and bf16-master cases: the optimizers, the codecs, the
# steps of each run and the clip case's bound
SHARDED_OPTS = ("sgd", "momentum", "adam")
SHARDED_CODECS = ("BF16Compressor", "BF16CompressorEF", "Int8Compressor")
SHARDED_STEPS, SHARDED_CLIP = 2, 0.5
# the two-level cases: the mesh, tests/test_hierarchical_sync.py's bucket
# shapes and (codec, DCN codec) cases, tests/test_schedule_ir.py's
# synthesized programs, the overlap's forced chunk and the engine's codecs
HIER_MESH = {"replica_dcn": 2, "replica_ici": 2}
HIER_SHAPES = {"a": (33,), "b": (17, 3), "c": (41,), "d": (8, 8)}
HIER_CASES = (("NoneCompressor", 0), ("BF16Compressor", 0), ("BF16CompressorEF", 0),
              ("Int8Compressor", 0), ("NoneCompressor", 3), ("NoneCompressor", 1))
IR_PROGRAMS = (
    "reduce_scatter@replica_ici:BF16Compressor;all_reduce@replica_dcn;"
    "all_gather@replica_ici:BF16Compressor",
    "reduce_scatter@replica_ici;ppermute_ring@replica_dcn;all_gather@replica_ici",
    "reduce_scatter@replica_ici;reduce_scatter@replica_dcn;all_gather@replica_dcn;"
    "all_gather@replica_ici",
    "reduce_scatter@replica_ici:BF16Compressor;all_reduce@replica_dcn:Int8Compressor;"
    "all_gather@replica_ici:BF16Compressor")
HIER_CHUNK_BYTES = 64
HIER_CODECS = ("NoneCompressor", "BF16Compressor", "BF16CompressorEF")
POWERSGD_SIZE = 5000
# the synchronous PS family: the partitioned builders on the linear model;
# the sparse embedding (V, D) under four builders; the row-split table of
# tests/test_sharded_embedding.py and its padded vocabulary; the PS subset's
# axis; a tiny NCF (users, items, mf_dim, mlp_dims) and its batch
PART_BUILDERS = ("PartitionedPS", "UnevenPartitionedPS", "PartitionedAR",
                 "RandomAxisPartitionAR")
SPARSE_BUILDERS = ("Parallax", "AllReduce", "PS", "PartitionedPS")
SPARSE_V, SPARSE_D, SPARSE_STEPS = 50, 4, 2
TABLE_V, TABLE_D, TABLE_PAD_V = 4100, 7, 4100
SUBSET_AXES = ("replica_ici",)
SUBSET_LR, SUBSET_CLIP = 0.1, 0.05
NCF_TINY = dict(num_users=40, num_items=24, mf_dim=8, mlp_dims=(16, 8, 4))
NCF_BUILDERS = ("Parallax", "PartitionedPS")
NCF_BATCH, NCF_STEPS, NCF_LR = 16, 2, 1e-3
# bounded staleness: tests/test_end_to_end.py's staleness cases (the batch,
# the periods, the steps), the adam, clip and Parallax cases' period and
# steps, and the async cluster's bound, steps, straggler delay and deadline
STALE_BATCH = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
STALE_AVERAGE, STALE_MID = 1, 3
STALE_PERIOD_S, STALE_STEPS = 1, 3
ASYNC_S, ASYNC_STEPS, ASYNC_DELAY, ASYNC_TIMEOUT = 1, 3, 0.02, 10.0
# checkpoints: the canonical-state builders, their adam steps and rates;
# tests/test_checkpoint.py's adam rate; the reshard matrix's axes
CKPT_BUILDERS = {"PSLoadBalancing": ("PSLoadBalancing", {}),
                 "PartitionedPS": ("PartitionedPS", {"max_shards": 8}),
                 "PS_stale": ("PS", {"staleness": 2})}
CKPT_STEPS, CKPT_GPT_LR, CKPT_LR = 2, 1e-3, 0.05
RESHARD_OPTS = ("adam", "sgd")
RESHARD_UPDATES = ("replicated", "sharded")
RESHARD_HIERARCHIES = ("flat", "two_level")
RESHARD_STEPS = 3
# elastic training: tests/test_elastic.py's linear model and adam rate, the
# steps, and the two cases' specs and chaos (the chief's node killed in the
# second, so its survivors hold global ranks 2-3)
ELASTIC_STEPS, ELASTIC_LR = 5, 0.05
ELASTIC_CASES = {
    "single_node": ({"nodes": [{"address": "localhost", "cpus": list(range(WORLD)),
                                "chief": True}]}, "kill_worker@2"),
    "chief_failover": ({"nodes": [{"address": "10.0.0.1", "cpus": [0, 1], "chief": True},
                                  {"address": "10.0.0.2", "cpus": [0, 1]}]},
                       "kill_worker@2:10.0.0.1"),
}


def elastic_params():
    """``tests/test_elastic.py::_params``."""
    return {"w": np.random.RandomState(7).randn(12, 3).astype(np.float32)}


def elastic_batch():
    """``tests/test_elastic.py::_batch_fn(0)``, the fixed batch of its loop."""
    r = np.random.RandomState(0)
    return {"x": r.randn(16, 12).astype(np.float32), "y": r.randn(16, 3).astype(np.float32)}


def codec_inputs(r, n, seed):
    """(r, n) buffers with magnitudes spread over blocks, an all-zero block,
    and (r, n) residual states."""
    rng = np.random.RandomState(seed)
    bufs = (rng.randn(r, n) * np.exp(rng.uniform(-3, 3, (r, 1)))).astype(np.float32)
    bufs[:, BLOCK:2 * BLOCK] = 0.0
    states = (1e-3 * rng.randn(r, n)).astype(np.float32)
    return bufs, states


def gpt_batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, GPT_VOCAB, (GPT_BATCH, GPT_SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def linear_inputs():
    rs = np.random.RandomState(0)
    batch = rs.randn(16, 12).astype(np.float32)
    r = np.random.RandomState(7)
    return batch, {"w": r.randn(12, 3).astype(np.float32), "b": np.zeros(3, np.float32)}


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def mlp_inputs():
    """``tests/test_sharded_update.py::_train``'s parameters and batch, drawn
    in its order from one RandomState."""
    r = np.random.RandomState(0)
    params = {"w1": r.randn(32, 16).astype(np.float32), "b1": np.zeros(16, np.float32),
              "w2": r.randn(16, 4).astype(np.float32)}
    batch = {"x": r.randn(32, 32).astype(np.float32), "y": r.randn(32, 4).astype(np.float32)}
    return params, batch


def sharded_clip_inputs():
    """``test_sharded_update_with_global_norm_clip``'s parameters and batch."""
    r = np.random.RandomState(1)
    params = {"w": (r.randn(32, 8) * 3).astype(np.float32)}
    return params, {"x": r.randn(16, 32).astype(np.float32)}


def make_inputs(jax_gpt_params):
    """Every rank's inputs, from seeds; ``jax_gpt_params`` is the flax
    GPT-tiny parameter tree both packages train."""
    from autodist_tpu_torch.models import convert

    linear_batch, linear_params = linear_inputs()
    b, s, _, d = RING_SHAPE
    inputs = {
        "codec_bufs": {}, "codec_states": {},
        "linear_batch": linear_batch, "linear_params": linear_params,
        "compressor_batch": np.random.RandomState(0).randn(16, 64).astype(np.float32),
        "gpt_params": {convert.torch_to_jax_name(n): t.numpy() for n, t in
                       convert.params_from_jax(jax_gpt_params).items()},
        "gpt_batch": gpt_batch(),
        "ring_qkv": qkv(RING_SHAPE, seed=11),
        "ulysses_qkv": qkv((b, s, ULYSSES_HEADS, d), seed=12),
        "ulysses_bad_qkv": qkv((b, s // 2, ULYSSES_BAD_HEADS, d), seed=13),
        "accum_batch": np.random.RandomState(0).randn(32, 6).astype(np.float32),
        "clip_batch": 5.0 * np.random.RandomState(0).randn(16, 10).astype(np.float32),
        "clip_params": {"w": np.random.RandomState(3).randn(10, 4).astype(np.float32),
                        "b": np.zeros(4, np.float32)},
        "uneven_params": {"w": np.random.RandomState(7).randn(6, 3).astype(np.float32),
                          "b": np.zeros(3, np.float32)},
        "uneven_batches": {n: np.random.RandomState(0).randn(n, 6).astype(np.float32)
                           for n in UNEVEN_SIZES},
        "uneven_accum_batch": np.random.RandomState(1).randn(13, 6).astype(np.float32),
    }
    inputs["mlp_params"], inputs["mlp_batch"] = mlp_inputs()
    inputs["sharded_clip_params"], inputs["sharded_clip_batch"] = sharded_clip_inputs()
    inputs["hier_grads"] = hier_grads()
    for i, n in enumerate(CODEC_SIZES):
        inputs["codec_bufs"][n], inputs["codec_states"][n] = codec_inputs(WORLD, n,
                                                                          seed=40 + i)
    inputs.update(sparse_inputs())
    return inputs


def hier_grads():
    """``tests/test_hierarchical_sync.py::_run_sync``'s per-device gradients
    (one RandomState(0), (4, n) per shape in order) and their second step
    ``g * 1.7 - 0.3``, computed here once for both packages."""
    r = np.random.RandomState(0)
    g1 = {n: r.randn(WORLD, int(np.prod(s))).astype(np.float32)
          for n, s in HIER_SHAPES.items()}
    return g1, {n: (g * np.float32(1.7) - np.float32(0.3)).astype(np.float32)
                for n, g in g1.items()}


def reshard_inputs():
    """``tests/test_manifest_reshard.py``'s batch and parameters."""
    r = np.random.RandomState(0)
    batch = {"x": r.randn(16, 12).astype(np.float32), "y": r.randn(16, 3).astype(np.float32)}
    r = np.random.RandomState(7)
    return batch, {"w": r.randn(12, 3).astype(np.float32), "b": np.zeros(3, np.float32)}


def reshard_optimizer(name):
    """The reshard matrix's optimizers: adam(0.05), sgd(0.1) with momentum
    0.9 (the momentum gives it a slot to reshard)."""
    from autodist_tpu_torch import optim

    return optim.adam(0.05) if name == "adam" else optim.sgd(0.1, momentum=0.9)


def sparse_inputs():
    """The PS family's cases' inputs, drawn in the JAX tests' orders:
    ``test_sparse_embedding_all_strategies``' table, projection and ids;
    ``tests/test_sharded_embedding.py``'s table (the value-exact and 2-D
    ids batches); ``tests/test_ps_mesh_subset.py``'s MLP, batch and
    Parallax table; and NCF_TINY's weights (flax names, Dense kernels
    ``(out, in)``) and batch."""
    r = np.random.RandomState(1)
    out = {"sparse_table": r.randn(SPARSE_V, SPARSE_D).astype(np.float32),
           "sparse_proj": r.randn(SPARSE_D, 2).astype(np.float32)}
    out["sparse_ids"] = r.randint(0, SPARSE_V, size=(16,)).astype(np.int32)
    r = np.random.RandomState(0)
    out["table_params"] = {"emb": r.randn(TABLE_V, TABLE_D).astype(np.float32),
                           "proj": r.randn(TABLE_D, 2).astype(np.float32)}
    out["table_ids"] = np.random.RandomState(2).randint(0, TABLE_V, (32,)).astype(np.int32)
    out["table_ids_2d"] = np.random.RandomState(3).randint(0, TABLE_V,
                                                           (8, 5)).astype(np.int32)
    out["subset_batch"] = {"x": np.random.RandomState(0).randn(16, 8).astype(np.float32),
                           "y": np.random.RandomState(1).randn(16).astype(np.float32)}
    r = np.random.RandomState(3)
    out["subset_params"] = {"w1": (r.randn(8, 16) * 0.3).astype(np.float32),
                            "b1": np.zeros((16,), np.float32),
                            "w2": (r.randn(16, 1) * 0.3).astype(np.float32)}
    r = np.random.RandomState(5)
    out["parallax_params"] = {"emb": (r.randn(30, 8) * 0.3).astype(np.float32),
                              "w": (r.randn(8, 1) * 0.3).astype(np.float32)}
    out["parallax_ids"] = np.random.RandomState(6).randint(0, 30, (16,))
    c, r = NCF_TINY, np.random.RandomState(9)
    half, dims = c["mlp_dims"][0] // 2, (c["mlp_dims"][0],) + c["mlp_dims"]
    ncf = {"mf_user_embedding": (c["num_users"], c["mf_dim"]),
           "mf_item_embedding": (c["num_items"], c["mf_dim"]),
           "mlp_user_embedding": (c["num_users"], half),
           "mlp_item_embedding": (c["num_items"], half)}
    ncf = {n: (0.3 * r.randn(*shape)).astype(np.float32) for n, shape in ncf.items()}
    for i in range(len(c["mlp_dims"])):
        ncf[f"Dense_{i}/kernel"] = (r.randn(dims[i + 1], dims[i]) / np.sqrt(dims[i])
                                    ).astype(np.float32)
        ncf[f"Dense_{i}/bias"] = (0.1 * r.randn(dims[i + 1])).astype(np.float32)
    ncf["prediction/kernel"] = r.randn(1, c["mf_dim"] + dims[-1]).astype(np.float32)
    ncf["prediction/bias"] = np.zeros((1,), np.float32)
    out["ncf_params"] = ncf
    out["ncf_batch"] = {"user": r.randint(0, c["num_users"], (NCF_BATCH,)).astype(np.int32),
                        "item": r.randint(0, c["num_items"], (NCF_BATCH,)).astype(np.int32),
                        "label": (r.rand(NCF_BATCH) < 0.5).astype(np.float32)}
    return out


_WORLD = {}
WORLD_DEADLINE_S = 90   # the ranks' whole run, shared by all four
OUTPUT_TAIL = 4000      # characters of a failed rank's output kept in the message


def rank_command(workdir):
    """The command each rank runs (its environment says which rank)."""
    return [sys.executable, os.path.abspath(__file__), workdir]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def _launch(jax_gpt_params):
    """Start the four ranks; returns what :func:`_finish` waits for.  The
    ranks are killed at the test process's exit if still running."""
    workdir = tempfile.mkdtemp(prefix="gloo4-")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    inputs = make_inputs(jax_gpt_params())
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(WORLD)]
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   AUTODIST_INIT_METHOD=f"file://{os.path.join(workdir, 'store')}",
                   AUTODIST_IS_TESTING="1", PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   GLOO_SOCKET_IFNAME="lo")   # loopback: no hostname lookup
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(rank_command(workdir), env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    atexit.register(_kill, procs)
    return workdir, inputs, procs, logs, time.monotonic() + WORLD_DEADLINE_S


def _finish(launched):
    """Wait for the launched ranks to their end against their one deadline;
    returns ``(inputs, per-rank results)``, or raises ``RuntimeError`` with
    the failing rank's output tail.  A rank that exits non-zero, or the
    deadline passing, kills every rank at once."""
    workdir, inputs, procs, logs, deadline = launched
    failed = timed_out = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            timed_out = failed is None and time.monotonic() > deadline
            if timed_out:
                failed = next(r for r, p in enumerate(procs) if p.poll() is None)
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode), None)
    finally:
        _kill(procs)
    if failed is not None:
        with open(logs[failed], errors="replace") as f:
            tail = f.read()[-OUTPUT_TAIL:]
        why = (f"was still running at the {WORLD_DEADLINE_S} s deadline" if timed_out
               else f"exited {procs[failed].returncode}")
        raise RuntimeError(f"gloo world: rank {failed} {why}:\n{tail}")
    results = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    assert [res["rank"] for res in results] == list(range(WORLD))
    assert all(res["world"] == WORLD for res in results)
    return inputs, results


def world(jax_gpt_params):
    """Start the 4 ranks once per process (unless :func:`prestart` did) and
    return ``(inputs, results)``, the per-rank results in rank order; later
    calls return the same.  ``jax_gpt_params()`` gives the flax GPT-tiny
    tree; it is called only when the ranks start.  A world that fails is
    not started again: its error is kept, and every later call raises it
    at once."""
    if "error" in _WORLD:
        raise RuntimeError(_WORLD["error"])
    if "results" not in _WORLD:
        try:
            inputs, results = _finish(_WORLD.pop("launched", None)
                                      or _launch(jax_gpt_params))
        except Exception as e:
            _WORLD["error"] = f"{type(e).__name__}: {e}"
            raise
        _WORLD.update(inputs=inputs, results=results)
    return _WORLD["inputs"], _WORLD["results"]


def prestart(jax_gpt_params):
    """Start the ranks now without waiting for them, once per process: a
    test module that uses the world calls this when it is imported, so
    the ranks run while pytest collects and runs the tests before it (the
    collection imports JAX, flax and torch on one core); :func:`world`
    then waits for what is left of their run.  The JAX worker process
    (``torch_jax_worker``), which imports the test modules, starts none."""
    import torch_jax_worker

    if not _WORLD and not torch_jax_worker.in_worker():
        try:
            _WORLD["launched"] = _launch(jax_gpt_params)
        except Exception as e:
            _WORLD["error"] = f"{type(e).__name__}: {e}"


def _session_result(sess, metrics):
    return {"strategy_id": sess.strategy_id, "step": sess.step,
            "loss": metrics["loss"].item(),
            "params": {n: t.numpy() for n, t in sess.params().items()}}


def main(workdir):
    import torch

    torch.set_num_threads(2)
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist
    from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
    from autodist_tpu_torch.models.gpt import GPT_TINY
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.parallel.mesh import replica_world
    from autodist_tpu_torch.proto import schema
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    world = replica_world("cpu")
    rank = world.rank
    results = {"rank": rank, "world": world.size}

    def autodist(builder, spec=SPEC):
        return AutoDist(resource_spec=ResourceSpec(resource_info=spec),
                        strategy_builder=builder, device="cpu")

    for name in CODECS:
        for n in CODEC_SIZES:
            comp = get_compressor(getattr(schema.AllReduceSynchronizer, name))
            buf = torch.from_numpy(inputs["codec_bufs"][n][rank])
            state = torch.from_numpy(inputs["codec_states"][n][rank]) if comp.stateful else ()
            out, new_state = comp.all_reduce(buf, state, world.group)
            results["codec", name, n] = (out.numpy(), new_state.numpy()
                                         if comp.stateful else None)

    def linear_loss(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"]) ** 2)

    for chunk, opt in LINEAR_CASES:
        make = optim.sgd(0.1) if opt == "sgd" else optim.adam(0.05)
        params = {k: torch.from_numpy(v) for k, v in inputs["linear_params"].items()}
        sess = autodist(AllReduce(chunk_size=chunk)).distribute(linear_loss, params, make)
        for _ in range(3):
            metrics = sess.run({"x": inputs["linear_batch"]})
        results["linear", chunk, opt] = _session_result(sess, metrics)

    params = {k: torch.from_numpy(v) for k, v in inputs["linear_params"].items()}
    sess = autodist(AllReduce(chunk_size=1)).distribute(
        lambda p, x: torch.mean((x @ p["w"] + p["b"]) ** 2), params, optim.sgd(0.1))
    results["linear_bare_slices"] = (
        sess.shard_batch(inputs["linear_batch"]).numpy(),
        sess.shard_batch({"x": inputs["linear_batch"]})["x"].numpy())
    for _ in range(3):
        metrics = sess.run(inputs["linear_batch"])
    results["linear_bare"] = _session_result(sess, metrics)

    for comp in COMPRESSOR_CASES:
        sess = autodist(AllReduce(compressor=comp)).distribute(
            lambda p, b: torch.mean(b["x"] @ p["w"]), {"w": torch.ones(64)},
            optim.sgd(0.1))
        metrics = sess.run({"x": inputs["compressor_batch"]})
        results["compressors", comp] = _session_result(sess, metrics)

    for comp in GPT_CODECS:
        loss_fn, _, sparse = gpt_capture(dataclasses.replace(GPT_TINY, num_layers=GPT_LAYERS),
                                         GPT_SEQ, device="cpu")
        params = {n: torch.from_numpy(a) for n, a in inputs["gpt_params"].items()}
        sess = autodist(AllReduce(compressor=comp)).distribute(
            loss_fn, params, optim.adamw(1e-3), sparse_vars=sparse, has_rng=True)
        losses = [sess.run(inputs["gpt_batch"])["loss"].item() for _ in range(GPT_STEPS)]
        results["gpt", comp] = dict(_session_result(sess, {"loss": torch.tensor(0.0)}),
                                    losses=losses)

    results["seq_parallel"] = seq_parallel_cases(inputs, world, autodist)
    results["ps"] = ps_cases(inputs, world, autodist)
    results["sharded"] = sharded_cases(inputs, autodist)
    results["hier"] = hier_cases(inputs, world, autodist)
    results["partitioned"] = partitioned_cases(inputs, autodist)
    results["stale"] = stale_cases(inputs, world, autodist)
    results["elastic"] = elastic_cases(workdir)
    results["checkpoint"] = checkpoint_cases(inputs, world, autodist, workdir)
    if rank == 0:
        results["imports"] = package_imports()

    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def package_modules():
    """The dotted name of every module of ``autodist_tpu_torch``."""
    modules = []
    for root, _, files in os.walk(os.path.join(REPO, "autodist_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                modules.append(rel[:-len(".__init__")] if rel.endswith("__init__") else rel)
    return sorted(modules)


def package_imports():
    """Import every module of the package; returns the modules this
    interpreter then holds."""
    import importlib

    for m in package_modules():
        importlib.import_module(m)
    return sorted(sys.modules)


def seq_parallel_cases(inputs, world, autodist):
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPT_TINY
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.parallel.context import seq_axis_context
    from autodist_tpu_torch.parallel.mesh import mesh_world
    from autodist_tpu_torch.parallel.ring_attention import all_to_all_attention, ring_attention
    from autodist_tpu_torch.strategy import AllReduce

    out = {}

    def block(arrays, seq):
        per = arrays[0].shape[1] // seq.size
        return [torch.from_numpy(a[:, seq.index * per:(seq.index + 1) * per].copy())
                for a in arrays]

    worlds = {layout: mesh_world(world, ("replica", "seq"), layout) for layout in RING_LAYOUTS}
    for layout, w in worlds.items():
        for impl in ("flash", "xla"):
            q, k, v = (t.requires_grad_(True) for t in block(inputs["ring_qkv"], w.seq))
            with seq_axis_context(w.seq):
                y = ring_attention(q, k, v, causal=True, impl=impl)
                grads = torch.autograd.grad(torch.sin(y).sum(), (q, k, v))
            out["ring", layout, impl] = dict(index=w.seq.index, size=w.seq.size,
                                             row=w.data_index, out=y.detach().numpy(),
                                             grads=[g.numpy() for g in grads])
    seq = worlds[RING_LAYOUTS[0]].seq
    with seq_axis_context(seq):
        for causal in (False, True):
            y = all_to_all_attention(*block(inputs["ulysses_qkv"], seq), causal=causal)
            out["ulysses", causal] = dict(index=seq.index, out=y.numpy())
        try:
            all_to_all_attention(*block(inputs["ulysses_bad_qkv"], seq))
        except ValueError as e:
            out["ulysses_indivisible"] = str(e)

    params = {n: torch.from_numpy(a) for n, a in inputs["gpt_params"].items()}
    batch = inputs["gpt_batch"]
    for name, mesh in (("seq", SP_MESH), ("flat", None), ("seq_only", SEQ_ONLY_MESH)):
        spec = dict(SPEC, mesh=mesh) if mesh else SPEC
        loss_fn, _, sparse = gpt_capture(dataclasses.replace(GPT_TINY, num_layers=GPT_LAYERS),
                                         GPT_SEQ, device="cpu")
        sess = autodist(AllReduce(), spec).distribute(
            loss_fn, params, optim.sgd(SP_LR), sparse_vars=sparse, has_rng=True)
        losses = [sess.run(batch)["loss"].item() for _ in range(GPT_STEPS)]
        seq_axis = sess.transformer.seq_axis
        out["gpt", name] = dict(
            losses=losses, strategy_id=sess.strategy_id,
            seq=None if seq_axis is None else (seq_axis.index, seq_axis.size),
            data_slice=sess.transformer.world.data_slice,
            params={n: t.numpy() for n, t in sess.params().items()})
        if name == "seq":
            bad = dict(batch, tokens=batch["tokens"][:, :GPT_SEQ - 1])
            try:
                sess.run(bad)
            except ValueError as e:
                out["dim1_error"] = str(e)
    return out


def masked_mse(p, batch):
    """``tests/test_uneven_batch.py``'s loss: a masked mean over the real rows."""
    import torch

    per_ex = torch.mean((batch["x"] @ p["w"] + p["b"]) ** 2, dim=-1)
    m = batch.get("__batch_mask__")
    if m is None:
        return torch.mean(per_ex)
    m = m.to(per_ex.dtype)
    return torch.sum(per_ex * m) / torch.clamp(torch.sum(m), min=1.0)


def ps_cases(inputs, world, autodist):
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.strategy import PS, AllReduce, PSLoadBalancing

    builders = {"PS": PS, "PS_proxy": lambda: PS(local_proxy_variable=True),
                "PSLoadBalancing": PSLoadBalancing, "AllReduce": AllReduce}
    out = {}

    def tensors(arrays):
        return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}

    def linear_loss(p, batch):
        return torch.mean((batch @ p["w"] + p["b"]) ** 2)

    for name in PS_BUILDERS:
        for opt in ("sgd", "adam"):
            make = optim.sgd(0.1) if opt == "sgd" else optim.adam(0.05)
            sess = autodist(builders[name]()).distribute(
                linear_loss, tensors(inputs["linear_params"]), make)
            for _ in range(3):
                metrics = sess.run(inputs["linear_batch"])
            res = _session_result(sess, metrics)
            opt_state = sess.state["opt_state"].state
            res["moments"] = {n: tuple(opt_state[t]["exp_avg"].shape) if opt == "adam"
                              else None for n, t in sess.state["shards"].items()}
            res["syncs"] = [n.WhichOneof("synchronizer")
                            for n in sess.transformer.strategy.node_config]
            out["linear", name, opt] = res

    def accum_loss(p, b):
        return torch.mean((b @ p["w"]) ** 2)

    for name in ("AllReduce", "PS"):
        for a in ACCUM_COUNTS:
            sess = autodist(builders[name]()).distribute(
                accum_loss, {"w": torch.ones(6)}, optim.sgd(0.05), accum_steps=a)
            for _ in range(3):
                metrics = sess.run(inputs["accum_batch"])
            out["accum", name, a] = _session_result(sess, metrics)
    sess = autodist(AllReduce()).distribute(accum_loss, {"w": torch.ones(6)},
                                            optim.sgd(0.05), accum_steps=3)
    try:
        sess.run(inputs["accum_batch"])
    except ValueError as e:
        out["accum_error"] = str(e)

    def ema_loss(p, s, b):
        return torch.mean(b @ p["w"]), {"ema": 0.5 * s["ema"] + 0.5 * torch.mean(b)}

    for a in (1, 4):
        sess = autodist(AllReduce()).distribute(
            ema_loss, {"w": torch.ones(6)}, optim.sgd(0.0),
            mutable_state={"ema": torch.zeros(())}, accum_steps=a)
        sess.run(np.ones((32, 6), np.float32))
        out["ema", a] = float(sess.mutable_state()["ema"])

    def aux_loss(p, b, generator):
        return torch.mean(b @ p["w"]), {"n": torch.randn((), generator=generator)}

    sess = autodist(PSLoadBalancing()).distribute(
        aux_loss, {"w": torch.ones(6)}, optim.sgd(0.05), has_aux=True, has_rng=True,
        accum_steps=2)
    metrics = sess.run(inputs["accum_batch"])
    out["rng_aux"] = {k: float(v) for k, v in metrics.items()}

    def clip_loss(p, b):
        return torch.mean((b @ p["w"] + p["b"]) ** 2)

    for name in ("AllReduce", "PS"):
        sess = autodist(builders[name]()).distribute(
            clip_loss, tensors(inputs["clip_params"]), optim.sgd(0.1),
            clip_global_norm=CLIP_NORM)
        for _ in range(3):
            metrics = sess.run(inputs["clip_batch"])
        out["clip", name] = dict(_session_result(sess, metrics),
                                 grad_norm=float(metrics["grad_norm"]))

    for name in ("AllReduce", "PS"):
        for n in UNEVEN_SIZES:
            sess = autodist(builders[name]()).distribute(
                masked_mse, tensors(inputs["uneven_params"]), optim.sgd(0.1),
                batch_mask=True)
            for _ in range(2):
                metrics = sess.run({"x": inputs["uneven_batches"][n]})
            out["uneven", name, n] = _session_result(sess, metrics)
    sess = autodist(AllReduce()).distribute(
        masked_mse, tensors(inputs["uneven_params"]), optim.sgd(0.1), accum_steps=2,
        batch_mask=True)
    sess.run({"x": inputs["uneven_accum_batch"]})
    out["uneven_accum"] = _session_result(sess, {"loss": torch.tensor(0.0)})
    sess = autodist(AllReduce()).distribute(
        masked_mse, tensors(inputs["uneven_params"]), optim.sgd(0.1),
        eval_fn=lambda p, b: b["x"] @ p["w"] + p["b"], batch_mask=True)
    out["predict_shape"] = tuple(sess.predict({"x": np.ones((10, 6), np.float32)}).shape)
    padded, pad = sess._pad_uneven({"x": np.ones((16, 6), np.float32)})
    out["even_batch"] = (pad, sorted(padded))
    sess = autodist(AllReduce()).distribute(masked_mse, tensors(inputs["uneven_params"]),
                                            optim.sgd(0.1))
    try:
        sess.run({"x": np.ones((13, 6), np.float32)})
    except ValueError as e:
        out["uneven_error"] = str(e)

    sess = autodist(PSLoadBalancing()).distribute(
        linear_loss, tensors(inputs["linear_params"]), optim.adam(0.05))
    sess.run_steps([inputs["linear_batch"]] * 2)
    steps = [sess.step]
    sess.fit(lambda step: inputs["linear_batch"], steps=5)
    steps.append(sess.step)
    out["session_steps"] = steps
    replication = [sess.check_replication()]
    if world.rank == 1:
        with torch.no_grad():
            sess.state["params"]["w"][0, 0] += 1.0
    replication.append(sess.check_replication())
    out["replication"] = replication
    return out


def sharded_cases(inputs, autodist):
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.strategy import AllReduce

    opts = {"sgd": lambda: optim.sgd(0.1), "momentum": lambda: optim.sgd(0.1, momentum=0.9),
            "adam": lambda: optim.adam(0.05)}

    def mlp_loss(p, b):   # f32 inputs meet bf16 compute copies in f32, as JAX promotes
        h = torch.tanh(b["x"] @ p["w1"].float() + p["b1"])
        return torch.mean((h @ p["w2"].float() - b["y"]) ** 2)

    def mlp_apply(p, b):
        return torch.tanh(b["x"] @ p["w1"] + p["b1"]) @ p["w2"]

    def clip_loss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    def run(builder, opt="sgd", loss=mlp_loss, params="mlp_params", batch="mlp_batch",
            steps=SHARDED_STEPS, **options):
        sess = autodist(builder).distribute(
            loss, {k: torch.from_numpy(v.copy()) for k, v in inputs[params].items()},
            opts[opt](), **options)
        for _ in range(steps):
            metrics = sess.run(inputs[batch])
        t = sess.transformer
        opt_state = sess.state["opt_state"].state
        return dict(
            _session_result(sess, metrics), sharded=t.sync_sharded_update,
            mixed=t.sync_mixed_precision, replication=sess.check_replication(),
            grad_norm=float(metrics["grad_norm"]) if "grad_norm" in metrics else None,
            shards={n: (tuple(x.shape), str(x.dtype)) for n, x in sess.state["shards"].items()},
            stored={n: (tuple(x.shape), str(x.dtype)) for n, x in sess.state["params"].items()},
            moments={n: tuple(opt_state[x]["exp_avg"].shape)
                     for n, x in sess.state["shards"].items()} if opt == "adam" else None,
            predict=sess.predict(inputs[batch], mlp_apply).numpy()
            if loss is mlp_loss else None)

    out = {}
    for opt in SHARDED_OPTS:
        for mode in ("replicated", "sharded"):
            out["opt", opt, mode] = run(AllReduce(sharded_update=mode), opt)
        out["bf16_master", opt] = run(AllReduce(precision="bf16_master"), opt)
    for comp in SHARDED_CODECS:
        for mode in ("replicated", "sharded"):
            out["codec", comp, mode] = run(AllReduce(compressor=comp, sharded_update=mode))
    for mode in ("replicated", "sharded"):
        out["accum", mode] = run(AllReduce(sharded_update=mode), "adam", accum_steps=2)
        out["clip", mode] = run(AllReduce(sharded_update=mode), loss=clip_loss,
                                params="sharded_clip_params", batch="sharded_clip_batch",
                                steps=1, clip_global_norm=SHARDED_CLIP)
    return out


def hier_buckets(comp, hierarchy, dcn=0, schedule_ir=""):
    """``tests/test_hierarchical_sync.py::_hier_buckets`` (two variables a
    group) through the port's ``plan_buckets``."""
    from autodist_tpu_torch.kernel import partitioner as part
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar

    plans = {name: part.VarPlan(name=name, shape=HIER_SHAPES[name], dtype="float32",
                                placement=part.Placement.REPLICATED,
                                sync=part.SyncKind.ALL_REDUCE, group=i // 2,
                                compressor=comp, hierarchy=hierarchy, dcn_compressor=dcn,
                                schedule_ir=schedule_ir)
             for i, name in enumerate(sorted(HIER_SHAPES))}
    return ar.plan_buckets(plans, HIER_SHAPES, dict.fromkeys(HIER_SHAPES, "float32"))


def hier_cases(inputs, world, autodist):
    import torch
    import torch.distributed as dist

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar
    from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
    from autodist_tpu_torch.parallel.mesh import mesh_world
    from autodist_tpu_torch.proto import schema
    from autodist_tpu_torch.strategy import AllReduce

    C = schema.AllReduceSynchronizer
    rank = world.rank
    w = mesh_world(world, tuple(HIER_MESH), tuple(HIER_MESH.values()))
    hier = ar.HierAxes(ici="replica_ici", dcn=("replica_dcn",))
    out = {"axis_groups": {axes: (g.index, g.size, g.order) for axes in (
        ("replica_dcn",), ("replica_ici",), ("replica_dcn", "replica_ici"),
        ("replica_ici", "replica_dcn")) for g in [w.axis_group(axes)]}}
    g1, g2 = ({n: torch.from_numpy(g[n][rank].reshape(HIER_SHAPES[n]).copy())
               for n in HIER_SHAPES} for g in inputs["hier_grads"])

    def two_steps(buckets, fn, **kw):
        states = ar.init_compressor_states(buckets)
        s1, states = fn(g1, buckets, states, w.group, axes=w.axis_group, **kw)
        s2, _ = fn(g2, buckets, states, w.group, axes=w.axis_group, **kw)
        return [{n: t.numpy() for n, t in s.items()} for s in (s1, s2)]

    for comp, dcn in HIER_CASES:
        c = getattr(C, comp)
        flat, two = hier_buckets(c, C.FLAT), hier_buckets(c, C.TWO_LEVEL, dcn)
        out["sync", comp, dcn] = {
            "flat": two_steps(flat, ar.sync_bucketed),
            "flat_overlap": two_steps(flat, ar.sync_overlapped,
                                      max_chunk_bytes=HIER_CHUNK_BYTES),
            "two": two_steps(two, ar.sync_hierarchical, hier=hier),
            "two_overlap": two_steps(two, ar.sync_overlapped, hier=hier,
                                     max_chunk_bytes=HIER_CHUNK_BYTES)}
    for ir in IR_PROGRAMS:
        out["ir_sync", ir] = two_steps(hier_buckets(0, C.FLAT, schedule_ir=ir),
                                       ar.sync_bucketed)

    comp = get_compressor(C.PowerSGDCompressor)
    buf = torch.from_numpy(inputs["codec_bufs"][POWERSGD_SIZE][rank])
    approx, state = comp.all_reduce(buf, comp.init_state(POWERSGD_SIZE), world.group)
    out["powersgd"] = (approx.numpy(), state["Q"].numpy(), state["residual"].numpy())

    hspec = dict(SPEC, mesh=HIER_MESH)

    def mlp_loss(p, b):
        h = torch.tanh(b["x"] @ p["w1"].float() + p["b1"])
        return torch.mean((h @ p["w2"].float() - b["y"]) ** 2)

    def train(builder, spec=hspec, **options):
        sess = autodist(builder, spec).distribute(
            mlp_loss, {k: torch.from_numpy(v.copy()) for k, v in inputs["mlp_params"].items()},
            optim.sgd(0.1), **options)
        for _ in range(2):
            metrics = sess.run(inputs["mlp_batch"])
        t = sess.transformer
        return dict(_session_result(sess, metrics), hierarchy=t.sync_hierarchy,
                    schedule=t.sync_schedule, replication=sess.check_replication(),
                    sharded=t.sync_sharded_update, keys=[b.key for b in t.buckets],
                    issued=None if t.last_overlap is None else (
                        t.last_overlap.issued, t.last_overlap.issued_in_backward))

    for codec in HIER_CODECS:
        for sched in ("barrier", "overlap"):
            out["engine", codec, sched] = train(AllReduce(
                compressor=codec, schedule=sched, hierarchy="two_level"))
    for sched in ("barrier", "overlap"):
        out["engine_accum", sched] = train(AllReduce(schedule=sched, hierarchy="two_level"),
                                           accum_steps=2)
        out["engine_flat", sched] = train(AllReduce(chunk_size=1, schedule=sched), SPEC)
    out["engine_ef_scan"] = train(AllReduce(schedule="overlap", hierarchy="two_level",
                                            compressor="BF16CompressorEF"), accum_steps=2)
    out["engine_int8_dcn"] = train(AllReduce(hierarchy="two_level",
                                             dcn_compressor="Int8Compressor"))
    for sched in ("barrier", "overlap"):
        out["engine_sharded", sched] = train(AllReduce(
            hierarchy="two_level", sharded_update="sharded", schedule=sched))
    for ir in IR_PROGRAMS:
        out["engine_ir", ir] = train(AllReduce(schedule_ir=ir))
    out["engine_sync_schedule"] = train(AllReduce(hierarchy="two_level"),
                                        sync_schedule="overlap")

    seen, all_reduce = [], dist.all_reduce

    def recording(tensor, *args, **kwargs):
        if tensor.numel() > 1:
            seen.append(str(tensor.dtype))
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = recording
    try:
        for dtype in (torch.bfloat16, torch.float32):
            seen.clear()
            sess = autodist(AllReduce()).distribute(
                lambda p, b: torch.mean((b.to(p["w"].dtype) @ p["w"]) ** 2).float(),
                {"w": torch.ones(16, 4, dtype=dtype)}, optim.sgd(0.1))
            sess.run(np.ones((16, 16), np.float32))
            out["wire_dtypes", str(dtype)] = sorted(set(seen))
    finally:
        dist.all_reduce = all_reduce
    return out


def _builder(name, **kwargs):
    from autodist_tpu_torch import strategy

    if name in ("PartitionedPS", "UnevenPartitionedPS", "PartitionedAR",
                "RandomAxisPartitionAR"):
        kwargs.setdefault("max_shards", 8)
    if name == "RandomAxisPartitionAR":
        kwargs.setdefault("seed", 3)
    return getattr(strategy, name)(**kwargs)


class _Shapes:
    """Every tensor shape an op makes on this rank while it is open (the
    port's counterpart of walking the step's jaxpr)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        shapes = self.shapes = set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                import torch

                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        shapes.add(tuple(t.shape))
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _collectives():
    """A context that records ``(kind, ranks of its group)`` for every
    reduce-scatter, all-gather and all-reduce of more than one element."""
    import contextlib

    import torch.distributed as dist

    seen, originals = [], {}

    def wrap(kind, fn):
        def call(out_or_tensor, *args, **kwargs):
            group = kwargs.get("group")
            if out_or_tensor.numel() > 1:
                seen.append((kind, tuple(dist.get_process_group_ranks(group))
                             if group is not None else tuple(range(dist.get_world_size()))))
            return fn(out_or_tensor, *args, **kwargs)
        return call

    @contextlib.contextmanager
    def recording():
        for name, kind in (("reduce_scatter_tensor", "scatter"),
                           ("all_gather_into_tensor", "gather"), ("all_reduce", "psum")):
            originals[name] = getattr(dist, name)
            setattr(dist, name, wrap(kind, originals[name]))
        try:
            yield seen
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)

    return recording()


def partitioned_cases(inputs, autodist):
    """The synchronous PS family: the partitioned builders, sparse lookups,
    the row-split table, the PS over a subset of the data axes, NCF."""
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.ncf import NCFConfig
    from autodist_tpu_torch.models.train_lib import ncf_capture
    from autodist_tpu_torch.ops.sparse import embedding_lookup

    out = {}

    def tensors(arrays):
        return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    def result(sess, metrics, **extra):
        t = sess.transformer
        return dict(_session_result(sess, metrics), **extra,
                    plans={n: (p.placement.value, p.partition_axis, p.padded_dim, p.ps_axes)
                           for n, p in t.plans.items()},
                    stored={n: tuple(x.shape) for n, x in sess.state["params"].items()},
                    replication=sess.check_replication())

    def linear_loss(p, batch):
        return torch.mean((batch @ p["w"] + p["b"]) ** 2)

    for name in PART_BUILDERS:
        for opt in ("sgd", "adam"):
            make = optim.sgd(0.1) if opt == "sgd" else optim.adam(0.05)
            sess = autodist(_builder(name)).distribute(
                linear_loss, tensors(inputs["linear_params"]), make)
            for _ in range(3):
                metrics = sess.run(inputs["linear_batch"])
            t, opt_state = sess.transformer, sess.state["opt_state"].state
            out["linear", name, opt] = result(
                sess, metrics, roundtrip=all(
                    torch.equal(t.uncanonical_leaf(t.canonical_leaf(x, n), n), x.detach())
                    for n, x in sess.state["params"].items()),
                moments={n: {k: t.canonical_leaf(v, n).numpy() for k, v in opt_state[x].items()
                             if k.startswith("exp_avg")}
                         for n, x in sess.state["params"].items() if x in opt_state})

    def sparse_loss(p, batch):
        return torch.mean((embedding_lookup(p["emb"], batch["ids"]) @ p["proj"]) ** 2)

    for name in SPARSE_BUILDERS:
        sess = autodist(_builder(name)).distribute(
            sparse_loss, tensors({"emb": inputs["sparse_table"], "proj": inputs["sparse_proj"]}),
            optim.sgd(0.1), sparse_vars=["emb"])
        for _ in range(SPARSE_STEPS):
            metrics = sess.run({"ids": inputs["sparse_ids"]})
        out["sparse", name] = result(sess, metrics)

    sess = autodist(_builder("PartitionedPS")).distribute(
        sparse_loss, tensors(inputs["table_params"]), optim.sgd(0.1), sparse_vars=["emb"])
    with _Shapes() as step_shapes:
        sess.run({"ids": inputs["table_ids"]})
    metrics = sess.run({"ids": inputs["table_ids"]})
    state_shapes = {tuple(t.shape) for t in sess.state["params"].values()}
    state_shapes |= {tuple(v.shape) for st in sess.state["opt_state"].state.values()
                     for v in st.values() if isinstance(v, torch.Tensor)}
    out["table"] = result(
        sess, metrics, step_shapes=sorted(step_shapes.shapes), state_shapes=sorted(state_shapes),
        predict=sess.predict({"ids": inputs["table_ids_2d"]},
                             lambda p, b: embedding_lookup(p["emb"], b["ids"])).numpy())

    def mlp_loss(p, b):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
        return torch.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)

    hspec = dict(SPEC, mesh=HIER_MESH)
    for key, builder, kw in (
            ("PS", _builder("PS", ps_axes=SUBSET_AXES), {}),
            ("PartitionedPS", _builder("PartitionedPS", ps_axes=SUBSET_AXES, max_shards=4), {}),
            ("full", _builder("PS"), {}),
            ("clip", _builder("PS", ps_axes=SUBSET_AXES), {"clip_global_norm": SUBSET_CLIP})):
        sess = autodist(builder, hspec).distribute(
            mlp_loss, tensors(inputs["subset_params"]), optim.sgd(SUBSET_LR), **kw)
        with _collectives() as seen:
            metrics = sess.run(inputs["subset_batch"])
        out["subset", key] = result(
            sess, metrics, collectives=sorted(set(seen)),
            grad_norm=float(metrics["grad_norm"]) if "grad_norm" in metrics else None)

    def parallax_loss(p, b):
        return torch.mean((embedding_lookup(p["emb"], b["ids"]) @ p["w"])[..., 0] ** 2)

    sess = autodist(_builder("Parallax", ps_axes=SUBSET_AXES), hspec).distribute(
        parallax_loss, tensors(inputs["parallax_params"]), optim.sgd(SUBSET_LR),
        sparse_vars=["emb"])
    out["subset", "Parallax"] = result(sess, sess.run({"ids": inputs["parallax_ids"]}))
    try:
        autodist(_builder("PS", ps_axes=("nope",)), hspec).distribute(
            mlp_loss, tensors(inputs["subset_params"]), optim.sgd(SUBSET_LR))
    except ValueError as e:
        out["subset_unknown_axes"] = str(e)

    loss_fn, _, sparse = ncf_capture(NCFConfig(**NCF_TINY), device="cpu")
    for name in NCF_BUILDERS:
        sess = autodist(_builder(name)).distribute(
            loss_fn, tensors(inputs["ncf_params"]), optim.adam(NCF_LR), sparse_vars=sparse)
        losses = [sess.run(inputs["ncf_batch"])["loss"].item() for _ in range(NCF_STEPS)]
        out["ncf", name] = result(sess, {"loss": torch.tensor(losses[-1])}, losses=losses)
    return out


def stale_cases(inputs, world, autodist):
    """Bounded staleness: DIVERGENT copies, then the cross-process async PS."""
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization import async_service
    from autodist_tpu_torch.ops.sparse import embedding_lookup
    from autodist_tpu_torch.strategy import PS, Parallax

    out = {}

    def tensors(arrays):
        return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    def record(sess, metrics, **extra):
        return dict(_session_result(sess, metrics), **extra,
                    own={n: t.detach().numpy().copy() for n, t in sess.state["params"].items()},
                    plans={n: p.placement.value for n, p in sess.transformer.plans.items()},
                    replication=sess.check_replication())

    def mean_loss(p, b):
        return torch.mean(b @ p["w"])

    for key, s, steps in (("average", STALE_AVERAGE, 2), ("mid", STALE_MID, 1)):
        sess = autodist(PS(staleness=s)).distribute(mean_loss, {"w": torch.zeros(8)},
                                                     optim.sgd(0.1))
        for _ in range(steps):
            metrics = sess.run(STALE_BATCH)
        out[key] = record(sess, metrics)

    def linear_loss(p, batch):
        return torch.mean((batch @ p["w"] + p["b"]) ** 2)

    sess = autodist(PS(staleness=STALE_PERIOD_S)).distribute(
        linear_loss, tensors(inputs["linear_params"]), optim.adam(0.05))
    for _ in range(STALE_STEPS):
        metrics = sess.run(inputs["linear_batch"])
    t, opt_state = sess.transformer, sess.state["opt_state"].state
    moments = {(n, k): v.numpy().copy() for n, x in sess.state["params"].items()
               for k, v in opt_state[x].items() if k.startswith("exp_avg")}
    out["adam"] = record(sess, metrics, moments=moments, canonical_moments={
        (n, k): t.canonical_leaf(torch.from_numpy(v), n).numpy()
        for (n, k), v in moments.items()})

    sess = autodist(PS(staleness=STALE_PERIOD_S)).distribute(
        lambda p, b: torch.mean((b @ p["w"] + p["b"]) ** 2), tensors(inputs["clip_params"]),
        optim.sgd(0.5), clip_global_norm=CLIP_NORM)
    norms = [sess.run(inputs["clip_batch"])["grad_norm"].item() for _ in range(2)]
    out["clip"] = record(sess, {"loss": torch.tensor(0.0)}, norms=norms)

    def parallax_loss(p, b):
        return torch.mean((embedding_lookup(p["emb"], b["ids"]) @ p["w"])[..., 0] ** 2)

    sess = autodist(Parallax(staleness=1)).distribute(
        parallax_loss, tensors(inputs["parallax_params"]), optim.sgd(SUBSET_LR),
        sparse_vars=["emb"])
    for _ in range(2):
        metrics = sess.run({"ids": inputs["parallax_ids"]})
    out["parallax"] = record(sess, metrics)

    os.environ["AUTODIST_ASYNC_PS_ADDR"] = "127.0.0.1:0"   # the chief takes any port
    async_service.CONNECT_WINDOW_S = ASYNC_TIMEOUT
    try:
        sess = autodist(PS(sync=False, staleness=ASYNC_S)).distribute(
            lambda p, b: torch.mean((b @ p["w"] + p["b"]) ** 2),
            tensors(inputs["linear_params"]), optim.sgd(0.1))
    finally:
        del os.environ["AUTODIST_ASYNC_PS_ADDR"]
    assert isinstance(sess, async_service.AsyncPSClusterSession)
    rows = np.array_split(inputs["linear_batch"], world.size)[world.rank]
    sess.run([rows], ASYNC_STEPS, delay=ASYNC_DELAY if world.rank == world.size - 1 else 0.0,
             timeout=ASYNC_TIMEOUT)
    sess.wait_all(ASYNC_STEPS, timeout=ASYNC_TIMEOUT)
    out["cluster"] = {"stats": sess.stats(), "history": list(sess.history),
                      "is_chief": sess.is_chief, "workers": sess.num_workers,
                      "address": sess.address,
                      "params": {n: t.numpy() for n, t in sess.params().items()}}
    torch.distributed.barrier()   # every rank has pulled: the chief may stop serving
    sess.close()
    return out


def elastic_cases(workdir):
    """ElasticTrainer at R = 4 -> 2 under ``AllReduce(sharded_update=
    "sharded")`` (see ``ELASTIC_CASES``): each rank's history, whether it
    left, its epoch and replans, and for a survivor its new world's place
    and the final parameters; the checkpoint's manifest as saved."""
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint import manifest
    from autodist_tpu_torch.elastic import ElasticTrainer
    from autodist_tpu_torch.parallel.collectives import psum
    from autodist_tpu_torch.parallel.mesh import mesh_world
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    batch = elastic_batch()
    out = {}
    for key, (spec, chaos) in ELASTIC_CASES.items():
        d = os.path.join(workdir, "elastic", key)
        trainer = ElasticTrainer(
            ResourceSpec(resource_info=spec), AllReduce(sharded_update="sharded"), loss,
            {k: torch.from_numpy(v) for k, v in elastic_params().items()},
            optim.adam(ELASTIC_LR), checkpoint_dir=d, chaos=chaos, verify_restore=False,
            device="cpu")
        sess = trainer.fit(lambda step: batch, ELASTIC_STEPS)
        res = {"history": list(trainer.history), "left": trainer.left,
               "epoch": trainer.epoch, "replans": trainer.replans, "step": sess.step,
               "manifest": manifest.load_manifest(os.path.join(d, "elastic_ckpt"))}
        if not trainer.left:
            w = sess.transformer.world
            # the survivors' world on a two-axis mesh: its seq row is a
            # group of global ranks that may exclude rank 0
            seq = mesh_world(w, ("replica", "seq"), (1, w.size)).seq
            total = psum(torch.tensor([float(torch.distributed.get_rank())]), seq.group)
            res.update(num_replicas=sess.transformer.num_replicas, world=(w.rank, w.size),
                       members=tuple(w.ranks), chief=trainer._ad.resource_spec.chief,
                       seq=(seq.index, seq.size, float(total)),
                       params={n: t.numpy() for n, t in sess.params().items()})
        out[key] = res
    return out


def checkpoint_cases(inputs, world, autodist, workdir):
    """Checkpoints, canonical and update-space, written under
    ``workdir/ckpt`` (see the module's docstring)."""
    import torch

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint import manifest
    from autodist_tpu_torch.checkpoint.reshard import reshard_restore
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.models.gpt import GPT_TINY
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.parallel.mesh import ReplicaWorld
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runner import DistributedSession
    from autodist_tpu_torch.strategy import PS, AllReduce, PartitionedPS
    from autodist_tpu_torch.strategy.base import StrategyCompiler

    d = os.path.join(workdir, "ckpt")
    out = {"dir": d}

    def tensors(arrays):
        return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

    def numpy(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy().copy()
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(numpy(v) for v in tree)
        return tree

    def canonical(sess):
        t = sess.transformer
        return {"params": numpy(t.canonical_params(sess.state)),
                "opt": numpy(t.canonical_opt_state(sess.state))}

    def linear_loss(p, batch):
        return torch.mean((batch @ p["w"] + p["b"]) ** 2)

    def linear(builder, opt=None):
        return autodist(builder).distribute(linear_loss, tensors(inputs["linear_params"]),
                                            opt or optim.adam(CKPT_LR))

    gpt_loss, _, gpt_sparse = gpt_capture(dataclasses.replace(GPT_TINY, num_layers=GPT_LAYERS),
                                          GPT_SEQ, device="cpu")
    for key, (name, kwargs) in CKPT_BUILDERS.items():
        for model in ("linear", "gpt"):
            if model == "linear":
                sess, batch = linear(_builder(name, **kwargs)), inputs["linear_batch"]
            else:
                sess = autodist(_builder(name, **kwargs)).distribute(
                    gpt_loss, tensors(inputs["gpt_params"]), optim.adam(CKPT_GPT_LR),
                    sparse_vars=gpt_sparse, has_rng=True)
                batch = inputs["gpt_batch"]
            for _ in range(CKPT_STEPS):
                sess.run(batch)
            out["canonical", key, model] = dict(canonical(sess), manifest=manifest.build_manifest(
                sess.transformer, step=sess.step, layout=manifest.LAYOUT_CANONICAL))

    batch = inputs["linear_batch"]
    sess = linear(PartitionedPS(max_shards=8))
    for _ in range(3):
        sess.run(batch)
    out["single"] = {"path": Saver(sess).save(os.path.join(d, "single")),
                     "params": numpy(sess.params())}
    sess.run(batch)
    out["single"]["next"] = numpy(sess.params())

    sess = linear(PS())
    for _ in range(2):
        sess.run(batch)
    path = Saver(sess).save(os.path.join(d, "resume"))
    sess.run(batch)
    sess2 = linear(PS())
    Saver(sess2).restore(path)
    restored_step = sess2.step
    sess2.run(batch)
    out["resume"] = {"want": numpy(sess.params()), "got": numpy(sess2.params()),
                     "step": restored_step}

    sess = linear(PartitionedPS(max_shards=8))
    for _ in range(2):
        sess.run(batch)
    path = Saver(sess).save(os.path.join(d, "cross"))
    sess2 = linear(AllReduce())
    Saver(sess2).restore(path)
    sess2.run(batch)
    sess.run(batch)
    out["cross"] = {"want": numpy(sess.params()), "got": numpy(sess2.params())}

    def own(sess):
        return numpy({"params": sess.state["params"], "shards": sess.state["shards"],
                      "opt": sess.state["opt_state"].state_dict()["state"]})

    sess = linear(AllReduce(sharded_update="sharded"))
    for _ in range(3):
        sess.run(batch)
    path = Saver(sess).save_sharded(os.path.join(d, "same"))
    saved = own(sess)
    sess.run(batch)
    sess2 = linear(AllReduce(sharded_update="sharded"))
    Saver(sess2).restore(path)
    out["same"] = {"saved": saved, "restored": own(sess2), "step": sess2.step,
                   "path": path}
    sess2.run(batch)
    out["same"].update(want=numpy(sess.params()), got=numpy(sess2.params()))

    rbatch, rparams = reshard_inputs()

    def reshard_loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    for opt in RESHARD_OPTS:
        for update in RESHARD_UPDATES:
            for hierarchy in RESHARD_HIERARCHIES:
                two = hierarchy == "two_level"
                sess = autodist(AllReduce(sharded_update=update,
                                          hierarchy="two_level" if two else "auto"),
                                dict(SPEC, mesh=HIER_MESH) if two else SPEC).distribute(
                    reshard_loss, tensors(rparams), reshard_optimizer(opt))
                for _ in range(RESHARD_STEPS):
                    sess.run(rbatch)
                path = Saver(sess).save_sharded(os.path.join(d, f"m_{opt}_{update}_{hierarchy}"))
                out["matrix", opt, update, hierarchy] = dict(
                    canonical(sess), path=path, hierarchy=sess.transformer.sync_hierarchy,
                    manifest=manifest.load_manifest(path))

    sess = autodist(PS()).distribute(reshard_loss, tensors(rparams), optim.adam(CKPT_LR))
    for _ in range(2):
        sess.run(rbatch)
    out["ps_flat"] = {"path": Saver(sess).save_sharded(os.path.join(d, "ps_flat")),
                      "params": numpy(sess.params())}

    # the grow direction: rank 0 alone trains and saves at R = 1, the four
    # ranks reshard it onto R = 4
    grow = os.path.join(d, "grow")
    if world.rank == 0:
        spec1 = ResourceSpec(resource_info={"nodes": [{"address": "localhost", "cpus": [0],
                                                        "chief": True}]})
        item = ModelItem(reshard_loss, tensors(rparams), optim.adam(CKPT_LR))
        builder = AllReduce(sharded_update="sharded")
        strategy = StrategyCompiler(item, spec1).compile(builder.build(item, spec1))
        one = DistributedSession(GraphTransformer(strategy, item, "cpu",
                                                  ReplicaWorld(rank=0, size=1)))
        for _ in range(2):
            one.run(rbatch)
        Saver(one).save_sharded(grow)
        out["grow_saved"] = canonical(one)
    torch.distributed.barrier()
    sess = autodist(AllReduce(sharded_update="sharded")).distribute(
        reshard_loss, tensors(rparams), optim.adam(CKPT_LR))
    reshard_restore(sess, grow, verify=False)
    out["grow"] = dict(canonical(sess), step=sess.step)
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
    # the results are written and every collective has returned: leave
    # without the interpreter's and the process group's teardown (~4 s)
    sys.stdout.flush()
    os._exit(0)
