"""The 4-rank gloo world that ``tests/test_torch_compressed_sync.py`` and
``tests/test_torch_ring_attention.py`` hold against the JAX package: its
rank code and its launcher.  It imports no JAX: the port has to run where
JAX is absent.

:func:`world` starts one process per rank, once per test process (both
test modules share the world and its results)::

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
- ``gpt``: 3 GPT-tiny adamw steps under ``Int8Compressor`` and
  ``EquarxInt8Compressor``;
- ``seq_parallel`` (one dict): ring attention on the seq rows of the
  meshes ``{replica: 2, seq: 2}`` and ``{replica: 1, seq: 4}`` under both
  impls, with the gradients of ``sum(sin(out))``; Ulysses attention on the
  first, causal and not, and its indivisible-heads error; 3 GPT-tiny sgd
  steps on ``{replica: 2, seq: 2}``, on the flat 4 replicas and on the
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
  bf16 and f32 gradients (``tests/test_wire_dtype.py``).

Every ``AutoDist`` case records its strategy id and final parameters, so
the test can check that the ranks agree.
"""
import atexit
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

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


_WORLD = {}


def world(jax_gpt_params):
    """Start the 4 ranks once per process and return ``(inputs, results)``,
    the per-rank results in rank order; later calls return the same.
    ``jax_gpt_params()`` gives the flax GPT-tiny tree; it is called only
    when the ranks start."""
    if "results" in _WORLD:
        return _WORLD["inputs"], _WORLD["results"]
    workdir = tempfile.mkdtemp(prefix="gloo4-")
    atexit.register(shutil.rmtree, workdir, ignore_errors=True)
    inputs = make_inputs(jax_gpt_params())
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   AUTODIST_INIT_METHOD=f"file://{os.path.join(workdir, 'store')}",
                   AUTODIST_IS_TESTING="1", PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    results = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    assert [res["rank"] for res in results] == list(range(WORLD))
    assert all(res["world"] == WORLD for res in results)
    _WORLD.update(inputs=inputs, results=results)
    return inputs, results


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
        loss_fn, _, sparse = gpt_capture(GPT_TINY, GPT_SEQ, device="cpu")
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

    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


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
        loss_fn, _, sparse = gpt_capture(GPT_TINY, GPT_SEQ, device="cpu")
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


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
