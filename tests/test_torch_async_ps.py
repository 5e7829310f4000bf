"""The port's asynchronous PS runtimes, and the session's signatures, against
the JAX package.

- ``TokenBarrier`` runs ``tests/test_async_ps.py::test_token_barrier_unit``
  (the port's and the JAX package's barrier, the same script).
- One worker of ``AsyncPSSession`` is a sequential run: 4 sgd steps of a
  tiny linear model give JAX's ``AsyncPSSession``'s parameters within
  1e-6.  Staleness 0 is lockstep (``max_lead_seen == 0``).  The c9 rig (a
  fast and a slow worker, staleness 2): the lead stays within the bound
  and some pushes are stale.  Sixteen workers under a microsecond switch
  interval lose no push.
- Through ``distribute``: ``PS(sync=False, staleness=2)``,
  ``Parallax(sync=False)`` and ``PartitionedPS(sync=False)`` give the
  engine session, whose ``.plans`` equal JAX's; every worker pushes every
  step.  The options only the synchronous engine implements,
  ``eval_fn`` and ``mutable_state`` raise.  ``has_rng`` streams do not
  replay across ``run`` calls.
- The service over TCP on an ephemeral port: a local and a remote worker,
  the lead bound, ``close`` ending every thread; ``_run_authkey`` gives
  JAX's bytes.
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``, the ``stale``
  entry's ``cluster``): the cross-process session, rank 0 serving on an
  ephemeral port handed over through the world: ``version == 4 x
  steps``, the lead within the bound, and every rank's ``params()`` equal
  to the chief's after ``wait_all``.
- The signatures: every parameter of the JAX ``AutoDist.distribute`` and
  of each public method of its ``DistributedSession`` is accepted by the
  port's, and an option of a later slice raises ``NotImplementedError``
  naming its ROADMAP item; the checkpoint options (``fit``'s
  ``checkpoint_path`` and ``preempt_checkpoint_dir``, ``run_steps``'s)
  run.

A fixture holds every test to leave no thread behind (the workers, the
servers' threads); every wait has a deadline of at most 10 s.
"""
import inspect
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import _strategy_requests_async as j_requests_async
from autodist_tpu.kernel.synchronization import async_ps as jasync
from autodist_tpu.kernel.synchronization import async_service as jservice
from autodist_tpu.ops.sparse import embedding_lookup as jembedding_lookup
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.runner import DistributedSession as JDistributedSession
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.autodist import AutoDist, _strategy_requests_async
from autodist_tpu_torch.kernel.synchronization import async_ps as tasync
from autodist_tpu_torch.kernel.synchronization import async_service as tservice
from autodist_tpu_torch.ops.sparse import embedding_lookup
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import DistributedSession

DEADLINE_S = 10.0   # every wait of a test
RUN_TIMEOUT_S = 5.0  # a run's own deadline: with the 5 s quiesce grace, 10 s in all
CPU2 = {"nodes": [{"address": "localhost", "cpus": [0, 1], "chief": True}]}


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


def _p0():
    return {"w": np.random.RandomState(0).randn(6).astype(np.float32)}


def _streams(workers, n=4):
    r = np.random.RandomState(1)
    return [[r.randn(8, 6).astype(np.float32) for _ in range(n)] for _ in range(workers)]


def _tloss(p, b):
    return torch.mean((b @ p["w"]) ** 2)


def _session(staleness, workers=2, **kw):
    return tasync.AsyncPSSession(_tloss, {k: torch.from_numpy(v) for k, v in _p0().items()},
                                 optim.sgd(0.02), staleness=staleness,
                                 devices=["cpu"] * workers, **kw)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_token_barrier_unit(impl):
    """``tests/test_async_ps.py::test_token_barrier_unit`` on either barrier."""
    b = (jasync if impl == "jax" else tasync).TokenBarrier(3, staleness=1)
    b.advance(0)
    b.wait_turn(0)   # lead 1 == s: may start, recorded
    assert b.max_lead_seen == 1 and b.steps == [1, 0, 0]
    t0 = time.monotonic()
    b.wait_turn(1)   # a laggard passes at once
    assert time.monotonic() - t0 < 0.05
    assert b.probe(1) and not (b.advance(0) or b.probe(0))   # steps [2, 0, 0]
    passed = threading.Event()
    t = threading.Thread(target=lambda: (b.wait_turn(0), passed.set()), daemon=True)
    t.start()
    time.sleep(0.1)
    assert not passed.is_set()   # lead 2 > s = 1
    b.advance(1)
    b.advance(2)
    t.join(DEADLINE_S)
    assert passed.is_set() and b.steps == [2, 1, 1] and b.max_lead_seen == 1


def test_one_worker_matches_jax_async_session():
    """One worker pulls, steps and pushes in turn: async SGD is plain SGD."""
    streams = _streams(1)
    jsess = jasync.AsyncPSSession(lambda p, b: jnp.mean((b @ p["w"]) ** 2),
                                  {k: jnp.asarray(v) for k, v in _p0().items()},
                                  optax.sgd(0.02), staleness=0, num_workers=1)
    want = jsess.run(streams, 4, timeout=RUN_TIMEOUT_S)
    sess = _session(0, workers=1)
    got = sess.run([[torch.from_numpy(b) for b in streams[0]]], 4, timeout=RUN_TIMEOUT_S)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6, rtol=0)
    assert (sess.version, sess.stale_pushes) == (jsess.version, jsess.stale_pushes) == (4, 0)
    jl = [loss for _, _, loss in jsess.history]
    np.testing.assert_allclose([loss for _, _, loss in sess.history], jl, rtol=1e-6)
    assert [t["worker"] for t in sess.timings] == [0] * 4


def test_staleness_zero_is_lockstep():
    sess = _session(0)
    sess.run(_streams(2), 5, delays=[0.0, 0.02], timeout=RUN_TIMEOUT_S)
    assert sess.barrier.max_lead_seen == 0 and sess.version == 10
    assert sess.barrier.steps == [5, 5]


def test_c9_fast_chief_slow_worker_progress():
    """The fast worker runs ahead by at most the bound while the slow one
    lags, and pushes computed against stale parameters land."""
    s, steps = 2, 8
    sess = _session(s)
    sess.run(_streams(2), steps, delays=[0.0, 0.02], timeout=RUN_TIMEOUT_S)
    assert sess.barrier.steps == [steps, steps] and sess.version == 2 * steps
    assert 1 <= sess.barrier.max_lead_seen <= s
    assert sess.stale_pushes > 0
    losses = [loss for _, _, loss in sorted(sess.history, key=lambda h: h[1])]
    assert losses[-1] < losses[0]


def test_many_workers_lose_no_push():
    """More worker threads than cores, the interpreter switching threads
    every microsecond: the loss ``mean(b @ w)`` has a gradient that does
    not depend on ``w``, so the final parameters are the start minus the
    rate times every push's gradient, in any order; a lost update breaks
    it, as it would the version and the step counts."""
    workers, steps, lr = 16, 5, 0.01
    r = np.random.RandomState(2)
    streams = [[r.randn(4, 6).astype(np.float32) for _ in range(steps)]
               for _ in range(workers)]
    sess = tasync.AsyncPSSession(lambda p, b: torch.mean(b @ p["w"]), {"w": torch.zeros(6)},
                                 optim.sgd(lr), staleness=2, devices=["cpu"] * workers)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sess.run(streams, steps, timeout=RUN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert sess.version == workers * steps and sess.barrier.steps == [steps] * workers
    assert len(sess.history) == len(sess.timings) == workers * steps
    assert sorted(v for _, v, _ in sess.history) == list(range(1, workers * steps + 1))
    want = -lr * sum(b.mean(0) for stream in streams for b in stream)
    np.testing.assert_allclose(sess.params()["w"].numpy(), want, atol=1e-5, rtol=0)
    assert sess.barrier.max_lead_seen <= 2


def _mixed_model():
    """``tests/test_async_ps.py``'s Parallax-style model: a sparse table and
    a dense projection."""
    r = np.random.RandomState(3)
    params = {"emb": (r.randn(40, 6) * 0.3).astype(np.float32),
              "w": (r.randn(6, 1) * 0.3).astype(np.float32)}

    def jloss(p, b):
        return jnp.mean((jembedding_lookup(p["emb"], b["ids"]) @ p["w"])[..., 0] ** 2)

    def tloss(p, b):
        return torch.mean((embedding_lookup(p["emb"], b["ids"]) @ p["w"])[..., 0] ** 2)

    return params, jloss, tloss


def _mixed_batches(workers, n=4):
    r = np.random.RandomState(4)
    return [[{"ids": r.randint(0, 40, (8,))} for _ in range(n)] for _ in range(workers)]


def _distribute(builder, spec=CPU2, **kw):
    params, _, tloss = _mixed_model()
    return AutoDist(resource_spec=ResourceSpec(resource_info=spec), strategy_builder=builder,
                    device="cpu").distribute(
        tloss, {k: torch.from_numpy(v) for k, v in params.items()}, optim.sgd(0.02),
        sparse_vars=["emb"], **kw)


ASYNC_BUILDERS = {
    "PS": lambda m: m.PS(sync=False, staleness=2),
    "Parallax": lambda m: m.Parallax(sync=False),
    "PartitionedPS": lambda m: m.PartitionedPS(sync=False, max_shards=8),
}


@pytest.mark.parametrize("builder", sorted(ASYNC_BUILDERS))
def test_async_selected_through_distribute(builder):
    """An async PS node (on the node, or on a partition's ``part_config``)
    selects the engine session, one worker a spec device; its plans are
    JAX's, and every worker pushes every step."""
    params, jloss, _ = _mixed_model()
    jsess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(2),
                      strategy_builder=ASYNC_BUILDERS[builder](jstrategy)).distribute(
        jloss, {k: jnp.asarray(v) for k, v in params.items()}, optax.sgd(0.02),
        sparse_vars=["emb"])
    sess = _distribute(ASYNC_BUILDERS[builder](tstrategy))
    assert isinstance(sess, tasync.AsyncPSEngineSession)
    assert j_requests_async(jsess.strategy.proto) and _strategy_requests_async(
        sess.strategy.proto)
    assert sess.staleness == jsess.staleness and sess.num_workers == 2
    assert sorted(sess.plans) == sorted(jsess.plans)
    for n, jp in jsess.plans.items():
        tp = sess.plans[n]
        assert (tp.placement.value, tp.sync.value, tp.ps_sync, tp.staleness, tp.sparse) == (
            jp.placement.value, jp.sync.value, jp.ps_sync, jp.staleness, jp.sparse), n
    before = sess.params()["w"].clone()
    steps = 3
    sess.run(_mixed_batches(2), steps, delays=[0.0, 0.02], timeout=RUN_TIMEOUT_S)
    assert sess.version == steps * sess.num_workers
    assert sess.barrier.max_lead_seen <= sess.staleness
    assert not torch.equal(sess.params()["w"], before)
    assert all(np.isfinite(loss) for _, _, loss in sess.history)
    sess.close()


@pytest.mark.parametrize("option,value", [
    ("batch_mask", True), ("rng", 1), ("accum_steps", 2), ("clip_global_norm", 1.0),
    ("sync_schedule", "overlap"), ("eval_fn", lambda p, b: b), ("mutable_state", "state")])
def test_async_runtime_rejects_unsupported_options(option, value):
    if option == "mutable_state":
        value = {"bn": torch.zeros(3)}
    with pytest.raises(NotImplementedError, match=option):
        _distribute(tstrategy.PS(sync=False), **{option: value})


def test_sync_strategy_still_uses_the_engine():
    assert isinstance(_distribute(tstrategy.Parallax(sync=True, staleness=1),
                                  spec={"nodes": [{"address": "localhost", "cpus": [0],
                                                   "chief": True}]}), DistributedSession)


def test_has_rng_streams_do_not_replay_across_runs():
    """Each (worker, lifetime step) draws its own generator: a second ``run``
    on the same batches draws new noise, and the aux reaches ``aux_history``."""
    params = {"w": torch.from_numpy(np.random.RandomState(5).randn(6).astype(np.float32))}

    def loss(p, b, generator):
        noise = torch.randn(b.shape, generator=generator)
        pred = (b + 0.01 * noise) @ p["w"]
        return torch.mean(pred ** 2), noise.sum()

    sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU2),
                    strategy_builder=tstrategy.PS(sync=False, staleness=1),
                    device="cpu").distribute(loss, params, optim.sgd(0.02), has_rng=True,
                                             has_aux=True)
    streams = [[torch.from_numpy(b) for b in s] for s in _streams(2)]
    sess.run(streams, 2, timeout=RUN_TIMEOUT_S)
    first = {w: sorted(float(a) for ww, _, a in sess.aux_history if ww == w) for w in (0, 1)}
    sess.run(streams, 2, timeout=RUN_TIMEOUT_S)
    second = {w: sorted(float(a) for ww, _, a in sess.aux_history[4:] if ww == w)
              for w in (0, 1)}
    assert len(sess.aux_history) == 8 and sess._inner._rng_step_base == 4
    for w in (0, 1):
        assert not set(first[w]) & set(second[w]), w
    assert not set(first[0]) & set(first[1])   # the workers' streams differ too


def test_async_service_tcp_roundtrip():
    """The service over a real localhost socket on an ephemeral port: worker
    0 drives it in process (the chief's path), worker 1 through the TCP
    client; the lead holds and ``close`` ends every serving thread."""
    service = tservice.AsyncPSService({k: torch.from_numpy(v) for k, v in _p0().items()},
                                      optim.sgd(0.02), staleness=1, num_workers=2)
    server, address = tservice.serve_async_ps(service, ("127.0.0.1", 0))
    assert address[1] != 0
    client = tservice.connect_async_ps(address)
    streams = [[torch.from_numpy(b) for b in s] for s in _streams(2)]
    results, errors = {}, []

    def drive(w):
        try:
            results[w] = tservice.run_async_worker(
                client if w else service, _tloss, w, streams[w], 6, delay=0.02 * w,
                device="cpu", timeout=RUN_TIMEOUT_S)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(w,), daemon=True) for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    stats = client.stats()
    client.close()
    server.close()
    assert not errors and not any(t.is_alive() for t in threads)
    assert stats["version"] == 12 and stats["steps"] == [6, 6]
    assert stats["max_lead_seen"] <= 1
    assert all(np.isfinite(loss) for _, loss in results[0] + results[1])
    with pytest.raises(OSError):   # closed: nothing listens any more
        tservice.connect_async_ps(address, retries=1)


def test_run_authkey_matches_jax():
    for run_id in ("20261018120000-123-1", "x"):
        assert tservice._run_authkey(run_id) == jservice._run_authkey(run_id)
    token = bytes(range(32))
    assert tservice.resolve_authkey("x", token.hex()) == token
    assert tservice.resolve_authkey("x", token) == token


# -- the 4-rank gloo world ---------------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

def test_cluster_session_over_four_ranks():
    """Every rank drives one worker; rank 0 serves.  Each worker pushed
    every step, the lead held, and after ``wait_all`` every rank pulls
    the chief's parameters."""
    _, results = ranks.world(_jax_gpt_params)
    cases = [res["stale"]["cluster"] for res in results]
    chief = cases[0]
    assert chief["is_chief"] and not any(c["is_chief"] for c in cases[1:])
    assert len({c["address"] for c in cases}) == 1 and not chief["address"].endswith(":0")
    for c in cases:
        assert c["workers"] == ranks.WORLD
        assert c["stats"]["version"] == ranks.WORLD * ranks.ASYNC_STEPS
        assert c["stats"]["steps"] == [ranks.ASYNC_STEPS] * ranks.WORLD
        assert c["stats"]["max_lead_seen"] <= ranks.ASYNC_S
        assert len(c["history"]) == ranks.ASYNC_STEPS
        assert all(np.isfinite(loss) for _, _, loss in c["history"])
        for n, v in chief["params"].items():
            np.testing.assert_array_equal(c["params"][n], v, err_msg=n)
    versions = sorted(v for c in cases for _, v, _ in c["history"])
    assert versions == list(range(1, ranks.WORLD * ranks.ASYNC_STEPS + 1))


# -- the session's signatures against the JAX package's ---------------------------

def _public_methods(cls):
    return sorted(n for n, f in inspect.getmembers(cls) if not n.startswith("_")
                  and callable(f) and not isinstance(inspect.getattr_static(cls, n), property))


def _accepts(port_fn, name):
    params = inspect.signature(port_fn).parameters
    return name in params or any(p.kind == p.VAR_KEYWORD for p in params.values())


@pytest.mark.parametrize("method", ["distribute"] + _public_methods(JDistributedSession))
def test_signatures_accept_every_jax_parameter(method):
    jcls, tcls = ((JAutoDist, AutoDist) if method == "distribute"
                  else (JDistributedSession, DistributedSession))
    assert hasattr(tcls, method), method
    jparams = inspect.signature(getattr(jcls, method)).parameters
    port = getattr(tcls, method)
    missing = [n for n in jparams if not _accepts(port, n)]
    assert not missing, f"{method}: the port takes no {missing}"


LATER = {   # (method, keyword arguments) -> the ROADMAP Queue A item it raises with
    ("run", "trace_dir"): 10, ("verify", None): 11,
}
# the Queue A item 7 options, which run since the checkpoints were ported
CHECKPOINTED = (("run_steps", "preempt_checkpoint_dir"), ("fit", "checkpoint_path"),
                ("fit", "preempt_checkpoint_dir"))


def test_later_session_options_raise_naming_their_item(tmp_path):
    sess = AutoDist(resource_spec=ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "cpus": [0], "chief": True}]}), device="cpu").distribute(
        _tloss, {"w": torch.ones(6)}, optim.sgd(0.1), donate=False)
    batch = np.ones((4, 6), np.float32)
    for (method, option), item in LATER.items():
        kwargs = {option: "dir"} if option else {}
        args = (batch,)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            getattr(sess, method)(*args, **kwargs)
    assert sess.step == 0
    for i, (method, option) in enumerate(CHECKPOINTED):
        args = ((lambda s: batch), i + 1) if method == "fit" else ([batch],)
        path = str(tmp_path / option)
        assert getattr(sess, method)(*args, **{option: path})["step"] == i + 1
        assert not sess.preempted
    assert os.path.isdir(tmp_path / "checkpoint_path")   # fit saved at its end
    assert sess.run_steps([batch], preempt_checkpoint_dir=None)["step"] == 4
    assert sess.run(batch, trace_dir=None)["step"] == 5
    assert sess.memory_stats() == {"cpu": None} and sess.finalize_telemetry() is None
    for option, item in (("data_axes", 9), ("batch_spec", 9), ("param_specs", 9),
                         ("verify", 11)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            AutoDist(resource_spec=ResourceSpec(resource_info=CPU2), device="cpu").distribute(
                _tloss, {"w": torch.ones(6)}, optim.sgd(0.1), **{option: True})
