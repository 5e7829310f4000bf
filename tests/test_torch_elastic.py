"""The port's elastic training (``autodist_tpu_torch/elastic.py``,
``cluster.py``, ``ResourceSpec`` SSH specs and ``shrink``, ``AutoDist.rebind``
and ``launch``, ``telemetry/{events,health}.py``) against the JAX package.
The oracles are ``tests/test_elastic.py``, ``tests/test_cluster.py`` and the
SSH parts of ``tests/test_resource_spec.py``.

- Pure Python, both packages on the same inputs, equal outputs: launch
  retry, its exhaustion's error and its exponential backoff (a fake launch
  ``Cluster`` whose commands are local shells); the TERM -> KILL escalation
  of ``terminate`` and the ``on_worker_exit`` claim; the epoch,
  ``AUTODIST_EPOCH`` and ``successor_chief``; ``shrink`` (the five cases of
  ``test_elastic.py`` and the ssh groups carried), field by field;
  ``parse_chaos``; ``HealthMonitor.observe`` on one seeded loss stream with
  a spike and a NaN; the event log; SSH specs; the ``worker_env`` keys that
  JAX sets (the port's ``torch.distributed`` keys checked apart: one
  process a GPU); ``remote_command`` for a remote node.
- R = 1 in this process, the linear model of ``test_elastic.py``: the
  history under ``kill_worker@2`` and ``delay@1:0.01`` is bitwise an
  uninterrupted run's; the ``max_replans=0`` guard; ``preempt@2``
  (SIGTERM, the manifest, a fresh trainer's resume equal to an
  uninterrupted run at atol 0); ``nan@2`` fires ``on_anomaly`` once.  An
  out-of-range token id reads a NaN row in the port's GPT as in JAX's
  (``jnp.take``'s fill), which the ``nan`` drill relies on for token
  batches.  ``launch`` on one process is ``distribute``; its async path
  hands the bound address and a fresh authkey to the workers.
- R = 4 -> 2 in the 4-rank gloo world's ``elastic`` entry
  (``tests/torch_gloo_ranks.py``): a node of 4 CPUs losing its upper half,
  and two nodes of 2 losing the chief's (the survivors hold global ranks
  2-3), each held against JAX's ``ElasticTrainer`` on 4 of the conftest's
  virtual CPU devices with the same specs (``chips``, as JAX's mesh takes
  every CPU device of a ``cpus`` spec) and ``verify_restore=False``.  The
  tolerance is 1e-5: the losses relative, the parameters absolute.  The
  two packages' f32 products already differ at R = 1 on this model (step
  1's loss 14.95 by 2.9e-6, step 5's by 3.4e-5 under adam), so the 1e-6 of
  the linear checkpoint tests cannot hold here.

The signatures of ``ElasticTrainer``, ``Cluster``, ``ResourceSpec.shrink``,
``AutoDist.rebind`` and ``AutoDist.launch`` are held in
``tests/test_torch_async_ps.py``, with the other signatures.
"""
import math
import os
import signal
import subprocess
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu import cluster as jcluster
from autodist_tpu import elastic as jelastic
from autodist_tpu import strategy as jstrategy
from autodist_tpu.ops.sparse import embedding_lookup as jembedding_lookup
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.telemetry import events as jevents
from autodist_tpu.telemetry import health as jhealth
from autodist_tpu_torch import cluster as tcluster
from autodist_tpu_torch import elastic as telastic
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.checkpoint import manifest
from autodist_tpu_torch.const import RANK_ENV, WORKER_ENV
from autodist_tpu_torch.models.gpt import take_rows
from autodist_tpu_torch.resource_spec import ResourceSpec, ResourceSpecError
from autodist_tpu_torch.telemetry import events as tevents
from autodist_tpu_torch.telemetry import health as thealth

WORLD_TOL = 1e-5   # see the module's docstring
ranks.prestart(oracle.world_gpt_params)   # the ranks run while the tests before them do


def _jax_info(info):
    """A spec for the JAX package: ``gpus`` and ``cpus`` as ``chips``."""
    nodes = []
    for n in info["nodes"]:
        n = dict(n)
        for key in ("gpus", "cpus"):
            if key in n:
                n["chips"] = n.pop(key)
        nodes.append(n)
    return dict(info, nodes=nodes)


def _specs(info):
    return ResourceSpec(resource_info=info), JResourceSpec(resource_info=_jax_info(info))


NODE2 = {"nodes": [{"address": "10.0.0.1", "gpus": [0, 1, 2, 3], "chief": True,
                    "network_bandwidth": 100},
                   {"address": "10.0.0.2", "gpus": [0, 1, 2, 3], "network_bandwidth": 100}]}
NODE3 = {"nodes": [{"address": "10.0.0.1", "gpus": [0, 1], "chief": True,
                    "network_bandwidth": 100},
                   {"address": "10.0.0.2", "gpus": [0, 1], "network_bandwidth": 100},
                   {"address": "10.0.0.3", "gpus": [0, 1], "network_bandwidth": 100}]}
# one GPU a node: the port's processes (one a GPU) are JAX's (one a host)
ONE_EACH = {"nodes": [{"address": "10.0.0.1", "gpus": [0], "chief": True},
                      {"address": "10.0.0.2", "gpus": [0]}]}
SSH = {"nodes": [{"address": "10.0.0.2", "gpus": [0], "ssh_config": "conf"},
                 {"address": "10.0.0.1", "gpus": [0], "chief": True, "ssh_config": "conf"}],
       "ssh": {"conf": {"username": "root", "key_file": "/k", "port": 2222,
                        "python_venv": "/venv", "shared_envs": {"LD_LIBRARY_PATH": "/lib"}}}}


# -- cluster: launch retry, backoff, terminate, the exit claim ----------------------------

def _fake(base):
    class Fake(base):
        """A Cluster whose 'ssh' is a local shell: the first ``fail_first``
        attempts exit 7 at once, later ones sleep (a healthy worker)."""

        def __init__(self, spec, fail_first=0):
            super().__init__(spec)
            self.fail_first = fail_first
            self.attempts = 0

        def remote_command(self, worker_address, argv, env, connect_timeout_s=10):
            self.attempts += 1
            if self.attempts <= self.fail_first:
                return ["/bin/sh", "-c", "exit 7"]
            return ["/bin/sh", "-c", "sleep 30"]

    return Fake


def _both(info, fail_first):
    tspec, jspec = _specs(info)
    return (_fake(tcluster.Cluster)(tspec, fail_first),
            _fake(jcluster.Cluster)(jspec, fail_first))


def test_launch_retry_recovers():
    for c in _both(ONE_EACH, fail_first=2):
        c.launch_workers("s1", argv=["x.py"], max_attempts=3, backoff_s=0.01, probe_s=0.2)
        assert c.attempts == 3   # two failures, one success
        assert [a for a, _ in c._procs] == ["10.0.0.2"]
        c.terminate(grace_s=1.0)
        assert not c._procs and not c._monitor_threads


def test_launch_retry_exhausts_with_clear_error():
    messages = []
    for c in _both(ONE_EACH, fail_first=99):
        with pytest.raises(Exception) as e:
            c.launch_workers("s1", argv=["x.py"], max_attempts=2, backoff_s=0.01,
                             probe_s=0.2)
        assert type(e.value).__name__ == "WorkerLaunchError"
        messages.append(str(e.value).split("; check")[0])
    assert messages[0] == messages[1]
    assert "10.0.0.2" in messages[0] and "2 attempt(s)" in messages[0]


def test_launch_backoff_is_exponential(monkeypatch):
    sleeps = []
    real_sleep = time.sleep
    monkeypatch.setattr(time, "sleep", lambda s: (sleeps.append(s), real_sleep(min(s, 0.01)))[1])
    backoffs = []
    for c in _both(ONE_EACH, fail_first=99):
        sleeps.clear()
        with pytest.raises(Exception, match="3 attempt"):
            c.launch_workers("s1", argv=["x.py"], max_attempts=3, backoff_s=0.5, probe_s=0.05)
        backoffs.append([s for s in sleeps if s >= 0.5])
    assert backoffs == [[0.5, 1.0], [0.5, 1.0]]   # doubling, no sleep after the last try


def _terminate_case(cls, spec):
    c = cls(spec)
    proc = subprocess.Popen(["/bin/sh", "-c", "trap '' TERM; sleep 60"],
                            start_new_session=True)
    c._procs.append(("10.0.0.2", proc))
    t = threading.Thread(target=c._monitor, args=("10.0.0.2", proc), daemon=True)
    t.start()
    c._monitor_threads.append(t)
    time.sleep(0.2)   # let the trap install
    t0 = time.monotonic()
    c.terminate(grace_s=0.5)
    return (proc.poll() is not None, proc.returncode, time.monotonic() - t0 < 10,
            c._procs, c._monitor_threads, t.is_alive())


def test_terminate_escalates_and_reaps():
    """A TERM-immune worker is KILLed after the grace period, reaped, and
    its monitor joined, in both packages."""
    tspec, jspec = _specs(NODE2)
    got, want = _terminate_case(tcluster.Cluster, tspec), _terminate_case(jcluster.Cluster, jspec)
    assert got == want == (True, -signal.SIGKILL, True, [], [], False)


def test_worker_exit_callback_claims_failure():
    seen = []
    for cls, spec in zip((tcluster.Cluster, jcluster.Cluster), _specs(NODE2)):
        c = cls(spec)
        c.on_worker_exit = lambda addr, code: (seen.append((cls.__module__, addr, code)), True)[1]
        proc = subprocess.Popen(["/bin/sh", "-c", "exit 3"])
        proc.wait()
        c._monitor("10.0.0.2", proc)   # would os._exit(1) without the claim
    assert [s[1:] for s in seen] == [("10.0.0.2", 3)] * 2


# -- membership epochs and the chief's successor ------------------------------------------

def test_epoch_env_and_successor_chief(monkeypatch):
    out = []
    for cls, spec in zip((tcluster.Cluster, jcluster.Cluster), _specs(NODE3)):
        c = cls(spec)
        row = [c.epoch, c.worker_env("10.0.0.2", "s1")["AUTODIST_EPOCH"], c.advance_epoch(),
               c.worker_env("10.0.0.2", "s1")["AUTODIST_EPOCH"], c.successor_chief(),
               c.successor_chief(down=["10.0.0.1"]),
               c.successor_chief(down=["10.0.0.1", "10.0.0.2"])]
        with pytest.raises(RuntimeError) as e:
            c.successor_chief(down=["10.0.0.1", "10.0.0.2", "10.0.0.3"])
        row.append(str(e.value))
        monkeypatch.setenv("AUTODIST_EPOCH", "4")
        row.append(cls(spec).epoch)
        monkeypatch.delenv("AUTODIST_EPOCH")
        out.append(row)
    assert out[0] == out[1]
    assert out[0][:7] == [0, "0", 1, "1", "10.0.0.1", "10.0.0.2", "10.0.0.3"]
    assert out[0][-1] == 4


# -- ResourceSpec: SSH specs and shrink ----------------------------------------------------

def _fields(spec):
    """A spec field by field (device types aside: JAX names its chips TPU)."""
    return {"nodes": spec.node_addresses, "chief": spec.chief,
            "devices": {a: [d.device_index for d in spec.node_devices(a)]
                        for a in spec.node_addresses},
            "accelerators": spec.num_accelerators, "cpus": spec.num_cpus,
            "bandwidth": {a: spec.network_bandwidth(a) for a in spec.node_addresses},
            "explicit_bandwidths": spec.explicit_bandwidths,
            "ssh": {a: spec.ssh_config(a) for a in spec.node_addresses},
            "ssh_map": spec.ssh_config_map, "mesh": spec.mesh_request,
            "single": spec.is_single_node}


SHRINK_CASES = {   # test_elastic.py:177-214, and the ssh groups carried
    "drop_node": (NODE3, {"drop_addresses": ["10.0.0.2"]}),
    "chief_failover": (NODE3, {"drop_addresses": ["10.0.0.1"]}),
    "keep_chips": ({"nodes": [{"address": "localhost", "gpus": list(range(8))}]},
                   {"keep_chips": {"localhost": [0, 1, 2, 3]}}),
    "drops_mesh_request": ({"nodes": [{"address": "localhost", "gpus": list(range(8))}],
                            "mesh": {"replica_dcn": 2, "replica_ici": 4}},
                           {"keep_chips": {"localhost": [0, 1, 2, 3]}}),
    "ssh_carried": (SSH, {"drop_addresses": ["10.0.0.1"]}),
}


@pytest.mark.parametrize("case", sorted(SHRINK_CASES))
def test_shrink_matches_jax(case):
    info, kwargs = SHRINK_CASES[case]
    tspec, jspec = _specs(info)
    got, want = _fields(tspec.shrink(**kwargs)), _fields(jspec.shrink(**kwargs))
    assert got == want
    if case == "chief_failover":
        assert got["chief"] == "10.0.0.2" == tcluster.Cluster(tspec).successor_chief(
            down=["10.0.0.1"])
    if case == "drops_mesh_request":
        assert tspec.mesh_request and got["mesh"] is None


def test_shrink_validation_matches_jax():
    cases = [(NODE2, {"drop_addresses": ["10.9.9.9"]}, "unknown node"),
             (NODE2, {"drop_addresses": ["10.0.0.1", "10.0.0.2"]}, "every node"),
             ({"nodes": [{"address": "localhost", "gpus": [0, 1, 2, 3]}]},
              {"keep_chips": {"localhost": [0, 9]}}, "no chip")]
    for info, kwargs, match in cases:
        messages = []
        for spec in _specs(info):
            with pytest.raises(ValueError, match=match) as e:
                spec.shrink(**kwargs)
            messages.append(str(e.value))
        assert messages[0] == messages[1]
    with pytest.raises(ResourceSpecError):
        ResourceSpec(resource_info=NODE2).shrink(drop_addresses=["10.9.9.9"])


def test_ssh_specs_match_jax():
    tspec, jspec = _specs(SSH)
    assert _fields(tspec) == _fields(jspec)
    conf = tspec.ssh_config("10.0.0.1")
    assert conf.username == "root" and conf.port == 2222 and conf.env == {
        "LD_LIBRARY_PATH": "/lib"}
    bad = dict(SSH, nodes=[dict(SSH["nodes"][0], ssh_config="nope"), SSH["nodes"][1]])
    for spec in _specs(bad):
        with pytest.raises(ValueError, match="Unknown ssh group"):
            spec.ssh_config("10.0.0.2")
    with pytest.raises(NotImplementedError, match="item 10"):
        ResourceSpec(resource_info=dict(SSH, topology="2x4"))


# -- the cluster's env contract and ssh command -------------------------------------------

def test_worker_env_matches_jax(monkeypatch):
    monkeypatch.delenv("AUTODIST_ASYNC_PS_ADDR", raising=False)
    tspec, jspec = _specs(SSH)
    tc, jc = tcluster.Cluster(tspec), jcluster.Cluster(jspec)
    got, want = tc.worker_env("10.0.0.2", "strat-1"), jc.worker_env("10.0.0.2", "strat-1")
    assert {k: got[k] for k in want} == want   # every key JAX sets, with its value
    assert {k: got[k] for k in RANK_ENV} == {
        "RANK": "1", "LOCAL_RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1",
        "MASTER_PORT": "15501"}
    assert set(got) == set(want) | set(RANK_ENV) == set(WORKER_ENV) | set(RANK_ENV) | {
        "LD_LIBRARY_PATH"}   # the ssh group's shared env
    assert (tc.coordinator_address, tc.num_processes, tc.process_id) == (
        jc.coordinator_address, jc.num_processes, jc.process_id)
    # four GPUs a node: one process a GPU, ranked chief's node first
    c = tcluster.Cluster(ResourceSpec(resource_info=NODE2))
    env = c.worker_env("10.0.0.2", "s", rank=6)
    assert (env["AUTODIST_PROCESS_ID"], env["RANK"], env["LOCAL_RANK"],
            env["AUTODIST_NUM_PROCESSES"], env["WORLD_SIZE"]) == ("6", "6", "2", "8", "8")
    assert c.num_processes == 8
    assert [(a, d.device_index) for a, d in tcluster.rank_devices(c._spec)][3:5] == [
        ("10.0.0.1", 3), ("10.0.0.2", 0)]
    local = c.local_command(["t.py"], {"RANK": "3"})
    assert local[:2] == ["env", "RANK=3"] and local[-1] == "t.py"
    monkeypatch.setenv("AUTODIST_WORKER", "10.0.0.2")
    monkeypatch.setenv("RANK", "5")
    assert c.process_id == 5 and not c.is_chief
    monkeypatch.setenv("AUTODIST_WORKER", "10.9.9.9")
    with pytest.raises(ValueError):
        c.process_id


def test_remote_command_matches_jax():
    tspec, jspec = _specs(SSH)
    tc, jc = tcluster.Cluster(tspec), jcluster.Cluster(jspec)
    env = jc.worker_env("10.0.0.2", "s1")
    args = ("10.0.0.2", ["/abs/train.py", "--flag"], env)
    assert tc.remote_command(*args, connect_timeout_s=7) == jc.remote_command(
        *args, connect_timeout_s=7)
    cmd = tc.remote_command(*args)
    assert cmd[0] == "ssh" and "ConnectTimeout=10" in " ".join(cmd)
    assert "root@10.0.0.2" in cmd and "/venv/bin/python" in cmd[-1]
    assert tc.cluster_view is None and tc.start_collector() is None
    assert tc.stream_address is None and tc.merge_telemetry() is None


# -- the chaos contract, the health monitor, the event log -------------------------------

CHAOS_TEXTS = ["kill_worker@3;delay@5:0.2; preempt@7 ;kill_worker@9:10.0.0.2", "", None,
               "nan@4", "kill_worker", "delay@soon", "explode@1"]


@pytest.mark.parametrize("text", CHAOS_TEXTS)
def test_parse_chaos_matches_jax(text):
    out = []
    for mod in (telastic, jelastic):
        try:
            out.append([(e.kind, e.step, e.arg, repr(e)) for e in mod.parse_chaos(text)])
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def _loss_stream():
    r = np.random.RandomState(11)
    losses = list(2.0 + 0.01 * r.randn(40))
    losses[20] = 9.0     # a spike
    losses[21] = 9.5     # another: the persistence streak
    losses[30] = float("nan")
    grads = list(1.0 + 0.02 * r.randn(40))
    grads[25] = 50.0
    walls = [0.1] * 16 + [0.3] * 24   # a drift
    return losses, grads, walls


def test_health_monitor_matches_jax():
    losses, grads, walls = _loss_stream()
    out = []
    for mod in (thealth, jhealth):
        mon = mod.HealthMonitor()
        found = [mon.observe(i, loss=l, grad_norm=g, wall_s=w)
                 for i, (l, g, w) in enumerate(zip(losses, grads, walls))]
        out.append((found, mon.summary(), mon.findings, mon.counts))
    assert repr(out[0]) == repr(out[1])   # NaN values compare by their text
    checks = [f["check"] for step in out[0][0] for f in step]
    assert {"nonfinite", "loss_spike", "grad_norm_spike", "step_time_drift"} <= set(checks)
    assert out[0][1]["first_nonfinite_step"] == 30
    assert thealth.median_of([3, 1, 2, 4]) == 2.5 and thealth.median_of([]) is None


def _events(mod):
    log = mod.ClusterEventLog()
    cause = log.note_signal("chaos", step=2, code="kill_worker", worker="10.0.0.2")
    log.record("chaos_injection", step=2, chaos_kind="kill_worker", arg=None, cause=cause)
    log.note_signal("anomaly", step=3, code="nonfinite", persistent=True)
    log.record("membership_epoch", epoch=1, lost=["10.0.0.2"], cause=cause)
    pending = mod.PendingCauses(maxlen=2)
    for i in range(3):
        pending.setdefault(("w", i), {"i": i})
    recs = [{k: v for k, v in r.items() if k not in ("t", "latency_s")}
            for r in log.to_records()]
    for r in recs:
        if "cause" in r:
            r["cause"] = {k: v for k, v in r["cause"].items() if k != "t"}
    return (recs, len(log.signals()), len(log.actions()), pending.dropped, len(pending),
            ("w", 0) in pending, mod.ACTION_KINDS, mod.SIGNAL_KINDS)


def test_event_log_matches_jax(tmp_path):
    assert _events(tevents) == _events(jevents)
    path = tmp_path / "events.jsonl"
    path.write_text('{"a": 1}\nnot json\n\n{"b": 2}\n')
    assert tevents.load_events(str(path)) == jevents.load_events(str(path)) == [{"a": 1},
                                                                                 {"b": 2}]
    with pytest.raises(NotImplementedError, match="item 10"):
        tevents.ClusterEventLog().attach_writer(None)


# -- R = 1 in this process ------------------------------------------------------------------

CPU1 = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}


def _tloss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def _batch_fn(step):
    """``tests/test_elastic.py::_batch_fn``."""
    r = np.random.RandomState(step)
    return {"x": r.randn(16, 12).astype(np.float32), "y": r.randn(16, 3).astype(np.float32)}


def _trainer(d, chaos="", builder=None, **kw):
    return telastic.ElasticTrainer(
        ResourceSpec(resource_info=CPU1), builder or tstrategy.AllReduce(), _tloss,
        {k: torch.from_numpy(v) for k, v in ranks.elastic_params().items()}, optim.adam(0.05),
        checkpoint_dir=str(d), chaos=chaos, verify_restore=False, device="cpu", **kw)


def test_kill_and_delay_keep_the_uninterrupted_history(tmp_path):
    ref = _trainer(tmp_path / "ref")
    ref.fit(_batch_fn, 5)
    t = _trainer(tmp_path / "chaos", chaos="delay@1:0.01;kill_worker@2")
    sess = t.fit(_batch_fn, 5)
    assert t.replans == 1 and t.epoch == 1 and sess.step == 5 and not t.left
    assert [e for e, _, _ in t.history] == [0, 0, 1, 1, 1]
    assert [h[1:] for h in t.history] == [h[1:] for h in ref.history]   # bitwise
    m = manifest.load_manifest(os.path.join(tmp_path, "chaos", "elastic_ckpt"))
    assert m["layout"] == "update_space" and m["step"] == 2 and m["epoch"] == 0
    (change,) = t.membership_changes
    assert change["replicas_before"] == change["replicas_after"] == 1
    assert all(change[k] >= 0 for k in ("drain_s", "save_s", "replan_s", "restore_s"))
    for a, b in zip(sess.params().values(), ref.session.params().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_max_replans_guard(tmp_path):
    t = _trainer(tmp_path, chaos="kill_worker@1", builder=tstrategy.AllReduce(),
                 max_replans=0)
    with pytest.raises(RuntimeError, match="max_replans"):
        t.fit(_batch_fn, 3)


def test_preempt_checkpoints_and_resumes(tmp_path):
    ref = _trainer(tmp_path / "ref")
    ref.fit(_batch_fn, 4)
    before = signal.getsignal(signal.SIGTERM)
    t = _trainer(tmp_path / "run", chaos="preempt@2")
    sess = t.fit(_batch_fn, 4)
    assert signal.getsignal(signal.SIGTERM) is before
    assert sess.preempted and sess.step == 2
    m = manifest.load_manifest(os.path.join(tmp_path, "run", "elastic_ckpt"))
    assert m["layout"] == "update_space" and m["step"] == 2
    resumed = _trainer(tmp_path / "run")
    sess = resumed.fit(_batch_fn, 4)
    assert sess.step == 4 and not sess.preempted
    assert [h[1] for h in resumed.history] == [3, 4]
    for a, b in zip(sess.params().values(), ref.session.params().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nan_fires_on_anomaly_once(tmp_path):
    fired = []
    t = _trainer(tmp_path, chaos="nan@2", on_anomaly=fired.append)
    t.fit(_batch_fn, 3)
    assert [(f["check"], f["step"]) for f in fired] == [("nonfinite", 2)]
    assert t.anomaly_signals == 1 and math.isnan(t.history[-1][2])
    assert [a["hook"] for a in t.event_log.actions() if a["event"] == "hook_fired"] == [
        "on_anomaly"]
    poisoned = telastic.poison({"ids": np.arange(3, dtype=np.int32),
                                "x": torch.ones(2), "t": torch.zeros(2, dtype=torch.int64)})
    assert (poisoned["ids"] == np.iinfo(np.int32).min).all()
    assert torch.isnan(poisoned["x"]).all()
    assert (poisoned["t"] == torch.iinfo(torch.int64).min).all()


def test_nan_token_ids_read_nan_rows_as_jax():
    """The ``nan`` drill's integer ids: JAX's lookup (``jnp.take``) counts
    a negative id from the end and reads a NaN row for an id outside the
    table ("fill"); so does the port's GPT."""
    table = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    ids = np.array([[0, 9, -1], [10, np.iinfo(np.int32).min, 3], [-10, -11, 5]], np.int32)
    want = np.asarray(jembedding_lookup(jnp.asarray(table), jnp.asarray(ids), sync=False))
    got = take_rows(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)   # NaN where JAX has NaN
    assert np.isnan(got[1, :2]).all() and np.isnan(got[2, 1]).all()
    assert np.isfinite(got[0]).all() and np.isfinite(got[2, ::2]).all()


def test_verify_restore_and_reaction_report_name_item_11(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        telastic.ElasticTrainer(ResourceSpec(resource_info=CPU1), None, _tloss, {},
                                optim.sgd(0.1), checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        _trainer(tmp_path).reaction_report()


def test_launch_one_process_is_distribute(tmp_path):
    params = {k: torch.from_numpy(v) for k, v in ranks.elastic_params().items()}
    ad = AutoDist(resource_spec=ResourceSpec(resource_info=CPU1),
                  strategy_builder=tstrategy.AllReduce(), device="cpu")
    launched = ad.launch(_tloss, params, optim.adam(0.05), coordinator_port=15999)
    plain = AutoDist(resource_spec=ResourceSpec(resource_info=CPU1),
                     strategy_builder=tstrategy.AllReduce(), device="cpu").distribute(
        _tloss, params, optim.adam(0.05))
    assert launched.run(_batch_fn(0))["loss"].item() == plain.run(_batch_fn(0))["loss"].item()
    assert ad._coordinator.cluster.num_processes == 1
    ad.rebind(ResourceSpec(resource_info=CPU1))
    assert ad._world is None and ad._mesh_worlds == {} and ad.in_world


def test_launch_async_hands_address_and_authkey(monkeypatch):
    """``launch``'s async path on the chief: the service binds first, then
    the workers are launched with its bound address and a fresh authkey in
    their environment, never in the chief's own."""
    monkeypatch.setenv("AUTODIST_ASYNC_PS_ADDR", "127.0.0.1:0")
    launched = {}
    monkeypatch.setattr(tcluster.Cluster, "launch_workers",
                        lambda self, sid, argv=None, extra_env=None, **kw: launched.update(
                            sid=sid, env=dict(extra_env)))
    info = {"nodes": [{"address": "localhost", "cpus": [0, 1], "chief": True}]}
    ad = AutoDist(resource_spec=ResourceSpec(resource_info=info),
                  strategy_builder=tstrategy.PS(sync=False), device="cpu")
    sess = ad.launch(lambda p, b: torch.mean(b @ p["w"]), {"w": torch.ones(3)},
                     optim.sgd(0.1))
    try:
        assert sess.is_chief and sess.num_workers == 2
        env = launched["env"]
        assert env["AUTODIST_ASYNC_PS_ADDR"] == sess.address != "127.0.0.1:0"
        assert len(bytes.fromhex(env["AUTODIST_ASYNC_PS_AUTHKEY"])) == 32
        assert "AUTODIST_ASYNC_PS_AUTHKEY" not in os.environ
    finally:
        sess.close()


# -- R = 4 -> 2 in the gloo world --------------------------------------------------------

_JAX = {}


def _jax_elastic(key):
    """JAX's ElasticTrainer on the world case's spec (as ``chips``)."""
    if key not in _JAX:
        import tempfile

        info, chaos = ranks.ELASTIC_CASES[key]
        batch = ranks.elastic_batch()
        with tempfile.TemporaryDirectory() as d:
            t = jelastic.ElasticTrainer(
                JResourceSpec(resource_info=_jax_info(info)),
                jstrategy.AllReduce(sharded_update="sharded"),
                lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
                {k: jnp.asarray(v) for k, v in ranks.elastic_params().items()},
                optax.adam(ranks.ELASTIC_LR), checkpoint_dir=d, chaos=chaos,
                verify_restore=False)
            sess = t.fit(lambda step: batch, ranks.ELASTIC_STEPS)
            _JAX[key] = {"history": t.history, "replans": t.replans, "epoch": t.epoch,
                         "num_replicas": sess._t.num_replicas,
                         "params": {n: np.asarray(v) for n, v in sess.params().items()}}
    return _JAX[key]


worker.submit(*((_jax_elastic, key) for key in sorted(ranks.ELASTIC_CASES)))


@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(oracle.world_gpt_params)
    return [res["elastic"] for res in results]


@pytest.mark.parametrize("key", sorted(ranks.ELASTIC_CASES))
def test_world_membership_change_matches_jax(gloo, key):
    want = worker.result(_jax_elastic, key)
    cases = [res[key] for res in gloo]
    survivors = (0, 1) if key == "single_node" else (2, 3)
    for r, c in enumerate(cases):
        assert c["manifest"]["num_replicas"] == ranks.WORLD
        assert c["manifest"]["layout"] == "update_space" and c["manifest"]["step"] == 2
        assert (c["epoch"], c["replans"]) == (want["epoch"], want["replans"]) == (1, 1)
        n = len(c["history"])
        assert [h[:2] for h in c["history"]] == [h[:2] for h in want["history"][:n]]
        np.testing.assert_allclose([h[2] for h in c["history"]],
                                   [h[2] for h in want["history"][:n]], rtol=WORLD_TOL, atol=0)
        if r in survivors:
            assert not c["left"] and c["step"] == ranks.ELASTIC_STEPS and n == 5
            assert c["num_replicas"] == want["num_replicas"] == 2
            assert c["members"] == survivors and c["world"] == (survivors.index(r), 2)
            assert c["seq"] == (survivors.index(r), 2, float(sum(survivors)))
            for name, v in want["params"].items():
                np.testing.assert_allclose(c["params"][name], v, rtol=0, atol=WORLD_TOL)
            np.testing.assert_array_equal(c["params"]["w"], cases[survivors[0]]["params"]["w"])
        else:   # took part in the save at step 2, then left
            assert c["left"] and c["step"] == 2 and n == 2
    if key == "chief_failover":
        assert {cases[r]["chief"] for r in survivors} == {"10.0.0.2"}
