"""Elastic fault-tolerant training: the membership-epoch loop
(counterpart of ``autodist_tpu/elastic.py``).

:class:`ElasticTrainer` runs the managed loop under the protocol::

    worker lost (Cluster.on_worker_exit / chaos injection)
        -> drain the in-flight step (torch.cuda.synchronize on the card)
        -> manifest checkpoint of the old epoch (Saver.save_sharded: the
           update-space layout, no gather; every rank of the old world)
        -> shrink the ResourceSpec to the survivors (chief failover =
           the deterministic successor)
        -> epoch += 1 (Cluster.advance_epoch; the AUTODIST_EPOCH contract)
        -> AutoDist.rebind + distribute: a re-plan on the surviving
           topology, in the survivors' subgroup of the process group
        -> reshard the R-way checkpoint onto the R' replicas
           (checkpoint.reshard_restore: parameters and flat optimizer shards)
        -> continue training, the loss continuous across the boundary

A rank whose device the shrink dropped takes part in the save, then leaves:
:meth:`ElasticTrainer.fit` returns its old session with :attr:`left` set,
and it must call no collective of the new epoch.  The launch's default
process group is never torn down (``parallel/mesh.py``).

SIGTERM/SIGINT preemption rides the same machinery through the runner's
:class:`~autodist_tpu_torch.runner.PreemptionGuard`: drain, manifest
checkpoint, clean exit; a fresh trainer's ``fit`` resumes from it (bitwise
on an unchanged topology).

Fault injection (the ``AUTODIST_CHAOS`` env contract)::

    AUTODIST_CHAOS="kill_worker@3;delay@5:0.2"

a semicolon-separated event list, each ``<kind>@<step>[:<arg>]``:

``kill_worker@N[:addr]``
    before step N, treat ``addr`` (default: the last non-chief node in
    rank order, or the upper half of a single node's devices) as dead.
``delay@N:seconds``
    before step N, stall the host for ``seconds`` (straggler injection).
``preempt@N``
    before step N, deliver SIGTERM to this process (preemption drill).
``nan@N``
    poison step N's batch (numeric-anomaly drill: the health monitor flags
    the non-finite loss and the ``on_anomaly`` hook fires).  Floating
    leaves become NaN; an integer leaf takes what numpy's cast of NaN gives
    (the type's minimum), an id outside every table, which the port's GPT
    reads as a NaN row, as JAX's ``jnp.take`` fills.

Left for later slices (ROADMAP, Queue A): the verification of the
re-planned schedule after a restore (``verify_restore=True``, JAX's
default) and :meth:`ElasticTrainer.reaction_report` are item 11 and raise;
the live control plane (``_connect_live``, ``_poll_live``), the flight
recorder's dumps, the events mirror and the ``AUTODIST_FLEET_*`` budgets
are telemetry, item 10: with telemetry off, as here, they do nothing, as
JAX's.
"""
import os
import time

import numpy as np

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging


class ChaosEvent:
    KINDS = ("kill_worker", "delay", "preempt", "nan")

    def __init__(self, kind, step, arg=None):
        if kind not in self.KINDS:
            raise ValueError(
                f"Unknown chaos event kind {kind!r}; accepted: {', '.join(self.KINDS)} "
                f"(AUTODIST_CHAOS contract, docs/elasticity.md)")
        self.kind = kind
        self.step = int(step)
        self.arg = arg
        self.fired = False

    def __repr__(self):
        return f"ChaosEvent({self.kind}@{self.step}" + (f":{self.arg}" if self.arg else "") + ")"


def parse_chaos(text):
    """Parse the ``AUTODIST_CHAOS`` contract: ``<kind>@<step>[:<arg>]``
    entries separated by ``;``.  Empty or None: no events."""
    events = []
    for piece in (text or "").split(";"):
        piece = piece.strip()
        if not piece:
            continue
        kind, sep, rest = piece.partition("@")
        if not sep:
            raise ValueError(
                f"Bad AUTODIST_CHAOS entry {piece!r}: expected '<kind>@<step>[:<arg>]' "
                f"(e.g. 'kill_worker@3', 'delay@5:0.2', 'preempt@4')")
        step_s, _, arg = rest.partition(":")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(f"Bad AUTODIST_CHAOS step in {piece!r}: {step_s!r} is not an "
                             f"integer") from None
        events.append(ChaosEvent(kind.strip(), step, arg or None))
    return events


def poison(batch):
    """The ``nan@N`` drill's batch: every floating leaf NaN, every integer
    leaf the minimum of its type (numpy's cast of NaN)."""
    import torch

    from autodist_tpu_torch.utils.tree import map_batch

    def leaf(a, _):
        if isinstance(a, torch.Tensor):
            if a.is_floating_point():
                return torch.full_like(a, float("nan"))
            return torch.full_like(a, torch.iinfo(a.dtype).min)
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return np.full_like(a, np.nan)
        return np.full_like(a, np.iinfo(a.dtype).min)

    return map_batch(leaf, batch)


class ElasticTrainer:
    """The membership-epoch training loop (see the module's docstring).

    Args:
      resource_spec: the FULL starting topology.
      strategy_builder: any StrategyBuilder (None: the default builder).
      loss_fn / params / optimizer: the single-device model, as
        :meth:`AutoDist.distribute` takes them.
      checkpoint_dir: where the epoch-boundary manifest checkpoints live
        (``<dir>/elastic_ckpt``).
      distribute_kwargs: forwarded to ``distribute`` on every (re)build.
      verify_restore: verify the re-planned schedule on every restore:
        ROADMAP Queue A item 11, so True (JAX's default) raises here;
        pass False.
      chaos: chaos spec string (default: the ``AUTODIST_CHAOS`` env).
      max_replans: cap on topology changes per run.
      on_straggler: callback ``(skew_dict) -> None`` for a persistent
        straggler signal (:meth:`note_straggler`); a hook, not a policy.
      on_anomaly: callback ``(finding_dict) -> None`` when the trainer's
        :class:`~autodist_tpu_torch.telemetry.health.HealthMonitor` flags
        the loss stream (:meth:`note_anomaly`): at once for a non-finite
        loss, after :data:`ANOMALY_PERSISTENCE` consecutive signals for
        spikes.
      event_log: a :class:`~autodist_tpu_torch.telemetry.events.
        ClusterEventLog` (default: a fresh in-memory one).
      mttr_budget_s: the reaction audit's latency budget (item 11).
      heartbeat_timeout_s: a worker silent on the live stream this long is
        a heartbeat gap (the live stream is item 10; stored).
      device: the :class:`AutoDist`'s device (the port's own argument:
        ``"cpu"`` asks for the CPU; default the card, as ``AutoDist``).

    Attributes: :attr:`history` the ``(epoch, step, loss)`` of every step,
    :attr:`replans`, :attr:`epoch`, :attr:`straggler_signals`,
    :attr:`anomaly_signals`, :attr:`left` (this rank's device was dropped),
    :attr:`membership_changes` (each change's seconds: drain, save, shrink,
    rebind and distribute, restore).
    """

    # consecutive straggler signals before the straggler is persistent
    STRAGGLER_PERSISTENCE = 2
    # consecutive health signals of one check before on_anomaly fires (a
    # single spike heals; nonfinite fires at once)
    ANOMALY_PERSISTENCE = 2
    # a worker silent on the stream this long is a heartbeat-gap signal
    HEARTBEAT_TIMEOUT_S = 10.0
    # a trainer built through __new__ (hook logic alone) records no causes
    event_log = None

    def __init__(self, resource_spec, strategy_builder, loss_fn, params, optimizer, *,
                 checkpoint_dir, distribute_kwargs=None, verify_restore=True, chaos=None,
                 max_replans=8, on_straggler=None, on_anomaly=None, event_log=None,
                 mttr_budget_s=None, heartbeat_timeout_s=None, device=None):
        if verify_restore:
            raise NotImplementedError(
                "ElasticTrainer(verify_restore=True): verifying the re-planned schedule after "
                "each restore is a later slice of the port (ROADMAP, Queue A item 11); pass "
                "verify_restore=False")
        from autodist_tpu_torch.autodist import AutoDist
        from autodist_tpu_torch.cluster import Cluster
        from autodist_tpu_torch.telemetry.events import ClusterEventLog, PendingCauses
        from autodist_tpu_torch.telemetry.health import HealthMonitor

        self._ad = AutoDist(resource_spec=resource_spec, strategy_builder=strategy_builder,
                            device=device)
        self.cluster = Cluster(resource_spec)
        self.cluster.on_worker_exit = self._note_worker_exit
        self._ckpt = os.path.join(checkpoint_dir, "elastic_ckpt")
        self._model = (loss_fn, params, optimizer)
        self._kwargs = dict(distribute_kwargs or {})
        self._verify = verify_restore
        self._chaos = parse_chaos(chaos if chaos is not None else ENV.AUTODIST_CHAOS.val)
        self._lost = []          # addresses reported dead, pending handling
        self._keep_chips = None  # a single node's device shrink
        self._max_replans = max_replans
        self.epoch = self.cluster.epoch
        self.replans = 0
        self.history = []        # (epoch, step, loss) across the whole run
        self.session = None
        self.left = False
        self.membership_changes = []
        self.on_straggler = on_straggler
        self._straggler_streak = {}
        self.straggler_signals = 0
        self.on_anomaly = on_anomaly
        self._health = HealthMonitor()
        self._anomaly_streak = {}
        self.anomaly_signals = 0
        self._poison_next = False     # armed by the nan@N chaos event
        self.event_log = event_log if event_log is not None else ClusterEventLog()
        self.mttr_budget_s = mttr_budget_s
        if heartbeat_timeout_s is not None:
            self.HEARTBEAT_TIMEOUT_S = float(heartbeat_timeout_s)
        self._pending_causes = PendingCauses()
        self.last_reaction_report = None
        self.last_postmortem_report = None
        self.last_postmortem_bundle = None

    # -- the black box: the flight recorder is telemetry (item 10) ----------

    def _postmortem_dump(self, trigger, step=None, cause=None, reason=None):
        """The flight recorder's dump: none with telemetry off (item 10)."""
        return None

    # -- membership signals -------------------------------------------------

    def note_straggler(self, skew):
        """Consume one straggler signal (``straggler_addr``, ``skew_s``).
        Once an address persists for :data:`STRAGGLER_PERSISTENCE`
        signals, ``on_straggler`` fires; returns True when it did."""
        addr = (skew or {}).get("straggler_addr")
        if not addr:
            self._straggler_streak.clear()
            return False
        self.straggler_signals += 1
        self._straggler_streak = {addr: self._straggler_streak.get(addr, 0) + 1}
        streak = self._straggler_streak[addr]
        cause = None
        if self.event_log is not None:
            cause = self.event_log.note_signal(
                "straggler", worker=addr, step=skew.get("step"), code="T002",
                persistent=streak >= self.STRAGGLER_PERSISTENCE, skew_s=skew.get("skew_s"))
            self._pending_causes.setdefault(("straggler", addr), cause)
        if streak < self.STRAGGLER_PERSISTENCE:
            return False
        self._postmortem_dump("straggler", step=skew.get("step"), cause=cause,
                              reason={"straggler_addr": addr, "skew_s": skew.get("skew_s")})
        logging.warning("ElasticTrainer: persistent straggler %s (skew %.3fs over %d "
                        "signals)%s", addr, skew.get("skew_s", 0.0), streak,
                        "" if self.on_straggler else " — no on_straggler hook set")
        if self.on_straggler is not None:
            self.on_straggler(dict(skew))
            if self.event_log is not None:
                self.event_log.record("hook_fired", step=skew.get("step"), hook="on_straggler",
                                      worker=addr,
                                      cause=self._pending_causes.pop(("straggler", addr), cause))
            return True
        return False

    def note_anomaly(self, finding):
        """Consume one health verdict (``check``, ``step``, ``value``,
        ``message``): ``nonfinite`` fires ``on_anomaly`` at once, spikes
        after :data:`ANOMALY_PERSISTENCE` consecutive signals of one check;
        returns True when the callback fired."""
        check = (finding or {}).get("check")
        if not check:
            self._anomaly_streak.clear()
            return False
        self.anomaly_signals += 1
        self._anomaly_streak[check] = self._anomaly_streak.get(check, 0) + 1
        need = 1 if check == "nonfinite" else self.ANOMALY_PERSISTENCE
        streak = self._anomaly_streak[check]
        cause = None
        if self.event_log is not None:
            cause = self.event_log.note_signal("anomaly", worker=finding.get("worker"),
                                               step=finding.get("step"), code=check,
                                               persistent=streak >= need)
            self._pending_causes.setdefault(("anomaly", check), cause)
        if streak < need:
            return False
        self._postmortem_dump("anomaly", step=finding.get("step"), cause=cause,
                              reason={"check": check})
        logging.warning("ElasticTrainer: health anomaly %s at step %s (%s)%s", check,
                        finding.get("step"), finding.get("message"),
                        "" if self.on_anomaly else " — no on_anomaly hook set")
        if self.on_anomaly is not None:
            self.on_anomaly(dict(finding))
            if self.event_log is not None:
                self.event_log.record("hook_fired", step=finding.get("step"), hook="on_anomaly",
                                      check=check,
                                      cause=self._pending_causes.pop(("anomaly", check), cause))
            return True
        return False

    def _note_worker_exit(self, addr, code):
        """Cluster monitor callback (monitor thread): queue the death for
        the step-boundary handler; True = claimed, no fail-fast."""
        logging.warning("ElasticTrainer: worker %s exited with %d; queueing membership "
                        "change", addr, code)
        cause = self.event_log.note_signal("worker_exit", worker=addr, code=str(code),
                                           persistent=True)
        self._pending_causes.setdefault(("worker_exit", addr), cause)
        self._lost.append(addr)
        self._postmortem_dump("worker_exit", cause=cause, reason={"worker": addr, "code": code})
        return True

    def _default_kill_target(self):
        """Who dies when a chaos kill names no address: the last non-chief
        node, or on a single node the upper half of its devices."""
        spec = self._ad.resource_spec
        order = [spec.chief] + [a for a in spec.node_addresses if a != spec.chief]
        if len(order) > 1:
            return order[-1], None
        addr = order[0]
        chips = [d.device_index for _, d in spec.accelerator_devices] or \
            [d.device_index for _, d in spec.cpu_devices]
        keep = chips[:max(1, len(chips) // 2)]
        return addr, {addr: keep}

    def _fire_chaos(self, step):
        for ev in self._chaos:
            if ev.fired or ev.step != step:
                continue
            ev.fired = True
            logging.warning("Chaos injection at step %d: %r", step, ev)
            cause = self.event_log.note_signal(
                "chaos", step=step, code=ev.kind,
                worker=ev.arg if ev.kind == "kill_worker" else None)
            self.event_log.record("chaos_injection", step=step, chaos_kind=ev.kind, arg=ev.arg,
                                  cause=cause)
            self._postmortem_dump("chaos", step=step, cause=cause,
                                  reason={"kind": ev.kind, "arg": ev.arg})
            if ev.kind == "kill_worker":
                if ev.arg:
                    self._pending_causes.setdefault(("worker_exit", ev.arg), cause)
                    self._lost.append(ev.arg)
                else:
                    addr, keep = self._default_kill_target()
                    self._pending_causes.setdefault(("worker_exit", addr), cause)
                    if keep is None:
                        self._lost.append(addr)
                    else:
                        self._keep_chips = keep
            elif ev.kind == "delay":
                time.sleep(float(ev.arg or 0.1))
            elif ev.kind == "preempt":
                self._pending_causes.setdefault(("preempt", None), cause)
                import signal

                os.kill(os.getpid(), signal.SIGTERM)
            elif ev.kind == "nan":
                self._poison_next = True

    # -- session lifecycle --------------------------------------------------

    def _build_session(self):
        loss_fn, params, optimizer = self._model
        self.session = self._ad.distribute(loss_fn, params, optimizer, **self._kwargs)
        self._connect_live(self.session)
        return self.session

    def _connect_live(self, sess):
        """The live control plane around a new session: telemetry, item
        10; nothing with telemetry off, as JAX's."""

    def _poll_live(self, step):
        """The step-boundary poll of the live cluster view: telemetry,
        item 10; there is no view with telemetry off, as in JAX."""

    def _finalize_live(self):
        """Close the control plane at the end of :meth:`fit`: the event
        log (no mirror here).  The reaction audit JAX runs here is item
        11."""
        self.event_log.close()

    def reaction_report(self, *, mttr_budget_s=None):
        """The reaction audit over the causal event log: ROADMAP Queue A
        item 11."""
        raise NotImplementedError(
            "ElasticTrainer.reaction_report: the E-code reaction audit is a later slice of the "
            "port (ROADMAP, Queue A item 11)")

    def _drain(self, sess):
        import torch

        if sess.device.type == "cuda":
            torch.cuda.synchronize(sess.device)

    def _restore(self, batch=None):
        """Manifest-aware restore into the current session: bitwise when
        the geometry matches, resharded otherwise (``verify_restore`` is
        item 11, so never verified here)."""
        from autodist_tpu_torch.checkpoint.reshard import reshard_restore

        del batch   # the batch's shapes feed the verification
        return reshard_restore(self.session, self._ckpt, verify=False)

    def _handle_membership_change(self, batch_fn):
        """The epoch transition: drain -> checkpoint -> shrink -> epoch ->
        re-plan -> reshard.  Returns the new session, or None on a rank
        that left."""
        from autodist_tpu_torch.checkpoint.saver import Saver
        from autodist_tpu_torch.cluster import Cluster

        lost = list(dict.fromkeys(self._lost))
        self._lost = []
        keep_chips, self._keep_chips = self._keep_chips, None
        cause = None
        for a in list(lost) + sorted(keep_chips or ()):
            cause = self._pending_causes.pop(("worker_exit", a), None) or cause
        if self.replans + 1 > self._max_replans:
            raise RuntimeError(
                f"ElasticTrainer: {self.replans + 1} topology changes exceed max_replans="
                f"{self._max_replans}; the cluster is flapping — stop and investigate")
        old = self.session
        times = {"epoch": self.epoch + 1, "step": int(old.step),
                 "replicas_before": old.transformer.num_replicas}
        # 1. drain: every launched step completes before the state is read
        t0 = time.perf_counter()
        self._drain(old)
        times["drain_s"] = time.perf_counter() - t0
        # 2. the old epoch's manifest checkpoint, by every rank of the old world
        t0 = time.perf_counter()
        Saver(old).save_sharded(self._ckpt, epoch=self.epoch)
        self._drain(old)
        times["save_s"] = time.perf_counter() - t0
        self.event_log.record("checkpoint_save", step=int(old.step), epoch=self.epoch,
                              cause=cause)
        # 3. the survivors' spec; deterministic chief failover inside
        t0 = time.perf_counter()
        new_spec = self._ad.resource_spec.shrink(drop_addresses=lost, keep_chips=keep_chips)
        self.epoch = self.cluster.advance_epoch()
        self.event_log.record("membership_epoch", epoch=self.epoch,
                              lost=lost or sorted(keep_chips or ()), cause=cause)
        logging.warning("Membership epoch %d: lost %s; surviving topology %r", self.epoch,
                        lost or list(keep_chips or ()), new_spec)
        # 4. stop what remains of the old epoch's launches; the new cluster
        #    view carries the epoch
        self.cluster.terminate()
        cl = Cluster(new_spec)
        cl._epoch = self.epoch
        cl.on_worker_exit = self._note_worker_exit
        self.cluster = cl
        self._ad.rebind(new_spec)
        self.replans += 1
        times["shrink_s"] = time.perf_counter() - t0
        if not self._ad.in_world:
            # this rank's device is gone: it took part in the save and leaves
            self.left = True
            self.membership_changes.append(times)
            logging.warning("ElasticTrainer: this rank left in membership epoch %d",
                            self.epoch)
            return None
        # 5. re-plan on the surviving topology
        t0 = time.perf_counter()
        sess = self._build_session()
        times["replan_s"] = time.perf_counter() - t0
        # 6. reshard the R-way checkpoint onto the R' replicas
        t0 = time.perf_counter()
        self._restore(batch_fn(int(sess.step)) if batch_fn is not None else None)
        self._drain(sess)
        times["restore_s"] = time.perf_counter() - t0
        times["replicas_after"] = sess.transformer.num_replicas
        self.membership_changes.append(times)
        self.event_log.record("replan", step=int(sess.step), epoch=self.epoch,
                              replans=self.replans, cause=cause, postmortem=None)
        logging.info("Epoch %d resumed at step %d on R=%d after re-plan #%d", self.epoch,
                     sess.step, sess.transformer.num_replicas, self.replans)
        return sess

    # -- the managed loop ---------------------------------------------------

    def fit(self, batch_fn, steps, log_every=0):
        """Train to ``steps`` total steps, surviving worker loss, chaos
        injection and preemption.  Returns the (possibly rebuilt) session,
        or on a rank that left, its last one (:attr:`left` set); each
        step's ``(epoch, step, loss)`` is in :attr:`history`."""
        from autodist_tpu_torch.checkpoint.saver import Saver
        from autodist_tpu_torch.runner import PreemptionGuard, _metrics_str

        sess = self.session or self._build_session()
        if Saver.exists(self._ckpt):
            self._restore(batch_fn(0))
            logging.info("ElasticTrainer: resumed from %s at step %d", self._ckpt, sess.step)
        with PreemptionGuard() as guard:
            while sess.step < steps:
                step = sess.step
                self._fire_chaos(step)
                if self._lost or self._keep_chips:
                    new = self._handle_membership_change(batch_fn)
                    if new is None:
                        break
                    sess = new
                    continue
                if guard.requested:
                    self._drain(sess)
                    Saver(sess).save_sharded(self._ckpt, epoch=self.epoch)
                    preempt_cause = self._pending_causes.pop(("preempt", None), None)
                    self.event_log.record("preemption_guard", step=int(sess.step),
                                          epoch=self.epoch, cause=preempt_cause)
                    self._postmortem_dump("preempt", step=int(sess.step), cause=preempt_cause)
                    logging.warning("ElasticTrainer: preempted at step %d; manifest checkpoint "
                                    "written, exiting cleanly", sess.step)
                    sess.preempted = True
                    break
                batch = batch_fn(step)
                if self._poison_next:
                    self._poison_next = False
                    batch = poison(batch)
                metrics = sess.run(batch)
                loss = metrics.get("loss") if isinstance(metrics, dict) else None
                loss_f = float(loss) if loss is not None else None
                self.history.append((self.epoch, int(sess.step),
                                     loss_f if loss_f is not None else float("nan")))
                # the trainer-side health judgment of the host loss
                if loss_f is not None:
                    for hf in self._health.observe(step, loss=loss_f):
                        self.note_anomaly(hf)
                self._poll_live(int(sess.step))
                if log_every and sess.step % log_every == 0:
                    logging.info("epoch %d step %d: %s", self.epoch, sess.step,
                                 _metrics_str(metrics))
        sess.finalize_telemetry()
        self._finalize_live()
        return sess
