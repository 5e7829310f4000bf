"""The causal cluster event log (counterpart of
``autodist_tpu/telemetry/events.py``), in memory.

The elastic control loop records two species of event:

- **signals**, observations that should provoke a reaction (a straggler, a
  health finding, a heartbeat gap, a worker's exit, a chaos injection);
- **actions**, what the control plane did about one (membership epochs,
  re-plans, checkpoint saves, preemption guards, chaos injections, hook
  firings).

Every action carries ``cause=`` the signal that triggered it and the
measured signal->action ``latency_s``.  The JAX package mirrors the log to
``events.jsonl`` and counts dropped causes through its telemetry
registry; both are telemetry-on features of ROADMAP Queue A item 10, so
``attach_writer`` and a ``writer`` raise here.
"""
import time
from collections import deque

EVENTS_NAME = "events.jsonl"

# action kinds the control plane records (signals all share kind "signal"
# with a ``signal=`` discriminator)
ACTION_KINDS = ("membership_epoch", "replan", "checkpoint_save", "preemption_guard",
                "chaos_injection", "hook_fired", "collector_start", "collector_stop",
                "postmortem_dump")

SIGNAL_KINDS = ("straggler", "anomaly", "heartbeat_gap", "worker_exit", "chaos")

_MIRROR_LATER = ("the events.jsonl mirror is telemetry, a later slice of the port "
                 "(ROADMAP, Queue A item 10)")


def make_cause(signal, *, worker=None, step=None, code=None, t=None):
    """A cause token: the signal identity an action will point back to."""
    return {"signal": signal, "worker": worker, "step": step, "code": code,
            "t": time.time() if t is None else t}


class PendingCauses:
    """Bounded (signal, subject) -> cause-token map.  The control loop
    parks a cause here when it fires a signal and pops it when it answers
    with an action; at ``maxlen`` the oldest pending cause is evicted and
    counted in ``dropped``."""

    def __init__(self, maxlen=1024):
        self.maxlen = maxlen
        self.dropped = 0
        self._d = {}

    def setdefault(self, key, cause):
        if key in self._d:
            return self._d[key]
        if len(self._d) >= self.maxlen:
            self._d.pop(next(iter(self._d)))
            self.dropped += 1
        self._d[key] = cause
        return cause

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def get(self, key, default=None):
        return self._d.get(key, default)

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d

    def __bool__(self):
        return bool(self._d)


class ClusterEventLog:
    """Append-only causal event log, bounded at ``maxlen`` records.  Past
    ``sample_workers_threshold`` distinct signalling workers, each
    (signal, worker) group keeps its first ``sample_keep`` records and then
    one in ``sample_every``; skipped records are counted (``sampled_out``),
    and the cause token is returned all the same."""

    def __init__(self, writer=None, maxlen=4096, sample_workers_threshold=64,
                 sample_keep=4, sample_every=8):
        if writer is not None:
            raise NotImplementedError(f"ClusterEventLog(writer=...): {_MIRROR_LATER}")
        self._events = deque(maxlen=maxlen)
        self.dropped = 0
        self.sample_workers_threshold = sample_workers_threshold
        self.sample_keep = sample_keep
        self.sample_every = sample_every
        self.sampled_out = 0
        self._signal_workers = set()
        self._group_counts = {}
        self._group_skipped = {}

    @property
    def mirrored(self):
        """Whether the log is mirrored to a JSONL writer: never here."""
        return False

    def attach_writer(self, writer, replay=False):
        raise NotImplementedError(f"ClusterEventLog.attach_writer: {_MIRROR_LATER}")

    def note_signal(self, signal, *, worker=None, step=None, code=None, persistent=False,
                    **fields):
        """Record a signal event; returns its cause token for the action."""
        cause = make_cause(signal, worker=worker, step=step, code=code)
        if not self._sample_admit(signal, worker):
            return cause
        rec = {"kind": "cluster_event", "event": "signal", "signal": signal, "worker": worker,
               "step": step, "code": code, "persistent": bool(persistent), "t": cause["t"]}
        skipped = self._group_skipped.pop((signal, worker), 0)
        if skipped:
            rec["sampled_out"] = skipped
        rec.update(fields)
        self._append(rec)
        return cause

    def _sample_admit(self, signal, worker):
        self._signal_workers.add(worker)
        group = (signal, worker)
        n = self._group_counts.get(group, 0) + 1
        self._group_counts[group] = n
        if len(self._signal_workers) <= self.sample_workers_threshold:
            return True
        if n <= self.sample_keep or n % self.sample_every == 0:
            return True
        self.sampled_out += 1
        self._group_skipped[group] = self._group_skipped.get(group, 0) + 1
        return False

    def record(self, event, *, step=None, cause=None, latency_s=None, **fields):
        """Record an action event; the signal->action latency is measured
        here when ``cause`` carries the signal's time."""
        now = time.time()
        rec = {"kind": "cluster_event", "event": event, "step": step, "t": now}
        if cause is not None:
            rec["cause"] = dict(cause)
            if latency_s is None and isinstance(cause.get("t"), (int, float)):
                latency_s = now - cause["t"]
        if latency_s is not None:
            rec["latency_s"] = float(latency_s)
        rec.update(fields)
        self._append(rec)
        return rec

    def _append(self, rec):
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(rec)

    @property
    def events(self):
        return list(self._events)

    def to_records(self):
        return [dict(r) for r in self._events]

    def signals(self):
        return [r for r in self._events if r.get("event") == "signal"]

    def actions(self):
        return [r for r in self._events if r.get("event") != "signal"]

    def close(self):
        """Nothing to close: the log has no mirror."""


def load_events(path):
    """Read an events JSONL file into a list of records (bad lines skipped)."""
    import json

    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out
