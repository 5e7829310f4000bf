"""The trainer-side telemetry the elastic trainer uses with telemetry off
(counterparts of ``autodist_tpu/telemetry/events.py`` and ``health.py``):
the in-memory causal event log and the loss-stream health judgment.  The
rest of the JAX package's telemetry (the registry and its counters, the
JSONL writers, the session trace, the live stream) is ROADMAP Queue A item
10."""
