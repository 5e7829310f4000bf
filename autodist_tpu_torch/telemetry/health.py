"""Online health detectors over the metrics stream (counterpart of
``autodist_tpu/telemetry/health.py``, pure Python, values as host floats).

:class:`HealthMonitor` judges metric values and returns plain verdict
dicts (``check`` / ``step`` / ``value`` / ``severity`` / ``message``):

- **nonfinite**: a NaN/Inf loss or gradient norm, at once (a non-finite
  value poisons every later step);
- **loss_spike** / **grad_norm_spike**: the value beyond a rolling
  z-score threshold of its recent window;
- **step_time_drift**: the recent step-wall median above the run's early
  median beyond tolerance.

The elastic trainer feeds it each step's loss and hands its findings to
``note_anomaly``.
"""
import math
from collections import deque

# rolling window for the z-score / drift statistics
WINDOW = 32
# observations required before spike/drift judgments
MIN_SAMPLES = 8
# rolling z-score beyond which a loss / grad-norm value is a spike
Z_SPIKE = 6.0
# the recent step-wall median may exceed the early-run median by this much
# (relative), with an absolute floor, before drift fires
DRIFT_REL = 0.75
DRIFT_ABS_S = 0.005

CHECKS = ("nonfinite", "loss_spike", "grad_norm_spike", "step_time_drift")


def _std(xs, mean):
    return math.sqrt(sum((x - mean) ** 2 for x in xs) / len(xs))


def median_of(xs):
    """Exact median (the mean of the middle two when even); None on empty
    input (``autodist_tpu/telemetry/sketch.py::median_of``)."""
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return None
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class HealthMonitor:
    """Streaming detectors; feed one observation per step.  ``observe``
    returns the findings the step produced (usually none); every finding
    is also kept on :attr:`findings` and counted in :attr:`counts`."""

    def __init__(self, window=WINDOW, min_samples=MIN_SAMPLES, z_spike=Z_SPIKE,
                 drift_rel=DRIFT_REL):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.z_spike = float(z_spike)
        self.drift_rel = float(drift_rel)
        self._loss = deque(maxlen=self.window)
        self._grad = deque(maxlen=self.window)
        self._walls = deque(maxlen=self.window)
        self._base_walls = []          # early-run reference for drift
        self._drift_cooldown = -1      # step before which drift stays quiet
        self.observed = 0
        self.findings = []
        self.counts = {}
        self.first_nonfinite_step = None
        self.max_loss_z = 0.0

    def _emit(self, check, step, value, severity, message):
        f = {"check": check, "step": int(step), "value": value, "severity": severity,
             "message": message}
        self.findings.append(f)
        self.counts[check] = self.counts.get(check, 0) + 1
        return f

    def _spike(self, series, check, label, step, x):
        """Rolling z-score spike over ``series``, judged before ``x`` joins
        the window."""
        out = None
        if len(series) >= self.min_samples:
            mean = sum(series) / len(series)
            std = _std(series, mean)
            scale = max(std, 1e-12, abs(mean) * 1e-6)
            z = (x - mean) / scale
            if check == "loss_spike":
                self.max_loss_z = max(self.max_loss_z, z)
            if z > self.z_spike and x > mean:
                out = self._emit(
                    check, step, x, "WARNING",
                    f"{label} {x:.6g} at step {step} is {z:.1f} sigma above its rolling "
                    f"mean {mean:.6g} (window {len(series)}, threshold {self.z_spike:.1f})")
        series.append(x)
        return out

    def observe(self, step, loss=None, grad_norm=None, wall_s=None):
        """Judge one step's metrics; returns the findings it produced."""
        self.observed += 1
        found = []
        for label, x in (("loss", loss), ("grad norm", grad_norm)):
            if x is None:
                continue
            x = float(x)
            if not math.isfinite(x):
                if self.first_nonfinite_step is None:
                    self.first_nonfinite_step = int(step)
                found.append(self._emit(
                    "nonfinite", step, x, "ERROR",
                    f"non-finite {label} ({x}) at step {step} — the update poisons every "
                    f"later step"))
            elif label == "loss":
                f = self._spike(self._loss, "loss_spike", label, step, x)
                if f:
                    found.append(f)
            else:
                f = self._spike(self._grad, "grad_norm_spike", label, step, x)
                if f:
                    found.append(f)
        if wall_s is not None and wall_s > 0:
            self._walls.append(float(wall_s))
            if len(self._base_walls) < self.min_samples:
                self._base_walls.append(float(wall_s))
            elif len(self._walls) >= self.min_samples and step >= self._drift_cooldown:
                base = median_of(self._base_walls)
                recent = median_of(list(self._walls)[-self.min_samples:])
                limit = base * (1.0 + self.drift_rel) + DRIFT_ABS_S
                if recent > limit:
                    # one verdict per window: drift is a condition, not an event
                    self._drift_cooldown = int(step) + self.window
                    found.append(self._emit(
                        "step_time_drift", step, recent, "WARNING",
                        f"step wall drift: recent median {recent * 1e3:.2f} ms vs early-run "
                        f"median {base * 1e3:.2f} ms (+{(recent / base - 1) * 100:.0f}% > "
                        f"{self.drift_rel:.0%} tolerance)"))
        return found

    def summary(self):
        """The aggregate verdict dict."""
        out = {"observed_steps": self.observed, "counts": dict(self.counts),
               "findings": len(self.findings)}
        if self.first_nonfinite_step is not None:
            out["first_nonfinite_step"] = self.first_nonfinite_step
        if self.max_loss_z:
            out["max_loss_z"] = round(self.max_loss_z, 3)
        return out
