#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc::

    python3 chip_smoke.py

Phases (each failure exits non-zero before the last line):

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the flash-attention kernels from ``autodist_tpu_torch/csrc``;
3. holds each kernel (forward, dq, dkdv) against its plain PyTorch version
   on the same bf16 inputs, the plain version computing in f32, at the
   GPT-2-small attention shape, a GQA case, a key-padding case with fully
   masked rows and a ragged S = 1000; then times kernel, plain version,
   ``scaled_dot_product_attention`` (the library yardstick, used nowhere in
   the port) and computes each kernel's bound at the GPT-2-small shape;
4. trains GPT-2 small at full width (GPTConfig(): 12 layers, hidden 768, 12
   heads, vocab 50257) through ``AutoDist(..., AllReduce()).distribute``
   for 10 steps at B=8, S=1024 on one seeded token batch, checks the
   losses and that every step launched each kernel once per layer, and
   holds step 1's loss against the kernel-free plain attention path;
5. prints the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Tolerances, kernel vs plain version on the same inputs.  bf16 inputs (the
tensor-core kernels; plain version in f32): out max-abs <= 1e-2 *
max(1, max|out|) (bf16 rounding of the output), lse max-abs <= 1e-3, dq,
dk, dv relative Frobenius error <= 1e-2.  f32 inputs (the FMA kernels):
1e-4 in place of each 1e-2 and 1e-3 (f32 sums in another order).  Step 1
loss, kernels vs plain attention: relative <= 1e-3.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "autodist_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "autodist_tpu/ops/pallas/flash_attention.py:198",
    "flash_dq": "autodist_tpu/ops/pallas/flash_attention.py:328",
    "flash_dkdv": "autodist_tpu/ops/pallas/flash_attention.py:367",
}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOLERANCES = {"bfloat16": (1e-2, 1e-3, 1e-2), "float32": (1e-4, 1e-4, 1e-4)}
LOSS_REL_TOL = 1e-3
STEPS, BATCH, SEQ = 10, 8, 1024
SLEEP_CYCLES = 200_000_000   # ~0.1 s of the SM clock: time to queue the timed runs


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, torch, flush, reps=15, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn``, L2 flushed before each.

    The runs are queued behind a sleep kernel, so the device runs them back
    to back and the host's launch time (large for a library call's many
    launches on a busy host) stays out of the device times.  If the sleep
    ends before the host has queued every run, it is doubled and the runs
    are timed again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    while True:
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        queued_in_time = not slept.query()
        torch.cuda.synchronize()
        if queued_in_time or cycles >= 8 * SLEEP_CYCLES:
            return statistics.median(start.elapsed_time(end) for start, end in events)
        cycles *= 2


def make_case(torch, b, s, h, h_kv, d, causal, masked, seed, dtype="bfloat16"):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(getattr(torch, dtype))

    q, do = rand(b * h, s, d), rand(b * h, s, d)
    k, v = rand(b * h_kv, s, d), rand(b * h_kv, s, d)
    bias = torch.zeros(b, s, device="cuda")
    if masked:
        bias[0, s // 3:] = -1e30   # ragged padding
        bias[-1, :] = -1e30        # an example with every key masked
    return dict(q=q, k=k, v=v, do=do, bias=bias, h=h, group=h // h_kv,
                scale=d ** -0.5, causal=causal)


def check_kernels(torch, fa):
    """Each kernel against its plain version; returns the max-abs errors
    of the bf16 cases (the main path's type)."""
    cases = {
        "gpt2_small B8 S1024 H12 D64 causal": (8, 1024, 12, 12, 64, True, False),
        "gqa g2 B2 S512 H12/6 D64 causal": (2, 512, 12, 6, 64, True, False),
        "key padding, fully masked rows B2 S512 H12 D64": (2, 512, 12, 12, 64, False, True),
        "ragged B2 S1000 H12 D64 causal": (2, 1000, 12, 12, 64, True, False),
        "f32 ragged GQA B2 S300 H4/2 D40 causal": (2, 300, 4, 2, 40, True, False, "float32"),
    }
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    for i, (label, shape) in enumerate(cases.items()):
        c = make_case(torch, *shape[:7], seed=i, dtype=(shape + ("bfloat16",))[7])
        out_tol, lse_tol, grad_tol = TOLERANCES[str(c["q"].dtype).split(".")[1]]
        cfg = (c["h"], c["scale"], c["causal"], c["group"])
        f32 = {n: c[n].float() for n in ("q", "k", "v", "do")}
        out, lse = fa.flash_fwd(c["q"], c["k"], c["v"], c["bias"], *cfg)
        ref_out, ref_lse = fa.flash_fwd_plain(f32["q"], f32["k"], f32["v"], c["bias"], *cfg)
        delta = (c["do"].float() * out.float()).sum(-1)
        args = (c["bias"], c["do"], lse, delta)
        dq = fa.flash_dq(c["q"], c["k"], c["v"], *args, *cfg)
        dk, dv = fa.flash_dkdv(c["q"], c["k"], c["v"], *args, *cfg)
        fargs = (c["bias"], f32["do"], lse, delta)
        ref_dq = fa.flash_dq_plain(f32["q"], f32["k"], f32["v"], *fargs, *cfg)
        ref_dk, ref_dv = fa.flash_dkdv_plain(f32["q"], f32["k"], f32["v"], *fargs, *cfg)
        torch.cuda.synchronize()

        def max_abs(a, b):
            return float((a.float() - b.float()).abs().max())

        def rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))

        e_out, e_lse = max_abs(out, ref_out), max_abs(lse, ref_lse)
        grads = {"dq": (dq, ref_dq), "dk": (dk, ref_dk), "dv": (dv, ref_dv)}
        rels = {n: rel(a, b) for n, (a, b) in grads.items()}
        print(f"kernel check [{label}]: out max-abs {e_out:.3e}, lse max-abs {e_lse:.3e}, "
              + ", ".join(f"{n} rel {r:.3e}" for n, r in rels.items()))
        out_bound = out_tol * max(1.0, float(ref_out.abs().max()))
        check(e_out <= out_bound, f"{label}: out max-abs {e_out} > {out_bound}")
        check(e_lse <= lse_tol, f"{label}: lse max-abs {e_lse} > {lse_tol}")
        for n, r in rels.items():
            check(r <= grad_tol, f"{label}: {n} relative error {r} > {grad_tol}")
        for t in (out, dq, dk, dv):
            check(bool(torch.isfinite(t.float()).all()), f"{label}: non-finite kernel output")
        if shape[6]:   # fully masked rows give exactly 0, forward and dq
            check(not out[-shape[2]:].any() and not dq[-shape[2]:].any(),
                  f"{label}: fully masked rows are not exact zeros")
        if c["q"].dtype != torch.bfloat16:
            continue
        worst["flash_fwd"] = max(worst["flash_fwd"], e_out)
        worst["flash_dq"] = max(worst["flash_dq"], max_abs(dq, ref_dq))
        worst["flash_dkdv"] = max(worst["flash_dkdv"], max_abs(dk, ref_dk),
                                  max_abs(dv, ref_dv))
    return worst


def measure_kernels(torch, fa):
    """Kernel, plain and library times and the bound at the GPT-2-small shape."""
    import torch.nn.functional as F

    b, s, h, d = BATCH, SEQ, 12, 64
    c = make_case(torch, b, s, h, h, d, True, False, seed=7)
    cfg = (c["h"], c["scale"], c["causal"], c["group"])
    q, k, v, do, bias = c["q"], c["k"], c["v"], c["do"], c["bias"]
    out, lse = fa.flash_fwd(q, k, v, bias, *cfg)
    delta = (do.float() * out.float()).sum(-1)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")   # > the 50 MB L2
    fold = {n: t.view(b, h, s, d) for n, t in (("q", q), ("k", k), ("v", v), ("do", do))}
    lib = {n: t.detach().clone().requires_grad_(n != "do") for n, t in fold.items()}

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(lib["q"], lib["k"], lib["v"], is_causal=True)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(lib["q"], lib["k"], lib["v"],
                                       is_causal=True).backward(lib["do"])

    with torch.no_grad():
        timings = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, bias, *cfg),
                          lambda: fa.flash_fwd_plain(q, k, v, bias, *cfg), sdpa_fwd),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, bias, do, lse, delta, *cfg),
                         lambda: fa.flash_dq_plain(q, k, v, bias, do, lse, delta, *cfg),
                         sdpa_fwd_bwd),
            "flash_dkdv": (lambda: fa.flash_dkdv(q, k, v, bias, do, lse, delta, *cfg),
                           lambda: fa.flash_dkdv_plain(q, k, v, bias, do, lse, delta, *cfg),
                           sdpa_fwd_bwd),
        }
        # (row, key) pairs this run's causal mask leaves, per head
        pairs = float(torch.ones(s, s, device="cuda").tril().sum()) * b * h
        elem = b * h * s * d
        rows = b * h * s
        work = {  # (flops, bytes): each input read once, each output written once
            "flash_fwd": (4 * d * pairs, 4 * elem * 2 + rows * 4 + b * s * 4),
            "flash_dq": (6 * d * pairs, 5 * elem * 2 + 2 * rows * 4 + b * s * 4),
            "flash_dkdv": (8 * d * pairs, 6 * elem * 2 + 2 * rows * 4 + b * s * 4),
        }
        results = {}
        for name, (kern, plain, library) in timings.items():
            flops, nbytes = work[name]
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            with torch.enable_grad():
                library_ms = time_ms(library, torch, flush)
            results[name] = {
                "ms": time_ms(kern, torch, flush),
                "plain_ms": time_ms(plain, torch, flush, reps=10),
                "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            r = results[name]
            print(f"timing {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}: {r['gflop']:.2f} GFLOP, {r['mbytes']:.2f} MB)")
    return results


def train_gpt2_small(torch, fa):
    """The port's main path: GPT-2 small, AllReduce, 10 adamw steps."""
    import dataclasses

    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    toks = np.random.default_rng(0).integers(0, config.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}

    # step 1's loss through the kernel-free plain attention, same weights
    plain_loss_fn, _, _ = gpt_capture(dataclasses.replace(config, attention_impl="xla"),
                                      SEQ, seed=0)
    with torch.no_grad():
        dev_batch = {n: torch.from_numpy(a).cuda() for n, a in batch.items()}
        plain_loss = plain_loss_fn(params, dev_batch).item()
    del plain_loss_fn, dev_batch
    torch.cuda.empty_cache()

    spec = ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": [0], "chief": True}]})
    sess = AutoDist(resource_spec=spec, strategy_builder=AllReduce()).distribute(
        loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse, has_rng=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = sess.run(batch)
        losses.append(metrics["loss"].item())   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steady = statistics.median(step_ms[1:])
    print("train losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print("train step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"train: median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"step 1 loss: kernels {losses[0]:.6f}, plain attention {plain_loss:.6f}, "
          f"relative difference {rel:.3e}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    check(abs(losses[0] - math.log(config.vocab_size)) <= 0.5,
          f"first loss {losses[0]} not within 0.5 of ln(vocab) = {math.log(config.vocab_size)}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(rel <= LOSS_REL_TOL, f"step 1 loss differs from the plain path by {rel}")
    per_step = config.num_layers * STEPS
    check(launches == {"flash_fwd": per_step, "flash_dq": per_step, "flash_dkdv": per_step},
          f"expected {per_step} launches of each kernel, got {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in sess.state["params"].values()),
          "non-finite parameters after training")
    profile_steps(torch, sess, batch)
    return launches


def profile_steps(torch, sess, batch, steps=2):
    """Where a step's device time goes: ``torch.profiler`` over two more
    steps (after the timed ones); prints the device-busy share and the
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.run(batch)["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # device-side events only: an operator's row repeats its kernels' time
    for e in prof.key_averages():
        if (str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA"
                or getattr(e, "is_user_annotation", False)):   # spans repeat kernels
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.key))
    busy = sum(ms for ms, _ in rows)
    if not rows:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile: {wall_ms / steps:.2f} ms per step on the host clock, device busy "
          f"{busy:.2f} ms ({100 * busy / (wall_ms / steps):.1f} %)")
    for ms, name in sorted(rows, reverse=True)[:15]:
        print(f"profile: {ms:8.3f} ms/step {100 * ms / busy:5.1f} %  {name[:90]}")


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this smoke test runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from autodist_tpu_torch.ops import build
        from autodist_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"FAIL: run from a checkout of the repo ({e})", file=sys.stderr)
        return 1
    # full-f32 products: the GPT head is an f32 matmul, as in the JAX model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(card[0] if card else "nvidia-smi: no output")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    try:
        t0 = time.perf_counter()
        build.build(["flash_attention"])
        print(f"kernel build: {time.perf_counter() - t0:.1f} s")
        errors = check_kernels(torch, fa)
        timing = measure_kernels(torch, fa)
        torch.cuda.empty_cache()
        launches = train_gpt2_small(torch, fa)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name], "max_abs_err": errors[name],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in ("flash_fwd", "flash_dq", "flash_dkdv")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
