#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-rank phases over R GPUs of one host, one
process per GPU (NCCL)::

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py Int8Compressor
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py ring
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py ps
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py sharded
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py sync
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py partitioned
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py stale
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py reshard && \\
    python3 -m torch.distributed.run --standalone --nproc-per-node 2 \\
        multi_gpu_check.py reshard

``CODEC`` (one of ``chip_smoke.CODECS``): each rank runs
``chip_smoke.train_gpt2_codec`` on its own GPU: GPT-2 small at full width
under ``AllReduce(compressor=CODEC)``, 8 sequences of 1024 tokens per rank,
with that function's checks (step 1's synced gradients through the kernels
bitwise equal to the codec's plain versions over the same NCCL
collectives, finite and falling losses, the launches per step of the
one-GPU run) and one more: every rank ends with the same parameters.

``ring``: sequence parallelism.  One global batch of 8 sequences of 1024
tokens trains GPT-2 small (adamw 3e-4, 5 steps) on ``mesh: {replica: 1,
seq: R}`` (every rank 8 sequences of 1024 / R tokens) and on ``{replica:
R / 2, seq: 2}``, attention through ``ring_attention`` over each seq row
(``flash_block_update`` forward, offset ``flash_dq`` / ``flash_dkdv``
backward, K/V blocks between the GPUs by NCCL point-to-point).  Checks:
step 1's loss within 1e-3 of the same batch's loss in one process on the
flat path (no sequence parallelism); 12 * R_s launches per step of each
ring kernel and none of ``flash_fwd``; finite losses that fall; every rank
ends with the same parameters.

``ps``: the default builder.  GPT-2 small (adamw 3e-4, 8 sequences of
1024 tokens per rank, 5 steps) under ``AutoDist(resource_spec=...)`` with
no strategy builder, so ``PSLoadBalancing``: one reduce-scatter of the
gradients, the adamw update of each rank's flat 1/R shards, one
all-gather, per step.  And the same run under ``AllReduce()`` (the
``NoneCompressor``) on the same cards, each builder twice, in turns.  Checks: ``check_replication() ==
[]`` after step 1; finite losses that fall; 12 launches per step of each
flash kernel; step 1's loss equal between the two within 1e-5 (same
parameters, same forward) and the later steps within 1e-3; every rank
ends with the same parameters.  Prints both builders' step medians.

``sharded``: the AllReduce family's weight-update sharding.  GPT-2 small
(adamw 3e-4, 8 sequences of 1024 tokens per rank, 5 steps) under
``AllReduce()``, ``AllReduce(sharded_update="sharded")`` (reduce-scatter of
the gradient buckets, adamw on each rank's flat 1/R shards, all-gather of
the parameters) and ``AllReduce(precision="bf16_master")`` (the f32
master only as those shards, a bf16 compute copy gathered at the top of
each step), in turns, twice each.  Checks: step 1's loss against the same
global batch's loss in one process on the dense path (within 1e-3
relative, the kernels' bound against plain versions; the bf16 master
within 2e-2), the sharded update's losses against ``AllReduce()``'s
(step 1 within 1e-5 relative, later steps 1e-3), ``check_replication() ==
[]`` after step 1, finite losses that fall, 12 launches per step of each
flash kernel, and every rank ending with the same full parameters.  Prints each
median step, peak memory and the flat-shard and optimizer-state bytes a
rank holds.

``sync``: the rest of the AllReduce family.  GPT-2 small (adamw 3e-4, 8
sequences of 1024 tokens per rank, 5 steps), each its own ``AutoDist``:
``AllReduce()`` and ``AllReduce(schedule="overlap")`` on ``{replica: R}``
in turns (barrier, overlap, overlap, barrier); then on ``{replica_dcn: 2,
replica_ici: R / 2}`` ``AllReduce(hierarchy="two_level")`` and the same
with ``dcn_compressor="EquarxInt8Compressor"``; then
``AllReduce(compressor="PowerSGDCompressor")`` on ``{replica: R}``.  On
one host the "DCN" hop is NVLink like the ICI hop: the run checks the
two-level program's collectives and numbers, not a slow link.  Checks:
``check_replication() == []`` after step 1; finite losses (falling,
but for PowerSGD); 12 launches a step of each flash kernel (and the
EQuARX hop's 2 ``quantize_int8`` + 2 ``equarx_hop``); the overlap's and
the two-level's losses against the barrier's on ``{replica: R}``, step 1
within 1e-5 relative and the later steps 1e-3 (the chunked or
three-hop NCCL reduction adds the 4 ranks' gradients in another order,
and adamw turns a last-bit difference into lr-sized steps); every rank
ending with the same parameters.  Prints each
median step, and for the barrier and the overlap the share of NCCL kernel
time that ran while a compute kernel ran, from one ``torch.profiler``
window of two steps.

``partitioned``: the synchronous PS family on NCF at full width
(``NCFConfig()``, ~31.8 M parameters; adam 1e-3, 64 examples per rank, 10
steps), its four tables in ``sparse_vars``: under
``PartitionedPS(max_shards=8)`` each rank stores its quarter of every
table's rows and looks them up through the row exchange (ids all-gathered,
rows reduce-scattered back, the row gradients all-gathered in the
backward), and under ``Parallax()`` the tables are sparse PS variables
(each rank updates its flat quarter, then all-gathers) and the MLP
all-reduces; in turns (Parallax, PartitionedPS, PartitionedPS, Parallax).
Checks: step 1 of each within 1e-5 relative of one process's dense loss
on the global batch and of the other builder's; finite losses; no launch
of the nine kernels; ``check_replication() == []``; every rank ends with
the same full parameters.  Prints each builder's median step and peak
memory.

``stale``: bounded staleness.  GPT-2 small (adamw 3e-4, 8 sequences of
1024 tokens per rank, 5 steps) under ``PS(staleness=2)``: every variable
a DIVERGENT copy per rank, updated by the rank's own gradient and
averaged over the ranks after step 3 (one NCCL all-reduce a period).
Checks: step 1's loss within 1e-3 relative of one process's loss of the
global batch; ``check_replication() == []`` (the copies are not
compared); finite losses that fall; 12 launches a step of each flash
kernel; the copies equal on every rank after the average of step 3 and
only then; ``params()`` (the mean of the copies) the same on every rank.
Then the cross-process async PS: ``PS(sync=False, staleness=1)``, each
rank one worker on its GPU, rank 0 serving the parameters from threads of
its process on an ephemeral port handed to the others through the
process group, 3 steps a worker on the rank's 8 sequences, rank R-1 a
straggler (0.05 s between pull and push).  Checks: ``version == 3 R``,
the lead at most 1, finite losses, 12 launches a step of each flash
kernel, and every rank's ``params()`` after ``wait_all`` equal to the
chief's.  Prints each run's step times and the server's stats.

``reshard``: checkpoints across a change of R, in two launches.  At 4
ranks: GPT-2 small (adamw 3e-4, 8 sequences of 1024 tokens per rank, 10
steps) under the default builder (``PSLoadBalancing``: flat optimizer
shards), ``Saver.save_sharded`` after step 5 into ``_ckpt/reshard`` in
the checkout (each rank its shards, rank 0 once what the ranks share),
and the ten losses beside it.  At fewer ranks (2): the same global batch
of 32 sequences (16 per rank), ``reshard_restore(verify=False)`` of that
checkpoint (the saved R = 4 flat shards put together, then cut for R =
2), then steps 6-10.  Checks: the save's manifest (``update_space``,
step 5, R = 4); the restored step; steps 6-10 against the 4-rank run's,
step 6 within 1e-5 relative and the later steps 1e-3; finite losses; 12
launches a step of each flash kernel; every rank ending with the same
parameters.  Prints the save's and the restore's seconds, bytes and GB/s.
The second launch removes the checkpoint.

Rank 0 builds the kernels and prints; the run ends with a ``RESULT {...}``
JSON line.  A failed check exits non-zero.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import chip_smoke as smoke

RING_STEPS = 5
RING_SEQUENCES = 8
PS_STEPS = 5


def train_gpt2_mesh(torch, ad, kernel_modules):
    """GPT-2 small on ``ad``'s ``{replica, seq}`` mesh, RING_SEQUENCES
    sequences of SEQ tokens in all, RING_STEPS adamw steps; returns the
    run's numbers."""
    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, smoke.SEQ, seed=0)
    toks = np.random.default_rng(0).integers(0, config.vocab_size,
                                             (RING_SEQUENCES, smoke.SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    with torch.no_grad():   # the same batch and weights in one process, flat path
        flat_loss = loss_fn(params, {n: torch.from_numpy(a).cuda()
                                     for n, a in batch.items()}).item()
    torch.cuda.empty_cache()
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    seq, rows = sess.transformer.seq_axis, sess.transformer.world.data_slice[1]
    tag = f"mesh replica {rows} x seq {seq.size}"
    losses, step_ms, launches, peak_gb = smoke.timed_steps(torch, sess, batch, RING_STEPS,
                                                           kernel_modules)
    steady = statistics.median(step_ms[1:])
    print(f"{tag} losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print(f"{tag} step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"{tag}: median step {steady:.2f} ms (steps 2-{RING_STEPS}), "
          f"{RING_SEQUENCES * smoke.SEQ / steady * 1e3:.0f} tokens/s over all ranks, "
          f"peak memory {peak_gb:.2f} GB, launches {launches}")
    print(f"{tag} step 1 loss {losses[0]:.6f}, one process on the flat path "
          f"{flat_loss:.6f}, difference {abs(losses[0] - flat_loss):.3e}")
    smoke.check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    smoke.check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    smoke.check(abs(losses[0] - flat_loss) <= smoke.RING_LOSS_TOL,
                f"{tag}: step 1 loss {losses[0]} differs from the flat path's {flat_loss}")
    per_step = config.num_layers * seq.size * RING_STEPS
    want = dict(smoke.NO_LAUNCHES, flash_block_update=per_step, flash_dq=per_step,
                flash_dkdv=per_step)
    smoke.check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    smoke.check(smoke.same_on_every_rank(torch, list(sess.state["params"].values()),
                                         sess.transformer.group),
                f"{tag}: the ranks hold different parameters")
    print(f"{tag}: all {sess.transformer.world.size} ranks hold the same parameters")
    return {"mesh": {"replica": rows, "seq": seq.size}, "losses": losses,
            "flat_loss": flat_loss, "step_ms": steady, "peak_gb": peak_gb,
            "launches_per_step": {k: v // RING_STEPS for k, v in launches.items() if v}}


def train_gpt2_sync(torch, ad, kernel_modules, tag, flat_loss=None, step1_tol=None,
                    extra_launches=None, falls=True, profile=False):
    """GPT-2 small at 8 sequences per rank under ``ad``'s builder, PS_STEPS
    adamw steps; ``check_replication`` after step 1, and with
    ``flat_loss`` step 1's loss within ``step1_tol`` relative of it;
    ``extra_launches`` are the kernel launches a step besides the flash
    kernels; ``profile`` adds the NCCL overlap share of two more steps.
    Returns the run's numbers."""
    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, smoke.SEQ, seed=0)
    rows = smoke.BATCH * ad.world.size
    toks = np.random.default_rng(0).integers(0, config.vocab_size, (rows, smoke.SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    first = sess.run(batch)["loss"].item()
    bad = sess.check_replication()
    smoke.check(bad == [], f"{tag}: check_replication() after step 1 names {bad}")
    if flat_loss is not None:
        rel = abs(first - flat_loss) / abs(flat_loss)
        print(f"{tag} step 1 loss {first:.6f}, one process on the dense path "
              f"{flat_loss:.6f}, relative difference {rel:.3e}")
        smoke.check(rel <= step1_tol, f"{tag}: step 1 loss differs from one process's by {rel}")
    shard_bytes, opt_bytes = smoke.state_bytes(sess)
    losses, step_ms, launches, peak_gb = smoke.timed_steps(torch, sess, batch, PS_STEPS - 1,
                                                           kernel_modules)
    losses = [first] + losses
    steady = statistics.median(step_ms)
    print(f"{tag} losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{tag} step ms (steps 2-{PS_STEPS}): " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"{tag}: median step {steady:.2f} ms (steps 2-{PS_STEPS}), "
          f"{rows * smoke.SEQ / steady * 1e3:.0f} tokens/s over {rows} sequences, peak "
          f"memory {peak_gb:.2f} GB, launches {launches}; check_replication() == [] "
          f"after step 1; this rank holds {shard_bytes / 1e9:.3f} GB of flat shards and "
          f"{opt_bytes / 1e9:.3f} GB of optimizer state")
    smoke.check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    smoke.check(losses[-1] < losses[0] or not falls, f"{tag}: loss did not fall: {losses}")
    per_step = config.num_layers * (PS_STEPS - 1)
    want = dict(smoke.NO_LAUNCHES, flash_fwd=per_step, flash_dq=per_step,
                flash_dkdv=per_step)
    want.update({k: v * (PS_STEPS - 1) for k, v in (extra_launches or {}).items()})
    smoke.check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    full = sess.transformer.canonical_params(sess.state)   # bf16 master: gathered in f32
    smoke.check(smoke.same_on_every_rank(torch, list(full.values()), sess.transformer.group),
                f"{tag}: the ranks hold different parameters")
    print(f"{tag}: all {ad.world.size} ranks hold the same parameters")
    result = {"losses": losses, "step_ms": steady, "steps_ms": step_ms, "peak_gb": peak_gb,
              "shard_bytes": shard_bytes, "opt_bytes": opt_bytes}
    if profile:
        result["nccl_overlap"] = nccl_overlap_share(torch, sess, batch)
        share = result["nccl_overlap"]
        print(f"{tag}: NCCL kernels {share['nccl_ms']:.2f} ms a step, "
              f"{100 * share['share']:.1f} % of it while a compute kernel ran; compute kernels "
              f"{share['compute_ms']:.2f} ms a step (torch.profiler, two steps)")
    return result


def nccl_overlap_share(torch, sess, batch, steps=2):
    """The share of NCCL kernel time during which a compute kernel also ran,
    over ``steps`` profiled steps, from ``torch.profiler``'s device events
    (copies and fills are neither)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sess.run(batch)["loss"].item()
    nccl, compute = [], []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        name = e.name.lower()
        if name.startswith(("memcpy", "memset")):
            continue
        span = (e.time_range.start, e.time_range.end)
        (nccl if "nccl" in name else compute).append(span)
    merged = []
    for start, end in sorted(compute):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    total = sum(end - start for start, end in nccl)
    both = sum(max(0, min(end, b) - max(start, a)) for start, end in nccl for a, b in merged)
    busy = sum(end - start for start, end in merged)
    return {"nccl_ms": total / 1e3 / steps, "compute_ms": busy / 1e3 / steps,
            "share": both / total if total else 0.0}


SYNC_RUNS = (   # tag -> (mesh, AllReduce options)
    ("barrier", None, {}),
    ("overlap", None, {"schedule": "overlap"}),
    ("two_level", "2x", {"hierarchy": "two_level"}),
    ("two_level EquarxInt8 DCN", "2x", {"hierarchy": "two_level",
                                        "dcn_compressor": "EquarxInt8Compressor"}),
    ("PowerSGD", None, {"compressor": "PowerSGDCompressor"}),
)


def compare_sync(torch, ads, modules):
    """SYNC_RUNS in turns (barrier, overlap, overlap, barrier, then the
    others once): the overlap's and the two-level's losses against the
    barrier's; returns the runs by tag."""
    names = [tag for tag, _, _ in SYNC_RUNS]
    result = {name: [] for name in names}
    for i in (0, 1, 1, 0, 2, 3, 4):
        tag = names[i]
        extra = smoke.SYNC_VARIANT_LAUNCHES.get(tag, {})
        result[tag].append(train_gpt2_sync(torch, ads[i], modules, tag, extra_launches=extra,
                                           falls=tag != "PowerSGD",
                                           profile=tag in ("barrier", "overlap")
                                           and not result[tag]))
        torch.cuda.empty_cache()
    barrier = result["barrier"][0]["losses"]
    for tag in ("overlap", "two_level"):
        rel = [abs(a - b) / abs(b) for a, b in zip(result[tag][0]["losses"], barrier)]
        print(f"{tag} vs barrier: relative loss differences "
              + ", ".join(f"{x:.3e}" for x in rel)
              + f" (bitwise equal: {result[tag][0]['losses'] == barrier})")
        smoke.check(rel[0] <= smoke.PS_STEP1_TOL,
                    f"{tag}: step 1 differs from the barrier's by {rel[0]}")
        smoke.check(max(rel[1:]) <= smoke.PS_LOSS_TOL,
                    f"{tag}: a later loss differs from the barrier's by {max(rel[1:])}")
    for name, runs in result.items():
        pooled = statistics.median(x for r in runs for x in r["steps_ms"])
        print(f"{name}: {pooled:.2f} ms a step (median of steps 2-{PS_STEPS} of {len(runs)} "
              f"run(s)), peak memory {runs[0]['peak_gb']:.2f} GB")
    return result


def compare_ps_allreduce(ps_runs, ar_runs):
    """The default builder against AllReduce on the same cards, each run
    twice in turns (PS, AllReduce, AllReduce, PS): the median of each
    builder's pooled steps, and the losses of their first runs."""
    ps, ar = ps_runs[0], ar_runs[0]
    medians = [statistics.median(x for r in runs for x in r["steps_ms"])
               for runs in (ps_runs, ar_runs)]
    rel = [abs(a - b) / abs(b) for a, b in zip(ps["losses"], ar["losses"])]
    print(f"PSLoadBalancing {medians[0]:.2f} ms vs AllReduce (NoneCompressor) "
          f"{medians[1]:.2f} ms a step (median of steps 2-{PS_STEPS} of two runs each, "
          f"in turns; run medians {[round(r['step_ms'], 2) for r in ps_runs]} and "
          f"{[round(r['step_ms'], 2) for r in ar_runs]}); losses: step 1 relative "
          f"difference {rel[0]:.3e}, largest later {max(rel[1:]):.3e}")
    smoke.check(rel[0] <= smoke.PS_STEP1_TOL, f"ps: step 1 differs from AllReduce by {rel[0]}")
    smoke.check(max(rel[1:]) <= smoke.PS_LOSS_TOL,
                f"ps: a later loss differs from AllReduce's by {max(rel[1:])}")


SHARDED_MODES = {   # tag -> (AllReduce options, step 1 tolerance against one process)
    "AllReduce": ({}, smoke.LOSS_REL_TOL),
    "AllReduce(sharded_update)": ({"sharded_update": "sharded"}, smoke.LOSS_REL_TOL),
    "AllReduce(bf16_master)": ({"precision": "bf16_master"}, smoke.BF16_MASTER_TOL),
}


def one_process_loss(torch, world_size):
    """The global batch's loss (8 sequences per rank) in this process, on
    the dense path, under ``no_grad``: what step 1 must reproduce."""
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    loss_fn, params, _ = gpt_capture(GPTConfig(), smoke.SEQ, seed=0)
    batch = smoke.gpt2_batch(GPTConfig(), smoke.BATCH * world_size)
    with torch.no_grad():
        loss = loss_fn(params, {n: torch.from_numpy(a).cuda() for n, a in batch.items()})
    loss = loss.item()
    del loss_fn, params
    torch.cuda.empty_cache()
    return loss


def compare_sharded(torch, ads, modules, world_size):
    """``AllReduce()``, its sharded update and its bf16 master (``ads`` in
    SHARDED_MODES' order) in turns, 0 1 2 2 1 0: each run's step 1 against
    one process's loss, the sharded update's losses against AllReduce's;
    returns the runs by mode."""
    flat_loss = one_process_loss(torch, world_size)
    names = list(SHARDED_MODES)
    result = {name: [] for name in names}
    for i in (0, 1, 2, 2, 1, 0):
        result[names[i]].append(train_gpt2_sync(
            torch, ads[i], modules, names[i], flat_loss, SHARDED_MODES[names[i]][1]))
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(
        result["AllReduce(sharded_update)"][0]["losses"], result["AllReduce"][0]["losses"])]
    print(f"sharded update vs AllReduce: step 1 relative difference {rel[0]:.3e}, "
          f"largest later {max(rel[1:]):.3e}")
    smoke.check(rel[0] <= smoke.PS_STEP1_TOL, f"sharded: step 1 differs from AllReduce by {rel[0]}")
    smoke.check(max(rel[1:]) <= smoke.PS_LOSS_TOL,
                f"sharded: a later loss differs from AllReduce's by {max(rel[1:])}")
    for name, runs in result.items():
        pooled = statistics.median(x for r in runs for x in r["steps_ms"])
        print(f"{name}: {pooled:.2f} ms a step (median of steps 2-{PS_STEPS} of two runs, in "
              f"turns), peak memory {runs[0]['peak_gb']:.2f} GB, per rank "
              f"{runs[0]['shard_bytes'] / 1e9:.3f} GB of flat shards and "
              f"{runs[0]['opt_bytes'] / 1e9:.3f} GB of optimizer state")
    return result


PARTITIONED_BUILDERS = ("Parallax", "PartitionedPS")
STALE_S, ASYNC_S, ASYNC_STEPS, ASYNC_DELAY = 2, 1, 3, 0.05


def train_ncf_ranks(torch, ad, tag, modules):
    """One NCF run of the ``partitioned`` mode on this rank, checked."""
    result, sess = smoke.train_ncf(torch, ad, tag, modules,
                                   rows=smoke.NCF_BATCH * ad.world.size)
    bad = sess.check_replication()
    smoke.check(bad == [], f"{tag}: check_replication() names {bad}")
    full = sess.transformer.canonical_params(sess.state)
    smoke.check(smoke.same_on_every_rank(torch, list(full.values()), sess.transformer.group),
                f"{tag}: the ranks hold different parameters")
    print(f"{tag}: all {ad.world.size} ranks hold the same parameters")
    del sess, full
    torch.cuda.empty_cache()
    return result


def compare_partitioned(torch, ads, modules, world_size):
    """NCF under Parallax and PartitionedPS (``ads`` in PARTITIONED_BUILDERS'
    order) in turns, 0 1 1 0: step 1 of each against one process's dense
    loss of the global batch and the other's; returns the runs."""
    dense = smoke.ncf_dense_loss(torch, smoke.NCF_BATCH * world_size)
    result = {name: [] for name in PARTITIONED_BUILDERS}
    for i in (0, 1, 1, 0):
        name = PARTITIONED_BUILDERS[i]
        result[name].append(train_ncf_ranks(torch, ads[i], f"NCF {name}", modules))
    smoke.check_ncf_step1({name: runs[0] for name, runs in result.items()}, dense)
    for name, runs in result.items():
        pooled = statistics.median(x for r in runs for x in r["steps_ms"])
        print(f"NCF {name}: {pooled:.3f} ms a step (median of steps 2-{smoke.NCF_STEPS} of two "
              f"runs, in turns), peak memory {runs[0]['peak_gb']:.3f} GB")
    return result


def train_stale(torch, ads, modules, world_size):
    """The ``stale`` mode: DIVERGENT GPT-2 small, then the cluster session."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization.async_service import (
        AsyncPSClusterSession)
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    flat_loss = one_process_loss(torch, world_size)
    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, smoke.SEQ, seed=0)
    batch = smoke.gpt2_batch(config, smoke.BATCH * world_size)
    tag = f"PS(staleness={STALE_S})"
    sess = ads[0].distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                             has_rng=True)
    t = sess.transformer
    smoke.check(len(t.divergent_names) == len(t.names) and not t.buckets,
                f"{tag}: expected every variable DIVERGENT")
    for km in modules:
        km.reset_launches()
    losses, same, step_ms = [], [], []
    for _ in range(PS_STEPS):
        t0 = time.perf_counter()
        losses.append(sess.run(batch)["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        same.append(smoke.same_on_every_rank(torch, list(sess.state["params"].values()),
                                             t.group))
    launches = {n: c for km in modules for n, c in km.LAUNCHES.items()}
    rel = abs(losses[0] - flat_loss) / abs(flat_loss)
    print(f"{tag} losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{tag}: median step {statistics.median(step_ms[1:]):.2f} ms (steps 2-{PS_STEPS}; "
          f"steps " + ", ".join(f"{x:.2f}" for x in step_ms) + " ms); copies equal on "
          f"every rank after each step: {same}; step 1 relative difference from one "
          f"process {rel:.3e}")
    smoke.check(rel <= smoke.LOSS_REL_TOL, f"{tag}: step 1 differs from one process's by {rel}")
    smoke.check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                f"{tag}: losses {losses}")
    smoke.check(same == [False, False, True, False, False],
                f"{tag}: expected equal copies only after step 3's average, got {same}")
    smoke.check(sess.check_replication() == [], f"{tag}: check_replication() names variables")
    want = smoke.flash_launches(config, PS_STEPS)
    smoke.check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    full = sess.params()
    smoke.check(smoke.same_on_every_rank(torch, [v.cuda() for v in full.values()], t.group),
                f"{tag}: params() differs between the ranks")
    result = {"divergent": {"losses": losses, "step_ms": step_ms, "same": same}}
    del sess, t, full
    torch.cuda.empty_cache()

    world = ads[1].world
    os.environ["AUTODIST_ASYNC_PS_ADDR"] = "127.0.0.1:0"   # the chief takes any port
    try:
        sess = ads[1].distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                                 has_rng=True)
    finally:
        del os.environ["AUTODIST_ASYNC_PS_ADDR"]
    smoke.check(isinstance(sess, AsyncPSClusterSession),
                f"async: expected the cluster session, got {type(sess).__name__}")
    rows = slice(world.rank * smoke.BATCH, (world.rank + 1) * smoke.BATCH)
    mine = {k: v[rows] for k, v in batch.items()}
    for km in modules:
        km.reset_launches()
    t0 = time.perf_counter()
    sess.run([mine], ASYNC_STEPS, delay=ASYNC_DELAY if world.rank == world_size - 1 else 0.0,
             timeout=300)
    run_s = time.perf_counter() - t0
    sess.wait_all(ASYNC_STEPS, timeout=300)
    stats = sess.stats()
    launches = {n: c for km in modules for n, c in km.LAUNCHES.items()}
    full = sess.params()
    losses = [loss for _, _, loss in sess.history]
    print(f"async cluster: rank {world.rank} losses " + ", ".join(f"{x:.6f}" for x in losses)
          + f", {run_s:.2f} s for {ASYNC_STEPS} steps; server stats {stats}")
    smoke.check(stats["version"] == ASYNC_STEPS * world_size, f"async: stats {stats}")
    smoke.check(stats["max_lead_seen"] <= ASYNC_S, f"async: lead over the bound: {stats}")
    smoke.check(all(math.isfinite(x) for x in losses), f"async: losses {losses}")
    want = smoke.flash_launches(config, ASYNC_STEPS)
    smoke.check(launches == want, f"async: expected launches {want}, got {launches}")
    smoke.check(smoke.same_on_every_rank(torch, [v.cuda() for v in full.values()],
                                         world.group),
                "async: the ranks pulled different parameters")
    torch.distributed.barrier()   # every rank has pulled: the chief may stop serving
    sess.close()
    print(f"async cluster: every rank pulled the chief's parameters; "
          f"{stats['stale_pushes']} stale pushes of {stats['version']}")
    result["async"] = {"losses": losses, "run_s": run_s, "stats": stats}
    return result


RESHARD_FROM, RESHARD_SAVE_STEP = 4, 5
RESHARD_DIR = os.path.join(smoke.CKPT_DIR, "reshard")


def train_reshard(torch, ad, modules, world_size):
    """The ``reshard`` mode: at RESHARD_FROM ranks train and save after
    step RESHARD_SAVE_STEP; at fewer, reshard that checkpoint and hold the
    later steps against the saving run's."""
    import shutil

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint import manifest
    from autodist_tpu_torch.checkpoint.reshard import reshard_restore
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, smoke.SEQ, seed=0)
    batch = smoke.gpt2_batch(config, smoke.BATCH * RESHARD_FROM)   # one global batch at any R
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    rank, group = ad.world.rank, sess.transformer.group
    path = os.path.join(RESHARD_DIR, "ckpt")
    tag = f"reshard R={world_size}"

    def launches():
        return {n: c for km in modules for n, c in km.LAUNCHES.items()}

    for km in modules:
        km.reset_launches()
    if world_size == RESHARD_FROM:
        if rank == 0:
            shutil.rmtree(RESHARD_DIR, ignore_errors=True)
            os.makedirs(RESHARD_DIR)
        torch.distributed.barrier()
        losses = []
        for step in range(smoke.STEPS):
            losses.append(sess.run(batch)["loss"].item())
            if step + 1 == RESHARD_SAVE_STEP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Saver(sess).save_sharded(path)
                save_s = time.perf_counter() - t0
        nbytes = smoke.dir_bytes(path)
        m = manifest.load_manifest(path)
        print(f"{tag} losses: " + ", ".join(f"{x:.6f}" for x in losses))
        print(f"{tag}: save_sharded after step {RESHARD_SAVE_STEP}: {save_s:.3f} s, "
              f"{nbytes / 1e9:.3f} GB, {nbytes / save_s / 1e9:.3f} GB/s over {world_size} "
              f"ranks; manifest {m['layout']} step {m['step']} R={m['num_replicas']}")
        smoke.check(m["layout"] == "update_space" and m["step"] == RESHARD_SAVE_STEP
                    and m["num_replicas"] == world_size, f"{tag}: manifest {m}")
        if rank == 0:
            with open(os.path.join(RESHARD_DIR, "losses.json"), "w") as f:
                json.dump(losses, f)
        result = {"losses": losses, "save_s": save_s, "bytes": nbytes}
        steps = smoke.STEPS
    else:
        with open(os.path.join(RESHARD_DIR, "losses.json")) as f:
            saved = json.load(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reshard_restore(sess, path, verify=False)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        smoke.check(sess.step == RESHARD_SAVE_STEP, f"{tag}: restored at step {sess.step}")
        losses = [sess.run(batch)["loss"].item() for _ in range(smoke.STEPS - RESHARD_SAVE_STEP)]
        want = saved[RESHARD_SAVE_STEP:]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        nbytes = smoke.dir_bytes(path)
        print(f"{tag}: reshard_restore of the R={RESHARD_FROM} checkpoint: {restore_s:.3f} s, "
              f"{nbytes / 1e9:.3f} GB, {nbytes / restore_s / 1e9:.3f} GB/s (every rank reads "
              f"it all)")
        print(f"{tag} steps {RESHARD_SAVE_STEP + 1}-{smoke.STEPS}: "
              + ", ".join(f"{x:.6f}" for x in losses) + f"; the R={RESHARD_FROM} run's "
              + ", ".join(f"{x:.6f}" for x in want) + f"; relative {rel[0]:.3e} at step "
              f"{RESHARD_SAVE_STEP + 1}, largest after {max(rel[1:]):.3e}")
        smoke.check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
        smoke.check(rel[0] <= smoke.PS_STEP1_TOL and max(rel[1:]) <= smoke.PS_LOSS_TOL,
                    f"{tag}: losses {losses} against the R={RESHARD_FROM} run's {want}")
        result = {"losses": losses, "want": want, "rel": rel, "restore_s": restore_s,
                  "bytes": nbytes}
        steps = smoke.STEPS - RESHARD_SAVE_STEP
    got = launches()
    want_launches = smoke.flash_launches(config, steps)
    smoke.check(got == want_launches, f"{tag}: expected launches {want_launches}, got {got}")
    full = sess.transformer.canonical_params(sess.state)
    smoke.check(smoke.same_on_every_rank(torch, list(full.values()), group),
                f"{tag}: the ranks hold different parameters")
    print(f"{tag}: all {world_size} ranks hold the same parameters; launches {got}")
    if world_size != RESHARD_FROM:
        torch.distributed.barrier()
        if rank == 0:
            shutil.rmtree(RESHARD_DIR, ignore_errors=True)
    return result


def main(argv):
    import torch

    if len(argv) != 1 or argv[0] not in (*smoke.CODECS, "ring", "ps", "sharded", "sync",
                                         "partitioned", "stale", "reshard"):
        print(__doc__ + f"\nCODEC is one of {list(smoke.CODECS)}", file=sys.stderr)
        return 2
    mode = argv[0]
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size < 2 or (mode in ("ring", "sync") and world_size % 2):
        print("FAIL: run under torchrun with --nproc-per-node >= 2 (even for ring and sync)",
              file=sys.stderr)
        return 1
    if mode in ("ring", "ps", "sharded", "sync", "partitioned", "stale"):   # several AutoDists
        os.environ["AUTODIST_IS_TESTING"] = "1"
    m = smoke.setup(torch)
    if m is None:
        return 1
    from autodist_tpu_torch.resource_spec import ResourceSpec

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    nodes = [{"address": "localhost", "gpus": list(range(world_size)), "chief": True}]
    if mode == "ring":   # (mesh, strategy builder) of each AutoDist
        runs = [({"replica": 1, "seq": world_size}, m["AllReduce"]()),
                ({"replica": world_size // 2, "seq": 2}, m["AllReduce"]())]
    elif mode == "ps":   # the default builder, then AllReduce
        runs = [(None, None), (None, m["AllReduce"]())]
    elif mode == "sharded":
        runs = [(None, m["AllReduce"](**opts)) for opts, _ in SHARDED_MODES.values()]
    elif mode == "sync":
        runs = [(None if mesh is None else {"replica_dcn": 2, "replica_ici": world_size // 2},
                 m["AllReduce"](**opts)) for _, mesh, opts in SYNC_RUNS]
    elif mode == "partitioned":
        from autodist_tpu_torch import strategy

        runs = [(None, strategy.Parallax()),
                (None, strategy.PartitionedPS(max_shards=smoke.PART_MAX_SHARDS))]
    elif mode == "stale":
        from autodist_tpu_torch import strategy

        runs = [(None, strategy.PS(staleness=STALE_S)),
                (None, strategy.PS(sync=False, staleness=ASYNC_S))]
    elif mode == "reshard":   # the default builder
        runs = [(None, None)]
    else:
        runs = [(None, m["AllReduce"](compressor=mode))]
    ads = [m["AutoDist"](resource_spec=ResourceSpec(resource_info=dict(
        {"nodes": nodes}, **({"mesh": mesh} if mesh else {}))), strategy_builder=builder)
        for mesh, builder in runs]
    rank = ads[0].world.rank   # joins the process group
    if rank == 0:
        m["build"].build(list(smoke.SOURCES))
    else:
        sys.stdout = open(os.devnull, "w")
    torch.distributed.barrier()
    print(f"{world_size} ranks, torch {torch.__version__}, {torch.cuda.get_device_name()}")
    if rank == 0:   # every card's name and power limit
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
    modules = (m["fa"], m["fn"], m["tq"])
    try:
        if mode == "ring":
            result = {"ring": [train_gpt2_mesh(torch, ad, modules) for ad in ads]}
        elif mode == "ps":   # in turns: PS, AllReduce, AllReduce, PS
            names = ("PSLoadBalancing", "AllReduce")
            by_builder = {name: [] for name in names}
            for i in (0, 1, 1, 0):
                by_builder[names[i]].append(train_gpt2_sync(torch, ads[i], modules,
                                                             names[i]))
                torch.cuda.empty_cache()
            compare_ps_allreduce(by_builder["PSLoadBalancing"], by_builder["AllReduce"])
            result = {"ps": by_builder["PSLoadBalancing"],
                      "all_reduce": by_builder["AllReduce"]}
        elif mode == "sharded":
            result = compare_sharded(torch, ads, modules, world_size)
        elif mode == "sync":
            result = compare_sync(torch, ads, modules)
        elif mode == "partitioned":
            result = compare_partitioned(torch, ads, modules, world_size)
        elif mode == "stale":
            result = train_stale(torch, ads, modules, world_size)
        elif mode == "reshard":
            result = train_reshard(torch, ads[0], modules, world_size)
        else:
            result = smoke.train_gpt2_codec(torch, ads[0], mode, modules)
    except smoke.SmokeFailure as e:
        print(f"FAIL (rank {rank}): {e}", file=sys.stderr, flush=True)
        return 1
    print("RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
