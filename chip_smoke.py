#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc::

    python3 chip_smoke.py

Phases (each failure exits non-zero before the last line):

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the kernels from ``autodist_tpu_torch/csrc`` (flash attention,
   fused norm and quantize, one ``nvcc`` each, started together) and prints
   the time, and each instantiation of the bf16 backward kernels
   (``wgmma_dq_kernel``, ``wgmma_dkdv_kernel``) with its registers and
   spills from ``-Xptxas -v``;
3. holds each flash kernel (forward, dq, dkdv) against its plain PyTorch
   version on the same bf16 inputs, the plain version computing in f32, at
   the GPT-2-small attention shape at phase 5's B=8 and at phase 13's
   B=32 (BH=384, four times the persistent grid's work items), a GQA case, a key-padding case with
   fully masked rows and a ragged S = 1000, and at the shapes that test
   the bf16 kernels' TMA tiles and wgmma layouts: D = 128 (two 64-column
   boxes a tile), D = 32 and D = 40 (boxes zero-filled past D), D = 36 (the
   wrapper's zero padding to a multiple of 8), a grid smaller than the
   card (B=1, H=2, S=128), S = 1000 with GQA, and causal key padding at
   S = 1000 (the bias row beside the diagonal's mask); every case but the
   two of key padding has no bias row, as the model's path.  Then times kernel, plain
   version and the library yardstick (used nowhere in the port) and
   computes each kernel's bound at the GPT-2-small shape: for the forward
   ``scaled_dot_product_attention``'s forward, for dq and dkdv its
   backward alone (the forward's fwd + bwd time is printed beside it);
4. holds the fused-norm kernels (``bn_fwd``, ``gn_fwd``) against their plain
   versions run in f32 on the same inputs: batch norm in bf16 at the
   ResNet-50 stem site (256, 112, 112, 64) (run twice: the two runs must be
   bitwise equal) and at a stage-4 site (256, 7, 7, 2048), in f32 and bf16
   at rows = 1000, C = 100 with residual and relu; group norm (G = 32) in
   bf16 at the gn path's own sites at B=256, the stem (256, 112, 112, 64)
   and stage 1 (256, 56, 56, 256) (each run twice: bitwise equal) and
   stage 4 (256, 7, 7, 2048), at B=64 (64, 56, 56, 256) and (64, 56, 56,
   64), in f32 at an odd (3, 37, 30), G = 10, with residual and relu.
   Then times kernel, plain version, ``F.batch_norm(training=True)`` /
   ``F.group_norm`` on the same channels-last tensor (the library
   yardsticks) and the bound at the two batch-norm shapes above and at
   (256, 56, 56, 256) and (64, 56, 56, 256) for group norm;
5. trains GPT-2 small at full width (GPTConfig(): 12 layers, hidden 768, 12
   heads, vocab 50257) through ``AutoDist(..., AllReduce()).distribute``
   for 10 steps at B=8, S=1024 on one seeded token batch, checks the
   losses and that every step launched each flash kernel once per layer
   (and no norm kernel), and holds step 1's loss against the kernel-free
   plain attention path;
6. trains ResNet-50 at full width (224x224, 1000 classes, ``norm="bn_fused"``)
   through ``classifier_capture`` and ``distribute(..., mutable_state=...)``
   for 10 ``sgd_momentum(0.1)`` steps at B=256 on one seeded batch put on
   the card once (images bf16, labels int64); checks finite losses, the
   mean of the last three below the first, step 1's loss against the same
   model with its norms set to ``impl="reference"`` (the plain versions), 53
   ``bn_fwd`` launches per step (and no other kernel), and batch
   statistics that are finite and moved; prints step ms, images/s, peak
   memory and the profile;
7. the same with ``norm="gn"`` for 5 steps: 53 ``gn_fwd`` launches per step;
8. (after phase 4) holds the int8 quantization kernels (``quantize_int8``,
   ``dequant_sum``, ``equarx_hop``) bitwise against their plain versions:
   ``quantize_int8`` at GPT-2 small's two bucket sizes (286,110 and 199,983
   blocks of 256) and at N = 1001 blocks with an all-zero block, a block of
   half-step ties and a NaN block (its scale NaN and its q 0 in both);
   ``dequant_sum`` and ``equarx_hop`` with D = 1, 2, 3, 4, 8 peers at the
   first bucket's size (the hop's three mean modes: none, times 2^-k, IEEE
   division), D = 4 at the 4-GPU path's chunk (71,528 blocks) and D = 3 at
   N = 1001, each with ``hop_case``'s edge blocks, which reach both of the
   hop's division paths (ties of the mean, subnormal and tiny requantized
   scales, +-inf, NaN, zeros and -0), and the EQuARX contract
   (``equarx_hop(q, s, D)`` bitwise equal to ``quantize_int8(dequant_sum(q,
   s) / D)``, kernels on both sides).  Then times kernel and plain version
   against the bound at the first bucket's size: ``quantize_int8``,
   ``dequant_sum`` at D = 1 and 8, ``equarx_hop`` at D = 1, 2, 4 and 8, and
   ``equarx_hop`` at D = 4 over the 4-GPU chunk;
9. trains GPT-2 small as in phase 5 under ``AllReduce(compressor=...)`` for
   each of ``Int8Compressor``, ``Int8CompressorEF`` and
   ``EquarxInt8Compressor``, 5 steps each, each in a process of its own
   (``chip_smoke.py --codec NAME``: ``AutoDist`` is one instance per
   process), one after another on the card: holds step 1's synced
   gradients (and EF residuals) through the kernels bitwise against the
   same codec's plain versions on the same CUDA gradients, times the sync,
   checks finite losses whose last three average below the first, and the
   launches per step (Int8: 4 ``quantize_int8`` + 2 ``dequant_sum``; EF: 6 +
   2; EQuARX: 2 ``quantize_int8`` + 2 ``equarx_hop``; 12 of each flash
   kernel); prints step ms, tokens/s, peak memory, and the Int8 and EQuARX
   profiles;
10. (after phase 3) holds the ring-attention kernels on one card as a
   "virtual ring": at the GPT-2 shape (B=8, H=12, S=1024, D=64, causal)
   S splits into n = 4 blocks of 256 (and again into n = 2 blocks of 512,
   the seq row of ``{replica: 2, seq: 2}``), and each q block folds the
   K/V blocks in ring order, ``(i - t) mod n`` at step t, through
   ``flash_block_update`` at their global offsets, from the carry (floor,
   0, 0).  Each step's
   carry is held against ``flash_block_update_plain`` on the same carry, a
   future block must leave the carry bitwise unchanged (m clamped at the
   floor), and the normalised result against ``flash_fwd`` over the whole
   sequence and against the plain versions' own ring.  The backward: the
   offset ``flash_dq`` / ``flash_dkdv`` of every (q block, k block) pair
   summed per block against the full-sequence kernels, a future pair's
   partials exactly zero.  In bf16 and in f32.  Then the main path's own
   block, the ring of one (BH=96, 1024 x 1024, causal, offsets 0, bf16):
   ``flash_block_update`` against its plain version from the (floor, 0, 0)
   carry and from a random one, at the carry tolerances above (the kernels
   line's ``max_abs_err`` is this block's normalised output from the floor
   carry), and a D = 128 block (B=2, H=12, 1024 x 1024) from both carries.
   Then (after phase 3's
   timings) times ``flash_block_update``, its plain version and its bound
   at the ring-of-one block (BH=96, 1024 x 1024, causal, offsets 0; the
   kernels line) and at a ring-of-4 past block (96, 256 x 256, no masked
   key), and the offset ``flash_dq`` / ``flash_dkdv`` at that past block;
11. trains GPT-2 small as in phase 5 (10 adamw steps, B=8, S=1024) under
   ``mesh: {replica: 1, seq: 1}``, sequence parallelism on a ring of one,
   in a process of its own (``chip_smoke.py --ring LOSS``): finite losses
   that fall, step 1's loss within 1e-3 of phase 5's flat-path loss
   (``LOSS``) and of the same step through the plain ring
   (``attention_impl="xla"``), and per step 12 ``flash_block_update``, 12
   ``flash_dq``, 12 ``flash_dkdv`` and no ``flash_fwd``; prints step ms,
   tokens/s, peak memory and the profile;
12. trains GPT-2 small as in phase 5 (10 adamw steps, B=8, S=1024, phase
   5's weights and batch) under the default builder, ``AutoDist(
   resource_spec=...)`` with no strategy builder (``PSLoadBalancing``: the
   gradients reduce-scattered, the flat shards updated, the shards
   all-gathered), in a process of its own (``chip_smoke.py --ps LOSSES``,
   LOSSES phase 5's ten losses as a JSON list): every node a
   ``PSSynchronizer`` on the chief's first GPU; step 1's loss within 1e-5
   relative of phase 5's (same parameters, same forward) and steps 2-10
   within 1e-3 (at R = 1 PS and AllReduce compute the same elementwise
   adamw; it prints the largest difference and whether the losses are
   bitwise equal); finite losses whose last three average below the
   first; per step 12 ``flash_fwd``, 12 ``flash_dq``, 12 ``flash_dkdv``
   and no other kernel; then ``fit`` to step 12 and ``check_replication()
   == []``; prints step ms, tokens/s, peak memory, the profile and the PS
   sync's device time (pack -> scatter -> shard update -> gather ->
   write-back, and its three parts).  A second session on the same
   ``AutoDist`` with ``accum_steps=2`` and ``clip_global_norm=1.0``, 3
   steps: step 1's loss within 1e-3 relative of phase 5's (the mean over 2
   microbatches of 4), a finite positive ``grad_norm``, 24 launches a step
   of each flash kernel;
13. trains GPT-2 small as ``bench.py`` trains it, in a process of its own
   (``chip_smoke.py --bench-gpt PHASE5``, PHASE5 phase 5's losses and peak
   memory as JSON): ``GPTConfig(remat=True)``,
   ``gpt_capture(streaming_loss=True)`` (the cross entropy over vocab
   chunks of 8192, no logits), ``AllReduce()``, adamw(3e-4), phase 5's
   weights, 32 seeded sequences of 1024, 10 steps: step 1's loss within
   1e-4 relative of the dense head's (the non-streaming ``loss_fn`` on the
   same weights and batch under ``no_grad``) and within 1e-3 of the same
   dense head through the kernel-free plain attention (``attention_impl=
   "xla"``, as phase 5 holds its step 1), finite losses that fall, per
   step 24 ``flash_fwd`` (12 of them remat's recompute), 12 ``flash_dq``,
   12 ``flash_dkdv`` and no other kernel; prints step ms, tokens/s, peak
   memory and the profile.  Then 3 steps at phase 5's B=8 batch with the
   same options: step 1's loss within 1e-4 relative of phase 5's, and
   their peak memory beside phase 5's;
14. trains GPT-2 small as in phase 5 (B=8, 10 adamw steps, phase 5's
   weights and batch) in a process of its own (``chip_smoke.py --sharded
   PHASE5``), under ``AllReduce(sharded_update="sharded")``: losses within
   1e-5 relative of phase 5's at step 1 and 1e-3 after (it prints whether
   they are bitwise equal); and under ``AllReduce(precision=
   "bf16_master")``: step 1 within 2e-2 relative (JAX's
   ``BF16_MASTER_TOL``), finite losses whose last three average below the
   first, every ``params()`` leaf f32.  Both: 12 launches a step of each
   flash kernel, ``check_replication() == []``; prints step ms, peak
   memory, the profile and the sync's device time by parts (reduce-scatter,
   adamw on the shards, parameter all-gather; for the bf16 master the
   top-of-step bf16 gather);
15. trains GPT-2 small as in phase 5 (B=8, adamw, phase 5's weights and
   batch) in a process of its own (``chip_smoke.py --sync-variants
   PHASE5``), one ``AutoDist`` each: (a) ``AllReduce(schedule="overlap")``,
   10 steps: each bucket's sync issued from the backward pass's hooks, in
   reverse bucket order, in ``_chunk_sizes`` chunks of 32 MiB (9 and 7 for
   the two f32 buckets; the last step's issue record is checked), losses
   within 1e-5 / 1e-3 relative of phase 5's (at R = 1 every chunk reduces
   by the identity; it prints whether they are bitwise equal), and the
   after-backward sync's device time, chunked and barrier; (b) the same
   with ``accum_steps=2``, 3 steps: step 1 within 1e-3 relative of phase
   5's, 24 launches a step of each flash kernel; (c)
   ``AllReduce(hierarchy="two_level")`` on ``mesh: {replica_dcn: 1,
   replica_ici: 1}``, 5 steps, within 1e-5 / 1e-3 of phase 5's (bitwise
   printed); (c') the same with ``dcn_compressor="EquarxInt8Compressor"``,
   5 steps: step 1's synced gradients through the kernels bitwise equal to
   the codec's plain versions, 2 ``quantize_int8`` + 2 ``equarx_hop`` a
   step, losses finite and falling; (d) ``AllReduce(compressor=
   "Int8Compressor", schedule="overlap")``, 3 steps: the hooks' synced
   gradients bitwise equal to the barrier schedule's (kernels on both
   sides), 4 ``quantize_int8`` + 2 ``dequant_sum`` a step; (e)
   ``compressor="PowerSGDCompressor"``, 5 steps, finite losses; at step 1,
   per bucket, ``approx + residual`` within 1e-6 of the corrected buffer
   (relative to its largest magnitude), ``P^T P = I`` within 1e-5, and
   ``approx`` within 1e-4 relative of the same iteration run in f64 from the
   same M and Q, and the sync's device time split into the GEMMs, the QR
   and the residual.  Every variant: 12 launches a step of each flash
   kernel (24 with accumulation), ``check_replication() == []``, and its
   step ms, tokens/s, peak memory and profile;
16. the synchronous PS family, in a process of its own (``chip_smoke.py
   --partitioned PHASE5``), one ``AutoDist`` each: GPT-2 small as in phase
   5 (B=8, 10 adamw steps, phase 5's weights and batch) under
   ``PartitionedPS(max_shards=8)`` and ``PartitionedAR(max_shards=8)``
   (every variable whose dim 0 has a divisor <= 8 partitioned: SHARDED
   storage, here over one replica), losses within 1e-5 / 1e-3 relative of
   phase 5's (bitwise equality printed), 12 launches a step of each flash
   kernel; then NCF at full width (``NCFConfig()``: 138,000 users, 27,000
   items, ``mf_dim`` 64, MLP 256-128-64, ~31.8 M parameters) as
   ``examples/benchmark.py`` runs it (batch 64, adam(1e-3), seeded
   batch), 10 steps under ``Parallax()`` (the four tables sparse PS
   variables, the MLP AllReduce) and under ``PartitionedPS(max_shards=8)``
   with the four tables in ``sparse_vars`` (the tables split on dim 0,
   looked up through ``ShardedTable``'s row exchange): step 1's loss
   within 1e-5 between the two and of one process's dense loss on the same
   weights and batch, finite losses, no launch of the nine kernels; prints
   each run's losses, median step, peak memory, the card's name and power
   limit, and each NCF run's profile;
17. bounded staleness, in a process of its own (``chip_smoke.py --stale
   PHASE5``), one ``AutoDist`` each: (a) GPT-2 small as in phase 5 (B=8,
   10 adamw steps, phase 5's weights and batch) under ``PS(staleness=2)``
   at R = 1: every non-scalar variable DIVERGENT (its own copy, averaged
   every 3 steps: at R = 1 the identity, no collective), losses within
   1e-5 relative of phase 5's at step 1 and 1e-3 after (bitwise equality
   printed), 12 launches a step of each flash kernel; (b) ``distribute``
   with ``PS(sync=False, staleness=1)``: the async engine session with one
   worker thread on the card, 3 steps, step 1's loss within 1e-5 relative
   of phase 5's; (c) ``AsyncPSSession`` with two workers on ``cuda:0``
   (each its own CUDA stream), delays ``[0, 0.05]`` s, 3 steps each:
   ``version == 6``, the lead at most 1, at least one stale push, finite
   losses.  (b) and (c): 12 launches a step of each flash kernel.  Prints
   each push's host copy and host update times, each worker's step time,
   the peak memory, and the card's name and power limit;
18. checkpoints, in a process of its own (``chip_smoke.py --ckpt
   PHASE5``), one ``AutoDist`` a session, GPT-2 small as in phase 5 (B=8,
   adamw, phase 5's weights and batch) under the default builder
   (``PSLoadBalancing``: the optimizer state on flat shards), the
   checkpoints in the checkout's ``_ckpt/`` (removed at the end): (a)
   ``fit(batch_fn, 10, checkpoint_path=..., save_every=5)``, its losses
   within 1e-5 relative of phase 5's at step 1 and 1e-3 after (bitwise
   equality printed), a canonical save at steps 5 and 10 (the step-5 one
   kept by hard links); (b) a fresh session's ``fit(..., 10)`` resumes
   from step 5, steps 6-10 bitwise (a)'s; (c) ``save_sharded`` at step
   10 restored into a fresh session, whose step-11 loss is bitwise the
   saving session's; (d) ``run_steps(..., preempt_checkpoint_dir=...)``
   with SIGTERM sent to the process from the batches before step 4:
   ``preempted``, an ``update_space`` manifest at step 4, and a re-run's
   ``fit(..., 6, preempt_checkpoint_dir=...)`` steps 5-6 bitwise (a)'s;
   (e) ``Saver.restore_single_device`` of the step-10 checkpoint into a
   plain ``models.gpt.GPT`` on the card (flash attention): its loss on
   the batch within 1e-6 relative of the session's step-11 loss (bitwise
   printed).  12 launches a step of each flash kernel in (a) and (b);
   prints each save's and restore's seconds, bytes and GB/s, the cost of
   the periodic saves a step, and the card's name and power limit;
19. elastic training, in a process of its own (``chip_smoke.py --elastic
   PHASE5``), GPT-2 small as in phase 18 (B=8, adamw, phase 5's weights
   and batch) under the default builder, the checkpoints in ``_ckpt/``
   (removed at the end): (a) ``ElasticTrainer(..., verify_restore=False,
   chaos="delay@2:0.2;kill_worker@3").fit(batch_fn, 10)``: on one GPU the
   default kill keeps ``gpus[:max(1, 1 // 2)]``, so the membership change
   (drain, ``save_sharded``, ``shrink``, epoch 1, ``rebind``,
   ``distribute``, ``reshard_restore``) runs at R = 1 -> 1: ``replans ==
   1``, ``epoch == 1``, the ten losses bitwise phase 5's; (b)
   ``chaos="preempt@4"``: SIGTERM before step 5, ``preempted``, an
   ``update_space`` manifest at step 4, and a fresh trainer's ``fit(...,
   6)`` resumes from it, its steps 5-6 bitwise (a)'s; (c) ``chaos="nan@3"``
   (the batch's token ids poisoned, read as NaN rows) with an
   ``on_anomaly`` hook: the hook fires once, at step 3; (d) ``ad.launch``
   on the one-GPU spec degrades to ``distribute``: its step-1 loss bitwise
   phase 5's.  12 launches a step of each flash kernel in (a), (b) and
   (d); prints the membership change's seconds (drain, save, shrink,
   rebind and distribute, restore), each save's and restore's GB/s, the
   peak memory, and the card's name and power limit;
20. prints the ``{"kernels": [...]}`` line (nine kernels), then the
   ``{"ok": true, ...}`` line.

Tolerances, kernel vs plain version on the same inputs.  Flash, bf16
inputs (the tensor-core kernels; plain version in f32): out max-abs <= 1e-2
* max(1, max|out|) (bf16 rounding of the output), lse max-abs <= 1e-3, dq,
dk, dv relative Frobenius error <= 1e-2.  f32 inputs (the FMA kernels):
1e-4 in place of each 1e-2 and 1e-3 (f32 sums in another order).  The
virtual ring: the same, and each step's carry m max-abs <= 1e-3, l and o
relative Frobenius <= 1e-2 (1e-4 each in f32).  The ring-of-one run: step
1's loss within 1e-3 (absolute) of the flat path's and the plain ring's.  Fused
norm: y max-abs <= 1e-2 * max(1, max|y|) in bf16 (output rounding) and
1e-4 in f32; mean and var max-abs <= 1e-4 of their largest magnitude (f32
partial sums in another order).  Step 1 loss, kernels vs plain versions:
relative <= 1e-3 (GPT-2 and both ResNets).  The default builder and the
sharded update against phase 5: step 1 relative <= 1e-5, steps 2-10 <=
1e-3; the bf16 master's step 1 <= 2e-2.  The streaming loss against the
dense head, and the bench configuration at B=8 against phase 5: step 1
relative <= 1e-4.  NCF, the two builders' step 1 and one process's:
relative <= 1e-5.  Bounded staleness against phase 5: the DIVERGENT run's
step 1 relative <= 1e-5 and steps 2-10 <= 1e-3, the async worker's step 1
relative <= 1e-5.  Checkpoints: the fit against phase 5 as the default
builder's run; resumed and restored losses bitwise; the plain model's
loss against the session's relative <= 1e-6.  Elastic: the R = 1 -> 1
trainer's losses, the resumed ones and ``launch``'s step 1 bitwise.  Quantization kernels and the
synced gradients of the int8 codecs: bitwise (both sides divide with IEEE
division, round half to even and sum the peers in order without FMA).
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"flash_attention": "autodist_tpu_torch/csrc/flash_attention.cu",
           "fused_norm": "autodist_tpu_torch/csrc/fused_norm.cu",
           "quantize": "autodist_tpu_torch/csrc/quantize.cu"}
KERNELS = {   # kernel -> (source, the TPU kernel's pallas_call)
    "flash_fwd": ("flash_attention", "autodist_tpu/ops/pallas/flash_attention.py:198"),
    "flash_block_update": ("flash_attention",
                           "autodist_tpu/ops/pallas/flash_attention.py:494"),
    "flash_dq": ("flash_attention", "autodist_tpu/ops/pallas/flash_attention.py:328"),
    "flash_dkdv": ("flash_attention", "autodist_tpu/ops/pallas/flash_attention.py:367"),
    "bn_fwd": ("fused_norm", "autodist_tpu/ops/pallas/fused_norm.py:112"),
    "gn_fwd": ("fused_norm", "autodist_tpu/ops/pallas/fused_norm.py:262"),
    "quantize_int8": ("quantize", "autodist_tpu/ops/pallas/quantize.py:41"),
    "dequant_sum": ("quantize", "autodist_tpu/ops/pallas/quantize.py:65"),
    "equarx_hop": ("quantize", "autodist_tpu/ops/pallas/quantize.py:98"),
}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOLERANCES = {"bfloat16": (1e-2, 1e-3, 1e-2), "float32": (1e-4, 1e-4, 1e-4)}
NORM_Y_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
NORM_STAT_TOL = 1e-4
LOSS_REL_TOL = 1e-3
STEPS, BATCH, SEQ = 10, 8, 1024
RESNET_BATCH, RESNET_STEPS, GN_STEPS, NORM_SITES = 256, 10, 5, 53
TPU_MAX_FUSED_ROWS = 16384   # autodist_tpu/ops/pallas/fused_norm.py:42, a VMEM bound
SLEEP_CYCLES = 200_000_000   # ~0.1 s of the SM clock: time to queue the timed runs
# GPT-2 small's two gradient buckets under an int8 codec (plan_buckets), in
# 256-element blocks: 73,244,160 and 51,195,648 f32 elements
GPT2_BUCKET_BLOCKS = (286_110, 199_983)
GPT2_R4_CHUNK_BLOCKS = 71_528   # the first bucket's chunk at R = 4 (EQuARX's hop over 4 GPUs)
PEER_COUNTS = (1, 2, 4, 8)
HOP_PEER_COUNTS = (1, 2, 3, 4, 8)
CODECS = {   # codec -> its quantization launches per GPT-2 small step (2 buckets)
    "Int8Compressor": {"quantize_int8": 4, "dequant_sum": 2, "equarx_hop": 0},
    "Int8CompressorEF": {"quantize_int8": 6, "dequant_sum": 2, "equarx_hop": 0},
    "EquarxInt8Compressor": {"quantize_int8": 2, "dequant_sum": 0, "equarx_hop": 2},
}
CODEC_STEPS = 5
RING_BLOCKS = (4, 2)        # the virtual rings' block counts of the GPT-2 sequence
RING_LOSS_TOL = 1e-3        # step 1 loss, ring of one vs the flat path (absolute)
# the default builder (PSLoadBalancing) vs phase 5's AllReduce, relative:
# step 1 (same parameters, same forward), steps 2-10, and step 1 of the
# accumulation and clipping session
PS_STEP1_TOL, PS_LOSS_TOL, PS_ACCUM_TOL = 1e-5, 1e-3, 1e-3
PS_FIT_STEPS, PS_ACCUM, PS_CLIP, PS_ACCUM_RUN = 12, 2, 1.0, 3
# bench.py's GPT-2 configuration: 32 sequences a card, then 3 steps at B=8;
# step 1 against the dense head and against phase 5, relative
BENCH_BATCH, BENCH_B8_STEPS, BENCH_LOSS_TOL = 32, 3, 1e-4
BF16_MASTER_TOL = 2e-2   # tests/test_mixed_precision.py:59, step 1 relative
# phase 15's runs: the accumulation and Int8-overlap steps, and the
# quantization launches a step of its codec variants (the EQuARX DCN hop:
# one quantize and one hop a bucket; Int8: two quantizes and one dequant-sum)
SYNC_ACCUM_STEPS, SYNC_INT8_STEPS = 3, 3
SYNC_VARIANT_LAUNCHES = {
    "two_level EquarxInt8 DCN": {"quantize_int8": 2, "equarx_hop": 2},
    "Int8 overlap": CODECS["Int8Compressor"],
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# phase 16: the partitioned builders' cap, and NCF as examples/benchmark.py
# runs it (batch 64, adam 1e-3); its step 1 tolerance between the builders
# and against one process's dense loss (relative)
PART_MAX_SHARDS = 8
NCF_BATCH, NCF_STEPS, NCF_LR, NCF_TOL = 64, 10, 1e-3, 1e-5
# phase 17: the DIVERGENT run's staleness; the async runs' bounds, steps a
# worker and the slow worker's delay (s)
STALE_S, ASYNC_ENGINE_S, ASYNC_THREADS_S, ASYNC_STEPS = 2, 1, 1, 3
ASYNC_DELAYS = (0.0, 0.05)
# phase 18: fit's checkpoint period, the step SIGTERM comes before, the
# resumed fit's end after the preemption, the plain model's loss against
# the session's (relative), and the checkpoints' directory in the checkout
CKPT_SAVE_EVERY, CKPT_PREEMPT_STEP, CKPT_RERUN_STEPS, CKPT_SINGLE_TOL = 5, 4, 6, 1e-6
CKPT_DIR = os.path.join(REPO, "_ckpt")
# phase 19: the chaos of each run, the resumed fit's end after the
# preemption, and the poisoned step's run length
ELASTIC_CHAOS = {"a": "delay@2:0.2;kill_worker@3", "b": "preempt@4", "c": "nan@3"}
ELASTIC_PREEMPT_STEP, ELASTIC_RERUN_STEPS, ELASTIC_NAN_STEPS = 4, 6, 4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, torch, flush, reps=15, warmup=3, group=None):
    """Median of ``reps`` CUDA-event timings of ``fn``, L2 flushed before each.

    The runs are queued behind a sleep kernel, so the device runs them back
    to back and the host's launch time (large for a library call's many
    launches on a busy host) stays out of the device times.  If the sleep
    ends before the host has queued every run, it is doubled and the runs
    are timed again; where ``fn`` holds collectives over ``group``, every
    rank of it makes that choice together."""
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
        if group is not None:
            flag = torch.tensor([int(queued_in_time)], device="cuda")
            torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MIN, group=group)
            queued_in_time = bool(flag.item())
        if queued_in_time or cycles >= 8 * SLEEP_CYCLES:
            return statistics.median(start.elapsed_time(end) for start, end in events)
        cycles *= 2


def make_case(torch, b, s, h, h_kv, d, causal, masked, seed, dtype="bfloat16"):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(getattr(torch, dtype))

    q, do = rand(b * h, s, d), rand(b * h, s, d)
    k, v = rand(b * h_kv, s, d), rand(b * h_kv, s, d)
    bias = None   # no key mask: no bias row, as the model's path
    if masked:
        bias = torch.zeros(b, s, device="cuda")
        bias[0, s // 3:] = -1e30   # ragged padding
        bias[-1, :] = -1e30        # an example with every key masked
    return dict(q=q, k=k, v=v, do=do, bias=bias, h=h, group=h // h_kv,
                scale=d ** -0.5, causal=causal)


def check_kernels(torch, fa):
    """Each kernel against its plain version; returns the max-abs errors
    of the bf16 cases (the main path's type)."""
    cases = {
        "gpt2_small B8 S1024 H12 D64 causal": (8, 1024, 12, 12, 64, True, False),
        "gpt2_small bench B32 S1024 H12 D64 causal": (32, 1024, 12, 12, 64, True, False),
        "gqa g2 B2 S512 H12/6 D64 causal": (2, 512, 12, 6, 64, True, False),
        "key padding, fully masked rows B2 S512 H12 D64": (2, 512, 12, 12, 64, False, True),
        "ragged B2 S1000 H12 D64 causal": (2, 1000, 12, 12, 64, True, False),
        "f32 ragged GQA B2 S300 H4/2 D40 causal": (2, 300, 4, 2, 40, True, False, "float32"),
        "two boxes a tile B2 S1024 H8 D128 causal": (2, 1024, 8, 8, 128, True, False),
        "zero-filled box B2 S512 H8 D32 causal": (2, 512, 8, 8, 32, True, False),
        "zero-filled box B2 S512 H8 D40 causal": (2, 512, 8, 8, 40, True, False),
        "padded to D40 B2 S300 H4 D36 causal": (2, 300, 4, 4, 36, True, False),
        "small grid B1 S128 H2 D64 causal": (1, 128, 2, 2, 64, True, False),
        "ragged GQA g3 B2 S1000 H12/4 D64 causal": (2, 1000, 12, 4, 64, True, False),
        "causal key padding B2 S1000 H12 D64": (2, 1000, 12, 12, 64, True, True),
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
    """Kernel, plain and library times and the bound at the GPT-2-small
    shape (no bias row).  The library yardstick of dq and dkdv is SDPA's
    backward alone, which computes what they compute together; its
    forward + backward is printed beside it."""
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

    lib_out = F.scaled_dot_product_attention(lib["q"], lib["k"], lib["v"], is_causal=True)
    lib_inputs = (lib["q"], lib["k"], lib["v"])

    def sdpa_bwd():   # the gradients returned, not accumulated into .grad
        torch.autograd.grad(lib_out, lib_inputs, lib["do"], retain_graph=True)

    with torch.no_grad():
        timings = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, bias, *cfg),
                          lambda: fa.flash_fwd_plain(q, k, v, bias, *cfg), sdpa_fwd),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, bias, do, lse, delta, *cfg),
                         lambda: fa.flash_dq_plain(q, k, v, bias, do, lse, delta, *cfg),
                         sdpa_bwd),
            "flash_dkdv": (lambda: fa.flash_dkdv(q, k, v, bias, do, lse, delta, *cfg),
                           lambda: fa.flash_dkdv_plain(q, k, v, bias, do, lse, delta, *cfg),
                           sdpa_bwd),
        }
        # (row, key) pairs this run's causal mask leaves, per head
        pairs = float(torch.ones(s, s, device="cuda").tril().sum()) * b * h
        elem = b * h * s * d
        rows = b * h * s
        work = {  # (flops, bytes): each input read once, each output written once
            "flash_fwd": (4 * d * pairs, 4 * elem * 2 + rows * 4),
            "flash_dq": (6 * d * pairs, 5 * elem * 2 + 2 * rows * 4),
            "flash_dkdv": (8 * d * pairs, 6 * elem * 2 + 2 * rows * 4),
        }
        with torch.enable_grad():
            print(f"timing SDPA forward + backward (is_causal): "
                  f"{time_ms(sdpa_fwd_bwd, torch, flush):.4f} ms")
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
                  f"library ({'SDPA fwd' if name == 'flash_fwd' else 'SDPA bwd alone'}) "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}: {r['gflop']:.2f} GFLOP, {r['mbytes']:.2f} MB)")
    return results


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_error(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def check_ring_kernels(torch, fa):
    """The virtual ring on one card (phase 10): ``flash_block_update`` and
    the offset ``flash_dq`` / ``flash_dkdv`` over the GPT-2 sequence cut in
    each of RING_BLOCKS blocks, in bf16 and f32."""
    for dtype in ("bfloat16", "float32"):
        c = make_case(torch, BATCH, SEQ, 12, 12, 64, True, False, seed=11, dtype=dtype)
        for n in RING_BLOCKS:
            virtual_ring(torch, fa, c, dtype, n)
        del c
        torch.cuda.empty_cache()


def virtual_ring(torch, fa, c, dtype, n):
    """One virtual ring of ``n`` blocks on the case ``c`` (see
    :func:`check_ring_kernels`); raises on a failed check."""
    out_tol, lse_tol, grad_tol = TOLERANCES[dtype]
    h, scale = c["h"], c["scale"]
    q, k, v, do, bias = c["q"], c["k"], c["v"], c["do"], c["bias"]
    blk = SEQ // n
    bh = q.shape[0]

    def part(t, i):
        return t[:, i * blk:(i + 1) * blk].contiguous()

    def start():
        return (torch.full((bh, blk), fa._M_FLOOR, device="cuda"),
                torch.zeros(bh, blk, device="cuda"),
                torch.zeros(bh, blk, 64, device="cuda"))

    def finish(m, l, o):
        denom = torch.where(l == 0, torch.ones_like(l), l)
        return (o / denom[..., None]).to(q.dtype), m + torch.log(denom)

    step_err = {"m": 0.0, "l": 0.0, "o": 0.0}
    outs, lses, plain_outs = [], [], []
    for i in range(n):
        qi = part(q, i)
        carry, plain = start(), start()
        for t in range(n):
            j = (i - t) % n
            kj, vj = part(k, j), part(v, j)
            offsets = (i * blk, j * blk, True, scale)
            new = fa.flash_block_update(qi, kj, vj, *carry, *offsets)
            ref = fa.flash_block_update_plain(qi, kj, vj, *carry, *offsets)
            plain = fa.flash_block_update_plain(qi, kj, vj, *plain, *offsets)
            torch.cuda.synchronize()
            step_err["m"] = max(step_err["m"], max_abs(new[0], ref[0]))
            step_err["l"] = max(step_err["l"], rel_error(new[1], ref[1]))
            step_err["o"] = max(step_err["o"], rel_error(new[2], ref[2]))
            if j > i:   # wholly in the future: the carry passes through
                check(torch.equal(new[0], carry[0].clamp(min=fa._M_FLOOR))
                      and torch.equal(new[1], carry[1]) and torch.equal(new[2], carry[2]),
                      f"virtual ring {dtype}: block {j} changed q block {i}'s carry")
            carry = new
        out_i, lse_i = finish(*carry)
        outs.append(out_i)
        lses.append(lse_i)
        plain_outs.append(finish(*plain)[0])
    out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=1)
    full_out, full_lse = fa.flash_fwd(q, k, v, bias, h, scale, True)
    plain_err = max_abs(out, torch.cat(plain_outs, dim=1))
    e_out, e_lse = max_abs(out, full_out), max_abs(lse, full_lse)
    m_tol, carry_tol = (1e-3, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-4)
    print(f"virtual ring [{dtype}, {n} blocks of {blk}]: per-step carry m max-abs "
          f"{step_err['m']:.3e}, l rel {step_err['l']:.3e}, o rel {step_err['o']:.3e}; "
          f"out vs flash_fwd max-abs {e_out:.3e}, lse {e_lse:.3e}; out vs the plain "
          f"ring max-abs {plain_err:.3e}")
    check(step_err["m"] <= m_tol, f"virtual ring {dtype}: m error {step_err['m']}")
    check(step_err["l"] <= carry_tol and step_err["o"] <= carry_tol,
          f"virtual ring {dtype}: carry error {step_err}")
    out_bound = out_tol * max(1.0, float(full_out.float().abs().max()))
    check(e_out <= out_bound, f"virtual ring {dtype}: out max-abs {e_out} > {out_bound}")
    check(plain_err <= out_bound, f"virtual ring {dtype}: out vs plain ring {plain_err}")
    check(e_lse <= lse_tol, f"virtual ring {dtype}: lse max-abs {e_lse} > {lse_tol}")

    # backward: every (q block, k block) pair at its offsets, summed
    delta = (do.float() * out.float()).sum(-1)
    dq = [torch.zeros(bh, blk, 64, device="cuda") for _ in range(n)]
    dk = [torch.zeros_like(dq[0]) for _ in range(n)]
    dv = [torch.zeros_like(dq[0]) for _ in range(n)]
    for i in range(n):
        for j in range(n):
            args = (part(q, i), part(k, j), part(v, j), None, part(do, i),
                    part(lse, i), part(delta, i), h, scale, True)
            dq_p = fa.flash_dq(*args, q_off=i * blk, k_off=j * blk)
            dk_p, dv_p = fa.flash_dkdv(*args, q_off=i * blk, k_off=j * blk)
            if j > i:
                torch.cuda.synchronize()
                check(not dq_p.any() and not dk_p.any() and not dv_p.any(),
                      f"virtual ring {dtype}: future block {j} of q block {i} gave "
                      f"non-zero gradients")
            dq[i] += dq_p.float()
            dk[j] += dk_p.float()
            dv[j] += dv_p.float()
    full_delta = (do.float() * full_out.float()).sum(-1)
    full = (fa.flash_dq(q, k, v, bias, do, full_lse, full_delta, h, scale, True),
            *fa.flash_dkdv(q, k, v, bias, do, full_lse, full_delta, h, scale, True))
    torch.cuda.synchronize()
    rels = {name: rel_error(torch.cat(parts, dim=1), ref)
            for name, parts, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), full)}
    print(f"virtual ring [{dtype}, {n} blocks] backward, block sums vs the full-sequence "
          f"kernels: "
          + ", ".join(f"{name} rel {r:.3e}" for name, r in rels.items())
          + "; future blocks gave exact zeros")
    for name, r in rels.items():
        check(r <= grad_tol, f"virtual ring {dtype}: {name} relative error {r}")


def check_ring_of_one_block(torch, fa):
    """``flash_block_update`` against its plain version at the block the
    main path gives it, the ring of one (BH=96, 1024 x 1024, causal,
    offsets 0, bf16), and at a D = 128 block (BH=24, 1024 x 1024: two
    boxes a tile), each from the (floor, 0, 0) carry the ring starts with
    and from a random carry: m max-abs <= 1e-3, l and o relative Frobenius
    <= 1e-2, the normalised output as phase 3's out.  Returns the max-abs
    error of that output from the floor carry at the main path's block
    (the kernels line's)."""
    err = None
    for batch, d in ((BATCH, 64), (2, 128)):
        e = ring_block_case(torch, fa, batch, d)
        err = e if err is None else err
    torch.cuda.empty_cache()
    return {"flash_block_update": err}


def ring_block_case(torch, fa, batch, d):
    """One block of :func:`check_ring_of_one_block`; returns the floor
    carry's output error."""
    out_tol = TOLERANCES["bfloat16"][0]
    c = make_case(torch, batch, SEQ, 12, 12, d, True, False, seed=13)
    q, k, v = c["q"], c["k"], c["v"]
    bh = q.shape[0]
    g = torch.Generator(device="cuda").manual_seed(14)
    carries = {
        "floor": (torch.full((bh, SEQ), fa._M_FLOOR, device="cuda"),
                  torch.zeros(bh, SEQ, device="cuda"), torch.zeros(bh, SEQ, d, device="cuda")),
        "random": (torch.rand(bh, SEQ, device="cuda", generator=g),
                   torch.rand(bh, SEQ, device="cuda", generator=g) + 0.5,
                   torch.randn(bh, SEQ, d, device="cuda", generator=g)),
    }
    err = None
    for label, carry in carries.items():
        cfg = (0, 0, True, c["scale"])
        m, l, o = fa.flash_block_update(q, k, v, *(t.clone() for t in carry), *cfg)
        pm, pl, po = fa.flash_block_update_plain(q, k, v, *carry, *cfg)
        torch.cuda.synchronize()
        e_m, e_l, e_o = max_abs(m, pm), rel_error(l, pl), rel_error(o, po)
        out, ref = (o / l[..., None]).to(q.dtype), po / pl[..., None]
        e_out = max_abs(out, ref)
        bound = out_tol * max(1.0, float(ref.abs().max()))
        print(f"ring-of-one block [bf16, BH {bh}, D {d}, {label} carry]: m max-abs {e_m:.3e}, l rel "
              f"{e_l:.3e}, o rel {e_o:.3e}; o / l max-abs {e_out:.3e} (limit {bound:.3e})")
        check(e_m <= 1e-3, f"ring-of-one block D {d}, {label} carry: m error {e_m}")
        check(e_l <= 1e-2 and e_o <= 1e-2,
              f"ring-of-one block D {d}, {label} carry: l error {e_l}, o error {e_o}")
        check(e_out <= bound, f"ring-of-one block D {d}, {label} carry: out max-abs {e_out}")
        if err is None:
            err = e_out
    return err


def ring_work(bh, sq, sk, d, pairs):
    """(flops, bytes) of the ring kernels on one block, bf16 inputs: each
    input read once, each output written once; ``pairs`` unmasked (row,
    key) pairs; no bias row (the ring has no key mask)."""
    q_elems, k_elems, rows = bh * sq * d, bh * sk * d, bh * sq
    return {
        # q, k, v; m and l read and written; o (f32) read and written
        "flash_block_update": (4 * d * pairs, (q_elems + 2 * k_elems) * 2 + 4 * rows * 4
                               + 2 * q_elems * 4),
        # q, dO, dq and k, v (bf16); lse, delta
        "flash_dq": (6 * d * pairs, (3 * q_elems + 2 * k_elems) * 2 + 2 * rows * 4),
        # q, dO and k, v, dk, dv (bf16); lse, delta
        "flash_dkdv": (8 * d * pairs, (2 * q_elems + 4 * k_elems) * 2 + 2 * rows * 4),
    }


def measure_ring_kernels(torch, fa):
    """Kernel and plain times and the bound of ``flash_block_update`` at the
    ring-of-one block (BH=96, 1024 x 1024, causal, offsets 0: the kernels
    line) and at a ring-of-4 past block (96, 256 x 256, no masked key), and
    of the offset ``flash_dq`` / ``flash_dkdv`` at that past block.  No
    single PyTorch call computes the carry update: no library time."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")   # > the 50 MB L2
    h, d = 12, 64
    results = {}
    for label, s, q_off, k_off in (("ring of one, 1024 x 1024 causal", SEQ, 0, 0),
                                   ("ring-of-4 past block, 256 x 256", SEQ // 4, SEQ // 4,
                                    0)):
        c = make_case(torch, BATCH, s, h, h, d, True, False, seed=13)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        bh = q.shape[0]
        g = torch.Generator(device="cuda").manual_seed(14)
        m = torch.rand(bh, s, device="cuda", generator=g)
        l = torch.rand(bh, s, device="cuda", generator=g) + 0.5
        o = torch.randn(bh, s, d, device="cuda", generator=g)
        cfg = (q_off, k_off, True, c["scale"])
        m2, l2, o2 = fa.flash_block_update(q, k, v, m, l, o, *cfg)
        lse = m2 + torch.log(l2)
        delta = (do.float() * (o2 / l2[..., None])).sum(-1)
        keep = (q_off + torch.arange(s, device="cuda"))[:, None] >= (
            k_off + torch.arange(s, device="cuda"))[None, :]
        pairs = float(keep.sum()) * bh
        grads = (None, do, lse, delta, h, c["scale"], True)
        offsets = dict(q_off=q_off, k_off=k_off)
        fns = {"flash_block_update": (lambda: fa.flash_block_update(q, k, v, m, l, o, *cfg),
                                      lambda: fa.flash_block_update_plain(q, k, v, m, l, o,
                                                                          *cfg))}
        if q_off:
            fns["flash_dq"] = (lambda: fa.flash_dq(q, k, v, *grads, **offsets),
                               lambda: fa.flash_dq_plain(q, k, v, *grads, **offsets))
            fns["flash_dkdv"] = (lambda: fa.flash_dkdv(q, k, v, *grads, **offsets),
                                 lambda: fa.flash_dkdv_plain(q, k, v, *grads, **offsets))
        work = ring_work(bh, s, s, d, pairs)
        with torch.no_grad():
            for name, (kern, plain) in fns.items():
                flops, nbytes = work[name]
                t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
                r = {"ms": time_ms(kern, torch, flush),
                     "plain_ms": time_ms(plain, torch, flush, reps=10), "library_ms": None,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                print(f"timing {name} [{label}, q_off {q_off}, k_off {k_off}]: kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library none (no "
                      f"single PyTorch call), bound {r['bound_ms']:.5f} ms ({r['bound_by']}: "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
                if name == "flash_block_update":
                    results.setdefault(name, r)
        del c, q, k, v, do, m, l, o, m2, l2, o2, fns
        torch.cuda.empty_cache()
    return results


def make_norm_case(torch, shape, seed, dtype):
    """x with per-channel offsets (the E[x^2] - mean^2 cancellation), f32
    scale and bias, a residual like x."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(*shape, device="cuda", generator=g) * 2
         + torch.rand(c, device="cuda", generator=g) - 0.5).to(getattr(torch, dtype))
    scale = torch.rand(c, device="cuda", generator=g) + 0.5
    bias = torch.randn(c, device="cuda", generator=g) * 0.1
    res = torch.randn(*shape, device="cuda", generator=g).to(x.dtype)
    return x, scale, bias, res


NORM_CASES = {   # label -> (shape, groups (None: batch norm), act, residual, dtype, repeat)
    "bn stem bf16 (256, 112, 112, 64)":
        ((256, 112, 112, 64), None, None, False, "bfloat16", True),
    "bn stage-4 bf16 (256, 7, 7, 2048)":
        ((256, 7, 7, 2048), None, None, False, "bfloat16", False),
    "bn f32 rows 1000 C 100 relu residual": ((1000, 100), None, "relu", True, "float32", False),
    "bn bf16 rows 1000 C 100 relu residual":
        ((1000, 100), None, "relu", True, "bfloat16", False),
    # the gn path's own sites at its batch, B=256: the stem and a stage-1 output
    "gn G32 bf16 stem (256, 112, 112, 64)": ((256, 112, 112, 64), 32, None, False, "bfloat16",
                                             True),
    "gn G32 bf16 stage-1 (256, 56, 56, 256)": ((256, 56, 56, 256), 32, None, False,
                                               "bfloat16", True),
    "gn G32 bf16 stage-4 (256, 7, 7, 2048)": ((256, 7, 7, 2048), 32, None, False, "bfloat16",
                                              False),
    "gn G32 bf16 (64, 56, 56, 256)": ((64, 56, 56, 256), 32, None, False, "bfloat16", False),
    "gn G32 bf16 (64, 56, 56, 64)": ((64, 56, 56, 64), 32, None, False, "bfloat16", False),
    "gn G10 f32 (3, 37, 30) relu residual": ((3, 37, 30), 10, "relu", True, "float32", False),
}


def check_norm_kernels(torch, fn):
    """Each norm kernel against its plain version in f32; returns the worst
    y max-abs error of the bf16 cases (the main path's type)."""
    worst = {"bn_fwd": 0.0, "gn_fwd": 0.0}
    for i, (label, (shape, groups, act, has_res, dtype, repeat)) in enumerate(
            NORM_CASES.items()):
        x, scale, bias, res = make_norm_case(torch, shape, 100 + i, dtype)
        res = res if has_res else None
        fres = None if res is None else res.float()
        if groups is None:
            y, mean, var = fn.bn_fwd(x, scale, bias, act=act, residual=res)
            ref_y, ref_mean, ref_var = fn.batch_norm_plain(x.float(), scale, bias, act=act,
                                                           residual=fres)
            stats = [("mean", mean, ref_mean), ("var", var, ref_var)]
        else:
            y = fn.gn_fwd(x, scale, bias, groups, act=act, residual=res)
            ref_y = fn.group_norm_plain(x.float(), scale, bias, groups, act=act,
                                        residual=fres)
            stats = []
        torch.cuda.synchronize()
        err = float((y.float() - ref_y).abs().max())
        bound = NORM_Y_TOL[dtype] * max(1.0, float(ref_y.abs().max()))
        line = f"norm check [{label}]: y max-abs {err:.3e} (limit {bound:.3e})"
        for name, got, want in stats:
            rel = float((got - want).abs().max()) / float(want.abs().max())
            line += f", {name} max-abs/max {rel:.3e}"
            check(rel <= NORM_STAT_TOL, f"{label}: {name} error {rel} > {NORM_STAT_TOL}")
        print(line)
        check(y.dtype == x.dtype and bool(torch.isfinite(y).all()),
              f"{label}: y not finite or not in x's type")
        check(err <= bound, f"{label}: y max-abs {err} > {bound}")
        if repeat:   # no atomics: a second run gives the same bits
            if groups is None:
                again = fn.bn_fwd(x, scale, bias, act=act, residual=res)
                same = all(torch.equal(a, b) for a, b in zip((y, mean, var), again))
            else:
                same = torch.equal(y, fn.gn_fwd(x, scale, bias, groups, act=act,
                                                residual=res))
            check(same, f"{label}: two runs differ")
            print(f"norm check [{label}]: a second run is bitwise equal")
        if dtype == "bfloat16":
            name = "bn_fwd" if groups is None else "gn_fwd"
            worst[name] = max(worst[name], err)
        del x, res, y, ref_y
    torch.cuda.empty_cache()
    return worst


def measure_norm_kernels(torch, fn):
    """Kernel, plain and library times and the bound at two batch-norm and
    two group-norm shapes, each a ResNet-50 norm site; the first shape of
    each kernel (a site of its path at B=256) is the one reported in the
    kernels line."""
    import torch.nn.functional as F

    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")   # > the 50 MB L2
    shapes = [("bn_fwd", (256, 112, 112, 64), None), ("bn_fwd", (256, 7, 7, 2048), None),
              ("gn_fwd", (256, 56, 56, 256), 32), ("gn_fwd", (64, 56, 56, 256), 32)]
    results = {}
    for name, shape, groups in shapes:
        x, scale, bias, _ = make_norm_case(torch, shape, 7, "bfloat16")
        xn = x.permute(0, 3, 1, 2)   # the NCHW view of the channels-last memory
        with torch.no_grad():
            if groups is None:
                fns = (lambda: fn.bn_fwd(x, scale, bias),
                       lambda: fn.batch_norm_plain(x, scale, bias),
                       lambda: F.batch_norm(xn, None, None, scale, bias, training=True,
                                            eps=1e-5))
            else:
                scale_x, bias_x = scale.to(x.dtype), bias.to(x.dtype)
                fns = (lambda: fn.gn_fwd(x, scale, bias, groups),
                       lambda: fn.group_norm_plain(x, scale, bias, groups),
                       lambda: F.group_norm(xn, groups, scale_x, bias_x, eps=1e-5))
            n = x.numel()
            c = shape[-1]
            # one read of x, one write of y, scale/bias read, mean/var written;
            # sum, square-add, subtract, multiply, add per element
            nbytes = 2 * n * x.element_size() + 4 * c * 4
            flops = 6 * n
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            r = {"ms": time_ms(fns[0], torch, flush),
                 "plain_ms": time_ms(fns[1], torch, flush, reps=10),
                 "library_ms": time_ms(fns[2], torch, flush),
                 "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        print(f"timing {name} {shape}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}: {r['gflop']:.3f} GFLOP, {r['mbytes']:.2f} MB)")
        results.setdefault(name, r)
        del x, xn, fns
        torch.cuda.empty_cache()
    return results


def make_quant_blocks(torch, n, seed):
    """(n, 256) f32 on the card, magnitudes spread over blocks as a
    gradient's are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, 256, device="cuda", generator=g) * torch.exp(
        torch.rand(n, 1, device="cuda", generator=g) * 16 - 12)


def bitwise_error(label, got, want):
    """Max-abs difference of matching outputs, which must be bitwise equal."""
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{label}: shape or type differs")
        err = max(err, float((a.float() - b.float()).abs().max()))
        check(a.equal(b), f"{label}: not bitwise equal (max-abs {err:.3e})")
    return err


HOP_EDGE_ROWS = ("ties at scale 1", "ties at scale 2^-20", "subnormal scale",
                 "subnormal scale, clamped", "scale below 2^-96", "+-inf", "NaN",
                 "inf and NaN", "zero", "-0")
HOP_NAN_ROWS = (6, 7)   # rows whose requantized scale is NaN
HOP_MEAN_MODES = {0: "none", 1: "times 2^-k", 2: "IEEE division"}


def hop_case(torch, tq, d, n, seed):
    """Peers ``(q (d, n, 256) int8, s (d, n, 1) f32)`` for ``equarx_hop``:
    ``quantize_int8`` of spread gradients, rows 0-9 overwritten with the
    edge blocks of ``HOP_EDGE_ROWS``.  Ties: every peer's scale 63.5 d 2^j,
    peer 0's q in {-2..2} (2 at element 0), later peers in pairs of q and -q,
    so the mean is 63.5 2^j k exactly, the requantized scale 2^j and x / s
    = 63.5 k, half-steps at k = +-1 (the reciprocal path).  Subnormal: every
    peer's scale 2^-149 (element 0 at 127 on every peer: scale 2^-149) or
    2^-148 (element 0 at 95: absmax 190 2^-149, scale 2^-149, so x / s
    reaches 190 and clamps).  Below 2^-96: peer scales 2^-110.  The rest:
    peer 0's scale 3e38 with q in {-1, 0, 1} and +-127 at elements 7, 8
    (+-inf among finite values), a NaN scale, an inf scale times a q of 0,
    all q 0, and all q 0 with scale -1 (a block of -0)."""
    q, s = tq.quantize_int8(make_quant_blocks(torch, d * n, seed))
    q, s = q.view(d, n, 256), s.view(d, n, 1)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand_q(lo, hi):
        return torch.randint(lo, hi + 1, (256,), device="cuda", generator=g,
                             dtype=torch.int8)

    q[:, :10] = 0
    for row, j in ((0, 0), (1, -20)):
        s[:, row] = 63.5 * d * 2.0 ** j
        k = rand_q(-2, 2)
        k[0] = 2
        q[0, row] = k
        for a in range(1, d - 1, 2):
            x = rand_q(-127, 127)
            q[a, row], q[a + 1, row] = x, -x
    for row, scale, top in ((2, 2.0 ** -149, 127), (3, 2.0 ** -148, 95)):
        s[:, row] = scale
        for a in range(d):
            q[a, row] = rand_q(-top, top)
        q[:, row, 0] = top
    s[:, 4] = 2.0 ** -110
    for a in range(d):
        q[a, 4] = rand_q(-127, 127)
    s[:, 5] = 3e38
    q[0, 5] = rand_q(-1, 1)
    q[0, 5, 7], q[0, 5, 8] = 127, -127
    s[0, 6] = float("nan")
    q[0, 6] = rand_q(1, 127)
    s[0, 7] = float("inf")
    q[0, 7] = rand_q(1, 127)
    q[0, 7, 3] = 0
    s[:, 8] = 1.0
    s[:, 9] = -1.0
    return q, s


def hop_bitwise(label, got, want):
    """``bitwise_error`` for hop outputs ``(q, s)``: the NaN-scale rows must
    be NaN in both, their q 0, and everything else bitwise equal."""
    (q, s), (wq, ws) = got, want
    rows = list(HOP_NAN_ROWS)
    check(bool(s[rows].isnan().all() and ws[rows].isnan().all()),
          f"{label}: a NaN did not poison its block's scale")
    check(not q[rows].any(), f"{label}: a NaN block's q is not 0")
    keep = s.new_ones(s.shape[0], dtype=bool)
    keep[rows] = False
    return bitwise_error(label, (q, s[keep]), (wq, ws[keep]))


def check_quantize_kernels(torch, tq):
    """Each quantization kernel against its plain version, bitwise: at the
    two GPT-2 small bucket sizes, at N = 1001 blocks with an all-zero block,
    a block of half-step ties and a NaN block; ``dequant_sum`` and
    ``equarx_hop`` with D in {1, 2, 3, 4, 8} peers at the first bucket's
    size, D = 4 at the 4-GPU path's chunk and D = 3 at N = 1001, each with
    the edge blocks of ``hop_case``; and the EQuARX contract (the fused hop
    equals the unfused kernels).  Returns each kernel's max-abs error (0
    when bitwise equal)."""
    worst = {"quantize_int8": 0.0, "dequant_sum": 0.0, "equarx_hop": 0.0}
    for i, n in enumerate(GPT2_BUCKET_BLOCKS + (1001,)):
        x = make_quant_blocks(torch, n, 200 + i)
        label = f"quantize_int8 N={n}"
        if n == 1001:
            x[1] = 0.0
            x[2] = torch.arange(256, device="cuda", dtype=torch.float32) % 64 - 31.5
            x[2, 0] = -127.0      # scale exactly 1: every other value on a tie
            x[3, 9] = float("nan")
            label += " (zero, tie and NaN blocks)"
        q, s = tq.quantize_int8(x)
        pq, ps = tq.quantize_int8(x, impl="plain")
        torch.cuda.synchronize()
        if n == 1001:
            check(bool(torch.isnan(s[3]).all() and torch.isnan(ps[3]).all()),
                  f"{label}: a NaN did not poison its block's scale")
            bitwise_error(f"{label} NaN block q", (q[3],), (pq[3],))
            check(not q[3].any(), f"{label}: a NaN block's q is not 0")
            check(not q[1].any() and float(s[1]) == 1.0, f"{label}: zero block")
            check(torch.equal(q[2].cpu(), torch.round(x[2].cpu()).to(torch.int8)),
                  f"{label}: ties do not round half to even")
            keep = torch.ones(n, dtype=torch.bool, device="cuda")
            keep[3] = False   # the NaN scales, compared above
            s, ps = s[keep], ps[keep]
        err = bitwise_error(label, (q, s), (pq, ps))
        worst["quantize_int8"] = max(worst["quantize_int8"], err)
        print(f"quantize check [{label}]: bitwise equal to the plain version")
        del x, q, s, pq, ps
    cases = [(d, GPT2_BUCKET_BLOCKS[0]) for d in HOP_PEER_COUNTS] + [
        (4, GPT2_R4_CHUNK_BLOCKS), (3, 1001)]
    for d, n in cases:
        q, s = hop_case(torch, tq, d, n, 300 + d)
        total = tq.dequant_sum(q, s)
        q2, s2 = tq.equarx_hop(q, s, d)
        uq, us = tq.quantize_int8(tq.true_divide(total, d))
        plain_total = tq.dequant_sum(q, s, impl="plain")
        pq2, ps2 = tq.equarx_hop(q, s, d, impl="plain")
        torch.cuda.synchronize()
        label = f"D={d} N={n}"
        ok = ~total.isnan()   # the NaN blocks' sums
        check(torch.equal(~ok, plain_total.isnan()),
              f"dequant_sum {label}: NaNs differ from the plain version's")
        worst["dequant_sum"] = max(worst["dequant_sum"], bitwise_error(
            f"dequant_sum {label}", (total[ok],), (plain_total[ok],)))
        worst["equarx_hop"] = max(worst["equarx_hop"], hop_bitwise(
            f"equarx_hop {label}", (q2, s2), (pq2, ps2)))
        hop_bitwise(f"EQuARX contract {label}", (q2, s2), (uq, us))
        fast = int(((s2 >= 2.0 ** -96) & (s2 < float("inf"))).sum())
        print(f"quantize check [{label}, mean {HOP_MEAN_MODES[tq.mean_mode(d)[0]]}, edge "
              f"blocks {', '.join(HOP_EDGE_ROWS)}]: dequant_sum and equarx_hop bitwise equal "
              f"to their plain versions; equarx_hop bitwise equal to quantize_int8("
              f"dequant_sum / {d}); {fast} of {n} blocks on the reciprocal path, "
              f"{n - fast} on IEEE division")
        del q, s, total, q2, s2, uq, us, plain_total, pq2, ps2
    torch.cuda.empty_cache()
    return worst


def quantize_work(name, n, d=1):
    """(operations, bytes) of one call over n blocks (each input read once,
    each output written once)."""
    elems, blocks = n * 256, n
    if name == "quantize_int8":   # abs, max, divide, round per element
        return 4 * elems, elems * 4 + elems + blocks * 4
    if name == "dequant_sum":     # a multiply and an add per peer
        return 2 * d * elems, d * (elems + blocks * 4) + elems * 4
    return (2 * d + 5) * elems, d * (elems + blocks * 4) + elems + blocks * 4


def measure_quantize_kernels(torch, tq):
    """Kernel and plain times and the bound at GPT-2 small's first bucket
    (286,110 blocks): ``quantize_int8``, ``dequant_sum`` at D = 1 and 8, and
    ``equarx_hop`` at D = 1 (the one-card path's shape; reported in the
    kernels line), 2, 4 and 8, and at D = 4 over the 4-GPU path's chunk
    (71,528 blocks).  No single PyTorch call computes these functions, so
    there is no library time."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")   # > the 50 MB L2
    n0 = GPT2_BUCKET_BLOCKS[0]
    x = make_quant_blocks(torch, n0, 7)
    results = {}
    shapes = [("quantize_int8", 1, n0), ("dequant_sum", 1, n0), ("dequant_sum", 8, n0)] + [
        ("equarx_hop", d, n0) for d in PEER_COUNTS] + [("equarx_hop", 4, GPT2_R4_CHUNK_BLOCKS)]
    for name, d, n in shapes:
        if name == "quantize_int8":
            fns = (lambda: tq.quantize_int8(x), lambda: tq.quantize_int8(x, impl="plain"))
        else:
            q, s = tq.quantize_int8(make_quant_blocks(torch, d * n, 8 + d))
            q, s = q.view(d, n, 256), s.view(d, n, 1)
            fn = tq.dequant_sum if name == "dequant_sum" else (
                lambda q_, s_, impl=None: tq.equarx_hop(q_, s_, d, impl=impl))
            fns = (lambda: fn(q, s), lambda: fn(q, s, impl="plain"))
        ops, nbytes = quantize_work(name, n, d)
        t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        r = {"ms": time_ms(fns[0], torch, flush), "plain_ms": time_ms(fns[1], torch, flush),
             "library_ms": None, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "mbytes": nbytes / 1e6}
        print(f"timing {name} N={n} D={d}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library none (no single PyTorch call), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['mbytes']:.2f} MB, "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of the memory rate)")
        results.setdefault(name, r)
    del x, flush
    torch.cuda.empty_cache()
    return results


def timed_steps(torch, sess, batch, steps, kernel_modules):
    """``steps`` steps of the main path, each ended by reading the loss,
    with every launch count set to 0 just before and read just after;
    returns (losses, step ms, launches, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in kernel_modules:
        m.reset_launches()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = sess.run(batch)
        losses.append(metrics["loss"].item())   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: c for m in kernel_modules for n, c in m.LAUNCHES.items()}
    return losses, step_ms, launches, torch.cuda.max_memory_allocated() / 1e9


def train_gpt2_small(torch, ad, kernel_modules):
    """The GPT path: GPT-2 small, AllReduce, 10 adamw steps."""
    import dataclasses

    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

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

    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS,
                                                     kernel_modules)
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
    want = dict(NO_LAUNCHES, flash_fwd=per_step, flash_dq=per_step, flash_dkdv=per_step)
    check(launches == want, f"expected launches {want}, got {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in sess.state["params"].values()),
          "non-finite parameters after training")
    profile_steps(torch, sess, batch)
    return ({n: launches[n] for n in ("flash_fwd", "flash_dq", "flash_dkdv")},
            {"losses": losses, "peak_gb": peak_gb})


def norm_site_shapes(torch):
    """The (1, H, W, C) input of each of ResNet-50's norm sites at 224x224,
    traced on the meta device (shapes only)."""
    from autodist_tpu_torch.models import norm
    from autodist_tpu_torch.models.resnet import ResNet50

    model = ResNet50(num_classes=1000, norm="bn", dtype=torch.float32, device="meta")
    shapes = []
    for m in model.modules():
        if isinstance(m, norm.BatchNorm):
            m.register_forward_pre_hook(lambda mod, args: shapes.append(tuple(args[0].shape)))
    model(torch.empty(1, 224, 224, 3, device="meta"), train=True, new_state={})
    return shapes


def report_norm_sites(torch):
    """Norm sites per step, their elements, the TPU kernel's reach under its
    VMEM row limit, and the per-step bound of the 53 bf16 launches."""
    shapes = norm_site_shapes(torch)
    per_image = sum(math.prod(sh) for sh in shapes)
    elements = per_image * RESNET_BATCH
    on_tpu_kernel = sum(RESNET_BATCH * sh[1] * sh[2] <= TPU_MAX_FUSED_ROWS for sh in shapes)
    print(f"resnet50 norm sites: {len(shapes)}, {per_image} elements per image, "
          f"{elements} per B={RESNET_BATCH} step; {on_tpu_kernel} of them within the TPU "
          f"kernel's {TPU_MAX_FUSED_ROWS}-row limit at that batch; one bf16 read of x and "
          f"write of y per site: {4 * elements / 1e9:.2f} GB, bound "
          f"{4 * elements / PEAK_BYTES * 1e3:.3f} ms per step")
    check(len(shapes) == NORM_SITES, f"expected {NORM_SITES} norm sites, got {len(shapes)}")


def train_resnet50(torch, ad, kernel_modules, norm, steps):
    """The ResNet path: ResNet-50 at full width, B=256, sgd_momentum(0.1),
    the batch statistics as mutable state."""
    import numpy as np

    from autodist_tpu_torch.models import train_lib
    from autodist_tpu_torch.models.norm import FusedBatchNorm, FusedGroupNorm
    from autodist_tpu_torch.models.resnet import ResNet50

    model = ResNet50(num_classes=1000, norm=norm, device="meta")
    loss_fn, params, state = train_lib.classifier_capture(model, (224, 224, 3), seed=0)
    rng = np.random.default_rng(0)
    batch = {   # put on the card once, as bench.py does
        "image": torch.from_numpy(rng.standard_normal(
            (RESNET_BATCH, 224, 224, 3), dtype=np.float32)).cuda().to(torch.bfloat16),
        "label": torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).cuda()}

    # step 1's loss through the norms' plain versions, same model and weights
    fused = [m for m in model.modules() if isinstance(m, (FusedBatchNorm, FusedGroupNorm))]
    check(len(fused) == NORM_SITES, f"expected {NORM_SITES} fused norms, got {len(fused)}")
    for m in fused:
        m.impl = "reference"
    with torch.no_grad():
        out = loss_fn(params, state, batch) if state else loss_fn(params, batch)
        plain_loss = (out[0] if state else out).item()
    for m in fused:
        m.impl = "kernel"
    del out
    torch.cuda.empty_cache()

    initial = None if state is None else {n: t.clone() for n, t in state.items()}
    sess = ad.distribute(loss_fn, params, train_lib.sgd_momentum(0.1), mutable_state=state)
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, steps,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    tag = f"resnet50 {norm}"
    print(f"{tag} losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print(f"{tag} step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"{tag}: median step {steady:.2f} ms (steps 2-{steps}), "
          f"{RESNET_BATCH / steady * 1e3:.1f} images/s, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"{tag} step 1 loss: kernels {losses[0]:.6f}, plain norms {plain_loss:.6f}, "
          f"relative difference {rel:.3e}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss in {losses}")
    check(statistics.mean(losses[-3:]) < losses[0],
          f"{tag}: the last three losses do not average below the first: {losses}")
    check(rel <= LOSS_REL_TOL, f"{tag}: step 1 loss differs from the plain path by {rel}")
    kernel = "bn_fwd" if norm == "bn_fused" else "gn_fwd"
    want = dict(NO_LAUNCHES, **{kernel: NORM_SITES * steps})
    check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in sess.state["params"].values()),
          f"{tag}: non-finite parameters after training")
    if initial is not None:
        final = sess.mutable_state()
        check(list(final) == list(initial) and len(final) == 2 * NORM_SITES,
              f"{tag}: mutable state names changed")
        check(all(bool(torch.isfinite(t).all()) for t in final.values()),
              f"{tag}: non-finite batch statistics")
        moved = sum(not torch.equal(final[n], initial[n].cpu()) for n in final)
        print(f"{tag}: {moved} of {len(final)} batch-statistics leaves moved")
        check(moved == len(final), f"{tag}: batch statistics did not all move")
    profile_steps(torch, sess, batch)
    return {kernel: launches[kernel]}


KERNEL_CATEGORIES = (   # (category, substrings of a kernel name), first match wins
    ("quantization kernels (quantize_int8 / dequant_sum / equarx_hop)",
     ("quantize_kernel", "dequant_sum_kernel", "equarx_hop_kernel")),
    ("fused-norm kernels (bn_fwd / gn_fwd)", ("norm_partial_kernel", "norm_stats_kernel",
                                             "norm_apply_kernel")),
    ("flash kernels", ("wgmma_fwd_kernel", "wgmma_dq_kernel", "wgmma_dkdv_kernel",
                       "fma_fwd_kernel", "fma_dq_kernel", "fma_dkdv_kernel")),
    ("convolutions and matmuls (cuDNN, cuBLAS)", ("conv", "cudnn", "xmma", "gemm", "nvjet",
                                                 "cutlass", "implicit", "dgrad", "wgrad")),
    ("reductions (sums, means)", ("reduce_kernel",)),
    ("copies and dtype casts", ("copy",)),
    ("other elementwise", ("",)),
)


def profile_steps(torch, sess, batch, steps=2):
    """Where a step's device time goes: ``torch.profiler`` over two more
    steps (after the timed ones); prints the device-busy share, the time by
    kernel category and the kernels with the most device time."""
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
    by_category = dict.fromkeys((name for name, _ in KERNEL_CATEGORIES), 0.0)
    for ms, name in rows:
        low = name.lower()
        by_category[next(c for c, keys in KERNEL_CATEGORIES
                         if any(k.lower() in low for k in keys))] += ms
    for category, ms in by_category.items():
        print(f"profile category: {ms:8.3f} ms/step {100 * ms / busy:5.1f} %  {category}")
    for ms, name in sorted(rows, reverse=True)[:15]:
        print(f"profile: {ms:8.3f} ms/step {100 * ms / busy:5.1f} %  {name[:90]}")


def same_on_every_rank(torch, tensors, group):
    """True when every rank of ``group`` holds the same bits in ``tensors``."""
    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
    ref = flat.clone()
    torch.distributed.broadcast(ref, src=0, group=group)
    agree = torch.tensor([int(torch.equal(ref, flat))], device=flat.device)
    torch.distributed.all_reduce(agree, op=torch.distributed.ReduceOp.MIN, group=group)
    return bool(agree.item())


def train_gpt2_codec(torch, ad, codec, kernel_modules):
    """The compressed AllReduce path: GPT-2 small, ``AllReduce(compressor=
    codec)``, CODEC_STEPS adamw steps on phase 5's batch (BATCH sequences
    per replica when ``multi_gpu_check.py`` runs it over R GPUs).  Before
    them, step 1's synced gradients through the codec's kernels are held
    bitwise against the same codec's plain versions on the same CUDA
    gradients, and the sync's device time is taken (kernels, plain, and the
    same buckets under NoneCompressor).  Over R > 1 replicas every rank
    must end with the same parameters."""
    import dataclasses

    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    rows = BATCH * ad.world.size
    toks = np.random.default_rng(0).integers(0, config.vocab_size, (rows, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    t = sess.transformer
    blocks = tuple(sorted((-(-b.total // 256) for b in t.buckets), reverse=True))
    check(blocks == GPT2_BUCKET_BLOCKS, f"{codec}: buckets of {blocks} blocks, expected "
                                        f"{GPT2_BUCKET_BLOCKS}")

    def fresh_states():
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in sess.state["comp"].items()}

    _, _, grads, _ = t.gradients(sess.state, sess.shard_batch(batch))
    synced, states = t.sync(grads, fresh_states())
    plain_synced, plain_states = t.sync(grads, fresh_states(), impl="plain")
    torch.cuda.synchronize()
    stateful = [k for k, v in states.items() if torch.is_tensor(v)]
    err = bitwise_error(f"{codec} step-1 synced gradients",
                        [synced[n] for n in t.names] + [states[k] for k in stateful],
                        [plain_synced[n] for n in t.names] + [plain_states[k] for k in stateful])
    print(f"{codec}: step 1's synced gradients ({len(t.names)} tensors"
          f"{', and the EF residuals' if stateful else ''}) through the kernels are bitwise "
          f"equal to the codec's plain versions")
    del synced, states, plain_synced, plain_states
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    none_buckets = [dataclasses.replace(b, compressor=0) for b in t.buckets]
    sync = {
        "kernels": time_ms(lambda: t.sync(grads, fresh_states()), torch, flush, reps=10,
                           group=t.group),
        "plain": time_ms(lambda: t.sync(grads, fresh_states(), impl="plain"), torch, flush,
                         reps=5, group=t.group),
        "NoneCompressor": time_ms(lambda: ar_sync.sync_bucketed(
            grads, none_buckets, {b.key: () for b in none_buckets}, t.group), torch, flush,
            reps=10, group=t.group),
    }
    print(f"{codec}: gradient sync device time per step (both buckets): kernels "
          f"{sync['kernels']:.4f} ms, plain versions {sync['plain']:.4f} ms, the same "
          f"buckets under NoneCompressor {sync['NoneCompressor']:.4f} ms")
    del grads, flush
    torch.cuda.empty_cache()

    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, CODEC_STEPS,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    print(f"{codec} losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print(f"{codec} step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"{codec}: median step {steady:.2f} ms (steps 2-{CODEC_STEPS}), "
          f"{rows * SEQ / steady * 1e3:.0f} tokens/s over {rows} sequences, peak memory "
          f"{peak_gb:.2f} GB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"{codec}: non-finite loss in {losses}")
    check(statistics.mean(losses[-3:]) < losses[0],
          f"{codec}: the last three losses do not average below the first: {losses}")
    per_layer = config.num_layers * CODEC_STEPS
    want = dict(NO_LAUNCHES, flash_fwd=per_layer, flash_dq=per_layer, flash_dkdv=per_layer)
    want.update({k: v * CODEC_STEPS for k, v in CODECS[codec].items()})
    check(launches == want, f"{codec}: expected launches {want}, got {launches}")
    check(all(bool(torch.isfinite(p).all()) for p in sess.state["params"].values()),
          f"{codec}: non-finite parameters after training")
    if t.group is not None:
        check(same_on_every_rank(torch, list(sess.state["params"].values()), t.group),
              f"{codec}: the ranks hold different parameters")
        print(f"{codec}: all {t.world.size} ranks hold the same parameters")
    if codec in ("Int8Compressor", "EquarxInt8Compressor"):
        profile_steps(torch, sess, batch)
    return {"codec": codec, "launches": {k: launches[k] for k in CODECS[codec]},
            "sync_max_abs_err": err, "step_ms": steady, "losses": losses, "rows": rows,
            "peak_gb": peak_gb, "sync_ms": sync}


def run_codec_phase():
    """Each codec's training run in a process of its own (``AutoDist`` is
    one instance per process), one after another on the one card; forwards
    their output and sums their launches."""
    launches = dict.fromkeys(("quantize_int8", "dequant_sum", "equarx_hop"), 0)
    for codec in CODECS:
        result = run_child(["--codec", codec], "CODEC_RESULT")
        for k, v in result["launches"].items():
            launches[k] += v
    print(f"compressed AllReduce runs: launches {launches} "
          f"({CODEC_STEPS} steps under each of {', '.join(CODECS)})")
    return launches


def train_gpt2_ring(torch, ad, kernel_modules, flat_loss):
    """Sequence parallelism on a ring of one (phase 11): phase 5's GPT-2
    small, batch and weights under ``mesh: {replica: 1, seq: 1}``, where
    attention runs ``ring_attention``: ``flash_block_update`` forward, the
    offset ``flash_dq`` / ``flash_dkdv`` backward.  Step 1's loss is held
    against ``flat_loss`` (phase 5's) and against the plain ring
    (``attention_impl="xla"``) on the same weights."""
    import dataclasses

    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.parallel.context import SeqAxis, seq_axis_context

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    toks = np.random.default_rng(0).integers(0, config.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    plain_loss_fn, _, _ = gpt_capture(dataclasses.replace(config, attention_impl="xla"),
                                      SEQ, seed=0)
    with torch.no_grad(), seq_axis_context(SeqAxis(group=None, index=0, size=1)):
        dev_batch = {n: torch.from_numpy(a).cuda() for n, a in batch.items()}
        plain_loss = plain_loss_fn(params, dev_batch).item()
    del plain_loss_fn, dev_batch
    torch.cuda.empty_cache()

    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    seq = sess.transformer.seq_axis
    check(seq is not None and seq.size == 1, f"the ring-of-one run has seq axis {seq}")
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    print("ring losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print("ring step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"ring (mesh replica 1 x seq 1): median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    print(f"ring step 1 loss: {losses[0]:.6f}; flat path (phase 5) {flat_loss:.6f}, "
          f"difference {abs(losses[0] - flat_loss):.3e}; plain ring {plain_loss:.6f}, "
          f"difference {abs(losses[0] - plain_loss):.3e}")
    check(all(math.isfinite(x) for x in losses), f"ring: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"ring: loss did not fall: {losses}")
    check(abs(losses[0] - flat_loss) <= RING_LOSS_TOL,
          f"ring: step 1 loss {losses[0]} differs from the flat path's {flat_loss}")
    check(abs(losses[0] - plain_loss) <= RING_LOSS_TOL,
          f"ring: step 1 loss {losses[0]} differs from the plain ring's {plain_loss}")
    per_step = config.num_layers * STEPS
    want = dict(NO_LAUNCHES, flash_block_update=per_step, flash_dq=per_step,
                flash_dkdv=per_step)
    check(launches == want, f"ring: expected launches {want}, got {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in sess.state["params"].values()),
          "ring: non-finite parameters after training")
    profile_steps(torch, sess, batch)
    return {"launches": {"flash_block_update": launches["flash_block_update"]},
            "step_ms": steady, "losses": losses, "peak_gb": peak_gb}


def shard_optimizer_step(torch, state):
    """The optimizer's step on the flat shards alone, as a function of the
    shards' gradients by name."""
    shards = state["shards"]

    def step(shard_grads):
        with torch.no_grad():
            for n, g in shard_grads.items():
                shards[n].grad = g
            state["opt_state"].step()
            for n in shard_grads:
                shards[n].grad = None

    return step


def time_ps_sync(torch, t, state, grads):
    """The PS sync's device time per step on ``grads``: pack -> scatter ->
    shard update -> gather -> write-back (:meth:`GraphTransformer.update`,
    which for the default builder holds nothing else), and its three parts.
    Each timed call takes an optimizer step: run it after the checks."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    shard_update = shard_optimizer_step(torch, state)
    scattered, _ = t.sync(grads, state["comp"])
    times = {
        "total": time_ms(lambda: t.update(state, grads), torch, flush, reps=10),
        "pack + reduce-scatter": time_ms(lambda: t.sync(grads, state["comp"]), torch, flush,
                                         reps=10),
        "shard update (adamw)": time_ms(lambda: shard_update(scattered), torch, flush,
                                        reps=10),
        "all-gather + write-back": time_ms(lambda: t.gather_buckets(state), torch, flush,
                                           reps=10),
    }
    del flush, scattered
    return times


def train_gpt2_ps(torch, ad, spec, kernel_modules, flat_losses):
    """The default builder (phase 12): phase 5's GPT-2 small, batch and
    weights under ``AutoDist(resource_spec=...)`` with no strategy builder,
    so ``PSLoadBalancing``: each step reduce-scatters the gradients, updates
    the flat shards (at R = 1 the whole of each variable) and gathers them
    back.  Its losses are held against ``flat_losses`` (phase 5's, under
    AllReduce); then ``fit``, ``check_replication`` and a second session
    with ``accum_steps`` and ``clip_global_norm``."""
    import numpy as np

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    toks = np.random.default_rng(0).integers(0, config.vocab_size, (BATCH, SEQ + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    t = sess.transformer
    anchor = spec.gpu_devices[0][0]
    dests = {(n.WhichOneof("synchronizer"), n.PSSynchronizer and
              n.PSSynchronizer.reduction_destination) for n in t.strategy.node_config}
    check(dests == {("PSSynchronizer", anchor)} and len(t.strategy.node_config) ==
          len(t.names), f"PS: expected every node a PSSynchronizer on {anchor}, got {dests}")
    check([b.key for b in t.buckets] == [f"ps_{d}" for d in t.ps_groups]
          and sum(len(v) for v in t.ps_groups.values()) == len(t.names),
          f"PS: expected every variable in a PS group, got {t.ps_groups} and {t.buckets}")
    print(f"PS: {len(t.names)} variables, every one a PSSynchronizer on {anchor}, "
          f"{len(t.ps_groups)} dtype group(s) of {sum(t.shard_len.values())} elements")
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, flat_losses)]
    print("PS losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print("PS step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"PS (default builder): median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB, "
          f"launches {launches}")
    print(f"PS vs phase 5 (AllReduce): step 1 relative difference {rel[0]:.3e}, largest "
          f"over steps 2-{STEPS} {max(rel[1:]):.3e}; bitwise equal losses: "
          f"{losses == list(flat_losses)}")
    check(len(flat_losses) == STEPS, f"PS: expected {STEPS} phase-5 losses")
    check(all(math.isfinite(x) for x in losses), f"PS: non-finite loss in {losses}")
    check(statistics.mean(losses[-3:]) < losses[0],
          f"PS: the last three losses do not average below the first: {losses}")
    check(rel[0] <= PS_STEP1_TOL, f"PS: step 1 loss differs from phase 5's by {rel[0]}")
    check(max(rel[1:]) <= PS_LOSS_TOL, f"PS: a loss differs from phase 5's by {max(rel)}")
    per_step = config.num_layers * STEPS
    want = dict(NO_LAUNCHES, flash_fwd=per_step, flash_dq=per_step, flash_dkdv=per_step)
    check(launches == want, f"PS: expected launches {want}, got {launches}")
    profile_steps(torch, sess, batch)
    sess.fit(lambda step: batch, steps=PS_FIT_STEPS)
    check(sess.step == PS_FIT_STEPS, f"PS: fit ended at step {sess.step}")
    bad = sess.check_replication()
    check(bad == [], f"PS: check_replication names {bad}")
    check(all(bool(torch.isfinite(p).all()) for p in sess.state["params"].values()),
          "PS: non-finite parameters after training")
    print(f"PS: fit ran to step {sess.step}; check_replication() == []")
    _, _, grads, _ = t.gradients(sess.state, sess.shard_batch(batch))
    sync = time_ps_sync(torch, t, sess.state, grads)
    print("PS sync device time per step: " + ", ".join(f"{k} {v:.4f} ms"
                                                        for k, v in sync.items()))
    del sess, t, grads
    torch.cuda.empty_cache()

    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True, accum_steps=PS_ACCUM, clip_global_norm=PS_CLIP)
    for m in kernel_modules:
        m.reset_launches()
    metrics = [sess.run(batch) for _ in range(PS_ACCUM_RUN)]
    accum_losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    accum_launches = {n: c for m in kernel_modules for n, c in m.LAUNCHES.items()}
    accum_rel = abs(accum_losses[0] - flat_losses[0]) / abs(flat_losses[0])
    print(f"PS accum_steps={PS_ACCUM}, clip_global_norm={PS_CLIP}: losses "
          + ", ".join(f"{x:.6f}" for x in accum_losses) + ", grad_norm "
          + ", ".join(f"{x:.4f}" for x in norms)
          + f"; step 1 relative difference from phase 5 {accum_rel:.3e}")
    check(accum_rel <= PS_ACCUM_TOL, f"PS accum: step 1 differs from phase 5's by {accum_rel}")
    check(all(math.isfinite(x) and x > 0 for x in norms), f"PS accum: grad_norm {norms}")
    check(all(math.isfinite(x) for x in accum_losses), f"PS accum: losses {accum_losses}")
    per_run = config.num_layers * PS_ACCUM * PS_ACCUM_RUN
    want = dict(NO_LAUNCHES, flash_fwd=per_run, flash_dq=per_run, flash_dkdv=per_run)
    check(accum_launches == want, f"PS accum: expected launches {want}, got {accum_launches}")
    return {"launches": {k: launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkdv")},
            "step_ms": steady, "losses": losses, "peak_gb": peak_gb, "sync_ms": sync,
            "accum_losses": accum_losses, "grad_norms": norms}


def gpt2_batch(config, rows):
    """Phase 5's seeded token batch at ``rows`` sequences of SEQ."""
    import numpy as np

    toks = np.random.default_rng(0).integers(0, config.vocab_size, (rows, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}


def flash_launches(config, steps, forwards=1):
    """The launches of ``steps`` GPT-2 steps: ``forwards`` flash forwards a
    layer (2 under remat: the recompute), one dq and one dkdv."""
    per_step = config.num_layers * steps
    return dict(NO_LAUNCHES, flash_fwd=per_step * forwards, flash_dq=per_step,
                flash_dkdv=per_step)


def train_gpt2_bench(torch, ad, kernel_modules, phase5):
    """GPT-2 small as ``bench.py`` trains it (phase 13): remat, the
    streaming vocab loss, AllReduce, adamw, BENCH_BATCH sequences; then
    BENCH_B8_STEPS steps at phase 5's batch with the same options."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig(remat=True)
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0, streaming_loss=True)
    batch = gpt2_batch(config, BENCH_BATCH)
    # the dense head's loss on the same weights and batch (phase 5's
    # loss_fn), with the flash kernels and with the plain attention
    dense_loss_fn, _, _ = gpt_capture(GPTConfig(), SEQ, seed=0)
    plain_loss_fn, _, _ = gpt_capture(GPTConfig(attention_impl="xla"), SEQ, seed=0)
    with torch.no_grad():
        dev_batch = {n: torch.from_numpy(a).cuda() for n, a in batch.items()}
        dense_loss = dense_loss_fn(params, dev_batch).item()
        plain_loss = plain_loss_fn(params, dev_batch).item()
        streamed = loss_fn(params, dev_batch).item()
    del dense_loss_fn, plain_loss_fn, dev_batch
    torch.cuda.empty_cache()

    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    rel = abs(losses[0] - dense_loss) / abs(dense_loss)
    plain_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print("bench GPT-2 losses: " + ", ".join(f"{x:.5f}" for x in losses))
    print("bench GPT-2 step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"bench GPT-2 (B={BENCH_BATCH}, remat, streaming loss): median step {steady:.2f} ms "
          f"(steps 2-{STEPS}), {BENCH_BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB, launches {launches}")
    print(f"bench GPT-2 step 1 loss {losses[0]:.6f}; dense head {dense_loss:.6f} (the "
          f"streaming loss without gradients {streamed:.6f}), relative difference {rel:.3e}; "
          f"dense head with plain attention {plain_loss:.6f}, relative difference "
          f"{plain_rel:.3e}")
    check(all(math.isfinite(x) for x in losses), f"bench: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"bench: loss did not fall: {losses}")
    check(rel <= BENCH_LOSS_TOL, f"bench: step 1 loss differs from the dense head's by {rel}")
    check(plain_rel <= LOSS_REL_TOL,
          f"bench: step 1 loss differs from the plain-attention dense head's by {plain_rel}")
    want = flash_launches(config, STEPS, forwards=2)
    check(launches == want, f"bench: expected launches {want}, got {launches}")
    profile_steps(torch, sess, batch)
    del sess
    torch.cuda.empty_cache()

    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    b8_losses, b8_ms, b8_launches, b8_peak = timed_steps(
        torch, sess, gpt2_batch(config, BATCH), BENCH_B8_STEPS, kernel_modules)
    b8_rel = abs(b8_losses[0] - phase5["losses"][0]) / abs(phase5["losses"][0])
    print(f"bench GPT-2 at B={BATCH}: losses " + ", ".join(f"{x:.6f}" for x in b8_losses)
          + f"; step 1 relative difference from phase 5 {b8_rel:.3e}; step ms "
          + ", ".join(f"{x:.2f}" for x in b8_ms) + f"; peak memory {b8_peak:.2f} GB "
          f"(phase 5, dense head, no remat: {phase5['peak_gb']:.2f} GB)")
    check(b8_rel <= BENCH_LOSS_TOL, f"bench B={BATCH}: step 1 differs from phase 5's by {b8_rel}")
    want = flash_launches(config, BENCH_B8_STEPS, forwards=2)
    check(b8_launches == want, f"bench B={BATCH}: expected launches {want}, got {b8_launches}")
    return {"launches": {k: launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkdv")},
            "step_ms": steady, "losses": losses, "peak_gb": peak_gb,
            "dense_loss": dense_loss, "plain_loss": plain_loss, "b8_losses": b8_losses, "b8_step_ms": b8_ms,
            "b8_peak_gb": b8_peak}


def state_bytes(sess):
    """(flat-shard bytes, optimizer-state bytes) this rank holds."""
    shards = sum(t.numel() * t.element_size() for t in sess.state["shards"].values())
    opt = sum(v.numel() * v.element_size() for st in sess.state["opt_state"].state.values()
              for v in st.values() if hasattr(v, "numel") and v.dim())
    return shards, opt


def time_sharded_sync(torch, t, state, grads):
    """The sharded update's device time per step on ``grads`` (f32 for the
    bf16 master), and its parts: the buckets' reduce-scatter, adamw on the
    shards, the parameter all-gather (none for the bf16 master) and the
    bf16 master's top-of-step gather of its compute copy.  Each timed
    update takes an optimizer step: run it after the checks."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    shard_update = shard_optimizer_step(torch, state)
    scattered, _ = t.sync(grads, state["comp"])
    times = {
        "total": time_ms(lambda: (t.gather_compute_copies(state), t.update(state, grads)),
                         torch, flush, reps=10),
        "reduce-scatter": time_ms(lambda: t.sync(grads, state["comp"]), torch, flush, reps=10),
        "shard update (adamw)": time_ms(lambda: shard_update(scattered), torch, flush,
                                        reps=10),
    }
    if t.precision_buckets:
        times["top-of-step bf16 gather"] = time_ms(lambda: t.gather_compute_copies(state),
                                                   torch, flush, reps=10)
    else:
        times["all-gather + write-back"] = time_ms(lambda: t.gather_buckets(state), torch,
                                                   flush, reps=10)
    del flush, scattered
    return times


def train_gpt2_sharded(torch, ad, mode, kernel_modules, phase5):
    """Phase 14: phase 5's GPT-2 small, batch and weights under
    ``ad``'s ``AllReduce(sharded_update="sharded")`` or
    ``AllReduce(precision="bf16_master")`` (``mode``), STEPS adamw steps,
    held against phase 5's losses; ``check_replication`` and the sync's
    device time by parts."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    t = sess.transformer
    master = mode == "bf16_master"
    check(t.sync_sharded_update and t.sync_mixed_precision == master
          and sum(len(b.var_names) for b in t.sharded_buckets) == len(t.names),
          f"{mode}: expected every variable in a sharded bucket, got {t.sharded_buckets}")
    summary = t.sharded_update_summary()
    print(f"{mode}: {len(t.sharded_buckets)} sharded bucket(s) of "
          f"{summary['vars']} variables, {summary['shard_bytes'] / 1e9:.3f} GB of flat "
          f"shards, parameter gather {summary['param_gather_bytes'] / 1e9:.3f} GB")
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS,
                                                     kernel_modules)
    steady = statistics.median(step_ms[1:])
    flat_losses = phase5["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, flat_losses)]
    print(f"{mode} losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{mode} step ms: " + ", ".join(f"{x:.2f}" for x in step_ms))
    print(f"{mode}: median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB "
          f"(phase 5: {phase5['peak_gb']:.2f} GB), launches {launches}")
    print(f"{mode} vs phase 5 (replicated f32 update): step 1 relative difference "
          f"{rel[0]:.3e}, largest over steps 2-{STEPS} {max(rel[1:]):.3e}; bitwise equal "
          f"losses: {losses == list(flat_losses)}")
    check(all(math.isfinite(x) for x in losses), f"{mode}: non-finite loss in {losses}")
    check(statistics.mean(losses[-3:]) < losses[0],
          f"{mode}: the last three losses do not average below the first: {losses}")
    if master:
        check(rel[0] <= BF16_MASTER_TOL, f"{mode}: step 1 differs from phase 5's by {rel[0]}")
        dtypes = {str(p.dtype) for p in sess.params().values()}
        check(dtypes == {"torch.float32"}, f"{mode}: params() dtypes {dtypes}")
    else:
        check(rel[0] <= PS_STEP1_TOL, f"{mode}: step 1 differs from phase 5's by {rel[0]}")
        check(max(rel[1:]) <= PS_LOSS_TOL, f"{mode}: a loss differs from phase 5's by "
              f"{max(rel)}")
    want = flash_launches(config, STEPS)
    check(launches == want, f"{mode}: expected launches {want}, got {launches}")
    bad = sess.check_replication()
    check(bad == [], f"{mode}: check_replication names {bad}")
    profile_steps(torch, sess, batch)
    _, _, grads, _ = t.gradients(sess.state, sess.shard_batch(batch))
    sync = time_sharded_sync(torch, t, sess.state, grads)
    print(f"{mode} sync device time per step: " + ", ".join(f"{k} {v:.4f} ms"
                                                          for k, v in sync.items()))
    del sess, t, grads
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": steady, "peak_gb": peak_gb, "sync_ms": sync,
            "launches": {k: launches[k] for k in ("flash_fwd", "flash_dq", "flash_dkdv")}}


def sync_run(torch, ad, tag, kernel_modules, phase5, steps, accum=1, before=None):
    """One phase-15 variant: GPT-2 small on phase 5's weights and batch
    under ``ad``'s builder; ``before(torch, sess, batch)`` (its checks, returning
    numbers) runs first, then ``steps`` adamw steps, printed and checked
    for finite losses and the launches of SYNC_VARIANT_LAUNCHES[tag], and
    the profile of two more.  Returns (losses, numbers)."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True, accum_steps=accum)
    t = sess.transformer
    numbers = before(torch, sess, batch) if before is not None else {}
    torch.cuda.empty_cache()
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, steps, kernel_modules)
    steady = statistics.median(step_ms[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5["losses"])]
    print(f"{tag} ({t.sync_schedule} schedule, {t.sync_hierarchy} hierarchy, buckets "
          f"{[b.key for b in t.buckets]}) losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{tag}: step ms " + ", ".join(f"{x:.2f}" for x in step_ms) + f"; median "
          f"{steady:.2f} ms (steps 2-{steps}), {BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB (phase 5: {phase5['peak_gb']:.2f} GB), launches {launches}")
    print(f"{tag} vs phase 5: step 1 relative difference {rel[0]:.3e}, largest "
          f"{max(rel):.3e}; bitwise equal losses: {losses == phase5['losses'][:steps]}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss in {losses}")
    want = flash_launches(config, steps * accum)
    want.update({k: v * steps for k, v in SYNC_VARIANT_LAUNCHES.get(tag, {}).items()})
    check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    if tag == "overlap":   # the last step's hook-issued syncs, against _chunk_sizes
        issued, expected = t.last_overlap.issued, [
            (b.key, len(ar_sync.bucket_chunks(b))) for b in reversed(t.buckets)]
        print(f"overlap: the last step's hook-issued syncs (bucket, chunks), in issue order: "
              f"{issued}; {t.last_overlap.issued_in_backward} of {len(t.buckets)} buckets "
              f"issued before the backward pass returned")
        check(issued == expected and t.last_overlap.issued_in_backward == len(t.buckets),
              f"overlap: issued {issued}, expected {expected}, all from the hooks")
        numbers["issued"] = issued
    profile_steps(torch, sess, batch)
    bad = sess.check_replication()
    check(bad == [], f"{tag}: check_replication names {bad}")
    del sess, t
    torch.cuda.empty_cache()
    return losses, dict(numbers, losses=losses, step_ms=steady, peak_gb=peak_gb,
                        launches={k: launches[k] for k in launches if launches[k]},
                        bitwise_phase5=losses == phase5["losses"][:steps])


def sync_ms(torch, sync, group=None):
    """Device time of one after-backward sync (``sync()``; the codecs leave
    their input states as they were)."""
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    ms = time_ms(sync, torch, flush, reps=10, group=group)
    del flush
    return ms


def overlap_checks(torch, sess, batch):
    """(a): the device time of the overlap schedule's after-backward sync
    (``sync_overlapped``: the chunks in reverse order) and of the barrier's
    over the same gradients."""
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync

    t = sess.transformer
    _, _, grads, _ = t.gradients(sess.state, sess.shard_batch(batch))
    states = sess.state["comp"]
    times = {"overlapped chunks": sync_ms(torch, lambda: t.sync(grads, states), t.group),
             "barrier": sync_ms(torch, lambda: ar_sync.sync_bucketed(
                 grads, t.buckets, states, t.group), t.group)}
    print("overlap: the after-backward sync's device time over both buckets: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in times.items()))
    return {"sync_ms": times}


def codec_checks(torch, sess, batch):
    """(c') and (d): step 1's synced gradients, bitwise: through the
    kernels against the codec's plain versions (the two-level EQuARX DCN
    hop), or from the overlap hooks against the barrier schedule (Int8
    under overlap, kernels on both sides); and the sync's device time."""
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync

    t = sess.transformer
    dev_batch = sess.shard_batch(batch)
    _, _, grads, _ = t.gradients(sess.state, dev_batch)
    states = sess.state["comp"]
    if t.hook_buckets:
        _, _, _, _, got = t._gradients(dict(sess.state), dev_batch, t.hook_buckets)
        want, _ = ar_sync.sync_bucketed(grads, t.buckets, states, t.group)
        label = "the overlap hooks' synced gradients vs the barrier schedule's"
    else:
        got, _ = t.sync(grads, states)
        want, _ = t.sync(grads, states, impl="plain")
        label = "step 1's synced gradients through the kernels vs the codec's plain versions"
    torch.cuda.synchronize()
    err = bitwise_error(label, [got[n] for n in t.names], [want[n] for n in t.names])
    ms = sync_ms(torch, lambda: t.sync(grads, states), t.group)
    print(f"{label}: bitwise equal ({len(t.names)} tensors); the sync's device time "
          f"{ms:.4f} ms")
    return {"sync_max_abs_err": err, "sync_ms": ms}


def powersgd_checks(torch, sess, batch):
    """(e): step 1's PowerSGD iteration on each bucket from the initial Q:
    approx + residual recovers the corrected buffer, P is orthonormal, and
    approx matches an f64 run of the same iteration from the same M and Q;
    then the device time of the sync and of its parts."""
    from autodist_tpu_torch.kernel.synchronization import all_reduce as ar_sync
    from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor

    t = sess.transformer
    _, _, grads, _ = t.gradients(sess.state, sess.shard_batch(batch))
    comp = get_compressor(ar_sync._AR.PowerSGDCompressor)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    parts = dict.fromkeys(("whole sync", "GEMMs", "QR", "residual"), 0.0)
    worst = {"recovery": 0.0, "orthonormality": 0.0, "f64": 0.0}
    for b in t.buckets:
        buf = ar_sync._bucket_buf(grads, b)
        st0 = sess.state["comp"][b.key]
        approx, st = comp.all_reduce(buf, st0, t.group)
        M, P, Q = comp.iterate(buf, st0, t.group)
        corrected = buf.float() + st0["residual"]
        worst["recovery"] = max(worst["recovery"], float(
            (approx + st["residual"] - corrected).abs().max() / corrected.abs().max()))
        eye = torch.eye(P.shape[1], device=P.device)
        worst["orthonormality"] = max(worst["orthonormality"],
                                      float((P.T @ P - eye).abs().max()))
        M64 = M.double()
        P64, _ = torch.linalg.qr(M64 @ st0["Q"].double())
        ref = (P64 @ (M64.T @ P64).T).reshape(-1)[:buf.shape[0]]
        worst["f64"] = max(worst["f64"], float((approx.double() - ref).abs().max()
                                               / ref.abs().max()))
        del M64, P64, ref
        MQ = M @ st0["Q"]
        full = P @ Q.T
        parts["whole sync"] += time_ms(lambda: comp.all_reduce(buf, st0, t.group), torch,
                                       flush, reps=10)
        parts["GEMMs"] += time_ms(lambda: (M @ st0["Q"], M.T @ P, P @ Q.T), torch, flush,
                                  reps=10)
        parts["QR"] += time_ms(lambda: torch.linalg.qr(MQ), torch, flush, reps=10)
        parts["residual"] += time_ms(lambda: (M - full).reshape(-1)[:buf.shape[0]], torch,
                                     flush, reps=10)
        del M, P, Q, MQ, full, approx, st, buf
    print(f"PowerSGD step 1 over {len(t.buckets)} buckets: max |approx + residual - corrected| "
          f"/ max|corrected| {worst['recovery']:.3e}, max |P^T P - I| "
          f"{worst['orthonormality']:.3e}, approx vs the same iteration in f64 (relative) "
          f"{worst['f64']:.3e}")
    print("PowerSGD sync device time per step (both buckets): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items()))
    check(worst["recovery"] <= 1e-6, f"PowerSGD: approx + residual off by {worst['recovery']}")
    check(worst["orthonormality"] <= 1e-5, f"PowerSGD: P^T P - I reaches "
                                           f"{worst['orthonormality']}")
    check(worst["f64"] <= 1e-4, f"PowerSGD: approx differs from f64 by {worst['f64']}")
    del flush, grads
    return {"checks": worst, "sync_ms": parts}


def train_gpt2_sync_variants(torch, m, kernel_modules, phase5):
    """Phase 15: the AllReduce family's overlap schedule (with and without
    accumulation), two-level hierarchy (with and without an EQuARX DCN
    codec), the Int8 codec under overlap and PowerSGD, each its own
    ``AutoDist`` on phase 5's weights and batch."""
    from autodist_tpu_torch.resource_spec import ResourceSpec

    AllReduce = m["AllReduce"]
    two_level_spec = ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": [0], "chief": True}],
        "mesh": {"replica_dcn": 1, "replica_ici": 1}})
    flat = phase5["losses"]
    out = {}

    def within(tag, losses, step1_tol, later_tol):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, flat)]
        check(rel[0] <= step1_tol, f"{tag}: step 1 differs from phase 5's by {rel[0]}")
        check(max(rel) <= later_tol, f"{tag}: a loss differs from phase 5's by {max(rel)}")

    runs = (   # tag, builder, spec, steps, accum_steps, checks first, (step 1, later) tolerance
        ("overlap", AllReduce(schedule="overlap"), None, STEPS, 1, overlap_checks,
         (PS_STEP1_TOL, PS_LOSS_TOL)),
        ("overlap accum_steps=2", AllReduce(schedule="overlap"), None, SYNC_ACCUM_STEPS, 2,
         None, (PS_ACCUM_TOL, None)),
        ("two_level", AllReduce(hierarchy="two_level"), two_level_spec, CODEC_STEPS, 1, None,
         (PS_STEP1_TOL, PS_LOSS_TOL)),
        ("two_level EquarxInt8 DCN", AllReduce(hierarchy="two_level",
                                               dcn_compressor="EquarxInt8Compressor"),
         two_level_spec, CODEC_STEPS, 1, codec_checks, None),
        ("Int8 overlap", AllReduce(compressor="Int8Compressor", schedule="overlap"), None,
         SYNC_INT8_STEPS, 1, codec_checks, None),
        ("PowerSGD", AllReduce(compressor="PowerSGDCompressor"), None, CODEC_STEPS, 1,
         powersgd_checks, None),
    )
    for tag, builder, spec, steps, accum, before, tol in runs:
        ad = m["AutoDist"](resource_spec=spec or m["spec"], strategy_builder=builder)
        losses, out[tag] = sync_run(torch, ad, tag, kernel_modules, phase5, steps, accum,
                                    before)
        if tol and tol[1] is not None:
            within(tag, losses, *tol)
        elif tol:
            within(tag, losses[:1], tol[0], tol[0])
        if tag == "two_level EquarxInt8 DCN":
            check(statistics.mean(losses[-3:]) < losses[0],
                  f"{tag}: the last three losses do not average below the first: {losses}")
        del ad
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"].get(k, 0) for r in out.values())
                       for k in ("quantize_int8", "dequant_sum", "equarx_hop")}
    return out


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def train_gpt2_partitioned(torch, ad, tag, kernel_modules, phase5):
    """Phase 16's GPT-2 runs: phase 5's model, weights and batch under
    ``ad``'s partitioned builder, STEPS adamw steps, held against phase
    5's losses."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.partitioner import Placement
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    sharded = [n for n, p in sess.transformer.plans.items() if p.placement == Placement.SHARDED]
    print(f"{tag}: {len(sharded)} of {len(sess.transformer.names)} variables partitioned "
          f"(SHARDED storage)")
    check(sharded, f"{tag}: no variable was partitioned")
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS, kernel_modules)
    steady = statistics.median(step_ms[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5["losses"])]
    print(f"{tag} losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{tag}: median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB "
          f"(phase 5: {phase5['peak_gb']:.2f} GB), launches {launches}")
    print(f"{tag} vs phase 5: step 1 relative difference {rel[0]:.3e}, largest over steps "
          f"2-{STEPS} {max(rel[1:]):.3e}; bitwise equal losses: "
          f"{losses == list(phase5['losses'])}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss in {losses}")
    check(rel[0] <= PS_STEP1_TOL, f"{tag}: step 1 differs from phase 5's by {rel[0]}")
    check(max(rel[1:]) <= PS_LOSS_TOL, f"{tag}: a loss differs from phase 5's by {max(rel)}")
    want = flash_launches(config, STEPS)
    check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    del sess
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": steady, "peak_gb": peak_gb}


def ncf_batch(config, rows, seed=0):
    """``examples/benchmark.py``'s NCF batch, seeded: ``rows`` users, items
    and 0/1 labels."""
    import numpy as np

    r = np.random.RandomState(seed)
    return {"user": r.randint(0, config.num_users, (rows,)).astype(np.int32),
            "item": r.randint(0, config.num_items, (rows,)).astype(np.int32),
            "label": (r.rand(rows) < 0.5).astype(np.float32)}


def ncf_dense_loss(torch, rows):
    """One process's loss of the seeded weights on the global batch of
    ``rows`` examples, without ``AutoDist``, under ``no_grad``."""
    from autodist_tpu_torch.models.ncf import NCFConfig
    from autodist_tpu_torch.models.train_lib import ncf_capture

    config = NCFConfig()
    loss_fn, params, _ = ncf_capture(config, seed=0)
    with torch.no_grad():
        loss = loss_fn(params, {k: torch.from_numpy(v).cuda()
                                for k, v in ncf_batch(config, rows).items()}).item()
    del params
    torch.cuda.empty_cache()
    return loss


def train_ncf(torch, ad, tag, kernel_modules, rows=NCF_BATCH, steps=NCF_STEPS):
    """NCF at full width under ``ad``'s builder with its four tables in
    ``sparse_vars``: ``steps`` adam steps on ``rows`` seeded examples (the
    global batch).  Returns the run's numbers and its session."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.models.ncf import NCFConfig
    from autodist_tpu_torch.models.train_lib import ncf_capture

    config = NCFConfig()
    loss_fn, params, sparse = ncf_capture(config, seed=0)
    count = sum(t.numel() for t in params.values())
    sess = ad.distribute(loss_fn, params, optim.adam(NCF_LR), sparse_vars=sparse)
    del params
    plans = sess.transformer.plans
    print(f"{tag}: NCF {count / 1e6:.2f} M parameters, tables " + ", ".join(
        f"{n} {plans[n].placement.value} {plans[n].sync.value}" for n in sparse))
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, ncf_batch(config, rows),
                                                     steps, kernel_modules)
    steady = statistics.median(step_ms[1:])
    print(f"{tag} losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"{tag} step ms: " + ", ".join(f"{x:.3f}" for x in step_ms))
    print(f"{tag}: median step {steady:.3f} ms (steps 2-{steps}), {rows / steady * 1e3:.0f} "
          f"examples/s, peak memory {peak_gb:.3f} GB; {card_line()}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss in {losses}")
    check(launches == NO_LAUNCHES, f"{tag}: expected no kernel launch, got {launches}")
    return {"losses": losses, "step_ms": steady, "steps_ms": step_ms[1:],
            "peak_gb": peak_gb}, sess


def check_ncf_step1(runs, dense, tol=NCF_TOL):
    """Step 1 of each NCF run against the other's and one process's dense
    loss, relative."""
    (tag_a, a), (tag_b, b) = runs.items()
    between = abs(a["losses"][0] - b["losses"][0]) / abs(b["losses"][0])
    rel = {tag: abs(r["losses"][0] - dense) / abs(dense) for tag, r in runs.items()}
    print(f"NCF step 1: {tag_a} {a['losses'][0]:.7f}, {tag_b} {b['losses'][0]:.7f} "
          f"(relative {between:.3e}), one process's dense loss {dense:.7f} (relative "
          + ", ".join(f"{tag} {x:.3e}" for tag, x in rel.items()) + ")")
    check(between <= tol, f"NCF: step 1 differs between {tag_a} and {tag_b} by {between}")
    for tag, x in rel.items():
        check(x <= tol, f"NCF {tag}: step 1 differs from one process's dense loss by {x}")


def train_partitioned(torch, m, kernel_modules, phase5):
    """Phase 16: GPT-2 small under the partitioned builders, NCF at full
    width under Parallax and PartitionedPS, one ``AutoDist`` each."""
    from autodist_tpu_torch.models.ncf import NCFConfig
    from autodist_tpu_torch.strategy import Parallax, PartitionedAR, PartitionedPS

    out = {"gpt2": {}, "ncf": {}}
    for tag, builder in (("PartitionedPS", PartitionedPS(max_shards=PART_MAX_SHARDS)),
                         ("PartitionedAR", PartitionedAR(max_shards=PART_MAX_SHARDS))):
        ad = m["AutoDist"](resource_spec=m["spec"], strategy_builder=builder)
        out["gpt2"][tag] = train_gpt2_partitioned(torch, ad, tag, kernel_modules, phase5)
    dense = ncf_dense_loss(torch, NCF_BATCH)
    for tag, builder in (("Parallax", Parallax()),
                         ("PartitionedPS", PartitionedPS(max_shards=PART_MAX_SHARDS))):
        ad = m["AutoDist"](resource_spec=m["spec"], strategy_builder=builder)
        out["ncf"][tag], sess = train_ncf(torch, ad, f"NCF {tag}", kernel_modules)
        profile_steps(torch, sess, ncf_batch(NCFConfig(), NCF_BATCH))
        del sess
        torch.cuda.empty_cache()
    check_ncf_step1(out["ncf"], dense)
    return out


def train_gpt2_divergent(torch, ad, kernel_modules, phase5):
    """Phase 17 (a): phase 5's GPT-2 small, weights and batch under
    ``PS(staleness=STALE_S)`` at R = 1, STEPS adamw steps, held against
    phase 5's losses."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.partitioner import Placement
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    t = sess.transformer
    plans = t.plans
    divergent = [n for n, p in plans.items() if p.placement == Placement.DIVERGENT]
    nonscalar = [n for n, p in plans.items() if p.shape]
    print(f"PS(staleness={STALE_S}): {len(divergent)} of {len(plans)} variables DIVERGENT "
          f"(sync period {plans[divergent[0]].sync_period if divergent else None}), "
          f"{len(t.buckets)} sync buckets")
    check(divergent == nonscalar and t.buckets == [],
          f"PS(staleness={STALE_S}): expected every non-scalar variable DIVERGENT and no "
          f"bucket, got {len(divergent)} of {len(nonscalar)} and {len(t.buckets)} buckets")
    losses, step_ms, launches, peak_gb = timed_steps(torch, sess, batch, STEPS, kernel_modules)
    steady = statistics.median(step_ms[1:])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5["losses"])]
    print("DIVERGENT losses: " + ", ".join(f"{x:.6f}" for x in losses))
    print(f"DIVERGENT: median step {steady:.2f} ms (steps 2-{STEPS}), "
          f"{BATCH * SEQ / steady * 1e3:.0f} tokens/s, peak memory {peak_gb:.2f} GB "
          f"(phase 5: {phase5['peak_gb']:.2f} GB), launches {launches}")
    print(f"DIVERGENT vs phase 5: step 1 relative difference {rel[0]:.3e}, largest over steps "
          f"2-{STEPS} {max(rel[1:]):.3e}; bitwise equal losses: "
          f"{losses == list(phase5['losses'])}")
    check(all(math.isfinite(x) for x in losses), f"DIVERGENT: non-finite loss in {losses}")
    check(rel[0] <= PS_STEP1_TOL, f"DIVERGENT: step 1 differs from phase 5's by {rel[0]}")
    check(max(rel[1:]) <= PS_LOSS_TOL, f"DIVERGENT: a loss differs from phase 5's by {max(rel)}")
    want = flash_launches(config, STEPS)
    check(launches == want, f"DIVERGENT: expected launches {want}, got {launches}")
    check(sess.check_replication() == [], "DIVERGENT: check_replication() names variables")
    del sess, t
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": steady, "peak_gb": peak_gb, "launches": launches}


def async_report(torch, tag, sess, kernel_modules, steps, workers):
    """Print an async run's losses, its pushes' host times and each
    worker's step time; check its launches (12 a step of each flash
    kernel) and finite losses; returns the run's numbers."""
    from autodist_tpu_torch.models.gpt import GPTConfig

    launches = {n: c for m in kernel_modules for n, c in m.LAUNCHES.items()}
    history = sorted(sess.history, key=lambda h: h[1])
    losses = [loss for _, _, loss in history]
    timings = sess.timings
    copy_ms = [t["copy_s"] * 1e3 for t in timings]
    update_ms = [t["update_s"] * 1e3 for t in timings]
    print(f"{tag} losses by version: " + ", ".join(f"w{w} v{v} {x:.6f}"
                                                    for w, v, x in history))
    print(f"{tag}: push host copy ms " + ", ".join(f"{x:.1f}" for x in copy_ms)
          + "; host update ms " + ", ".join(f"{x:.1f}" for x in update_ms))
    step_ms = {}
    for w in range(workers):
        mine = [t["step_s"] * 1e3 for t in timings if t["worker"] == w]
        step_ms[w] = statistics.median(mine)
        print(f"{tag}: worker {w} step ms " + ", ".join(f"{x:.1f}" for x in mine)
              + f" (median {step_ms[w]:.1f}; pull + value and gradient "
              + ", ".join(f"{t['grads_s'] * 1e3:.1f}" for t in timings if t["worker"] == w)
              + ")")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}: version {sess.version}, max lead {sess.barrier.max_lead_seen}, stale "
          f"pushes {sess.stale_pushes}, peak memory {peak_gb:.2f} GB, launches {launches}; "
          f"{card_line()}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss in {losses}")
    want = flash_launches(GPTConfig(), steps * workers)
    check(launches == want, f"{tag}: expected launches {want}, got {launches}")
    return {"losses": losses, "version": sess.version, "max_lead": sess.barrier.max_lead_seen,
            "stale_pushes": sess.stale_pushes, "copy_ms": copy_ms, "update_ms": update_ms,
            "step_ms": step_ms, "peak_gb": peak_gb, "launches": launches}


def train_async(torch, m, kernel_modules, phase5):
    """Phase 17 (b) and (c): the async engine session through ``distribute``
    with one worker on the card, then two worker threads on ``cuda:0``."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.kernel.synchronization.async_ps import (AsyncPSEngineSession,
                                                                    AsyncPSSession)
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.strategy import PS

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    out = {}
    ad = m["AutoDist"](resource_spec=m["spec"],
                       strategy_builder=PS(sync=False, staleness=ASYNC_ENGINE_S))
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse,
                         has_rng=True)
    check(isinstance(sess, AsyncPSEngineSession) and sess.num_workers == 1,
          f"PS(sync=False): expected the async engine session with one worker, got "
          f"{type(sess).__name__}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for km in kernel_modules:
        km.reset_launches()
    sess.run([[batch]], ASYNC_STEPS, timeout=300)
    out["engine"] = async_report(torch, "async engine (1 worker)", sess, kernel_modules,
                                 ASYNC_STEPS, 1)
    rel = abs(out["engine"]["losses"][0] - phase5["losses"][0]) / abs(phase5["losses"][0])
    print(f"async engine: step 1 relative difference from phase 5 {rel:.3e}")
    check(rel <= PS_STEP1_TOL, f"async engine: step 1 differs from phase 5's by {rel}")
    check(sess.version == ASYNC_STEPS, f"async engine: version {sess.version}")
    del sess
    torch.cuda.empty_cache()

    sess = AsyncPSSession(loss_fn, params, optim.adamw(3e-4), staleness=ASYNC_THREADS_S,
                          devices=["cuda:0", "cuda:0"], has_rng=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for km in kernel_modules:
        km.reset_launches()
    sess.run([[batch], [batch]], ASYNC_STEPS, delays=list(ASYNC_DELAYS), timeout=300)
    out["threads"] = async_report(torch, "async 2 workers on cuda:0", sess, kernel_modules,
                                  ASYNC_STEPS, 2)
    check(sess.version == 2 * ASYNC_STEPS, f"async threads: version {sess.version}")
    check(sess.barrier.max_lead_seen <= ASYNC_THREADS_S,
          f"async threads: lead {sess.barrier.max_lead_seen} over the bound")
    check(sess.stale_pushes >= 1, "async threads: no stale push")
    del sess
    torch.cuda.empty_cache()
    return out


def train_stale(torch, m, kernel_modules, phase5):
    """Phase 17: DIVERGENT GPT-2 small, then the async runs."""
    from autodist_tpu_torch.strategy import PS

    ad = m["AutoDist"](resource_spec=m["spec"], strategy_builder=PS(staleness=STALE_S))
    out = {"divergent": train_gpt2_divergent(torch, ad, kernel_modules, phase5)}
    out.update(train_async(torch, m, kernel_modules, phase5))
    out["launches"] = {k: sum(out[r]["launches"][k] for r in ("divergent", "engine", "threads"))
                       for k in ("flash_fwd", "flash_dq", "flash_dkdv")}
    return out


def dir_bytes(path):
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


class CheckpointClock:
    """Times every ``Saver`` save and restore of the process (``fit``
    calls them itself): seconds (the device drained before and after),
    bytes on disk and GB/s; ``undo()`` puts the methods back."""

    def __init__(self, torch):
        from autodist_tpu_torch.checkpoint.saver import Saver

        self.records, self._saved = [], {}
        for name in ("save", "save_sharded", "restore"):
            real = getattr(Saver, name)
            self._saved[name] = real

            def timed(saver, path, *args, _real=real, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(saver, path, *args, **kwargs)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                nbytes = dir_bytes(os.path.abspath(path))
                self.records.append({"op": _name, "path": os.path.basename(path),
                                     "step": saver._sess.step, "s": secs, "bytes": nbytes,
                                     "gb_s": nbytes / secs / 1e9})
                print(f"checkpoint {_name} {os.path.basename(path)} at step "
                      f"{saver._sess.step}: {secs:.3f} s, {nbytes / 1e9:.3f} GB, "
                      f"{nbytes / secs / 1e9:.3f} GB/s")
                return out

            setattr(Saver, name, timed)

    def undo(self):
        from autodist_tpu_torch.checkpoint.saver import Saver

        for name, real in self._saved.items():
            setattr(Saver, name, real)


def recorded_runs(sess):
    """``sess.run`` wrapped to record each step's loss (read at once) and
    milliseconds; returns the two lists it fills."""
    losses, step_ms = [], []
    run = sess.run

    def timed(batch, *args, **kwargs):
        t0 = time.perf_counter()
        metrics = run(batch, *args, **kwargs)
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    sess.run = timed
    return losses, step_ms


def train_gpt2_ckpt(torch, m, kernel_modules, phase5):
    """Phase 18: checkpoints of phase 5's GPT-2 small under the default
    builder; see the module's docstring."""
    import shutil
    import signal

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint import manifest
    from autodist_tpu_torch.checkpoint.saver import Saver
    from autodist_tpu_torch.models.convert import jax_to_torch_name
    from autodist_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    ckpt, ckpt5, sharded, preempt = (os.path.join(CKPT_DIR, n) for n in (
        "fit", "fit_step5", "sharded", "preempt"))

    def session():   # the default builder, PSLoadBalancing: flat optimizer shards
        return m["AutoDist"](resource_spec=m["spec"]).distribute(
            loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse, has_rng=True)

    def launches():
        return {n: c for km in kernel_modules for n, c in km.LAUNCHES.items()}

    def reset():
        for km in kernel_modules:
            km.reset_launches()

    clock = CheckpointClock(torch)
    out = {"card": card_line()}
    print(f"phase 18 on {out['card']}")
    try:
        # (a) fit with a canonical checkpoint every CKPT_SAVE_EVERY steps
        def batch_fn(step):
            if step == CKPT_SAVE_EVERY:   # keep the step-5 checkpoint for (b): hard links
                shutil.copytree(ckpt, ckpt5, copy_function=os.link)
                shutil.copy(manifest.manifest_path(ckpt), manifest.manifest_path(ckpt5))
            return batch

        sess = session()
        check(sess.transformer.sharded_buckets and not sess.transformer.sharded_names,
              "ckpt: expected the default builder's flat shards")
        losses, step_ms = recorded_runs(sess)
        reset()
        t0 = time.perf_counter()
        sess.fit(batch_fn, STEPS, checkpoint_path=ckpt, save_every=CKPT_SAVE_EVERY)
        fit_s = time.perf_counter() - t0
        fit_launches = launches()
        losses, step_ms = list(losses), list(step_ms)   # the fit's steps alone
        saves = [r for r in clock.records if r["op"] == "save"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5["losses"])]
        steady = statistics.median(step_ms[1:])
        save_s = sum(r["s"] for r in saves)
        print("ckpt (a) fit losses: " + ", ".join(f"{x:.6f}" for x in losses))
        print(f"ckpt (a): fit {STEPS} steps in {fit_s:.2f} s, median step {steady:.2f} ms; "
              f"{len(saves)} canonical saves, {save_s:.3f} s, "
              f"{1e3 * save_s / STEPS:.2f} ms a step over the run "
              f"({100 * save_s / STEPS / (steady / 1e3):.1f} % of the median step); "
              f"vs phase 5: step 1 relative {rel[0]:.3e}, largest over steps 2-{STEPS} "
              f"{max(rel[1:]):.3e}; bitwise equal losses: {losses == list(phase5['losses'])}; "
              f"launches {fit_launches}; {out['card']}")
        check(len(losses) == STEPS and rel[0] <= PS_STEP1_TOL and max(rel[1:]) <= PS_LOSS_TOL,
              f"ckpt (a): losses {losses} against phase 5's {phase5['losses']}")
        check([r["step"] for r in saves] == [CKPT_SAVE_EVERY, STEPS],
              f"ckpt (a): expected saves at steps {CKPT_SAVE_EVERY} and {STEPS}: {saves}")
        m5 = manifest.load_manifest(ckpt5)
        check(m5["layout"] == "canonical" and m5["step"] == CKPT_SAVE_EVERY,
              f"ckpt (a): the step-{CKPT_SAVE_EVERY} manifest {m5}")
        check(fit_launches == flash_launches(config, STEPS),
              f"ckpt (a): expected launches {flash_launches(config, STEPS)}, got {fit_launches}")
        out["a"] = {"losses": losses, "step_ms": step_ms, "median_ms": steady, "fit_s": fit_s,
                    "saves": saves}

        # (c) the live state as laid out, restored into a fresh session
        Saver(sess).save_sharded(sharded)
        loss11 = sess.run(batch)["loss"].item()
        del sess
        torch.cuda.empty_cache()

        # (b) a fresh session resumes from the step-5 checkpoint
        sess = session()
        resumed, _ = recorded_runs(sess)
        reset()
        sess.fit(lambda step: batch, STEPS, checkpoint_path=ckpt5)
        restore = next(r for r in clock.records if r["op"] == "restore")
        print("ckpt (b) resumed losses, steps 6-10: " + ", ".join(f"{x:.6f}" for x in resumed)
              + f"; bitwise equal to (a)'s: {resumed == losses[CKPT_SAVE_EVERY:]}; restore "
              f"{restore['s']:.3f} s ({restore['gb_s']:.3f} GB/s); {out['card']}")
        check(resumed == losses[CKPT_SAVE_EVERY:],
              f"ckpt (b): steps 6-10 {resumed} differ from (a)'s {losses[CKPT_SAVE_EVERY:]}")
        check(launches() == flash_launches(config, STEPS - CKPT_SAVE_EVERY),
              f"ckpt (b): launches {launches()}")
        del sess
        torch.cuda.empty_cache()

        sess = session()
        Saver(sess).restore(sharded)
        m_us = manifest.load_manifest(sharded)
        again = sess.run(batch)["loss"].item()
        print(f"ckpt (c) save_sharded at step {STEPS} restored: step-{STEPS + 1} loss "
              f"{again:.6f}, the saving session's {loss11:.6f}, bitwise equal: "
              f"{again == loss11}; {out['card']}")
        check(m_us["layout"] == "update_space" and m_us["step"] == STEPS,
              f"ckpt (c): manifest {m_us}")
        check(again == loss11, f"ckpt (c): step {STEPS + 1} loss {again} != {loss11}")
        del sess
        torch.cuda.empty_cache()

        # (d) SIGTERM before step CKPT_PREEMPT_STEP of run_steps, then a re-run
        def batches():
            for step in range(STEPS):
                if step == CKPT_PREEMPT_STEP - 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        sess = session()
        sess.run_steps(batches(), preempt_checkpoint_dir=preempt)
        m_pre = manifest.load_manifest(os.path.join(preempt, "preempt_ckpt"))
        check(sess.preempted and sess.step == CKPT_PREEMPT_STEP
              and m_pre["layout"] == "update_space" and m_pre["step"] == CKPT_PREEMPT_STEP,
              f"ckpt (d): preempted {sess.preempted} at step {sess.step}, manifest {m_pre}")
        del sess
        torch.cuda.empty_cache()
        sess = session()
        rerun, _ = recorded_runs(sess)
        sess.fit(lambda step: batch, CKPT_RERUN_STEPS, preempt_checkpoint_dir=preempt)
        want = losses[CKPT_PREEMPT_STEP:CKPT_RERUN_STEPS]
        print(f"ckpt (d) SIGTERM before step {CKPT_PREEMPT_STEP}: preempted at step "
              f"{CKPT_PREEMPT_STEP}, update-space manifest; the re-run's steps "
              f"{CKPT_PREEMPT_STEP + 1}-{CKPT_RERUN_STEPS}: "
              + ", ".join(f"{x:.6f}" for x in rerun) + f", bitwise equal to (a)'s: "
              f"{rerun == want}; {out['card']}")
        check(rerun == want, f"ckpt (d): re-run losses {rerun} differ from (a)'s {want}")
        del sess
        torch.cuda.empty_cache()

        # (e) a plain single-device GPT on the card from the canonical checkpoint
        t0 = time.perf_counter()
        raw = Saver.restore_single_device(ckpt)
        read_s = time.perf_counter() - t0
        model = GPT(config, device="cuda")
        model.load_state_dict({jax_to_torch_name(n): v for n, v in raw["params"].items()})
        dev = {n: torch.from_numpy(a).cuda() for n, a in batch.items()}
        with torch.no_grad():
            plain = gpt_loss(model(dev["tokens"]), dev["targets"]).item()
        rel_e = abs(plain - loss11) / abs(loss11)
        print(f"ckpt (e) restore_single_device: {read_s:.3f} s, step {raw['step']}; a plain "
              f"GPT on the card: loss {plain:.6f}, the session's step-{STEPS + 1} loss "
              f"{loss11:.6f}, relative {rel_e:.3e}, bitwise equal: {plain == loss11}; "
              f"{out['card']}")
        check(raw["step"] == STEPS and rel_e <= CKPT_SINGLE_TOL,
              f"ckpt (e): step {raw['step']}, relative difference {rel_e}")
        del model, raw
        out.update(records=clock.records, loss11=loss11, plain_loss=plain, read_s=read_s)
        out["launches"] = {k: fit_launches[k] + v for k, v in launches().items()}
    finally:
        clock.undo()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def train_gpt2_elastic(torch, m, kernel_modules, phase5):
    """Phase 19: the elastic trainer on phase 5's GPT-2 small under the
    default builder; see the module's docstring."""
    import shutil

    from autodist_tpu_torch import optim
    from autodist_tpu_torch.checkpoint import manifest
    from autodist_tpu_torch.elastic import ElasticTrainer
    from autodist_tpu_torch.models.gpt import GPTConfig
    from autodist_tpu_torch.models.train_lib import gpt_capture

    config = GPTConfig()
    loss_fn, params, sparse = gpt_capture(config, SEQ, seed=0)
    batch = gpt2_batch(config, BATCH)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)

    def trainer(run, chaos, **kw):   # the default builder, PSLoadBalancing
        return ElasticTrainer(m["spec"], None, loss_fn, params, optim.adamw(3e-4),
                              checkpoint_dir=os.path.join(CKPT_DIR, run),
                              distribute_kwargs={"sparse_vars": sparse, "has_rng": True},
                              verify_restore=False, chaos=chaos, **kw)

    def launches():
        return {n: c for km in kernel_modules for n, c in km.LAUNCHES.items()}

    def reset():
        for km in kernel_modules:
            km.reset_launches()

    def losses_of(t):
        return [loss for _, _, loss in t.history]

    clock = CheckpointClock(torch)
    out = {"card": card_line()}
    print(f"phase 19 on {out['card']}")
    want5 = list(phase5["losses"])
    total = dict(NO_LAUNCHES)
    try:
        # (a) a kill and a delay: the membership change at R = 1 -> 1
        torch.cuda.reset_peak_memory_stats()
        t = trainer("a", ELASTIC_CHAOS["a"])
        reset()
        t0 = time.perf_counter()
        t.fit(lambda step: batch, STEPS)
        fit_s = time.perf_counter() - t0
        got = launches()
        losses = losses_of(t)
        (change,) = t.membership_changes
        peak = torch.cuda.max_memory_allocated() / 1e9
        print("elastic (a) losses: " + ", ".join(f"{x:.6f}" for x in losses)
              + f"; bitwise phase 5's: {losses == want5}; epochs "
              f"{[e for e, _, _ in t.history]}; replans {t.replans}")
        print(f"elastic (a) membership change at step {change['step']} (R = "
              f"{change['replicas_before']} -> {change['replicas_after']}): drain "
              f"{change['drain_s']:.4f} s, save {change['save_s']:.3f} s, shrink "
              f"{change['shrink_s']:.4f} s, rebind + distribute {change['replan_s']:.3f} s, "
              f"restore {change['restore_s']:.3f} s; fit {fit_s:.2f} s; peak memory "
              f"{peak:.2f} GB; launches {got}; {out['card']}")
        check(t.replans == 1 and t.epoch == 1 and not t.left,
              f"elastic (a): replans {t.replans}, epoch {t.epoch}, left {t.left}")
        check(losses == want5, f"elastic (a): losses {losses} are not phase 5's {want5}")
        check(got == flash_launches(config, STEPS),
              f"elastic (a): expected launches {flash_launches(config, STEPS)}, got {got}")
        total = {k: total[k] + v for k, v in got.items()}
        out["a"] = {"losses": losses, "change": change, "fit_s": fit_s, "peak_gb": peak}
        del t
        torch.cuda.empty_cache()

        # (b) SIGTERM before step ELASTIC_PREEMPT_STEP + 1, then a fresh trainer resumes
        t = trainer("b", ELASTIC_CHAOS["b"])
        reset()
        sess = t.fit(lambda step: batch, STEPS)
        m_b = manifest.load_manifest(os.path.join(CKPT_DIR, "b", "elastic_ckpt"))
        check(sess.preempted and sess.step == ELASTIC_PREEMPT_STEP
              and m_b["layout"] == "update_space" and m_b["step"] == ELASTIC_PREEMPT_STEP,
              f"elastic (b): preempted {sess.preempted} at step {sess.step}, manifest {m_b}")
        del sess, t
        torch.cuda.empty_cache()
        t = trainer("b", "")
        t.fit(lambda step: batch, ELASTIC_RERUN_STEPS)
        got = launches()
        rerun = losses_of(t)
        want = losses[ELASTIC_PREEMPT_STEP:ELASTIC_RERUN_STEPS]
        print(f"elastic (b) preempt@{ELASTIC_PREEMPT_STEP}: preempted at step "
              f"{ELASTIC_PREEMPT_STEP}, update-space manifest; the resumed steps "
              f"{ELASTIC_PREEMPT_STEP + 1}-{ELASTIC_RERUN_STEPS}: "
              + ", ".join(f"{x:.6f}" for x in rerun) + f", bitwise (a)'s: {rerun == want}; "
              f"launches {got}; {out['card']}")
        check(rerun == want, f"elastic (b): resumed losses {rerun} differ from (a)'s {want}")
        check(got == flash_launches(config, ELASTIC_RERUN_STEPS),
              f"elastic (b): launches {got}")
        total = {k: total[k] + v for k, v in got.items()}
        out["b"] = {"rerun": rerun}
        del t
        torch.cuda.empty_cache()

        # (c) a poisoned batch fires the on_anomaly hook
        fired = []
        t = trainer("c", ELASTIC_CHAOS["c"], on_anomaly=fired.append)
        t.fit(lambda step: batch, ELASTIC_NAN_STEPS)
        print(f"elastic (c) nan@3: on_anomaly fired {[(f['check'], f['step']) for f in fired]}; "
              f"losses " + ", ".join(f"{x:.6f}" for x in losses_of(t)))
        check([(f["check"], f["step"]) for f in fired] == [("nonfinite", 3)],
              f"elastic (c): on_anomaly fired {fired}")
        del t
        torch.cuda.empty_cache()

        # (d) launch on the one-GPU spec is distribute
        ad = m["AutoDist"](resource_spec=m["spec"])
        sess = ad.launch(loss_fn, params, optim.adamw(3e-4), sparse_vars=sparse, has_rng=True)
        reset()
        loss1 = sess.run(batch)["loss"].item()
        got = launches()
        print(f"elastic (d) launch on one GPU: step 1 loss {loss1:.6f}, phase 5's "
              f"{want5[0]:.6f}, bitwise equal: {loss1 == want5[0]}; launches {got}")
        check(loss1 == want5[0], f"elastic (d): step 1 loss {loss1} != phase 5's {want5[0]}")
        check(got == flash_launches(config, 1), f"elastic (d): launches {got}")
        total = {k: total[k] + v for k, v in got.items()}
        del sess, ad
        torch.cuda.empty_cache()
        out.update(records=clock.records, launches=total)
    finally:
        clock.undo()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def run_child(args, marker):
    """``chip_smoke.py ARGS`` in a process of its own (``AutoDist`` is one
    instance per process); forwards its output and returns its ``MARKER``
    JSON result."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(marker + " "):
            result = json.loads(line[len(marker) + 1:])
        else:
            print(line)
    print(f"{' '.join(args)}: run took {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0 and result is not None,
          f"{' '.join(args)} run failed (exit {proc.returncode}):\n{proc.stderr[-3000:]}")
    return result


def report_registers(build, kernels=("wgmma_dq_kernel", "wgmma_dkdv_kernel")):
    """Each instantiation of ``kernels`` with its registers and spills, as
    ``-Xptxas -v`` reported them in the build log of flash_attention.cu."""
    path = os.path.join(build.BUILD_DIR, "flash_attention.log")
    if not os.path.exists(path):
        print(f"ptxas: no build log at {path}")
        return
    with open(path) as f:
        lines = f.read().splitlines()
    entry, found = None, {}
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if any(k in name for k in kernels) else None
        elif entry and "spill" in line:
            found[entry] = [line.strip()]
        elif entry and "Used" in line and entry in found:
            found[entry].append(line.split(":", 1)[1].strip())
            entry = None
    names = list(found)
    try:   # demangled names, where the host has c++filt
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=30).stdout.splitlines() or names
    except OSError:
        pass
    for name, info in zip(names, found.values()):
        short = next((w.split("(")[0] for w in name.split("::") if w.startswith(kernels)), name)
        print(f"ptxas [{short}]: {'; '.join(info)}")


def setup(torch):
    """The checks every process of the script makes first; returns the
    port's modules, or None after printing why it cannot run."""
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this smoke test runs on a GPU", file=sys.stderr)
        return None
    sys.path.insert(0, REPO)
    try:
        import autodist_tpu_torch.autodist as autodist
        from autodist_tpu_torch.ops import build
        from autodist_tpu_torch.ops import flash_attention as fa
        from autodist_tpu_torch.ops import fused_norm as fn
        from autodist_tpu_torch.ops import quantize as tq
        from autodist_tpu_torch.resource_spec import ResourceSpec
        from autodist_tpu_torch.strategy import AllReduce
    except ImportError as e:
        print(f"FAIL: run from a checkout of the repo ({e})", file=sys.stderr)
        return None
    # full-f32 products: the GPT head is an f32 matmul, as in the JAX model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": [0], "chief": True}]})
    ring_spec = ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": [0], "chief": True}], "mesh": {"replica": 1, "seq": 1}})
    return dict(AutoDist=autodist.AutoDist, build=build, fa=fa, fn=fn, tq=tq, spec=spec,
                ring_spec=ring_spec, AllReduce=AllReduce)


def codec_main(codec):
    """``chip_smoke.py --codec NAME``: one compressed AllReduce run (phase 9)."""
    import torch

    m = setup(torch)
    if m is None:
        return 1
    try:
        check(codec in CODECS, f"unknown codec {codec!r}; expected one of {list(CODECS)}")
        ad = m["AutoDist"](resource_spec=m["spec"],
                           strategy_builder=m["AllReduce"](compressor=codec))
        result = train_gpt2_codec(torch, ad, codec, (m["fa"], m["fn"], m["tq"]))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("CODEC_RESULT " + json.dumps(result))
    return 0


def ring_main(flat_loss):
    """``chip_smoke.py --ring LOSS``: the ring-of-one training run (phase 11)."""
    import torch

    m = setup(torch)
    if m is None:
        return 1
    try:
        ad = m["AutoDist"](resource_spec=m["ring_spec"], strategy_builder=m["AllReduce"]())
        result = train_gpt2_ring(torch, ad, (m["fa"], m["fn"], m["tq"]), float(flat_loss))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("RING_RESULT " + json.dumps(result))
    return 0


def ps_main(flat_losses):
    """``chip_smoke.py --ps LOSSES``: the default builder's run (phase 12);
    LOSSES is phase 5's JSON list of losses."""
    import torch

    m = setup(torch)
    if m is None:
        return 1
    try:
        ad = m["AutoDist"](resource_spec=m["spec"])
        result = train_gpt2_ps(torch, ad, m["spec"], (m["fa"], m["fn"], m["tq"]),
                               json.loads(flat_losses))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("PS_RESULT " + json.dumps(result))
    return 0


def bench_gpt_main(phase5):
    """``chip_smoke.py --bench-gpt PHASE5``: bench.py's GPT-2 configuration
    (phase 13); PHASE5 is phase 5's JSON losses and peak memory."""
    import torch

    m = setup(torch)
    if m is None:
        return 1
    try:
        ad = m["AutoDist"](resource_spec=m["spec"], strategy_builder=m["AllReduce"]())
        result = train_gpt2_bench(torch, ad, (m["fa"], m["fn"], m["tq"]), json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("BENCH_GPT_RESULT " + json.dumps(result))
    return 0


def sharded_main(phase5):
    """``chip_smoke.py --sharded PHASE5``: the sharded update and the bf16
    master (phase 14), one ``AutoDist`` each in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # two AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = {}
        for mode, kwargs in (("sharded", {"sharded_update": "sharded"}),
                             ("bf16_master", {"precision": "bf16_master"})):
            ad = m["AutoDist"](resource_spec=m["spec"],
                               strategy_builder=m["AllReduce"](**kwargs))
            result[mode] = train_gpt2_sharded(torch, ad, mode, (m["fa"], m["fn"], m["tq"]),
                                              json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("SHARDED_RESULT " + json.dumps(result))
    return 0


def sync_variants_main(phase5):
    """``chip_smoke.py --sync-variants PHASE5``: the overlap schedule, the
    two-level hierarchy, the Int8 codec under overlap and PowerSGD (phase
    15), one ``AutoDist`` each in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # several AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = train_gpt2_sync_variants(torch, m, (m["fa"], m["fn"], m["tq"]),
                                          json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("SYNC_VARIANTS_RESULT " + json.dumps(result))
    return 0


def partitioned_main(phase5):
    """``chip_smoke.py --partitioned PHASE5``: the synchronous PS family
    (phase 16), one ``AutoDist`` each in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # several AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = train_partitioned(torch, m, (m["fa"], m["fn"], m["tq"]), json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("PARTITIONED_RESULT " + json.dumps(result))
    return 0


def stale_main(phase5):
    """``chip_smoke.py --stale PHASE5``: bounded staleness (phase 17), one
    ``AutoDist`` each in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # several AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = train_stale(torch, m, (m["fa"], m["fn"], m["tq"]), json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("STALE_RESULT " + json.dumps(result))
    return 0


def ckpt_main(phase5):
    """``chip_smoke.py --ckpt PHASE5``: checkpoints (phase 18), one
    ``AutoDist`` a session in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # several AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = train_gpt2_ckpt(torch, m, (m["fa"], m["fn"], m["tq"]), json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("CKPT_RESULT " + json.dumps(result))
    return 0


def elastic_main(phase5):
    """``chip_smoke.py --elastic PHASE5``: elastic training (phase 19), one
    ``AutoDist`` a trainer in this process."""
    import torch

    os.environ["AUTODIST_IS_TESTING"] = "1"   # several AutoDists in this process
    m = setup(torch)
    if m is None:
        return 1
    try:
        result = train_gpt2_elastic(torch, m, (m["fa"], m["fn"], m["tq"]), json.loads(phase5))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("ELASTIC_RESULT " + json.dumps(result))
    return 0


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    m = setup(torch)
    if m is None:
        return 1
    fa, fn, tq = m["fa"], m["fn"], m["tq"]
    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    kernel_modules = (fa, fn, tq)
    try:
        t0 = time.perf_counter()
        m["build"].build(list(SOURCES))
        print(f"kernel build: {time.perf_counter() - t0:.1f} s")
        report_registers(m["build"])
        errors = check_kernels(torch, fa)
        check_ring_kernels(torch, fa)
        errors.update(check_ring_of_one_block(torch, fa))
        errors.update(check_norm_kernels(torch, fn))
        errors.update(check_quantize_kernels(torch, tq))
        timing = measure_kernels(torch, fa)
        timing.update(measure_ring_kernels(torch, fa))
        timing.update(measure_norm_kernels(torch, fn))
        timing.update(measure_quantize_kernels(torch, tq))
        torch.cuda.empty_cache()
        ad = m["AutoDist"](resource_spec=m["spec"], strategy_builder=m["AllReduce"]())
        launches, phase5 = train_gpt2_small(torch, ad, kernel_modules)
        flat_losses = phase5["losses"]
        torch.cuda.empty_cache()
        report_norm_sites(torch)
        launches.update(train_resnet50(torch, ad, kernel_modules, "bn_fused", RESNET_STEPS))
        torch.cuda.empty_cache()
        launches.update(train_resnet50(torch, ad, kernel_modules, "gn", GN_STEPS))
        del ad
        torch.cuda.empty_cache()
        launches.update(run_codec_phase())
        launches.update(run_child(["--ring", repr(flat_losses[0])], "RING_RESULT")["launches"])
        run_child(["--ps", json.dumps(flat_losses)], "PS_RESULT")
        run_child(["--bench-gpt", json.dumps(phase5)], "BENCH_GPT_RESULT")
        run_child(["--sharded", json.dumps(phase5)], "SHARDED_RESULT")
        variants = run_child(["--sync-variants", json.dumps(phase5)], "SYNC_VARIANTS_RESULT")
        for k, v in variants["launches"].items():   # the codec runs' quantization launches
            launches[k] += v
        run_child(["--partitioned", json.dumps(phase5)], "PARTITIONED_RESULT")
        stale = run_child(["--stale", json.dumps(phase5)], "STALE_RESULT")
        for k, v in stale["launches"].items():
            launches[k] += v
        ckpt = run_child(["--ckpt", json.dumps(phase5)], "CKPT_RESULT")
        for k, v in ckpt["launches"].items():
            launches[k] += v
        elastic = run_child(["--elastic", json.dumps(phase5)], "ELASTIC_RESULT")
        for k, v in elastic["launches"].items():
            launches[k] += v
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[src], "replaces": replaces,
        "launches": launches[name], "max_abs_err": errors[name],
        "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--codec":
        sys.exit(codec_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ring":
        sys.exit(ring_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ps":
        sys.exit(ps_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--bench-gpt":
        sys.exit(bench_gpt_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded":
        sys.exit(sharded_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--sync-variants":
        sys.exit(sync_variants_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--partitioned":
        sys.exit(partitioned_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--stale":
        sys.exit(stale_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ckpt":
        sys.exit(ckpt_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--elastic":
        sys.exit(elastic_main(sys.argv[2]))
    sys.exit(main())
