#!/usr/bin/env python3
"""``chip_smoke.py``'s compressed AllReduce phase over R GPUs of one host,
one process per GPU (NCCL)::

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        multi_gpu_check.py Int8Compressor

Each rank runs ``chip_smoke.train_gpt2_codec`` on its own GPU: GPT-2 small
at full width under ``AllReduce(compressor=CODEC)``, 8 sequences of 1024
tokens per rank, with that function's checks (step 1's synced gradients
through the kernels bitwise equal to the codec's plain versions over the
same NCCL collectives, finite and falling losses, the launches per step of
the one-GPU run) and one more: every rank ends with the same parameters.
Rank 0 builds the kernels and prints; the run ends with a ``RESULT {...}``
JSON line.  A failed check exits non-zero.
"""
import json
import os
import sys

import chip_smoke as smoke


def main(argv):
    import torch

    if len(argv) != 1 or argv[0] not in smoke.CODECS:
        print(__doc__ + f"\nCODEC is one of {list(smoke.CODECS)}", file=sys.stderr)
        return 2
    codec = argv[0]
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size < 2:
        print("FAIL: run under torchrun with --nproc-per-node >= 2", file=sys.stderr)
        return 1
    m = smoke.setup(torch)
    if m is None:
        return 1
    from autodist_tpu_torch.resource_spec import ResourceSpec

    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    spec = ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": list(range(world_size)), "chief": True}]})
    ad = m["AutoDist"](resource_spec=spec, strategy_builder=m["AllReduce"](compressor=codec))
    rank = ad.world.rank   # joins the process group
    if rank == 0:
        m["build"].build(list(smoke.SOURCES))
    else:
        sys.stdout = open(os.devnull, "w")
    torch.distributed.barrier()
    print(f"{world_size} ranks, torch {torch.__version__}, {torch.cuda.get_device_name()}")
    try:
        result = smoke.train_gpt2_codec(torch, ad, codec, (m["fa"], m["fn"], m["tq"]))
    except smoke.SmokeFailure as e:
        print(f"FAIL (rank {rank}): {e}", file=sys.stderr, flush=True)
        return 1
    print("RESULT " + json.dumps(result), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
