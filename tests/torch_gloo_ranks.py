"""Rank code of the 4-rank gloo world that ``tests/test_torch_compressed_sync.py``
holds against the JAX package.  It imports no JAX: the port has to run
where JAX is absent.

The test starts one process per rank::

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r AUTODIST_INIT_METHOD=file://DIR/store \\
        AUTODIST_IS_TESTING=1 python tests/torch_gloo_ranks.py DIR

Each rank reads ``DIR/inputs.pkl`` (numpy arrays the test made from seeds),
joins the process group through the port's own bootstrap
(:func:`autodist_tpu_torch.parallel.mesh.replica_world`, gloo for the CPU),
runs the cases below and writes ``DIR/rank<r>.pkl``:

- ``codec``: every codec's ``all_reduce`` on this rank's buffer (and, for
  the error-feedback codecs, its residual state);
- ``linear``: ``tests/test_end_to_end.py::test_value_exact_sync``'s linear
  model, 3 steps under ``AllReduce(chunk_size=1 | 128)`` x sgd/adam;
- ``compressors``: ``test_compressors``' one sgd step under each codec;
- ``gpt``: 3 GPT-tiny adamw steps under ``Int8Compressor`` and
  ``EquarxInt8Compressor``.

Every ``AutoDist`` case records its strategy id and final parameters, so
the test can check that the ranks agree.
"""
import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD = 4
CODECS = ("NoneCompressor", "BF16Compressor", "BF16CompressorEF", "Int8Compressor",
          "Int8CompressorEF", "EquarxInt8Compressor")
CODEC_SIZES = (1000, 5000)
LINEAR_CASES = ((1, "sgd"), (1, "adam"), (128, "sgd"), (128, "adam"))
COMPRESSOR_CASES = {"NoneCompressor": 1e-6, "HorovodCompressor": 5e-3,
                    "HorovodCompressorEF": 5e-3, "Int8Compressor": 5e-2,
                    "Int8CompressorEF": 5e-2}
GPT_CODECS = ("Int8Compressor", "EquarxInt8Compressor")
GPT_SEQ, GPT_BATCH, GPT_STEPS = 16, 8, 3
SPEC = {"nodes": [{"address": "localhost", "cpus": list(range(WORLD)), "chief": True}]}


def _session_result(sess, metrics):
    return {"strategy_id": sess.strategy_id, "step": sess.step,
            "loss": metrics["loss"].item(),
            "params": {n: t.numpy() for n, t in sess.params().items()}}


def main(workdir):
    import torch

    torch.set_num_threads(2)
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.autodist import AutoDist
    from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
    from autodist_tpu_torch.models.gpt import GPT_TINY
    from autodist_tpu_torch.models.train_lib import gpt_capture
    from autodist_tpu_torch.parallel.mesh import replica_world
    from autodist_tpu_torch.proto import schema
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce

    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    world = replica_world("cpu")
    rank = world.rank
    results = {"rank": rank, "world": world.size}

    def autodist(builder):
        return AutoDist(resource_spec=ResourceSpec(resource_info=SPEC),
                        strategy_builder=builder, device="cpu")

    for name in CODECS:
        for n in CODEC_SIZES:
            comp = get_compressor(getattr(schema.AllReduceSynchronizer, name))
            buf = torch.from_numpy(inputs["codec_bufs"][n][rank])
            state = torch.from_numpy(inputs["codec_states"][n][rank]) if comp.stateful else ()
            out, new_state = comp.all_reduce(buf, state, world.group)
            results["codec", name, n] = (out.numpy(), new_state.numpy()
                                         if comp.stateful else None)

    def linear_loss(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"]) ** 2)

    for chunk, opt in LINEAR_CASES:
        make = optim.sgd(0.1) if opt == "sgd" else optim.adam(0.05)
        params = {k: torch.from_numpy(v) for k, v in inputs["linear_params"].items()}
        sess = autodist(AllReduce(chunk_size=chunk)).distribute(linear_loss, params, make)
        for _ in range(3):
            metrics = sess.run({"x": inputs["linear_batch"]})
        results["linear", chunk, opt] = _session_result(sess, metrics)

    for comp in COMPRESSOR_CASES:
        sess = autodist(AllReduce(compressor=comp)).distribute(
            lambda p, b: torch.mean(b["x"] @ p["w"]), {"w": torch.ones(64)},
            optim.sgd(0.1))
        metrics = sess.run({"x": inputs["compressor_batch"]})
        results["compressors", comp] = _session_result(sess, metrics)

    for comp in GPT_CODECS:
        loss_fn, _, sparse = gpt_capture(GPT_TINY, GPT_SEQ, device="cpu")
        params = {n: torch.from_numpy(a) for n, a in inputs["gpt_params"].items()}
        sess = autodist(AllReduce(compressor=comp)).distribute(
            loss_fn, params, optim.adamw(1e-3), sparse_vars=sparse, has_rng=True)
        losses = [sess.run(inputs["gpt_batch"])["loss"].item() for _ in range(GPT_STEPS)]
        results["gpt", comp] = dict(_session_result(sess, {"loss": torch.tensor(0.0)}),
                                    losses=losses)

    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
