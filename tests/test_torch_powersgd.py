"""The PowerSGD codec, the port against the JAX package.

- The state ``{"Q", "residual"}``: Q drawn from ``RandomState(size %
  2**31)`` bitwise equal to JAX's, the residual zeros, at sizes from 1 to
  a non-square 262,147.
- One ``all_reduce`` at R = 1 (in this process) and at R = 4 (the shared
  gloo world of ``tests/torch_gloo_ranks.py``, each rank's buffer of 5,000
  elements, magnitudes up to ~22) against JAX's in ``shard_map``: the
  approximation, the residual and Q within 1e-5 (f32 products summed in
  another order), Q up to the sign of each column (the QR's convention may
  flip one in both P and Q; P Q^T does not see it).
- ``tests/test_powersgd.py``'s three cases on the port alone, at one
  replica in this process and at that test's thresholds: a rank-1 gradient
  is captured (rel 0.05 after 20 steps), error feedback recovers a
  full-rank one (rel 0.1 after 200 steps), the dict state survives the
  step loop; and the overlap schedule's run of the last is bitwise equal to
  the barrier's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_gloo_ranks as ranks
from autodist_tpu.kernel.synchronization.compressor import get_compressor as jget
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.proto import synchronizers_pb2
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel.synchronization.compressor import get_compressor
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
TOL = 1e-5


def _codecs():
    return (jget(synchronizers_pb2.AllReduceSynchronizer.PowerSGDCompressor),
            get_compressor(schema.AllReduceSynchronizer.PowerSGDCompressor))


@pytest.mark.parametrize("size", [1, 17, 1000, 5000, 2048, 262_147])
def test_state_init_bitwise_equal_to_jax(size):
    jcomp, tcomp = _codecs()
    want, got = jcomp.init_state(size), tcomp.init_state(size)
    assert sorted(got) == sorted(want) == ["Q", "residual"]
    for k in want:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (size, k)


def _jax_all_reduce(bufs):
    """JAX's PowerSGD ``all_reduce`` over ``len(bufs)`` CPU devices from the
    initial state: each device's (approx, Q, residual)."""
    r, n = bufs.shape
    jcomp, _ = _codecs()
    mesh = Mesh(np.array(jax.devices()[:r]), ("replica",))

    def body(b):
        approx, state = jcomp.all_reduce(b[0], jcomp.init_state(n), "replica")
        return approx[None], state["Q"][None], state["residual"][None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("replica"),
                               out_specs=(P("replica"),) * 3, check_vma=False))
    return [np.asarray(x) for x in fn(jnp.asarray(bufs))]


def _assert_matches(got, want):
    approx, q, residual = got
    j_approx, j_q, j_residual = want
    np.testing.assert_allclose(approx, j_approx, atol=TOL, rtol=0)
    np.testing.assert_allclose(residual, j_residual, atol=TOL, rtol=0)
    signs = np.sign(np.sum(q * j_q, axis=0))          # per column
    assert (signs != 0).all()
    np.testing.assert_allclose(q * signs, j_q, atol=TOL, rtol=0)


def test_all_reduce_at_one_replica_matches_jax():
    bufs, _ = ranks.codec_inputs(1, ranks.POWERSGD_SIZE, seed=5)
    _, tcomp = _codecs()
    approx, state = tcomp.all_reduce(torch.from_numpy(bufs[0]),
                                     tcomp.init_state(ranks.POWERSGD_SIZE), None)
    want = _jax_all_reduce(bufs)
    _assert_matches((approx.numpy(), state["Q"].numpy(), state["residual"].numpy()),
                    [w[0] for w in want])
    # the residual is what the approximation leaves of the corrected buffer
    np.testing.assert_allclose(approx.numpy() + state["residual"].numpy(), bufs[0],
                               rtol=1e-6, atol=1e-6 * np.abs(bufs[0]).max())


def _jax_gpt_params():
    _, params, _ = jtrain.gpt_capture(jgpt.GPT_TINY, ranks.GPT_SEQ)
    return params


def test_all_reduce_over_four_ranks_matches_jax():
    inputs, results = ranks.world(_jax_gpt_params)
    bufs = inputs["codec_bufs"][ranks.POWERSGD_SIZE]
    want = _jax_all_reduce(bufs)
    for rank, res in enumerate(results):
        _assert_matches(res["hier"]["powersgd"], [w[rank] for w in want])
        for other in results:   # the mean's approximation is the same everywhere
            assert np.array_equal(other["hier"]["powersgd"][0], res["hier"]["powersgd"][0])


# -- tests/test_powersgd.py on the port -----------------------------------------

def _session(params, loss, lr, schedule="barrier"):
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=AllReduce(compressor="PowerSGDCompressor",
                                               schedule=schedule),
                    device="cpu").distribute(loss, params, optim.sgd(lr))


def test_rank1_gradient_captured_exactly():
    sess = _session({"w": torch.zeros(64, 32)}, lambda p, b: torch.mean((b @ p["w"]).sum(1)),
                    0.01)
    b = np.random.RandomState(0).randn(16, 64).astype(np.float32)
    for _ in range(20):
        sess.run(b)
    got = sess.params()["w"].numpy()
    exp = -0.01 * 20 * np.outer(b.mean(0), np.ones(32))   # the true SGD trajectory
    rel = np.abs(got - exp).max() / np.abs(exp).max()
    assert rel < 0.05, rel


def test_error_feedback_recovers_full_rank():
    target = torch.from_numpy(np.random.RandomState(1).randn(32, 16).astype(np.float32))
    sess = _session({"w": torch.zeros(32, 16)},
                    lambda p, b: -torch.sum(p["w"] * target) + 0.0 * torch.sum(b), 0.1)
    b = np.zeros((8, 1), np.float32)
    for _ in range(200):
        sess.run(b)
    exp = 0.1 * 200 * target.numpy()
    rel = np.abs(sess.params()["w"].numpy() - exp).max() / np.abs(exp).max()
    assert rel < 0.1, rel   # EF closes the low-rank gap over steps


def test_state_roundtrip_through_steps():
    runs = {}
    for schedule in ("barrier", "overlap"):
        sess = _session({"w": torch.zeros(16, 4)}, lambda p, b: torch.mean(b @ p["w"]), 0.1,
                        schedule)
        b = np.ones((8, 16), np.float32)
        sess.run(b)
        comp = sess.state["comp"]
        (key,) = comp
        assert set(comp[key]) == {"Q", "residual"}
        q0 = comp[key]["Q"].clone()
        sess.run(b)
        assert sess.state["comp"][key]["Q"].shape == q0.shape   # warm-started, carried
        runs[schedule] = sess.params()["w"].numpy()
    assert np.array_equal(runs["overlap"], runs["barrier"])
