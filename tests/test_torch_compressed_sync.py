"""The port's compressed AllReduce family against the JAX package.

- (b) Each codec's ``all_reduce`` at R = 1 against the JAX codec inside a
  1-device ``shard_map``.
- (c) One gloo world of 4 ranks, started once per test process and shared
  with ``tests/test_torch_ring_attention.py`` (rank code and launcher in
  ``tests/torch_gloo_ranks.py``, which imports no JAX), against the JAX
  package on 4 of the 8 virtual CPU devices:
  - each codec's ``all_reduce`` against the JAX codec in ``shard_map``;
  - ``test_end_to_end.py::test_value_exact_sync``'s linear model under
    ``AllReduce(chunk_size=1 | 128)`` x sgd/adam against its oracle
    (single-device optax on the global batch) at atol 2e-5;
  - ``test_compressors``' five cases at their tolerances;
  - three steps of a one-block GPT-tiny under ``Int8Compressor`` and
    ``EquarxInt8Compressor`` against the JAX ``AutoDist`` on
    ``ResourceSpec.from_num_chips(4)``: losses to rtol 1e-3;
  - every rank holds the same strategy id and the same parameters.
- (d) The error-feedback residual carries over steps
  (``test_error_feedback_residual_carries``), for the bf16 and int8 EF
  codecs.

Codec tolerances, port vs JAX on the same inputs: the int8 family within
one output quantization step of each 256-element block (the port divides
with IEEE division and sums the peers without FMA where XLA on the CPU
multiplies by reciprocals and contracts; a last-bit difference can move a
value across a rounding boundary), and the EF residual within one input
quantization step; the bf16 family within 1e-2 relative to the largest
magnitude (a bf16 sum in the backend's own order), its residual exactly at
R = 1; the NoneCompressor to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel.synchronization.compressor import get_compressor as jget
from autodist_tpu.kernel.synchronization.compressor import wire_byte_factor as jwire
from autodist_tpu.proto import synchronizers_pb2
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel.synchronization.compressor import (get_compressor,
                                                                   wire_byte_factor)
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

BLOCK = ranks.BLOCK
INT8 = ("Int8Compressor", "Int8CompressorEF", "EquarxInt8Compressor")
BF16 = ("BF16Compressor", "BF16CompressorEF")
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}


def _enum(name):
    return getattr(synchronizers_pb2.AllReduceSynchronizer, name)


def _jax_all_reduce(name, bufs, states):
    """The JAX codec in ``shard_map`` over ``len(bufs)`` CPU devices: each
    device's (mean, new state)."""
    r = bufs.shape[0]
    comp = jget(_enum(name))
    mesh = Mesh(np.array(jax.devices()[:r]), ("replica",))

    def body(b, s):
        out, new = comp.all_reduce(b[0], s[0] if comp.stateful else (), "replica")
        return out[None], (new if comp.stateful else s[0])[None]

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("replica"), P("replica")),
                               out_specs=(P("replica"), P("replica")), check_vma=False))
    out, new = fn(jnp.asarray(bufs), jnp.asarray(states))
    return np.asarray(out), np.asarray(new)


def _jax_codec_one(name):
    """The JAX codec at R = 1 on ``codec_inputs(1, 1000, seed=5)``."""
    return _jax_all_reduce(name, *ranks.codec_inputs(1, 1000, seed=5))


def _jax_codec_world(name):
    """size -> the JAX codec over 4 devices on the world's buffers."""
    inputs = oracle.world_inputs()
    return {n: _jax_all_reduce(name, inputs["codec_bufs"][n], inputs["codec_states"][n])
            for n in ranks.CODEC_SIZES}


def _block_steps(x):
    """Each element's quantization step: its 256-block's absmax / 127."""
    n = x.shape[-1]
    pad = np.pad(np.abs(x), [(0, 0)] * (x.ndim - 1) + [(0, -n % BLOCK)])
    amax = pad.reshape(x.shape[:-1] + (-1, BLOCK)).max(-1) / 127.0
    return np.repeat(amax, BLOCK, axis=-1)[..., :n]


def _assert_codec_close(name, got, want, got_state, want_state, corrected):
    if name in INT8:
        # the output's own blocks: each is q2 * s2 with max |q2| = 127
        assert (np.abs(got - want) <= _block_steps(want) * (1 + 1e-6)).all()
        if got_state is not None:   # residual: one step of the input's blocks
            assert (np.abs(got_state - want_state)
                    <= _block_steps(corrected) * (1 + 1e-6)).all()
    elif name in BF16:
        np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(), rtol=0)
        if got_state is not None:
            np.testing.assert_allclose(got_state, want_state, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# -- (b) R = 1 ----------------------------------------------------------------

@pytest.mark.parametrize("name", ranks.CODECS)
def test_codec_matches_jax_at_one_replica(name):
    bufs, states = ranks.codec_inputs(1, 1000, seed=5)
    want, want_state = worker.result(_jax_codec_one, name)
    comp = get_compressor(getattr(schema.AllReduceSynchronizer, name))
    state = torch.from_numpy(states[0]) if comp.stateful else ()
    got, got_state = comp.all_reduce(torch.from_numpy(bufs[0]), state, None)
    assert got.dtype == torch.float32 and got.shape == (1000,)
    _assert_codec_close(name, got.numpy()[None], want,
                        got_state.numpy()[None] if comp.stateful else None, want_state,
                        bufs + states)
    if name in BF16:   # one replica: the bf16 round trip is exact in both
        np.testing.assert_array_equal(got.numpy(), want[0])


def test_registry_and_wire_factors_match_jax():
    for name in ranks.CODECS + ("PowerSGDCompressor",):
        for size in (1, 1000, 73_244_160):
            assert wire_byte_factor(getattr(schema.AllReduceSynchronizer, name), size) == \
                jwire(_enum(name), size), (name, size)
    for name in ranks.CODECS + ("PowerSGDCompressor",):
        comp, jcomp = get_compressor(getattr(schema.AllReduceSynchronizer, name)), jget(
            _enum(name))
        assert (comp.name, comp.stateful) == (jcomp.name, jcomp.stateful)
    with pytest.raises(ValueError, match="Unknown compressor"):
        get_compressor(99)


# -- (c) a 4-rank gloo world --------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    """The 4 ranks (started once per test process); returns (inputs, JAX GPT
    params, per-rank results)."""
    j_gpt_params = _jax_gpt_params()
    inputs, results = ranks.world(lambda: j_gpt_params)
    return inputs, j_gpt_params, results


@pytest.mark.parametrize("name", ranks.CODECS)
def test_codec_matches_jax_over_four_ranks(gloo, name):
    inputs, _, results = gloo
    jax_runs = worker.result(_jax_codec_world, name)
    for n in ranks.CODEC_SIZES:
        bufs, states = inputs["codec_bufs"][n], inputs["codec_states"][n]
        want, want_state = jax_runs[n]
        got = np.stack([res["codec", name, n][0] for res in results])
        stateful = results[0]["codec", name, n][1] is not None
        got_state = np.stack([res["codec", name, n][1] for res in results]) \
            if stateful else None
        assert got.shape == (ranks.WORLD, n)
        _assert_codec_close(name, got, want, got_state, want_state, bufs + states)
        # every replica ends with the same mean
        assert all(np.array_equal(got[0], g) for g in got[1:])


def _linear_oracle(opt, batch, params, steps=3):
    def loss(p, b):
        return jnp.mean((b @ p["w"] + p["b"]) ** 2)

    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p)
    for _ in range(steps):
        g = jax.grad(loss)(p, jnp.asarray(batch))
        u, st = opt.update(g, st, p)
        p = optax.apply_updates(p, u)
    return p


def _jax_linear(opt):
    """The optax oracle's parameters after 3 steps on the world's linear case."""
    inputs = oracle.world_inputs()
    jopt = optax.sgd(0.1) if opt == "sgd" else optax.adam(0.05)
    p = _linear_oracle(jopt, inputs["linear_batch"], inputs["linear_params"])
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("chunk,opt", ranks.LINEAR_CASES)
def test_value_exact_sync_over_four_ranks(gloo, chunk, opt):
    _, _, results = gloo
    exp = worker.result(_jax_linear, opt)
    for res in results:
        got = res["linear", chunk, opt]
        assert got["step"] == 3 and np.isfinite(got["loss"])
        np.testing.assert_allclose(got["params"]["w"], exp["w"], atol=2e-5)
        np.testing.assert_allclose(got["params"]["b"], exp["b"], atol=2e-5)


def test_bare_array_batch_over_four_ranks(gloo):
    """The bare ndarray batch, as ``tests/test_end_to_end.py`` passes it:
    each rank's slice and its 3 sgd steps are bitwise the ``{"x": ...}``
    form's."""
    inputs, _, results = gloo
    per = inputs["linear_batch"].shape[0] // ranks.WORLD
    for r, res in enumerate(results):
        bare, in_dict = res["linear_bare_slices"]
        assert np.array_equal(bare, in_dict)
        assert np.array_equal(bare, inputs["linear_batch"][r * per:(r + 1) * per])
        got, want = res["linear_bare"], res["linear", 1, "sgd"]
        assert got["step"] == 3 and got["loss"] == want["loss"]
        for name in ("w", "b"):
            assert np.array_equal(got["params"][name], want["params"][name]), name


@pytest.mark.parametrize("comp", sorted(ranks.COMPRESSOR_CASES))
def test_compressors_over_four_ranks(gloo, comp):
    inputs, _, results = gloo
    b = inputs["compressor_batch"]
    exp = np.ones(64) - 0.1 * b.mean(0)
    for res in results:
        got = res["compressors", comp]["params"]["w"]
        assert np.abs(got - exp).max() < ranks.COMPRESSOR_CASES[comp]


def _jax_gpt_losses(comp):
    """The JAX engine's losses of the world GPT under ``AllReduce(compressor=
    comp)`` over 4 devices."""
    j_loss_fn, _ = oracle.gpt_capture(oracle.world_gpt(), ranks.GPT_SEQ)
    j_sess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(ranks.WORLD),
                       strategy_builder=JAllReduce(compressor=comp)).distribute(
        j_loss_fn, _jax_gpt_params(), optax.adamw(1e-3), has_rng=True)
    return [float(j_sess.run(oracle.world_inputs()["gpt_batch"])["loss"])
            for _ in range(ranks.GPT_STEPS)]


worker.submit(*((_jax_codec_one, name) for name in ranks.CODECS),
              *((_jax_codec_world, name) for name in ranks.CODECS),
              *((_jax_linear, opt) for opt in sorted({opt for _, opt in ranks.LINEAR_CASES})),
              *((_jax_gpt_losses, comp) for comp in ranks.GPT_CODECS))


@pytest.mark.parametrize("comp", ranks.GPT_CODECS)
def test_gpt_tiny_matches_jax_autodist_over_four_ranks(gloo, comp):
    _, _, results = gloo
    j_losses = worker.result(_jax_gpt_losses, comp)
    for res in results:
        losses = res["gpt", comp]["losses"]
        np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
        assert losses[-1] < losses[0]


def test_ranks_hold_one_strategy_and_the_same_parameters(gloo):
    _, _, results = gloo
    keys = [k for k in results[0] if isinstance(k, tuple) and k[0] != "codec"]
    assert len(keys) == len(ranks.LINEAR_CASES) + len(ranks.COMPRESSOR_CASES) \
        + len(ranks.GPT_CODECS)
    ids = set()
    for key in keys:
        first = results[0][key]
        assert first["strategy_id"]
        ids.add(first["strategy_id"])
        for res in results[1:]:
            assert res[key]["strategy_id"] == first["strategy_id"], key
            for n, a in first["params"].items():
                np.testing.assert_array_equal(res[key]["params"][n], a, err_msg=str(key))
    assert len(ids) == len(keys)   # each distribute built its own strategy


# -- (d) error feedback over steps --------------------------------------------

@pytest.mark.parametrize("comp", ["HorovodCompressorEF", "Int8CompressorEF"])
def test_error_feedback_residual_carries(comp):
    """EF tracks and reinjects the quantization error over steps: 64 steps
    of a value bf16 cannot represent stay within rtol 2e-3 of the exact
    sum (``tests/test_end_to_end.py::test_error_feedback_residual_carries``)."""
    ad = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                  strategy_builder=AllReduce(compressor=comp), device="cpu")
    sess = ad.distribute(lambda p, b: torch.mean(b["x"] @ p["w"]),
                         {"w": torch.zeros(32)}, optim.sgd(0.01))
    b = np.full((8, 32), 1.0 + 2 ** -10, np.float32)
    for _ in range(64):
        sess.run({"x": b})
    got = sess.params()["w"].numpy()
    np.testing.assert_allclose(got, -0.01 * 64 * b.mean(0), rtol=2e-3)
    residual = next(iter(sess.state["comp"].values()))
    assert residual.shape == (32,) and residual.dtype == torch.float32
