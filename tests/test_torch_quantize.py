"""The port's int8 quantization ops against the JAX package's Pallas kernels.

``autodist_tpu_torch.ops.quantize``'s plain versions (what its wrappers run
for CPU tensors) against ``autodist_tpu/ops/pallas/quantize.py``'s
``quantize_int8``, ``dequant_sum`` and ``equarx_hop`` run in Pallas
``interpret=True``, on the same numpy inputs: small N, all-zero blocks,
values on rounding ties, D in {1, 2, 4}.

Tolerances.  Two places where the port's arithmetic differs from XLA's
on the CPU, both fixed by the port's bitwise contract with its CUDA
kernels:

- the port divides with IEEE division; XLA folds the reference's
  ``/ 127.0`` and ``/ n_dev`` into a multiply by the reciprocal.  So a
  quantize scale may differ by one ulp (rtol 1e-6), and where it does a q
  may differ by one step (x / s on a rounding tie); where the scales are
  equal the q are equal;
- the port sums the peers with a separate multiply and add; XLA contracts
  ``acc + q * s`` into an FMA.  So a sum differs by at most the rounding
  of its products: within 1e-6 of the sum of the magnitudes ``sum_d |q_d
  s_d|`` (rtol 1e-6 against the terms; against the sum itself it would
  fail wherever the peers cancel).  In the fused hop the mean then moves
  by that rounding too, so its scales stay within rtol 1e-6 and its q
  within one step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops.pallas import quantize as jq
from autodist_tpu_torch.ops import quantize as tq

D_VALUES = (1, 2, 4)


def _blocks(n, seed):
    """(n, 256) f32 with magnitudes spread over blocks, an all-zero block and
    a block whose values sit on half-step ties (absmax 127 -> scale 1)."""
    r = np.random.RandomState(seed)
    x = (r.randn(n, jq.BLOCK) * np.exp(r.uniform(-4, 4, (n, 1)))).astype(np.float32)
    x[3] = 0.0
    x[5] = np.arange(jq.BLOCK, dtype=np.float32) % 64 - 31.5
    x[5, 0] = 127.0
    return x


def _peers(d, n, seed):
    r = np.random.RandomState(seed)
    q = r.randint(-127, 128, (d, n, jq.BLOCK)).astype(np.int8)
    s = np.abs(r.randn(d, n, 1)).astype(np.float32) + 1e-3
    q[:, 2] = 0                       # a block that is zero on every peer
    return q, s


def _assert_quantized_close(q, s, q_ref, s_ref, same_input=True):
    """Scales within rtol 1e-6, q within one step; with ``same_input`` (the
    quantize of one x) scales within one ulp and q equal where the scales
    are equal."""
    q, s, q_ref, s_ref = (np.asarray(a) for a in (q, s, q_ref, s_ref))
    assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == q_ref.shape
    np.testing.assert_allclose(s, s_ref, rtol=1e-6)
    step = np.abs(q.astype(np.int32) - q_ref.astype(np.int32))
    assert step.max() <= 1
    if same_input:
        ulps = np.abs(s.view(np.int32).astype(np.int64) - s_ref.view(np.int32))[:, 0]
        assert ulps.max() <= 1, ulps.max()
        np.testing.assert_array_equal(step[ulps == 0], 0)


@pytest.mark.parametrize("n", [jq.ROWS, 2 * jq.ROWS])
def test_quantize_matches_pallas(n):
    x = _blocks(n, seed=n)
    q_ref, s_ref = jq.quantize_int8(jnp.asarray(x), interpret=True)
    q, s = tq.quantize_int8(torch.from_numpy(x))
    assert q.shape == (n, tq.BLOCK) and s.shape == (n, 1)
    _assert_quantized_close(q.numpy(), s.numpy(), q_ref, s_ref)
    assert not q[3].any() and float(s[3]) == 1.0      # zero block: scale 1, q 0
    # the ties round half to even (x / s = k + 0.5 exactly, scale 1)
    assert float(s[5]) == 1.0
    np.testing.assert_array_equal(q[5].numpy(), np.round(x[5]).astype(np.int8))


@pytest.mark.parametrize("d", D_VALUES)
def test_dequant_sum_matches_pallas(d):
    q, s = _peers(d, jq.ROWS, seed=10 + d)
    want = np.asarray(jq.dequant_sum(jnp.asarray(q), jnp.asarray(s), interpret=True))
    got = tq.dequant_sum(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    terms = np.abs(q.astype(np.float32) * s).sum(axis=0)
    assert (np.abs(got - want) <= 1e-6 * terms).all()
    if d == 1:   # one product, no sum: the same bits
        np.testing.assert_array_equal(got, want)
    assert not got[2].any()


@pytest.mark.parametrize("d", D_VALUES)
def test_equarx_hop_matches_pallas(d):
    q, s = _peers(d, jq.ROWS, seed=20 + d)
    q_ref, s_ref = jq.equarx_hop(jnp.asarray(q), jnp.asarray(s), d, interpret=True)
    q2, s2 = tq.equarx_hop(torch.from_numpy(q), torch.from_numpy(s), d)
    _assert_quantized_close(q2.numpy(), s2.numpy(), q_ref, s_ref, same_input=d == 1)
    assert not q2[2].any() and float(s2[2]) == 1.0
    # the EQuARX contract: the fused hop equals quantize(dequant_sum / n)
    uq, us = tq.quantize_int8(tq.true_divide(
        tq.dequant_sum(torch.from_numpy(q), torch.from_numpy(s)), d))
    assert torch.equal(q2, uq) and torch.equal(s2, us)


def test_nan_poisons_its_block_scale():
    x = _blocks(8, seed=3)
    x[1, 17] = np.nan
    q, s = tq.quantize_int8(torch.from_numpy(x))
    q_ref, s_ref = jq.quantize_int8(jnp.asarray(np.concatenate([x, np.zeros(
        (jq.ROWS - 8, jq.BLOCK), np.float32)])), interpret=True)
    assert np.isnan(float(s[1])) and np.isnan(np.asarray(s_ref)[1, 0])
    assert not q[1].any() and not np.asarray(q_ref)[1].any()   # a NaN's q is 0
    assert torch.isfinite(torch.cat([s[:1], s[2:]])).all()


def test_pad_to_blocks_and_dispatch():
    x = np.arange(tq.BLOCK * 3 + 7, dtype=np.float32)
    want = np.asarray(jq.pad_to_blocks(jnp.asarray(x)))   # ROWS blocks, the TPU tile
    got = tq.pad_to_blocks(torch.from_numpy(x))
    assert got.shape == (4, tq.BLOCK) and not want[4:].any()
    np.testing.assert_array_equal(got.numpy(), want[:4])
    # CPU tensors take the plain versions and launch nothing
    tq.reset_launches()
    xb = torch.from_numpy(_blocks(8, seed=1))
    for impl in (None, "plain"):
        q, s = tq.quantize_int8(xb, impl=impl)
        assert torch.equal(q, tq.quantize_int8_plain(xb)[0])
    assert tq.LAUNCHES == {"quantize_int8": 0, "dequant_sum": 0, "equarx_hop": 0}
    with pytest.raises(ValueError, match="impl"):
        tq.quantize_int8(xb, impl="kernel")
    with pytest.raises(RuntimeError, match="cuda"):
        tq.quantize_int8(xb.to("meta"))
    # IEEE division: not the reciprocal multiply where the two differ
    v = torch.tensor([1.0, 3.0, 100.0, 7.0e-3])
    assert torch.equal(tq.true_divide(v, 127.0), torch.from_numpy(v.numpy() / np.float32(127)))


# The hop kernel's arithmetic (csrc/quantize.cu), pinned on the CPU: the
# mean by a power of two as a multiply, and the requantize's quotient from a
# per-block reciprocal and one FMA correction, each bitwise the IEEE
# division the plain versions do.

@pytest.mark.parametrize("n_dev, want", [
    (1, (0, 1.0)), (2, (1, 0.5)), (4, (1, 0.25)), (8, (1, 0.125)), (1024, (1, 2.0 ** -10)),
    (3, (2, 3.0)), (6, (2, 6.0)), (2.0 ** 127, (2, 2.0 ** 127))])
def test_hop_mean_mode_from_n_dev(n_dev, want):
    assert tq.mean_mode(n_dev) == want


def _all_f32(seed, n=1 << 16):
    """Seeded f32 over every bit pattern (subnormals, inf and NaN among
    them) and the special values themselves."""
    bits = np.random.RandomState(seed).randint(0, 1 << 32, n, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.4e-45, -1.4e-45, 1.1754942e-38,
                        1.17549435e-38, 3.4028235e38, -3.4028235e38], np.float32)
    return np.concatenate([x, special])


@pytest.mark.parametrize("k", [1, 2, 3, 10])
def test_power_of_two_mean_is_ieee_division(k):
    x = torch.from_numpy(_all_f32(seed=k))
    mode, arg = tq.mean_mode(2 ** k)
    assert mode == 1 and arg == 2.0 ** -k
    got = x * torch.tensor(arg, dtype=torch.float32)
    want = tq.true_divide(x, 2 ** k)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))   # -0 too


def _fma32(a, b, c):
    """``RN32(a * b + c)`` of f32 arrays, exactly: ``a * b`` is exact in f64,
    TwoSum recovers the f64 sum's rounding error, and that error decides
    the one case where rounding the f64 sum to f32 could differ (a sum on an
    f32 midpoint)."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    p = a * b
    hi = p + c
    bv = hi - p
    lo = (p - (hi - bv)) + (c - bv)
    r = hi.astype(np.float32)
    other = np.where(hi > r, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    fix = (hi == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (lo != 0)
    return np.where(fix, np.where(lo > 0, np.maximum(r, other), np.minimum(r, other)), r)


def _reciprocal_quotient(x, s):
    """The kernel's x / s: y = RN(1/s), t = RN(x y), t + RN(x - s t) y by FMAs."""
    y = np.float32(1.0) / s
    t = x * y
    return _fma32(_fma32(-t, s, x), y, t)


def _near_midpoint_pairs(n, seed):
    """(x, s) whose exact quotient lies about 2^-47 of its size from a
    midpoint of two f32 (A 2^24 - B M = +-1 for significands A, B and the
    midpoint's M), at exponents that keep s in [2^-90, 2^90] and x / s
    below 128."""
    rng = np.random.RandomState(seed)
    xs, ss = [], []
    while len(xs) < n:
        b = int(rng.randint(1 << 23, 1 << 24)) | 1
        k = int(rng.choice([-1, 1]))
        m = (-k * pow(b, -1, 1 << 24)) % (1 << 24)
        for mm in (m, m + (1 << 24)):
            a, rem = divmod(b * mm + k, 1 << 24)
            if rem == 0 and mm % 2 and (1 << 23) <= a < (1 << 24):
                e = int(rng.randint(-90, 90))
                xs.append(np.ldexp(np.float64(a), e + int(rng.randint(0, 7)) - 23))
                ss.append(np.ldexp(np.float64(b), e - 23))
                break
    return np.array(xs, np.float32), np.array(ss, np.float32)


@pytest.mark.parametrize("case", ["spread", "ties", "near_midpoints"])
def test_requantize_by_reciprocal_is_ieee_division(case):
    if case == "near_midpoints":
        x, s = _near_midpoint_pairs(3000, seed=5)
        assert np.array_equal(_reciprocal_quotient(x, s).view(np.int32), (x / s).view(np.int32))
        return
    r = np.random.RandomState(7)
    if case == "spread":   # magnitudes from 2^-60 to 2^60, scales far above 2^-96
        x = (r.randn(512, tq.BLOCK) * np.exp2(r.randint(-60, 60, (512, 1)))).astype(np.float32)
    else:                  # x / s on half steps k + 1/2 at scale 2^e
        e = np.exp2(r.randint(-80, 80, (512, 1)))
        x = ((r.randint(-127, 127, (512, tq.BLOCK)) + 0.5) * e).astype(np.float32)
        x[:, 0] = 127 * e[:, 0]   # absmax 127 2^e: the scale is 2^e
        assert (np.abs(x[:, 1:] / e) % 1 == 0.5).all()
    want_q, s = tq.quantize_int8_plain(torch.from_numpy(x))
    s = s.numpy()
    assert (s >= 2.0 ** -96).all() and np.isfinite(s).all()   # the reciprocal path
    t = _reciprocal_quotient(x, s)
    assert np.array_equal(t.view(np.int32), (x / s).view(np.int32))
    # the rounding by the 1.5 * 2^23 shifter: the low byte is rint(t)
    q = ((t + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(q, want_q.numpy())
