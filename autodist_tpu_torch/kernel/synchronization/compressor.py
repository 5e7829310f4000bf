"""Gradient compression codecs around the replica collectives.

Counterpart of ``autodist_tpu/kernel/synchronization/compressor.py``, with
its math and op order.  A codec's ``all_reduce(buf, state, group) ->
(mean, state)`` reduces one flat gradient bucket to its mean over the
replicas of ``group`` (``None``: one replica):

- ``NoneCompressor``: the plain mean;
- ``BF16Compressor``: a bf16 wire, summed in bf16 and divided in f32;
  ``BF16CompressorEF`` carries the cast's error to the next step as a flat
  f32 residual;
- ``Int8Compressor``: block int8 on the wire in both phases.  Quantize the
  padded bucket, all-to-all its R chunks, dequantize and sum each peer's
  copy of this replica's chunk, divide by R, requantize, all-gather.
  ``EquarxInt8Compressor`` runs the middle (dequantize, mean, requantize)
  as one fused kernel; ``Int8CompressorEF`` adds the error-feedback
  residual of the local quantization.

The int8 codecs call :mod:`autodist_tpu_torch.ops.quantize` on every
device, so on the card the quantize, dequant-sum and fused-hop kernels
run (where the JAX package takes Pallas only on a TPU), and on the CPU
their plain versions.  ``impl="plain"`` runs the plain versions on the
card too, for the checks.  Buckets pad to R chunks of a multiple of
``BLOCK`` elements each, as the JAX package's jnp path does; the TPU's
``ROWS * BLOCK`` chunk rounding is a tiling rule the CUDA kernels do not
need.  ``PowerSGDCompressor`` runs a rank-4 subspace iteration with error
feedback, its state a dict ``{"Q", "residual"}``.
"""
import math

import torch

from autodist_tpu_torch.ops import quantize as qops
from autodist_tpu_torch.parallel import collectives as coll
from autodist_tpu_torch.proto import schema

_C = schema.AllReduceSynchronizer


class Compressor:
    """Codec interface: ``all_reduce(flat_buffer, state, group) -> (mean,
    state)``."""

    name = "none"
    stateful = False

    def __init__(self, impl=None):
        self.impl = impl    # None: kernels on CUDA tensors; "plain": plain versions

    def init_state(self, size, device="cpu"):
        return ()

    def all_reduce(self, buf, state, group=None):
        return coll.pmean(buf, group), state


class NoneCompressor(Compressor):
    pass


class BF16Compressor(Compressor):
    """Cast to bf16 for the wire; the bf16 sum is upcast and divided."""

    name = "bf16"

    def all_reduce(self, buf, state, group=None):
        wire = buf.to(torch.bfloat16)
        reduced = coll.psum(wire, group).float()
        return reduced / coll.axis_size(group), state


class BF16CompressorEF(BF16Compressor):
    """BF16 wire with an error-feedback residual."""

    name = "bf16_ef"
    stateful = True

    def init_state(self, size, device="cpu"):
        return torch.zeros(size, dtype=torch.float32, device=device)

    def all_reduce(self, buf, state, group=None):
        corrected = buf + state
        wire = corrected.to(torch.bfloat16)
        residual = corrected - wire.float()
        reduced = coll.psum(wire, group).float()
        return reduced / coll.axis_size(group), residual


def _quantize_int8(x, block, impl=None):
    """Block-wise symmetric int8 quantization of a flat f32 ``x`` whose
    length divides into ``block``s: ((n/block, block) int8, (n/block, 1) f32)."""
    return qops.quantize_int8(x.reshape(-1, block), impl=impl)


def _dequantize_int8(q, scale):
    return (q.float() * scale).reshape(-1)


class Int8Compressor(Compressor):
    """Quantized all-reduce: int8 on the wire in both phases."""

    name = "int8"
    BLOCK = 256

    def _exchange(self, buf, group):
        """Pad, quantize and all-to-all: this replica's chunk as every peer
        quantized it, ((R, chunk/BLOCK, BLOCK) int8, (R, chunk/BLOCK, 1) f32)."""
        n_dev = coll.axis_size(group)
        n = buf.shape[0]
        chunk = -(-n // n_dev)
        chunk = -(-chunk // self.BLOCK) * self.BLOCK
        padded = torch.nn.functional.pad(buf, (0, chunk * n_dev - n))
        q, scale = _quantize_int8(padded, self.BLOCK, self.impl)
        # replica d receives row block d from every peer
        q_rx = coll.all_to_all_single(q, group)
        s_rx = coll.all_to_all_single(scale, group)
        rows = chunk // self.BLOCK
        return q_rx.view(n_dev, rows, self.BLOCK), s_rx.view(n_dev, rows, 1)

    def _gather(self, q2, s2, n, group):
        """All-gather the requantized chunks and dequantize the bucket."""
        q2g = coll.all_gather_into_tensor(q2, group)
        s2g = coll.all_gather_into_tensor(s2, group)
        return _dequantize_int8(q2g, s2g)[:n]

    def all_reduce(self, buf, state, group=None):
        buf = buf.float()  # quantization math in f32
        n_dev = coll.axis_size(group)
        q_rx, s_rx = self._exchange(buf, group)
        # dequant + sum over peers, then the mean: two steps, as in JAX
        local = qops.true_divide(qops.dequant_sum(q_rx, s_rx, impl=self.impl), n_dev)
        q2, s2 = qops.quantize_int8(local, impl=self.impl)
        return self._gather(q2, s2, buf.shape[0], group), state


class EquarxInt8Compressor(Int8Compressor):
    """EQuARX (arXiv 2506.17615): the int8 all-reduce with its hop fused
    into one kernel: dequantize the received peer chunks, mean, requantize
    (:func:`ops.quantize.equarx_hop`), so the f32 accumulator never goes
    through device memory between the all-to-all and the all-gather.  The
    same wire and, element for element, the same math as
    :class:`Int8Compressor`."""

    name = "equarx_int8"

    def all_reduce(self, buf, state, group=None):
        buf = buf.float()
        n_dev = coll.axis_size(group)
        q_rx, s_rx = self._exchange(buf, group)
        q2, s2 = qops.equarx_hop(q_rx, s_rx, n_dev, impl=self.impl)
        return self._gather(q2, s2, buf.shape[0], group), state


class Int8CompressorEF(Int8Compressor):
    """Int8 with an error-feedback residual: what quantizing the corrected
    gradient loses locally."""

    name = "int8_ef"
    stateful = True

    def init_state(self, size, device="cpu"):
        return torch.zeros(size, dtype=torch.float32, device=device)

    def all_reduce(self, buf, state, group=None):
        corrected = buf + state
        reduced, _ = super().all_reduce(corrected, (), group)
        q, scale = qops.quantize_int8(qops.pad_to_blocks(corrected), impl=self.impl)
        residual = corrected - _dequantize_int8(q, scale)[:corrected.shape[0]]
        return reduced, residual


class PowerSGDCompressor(Compressor):
    """Low-rank compression with error feedback (PowerSGD, Vogels et al.,
    arXiv 1905.13727).  The flat bucket plus its residual is viewed as an
    f32 matrix M (``_dims``: rows a power of two near sqrt(n), zero padded);
    one subspace iteration from the carried Q approximates the replica mean
    of M as P Q^T: ``P = orth(psum(M Q))``, ``Q = psum(M^T P) / R``.  State:
    ``{"Q": (cols, r), "residual": (n,)}``, Q drawn as JAX draws it.  The
    products and the QR are ``torch.matmul`` and ``torch.linalg.qr``, as
    JAX computes them outside any Pallas kernel."""

    name = "powersgd"
    stateful = True
    RANK = 4

    @staticmethod
    def _dims(size):
        rows = 1 << max(1, int(math.ceil(math.log2(math.sqrt(size)))))
        return rows, -(-size // rows)

    @classmethod
    def _rank(cls, size):
        rows, cols = cls._dims(size)
        return max(1, min(cls.RANK, rows, cols))

    def init_state(self, size, device="cpu"):
        import numpy as np

        rows, cols = self._dims(size)
        rng = np.random.RandomState(size % (2 ** 31))
        q = (rng.randn(cols, self._rank(size)) / np.sqrt(cols)).astype(np.float32)
        return {"Q": torch.from_numpy(q).to(device),
                "residual": torch.zeros(size, dtype=torch.float32, device=device)}

    def iterate(self, buf, state, group=None):
        """One subspace iteration: (M, P, Q) with P orthonormal and P Q^T the
        approximation of the replica mean of M."""
        buf = buf.float()
        n = buf.shape[0]
        rows, cols = self._dims(n)
        corrected = buf + state["residual"]
        M = torch.nn.functional.pad(corrected, (0, rows * cols - n)).view(rows, cols)
        P = coll.psum(M @ state["Q"], group)
        P, _ = torch.linalg.qr(P)
        Q = coll.psum(M.T @ P, group) / coll.axis_size(group)
        return M, P, Q

    def all_reduce(self, buf, state, group=None):
        n = buf.shape[0]
        M, P, Q = self.iterate(buf, state, group)
        approx = P @ Q.T
        residual = (M - approx).reshape(-1)[:n]
        return approx.reshape(-1)[:n], {"Q": Q, "residual": residual}


_REGISTRY = {
    _C.NoneCompressor: NoneCompressor,
    _C.BF16Compressor: BF16Compressor,
    _C.BF16CompressorEF: BF16CompressorEF,
    _C.Int8Compressor: Int8Compressor,
    _C.Int8CompressorEF: Int8CompressorEF,
    _C.PowerSGDCompressor: PowerSGDCompressor,
    _C.EquarxInt8Compressor: EquarxInt8Compressor,
}


def get_compressor(enum_value, impl=None) -> Compressor:
    try:
        cls = _REGISTRY[enum_value]
    except KeyError:
        raise ValueError(f"Unknown compressor enum {enum_value}") from None
    return cls(impl=impl)


def wire_byte_factor(enum_value, size=1):
    """Wire bytes per uncompressed f32 byte for a codec.  ``size`` (flat
    element count) matters only for PowerSGD."""
    if enum_value == _C.PowerSGDCompressor:
        size = max(1, int(size))
        rows, cols = PowerSGDCompressor._dims(size)
        r = PowerSGDCompressor._rank(size)
        return min(1.0, r * (rows + cols) / size)
    # the int8 family pays an f32 scale per BLOCK-element block on the wire
    int8_factor = 0.25 * (1.0 + 4.0 / Int8Compressor.BLOCK)
    return {
        _C.NoneCompressor: 1.0,
        _C.BF16Compressor: 0.5,
        _C.BF16CompressorEF: 0.5,
        _C.Int8Compressor: int8_factor,
        _C.Int8CompressorEF: int8_factor,
        _C.EquarxInt8Compressor: int8_factor,
    }.get(enum_value, 1.0)
