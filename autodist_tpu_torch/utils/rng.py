"""Seeded random generators (counterpart of ``autodist_tpu/utils/rng.py``).

``torch.Generator``s take the place of ``jax.random`` keys.  They give other
numbers than JAX from the same seed, so tests make shared inputs with numpy.

- :func:`host_generator` -- the root generator of a seed;
- :func:`step_generator` -- a generator for one training step, folded from
  (seed, step) so that two steps never reuse a stream (the JAX engine's
  ``fold_in(rng, step)``), and over more than one replica from the rank
  too, so that replicas draw independent streams (its
  ``fold_in(axis_index)``), and under gradient accumulation from the
  microbatch index (its ``fold_in(micro_idx)``).
"""
import torch

_MASK64 = (1 << 64) - 1


def _mix(x):
    """splitmix64 finaliser: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed, data):
    """A new 63-bit seed from ``seed`` and an integer ``data``."""
    return _mix(_mix(int(seed) & _MASK64) ^ (int(data) & _MASK64)) >> 1


def host_generator(seed=0, device="cpu"):
    """The root generator of ``seed`` on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def step_generator(seed, step, device="cpu", replica=None, micro=None):
    """The generator of training step ``step`` under root ``seed``; with
    ``replica``, that replica's own stream of the step; with ``micro``, that
    microbatch's stream of it."""
    folded = fold_in(seed, step)
    if replica is not None:
        folded = fold_in(folded, replica)
    if micro is not None:
        folded = fold_in(folded, micro)
    return torch.Generator(device=device).manual_seed(folded)
