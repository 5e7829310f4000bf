"""Rematerialisation with explicit generators (the counterpart of
``nn.remat`` and ``jax.checkpoint`` in the JAX package).

:func:`checkpoint` runs ``fn(*args)`` under ``torch.utils.checkpoint``
(non-reentrant): the forward keeps only its inputs, and the backward runs
``fn`` again to rebuild what it needs.  JAX's random keys are values, so a
recomputed dropout there draws the masks of the first run.  A
``torch.Generator`` is a state that the first run advanced, and
``preserve_rng_state`` covers only the global generators: so every
generator among ``args`` is set back, for the recompute, to its state at
the first run's start, and restored afterwards to where the step left it.
Remat with dropout then computes the gradients of the run without remat.
"""
import torch
from torch.utils import checkpoint as _ckpt


def checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward; a plain
    call where autograd does not record."""
    if not torch.is_grad_enabled():
        return fn(*args)
    gens = [a for a in args if isinstance(a, torch.Generator)]
    if not gens:
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    starts = [g.get_state() for g in gens]
    first = [True]

    def run(*inner):
        if first[0]:
            first[0] = False
            return fn(*inner)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, starts):
            g.set_state(s)
        try:
            return fn(*inner)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return _ckpt.checkpoint(run, *args, use_reentrant=False)
