"""Optimizers with optax's names and defaults, realised by ``torch.optim``.

An :class:`Optimizer` is a recipe, as an optax ``GradientTransformation``
is: the engine calls :meth:`Optimizer.create` on the tensors it stores and
steps the result, which updates them in place (the port keeps one copy of
the parameters where JAX writes a new one each step).

- :func:`adamw` -- ``optax.adamw``: b1=0.9, b2=0.999, eps=1e-8 and
  weight_decay=1e-4 applied to every leaf (torch's own default is 1e-2).
  ``torch.optim.AdamW`` decays before its Adam step, which equals optax's
  ``-lr * (adam + wd * p)`` on the pre-update parameter.
- :func:`adam` -- ``optax.adam``: b1=0.9, b2=0.999, eps=1e-8, ``m_hat /
  (sqrt(v_hat) + eps)``, as ``torch.optim.Adam`` computes it.
- :func:`sgd` -- ``optax.sgd``: plain, momentum (optax's trace: t = g + m t)
  or Nesterov.

Learning-rate schedules, ``eps_root`` and masks are later slices and raise.
"""
import torch


class Optimizer:
    """A named optimizer recipe: ``create(params) -> torch.optim.Optimizer``."""

    def __init__(self, name, factory, **hyper):
        self.name = name
        self._factory = factory
        self.hyper = hyper

    def create(self, params):
        return self._factory(list(params))

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.hyper.items())
        return f"{self.name}({args})"


def _constant_lr(learning_rate):
    if callable(learning_rate):
        raise NotImplementedError("learning-rate schedules are a later slice of the port")
    return float(learning_rate)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          weight_decay=1e-4, mask=None):
    lr = _constant_lr(learning_rate)
    if eps_root or mask is not None:
        raise NotImplementedError("adamw eps_root and mask are a later slice of the port")
    return Optimizer(
        "adamw",
        lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(b1, b2), eps=eps,
                                     weight_decay=weight_decay),
        learning_rate=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    lr = _constant_lr(learning_rate)
    if eps_root:
        raise NotImplementedError("adam eps_root is a later slice of the port")
    return Optimizer(
        "adam", lambda ps: torch.optim.Adam(ps, lr=lr, betas=(b1, b2), eps=eps),
        learning_rate=lr, b1=b1, b2=b2, eps=eps)


def sgd(learning_rate, momentum=None, nesterov=False):
    lr = _constant_lr(learning_rate)
    return Optimizer(
        "sgd",
        lambda ps: torch.optim.SGD(ps, lr=lr, momentum=momentum or 0.0,
                                   nesterov=nesterov),
        learning_rate=lr, momentum=momentum, nesterov=nesterov)
