"""ModelItem: the captured model (counterpart of ``autodist_tpu/model_item.py``).

A model is ``loss_fn(params, batch[, generator]) -> loss`` over a dict of
tensors.  ``params`` may be nested dicts (as a flax params tree) or one flat
dict with '/'-joined names; either way each leaf becomes a
:class:`VariableInfo` named by its '/'-joined path, in the order JAX
flattens a dict pytree: keys sorted at every level.  So the names and their
order -- and with them the AllReduce builder's groups and buckets -- are
the JAX package's (GPT: ``h_0/...``, ``h_1/...``, ``h_10/...``, ...,
``ln_f/...``, ``wpe``, ``wte``).

With ``mutable_state`` (non-trainable state such as a ResNet's
``batch_stats``) the model is ``loss_fn(params, state, batch[, generator])
-> (loss, new_state)``.  The state is flattened by the same names; its
leaves are no variables of the strategy (they stand in no ``var_infos``), and
the engine takes the cross-replica mean of its float leaves every step.
``eval_fn(params[, state], batch) -> outputs`` is the session's default
forward for ``predict``.
"""
import dataclasses
import fnmatch
import math
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Callable, Optional, Sequence

import torch


def flatten_params(params):
    """OrderedDict '/'-joined name -> leaf, in JAX dict-pytree order."""
    items = []

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(prefix + tuple(str(key).split("/")), value)
        else:
            items.append((prefix, node))

    walk((), params)
    items.sort(key=lambda kv: kv[0])
    flat = OrderedDict()
    for path, leaf in items:
        name = "/".join(path) if path else "param"
        if name in flat:
            raise ValueError(f"Duplicate variable name {name!r}: distinct paths "
                             f"render to the same '/'-joined name")
        flat[name] = leaf
    return flat


def dtype_name(dtype):
    """A torch dtype as numpy spells it ("float32", "bfloat16")."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class VariableInfo:
    """Metadata for one trainable leaf."""

    name: str
    shape: tuple
    dtype: Any
    trainable: bool = True
    sparse: bool = False

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def byte_size(self) -> int:
        return self.size * self.dtype.itemsize


class ModelItem:
    """Captured model: params + loss + optimizer + variable metadata."""

    def __init__(self, loss_fn: Callable, params: Any, optimizer: Any = None, *,
                 sparse_vars: Optional[Sequence[str]] = None, has_aux: bool = False,
                 has_rng: bool = False, mutable_state: Any = None,
                 eval_fn: Optional[Callable] = None, name: str = ""):
        self.loss_fn = loss_fn
        self.params = flatten_params(params)
        self.mutable_state = None if mutable_state is None else flatten_params(mutable_state)
        for n, leaf in (self.mutable_state or {}).items():
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"mutable state leaf {n!r} is a {type(leaf).__name__}, "
                                f"not a torch.Tensor")
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.has_rng = has_rng
        self.eval_fn = eval_fn
        self.name = name
        sparse_vars = set(sparse_vars or ())
        self._var_infos = []
        for n, leaf in self.params.items():
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"parameter {n!r} is a {type(leaf).__name__}, "
                                f"not a torch.Tensor")
            self._var_infos.append(VariableInfo(
                name=n, shape=tuple(leaf.shape), dtype=leaf.dtype,
                trainable=True, sparse=self._match_sparse(n, sparse_vars)))
        for pat in sparse_vars:
            if not any(self._match_sparse(v.name, [pat]) for v in self._var_infos):
                raise ValueError(f"sparse_vars entry {pat!r} matches no variable; have "
                                 f"{[v.name for v in self._var_infos]}")

    @staticmethod
    def _match_sparse(name, patterns):
        # exact name, glob, or whole trailing path segments -- never a substring
        return any(name == pat or fnmatch.fnmatchcase(name, pat)
                   or name.endswith("/" + pat) for pat in patterns)

    @property
    def var_infos(self) -> Sequence[VariableInfo]:
        return list(self._var_infos)

    @property
    def var_names(self):
        return [v.name for v in self._var_infos]

    @property
    def trainable_var_names(self):
        return [v.name for v in self._var_infos if v.trainable]

    def to_proto(self):
        raise NotImplementedError(
            "ModelItem export is a later slice of the port (ROADMAP, Queue A item 10)")

    def __repr__(self):
        total = sum(v.size for v in self._var_infos)
        return f"ModelItem(name={self.name!r}, vars={len(self._var_infos)}, params={total})"
