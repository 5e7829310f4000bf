"""Neural Collaborative Filtering (counterpart of ``autodist_tpu/models/ncf.py``).

NeuMF: a GMF tower (the product of a user and an item embedding) beside an
MLP tower (their concatenation through ``mlp_dims``, relu), joined by a
one-unit ``prediction`` layer.  All four tables go through
:func:`~autodist_tpu_torch.ops.sparse.embedding_lookup`, so under
``distribute(sparse_vars=...)`` their gradients sync in the lookups'
backward, and a table split on dim 0 (a
:class:`~autodist_tpu_torch.ops.sparse.ShardedTable`) takes the row
exchange.

:func:`neumf_apply` is the forward over a parameter dict with the flax
names (``mf_user_embedding``, ``Dense_0/kernel``, ``prediction/bias``,
...), each Dense kernel stored ``(out, in)`` as the port's
:class:`~autodist_tpu_torch.models.gpt.Dense` stores it; :class:`NeuMF`
holds the parameters, initialised as flax does (normal(0.01) tables,
lecun-normal kernels, zero biases).
"""
import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.convert import torch_to_jax_name
from autodist_tpu_torch.models.gpt import Dense
from autodist_tpu_torch.ops.sparse import embedding_lookup

TABLES = ("mf_user_embedding", "mf_item_embedding", "mlp_user_embedding",
          "mlp_item_embedding")


@dataclasses.dataclass(frozen=True)
class NCFConfig:
    num_users: int = 138_000
    num_items: int = 27_000
    mf_dim: int = 64
    mlp_dims: Sequence[int] = (256, 128, 64)
    dtype: Any = torch.float32


class NeuMF(nn.Module):
    """NeuMF's parameters; ``forward(user_ids, item_ids)`` -> logits (B,)."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = self.config = config
        half = c.mlp_dims[0] // 2
        for name, rows, cols in (("mf_user_embedding", c.num_users, c.mf_dim),
                                 ("mf_item_embedding", c.num_items, c.mf_dim),
                                 ("mlp_user_embedding", c.num_users, half),
                                 ("mlp_item_embedding", c.num_items, half)):
            table = nn.Parameter(torch.empty(rows, cols, device=device))
            with torch.no_grad():
                table.normal_(0.0, 0.01, generator=generator)
            setattr(self, name, table)
        dims = (c.mlp_dims[0],) + tuple(c.mlp_dims)
        for i in range(len(c.mlp_dims)):
            setattr(self, f"Dense_{i}", Dense(dims[i], dims[i + 1], c.dtype, device,
                                              generator))
        self.prediction = Dense(c.mf_dim + c.mlp_dims[-1], 1, torch.float32, device,
                                generator)

    def forward(self, user_ids, item_ids):
        params = {torch_to_jax_name(n): p for n, p in self.named_parameters()}
        return neumf_apply(params, user_ids, item_ids, self.config)


def _dense(params, name, x, dtype):
    """flax ``nn.Dense(dtype=dtype)`` from ``params``: input, kernel and bias
    cast to ``dtype``."""
    return F.linear(x.to(dtype), params[f"{name}/kernel"].to(dtype),
                    params[f"{name}/bias"].to(dtype))


def neumf_apply(params, user_ids, item_ids, config):
    """NeuMF's logits (B,) for ``user_ids`` and ``item_ids`` (B,) from the
    flax-named ``params``."""
    c = config
    gmf = (embedding_lookup(params["mf_user_embedding"], user_ids)
           * embedding_lookup(params["mf_item_embedding"], item_ids))
    x = torch.cat([embedding_lookup(params["mlp_user_embedding"], user_ids),
                   embedding_lookup(params["mlp_item_embedding"], item_ids)], dim=-1)
    for i in range(len(c.mlp_dims)):
        x = torch.relu(_dense(params, f"Dense_{i}", x, c.dtype))
    x = torch.cat([gmf, x.to(gmf.dtype)], dim=-1)
    return _dense(params, "prediction", x, torch.float32)[..., 0]


def ncf_loss(logits, labels, mask=None):
    """Binary cross entropy on implicit-feedback labels; ``mask`` (1.0 real,
    0.0 pad) leaves the padded examples of an uneven batch out."""
    per_ex = (torch.clamp(logits, min=0) - logits * labels
              + torch.log1p(torch.exp(-torch.abs(logits))))
    if mask is None:
        return per_ex.mean()
    m = mask.to(per_ex.dtype)
    return (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)
