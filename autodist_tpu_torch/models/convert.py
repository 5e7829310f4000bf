"""Carry GPT, ResNet and NCF weights between the flax trees and the
PyTorch modules.

A flax Dense ``kernel`` is ``(in, out)``; the port's dense layers store
``weight`` as ``(out, in)``, so kernels are transposed on the way.  A flax
Conv ``kernel`` is ``(kh, kw, in, out)``; the port's :class:`~autodist_tpu_torch.
models.resnet.Conv` stores ``(out, in, kh, kw)`` (``permute(3, 2, 0, 1)``).
Every other leaf (biases, norm scales, ``wte``, ``wpe``, NCF's embedding
tables) carries over as it is.  Names map one to one: ``h_0/attn/qkv/kernel`` <-> ``h_0.attn.qkv.weight``,
and a ResNet's ``batch_stats`` leaf ``b/FusedBatchNorm_0/mean`` <-> the
buffer ``b.FusedBatchNorm_0.mean``.
"""
from collections import OrderedDict

import numpy as np
import torch

from autodist_tpu_torch.model_item import flatten_params


def jax_to_torch_name(name):
    parts = name.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def torch_to_jax_name(name):
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def state_to_buffer_name(name):
    """'/'-joined mutable-state name (``batch_stats/a/b/mean``) -> buffer name
    (``a.b.mean``)."""
    parts = name.split("/")
    if parts[0] != "batch_stats":
        raise ValueError(f"{name!r} is not a batch_stats leaf")
    return ".".join(parts[1:])


def buffer_to_state_name(name):
    return "/".join(["batch_stats"] + name.split("."))


def _kernel_to_torch(arr):
    if arr.ndim == 4:   # conv (kh, kw, in, out) -> (out, in, kh, kw)
        return arr.transpose(3, 2, 0, 1)
    return arr.T        # dense (in, out) -> (out, in)


def _kernel_to_jax(arr):
    return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T


def params_from_jax(params, batch_stats=None):
    """flax ``params`` (and ``batch_stats``) trees of numpy or JAX arrays ->
    a ``state_dict`` of CPU tensors for the port's module (GPT, ResNet,
    NeuMF)."""
    state = OrderedDict()
    for name, leaf in flatten_params(params).items():
        arr = np.array(leaf)
        if name.endswith("/kernel"):
            arr = _kernel_to_torch(arr)
        state[jax_to_torch_name(name)] = torch.from_numpy(np.ascontiguousarray(arr))
    for name, leaf in flatten_params(batch_stats or {}).items():
        state[name.replace("/", ".")] = torch.from_numpy(np.array(leaf))
    return state


def params_to_jax(module_or_state):
    """A module (or a dict of its parameters by name) -> ``(params_tree,
    batch_stats_tree)`` of numpy arrays.  The batch statistics are the
    module's buffers; the second tree is ``{}`` for a module without them
    and for a dict."""
    if isinstance(module_or_state, torch.nn.Module):
        state = module_or_state.state_dict()
        buffers = {n for n, _ in module_or_state.named_buffers()}
    else:
        state, buffers = module_or_state, set()
    params, stats = {}, {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        if name in buffers:
            tree, jname = stats, name.replace(".", "/")
        else:
            tree, jname = params, torch_to_jax_name(name)
            if jname.endswith("/kernel"):
                arr = np.ascontiguousarray(_kernel_to_jax(arr))
        *parents, leaf = jname.split("/")
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[leaf] = arr
    return params, stats
