"""Carry GPT weights between the flax tree and the PyTorch module.

A flax Dense ``kernel`` is ``(in, out)``; the port's :class:`Dense` stores
``weight`` as ``(out, in)``, so kernels are transposed on the way.  Every
other leaf (biases, LayerNorm scales, ``wte``, ``wpe``) carries over as
it is.  Names map one to one: ``h_0/attn/qkv/kernel`` <->
``h_0.attn.qkv.weight``.
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


def gpt_params_from_jax(tree):
    """flax params tree (nested dicts of numpy or JAX arrays) -> a
    ``state_dict`` of f32-or-native CPU tensors for :class:`GPT`."""
    state = OrderedDict()
    for name, leaf in flatten_params(tree).items():
        arr = np.array(leaf)
        if name.endswith("/kernel"):
            arr = arr.T
        state[jax_to_torch_name(name)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def gpt_params_to_jax(module):
    """A :class:`GPT` (or its ``state_dict``) -> the flax params tree of
    numpy arrays."""
    state = module.state_dict() if isinstance(module, torch.nn.Module) else module
    tree = {}
    for name, t in state.items():
        arr = t.detach().cpu().numpy()
        jname = torch_to_jax_name(name)
        if jname.endswith("/kernel"):
            arr = np.ascontiguousarray(arr.T)
        node = tree
        *parents, leaf = jname.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
