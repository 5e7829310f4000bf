"""The JAX side of the port's parity tests: the JAX package's GPT capture
without its eager flax init, and its value and gradient compiled once.

:func:`gpt_capture` returns the JAX package's ``gpt_capture`` loss for a
config, with the parameters drawn by numpy on the shapes ``jax.eval_shape``
gives (flax's own scales: normal(0.02) embeddings, kernels of standard
deviation ``1 / sqrt(fan_in)``, unit LayerNorm scales, zero biases), so no
test pays for an eager ``model.init``.  Every draw comes from one seed,
so two calls give the same arrays.

:func:`value_and_grad` compiles a function's value and gradient with
``jax.jit`` and XLA's ``xla_allow_excess_precision`` off: each bf16
operation rounds as it does eagerly, instead of XLA keeping bf16
intermediates in f32 (its CPU default under ``jit``).
"""
import dataclasses
import functools

import jax
import numpy as np

import torch_gloo_ranks as ranks
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.models import train_lib as jtrain


def draw_params(shapes, seed=0):
    """numpy leaves on a tree of shapes, by leaf name, in flatten order."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if name in ("wte", "wpe"):
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "scale":
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _capture(config, seq_len, streaming_loss=False, loss_chunk=8192):
    box = {}

    def capture():
        box["loss_fn"], params, _ = jtrain.gpt_capture(
            config, seq_len, streaming_loss=streaming_loss, loss_chunk=loss_chunk)
        return params

    return box, draw_params(jax.eval_shape(capture))


def gpt_capture(config, seq_len, **kw):
    """(loss_fn, params) of ``autodist_tpu.models.train_lib.gpt_capture``:
    its loss, and numpy parameters on its tree's shapes."""
    box, params = _capture(config, seq_len, **kw)
    return box["loss_fn"], jax.tree.map(np.copy, params)


def world_gpt():
    """The JAX config of the gloo world's GPT (GPT-tiny of
    ``torch_gloo_ranks.GPT_LAYERS`` blocks)."""
    return dataclasses.replace(jgpt.GPT_TINY, num_layers=ranks.GPT_LAYERS)


def world_gpt_params():
    """The world GPT's flax parameter tree (numpy), the one the gloo world
    and the JAX runs it is held against share."""
    return gpt_capture(world_gpt(), ranks.GPT_SEQ)[1]


@functools.lru_cache(maxsize=None)
def world_inputs():
    """The gloo world's inputs (``torch_gloo_ranks.make_inputs`` on
    :func:`world_gpt_params`), made from the same seeds, for JAX results
    computed apart from the world."""
    return ranks.make_inputs(world_gpt_params())


def value_and_grad(fn, *args, **kw):
    """``jax.value_and_grad(fn, **kw)(*args)``, compiled once for these
    arguments with every bf16 operation rounding as it does eagerly."""
    vag = jax.jit(jax.value_and_grad(fn, **kw))
    return vag.lower(*args).compile({"xla_allow_excess_precision": False})(*args)
