"""Wrap a model into the capture that ``AutoDist.distribute`` takes
(counterpart of ``autodist_tpu/models/train_lib.py``): GPT's and NCF's
``(loss_fn, params, sparse_vars)`` and an image classifier's ``(loss_fn,
params, mutable_state)``.  Other captures (BERT, the LSTM LM, ...) are
later slices.
"""
from collections import OrderedDict

import torch
from torch.func import functional_call

from autodist_tpu_torch import optim
from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.kernel.device.resolver import resolve_device
from autodist_tpu_torch.model_item import flatten_params
from autodist_tpu_torch.models.convert import (buffer_to_state_name, jax_to_torch_name,
                                               state_to_buffer_name, torch_to_jax_name)
from autodist_tpu_torch.utils.rng import host_generator


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean cross entropy; with ``mask`` (1.0 real / 0.0 pad) a masked mean
    over the real examples."""
    logp = torch.log_softmax(logits, dim=-1)
    per_ex = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return per_ex.mean()
    mask = mask.to(per_ex.dtype)
    return (per_ex * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def classifier_capture(model, input_shape, seed=0, device=None, with_batch_stats=True):
    """Init an image classifier from ``seed``; returns (loss_fn, params,
    mutable_state).

    ``model`` is a module over NHWC images (a ResNet); its weights are drawn
    anew on the device from ``seed`` (flax's ``model.init``).  ``params``
    maps the flax names to the module's tensors; ``mutable_state`` maps the
    ``batch_stats/...`` names to its running statistics, and
    ``loss_fn(params, state, batch) -> (loss, new_state)`` with ``batch =
    {"image", "label"}``.  Without batch norms, or with
    ``with_batch_stats=False``, the state is None and ``loss_fn(params,
    batch) -> loss`` (the running statistics, if any, stay as they are).
    Runs on ``cuda`` unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    if tuple(input_shape)[-1] != model.in_channels:
        raise ValueError(f"input_shape {tuple(input_shape)} has not the model's "
                         f"{model.in_channels} channels last")
    model.to_empty(device=dev)
    model.reset_parameters(host_generator(seed, dev))
    params = flatten_params(OrderedDict(
        (torch_to_jax_name(n), p.detach()) for n, p in model.named_parameters()))
    state = flatten_params(OrderedDict(
        (buffer_to_state_name(n), b) for n, b in model.named_buffers()))

    def apply(p, s, batch):
        tensors = {jax_to_torch_name(n): t for n, t in p.items()}
        tensors.update((state_to_buffer_name(n), t) for n, t in s.items())
        new = {}
        logits = functional_call(model, tensors, (batch["image"],),
                                 {"train": True, "new_state": new})
        loss = softmax_cross_entropy(logits, batch["label"], batch.get(BATCH_MASK_KEY))
        return loss, OrderedDict((n, new[state_to_buffer_name(n)]) for n in s)

    if state and with_batch_stats:
        return apply, params, state

    def loss_fn(p, batch):
        return apply(p, {}, batch)[0]

    return loss_fn, params, None


def sgd_momentum(lr=0.1, momentum=0.9):
    """``optax.sgd(lr, momentum=momentum)``."""
    return optim.sgd(lr, momentum=momentum)


def _positional_mask(targets, example_mask):
    """The session's per-example (B,) mask broadcast to ``targets``' shape;
    None stays None."""
    if example_mask is None:
        return None
    m = example_mask.reshape(example_mask.shape + (1,) * (targets.dim() - example_mask.dim()))
    return m.expand(targets.shape)


def gpt_capture(config, seq_len, seed=0, device=None, streaming_loss=False,
                loss_chunk=8192):
    """Init a GPT causal LM from ``seed``; returns (loss_fn, params, sparse_vars).

    ``params`` maps the flax names (``h_0/attn/qkv/kernel``, ...) to the
    module's tensors (PyTorch layout); ``loss_fn(params, batch,
    generator=None)`` with ``batch = {"tokens", "targets"}`` (targets
    pre-shifted by the caller) runs the module on them.  The tied
    embedding's gradient is dense, so no variable takes the sparse path.
    ``streaming_loss=True`` takes the cross entropy against the tied
    ``wte`` without the (B, S, V) logits
    (:func:`~autodist_tpu_torch.ops.losses.streaming_softmax_xent`, vocab
    chunks of ``loss_chunk``); the parameters are the same either way.
    Runs on ``cuda`` unless ``device="cpu"``.
    """
    from autodist_tpu_torch.models.gpt import GPT, gpt_loss
    from autodist_tpu_torch.ops.losses import streaming_softmax_xent

    dev = resolve_device(device)
    if seq_len > config.max_position:
        raise ValueError(f"seq_len {seq_len} exceeds max_position {config.max_position}")
    model = GPT(config, device=dev, generator=host_generator(seed, dev))
    params = flatten_params(OrderedDict(
        (torch_to_jax_name(n), p.detach()) for n, p in model.named_parameters()))

    def forward(p, batch, generator, return_hidden):
        tensors = {jax_to_torch_name(n): t for n, t in p.items()}
        return functional_call(model, tensors, (batch["tokens"],),
                               {"generator": generator, "return_hidden": return_hidden})

    if streaming_loss:
        def loss_fn(p, batch, generator=None):
            t = batch["targets"]
            return streaming_softmax_xent(
                forward(p, batch, generator, True), p["wte"], t,
                valid=_positional_mask(t, batch.get(BATCH_MASK_KEY)), chunk=loss_chunk)
    else:
        def loss_fn(p, batch, generator=None):
            return gpt_loss(forward(p, batch, generator, False), batch["targets"],
                            batch.get(BATCH_MASK_KEY))

    return loss_fn, params, []


def ncf_capture(config, seed=0, device=None):
    """Init NeuMF from ``seed``; returns (loss_fn, params, sparse_vars).

    ``params`` maps the flax names to the module's tensors (Dense kernels
    ``(out, in)``); ``loss_fn(params, batch)`` with ``batch = {"user",
    "item", "label"}`` is the binary cross entropy of the logits (a masked
    mean under ``batch_mask``).  ``sparse_vars`` names the four embedding
    tables.  Runs on ``cuda`` unless ``device="cpu"``.
    """
    from autodist_tpu_torch.models.ncf import TABLES, NeuMF, ncf_loss, neumf_apply

    dev = resolve_device(device)
    model = NeuMF(config, device=dev, generator=host_generator(seed, dev))
    params = flatten_params(OrderedDict(
        (torch_to_jax_name(n), p.detach()) for n, p in model.named_parameters()))

    def loss_fn(p, batch):
        logits = neumf_apply(p, batch["user"], batch["item"], config)
        return ncf_loss(logits, batch["label"], batch.get(BATCH_MASK_KEY))

    return loss_fn, params, list(TABLES)
