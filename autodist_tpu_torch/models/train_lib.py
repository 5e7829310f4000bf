"""Wrap a model into the ``(loss_fn, params, sparse_vars)`` capture that
``AutoDist.distribute`` takes (counterpart of ``autodist_tpu/models/train_lib.py``).
"""
from collections import OrderedDict

from torch.func import functional_call

from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.kernel.device.resolver import resolve_device
from autodist_tpu_torch.model_item import flatten_params
from autodist_tpu_torch.models.convert import jax_to_torch_name, torch_to_jax_name
from autodist_tpu_torch.utils.rng import host_generator


def gpt_capture(config, seq_len, seed=0, device=None):
    """Init a GPT causal LM from ``seed``; returns (loss_fn, params, sparse_vars).

    ``params`` maps the flax names (``h_0/attn/qkv/kernel``, ...) to the
    module's tensors (PyTorch layout); ``loss_fn(params, batch,
    generator=None)`` with ``batch = {"tokens", "targets"}`` (targets
    pre-shifted by the caller) runs the module on them.  The tied
    embedding's gradient is dense, so no variable takes the sparse path.
    Runs on ``cuda`` unless ``device="cpu"``.
    """
    from autodist_tpu_torch.models.gpt import GPT, gpt_loss

    dev = resolve_device(device)
    if seq_len > config.max_position:
        raise ValueError(f"seq_len {seq_len} exceeds max_position {config.max_position}")
    model = GPT(config, device=dev, generator=host_generator(seed, dev))
    params = flatten_params(OrderedDict(
        (torch_to_jax_name(n), p.detach()) for n, p in model.named_parameters()))

    def loss_fn(p, batch, generator=None):
        tensors = {jax_to_torch_name(n): t for n, t in p.items()}
        logits = functional_call(model, tensors, (batch["tokens"],),
                                 {"generator": generator})
        return gpt_loss(logits, batch["targets"], batch.get(BATCH_MASK_KEY))

    return loss_fn, params, []

