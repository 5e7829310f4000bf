"""GPT-style causal decoder LM (counterpart of ``autodist_tpu/models/gpt.py``).

Reproduces the flax model's numerics in PyTorch:

- :class:`Dense` is flax ``nn.Dense(dtype=...)``: input, kernel and bias are
  cast to ``dtype`` and the bias is added in it.  Its weight is stored
  ``(out, in)`` as ``nn.Linear`` stores it; the flax kernel is ``(in, out)``
  (``models/convert.py`` transposes).  Init: lecun-normal kernel (truncated
  normal, fan-in), zero bias.
- :class:`LayerNorm` is flax ``nn.LayerNorm(dtype=...)``: eps = 1e-6,
  statistics in f32 with var = E[x^2] - E[x]^2 clipped at 0, output cast
  to ``dtype``; unit scale, zero bias.
- the MLP activation is flax ``nn.gelu``, the tanh approximation;
- embeddings are normal(0.02) f32; the output head is
  ``x.float() @ wte.T`` in f32.  On the GPU that product must run in full
  f32: the port never enables TF32, and ``chip_smoke.py`` pins
  ``torch.backends.cuda.matmul.allow_tf32 = False``.  ``return_hidden``
  returns the ``ln_f`` output in f32 instead, for the streaming vocab loss
  (:mod:`autodist_tpu_torch.ops.losses`), which never builds the logits.
- with ``remat`` each block runs under
  :func:`autodist_tpu_torch.utils.remat.checkpoint` (flax's
  ``nn.remat(GPTBlock)``): its activations are recomputed in the backward,
  dropout masks included, from the generator's state at the block's
  first run.

Parameters may be bf16 (the AllReduce builder's ``precision="bf16_master"``
hands the loss a bf16 compute copy); every op then promotes as JAX does:
the embedding lookup and the ``wpe`` add stay bf16, LayerNorm's f32
statistics meet bf16 scale and bias in f32, and the head promotes ``wte``
to f32.

Attention runs through :func:`~autodist_tpu_torch.ops.flash_attention.
flash_attention` (the Hopper kernels on CUDA) unless ``attention_impl=
"xla"`` picks the kernel-free plain path.  Under sequence parallelism (a
:func:`~autodist_tpu_torch.parallel.context.seq_axis_context`, which the
graph transformer enters on a ``{"replica", "seq"}`` mesh) it runs
:func:`~autodist_tpu_torch.parallel.ring_attention.ring_attention` over
the seq row with full heads, and the position embedding starts at the
block's global offset.  Parameter names map one to one onto the flax tree
(``h_0.attn.qkv.weight`` <-> ``h_0/attn/qkv/kernel``).  Decoding with a KV
cache is a later slice.
"""
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from autodist_tpu_torch.ops.flash_attention import attention_plain, flash_attention, use_flash
from autodist_tpu_torch.parallel.context import current_seq_axis, global_position_offset
from autodist_tpu_torch.parallel.ring_attention import ring_attention
from autodist_tpu_torch.utils.remat import checkpoint

# flax's lecun_normal: truncated normal at +-2 std, std corrected for the cut
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    dropout_rate: float = 0.0
    dtype: Any = torch.bfloat16
    # "auto"/"flash": the flash kernels; "xla": plain attention, no kernel
    attention_impl: str = "auto"
    remat: bool = False
    num_kv_heads: int = 0   # grouped-query attention (0 = MHA)


GPT_SMALL = GPTConfig()
GPT_TINY = GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                     num_heads=2, intermediate_size=128, max_position=128,
                     dtype=torch.float32)


def _dropout(x, rate, generator):
    """Inverted dropout drawn from ``generator``; identity at rate 0 or
    without a generator (deterministic)."""
    if rate == 0.0 or generator is None:
        return x
    keep = torch.empty_like(x, dtype=torch.float32).bernoulli_(1.0 - rate,
                                                               generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """flax ``nn.Dense``; weight (out, in) f32, compute in ``dtype``."""

    def __init__(self, in_features, out_features, dtype, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, output in ``dtype``."""

    def __init__(self, features, dtype, eps=1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = config
        if c.num_heads % (c.num_kv_heads or c.num_heads):
            raise ValueError(f"num_heads {c.num_heads} not a multiple of "
                             f"num_kv_heads {c.num_kv_heads}")
        self.config = c
        kv_dim = (c.num_kv_heads or c.num_heads) * (c.hidden_size // c.num_heads)
        self.qkv = Dense(c.hidden_size, c.hidden_size + 2 * kv_dim, c.dtype, device, generator)
        self.out = Dense(c.hidden_size, c.hidden_size, c.dtype, device, generator)

    def forward(self, x):
        c = self.config
        B, S = x.shape[0], x.shape[1]
        head_dim = c.hidden_size // c.num_heads
        kv_heads = c.num_kv_heads or c.num_heads
        kv_dim = kv_heads * head_dim
        qkv = self.qkv(x)
        q = qkv[..., :c.hidden_size].reshape(B, S, c.num_heads, head_dim)
        k = qkv[..., c.hidden_size:c.hidden_size + kv_dim].reshape(B, S, kv_heads, head_dim)
        v = qkv[..., c.hidden_size + kv_dim:].reshape(B, S, kv_heads, head_dim)
        if current_seq_axis() is not None:
            # causal over global positions while K/V blocks stream around
            # the seq ring, which streams full-head blocks
            group = c.num_heads // kv_heads
            k, v = (t.repeat_interleave(group, dim=2) if group > 1 else t for t in (k, v))
            y = ring_attention(q, k, v, causal=True, impl=c.attention_impl)
        else:
            attend = flash_attention if use_flash(c.attention_impl) else attention_plain
            y = attend(q, k, v, causal=True)
        return self.out(y.reshape(B, S, c.hidden_size))


class GPTBlock(nn.Module):
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = config
        self.config = c
        self.ln_1 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.attn = CausalSelfAttention(c, device, generator)
        self.ln_2 = LayerNorm(c.hidden_size, c.dtype, device=device)
        self.mlp_in = Dense(c.hidden_size, c.intermediate_size, c.dtype, device, generator)
        self.mlp_out = Dense(c.intermediate_size, c.hidden_size, c.dtype, device, generator)

    def forward(self, x, generator=None):
        rate = self.config.dropout_rate
        x = x + _dropout(self.attn(self.ln_1(x)), rate, generator)
        y = F.gelu(self.mlp_in(self.ln_2(x)), approximate="tanh")
        return x + _dropout(self.mlp_out(y), rate, generator)


class GPT(nn.Module):
    """Returns next-token logits (B, S, V) in f32, or with ``return_hidden``
    the (B, S, D) ``ln_f`` output in f32.

    ``generator`` seeds the initialisation (flax's ``model.init``); the
    forward's ``generator`` draws dropout masks (None = deterministic)."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        c = config
        self.config = c
        self.wte = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size, device=device))
        self.wpe = nn.Parameter(torch.empty(c.max_position, c.hidden_size, device=device))
        with torch.no_grad():
            self.wte.normal_(0.0, 0.02, generator=generator)
            self.wpe.normal_(0.0, 0.02, generator=generator)
        for i in range(c.num_layers):
            self.add_module(f"h_{i}", GPTBlock(c, device, generator))
        self.ln_f = LayerNorm(c.hidden_size, c.dtype, device=device)

    def forward(self, tokens, generator=None, return_hidden=False):
        c = self.config
        S = tokens.shape[1]
        pos0 = global_position_offset(S)   # sequence parallelism: the block's start
        if pos0 + S > c.max_position:
            raise ValueError(f"positions {pos0}..{pos0 + S - 1} exceed max_position "
                             f"{c.max_position}")
        x = take_rows(self.wte, tokens) + self.wpe[pos0:pos0 + S][None]
        x = _dropout(x.to(c.dtype), c.dropout_rate, generator)
        for i in range(c.num_layers):
            block = getattr(self, f"h_{i}")
            if c.remat:
                # the recompute runs after functional_call has put the module's
                # own tensors back: it must see the tensors this forward saw
                x = checkpoint(_call_block, block, dict(block.named_parameters()), x,
                               generator)
            else:
                x = block(x, generator)
        x = self.ln_f(x).float()
        if return_hidden:
            return x
        return x @ self.wte.t().float()


def take_rows(table, ids):
    """``table``'s rows by ``ids``, as ``jnp.take`` reads them by default:
    an id in ``[-len(table), 0)`` counts from the end, and an id outside
    ``[-len(table), len(table))`` gives a NaN row ("fill"; the elastic
    trainer's ``nan`` drill poisons token ids so)."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    rows = F.embedding(torch.where(inside, ids, 0), table)
    return torch.where(inside[..., None], rows, float("nan"))


def _call_block(block, params, x, generator):
    return functional_call(block, params, (x, generator))


def gpt_loss(logits, targets, mask=None):
    """Next-token cross entropy; ``targets[t]`` is the token after position
    ``t``; -100 (any negative) targets are ignored; ``mask`` is a
    per-example validity weight."""
    valid = (targets >= 0).float()
    if mask is not None:
        valid = valid * mask.float().reshape(mask.shape + (1,) * (valid.dim() - mask.dim()))
    safe = torch.clamp(targets, min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(ll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
