"""The port's CUDA flash-attention kernels against their plain versions.

Needs an NVIDIA GPU and nvcc; every test is marked ``cuda`` and skips
without a GPU.  The file imports no JAX, so it also runs on a machine
that has only PyTorch (the repo's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Each case runs ``flash_attention`` forward and backward (the three
kernels) and ``attention_plain`` in f32 on the same inputs.  Tolerance:
relative Frobenius error <= 1e-2 for bf16 inputs (bf16 output and
operand rounding) and <= 1e-5 for f32 inputs (f32 sums in another order).
"""
import pytest
import torch

from autodist_tpu_torch.ops import flash_attention as tfa

# (B, S, H, H_kv, D, causal, masked, dtype)
CASES = {
    "bf16_causal_ragged": (2, 200, 4, 4, 64, True, False, "bfloat16"),
    "bf16_gqa_d40": (2, 129, 4, 2, 40, True, False, "bfloat16"),
    "bf16_kv_mask_d128": (2, 96, 2, 2, 128, False, True, "bfloat16"),
    "f32_causal_gqa": (2, 150, 4, 2, 32, True, False, "float32"),
}
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, h_kv, d, causal, masked, dtype = CASES[case]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(heads):
        return torch.randn(b, s, heads, d, device="cuda", generator=g).to(getattr(torch, dtype))

    q, k, v, do = rand(h), rand(h_kv), rand(h_kv), rand(h)
    kv_mask = None
    if masked:
        kv_mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
        kv_mask[0, s // 2:] = False
        kv_mask[1] = False          # a fully masked example
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.reset_launches()
    out = tfa.flash_attention(*inputs, causal=causal, kv_mask=kv_mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkdv": 1}
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref_out = tfa.attention_plain(*ref, causal=causal, kv_mask=kv_mask)
    ref_out.backward(do.float())
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out.detach(), *(t.grad for t in inputs)),
                               (ref_out.detach(), *(t.grad for t in ref))):
        assert got.dtype == getattr(torch, dtype) and bool(torch.isfinite(got).all())
        rel = float((got.float() - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= REL_TOL[dtype], (name, rel)
    if masked:
        assert not out[1].any() and not inputs[0].grad[1].any()
