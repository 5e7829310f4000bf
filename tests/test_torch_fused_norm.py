"""The port's fused batch norm and group norm against the JAX package's.

The same numpy inputs go through ``autodist_tpu.ops.pallas.fused_norm``
(the Pallas kernels in interpret mode, under ``jax.jit``) and
``autodist_tpu_torch.ops.fused_norm`` on CPU tensors (the kernels' plain
versions forward, the closed-form backward).  The loss is ``sum(y * wy)``,
plus ``sum(mean * wm) + sum(var * wv)`` for batch norm, so the gradients
carry the relu mask, the residual and the mean/var fold-in terms.

Tolerances: f32 y, mean and var atol 1e-5 and every gradient atol 1e-4
(f32 sums in another order; the gradients' sums run over up to 175 rows);
the bf16 forward at most one bf16 rounding step of y, 2^-7 of its
magnitude (where the two f32 results straddle a rounding boundary).  The
modules: running statistics (momentum 0.9, biased var) and the eval path
atol 1e-5 against flax; the group-count rule exactly.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_worker as worker
from autodist_tpu.models.norm import FusedBatchNorm as JFusedBatchNorm
from autodist_tpu.models.norm import FusedGroupNorm as JFusedGroupNorm
from autodist_tpu.ops.pallas import fused_norm as jfn
from autodist_tpu_torch.models import norm as tnorm
from autodist_tpu_torch.ops import fused_norm as tfn

F32_ATOL, GRAD_ATOL, BF16_STEP = 1e-5, 1e-4, 2.0 ** -7

# name -> (shape, num_groups (None: batch norm), act, residual)
CASES = {
    "bn_f32": ((4, 6, 6, 16), None, None, False),
    "bn_f32_relu_residual": ((4, 6, 6, 16), None, "relu", True),
    "bn_f32_odd_rows_c100": ((3, 7, 5, 100), None, "relu", True),
    "gn_f32_2_per_group": ((2, 5, 5, 16), 8, None, False),
    "gn_f32_8_per_group_relu_residual": ((2, 5, 5, 64), 8, "relu", True),
}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    # per-channel offsets, so the E[x^2] - mean^2 cancellation is exercised
    x = (rng.standard_normal(shape) * 1.5 + rng.uniform(-1, 1, c)).astype(np.float32)
    return {
        "x": x,
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
        "residual": rng.standard_normal(shape).astype(np.float32),
        "wy": rng.standard_normal(shape).astype(np.float32),
        "wm": rng.standard_normal(c).astype(np.float32),
        "wv": rng.standard_normal(c).astype(np.float32),
    }


def _jax_run(case):
    """The Pallas fused norm (interpret mode): outputs and the gradients of
    the case's weighted sum."""
    shape, groups, act, has_res = CASES[case]
    inp = _inputs(shape)

    def loss(x, scale, bias, residual):
        r = residual if has_res else None
        if groups is None:
            y, m, v = jfn.fused_batch_norm(x, scale, bias, act=act, residual=r)
            extra = jnp.sum(m * inp["wm"]) + jnp.sum(v * inp["wv"])
            return jnp.sum(y * inp["wy"]) + extra, (y, m, v)
        y = jfn.fused_group_norm(x, scale, bias, groups, act=act, residual=r)
        return jnp.sum(y * inp["wy"]), (y,)

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))
    (_, outs), grads = fn(*(jnp.asarray(inp[k]) for k in ("x", "scale", "bias", "residual")))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_run(inp, groups, act, has_res):
    t = {k: torch.tensor(inp[k], requires_grad=True)
         for k in ("x", "scale", "bias", "residual")}
    r = t["residual"] if has_res else None
    if groups is None:
        y, m, v = tfn.fused_batch_norm(t["x"], t["scale"], t["bias"], act=act, residual=r)
        outs = (y, m, v)
        loss = ((y * torch.from_numpy(inp["wy"])).sum() + (m * torch.from_numpy(inp["wm"])).sum()
                + (v * torch.from_numpy(inp["wv"])).sum())
    else:
        y = tfn.fused_group_norm(t["x"], t["scale"], t["bias"], groups, act=act, residual=r)
        outs = (y,)
        loss = (y * torch.from_numpy(inp["wy"])).sum()
    loss.backward()
    grads = [t[k].grad for k in ("x", "scale", "bias", "residual")]
    return ([o.detach().numpy() for o in outs],
            [np.zeros_like(inp["residual"]) if g is None else g.numpy() for g in grads])


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    shape, groups, act, has_res = CASES[case]
    inp = _inputs(shape)
    j_outs, j_grads = worker.result(_jax_run, case)
    t_outs, t_grads = _torch_run(inp, groups, act, has_res)
    for name, a, b in zip(("y", "mean", "var"), t_outs, j_outs):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0, err_msg=name)
    for name, a, b in zip(("dx", "dscale", "dbias", "dresidual"), t_grads, j_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0, err_msg=name)
    if not has_res:
        assert not j_grads[3].any()


def _jax_bf16(groups):
    """The Pallas fused norm's bf16 forward: (dtype name, output in f32)."""
    inp = _inputs((2, 9, 7, 40), seed=1)
    x = jnp.asarray(inp["x"], jnp.bfloat16)
    scale, bias = jnp.asarray(inp["scale"]), jnp.asarray(inp["bias"])
    if groups is None:
        jy = jfn.fused_batch_norm(x, scale, bias)[0]
    else:
        jy = jfn.fused_group_norm(x, scale, bias, groups)
    return str(jy.dtype), np.asarray(jy.astype(jnp.float32))


worker.submit(*((_jax_run, case) for case in sorted(CASES)), (_jax_bf16, None), (_jax_bf16, 4))


@pytest.mark.parametrize("groups", [None, 4])
def test_bf16_forward_matches_jax(groups):
    inp = _inputs((2, 9, 7, 40), seed=1)
    tx = torch.from_numpy(inp["x"]).bfloat16()
    scale, bias = inp["scale"], inp["bias"]
    if groups is None:
        ty = tfn.fused_batch_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))[0]
    else:
        ty = tfn.fused_group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), groups)
    j_dtype, jy = worker.result(_jax_bf16, groups)
    assert ty.dtype == torch.bfloat16 and j_dtype == "bfloat16"
    ty = ty.float().numpy()
    step = BF16_STEP * np.maximum(np.abs(jy), np.abs(ty))
    assert np.all(np.abs(ty - jy) <= step), np.abs(ty - jy).max()
    assert np.mean(ty == jy) > 0.99


def test_kernel_wrappers_take_the_plain_versions_on_cpu():
    inp = _inputs((3, 4, 10))
    x, s, b = (torch.from_numpy(inp[k]) for k in ("x", "scale", "bias"))
    tfn.reset_launches()
    for got, want in zip(tfn.bn_fwd(x, s, b, act="relu"),
                         tfn.batch_norm_plain(x, s, b, act="relu")):
        assert torch.equal(got, want)
    assert torch.equal(tfn.gn_fwd(x, s, b, 5), tfn.group_norm_plain(x, s, b, 5))
    assert tfn.LAUNCHES == {"bn_fwd": 0, "gn_fwd": 0}
    with pytest.raises(ValueError, match="divisible"):
        tfn.fused_group_norm(x, s, b, 3)
    with pytest.raises(ValueError, match="activation"):
        tfn.fused_batch_norm(x, s, b, act="gelu")
    with pytest.raises(NotImplementedError, match="interpret"):
        tfn.fused_batch_norm(x, s, b, interpret=True)


def test_fused_batch_norm_module_running_stats_and_eval_match_flax():
    inp = _inputs((4, 8, 8, 16), seed=2)
    rng = np.random.default_rng(3)
    stats = {"mean": rng.standard_normal(16).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    params = {"scale": inp["scale"], "bias": inp["bias"]}
    x = jnp.asarray(inp["x"])
    jy, jnew = JFusedBatchNorm(use_running_average=False, momentum=0.9).apply(
        {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
    jeval = JFusedBatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, x)
    # flax nn.BatchNorm's update is the same
    _, pnew = fnn.BatchNorm(use_running_average=False, momentum=0.9).apply(
        {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])

    mod = tnorm.FusedBatchNorm(16, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    mod.path = "bn"
    new = {}
    ty = mod(torch.from_numpy(inp["x"]), True, new)
    teval = mod(torch.from_numpy(inp["x"]), False)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(teval.detach().numpy(), np.asarray(jeval), atol=F32_ATOL,
                               rtol=0)
    for k in ("mean", "var"):
        for want in (jnew, pnew):
            np.testing.assert_allclose(new[f"bn.{k}"].numpy(),
                                       np.asarray(want["batch_stats"][k]), atol=F32_ATOL,
                                       rtol=0)
    assert torch.equal(mod.mean, torch.from_numpy(stats["mean"]))   # buffers unchanged


@pytest.mark.parametrize("channels,groups", [(64, 32), (12, 12), (48, 1)])
def test_group_norm_module_group_rule_matches_flax(channels, groups):
    inp = _inputs((2, 3, 3, channels), seed=4)
    params = {"scale": inp["scale"], "bias": inp["bias"]}
    jy = JFusedGroupNorm(num_groups=32).apply({"params": params}, jnp.asarray(inp["x"]))
    mod = tnorm.FusedGroupNorm(channels, num_groups=32, device="cpu")
    assert mod.num_groups == tfn.group_count(channels, 32) == groups
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    ty = mod(torch.from_numpy(inp["x"]))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=F32_ATOL, rtol=0)
