"""The port's ResNet, classifier capture and mutable-state step against the
JAX package's.

A tiny bottleneck ResNet (``stage_sizes=[1, 1]``, 4 filters, 10 classes,
16x16 images, B=4, f32) takes the flax variable tree's shapes, with every
leaf drawn by numpy: lecun-scaled kernels, norm scales and biases (none at
zero, so every residual branch carries gradient) and random
``batch_stats``.  They go into the PyTorch module with
``params_from_jax``.  The same numpy batch goes through
both.  The JAX side runs the fused norms' Pallas kernels in interpret mode,
the port their plain versions (CPU tensors).

16x16 inputs make flax's ``"SAME"`` padding asymmetric twice: the max-pool
pads (0, 1) on the 8x8 stem output, and the second stage's stride-2 3x3
conv pads (0, 1) on its 4x4 input.

Tolerances (f32; sums in another order): logits, loss and new batch
statistics atol 2e-5, every parameter gradient atol 1e-4.  Three
``AutoDist(..., AllReduce())`` steps with ``sgd_momentum(0.01)`` and the
batch statistics as mutable state: per-step losses rtol 1e-4, final
parameters and ``mutable_state()`` atol 1e-4.

``bn_f32_stats=False`` (batch statistics in the compute dtype, flax's
``force_float32_reductions=False``): one batch norm against flax's on the
same bf16 input (bitwise but for 0.1 % of the outputs, those within one
bf16 rounding; running statistics 1e-6), and ResNet-18 (8 filters, bf16)
against flax's at atol 0.1 on the logits (the bound of the bf16
convolutions, stated at the test), within 0.15 of its f32-statistics
logits (``tests/test_models.py``'s bound), and three falling training
steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert, norm as tnorm
from autodist_tpu_torch.models import resnet as tresnet
from autodist_tpu_torch.models import train_lib
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce

B, HW, CLASSES, STEPS = 4, 16, 10, 3
OUT_ATOL, GRAD_ATOL, STEP_ATOL = 2e-5, 1e-4, 1e-4
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
CASES = [("bn_fused", "conv"), ("gn", "conv"), ("bn", "conv"), ("bn_fused", "space_to_depth")]


def _jax_model(norm, stem="conv"):
    return jresnet.ResNet(stage_sizes=[1, 1], block_cls=jresnet.BottleneckResNetBlock,
                          num_filters=4, num_classes=CLASSES, norm=norm, stem=stem,
                          dtype=jnp.float32)


def _torch_model(norm, stem="conv"):
    return tresnet.ResNet(stage_sizes=[1, 1], block_cls=tresnet.BottleneckResNetBlock,
                          num_filters=4, num_classes=CLASSES, norm=norm, stem=stem,
                          dtype=torch.float32, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((B, HW, HW, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, B).astype(np.int32)}


def _draw(tree, rng):
    """numpy leaves for a tree of shapes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _draw(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:   # bias, mean
            out[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def variables():
    """(norm, stem) -> (params, batch_stats) numpy trees on flax's shapes."""
    out = {}
    for norm, stem in CASES:
        shapes = jax.eval_shape(lambda m=_jax_model(norm, stem): m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)), train=False))
        rng = np.random.default_rng(1)
        out[norm, stem] = (_draw(shapes["params"], rng), _draw(shapes.get("batch_stats", {}), rng))
    return out


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_run(norm, stem, params, stats, batch, train):
    model = _jax_model(norm, stem)

    def loss(p):
        out = model.apply({"params": p, "batch_stats": stats} if stats else {"params": p},
                          batch["image"], train=train,
                          mutable=["batch_stats"] if stats and train else False)
        logits, new = out if stats and train else (out, {})
        return jtrain.softmax_cross_entropy(logits, batch["label"]), (logits, new)

    (value, (logits, new)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), np.asarray(logits), _flat(new.get("batch_stats", {})), _flat(grads)


def _torch_run(norm, stem, params, stats, batch, train):
    model = _torch_model(norm, stem)
    model.load_state_dict(convert.params_from_jax(params, stats))
    new = {}
    logits = model(torch.from_numpy(batch["image"]), train=train, new_state=new)
    loss = train_lib.softmax_cross_entropy(logits, torch.from_numpy(batch["label"]))
    loss.backward()
    grads, _ = convert.params_to_jax({n: p.grad for n, p in model.named_parameters()})
    new = {n.replace(".", "/"): t.numpy() for n, t in new.items()}
    return loss.item(), logits.detach().numpy(), new, _flat(grads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("norm,stem", CASES)
def test_logits_loss_gradients_and_batch_stats_match_flax(variables, norm, stem, train):
    params, stats = variables[norm, stem]
    batch = _batch()
    j_loss, j_logits, j_new, j_grads = _jax_run(norm, stem, params, stats, batch, train)
    t_loss, t_logits, t_new, t_grads = _torch_run(norm, stem, params, stats, batch, train)
    np.testing.assert_allclose(t_logits, j_logits, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(t_loss, j_loss, atol=OUT_ATOL, rtol=0)
    assert sorted(t_grads) == sorted(j_grads)
    for name, g in j_grads.items():
        np.testing.assert_allclose(t_grads[name], g, atol=GRAD_ATOL, rtol=0, err_msg=name)
    assert sorted(t_new) == sorted(j_new) and (len(j_new) == 18) == (train and norm != "gn")
    for name, v in j_new.items():
        np.testing.assert_allclose(t_new[name], v, atol=OUT_ATOL, rtol=0, err_msg=name)


def test_same_padding_is_flax_and_asymmetric_on_this_input():
    for size in range(1, 12):
        for k, s in ((1, 1), (1, 2), (3, 1), (3, 2), (7, 2), (4, 1)):
            want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert tresnet.same_pads(size, k, s) == tuple(want), (size, k, s)
    assert tresnet.same_pads(8, 3, 2) == (0, 1)   # max-pool on the 8x8 stem output
    assert tresnet.same_pads(4, 3, 2) == (0, 1)   # stage 2's stride-2 3x3 conv


def test_params_roundtrip_and_s2d_kernel(variables):
    params, stats = variables["bn_fused", "conv"]
    model = _torch_model("bn_fused", "conv")
    model.load_state_dict(convert.params_from_jax(params, stats))
    back_p, back_s = convert.params_to_jax(model)
    for want, got in ((params, back_p), (stats, back_s)):
        fw, fg = _flat(want), _flat(got)
        assert list(fw) == list(fg)
        for n in fw:
            assert fw[n].dtype == fg[n].dtype and np.array_equal(fw[n], fg[n]), n
    k7 = params["conv_init"]["kernel"]
    want = np.asarray(jresnet.conv7_to_s2d_kernel(jnp.asarray(k7))).transpose(3, 2, 0, 1)
    got = tresnet.conv7_to_s2d_kernel(torch.from_numpy(k7.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_norm_inputs_are_contiguous_channels_last():
    """Every norm site gets the contiguous (rows, C) layout the kernels take."""
    model = _torch_model("bn_fused")
    seen = []
    for m in model.modules():
        if isinstance(m, (tnorm.FusedBatchNorm, tnorm.FusedGroupNorm)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].is_contiguous()))
    model(torch.from_numpy(_batch()["image"]), train=True, new_state={})
    assert len(seen) == 9 and all(seen)


def test_allreduce_build_matches_jax(variables):
    params, stats = variables["bn_fused", "conv"]
    jitem = JModelItem(lambda p, s, b: (0.0, s), params, mutable_state={"batch_stats": stats})
    state = convert.params_from_jax(params, stats)
    titem = ModelItem(lambda p, s, b: (0.0, s),
                      {convert.torch_to_jax_name(n): t for n, t in state.items()
                       if not n.endswith((".mean", ".var"))},
                      mutable_state={convert.buffer_to_state_name(n): t for n, t in state.items()
                                     if n.endswith((".mean", ".var"))})
    assert titem.var_names == jitem.var_names and len(titem.var_names) == 29
    assert list(titem.mutable_state) == ["batch_stats/" + n for n in _flat(stats)]
    js = JAllReduce(chunk_size=8).build(jitem, JResourceSpec.from_num_chips(1))
    ts = AllReduce(chunk_size=8).build(titem, ResourceSpec(resource_info=CPU_SPEC))
    assert ([(n.var_name, n.AllReduceSynchronizer.group) for n in ts.node_config]
            == [(n.var_name, n.AllReduceSynchronizer.group) for n in js.node_config])


def test_three_steps_with_batch_stats_match_jax_autodist(variables):
    params, stats = variables["bn_fused", "conv"]
    batch = _batch(2)
    model = _jax_model("bn_fused")

    def j_loss_fn(p, s, b):   # jtrain.classifier_capture's loss, without its eager init
        logits, new = model.apply({"params": p, **s}, b["image"], train=True,
                                  mutable=list(s.keys()))
        return jtrain.softmax_cross_entropy(logits, b["label"]), new

    j_sess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(1),
                       strategy_builder=JAllReduce()).distribute(
        j_loss_fn, params, jtrain.sgd_momentum(0.01), mutable_state={"batch_stats": stats})
    j_losses = [float(j_sess.run(batch)["loss"]) for _ in range(STEPS)]

    t_loss_fn, t_params, t_state = train_lib.classifier_capture(
        _torch_model("bn_fused"), (HW, HW, 3), device="cpu")
    state = convert.params_from_jax(params, stats)
    t_params = {n: state[convert.jax_to_torch_name(n)] for n in t_params}
    t_state = {n: state[convert.state_to_buffer_name(n)] for n in t_state}
    t_sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                      strategy_builder=AllReduce(), device="cpu").distribute(
        t_loss_fn, t_params, train_lib.sgd_momentum(0.01), mutable_state=t_state)
    t_losses = [t_sess.run(batch)["loss"].item() for _ in range(STEPS)]

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0] and t_sess.step == STEPS
    j_final = _flat(j_sess.params())
    t_final = _flat(convert.params_to_jax(
        {convert.jax_to_torch_name(n): t for n, t in t_sess.params().items()})[0])
    assert list(t_final) == list(j_final)
    for name, t in t_final.items():
        np.testing.assert_allclose(t, j_final[name], atol=STEP_ATOL, rtol=0, err_msg=name)
    j_mut = _flat(j_sess.mutable_state())
    t_mut = t_sess.mutable_state()
    assert list(t_mut) == list(j_mut) and len(t_mut) == 18
    for name, t in t_mut.items():
        np.testing.assert_allclose(t.numpy(), j_mut[name], atol=STEP_ATOL, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(t.numpy(), _flat({"batch_stats": stats})[name])


# -- bf16 batch statistics (bn_f32_stats=False) --------------------------------

def test_compute_dtype_batch_norm_matches_flax():
    """One ``BatchNorm(f32_stats=False)`` against flax ``nn.BatchNorm(
    force_float32_reductions=False)`` on the same bf16 input: the output
    bitwise equal on all but 0.1 % of the elements and those within one
    bf16 rounding (the f32 sums run in another order before the statistics
    round to bf16); the new running statistics within 1e-6."""
    import flax.linen as nn

    r = np.random.RandomState(0)
    c = 16
    x = np.array(jnp.asarray((r.randn(8, 16, 16, c) * 3 + 1), jnp.bfloat16).astype(jnp.float32))
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.2 * r.randn(c)).astype(np.float32)
    mean, var = (0.2 * r.randn(c)).astype(np.float32), r.uniform(0.5, 1.5, c).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           dtype=jnp.bfloat16, force_float32_reductions=False)
    y, new = jax.jit(lambda v: flax_bn.apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        v, mutable=["batch_stats"]))(jnp.asarray(x, jnp.bfloat16))
    bn = tnorm.BatchNorm(c, dtype=torch.bfloat16, f32_stats=False)
    for name, value in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        getattr(bn, name).data.copy_(torch.from_numpy(value))
    out = {}
    with torch.no_grad():
        t_y = bn(torch.from_numpy(x).to(torch.bfloat16), train=True, new_state=out)
    assert t_y.dtype == torch.bfloat16
    j_y = np.asarray(y, np.float32)
    t_y = t_y.float().numpy()
    assert (t_y != j_y).mean() < 1e-3
    np.testing.assert_allclose(t_y, j_y, rtol=2 ** -7, atol=0)   # one bf16 ulp
    for name in ("mean", "var"):
        np.testing.assert_allclose(out["." + name].numpy(),
                                   np.asarray(new["batch_stats"][name]), atol=1e-6, rtol=0)


def _resnet18(bn_f32_stats, dtype=torch.bfloat16, seed=0):
    from autodist_tpu_torch.utils.rng import host_generator

    return tresnet.ResNet18(num_classes=CLASSES, num_filters=8, dtype=dtype,
                            bn_f32_stats=bn_f32_stats, device="cpu",
                            generator=host_generator(seed))


def test_resnet18_bf16_batch_stats_match_jax():
    """ResNet-18 (8 filters, bf16) in training mode on the same weights (the
    port's seeded init, carried to flax) and images, with f32 and with bf16
    batch statistics: logits within 0.1 of flax's.  The bound is the bf16
    convolutions': they round at other places in the two frameworks, and
    the f32-statistics model, whose norms agree with flax's to f32
    round-off, differs by up to 0.05 on logits of magnitude ~2.7 here;
    0.1 leaves the bf16 statistics one such gap more.  And, as
    ``tests/test_models.py::test_bf16_bn_stats_close_to_f32``, the port's
    bf16-statistics logits within 0.15 of its f32-statistics ones."""
    x = np.random.RandomState(1).randn(8, 32, 32, 3).astype(np.float32)
    logits = {}
    for f32 in (True, False):
        model = _resnet18(f32)
        params, stats = convert.params_to_jax(model)
        j_model = jresnet.ResNet18(num_classes=CLASSES, num_filters=8, dtype=jnp.bfloat16,
                                   bn_f32_stats=f32)
        j_y, _ = jax.jit(lambda p, s, v: j_model.apply(
            {"params": p, "batch_stats": s}, v, train=True, mutable=["batch_stats"]))(
            params, stats, x)
        with torch.no_grad():
            t_y = model(torch.from_numpy(x), train=True, new_state={}).float().numpy()
        assert np.isfinite(t_y).all()
        np.testing.assert_allclose(t_y, np.asarray(j_y, np.float32), atol=0.1, rtol=0)
        logits[f32] = t_y
    np.testing.assert_allclose(logits[False], logits[True], atol=0.15, rtol=0)


def test_resnet18_bf16_batch_stats_trains():
    """``test_bf16_bn_stats_close_to_f32``'s training half: ResNet-18 (8
    filters, f32) with ``bn_f32_stats=False`` under ``AutoDist`` and
    ``sgd(0.1)``, three steps on one batch: finite losses that fall."""
    from autodist_tpu_torch import optim

    loss_fn, params, state = train_lib.classifier_capture(_resnet18(False, torch.float32),
                                                          (32, 32, 3), device="cpu")
    sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=AllReduce(), device="cpu").distribute(
        loss_fn, params, optim.sgd(0.1), mutable_state=state)
    r = np.random.RandomState(0)
    batch = {"image": r.randn(8, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, CLASSES, 8)}
    losses = [sess.run(batch)["loss"].item() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
