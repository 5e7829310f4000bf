"""The port's engine against the JAX package's, on GPT-tiny.

- The AllReduce builder gives the JAX builder's variable names, order and
  groups (GPT-tiny, and GPT-2 small's 148 variables from shapes alone), and
  ``plan_buckets`` the same keys and sizes.
- Three ``AutoDist(..., AllReduce()).distribute(gpt_capture(...))`` steps
  of a one-block GPT-tiny on the CPU follow the JAX ``AutoDist`` on a one-chip spec from the
  same weights and batch: per-step losses to rtol 1e-4; final parameters
  within steps x lr for adamw (Adam's per-element normalisation turns a
  rounding-level gradient difference into up to an lr-sized step, the bound
  ``tests/test_mixed_precision.py`` uses) and to atol 1e-5 for sgd.
- ``optim.adamw``/``optim.sgd`` against optax on random leaves (atol 1e-6).
- ``DistributedSession.shard_batch`` takes a bare array, a tuple and a
  dict nested two deep, as the reference's ``_shard_batch`` maps over any
  pytree: 3 sgd steps of ``tests/test_end_to_end.py``'s linear model with
  a loss that reads its leaves from that structure match the JAX
  ``AutoDist`` session's parameters to atol 2e-5 (that test's tolerance);
  a leaf that is no array raises ``TypeError`` naming its path.
- The package imports no JAX, flax, optax, protobuf or ``autodist_tpu``
  (the import statements, and rank 0 of the gloo world importing every
  module in an interpreter without JAX), and its entry points (``gpt_capture`` and ``classifier_capture`` too)
  raise without a GPU unless given ``device="cpu"``.
- The AllReduce knobs (``PowerSGDCompressor``, the overlap schedule,
  two-level) build; ``PSLoadBalancing(sync=False)`` gives the async
  session, the ``data_axes`` option of a later slice raises, and a spec of two replicas in a one-process world raises the
  world-size error instead of running one replica.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.kernel.synchronization import all_reduce as jar
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.models import gpt as jgpt
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.kernel import partitioner as tpart
from autodist_tpu_torch.kernel.device.resolver import resolve_device
from autodist_tpu_torch.kernel.synchronization import all_reduce as tar
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import gpt as tgpt
from autodist_tpu_torch.models.resnet import ResNet18
from autodist_tpu_torch.models.train_lib import classifier_capture, gpt_capture
from autodist_tpu_torch.proto import schema
from autodist_tpu_torch.resource_spec import ResourceSpec, ResourceSpecError
from autodist_tpu_torch.strategy import AllReduce, PSLoadBalancing
from autodist_tpu_torch.strategy.base import Strategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, B, STEPS = 16, 4, 3
CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jgpt.GPT_TINY.vocab_size, (B, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax_item(config):
    params = jax.eval_shape(
        lambda: jgpt.GPT(config).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, SEQ), jnp.int32))["params"])
    return JModelItem(lambda p, b: 0.0, params)


def _torch_item(config):
    model = tgpt.GPT(config, device="meta")   # shapes only, no storage
    return ModelItem(lambda p, b: 0.0, {convert.torch_to_jax_name(n): p
                                        for n, p in model.named_parameters()})


@pytest.mark.parametrize("config,chunk", [("tiny", 5), ("tiny", 128), ("small", 128)])
def test_allreduce_build_and_buckets_match_jax(config, chunk):
    jc, tc = {"tiny": (jgpt.GPT_TINY, tgpt.GPT_TINY),
              "small": (jgpt.GPT_SMALL, tgpt.GPT_SMALL)}[config]
    jitem, titem = _jax_item(jc), _torch_item(tc)
    assert titem.var_names == jitem.var_names
    js = JAllReduce(chunk_size=chunk).build(jitem, JResourceSpec.from_num_chips(1))
    ts = AllReduce(chunk_size=chunk).build(titem, ResourceSpec(resource_info=CPU_SPEC))
    assert ([(n.var_name, n.AllReduceSynchronizer.group) for n in ts.node_config]
            == [(n.var_name, n.AllReduceSynchronizer.group) for n in js.node_config])
    jb = jar.plan_buckets(jpart.build_var_plans(js, jitem, 1),
                          {v.name: v.shape for v in jitem.var_infos},
                          {v.name: v.dtype for v in jitem.var_infos})
    tb = tar.plan_buckets(tpart.build_var_plans(ts, titem, 1),
                          {v.name: v.shape for v in titem.var_infos},
                          {v.name: v.dtype for v in titem.var_infos})
    assert [(b.key, b.var_names, b.sizes) for b in tb] == \
        [(b.key, b.var_names, b.sizes) for b in jb]
    if config == "small":
        assert len(titem.var_names) == 148 and titem.var_names[-2:] == ["wpe", "wte"]
        assert [b.key for b in tb] == ["g0_float32_c0", "g1_float32_c0"]


_OPTS = {"adamw": (lambda: optax.adamw(1e-3), lambda: optim.adamw(1e-3), STEPS * 1e-3),
         "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1), 1e-5)}


def _jax_three_steps(opt):
    """The JAX engine's losses and final parameter tree (numpy) after STEPS
    steps of one GPT-tiny block under ``AllReduce()``."""
    # one GPT-tiny block: every op of the model, half the JAX compile
    j_loss_fn, j_params = oracle.gpt_capture(
        dataclasses.replace(jgpt.GPT_TINY, num_layers=1), SEQ)
    j_sess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(1),
                       strategy_builder=JAllReduce()).distribute(
        j_loss_fn, j_params, _OPTS[opt][0](), has_rng=True)
    j_losses = [float(j_sess.run(_batch())["loss"]) for _ in range(STEPS)]
    return j_losses, jax.tree.map(np.asarray, j_sess.params())


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_three_steps_match_jax_autodist(opt):
    _, make_t, params_atol = _OPTS[opt]
    batch = _batch()
    j_params = oracle.gpt_capture(dataclasses.replace(jgpt.GPT_TINY, num_layers=1), SEQ)[1]
    j_losses, j_final_tree = worker.result(_jax_three_steps, opt)

    t_loss_fn, _, t_sparse = gpt_capture(dataclasses.replace(tgpt.GPT_TINY, num_layers=1),
                                         SEQ, device="cpu")
    t_params = {convert.torch_to_jax_name(n): t
                for n, t in convert.params_from_jax(j_params).items()}
    t_sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                      strategy_builder=AllReduce(), device="cpu").distribute(
        t_loss_fn, t_params, make_t(), sparse_vars=t_sparse, has_rng=True)
    t_losses = [t_sess.run(batch)["loss"].item() for _ in range(STEPS)]

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0] and t_sess.step == STEPS
    final, _ = convert.params_to_jax(
        {convert.jax_to_torch_name(n): t for n, t in t_sess.params().items()})
    j_final = dict(jax.tree_util.tree_leaves_with_path(j_final_tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(final):
        np.testing.assert_allclose(leaf, np.asarray(j_final[path]), atol=params_atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


# tests/test_end_to_end.py's linear model: its BATCH and weights, plus targets
_LINEAR_X = np.random.RandomState(0).randn(16, 12).astype(np.float32)
_LINEAR_Y = np.random.RandomState(1).randn(16, 3).astype(np.float32)
_LINEAR_W = np.random.RandomState(7).randn(12, 3).astype(np.float32)
# structure -> (build the batch from x, y; read (x, y or None) back from it)
_NESTED = {
    "bare_array": (lambda x, y: x, lambda b: (b, None)),
    "tuple": (lambda x, y: (x, y), lambda b: b),
    "dict_two_deep": (lambda x, y: {"inputs": {"x": x}, "targets": {"y": y}},
                      lambda b: (b["inputs"]["x"], b["targets"]["y"])),
}


def _linear_loss(read, mean):
    def loss(p, batch):
        x, y = read(batch)
        r = x @ p["w"] + p["b"]
        return mean((r if y is None else r - y) ** 2)
    return loss


def _linear_session(read):
    params = {"w": torch.from_numpy(_LINEAR_W.copy()), "b": torch.zeros(3)}
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=AllReduce(), device="cpu").distribute(
        _linear_loss(read, torch.mean), params, optim.sgd(0.1))


def _jax_nested(structure):
    """The JAX engine's parameters after STEPS sgd steps on the nested batch."""
    make, read = _NESTED[structure]
    j_sess = JAutoDist(resource_spec=JResourceSpec.from_num_chips(1),
                       strategy_builder=JAllReduce()).distribute(
        _linear_loss(read, jnp.mean), {"w": jnp.asarray(_LINEAR_W), "b": jnp.zeros(3)},
        optax.sgd(0.1))
    for _ in range(STEPS):
        j_sess.run(make(_LINEAR_X, _LINEAR_Y))
    return {k: np.asarray(v) for k, v in j_sess.params().items()}


@pytest.mark.parametrize("structure", sorted(_NESTED))
def test_shard_batch_takes_nested_batches(structure):
    make, read = _NESTED[structure]
    batch = make(_LINEAR_X, _LINEAR_Y)
    t_sess = _linear_session(read)
    for _ in range(STEPS):
        t_sess.run(batch)
    assert t_sess.step == STEPS
    want, got = worker.result(_jax_nested, structure), t_sess.params()
    for name in ("w", "b"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=2e-5,
                                   rtol=0, err_msg=name)
    sharded = t_sess.shard_batch(batch)
    x, y = read(sharded)
    leaf = isinstance(batch, np.ndarray)
    assert type(sharded) is (torch.Tensor if leaf else type(batch))
    assert torch.equal(x, torch.from_numpy(_LINEAR_X))
    assert y is None or torch.equal(y, torch.from_numpy(_LINEAR_Y))


def test_shard_batch_names_a_leaf_that_is_no_array():
    sess = _linear_session(_NESTED["dict_two_deep"][1])
    batch = {"inputs": {"x": _LINEAR_X, "count": 3}, "targets": {"y": _LINEAR_Y}}
    with pytest.raises(TypeError, match=r"batch\['inputs'\]\['count'\].*int"):
        sess.shard_batch(batch)
    with pytest.raises(TypeError, match=r"batch\[1\].*str"):
        sess.shard_batch((_LINEAR_X, "labels"))


def _optimizer_case():
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
             for _ in range(3)]
    return leaves, grads


def _jax_optimizer(opt):
    """optax's parameters after the case's three updates."""
    leaves, grads = _optimizer_case()
    jopt = optax.adamw(0.01) if opt == "adamw" else optax.sgd(0.05, momentum=0.9)
    jp = [jnp.asarray(x) for x in leaves]
    state = jopt.init(jp)
    for g in grads:
        updates, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    return [np.asarray(x) for x in jp]


worker.submit(*((_jax_three_steps, opt) for opt in sorted(_OPTS)),
              *((_jax_nested, structure) for structure in sorted(_NESTED)),
              (_jax_optimizer, "adamw"), (_jax_optimizer, "sgd_momentum"))


@pytest.mark.parametrize("opt", ["adamw", "sgd_momentum"])
def test_optimizers_match_optax(opt):
    leaves, grads = _optimizer_case()
    topt = optim.adamw(0.01) if opt == "adamw" else optim.sgd(0.05, momentum=0.9)
    tp = [torch.tensor(x, requires_grad=True) for x in leaves]
    torch_opt = topt.create(tp)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        torch_opt.step()
    for a, b in zip(tp, worker.result(_jax_optimizer, opt)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)


_BANNED = ("jax", "jaxlib", "flax", "optax", "autodist_tpu", "orbax")


def _banned(module):
    return (module.split(".")[0] in _BANNED or module.startswith("google.protobuf")
            or module.split(".")[0] == "yaml")


def test_package_imports_no_jax_protobuf_or_reference_package():
    """Statically: no import statement of the package names a banned root,
    and ``yaml`` only inside a function (read on demand).  Dynamically:
    rank 0 of the gloo world, an interpreter that never imported JAX,
    imports every module of the package, and none of them is then among
    its modules (``tests/torch_gloo_ranks.py::package_imports``)."""
    for module in ranks.package_modules():
        path = os.path.join(REPO, *module.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *module.split("."), "__init__.py")
        tree = ast.parse(open(path).read())
        top_level = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots = [node.module.split(".")[0]]
            else:
                continue
            full = [a.name for a in node.names] if isinstance(node, ast.Import) \
                else [node.module]
            assert not any(_banned(m) for m in full if not m.startswith("yaml")), \
                (path, full)
            assert not ("yaml" in roots and id(node) in top_level), path
    _, results = ranks.world(oracle.world_gpt_params)
    new = results[0]["imports"]
    assert set(ranks.package_modules()) | {"autodist_tpu_torch.models.gpt"} <= set(new)
    assert not [m for m in new if _banned(m)], new


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                 strategy_builder=AllReduce())
    with pytest.raises(ResourceSpecError, match="device='cpu'"):
        ResourceSpec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_capture(tgpt.GPT_TINY, SEQ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classifier_capture(ResNet18(num_classes=10, device="meta"), (32, 32, 3))
    assert ResourceSpec(device="cpu").cpu_devices[0][0] == "localhost:CPU:0"
    assert resolve_device("cpu") == torch.device("cpu")


def test_strategy_json_roundtrip_and_later_slices_raise(tmp_path):
    item = _torch_item(tgpt.GPT_TINY)
    s = AllReduce(chunk_size=4).build(item, ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "gpus": [0, 1], "chief": True}]}))
    path = s.serialize(str(tmp_path / s.id))
    back = Strategy.deserialize(path=path)
    assert back.proto == s.proto and back.id == s.id
    assert back.graph_config.replicas == ["localhost:GPU:0", "localhost:GPU:1"]
    assert back.node_config[-1].WhichOneof("synchronizer") == "AllReduceSynchronizer"
    for field, kwargs in (("compressor", {"compressor": "PowerSGDCompressor"}),
                          ("schedule", {"schedule": "overlap"}),
                          ("hierarchy", {"hierarchy": "two_level"})):
        built = AllReduce(**kwargs).build(item, ResourceSpec(resource_info=CPU_SPEC))
        assert {int(getattr(n.AllReduceSynchronizer, field)) for n in built.node_config} == {
            int(getattr(schema.AllReduceSynchronizer, {"compressor": "PowerSGDCompressor",
                                                       "schedule": "OVERLAP",
                                                       "hierarchy": "TWO_LEVEL"}[field]))}
    loss_fn, params, _ = gpt_capture(dataclasses.replace(tgpt.GPT_TINY, num_layers=1),
                                     SEQ, device="cpu")
    # an async PS selects the async runtime (it raised before that slice)
    sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=PSLoadBalancing(sync=False), device="cpu").distribute(
        loss_fn, params, optim.sgd(0.1))
    assert type(sess).__name__ == "AsyncPSEngineSession" and sess.num_workers == 1
    ad = AutoDist(resource_spec=ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "gpus": [0, 1], "chief": True}]}),
        strategy_builder=AllReduce(), device="cpu")
    with pytest.raises(ValueError, match="2 replicas but this launch has WORLD_SIZE=1"):
        ad.distribute(loss_fn, params, optim.sgd(0.1))
    with pytest.raises(NotImplementedError, match="data_axes"):
        ad.distribute(loss_fn, params, optim.sgd(0.1), data_axes=("replica",))


def test_resource_spec_yaml_matches_dict(tmp_path):
    pytest.importorskip("yaml")
    info = {"nodes": [{"address": "10.0.0.1", "gpus": [0, 1], "chief": True},
                      {"address": "10.0.0.2", "chips": [0, 1]}]}
    path = tmp_path / "spec.yml"
    path.write_text("nodes:\n"
                    "  - address: 10.0.0.1\n    gpus: [0, 1]\n    chief: true\n"
                    "  - address: 10.0.0.2\n    chips: [0, 1]\n")
    a, b = ResourceSpec(str(path)), ResourceSpec(resource_info=info)
    assert [n for n, _ in a.devices] == [n for n, _ in b.devices] == [
        "10.0.0.1:GPU:0", "10.0.0.1:GPU:1", "10.0.0.2:GPU:0", "10.0.0.2:GPU:1"]
    assert a.chief == "10.0.0.1"
    ssh = ResourceSpec(resource_info={"nodes": info["nodes"], "ssh": {"g": {}}})
    assert ssh.ssh_config_map["g"].port == 22 and ssh.ssh_config("10.0.0.1") is None


def test_dropout_streams_follow_seed_and_step():
    """With dropout on, the step generators (folded from seed and step)
    make a run repeat exactly under one seed and differ under another."""
    config = dataclasses.replace(tgpt.GPT_TINY, num_layers=1, dropout_rate=0.5)

    def losses(seed):
        loss_fn, params, _ = gpt_capture(config, SEQ, device="cpu")
        sess = AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                        strategy_builder=AllReduce(), device="cpu").distribute(
            loss_fn, params, optim.sgd(0.0), has_rng=True, rng=seed)
        return [sess.run(_batch())["loss"].item() for _ in range(2)]

    first = losses(0)
    assert losses(0) == first
    assert first[0] != first[1]          # a new stream each step (lr 0)
    assert losses(1) != first
