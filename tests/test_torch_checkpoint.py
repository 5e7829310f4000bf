"""The port's checkpoints (``autodist_tpu_torch/checkpoint``) and the
session's ``fit`` resume and preemption, against the JAX package.

- The canonical state (``canonical_params``, ``canonical_opt_state``)
  after 2 adam steps of ``PSLoadBalancing``, ``PartitionedPS(max_shards=8)``
  and ``PS(staleness=2)`` against the JAX engine's ``canonicalize_params``
  / ``canonicalize_opt_state`` (no orbax write), the port's
  ``exp_avg``/``exp_avg_sq``/``step`` against optax's ``mu``/``nu``/
  ``count``: ``tests/test_checkpoint.py``'s linear model at R = 1 (here)
  and R = 4 (the 4-rank gloo world's ``checkpoint`` entry, against 4 of
  the conftest's virtual CPU devices), atol 1e-6; the one-block GPT-tiny
  at R = 4, at the tolerance ``tests/test_torch_ps.py::
  test_default_builder_three_steps_match_jax_autodist`` holds the default
  builder's GPT-tiny parameters to (``1e-3`` a step: 2e-3; the moments
  rtol 1e-3).
- The manifest against JAX's ``build_manifest`` for the same spec, builder
  and model (all but ``wall_time`` and ``strategy_id``); ``geometry_matches``
  against itself and, with reasons, across R.
- ``tests/test_checkpoint.py``: the single-device contract (the world's
  R = 4 save read by ``restore_single_device``, unpadded, ``step == 3``; a
  vanilla ``torch.optim.Adam`` loads ``opt_state`` and its next step is
  the session's, atol 1e-6), same-strategy resume bitwise at R = 1 and 4,
  cross-strategy resume (PartitionedPS -> AllReduce, atol 1e-5), a
  restoring session keeping its own learning rate (an optax state has
  none), and the error-feedback sidecar (10 + 10 steps, rtol = atol = 0;
  a sidecar of another bucket layout starts at zero with JAX's warning,
  and a save without codec state removes a stale one).
- ``tests/test_manifest_reshard.py``: the update-space layout restores
  bitwise on its own geometry (R = 1 and 4); an R mismatch without the
  reshard raises naming ``reshard_restore``; a checkpoint without manifest
  does not reshard; the reshard matrix (adam, sgd with momentum x
  replicated, sharded update x flat, two-level on ``{replica_dcn: 2,
  replica_ici: 2}``): the world saves at R = 4, this process restores at
  R = 1, the canonical state bitwise the saved one and the next step a
  vanilla ``torch.optim`` step from it (atol 1e-6); the PS flat shards;
  the grow direction (R = 1 -> 4, in the world); a canonical checkpoint
  through ``reshard_restore``.
- ``tests/test_fit_resume.py``: a crashed ``fit`` resumed equals the
  uninterrupted one bitwise; a fresh ``fit`` with no checkpoint starts at
  step 0 and saves at its end.  SIGTERM from the batches in
  ``run_steps`` and in ``fit`` drains, writes an ``update_space``
  ``<dir>/preempt_ckpt`` at the drained step and sets ``preempted``; a
  run again resumes bitwise.  The guard is inert off the main thread.
- ``reshard_restore(verify=True)`` raises naming Queue A item 11 before
  the state is touched, the serving export naming item 10.
"""
import concurrent.futures
import os
import shutil
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.checkpoint import manifest as jmanifest
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as tstrategy
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.checkpoint import manifest
from autodist_tpu_torch.checkpoint import saver as saver_mod
from autodist_tpu_torch.checkpoint.reshard import reshard_restore
from autodist_tpu_torch.checkpoint.saver import SavedModelBuilder, Saver, load_serving
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import PreemptionGuard

CPU_SPEC = {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
LINEAR_ATOL = 1e-6
GPT_PARAMS_ATOL = ranks.CKPT_STEPS * 1e-3   # test_torch_ps.py: 1e-3 a step under adamw
GPT_MOMENT_RTOL = 1e-3
STEP_ATOL = 1e-6


def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do


@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["checkpoint"] for res in results]


def _tensors(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _linear_loss(p, b):
    return torch.mean((b @ p["w"] + p["b"]) ** 2)


def _linear(builder, opt=None):
    _, params = ranks.linear_inputs()
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC), strategy_builder=builder,
                    device="cpu").distribute(_linear_loss, _tensors(params),
                                             opt or optim.adam(ranks.CKPT_LR))


def _equal(a, b):
    """Bitwise equality of two trees of arrays or tensors."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b, (a, b)


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree


def _torch(tree):
    """``_numpy``'s inverse: a tree of arrays as tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(v) for v in tree)
    return tree


def _canonical(sess):
    t = sess.transformer
    return {"params": _numpy(t.canonical_params(sess.state)),
            "opt": _numpy(t.canonical_opt_state(sess.state))}


# -- the canonical state and the manifest against the JAX engine ---------------------

def _jbuilder(key):
    name, kwargs = ranks.CKPT_BUILDERS[key]
    return getattr(jstrategy, name)(**kwargs)


def _jspec(r, mesh=None):
    info = {"nodes": [{"address": "localhost", "chips": list(range(r))}]}
    if mesh:
        info["mesh"] = mesh
    return JResourceSpec(resource_info=info)


JAX_CASES = [(key, 1, "linear") for key in ranks.CKPT_BUILDERS] + [
    (key, ranks.WORLD, model) for key in ranks.CKPT_BUILDERS for model in ("linear", "gpt")]
_JAX = {}


def _start_jax_runs():
    """Start every JAX case of this file on a thread pool, once: the
    engine's compiles run side by side (XLA compiles outside the
    interpreter's lock) and beside the tests before this file's."""
    if not _JAX:
        pool = concurrent.futures.ThreadPoolExecutor(len(JAX_CASES) + 1)
        _JAX.update({case: pool.submit(_jax_run, *case) for case in JAX_CASES})
        _JAX["two_level"] = pool.submit(_jax_two_level_manifest)
        pool.shutdown(wait=False)   # its threads end with their cases


def _jax_runs():
    _start_jax_runs()
    return {case: f.result() for case, f in _JAX.items()}


def _jax_canonical(key, r, model):
    return _jax_runs()[key, r, model]


def _jax_run(key, r, model):
    """The JAX engine's canonical state and manifest after CKPT_STEPS adam
    steps: the port's names and layout (kernels ``(out, in)``)."""
    if model == "linear":
        batch, params = ranks.linear_inputs()

        def loss(p, b):
            return jnp.mean((b @ p["w"] + p["b"]) ** 2)
        opt, options = optax.adam(ranks.CKPT_LR), {}
    else:
        loss, params = oracle.gpt_capture(oracle.world_gpt(), ranks.GPT_SEQ)
        batch, opt, options = ranks.gpt_batch(), optax.adam(ranks.CKPT_GPT_LR), {"has_rng": True}
    sess = JAutoDist(resource_spec=_jspec(r), strategy_builder=_jbuilder(key)).distribute(
        loss, jax.tree.map(jnp.asarray, params), opt, **options)
    for _ in range(ranks.CKPT_STEPS):
        sess.run(batch)
    t = sess._t
    adam = jax.device_get(t.canonicalize_opt_state(sess.state["opt_state"]))[0]
    trees = {"params": jax.device_get(t.canonicalize_params(sess.state["params"])),
             "mu": adam.mu, "nu": adam.nu}
    if model == "gpt":
        trees = {k: {convert.torch_to_jax_name(n): v.numpy()
                     for n, v in convert.params_from_jax(tree).items()}
                 for k, tree in trees.items()}
    return dict(trees, count=int(adam.count),
                manifest=jmanifest.build_manifest(t, step=ranks.CKPT_STEPS, layout="canonical"))


def _port_r1_canonical(key):
    name, kwargs = ranks.CKPT_BUILDERS[key]
    sess = _linear(getattr(tstrategy, name)(**kwargs))
    batch, _ = ranks.linear_inputs()
    for _ in range(ranks.CKPT_STEPS):
        sess.run(batch)
    return dict(_canonical(sess), manifest=manifest.build_manifest(
        sess.transformer, step=sess.step, layout="canonical"))


@pytest.mark.parametrize("r,model", [(1, "linear"), (4, "linear"), (4, "gpt")])
@pytest.mark.parametrize("key", sorted(ranks.CKPT_BUILDERS))
def test_canonical_state_matches_jax(gloo, key, r, model):
    got = _port_r1_canonical(key) if r == 1 else gloo[1][0]["canonical", key, model]
    want = _jax_canonical(key, r, model)
    atol = LINEAR_ATOL if model == "linear" else GPT_PARAMS_ATOL
    names = sorted(want["params"])
    assert list(got["params"]) == names
    for n in names:
        np.testing.assert_allclose(got["params"][n], want["params"][n], atol=atol, rtol=0,
                                   err_msg=n)
    slots = got["opt"]["state"]
    assert sorted(slots) == list(range(len(names)))
    for i, n in enumerate(names):
        assert float(slots[i]["step"]) == want["count"] == ranks.CKPT_STEPS
        for slot, ref in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            if model == "linear":
                np.testing.assert_allclose(slots[i][slot], want[ref][n], atol=LINEAR_ATOL,
                                           rtol=0, err_msg=(n, slot))
            else:
                np.testing.assert_allclose(slots[i][slot], want[ref][n], rtol=GPT_MOMENT_RTOL,
                                           atol=GPT_MOMENT_RTOL * np.abs(want[ref][n]).max(),
                                           err_msg=(n, slot))
    # a vanilla optimizer over the full parameters in name order takes it
    vanilla = torch.optim.Adam([torch.nn.Parameter(torch.from_numpy(got["params"][n]))
                                for n in names])
    vanilla.load_state_dict(_torch(got["opt"]))


def _without(m):
    return {k: v for k, v in m.items() if k not in ("wall_time", "strategy_id")}


@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("key", sorted(ranks.CKPT_BUILDERS))
def test_manifest_matches_jax(gloo, key, r):
    got = (_port_r1_canonical(key) if r == 1
           else gloo[1][0]["canonical", key, "linear"])["manifest"]
    assert _without(got) == _without(_jax_canonical(key, r, "linear")["manifest"])


def _jax_two_level_manifest():
    _, params = ranks.reshard_inputs()
    sess = JAutoDist(resource_spec=_jspec(ranks.WORLD, ranks.HIER_MESH),
                     strategy_builder=jstrategy.AllReduce(sharded_update="sharded",
                                                          hierarchy="two_level")).distribute(
        lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
        jax.tree.map(jnp.asarray, params), optax.adam(0.05))
    return jmanifest.build_manifest(sess._t, step=ranks.RESHARD_STEPS, layout="update_space")


_start_jax_runs()   # while pytest collects and runs the files before this one


def test_two_level_manifest_matches_jax(gloo):
    got = gloo[1][0]["matrix", "adam", "sharded", "two_level"]["manifest"]
    assert got["layout"] == "update_space" and got["hierarchy"] == "two_level"
    assert _without(got) == _without(_jax_runs()["two_level"])


def test_geometry_matches_itself_and_not_across_r(gloo):
    sess = _linear(tstrategy.PSLoadBalancing())
    t = sess.transformer
    ok, reasons = manifest.geometry_matches(t, manifest.build_manifest(
        t, step=0, layout="update_space"))
    assert ok and reasons == []
    ok, reasons = manifest.geometry_matches(
        t, gloo[1][0]["canonical", "PSLoadBalancing", "linear"]["manifest"])
    assert not ok and "num_replicas 4 != 1" in reasons


# -- tests/test_checkpoint.py ----------------------------------------------------------

def test_save_restore_single_device(gloo):
    inputs, results = gloo
    single = results[0]["single"]
    raw = Saver.restore_single_device(single["path"])
    assert raw["params"]["w"].shape == (12, 3)   # unpadded, the variable's own shape
    assert raw["step"] == 3 and raw["mutable"] is None
    item = {"params": {"w": torch.zeros(12, 3), "b": torch.zeros(3)}, "step": 0}
    w = item["params"]["w"]
    assert Saver.restore_single_device(single["path"], item=item) is item
    assert item["step"] == 3 and item["params"]["w"] is w   # filled in place
    _equal(item["params"], raw["params"])
    for n, v in single["params"].items():
        np.testing.assert_allclose(raw["params"][n].numpy(), v, atol=STEP_ATOL, err_msg=n)
    # a single-device program goes on training from it
    names = sorted(raw["params"])
    params = [torch.nn.Parameter(raw["params"][n].clone()) for n in names]
    opt = torch.optim.Adam(params, lr=ranks.CKPT_LR)
    opt.load_state_dict(raw["opt_state"])
    _linear_loss(dict(zip(names, params)), torch.from_numpy(inputs["linear_batch"])).backward()
    opt.step()
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.detach().numpy(), single["next"][n], atol=STEP_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("r", [1, 4])
def test_resume_same_strategy_bitexact(gloo, tmp_path, r):
    if r == 4:
        res = gloo[1][0]["resume"]
        got, want, step = res["got"], res["want"], res["step"]
    else:
        batch, _ = ranks.linear_inputs()
        sess = _linear(tstrategy.PS())
        for _ in range(2):
            sess.run(batch)
        path = Saver(sess).save(str(tmp_path / "c1"))
        sess.run(batch)
        sess2 = _linear(tstrategy.PS())
        Saver(sess2).restore(path)
        step = sess2.step
        sess2.run(batch)
        got, want = sess2.params(), sess.params()
    assert step == 2
    _equal(got, want)


@pytest.mark.parametrize("save", ["save", "save_sharded"])
def test_restore_keeps_the_session_hyperparameters(tmp_path, save):
    """An optax state carries no learning rate: the restoring session
    keeps its own, as JAX's does."""
    sess = _linear(tstrategy.PS())
    sess.run(ranks.linear_inputs()[0])
    path = getattr(Saver(sess), save)(str(tmp_path / "h"))
    other = _linear(tstrategy.PS(), optim.adam(0.01))
    Saver(other).restore(path)
    assert other.step == 1
    assert other.state["opt_state"].param_groups[0]["lr"] == 0.01
    _equal(_numpy(other.params()), _numpy(sess.params()))


def test_cross_strategy_resume(gloo):
    """A PartitionedPS checkpoint resumes under AllReduce and goes on as
    the PartitionedPS session does (R = 4)."""
    for res in gloo[1]:
        for n, v in res["cross"]["want"].items():
            np.testing.assert_allclose(res["cross"]["got"][n], v, atol=1e-5, err_msg=n)


def _ef_session(**kwargs):
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC), strategy_builder=(
        tstrategy.AllReduce(compressor="HorovodCompressorEF", **kwargs)), device="cpu"
    ).distribute(lambda p, b: torch.mean(b @ p["w"]) + torch.mean(b[:, :16] @ p["v"]),
                 {"w": torch.zeros(32), "v": torch.zeros(16)}, optim.sgd(0.01))


EF_BATCH = np.full((8, 32), 1.0 + 2 ** -10, np.float32)   # not representable in bf16


def test_ef_residuals_survive_resume(tmp_path):
    sess = _ef_session()
    for _ in range(10):
        sess.run(EF_BATCH)
    path = Saver(sess).save(str(tmp_path / "ef"))
    assert os.path.isdir(path + ".comp")
    for _ in range(10):
        sess.run(EF_BATCH)
    uninterrupted = sess.params()
    sess2 = _ef_session()
    Saver(sess2).restore(path)
    # the residuals come back as saved, not reset to zero
    residuals = [v for v in sess2.state["comp"].values() if isinstance(v, torch.Tensor)]
    assert residuals and any(float(v.abs().max()) > 0 for v in residuals)
    for _ in range(10):
        sess2.run(EF_BATCH)
    for n, v in uninterrupted.items():
        np.testing.assert_allclose(sess2.params()[n], v, atol=0, rtol=0, err_msg=n)


def test_codec_sidecar_layout_mismatch_resets_and_stale_one_goes(tmp_path, monkeypatch):
    warned = []
    monkeypatch.setattr(saver_mod.logging, "warning", lambda msg, *a: warned.append(msg % a))
    sess = _ef_session()
    for _ in range(2):
        sess.run(EF_BATCH)
    path = Saver(sess).save(str(tmp_path / "ef"))
    other = _ef_session(chunk_size=1)   # a bucket a variable: another residual layout
    assert len(other.transformer.buckets) != len(sess.transformer.buckets)
    Saver(other).restore(path)
    assert other.step == 2 and any("does not match this strategy's bucket layout" in w
                                   for w in warned)
    assert all(float(v.abs().max()) == 0 for v in other.state["comp"].values()
               if isinstance(v, torch.Tensor))
    stateless = _linear(tstrategy.AllReduce())
    Saver(stateless).save(path)   # no codec state: the stale sidecar goes
    assert not os.path.exists(path + ".comp")


# -- tests/test_manifest_reshard.py ----------------------------------------------------

@pytest.mark.parametrize("r", [1, 4])
def test_update_space_same_geometry_resume_bitwise(gloo, tmp_path, r):
    if r == 4:
        for res in gloo[1]:
            same = res["same"]
            assert same["step"] == 3
            _equal(same["restored"], same["saved"])
            _equal(same["got"], same["want"])
        return
    batch, _ = ranks.linear_inputs()
    sess = _linear(tstrategy.AllReduce(sharded_update="sharded"))
    for _ in range(3):
        sess.run(batch)
    path = Saver(sess).save_sharded(str(tmp_path / "u"))
    assert manifest.load_manifest(path)["layout"] == "update_space"
    saved = _numpy({"params": sess.state["params"], "shards": sess.state["shards"],
                    "opt": sess.state["opt_state"].state_dict()["state"]})
    sess.run(batch)
    sess2 = _linear(tstrategy.AllReduce(sharded_update="sharded"))
    Saver(sess2).restore(path)
    assert sess2.step == 3
    _equal(_numpy({"params": sess2.state["params"], "shards": sess2.state["shards"],
                   "opt": sess2.state["opt_state"].state_dict()["state"]}), saved)
    sess2.run(batch)
    _equal(sess2.params(), sess.params())


def test_mismatched_r_without_reshard_raises(gloo):
    sess = _linear(tstrategy.AllReduce(sharded_update="sharded"))
    with pytest.raises(ValueError) as e:
        Saver(sess).restore(gloo[1][0]["same"]["path"])
    assert "reshard_restore" in str(e.value) and "num_replicas 4 != 1" in str(e.value)
    assert sess.step == 0


def test_reshard_requires_manifest(tmp_path):
    sess = _linear(tstrategy.AllReduce(sharded_update="sharded"))
    sess.run(ranks.linear_inputs()[0])
    path = Saver(sess).save_sharded(str(tmp_path / "n"))
    os.remove(manifest.manifest_path(path))
    with pytest.raises(FileNotFoundError, match="manifest"):
        reshard_restore(_linear(tstrategy.AllReduce()), path, verify=False)


def _reshard_loss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _reshard_session(builder, opt):
    _, params = ranks.reshard_inputs()
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC), strategy_builder=builder,
                    device="cpu").distribute(_reshard_loss, _tensors(params), opt)


def _vanilla_step(canonical, opt):
    """One step of a plain ``torch.optim`` optimizer over the canonical
    parameters and optimizer state, on the whole batch."""
    batch, _ = ranks.reshard_inputs()
    names = sorted(canonical["params"])
    params = [torch.nn.Parameter(torch.from_numpy(canonical["params"][n].copy())) for n in names]
    vanilla = (torch.optim.Adam(params) if opt == "adam"
               else torch.optim.SGD(params, lr=0.1, momentum=0.9))
    vanilla.load_state_dict(_torch(canonical["opt"]))
    _reshard_loss(dict(zip(names, params)), _tensors(batch)).backward()
    vanilla.step()
    return {n: p.detach().numpy() for n, p in zip(names, params)}


@pytest.mark.parametrize("hierarchy", ranks.RESHARD_HIERARCHIES)
@pytest.mark.parametrize("update", ranks.RESHARD_UPDATES)
@pytest.mark.parametrize("opt", ranks.RESHARD_OPTS)
def test_reshard_matrix(gloo, opt, update, hierarchy):
    """R = 4 (flat or replica_dcn x replica_ici) -> R = 1: the canonical
    parameters and optimizer state bitwise the saved ones (the re-layout
    moves bytes, no arithmetic), and the next step a vanilla optimizer's
    from them."""
    saved = gloo[1][0]["matrix", opt, update, hierarchy]
    assert saved["hierarchy"] == ("two_level" if hierarchy == "two_level" else "flat")
    sess = _reshard_session(tstrategy.AllReduce(sharded_update=update),
                            ranks.reshard_optimizer(opt))
    assert reshard_restore(sess, saved["path"], verify=False) is None
    assert sess.step == ranks.RESHARD_STEPS
    got = _canonical(sess)
    _equal(got["params"], saved["params"])
    _equal(got["opt"]["state"], saved["opt"]["state"])
    want = _vanilla_step(saved, opt)
    sess.run(ranks.reshard_inputs()[0])
    for n, v in sess.params().items():
        np.testing.assert_allclose(v.numpy(), want[n], atol=STEP_ATOL, rtol=0, err_msg=n)


def test_ps_flat_shard_reshard(gloo):
    saved = gloo[1][0]["ps_flat"]
    sess = _reshard_session(tstrategy.PS(), optim.adam(ranks.CKPT_LR))
    reshard_restore(sess, saved["path"], verify=False)
    assert sess.step == 2
    _equal(_numpy(sess.params()), saved["params"])


def test_reshard_grow_back(gloo):
    """R = 1 -> R = 4: every rank's canonical state bitwise the saved one."""
    saved = gloo[1][0]["grow_saved"]
    for res in gloo[1]:
        assert res["grow"]["step"] == 2
        _equal(res["grow"]["params"], saved["params"])
        _equal(res["grow"]["opt"]["state"], saved["opt"]["state"])


def test_reshard_canonical_checkpoint_dispatches_to_saver(gloo):
    single = gloo[1][0]["single"]
    sess = _linear(tstrategy.AllReduce())
    reshard_restore(sess, single["path"], verify=False)
    assert sess.step == 3
    _equal(_numpy(sess.params()), single["params"])


# -- tests/test_fit_resume.py and preemption -------------------------------------------

def _fit_session(builder=None):
    return AutoDist(resource_spec=ResourceSpec(resource_info=CPU_SPEC),
                    strategy_builder=builder or tstrategy.AllReduce(), device="cpu").distribute(
        lambda p, b: torch.mean((b @ p["w"]) ** 2), {"w": torch.ones(6)}, optim.sgd(0.05))


def _batch_fn(step):
    return np.random.RandomState(step).randn(16, 6).astype(np.float32)


def test_fit_crash_resume_equals_uninterrupted(tmp_path):
    ckpt = str(tmp_path / "fit_ckpt")
    ref = _fit_session()
    ref.fit(_batch_fn, steps=7)

    def crashing(step):
        if step == 5:
            raise RuntimeError("induced preemption")
        return _batch_fn(step)

    s1 = _fit_session()
    with pytest.raises(RuntimeError, match="induced preemption"):
        s1.fit(crashing, steps=7, checkpoint_path=ckpt, save_every=2)
    assert s1.step == 5   # 5 steps done; the step-5 batch raised
    assert manifest.load_manifest(ckpt)["step"] == 4
    s2 = _fit_session()
    m = s2.fit(_batch_fn, steps=7, checkpoint_path=ckpt, save_every=2)
    assert s2.step == 7 and np.isfinite(float(m["loss"]))
    _equal(s2.params(), ref.params())


def test_fit_fresh_no_checkpoint(tmp_path):
    s = _fit_session(tstrategy.PS())
    m = s.fit(_batch_fn, steps=3, checkpoint_path=str(tmp_path / "c"), save_every=10)
    assert s.step == 3 and np.isfinite(float(m["loss"]))
    s2 = _fit_session(tstrategy.PS())   # the final save happened: restored at 3, no step
    assert s2.fit(_batch_fn, steps=3, checkpoint_path=str(tmp_path / "c")) is None
    assert s2.step == 3


@pytest.mark.parametrize("loop", ["run_steps", "fit"])
def test_sigterm_drains_checkpoints_and_resumes(tmp_path, loop):
    ref = _fit_session(tstrategy.PS())
    ref.fit(_batch_fn, steps=6)

    def batches(step):   # SIGTERM to this process before step 4's batch
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return _batch_fn(step)

    before = signal.getsignal(signal.SIGTERM)
    s1 = _fit_session(tstrategy.PS())
    if loop == "fit":
        s1.fit(batches, steps=6, preempt_checkpoint_dir=str(tmp_path))
    else:
        s1.run_steps((batches(i) for i in range(6)), preempt_checkpoint_dir=str(tmp_path))
    assert signal.getsignal(signal.SIGTERM) is before   # the guard gave the handler back
    assert s1.preempted and s1.step == 4   # the step in flight drained
    m = manifest.load_manifest(os.path.join(tmp_path, "preempt_ckpt"))
    assert m["layout"] == "update_space" and m["step"] == 4
    s2 = _fit_session(tstrategy.PS())
    s2.fit(_batch_fn, steps=6, preempt_checkpoint_dir=str(tmp_path))
    assert s2.step == 6 and not s2.preempted
    _equal(s2.params(), ref.params())


def test_preemption_guard_is_inert_off_the_main_thread():
    seen = {}

    def body():
        before = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as guard:
            seen["handler"] = signal.getsignal(signal.SIGTERM) is before
            seen["requested"] = guard.requested

    thread = threading.Thread(target=body)
    thread.start()
    thread.join(timeout=10)
    assert seen == {"handler": True, "requested": False}


# -- what later slices port ------------------------------------------------------------

def test_reshard_verify_raises_naming_item_11_before_touching_state(tmp_path):
    sess = _linear(tstrategy.AllReduce())
    sess.run(ranks.linear_inputs()[0])
    path = Saver(sess).save_sharded(str(tmp_path / "v"))
    fresh = _linear(tstrategy.PSLoadBalancing())
    before = _numpy(fresh.params())
    with pytest.raises(NotImplementedError, match="item 11"):
        reshard_restore(fresh, path)
    assert fresh.step == 0
    _equal(_numpy(fresh.params()), before)
    shutil.rmtree(path)   # verify=True raises before it reads: no checkpoint needed
    with pytest.raises(NotImplementedError, match="item 11"):
        reshard_restore(fresh, path, verify=True)


def test_serving_export_names_item_10(tmp_path):
    sess = _linear(tstrategy.AllReduce())
    with pytest.raises(NotImplementedError, match="item 10"):
        SavedModelBuilder(sess).save(str(tmp_path / "export"))
    with pytest.raises(NotImplementedError, match="item 10"):
        load_serving(str(tmp_path / "export"))
    with pytest.raises(ValueError, match="etils is unavailable"):
        Saver.exists("gs://bucket/ckpt")
