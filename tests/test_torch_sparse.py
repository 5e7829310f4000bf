"""The port's sparse lookups, row-split tables and NCF against the JAX package.

- ``embedding_lookup`` at one replica on 2-D ids with repeats: the rows
  and the table's gradient equal JAX's (the gradient's repeated rows sum
  in another order: atol 1e-6); a :class:`ShardedTable` of one block
  gives the same.
- NeuMF (``models/ncf.py``) at a tiny ``NCFConfig``: flax's variable
  shapes, drawn by numpy and carried across with ``params_from_jax``;
  logits, loss and every gradient against flax's (atol 1e-5; loss 1e-6),
  with and without the session's mask; ``ncf_capture``'s names, shapes
  and sparse variables are JAX's.
- In the 4-rank gloo world (``tests/torch_gloo_ranks.py``), against the
  single-device optax oracles of the JAX tests on the same numpy inputs:
  ``tests/test_end_to_end.py::test_sparse_embedding_all_strategies``
  (Parallax, AllReduce, PS, PartitionedPS; 2 sgd steps; atol 1e-5);
  ``tests/test_sharded_embedding.py``: the value-exact large table (V =
  4100, D = 7; atol 1e-5), ``predict`` on 2-D ids, and no full-size table
  on a rank: no tensor an op made in a step, nor any tensor of the
  session's state, has the table's vocabulary as its dim 0 (the port's
  counterpart of the JAX test's jaxpr walk); tiny NCF under Parallax and
  under PartitionedPS with its four tables split on dim 0: both builders'
  losses equal (1e-5), step 1 within 1e-5 of one process's dense loss and
  the parameters after two adam steps within 1e-5 of flax and optax's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks as ranks
import torch_jax_oracle as oracle
import torch_jax_worker as worker
from autodist_tpu.const import BATCH_MASK_KEY as J_MASK_KEY
from autodist_tpu.models import ncf as jncf
from autodist_tpu.models import train_lib as jtrain
from autodist_tpu.ops.sparse import embedding_lookup as jlookup
from autodist_tpu_torch.const import BATCH_MASK_KEY
from autodist_tpu_torch.models import convert
from autodist_tpu_torch.models import ncf as tncf
from autodist_tpu_torch.models.train_lib import ncf_capture
from autodist_tpu_torch.ops.sparse import ShardedTable, embedding_lookup

TINY = ranks.NCF_TINY


def test_embedding_lookup_matches_jax_at_one_replica():
    r = np.random.RandomState(4)
    table = r.randn(20, 6).astype(np.float32)
    ids = r.randint(0, 20, (5, 7)).astype(np.int32)
    ids[0, :3] = 11   # repeats sum into one row
    up = r.randn(5, 7, 6).astype(np.float32)
    jrows, jvjp = jax.vjp(lambda t: jlookup(t, jnp.asarray(ids)), jnp.asarray(table))
    (jgrad,) = jvjp(jnp.asarray(up))
    for make in (lambda t: t, lambda t: ShardedTable(t, None)):
        t = torch.from_numpy(table.copy()).requires_grad_(True)
        rows = embedding_lookup(make(t), torch.from_numpy(ids))
        (grad,) = torch.autograd.grad(rows, t, torch.from_numpy(up))
        assert rows.shape == (5, 7, 6)
        np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(jrows))
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)
    plain = embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids), sync=False)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jrows))


def _ncf_configs():
    return (jncf.NCFConfig(**TINY), tncf.NCFConfig(**TINY))


def _flax_ncf_params():
    """flax's NeuMF variable shapes, drawn by numpy (tables and kernels of
    unit scale, so every layer carries gradient)."""
    jc, _ = _ncf_configs()
    shapes = jax.eval_shape(lambda: jncf.NeuMF(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))
    r = np.random.RandomState(5)
    return jax.tree.map(lambda s: (0.5 * r.randn(*s.shape)).astype(np.float32),
                        shapes["params"])


def _ncf_batch(seed, n=12):
    r = np.random.RandomState(seed)
    return {"user": r.randint(0, TINY["num_users"], (n,)).astype(np.int32),
            "item": r.randint(0, TINY["num_items"], (n,)).astype(np.int32),
            "label": (r.rand(n) < 0.5).astype(np.float32)}


def _mask_weights():
    return (np.arange(12) % 3 != 0).astype(np.float32)


def _jax_neumf(mask):
    """flax's NeuMF loss, logits and gradient tree (numpy) on ``_ncf_batch(1)``."""
    jc, _ = _ncf_configs()
    jb = {k: jnp.asarray(v) for k, v in _ncf_batch(1).items()}
    if mask:   # the session's per-example weights
        jb[J_MASK_KEY] = jnp.asarray(_mask_weights())
    model = jncf.NeuMF(jc)

    def jloss(p):
        logits = model.apply({"params": p}, jb["user"], jb["item"])
        return jncf.ncf_loss(logits, jb["label"], jb.get(J_MASK_KEY)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_flax_ncf_params())
    return float(jl), np.asarray(jlogits), jax.tree.map(np.asarray, jg)


@pytest.mark.parametrize("mask", [False, True])
def test_neumf_forward_loss_and_gradients_match_flax(mask):
    _, tc = _ncf_configs()
    jparams = _flax_ncf_params()
    batch = _ncf_batch(1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mask:   # the session's per-example weights
        tb[BATCH_MASK_KEY] = torch.from_numpy(_mask_weights())
    jl, jlogits, jg = worker.result(_jax_neumf, mask)
    tmodel = tncf.NeuMF(tc, device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(jparams))
    logits = tmodel(tb["user"], tb["item"])
    loss = tncf.ncf_loss(logits, tb["label"], tb.get(BATCH_MASK_KEY))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6, rtol=0)
    grads, _ = convert.params_to_jax({n: p.grad for n, p in tmodel.named_parameters()})
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    got = jax.tree_util.tree_leaves_with_path(grads)
    assert len(got) == len(want) == 12
    for path, g in got:
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_ncf_capture_names_shapes_and_sparse_vars_match_jax():
    jc, tc = _ncf_configs()
    box = {}

    def capture():
        _, params, box["sparse"] = jtrain.ncf_capture(jc)
        return params

    jshapes = convert.params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                                   jax.eval_shape(capture)))
    _, params, sparse = ncf_capture(tc, device="cpu")
    assert sparse == box["sparse"]
    assert {n: tuple(t.shape) for n, t in params.items()} == {
        convert.torch_to_jax_name(n): tuple(t.shape) for n, t in jshapes.items()}
    full = jax.eval_shape(lambda: jncf.NeuMF(jncf.NCFConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))
    count = sum(t.numel() for t in tncf.NeuMF(tncf.NCFConfig(), device="meta").parameters())
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(full))   # ~31.8 M


# -- the 4-rank gloo world ----------------------------------------------------

def _jax_gpt_params():
    return oracle.world_gpt_params()


ranks.prestart(_jax_gpt_params)   # the ranks run while the tests before them do

@pytest.fixture(scope="module")
def gloo():
    inputs, results = ranks.world(_jax_gpt_params)
    return inputs, [res["partitioned"] for res in results]


def _sgd_oracle(loss, params, batch, steps, lr=0.1):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.grad(loss))
    for _ in range(steps):
        p = jax.tree.map(lambda a, g: a - lr * g, p, grad(p, b))
    return p


def _sparse_loss(p, batch):
    return jnp.mean((jlookup(p["emb"], batch["ids"]) @ p["proj"]) ** 2)


def _jax_sparse(case):
    """numpy parameters of the sgd oracle on the world's sparse case
    (``"sparse"``: SPARSE_STEPS on the small table; ``"table"``: 2 on the
    row-split one)."""
    inputs = oracle.world_inputs()
    if case == "sparse":
        p = _sgd_oracle(_sparse_loss, {"emb": inputs["sparse_table"],
                                       "proj": inputs["sparse_proj"]},
                        {"ids": inputs["sparse_ids"]}, ranks.SPARSE_STEPS)
    else:
        p = _sgd_oracle(_sparse_loss, inputs["table_params"], {"ids": inputs["table_ids"]}, 2)
    return {k: np.asarray(v) for k, v in p.items()}


def _jax_ncf_world():
    """flax and optax on one device: the NCF parameter tree (numpy) after
    NCF_STEPS adam steps on the world's NCF batch and weights."""
    inputs = oracle.world_inputs()
    jc, _ = _ncf_configs()
    jparams, _ = convert.params_to_jax({convert.jax_to_torch_name(n): torch.from_numpy(a.copy())
                                        for n, a in inputs["ncf_params"].items()})
    model = jncf.NeuMF(jc)
    batch = {k: jnp.asarray(v) for k, v in inputs["ncf_batch"].items()}

    def jloss(p):
        return jncf.ncf_loss(model.apply({"params": p}, batch["user"], batch["item"]),
                             batch["label"])

    opt = optax.adam(ranks.NCF_LR)
    p = jax.tree.map(jnp.asarray, jparams)
    st, grad = opt.init(p), jax.jit(jax.grad(jloss))
    for _ in range(ranks.NCF_STEPS):
        u, st = opt.update(grad(p), st, p)
        p = optax.apply_updates(p, u)
    return jax.tree.map(np.asarray, p)


worker.submit((_jax_neumf, False), (_jax_neumf, True), (_jax_sparse, "sparse"),
              (_jax_sparse, "table"), (_jax_ncf_world,))


def _same_on_every_rank(results, key):
    first = results[0][key]
    for res in results[1:]:
        assert res[key]["strategy_id"] == first["strategy_id"], key
        for n, p in res[key]["params"].items():
            assert np.array_equal(p, first["params"][n]), (key, n)
    for res in results:
        assert res[key]["replication"] == [], key


@pytest.mark.parametrize("builder", ranks.SPARSE_BUILDERS)
def test_sparse_embedding_all_strategies_over_four_ranks(gloo, builder):
    _, results = gloo
    want = worker.result(_jax_sparse, "sparse")
    _same_on_every_rank(results, ("sparse", builder))
    got = results[0]["sparse", builder]
    for k in want:
        np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=f"{builder} {k}")
    emb = got["plans"]["emb"][0]
    assert emb == ("sharded" if builder == "PartitionedPS" else "replicated")


def test_sharded_lookup_value_exact_large_over_four_ranks(gloo):
    _, results = gloo
    want = worker.result(_jax_sparse, "table")
    for res in results:
        got = res["table"]
        assert got["step"] == 2
        for k in want:
            np.testing.assert_allclose(got["params"][k], np.asarray(want[k]), atol=1e-5,
                                       err_msg=k)
    assert results[0]["table"]["plans"]["emb"][:3] == ("sharded", 0, ranks.TABLE_PAD_V)


def test_sharded_lookup_2d_ids_over_four_ranks(gloo):
    inputs, results = gloo
    for res in results:
        out = res["table"]["predict"]
        assert out.shape == (8, 5, ranks.TABLE_D)
        np.testing.assert_allclose(out, res["table"]["params"]["emb"][inputs["table_ids_2d"]],
                                   atol=1e-6)


def test_no_full_table_held_by_a_rank(gloo):
    """Each rank stores a block of ``padded V / 4`` rows; no op of a step
    makes, and no state tensor has, a tensor of the table's rows."""
    _, results = gloo
    full = (ranks.TABLE_V, ranks.TABLE_PAD_V)
    for res in results:
        got = res["table"]
        assert got["stored"]["emb"] == (ranks.TABLE_PAD_V // ranks.WORLD, ranks.TABLE_D)
        assert got["step_shapes"], "no op recorded in the step"
        for where in ("step_shapes", "state_shapes"):
            big = [s for s in got[where] if len(s) >= 2 and s[0] in full]
            assert not big, f"{where}: full-table-sized tensors {big}"


def test_ncf_over_four_ranks_matches_one_device(gloo):
    """Tiny NCF under Parallax and under PartitionedPS (tables split on dim
    0): equal losses, step 1 against one process's dense loss, and two
    adam steps against flax and optax on one device."""
    inputs, results = gloo
    _, tc = _ncf_configs()
    loss_fn, _, sparse = ncf_capture(tc, device="cpu")
    tparams = {n: torch.from_numpy(a.copy()) for n, a in inputs["ncf_params"].items()}
    dense = loss_fn(tparams, {k: torch.from_numpy(v) for k, v in inputs["ncf_batch"].items()})
    want = dict(jax.tree_util.tree_leaves_with_path(worker.result(_jax_ncf_world)))
    losses = {}
    for name in ranks.NCF_BUILDERS:
        _same_on_every_rank(results, ("ncf", name))
        got = results[0]["ncf", name]
        losses[name] = got["losses"]
        tables = {n: got["plans"][n][0] for n in sparse}
        assert set(tables.values()) == {"sharded" if name == "PartitionedPS" else "replicated"}
        tree, _ = convert.params_to_jax({convert.jax_to_torch_name(n): torch.from_numpy(a)
                                         for n, a in got["params"].items()})
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            np.testing.assert_allclose(leaf, np.asarray(want[path]), atol=1e-5, rtol=0,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")
    np.testing.assert_allclose(losses["PartitionedPS"], losses["Parallax"], rtol=1e-5)
    np.testing.assert_allclose(losses["Parallax"][0], dense.item(), rtol=1e-5)
