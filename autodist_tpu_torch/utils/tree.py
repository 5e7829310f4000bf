"""Batches as trees: dicts, tuples, lists and named tuples nested to any
depth, with numpy arrays or tensors at the leaves, as the JAX package's
``jax.tree.map`` walks a batch pytree."""


def map_batch(fn, value, path="batch"):
    """``value`` with every leaf replaced by ``fn(leaf, path)``, in the same
    structure; ``path`` names the leaf (``batch['x'][0]``) for errors."""
    if isinstance(value, dict):
        return type(value)((k, map_batch(fn, v, f"{path}[{k!r}]")) for k, v in value.items())
    if isinstance(value, (tuple, list)):
        leaves = [map_batch(fn, v, f"{path}[{i}]") for i, v in enumerate(value)]
        return type(value)(*leaves) if hasattr(value, "_fields") else type(value)(leaves)
    return fn(value, path)


def batch_leaves(value):
    """The leaves of ``value`` in :func:`map_batch`'s order."""
    leaves = []
    map_batch(lambda leaf, _: leaves.append(leaf), value)
    return leaves
