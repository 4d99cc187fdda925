"""Parameter trees: nested dicts of tensors, walked in the reference's
order (JAX flattens a dict by its sorted keys), and the string JAX gives
such a tree's structure (``treedef_str``, kept in checkpoint manifests)."""

from __future__ import annotations


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) pairs, dict keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    out = tree_map(lambda _: None, like)
    for path, _ in tree_leaves(like):
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = next(it)
    return out


def treedef_str(tree) -> str:
    """``str(jax.tree.flatten(tree)[1])`` for a tree of nested dicts: keys
    sorted and written with ``repr``, each leaf a ``*`` -- e.g.
    ``PyTreeDef({'o_m': {'x': *}, 'p': {'a': *, 'b': *}})``."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"
