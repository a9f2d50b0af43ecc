"""Trees of tensors in the JAX package's pytree order.

The port's parameter, optimizer and checkpoint trees are nested dicts,
tuples, lists and named tuples of tensors, as the reference's pytrees are.
These helpers walk them in ``jax.tree_util``'s order (dict keys sorted,
sequences and named-tuple fields in order, ``None`` an empty subtree) and
name each leaf as ``jax.tree_util.keystr`` does (``['blocks'][0]['wq']``,
``.field`` for a named tuple), so sums over leaves group as the
reference's do and checkpoint keys are the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``
    order, each path as ``keystr`` writes it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_path(getattr(tree, f),
                                            f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in :func:`leaves`
    order) in place of its leaves; dicts keep the template's key order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest``,
    which must have ``tree``'s paths."""
    flat = flatten_with_path(tree)
    paths = [p for p, _ in flat]
    others = []
    for r in rest:
        fr = flatten_with_path(r)
        if [p for p, _ in fr] != paths:
            raise ValueError("trees differ in structure")
        others.append([leaf for _, leaf in fr])
    return unflatten(tree, [fn(leaf, *xs) for (_, leaf), *xs
                            in zip(flat, *others)])
