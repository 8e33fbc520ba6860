"""Nested dicts and lists of tensors ("trees"), walked in the JAX
package's order: a dict's keys sorted, a list's items in order.  The
optimizers map over them leaf for leaf, and the checkpointer names each
leaf by its path (``"/"``-joined keys and list indices, the JAX
package's key names).  ``from_numpy`` carries a JAX package tree (numpy
leaves) across as the port's."""
from __future__ import annotations

import numpy as np
import torch


def paths(tree, prefix: tuple = ()):
    """[(path, leaf)], path a tuple of keys and list indices."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def map_(fn, tree, *rest):
    """``fn`` applied leaf by leaf, in ``leaves`` order, to ``tree`` and
    the trees of its structure in ``rest``; the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def from_leaves(template, leaves_: list):
    """A tree of ``template``'s structure holding ``leaves_`` (in
    ``leaves`` order)."""
    it = iter(leaves_)
    return map_(lambda _: next(it), template)


def from_numpy(tree, device, dtype: torch.dtype | None = None):
    """A JAX package parameter tree (leaves as numpy arrays, nested dicts
    and lists) as the port's: the same tree of tensors on ``device``,
    each a copy (never a view of the caller's buffer), floating leaves
    cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t
