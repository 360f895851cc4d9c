"""Nested-dict trees of tensors: the port's counterpart of ``jax.tree_util``.

Parameters, gradients and optimizer state are nested ``dict``s of tensors; a
decode state also holds a ``list`` (the hybrid's un-stacked tail layers).
Leaves are visited in sorted key order, as JAX flattens dicts, and lists in
index order, so leaf order (and every sum taken over leaves) matches the JAX
package, and ``keystr`` gives JAX's path strings
(``"['blocks']['attn_wq']"``, ``"['tail'][0]['h']"``), the residue keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple, Union

import torch

__all__ = ["keystr", "flatten_with_path", "leaves", "unflatten", "tree_map", "zeros_like"]

Tree = Any


def keystr(keys: Tuple[Union[str, int], ...]) -> str:
    """``('blocks', 'attn_wq')`` -> ``"['blocks']['attn_wq']"``, ``('tail', 0)`` ->
    ``"['tail'][0]"``, as jax.tree_util.keystr."""
    return "".join(f"[{k!r}]" for k in keys)


def _walk(tree: Tree, prefix: Tuple[str, ...], out: List):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], prefix + (k,), out)
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            _walk(t, prefix + (i,), out)
    else:
        out.append((prefix, tree))


def flatten_with_path(tree: Tree) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's leaf order (dict keys sorted, lists in order)."""
    out: List = []
    _walk(tree, (), out)
    return [(keystr(p), leaf) for p, leaf in out]


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Tree, new_leaves: List[Any]) -> Tree:
    """A tree shaped like ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def zeros_like(tree: Dict) -> Dict:
    return tree_map(torch.zeros_like, tree)
