"""Nested dicts of tensors: the port's parameter and optimizer-state
trees, the reference's pytrees. ``None`` leaves stay ``None``."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def leaves(tree):
    """The leaves of ``tree`` in order, ``None`` leaves skipped."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif tree is not None:
        yield tree


def flat_params(tree, prefix=""):
    """``{"a/b/c": leaf}`` for a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest_params(flat):
    """The inverse of ``flat_params``."""
    root = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root
