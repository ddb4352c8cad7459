"""Flax-layout parameter trees by path: nested dicts (and lists) of leaves
↔ one dict keyed by '/'-joined paths (a list's items under their index)."""

from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict[str, object]:
    """{"a": {"b": [x, y]}} → {"a/b/0": x, "a/b/1": y}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _lists(tree):
    """Dicts keyed "0" … "n-1" back into lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists(v) for k, v in tree.items()}
    if tree and sorted(tree) == sorted(map(str, range(len(tree)))):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def unflatten(leaves: dict) -> dict:
    """{"a/b/c": leaf} → {"a": {"b": {"c": leaf}}}; "a/0/c" → {"a": [{"c": leaf}]}."""
    out: dict = {}
    for path, v in leaves.items():
        *head, leaf = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[leaf] = v
    return _lists(out)
