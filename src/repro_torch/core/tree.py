"""Pytree-path utilities for the DFQ plan executor (port of
``repro.core.tree``).

Paths are tuples of dict keys. Transforms are functional: ``set_path``
returns a new nested dict that shares every subtree it did not modify.
"""
from __future__ import annotations

from typing import Any, Mapping

Path = tuple


def get_path(tree: Mapping, path: Path) -> Any:
    node = tree
    for key in path:
        node = node[key]
    return node


def has_path(tree: Mapping, path: Path) -> bool:
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            return False
        node = node[key]
    return True


def set_path(tree: Mapping, path: Path, value: Any) -> dict:
    """Functionally set ``tree[path] = value`` (dicts copied along the path,
    leaves shared)."""
    if not path:
        raise ValueError("empty path")
    new = dict(tree)
    key = path[0]
    if len(path) == 1:
        new[key] = value
    else:
        new[key] = set_path(new.get(key, {}), path[1:], value)
    return new
