"""Nested dict trees (params, moments, partition specs) as flat lists of
``(path, leaf)`` and back; paths join keys with ``/``."""

from __future__ import annotations

from typing import Any


def flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict tree, depth first in insertion
    order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in flatten(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def unflatten(items) -> dict:
    """The nested dict tree of ``(path, leaf)`` items."""
    out: dict = {}
    for path, leaf in items:
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
