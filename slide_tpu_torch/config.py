"""Experiment configs in the reference's JSON schema (counterpart:
`slide_tpu/config.py::restore_lists`).  The reference stores lists inside
JSON as their `str()`; `restore_lists` turns them back with
`ast.literal_eval`."""

from __future__ import annotations

import ast
from typing import Any


def _restore(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _restore(v) for k, v in node.items()}
    if isinstance(node, str):
        try:
            v = ast.literal_eval(node)
        except (ValueError, SyntaxError):
            return node
        return v if isinstance(v, list) else node
    return node


def restore_lists(config: dict) -> dict:
    """Recursively convert stringified lists back to lists."""
    return _restore(config)
