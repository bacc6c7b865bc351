"""Experiment-grid expansion of YAML/JSON configs, and a YAML writer.

The port's own copy of ``medsegpretrainimagenet_tpu/config/grid.py``: inside
a config tree,

* every **list** enumerates alternatives: the config expands into the
  cartesian product over all lists found anywhere in the tree;
* every **tuple** (``!!python/tuple`` in YAML) is a *literal* sequence value
  (its elements still expand element-wise, but the tuple itself is not a
  product axis);
* scalars are literals.

JSON has no tuples, so in a ``.json`` config every array is a grid axis.

PyYAML is imported only to read a ``.yaml`` file.  :func:`dump_yaml` writes
the run directories' ``config.yaml`` and ``source_config.yaml`` without it,
in the form PyYAML's ``full_load`` reads back to the same tree (tuples as
``!!python/tuple``).
"""
from __future__ import annotations

import itertools
import json
import math
from typing import Any, List

__all__ = ["expand_grid", "parse", "dump_yaml"]


def expand_grid(node: Any, *, literal_list: bool = False) -> List[Any]:
    """Return the list of concrete configs encoded by *node*."""
    if isinstance(node, dict):
        keys = list(node.keys())
        alternative_rows = itertools.product(
            *(expand_grid(node[k]) for k in keys))
        return [dict(zip(keys, row)) for row in alternative_rows]
    if isinstance(node, tuple):
        rows = itertools.product(
            *(expand_grid(v, literal_list=True) for v in node))
        return [tuple(row) for row in rows]
    if isinstance(node, list) and not literal_list:
        expanded: List[Any] = []
        for alternative in node:
            expanded.extend(expand_grid(alternative))
        return expanded
    return [node]


def _load(path: str):
    suffix = str(path).rsplit(".", 1)[-1].lower()
    with open(path) as fh:
        if suffix == "json":
            return json.load(fh)
        if suffix in ("yaml", "yml"):
            import yaml
            return yaml.load(fh, Loader=yaml.FullLoader)
    raise ValueError(f"Unknown config extension: {path}")


def parse(path: str):
    """Load a config file and expand it into its experiment grid.

    Returns ``(configs, original)`` where *configs* is the list of concrete
    config dicts and *original* is the raw parsed tree (kept for dumping a
    ``source_config.yaml`` next to each experiment).
    """
    original = _load(path)
    return expand_grid(original), original


# ---------------------------------------------------------------------------
# YAML writer
# ---------------------------------------------------------------------------

def _scalar(value) -> str:
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        value = value.item()  # numpy scalars
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 (PyYAML) reads a float only with a '.' in its mantissa
        if "e" in text and "." not in text:
            text = text.replace("e", ".0e")
        return text
    # a JSON string is a YAML double-quoted scalar
    return json.dumps(str(value))


def _block(value, indent: int) -> List[str]:
    """The lines of a non-empty dict, list or tuple at *indent*."""
    pad = " " * indent
    lines: List[str] = []
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar(str(key))}:"
            if _is_block(item):
                tag = " !!python/tuple" if isinstance(item, tuple) else ""
                lines.append(head + tag)
                # a sequence under a key sits at the key's indent, a mapping
                # one level in
                lines.extend(_block(item, indent if isinstance(
                    item, (list, tuple)) else indent + 2))
            else:
                lines.append(f"{head} {_inline(item)}")
        return lines
    for item in value:
        if _is_block(item):
            tag = "!!python/tuple" if isinstance(item, tuple) else ""
            inner = _block(item, indent + 2)
            if tag:
                lines.append(f"{pad}- {tag}")
                lines.extend(inner)
            else:
                lines.append(f"{pad}- {inner[0].lstrip()}")
                lines.extend(inner[1:])
        else:
            lines.append(f"{pad}- {_inline(item)}")
    return lines


def _is_block(value) -> bool:
    return isinstance(value, (dict, list, tuple)) and len(value) > 0


def _inline(value) -> str:
    """A scalar or an empty collection on one line."""
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, tuple):
        return "!!python/tuple []"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dump_yaml(tree) -> str:
    """*tree* (dicts, lists, tuples, scalars) as block-style YAML text."""
    if _is_block(tree):
        lines = _block(tree, 0)
        if isinstance(tree, tuple):
            lines.insert(0, "!!python/tuple")
        return "\n".join(lines) + "\n"
    return _inline(tree) + "\n"
