"""Declarative partition rules: regex → ``PartitionSpec``, in one table.

A rule table of ``(regex, PartitionSpec)`` pairs is matched against the
'/'-joined tree path of every leaf of a nested dict / NamedTuple / list of
arrays: the first rule whose regex ``re.search``\\ es the path wins, scalars
(and one-element arrays) are never partitioned, and a leaf no rule matches
raises — a new tensor in a sharded program must be placed deliberately,
not silently replicated.

Two tables are the single source of truth of the spec-grid mesh path
(``specgrid.sharded``), both over one mesh axis (default ``"cells"``): the
two stages run one after the other, so the same devices carry firms during
the contraction and specs during the solve.

- ``SPECGRID_PANEL_RULES``, the contraction side: the (T, N) panel tensors
  shard over firms on axis 1, the (U, T, N) universe stack on axis 2; the
  small per-spec selectors and the (T, P) center replicate;
- ``SPECGRID_STATS_RULES``, the solve side: every leaf of
  ``SpecGramStats`` with a leading spec axis (and the per-spec selectors)
  shards over specs; the shared center replicates.

The tables are data: for every leaf name the reference's tables give the
same spec.
"""

from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

import numpy as np

from fm_returnprediction_tpu_torch.parallel.mesh import Mesh, NamedSharding, P, PartitionSpec

__all__ = [
    "match_partition_rules",
    "named_tree_paths",
    "tree_shardings",
    "SPECGRID_PANEL_RULES",
    "SPECGRID_STATS_RULES",
    "specgrid_axis",
    "specgrid_panel_rules",
    "specgrid_stats_rules",
]

#: the one mesh-axis name of the spec-grid path
SPECGRID_AXIS = "cells"


def specgrid_axis() -> str:
    """The spec-grid mesh axis name."""
    return SPECGRID_AXIS


def _children(node: Any):
    """``[(name, child), ...]`` of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if hasattr(node, "_fields"):  # NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def named_tree_paths(tree: Any, sep: str = "/"):
    """``[(path, leaf), ...]`` with dict keys / NamedTuple fields / sequence
    indices joined by ``sep``: the names the rule regexes see."""
    out = []

    def walk(prefix: str, node: Any) -> None:
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for k, v in kids:
            walk(f"{prefix}{sep}{k}" if prefix else k, v)

    walk("", tree)
    return out


def match_partition_rules(rules: Sequence[Tuple[str, PartitionSpec]], tree: Any):
    """The same-structure tree of ``PartitionSpec``\\ s for a tree of arrays
    (rules in order, first hit wins; scalar leaves ``P()``; an unmatched
    leaf raises ``ValueError``)."""

    def get_spec(name: str, leaf: Any) -> PartitionSpec:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"partition rule not found for leaf: {name!r}")

    def rebuild(prefix: str, node: Any):
        kids = _children(node)
        if kids is None:
            return get_spec(prefix, node)
        vals = [rebuild(f"{prefix}/{k}" if prefix else k, v) for k, v in kids]
        if isinstance(node, dict):
            return dict(zip(node.keys(), vals))
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals) if isinstance(node, list) else tuple(vals)

    return rebuild("", tree)


def tree_shardings(mesh: Mesh, rules: Sequence[Tuple[str, PartitionSpec]], tree: Any):
    """``match_partition_rules`` with every spec wrapped in a
    ``NamedSharding`` on ``mesh``."""

    def wrap(node: Any):
        if isinstance(node, PartitionSpec):
            return NamedSharding(mesh, node)
        if isinstance(node, dict):
            return {k: wrap(v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(wrap(v) for v in node))
        vals = [wrap(v) for v in node]
        return vals if isinstance(node, list) else tuple(vals)

    return wrap(match_partition_rules(rules, tree))


def specgrid_panel_rules(axis: str = SPECGRID_AXIS) -> Tuple[Tuple[str, PartitionSpec], ...]:
    """Contraction side (module docstring)."""
    return (
        (r"(^|/)(y|mask|row_weights)$", P(None, axis)),
        (r"(^|/)x$", P(None, axis, None)),
        (r"(^|/)universes$", P(None, None, axis)),
        (r"(^|/)(uidx|col_sel|window|sel_aug|center)$", P()),
    )


def specgrid_stats_rules(axis: str = SPECGRID_AXIS) -> Tuple[Tuple[str, PartitionSpec], ...]:
    """Solve side (module docstring)."""
    return (
        (r"(^|/)(gram|moment|n|ysum|yy)$", P(axis)),
        (r"(^|/)(sel_aug|uidx|col_sel|window)$", P(axis)),
        (r"(^|/)center$", P()),
    )


#: the default-axis instantiations
SPECGRID_PANEL_RULES: Tuple[Tuple[str, PartitionSpec], ...] = specgrid_panel_rules()
SPECGRID_STATS_RULES: Tuple[Tuple[str, PartitionSpec], ...] = specgrid_stats_rules()
