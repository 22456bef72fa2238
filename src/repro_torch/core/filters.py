"""Filtered search: per-row metadata attributes + predicate objects
(DESIGN.md §11).

Real deployments multiplex many workloads over one index: recsys queries
constrained to a category, RAG queries constrained to a tenant's corpus,
freshness windows over an ingest timestamp.  The paper's pipeline has a
natural place to honor such constraints *cheaply*: candidate collection
(stages ②③⑤) already materializes explicit id lists before the ADC scan,
so a row mask applied THERE shrinks the scan itself — selectivity reduces
work — instead of discarding rows after top-k (which silently degrades
recall for selective predicates).

Two pieces, both purely functional:

* :class:`AttributeTable` — named small-int/categorical columns (e.g.
  ``category``/``tenant``/``timestamp``), one value per row, carried
  through every tier: the sealed segment (ID-space, survives compaction
  and snapshots) and the delta segment (appended alongside vectors).
  Missing values are :data:`UNSET` (``-1``) and NEVER match a predicate
  — fail-closed, which is what makes tenant base predicates an isolation
  boundary rather than a convention.
* Predicates — hashable frozen dataclasses :class:`Eq` / :class:`In` /
  :class:`Range` / :class:`And`, compiled against a table to a boolean
  row mask by :meth:`Predicate.mask`.  Hashability is load-bearing: the
  predicate folds into coalescing keys (``serve/client.coalesce_key``)
  so a filtered request can never attach to an unfiltered leader.
  ``predicate_to_json``/``predicate_from_json`` round-trip the grammar
  over the HTTP edge.

Attribute values are conventionally non-negative ints; categorical
string attributes are dictionary-encoded by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["UNSET", "AttributeTable", "Predicate", "Eq", "In", "Range",
           "And", "combine", "predicate_to_json", "predicate_from_json"]

#: Sentinel for "this row has no value in this column".  Rows whose
#: column is UNSET never match any predicate over that column.
UNSET = -1


# ---------------------------------------------------------------------------
# Attribute store
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttributeTable:
    """Columnar per-row metadata, snapshotted functionally like
    :class:`~repro_torch.core.segments.DeltaSegment`: every mutation returns a
    NEW table, so a published :class:`~repro_torch.core.segments.IndexView`
    holds attributes that can never change under its readers.

    A column absent from ``columns`` reads as all-:data:`UNSET`, so
    tables built before a column existed keep working (and keep failing
    closed) when new ingest starts carrying it.
    """

    n: int
    columns: Mapping[str, np.ndarray] = \
        dataclasses.field(default_factory=dict)

    @staticmethod
    def _as_col(values, n: int) -> np.ndarray:
        col = np.asarray(values, np.int64)
        if col.shape != (n,):
            raise ValueError(
                f"attribute column must be shape ({n},), got {col.shape}")
        return col

    @classmethod
    def empty(cls, n: int) -> "AttributeTable":
        return cls(n=int(n), columns={})

    @classmethod
    def from_columns(cls, n: int,
                     values: Optional[Mapping[str, Sequence[int]]]
                     ) -> "AttributeTable":
        if not values:
            return cls.empty(n)
        return cls(n=int(n), columns={
            str(name): cls._as_col(col, int(n))
            for name, col in values.items()})

    def lookup(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Column values at ``rows``; all-:data:`UNSET` for a column this
        table has never seen (fail-closed)."""
        rows = np.asarray(rows, np.int64)
        col = self.columns.get(name)
        if col is None:
            return np.full(rows.shape, UNSET, np.int64)
        return col[rows]

    def append(self, count: int,
               values: Optional[Mapping[str, Sequence[int]]] = None
               ) -> "AttributeTable":
        """``count`` new rows; ``values`` maps column -> per-row ints.
        Columns absent on either side backfill with :data:`UNSET`."""
        count = int(count)
        new = {str(k): self._as_col(v, count)
               for k, v in (values or {}).items()}
        cols: Dict[str, np.ndarray] = {}
        for name in set(self.columns) | set(new):
            old_col = self.columns.get(
                name, np.full(self.n, UNSET, np.int64))
            new_col = new.get(name, np.full(count, UNSET, np.int64))
            cols[name] = np.concatenate([old_col, new_col])
        return AttributeTable(n=self.n + count, columns=cols)

    def extend(self, other: "AttributeTable") -> "AttributeTable":
        """Concatenate another table's rows after this one's (compaction:
        sealed attrs + the sealed delta prefix's attrs)."""
        return self.append(other.n, {name: other.lookup(name,
                                                        np.arange(other.n))
                                     for name in other.columns})

    def head(self, count: int) -> "AttributeTable":
        return AttributeTable(
            n=int(count),
            columns={k: v[:count] for k, v in self.columns.items()})

    def drop_prefix(self, count: int) -> "AttributeTable":
        return AttributeTable(
            n=self.n - int(count),
            columns={k: v[count:] for k, v in self.columns.items()})


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------

class Predicate:
    """Base class; concrete predicates are hashable frozen dataclasses."""

    def mask(self, attrs: AttributeTable, rows: np.ndarray) -> np.ndarray:
        """Boolean mask over ``rows`` (row indices into ``attrs``)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Eq(Predicate):
    column: str
    value: int

    def mask(self, attrs: AttributeTable, rows: np.ndarray) -> np.ndarray:
        vals = attrs.lookup(self.column, rows)
        return (vals != UNSET) & (vals == int(self.value))


@dataclasses.dataclass(frozen=True)
class In(Predicate):
    column: str
    values: Tuple[int, ...]

    def __post_init__(self):
        # canonical sorted-unique tuple: In("c", (2, 1, 2)) == In("c",
        # (1, 2)) — equal predicates must coalesce to equal keys
        object.__setattr__(
            self, "values", tuple(sorted({int(v) for v in self.values})))

    def mask(self, attrs: AttributeTable, rows: np.ndarray) -> np.ndarray:
        vals = attrs.lookup(self.column, rows)
        return (vals != UNSET) & np.isin(
            vals, np.asarray(self.values, np.int64))


@dataclasses.dataclass(frozen=True)
class Range(Predicate):
    """Half-open interval ``lo <= value < hi``."""

    column: str
    lo: int
    hi: int

    def mask(self, attrs: AttributeTable, rows: np.ndarray) -> np.ndarray:
        vals = attrs.lookup(self.column, rows)
        return (vals != UNSET) & (vals >= int(self.lo)) \
            & (vals < int(self.hi))


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    children: Tuple[Predicate, ...]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))

    def mask(self, attrs: AttributeTable, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        out = np.ones(rows.shape, bool)
        for child in self.children:
            out &= child.mask(attrs, rows)
        return out


def combine(a: Optional[Predicate],
            b: Optional[Predicate]) -> Optional[Predicate]:
    """Conjunction with ``None`` = no constraint.  The tenant layer uses
    this to stamp a base predicate UNDER a request's own filter — the
    request can only ever narrow its tenant's view, never widen it."""
    if a is None:
        return b
    if b is None:
        return a
    return And((a, b))


# ---------------------------------------------------------------------------
# Wire form (HTTP edge)
# ---------------------------------------------------------------------------

def predicate_to_json(p: Optional[Predicate]):
    """``{"eq": [col, v]}`` / ``{"in": [col, [...]]}`` /
    ``{"range": [col, lo, hi]}`` / ``{"and": [...]}``."""
    if p is None:
        return None
    if isinstance(p, Eq):
        return {"eq": [p.column, int(p.value)]}
    if isinstance(p, In):
        return {"in": [p.column, [int(v) for v in p.values]]}
    if isinstance(p, Range):
        return {"range": [p.column, int(p.lo), int(p.hi)]}
    if isinstance(p, And):
        return {"and": [predicate_to_json(c) for c in p.children]}
    raise TypeError(f"not a predicate: {type(p).__name__}")


def predicate_from_json(doc) -> Optional[Predicate]:
    if doc is None:
        return None
    if not isinstance(doc, dict) or len(doc) != 1:
        raise ValueError(
            "predicate must be a one-key object: eq/in/range/and")
    (kind, spec), = doc.items()
    try:
        if kind == "eq":
            col, value = spec
            return Eq(str(col), int(value))
        if kind == "in":
            col, values = spec
            return In(str(col), tuple(int(v) for v in values))
        if kind == "range":
            col, lo, hi = spec
            return Range(str(col), int(lo), int(hi))
        if kind == "and":
            kids = tuple(predicate_from_json(c) for c in spec)
            if any(k is None for k in kids):
                raise ValueError("null child")
            return And(kids)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"malformed {kind!r} predicate: {exc}") from None
    raise ValueError(f"unknown predicate kind {kind!r}")
