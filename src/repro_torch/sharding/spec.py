"""Logical sharding rules mapped onto a mesh's axes, and the stages that
run a function shard by shard (the port's counterpart of
``repro.sharding.spec``).

The framework uses a 2-D single-pod mesh ``("data", "model")`` and a 3-D
multi-pod mesh ``("pod", "data", "model")``.  Code never names mesh axes
directly; it asks the active :class:`Rules` for a logical axis:

  * ``batch``  — data parallel (pod x data on multi-pod meshes)
  * ``fsdp``   — weight sharding axis #1 (the "data" axis)
  * ``tensor`` — weight sharding axis #2 / sequence parallel axis ("model")
  * ``expert`` — expert parallel axis (aliases "tensor")
  * ``corpus`` — ANNS corpus row shards (all axes; the paper's pinned-HBM
    tier)

:class:`ShardCtx` (a mesh and its rules, ``mesh=None`` meaning one
device) lives here; the JAX package keeps it in ``models/layers.py``.

One process drives every logical device of a ``launch.mesh.Mesh``, as
JAX's single controller does.  A JAX ``shard_map`` region becomes
explicit stages: :func:`shard_split` cuts each input into the block each
logical id holds (placed on that id's device), a stage runs once per id
(:func:`shard_map` for a body with no collective inside), the collective
between two stages is a fixed order of copies (:func:`all_to_all`,
:func:`psum`, :func:`all_gather`: shards summed or concatenated in
shard order), and :func:`shard_merge` puts the outputs back together on
the mesh's first device.  Every step is a differentiable torch op
(``narrow``, ``.to``, ``cat``, ``+``), so autograd gives the sharded
function's gradient.

Outside those regions a tensor stays whole on the mesh's first device:
:func:`constrain` (XLA's placement hint, which changes no value) checks
the spec against the mesh and moves nothing else.  :class:`NamedSharding`
is a mesh and a spec: the placement the tree of a cell's arguments
records (``models.api``), its per-device block shape
(:meth:`NamedSharding.shard_shape`, what ``launch.dryrun`` counts) and
the device a leaf lives on (the mesh's first).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[None, str, Tuple[str, ...]]
Parts = Dict[int, torch.Tensor]


def axes_tuple(axes: Axis) -> Tuple[str, ...]:
    """A logical axis as a tuple of mesh axis names (``None`` -> ())."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class PartitionSpec(tuple):
    """The mesh axes of each dimension of an array (None: not split), as
    ``jax.sharding.PartitionSpec``: a tuple whose one-axis tuples read as
    the axis name.  A leaf of a tree (``repro_torch.tree``), not a node."""

    _tree_leaf = True

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else
            (tuple(a) if isinstance(a, list) else a) for a in axes))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical -> mesh axis mapping."""

    batch: Axis = "data"
    fsdp: Axis = "data"
    tensor: Axis = "model"
    expert: Axis = "model"
    corpus: Axis = ("data", "model")

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """The PartitionSpec of dimensions named by logical axes (None =
        replicated)."""
        return P(*(None if name is None else getattr(self, name)
                   for name in logical))


SINGLE_POD_RULES = Rules(
    batch="data",
    fsdp="data",
    tensor="model",
    expert="model",
    corpus=("data", "model"),
)

MULTI_POD_RULES = Rules(
    batch=("pod", "data"),
    fsdp="data",
    tensor="model",
    expert="model",
    corpus=("pod", "data", "model"),
)


def rules_for_mesh(mesh) -> Rules:
    return MULTI_POD_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES


# ---------------------------------------------------------------------------
# Specs on a mesh
# ---------------------------------------------------------------------------

def _checked(mesh, spec, ndim: int) -> Tuple[Axis, ...]:
    """``spec`` padded with None to ``ndim`` entries, after checking that
    it names only the mesh's axes, each at most once, in at most ``ndim``
    entries (``ValueError`` otherwise, as JAX refuses such a spec)."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {P(*spec)} has {len(spec)} entries for a "
                         f"{ndim}-D array")
    used = [a for e in spec for a in axes_tuple(e)]
    for a in used:
        if a not in mesh.axis_names:
            raise ValueError(f"spec {P(*spec)} names {a!r}, not an axis of "
                             f"the mesh {tuple(mesh.axis_names)}")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {P(*spec)} names a mesh axis twice")
    return spec + (None,) * (ndim - len(spec))


def _count(mesh, entry: Axis) -> int:
    """Blocks of a dimension split over ``entry``'s mesh axes."""
    return math.prod(mesh.shape[a] for a in axes_tuple(entry))


def _coords(mesh, lid: int) -> Dict[str, int]:
    """The position of logical id ``lid`` along each mesh axis."""
    pos = np.argwhere(mesh.ids == lid)[0]
    return dict(zip(mesh.axis_names, (int(p) for p in pos)))


def axis_index(mesh, lid: int, axes: Axis) -> int:
    """``jax.lax.axis_index(axes)`` at logical id ``lid``: its block index
    over ``axes``, row-major (the first axis slowest)."""
    c = _coords(mesh, lid)
    idx = 0
    for a in axes_tuple(axes):
        idx = idx * mesh.shape[a] + c[a]
    return idx


def _block(mesh, lid: int, spec: Tuple[Axis, ...]) -> Tuple[int, ...]:
    return tuple(axis_index(mesh, lid, e) for e in spec)


def _ids(mesh):
    return [int(i) for i in mesh.ids.flat]


def constrain(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``with_sharding_constraint``'s counterpart: XLA's placement hint,
    which changes no value.  Without a mesh, ``x``.  On a mesh the spec
    must fit ``x`` and name the mesh's axes (``ValueError`` otherwise);
    ``x`` stays whole, on the mesh's first device."""
    if mesh is None:
        return x
    _checked(mesh, spec, x.dim())
    dev = mesh.first_device
    return x if x.device == dev else x.to(dev)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each block of an array lives.  The port
    keeps an array outside a shard region whole on :attr:`device` (the
    mesh's first); :meth:`shard_shape` is one logical device's block."""

    mesh: Any
    spec: PartitionSpec

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The block a logical device holds of an array of ``shape``:
        each split dimension divided by its block count, rounded up (XLA
        pads an uneven split)."""
        spec = _checked(self.mesh, self.spec, len(shape))
        return tuple(-(-int(n) // _count(self.mesh, e))
                     for n, e in zip(shape, spec))


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh and its logical rules, threaded through the sharded
    functions (``mesh=None``: one device)."""

    mesh: Optional[object] = None
    rules: Rules = Rules()

    def constrain(self, x: torch.Tensor, *logical: Optional[str]
                  ) -> torch.Tensor:
        """:func:`constrain` at the spec of the logical axes: a check
        that the spec names the mesh's axes, no change of value; ``x``
        stays whole on the mesh's first device."""
        if self.mesh is None:
            return x
        return constrain(x, self.mesh, self.rules.spec(*logical))


LOCAL_CTX = ShardCtx()


# ---------------------------------------------------------------------------
# Shard stages: split, run per logical id, collectives, merge
# ---------------------------------------------------------------------------

def shard_split(x: torch.Tensor, mesh, spec) -> Parts:
    """``x`` cut into the block each logical id holds under ``spec`` (a
    dimension split over axes (a, b) in blocks row-major over them, as
    ``PartitionSpec`` places it), each on its id's device.  Ids holding
    the same block on the same device share one tensor (a view of ``x``
    where that is ``x``'s device).  A dimension that does not divide
    raises ``ValueError``, as ``shard_map`` refuses it."""
    spec = _checked(mesh, spec, x.dim())
    counts = [_count(mesh, e) for e in spec]
    for d, c in enumerate(counts):
        if x.shape[d] % c:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split into {c} blocks ({P(*spec)})")
    out: Parts = {}
    made: Dict[tuple, torch.Tensor] = {}
    for lid in _ids(mesh):
        blk, dev = _block(mesh, lid, spec), mesh.device(lid)
        key = (blk, dev)
        if key not in made:
            t = x
            for d, (b, c) in enumerate(zip(blk, counts)):
                if c > 1:
                    n = x.shape[d] // c
                    t = t.narrow(d, b * n, n)
            made[key] = t if t.device == dev else t.to(dev)
        out[lid] = made[key]
    return out


def shard_merge(parts: Parts, mesh, spec) -> torch.Tensor:
    """The blocks of ``parts`` (one a logical id, laid out by ``spec``)
    as one tensor on the mesh's first device.  A block held by several
    ids (an axis ``spec`` does not name) is taken from the first of them
    in row-major order, as ``shard_map``'s unchecked ``out_specs``
    does."""
    some = next(iter(parts.values()))
    spec = _checked(mesh, spec, some.dim())
    counts = [_count(mesh, e) for e in spec]
    dev = mesh.first_device
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
    for lid in _ids(mesh):
        blk = _block(mesh, lid, spec)
        if blk not in blocks:
            t = parts[lid]
            blocks[blk] = t if t.device == dev else t.to(dev)

    def cat(prefix: Tuple[int, ...]) -> torch.Tensor:
        d = len(prefix)
        if d == len(counts):
            return blocks[prefix]
        if counts[d] == 1:
            return cat(prefix + (0,))
        return torch.cat([cat(prefix + (b,)) for b in range(counts[d])],
                         dim=d)
    return cat(())


def _groups(mesh, axes: Axis):
    """The ids that take part in one collective over ``axes``: those equal
    on every other axis, each group in block order over ``axes``."""
    axes = axes_tuple(axes)
    groups: Dict[tuple, list] = {}
    for lid in _ids(mesh):
        c = _coords(mesh, lid)
        key = tuple(c[a] for a in mesh.axis_names if a not in axes)
        groups.setdefault(key, []).append(lid)
    return [sorted(g, key=lambda lid: axis_index(mesh, lid, axes))
            for g in groups.values()]


def all_to_all(parts: Parts, mesh, axes: Axis, split_axis: int,
               concat_axis: int) -> Parts:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axes``: in each
    group of n ids, id i's tensor is cut into n chunks along
    ``split_axis``; id j receives chunk j of every member, concatenated
    along ``concat_axis`` in member order, on its own device."""
    out: Parts = {}
    for group in _groups(mesh, axes):
        n = len(group)
        chunks = []
        for lid in group:
            t = parts[lid]
            if t.shape[split_axis] % n:
                raise ValueError(f"all_to_all: dimension {split_axis} of "
                                 f"{tuple(t.shape)} does not split {n} ways")
            chunks.append(torch.chunk(t, n, dim=split_axis))
        for j, lid in enumerate(group):
            dev = mesh.device(lid)
            out[lid] = torch.cat([c[j].to(dev) for c in chunks],
                                 dim=concat_axis)
    return out


def psum(parts: Parts, mesh, axes: Axis) -> Parts:
    """``jax.lax.psum`` over ``axes``: each group's tensors summed in
    member order on the first member's device, the sum given to every
    member on its own device."""
    out: Parts = {}
    for group in _groups(mesh, axes):
        dev = mesh.device(group[0])
        total = parts[group[0]]
        for lid in group[1:]:
            total = total + parts[lid].to(dev)
        for lid in group:
            out[lid] = total.to(mesh.device(lid))
    return out


def all_gather(parts: Parts, mesh, axes: Axis, dim: int) -> Parts:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axes``: each group's
    tensors concatenated along ``dim`` in member order, on each member's
    device."""
    out: Parts = {}
    for group in _groups(mesh, axes):
        for lid in group:
            dev = mesh.device(lid)
            out[lid] = torch.cat([parts[m].to(dev) for m in group], dim=dim)
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """What a stage body knows of the logical device it runs for."""

    mesh: Any
    lid: int

    @property
    def device(self) -> torch.device:
        return self.mesh.device(self.lid)

    def axis_index(self, axes: Axis) -> int:
        return axis_index(self.mesh, self.lid, axes)


def per_shard(mesh, body: Callable, *parts: Parts) -> Dict[int, Any]:
    """One stage: ``body(Shard, *blocks)`` for each logical id in
    row-major order, the blocks of ``parts`` at that id."""
    return {lid: body(Shard(mesh, lid), *(p[lid] for p in parts))
            for lid in _ids(mesh)}


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs):
    """``shard_map_compat``'s counterpart for a body with no collective:
    the returned function splits each tensor argument by its spec
    (:func:`shard_split`), runs ``body(Shard, *blocks)`` once per logical
    id and merges each output by its spec (a tuple of specs for a tuple
    of outputs)."""
    def fn(*args):
        parts = [shard_split(a, mesh, s) for a, s in zip(args, in_specs,
                                                          strict=True)]
        outs = per_shard(mesh, body, *parts)
        if isinstance(out_specs, PartitionSpec):
            return shard_merge(outs, mesh, out_specs)
        return tuple(shard_merge({lid: o[i] for lid, o in outs.items()},
                                 mesh, s) for i, s in enumerate(out_specs))
    return fn
