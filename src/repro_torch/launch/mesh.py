"""Meshes of logical devices (the port's counterpart of
``repro.launch.mesh``).

JAX drives every device of a mesh from one Python process, and so does
the port: a :class:`Mesh` is an array of logical device ids with axis
names, and the ``torch.device`` each id lives on.  The sharded functions
(``core.distributed``, ``core.topk``) launch each shard's kernel on its
id's device and copy only (dist, id) pairs to the mesh's first device.
Several logical ids may share one physical device: that is how a
one-card machine (or the CPU, in tests) holds a mesh of four, as the
JAX package's tests force several host devices on one CPU.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Devices = Union[Mapping[int, object], Sequence[object]]


def _reachable(dev) -> torch.device:
    """``dev`` as a ``torch.device`` with its index, or ``ValueError``
    where this process cannot reach it.  ``meta`` is taken: a mesh that
    only places shapes (``make_production_mesh``), where no shard runs."""
    dev = torch.device(dev)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a logical device lives on the CPU, a CUDA "
                         f"card or meta, not on {dev}")
    idx = 0 if dev.index is None else dev.index
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if idx >= count:
        raise ValueError(f"a logical device lives on {dev}, and this "
                         f"process sees {count} CUDA card(s)")
    return torch.device("cuda", idx)


class Mesh:
    """``ids`` (an int array, one logical device id per position, shaped
    like the mesh) with ``axis_names`` (one per dimension), and
    ``devices``: the device of each id (a mapping, or a sequence indexed
    by id).  Every device must be reachable from this process."""

    def __init__(self, ids, axis_names: Sequence[str], devices: Devices):
        ids = np.asarray(ids, np.int64)
        axis_names = tuple(axis_names)
        if ids.ndim != len(axis_names):
            raise ValueError(f"{ids.ndim}-D ids with axis names "
                             f"{axis_names}")
        if len(np.unique(ids)) != ids.size:
            raise ValueError(f"logical ids repeat: {ids.tolist()}")
        if not isinstance(devices, Mapping):
            devices = dict(enumerate(devices))
        missing = [int(i) for i in ids.flat if int(i) not in devices]
        if missing:
            raise ValueError(f"no device given for logical ids {missing}")
        self.ids = ids
        self.axis_names = axis_names
        self._devices: Dict[int, torch.device] = {
            int(i): _reachable(devices[int(i)]) for i in ids.flat}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ids.shape))

    @property
    def size(self) -> int:
        return int(self.ids.size)

    def device(self, lid: int) -> torch.device:
        return self._devices[int(lid)]

    def devices_of(self, ids=None) -> List[torch.device]:
        """The device of each logical id in ``ids`` (default: the whole
        mesh, row-major)."""
        ids = self.ids if ids is None else np.asarray(ids)
        return [self._devices[int(i)] for i in np.ravel(ids)]

    @property
    def first_device(self) -> torch.device:
        """Where the sharded functions merge and return their results."""
        return self._devices[int(self.ids.flat[0])]

    def grid_ids(self, *dims: Tuple[str, ...]) -> np.ndarray:
        """The logical ids that hold the blocks of an array whose i-th
        sharded dimension is split over the mesh axes ``dims[i]``: shape
        (blocks of dim 0, blocks of dim 1, ...), a dimension's block index
        row-major over its axes (as ``axis_index`` counts in JAX), the
        first position along every axis no dimension names."""
        used = [a for d in dims for a in d]
        if len(set(used)) != len(used):
            raise ValueError(f"a mesh axis shards two dimensions: {dims}")
        for a in used:
            if a not in self.axis_names:
                raise ValueError(f"no mesh axis {a!r} in {self.axis_names}")
        order = [self.axis_names.index(a) for a in used]
        rest = [i for i in range(self.ids.ndim) if i not in order]
        arr = self.ids.transpose(order + rest)[
            (Ellipsis,) + (0,) * len(rest)]
        return arr.reshape(tuple(
            int(np.prod([self.shape[a] for a in d], dtype=np.int64))
            for d in dims))

    def submesh(self, ids) -> "Mesh":
        """The mesh over ``ids`` (a subset of this one's), its axis names
        and devices kept."""
        return Mesh(ids, self.axis_names,
                    {int(i): self._devices[int(i)] for i in np.ravel(ids)})

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self._devices.values()})
        return (f"Mesh({self.shape}, ids={self.ids.ravel().tolist()}, "
                f"on {', '.join(devs)})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: one pod, 16 x 16 = 256 devices
    ``("data", "model")``, or two, 2 x 16 x 16 = 512 ``("pod", "data",
    "model")``, as logical ids 0..n-1 row-major.  Every id lives on
    ``meta``: a mesh that places shapes for ``launch.dryrun`` and runs no
    shard (no host of the port holds 256 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(np.arange(n).reshape(shape), axes, ["meta"] * n)


def make_test_mesh(n_devices: Optional[int] = None, *,
                   multi_pod: bool = False, device=None) -> Mesh:
    """A small mesh in the reference's shapes: (1, 1) for one device,
    (2, n/2) ``("data", "model")``, or (2, 2, n/4) ``("pod", "data",
    "model")`` with ``multi_pod``.

    ``device=None``: the CUDA cards, one a logical device where
    ``torch.cuda.device_count() >= n`` (n defaults to that count), else
    all n logical devices on ``cuda:0`` (a one-card machine); it raises
    without a card.  A ``device`` puts all n on it — the CPU in tests.
    Several logical devices on one physical device are the counterpart
    of the JAX package's forced host devices: the sharded paths run and
    answer as on n cards, one shard after another."""
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_test_mesh(device=None) places the mesh "
                               "on CUDA cards and none is available; pass "
                               "device='cpu'")
        n = n_devices or count
        devices = ([torch.device("cuda", i) for i in range(n)]
                   if count >= n else [torch.device("cuda", 0)] * n)
    else:
        n = n_devices or 1
        devices = [torch.device(device)] * n
    if multi_pod:
        if n % 2 or n < 8:
            raise ValueError(f"a multi-pod test mesh needs an even n >= 8, "
                             f"got {n}")
        shape, names = (2, 2, n // 4), ("pod", "data", "model")
    elif n == 1:
        shape, names = (1, 1), ("data", "model")
    else:
        if n % 2:
            raise ValueError(f"a test mesh of {n} devices is not (2, n/2)")
        shape, names = (2, n // 2), ("data", "model")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    return Mesh(np.arange(n).reshape(shape), names, devices)


def split_mesh(mesh: Mesh, n_replicas: int) -> List[Mesh]:
    """Carve ``mesh`` into ``n_replicas`` DISJOINT sub-meshes (multi-replica
    serving: each replica's executor row-shards the corpus over its own
    device group, so per-replica ADC scans never contend for a device).

    The leading mesh axis is split when divisible; otherwise the id
    array is flattened and re-folded so any ``n_replicas`` dividing the
    device count works.  Every sub-mesh keeps the parent's axis names
    (sharding rules and ``corpus``-axis specs stay valid unchanged)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if n_replicas == 1:
        return [mesh]
    ids = mesh.ids
    total = ids.size
    if total % n_replicas:
        raise ValueError(
            f"cannot split {total} devices into {n_replicas} replicas")
    per = total // n_replicas
    if ids.shape[0] % n_replicas == 0:
        groups = np.split(ids, n_replicas, axis=0)
    else:                      # re-fold: (n_replicas, 1, ..., per)
        shape = (1,) * (ids.ndim - 1) + (per,)
        groups = [g.reshape(shape)
                  for g in np.split(ids.reshape(-1), n_replicas)]
    return [mesh.submesh(g) for g in groups]


def recarve_mesh(mesh: Mesh, n_groups: int) -> List[Mesh]:
    """Re-carve ``mesh`` into ``n_groups`` disjoint sub-meshes for an
    ELASTIC replica set (serve/autoscaler.py): unlike :func:`split_mesh`,
    ``n_groups`` need not divide the device count — the flattened id
    list is cut into contiguous near-equal groups (sizes differ by at
    most one).  Equal divisions keep :func:`split_mesh` semantics exactly
    (same grouping, same axis folding).  Every sub-mesh keeps the
    parent's axis names, so ``corpus``-axis specs stay valid; an executor
    re-attached to its new group (``QueryExecutor.attach_mesh``)
    re-places its code shards on the next dispatch."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    ids = mesh.ids
    total = ids.size
    if n_groups > total:
        raise ValueError(
            f"cannot carve {total} device(s) into {n_groups} groups")
    if total % n_groups == 0:
        return split_mesh(mesh, n_groups)
    flat = ids.reshape(-1)
    base, extra = divmod(total, n_groups)
    groups, at = [], 0
    for gi in range(n_groups):
        size = base + (1 if gi < extra else 0)
        shape = (1,) * (ids.ndim - 1) + (size,)
        groups.append(flat[at:at + size].reshape(shape))
        at += size
    return [mesh.submesh(g) for g in groups]
