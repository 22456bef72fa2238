"""Logical sharding rules mapped onto a mesh's axes (the port's
counterpart of ``repro.sharding.spec``).

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
device) lives here until ``models/`` is ported; the JAX package keeps it
in ``models/layers.py``.  The JAX module's ``shard_map_compat``,
``constrain`` and ``named`` are XLA's sharding machinery and have no
counterpart: the port's mesh functions place each shard on its device
themselves (``core.distributed``, ``core.topk``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]


def axes_tuple(axes: Axis) -> Tuple[str, ...]:
    """A logical axis as a tuple of mesh axis names (``None`` -> ())."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical -> mesh axis mapping."""

    batch: Axis = "data"
    fsdp: Axis = "data"
    tensor: Axis = "model"
    expert: Axis = "model"
    corpus: Axis = ("data", "model")

    def spec(self, *logical: Optional[str]) -> Tuple[Axis, ...]:
        """The mesh axes of each dimension named by a logical axis (None =
        replicated): the port's form of a ``PartitionSpec``."""
        return tuple(None if name is None else getattr(self, name)
                     for name in logical)


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


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """A mesh and its logical rules, threaded through the sharded
    functions (``mesh=None``: one device)."""

    mesh: Optional[object] = None
    rules: Rules = Rules()


LOCAL_CTX = ShardCtx()
