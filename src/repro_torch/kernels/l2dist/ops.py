"""Wrapper of the exact-L2 kernels.

Two kernels, written in CUDA C++ for ``sm_90a``, port the Pallas
``l2dist``; plain version ``ref.l2dist_ref``:

* ``l2dist_wgmma`` (``csrc/l2dist_wgmma.cu``): f32 on the tensor cores
  (3xTF32 ``wgmma``, TMA), for widths d % 4 == 0 (TMA's 16-byte row
  stride) up to 128 (the query tile it keeps in shared memory); q or v
  that does not start on a 16-byte boundary is copied first; its
  persistent grid comes from :func:`l2_plan`;
* ``l2dist`` (``csrc/l2dist.cu``): f32 or bf16 on the CUDA cores, for
  every other case: bf16, and f32 of another width.

:func:`l2_kernel` states that rule.  The wrapper runs the plain version
when its tensors lie on the CPU.  On CUDA tensors it launches the kernel
the rule names, or raises: it checks device, dtype, shape and contiguity
first and the ``cudaError_t`` after, allocates the output with
``torch.empty``, launches on the current stream and counts the launch in
``LAUNCHES[<kernel name>]`` (``repro_torch.kernels.launch``).  Ragged B,
N and d need no padding: the kernels mask their edge tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.l2dist.ref import l2dist_ref
from repro_torch.kernels.launch import check, launch

_DTYPES = (torch.float32, torch.bfloat16)
_WGMMA_MAX_D = 128              # l2dist_wgmma.cu: kMaxD
_WGMMA_TILE = 128               # l2dist_wgmma.cu: kBM = kBN


def l2_kernel(dtype: torch.dtype, d: int) -> str:
    """The kernel that computes distances of inputs of ``dtype`` and width
    ``d``: ``l2dist_wgmma`` for f32 with d % 4 == 0 and d <= 128,
    ``l2dist`` for everything else."""
    if dtype == torch.float32 and d % 4 == 0 and 0 < d <= _WGMMA_MAX_D:
        return "l2dist_wgmma"
    return "l2dist"


def l2_plan(b: int, n: int, sms: int) -> int:
    """``grid_x`` of ``l2dist_wgmma``'s persistent grid for B queries
    against N vectors on a card of ``sms`` SMs.

    One block resides on an SM (its tiles take 224 KB of shared memory).
    The kernel's entry gives its grid one row per query tile (128
    queries); each row's grid_x = sms // rows blocks (at least one, at
    most one per vector tile) walk the 128-vector tiles x, x + grid_x,
    ..., each in step with the blocks of the other rows at the same x."""
    q_tiles = -(-b // _WGMMA_TILE)
    v_tiles = -(-n // _WGMMA_TILE)
    return max(1, min(v_tiles, sms // q_tiles))


def l2_distances(queries: torch.Tensor, vectors: torch.Tensor
                 ) -> torch.Tensor:
    """queries (B, D), vectors (N, D), both f32 or both bf16 -> exact
    squared L2 distances (B, N) f32, summed in f32."""
    if queries.device.type == "cpu":
        return l2dist_ref(queries, vectors)
    dev = queries.device
    check("queries", queries, _DTYPES, 2, dev)
    check("vectors", vectors, queries.dtype, 2, dev)
    b, d = queries.shape
    n, dv = vectors.shape
    if dv != d:
        raise ValueError(f"queries {tuple(queries.shape)} and vectors "
                         f"{tuple(vectors.shape)} differ in D")
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if not (b and n):
        return out
    name = l2_kernel(queries.dtype, d)
    if name == "l2dist_wgmma":
        # its TMA loads start on 16-byte boundaries: a view that starts
        # elsewhere is copied into a fresh (aligned) buffer first
        queries, vectors = (x if x.data_ptr() % 16 == 0 else x.clone()
                            for x in (queries, vectors))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        launch(name, dev, queries.data_ptr(), vectors.data_ptr(),
               out.data_ptr(), b, n, d, l2_plan(b, n, sms))
    else:
        launch(name, dev, queries.data_ptr(), vectors.data_ptr(),
               out.data_ptr(), b, n, d,
               int(queries.dtype == torch.bfloat16))
    return out
