"""Wrapper of the exact-L2 kernel.

One kernel, written in CUDA C++ for ``sm_90a``: ``l2dist``
(``csrc/l2dist.cu``), the port of the Pallas ``l2dist``; plain version
``ref.l2dist_ref``.  The wrapper runs the plain version when its tensors
lie on the CPU.  On CUDA tensors it launches the kernel, or raises: it
checks device, dtype, shape and contiguity first and the ``cudaError_t``
after, allocates the output with ``torch.empty``, launches on the current
stream and counts the launch in ``LAUNCHES["l2dist"]``
(``repro_torch.kernels.launch``).  Ragged B and N need no padding: the
kernel masks its edge tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.l2dist.ref import l2dist_ref
from repro_torch.kernels.launch import check, launch

_DTYPES = (torch.float32, torch.bfloat16)


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
    if b and n:
        launch("l2dist", dev, queries.data_ptr(), vectors.data_ptr(),
               out.data_ptr(), b, n, d,
               int(queries.dtype == torch.bfloat16))
    return out
