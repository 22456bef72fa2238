"""Wrapper of the exact-L2 kernel.

One kernel, written in CUDA C++ for ``sm_90a``, ports the Pallas
``l2dist``; plain version ``ref.l2dist_ref``: ``l2dist_wgmma``
(``csrc/l2dist_wgmma.cu``), on the tensor cores, f32 of every width in
3xTF32, loaded by TMA where d % 4 == 0 (rows on its 16-byte stride) and
by 4-byte ``cp.async`` granules otherwise, and bf16 of every even width
in one product (each product exact in f32), loaded by ``cp.async`` in the
widest granule the row stride allows (16 bytes where d % 8 == 0, else 8
or 4: SPACEV1B's d = 100 has rows of 200 bytes); the query tile stays in
shared memory up to d = 128 and rides the ring with the vectors above
(GIST1M's d = 960; there bf16 with d % 8 == 0 loads by TMA, and a
prologue kernel writes the query norms and, in f32, q's TF32 hi and lo
parts into a scratch buffer this wrapper allocates); its persistent grid
comes from :func:`l2_plan`.

8-bit integers (SIFT1B's uint8 at d = 128, SPACEV1B's int8 at d = 100)
go to the kernel as they are where both operands are uint8 or int8 and
d <= 128 with d % 4 == 0: one integer product a k-step
(``wgmma ... .s32`` on u8 or s8, each operand its own signedness, all
four mixes), exact int32 sums and one conversion to f32, which is the
plain version's value bit for bit (every sum below 128 * 255^2 < 2^24);
loaded by TMA where d % 16 == 0, else by 8- or 4-byte ``cp.async``
granules.

The wrapper takes what the JAX one takes: any real dtype for each
operand, mixed, and views.  ``launch.operand_dtype`` names the dtype the
kernel computes in outside the 8-bit instances (bf16 where both are
uint8, int8 or bf16, each value exact there: 8-bit widths past 128 or
off d % 4 == 0; f32 otherwise, the JAX kernel's own type); an input of
another dtype, not contiguous or off a 16-byte boundary is copied first;
bf16 of odd width (rows on 2-byte boundaries, which no ``cp.async``
granule takes) is copied by a kernel of the same source, in the same
launch, into buffers this wrapper allocates with rows of the next
multiple of 8 columns (on 16 bytes, the widest granule), the rest zero,
which adds nothing to any sum.

:func:`l2_kernel` states the rule, :func:`l2_instance` the key a launch
is counted under: ``l2dist_wgmma[int8]`` (8-bit rows on the 16-byte
stride, d % 16 == 0), ``l2dist_wgmma[int8,off16]`` (other 8-bit d <= 128
with d % 4 == 0), ``l2dist_wgmma`` (f32, d <= 128),
``l2dist_wgmma[d>128]`` (f32, streamed query tile),
``l2dist_wgmma[bf16]`` (bf16 rows on the 16-byte stride, d <= 128),
``l2dist_wgmma[bf16,off16]`` (other even d <= 128),
``l2dist_wgmma[bf16,d>128]`` and ``l2dist_wgmma[bf16,odd]`` (odd d, padded
to a multiple of 8).  The wrapper runs the plain version when its tensors lie
on the CPU.  On CUDA tensors it launches the kernel, or raises: it checks
device and shape first and the ``cudaError_t`` after, allocates the output
with ``torch.empty``, launches on the current stream and counts the launch
in ``LAUNCHES[l2_instance(q dtype, d, v dtype)]``
(``repro_torch.kernels.launch``).
Ragged B, N and d need no padding: the kernel masks its edge tiles.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.l2dist.ref import l2dist_ref
from repro_torch.kernels.launch import launch, operand, operand_dtype

_RESIDENT_MAX_D = 128           # l2dist_wgmma.cu: kMaxD
_WGMMA_TILE = 128               # l2dist_wgmma.cu: kBM = kBN
_8BIT = (torch.uint8, torch.int8)


def _on_integers(dtype: torch.dtype, d: int, vdtype: torch.dtype) -> bool:
    """Whether inputs of ``dtype`` and ``vdtype``, ``d`` wide, take the
    8-bit instances: both uint8 or int8 (``wgmma`` takes u8 and s8 in all
    four mixes), d <= 128 (the query tile one slice of 128 bytes a row)
    with d % 4 == 0 (rows on the 4-byte ``cp.async`` granule)."""
    return (dtype in _8BIT and vdtype in _8BIT and d <= _RESIDENT_MAX_D
            and d % 4 == 0)


def l2_kernel(dtype: torch.dtype, d: int,
              vdtype: Optional[torch.dtype] = None) -> str:
    """The kernel that computes distances of queries of ``dtype`` and
    vectors of ``vdtype`` (``dtype`` where None), ``d`` wide:
    ``l2dist_wgmma`` for every dtype and width (odd bf16 widths padded
    with zero columns to a multiple of 8)."""
    operand_dtype(dtype, vdtype or dtype)
    return "l2dist_wgmma"


def l2_width(dtype: torch.dtype, d: int,
             vdtype: Optional[torch.dtype] = None) -> int:
    """The width the kernel sees for queries of ``dtype`` and vectors of
    ``vdtype`` (``dtype`` where None), ``d`` wide: d, or for an odd width
    computed in bf16 the next multiple of 8 (rows on 16 bytes, the widest
    ``cp.async`` granule; d + 1 would give rows of 4-byte granules, e.g.
    204 bytes at d = 101)."""
    if operand_dtype(dtype, vdtype or dtype) == torch.bfloat16 and d % 2:
        return -(-d // 8) * 8
    return d


def l2_instance(dtype: torch.dtype, d: int,
                vdtype: Optional[torch.dtype] = None) -> str:
    """The ``LAUNCHES`` key of a launch for queries of ``dtype`` and
    vectors of ``vdtype`` (``dtype`` where None), ``d`` wide: both 8-bit
    with d <= 128 and d % 4 == 0, ``l2dist_wgmma[int8]`` where d % 16 ==
    0 (rows on TMA's 16-byte stride) and ``l2dist_wgmma[int8,off16]``
    otherwise (8- or 4-byte copies); else by ``operand_dtype``: above d
    = 128 (the query tile streamed) ``l2dist_wgmma[d>128]`` in f32 and
    ``l2dist_wgmma[bf16,d>128]`` in bf16; up to 128, ``l2dist_wgmma`` in
    f32, and in bf16 ``l2dist_wgmma[bf16]`` where d % 8 == 0 (rows on 16
    bytes, 16-byte copies) and ``l2dist_wgmma[bf16,off16]`` for other
    even d (8- or 4-byte copies); odd bf16 widths, of any size,
    ``l2dist_wgmma[bf16,odd]``."""
    vdtype = vdtype or dtype
    name = l2_kernel(dtype, d, vdtype)
    if _on_integers(dtype, d, vdtype):
        return f"{name}[int8{'' if d % 16 == 0 else ',off16'}]"
    bf16 = operand_dtype(dtype, vdtype) == torch.bfloat16
    if bf16 and d % 2:
        return "l2dist_wgmma[bf16,odd]"
    if d > _RESIDENT_MAX_D:
        return "l2dist_wgmma[bf16,d>128]" if bf16 else "l2dist_wgmma[d>128]"
    if not bf16:
        return name
    return "l2dist_wgmma[bf16]" if d % 8 == 0 else "l2dist_wgmma[bf16,off16]"


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
    """queries (B, D), vectors (N, D) of any real dtypes -> exact squared
    L2 distances (B, N) f32, summed in f32."""
    if queries.device.type == "cpu":
        return l2dist_ref(queries, vectors)
    dev = queries.device
    if queries.dim() != 2 or vectors.dim() != 2:
        raise ValueError(f"queries {tuple(queries.shape)} and vectors "
                         f"{tuple(vectors.shape)} must be 2-d")
    b, d = queries.shape
    n, dv = vectors.shape
    if dv != d:
        raise ValueError(f"queries {tuple(queries.shape)} and vectors "
                         f"{tuple(vectors.shape)} differ in D")
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if not (b and n):
        return out
    name = l2_instance(queries.dtype, d, vectors.dtype)
    dp = l2_width(queries.dtype, d, vectors.dtype)
    if _on_integers(queries.dtype, d, vectors.dtype):
        # each operand in its own 8-bit type: 2 + 2 * (q is s8) + (v is s8)
        qdt, vdt = queries.dtype, vectors.dtype
        kind = 2 + 2 * (qdt == torch.int8) + (vdt == torch.int8)
    else:
        qdt = vdt = operand_dtype(queries.dtype, vectors.dtype)
        kind = int(qdt == torch.bfloat16)
    # the kernel's loads (TMA, cp.async granules) start on 16-byte
    # boundaries: an input that is not a contiguous, aligned tensor of the
    # operand dtype is copied into a fresh buffer first; at an odd bf16
    # width the kernel's entry copies the rows into buffers of the next
    # multiple of 8 columns (the rest zero) before its loads
    queries = operand("queries", queries, qdt, 2, d, dev)
    vectors = operand("vectors", vectors, vdt, 2, d, dev)
    odd = (queries, vectors) if dp != d else (None, None)
    if dp != d:
        queries, vectors = (torch.empty(x.shape[0], dp, dtype=qdt,
                                        device=dev) for x in odd)
    bf16 = kind == 1
    # above d = 128 the kernel's prologue writes the query norms (b,
    # padded to 4) and, in f32, q's TF32 hi and lo parts here
    scratch = (torch.empty(-(-b // 4) * 4 + (0 if bf16 else 2 * b * dp),
                           dtype=torch.float32, device=dev)
               if dp > _RESIDENT_MAX_D else None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch(name, dev, queries.data_ptr(), vectors.data_ptr(),
           *(0 if x is None else x.data_ptr() for x in odd),
           out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
           b, n, dp, d, l2_plan(b, n, sms), kind)
    return out
