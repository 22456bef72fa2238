"""Wrapper of the flash-attention forward kernels.

Three kernels, written in CUDA C++ for ``sm_90a``, port the Pallas
``flash_attention_fwd``; plain version ``ref.flash_attn_ref``:

* ``flash_attn_fwd_wgmma`` (``csrc/flash_attn_fwd_wgmma.cu``): bf16 on
  the tensor cores (``wgmma``, TMA), for dh % 8 == 0 up to 128;
* ``flash_attn_fwd_tf32`` (``csrc/flash_attn_fwd_tf32.cu``): f32 on the
  tensor cores in 3xTF32 (each operand split into a TF32 hi and lo part,
  three products: one TF32 product would break the f32 tolerance, three
  keep it), for dh % 4 == 0 up to 128;
* ``flash_attn_fwd`` (``csrc/flash_attn_fwd.cu``): f32 or bf16 on the CUDA
  cores, for every other head width up to 256.

Each tensor-core kernel has two instances, at dh 64 and 128: a head
width up to 64 runs on the first, up to 128 on the second, its tensor
maps taking the true dh as their inner extent, so TMA reads the columns
past dh as zeros (TMA needs every row stride on 16 bytes, hence the
multiples of 4 and 8).  For either, q, k or v that does not start on a
16-byte boundary is copied first (its TMA loads need it).  Above dh =
256 the card has no kernel and the wrapper raises; the JAX package takes
any width.

:func:`flash_kernel` states that rule, :func:`flash_instance` the key a
launch is counted under: a tensor-core kernel at a head width other than
its instance's (64 or 128) counts apart, as ``<kernel>[padded]``.  The
wrapper keeps the JAX
package's layout — q (B, S, H, dh), k and v (B, T, Hk, dh) — and runs the
plain version when its tensors lie on the CPU.  On CUDA tensors it
launches the kernel the rule names, or raises: it checks device, dtype,
shape and contiguity first and the ``cudaError_t`` after, allocates the
output with ``torch.empty``, launches on the current stream and counts
the launch in ``LAUNCHES[flash_instance(dtype, dh)]``
(``repro_torch.kernels.launch``).
Ragged S and T need no padding: the kernels mask their edge tiles.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attn.ref import flash_attn_ref
from repro_torch.kernels.launch import check, launch

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DH = 256                   # flash_attn_fwd.cu: kMaxDh
_WGMMA_MAX_DH = 128             # the tensor-core kernels' wider instance
_WGMMA_DH = (64, 128)           # their instances' head widths


def flash_kernel(dtype: torch.dtype, dh: int) -> str:
    """The kernel that computes attention for inputs of ``dtype`` and head
    width ``dh``: up to dh = 128, ``flash_attn_fwd_wgmma`` for bf16 with
    dh % 8 == 0 and ``flash_attn_fwd_tf32`` for f32 with dh % 4 == 0 (rows
    on TMA's 16-byte stride); ``flash_attn_fwd`` for every other head
    width up to 256.  Raises ``ValueError`` outside 1 <= dh <= 256, where
    the card has no kernel."""
    if not 1 <= dh <= _MAX_DH:
        raise ValueError(f"head width {dh}: the CUDA kernels take 1 <= dh "
                         f"<= {_MAX_DH}")
    step = 8 if dtype == torch.bfloat16 else 4    # 16-byte row stride
    if dh % step or dh > _WGMMA_MAX_DH:
        return "flash_attn_fwd"
    if dtype == torch.bfloat16:
        return "flash_attn_fwd_wgmma"
    return "flash_attn_fwd_tf32"


def flash_instance(dtype: torch.dtype, dh: int) -> str:
    """The ``LAUNCHES`` key of the kernel :func:`flash_kernel` names: a
    tensor-core kernel at a head width other than 64 or 128 (its columns
    padded with zeros up to the instance) counts as ``<kernel>[padded]``;
    else the kernel's name."""
    name = flash_kernel(dtype, dh)
    if name != "flash_attn_fwd" and dh not in _WGMMA_DH:
        return f"{name}[padded]"
    return name


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """GQA attention forward: q (B, S, H, dh), k/v (B, T, Hk, dh), f32 or
    bf16 -> (B, S, H, dh) in q's dtype, accumulated in f32.  ``scale``
    defaults to 1/sqrt(dh); ``causal`` keeps key t for query s where
    s >= t, positions aligned at the top left."""
    if q.device.type == "cpu":
        return flash_attn_ref(q, k, v, causal=causal, scale=scale)
    dev = q.device
    check("q", q, _DTYPES, 4, dev)
    check("k", k, q.dtype, 4, dev)
    check("v", v, q.dtype, 4, dev)
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh
            or hk < 1 or h % hk):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H % Hk == 0)")
    name = flash_instance(q.dtype, dh)          # raises past dh = 256
    if t == 0:
        raise ValueError("attention over zero keys")
    out = torch.empty_like(q)
    if not (b and s and h):
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if name == "flash_attn_fwd":
        launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, s, t, h, hk, dh,
               int(q.dtype == torch.bfloat16), scale, int(causal))
    else:
        # their TMA loads start on 16-byte boundaries: a view that starts
        # elsewhere is copied into a fresh (aligned) buffer first
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
        launch(name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, s, t, h, hk, dh, scale, int(causal))
    return out
