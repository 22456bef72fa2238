"""Wrapper of the flash-attention forward kernel.

One kernel, written in CUDA C++ for ``sm_90a``: ``flash_attn_fwd``
(``csrc/flash_attn_fwd.cu``), the port of the Pallas
``flash_attention_fwd``; plain version ``ref.flash_attn_ref``.  The
wrapper keeps the JAX package's layout — q (B, S, H, dh), k and v
(B, T, Hk, dh) — and runs the plain version when its tensors lie on the
CPU.  On CUDA tensors it launches the kernel, or raises: it checks device,
dtype, shape and contiguity first and the ``cudaError_t`` after, allocates
the output with ``torch.empty``, launches on the current stream and counts
the launch in ``LAUNCHES["flash_attn_fwd"]``
(``repro_torch.kernels.launch``).  Ragged S and T need no padding: the
kernel masks its edge tiles.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attn.ref import flash_attn_ref
from repro_torch.kernels.launch import check, launch

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DH = 128                   # flash_attn_fwd.cu: kMaxDh


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
            or hk < 1 or h % hk or dh % 4 or not 4 <= dh <= _MAX_DH):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H % Hk == 0, dh % 4 == 0, dh <= "
            f"{_MAX_DH})")
    if t == 0:
        raise ValueError("attention over zero keys")
    out = torch.empty_like(q)
    if b and s and h:
        launch("flash_attn_fwd", dev, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), b, s, t, h, hk, dh,
               int(q.dtype == torch.bfloat16),
               scale if scale is not None else 1.0 / math.sqrt(dh),
               int(causal))
    return out
