"""Wrapper of the flash-attention forward kernels.

Two kernels, written in CUDA C++ for ``sm_90a``, port the Pallas
``flash_attention_fwd``; plain version ``ref.flash_attn_ref``:

* ``flash_attn_fwd_wgmma`` (``csrc/flash_attn_fwd_wgmma.cu``): bf16 on
  the tensor cores (``wgmma``, TMA);
* ``flash_attn_fwd_tf32`` (``csrc/flash_attn_fwd_tf32.cu``): f32 on the
  tensor cores in 3xTF32 (each operand split into a TF32 hi and lo part,
  three products: one TF32 product would break the f32 tolerance, three
  keep it).

Each kernel has four instances, named by the width of q and k (kDh, the
K of the Q K^T product) and of v (kDv, the N of the P V product): (64,
64), (128, 128), (192, 128) and (256, 256).  :func:`flash_plan` states
the rule, the same for both dtypes: a head width up to 64 runs on the
first, up to 128 on the second, up to 192 with v at most 128 wide on the
third (DeepSeek-V2's MLA prefill: q and k 192 wide, v 128), the rest on
the fourth.  The tensor maps take the true widths as their inner extent,
so TMA reads the columns past dh (q, k) and dv (v) as zeros; the output
is written at v's width.  TMA needs every row stride on 16 bytes: a
width off it (bf16 % 8 != 0, f32 % 4 != 0) is copied into buffers
zero-padded to the next multiple of 8 or 4 (zero columns add nothing to
a score and give zero output columns, which are cut off), with the scale
of the true dh.  Above dh = 256 the card has no kernel and the wrapper
raises; the JAX package takes any width.

The wrapper takes what the JAX one takes: any real dtype for each of q,
k and v, mixed, and views.  ``launch.operand_dtype`` names the dtype the
kernel computes in (bf16 where all three are uint8, int8 or bf16; f32
otherwise); an input of another dtype, not contiguous or off a 16-byte
boundary is copied first.  It returns q's dtype, as the JAX kernel does.
v may be narrower than q and k (dv < dh), as the JAX model's attention
takes it.

:func:`flash_kernel` names the kernel, :func:`flash_instance` the key a
launch is counted under: ``<kernel>[dv]`` where v is narrower than q;
else ``<kernel>`` at dh 64 and 128, ``<kernel>[padded]`` at other
widths up to 128 on the stride, ``<kernel>[256]`` above 128 on the
stride, ``<kernel>[stride-pad]`` off it.  The wrapper keeps the JAX
package's layout — q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv)
— and runs the plain version when its tensors lie on the CPU.  On CUDA
tensors it launches the kernel the plan names, or raises: it checks
device and shapes first and the ``cudaError_t`` after, allocates the
output with ``torch.empty``, launches on the current stream and counts
the launch in ``LAUNCHES[flash_instance(dtype, dh, dv)]``
(``repro_torch.kernels.launch``).  Ragged S and T need no padding: the
kernels mask their edge tiles.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn.ref import flash_attn_ref
from repro_torch.kernels.launch import launch, operand, operand_dtype

_MAX_DH = 256                   # the kernels' widest instance
_INSTANCE_DH = (64, 128)        # instances taken without a [padded] key


def _step(dtype: torch.dtype) -> int:
    """Elements a 16-byte row stride holds a multiple of."""
    return 8 if operand_dtype(dtype) == torch.bfloat16 else 4


def flash_kernel(dtype: torch.dtype, dh: int) -> str:
    """The kernel that computes attention for inputs of ``dtype`` and head
    width ``dh``: ``flash_attn_fwd_wgmma`` where they compute in bf16
    (``launch.operand_dtype``), ``flash_attn_fwd_tf32`` in f32, at every
    head width up to 256.  Raises ``ValueError`` outside 1 <= dh <= 256,
    where the card has no kernel."""
    if not 1 <= dh <= _MAX_DH:
        raise ValueError(f"head width {dh}: the CUDA kernels take 1 <= dh "
                         f"<= {_MAX_DH}")
    if operand_dtype(dtype) == torch.bfloat16:
        return "flash_attn_fwd_wgmma"
    return "flash_attn_fwd_tf32"


def flash_width(dtype: torch.dtype, dh: int) -> int:
    """The head width the kernel sees: dh rounded up to the 16-byte row
    stride (a multiple of 8 in bf16, of 4 in f32)."""
    step = _step(dtype)
    return -(-dh // step) * step


def flash_instance(dtype: torch.dtype, dh: int,
                   dv: Optional[int] = None) -> str:
    """The ``LAUNCHES`` key of the kernel :func:`flash_kernel` names:
    ``<kernel>[dv]`` where v is ``dv`` wide, narrower than q and k,
    whatever the strides; else ``<kernel>[stride-pad]`` for a head width
    off the 16-byte row stride (copied with zero columns first); on it,
    ``<kernel>[256]`` above 128 (the 256 instance), ``<kernel>[padded]``
    at other widths than 64 and 128 (its columns past dh read as zeros
    up to the instance), else the kernel's name.  Raises ``ValueError``
    where dv is not in 1 .. dh."""
    name = flash_kernel(dtype, dh)
    if dv is not None and dv != dh:
        if not 1 <= dv < dh:
            raise ValueError(f"v width {dv}: the kernels take 1 <= dv <= "
                             f"dh = {dh}")
        return f"{name}[dv]"
    if dh % _step(dtype):
        return f"{name}[stride-pad]"
    if dh > 128:
        return f"{name}[256]"
    if dh not in _INSTANCE_DH:
        return f"{name}[padded]"
    return name


class FlashPlan(NamedTuple):
    """What :func:`flash_attention` launches: the kernel's instance (kDh,
    kDv), the widths of q/k and of v the kernel is passed (each rounded up
    to the 16-byte row stride), and the ``LAUNCHES`` key."""
    instance: Tuple[int, int]
    widths: Tuple[int, int]
    key: str


def flash_plan(dtype: torch.dtype, dh: int,
               dv: Optional[int] = None) -> FlashPlan:
    """The instance that computes attention over q and k ``dh`` wide and v
    ``dv`` wide (``dh`` when None) for inputs of ``dtype``, by the rule of
    both kernels' C entry points: q/k at most 64 wide -> (64, 64); at most
    128 -> (128, 128); at most 192 with v at most 128 -> (192, 128); else
    (256, 256), the widths taken after rounding to the row stride.  Raises
    ``ValueError`` as :func:`flash_instance` does."""
    dv = dh if dv is None else dv
    key = flash_instance(dtype, dh, dv)
    dp, dvp = flash_width(dtype, dh), flash_width(dtype, dv)
    if dp <= 64:
        instance = (64, 64)
    elif dp <= 128:
        instance = (128, 128)
    elif dp <= 192 and dvp <= 128:
        instance = (192, 128)
    else:
        instance = (256, 256)
    return FlashPlan(instance, (dp, dvp), key)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """GQA attention forward: q (B, S, H, dh), k (B, T, Hk, dh), v (B, T,
    Hk, dv) with dv <= dh, of any real dtypes -> (B, S, H, dv) in q's
    dtype, accumulated in f32.  ``scale`` defaults to 1/sqrt(dh);
    ``causal`` keeps key t for query s where s >= t, positions aligned at
    the top left."""
    if q.device.type == "cpu":
        return flash_attn_ref(q, k, v, causal=causal, scale=scale)
    dev = q.device
    dtype = operand_dtype(q.dtype, k.dtype, v.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be 4-d")
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh
            or hk < 1 or h % hk):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H % Hk == 0)")
    plan = flash_plan(dtype, dh, dv)        # raises past dh = 256, dv > dh
    if t == 0:
        raise ValueError("attention over zero keys")
    dp, dvp = plan.widths
    q_dtype = q.dtype
    q, k = (operand(nm, x, dtype, 4, dp, dev) for nm, x in (("q", q),
                                                            ("k", k)))
    v = operand("v", v, dtype, 4, dvp, dev)
    out = torch.empty(b, s, h, dvp, dtype=dtype, device=dev)
    if b and s and h:
        scale = scale if scale is not None else 1.0 / math.sqrt(dh)
        launch(plan.key, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), b, s, t, h, hk, dp, dvp, scale, int(causal))
    if dvp != dv:
        out = out[..., :dv]
    return out.to(q_dtype).contiguous()
