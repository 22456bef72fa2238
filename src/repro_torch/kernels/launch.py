"""What every kernel wrapper shares: input checks, the ctypes binding of
each kernel's C entry point, and the launch counts.

A wrapper checks device, dtype, shape and contiguity of its tensors with
:func:`check`, then calls :func:`launch`, which calls the kernel's C
function (it launches on the stream it is given and returns a
``cudaError_t``), raises if that is not 0, and adds one to
``LAUNCHES[<kernel name>]``.  Nothing else touches the counts.  The exact
L2 and flash-attention wrappers take any real dtype, as the JAX kernels
do: :func:`operand_dtype` names the type their kernels compute in, and
:func:`operand` copies an input into it (and pads its last axis) where
the input is not already a contiguous, 16-byte aligned tensor of it.
Kernels that read their operands at the caller's strides (the f32 flash
forward through TMA tensor maps, the narrow flash backward by 8- and
16-byte loads) take a view as it lies where :func:`tma_view` says so,
with :func:`tma_strides` for its strides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple, Union

import torch

from repro_torch.kernels.build import SOURCES, load

# instantiations counted apart from the source's own name: "<source>[x]"
# launches the library of <source> and counts under its own key
INSTANCES = ("adc_fused_topk[spill]",
             "l2dist_wgmma[d>128]", "l2dist_wgmma[bf16]",
             "l2dist_wgmma[bf16,off16]", "l2dist_wgmma[bf16,d>128]",
             "l2dist_wgmma[bf16,odd]", "l2dist_wgmma[int8]",
             "l2dist_wgmma[int8,off16]",
             "flash_attn_fwd_wgmma[padded]", "flash_attn_fwd_tf32[padded]",
             "flash_attn_fwd_wgmma[256]", "flash_attn_fwd_tf32[256]",
             "flash_attn_fwd_wgmma[stride-pad]",
             "flash_attn_fwd_tf32[stride-pad]",
             "flash_attn_fwd_wgmma[dv]", "flash_attn_fwd_tf32[dv]",
             "flash_attn_fwd_tf32[32]",
             "flash_attn_bwd[bf16]", "flash_attn_bwd[dv]",
             "flash_attn_bwd[bf16,dv]", "flash_attn_bwd[32]")
# kernel launches since the last reset_launches()
LAUNCHES = {name: 0 for name in (*SOURCES, *INSTANCES)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# each C entry point's arguments; the last is always the stream
_SIGNATURES = {
    "adc_scan_batch": (_P, _P, _P) + (_I,) * 8 + (_P,),
    "adc_fused_topk": (_P,) * 6 + (_I,) * 14 + (_P,),
    "adc_scan": (_P, _P, _P) + (_I,) * 4 + (_P,),
    "adc_scan_topk": (_P,) * 4 + (_I,) * 7 + (_P,),
    "l2dist_wgmma": (_P,) * 6 + (_I,) * 6 + (_P,),
    "flash_attn_fwd_wgmma": (_P,) * 5 + (_I,) * 7 + (_F, _I, _P),
    # f32 flash: the last 9 are q, k and v's batch, row and head strides
    "flash_attn_fwd_tf32": (_P,) * 5 + (_I,) * 7 + (_F, _I) + (_L,) * 9
                           + (_P,),
    # the backward: the last 15 are q, k, v, o and dout's batch, row and
    # head strides (read by its narrow instance)
    "flash_attn_bwd": (_P,) * 11 + (_I,) * 7 + (_F, _I, _I) + (_L,) * 15
                      + (_P,),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(load(name), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def check(name: str, t: torch.Tensor,
          dtype: Union[torch.dtype, Sequence[torch.dtype]], ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device``, has one of ``dtype``, has
    ``ndim`` dimensions and is contiguous."""
    dtypes = (dtype,) if isinstance(dtype, torch.dtype) else tuple(dtype)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# dtypes whose every value bf16 holds exactly
_EXACT_IN_BF16 = (torch.uint8, torch.int8, torch.bfloat16)


def operand_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The dtype the exact-L2 and flash kernels compute inputs of
    ``dtypes`` in: bf16 where every input is uint8, int8 or bf16 (each
    value exact in bf16: flash's 8-bit inputs, and the exact L2's at
    widths its 8-bit instances do not take, ``l2dist.l2_instance``); f32,
    the JAX kernels' own type, for every other mix (f16, f32, f64, wider
    integers, bool).  Raises ``TypeError`` on a complex dtype."""
    for dt in dtypes:
        if dt.is_complex:
            raise TypeError(f"the kernels take real dtypes, got {dt}")
    if all(dt in _EXACT_IN_BF16 for dt in dtypes):
        return torch.bfloat16
    return torch.float32


def operand(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
            width: int, device: torch.device) -> torch.Tensor:
    """``t`` as a kernel operand: on ``device`` with ``ndim`` dimensions
    (else ``ValueError``), of ``dtype``, contiguous, 16-byte aligned, its
    last axis ``width`` long (the columns past ``t``'s own width zero).
    ``t`` itself where it is all of that; else a fresh copy, in one pass
    where no padding is needed."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    d = t.shape[-1]
    if (t.dtype == dtype and d == width and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    out = torch.empty(*t.shape[:-1], width, dtype=dtype, device=device)
    if width == d:
        return out.copy_(t)
    out[..., d:].zero_()
    out[..., :d].copy_(t)
    return out


def tma_view(t: torch.Tensor, dtype: torch.dtype, width: int) -> bool:
    """Whether a kernel that reads ``t`` through a TMA tensor map at its
    own strides takes it as it lies, with no copy: ``t`` is of ``dtype``,
    its last axis is ``width`` long and unit-stride, every other axis
    longer than 1 has a positive stride of a multiple of 16 bytes, and
    its first element lies on a 16-byte boundary (TMA's rules for a
    tensor map's base and strides).  The q, k and v split from one (B, S,
    3H, dh) f32 tensor with dh % 4 == 0 pass; a view 4 bytes off, a
    strided last axis, or rows off 16 bytes do not."""
    if t.dtype != dtype or t.dim() < 1 or t.shape[-1] != width:
        return False
    if width > 1 and t.stride(-1) != 1:
        return False
    item = t.element_size()
    if any(n > 1 and (st <= 0 or st * item % 16)
           for n, st in zip(t.shape[:-1], t.stride()[:-1])):
        return False
    return t.data_ptr() % 16 == 0


def tma_strides(t: torch.Tensor) -> Tuple[int, ...]:
    """The element strides of ``t``'s leading axes for a tensor map, of a
    tensor :func:`tma_view` takes: its own, except on an axis of length 1,
    whose stride no load reads, given as 16 bytes' worth."""
    return tuple(st if n > 1 else 16 // t.element_size()
                 for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` (a source, or one of its :data:`INSTANCES`)
    on ``device``'s current stream (appended as the last argument) and
    count it under ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name.split("[")[0])(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
