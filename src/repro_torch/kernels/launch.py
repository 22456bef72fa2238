"""What every kernel wrapper shares: input checks, the ctypes binding of
each kernel's C entry point, and the launch counts.

A wrapper checks device, dtype, shape and contiguity of its tensors with
:func:`check`, then calls :func:`launch`, which calls the kernel's C
function (it launches on the stream it is given and returns a
``cudaError_t``), raises if that is not 0, and adds one to
``LAUNCHES[<kernel name>]``.  Nothing else touches the counts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Union

import torch

from repro_torch.kernels.build import SOURCES, load

# instantiations counted apart from the source's own name: "<source>[x]"
# launches the library of <source> and counts under its own key
INSTANCES = ("l2dist_wgmma[d>128]", "l2dist_wgmma[bf16]",
             "l2dist_wgmma[bf16,off16]", "l2dist_wgmma[bf16,d>128]",
             "flash_attn_fwd_wgmma[padded]", "flash_attn_fwd_tf32[padded]")
# kernel launches since the last reset_launches()
LAUNCHES = {name: 0 for name in (*SOURCES, *INSTANCES)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each C entry point's arguments; the last is always the stream
_SIGNATURES = {
    "adc_scan_batch": (_P, _P, _P) + (_I,) * 8 + (_P,),
    "adc_fused_topk": (_P,) * 6 + (_I,) * 12 + (_P,),
    "adc_scan": (_P, _P, _P) + (_I,) * 4 + (_P,),
    "adc_scan_topk": (_P,) * 4 + (_I,) * 7 + (_P,),
    "l2dist": (_P, _P, _P) + (_I,) * 3 + (_P,),
    "l2dist_wgmma": (_P,) * 4 + (_I,) * 5 + (_P,),
    "flash_attn_fwd": (_P,) * 4 + (_I,) * 7 + (_F, _I, _P),
    "flash_attn_fwd_wgmma": (_P,) * 4 + (_I,) * 6 + (_F, _I, _P),
    "flash_attn_fwd_tf32": (_P,) * 4 + (_I,) * 6 + (_F, _I, _P),
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
