"""Wrappers of the flash-attention kernels: the forward and its backward.

Two kernels, written in CUDA C++ for ``sm_90a``, port the Pallas
``flash_attention_fwd``; plain version ``ref.flash_attn_ref``:

* ``flash_attn_fwd_wgmma`` (``csrc/flash_attn_fwd_wgmma.cu``): bf16 on
  the tensor cores (``wgmma``, TMA);
* ``flash_attn_fwd_tf32`` (``csrc/flash_attn_fwd_tf32.cu``): f32 on the
  tensor cores in 3xTF32 (each operand split into a TF32 hi and lo part,
  three products: one TF32 product would break the f32 tolerance, three
  keep it).

Each kernel has instances named by the width of q and k (kDh, the K of
the Q K^T product) and of v (kDv, the N of the P V product): (64, 64),
(128, 128), (192, 128) and (256, 256) in both, and in f32 also (32, 32).
:func:`flash_plan` states the rule per dtype.  f32: q/k up to 32 wide
(so v too) runs on (32, 32), a narrow kernel of its own (a persistent
block of four consumer warpgroups takes a (batch, KV head) with up to
four 64-row q tiles of its query heads, and splits each 40-key K and V
tile once for all of them: BERT4Rec's two heads of 32); up to 64 on (64,
64), up to 128 on (128, 128), up to 192 with v at most 128 wide on (192,
128) (DeepSeek-V2's MLA prefill: q and k 192 wide, v 128), the rest on
(256, 256).  bf16: the same without (32, 32) (no model of the repo runs
bf16 at dh <= 32), so up to 64 on (64, 64).  The tensor maps take the
true widths as their inner extent, so TMA reads the columns past dh (q,
k) and dv (v) as zeros; the output is written at v's width.  TMA needs
every row stride on 16 bytes: a width off it (bf16 % 8 != 0, f32 % 4 !=
0) is copied into buffers zero-padded to the next multiple of 8 or 4
(zero columns add nothing to a score and give zero output columns, which
are cut off), with the scale of the true dh.  Above dh = 256 the card
has no kernel and the wrapper raises; the JAX package takes any width.

The wrapper takes what the JAX one takes: any real dtype for each of q,
k and v, mixed, and views.  ``launch.operand_dtype`` names the dtype the
kernel computes in (bf16 where all three are uint8, int8 or bf16; f32
otherwise).  The f32 kernel reads q, k and v through tensor maps at
their own strides, so a view passes as it lies where ``launch.tma_view``
says so (the last axis unit-stride, the other strides and the base on 16
bytes: the q, k and v split from one (B, S, 3H, dh) tensor); the bf16
kernel takes contiguous operands.  Any other input (another dtype, a
layout the kernel cannot read) is copied first.  It returns q's dtype, as
the JAX kernel does.
v may be narrower than q and k (dv < dh), as the JAX model's attention
takes it.

:func:`flash_schedule` gives each instance's launch on the bf16 kernel:
the threads of a block, the keys of a KV tile, the stages of the ring and
the dynamic shared memory.  Every block takes 128 query rows, 64 a
consumer warpgroup, and runs a loop after FlashAttention-3's (P V of
tile j - 1 issued with S of tile j; ping-pong turns of the two consumer
warpgroups).  The instances with v at most 128 wide add a producer
warpgroup (384 threads; ptxas then gives a thread 168 registers):
128-key tiles at (64, 64), 96 at the others.  (256, 256), whose O takes
128 registers a thread, runs the two consumer warpgroups alone (256
threads, up to 255 registers; the warp that releases a stage last
refills it) on 80-key tiles in a ring of two stages, 224 KB of shared
memory.

:func:`flash_kernel` names the kernel, :func:`flash_instance` the key a
launch is counted under: ``<kernel>[dv]`` where v is narrower than q;
else ``<kernel>[stride-pad]`` off the stride; on it ``<kernel>`` at dh 64
and 128, ``flash_attn_fwd_tf32[32]`` for f32 up to 32 (the narrow
instance), ``<kernel>[padded]`` at other widths up to 128,
``<kernel>[256]`` above 128.  The wrapper keeps the JAX
package's layout — q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv)
— and runs the plain version when its tensors lie on the CPU.  On CUDA
tensors it launches the kernel the plan names, or raises: it checks
device and shapes first and the ``cudaError_t`` after, allocates the
output with ``torch.empty``, launches on the current stream and counts
the launch in ``LAUNCHES[flash_instance(dtype, dh, dv)]``
(``repro_torch.kernels.launch``).  Ragged S and T need no padding: the
kernels mask their edge tiles.  With ``return_lse`` the kernel also
writes each row's natural-log logsumexp, (B, H, S) f32, the residual of
the backward; without it the kernel is passed a null pointer and writes
none.

The backward, :func:`flash_attention_bwd`, has no Pallas counterpart
(the reference's VJP is plain ``jnp``): ``flash_attn_bwd``
(``csrc/flash_attn_bwd.cu``, bf16 ``wgmma`` on operands split into bf16
terms, f32 sums; plain version ``ref.flash_attn_bwd_ref``) recomputes the
scores from the saved lse.  Its instances are named (kD, kDv) as the
forward's: (32, 32), (64, 64), (128, 128) and (192, 128), the last for
MLA's training (q/k 192, v 128).  :func:`flash_bwd_plan` names the
instance from the dtype, the widths and the number of keys T: f32 inputs
with q/k up to 32 wide over up to 256 keys run the narrow (32, 32)
instance, counted under ``flash_attn_bwd[32]`` (BERT4Rec's training
shape: one kernel of four warpgroups a (batch, KV head), its keys
resident, every input read once, S and dP formed once, dQ summed inside
the block; it reads q, k, v, out and dout at their own strides where
``launch.tma_view`` says so, so the encode's split q, k, v are not
copied, and takes no scratch); every other shape by the forward's rule
without its (32, 32) (q/k up to 64, up to 128, up to 192 with v up to
128; :func:`flash_bwd_width` raises ``ValueError`` past it, naming the
shape: (192, 192), (256, 256), a v wider than q), the widths padded to
multiples of 8, and the term count: bf16 inputs
(``launch.operand_dtype``) run the one-term instance, counted under
``flash_attn_bwd[bf16]``, which reads them as they are and writes bf16
gradients; every other dtype is copied to f32 (the reference's backward
computes in f32) and runs the three-term instance, counted under
``flash_attn_bwd``, with a scratch buffer for the terms; ``[dv]`` is
added to either key where v is narrower than q (``flash_attn_bwd[dv]``,
``flash_attn_bwd[bf16,dv]``).  One launch a call.
:func:`flash_bwd_schedule` gives each instance's launches: at (32, 32)
one kernel of 512 threads, 256 keys resident, two stages of 32 query
rows; one warpgroup a block at (64, 64) and (128, 128); at (192, 128)
two, parted by product (one forms S and P, the other dP and dS, P handed
over in shared memory), on 64-row streamed tiles in bf16 and 16-row in
f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attn.ref import (flash_attn_bwd_ref,
                                                flash_attn_ref)
from repro_torch.kernels.launch import (launch, operand, operand_dtype,
                                        tma_strides, tma_view)

_MAX_DH = 256                   # the kernels' widest instance
_INSTANCE_DH = (64, 128)        # instances taken without a [padded] key
_NARROW_DH = 32                 # f32's narrow instance, (32, 32)


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
    ``<kernel>[256]`` above 128 (the 256 instance),
    ``flash_attn_fwd_tf32[32]`` for f32 at dh <= 32 (the narrow (32, 32)
    instance), ``<kernel>[padded]`` at other widths than 64 and 128 (its
    columns past dh read as zeros up to the instance), else the kernel's
    name.  Raises ``ValueError`` where dv is not in 1 .. dh."""
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
    if dh <= _NARROW_DH and operand_dtype(dtype) == torch.float32:
        return f"{name}[32]"
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
    both kernels' C entry points, the widths taken after rounding to the
    row stride.  f32: q/k at most 32 wide (v at most as wide) -> (32, 32);
    at most 64 -> (64, 64); at most 128 -> (128, 128); at most 192 with v
    at most 128 -> (192, 128); else (256, 256).  bf16: the same without
    (32, 32), so q/k at most 64 wide -> (64, 64).  Raises ``ValueError``
    as :func:`flash_instance` does."""
    dv = dh if dv is None else dv
    key = flash_instance(dtype, dh, dv)
    dp, dvp = flash_width(dtype, dh), flash_width(dtype, dv)
    if dp <= _NARROW_DH and operand_dtype(dtype) == torch.float32:
        instance = (_NARROW_DH, _NARROW_DH)
    elif dp <= 64:
        instance = (64, 64)
    elif dp <= 128:
        instance = (128, 128)
    elif dp <= 192 and dvp <= 128:
        instance = (192, 128)
    else:
        instance = (256, 256)
    return FlashPlan(instance, (dp, dvp), key)


class FlashSchedule(NamedTuple):
    """The launch of one instance of the bf16 kernel: threads a block, keys
    a KV tile, stages of the KV ring, dynamic shared-memory bytes."""
    threads: int
    kv_tile: int
    stages: int
    smem: int


_INSTANCES = ((64, 64), (128, 128), (192, 128), (256, 256))
_BQ = 128                       # query rows a block
_MAX_STAGES = 4
SMEM_CAP = 227 * 1024           # shared memory a block may have on an H100


def flash_schedule(instance: Tuple[int, int]) -> FlashSchedule:
    """The launch of ``flash_attn_fwd_wgmma``'s (kDh, kDv) ``instance``
    (one of :func:`flash_plan`'s four for bf16): a producer warpgroup
    beside the two consumer warpgroups where kDv <= 128 (384 threads;
    128-key tiles
    at kDv = 64, 96-key at 128), the consumers alone at (256, 256) (256
    threads, 80-key tiles); as many stages as ``SMEM_CAP`` holds beside
    the 128-row q tile and 2 KB for the alignment and the barriers, at
    most 4; the dynamic shared memory (q tile, the ring, 1 KB to align
    it).  The kernel's ``Schedule`` computes the same numbers, and its
    ``flash_attn_fwd_wgmma_schedule`` reports them.  Raises
    ``ValueError`` for widths that name no instance."""
    if tuple(instance) not in _INSTANCES:
        raise ValueError(f"no instance {tuple(instance)}: the kernel has "
                         f"{_INSTANCES}")
    kdh, kdv = instance
    wide = kdv > 128
    tile = 80 if wide else 96 if kdv > 64 else 128
    stages = min(_MAX_STAGES, (SMEM_CAP - 2048 - _BQ * kdh * 2)
                 // (tile * (kdh + kdv) * 2))
    return FlashSchedule(256 if wide else 384, tile, stages,
                         (_BQ * kdh + stages * tile * (kdh + kdv)) * 2 + 1024)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be 4-d")
    b, _, h, dh = q.shape
    hk = k.shape[2]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh
            or hk < 1 or h % hk):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H % Hk == 0)")
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """GQA attention forward: q (B, S, H, dh), k (B, T, Hk, dh), v (B, T,
    Hk, dv) with dv <= dh, of any real dtypes -> (B, S, H, dv) in q's
    dtype, accumulated in f32.  ``scale`` defaults to 1/sqrt(dh);
    ``causal`` keeps key t for query s where s >= t, positions aligned at
    the top left.  With ``return_lse``, (out, lse): lse (B, H, S) f32,
    each row's natural-log logsumexp of its scaled scores."""
    if q.device.type == "cpu":
        return flash_attn_ref(q, k, v, causal=causal, scale=scale,
                              return_lse=return_lse)
    dev = q.device
    dtype = operand_dtype(q.dtype, k.dtype, v.dtype)
    _check_qkv(q, k, v)
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    plan = flash_plan(dtype, dh, dv)        # raises past dh = 256, dv > dh
    dp, dvp = plan.widths
    q_dtype = q.dtype
    operands = (("q", q, dp), ("k", k, dp), ("v", v, dvp))
    if dtype == torch.float32:
        # the f32 kernel reads a view at its own strides where TMA can
        q, k, v = (x if x.device == dev and tma_view(x, dtype, wd)
                   else operand(nm, x, dtype, 4, wd, dev)
                   for nm, x, wd in operands)
        strides = [st for x in (q, k, v) for st in tma_strides(x)]
    else:
        q, k, v = (operand(nm, x, dtype, 4, wd, dev)
                   for nm, x, wd in operands)
        strides = []
    out = torch.empty(b, s, h, dvp, dtype=dtype, device=dev)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=dev)
           if return_lse else None)
    if b and s and h:
        scale = scale if scale is not None else 1.0 / math.sqrt(dh)
        launch(plan.key, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), 0 if lse is None else lse.data_ptr(),
               b, s, t, h, hk, dp, dvp, scale, int(causal), *strides)
    if dvp != dv:
        out = out[..., :dv]
    out = out.to(q_dtype).contiguous()
    return (out, lse) if return_lse else out


_BWD_INSTANCES = ((64, 64), (128, 128), (192, 128))   # (kD, kDv)
_BWD_MAX_DH = 192
_BWD_NARROW_T = 256             # the narrow instance's keys, all resident
BWD_KEY = "flash_attn_bwd"
BWD_BF16_KEY = "flash_attn_bwd[bf16]"
BWD_DV_KEY = "flash_attn_bwd[dv]"
BWD_BF16_DV_KEY = "flash_attn_bwd[bf16,dv]"
BWD_NARROW_KEY = "flash_attn_bwd[32]"


def flash_bwd_width(dh: int, dv: Optional[int] = None) -> Tuple[int, int]:
    """The widths the backward kernel is passed for q and k ``dh`` wide and
    v ``dv`` wide (``dh`` when None): each rounded up to a multiple of 8,
    the row stride of 16 bytes of its bf16 operands.  Raises
    ``ValueError`` where it has no instance, naming the shape: q/k outside
    1 .. 192, v outside 1 .. dh, or q/k past 128 with v past 128 (e.g.
    (192, 192), (256, 256))."""
    dv = dh if dv is None else dv
    if not 1 <= dh <= _BWD_MAX_DH:
        raise ValueError(f"head width {dh}: the backward kernel takes 1 <= "
                         f"dh <= {_BWD_MAX_DH}")
    if not 1 <= dv <= dh:
        raise ValueError(f"v width {dv} with q/k width {dh}: the backward "
                         f"kernel takes 1 <= dv <= dh")
    w, wv = -(-dh // 8) * 8, -(-dv // 8) * 8
    if not any(w <= a and wv <= b for a, b in _BWD_INSTANCES):
        raise ValueError(f"(dh, dv) = ({dh}, {dv}): no backward instance "
                         f"(kD, kDv) in {_BWD_INSTANCES} holds it")
    return w, wv


class BwdPlan(NamedTuple):
    """What :func:`flash_attention_bwd` launches: the ``LAUNCHES`` key, the
    instance (kD, kDv), the widths of q/k and of v the kernel is passed,
    and the bf16 terms each of q, k, v and dO is split into (the kernel's
    kTerms; P and dS always take three)."""
    key: str
    instance: Tuple[int, int]
    widths: Tuple[int, int]
    terms: int


def flash_bwd_plan(dtype: torch.dtype, dh: int, dv: Optional[int] = None,
                   t: Optional[int] = None) -> BwdPlan:
    """The backward instance for inputs computing in ``dtype``
    (``launch.operand_dtype``) with q and k ``dh`` wide, v ``dv`` wide
    (``dh`` when None) and ``t`` keys (None: any number), by the rule of
    the kernel's C entry point.  Inputs computing in f32 with q/k at most
    32 wide over at most 256 keys -> the narrow instance (32, 32),
    key ``flash_attn_bwd[32]`` whatever v's width: one kernel keeps a
    (batch, KV head)'s keys resident and forms dQ, dK and dV from each
    input read once.  Otherwise the forward's rule without its (32, 32):
    q/k at most 64 wide -> (64, 64); at most 128 -> (128, 128); at most
    192 with v at most 128 -> (192, 128), the widths :func:`flash_bwd_width`
    gives (a v narrower than the instance read as zero columns).  bf16
    (inputs exact in bf16) -> one term, key ``flash_attn_bwd[bf16]``;
    anything else -> f32 in three terms, key ``flash_attn_bwd``; ``[dv]``
    added (``flash_attn_bwd[dv]``, ``flash_attn_bwd[bf16,dv]``) where v is
    narrower than q, as :func:`flash_instance` names the forward's.
    Raises ``ValueError`` as :func:`flash_bwd_width` does."""
    dv = dh if dv is None else dv
    w, wv = flash_bwd_width(dh, dv)
    bf16 = operand_dtype(dtype) == torch.bfloat16
    if (not bf16 and w <= _NARROW_DH and t is not None
            and t <= _BWD_NARROW_T):
        return BwdPlan(BWD_NARROW_KEY, (_NARROW_DH, _NARROW_DH), (w, wv), 3)
    if dv != dh:
        key = BWD_BF16_DV_KEY if bf16 else BWD_DV_KEY
    else:
        key = BWD_BF16_KEY if bf16 else BWD_KEY
    instance = next(i for i in _BWD_INSTANCES if w <= i[0] and wv <= i[1])
    return BwdPlan(key, instance, (w, wv), 1 if bf16 else 3)


class BwdSchedule(NamedTuple):
    """The launch of one kernel of the backward: threads a block, rows a
    block (keys in the dK/dV pass, queries in the dQ pass), rows of a
    streamed tile, stages of the ring, dynamic shared-memory bytes."""
    threads: int
    rows: int
    streamed: int
    stages: int
    smem: int


class BwdLaunch(NamedTuple):
    """The launches of a backward instance: its dK/dV and its dQ kernel
    (the narrow instance's one kernel in both)."""
    dkdv: BwdSchedule
    dq: BwdSchedule


_BWD_ROWS = 64                  # keys or queries a block
SMEM_HALF = 113 * 1024          # a block's share where two fit an SM
_NARROW_STAGE = 32              # query rows of a narrow stage
_NARROW_STAGES = 2              # its stage buffers


def _narrow_smem() -> int:
    """The narrow kernel's dynamic shared memory: K and V in three bf16
    terms at 256 keys x 32 columns, two stages of Q's and dO's terms (32
    rows), the four warpgroups' dS^T terms (64 keys x 32 queries), two sets
    of their f32 dQ partials (32 x 32), two stages' lse2 and D (32 f32
    each), 1 KB to align them."""
    kv = 2 * 3 * _BWD_NARROW_T * _NARROW_DH * 2
    stages = _NARROW_STAGES * 2 * 3 * _NARROW_STAGE * _NARROW_DH * 2
    ds = 4 * 3 * _BWD_ROWS * _NARROW_STAGE * 2
    parts = 2 * 4 * _NARROW_STAGE * _NARROW_DH * 4
    rows = _NARROW_STAGES * 2 * _NARROW_STAGE * 4
    return kv + stages + ds + parts + rows + 1024


def flash_bwd_schedule(instance: Tuple[int, int], terms: int) -> BwdLaunch:
    """The launches of ``flash_attn_bwd``'s (kD, kDv) ``instance`` with
    ``terms`` bf16 terms of q, k, v and dO (:func:`flash_bwd_plan`'s).
    (32, 32), three terms only: one kernel of four warpgroups (512
    threads), 256 keys resident, two stages of 32 query rows, on a grid of
    one block an SM (the same launch in both fields).  Otherwise each block
    keeps 64 rows of one pair of tensors resident (K and V, or Q and dO,
    ``terms`` planes each) and streams the other pair through a ring.
    (64, 64) and (128, 128): one warpgroup (128 threads), 32-row
    tiles; in f32 as many stages as ``SMEM_CAP`` holds beside the
    resident tiles and 2 KB, in bf16 as many as ``SMEM_HALF`` holds (two
    blocks an SM), and the bf16 dQ pass two stages (three blocks an SM);
    at most 4.  (192, 128): two warpgroups (256 threads), the widest of
    64, 32 and 16 streamed rows at which two stages fit beside the
    resident tiles, the 64 x n f32 hand-off between the warpgroups, 1 KB
    of alignment and 2 KB (64 in bf16, 16 in f32), and as many stages as
    then fit, at most 4, for both passes.  Dynamic shared memory: the
    resident tiles, the ring, the hand-off, 1 KB to align them.  The
    kernel's ``Schedule`` computes the same numbers, and its
    ``flash_attn_bwd_schedule`` reports them.  Raises ``ValueError`` for
    an instance or a term count the kernel does not have."""
    if terms not in (1, 3):
        raise ValueError(f"{terms} terms: the backward takes 1 or 3")
    if tuple(instance) == (_NARROW_DH, _NARROW_DH):
        if terms != 3:
            raise ValueError("the narrow backward instance (32, 32) takes "
                             "three terms (f32 inputs)")
        one = BwdSchedule(512, _BWD_NARROW_T, _NARROW_STAGE, _NARROW_STAGES,
                          _narrow_smem())
        return BwdLaunch(one, one)
    if tuple(instance) not in _BWD_INSTANCES:
        raise ValueError(f"no backward instance {tuple(instance)}: the "
                         f"kernel has {((32, 32),) + _BWD_INSTANCES}")
    kd, kdv = instance
    res = terms * (kd + kdv) * _BWD_ROWS * 2       # bf16 terms

    def stage(n):
        return terms * (kd + kdv) * n * 2

    if kd > 128:
        def hand(n):
            return _BWD_ROWS * n * 4

        n = next(n for n in (64, 32, 16) if res + 2 * stage(n) + hand(n)
                 + 1024 + 2048 <= SMEM_CAP)
        stages = min(_MAX_STAGES, (SMEM_CAP - 2048 - res - hand(n) - 1024)
                     // stage(n))
        one = BwdSchedule(256, _BWD_ROWS, n, stages,
                          res + stages * stage(n) + hand(n) + 1024)
        return BwdLaunch(one, one)
    n = 32
    cap = SMEM_HALF if terms == 1 else SMEM_CAP
    stages = min(_MAX_STAGES, (cap - 2048 - res) // stage(n))
    stages_q = 2 if terms == 1 else stages
    return BwdLaunch(*(BwdSchedule(128, _BWD_ROWS, n, st,
                                   res + st * stage(n) + 1024)
                       for st in (stages, stages_q)))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        scale: Optional[float] = None, q_offset: int = 0,
                        block_size: int = 512):
    """The attention VJP: from q (B, S, H, dh), k (B, T, Hk, dh) and v (B,
    T, Hk, dv), the forward's output ``out`` and ``lse`` (B, H, S) f32 (its
    ``return_lse``) and the output's gradient ``dout`` (B, S, H, dv) ->
    (dq, dk, dv), each in its input's dtype.  CPU tensors run
    ``ref.flash_attn_bwd_ref`` (KV blocks of ``block_size``, queries at
    ``q_offset``); CUDA tensors launch ``flash_attn_bwd``, which takes
    ``q_offset == 0`` and the shapes :func:`flash_bwd_width` takes, and
    raises ``ValueError`` on any other (it tiles the keys on its own:
    ``block_size`` is not read); the instance is :func:`flash_bwd_plan`'s
    for the dtype q, k, v, out and dout compute in, their widths and T.
    The narrow instance reads q, k, v, out and dout as they lie where
    ``launch.tma_view`` takes them and copies the others."""
    if q.device.type == "cpu":
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                  scale=scale, q_offset=q_offset,
                                  block_size=block_size)
    if q_offset != 0:
        raise ValueError(f"q_offset={q_offset}: the backward kernel takes "
                         f"queries at offset 0 only")
    dev = q.device
    _check_qkv(q, k, v)
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    dtype = operand_dtype(q.dtype, k.dtype, v.dtype, out.dtype, dout.dtype)
    plan = flash_bwd_plan(dtype, dh, dv, t)
    w, wv = plan.widths
    if tuple(out.shape) != (b, s, h, dv) or tuple(dout.shape) != (b, s, h,
                                                                    dv):
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be {(b, s, h, dv)}")
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse {tuple(lse.shape)} must be {(b, h, s)}")
    dt = torch.bfloat16 if plan.terms == 1 else torch.float32
    narrow = plan.key == BWD_NARROW_KEY
    operands = (("q", q, w), ("k", k, w), ("v", v, wv), ("out", out, wv),
                ("dout", dout, wv))
    # the narrow instance reads a view at its own strides where it can
    ops = [x if narrow and x.device == dev and tma_view(x, dt, wd)
           else operand(nm, x, dt, 4, wd, dev) for nm, x, wd in operands]
    strides = [st for x in ops for st in tma_strides(x)]
    lse = operand("lse", lse, torch.float32, 3, s, dev)
    dq = torch.empty(b, s, h, w, dtype=dt, device=dev)
    dk = torch.empty(b, t, hk, w, dtype=dt, device=dev)
    dvv = torch.empty(b, t, hk, wv, dtype=dt, device=dev)
    # D and the three-term planes (q, k at w, dO, v at wv, three bf16
    # terms each) of the (64, 64) and wider instances; the narrow one
    # forms both in shared memory
    delta = (None if narrow else
             torch.empty(b, h, s, dtype=torch.float32, device=dev))
    scratch = (torch.empty(3 * (b * s * h + b * t * hk) * (w + wv),
                           dtype=torch.bfloat16, device=dev)
               if plan.terms == 3 and not narrow else None)
    if b and s and h:
        scale = scale if scale is not None else 1.0 / math.sqrt(dh)
        launch(plan.key, dev, *(x.data_ptr() for x in ops), lse.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
               *(0 if x is None else x.data_ptr() for x in (delta, scratch)),
               b, s, t, h, hk, w, wv, scale, int(causal), plan.terms,
               *strides)
    grads = []
    for g, x in ((dq, q), (dk, k), (dvv, v)):
        g = g[..., :x.shape[-1]] if g.shape[-1] != x.shape[-1] else g
        grads.append(g.to(x.dtype).contiguous())
    return tuple(grads)
