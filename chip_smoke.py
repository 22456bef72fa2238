#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` (FusionANNS on PyTorch + CUDA) on one GPU.

    python3 chip_smoke.py [--n 10000000] [--queries 256] [--seed 0]

From the root of a checkout, with one CUDA card:

1. prints the card's name and power limit, builds the eight CUDA kernels
   from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source, in
   parallel), prints the build time and each ``ptxas`` register/spill line;
2. holds each kernel against its plain PyTorch version on the card at
   small shapes: the ADC scans at ragged N, B = 1 and 64, S not a multiple
   of the block, all-pad rows, a mostly-padding last block, N < topk,
   constructed ties, M in {8, 32}; exact L2 in f32 (both kernels of
   ``l2_kernel``'s rule: d in {1, 4, 36, 96, 100, 128}, a view off a
   16-byte boundary, integer data bit for bit) and bf16; flash attention
   in f32 and bf16, ragged sizes, MQA (Hk = 1), causal and not, S != T;
3. builds a SIFT1B-width index (dim 128 uint8, M = 32, K = 256) over
   ``--n`` clustered vectors drawn from ``--seed`` through the public
   ``FusionANNSIndex.build``, and prints the cuts of scale on a
   ``reduced`` line with each build stage's time;
4. computes exact ground truth through the ``l2dist_wgmma`` kernel
   (``ground_truth``, chunks of 2^20 rows, f32 at d = 128) and once more
   through its plain version, and fails unless it launched that kernel and
   the ids are identical for every query (on uint8 data every partial sum
   is an integer below 2^24, so both are exact); serves ``--queries`` queries through three paths — the dense
   window (``window=64``), ``fused=True`` and ``fused=True,
   lut_int8=True`` — each with the launch counts set to 0 just before it
   and read just after, and prints recall@10 against the ground truth, QPS
   and p50/p99; it fails unless dense and fused f32 give identical ids for
   every query, f32 recall > 0.5, int8 recall >= f32 recall - 0.05, and
   each path launched its kernel;
5. drives the kernel entry points at full width, counts set to 0 just
   before: ``pq_adc`` and ``pq_adc_topk(topk=top_n)`` over the index's
   codes with the LUTs of the first 8 queries (top-k ids must equal the
   first top_n of a stable argsort of ``pq_adc``), ``l2_distances`` on the
   first ground-truth chunk in f32 and once in bf16, and
   ``flash_attention`` at Qwen3-0.6B's attention widths (H = 16, Hk = 8,
   dh = 128), B = 1, S = T = 4096, causal, in bf16 and once in f32; each
   against its plain version; it fails unless the f32 L2 call launched
   ``l2dist_wgmma`` and the bf16 one ``l2dist``, and the bf16 flash call
   ``flash_attn_fwd_wgmma`` (tensor cores) and the f32 one
   ``flash_attn_fwd`` (CUDA cores);
6. holds each kernel against its plain version on the inputs its path
   gave it, and times kernel, plain version and (where one exists) a
   single PyTorch call computing the same function, with CUDA events,
   beside the least time the card could take.

Flash attention is held to its plain version elementwise (2e-5 in f32,
5e-2 in bf16) and, in bf16, row by row: each (b, s, h) row's L2 error
within 2^-6 of its L2 norm (``check_attn``).

The second-to-last line is a JSON object ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero and prints no result.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # float32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 on the tensor cores
BF16_FLOPS = 989e12              # dense bf16 on the tensor cores
RTOL = 1e-5                      # M f32 terms summed in another order
L2_ATOL = 1e-3                   # D products summed in another order
FLASH_TOL = {torch.float32: 2e-5,    # online softmax against a plain one
             torch.bfloat16: 5e-2}   # output rounded to bf16 on each side
# bf16 flash, also: each (b, s, h) row's L2 error within 2^-6 of the row's
# L2 norm.  A sound kernel differs by its P rounded to bf16 (at most 2^-8
# of a row's weight) and one final rounding; long rows' outputs are small
# (|o| ~ sqrt(e / (s + 1))), so an elementwise limit alone misses a wrong
# K/V tile there, but it moves the row by a large share of its norm.
FLASH_ROW_RTOL = 2.0 ** -6
WINDOW = 64
QWEN3_ATTN = dict(H=16, Hk=8, dh=128)    # src/repro/configs/qwen3_0_6b.py
ATTN_LEN = 4096                          # S = T of the full-width flash run
PQ_SRC = "src/repro_torch/kernels/pq_adc/csrc/"
PQ_TPU = "src/repro/kernels/pq_adc/pq_adc.py:"
FLASH_SRC = "src/repro_torch/kernels/flash_attn/csrc/"
L2_SRC = "src/repro_torch/kernels/l2dist/csrc/"
KERNELS = {
    "adc_scan_batch": dict(route="cuda", source=PQ_SRC + "adc_scan_batch.cu",
                           replaces=PQ_TPU + "80"),
    "adc_fused_topk": dict(route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
                           replaces=PQ_TPU + "239"),
    "adc_fused_topk[lut_int8]": dict(
        route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
        replaces=PQ_TPU + "177"),
    "adc_scan": dict(route="cuda", source=PQ_SRC + "adc_scan.cu",
                     replaces=PQ_TPU + "43"),
    "adc_scan_topk": dict(route="cuda", source=PQ_SRC + "adc_scan_topk.cu",
                          replaces=PQ_TPU + "133"),
    "l2dist_wgmma": dict(route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
                         replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist": dict(route="cuda", source=L2_SRC + "l2dist.cu",
                   replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "flash_attn_fwd_wgmma": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
}


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------- comparison
def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                got_ids=None, want_ids=None) -> float:
    """Distances to RTOL (inf where inf); ids equal except inside runs of
    distances that tie within RTOL.  Returns the max abs error."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
    fin = np.isfinite(w)
    if not np.array_equal(fin, np.isfinite(g)):
        raise AssertionError(f"{name}: +inf slots differ")
    if not np.allclose(g[fin], w[fin], rtol=RTOL, atol=0):
        raise AssertionError(f"{name}: distances differ beyond rtol {RTOL}")
    err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
    if got_ids is not None:
        gi, wi = got_ids.cpu().numpy(), want_ids.cpu().numpy()
        diff = gi != wi
        tie = np.zeros_like(diff)
        if w.shape[-1] > 1:
            eq = np.isclose(w[..., 1:], w[..., :-1], rtol=RTOL, atol=0)
            tie[..., 1:] |= eq
            tie[..., :-1] |= eq
        if (diff & ~tie).any():
            raise AssertionError(f"{name}: ids differ outside distance ties")
    return err


def check_tol(name: str, got: torch.Tensor, want: torch.Tensor,
              rtol: float, atol: float) -> float:
    """Values within rtol/atol (compared in f32); returns the max abs
    error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max abs error {err} beyond rtol "
                             f"{rtol}, atol {atol}")
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest L2 error of a last-axis row over that row's L2 norm."""
    g, w = got.float(), want.float()
    err = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return float(err.max()) if err.numel() else 0.0


def check_attn(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Flash attention against its plain version: every element within
    FLASH_TOL of its dtype and, in bf16, every (b, s, h) row within
    FLASH_ROW_RTOL; returns the max abs error."""
    tol = FLASH_TOL[want.dtype]
    err = check_tol(name, got, want, tol, tol)
    if want.dtype == torch.bfloat16:
        row = row_rel_err(got, want)
        if row > FLASH_ROW_RTOL:
            raise AssertionError(f"{name}: a row's relative L2 error {row} "
                                 f"beyond {FLASH_ROW_RTOL}")
    return err


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up.
    The card first spins for about 20 ms, so the host has queued the runs
    before the start event and the events time the device, not the
    host's launches."""
    fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2
def check_kernels_small(dev: torch.device, rng: np.random.Generator) -> None:
    from repro_torch.kernels.pq_adc import ops, ref
    for m in (8, 32):
        k, dsub = 256, 4
        cb = torch.from_numpy(rng.standard_normal((m, k, dsub)).astype(
            np.float32)).to(dev)
        for n in (1, 777, 8192 + 13, 3 * 8192 + 5):
            codes = torch.from_numpy(rng.integers(0, 256, (n, m)).astype(
                np.uint8)).to(dev)
            # a 1-byte storage offset exercises the byte-load path too
            flat = torch.empty(n * m + 1, dtype=torch.uint8, device=dev)
            flat[1:] = codes.reshape(-1)
            for cds in (codes, flat[1:].view(n, m)):
                for b in (1, 64):
                    q = torch.from_numpy(rng.standard_normal(
                        (b, m * dsub)).astype(np.float32)).to(dev)
                    luts = ref.build_luts_ref(cb, q)
                    check_close(f"adc_scan_batch m{m} n{n} b{b}",
                                ops.pq_adc_batch(cds, luts),
                                ref.pq_adc_batch_ref(cds, luts))
                    mask = torch.from_numpy(rng.random((b, n)) < 0.3).to(dev)
                    kv, ki = ops.pq_adc_topk_batch(cds, luts, 100, mask=mask)
                    d = ref.pq_adc_batch_ref(cds, luts).masked_fill(
                        ~mask, torch.inf)
                    pv, pi = torch.sort(d, dim=1, stable=True)
                    check_close(f"masked top-k m{m} n{n} b{b}", kv,
                                pv[:, :100], ki, pi[:, :100])
        # fused: ragged S, all-pad rows, exact ties from duplicate code rows
        n = 50_000
        base = rng.integers(0, 256, (n // 4, m)).astype(np.uint8)
        codes = torch.from_numpy(np.repeat(base, 4, axis=0)).to(dev)
        for b, s, topk in ((1, 3000, 10), (64, 5000, 512), (64, 2048, 3000),
                           (5, 37, 512)):
            rows = np.full((b, s), -1, np.int32)
            for i in range(b - 1 if b > 1 else b):   # last row all pads
                c = int(rng.integers(1, s + 1))
                rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
            rows_t = torch.from_numpy(rows).to(dev)
            q = torch.from_numpy(rng.standard_normal((b, m * dsub)).astype(
                np.float32)).to(dev)
            for int8 in (False, True):
                kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows_t, topk,
                                               lut_int8=int8)
                pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows_t,
                                                     topk, lut_int8=int8)
                check_close(f"adc_fused_topk m{m} b{b} s{s} k{topk} "
                            f"int8={int8}", kv, pv, ki, pi)
                if not torch.equal(ki, pi):
                    raise AssertionError("fused ids differ on exact ties")
    torch.cuda.synchronize()


def check_l2_small(dev: torch.device, rng: np.random.Generator) -> None:
    """Both exact-L2 kernels against the plain version: each call must
    launch the kernel ``l2_kernel`` names, and only it."""
    from repro_torch.kernels.l2dist import l2_distances, l2_kernel, l2dist_ref
    from repro_torch.kernels.pq_adc import ops

    def run(name, q, v, exact=False):
        before = dict(ops.LAUNCHES)
        got = l2_distances(q, v)
        torch.cuda.synchronize()
        ran = {k for k, c in ops.LAUNCHES.items() if c != before[k]}
        want = l2_kernel(q.dtype, q.shape[1])
        if ran != {want}:
            raise AssertionError(f"{name} launched {sorted(ran)}, not {want}")
        if exact and not torch.equal(got, l2dist_ref(q, v)):
            raise AssertionError(f"{name}: not bit-equal on integer data")
        check_tol(name, got, l2dist_ref(q, v), RTOL, L2_ATOL)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        # f32 at d 1, 102, 132 and 960 on l2dist.cu, the rest on wgmma
        for b, n, d in ((1, 1, 1), (3, 777, 100), (129, 1000, 128),
                        (256, 5003, 96), (1, 5003, 4), (130, 777, 36),
                        (3, 777, 102), (129, 1000, 132), (5, 5003, 960)):
            run(f"l2dist {dtype} b{b} n{n} d{d}", normal(b, d).to(dtype),
                normal(n, d).to(dtype))
    # views off a 16-byte boundary, copied before the TMA loads
    flat = normal(3 * 100 + 1)
    run("l2dist f32 unaligned view", flat[1:].view(3, 100),
        normal(777, 100))
    # integer data: every partial sum is exact, so equal bit for bit
    # (at d 132, on l2dist.cu, still below 2^24: 132 * 255^2)
    for d in (128, 132):
        ints = [torch.from_numpy(rng.integers(0, 256, shape).astype(
            np.float32)).to(dev) for shape in ((37, d), (3001, d))]
        run(f"l2dist f32 integers d{d}", *ints, exact=True)


def check_entry_kernels_small(dev: torch.device,
                              rng: np.random.Generator) -> None:
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.pq_adc import ops, ref
    for m in (8, 32):
        # ragged N, N < topk, a mostly-padding last block (2048 + 7 rows),
        # topk above the 2048-row block; every code row three times, so
        # distances tie exactly and ids must come out lowest row first
        for n, topk in ((1, 10), (5, 512), (777, 512), (2048 + 7, 32),
                        (3 * 2048 + 5, 2048), (50_000, 4000)):
            base = rng.integers(0, 256, (-(-n // 3), m)).astype(np.uint8)
            codes = torch.from_numpy(np.repeat(base, 3, axis=0)[:n]).to(dev)
            flat = torch.empty(n * m + 1, dtype=torch.uint8, device=dev)
            flat[1:] = codes.reshape(-1)
            lut = torch.from_numpy(rng.random((m, 256)).astype(
                np.float32)).to(dev)
            # a 1-byte storage offset exercises the byte-load path too
            for cds in (codes, flat[1:].view(n, m)):
                check_close(f"adc_scan m{m} n{n}", ops.pq_adc(cds, lut),
                            ref.pq_adc_ref(cds, lut))
                kv, ki = ops.pq_adc_topk(cds, lut, topk)
                pv, pi = ops.pq_adc_topk_plain(cds, lut, topk)
                check_close(f"adc_scan_topk m{m} n{n} k{topk}", kv, pv, ki,
                            pi)
                if not torch.equal(ki, pi):
                    raise AssertionError("adc_scan_topk ids differ on exact "
                                         "ties")
    check_l2_small(dev, rng)
    for dtype in (torch.float32, torch.bfloat16):
        # MQA (Hk = 1), causal and not, S != T both ways, ragged tiles
        for bsz, s, t, h, hk, dh, causal in (
                (2, 16, 16, 4, 2, 8, True), (1, 32, 32, 2, 2, 16, False),
                (2, 100, 100, 6, 3, 64, True), (1, 24, 24, 4, 1, 8, True),
                (1, 70, 130, 4, 2, 128, True), (1, 130, 70, 4, 4, 128, True),
                (1, 257, 257, 8, 1, 128, False)):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype) for shape in (
                    (bsz, s, h, dh), (bsz, t, hk, dh), (bsz, t, hk, dh)))
            check_attn(f"flash_attention {dtype} {(bsz, s, t, h, hk, dh)} "
                       f"causal={causal}",
                       flash_attention(q, k, v, causal=causal),
                       flash_attn_ref(q, k, v, causal=causal))
    torch.cuda.synchronize()


# ------------------------------------------------------------- phase 3/4
def make_data(n: int, n_queries: int, seed: int):
    from repro_torch.data.synthetic import clustered_vectors
    rng = np.random.default_rng(seed)
    allv = clustered_vectors(rng, n + n_queries, 128,
                             n_clusters=max(8, n // 500), dtype=np.uint8,
                             chunk=1 << 20)
    return allv[:n], allv[n:].astype(np.float32)


class Recorder:
    """Keeps the inputs of the first call of each kernel wrapper while
    the main path runs, so phase 6 can hold the kernels against their
    plain versions at the shapes the main path gave them."""

    def __init__(self):
        from repro_torch.core import distributed
        from repro_torch.kernels.pq_adc import ops
        self.ops, self.dist = ops, distributed
        self.calls = {}
        self._orig = (ops.pq_adc_batch, distributed.pq_adc_fused_topk)

    def __enter__(self):
        batch, fused = self._orig

        def rec_batch(codes, luts):
            self.calls.setdefault("adc_scan_batch", (codes, luts))
            return batch(codes, luts)

        def rec_fused(codes, queries, codebooks, rows, topk, *, lut_int8):
            key = "adc_fused_topk" + ("[lut_int8]" if lut_int8 else "")
            self.calls.setdefault(key, (codes, queries, codebooks, rows,
                                        topk))
            return fused(codes, queries, codebooks, rows, topk,
                         lut_int8=lut_int8)

        self.ops.pq_adc_batch = rec_batch
        self.dist.pq_adc_fused_topk = rec_fused
        return self

    def __exit__(self, *exc):
        self.ops.pq_adc_batch, self.dist.pq_adc_fused_topk = self._orig


def serve(index, queries: np.ndarray, gt: np.ndarray, **plan):
    from repro_torch.core.engine import recall_at_k
    lat = np.zeros(len(queries))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticket = index.submit(queries, window=WINDOW, inflight_depth=2, **plan)
    for i, f in enumerate(ticket.futures):
        f.add_done_callback(
            lambda _f, i=i: lat.__setitem__(i, time.perf_counter() - t0))
    res = ticket.results()
    wall = time.perf_counter() - t0
    ids = np.stack([r.ids for r in res])
    return ids, dict(recall_at_10=recall_at_k(ids, gt, 10),
                     qps=len(queries) / wall,
                     p50_ms=1e3 * float(np.percentile(lat, 50)),
                     p99_ms=1e3 * float(np.percentile(lat, 99)),
                     candidates_scanned_mean=float(np.mean(
                         [r.stats.candidates_scanned for r in res])))


def ground_truth_plain(data: np.ndarray, queries: np.ndarray,
                       k: int) -> np.ndarray:
    """``ground_truth`` with its distance blocks from the plain version
    of the ``l2dist`` kernel."""
    from repro_torch.core import engine
    from repro_torch.kernels.l2dist.ref import l2dist_ref
    kernel = engine.l2_distances
    engine.l2_distances = l2dist_ref
    try:
        return engine.ground_truth(data, queries, k)
    finally:
        engine.l2_distances = kernel


# ---------------------------------------------------------------- phase 5
def drive_entry_points(index, top_n: int, data: np.ndarray,
                       queries: np.ndarray, seed: int):
    """The kernel entry points at full width, launch counts set to 0 just
    before and read just after; then each output against its plain
    version.  Returns (launches, the inputs for phase 6)."""
    from repro_torch.core.pq import adc_lut_batch
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    from repro_torch.kernels.pq_adc import ops, ref
    dev = index.device
    codes = index.codes
    luts = adc_lut_batch(index.codebook, torch.from_numpy(queries[:8]).to(
        dev))
    q = torch.from_numpy(queries).to(dev)
    chunk = torch.from_numpy(np.ascontiguousarray(data[:1 << 20])).to(
        dev).float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = ATTN_LEN
    attn = {dtype: tuple(torch.randn(shape, generator=gen, device=dev).to(
        dtype) for shape in ((1, s, QWEN3_ATTN["H"], QWEN3_ATTN["dh"]),
                             (1, s, QWEN3_ATTN["Hk"], QWEN3_ATTN["dh"]),
                             (1, s, QWEN3_ATTN["Hk"], QWEN3_ATTN["dh"])))
        for dtype in (torch.bfloat16, torch.float32)}
    q16, chunk16 = q.bfloat16(), chunk.bfloat16()
    torch.cuda.synchronize()

    ops.reset_launches()
    dists = [ops.pq_adc(codes, luts[i]) for i in range(len(luts))]
    tops = [ops.pq_adc_topk(codes, luts[i], top_n) for i in range(len(luts))]
    d2, l2_ran = {}, {}
    for dtype, qv in ((torch.float32, (q, chunk)),
                      (torch.bfloat16, (q16, chunk16))):
        before = dict(ops.LAUNCHES)
        d2[dtype] = l2_distances(*qv)
        l2_ran[dtype] = {name for name, c in ops.LAUNCHES.items()
                         if c != before[name]}
    outs, flash_ran = {}, {}
    for dtype, qkv in attn.items():
        before = dict(ops.LAUNCHES)
        outs[dtype] = flash_attention(*qkv, causal=True)
        flash_ran[dtype] = {name for name, c in ops.LAUNCHES.items()
                            if c != before[name]}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for what, ran, dtype, want in (
            ("l2_distances", l2_ran, torch.float32, "l2dist_wgmma"),
            ("l2_distances", l2_ran, torch.bfloat16, "l2dist"),
            ("flash_attention", flash_ran, torch.bfloat16,
             "flash_attn_fwd_wgmma"),
            ("flash_attention", flash_ran, torch.float32, "flash_attn_fwd")):
        if ran[dtype] != {want}:
            raise AssertionError(f"{what} in {dtype} launched "
                                 f"{sorted(ran[dtype])}, not {want}")

    for i, (d, (tv, ti)) in enumerate(zip(dists, tops)):
        check_close(f"adc_scan query {i} at N={len(codes)}", d,
                    ref.pq_adc_ref(codes, luts[i]))
        order = torch.sort(d, stable=True)[1][:top_n]
        if not (torch.equal(ti.long(), order) and torch.equal(tv, d[order])):
            raise AssertionError(f"pq_adc_topk query {i}: not the first "
                                 f"{top_n} of a stable argsort of pq_adc")
    for dtype, qv in ((torch.float32, (q, chunk)),
                      (torch.bfloat16, (q16, chunk16))):
        err = check_tol(f"l2_distances {dtype} on the first ground-truth "
                        f"chunk", d2[dtype], l2dist_ref(*qv), RTOL, L2_ATOL)
        log(f"l2_distances {dtype} on the first ground-truth chunk: max abs "
            f"error {err}")
    del d2
    # the chunk's integers leave every lo part 0, so hold the cross
    # products (hi*lo, lo*hi) at full width on normal values of its shape
    qn, vn = (torch.randn(x.shape, generator=gen, device=dev)
              for x in (q, chunk))
    before = dict(ops.LAUNCHES)
    got = l2_distances(qn, vn)
    torch.cuda.synchronize()
    ran = {name for name, c in ops.LAUNCHES.items() if c != before[name]}
    if ran != {"l2dist_wgmma"}:
        raise AssertionError(f"l2_distances on normal values launched "
                             f"{sorted(ran)}, not l2dist_wgmma")
    err = check_tol("l2_distances f32 on normal values at the chunk's "
                    "shape", got, l2dist_ref(qn, vn), RTOL, L2_ATOL)
    log(f"l2_distances f32 on normal values at the chunk's shape: max abs "
        f"error {err}")
    del qn, vn, got
    for dtype, qkv in attn.items():
        want = flash_attn_ref(*qkv, causal=True)
        err = check_attn(f"flash_attention {dtype} at the Qwen3-0.6B shape",
                         outs[dtype], want)
        log(f"flash_attention {dtype} at the Qwen3-0.6B shape: max abs error "
            f"{err}, largest row-relative L2 error "
            f"{row_rel_err(outs[dtype], want)}")
    log(f"entry points at full width vs plain: ok; pq_adc_topk ids == "
        f"stable argsort of pq_adc for {len(luts)} queries; "
        f"launches={launches}")
    return launches, {"adc_scan": (codes, luts[0]),
                      "adc_scan_topk": (codes, luts[0], top_n),
                      "l2dist_wgmma": (q, chunk),
                      "l2dist": (q16, chunk16),
                      "flash_attn_fwd_wgmma": attn[torch.bfloat16],
                      "flash_attn_fwd": attn[torch.float32]}


# ---------------------------------------------------------------- phase 6
def measure(calls) -> list:
    from repro_torch.kernels.pq_adc import ops, ref
    out = []
    codes, luts = calls["adc_scan_batch"]
    b, m, k = luts.shape
    n = codes.shape[0]
    err = check_close("adc_scan_batch at main-path shape",
                      ops.pq_adc_batch(codes, luts),
                      ref.pq_adc_batch_ref(codes, luts))
    weight = luts.permute(1, 2, 0).reshape(m * k, b).contiguous()
    flat_idx = (codes.long() + torch.arange(m, device=codes.device) * k)
    lib = torch.nn.functional.embedding_bag(flat_idx, weight, mode="sum")
    check_close("embedding_bag yardstick", lib.T.contiguous(),
                ref.pq_adc_batch_ref(codes, luts))
    nbytes = n * m + b * m * k * 4 + b * n * 4
    flops = b * n * m
    out.append(dict(
        name="adc_scan_batch", shape=dict(B=b, N=n, M=m, K=k),
        max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc_batch(codes, luts), 20),
        plain_ms=gpu_ms(lambda: ref.pq_adc_batch_ref(codes, luts), 3),
        library_ms=gpu_ms(lambda: torch.nn.functional.embedding_bag(
            flat_idx, weight, mode="sum"), 5),
        **bound(nbytes, flops)))
    del lib, weight, flat_idx
    for key in ("adc_fused_topk", "adc_fused_topk[lut_int8]"):
        codes, q, cb, rows, topk = calls[key]
        int8 = key.endswith("[lut_int8]")
        kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                       lut_int8=int8)
        pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, topk,
                                             lut_int8=int8)
        err = check_close(f"{key} at main-path shape", kv, pv, ki, pi)
        b, s = rows.shape
        m, k, dsub = cb.shape
        valid = int((rows >= 0).sum())
        tk = min(topk, s)
        nbytes = (b * s * 4 + valid * m + b * m * dsub * 4
                  + m * k * dsub * 4 + b * tk * 8)
        lut_ops = b * m * k * 3 * dsub + (b * m * k * 5 if int8 else 0)
        flops = lut_ops + valid * m * (4 if int8 else 1)
        out.append(dict(
            name=key, shape=dict(B=b, S=s, valid_slots=valid, M=m, K=k,
                                 topk=topk),
            max_abs_err=err,
            ms=gpu_ms(lambda: ops.pq_adc_fused_topk(
                codes, q, cb, rows, topk, lut_int8=int8), 20),
            plain_ms=gpu_ms(lambda: ops.pq_adc_fused_topk_plain(
                codes, q, cb, rows, topk, lut_int8=int8), 3),
            library_ms=None, **bound(nbytes, flops)))
    return out


def measure_entry(calls) -> list:
    """Phase 6 for the entry-point kernels, on phase 5's inputs."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    from repro_torch.kernels.pq_adc import ops, ref
    F = torch.nn.functional
    out = []

    codes, lut = calls["adc_scan"]
    n, m = codes.shape
    k = lut.shape[1]
    plain = ref.pq_adc_ref(codes, lut)
    err = check_close("adc_scan", ops.pq_adc(codes, lut), plain)
    flat_idx = codes.long() + torch.arange(m, device=codes.device) * k
    weight = lut.reshape(m * k, 1)
    check_close("embedding_bag yardstick (B = 1)", F.embedding_bag(
        flat_idx, weight, mode="sum")[:, 0], plain)
    out.append(dict(
        name="adc_scan", shape=dict(N=n, M=m, K=k), max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc(codes, lut), 20),
        plain_ms=gpu_ms(lambda: ref.pq_adc_ref(codes, lut), 3),
        library_ms=gpu_ms(lambda: F.embedding_bag(flat_idx, weight,
                                                  mode="sum"), 5),
        **bound(n * m + m * k * 4 + n * 4, n * m)))
    del flat_idx, plain

    codes, lut, topk = calls["adc_scan_topk"]
    kv, ki = ops.pq_adc_topk(codes, lut, topk)
    pv, pi = ops.pq_adc_topk_plain(codes, lut, topk)
    err = check_close("adc_scan_topk", kv, pv, ki, pi)
    out.append(dict(
        name="adc_scan_topk", shape=dict(N=n, M=m, K=k, topk=topk),
        max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc_topk(codes, lut, topk), 10),
        plain_ms=gpu_ms(lambda: ops.pq_adc_topk_plain(codes, lut, topk), 3),
        library_ms=None,
        **bound(n * m + m * k * 4 + min(topk, n) * 8, n * m)))

    # the least time for either dtype is on the tensor cores: f32 in
    # 3xTF32 (three products each), bf16 in one (its products are exact
    # in f32), whichever kernel l2_kernel's rule picks; the output alone
    # is B * N * 4 bytes.  The yardstick is one addmm, bf16 in and f32 out
    # for bf16.
    for name, peak, products in (("l2dist_wgmma", TF32_FLOPS, 3),
                                 ("l2dist", BF16_FLOPS, 1)):
        q, v = calls[name]
        (b, d), nv = q.shape, v.shape[0]
        plain = l2dist_ref(q, v)
        err = check_tol(f"{name} ({q.dtype})", l2_distances(q, v), plain,
                        RTOL, L2_ATOL)
        qf, vf = q.float(), v.float()
        norms = (qf * qf).sum(-1, keepdim=True) + (vf * vf).sum(-1)[None]
        del qf, vf
        kw = ({} if q.dtype == torch.float32
              else dict(out_dtype=torch.float32))

        def addmm(q=q, v=v, norms=norms, kw=kw):
            return torch.addmm(norms, q, v.T, alpha=-2, **kw)
        check_tol(f"addmm yardstick ({q.dtype})", addmm(), plain, RTOL,
                  L2_ATOL)
        del plain
        out.append(dict(
            name=name, shape=dict(B=b, N=nv, D=d, dtype=str(q.dtype)),
            max_abs_err=err,
            ms=gpu_ms(lambda: l2_distances(q, v), 10),
            plain_ms=gpu_ms(lambda: l2dist_ref(q, v), 3),
            library_ms=gpu_ms(addmm, 10),
            **bound((b * d + nv * d) * q.element_size() + b * nv * 4,
                    products * 2 * b * nv * d, peak=peak)))
        del norms, addmm

    # bf16 on the tensor cores, f32 on the CUDA cores (flash_kernel's rule)
    for name, peak in (("flash_attn_fwd_wgmma", BF16_FLOPS),
                       ("flash_attn_fwd", F32_FLOPS)):
        q, k, v = calls[name]
        bsz, s, h, dh = q.shape
        t = k.shape[1]
        plain = flash_attn_ref(q, k, v, causal=True)
        tol = FLASH_TOL[q.dtype]
        err = check_attn(f"{name} ({q.dtype})",
                         flash_attention(q, k, v, causal=True), plain)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        check_tol(f"scaled_dot_product_attention yardstick ({q.dtype})",
                  sdpa().transpose(1, 2), plain, tol, tol)
        del plain
        pairs = sum(min(i + 1, t) for i in range(s))       # unmasked (s, t)
        out.append(dict(
            name=name,
            shape=dict(B=bsz, S=s, T=t, H=h, Hk=k.shape[2], dh=dh,
                       dtype=str(q.dtype), causal=True),
            max_abs_err=err,
            ms=gpu_ms(lambda: flash_attention(q, k, v, causal=True), 10),
            plain_ms=gpu_ms(lambda: flash_attn_ref(q, k, v, causal=True), 3),
            library_ms=gpu_ms(sdpa, 10),
            **bound((2 * q.numel() + k.numel() + v.numel())
                    * q.element_size(), 4 * bsz * h * dh * pairs,
                    peak=peak)))
    return out


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.configs.anns_datasets import SIFT1B
    from repro_torch.core.engine import FusionANNSIndex, ground_truth
    from repro_torch.kernels import build
    from repro_torch.kernels.pq_adc import ops

    dev = torch.device("cuda")
    # the plain versions' products and the yardsticks in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    t = time.perf_counter()
    reports = build.build()
    log(f"kernel build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(build.SOURCES)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t = time.perf_counter()
    check_kernels_small(dev, np.random.default_rng(args.seed + 1))
    check_entry_kernels_small(dev, np.random.default_rng(args.seed + 2))
    log(f"kernels vs plain (small shapes): ok, "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    data, queries = make_data(args.n, args.queries, args.seed)
    t_data = time.perf_counter() - t
    cfg = dataclasses.replace(SIFT1B, n_vectors=args.n,
                              n_posting_fraction=0.005)
    index = FusionANNSIndex.build(data, cfg, seed=args.seed)
    secs = {"data": round(t_data, 1)}
    secs.update({k: round(v, 1) for k, v in index.build_seconds.items()})
    log(f"index: N={args.n} dim=128 uint8 M={cfg.pq_m} K=256 "
        f"centroids={index.posting.n_clusters} "
        f"replication={index.posting.replication_factor():.2f} "
        f"codes={index.codes.numel() / 2**20:.0f} MiB on {index.device}")
    sizes = np.array([len(mb) for mb in index.posting.members])
    view = index.view()
    per_q = [len(view.collect_candidates(q, cfg.top_m)[0])
             for q in queries[:WINDOW]]
    cents = torch.from_numpy(index.posting.centroids).to(index.device)
    near = torch.cdist(torch.from_numpy(queries[:WINDOW]).to(index.device),
                       cents)
    near = torch.sort(near, dim=1, stable=True)[1][:, :cfg.top_m].cpu()
    log("posting lists: " + json.dumps({
        "mean": float(sizes.mean()), "median": float(np.median(sizes)),
        "empty": int((sizes == 0).sum()),
        "candidates_per_query_mean": float(np.mean(per_q)),
        "members_of_exact_top_m_centroids_mean": float(np.mean(
            [sizes[r.numpy()].sum() for r in near]))}))
    log("reduced: " + json.dumps({
        "n_vectors": [SIFT1B.n_vectors, args.n],
        "n_posting_fraction": [SIFT1B.n_posting_fraction, 0.005],
        "build_s": secs}))

    t = time.perf_counter()
    ops.reset_launches()
    gt = ground_truth(data, queries, 10)
    gt_launches = dict(ops.LAUNCHES)
    t_gt = time.perf_counter() - t
    if gt_launches["l2dist_wgmma"] < 1:
        raise AssertionError("ground truth never launched l2dist_wgmma")
    t = time.perf_counter()
    gt_plain = ground_truth_plain(data, queries, 10)
    if not np.array_equal(gt, gt_plain):
        bad = int((gt != gt_plain).any(1).sum())
        raise AssertionError(f"ground truth ids differ from the plain "
                             f"version's on {bad} queries")
    log(f"ground truth (l2dist_wgmma kernel, chunks of 2^20 rows): "
        f"{t_gt:.1f} s, "
        f"launches={gt_launches}; plain version "
        f"{time.perf_counter() - t:.1f} s; ids identical for all "
        f"{len(gt)} queries")

    paths = (("dense", "adc_scan_batch", {}),
             ("fused", "adc_fused_topk", {"fused": True}),
             ("fused_int8", "adc_fused_topk", {"fused": True,
                                               "lut_int8": True}))
    ids, metrics, launches = {}, {}, {}
    with Recorder() as recorder:
        for path, kernel, plan in paths:
            ops.reset_launches()
            ids[path], metrics[path] = serve(index, queries, gt, **plan)
            launches[path] = dict(ops.LAUNCHES)
            log(f"serve {path}: " + json.dumps(metrics[path])
                + f" launches={launches[path]}")
            if launches[path][kernel] < 1:
                raise AssertionError(f"{path} path never launched {kernel}")
    if not np.array_equal(ids["dense"], ids["fused"]):
        bad = int((ids["dense"] != ids["fused"]).any(1).sum())
        raise AssertionError(f"dense and fused ids differ on {bad} queries")
    r32, r8 = (metrics["fused"]["recall_at_10"],
               metrics["fused_int8"]["recall_at_10"])
    if not r32 > 0.5:
        raise AssertionError(f"f32 recall@10 {r32} <= 0.5")
    if not r8 >= r32 - 0.05:
        raise AssertionError(f"int8 recall@10 {r8} < f32 {r32} - 0.05")
    log("dense == fused ids for every query; recall checks: ok")

    entry_launches, entry_calls = drive_entry_points(
        index, cfg.top_n, data, queries, args.seed)
    for name in ("adc_scan", "adc_scan_topk", "l2dist_wgmma", "l2dist",
                 "flash_attn_fwd_wgmma", "flash_attn_fwd"):
        if entry_launches[name] < 1:
            raise AssertionError(f"the entry points never launched {name}")

    rows = measure(recorder.calls) + measure_entry(entry_calls)
    per_path = {"adc_scan_batch": launches["dense"]["adc_scan_batch"],
                "adc_fused_topk": launches["fused"]["adc_fused_topk"],
                "adc_fused_topk[lut_int8]":
                    launches["fused_int8"]["adc_fused_topk"],
                "adc_scan": entry_launches["adc_scan"],
                "adc_scan_topk": entry_launches["adc_scan_topk"],
                "l2dist_wgmma": gt_launches["l2dist_wgmma"],
                "l2dist": entry_launches["l2dist"],
                "flash_attn_fwd_wgmma":
                    entry_launches["flash_attn_fwd_wgmma"],
                "flash_attn_fwd": entry_launches["flash_attn_fwd"]}
    kernels = []
    for r in rows:
        shape = r.pop("shape")
        log(f"timing {r['name']} {shape}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
        kernels.append({"name": r["name"], **KERNELS[r["name"]],
                        "launches": per_path[r["name"]], **r})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
