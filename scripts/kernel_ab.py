#!/usr/bin/env python3
"""Times the dense ADC scan, the fused LUT -> ADC -> top-k scan (f32 and
int8), the single-query ADC scan + top-k, flash attention (bf16 and f32)
and its backward, and exact L2 (f32 and bf16, and bf16 at SPACEV1B's d =
100) of other source trees beside this one's on one card, and reads each
output against its plain version.

    python3 scripts/kernel_ab.py --against DIR [--against DIR ...]
                                 [--only GROUP ...] [--out FILE] [--seed 0]

Each ``DIR`` is the root of another tree of this repo, or of its
``src/repro_torch`` at least: an earlier commit unpacked with
``git archive``, or a copy with one kernel source changed.  Its package
is built and driven through its own public wrappers,
``kernels.pq_adc.ops.pq_adc_batch``,
``kernels.pq_adc.ops.pq_adc_fused_topk``, ``kernels.pq_adc.ops.pq_adc_topk``,
``kernels.flash_attn.flash_attention`` and
``kernels.l2dist.l2_distances``, so the trees may
differ in launch shapes, C entry points and which kernel a call reaches.  Both packages are named
``repro_torch``, so every tree runs in a process of its own, in turns:
``DIR``, this tree, this tree, ``DIR``.

Every process makes the same inputs from ``--seed``: the dense window's
B = 64 LUTs over a 32,768-row bucket of M = 32 codes; the fused scan over
10M rows of M = 32 random codes (K = 256, dsub = 4, topk 512) at the main
path's window, B = 64 queries of S = 1,024 slots, and at a multi-block
window of S = 8,192, each query's valid rows (uniform in [S/4, 3S/4],
about 500 and 4,000) drawn ascending from the 10M and followed by pads,
in f32 and int8; one query's LUT
over 10M rows of M = 32 codes with topk 512 (the smoke's phase 5), once
with the rows in random order and once sorted by descending distance,
where every row beats each block's running threshold; flash attention at
Qwen3-0.6B's widths (H 16, Hk 8), B = 1, S = T = 4096, causal, in bf16
and in f32 at dh 128, 96 and 256, and in bf16 at dh 256 and at dh 100
(off the 16-byte row stride), and at DeepSeek-V2-Lite's MLA prefill
(H = Hk = 16, q and k 192 wide, v 128, B = 1, S = T = 4096, causal) in
bf16 and f32; exact L2 at the ground-truth chunk, 256
queries x 2^20 vectors x 128, in f32, in bf16 and passed as uint8, in
bf16 cut to SPACEV1B's d = 100 (rows off TMA's 16-byte stride) and to
an odd d = 101, and in f32 and bf16 at GIST1M's d = 960, once on
integers (in [0, 256), SIFT's values; in [0, 128) at d = 960, where
960 * 127^2 < 2^24 keeps every sum exact) and once on normal values
(not for uint8); and the fused scan at a window past ``fused_plan``'s
one launch (B = 64, S = 32,768, tk = 4,096, f32 and int8: the spill
route); the attention backward (``flash_attention_bwd``) at Qwen3-0.6B's
widths, dh 128, B = 1, S = T = 4096, causal, on f32 and bf16 inputs
(rows 7 and 7b of PERF.md section 6), from the forward kernel's output
and lse, its gradients' relative L2 error against ``flash_attn_bwd_ref``
(and, where the tree's plain version evaluates in f64, against that
exact gradient, with the f32 plain version's own error beside it),
whether two runs are bit-equal, SDPA's backward beside it (this tree's
process), and the ``ptxas`` lines of the backward's kernels where the
process compiled them.  A reading whose call raises (a width, dtype or
window an older tree's kernels do not take) is reported with its error.
It reports the device time of each call (``chip_smoke.gpu_ms``), the
kernels the call launched, whether the dense output is bit-equal to
``pq_adc_batch_ref``, whether the fused output is bit-equal to
``pq_adc_fused_topk_plain`` (values and ids) and its time with the
wrapper's ``torch.sort`` and ``torch.gather`` stubbed out (the kernel
alone; a one-launch wrapper has neither), whether the top-k
equals the first topk of a stable argsort of ``pq_adc`` (values and ids)
and its time with every ``torch.sort`` of the wrapper stubbed out (the
kernel without the merge; ``ms`` less that is the merge), the flash
output's max abs error, its largest row-relative error and whether
``chip_smoke``'s check of its dtype accepts it against ``flash_attn_ref``, and
the L2 output's max abs error against ``l2dist_ref``, whether it is
bit-equal on the integers and within ``chip_smoke``'s L2 tolerance on the
normal values.  This tree's processes also time the one PyTorch call for
each function where there is one (``embedding_bag``,
``scaled_dot_product_attention``, ``addmm``).  A tree whose process fails is
reported with its error, and the others still run.  Prints the card's
name and power limit, and one JSON object, which ``--out`` also writes.
``--only`` keeps the readings of the groups named (``adc``: the dense,
top-k, fused and spill scans; ``flash``; ``l2``; ``bwd``: the attention
backward), all by default.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B, N, M, K = 64, 32_768, 32, 256                 # the dense window
FUSED = dict(N=10_000_000, dsub=4, topk=512,      # the fused windows
             S={"main": 1024, "multi": 8192})
TOPK = dict(N=10_000_000, topk=512)               # smoke phase 5's top-k
ATTN = dict(S=4096, H=16, Hk=8)                  # Qwen3-0.6B's attention
MLA = dict(S=4096, H=16, Hk=16)                 # DeepSeek-V2-Lite's MLA
# (dtype, tag, q/k width, v width, the shape: S = T, H, Hk)
ATTN_CASES = ((torch.bfloat16, "bf16", 128, 128, ATTN),
              (torch.float32, "f32", 128, 128, ATTN),
              (torch.bfloat16, "bf16,dh96", 96, 96, ATTN),
              (torch.float32, "f32,dh96", 96, 96, ATTN),
              (torch.float32, "f32,dh256", 256, 256, ATTN),
              (torch.bfloat16, "bf16,dh256", 256, 256, ATTN),
              (torch.bfloat16, "bf16,dh100", 100, 100, ATTN),
              (torch.bfloat16, "bf16,mla", 192, 128, MLA),
              (torch.float32, "f32,mla", 192, 128, MLA))
GROUPS = ("adc", "flash", "l2", "bwd")
PREFIX = {"adc": "adc_", "flash": "flash_", "l2": "l2dist",   # sources
          "bwd": "flash_"}
# the attention backward at row 6b's shape (Qwen3-0.6B's heads, dh 128,
# B = 1, S = T = 4096, causal): f32 (row 7) and bf16 inputs (row 7b)
BWD_CASES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
L2 = dict(B=256, N=1 << 20, D=128)               # one ground-truth chunk
# (dtype, tag, width, integers below): the chunk at SIFT1B's 128, cut to
# SPACEV1B's 100 and to an odd 101, and at GIST1M's 960
L2_CASES = ((torch.float32, "f32", 128, 256),
            (torch.bfloat16, "bf16", 128, 256),
            (torch.bfloat16, "bf16,d100", 100, 256),
            (torch.bfloat16, "bf16,d101", 101, 256),
            (torch.uint8, "u8", 128, 256),
            (torch.float32, "f32,d960", 960, 128),
            (torch.bfloat16, "bf16,d960", 960, 128))


def measure(tree: Path, seed: int, only=GROUPS) -> dict:
    """One tree's readings of the groups ``only``, in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.pq_adc import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    reports = build.build([n for n in build.SOURCES   # the groups' sources
                           if any(n.startswith(PREFIX[g]) for g in only)])
    dev = torch.device("cuda")
    F = torch.nn.functional
    yardsticks = tree.resolve() == ROOT

    def ran(fn):
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, sorted(n for n, c in ops.LAUNCHES.items()
                           if c != before[n])

    out = {}
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if "adc" in only:
        codes = torch.from_numpy(rng.integers(0, K, (N, M)).astype(
            np.uint8)).to(dev)
        luts = torch.from_numpy(rng.random((B, M, K)).astype(
            np.float32)).to(dev)
        res, launched = ran(lambda: ops.pq_adc_batch(codes, luts))
        dense = dict(launched=launched, bit_equal=bool(torch.equal(
            res, ref.pq_adc_batch_ref(codes, luts))),
            ms=chip_smoke.gpu_ms(lambda: ops.pq_adc_batch(codes, luts),
                                 200))
        if yardsticks:
            weight = luts.permute(1, 2, 0).reshape(M * K, B).contiguous()
            idx = codes.long() + torch.arange(M, device=dev) * K
            dense["embedding_bag_ms"] = chip_smoke.gpu_ms(
                lambda: F.embedding_bag(idx, weight, mode="sum"), 200)
        out["adc_scan_batch"] = dense
        out["pq_adc_topk"] = topk_readings(ops, ref, dev, gen, luts[0],
                                           chip_smoke.gpu_ms)
        del codes, luts, res
    if "flash" in only:
        for dtype, tag, dh, dv, shape in ATTN_CASES:
            out[f"flash_attn[{tag}]"] = reading(lambda: flash_reading(
                dtype, dh, dv, shape, dev, gen, ran, yardsticks,
                chip_smoke))
    if "bwd" in only:
        for dtype, tag in BWD_CASES:
            out[f"flash_attn_bwd[{tag}]"] = reading(lambda: bwd_reading(
                dtype, dev, gen, ran, yardsticks, chip_smoke))
        if "flash_attn_bwd" in reports:     # compiled by this process
            out["flash_attn_bwd[ptxas]"] = ptxas_lines(
                reports["flash_attn_bwd"])
    if "l2" in only:
        for dtype, tag, width, below in L2_CASES:
            out[f"l2dist[{tag}]"] = reading(lambda: l2_reading(
                dtype, width, below, dev, gen, ran, yardsticks, chip_smoke))
    if "adc" in only:
        # last, so the readings above keep the inputs of earlier runs
        out["pq_adc_fused_topk"] = fused_readings(
            ops, dev, gen, chip_smoke.window_rows, chip_smoke.gpu_ms)
        out["pq_adc_fused_topk[spill]"] = spill_readings(
            ops, dev, gen, chip_smoke.window_rows, chip_smoke.gpu_ms)
    return out


def reading(fn) -> dict:
    """``fn()``, or the error it raised (a width an older tree's kernels
    do not take)."""
    try:
        return fn()
    except (ValueError, TypeError) as e:
        return {"error": str(e)[:300]}


def flash_reading(dtype, dh, dv, shape, dev, gen, ran, yardsticks,
                  chip_smoke) -> dict:
    """Flash attention at ``shape``'s S = T, H and Hk, q and k ``dh`` wide,
    v ``dv`` wide."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    F = torch.nn.functional
    s, h, hk = shape["S"], shape["H"], shape["Hk"]
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dtype)
               for sh in ((1, s, h, dh), (1, s, hk, dh), (1, s, hk, dv)))
    out, launched = ran(lambda: flash_attention(q, k, v, causal=True))
    want = flash_attn_ref(q, k, v, causal=True)
    try:
        chip_smoke.check_attn(f"flash {dtype} dh={dh} dv={dv}", out, want)
        accepted = True
    except AssertionError:
        accepted = False
    r = dict(launched=launched,
             max_abs_err=float((out.float() - want.float()).abs().max()),
             row_rel_err=chip_smoke.row_rel_err(out, want),
             smoke_check_accepts=accepted,
             ms=chip_smoke.gpu_ms(
                 lambda: flash_attention(q, k, v, causal=True), 20))
    del out, want
    if yardsticks:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        r["sdpa_ms"] = chip_smoke.gpu_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    return r


def bwd_reading(dtype, dev, gen, ran, yardsticks, chip_smoke) -> dict:
    """The attention backward (``flash_attention_bwd``) at row 6b's shape
    on inputs of ``dtype``, from the forward kernel's output and lse: the
    kernels it launched, each gradient's relative L2 error against
    ``flash_attn_bwd_ref`` on the same residuals, whether two runs are
    bit-equal, and its time; this tree's process also times SDPA's
    backward alone (``torch.autograd.grad`` of its output) and reads its
    gradients' relative L2 error against the kernel's."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attn_bwd_ref)
    F = torch.nn.functional
    s, h, hk, dh = ATTN["S"], ATTN["H"], ATTN["Hk"], 128
    q, do = (torch.randn(1, s, h, dh, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(1, s, hk, dh, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)

    def call():
        return flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    got, launched = ran(call)
    want = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=True)
    names = ("dq", "dk", "dv")
    r = dict(launched=launched,
             rel_l2={n: chip_smoke.rel_l2(g, w) for n, g, w in
                     zip(names, got, want)},
             bit_equal_runs=all(torch.equal(a, b)
                                for a, b in zip(got, call())),
             ms=chip_smoke.gpu_ms(call, 10))
    try:                # a plain version that evaluates in f64 too
        exact = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=True,
                                   compute=torch.float64)
        r["exact_rel_l2"] = {n: chip_smoke.rel_l2(g, e) for n, g, e in
                             zip(names, got, exact)}
        r["plain_exact_rel_l2"] = {n: chip_smoke.rel_l2(w, e) for n, w, e
                                   in zip(names, want, exact)}
        del exact
    except TypeError:
        pass
    del want
    if yardsticks:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        do_t = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(o, (qt, kt, vt), do_t,
                                       retain_graph=True)
        r["sdpa_rel_l2"] = max(chip_smoke.rel_l2(g.transpose(1, 2), w)
                               for g, w in zip(sdpa_bwd(), got))
        r["sdpa_ms"] = chip_smoke.gpu_ms(sdpa_bwd, 10)
    return r


def ptxas_lines(report: str) -> list:
    """The lines of an ``nvcc -Xptxas -v`` report that name a function and
    its registers, stack and spills."""
    keep = ("Compiling entry function", "registers", "spill")
    return [ln.strip() for ln in report.splitlines()
            if any(k in ln for k in keep)]


def l2_reading(dtype, width, below, dev, gen, ran, yardsticks,
               chip_smoke) -> dict:
    """Exact L2 over the ground-truth chunk's shape at ``width``: on
    integers in [0, below), bit-equal or not, and on normal values, within
    the smoke's tolerance or not; the time on the integers."""
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    b, n = L2["B"], L2["N"]
    ints = [torch.randint(0, below, (rows, width), generator=gen,
                          device=dev, dtype=torch.uint8).to(dtype)
            for rows in (b, n)]
    out, launched = ran(lambda: l2_distances(*ints))
    want = l2dist_ref(*ints)
    r = dict(launched=launched, bit_equal_on_integers=bool(torch.equal(
        out, want)), max_abs_err_integers=float((out - want).abs().max()))
    del out, want
    if dtype.is_floating_point:
        normal = [torch.randn(rows, width, generator=gen,
                              device=dev).to(dtype) for rows in (b, n)]
        out, _ = ran(lambda: l2_distances(*normal))
        want = l2dist_ref(*normal)
        r["max_abs_err_normal"] = float((out - want).abs().max())
        r["within_tol_normal"] = bool(torch.allclose(
            out, want, rtol=chip_smoke.RTOL, atol=chip_smoke.L2_ATOL))
        del out, want, normal
    r["ms"] = chip_smoke.gpu_ms(lambda: l2_distances(*ints), 20)
    if yardsticks and dtype.is_floating_point:
        qi, vi = ints
        qf, vf = qi.float(), vi.float()
        norms = (qf * qf).sum(-1, keepdim=True) + (vf * vf).sum(-1)[None]
        del qf, vf
        kw = {} if dtype == torch.float32 else dict(out_dtype=torch.float32)
        r["addmm_ms"] = chip_smoke.gpu_ms(
            lambda: torch.addmm(norms, qi, vi.T, alpha=-2, **kw), 20)
    return r


class _NoMerge:
    """Within it, ``torch.sort`` returns its input and a cached index
    tensor, and ``torch.gather`` a cached tensor of the index's shape: a
    wrapper's merge costs nothing, its kernel runs as ever."""

    def __enter__(self):
        self.saved, kept = (torch.sort, torch.gather), {}

        def no_sort(x, *a, **kw):
            key = ("sort", tuple(x.shape), x.device)
            if key not in kept:
                kept[key] = torch.zeros(x.shape, dtype=torch.long,
                                        device=x.device)
            return x, kept[key]

        def no_gather(x, dim, index, **kw):
            key = ("gather", tuple(index.shape), x.dtype, x.device)
            if key not in kept:
                kept[key] = torch.empty(index.shape, dtype=x.dtype,
                                        device=x.device)
            return kept[key]
        torch.sort, torch.gather = no_sort, no_gather
        return self

    def __exit__(self, *exc):
        torch.sort, torch.gather = self.saved


def fused_readings(ops, dev, gen, window_rows, gpu_ms) -> dict:
    """``pq_adc_fused_topk`` at the main path's window and a multi-block
    one (rows from ``chip_smoke.window_rows``), f32 and int8: bit-equal to
    its plain version, the kernels it launched, its time, and its time
    with the merge stubbed out."""
    n, dsub, topk = FUSED["N"], FUSED["dsub"], FUSED["topk"]
    codes = torch.randint(0, K, (n, M), generator=gen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn(M, K, dsub, generator=gen, device=dev)
    out = {}
    for shape, s in FUSED["S"].items():
        q = torch.randn(B, M * dsub, generator=gen, device=dev)
        rows = window_rows(B, s, n, dev, gen)
        for int8 in (False, True):
            before = dict(ops.LAUNCHES)
            v, i = ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                         lut_int8=int8)
            torch.cuda.synchronize()
            pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, topk,
                                                 lut_int8=int8)

            def call():
                return ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                             lut_int8=int8)
            r = dict(S=s, valid_slots=int((rows >= 0).sum()),
                     launched={k: c - before[k] for k, c in
                               ops.LAUNCHES.items() if c != before[k]},
                     bit_equal=bool(torch.equal(v, pv)
                                    and torch.equal(i, pi)),
                     ms=gpu_ms(call, 50))
            with _NoMerge():
                r["kernel_ms"] = gpu_ms(call, 50)
            r["merge_ms"] = r["ms"] - r["kernel_ms"]
            out[f"{shape}[{'int8' if int8 else 'f32'}]"] = r
        del rows, q
    return out


def spill_readings(ops, dev, gen, window_rows, gpu_ms) -> dict:
    """``pq_adc_fused_topk`` at a window ``fused_plan`` refuses (B = 64,
    S = 32,768, tk = 4,096; rows from ``chip_smoke.window_rows``), f32
    and int8: bit-equal to its plain version, the kernels it launched
    and its time, or the error an older tree raises."""
    n, dsub, s, tk = FUSED["N"], FUSED["dsub"], 1 << 15, 4096
    codes = torch.randint(0, K, (n, M), generator=gen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn(M, K, dsub, generator=gen, device=dev)
    q = torch.randn(B, M * dsub, generator=gen, device=dev)
    rows = window_rows(B, s, n, dev, gen)
    out = {}
    for int8 in (False, True):
        def call():
            return ops.pq_adc_fused_topk(codes, q, cb, rows, tk,
                                         lut_int8=int8)

        def one() -> dict:
            before = dict(ops.LAUNCHES)
            v, i = call()
            torch.cuda.synchronize()
            pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, tk,
                                                 lut_int8=int8)
            return dict(S=s, tk=tk, valid_slots=int((rows >= 0).sum()),
                        launched={k: c - before[k] for k, c in
                                  ops.LAUNCHES.items() if c != before[k]},
                        bit_equal=bool(torch.equal(v, pv)
                                       and torch.equal(i, pi)),
                        ms=gpu_ms(call, 20))
        out["int8" if int8 else "f32"] = reading(one)
    return out


def topk_readings(ops, ref, dev, gen, lut, gpu_ms) -> dict:
    """``pq_adc_topk`` over ``TOPK["N"]`` random rows of M codes with one
    query's LUT, rows in random order and sorted by descending distance:
    exact against a stable argsort of ``pq_adc``, its time, and its time
    with the wrapper's ``torch.sort`` calls stubbed out."""
    n, topk = TOPK["N"], TOPK["topk"]
    codes = torch.randint(0, K, (n, M), generator=gen, device=dev,
                          dtype=torch.uint8)
    out = {}
    for order in ("random", "descending"):
        if order == "descending":
            d = ref.pq_adc_ref(codes, lut)
            codes = codes[torch.sort(d, descending=True, stable=True)[1]]
            del d
        before = dict(ops.LAUNCHES)
        v, i = ops.pq_adc_topk(codes, lut, topk)
        d = ops.pq_adc(codes, lut)
        torch.cuda.synchronize()
        sv, si = torch.sort(d, stable=True)
        r = dict(launched=sorted(k for k, c in ops.LAUNCHES.items()
                                 if c != before[k]),
                 exact=bool(torch.equal(v, sv[:topk]) and torch.equal(
                     i.long(), si[:topk])),
                 ms=gpu_ms(lambda: ops.pq_adc_topk(codes, lut, topk), 20))
        del d, sv, si
        with _NoMerge():
            r["kernel_ms"] = gpu_ms(
                lambda: ops.pq_adc_topk(codes, lut, topk), 20)
        r["merge_ms"] = r["ms"] - r["kernel_ms"]
        out[order] = r
    return out


def in_process(tree: Path, seed: int, only) -> dict:
    res = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--seed", str(seed), "--only", *only],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{tree}: exit {res.returncode}\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", type=Path, default=[],
                    metavar="DIR")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tree is not None:           # one tree's process
        print(json.dumps(measure(args.tree, args.seed, args.only)))
        return 0
    if not args.against:
        ap.error("give at least one --against DIR")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "runs": []}
    for other in args.against:
        try:
            turns = [in_process(t, args.seed, args.only)
                     for t in (other, ROOT, ROOT, other)]
            run = {"against": str(other), "other": [turns[0], turns[3]],
                   "this": [turns[1], turns[2]]}
        except RuntimeError as e:       # a tree whose launch fails
            run = {"against": str(other), "error": str(e)}
        result["runs"].append(run)
        print(json.dumps(result["runs"][-1]), flush=True)
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
