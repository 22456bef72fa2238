#!/usr/bin/env python3
"""Times the dense ADC scan, bf16 flash attention and exact L2 of other
source trees beside this one's on one card, and reads each output against
its plain version.

    python3 scripts/kernel_ab.py --against DIR [--against DIR ...]
                                 [--out FILE] [--seed 0]

Each ``DIR`` is the root of another tree of this repo, or of its
``src/repro_torch`` at least: an earlier commit unpacked with
``git archive``, or a copy with one kernel source changed.  Its package
is built and driven through its own public wrappers,
``kernels.pq_adc.ops.pq_adc_batch``, ``kernels.flash_attn.
flash_attention`` and ``kernels.l2dist.l2_distances``, so the trees may
differ in launch shapes, C entry points and which kernel a call reaches.  Both packages are named
``repro_torch``, so every tree runs in a process of its own, in turns:
``DIR``, this tree, this tree, ``DIR``.

Every process makes the same inputs from ``--seed``: the dense window's
B = 64 LUTs over a 32,768-row bucket of M = 32 codes, and flash
attention at Qwen3-0.6B's widths (H 16, Hk 8, dh 128), B = 1,
S = T = 4096, bf16, causal, and exact L2 at the ground-truth chunk,
256 queries x 2^20 vectors x 128, f32, once on integers in [0, 256)
(SIFT's values) and once on normal values.  It reports the device time of
each call (``chip_smoke.gpu_ms``), the kernels the call launched, whether
the dense output is bit-equal to ``pq_adc_batch_ref``, the flash output's
max abs error, its largest row-relative error and whether
``chip_smoke``'s bf16 check accepts it against ``flash_attn_ref``, and
the L2 output's max abs error against ``l2dist_ref``, whether it is
bit-equal on the integers and within ``chip_smoke``'s L2 tolerance on the
normal values.  This tree's processes also time the one PyTorch call for
each function (``embedding_bag``, ``scaled_dot_product_attention``,
``addmm``).  A tree whose process fails is
reported with its error, and the others still run.  Prints the card's
name and power limit, and one JSON object, which ``--out`` also writes.
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
ATTN = dict(S=4096, H=16, Hk=8, dh=128)          # Qwen3-0.6B's attention
L2 = dict(B=256, N=1 << 20, D=128)               # one ground-truth chunk


def measure(tree: Path, seed: int) -> dict:
    """One tree's readings, in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    from repro_torch.kernels.pq_adc import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    dev = torch.device("cuda")
    F = torch.nn.functional
    yardsticks = tree.resolve() == ROOT

    def ran(fn):
        before = dict(ops.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, sorted(n for n, c in ops.LAUNCHES.items()
                           if c != before[n])

    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, K, (N, M)).astype(
        np.uint8)).to(dev)
    luts = torch.from_numpy(rng.random((B, M, K)).astype(np.float32)).to(dev)
    out, launched = ran(lambda: ops.pq_adc_batch(codes, luts))
    dense = dict(launched=launched, bit_equal=bool(torch.equal(
        out, ref.pq_adc_batch_ref(codes, luts))),
        ms=chip_smoke.gpu_ms(lambda: ops.pq_adc_batch(codes, luts), 200))
    if yardsticks:
        weight = luts.permute(1, 2, 0).reshape(M * K, B).contiguous()
        idx = codes.long() + torch.arange(M, device=dev) * K
        dense["embedding_bag_ms"] = chip_smoke.gpu_ms(
            lambda: F.embedding_bag(idx, weight, mode="sum"), 200)

    gen = torch.Generator(device=dev).manual_seed(seed)
    s, h, hk, dh = ATTN["S"], ATTN["H"], ATTN["Hk"], ATTN["dh"]
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((1, s, h, dh), (1, s, hk, dh),
                                      (1, s, hk, dh)))
    out, launched = ran(lambda: flash_attention(q, k, v, causal=True))
    want = flash_attn_ref(q, k, v, causal=True)
    try:
        chip_smoke.check_attn("flash bf16", out, want)
        accepted = True
    except AssertionError:
        accepted = False
    flash = dict(launched=launched,
                 max_abs_err=float((out.float() - want.float()).abs().max()),
                 row_rel_err=chip_smoke.row_rel_err(out, want),
                 smoke_check_accepts=accepted,
                 ms=chip_smoke.gpu_ms(
                     lambda: flash_attention(q, k, v, causal=True), 20))
    if yardsticks:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flash["sdpa_ms"] = chip_smoke.gpu_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    del q, k, v, out, want

    b, n, d = L2["B"], L2["N"], L2["D"]
    ints = [torch.from_numpy(rng.integers(0, 256, (rows, d), dtype=np.uint8)
                             ).to(dev).float() for rows in (b, n)]
    normal = [torch.randn(rows, d, generator=gen, device=dev)
              for rows in (b, n)]
    out, launched = ran(lambda: l2_distances(*ints))
    want = l2dist_ref(*ints)
    l2 = dict(launched=launched, bit_equal_on_integers=bool(torch.equal(
        out, want)), max_abs_err_integers=float((out - want).abs().max()))
    del out, want
    out, _ = ran(lambda: l2_distances(*normal))
    want = l2dist_ref(*normal)
    l2["max_abs_err_normal"] = float((out - want).abs().max())
    l2["within_tol_normal"] = bool(torch.allclose(
        out, want, rtol=chip_smoke.RTOL, atol=chip_smoke.L2_ATOL))
    del out, want
    l2["ms"] = chip_smoke.gpu_ms(lambda: l2_distances(*ints), 20)
    if yardsticks:
        qi, vi = ints
        norms = (qi * qi).sum(-1, keepdim=True) + (vi * vi).sum(-1)[None]
        l2["addmm_ms"] = chip_smoke.gpu_ms(
            lambda: torch.addmm(norms, qi, vi.T, alpha=-2), 20)
    return {"adc_scan_batch": dense, "flash_attn[bf16]": flash,
            "l2dist[f32]": l2}


def in_process(tree: Path, seed: int) -> dict:
    res = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--seed", str(seed)], capture_output=True,
                         text=True, timeout=900)
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.tree is not None:           # one tree's process
        print(json.dumps(measure(args.tree, args.seed)))
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
            turns = [in_process(t, args.seed)
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
