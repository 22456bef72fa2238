#!/usr/bin/env python3
"""Where the fused LUT -> ADC -> top-k kernel's time goes, and what its
design choices are worth, on one card.

    python3 scripts/fused_phases.py --dir build/fused_phases [--out FILE]
                                    [--spill] [--source TREE]
                                    [--only VARIANT ...]

Copies the ``src/repro_torch`` of this tree (or of ``TREE``, another
tree of this repo, e.g. an earlier commit unpacked with ``git archive``)
into ``DIR/<variant>`` (a gitignored directory; never into the package
itself) with one text edit each, then times ``pq_adc_fused_topk`` of
every copy and of the source tree with ``kernel_ab.fused_readings`` (B =
64 at S = 1,024 and 8,192, f32 and int8, about 500 and 4,000 valid rows
a query from 10M), or with ``--spill`` ``kernel_ab.spill_readings`` (B =
64, S = 32,768, tk = 4,096: the spill route).  Every copy is named
``repro_torch``, so each runs in a process of its own, in turns: the
source tree, the variants, the source tree again.

* ``stop_*``: ``adc_fused_topk.cu`` ends after a phase, behind a cluster
  barrier (its output is then not the answer): at entry (the launch of a
  cluster kernel that does nothing), after the LUT build and exchange,
  after the scan, after the select, after the sort.  Successive
  differences are the phases' costs on the critical path.
* ``contiguous``: CTA r of a query's cluster takes one contiguous range
  of chunks in place of every cluster-th chunk.
* ``cluster2``, ``cluster8``: the cluster size fixed at 2 or 8 CTAs a
  query (8 with ``__launch_bounds__(256, 4)``, so 4 CTAs fit an SM).
* ``match_any``: the radix select's histogram aggregated a warp at a
  time with ``__match_any_sync`` in place of one shared atomic a key.
* ``sort_select``: the final select by a bitonic sort of all the keys a
  CTA holds in place of the radix select.

``--spill`` takes the variants of ``SPILL_VARIANTS`` instead: the spill
route's ``adc_fused_spill_kernel`` ended after a phase (at entry, after
the LUT build, after the scan, after the cluster's select, after the
sort), so successive differences and the whole split it into launch,
LUT, scan, select, sort, the copy of the other CTAs' keys into the
inbox, and the rank search with its writes; ``spill_slots8`` gives a
thread eight slots of a tile in place of four (both routes' tiles of
2,048 slots: more loads in flight);
``spill_cluster8`` takes 8 CTAs a query in place of ``fused_plan``'s
cluster, ``spill_bounds3`` asks for three CTAs an SM (85 registers a
thread), ``spill_match_any`` counts the select's digits one shared
atomic a digit a warp (``__match_any_sync``).  On a source
whose spill route still ends in ``adc_fused_merge_kernel`` (the sorted
lists of a grid of CTAs a query through a global scratch: this repo
before the spill route's redesign) it takes ``MERGE_KERNEL_VARIANTS``:
``spill_stop_*`` end the main kernel after a phase (at entry, after the
LUT build, after the scan, after the sort) and make the merge kernel
return at once; ``spill_no_merge`` keeps the main kernel whole (its
scratch write included) and only empties the merge kernel: launch, LUT,
scan, sort, scratch write, merge.

Prints the card's name and power limit, then one JSON object, which
``--out`` also writes.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CU = "kernels/pq_adc/csrc/adc_fused_topk.cu"
OPS = "kernels/pq_adc/ops.py"
STOP = "  if (true) { cluster.sync(); return; }\n"


def _after(anchor: str):
    return CU, anchor, anchor + STOP


def _before(anchor: str):
    return CU, anchor, STOP + anchor


OWN = "  const int own = rank < chunks ? (chunks - rank + c - 1) / c : 0;\n"
LUT_DONE = ("  cluster.sync();                      // every CTA's rows "
            "pushed\n")
SCAN_DONE = ("    tau = sh.tau;\n    __syncthreads();                   "
             "// read before the next appends\n  }\n")
SELECT_DONE = ("  if (cnt > keep) {\n    compact(buf, cnt, keep, sh);\n"
               "    cnt = keep;\n  }\n")
SORT_DONE = "    sort_keys(buf, size);\n  }\n"
VARIANTS = {
    "stop_launch": [_after(OWN + "\n  // 1. this CTA's rows")],
    "stop_lut": [_after(LUT_DONE + "\n  // 2. the CTA's tiles")],
    "stop_scan": [_after(SCAN_DONE)],
    "stop_select": [_after(SELECT_DONE)],
    "stop_sort": [_after(SORT_DONE)],
    "contiguous": [
        (CU, OWN + "\n  // 1. this CTA's rows",
         "  const int per = (chunks + c - 1) / c;\n"
         "  const int own = max(0, min(chunks, (rank + 1) * per)"
         " - rank * per);\n\n  // 1. this CTA's rows"),
        (CU, "    x.p[u] = (ch * g + qr) * 32 + lane;\n",
         "    x.p[u] = (qr * (((s + 31) / 32 + g - 1) / g) + ch) * 32 + lane;"
         "\n")],
    "cluster2": [(OPS, "    c = 1\n    while (2 * c <= _FUSED_MAX_CLUSTER",
                  "    c = 2\n    while False and (2 * c <= "
                  "_FUSED_MAX_CLUSTER")],
    "cluster8": [(OPS, "    c = 1\n    while (2 * c <= _FUSED_MAX_CLUSTER",
                  "    c = 8\n    while False and (2 * c <= "
                  "_FUSED_MAX_CLUSTER"),
                 (CU, "__launch_bounds__(kThreads, 3)",
                  "__launch_bounds__(kThreads, 4)")],
    "match_any": [(CU, "      if (shift == 56 || (key ^ prefix) >> (shift +"
                       " 8) == 0)\n        atomicAdd(&sh.hist[(key >> "
                       "shift) & 255], 1u);\n",
                   "      const bool in = shift == 56 || (key ^ prefix) >>"
                   " (shift + 8) == 0;\n      const unsigned digit = in ?"
                   " (unsigned)(key >> shift) & 255u : 256u + lane;\n"
                   "      const unsigned same = __match_any_sync("
                   "__activemask(), digit);\n      if (in && lane == "
                   "__ffs(same) - 1)\n        atomicAdd(&sh.hist[digit], "
                   "(unsigned)__popc(same));\n")],
    "sort_select": [(CU, "  int cnt = sh.cnt;\n" + SELECT_DONE,
                     "  int cnt = sh.cnt;\n"),
                    (CU, SORT_DONE, SORT_DONE
                     + "  if (cnt > keep) cnt = keep;\n")],
}

# --spill: the spill route's phases, ended behind a cluster barrier
SPILL_VARIANTS = {
    "spill_stop_launch": [_after(
        "  const int tiles = (slots / 32 + kTile / 32 - 1) / (kTile / 32);"
        "\n")],
    "spill_stop_lut": [_before(
        "  float* qvals = vals + (size_t)b * tk;\n  int32_t* qids = ids + "
        "(size_t)b * tk;\n  const uint64_t* peer")],
    "spill_stop_scan": [_before(
        "    // 3. the cluster's best want, each CTA's share sorted\n")],
    "spill_stop_select": [_after(
        "    const int cnt = cluster_select(buf, sh.cnt, want, hist, pass, "
        "tau, sh,\n                                   cluster);\n")],
    "spill_stop_sort": [_before("    if (t == 0) sh.n_pub = cnt;\n")],
    "spill_stop_copy": [_before(
        "    for (int i = t; i < cnt; i += kThreads) {\n      const uint64_t "
        "x = buf[i];\n")],
    "spill_slots8": [(CU, "constexpr int kSlotsPerThread = 4;",
                      "constexpr int kSlotsPerThread = 8;")],
    "spill_cluster8": [(OPS, "    c = _fused_cluster(b, s, sms)\n    slots",
                        "    c = 8\n    slots")],
    "spill_bounds3": [(CU, "__launch_bounds__(kThreads, 2)\n"
                           "adc_fused_spill_kernel",
                       "__launch_bounds__(kThreads, 3)\n"
                       "adc_fused_spill_kernel")],
    "spill_match_any": [(CU, "      if (shift == 56 || (key ^ prefix) >> "
                             "(shift + 8) == 0)\n        atomicAdd(&h[(key"
                             " >> shift) & 255], 1u);\n",
                         "      const bool in = shift == 56 || (key ^ "
                         "prefix) >> (shift + 8) == 0;\n      const "
                         "unsigned digit = in ? (unsigned)(key >> shift) & "
                         "255u : 256u + (t & 31);\n      const unsigned "
                         "same = __match_any_sync(__activemask(), digit);\n"
                         "      if (in && (t & 31) == __ffs(same) - 1)\n"
                         "        atomicAdd(&h[digit], (unsigned)__popc("
                         "same));\n")],
}
# --spill on a source whose spill route still ends in a merge kernel
# (adc_fused_merge_kernel: a grid of CTAs a query writing sorted lists to
# a global scratch): the main kernel ended after a phase and the merge
# kernel emptied, or only the merge kernel emptied (spill_no_merge)
NO_MERGE = (CU, "  extern __shared__ uint64_t other[];  // one other list "
                "at a time\n", "  extern __shared__ uint64_t other[];  // one "
                "other list at a time\n  if (true) return;\n")
MERGE_KERNEL_VARIANTS = {
    "spill_stop_launch": [_after(
        "  const int own = qr < chunks ? (chunks - qr + g - 1) / g : 0;\n"),
        NO_MERGE],
    "spill_stop_lut": [_after(LUT_DONE), NO_MERGE],
    "spill_stop_scan": [_after(SCAN_DONE), NO_MERGE],
    "spill_stop_sort": [_after(SORT_DONE), NO_MERGE],
    "spill_no_merge": [NO_MERGE],
}


def make(dest: Path, edits, source: Path = ROOT) -> None:
    """A copy of ``source``'s package under dest/src with the edits made;
    each anchor must occur exactly once."""
    pkg = dest / "src" / "repro_torch"
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(source / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{dest.name}: anchor not found once in {rel}")
        path.write_text(text.replace(old, new))


def readings(tree: Path, seed: int, spill: bool) -> dict:
    """One tree's fused (or spill) readings, in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT), str(ROOT / "scripts")]
    import chip_smoke
    import kernel_ab
    from repro_torch.kernels import build
    from repro_torch.kernels.pq_adc import ops
    build.build(["adc_fused_topk"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    fn = kernel_ab.spill_readings if spill else kernel_ab.fused_readings
    return fn(ops, dev, gen, chip_smoke.window_rows, chip_smoke.gpu_ms)


def in_process(tree: Path, seed: int, spill: bool) -> dict:
    res = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--seed", str(seed)] + ["--spill"] * spill,
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        return {"error": f"exit {res.returncode}: {res.stderr[-3000:]}"}
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spill", action="store_true")
    ap.add_argument("--source", type=Path, default=ROOT)
    ap.add_argument("--only", nargs="+", metavar="VARIANT",
                    help="run these variants alone (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_phases: no CUDA device", file=sys.stderr)
        return 2
    if args.tree is not None:           # one tree's process
        print(json.dumps(readings(args.tree, args.seed, args.spill)))
        return 0
    if args.dir is None:
        ap.error("give --dir DIR for the copies")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "trees": {}}
    source = args.source.resolve()
    result["trees"]["this"] = [in_process(source, args.seed, args.spill)]
    variants = VARIANTS
    if args.spill:
        merge = "adc_fused_merge_kernel" in (source / "src" / "repro_torch"
                                             / CU).read_text()
        variants = MERGE_KERNEL_VARIANTS if merge else SPILL_VARIANTS
    for name, edits in variants.items():
        if args.only and name not in args.only:
            continue
        make(args.dir / name, edits, source)
        result["trees"][name] = in_process(args.dir / name, args.seed,
                                           args.spill)
        print(name, json.dumps(result["trees"][name]), flush=True)
    result["trees"]["this"].append(in_process(source, args.seed,
                                              args.spill))
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
