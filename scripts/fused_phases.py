#!/usr/bin/env python3
"""Where the fused LUT -> ADC -> top-k kernel's time goes, and what its
design choices are worth, on one card.

    python3 scripts/fused_phases.py --dir build/fused_phases [--out FILE]

Copies this tree's ``src/repro_torch`` into ``DIR/<variant>`` (a
gitignored directory; never into the package itself) with one text edit
each, then times ``pq_adc_fused_topk`` of every copy and of this tree
with ``kernel_ab.fused_readings`` (B = 64 at S = 1,024 and 8,192, f32 and
int8, about 500 and 4,000 valid rows a query from 10M).  Every copy is
named ``repro_torch``, so each runs in a process of its own, in turns:
this tree, the variants, this tree again.

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


VARIANTS = {
    "stop_launch": [_after(
        "  const int own = rank < chunks ? (chunks - rank + c - 1) / c"
        " : 0;\n")],
    "stop_lut": [_after(
        "  cluster.sync();                      // every CTA's rows"
        " pushed\n")],
    "stop_scan": [_after(
        "    tau = sh.tau;\n    __syncthreads();                   // read"
        " before the next appends\n  }\n")],
    "stop_select": [_after(
        "  if (cnt > keep) {\n    compact(buf, cnt, keep, sh);\n"
        "    cnt = keep;\n  }\n")],
    "stop_sort": [_after("    sort_keys(buf, size);\n  }\n")],
    "contiguous": [
        (CU, "  const int own = rank < chunks ? (chunks - rank + c - 1) / c"
             " : 0;\n",
         "  const int per = (chunks + c - 1) / c;\n"
         "  const int own = max(0, min(chunks, (rank + 1) * per)"
         " - rank * per);\n"),
        (CU, "      p[u] = (ch * c + rank) * 32 + lane;\n",
         "      p[u] = (rank * per + ch) * 32 + lane;\n")],
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
    "sort_select": [(CU, "  int cnt = sh.cnt;\n  if (cnt > keep) {\n"
                         "    compact(buf, cnt, keep, sh);\n    cnt = keep;"
                         "\n  }\n", "  int cnt = sh.cnt;\n"),
                    (CU, "    sort_keys(buf, size);\n  }\n",
                     "    sort_keys(buf, size);\n  }\n"
                     "  if (cnt > keep) cnt = keep;\n")],
}


def make(dest: Path, edits) -> None:
    """A copy of this tree's package under dest/src with the edits made;
    each anchor must occur exactly once."""
    pkg = dest / "src" / "repro_torch"
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{dest.name}: anchor not found once in {rel}")
        path.write_text(text.replace(old, new))


def readings(tree: Path, seed: int) -> dict:
    """One tree's fused readings, in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT), str(ROOT / "scripts")]
    import chip_smoke
    import kernel_ab
    from repro_torch.kernels import build
    from repro_torch.kernels.pq_adc import ops
    build.build(["adc_fused_topk"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return kernel_ab.fused_readings(ops, dev, gen, chip_smoke.window_rows,
                                    chip_smoke.gpu_ms)


def in_process(tree: Path, seed: int) -> dict:
    res = subprocess.run([sys.executable, __file__, "--tree", str(tree),
                          "--seed", str(seed)], capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        return {"error": f"exit {res.returncode}: {res.stderr[-3000:]}"}
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", type=Path)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_phases: no CUDA device", file=sys.stderr)
        return 2
    if args.tree is not None:           # one tree's process
        print(json.dumps(readings(args.tree, args.seed)))
        return 0
    if args.dir is None:
        ap.error("give --dir DIR for the copies")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "trees": {}}
    result["trees"]["this"] = [in_process(ROOT, args.seed)]
    for name, edits in VARIANTS.items():
        make(args.dir / name, edits)
        result["trees"][name] = in_process(args.dir / name, args.seed)
        print(name, json.dumps(result["trees"][name]), flush=True)
    result["trees"]["this"].append(in_process(ROOT, args.seed))
    text = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
