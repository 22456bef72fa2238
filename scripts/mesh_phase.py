#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` alone, on one CUDA card: builds the
kernels and runs ``mesh_models_phase`` (the models on a mesh of 4
logical devices sharing the card: Qwen3-30B-A3B's prefill, decode and
training on (1, 4), SAGE's dst-partitioned cell and retrieval on (2, 2),
each against one device), then prints its results and its flash
launches.

    python3 scripts/mesh_phase.py [--seed 0]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cs.log(card)
    t = time.perf_counter()
    build.build()
    cs.log(f"kernel build: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out = cs.mesh_models_phase(args.seed, card)
    cs.log(f"mesh models: ok, {time.perf_counter() - t:.1f} s; peak "
           f"{out['peak_gb']:.1f} GB; launches="
           + json.dumps(out["launches"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
