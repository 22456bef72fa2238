#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone, on one CUDA card: builds the
kernels, runs phase 2's ADC checks (the dense and fused scans at every
width, dsub 5 among them) and ``recsys_phase`` (the recsys and GNN models
at full width, BERT4Rec's items through FusionANNS), and prints its
results and its kernels-line row.

    python3 scripts/recsys_phase.py [--seed 0]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("recsys_phase: no CUDA device", file=sys.stderr)
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
    cs.check_kernels_small(torch.device("cuda"),
                           np.random.default_rng(args.seed + 1))
    cs.log(f"ADC scans vs plain (small shapes): ok, "
           f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rec, row = cs.recsys_phase(args.seed, card)
    cs.log(f"recsys: ok, {time.perf_counter() - t:.1f} s; peak "
           f"{rec['peak_gb']:.1f} GB; launches={rec['launches']}")
    cs.log(f"row 6j: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
