#!/usr/bin/env python3
"""Phases 14 and 15 of ``chip_smoke.py`` alone, on one CUDA card: builds
the kernels, runs phase 2's ADC checks (the dense and fused scans at
every width, dsub 5 among them), ``recsys_phase`` (the recsys and GNN
models served at full width, BERT4Rec's items through FusionANNS) and
``recsys_train_phase`` (their train cells through ``models.api``), and
prints their results and their kernels-line rows (6j and 7e).

    python3 scripts/recsys_phase.py [--seed 0] [--skip-serving]

``--skip-serving`` runs phase 14's GraphSAGE round alone before phase 15
(it samples minibatch_lg's batch, which phase 15 trains on).
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
    ap.add_argument("--skip-serving", action="store_true")
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
    keep: dict = {}
    dev = torch.device("cuda")
    t = time.perf_counter()
    if args.skip_serving:
        cs.sage_round(args.seed, dev, {}, keep)
        cs.log(f"sage round (phase 14 (d)): {time.perf_counter() - t:.1f} s")
    else:
        cs.check_kernels_small(dev, np.random.default_rng(args.seed + 1))
        cs.log(f"ADC scans vs plain (small shapes): ok, "
               f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rec, row = cs.recsys_phase(args.seed, card, keep)
        cs.log(f"recsys: ok, {time.perf_counter() - t:.1f} s; peak "
               f"{rec['peak_gb']:.1f} GB; launches={rec['launches']}")
        cs.log(f"row 6j: {row}")
    t = time.perf_counter()
    trn, row = cs.recsys_train_phase(args.seed, card, keep)
    cs.log(f"recsys train: ok, {time.perf_counter() - t:.1f} s; peak "
           f"{trn['peak_gb']:.1f} GB; launches={trn['launches']}")
    cs.log(f"row 7e: {row}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
