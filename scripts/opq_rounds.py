#!/usr/bin/env python3
"""OPQ's reconstruction error round by round, beside plain PQ's, on the
smoke's data (``chip_smoke.make_data``: SIFT1B's widths, dim 128 uint8,
M = 32, K = 256).

    python3 scripts/opq_rounds.py [--n 10000000] [--seed 0] [--device cuda]

Prints plain PQ's mean squared reconstruction error after 8 and after 12
k-means rounds (``pq.train_codebooks`` from ``--seed``), then, for OPQ
with 8 and with 12 k-means rounds a round of rotation, each round's error
under the rotation the codebook was trained for and under the Procrustes
rotation that follows it (``core/opq.py``'s loop, four rounds).  Round 0
of OPQ is plain PQ at the same k-means rounds and seed, so the rows show
what the rotation alone gains.  One JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from chip_smoke import make_data
    from repro_torch.core import opq, pq
    dev = torch.device(args.device)
    # the smoke's draw: N rows and 256 queries, the rows kept
    x = torch.from_numpy(make_data(args.n, 256, args.seed)[0]).to(dev)
    xf = x.float()
    eye = np.eye(x.shape[1], dtype=np.float32)

    def error(cb, rotation):
        return opq.reconstruction_error(
            opq.OPQCodebook(rotation=rotation, cb=cb), x)

    for rounds in (8, 12):
        cb = pq.train_codebooks(torch.Generator().manual_seed(args.seed), x,
                                32, iters=rounds, device=dev)
        print(json.dumps({"pq_kmeans_rounds": rounds,
                          "error": error(cb, eye)}), flush=True)
    for rounds in (8, 12):
        gen = torch.Generator().manual_seed(args.seed)
        state = gen.get_state()
        r = eye
        for i in range(4):
            xr = opq.rotate(xf, r, dev)
            gen.set_state(state)
            cb = pq.train_codebooks(gen, xr, 32, iters=rounds, device=dev)
            err, xtr = opq._recon_sums(cb, xf, xr)
            u, _, vt = np.linalg.svd(xtr.cpu().numpy(), full_matrices=False)
            r = (u @ vt).astype(np.float32)
            print(json.dumps({"opq_kmeans_rounds": rounds, "round": i,
                              "error_trained_rotation": err,
                              "error_next_rotation": error(cb, r)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
