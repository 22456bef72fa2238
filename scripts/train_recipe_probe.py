#!/usr/bin/env python3
"""Phase 15's train cells of ``chip_smoke.py`` at several AdamW recipes,
on one CUDA card: for each cell of ``chip_smoke.TRAIN_CELLS`` at full
width (phase 15's params and batches from ``--seed``) and each recipe
(lr, warmup steps and optionally total steps), the losses of ``--steps`` steps of
``chip_smoke.train_step`` on the one batch.  For the archs of ``--host``
it runs the same steps on the host too, on a copy of the params cut to
the embedding rows the batch touches (``chip_smoke.touched_rows``): the
same function, and the same trajectory, since the loss reads no other
row and AdamW gives a row with no gradient none of the update but its
weight decay.  So a loss that rises on the card can be told from one
that rises in the function.  SAGE's cells also print their whole graph's
gradient against the host's (``chip_smoke.grads_vs_host``).

    python3 scripts/train_recipe_probe.py [--seed 0] [--steps 12] \\
        [--recipes 1e-4,2 1e-3,2] [--host dlrm-rm2 wide-deep] \\
        [--cells dlrm-rm2 molecule]

Each line it prints is a JSON object; ``--out`` writes them all to a file
as well.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def losses(step, state, batch, n: int) -> list:
    out = []
    for _ in range(n):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--recipes", nargs="+", default=["1e-4,2", "1e-3,2"],
                    help="lr,warmup_steps[,total_steps]")
    ap.add_argument("--host", nargs="*", default=["dlrm-rm2"])
    ap.add_argument("--cells", nargs="*", default=None,
                    help="names of chip_smoke.TRAIN_CELLS (default all)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_recipe_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.core.clustering import full_f32
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lines = []

    def emit(obj):
        obj["card"] = card
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)
    build.build()
    dev = torch.device("cuda")
    keep: dict = {}
    cs.sage_round(args.seed, dev, {}, keep)
    batches = cs.train_batches(args.seed, keep)
    recipes = [dict(zip(("lr", "warmup_steps", "total_steps"),
                        (float(f) if i == 0 else int(f) for i, f in
                         enumerate(r.split(","))))) for r in args.recipes]
    with full_f32:
        for arch, shape, name in cs.TRAIN_CELLS:
            if args.cells and name not in args.cells:
                continue
            batch = batches[name]
            cell = api.build_cell(arch, shape)
            micro = cs.TRAIN_MICRO.get(arch, 1)
            kind = getattr(get_config(arch), "kind", "sage")
            on = cs.cell_batch(cell, batch, dev)
            gen = torch.Generator(device=dev)
            if kind == "sage":
                params = cell.init_fn(gen.manual_seed(args.seed), dev)
                emit({"cell": name, "grad_vs_host": cs.grads_vs_host(
                    cell, params, batch, kind, None)})
                del params
            for recipe in recipes:
                params = cell.init_fn(gen.manual_seed(args.seed), dev)
                host = None
                if arch in args.host:
                    hp, hb, _ = cs.touched_rows(params, batch, kind)
                    host = ({"params": hp, "opt": adamw_init(hp)},
                            {k: torch.from_numpy(v) for k, v in hb.items()})
                step = cs.train_step(cell, micro, recipe)
                t = time.perf_counter()
                card_losses = losses(step, {"params": params,
                                            "opt": adamw_init(params)},
                                     on, args.steps)
                del params
                res = {"cell": name, "recipe": recipe, "steps": args.steps,
                       "losses": card_losses,
                       "drop_rel": (card_losses[0] - card_losses[-1])
                       / abs(card_losses[0]),
                       "s": time.perf_counter() - t}
                gc.collect()
                torch.cuda.empty_cache()
                if host is not None:
                    t = time.perf_counter()
                    res["host_losses"] = losses(step, host[0], host[1],
                                                args.steps)
                    res["host_s"] = time.perf_counter() - t
                    res["host_rel_diff"] = max(
                        abs(a - b) / abs(b) for a, b in
                        zip(card_losses, res["host_losses"]))
                    del host
                emit(res)
            del on
            gc.collect()
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
