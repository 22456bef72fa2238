"""Multi-pod dry run of the port: every (architecture x input shape) cell
placed on the production meshes, with its per-device argument bytes,
model FLOPs and roofline terms (the port's counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices and reads the compiled program's memory and cost.  The
port has no compiler to ask: a cell is built by ``models.api.
build_cell`` on ``launch.mesh.make_production_mesh()``, whose logical
devices live on ``meta``, so its arguments are shapes and its
``in_shardings`` the reference's spec tree.  Each record holds

  * ``memory.argument_bytes``: the bytes of one device's block of every
    argument (``NamedSharding.shard_shape``; an uneven split rounded up,
    as XLA pads it); the compiled program's output and temporary bytes
    have no counterpart here and are not recorded;
  * ``model_flops``: ``analysis.model_flops`` (the reference's formulas);
  * ``roofline``: two of ``analysis.roofline.Roofline``'s terms at the
    H100's data-sheet rates, ``t_compute_s`` (the model's FLOPs split
    evenly over the devices) and ``t_memory_s`` (each argument byte read
    once), and the larger's name: a lower bound on a step, not a
    measurement.  The collective term and the ratios that compare the
    compiled program's FLOPs with the model's need the compiled program
    and are not recorded.

It needs no card and runs in seconds:

  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --anns      # FusionANNS sharded-scan cell

Results append to JSONL (default ``dryrun_results.jsonl``); cells done
in an earlier run are skipped (resume)."""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import tree
from repro_torch.analysis.model_flops import model_flops
from repro_torch.analysis.roofline import Roofline
from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.spec import NamedSharding, P, rules_for_mesh

ANNS_CELL = dict(n=2 ** 30, m=32, k=256, batch=64)   # SIFT1B, M = 32


def argument_bytes(args, shardings) -> int:
    """One device's bytes of every argument: the block its sharding
    gives it, times the element size."""
    leaves = tree.leaves(args)
    shards = tree.leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError(f"{len(leaves)} arguments, {len(shards)} shardings")
    return sum(math.prod(s.shard_shape(tuple(x.shape))) * x.element_size()
               for x, s in zip(leaves, shards))


def _record(arch: str, shape: str, step: str, multi_pod: bool, n_chips: int,
            arg_bytes: int, mf: float, t0: float) -> dict:
    roof = Roofline(flops=mf / n_chips, hbm_bytes=float(arg_bytes),
                    coll_bytes=0.0, coll_breakdown={}, model_flops=mf,
                    n_chips=n_chips)
    return {
        "arch": arch, "shape": shape, "step": step,
        "mesh": "multi" if multi_pod else "single", "n_chips": n_chips,
        "t_build_s": round(time.time() - t0, 3),
        "memory": {"argument_bytes": arg_bytes}, "model_flops": mf,
        "roofline": {"t_compute_s": roof.t_compute,
                     "t_memory_s": roof.t_memory,
                     "bottleneck": ("compute" if roof.t_compute
                                    >= roof.t_memory else "memory")},
        "ok": True,
    }


def run_cell(arch: str, shape_id: str, multi_pod: bool) -> dict:
    from repro_torch.models.api import build_cell
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    cell = build_cell(arch, shape_id, mesh=mesh)
    dims = next(c for c in shapes_for(cfg) if c.shape_id == shape_id).dims
    return _record(arch, shape_id, cell.step, multi_pod, mesh.size,
                   argument_bytes(cell.args, cell.in_shardings),
                   model_flops(cfg, cell.step, shape_id, dims), t0)


def run_anns_cell(multi_pod: bool) -> dict:
    """The paper's own distributed cell: the billion-scale sharded ADC
    scan (SIFT1B: 2^30 x M = 32 codes row-sharded over every device, a
    batch of 64 LUTs replicated) and its two-level top-n merge."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    corpus = rules_for_mesh(mesh).corpus
    c = ANNS_CELL
    args = (torch.empty((c["n"], c["m"]), dtype=torch.uint8, device="meta"),
            torch.empty((c["batch"], c["m"], c["k"]), dtype=torch.float32,
                        device="meta"))
    sh = (NamedSharding(mesh, P(corpus, None)),
          NamedSharding(mesh, P(None, None, None)))
    # useful work: batch x N x M lookups, ~2 flop each (gather + add)
    mf = 2.0 * c["batch"] * c["n"] * c["m"]
    return _record("fusionanns", f"scan_1b_b{c['batch']}", "anns_scan",
                   multi_pod, mesh.size, argument_bytes(args, sh), mf, t0)


def _done_cells(path: str):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS + ("fusionanns",))
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--anns", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = []
    if args.all:
        for arch in ARCH_IDS:
            for sc in shapes_for(get_config(arch)):
                jobs.extend((arch, sc.shape_id, mp) for mp in meshes)
        jobs.extend(("fusionanns", "anns", mp) for mp in meshes)
    elif args.anns or args.arch == "fusionanns":
        jobs = [("fusionanns", "anns", mp) for mp in meshes]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape, mp) for mp in meshes]
    else:
        ap.error("give --all, --anns, or --arch with --shape")

    done = _done_cells(args.out)
    anns_shape = f"scan_1b_b{ANNS_CELL['batch']}"
    for arch, shape, mp in jobs:
        mesh_name = "multi" if mp else "single"
        key = (arch, anns_shape if arch == "fusionanns" else shape, mesh_name)
        if key in done:
            print(f"SKIP {key}", flush=True)
            continue
        print(f"RUN  {arch} {shape} {mesh_name}", flush=True)
        try:
            rec = (run_anns_cell(mp) if arch == "fusionanns"
                   else run_cell(arch, shape, mp))
            print(f"  ok: args={rec['memory']['argument_bytes'] / 2**30:.2f}"
                  f"GiB/device bottleneck={rec['roofline']['bottleneck']}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — record the failure, continue
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAIL {type(e).__name__}: {e}", flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
