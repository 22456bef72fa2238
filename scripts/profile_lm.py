#!/usr/bin/env python3
"""Where an LM's device time goes: one bf16 ``lm_prefill`` at the
smoke's phase 10/11 shape (B = 2, S = 4,096) and one f32 decode step (B
= 8 at position 2,048, as ``LMServer`` decodes) of an LM of the registry
at its full config, random bf16 weights from seed 0, under
``torch.profiler`` on one card.

    python3 scripts/profile_lm.py [--arch deepseek-v2-lite-16b]
                                  [--layers N] [--top 25]
    python3 scripts/profile_lm.py --arch qwen3-0.6b --train

``--train`` profiles one f32 train step instead (``train.loop.
make_train_step`` over ``lm_loss``, f32 weights, smoke phases 12 and
13's batch B = 2, S = 2,048; an MoE arch at phase 13's capacity factor
16, so that no (token, expert) pair is dropped; the step before it warms
up), and also sums the device time by kernel family (``flash_attn_bwd``'s
three kernels, the flash forward, GEMMs, the rest):

    python3 scripts/profile_lm.py --arch deepseek-v2-lite-16b --layers 3 \
                                  --train

Prints the card's name and power limit, then for each run: the host's
wall time around a synchronised run, the device time the profiler's
kernels add up to, their share of the wall time (the rest: the device
idle, waiting on the host), and the ``--top`` kernels by device time,
grouped by name.  ``--layers`` cuts the depth (Qwen3-30B-A3B's 48 layers
do not fit beside other work: the smoke runs 8).  Without a card it
exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


PREFILL = (2, 4096)         # B, S: the smoke's phases 10 and 11
DECODE = (8, 2048)          # B, position of the decode step
TRAIN = (2, 2048)           # B, S: the smoke's phases 12 and 13
TRAIN_CAPACITY = 16.0       # an MoE's capacity factor: phase 13's
# kernel families of a train step, by a substring of the kernel's name
FAMILIES = (("flash backward", ("bwd_prep", "bwd_dkdv", "bwd_dq")),
            ("flash forward", ("flash_fwd",)),
            ("GEMM", ("gemm", "sm90_xmma", "cutlass")))


def profiled(fn, top: int) -> dict:
    """One warm run, then one run under the profiler: wall ms (host clock
    around a synchronised run), device ms (the CUDA kernels' sum) and the
    ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    device = sum(r[0] for r in rows)
    return {"wall_ms": wall, "device_ms": device,
            "device_share": device / wall if wall else None,
            "top": [{"ms": ms, "share": ms / device if device else None,
                     "calls": n, "kernel": name[:120]}
                    for ms, n, name in rows[:top]]}


def train_profile(cfg, dev: torch.device, top: int) -> dict:
    """One f32 train step of ``cfg`` at TRAIN (an MoE at TRAIN_CAPACITY)
    under the profiler, with the device time summed by kernel family
    (every kernel, not only the top ones)."""
    import numpy as np
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.train.loop import TrainConfig, init_state, make_train_step
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=TRAIN_CAPACITY)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    batch = lm_batch(np.random.default_rng(0), *TRAIN, cfg.vocab_size)
    tcfg = TrainConfig()
    step = make_train_step(
        lambda p, b: tfm.lm_loss(p, b, cfg, dtype=torch.float32), tcfg)
    state = init_state(params, tcfg)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "train": dict(batch=TRAIN[0], seq=TRAIN[1], dtype="f32",
                         capacity_factor=cfg.capacity_factor)}
    out["train"].update(profiled(lambda: step(state, batch), 10 ** 6))
    kernels = out["train"].pop("top")
    fam = {name: 0.0 for name, _ in FAMILIES}
    fam["other"] = 0.0
    for k in kernels:
        name = next((f for f, keys in FAMILIES
                     if any(key in k["kernel"] for key in keys)), "other")
        fam[name] += k["ms"]
    out["train"]["by_family_ms"] = fam
    out["train"]["top"] = kernels[:top]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="profile one f32 train step (B, S = 2, 2048)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.train:
        print(json.dumps(train_profile(cfg, dev, args.top), indent=1))
        return 0
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL, generator=gen,
                           device=dev)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "prefill": dict(batch=PREFILL[0], seq=PREFILL[1], dtype="bf16")}
    out["prefill"].update(profiled(
        lambda: tfm.lm_prefill(params, tokens, cfg, dtype=torch.bfloat16),
        args.top))
    b, pos = DECODE
    cache = tfm.init_kv_cache(cfg, b, PREFILL[1], dtype=torch.float32,
                              device=dev)
    step = tokens[:1, :1].expand(b, 1)
    out["decode"] = dict(batch=b, pos=pos, dtype="f32")
    out["decode"].update(profiled(
        lambda: tfm.lm_decode_step(params, cache, step, pos, cfg,
                                   dtype=torch.float32), args.top))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
