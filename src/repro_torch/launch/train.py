"""Training launcher, on the card unless ``--device`` names another.

  python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --steps 50
  python -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu

The reference's CLI: a dense or MoE LM of the registry in f32 (attention
through the flash forward and backward kernels on the card), AdamW with
warmup and a cosine, optional microbatching, int8 error-feedback
gradient compression and periodic checkpoints.  One device: the models'
mesh paths wait for ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import LOCAL_CTX
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.loop import TrainConfig, init_state, make_train_step, run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                            total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compress_bits=args.grad_compress_bits,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)

    def loss_fn(p, batch):
        return tfm.lm_loss(p, batch, cfg, LOCAL_CTX, dtype=torch.float32)

    step_fn = make_train_step(loss_fn, tcfg)
    state = init_state(params, tcfg)

    rng = np.random.default_rng(0)

    def batches():
        for _ in range(args.steps):
            yield lm_batch(rng, args.batch, args.seq, cfg.vocab_size)

    state, step, history = run(step_fn, state, batches(), tcfg, log_every=10)
    for h in history:
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}))
    if args.log:
        with open(args.log, "w") as f:
            json.dump(history, f)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {step} steps")


if __name__ == "__main__":
    main()
