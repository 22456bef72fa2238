"""Serving launcher: ANNS service and/or LM decode demo, on the card unless
``--device`` names another.

  python -m repro_torch.launch.serve --mode anns --n 20000 --queries 50
  python -m repro_torch.launch.serve --mode lm --arch qwen3-0.6b --reduced
  python -m repro_torch.launch.serve --mode lm --reduced --device cpu
  python -m repro_torch.launch.serve --mode lm --arch deepseek-v2-lite-16b \
      --reduced --device cpu

``--mode lm`` serves every LM arch of the registry: the dense ones, the
MoE ones (qwen3-moe-30b-a3b) and MLA (deepseek-v2-lite-16b).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs.anns_datasets import SIFT_SMALL
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.engine import (FusionANNSIndex, ground_truth,
                                     recall_at_k)
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import LMServer, ServeConfig


def serve_anns(args) -> None:
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(SIFT_SMALL, n_vectors=args.n)
    data = clustered_vectors(rng, cfg.n_vectors, cfg.dim,
                             n_clusters=max(8, args.n // 400))
    t0 = time.time()
    index = FusionANNSIndex.build(data, cfg, device=args.device)
    print(f"index built in {time.time()-t0:.1f}s "
          f"(clusters={index.posting.n_clusters}, "
          f"replication={index.posting.replication_factor():.2f}x)")
    queries = clustered_vectors(rng, args.queries, cfg.dim,
                                n_clusters=max(8, args.n // 400))
    gt = ground_truth(data, queries, cfg.top_k, device=args.device)
    t0 = time.time()
    results = index.batch_query(queries)
    dt = time.time() - t0
    rec = recall_at_k(np.stack([r.ids for r in results]), gt, cfg.top_k)
    print(json.dumps({
        "recall@10": round(rec, 4),
        "qps_host": round(len(queries) / dt, 1),
        "mean_ios": round(float(np.mean([r.stats.ios for r in results])), 2),
        "mean_h2d_bytes": int(np.mean([r.stats.h2d_bytes for r in results])),
        "early_stop_rate": round(float(np.mean(
            [r.stats.early_stopped for r in results])), 3),
    }))


def serve_lm(args) -> None:
    cfg = get_config(args.arch, reduced=args.reduced)
    dev = torch.device(args.device)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    server = LMServer(params, cfg, ServeConfig(max_len=args.max_len))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    out = server.generate(prompts, args.gen_tokens)
    print(json.dumps({"tokens_per_s": round(out["tokens_per_s"], 1),
                      "wall_s": round(out["wall_s"], 2),
                      "shape": list(out["tokens"].shape)}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("anns", "lm"), default="anns")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args()
    if args.mode == "anns":
        serve_anns(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
