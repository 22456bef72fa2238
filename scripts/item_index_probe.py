#!/usr/bin/env python3
"""Why the FusionANNS index over BERT4Rec's items answers some queries
with fewer than k ids, on one CUDA card.

Builds ``chip_smoke.item_index`` (``examples/recsys_retrieval.py`` at
full width: 2^20 items, 80 columns, pq_m 16) at ``--fraction``, serves
BERT4Rec's 512 user embeddings on the dense path, and for every query
counts the rows of the posting lists that the navigation graph's search
returns, beside the rows of the exact ``top_m`` nearest centroids and of
an exact kNN graph's search over the same centroids.  Prints the
posting-list sizes, the graph's in-degrees and reach, and the short
answers, and writes the centroids, the graph, the list members and the
queries to ``--out`` (an ``.npz``) so that a CPU run can hold both
packages' graph and search on the same case.

    python3 scripts/item_index_probe.py [--seed 0] [--fraction 0.05]
        [--out chiprun_out/item_probe.npz]
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def union_rows(members, cids) -> int:
    if not len(cids):
        return 0
    return len(np.unique(np.concatenate([members[c] for c in cids])))


def reach(neighbors: np.ndarray, starts) -> int:
    """Vertices reachable from ``starts`` along the graph's edges."""
    seen = np.zeros(len(neighbors), bool)
    todo = collections.deque(int(s) for s in starts)
    seen[list(todo)] = True
    while todo:
        for v in neighbors[todo.popleft()]:
            if v >= 0 and not seen[v]:
                seen[v] = True
                todo.append(int(v))
    return int(seen.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fraction", type=float, default=0.05)
    ap.add_argument("--out", default="chiprun_out/item_probe.npz")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("item_index_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.core import navgraph as ng
    from repro_torch.core.clustering import full_f32
    from repro_torch.data.synthetic import recsys_seq_batch
    from repro_torch.kernels import build
    from repro_torch.models import recsys as R
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cs.log(card)
    build.build()
    dev = torch.device("cuda")
    cfg = get_config("bert4rec")
    with full_f32:
        params = R.init_bert4rec(
            torch.Generator(device=dev).manual_seed(args.seed), cfg, dev)
        ids = torch.from_numpy(recsys_seq_batch(
            np.random.default_rng(args.seed), cs.RECSYS_P99, cfg.seq_len,
            cfg.vocab_size)["item_ids"]).to(dev)
        u = R.bert4rec_user_embedding(params, ids, cfg)
        items = params["item_embed"]
        t = time.perf_counter()
        index, aug, queries, acfg = cs.item_index(args.seed, items, u,
                                                  args.fraction)
        build_s = time.perf_counter() - t
    k, top_m = acfg.top_k, acfg.top_m
    members = index.posting.members
    graph = index.graph
    sizes = np.array([len(m) for m in members])
    out = {"card": card, "fraction": args.fraction,
           "centroids": len(members), "build_s": round(build_s, 1),
           "build_stages_s": {s: round(v, 1)
                              for s, v in index.build_seconds.items()},
           "list_rows": {"empty": int((sizes == 0).sum()),
                         "under_k": int((sizes < k).sum()),
                         "p50": float(np.median(sizes)),
                         "p99": float(np.percentile(sizes, 99)),
                         "max": int(sizes.max()),
                         "replication": index.posting.replication_factor()}}
    indeg = np.bincount(graph.neighbors[graph.neighbors >= 0],
                        minlength=len(members))
    out["graph"] = {"degree": graph.neighbors.shape[1],
                    "out_missing": int((graph.neighbors < 0).sum()),
                    "in_degree_0": int((indeg == 0).sum()),
                    "reach_from_entry": reach(graph.neighbors,
                                              [graph.entry])}
    ids_dense, served = cs.serve(index, queries, np.zeros((len(queries), k),
                                                          np.int64))
    out["served_short"] = served["short_answers"]
    # per query: the search's lists, the exact nearest lists, an exact
    # kNN graph's search
    pts = torch.from_numpy(graph.points).to(dev)
    with full_f32:
        d2 = torch.cdist(torch.from_numpy(queries).to(dev), pts) ** 2
    exact_c = torch.topk(d2, top_m, largest=False).indices.cpu().numpy()
    exact_graph = ng.knn_graph_exact(graph.points, dev,
                                     degree=acfg.graph_degree)
    found = [ng.search(graph, q, top_m) for q in queries]
    found_exact_graph = [ng.search(exact_graph, q, top_m) for q in queries]
    rows_search = np.array([union_rows(members, c) for c in found])
    rows_exact = np.array([union_rows(members, c) for c in exact_c])
    rows_exact_graph = np.array([union_rows(members, c)
                                 for c in found_exact_graph])
    overlap = np.array([len(np.intersect1d(f, e)) for f, e in
                        zip(found, exact_c)])
    short = np.nonzero(rows_search < k)[0]
    out["queries"] = {
        "short_search": len(short),
        "short_exact_lists": int((rows_exact < k).sum()),
        "short_exact_graph": int((rows_exact_graph < k).sum()),
        "search_returned_lt_top_m": int(sum(len(f) < top_m for f in found)),
        "rows_search_p50": float(np.median(rows_search)),
        "rows_exact_p50": float(np.median(rows_exact)),
        "overlap_with_exact_mean": float(overlap.mean()),
        "overlap_exact_graph_mean": float(np.mean([
            len(np.intersect1d(f, e))
            for f, e in zip(found_exact_graph, exact_c)]))}
    detail = []
    for qi in short[:8]:
        q = queries[qi]
        f = found[qi]
        df = np.sum((graph.points[f] - q) ** 2, -1)
        de = np.sum((graph.points[exact_c[qi]] - q) ** 2, -1)
        seeds = graph.seed_beam(q)
        detail.append({"query": int(qi), "found": len(f),
                       "found_rows": [int(sizes[c]) for c in f],
                       "exact_rows": [int(sizes[c]) for c in exact_c[qi]],
                       "found_d2": [float(df.min()), float(df.max())],
                       "exact_d2": [float(de.min()), float(de.max())],
                       "overlap": int(overlap[qi]),
                       "seeds": len(seeds),
                       "reach_from_seeds": reach(graph.neighbors, seeds)})
    out["short_detail"] = detail
    cs.log("item index probe: " + json.dumps(out))
    offsets = np.cumsum([0] + [len(m) for m in members])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, points=graph.points, neighbors=graph.neighbors,
        entry=graph.entry, super_centroids=graph.super_centroids,
        super_assign=graph.super_assign,
        members=np.concatenate(members).astype(np.int32),
        offsets=offsets, queries=queries.astype(np.float32),
        found=np.stack([np.pad(f, (0, top_m - len(f)), constant_values=-1)
                        for f in found]),
        served_ids=ids_dense, top_m=top_m, k=k, degree=acfg.graph_degree)
    cs.log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
