#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` (FusionANNS on PyTorch + CUDA) on one GPU.

    python3 chip_smoke.py [--n 10000000] [--queries 256] [--seed 0]

From the root of a checkout, with one CUDA card:

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/pq_adc/csrc`` (one ``nvcc`` per source, in
   parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card at
   small shapes (ragged N, B = 1 and 64, S not a multiple of the block,
   all-pad rows, constructed ties, M in {8, 32});
3. builds a SIFT1B-width index (dim 128 uint8, M = 32, K = 256) over
   ``--n`` clustered vectors drawn from ``--seed`` through the public
   ``FusionANNSIndex.build``, and prints the cuts of scale on a
   ``reduced`` line with each build stage's time;
4. serves ``--queries`` queries through three paths — the dense window
   (``window=64``), ``fused=True`` and ``fused=True, lut_int8=True`` —
   each with the launch counts set to 0 just before it and read just
   after, and prints recall@10 against exact ground truth, QPS and
   p50/p99; it fails unless dense and fused f32 give identical ids for
   every query, f32 recall > 0.5, int8 recall >= f32 recall - 0.05, and
   each path launched its kernel;
5. holds each kernel against its plain version again on the inputs the
   first serving window gave it, and times kernel, plain version and (where
   one exists) a single PyTorch call computing the same function, with
   CUDA events, beside the least time the card could take.

The second-to-last line is a JSON object ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero and prints no result.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # float32 outside the tensor cores
RTOL = 1e-5                      # M f32 terms summed in another order
WINDOW = 64
FUSED_SRC = "src/repro_torch/kernels/pq_adc/csrc/adc_fused_topk.cu"
KERNELS = {
    "adc_scan_batch": dict(
        route="cuda", source="src/repro_torch/kernels/pq_adc/csrc/"
        "adc_scan_batch.cu", replaces="src/repro/kernels/pq_adc/pq_adc.py:80"),
    "adc_fused_topk": dict(
        route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/pq_adc/pq_adc.py:239"),
    "adc_fused_topk[lut_int8]": dict(
        route="cuda", source=FUSED_SRC,
        replaces="src/repro/kernels/pq_adc/pq_adc.py:177"),
}


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------- comparison
def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                got_ids=None, want_ids=None) -> float:
    """Distances to RTOL (inf where inf); ids equal except inside runs of
    distances that tie within RTOL.  Returns the max abs error."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
    fin = np.isfinite(w)
    if not np.array_equal(fin, np.isfinite(g)):
        raise AssertionError(f"{name}: +inf slots differ")
    if not np.allclose(g[fin], w[fin], rtol=RTOL, atol=0):
        raise AssertionError(f"{name}: distances differ beyond rtol {RTOL}")
    err = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
    if got_ids is not None:
        gi, wi = got_ids.cpu().numpy(), want_ids.cpu().numpy()
        diff = gi != wi
        tie = np.zeros_like(diff)
        if w.shape[-1] > 1:
            eq = np.isclose(w[..., 1:], w[..., :-1], rtol=RTOL, atol=0)
            tie[..., 1:] |= eq
            tie[..., :-1] |= eq
        if (diff & ~tie).any():
            raise AssertionError(f"{name}: ids differ outside distance ties")
    return err


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 2
def check_kernels_small(dev: torch.device, rng: np.random.Generator) -> None:
    from repro_torch.kernels.pq_adc import ops, ref
    for m in (8, 32):
        k, dsub = 256, 4
        cb = torch.from_numpy(rng.standard_normal((m, k, dsub)).astype(
            np.float32)).to(dev)
        for n in (1, 777, 8192 + 13, 3 * 8192 + 5):
            codes = torch.from_numpy(rng.integers(0, 256, (n, m)).astype(
                np.uint8)).to(dev)
            # a 1-byte storage offset exercises the byte-load path too
            flat = torch.empty(n * m + 1, dtype=torch.uint8, device=dev)
            flat[1:] = codes.reshape(-1)
            for cds in (codes, flat[1:].view(n, m)):
                for b in (1, 64):
                    q = torch.from_numpy(rng.standard_normal(
                        (b, m * dsub)).astype(np.float32)).to(dev)
                    luts = ref.build_luts_ref(cb, q)
                    check_close(f"adc_scan_batch m{m} n{n} b{b}",
                                ops.pq_adc_batch(cds, luts),
                                ref.pq_adc_batch_ref(cds, luts))
                    mask = torch.from_numpy(rng.random((b, n)) < 0.3).to(dev)
                    kv, ki = ops.pq_adc_topk_batch(cds, luts, 100, mask=mask)
                    d = ref.pq_adc_batch_ref(cds, luts).masked_fill(
                        ~mask, torch.inf)
                    pv, pi = torch.sort(d, dim=1, stable=True)
                    check_close(f"masked top-k m{m} n{n} b{b}", kv,
                                pv[:, :100], ki, pi[:, :100])
        # fused: ragged S, all-pad rows, exact ties from duplicate code rows
        n = 50_000
        base = rng.integers(0, 256, (n // 4, m)).astype(np.uint8)
        codes = torch.from_numpy(np.repeat(base, 4, axis=0)).to(dev)
        for b, s, topk in ((1, 3000, 10), (64, 5000, 512), (64, 2048, 3000),
                           (5, 37, 512)):
            rows = np.full((b, s), -1, np.int32)
            for i in range(b - 1 if b > 1 else b):   # last row all pads
                c = int(rng.integers(1, s + 1))
                rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
            rows_t = torch.from_numpy(rows).to(dev)
            q = torch.from_numpy(rng.standard_normal((b, m * dsub)).astype(
                np.float32)).to(dev)
            for int8 in (False, True):
                kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows_t, topk,
                                               lut_int8=int8)
                pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows_t,
                                                     topk, lut_int8=int8)
                check_close(f"adc_fused_topk m{m} b{b} s{s} k{topk} "
                            f"int8={int8}", kv, pv, ki, pi)
                if not torch.equal(ki, pi):
                    raise AssertionError("fused ids differ on exact ties")
    torch.cuda.synchronize()


# ------------------------------------------------------------- phase 3/4
def make_data(n: int, n_queries: int, seed: int):
    from repro_torch.data.synthetic import clustered_vectors
    rng = np.random.default_rng(seed)
    allv = clustered_vectors(rng, n + n_queries, 128,
                             n_clusters=max(8, n // 500), dtype=np.uint8,
                             chunk=1 << 20)
    return allv[:n], allv[n:].astype(np.float32)


class Recorder:
    """Keeps the inputs of the first call of each kernel wrapper while
    the main path runs, so phase 5 can hold the kernels against their
    plain versions at the shapes the main path gave them."""

    def __init__(self):
        from repro_torch.core import distributed
        from repro_torch.kernels.pq_adc import ops
        self.ops, self.dist = ops, distributed
        self.calls = {}
        self._orig = (ops.pq_adc_batch, distributed.pq_adc_fused_topk)

    def __enter__(self):
        batch, fused = self._orig

        def rec_batch(codes, luts):
            self.calls.setdefault("adc_scan_batch", (codes, luts))
            return batch(codes, luts)

        def rec_fused(codes, queries, codebooks, rows, topk, *, lut_int8):
            key = "adc_fused_topk" + ("[lut_int8]" if lut_int8 else "")
            self.calls.setdefault(key, (codes, queries, codebooks, rows,
                                        topk))
            return fused(codes, queries, codebooks, rows, topk,
                         lut_int8=lut_int8)

        self.ops.pq_adc_batch = rec_batch
        self.dist.pq_adc_fused_topk = rec_fused
        return self

    def __exit__(self, *exc):
        self.ops.pq_adc_batch, self.dist.pq_adc_fused_topk = self._orig


def serve(index, queries: np.ndarray, gt: np.ndarray, **plan):
    from repro_torch.core.engine import recall_at_k
    lat = np.zeros(len(queries))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticket = index.submit(queries, window=WINDOW, inflight_depth=2, **plan)
    for i, f in enumerate(ticket.futures):
        f.add_done_callback(
            lambda _f, i=i: lat.__setitem__(i, time.perf_counter() - t0))
    res = ticket.results()
    wall = time.perf_counter() - t0
    ids = np.stack([r.ids for r in res])
    return ids, dict(recall_at_10=recall_at_k(ids, gt, 10),
                     qps=len(queries) / wall,
                     p50_ms=1e3 * float(np.percentile(lat, 50)),
                     p99_ms=1e3 * float(np.percentile(lat, 99)),
                     candidates_scanned_mean=float(np.mean(
                         [r.stats.candidates_scanned for r in res])))


# ---------------------------------------------------------------- phase 5
def measure(calls) -> list:
    from repro_torch.kernels.pq_adc import ops, ref
    out = []
    codes, luts = calls["adc_scan_batch"]
    b, m, k = luts.shape
    n = codes.shape[0]
    err = check_close("adc_scan_batch at main-path shape",
                      ops.pq_adc_batch(codes, luts),
                      ref.pq_adc_batch_ref(codes, luts))
    weight = luts.permute(1, 2, 0).reshape(m * k, b).contiguous()
    flat_idx = (codes.long() + torch.arange(m, device=codes.device) * k)
    lib = torch.nn.functional.embedding_bag(flat_idx, weight, mode="sum")
    check_close("embedding_bag yardstick", lib.T.contiguous(),
                ref.pq_adc_batch_ref(codes, luts))
    nbytes = n * m + b * m * k * 4 + b * n * 4
    flops = b * n * m
    out.append(dict(
        name="adc_scan_batch", shape=dict(B=b, N=n, M=m, K=k),
        max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc_batch(codes, luts), 20),
        plain_ms=gpu_ms(lambda: ref.pq_adc_batch_ref(codes, luts), 3),
        library_ms=gpu_ms(lambda: torch.nn.functional.embedding_bag(
            flat_idx, weight, mode="sum"), 5),
        **bound(nbytes, flops)))
    del lib, weight, flat_idx
    for key in ("adc_fused_topk", "adc_fused_topk[lut_int8]"):
        codes, q, cb, rows, topk = calls[key]
        int8 = key.endswith("[lut_int8]")
        kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                       lut_int8=int8)
        pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, topk,
                                             lut_int8=int8)
        err = check_close(f"{key} at main-path shape", kv, pv, ki, pi)
        b, s = rows.shape
        m, k, dsub = cb.shape
        valid = int((rows >= 0).sum())
        tk = min(topk, s)
        nbytes = (b * s * 4 + valid * m + b * m * dsub * 4
                  + m * k * dsub * 4 + b * tk * 8)
        lut_ops = b * m * k * 3 * dsub + (b * m * k * 5 if int8 else 0)
        flops = lut_ops + valid * m * (4 if int8 else 1)
        out.append(dict(
            name=key, shape=dict(B=b, S=s, valid_slots=valid, M=m, K=k,
                                 topk=topk),
            max_abs_err=err,
            ms=gpu_ms(lambda: ops.pq_adc_fused_topk(
                codes, q, cb, rows, topk, lut_int8=int8), 20),
            plain_ms=gpu_ms(lambda: ops.pq_adc_fused_topk_plain(
                codes, q, cb, rows, topk, lut_int8=int8), 3),
            library_ms=None, **bound(nbytes, flops)))
    return out


def bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.configs.anns_datasets import SIFT1B
    from repro_torch.core.engine import FusionANNSIndex, ground_truth
    from repro_torch.kernels.pq_adc import build, ops

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    t = time.perf_counter()
    reports = build.build()
    log(f"kernel build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(build.SOURCES)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t = time.perf_counter()
    check_kernels_small(dev, np.random.default_rng(args.seed + 1))
    log(f"kernels vs plain (small shapes): ok, "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    data, queries = make_data(args.n, args.queries, args.seed)
    t_data = time.perf_counter() - t
    cfg = dataclasses.replace(SIFT1B, n_vectors=args.n,
                              n_posting_fraction=0.005)
    index = FusionANNSIndex.build(data, cfg, seed=args.seed)
    secs = {"data": round(t_data, 1)}
    secs.update({k: round(v, 1) for k, v in index.build_seconds.items()})
    log(f"index: N={args.n} dim=128 uint8 M={cfg.pq_m} K=256 "
        f"centroids={index.posting.n_clusters} "
        f"replication={index.posting.replication_factor():.2f} "
        f"codes={index.codes.numel() / 2**20:.0f} MiB on {index.device}")
    sizes = np.array([len(mb) for mb in index.posting.members])
    view = index.view()
    per_q = [len(view.collect_candidates(q, cfg.top_m)[0])
             for q in queries[:WINDOW]]
    cents = torch.from_numpy(index.posting.centroids).to(index.device)
    near = torch.cdist(torch.from_numpy(queries[:WINDOW]).to(index.device),
                       cents)
    near = torch.sort(near, dim=1, stable=True)[1][:, :cfg.top_m].cpu()
    log("posting lists: " + json.dumps({
        "mean": float(sizes.mean()), "median": float(np.median(sizes)),
        "empty": int((sizes == 0).sum()),
        "candidates_per_query_mean": float(np.mean(per_q)),
        "members_of_exact_top_m_centroids_mean": float(np.mean(
            [sizes[r.numpy()].sum() for r in near]))}))
    log("reduced: " + json.dumps({
        "n_vectors": [SIFT1B.n_vectors, args.n],
        "n_posting_fraction": [SIFT1B.n_posting_fraction, 0.005],
        "build_s": secs}))

    t = time.perf_counter()
    gt = ground_truth(data, queries, 10)
    log(f"ground truth (torch.matmul, chunked): "
        f"{time.perf_counter() - t:.1f} s")

    paths = (("dense", "adc_scan_batch", {}),
             ("fused", "adc_fused_topk", {"fused": True}),
             ("fused_int8", "adc_fused_topk", {"fused": True,
                                               "lut_int8": True}))
    ids, metrics, launches = {}, {}, {}
    with Recorder() as recorder:
        for path, kernel, plan in paths:
            ops.reset_launches()
            ids[path], metrics[path] = serve(index, queries, gt, **plan)
            launches[path] = dict(ops.LAUNCHES)
            log(f"serve {path}: " + json.dumps(metrics[path])
                + f" launches={launches[path]}")
            if launches[path][kernel] < 1:
                raise AssertionError(f"{path} path never launched {kernel}")
    if not np.array_equal(ids["dense"], ids["fused"]):
        bad = int((ids["dense"] != ids["fused"]).any(1).sum())
        raise AssertionError(f"dense and fused ids differ on {bad} queries")
    r32, r8 = (metrics["fused"]["recall_at_10"],
               metrics["fused_int8"]["recall_at_10"])
    if not r32 > 0.5:
        raise AssertionError(f"f32 recall@10 {r32} <= 0.5")
    if not r8 >= r32 - 0.05:
        raise AssertionError(f"int8 recall@10 {r8} < f32 {r32} - 0.05")
    log("dense == fused ids for every query; recall checks: ok")

    rows = measure(recorder.calls)
    per_path = {"adc_scan_batch": launches["dense"]["adc_scan_batch"],
                "adc_fused_topk": launches["fused"]["adc_fused_topk"],
                "adc_fused_topk[lut_int8]":
                    launches["fused_int8"]["adc_fused_topk"]}
    kernels = []
    for r in rows:
        shape = r.pop("shape")
        log(f"timing {r['name']} {shape}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
        kernels.append({"name": r["name"], **KERNELS[r["name"]],
                        "launches": per_path[r["name"]], **r})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
