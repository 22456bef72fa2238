#!/usr/bin/env python3
"""Smoke run of ``repro_torch`` (FusionANNS on PyTorch + CUDA) on one GPU.

    python3 chip_smoke.py [--n 10000000] [--queries 256] [--seed 0]

From the root of a checkout, with one CUDA card:

1. prints the card's name and power limit, builds the eight CUDA kernel
   sources from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per
   source, in parallel), prints the build time and each ``ptxas``
   register/spill line;
2. holds each kernel against its plain PyTorch version on the card at
   small shapes: the ADC scans at ragged N, B = 1 and 64, S not a multiple
   of the block, all-pad rows, a mostly-padding last block, N < topk,
   constructed ties, M in {8, 32} (and 16 for the single-query scans; the
   fused scan bit for bit also at 24 and 25, S up to 8,192, rows >= N,
   and on its spill route at S = 32,768 with tk = 4,096), rows in
   descending distance and a topk that fills the top-k kernel's
   candidate buffer; exact L2 (every instantiation of ``l2dist_wgmma``:
   f32 loading by TMA where d % 4 == 0 and by 4-byte ``cp.async`` copies
   otherwise, bf16 by ``cp.async`` in 16-byte granules or, at even widths
   off the 16-byte row stride, 8- or 4-byte ones, odd bf16 widths with
   zero columns to a multiple of 8, the query tile resident up to d = 128
   and streamed
   above: d in {1, 2, 4, 6, 8, 36, 96, 100, 101, 102, 104, 126, 128, 132,
   960}, views off a 16-byte boundary, integer data bit for bit at d 100,
   101, 102, 128, 132 and, below 128, 960; uint8, int8, f16 and mixed
   inputs and a strided view); flash attention in f32 and bf16 (both
   kernels of ``flash_kernel``'s rule, on the tensor cores, in 3xTF32 for
   f32, at dh 8, 16, 64, 96, 128, 192 and 256, f32 at 36, and off the
   16-byte stride at 6, 100 and bf16 36, zero-padded; v narrower than q
   and k on the ``[dv]`` instances: 192 x 128, 160 x 64, 136 x 120, 64 x
   32, 96 x 32, 256 x 128 and 100 x 60), f16 and mixed inputs, ragged
   sizes, MQA (Hk = 1),
   causal and not, S != T;
3. builds a SIFT1B-width index (dim 128 uint8, M = 32, K = 256) over
   ``--n`` clustered vectors drawn from ``--seed`` through the public
   ``FusionANNSIndex.build``, and prints the cuts of scale on a
   ``reduced`` line with each build stage's time;
4. computes exact ground truth through the ``l2dist_wgmma`` kernel
   (``ground_truth``, chunks of 2^20 rows, f32 at d = 128) and once more
   through its plain version, and fails unless it launched that kernel and
   the ids are identical for every query (on uint8 data every partial sum
   is an integer below 2^24, so both are exact); serves ``--queries`` queries through three paths — the dense
   window (``window=64``), ``fused=True`` and ``fused=True,
   lut_int8=True`` — each with the launch counts set to 0 just before it
   and read just after, and prints recall@10 against the ground truth, QPS
   and p50/p99; it fails unless dense and fused f32 give identical ids for
   every query, f32 recall > 0.5, int8 recall >= f32 recall - 0.05, and
   each path launched its kernel;
5. drives the kernel entry points at full width, counts set to 0 just
   before: ``pq_adc`` and ``pq_adc_topk(topk=top_n)`` over the index's
   codes with the LUTs of the first 8 queries (top-k ids must equal the
   first top_n of a stable argsort of ``pq_adc``); ``l2_distances`` on the
   first ground-truth chunk in f32, in bf16, in bf16 cut to SPACEV1B's
   width (d = 100, rows of 200 bytes, off the 16-byte stride) and in
   bf16 cut to an odd d = 101 (rows on 2 bytes: zero-padded to 104),
   and the chunk's integers passed as uint8 (computed in bf16), each
   bit-equal to its plain version on the chunk's integers,
   then in f32 and bf16 on normal values of its shape, and in f32 and
   bf16 at GIST1M's width (d = 960, normal values, 2^20 rows: the query
   tile streamed); ``flash_attention`` at Qwen3-0.6B's attention widths
   (H = 16, Hk = 8), B = 1, S = T = 4096, causal, in bf16 and in f32 at
   dh = 128, at dh = 96 (a width no model of the repo has: the
   tensor-core kernels' 128 instances, padded) and at dh = 256 (their 256
   instances), and in bf16 at dh = 100 (off the 16-byte stride: copied
   with zero columns); and the fused scan's spill route at a window of
   B = 64, S = 32,768 (each query's valid rows uniform in [S/4, 3S/4]),
   tk = 4,096, in f32 and int8, bit-equal to its plain version; each
   against its plain version.  It fails unless each call launched the
   kernel its rule names, counted under its key: ``l2dist_wgmma`` (f32,
   d = 128), ``l2dist_wgmma[bf16]`` (bf16 and uint8),
   ``l2dist_wgmma[bf16,off16]`` (d = 100), ``l2dist_wgmma[bf16,odd]``
   (d = 101), ``l2dist_wgmma[d>128]`` and ``l2dist_wgmma[bf16,d>128]``
   (d = 960); ``flash_attn_fwd_wgmma`` (bf16) and ``flash_attn_fwd_tf32``
   (f32, 3xTF32) at dh = 128, the same kernels as ``[padded]`` at dh =
   96 and ``[256]`` at dh = 256, ``flash_attn_fwd_wgmma[stride-pad]`` at
   dh = 100; ``adc_fused_topk[spill]``;
6. holds each kernel against its plain version on the inputs its path
   gave it (the fused scan bit for bit, and once more at a multi-block
   window of S = 8,192 slots, timed and logged on its own line), and times
   kernel, plain version and (where one exists) a
   single PyTorch call computing the same function, with CUDA events,
   beside the least time the card could take: the operations at the
   fastest rate the card has for the function (``exact_products``: f32
   products in 3xTF32, three at 495 TFLOP/s, bf16 in one at 989, on
   whichever unit the kernel runs; the ADC scans' adds at the f32 rate of
   67), or the bytes at 3.35 TB/s, whichever is larger;
7. mutates the index of phase 3 (``mutation_phase``): inserts 1% of N
   (noisy copies, sigma 2, rounded and clipped to uint8, of rows picked
   by ``--seed`` and of each query, so every query's exact neighbours
   include inserted ids), deletes each query's ground-truth top-1 and a
   tenth of the inserts, computes ground truth over the live set through
   ``l2dist_wgmma``, serves the three paths with the delta scanned
   exactly, runs ``compact()`` (it must seal every inserted row and grow
   the physical rows by the live ones), serves them again on the
   re-published codes and holds those kernel calls against their plain
   versions; in both rounds no deleted id may come back, dense ids must
   equal fused ids, f32 recall > 0.5 and int8 recall >= f32 - 0.05.  It
   then saves a snapshot to a temporary directory, loads it onto the card
   and requires equal ids and distances on the dense and fused paths;
   runs the background compactor (``min_delta`` 4,096) while 20 batches
   of 1,024 inserts alternate with serving windows, and requires every
   inserted id sealed exactly once after ``stop_compactor(flush=True)``
   (which re-raises a seal's error); and trains OPQ over the N rows on
   the card, its k-means at the index codebook's 12 rounds from the same
   seed (rotation orthonormal to 1e-4, reconstruction error below the
   index's plain PQ), serving the dense and fused paths on an index that
   shares the built posting lists, graph and SSD tier (equal ids, recall
   > 0.5);
8. serves the index as phase 7 leaves it through the serving stack
   (``serving_phase``), with ground truth over its live rows through
   ``l2dist_wgmma``: (a) ``make_serving_stack(index, n_replicas=2,
   threaded=True)`` dense, ``fused=True`` and ``fused=True,
   lut_int8=True``, each fed the queries as ``SearchRequest``s by
   ``ANNSClient.search_many`` with the launch counts set to 0 just before
   and read just after: every answer must equal ``batch_query`` (dense),
   ``query_batch_fused`` (fused) or the int8 window's, the stack must
   launch its kernel and count every query served, and after ``stop()``
   (a window submitted just before it) no future may be pending; it
   prints recall@10, QPS and p50/p99 of ``latency_percentiles()``; (b) an
   ``AnnsEdge`` on 127.0.0.1 at an ephemeral port over the dense stack,
   two tenants with API keys and a quota of 32 on one: 64 searches over
   four keep-alive connections from an asyncio client in this process
   return the dense ids, the next search past the quota gets 429,
   ``/v1/stats`` and ``/healthz`` 200; (d) 64 ``adaptive=True``
   requests, one at a time, with a deadline the planner (which observed
   the served traffic) resolves to a reduced accuracy level: recall@10 >
   0.5; (c) ``add_replica()`` hydrates a replica from a snapshot in a
   temporary directory onto the card, which must answer as its donor;
   1,024 inserts and the deletion of the first 64 queries' top-1 ids
   through the router: no deleted id comes back, donor and hydrated
   replica answer alike; ``remove_replica()`` under load loses no future;
   (e) one ``ReplicaAutoscaler.tick()`` after a queued burst, its decision
   and ``_model_cap`` printed.  The kernels line's serving rows count
   these stacks' launches too;
9. runs the mesh half over the index as phase 8 leaves it
   (``mesh_phase``, no new index): ``make_test_mesh(4)``, four cards where
   there are four, else four logical devices on ``cuda:0`` (printed),
   whose shards then run one after another on one card: (a)
   ``make_executor`` over the mesh and over one half of it
   (``split_mesh``) serves the dense, fused and int8 paths, each answer
   equal to a one-device executor's and each path's kernel launched
   exactly shards x windows times (counts set to 0 just before each
   sharded run and read just after), QPS of the sharded and one-device
   runs printed side by side (no limit); (b) over the index's codes, cut
   to whole blocks of 65,536 rows a shard, ``sharded_adc_topn`` (one LUT,
   top-n 512) and ``sharded_adc_topn_batch`` (8 LUTs) equal
   ``pq_adc_topk`` / ``pq_adc_topk_batch`` bit for bit with four
   launches each, and ``sharded_topk`` on (64, 2^20) f32 scores with
   ties planted at every shard boundary equals its plain version (a
   stable sort); (c) two-replica stacks carved from the mesh (dense and
   fused) answer as ``batch_query`` / ``query_batch_fused``,
   ``add_replica()`` re-carves them to [2, 1, 1] shards with the answers
   unchanged, ``remove_replica()`` under load loses no future; (d) the
   paper's SPANN-like, HI+PQ and RUMMY-like baselines
   (``core.baselines``) serve 16 queries over the sealed tiers with
   recall@10 > 0.5, their mean I/Os printed (DiskANN-like is not run: its
   graph build is a host loop).  The kernels line's rows of
   ``adc_scan_batch``, ``adc_fused_topk`` (f32 and int8) and
   ``adc_scan_topk`` count phase 9's sharded launches too;
10. serves Qwen3-0.6B at its full config (``configs/qwen3_0_6b.py``: 28
   layers, d 1024, H 16, Hk 8, dh 128, vocabulary 151,936; random
   weights from ``--seed``) beside the index as phase 9 leaves it
   (``lm_phase``): (a) ``lm_prefill`` at B = 2, S = 4,096 in bf16 and in
   f32, counts set to 0 just before and read just after: each forward
   must launch ``flash_attn_fwd_wgmma`` (bf16) or ``flash_attn_fwd_tf32``
   (f32) exactly 28 times and nothing else, and each batch row's
   last-position logits must lie within ``LM_ROW_RTOL`` (L2 error over
   L2 norm) of the same prefill on the plain attention (the CPU path's
   scan, run on the card); it prints the forward's ms and the flash
   kernel's share of it; (b) the f32 ``lm_decode_step`` over the first
   64 positions of one sequence equals ``lm_forward(dtype=float32)``
   within rtol = atol = 2e-3; (c) greedy ``LMServer.generate`` (B = 8,
   prompt 64, 64 new tokens) twice gives the same tokens, in the
   vocabulary, the first of them the argmax of the f32 prefill's logits
   of the prompts (or within 2e-3 of it: a rounding tie), and prints
   tokens/s; (d) ``RAGPipeline.answer_batch`` of 16 queries at k = 10,
   through ``submit`` and through a two-replica ``make_serving_stack``
   router: the retrieved ids equal ``batch_query``'s top-10, the dense
   kernel launched on both routes, the same tokens on both.  The flash
   rows and ``adc_scan_batch``'s of the kernels line count phase 10's
   launches too;
11. serves the MoE LMs beside the index as phase 10 leaves it
   (``moe_phase``), their weights stored in bf16 from ``--seed``:
   DeepSeek-V2-Lite at its full config (``configs/deepseek_v2_lite_16b
   .py``: 27 layers, the first dense, d 2048, MLA with q/k 192 and v 128
   wide, 64 routed experts top-6 and 2 shared, vocabulary 102,400; 15.7B
   params, 31.4 GB): (a) ``lm_prefill`` at B = 2, S = 4,096 in bf16 and
   f32 as phase 10 (a), each forward launching the dtype's ``[dv]``
   flash instance exactly 27 times and nothing else, rows within
   ``MOE_ROW_RTOL``; it prints the pairs dropped past the experts'
   capacity (also layer by layer, beside the most pairs one expert got
   and the mean cosine of the router's inputs) and the expert
   assignments that differ between the kernel and the plain run; (b) as phase 10 (b) at capacity factor 16 (the
   forward then drops no pair, as one-token decode steps never do); (c)
   as phase 10 (c), the first token held to the f32 prefill at capacity
   factor 16, the pairs the decode steps dropped printed; (d) as phase
   10 (d) through ``submit``; then the ``[dv]`` instances alone at its
   attention shape (B = 1, S = T = 4,096, H = Hk = 16, 192 x 128),
   against their plain versions; and Qwen3-30B-A3B at full width (d
   2048, 128 experts top-8, H 32, Hk 4, dh 128, qk-norm) with its depth
   cut to ``MOE_LAYERS`` of 48, (a) with ``flash_attn_fwd_wgmma`` /
   ``flash_attn_fwd_tf32`` once a layer, and (b).  The kernels line's
   flash rows count phase 11's launches too, and its ``[dv]`` rows are
   timed at DeepSeek-V2-Lite's attention shape;
12. trains Qwen3-0.6B at its full config in f32 (random weights from
   ``--seed``) after phase 11 has freed its weights (``train_phase``):
   (a) the attention backward kernel ``flash_attn_bwd`` at row 6b's shape
   (B = 1, S = T = 4,096, H 16, Hk 8, dh 128, causal) on f32 and on bf16
   inputs, each gradient within ``BWD_RTOL`` relative L2 of
   ``flash_attn_bwd_ref`` evaluated in f64 on the same residuals (its
   errors against the f32 evaluation, and that one's against the f64,
   printed beside), bit-equal across two
   runs, the forward kernel's lse within ``LSE_RTOL`` of the plain
   forward's, timed beside its plain version, SDPA's backward alone and
   its bound (five products); (b) the gradients of ``lm_loss`` on one
   ``lm_batch`` at B = 2, S = 2,048 through the kernels, with TF32
   allowed by the caller, each leaf within ``TRAIN_GRAD_RTOL`` relative
   L2 of the same gradient on the plain attention (the CPU path's scan
   and backward, on the card) with TF32 off; (c) every
   train step launches exactly 56 ``flash_attn_fwd_tf32`` (full remat:
   each block's forward twice) and 28 ``flash_attn_bwd`` and nothing else
   of flash; (d) 25 steps on that batch at lr 1e-3 lower the loss by more
   than 0.5 (the reference's ``test_loss_decreases``), a second run of
   three gives the first three losses to 1e-6, and it prints the step's
   ms and tokens/s; one bf16 gradient launches ``flash_attn_fwd_wgmma``
   56 times and the backward's bf16 instance 28 (``flash_attn_bwd[bf16]``,
   on bf16 residuals); (e) ``supervise``
   with ``FaultInjector([7])``, ``ckpt_every=5`` (checkpoints in a
   temporary directory) resumes from step 5 and ends at step 10, at full
   width with the depth cut to ``FAULT_LAYERS`` (a ``reduced`` line).
   The kernels line's f32 and bf16 flash forward rows count phase 12's
   launches too, and it gains the backward's rows (``flash_attn_bwd``, the
   f32 instance, and ``flash_attn_bwd@bf16``, the bf16 one).

Flash attention is held to its plain version elementwise (2e-5 in f32,
2e-3 in f16, 5e-2 in bf16) and, in bf16, row by row: each (b, s, h)
row's L2 error within 2^-6 of its L2 norm (``check_attn``).

The second-to-last line is a JSON object ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
then exits non-zero and prints no result.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # float32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 on the tensor cores
BF16_FLOPS = 989e12              # dense bf16 on the tensor cores
RTOL = 1e-5                      # M f32 terms summed in another order
L2_ATOL = 1e-3                   # D products summed in another order
FLASH_TOL = {torch.float32: 2e-5,    # online softmax against a plain one
             torch.float16: 2e-3,    # output rounded to f16 on each side
             torch.bfloat16: 5e-2}   # output rounded to bf16 on each side
# bf16 flash, also: each (b, s, h) row's L2 error within 2^-6 of the row's
# L2 norm.  A sound kernel differs by its P rounded to bf16 (at most 2^-8
# of a row's weight) and one final rounding; long rows' outputs are small
# (|o| ~ sqrt(e / (s + 1))), so an elementwise limit alone misses a wrong
# K/V tile there, but it moves the row by a large share of its norm.
FLASH_ROW_RTOL = 2.0 ** -6
WINDOW = 64
MULTI_S = 8192                  # phase 6's multi-block fused window
QWEN3_ATTN = dict(H=16, Hk=8, dh=128)    # src/repro/configs/qwen3_0_6b.py
SPACEV_DIM = 100                         # configs/anns_datasets.SPACEV1B.dim
ODD_DIM = 101               # an odd bf16 width: rows on 2 bytes
GIST_DIM = 960              # GIST1M's width (ann-benchmarks); no config here
FLASH_PADDED_DH = 96        # a head width padded to 128; no model here
FLASH_WIDE_DH = 256         # the tensor-core kernels' 256 instances
FLASH_OFF_STRIDE_DH = 100   # bf16 rows off 16 bytes: zero-padded to 104
SPILL = dict(S=32_768, topk=4096)   # a fused window past fused_plan
SERVE_PATHS = (("dense", "adc_scan_batch", {}),
               ("fused", "adc_fused_topk", {"fused": True}),
               ("fused_int8", "adc_fused_topk", {"fused": True,
                                                 "lut_int8": True}))
# phase 8: the stack whose launches add to each serving kernel's row
SERVING_KEYS = {"adc_scan_batch": "dense", "adc_fused_topk": "fused",
                "adc_fused_topk[lut_int8]": "fused_int8"}
NOISE_SIGMA = 2.0           # phase 7: noise of an inserted copy of a row
COMPACTOR_BATCHES, COMPACTOR_BATCH = 20, 1024
STACK_TIMEOUT_S = 300.0     # phase 8: the longest wait on any answer
EDGE_BURST = 32             # phase 8: alice's quota (bob's is unlimited)
EDGE_RATE_QPS = 1e-3        # alice's refill: no token comes back in a run
HYDRATE_INSERTS = 1024      # phase 8: rows inserted through the router
ADAPTIVE_N = 64             # phase 8: adaptive requests, one at a time
ADAPTIVE_PROBES = 16        # plain single requests timed before them
ADAPTIVE_SLACK = 4.0        # their deadline: this times the probes' p99
COMPACTOR_MIN_DELTA = 4096
MESH_TOP_N = 512            # phase 9 (b): the sharded scans' top-n
MESH_LUTS = 8               # phase 9 (b): LUTs of the batched scan
TOPK_SCORES = (64, 1 << 20)     # phase 9 (b): sharded_topk's scores
BASELINE_QUERIES = 16       # phase 9 (d): queries a baseline serves
PQ_ROUNDS = 12              # pq.train_codebooks' default: the index's
ATTN_LEN = 4096                          # S = T of the full-width flash run
LM_ARCH = "qwen3-0.6b"      # phase 10: the LM, at its full CONFIG
PREFILL = (2, 4096)         # phase 10 (a): B, S of the prefill
# (a): each batch row's last-position logits, L2 error over L2 norm,
# against the same prefill on the plain attention.  bf16: the kernel
# rounds P to bf16 in each of 28 layers and the layers' outputs round to
# bf16 on both sides; read 0.01453 on the H100 at this seed, so 2^-5
LM_ROW_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -5}
DECODE_LEN = 64             # (b): positions decoded against the forward
DECODE_TOL = 2e-3           # (b): rtol = atol (tests/test_serve.py's)
GEN = dict(batch=8, prompt=64, new=64)   # (c)
RAG_QUERIES, RAG_K, RAG_PROMPT, RAG_NEW = 16, 10, 8, 8   # (d)
MLA_ARCH = "deepseek-v2-lite-16b"   # phase 11 (a)-(d): at its full CONFIG
MOE_ARCH = "qwen3-moe-30b-a3b"      # phase 11 (e): full width, depth cut
MOE_LAYERS = 8              # (e): of 48; 61 GB of bf16 weights beside
                            # the 15 GB index leave no room to run
MOE_CAPACITY = 16.0         # (b), (c): no pair dropped by the forward
# phase 11 (a): as LM_ROW_RTOL, per arch; bf16 set from the first reading
# (read on the H100 at this seed: DeepSeek-V2-Lite 0.03244, where routing
# follows each side's bf16 rounding, so some tokens take other experts;
# Qwen3-30B-A3B at 8 layers 0.01694)
MOE_ROW_RTOL = {MLA_ARCH: {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -4},
                MOE_ARCH: {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -5}}
# phase 12 (a): the backward kernel's dq, dk, dv, relative L2 against its
# plain version evaluated in f64 on the same residuals (rounded to the
# gradients' dtype: the exact gradient of the reference's function): f32
# 1e-4; on bf16 inputs both sides round to bf16 once, so a rounding that
# falls the other way moves an element by up to 2^-8 of it: 6.7e-5, twice
# PR 28's first reading against the plain version in f32 (dq 3.36e-5, dk
# and dv 0: its dk and dv summed in that version's order, bit-equal).  The
# f32 plain version is itself off the exact gradient by its own rounding:
# on bf16 inputs its dk and dv are 9.1e-5 and 1.1e-4 from the exact ones at
# this seed, past the limit, so a kernel that sums in another order cannot
# be held to it there; the kernel's errors against it are printed too.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 6.7e-5}
# (a): the forward's lse against the plain one's, relative to at least 1
# (the first causal row's lse is its one scaled score, which may be ~0)
LSE_RTOL = 1e-5
TRAIN_BATCH = (2, 2048)     # (b)-(d): B, S of the lm_batch
TRAIN_GRAD_RTOL = 1e-4      # (b): each gradient leaf's relative L2 error
TRAIN_STEPS, TRAIN_LR = 25, 1e-3   # (d): tests/test_train.py's recipe
FAULT_LAYERS = 2            # (e): of 28, at full width
FAULT_BATCH = (2, 512)      # (e): B, S
PQ_SRC = "src/repro_torch/kernels/pq_adc/csrc/"
PQ_TPU = "src/repro/kernels/pq_adc/pq_adc.py:"
FLASH_SRC = "src/repro_torch/kernels/flash_attn/csrc/"
L2_SRC = "src/repro_torch/kernels/l2dist/csrc/"
KERNELS = {
    "adc_scan_batch": dict(route="cuda", source=PQ_SRC + "adc_scan_batch.cu",
                           replaces=PQ_TPU + "80"),
    "adc_fused_topk": dict(route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
                           replaces=PQ_TPU + "239"),
    "adc_fused_topk[lut_int8]": dict(
        route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
        replaces=PQ_TPU + "177"),
    "adc_fused_topk[spill]": dict(
        route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
        replaces=PQ_TPU + "239"),
    "adc_fused_topk[spill,lut_int8]": dict(
        route="cuda", source=PQ_SRC + "adc_fused_topk.cu",
        replaces=PQ_TPU + "177"),
    "adc_scan": dict(route="cuda", source=PQ_SRC + "adc_scan.cu",
                     replaces=PQ_TPU + "43"),
    "adc_scan_topk": dict(route="cuda", source=PQ_SRC + "adc_scan_topk.cu",
                          replaces=PQ_TPU + "133"),
    "l2dist_wgmma": dict(route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
                         replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[bf16]": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[bf16,off16]": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[d>128]": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[bf16,d>128]": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[bf16,odd]": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "l2dist_wgmma[bf16]@uint8": dict(
        route="cuda", source=L2_SRC + "l2dist_wgmma.cu",
        replaces="src/repro/kernels/l2dist/l2dist.py:38"),
    "flash_attn_fwd_wgmma": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_tf32": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_tf32.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_wgmma[padded]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_tf32[padded]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_tf32.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_wgmma[256]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_tf32[256]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_tf32.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_wgmma[stride-pad]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_wgmma[dv]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    "flash_attn_fwd_tf32[dv]": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_fwd_tf32.cu",
        replaces="src/repro/kernels/flash_attn/flash_attn.py:92"),
    # the reference's attention VJP (jnp, no pallas_call): _flash_bwd
    "flash_attn_bwd": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_bwd.cu",
        replaces="src/repro/models/layers.py:173"),
    "flash_attn_bwd@bf16": dict(
        route="cuda", source=FLASH_SRC + "flash_attn_bwd.cu",
        replaces="src/repro/models/layers.py:173"),
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


def check_tol(name: str, got: torch.Tensor, want: torch.Tensor,
              rtol: float, atol: float) -> float:
    """Values within rtol/atol (compared in f32); returns the max abs
    error."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(w.shape)}")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max abs error {err} beyond rtol "
                             f"{rtol}, atol {atol}")
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest L2 error of a last-axis row over that row's L2 norm."""
    g, w = got.float(), want.float()
    err = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return float(err.max()) if err.numel() else 0.0


def check_attn(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Flash attention against its plain version: every element within
    FLASH_TOL of its dtype and, in bf16, every (b, s, h) row within
    FLASH_ROW_RTOL; returns the max abs error."""
    tol = FLASH_TOL[want.dtype]
    err = check_tol(name, got, want, tol, tol)
    if want.dtype == torch.bfloat16:
        row = row_rel_err(got, want)
        if row > FLASH_ROW_RTOL:
            raise AssertionError(f"{name}: a row's relative L2 error {row} "
                                 f"beyond {FLASH_ROW_RTOL}")
    return err


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up.
    The card first spins for about 20 ms, so the host has queued the runs
    before the start event and the events time the device, not the
    host's launches."""
    fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
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
    for m in (8, 24, 25, 32):
        check_fused_small(dev, rng, m)
    torch.cuda.synchronize()


def check_fused_small(dev: torch.device, rng: np.random.Generator,
                      m: int) -> None:
    """The fused kernel bit-equal to its plain version: B = 1 (a cluster
    of eight CTAs), 5 (one CTA a query) and 64 (four) at S from 37 to
    8,192, and B = 8 at S = 32,768 with tk = 4,096 (the spill route:
    sixteen CTAs a query, their lists merged by a second kernel), valid
    rows below and above tk, the last query all pads, query
    1's last three rows >= N (pads on the card; -1 for the plain
    version), exact ties from repeated code rows; M = 8, DEEP1B's 24 (8-byte
    code loads), SPACEV1B's 25 (1-byte) and 32 (16-byte)."""
    from repro_torch.kernels.pq_adc import ops
    n, k, dsub = 50_000, 256, 4
    cb = torch.from_numpy(rng.standard_normal((m, k, dsub)).astype(
        np.float32)).to(dev)
    base = rng.integers(0, 256, (n // 4, m)).astype(np.uint8)
    codes = torch.from_numpy(np.repeat(base, 4, axis=0)).to(dev)
    for b, s, topk in ((1, 3000, 10), (64, 5000, 512), (64, 2048, 3000),
                       (64, 8192, 512), (5, 37, 512),
                       (8, SPILL["S"], SPILL["topk"])):
        rows = np.full((b, s), -1, np.int32)
        for i in range(b - 1 if b > 1 else b):   # last row all pads
            c = int(rng.integers(1, s + 1))
            rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
        c1 = int((rows[min(1, b - 1)] >= 0).sum())
        if b > 2 and c1 >= 3:
            rows[1, c1 - 3:c1] = n + np.array([0, 7, 100])
        rows_t = torch.from_numpy(rows).to(dev)
        plain_rows = torch.from_numpy(np.where(rows >= n, -1, rows).astype(
            np.int32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, m * dsub)).astype(
            np.float32)).to(dev)
        for int8 in (False, True):
            kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows_t, topk,
                                           lut_int8=int8)
            pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, plain_rows,
                                                 topk, lut_int8=int8)
            if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                raise AssertionError(f"adc_fused_topk m{m} b{b} s{s} "
                                     f"k{topk} int8={int8}: not bit-equal "
                                     f"to its plain version")


def check_l2_small(dev: torch.device, rng: np.random.Generator) -> None:
    """The exact-L2 kernel against the plain version, in f32, bf16 and
    other dtypes: each call must launch the kernel ``l2_kernel`` names,
    and only it, counted under ``l2_instance``'s key for the operand
    dtype."""
    from repro_torch.kernels.l2dist import (l2_distances, l2_instance,
                                            l2dist_ref)
    from repro_torch.kernels.launch import operand_dtype
    from repro_torch.kernels.pq_adc import ops

    def run(name, q, v, exact=False):
        before = dict(ops.LAUNCHES)
        got = l2_distances(q, v)
        torch.cuda.synchronize()
        ran = {k for k, c in ops.LAUNCHES.items() if c != before[k]}
        want = l2_instance(operand_dtype(q.dtype, v.dtype), q.shape[1])
        if ran != {want}:
            raise AssertionError(f"{name} launched {sorted(ran)}, not {want}")
        if exact and not torch.equal(got, l2dist_ref(q, v)):
            raise AssertionError(f"{name}: not bit-equal on integer data")
        check_tol(name, got, l2dist_ref(q, v), RTOL, L2_ATOL)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    for dtype in (torch.float32, torch.bfloat16):
        # bf16 at d 1 and 101 zero-padded to 8 and 104; the query tile
        # streamed at 132 and 960, f32 by 4-byte cp.async copies at d 1,
        # 2, 6, 101, 102 and 126, bf16 by cp.async at d 2, 4, 6, 36, 100,
        # 102 and 126 (rows off 16 bytes)
        for b, n, d in ((1, 1, 1), (3, 777, 100), (129, 1000, 128),
                        (256, 5003, 96), (1, 5003, 4), (130, 777, 36),
                        (1, 5003, 8), (130, 777, 104), (5, 777, 2),
                        (130, 5003, 6), (129, 777, 126), (3, 777, 101),
                        (3, 777, 102), (129, 1000, 132), (5, 5003, 960)):
            run(f"l2dist {dtype} b{b} n{n} d{d}", normal(b, d).to(dtype),
                normal(n, d).to(dtype))
        # views off a 16-byte boundary, copied before the tensor-core loads
        for d in (104, 100):
            flat = normal(3 * d + 1).to(dtype)
            run(f"l2dist {dtype} unaligned view d{d}", flat[1:].view(3, d),
                normal(777, d).to(dtype))
        # integer data below 256 (exact in bf16): every partial sum is
        # exact, so equal bit for bit (at d 132 still below 2^24: 132 *
        # 255^2; at d 960 below 128: 960 * 127^2)
        for d, below in ((100, 256), (101, 256), (102, 256), (128, 256),
                         (132, 256), (960, 128)):
            ints = [torch.from_numpy(rng.integers(0, below, shape).astype(
                np.float32)).to(dev, dtype) for shape in ((37, d), (3001, d))]
            run(f"l2dist {dtype} integers d{d}", *ints, exact=True)
    # other dtypes, as the JAX wrapper takes them: uint8 and int8 in bf16
    # (exact), f16 and mixed in f32; a transposed (strided) view
    for qd, vd, d in ((torch.uint8, torch.uint8, 128),
                      (torch.int8, torch.int8, 100),
                      (torch.uint8, torch.uint8, 101),
                      (torch.float16, torch.float16, 96),
                      (torch.uint8, torch.float32, 64)):
        q, v = (torch.from_numpy(rng.integers(0, 100, shape).astype(
            np.float32)).to(dev, dt) for dt, shape in ((qd, (37, d)),
                                                       (vd, (3001, d))))
        run(f"l2dist {qd}/{vd} integers d{d}", q, v, exact=True)
    run("l2dist strided view", normal(64, 40).T, normal(777, 64))


def check_entry_kernels_small(dev: torch.device,
                              rng: np.random.Generator) -> None:
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.pq_adc import ops, ref
    for m in (8, 16, 32):
        # ragged N, N < topk, short last ranges, topk above a range of
        # rows (every row kept), a topk that fills the candidate buffer
        # (2,048 + a round of 2,048 = 4,096 slots: each round with a
        # candidate compacts), and rows in descending distance (every row
        # beats the running threshold); every code row three times, so
        # distances tie exactly and ids must come out lowest row first
        for n, topk, descending in (
                (1, 10, False), (5, 512, False), (777, 512, False),
                (2048 + 7, 32, False), (3 * 2048 + 5, 2048, False),
                (50_000, 4000, False), (2_000_001, 2048, False),
                (2_000_001, 512, True)):
            base = rng.integers(0, 256, (-(-n // 3), m)).astype(np.uint8)
            codes = torch.from_numpy(np.repeat(base, 3, axis=0)[:n]).to(dev)
            lut = torch.from_numpy(rng.random((m, 256)).astype(
                np.float32)).to(dev)
            if descending:
                codes = codes[torch.sort(ref.pq_adc_ref(codes, lut),
                                         descending=True, stable=True)[1]]
            flat = torch.empty(n * m + 1, dtype=torch.uint8, device=dev)
            flat[1:] = codes.reshape(-1)
            # a 1-byte storage offset exercises the byte-load path too
            for cds in (codes, flat[1:].view(n, m)):
                check_close(f"adc_scan m{m} n{n}", ops.pq_adc(cds, lut),
                            ref.pq_adc_ref(cds, lut))
                kv, ki = ops.pq_adc_topk(cds, lut, topk)
                pv, pi = ops.pq_adc_topk_plain(cds, lut, topk)
                check_close(f"adc_scan_topk m{m} n{n} k{topk}", kv, pv, ki,
                            pi)
                if not torch.equal(ki, pi):
                    raise AssertionError("adc_scan_topk ids differ on exact "
                                         "ties")
    check_l2_small(dev, rng)
    for dtype in (torch.float32, torch.bfloat16):
        # MQA (Hk = 1), causal and not, S != T both ways, ragged tiles
        for bsz, s, t, h, hk, dh, causal in (
                (2, 16, 16, 4, 2, 8, True), (1, 32, 32, 2, 2, 16, False),
                (2, 100, 100, 6, 3, 64, True), (1, 24, 24, 4, 1, 8, True),
                (1, 70, 130, 4, 2, 128, True), (1, 130, 70, 4, 4, 128, True),
                (1, 257, 257, 8, 1, 128, False), (2, 97, 97, 4, 2, 96, True),
                (1, 1, 65, 2, 1, 64, True), (1, 40, 40, 2, 1, 6, True),
                (1, 50, 70, 4, 2, 36, False), (1, 70, 50, 2, 2, 192, True),
                (1, 65, 65, 2, 1, 256, False), (2, 97, 97, 4, 2, 100, True),
                (1, 130, 70, 4, 1, 130, True),
                (1, 70, 130, 2, 2, 250, False)):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype) for shape in (
                    (bsz, s, h, dh), (bsz, t, hk, dh), (bsz, t, hk, dh)))
            check_attn(f"flash_attention {dtype} {(bsz, s, t, h, hk, dh)} "
                       f"causal={causal}",
                       flash_attention(q, k, v, causal=causal),
                       flash_attn_ref(q, k, v, causal=causal))
        # v narrower than q and k (the [dv] instances; MLA's 192 x 128)
        for bsz, s, t, h, hk, dh, dv, causal in (
                (1, 70, 130, 4, 2, 192, 128, True),
                (1, 130, 70, 2, 1, 160, 64, False),
                (2, 97, 97, 4, 4, 136, 120, True),
                (2, 97, 97, 4, 4, 64, 32, True),
                (1, 130, 70, 2, 1, 96, 32, False),
                (1, 65, 65, 4, 2, 256, 128, True),
                (1, 50, 50, 2, 2, 100, 60, True)):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype) for shape in (
                    (bsz, s, h, dh), (bsz, t, hk, dh), (bsz, t, hk, dv)))
            check_attn(f"flash_attention {dtype} "
                       f"{(bsz, s, t, h, hk, dh, dv)} causal={causal}",
                       flash_attention(q, k, v, causal=causal),
                       flash_attn_ref(q, k, v, causal=causal))
    # f16 and mixed inputs (computed in f32, returned in q's dtype) and
    # strided views of q, k and v
    x = torch.from_numpy(rng.standard_normal((1, 90, 6, 64)).astype(
        np.float32)).to(dev)
    for q, k, v in ((x[:, :, :4].half(), x[:, :, 4:5].half(),
                     x[:, :, 5:].half()),
                    (x[:, :, :4], x[:, :, 4:5].bfloat16(),
                     x[:, :, 5:].half()),
                    (x[:, :, :4], x[:, :, 4:5], x[:, :, 5:])):
        check_attn(f"flash_attention {q.dtype}/{k.dtype}/{v.dtype} views",
                   flash_attention(q, k, v), flash_attn_ref(q, k, v))
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
    the main path runs, so phase 6 can hold the kernels against their
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


def ground_truth_plain(data: np.ndarray, queries: np.ndarray,
                       k: int) -> np.ndarray:
    """``ground_truth`` with its distance blocks from the plain version
    of the ``l2dist`` kernel."""
    from repro_torch.core import engine
    from repro_torch.kernels.l2dist.ref import l2dist_ref
    kernel = engine.l2_distances
    engine.l2_distances = l2dist_ref
    try:
        return engine.ground_truth(data, queries, k)
    finally:
        engine.l2_distances = kernel


# ---------------------------------------------------------------- phase 5
def drive_entry_points(index, top_n: int, data: np.ndarray,
                       queries: np.ndarray, seed: int):
    """The kernel entry points at full width, launch counts set to 0 just
    before and read just after; then each output against its plain
    version.  Returns (launches, the inputs for phase 6)."""
    from repro_torch.core.pq import adc_lut_batch
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    from repro_torch.kernels.pq_adc import ops, ref
    dev = index.device
    codes = index.codes
    luts = adc_lut_batch(index.codebook, torch.from_numpy(queries[:8]).to(
        dev))
    q = torch.from_numpy(queries).to(dev)
    chunk = torch.from_numpy(np.ascontiguousarray(data[:1 << 20])).to(
        dev).float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, h, hk = ATTN_LEN, QWEN3_ATTN["H"], QWEN3_ATTN["Hk"]
    # flash at Qwen3-0.6B's widths in bf16 and f32 (on the tensor cores),
    # at a head width padded to their 128 instances, at dh = 256 (their
    # 256 instances), and in bf16 at a width off the 16-byte row stride
    flash_calls = {
        name: tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                    for shape in ((1, s, h, dh), (1, s, hk, dh),
                                  (1, s, hk, dh)))
        for name, dtype, dh in (
            ("flash_attn_fwd_wgmma", torch.bfloat16, QWEN3_ATTN["dh"]),
            ("flash_attn_fwd_tf32", torch.float32, QWEN3_ATTN["dh"]),
            ("flash_attn_fwd_wgmma[padded]", torch.bfloat16,
             FLASH_PADDED_DH),
            ("flash_attn_fwd_tf32[padded]", torch.float32, FLASH_PADDED_DH),
            ("flash_attn_fwd_tf32[256]", torch.float32, FLASH_WIDE_DH),
            ("flash_attn_fwd_wgmma[256]", torch.bfloat16, FLASH_WIDE_DH),
            ("flash_attn_fwd_wgmma[stride-pad]", torch.bfloat16,
             FLASH_OFF_STRIDE_DH))}
    q16, chunk16 = q.bfloat16(), chunk.bfloat16()
    # the chunk in f32 (TMA loads) and in bf16 (16-byte cp.async copies)
    # at SIFT1B's width, in bf16 cut to SPACEV1B's width, d = 100 (rows of
    # 200 bytes, off the 16-byte stride: 8-byte copies), all on the tensor
    # cores, in bf16 cut to an odd width, d = 101 (zero-padded to 104),
    # and as uint8, SIFT1B's own type (computed in bf16, exactly); and
    # normal values at GIST1M's width, d = 960, over the chunk's rows in
    # f32 and bf16 (the query tile streamed)
    gist = [torch.randn(rows, GIST_DIM, generator=gen, device=dev)
            for rows in (len(q), len(chunk))]
    l2_calls = {"l2dist_wgmma": (q, chunk),
                "l2dist_wgmma[bf16]": (q16, chunk16),
                "l2dist_wgmma[bf16,off16]": (
                    q16[:, :SPACEV_DIM].contiguous(),
                    chunk16[:, :SPACEV_DIM].contiguous()),
                "l2dist_wgmma[bf16,odd]": (
                    q16[:, :ODD_DIM].contiguous(),
                    chunk16[:, :ODD_DIM].contiguous()),
                "l2dist_wgmma[bf16]@uint8": (
                    q.to(torch.uint8),
                    torch.from_numpy(np.ascontiguousarray(
                        data[:1 << 20])).to(dev)),
                "l2dist_wgmma[d>128]": tuple(gist),
                "l2dist_wgmma[bf16,d>128]": tuple(x.bfloat16()
                                                  for x in gist)}
    del gist
    on_integers = ("l2dist_wgmma", "l2dist_wgmma[bf16]",
                   "l2dist_wgmma[bf16,off16]", "l2dist_wgmma[bf16,odd]",
                   "l2dist_wgmma[bf16]@uint8")
    # the fused scan's spill route: a window of B = 64 at S = 32,768 over
    # the index's codes, tk = 4,096 (f32 and int8)
    spill_rows = window_rows(WINDOW, SPILL["S"], codes.shape[0], dev,
                             torch.Generator(device=dev).manual_seed(
                                 SPILL["S"]))
    spill_q = torch.from_numpy(queries[:WINDOW]).to(dev)
    spill_calls = {
        key: (codes, spill_q, index.codebook.codebooks,
              spill_rows, SPILL["topk"])
        for key in ("adc_fused_topk[spill]",
                    "adc_fused_topk[spill,lut_int8]")}
    torch.cuda.synchronize()

    ops.reset_launches()
    dists = [ops.pq_adc(codes, luts[i]) for i in range(len(luts))]
    tops = [ops.pq_adc_topk(codes, luts[i], top_n) for i in range(len(luts))]
    d2, ran, fused = {}, {}, {}
    for key, qv in l2_calls.items():
        before = dict(ops.LAUNCHES)
        d2[key] = l2_distances(*qv)
        ran[key] = {name for name, c in ops.LAUNCHES.items()
                    if c != before[name]}
    for key, args in spill_calls.items():
        before = dict(ops.LAUNCHES)
        fused[key] = ops.pq_adc_fused_topk(
            *args, lut_int8=key.endswith("lut_int8]"))
        ran[key] = {name for name, c in ops.LAUNCHES.items()
                    if c != before[name]}
    outs = {}
    for key, qkv in flash_calls.items():
        before = dict(ops.LAUNCHES)
        outs[key] = flash_attention(*qkv, causal=True)
        ran[key] = {name for name, c in ops.LAUNCHES.items()
                    if c != before[name]}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for key, got in ran.items():    # each call is keyed by its kernel
        if got != {launch_key(key)}:
            raise AssertionError(f"the call for {key} launched "
                                 f"{sorted(got)}")

    for key, args in spill_calls.items():
        int8 = key.endswith("lut_int8]")
        pv, pi = ops.pq_adc_fused_topk_plain(*args, lut_int8=int8)
        if not (torch.equal(fused[key][0], pv)
                and torch.equal(fused[key][1], pi)):
            raise AssertionError(f"{key} at B={WINDOW}, S={SPILL['S']}, "
                                 f"tk={SPILL['topk']}: not bit-equal to "
                                 f"its plain version")
        log(f"{key} at B={WINDOW}, S={SPILL['S']}, tk={SPILL['topk']}: "
            f"bit-equal to its plain version")
    del fused

    for i, (d, (tv, ti)) in enumerate(zip(dists, tops)):
        check_close(f"adc_scan query {i} at N={len(codes)}", d,
                    ref.pq_adc_ref(codes, luts[i]))
        order = torch.sort(d, stable=True)[1][:top_n]
        if not (torch.equal(ti.long(), order) and torch.equal(tv, d[order])):
            raise AssertionError(f"pq_adc_topk query {i}: not the first "
                                 f"{top_n} of a stable argsort of pq_adc")
    for key, qv in l2_calls.items():
        what = (f"l2_distances {qv[0].dtype} d={qv[0].shape[1]} "
                + ("on the first ground-truth chunk" if key in on_integers
                   else "on normal values over the chunk's rows")
                + f" ({key})")
        want = l2dist_ref(*qv)
        # integers: every sum exact
        if key in on_integers and not torch.equal(d2[key], want):
            raise AssertionError(f"{what}: not bit-equal to the plain "
                                 f"version on integer data")
        err = check_tol(what, d2[key], want, RTOL, L2_ATOL)
        log(f"{what}: {'bit-equal, ' if key in on_integers else ''}"
            f"max abs error {err}")
        del want
    del d2
    # the chunk's integers leave every lo part 0 and every sum exact, so
    # hold the tensor cores' products (in f32 the cross products hi*lo,
    # lo*hi) and sums at full width on normal values of its shape
    qn, vn = (torch.randn(x.shape, generator=gen, device=dev)
              for x in (q, chunk))
    for key, dtype in (("l2dist_wgmma", torch.float32),
                       ("l2dist_wgmma[bf16]", torch.bfloat16)):
        qd, vd = qn.to(dtype), vn.to(dtype)
        before = dict(ops.LAUNCHES)
        got = l2_distances(qd, vd)
        torch.cuda.synchronize()
        ran = {name for name, c in ops.LAUNCHES.items() if c != before[name]}
        if ran != {key}:
            raise AssertionError(f"l2_distances on normal values launched "
                                 f"{sorted(ran)}, not {key}")
        err = check_tol(f"l2_distances {dtype} on normal values at the "
                        f"chunk's shape", got, l2dist_ref(qd, vd), RTOL,
                        L2_ATOL)
        log(f"l2_distances {dtype} on normal values at the chunk's shape: "
            f"max abs error {err}")
        del qd, vd, got
    del qn, vn
    for key, qkv in flash_calls.items():
        what = (f"flash_attention {qkv[0].dtype} dh={qkv[0].shape[3]} at "
                f"Qwen3-0.6B's S, T, H, Hk ({key})")
        want = flash_attn_ref(*qkv, causal=True)
        err = check_attn(what, outs[key], want)
        log(f"{what}: max abs error {err}, largest row-relative L2 error "
            f"{row_rel_err(outs[key], want)}")
        del want
    log(f"entry points at full width vs plain: ok; pq_adc_topk ids == "
        f"stable argsort of pq_adc for {len(luts)} queries; "
        f"launches={launches}")
    return launches, {"adc_scan": (codes, luts[0]),
                      "adc_scan_topk": (codes, luts[0], top_n),
                      **spill_calls, **l2_calls, **flash_calls}


def launch_key(row: str) -> str:
    """The ``LAUNCHES`` key a phase 5 row's call counts under: the row's
    name, less what tells two rows of one key apart (``@uint8``, the
    spill route's ``lut_int8``)."""
    return row.split("@")[0].replace(",lut_int8]", "]")


# ---------------------------------------------------------------- phase 6
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
        out.append(measure_fused(key, codes, q, cb, rows, topk))
        # and a window of several tiles a CTA: S = 8,192, each query's
        # valid rows uniform in [S/4, 3S/4] (about 4,000), drawn ascending
        # from the index's rows; logged, the row above stays the main path's
        multi = measure_fused(key, codes, q, cb, window_rows(
            rows.shape[0], MULTI_S, codes.shape[0], rows.device,
            torch.Generator(device=rows.device).manual_seed(MULTI_S)), topk)
        shape = multi.pop("shape")
        log(f"timing {key} multi-block {shape}: ms={multi['ms']:.4f} "
            f"plain_ms={multi['plain_ms']:.3f} "
            f"bound_ms={multi['bound_ms']:.4f} ({multi['bound_by']}) "
            f"max_abs_err={multi['max_abs_err']}")
    return out


def window_rows(b: int, s: int, n: int, dev: torch.device,
                gen: torch.Generator) -> torch.Tensor:
    """A fused scan window's rows (B, S): each query's valid rows, uniform
    in number in [S/4, 3S/4], drawn ascending from N, then pads."""
    rows = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    counts = torch.randint(s // 4, 3 * s // 4 + 1, (b,), generator=gen,
                           device=dev).tolist()
    for i, c in enumerate(counts):
        rows[i, :c] = torch.sort(torch.randperm(
            n, generator=gen, device=dev)[:c])[0].int()
    return rows


def check_fused(key: str, codes, q, cb, rows, topk: int) -> float:
    """The fused kernel bit-equal to its plain version (values and ids)
    on these inputs; returns the largest distance error."""
    from repro_torch.kernels.pq_adc import ops
    int8 = key.endswith("[lut_int8]")
    kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, topk, lut_int8=int8)
    pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, topk,
                                         lut_int8=int8)
    err = check_close(f"{key} at S={rows.shape[1]}", kv, pv, ki, pi)
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        raise AssertionError(f"{key} at S={rows.shape[1]}: not bit-equal "
                             f"to its plain version")
    return err


def measure_fused(key: str, codes, q, cb, rows, topk: int) -> dict:
    """``check_fused`` on these inputs, and the kernel's times."""
    from repro_torch.kernels.pq_adc import ops
    int8 = key.endswith("[lut_int8]")
    err = check_fused(key, codes, q, cb, rows, topk)
    b, s = rows.shape
    m, k, dsub = cb.shape
    valid = int((rows >= 0).sum())
    tk = min(topk, s)
    nbytes = (b * s * 4 + valid * m + b * m * dsub * 4
              + m * k * dsub * 4 + b * tk * 8)
    lut_ops = b * m * k * 3 * dsub + (b * m * k * 5 if int8 else 0)
    flops = lut_ops + valid * m * (4 if int8 else 1)
    return dict(
        name=key, shape=dict(B=b, S=s, valid_slots=valid, M=m, K=k,
                             topk=topk),
        max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc_fused_topk(
            codes, q, cb, rows, topk, lut_int8=int8), 20),
        plain_ms=gpu_ms(lambda: ops.pq_adc_fused_topk_plain(
            codes, q, cb, rows, topk, lut_int8=int8), 3),
        library_ms=None, **bound(nbytes, flops))


def measure_entry(calls) -> list:
    """Phase 6 for the entry-point kernels, on phase 5's inputs."""
    from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
    from repro_torch.kernels.pq_adc import ops, ref
    F = torch.nn.functional
    out = []

    codes, lut = calls["adc_scan"]
    n, m = codes.shape
    k = lut.shape[1]
    plain = ref.pq_adc_ref(codes, lut)
    err = check_close("adc_scan", ops.pq_adc(codes, lut), plain)
    flat_idx = codes.long() + torch.arange(m, device=codes.device) * k
    weight = lut.reshape(m * k, 1)
    check_close("embedding_bag yardstick (B = 1)", F.embedding_bag(
        flat_idx, weight, mode="sum")[:, 0], plain)
    out.append(dict(
        name="adc_scan", shape=dict(N=n, M=m, K=k), max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc(codes, lut), 20),
        plain_ms=gpu_ms(lambda: ref.pq_adc_ref(codes, lut), 3),
        library_ms=gpu_ms(lambda: F.embedding_bag(flat_idx, weight,
                                                  mode="sum"), 5),
        **bound(n * m + m * k * 4 + n * 4, n * m)))
    del flat_idx, plain

    codes, lut, topk = calls["adc_scan_topk"]
    kv, ki = ops.pq_adc_topk(codes, lut, topk)
    pv, pi = ops.pq_adc_topk_plain(codes, lut, topk)
    err = check_close("adc_scan_topk", kv, pv, ki, pi)
    out.append(dict(
        name="adc_scan_topk", shape=dict(N=n, M=m, K=k, topk=topk),
        max_abs_err=err,
        ms=gpu_ms(lambda: ops.pq_adc_topk(codes, lut, topk), 10),
        plain_ms=gpu_ms(lambda: ops.pq_adc_topk_plain(codes, lut, topk), 3),
        library_ms=None,
        **bound(n * m + m * k * 4 + min(topk, n) * 8, n * m)))

    # the fused scan's spill route at phase 5's window (no library call)
    for name in ("adc_fused_topk[spill]", "adc_fused_topk[spill,lut_int8]"):
        codes_f, q_f, cb_f, rows_f, topk_f = calls[name]
        out.append(measure_fused(name, codes_f, q_f, cb_f, rows_f, topk_f))

    # the output alone is B * N * 4 bytes.  The yardstick is one addmm,
    # bf16 in and f32 out for bf16 (none takes uint8: no library call).
    for name in ("l2dist_wgmma", "l2dist_wgmma[bf16]",
                 "l2dist_wgmma[bf16,off16]", "l2dist_wgmma[bf16,odd]",
                 "l2dist_wgmma[bf16]@uint8", "l2dist_wgmma[d>128]",
                 "l2dist_wgmma[bf16,d>128]"):
        q, v = calls[name]
        peak, products = exact_products(q.dtype)
        (b, d), nv = q.shape, v.shape[0]
        plain = l2dist_ref(q, v)
        err = check_tol(f"{name} ({q.dtype})", l2_distances(q, v), plain,
                        RTOL, L2_ATOL)
        qf, vf = q.float(), v.float()
        norms = (qf * qf).sum(-1, keepdim=True) + (vf * vf).sum(-1)[None]
        del qf, vf
        kw = ({} if q.dtype == torch.float32
              else dict(out_dtype=torch.float32))

        def addmm(q=q, v=v, norms=norms, kw=kw):
            return torch.addmm(norms, q, v.T, alpha=-2, **kw)
        library = q.is_floating_point()
        if library:
            check_tol(f"addmm yardstick ({q.dtype})", addmm(), plain, RTOL,
                      L2_ATOL)
        del plain
        out.append(dict(
            name=name, shape=dict(B=b, N=nv, D=d, dtype=str(q.dtype)),
            max_abs_err=err,
            ms=gpu_ms(lambda: l2_distances(q, v), 10),
            plain_ms=gpu_ms(lambda: l2dist_ref(q, v), 3),
            library_ms=gpu_ms(addmm, 10) if library else None,
            **bound((b * d + nv * d) * q.element_size() + b * nv * 4,
                    products * 2 * b * nv * d, peak=peak)))
        del norms, addmm

    for name in ("flash_attn_fwd_wgmma", "flash_attn_fwd_tf32",
                 "flash_attn_fwd_wgmma[padded]",
                 "flash_attn_fwd_tf32[padded]", "flash_attn_fwd_tf32[256]",
                 "flash_attn_fwd_wgmma[256]",
                 "flash_attn_fwd_wgmma[stride-pad]"):
        out.append(measure_flash(name, *calls[name]))
    return out


def measure_flash(name: str, q, k, v) -> dict:
    """Phase 6 for one flash call (causal): the kernel against its plain
    version, its time, the plain version's and SDPA's, and the bound: (dh + dv) products a pair of (s, t) kept
    by the mask, the bytes of q, k, v and the output."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
    F = torch.nn.functional
    peak, products = exact_products(q.dtype)
    bsz, s, h, dh = q.shape
    t, dv = k.shape[1], v.shape[3]
    plain = flash_attn_ref(q, k, v, causal=True)
    tol = FLASH_TOL[q.dtype]
    err = check_attn(f"{name} ({q.dtype})",
                     flash_attention(q, k, v, causal=True), plain)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    check_tol(f"scaled_dot_product_attention yardstick ({q.dtype})",
              sdpa().transpose(1, 2), plain, tol, tol)
    library_ms = gpu_ms(sdpa, 10)
    del plain
    pairs = sum(min(i + 1, t) for i in range(s))       # unmasked (s, t)
    return dict(
        name=name,
        shape=dict(B=bsz, S=s, T=t, H=h, Hk=k.shape[2], dh=dh, dv=dv,
                   dtype=str(q.dtype), causal=True),
        max_abs_err=err,
        ms=gpu_ms(lambda: flash_attention(q, k, v, causal=True), 10),
        plain_ms=gpu_ms(lambda: flash_attn_ref(q, k, v, causal=True), 3),
        library_ms=library_ms,
        **bound((q.numel() + k.numel() + v.numel() + bsz * s * h * dv)
                * q.element_size(),
                products * 2 * bsz * h * (dh + dv) * pairs, peak=peak))


# ---------------------------------------------------------------- phase 7
def noisy(rng: np.random.Generator, rows: np.ndarray) -> np.ndarray:
    """Rows plus Gaussian noise of sigma NOISE_SIGMA, rounded and clipped
    to uint8's range (returned as float32 integers)."""
    out = rows.astype(np.float32) + rng.normal(
        0.0, NOISE_SIGMA, rows.shape).astype(np.float32)
    return np.clip(np.rint(out), 0, 255)


def serve_round(label: str, index, queries: np.ndarray, gt: np.ndarray,
                deleted: np.ndarray) -> dict:
    """The three serving paths, each with the counts set to 0 just before
    it and read just after; fails unless each launched its kernel, no
    deleted id comes back, dense ids equal fused ids, f32 recall > 0.5
    and int8 recall >= f32 recall - 0.05."""
    from repro_torch.kernels.pq_adc import ops
    ids, metrics = {}, {}
    for path, kernel, plan in SERVE_PATHS:
        ops.reset_launches()
        ids[path], metrics[path] = serve(index, queries, gt, **plan)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"mutation {label} {path}: " + json.dumps(metrics[path])
            + f" launches={launches}")
        if launches.get(kernel, 0) < 1:
            raise AssertionError(f"mutation {label}: {path} never "
                                 f"launched {kernel}")
        back = np.intersect1d(ids[path], deleted)
        if len(back):
            raise AssertionError(f"mutation {label}: {path} returned "
                                 f"deleted ids {back[:8].tolist()}")
    if not np.array_equal(ids["dense"], ids["fused"]):
        bad = int((ids["dense"] != ids["fused"]).any(1).sum())
        raise AssertionError(f"mutation {label}: dense and fused ids "
                             f"differ on {bad} queries")
    r32, r8 = (metrics["fused"]["recall_at_10"],
               metrics["fused_int8"]["recall_at_10"])
    if not (r32 > 0.5 and r8 >= r32 - 0.05):
        raise AssertionError(f"mutation {label}: recall@10 f32 {r32}, "
                             f"int8 {r8}")
    return metrics


def same_answers(label: str, a, b, queries: np.ndarray) -> None:
    """Dense and fused windows of ``a`` and ``b`` give equal ids and
    distances for every query."""
    for plan in ({}, {"fused": True}):
        for ra, rb in zip(a.submit(queries, window=WINDOW, **plan).results(),
                          b.submit(queries, window=WINDOW, **plan).results()):
            if not (np.array_equal(ra.ids, rb.ids)
                    and np.array_equal(ra.dists, rb.dists)):
                raise AssertionError(f"{label}: answers differ ({plan})")


def mutation_phase(index, data: np.ndarray, queries: np.ndarray,
                   gt: np.ndarray, seed: int) -> dict:
    """Phase 7: insert, delete, query, compact, query, snapshot round
    trip, background compactor and OPQ, on the index of phase 3."""
    from repro_torch.core import opq
    from repro_torch.core.engine import FusionANNSIndex, ground_truth
    from repro_torch.kernels.pq_adc import ops, ref
    rng = np.random.default_rng(seed + 7)
    n, nq = len(data), len(queries)
    view0 = index.view()
    out = {}
    # 1. insert 1% of N: noisy copies of existing rows, and of each query
    n_ins = n // 100
    picks = np.sort(rng.choice(n, n_ins - nq, replace=False))
    rows = np.concatenate([noisy(rng, data[picks]), noisy(rng, queries)])
    t = time.perf_counter()
    new_ids = index.insert(rows)
    out["insert_s"] = time.perf_counter() - t
    # 2. delete each query's pre-mutation top-1 and a tenth of the inserts
    del_inserted = rng.choice(new_ids, n_ins // 10, replace=False)
    deleted = np.concatenate([np.unique(gt[:, 0]), np.sort(del_inserted)])
    t = time.perf_counter()
    index.delete(deleted)
    out["delete_s"] = time.perf_counter() - t
    out.update(inserted=int(n_ins), deleted=int(len(deleted)))
    # ground truth over the live set, through l2dist_wgmma
    t = time.perf_counter()
    all_rows = np.concatenate([data, rows.astype(data.dtype)])
    live_ids = np.setdiff1d(np.arange(len(all_rows)), deleted)
    ops.reset_launches()
    gt_live = live_ids[ground_truth(all_rows[live_ids], queries, 10)]
    if ops.LAUNCHES["l2dist_wgmma"] < 1:
        raise AssertionError("mutation: the live-set ground truth never "
                             "launched l2dist_wgmma")
    out["ground_truth_s"] = time.perf_counter() - t
    log(f"mutation: inserted {n_ins} rows in {out['insert_s']:.4f} s, "
        f"deleted {len(deleted)} ids in {out['delete_s']:.4f} s, live-set "
        f"ground truth {out['ground_truth_s']:.1f} s")
    del all_rows
    # the share of the live ground truth that the inserts hold
    out["gt_share_inserted"] = float(np.isin(gt_live, new_ids).mean())
    # 3. query with the delta scanned exactly
    out["before_seal"] = serve_round("before seal", index, queries,
                                     gt_live, deleted)
    # 4. seal
    rows0 = index.view().n_rows
    t = time.perf_counter()
    sealed = index.compact()
    torch.cuda.synchronize()
    out["seal_s"] = time.perf_counter() - t
    grown = index.view().n_rows - rows0
    log(f"mutation: compact() sealed {sealed} rows in {out['seal_s']:.3f} "
        f"s, n_rows +{grown}, delta {index.delta_size}")
    if sealed != n_ins or grown != n_ins - len(del_inserted):
        raise AssertionError(f"mutation: compact sealed {sealed} rows "
                             f"(want {n_ins}), n_rows grew by {grown}")
    # 5. query the re-published codes; hold their kernels against plain
    with Recorder() as recorder:
        out["after_seal"] = serve_round("after seal", index, queries,
                                        gt_live, deleted)
    codes, luts = recorder.calls["adc_scan_batch"]
    check_close("adc_scan_batch on the sealed codes",
                ops.pq_adc_batch(codes, luts),
                ref.pq_adc_batch_ref(codes, luts))
    for key in ("adc_fused_topk", "adc_fused_topk[lut_int8]"):
        check_fused(key, *recorder.calls[key])
    # 6. snapshot round trip onto the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snapshot_") as tmp:
        t = time.perf_counter()
        index.save_snapshot(tmp)
        out["snapshot_save_s"] = time.perf_counter() - t
        out["snapshot_bytes"] = sum(
            os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t = time.perf_counter()
        loaded = FusionANNSIndex.load_snapshot(tmp, device="cuda")
        out["snapshot_load_s"] = time.perf_counter() - t
    same_answers("snapshot round trip", index, loaded, queries)
    del loaded
    log(f"mutation: snapshot {out['snapshot_bytes']} bytes, save "
        f"{out['snapshot_save_s']:.1f} s, load onto the card "
        f"{out['snapshot_load_s']:.1f} s; dense and fused answers equal")
    # 7. the background compactor while windows run on the card
    t = time.perf_counter()
    index.start_compactor(min_delta=COMPACTOR_MIN_DELTA)
    batches = []
    epoch0 = index.epoch
    for _ in range(COMPACTOR_BATCHES):
        pick = rng.choice(n, COMPACTOR_BATCH, replace=False)
        batches.append(index.insert(noisy(rng, data[pick])))
        index.submit(queries[:WINDOW], window=WINDOW).results()
    index.stop_compactor(flush=True)
    out["compactor_s"] = time.perf_counter() - t
    out["compactor_epochs"] = index.epoch - epoch0
    id_of = index.view().id_of
    added = np.concatenate(batches)
    if index.delta_size or not (np.diff(id_of) > 0).all() \
            or not np.isin(added, id_of).all():
        raise AssertionError("mutation: the compactor left rows unsealed "
                             "or sealed a row twice")
    log(f"mutation: compactor sealed {len(added)} rows under serving in "
        f"{out['compactor_s']:.1f} s ({out['compactor_epochs']} epochs)")
    # 8. OPQ over the N rows, served on the built posting lists and graph;
    # its k-means takes the index codebook's rounds from the same seed, so
    # its first round IS that codebook and the comparison below isolates
    # the rotation (as the JAX package's OPQ test holds equal rounds)
    dev = index.device
    t = time.perf_counter()
    ocb, _ = opq.train_opq(torch.Generator().manual_seed(seed), data,
                           index.cfg.pq_m, index.cfg.pq_nbits,
                           kmeans_iters=PQ_ROUNDS, device=dev)
    out["opq_train_s"] = time.perf_counter() - t
    r = ocb.rotation.astype(np.float64)
    out["opq_orthonormality"] = float(np.abs(r.T @ r - np.eye(len(r))).max())
    out["opq_error"] = opq.reconstruction_error(ocb, data)
    out["pq_error"] = opq.reconstruction_error(opq.OPQCodebook(
        rotation=np.eye(len(r), dtype=np.float32), cb=index.codebook), data)
    log(f"OPQ: trained in {out['opq_train_s']:.1f} s, |R^T R - I| = "
        f"{out['opq_orthonormality']}, error {out['opq_error']} against "
        f"plain PQ's {out['pq_error']}")
    if not (out["opq_orthonormality"] <= 1e-4
            and out["opq_error"] < out["pq_error"]):
        raise AssertionError(f"OPQ: |R^T R - I| = "
                             f"{out['opq_orthonormality']}, error "
                             f"{out['opq_error']} vs PQ {out['pq_error']}")
    oidx = FusionANNSIndex(cfg=index.cfg, codebook=ocb.cb,
                           codes=opq.encode(ocb, data),
                           posting=view0.posting, graph=view0.graph,
                           ssd=index.ssd, rotation=ocb.rotation)
    ids = {}
    for path, kernel, plan in SERVE_PATHS[:2]:
        ops.reset_launches()
        ids[path], out[f"opq_{path}"] = serve(oidx, queries, gt, **plan)
        if ops.LAUNCHES[kernel] < 1:
            raise AssertionError(f"OPQ: {path} never launched {kernel}")
    if not np.array_equal(ids["dense"], ids["fused"]) \
            or not out["opq_fused"]["recall_at_10"] > 0.5:
        raise AssertionError("OPQ: dense ids differ from fused or recall "
                             f"{out['opq_fused']['recall_at_10']} <= 0.5")
    return out


# ---------------------------------------------------------------- phase 8
def live_ground_truth(index, queries: np.ndarray, *,
                      sealed_only: bool = False) -> np.ndarray:
    """Exact top-10 ids over the index's live rows (sealed, untombstoned;
    the delta must be empty, or is left out with ``sealed_only``), through
    ``ground_truth``."""
    from repro_torch.core.engine import ground_truth
    view = index.view()
    if index.delta_size and not sealed_only:
        raise AssertionError("serving: the delta is not empty")
    rows = np.flatnonzero(~view.tombstones[view.id_of])
    return view.id_of[rows][ground_truth(index.ssd.vectors[rows], queries,
                                         10)]


def same_as(label: str, got, want) -> None:
    """Responses ``got`` give the ids and distances of ``want``, query by
    query."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} answers for "
                             f"{len(want)} queries")
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not (np.array_equal(g.ids, w.ids)
                   and np.array_equal(g.dists, w.dists))]
    if bad:
        raise AssertionError(f"{label}: answers differ on {len(bad)} "
                             f"queries (first {bad[:8]})")


def ids_of(responses) -> np.ndarray:
    return np.stack([np.asarray(r.ids) for r in responses])


def stop_drained(label: str, stack, client, reqs) -> list:
    """Submit one more window of requests, ``stop()`` at once, and fail
    unless every future resolved; returns their responses."""
    futs = [client.submit(r) for r in reqs[:WINDOW]]
    stack.stop()
    if not all(f.done() for f in futs) or stack.live_load():
        raise AssertionError(f"{label}: futures pending after stop()")
    return [f.result(timeout=0) for f in futs]


def serve_stack(label: str, stack, reqs, gt) -> tuple:
    """The requests through ``ANNSClient.search_many``: (responses,
    metrics), recall@10 against ``gt``, QPS, p50/p99 of the stack's
    submit -> resolve latencies."""
    from repro_torch.core.engine import recall_at_k
    from repro_torch.serve.client import ANNSClient
    t = time.perf_counter()
    resps = ANNSClient(stack).search_many(reqs, timeout=STACK_TIMEOUT_S)
    wall = time.perf_counter() - t
    served = stack.stats_rollup()["served"]
    if served != len(reqs):
        raise AssertionError(f"{label}: served {served} of {len(reqs)}")
    pct = stack.latency_percentiles()
    return resps, dict(recall_at_10=recall_at_k(ids_of(resps), gt, 10),
                       qps=len(reqs) / wall, p50_ms=1e3 * pct["p50"],
                       p99_ms=1e3 * pct["p99"], served=served)


def edge_round(stack, queries: np.ndarray, want) -> dict:
    """An ``AnnsEdge`` on 127.0.0.1 at an ephemeral port over ``stack``:
    two tenants with API keys, alice's quota EDGE_BURST; 64 searches over
    four keep-alive connections must return ``want``'s ids, alice's next
    gets 429, ``/v1/stats`` and ``/healthz`` 200."""
    import asyncio
    from repro_torch.serve.edge import (AnnsEdge, EdgeConfig, HttpConn,
                                        TenantConfig)
    tenants = (TenantConfig("alice", "key-a", rate_qps=EDGE_RATE_QPS,
                            burst=EDGE_BURST),
               TenantConfig("bob", "key-b"))
    keys = ("key-a", "key-b")
    n = 2 * EDGE_BURST

    async def drive():
        edge = AnnsEdge(stack, EdgeConfig(tenants=tenants))
        await edge.start()
        try:
            conns = [await HttpConn.open("127.0.0.1", edge.port)
                     for _ in range(4)]

            async def one(c, idxs):
                out = {}
                for i in idxs:
                    out[i] = await c.request(
                        "POST", "/v1/search",
                        {"query": queries[i].tolist(), "tag": i},
                        headers={"x-api-key": keys[i % 2]})
                return out

            t = time.perf_counter()
            parts = await asyncio.wait_for(asyncio.gather(*[
                one(c, range(j, n, 4)) for j, c in enumerate(conns)]),
                STACK_TIMEOUT_S)
            wall = time.perf_counter() - t
            over = await conns[0].request(
                "POST", "/v1/search", {"query": queries[0].tolist()},
                headers={"x-api-key": keys[0]})
            stats = await conns[1].request("GET", "/v1/stats")
            health = await conns[2].request("GET", "/healthz")
            for c in conns:
                await c.aclose()
            return ({k: v for p in parts for k, v in p.items()}, wall,
                    over, stats, health, dict(edge.stats))
        finally:
            await asyncio.wait_for(edge.aclose(), STACK_TIMEOUT_S)

    got, wall, over, stats, health, edge_stats = asyncio.run(drive())
    for i in range(n):
        status, payload = got[i]
        if status != 200 or payload["tenant"] != ("alice", "bob")[i % 2] \
                or not np.array_equal(payload["ids"], want[i].ids):
            raise AssertionError(f"edge: search {i} answered {status} "
                                 f"{str(payload)[:200]}")
    if over[0] != 429 or stats[0] != 200 or health[0] != 200:
        raise AssertionError(f"edge: past the quota {over[0]}, /v1/stats "
                             f"{stats[0]}, /healthz {health[0]}")
    return dict(searches=n, qps=n / wall, quota_status=over[0],
                retry_after=over[1]["error"]["message"],
                stats_status=stats[0], healthz_status=health[0],
                edge=edge_stats)


def adaptive_round(stack, queries: np.ndarray, gt: np.ndarray) -> dict:
    """``adaptive=True`` requests, one at a time, with a deadline that the
    first replica's planner (which has observed the served traffic)
    resolves to a reduced accuracy level; recall@10 > 0.5.

    The planner's device model is the paper's testbed: it prices a
    request's SSD, link and scan work, not the host's Python stages, which
    take most of a request here.  So the deadline is ADAPTIVE_SLACK times
    the measured p99 of plain single requests, and the planner's
    ``headroom`` (the share of a deadline its model may fill) is set so
    that this deadline falls midway between the modelled latencies of
    full accuracy and the next level."""
    from repro_torch.core import perf_model as pm
    from repro_torch.core.engine import recall_at_k
    from repro_torch.serve.client import SearchRequest
    lat = []
    for q in queries[:ADAPTIVE_PROBES]:
        t = time.perf_counter()
        stack.submit(SearchRequest(query=q)).result(timeout=STACK_TIMEOUT_S)
        lat.append(time.perf_counter() - t)
    deadline = ADAPTIVE_SLACK * float(np.percentile(lat, 99))
    pl = stack.replicas[0].executor.planner
    if pl._n_observed < 1:
        raise AssertionError("adaptive: the planner observed nothing")
    lats = [pm.single_thread_latency(pm.scale_demand(pl._demand, lv),
                                     pl.hw) for lv in pm.ACCURACY_LEVELS]
    headroom = (lats[0] + lats[1]) / 2 / deadline
    for r in stack.replicas:
        r.executor.planner.headroom = headroom
    sugs = [r.executor.planner.suggest(deadline) for r in stack.replicas]
    resps = []
    t = time.perf_counter()
    for q in queries:
        resps.append(stack.submit(SearchRequest(
            query=q, deadline_s=deadline, adaptive=True)).result(
                timeout=STACK_TIMEOUT_S))
    wall = time.perf_counter() - t
    recall = recall_at_k(ids_of(resps), gt, 10)
    out = dict(single_request_p99_s=deadline / ADAPTIVE_SLACK,
               deadline_s=deadline, headroom=headroom,
               modelled_level_latency_s=lats, suggestions=sugs,
               recall_at_10=recall, qps=len(queries) / wall,
               candidates_scanned_mean=float(np.mean(
                   [r.stats.candidates_scanned for r in resps])))
    if sugs[0] is None or not recall > 0.5:
        raise AssertionError(f"adaptive: suggestion {sugs[0]}, recall "
                             f"{recall}")
    return out


def serving_phase(index, queries: np.ndarray, seed: int) -> dict:
    """Phase 8: the serving stack on the card over the index as phase 7
    leaves it."""
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.serve.autoscaler import (AutoscalerConfig,
                                              ReplicaAutoscaler)
    from repro_torch.serve.client import ANNSClient, SearchRequest
    from repro_torch.serve.stack import make_serving_stack
    rng = np.random.default_rng(seed + 8)
    out, launches = {}, {}
    t = time.perf_counter()
    gt = live_ground_truth(index, queries)
    out["ground_truth_s"] = time.perf_counter() - t
    reqs = [SearchRequest(query=q, tag=i) for i, q in enumerate(queries)]
    want = {"dense": index.batch_query(queries),
            "fused": index.query_batch_fused(queries),
            "fused_int8": index.submit(queries, window=WINDOW, fused=True,
                                       lut_int8=True).results()}
    # (a) the fused stacks, each started and stopped with the counts set
    # to 0 just before and read just after
    for path, kernel, plan in SERVE_PATHS[1:]:
        ops.reset_launches()
        stack = make_serving_stack(index, n_replicas=2, threaded=True,
                                   **plan)
        try:
            resps, out[path] = serve_stack(path, stack, reqs, gt)
        finally:
            tail = stop_drained(path, stack, ANNSClient(stack), reqs)
        launches[path] = {k: v for k, v in ops.LAUNCHES.items() if v}
        same_as(f"stack {path}", resps + tail,
                want[path] + want[path][:WINDOW])
        if launches[path].get(kernel, 0) < 1:
            raise AssertionError(f"stack {path} never launched {kernel}")
        log(f"serving stack {path}: " + json.dumps(out[path])
            + f" launches={launches[path]}")
    # the dense stack serves (a), then the edge (b), adaptive requests
    # (d), hydration and mutation (c) and the autoscaler (e)
    ops.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stack_") as tmp:
        stack = make_serving_stack(index, n_replicas=2, threaded=True,
                                   snapshot_dir=tmp)
        client = ANNSClient(stack)
        try:
            for r in stack.replicas:         # observe from the first query
                r.executor.planner           # noqa: B018
            resps, out["dense"] = serve_stack("dense", stack, reqs, gt)
            same_as("stack dense", resps, want["dense"])
            log("serving stack dense: " + json.dumps(out["dense"]))
            out["edge"] = edge_round(stack, queries, want["dense"])
            log("edge: " + json.dumps(out["edge"]))
            out["adaptive"] = adaptive_round(stack, queries[:ADAPTIVE_N],
                                             gt[:ADAPTIVE_N])
            log("adaptive: " + json.dumps(out["adaptive"]))
            out["hydration"] = hydrate_and_mutate(stack, client, index,
                                                  reqs, resps, want, rng)
            log("hydration and mutation: " + json.dumps(out["hydration"]))
            asc = ReplicaAutoscaler(stack, AutoscalerConfig(
                min_replicas=1, max_replicas=3))
            futs = [stack.submit(r) for r in reqs]
            sig = stack.scaling_signals()
            t = time.perf_counter()
            decision = asc.tick()
            out["autoscaler"] = dict(
                decision=decision, model_cap=asc._model_cap(),
                tick_s=time.perf_counter() - t,
                live_load=sig["live_load"], n_replicas=stack.n_replicas,
                stats=dict(asc.stats))
            for f in futs:
                f.result(timeout=STACK_TIMEOUT_S)
            log("autoscaler: " + json.dumps(out["autoscaler"]))
        finally:
            tail = stop_drained("dense", stack, client, reqs)
    launches["dense"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launches["dense"].get("adc_scan_batch", 0) < 1:
        raise AssertionError("stack dense never launched adc_scan_batch")
    log(f"serving stack dense: launches={launches['dense']}")
    out["launches"] = launches
    out["tail_answers"] = len(tail)
    return out


def hydrate_and_mutate(stack, client, index, reqs, resps, want,
                       rng: np.random.Generator) -> dict:
    """Phase 8 (c): a replica hydrated from a snapshot onto the card
    answers as its donor; 1,024 inserts and the deletion of the first 64
    queries' top-1 ids fan out to both indexes (no deleted id back, the
    replicas in lockstep); ``remove_replica()`` under load loses no
    future."""
    out = {}
    t = time.perf_counter()
    slot = stack.add_replica()
    out["hydrate_s"] = time.perf_counter() - t
    new, donor = stack.replicas[-1], stack.replicas[0]
    if new.index is index or new.index.device != index.device:
        raise AssertionError("hydration: the replica shares the donor or "
                             f"sits on {new.index.device}")
    hyd = [f.result(timeout=STACK_TIMEOUT_S) for f in
           [new.submit(r) for r in reqs]]
    same_as("hydrated replica", hyd, want["dense"])
    n = len(index.ssd.vectors)
    rows = noisy(rng, index.ssd.vectors[np.sort(rng.choice(
        n, HYDRATE_INSERTS, replace=False))])
    t = time.perf_counter()
    new_ids = stack.insert(rows)
    deleted = np.unique(ids_of(resps)[:64, 0])
    stack.delete(deleted)
    out["mutate_s"] = time.perf_counter() - t
    after = client.search_many(reqs, timeout=STACK_TIMEOUT_S)
    back = np.intersect1d(ids_of(after), deleted)
    if len(back):
        raise AssertionError(f"mutation: deleted ids came back "
                             f"{back[:8].tolist()}")
    pairs = [[f.result(timeout=STACK_TIMEOUT_S) for f in
              [r.submit(q) for q in reqs[:WINDOW]]] for r in (donor, new)]
    same_as("hydrated replica after mutation", pairs[1], pairs[0])
    futs = [client.submit(r) for r in reqs]
    t = time.perf_counter()
    removed = stack.remove_replica()
    out["remove_s"] = time.perf_counter() - t
    done = [f.result(timeout=STACK_TIMEOUT_S) for f in futs]
    if not all(f.done() and not f.cancelled() for f in futs):
        raise AssertionError("remove_replica: a future was lost")
    same_as("served while a replica was removed", done, after)
    out.update(slot=slot, removed=removed, inserted=len(new_ids),
               deleted=int(len(deleted)), n_replicas=stack.n_replicas)
    return out


# ---------------------------------------------------------------- phase 9
def timed_run(ex, queries: np.ndarray, plan) -> tuple:
    """``ex.run`` over the queries: (results, QPS)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = ex.run(queries, plan)
    return res, len(queries) / (time.perf_counter() - t)


def timed_ms(fn) -> tuple:
    """``fn()`` once, synchronised: (its result, milliseconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def equal_pairs(label: str, got, want) -> None:
    """(dists, ids) pairs equal bit for bit."""
    for g, w, what in zip(got, want, ("distances", "ids")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: {what} differ from the "
                                 f"one-device kernel's")


def mesh_executors(index, queries: np.ndarray, mesh4, launches) -> dict:
    """Phase 9 (a): ``make_executor`` over the mesh of four and over one
    half of it, each serving path's answers equal to a one-device
    executor's, its kernel launched once a shard a window."""
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.launch.mesh import split_mesh
    out = {}
    windows = -(-len(queries) // WINDOW)
    one = index.make_executor()
    meshes = (("mesh4", mesh4), ("half", split_mesh(mesh4, 2)[0]))
    for path, kernel, plan in SERVE_PATHS:
        p = index.plan(window=WINDOW, inflight_depth=2, **plan)
        want, qps = timed_run(one, queries, p)
        out[path] = {"qps_one_device": qps}
        for label, mesh in meshes:
            ex = index.make_executor(mesh)
            shards = ex._n_shards()
            ops.reset_launches()
            got, qps = timed_run(ex, queries, p)
            n = ops.LAUNCHES[kernel]
            same_as(f"{label} executor {path}", got, want)
            if n != shards * windows:
                raise AssertionError(
                    f"{label} executor {path}: {n} launches of {kernel}, "
                    f"expected {shards} shards x {windows} windows")
            out[path][f"qps_{label}"] = qps
            out[path][f"launches_{label}"] = n
            row = kernel + ("[lut_int8]" if plan.get("lut_int8") else "")
            launches[row] = launches.get(row, 0) + n
        log(f"mesh executor {path}: " + json.dumps(out[path]))
    return out


def mesh_functions(index, queries: np.ndarray, mesh4, launches,
                   rng: np.random.Generator) -> dict:
    """Phase 9 (b): the sharded scans over the index's codes (cut to an
    equal share a shard, and above 65,536 rows to whole blocks of them,
    as the reference's blocked batch scan needs) against the one-device
    kernels, and ``sharded_topk`` on
    (64, 2^20) scores with ties planted at every shard boundary against
    its plain version."""
    from repro_torch.core import distributed as dist, pq
    from repro_torch.core.topk import sharded_topk
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.sharding.spec import ShardCtx, rules_for_mesh
    ctx = ShardCtx(mesh=mesh4, rules=rules_for_mesh(mesh4))
    shards = 4
    codes = index.codes
    n_loc = codes.shape[0] // shards
    if n_loc > dist.BLOCK_N:
        n_loc -= n_loc % dist.BLOCK_N
    codes = codes[:shards * n_loc]
    dev = codes.device
    luts = pq.adc_lut_batch(index.codebook, torch.from_numpy(np.stack(
        [index._lut_query(q) for q in queries[:MESH_LUTS]])).to(dev))
    out = {"rows": codes.shape[0]}
    ops.reset_launches()
    got, out["topn_ms"] = timed_ms(
        lambda: dist.sharded_adc_topn(codes, luts[0], MESH_TOP_N, ctx))
    n_topk = ops.LAUNCHES["adc_scan_topk"]
    want, out["topn_one_device_ms"] = timed_ms(
        lambda: ops.pq_adc_topk(codes, luts[0], MESH_TOP_N))
    equal_pairs("sharded_adc_topn", got, want)
    if n_topk != shards:
        raise AssertionError(f"sharded_adc_topn: {n_topk} launches")
    ops.reset_launches()
    got, out["batch_ms"] = timed_ms(
        lambda: dist.sharded_adc_topn_batch(codes, luts, MESH_TOP_N, ctx))
    n_batch = ops.LAUNCHES["adc_scan_batch"]
    want, out["batch_one_device_ms"] = timed_ms(
        lambda: ops.pq_adc_topk_batch(codes, luts, MESH_TOP_N))
    equal_pairs("sharded_adc_topn_batch", got, want)
    if n_batch != shards:
        raise AssertionError(f"sharded_adc_topn_batch: {n_batch} launches")
    b, v = TOPK_SCORES
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    scores = torch.randn(b, v, generator=gen, device=dev)
    for s in range(1, shards):
        scores[:, s * v // shards - 1:s * v // shards + 1] = 8.0
    got, out["topk_ms"] = timed_ms(lambda: sharded_topk(
        scores, MESH_TOP_N, ctx, shard_axes=ctx.rules.corpus,
        batch_axes=None))
    pv, pi = torch.sort(scores, dim=1, descending=True, stable=True)
    equal_pairs("sharded_topk", got, (pv[:, :MESH_TOP_N],
                                      pi[:, :MESH_TOP_N]))
    launches["adc_scan_topk"] = launches.get("adc_scan_topk", 0) + n_topk
    launches["adc_scan_batch"] = launches.get("adc_scan_batch", 0) + n_batch
    log("mesh functions: " + json.dumps(out))
    return out


def mesh_stacks(index, queries: np.ndarray, mesh4, launches) -> dict:
    """Phase 9 (c): two-replica stacks carved from the mesh of four
    (dense and fused) answer as ``batch_query`` / ``query_batch_fused``;
    ``add_replica()`` re-carves to [2, 1, 1] with the answers unchanged;
    ``remove_replica()`` under load loses no future."""
    from repro_torch.kernels.pq_adc import ops
    from repro_torch.serve.client import ANNSClient, SearchRequest
    from repro_torch.serve.stack import make_serving_stack
    reqs = [SearchRequest(query=q, tag=i) for i, q in enumerate(queries)]
    out = {}
    for path, kernel, plan in SERVE_PATHS[:2]:
        want = (index.query_batch_fused(queries) if plan
                else index.batch_query(queries))
        ops.reset_launches()
        stack = make_serving_stack(index, n_replicas=2, threaded=True,
                                   mesh=mesh4, **plan)
        client = ANNSClient(stack)
        try:
            shards = [r.executor._n_shards() for r in stack.replicas]
            t = time.perf_counter()
            resps = client.search_many(reqs, timeout=STACK_TIMEOUT_S)
            qps = len(reqs) / (time.perf_counter() - t)
            same_as(f"mesh stack {path}", resps, want)
            stack.add_replica()
            grown = [r.executor._n_shards() for r in stack.replicas]
            if shards != [2, 2] or grown != [2, 1, 1]:
                raise AssertionError(f"mesh stack {path}: shards {shards} "
                                     f"then {grown}")
            same_as(f"mesh stack {path} after add_replica",
                    client.search_many(reqs, timeout=STACK_TIMEOUT_S), want)
            futs = [client.submit(r) for r in reqs]
            stack.remove_replica()
            done = [f.result(timeout=STACK_TIMEOUT_S) for f in futs]
            if not all(f.done() and not f.cancelled() for f in futs):
                raise AssertionError(f"mesh stack {path}: a future was "
                                     f"lost in remove_replica")
            same_as(f"mesh stack {path} under remove_replica", done, want)
            shrunk = [r.executor._n_shards() for r in stack.replicas]
        finally:
            stop_drained(f"mesh stack {path}", stack, client, reqs)
        n = ops.LAUNCHES[kernel]
        if n < 1 or shrunk != [2, 2]:
            raise AssertionError(f"mesh stack {path}: {n} launches, "
                                 f"shards {shrunk} after remove_replica")
        launches[kernel] = launches.get(kernel, 0) + n
        out[path] = dict(qps=qps, shards=[shards, grown, shrunk],
                         launches=n, served=stack.stats_rollup()["served"])
        log(f"mesh stack {path}: " + json.dumps(out[path]))
    return out


def baselines_round(index, queries: np.ndarray) -> dict:
    """Phase 9 (d): the paper's SPANN-like, HI+PQ and RUMMY-like
    baselines over the index's sealed tiers (rows; ``id_of`` maps them to
    ids), recall@10 against the sealed live rows' exact neighbours, mean
    I/Os a query.  DiskANN-like is not run: its graph build is a host
    loop over every row."""
    from repro_torch.core.baselines import HIPq, RummyLike, SpannLike
    from repro_torch.core.engine import recall_at_k
    cfg = index.cfg
    qs = queries[:BASELINE_QUERIES]
    gt = live_ground_truth(index, qs, sealed_only=True)
    id_of = index.view().id_of
    data = index.ssd.vectors
    out = {}
    t = time.perf_counter()
    systems = {"spann": SpannLike(index, data), "hi_pq": HIPq(index, data),
               "rummy": RummyLike(index, data)}
    out["setup_s"] = time.perf_counter() - t
    for name, system in systems.items():
        t = time.perf_counter()
        res = [system.query(q, 10, cfg.top_m, cfg.top_n) if name == "hi_pq"
               else system.query(q, 10, cfg.top_m) for q in qs]
        recall = recall_at_k(np.stack([id_of[r.ids] for r in res]), gt, 10)
        out[name] = dict(
            recall_at_10=recall, s=time.perf_counter() - t,
            ios_mean=float(np.mean([r.io.ios for r in res])),
            pages_mean=float(np.mean([r.demand.ssd_ios for r in res])),
            h2d_bytes_mean=float(np.mean([r.demand.h2d_bytes for r in res])))
        if not recall > 0.5:
            raise AssertionError(f"baseline {name}: recall@10 {recall}")
    log("baselines: " + json.dumps(out))
    return out


def mesh_phase(index, queries: np.ndarray, seed: int) -> dict:
    """Phase 9: the mesh half on the card over the index as phase 8
    leaves it (no new index is built)."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh4 = make_test_mesh(4)
    cards = len(set(mesh4.devices_of()))
    log(f"mesh of four: {mesh4} — "
        + ("one card a logical device" if cards == 4 else
           f"four logical devices on {cards} card(s), run one after "
           f"another"))
    launches = {}
    out = {"cards": cards}
    out["executors"] = mesh_executors(index, queries, mesh4, launches)
    out["functions"] = mesh_functions(index, queries, mesh4, launches,
                                      np.random.default_rng(seed + 9))
    out["stacks"] = mesh_stacks(index, queries, mesh4, launches)
    out["baselines"] = baselines_round(index, queries)
    out["launches"] = launches
    return out


# --------------------------------------------------------------- phase 10
@contextlib.contextmanager
def plain_attention():
    """Inside it the models' attention runs its plain versions on the
    card (the CPU path's scan forward and ``flash_attn_bwd_ref``), so a
    forward or a gradient can be held against the same one without the
    flash kernels."""
    from repro_torch.kernels.flash_attn import flash_attn_bwd_ref
    from repro_torch.models import layers
    fwd, bwd = layers.flash_attention, layers.flash_attention_bwd

    def plain_fwd(q, k, v, *, causal=True, scale=None, return_lse=False):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        out, lse = layers._attention_fwd_scan(q, k, v, causal, 0, 512,
                                              scale)
        lse = lse.reshape(q.shape[0], q.shape[2], q.shape[1])
        return (out, lse) if return_lse else out
    layers.flash_attention = plain_fwd
    layers.flash_attention_bwd = flash_attn_bwd_ref
    try:
        yield
    finally:
        layers.flash_attention, layers.flash_attention_bwd = fwd, bwd


def attn_widths(cfg) -> tuple:
    """(H, Hk, q/k width, v width) of a model's prefill attention: MLA's
    expanded heads (H = Hk, nope + rope, v_head_dim) or GQA's."""
    if cfg.mla:
        return (cfg.n_heads, cfg.n_heads,
                cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    return cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_head


@contextlib.contextmanager
def record_routing():
    """Inside it each MoE layer's router call is kept, in call order, as
    (expert ids (t, k), the layer's capacity, n_experts, the spread of
    its inputs: the squared norm of the mean of the tokens' unit
    vectors, the mean cosine of two tokens' inputs, 1 where all point
    one way, ~1/t where they are independent)."""
    from repro_torch.models import layers
    router = layers._router
    calls = []

    def recording(x, router_w, cfg):
        gates, eids = router(x, router_w, cfg)
        unit = torch.nn.functional.normalize(x.float(), dim=-1)
        calls.append((eids, layers._capacity(
            x.shape[0], cfg.moe_top_k, cfg.n_experts, cfg.capacity_factor),
            cfg.n_experts, unit.mean(0).square().sum()))
        return gates, eids
    layers._router = recording
    try:
        yield calls
    finally:
        layers._router = router


def differing_assignments(a, b) -> int:
    """(token, expert) assignments made in one of two recorded runs and
    not in the other, layer by layer (an order swap within a token's
    top-k is no difference)."""
    n = 0
    for (ea, _, n_experts, _), (eb, *_) in zip(a, b, strict=True):
        ma, mb = (torch.nn.functional.one_hot(e, n_experts).sum(1)
                  for e in (ea, eb))
        n += int((ma != mb).sum()) // 2
    return n


def dropped_pairs(calls) -> int:
    """(token, k) pairs past their expert's capacity in recorded calls."""
    return sum(by_layer(calls)["dropped_by_layer"])


def by_layer(calls) -> dict:
    """Recorded router calls one by one: the pairs dropped, the most
    pairs sent to one expert (against the capacity) and the mean cosine
    of the tokens' router inputs."""
    from repro_torch.models import layers
    out = {"dropped_by_layer": [], "max_load_by_layer": [],
           "input_mean_cos_by_layer": []}
    for eids, cap, n_experts, cos in calls:
        _, pos = layers._expert_slots(eids, n_experts)
        out["dropped_by_layer"].append(int((pos >= cap).sum()))
        out["max_load_by_layer"].append(int(torch.bincount(
            eids.reshape(-1), minlength=n_experts).max()))
        out["input_mean_cos_by_layer"].append(float(cos))
    return out


def prefill_round(params, cfg, tokens: torch.Tensor, dtype: torch.dtype,
                  kernel: str, launches: dict, limit: float) -> dict:
    """Phase 10 and 11 (a): ``lm_prefill`` in ``dtype``, counts set to 0
    just before and read just after (its launches must be one a layer a
    run), held row by row against the same prefill on the plain
    attention within ``limit``; its ms and the flash kernel's share of
    them (the kernel alone at the prefill's shape, on normal values, held
    to its plain version).  A MoE model's routing is recorded in the
    first run and in the plain one: the pairs each dropped, and the
    expert assignments that differ between them."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attn_ref)
    from repro_torch.kernels.launch import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tfm
    reps = 3                 # timed runs, after the first and a warm-up
    reset_launches()
    with record_routing() as routed:
        got = tfm.lm_prefill(params, tokens, cfg, dtype=dtype)
    ms = gpu_ms(lambda: tfm.lm_prefill(params, tokens, cfg, dtype=dtype),
                reps)
    torch.cuda.synchronize()
    grew = {n: c for n, c in LAUNCHES.items() if c}
    runs = 2 + reps
    want_n = cfg.n_layers * runs
    if grew != {kernel: want_n}:
        raise AssertionError(f"prefill {dtype}: launches {grew}, expected "
                             f"{{{kernel!r}: {want_n}}} ({cfg.n_layers} a "
                             f"forward)")
    launches[kernel] = launches.get(kernel, 0) + want_n
    with plain_attention(), record_routing() as routed_plain:
        want = tfm.lm_prefill(params, tokens, cfg, dtype=dtype)
    torch.cuda.synchronize()
    if {n: c for n, c in LAUNCHES.items() if c} != grew:
        raise AssertionError("the plain-attention prefill launched a kernel")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"prefill {dtype}: non-finite logits")
    row = row_rel_err(got, want)
    if not row <= limit:
        raise AssertionError(f"prefill {dtype}: a row's relative L2 error "
                             f"{row} beyond {limit}")
    routing = {}
    if cfg.moe:
        routing = {"dropped_pairs": dropped_pairs(routed),
                   "dropped_pairs_plain": dropped_pairs(routed_plain),
                   "assignments": sum(c[0].numel() for c in routed),
                   "assignments_differing": differing_assignments(
                       routed, routed_plain),
                   "capacity": routed[0][1], **by_layer(routed)}
    del routed, routed_plain
    b, s = tokens.shape
    H, Hk, dk, dv = attn_widths(cfg)
    gen = torch.Generator(device=tokens.device).manual_seed(0)
    q, k = (torch.randn(b, s, h, dk, generator=gen, device=tokens.device)
            for h in (H, Hk))
    v = torch.randn(b, s, Hk, dv, generator=gen, device=tokens.device)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    flash_err = check_attn(f"flash_attention {dtype} at the prefill's shape",
                           flash_attention(q, k, v, causal=True),
                           flash_attn_ref(q, k, v, causal=True))
    flash = gpu_ms(lambda: flash_attention(q, k, v, causal=True), 10)
    return {"ms": ms, "flash_ms": flash, "flash_max_abs_err": flash_err,
            "flash_share": cfg.n_layers * flash / ms, "row_rel_err": row,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "launches": want_n, "runs": runs, **routing}


def decode_round(params, cfg, seq: torch.Tensor, launches: dict,
                 kernel: str = "flash_attn_fwd_tf32") -> dict:
    """Phase 10 and 11 (b): the f32 decode step over the first
    DECODE_LEN positions of one sequence against
    ``lm_forward(dtype=float32)``, whose flash launches (of ``kernel``)
    must be one a layer."""
    from repro_torch.kernels.launch import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tfm
    seq = seq[None, :DECODE_LEN]
    reset_launches()
    full = tfm.lm_forward(params, seq, cfg, dtype=torch.float32)
    torch.cuda.synchronize()
    n = LAUNCHES[kernel]
    if n != cfg.n_layers:
        raise AssertionError(f"f32 forward: {n} launches of {kernel}")
    launches[kernel] = launches.get(kernel, 0) + n
    cache = tfm.init_kv_cache(cfg, 1, DECODE_LEN, dtype=torch.float32,
                              device=seq.device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec = torch.cat([tfm.lm_decode_step(params, cache, seq[:, p:p + 1], p,
                                        cfg, dtype=torch.float32)[0]
                     for p in range(DECODE_LEN)], dim=1)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / DECODE_LEN
    err = check_tol("decode vs forward", dec, full, DECODE_TOL, DECODE_TOL)
    return {"positions": DECODE_LEN, "max_abs_err": err,
            "step_ms": step_ms}


def generate_round(params, cfg, rng: np.random.Generator, launches: dict,
                   kernel: str = "flash_attn_fwd_tf32",
                   prefill_cfg=None) -> dict:
    """Phase 10 and 11 (c): greedy ``LMServer.generate`` twice on the
    same prompts (identical tokens, in the vocabulary); the first token
    is the argmax of the f32 prefill's logits of the prompts (that
    prefill under ``prefill_cfg``, default ``cfg``), unless the two
    logits lie within DECODE_TOL of each other (a rounding tie).  A MoE
    model's pairs dropped by the first run's decode steps are counted."""
    from repro_torch.kernels.launch import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import LMServer, ServeConfig
    b, p, n = GEN["batch"], GEN["prompt"], GEN["new"]
    server = LMServer(params, cfg, ServeConfig(max_len=p + n))
    prompts = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    with record_routing() as routed:
        runs = [server.generate(prompts, n)]
    dropped = dropped_pairs(routed)
    del routed
    runs.append(server.generate(prompts, n))
    toks = runs[0]["tokens"]
    if not np.array_equal(toks, runs[1]["tokens"]):
        raise AssertionError("greedy generation differs between two runs")
    if toks.shape != (b, n) or not ((toks >= 0)
                                    & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens {toks.shape} out of range")
    reset_launches()
    logits = tfm.lm_prefill(params, prompts, prefill_cfg or cfg,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    launches[kernel] = launches.get(kernel, 0) + LAUNCHES[kernel]
    first = torch.from_numpy(toks[:, 0]).to(logits.device).long()
    top = logits.argmax(dim=-1)
    gap = (logits.gather(1, top[:, None])
           - logits.gather(1, first[:, None]))[:, 0]
    ties = int((top != first).sum())
    if float(gap.max()) > DECODE_TOL:
        raise AssertionError(f"first generated token is not the prefill's "
                             f"argmax (logit gap {float(gap.max())})")
    return {"batch": b, "prompt": p, "new": n,
            "tokens_per_s": [r["tokens_per_s"] for r in runs],
            "wall_s": [r["wall_s"] for r in runs],
            "first_token_rounding_ties": ties,
            **({"decode_dropped_pairs": dropped} if cfg.moe else {}),
            "tokens_head": toks[0, :8].tolist()}


def rag_round(index, params, cfg, queries: np.ndarray,
              rng: np.random.Generator, launches: dict,
              routes=("submit", "router")) -> dict:
    """Phase 10 and 11 (d): ``RAGPipeline.answer_batch`` over the index
    through each of ``routes``, ``submit`` and a two-replica
    ``make_serving_stack`` router: retrieved ids equal ``batch_query``'s
    top-k on each, the dense kernel launched on each, the same tokens on
    each."""
    from repro_torch.kernels.launch import LAUNCHES, reset_launches
    from repro_torch.serve.engine import LMServer, RAGPipeline, ServeConfig
    from repro_torch.serve.stack import make_serving_stack
    qs = queries[:RAG_QUERIES]
    want = np.stack([r.ids for r in index.batch_query(qs, k=RAG_K)])
    server = LMServer(params, cfg, ServeConfig(
        max_len=RAG_K + RAG_PROMPT + RAG_NEW))
    prompts = rng.integers(0, cfg.vocab_size,
                           (RAG_QUERIES, RAG_PROMPT)).astype(np.int32)
    out, tokens = {}, {}
    for route in routes:
        stack = (make_serving_stack(index, n_replicas=2, threaded=True)
                 if route == "router" else None)
        try:
            reset_launches()
            t = time.perf_counter()
            outs = RAGPipeline(index, server, router=stack).answer_batch(
                qs, prompts, n_tokens=RAG_NEW, k=RAG_K)
            secs = time.perf_counter() - t
        finally:
            if stack is not None:
                stack.stop()
        n = LAUNCHES["adc_scan_batch"]
        got = np.stack([o["retrieved_ids"] for o in outs])
        if not np.array_equal(got, want):
            bad = int((got != want).any(1).sum())
            raise AssertionError(f"RAG {route}: retrieved ids differ from "
                                 f"batch_query's on {bad} queries")
        if n < 1:
            raise AssertionError(f"RAG {route}: adc_scan_batch never "
                                 f"launched")
        launches["adc_scan_batch"] = launches.get("adc_scan_batch", 0) + n
        tokens[route] = np.stack([o["tokens"][0] for o in outs])
        out[route] = {"s": secs, "answers_per_s": len(qs) / secs,
                      "adc_scan_batch_launches": n}
    if any(not np.array_equal(tokens[routes[0]], tokens[r])
           for r in routes):
        raise AssertionError("RAG: the routes generated other tokens")
    out["tokens_head"] = tokens[routes[0]][:2].tolist()
    return out


def lm_phase(index, queries: np.ndarray, seed: int) -> dict:
    """Phase 10: Qwen3-0.6B at its full config (random weights from
    ``seed``) on the card, beside the index as phase 9 leaves it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(LM_ARCH)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(seed),
                         cfg, device=dev)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t,
           "params": sum(v.numel() for v in (params["embed"],
                                              params["final_norm"],
                                              *params["blocks"].values()))}
    log(f"lm {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"H {cfg.n_heads}, Hk {cfg.n_kv_heads}, dh {cfg.d_head}, vocabulary "
        f"{cfg.vocab_size}: " + json.dumps(out))
    rng = np.random.default_rng(seed + 10)
    launches = {}
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, PREFILL)).to(dev)
    for dtype, kernel in ((torch.bfloat16, "flash_attn_fwd_wgmma"),
                          (torch.float32, "flash_attn_fwd_tf32")):
        res = prefill_round(params, cfg, tokens, dtype, kernel, launches,
                            LM_ROW_RTOL[dtype])
        out[f"prefill_{str(dtype).split('.')[1]}"] = res
        log(f"lm prefill {dtype} B, S = {PREFILL}: " + json.dumps(res))
    out["decode"] = decode_round(params, cfg, tokens[0], launches)
    log("lm decode vs forward: " + json.dumps(out["decode"]))
    out["generate"] = generate_round(params, cfg, rng, launches)
    log("lm generate: " + json.dumps(out["generate"]))
    out["rag"] = rag_round(index, params, cfg, queries, rng, launches)
    log("rag: " + json.dumps(out["rag"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    return out


# --------------------------------------------------------------- phase 11
def init_model(cfg, seed: int, dev: torch.device) -> tuple:
    """A model's params from ``seed`` on the card, stored in bf16 (drawn
    one layer at a time), and what they take."""
    from repro_torch.models import transformer as tfm
    t = time.perf_counter()
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(x.numel() for v in params.values()
            for x in (v.values() if isinstance(v, dict) else (v,)))
    info = {"init_s": time.perf_counter() - t, "params": n,
            "n_params_config": cfg.n_params(), "weights_gb": 2 * n / 1e9}
    log(f"lm {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, H "
        f"{cfg.n_heads}, Hk {cfg.n_kv_heads}, {cfg.n_experts} experts top-"
        f"{cfg.moe_top_k} (+{cfg.n_shared_experts} shared), first "
        f"{cfg.first_k_dense} dense, MLA {cfg.mla}, attention widths "
        f"{attn_widths(cfg)}, vocabulary {cfg.vocab_size}: "
        + json.dumps(info))
    return params, info


def moe_phase(index, queries: np.ndarray, seed: int) -> tuple:
    """Phase 11: DeepSeek-V2-Lite at its full config, bf16 weights from
    ``seed``, beside the index as phase 10 leaves it: (a) prefill in
    bf16 and f32, (b) decode vs forward, (c) greedy generation, (d) RAG
    through ``submit``; the MLA flash instance alone at its shape; then
    Qwen3-30B-A3B at full width, its depth cut to MOE_LAYERS, (a) and
    (b).  Returns (results, the flash calls for phase 6's timing)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attn_ref,
                                                flash_instance)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed + 11)
    launches = {}
    out = {}
    for arch in (MLA_ARCH, MOE_ARCH):
        cfg = get_config(arch)
        if arch == MOE_ARCH:
            log("reduced: " + json.dumps({
                "model": arch, "n_layers": [cfg.n_layers, MOE_LAYERS]}))
            cfg = dataclasses.replace(cfg, n_layers=MOE_LAYERS)
        params, out[arch] = init_model(cfg, seed, dev)
        res = out[arch]
        _, _, dk, dv = attn_widths(cfg)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, PREFILL)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            kernel = flash_instance(dtype, dk, dv)
            r = prefill_round(params, cfg, tokens, dtype, kernel, launches,
                              MOE_ROW_RTOL[arch][dtype])
            res[f"prefill_{str(dtype).split('.')[1]}"] = r
            log(f"moe {arch} prefill {dtype} B, S = {PREFILL} ({kernel}): "
                + json.dumps(r))
        f32_key = flash_instance(torch.float32, dk, dv)
        cf16 = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY)
        res["decode"] = decode_round(params, cf16, tokens[0], launches,
                                     f32_key)
        log(f"moe {arch} decode vs forward (capacity factor "
            f"{MOE_CAPACITY}): " + json.dumps(res["decode"]))
        if arch == MLA_ARCH:
            res["generate"] = generate_round(params, cfg, rng, launches,
                                             f32_key, prefill_cfg=cf16)
            log(f"moe {arch} generate: " + json.dumps(res["generate"]))
            res["rag"] = rag_round(index, params, cfg, queries, rng,
                                   launches, routes=("submit",))
            log(f"moe {arch} rag: " + json.dumps(res["rag"]))
        del params, tokens
        torch.cuda.empty_cache()
    # the MLA instance alone at DeepSeek-V2-Lite's prefill attention, B = 1
    cfg = get_config(MLA_ARCH)
    H, Hk, dk, dv = attn_widths(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flash_calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn(1, ATTN_LEN, h, dk, generator=gen, device=dev)
                for h in (H, Hk))
        v = torch.randn(1, ATTN_LEN, Hk, dv, generator=gen, device=dev)
        qkv = tuple(x.to(dtype) for x in (q, k, v))
        key = flash_instance(dtype, dk, dv)
        err = check_attn(f"flash_attention {dtype} at MLA's widths ({key})",
                         flash_attention(*qkv, causal=True),
                         flash_attn_ref(*qkv, causal=True))
        log(f"flash_attention {dtype} dh={dk} dv={dv} at "
            f"{MLA_ARCH}'s S, T, H, Hk ({key}): max abs error {err}")
        flash_calls[key] = qkv
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    return out, flash_calls


# --------------------------------------------------------------- phase 12
def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """L2 error over L2 norm, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def measure_bwd(name: str, dtype: torch.dtype, seed: int) -> dict:
    """Phase 12 (a): the backward kernel at row 6b's shape (B = 1, S = T
    = ATTN_LEN, Qwen3-0.6B's heads, causal) on inputs of ``dtype``,
    against its plain version evaluated in f64 on the same residuals (the
    forward kernel's output and lse; also read against it in f32), the
    launch under the instance ``flash_bwd_plan`` names, the forward's lse
    against the plain
    forward's; its time, the plain version's, SDPA's backward alone, and
    the bound: five products a (s, t) pair kept by the mask, the bytes of
    q, k, v, o, dO and lse read and dq, dk, dv written."""
    from repro_torch.kernels.flash_attn import (flash_attention,
                                                flash_attention_bwd,
                                                flash_attn_bwd_ref,
                                                flash_attn_ref,
                                                flash_bwd_plan)
    from repro_torch.kernels.launch import LAUNCHES
    F = torch.nn.functional
    dev = torch.device("cuda")
    H, Hk, dh = QWEN3_ATTN["H"], QWEN3_ATTN["Hk"], QWEN3_ATTN["dh"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(1, ATTN_LEN, H, dh, generator=gen, device=dev)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(1, ATTN_LEN, Hk, dh, generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    _, lse_plain = flash_attn_ref(q, k, v, causal=True, return_lse=True)
    lse_err = float(((lse - lse_plain).abs()
                     / lse_plain.abs().clamp_min(1)).max())
    if not lse_err <= LSE_RTOL:
        raise AssertionError(f"{name}: lse relative error {lse_err} > "
                             f"{LSE_RTOL}")
    del lse_plain
    key = flash_bwd_plan(dtype, dh).key
    before = LAUNCHES[key]
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    if LAUNCHES[key] != before + 1:
        raise AssertionError(f"{name}: no launch of {key}")
    want = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=True,
                              compute=torch.float64)
    plain = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=True)
    limit = BWD_RTOL[dtype]
    errs, plain_errs, plain_exact = {}, {}, {}
    for g_name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: non-finite {g_name}")
        errs[g_name] = rel_l2(g, w)
        plain_errs[g_name] = rel_l2(g, p)
        plain_exact[g_name] = rel_l2(p, w)
        if not errs[g_name] <= limit:
            raise AssertionError(f"{name}: {g_name} relative L2 error "
                                 f"{errs[g_name]} > {limit}")
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs differ")
    max_abs = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    del got, want, plain, again
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    do_t = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                   retain_graph=True)
    lib = sdpa_bwd()
    lib_err = max(rel_l2(g.transpose(1, 2), w) for g, w in zip(
        lib, flash_attention_bwd(q, k, v, out, lse, do, causal=True)))
    del lib
    library_ms = gpu_ms(sdpa_bwd, 5)
    peak, products = exact_products(dtype)
    pairs = ATTN_LEN * (ATTN_LEN + 1) // 2            # (s, t) kept
    nbytes = ((2 * (q.numel() + k.numel() + v.numel()) + out.numel()
               + do.numel()) * q.element_size() + lse.numel() * 4)
    row = dict(
        name=name,
        shape=dict(B=1, S=ATTN_LEN, T=ATTN_LEN, H=H, Hk=Hk, dh=dh,
                   dtype=str(dtype), causal=True),
        max_abs_err=max_abs, rel_l2=errs, rel_l2_vs_f32_plain=plain_errs,
        f32_plain_rel_l2=plain_exact, lse_rel_err=lse_err,
        sdpa_rel_l2=lib_err,
        ms=gpu_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                              causal=True), 5),
        plain_ms=gpu_ms(lambda: flash_attn_bwd_ref(q, k, v, out, lse, do,
                                                   causal=True), 3),
        library_ms=library_ms,
        **bound(nbytes, products * 5 * 2 * H * dh * pairs, peak=peak))
    del q, k, v, do, out, lse, o_sdpa, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def train_phase(seed: int) -> tuple:
    """Phase 12: Qwen3-0.6B's training at its full config in f32 (random
    weights from ``seed``): (a) the backward kernel at row 6b's shape;
    (b) the gradients of ``lm_loss`` on one ``lm_batch`` through the
    kernels against the same on the plain attention; (c) a train step's
    launches; (d) TRAIN_STEPS steps on that batch (the reference's
    ``test_loss_decreases``), a second run of three; (e) ``supervise``
    through an injected failure, at full width cut to FAULT_LAYERS
    layers.  Returns (results, the backward's kernels-line rows)."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attn import BWD_BF16_KEY, BWD_KEY
    from repro_torch.kernels.launch import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FaultInjector, supervise
    from repro_torch.train.loop import (TrainConfig, init_state,
                                        make_train_step, value_and_grad)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, launches = {}, {}
    rows = []
    for name, dtype in (("flash_attn_bwd", torch.float32),
                        ("flash_attn_bwd@bf16", torch.bfloat16)):
        rows.append(measure_bwd(name, dtype, seed))
        r = rows[-1]
        log(f"{name} at row 6b's shape {r['shape']}: rel L2 {r['rel_l2']} "
            f"(limit {BWD_RTOL[dtype]}; against the f32 plain version "
            f"{r['rel_l2_vs_f32_plain']}, which is "
            f"{r['f32_plain_rel_l2']} off), lse {r['lse_rel_err']}, SDPA's "
            f"backward {r['sdpa_rel_l2']}; ms={r['ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.4f}")

    cfg = get_config(LM_ARCH)
    params = tfm.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    rng = np.random.default_rng(seed + 12)
    batch = lm_batch(rng, *TRAIN_BATCH, cfg.vocab_size)
    tokens = TRAIN_BATCH[0] * TRAIN_BATCH[1]

    def loss_fn(p, b, dtype=torch.float32):
        return tfm.lm_loss(p, b, cfg, dtype=dtype)

    # (b) gradients through the kernels, with TF32 allowed by the caller
    # (the backward and its remat recompute run after lm_forward's full_f32
    # has closed: value_and_grad must hold them in full f32), against the
    # plain attention's with TF32 off
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        reset_launches()
        grads, m = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("value_and_grad left TF32 off")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    grew = {n: c for n, c in LAUNCHES.items() if c}
    want = {"flash_attn_fwd_tf32": 2 * cfg.n_layers, BWD_KEY: cfg.n_layers}
    if grew != want:
        raise AssertionError(f"lm_loss gradient: launches {grew}, expected "
                             f"{want}")
    with plain_attention():
        plain, pm = value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    if {n: c for n, c in LAUNCHES.items() if c} != grew:
        raise AssertionError("the plain-attention gradient launched a kernel")
    worst = max((rel_l2(g, w), key) for (key, g), w in zip(
        tree.keyed_leaves(grads), tree.leaves(plain)))
    if not worst[0] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"lm_loss gradient {worst[1]}: relative L2 "
                             f"error {worst[0]} > {TRAIN_GRAD_RTOL}")
    out["grad"] = {"loss": float(m["loss"]), "loss_plain": float(pm["loss"]),
                   "worst_rel_l2": worst[0], "worst_leaf": worst[1],
                   "launches": grew}
    launches["flash_attn_fwd_tf32"] = 2 * cfg.n_layers
    launches["flash_attn_bwd"] = cfg.n_layers
    del grads, plain
    log("train (b) lm_loss gradients, kernels vs plain attention: "
        + json.dumps(out["grad"]))

    # (c), (d): steps on one batch; the first timed alone for its launches
    tcfg = TrainConfig(opt=OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                                           total_steps=40))
    step = make_train_step(loss_fn, tcfg)
    state = init_state(params, tcfg)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))            # synchronises
        secs.append(time.perf_counter() - t)
        grew = {n: c for n, c in LAUNCHES.items() if c}
        if grew != want:
            raise AssertionError(f"train step {i}: launches {grew}, "
                                 f"expected {want}")
    launches["flash_attn_fwd_tf32"] += TRAIN_STEPS * 2 * cfg.n_layers
    launches["flash_attn_bwd"] += TRAIN_STEPS * cfg.n_layers
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    if not losses[-1] < losses[0] - 0.5:
        raise AssertionError(f"loss {losses[0]} -> {losses[-1]} over "
                             f"{TRAIN_STEPS} steps: not down by 0.5")
    del state
    state = init_state(params, tcfg)
    again = []
    for _ in range(3):
        state, m = step(state, batch)
        again.append(float(m["loss"]))
    launches["flash_attn_fwd_tf32"] += 3 * 2 * cfg.n_layers
    launches["flash_attn_bwd"] += 3 * cfg.n_layers
    if not np.allclose(again, losses[:3], rtol=1e-6, atol=0):
        raise AssertionError(f"two runs of three steps: {again} vs "
                             f"{losses[:3]}")
    del state
    step_s = float(np.median(secs[1:]))
    out["steps"] = {"losses": losses, "rerun": again,
                    "first_step_s": secs[0], "step_ms": 1e3 * step_s,
                    "step_ms_min": 1e3 * min(secs[1:]),
                    "tokens_per_s": tokens / step_s,
                    "launches_per_step": want}
    log(f"train (c), (d) {TRAIN_STEPS} steps at lr {TRAIN_LR}, B, S = "
        f"{TRAIN_BATCH}: " + json.dumps(out["steps"]))

    # one bf16 step's gradient: the backward kernel on bf16 residuals
    reset_launches()
    value_and_grad(lambda p, b: loss_fn(p, b, torch.bfloat16), params, batch)
    torch.cuda.synchronize()
    grew = {n: c for n, c in LAUNCHES.items() if c}
    want16 = {"flash_attn_fwd_wgmma": 2 * cfg.n_layers,
              BWD_BF16_KEY: cfg.n_layers}
    if grew != want16:
        raise AssertionError(f"bf16 gradient: launches {grew}, expected "
                             f"{want16}")
    launches["flash_attn_fwd_wgmma"] = 2 * cfg.n_layers
    launches["flash_attn_bwd@bf16"] = cfg.n_layers
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()

    # (e) the supervisor through an injected failure, depth cut
    small = dataclasses.replace(cfg, n_layers=FAULT_LAYERS)
    log("reduced: " + json.dumps({"model": f"{LM_ARCH} (phase 12 (e))",
                                  "n_layers": [cfg.n_layers, FAULT_LAYERS]}))
    fcfg = TrainConfig(opt=OptimizerConfig(lr=TRAIN_LR, warmup_steps=1,
                                           total_steps=30),
                       ckpt_every=5, keep_ckpts=2)
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = dataclasses.replace(fcfg, ckpt_dir=tmp)
        injector = FaultInjector([7])

        def on_step(s):
            seen.append(s)
            injector(s)

        def init_fn():
            return init_state(tfm.init_lm(
                torch.Generator(device=dev).manual_seed(seed), small,
                device=dev), fcfg)

        def batches(n):
            r = np.random.default_rng(seed + 13)
            for _ in range(n):
                yield lm_batch(r, *FAULT_BATCH, small.vocab_size)
        t = time.perf_counter()
        reset_launches()
        state, restarts, _ = supervise(
            lambda: make_train_step(
                lambda p, b: tfm.lm_loss(p, b, small, dtype=torch.float32),
                fcfg), init_fn, batches, fcfg, total_steps=10,
            max_restarts=2, on_step=on_step, device=dev)
        torch.cuda.synchronize()
        grew = {n: c for n, c in LAUNCHES.items() if c}
        resumed = seen[seen.index(7) + 1]
        final = int(state["opt"]["step"])
        if (restarts, resumed, final, ckpt.latest_step(tmp)) != (1, 5, 10,
                                                                 10):
            raise AssertionError(f"supervise: restarts {restarts}, resumed "
                                 f"at {resumed}, ended at {final}")
        del state
    out["fault"] = {"restarts": restarts, "resumed_at": resumed,
                    "final_step": final, "steps_seen": seen,
                    "s": time.perf_counter() - t, "launches": grew}
    launches["flash_attn_fwd_tf32"] += grew.get("flash_attn_fwd_tf32", 0)
    launches["flash_attn_bwd"] += grew.get(BWD_KEY, 0)
    log("train (e) supervise, FaultInjector([7]), ckpt_every=5: "
        + json.dumps(out["fault"]))
    torch.cuda.empty_cache()
    out["launches"] = launches
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
    return out, rows


def exact_products(dtype: torch.dtype) -> tuple[float, int]:
    """The fastest rate the card has for products of inputs of ``dtype``
    that are exact in f32, and how many products each takes: inputs exact
    in bf16 (bf16, uint8, int8) in one on the tensor cores, others in
    three (3xTF32), whichever unit the kernel runs on."""
    from repro_torch.kernels.launch import operand_dtype
    return ((BF16_FLOPS, 1) if operand_dtype(dtype) == torch.bfloat16
            else (TF32_FLOPS, 3))


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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
    from repro_torch.kernels import build
    from repro_torch.kernels.pq_adc import ops

    dev = torch.device("cuda")
    # the plain versions' products and the yardsticks in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    check_entry_kernels_small(dev, np.random.default_rng(args.seed + 2))
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
    ops.reset_launches()
    gt = ground_truth(data, queries, 10)
    gt_launches = dict(ops.LAUNCHES)
    t_gt = time.perf_counter() - t
    if gt_launches["l2dist_wgmma"] < 1:
        raise AssertionError("ground truth never launched l2dist_wgmma")
    t = time.perf_counter()
    gt_plain = ground_truth_plain(data, queries, 10)
    if not np.array_equal(gt, gt_plain):
        bad = int((gt != gt_plain).any(1).sum())
        raise AssertionError(f"ground truth ids differ from the plain "
                             f"version's on {bad} queries")
    log(f"ground truth (l2dist_wgmma kernel, chunks of 2^20 rows): "
        f"{t_gt:.1f} s, "
        f"launches={gt_launches}; plain version "
        f"{time.perf_counter() - t:.1f} s; ids identical for all "
        f"{len(gt)} queries")

    ids, metrics, launches = {}, {}, {}
    with Recorder() as recorder:
        for path, kernel, plan in SERVE_PATHS:
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

    entry_launches, entry_calls = drive_entry_points(
        index, cfg.top_n, data, queries, args.seed)
    entry_names = ("adc_scan", "adc_scan_topk", "adc_fused_topk[spill]",
                   "adc_fused_topk[spill,lut_int8]", "l2dist_wgmma",
                   "l2dist_wgmma[bf16]", "l2dist_wgmma[bf16,off16]",
                   "l2dist_wgmma[bf16,odd]", "l2dist_wgmma[bf16]@uint8",
                   "l2dist_wgmma[d>128]", "l2dist_wgmma[bf16,d>128]",
                   "flash_attn_fwd_wgmma", "flash_attn_fwd_tf32",
                   "flash_attn_fwd_wgmma[padded]",
                   "flash_attn_fwd_tf32[padded]",
                   "flash_attn_fwd_tf32[256]", "flash_attn_fwd_wgmma[256]",
                   "flash_attn_fwd_wgmma[stride-pad]")
    for name in entry_names:
        if entry_launches[launch_key(name)] < 1:
            raise AssertionError(f"the entry points never launched "
                                 f"{launch_key(name)}")

    rows = measure(recorder.calls) + measure_entry(entry_calls)
    per_path = {"adc_scan_batch": launches["dense"]["adc_scan_batch"],
                "adc_fused_topk": launches["fused"]["adc_fused_topk"],
                "adc_fused_topk[lut_int8]":
                    launches["fused_int8"]["adc_fused_topk"],
                "adc_scan": entry_launches["adc_scan"],
                "adc_scan_topk": entry_launches["adc_scan_topk"],
                **{name: entry_launches[launch_key(name)]
                   for name in entry_names[2:]},
                "l2dist_wgmma": gt_launches["l2dist_wgmma"]}
    kernels = []
    for r in rows:
        shape = r.pop("shape")
        log(f"timing {r['name']} {shape}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
        kernels.append({"name": r["name"], **KERNELS[r["name"]],
                        "launches": per_path[r["name"]], **r})
    t = time.perf_counter()
    mut = mutation_phase(index, data, queries, gt, args.seed)
    log(f"mutation: ok, {time.perf_counter() - t:.1f} s; "
        + json.dumps(mut) + "; plain PQ recall@10 (phase 4) "
        + json.dumps({p: metrics[p]["recall_at_10"] for p in metrics}))
    del data
    t = time.perf_counter()
    srv = serving_phase(index, queries, args.seed)
    log(f"serving: ok, {time.perf_counter() - t:.1f} s; "
        + json.dumps({k: v for k, v in srv.items() if k != "launches"}))
    # phase 8's stacks count under the serving kernels' keys too
    for k in kernels:
        path = SERVING_KEYS.get(k["name"])
        if path is not None:
            k["launches"] += srv["launches"][path].get(
                k["name"].split("[")[0], 0)
    t = time.perf_counter()
    msh = mesh_phase(index, queries, args.seed)
    log(f"mesh: ok, {time.perf_counter() - t:.1f} s; launches="
        + json.dumps(msh["launches"]))
    # and phase 9's sharded runs, each kernel's under its row
    for k in kernels:
        k["launches"] += msh["launches"].get(k["name"], 0)
    t = time.perf_counter()
    lm = lm_phase(index, queries, args.seed)
    log(f"lm: ok, {time.perf_counter() - t:.1f} s; peak "
        f"{lm['peak_gb']:.1f} GB; launches=" + json.dumps(lm["launches"]))
    # and phase 10's model and RAG runs
    for k in kernels:
        k["launches"] += lm["launches"].get(k["name"], 0)
    t = time.perf_counter()
    moe, moe_flash = moe_phase(index, queries, args.seed)
    log(f"moe: ok, {time.perf_counter() - t:.1f} s; peak "
        f"{moe['peak_gb']:.1f} GB; launches=" + json.dumps(moe["launches"]))
    # and phase 11's, with the rows of the MLA instance timed at its shape
    for k in kernels:
        k["launches"] += moe["launches"].get(k["name"], 0)
    for name, qkv in moe_flash.items():
        r = measure_flash(name, *qkv)
        shape = r.pop("shape")
        log(f"timing {name} {shape}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
        kernels.append({"name": name, **KERNELS[name],
                        "launches": moe["launches"].get(name, 0), **r})
    del moe_flash
    t = time.perf_counter()
    trn, bwd_rows = train_phase(args.seed)
    log(f"train: ok, {time.perf_counter() - t:.1f} s; peak "
        f"{trn['peak_gb']:.1f} GB; launches=" + json.dumps(trn["launches"]))
    # and phase 12's training runs, with the backward's rows
    for k in kernels:
        if k["name"] in ("flash_attn_fwd_tf32", "flash_attn_fwd_wgmma"):
            k["launches"] += trn["launches"].get(k["name"], 0)
    for r in bwd_rows:
        shape = r.pop("shape")
        for extra in ("rel_l2", "lse_rel_err", "sdpa_rel_l2"):
            r.pop(extra)
        kernels.append({"name": r["name"], **KERNELS[r["name"]], **r})
        log(f"timing {r['name']} {shape}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
