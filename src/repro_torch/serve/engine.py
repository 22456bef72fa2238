"""LM serving engine: prefill + greedy/temperature decode with the KV cache,
plus the RAG front end that wires FusionANNS retrieval into generation
(paper Fig. 1).  The port's counterpart of the JAX package's
``serve/engine.py``, with the same surface."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import LOCAL_CTX, ShardCtx


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0          # 0 = greedy
    cache_dtype: Any = torch.float32


class LMServer:
    """Static-batched decode server (one shared position counter, the
    production pattern exercised by the decode_32k / long_500k cells).
    Decodes in f32 on the params' device."""

    def __init__(self, params, cfg: LMConfig, scfg: ServeConfig = ServeConfig(),
                 ctx: ShardCtx = LOCAL_CTX):
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.ctx = ctx
        self.device = params["embed"].device

    def _decode(self, cache, tokens: torch.Tensor, pos: int,
                gen: torch.Generator) -> torch.Tensor:
        logits, _ = tfm.lm_decode_step(self.params, cache, tokens, pos,
                                       self.cfg, self.ctx,
                                       dtype=torch.float32)
        last = logits[:, -1]
        if self.scfg.temperature > 0:
            probs = torch.softmax(last / self.scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt[:, None]

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 seed: int = 0) -> Dict[str, Any]:
        """prompts (B, P) int32 -> generated (B, n_tokens) int32.

        Greedy decoding takes the first largest logit, as ``jnp.argmax``
        does.  Temperature sampling draws from a ``torch.Generator`` on
        the params' device seeded by ``seed``: reproducible from the seed,
        but not the reference's ``jax.random.categorical`` stream, which
        torch cannot reproduce."""
        B, P = prompts.shape
        cache = tfm.init_kv_cache(self.cfg, B, self.scfg.max_len,
                                  dtype=self.scfg.cache_dtype,
                                  device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        # prefill token-by-token through the decode path (correct though
        # not the fast path; the prefill cell lowers the batched version)
        t0 = time.perf_counter()
        for p in range(P):
            nxt = self._decode(cache, toks[:, p:p + 1], p, gen)
        out = [nxt]
        for i in range(n_tokens - 1):
            out.append(self._decode(cache, out[-1], P + i, gen))
        gen_tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        dt = time.perf_counter() - t0
        return {"tokens": gen_tokens,
                "tokens_per_s": B * (P + n_tokens) / dt,
                "wall_s": dt}


class RAGPipeline:
    """Retrieval-augmented generation: FusionANNS retrieves the top-k
    context vectors for the query embedding; their ids become context
    tokens prepended to the prompt (paper Fig. 1 flow).

    Uses the futures-first retrieval API (DESIGN.md §3): ``answer`` submits
    the retrieval (host traversal + async device scan) and only blocks on
    the future when the context tokens are needed; ``answer_batch``
    pipelines a whole request window through one submission, resolving
    each retrieval future right before its generation step.

    ``router=`` swaps the retrieval tier for a
    :class:`~repro_torch.serve.router.ReplicaRouter` (DESIGN.md §5): each
    retrieval is routed via a typed
    :class:`~repro_torch.serve.client.SearchRequest` to one of N serving
    replicas, and the per-request future resolves to a
    :class:`~repro_torch.serve.client.SearchResponse` — the same
    ``ids``/``stats`` surface as an executor
    :class:`~repro_torch.core.engine.QueryResult`; the replicas' pump
    threads make progress instead of ``ticket.poll()``."""

    def __init__(self, anns_index, lm_server: LMServer,
                 embed_fn: Optional[Callable] = None, router=None):
        self.index = anns_index
        self.server = lm_server
        self.embed = embed_fn or (lambda toks: None)
        self.router = router

    def _retrieve(self, query_vecs: np.ndarray, k: int,
                  inflight_depth: int = 2):
        """Submit every query; returns ``(futures, poll)`` where each
        future resolves to something with the ``ids``/``dists``/``stats``
        surface — a ``QueryResult`` from the executor ticket, or a
        ``SearchResponse`` from a router — and ``poll()`` opportunistically
        retires landed scan windows."""
        q = np.atleast_2d(np.asarray(query_vecs, np.float32))
        if self.router is not None:
            from repro_torch.serve.client import SearchRequest
            return ([self.router.submit(SearchRequest(query=v, k=k))
                     for v in q], lambda: None)
        ticket = self.index.submit(q, k=k, window=1,
                                   inflight_depth=inflight_depth)
        return list(ticket.futures), ticket.poll

    def _ctx_tokens(self, res) -> np.ndarray:
        vocab = self.server.cfg.vocab_size
        return (res.ids.astype(np.int64) % vocab).astype(np.int32)

    def answer(self, query_vec: np.ndarray, prompt: np.ndarray,
               n_tokens: int = 16, k: int = 4) -> Dict[str, Any]:
        futs, _ = self._retrieve(np.asarray(query_vec, np.float32)[None], k)
        res = futs[0].result()             # scan was in flight since submit
        full = np.concatenate([self._ctx_tokens(res)[None, :], prompt],
                              axis=1)
        out = self.server.generate(full, n_tokens)
        out["retrieved_ids"] = res.ids
        out["retrieval_stats"] = res.stats
        return out

    def answer_batch(self, query_vecs: np.ndarray, prompts: np.ndarray,
                     n_tokens: int = 16, k: int = 4,
                     inflight_depth: int = 2) -> List[Dict[str, Any]]:
        """One retrieval submission for B requests: per-request scan
        windows pipeline on the device (depth ``inflight_depth``) while the
        host runs generation for already-resolved requests.  After each
        generation step the ticket is polled, so retrieval windows whose
        scan landed during generation retire opportunistically (possibly
        out of order) and the next ``result()`` returns without
        blocking."""
        futs, poll = self._retrieve(np.asarray(query_vecs, np.float32), k,
                                    inflight_depth=inflight_depth)
        outs: List[Dict[str, Any]] = []
        for fut, prompt in zip(futs, prompts):
            res = fut.result()
            full = np.concatenate([self._ctx_tokens(res)[None, :],
                                   prompt[None] if prompt.ndim == 1
                                   else prompt], axis=1)
            out = self.server.generate(full, n_tokens)
            out["retrieved_ids"] = res.ids
            out["retrieval_stats"] = res.stats
            outs.append(out)
            # generation kept the host busy: retire any landed scans now
            # (no-op under a router — replica pump threads own progress)
            poll()
        return outs
