"""The port's LM server, RAG front end and serving launcher
(``repro_torch.serve.engine``, ``repro_torch.launch.serve``) against the
JAX package's, on the CPU.

* ``LMServer.generate``, greedy: the reference server's tokens on the
  same params (carried across by ``params_from_numpy``), for the three
  dense LMs, reduced.  Equal exactly: the two decode steps' logits agree
  to ~1e-6 (``tests/test_torch_models.py``), far inside any gap between
  a reduced model's two largest logits on these prompts.
* Temperature sampling: reproducible from its seed and in the vocabulary
  (the reference's ``jax.random`` stream is not reproduced).
* ``RAGPipeline.answer`` / ``answer_batch``: the reference pipeline's
  retrieved ids and generated tokens over the same index (the shared
  test index ``anns_bundle`` and the port's load of its snapshot),
  through the executor's ``submit`` and through a ``ReplicaRouter``.
* ``python -m repro_torch.launch.serve`` in both modes on the CPU.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as ref_config
from repro.models import transformer as RT
from repro.serve.engine import (LMServer as RefServer,
                                RAGPipeline as RefRAG,
                                ServeConfig as RefServeConfig)
from repro.serve.router import ReplicaRouter as RefRouter
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMServer, RAGPipeline, ServeConfig
from repro_torch.serve.router import ReplicaRouter

from _torch_serving import (pair, port_witness_guard,  # noqa: F401
                            snapshot)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@functools.lru_cache(maxsize=None)
def _servers(arch, max_len=32, temperature=0.0):
    """The reference's server and the port's, on the same params."""
    rcfg = ref_config(arch, reduced=True)
    rp = RT.init_lm(jax.random.key(0), rcfg)
    pp = T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return (RefServer(rp, rcfg, RefServeConfig(max_len=max_len,
                                               temperature=temperature)),
            LMServer(pp, get_config(arch, reduced=True),
                     ServeConfig(max_len=max_len, temperature=temperature)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-4b", "chatglm3-6b"])
def test_greedy_generate_matches_reference(rng, arch):
    ref, port = _servers(arch)
    prompts = rng.integers(0, port.cfg.vocab_size, (2, 6), dtype=np.int32)
    want = ref.generate(prompts, 8)
    got = port.generate(prompts, 8)
    assert got["tokens"].dtype == np.int32 and got["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens_per_s"] > 0 and got["wall_s"] > 0
    np.testing.assert_array_equal(port.generate(prompts, 8)["tokens"],
                                  got["tokens"])


def test_temperature_sampling_is_seeded(rng):
    _, port = _servers("qwen3-0.6b", temperature=1.0)
    prompts = rng.integers(0, port.cfg.vocab_size, (3, 4), dtype=np.int32)
    a = port.generate(prompts, 10, seed=7)["tokens"]
    b = port.generate(prompts, 10, seed=7)["tokens"]
    c = port.generate(prompts, 10, seed=8)["tokens"]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < port.cfg.vocab_size)).all()


def _rag_pair(pair, router_kw=None):
    b, idx = pair
    ref_srv, port_srv = _servers("qwen3-0.6b")
    if router_kw is None:
        return RefRAG(b.index, ref_srv), RAGPipeline(idx, port_srv), []
    routers = [RefRouter(b.index, **router_kw), ReplicaRouter(idx,
                                                              **router_kw)]
    return (RefRAG(b.index, ref_srv, router=routers[0]),
            RAGPipeline(idx, port_srv, router=routers[1]), routers)


@pytest.mark.parametrize("route", ["submit", "router"])
def test_rag_matches_reference(pair, route):
    b, idx = pair
    kw = (None if route == "submit" else
          dict(n_replicas=2, policy="jsq", max_batch=4, max_wait_s=0.001))
    ref, port, routers = _rag_pair(pair, kw)
    rng = np.random.default_rng(3)
    vocab = port.server.cfg.vocab_size
    try:
        prompt = rng.integers(0, vocab, (1, 4), dtype=np.int32)
        want = ref.answer(b.queries[3], prompt, n_tokens=4, k=b.cfg.top_k)
        got = port.answer(b.queries[3], prompt, n_tokens=4, k=b.cfg.top_k)
        np.testing.assert_array_equal(got["retrieved_ids"],
                                      want["retrieved_ids"])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["retrieval_stats"].ios == want["retrieval_stats"].ios
        qs = b.queries[:6]
        prompts = rng.integers(0, vocab, (6, 3), dtype=np.int32)
        want = ref.answer_batch(qs, prompts, n_tokens=3, k=5)
        got = port.answer_batch(qs, prompts, n_tokens=3, k=5)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["retrieved_ids"],
                                          w["retrieved_ids"])
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
        # and they are the index's own answers
        np.testing.assert_array_equal(
            np.stack([g["retrieved_ids"] for g in got]),
            np.stack([r.ids for r in idx.batch_query(qs, k=5)]))
    finally:
        for r in routers:
            r.stop()


def _launch(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_launch_serve_lm_on_cpu():
    res = _launch("--mode", "lm", "--arch", "qwen3-0.6b", "--reduced")
    assert res["shape"] == [2, 16] and res["tokens_per_s"] > 0


def test_launch_serve_anns_on_cpu():
    res = _launch("--mode", "anns", "--n", "2000", "--queries", "16")
    assert res["recall@10"] > 0.5 and res["mean_ios"] >= 0

