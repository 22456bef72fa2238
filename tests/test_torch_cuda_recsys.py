"""The recsys and GNN models of ``repro_torch`` on the card, against their
plain versions.  Marked ``gpu``: without a CUDA device they skip (a CUDA
kernel has no CPU mode).  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_recsys.py

Tolerances: forwards on the card within 1e-5 relative (rtol 1e-5, atol
1e-6 per element) of the same forward on the CPU, where the CPU runs the
plain versions (f32 products with TF32 off on both sides, summed in
another order); BERT4Rec's attention at its full shape (B 8, S = T =
200, H 2, dh 32, not causal) within 2e-5 of the plain scan on the card
(an online softmax in 3xTF32 against a plain one, as the kernel tests
hold it); two SAGE runs on the card bit for bit (segment sums in a fixed
order); the ADC dense and fused scans at the recsys item index's M = 16,
dsub = 5 bit for bit (f32 and int8 LUTs).
"""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.data import graphs, synthetic
from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import flash_plan
from repro_torch.kernels.pq_adc import ops, ref
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R

RTOL, ATOL = 1e-5, 1e-6
FLASH_F32 = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _host(params):
    return tree.tree_map(lambda x: x.cpu(), params)


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-rm2", "wide-deep"])
@pytest.mark.parametrize("batch", [8, 16384])
def test_cuda_ranking_forward_matches_host(cuda, arch, batch):
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    rng = np.random.default_rng(1)
    if cfg.kind == "dlrm":
        p = R.init_dlrm(gen, cfg, cuda)
        b = synthetic.recsys_dlrm_batch(rng, batch, cfg.n_dense,
                                        cfg.n_sparse, cfg.vocab_size)
        got = R.dlrm_forward(p, b["dense"], b["sparse_ids"], cfg)
        want = R.dlrm_forward(_host(p), b["dense"], b["sparse_ids"], cfg)
    else:
        p = R.init_wide_deep(gen, cfg, cuda)
        b = synthetic.recsys_sparse_batch(rng, batch, cfg.n_sparse,
                                          cfg.vocab_size)
        got = R.wide_deep_forward(p, b["sparse_ids"], cfg)
        want = R.wide_deep_forward(_host(p), b["sparse_ids"], cfg)
    assert got.is_cuda and got.shape == (batch,)
    _close(got, want)


@pytest.mark.gpu
def test_cuda_bert4rec_launches_flash_and_matches_host(cuda):
    cfg = get_config("bert4rec", reduced=True)
    p = R.init_bert4rec(torch.Generator(device=cuda).manual_seed(0), cfg,
                        cuda)
    b = synthetic.recsys_seq_batch(np.random.default_rng(2), 4, cfg.seq_len,
                                   cfg.vocab_size, n_neg=15)
    key = flash_plan(torch.float32, cfg.embed_dim // cfg.n_heads,
                     cfg.embed_dim // cfg.n_heads).key
    launch.reset_launches()
    u = R.bert4rec_user_embedding(p, b["item_ids"], cfg)
    flash = {k: n for k, n in launch.LAUNCHES.items()
             if k.startswith("flash_attn") and n}
    assert flash == {key: cfg.n_blocks}
    hp = _host(p)
    _close(u, R.bert4rec_user_embedding(hp, b["item_ids"], cfg))
    args = [b[k] for k in ("item_ids", "mask_pos", "pos_items",
                           "neg_items")]
    _close(R.bert4rec_sampled_loss(p, *args, cfg)[0],
           R.bert4rec_sampled_loss(hp, *args, cfg)[0])


@pytest.mark.gpu
def test_cuda_bert4rec_attention_at_full_shape(cuda):
    """BERT4Rec's attention at its full config's shape: one launch of
    the f32 kernel's narrow (32, 32) instance, against the plain scan on
    the card."""
    cfg = get_config("bert4rec")
    dh = cfg.embed_dim // cfg.n_heads
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(8, cfg.seq_len, cfg.n_heads, dh, generator=g,
                           device=cuda) for _ in range(3))
    launch.reset_launches()
    got = L.blockwise_attention(q, k, v, causal=False,
                                block_size=min(512, cfg.seq_len))
    assert launch.LAUNCHES["flash_attn_fwd_tf32[32]"] == 1
    want = L._attention_fwd_scan(q, k, v, False, 0, cfg.seq_len,
                                 dh ** -0.5)[0]
    torch.testing.assert_close(got, want, rtol=FLASH_F32, atol=FLASH_F32)


@pytest.mark.gpu
def test_cuda_mind_and_scores_match_host(cuda):
    cfg = get_config("mind", reduced=True)
    p = R.init_mind(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    hist = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (6, cfg.hist_len))
    got = R.mind_interests(p, hist, cfg)
    hp = _host(p)
    _close(got, R.mind_interests(hp, hist, cfg))
    v, i = R.score_all_items(got[:, 0], p["item_embed"], 10)
    assert v.is_cuda and i.dtype == torch.int32
    tie = v[:, 1:] == v[:, :-1]
    assert not (v[:, 1:] > v[:, :-1]).any()
    assert not (i[:, 1:] <= i[:, :-1])[tie].any()


def _sage_cases(cfg, rng):
    g = graphs.random_graph(rng, 300, 2000, cfg.d_feat, cfg.n_classes)
    indptr, idx = graphs.build_csr(g["edges"], 300)
    hops = graphs.sample_two_hop(rng, indptr, idx, np.arange(64),
                                 cfg.sample_sizes, g["features"])
    mol = graphs.block_diagonal_batch(rng, 16, 30, 64, cfg.d_feat,
                                      cfg.n_classes)
    return {"full": (G.sage_forward_full, (g["features"], g["edges"])),
            "minibatch": (G.sage_forward_minibatch, hops),
            "batched": (G.sage_forward_batched,
                        (mol["features"], mol["edges"], mol["graph_ids"],
                         16))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["full", "minibatch", "batched"])
def test_cuda_sage_matches_host_and_repeats(cuda, case):
    cfg = get_config("graphsage-reddit", reduced=True)
    fn, args = _sage_cases(cfg, np.random.default_rng(5))[case]
    p = G.init_sage(torch.Generator(device=cuda).manual_seed(0), cfg,
                    device=cuda)
    on = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
          for a in args]
    got = fn(p, *on, cfg=cfg)
    assert torch.equal(got, fn(p, *on, cfg=cfg))
    want = fn(_host(p), *[a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in on], cfg=cfg)
    _close(got, want)


@pytest.mark.gpu
def test_cuda_segment_reduce_repeats_on_many_duplicates(cuda):
    """A few destinations with thousands of edges each: the sums come
    back bit for bit from run to run."""
    g = torch.Generator(device=cuda).manual_seed(6)
    v = torch.randn(200_000, 16, generator=g, device=cuda)
    seg = torch.randint(0, 7, (200_000,), generator=g, device=cuda)
    a = L.segment_reduce(v, seg, 7)
    for _ in range(3):
        assert torch.equal(a, L.segment_reduce(v, seg, 7))
    _close(a, L.segment_reduce(v.cpu(), seg.cpu(), 7), rtol=1e-4,
           atol=1e-3)


@pytest.mark.gpu
def test_cuda_adc_scans_at_dsub5(cuda):
    """The recsys item index's widths: M = 16 sub-spaces of 5 floats (the
    fused kernel builds its LUT one float at a time), dense and fused
    scans bit for bit, f32 and int8 LUTs."""
    rng = np.random.default_rng(7)
    n, m, k, dsub, b = 20_000, 16, 256, 5, 64
    cb = torch.from_numpy(rng.standard_normal((m, k, dsub)).astype(
        np.float32)).to(cuda)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(
        np.uint8)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, m * dsub)).astype(
        np.float32)).to(cuda)
    luts = ref.build_luts_ref(cb, q)
    assert torch.equal(ops.pq_adc_batch(codes, luts),
                       ref.pq_adc_batch_ref(codes, luts))
    rows = np.full((b, 2048), -1, np.int32)
    for i in range(b - 1):
        c = int(rng.integers(1, 2049))
        rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
    rows = torch.from_numpy(rows).to(cuda)
    for int8 in (False, True):
        launch.reset_launches()
        kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, 128,
                                       lut_int8=int8)
        assert launch.LAUNCHES["adc_fused_topk"] == 1
        pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, 128,
                                             lut_int8=int8)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
