"""The port's recsys models and batches (``repro_torch.models.recsys``,
``repro_torch.data.synthetic.recsys_*_batch``) against the JAX package's,
on the CPU, on the same numpy-seeded inputs and the reference's own params
carried across by ``transformer.params_from_numpy``.

Tolerances: batches bit for bit (the same numpy draws); f32 functions
rtol 1e-5 / atol 1e-6 (the same operations summed in another order);
``score_all_items``' values within 2^-8 relative (one bf16 rounding of
each side's f32 sums), and its ids equal at every rank except where the
two packages' bf16 scores of the ids at that rank round apart (both
products sum in f32 in their own order and round once to bf16, so a
score near a rounding boundary may land on either side; ties among equal
scores go to the lowest id on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.data import synthetic as RS
from repro.models import recsys as RR
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.sharding.spec import LOCAL_CTX, ShardCtx, rules_for_mesh

RTOL, ATOL = 1e-5, 1e-6
SCORE_REL = 2.0 ** -8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _params(arch: str, init: str):
    """(reference params, the same as the port's, both configs)."""
    rcfg, cfg = ref_config(arch, reduced=True), get_config(arch,
                                                           reduced=True)
    rp = getattr(RR, init)(jax.random.key(0), rcfg)
    return rp, T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu"), \
        rcfg, cfg


# ---------------------------------------------------------------- batches
@pytest.mark.parametrize("fn,args", [
    ("recsys_dlrm_batch", (8, 13, 26, 1000)),
    ("recsys_dlrm_batch", (5, 13, 6, 512, 3)),
    ("recsys_sparse_batch", (8, 40, 1000)),
    ("recsys_sparse_batch", (3, 6, 512, 2)),
    ("recsys_seq_batch", (4, 200, 1 << 20)),
    ("recsys_seq_batch", (6, 16, 512, 9)),
])
def test_batches_bit_equal(fn, args):
    got = getattr(S, fn)(np.random.default_rng(7), *args)
    want = getattr(RS, fn)(np.random.default_rng(7), *args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------------- EmbeddingBag
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged(mode):
    """Unsorted segment ids, an empty bag (bag 2), a segment id past
    n_bags (dropped)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 23).astype(np.int32)
    seg = rng.permutation(np.array([0] * 5 + [1] * 7 + [3] * 4 + [4] * 6
                                   + [9]))
    seg = seg.astype(np.int32)
    got = R.embedding_bag_ragged(torch.from_numpy(table), ids, seg, 5, mode)
    want = RR.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(seg), 5, mode)
    if mode == "max":
        assert np.all(np.isneginf(_np(got)[2]))
    _close(got, want)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("gdt", [None, "bf16"])
def test_embedding_bag_dense(mode, gdt):
    rng = np.random.default_rng(2)
    tables = rng.standard_normal((3, 40, 8)).astype(np.float32)
    ids = rng.integers(0, 40, (6, 3, 4)).astype(np.int32)
    got = R.embedding_bag_dense(torch.from_numpy(tables), ids, mode,
                                None if gdt is None else torch.bfloat16)
    want = RR.embedding_bag_dense(jnp.asarray(tables), jnp.asarray(ids),
                                  mode,
                                  None if gdt is None else jnp.bfloat16)
    assert (got.dtype == torch.bfloat16) == (gdt is not None)
    if gdt is None:
        _close(got, want)
    else:
        # each side sums bf16 rows in f32 and rounds once
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -8,
                                   atol=0)


def test_bf16_gather_rounds_rows_as_the_table():
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(rng.standard_normal((2, 30, 4)).astype(
        np.float32))
    ids = rng.integers(0, 30, (5, 2, 1))
    got = R.embedding_bag_dense(tables, ids, "mean", torch.bfloat16)
    want = tables.to(torch.bfloat16)[torch.arange(2)[None, :, None],
                                     torch.from_numpy(ids)][:, :, 0]
    assert torch.equal(got, want)


# -------------------------------------------------------- ranking models
@pytest.mark.parametrize("batch", [8, 16384])
def test_dlrm_forward(batch):
    rp, p, rcfg, cfg = _params("dlrm-rm2", "init_dlrm")
    b = S.recsys_dlrm_batch(np.random.default_rng(4), batch, cfg.n_dense,
                            cfg.n_sparse, cfg.vocab_size, cfg.multi_hot)
    got = R.dlrm_forward(p, torch.from_numpy(b["dense"]), b["sparse_ids"],
                         cfg)
    want = RR.dlrm_forward(rp, jnp.asarray(b["dense"]),
                           jnp.asarray(b["sparse_ids"]), rcfg)
    assert got.shape == (batch,)
    _close(got, want)
    _close(R.bce_loss(got, b["labels"])[0],
           RR.bce_loss(want, jnp.asarray(b["labels"]))[0])


@pytest.mark.parametrize("batch", [8, 16384])
def test_wide_deep_forward(batch):
    rp, p, rcfg, cfg = _params("wide-deep", "init_wide_deep")
    b = S.recsys_sparse_batch(np.random.default_rng(5), batch, cfg.n_sparse,
                              cfg.vocab_size, cfg.multi_hot)
    got = R.wide_deep_forward(p, b["sparse_ids"], cfg)
    want = RR.wide_deep_forward(rp, jnp.asarray(b["sparse_ids"]), rcfg)
    assert got.shape == (batch,)
    _close(got, want)


def test_bce_loss():
    rng = np.random.default_rng(6)
    logits = (4 * rng.standard_normal(64)).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    got = R.bce_loss(torch.from_numpy(logits), labels)
    want = RR.bce_loss(jnp.asarray(logits), jnp.asarray(labels))
    for k in ("loss", "accuracy"):
        _close(got[1][k], want[1][k])
    _close(got[0], want[0])


# ------------------------------------------------------ sequence models
def _seq_batch(cfg, batch=4):
    return S.recsys_seq_batch(np.random.default_rng(8), batch, cfg.seq_len,
                              cfg.vocab_size, n_neg=15)


def test_bert4rec_encode_and_user_embedding():
    rp, p, rcfg, cfg = _params("bert4rec", "init_bert4rec")
    ids = _seq_batch(cfg)["item_ids"]
    h = R.bert4rec_encode(p, ids, cfg)
    _close(h, RR.bert4rec_encode(rp, jnp.asarray(ids), rcfg))
    u = R.bert4rec_user_embedding(p, ids, cfg)
    assert u.shape == (4, cfg.embed_dim)
    _close(u, RR.bert4rec_user_embedding(rp, jnp.asarray(ids), rcfg))


def test_bert4rec_sampled_loss():
    rp, p, rcfg, cfg = _params("bert4rec", "init_bert4rec")
    b = _seq_batch(cfg)
    got = R.bert4rec_sampled_loss(p, b["item_ids"], b["mask_pos"],
                                  b["pos_items"], b["neg_items"], cfg)
    want = RR.bert4rec_sampled_loss(
        rp, *(jnp.asarray(b[k]) for k in ("item_ids", "mask_pos",
                                          "pos_items", "neg_items")), rcfg)
    _close(got[0], want[0])
    _close(got[1]["accuracy"], want[1]["accuracy"])


def test_mind_interests_and_loss():
    rp, p, rcfg, cfg = _params("mind", "init_mind")
    rng = np.random.default_rng(9)
    hist = rng.integers(0, cfg.vocab_size, (5, cfg.hist_len)).astype(
        np.int32)
    pos = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    neg = rng.integers(0, cfg.vocab_size, (5, 11)).astype(np.int32)
    got = R.mind_interests(p, hist, cfg)
    assert got.shape == (5, cfg.n_interests, cfg.embed_dim)
    _close(got, RR.mind_interests(rp, jnp.asarray(hist), rcfg))
    lg = R.mind_sampled_loss(p, hist, pos, neg, cfg)
    lw = RR.mind_sampled_loss(rp, jnp.asarray(hist), jnp.asarray(pos),
                              jnp.asarray(neg), rcfg)
    _close(lg[0], lw[0])
    _close(lg[1]["accuracy"], lw[1]["accuracy"])


def test_squash():
    z = np.random.default_rng(10).standard_normal((3, 4, 8)).astype(
        np.float32)
    _close(R._squash(torch.from_numpy(z)), RR._squash(jnp.asarray(z)))


# ---------------------------------------------------------- score heads
@pytest.mark.parametrize("k", [1, 100])
def test_score_all_items(k):
    """Values within 2^-8; ids equal at every rank except where the two
    packages' bf16 scores of the ids at that rank differ."""
    rng = np.random.default_rng(11)
    user = rng.standard_normal((8, 64)).astype(np.float32)
    items = (0.02 * rng.standard_normal((4096, 64))).astype(np.float32)
    items[100:110] = items[7]            # exact ties: lowest id first
    gv, gi = R.score_all_items(torch.from_numpy(user),
                               torch.from_numpy(items), k)
    wv, wi = RR.score_all_items(jnp.asarray(user), jnp.asarray(items), k,
                                RR.LOCAL_CTX)
    assert gv.dtype == torch.bfloat16 and gi.dtype == torch.int32
    np.testing.assert_allclose(_np(gv), _np(wv), rtol=SCORE_REL, atol=0)
    gi, wi = gi.numpy(), np.asarray(wi)
    port = (torch.from_numpy(user).to(torch.bfloat16)
            @ torch.from_numpy(items).to(torch.bfloat16).T).float().numpy()
    ref = np.asarray(jnp.einsum("bd,vd->bv", jnp.asarray(user, jnp.bfloat16),
                                jnp.asarray(items, jnp.bfloat16)).astype(
                                    jnp.float32))
    rows, ranks = np.nonzero(gi != wi)
    for b, r in zip(rows, ranks):
        pair = [gi[b, r], wi[b, r]]
        assert np.any(port[b, pair] != ref[b, pair]), (b, r)
    # ties among the port's own scores come in ascending id
    vals = _np(gv)
    for b in range(len(gi)):
        tie = vals[b, 1:] == vals[b, :-1]
        assert np.all(gi[b, 1:][tie] > gi[b, :-1][tie])


def test_score_ties_go_to_the_lowest_id():
    user = torch.ones(2, 4)
    items = torch.ones(1000, 4)
    items[500:] *= 2
    v, i = R.score_all_items(user, items, 10)
    assert i.tolist() == [list(range(500, 510))] * 2


# ------------------------------------------------------- item retrieval
@pytest.fixture(scope="module")
def item_pair(tmp_path_factory):
    """``examples/recsys_retrieval.py``'s index at a small size: items as
    L2 over [v, sqrt(phi - |v|^2)], built by the JAX package and loaded
    into the port, and user queries zero-padded.  The lists nearest a
    MIPS query hold few rows, so at top_m 2 some answers are short."""
    import dataclasses

    from repro.configs.anns_datasets import SIFT_SMALL
    from repro.core.engine import FusionANNSIndex as RefIndex
    from repro_torch.core.engine import FusionANNSIndex
    rng = np.random.default_rng(21)
    items = (0.02 * rng.standard_normal((3000, 15))).astype(np.float32)
    norms = np.sum(items ** 2, axis=1)
    aug = np.concatenate([items, np.sqrt(norms.max() - norms)[:, None]],
                         axis=1)
    queries = np.pad(rng.standard_normal((32, 15)).astype(np.float32),
                     ((0, 0), (0, 1)))
    cfg = dataclasses.replace(SIFT_SMALL, n_vectors=len(aug), dim=16,
                              pq_m=4, n_posting_fraction=0.3, top_m=2)
    ref = RefIndex.build(aug, cfg)
    path = str(tmp_path_factory.mktemp("items"))
    ref.save_snapshot(path)
    return ref, FusionANNSIndex.load_snapshot(path, device="cpu"), queries


@pytest.mark.parametrize("plan", [{}, {"fused": True},
                                  {"fused": True, "lut_int8": True}],
                         ids=["dense", "fused", "fused_int8"])
def test_item_index_short_answers_match_reference(item_pair, plan):
    """A query whose top_m lists hold fewer than k rows gets every one of
    them, ranked, and no more, in both packages alike."""
    ref, port, queries = item_pair
    want = ref.submit(queries, **plan).results()
    got = port.submit(queries, **plan).results()
    short = 0
    for q, r, p in zip(queries, want, got):
        np.testing.assert_array_equal(p.ids, r.ids)
        np.testing.assert_array_equal(p.dists, r.dists)
        if len(p.ids) < ref.cfg.top_k:
            short += 1
            assert len(p.ids) == len(port.candidate_ids(q, ref.cfg.top_m))
    assert short > 0


# ------------------------------------------------------------------ mesh
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("entry", ["dlrm", "wide_deep", "bert4rec", "mind",
                                   "score"])
def test_mesh_ctx_matches_one_device(entry, mesh):
    """Each forward on a mesh of logical CPU devices is the one-device
    forward bit for bit (the reference's sharding constraints change no
    value) and the reference's one-device forward within RTOL;
    ``score_all_items`` on a mesh (the two-level top-k over the item
    shards) gives the one-device ids and values, ties to the lowest id."""
    shape = MESHES[mesh]
    m = Mesh(np.arange(4).reshape(shape), ("data", "model"), ["cpu"] * 4)
    ctx = ShardCtx(mesh=m, rules=rules_for_mesh(m))
    arch, init = {"dlrm": ("dlrm-rm2", "init_dlrm"),
                  "wide_deep": ("wide-deep", "init_wide_deep"),
                  "bert4rec": ("bert4rec", "init_bert4rec"),
                  "mind": ("mind", "init_mind"),
                  "score": ("bert4rec", "init_bert4rec")}[entry]
    rp, p, rcfg, cfg = _params(arch, init)
    rng = np.random.default_rng(11)
    if entry in ("dlrm", "wide_deep"):
        ids = rng.integers(0, cfg.vocab_size,
                           (4, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
        dense = rng.standard_normal((4, cfg.n_dense)).astype(np.float32)
        if entry == "dlrm":
            run = lambda c: R.dlrm_forward(p, torch.from_numpy(dense), ids,  # noqa: E731
                                           cfg, c)
            want = RR.dlrm_forward(rp, jnp.asarray(dense), jnp.asarray(ids),
                                   rcfg)
        else:
            run = lambda c: R.wide_deep_forward(p, ids, cfg, c)  # noqa: E731
            want = RR.wide_deep_forward(rp, jnp.asarray(ids), rcfg)
    elif entry == "bert4rec":
        ids = rng.integers(0, cfg.vocab_size, (4, cfg.seq_len)).astype(
            np.int32)
        run = lambda c: R.bert4rec_encode(p, ids, cfg, c)  # noqa: E731
        want = RR.bert4rec_encode(rp, jnp.asarray(ids), rcfg)
    elif entry == "mind":
        ids = rng.integers(0, cfg.vocab_size, (4, cfg.hist_len)).astype(
            np.int32)
        run = lambda c: R.mind_interests(p, ids, cfg, c)  # noqa: E731
        want = RR.mind_interests(rp, jnp.asarray(ids), rcfg)
    else:
        user = rng.integers(-3, 4, (4, 8)).astype(np.float32)
        items = rng.integers(-3, 4, (64, 8)).astype(np.float32)
        items[[15, 16, 47, 48]] = items[0]          # ties across shards
        got = R.score_all_items(torch.from_numpy(user),
                                torch.from_numpy(items), 10, ctx)
        one = R.score_all_items(torch.from_numpy(user),
                                torch.from_numpy(items), 10)
        wv, wi = RR.score_all_items(jnp.asarray(user), jnp.asarray(items),
                                    10, RR.LOCAL_CTX)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(wi))
        return
    got = run(ctx)
    assert torch.equal(got, run(LOCAL_CTX))
    _close(got, want)


def test_init_shapes_match_the_reference():
    """The port's ``init_*`` draw trees of the reference's structure,
    shapes and dtypes (other numbers: the generators differ)."""
    for arch, init in (("dlrm-rm2", "init_dlrm"),
                       ("wide-deep", "init_wide_deep"),
                       ("bert4rec", "init_bert4rec"), ("mind", "init_mind")):
        rp, _, _, cfg = _params(arch, init)
        p = getattr(R, init)(torch.Generator().manual_seed(0), cfg, "cpu")
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), p)
        want = jax.tree.map(lambda a: (tuple(a.shape), "torch.float32"),
                            rp)
        assert got == want, arch
