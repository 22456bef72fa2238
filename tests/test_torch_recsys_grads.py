"""Gradients of the port's recsys and GNN losses against ``jax.grad`` of
the JAX package's, on the CPU, at the reduced configs in f32, on the
reference's params carried across (``transformer.params_from_numpy``)
and numpy-seeded batches.

Tolerances:

* ``layers.gather_rows``' gradient: the reference's scatter-add (the VJP
  of ``jnp.take``) bit for bit, in f32 and with the rows rounded to bf16,
  on repeated ids in any order: both add each id's rows one at a time in
  the order the ids come, each sum rounded to the gathered dtype.
* The bf16 gather of DLRM-RM2 and Wide&Deep from B = 16,384 on
  (``BULK_GATHER_BATCH``) over the reduced 512-row tables, where ids
  repeat ~190 times a row: ``embedding_bag_dense``'s VJP on a given bf16
  cotangent bit for bit against the reference's (the sums in bf16; summed
  in f32 and rounded once they differ, which the test also shows).
* Each loss's gradient leaf within 1e-5 relative L2 of the reference's
  (the same f32 function summed in another order), except the tables of
  a bf16 gather, within 2^-8 (each table row's cotangent rounds to bf16
  before it is summed in bf16; an f32 cotangent 1e-7 off on the two sides
  may round the other way, moving that term by one bf16 step, 2^-8 of
  it), and the loss within 1e-5 relative.
* ``train.loop.microbatch_grads``: BERT4Rec's gradient in 4 microbatches
  within 1e-6 relative L2 of the one-batch gradient (four means averaged
  against one mean, in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.data import graphs as RGr
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.data import graphs as Gr
from repro_torch.data import synthetic as S
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.loop import microbatch_grads, value_and_grad

GRAD_REL = 1e-5
BF16_TABLE_REL = 2.0 ** -8
MICRO_REL = 1e-6
BULK = R.BULK_GATHER_BATCH


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _params(arch: str, init: str, mod=RR):
    rcfg = ref_config(arch, reduced=True)
    rp = getattr(mod, init)(jax.random.key(0), rcfg)
    return rp, T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu"), \
        rcfg, get_config(arch, reduced=True)


def _check_grads(got, want, loss, want_loss, bf16_tables=False):
    assert float(loss) == pytest.approx(float(want_loss), rel=GRAD_REL)
    wl = dict((jax.tree_util.keystr(p), x) for p, x in
              jax.tree_util.tree_flatten_with_path(want)[0])
    gl = dict(tree.keyed_leaves(got))
    assert gl.keys() == wl.keys()
    for key, w in wl.items():
        assert gl[key].dtype == torch.float32, key
        lim = (BF16_TABLE_REL if bf16_tables and key == "['tables']"
               else GRAD_REL)
        assert _rel(gl[key], w) <= lim, key


# ----------------------------------------------------------- gather_rows
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_gather_rows_grad_is_the_reference_scatter_add(dtype):
    """Repeated ids in no order (2-D), some rows never taken."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((9, 5)).astype(np.float32)
    ids = rng.integers(0, 7, (40, 30))
    jd = jnp.bfloat16 if dtype else jnp.float32
    td = torch.bfloat16 if dtype else None
    cot = rng.standard_normal((40, 30, 5)).astype(np.float32)

    def f(t):
        return jnp.take(t.astype(jd), jnp.asarray(ids), axis=0)
    rows, vjp = jax.vjp(f, jnp.asarray(table))
    want = vjp(jnp.asarray(cot).astype(jd))[0]
    t = torch.from_numpy(table).requires_grad_()
    got = L.gather_rows(t, torch.from_numpy(ids), td)
    np.testing.assert_array_equal(_np(got), _np(rows))
    got.backward(torch.from_numpy(cot).to(got.dtype))
    assert t.grad.dtype == torch.float32
    np.testing.assert_array_equal(t.grad.numpy(), _np(want))
    assert not t.grad[7:].any()


def test_gather_rows_without_grad_is_the_gather():
    """Without grad it is the gather alone, in the asked dtype."""
    table = torch.arange(12.0).reshape(4, 3)
    ids = torch.tensor([3, 0, 3])
    with torch.no_grad():
        out = L.gather_rows(table, ids, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), table[ids])


# ------------------------------------------------------ the bf16 gather
@pytest.mark.parametrize("arch", ["dlrm-rm2", "wide-deep"])
def test_bf16_gather_grad_sums_in_bf16(arch):
    """``embedding_bag_dense`` at B = 16,384 over the reduced tables (512
    rows, ~190 ids a row a table): the reference's VJP on one bf16
    cotangent, bit for bit; f32 sums rounded once differ."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(1)
    tables = (0.05 * rng.standard_normal(
        (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim))).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (BULK, cfg.n_sparse,
                                           cfg.multi_hot)).astype(np.int32)
    cot = rng.standard_normal((BULK, cfg.n_sparse, cfg.embed_dim))

    def f(t):
        return RR.embedding_bag_dense(t, jnp.asarray(ids),
                                      gather_dtype=jnp.bfloat16)
    _, vjp = jax.vjp(f, jnp.asarray(tables))
    cot16 = jnp.asarray(cot, jnp.float32).astype(jnp.bfloat16)
    want = _np(vjp(cot16)[0])
    t = torch.from_numpy(tables).requires_grad_()
    out = R.embedding_bag_dense(t, ids, gather_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(_np(cot16)).to(torch.bfloat16))
    np.testing.assert_array_equal(t.grad.numpy(), want)
    # the same cotangent summed in f32 and rounded once is another function
    flat = (ids[..., 0] + cfg.vocab_size * np.arange(cfg.n_sparse)).ravel()
    f32 = torch.zeros(cfg.n_sparse * cfg.vocab_size, cfg.embed_dim)
    f32.index_add_(0, torch.from_numpy(flat),
                   torch.from_numpy(_np(cot16)).reshape(-1, cfg.embed_dim))
    once = f32.to(torch.bfloat16).float().reshape(t.shape).numpy()
    assert not np.array_equal(once, want)


# --------------------------------------------------------------- losses
def _dlrm_case(batch):
    rp, p, rcfg, cfg = _params("dlrm-rm2", "init_dlrm")
    b = S.recsys_dlrm_batch(np.random.default_rng(2), batch, cfg.n_dense,
                            cfg.n_sparse, cfg.vocab_size, cfg.multi_hot)

    def ref(q):
        return RR.bce_loss(RR.dlrm_forward(q, jnp.asarray(b["dense"]),
                                           jnp.asarray(b["sparse_ids"]),
                                           rcfg), jnp.asarray(b["labels"]))

    def port(q, bb):
        return R.bce_loss(R.dlrm_forward(q, bb["dense"], bb["sparse_ids"],
                                         cfg), bb["labels"])
    return rp, p, b, ref, port


def _wide_deep_case(batch):
    rp, p, rcfg, cfg = _params("wide-deep", "init_wide_deep")
    b = S.recsys_sparse_batch(np.random.default_rng(3), batch, cfg.n_sparse,
                              cfg.vocab_size, cfg.multi_hot)

    def ref(q):
        return RR.bce_loss(RR.wide_deep_forward(
            q, jnp.asarray(b["sparse_ids"]), rcfg),
            jnp.asarray(b["labels"]))

    def port(q, bb):
        return R.bce_loss(R.wide_deep_forward(q, bb["sparse_ids"], cfg),
                          bb["labels"])
    return rp, p, b, ref, port


def _bert4rec_case(batch=8):
    rp, p, rcfg, cfg = _params("bert4rec", "init_bert4rec")
    b = S.recsys_seq_batch(np.random.default_rng(4), batch, cfg.seq_len,
                           cfg.vocab_size)

    def ref(q):
        return RR.bert4rec_sampled_loss(
            q, *(jnp.asarray(b[k]) for k in ("item_ids", "mask_pos",
                                              "pos_items", "neg_items")),
            rcfg)

    def port(q, bb):
        return R.bert4rec_sampled_loss(
            q, bb["item_ids"], bb["mask_pos"], bb["pos_items"],
            bb["neg_items"], cfg)
    return rp, p, b, ref, port


def _mind_case(batch=8):
    rp, p, rcfg, cfg = _params("mind", "init_mind")
    b = S.recsys_seq_batch(np.random.default_rng(5), batch, cfg.hist_len,
                           cfg.vocab_size)

    def ref(q):
        return RR.mind_sampled_loss(
            q, *(jnp.asarray(b[k]) for k in ("item_ids", "pos_items",
                                              "neg_items")), rcfg)

    def port(q, bb):
        return R.mind_sampled_loss(q, bb["item_ids"], bb["pos_items"],
                                   bb["neg_items"], cfg)
    return rp, p, b, ref, port


def _sage_case(mode):
    rcfg = ref_config("graphsage-reddit", reduced=True)
    cfg = get_config("graphsage-reddit", reduced=True)
    n_classes = 2 if mode == "batched" else cfg.n_classes
    rp = RG.init_sage(jax.random.key(0), rcfg, n_classes=n_classes)
    p = T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(6)
    if mode == "full":
        g = Gr.random_graph(rng, 60, 400, cfg.d_feat, cfg.n_classes)
        mask = (np.arange(60) % 3 != 0).astype(np.float32)
        b = {"features": g["features"], "edges": g["edges"],
             "labels": g["labels"], "mask": mask}

        def ref(q):
            lg = RG.sage_forward_full(q, jnp.asarray(b["features"]),
                                      jnp.asarray(b["edges"]), rcfg)
            return RG.sage_loss(lg, jnp.asarray(b["labels"]),
                                jnp.asarray(b["mask"]))

        def port(q, bb):
            lg = G.sage_forward_full(q, bb["features"], bb["edges"], cfg)
            return G.sage_loss(lg, bb["labels"], bb["mask"])
    elif mode == "minibatch":
        g = Gr.random_graph(rng, 200, 1500, cfg.d_feat, cfg.n_classes)
        indptr, idx = Gr.build_csr(g["edges"], 200)
        nodes = np.arange(16)
        f0, f1, f2 = Gr.sample_two_hop(rng, indptr, idx, nodes,
                                       cfg.sample_sizes, g["features"])
        b = {"feats0": f0, "feats1": f1, "feats2": f2,
             "labels": g["labels"][nodes]}

        def ref(q):
            lg = RG.sage_forward_minibatch(
                q, *(jnp.asarray(b[k]) for k in ("feats0", "feats1",
                                                  "feats2")), rcfg)
            return RG.sage_loss(lg, jnp.asarray(b["labels"]))

        def port(q, bb):
            lg = G.sage_forward_minibatch(q, bb["feats0"], bb["feats1"],
                                          bb["feats2"], cfg)
            return G.sage_loss(lg, bb["labels"])
    else:
        b = RGr.block_diagonal_batch(rng, 8, 30, 64, cfg.d_feat, 2)

        def ref(q):
            lg = RG.sage_forward_batched(
                q, jnp.asarray(b["features"]), jnp.asarray(b["edges"]),
                jnp.asarray(b["graph_ids"]), 8, rcfg)
            return RG.sage_loss(lg, jnp.asarray(b["labels"]))

        def port(q, bb):
            lg = G.sage_forward_batched(q, bb["features"], bb["edges"],
                                        bb["graph_ids"], 8, cfg)
            return G.sage_loss(lg, bb["labels"])
    return rp, p, b, ref, port


CASES = {
    "dlrm": lambda: _dlrm_case(8),
    f"dlrm-B{BULK}": lambda: _dlrm_case(BULK),
    "wide_deep": lambda: _wide_deep_case(8),
    f"wide_deep-B{BULK}": lambda: _wide_deep_case(BULK),
    "bert4rec": _bert4rec_case,
    "mind": _mind_case,
    "sage-full": lambda: _sage_case("full"),
    "sage-minibatch": lambda: _sage_case("minibatch"),
    "sage-batched": lambda: _sage_case("batched"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_grads_match_jax_grad(case):
    rp, p, b, ref, port = CASES[case]()
    (want_loss, _), want = jax.jit(jax.value_and_grad(ref, has_aux=True))(rp)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    got, m = value_and_grad(port, p, batch)
    _check_grads(got, want, m["loss"], want_loss,
                 bf16_tables=case.endswith(f"B{BULK}"))


def test_microbatch_grads_match_one_batch():
    _, p, b, _, port = _bert4rec_case(batch=16)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    one, m1 = microbatch_grads(port, p, batch, 1)
    four, m4 = microbatch_grads(port, p, batch, 4)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for (key, g), w in zip(tree.keyed_leaves(four), tree.leaves(one)):
        assert _rel(g, w) <= MICRO_REL, key
