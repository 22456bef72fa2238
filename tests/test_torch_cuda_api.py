"""The recsys and GNN train cells of ``repro_torch.models.api`` on the
card: a reduced train step of each arch against the same step on the
CPU, two runs bit for bit, and BERT4Rec's flash launches in a step.
Marked ``gpu``: without a CUDA device they skip (a CUDA kernel has no CPU
mode).  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_api.py

Tolerances: the loss and metrics within 1e-5 relative (the same f32
function summed in another order, f32 products with TF32 off on both
sides, flash in 3xTF32 against the plain scan); AdamW's moments (the
gradients) within 1e-4 relative L2 a leaf, except the tables of a bf16
gather (B >= 16,384), within 2^-8 (a row's cotangent rounds to bf16
before its bf16 sum: an f32 cotangent a rounding off may round the other
way); the updated params within rtol 1e-5 / atol 1e-9 plus lr times the
difference of the two steps' normalised updates m^ / (sqrt(v^) + eps)
(AdamW's first update is ~lr sign(g)); two runs on the card bit for bit
(every sum in a fixed order: ``layers.gather_rows``, ``segment_reduce``,
the backward kernel).
"""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import flash_bwd_plan, flash_plan
from repro_torch.models import api as A
from repro_torch.optim.adamw import cosine_lr
from repro_torch.train.loop import TrainConfig, make_train_step

REL = 1e-5
MOMENT_REL = 1e-4
BF16_TABLE_REL = 2.0 ** -8
BULK = 16384
CELLS = [("bert4rec", "train_batch", None), ("mind", "train_batch", None),
         ("dlrm-rm2", "train_batch", None), ("wide-deep", "train_batch", None),
         ("dlrm-rm2", "train_batch", BULK), ("wide-deep", "train_batch", BULK),
         ("graphsage-reddit", "full_graph_sm", None),
         ("graphsage-reddit", "minibatch_lg", None),
         ("graphsage-reddit", "ogb_products", None),
         ("graphsage-reddit", "molecule", None)]
IDS = [f"{a}-{s}" + (f"-B{b}" if b else "") for a, s, b in CELLS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _cell(arch, shape, batch):
    return A.build_cell(arch, shape, reduced=True,
                        dim_overrides={"batch": batch} if batch else None)


def _to(t, dev):
    return tree.tree_map(lambda x: x.to(dev), t)


def _rel(got, want) -> float:
    g, w = got.double().cpu(), want.double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _update(leaves, tail: str) -> torch.Tensor:
    o = A.OPT
    m = leaves["['opt']['m']" + tail].double().cpu() / (1 - o.b1)
    v = leaves["['opt']['v']" + tail].double().cpu() / (1 - o.b2)
    return m / (v.sqrt() + o.eps)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,batch", CELLS, ids=IDS)
def test_cuda_train_step_matches_cpu(cuda, arch, shape, batch):
    cell = _cell(arch, shape, batch)
    state, data = A.realize(cell, seed=1, device="cpu")
    if arch in ("bert4rec", "mind"):          # ids over the whole table
        rng = np.random.default_rng(2)
        for k in data:
            if k != "mask_pos":
                hi = cell.args[0]["params"]["item_embed"].shape[0]
                data[k] = torch.from_numpy(rng.integers(
                    0, hi, tuple(data[k].shape))).int()
    want_state, wm = cell.fn(state, data)
    launch.reset_launches()
    got_state, gm = cell.fn(_to(state, cuda), _to(data, cuda))
    torch.cuda.synchronize()
    for k in wm:
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=REL), k
    gl, wl = dict(tree.keyed_leaves(got_state)), dict(tree.keyed_leaves(
        want_state))
    lr = float(cosine_lr(1, A.OPT))
    for key, w in wl.items():
        g = gl[key]
        assert g.device.type == "cuda" and g.dtype == w.dtype, key
        if key.startswith("['opt']['m']") or key.startswith("['opt']['v']"):
            lim = (BF16_TABLE_REL if batch and key.endswith("['tables']")
                   else MOMENT_REL)
            assert _rel(g, w) <= lim, key
        elif key.startswith("['params']"):
            tail = key[len("['params']"):]
            du = (_update(gl, tail) - _update(wl, tail)).abs()
            err = (g.cpu().double() - w.double()).abs()
            assert bool((err <= REL * w.double().abs() + 1e-9
                         + lr * du * (1 + 1e-3)).all()), key


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,batch", CELLS, ids=IDS)
def test_cuda_train_step_repeats_bit_for_bit(cuda, arch, shape, batch):
    cell = _cell(arch, shape, batch)
    state, data = A.realize(cell, seed=2, device=cuda)
    one, m1 = cell.fn(state, data)
    two, m2 = cell.fn(state, data)
    for (key, a), b in zip(tree.keyed_leaves(one), tree.leaves(two)):
        assert torch.equal(a, b), key
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


@pytest.mark.gpu
def test_cuda_bert4rec_step_launches(cuda):
    """A BERT4Rec step in two microbatches launches the f32 forward with
    its lse once a block a microbatch and the backward kernel (its narrow
    instance) once a block a microbatch, and no other flash key."""
    cell = _cell("bert4rec", "train_batch", 8)
    state, data = A.realize(cell, device=cuda)
    step = make_train_step(cell.loss_fn, TrainConfig(microbatches=2))
    launch.reset_launches()
    step(state, data)
    torch.cuda.synchronize()
    dh = cell.args[0]["params"]["blocks"][0]["wqkv"].shape[0] // 2
    n = 2 * len(cell.args[0]["params"]["blocks"])
    t = data["item_ids"].shape[1]
    bwd = flash_bwd_plan(torch.float32, dh, None, t).key
    assert bwd == "flash_attn_bwd[32]"          # dh 32 over <= 256 keys
    assert {k: c for k, c in launch.LAUNCHES.items()
            if c and k.startswith("flash")} == {
        flash_plan(torch.float32, dh).key: n, bwd: n}
