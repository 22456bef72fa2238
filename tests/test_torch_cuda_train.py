"""The training half of the flash kernels on the card: the backward
kernel (``flash_attn_bwd``) against its plain version
``flash_attn_bwd_ref``, the logsumexp the forward kernels write against
the plain forward's, and the models' attention VJP and ``lm_loss``
gradients on the card against the CPU.  Marked ``gpu``: without a CUDA
device they skip (a CUDA kernel has no CPU mode).  This file imports no
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_train.py

Tolerances: the backward's dQ, dK and dV within 1e-4 relative L2 (L2
error over L2 norm) of the plain backward in f32 (the same f32 operations
summed in another order, on bf16 terms of the operands on the tensor
cores against cuBLAS with TF32 off)
and, for bf16 inputs (both sides convert to f32, compute, and round the
gradients to bf16 once), within 2^-7 (a rounding that falls on the other
side moves an element by at most 2^-8 of it); two runs bit for bit (no
atomics); lse within 1e-5 relative of the plain forward's (against at
least 1: the first causal row's lse is its one scaled score, which may lie
near 0 and has no relative scale); the models'
attention VJP on the card within 1e-4 (f32) and 2^-5 (bf16: the card's
forward rounds P to bf16) of the CPU's; a reduced
LM's gradients on the card within 1e-4 relative L2 of the CPU's (f32,
full f32 products on both), the dense arch's and both MoE archs' (the
same expert choices on both sides; DeepSeek-V2-Lite's MLA through the
backward's ``[dv]`` keys, v narrower than q and k).
"""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import (BWD_BF16_DV_KEY, BWD_BF16_KEY,
                                            BWD_DV_KEY, BWD_KEY,
                                            BWD_NARROW_KEY, flash_attention,
                                            flash_attention_bwd,
                                            flash_attn_bwd_ref,
                                            flash_attn_ref, flash_bwd_plan,
                                            flash_bwd_width, flash_plan)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.loop import value_and_grad

REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# the models' VJP on the card against the CPU's: in bf16 the card's forward
# rounds P to bf16 before P V (2^-8 of a row's weight), so O and D =
# rowsum(dO O) differ from the CPU's by that much, and dS = P (dP - D)
# takes a difference of such terms
VJP_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
LSE_REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _inputs(dev, b, s, t, h, hk, dh, dtype, seed=0, dv=None):
    """q, k (dh wide), v and dO (dv wide, dh when None) from ``seed``."""
    dv = dh if dv is None else dv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, dh, generator=g, device=dev)
    k = torch.randn(b, t, hk, dh, generator=g, device=dev)
    v = torch.randn(b, t, hk, dv, generator=g, device=dev)
    do = torch.randn(b, s, h, dv, generator=g, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v, do))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,hk,dh,dv", [
    (1, 128, 128, 4, 2, 64, 64),
    (2, 200, 200, 4, 4, 128, 128),     # ragged tiles, MHA
    (1, 96, 320, 8, 2, 128, 128),      # S != T
    (1, 257, 257, 6, 1, 96, 96),       # MQA, dh padded to the 128 tile
    (2, 70, 70, 2, 1, 36, 36),         # dh 36 on the 64 tile
    (1, 64, 64, 2, 2, 6, 6),           # dh off the f32 stride: padded to 8
    (1, 150, 150, 4, 2, 100, 100),     # dh off the bf16 stride: to 104
    (1, 64, 64, 2, 1, 8, 8),           # the narrowest width on the stride
    (1, 1000, 1000, 8, 1, 128, 128),   # G = 8: dK, dV over eight heads
    (1, 300, 200, 4, 4, 192, 128),     # MLA's (192, 128), G = 1, S != T
    (1, 200, 330, 2, 2, 192, 128),     # the same, T > S, ragged
    (2, 130, 130, 4, 4, 48, 32),       # the reduced DeepSeek's, on 64
    (1, 150, 150, 4, 2, 136, 96),      # padded within (192, 128)
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_bwd_matches_plain(cuda, b, s, t, h, hk, dh, dv, causal,
                                      dtype):
    q, k, v, do = _inputs(cuda, b, s, t, h, hk, dh, dtype, dv=dv)
    out, lse = flash_attn_ref(q, k, v, causal=causal, return_lse=True)
    key = {(torch.float32, True): BWD_KEY,
           (torch.bfloat16, True): BWD_BF16_KEY,
           (torch.float32, False): BWD_DV_KEY,
           (torch.bfloat16, False): BWD_BF16_DV_KEY}[dtype, dv == dh]
    if dtype == torch.float32 and dh <= 32 and t <= 256:
        key = BWD_NARROW_KEY                 # f32 at q/k <= 32, T <= 256
    assert flash_bwd_plan(dtype, dh, dv, t).key == key   # its instance
    launch.reset_launches()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert {n: c for n, c in launch.LAUNCHES.items() if c} == {key: 1}
    want = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=causal,
                              block_size=t)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= REL[dtype], (name, _rel(g, w))
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for g, a in zip(got, again):
        assert torch.equal(g, a)                       # bit for bit


# the narrow instance against the plain version evaluated in f64: G 1 and
# 2, S != T, causal, dh 8, 20 (padded to 24) and 32, v narrower, T at the
# resident limit 256, and a batch at which every block of the persistent
# grid takes several (batch, KV head) units; T = 257 keeps (64, 64)
NARROW_CASES = [
    (2, 200, 200, 2, 2, 32, 32),       # BERT4Rec's row, G = 1
    (2, 200, 200, 4, 2, 32, 32),       # G = 2
    (3, 200, 160, 2, 2, 32, 32),       # S != T
    (3, 160, 200, 4, 1, 32, 32),       # T > S, G = 4
    (2, 64, 64, 2, 2, 8, 8),
    (2, 100, 90, 2, 1, 20, 20),
    (2, 300, 200, 2, 2, 32, 16),       # v narrower
    (2, 256, 256, 2, 2, 32, 32),
    (2, 257, 257, 2, 2, 32, 32),       # past the resident keys: (64, 64)
    (700, 200, 200, 2, 2, 32, 32),     # 1,400 units: ~10 a block
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,hk,dh,dv", NARROW_CASES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_bwd_narrow_matches_f64(cuda, b, s, t, h, hk, dh, dv,
                                           causal):
    """f32 at q/k <= 32 over at most 256 keys: one launch of
    ``flash_attn_bwd[32]``, dq, dk and dv within ``REL`` (1e-4, the
    smoke's ``BWD_RTOL``) of ``flash_attn_bwd_ref`` in f64, two runs bit
    for bit; at 257 keys the (64, 64) instance under ``flash_attn_bwd``."""
    q, k, v, do = _inputs(cuda, b, s, t, h, hk, dh, torch.float32, dv=dv)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    key = BWD_NARROW_KEY if t <= 256 else (BWD_KEY if dv == dh
                                           else BWD_DV_KEY)
    assert flash_bwd_plan(torch.float32, dh, dv, t).key == key
    launch.reset_launches()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert {n: c for n, c in launch.LAUNCHES.items() if c} == {key: 1}
    want = flash_attn_bwd_ref(q, k, v, out, lse, do, causal=causal,
                              block_size=t, compute=torch.float64)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert _rel(g, w) <= REL[torch.float32], (name, _rel(g, w))
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for g, a in zip(got, again):
        assert torch.equal(g, a)                       # bit for bit


@pytest.mark.gpu
def test_cuda_flash_bwd_narrow_reads_split_views(cuda, monkeypatch):
    """q, k and v split from one (B, S, 3H, 32) tensor, as BERT4Rec's
    encode hands them over, reach the narrow instance as they lie: no
    operand of the five is copied, and the gradients are the ones of
    contiguous copies bit for bit."""
    from repro_torch.kernels.flash_attn import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(3, 200, 6, 32, generator=g, device=cuda)
    q, k, v = torch.split(qkv, 2, dim=2)
    do = torch.randn(3, 200, 2, 32, generator=g, device=cuda)
    out, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    copied = []
    real = ops.operand

    def spy(name, *args):
        copied.append(name)
        return real(name, *args)
    monkeypatch.setattr(ops, "operand", spy)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    assert copied == ["lse"], copied
    want = flash_attention_bwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), out, lse, do, causal=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,dv", [
    (torch.float32, 64, 64), (torch.float32, 128, 128),
    (torch.float32, 192, 128), (torch.float32, 256, 256),
    (torch.bfloat16, 64, 64), (torch.bfloat16, 128, 128),
    (torch.bfloat16, 192, 128), (torch.bfloat16, 256, 256),
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_forward_lse_matches_plain(cuda, dtype, dh, dv, causal):
    """Every epilogue that writes lse: the f32 keys-split and 256
    kernels, the bf16 pipelined and serial loops; the output is the one
    the kernel gives without lse."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 333, 8, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 333, 4, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 333, 4, dv, generator=g, device=cuda).to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    _, want = flash_attn_ref(q, k, v, causal=causal, return_lse=True)
    assert lse.shape == (2, 8, 333) and lse.dtype == torch.float32
    assert float(((lse - want).abs() / want.abs().clamp_min(1)).max()) \
        <= LSE_REL
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    assert flash_plan(dtype, dh, dv).key in launch.LAUNCHES


@pytest.mark.gpu
def test_cuda_flash_bwd_rejects_shapes_it_lacks(cuda):
    """The backward takes q/k up to 192 wide with v up to 128 (or v up to
    q/k's width up to 128): (192, 192), (256, 256), a v wider than q and
    a query offset raise ``ValueError`` naming the shape, the models'
    attention in its forward, before any launch."""
    q, k, v, do = _inputs(cuda, 1, 64, 64, 2, 2, 192, torch.float32)
    out, lse = flash_attn_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match=r"\(192, 192\)"):
        flash_attention_bwd(q, k, v, out, lse, do)
    q2, k2, v2, do2 = _inputs(cuda, 1, 64, 64, 2, 2, 256, torch.float32)
    out2, lse2 = flash_attn_ref(q2, k2, v2, return_lse=True)
    with pytest.raises(ValueError, match="head width 256"):
        flash_attention_bwd(q2, k2, v2, out2, lse2, do2)
    qn, kn = q[..., :64], k[..., :64]                    # v wider than q
    out3, lse3 = flash_attn_ref(qn, kn, v[..., :96], return_lse=True)
    with pytest.raises(ValueError, match="v width 96"):
        flash_attention_bwd(qn, kn, v[..., :96], out3, lse3, do[..., :96])
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_bwd(qn, kn, kn, out3[..., :64], lse3, do[..., :64],
                            q_offset=8)
    # the models' attention raises in the forward, before any launch
    launch.reset_launches()
    for a, b, c in ((q, k, v), (q2, k2, v2)):
        with pytest.raises(ValueError, match="head width 256|192, 192"):
            L.blockwise_attention(a.clone().requires_grad_(), b, c)
    assert not any(launch.LAUNCHES.values())
    for dtype in (torch.float32, torch.bfloat16):
        for dh, dv in ((192, 192), (256, 256), (64, 96)):
            with pytest.raises(ValueError):
                flash_bwd_plan(dtype, dh, dv)
        with pytest.raises(ValueError):
            flash_bwd_width(193, 128)


@pytest.mark.gpu
def test_cuda_serving_forward_writes_no_lse_and_no_backward(cuda,
                                                            monkeypatch):
    from repro_torch.kernels.flash_attn import ops
    calls = []
    real = ops.launch

    def spy(name, dev, *args):
        calls.append((name, args[4]))          # the lse pointer
        return real(name, dev, *args)
    monkeypatch.setattr(ops, "launch", spy)
    q, k, v, _ = _inputs(cuda, 1, 128, 128, 4, 2, 128, torch.float32)
    q.requires_grad_()
    launch.reset_launches()
    with torch.no_grad():
        L.blockwise_attention(q, k, v)
    L.blockwise_attention(q.detach(), k, v)
    torch.cuda.synchronize()
    assert calls == [("flash_attn_fwd_tf32", 0)] * 2
    assert {n: c for n, c in launch.LAUNCHES.items() if c} == {
        "flash_attn_fwd_tf32": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_attention_vjp_matches_cpu(cuda, dtype):
    x = _inputs(torch.device("cpu"), 2, 100, 100, 4, 2, 64, torch.float32)
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v, do = (t.to(dev, dtype).detach().clone() for t in x)
        for t in (q, k, v):
            t.requires_grad_()
        launch.reset_launches()
        out = L.blockwise_attention(q, k, v, block_size=50)
        out.backward(do)
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
        if dev is cuda:
            torch.cuda.synchronize()
            fwd = flash_plan(dtype, 64).key
            assert {n: c for n, c in launch.LAUNCHES.items() if c} == {
                fwd: 1, flash_bwd_plan(dtype, 64).key: 1}
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, w) <= VJP_REL[dtype]


@pytest.mark.gpu
def test_cuda_attention_vjp_narrow_matches_cpu(cuda):
    """A gradient through ``layers._FlashAttention`` at dh 32 in f32
    (BERT4Rec's and the reduced LMs' head width): the forward and the
    backward both on their narrow (32, 32) instances, one launch each;
    dq, dk, dv within phase 12's 1e-4 relative L2 of the plain scan's
    gradients (the CPU path), the lse within ``LSE_REL`` of the plain
    forward's; G = 2, S != T."""
    x = _inputs(torch.device("cpu"), 2, 200, 160, 4, 2, 32, torch.float32)
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v, do = (t.to(dev).detach().clone() for t in x)
        for t in (q, k, v):
            t.requires_grad_()
        launch.reset_launches()
        out = L.blockwise_attention(q, k, v, causal=False, block_size=160)
        out.backward(do)
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
        if dev is cuda:
            torch.cuda.synchronize()
            assert {n: c for n, c in launch.LAUNCHES.items() if c} == {
                "flash_attn_fwd_tf32[32]": 1, BWD_NARROW_KEY: 1}
            assert flash_bwd_plan(torch.float32, 32, None,
                                  160).instance == (32, 32)
            _, lse = flash_attention(q.detach(), k.detach(), v.detach(),
                                     causal=False, return_lse=True)
            _, want = flash_attn_ref(q.detach(), k.detach(), v.detach(),
                                     causal=False, return_lse=True)
            assert float(((lse - want).abs()
                          / want.abs().clamp_min(1.0)).max()) <= LSE_REL
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, w) <= VJP_REL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("caller_tf32", [False, True])
def test_cuda_lm_loss_grads_match_cpu(cuda, caller_tf32):
    """A reduced Qwen3-0.6B's f32 loss gradients on the card (flash
    forward with lse, the backward kernel, full remat) against the CPU's;
    two forward launches and one backward a layer (dh 32 at 128 tokens:
    both on their narrow instances).  With TF32 allowed by
    the caller they still match: the backward and the remat recompute run
    after ``lm_forward``'s ``full_f32`` has closed, so ``value_and_grad``
    holds them in full f32 itself (TF32 products there err by ~1e-3);
    the caller's setting is restored."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def loss_fn(p, b):
        return T.lm_loss(p, b, cfg, dtype=torch.float32)
    want, wm = value_and_grad(loss_fn, params, batch)
    on_card = T.params_from_numpy(
        tree.tree_map(lambda t: t.numpy(), params), cuda)
    torch.backends.cuda.matmul.allow_tf32 = caller_tf32
    launch.reset_launches()
    got, m = value_and_grad(loss_fn, on_card, batch)
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 == caller_tf32
    fwd = flash_plan(torch.float32, cfg.d_head).key     # dh 32: [32]
    bwd = flash_bwd_plan(torch.float32, cfg.d_head, None, 128).key
    assert bwd == BWD_NARROW_KEY                        # dh 32, T 128
    assert {n: c for n, c in launch.LAUNCHES.items() if c} == {
        fwd: 2 * cfg.n_layers, bwd: cfg.n_layers}
    assert float(m["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)
    for (key, g), w in zip(tree.keyed_leaves(got), tree.leaves(want)):
        assert _rel(g.cpu(), w) <= 1e-4, key



@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_cuda_moe_lm_loss_grads_match_cpu(cuda, arch):
    """The MoE archs at their reduced configs: f32 loss gradients on the
    card (flash forward with lse, the backward kernel, the MoE dispatch
    under grad, full remat) against the CPU's, each leaf within 1e-4
    relative L2; the same expert assignments on both; two forward
    launches and one backward a layer, under the ``[dv]`` keys where v
    is narrower than q (DeepSeek-V2-Lite's MLA: 48 x 32), on the narrow
    instance at Qwen3-30B-A3B's dh 32."""
    cfg = get_config(arch, reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def loss_fn(p, b):
        return T.lm_loss(p, b, cfg, dtype=torch.float32)
    routes = {}
    router = L._router

    def recording(x, w, c):
        gates, eids = router(x, w, c)
        routes.setdefault(str(x.device.type), []).append(eids.cpu())
        return gates, eids
    L._router = recording
    try:
        want, wm = value_and_grad(loss_fn, params, batch)
        on_card = T.params_from_numpy(
            tree.tree_map(lambda t: t.numpy(), params), cuda)
        launch.reset_launches()
        got, m = value_and_grad(loss_fn, on_card, batch)
        torch.cuda.synchronize()
    finally:
        L._router = router
    for a, b in zip(routes["cpu"], routes["cuda"], strict=True):
        assert torch.equal(a, b)
    if cfg.mla:
        dh, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    else:
        dh = dv = cfg.d_head
    fwd = flash_plan(torch.float32, dh, dv).key
    bwd = flash_bwd_plan(torch.float32, dh, dv, 128).key
    assert bwd == (BWD_DV_KEY if cfg.mla else BWD_NARROW_KEY)
    assert {n: c for n, c in launch.LAUNCHES.items() if c} == {
        fwd: 2 * cfg.n_layers, bwd: cfg.n_layers}
    assert float(m["loss"]) == pytest.approx(float(wm["loss"]), rel=1e-5)
    for (key, g), w in zip(tree.keyed_leaves(got), tree.leaves(want)):
        assert _rel(g.cpu(), w) <= 1e-4, key
