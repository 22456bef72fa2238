"""The training loop: the port of the JAX package's ``train/loop.py``.

:func:`make_train_step` builds ``train_step(state, batch) -> (state,
metrics)``: gradients by ``torch.autograd.grad`` (microbatches
accumulated in f32 and averaged, as the reference's ``lax.scan`` does),
optional int8 error-feedback compression, then AdamW.  PyTorch runs
eagerly, so there is nothing to jit; the step allocates new params and
state rather than updating in place.  The forward and the backward run
under ``core.clustering.full_f32``: f32 products on the card in full f32
(TF32 off) in the backward too, whose recompute of each block runs after
the forward's own precision context has closed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.clustering import full_f32
from repro_torch.optim.adamw import OptimizerConfig, adamw_init, adamw_update
from repro_torch.optim.compress import ef_compress_grads, ef_init
from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1               # gradient accumulation steps
    grad_compress_bits: int = 0         # 0 = off; 8 = int8 EF compression
    ckpt_every: int = 0
    ckpt_dir: str = ""
    keep_ckpts: int = 3


def value_and_grad(loss_fn: Callable, params, batch):
    """(grads like params, metrics detached) of ``loss_fn(params, batch)
    -> (loss, metrics)``, forward and backward under ``full_f32``.  The
    caller's tensors are not touched: the loss sees detached aliases that
    require grad."""
    xs = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with full_f32:
        loss, metrics = loss_fn(tree.unflatten_like(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, xs)]
    return (tree.unflatten_like(params, grads),
            {k: torch.as_tensor(v).detach() for k, v in metrics.items()})


def microbatch_grads(loss_fn: Callable, params, batch, microbatches: int):
    """:func:`value_and_grad` of ``batch`` cut along its leading axis into
    ``microbatches`` equal parts, one after another: the gradients summed
    in f32 and divided by their count, the metrics averaged (the
    reference's ``lax.scan`` accumulation).  One part: ``value_and_grad``
    itself."""
    mb = microbatches
    if mb <= 1:
        return value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    micro = {k: v.reshape(mb, b // mb, *v.shape[1:])
             for k, v in batch.items()}
    acc, per_mb = None, []
    for i in range(mb):
        grads, metrics = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in micro.items()})
        g32 = tree.tree_map(lambda g: g.float(), grads)
        acc = g32 if acc is None else tree.tree_map(torch.add, acc, g32)
        per_mb.append(metrics)
    grads = tree.tree_map(lambda g: g / mb, acc)
    metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
               for k in per_mb[0]}
    return grads, metrics


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``.  Returns
    ``train_step(state, batch) -> (state, metrics)``; state = {"params",
    "opt"[, "ef"]}.  A batch is a dict of arrays or tensors whose leading
    axis ``microbatches`` divides (:func:`microbatch_grads`)."""

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        grads, metrics = microbatch_grads(loss_fn, params, batch,
                                          tcfg.microbatches)
        if tcfg.grad_compress_bits:
            grads, residuals = ef_compress_grads(
                grads, state["ef"], tcfg.grad_compress_bits)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, opt_state, params, tcfg.opt)
        metrics = {**metrics, **opt_metrics}
        new_state = {"params": new_params, "opt": new_opt}
        if tcfg.grad_compress_bits:
            new_state["ef"] = residuals
        return new_state, metrics

    return train_step


def init_state(params, tcfg: TrainConfig):
    state = {"params": params, "opt": adamw_init(params)}
    if tcfg.grad_compress_bits:
        state["ef"] = ef_init(params)
    return state


def run(train_step, state, batches, tcfg: TrainConfig, *,
        start_step: int = 0, log_every: int = 10,
        on_step: Optional[Callable[[int], None]] = None):
    """Drive the loop over an iterable of batches; checkpoint every
    ``tcfg.ckpt_every`` steps.  ``on_step(step)`` runs before each step
    (the supervisor's fault injection and monitoring hook).  Returns
    (state, step, history of logged metrics)."""
    history = []
    step = start_step
    t0 = time.time()
    for batch in batches:
        if on_step is not None:
            on_step(step)
        state, metrics = train_step(state, batch)
        step += 1
        if step % log_every == 0 or step == start_step + 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
            ckpt_lib.save(tcfg.ckpt_dir, step, state, keep=tcfg.keep_ckpts)
    return state, step, history
