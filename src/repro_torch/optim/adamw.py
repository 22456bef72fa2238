"""AdamW, a warmup-then-cosine schedule and global-norm clipping: the
port of the JAX package's ``optim/adamw.py`` (written from scratch there
too, no optax; ``torch.optim.AdamW`` is not used).

Plain functions on trees of tensors (``repro_torch.tree``): the state is
``{"m", "v"}`` (f32 trees like the params) and ``"step"`` (a 0-d int32
tensor), every step returns new tensors (nothing is updated in place).
The semantics are the reference's: the global norm clips the gradients
before the moments, bias correction divides the moments, weight decay
is added to the update inside it (decoupled, times the same lr), and the
schedule is f32 arithmetic on the step.  :func:`opt_state_specs` is the
state's layout on a mesh: the moments as the params, the step
replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.sharding.spec import P


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The lr at ``step`` (an int or a tensor) as a 0-d f32 tensor on the
    step's device: linear warmup over ``warmup_steps``, then a cosine down
    to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum, over the leaves in tree order, of each leaf's sum
    of squares in f32."""
    total = None
    for x in tree.leaves(grads):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params) -> Dict[str, Any]:
    zeros = tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    dev = tree.leaves(params)[0].device
    return {"m": zeros, "v": tree.tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs) -> Dict[str, Any]:
    return {"m": param_specs, "v": param_specs, "step": P()}


def adamw_update(grads, state, params, cfg: OptimizerConfig):
    """One AdamW step: (new params in each param's dtype, new state,
    {"grad_norm" (before clipping), "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(step, cfg)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    # the reference's expression, each step in place on a tensor this
    # update made (the same f32 operations in the same order), so no more
    # than about four temporaries of a leaf's size are live at once: at
    # full width a leaf of stacked experts' weights is gigabytes
    def upd(g, m, v, p):
        g = g.float() * scale
        m = (cfg.b1 * m).add_((1 - cfg.b1) * g)
        v = (cfg.b2 * v).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = torch.div(m, b1c).div_(
            torch.div(v, b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        return (p.float() - delta.mul_(lr)).to(p.dtype), m, v

    new = [upd(g, m, v, p) for g, m, v, p in zip(
        tree.leaves(grads), tree.leaves(state["m"]),
        tree.leaves(state["v"]), tree.leaves(params), strict=True)]
    new_p = tree.unflatten_like(params, (n[0] for n in new))
    new_m = tree.unflatten_like(params, (n[1] for n in new))
    new_v = tree.unflatten_like(params, (n[2] for n in new))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def apply_updates(params, updates):
    return tree.tree_map(lambda p, u: p + u, params, updates)
