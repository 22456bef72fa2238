"""int8 error-feedback gradient compression: the port of the JAX
package's ``optim/compress.py``.

On a cluster this cuts the gradient all-reduce's bytes; error feedback
keeps convergence (1-bit Adam / EF-SGD lineage).  As in the reference it
is modelled on one device as quantise -> dequantise plus a carried
residual (residual + transmitted == original, the EF invariant).
"""

from __future__ import annotations

import torch

from repro_torch import tree


def compress_decompress(g: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor int quantisation: (dequantised in g's dtype,
    residual in f32).  Rounds half to even, as ``jnp.round`` does."""
    gf = g.float()
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / qmax
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
    dq = q * scale
    return dq.to(g.dtype), gf - dq


def ef_init(params):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def ef_compress_grads(grads, residuals, bits: int = 8):
    """Error feedback: compress (grad + residual), carry the new residual.
    Returns (compressed grads, residuals), trees like ``grads``."""
    pairs = [compress_decompress(g.float() + r, bits) for g, r in zip(
        tree.leaves(grads), tree.leaves(residuals), strict=True)]
    return (tree.unflatten_like(grads, (p[0] for p in pairs)),
            tree.unflatten_like(grads, (p[1] for p in pairs)))
