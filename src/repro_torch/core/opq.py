"""OPQ: optimized product quantization (beyond-paper PQ-quality lever).

Learns an orthonormal rotation R so that sub-space energy is balanced
before PQ (Ge et al., OPQ, CVPR'13 — standard companion to IVF-PQ systems;
FAISS applies it by default at billion scale).  Alternating minimisation:
  E-step: PQ-encode R·x;  M-step: R <- Procrustes(X, decoded codes).
Drop-in: wrap the codebook; queries rotate once before the LUT build.

The rows, their rotation, the codebooks (``pq.train_codebooks``, f64
sums) and ``xᵀ·recon`` live on ``device``; only the 128 × 128 Procrustes
SVD runs on the host, in numpy f64.  The codebooks start from a
``torch.Generator`` draw (the same draw every round, as the JAX package
reuses its key), so a port-trained rotation differs from the JAX
package's; ``encode`` and ``adc_lut`` of a given ``OPQCodebook`` are the
same functions.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import pq
from repro_torch.core.clustering import full_f32

# rows per chunk of the error and Procrustes sums
_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class OPQCodebook:
    rotation: np.ndarray          # (D, D) orthonormal, f32
    cb: pq.PQCodebook

    @property
    def m(self) -> int:
        return self.cb.m


def _as_rows(data, device: torch.device) -> torch.Tensor:
    """(N, D) numpy or torch rows on ``device``, in their own dtype."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(data))
    return data.to(device)


def rotate(data, rotation, device: torch.device) -> torch.Tensor:
    """``data @ rotation`` in f32 on ``device`` (TF32 off)."""
    x = _as_rows(data, device).float()
    r = torch.as_tensor(rotation).to(device=device, dtype=torch.float32)
    with full_f32:
        return x @ r


def _recon_sums(cb: pq.PQCodebook, x: torch.Tensor, xr: torch.Tensor
                ) -> Tuple[float, torch.Tensor]:
    """(mean squared reconstruction error of ``xr``, ``xᵀ·recon`` in
    f64), over chunks of rows."""
    d = x.shape[1]
    err = torch.zeros((), dtype=torch.float64, device=x.device)
    xtr = torch.zeros(d, d, dtype=torch.float64, device=x.device)
    for s in range(0, len(x), _CHUNK):
        xr_c = xr[s:s + _CHUNK]
        recon = pq.decode(cb, pq.encode(cb, xr_c))
        err += ((xr_c - recon).double() ** 2).sum()
        xtr += x[s:s + _CHUNK].double().T @ recon.double()
    return float(err) / max(len(x), 1), xtr


def train_opq(gen: torch.Generator, data, m: int, nbits: int = 8,
              iters: int = 4, kmeans_iters: int = 8, *,
              device: torch.device) -> Tuple[OPQCodebook, float]:
    """Returns (codebook, final mean squared reconstruction error).
    ``data`` is (N, D), numpy or torch; ``gen`` is a CPU generator."""
    x = _as_rows(data, device).float()
    d = x.shape[1]
    r = np.eye(d, dtype=np.float32)
    state = gen.get_state()
    cb = None
    err = float("inf")
    for _ in range(iters):
        xr = rotate(x, r, device)
        gen.set_state(state)
        cb = pq.train_codebooks(gen, xr, m, nbits, iters=kmeans_iters,
                                device=device)
        err, xtr = _recon_sums(cb, x, xr)
        del xr
        # Procrustes: R = argmin ||XR - recon||  =>  R = U V^T of X^T recon
        u, _, vt = np.linalg.svd(xtr.cpu().numpy(), full_matrices=False)
        r = (u @ vt).astype(np.float32)
    return OPQCodebook(rotation=r, cb=cb), err


def encode(ocb: OPQCodebook, data) -> torch.Tensor:
    dev = ocb.cb.codebooks.device
    return pq.encode(ocb.cb, rotate(data, ocb.rotation, dev))


def adc_lut(ocb: OPQCodebook, query: np.ndarray) -> torch.Tensor:
    """Rotation preserves L2, so rotated-space ADC distances estimate the
    original-space distances directly.  (D,) -> (M, K).  The query turns
    on the host, as the engine's ``_lut_query`` turns it."""
    q = np.asarray(query, np.float32) @ ocb.rotation
    return pq.adc_lut(ocb.cb, torch.from_numpy(q).to(
        ocb.cb.codebooks.device))


def reconstruction_error(ocb: OPQCodebook, data) -> float:
    dev = ocb.cb.codebooks.device
    x = _as_rows(data, dev).float()
    return _recon_sums(ocb.cb, x, rotate(x, ocb.rotation, dev))[0]
