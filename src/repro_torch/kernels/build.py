"""Builds the port's CUDA sources and loads them.

Every kernel is one ``<package>/csrc/<name>.cu`` under
``repro_torch/kernels`` (:data:`SOURCES` names them), compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, which
``ctypes`` loads (no PyTorch headers, so a build takes seconds).
:func:`build` starts one ``nvcc`` per source, all together.  Libraries go
to ``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of their source, of each header it includes (``#include "x.cuh"``,
found in the source's ``csrc/`` directory or in ``repro_torch/kernels``
itself, which holds ``hopper.cuh``, the Hopper helpers of the
tensor-core kernels, and is passed with ``-I``), and of the flags, so an
edited source or header rebuilds the libraries that use it and no
other.  Nothing is built until a kernel is first used on a CUDA tensor,
or :func:`build` is called.

FMA policy: every source is compiled with ``-fmad=false``, so no multiply
and add are contracted unless the source writes ``__fmaf_rn``.

* ``pq_adc`` (``adc_scan``, ``adc_scan_topk``, ``adc_scan_batch``,
  ``adc_fused_topk``): the LUT chain is written with ``__fmaf_rn`` where
  the plain version fuses, and every other step rounds on its own, so the
  kernels give the plain versions' bits.
* ``flash_attn_fwd_wgmma``: its products run on the tensor cores (bf16
  in, f32 sums, in the tensor cores' order); the softmax is written out
  step by step in base 2 (``ex2.approx``).
* ``flash_attn_fwd_tf32``: its products run on the tensor cores in
  3xTF32 (f32 sums, in the tensor cores' order); the scaling, the
  softmax in base 2 (``ex2.approx``), the rescaling and the final
  division round each step (``__fmul_rn``, ``__fadd_rn``, ...).
* ``flash_attn_bwd``: the attention backward on the tensor cores, every
  product in bf16 ``wgmma`` on bf16 terms of its operands (three terms of
  f32 inputs, P and dS; f32 sums, in the tensor cores' order); D a chain
  of ``__fmaf_rn``, each element step rounded on its own, the
  exponentials ``expf``; the forwards write the logsumexp it reads
  (``flash_lse.cuh``).
* ``l2dist_wgmma``: its product runs on the tensor cores, in 3xTF32 for
  f32 inputs and in one bf16 product for bf16 (f32 sums in the tensor
  cores' order); its norms are ``__fmaf_rn`` sums (one rounding per
  term) and its epilogue (``|q|^2 - 2 q.v + |v|^2``) rounds each step, as
  the plain version does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch_kernels"
# kernel name -> the package whose csrc/ holds <name>.cu
SOURCES = {
    "adc_scan_batch": "pq_adc",
    "adc_fused_topk": "pq_adc",
    "adc_scan": "pq_adc",
    "adc_scan_topk": "pq_adc",
    "l2dist_wgmma": "l2dist",       # f32 and bf16 instantiations
    "flash_attn_fwd_wgmma": "flash_attn",
    "flash_attn_fwd_tf32": "flash_attn",
    "flash_attn_bwd": "flash_attn",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch are built from source at first use")


def source_path(name: str) -> Path:
    return KERNELS / SOURCES[name] / "csrc" / f"{name}.cu"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(name: str) -> list:
    """The headers source ``name`` includes, directly or through another
    header: each ``#include "x"`` looked up in the source's ``csrc/`` and
    then in ``repro_torch/kernels``, as ``nvcc`` finds it."""
    src = source_path(name)
    found, todo = [], [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = next((d / inc for d in (src.parent, KERNELS)
                         if (d / inc).is_file()), None)
            if path is not None and path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    for header in headers(name):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each compiled
    source's ``ptxas`` report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, f"-I{KERNELS}", "-o", str(tmp),
               str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader sees all
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def main(argv: Sequence[str] = ()) -> int:
    """``python -m repro_torch.kernels.build [name ...]``: build the named
    sources (all by default) from nothing and print the seconds, all
    together (as the first use builds them), then each alone."""
    import argparse
    import time
    ap = argparse.ArgumentParser(
        description="Build the port's CUDA sources from nothing and print "
                    "the seconds: all together, then each alone.")
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"of {', '.join(SOURCES)} (default: all)")
    names = ap.parse_args(list(argv) or None).names or list(SOURCES)
    unknown = sorted(set(names) - set(SOURCES))
    if unknown:
        ap.error(f"unknown kernels {unknown}")

    def fresh(names) -> float:
        for name in names:
            library_path(name).unlink(missing_ok=True)
        t = time.perf_counter()
        build(names)
        return time.perf_counter() - t
    print(f"together: {fresh(names):.1f} s")
    for name in names:
        print(f"{name}: {fresh([name]):.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
