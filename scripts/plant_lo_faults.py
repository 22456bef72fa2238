#!/usr/bin/env python3
"""Shows that the GPU tests of the 3xTF32 kernels catch a dropped lo
term: for each of the flash kernels' four lo parts (the keys-split kernel,
of 32 < dh <= 128 and of MLA's 192 x 128, the one of 128 < dh <= 256 whose
warpgroups split the head width, and the narrow one of dh <= 32),
and for the lo part of the exact-L2 kernel's streamed query slices, copies
the tree with that part set to zero and runs the kernel's lo-term tests
on the copy, which must fail.

    python3 scripts/plant_lo_faults.py [--dir build/plant] [--out FILE]
                                       [--only FAULT ...]

Each copy (``src/``, ``tests/``, ``pytest.ini``) goes under ``--dir``, a
directory ``.gitignore`` lists, and builds its own kernels there.  The
thirteen faults, one edit each:

* ``no_Qhi_Klo`` (``flash_attn_fwd_tf32.cu``, the keys-split kernel):
  K lo = 0, so Q hi * K lo drops out of S;
* ``no_Qlo_Khi``: Q lo = 0 (Q lo * K hi);
* ``no_Plo_Vhi``: P lo = 0 (P lo * V hi);
* ``no_Phi_Vlo``: V lo = 0 (P hi * V lo);
* ``wide_no_Qhi_Klo`` ... ``wide_no_Phi_Vlo``: the same four in the
  kernel of 128 < dh <= 256 (the second occurrence of each line the two
  share);
* ``narrow_no_Qhi_Klo`` ... ``narrow_no_Phi_Vlo``: the same four in the
  narrow kernel of dh <= 32 (its own lines: the lo parts unrounded);
* ``l2_streamed_no_Qlo_Vhi`` (``l2dist_wgmma.cu``): the prologue that
  splits the queries for the streamed path (d > 128) writes q lo = 0, so
  Q lo * V hi drops out of the distances.

Runs ``pytest -m gpu -k <selection> tests/test_torch_cuda.py`` on each
copy (the flash faults: every ``flash_tf32`` test at the widths of the
kernel changed, 32 < dh <= 128 and the 192 x 128 ``[dv]`` instance, dh
192 and 256, or the lo-term tests at dh 32; the L2 fault: the
cross-term tests whose queries carry lo parts and whose query tile is
streamed) and prints its exit code, its greatest differences and the
tests that failed; ``--out`` also writes that log.  Exits non-zero unless
every copy failed every one of its tests.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH_SRC = "src/repro_torch/kernels/flash_attn/csrc/flash_attn_fwd_tf32.cu"
# (source, pytest -k selection, which occurrence of the line to change,
# how many there are)
# (the narrow instance's dh 32 tests named by their ids: "tf32" holds "32")
FLASH = (FLASH_SRC, "flash_tf32 and not 192 and not 256 and not dh32 and "
                    "not split_views and not scores-32 and not values-32")
WIDE = (FLASH_SRC, "flash_tf32_lo_terms and (192 or 256)")
NARROW = (FLASH_SRC, "flash_tf32_lo_terms and (scores-32 or values-32)")
L2 = ("src/repro_torch/kernels/l2dist/csrc/l2dist_wgmma.cu",
      "l2dist_wgmma_cross_terms and vectors and not 128")
# lines both flash kernels share (occurrence 0 in the kernel of dh <= 128,
# 1 in the wide one) and their faulty forms
K_LO = ("kl4[t + 128 * i] = make_float4(",
        "kl4[t + 128 * i] = make_float4(0.f, 0.f, 0.f, 0.f); (void)make_float4(")
Q_LO = ("return tf32_rna(__fsub_rn(y, tf32_rna(y)));", "return 0.f;")
P_LO = ("p_lo[slot] = __float_as_uint(tf32_rna(__fsub_rn(p, hi)));",
        "p_lo[slot] = 0u;")
V_LO = ("lv[e] = tf32_rna(__fsub_rn(x, hv[e]));", "lv[e] = 0.f;")
# name -> (source, pytest -k selection, occurrence, count, line, faulty)
FAULTS = {
    "no_Qhi_Klo": FLASH + (0, 2) + K_LO,
    "no_Qlo_Khi": FLASH + (0, 2) + Q_LO,
    "no_Plo_Vhi": FLASH + (0, 2) + P_LO,
    "no_Phi_Vlo": FLASH + (0, 2) + V_LO,
    "wide_no_Qhi_Klo": WIDE + (1, 2) + K_LO,
    "wide_no_Qlo_Khi": WIDE + (1, 2) + Q_LO,
    "wide_no_Plo_Vhi": WIDE + (1, 2) + P_LO,
    "wide_no_Phi_Vlo": WIDE + (1, 2) + V_LO,
    "narrow_no_Qhi_Klo": NARROW + (0, 1) + (
        "reinterpret_cast<float4*>(k_lo(st))[i] =",
        "reinterpret_cast<float4*>(k_lo(st))[i] = make_float4(0.f, 0.f, "
        "0.f, 0.f); (void)"),
    "narrow_no_Qlo_Khi": NARROW + (0, 1) + (
        "return __fsub_rn(y, tf32_hi(y));", "return 0.f;"),
    "narrow_no_Plo_Vhi": NARROW + (0, 1) + (
        "p_lo[slot] = __float_as_uint(__fsub_rn(p, hi));",
        "p_lo[slot] = 0u;"),
    "narrow_no_Phi_Vlo": NARROW + (0, 1) + (
        "lv[e] = __fsub_rn(x, hv[e]);", "lv[e] = 0.f;"),
    "l2_streamed_no_Qlo_Vhi": L2 + (0, 1) + (
        "lo[i] = tf32_rna(__fsub_rn(x, h));",
        "lo[i] = 0.f;"),
}


def plant(dst: Path, source: str, at: int, count: int, old: str,
          new: str) -> None:
    """A copy of the tree at ``dst`` with occurrence ``at`` of ``old``
    (found ``count`` times) replaced."""
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for part in ("src", "tests"):
        shutil.copytree(ROOT / part, dst / part, ignore=ignore)
    shutil.copy2(ROOT / "pytest.ini", dst / "pytest.ini")
    src = dst / source
    text = src.read_text()
    if text.count(old) != count:
        raise SystemExit(f"{source}: the edit's line occurs "
                         f"{text.count(old)} times, not {count}")
    parts = text.split(old)
    src.write_text(old.join(parts[:at + 1]) + new
                   + old.join(parts[at + 1:]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", type=Path, default=ROOT / "build" / "plant")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--only", nargs="+", choices=FAULTS, default=FAULTS,
                    metavar="FAULT", help="the faults to plant (all by "
                    "default)")
    args = ap.parse_args()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log, caught = [], True
    for name in args.only:
        source, select, at, count, old, new = FAULTS[name]
        dst = args.dir / name
        plant(dst, source, at, count, old, new)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-m", "gpu", "-k", select, "tests/test_torch_cuda.py"],
            cwd=dst, env=env, capture_output=True, text=True)
        out = run.stdout + run.stderr
        failed = re.findall(r"^FAILED (\S+)", out, re.M)
        passed = re.search(r"(\d+) passed", out)
        ok = run.returncode != 0 and failed and not passed
        caught &= bool(ok)
        log.append(f"== {name}: exit {run.returncode}, {len(failed)} failed,"
                   f" {passed.group(1) if passed else 0} passed")
        log += re.findall(r"^E\s+Greatest absolute difference.*$", out, re.M)
        log += [f"FAILED {t}" for t in failed]
        if not failed:
            log.append(out[-3000:])
    log.append(f"every planted fault caught: {caught}")
    text = "\n".join(log)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
