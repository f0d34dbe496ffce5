#!/usr/bin/env python3
"""Where the time of the fused soft kernels (B7, B8) goes, on one CUDA card.

    python3 tools/ablate_soft_kernels.py [--n N]   # from the repository root, default 512

Builds `voxtpu_torch/csrc/soft_vox.cu` as it is and in variants that
each change or take out one part (by exact substitution in the source;
the tool fails if a substitution no longer applies), then times the C
entry points `vt_fused_fwd` (B7) and `vt_fused_bwd` (B8) of each on
step 1 of phase 6's fused fit in `chip_smoke.py` (the 1,348,128-face
rotated torus at N^3; the loss cotangent for B8), buffers allocated
once. CUDA events, one warm-up, median of 5.

  as_is           the kernels as they are
  b7_cas          B7's 64-bit shared adds as atomicAdd on the 64-bit word
                  (a compare-and-swap loop on sm_90a) instead of two
                  32-bit adds with a carry (exact)
  b7_no_carry     B7 without its saturated columns (not exact: timing)
  b7_no_windows   B7 without its window columns (not exact: timing)
  b7_records      B7's record pass alone (timing)
  b8_row_sums     B8 summing table rows with `row_sums`, every row over
                  every slot of its batch (exact)
  b8_no_rows      B8 without its table-row sums (not exact: timing)
  b8_no_windows   B8 without its window columns (not exact: timing)
  b8_prefix       B8's row prefix pass alone (timing)

Prints the card's name and power limit, each variant's ptxas lines for
the fused kernels, and per variant the B7 and B8 times. Exits non-zero
if a build fails or an exact variant differs from `as_is`.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TAU, bitwise_equal, card_line, cuda_ms, loss_cotangent  # noqa: E402
from tools.check_fused_window import torus_fit  # noqa: E402
from voxtpu_torch import _build  # noqa: E402
from voxtpu_torch.ops import soft_vox_fused as F  # noqa: E402

SRC = _build.CSRC / "soft_vox.cu"
EXACT = ("as_is", "b7_cas", "b8_row_sums")
SKIP = "g.n < 0 && "  # a condition that never holds, in front of a loop's own

VARIANTS = {
    "as_is": [],
    "b7_cas": [("    add_split(&s_base[r.x], fix);", "    atomicAdd(&s_base[r.x], fix);"),
               ("if (a < x1) add_split(", "if (a < x1) atomicAdd("),
               ("fix_add_split(&s_acc", "fix_add(&s_acc")],
    "b7_no_carry": [("if (r.x < 0 || a <= x0) continue;",
                     "if (r.x < 0 || a <= x0 || g.n > 0) continue;")],
    "b7_no_windows": [("for (int i = threadIdx.x / kGroup; i < count;",
                       f"for (int i = threadIdx.x / kGroup; {SKIP}i < count;")],
    "b7_records": [("  const size_t smem = fused_fwd_smem(tc, tb);",
                    "  if (n > 0) return 0;\n  const size_t smem = fused_fwd_smem(tc, tb);")],
    "b8_row_sums": [("  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab",
                     "  row_sums(s_d, s_row, tb, tbl, dtab")],
    "b8_no_rows": [("  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab",
                    "  if (g.n < 0) row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab")],
    "b8_no_windows": [("for (int x = (win & 0xffff) + glane; x < (win >> 16);",
                       f"for (int x = (win & 0xffff) + glane; {SKIP}x < (win >> 16);")],
    "b8_prefix": [("  const size_t smem = (size_t)tb * (kNgrad + 1)",
                   "  if (n > 0) return 0;\n  const size_t smem = (size_t)tb * (kNgrad + 1)")],
}


def variant_source(name: str) -> str:
    text = SRC.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r} exactly once")
        text = text.replace(old, new)
    return text


def build_all(out_dir: str) -> dict:
    """{variant: ctypes library}, one nvcc per variant, started together;
    prints the fused kernels' ptxas lines."""
    procs = {}
    for name in VARIANTS:
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", so,
             src], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        kernel = None
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '\w*?((?:fused|row)_\w+?_kernel)", line)
            if found:
                kernel = found.group(1)
            elif kernel and "Used" in line:
                print(f"{name}: {kernel}: {line.split(':', 1)[1].strip()}")
                kernel = None
        lib = ctypes.CDLL(so)
        for entry in ("vt_fused_fwd", "vt_fused_bwd"):
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=512)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate_soft_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    print(card_line())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_all(tmp)
        fit, state, target = torus_fit(args.n)
        fp = fit.engine_plan
        n, tc, tb, prm = fp.spec.n, fp.tc, fp.cells_d[0].numel(), fp.prm(*TAU)
        with torch.no_grad():
            tables = F.tables_of(state.coords, fp)
        occ_ref = F.fused_fwd(tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d,
                              fp.run_start_d, n=n, tc=tc, prm=prm)
        g = loss_cotangent(occ_ref, target)
        ptrs = (tables.data_ptr(), fp.cells_d.data_ptr(), fp.tblidx_d.data_ptr(),
                fp.batch_tile_d.data_ptr())
        work = torch.empty((fp.cells_d.numel(), 4), dtype=torch.int32, device=g.device)
        pre = torch.empty((n * n, n), dtype=torch.float64, device=g.device)
        stream = _build.stream_of(g)
        ok = True
        for name, lib in libs.items():
            out = torch.zeros_like(occ_ref)
            dtab = torch.zeros_like(tables)

            def b7():
                err = lib.vt_fused_fwd(*ptrs, fp.run_start_d.data_ptr(), tables.shape[0],
                                       fp.run_start_d.numel() - 1, tb, tables.shape[1], n,
                                       tc, n * n // tc, *prm, work.data_ptr(),
                                       out.data_ptr(), stream)
                assert err == 0, f"{name} B7: CUDA error {err}"

            def b8():
                err = lib.vt_fused_bwd(*ptrs, g.data_ptr(), tables.shape[0], tb,
                                       tables.shape[1], n, tc, n * n // tc, *prm,
                                       pre.data_ptr(), dtab.data_ptr(), stream)
                assert err == 0, f"{name} B8: CUDA error {err}"

            b7()
            b8()
            torch.cuda.synchronize()
            if name in EXACT:
                if name == "as_is":
                    dtab_ref = dtab.clone()
                same = bitwise_equal(out, occ_ref) and bitwise_equal(dtab, dtab_ref)
                ok &= same
                print(f"{name}: B7 and B8 bitwise as_is: {same}")
            print(f"{name}: B7 {cuda_ms(b7):.4f} ms, B8 {cuda_ms(b8):.4f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
