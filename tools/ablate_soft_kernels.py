#!/usr/bin/env python3
"""Where the time of the windowed soft kernels (B7, B8, B9, B11, B13) goes, on one CUDA card.

    python3 tools/ablate_soft_kernels.py [--n N]   # from the repository root, default 512

Builds `voxtpu_torch/csrc/soft_vox.cu` and `soft_vox_seg.cu` as they
are and in variants that each change or take out one part (by exact
substitution in the source or in the `soft_common.cuh` it includes,
written beside it; the tool fails if a substitution no longer applies),
then times the C entry points of each: `vt_fused_fwd` (B7)
and `vt_fused_bwd` (B8) on step 1 of phase 6's fused fit in
`chip_smoke.py` (the 1,348,128-face rotated torus at N^3; the loss
cotangent for B8), `vt_fragment_fwd` and `vt_fragment_bwd` (B13) on
step 1 of its cuda-engine fit from the same start, `vt_seg_fwd` (B9)
and `vt_seg_bwd` (B11) on step 1 of its seg fit; buffers allocated once
(so B9's times leave out the wrapper's zeroed family arrays). CUDA
events, one warm-up, median of 5. B7 and B13 fwd share one
accumulation, and B8 and B13 bwd one window sum, so a variant of those
parts changes both kernels.

  as_is           the kernels as they are
  b7_cas          the accumulation's 64-bit shared adds (B7, B13 fwd) as
                  atomicAdd on the 64-bit word (a compare-and-swap loop
                  on sm_90a) instead of two 32-bit adds with a carry
                  (exact)
  b7_no_carry     B7 and B13 fwd without their saturated columns (not
                  exact: timing)
  b7_no_windows   B7 and B13 fwd without their window columns (timing)
  b7_records      B7's and B13 fwd's record passes alone (timing)
  b8_row_sums     B8 summing table rows with `row_sums`, every row over
                  every slot of its batch (exact)
  b8_no_rows      B8 without its table-row sums (not exact: timing)
  b8_no_windows   B8 and B13 bwd without their window columns (timing)
  b8_prefix       B8's row prefix pass alone (timing)
  b13_prefix      B13 bwd's row prefix pass alone (timing)
  seg_as_is       B9 and B11 as they are
  b9_records      B9's record pass alone (timing)
  b9_no_carry     B9 without its saturated columns and carry (not exact)
  b9_no_windows   B9 without its window columns (not exact: timing)
  b11_no_left     B11's lanes starting at the window, without the
                  in-panel prefix left of it (not exact: timing)
  b11_no_windows  B11 without its lane loop over the panel (timing)
  b11_no_rows     B11 without its table-row sums (not exact: timing)

Prints the card's name and power limit, each variant's ptxas lines for
the soft kernels, and per variant the times of its two kernels. Exits
non-zero if a build fails or an exact variant differs from the wrapper's
result (`as_is`, `b7_cas`, `b8_row_sums` against the fused and per-fragment
wrappers, `seg_as_is` against the seg ones).
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
from voxtpu_torch.ops import soft_vox, soft_vox_cuda as C  # noqa: E402
from voxtpu_torch.ops import soft_vox_fused as F  # noqa: E402
from voxtpu_torch.ops import soft_vox_seg as S  # noqa: E402

FUSED, SEG, COMMON = "soft_vox.cu", "soft_vox_seg.cu", "soft_common.cuh"
EXACT = ("as_is", "b7_cas", "b8_row_sums", "seg_as_is")
SKIP = "g.n < 0 && "  # a condition that never holds, in front of a loop's own

FUSED_VARIANTS = {
    "as_is": [],
    "b7_cas": [("    add_split(&s.base[r.x], fix);", "    atomicAdd(&s.base[r.x], fix);"),
               ("if (a < x1) add_split(", "if (a < x1) atomicAdd("),
               ("fix_add_split(&s.acc", "fix_add(&s.acc")],
    "b7_no_carry": [("    if (r.x < 0) continue;", "    if (r.x < 0 || g.n > 0) continue;")],
    "b7_no_windows": [("for (int i = threadIdx.x / kGroup; i < count;",
                       f"for (int i = threadIdx.x / kGroup; {SKIP}i < count;")],
    "b7_records": [("  const size_t smem = acc_smem_bytes(g.tc, tb);",
                    "  if (g.n > 0) return 0;\n"
                    "  const size_t smem = acc_smem_bytes(g.tc, tb);")],
    "b8_row_sums": [("  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab",
                     "  row_sums(s_d, s_row, tb, tbl, dtab")],
    "b8_no_rows": [("  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab",
                    "  if (g.n < 0) row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab")],
    "b8_no_windows": [("for (int x = a + (int)(threadIdx.x % kGroup); x < b;",
                       f"for (int x = a + (int)(threadIdx.x % kGroup); {SKIP}x < b;")],
    "b8_prefix": [("  const size_t smem = (size_t)tb * (kNgrad + 1)",
                   "  if (n > 0) return 0;\n  const size_t smem = (size_t)tb * (kNgrad + 1)")],
    "b13_prefix": [("  const unsigned blocks = (unsigned)((slots + kThreads",
                    "  if (n > 0) return 0;\n"
                    "  const unsigned blocks = (unsigned)((slots + kThreads")],
}
SEG_VARIANTS = {
    "seg_as_is": [],
    "b9_records": [("  const size_t smem = acc_smem_bytes(tc, tb);",
                    "  if (n > 0) return 0;\n  const size_t smem = acc_smem_bytes(tc, tb);")],
    "b9_no_carry": [("    if (r.x < 0) continue;", "    if (r.x < 0 || g.n > 0) continue;")],
    "b9_no_windows": [("for (int i = threadIdx.x / kGroup; i < count;",
                       f"for (int i = threadIdx.x / kGroup; {SKIP}i < count;")],
    "b11_no_left": [("for (int q = glane; 4 * q < a - p0;",
                     f"for (int q = glane; {SKIP}4 * q < a - p0;")],
    "b11_no_windows": [("for (int q = glane; 4 * q < a - p0;",
                        f"for (int q = glane; {SKIP}4 * q < a - p0;"),
                       ("for (int x = a + glane; x < (win >> 16);",
                        f"for (int x = a + glane; {SKIP}x < (win >> 16);")],
    "b11_no_rows": [("  row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab",
                     "  if (g.n < 0) row_sums_ranged(s_d, s_row, s_first, s_last, tbl, dtab")],
}
# variant -> (source file, substitutions)
VARIANTS = {**{k: (FUSED, v) for k, v in FUSED_VARIANTS.items()},
            **{k: (SEG, v) for k, v in SEG_VARIANTS.items()}}
ENTRIES = {FUSED: ("vt_fused_fwd", "vt_fused_bwd", "vt_fragment_fwd", "vt_fragment_bwd"),
           SEG: ("vt_seg_fwd", "vt_seg_bwd")}


def variant_sources(name: str) -> dict:
    """{file name: text} of a variant: its source and the shared header,
    each substitution made in the one of them that holds it."""
    source, subs = VARIANTS[name]
    texts = {f: (_build.CSRC / f).read_text() for f in (source, COMMON)}
    for old, new in subs:
        where = [f for f, text in texts.items() if old in text]
        if len(where) != 1 or texts[where[0]].count(old) != 1:
            raise SystemExit(f"{name}: the sources no longer hold {old!r} exactly once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def build_all(out_dir: str) -> dict:
    """{variant: ctypes library}, one nvcc per variant, started together,
    each in a directory of its own (its source includes the header
    beside it); prints the soft kernels' ptxas lines."""
    procs = {}
    for name in VARIANTS:
        vdir = os.path.join(out_dir, name)
        os.mkdir(vdir)
        for fname, text in variant_sources(name).items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        so = os.path.join(vdir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(vdir, VARIANTS[name][0])],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-4000:]}")
        kernel = None
        for line in log.splitlines():
            found = re.search(
                r"Compiling entry function '\w*?((?:fused|fragment|window|row|seg)_\w+?_kernel)",
                line)
            if found:
                kernel = found.group(1)
            elif kernel and "Used" in line:
                print(f"{name}: {kernel}: {line.split(':', 1)[1].strip()}")
                kernel = None
        lib = ctypes.CDLL(so)
        for entry in ENTRIES[VARIANTS[name][0]]:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_fused(libs: dict, n: int) -> bool:
    """B7 and B8 of each soft_vox.cu variant on the fused fit's step 1."""
    fit, state, target = torus_fit(n)
    fp = fit.engine_plan
    n, tc, tb, prm = fp.spec.n, fp.tc, fp.cells_d[0].numel(), fp.prm(*TAU)
    with torch.no_grad():
        tables = F.tables_of(state.coords, fp)
    occ_ref = F.fused_fwd(tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d, fp.run_start_d,
                          n=n, tc=tc, prm=prm)
    g = loss_cotangent(occ_ref, target)
    dtab_ref = F.fused_bwd(tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d, g, n=n, tc=tc,
                           prm=prm)
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
                                   fp.run_start_d.numel() - 1, tb, tables.shape[1], n, tc,
                                   n * n // tc, *prm, work.data_ptr(), out.data_ptr(), stream)
            assert err == 0, f"{name} B7: CUDA error {err}"

        def b8():
            err = lib.vt_fused_bwd(*ptrs, g.data_ptr(), tables.shape[0], tb, tables.shape[1],
                                   n, tc, n * n // tc, *prm, pre.data_ptr(), dtab.data_ptr(),
                                   stream)
            assert err == 0, f"{name} B8: CUDA error {err}"

        b7()
        b8()
        torch.cuda.synchronize()
        if name in EXACT:
            same = bitwise_equal(out, occ_ref) and bitwise_equal(dtab, dtab_ref)
            ok &= same
            print(f"{name}: B7 and B8 bitwise the wrappers': {same}")
        print(f"{name}: B7 {cuda_ms(b7):.4f} ms, B8 {cuda_ms(b8):.4f} ms", flush=True)
    del fit, state, target, fp, tables, occ_ref, g, dtab_ref, work, pre
    torch.cuda.empty_cache()
    return ok


def time_fragment(libs: dict, n: int) -> bool:
    """B13 fwd and bwd of each soft_vox.cu variant on the cuda-engine
    fit's step 1."""
    fit, state, target = torus_fit(n, "cuda")
    cp = fit.engine_plan
    n, tc, tb = cp.spec.n, cp.tc, cp.cells_d[0].numel()
    vs, _, tau_x = soft_vox.temperatures(cp.spec, *TAU)
    prm = (soft_vox.f32(cp.spec.origin[0]), vs, tau_x)
    with torch.no_grad():
        _, w, x = soft_vox.soft_fragments(state.coords, cp.soft_plan, tau_edge_frac=TAU[0],
                                          tau_x_frac=TAU[1])
        wb, xb = C._Permute.apply(w, x, cp)
    del w, x
    args = (wb, xb, cp.cells_d, cp.batch_tile_d)
    kw = dict(n=n, tc=tc, prm=prm)
    occ_ref = C.fragment_fwd(*args, cp.run_start_d, **kw)
    g = loss_cotangent(occ_ref, target)
    grads_ref = C.fragment_bwd(*args, g, **kw)
    ptrs = tuple(t.data_ptr() for t in args)
    work = torch.empty((cp.cells_d.numel(), 4), dtype=torch.int32, device=g.device)
    pre = torch.empty((n * n, n), dtype=torch.float64, device=g.device)
    stream = _build.stream_of(g)
    ok = True
    for name, lib in libs.items():
        out = torch.zeros_like(occ_ref)
        dw, dx = torch.zeros_like(wb), torch.zeros_like(xb)

        def fwd():
            err = lib.vt_fragment_fwd(*ptrs, cp.run_start_d.data_ptr(), cp.num_batches,
                                      cp.run_start_d.numel() - 1, tb, n, tc, n * n // tc,
                                      *prm, work.data_ptr(), out.data_ptr(), stream)
            assert err == 0, f"{name} B13 fwd: CUDA error {err}"

        def bwd():
            err = lib.vt_fragment_bwd(*ptrs, g.data_ptr(), cp.num_batches, tb, n, tc,
                                      n * n // tc, *prm, pre.data_ptr(), dw.data_ptr(),
                                      dx.data_ptr(), stream)
            assert err == 0, f"{name} B13 bwd: CUDA error {err}"

        fwd()
        bwd()
        torch.cuda.synchronize()
        if name in EXACT:
            same = (bitwise_equal(out, occ_ref) and bitwise_equal(dw, grads_ref[0])
                    and bitwise_equal(dx, grads_ref[1]))
            ok &= same
            print(f"{name}: B13 fwd and bwd bitwise the wrappers': {same}")
        print(f"{name}: B13 fwd {cuda_ms(fwd):.4f} ms, B13 bwd {cuda_ms(bwd):.4f} ms",
              flush=True)
    del fit, state, target, cp, args, wb, xb, occ_ref, g, grads_ref, work, pre
    torch.cuda.empty_cache()
    return ok


def time_seg(libs: dict, n: int) -> bool:
    """B9 and B11 of each soft_vox_seg.cu variant on the seg fit's step 1."""
    fit, state, target = torus_fit(n, "seg")
    sp = fit.engine_plan
    n, tc, tz, tb, prm = sp.spec.n, sp.tc, sp.tz, sp.cells_d[0].numel(), sp.prm(*TAU)
    args = (sp.cells_d, sp.tblidx_d, sp.batch_tile_d, sp.batch_panel_d)
    kw = dict(n=n, tc=tc, tz=tz)
    with torch.no_grad():
        tables = F.tables_of(state.coords, sp)
    parts_ref = S.seg_fwd(tables, *args, sp.run_start_d, prm=prm, **kw)
    g = loss_cotangent(S.seg_combine(*parts_ref, **kw), target)
    gpre = S.seg_gpre(g)
    dtab_ref = S.seg_bwd(tables, *args, g, gpre, prm=prm, **kw)
    ptrs = (tables.data_ptr(), *(t.data_ptr() for t in args))
    work = torch.empty((sp.cells_d.numel(), 4), dtype=torch.int32, device=g.device)
    stream = _build.stream_of(g)
    nt = n * n // tc
    ok = True
    for name, lib in libs.items():
        parts = tuple(torch.zeros_like(p) for p in parts_ref)
        dtab = torch.zeros_like(tables)

        def b9():
            err = lib.vt_seg_fwd(*ptrs, sp.run_start_d.data_ptr(), tables.shape[0],
                                 sp.run_start_d.numel() - 1, tb, tables.shape[1], n, tc, tz,
                                 nt, *prm, work.data_ptr(), *(p.data_ptr() for p in parts),
                                 stream)
            assert err == 0, f"{name} B9: CUDA error {err}"

        def b11():
            err = lib.vt_seg_bwd(*ptrs, g.data_ptr(), gpre.data_ptr(), tables.shape[0], tb,
                                 tables.shape[1], n, tc, tz, nt, *prm, dtab.data_ptr(), stream)
            assert err == 0, f"{name} B11: CUDA error {err}"

        b9()
        b11()
        torch.cuda.synchronize()
        if name in EXACT:
            same = (all(bitwise_equal(x, y) for x, y in zip(parts, parts_ref))
                    and bitwise_equal(dtab, dtab_ref))
            ok &= same
            print(f"{name}: B9 and B11 bitwise the wrappers': {same}")
        print(f"{name}: B9 {cuda_ms(b9):.4f} ms, B11 {cuda_ms(b11):.4f} ms", flush=True)
    return ok


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
        fused = {k: v for k, v in libs.items() if VARIANTS[k][0] == FUSED}
        ok = time_fused(fused, args.n)
        ok &= time_fragment(fused, args.n)
        ok &= time_seg({k: v for k, v in libs.items() if VARIANTS[k][0] == SEG}, args.n)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
