#!/usr/bin/env python3
"""B9, B10 and B11 on the seg training path, against their plain versions
and an earlier tree's kernels, on one CUDA card.

    python3 tools/check_seg_window.py [--parent DIR] [--n N]   # from the repository root

The training path of `chip_smoke.py` (phase 6) on the seg engine: the
1,348,128-face rotated torus, its hard grid at N^3 (default 512, where
`"auto"` takes the seg engine on a card) as the target, the start
shifted by half a voxel along x plus 0.1 voxel of jitter,
`VoxelFit(engine="seg", refresh_every=4, drift_limit_frac=0.25)`, 5
Adam steps (step 4 refreshes the plan). On step 1's plan and on the
refreshed one, at the coordinates of the moment:

- B9 against `seg_fwd_plain` (out_a, out_b and the carry, limit 1e-4),
  B10 against `seg_combine_plain` (bitwise) and B11 against
  `seg_bwd_plain` (limit 1e-3 x max|plain|) for the loss cotangent;
- with `--parent DIR` (an earlier tree, its
  `voxtpu_torch/csrc/soft_vox_seg.cu` built here with nvcc into
  `voxtpu_torch/csrc/build/` and bound with the C signatures of its own
  `voxtpu_torch/_build.py`: the whole-panel B9 and B11, or windowed ones
  whose B9 takes a work buffer): B9's out_a, out_b and carry and B10's
  grid bitwise against that tree's, both trees' B11 errors against the
  plain version, and both trees' B9, B10 (with the carry prefix in
  torch ops, as the wrapper computes it) and B11 timed in turns
  (parent, change, change, parent; CUDA events, median of 5 each);
- the live slots and the mean window clipped to the panel, in columns.

Between the plans, each step's loss, wall time and peak device memory.
Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (GRAD_TOL, OCC_TOL, TAU, bitwise_equal, card_line,  # noqa: E402
                        cuda_ms, float_err, loss_cotangent, seg_windows)
from tools.check_fused_window import parent_library, torus_fit, windowed  # noqa: E402
from voxtpu_torch import _build  # noqa: E402
from voxtpu_torch.ops import soft_vox_seg as S  # noqa: E402
from voxtpu_torch.ops.soft_vox_fused import tables_of  # noqa: E402

def parent_calls(lib, sp, tables, prm):
    """The parent tree's B9 (tables -> out_a, out_b, carry), B10 ((out_a,
    out_b, carry) -> the grid, on the carry prefix) and B11 ((tables, g,
    gpre) -> table cotangents) on plan `sp`; a windowed B9 also takes the
    batch count and a work buffer."""
    n, tc, tz = sp.spec.n, sp.tc, sp.tz
    tb, nt = sp.cells_d[0].numel(), n * n // tc
    ptrs = (tables.data_ptr(), sp.cells_d.data_ptr(), sp.tblidx_d.data_ptr(),
            sp.batch_tile_d.data_ptr(), sp.batch_panel_d.data_ptr())
    fwd_windowed = windowed(lib, "vt_seg_fwd")

    def check(err):
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")

    def fwd():
        out_a = torch.zeros((nt, n // S.PANEL, tc, S.PANEL), dtype=torch.float32,
                            device=tables.device)
        out_b = torch.zeros_like(out_a)
        carry = torch.zeros((nt, n // S.LATTICE, tc), dtype=torch.float32,
                            device=tables.device)
        runs = (sp.run_start_d.data_ptr(),
                *((tables.shape[0],) if fwd_windowed else ()), sp.run_start_d.numel() - 1)
        work = (torch.empty((sp.cells_d.numel(), 4), dtype=torch.int32, device=out_a.device),
                ) if fwd_windowed else ()
        check(lib.vt_seg_fwd(*ptrs, *runs, tb, tables.shape[1], n, tc, tz, nt, *prm,
                             *(w.data_ptr() for w in work), out_a.data_ptr(),
                             out_b.data_ptr(), carry.data_ptr(), _build.stream_of(out_a)))
        return out_a, out_b, carry

    def combine(out_a, out_b, carry):
        pre = S.carry_prefix(carry).contiguous()
        out = torch.empty((n, n, n), dtype=torch.float32, device=out_a.device)
        check(lib.vt_seg_combine(out_a.data_ptr(), out_b.data_ptr(), pre.data_ptr(), n, tc,
                                 tz, out.data_ptr(), _build.stream_of(out)))
        return out

    def bwd(g, gpre):
        dtab = torch.zeros_like(tables)
        check(lib.vt_seg_bwd(*ptrs, g.data_ptr(), gpre.data_ptr(), tables.shape[0], tb,
                             tables.shape[1], n, tc, tz, nt, *prm, dtab.data_ptr(),
                             _build.stream_of(dtab)))
        return dtab

    return fwd, combine, bwd


def check_plan(sp, coords, target, parent, what: str) -> bool:
    """B9, B10 and B11 on seg plan `sp` at `coords`: errors, parent
    equality and times. Returns whether every check held."""
    prm = sp.prm(*TAU)
    args = (sp.cells_d, sp.tblidx_d, sp.batch_tile_d, sp.batch_panel_d)
    kw = dict(n=sp.spec.n, tc=sp.tc, tz=sp.tz, prm=prm)
    with torch.no_grad():
        tables = tables_of(coords, sp)
    slots, pairs = seg_windows(sp, tables, prm)
    print(f"{what}: {slots:,} live slots in {sp.num_batches:,} batches ({sp.num_runs:,} "
          f"runs), mean clipped window {pairs / max(slots, 1):.3f} columns of {S.PANEL}")
    ok = True
    parts = S.seg_fwd(tables, *args, sp.run_start_d, **kw)
    want = S.seg_fwd_plain(tables, *args, **kw)
    e9 = max(float_err(x, y) for x, y in zip(parts, want))
    ok &= e9 <= OCC_TOL
    del want
    ckw = dict(n=sp.spec.n, tc=sp.tc, tz=sp.tz)
    occ = S.seg_combine(*parts, **ckw)
    same10 = bitwise_equal(occ, S.seg_combine_plain(*parts, **ckw))
    ok &= same10
    g = loss_cotangent(occ, target)
    gpre = S.seg_gpre(g)
    dtab = S.seg_bwd(tables, *args, g, gpre, **kw)
    want11 = S.seg_bwd_plain(tables, *args, g, gpre, **kw)
    top = float(want11.abs().max())
    e11 = float_err(dtab, want11)
    ok &= e11 <= GRAD_TOL * top
    line = (f"{what}: B9 max_abs_err {e9:.3e} (limit {OCC_TOL:.0e}); B10 bitwise the plain "
            f"version: {same10}; B11 {e11:.3e} (limit {GRAD_TOL * top:.3e})")
    calls = {"B9": lambda: S.seg_fwd(tables, *args, sp.run_start_d, **kw),
             "B10": lambda: S.seg_combine(*parts, **ckw),
             "B11": lambda: S.seg_bwd(tables, *args, g, gpre, **kw)}
    if parent is not None:
        pfwd, pcombine, pbwd = parent_calls(parent, sp, tables, prm)
        pparts = pfwd()
        same = all(bitwise_equal(x, y) for x, y in zip(parts, pparts))
        same10 = bitwise_equal(occ, pcombine(*parts))
        ok &= same and same10
        pe11 = float_err(pbwd(g, gpre), want11)
        line += (f"; parent B11 {pe11:.3e}; B9 (out_a, out_b, carry) bitwise the "
                 f"parent's: {same}; B10 bitwise the parent's: {same10}")
        del pparts
        calls = {"B9": (pfwd, calls["B9"]), "B10": (lambda: pcombine(*parts), calls["B10"]),
                 "B11": (lambda: pbwd(g, gpre), calls["B11"])}
    print(line)
    del want11, occ
    torch.cuda.empty_cache()
    for key, fns in calls.items():
        if parent is None:
            print(f"{what}: {key} {cuda_ms(fns):.4f} ms")
            continue
        old, new = fns
        t = [cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)]
        print(f"{what}: {key} parent {t[0]:.4f} / {t[3]:.4f} ms, change {t[1]:.4f} / "
              f"{t[2]:.4f} ms")
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent",
                        help="an earlier tree (its B9 / B11 whole-panel or windowed)")
    parser.add_argument("--n", type=int, default=512)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("check_seg_window: no CUDA device is available", file=sys.stderr)
        return 2
    print(card_line())
    parent = (parent_library(args.parent, "soft_vox_seg.cu",
                             ("vt_seg_fwd", "vt_seg_combine", "vt_seg_bwd"))
              if args.parent else None)
    fit, state, target = torus_fit(args.n, "seg")
    ok = check_plan(fit.engine_plan, state.coords, target, parent, f"{args.n}^3 step 1")
    losses = []
    for i in range(5):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = fit.step(state)
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        print(f"step {i + 1}: loss {losses[-1]:.6f}, wall {time.perf_counter() - t0:.4f} s, "
              f"refreshes {fit.refresh_count}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    with torch.no_grad():
        final = float(fit.loss(state.coords))
    print(f"seg losses {[round(x, 6) for x in losses]}, after the last step {final:.6f}")
    ok &= final < losses[0] and fit.refresh_count == 1
    ok &= check_plan(fit.engine_plan, state.coords, target, parent, f"{args.n}^3 refreshed")
    print("check_seg_window:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
