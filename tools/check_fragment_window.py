#!/usr/bin/env python3
"""B13 fwd and bwd on the training path, against their plain versions and
an earlier tree's kernels, on one CUDA card.

    python3 tools/check_fragment_window.py [--parent DIR] [--n N]   # from the repository root

The training path of `chip_smoke.py` (phase 6) on the per-fragment
("cuda") engine: the 1,348,128-face rotated torus, its hard grid at N^3
(default 512) as the target, the start shifted by half a voxel along x
plus 0.1 voxel of jitter, `VoxelFit(engine="cuda", refresh_every=4,
drift_limit_frac=0.25)`, 5 Adam steps (step 4 refreshes the plan). On
step 1's plan and on the refreshed one, at the coordinates of the
moment, with each slot's (w, x_hit) from `soft_fragments`:

- B13 fwd against `fragment_fwd_plain` (limit 1e-4) and B13 bwd against
  `fragment_bwd_plain` (dw and dx_hit, limit 1e-3 x max|plain|) for the
  loss cotangent;
- with `--parent DIR` (an earlier tree, its `voxtpu_torch/csrc/soft_vox.cu`
  built here with nvcc into `voxtpu_torch/csrc/build/` and bound with
  the C signatures of its own `voxtpu_torch/_build.py`: the full-row
  B13, or a windowed one that takes a work and a prefix buffer): B13
  fwd bitwise against that tree's, both trees' B13 bwd errors against
  the plain version, and both trees' B13 fwd and bwd timed in turns
  (parent, change, change, parent; CUDA events, median of 5 each);
- the live slots and the mean window width in columns.

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
                        cuda_ms, float_err, loss_cotangent, window_widths)
from tools.check_fused_window import parent_library, torus_fit, windowed  # noqa: E402
from voxtpu_torch import _build  # noqa: E402
from voxtpu_torch.ops import soft_vox  # noqa: E402
from voxtpu_torch.ops import soft_vox_cuda as C  # noqa: E402


def fragment_inputs(cp, coords):
    """((wb, xb, cells_b, batch_tile), (ox, vs, tau_x)): the slots of
    plan `cp` at `coords`, as the cuda engine's forward lays them out."""
    spec = cp.spec
    vs, _, tau_x = soft_vox.temperatures(spec, *TAU)
    with torch.no_grad():
        _, w, x = soft_vox.soft_fragments(coords, cp.soft_plan, tau_edge_frac=TAU[0],
                                          tau_x_frac=TAU[1])
        wb, xb = C._Permute.apply(w, x, cp)
    return (wb, xb, cp.cells_d, cp.batch_tile_d), (soft_vox.f32(spec.origin[0]), vs, tau_x)


def parent_calls(lib, cp, args, prm):
    """The parent tree's B13 fwd (-> occupancy) and bwd (g -> (dw,
    dx_hit)) on plan `cp`'s slots `args`, in either C form: full-row (no
    buffers) or windowed (the forward also takes the batch count and a
    work buffer, the backward a prefix buffer)."""
    n, tc, tb = cp.spec.n, cp.tc, cp.cells_d[0].numel()
    wb = args[0]
    ptrs = tuple(t.data_ptr() for t in args)
    fwd_windowed, bwd_windowed = (windowed(lib, e)
                                  for e in ("vt_fragment_fwd", "vt_fragment_bwd"))

    def check(err):
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")

    def fwd():
        out = torch.zeros((n, n, n), dtype=torch.float32, device=wb.device)
        runs = (cp.run_start_d.data_ptr(), *((cp.num_batches,) if fwd_windowed else ()),
                cp.run_start_d.numel() - 1)
        work = (torch.empty((cp.cells_d.numel(), 4), dtype=torch.int32, device=wb.device),
                ) if fwd_windowed else ()
        check(lib.vt_fragment_fwd(*ptrs, *runs, tb, n, tc, n * n // tc, *prm,
                                  *(w.data_ptr() for w in work), out.data_ptr(),
                                  _build.stream_of(out)))
        return out

    def bwd(g):
        dw, dx = torch.zeros_like(wb), torch.zeros_like(wb)
        pre = (torch.empty((n * n, n), dtype=torch.float64, device=g.device),
               ) if bwd_windowed else ()
        check(lib.vt_fragment_bwd(*ptrs, g.data_ptr(), cp.num_batches, tb, n, tc,
                                  n * n // tc, *prm, *(p.data_ptr() for p in pre),
                                  dw.data_ptr(), dx.data_ptr(), _build.stream_of(dw)))
        return dw, dx

    return fwd, bwd


def check_plan(cp, coords, target, parent, what: str) -> bool:
    """B13 fwd and bwd on plan `cp` at `coords`: errors, parent equality
    and times. Returns whether every check held."""
    args, prm = fragment_inputs(cp, coords)
    kw = dict(n=cp.spec.n, tc=cp.tc, prm=prm)
    live = cp.cells_d.reshape(-1) >= 0
    xl = args[1].reshape(-1)[live]
    ok_win = (args[0].reshape(-1)[live].abs() <= 1) & torch.isfinite(xl)
    slots = int(live.sum())
    pairs = int(window_widths(xl, ok_win, cp.spec.n, prm[0], prm[1], prm[2]).sum())
    print(f"{what}: {slots:,} live slots in {cp.num_batches:,} batches, mean window "
          f"{pairs / max(slots, 1):.3f} columns of {cp.spec.n}")
    ok = True
    occ = C.fragment_fwd(*args, cp.run_start_d, **kw)
    want = C.fragment_fwd_plain(*args, **kw)
    ef = float_err(occ, want)
    ok &= ef <= OCC_TOL
    g = loss_cotangent(occ, target)
    grads = C.fragment_bwd(*args, g, **kw)
    wants = C.fragment_bwd_plain(*args, g, **kw)
    tops = [float(w.abs().max()) for w in wants]
    errs = [float_err(x, y) for x, y in zip(grads, wants)]
    ok &= all(e <= GRAD_TOL * t for e, t in zip(errs, tops))
    line = (f"{what}: B13 fwd max_abs_err {ef:.3e} (limit {OCC_TOL:.0e}); B13 bwd dw "
            f"{errs[0]:.3e} (limit {GRAD_TOL * tops[0]:.3e}), dx_hit {errs[1]:.3e} (limit "
            f"{GRAD_TOL * tops[1]:.3e})")
    calls = {"B13 fwd": lambda: C.fragment_fwd(*args, cp.run_start_d, **kw),
             "B13 bwd": lambda: C.fragment_bwd(*args, g, **kw)}
    if parent is not None:
        pfwd, pbwd = parent_calls(parent, cp, args, prm)
        pocc = pfwd()
        same = bitwise_equal(occ, pocc)
        ok &= same
        perrs = [float_err(x, y) for x, y in zip(pbwd(g), wants)]
        line += (f"; parent B13 fwd {float_err(pocc, want):.3e}, bwd dw {perrs[0]:.3e}, "
                 f"dx_hit {perrs[1]:.3e}; B13 fwd bitwise the parent's: {same}")
        del pocc
        calls = {"B13 fwd": (pfwd, calls["B13 fwd"]),
                 "B13 bwd": (lambda: pbwd(g), calls["B13 bwd"])}
    print(line)
    del want, wants, grads
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
    parser.add_argument("--parent", help="an earlier tree (its B13 full-row or windowed)")
    parser.add_argument("--n", type=int, default=512)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("check_fragment_window: no CUDA device is available", file=sys.stderr)
        return 2
    print(card_line())
    entries = ("vt_fragment_fwd", "vt_fragment_bwd")
    parent = parent_library(args.parent, "soft_vox.cu", entries) if args.parent else None
    fit, state, target = torus_fit(args.n, "cuda")
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
    print(f"cuda losses {[round(x, 6) for x in losses]}, after the last step {final:.6f}")
    ok &= final < losses[0] and fit.refresh_count == 1
    ok &= check_plan(fit.engine_plan, state.coords, target, parent, f"{args.n}^3 refreshed")
    print("check_fragment_window:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
