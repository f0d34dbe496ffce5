#!/usr/bin/env python3
"""B7 and B8 on the training path, against their plain versions and an
earlier tree's kernels, on one CUDA card.

    python3 tools/check_fused_window.py [--parent DIR] [--n N]   # from the repository root

The training path of `chip_smoke.py` (phase 6): the 1,348,128-face
rotated torus, its hard grid at N^3 (default 512) as the target, the
start shifted by half a voxel along x plus 0.1 voxel of jitter,
`VoxelFit(engine="fused", refresh_every=4, drift_limit_frac=0.25)`, 5
Adam steps (step 4 refreshes the plan). On step 1's plan and on the
refreshed one, at the coordinates of the moment:

- B7 against `fused_fwd_plain` (limit 1e-4) and B8 against
  `fused_bwd_plain` (limit 1e-3 x max|plain|) for the loss cotangent;
- with `--parent DIR` (an earlier tree, its `voxtpu_torch/csrc/soft_vox.cu`
  built here with nvcc into `voxtpu_torch/csrc/build/` and its entries
  bound with the C signatures of its own `voxtpu_torch/_build.py`: the
  full-row B7 and B8 from before the transition windows, or windowed
  ones that take a work or prefix buffer): B7 bitwise against that
  tree's B7, both trees' errors against the plain versions, whether B8
  is bitwise that tree's (printed: the full-row B8 sums in another
  order), and both trees' B7 and B8 timed in turns (parent, change,
  change, parent; CUDA events, median of 5 each);
- the live slots and the mean window width in columns.

Between the plans, each step's loss, wall time and peak device memory.
Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (GRAD_TOL, MAIN_FACES, OCC_TOL, TAU, TRAIN_LR_VOX,  # noqa: E402
                        bitwise_equal, card_line, cuda_ms, float_err, fused_windows,
                        loss_cotangent, rotated_torus)
from voxtpu_torch import _build  # noqa: E402
from voxtpu_torch.grids.voxel_grid import GridSpec  # noqa: E402
from voxtpu_torch.mesh.mesh import Mesh  # noqa: E402
from voxtpu_torch.models.fit import VoxelFit  # noqa: E402
from voxtpu_torch.ops import soft_vox_fused as F  # noqa: E402
from voxtpu_torch.ops.soft_vox import make_soft_plan  # noqa: E402
from voxtpu_torch.ops.vox import voxelize  # noqa: E402



def parent_signatures(tree: str, entries) -> dict:
    """The C signatures of `entries` as `tree`'s own
    `voxtpu_torch/_build.py` declares them (loaded by path, so that this
    tree's package is not replaced)."""
    path = os.path.join(tree, "voxtpu_torch", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks its module up
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[spec.name]
    return {name: module.SIGNATURES[name] for name in entries}


def windowed(lib, entry: str) -> bool:
    """Whether `lib`'s `entry` takes this tree's C signature (an earlier
    form takes fewer arguments: no work or prefix buffer)."""
    return len(getattr(lib, entry).argtypes) == len(_build.SIGNATURES[entry])


def parent_library(tree: str, source: str = "soft_vox.cu",
                   entries=("vt_fused_fwd", "vt_fused_bwd")) -> ctypes.CDLL:
    """`tree`'s csrc `source` (with the headers beside it), built alone
    with this tree's nvcc flags, its `entries` bound with `tree`'s own C
    signatures."""
    csrc = os.path.join(tree, "voxtpu_torch", "csrc")
    src = os.path.join(csrc, source)
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc)):
        if name == source or name.endswith(".cuh"):
            h.update(open(os.path.join(csrc, name), "rb").read())
    out = _build.BUILD_DIR / f"parent_{source.split('.')[0]}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                               src], capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{done.stderr[-4000:]}")
        print(f"parent {source} built in {time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in parent_signatures(tree, entries).items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def parent_calls(lib, fp, tables, prm):
    """The parent tree's B7 (tables -> occupancy) and B8 ((tables, g)
    -> table cotangents) on plan `fp`, in either C form: full-row (no
    buffers) or windowed (B7 also takes the batch count and a work
    buffer, B8 a prefix buffer)."""
    n, tc = fp.spec.n, fp.tc
    tb = fp.cells_d[0].numel()
    ptrs = (tables.data_ptr(), fp.cells_d.data_ptr(), fp.tblidx_d.data_ptr(),
            fp.batch_tile_d.data_ptr())
    fwd_windowed, bwd_windowed = (windowed(lib, e) for e in ("vt_fused_fwd", "vt_fused_bwd"))

    def check(err):
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")

    def fwd():
        out = torch.zeros((n, n, n), dtype=torch.float32, device=tables.device)
        runs = (fp.run_start_d.data_ptr(),
                *((tables.shape[0],) if fwd_windowed else ()), fp.run_start_d.numel() - 1)
        work = (torch.empty((fp.cells_d.numel(), 4), dtype=torch.int32, device=out.device),
                ) if fwd_windowed else ()
        check(lib.vt_fused_fwd(*ptrs, *runs, tb, tables.shape[1], n, tc, n * n // tc, *prm,
                               *(w.data_ptr() for w in work), out.data_ptr(),
                               _build.stream_of(out)))
        return out

    def bwd(g):
        dtab = torch.zeros_like(tables)
        pre = (torch.empty((n * n, n), dtype=torch.float64, device=g.device),
               ) if bwd_windowed else ()
        check(lib.vt_fused_bwd(*ptrs, g.data_ptr(), tables.shape[0], tb, tables.shape[1], n,
                               tc, n * n // tc, *prm, *(p.data_ptr() for p in pre),
                               dtab.data_ptr(), _build.stream_of(dtab)))
        return dtab

    return fwd, bwd


def check_plan(fp, coords, target, parent, what: str) -> bool:
    """B7 and B8 on plan `fp` at `coords`: errors, parent equality and
    times. Returns whether every check held."""
    prm = fp.prm(*TAU)
    args = (fp.cells_d, fp.tblidx_d, fp.batch_tile_d)
    kw = dict(n=fp.spec.n, tc=fp.tc, prm=prm)
    with torch.no_grad():
        tables = F.tables_of(coords, fp)
    slots, pairs = fused_windows(fp, tables, prm)
    print(f"{what}: {slots:,} live slots in {fp.num_batches:,} batches, mean window "
          f"{pairs / max(slots, 1):.3f} columns of {fp.spec.n}")
    ok = True
    occ = F.fused_fwd(tables, *args, fp.run_start_d, **kw)
    want = F.fused_fwd_plain(tables, *args, **kw)
    e7 = float_err(occ, want)
    ok &= e7 <= OCC_TOL
    g = loss_cotangent(occ, target)
    dtab = F.fused_bwd(tables, *args, g, **kw)
    want8 = F.fused_bwd_plain(tables, *args, g, **kw)
    top = float(want8.abs().max())
    e8 = float_err(dtab, want8)
    ok &= e8 <= GRAD_TOL * top
    line = (f"{what}: B7 max_abs_err {e7:.3e} (limit {OCC_TOL:.0e}); B8 {e8:.3e} "
            f"(limit {GRAD_TOL * top:.3e})")
    calls = {"B7": lambda: F.fused_fwd(tables, *args, fp.run_start_d, **kw),
             "B8": lambda: F.fused_bwd(tables, *args, g, **kw)}
    if parent is not None:
        pfwd, pbwd = parent_calls(parent, fp, tables, prm)
        pocc = pfwd()
        same = bitwise_equal(occ, pocc)
        ok &= same
        pdtab = pbwd(g)
        line += (f"; parent B7 {float_err(pocc, want):.3e}, B8 {float_err(pdtab, want8):.3e};"
                 f" B7 bitwise the parent's: {same}; B8 bitwise the parent's (not "
                 f"required): {bitwise_equal(dtab, pdtab)}")
        del pocc, pdtab
        calls = {"B7": (lambda: pfwd(), calls["B7"]), "B8": (lambda: pbwd(g), calls["B8"])}
    print(line)
    del want, want8
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


def torus_fit(n: int, engine: str = "fused"):
    """Phase 6's fit at n^3 on `engine` before its first step: (fit,
    state, target)."""
    mesh = rotated_torus(MAIN_FACES)
    spec = GridSpec.fit(mesh.coords, n)
    vs = spec.voxel_size
    rng = np.random.default_rng(0)
    start = (mesh.coords + np.float32([0.5 * vs, 0.0, 0.0])
             + rng.normal(0, 0.1 * vs, mesh.coords.shape)).astype(np.float32)
    target = voxelize(mesh, spec, "cuda", device=torch.device("cuda", 0)).to_dense().float()
    plan = make_soft_plan(Mesh(name="start", coords=start, faces=mesh.faces,
                               faces_normals=mesh.faces), spec, pad_window=2)
    fit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine=engine,
                   refresh_every=4, drift_limit_frac=0.25)
    return fit, fit.init(start), target


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an earlier tree (its B7 / B8 full-row or windowed)")
    parser.add_argument("--n", type=int, default=512)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("check_fused_window: no CUDA device is available", file=sys.stderr)
        return 2
    print(card_line())
    parent = parent_library(args.parent) if args.parent else None
    fit, state, target = torus_fit(args.n)
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
    print(f"fused losses {[round(x, 6) for x in losses]}, after the last step {final:.6f}")
    ok &= final < losses[0] and fit.refresh_count == 1
    ok &= check_plan(fit.engine_plan, state.coords, target, parent, f"{args.n}^3 refreshed")
    print("check_fused_window:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
