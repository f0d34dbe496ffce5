#!/usr/bin/env python3
"""Smoke run of voxtpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code
and no result line:

1. Device: a CUDA device must exist; prints the card's name and power
   limit as nvidia-smi reports them.
2. Build: compiles the kernels from voxtpu_torch/csrc with nvcc for
   sm_90a and prints the build time and ptxas's resource report.
3. Kernels against their plain torch versions on the card, exact:
   B1 (banded fill) on an icosphere at n=128, band=64; B2 (whole-axis
   fill) through the pipeline on the icosahedron at n=192, band=64, and
   on live random slots; B3 (flood step) at every stride of n=128; B5
   (signed distance) at n=128; and at n=64 the NumPy oracle
   (voxelize_ref, jfa_ref) as a third witness.
4. Main path at the reference's benchmark scale: two washers of
   1,348,128 faces each (the second one shifted), written as OBJ files
   and run through `voxtpu_torch.cli` at 512^3 (vox -> CSG union ->
   JFA SDF -> export). The launch counts of the run must show every
   kernel; the folded grid must equal the plain pipeline on the card
   (xor popcount 0) and the SDF the plain flood (bitwise, inf == inf).
   Then each kernel is timed beside its plain version at these shapes
   (CUDA events, warm, median of 5). The washers' wide slots are all
   inert (an x-parallel cap covers no cell centre), so B2 is also timed
   on random live slots of the same shape and tiles.
5. Training kernels against their plain torch versions at n=128 on a
   jittered icosphere(4), soft plan with pad 2: B7 (fused forward)
   occupancy within 1e-4; B8 (fused backward) table cotangents for a
   seeded random cotangent, B13 fwd / bwd (per-fragment engine) on the
   same plan, and the coordinate gradient of soft_iou_loss through the
   fused and cuda engines on the card against the same engines on the
   CPU (the kernels' plain versions), each within 1e-3 x max|plain|.
6. Training path: `VoxelFit(engine="fused")` takes 5 Adam steps at
   512^3 on a torus brought to 1,348,128 faces and rotated; the target
   is its hard grid through the serving path (B1, B2 where the mesh has
   x-degenerate candidates); the start is shifted by half a voxel along
   x plus 0.1 voxel of seeded jitter; refresh_every=4 with a drift
   limit of half a voxel, so step 4 rebuilds the plan at full size.
   Each step prints loss, grad norm, wall time and launch counts; the
   first also holds B7 / B8 against their plain versions at full size
   and times them (CUDA events, warm, median of 3). The loss must fall
   and B1, B7, B8 launch (and B2 if the target routed candidates to it;
   the rotated torus has no x-degenerate face, so it routes none). After
   the last step all four training kernels are held again on the
   refreshed plan, the densest of the path, within the same limits. Then
   `VoxelFit(engine="cuda")` takes 2 steps from the same start on the
   same plan: B13 fwd / bwd are held and timed as B7 / B8 were, and its
   first loss must equal the fused engine's within 1e-4 relative.
   The kernel table's launches are phase 4's for B1-B5 and this
   phase's for B7, B8 and B13.
7. `python -m voxtpu_torch.examples.fit_vertices --n 64 --steps 10
   --engine fused` on an OBJ written here must exit 0 with an improved
   hard IoU.
8. Prints each kernel's largest error as a share of its limit, the
   kernel table as one JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of jax or voxtpu.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_N = 512
MAIN_FACES = 1_348_128  # the reference's benchmark mesh (BASELINE.md)
KERNEL_N = 128          # phase 5's grid
TRAIN_STEPS = 5
CUDA_STEPS = 2          # the per-fragment engine's steps, from the same start
TRAIN_LR_VOX = 0.25     # Adam's learning rate, in voxels
TAU = (0.5, 0.5)        # VoxelFit's default (tau_edge_frac, tau_x_frac)
OCC_TOL = 1e-4          # occupancy, absolute
GRAD_TOL = 1e-3         # cotangents and gradients, times max|plain|


class SmokeFailure(Exception):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def int_err(a, b) -> int:
    """Max |a - b| over two integer tensors (0 iff equal)."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def float_err(a, b) -> float:
    """Max |a - b| with inf == inf; inf where only one side is inf."""
    import torch

    require(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a[~same] - b[~same]).abs().max())


def bitwise_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def rotation(ax: float, ay: float, az: float):
    """Rz(az) @ Ry(ay) @ Rx(ax), float64."""
    import numpy as np

    cx, sx, cy, sy, cz, sz = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                              np.cos(az), np.sin(az))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


@contextlib.contextmanager
def uncounted(*fns):
    """Launches inside are checks and timings, not the path's own: the
    wrappers' counts are put back as they were."""
    saved = [fn.launches for fn in fns]
    try:
        yield
    finally:
        for fn, count in zip(fns, saved):
            fn.launches = count


def hold(errs, key: str, got, want, tol: float, what: str) -> float:
    """Record max |got - want| under `key`, and its largest share of the
    limit under (key, "/tol"); require it <= tol."""
    err = float_err(got, want)
    errs[key] = max(errs.get(key, 0.0), err)
    errs[key, "/tol"] = max(errs.get((key, "/tol"), 0.0), err / tol)
    require(err <= tol, f"{what}: max |kernel - plain| {err:.3e} > {tol:.3e}")
    return err


def loss_cotangent(occ, target):
    """d soft_iou_loss(clip01(occ), target) / d occ, the cotangent that
    the engines' backward kernels receive in a VoxelFit step."""
    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox import clip01

    leaf = occ.detach().requires_grad_(True)
    soft_iou_loss(clip01(leaf), target).backward()
    return leaf.grad


def hold_fused(fp, tables, g, errs, what: str):
    """B7 and B8 against their plain versions on one plan's tables and
    cotangent `g` (a tensor, or a function of B7's occupancy). Returns
    the four calls for timing: (B7, B7 plain, B8, B8 plain)."""
    import torch

    from voxtpu_torch.ops import soft_vox_fused as F

    args = (tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d)
    kw = dict(n=fp.spec.n, tc=fp.tc, prm=fp.prm(*TAU))
    occ = F.fused_fwd(*args, fp.run_start_d, **kw)
    want = F.fused_fwd_plain(*args, **kw)
    require(bool(torch.isfinite(occ).all()), f"B7 {what}: non-finite occupancy")
    require(float(want.max()) > 0.5, f"B7 {what}: the plain occupancy is empty")
    e7 = hold(errs, "B7", occ, want, OCC_TOL, f"B7 {what}")
    g = g(occ) if callable(g) else g
    dtab = F.fused_bwd(*args, g, **kw)
    want = F.fused_bwd_plain(*args, g, **kw)
    top = float(want.abs().max())
    e8 = hold(errs, "B8", dtab, want, GRAD_TOL * top, f"B8 {what}")
    print(f"B7 {what}: max_abs_err {e7:.3e} (limit {OCC_TOL:.0e}); B8: {e8:.3e} "
          f"(max |plain| {top:.3e}, limit {GRAD_TOL * top:.3e})")
    return (lambda: F.fused_fwd(*args, fp.run_start_d, **kw),
            lambda: F.fused_fwd_plain(*args, **kw),
            lambda: F.fused_bwd(*args, g, **kw),
            lambda: F.fused_bwd_plain(*args, g, **kw))


def hold_fragment(cp, coords, g, errs, what: str):
    """B13 fwd and bwd against their plain versions on the per-fragment
    engine's slots of `coords`; `g` as in `hold_fused`. Returns the four
    calls for timing."""
    import torch

    from voxtpu_torch.ops import soft_vox, soft_vox_cuda as C

    spec = cp.spec
    vs, _, tau_x = soft_vox.temperatures(spec, *TAU)
    with torch.no_grad():
        _, w, x = soft_vox.soft_fragments(coords, cp.soft_plan, tau_edge_frac=TAU[0],
                                          tau_x_frac=TAU[1])
        wb, xb = C._Permute.apply(w, x, cp)
    args = (wb, xb, cp.cells_d, cp.batch_tile_d)
    kw = dict(n=spec.n, tc=cp.tc, prm=(soft_vox.f32(spec.origin[0]), vs, tau_x))
    occ = C.fragment_fwd(*args, cp.run_start_d, **kw)
    want = C.fragment_fwd_plain(*args, **kw)
    require(float(want.max()) > 0.5, f"B13 fwd {what}: the plain occupancy is empty")
    ef = hold(errs, "B13f", occ, want, OCC_TOL, f"B13 fwd {what}")
    g = g(occ) if callable(g) else g
    bwd = []
    for name, got, want in zip(("dw", "dx_hit"), C.fragment_bwd(*args, g, **kw),
                               C.fragment_bwd_plain(*args, g, **kw)):
        top = float(want.abs().max())
        err = hold(errs, "B13b", got, want, GRAD_TOL * top, f"B13 bwd {name} {what}")
        bwd.append(f"{name} {err:.3e} (max |plain| {top:.3e}, limit {GRAD_TOL * top:.3e})")
    print(f"B13 fwd {what}: max_abs_err {ef:.3e} (limit {OCC_TOL:.0e}); B13 bwd: "
          + "; ".join(bwd))
    return (lambda: C.fragment_fwd(*args, cp.run_start_d, **kw),
            lambda: C.fragment_fwd_plain(*args, **kw),
            lambda: C.fragment_bwd(*args, g, **kw),
            lambda: C.fragment_bwd_plain(*args, g, **kw))


def soft_case(n: int, level: int = 4):
    """A jittered icosphere (1e-3, numpy seed n) and its soft plan at n,
    pad 2."""
    import numpy as np

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.soft_vox import make_soft_plan

    c, f = procedural.icosphere(level, center=(0.1, -0.2, 0.3))
    c = (c + np.random.default_rng(n).normal(0, 1e-3, c.shape)).astype(np.float32)
    mesh = Mesh(name="icosphere", coords=c, faces=f, faces_normals=f)
    return mesh, make_soft_plan(mesh, GridSpec.fit(c, n), pad_window=2)


def check_training_kernels(dev, errs, n: int = KERNEL_N) -> None:
    """Phase 5: B7, B8, B13 fwd / bwd against their plain versions, and
    the coordinate gradient of soft_iou_loss through the kernel engines
    against the plain engine, at n on a jittered icosphere(4)."""
    import numpy as np
    import torch

    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox import soft_voxelize
    from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
    from voxtpu_torch.ops.soft_vox_fused import (FusedSoftPlan, soft_voxelize_fused,
                                                 tables_of)
    from voxtpu_torch.ops.vox import voxelize

    mesh, sp = soft_case(n)
    coords = torch.from_numpy(mesh.coords).to(dev)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((n, n, n)).astype(
        np.float32)).to(dev)
    fp = FusedSoftPlan(sp, dev)
    with torch.no_grad():
        tables = tables_of(coords, fp)
    hold_fused(fp, tables, g, errs, f"n={n}")
    cp = SoftCudaPlan(sp, dev)
    hold_fragment(cp, coords, g, errs, f"n={n}")
    print(f"n={n}: {len(mesh.faces)} faces, {fp.num_fragments} fused slots in "
          f"{fp.num_batches} batches, {cp.num_fragments} fragment slots in "
          f"{cp.num_batches} batches")

    # The coordinate gradient of soft_iou_loss through each kernel engine
    # on the card, against the same engine on the CPU, where its wrappers
    # take the kernels' plain versions. The plain engine is a third
    # witness: the fused engine distributes x_hit's division over its
    # coefficients, so it differs from the other two by float32 rounding.
    target = voxelize(mesh, sp.spec, "cuda", device=dev).to_dense().float()
    cpu = torch.device("cpu")

    def coord_grad(fwd, plan, device):
        x = coords.to(device).clone().requires_grad_(True)
        soft_iou_loss(fwd(x, plan, tau_edge_frac=TAU[0], tau_x_frac=TAU[1]),
                      target.to(device)).backward()
        return x.grad.to(dev)

    plain = coord_grad(soft_voxelize, sp, dev)
    for name, fwd, on_card, on_cpu in (
            ("fused", soft_voxelize_fused, fp, FusedSoftPlan(sp, cpu)),
            ("cuda", soft_voxelize_cuda, cp, SoftCudaPlan(sp, cpu))):
        want = coord_grad(fwd, on_cpu, cpu)
        scale = float(want.abs().max())
        require(scale > 0, f"the {name} engine's coordinate gradient is zero")
        got = coord_grad(fwd, on_card, dev)
        err = float_err(got, want)
        require(err <= GRAD_TOL * scale, f"{name} engine's coordinate gradient: "
                f"{err:.3e} > {GRAD_TOL} x {scale:.3e}")
        print(f"coordinate gradient of soft_iou_loss, {name} engine: kernels vs plain "
              f"versions max_abs_err {err:.3e} (max |plain| {scale:.3e}); vs the plain "
              f"engine {float_err(got, plain):.3e}")


def rotated_torus(faces: int):
    """Phase 6's mesh: a torus brought to `faces` faces, turned by a
    fixed rotation off every axis (no face x-parallel)."""
    import numpy as np

    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh

    c, f = procedural.torus(1.0, 0.35, 48, 24)
    c, f = procedural.subdivide_to(c, f, faces)
    require(len(f) == faces, "face count")
    c = (c.astype(np.float64) @ rotation(0.3, 0.5, 0.7).T).astype(np.float32)
    return Mesh(name="torus", coords=c, faces=f, faces_normals=f)


def training_path(dev, errs, timings, n: int = MAIN_N, faces: int = MAIN_FACES):
    """Phase 6: VoxelFit(engine="fused") at n on a rotated torus of
    `faces` faces for TRAIN_STEPS Adam steps (one plan refresh), then
    VoxelFit(engine="cuda") for CUDA_STEPS steps from the same start.
    Returns the launch counts of the two runs (B1 and B2 for the target,
    B7 and B8 for the fused fit, B13 for the other)."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.fit import VoxelFit
    from voxtpu_torch.ops import soft_vox_cuda, soft_vox_fused, vox_cuda, vox_slots_banded
    from voxtpu_torch.ops.soft_vox import make_soft_plan
    from voxtpu_torch.ops.soft_vox_fused import tables_of
    from voxtpu_torch.ops.vox import voxelize

    B1, B2 = vox_slots_banded.banded_fill, vox_cuda.wide_fill
    B7, B8 = soft_vox_fused.fused_fwd, soft_vox_fused.fused_bwd
    B13F, B13B = soft_vox_cuda.fragment_fwd, soft_vox_cuda.fragment_bwd
    every = (B1, B2, B7, B8, B13F, B13B)

    t0 = time.perf_counter()
    mesh = rotated_torus(faces)
    spec = GridSpec.fit(mesh.coords, n)
    vs = spec.voxel_size
    rng = np.random.default_rng(0)
    start = (mesh.coords + np.float32([0.5 * vs, 0.0, 0.0])
             + rng.normal(0, 0.1 * vs, mesh.coords.shape)).astype(np.float32)
    print(f"torus: {faces:,} faces, {len(mesh.coords):,} vertices, n={n}, voxel "
          f"{vs:.6g}; made in {time.perf_counter() - t0:.1f} s")

    for fn in every:
        fn.launches = 0
    t0 = time.perf_counter()
    pipe = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev)
    target = voxelize(mesh, spec, "cuda", device=dev, plan=pipe).to_dense().float()
    torch.cuda.synchronize()
    occupied = int(target.sum())
    require(0 < occupied < n ** 3, f"target occupancy {occupied}")
    print(f"target: {occupied:,} voxels through the serving path in "
          f"{time.perf_counter() - t0:.1f} s; {pipe.num_wide} wide candidates")

    t0 = time.perf_counter()
    plan = make_soft_plan(Mesh(name="start", coords=start, faces=mesh.faces,
                               faces_normals=mesh.faces), spec, pad_window=2)
    t1 = time.perf_counter()
    fit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine="fused",
                   refresh_every=4, drift_limit_frac=0.25)
    t2 = time.perf_counter()
    fp = fit.engine_plan
    print(f"plan: make_soft_plan {t1 - t0:.1f} s ({plan.num_fragments:,} candidate "
          f"fragments), FusedSoftPlan {t2 - t1:.1f} s ({fp.num_fragments:,} slots in "
          f"{fp.num_batches:,} batches of {fp.cells_b[0].size}, {fp.num_pairs:,} "
          f"table rows)")
    state = fit.init(start)

    # Step 1's inputs: B7 and B8 against their plain versions at full
    # size, and their times (not counted as the path's launches).
    with uncounted(*every):
        with torch.no_grad():
            tables = tables_of(state.coords, fp)
        calls = hold_fused(fp, tables, lambda occ: loss_cotangent(occ, target), errs,
                           f"{n}^3")
        timings["B7"] = (cuda_ms(calls[0], reps=3), cuda_ms(calls[1], reps=3))
        timings["B8"] = (cuda_ms(calls[2], reps=3), cuda_ms(calls[3], reps=3))
        del tables, calls
    for key in ("B7", "B8"):
        print(f"{key} at {n}^3: kernel {timings[key][0]:.3f} ms, plain "
              f"{timings[key][1]:.3f} ms")

    losses = []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = fit.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        require(np.isfinite(loss) and np.isfinite(gnorm), f"step {i + 1}: non-finite")
        losses.append(loss)
        print(f"step {i + 1}: loss {loss:.6f}, grad norm {gnorm:.6g}, drift "
              f"{float(m['max_drift_vox']):.3f} vox, wall {wall:.3f} s, refreshes "
              f"{fit.refresh_count}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB; launches B1 {B1.launches} B2 {B2.launches} B7 {B7.launches} "
              f"B8 {B8.launches}")
    with torch.no_grad():
        final = float(fit.loss(state.coords))
    launches = {"B1": B1.launches, "B2": B2.launches, "B7": B7.launches,
                "B8": B8.launches}
    print(f"loss {losses[0]:.6f} before the first step, {final:.6f} after the last; "
          f"launches {launches}")
    require(final < losses[0], "the fused fit's loss did not fall")
    require(fit.refresh_count == 1, f"{fit.refresh_count} plan refreshes, expected 1")
    for key in ("B1", "B7", "B8") + (("B2",) if pipe.num_wide else ()):
        require(launches[key] > 0, f"the training path never launched {key}")
    require(launches["B7"] == TRAIN_STEPS + 1 and launches["B8"] == TRAIN_STEPS,
            "B7 / B8: one launch each per step, and B7 once for the final loss")

    # Step 4's refresh made the densest plan of the path: the four
    # kernels are held on it too, at the last coordinates.
    with uncounted(*every):
        with torch.no_grad():
            tables = tables_of(state.coords, fit.engine_plan)
        hold_fused(fit.engine_plan, tables, lambda occ: loss_cotangent(occ, target),
                   errs, f"{n}^3 refreshed")
        del tables
        t0 = time.perf_counter()
        rp = soft_vox_cuda.SoftCudaPlan(fit.plan, dev)
        print(f"refreshed plan: {fit.engine_plan.num_fragments:,} fused slots, "
              f"{rp.num_fragments:,} fragment slots (SoftCudaPlan "
              f"{time.perf_counter() - t0:.1f} s)")
        hold_fragment(rp, state.coords, lambda occ: loss_cotangent(occ, target), errs,
                      f"{n}^3 refreshed")
        del rp
        torch.cuda.empty_cache()

    # The per-fragment engine (B13) from the same start on the same
    # plan: B13 held and timed at the shapes B7 / B8 were, then its own
    # steps, whose first loss is the fused engine's first.
    for fn in every:
        fn.launches = 0
    t0 = time.perf_counter()
    cfit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine="cuda",
                    refresh_every=0)
    cp = cfit.engine_plan
    print(f"SoftCudaPlan {time.perf_counter() - t0:.1f} s ({cp.num_fragments:,} "
          f"fragment slots in {cp.num_batches:,} batches)")
    cstate = cfit.init(start)
    with uncounted(*every):
        calls = hold_fragment(cp, cstate.coords, lambda occ: loss_cotangent(occ, target),
                              errs, f"{n}^3")
        timings["B13f"] = (cuda_ms(calls[0], reps=3), cuda_ms(calls[1], reps=3))
        timings["B13b"] = (cuda_ms(calls[2], reps=3), cuda_ms(calls[3], reps=3))
        del calls
    for key, name in (("B13f", "B13 fwd"), ("B13b", "B13 bwd")):
        print(f"{name} at {n}^3: kernel {timings[key][0]:.3f} ms, plain "
              f"{timings[key][1]:.3f} ms")
    closs = []
    for i in range(CUDA_STEPS):
        t0 = time.perf_counter()
        cstate, m = cfit.step(cstate)
        torch.cuda.synchronize()
        closs.append(float(m["loss"]))
        require(np.isfinite(closs[-1]), f"cuda engine step {i + 1}: non-finite loss")
        print(f"cuda engine step {i + 1}: loss {closs[-1]:.6f}, wall "
              f"{time.perf_counter() - t0:.3f} s; launches B13 fwd {B13F.launches} "
              f"bwd {B13B.launches}")
    require(abs(closs[0] - losses[0]) <= 1e-4 * losses[0],
            f"the cuda engine's first loss {closs[0]:.6f} differs from the fused "
            f"engine's {losses[0]:.6f}")
    launches.update({"B13f": B13F.launches, "B13b": B13B.launches})
    for key in ("B13f", "B13b"):
        require(launches[key] == CUDA_STEPS, f"{key}: {launches[key]} launches")
    return launches


def fit_example(dev) -> None:
    """Phase 7: `python -m voxtpu_torch.examples.fit_vertices` on an OBJ
    written here, fused engine on the card."""
    from voxtpu_torch.mesh.obj_io import export_mesh

    mesh, _ = soft_case(64, level=3)
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_fit_") as tmp:
        path = os.path.join(tmp, "icosphere.obj")
        export_mesh(path, mesh)
        cmd = [sys.executable, "-m", "voxtpu_torch.examples.fit_vertices", "--mesh", path,
               "--n", "64", "--steps", "10", "--engine", "fused", "--device", str(dev)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600,
                              env={**os.environ, "PYTHONPATH": ROOT})
    print(proc.stdout.strip())
    require(proc.returncode == 0,
            f"fit_vertices exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    require("(improved)" in proc.stdout, "fit_vertices did not improve the hard IoU")
    print(f"fit_vertices: exit 0 in {time.perf_counter() - t0:.1f} s")


def pipeline_inputs(pipe, spec):
    """The inputs of B1 and B2 in one call of a pipeline on the card."""
    from voxtpu_torch.ops.vox_slots_banded import emit_slots

    dev = pipe.device
    banded, wide, _ = emit_slots(pipe.state, spec.origin_tensor(dev),
                                 spec.voxel_size_tensor(dev), n=spec.n,
                                 tc=pipe.tc, band=pipe.band)
    return banded, wide


def plain_words(pipe, spec):
    """The pipeline's grid through the plain versions of B1 and B2."""
    from voxtpu_torch.ops.vox_cuda import wide_fill_plain
    from voxtpu_torch.ops.vox_slots_banded import banded_fill_plain

    n, tc, st = spec.n, pipe.tc, pipe.state
    (lk, xs), wide = pipeline_inputs(pipe, spec)
    words = banded_fill_plain(lk, xs, st.batch_tile, st.batch_basew, n=n,
                              tc=tc, band=pipe.band)
    if wide is not None:
        w_ctile, w_uidx = st.wide[3], st.wide[4]
        w_words = wide_fill_plain(*wide, w_ctile, n=n, tc=tc,
                                  num_tiles=w_uidx.shape[0])
        words.view(-1, tc, n // 32)[w_uidx] ^= w_words
    return words


def plain_flood(occ, org):
    """(final seeds, SDF) of the flood through the plain versions."""
    from voxtpu_torch.ops.jfa import jfa_init_seed
    from voxtpu_torch.ops.jfa_cuda import flood_step_plain, sdf_from_seed_plain

    seed = jfa_init_seed(occ)
    k = occ.shape[0] // 2
    while k >= 1:
        seed = flood_step_plain(seed, org, k)
        k //= 2
    return seed, sdf_from_seed_plain(seed, occ, org)


def run() -> int:
    import torch

    # ---- 1. device -------------------------------------------------------
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import voxtpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from voxtpu_torch import _build
    from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.mesh.obj_io import export_mesh, import_mesh
    from voxtpu_torch.ops import jfa_cuda, vox_cuda, vox_slots_banded
    from voxtpu_torch.ops.jfa import jfa_init_seed
    from voxtpu_torch.ops.reference import jfa_ref, voxelize_ref
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    B1, B2 = vox_slots_banded.banded_fill, vox_cuda.wide_fill
    B3, B5 = jfa_cuda.flood_step, jfa_cuda.sdf_from_seed
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False  # no matmuls run; stated
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ---------------------------------------------------------
    phase("2. build")
    built = _build.build()
    _build.library()
    print(f"built {os.path.relpath(built.path, ROOT)} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1])

    errs = {"B1": 0, "B2": 0, "B3": 0, "B5": 0.0}

    def mesh_of(coords, faces, name):
        return Mesh(name=name, coords=coords, faces=faces, faces_normals=faces)

    # ---- 3. kernels vs plain ----------------------------------------------
    phase("3. kernels against their plain versions")
    c, f = procedural.icosphere(4, center=(0.1, -0.2, 0.3))
    sphere = mesh_of(c, f, "icosphere")
    spec128 = GridSpec.fit(c, 128)
    pipe = BandedSlotVoxPipeline(sphere, spec128, dev, band=64)
    (lk, xs), _ = pipeline_inputs(pipe, spec128)
    st = pipe.state
    got = B1(lk, xs, st.batch_tile, st.batch_basew, n=128, tc=pipe.tc, band=64)
    want = vox_slots_banded.banded_fill_plain(lk, xs, st.batch_tile, st.batch_basew,
                                              n=128, tc=pipe.tc, band=64)
    errs["B1"] = max(errs["B1"], int_err(got, want))
    require(torch.equal(got, want), "B1 differs from its plain version (n=128)")
    require(bool((got != 0).any()), "B1 produced an empty grid")
    print(f"B1 n=128 band=64: {pipe.num_batches} batches, equal")

    c, f = procedural.icosahedron()
    ico = mesh_of(c, f, "icosahedron")
    spec192 = GridSpec.fit(c, 192)
    pipe = BandedSlotVoxPipeline(ico, spec192, dev, band=64)
    require(pipe.num_wide > 0, "icosahedron at 192/64 routed nothing wide")
    before = B2.launches
    words, overflow = pipe.words()
    require(B2.launches > before, "the icosahedron pipeline did not launch B2")
    require(int(overflow) == 0, "overflow on the icosahedron")
    want = plain_words(pipe, spec192)
    errs["B2"] = max(errs["B2"], int_err(words, want))
    require(torch.equal(words, want), "icosahedron pipeline differs from plain")
    g = torch.Generator().manual_seed(7)
    for n, tiles in ((192, 6), (512, 5)):
        local = torch.randint(-1, 128, (4 * tiles, 4, 128), generator=g,
                              dtype=torch.int32).to(dev)
        rxs = torch.randint(0, n, local.shape, generator=g, dtype=torch.int32).to(dev)
        btile = torch.arange(tiles, dtype=torch.int32).repeat_interleave(4).to(dev)
        got = B2(local, rxs, btile, n=n, tc=128, num_tiles=tiles)
        want = vox_cuda.wide_fill_plain(local, rxs, btile, n=n, tc=128,
                                        num_tiles=tiles)
        errs["B2"] = max(errs["B2"], int_err(got, want))
        require(torch.equal(got, want), f"B2 differs from plain on live slots (n={n})")
    print(f"B2 n=192 band=64: {pipe.num_wide} wide candidates, equal; "
          "live random slots at n=192 and 512 equal")

    occ128 = BandedSlotVoxPipeline(sphere, spec128, dev)().to_dense()
    org = jfa_cuda.org_tensor(spec128, dev)
    seed = jfa_init_seed(occ128)
    k = 64
    while k >= 1:
        got = B3(seed, org, k)
        want = jfa_cuda.flood_step_plain(seed, org, k)
        errs["B3"] = max(errs["B3"], int_err(got, want))
        require(torch.equal(got, want), f"B3 differs from plain at k={k}")
        seed = got
        k //= 2
    got = B5(seed, occ128, org)
    want = jfa_cuda.sdf_from_seed_plain(seed, occ128, org)
    errs["B5"] = max(errs["B5"], float_err(got, want))
    require(bitwise_equal(got, want), "B5 differs from plain (n=128)")
    print("B3 at k=64..1 and B5 at n=128: equal")

    spec64 = GridSpec.fit(sphere.coords, 64)
    grid64 = BandedSlotVoxPipeline(sphere, spec64, dev)()
    oracle_occ = voxelize_ref(sphere, spec64)
    require(torch.equal(grid64.words.cpu(), pack_bits(torch.from_numpy(oracle_occ))),
            "voxelizer differs from voxelize_ref at n=64")
    sdf64 = jfa_cuda.jfa_cuda(grid64.to_dense(), spec64).cpu()
    require(bitwise_equal(sdf64, torch.from_numpy(jfa_ref(oracle_occ, spec64))),
            "JFA differs from jfa_ref at n=64")
    print(f"n=64 oracle: grid ({int(oracle_occ.sum())} voxels) and SDF bitwise equal")

    # ---- 4. main path -------------------------------------------------------
    phase(f"4. main path: CLI at {MAIN_N}^3, two meshes of {MAIN_FACES:,} faces")
    t0 = time.perf_counter()
    c, f = procedural.washer(0.85, 1.0, 0.16, nu=64)
    c, f = procedural.subdivide_to(c, f, MAIN_FACES)
    require(len(f) == MAIN_FACES, "face count")
    shifted = (c + [0.9, 0.0, 0.05]).astype(c.dtype)
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_smoke_") as tmp:
        paths = [os.path.join(tmp, "washer_a.obj"), os.path.join(tmp, "washer_b.obj")]
        export_mesh(paths[0], mesh_of(c, f, "washer_a"))
        export_mesh(paths[1], mesh_of(shifted, f, "washer_b"))
        print(f"meshes written in {time.perf_counter() - t0:.1f} s")
        out_dir = os.path.join(tmp, "out")
        argv = [*paths, "-n", str(MAIN_N), "-t", "2", "-p", "1", "-s", "-e",
                "-o", "merged.obj", "--out-dir", out_dir]
        for fn in (B1, B2, B3, B5):
            fn.launches = 0
        t0 = time.perf_counter()
        from voxtpu_torch import cli

        result = cli.run(argv)  # what `python -m voxtpu_torch.cli ...` runs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": B1.launches, "B2": B2.launches, "B3": B3.launches,
                    "B5": B5.launches}
        print(f"CLI wall {wall:.1f} s; launches {launches}")
        for name, count in launches.items():
            require(count > 0, f"the main path never launched {name}")
        exported = sorted(os.listdir(out_dir))
        require(len(exported) == 5 and all(
            os.path.getsize(os.path.join(out_dir, e)) > 0 for e in exported),
            f"exports: {exported}")
        print("exports:", ", ".join(exported))

        spec = result.spec
        folded = result.grids[0].words
        pipes = [BandedSlotVoxPipeline(import_mesh(p), spec, dev) for p in paths]
        require(all(p.num_wide > 0 for p in pipes), "main meshes routed nothing wide")
        plain = plain_words(pipes[0], spec) | plain_words(pipes[1], spec)
        errs["B1"] = max(errs["B1"], int_err(folded, plain))
        require(torch.equal(folded, plain), "folded grid differs from the plain pipeline")
        occ = result.grids[0].to_dense()
        count = int(occ.sum())
        require(0 < count < MAIN_N ** 3, f"occupancy {count}")
        org = jfa_cuda.org_tensor(spec, dev)
        seed_plain, sdf_plain = plain_flood(occ, org)
        errs["B5"] = max(errs["B5"], float_err(result.sdf, sdf_plain))
        require(bitwise_equal(result.sdf, sdf_plain), "SDF differs from the plain flood")
        require(bool((result.sdf[occ] >= 0).all()) and bool((result.sdf[~occ] < 0).all()),
                "SDF signs do not follow occupancy")
        finite = float(torch.isfinite(result.sdf).float().mean())
        print(f"folded grid: {count} voxels, xor 0 against plain; SDF bitwise "
              f"equal to the plain flood; {pipes[0].num_wide} + {pipes[1].num_wide} "
              f"wide candidates; finite SDF share {finite}")

        # Timing at the main path's shapes (these launches are not counted).
        p0 = pipes[0]
        (lk, xs), (wk, wxs) = pipeline_inputs(p0, spec)
        st = p0.state
        kw = dict(n=MAIN_N, tc=p0.tc, band=p0.band)
        w_ctile, w_uidx = st.wide[3], st.wide[4]
        wkw = dict(n=MAIN_N, tc=p0.tc, num_tiles=w_uidx.shape[0])
        seed0 = jfa_init_seed(occ)
        seeds, k, s = [], MAIN_N // 2, seed0
        while k >= 1:
            seeds.append((s, k))
            s = B3(s, org, k)
            k //= 2
        final_seed = s
        errs["B3"] = max(errs["B3"], int_err(final_seed, seed_plain))
        require(torch.equal(final_seed, seed_plain),
                "B3 chain differs from the plain flood at 512^3")

        def steps(fn):
            return lambda: [fn(si, org, ki) for si, ki in seeds]

        timings = {
            "B1": (cuda_ms(lambda: B1(lk, xs, st.batch_tile, st.batch_basew, **kw)),
                   cuda_ms(lambda: vox_slots_banded.banded_fill_plain(
                       lk, xs, st.batch_tile, st.batch_basew, **kw))),
            "B2": (cuda_ms(lambda: B2(wk, wxs, w_ctile, **wkw)),
                   cuda_ms(lambda: vox_cuda.wide_fill_plain(wk, wxs, w_ctile, **wkw))),
            "B3": (cuda_ms(steps(B3), reps=3) / len(seeds),
                   cuda_ms(steps(jfa_cuda.flood_step_plain), reps=3) / len(seeds)),
            "B5": (cuda_ms(lambda: B5(final_seed, occ, org)),
                   cuda_ms(lambda: jfa_cuda.sdf_from_seed_plain(final_seed, occ, org))),
        }
        for name, (ms, plain_ms) in timings.items():
            print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        g = torch.Generator().manual_seed(11)
        live_k = torch.randint(0, p0.tc, tuple(wk.shape), generator=g,
                               dtype=torch.int32).to(dev)
        live_xs = torch.randint(0, MAIN_N, tuple(wk.shape), generator=g,
                                dtype=torch.int32).to(dev)
        got = B2(live_k, live_xs, w_ctile, **wkw)
        want = vox_cuda.wide_fill_plain(live_k, live_xs, w_ctile, **wkw)
        errs["B2"] = max(errs["B2"], int_err(got, want))
        require(torch.equal(got, want), "B2 differs from plain on live slots (main shape)")
        live_ms = cuda_ms(lambda: B2(live_k, live_xs, w_ctile, **wkw))
        live_plain_ms = cuda_ms(lambda: vox_cuda.wide_fill_plain(
            live_k, live_xs, w_ctile, **wkw))
        print(f"B2 on live random slots of the same shape: kernel {live_ms:.4f} ms, "
              f"plain {live_plain_ms:.4f} ms, equal")
        print(f"shapes: B1 {tuple(lk.shape)} slots, B2 {tuple(wk.shape)} slots on "
              f"{w_uidx.shape[0]} tiles, B3 per step (mean of k={MAIN_N // 2}..1), "
              f"B5 {MAIN_N}^3")
    # The serving path's grids and seeds (~6 GiB) are not the training
    # path's: free them before its peak memory is read.
    del result, occ, seeds, seed0, s, final_seed, seed_plain, sdf_plain, pipes, folded
    del plain, live_k, live_xs, got, want
    torch.cuda.empty_cache()

    # ---- 5. training kernels vs plain ------------------------------------------
    phase(f"5. training kernels against their plain versions (n={KERNEL_N})")
    check_training_kernels(dev, errs)

    # ---- 6. training path --------------------------------------------------------
    phase(f"6. training path: VoxelFit at {MAIN_N}^3 on {MAIN_FACES:,} faces")
    train = training_path(dev, errs, timings)
    launches.update({k: train[k] for k in ("B7", "B8", "B13f", "B13b")})

    # ---- 7. the fitting example --------------------------------------------------
    phase("7. examples.fit_vertices on the card")
    fit_example(dev)

    # ---- 8. result lines ------------------------------------------------------
    phase("8. result")
    soft = "voxtpu_torch/csrc/soft_vox.cu"
    table = [
        ("B1", "B1 banded_fill", "voxtpu_torch/csrc/vox_fill.cu",
         "voxtpu/ops/vox_slots_banded.py:118"),
        ("B2", "B2 wide_fill", "voxtpu_torch/csrc/vox_fill.cu",
         "voxtpu/ops/vox_pallas.py:56"),
        ("B3", "B3 flood_step", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:43"),
        ("B5", "B5 sdf_from_seed", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:442"),
        ("B7", "B7 fused_fwd", soft, "voxtpu/ops/soft_vox_fused.py:209"),
        ("B8", "B8 fused_bwd", soft, "voxtpu/ops/soft_vox_fused.py:284"),
        ("B13f", "B13 fragment_fwd", soft, "voxtpu/ops/soft_vox_pallas.py:49"),
        ("B13b", "B13 fragment_bwd", soft, "voxtpu/ops/soft_vox_pallas.py:88"),
    ]
    kernels = []
    for key, name, source, replaces in table:
        ms, plain_ms = timings[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms})
    print("largest max_abs_err / limit of any check: " + ", ".join(
        f"{name} {errs[key, '/tol']:.3f}" for key, name, _, _ in table
        if (key, "/tol") in errs))
    print(card)  # nvidia-smi's own line: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
