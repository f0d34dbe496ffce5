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
   (signed distance) at n=128; B6 (pipelined flood step) at every
   stride of n=128 against its plain version and B3, and with the
   signed distance against B5 after B3; B14 (work-queue fill) on the
   icosphere's plan at n=128 (two X segments) against its plain version
   and the banded grid; and at n=64 the NumPy oracle (voxelize_ref,
   jfa_ref) as a third witness, then P1's five variants (flood-step
   probe) against their plain versions at k = 32, 4, 1.
4. Main path at the reference's benchmark scale: two washers of
   1,348,128 faces each (the second one shifted), written as OBJ files
   and run through `voxtpu_torch.cli` at 512^3 (vox -> CSG union ->
   JFA SDF -> export). The launch counts of the run must show every
   kernel; the folded grid must equal the plain pipeline on the card
   (xor popcount 0) and the SDF the plain flood (bitwise, inf == inf).
   Then each kernel is timed beside its plain version at these shapes
   (CUDA events, warm, median of 5). The washers' wide slots are all
   inert (an x-parallel cap covers no cell centre), so B2 is also timed
   on random live slots of the same shape and tiles. Then, while the
   folded grid is live, `jfa(grid, backend="cuda", pipe=True)` (voxtpu's
   JFA_PIPE=1) must launch B6 9 times (k = 256 ... 2 and the fused
   k = 1) and B3 and B5 never, and equal the CLI's SDF bitwise; B6 is
   held against B3 and its plain version at each step and timed per step
   beside B3. P1's variants are timed on the flood's own seeds at k = 4
   and 128 (dense, where phase 4c's ball shell is sparse).
4b. voxtpu's own routes (phase 4's state freed first, this phase's
   freed before phase 5): B12 (word-event fill) against its plain
   version on the icosphere at n=96 (36 tiles a supertile), n=128, and
   n=128 with tc=64, tb_sub=1; then on phase 4's two washers at 512^3
   and 1024^3, `voxelize(backend="word_event")` on a WordEventVoxPlan
   and DeviceVoxPipeline.words() must each equal the banded pipeline's
   grid (xor popcount 0, overflow 0) and launch B12, which is held
   against its plain version at full size; events, batches, plan build
   times and the per-call totals of DeviceVoxPipeline.words() and of
   the banded pipeline (CUDA events, warm, median of 5) are printed.
   `jfa()` on the union of the two 1024^3 grids must run B4 (row-band
   flood step) and not B3, and equal a B3 chain bitwise; B4 is held
   against B3 and against its band-wise plain version at every stride,
   and B4 and B3 are timed per step. `voxelize_wq` on a WorkQueueVoxPlan
   of the same fragments must equal the banded grid at 512^3 and 1024^3
   on each washer and launch B14 once a call; B14 is held against its
   plain version there and timed on washer_a at 512^3; at 2048^3 on
   washer_a (a 1.07 GB grid) it must equal `resolve_fragments` on the
   same fragments, and is timed. Last, the CLI with -t 1 (the plain
   route) on the card at n=128 on two small washers must equal -t 2:
   grid xor 0, SDF bitwise.
4c. The flood-step probe P1 through its runner
   (`tools/probe_jfa_micro.py`) at 512^3 on ball-shell seeds, k = 4 and
   128: every variant timed, `hoist` / `hoistv` bitwise equal to B3;
   `hoistv` held against its plain version and timed beside it.
5. Training kernels against their plain torch versions at n=128 on a
   jittered icosphere(4), soft plan with pad 2: B7 (fused forward)
   occupancy within 1e-4; B8 (fused backward) table cotangents for a
   seeded random cotangent, B13 fwd / bwd (per-fragment engine) on the
   same plan, and the coordinate gradient of soft_iou_loss through the
   fused and cuda engines on the card against the same engines on the
   CPU (the kernels' plain versions), each within 1e-3 x max|plain|.
5b. The seg kernels at n=256 (the seg engine's floor) on the same kind
   of icosphere: B9's family arrays and carry within 1e-4, B10 bitwise,
   B11 within 1e-3 x max|plain| for a seeded random cotangent, and the
   seg engine's coordinate gradient on the card against the CPU.
6. Training path: `VoxelFit(engine="fused")` takes 5 Adam steps at
   512^3 on a torus brought to 1,348,128 faces and rotated; the target
   is its hard grid through the serving path (B1, B2 where the mesh has
   x-degenerate candidates); the start is shifted by half a voxel along
   x plus 0.1 voxel of seeded jitter; refresh_every=4 with a drift
   limit of half a voxel, so step 4 rebuilds the plan at full size.
   Each step prints loss, grad norm, wall time, peak memory and launch
   counts; the first also holds B7 / B8 against their plain versions at
   full size and times them (CUDA events, warm, median of 3). The loss
   must fall and B1, B7, B8 launch (and B2 if the target routed
   candidates to it; the rotated torus has no x-degenerate face, so it
   routes none). After the last step all four training kernels are held
   again on the refreshed plan, the densest of the path, within the
   same limits. Then `VoxelFit(engine="seg")` runs the same 5 steps
   from the same plan and start: B9 / B10 / B11 held and timed on step
   1's inputs and held again on its refreshed plan, launches once per
   step (B9 / B10 also for the final loss), its first loss the fused
   engine's within 1e-4 relative, its warm step printed beside the
   fused one. Then `VoxelFit(engine="cuda")` takes 2 steps from the
   same start on the same plan: B13 fwd / bwd are held and timed as B7
   / B8 were, and its first loss must equal the fused engine's within
   1e-4 relative. The kernel table's launches are phase 4's for B1-B5
   and this phase's for B7-B11 and B13 (phase 4b's for B4 and B12).
7. `python -m voxtpu_torch.examples.fit_vertices --n 64 --steps 10
   --engine fused` on an OBJ written here must exit 0 with an improved
   hard IoU.
8. Prints each kernel's largest error as a share of its limit, the
   card's name and power limit, the kernel table as one JSON line (each
   kernel's launches, error, time, plain time and bound: the larger of
   its bytes over the memory rate and its operations over their peak
   rate, counted from this run's inputs; `bound`), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
   Launches are those of each kernel's own path: phase 4's CLI call
   (B1-B3, B5) and `jfa(pipe=True)` (B6); phase 4b's routes (B4, B12,
   B14); phase 4c's probe (P1); phase 6 (the training kernels).

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
SEG_N = 256             # phase 5b's grid, the seg engine's floor
WE_SIZES = (MAIN_N, 1024)  # phase 4b's word-event grids
JFA_N = 1024            # B4's grid (jfa routes 512 < N <= 1024 to it)
PLAIN_CLI_N = 128       # phase 4b's -t 1 run on the card
WQ_BIG_N = 2048         # phase 4b's B14 grid on washer_a alone
PROBE_N, PROBE_KS = 512, (4, 128)  # phase 4c's flood-step probe
PROBE_ROW = "hoistv"    # the probe variant whose time the kernels line carries

# The least time the card could take for a kernel's work (`bound`): the
# larger of its bytes over the memory rate and its operations over their
# peak rate. NVIDIA H100 SXM at its 700 W limit: 3.35 TB/s, 67 TFLOP/s
# float32 outside the tensor cores, and the special-function units
# (expf's ex2, the reciprocal behind each IEEE division) at 16 results
# per SM per clock (compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
SFU_OP_S = 16 * 132 * 1.98e9
# Operations (float32, special-function) of the soft kernels, counted
# from the sources: a forward (slot, column) pair is the column centre
# (3), (xh - cx) / tau_x, the sigmoid 1 / (1 + expf(-v)), w * sig and
# its fixed-point scaling (6), with three special-function operations
# (two divisions, one expf); a backward pair adds the cotangent's
# products and the two running sums (5 more). A slot's fragment rebuild
# is 3 edge sigmoids and the weight and x-hit (37, 9 special); the
# chain rule to 13 cotangents 30 more (3 divisions).
PAIR_FWD = (9, 3)
PAIR_BWD = (14, 3)
SLOT_FRAG = (37, 9)
SLOT_CHAIN = (30, 3)


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


def bound(nbytes: float, flops: float = 0.0, sfu: float = 0.0):
    """(ms, "bytes" or "operations"): the least time for `nbytes` of
    device memory traffic, `flops` float32 operations and `sfu`
    special-function operations, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(flops / F32_FLOP_S, sfu / SFU_OP_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def soft_bound(moved: int, slots: int, cols: int, backward: bool, rebuild: bool = True):
    """The bound of a soft kernel: `moved` bytes, `slots` live slots
    over `cols` columns each; `rebuild` (the fused and seg kernels)
    adds each slot's fragment and, backward, its chain rule."""
    pair = PAIR_BWD if backward else PAIR_FWD
    per_slot = [(f + (c if backward else 0)) * rebuild
                for f, c in zip(SLOT_FRAG, SLOT_CHAIN)]
    pairs = slots * cols
    return bound(moved, pairs * pair[0] + slots * per_slot[0],
                 pairs * pair[1] + slots * per_slot[1])


def live_slots(cells) -> int:
    return int((cells >= 0).sum())


def seeded_candidates(seed, k: int) -> int:
    """The in-grid candidates (own seed included) that hold a seed, over
    all voxels, at stride k: the distances a flood step needs."""
    n = seed.shape[0]
    valid = seed >= 0
    count = int(valid.sum())
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz or dy or dx:
                    box = tuple(slice(max(0, d * k), n + min(0, d * k))
                                for d in (dz, dy, dx))
                    count += int(valid[box].sum())
    return count


def flood_flops(seed, k: int) -> int:
    """Float32 operations of one flood step (B3) on `seed` at stride k:
    each voxel's coordinates (6), and the unpack and squared distance
    (14) of each seeded candidate (the kernel skips the rest)."""
    return 6 * seed.shape[0] ** 3 + 14 * seeded_candidates(seed, k)


def pipe_flops(seed, k: int, emit_sdf: bool = False) -> int:
    """Float32 operations of one B6 step on `seed` at stride k, counted
    from its source: each voxel's coordinates (6) and the unpack of its
    staged seed (6, once, where B3 unpacks per candidate), the distance
    from unpacked coordinates (8) of each seeded candidate, and with the
    signed distance one product a voxel."""
    n3 = seed.shape[0] ** 3
    return 12 * n3 + 8 * seeded_candidates(seed, k) + emit_sdf * n3


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
    the four calls for timing, (B7, B7 plain, B8, B8 plain), and the
    two kernels' bounds on these inputs."""
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
    slots, n = live_slots(fp.cells_d), fp.spec.n
    bounds = {"B7": soft_bound(nbytes(*args, fp.run_start_d, occ), slots, n, False),
              "B8": soft_bound(nbytes(*args, g, dtab), slots, n, True)}
    return (lambda: F.fused_fwd(*args, fp.run_start_d, **kw),
            lambda: F.fused_fwd_plain(*args, **kw),
            lambda: F.fused_bwd(*args, g, **kw),
            lambda: F.fused_bwd_plain(*args, g, **kw)), bounds


def hold_fragment(cp, coords, g, errs, what: str):
    """B13 fwd and bwd against their plain versions on the per-fragment
    engine's slots of `coords`; `g` as in `hold_fused`. Returns the four
    calls for timing and the two kernels' bounds."""
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
    grads = C.fragment_bwd(*args, g, **kw)
    for name, got, want in zip(("dw", "dx_hit"), grads,
                               C.fragment_bwd_plain(*args, g, **kw)):
        top = float(want.abs().max())
        err = hold(errs, "B13b", got, want, GRAD_TOL * top, f"B13 bwd {name} {what}")
        bwd.append(f"{name} {err:.3e} (max |plain| {top:.3e}, limit {GRAD_TOL * top:.3e})")
    print(f"B13 fwd {what}: max_abs_err {ef:.3e} (limit {OCC_TOL:.0e}); B13 bwd: "
          + "; ".join(bwd))
    slots = live_slots(cp.cells_d)
    bounds = {"B13f": soft_bound(nbytes(*args, cp.run_start_d, occ), slots, spec.n,
                                 False, rebuild=False),
              "B13b": soft_bound(nbytes(*args, g, *grads), slots, spec.n, True,
                                 rebuild=False)}
    return (lambda: C.fragment_fwd(*args, cp.run_start_d, **kw),
            lambda: C.fragment_fwd_plain(*args, **kw),
            lambda: C.fragment_bwd(*args, g, **kw),
            lambda: C.fragment_bwd_plain(*args, g, **kw)), bounds


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


def fit_steps(fit, state, what: str, counted):
    """TRAIN_STEPS Adam steps of `fit`, each printed with its loss, wall
    time, peak device memory and the launch counts of `counted` (name ->
    wrapper). Returns (state, losses, walls, final loss)."""
    import numpy as np
    import torch

    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = fit.step(state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        require(np.isfinite(loss) and np.isfinite(gnorm), f"{what} step {i + 1}: non-finite")
        losses.append(loss)
        print(f"{what} step {i + 1}: loss {loss:.6f}, grad norm {gnorm:.6g}, drift "
              f"{float(m['max_drift_vox']):.3f} vox, wall {walls[-1]:.3f} s, refreshes "
              f"{fit.refresh_count}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB; launches " + " ".join(f"{k} {fn.launches}" for k, fn in counted.items()))
    with torch.no_grad():
        final = float(fit.loss(state.coords))
    print(f"{what}: loss {losses[0]:.6f} before the first step, {final:.6f} after the last")
    require(final < losses[0], f"the {what} fit's loss did not fall")
    require(fit.refresh_count == 1, f"{what}: {fit.refresh_count} plan refreshes, expected 1")
    return state, losses, walls, final


def warm_step(walls) -> float:
    """The median wall of steps 2, 3 and 5: after the first step's
    one-time set-up, without step 4's plan refresh."""
    return sorted(walls[i] for i in (1, 2, 4))[1]


def hold_seg(plan, tables, g, errs, what: str):
    """B9, B10 and B11 against their plain versions on one seg plan's
    tables and cotangent `g` (a tensor, or a function of B10's
    occupancy): B9's three arrays within OCC_TOL, B10 bitwise, B11
    within GRAD_TOL x max|plain|. Returns the six calls for timing (B9,
    B9 plain, B10, B10 plain, B11, B11 plain) and the kernels' bounds."""
    import torch

    from voxtpu_torch.ops import soft_vox_seg as S

    args = (tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d)
    kw = dict(n=plan.spec.n, tc=plan.tc, tz=plan.tz)
    prm = plan.prm(*TAU)
    parts = S.seg_fwd(*args, plan.run_start_d, prm=prm, **kw)
    want = S.seg_fwd_plain(*args, prm=prm, **kw)
    require(all(bool(torch.isfinite(p).all()) for p in parts), f"B9 {what}: non-finite")
    e9 = max(hold(errs, "B9", got, ref, OCC_TOL, f"B9 {what} {name}")
             for name, got, ref in zip(("out_a", "out_b", "carry"), parts, want))
    del want
    occ = S.seg_combine(*parts, **kw)
    ref = S.seg_combine_plain(*parts, **kw)
    errs["B10"] = max(errs.get("B10", 0.0), float_err(occ, ref))
    require(bitwise_equal(occ, ref), f"B10 {what}: differs from its plain version")
    require(float(ref.max()) > 0.5, f"B10 {what}: the plain occupancy is empty")
    del ref
    g = g(occ) if callable(g) else g
    gpre = S.seg_gpre(g)
    dtab = S.seg_bwd(*args, g, gpre, prm=prm, **kw)
    want = S.seg_bwd_plain(*args, g, gpre, prm=prm, **kw)
    top = float(want.abs().max())
    e11 = hold(errs, "B11", dtab, want, GRAD_TOL * top, f"B11 {what}")
    print(f"B9 {what}: max_abs_err {e9:.3e} (limit {OCC_TOL:.0e}); B10 bitwise equal; "
          f"B11 {e11:.3e} (max |plain| {top:.3e}, limit {GRAD_TOL * top:.3e})")
    slots, n = live_slots(plan.cells_d), plan.spec.n
    bounds = {"B9": soft_bound(nbytes(*args, plan.run_start_d, *parts), slots, S.PANEL,
                               False),
              "B10": bound(nbytes(*parts, occ), 2 * n ** 3),
              "B11": soft_bound(nbytes(*args, g, gpre, dtab), slots, S.PANEL, True)}
    return (lambda: S.seg_fwd(*args, plan.run_start_d, prm=prm, **kw),
            lambda: S.seg_fwd_plain(*args, prm=prm, **kw),
            lambda: S.seg_combine(*parts, **kw),
            lambda: S.seg_combine_plain(*parts, **kw),
            lambda: S.seg_bwd(*args, g, gpre, prm=prm, **kw),
            lambda: S.seg_bwd_plain(*args, g, gpre, prm=prm, **kw)), bounds


def check_seg_kernels(dev, errs, n: int = SEG_N) -> None:
    """Phase 5b: B9, B10, B11 against their plain versions at n (the seg
    engine's floor) on `soft_case(n)` with a seeded random cotangent,
    and the seg engine's coordinate gradient of soft_iou_loss on the
    card against the same engine on the CPU."""
    import numpy as np
    import torch

    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox_fused import tables_of
    from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan, soft_voxelize_seg
    from voxtpu_torch.ops.vox import voxelize

    mesh, sp = soft_case(n)
    coords = torch.from_numpy(mesh.coords).to(dev)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((n, n, n)).astype(
        np.float32)).to(dev)
    t0 = time.perf_counter()
    plan = SegSoftPlan(sp, mesh.coords, dev)
    print(f"n={n}: {len(mesh.faces)} faces; SegSoftPlan {time.perf_counter() - t0:.2f} s, "
          f"{plan.num_fragments} slots in {plan.num_batches} batches, {plan.num_runs} "
          f"(tile, panel) runs, {plan.num_pairs} table rows")
    with torch.no_grad():
        tables = tables_of(coords, plan)
    hold_seg(plan, tables, g, errs, f"n={n}")

    target = voxelize(mesh, sp.spec, "cuda", device=dev).to_dense().float()
    cpu = torch.device("cpu")

    def coord_grad(p, device):
        x = coords.to(device).clone().requires_grad_(True)
        soft_iou_loss(soft_voxelize_seg(x, p, tau_edge_frac=TAU[0], tau_x_frac=TAU[1]),
                      target.to(device)).backward()
        return x.grad.to(dev)

    want = coord_grad(SegSoftPlan(sp, mesh.coords, cpu), cpu)
    scale = float(want.abs().max())
    require(scale > 0, "the seg engine's coordinate gradient is zero")
    err = float_err(coord_grad(plan, dev), want)
    require(err <= GRAD_TOL * scale, f"seg engine's coordinate gradient: {err:.3e} > "
            f"{GRAD_TOL} x {scale:.3e}")
    print(f"coordinate gradient of soft_iou_loss, seg engine: kernels vs plain versions "
          f"max_abs_err {err:.3e} (max |plain| {scale:.3e})")


def seg_fit(dev, errs, timings, bounds, plan, start, target, fused_loss0: float):
    """Phase 6's seg run: VoxelFit(engine="seg") from the fused run's
    plan and start for TRAIN_STEPS steps (step 4 refreshes); B9-B11
    held and timed on step 1's inputs and held again on the refreshed
    plan. Returns (launch counts, walls)."""
    import torch

    from voxtpu_torch.models.fit import VoxelFit
    from voxtpu_torch.ops import soft_vox_seg
    from voxtpu_torch.ops.soft_vox_fused import tables_of

    counted = {"B9": soft_vox_seg.seg_fwd, "B10": soft_vox_seg.seg_combine,
               "B11": soft_vox_seg.seg_bwd}
    every = tuple(counted.values())
    for fn in every:
        fn.launches = 0
    n, vs = plan.spec.n, plan.spec.voxel_size
    t0 = time.perf_counter()
    fit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine="seg",
                   refresh_every=4, drift_limit_frac=0.25)
    sg = fit.engine_plan
    print(f"SegSoftPlan {time.perf_counter() - t0:.1f} s: {sg.num_fragments:,} slots in "
          f"{sg.num_batches:,} batches of {sg.cells_b[0].size}, {sg.num_runs:,} (tile, "
          f"panel) runs, {sg.num_pairs:,} table rows")
    state = fit.init(start)
    with uncounted(*every):
        with torch.no_grad():
            tables = tables_of(state.coords, sg)
        calls, b = hold_seg(sg, tables, lambda occ: loss_cotangent(occ, target), errs,
                            f"{n}^3")
        bounds.update(b)
        for key, i in (("B9", 0), ("B10", 2), ("B11", 4)):
            timings[key] = (cuda_ms(calls[i], reps=3), cuda_ms(calls[i + 1], reps=3))
            print(f"{key} at {n}^3: kernel {timings[key][0]:.3f} ms, plain "
                  f"{timings[key][1]:.3f} ms, bound {bounds[key][0]:.3f} ms "
                  f"({bounds[key][1]})")
        del tables, calls
        torch.cuda.empty_cache()

    state, losses, walls, _ = fit_steps(fit, state, "seg", counted)
    limit = max(soft_vox_seg.MARGIN - 17 * TAU[1] - 4, 0)
    print(f"seg: x_hit drift bound one step after the refresh "
          f"{fit.engine_plan.xhit_drift_vox(state.coords):.3f} voxels (refresh limit "
          f"{limit:.1f}, read every 4 steps)")
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"seg launches {launches}")
    require(launches["B9"] == launches["B10"] == TRAIN_STEPS + 1
            and launches["B11"] == TRAIN_STEPS,
            "B9 / B10 once per step and for the final loss, B11 once per step")
    require(abs(losses[0] - fused_loss0) <= 1e-4 * fused_loss0,
            f"the seg engine's first loss {losses[0]:.6f} differs from the fused "
            f"engine's {fused_loss0:.6f}")
    print(f"seg first loss {losses[0]:.6f}, fused {fused_loss0:.6f}: relative "
          f"{abs(losses[0] - fused_loss0) / fused_loss0:.3e}")

    # The refreshed plan (step 4), at the last coordinates.
    rp = fit.engine_plan
    print(f"refreshed SegSoftPlan: {rp.num_fragments:,} slots in {rp.num_batches:,} "
          f"batches, {rp.num_runs:,} runs")
    with uncounted(*every):
        with torch.no_grad():
            tables = tables_of(state.coords, rp)
        hold_seg(rp, tables, lambda occ: loss_cotangent(occ, target), errs,
                 f"{n}^3 refreshed")
    return launches, walls


def training_path(dev, errs, timings, bounds, n: int = MAIN_N, faces: int = MAIN_FACES):
    """Phase 6: VoxelFit(engine="fused") at n on a rotated torus of
    `faces` faces for TRAIN_STEPS Adam steps (one plan refresh), then
    VoxelFit(engine="seg") and VoxelFit(engine="cuda") (CUDA_STEPS
    steps) from the same start on the same plan. Returns the launch
    counts of the runs (B1 and B2 for the target, B7 and B8 for the
    fused fit, B9-B11 for the seg fit, B13 for the cuda one)."""
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
        calls, b = hold_fused(fp, tables, lambda occ: loss_cotangent(occ, target), errs,
                              f"{n}^3")
        bounds.update(b)
        timings["B7"] = (cuda_ms(calls[0], reps=3), cuda_ms(calls[1], reps=3))
        timings["B8"] = (cuda_ms(calls[2], reps=3), cuda_ms(calls[3], reps=3))
        del tables, calls
    for key in ("B7", "B8"):
        print(f"{key} at {n}^3: kernel {timings[key][0]:.3f} ms, plain "
              f"{timings[key][1]:.3f} ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]})")

    state, losses, fused_walls, _ = fit_steps(
        fit, state, "fused", {"B1": B1, "B2": B2, "B7": B7, "B8": B8})
    launches = {"B1": B1.launches, "B2": B2.launches, "B7": B7.launches,
                "B8": B8.launches}
    print(f"fused launches {launches}")
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
        del rp, fit, fp, state
        torch.cuda.empty_cache()

    # The seg engine from the same start on the same plan.
    seg_launches, seg_walls = seg_fit(dev, errs, timings, bounds, plan, start, target,
                                      losses[0])
    launches.update(seg_launches)
    torch.cuda.empty_cache()
    print(f"warm step (median of steps 2, 3, 5) at {n}^3: seg {warm_step(seg_walls):.4f} "
          f"s, fused {warm_step(fused_walls):.4f} s")

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
        calls, b = hold_fragment(cp, cstate.coords,
                                 lambda occ: loss_cotangent(occ, target), errs, f"{n}^3")
        bounds.update(b)
        timings["B13f"] = (cuda_ms(calls[0], reps=3), cuda_ms(calls[1], reps=3))
        timings["B13b"] = (cuda_ms(calls[2], reps=3), cuda_ms(calls[3], reps=3))
        del calls
    for key, name in (("B13f", "B13 fwd"), ("B13b", "B13 bwd")):
        print(f"{name} at {n}^3: kernel {timings[key][0]:.3f} ms, plain "
              f"{timings[key][1]:.3f} ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]})")
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


def jfa_pipe(errs, timings, bounds, result, occ, org, seeds) -> int:
    """Phase 4, voxtpu's JFA_PIPE=1 on the folded grid: `jfa(pipe=True)`
    must launch B6 once a step (the k = 1 step with the signed distance)
    and B3 and B5 never, and equal the CLI's SDF bitwise. B6 is held
    against B3 (the next entry of `seeds`, B3's (input, k) chain) and
    its plain version at each step, and timed per step. Returns B6's
    launches in the jfa() run."""
    import torch

    from voxtpu_torch.ops import jfa_cuda as J
    from voxtpu_torch.ops.jfa import jfa

    B3, B5, B6 = J.flood_step, J.sdf_from_seed, J.flood_step_pipe
    for fn in (B3, B5, B6):
        fn.launches = 0
    t0 = time.perf_counter()
    sdf = jfa(result.grids[0], result.spec, backend="cuda", pipe=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B6": B6.launches, "B3": B3.launches, "B5": B5.launches}
    print(f"jfa(pipe=True) at {MAIN_N}^3: {wall:.3f} s; launches {launches}")
    require(launches == {"B6": len(seeds), "B3": 0, "B5": 0},
            f"jfa(pipe=True) must run B6 at each of its {len(seeds)} steps, B3 and B5 never")
    require(bitwise_equal(sdf, result.sdf), "jfa(pipe=True) differs from the CLI's SDF")
    del sdf

    step_ms, b3_ms, plain_ms, flops, moved = [], [], [], [], []
    with uncounted(B3, B6):
        for i, (si, ki) in enumerate(seeds):
            extra = (occ,) if ki == 1 else ()
            want = result.sdf if ki == 1 else seeds[i + 1][0]
            got = B6(si, org, ki, *extra)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = J.flood_step_pipe_plain(si, org, ki, *extra)
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
            err = int_err(got, want) if ki > 1 else float_err(got, want)
            errs["B6"] = max(errs["B6"], err)
            require(bitwise_equal(got, want) and bitwise_equal(got, plain),
                    f"B6 at k={ki} differs from B3 (B5 after B3 at k=1) or its plain version")
            del got, plain
            step_ms.append(cuda_ms(lambda: B6(si, org, ki, *extra), reps=3))
            b3_ms.append(cuda_ms(lambda: B3(si, org, ki), reps=3))
            flops.append(pipe_flops(si, ki, emit_sdf=ki == 1))
            moved.append(nbytes(si, org, *extra) + 4 * si.numel())
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["B6"] = (mean(step_ms), mean(plain_ms))
    bounds["B6"] = bound(mean(moved), mean(flops))
    for name, times in (("B6", step_ms), ("B3", b3_ms)):
        print(f"{name} step ms (k=" + ",".join(str(k) for _, k in seeds) + "): "
              + ", ".join(f"{t:.4f}" for t in times))
    print(f"B6 at {MAIN_N}^3 per step (mean of {len(seeds)}, the last fused with the signed "
          f"distance): kernel {timings['B6'][0]:.4f} ms beside B3 {mean(b3_ms):.4f} ms, "
          f"plain {timings['B6'][1]:.1f} ms, bound {bounds['B6'][0]:.4f} ms "
          f"({bounds['B6'][1]}); bitwise equal to B3 at every step")
    return launches["B6"]


def probe_main_path(org, seeds) -> None:
    """Phase 4: P1's variants on the main path's own seed grids at the
    strides PROBE_KS (B3's input at those steps: seeds dense after the
    first steps, where the runner's ball shell is sparse), timed (not
    counted as P1's path); hoist and hoistv held equal to B3."""
    import torch

    from voxtpu_torch.ops import jfa_probe

    P1 = jfa_probe.flood_probe
    with uncounted(P1):
        for si, ki in seeds:
            if ki not in PROBE_KS:
                continue
            ref = P1(si, org, ki, "legacy")
            for variant in ("hoist", "hoistv"):
                require(torch.equal(P1(si, org, ki, variant), ref),
                        f"P1 {variant} differs from B3 on the main path's seeds at k={ki}")
            t = {v: cuda_ms(lambda v=v: P1(si, org, ki, v), reps=3) for v in jfa_probe.VARIANTS}
            print(f"P1 on the main path's seeds ({int((si >= 0).sum()):,} seeded voxels), "
                  f"k={ki}: " + ", ".join(f"{v} {ms:.4f}" for v, ms in t.items())
                  + f" ms; rolls {t['rolls'] / t['legacy']:.3f} and alu "
                  f"{t['alu'] / t['legacy']:.3f} of legacy")


def xor_popcount(a, b) -> int:
    """Set bits of a ^ b over two int32 word tensors."""
    from voxtpu_torch.grids.voxel_grid import popcount32

    return int(popcount32(a ^ b).sum())


def we_args(plan):
    """B12's inputs on a word-event plan."""
    return (plan.cells, plan.ws, plan.his, plan.masks, plan.cnts, plan.batch_tile)


def check_word_event_small(dev, errs, sphere) -> None:
    """Phase 4b, first part: B12 against its plain version on the
    icosphere at n=96 (G = 36), n=128, and n=128 with tc=64, tb_sub=1."""
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.ops import vox_word_event as W

    for n, tc, tb_sub in ((96, 128, 4), (128, 128, 4), (128, 64, 1)):
        spec = GridSpec.fit(sphere.coords, n)
        plan = W.WordEventVoxPlan(sphere, spec, dev, tc=tc, tb_sub=tb_sub)
        got = W.word_event_fill(*we_args(plan), n=n, tc=tc)
        want = W.word_event_fill_plain(*we_args(plan), n=n, tc=tc)
        errs["B12"] = max(errs["B12"], int_err(got, want))
        require(torch.equal(got, want), f"B12 differs from its plain version (n={n}, "
                f"tc={tc}, tb_sub={tb_sub})")
        require(bool((got != 0).any()), f"B12 produced an empty grid (n={n})")
        print(f"B12 n={n} tc={tc} tb_sub={tb_sub}: {plan.num_events} events in "
              f"{plan.num_batches} batches, G={plan.group}, equal")


def wq_route(errs, timings, bounds, mesh, spec, frag_plan, want, timed: bool) -> int:
    """Phase 4b, the work-queue route on `frag_plan`'s fragments:
    `voxelize_wq` on a WorkQueueVoxPlan must equal `want` and launch B14
    once; B14 held against its plain version; timed when `timed`.
    Returns B14's launches on the route."""
    import torch

    from voxtpu_torch.ops import vox_work_queue as Q
    from voxtpu_torch.ops.vox import fragments_from_plan

    B14, n = Q.wq_fill, spec.n
    dev = frag_plan.device
    t0 = time.perf_counter()
    plan = Q.WorkQueueVoxPlan(mesh, spec, dev, fragments=fragments_from_plan(frag_plan))
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    B14.launches = 0
    grid = Q.voxelize_wq(mesh, spec, dev, plan=plan)
    route = B14.launches
    x = xor_popcount(grid.words, want)
    require(route == 1, f"voxelize_wq launched B14 {route} times at {n}^3")
    require(x == 0, f"{mesh.name} {n}^3: the work-queue grid differs from the banded one "
            f"(xor popcount {x})")
    with uncounted(B14):
        args = plan.args()
        plain = Q.wq_fill_plain(*args, n=n, tc=plan.tc)
        errs["B14"] = max(errs["B14"], int_err(grid.words, plain))
        require(torch.equal(grid.words, plain), f"B14 differs from plain at {n}^3")
        del plain
        if timed:
            timings["B14"] = (cuda_ms(lambda: B14(*args, n=n, tc=plan.tc)),
                              cuda_ms(lambda: Q.wq_fill_plain(*args, n=n, tc=plan.tc)))
            bounds["B14"] = bound(nbytes(*args) + n ** 3 // 8)
    print(f"{mesh.name} {n}^3 work queue: {plan.num_fragments:,} fragments on "
          f"{plan.num_active:,} active tiles, {plan.cells2d.shape[0]:,} lane rows; "
          f"WorkQueueVoxPlan {built:.2f} s; equal to the banded grid and B14's plain "
          "version")
    return route


def wq_big(errs, timings, mesh, spec, dev) -> int:
    """Phase 4b, B14 at WQ_BIG_N on one washer: `voxelize_wq` against
    `resolve_fragments` on the same fragments (xor popcount 0), timed.
    Returns B14's launches on the route."""
    import torch

    from voxtpu_torch.ops import vox_work_queue as Q
    from voxtpu_torch.ops.vox import FragmentPlan, fragments_from_plan, resolve_fragments

    B14, n = Q.wq_fill, spec.n
    t0 = time.perf_counter()
    frags = fragments_from_plan(FragmentPlan(mesh, spec, dev))
    plan = Q.WorkQueueVoxPlan(mesh, spec, dev, fragments=frags)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    B14.launches = 0
    grid = Q.voxelize_wq(mesh, spec, dev, plan=plan)
    route = B14.launches
    want = resolve_fragments(*frags, n=n)
    x = xor_popcount(grid.words, want)
    require(route == 1 and x == 0, f"{mesh.name} {n}^3: voxelize_wq (B14 launched {route} "
            f"times) differs from resolve_fragments (xor popcount {x})")
    del want
    with uncounted(B14):
        args = plan.args()
        timings["B14 big"] = cuda_ms(lambda: B14(*args, n=n, tc=plan.tc), reps=3)
    occupied = int(grid.count())
    print(f"{mesh.name} {n}^3 work queue: {plan.num_fragments:,} fragments on "
          f"{plan.num_active:,} active tiles ({int(frags[0].shape[0]):,} candidates), "
          f"plan {built:.2f} s; grid {grid.words.numel() * 4 / 1e9:.2f} GB, {occupied:,} "
          f"voxels, xor 0 against resolve_fragments; B14 {timings['B14 big']:.4f} ms, "
          f"bound {bound(nbytes(*args) + n ** 3 // 8)[0]:.4f} ms (bytes)")
    return route


def word_event_route(dev, errs, timings, bounds, meshes):
    """Phase 4b, the word-event route at WE_SIZES on `meshes`: a
    WordEventVoxPlan through `voxelize(backend="word_event")` and a
    DeviceVoxPipeline, each against the banded pipeline's grid; B12
    held against its plain version on every plan; and the work-queue
    route (`wq_route`) on the pipeline's fragments. Returns (B12's
    launches on the route, B14's, the banded grids at JFA_N, that
    grid's spec)."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.ops import vox_word_event as W
    from voxtpu_torch.ops.vox import voxelize
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    B12 = W.word_event_fill
    allc = np.concatenate([m.coords for m in meshes])
    launches, wq_launches, kept, kept_spec = 0, 0, [], None
    for n in WE_SIZES:
        spec = GridSpec.fit(allc, n)
        for mesh in meshes:
            t0 = time.perf_counter()
            banded = BandedSlotVoxPipeline(mesh, spec, dev)
            want, overflow = banded.words()
            require(int(overflow) == 0, f"banded overflow at {n}^3")
            t1 = time.perf_counter()
            plan = W.WordEventVoxPlan(mesh, spec, dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pipe = W.DeviceVoxPipeline(mesh, spec, dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()

            B12.launches = 0
            grid = voxelize(mesh, spec, "word_event", device=dev, plan=plan)
            words, overflow = pipe.words()
            overflow = int(overflow)
            route = B12.launches
            launches += route
            require(route == 2, f"the word-event route launched B12 {route} times at {n}^3")
            require(overflow == 0, f"DeviceVoxPipeline overflow {overflow} at {n}^3")
            x_plan, x_pipe = xor_popcount(grid.words, want), xor_popcount(words, want)
            require(x_plan == 0 and x_pipe == 0, f"{mesh.name} {n}^3: word-event grids "
                    f"differ from the banded one (xor popcount {x_plan}, {x_pipe})")
            with uncounted(B12):
                args = we_args(plan)
                got = B12(*args, n=n, tc=plan.tc)
                plain = W.word_event_fill_plain(*args, n=n, tc=plan.tc)
                errs["B12"] = max(errs["B12"], int_err(got, plain))
                require(torch.equal(got, plain), f"B12 differs from plain at {n}^3")
                del got, plain
                pipe_ms, banded_ms = cuda_ms(pipe.words), cuda_ms(banded.words)
                if n == MAIN_N and mesh is meshes[0]:
                    timings["B12"] = (
                        cuda_ms(lambda: B12(*args, n=n, tc=plan.tc)),
                        cuda_ms(lambda: W.word_event_fill_plain(*args, n=n, tc=plan.tc)))
                    bounds["B12"] = bound(nbytes(*args) + n ** 3 // 8)
            print(f"{mesh.name} {n}^3: {plan.num_fragments:,} candidates, "
                  f"{pipe.num_valid:,} fragments, {plan.num_events:,} events in "
                  f"{plan.num_batches:,} batches (b_max {pipe.b_max}, cap_f {pipe.cap_f:,}); "
                  f"build: banded {t1 - t0:.2f} s, WordEventVoxPlan {t2 - t1:.2f} s, "
                  f"DeviceVoxPipeline {t3 - t2:.2f} s; per call: DeviceVoxPipeline.words() "
                  f"{pipe_ms:.3f} ms, banded words() {banded_ms:.3f} ms; xor 0, overflow 0")
            del plan, grid, words
            wq_launches += wq_route(errs, timings, bounds, mesh, spec, pipe.frag_plan, want,
                                    timed=n == MAIN_N and mesh is meshes[0])
            if n == JFA_N:
                kept.append(want)
                kept_spec = spec
            del banded, pipe, want
        torch.cuda.empty_cache()
    return launches, wq_launches, kept, kept_spec


def jfa_rows(dev, errs, timings, bounds, words, spec):
    """Phase 4b, JFA at JFA_N: `jfa()` on the grid of `words` must run
    B4 and not B3 and equal a B3 chain bitwise; B4 held against B3 and
    flood_step_rows_plain at every stride, B4 and B3 timed per step.
    Returns B4's launches in the jfa() run."""
    import torch

    from voxtpu_torch.grids.voxel_grid import VoxelGrid
    from voxtpu_torch.ops import jfa_cuda as J
    from voxtpu_torch.ops.jfa import jfa, jfa_init_seed

    B3, B4, B5 = J.flood_step, J.flood_step_rows, J.sdf_from_seed
    n = spec.n
    grid = VoxelGrid(words, spec.origin_tensor(dev), spec.voxel_size_tensor(dev))
    for fn in (B3, B4, B5):
        fn.launches = 0
    t0 = time.perf_counter()
    sdf = jfa(grid, spec, backend="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B3": B3.launches, "B4": B4.launches, "B5": B5.launches}
    steps = n.bit_length() - 1
    print(f"jfa() at {n}^3: {wall:.3f} s; launches {launches}")
    require(launches["B4"] == steps and launches["B3"] == 0 and launches["B5"] == 1,
            f"jfa at {n}^3 must run B4 at each of its {steps} strides and not B3")

    occ = grid.to_dense()
    org = J.org_tensor(spec, dev)
    b4_ms, b3_ms, plain_ms, flops = [], [], [], []
    with uncounted(B3, B4, B5):
        seed = jfa_init_seed(occ)
        k = n // 2
        while k >= 1:
            nxt = B3(seed, org, k)
            got = B4(seed, org, k)
            errs["B4"] = max(errs["B4"], int_err(got, nxt))
            require(torch.equal(got, nxt), f"B4 differs from B3 at k={k}")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            plain = J.flood_step_rows_plain(seed, org, k)
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
            errs["B4"] = max(errs["B4"], int_err(got, plain))
            require(torch.equal(got, plain), f"B4 differs from its plain version at k={k}")
            del got, plain
            b4_ms.append(cuda_ms(lambda: B4(seed, org, k), reps=3))
            b3_ms.append(cuda_ms(lambda: B3(seed, org, k), reps=3))
            flops.append(flood_flops(seed, k))
            print(f"k={k}: B4 {b4_ms[-1]:.3f} ms, B3 {b3_ms[-1]:.3f} ms, plain "
                  f"{plain_ms[-1]:.1f} ms, equal")
            seed = nxt
            k //= 2
        chain = B5(seed, occ, org)
    require(bitwise_equal(sdf, chain), f"jfa() at {n}^3 differs from the B3 chain")
    finite = float(torch.isfinite(sdf).float().mean())
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["B4"] = (mean(b4_ms), mean(plain_ms))
    bounds["B4"] = bound(nbytes(seed, org) + 4 * n ** 3, mean(flops))
    print(f"B4 at {n}^3 per step (mean of k={n // 2}..1): kernel {timings['B4'][0]:.4f} "
          f"ms, B3 {mean(b3_ms):.4f} ms, plain {timings['B4'][1]:.1f} ms, bound "
          f"{bounds['B4'][0]:.4f} ms ({bounds['B4'][1]}); SDF bitwise equal to the B3 "
          f"chain, {int(occ.sum()):,} voxels, finite share {finite}")
    return launches["B4"]


def probe_run(dev, errs, timings, bounds) -> int:
    """Phase 4c: the probe runner `tools/probe_jfa_micro.py` at PROBE_N
    on its ball-shell seeds for PROBE_KS (every variant timed, hoist and
    hoistv asserted bitwise equal to B3 there); then PROBE_ROW held
    against its plain version and timed beside it. Returns P1's
    launches in the runner's run."""
    import importlib.util

    import torch

    from voxtpu_torch.ops import jfa_probe

    spec = importlib.util.spec_from_file_location(
        "probe_jfa_micro", os.path.join(ROOT, "tools", "probe_jfa_micro.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    P1 = jfa_probe.flood_probe
    P1.launches = 0
    try:
        times = runner.probe(PROBE_N, PROBE_KS, 5, dev)
    except AssertionError as e:
        raise SmokeFailure(f"P1: {e}") from e
    launches = P1.launches
    require(launches > 0, "the probe never launched P1")

    seed, org = runner.shell_seeds(PROBE_N, dev)
    plain_ms, flops = [], []
    with uncounted(P1):
        for k in PROBE_KS:
            got = P1(seed, org, k, PROBE_ROW)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = jfa_probe.flood_probe_plain(seed, org, k, PROBE_ROW)
            end.record()
            end.synchronize()
            plain_ms.append(start.elapsed_time(end))
            errs["P1"] = max(errs["P1"], int_err(got, want))
            require(torch.equal(got, want), f"P1 {PROBE_ROW} differs from plain at k={k}")
            flops.append(flood_flops(seed, k))
            del got, want
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["P1"] = (mean([times[k][PROBE_ROW] for k in PROBE_KS]), mean(plain_ms))
    bounds["P1"] = bound(nbytes(seed, org) + 4 * seed.numel(), mean(flops))
    for k in PROBE_KS:
        t = times[k]
        print(f"P1 k={k}: legacy {t['legacy']:.4f}, hoist {t['hoist']:.4f}, hoistv "
              f"{t['hoistv']:.4f}, rolls {t['rolls']:.4f}, alu {t['alu']:.4f} ms; reads "
              f"(rolls) {t['rolls'] / t['legacy']:.3f} and arithmetic (alu) "
              f"{t['alu'] / t['legacy']:.3f} of legacy")
    print(f"P1 {PROBE_ROW} per step (mean of k={PROBE_KS}): kernel {timings['P1'][0]:.4f} "
          f"ms, plain {timings['P1'][1]:.1f} ms, bound {bounds['P1'][0]:.4f} ms "
          f"({bounds['P1'][1]}); launches {launches}")
    return launches


def plain_cli_on_card(dev) -> None:
    """Phase 4b, last: the CLI's -t 1 (plain route) with --device cuda
    at PLAIN_CLI_N on two small washers equals its -t 2."""
    import torch

    from voxtpu_torch import cli
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.mesh.obj_io import export_mesh

    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_plain_") as tmp:
        paths = []
        for name, center in (("ring_a", (2.0, 2.0, 2.0)), ("ring_b", (2.5, 2.0, 2.0625))):
            c, f = procedural.washer(0.75, 1.0, 0.25, 96, center=center)
            paths.append(os.path.join(tmp, f"{name}.obj"))
            export_mesh(paths[-1], Mesh(name=name, coords=c, faces=f, faces_normals=f))
        argv = [*paths, "-n", str(PLAIN_CLI_N), "-p", "1", "-s", "--device", str(dev)]
        plain = cli.run([*argv, "-t", "1"])
        cuda = cli.run([*argv, "-t", "2"])
    x = xor_popcount(plain.grids[0].words, cuda.grids[0].words)
    require(x == 0, f"-t 1 grid differs from -t 2 (xor popcount {x})")
    require(plain.grids[0].count() > 0, "-t 1 grid is empty")
    require(bitwise_equal(plain.sdf, cuda.sdf), "-t 1 SDF differs from -t 2")
    print(f"CLI -t 1 --device {dev} at {PLAIN_CLI_N}^3: grid ({plain.grids[0].count():,} "
          "voxels) xor 0 and SDF bitwise equal to -t 2")


def run() -> int:
    import numpy as np
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
    from voxtpu_torch.ops import (jfa_cuda, jfa_probe, vox_cuda, vox_slots_banded,
                                  vox_work_queue)
    from voxtpu_torch.ops.jfa import jfa, jfa_init_seed
    from voxtpu_torch.ops.reference import jfa_ref, voxelize_ref
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    B1, B2 = vox_slots_banded.banded_fill, vox_cuda.wide_fill
    B3, B5, B6 = jfa_cuda.flood_step, jfa_cuda.sdf_from_seed, jfa_cuda.flood_step_pipe
    B14, P1 = vox_work_queue.wq_fill, jfa_probe.flood_probe
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

    errs = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0.0, "B6": 0.0, "B12": 0, "B14": 0,
            "P1": 0}

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

    grid128 = BandedSlotVoxPipeline(sphere, spec128, dev)()
    occ128 = grid128.to_dense()
    org = jfa_cuda.org_tensor(spec128, dev)
    seed = jfa_init_seed(occ128)
    k = 64
    while k >= 1:
        got = B3(seed, org, k)
        want = jfa_cuda.flood_step_plain(seed, org, k)
        errs["B3"] = max(errs["B3"], int_err(got, want))
        require(torch.equal(got, want), f"B3 differs from plain at k={k}")
        pipe_got = B6(seed, org, k)
        pipe_plain = jfa_cuda.flood_step_pipe_plain(seed, org, k)
        errs["B6"] = max(errs["B6"], int_err(pipe_got, got), int_err(pipe_got, pipe_plain))
        require(torch.equal(pipe_got, got) and torch.equal(pipe_got, pipe_plain),
                f"B6 differs from B3 or its plain version at k={k}")
        if k == 1:
            pipe_sdf = B6(seed, org, 1, occ128)
            pipe_plain = jfa_cuda.flood_step_pipe_plain(seed, org, 1, occ128)
            chain = B5(got, occ128, org)
            errs["B6"] = max(errs["B6"], float_err(pipe_sdf, chain),
                             float_err(pipe_sdf, pipe_plain))
            require(bitwise_equal(pipe_sdf, chain) and bitwise_equal(pipe_sdf, pipe_plain),
                    "B6 with the signed distance differs from B5 after B3 or its plain "
                    "version")
        seed = got
        k //= 2
    got = B5(seed, occ128, org)
    want = jfa_cuda.sdf_from_seed_plain(seed, occ128, org)
    errs["B5"] = max(errs["B5"], float_err(got, want))
    require(bitwise_equal(got, want), "B5 differs from plain (n=128)")
    print("B3, B6 at k=64..1 (B6 with the signed distance at k=1) and B5 at n=128: equal")

    wplan = vox_work_queue.WorkQueueVoxPlan(sphere, spec128, dev, seg=64)
    got = B14(*wplan.args(), n=128, tc=wplan.tc)
    want = vox_work_queue.wq_fill_plain(*wplan.args(), n=128, tc=wplan.tc)
    errs["B14"] = max(errs["B14"], int_err(got, want), int_err(got, grid128.words))
    require(torch.equal(got, want) and torch.equal(got, grid128.words),
            "B14 differs from its plain version or the banded grid (n=128)")
    print(f"B14 n=128 seg=64: {wplan.num_fragments} fragments on {wplan.num_active} tiles, "
          "equal to its plain version and the banded grid")

    spec64 = GridSpec.fit(sphere.coords, 64)
    grid64 = BandedSlotVoxPipeline(sphere, spec64, dev)()
    oracle_occ = voxelize_ref(sphere, spec64)
    require(torch.equal(grid64.words.cpu(), pack_bits(torch.from_numpy(oracle_occ))),
            "voxelizer differs from voxelize_ref at n=64")
    sdf64 = jfa_cuda.jfa_cuda(grid64.to_dense(), spec64).cpu()
    require(bitwise_equal(sdf64, torch.from_numpy(jfa_ref(oracle_occ, spec64))),
            "JFA differs from jfa_ref at n=64")
    print(f"n=64 oracle: grid ({int(oracle_occ.sum())} voxels) and SDF bitwise equal")

    seed = jfa_init_seed(grid64.to_dense())
    org = jfa_cuda.org_tensor(spec64, dev)
    for k in (32, 4, 1):
        b3 = B3(seed, org, k)
        for variant in jfa_probe.VARIANTS:
            got = P1(seed, org, k, variant)
            want = jfa_probe.flood_probe_plain(seed, org, k, variant)
            errs["P1"] = max(errs["P1"], int_err(got, want))
            require(torch.equal(got, want), f"P1 {variant} differs from plain at k={k}")
            if variant in ("legacy", "hoist", "hoistv"):
                require(torch.equal(got, b3), f"P1 {variant} differs from B3 at k={k}")
    print(f"P1 {', '.join(jfa_probe.VARIANTS)} at n=64, k=32, 4, 1: equal to their plain "
          "versions; legacy, hoist, hoistv equal to B3")

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
        n3 = MAIN_N ** 3
        bounds = {
            "B1": bound(nbytes(lk, xs, st.batch_tile, st.batch_basew) + n3 // 8),
            "B2": bound(nbytes(wk, wxs, w_ctile) + w_uidx.shape[0] * p0.tc * MAIN_N // 8),
            "B3": bound(nbytes(seed0, org) + 4 * n3,
                        sum(flood_flops(si, ki) for si, ki in seeds) / len(seeds)),
            "B5": bound(nbytes(final_seed, occ, org) + 4 * n3,
                        7 * n3 + 14 * int((final_seed >= 0).sum())),
        }
        for name, (ms, plain_ms) in timings.items():
            print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]})")
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
        launches["B6"] = jfa_pipe(errs, timings, bounds, result, occ, org, seeds)
        probe_main_path(org, seeds)
    # The serving path's grids and seeds (~6 GiB) are not the training
    # path's: free them before its peak memory is read.
    del result, occ, seeds, seed0, s, final_seed, seed_plain, sdf_plain, pipes, folded
    del plain, live_k, live_xs, got, want
    torch.cuda.empty_cache()

    # ---- 4b. voxtpu's own routes: word events (B12), B4, -t 1 -------------------
    phase(f"4b. word-event route (B12) at {WE_SIZES}, B4 at {JFA_N}^3, -t 1 on the card")
    t_phase = time.perf_counter()
    check_word_event_small(dev, errs, sphere)
    washers = [mesh_of(c, f, "washer_a"), mesh_of(shifted, f, "washer_b")]
    launches["B12"], launches["B14"], kept, spec1024 = word_event_route(
        dev, errs, timings, bounds, washers)
    union = kept[0] | kept[1]
    del kept
    launches["B4"] = jfa_rows(dev, errs, timings, bounds, union, spec1024)
    del union
    torch.cuda.empty_cache()
    spec_big = GridSpec.fit(np.concatenate([m.coords for m in washers]), WQ_BIG_N)
    launches["B14"] += wq_big(errs, timings, washers[0], spec_big, dev)
    del washers
    torch.cuda.empty_cache()
    plain_cli_on_card(dev)
    print(f"phase 4b: {time.perf_counter() - t_phase:.1f} s")

    # ---- 4c. the flood-step probe P1 ----------------------------------------------
    phase(f"4c. flood-step probe P1 at {PROBE_N}^3, k = {PROBE_KS}")
    launches["P1"] = probe_run(dev, errs, timings, bounds)

    # ---- 5. training kernels vs plain ------------------------------------------
    phase(f"5. training kernels against their plain versions (n={KERNEL_N})")
    check_training_kernels(dev, errs)
    phase(f"5b. seg kernels against their plain versions (n={SEG_N})")
    check_seg_kernels(dev, errs)

    # ---- 6. training path --------------------------------------------------------
    phase(f"6. training path: VoxelFit at {MAIN_N}^3 on {MAIN_FACES:,} faces")
    train = training_path(dev, errs, timings, bounds)
    launches.update({k: train[k]
                     for k in ("B7", "B8", "B9", "B10", "B11", "B13f", "B13b")})

    # ---- 7. the fitting example --------------------------------------------------
    phase("7. examples.fit_vertices on the card")
    fit_example(dev)

    # ---- 8. result lines ------------------------------------------------------
    phase("8. result")
    soft = "voxtpu_torch/csrc/soft_vox.cu"
    seg = "voxtpu_torch/csrc/soft_vox_seg.cu"
    table = [
        ("B1", "B1 banded_fill", "voxtpu_torch/csrc/vox_fill.cu",
         "voxtpu/ops/vox_slots_banded.py:118"),
        ("B2", "B2 wide_fill", "voxtpu_torch/csrc/vox_fill.cu",
         "voxtpu/ops/vox_pallas.py:56"),
        ("B3", "B3 flood_step", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:43"),
        ("B4", "B4 flood_step_rows", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:168"),
        ("B5", "B5 sdf_from_seed", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:442"),
        ("B6", "B6 flood_step_pipe", "voxtpu_torch/csrc/jfa.cu",
         "voxtpu/ops/jfa_pallas.py:297"),
        ("B7", "B7 fused_fwd", soft, "voxtpu/ops/soft_vox_fused.py:209"),
        ("B8", "B8 fused_bwd", soft, "voxtpu/ops/soft_vox_fused.py:284"),
        ("B9", "B9 seg_fwd", seg, "voxtpu/ops/soft_vox_seg.py:89"),
        ("B10", "B10 seg_combine", seg, "voxtpu/ops/soft_vox_seg.py:313"),
        ("B11", "B11 seg_bwd", seg, "voxtpu/ops/soft_vox_seg.py:169"),
        ("B12", "B12 word_event_fill", "voxtpu_torch/csrc/vox_we.cu",
         "voxtpu/ops/vox_pallas_we.py:71"),
        ("B13f", "B13 fragment_fwd", soft, "voxtpu/ops/soft_vox_pallas.py:49"),
        ("B13b", "B13 fragment_bwd", soft, "voxtpu/ops/soft_vox_pallas.py:88"),
        ("B14", "B14 wq_fill", "voxtpu_torch/csrc/vox_wq.cu",
         "voxtpu/ops/vox_pallas_wq.py:35"),
        ("P1", f"P1 flood_probe ({PROBE_ROW})", "voxtpu_torch/csrc/jfa_probe.cu",
         "scripts/probe_jfa_micro.py:56"),
    ]
    # library_ms: no single PyTorch call computes a parity fill, a
    # 26-candidate flood step (or a variant of one), a seeded distance,
    # a per-slot sigmoid profile or its cotangents, the seg combine's
    # gather, or a word-event or work-queue XOR fill.
    kernels = []
    for key, name, source, replaces in table:
        ms, plain_ms = timings[key]
        bound_ms, bound_by = bounds[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
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
