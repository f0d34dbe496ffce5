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
   fill) through the pipeline on the icosahedron at n=192, band=64 (in
   place into B1's grid), and on live random slots, into a buffer and in
   place into a random grid against the plain fill and its merge; B3
   (flood step) at every stride of n=128, and
   B4 (row-band flood step, bands of 32 and 100) against it; B5
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
   kernel, C1's both passes once for each of the CLI's two plans; the
   folded grid must equal the plain pipeline on the card
   (xor popcount 0) and the SDF the plain flood (bitwise, inf == inf);
   every B3 step of the flood must equal its plain version and B4 in
   bands of 256 and 100. The batches per tile that B1 and B2 see are
   printed with their cluster sizes. Then each kernel is timed beside
   its plain version at these shapes (CUDA events, warm, median of 5
   single calls); B1, B2 (in place, as the pipeline runs it, and into a
   compact buffer) and B5 also as the device time a launch over a run of
   back-to-back launches (`device_ms`: a single call's time also holds
   the wrapper's host work, which the card waits for), each beside its
   bound (B2 in place: slots + 2 x k x tc x n/8 bytes). The washers'
   wide slots are all inert (an x-parallel cap covers no cell centre),
   so B2 is also held (into a buffer and in place) and timed on random
   live slots of the same shape and tiles. One whole banded_total call
   is timed (a call in a run, a single call, the host wall of
   `words()`), and its host part split into the geometry tensors, the
   emit, the wrappers' checks, the allocation, data_ptr and the stream,
   and the ctypes calls (`host_split`). C1, the serving plan's band cut
   (`csrc/vox_plan.cu`), is caught on the sorted slots washer_a's plan
   hands it: both passes bitwise their plain versions on host copies,
   timed (a single call and `device_ms`) beside its bound and the plain
   versions' host time. Then, while the
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
   and 1024^3, the banded pipeline's grid (B1, B2 in place) must equal
   the plain pipeline's (xor popcount 0), and at 1024^3 B1 and B2 are
   timed on washer_a as in phase 4 with the batches per tile and one
   whole banded_total call; `voxelize(backend="word_event")` on a
   WordEventVoxPlan and DeviceVoxPipeline.words() must each equal the
   banded pipeline's grid (xor popcount 0, overflow 0) and launch B12,
   which is held
   against its plain version at full size and timed on washer_a at both
   sizes (a single call and `device_ms`); events, batches, plan build
   times and the per-call totals of DeviceVoxPipeline.words() and of
   the banded pipeline (CUDA events, warm, median of 5) are printed.
   `jfa()` on the union of the two 1024^3 grids must run B4 (row-band
   flood step) and not B3, and equal a B3 chain bitwise; B4 is held
   against B3 and against its band-wise plain version at every stride,
   and B4 and B3 are timed per step; B5 on the chain's seeds is timed at
   1024^3 (a single call and `device_ms`). `voxelize_wq` on a WorkQueueVoxPlan
   of the same fragments must equal the banded grid at 512^3 and 1024^3
   on each washer and launch B14 once a call; B14 is held against its
   plain version there and timed on washer_a at 512^3 (both ways); at 2048^3 on
   washer_a (a 1.07 GB grid) it must equal `resolve_fragments` on the
   same fragments, and is timed. voxtpu's two cross-check routes on B2
   at 512^3 on washer_a: SlotVoxPipeline and the suffix route of a
   PallasVoxPlan at seg = 512 and 256 (on the word-event route's
   fragments) must each equal the banded grid (xor popcount 0) and
   launch B2 once a call (counted and printed, with their plan builds
   and per-call times). Last, the CLI with -t 1 (the plain route) on
   the card at n=128 on two small washers must equal -t 2: grid xor 0,
   SDF bitwise.
4c. The flood-step probe P1 through its runner
   (`tools/probe_jfa_micro.py`) at 512^3 on ball-shell seeds, k = 4 and
   128: every variant timed, `hoist` / `hoistv` bitwise equal to B3;
   `hoistv` held against its plain version and timed beside it.
4d. The CLI with --trace at 128^3 on two small washers: the trace that
   torch.profiler writes must hold the CLI's scopes as named ranges and
   the fill kernel (suffix_fill_kernel, B1 and B2). Then the CLI at
   1280^3 on phase 4's two washers (-t 2 -p 1 -s, phase 4b's state
   freed): its SDF must take the wide (hi, lo) flood (torch ops): B1
   and B2 launch, B3-B6 never, and the [CudaJFA::wide] scope prints;
   the field must pass tools/check_jfa_wide.py's check_wide_field:
   signs follow the folded occupancy, sdf == 0 exactly on the boundary
   mask and nowhere else, and on 1024 seeded sample voxels |sdf| is
   never below the brute-force nearest boundary seed (same float
   formula) and above it by more than rtol 1e-5 at under 1% of them.
   Prints the phase's wall time, the JFA's time per step and the peak
   device memory. Between the two, the CLI's -t 3 (voxtpu's native
   C++/OpenMP backend on the host, `voxtpu_torch/native`) at 128^3 on
   the small washers: its grid xor popcount 0 against -t 0's, its SDF
   within rtol 1e-6 of the oracle's, both on the card; its wall printed.
4e. The main path at voxtpu's largest grid (every earlier phase's state
   freed): phase 4's washer_a at 4096^3 (its own grid fit, band 256, as
   voxtpu's bench runs it), every grid kept packed (2^31 words, 8 GiB):
   `BandedSlotVoxPipeline.words()` must give overflow 0 and launch B1
   and B2 once each (counted from 0 around the call); its grid must have
   xor popcount 0 against `DeviceVoxPipeline.words()` (B12 launched
   once, overflow 0) and the same `grid_digest`, and equal the plane
   oracle (`voxelize_ref_planes`) on 8 z-planes spread over the occupied
   ones; its occupied count is printed. B1, B2 (in place) and B12 are
   timed as phase 4b times them (a single call and `device_ms`) beside
   their bounds, the per-call totals of both pipelines with
   `utils/timing.py::time_device_fn`, with the plan builds (s) and the
   peak device memory (`large_grid`, which `tools/check_large_grids.py`
   also runs).
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
   full size and times them (CUDA events, warm, median of 3). Each
   plan B7 / B8 are held on prints its live slots and their mean
   transition window in columns (`window_widths`). The loss
   must fall and B1, B7, B8 launch (and B2 if the target routed
   candidates to it; the rotated torus has no x-degenerate face, so it
   routes none). After the last step all four training kernels are held
   again on the refreshed plan, the densest of the path, within the
   same limits. The fused plans are built on the card (torch ops and
   C2, the pair cut, both of whose passes launch once a plan: 2 plans,
   4 launches, the kernel table's count); C2 is caught on the pairs of
   the refreshed soft plan's fused plan, both passes held bitwise against
   their plain versions on host copies and timed (a single call and
   `device_ms`) beside its bound and the plain versions' host time.
   Then `VoxelFit(engine="seg")` runs the same 5 steps
   from the same plan and start: B9 / B10 / B11 held and timed on step
   1's inputs and held again on its refreshed plan (each plan printing
   its live slots and their mean transition window clipped to the
   panel, `seg_window_widths`), launches once per step (B9 / B10 also
   for the final loss), its first loss the fused engine's within 1e-4
   relative, its warm step printed beside the fused one. Then
   `VoxelFit(engine="cuda")` takes 2 steps from the same start on the
   same plan, each printed with its wall time and peak device memory:
   B13 fwd / bwd are held and timed as B7 / B8 were, and its first loss
   must equal the fused engine's within 1e-4 relative. The
   kernel table's launches are phase 4's for B1-B5 and this phase's for
   B7-B11, B13 and C2 (phase 4b's for B4 and B12).
6b. The sharded paths (`voxtpu_torch.parallel`), after the kernels were
   built in phase 2: this script starts itself as the ranks of a world
   (`--sharded-rank WORLD RANK BACKEND DIR`), each importing only
   voxtpu_torch, with a timeout a world, inputs and results passing
   through files in a temporary directory; any rank's failure fails the
   phase. A world of 1 on NCCL (cuda:0), then a world of 2 on gloo
   with both ranks on cuda:0 (NCCL refuses two ranks on one device; the
   collectives stage CUDA tensors through the host and count the bytes).
   Each rank takes its card from the world (`world_card`): its own,
   `init_distributed`'s choice, for an NCCL world on a host with a card
   a rank; cuda:0 for the gloo world. The same rank body and checks run
   NCCL worlds of 2 and 4 on four cards (`tools/check_sharded_cards.py`;
   `world_layout` gives each world's mesh shapes).
   Vox: `voxelize_sharded` on phase 4's two washers at 512^3 on (1, W)
   and (W, 1), ring and gather: every assembled grid xor popcount 0
   against the banded pipeline's. JFA: `jfa_sharded` on the union of the
   (1, W) slabs: packed bitwise the CLI's SDF route (B3 + B5), wide
   bitwise `jfa_wide`; wall and each step's time (a replay of the
   flood, bitwise the call). Fit: the cuda (B13), fused (B7/B8) and seg
   (B9-B11) sharded engines at 512^3 on phase 6's torus, target and
   start on (1, W), and the plain engine at 128^3 on phase 5's icosphere
   (one step), the cuda engine's gradient there on (W, 1) (the d axis).
   World 1: loss within 1e-6 relative and gradient within 1e-3 x max|g|
   of the single-device engine on the same plan. World 2: first loss
   within 1e-5 relative of phase 6's for that engine, gradient within
   1e-3 x max|g| of world 1's, SHARDED_STEPS steps after which the loss
   is lower, coordinates bitwise equal on both ranks, each rank's kernels
   held against their plain versions on its plan (phase 5's limits; B13
   timed on rank 0's plan while rank 1 waits) and launched on each rank
   (counted from zero around the engine's run). Prints walls, each
   rank's peak memory, staged bytes and launch counts, with the card's
   name and power limit: on one card the times measure staging through
   the host, not scaling. Last, `python -m voxtpu_torch.parallel.dryrun
   1` (voxtpu's dryrun_multichip, one NCCL rank) must print its line.
7. `python -m voxtpu_torch.examples.fit_vertices --n 64 --steps 10
   --engine fused` on an OBJ written here must exit 0 with an improved
   hard IoU.
8. Prints each kernel's largest error as a share of its limit, the
   card's name and power limit, the kernel table as one JSON line (each
   kernel's launches, error, time (`ms`, a single call), `device_ms` (a
   launch in a run, for B1, B2, B5, B12, B14; null for the others),
   plain time and bound: the larger of
   its bytes over the memory rate and its operations over their peak
   rate, counted from this run's inputs; `bound`; a soft kernel's
   sigmoids counted over its slots' transition windows only, clipped to
   the panel for B9 and B11, the every-pair or every-panel-column count
   printed beside it), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
   Launches are those of each kernel's own path: phase 4's CLI call
   (B1-B3, B5) and `jfa(pipe=True)` (B6); phase 4b's routes (B4, B12,
   B14); phase 4c's probe (P1); phase 6 (the training kernels); phase
   6b's world of 2 (both ranks) for the two rows of B13's sharded sites
   and the `sharded_launches` of B7-B11 and B13.

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
WIDE_N = 1280           # phase 4d: the CLI's SDF on the wide (hi, lo) flood
LARGE_N = 4096          # phase 4e: voxtpu's largest banded grid (bench.py:503-552)
ORACLE_PLANES = 8       # phase 4e: z-planes held against the plane oracle
PLANE_CHUNK = 64        # planes a chunk of the per-plane popcount
MAX_ARBITRATED = 32     # planes where a witness differs that the plane oracle decides
TRACE_N = 128           # phase 4d: the CLI with --trace
SHARDED_STEPS = 3       # phase 6b: each kernel engine's steps in the world of 2

# The least time the card could take for a kernel's work (`bound`): the
# larger of its bytes over the memory rate and its operations over their
# peak rate. NVIDIA H100 SXM at its 700 W limit: 3.35 TB/s, 67 TFLOP/s
# float32 outside the tensor cores (an FMA counted as two operations),
# the special-function units (expf's ex2, the reciprocal behind each
# IEEE division) at 16 results per SM per clock (compute capability 9.0)
# x 132 SMs x 1.98 GHz, uncontracted float32 operations (each add,
# subtract or multiply on its own, as the flood's exact distance must
# be: no FMA) at 128 per SM per clock, and float32 compares at 64.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
SFU_OP_S = 16 * 132 * 1.98e9
F32_UNFUSED_OP_S = 128 * 132 * 1.98e9
CMP_OP_S = 64 * 132 * 1.98e9
# Operations (float32, special-function) of the soft kernels, counted
# from the sources: a forward (slot, column) pair is the column centre
# (3), (xh - cx) / tau_x, the sigmoid 1 / (1 + expf(-v)), w * sig and
# its fixed-point scaling (6), with three special-function operations
# (two divisions, one expf); a backward pair adds the cotangent's
# products and the two running sums (5 more). A slot's fragment rebuild
# is 3 edge sigmoids and the weight and x-hit (37, 9 special); the
# chain rule to 13 cotangents 30 more (3 divisions).
# Each (slot, column) pair outside a slot's transition window has a
# term known without its sigmoid (`window_widths`): the thresholds of
# csrc/soft_common.cuh (kSatHi, kSatLo) on (xh - cx) / tau_x.
SAT_HI, SAT_LO = 17.0, -29.0
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


def device_ms(fn, launches: int = 50, runs: int = 3) -> float:
    """Device time of one fn() in ms: a run of `launches` back-to-back
    calls between one pair of CUDA events, over the count (the median of
    `runs` runs), after one warm-up. The stream first sleeps until the
    host has queued the whole run, so the card never waits for the host
    inside it; `cuda_ms`'s single call holds that wait too. A run whose
    start event had passed before the host finished queueing is taken
    again behind a longer sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    torch.cuda.synchronize()
    sleep_s = 2 * (time.perf_counter() - t0)  # the host's time for a run, and the card's
    means = []
    while len(means) < runs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))  # clock cycles, at most ~2 GHz
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        waited = start.query()  # the card reached the run before its last launch was queued
        end.synchronize()
        if waited:
            require(sleep_s < 1.0, "device_ms: the host cannot queue a run ahead of the card")
            sleep_s *= 2
            continue
        means.append(start.elapsed_time(end) / launches)
    return sorted(means)[len(means) // 2]


def bound(nbytes: float, flops: float = 0.0, sfu: float = 0.0, unfused: float = 0.0,
          cmp: float = 0.0):
    """(ms, "bytes" or "operations"): the least time for `nbytes` of
    device memory traffic, `flops` float32 operations (FMAs allowed),
    `unfused` float32 operations that may not contract, `sfu`
    special-function operations and `cmp` float32 compares (each unit
    at its own rate, side by side), and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(flops / F32_FLOP_S + unfused / F32_UNFUSED_OP_S, sfu / SFU_OP_S,
                cmp / CMP_OP_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def soft_bound(moved: int, slots: int, pairs: int, backward: bool, rebuild: bool = True):
    """The bound of a soft kernel: `moved` bytes, `slots` live slots
    and `pairs` (slot, column) pairs whose sigmoid the function needs;
    `rebuild` (the fused and seg kernels) adds each slot's fragment
    and, backward, its chain rule."""
    pair = PAIR_BWD if backward else PAIR_FWD
    per_slot = [(f + (c if backward else 0)) * rebuild
                for f, c in zip(SLOT_FRAG, SLOT_CHAIN)]
    return bound(moved, pairs * pair[0] + slots * per_slot[0],
                 pairs * pair[1] + slots * per_slot[1])


def window_ends(xh, ok, n: int, ox: float, vs: float, tau_x: float):
    """Per slot, the transition window [a, b) of
    `csrc/soft_common.cuh::slot_window` over the row's n columns (left of
    a the sigmoid is exactly 1, from b on the term rounds to 0 in the
    fixed point), found as the kernels find it, by stepping the float32
    argument (xh - cx) / tau_x from an estimate; a slot that is not `ok`
    gets the window of x_hit = 0."""
    import torch

    xh = torch.where(ok, xh, torch.zeros_like(xh))

    def arg(col):
        return (xh - (ox + (col.float() * vs + vs * 0.5))) / tau_x

    def step(col, move, sign):
        while True:
            m = move(col)
            if not bool(m.any()):
                return col
            col = col + sign * m.long()

    at = (xh - ox) / vs - 0.5
    r = tau_x / vs
    a = (at - SAT_HI * r).clamp(0, n).long()
    a = step(a, lambda c: (c > 0) & (arg(c - 1) < SAT_HI), -1)
    a = step(a, lambda c: (c < n) & (arg(c) >= SAT_HI), 1)
    b = torch.maximum(a, (at - SAT_LO * r + 1.0).clamp(0, n).long())
    b = step(b, lambda c: (c > a) & (arg(c - 1) <= SAT_LO), -1)
    b = step(b, lambda c: (c < n) & (arg(c) > SAT_LO), 1)
    return a, b


def window_widths(xh, ok, n: int, ox: float, vs: float, tau_x: float):
    """Per slot, the columns of the row whose sigmoid the soft profile
    needs (`window_ends`); n for a slot that is not `ok` (|w| > 1 or a
    non-finite x_hit: the whole row). One count for B7, B8 and B13,
    whatever each kernel evaluates."""
    import torch

    a, b = window_ends(xh, ok, n, ox, vs, tau_x)
    return torch.where(ok, b - a, torch.full_like(a, n))


def seg_window_widths(xh, ok, p0, n: int, ox: float, vs: float, tau_x: float):
    """Per seg slot, the columns of its panel [p0, p0 + 128) whose
    sigmoid the profile needs: `window_ends` clipped to the panel (0
    where the window lies wholly outside it); 128 for a slot that is not
    `ok` (the whole panel). One count for B9 and B11."""
    import torch

    from voxtpu_torch.ops.soft_vox_seg import PANEL

    a, b = window_ends(xh, ok, n, ox, vs, tau_x)
    a, b = (torch.minimum(torch.maximum(e, p0), p0 + PANEL) for e in (a, b))
    return torch.where(ok, b - a, torch.full_like(a, PANEL))


def fused_windows(fp, tables, prm):
    """(live slots, (slot, column) pairs in their windows) of a fused
    plan's tables, the x_hit and w rebuilt as the plain version does."""
    import torch

    from voxtpu_torch.ops import soft_vox_fused as F

    slots = pairs = 0
    for b0 in range(0, fp.num_batches, 4096):
        b1 = min(b0 + 4096, fp.num_batches)
        valid, *_, w, xh = F._fused_slots(tables, fp.cells_d, fp.tblidx_d, fp.batch_tile_d,
                                          b0, b1, n=fp.spec.n, tc=fp.tc, prm=prm)
        ok = (w.abs() <= 1) & torch.isfinite(xh)
        widths = window_widths(xh[valid], ok[valid], fp.spec.n, prm[0], prm[3], prm[5])
        slots += int(valid.sum())
        pairs += int(widths.sum())
    return slots, pairs


def seg_windows(plan, tables, prm):
    """(live slots, (slot, column) pairs in their clipped windows) of a
    seg plan's tables, the x_hit and w rebuilt as the plain version
    does."""
    import torch

    from voxtpu_torch.ops import soft_vox_seg as S

    slots = pairs = 0
    for b0 in range(0, plan.num_batches, 4096):
        b1 = min(b0 + 4096, plan.num_batches)
        valid, _, _, p0, *_, w, xh = S._seg_slots(
            tables, plan.cells_d, plan.tblidx_d, plan.batch_tile_d, plan.batch_panel_d, b0,
            b1, n=plan.spec.n, tc=plan.tc, tz=plan.tz, prm=prm)
        ok = (w.abs() <= 1) & torch.isfinite(xh)
        widths = seg_window_widths(xh[valid], ok[valid], p0.expand_as(w)[valid], plan.spec.n,
                                   prm[0], prm[3], prm[5])
        slots += int(valid.sum())
        pairs += int(widths.sum())
    return slots, pairs


def live_slots(cells) -> int:
    return int((cells >= 0).sum())


def live_keys(tables, cells_b, tblidx_b, tc: int):
    """(live (B, tb) mask, (B, tb) local cells): the slots whose cell and
    table row the kernels read, as `soft_vox_fused.slot_rows` takes them."""
    nb, tbl = tables.shape[0], tables.shape[1]
    cells = cells_b.reshape(nb, -1).long()
    idx = tblidx_b.reshape(nb, -1).long()
    return (cells >= 0) & (cells < tc) & (idx >= 0) & (idx < tbl), cells


def table_bytes(tables, cells_b, tblidx_b, tc: int) -> int:
    """The bytes of the table rows that live slots read, each distinct
    (batch, row) once: a batch's table has room for more rows than its
    slots name."""
    import torch

    live, _ = live_keys(tables, cells_b, tblidx_b, tc)
    nb, tbl = tables.shape[0], tables.shape[1]
    keys = (torch.arange(nb, device=tables.device)[:, None] * tbl
            + tblidx_b.reshape(nb, -1).long())[live]
    return int(torch.unique(keys).numel()) * tables.shape[2] * tables.element_size()


def seg_cotangent_bytes(plan, tables) -> int:
    """The bytes of the cotangent that B11's function reads: the panel
    columns of the rows that hold live slots, each distinct (row,
    64-column half) once (left of a panel gpre stands for the row)."""
    import torch

    from voxtpu_torch.ops import soft_vox_seg as S

    n = plan.spec.n
    live, cells = live_keys(tables, plan.cells_d, plan.tblidx_d, plan.tc)
    gy, gz = S._decode_yz(plan.batch_tile_d.long()[:, None], cells, n=n, tc=plan.tc,
                          tz=plan.tz)
    half = (plan.batch_panel_d.long() // S.LATTICE)[:, None]
    first = ((gz * n + gy) * (n // S.LATTICE) + half)[live]
    halves = torch.unique(torch.cat([first, first + 1])).numel()
    return int(halves) * S.LATTICE * 4


def seeded_candidates(seed, k: int) -> tuple[int, int]:
    """The in-grid candidates (own seed included) that hold a seed, over
    all voxels, at stride k, and those of them in the voxel's own plane
    (dz = 0). The latter count the (seeded source entry, voxel column)
    pairs: the three candidates dz = -1, 0, 1 of one column that read
    one source entry share its (px - sx)^2 + (py - sy)^2."""
    n = seed.shape[0]
    valid = seed >= 0
    total = in_plane = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                box = tuple(slice(max(0, d * k), n + min(0, d * k)) for d in (dz, dy, dx))
                count = int(valid[box].sum())
                total += count
                in_plane += count if dz == 0 else 0
    return total, in_plane


def flood_ops(seed, k: int, emit_sdf: bool = False) -> tuple[int, int]:
    """(float32 operations, compares) that one flood step on `seed` at
    stride k needs, the one count of the step's work for B3, B4, B6 and
    P1 (whatever each kernel does beyond it). Float: each grid index's
    world coordinate, once an axis (2); each seed's unpack into world
    coordinates, once (9: three exact field conversions, 2^23 + f less
    2^23, and ox + f*vs); per seeded (source entry, voxel column) pair
    (px - sx)^2 + (py - sy)^2 (5); per seeded candidate (pz - sz)^2 and
    the sum (3; the others are +inf and need none); with the signed
    distance one product a voxel. Uncontracted: the exact distance
    forbids FMA. Compares: one per seeded candidate but the own seed."""
    n = seed.shape[0]
    seeded = int((seed >= 0).sum())
    candidates, pairs = seeded_candidates(seed, k)
    flops = 6 * n + 9 * seeded + 5 * pairs + 3 * candidates + emit_sdf * n ** 3
    return flops, candidates - seeded


def flood_bound(nbytes: float, ops: list):
    """`bound` of a flood kernel over `ops`, the `flood_ops` of its steps:
    their mean float operations (uncontracted) and compares."""
    return bound(nbytes, unfused=sum(f for f, _ in ops) / len(ops),
                 cmp=sum(c for _, c in ops) / len(ops))


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
    slots, pairs = fused_windows(fp, tables, kw["prm"])
    n = fp.spec.n
    print(f"B7 / B8 {what}: {slots:,} live slots, {pairs:,} window pairs, mean window "
          f"{pairs / max(slots, 1):.3f} of {n} columns")
    live = table_bytes(tables, fp.cells_d, fp.tblidx_d, fp.tc)
    moved = {"B7": live + nbytes(*args[1:], fp.run_start_d, occ),
             "B8": live + nbytes(*args[1:], g, dtab)}
    bounds = {key: soft_bound(moved[key], slots, pairs, key == "B8") for key in moved}
    for key in moved:
        every = soft_bound(moved[key], slots, slots * n, key == "B8")
        print(f"{key} {what}: bound {bounds[key][0]:.4f} ms ({bounds[key][1]}); counting "
              f"every pair {every[0]:.4f} ms ({every[1]})")
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
    live = cp.cells_d.reshape(-1) >= 0
    xl = xb.reshape(-1)[live]
    ok = (wb.reshape(-1)[live].abs() <= 1) & torch.isfinite(xl)
    slots = int(live.sum())
    pairs = int(window_widths(xl, ok, spec.n, kw["prm"][0], vs, tau_x).sum())
    moved = {"B13f": nbytes(*args, cp.run_start_d, occ), "B13b": nbytes(*args, g, *grads)}
    bounds = {key: soft_bound(moved[key], slots, pairs, key == "B13b", rebuild=False)
              for key in moved}
    for key in moved:
        every = soft_bound(moved[key], slots, slots * spec.n, key == "B13b", rebuild=False)
        print(f"{key} {what}: {slots:,} live slots, mean window {pairs / max(slots, 1):.3f}"
              f" columns; bound {bounds[key][0]:.4f} ms ({bounds[key][1]}); counting "
              f"every pair {every[0]:.4f} ms ({every[1]})")
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
    slots, pairs = seg_windows(plan, tables, prm)
    n = plan.spec.n
    print(f"B9 / B11 {what}: {slots:,} live slots, {pairs:,} window pairs, mean clipped "
          f"window {pairs / max(slots, 1):.3f} of {S.PANEL} panel columns")
    live = table_bytes(tables, plan.cells_d, plan.tblidx_d, plan.tc)
    gread = seg_cotangent_bytes(plan, tables)
    moved = {"B9": live + nbytes(*args[1:], plan.run_start_d, *parts),
             "B11": live + gread + nbytes(*args[1:], gpre, dtab)}
    print(f"B9 / B11 {what}: live table rows {live / 1e6:.3f} MB of {nbytes(tables) / 1e6:.3f}"
          f" MB; B11's cotangent over the live rows' panels {gread / 1e6:.3f} MB of "
          f"{nbytes(g) / 1e6:.3f} MB")
    bounds = {key: soft_bound(moved[key], slots, pairs, key == "B11") for key in moved}
    for key in moved:
        every = soft_bound(moved[key], slots, slots * S.PANEL, key == "B11")
        print(f"{key} {what}: {moved[key] / 1e6:.3f} MB moved; bound {bounds[key][0]:.4f} ms "
              f"({bounds[key][1]}); counting all {S.PANEL} panel columns {every[0]:.4f} ms "
              f"({every[1]})")
    bounds["B10"] = bound(nbytes(*parts, occ), 2 * n ** 3)
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
    plan. Returns (launch counts, walls, first loss)."""
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
    return launches, walls, losses[0]


def torus_case(dev, n: int = MAIN_N, faces: int = MAIN_FACES):
    """Phase 6's fit: the rotated torus, its grid spec at n, the start
    (shifted half a voxel along x plus 0.1 voxel of seeded jitter) and
    the target, its hard grid through the serving path on `dev` (B1,
    B2). Returns (mesh, spec, start, target, pipeline)."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.ops import vox_slots_banded
    from voxtpu_torch.ops.vox import voxelize

    t0 = time.perf_counter()
    mesh = rotated_torus(faces)
    spec = GridSpec.fit(mesh.coords, n)
    vs = spec.voxel_size
    rng = np.random.default_rng(0)
    start = (mesh.coords + np.float32([0.5 * vs, 0.0, 0.0])
             + rng.normal(0, 0.1 * vs, mesh.coords.shape)).astype(np.float32)
    print(f"torus: {faces:,} faces, {len(mesh.coords):,} vertices, n={n}, voxel "
          f"{vs:.6g}; made in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev)
    target = voxelize(mesh, spec, "cuda", device=dev, plan=pipe).to_dense().float()
    torch.cuda.synchronize()
    occupied = int(target.sum())
    require(0 < occupied < n ** 3, f"target occupancy {occupied}")
    print(f"target: {occupied:,} voxels through the serving path in "
          f"{time.perf_counter() - t0:.1f} s; {pipe.num_wide} wide candidates")
    return mesh, spec, start, target, pipe


def washer_meshes(faces: int = MAIN_FACES):
    """Phase 4's two washers: radii 0.85 and 1.0, height 0.16, 64
    segments, brought to `faces` faces; the second shifted by (0.9, 0,
    0.05)."""
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh

    c, f = procedural.washer(0.85, 1.0, 0.16, nu=64)
    c, f = procedural.subdivide_to(c, f, faces)
    require(len(f) == faces, "face count")
    shifted = (c + [0.9, 0.0, 0.05]).astype(c.dtype)
    return [Mesh(name="washer_a", coords=c, faces=f, faces_normals=f),
            Mesh(name="washer_b", coords=shifted, faces=f, faces_normals=f)]


def training_path(dev, errs, timings, bounds, n: int = MAIN_N, faces: int = MAIN_FACES):
    """Phase 6: VoxelFit(engine="fused") at n on a rotated torus of
    `faces` faces for TRAIN_STEPS Adam steps (one plan refresh), then
    VoxelFit(engine="seg") and VoxelFit(engine="cuda") (CUDA_STEPS
    steps) from the same start on the same plan. Returns the launch
    counts of the runs (B1 and B2 for the target, B7 and B8 for the
    fused fit, B9-B11 for the seg fit, B13 for the cuda one) and the
    fit's case for phase 6b (mesh, start, spec, packed target, each
    engine's first loss)."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import pack_bits
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.models.fit import VoxelFit
    from voxtpu_torch.ops import soft_vox_cuda, soft_vox_fused, vox_cuda, vox_slots_banded
    from voxtpu_torch.ops.soft_vox import make_soft_plan
    from voxtpu_torch.ops.soft_vox_fused import tables_of

    B1, B2 = vox_slots_banded.banded_fill, vox_cuda.wide_fill
    B7, B8 = soft_vox_fused.fused_fwd, soft_vox_fused.fused_bwd
    B13F, B13B = soft_vox_cuda.fragment_fwd, soft_vox_cuda.fragment_bwd
    C2 = (soft_vox_fused.pair_cut_counts, soft_vox_fused.pair_cut)
    every = (B1, B2, B7, B8, B13F, B13B, *C2)

    for fn in every:
        fn.launches = 0
    mesh, spec, start, target, pipe = torus_case(dev, n, faces)
    vs = spec.voxel_size

    t0 = time.perf_counter()
    plan = make_soft_plan(Mesh(name="start", coords=start, faces=mesh.faces,
                               faces_normals=mesh.faces), spec, pad_window=2)
    t1 = time.perf_counter()
    fit = VoxelFit(plan, target, learning_rate=TRAIN_LR_VOX * vs, engine="fused",
                   refresh_every=4, drift_limit_frac=0.25)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    fp = fit.engine_plan
    print(f"plan: make_soft_plan {t1 - t0:.1f} s ({plan.num_fragments:,} candidate "
          f"fragments), FusedSoftPlan on the card {t2 - t1:.3f} s ({fp.num_fragments:,} slots in "
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
                "B8": B8.launches, "C2": C2[0].launches + C2[1].launches}
    print(f"fused launches {launches}")
    for key in ("B1", "B7", "B8", "C2") + (("B2",) if pipe.num_wide else ()):
        require(launches[key] > 0, f"the training path never launched {key}")
    require(launches["B7"] == TRAIN_STEPS + 1 and launches["B8"] == TRAIN_STEPS,
            "B7 / B8: one launch each per step, and B7 once for the final loss")
    # Each plan, the fit's first and each refresh's, launches both passes of C2.
    require(C2[0].launches == C2[1].launches == 1 + fit.refresh_count == 2,
            f"C2: {C2[0].launches} + {C2[1].launches} launches for "
            f"{1 + fit.refresh_count} plans, not 2 a plan")

    # Step 4's refresh made the densest plan of the path: the four
    # kernels are held on it too, at the last coordinates.
    with uncounted(*every):
        with torch.no_grad():
            tables = tables_of(state.coords, fit.engine_plan)
        hold_fused(fit.engine_plan, tables, lambda occ: loss_cotangent(occ, target),
                   errs, f"{n}^3 refreshed")
        del tables
        check_pair_cut(errs, timings, bounds, fit.plan, dev)
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
    seg_launches, seg_walls, seg_loss0 = seg_fit(dev, errs, timings, bounds, plan, start,
                                                 target, losses[0])
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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cstate, m = cfit.step(cstate)
        torch.cuda.synchronize()
        closs.append(float(m["loss"]))
        require(np.isfinite(closs[-1]), f"cuda engine step {i + 1}: non-finite loss")
        print(f"cuda engine step {i + 1}: loss {closs[-1]:.6f}, wall "
              f"{time.perf_counter() - t0:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches B13 fwd "
              f"{B13F.launches} bwd {B13B.launches}")
    require(abs(closs[0] - losses[0]) <= 1e-4 * losses[0],
            f"the cuda engine's first loss {closs[0]:.6f} differs from the fused "
            f"engine's {losses[0]:.6f}")
    launches.update({"B13f": B13F.launches, "B13b": B13B.launches})
    for key in ("B13f", "B13b"):
        require(launches[key] == CUDA_STEPS, f"{key}: {launches[key]} launches")
    case = {"coords": mesh.coords, "faces": mesh.faces, "start": start,
            "spec": (spec.n, spec.origin, spec.voxel_size),
            "target": pack_bits(target.bool()).cpu().numpy(),
            "first": {"fused": losses[0], "seg": seg_loss0, "cuda": closs[0]}}
    return launches, case


# ---------------------------------------------------------------------------
# Phase 6b: the sharded paths (voxtpu_torch.parallel), worlds of ranks
# ---------------------------------------------------------------------------


def world_log(rank: int, world: int, msg: str) -> None:
    print(f"[world {world} rank {rank}] {msg}", flush=True)


def barrier(world: int) -> None:
    """Every rank's queued work done, then every rank here."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize()
    if world > 1:
        dist.barrier()


def world_layout(world: int) -> dict:
    """The (d, z) mesh shapes a world runs each part on: vox on (1, W),
    (W, 1) and, from 4 ranks, (2, W / 2); the JFA and the MAIN_N fits on
    (1, W) and, from 4 ranks, (2, W / 2)."""
    if world == 1:
        return {"vox": ((1, 1),), "jfa": ((1, 1),), "fit": ((1, 1),)}
    both = ((2, world // 2),) if world >= 4 else ()
    return {"vox": ((1, world), (world, 1)) + both, "jfa": ((1, world),) + both,
            "fit": ((1, world),) + both}


def fit_key(name: str, shape, world: int) -> str:
    """A MAIN_N fit's key: the engine's name on (1, W), with the shape
    on another mesh."""
    return name if tuple(shape) == (1, world) else f"{name}@{shape[0]}x{shape[1]}"


def sharded_vox_part(world, rank, dev, inputs, out, directory) -> dict:
    """voxelize_sharded on phase 4's two washers at MAIN_N on each of
    `world_layout`'s vox shapes, both exchanges: each rank writes its
    slab; returns this rank's ring slabs of each JFA shape."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.vox import FragmentPlan
    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.distributed import global_mesh
    from voxtpu_torch.parallel.sharded_vox import voxelize_sharded

    spec = GridSpec(*inputs["spec"])
    meshes = [Mesh(name=f"washer_{i}", coords=c, faces=f, faces_normals=f)
              for i, (c, f) in enumerate(inputs["washers"])]
    layout = world_layout(world)
    t0 = time.perf_counter()
    plans = [FragmentPlan(m, spec, dev) for m in meshes]
    torch.cuda.synchronize()
    world_log(rank, world, f"vox: two FragmentPlans in {time.perf_counter() - t0:.1f} s")
    kept = {}
    for shape in layout["vox"]:
        dmesh = global_mesh(("d", "z"), shape)
        for i, m in enumerate(meshes):
            for exchange in ("ring", "gather"):
                C.staged_bytes.count = 0
                torch.cuda.reset_peak_memory_stats()
                barrier(world)
                t0 = time.perf_counter()
                grid = voxelize_sharded(m, spec, dmesh, plan=plans[i], exchange=exchange)
                barrier(world)
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                np.save(os.path.join(directory, f"vox_{i}_{shape[0]}x{shape[1]}_{exchange}"
                                                 f"_r{rank}.npy"), grid.words.cpu().numpy())
                out["vox", i, shape, exchange] = {"wall": wall, "staged": C.staged_bytes(),
                                                  "peak": peak}
                world_log(rank, world, f"voxelize_sharded washer {i} on {shape} {exchange}: "
                          f"{wall:.3f} s, slab {tuple(grid.words.shape)}, staged "
                          f"{C.staged_bytes() / 1e6:.1f} MB, peak {peak:.2f} GiB")
                if shape in layout["jfa"] and exchange == "ring":
                    kept.setdefault(shape, []).append(grid.words)
    return kept


def exchange_s(state, fills, k: int, slab: int, group, z: int, dz: int) -> float:
    """Seconds the send/recv of one flood step at stride k takes alone
    (`sharded_jfa`'s exchanges without the step: k-plane halos both
    ways, or the whole slabs at z -/+ k / slab), between a synchronise
    and a barrier on every rank before and after."""
    import torch.distributed as dist

    from voxtpu_torch.parallel import sharded_jfa as SJ

    barrier(dist.get_world_size())
    t0 = time.perf_counter()
    for s, fill in zip(state, fills):
        if k < slab:
            SJ._halos(s, k, group, z, dz)
        else:
            for shift in (-(k // slab), k // slab):
                SJ._fetch_slab(s, shift, group, z, dz, fill)
    barrier(dist.get_world_size())
    return time.perf_counter() - t0


def sharded_jfa_part(world, rank, dev, inputs, out, directory, slabs) -> None:
    """jfa_sharded on the union of the two washers' ring slabs of each
    JFA shape, packed and wide: each rank writes its field's slab; on
    (1, W) the flood is replayed step by step (bitwise the call) for
    each step's time and the rate its exchange moved at."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec, unpack_bits
    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel import sharded_jfa as SJ
    from voxtpu_torch.parallel.distributed import global_mesh

    spec = GridSpec(*inputs["spec"])
    for shape in world_layout(world)["jfa"]:
        dz = shape[1]
        n, slab = spec.n, spec.n // dz
        dmesh = global_mesh(("d", "z"), shape)
        occ = unpack_bits(slabs[shape][0] | slabs[shape][1])
        group, z = dmesh.get_group("z"), dmesh.get_local_rank("z")
        for encoding in ("packed", "wide"):
            C.staged_bytes.count = 0
            torch.cuda.reset_peak_memory_stats()
            barrier(world)
            t0 = time.perf_counter()
            sdf = SJ.jfa_sharded(occ, spec, dmesh, encoding=encoding)
            barrier(world)
            wall = time.perf_counter() - t0
            staged = C.staged_bytes()
            peak = torch.cuda.max_memory_allocated() / 2**30
            np.save(os.path.join(directory, f"jfa_{encoding}_{shape[0]}x{shape[1]}_r{rank}.npy"),
                    sdf.cpu().numpy())
            res = {"wall": wall, "staged": staged, "peak": peak}
            out["jfa", shape, encoding] = res
            line = (f"jfa_sharded {encoding} at {n}^3 on {shape}: {wall:.3f} s wall, staged "
                    f"{staged / 1e6:.1f} MB, peak {peak:.2f} GiB")
            if shape == (1, world):
                flood = SJ.SlabFlood(spec, dmesh, "z", encoding, dev, SJ.WIDE_BUDGET)
                steps = []
                barrier(world)
                t0 = time.perf_counter()
                state = flood.init(occ)
                barrier(world)
                res["init"] = time.perf_counter() - t0
                for k in flood.strides():
                    sent = SJ.comm_bytes_per_step(n, dz, encoding, k) if dz > 1 else 0
                    moved = (exchange_s(state, flood.fills, k, slab, group, z, dz)
                             if sent else 0.0)
                    barrier(world)
                    t0 = time.perf_counter()
                    state = flood.step(state, k)
                    barrier(world)
                    steps.append((k, time.perf_counter() - t0, sent, moved))
                replay = flood.output(state, occ)
                require(bitwise_equal(replay, sdf), f"jfa_sharded {encoding}: the replayed "
                        "flood differs from the call")
                res["steps"] = steps
                line += f"; init {res['init']:.3f} s; steps " + ", ".join(
                    f"k={k} {t:.3f} s" + (f" (sends {b / 1e9:.3f} GB: the exchange alone "
                                          f"{x * 1e3:.2f} ms, {b / x / 1e9:.1f} GB/s)"
                                          if b else "") for k, t, b, x in steps)
                del replay, state
            world_log(rank, world, line)
            del sdf


def sharded_engine(name, soft_plan, start, dmesh, lr, *, n_small=False):
    """(init_fn, step_fn, loss_fn) of a sharded engine at phase 6's
    temperatures."""
    from voxtpu_torch.parallel.sharded_fit import make_sharded_fit
    from voxtpu_torch.parallel.sharded_soft_fused import make_sharded_fit_fused
    from voxtpu_torch.parallel.sharded_soft_pallas import make_sharded_fit_pallas
    from voxtpu_torch.parallel.sharded_soft_seg import make_sharded_fit_seg

    kw = dict(learning_rate=lr, tau_edge_frac=TAU[0], tau_x_frac=TAU[1])
    if name == "seg":
        return make_sharded_fit_seg(soft_plan, start, dmesh, **kw)[:3]
    make = {"plain": make_sharded_fit, "cuda": make_sharded_fit_pallas,
            "fused": make_sharded_fit_fused}[name]
    return make(soft_plan, dmesh, **kw)


def single_device(name, plan, coords, target):
    """(loss, coordinate gradient) through the single-device engine on
    the same engine plan (a world of 1's plan is the whole plan)."""
    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox import soft_voxelize
    from voxtpu_torch.ops.soft_vox_cuda import soft_voxelize_cuda
    from voxtpu_torch.ops.soft_vox_fused import soft_voxelize_fused
    from voxtpu_torch.ops.soft_vox_seg import soft_voxelize_seg

    fwd = {"plain": soft_voxelize, "cuda": soft_voxelize_cuda, "fused": soft_voxelize_fused,
           "seg": soft_voxelize_seg}[name]
    x = coords.detach().clone().requires_grad_(True)
    loss = soft_iou_loss(fwd(x, plan, tau_edge_frac=TAU[0], tau_x_frac=TAU[1]), target)
    loss.backward()
    return float(loss), x.grad


SHARDED_COUNTED = {"cuda": ("B13f", "B13b"), "fused": ("B7", "B8"),
                   "seg": ("B9", "B10", "B11"), "plain": ()}


def kernel_wrappers():
    from voxtpu_torch.ops import soft_vox_cuda, soft_vox_fused, soft_vox_seg

    return {"B13f": soft_vox_cuda.fragment_fwd, "B13b": soft_vox_cuda.fragment_bwd,
            "B7": soft_vox_fused.fused_fwd, "B8": soft_vox_fused.fused_bwd,
            "B9": soft_vox_seg.seg_fwd, "B10": soft_vox_seg.seg_combine,
            "B11": soft_vox_seg.seg_bwd}


def hold_rank_plan(name, plan, coords, g, errs, what):
    """The engine's kernels against their plain versions on this rank's
    plan (phase 5's limits); the calls and bounds of B13's."""
    import torch

    from voxtpu_torch.ops.soft_vox_fused import tables_of

    if name == "cuda":
        return hold_fragment(plan, coords, g, errs, what)
    with torch.no_grad():
        tables = tables_of(coords, plan)
    if name == "fused":
        return hold_fused(plan, tables, g, errs, what)
    return hold_seg(plan, tables, g, errs, what)


def sharded_fit_run(world, rank, dev, name, soft_plan, start, target, shape, lr, steps,
                    out, key, g=None):
    """One sharded engine on `shape`: its plan, the kernels held on the
    rank's plan (`g` a cotangent; not counted), then with the counts at
    0: the loss and gradient at `start`, `steps` Adam steps and the final
    loss; the counts read after. World 1 also takes the single-device
    engine on the same plan. Returns the gradient at `start`."""
    import numpy as np
    import torch

    from voxtpu_torch.parallel import collectives as C
    from voxtpu_torch.parallel.distributed import global_mesh
    from voxtpu_torch.parallel.mesh_utils import local_slab
    from voxtpu_torch.parallel.sharded_fit import value_and_grad

    wrappers = kernel_wrappers()
    dmesh = global_mesh(("d", "z"), shape)
    target_slab = local_slab(target, dmesh).contiguous()
    barrier(world)
    t0 = time.perf_counter()
    init_fn, step_fn, loss_fn = sharded_engine(name, soft_plan, start, dmesh, lr)
    barrier(world)
    res = {"plan_s": time.perf_counter() - t0}
    plan = step_fn.plan
    coords, opt_state = init_fn(start)
    counted = [wrappers[k] for k in SHARDED_COUNTED[name]]
    if g is not None:
        with uncounted(*wrappers.values()):
            calls, bounds = hold_rank_plan(name, plan, coords, g, res.setdefault("errs", {}),
                                           f"{key} rank {rank}")
            if name == "cuda" and world > 1:
                # rank 0 times B13 on its plan while the others wait
                barrier(world)
                if rank == 0:
                    res["timings"] = {"B13f": (cuda_ms(calls[0], reps=3),
                                               cuda_ms(calls[1], reps=3)),
                                      "B13b": (cuda_ms(calls[2], reps=3),
                                               cuda_ms(calls[3], reps=3))}
                    res["bounds"] = bounds
                barrier(world)
            del calls
    if world == 1:
        with uncounted(*wrappers.values()):
            loss1, grad1 = single_device(name, plan, coords, target)
            res["single"] = (loss1, grad1.cpu().numpy())
    for fn in counted:
        fn.launches = 0
    C.staged_bytes.count = 0
    torch.cuda.reset_peak_memory_stats()
    barrier(world)
    t0 = time.perf_counter()
    loss, grad = value_and_grad(loss_fn, coords, target_slab, dmesh)
    barrier(world)
    res.update(loss=float(loss), grad_s=time.perf_counter() - t0, walls=[], losses=[])
    for _ in range(steps):
        t0 = time.perf_counter()
        coords, opt_state, step_loss = step_fn(coords, opt_state, target_slab)
        barrier(world)
        res["walls"].append(time.perf_counter() - t0)
        res["losses"].append(float(step_loss))
    with torch.no_grad():
        res["final"] = float(loss_fn(coords, target_slab))
    barrier(world)
    res.update(peak=torch.cuda.max_memory_allocated() / 2**30, staged=C.staged_bytes(),
               launches={k: fn.launches for k, fn in zip(SHARDED_COUNTED[name], counted)},
               coords=coords.cpu().numpy())
    world_log(rank, world, f"{key}: plan {res['plan_s']:.1f} s; loss {res['loss']:.6f}, "
              f"gradient {res['grad_s']:.3f} s; steps " + ", ".join(
                  f"{lo:.6f} in {w:.3f} s" for lo, w in zip(res["losses"], res["walls"]))
              + f"; final {res['final']:.6f}; peak {res['peak']:.2f} GiB; staged "
              f"{res['staged'] / 1e9:.3f} GB; launches {res['launches']}")
    out[key] = res
    return grad.cpu().numpy()


def sharded_fit_part(world, rank, dev, inputs, out, directory) -> None:
    """The three kernel engines at MAIN_N on phase 6's torus, target and
    start on each of `world_layout`'s fit shapes (``inputs["steps1"]``
    steps in a world of 1, 1 by default; SHARDED_STEPS in a larger one);
    the plain engine one step at KERNEL_N on phase 5's icosphere on
    (1, W); the cuda engine's gradient at KERNEL_N on (W, 1). Each
    gradient is written for the parent."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec, unpack_bits
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.soft_vox import make_soft_plan
    from voxtpu_torch.ops.vox import voxelize

    fc = inputs["fit"]
    spec = GridSpec(*fc["spec"])
    start = torch.from_numpy(fc["start"]).to(dev)
    t0 = time.perf_counter()
    soft_plan = make_soft_plan(Mesh(name="start", coords=fc["start"], faces=fc["faces"],
                                    faces_normals=fc["faces"]), spec, pad_window=2)
    world_log(rank, world, f"fit: make_soft_plan {time.perf_counter() - t0:.1f} s")
    target = unpack_bits(torch.from_numpy(fc["target"]).to(dev)).float()
    g = None  # a world of 1 holds no kernel: phase 6 held them on this plan
    if world > 1:
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (spec.n,) * 3).astype(np.float32)).to(dev)
    steps = inputs.get("steps1", 1) if world == 1 else SHARDED_STEPS
    lr = TRAIN_LR_VOX * spec.voxel_size
    for shape in world_layout(world)["fit"]:
        for name in ("cuda", "fused", "seg"):
            key = fit_key(name, shape, world)
            # The kernels are held on every rank's plan of the first mesh.
            held = g if shape == (1, world) else None
            grad = sharded_fit_run(world, rank, dev, name, soft_plan, start, target, shape,
                                   lr, steps, out, key, g=held)
            if rank == 0:
                np.save(os.path.join(directory, f"grad_{key}.npy"), grad)
            torch.cuda.empty_cache()
    del target, g
    mesh, sp = soft_case(KERNEL_N)
    small = torch.from_numpy(mesh.coords).to(dev)
    target = voxelize(mesh, sp.spec, "cuda", device=dev).to_dense().float()
    lr = TRAIN_LR_VOX * sp.spec.voxel_size
    for name, shape in (("plain", (1, world)), ("cuda", (world, 1))):
        key = f"{name}{KERNEL_N}"
        grad = sharded_fit_run(world, rank, dev, name, sp, small, target, shape, lr,
                               1 if name == "plain" else 0, out, key)
        if rank == 0:
            np.save(os.path.join(directory, f"grad_{key}.npy"), grad)


def world_card(world: int, backend: str) -> int | None:
    """A rank's card: None (the rank's own, `init_distributed`'s choice)
    for an NCCL world on a host with a card a rank; 0 for a gloo world,
    whose ranks share the first card."""
    import torch

    if backend == "nccl" and torch.cuda.device_count() >= world:
        return None
    return 0


def sharded_rank(world: int, rank: int, backend: str, directory: str) -> int:
    """A rank of phase 6b's world: vox, JFA and the fits; writes what
    the parent checks to `directory` (results in rank{rank}.pkl)."""
    import pickle

    import torch

    from voxtpu_torch.parallel.distributed import init_distributed, shutdown_distributed

    card = world_card(world, backend)
    init_distributed(f"file://{directory}/rendezvous", world, rank,
                     None if card is None else [card], backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    world_log(rank, world, f"{backend} rank on {dev} ({torch.cuda.get_device_name(dev)})")
    try:
        with open(os.path.join(directory, "..", "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = {"device": str(dev)}
        slabs = sharded_vox_part(world, rank, dev, inputs, out, directory)
        sharded_jfa_part(world, rank, dev, inputs, out, directory, slabs)
        del slabs
        torch.cuda.empty_cache()
        sharded_fit_part(world, rank, dev, inputs, out, directory)
        with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


def run_world(world: int, backend: str, directory: str, timeout: float, argv=None) -> list:
    """Start `world` ranks of this script (`--sharded-rank`; or the
    command `argv(rank)`), wait for them within `timeout` seconds, print
    their logs; any rank's failure or the timeout fails the phase.
    Returns each rank's results (``rank{r}.pkl`` in `directory`)."""
    import pickle

    if argv is None:
        def argv(r):
            return [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(world),
                    str(r), backend, directory]
    os.makedirs(directory)
    logs = [open(os.path.join(directory, f"log{r}.txt"), "w") for r in range(world)]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "4"}
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(argv(r), cwd=ROOT, env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r in range(world):
        with open(os.path.join(directory, f"log{r}.txt")) as f:
            print(f.read().rstrip())
    codes = [p.returncode for p in procs]
    require(all(c == 0 for c in codes), f"world of {world} ({backend}): exit codes {codes} "
            f"(timeout {timeout} s)")
    print(f"world of {world} ({backend}): {time.perf_counter() - t0:.1f} s")
    out = []
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def sharded_references(dev, washers) -> tuple:
    """(spec, want) for the sharded checks at MAIN_N on `washers`: each
    washer's banded grid, and the CLI's SDF route (B3 + B5) and
    `jfa_wide` on their union, as NumPy arrays."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
    from voxtpu_torch.ops import jfa_cuda, vox_cuda, vox_slots_banded
    from voxtpu_torch.ops.jfa import jfa, jfa_wide
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    t0 = time.perf_counter()
    spec = GridSpec.fit(np.concatenate([m.coords for m in washers]), MAIN_N)
    with uncounted(vox_slots_banded.banded_fill, vox_cuda.wide_fill, jfa_cuda.flood_step,
                   jfa_cuda.sdf_from_seed):
        grids = [BandedSlotVoxPipeline(m, spec, dev)().words for m in washers]
        occ = VoxelGrid(grids[0] | grids[1], spec.origin_tensor(dev),
                        spec.voxel_size_tensor(dev)).to_dense()
        want = {"vox": [g.cpu().numpy() for g in grids],
                "packed": jfa(occ, spec, backend="cuda").cpu().numpy(),
                "wide": jfa_wide(occ, spec).cpu().numpy()}
    del grids, occ
    torch.cuda.empty_cache()
    print(f"references (banded grids, the CLI's SDF route, jfa_wide) in "
          f"{time.perf_counter() - t0:.1f} s")
    return spec, want


def run_worlds(worlds, washers, spec, want, fit_case, tmp, steps1: int = 1) -> dict:
    """Each (world, backend, timeout) of `worlds` in turn, world 1 first
    (its gradients are every later world's reference, and where
    `fit_case` has no "first" losses, its single-device losses become
    them); each world checked by `check_world`. Returns each world's
    rank results."""
    import pickle

    inputs = {"washers": [(m.coords, m.faces) for m in washers],
              "spec": (spec.n, spec.origin, spec.voxel_size), "fit": fit_case,
              "steps1": steps1}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    results = {}
    for world, backend, timeout in worlds:
        wdir = os.path.join(tmp, f"world{world}")
        results[world] = run_world(world, backend, wdir, timeout)
        check_world(world, backend, wdir, results[world], want, fit_case,
                    os.path.join(tmp, "world1"))
        if world == 1 and "first" not in fit_case:
            fit_case["first"] = {k: results[1][0][k]["single"][0]
                                 for k in ("cuda", "fused", "seg")}
    return results


def dryrun_on_card(n_ranks: int, timeout: float = 600) -> str:
    """`python -m voxtpu_torch.parallel.dryrun N` (voxtpu's
    dryrun_multichip: one rank a card on NCCL); returns its line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "voxtpu_torch.parallel.dryrun", str(n_ranks)],
                          capture_output=True, text=True, cwd=ROOT, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": ROOT})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip(")]
    require(proc.returncode == 0 and len(lines) == 1,
            f"dryrun {n_ranks} exited {proc.returncode}:\n{proc.stdout[-2000:]}"
            f"{proc.stderr[-4000:]}")
    print(f"{lines[0]}  ({time.perf_counter() - t0:.1f} s, NCCL, {n_ranks} rank(s))")
    return lines[0]


def sharded_paths(dev, errs, timings, bounds, card, washers, fit_case):
    """Phase 6b: voxtpu_torch.parallel in a world of 1 on NCCL and a
    world of 2 on gloo, both ranks on this card (NCCL refuses two ranks
    on one device), each rank a process of this script; then voxtpu's
    dryrun_multichip in a world of 1 on NCCL. The kernels were built in
    phase 2. Checks (`check_world`): every assembled vox grid xor 0
    against the banded pipeline's; the JFA slabs bitwise the CLI's SDF
    (packed, B3 + B5) and `jfa_wide`; world 1's fits equal the
    single-device engines (loss 1e-6 relative, gradient 1e-3 x max|g|);
    world 2's first loss phase 6's within 1e-5 relative, its gradients
    world 1's within 1e-3 x max|g|, the loss falling over its steps, the
    coordinates bitwise equal on both ranks; the kernels launched on
    each rank and held on its plan. Returns the sharded launch counts
    (summed over world 2's ranks), each kernel's largest error on the
    ranks' plans, and B13's times and bounds on rank 0's plan."""
    t_phase = time.perf_counter()
    spec, want = sharded_references(dev, washers)
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_sharded_") as tmp:
        results = run_worlds(((1, "nccl", 420), (2, "gloo", 600)), washers, spec, want,
                             fit_case, tmp)
    w2 = results[2]
    sharded_errs = {}  # each kernel's largest error on world 2's rank plans
    for r in w2:
        for key in ("cuda", "fused", "seg"):
            for k, v in r[key]["errs"].items():
                if isinstance(k, tuple):  # (kernel, "/tol"): its share of the limit
                    errs[k] = max(errs.get(k, 0.0), v)
                else:
                    sharded_errs[k] = max(sharded_errs.get(k, 0.0), v)
    launches = {k: sum(r[e]["launches"][k] for r in w2)
                for e in ("cuda", "fused", "seg") for k in SHARDED_COUNTED[e]}
    for k, count in launches.items():
        require(count > 0, f"world 2 never launched {k}")
    print(f"world 2 launches (both ranks, the 3 steps and their loss and gradient): "
          f"{launches}")
    dryrun_on_card(1)
    print("unchecked on one card: NCCL with more than one rank and more than one card "
          "(tools/check_sharded_cards.py on four), more than one host; world 2's times "
          "measure staging through the host, not scaling")
    print(f"phase 6b: {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches, sharded_errs, w2[0]["cuda"]["timings"], w2[0]["cuda"]["bounds"]


def check_world(world, backend, wdir, res, want, fit_case, w1dir) -> None:
    """Phase 6b's checks of one world's results (see `sharded_paths`);
    under NCCL also: each rank on its own card, nothing staged through
    the host on any rank, and every counted kernel launched on every
    rank."""
    import numpy as np

    def assembled(fmt, shape):
        dd, dz = shape
        rows = [np.concatenate([np.load(os.path.join(wdir, fmt.format(r=d * dz + z)))
                                for z in range(dz)]) for d in range(dd)]
        for row in rows[1:]:
            require(np.array_equal(row.view(np.int32), rows[0].view(np.int32)),
                    f"world {world}: the d rows of {fmt} differ")
        return rows[0]

    layout = world_layout(world)
    nccl = backend == "nccl" and world > 1
    if nccl:
        cards = [r["device"] for r in res]
        require(len(set(cards)) == world, f"world {world}: ranks share cards {cards}")
        print(f"world {world}: ranks on {', '.join(cards)}")
    for shape in layout["vox"]:
        for i in range(2):
            for exchange in ("ring", "gather"):
                got = assembled(f"vox_{i}_{shape[0]}x{shape[1]}_{exchange}_r{{r}}.npy", shape)
                xor = int(np.unpackbits((got ^ want["vox"][i]).view(np.uint8)).sum())
                require(xor == 0, f"world {world}: washer {i} on {shape} {exchange}: xor "
                        f"popcount {xor}")
    print(f"world {world}: every voxelize_sharded grid (2 washers x {len(layout['vox'])} "
          f"shapes {layout['vox']} x 2 exchanges) xor popcount 0 against the banded pipeline")
    for shape in layout["jfa"]:
        for encoding in ("packed", "wide"):
            got = assembled(f"jfa_{encoding}_{shape[0]}x{shape[1]}_r{{r}}.npy", shape)
            require(np.array_equal(got.view(np.int32), want[encoding].view(np.int32)),
                    f"world {world}: jfa_sharded {encoding} on {shape} differs from the "
                    "single-device field")
    print(f"world {world}: jfa_sharded on {layout['jfa']} packed bitwise the CLI's SDF route "
          f"(B3 + B5), wide bitwise jfa_wide, at {MAIN_N}^3")
    ranks = range(world)
    fits = [(fit_key(name, shape, world), name) for shape in layout["fit"]
            for name in ("cuda", "fused", "seg")]
    for key, name in fits + [(f"plain{KERNEL_N}", "plain"), (f"cuda{KERNEL_N}", "cuda")]:
        r0 = res[0][key]
        require(all(np.isfinite(r[key]["loss"]) for r in res), f"{key}: non-finite loss")
        require(all(r[key]["loss"] == r0["loss"] for r in res), f"{key}: ranks' losses differ")
        for r in ranks:
            require(np.array_equal(res[r][key]["coords"], r0["coords"]),
                    f"world {world} {key}: rank {r}'s coordinates differ from rank 0's")
        grad = np.load(os.path.join(wdir, f"grad_{key}.npy"))
        if world == 1:
            loss1, grad1 = r0["single"]
            require(abs(r0["loss"] - loss1) <= 1e-6 * abs(loss1),
                    f"world 1 {key}: loss {r0['loss']} against single-device {loss1}")
            err, top = float(np.abs(grad - grad1).max()), float(np.abs(grad1).max())
            require(err <= GRAD_TOL * top, f"world 1 {key}: gradient {err:.3e} > "
                    f"{GRAD_TOL} x {top:.3e}")
            line = (f"world 1 {key}: loss {r0['loss']:.7f} (single device {loss1:.7f}), "
                    f"gradient max_abs_err {err:.3e} (max |g| {top:.3e})")
            if r0["losses"]:
                line += "; step walls " + ", ".join(f"{w:.3f}" for w in r0["walls"]) + " s"
            print(line)
            continue
        ref = np.load(os.path.join(w1dir, f"grad_{key.split('@')[0]}.npy"))
        err, top = float(np.abs(grad - ref).max()), float(np.abs(ref).max())
        require(err <= GRAD_TOL * top, f"world {world} {key}: gradient against world 1's "
                f"{err:.3e} > {GRAD_TOL} x {top:.3e}")
        line = (f"world {world} {key}: gradient against world 1's max_abs_err {err:.3e} (max "
                f"|g| {top:.3e}); loss {r0['loss']:.7f}")
        if key.split("@")[0] in fit_case["first"]:
            first = fit_case["first"][name]
            require(abs(r0["loss"] - first) <= 1e-5 * first, f"world {world} {key}: first "
                    f"loss {r0['loss']} against phase 6's {first}")
            line += f", phase 6's {first:.7f}"
            require(r0["final"] < r0["loss"], f"world {world} {key}: the loss did not fall")
        if r0["losses"]:
            line += (f"; after {len(r0['losses'])} steps {r0['final']:.7f}; step walls "
                     + ", ".join(f"{w:.3f}" for w in r0["walls"]) + " s")
        line += "; peak GiB " + ", ".join(f"{r[key]['peak']:.2f}" for r in res)
        line += f"; staged {r0['staged'] / 1e9:.3f} GB a rank"
        if nccl and key in dict(fits):
            for r in ranks:
                require(all(c > 0 for c in res[r][key]["launches"].values()),
                        f"world {world} {key}: rank {r} launches {res[r][key]['launches']}")
            line += "; launches on every rank"
        print(line)
    if nccl:
        staged = [(k, r) for r in ranks for k, v in res[r].items()
                  if isinstance(v, dict) and v.get("staged")]
        require(not staged, f"world {world} staged bytes through the host: {staged}")
        print(f"world {world}: staged_bytes 0 on every rank (vox, JFA, fits)")


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


def check_band_cut(errs, timings, bounds, mesh, spec, dev) -> None:
    """The serving plan's band cut (C1, `csrc/vox_plan.cu`) on the sorted
    slots the plan hands it for `mesh` at spec.n: both passes bitwise
    their plain versions on host copies; each pass timed as a single call
    and a launch in a run, beside the bound (each slot's window end and
    each batch's first window read once a pass, the tile bounds and
    offsets read, the counts and batches written once) and the plain
    versions' host time. None of these launches is the path's own: C1's
    count comes from the CLI's run."""
    from voxtpu_torch.ops import vox_slots_banded as V

    counts_fn, seen = V.band_cut_counts, {}

    def catch(xlo, xhi, tbounds, **kw):
        seen.update(args=(xlo, xhi, tbounds), kw=kw)
        return counts_fn(xlo, xhi, tbounds, **kw)

    catch.launches = 0  # the wrapper counts on the module's name, `catch` here
    with uncounted(counts_fn, V.band_cut):
        V.band_cut_counts = catch
        try:
            pipe = V.BandedSlotVoxPipeline(mesh, spec, dev)
        finally:
            V.band_cut_counts = counts_fn
        (xlo, xhi, tbounds), kw = seen["args"], seen["kw"]
        host = [a.cpu() for a in (xlo, xhi, tbounds)]
        g = V._group_factor(spec.n // 32, pipe.num_tiles)
        counts = counts_fn(xlo, xhi, tbounds, **kw)
        t0 = time.perf_counter()
        want = V.band_cut_counts_plain(*host, **kw)
        plain_s = time.perf_counter() - t0
        errs["C1"] = int_err(counts.cpu(), want)
        require(torch_equal(counts.cpu(), want), "C1's count pass differs from its plain version")
        off, pads, total = V._pack_runs(counts, g, V.PACK)
        total = int(total)
        got = V.band_cut(xlo, xhi, tbounds, off, pads, total=total, **kw)
        t0 = time.perf_counter()
        want = V.band_cut_plain(*host, off.cpu(), pads.cpu(), total=total, **kw)
        plain_s += time.perf_counter() - t0
        for a, b in zip(got, want):
            errs["C1"] = max(errs["C1"], int_err(a.cpu(), b))
            require(torch_equal(a.cpu(), b), "C1's write pass differs from its plain version")
        require(torch_equal(got[0].cpu(), pipe.state.batch_tile.cpu()),
                "C1's batches are not the plan's")

        def both():
            c = counts_fn(xlo, xhi, tbounds, **kw)
            V.band_cut(xlo, xhi, tbounds, off, pads, total=total, **kw)
            return c

        timings["C1"] = (cuda_ms(both), plain_s * 1e3)
        timings["C1", "device"] = device_ms(both, launches=20)
    slots, tiles = int(host[2][-1]), pipe.num_tiles
    real = total - int(pads.sum())
    moved = 2 * (4 * slots + 4 * real + 4 * (tiles + 1)) + 4 * tiles + 8 * tiles + 16 * total
    bounds["C1"] = bound(moved)
    print(f"C1 band cut at {spec.n}^3 on {mesh.name}: {slots} narrow slots on {tiles} tiles, "
          f"{total} batches ({total - real} pads); both passes {timings['C1'][0]:.4f} ms a "
          f"single call, {timings['C1', 'device']:.4f} ms in a run, plain {plain_s * 1e3:.1f} "
          f"ms on the host, bound {bounds['C1'][0]:.4f} ms ({bounds['C1'][1]}); bitwise equal")


def check_pair_cut(errs, timings, bounds, soft_plan, dev) -> None:
    """The fused plan's pair cut (C2, `csrc/soft_plan.cu`) on the pairs
    that the plan of `soft_plan` hands it: both passes bitwise their
    plain versions on host copies, the write pass's runs the plan's batch
    tiles; each pass timed as a single call and a launch in a run, beside
    the bound (each pair's prefix and each run's bounds read once a pass,
    the counts written, the offsets read, the batches written once) and
    the plain versions' host time. None of these launches is the path's
    own: C2's count comes from the fit."""
    import torch

    from voxtpu_torch.ops import soft_vox_fused as F

    counts_fn, seen = F.pair_cut_counts, {}

    def catch(csum, pbounds, **kw):
        seen.update(args=(csum, pbounds), kw=kw)
        return counts_fn(csum, pbounds, **kw)

    catch.launches = 0  # the wrapper counts on the module's name, `catch` here
    with uncounted(counts_fn, F.pair_cut):
        F.pair_cut_counts = catch
        try:
            plan = F.FusedSoftPlan(soft_plan, dev)
        finally:
            F.pair_cut_counts = counts_fn
        (csum, pbounds), kw = seen["args"], seen["kw"]
        host = [a.cpu() for a in (csum, pbounds)]
        counts = counts_fn(csum, pbounds, **kw)
        t0 = time.perf_counter()
        want = F.pair_cut_counts_plain(*host, **kw)
        plain_s = time.perf_counter() - t0
        errs["C2"] = int_err(counts.cpu(), want)
        require(torch_equal(counts.cpu(), want), "C2's count pass differs from its plain version")
        off = (torch.cumsum(counts, 0) - counts).int()
        total = int(counts.sum())
        got = F.pair_cut(csum, pbounds, off, total=total, **kw)
        t0 = time.perf_counter()
        want = F.pair_cut_plain(*host, off.cpu(), total=total, **kw)
        plain_s += time.perf_counter() - t0
        for a, b in zip(got, want):
            errs["C2"] = max(errs["C2"], int_err(a.cpu(), b))
            require(torch_equal(a.cpu(), b), "C2's write pass differs from its plain version")
        require(torch_equal(got[0].cpu(), plan.batch_tile_d.cpu()),
                "C2's batches are not the plan's")

        def both():
            c = counts_fn(csum, pbounds, **kw)
            F.pair_cut(csum, pbounds, off, total=total, **kw)
            return c

        timings["C2"] = (cuda_ms(both), plain_s * 1e3)
        timings["C2", "device"] = device_ms(both, launches=20)
    pairs, runs = int(host[0].shape[0]) - 1, int(host[1].shape[0]) - 1
    moved = 2 * (4 * (pairs + 1) + 4 * (runs + 1)) + 4 * runs + 4 * runs + 12 * total
    bounds["C2"] = bound(moved)
    print(f"C2 pair cut at {soft_plan.spec.n}^3: {pairs} pairs on {runs} tiles, {total} "
          f"batches; both passes {timings['C2'][0]:.4f} ms a single call, "
          f"{timings['C2', 'device']:.4f} ms in a run, plain {plain_s * 1e3:.1f} ms on the "
          f"host, bound {bounds['C2'][0]:.4f} ms ({bounds['C2'][1]}); bitwise equal")


def torch_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and torch.equal(a, b)


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
        words.view(-1, tc, n // 32)[w_uidx.long()] ^= w_words
    return words


def fill_spread(pipe) -> str:
    """The batches per tile that B1 and B2 see on a pipeline's plan, and
    the cluster size each kernel takes."""
    import numpy as np

    st = pipe.state
    parts = []
    for name, tiles, num_tiles, layout in (
            ("B1", st.batch_tile, pipe.num_tiles, st.layout),
            ("B2", None if st.wide is None else st.wide[3],
             0 if st.wide is None else st.wide[4].shape[0], st.wide_layout)):
        if tiles is None:
            continue
        counts = np.bincount(tiles.cpu().numpy(), minlength=num_tiles)
        busy = counts[counts > 0]
        parts.append(f"{name}: {int(counts.sum())} batches on {len(busy)} of {num_tiles} "
                     f"tiles, up to {int(busy.max())} a tile (mean {busy.mean():.1f} on a "
                     f"busy tile), cluster {layout.cluster}")
    return "; ".join(parts)


def fill_calls(pipe, spec, banded, wide):
    """Zero-argument calls of B1 and B2 as one call of the pipeline runs
    them, on the slots (banded, wide), their plain versions, and the
    bytes each must move. "B2" is the pipeline's form, in place into a
    scratch grid (`wide_fill_into`); "B2 compact" the compact buffer
    alone. Each takes its plan's layout. Without wide slots (`wide` None)
    there are B1's alone, and no scratch grid (None)."""
    import torch

    from voxtpu_torch.ops import vox_cuda
    from voxtpu_torch.ops import vox_slots_banded as V

    st, n, tc = pipe.state, spec.n, pipe.tc
    lk, xs = banded
    kw = dict(n=n, tc=tc, band=pipe.band)
    calls = {
        "B1": lambda: V.banded_fill(lk, xs, st.batch_tile, st.batch_basew, **kw,
                                    layout=st.layout),
        "B1 plain": lambda: V.banded_fill_plain(lk, xs, st.batch_tile, st.batch_basew, **kw),
    }
    moved = {"B1": nbytes(lk, xs, st.batch_tile, st.batch_basew) + n ** 3 // 8}
    if wide is None:
        return calls, moved, None
    w_ctile, w_uidx = st.wide[3], st.wide[4]
    k, nw = w_uidx.shape[0], n // 32
    grid = torch.zeros((n, n, nw), dtype=torch.int32, device=lk.device)
    rows = grid.view(-1, tc, nw)

    def plain_merge():
        rows[w_uidx.long()] ^= vox_cuda.wide_fill_plain(*wide, w_ctile, n=n, tc=tc,
                                                        num_tiles=k)

    calls.update({
        "B2": lambda: vox_cuda.wide_fill_into(grid, *wide, w_ctile, w_uidx, n=n, tc=tc,
                                              layout=st.wide_layout),
        "B2 compact": lambda: vox_cuda.wide_fill(*wide, w_ctile, n=n, tc=tc, num_tiles=k,
                                                 layout=st.wide_layout),
        "B2 plain": plain_merge,
    })
    slot_bytes = nbytes(*wide, w_ctile)
    moved.update({"B2": slot_bytes + nbytes(w_uidx) + 2 * k * tc * n // 8,
                  "B2 compact": slot_bytes + k * tc * n // 8})
    return calls, moved, grid


def time_fills(calls, moved, what: str) -> dict:
    """Single-call and run times of B1, B2 (the pipeline's form) and B2's
    compact form (where `calls` has them), each beside its bound; printed
    and returned by name."""
    out = {}
    for name in ("B1", "B2", "B2 compact"):
        if name not in calls:
            continue
        single, run_ms = cuda_ms(calls[name]), device_ms(calls[name])
        b = bound(moved[name])
        out[name] = (single, run_ms, b)
        print(f"{what} {name}: {single:.4f} ms a single call, {run_ms:.4f} ms a launch in "
              f"a run, bound {b[0]:.4f} ms ({b[1]}), {100 * b[0] / run_ms:.0f}% of it by run")
    return out


def time_total(pipe, what: str) -> tuple[float, float, float]:
    """One whole banded_total call: its device time (a call in a run,
    `device_ms`, on geometry tensors made once), a single call between
    two events, and the host wall of `pipe.words()` to a finished grid
    (median of 50 calls, each followed by a synchronize)."""
    import torch

    from voxtpu_torch.ops.vox_slots_banded import banded_total

    spec, dev = pipe.spec, pipe.device
    origin, vs = spec.origin_tensor(dev), spec.voxel_size_tensor(dev)

    def call():
        return banded_total(pipe.state, origin, vs, n=spec.n, tc=pipe.tc, band=pipe.band)

    # Four calls a run (~100 launches each): more would fill the card's
    # launch queue, and the host would wait for the card inside the run.
    run_ms, single = device_ms(call, launches=4), cuda_ms(call)
    walls = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.words()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[len(walls) // 2]
    print(f"{what} banded_total: {run_ms:.4f} ms a call in a run, {single:.4f} ms a single "
          f"call, host wall {wall:.4f} ms to a finished grid")
    return run_ms, single, wall


def host_split(pipe, spec, reps: int = 200) -> dict:
    """The host part of one banded_total call, split (median of `reps`
    timings of each part alone, `time.perf_counter`, the card drained
    before each, so that no timing holds a wait for a full launch
    queue): the grid geometry as device tensors made from host values
    (what `words()` did each call until the pipeline kept them), the
    emit's torch ops, the wrappers' argument checks, the grid's
    allocation, the tensors' data_ptr and the stream, and the two ctypes
    calls (B1, B2 in place) with their launches; then a whole
    `pipe.words()`. Returns ms by part and prints them."""
    import torch

    from voxtpu_torch import _build
    from voxtpu_torch.ops import vox_cuda
    from voxtpu_torch.ops import vox_slots_banded as V

    st, n, tc, band = pipe.state, spec.n, pipe.tc, pipe.band
    nw = n // 32
    dev = pipe.device
    origin, vs = spec.origin_tensor(dev), spec.voxel_size_tensor(dev)
    (lk, xs), wide, _ = V.emit_slots(st, origin, vs, n=n, tc=tc, band=band)
    w_ctile, w_uidx = st.wide[3], st.wide[4]
    words = torch.empty((n, n, nw), dtype=torch.int32, device=dev)

    def checks():
        V._check_slots(lk, xs, st.batch_tile)
        _build.expect(st.batch_basew, "batch_basew", torch.int32, (lk.shape[0],))
        _build.on_cuda(lk, xs, st.batch_tile, st.batch_basew)
        vox_cuda.fill_rows(nw, tc)
        vox_cuda._layout(st.layout, st.batch_tile, pipe.num_tiles, nw=nw, tc=tc)
        vox_cuda._check_slots(*wide, w_ctile)
        _build.expect(words, "words", torch.int32, (n, n, nw))
        _build.expect(w_uidx, "tile_map", torch.int32, (None,))
        _build.on_cuda(words, *wide, w_ctile, w_uidx)
        vox_cuda._layout(st.wide_layout, w_ctile, w_uidx.shape[0], nw=nw, tc=tc)

    lay, wlay = st.layout, st.wide_layout

    def pointers():
        return (lk.data_ptr(), xs.data_ptr(), st.batch_basew.data_ptr(),
                lay.start.data_ptr(), lay.order.data_ptr(), words.data_ptr(),
                _build.stream_of(words), wide[0].data_ptr(), wide[1].data_ptr(),
                wlay.start.data_ptr(), wlay.order.data_ptr(), w_uidx.data_ptr(),
                _build.stream_of(words))

    p = pointers()
    b, tb, k = lk.shape[0], lk.shape[1] * lk.shape[2], w_uidx.shape[0]
    wb, wtb = wide[0].shape[0], wide[0].shape[1] * wide[0].shape[2]

    def ctypes_calls():
        _build.launch("vt_banded_fill", *p[:5], b, tb, tc, nw, band // 32, pipe.num_tiles,
                      lay.nbusy, lay.cluster, p[5], p[6])
        _build.launch("vt_wide_fill", *p[7:12], wb, wtb, tc, nw, k, wlay.nbusy,
                      pipe.num_tiles, wlay.cluster, p[5], p[12])

    parts = {
        "geometry tensors": lambda: (spec.origin_tensor(dev), spec.voxel_size_tensor(dev)),
        "emit": lambda: V.emit_slots(st, origin, vs, n=n, tc=tc, band=band),
        "checks": checks,
        "allocation": lambda: torch.empty((n, n, nw), dtype=torch.int32, device=dev),
        "data_ptr and stream": pointers,
        "ctypes calls": ctypes_calls,
        "whole call": pipe.words,
    }
    out = {}
    for name, fn in parts.items():
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out[name] = sorted(times)[len(times) // 2]
    print("host part of one banded_total call (ms, median of "
          f"{reps}): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


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

    step_ms, b3_ms, plain_ms, ops, moved = [], [], [], [], []
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
            ops.append(flood_ops(si, ki, emit_sdf=ki == 1))
            moved.append(nbytes(si, org, *extra) + 4 * si.numel())
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["B6"] = (mean(step_ms), mean(plain_ms))
    bounds["B6"] = flood_bound(mean(moved), ops)
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
    """Set bits of a ^ b over two int32 word tensors (in chunks: a 4096^3
    grid is 2^31 words)."""
    from voxtpu_torch.grids.voxel_grid import xor_popcount as packed_xor_popcount

    return packed_xor_popcount(a, b)


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
            timings["B14", "device"] = device_ms(lambda: B14(*args, n=n, tc=plan.tc))
            bounds["B14"] = bound(nbytes(*args) + n ** 3 // 8)
            print(f"B14 at {n}^3 on {mesh.name}: {timings['B14'][0]:.4f} ms a single call, "
                  f"{timings['B14', 'device']:.4f} ms a launch in a run")
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
    from voxtpu_torch.ops import vox_cuda, vox_slots_banded
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
            x_plain = xor_popcount(want, plain_words(banded, spec))
            errs["B1"] = max(errs["B1"], x_plain)
            require(x_plain == 0, f"{mesh.name} {n}^3: the banded grid (B1, B2 in place) "
                    f"differs from the plain pipeline (xor popcount {x_plain})")
            if n != MAIN_N and mesh is meshes[0]:
                print(f"batches per tile at {n}^3: " + fill_spread(banded))
                with uncounted(vox_slots_banded.banded_fill, vox_cuda.wide_fill):
                    calls, moved, _ = fill_calls(banded, spec, *pipeline_inputs(banded, spec))
                    fills = time_fills(calls, moved, f"{n}^3 {mesh.name}")
                    timings["B1", n] = fills["B1"]
                    timings["B2", n] = fills["B2"]
                    del calls
                    time_total(banded, f"{n}^3 {mesh.name}")
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
                if mesh is meshes[0]:
                    single = cuda_ms(lambda: B12(*args, n=n, tc=plan.tc))
                    run_ms = device_ms(lambda: B12(*args, n=n, tc=plan.tc))
                    b12_bound = bound(nbytes(*args) + n ** 3 // 8)
                    print(f"B12 at {n}^3 on {mesh.name}: {single:.4f} ms a single call, "
                          f"{run_ms:.4f} ms a launch in a run, bound {b12_bound[0]:.4f} ms "
                          f"({b12_bound[1]})")
                if n == MAIN_N and mesh is meshes[0]:
                    timings["B12"] = (
                        single, cuda_ms(lambda: W.word_event_fill_plain(*args, n=n, tc=plan.tc)))
                    timings["B12", "device"] = run_ms
                    bounds["B12"] = b12_bound
            print(f"{mesh.name} {n}^3: {plan.num_fragments:,} candidates, "
                  f"{pipe.num_valid:,} fragments, {plan.num_events:,} events in "
                  f"{plan.num_batches:,} batches (b_max {pipe.b_max}, cap_f {pipe.cap_f:,}); "
                  f"build: banded {t1 - t0:.2f} s, WordEventVoxPlan {t2 - t1:.2f} s, "
                  f"DeviceVoxPipeline {t3 - t2:.2f} s; per call: DeviceVoxPipeline.words() "
                  f"{pipe_ms:.3f} ms, banded words() {banded_ms:.3f} ms; xor 0, overflow 0")
            del plan, grid, words
            if n == MAIN_N and mesh is meshes[0]:
                cross_check_routes(mesh, spec, dev, pipe.frag_plan, want)
            wq_launches += wq_route(errs, timings, bounds, mesh, spec, pipe.frag_plan, want,
                                    timed=n == MAIN_N and mesh is meshes[0])
            if n == JFA_N:
                kept.append(want)
                kept_spec = spec
            del banded, pipe, want
        torch.cuda.empty_cache()
    return launches, wq_launches, kept, kept_spec


def cross_check_routes(mesh, spec, dev, frag_plan, want) -> None:
    """Phase 4b: voxtpu's two cross-check routes on B2 at MAIN_N on one
    washer: `SlotVoxPipeline` (every candidate a slot, whole-axis fill)
    and the suffix route of a `PallasVoxPlan` at seg = n and n/2
    (`voxelize(backend="word_event", plan=...)`), on the same fragments
    as the word-event route. Each must launch B2 once a call and equal
    the banded grid `want` (xor popcount 0); their plan builds and
    per-call times (CUDA events, warm, median of 5) are printed."""
    import torch

    from voxtpu_torch.ops import vox_cuda
    from voxtpu_torch.ops.vox import voxelize
    from voxtpu_torch.ops.vox_slots import SlotVoxPipeline

    B2, n = vox_cuda.wide_fill, spec.n
    routes = []
    t0 = time.perf_counter()
    slots = SlotVoxPipeline(mesh, spec, dev)
    routes.append((f"SlotVoxPipeline ({slots.num_candidates:,} candidates, "
                   f"{slots.num_batches:,} batches)", time.perf_counter() - t0, slots.words))
    for seg in (n, n // 2):
        t0 = time.perf_counter()
        plan = vox_cuda.PallasVoxPlan(mesh, spec, dev, frag_plan=frag_plan, seg=seg)
        torch.cuda.synchronize()
        routes.append((f"PallasVoxPlan seg={seg} ({plan.num_fragments:,} fragments, "
                       f"{plan.num_batches:,} batches)", time.perf_counter() - t0,
                       lambda plan=plan: voxelize(mesh, spec, "word_event", device=dev,
                                                  plan=plan).words))
    before = B2.launches
    for what, build_s, call in routes:
        x = xor_popcount(call(), want)
        require(x == 0, f"{mesh.name} {n}^3: {what} differs from the banded grid "
                f"(xor popcount {x})")
        with uncounted(B2):
            ms = cuda_ms(call)
        print(f"{mesh.name} {n}^3 {what}: built in {build_s:.2f} s, {ms:.3f} ms a call, "
              "xor 0 against the banded grid")
    launched = B2.launches - before
    require(launched == len(routes), f"the cross-check routes launched B2 {launched} "
            f"times, not {len(routes)}")
    print(f"B2 launches on the cross-check routes: {launched}")


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
    b4_ms, b3_ms, plain_ms, ops = [], [], [], []
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
            ops.append(flood_ops(seed, k))
            print(f"k={k}: B4 {b4_ms[-1]:.3f} ms, B3 {b3_ms[-1]:.3f} ms, plain "
                  f"{plain_ms[-1]:.1f} ms, equal")
            seed = nxt
            k //= 2
        chain = B5(seed, occ, org)
        require(bitwise_equal(sdf, chain), f"jfa() at {n}^3 differs from the B3 chain")
        b5_single = cuda_ms(lambda: B5(seed, occ, org))
        b5_run = device_ms(lambda: B5(seed, occ, org), launches=20)
    b5_bytes = nbytes(seed, occ, org) + 4 * n ** 3
    print(f"B5 at {n}^3: {b5_single:.4f} ms a single call, {b5_run:.4f} ms a launch in a "
          f"run, bound {bound(b5_bytes)[0]:.4f} ms (bytes: {b5_bytes / 1e9:.3f} GB); "
          f"{b5_bytes / b5_run / 1e9:.3f} TB/s in a run")
    finite = float(torch.isfinite(sdf).float().mean())
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["B4"] = (mean(b4_ms), mean(plain_ms))
    bounds["B4"] = flood_bound(nbytes(seed, org) + 4 * n ** 3, ops)
    print(f"B4 at {n}^3 per step (mean of k={n // 2}..1): kernel {timings['B4'][0]:.4f} "
          f"ms, B3 {mean(b3_ms):.4f} ms, plain {timings['B4'][1]:.1f} ms, bound "
          f"{bounds['B4'][0]:.4f} ms ({bounds['B4'][1]}); SDF bitwise equal to the B3 "
          f"chain, {int(occ.sum()):,} voxels, finite share {finite}")
    return launches["B4"]


def plane_counts(words) -> "np.ndarray":
    """Set voxels of each z-plane of a packed grid, PLANE_CHUNK planes at
    a time (no whole-grid temporary)."""
    import numpy as np

    from voxtpu_torch.grids.voxel_grid import popcount32

    n = words.shape[0]
    counts = [popcount32(words[z0:z0 + PLANE_CHUNK]).sum(dim=(1, 2)).cpu()
              for z0 in range(0, n, PLANE_CHUNK)]
    return np.concatenate([c.numpy() for c in counts])


def oracle_planes(counts, k: int):
    """`k` z-planes spread evenly over the occupied ones (those with a
    set voxel), ascending."""
    import numpy as np

    occupied = np.nonzero(counts)[0]
    require(occupied.size > 0, "the grid is empty")
    pick = np.unique(np.round(np.linspace(0, occupied.size - 1, k)).astype(np.int64))
    return occupied[pick]


def held_on_planes(words, mesh, spec, planes) -> int:
    """Voxels where the packed grid's planes differ from the plane oracle
    (`voxelize_ref_planes`) on them."""
    import torch

    from voxtpu_torch.grids.voxel_grid import pack_bits
    from voxtpu_torch.ops.reference import voxelize_ref_planes

    want = pack_bits(torch.from_numpy(voxelize_ref_planes(mesh, spec, planes)))
    got = words[torch.as_tensor(planes, device=words.device)].cpu()
    return xor_popcount(got, want)


def large_grid(dev, mesh, spec, *, band: int | None = None, planes: int = ORACLE_PLANES,
               witness=None) -> dict:
    """Phase 4e's checks of one mesh at spec.n (LARGE_N in the smoke;
    also `tools/check_large_grids.py`'s), every grid kept packed:

    - `BandedSlotVoxPipeline.words()` (B1, then B2 in place; at `band`,
      the pipeline's default BAND where None): overflow 0,
      B1 and B2 launched (counted from 0 around the call), a nonzero
      occupied count;
    - `DeviceVoxPipeline.words()` (B12): overflow 0, B12 launched, xor
      popcount 0 against the banded grid and the same `grid_digest`;
    - the banded grid equal to `voxelize_ref_planes` on `planes` z-planes
      spread over the occupied ones (0 skips it), and, where `witness`
      is given (a function of (mesh, spec) giving packed words), against
      its grid: xor popcount 0, or differences on at most MAX_ARBITRATED
      planes, on each of which the banded grid equals the plane oracle;
    - B1, B2 (in place, and into its compact buffer) and B12 timed as a
      single call and a launch in a run (`cuda_ms`, `device_ms`) beside
      their bounds, and the per-call totals of the banded and word-event
      pipelines (`utils/timing.py::time_device_fn`).

    Prints the plan builds, candidates, slots, wide candidates and the
    peak device memory; returns the numbers by name."""
    import numpy as np
    import torch

    from voxtpu_torch.grids.voxel_grid import grid_digest, packed_popcount
    from voxtpu_torch.ops import vox_cuda, vox_slots_banded
    from voxtpu_torch.ops import vox_word_event as W
    from voxtpu_torch.ops.vox import fragments_from_plan
    from voxtpu_torch.utils.timing import time_device_fn

    B1, B2, B12 = vox_slots_banded.banded_fill, vox_cuda.wide_fill, W.word_event_fill
    n, out = spec.n, {}
    band = vox_slots_banded.BAND if band is None else band
    what = f"{mesh.name} ({mesh.num_faces:,} faces) at {n}^3, band {min(band, n)}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    banded = vox_slots_banded.BandedSlotVoxPipeline(mesh, spec, dev, band=band)
    torch.cuda.synchronize()
    out["banded_build_s"] = time.perf_counter() - t0
    B1.launches = B2.launches = 0
    words, overflow = banded.words()
    torch.cuda.synchronize()
    out["launches"] = {"B1": B1.launches, "B2": B2.launches}
    require(int(overflow) == 0, f"{what}: banded overflow {int(overflow)}")
    require(B1.launches == 1, f"{what}: the banded pipeline launched B1 {B1.launches} times")
    require(B2.launches == (1 if banded.num_wide else 0),
            f"{what}: the banded pipeline launched B2 {B2.launches} times "
            f"({banded.num_wide:,} wide candidates)")
    live_wide = 0
    if banded.num_wide:
        _, (w_k, _) = pipeline_inputs(banded, spec)
        live_wide = int((w_k >= 0).sum())
        del w_k
    counts = plane_counts(words)
    occupied = int(counts.sum())
    require(occupied == packed_popcount(words) and occupied > 0,
            f"{what}: occupied count {occupied}")
    out.update(occupied=occupied, candidates=banded.num_candidates, slots=banded.num_slots,
               batches=banded.num_batches, num_wide=banded.num_wide, live_wide=live_wide)
    print(f"{what}: banded plan {out['banded_build_s']:.2f} s, {banded.num_candidates:,} "
          f"candidates in {banded.num_slots:,} slots ({banded.num_batches:,} batches), "
          f"{banded.num_wide:,} wide candidates ({live_wide:,} live wide slots); overflow 0, "
          f"launches {out['launches']}; {occupied:,} voxels set", flush=True)

    if planes:
        z = oracle_planes(counts, planes)
        t0 = time.perf_counter()
        x = held_on_planes(words, mesh, spec, z)
        require(x == 0, f"{what}: the banded grid differs from the plane oracle on planes "
                f"{z.tolist()} (xor popcount {x})")
        out["oracle_planes"] = z.tolist()
        print(f"{what}: equal to the plane oracle on {len(z)} z-planes {z.tolist()} "
              f"({int(counts[z].sum()):,} voxels; {time.perf_counter() - t0:.1f} s)",
              flush=True)
    if witness is not None:
        t0 = time.perf_counter()
        other = witness(mesh, spec).to(dev)
        x = xor_popcount(words, other)
        line = f"{what}: xor popcount {x} against the native library's grid"
        if x:
            # voxtpu's native build (g++ -O3 -march=native) contracts
            # multiply-adds into FMAs, so it can move an x entry by a
            # voxel where the oracle does not; the oracle decides.
            z = np.nonzero(plane_counts(words ^ other))[0]
            require(len(z) <= MAX_ARBITRATED, f"{what}: the native grid differs on {len(z)} "
                    f"planes (more than {MAX_ARBITRATED} to hold against the oracle)")
            o = held_on_planes(words, mesh, spec, z)
            require(o == 0, f"{what}: the banded grid differs from the plane oracle on the "
                    f"planes {z.tolist()} where the native grid differs (xor popcount {o})")
            line += (f", all on the planes {z.tolist()}, where the banded grid equals the "
                     "plane oracle (the native build contracts multiply-adds)")
        del other
        print(f"{line} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    pipe = W.DeviceVoxPipeline(mesh, spec, dev)
    torch.cuda.synchronize()
    out["pipe_build_s"] = time.perf_counter() - t0
    B12.launches = 0
    we_words, we_overflow = pipe.words()
    torch.cuda.synchronize()
    out["launches"]["B12"] = B12.launches
    require(int(we_overflow) == 0, f"{what}: DeviceVoxPipeline overflow {int(we_overflow)}")
    require(B12.launches == 1, f"{what}: DeviceVoxPipeline launched B12 {B12.launches} times")
    x = xor_popcount(words, we_words)
    require(x == 0, f"{what}: the banded grid differs from the word-event grid (xor popcount "
            f"{x})")
    digest = grid_digest(words)
    require(digest == grid_digest(we_words), f"{what}: the grids' digests differ")
    del we_words
    print(f"{what}: DeviceVoxPipeline {out['pipe_build_s']:.2f} s ({pipe.num_fragments:,} "
          f"candidates, {pipe.num_valid:,} fragments, {pipe.num_events:,} events, b_max "
          f"{pipe.b_max:,}, cap_f {pipe.cap_f:,}); xor 0 against the banded grid, digest "
          f"{digest} on both", flush=True)

    del words
    with uncounted(B1, B2, B12):
        calls, moved, _ = fill_calls(banded, spec, *pipeline_inputs(banded, spec))
        out.update(time_fills(calls, moved, what))
        del calls
        plan = W.WordEventVoxPlan(mesh, spec, dev, fragments=fragments_from_plan(
            pipe.frag_plan))
        args = we_args(plan)
        b12 = (cuda_ms(lambda: B12(*args, n=n, tc=plan.tc)),
               device_ms(lambda: B12(*args, n=n, tc=plan.tc)),
               bound(nbytes(*args) + n ** 3 // 8))
        out["B12"] = b12
        print(f"{what} B12: {b12[0]:.4f} ms a single call, {b12[1]:.4f} ms a launch in a "
              f"run, bound {b12[2][0]:.4f} ms ({b12[2][1]})", flush=True)
        del plan, args
        torch.cuda.empty_cache()
        out["banded_ms"] = 1e3 * time_device_fn(banded.words, iters=3, repeats=3)
        out["pipe_ms"] = 1e3 * time_device_fn(pipe.words, iters=3, repeats=3)
    print(f"{what}: per call (time_device_fn): banded words() {out['banded_ms']:.3f} ms, "
          f"DeviceVoxPipeline.words() {out['pipe_ms']:.3f} ms", flush=True)
    del banded, pipe
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{what}: peak device memory {out['peak_gib']:.2f} GiB", flush=True)
    torch.cuda.empty_cache()
    return out


def _load_tool(name: str):
    """A script of tools/ loaded by path, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def probe_run(dev, errs, timings, bounds) -> int:
    """Phase 4c: the probe runner `tools/probe_jfa_micro.py` at PROBE_N
    on its ball-shell seeds for PROBE_KS (every variant timed, hoist and
    hoistv asserted bitwise equal to B3 there); then PROBE_ROW held
    against its plain version and timed beside it. Returns P1's
    launches in the runner's run."""
    import torch

    from voxtpu_torch.ops import jfa_probe

    runner = _load_tool("probe_jfa_micro")
    P1 = jfa_probe.flood_probe
    P1.launches = 0
    try:
        times = runner.probe(PROBE_N, PROBE_KS, 5, dev)
    except AssertionError as e:
        raise SmokeFailure(f"P1: {e}") from e
    launches = P1.launches
    require(launches > 0, "the probe never launched P1")

    seed, org = runner.shell_seeds(PROBE_N, dev)
    plain_ms, ops = [], []
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
            ops.append(flood_ops(seed, k))
            del got, want
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    timings["P1"] = (mean([times[k][PROBE_ROW] for k in PROBE_KS]), mean(plain_ms))
    bounds["P1"] = flood_bound(nbytes(seed, org) + 4 * seed.numel(), ops)
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


class _Tee:
    """A stdout that also keeps what it is given."""

    def __init__(self, out):
        self.out, self.kept = out, []

    def write(self, text):
        self.kept.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def traced_cli(dev) -> None:
    """Phase 4d: the CLI with --trace at TRACE_N on two small washers: the
    trace `torch.profiler` writes must hold the CLI's scopes as named
    ranges and the fill kernel's launches (B1 and B2 are
    `csrc/vox_fill.cu::suffix_fill_kernel`)."""
    import glob

    from voxtpu_torch import cli
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.mesh.obj_io import export_mesh

    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_trace_") as tmp:
        paths = []
        for name, center in (("ring_a", (2.0, 2.0, 2.0)), ("ring_b", (2.5, 2.0, 2.0625))):
            c, f = procedural.washer(0.75, 1.0, 0.25, 96, center=center)
            paths.append(os.path.join(tmp, f"{name}.obj"))
            export_mesh(paths[-1], Mesh(name=name, coords=c, faces=f, faces_normals=f))
        log_dir = os.path.join(tmp, "trace")
        rc = cli.main([*paths, "-n", str(TRACE_N), "-t", "2", "-p", "1", "-s",
                       "--device", str(dev), "--trace", log_dir])
        require(rc == 0, f"the traced CLI exited {rc}")
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        require(len(files) == 1, f"--trace wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as fh:
            events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = {e.get("name") for e in events if e.get("cat") == "kernel"}
    scopes = ("CudaVox(ring_a.obj)", "CudaVox(ring_b.obj)", "CudaVox::planning",
              "CudaVox::processing", "CudaCSG", "CudaJFA")
    missing = [sc for sc in scopes if sc not in names]
    require(not missing, f"the trace lacks the CLI scopes {missing}")
    fills = sorted(k for k in kernels if "suffix_fill_kernel" in k)
    require(fills, "the trace holds no fill kernel (suffix_fill_kernel)")
    ours = sorted({k.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]
                   for k in kernels if "at::native" not in k})
    print(f"CLI --trace at {TRACE_N}^3: {size:,} bytes, {len(events):,} events, "
          f"{len(kernels)} kernel names; the CLI's scopes {', '.join(scopes)} and "
          f"{fills[0]} present; the kernels that are not PyTorch's: {', '.join(ours)}")


def native_cli(dev) -> None:
    """Phase 4d: the CLI's -t 3 (voxtpu's native C++/OpenMP backend on
    the host, its results on the card) at TRACE_N on two small washers
    (-p 1 -s): the folded grid xor 0 against -t 0's, the SDF within
    rtol 1e-6 of the oracle's (-t 0; on this dyadic grid fit it is
    bitwise), both on the card; prints -t 3's wall."""
    import torch

    from voxtpu_torch import cli
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.mesh.obj_io import export_mesh

    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_native_") as tmp:
        paths = []
        for name, center in (("ring_a", (2.0, 2.0, 2.0)), ("ring_b", (2.5, 2.0, 2.0625))):
            c, f = procedural.washer(0.75, 1.0, 0.25, 96, center=center)
            paths.append(os.path.join(tmp, f"{name}.obj"))
            export_mesh(paths[-1], Mesh(name=name, coords=c, faces=f, faces_normals=f))
        argv = [*paths, "-n", str(TRACE_N), "-p", "1", "-s", "--device", str(dev)]
        t0 = time.perf_counter()
        nat = cli.run([*argv, "-t", "3"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = cli.run([*argv, "-t", "0"])
        ref_wall = time.perf_counter() - t0
    require(nat.sdf.is_cuda and nat.grids[0].words.is_cuda, "-t 3's results are not on the card")
    x = xor_popcount(nat.grids[0].words, ref.grids[0].words)
    require(x == 0, f"-t 3 grid differs from -t 0 (xor popcount {x})")
    require(nat.grids[0].count() > 0, "-t 3 grid is empty")
    a, b = nat.sdf, ref.sdf
    fin = torch.isfinite(b)
    require(bool((torch.isfinite(a) == fin).all()) and bool((a[~fin] == b[~fin]).all()),
            "-t 3 SDF: its infinities differ from the oracle's")
    far = int(((a[fin] - b[fin]).abs() > 1e-6 * b[fin].abs()).sum())
    require(far == 0, f"-t 3 SDF: {far} voxels beyond rtol 1e-6 of the oracle's")
    print(f"CLI -t 3 --device {dev} at {TRACE_N}^3 (-p 1 -s): wall {wall:.2f} s (-t 0 "
          f"{ref_wall:.2f} s); grid ({nat.grids[0].count():,} voxels) xor 0 against -t 0; "
          f"SDF within rtol 1e-6 of the oracle (bitwise: {bitwise_equal(a, b)})")


def wide_cli(dev, paths) -> None:
    """Phase 4d: the CLI at WIDE_N (-t 2 -p 1 -s) on phase 4's two
    washers. The SDF must come from the wide flood: B1 and B2 launch, B3,
    B4, B5 and B6 never, and the `[CudaJFA::wide]` scope prints; the
    field passes `tools/check_jfa_wide.py::check_wide_field` (signs as
    the folded occupancy, sdf == 0 exactly on the boundary mask, 1024
    seeded samples never below the brute-force nearest seed and above it
    by more than rtol 1e-5 at under 1%). Prints the phase's wall time,
    the JFA scope's time per step and the peak device memory."""
    import re

    import torch

    from voxtpu_torch import cli
    from voxtpu_torch.ops import jfa_cuda as J
    from voxtpu_torch.ops import vox_cuda, vox_slots_banded

    checker = _load_tool("check_jfa_wide")
    kernels = {"B1": vox_slots_banded.banded_fill, "B2": vox_cuda.wide_fill,
               "B3": J.flood_step, "B4": J.flood_step_rows, "B5": J.sdf_from_seed,
               "B6": J.flood_step_pipe}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = cli.run([*paths, "-n", str(WIDE_N), "-t", "2", "-p", "1", "-s"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"CLI -n {WIDE_N} -t 2 -p 1 -s: wall {wall:.1f} s; launches {launches}; peak "
          f"device memory {peak / 2**30:.3f} GiB")
    require(launches["B1"] > 0 and launches["B2"] > 0, "the CLI at "
            f"{WIDE_N}^3 did not launch B1 and B2")
    require(all(launches[k] == 0 for k in ("B3", "B4", "B5", "B6")),
            f"the CLI at {WIDE_N}^3 launched a packed flood kernel: {launches}")
    m = re.search(r"\[CudaJFA::wide\]: ([\d.]+) ms", "".join(tee.kept))
    require(m is not None, "no [CudaJFA::wide] scope: the SDF did not take the wide flood")
    occ = result.grids[0].to_dense()
    t0 = time.perf_counter()
    try:
        checks = checker.check_wide_field(result.sdf, occ, result.spec, samples=1024, seed=0)
    except checker.CheckFailed as e:
        raise SmokeFailure(f"the {WIDE_N}^3 SDF: {e}") from e
    steps = WIDE_N.bit_length() - 1
    print(f"SDF at {WIDE_N}^3 ({int(occ.sum()):,} voxels): {checks} (checked in "
          f"{time.perf_counter() - t0:.1f} s); the wide JFA took {float(m.group(1)):.1f} ms, "
          f"{float(m.group(1)) / steps:.1f} ms a step over its {steps} steps (init and "
          "output pass included)")


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
    B4 = jfa_cuda.flood_step_rows
    B14, P1 = vox_work_queue.wq_fill, jfa_probe.flood_probe
    band_cut_counts, band_cut = vox_slots_banded.band_cut_counts, vox_slots_banded.band_cut  # C1
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
        # In place: into a random grid through a tile map, against the merge.
        grid = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, n, n // 32), generator=g,
                             dtype=torch.int32).to(dev)
        tile_map = torch.randperm(n * n // 128, generator=g)[:tiles].to(torch.int32).to(dev)
        merged = grid.clone()
        merged.view(-1, 128, n // 32)[tile_map.long()] ^= want
        vox_cuda.wide_fill_into(grid, local, rxs, btile, tile_map, n=n, tc=128)
        errs["B2"] = max(errs["B2"], int_err(grid, merged))
        require(torch.equal(grid, merged),
                f"B2 in place differs from the plain fill and merge (n={n})")
    print(f"B2 n=192 band=64: {pipe.num_wide} wide candidates, equal (in place); "
          "live random slots at n=192 and 512 equal, into a buffer and in place")

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
        for band in (32, 100):
            rows = B4(seed, org, k, band)
            errs["B4"] = max(errs["B4"], int_err(rows, got))
            require(torch.equal(rows, got), f"B4 (band {band}) differs from B3 at k={k}")
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
    print("B3, B4 (bands 32, 100), B6 at k=64..1 (B6 with the signed distance at k=1) and "
          "B5 at n=128: equal")

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
    washer_a, washer_b = washer_meshes()
    c, f, shifted = washer_a.coords, washer_a.faces, washer_b.coords
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_smoke_") as tmp:
        paths = [os.path.join(tmp, "washer_a.obj"), os.path.join(tmp, "washer_b.obj")]
        export_mesh(paths[0], mesh_of(c, f, "washer_a"))
        export_mesh(paths[1], mesh_of(shifted, f, "washer_b"))
        print(f"meshes written in {time.perf_counter() - t0:.1f} s")
        out_dir = os.path.join(tmp, "out")
        argv = [*paths, "-n", str(MAIN_N), "-t", "2", "-p", "1", "-s", "-e",
                "-o", "merged.obj", "--out-dir", out_dir]
        for fn in (B1, B2, B3, B5, band_cut_counts, band_cut):
            fn.launches = 0
        t0 = time.perf_counter()
        from voxtpu_torch import cli

        result = cli.run(argv)  # what `python -m voxtpu_torch.cli ...` runs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": B1.launches, "B2": B2.launches, "B3": B3.launches,
                    "B5": B5.launches}
        # The CLI builds one plan a mesh, each launching both passes of C1.
        require(band_cut_counts.launches == band_cut.launches == len(paths),
                f"C1: {band_cut_counts.launches} + {band_cut.launches} launches for "
                f"{len(paths)} plans, not 2 a plan")
        launches["C1"] = band_cut_counts.launches + band_cut.launches
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
            nxt = B3(s, org, k)
            errs["B3"] = max(errs["B3"], int_err(nxt, jfa_cuda.flood_step_plain(s, org, k)))
            require(errs["B3"] == 0, f"B3 differs from its plain version at {MAIN_N}^3, k={k}")
            for band in (jfa_cuda.ROW_BAND, 100):
                errs["B4"] = max(errs["B4"], int_err(B4(s, org, k, band), nxt))
                require(errs["B4"] == 0, f"B4 (band {band}) differs from B3 at {MAIN_N}^3, k={k}")
            s = nxt
            k //= 2
        final_seed = s
        errs["B3"] = max(errs["B3"], int_err(final_seed, seed_plain))
        require(torch.equal(final_seed, seed_plain),
                "B3 chain differs from the plain flood at 512^3")

        def steps(fn):
            return lambda: [fn(si, org, ki) for si, ki in seeds]

        print("batches per tile at 512^3: " + fill_spread(p0))
        calls, moved, _ = fill_calls(p0, spec, (lk, xs), (wk, wxs))
        fills = time_fills(calls, moved, f"{MAIN_N}^3 washer_a (inert wide slots)")
        timings = {
            "B1": (fills["B1"][0], cuda_ms(calls["B1 plain"])),
            "B2": (fills["B2"][0], cuda_ms(calls["B2 plain"])),
            "B3": (cuda_ms(steps(B3), reps=3) / len(seeds),
                   cuda_ms(steps(jfa_cuda.flood_step_plain), reps=3) / len(seeds)),
            "B5": (cuda_ms(lambda: B5(final_seed, occ, org)),
                   cuda_ms(lambda: jfa_cuda.sdf_from_seed_plain(final_seed, occ, org))),
        }
        n3 = MAIN_N ** 3
        bounds = {
            "B1": fills["B1"][2],
            "B2": fills["B2"][2],
            "B3": flood_bound(nbytes(seed0, org) + 4 * n3,
                              [flood_ops(si, ki) for si, ki in seeds]),
            "B5": bound(nbytes(final_seed, occ, org) + 4 * n3,
                        7 * n3 + 14 * int((final_seed >= 0).sum())),
        }
        timings["B1", "device"] = fills["B1"][1]
        timings["B2", "device"] = fills["B2"][1]
        check_band_cut(errs, timings, bounds, washer_a, spec, dev)
        timings["B5", "device"] = device_ms(lambda: B5(final_seed, occ, org), launches=20)
        for name in ("B1", "B2", "B3", "B5"):
            (ms, plain_ms), dev_ms = timings[name], timings.get((name, "device"))
            print(f"{name}: kernel {ms:.4f} ms" + (
                "" if dev_ms is None else f" a single call, {dev_ms:.4f} ms a launch in a run")
                + f", plain {plain_ms:.4f} ms, bound {bounds[name][0]:.4f} ms "
                f"({bounds[name][1]})")
        b5_bytes = nbytes(final_seed, occ, org) + 4 * n3
        print(f"B5 moves {b5_bytes / 1e9:.3f} GB: {b5_bytes / timings['B5'][0] / 1e9:.3f} "
              f"TB/s a single call, {b5_bytes / timings['B5', 'device'] / 1e9:.3f} TB/s in "
              "a run")
        g = torch.Generator().manual_seed(11)
        live_k = torch.randint(0, p0.tc, tuple(wk.shape), generator=g,
                               dtype=torch.int32).to(dev)
        live_xs = torch.randint(0, MAIN_N, tuple(wk.shape), generator=g,
                                dtype=torch.int32).to(dev)
        got = B2(live_k, live_xs, w_ctile, **wkw)
        want = vox_cuda.wide_fill_plain(live_k, live_xs, w_ctile, **wkw)
        errs["B2"] = max(errs["B2"], int_err(got, want))
        require(torch.equal(got, want), "B2 differs from plain on live slots (main shape)")
        live, live_moved, live_grid = fill_calls(p0, spec, (lk, xs), (live_k, live_xs))
        with uncounted(B2):
            live["B2"]()
        merged = torch.zeros_like(live_grid)
        merged.view(-1, p0.tc, MAIN_N // 32)[w_uidx.long()] ^= want
        errs["B2"] = max(errs["B2"], int_err(live_grid, merged))
        require(torch.equal(live_grid, merged),
                "B2 in place differs from the plain merge on live slots (main shape)")
        live_t = time_fills(live, live_moved, f"{MAIN_N}^3 washer_a (live random wide slots)")
        live_plain_ms = cuda_ms(live["B2 plain"])
        print(f"B2 on live random slots of the same shape: in place {live_t['B2'][0]:.4f} ms "
              f"a single call, {live_t['B2'][1]:.4f} ms a launch in a run, plain fill and "
              f"merge {live_plain_ms:.4f} ms, equal (into a buffer and in place)")
        print(f"shapes: B1 {tuple(lk.shape)} slots, B2 {tuple(wk.shape)} slots on "
              f"{w_uidx.shape[0]} tiles, B3 per step (mean of k={MAIN_N // 2}..1; every step "
              f"equal to its plain version and to B4 in bands of {jfa_cuda.ROW_BAND} and 100), "
              f"B5 {MAIN_N}^3")
        time_total(p0, f"{MAIN_N}^3 washer_a")
        host_split(p0, spec)
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

    # ---- 4d. the wide flood above N = 1024, and --trace ---------------------------
    phase(f"4d. the CLI's SDF at {WIDE_N}^3 on the wide flood; --trace at {TRACE_N}^3")
    t_phase = time.perf_counter()
    traced_cli(dev)
    native_cli(dev)
    with tempfile.TemporaryDirectory(prefix="voxtpu_torch_wide_") as tmp:
        paths = [os.path.join(tmp, "washer_a.obj"), os.path.join(tmp, "washer_b.obj")]
        export_mesh(paths[0], mesh_of(c, f, "washer_a"))
        export_mesh(paths[1], mesh_of(shifted, f, "washer_b"))
        wide_cli(dev, paths)
    torch.cuda.empty_cache()
    print(f"phase 4d: {time.perf_counter() - t_phase:.1f} s")

    # ---- 4e. the main path at voxtpu's largest grid ----------------------------------
    phase(f"4e. the banded pipeline at {LARGE_N}^3 on washer_a against the word-event "
          "route and the plane oracle")
    t_phase = time.perf_counter()
    large = large_grid(dev, mesh_of(c, f, "washer_a"), GridSpec.fit(c, LARGE_N))
    require(large["launches"]["B2"] == 1, f"B2 did not launch at {LARGE_N}^3")
    print(f"phase 4e: {time.perf_counter() - t_phase:.1f} s ({card})")

    # ---- 5. training kernels vs plain ------------------------------------------
    phase(f"5. training kernels against their plain versions (n={KERNEL_N})")
    check_training_kernels(dev, errs)
    phase(f"5b. seg kernels against their plain versions (n={SEG_N})")
    check_seg_kernels(dev, errs)

    # ---- 6. training path --------------------------------------------------------
    phase(f"6. training path: VoxelFit at {MAIN_N}^3 on {MAIN_FACES:,} faces")
    train, fit_case = training_path(dev, errs, timings, bounds)
    launches.update({k: train[k]
                     for k in ("B7", "B8", "B9", "B10", "B11", "B13f", "B13b", "C2")})

    # ---- 6b. the sharded paths -----------------------------------------------------
    phase("6b. sharded paths: a world of 1 (NCCL) and of 2 (gloo, both ranks on this card)")
    sharded, sharded_errs, b13_ms, b13_bounds = sharded_paths(
        dev, errs, timings, bounds, card,
        [mesh_of(c, f, "washer_a"), mesh_of(shifted, f, "washer_b")], fit_case)
    for key in ("B13f", "B13b"):
        timings[key, "sharded"] = b13_ms[key]
        bounds[key, "sharded"] = b13_bounds[key]
        launches[key, "sharded"] = sharded[key]
        errs[key, "sharded"] = sharded_errs[key]

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
        ("C1", "C1 band_cut_counts + band_cut", "voxtpu_torch/csrc/vox_plan.cu",
         "none (voxtpu's host cut, voxtpu/ops/vox_slots_banded.py:389-448)"),
        ("C2", "C2 pair_cut_counts + pair_cut", "voxtpu_torch/csrc/soft_plan.cu",
         "none (voxtpu's host cut, voxtpu/ops/soft_vox_fused.py:596-696)"),
        (("B13f", "sharded"), "B13 fragment_fwd (sharded, a rank's plan)", soft,
         "voxtpu/parallel/sharded_soft_pallas.py:91"),
        (("B13b", "sharded"), "B13 fragment_bwd (sharded, a rank's plan)", soft,
         "voxtpu/parallel/sharded_soft_pallas.py:127"),
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
                        "max_abs_err": errs[key], "ms": ms,
                        "device_ms": timings.get((key, "device")), "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
        if key in sharded:  # B7-B11 and B13 also run per rank in phase 6b's world of 2
            kernels[-1].update(sharded_launches=sharded[key],
                               sharded_max_abs_err=sharded_errs[key])
    print("largest max_abs_err / limit of any check: " + ", ".join(
        f"{name} {errs[key, '/tol']:.3f}" for key, name, _, _ in table
        if (key, "/tol") in errs))
    print(card)  # nvidia-smi's own line: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--sharded-rank":  # a rank of phase 6b
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(run())
