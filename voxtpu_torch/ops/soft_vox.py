"""Differentiable soft voxelization — the plain engine.

Port of `voxtpu/ops/soft_vox.py` (voxtpu's ``xla`` engine; here the
``"plain"`` engine of `VoxelFit`). Solid occupancy is a signed winding
sum along +x, relaxed with sigmoids so that it is smooth in every
vertex coordinate:

    occ(x, y, z) = clip( sum_t  sgn(n_x^t) * cov_t(y, z) * H(x_hit^t - x) )

cov_t is the product of the triangle's three edge functions pushed
through sigmoids (temperature ``tau_edge``, length^2), H a sigmoid step
along x (``tau_x``, length); both default to fractions of the voxel
size. A triangle whose x-facing flips (n_x crossing 0) flips the sign
of its whole contribution: meshes with exactly x-parallel faces sit on
that knife edge, so gradient checks use jittered meshes.

The host plan (`make_soft_plan`, `refresh_soft_plan`) is voxtpu's
NumPy bucketing line for line, so the tests compare its arrays with
voxtpu's. Per call, `_soft_fragments` computes each candidate cell's
weight and x-hit in torch ops (autograd flows through them) and
`_Accumulate` sums ``w * sigmoid((x_hit - cx) / tau_x)`` into the grid
with `index_add_`, in chunks of fragments so that no (F, N) profile is
ever whole; its backward is the matching chunked gather. The same two
chunked helpers are the plain versions behind the CUDA engines' kernels
(`ops/soft_vox_cuda.py`, `ops/soft_vox_fused.py`).

All engines clip with `clip01`, whose gradient at 0 and at 1 is 0.5,
as `jnp.clip`'s is (`torch.clamp` gives 1.0 there). Empty cells sit at
exactly 0 and saturated interior cells can sit at exactly 1.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import (FragmentPlan, _edge_zy, _pad_granular,
                                  _pad_rows, _triangle_windows,
                                  _window_classes)
from voxtpu_torch.utils.trace import span

# Elements of one chunk's (fragments, N) temporaries in the plain
# versions: 2^25 float32 values, 128 MiB each.
CHUNK_ELEMS = 1 << 25


def f32(x: float) -> float:
    """`x` rounded to float32, as a Python float (exact in either)."""
    return float(np.float32(x))


def temperatures(spec: GridSpec, tau_edge_frac: float, tau_x_frac: float):
    """(voxel size, tau_edge, tau_x) as float32 values, rounded where
    voxtpu rounds them (`jnp.asarray` of the float64 products)."""
    vs = spec.voxel_size
    return f32(vs), f32(tau_edge_frac * vs * vs), f32(tau_x_frac * vs)


def clip01(occ: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1] with jnp.clip's tie gradient (0.5 at 0 and at 1)."""
    return torch.minimum(torch.maximum(occ, occ.new_zeros(())), occ.new_ones(()))


def x_centers(n: int, ox: float, vs: float, device) -> torch.Tensor:
    """Cell-centre x coordinates, ``ox + (x * vs + vs / 2)`` in float32."""
    return ox + (torch.arange(n, device=device, dtype=torch.float32) * vs + vs * 0.5)


def profile_out(n: int, device) -> torch.Tensor:
    """A zeroed accumulator for `profile_add`: (n*n + 1, n) float64, its
    last row the dump for inert fragments. The float32 terms are summed
    in float64 and rounded once (`profile_grid`), so that a plain
    version's sum carries next to no rounding of its own: the kernels
    (whose forward sums are fixed-point, as exact) are held against
    nearly exact values."""
    return torch.zeros((n * n + 1, n), dtype=torch.float64, device=device)


def profile_grid(out: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, n, n) float32 occupancy of a `profile_out` accumulator."""
    return out[: n * n].view(n, n, n).float()


def profile_add(out: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                xh: torch.Tensor, cx: torch.Tensor, tau_x: float) -> None:
    """out[rows[f]] += w[f] * sigmoid((xh[f] - cx) / tau_x), in chunks.

    `out` is (R, N) and its last row is a dump for inert fragments
    (their `rows` point at it); `index_add_` sums in place, in `out`'s
    dtype."""
    step = max(1, CHUNK_ELEMS // max(cx.numel(), 1))
    for i in range(0, rows.numel(), step):
        sig = torch.sigmoid((xh[i:i + step, None] - cx[None, :]) / tau_x)
        out.index_add_(0, rows[i:i + step], (w[i:i + step, None] * sig).to(out.dtype))


def profile_sums(g: torch.Tensor, rows: torch.Tensor, xh: torch.Tensor,
                 cx: torch.Tensor, tau_x: float):
    """Per fragment f with pg = g[rows[f]] and sig its x profile:
    (sum pg * sig, sum pg * sig * (1 - sig)), in chunks. `g` is (R, N)
    with a zero last row for inert fragments."""
    a = torch.empty_like(xh)
    b = torch.empty_like(xh)
    step = max(1, CHUNK_ELEMS // max(cx.numel(), 1))
    for i in range(0, rows.numel(), step):
        sig = torch.sigmoid((xh[i:i + step, None] - cx[None, :]) / tau_x)
        ps = g.index_select(0, rows[i:i + step]) * sig
        a[i:i + step] = ps.sum(1)
        b[i:i + step] = (ps * (1.0 - sig)).sum(1)
    return a, b


class _Accumulate(torch.autograd.Function):
    """(F,) fragments (row, w, x_hit) -> (n, n, n) occupancy; row n*n
    is inert. The backward gathers instead of differentiating through
    the chunks, so that neither pass holds an (F, N) profile."""

    @staticmethod
    def forward(ctx, rows, w, xh, n: int, ox: float, vs: float, tau_x: float):
        cx = x_centers(n, ox, vs, w.device)
        out = profile_out(n, w.device)
        profile_add(out, rows, w.detach(), xh.detach(), cx, tau_x)
        ctx.save_for_backward(rows, w, xh, cx)
        ctx.tau_x = tau_x
        return profile_grid(out, n)

    @staticmethod
    def backward(ctx, g):
        rows, w, xh, cx = ctx.saved_tensors
        n = cx.numel()
        g_ext = torch.cat([g.reshape(n * n, n), g.new_zeros((1, n))])
        a, b = profile_sums(g_ext, rows, xh.detach(), cx, ctx.tau_x)
        return None, a, (w.detach() / ctx.tau_x) * b, None, None, None, None


def _soft_fragments(tri, start_y, start_z, *, window: int, n: int,
                    origin, vs: float, tau_e: float):
    """Per-bucket soft coverage (`soft_vox.py:53-92`): (T, 3, 3)
    triangles and their window starts -> (cell (F,) int64 with n*n for
    out-of-grid, weight (F,), x_hit (F,)), F = T * window^2 in
    (triangle, dz, dy) order. Differentiable in `tri`."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    normal_x = (b[:, 1] - a[:, 1]) * (c[:, 2] - b[:, 2]) - (
        b[:, 2] - a[:, 2]) * (c[:, 1] - b[:, 1])
    one = tri.new_ones(())
    sign = torch.where(normal_x >= 0, one, -one)
    cr = torch.linalg.cross(b - a, c - a, dim=1)
    A, B, C = cr[:, 0], cr[:, 1], cr[:, 2]
    D = A * a[:, 0] + B * a[:, 1] + C * a[:, 2]

    d = torch.arange(window, device=tri.device)
    ys = start_y[:, None, None] + d[None, None, :]
    zs = start_z[:, None, None] + d[None, :, None]
    cy = origin[1] + (ys.float() * vs + vs * 0.5)
    cz = origin[2] + (zs.float() * vs + vs * 0.5)

    def col(v):
        return v[:, None, None]

    s = col(sign)
    e0 = _edge_zy(col(a[:, 1]), col(a[:, 2]), col(b[:, 1]), col(b[:, 2]), cy, cz) * s
    e1 = _edge_zy(col(b[:, 1]), col(b[:, 2]), col(c[:, 1]), col(c[:, 2]), cy, cz) * s
    e2 = _edge_zy(col(c[:, 1]), col(c[:, 2]), col(a[:, 1]), col(a[:, 2]), cy, cz) * s
    cov = (torch.sigmoid(e0 / tau_e) * torch.sigmoid(e1 / tau_e)
           * torch.sigmoid(e2 / tau_e))
    in_grid = (ys >= 0) & (ys < n) & (zs >= 0) & (zs < n)

    degenerate = A.abs() < 1e-20
    safe_A = torch.where(degenerate, A.new_full((), 1e-20), A)
    x_hit = (col(D) - col(B) * cy - col(C) * cz) / col(safe_A)
    weight = torch.where(in_grid & ~col(degenerate), s * cov, cov.new_zeros(()))
    cell = torch.where(in_grid, zs * n + ys, torch.full_like(ys, n * n))
    return cell.reshape(-1), weight.reshape(-1), x_hit.reshape(-1)


def bucket_tensors(plan: FragmentPlan, device):
    """The plan's buckets on `device`: [(W, start_y, start_z, face
    vertex ids (T, 3))] as int64 tensors, copied once per device."""
    device = torch.empty(0, device=device).device
    cache = plan.__dict__.setdefault("_device_buckets", {})
    if device not in cache:
        faces = np.asarray(plan.faces_array, np.int64)
        cache[device] = [
            (b[0], *(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                     for a in (b[4], b[5])),
             torch.from_numpy(faces[np.asarray(b[6])]).to(device))
            for b in plan.buckets]
    return cache[device]


def soft_fragments(coords: torch.Tensor, plan: FragmentPlan, *,
                   tau_edge_frac: float, tau_x_frac: float):
    """Every bucket's fragments, concatenated in bucket order: (cell,
    weight, x_hit), each (F,). Differentiable in `coords`."""
    spec = plan.spec
    vs, tau_e, _ = temperatures(spec, tau_edge_frac, tau_x_frac)
    origin = [f32(o) for o in spec.origin]
    parts = [
        _soft_fragments(coords[fv], sy, sz, window=window, n=spec.n,
                        origin=origin, vs=vs, tau_e=tau_e)
        for window, sy, sz, fv in bucket_tensors(plan, coords.device)]
    if not parts:  # zero-face mesh: one inert sentinel fragment
        parts = [(torch.full((1,), spec.n * spec.n, dtype=torch.int64,
                             device=coords.device),
                  coords.new_zeros(1), coords.new_zeros(1))]
    return tuple(torch.cat(p) for p in zip(*parts))


def soft_voxelize(coords: torch.Tensor, plan: FragmentPlan, *,
                  tau_edge_frac: float = 0.25, tau_x_frac: float = 0.5,
                  clip: bool = True) -> torch.Tensor:
    """Differentiable (n, n, n) occupancy from (V, 3) float32 vertex
    coordinates (`soft_vox.py:109-157`). `plan` fixes the triangle
    bucketing; rebuild it (`refresh_soft_plan`) when vertices move
    across voxel rows."""
    spec = plan.spec
    vs, _, tau_x = temperatures(spec, tau_edge_frac, tau_x_frac)
    cells, w, x = soft_fragments(coords, plan, tau_edge_frac=tau_edge_frac,
                                 tau_x_frac=tau_x_frac)
    occ = _Accumulate.apply(cells, w, x, spec.n, f32(spec.origin[0]), vs, tau_x)
    return clip01(occ) if clip else occ


def make_soft_plan(mesh: Mesh, spec: GridSpec, pad_window: int = 1) -> FragmentPlan:
    """Soft plan: per-bucket face indices and padded raster windows
    (`soft_vox.py:160-237`, line for line). `pad_window` widens the
    windows so that sigmoid tails and small vertex motions stay covered;
    fragment count grows about quadratically with it. Span
    ``soft.plan``, counting the plan's fragments."""
    with span("soft.plan") as sp:
        plan = _soft_plan(mesh, spec, pad_window)
        sp.count("fragments", plan.num_fragments)
    return plan


def _soft_plan(mesh: Mesh, spec: GridSpec, pad_window: int) -> FragmentPlan:
    plan = FragmentPlan.__new__(FragmentPlan)  # a bare plan, filled below
    plan.spec = spec
    plan.faces_array = np.asarray(mesh.faces, np.int32)

    v0, v1, v2, start_y, start_z, w = _triangle_windows(mesh, spec)
    # Windows may exceed N by the padding (out-of-grid candidates are
    # masked at run time). An odd pad's leftover cell goes, per axis, to
    # the side whose base window has less slack.
    w_cap = spec.n + pad_window
    w = np.minimum(w + pad_window, w_cap)
    shift_y = np.full(len(w), pad_window // 2, np.int64)
    shift_z = shift_y.copy()
    if pad_window % 2:
        oy, oz = np.float32(spec.origin[1]), np.float32(spec.origin[2])
        vs_np = np.float32(spec.voxel_size)

        def _extra_low(lo, hi, o):
            t_lo = (lo - o) / vs_np
            t_hi = (hi - o) / vs_np
            return ((t_lo - np.floor(t_lo)) + (t_hi - np.floor(t_hi))
                    < 1.0)

        ys = (v0[:, 1], v1[:, 1], v2[:, 1])
        zs = (v0[:, 2], v1[:, 2], v2[:, 2])
        shift_y += _extra_low(np.minimum(np.minimum(*ys[:2]), ys[2]),
                              np.maximum(np.maximum(*ys[:2]), ys[2]), oy)
        shift_z += _extra_low(np.minimum(np.minimum(*zs[:2]), zs[2]),
                              np.maximum(np.maximum(*zs[:2]), zs[2]), oz)
    start_y = np.maximum(start_y - shift_y, -pad_window)
    start_z = np.maximum(start_z - shift_z, -pad_window)
    plan.buckets = []
    classes = _window_classes(max(int(w.max(initial=1)), 1))
    lo = 0
    for wclass in classes:
        idx = np.nonzero((w > lo) & (w <= wclass))[0]
        if idx.size:
            pad = _pad_granular(idx.size)
            plan.buckets.append((
                int(min(wclass, w_cap)), None, None, None,
                _pad_rows(start_y[idx].astype(np.int32), pad, fill=spec.n),
                _pad_rows(start_z[idx].astype(np.int32), pad, fill=spec.n),
                _pad_rows(idx.astype(np.int32), pad, fill=0),
            ))
        lo = wclass
    plan.num_fragments = sum(
        b[4].shape[0] * min(b[0], w_cap) ** 2 for b in plan.buckets)
    plan.pad_window = pad_window
    plan.plan_coords = np.asarray(mesh.coords, np.float32)
    return plan


def refresh_soft_plan(plan: FragmentPlan, coords) -> FragmentPlan:
    """The same plan (spec, faces, pad) rebuilt from moved vertices
    (`soft_vox.py:240-256`); `VoxelFit.maybe_refresh_plan` calls it."""
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    faces = np.asarray(plan.faces_array)
    mesh = Mesh(name="refresh", coords=np.asarray(coords, np.float32),
                faces=faces, faces_normals=faces)
    return make_soft_plan(mesh, plan.spec, pad_window=plan.pad_window)
