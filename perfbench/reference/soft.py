"""Plain differentiable soft voxelization, soft-IoU loss and Adam.

The function that a fit's step computes (voxtpu's soft voxelization, as
`VoxelFit` documents it):

    occ(x, y, z) = clip01( sum_f  w_f * sigmoid((x_hit_f - cx) / tau_x) )

over the fragments f of a plan: for each triangle, the W x W cells of
its YZ raster window (the triangle's box of cells widened by one cell,
W the next size of the ladder 1, 2, 3, 4, 6, 8, 12, ...), with weight
w_f = sign(n_x) * prod_e sigmoid(edge_e(cy, cz) * sign(n_x) / tau_edge)
and x_hit_f the plane's x at the cell centre (0 weight out of the grid
or for a plane with |A| < 1e-20). The plan is built from the vertices
as they stood when it was made, and rebuilt on drift. clip01's gradient
at 0 and 1 is 0.5. The loss is 1 - soft IoU against the target, and the
optimizer Adam (beta 0.9, 0.999, eps 1e-8).

Every sum over columns runs over whole rows in float64 and rounds once,
in chunks of fragments; the rest runs in the working precision. Plain
torch operations; imports nothing of the program under test. `dtype`
float32 is the configuration's precision, a lower one the control.
"""

from __future__ import annotations

import math

import torch

CHUNK_ELEMS = 1 << 25
PAD = 1  # cells a plan's raster window is widened by


def f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def temperatures(voxel: float, tau_edge_frac: float, tau_x_frac: float):
    """(voxel size, tau_edge, tau_x), each rounded to float32."""
    return f32(voxel), f32(tau_edge_frac * voxel * voxel), f32(tau_x_frac * voxel)


def _ladder(w: torch.Tensor) -> torch.Tensor:
    """The least size of 1, 2, 3, 4, 6, 8, 12, 16, ... that holds w."""
    sizes = [1, 2, 3]
    c = 4
    wmax = int(w.max()) if w.numel() else 1
    while sizes[-1] < wmax:
        sizes += [c, c + c // 2]
        c *= 2
    ladder = torch.tensor(sizes, device=w.device)
    return ladder[torch.searchsorted(ladder, w)]


def plan(coords: torch.Tensor, faces: torch.Tensor, n: int, origin, voxel: float):
    """Each triangle's raster window from the vertices `coords`:
    (start_y, start_z, W), int64 each. Float32 arithmetic."""
    c = coords.detach().float()
    t = c[faces]  # (F, 3, 3)
    vs = torch.tensor(f32(voxel), device=c.device)
    out = []
    for axis in (1, 2):
        o = torch.tensor(f32(origin[axis]), device=c.device)
        lo = torch.minimum(torch.minimum(t[:, 0, axis], t[:, 1, axis]), t[:, 2, axis])
        hi = torch.maximum(torch.maximum(t[:, 0, axis], t[:, 1, axis]), t[:, 2, axis])
        start = torch.floor((lo - o) / vs).clamp(-1, n + 1).long().clamp(0, n)
        end = torch.ceil((hi - o) / vs).clamp(-1, n + 1).long().clamp(0, n)
        t_lo, t_hi = (lo - o) / vs, (hi - o) / vs
        # An odd widening's cell goes to the low side where the box has
        # less slack there.
        low = ((t_lo - torch.floor(t_lo)) + (t_hi - torch.floor(t_hi))) < 1.0
        out.append((start, end, low))
    (sy, ey, ly), (sz, ez, lz) = out
    w = torch.minimum(torch.maximum(ey - sy, ez - sz) + PAD, torch.tensor(n + PAD))
    shift = PAD // 2
    sy = torch.clamp(sy - shift - (ly.long() if PAD % 2 else 0), min=-PAD)
    sz = torch.clamp(sz - shift - (lz.long() if PAD % 2 else 0), min=-PAD)
    return sy, sz, torch.clamp(_ladder(w), max=n + PAD)


def fragments(coords: torch.Tensor, faces: torch.Tensor, windows, n: int, origin,
              voxel: float, tau_edge: float, dtype=torch.float32):
    """(rows (F,) int64, n*n for out of the grid; w (F,); x_hit (F,)),
    differentiable in `coords`; F counts every triangle's W x W cells."""
    sy, sz, W = windows
    rows, ws, xs = [], [], []
    ctab = coords.to(dtype)
    oy, oz = f32(origin[1]), f32(origin[2])
    vs = f32(voxel)
    for size in torch.unique(W).tolist():
        sel = torch.nonzero(W == size).squeeze(1)
        tri = ctab[faces[sel]]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        normal_x = (b[:, 1] - a[:, 1]) * (c[:, 2] - b[:, 2]) - (b[:, 2] - a[:, 2]) * (
            c[:, 1] - b[:, 1])
        one = torch.ones((), dtype=dtype, device=coords.device)
        s = torch.where(normal_x >= 0, one, -one)[:, None, None]
        u, v = b - a, c - a
        A = u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1]
        B = u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2]
        C = u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]
        D = A * a[:, 0] + B * a[:, 1] + C * a[:, 2]
        d = torch.arange(size, device=coords.device)
        ys = sy[sel, None, None] + d[None, None, :]
        zs = sz[sel, None, None] + d[None, :, None]
        cy = oy + (ys.to(dtype) * vs + vs * 0.5)
        cz = oz + (zs.to(dtype) * vs + vs * 0.5)

        def edge(p, q):
            py, pz, qy, qz = (t[:, None, None] for t in (p[:, 1], p[:, 2], q[:, 1], q[:, 2]))
            return ((cz - pz) * (qy - py) - (cy - py) * (qz - pz)) * s

        cov = (torch.sigmoid(edge(a, b) / tau_edge) * torch.sigmoid(edge(b, c) / tau_edge)
               * torch.sigmoid(edge(c, a) / tau_edge))
        in_grid = (ys >= 0) & (ys < n) & (zs >= 0) & (zs < n)
        flat = A.abs() < 1e-20
        safe_A = torch.where(flat, torch.full_like(A, 1e-20), A)
        col = lambda t: t[:, None, None]  # noqa: E731
        xh = (col(D) - col(B) * cy - col(C) * cz) / col(safe_A)
        w = torch.where(in_grid & ~col(flat), s * cov, torch.zeros((), dtype=dtype,
                                                                  device=coords.device))
        rows.append(torch.where(in_grid, zs * n + ys, torch.full_like(ys, n * n)).reshape(-1))
        ws.append(w.reshape(-1))
        xs.append(xh.reshape(-1))
    return torch.cat(rows), torch.cat(ws), torch.cat(xs)


def _sig(xh, cx, tau_x):
    return torch.sigmoid((xh[:, None] - cx[None, :]) / tau_x)


class Accumulate(torch.autograd.Function):
    """Fragments (rows, w, x_hit) -> (n, n, n) sums over whole rows; the
    backward gathers the cotangent's rows (no (F, n) profile is kept)."""

    @staticmethod
    def forward(ctx, rows, w, xh, cx, tau_x: float, acc_dtype):
        n = cx.numel()
        out = torch.zeros((n * n + 1, n), dtype=acc_dtype, device=w.device)
        step = max(1, CHUNK_ELEMS // n)
        for i in range(0, rows.numel(), step):
            sig = _sig(xh[i:i + step], cx, tau_x)
            out.index_add_(0, rows[i:i + step], (w[i:i + step, None] * sig).to(acc_dtype))
        ctx.save_for_backward(rows, w, xh, cx)
        ctx.tau_x = tau_x
        return out[:n * n].view(n, n, n).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, w, xh, cx = ctx.saved_tensors
        n = cx.numel()
        g_rows = torch.cat([g.reshape(n * n, n), g.new_zeros((1, n))])
        ga, gb = torch.empty_like(xh), torch.empty_like(xh)
        step = max(1, CHUNK_ELEMS // n)
        for i in range(0, rows.numel(), step):
            sig = _sig(xh[i:i + step], cx, ctx.tau_x)
            ps = g_rows.index_select(0, rows[i:i + step]) * sig
            ga[i:i + step] = ps.sum(1)
            gb[i:i + step] = (ps * (1.0 - sig)).sum(1)
        return None, ga, (w / ctx.tau_x) * gb, None, None, None


def occupancy(coords, faces, windows, n: int, origin, voxel: float, tau_edge_frac: float,
              tau_x_frac: float, dtype=torch.float32):
    """The clipped soft occupancy (n, n, n) of `coords` on a plan's windows."""
    vs, tau_e, tau_x = temperatures(voxel, tau_edge_frac, tau_x_frac)
    rows, w, xh = fragments(coords, faces, windows, n, origin, voxel, tau_e, dtype)
    cx = f32(origin[0]) + (torch.arange(n, device=coords.device, dtype=dtype) * vs + vs * 0.5)
    acc = torch.float64 if dtype == torch.float32 else dtype
    occ = Accumulate.apply(rows, w, xh, cx, tau_x, acc)
    return torch.minimum(torch.maximum(occ, occ.new_zeros(())), occ.new_ones(()))


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    inter = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target) - inter
    return 1.0 - inter / (union + 1e-8)


def loss_and_grad(coords, faces, windows, target, n, origin, voxel, tau, dtype):
    """(loss, d loss / d coords) in `dtype`."""
    c = coords.detach().to(dtype).requires_grad_(True)
    loss = iou_loss(occupancy(c, faces, windows, n, origin, voxel, *tau, dtype=dtype),
                    target.to(dtype))
    (g,) = torch.autograd.grad(loss, c)
    return loss.detach(), g


def fit(start, faces, target, n: int, origin, voxel: float, *, steps: int, lr: float,
        tau=(0.5, 0.5), replan_at=(), dtype=torch.float32) -> dict:
    """`steps` Adam steps from `start` on a plan built from `start` and
    rebuilt from the coordinates as they stand before each step in
    `replan_at` (counted from 1): {"losses": [loss of each step],
    "grad_norm": |first gradient|, "change_norm": |coords after the steps
    - start|}."""
    windows = plan(start, faces, n, origin, voxel)
    p = start.detach().to(dtype)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    losses, grad_norm = [], None
    for t in range(1, steps + 1):
        if t in replan_at:
            windows = plan(p, faces, n, origin, voxel)
        loss, g = loss_and_grad(p, faces, windows, target, n, origin, voxel, tau, dtype)
        losses.append(float(loss))
        if grad_norm is None:
            grad_norm = float(torch.linalg.vector_norm(g.float()))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        denom = torch.sqrt(v) / math.sqrt(1 - 0.999 ** t) + 1e-8
        p = p - (lr / (1 - 0.9 ** t)) * (m / denom)
    change = float(torch.linalg.vector_norm((p.float() - start.float())))
    return {"losses": losses, "grad_norm": grad_norm, "change_norm": change}
