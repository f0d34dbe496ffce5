"""The collectives of the sharded paths, each on a process group.

voxtpu's `shard_map` bodies become the code every rank runs (SPMD), and
their collectives become these helpers:

| voxtpu | here |
|---|---|
| `ppermute` | `permute` (`batch_isend_irecv` within the group; under NCCL after a collective of the whole group) |
| `psum_scatter(tiled=True)` | `reduce_scatter` (`reduce_scatter_tensor`) |
| `psum` | `all_reduce` |
| `all_gather(tiled=True)` | `all_gather` (`all_gather_into_tensor`) |

A group of one rank needs no collective, and gets none: the tensor is
returned as it is (a world of 1 runs the single-device arithmetic).

**Backends.** The caller picks the backend when it starts the process
group, and nothing here changes it. gloo's send/recv, all-gather and
reduce-scatter take CPU tensors, so where a group's backend is gloo and
a tensor lies on a CUDA card, the helper copies it to the host, runs
the collective there and copies the result back: a transport, counted
in `staged_bytes` (both directions), not a fallback. The arithmetic
stays on the card. Any other backend (NCCL for CUDA tensors) gets the
tensors as they are; an error it raises is not caught.

**Gradients.** `ReduceScatter` and `SumReplicated` are autograd
Functions with voxtpu's transposes: the reduce-scatter's backward is an
all-gather over the same group, and the sum of replicated values takes
the identity as its backward (every rank then back-propagates its own
share of one replicated loss). `torch.distributed.nn.functional`'s
all_reduce sums the cotangents over the ranks in its backward, which
would count a replicated loss's gradient once per rank; it is not used.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if _staged(group, t):
        staged_bytes.count += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if wire.device != like.device:
        staged_bytes.count += wire.numel() * wire.element_size()
        return wire.to(like.device)
    return wire


def staged_bytes() -> int:
    """Bytes copied between a card and the host for gloo since the count
    was last set to 0 (``staged_bytes.count = 0``)."""
    return staged_bytes.count


staged_bytes.count = 0


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of `t` over the group, as a new tensor on `t`'s
    device (voxtpu's psum)."""
    if _size(group) == 1:
        return t
    wire = _to_wire(group, t).clone()
    dist.all_reduce(wire, op=op, group=group)
    return _from_wire(wire, t)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in group-rank order
    (voxtpu's all_gather(tiled=True)); every rank's must have `t`'s
    shape."""
    if _size(group) == 1:
        return t
    wire = _to_wire(group, t)
    out = wire.new_empty((wire.shape[0] * _size(group), *wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=group)
    return _from_wire(out, t)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, this rank's block of dim 0 (voxtpu's
    psum_scatter(scatter_dimension=0, tiled=True)); dim 0 must divide by
    the group's size."""
    size = _size(group)
    if size == 1:
        return t
    if t.shape[0] % size:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not divide by {size} ranks")
    wire = _to_wire(group, t)
    out = wire.new_empty((wire.shape[0] // size, *wire.shape[1:]))
    dist.reduce_scatter_tensor(out, wire, group=group)
    return _from_wire(out, t)


def _whole_group(group, t: torch.Tensor) -> None:
    """A collective that every rank of the group joins, on `t`'s card.
    NCCL leaves a batch of sends and receives undefined (a hang is
    typical) when it is the first call on a group and some rank has no
    operation in it, as the end ranks of a halo exchange have none; a
    one-element all-reduce first brings the group's communicator up on
    every rank. Every rank calls `permute` alike (SPMD), so the
    all-reduce matches across the group at each exchange."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(torch.zeros(1, device=t.device), group=group)


def permute(t: torch.Tensor, group, send_to: int | None,
            recv_from: int | None) -> torch.Tensor | None:
    """One step of voxtpu's ppermute within the group: send `t` to group
    rank `send_to` and receive a tensor of `t`'s shape from `recv_from`
    (either may be None). Every rank of the group calls it, those with
    neither too. Returns what was received, or None."""
    if _size(group) > 1:
        _whole_group(group, t)
    ops, got = [], None
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, _to_wire(group, t),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        got = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if _staged(group, t) else t.device)
        ops.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(group, recv_from), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if got is None else _from_wire(got, t)


class ReduceScatter(torch.autograd.Function):
    """`reduce_scatter` along dim 0; backward the all-gather of the
    cotangent over the same group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = reduce_scatter(t, group)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group), None


class SumReplicated(torch.autograd.Function):
    """`all_reduce` (sum) whose backward is the identity: each rank's
    summand gets the cotangent of the replicated sum once."""

    @staticmethod
    def forward(ctx, t, group):
        out = all_reduce(t, group)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return g, None
