#!/usr/bin/env python3
"""B1 and B2 (the fill kernels) and one banded_total call, timed on a CUDA card.

    python3 tools/time_fill.py                    # this tree
    (cd other_tree && python3 /path/to/tools/time_fill.py --label parent)
    python3 tools/time_fill.py --sweep            # also each cluster size

Imports `voxtpu_torch` from the current directory, so one copy of this
script times any tree of the repo, and takes its measurements from the
`chip_smoke.py` beside it (`fill_calls`, `time_fills`, `time_total`,
`host_split`). A tree whose pipelines keep no fill layouts (before
`wide_fill_into`: B1 takes no layout, B2 runs as a compact buffer and a
merge) is driven through `legacy_calls`, so that a parent of that form
is timed beside this tree in one call. On washer_a of the smoke's main path
(1,348,128 faces) at 512^3 and 1024^3 on the spec of both washers:

- the pipeline's grid against the plain pipeline (xor popcount 0);
- the batches per tile that B1 and B2 see;
- B1, B2 as the pipeline runs it and B2's compact form, each a single
  call and a launch in a run (`chip_smoke.device_ms`), beside its bound,
  on the plan's slots (the wide ones inert) and on live random wide
  slots of the same shape;
- one whole `banded_total` call: device time, single call, host wall;
- at 512^3, the kernels one call launches (torch.profiler) and, in a
  tree with fill layouts, the split of its host part;
- with --sweep (a tree with fill layouts), B1 and B2 (in place, live
  slots) at each cluster size.

Prints one JSON line, {"label": ..., "card": ..., results}, last.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_launches(fn) -> dict:
    """The device kernels, memsets and copies of one fn(), by kind:
    "fill" (B1, B2), "int fill" (torch's zero fills of int32 buffers),
    "merge" (the gather, XOR and index_put of a compact buffer), "copy"
    (host-to-device copies), and "total"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = collections.Counter({"total": 0})
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kinds["total"] += 1
        name = e.name
        if "suffix_fill_kernel" in name:
            kinds["fill"] += 1
        elif "FillFunctor<int>" in name:
            kinds["int fill"] += 1
        elif "gather" in name or "index_put" in name or "BitwiseXor" in name:
            kinds["merge"] += 1
        elif "Memcpy HtoD" in name:
            kinds["copy"] += 1
    return dict(kinds)


def legacy_calls(pipe, spec, banded, wide):
    """`chip_smoke.fill_calls` for a tree without fill layouts: B1 on its
    own, "B2" as that tree's pipeline ran it (the compact buffer, then a
    gather, XOR and scatter into a scratch grid), "B2 compact" alone."""
    import torch

    from voxtpu_torch.ops import vox_cuda
    from voxtpu_torch.ops import vox_slots_banded as V

    st, n, tc = pipe.state, spec.n, pipe.tc
    lk, xs = banded
    w_ctile, w_uidx = st.wide[3], st.wide[4]
    k = w_uidx.shape[0]
    rows = torch.zeros((n * n // tc, tc, n // 32), dtype=torch.int32, device=lk.device)

    def b2():
        rows[w_uidx] ^= vox_cuda.wide_fill(*wide, w_ctile, n=n, tc=tc, num_tiles=k)

    calls = {"B1": lambda: V.banded_fill(lk, xs, st.batch_tile, st.batch_basew, n=n,
                                         tc=tc, band=pipe.band),
             "B2": b2,
             "B2 compact": lambda: vox_cuda.wide_fill(*wide, w_ctile, n=n, tc=tc,
                                                      num_tiles=k)}
    slot_bytes = _nbytes(*wide, w_ctile)
    moved = {"B1": _nbytes(lk, xs, st.batch_tile, st.batch_basew) + n ** 3 // 8,
             "B2": slot_bytes + _nbytes(w_uidx) + 2 * k * tc * n // 8,
             "B2 compact": slot_bytes + k * tc * n // 8}
    return calls, moved, rows


def sweep_calls(pipe, spec, banded, wide, live_wide, cluster):
    """B1, B2 in place on the plan's (inert) wide slots and B2 in place on
    live ones, each on its plan's layout with `cluster` blocks a busy
    tile in place of the plan's own size."""
    import torch

    from voxtpu_torch.ops import vox_cuda
    from voxtpu_torch.ops import vox_slots_banded as V

    st, n, tc = pipe.state, spec.n, pipe.tc
    lay = dataclasses.replace(st.layout, cluster=cluster)
    wlay = dataclasses.replace(st.wide_layout, cluster=cluster)
    grid = torch.zeros((n, n, n // 32), dtype=torch.int32, device=banded[0].device)
    return (lambda: V.banded_fill(*banded, st.batch_tile, st.batch_basew, n=n, tc=tc,
                                  band=pipe.band, layout=lay),
            *(lambda w=w: vox_cuda.wide_fill_into(grid, *w, st.wide[3], st.wide[4], n=n,
                                                  tc=tc, layout=wlay)
              for w in (wide, live_wide)))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_fill: no CUDA device is available", file=sys.stderr)
        return 2
    S = smoke()
    from voxtpu_torch import _build
    from voxtpu_torch.grids.voxel_grid import GridSpec
    from voxtpu_torch.mesh import procedural
    from voxtpu_torch.mesh.mesh import Mesh
    from voxtpu_torch.ops.vox_slots_banded import BandedSlotVoxPipeline

    _build.library()
    dev = torch.device("cuda", 0)
    card = S.card_line()
    print(f"{args.label}: {os.getcwd()}; {card}", flush=True)
    c, f = procedural.washer(0.85, 1.0, 0.16, nu=64)
    c, f = procedural.subdivide_to(c, f, S.MAIN_FACES)
    shifted = (c + [0.9, 0.0, 0.05]).astype(c.dtype)
    mesh = Mesh(name="washer_a", coords=c, faces=f, faces_normals=f)
    allc = np.concatenate([c, shifted])
    out = {"label": args.label, "card": card}
    for n in (S.MAIN_N, 1024):
        spec = GridSpec.fit(allc, n)
        pipe = BandedSlotVoxPipeline(mesh, spec, dev)
        words, overflow = pipe.words()
        x = S.xor_popcount(words, S.plain_words(pipe, spec))
        S.require(int(overflow) == 0 and x == 0, f"{n}^3: grid differs from plain ({x})")
        del words
        layouts = hasattr(pipe.state, "layout")
        fill_calls = S.fill_calls if layouts else legacy_calls
        res = {"spread": S.fill_spread(pipe) if layouts else None}
        print(f"{n}^3: xor 0 against the plain pipeline; {res['spread']}", flush=True)
        banded, wide = S.pipeline_inputs(pipe, spec)
        calls, moved, _ = fill_calls(pipe, spec, banded, wide)
        res["inert"] = S.time_fills(calls, moved, f"{n}^3 inert")
        g = torch.Generator().manual_seed(11)
        live_wide = tuple(torch.randint(0, hi, tuple(wide[0].shape), generator=g,
                                        dtype=torch.int32).to(dev) for hi in (pipe.tc, n))
        live, live_moved, _ = fill_calls(pipe, spec, banded, live_wide)
        res["live"] = S.time_fills(live, live_moved, f"{n}^3 live")
        res["total"] = S.time_total(pipe, f"{n}^3")
        if n == S.MAIN_N:
            res["launches"] = kernel_launches(pipe.words)
            print(f"device work of one banded_total call (pipe.words()): {res['launches']}",
                  flush=True)
            if layouts:
                res["host"] = S.host_split(pipe, spec)
        if args.sweep and layouts:
            sweep = {}
            for cl in (1, 2, 3, 4, 6, 8, 12, 16):
                b1, b2i, b2 = (S.device_ms(fn) for fn in sweep_calls(pipe, spec, banded,
                                                                      wide, live_wide, cl))
                sweep[cl] = (b1, b2i, b2)
                print(f"{n}^3 cluster {cl}: B1 {b1:.4f} ms, B2 in place {b2i:.4f} (inert), "
                      f"{b2:.4f} (live) ms a launch in a run", flush=True)
            res["sweep"] = sweep
        out[n] = res
        del pipe, calls, live, banded, wide, live_wide
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
