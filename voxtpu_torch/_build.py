"""Build, load and launch the port's CUDA kernels.

The sources under `csrc/*.cu` have a plain C interface. At first use
they are compiled with nvcc for Hopper (`sm_90a`), one nvcc process per
source, all started together, and linked into one shared library under
`csrc/build/` (listed in `.gitignore`), named by a hash of the sources
and flags so that an edit rebuilds it, and loaded with ctypes. A wrapper passes tensors as `data_ptr()` integers and PyTorch's
current stream; each C entry returns `cudaGetLastError()` after its
launch, and `launch` raises when that is not 0.

Nothing here runs at import: every module imports on a machine with
no nvcc and no card, and the library is built only when a kernel is
first launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"

# -fmad=false: no fused multiply-add contraction anywhere (the JFA
# distance and every float comparison must round term for term).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry point -> argtypes; every entry returns a cudaError_t as int.
SIGNATURES = {
    # tables, cells, tblidx, batch_tile, run_start, num_batches, num_runs,
    # tb, tbl, n, tc, num_tiles, ox, oy, oz, vs, tau_e, tau_x, work, out,
    # stream
    "vt_fused_fwd": [_P] * 5 + [_I] * 7 + [_F] * 6 + [_P] * 3,
    # tables, cells, tblidx, batch_tile, g, num_batches, tb, tbl, n, tc,
    # num_tiles, ox, oy, oz, vs, tau_e, tau_x, pre, dtab, stream
    "vt_fused_bwd": [_P] * 5 + [_I] * 6 + [_F] * 6 + [_P] * 3,
    # wb, xb, cells, batch_tile, run_start, num_batches, num_runs, tb, n,
    # tc, num_tiles, ox, vs, tau_x, work, out, stream
    "vt_fragment_fwd": [_P] * 5 + [_I] * 6 + [_F] * 3 + [_P] * 3,
    # wb, xb, cells, batch_tile, g, num_batches, tb, n, tc, num_tiles,
    # ox, vs, tau_x, pre, dw, dx, stream
    "vt_fragment_bwd": [_P] * 5 + [_I] * 5 + [_F] * 3 + [_P] * 4,
    # tables, cells, tblidx, batch_tile, batch_panel, run_start,
    # num_batches, num_runs, tb, tbl, n, tc, tz, num_tiles, ox, oy, oz, vs,
    # tau_e, tau_x, work, out_a, out_b, carry, stream
    "vt_seg_fwd": [_P] * 6 + [_I] * 8 + [_F] * 6 + [_P] * 5,
    # out_a, out_b, pre, n, tc, tz, out, stream
    "vt_seg_combine": [_P] * 3 + [_I] * 3 + [_P, _P],
    # tables, cells, tblidx, batch_tile, batch_panel, g, gpre, num_batches,
    # tb, tbl, n, tc, tz, num_tiles, ox, oy, oz, vs, tau_e, tau_x, dtab,
    # stream
    "vt_seg_bwd": [_P] * 7 + [_I] * 7 + [_F] * 6 + [_P, _P],
    # local, xs, batch_basew, start, order, B, tb, tc, nw, bwords,
    # num_tiles, nbusy, cluster, out, stream
    "vt_banded_fill": [_P] * 5 + [_I] * 8 + [_P, _P],
    # local, xs, start, order, tile_map, B, tb, tc, nw, num_tiles, nbusy,
    # out_tiles, cluster, out, stream
    "vt_wide_fill": [_P] * 5 + [_I] * 8 + [_P, _P],
    # cells, ws, his, masks, cnts, batch_tile, num_batches, tb, tc, nw, g,
    # num_super, wpad, out, stream
    "vt_word_event_fill": [_P] * 6 + [_I] * 7 + [_P, _P],
    # seed, out, org, n, k, then `WalkGeometry.args()`: mr_shift, chunks,
    # groups, walks, cols, x_groups, grid x, y, z, smem; stream
    "vt_flood_step": [_P, _P, _P] + [_I] * 12 + [_P],
    # seed, out, org, n, k, band, `WalkGeometry.args()`, stream
    "vt_flood_step_rows": [_P, _P, _P] + [_I] * 13 + [_P],
    # seed, occ, org, out, n, stream
    "vt_sdf_from_seed": [_P, _P, _P, _P, _I, _P],
    # seed, occ, org, out, n, k, emit_sdf, `WalkGeometry.args()`, stream
    "vt_flood_step_pipe": [_P] * 4 + [_I] * 13 + [_P],
    # cells2d, xs2d, row_start, num_chunks, tile_id, tile_mask, num_active,
    # num_rows, n, tc, num_tiles, out, stream
    "vt_wq_fill": [_P] * 6 + [_I] * 5 + [_P, _P],
    # seed, out, org, n, k, variant, stream
    "vt_flood_probe": [_P, _P, _P, _I, _I, _I, _P],
    # xlo, xhi, tbounds, counts, num_tiles, n, band, tb, stream
    "vt_band_cut_counts": [_P] * 4 + [_I] * 4 + [_P],
    # xlo, xhi, tbounds, off, pads, batch_tile, batch_base, start, end,
    # num_tiles, n, band, tb, stream
    "vt_band_cut": [_P] * 9 + [_I] * 4 + [_P],
    # csum, pbounds, counts, num_runs, tb, tbl, stream
    "vt_pair_cut_counts": [_P] * 3 + [_I] * 3 + [_P],
    # csum, pbounds, off, batch_run, p0, p1, num_runs, tb, tbl, stream
    "vt_pair_cut": [_P] * 6 + [_I] * 3 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's stderr (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile the kernels unless a library for these sources exists:
    one nvcc per source, all started together, then one link."""
    lib = BUILD_DIR / f"libvoxtpu_torch_{_digest()}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    tmp = lib.with_name(f"{tag}.so.tmp")
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    cmds.append([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds[:-1]]
        logs = [proc.communicate()[1] for proc in procs]
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            procs.append(link)
            logs.append(link.stdout + link.stderr)
        failed = [f"{' '.join(cmd)}\n{log}" for cmd, proc, log in zip(cmds, procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return Build(lib, time.perf_counter() - t0, "".join(logs))


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry's argtypes set."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if its launch reported an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.vt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """Kernel dispatch: False for CPU tensors (the plain version runs),
    True for CUDA tensors (the kernel launches); any other device, or
    tensors on different devices, raise. There is no fallback."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev} (expected cpu or cuda)")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel argument: dtype, contiguity and (optional) shape;
    None in `shape` matches any size."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None:
        ok = len(shape) == t.dim() and all(
            s is None or s == d for s, d in zip(shape, t.shape))
        if not ok:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
