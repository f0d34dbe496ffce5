"""The word-event fill B12's CUDA source, run on the CPU against its plain version.

Without a card the wrapper runs `word_event_fill_plain`, so the CPU
tests never reach `csrc/vox_we.cu`: its binary search over the batches,
the mask and marker-bit atomics, the carries' word-parallel prefix XOR
and the write-out in uint4 units (nw % 4 == 0) or words. Here the source
is compiled with the host C++ compiler against `tests/cuda_emulation.h`
(blocks one after another, a block's threads as host threads with real
barriers, atomics as `std::atomic_ref`) and launched through its C
entry point with the wrapper's own geometry (`_panel_geometry`).
Tolerance: bitwise, against `word_event_fill_plain`, on icosphere plans
and on hand-made events: duplicates, inert events, odd counts with
w + 1 == hi and with hi at or past the panel's 128 lanes, and batches
whose supertile lies outside [0, num_super). The output starts as a
pattern, so a word the kernel does not write shows. Skips where no
C++20 compiler is installed.
"""

import ctypes

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import _build
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops import vox_word_event as W
from voxtpu_torch.ops.vox_cuda import TB_LANE

from tests.emulation import build_host_library

UNWRITTEN = 0x5A5A5A5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = build_host_library(tmp_path_factory.mktemp("we_emulated"),
                            {"vox_we.cu": (_build.CSRC / "vox_we.cu").read_text()},
                            ["vox_we.cu"], "we_emulated")
    library = ctypes.CDLL(str(so))
    library.vt_word_event_fill.argtypes = _build.SIGNATURES["vt_word_event_fill"]
    return library


def _b12(lib, cells, ws, his, masks, cnts, batch_tile, *, n, tc, wpad=None):
    """B12 through its C entry -> (error code, the (n, n, n/32) words)."""
    nw, _, g, num_super, lanes = W._panel_geometry(n, tc)
    out = torch.full((n, n, nw), UNWRITTEN, dtype=torch.int32)
    err = lib.vt_word_event_fill(cells.data_ptr(), ws.data_ptr(), his.data_ptr(),
                                 masks.data_ptr(), cnts.data_ptr(), batch_tile.data_ptr(),
                                 cells.shape[0], cells.shape[1] * cells.shape[2], tc, nw, g,
                                 num_super, lanes if wpad is None else wpad,
                                 out.data_ptr(), None)
    return err, out


def _plan(n, tc, tb_sub):
    coords, faces = procedural.icosphere(3, center=(0.1, -0.2, 0.3))
    mesh = Mesh(name="icosphere", coords=coords, faces=faces, faces_normals=faces)
    spec = GridSpec.fit(coords, n)
    return W.WordEventVoxPlan(mesh, spec, "cpu", tc=tc, tb_sub=tb_sub)


# (64, 64, 1): nw = 2, G = 64, word stores; (96, 128, 4): nw = 3, G = 36
# (not a power of two), word stores; (128, 128, 4): nw = 4, uint4 stores.
@pytest.mark.parametrize("n,tc,tb_sub", [(64, 64, 1), (96, 128, 4), (128, 128, 4)])
def test_b12_source_is_bitwise_plain_on_plans(lib, n, tc, tb_sub):
    plan = _plan(n, tc, tb_sub)
    args = (plan.cells, plan.ws, plan.his, plan.masks, plan.cnts, plan.batch_tile)
    err, got = _b12(lib, *args, n=n, tc=tc)
    assert err == 0
    want = W.word_event_fill_plain(*args, n=n, tc=tc)
    assert torch.equal(got, want)
    assert bool((got != 0).any())


def _hand_made(n, tc, tb_sub, seed):
    """Events of every kind on every supertile, plus batches on tiles -1
    and num_super (skipped): random events (inert cells and lanes, any
    bound, any count) and, on each real tile, duplicates at one (cell,
    word), an odd count with w + 1 == hi, one with hi == 128 and one
    with hi past it."""
    _, _, _, num_super, wpad = W._panel_geometry(n, tc)
    rng = np.random.default_rng(seed)
    tiles = [-1] + [t for t in range(num_super) for _ in range(2)] + [num_super]
    shape = (len(tiles), tb_sub, TB_LANE)
    cells = rng.integers(-1, tc + 1, shape)
    ws = rng.integers(-1, wpad + 2, shape)
    his = np.minimum(ws + rng.integers(-1, 40, shape), wpad + 3)
    masks = rng.integers(-2 ** 31, 2 ** 31, shape)
    cnts = rng.integers(0, 4, shape)
    for b in range(1, len(tiles) - 1, 2):
        flat = [a[b].reshape(-1) for a in (cells, ws, his, masks, cnts)]
        made = [(5, 9, 40, 0x0F0F0F0F, 3), (5, 9, 60, -0x10000, 1),  # duplicates
                (7, 20, 21, 0x1, 1),                                 # w + 1 == hi
                (8, 100, wpad, -1, 5),                               # hi == 128
                (9, 3, wpad + 7, 0x80000000 - 2 ** 32, 1),           # hi past 128
                (10, 126, wpad, 0, 1), (11, wpad - 1, wpad, 0x7, 1),
                (-1, 4, 50, 0x3, 1), (tc, 4, 50, 0x3, 1),            # inert cells
                (12, -1, 50, 0x3, 1), (12, wpad, wpad + 1, 0x3, 1)]  # inert lanes
        for i, event in enumerate(made):
            for a, v in zip(flat, event):
                a[i] = v
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))  # noqa: E731
    return (*(t(a) for a in (cells, ws, his, masks, cnts)), t(np.array(tiles)))


@pytest.mark.parametrize("n,tc,tb_sub", [(64, 64, 1), (96, 128, 2), (128, 128, 1)])
def test_b12_source_is_bitwise_plain_on_hand_made_events(lib, n, tc, tb_sub):
    args = _hand_made(n, tc, tb_sub, seed=n)
    err, got = _b12(lib, *args, n=n, tc=tc)
    assert err == 0
    assert torch.equal(got, W.word_event_fill_plain(*args, n=n, tc=tc))


def test_b12_entry_refuses_another_panel_width(lib):
    """The kernel's panel is 128 lanes, every plan's wpad."""
    args = _hand_made(128, 128, 1, seed=1)
    err, got = _b12(lib, *args, n=128, tc=128, wpad=64)
    assert err != 0
    assert bool((got == UNWRITTEN).all())
