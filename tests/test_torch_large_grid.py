"""The port's pieces for grids too large to unpack (4096^3 is 2^31 words,
8 GiB packed, 64 GiB dense), on the CPU at small sizes:

- `voxelize_ref_planes` (the plane oracle) against `voxelize_ref`'s
  planes, on an icosphere and a rotated torus at 64, every plane and a
  sparse set;
- the packed checks (`packed_popcount`, `xor_popcount`, `grid_digest`)
  against dense NumPy, in chunks smaller than the grid, and the digest
  against voxtpu's `_grid_digest` (`bench.py:395-419`) on the same words;
  a digest that changes when any one word flips;
- the banded plan built on the host at N = 4096 for a small mesh: its
  arrays' shapes and index ranges in bounds, and its per-call emit (no
  grid is made);
- `utils/timing.py::time_device_fn`'s refusals.
"""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch.grids import voxel_grid as G
from voxtpu_torch.grids.voxel_grid import GridSpec, pack_bits
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.reference import voxelize_ref, voxelize_ref_planes


def _mesh(name):
    if name == "icosphere":
        c, f = procedural.icosphere(3, center=(0.1, -0.2, 0.3))
    else:
        c, f = procedural.torus(1.0, 0.35, 24, 12)
        a, b = 0.3, 0.5  # turned off every axis: no face x-parallel
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        c = (c.astype(np.float64) @ (ry @ rx).T).astype(np.float32)
    return Mesh(name=name, coords=c, faces=f, faces_normals=f)


@pytest.mark.parametrize("name", ["icosphere", "torus"])
@pytest.mark.parametrize("which", ["every", "sparse", "none"])
def test_plane_oracle_is_voxelize_refs_planes(name, which):
    mesh = _mesh(name)
    spec = GridSpec.fit(mesh.coords, 64)
    whole = voxelize_ref(mesh, spec)
    planes = {"every": np.arange(64), "sparse": np.array([0, 5, 17, 31, 32, 50, 63]),
              "none": np.zeros(0, np.int64)}[which]
    got = voxelize_ref_planes(mesh, spec, planes)
    assert got.shape == (len(planes), 64, 64) and got.dtype == bool
    np.testing.assert_array_equal(got, whole[planes])
    if which != "none":
        assert got.any()


@pytest.mark.parametrize("planes", [[3, 3], [5, 2], [-1], [64]])
def test_plane_oracle_refuses_bad_planes(planes):
    mesh = _mesh("icosphere")
    with pytest.raises(ValueError, match="strictly increasing"):
        voxelize_ref_planes(mesh, GridSpec.fit(mesh.coords, 64), planes)


def _grids(n=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n, n)) < 0.3
    a[::3, ::2, 31::32] = True  # bit 31: the int32 word's sign bit
    b = a.copy()
    b[rng.random((n, n, n)) < 0.01] ^= True
    return a, b


@pytest.mark.parametrize("chunk", [1 << 24, 1000, 4096])
def test_packed_checks_are_dense_numpys(monkeypatch, chunk):
    monkeypatch.setattr(G, "CHECK_CHUNK", chunk)
    a, b = _grids()
    wa, wb = pack_bits(torch.from_numpy(a)), pack_bits(torch.from_numpy(b))
    assert G.packed_popcount(wa) == int(a.sum())
    assert G.VoxelGrid(wa, torch.zeros(3), torch.ones(())).count() == int(a.sum())
    assert G.xor_popcount(wa, wb) == int((a != b).sum())
    assert G.xor_popcount(wa, wa) == 0


def _digest_numpy(words: np.ndarray):
    """The digest's formula in uint32 NumPy, wrapping as uint32 does."""
    w = words.reshape(-1, words.shape[-1]).view(np.uint32)
    nw = w.shape[1]
    pos = (np.arange(w.shape[0], dtype=np.uint32)[:, None] * np.uint32(nw)
           + np.arange(nw, dtype=np.uint32)[None, :])
    m1 = pos * np.uint32(2654435761) | np.uint32(1)
    m2 = (pos ^ np.uint32(0x9E3779B9)) * np.uint32(0x85EBCA6B) | np.uint32(1)
    pop = int(np.unpackbits(w.view(np.uint8)).sum()) & 0xFFFFFFFF
    return pop, int((w * m1).sum(dtype=np.uint32)), int((w * m2).sum(dtype=np.uint32))


@pytest.mark.parametrize("chunk", [1 << 24, 999])
def test_grid_digest_is_voxtpus(monkeypatch, chunk):
    import jax.numpy as jnp

    from bench import _grid_digest

    monkeypatch.setattr(G, "CHECK_CHUNK", chunk)
    a, _ = _grids()
    words = pack_bits(torch.from_numpy(a))
    got = G.grid_digest(words)
    want = tuple(int(x) for x in _grid_digest(jnp.asarray(words.numpy().view(np.uint32))))
    assert got == want == _digest_numpy(words.numpy())


def test_grid_digest_changes_when_any_one_word_flips():
    n = 32
    a, _ = _grids(n, seed=3)
    words = pack_bits(torch.from_numpy(a))
    base = G.grid_digest(words)
    rng = np.random.default_rng(1)
    flat = words.view(-1)
    for i in range(flat.shape[0]):
        bit = int(rng.integers(0, 32))
        mask = int(np.array(1 << bit, np.uint32).view(np.int32))
        flat[i] ^= mask
        got = G.grid_digest(words)
        assert got[1] != base[1] and got[2] != base[2], (i, bit)
        flat[i] ^= mask
    assert G.grid_digest(words) == base


def test_banded_plan_at_4096_is_in_bounds():
    """The banded pipeline's host plan at N = 4096 (voxtpu's largest
    grid, band 256) for a small mesh, built on the CPU: every array's
    shape and range as the kernels assume them, and one call's emit."""
    from voxtpu_torch.ops.vox_slots_banded import (BAND, TB_SUB, BandedSlotVoxPipeline,
                                                   emit_slots)

    n = 4096
    c, f = procedural.washer(0.85, 1.0, 0.16, nu=16)  # x-parallel caps: wide candidates
    mesh = Mesh(name="washer", coords=c, faces=f, faces_normals=f)
    spec = GridSpec.fit(c, n)
    pipe = BandedSlotVoxPipeline(mesh, spec, "cpu")
    st, tc = pipe.state, pipe.tc
    num_tiles = n * n // tc
    assert pipe.band == BAND == 256 and pipe.num_tiles == num_tiles == 131072
    b = st.local.shape[0]
    assert st.local.shape == (b, TB_SUB, 128) and st.local.dtype == torch.int32
    assert all(r.shape == st.local.shape and r.dtype == torch.float32 for r in st.rows)
    assert int(st.local.min()) >= -1 and int(st.local.max()) < tc
    assert 0 <= int(st.batch_tile.min()) and int(st.batch_tile.max()) < num_tiles
    assert bool((st.batch_tile[1:] >= st.batch_tile[:-1]).all())
    assert 0 <= int(st.batch_basew.min()) and int(st.batch_basew.max()) <= (n - BAND) // 32
    lay = st.layout
    assert torch.equal(torch.sort(lay.order.long()).values, torch.arange(num_tiles))
    assert lay.start.shape == (lay.nbusy + 1,) and int(lay.start[-1]) == b
    assert pipe.num_wide > 0
    w_rows, w_local, w_rtile, w_ctile, w_uidx = st.wide
    assert 0 <= int(w_uidx.min()) and int(w_uidx.max()) < num_tiles
    assert int(w_ctile.max()) < w_uidx.shape[0]
    assert torch.equal(w_uidx[w_ctile.long()], w_rtile)
    (lk, xs), (wk, wxs), overflow = emit_slots(st, pipe._origin, pipe._voxel_size, n=n,
                                               tc=tc, band=pipe.band)
    assert int(overflow) == 0
    live = lk >= 0
    assert int(live.sum()) > 0
    base = st.batch_basew[:, None, None] * 32
    assert bool(((xs >= base) & (xs < base + BAND))[live].all())
    assert int(xs.min()) >= 0 and int(xs.max()) < n and int(wxs.max()) < n


def test_time_device_fn_refusals():
    from voxtpu_torch.utils.timing import time_device_fn

    with pytest.raises(ValueError, match="warmup must be >= 1"):
        time_device_fn(lambda: None, warmup=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            time_device_fn(lambda: None)
