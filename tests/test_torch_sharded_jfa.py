"""voxtpu_torch.parallel.sharded_jfa against voxtpu's sharded_jfa: at
n = 32, packed and wide, on (1, 2), (1, 4) and (2, 2), the assembled
field bitwise voxtpu's `jfa_sharded` (conftest's 8 virtual CPU devices)
on dyadic geometry (origin (0.5, 0, -1), voxel 1/32: every distance is
exact, so XLA:CPU's contracted multiply-adds round nothing; ROADMAP C)
and bitwise the port's single-device flood on a non-dyadic grid too;
`comm_bytes_per_step` over a table; the refusals, which need no
process group. The wide encoding also runs with byte budgets that force
z-chunks of one and of three planes (`BUDGETS`), over strides below, at
and above the slab ((1, 2): slab 16, k <= 16; (1, 4) and (2, 2): slab
8, k up to 16), held the same way. The port's ranks run as gloo worlds
of 2 and 4 CPU processes (`tests/torch_parallel_worker.py`)."""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from tests.torch_parallel_worker import World
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops.jfa import jfa
from voxtpu_torch.parallel import sharded_jfa as SJ

N = 32
DYADIC = (N, (0.5, 0.0, -1.0), 1.0 / N)
ODD = (N, (0.1, -0.23, 0.37), 0.0313)
SHAPES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
ENCODINGS = ("packed", "wide")
# Chunk temporaries of a z-plane of the wide step: one plane, three planes.
PLANE = 16 * N * N
BUDGETS = {"one_plane": PLANE, "three_planes": 3 * PLANE}


def ball():
    zz, yy, xx = np.indices((N, N, N))
    c = (N - 1) / 2
    return (zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 <= (N * 0.35) ** 2


def scattered():
    return np.random.default_rng(0).random((N, N, N)) < 0.03


GRIDS = {"ball": (ball(), DYADIC), "scattered": (scattered(), DYADIC),
         "scattered_odd": (scattered(), ODD)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    worlds = {size: World("jfa", size, {"shapes": shapes, "grids": GRIDS, "budgets": BUDGETS},
                          tmp_path_factory.mktemp(f"jfa{size}"))
              for size, shapes in SHAPES.items()}
    return {size: w.results() for size, w in worlds.items()}


def assembled(results, key, shape):
    dd, dz = shape
    rows = [np.concatenate([results[d * dz + z][key] for z in range(dz)]) for d in range(dd)]
    for row in rows[1:]:
        np.testing.assert_array_equal(row.view(np.int32), rows[0].view(np.int32))
    return rows[0]


def voxtpu_sharded(occ, shape, encoding):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.parallel.sharded_jfa import jfa_sharded

    devices = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    n, origin, vs = DYADIC
    return np.asarray(jfa_sharded(jnp.asarray(occ), JSpec(n=n, origin=origin, voxel_size=vs),
                                  Mesh(devices, ("d", "z")), encoding=encoding))


CASES = [(g, shape, e) for g in GRIDS for size in SHAPES for shape in SHAPES[size]
         for e in ENCODINGS]


@pytest.mark.parametrize("grid, shape, encoding", CASES)
def test_sharded_field_is_single_device_and_voxtpus(port, grid, shape, encoding):
    occ, spec = GRIDS[grid]
    got = assembled(port[shape[0] * shape[1]], (grid, shape, encoding), shape)
    single = jfa(torch.from_numpy(occ), GridSpec(*spec), backend="plain",
                 encoding=encoding).numpy()
    assert got.dtype == np.float32 and got.shape == (N, N, N)
    np.testing.assert_array_equal(got.view(np.int32), single.view(np.int32))
    assert np.isfinite(got).all()
    if spec == DYADIC:
        want = voxtpu_sharded(occ, shape, encoding)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


CHUNKED = [(g, shape, b) for g in GRIDS for size in SHAPES for shape in SHAPES[size]
           for b in BUDGETS]


@pytest.mark.parametrize("grid, shape, budget", CHUNKED)
def test_chunked_wide_field_is_single_device_and_voxtpus(port, grid, shape, budget):
    """The wide step in z-chunks of one and three planes gives the same
    field, bitwise, as the single-device flood (and voxtpu's sharded
    flood on the dyadic grids)."""
    occ, spec = GRIDS[grid]
    got = assembled(port[shape[0] * shape[1]], (grid, shape, "wide", budget), shape)
    single = jfa(torch.from_numpy(occ), GridSpec(*spec), backend="plain",
                 encoding="wide").numpy()
    np.testing.assert_array_equal(got.view(np.int32), single.view(np.int32))
    if spec == DYADIC:
        want = voxtpu_sharded(occ, shape, "wide")
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("budget, dz, planes", [
    (BUDGETS["one_plane"], 2, 1), (BUDGETS["three_planes"], 4, 3),
    (BUDGETS["one_plane"] - 1, 2, 1), (1 << 40, 4, N // 4)])
def test_wide_chunk_planes(budget, dz, planes):
    """The budgets above give the chunks they are named for; a chunk is
    at least one plane and at most the slab."""
    assert SJ._wide_chunk(N, N // dz, budget) == planes


def _cards_tool():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "check_sharded_cards.py"
    spec = importlib.util.spec_from_file_location("check_sharded_cards", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_wide_reckoning_of_the_cards_tool():
    """tools/check_sharded_cards.py reckons a rank's peak from the step's
    own per-voxel bytes, plus a chunk budget and headroom: 2048^3 on
    (1, 4) at 29 bytes a slab voxel is 58 GiB + 2 + 4, within the 75.4
    GiB an H100 rank had free under NCCL; the step's old 58 bytes a voxel
    did not fit."""
    tool = _cards_tool()
    assert tool.STEP_BYTES == SJ.WIDE_SLAB_BYTES == 29
    peak = tool.sharded_wide_peak(2048, 4)
    assert peak == 29 * 2048 ** 3 // 4 + tool.WIDE_BUDGET + tool.HEADROOM
    assert peak / 2 ** 30 == 64.0
    free = int(75.4 * 2 ** 30)
    assert peak <= free < tool.sharded_wide_peak(2048, 4, per_voxel=58)
    assert tool.largest_wide_n(free, 4, 29) == 2048
    assert tool.largest_wide_n(free, 4, 58) < 2048


COMM = [(n, dz, e, k, gathered) for n in (64, 2048) for dz in (2, 8) for e in ENCODINGS
        for k in (1, n // 16, n // 2) for gathered in (False, True)]


@pytest.mark.parametrize("n, dz, encoding, k, gathered", COMM)
def test_comm_bytes_per_step_is_voxtpus(n, dz, encoding, k, gathered):
    from voxtpu.parallel.sharded_jfa import comm_bytes_per_step

    assert (SJ.comm_bytes_per_step(n, dz, encoding, k, gathered)
            == comm_bytes_per_step(n, dz, encoding, k, gathered))


@pytest.mark.parametrize("n, dz, encoding, match", [
    (96, 6, "auto", "power of two"),
    (100, 8, "auto", "must divide by z axis"),
    (2048, 2, "packed", "packed seeds are 10-bit fields"),
    (32768, 2, "wide", "N <= 16384"),
    (64, 2, "narrow", "unknown encoding"),
])
def test_refusals_are_voxtpus(n, dz, encoding, match):
    """The port's refusals, checked without a process group, and
    voxtpu's on the same sizes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.parallel.sharded_jfa import jfa_sharded

    with pytest.raises(ValueError, match=match):
        SJ.check_jfa_sharded(n, dz, encoding)
    devices = np.asarray(jax.devices()[:dz]).reshape(1, dz)
    occ = jax.ShapeDtypeStruct((n, n, n), jnp.bool_)
    with pytest.raises(ValueError, match=match):
        jfa_sharded(occ, JSpec(n=n, origin=(0.0, 0.0, 0.0), voxel_size=1.0),
                    Mesh(devices, ("d", "z")), encoding=encoding)


@pytest.mark.parametrize("n, dz", [(64, 2), (1024, 8), (2048, 4)])
def test_auto_takes_packed_up_to_1024(n, dz):
    assert SJ.check_jfa_sharded(n, dz) == ("packed" if n <= 1024 else "wide")
