"""voxtpu_torch.parallel.sharded_vox against voxtpu's sharded_vox: the
shard split's arrays, and the assembled grid bitwise voxtpu's
`voxelize_sharded` (conftest's 8 virtual CPU devices) and the port's
single-device plain voxelizer, at n = 32 and 64 on (1, 2), (2, 1),
(1, 4) and (2, 2) with both exchanges. The port's ranks run as gloo
worlds of 2 and 4 CPU processes (`tests/torch_parallel_worker.py`), one
world a size for the whole module."""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from tests.torch_parallel_worker import World
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.vox import FragmentPlan, voxelize
from voxtpu_torch.parallel import sharded_vox as SV

SIZES = (32, 64)
SHAPES = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
CASES = [(n, shape, exchange) for n in SIZES for world in SHAPES for shape in SHAPES[world]
         for exchange in SV.EXCHANGES]


def icosphere():
    coords, faces = procedural.icosphere(2, center=(0.1, -0.2, 0.3))
    return coords.astype(np.float32), faces


def spec_of(n):
    return GridSpec.fit(icosphere()[0], n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    coords, faces = icosphere()
    meshes = {n: (coords, faces, (n, spec_of(n).origin, spec_of(n).voxel_size))
              for n in SIZES}
    worlds = {size: World("vox", size, {"shapes": shapes, "meshes": meshes},
                          tmp_path_factory.mktemp(f"vox{size}"))
              for size, shapes in SHAPES.items()}
    return {size: w.results() for size, w in worlds.items()}


def assembled(results, key, shape):
    """The whole grid from the ranks' slabs; every d row's the same."""
    dd, dz = shape
    rows = [np.concatenate([results[d * dz + z][key] for z in range(dz)]) for d in range(dd)]
    for row in rows[1:]:
        np.testing.assert_array_equal(row, rows[0])
    return rows[0]


def voxtpu_sharded(n, shape, exchange):
    import jax
    from jax.sharding import Mesh as JMesh

    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.mesh.mesh import Mesh as JTri
    from voxtpu.parallel.sharded_vox import voxelize_sharded

    coords, faces = icosphere()
    spec = spec_of(n)
    devices = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    grid = voxelize_sharded(JTri(coords=coords, faces=faces, faces_normals=faces),
                            JSpec(n=n, origin=spec.origin, voxel_size=spec.voxel_size),
                            JMesh(devices, ("d", "z")), exchange=exchange)
    return np.asarray(grid.words)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_split_buckets_are_voxtpus(n_shards):
    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.mesh.mesh import Mesh as JTri
    from voxtpu.ops.vox import FragmentPlan as JPlan
    from voxtpu.parallel.sharded_vox import _split_buckets

    coords, faces = icosphere()
    spec = spec_of(64)
    ours = SV._split_buckets(FragmentPlan(Mesh(name="s", coords=coords, faces=faces,
                                               faces_normals=faces), spec, "cpu"), n_shards)
    theirs = _split_buckets(JPlan(JTri(coords=coords, faces=faces, faces_normals=faces),
                                  JSpec(n=64, origin=spec.origin,
                                        voxel_size=spec.voxel_size)), n_shards)
    assert len(ours) == len(theirs) == n_shards
    for s in range(n_shards):
        carried = interop.vox_shard_from_voxtpu(theirs, s)
        assert len(ours[s]) == len(carried) > 0
        for a, b in zip(ours[s], carried):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        # the port emits the same fragments from voxtpu's rows
        for got, want in zip(SV.local_fragments(carried, spec, "cpu"),
                             SV.local_fragments(ours[s], spec, "cpu")):
            assert torch.equal(got, want)


@pytest.mark.parametrize("n, shape, exchange", CASES)
def test_sharded_grid_is_voxtpus_and_single_device(port, n, shape, exchange):
    got = assembled(port[shape[0] * shape[1]], (n, shape, exchange), shape)
    spec = spec_of(n)
    coords, faces = icosphere()
    single = voxelize(Mesh(name="s", coords=coords, faces=faces, faces_normals=faces), spec,
                      "plain", device="cpu").words
    assert got.dtype == np.int32 and got.shape == (n, n, n // 32)
    np.testing.assert_array_equal(got, single.numpy())
    assert single.any()
    np.testing.assert_array_equal(got.view(np.uint32), voxtpu_sharded(n, shape, exchange))


@pytest.mark.parametrize("n, slab, refused", [(4096, 4096, True), (4096, 2048, False),
                                              (2048, 2048, False)])
def test_slab_key_refusal_is_voxtpus(n, slab, refused):
    """voxtpu's int32 limit on a slab's (cell, word) keys
    (`sharded_vox.py:79-83`), refused before any work."""
    if refused:
        with pytest.raises(ValueError, match="slab cell keys exceed int32 at N=4096"):
            SV.slab_key_limit(n, slab)
    else:
        SV.slab_key_limit(n, slab)
