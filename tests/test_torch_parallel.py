"""voxtpu_torch.parallel's bootstrap, meshes and collectives against
voxtpu/parallel: mesh shapes against voxtpu's `make_mesh` on
conftest's 8 virtual CPU devices; `init_distributed`, `make_mesh`,
`global_from_local` / `local_from_global` and the collectives' autograd
rules in a gloo world of 2 CPU processes (`tests/torch_parallel_worker.py`)."""

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from tests.torch_parallel_worker import World
from voxtpu_torch.parallel.mesh_utils import mesh_shape


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return World("bootstrap", 2, None, tmp_path_factory.mktemp("bootstrap")).results()


@pytest.mark.parametrize("n, grid_axis", [(1, None), (2, None), (4, None), (8, None),
                                          (8, 2), (8, 1)])
def test_mesh_shape_is_voxtpus(n, grid_axis):
    from voxtpu.parallel.mesh_utils import make_mesh

    assert mesh_shape(n, grid_axis) == make_mesh(n, grid_axis).devices.shape


def test_mesh_shape_refuses_an_uneven_grid_axis():
    from voxtpu.parallel.mesh_utils import make_mesh

    with pytest.raises(ValueError, match="not divisible by grid axis"):
        make_mesh(6, grid_axis=4)
    with pytest.raises(ValueError, match="not divisible by grid axis"):
        mesh_shape(6, 4)


def test_init_distributed_is_idempotent(world2):
    assert [r["again"] for r in world2] == [(0, 2), (1, 2)]


def test_make_mesh_spans_the_world(world2):
    for r in world2:
        assert r["mesh_shape"] == (1, 2)
        assert "spans the world of 2 ranks" in r["refused"]


def test_global_from_local_round_trips(world2):
    for rank, r in enumerate(world2):
        assert r["global_shape"] == (4, 3, 4)
        [(index, data)] = r["pairs"]
        assert index == (slice(2 * rank, 2 * rank + 2), slice(0, 3), slice(0, 4))
        np.testing.assert_array_equal(data, r["local"])


def test_collectives_take_voxtpus_transposes(world2):
    """The reduce-scatter's cotangent is the all-gather of the slabs'
    cotangents, and the replicated sum's is passed through once: no
    factor of the world size."""
    x = [np.arange(8.0) + 10 * r for r in range(2)]
    w = [np.arange(4.0) + r for r in range(2)]
    summed = x[0] + x[1]
    total = sum(float(summed[4 * r:4 * r + 4] @ w[r]) for r in range(2))
    for r in world2:
        assert r["total"] == total
        np.testing.assert_array_equal(r["x_grad"], np.concatenate(w))
        assert r["staged"] == 0  # CPU tensors: nothing to stage


@pytest.mark.parametrize("kw, card", [
    (dict(device_count=4, local_device_ids=[2], local_rank=1, process_id=3), 2),
    (dict(device_count=4, local_rank=1, process_id=3), 1),
    (dict(device_count=4, process_id=6), 2),
    (dict(device_count=4), 0),
    (dict(device_count=4, process_id=3, ranks_on_host=4), 3),
    (dict(device_count=1, process_id=1, ranks_on_host=2, backend="gloo"), 0),
    (dict(device_count=1, local_device_ids=(0,), ranks_on_host=2, backend="gloo"), 0),
])
def test_rank_card_takes_the_first_of_ids_local_rank_and_process_id(kw, card):
    from voxtpu_torch.parallel.distributed import rank_card

    assert rank_card(**kw) == card


@pytest.mark.parametrize("kw, match", [
    (dict(device_count=1, process_id=1, ranks_on_host=2), "NCCL takes one card a rank"),
    (dict(device_count=4, local_rank=0, ranks_on_host=8), "NCCL takes one card a rank"),
    (dict(device_count=2, local_device_ids=[2]), "card 2 does not exist"),
    (dict(device_count=2, local_rank=5), "card 5 does not exist"),
    (dict(device_count=4, local_device_ids=[0, 1]), "a rank holds one card"),
    (dict(device_count=0), "no CUDA card"),
])
def test_rank_card_refuses_two_nccl_ranks_on_one_card(kw, match):
    from voxtpu_torch.parallel.distributed import rank_card

    with pytest.raises(ValueError, match=match):
        rank_card(**kw)


def test_rendezvous_on_this_host():
    from voxtpu_torch.parallel.distributed import _on_this_host

    for address in ("file:///tmp/rdv", "tcp://localhost:29500", "tcp://127.0.0.1:1234",
                    "tcp://[::1]:1234"):
        assert _on_this_host(address), address
    for address in (None, "tcp://10.0.0.1:8476", "tcp://node3:29500"):
        assert not _on_this_host(address), address
