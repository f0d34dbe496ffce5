"""voxtpu_torch JFA vs voxtpu's Pallas JFA and the NumPy oracle.

voxtpu's Pallas kernels run in interpret mode on the CPU; the port's
wrappers take their plain torch versions for CPU tensors. Tolerance:
exact (equal seeds; SDF bitwise equal, inf == inf).

Geometry: the comparisons with voxtpu use a dyadic origin and voxel
size (voxtpu's own test geometry), where every float operation of the
distance is exact. With other geometry voxtpu on XLA:CPU contracts the
distance's multiply-adds into FMAs and differs from its oracle in the
last bit of most voxels; the port rounds term for term and is held to
the oracle bitwise there too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.ops.jfa import jfa as j_jfa
from voxtpu.ops.jfa import jfa_init_seed as j_init_seed
from voxtpu.ops.jfa_pallas import (_flood_step_pallas, _flood_step_pallas_yblocked,
                                   _flood_step_pipelined, _jfa_pallas,
                                   _sdf_from_seed_pallas)
from voxtpu_torch.grids.voxel_grid import GridSpec, VoxelGrid
from voxtpu_torch.ops.jfa import jfa, jfa_init_seed
from voxtpu_torch.ops import jfa_cuda as J
from voxtpu_torch.ops.jfa_cuda import (flood_step, jfa_cuda, org_tensor,
                                       sdf_from_seed)
from voxtpu_torch.ops.reference import jfa_ref

DYADIC = dict(origin=(0.5, -2.0, 1.25), voxel_size=0.0625)
OTHER = dict(origin=(0.1, -0.23, 0.37), voxel_size=0.0731)


def _ball(n, r=0.35):
    zz, yy, xx = np.indices((n, n, n))
    c = (n - 1) / 2
    return (zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 <= (n * r) ** 2


def _sparse(n, seed, p=0.03):
    return np.random.default_rng(seed).random((n, n, n)) < p


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("occ", [_sparse(32, 1), _ball(32), np.zeros((32,) * 3, bool)],
                         ids=["sparse", "ball", "empty"])
def test_init_seed_matches_voxtpu(occ):
    got = jfa_init_seed(torch.from_numpy(occ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_init_seed(jnp.asarray(occ))))


def test_flood_step_and_final_plain_match_pallas_every_k():
    """B3's plain version against `_flood_step_pallas` at every stride of
    n=32, fed the same seeds each step; then B5's plain version against
    `_sdf_from_seed_pallas`."""
    n = 32
    occ = _sparse(n, 11)
    spec = GridSpec(n=n, **DYADIC)
    org = org_tensor(spec, "cpu")
    jorg = jnp.asarray(org.numpy())
    seed = jfa_init_seed(torch.from_numpy(occ))
    k = n // 2
    while k >= 1:
        got = flood_step(seed, org, k)
        want = np.asarray(_flood_step_pallas(jnp.asarray(seed.numpy()), jorg, k, n))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
        seed = got
        k //= 2
    got = sdf_from_seed(seed, torch.from_numpy(occ), org)
    want = _sdf_from_seed_pallas(jnp.asarray(seed.numpy()), jnp.asarray(occ), jorg, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert flood_step.launches == 0 and sdf_from_seed.launches == 0


def test_flood_rows_plain_matches_yblocked_pallas():
    """B4's plain version against voxtpu's `_flood_step_pallas_yblocked`
    at n=32, band H = 8 and 16, strides 16, 8, 5, 1 (k < H, k = H,
    H | k; voxtpu's own y-blocked test's org), fed the same seeds."""
    n = 32
    occ = np.random.default_rng(19).random((n, n, n)) < 0.03
    org = torch.tensor([0.5, -2.0, 1.25, 0.0625], dtype=torch.float32)
    jorg = jnp.asarray(org.numpy())
    seed = jfa_init_seed(torch.from_numpy(occ))
    for k in (16, 8, 5, 1):
        for band in (8, 16):
            got = J.flood_step_rows(seed, org, k, band)
            want = np.asarray(_flood_step_pallas_yblocked(
                jnp.asarray(seed.numpy()), jorg, k, n, band))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k} H={band}")
        seed = got
    assert J.flood_step_rows.launches == 0


def test_flood_rows_plain_matches_b3_where_voxtpu_asserts():
    """n = 96 with H = 64: voxtpu asserts H | n; the port takes a short
    last band. Every stride of the flood, on non-dyadic geometry."""
    n = 96
    occ = _sparse(n, 2, p=0.01)
    org = org_tensor(GridSpec(n=n, **OTHER), "cpu")
    seed = jfa_init_seed(torch.from_numpy(occ))
    k = n // 2
    while k >= 1:
        got = J.flood_step_rows(seed, org, k, 64)
        assert torch.equal(got, J.flood_step_plain(seed, org, k)), k
        seed = got
        k //= 2


def test_flood_step_routing():
    """B3 up to N = 512, B4 (voxtpu's y-blocked kernel) for 512 < N <=
    1024, as voxtpu's `jfa_pallas` routes; nothing above."""
    for n in (32, 96, 512):
        assert J.flood_step_for(n) is J.flood_step
        assert J.flood_step_for(n, plain=True) is J.flood_step_plain
    for n in (544, 768, 1024):
        assert J.flood_step_for(n) is J.flood_step_rows
        assert J.flood_step_for(n, plain=True) is J.flood_step_rows_plain
    with pytest.raises(ValueError, match="N <= 1024"):
        J.flood_step_for(1056)
    assert J.ROW_BAND == 256


def test_flood_step_pipe_plain_matches_pipelined_pallas():
    """B6's plain version against voxtpu's `_flood_step_pipelined` at
    every stride k | n of n = 32, fed the same seeds each step, and equal
    to B3's plain version there; then the k = 1 step with the signed
    distance (`emit_sdf`) against voxtpu's and against B5 after B3."""
    n = 32
    occ = _sparse(n, 13)
    org = org_tensor(GridSpec(n=n, **DYADIC), "cpu")
    jorg = jnp.asarray(org.numpy())
    seed = jfa_init_seed(torch.from_numpy(occ))
    for k in (16, 8, 4, 2, 1):
        got = J.flood_step_pipe(seed, org, k)
        want = np.asarray(_flood_step_pipelined(jnp.asarray(seed.numpy()), jorg, k, n))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
        assert torch.equal(got, J.flood_step_plain(seed, org, k)), k
        if k > 1:
            seed = got
    occ_t = torch.from_numpy(occ)
    got = J.flood_step_pipe(seed, org, 1, occ_t)
    want = _flood_step_pipelined(jnp.asarray(seed.numpy()), jorg, 1, n,
                                 occ=jnp.asarray(occ), emit_sdf=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    chain = J.sdf_from_seed_plain(J.flood_step_plain(seed, org, 1), occ_t, org)
    np.testing.assert_array_equal(_bits(got), _bits(chain))
    assert J.flood_step_pipe.launches == 0


@pytest.mark.parametrize("n,origin,p", [(32, DYADIC, 0.03), (14, DYADIC, 0.05),
                                        (24, OTHER, 0.03)])
def test_jfa_pipe_matches_voxtpu_pipe_and_oracle(n, origin, p):
    """`jfa(pipe=True)` on the CPU against voxtpu's `_jfa_pallas(pipe=True)`
    (dyadic) and `jfa_ref`; n = 14 sends k = 3 to B3 (3 does not divide
    14), n = 24 k = 3 likewise, on non-dyadic geometry (oracle only)."""
    occ = _sparse(n, n, p)
    spec = GridSpec(n=n, **origin)
    got = jfa(torch.from_numpy(occ), spec, backend="cuda", pipe=True).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jfa_ref(occ, spec)))
    if origin is DYADIC:
        want = _jfa_pallas(jnp.asarray(occ), DYADIC["origin"], DYADIC["voxel_size"], n=n,
                           pipe=True)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pipe_routing_counts_plain_calls(monkeypatch):
    """With pipe, N <= 512 (`FULL_PLANE_MAX_N`): B6 at the strides that
    divide N, B3 at the others, B6 with the signed distance at k = 1 and
    no B5; above it pipe changes nothing. JFA_PIPE=1 selects pipe when
    `pipe` is None, for backend "cuda" only."""
    calls = {}
    for name in ("flood_step_pipe_plain", "flood_step_plain", "flood_step_rows_plain",
                 "sdf_from_seed_plain"):
        def counted(*args, _fn=getattr(J, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(J, name, counted)

    def run(n, **kw):
        calls.clear()
        occ = torch.from_numpy(_sparse(n, 1, 0.05))
        out = jfa(occ, GridSpec(n=n, **OTHER), **kw)
        np.testing.assert_array_equal(_bits(out.numpy()),
                                      _bits(jfa_ref(occ.numpy(), GridSpec(n=n, **OTHER))))
        return dict(calls)

    assert run(32, pipe=True) == {"flood_step_pipe_plain": 5}
    assert run(14, pipe=True) == {"flood_step_pipe_plain": 2, "flood_step_plain": 1}
    assert run(32, pipe=False) == {"flood_step_plain": 5, "sdf_from_seed_plain": 1}
    assert run(32) == {"flood_step_plain": 5, "sdf_from_seed_plain": 1}
    monkeypatch.setenv("JFA_PIPE", "1")
    assert run(32) == {"flood_step_pipe_plain": 5}
    assert run(32, backend="plain") == {"flood_step_plain": 5, "sdf_from_seed_plain": 1}
    monkeypatch.setattr(J, "FULL_PLANE_MAX_N", 16)
    assert run(32, pipe=True) == {"flood_step_rows_plain": 5, "sdf_from_seed_plain": 1}
    assert J.flood_step_pipe.launches == J.flood_step.launches == 0


def test_pipe_refusals():
    occ = torch.zeros((32,) * 3, dtype=torch.bool)
    spec = GridSpec(n=32, origin=(0.0,) * 3, voxel_size=1.0)
    for backend in ("plain", "reference"):
        with pytest.raises(ValueError, match="pipe=True needs backend 'cuda'"):
            jfa(occ, spec, backend=backend, pipe=True)
    seed = torch.full((12, 12, 12), -1, dtype=torch.int32)
    org = torch.zeros(4)
    for k in (5, 12, 0):
        with pytest.raises(ValueError, match="must divide"):
            J.flood_step_pipe(seed, org, k)
    with pytest.raises(TypeError, match="bool"):
        J.flood_step_pipe(seed, org, 1, torch.zeros((12,) * 3, dtype=torch.uint8))
    with pytest.raises(TypeError, match="int32"):
        J.flood_step_pipe(seed.long(), org, 1)


def test_jfa_plain_backend_matches_cuda_backend_and_oracle():
    n = 64
    occ = _ball(n, 0.3) ^ _sparse(n, 9, p=0.005)
    spec = GridSpec(n=n, **OTHER)
    got = jfa(torch.from_numpy(occ), spec, backend="plain").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jfa(torch.from_numpy(occ), spec,
                                                         backend="cuda").numpy()))
    np.testing.assert_array_equal(_bits(got), _bits(jfa_ref(occ, spec)))


@pytest.mark.parametrize("n,occ_fn", [
    (32, lambda n: _sparse(n, 7)),
    (64, _ball),
    (96, lambda n: _sparse(n, 5, p=0.01)),
])
def test_jfa_matches_voxtpu_pallas_and_oracle(n, occ_fn):
    occ = occ_fn(n)
    spec = GridSpec(n=n, **DYADIC)
    got = jfa(torch.from_numpy(occ), spec, backend="cuda").numpy()
    want = np.asarray(j_jfa(occ, JSpec(n, DYADIC["origin"], DYADIC["voxel_size"]),
                            backend="pallas"))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(jfa_ref(occ, spec)))
    assert np.isinf(got).any() == (not occ.any() or np.isinf(want).any())


@pytest.mark.parametrize("n", [32, 64])
def test_jfa_matches_oracle_on_non_dyadic_grid(n):
    occ = _sparse(n, 3)
    spec = GridSpec(n=n, **OTHER)
    got = jfa(torch.from_numpy(occ), spec, backend="cuda").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jfa_ref(occ, spec)))


def test_jfa_from_voxelgrid_and_reference_backend():
    n = 32
    occ = _ball(n, 0.3)
    spec = GridSpec(n=n, **OTHER)
    grid = VoxelGrid.from_dense(torch.from_numpy(occ), spec)
    got = jfa(grid, backend="cuda")
    ref = jfa(grid, backend="reference")
    assert got.dtype == torch.float32 and got.shape == (n, n, n)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref.numpy()))
    assert (got[torch.from_numpy(occ)] >= 0).all()
    assert (got[~torch.from_numpy(occ)] < 0).all()


def test_jfa_rejects_unsupported_requests():
    spec = GridSpec(n=2048, origin=(0.0,) * 3, voxel_size=1.0)
    with pytest.raises(ValueError, match="N <= 1024"):
        jfa_cuda(torch.zeros((2048, 1, 1), dtype=torch.bool), spec)
    with pytest.raises(ValueError, match="unknown backend"):
        jfa(torch.zeros((32,) * 3, dtype=torch.bool),
            GridSpec(n=32, origin=(0.0,) * 3, voxel_size=1.0), backend="xla")
    with pytest.raises(ValueError, match="spec required"):
        jfa(torch.zeros((32,) * 3, dtype=torch.bool))
    seed = torch.zeros((8, 8, 8), dtype=torch.int32)
    org = torch.zeros(4)
    with pytest.raises(ValueError, match="stride"):
        flood_step(seed, org, 8)
    with pytest.raises(TypeError, match="float32"):
        flood_step(seed, org.double(), 1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flood_step(seed.to("meta"), org.to("meta"), 1)
