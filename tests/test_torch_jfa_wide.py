"""voxtpu_torch's wide (hi, lo) JFA vs voxtpu's wide XLA flood, the
packed flood and the NumPy oracle, on the CPU.

Tolerances: the wide seed init and every flood step bitwise (hi and
lo); the whole wide JFA bitwise against voxtpu's on dyadic geometry
(voxtpu on XLA:CPU contracts the output pass's multiply-adds into FMAs
elsewhere); rtol 1e-6 against `jfa_ref` and rtol 1e-5 against the
packed flood (voxtpu's `tests/test_jfa.py:104-124`: the wide flood
selects by exact integer distance, the packed one by float distance,
so ties may settle on other seeds at the same rounded distance).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu.grids.voxel_grid import GridSpec as JSpec
from voxtpu.ops import jfa as JJ
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops import jfa as W
from voxtpu_torch.ops import jfa_cuda as J
from voxtpu_torch.ops.jfa import jfa, seed_encoding
from voxtpu_torch.ops.reference import jfa_ref

from tests.test_torch_cli import _write_meshes
from tests.test_torch_jfa import DYADIC, _ball, _bits, _sparse

@pytest.mark.parametrize("n,p,seed,z0", [(16, 0.2, 0, 0), (32, 0.03, 1, 0),
                                         (32, 0.5, 2, 0), (16, 0.2, 4, 1040)])
def test_wide_init_matches_voxtpu(n, p, seed, z0):
    occ = _sparse(n, seed, p=p)
    jhi, jlo = JJ.jfa_init_seed_wide(jnp.asarray(occ), z0=z0)
    hi, lo = W.jfa_init_seed_wide(torch.from_numpy(occ), z0=z0)
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("n,p,seed", [(16, 0.2, 0), (32, 0.03, 1), (32, 0.5, 2)])
def test_wide_steps_match_voxtpu_every_k_and_chunk(n, p, seed):
    """Each `_flood_step_seed_wide` at every stride, fed voxtpu's state,
    bitwise voxtpu's in hi and lo, at z-chunks of 1, 3 and n planes."""
    occ = _sparse(n, seed, p=p)
    jhi, jlo = JJ.jfa_init_seed_wide(jnp.asarray(occ))
    jcoords = JJ._int_coords((n, n, n))
    coords = W._int_coords((n, n, n), device="cpu")
    k = n // 2
    while k >= 1:
        want = JJ._flood_step_seed_wide(jhi, jlo, k, n, *jcoords)
        for chunk in (1, 3, n):
            state = interop.wide_seed_from_voxtpu(jhi, jlo, device="cpu")
            hi, lo = W._flood_step_seed_wide(*state, k, n, *coords, chunk=chunk)
            np.testing.assert_array_equal(hi.numpy(), np.asarray(want[0]),
                                          err_msg=f"hi k={k} chunk={chunk}")
            np.testing.assert_array_equal(lo.numpy(), np.asarray(want[1]),
                                          err_msg=f"lo k={k} chunk={chunk}")
        jhi, jlo = want
        k //= 2


@pytest.mark.parametrize("n,occ_fn", [(32, lambda n: _sparse(n, 3, p=0.2)), (32, _ball),
                                      (32, lambda n: _sparse(n, 5, p=0.03))],
                         ids=["random32", "ball32", "sparse32"])
def test_wide_jfa_matches_voxtpu_wide_on_dyadic_geometry(n, occ_fn):
    occ = occ_fn(n)
    spec = GridSpec(n=n, **DYADIC)
    got = jfa(torch.from_numpy(occ), spec, backend="plain", encoding="wide").numpy()
    want = JJ.jfa(jnp.asarray(occ), JSpec(n, DYADIC["origin"], DYADIC["voxel_size"]),
                  backend="xla", encoding="wide")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got[occ] >= 0).all() and (got[~occ] < 0).all()


def test_wide_random_matches_oracle():
    """voxtpu's `test_wide_encoding_random_matches_oracle`."""
    n = 16
    occ = _sparse(n, 3, p=0.2)
    spec = GridSpec(n=n, origin=(0.0, 0.0, 0.0), voxel_size=1.0 / n)
    got = jfa(torch.from_numpy(occ), spec, backend="plain", encoding="wide").numpy()
    np.testing.assert_allclose(got, jfa_ref(occ, spec), rtol=1e-6, atol=0)


def test_wide_matches_packed():
    """voxtpu's `test_wide_encoding_matches_packed`, on the port's packed
    flood (the plain versions and the cuda backend's wrappers)."""
    occ = torch.from_numpy(_ball(32))
    spec = GridSpec(n=32, origin=(0.125, -0.5, 2.0), voxel_size=1.0 / 32)
    wide = jfa(occ, spec, backend="plain", encoding="wide").numpy()
    for backend in ("plain", "cuda"):
        packed = jfa(occ, spec, backend=backend, encoding="packed").numpy()
        np.testing.assert_allclose(wide, packed, rtol=1e-5, atol=0)


@pytest.mark.parametrize("budget", [1, 5 * 16 * 24 * 24, 1 << 30])
def test_wide_budget_sets_chunks_not_results(budget):
    """The byte budget picks the z-chunk of the steps and the output pass
    (1, 5 and all 24 planes here); the field is the same bit for bit."""
    n = 24
    occ = torch.from_numpy(_sparse(n, 8, p=0.05))
    spec = GridSpec(n=n, origin=(0.1, -0.23, 0.37), voxel_size=0.0731)
    got = W.jfa_wide(occ, spec, budget=budget)
    assert W._wide_chunk(n, budget) == {1: 1, 5 * 16 * 24 * 24: 5, 1 << 30: 24}[budget]
    np.testing.assert_array_equal(_bits(got), _bits(W.jfa_wide(occ, spec)))
    assert (got[occ] >= 0).all() and (got[~occ] < 0).all()


def test_wide_fields_hold_large_coordinates():
    """voxtpu's unit check of the 16-bit fields beyond the packed
    encoding's 10-bit range (z, y > 1023), and the sentinel."""
    z, y, x = 2047, 1531, 1789
    hi = torch.full((1,), (z << 16) | y, dtype=torch.int32)
    lo = torch.full((1,), x, dtype=torch.int32)
    org = torch.tensor([0.0, 0.0, 0.0, 0.5])
    zero = torch.zeros(1)
    d2 = W._seed_d2_wide(hi, lo, org, zero, zero, zero)
    want = JJ._seed_d2_wide(jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy()),
                            jnp.zeros(3, jnp.float32), jnp.float32(0.5),
                            jnp.zeros(1), jnp.zeros(1), jnp.zeros(1))
    np.testing.assert_allclose(d2.numpy(), [0.25 * (x * x + y * y + z * z)], rtol=1e-6)
    np.testing.assert_array_equal(_bits(d2), _bits(want))
    sentinel = W._seed_d2_wide(torch.full((1,), -1, dtype=torch.int32), lo, org,
                               zero, zero, zero)
    assert torch.isposinf(sentinel).all()
    # The integer metric at those fields, and its sentinel.
    zz, yy, xx = (torch.zeros((1,), dtype=torch.int32),) * 3
    assert int(W._seed_d2i_wide(hi, lo, zz, yy, xx)) == x * x + y * y + z * z
    assert int(W._seed_d2i_wide(-hi.abs() - 1, lo, zz, yy, xx)) == 2 ** 31 - 1


def test_encoding_refusals():
    """voxtpu's `jfa_xla` refusals (packed above 1024, N > 16384, an
    unknown encoding), checked before any grid is touched; and the
    encodings the cuda route and the oracle cannot honour."""
    occ = torch.zeros((8, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="10-bit"):
        seed_encoding(2048, "packed")
    with pytest.raises(ValueError, match="16384"):
        seed_encoding(16416, "auto", backend="cuda")
    with pytest.raises(ValueError, match="16384"):
        seed_encoding(16416, "wide")
    for backend in ("plain", "cuda"):
        with pytest.raises(ValueError, match="unknown encoding"):
            jfa(occ, GridSpec(n=8, origin=(0.0,) * 3, voxel_size=1.0), backend=backend,
                encoding="wde")
    with pytest.raises(ValueError, match="needs backend='plain'"):
        jfa(occ, GridSpec(n=8, origin=(0.0,) * 3, voxel_size=1.0), backend="cuda",
            encoding="wide")
    with pytest.raises(ValueError, match="no seed encoding"):
        jfa(occ, GridSpec(n=8, origin=(0.0,) * 3, voxel_size=1.0), backend="reference",
            encoding="packed")
    with pytest.raises(ValueError, match="does not match"):
        J.jfa_plain(occ, GridSpec(n=2048, origin=(0.0,) * 3, voxel_size=1.0))
    with pytest.raises(ValueError, match="bool grid"):
        W.jfa_wide(occ.to(torch.uint8), GridSpec(n=8, origin=(0.0,) * 3, voxel_size=1.0))
    # `flood_step_for` and the packed kernels' seed check keep refusing N > 1024.
    with pytest.raises(ValueError, match="N <= 1024"):
        J.flood_step_for(2048)


@pytest.mark.parametrize("n,backend,encoding,route", [
    (512, "cuda", "auto", "packed"),
    (512, "cuda", "packed", "packed"),
    (512, "plain", "auto", "packed"),
    (512, "plain", "wide", "wide"),
    (2048, "cuda", "auto", "wide"),
    (2048, "cuda", "wide", "wide"),
    (2048, "plain", "auto", "wide"),
    (2048, "plain", "wide", "wide"),
])
def test_flood_routing_without_a_flood(monkeypatch, n, backend, encoding, route):
    """Which flood `jfa` takes, on a meta grid (no memory, no flood):
    `"auto"` and the cuda route go wide above 1024 only; the plain route
    honours `encoding` at any N."""
    taken = []

    def wide(occ, spec):
        taken.append("wide")
        return occ

    def packed(n, *, plain=False):
        taken.append("packed")
        raise LookupError("packed route")

    monkeypatch.setattr(J, "jfa_wide", wide)
    monkeypatch.setattr(J, "flood_step_for", packed)
    occ = torch.empty((n, n, n), dtype=torch.bool, device="meta")
    spec = GridSpec(n=n, origin=(0.0,) * 3, voxel_size=1.0)
    try:
        jfa(occ, spec, backend=backend, encoding=encoding)
    except LookupError:
        pass
    assert taken == [route]
    assert seed_encoding(n, encoding, backend=backend) == route
    assert W._use_stepped_xla(n, encoding) == (n > 1024)


def test_cli_takes_the_wide_flood_above_the_packed_limit(monkeypatch, tmp_path, capsys):
    """The CLI's -t 2 -s with the packed limit lowered to 16 (as N = 1280
    meets 1024): the SDF of the folded grid comes from the wide flood,
    the `[CudaJFA::wide]` scope says so, and no packed step runs."""
    from voxtpu_torch import cli

    paths = _write_meshes(tmp_path)
    argv = [*paths, "-n", "32", "-t", "2", "-p", "1", "-s", "--device", "cpu"]
    packed = cli.run(argv)
    assert "[CudaJFA::wide]" not in capsys.readouterr().out

    def no_packed_step(n, *, plain=False):
        raise AssertionError("a packed flood step ran")

    monkeypatch.setattr(W, "_MAX_PACKED_N", 16)
    monkeypatch.setattr(J, "flood_step_for", no_packed_step)
    wide = cli.run(argv)
    assert re.search(r"\[CudaJFA::wide\]: [\d.]+ ms\n\[CudaJFA\]: [\d.]+ ms",
                     capsys.readouterr().out)
    assert torch.equal(wide.grids[0].words, packed.grids[0].words)
    occ = wide.grids[0].to_dense()
    want = W.jfa_wide(occ, wide.spec)
    np.testing.assert_array_equal(_bits(wide.sdf), _bits(want))
    np.testing.assert_allclose(wide.sdf.numpy(), packed.sdf.numpy(), rtol=1e-5, atol=0)
