"""voxtpu_torch's flood-step probe P1 (`ops/jfa_probe.py`) vs voxtpu's
(`scripts/probe_jfa_micro.py`, its Pallas kernel in interpret mode).

The script is loaded from its path. Importing it points JAX's
persistent compilation cache at the home directory; both settings are
put back right after, so that no later test writes a cache. Tolerance:
exact (equal seed grids).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu.ops.jfa import jfa_init_seed as j_init_seed
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.ops import jfa_probe as P
from voxtpu_torch.ops.jfa import jfa_init_seed
from voxtpu_torch.ops.jfa_cuda import flood_step_plain, org_tensor

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_jfa_micro.py"
DYADIC = dict(origin=(0.5, -2.0, 1.25), voxel_size=0.0625)


@pytest.fixture(scope="module")
def probe():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        spec = importlib.util.spec_from_file_location("probe_jfa_micro", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    return module


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_variants_match_voxtpu_probe(probe, n, k):
    """Every variant's plain version against voxtpu's `_step(..., variant)`
    on random 3% seeds; hoist and hoistv also equal B3's plain version."""
    occ = np.random.default_rng(n * 10 + k).random((n, n, n)) < 0.03
    seed = jfa_init_seed(torch.from_numpy(occ))
    org = org_tensor(GridSpec(n=n, **DYADIC), "cpu")
    jseed, jorg = jnp.asarray(seed.numpy()), jnp.asarray(org.numpy())
    b3 = flood_step_plain(seed, org, k)
    for variant in P.VARIANTS:
        got = P.flood_probe(seed, org, k, variant)
        want = np.asarray(probe._step(jseed, jorg, k, n, variant))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=variant)
        if variant in ("legacy", "hoist", "hoistv"):
            assert torch.equal(got, b3), variant
    assert P.flood_probe.launches == 0


def test_rolls_and_alu_differ_from_b3():
    """The two distortions compute other functions (so the probe times
    other work), and on the ball-shell seeds of the runner."""
    n, k = 32, 4
    ax = np.arange(n, dtype=np.float32) - n / 2
    r2 = ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
    seed = jfa_init_seed(torch.from_numpy(r2 <= (0.3 * n) ** 2))
    org = org_tensor(GridSpec(n=n, origin=(0.0,) * 3, voxel_size=1.0 / n), "cpu")
    b3 = flood_step_plain(seed, org, k)
    for variant in ("rolls", "alu"):
        assert not torch.equal(P.flood_probe(seed, org, k, variant), b3), variant


def test_runner_seeds_and_refusal_without_a_card(probe, monkeypatch):
    """The port's runner (`tools/probe_jfa_micro.py`) makes voxtpu's
    ball-shell seeds, and exits 2 without a card, printing no times."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_jfa_micro.py"
    spec = importlib.util.spec_from_file_location("port_probe_jfa_micro", path)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    n = 32
    seed, org = runner.shell_seeds(n, torch.device("cpu"))
    ax = np.arange(n, dtype=np.float32) - n / 2
    r2 = ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
    want = j_init_seed(jnp.asarray(r2 <= (0.3 * n) ** 2))
    np.testing.assert_array_equal(seed.numpy(), np.asarray(want))
    np.testing.assert_array_equal(org.numpy(), np.float32([0, 0, 0, 1 / n]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main() == 2


def test_refusals():
    seed = torch.full((8, 8, 8), -1, dtype=torch.int32)
    org = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown variant"):
        P.flood_probe(seed, org, 1, "dma")
    with pytest.raises(ValueError, match="stride"):
        P.flood_probe(seed, org, 8, "rolls")
    with pytest.raises(TypeError, match="int32"):
        P.flood_probe(seed.long(), org, 1, "alu")
