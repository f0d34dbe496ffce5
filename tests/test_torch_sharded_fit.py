"""voxtpu_torch.parallel's sharded fit engines against voxtpu's: the
shard split; for the plain, cuda and fused engines at n = 32 on a
jittered icosphere(2), on (1, 2) and (2, 2), the loss within 1e-5
relative and the coordinate gradient within 1e-3 x max|g| of voxtpu's
sharded engine of the same kind at the same shape (conftest's 8 virtual
CPU devices, Pallas in interpret mode); the world-2 gradient against
the port's own single-device engine (not scaled by the world size); one
step lowers the loss and leaves every rank the same coordinates; a
state carried from voxtpu's step (`interop`); and the seg engine at
n = 256 on (1, 2) on a jittered icosphere(3) spanning 96 voxels. The port's ranks run as
gloo worlds of 2 and 4 CPU processes (`tests/torch_parallel_worker.py`)."""

import numpy as np
import pytest
import torch

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from tests.torch_parallel_worker import World
from voxtpu_torch import interop
from voxtpu_torch.grids.voxel_grid import GridSpec
from voxtpu_torch.mesh import procedural
from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.ops.soft_vox import make_soft_plan, soft_voxelize
from voxtpu_torch.ops.vox import voxelize
from voxtpu_torch.parallel import sharded_fit as SF

LR = 1e-3
ENGINES = ("plain", "cuda", "fused")
SHAPES = ((1, 2), (2, 2))
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-3
# The seg engine's floor, n = 256; the mesh spans 96 voxels of it, so
# that voxtpu's seg engine in interpret mode takes ~10 s, not ~70.
SEG_N, SEG_SPAN, SEG_SHAPE = 256, 96, (1, 2)


def case(level: int, n: int, span: int | None = None):
    """A jittered icosphere, its hard grid at n (the target) and a start
    half a voxel off along x. The mesh spans the grid, or `span` voxels
    in its middle."""
    c, f = procedural.icosphere(level, center=(0.1, -0.2, 0.3))
    c = (c + np.random.default_rng(3).normal(0, 1e-3, c.shape)).astype(np.float32)
    spec = GridSpec.fit(c, n)
    if span is not None:
        vs = spec.voxel_size * n / span
        spec = GridSpec(n=n, origin=tuple(float(o - (n - span) / 2 * vs) for o in spec.origin),
                        voxel_size=vs)
    mesh = Mesh(name="icosphere", coords=c, faces=f, faces_normals=f)
    target = voxelize(mesh, spec, "plain", device="cpu").to_dense().float().numpy()
    start = (c + np.float32([0.5 * spec.voxel_size, 0.0, 0.0])).astype(np.float32)
    return dict(coords=c, faces=f, spec=(spec.n, spec.origin, spec.voxel_size), pad=1,
                target=target, start=start)


def voxtpu_engine(name, c, shape, soft_plan=None):
    """voxtpu's sharded engine `name` on c's mesh: (init_fn, step_fn,
    loss_fn, target slab)."""
    import jax
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.mesh.mesh import Mesh as JTri
    from voxtpu.ops.soft_vox import make_soft_plan as j_make_soft_plan
    from voxtpu.parallel.sharded_fit import make_sharded_fit
    from voxtpu.parallel.sharded_soft_fused import make_sharded_fit_fused
    from voxtpu.parallel.sharded_soft_pallas import make_sharded_fit_pallas
    from voxtpu.parallel.sharded_soft_seg import make_sharded_fit_seg

    n, origin, vs = c["spec"]
    if soft_plan is None:
        soft_plan = j_make_soft_plan(JTri(coords=c["coords"], faces=c["faces"],
                                          faces_normals=c["faces"]),
                                     JSpec(n=n, origin=origin, voxel_size=vs),
                                     pad_window=c["pad"])
    devices = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    dmesh = JMesh(devices, ("d", "z"))
    target = jax.device_put(c["target"], NamedSharding(dmesh, P("z", None, None)))
    if name == "seg":
        fns = make_sharded_fit_seg(soft_plan, c["start"], dmesh, learning_rate=LR)[:3]
    elif name == "fused":
        # f32 dots, as the port's: the default "exact8" takes the smooth
        # dots in bf16_3x, 6.3e-3 x max|g| off the gradient here.
        fns = make_sharded_fit_fused(soft_plan, dmesh, learning_rate=LR, mode="highest")
    else:
        make = {"plain": make_sharded_fit, "cuda": make_sharded_fit_pallas}[name]
        fns = make(soft_plan, dmesh, learning_rate=LR)
    return (*fns, target)


def voxtpu_value_and_grad(name, c, shape):
    import jax

    init_fn, _, loss_fn, target = voxtpu_engine(name, c, shape)
    coords, _ = init_fn(c["start"])
    loss, grad = jax.value_and_grad(loss_fn)(coords, target)
    return float(loss), np.asarray(grad)


def exact_loss(c, coords, formula: str = "plain") -> float:
    """The soft IoU loss of `coords` evaluated in float64: the plain
    engine's formula (plain, cuda) on float64 coordinates, or the fused
    one (fused, seg: x_hit from the distributed planes P, Q, R) on
    float64 tables, each occupancy rounded to float32 once; float32 cell
    centres and temperatures, as both packages round them; float64
    sums."""
    from voxtpu_torch.ops import soft_vox as S
    from voxtpu_torch.ops import soft_vox_fused as F

    n, origin, vs = c["spec"]
    plan = make_soft_plan(Mesh(name="s", coords=c["coords"], faces=c["faces"],
                               faces_normals=c["faces"]), GridSpec(n, origin, vs),
                          pad_window=c["pad"])
    x = torch.from_numpy(np.asarray(coords)).double()
    with torch.no_grad():
        if formula == "fused":
            fp = F.FusedSoftPlan(plan, "cpu")
            occ = F.fused_fwd_plain(F.tables_of(x, fp), fp.cells_d, fp.tblidx_d,
                                    fp.batch_tile_d, n=n, tc=fp.tc, prm=fp.prm(0.25, 0.5))
        else:
            occ = soft_voxelize(x, plan, tau_edge_frac=0.25, tau_x_frac=0.5, clip=False)
    occ = S.clip01(occ.double()).reshape(n * n, n)
    target = torch.from_numpy(c["target"]).double().view(n * n, n)
    inter = float((occ * target).sum())
    return 1.0 - inter / (float(occ.sum()) + float(target.sum()) - inter + 1e-8)


FORMULA = {"plain": "plain", "cuda": "plain", "fused": "fused", "seg": "fused"}


def hold_loss(loss, voxtpu_loss, exact, single=None):
    """The port's loss within LOSS_RTOL of the float64 loss; voxtpu's
    float32 loss sums on XLA:CPU miss that value by more (1.1e-5 relative
    at n = 32, 1.0e-4 at n = 256 on these meshes), so the port is held
    to voxtpu within voxtpu's own distance from it plus LOSS_RTOL. Where
    the engine's own float32 occupancy misses the float64 loss by more
    (the seg case: the fused formula's planes P, Q, R in float32 put the
    single-device loss 1.8e-5 off), `single` is the port's single-device
    loss: the sharded one is held within LOSS_RTOL of it, and to voxtpu
    within both engines' distances from the float64 loss plus LOSS_RTOL."""
    if single is None:
        assert abs(loss - exact) <= LOSS_RTOL * exact, (loss, exact)
        apart = 0.0
    else:
        assert abs(loss - single) <= LOSS_RTOL * single, (loss, single)
        apart = abs(single - exact)
    assert abs(loss - voxtpu_loss) <= abs(voxtpu_loss - exact) + apart + LOSS_RTOL * exact, (
        loss, voxtpu_loss, exact)


def hold(loss, grad, want_loss, want_grad, exact):
    hold_loss(loss, want_loss, exact)
    scale = np.abs(want_grad).max()
    assert scale > 0
    err = np.abs(grad - want_grad).max()
    assert err <= GRAD_TOL * scale, (err, scale)


@pytest.fixture(scope="module")
def small():
    return case(2, 32)


@pytest.fixture(scope="module")
def carried(small):
    """voxtpu's plain engine on (1, 2) one step in: its state, the loss
    at it and its next step's Adam moments."""
    init_fn, step_fn, loss_fn, target = voxtpu_engine("plain", small, (1, 2))
    coords, opt = init_fn(small["start"])
    coords, opt, _ = step_fn(coords, opt, target)
    state = (np.asarray(coords), np.asarray(opt[0].count), np.asarray(opt[0].mu),
             np.asarray(opt[0].nu))
    _, opt2, loss = step_fn(coords, opt, target)
    return state, float(loss), opt2[0]


@pytest.fixture(scope="module")
def port(small, carried, tmp_path_factory):
    seg = dict(case(3, SEG_N, SEG_SPAN), engines=["seg"], shape=SEG_SHAPE, step=False)
    cases = {2: [dict(small, engines=ENGINES, shape=(1, 2)),
                 dict(small, engines=["plain"], shape=(1, 2), state=carried[0],
                      tag="carried"), seg],
             4: [dict(small, engines=ENGINES, shape=(2, 2))]}
    worlds = {size: World("fit", size, cs, tmp_path_factory.mktemp(f"fit{size}"))
              for size, cs in cases.items()}
    return {size: w.results() for size, w in worlds.items()}, seg


def ranks(port, name, shape, tag=None):
    results = port[0][shape[0] * shape[1]]
    return [r[name, shape, tag] for r in results]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_split_soft_buckets_are_voxtpus(small, n_shards):
    from voxtpu.grids.voxel_grid import GridSpec as JSpec
    from voxtpu.mesh.mesh import Mesh as JTri
    from voxtpu.ops.soft_vox import make_soft_plan as j_make_soft_plan
    from voxtpu.parallel.sharded_fit import _split_soft_buckets

    n, origin, vs = small["spec"]
    mesh = Mesh(name="s", coords=small["coords"], faces=small["faces"],
                faces_normals=small["faces"])
    plan = make_soft_plan(mesh, GridSpec(n, origin, vs))
    ours = SF._split_soft_buckets(plan, n_shards)
    theirs = _split_soft_buckets(
        j_make_soft_plan(JTri(coords=small["coords"], faces=small["faces"],
                              faces_normals=small["faces"]),
                         JSpec(n=n, origin=origin, voxel_size=vs)), n_shards)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, np.asarray(y))
    for s in range(n_shards):
        carried = interop.soft_shard_from_voxtpu(plan, theirs, s)
        own = SF.ShardPlan(plan, [(w, sy[s], sz[s], fi[s]) for w, sy, sz, fi in ours])
        assert carried.num_fragments == own.num_fragments
        for x, y in zip(carried.buckets, own.buckets):
            assert x[0] == y[0]
            for i in (4, 5, 6):
                np.testing.assert_array_equal(x[i], y[i])


@pytest.mark.parametrize("name, shape", [(e, s) for e in ENGINES for s in SHAPES])
def test_engine_is_voxtpus(port, small, name, shape):
    loss, grad = voxtpu_value_and_grad(name, small, shape)
    exact = exact_loss(small, small["start"], FORMULA[name])
    for r in ranks(port, name, shape):
        hold(r["loss"], r["grad"], loss, grad, exact)


@pytest.mark.parametrize("name", ENGINES)
def test_gradient_is_not_scaled_by_the_world(port, small, name):
    """The world-2 loss and gradient against the port's single-device
    engine of the same kind (tau_edge_frac 0.25, voxtpu's sharded
    default)."""
    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox_cuda import SoftCudaPlan, soft_voxelize_cuda
    from voxtpu_torch.ops.soft_vox_fused import FusedSoftPlan, soft_voxelize_fused

    n, origin, vs = small["spec"]
    plan = make_soft_plan(Mesh(name="s", coords=small["coords"], faces=small["faces"],
                               faces_normals=small["faces"]), GridSpec(n, origin, vs))
    fwd = {"plain": lambda x: soft_voxelize(x, plan, tau_edge_frac=0.25),
           "cuda": lambda x: soft_voxelize_cuda(x, SoftCudaPlan(plan, "cpu"),
                                                tau_edge_frac=0.25),
           "fused": lambda x: soft_voxelize_fused(x, FusedSoftPlan(plan, "cpu"),
                                                  tau_edge_frac=0.25)}[name]
    x = torch.from_numpy(small["start"]).requires_grad_(True)
    loss = soft_iou_loss(fwd(x), torch.from_numpy(small["target"]))
    loss.backward()
    for r in ranks(port, name, (1, 2)):
        assert abs(r["loss"] - float(loss)) <= LOSS_RTOL * float(loss)
        scale = np.abs(x.grad.numpy()).max()
        assert np.abs(r["grad"] - x.grad.numpy()).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("name, shape", [(e, s) for e in ENGINES for s in SHAPES])
def test_step_lowers_the_loss_on_equal_ranks(port, name, shape):
    rs = ranks(port, name, shape)
    for r in rs:
        assert r["step_loss"] == r["loss"]
        assert r["loss_after"] < r["step_loss"]
        assert r["count"] == 1.0
        np.testing.assert_array_equal(r["coords"], rs[0]["coords"])
        np.testing.assert_array_equal(r["mu"], rs[0]["mu"])


def test_state_carried_from_voxtpus_step(port, small, carried):
    """voxtpu's (coords, Adam state) after its first step, carried into
    the port (`interop.sharded_fit_state_from_voxtpu`): the port's next
    step sees voxtpu's loss and leaves voxtpu's Adam moments."""
    state, loss, adam = carried
    exact = exact_loss(small, state[0])
    for r in ranks(port, "plain", (1, 2), "carried"):
        hold_loss(r["step_loss"], loss, exact)
        assert r["count"] == int(adam.count) == 2
        for got, want in ((r["mu"], np.asarray(adam.mu)), (r["nu"], np.asarray(adam.nu))):
            assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


def test_seg_engine_is_voxtpus(port):
    """voxtpu's seg engine takes its smooth dots in bf16_3x (its module
    notes): its gradient is 2.9e-3 x max|g| from its own plain sharded
    engine on this mesh. So the port's world-2 gradient is held to
    voxtpu's seg by voxtpu's own rule between its seg engine and an f32
    engine (`tests/test_soft_vox_seg.py:129-130`: 99.9% of the elements
    within 5e-3 x max|g|), and within 1e-3 x max|g| of the port's own
    single-device seg engine; the loss as `hold_loss` says, against the
    fused formula in float64 and the port's single-device seg loss."""
    from voxtpu_torch.models.fit import soft_iou_loss
    from voxtpu_torch.ops.soft_vox_seg import SegSoftPlan, soft_voxelize_seg

    seg = port[1]
    loss, grad = voxtpu_value_and_grad("seg", seg, SEG_SHAPE)
    exact = exact_loss(seg, seg["start"], "fused")
    n, origin, vs = seg["spec"]
    plan = make_soft_plan(Mesh(name="s", coords=seg["coords"], faces=seg["faces"],
                               faces_normals=seg["faces"]), GridSpec(n, origin, vs))
    x = torch.from_numpy(seg["start"]).requires_grad_(True)
    single = soft_iou_loss(soft_voxelize_seg(x, SegSoftPlan(plan, seg["start"], "cpu"),
                                             tau_edge_frac=0.25),
                           torch.from_numpy(seg["target"]))
    single.backward()
    scale = np.abs(grad).max()
    for r in ranks(port, "seg", SEG_SHAPE):
        hold_loss(r["loss"], loss, exact, float(single))
        assert np.mean(np.abs(r["grad"] - grad) <= 5e-3 * scale) >= 0.999
        mine = np.abs(x.grad.numpy()).max()
        assert np.abs(r["grad"] - x.grad.numpy()).max() <= GRAD_TOL * mine
