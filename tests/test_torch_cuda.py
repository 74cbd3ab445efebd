"""Card-only tests of the port's CUDA kernels (marker ``cuda``), and of
the exact xla path on the card (bitwise forces, the pallas kernels'
function, the neighbour gather's backward).

Each kernel (Chebyshev with the per-block combined backward, its
periodic-cell variants and its bf16x3 tier, dense and neighbour-matrix
CFConv; the tensor-core kernels also on ragged sizes and on positions
with dead, live and clustered pairs) against its plain PyTorch twin on
the card (at bf16x3 also nearer that twin than the fp32 one), the launch
counters on the paths
and on both cheb schedules (also under each radial-basis envelope), bitwise reproducibility, the wrappers'
refusals and that the per-block schedule never takes a twin. Without a
card every test skips (decided in a fixture, so every xdist worker
collects the same tests). On the GPU machine, which has no
JAX, run them without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports no JAX.
"""

import pytest
import torch

from flashmd_tpu_torch.ops import cfconv as cf
from flashmd_tpu_torch.ops import cfconv_dense as cd
from flashmd_tpu_torch.ops import cheb_kernel as ck
from flashmd_tpu_torch.ops.neighborlist import batched_radius_neighbor_matrix

pytestmark = pytest.mark.cuda

RCUT = 10.0
# max|kernel - plain| / max|plain|, as chip_smoke.py: the JAX suite's fp32
# kernel tolerances; bf16 differs only by summation order and recurrence
# ulps; bf16x3 by those and the order of its three bf16 products, near
# float32, held to the fp32 backward tolerance.
BOUNDS = {"fp32": {"fwd": 1e-5, "bwd": 1e-4},
          "bf16": {"fwd": 2e-3, "bwd": 2e-3},
          "bf16x3": {"fwd": 1e-4, "bwd": 1e-4}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, s, a, f, m1, m2, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    # positions spread so that some pairs fall inside the cutoff, some out
    pos = randn(s, a, 3, scale=6.0)
    return {
        "pos": pos, "x": randn(s, a, f), "g": randn(s, a, f),
        "c": randn(m1, f, scale=1.0 / m1), "c2": randn(m2, f, scale=1.0 / m2),
        "w0": randn(f),
    }


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _fp32(args):
    """The argument tuple with its precision replaced by "fp32"."""
    return tuple("fp32" if isinstance(v, str) else v for v in args)


def _takes_splits(k, ref, fp32_ref):
    """The bf16x3 kernel output lies nearer its bf16x3 twin than the fp32
    twin on the same inputs (Frobenius norms): the 1e-4 bound alone would
    also pass a kernel that skipped the hi/lo splits."""
    return bool(torch.linalg.norm(k - ref) < torch.linalg.norm(k - fp32_ref))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("a,f", [(70, 128), (33, 48)])
def test_kernels_match_twins(dev, precision, d_min, a, f):
    t = _inputs(dev, 3, a, f, 12, 16)
    w_lin = None
    if d_min > 0:
        from flashmd_tpu_torch.models.cheb import _lin_slope

        w_lin = _lin_slope(t["c2"])
    args = (t["pos"], t["x"], RCUT, precision, d_min, w_lin)
    out = ck.cheb_conv_fwd(t["c"], t["w0"], *args)
    ref = ck.cheb_conv_fwd_plain(t["c"], t["w0"], *args)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    x3 = precision == "bf16x3"
    assert not x3 or _takes_splits(
        out, ref, ck.cheb_conv_fwd_plain(t["c"], t["w0"], *_fp32(args)))
    args = (t["pos"], t["g"], RCUT, precision, d_min, w_lin)
    gx = ck.cheb_conv_bwd_gx(t["c"], t["w0"], *args)
    gx_ref = ck.cheb_conv_bwd_gx_plain(t["c"], t["w0"], *args)
    assert _rel(gx, gx_ref) <= BOUNDS[precision]["bwd"]
    assert not x3 or _takes_splits(
        gx, gx_ref, ck.cheb_conv_bwd_gx_plain(t["c"], t["w0"], *_fp32(args)))
    args = (t["c2"], t["pos"], t["x"], t["g"], RCUT, precision, d_min)
    gpos = ck.cheb_conv_bwd_gd(*args)
    gpos_ref = ck.cheb_conv_bwd_gd_plain(*args)
    torch.cuda.synchronize()
    assert _rel(gpos, gpos_ref) <= BOUNDS[precision]["bwd"]
    assert not x3 or _takes_splits(
        gpos, gpos_ref, ck.cheb_conv_bwd_gd_plain(*_fp32(args)))


# rows = lattice vectors; widths > 2 RCUT, so the minimum image is sound
CELL_CUBIC = [[24.0, 0.0, 0.0], [0.0, 24.0, 0.0], [0.0, 0.0, 24.0]]
CELL_TRICLINIC = [[24.0, 0.0, 0.0], [4.0, 24.0, 0.0], [2.0, 2.0, 24.0]]


def _cells(dev, s):
    """Per-molecule cells, cubic and triclinic in turn, [S, 3, 3]."""
    return torch.tensor([(CELL_CUBIC, CELL_TRICLINIC)[i % 2]
                         for i in range(s)], device=dev)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("a,f", [(70, 128), (33, 48)])
def test_cell_kernels_match_twins(dev, precision, d_min, a, f):
    """The three cell variants on positions folded into [0, 24)^3, where
    many pairs within the cutoff cross a face."""
    t = _inputs(dev, 3, a, f, 12, 16)
    pos = torch.remainder(t["pos"], 24.0)
    cell = _cells(dev, 3)
    w_lin = None
    if d_min > 0:
        from flashmd_tpu_torch.models.cheb import _lin_slope

        w_lin = _lin_slope(t["c2"])
    args = (pos, t["x"], RCUT, precision, d_min, w_lin)
    out = ck.cheb_conv_fwd(t["c"], t["w0"], *args, cell=cell)
    ref = ck.cheb_conv_fwd_plain(t["c"], t["w0"], *args, cell=cell)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    x3 = precision == "bf16x3"
    assert not x3 or _takes_splits(out, ref, ck.cheb_conv_fwd_plain(
        t["c"], t["w0"], *_fp32(args), cell=cell))
    open_ = ck.cheb_conv_fwd_plain(t["c"], t["w0"], *args)
    assert _rel(open_, ref) > 1e-2  # the cell changes the answer
    args = (pos, t["g"], RCUT, precision, d_min, w_lin)
    gx = ck.cheb_conv_bwd_gx(t["c"], t["w0"], *args, cell=cell)
    gx_ref = ck.cheb_conv_bwd_gx_plain(t["c"], t["w0"], *args, cell=cell)
    assert _rel(gx, gx_ref) <= BOUNDS[precision]["bwd"]
    assert not x3 or _takes_splits(gx, gx_ref, ck.cheb_conv_bwd_gx_plain(
        t["c"], t["w0"], *_fp32(args), cell=cell))
    args = (t["c2"], pos, t["x"], t["g"], RCUT, precision, d_min)
    gpos = ck.cheb_conv_bwd_gd(*args, cell=cell)
    gpos_ref = ck.cheb_conv_bwd_gd_plain(*args, cell=cell)
    torch.cuda.synchronize()
    assert _rel(gpos, gpos_ref) <= BOUNDS[precision]["bwd"]
    assert not x3 or _takes_splits(
        gpos, gpos_ref, ck.cheb_conv_bwd_gd_plain(*_fp32(args), cell=cell))


def test_cell_gd_bitwise_reproducible(dev):
    t = _inputs(dev, 2, 90, 64, 8, 16, seed=1)
    args = (t["c2"], torch.remainder(t["pos"], 24.0), t["x"], t["g"], RCUT,
            "bf16", 2.0)
    cell = _cells(dev, 2)
    first = ck.cheb_conv_bwd_gd(*args, cell=cell)
    for _ in range(3):
        assert torch.equal(ck.cheb_conv_bwd_gd(*args, cell=cell), first)


def test_cell_launch_counts(dev):
    """A periodic force evaluation of a 3-block cheb model launches the
    cell variants 3/2/1 times and the open ones never, in
    compute_energy_forces and in a short simulation; the forces agree
    with the CPU plain path."""
    import dataclasses

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    results = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                      message_passing="cheb", device=device)
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                      ff.schnet_config))
        system = collate(cfgs, device=device)
        ck.reset_launch_counts()
        _, forces, _ = compute_energy_forces(
            ff, system.pos, system.atom_types,
            cell=_cells(device, 2) * (25.0 / 24.0),
        )
        results[device.type] = (forces.cpu(), ck.launch_counts())
    zero = dict.fromkeys(ck.launch_counts(), 0)
    assert results["cuda"][1] == {**zero, "cheb_fwd_cell": 3,
                                  "cheb_bwd_gx_cell": 2,
                                  "cheb_bwd_gd_cell": 1}
    assert all(v == 0 for v in results["cpu"][1].values())
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(results["cuda"][0], results["cpu"][0]) <= 2e-3

    ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                  message_passing="cheb", device=dev)
    cfgs = [dataclasses.replace(c, cell=[[25.0, 0, 0], [0, 25.0, 0],
                                         [0, 0, 25.0]]) for c in cfgs]
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device=dev)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    ck.reset_launch_counts()
    coords = sim.simulate()
    assert ck.launch_counts() == {**zero, "cheb_fwd_cell": 15,
                                  "cheb_bwd_gx_cell": 10,
                                  "cheb_bwd_gd_cell": 5}
    assert torch.isfinite(torch.as_tensor(coords)).all()


def test_gd_bitwise_reproducible(dev):
    t = _inputs(dev, 2, 90, 64, 8, 16, seed=1)
    args = (t["c2"], t["pos"], t["x"], t["g"], RCUT, "bf16", 2.0)
    first = ck.cheb_conv_bwd_gd(*args)
    for _ in range(3):
        assert torch.equal(ck.cheb_conv_bwd_gd(*args), first)


# The tensor-core gd kernel (bf16, bf16x3): 16 x 8 pair fragments, dead
# ones skipped. Ragged atom counts (not multiples of 16 or 8), feature
# widths (not multiples of 16), order counts down to 1.
GD_ATOMS = [1, 7, 17, 63, 65, 266]
GD_FEATURES = [16, 50, 128, 384]
GD_ORDERS = [1, 2, 64]
# a cell wide enough for the layouts below (minimum image sound)
CELL_WIDE = [[100.0, 0.0, 0.0], [10.0, 100.0, 0.0], [5.0, 5.0, 100.0]]


def _gd_check(pos, x, g, c2, precision, cell=None):
    """The gd kernel vs its twin: 2e-3 (bf16) or 1e-4 and nearer the bf16x3
    twin than the fp32 one (bf16x3) of max|twin|; exactly zero where the
    twin is (no live pair)."""
    args = (c2, pos, x, g, RCUT, precision, 2.0)
    gpos = ck.cheb_conv_bwd_gd(*args, cell=cell)
    ref = ck.cheb_conv_bwd_gd_plain(*args, cell=cell)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(gpos).all())
    if float(ref.abs().max()) == 0.0:
        assert float(gpos.abs().max()) == 0.0
        return
    assert _rel(gpos, ref) <= BOUNDS[precision]["bwd"]
    if precision == "bf16x3":
        assert _takes_splits(gpos, ref, ck.cheb_conv_bwd_gd_plain(
            *_fp32(args), cell=cell))


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m", GD_ORDERS)
@pytest.mark.parametrize("f", GD_FEATURES)
@pytest.mark.parametrize("a", GD_ATOMS)
def test_gd_tensor_core_kernel_matches_twin(dev, a, f, m, periodic,
                                            precision):
    t = _inputs(dev, 2, a, f, 1, m, seed=a * 1000 + f + m)
    pos, cell = t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    _gd_check(pos, t["x"], t["g"], t["c2"], precision, cell)


def _gd_layout(dev, s, a, layout, seed):
    """Positions [S, A, 3] inside [5, 95)^3: "clusters", two compact
    clusters 3 RCUT apart (dead fragments beside live ones); "none", a
    grid of spacing 1.2 RCUT (no pair within the cutoff); "compact", all
    in a 5 A cube (every fragment live)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "clusters":
        pos = 1.5 * torch.randn(s, a, 3, generator=gen, device=dev)
        pos[:, a // 2:, 0] += 3 * RCUT
    elif layout == "none":
        i = torch.arange(a, device=dev)
        grid = torch.stack([i % 7, (i // 7) % 7, i // 49], dim=-1)
        pos = (1.2 * RCUT * grid.float()).expand(s, a, 3).contiguous()
    else:
        pos = 5.0 * torch.rand(s, a, 3, generator=gen, device=dev)
    return pos + 10.0


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("layout", ["clusters", "none", "compact"])
@pytest.mark.parametrize("a", [63, 266])
def test_gd_tensor_core_kernel_layouts(dev, a, layout, periodic, precision):
    t = _inputs(dev, 2, a, 128, 1, 64, seed=a + 7)
    pos = _gd_layout(dev, 2, a, layout, seed=a + 8)
    cell = None
    if periodic:
        cell = torch.tensor([CELL_WIDE] * 2, device=dev)
    if layout == "none":
        gpos = ck.cheb_conv_bwd_gd(t["c2"], pos, t["x"], t["g"], RCUT,
                                   precision, 2.0, cell=cell)
        assert torch.equal(gpos, torch.zeros_like(gpos))
    _gd_check(pos, t["x"], t["g"], t["c2"], precision, cell)


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
def test_gd_tensor_core_bitwise_reproducible(dev, precision, periodic):
    """Two launches at the stacked slice's widths give identical gpos."""
    t = _inputs(dev, 3, 266, 384, 1, 64, seed=2)
    pos, cell = 3.0 * t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 3)
    args = (t["c2"], pos, t["x"], t["g"], RCUT, precision, 2.0)
    first = ck.cheb_conv_bwd_gd(*args, cell=cell)
    for _ in range(2):
        assert torch.equal(ck.cheb_conv_bwd_gd(*args, cell=cell), first)


# The tensor-core fwd/gx kernel (bf16, bf16x3): 16 x 16 pair fragments,
# those with z == 1 on every pair skipped, the linear term only where low
# != 0. Ragged atom counts (not multiples of 16) and feature widths (not
# multiples of 64), one order and an odd count.
ROWS_ATOMS = [33, 70, 266]
ROWS_FEATURES = [48, 128]
ROWS_ORDERS = [1, 12]


def _rows_check(c, w0, pos, x, d_min, precision, cell=None):
    """cheb_fwd and cheb_bwd_gx vs their twins: 2e-3 (bf16) or 1e-4 and
    nearer the bf16x3 twin than the fp32 one (bf16x3) of max|twin|; two
    launches bitwise equal."""
    from flashmd_tpu_torch.models.cheb import _lin_slope

    w_lin = _lin_slope(c) if d_min > 0 else None
    args = (c, w0, pos, x, RCUT, precision, d_min, w_lin)
    for kern, plain, bound in (
            (ck.cheb_conv_fwd, ck.cheb_conv_fwd_plain, "fwd"),
            (ck.cheb_conv_bwd_gx, ck.cheb_conv_bwd_gx_plain, "bwd")):
        out = kern(*args, cell=cell)
        again = kern(*args, cell=cell)
        ref = plain(*args, cell=cell)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, again)
        assert _rel(out, ref) <= BOUNDS[precision][bound]
        if precision == "bf16x3":
            assert _takes_splits(out, ref, plain(*_fp32(args), cell=cell))


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("m", ROWS_ORDERS)
@pytest.mark.parametrize("f", ROWS_FEATURES)
@pytest.mark.parametrize("a", ROWS_ATOMS)
def test_rows_tensor_core_kernel_matches_twin(dev, a, f, m, periodic,
                                              precision):
    """d_min 2.0 on positions spread at 6 A: pairs below it exist, so the
    linear term runs."""
    t = _inputs(dev, 2, a, f, m, 1, seed=a * 1000 + f + m)
    pos, cell = t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    d, _ = ck.pair_geometry(pos, RCUT, 2.0, cell)
    eye = torch.eye(a, dtype=torch.bool, device=dev)
    assert bool(((d < 2.0) & ~eye).any())
    _rows_check(t["c"], t["w0"], pos, t["x"], 2.0, precision, cell)


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("layout", ["clusters", "none", "compact"])
@pytest.mark.parametrize("a", [63, 266])
def test_rows_tensor_core_kernel_layouts(dev, a, layout, periodic,
                                         precision):
    """Dead fragments beside live ones, only the diagonal's fragments
    live, every fragment live; at the slice's width and orders."""
    t = _inputs(dev, 2, a, 128, 48, 1, seed=a + 9)
    pos = _gd_layout(dev, 2, a, layout, seed=a + 10)
    cell = None
    if periodic:
        cell = torch.tensor([CELL_WIDE] * 2, device=dev)
    for d_min in (0.0, 2.0):
        _rows_check(t["c"], t["w0"], pos, t["x"], d_min, precision, cell)


# The fp32 CUDA-core kernels of cheb_fwd, cheb_bwd_gx and cheb_bwd_gd:
# live pairs only, compacted per row (z != 1 for fwd/gx, d < rcut off the
# diagonal for gd). Ragged atom counts and feature widths (45 x 20, and 70
# x 45, not a multiple of 4: the scalar loads), a few orders and the fp32
# zoo's 128; gd stacked over three blocks and on one block's features.
FP32_SHAPES = [(45, 20), (70, 45)]
FP32_ORDERS = [8, 128]


def _cpu(args):
    return tuple(v.cpu() if torch.is_tensor(v) else v for v in args)


def _fp32_check(t, pos, cell, d_min):
    """fwd and gx within 1e-5 and 1e-4 of max|twin|, gd (stacked over
    three blocks' features and one block's) within 1e-4, exactly zero
    where the twin is; each two launches bitwise equal. The twins run on
    the CPU: the kernels round the pair geometry and the forward's
    recurrence as the twins do there, and on the card the twins' torch.sum
    adds the squared components in another order, which at order 128
    moves the basis near z = +-1 by as much as the forward's bound."""
    from flashmd_tpu_torch.models.cheb import _lin_slope

    w_lin = _lin_slope(t["c2"]) if d_min > 0 else None
    stacked = [torch.cat([t[k]] * 3, dim=-1).contiguous()
               for k in ("x", "g", "c2")]
    calls = [
        (ck.cheb_conv_fwd, ck.cheb_conv_fwd_plain, "fwd",
         (t["c"], t["w0"], pos, t["x"], RCUT, "fp32", d_min, w_lin)),
        (ck.cheb_conv_bwd_gx, ck.cheb_conv_bwd_gx_plain, "bwd",
         (t["c"], t["w0"], pos, t["g"], RCUT, "fp32", d_min, w_lin)),
        (ck.cheb_conv_bwd_gd, ck.cheb_conv_bwd_gd_plain, "bwd",
         (t["c2"], pos, t["x"], t["g"], RCUT, "fp32", d_min)),
        (ck.cheb_conv_bwd_gd, ck.cheb_conv_bwd_gd_plain, "bwd",
         (stacked[2], pos, stacked[0], stacked[1], RCUT, "fp32", d_min)),
    ]
    for kern, plain, bound, args in calls:
        out = kern(*args, cell=cell)
        again = kern(*args, cell=cell)
        ref = plain(*_cpu(args), cell=None if cell is None else cell.cpu())
        torch.cuda.synchronize()
        out, again = out.cpu(), again.cpu()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, again)
        if float(ref.abs().max()) == 0.0:
            assert float(out.abs().max()) == 0.0
            continue
        assert _rel(out, ref) <= BOUNDS["fp32"][bound]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("layout", ["spread", "clusters", "none", "compact"])
@pytest.mark.parametrize("m", FP32_ORDERS)
@pytest.mark.parametrize("a,f", FP32_SHAPES)
def test_fp32_live_pair_kernels_match_twins(dev, a, f, m, layout, periodic):
    """Positions spread at 6 A (pairs below d_min 2.0: the linear term), in
    two clusters (rows whose pairs are all dead beside mixed ones), on a
    grid beyond the cutoff (only the diagonal live: gd exactly zero) or
    compact (every pair live); open and under cells; d_min 0 and 2."""
    t = _inputs(dev, 2, a, f, m, m, seed=a * 1000 + f + m)
    cell = None
    if layout == "spread":
        pos = t["pos"]
        if periodic:
            pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    else:
        pos = _gd_layout(dev, 2, a, layout, seed=a + m)
        if periodic:
            cell = torch.tensor([CELL_WIDE] * 2, device=dev)
    for d_min in (0.0, 2.0):
        _fp32_check(t, pos, cell, d_min)


@pytest.mark.parametrize("periodic", [False, True])
def test_fp32_live_pair_kernels_at_the_slice_widths(dev, periodic):
    """266 beads, F = 128 (gd also stacked to 384), the fp32 zoo's 128
    orders, positions spread so that most pairs are dead."""
    t = _inputs(dev, 2, 266, 128, 128, 128, seed=3)
    pos, cell = 3.0 * t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    _fp32_check(t, pos, cell, 0.0)


def test_fp32_step_loop_makes_no_host_sync(dev):
    """Five BAOAB steps of a 3-block fp32 cheb field under
    ``torch.cuda.set_sync_debug_mode("error")``: the live-pair kernels
    compact their pairs on the card, so nothing in a step waits for it;
    the steps launch 3/2/1 per force evaluation on the fp32 counters."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    ff, cfgs = cgschnet_1enh_like(n_atoms=45, batch_size=2,
                                  precision="fp32", message_passing="cheb",
                                  device=dev)
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device=dev,
                             gptq=None)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    sim.simulate()  # builds the kernels, warms the allocator
    gen = torch.Generator(device=dev).manual_seed(7)
    carry, first = sim.final_carry, sim.n_timesteps
    draws = [sim._step_draws(gen, first + i) for i in range(5)]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for i, (xi, u) in enumerate(draws):
                carry = sim._step_with_hooks(carry, xi, first + i, u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ck.launch_counts() == {**dict.fromkeys(ck.launch_counts(), 0),
                                  "cheb_fwd_fp32": 15,
                                  "cheb_bwd_gx_fp32": 10,
                                  "cheb_bwd_gd_fp32": 5}
    assert bool(torch.isfinite(carry["pos"]).all())


def test_wrappers_refuse_what_kernels_do_not_take(dev):
    t = _inputs(dev, 2, 20, 16, 8, 8)
    with pytest.raises(ValueError):
        ck.cheb_conv_fwd(t["c"], t["w0"], t["pos"], t["x"].transpose(1, 2)
                         .contiguous().transpose(1, 2), RCUT, "fp32")
    with pytest.raises(ValueError):
        ck.cheb_conv_fwd(t["c"], t["w0"], t["pos"].double(), t["x"], RCUT,
                         "fp32")
    with pytest.raises(ValueError):
        ck.cheb_conv_fwd(t["c"], t["w0"], t["pos"], t["x"].cpu(), RCUT,
                         "fp32")
    with pytest.raises(ValueError):
        ck.cheb_conv_fwd(t["c"], t["w0"], t["pos"], t["x"], RCUT, "fp16")


def test_main_path_launch_counts(dev):
    """3 cheb_fwd + 2 cheb_bwd_gx + 1 cheb_bwd_gd per force evaluation of
    a 3-block model; the forces agree with the CPU plain path."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    results = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                      message_passing="cheb", device=device)
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                      ff.schnet_config))
        system = collate(cfgs, device=device)
        ck.reset_launch_counts()
        for _ in range(2):
            _, forces, _ = compute_energy_forces(ff, system.pos,
                                                 system.atom_types)
        results[device.type] = (forces.cpu(), ck.launch_counts())
    assert results["cuda"][1] == {**dict.fromkeys(ck.launch_counts(), 0),
                                  "cheb_fwd": 6, "cheb_bwd_gx": 4,
                                  "cheb_bwd_gd": 2}
    assert all(v == 0 for v in results["cpu"][1].values())
    f_k, f_p = results["cuda"][0], results["cpu"][0]
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(f_k, f_p) <= 2e-3


def test_in_graph_fit_card_matches_cpu(dev):
    """The in-graph Chebyshev fit runs on the card when the parameters are
    there: each block's c, c2, w0 within 1e-5 of the same fit on the CPU
    (float32 transcendentals and summation order) and within 1e-4 of the
    float64 host fit; a field with no fit attached launches 3/2/1 per
    force evaluation and its forces agree with the CPU's."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import (
        fit_chebyshev_filter,
        fit_chebyshev_filter_host,
    )
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    fits, forces, counts = {}, {}, {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                      message_passing="cheb", device=device)
        cfg, params = ff.schnet_config, ff.schnet_params
        fits[device.type] = [
            fit_chebyshev_filter(bp, params["rbf"], cfg, cfg.cheb_order,
                                 order_deriv=cfg.cheb_order_deriv)
            for bp in params["interactions"]
        ]
        system = collate(cfgs, device=device)
        ck.reset_launch_counts()
        forces[device.type] = compute_energy_forces(
            ff, system.pos, system.atom_types)[1].cpu()
        counts[device.type] = ck.launch_counts()
    host = [fit_chebyshev_filter_host(bp, params["rbf"], cfg,
                                      cfg.cheb_order,
                                      order_deriv=cfg.cheb_order_deriv)
            for bp in params["interactions"]]
    for card, cpu, ref in zip(fits["cuda"], fits["cpu"], host):
        for k, p, h in zip(card, cpu, ref):
            assert k.device.type == "cuda" and k.dtype == torch.float32
            assert _rel(k.cpu(), p) <= 1e-5
            assert _rel(k.cpu(), h) <= 1e-4
    assert counts["cuda"] == {**dict.fromkeys(ck.launch_counts(), 0),
                              "cheb_fwd": 3, "cheb_bwd_gx": 2,
                              "cheb_bwd_gd": 1}
    assert all(v == 0 for v in counts["cpu"].values())  # twins only
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(forces["cuda"], forces["cpu"]) <= 2e-3


ENVELOPES = ("IdentityCutoff(0, rc)", "CosineCutoff(0, rc - 1)",
             "CosineCutoff(1, rc)", "ShiftedCosineCutoff(0, rc, 0.5)")


def _envelope(name, rcut):
    from flashmd_tpu_torch.models.cutoff import (
        CosineCutoff,
        IdentityCutoff,
        ShiftedCosineCutoff,
    )

    return {"IdentityCutoff(0, rc)": IdentityCutoff(0.0, rcut),
            "CosineCutoff(0, rc - 1)": CosineCutoff(0.0, rcut - 1.0),
            "CosineCutoff(1, rc)": CosineCutoff(1.0, rcut),
            "ShiftedCosineCutoff(0, rc, 0.5)": ShiftedCosineCutoff(
                0.0, rcut, 0.5)}[name]


@pytest.mark.parametrize("schedule", ["1", "0"], ids=["stacked",
                                                      "per-block"])
@pytest.mark.parametrize("envelope", ENVELOPES)
def test_cheb_basis_envelope_card_matches_cpu(dev, monkeypatch, envelope,
                                              schedule):
    """The cheb path under each radial-basis envelope the reference's cheb
    path takes: the host fit attached on the card and on the CPU, forces
    card vs CPU within 1e-4 of max|F| at fp32 and 2e-3 at bf16, and the
    launches of one force evaluation: 3/2/1 of fwd/gx/gd stacked, 3/2/1 of
    fwd/gxgd/gd per block (on the fp32 counters at fp32)."""
    import dataclasses
    import warnings

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    monkeypatch.setenv("FLASHMD_CHEB_STACK", schedule)
    per = ({"cheb_fwd": 3, "cheb_bwd_gx": 2, "cheb_bwd_gd": 1}
           if schedule == "1" else
           {"cheb_fwd": 3, "cheb_bwd_gxgd": 2, "cheb_bwd_gd": 1})
    for precision, bound in (("fp32", 1e-4), ("bf16", 2e-3)):
        sfx = "_fp32" if precision == "fp32" else ""
        forces, counts = {}, {}
        for device in (dev, torch.device("cpu")):
            ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                          precision=precision,
                                          message_passing="cheb",
                                          device=device)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # the bounds
                cfg = dataclasses.replace(
                    ff.schnet_config,
                    rbf_cutoff=_envelope(envelope, ff.rcut))
            ff = ff.replace(schnet_config=cfg, schnet_params=attach_cheb_fit(
                ff.schnet_params, cfg))
            system = collate(cfgs, device=device)
            ck.reset_launch_counts()
            f = compute_energy_forces(ff, system.pos, system.atom_types)[1]
            forces[device.type], counts[device.type] = (f.cpu(),
                                                        ck.launch_counts())
        assert torch.isfinite(forces["cuda"]).all()
        assert _rel(forces["cuda"], forces["cpu"]) <= bound, precision
        assert counts["cuda"] == {**dict.fromkeys(ck.launch_counts(), 0),
                                  **{k + sfx: v for k, v in per.items()}}
        assert all(v == 0 for v in counts["cpu"].values())  # twins only


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("a,f", [(70, 128), (33, 48), (41, 200)])
def test_gxgd_kernel_matches_twin(dev, precision, d_min, periodic, a, f):
    """The combined per-block backward (gpos, gx) against its twin, open
    and on positions folded into per-molecule cells; F = 200 runs two
    feature chunks. Two launches on the same inputs are bitwise equal."""
    from flashmd_tpu_torch.models.cheb import _lin_slope

    t = _inputs(dev, 3, a, f, 12, 16)
    pos, cell = t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 3)
    w_lin = _lin_slope(t["c2"]) if d_min > 0 else None
    args = (t["c"], t["c2"], t["w0"], pos, t["x"], t["g"], RCUT, precision,
            d_min, w_lin)
    out = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    again = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    ref = ck.cheb_conv_bwd_gxgd_plain(*args, cell=cell)
    torch.cuda.synchronize()
    for k, r in zip(out, ref):
        assert _rel(k, r) <= BOUNDS[precision]["bwd"]
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    if precision == "bf16x3":
        ref32 = ck.cheb_conv_bwd_gxgd_plain(*_fp32(args), cell=cell)
        assert all(_takes_splits(k, r, r32)
                   for k, r, r32 in zip(out, ref, ref32))


# The tensor-core gx+gd kernel (bf16, bf16x3): 16 x 16 pair fragments,
# those with z == 1 on every pair skipped, the linear term only where low
# != 0; the slice's orders and width, ragged atom counts.
GXGD_ATOMS = [33, 70, 266]


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("layout", ["spread", "clusters", "none", "compact"])
@pytest.mark.parametrize("a", GXGD_ATOMS)
def test_gxgd_tensor_core_kernel_matches_twin(dev, a, layout, periodic,
                                              precision):
    """(gpos, gx) against the twin: 2e-3 (bf16) or 1e-4 and nearer the
    bf16x3 twin than the fp32 one (bf16x3) of max|twin|, gpos exactly zero
    where the twin's is (only the diagonal live); two launches bitwise
    equal. Positions spread at 6 A (pairs below d_min 2.0: the linear
    term runs), in two clusters, on a grid beyond the cutoff, or compact."""
    from flashmd_tpu_torch.models.cheb import _lin_slope

    t = _inputs(dev, 2, a, 128, 48, 64, seed=a + 11)
    cell = None
    if layout == "spread":
        pos = t["pos"]
        if periodic:
            pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    else:
        pos = _gd_layout(dev, 2, a, layout, seed=a + 12)
        if periodic:
            cell = torch.tensor([CELL_WIDE] * 2, device=dev)
    args = (t["c"], t["c2"], t["w0"], pos, t["x"], t["g"], RCUT, precision,
            2.0, _lin_slope(t["c2"]))
    out = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    again = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    ref = ck.cheb_conv_bwd_gxgd_plain(*args, cell=cell)
    ref32 = ck.cheb_conv_bwd_gxgd_plain(*_fp32(args), cell=cell)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    for k, r, r32 in zip(out, ref, ref32):
        assert bool(torch.isfinite(k).all())
        if float(r.abs().max()) == 0.0:
            assert float(k.abs().max()) == 0.0
            continue
        assert _rel(k, r) <= BOUNDS[precision]["bwd"]
        if precision == "bf16x3":
            assert _takes_splits(k, r, r32)
    if layout == "none":
        assert float(ref[0].abs().max()) == 0.0



# The fp32 gx+gd kernel (CUDA cores, live pairs only): rows all dead but the
# diagonal ("none"), all live ("compact"), a lone atom's beside mixed ones
# ("lone"), mixed ("spread", "clusters"); ragged atom counts, one feature
# chunk (F = 128: one launch, no reduce) and two (F = 200: the second
# chunk's partials reduced), odd orders (13 forward, so 14 gx; 15 gd).
FP32_GXGD_ATOMS = [33, 266, 300]


def _lone_atom(pos):
    """Positions with their last atom moved 3 RCUT along y: its row's only
    pair within the cutoff is its diagonal, open and in CELL_WIDE."""
    pos = pos.clone()
    pos[:, -1, 1] += 3 * RCUT
    return pos


def _fp32_gxgd_check(t, pos, cell, d_min, cpu_twin=False):
    """(gpos, gx) of the fp32 kernel against the twin (on the CPU with
    ``cpu_twin``, as _fp32_check) at 1e-4 of max|twin|, exactly zero where
    the twin is; two launches bitwise equal."""
    from flashmd_tpu_torch.models.cheb import _lin_slope

    w_lin = _lin_slope(t["c2"]) if d_min > 0 else None
    args = (t["c"], t["c2"], t["w0"], pos, t["x"], t["g"], RCUT, "fp32",
            d_min, w_lin)
    out = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    again = ck.cheb_conv_bwd_gxgd(*args, cell=cell)
    if cpu_twin:
        ref = ck.cheb_conv_bwd_gxgd_plain(
            *_cpu(args), cell=None if cell is None else cell.cpu())
    else:
        ref = ck.cheb_conv_bwd_gxgd_plain(*args, cell=cell)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    for k, r in zip(out, ref):
        k = k.to(r.device)
        assert bool(torch.isfinite(k).all())
        if float(r.abs().max()) == 0.0:
            assert float(k.abs().max()) == 0.0
            continue
        assert _rel(k, r) <= BOUNDS["fp32"]["bwd"]
    return ref


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("layout",
                         ["spread", "clusters", "lone", "none", "compact"])
@pytest.mark.parametrize("f", [128, 200])
@pytest.mark.parametrize("a", FP32_GXGD_ATOMS)
def test_fp32_gxgd_kernel_matches_twin(dev, a, f, layout, periodic):
    """At d_min 0 and 2.0 (pairs below it: the linear term), open and
    under cells; only the diagonal live ("none"): gpos exactly zero."""
    t = _inputs(dev, 2, a, f, 13, 15, seed=a + f)
    cell = None
    if layout == "spread":
        pos = t["pos"]
        if periodic:
            pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    else:
        pos = _gd_layout(dev, 2, a, "clusters" if layout == "lone"
                         else layout, seed=a + 5)
        if layout == "lone":
            pos = _lone_atom(pos)
        if periodic:
            cell = torch.tensor([CELL_WIDE] * 2, device=dev)
    for d_min in (0.0, 2.0):
        ref = _fp32_gxgd_check(t, pos, cell, d_min)
        if layout == "none":
            assert float(ref[0].abs().max()) == 0.0


@pytest.mark.parametrize("periodic", [False, True])
def test_fp32_gxgd_kernel_at_the_slice_widths(dev, periodic):
    """266 beads, F = 128, the fp32 zoo's orders (128, so 129 gx; 128 gd)
    on d_min 0, positions spread so that most pairs are dead; against the
    twin on the CPU (at order 128 the twin on the card sums |rel|^2 in
    another order, _fp32_check)."""
    t = _inputs(dev, 2, 266, 128, 128, 128, seed=4)
    pos, cell = 3.0 * t["pos"], None
    if periodic:
        pos, cell = torch.remainder(pos, 24.0), _cells(dev, 2)
    _fp32_gxgd_check(t, pos, cell, 0.0, cpu_twin=True)


def _no_sync_steps(sim, dev, n=5):
    """``n`` BAOAB steps of an attached and simulated ``sim`` under
    ``torch.cuda.set_sync_debug_mode("error")``; the carry after them."""
    gen = torch.Generator(device=dev).manual_seed(7)
    carry, first = sim.final_carry, sim.n_timesteps
    draws = [sim._step_draws(gen, first + i) for i in range(n)]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    cd.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for i, (xi, u) in enumerate(draws):
                carry = sim._step_with_hooks(carry, xi, first + i, u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return carry


@pytest.mark.parametrize("path", ["perblock", "dense"])
def test_fp32_slice_step_loops_make_no_host_sync(dev, monkeypatch, path):
    """Five BAOAB steps of a 3-block fp32 field on the per-block cheb
    schedule (FLASHMD_CHEB_STACK=0) and on the dense path launch nothing
    that waits for the card: per force evaluation cheb_fwd 3, cheb_bwd_gxgd
    2 and one-block cheb_bwd_gd 1 on the fp32 counters, or dense fwd 3 and
    bwd 3, every other counter 0."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    if path == "perblock":
        monkeypatch.setenv("FLASHMD_CHEB_STACK", "0")
    ff, cfgs = cgschnet_1enh_like(
        n_atoms=45, batch_size=2, precision="fp32",
        message_passing="cheb" if path == "perblock" else "dense",
        device=dev)
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device=dev,
                             gptq=None)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    sim.simulate()  # builds the kernels, warms the allocator
    carry = _no_sync_steps(sim, dev)
    cheb = {"cheb_fwd_fp32": 15, "cheb_bwd_gxgd_fp32": 10,
            "cheb_bwd_gd_fp32": 5} if path == "perblock" else {}
    dense = dict.fromkeys(cd.launch_counts(), 0 if cheb else 15)
    assert ck.launch_counts() == {**dict.fromkeys(ck.launch_counts(), 0),
                                  **cheb}
    assert cd.launch_counts() == dense
    assert bool(torch.isfinite(carry["pos"]).all())

def _perblock_forces(device, monkeypatch, cell=None, precision="bf16",
                     stack="0"):
    """Forces of a 3-block cheb model on the per-block schedule (or, with
    ``stack="1"``, the stacked one), with the launch counts of the
    evaluation."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    monkeypatch.setenv("FLASHMD_CHEB_STACK", stack)
    ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                  precision=precision,
                                  message_passing="cheb", device=device)
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    system = collate(cfgs, device=device)
    ck.reset_launch_counts()
    _, forces, _ = compute_energy_forces(
        ff, system.pos, system.atom_types,
        cell=None if cell is None else cell.to(device),
    )
    return forces.cpu(), ck.launch_counts()


@pytest.mark.parametrize("periodic", [False, True])
def test_perblock_launch_counts(dev, periodic, monkeypatch):
    """FLASHMD_CHEB_STACK=0: one force evaluation of a 3-block model
    launches cheb_fwd 3, cheb_bwd_gxgd 2 (blocks 2-3) and cheb_bwd_gd 1
    (block 1), the cell variants under a cell; the forces agree with the
    CPU plain path."""
    cell = _cells(dev, 2) * (25.0 / 24.0) if periodic else None
    forces, counts = _perblock_forces(dev, monkeypatch, cell)
    sfx = "_cell" if periodic else ""
    assert counts == {**dict.fromkeys(counts, 0), "cheb_fwd" + sfx: 3,
                      "cheb_bwd_gxgd" + sfx: 2, "cheb_bwd_gd" + sfx: 1}
    forces_cpu, counts_cpu = _perblock_forces(torch.device("cpu"),
                                              monkeypatch, cell)
    assert all(v == 0 for v in counts_cpu.values())
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(forces, forces_cpu) <= 2e-3


@pytest.mark.parametrize("stack", ["1", "0"])
@pytest.mark.parametrize("periodic", [False, True])
def test_bf16x3_launch_counts(dev, periodic, stack, monkeypatch):
    """A bf16x3 force evaluation of a 3-block model launches only the
    bf16x3 counters (3/2/1 stacked, 3/2/1 of fwd/gxgd/gd per block, under
    "_cell" with a cell); its forces agree with the CPU plain path to
    1e-4 (near float32: summation order and product order only)."""
    cell = _cells(dev, 2) * (25.0 / 24.0) if periodic else None
    forces, counts = _perblock_forces(dev, monkeypatch, cell, "bf16x3",
                                      stack)
    sfx = ("_cell" if periodic else "") + "_bf16x3"
    bwd = "cheb_bwd_gx" if stack == "1" else "cheb_bwd_gxgd"
    assert counts == {**dict.fromkeys(counts, 0), "cheb_fwd" + sfx: 3,
                      bwd + sfx: 2, "cheb_bwd_gd" + sfx: 1}
    forces_cpu, _ = _perblock_forces(torch.device("cpu"), monkeypatch, cell,
                                     "bf16x3", stack)
    assert _rel(forces, forces_cpu) <= 1e-4


def test_perblock_path_never_takes_a_twin(dev, monkeypatch):
    """With every cheb twin made to raise, the per-block schedule still
    runs on the card: its wrappers launch, they never fall back."""
    def refuse(*args, **kw):
        raise AssertionError("a plain twin ran on the card")

    for name in ("cheb_conv_fwd_plain", "cheb_conv_bwd_gd_plain",
                 "cheb_conv_bwd_gxgd_plain", "cheb_conv_bwd_gx_plain"):
        monkeypatch.setattr(ck, name, refuse)
    forces, counts = _perblock_forces(dev, monkeypatch)
    assert counts["cheb_bwd_gxgd"] == 2
    assert torch.isfinite(forces).all()


def _dense_inputs(dev, s, a, f=128, r=50, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    offset = torch.linspace(0.0, RCUT, r, device=dev)
    coeff = torch.tensor(-0.5 / float(offset[1] - offset[0]) ** 2,
                         device=dev)
    weights = (randn(r, f, scale=r ** -0.5), randn(f, scale=0.1),
               randn(f, f, scale=f ** -0.5), offset, coeff)
    return randn(s, a, 3, scale=6.0), randn(s, a, f), randn(s, a, f), weights


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("a", [37, 70])
def test_dense_kernels_match_twins(dev, precision, a):
    pos, x, g, w = _dense_inputs(dev, 3, a)
    out = cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision)
    ref = cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, precision)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    gpos_ref, gx_ref = cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT,
                                                 precision)
    gpos, gx = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision)
    gpos_only, none = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision,
                                          need_gx=False)
    torch.cuda.synchronize()
    assert _rel(gpos, gpos_ref) <= BOUNDS[precision]["bwd"]
    assert _rel(gx, gx_ref) <= BOUNDS[precision]["bwd"]
    assert none is None and torch.equal(gpos_only, gpos)


# The tensor-core dense kernels (bf16): each work item's live pairs in
# 16-pair tiles, gd = 0 written for the others; ragged atom counts.
DENSE_ATOMS = [20, 90, 266]


def _dense_layout(dev, pos, a, layout):
    """Positions spread at 6 A ("spread"), at half that ("dense": rows
    with more than 32 live pairs), or on a grid beyond the cutoff ("none":
    no live pair)."""
    if layout == "dense":
        pos = pos * 0.5
        d = torch.cdist(pos, pos)
        assert int(((d < RCUT).sum(-1) - 1).max()) > min(32, a - 2)
    elif layout == "none":
        pos = _gd_layout(dev, 2, a, "none", seed=a)
    return pos


@pytest.mark.parametrize("layout", ["spread", "dense", "none"])
@pytest.mark.parametrize("a", DENSE_ATOMS)
def test_dense_tensor_core_fwd_matches_twin(dev, a, layout):
    """out against the bf16 twin (2e-3 of max|twin|; exactly zero where
    the twin is), two launches bitwise equal (_dense_layout)."""
    pos, x, _, w = _dense_inputs(dev, 2, a, seed=a)
    pos = _dense_layout(dev, pos, a, layout)
    out = cd.dense_cfconv_fwd(pos, x, *w, RCUT, "bf16")
    again = cd.dense_cfconv_fwd(pos, x, *w, RCUT, "bf16")
    ref = cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, "bf16")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    if layout == "none":
        assert float(ref.abs().max()) == 0.0
        assert float(out.abs().max()) == 0.0
    else:
        assert _rel(out, ref) <= BOUNDS["bf16"]["fwd"]


@pytest.mark.parametrize("layout", ["spread", "dense", "none"])
@pytest.mark.parametrize("a", DENSE_ATOMS)
def test_dense_tensor_core_bwd_matches_twin(dev, a, layout):
    """gpos and gx, with and without gx, against the bf16 twin (2e-3 of
    max|twin|; exactly zero where the twin is), two launches bitwise
    equal (_dense_layout)."""
    pos, x, g, w = _dense_inputs(dev, 2, a, seed=a)
    pos = _dense_layout(dev, pos, a, layout)
    for need_gx in (True, False):
        out = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16",
                                  need_gx=need_gx)
        again = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16",
                                    need_gx=need_gx)
        ref = cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT, "bf16",
                                        need_gx=need_gx)
        torch.cuda.synchronize()
        assert (out[1] is None) == (ref[1] is None) == (not need_gx)
        for k, k2, r in zip(out, again, ref):
            if r is None:
                continue
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
            if layout == "none":
                assert float(r.abs().max()) == 0.0
                assert float(k.abs().max()) == 0.0
            else:
                assert _rel(k, r) <= BOUNDS["bf16"]["bwd"]


def test_dense_bwd_bitwise_reproducible(dev):
    pos, x, g, w = _dense_inputs(dev, 2, 90, seed=1)
    first = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16")
    for _ in range(3):
        again = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16")
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])



def _dense_gd(pos, x, g, w, precision, need_gx=True):
    """The backward's [S, A, A] gd workspace after one launch (filled with
    NaN before it: every entry must be written) and its (gpos, gx)."""
    from flashmd_tpu_torch.ops._build import load
    from flashmd_tpu_torch.ops._launch import _ptr, _stream

    s, a, f = x.shape
    gd = torch.full((s, a, a), float("nan"), device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(g) if need_gx else None
    rc = load().dense_cfconv_bwd(
        _ptr(pos), _ptr(x), _ptr(g), *(_ptr(t) for t in w), _ptr(gd),
        _ptr(gpos), _ptr(gx), s, a, f, w[0].shape[0], RCUT,
        int(precision == "bf16"), _stream())
    assert rc == 0
    return gd, gpos, gx


@pytest.mark.parametrize("layout", ["spread", "dense", "none", "lone"])
@pytest.mark.parametrize("a", DENSE_ATOMS)
def test_dense_fp32_bwd_matches_twin(dev, a, layout):
    """The fp32 live-pair backward: gpos and gx, with and without gx,
    against the fp32 twin (1e-4 of max|twin|; exactly zero where the twin
    is), two launches bitwise equal; gd exactly 0 on every dead pair (d >=
    rc, the diagonal) and within 1e-4 of the twin's on the live ones
    (_dense_layout; "lone": two clusters with an atom whose row has no
    live pair)."""
    pos, x, g, w = _dense_inputs(dev, 2, a, seed=a + 3)
    if layout == "lone":
        pos = _lone_atom(_gd_layout(dev, 2, a, "clusters", seed=a))
    else:
        pos = _dense_layout(dev, pos, a, layout)
    for need_gx in (True, False):
        out = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "fp32",
                                  need_gx=need_gx)
        again = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "fp32",
                                    need_gx=need_gx)
        ref = cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT, "fp32",
                                        need_gx=need_gx)
        torch.cuda.synchronize()
        assert (out[1] is None) == (ref[1] is None) == (not need_gx)
        for k, k2, r in zip(out, again, ref):
            if r is None:
                continue
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
            if float(r.abs().max()) == 0.0:
                assert float(k.abs().max()) == 0.0
            else:
                assert _rel(k, r) <= BOUNDS["fp32"]["bwd"]
        gd, gpos, _ = _dense_gd(pos, x, g, w, "fp32", need_gx)
        torch.cuda.synchronize()
        assert torch.equal(gpos, out[0])
        geometry = cd._pair_geometry(pos, w[3], w[4], RCUT)
        eye = torch.eye(a, dtype=torch.bool, device=dev)
        dead = (geometry[1] >= RCUT) | eye
        assert bool((gd[dead] == 0.0).all())
        gd_ref, _ = cd._pair_gd(geometry, x, g, *w, "fp32", need_gx=False)
        assert bool(torch.isfinite(gd).all())
        if bool((~dead).any()):
            assert _rel(gd, gd_ref) <= BOUNDS["fp32"]["bwd"]


def test_dense_fp32_bwd_at_the_slice_width(dev):
    """266 beads at the dense slice's widths (F = 128, R = 50) on positions
    spread so that most pairs are dead: within 1e-4 of the twin, three
    launches bitwise equal."""
    pos, x, g, w = _dense_inputs(dev, 4, 266, seed=9)
    first = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "fp32")
    ref = cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT, "fp32")
    for _ in range(2):
        again = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "fp32")
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    for k, r in zip(first, ref):
        assert _rel(k, r) <= BOUNDS["fp32"]["bwd"]


@pytest.mark.parametrize("layout", ["spread", "lone"])
@pytest.mark.parametrize("a", DENSE_ATOMS)
def test_dense_fp32_fwd_matches_twin(dev, a, layout):
    """The fp32 live-pair forward (dense_fwd_ffma_kernel) against the fp32
    twin (1e-5 of max|twin|), two launches bitwise equal; "lone": two
    clusters with an atom whose row has no live pair, whose out row is
    exactly zero as the twin's."""
    pos, x, _, w = _dense_inputs(dev, 2, a, seed=a + 5)
    if layout == "lone":
        pos = _lone_atom(_gd_layout(dev, 2, a, "clusters", seed=a))
    out = cd.dense_cfconv_fwd(pos, x, *w, RCUT, "fp32")
    again = cd.dense_cfconv_fwd(pos, x, *w, RCUT, "fp32")
    ref = cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, "fp32")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert _rel(out, ref) <= BOUNDS["fp32"]["fwd"]
    if layout == "lone":
        assert float(ref[:, -1].abs().max()) == 0.0
        assert float(out[:, -1].abs().max()) == 0.0


def test_dense_fp32_fwd_at_the_slice_width(dev):
    """266 beads at the dense slice's widths (F = 128, R = 50), batch 8,
    at the spread positions and at half their spacing (rows with more than
    32 live pairs): within 1e-5 of the twin, three launches bitwise
    equal."""
    pos, x, _, w = _dense_inputs(dev, 8, 266, seed=11)
    for p in (pos, _dense_layout(dev, pos, 266, "dense")):
        first = cd.dense_cfconv_fwd(p, x, *w, RCUT, "fp32")
        ref = cd.dense_cfconv_fwd_plain(p, x, *w, RCUT, "fp32")
        for _ in range(2):
            assert torch.equal(cd.dense_cfconv_fwd(p, x, *w, RCUT, "fp32"),
                               first)
        assert _rel(first, ref) <= BOUNDS["fp32"]["fwd"]


def test_dense_fp32_fwd_bitwise_reproducible(dev):
    """The fp32 forward, bitwise equal over launches and batch orders: a
    molecule's rows do not depend on which warp or block runs them."""
    pos, x, _, w = _dense_inputs(dev, 3, 90, seed=2)
    first = cd.dense_cfconv_fwd(pos, x, *w, RCUT, "fp32")
    for _ in range(3):
        assert torch.equal(cd.dense_cfconv_fwd(pos, x, *w, RCUT, "fp32"),
                           first)
    flip = torch.flip
    out = cd.dense_cfconv_fwd(flip(pos, [0]).contiguous(),
                              flip(x, [0]).contiguous(), *w, RCUT, "fp32")
    assert torch.equal(flip(out, [0]), first)


def test_dense_wrappers_refuse_what_kernels_do_not_take(dev):
    pos, x, g, w = _dense_inputs(dev, 2, 20)
    with pytest.raises(ValueError):
        cd.dense_cfconv_fwd(pos, x.double(), *w, RCUT, "fp32")
    with pytest.raises(ValueError):
        cd.dense_cfconv_bwd(pos, x, g.half(), *w, RCUT, "bf16")
    with pytest.raises(ValueError):
        cd.dense_cfconv_fwd(pos, x.cpu(), *w, RCUT, "fp32")
    # no radial function (R = 0): every width F >= 1, R >= 1 runs
    w0, b0, w1, offset, coeff = w
    with pytest.raises(ValueError):
        cd.dense_cfconv_fwd(pos, x, w0[:0], b0, w1, offset[:0], coeff,
                            RCUT, "fp32")


def test_dense_main_path_launch_counts(dev):
    """3 dense_cfconv_fwd + 3 dense_cfconv_bwd per force evaluation of a
    3-block dense model; the forces agree with the CPU plain path."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    results = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                      message_passing="dense", device=device)
        system = collate(cfgs, device=device)
        cd.reset_launch_counts()
        for _ in range(2):
            _, forces, _ = compute_energy_forces(ff, system.pos,
                                                 system.atom_types)
        results[device.type] = (forces.cpu(), cd.launch_counts())
    assert results["cuda"][1] == {"dense_cfconv_fwd": 6,
                                  "dense_cfconv_bwd": 6}
    assert results["cpu"][1] == {"dense_cfconv_fwd": 0,
                                 "dense_cfconv_bwd": 0}
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(results["cuda"][0], results["cpu"][0]) <= 2e-3


def _nbr_case(dev, s, a, capacity, seed=0):
    """Dense inputs plus the list at rcut + 1 (a skin) of capacity K."""
    pos, x, g, w = _dense_inputs(dev, s, a, seed=seed)
    pos = pos * 0.5  # denser: rows with more than 32 neighbours exist
    nbr = batched_radius_neighbor_matrix(pos, RCUT + 1.0, capacity)
    return pos, x, g, w, nbr


# capacity 96 holds every neighbour (a symmetric list); 32 overflows
# (each row keeps its nearest 32: the list is asymmetric).
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("capacity", [96, 32])
def test_nbr_kernels_match_twins(dev, precision, capacity):
    pos, x, g, w, nbr = _nbr_case(dev, 3, 70, capacity)
    overflow = int(nbr.n_max.max()) > capacity
    assert overflow == (capacity == 32)
    out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                              precision)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    gpos_ref, gx_ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w,
                                           RCUT, precision)
    gpos, gx = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, precision)
    gpos_only, none = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, precision,
                                    need_gx=False)
    torch.cuda.synchronize()
    assert _rel(gpos, gpos_ref) <= BOUNDS[precision]["bwd"]
    assert _rel(gx, gx_ref) <= BOUNDS[precision]["bwd"]
    assert none is None and torch.equal(gpos_only, gpos)


# The live-slot neighbour-matrix kernels (bf16 on the tensor cores, fp32 on
# the CUDA cores): each work item's live slots in 16-slot tiles (the
# forward adds nothing for the others, the backward writes gd = 0 for
# them), gx over the source CSR; ragged atom counts.
NBR_ATOMS = [33, 70, 266]


def _not_a_prefix(pos, nbr):
    """Whether some row of the list has a live slot (d < RCUT) after a
    listed slot at d >= RCUT."""
    b = torch.arange(pos.shape[0], device=pos.device)[:, None, None]
    rel = pos[b, nbr.idx.long()] - pos[:, :, None, :]
    live = nbr.mask & (torch.linalg.norm(rel, dim=-1) < RCUT)
    dead_before = torch.cumsum((nbr.mask & ~live).int(), dim=-1) > 0
    return bool((live & dead_before).any())


def _nbr_tc_case(dev, a, capacity, stale, f=128, r=50):
    """(pos, x, g, filter weights, list): a symmetric list (capacity 96)
    or an overflowed one (32, where a row has more neighbours), fresh or
    with the atoms moved after the build (a stale list, whose live slots
    are not a prefix of their row). Atoms uniform in a cube at about 40
    within RCUT + 1 of an inner atom. F filters, R radial functions."""
    _, x, g, w = _dense_inputs(dev, 2, a, f=f, r=r, seed=a)
    gen = torch.Generator(device=dev).manual_seed(a + 1)
    side = (a / 0.0072) ** (1 / 3)
    pos = side * torch.rand(2, a, 3, generator=gen, device=dev)
    nbr = batched_radius_neighbor_matrix(pos, RCUT + 1.0, capacity)
    if a >= 70:
        assert (int(nbr.n_max.max()) > capacity) == (capacity == 32)
    if stale:
        pos = pos + 0.5 * torch.randn(pos.shape, generator=gen, device=dev)
        assert _not_a_prefix(pos, nbr)
    return pos, x, g, w, nbr


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("capacity", [96, 32])
@pytest.mark.parametrize("a", NBR_ATOMS)
def test_nbr_tensor_core_fwd_matches_twin(dev, a, capacity, stale,
                                          precision):
    """out of the live-slot forward (nbr_fwd_mma_kernel at bf16,
    nbr_fwd_ffma_kernel at fp32) against the twin of its tier (2e-3 and
    1e-5 of max|twin|), two launches bitwise equal (_nbr_tc_case); every
    row with no live slot exactly zero, as the twin's."""
    pos, x, _, w, nbr = _nbr_tc_case(dev, a, capacity, stale)
    out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    again = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                              precision)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    d = cf._slot_geometry(pos, nbr.idx, nbr.mask, w[3], w[4], RCUT)[1]
    empty = ~(nbr.mask & (d < RCUT)).any(dim=-1)
    assert not bool(ref[empty].any()) and not bool(out[empty].any())


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
@pytest.mark.parametrize("a", NBR_ATOMS)
def test_nbr_tensor_core_fwd_all_dead(dev, a, precision):
    """A list built on compact positions, then every atom moved onto a
    grid of spacing 1.2 RCUT: every listed slot at d >= RCUT. out is
    exactly zero, as the twin's, at bf16 and fp32."""
    _, x, _, w = _dense_inputs(dev, 2, a, seed=a)
    nbr = batched_radius_neighbor_matrix(
        _gd_layout(dev, 2, a, "compact", seed=a), RCUT + 1.0, 32)
    assert bool(nbr.mask.any())
    pos = _gd_layout(dev, 2, a, "none", seed=a)
    out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                              precision)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) == 0.0
    assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("capacity", [96, 32])
@pytest.mark.parametrize("a", NBR_ATOMS)
def test_nbr_tensor_core_bwd_matches_twin(dev, a, capacity, stale):
    """gpos and gx, with and without gx, against the bf16 twin (2e-3 of
    max|twin|), two launches bitwise equal (_nbr_tc_case)."""
    pos, x, g, w, nbr = _nbr_tc_case(dev, a, capacity, stale)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    for need_gx in (True, False):
        out = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16",
                            need_gx=need_gx)
        again = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16",
                              need_gx=need_gx)
        ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, RCUT,
                                  "bf16", need_gx=need_gx)
        torch.cuda.synchronize()
        assert (out[1] is None) == (ref[1] is None) == (not need_gx)
        for k, k2, r in zip(out, again, ref):
            if r is None:
                continue
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
            assert _rel(k, r) <= BOUNDS["bf16"]["bwd"]


def _nbr_gd(pos, nbr, x, g, w, need_gx):
    """The fp32 backward's [S, A, K] gd and [S, A, K, F] W workspaces after
    one launch (both filled with NaN before it), and its (gpos, gx)."""
    from flashmd_tpu_torch.ops._build import load
    from flashmd_tpu_torch.ops._launch import _ptr, _stream

    s, a, f = x.shape
    k = nbr.idx.shape[-1]
    gd = torch.full((s, a, k), float("nan"), device=pos.device)
    wbuf = (torch.full((s, a, k, f), float("nan"), device=pos.device)
            if need_gx else None)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(g) if need_gx else None
    rc = load().cfconv_bwd(
        _ptr(pos), _ptr(nbr.idx), _ptr(nbr.mask), _ptr(nbr.csr_offsets),
        _ptr(nbr.csr_slots), _ptr(x), _ptr(g), *(_ptr(t) for t in w),
        _ptr(gd), _ptr(wbuf), _ptr(gpos), _ptr(gx), s, a, k, f,
        w[0].shape[0], RCUT, 0, _stream())
    assert rc == 0
    return gd, wbuf, gpos, gx


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("capacity", [96, 32])
@pytest.mark.parametrize("a", NBR_ATOMS)
def test_nbr_fp32_bwd_matches_twin(dev, a, capacity, stale):
    """The fp32 live-slot backward (nbr_bwd_ffma_kernel, then gpos_kernel
    and gx_kernel): gpos and gx, with and without gx, against the fp32
    twin (1e-4 of max|twin|), two launches bitwise equal (_nbr_tc_case:
    symmetric and overflowed lists, fresh and stale); gd exactly 0 on
    every masked slot and every slot at d >= rc and within 1e-4 of the
    twin's on the live ones; W written at exactly the live slots (the
    ones gx_kernel reads), within 1e-4 of the twin's W there, and nowhere
    else (NaN left)."""
    pos, x, g, w, nbr = _nbr_tc_case(dev, a, capacity, stale)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    for need_gx in (True, False):
        out = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32",
                            need_gx=need_gx)
        again = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32",
                              need_gx=need_gx)
        ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, RCUT,
                                  "fp32", need_gx=need_gx)
        torch.cuda.synchronize()
        assert (out[1] is None) == (ref[1] is None) == (not need_gx)
        for k, k2, r in zip(out, again, ref):
            if r is None:
                continue
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
            assert _rel(k, r) <= BOUNDS["fp32"]["bwd"]
        gd, wbuf, gpos, _ = _nbr_gd(pos, nbr, x, g, w, need_gx)
        torch.cuda.synchronize()
        assert torch.equal(gpos, out[0])
        geometry = cf._slot_geometry(pos, nbr.idx, nbr.mask, w[3], w[4],
                                     RCUT)
        live = nbr.mask & (geometry[1] < RCUT)
        assert bool((gd[~live] == 0.0).all())
        gd_ref, w_ref = cf._slot_gd(geometry, cf._gather_rows(x, nbr.idx),
                                    g[:, :, None, :], *w, "fp32")
        assert bool(torch.isfinite(gd).all())
        assert _rel(gd, gd_ref) <= BOUNDS["fp32"]["bwd"]
        if need_gx:
            assert bool(torch.isfinite(wbuf[live]).all())
            assert bool(torch.isnan(wbuf[~live]).all())
            assert _rel(wbuf[live], w_ref[live]) <= BOUNDS["fp32"]["bwd"]


def test_nbr_fp32_bwd_at_the_slice_width(dev):
    """266 beads at the pallas slice's widths (F = 128, R = 50), batch 8,
    on a fresh list at capacity 96 and on an overflowed one (32): gpos and
    gx within 1e-4 of the twin, with and without gx, three launches
    bitwise equal."""
    pos, x, g, w, _ = _nbr_tc_case(dev, 266, 96, False)
    for capacity in (96, 32):
        nbr = batched_radius_neighbor_matrix(pos, RCUT + 1.0, capacity)
        csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
        for need_gx in (True, False):
            first = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32",
                                  need_gx=need_gx)
            ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w,
                                      RCUT, "fp32", need_gx=need_gx)
            for _ in range(2):
                again = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32",
                                      need_gx=need_gx)
                for k, k2 in zip(first, again):
                    assert k is None or torch.equal(k, k2)
            for k, r in zip(first, ref):
                if r is not None:
                    assert _rel(k, r) <= BOUNDS["fp32"]["bwd"]


def test_nbr_fp32_fwd_at_the_slice_width(dev):
    """The pallas fp32 slice's field (cgschnet_1enh_like at fp32: 266
    beads, batch 128, F = 128, R = 50) on its own list (K = 88, rc + skin
    1.0) at the start positions and with the atoms moved (a stale list):
    the fp32 forward within 1e-5 of the twin, three launches bitwise
    equal."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(n_atoms=266, batch_size=128,
                                  message_passing="pallas",
                                  precision="fp32", device=dev)
    pos = collate(cfgs, device=dev).pos
    nbr = build_neighbors(ff, pos, skin=1.0)
    assert nbr.capacity == 88
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    w = (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
         rbf["coeff"])
    rcut = float(ff.schnet_config.cutoff.cutoff_upper)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(*pos.shape[:2], 128, generator=gen, device=dev)
    moved = pos + 0.3 * torch.randn(pos.shape, generator=gen, device=dev)
    for p in (pos, moved):
        first = cf.cfconv_fwd(p, nbr.idx, nbr.mask, x, *w, rcut, "fp32")
        ref = cf.cfconv_fwd_plain(p, nbr.idx, nbr.mask, x, *w, rcut,
                                  "fp32")
        for _ in range(2):
            assert torch.equal(
                cf.cfconv_fwd(p, nbr.idx, nbr.mask, x, *w, rcut, "fp32"),
                first)
        assert bool(torch.isfinite(first).all())
        assert _rel(first, ref) <= BOUNDS["fp32"]["fwd"]


def test_nbr_fp32_fwd_bitwise_reproducible(dev):
    """The fp32 forward, bitwise equal over launches and batch orders: a
    molecule's rows do not depend on which warp or block runs them."""
    pos, x, _, w, nbr = _nbr_case(dev, 3, 90, 32, seed=2)
    first = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, "fp32")
    for _ in range(3):
        assert torch.equal(
            cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, "fp32"),
            first)
    flip = torch.flip
    rev = batched_radius_neighbor_matrix(flip(pos, [0]).contiguous(),
                                         RCUT + 1.0, 32)
    out = cf.cfconv_fwd(flip(pos, [0]).contiguous(), rev.idx, rev.mask,
                        flip(x, [0]).contiguous(), *w, RCUT, "fp32")
    assert torch.equal(flip(out, [0]), first)


def test_nbr_fp32_bwd_bitwise_reproducible(dev):
    """The fp32 backward, bitwise equal over launches and batch orders."""
    pos, x, g, w, nbr = _nbr_case(dev, 3, 90, 32, seed=1)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    first = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32")
    for _ in range(3):
        again = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "fp32")
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    flip = torch.flip
    rev = batched_radius_neighbor_matrix(flip(pos, [0]).contiguous(),
                                         RCUT + 1.0, 32)
    gpos, gx = cf.cfconv_bwd(flip(pos, [0]).contiguous(), rev.idx, rev.mask,
                             rev.csr_offsets, rev.csr_slots,
                             flip(x, [0]).contiguous(),
                             flip(g, [0]).contiguous(), *w, RCUT, "fp32")
    assert torch.equal(flip(gpos, [0]), first[0])
    assert torch.equal(flip(gx, [0]), first[1])


def test_nbr_bwd_bitwise_reproducible(dev):
    """The bf16 backward and forward, each bitwise equal over launches."""
    pos, x, g, w, nbr = _nbr_case(dev, 2, 90, 32, seed=1)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    first = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16")
    first_out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, "bf16")
    for _ in range(3):
        again = cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16")
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
        out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, "bf16")
        assert torch.equal(out, first_out)


def test_nbr_wrappers_refuse_what_kernels_do_not_take(dev):
    pos, x, g, w, nbr = _nbr_case(dev, 2, 20, 16)
    with pytest.raises(ValueError):
        cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x.double(), *w, RCUT, "fp32")
    with pytest.raises(ValueError):
        cf.cfconv_fwd(pos, nbr.idx.long(), nbr.mask, x, *w, RCUT, "fp32")
    with pytest.raises(ValueError):
        cf.cfconv_bwd(pos, nbr.idx, nbr.mask, nbr.csr_offsets.long(),
                      nbr.csr_slots, x, g, *w, RCUT, "bf16")
    with pytest.raises(ValueError):
        cf.cfconv_fwd(pos, nbr.idx, nbr.mask.float(), x, *w, RCUT, "fp32")


def _pallas_field(device, **kw):
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                  message_passing="pallas", device=device,
                                  **kw)
    return ff, cfgs, collate(cfgs, device=device)


def test_nbr_forces_bitwise_reproducible(dev):
    """The force field's forces, neighbour build included, are bitwise
    equal over two evaluations."""
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    ff, _, system = _pallas_field(dev)
    first = compute_energy_forces(ff, system.pos, system.atom_types)[1]
    again = compute_energy_forces(ff, system.pos, system.atom_types)[1]
    assert torch.equal(first, again)


def test_nbr_main_path_launch_counts(dev):
    """3 cfconv_fwd + 3 cfconv_bwd per force evaluation of a 3-block
    pallas model, in compute_energy_forces and in a short simulation; the
    forces agree with the CPU plain path."""
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    results = {}
    for device in (dev, torch.device("cpu")):
        ff, _, system = _pallas_field(device)
        cf.reset_launch_counts()
        for _ in range(2):
            _, forces, _ = compute_energy_forces(ff, system.pos,
                                                 system.atom_types)
        results[device.type] = (forces.cpu(), cf.launch_counts())
    assert results["cuda"][1] == {"cfconv_fwd": 6, "cfconv_bwd": 6}
    assert results["cpu"][1] == {"cfconv_fwd": 0, "cfconv_bwd": 0}
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(results["cuda"][0], results["cpu"][0]) <= 2e-3

    ff, cfgs, _ = _pallas_field(dev)
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device=dev)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    cf.reset_launch_counts()
    coords = sim.simulate()
    assert cf.launch_counts() == {"cfconv_fwd": 15, "cfconv_bwd": 15}
    assert coords.shape == (2, 2, 40, 3)
    assert torch.isfinite(torch.as_tensor(coords)).all()


# --------------------------------------------------------------------------
# every width (ops/cfconv_general.py): the tuned kernels zero-padded below
# F = 128 (F <= 128, R <= 64), the general-width kernels at F > 128 or
# R > 64, each family on its own counters
# --------------------------------------------------------------------------

# SchNet's published widths (F 64, R 300), F 256 at R 50, F 96, a narrow
# F 64 at R 32 (both padded onto the tuned kernels), R 100 at F 128 and the
# Open Catalyst SchNet's filter, F 256 at R 200 (streamed at bf16).
WIDTHS = [(64, 300), (256, 50), (96, 50), (64, 32), (128, 100), (256, 200)]


def _family_counts():
    from flashmd_tpu_torch.ops import cfconv_general as cg

    return {**cd.launch_counts(), **cf.launch_counts(), **cg.launch_counts()}


def _reset_family_counts():
    from flashmd_tpu_torch.ops import cfconv_general as cg

    for mod in (cd, cf, cg):
        mod.reset_launch_counts()


def _expect_launches(f, r, precision, path, fwd, bwd):
    """Every counter of the dense, neighbour-matrix and general families 0
    but ``path``'s ("dense_cfconv" or "cfconv") forward and backward on the
    family that :func:`route` names."""
    from flashmd_tpu_torch.ops import cfconv_general as cg

    family = cg.route(f, r, precision)[0]
    sfx = "" if family == "tuned" else f"_{family}"
    return {**dict.fromkeys(_family_counts(), 0),
            f"{path}_fwd{sfx}": fwd, f"{path}_bwd{sfx}": bwd}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("f,r", WIDTHS)
def test_dense_kernels_at_every_width(dev, f, r, precision):
    """The dense forward and backward (with and without gx) against their
    twins at each width, two launches bitwise equal, gpos the same with
    and without gx, and the launches on the routed family's counters."""
    pos, x, g, w = _dense_inputs(dev, 2, 70, f=f, r=r, seed=f + r)
    _reset_family_counts()
    out = cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision)
    again = cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision)
    bwd = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision)
    bwd2 = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision)
    gpos_only, none = cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision,
                                          need_gx=False)
    torch.cuda.synchronize()
    assert _family_counts() == _expect_launches(f, r, precision,
                                                "dense_cfconv", 2, 3)
    ref = cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, precision)
    gpos_ref, gx_ref = cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT,
                                                 precision)
    assert out.shape == x.shape and bwd[1].shape == x.shape
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    assert torch.equal(bwd[0], bwd2[0]) and torch.equal(bwd[1], bwd2[1])
    assert _rel(bwd[0], gpos_ref) <= BOUNDS[precision]["bwd"]
    assert _rel(bwd[1], gx_ref) <= BOUNDS[precision]["bwd"]
    assert none is None and torch.equal(gpos_only, bwd[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("capacity", [96, 32])
@pytest.mark.parametrize("f,r", WIDTHS)
def test_nbr_kernels_at_every_width(dev, f, r, capacity, stale, precision):
    """The neighbour-matrix forward and backward (with and without gx) on
    symmetric (96) and overflowed (32) lists, fresh and stale
    (_nbr_tc_case), against their twins at each width; two launches
    bitwise equal; the launches on the routed family's counters."""
    pos, x, g, w, nbr = _nbr_tc_case(dev, 70, capacity, stale, f=f, r=r)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    _reset_family_counts()
    out = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    again = cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision)
    runs = {need_gx: [cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, precision,
                                    need_gx=need_gx) for _ in range(2)]
            for need_gx in (True, False)}
    torch.cuda.synchronize()
    assert _family_counts() == _expect_launches(f, r, precision, "cfconv",
                                                2, 4)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                              precision)
    assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
    assert _rel(out, ref) <= BOUNDS[precision]["fwd"]
    for need_gx, (first, second) in runs.items():
        ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, RCUT,
                                  precision, need_gx=need_gx)
        assert (first[1] is None) == (not need_gx)
        for k, k2, p in zip(first, second, ref):
            if p is None:
                continue
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
            assert _rel(k, p) <= BOUNDS[precision]["bwd"]
    assert torch.equal(runs[True][0][0], runs[False][0][0])


# Odd widths: F = R = 1 (padded onto the tuned kernels), F just past 128,
# F and R that are no multiples of 64 (x, g and the weights padded to 64 by
# the general wrapper), F = 1,600, whose backward tiles exceed a block's
# shared memory and go to the device-memory workspace, and F = 2,900,
# whose forward and gx-pass tiles go there too.
ODD_WIDTHS = [(1, 1), (100, 70), (129, 1), (300, 17), (1600, 8), (2900, 8)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("f,r", ODD_WIDTHS)
def test_kernels_at_odd_widths(dev, f, r, precision):
    """The four kernels, the backwards with and without gx, against their
    twins at each odd width on a stale overflowed list, two launches
    bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(f + r)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    offset = torch.linspace(0.0, RCUT, r, device=dev)
    coeff = torch.tensor(-0.5 / (RCUT / max(r - 1, 1)) ** 2, device=dev)
    w = (randn(r, f, scale=r ** -0.5), randn(f, scale=0.1),
         randn(f, f, scale=f ** -0.5), offset, coeff)
    pos, _, _, _, nbr = _nbr_tc_case(dev, 33, 32, True)
    x, g = randn(2, 33, f), randn(2, 33, f)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    calls = {
        "dense fwd": (lambda: cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision),
                      lambda: cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT,
                                                        precision), "fwd"),
        "nbr fwd": (lambda: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w,
                                          RCUT, precision),
                    lambda: cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w,
                                                RCUT, precision), "fwd"),
    }
    for need_gx in (True, False):
        calls[f"dense bwd {need_gx}"] = (
            lambda n=need_gx: cd.dense_cfconv_bwd(pos, x, g, *w, RCUT,
                                                  precision, need_gx=n),
            lambda n=need_gx: cd.dense_cfconv_bwd_plain(
                pos, x, g, *w, RCUT, precision, need_gx=n), "bwd")
        calls[f"nbr bwd {need_gx}"] = (
            lambda n=need_gx: cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT,
                                            precision, need_gx=n),
            lambda n=need_gx: cf.cfconv_bwd_plain(
                pos, nbr.idx, nbr.mask, x, g, *w, RCUT, precision,
                need_gx=n), "bwd")
    for name, (kern, plain, kind) in calls.items():
        first, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        first, again, ref = (v if isinstance(v, tuple) else (v,)
                             for v in (first, again, ref))
        for k, k2, p in zip(first, again, ref):
            if p is None:
                assert k is None
                continue
            assert k.shape == p.shape, name
            assert bool(torch.isfinite(k).all()) and torch.equal(k, k2), name
            assert _rel(k, p) <= BOUNDS[precision][kind], name


# The CUDA-core tiles' layouts (ops/cfconv_general.py ffma_layout): a
# width just inside and one just outside each boundary. F 128: weights
# staged in shared memory up to R 104, streamed in panels from R 105; R 8:
# panels up to F 576, the first design's kernels (weights through L1/L2)
# from F 577 (Fp 640).
LAYOUT_WIDTHS = [(128, 104, "staged"), (128, 105, "panels"),
                 (576, 8, "panels"), (577, 8, "l2")]


def _general_gd(pos, nbr, x, g, w, need_gx, precision="fp32", tier=None):
    """The general-width backward's gd workspace ([S, A, A] dense when
    ``nbr`` is None, else [S, A, K]) after one launch at ``precision``
    (fp32: tier 0, bf16: tier 1, the wide family's CUDA-core kernels; or
    ``tier`` 2, the tensor-core tiles with the weights staged, 3 streamed;
    filled with NaN before it: every entry must be written) and its
    gpos."""
    from flashmd_tpu_torch.ops import cfconv_general as cg
    from flashmd_tpu_torch.ops._build import load
    from flashmd_tpu_torch.ops._launch import _ptr, _stream

    s, a, f = x.shape
    r = w[0].shape[0]
    k = nbr.idx.shape[-1] if nbr is not None else 0
    mma = tier is not None
    wg = cg.general_weights(*w[:4], precision, tensor_cores=mma)
    fp, rq = wg["w1"].shape[0], wg["off"].shape[0]
    xp, gp = cg.pad_features(x, fp), cg.pad_features(g, fp)
    gd = torch.full((s, a, k or a), float("nan"), device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(gp) if need_gx else None
    lists = ((nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
             if nbr is not None else (None,) * 4)
    rc = load().cfconv_general_bwd(
        int(nbr is not None), _ptr(pos), *(_ptr(t) for t in lists),
        _ptr(xp), _ptr(gp), *cg._weight_ptrs(wg, w[4]), _ptr(gd),
        _ptr(gpos), _ptr(gx),
        _ptr(None if mma else cg._workspace(True, fp, pos.device)), s, a, k,
        fp, r, rq, RCUT, tier if mma else int(precision == "bf16"),
        _stream())
    assert rc == 0
    return gd, gpos


def _check_cuda_core_tiles(dev, f, r, layout, precision):
    """The CUDA-core tiles at F, R in ``layout`` at ``precision`` (fp32, or
    bf16 for the wide family): the library's layout of each kind equals
    the Python mirror's (the forward and the gx pass at Fp 64 take the
    first design's kernels); the dense and neighbour-matrix forwards and
    backwards (with and without gx) against their twins within
    BOUNDS[precision], two launches bitwise equal, gpos the same with and
    without gx; gd exactly 0 on every dead pair (the diagonal, d >= rc)
    and slot (masked, d >= rc), within the backward's bound of the twin's
    on the live ones."""
    from flashmd_tpu_torch.ops import cfconv_general as cg
    from flashmd_tpu_torch.ops._build import load

    assert cg.ffma_layout(f, r) == layout
    fp, rq = -(-f // 64) * 64, -(-r // 64) * 64
    code = {"staged": 0, "panels": 1, "l2": -1}[layout]
    assert [load().cfconv_general_layout(kind, fp, r, rq)
            for kind in (0, 1, 2)] == [-1 if fp == 64 else code, code, code]
    bounds = BOUNDS[precision]
    pos, x, g, w, nbr = _nbr_tc_case(dev, 33, 32, True, f=f, r=r)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    paths = {
        "dense": (lambda: cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision),
                  lambda: cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT,
                                                    precision),
                  lambda n: cd.dense_cfconv_bwd(pos, x, g, *w, RCUT,
                                                precision, need_gx=n),
                  lambda n: cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT,
                                                      precision, need_gx=n)),
        "nbr": (lambda: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                                      precision),
                lambda: cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w,
                                            RCUT, precision),
                lambda n: cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, precision,
                                        need_gx=n),
                lambda n: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g,
                                              *w, RCUT, precision,
                                              need_gx=n)),
    }
    for name, (fwd, fwd_plain, bwd, bwd_plain) in paths.items():
        out, again, ref = fwd(), fwd(), fwd_plain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
        assert _rel(out, ref) <= bounds["fwd"], name
        runs = {n: (bwd(n), bwd(n), bwd_plain(n)) for n in (True, False)}
        torch.cuda.synchronize()
        for n, (first, second, ref) in runs.items():
            assert (first[1] is None) == (not n)
            for k, k2, p in zip(first, second, ref):
                if p is None:
                    continue
                assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
                assert _rel(k, p) <= bounds["bwd"], (name, n)
        assert torch.equal(runs[True][0][0], runs[False][0][0])
        for need_gx in (True, False):
            gd, gpos = _general_gd(pos, nbr if name == "nbr" else None, x, g,
                                   w, need_gx, precision)
            torch.cuda.synchronize()
            assert torch.equal(gpos, runs[need_gx][0][0])
            if name == "nbr":
                geometry = cf._slot_geometry(pos, nbr.idx, nbr.mask, w[3],
                                             w[4], RCUT)
                live = nbr.mask & (geometry[1] < RCUT)
                gd_ref, _ = cf._slot_gd(geometry,
                                        cf._gather_rows(x, nbr.idx),
                                        g[:, :, None, :], *w, precision)
            else:
                geometry = cd._pair_geometry(pos, w[3], w[4], RCUT)
                eye = torch.eye(x.shape[1], dtype=torch.bool, device=dev)
                live = (geometry[1] < RCUT) & ~eye
                gd_ref, _ = cd._pair_gd(geometry, x, g, *w, precision,
                                        need_gx=False)
            assert bool((gd[~live] == 0.0).all()), name
            assert bool(torch.isfinite(gd).all()), name
            assert _rel(gd, gd_ref) <= bounds["bwd"], name


@pytest.mark.parametrize("f,r,layout", LAYOUT_WIDTHS)
def test_fp32_kernels_at_the_layout_boundaries(dev, f, r, layout):
    """At each side of each layout boundary, the fp32 tier: the checks of
    _check_cuda_core_tiles within BOUNDS["fp32"] (1e-5 / 1e-4 of
    max|twin|)."""
    _check_cuda_core_tiles(dev, f, r, layout, "fp32")


# The wide family (bf16 widths where neither the whole bf16 weights nor the
# streamed tiles' panel buffers and one warp fit in a block's shared memory)
# on the CUDA-core kernels at tier 1: F 4,096 at R 8 (the first design's,
# tiles in device memory; the streamed tiles take up to F 4,048 there).
WIDE_WIDTHS = [(4096, 8, "l2")]


@pytest.mark.parametrize("f,r,layout", WIDE_WIDTHS)
def test_wide_bf16_kernels_on_the_cuda_core_tiles(dev, f, r, layout):
    """The wide family at bf16: routed to ("wide", "bf16"), the checks of
    _check_cuda_core_tiles within BOUNDS["bf16"] against the bf16 twins
    (operands rounded where they round them), and every launch on the wide
    family's counters."""
    from flashmd_tpu_torch.ops import cfconv_general as cg

    assert cg.route(f, r, "bf16") == ("wide", "bf16")
    _reset_family_counts()
    _check_cuda_core_tiles(dev, f, r, layout, "bf16")
    counts = _family_counts()
    assert all(counts[f"{path}_{kind}_wide"] > 0
               for path in ("dense_cfconv", "cfconv")
               for kind in ("fwd", "bwd"))
    assert not any(v for k, v in counts.items() if not k.endswith("_wide"))


def _check_mma_tiles(dev, f, r, tier):
    """The tensor-core tiles at F, R on ``tier`` (2 the weights staged, 3
    streamed in panels): the dense and neighbour-matrix forwards and
    backwards (with and without gx) through the wrappers against their
    bf16 twins within BOUNDS["bf16"], two launches bitwise equal, gpos the
    same with and without gx; the backward at ``tier`` called directly:
    gd exactly 0 on every dead pair (the diagonal, d >= rc) and slot
    (masked, d >= rc), within the backward's bound of the twin's on the
    live ones, and its gpos the wrapper's."""
    bounds = BOUNDS["bf16"]
    pos, x, g, w, nbr = _nbr_tc_case(dev, 33, 32, True, f=f, r=r)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    paths = {
        "dense": (lambda: cd.dense_cfconv_fwd(pos, x, *w, RCUT, "bf16"),
                  lambda: cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, "bf16"),
                  lambda n: cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16",
                                                need_gx=n),
                  lambda n: cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT,
                                                      "bf16", need_gx=n)),
        "nbr": (lambda: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT,
                                      "bf16"),
                lambda: cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w,
                                            RCUT, "bf16"),
                lambda n: cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16",
                                        need_gx=n),
                lambda n: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g,
                                              *w, RCUT, "bf16", need_gx=n)),
    }
    for name, (fwd, fwd_plain, bwd, bwd_plain) in paths.items():
        out, again, ref = fwd(), fwd(), fwd_plain()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and torch.equal(out, again)
        assert _rel(out, ref) <= bounds["fwd"], name
        runs = {n: (bwd(n), bwd(n), bwd_plain(n)) for n in (True, False)}
        torch.cuda.synchronize()
        for n, (first, second, ref) in runs.items():
            assert (first[1] is None) == (not n)
            for k, k2, p in zip(first, second, ref):
                if p is None:
                    continue
                assert bool(torch.isfinite(k).all()) and torch.equal(k, k2)
                assert _rel(k, p) <= bounds["bwd"], (name, n)
        assert torch.equal(runs[True][0][0], runs[False][0][0])
        for need_gx in (True, False):
            gd, gpos = _general_gd(pos, nbr if name == "nbr" else None, x, g,
                                   w, need_gx, "bf16", tier=tier)
            torch.cuda.synchronize()
            assert torch.equal(gpos, runs[need_gx][0][0])
            if name == "nbr":
                geometry = cf._slot_geometry(pos, nbr.idx, nbr.mask, w[3],
                                             w[4], RCUT)
                live = nbr.mask & (geometry[1] < RCUT)
                gd_ref, _ = cf._slot_gd(geometry,
                                        cf._gather_rows(x, nbr.idx),
                                        g[:, :, None, :], *w, "bf16")
            else:
                geometry = cd._pair_geometry(pos, w[3], w[4], RCUT)
                eye = torch.eye(x.shape[1], dtype=torch.bool, device=dev)
                live = (geometry[1] < RCUT) & ~eye
                gd_ref, _ = cd._pair_gd(geometry, x, g, *w, "bf16",
                                        need_gx=False)
            assert bool((gd[~live] == 0.0).all()), name
            assert bool(torch.isfinite(gd).all()), name
            assert _rel(gd, gd_ref) <= bounds["bwd"], name


# The streamed family (bf16 widths whose bf16 weights do not fit whole in a
# block's shared memory: the tensor-core tiles with the weights streamed in
# panels, tier 3): the Open Catalyst SchNet's F 256 R 200, F 320 R 17
# (just past F 300 R 17, the widest staged one there), F 640 R 8 and F 64
# R 3000 (a lone wide R).
STREAMED_WIDTHS = [(256, 200), (320, 17), (640, 8), (64, 3000)]


@pytest.mark.parametrize("f,r", STREAMED_WIDTHS)
def test_streamed_bf16_kernels_on_the_tensor_core_tiles(dev, f, r):
    """The streamed family at bf16: routed to ("streamed", "bf16"), the
    library's layout 1 (panels) equal to the mirror's, the checks of
    _check_mma_tiles on tier 3, and every launch on the streamed family's
    counters."""
    from flashmd_tpu_torch.ops import cfconv_general as cg
    from flashmd_tpu_torch.ops._build import load

    assert cg.route(f, r, "bf16") == ("streamed", "bf16")
    assert cg.mma_layout(f, r) == "panels"
    fq, rq = -(-f // 16) * 16, -(-r // 16) * 16
    assert load().cfconv_general_mma_layout(fq, rq) == 1
    assert all(load().cfconv_general_mma_warps(kind, fq, rq) >= 1
               for kind in (0, 1, 2))
    _reset_family_counts()
    _check_mma_tiles(dev, f, r, 3)
    counts = _family_counts()
    assert all(counts[f"{path}_{kind}_streamed"] > 0
               for path in ("dense_cfconv", "cfconv")
               for kind in ("fwd", "bwd"))
    assert not any(v for k, v in counts.items()
                   if not k.endswith("_streamed"))


@pytest.mark.parametrize("f,r", [(256, 50), (64, 300), (300, 17)])
def test_streamed_tiles_are_bitwise_the_staged_ones(dev, f, r):
    """At widths whose weights fit whole, the streamed tiles (tier 3,
    called directly) run gm_*'s products in the same k order: every
    output of the dense and neighbour-matrix forward and backward (gd, gpos
    and gx) is bitwise the staged tiles' (tier 2), and the library's layout
    there is 0 (staged)."""
    from flashmd_tpu_torch.ops import cfconv_general as cg
    from flashmd_tpu_torch.ops._build import load
    from flashmd_tpu_torch.ops._launch import _ptr, _stream

    assert cg.mma_layout(f, r) == "staged"
    fq, rq = -(-f // 16) * 16, -(-r // 16) * 16
    assert load().cfconv_general_mma_layout(fq, rq) == 0
    pos, x, g, w, nbr = _nbr_tc_case(dev, 70, 32, True, f=f, r=r)
    wg = cg.general_weights(*w[:4], "bf16", tensor_cores=True)
    xp, gp = cg.pad_features(x, fq), cg.pad_features(g, fq)
    s, a = x.shape[:2]

    def fwd(tier, lists):
        out = torch.empty_like(xp)
        rc = load().cfconv_general_fwd(
            int(lists is not None), _ptr(pos),
            *(_ptr(t) for t in (lists or (None, None))), _ptr(xp),
            *cg._weight_ptrs(wg, w[4]), _ptr(out), _ptr(None), s, a,
            nbr.idx.shape[-1] if lists else 0, fq, r, rq, RCUT, tier,
            _stream())
        assert rc == 0
        return (out,)

    def bwd(tier, lists):
        outs = []
        for need_gx in (True, False):
            k = nbr.idx.shape[-1] if lists else 0
            gd = torch.full((s, a, k or a), float("nan"), device=dev)
            gpos = torch.empty_like(pos)
            gx = torch.empty_like(gp) if need_gx else None
            rc = load().cfconv_general_bwd(
                int(lists is not None), _ptr(pos),
                *(_ptr(t) for t in (lists or (None,) * 4)), _ptr(xp),
                _ptr(gp), *cg._weight_ptrs(wg, w[4]), _ptr(gd), _ptr(gpos),
                _ptr(gx), _ptr(None), s, a, k, fq, r, rq, RCUT, tier,
                _stream())
            assert rc == 0
            outs += [gd, gpos] + ([gx] if need_gx else [])
        return tuple(outs)

    lists = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    staged, streamed = ((*fwd(t, None), *fwd(t, lists[:2]), *bwd(t, None),
                         *bwd(t, lists)) for t in (2, 3))
    torch.cuda.synchronize()
    assert len(staged) == len(streamed) == 12
    for k, p in zip(streamed, staged):
        assert bool(torch.isfinite(k).all()) and torch.equal(k, p)


@pytest.mark.parametrize("f,r", [(64, 300), (256, 50)])
def test_general_kernels_bf16x3_is_fp32(dev, f, r):
    """The general-width kernels at bf16x3 are bitwise their fp32 tier, as
    the reference computes these kernels at float32."""
    pos, x, g, w, nbr = _nbr_tc_case(dev, 70, 32, True, f=f, r=r)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)

    def run(precision):
        return (cd.dense_cfconv_fwd(pos, x, *w, RCUT, precision),
                *cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, precision),
                cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, precision),
                *cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, precision))

    for k, p in zip(run("bf16x3"), run("fp32")):
        assert torch.equal(k, p)


def _width_field(device, f, r, message_passing, precision="bf16", **kw):
    """The zoo's chain (priors, configurations, capacity) with a SchNet of
    hidden_channels = num_filters = f and num_rbf = r from SchNetConfig and
    init_schnet on a seeded generator."""
    import dataclasses

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.schnet import init_schnet
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(message_passing=message_passing,
                                  precision=precision, device=device, **kw)
    cfg = dataclasses.replace(ff.schnet_config, hidden_channels=f,
                              num_filters=f, num_rbf=r)
    params = init_schnet(cfg, torch.Generator().manual_seed(11), device)
    ff = ff.replace(schnet_params=params, schnet_config=cfg)
    return ff, cfgs, collate(cfgs, device=device)


@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_width_field_launch_counts(dev, path):
    """3 forward + 3 backward launches of the general family per force
    evaluation of a 3-block SchNet at F 64, R 300 on the dense and the
    pallas path (and none of the tuned one), in compute_energy_forces and
    in a short simulation; the forces agree with the CPU twins'."""
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    name = "dense_cfconv" if path == "dense" else "cfconv"
    results = {}
    for device in (dev, torch.device("cpu")):
        ff, _, system = _width_field(device, 64, 300, path, n_atoms=40,
                                     batch_size=2)
        _reset_family_counts()
        for _ in range(2):
            _, forces, _ = compute_energy_forces(ff, system.pos,
                                                 system.atom_types)
        results[device.type] = (forces.cpu(), _family_counts())
    assert results["cuda"][1] == _expect_launches(64, 300, "bf16", name, 6,
                                                  6)
    assert not any(results["cpu"][1].values())
    assert bool(torch.isfinite(results["cuda"][0]).all())
    assert _rel(results["cuda"][0], results["cpu"][0]) <= 2e-3

    ff, cfgs, _ = _width_field(dev, 64, 300, path, n_atoms=40, batch_size=2)
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device=dev)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    _reset_family_counts()
    coords = sim.simulate()
    assert _family_counts() == _expect_launches(64, 300, "bf16", name, 15,
                                                15)
    assert torch.isfinite(torch.as_tensor(coords)).all()


@pytest.mark.parametrize("f,r,family", [(300, 17, "general"),
                                        (1600, 8, "streamed"),
                                        (4096, 8, "wide")])
def test_bf16_general_launches_count_on_their_family(dev, f, r, family):
    """At bf16 the tensor-core tiles count on the general family's
    counters where the weights fit whole in shared memory, on the streamed
    family's where only their panels do, and the widths where neither fits
    on the wide family's (the CUDA-core kernels at bf16); the dense and the
    neighbour-matrix forward and backward against their twins."""
    from flashmd_tpu_torch.ops import cfconv_general as cg

    assert cg.route(f, r, "bf16") == (family, "bf16")
    pos, x, g, w, nbr = _nbr_tc_case(dev, 33, 32, True, f=f, r=r)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    _reset_family_counts()
    outs = (cd.dense_cfconv_fwd(pos, x, *w, RCUT, "bf16"),
            *cd.dense_cfconv_bwd(pos, x, g, *w, RCUT, "bf16"),
            cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, RCUT, "bf16"),
            *cf.cfconv_bwd(pos, *csr, x, g, *w, RCUT, "bf16"))
    torch.cuda.synchronize()
    expect = dict.fromkeys(_family_counts(), 0)
    for name in ("dense_cfconv_fwd", "dense_cfconv_bwd", "cfconv_fwd",
                 "cfconv_bwd"):
        expect[f"{name}_{family}"] = 1
    assert _family_counts() == expect
    refs = (cd.dense_cfconv_fwd_plain(pos, x, *w, RCUT, "bf16"),
            *cd.dense_cfconv_bwd_plain(pos, x, g, *w, RCUT, "bf16"),
            cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, RCUT, "bf16"),
            *cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, RCUT,
                                 "bf16"))
    for k, p in zip(outs, refs):
        assert bool(torch.isfinite(k).all())
        assert _rel(k, p) <= BOUNDS["bf16"]["bwd"]


# --------------------------------------------------------------------------
# the exact xla path (no kernel of its own: plain PyTorch with the
# deterministic neighbour gather of ops/gather.py)
# --------------------------------------------------------------------------


def _all_counts():
    return {**ck.launch_counts(), **cd.launch_counts(), **cf.launch_counts()}


def _reset_all_counts():
    for mod in (ck, cd, cf):
        mod.reset_launch_counts()


def _xla_field(device, batch, **kw):
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(n_atoms=266, batch_size=batch,
                                  message_passing="xla", device=device, **kw)
    return ff, collate(cfgs, device=device)


def test_xla_forces_bitwise_reproducible_at_batch_128(dev):
    """Forces and energies of the full-width bf16 xla field at S = 128,
    list build included, are bitwise equal over two evaluations: the
    gather's backward is the fixed-order CSR segment sum. The path
    launches none of the port's kernels."""
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    ff, system = _xla_field(dev, 128)
    _reset_all_counts()
    e1, f1, _ = compute_energy_forces(ff, system.pos, system.atom_types)
    e2, f2, _ = compute_energy_forces(ff, system.pos, system.atom_types)
    assert torch.isfinite(f1).all()
    assert torch.equal(f1, f2) and torch.equal(e1, e2)
    assert all(v == 0 for v in _all_counts().values())


def test_xla_fp32_matches_pallas_fp32_on_one_list(dev):
    """One function, two implementations: the fp32 xla and pallas fields
    on the same weights, positions and list, within 1e-4 of max|F|."""
    import dataclasses

    from flashmd_tpu_torch.models.forcefield import (
        build_neighbors,
        compute_energy_forces,
    )

    ff, system = _xla_field(dev, 4, precision="fp32")
    pallas = ff.replace(schnet_config=dataclasses.replace(
        ff.schnet_config, message_passing="pallas"))
    nbr = build_neighbors(ff, system.pos)
    assert int(nbr.n_max.max()) <= ff.neighbor_capacity
    f_x = compute_energy_forces(ff, system.pos, system.atom_types, nbr)[1]
    f_p = compute_energy_forces(pallas, system.pos, system.atom_types,
                                nbr)[1]
    assert _rel(f_x, f_p) <= 1e-4


@pytest.mark.parametrize("images", [False, True])
def test_gather_backward_card_matches_cpu(dev, images):
    """The gather's backward on the card against the same call on the CPU,
    1e-6 of max|CPU|, on an open list and an image-replicated one."""
    import numpy as np

    from flashmd_tpu_torch.ops.gather import neighbor_gather
    from flashmd_tpu_torch.ops.neighborlist import compute_image_shifts

    gen = torch.Generator().manual_seed(0)
    if images:
        pos = 5.0 * torch.rand(8, 12, 3, generator=gen)
        kw = {"cell": 5.0 * torch.eye(3),
              "images": compute_image_shifts(5.0 * np.eye(3), 4.0)}
        capacity = 96
    else:
        pos = 12.0 * torch.rand(8, 128, 3, generator=gen)
        kw, capacity = {}, 48
    src = torch.randn(8, pos.shape[1], 128, generator=gen)
    cot = torch.randn(8, pos.shape[1], capacity, 128, generator=gen)
    out = {}
    for device in (dev, torch.device("cpu")):
        nbr = batched_radius_neighbor_matrix(
            pos.to(device), 4.0, capacity,
            **{k: (v.to(device) if torch.is_tensor(v) else v)
               for k, v in kw.items()})
        # cotangents as the xla path gives them: zero on masked slots
        g = cot.to(device) * nbr.mask[..., None]
        x = src.to(device).requires_grad_(True)
        (out[device.type],) = torch.autograd.grad(neighbor_gather(x, nbr),
                                                  x, g)
    assert _rel(out["cuda"].cpu(), out["cpu"]) <= 1e-6


def test_checkpoint_ingestion_card_matches_cpu(dev, tmp_path):
    """The helper's reference-layout checkpoint ingested on the card
    against the same ingestion on the CPU: the exact fp32 field's forces
    within 1e-5 of max|CPU|; the default field on the cheb path with the
    frontier measured on the card, its forces within 2e-3 of the same
    config's on the CPU and 2/1/1 kernel launches per evaluation (two
    blocks)."""
    import dataclasses

    from flashmd_tpu_torch.models import checkpoint_io as cio
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from tests.helpers.synthetic_checkpoint import build_synthetic_checkpoint

    info = build_synthetic_checkpoint(tmp_path, general_priors=True)
    ref = cio.load_reference_checkpoint(info["model_path"])
    cfgs = cio.load_reference_configurations(info["structures_path"])
    types = torch.tensor(info["types"])
    pos = torch.tensor(info["pos"], dtype=torch.float32)[None]

    def forces(ff, device):
        return compute_energy_forces(ff, pos.to(device),
                                     types.to(device))[1].cpu()

    exact = {d.type: forces(cio.build_forcefield(ref, cfgs[0], optimize=False,
                                                 device=d), d)
             for d in (dev, torch.device("cpu"))}
    assert _rel(exact["cuda"], exact["cpu"]) <= 1e-5

    ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs)
    cfg = ff.schnet_config
    assert (cfg.message_passing, cfg.precision) == ("cheb", "bf16")
    assert ff.schnet_params["embedding"].device.type == "cuda"
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params, cfg))
    cpu = cio.build_forcefield(ref, cfgs[0], optimize=False, device="cpu")
    cpu = cpu.replace(schnet_config=dataclasses.replace(
        cpu.schnet_config, message_passing="cheb", precision="bf16",
        cheb_order=cfg.cheb_order, cheb_order_deriv=cfg.cheb_order_deriv,
        cheb_d_min=cfg.cheb_d_min))
    cpu = cpu.replace(schnet_params=attach_cheb_fit(cpu.schnet_params,
                                                    cpu.schnet_config))
    ck.reset_launch_counts()
    f_card = forces(ff, dev)
    counts = ck.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "cheb_fwd": 2,
                      "cheb_bwd_gx": 1, "cheb_bwd_gd": 1}
    assert _rel(f_card, forces(cpu, torch.device("cpu"))) <= 2e-3


def test_pt_exchange_card_matches_cpu_without_host_sync(dev):
    """Parallel tempering's exchange on the card equals the exchange on
    the CPU for the same carry (the pallas list rebuilt from the same
    distinct positions per slot) and uniforms, at four replicas and both
    parities: permutation, list, source CSR, counters and int32 matrix
    bitwise, the rescaled velocities to 1e-6; on the card it runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so nothing in it waits
    for the card."""
    import numpy as np

    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation import PTSimulation

    betas = [2.0, 1.6, 1.3, 1.0]
    rng = np.random.default_rng(0)
    out = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=3,
                                      num_interactions=1,
                                      message_passing="pallas", device=device)
        sim = PTSimulation(friction=1.0, dt=5e-3, n_timesteps=20,
                           save_interval=10, exchange_interval=10,
                           neighbor_rebuild_interval=2, device=device)
        sim.attach_model_and_configurations(ff, cfgs, betas)
        if not out:
            s, a = sim.n_sims, sim.n_atoms
            state = {
                "pos": sim.initial_system.pos.cpu().numpy()
                + rng.normal(scale=0.3, size=(s, a, 3)),
                "vel": rng.normal(size=(s, a, 3)),
                "forces": rng.normal(size=(s, a, 3)),
                "potential": rng.normal(scale=4.0, size=s),
            }
            u = rng.uniform(size=sim._subroutine_draw_shape())
        with torch.no_grad():
            carry = sim._init_carry(sim.initial_system)
            carry.update({k: torch.tensor(v, dtype=torch.float32,
                                          device=device)
                          for k, v in state.items()})
            carry = sim._rebuild_neighbors(carry)
            u_dev = torch.tensor(u, dtype=torch.float32, device=device)
            out[device.type] = []
            for parity in (0, 1):
                carry["exchange_parity"] = torch.tensor(
                    parity, dtype=torch.int32, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    new = sim._device_subroutine(carry, u_dev)
                finally:
                    if device.type == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
                out[device.type].append(new)
    for card, cpu in zip(out["cuda"], out["cpu"]):
        for name in ("pos", "forces", "potential", "nbr_ref_pos",
                     "acceptance_matrix", "n_exchange_approved",
                     "n_exchange_attempted", "exchange_parity"):
            assert torch.equal(card[name].cpu(), cpu[name]), name
        for leaf in ("idx", "mask", "n_max", "csr_offsets", "csr_slots"):
            assert torch.equal(getattr(card["nbr"], leaf).cpu(),
                               getattr(cpu["nbr"], leaf)), leaf
        assert _rel(card["vel"].cpu(), cpu["vel"]) <= 1e-6
    # not vacuous: some swap was accepted
    assert sum(int(n["n_exchange_approved"]) for n in out["cpu"]) > 0


def test_pipelined_export_on_the_card_matches_synchronous(dev, tmp_path):
    """The export loop on the card: the pipelined order's files (with the
    checkpoints and the generator's state) are bitwise those of the
    synchronous order (a no-op host subroutine), and nothing between two
    fetches waits for the card: every launch but the one that reads the
    throughput fence, and every launch's copy to the host, runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import pathlib

    import numpy as np

    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation import LangevinSimulation
    from flashmd_tpu_torch.simulation import base

    ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2,
                                  message_passing="cheb", device=dev)
    guarded = []

    class NoSyncCopy(base.HostCopy):
        def __init__(self, tensors, stream=None):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super().__init__(tensors, stream)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def run(tag, **extra):
        sim = LangevinSimulation(
            dt=0.004, friction=1.0, n_timesteps=40, save_interval=5,
            export_interval=20, max_steps_per_launch=10, save_forces=True,
            save_energies=True, create_checkpoints=True, random_seed=5,
            filename="t", output_dir=str(tmp_path / tag), device=dev,
            **extra)
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
        launch = sim._launch

        def no_sync_launch(carry, gen, step, n_frames, halfway):
            if (sim._warmup_end_time is None
                    and step + (n_frames - 1) * sim.save_interval >= halfway):
                return launch(carry, gen, step, n_frames, halfway)
            guarded.append(step)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return launch(carry, gen, step, n_frames, halfway)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        sim._launch = no_sync_launch
        sim.simulate()
        return tmp_path / tag

    original = base.HostCopy
    base.HostCopy = NoSyncCopy
    try:
        piped = run("pipelined")
    finally:
        base.HostCopy = original
    assert guarded == [0, 10, 30]
    sync = run("synchronous", sim_subroutine=lambda carry: carry,
               sim_subroutine_interval=20)
    names = sorted(p.name for p in piped.iterdir()
                   if p.suffix in (".npy", ".npz"))
    assert names == sorted(p.name for p in sync.iterdir()
                           if p.suffix in (".npy", ".npz"))
    assert "t_checkpoint_0001.npz" in names and "t_forces_0001.npy" in names
    for name in names:
        a, b = np.load(piped / name), np.load(sync / name)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(a, b)
        else:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    assert pathlib.Path(piped / "t_specialized_model_and_config.pkl").exists()


def test_cli_on_the_card_matches_the_engine(dev, tmp_path, monkeypatch):
    """The command line (flashmd-torch-langevin's main) on the helper's
    reference checkpoint, on the card by default: the cheb path, and the
    final positions bitwise those of the engine driven directly with the
    YAML's options and the command line's build_forcefield arguments."""
    import numpy as np

    from flashmd_tpu_torch.models import checkpoint_io as cio
    from flashmd_tpu_torch.simulation import scripts
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
    from flashmd_tpu_torch.utils.io import dump_yaml
    from tests.helpers.synthetic_checkpoint import build_synthetic_checkpoint

    info = build_synthetic_checkpoint(tmp_path)
    opts = {"friction": 1.0, "n_timesteps": 40, "dt": 0.004,
            "save_interval": 10, "random_seed": 7, "export_interval": 20,
            "filename": "cli", "output_dir": str(tmp_path / "cli")}
    dump_yaml(tmp_path / "config.yaml",
              {"simulation": opts, "betas": [1.67],
               "model_file": info["model_path"],
               "structure_file": info["structures_path"]})
    monkeypatch.setattr("sys.argv", ["flashmd-torch-langevin", "--config",
                                     str(tmp_path / "config.yaml")])
    sim = scripts.nvt_langevin_main()
    assert sim.device.type == "cuda"
    assert sim.model.schnet_config.message_passing == "cheb"
    ref = cio.load_reference_checkpoint(info["model_path"])
    structures = cio.load_reference_configurations(info["structures_path"])
    ff = cio.build_forcefield(ref, structures[0],
                              tune_configurations=structures, device=dev)
    direct = LangevinSimulation(**{**opts, "output_dir": str(tmp_path / "d"),
                                   "device": dev})
    direct.attach_model_and_configurations(ff, structures, 1.67)
    direct.simulate()
    assert torch.equal(direct.final_carry["pos"], sim.final_carry["pos"])
    assert np.array_equal(direct.coords, sim.coords)


@pytest.mark.parametrize("mp", ["cheb", "pallas", "dense", "xla"])
def test_mixed_batch_card_matches_cpu(dev, mp):
    """A mixed batch (2 x 40 + 2 x 70 beads of the zoo, one network, the
    priors stacked, padded to 70) on the card against the CPU plain path:
    forces within the bf16 bound, the padded rows' forces exactly 0 on
    the card, the cheb kernels launched 3/2/1 once."""
    from flashmd_tpu_torch.data.system import collate_padded
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import (
        compute_energy_forces,
        stack_forcefields,
    )
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    results = {}
    for device in (dev, torch.device("cpu")):
        ffs, cfgs = [], []
        for a in (40, 40, 70, 70):
            ff, c = cgschnet_1enh_like(
                n_atoms=a, batch_size=1, message_passing=mp, cheb_order=64,
                cheb_order_deriv=64, cheb_d_min=2.0, neighbor_capacity=40,
                device=device)
            ffs.append(ff)
            cfgs += c
        mixed = stack_forcefields(ffs)
        if mp == "cheb":
            mixed = mixed.replace(schnet_params=attach_cheb_fit(
                mixed.schnet_params, mixed.schnet_config))
        system = collate_padded(cfgs, device=device)
        ck.reset_launch_counts()
        _, forces, _ = compute_energy_forces(mixed, system.pos,
                                             system.atom_types,
                                             atom_mask=system.atom_mask)
        results[device.type] = (forces.cpu(), ck.launch_counts())
    f_k, f_p = results["cuda"][0], results["cpu"][0]
    assert bool(torch.isfinite(f_k).all())
    assert torch.all(f_k[:2, 40:] == 0.0)
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(f_k, f_p) <= 2e-3
    cheb = {"cheb_fwd": 3, "cheb_bwd_gx": 2, "cheb_bwd_gd": 1}
    assert results["cuda"][1] == {**dict.fromkeys(ck.launch_counts(), 0),
                                  **(cheb if mp == "cheb" else {})}


def test_radius_engine_matches_its_twin(dev):
    """The host cell-list engine, built with g++ on the card's machine,
    against its numpy twin: counts open and under a cubic cell, and the
    pairs, on the zoo's 266-bead start."""
    import numpy as np

    from flashmd_tpu_torch import native
    from flashmd_tpu_torch.models.zoo import random_cg_protein

    native.build(force=True)
    pos = random_cg_protein(n_atoms=266, seed=0).pos
    for cell in (None, 60.0 * np.eye(3)):
        p = pos if cell is None else np.mod(pos, 60.0)
        assert np.array_equal(native.neighbor_counts(p, 11.0, cell),
                              native.neighbor_counts(p, 11.0, cell,
                                                     native=False))
    got, want = (native.radius_pairs(pos, 11.0, native=use)
                 for use in (True, False))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _mesh_run(mesh):
    """PT on the zoo's 64-bead cheb field at fp32, two betas over two
    structures (four slots), 40 steps, exchanging every 5. At bf16 a
    sharded run is not bitwise at this size: cuBLAS takes other GEMM
    kernels for each rank's fewer rows, and a last-bit difference can move
    a bf16 cast (chip_smoke.py's mesh phase prints it; at 126 slots of 266
    beads the runs are bitwise)."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.simulation import PTSimulation

    ff, cfgs = cgschnet_1enh_like(n_atoms=64, batch_size=2,
                                  precision="fp32", message_passing="cheb",
                                  device="cuda")
    sim = PTSimulation(friction=1.0, dt=0.004, n_timesteps=40,
                       save_interval=10, exchange_interval=5, random_seed=9,
                       device="cuda", gptq=None, mesh=mesh)
    sim.attach_model_and_configurations(ff, cfgs, [1.67, 1.5])
    sim.simulate()
    carry = sim.final_carry
    return {"coords": sim.coords, "acceptance": sim.simulated_acceptance,
            **{k: carry[k].cpu().numpy() for k in (
                "pos", "acceptance_matrix", "n_exchange_approved")}}


def _mesh_rank_main(mode, out):
    """One rank under torch.distributed.run: "nccl" (one rank; mesh="auto"
    joins an NCCL group) or "gloo" (the ranks share this card over gloo);
    rank 0 saves the sharded run."""
    import numpy as np

    from flashmd_tpu_torch.parallel import mesh as mesh_mod

    if mode == "gloo":
        mesh_mod.initialize_distributed(backend="gloo")
    got = _mesh_run("auto")
    if mesh_mod.is_io_process():
        np.savez(out, **got)
    torch.distributed.destroy_process_group()


def _launch_ranks(mode, nproc, out):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", os.path.abspath(__file__),
         "--mesh-rank", mode, str(out)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_mesh_auto_one_nccl_rank_is_bitwise_the_run_without(dev, tmp_path):
    """PT through mesh="auto" on one NCCL rank under torch.distributed.run
    equals the same run without a mesh in this process, bitwise."""
    import numpy as np

    _launch_ranks("nccl", 1, tmp_path / "nccl.npz")
    got = dict(np.load(tmp_path / "nccl.npz"))
    for k, v in _mesh_run(None).items():
        assert np.array_equal(got[k], v), k


def test_mesh_two_gloo_ranks_share_the_card(dev, tmp_path):
    """Two ranks on this card over gloo with CUDA tensors: PT within the
    JAX suite's bounds of the one-process run (rtol 1e-5, atol 1e-6), the
    acceptance counts and matrix exactly equal."""
    import numpy as np

    _launch_ranks("gloo", 2, tmp_path / "gloo.npz")
    got = dict(np.load(tmp_path / "gloo.npz"))
    want = _mesh_run(None)
    np.testing.assert_allclose(got["coords"], want["coords"], rtol=1e-5,
                               atol=1e-6)
    for k in ("acceptance", "acceptance_matrix", "n_exchange_approved"):
        assert np.array_equal(got[k], want[k]), k


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--mesh-rank"]:
        _mesh_rank_main(*sys.argv[2:])
