"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel against its plain PyTorch twin on the card, the launch
counters on the main path, bitwise reproducibility and the wrappers'
refusals. Without a card every test skips (decided in a fixture, so every
xdist worker collects the same tests). On the GPU machine, which has no
JAX, run them without the JAX suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports no JAX.
"""

import pytest
import torch

from flashmd_tpu_torch.ops import cheb_kernel as ck

pytestmark = pytest.mark.cuda

RCUT = 10.0
# max|kernel - plain| / max|plain|, as chip_smoke.py: the JAX suite's fp32
# kernel tolerances; bf16 differs only by summation order and recurrence ulps.
BOUNDS = {"fp32": {"fwd": 1e-5, "bwd": 1e-4}, "bf16": {"fwd": 2e-3,
                                                         "bwd": 2e-3}}


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


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
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
    args = (t["pos"], t["g"], RCUT, precision, d_min, w_lin)
    gx = ck.cheb_conv_bwd_gx(t["c"], t["w0"], *args)
    gx_ref = ck.cheb_conv_bwd_gx_plain(t["c"], t["w0"], *args)
    assert _rel(gx, gx_ref) <= BOUNDS[precision]["bwd"]
    args = (t["c2"], t["pos"], t["x"], t["g"], RCUT, precision, d_min)
    gpos = ck.cheb_conv_bwd_gd(*args)
    gpos_ref = ck.cheb_conv_bwd_gd_plain(*args)
    torch.cuda.synchronize()
    assert _rel(gpos, gpos_ref) <= BOUNDS[precision]["bwd"]


def test_gd_bitwise_reproducible(dev):
    t = _inputs(dev, 2, 90, 64, 8, 16, seed=1)
    args = (t["c2"], t["pos"], t["x"], t["g"], RCUT, "bf16", 2.0)
    first = ck.cheb_conv_bwd_gd(*args)
    for _ in range(3):
        assert torch.equal(ck.cheb_conv_bwd_gd(*args), first)


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
    with pytest.raises(NotImplementedError):
        ck.cheb_conv_fwd(t["c"], t["w0"], t["pos"], t["x"], RCUT, "bf16x3")


def test_main_path_launch_counts(dev):
    """3 cheb_fwd + 2 cheb_bwd_gx + 1 cheb_bwd_gd per force evaluation of
    a 3-block model; the forces agree with the CPU plain path."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    results = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(n_atoms=40, batch_size=2, device=device)
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                      ff.schnet_config))
        system = collate(cfgs, device=device)
        ck.reset_launch_counts()
        for _ in range(2):
            _, forces, _ = compute_energy_forces(ff, system.pos,
                                                 system.atom_types)
        results[device.type] = (forces.cpu(), ck.launch_counts())
    assert results["cuda"][1] == {"cheb_fwd": 6, "cheb_bwd_gx": 4,
                                  "cheb_bwd_gd": 2}
    assert results["cpu"][1] == {"cheb_fwd": 0, "cheb_bwd_gx": 0,
                                 "cheb_bwd_gd": 0}
    f_k, f_p = results["cuda"][0], results["cpu"][0]
    # bf16 model: summation order on the card vs the CPU only
    assert _rel(f_k, f_p) <= 2e-3
