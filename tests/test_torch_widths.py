"""Port parity for the exact-filter CFConv paths (``message_passing`` "dense"
and "pallas") at widths other than the zoo's F = 128, R = 50: the plain
twins of flashmd_tpu_torch/ops/cfconv_dense.py and ops/cfconv.py (forward,
and the VJP with and without gx, fp32 and bf16) against the JAX Pallas
kernels in interpret mode; the SchNet dense and pallas branches at SchNet's
published widths (F 64, R 300), at F 256, R 50 and at the Open Catalyst
SchNet's (hidden 1,024, F 256, R 200; forces, then BAOAB steps with the
reference's noise injected) against the JAX package through
``forcefield_from_numpy``; the tuned kernels' zero padding
(ops/cfconv_general.py ``tuned_operands``: the twin on padded operands
against the twin on the originals); and the route between the tuned and
the general-width kernels at each width and precision.

On the card the tuned kernels take F <= 128, R <= 64 (padded to F = 128)
and the general-width kernels every other width; their kernels run only
there (tests/test_torch_cuda.py). Here the wrappers take their twins, and
the JAX side runs as its own tests run it on the CPU.
Tolerances, on max|port - jax| / max|jax| (those of test_torch_cfconv.py):
  * fp32: 1e-5 (summation order only);
  * bf16: 2e-3 (the same rounding points; summation order).
The padding identity: 1e-6 (fp32) and 2e-3 (bf16) of max|twin|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.ops.neighborlist import (
    batched_radius_neighbor_matrix as jbatched,
)
from flashmd_tpu.ops.pallas.cfconv import (
    fused_cfconv_message as jfused_cfconv_message,
)
from flashmd_tpu.ops.pallas.cfconv_dense import (
    dense_cfconv_message as jdense_cfconv_message,
)
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.mlp import round_bf16
from flashmd_tpu_torch.ops import cfconv as cf
from flashmd_tpu_torch.ops import cfconv_dense as cd
from flashmd_tpu_torch.ops import cfconv_general as cg
from flashmd_tpu_torch.ops.neighborlist import batched_radius_neighbor_matrix
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = 29  # JAX pads to a multiple of 8: padding is exercised
S = 2
RCUT = 4.0
CAPACITY = 32  # holds every neighbour: a symmetric list
# (F, R): SchNet's published widths, F 96 (padded onto the tuned kernels on
# the card), F 256, and a width that is no multiple of 64 with R > 64.
WIDTHS = [(64, 300), (96, 50), (256, 50), (100, 70)]
TOL = {"fp32": 1e-5, "bf16": 2e-3}
PAD_TOL = {"fp32": 1e-6, "bf16": 2e-3}


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()


def _inputs(f, r, seed):
    rng = np.random.default_rng(seed)
    offset = np.linspace(0.0, RCUT, r).astype(np.float32)
    return {
        # a box of side 6 around rc = 4: pairs inside and outside the cutoff
        "pos": rng.uniform(0.0, 6.0, (S, A, 3)).astype(np.float32),
        "x": rng.normal(size=(S, A, f)).astype(np.float32),
        "g": rng.normal(size=(S, A, f)).astype(np.float32),
        "w0": (rng.normal(size=(r, f)) / np.sqrt(r)).astype(np.float32),
        "b0": (0.1 * rng.normal(size=f)).astype(np.float32),
        "w1": (rng.normal(size=(f, f)) / np.sqrt(f)).astype(np.float32),
        "offset": offset,
        "coeff": np.float32(-0.5 / float(offset[1] - offset[0]) ** 2),
    }


def _weights(tt):
    return (tt["w0"], tt["b0"], tt["w1"], tt["offset"], tt["coeff"])


@functools.cache
def _case(path, f, r, precision):
    """(torch inputs, port list or None, JAX out, gpos, gx) of one path,
    width and tier: the JAX message and its VJP on the same numpy inputs,
    computed once per module."""
    t = _inputs(f, r, seed=f + r)
    jw = (jnp.asarray(t["w0"]), jnp.asarray(t["b0"]), jnp.asarray(t["w1"]),
          (jnp.asarray(t["offset"]), jnp.asarray(t["coeff"])))
    tn = None
    if path == "dense":
        def one(p, x):
            return jdense_cfconv_message(p, x, *jw, RCUT, 8, precision)
        fn = jax.vmap(one)
    else:
        jn = jbatched(jnp.asarray(t["pos"]), RCUT + 0.5, CAPACITY)
        tn = batched_radius_neighbor_matrix(torch.tensor(t["pos"]),
                                            RCUT + 0.5, CAPACITY)
        assert int(tn.n_max.max()) <= CAPACITY

        def one(p, idx, mask, x):
            return jfused_cfconv_message(p, idx, mask.astype(jnp.float32), x,
                                         *jw, RCUT, 8, precision)
        fn = (lambda p, x: jax.vmap(one)(p, jn.idx, jn.mask, x))
    out, vjp = jax.vjp(fn, jnp.asarray(t["pos"]), jnp.asarray(t["x"]))
    gpos, gx = vjp(jnp.asarray(t["g"]))
    tt = {k: torch.tensor(v) for k, v in t.items()}
    return tt, tn, np.asarray(out), np.asarray(gpos), np.asarray(gx)


def _port_fwd(path, tt, tn, precision):
    if path == "dense":
        return cd.dense_cfconv_fwd(tt["pos"], tt["x"], *_weights(tt), RCUT,
                                   precision)
    return cf.cfconv_fwd(tt["pos"], tn.idx, tn.mask, tt["x"], *_weights(tt),
                         RCUT, precision)


def _port_bwd(path, tt, tn, precision, need_gx):
    if path == "dense":
        return cd.dense_cfconv_bwd(tt["pos"], tt["x"], tt["g"],
                                   *_weights(tt), RCUT, precision,
                                   need_gx=need_gx)
    return cf.cfconv_bwd(tt["pos"], tn.idx, tn.mask, tn.csr_offsets,
                         tn.csr_slots, tt["x"], tt["g"], *_weights(tt), RCUT,
                         precision, need_gx=need_gx)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("f,r", WIDTHS)
@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_twin_fwd_matches_jax(path, f, r, precision):
    tt, tn, ref, _, _ = _case(path, f, r, precision)
    out = _port_fwd(path, tt, tn, precision)
    assert out.shape == (S, A, f)
    assert _rel(out.numpy(), ref) <= TOL[precision]


@pytest.mark.parametrize("need_gx", [True, False], ids=["gx", "no_gx"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("f,r", WIDTHS)
@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_twin_vjp_matches_jax(path, f, r, precision, need_gx):
    tt, tn, _, gpos_ref, gx_ref = _case(path, f, r, precision)
    gpos, gx = _port_bwd(path, tt, tn, precision, need_gx)
    assert _rel(gpos.numpy(), gpos_ref) <= TOL[precision]
    if need_gx:
        assert gx.shape == (S, A, f)
        assert _rel(gx.numpy(), gx_ref) <= TOL[precision]
    else:
        assert gx is None


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("f,r", [(64, 32), (96, 50), (100, 64)])
@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_padding_to_the_tuned_width_is_exact(path, f, r, precision):
    """The twin on operands zero-padded to F = 128 by tuned_operands (as
    the wrappers hand them to the tuned kernels) equals the twin on the
    originals once its outputs are sliced back to F; the padded columns
    come out exactly zero."""
    t = _inputs(f, r, seed=3 * f + r)
    tt = {k: torch.tensor(v) for k, v in t.items()}
    w0, b0, w1, offset, coeff = _weights(tt)
    (xp, gp), w0p, b0p, w1p = cg.tuned_operands((tt["x"], tt["g"]), w0, b0,
                                                w1)
    assert xp.shape == (S, A, cg.TUNED_F) and w1p.shape == (128, 128)
    assert w0p.shape == (r, 128) and b0p.shape == (128,)
    pos = tt["pos"]
    if path == "dense":
        fwd = cd.dense_cfconv_fwd_plain
        bwd = cd.dense_cfconv_bwd_plain
        lst = ()
    else:
        tn = batched_radius_neighbor_matrix(pos, RCUT + 0.5, CAPACITY)
        fwd, bwd, lst = cf.cfconv_fwd_plain, cf.cfconv_bwd_plain, (tn.idx,
                                                                   tn.mask)
    out = fwd(pos, *lst, tt["x"], w0, b0, w1, offset, coeff, RCUT, precision)
    out_p = fwd(pos, *lst, xp, w0p, b0p, w1p, offset, coeff, RCUT, precision)
    gpos, gx = bwd(pos, *lst, tt["x"], tt["g"], w0, b0, w1, offset, coeff,
                   RCUT, precision)
    gpos_p, gx_p = bwd(pos, *lst, xp, gp, w0p, b0p, w1p, offset, coeff, RCUT,
                       precision)
    assert not bool(out_p[..., f:].any()) and not bool(gx_p[..., f:].any())
    for k, p in ((out_p[..., :f], out), (gpos_p, gpos), (gx_p[..., :f], gx)):
        assert _rel(k.numpy(), p.numpy()) <= PAD_TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
def test_route_at_each_width(precision):
    """F <= 128 and R <= 64 take the tuned kernels (padded to 128), every
    other width the general ones; bf16x3 runs these kernels at fp32. At
    bf16 the general family is the tensor-core tiles with the weights
    staged whole, which take F 300, R 17 with one warp a block (229,184 of
    the 232,448 bytes); the widths whose bf16 weights do not fit there go
    to the same tiles with the weights streamed in panels, the "streamed"
    family (F 256, R 200: the Open Catalyst SchNet's filter; F 320, R 17;
    F 640, R 8), up to the widest whose panel buffers and one warp of the
    dense backward with gx fit (F 4,048 at R 8, 3,920 at R 200, R 5,776 at
    F 64); beyond, the CUDA-core kernels at bf16, the "wide" family. A
    width on each side of each boundary."""
    tier = "bf16" if precision == "bf16" else "fp32"
    expect = {(128, 50): "tuned", (128, 64): "tuned", (64, 32): "tuned",
              (96, 50): "tuned", (1, 1): "tuned", (64, 300): "general",
              (256, 50): "general", (128, 100): "general",
              (100, 70): "general", (129, 1): "general",
              (128, 65): "general", (300, 17): "general"}
    streamed = {(320, 17), (256, 200), (640, 8), (1600, 8), (2900, 8),
                (64, 3000), (4048, 8), (3920, 200), (64, 5776)}
    wide = {(4049, 8), (4096, 8), (3921, 200), (64, 5777)}
    for f, r in streamed:
        expect[f, r] = "streamed" if tier == "bf16" else "general"
    for f, r in wide:
        expect[f, r] = "wide" if tier == "bf16" else "general"
    for (f, r), family in expect.items():
        assert cg.route(f, r, precision) == (family, tier)
    assert cg.mma_smem_bytes(300, 17) == 229184 <= cg.SMEM_MAX
    assert cg.mma_smem_bytes(256, 50) == 187136
    assert all(cg.mma_smem_bytes(f, r) > cg.SMEM_MAX
               for f, r in streamed | wide)
    # the byte mirror of the streamed tiles: F 256 R 200 needs 268,352 B
    # with its weights whole, 41,792 with the two panel buffers (18,432 B),
    # b0 and the offsets (1,856) and one warp of the dense backward with gx
    # (21,504); the widest widths the panels take fill all but a few bytes
    assert cg.mma_smem_bytes(256, 200) == 268352
    assert cg.mma_smem_bytes(256, 200, "panels") == 18432 + 1856 + 21504
    assert cg.mma_smem_bytes(4048, 8, "panels") == 232064
    assert cg.mma_smem_bytes(3920, 200, "panels") == 232320
    assert cg.mma_smem_bytes(64, 5776, "panels") == 232256
    assert all(cg.mma_smem_bytes(f, r, "panels") > cg.SMEM_MAX
               for f, r in wide)
    assert [cg.mma_layout(f, r) for f, r in
            ((300, 17), (320, 17), (256, 200), (4048, 8), (4049, 8))] == [
                "staged", "panels", "panels", "panels", "none"]
    # the CUDA-core tiles' layout (fp32, and the wide bf16 family): w0 and
    # w1 staged whole where they fit beside 4 warps of the dense backward
    # with gx, else streamed in panels where 2 warps fit, else the first
    # design's kernels ("l2"); a width on each side of each boundary
    layouts = {(64, 300): "staged", (128, 100): "staged",
               (100, 70): "staged", (128, 104): "staged",
               (128, 105): "panels", (256, 50): "panels",
               (129, 1): "panels", (300, 17): "panels", (576, 8): "panels",
               (577, 8): "l2", (1600, 8): "l2", (2900, 8): "l2"}
    for (f, r), layout in layouts.items():
        assert cg.ffma_layout(f, r) == layout
    # the byte mirror: F 64 R 300 stages 100,544 B of weights (w0 [300][68],
    # w1 [64][68], b0, offsets [320]) beside 4 warps of 13,824 B
    assert cg.ffma_warp_bytes(64) == 13824
    assert cg.ffma_smem_bytes(64, 300, "staged") == 100544 + 4 * 13824
    assert cg.ffma_smem_bytes(128, 104, "staged") == 232064 <= cg.SMEM_MAX
    assert cg.ffma_smem_bytes(128, 105, "staged") == 234176 > cg.SMEM_MAX
    assert cg.ffma_smem_bytes(256, 50, "panels") == 38144 + 2 * 45568
    assert cg.ffma_smem_bytes(576, 8, "panels") <= cg.SMEM_MAX
    assert cg.ffma_smem_bytes(577, 8, "panels") > cg.SMEM_MAX


def test_general_weights_layout():
    """The general-width kernels' weights: zero-padded to Fp = F rounded
    up to 64 and Rq = R rounded up to 64; w0 and w1 rounded to bf16 at that
    tier only; their transposes only where the layout is "l2" (F 600, R 8:
    the first design's backward reads them), not where the weights are
    staged (F 100, R 70)."""
    for (f, r), fp, rq in (((100, 70), 128, 128), ((600, 8), 640, 64)):
        t = _inputs(f, r, seed=1)
        tt = {k: torch.tensor(v) for k, v in t.items()}
        l2 = cg.ffma_layout(f, r) == "l2"
        assert l2 == (f == 600)
        for precision in ("fp32", "bf16"):
            wg = cg.general_weights(tt["w0"], tt["b0"], tt["w1"],
                                    tt["offset"], precision)
            assert sorted(wg) == sorted(["w0", "b0", "w1", "off"]
                                        + (["w0t", "w1t"] if l2 else []))
            assert wg["w0"].shape == (rq, fp) and wg["w1"].shape == (fp, fp)
            assert wg["off"].shape == (rq,) and wg["b0"].shape == (fp,)
            assert all(v.is_contiguous() for v in wg.values())
            op = cf._op
            assert torch.equal(wg["w0"][:r, :f], op(tt["w0"], precision))
            assert torch.equal(wg["w1"][:f, :f], op(tt["w1"], precision))
            if l2:
                assert torch.equal(wg["w0t"], wg["w0"].T)
                assert torch.equal(wg["w1t"], wg["w1"].T)
            assert torch.equal(wg["b0"][:f], tt["b0"])
            assert torch.equal(wg["off"][:r], tt["offset"])
            for k, v in wg.items():
                mask = torch.ones_like(v, dtype=torch.bool)
                if k in ("b0", "off"):
                    mask[:(f if k == "b0" else r)] = False
                else:
                    rows, cols = {"w0": (r, f), "w0t": (f, r),
                                  "w1": (f, f), "w1t": (f, f)}[k]
                    mask[:rows, :cols] = False
                assert not bool(v[mask].any())


@pytest.mark.parametrize("f,r", [(64, 300), (256, 50), (100, 70),
                                 (129, 2), (300, 17)])
def test_tensor_core_weights_layout(f, r):
    """The tensor-core tiles' weights: w0 [Rq, Fq] and w1 [Fq, Fq] in
    bfloat16 equal to round_bf16 of the parameters, b0 [Fq] and the offsets
    [Rq] float32 as they are, zero-padded (Fq, Rq: F, R rounded up to 16),
    no transposes, each contiguous."""
    t = _inputs(f, r, seed=5 * f + r)
    tt = {k: torch.tensor(v) for k, v in t.items()}
    fq, rq = -(-f // 16) * 16, -(-r // 16) * 16
    wg = cg.general_weights(tt["w0"], tt["b0"], tt["w1"], tt["offset"],
                            "bf16", tensor_cores=True)
    assert sorted(wg) == ["b0", "off", "w0", "w1"]
    assert all(v.is_contiguous() for v in wg.values())
    shapes = {"w0": (rq, fq), "w1": (fq, fq), "b0": (fq,), "off": (rq,)}
    for k, shape in shapes.items():
        assert tuple(wg[k].shape) == shape
        assert wg[k].dtype == (torch.bfloat16 if k in ("w0", "w1")
                               else torch.float32)
    assert torch.equal(wg["w0"][:r, :f].float(), round_bf16(tt["w0"]))
    assert torch.equal(wg["w1"][:f, :f].float(), round_bf16(tt["w1"]))
    assert torch.equal(wg["b0"][:f], tt["b0"])
    assert torch.equal(wg["off"][:r], tt["offset"])
    live = {"w0": (r, f), "w1": (f, f), "b0": (f,), "off": (r,)}
    for k, v in wg.items():
        mask = torch.ones(v.shape, dtype=torch.bool)
        mask[tuple(slice(0, n) for n in live[k])] = False
        assert not bool(v[mask].any())


def _params(f=100, r=70, seed=2):
    t = _inputs(f, r, seed=seed)
    return [torch.tensor(t[k]) for k in ("w0", "b0", "w1", "offset")]


@pytest.mark.parametrize("tensor_cores,precision",
                         [(True, "bf16"), (False, "bf16"), (False, "fp32"),
                          (False, "bf16x3")])
def test_weights_are_prepared_once(tensor_cores, precision):
    """A second call with the same parameters prepares nothing and returns
    the same tensors; other parameters of equal values are prepared anew."""
    params = _params()
    n = cg.weight_preparations()
    first = cg.general_weights(*params, precision, tensor_cores=tensor_cores)
    assert cg.weight_preparations() == n + 1
    again = cg.general_weights(*params, precision, tensor_cores=tensor_cores)
    assert cg.weight_preparations() == n + 1 and again is first
    copies = [t.clone() for t in params]
    other = cg.general_weights(*copies, precision, tensor_cores=tensor_cores)
    assert cg.weight_preparations() == n + 2 and other is not first
    for k, v in first.items():
        assert torch.equal(other[k], v)


def test_tuned_weights_are_prepared_once():
    """The tuned family's weights padded to F = 128 (tuned_operands) are
    prepared once per parameter set: a second call prepares nothing and
    returns the same tensors, equal to the ones padded anew, with x and g
    padded on each call; other parameters of equal values, or an in-place
    update, are prepared anew; F = 128 needs no padding and prepares
    nothing."""
    w0, b0, w1, _ = _params(f=96, r=50, seed=7)
    x = torch.randn(2, 5, 96)
    n = cg.weight_preparations()
    (xp,), *first = cg.tuned_operands((x,), w0, b0, w1)
    assert cg.weight_preparations() == n + 1
    (xp2,), *again = cg.tuned_operands((x,), w0, b0, w1)
    assert cg.weight_preparations() == n + 1
    assert all(u is v for u, v in zip(first, again)) and xp2 is not xp
    assert torch.equal(xp, cg.pad_features(x, 128)) and xp.shape == (2, 5,
                                                                     128)
    fresh = cg._prepare_tuned(w0, b0, w1)
    for u, k in zip(first, ("w0", "b0", "w1")):
        assert torch.equal(u, fresh[k])
    copies = [t.clone() for t in (w0, b0, w1)]
    other = cg.tuned_operands((x,), *copies)[1:]
    assert cg.weight_preparations() == n + 2
    assert all(u is not v for u, v in zip(first, other))
    w1.mul_(2.0)
    updated = cg.tuned_operands((x,), w0, b0, w1)[1:]
    assert cg.weight_preparations() == n + 3
    assert torch.equal(updated[2][:96, :96], w1)
    full = _params(f=128, r=50, seed=8)[:3]
    assert cg.tuned_operands((x,), *full)[1:] == tuple(full)
    assert cg.weight_preparations() == n + 3


@pytest.mark.parametrize("which", range(4), ids=["w0", "b0", "w1", "offset"])
@pytest.mark.parametrize("tensor_cores", [True, False])
def test_weights_see_in_place_updates(which, tensor_cores):
    """An in-place update of a parameter (its version counter moves) is
    prepared again, and the new tensors hold the new values."""
    params = _params(seed=3)
    first = cg.general_weights(*params, "bf16", tensor_cores=tensor_cores)
    kept = {k: v.clone() for k, v in first.items()}
    n = cg.weight_preparations()
    params[which].mul_(2.0)
    second = cg.general_weights(*params, "bf16", tensor_cores=tensor_cores)
    assert cg.weight_preparations() == n + 1
    fresh = cg._prepare(*params, "bf16", tensor_cores)
    for k, v in second.items():
        assert torch.equal(v, fresh[k])
    assert any(not torch.equal(second[k], kept[k]) for k in kept)


def test_weights_of_dead_or_updated_parameters_are_dropped():
    """The cache keeps one entry per live parameter set: an in-place
    update replaces its entry, and the entry goes with its parameters."""
    import gc

    params = _params(seed=6)
    ids = tuple(map(id, params))

    def entries():
        return [k for k in cg._cache if k[2:] == ids]

    cg.general_weights(*params, "bf16", tensor_cores=True)
    assert len(entries()) == 1
    params[2].mul_(2.0)
    second = cg.general_weights(*params, "bf16", tensor_cores=True)
    assert len(entries()) == 1 and cg._cache[entries()[0]][2] is second
    del params
    gc.collect()
    assert not entries()


def test_weight_tiers_are_kept_apart():
    """fp32 and bf16 of one parameter set are prepared apart (the weights
    rounded at bf16 only), and so are the CUDA-core and the tensor-core
    layouts; bf16x3 shares the fp32 tensors, as it computes at fp32."""
    params = _params(seed=4)
    n = cg.weight_preparations()
    fp32 = cg.general_weights(*params, "fp32")
    bf16 = cg.general_weights(*params, "bf16")
    mma = cg.general_weights(*params, "bf16", tensor_cores=True)
    assert cg.weight_preparations() == n + 3
    assert cg.general_weights(*params, "bf16x3") is fp32
    assert cg.weight_preparations() == n + 3
    assert torch.equal(fp32["w1"][:100, :100], params[2])
    assert torch.equal(bf16["w1"][:100, :100], round_bf16(params[2]))
    assert not torch.equal(fp32["w1"], bf16["w1"])
    assert mma["w1"].dtype == torch.bfloat16 and "w1t" not in mma
    assert (cg.general_weights(*params, "fp32"),
            cg.general_weights(*params, "bf16"),
            cg.general_weights(*params, "bf16", tensor_cores=True)) == (
                fp32, bf16, mma)
    assert cg.weight_preparations() == n + 3


def _config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# hidden_channels of a width whose SchNet has more hidden channels than
# filters: the Open Catalyst Project's SchNet baseline (Chanussot et al., ACS
# Catal. 2021, configs/s2ef/all/schnet/schnet.yml: hidden_channels 1024,
# num_filters 256, num_gaussians 200), with CGSchNet's tanh filter.
HIDDEN = {(256, 200): 1024}


@functools.cache
def _baoab_pair(path, f, r):
    """(JAX simulation, port simulation) of a 2-block fp32 SchNet at
    num_filters = f, num_rbf = r and hidden_channels HIDDEN's (else f) on
    ``path``, on the zoo's 24-bead chain, its priors and start, the same
    weights."""
    jff, jcfgs = jcgschnet(n_atoms=24, batch_size=S, num_interactions=2,
                           precision="fp32", message_passing=path,
                           neighbor_capacity=24)
    jcfg = dataclasses.replace(jff.schnet_config,
                               hidden_channels=HIDDEN.get((f, r), f),
                               num_filters=f, num_rbf=r)
    jff = jff.replace(schnet_params=jinit_schnet(jax.random.PRNGKey(f + r),
                                                 jcfg),
                      schnet_config=jcfg)
    rng = np.random.default_rng(4)
    jcfgs = [dataclasses.replace(c, velocities=rng.normal(
        scale=0.5, size=c.pos.shape)) for c in jcfgs]
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=2, save_interval=2,
                  random_seed=3, neighbor_skin=1.0,
                  neighbor_rebuild_interval=1)
    jsim = JLangevinSimulation(gptq=None, **kwargs)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity,
    )
    assert (ff.schnet_config.hidden_channels, ff.schnet_config.num_filters,
            ff.schnet_config.num_rbf, ff.schnet_config.message_passing) == (
                HIDDEN.get((f, r), f), f, r, path)
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities)
            for c in jcfgs]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    return jsim, sim


@pytest.mark.parametrize("f,r", [(64, 300), (256, 50), (256, 200)])
@pytest.mark.parametrize("path", ["dense", "pallas"])
def test_schnet_forces_and_baoab_match_jax(path, f, r):
    """The start forces, then 2 BAOAB steps with the reference's own
    normal draws injected (the pallas list rebuilt every step, as the
    reference's _step_with_hooks), fp32: 1e-5 of the largest force,
    position and velocity. F 256 R 200 with 1,024 hidden channels: the
    Open Catalyst SchNet's widths (HIDDEN), 2 of its 5 blocks."""
    jsim, sim = _baoab_pair(path, f, r)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._baoab)
    jrebuild = jax.jit(jsim._rebuild_neighbors) if path == "pallas" else None
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        assert _rel(carry["forces"].numpy(), jcarry["forces"]) <= TOL["fp32"]
        for t in range(2):
            if jrebuild is not None:
                jcarry = jrebuild(jcarry)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, torch.tensor(np.asarray(xi)),
                                         t)
    for key in ("forces", "pos", "vel"):
        assert _rel(carry[key].numpy(), jcarry[key]) <= TOL["fp32"]
