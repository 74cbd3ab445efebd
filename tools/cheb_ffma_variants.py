"""Design variants of the fp32 (CUDA-core) cheb kernels, timed on the card.

    python3 tools/cheb_ffma_variants.py

Each variant is an edited copy of flashmd_tpu_torch/csrc/cheb_kernels.cu
(text substitutions) compiled into a library of its own, in parallel with
the others; ptxas' registers and spills of its cheb_rows_ffma_kernel and
cheb_gd_ffma_kernel instantiations are printed, then cheb_fwd, cheb_bwd_gx
and cheb_bwd_gd (stacked F = 384 and one block F = 128) at fp32 on the
slice's start positions (batch 128, 266 beads), open and folded into
chip_smoke.py's per-molecule cells, on the cheb slice's (48, 64) fit and
the fp32 zoo's (128, 128) one, are held against their twins and timed
with CUDA events, the variants in turns. The variants:

* base       -- the source as it is;
* rows_minb2 -- fwd/gx with two blocks of 8 warps per SM for the
                register budget (128 registers; the source: one);
* gd_minb1   -- gd with one (the source: two);
* w4         -- blocks of 4 warps, four per SM for the register budget;
* rows_unroll1, rows_unroll2 -- the order loop of fwd/gx unrolled once
                or twice (two orders a step; the source: four times);
* gd_unroll2 -- gd's order loop unrolled twice (the source: once);
* fwd_fma_step -- the forward's recurrence step as one FMA (the source
                rounds the product and the difference apart, as the twins
                do; gx and gd take one FMA);
* geo_reg    -- the cell's lattice read into registers once per row for
                the scan;
* no_orders  -- diagnostic, wrong results: the order loop removed, so its
                time is what the scan, the epilogues and the staging cost.

Needs a CUDA card and nvcc; prints the card's name and power limit last.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from flashmd_tpu_torch.data.system import collate  # noqa: E402
from flashmd_tpu_torch.models.cheb import _lin_slope  # noqa: E402
from flashmd_tpu_torch.ops import _build  # noqa: E402
from flashmd_tpu_torch.ops import cheb_kernel as ck  # noqa: E402
from flashmd_tpu_torch.ops._launch import _ptr, _stream  # noqa: E402

SCAN = """    int n_row = 0;
    for (int j0 = 0; j0 < A; j0 += 32) {"""
SCAN_GEO = """    int n_row = 0;
    float gr[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) gr[k] = HAS_CELL ? geo[k] : 0.0f;
    for (int j0 = 0; j0 < A; j0 += 32) {"""
VARIANTS = {
    "base": {},
    "rows_minb2": {"constexpr int LF_ROWS_MINB = 1;":
                   "constexpr int LF_ROWS_MINB = 2;"},
    "gd_minb1": {"constexpr int LF_GD_MINB = 2;":
                 "constexpr int LF_GD_MINB = 1;"},
    "w4": {"constexpr int LF_W = 8;": "constexpr int LF_W = 4;",
           "LF_ROWS_MINB = 1;": "LF_ROWS_MINB = 4;",
           "LF_GD_MINB = 2;": "LF_GD_MINB = 4;"},
    "rows_unroll1": {"lf_product<4, !GX>(": "lf_product<1, !GX>("},
    "rows_unroll2": {"lf_product<4, !GX>(": "lf_product<2, !GX>("},
    "gd_unroll2": {"lf_product<1, false>(": "lf_product<2, false>("},
    "fwd_fma_step": {"lf_product<4, !GX>(": "lf_product<4, false>("},
    "geo_reg": {SCAN: SCAN_GEO,
                "lf_geom<HAS_CELL>(pi, pj, geo, valid":
                "lf_geom<HAS_CELL>(pi, pj, gr, valid"},
    "no_orders": {"(acc, ta, tb, z2, c_s + 4 * fg, M);":
                  "(acc, ta, tb, z2, c_s + 4 * fg, 0);"},
}
DIAGNOSTIC = {"no_orders"}
KERNELS = ("cheb_rows_ffma_kernel", "cheb_gd_ffma_kernel")


def build_all(tmp):
    """{variant: loaded library}; prints each variant's ptxas lines."""
    src = (_build.CSRC / "cheb_kernels.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"FAILED: {name}: substitution not found")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(tmp / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"FAILED: {name} does not build\n{log[-4000:]}")
        for line in cs.ptxas_summary(log):
            if any(k in line for k in KERNELS):
                print(f"variant {name}: {cs.ffma_label(line.split(':')[0])}"
                      f": {line.split(': ', 1)[1]}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("cheb_fwd", "cheb_bwd_gx", "cheb_bwd_gd"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases(ff, cfgs, dev, periodic):
    """{label: (C entry point, its tensor operands but the outputs, its
    other arguments, the twin's output, kind)} of one fit, open or folded
    into cells."""
    fits = ff.schnet_params["cheb_fit"]
    c, c2, w0 = fits[0]
    d_min = float(ff.schnet_config.cheb_d_min)
    w_lin = _lin_slope(c2) if d_min > 0 else None
    c2_cat = torch.cat([f[1] for f in fits], dim=1).contiguous()
    rcut = float(ff.rcut)
    cell = inv = None
    pos = collate(cfgs, device=dev).pos
    if periodic:
        cells = cs.kernel_cells(len(cfgs))
        pos = collate(cs.with_cells(cfgs, cells, folded=True), device=dev).pos
        cell = cs.kernel_cells(len(cfgs), dev)
        inv = torch.linalg.inv(cell.double()).float().contiguous()
    s, a, f = pos.shape[0], pos.shape[1], c.shape[1]
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(s, a, f, generator=gen, device=dev)
    x_cat = torch.randn(s, a, 3 * f, generator=gen, device=dev)
    q = ck._to_that_basis(c).contiguous()
    kw = {"cell": cell, "inv": inv}
    out = {}
    for fn, coef, plain in (("cheb_fwd", c, ck.cheb_conv_fwd_plain),
                            ("cheb_bwd_gx", q, ck.cheb_conv_bwd_gx_plain)):
        out[fn] = (fn, [pos, x, coef, w0, w_lin, cell, inv],
                   [s, a, f, coef.shape[0], rcut, d_min],
                   plain(c, w0, pos, x, rcut, "fp32", d_min, w_lin, **kw),
                   "rows")
    for label, cc, xx in (("cheb_bwd_gd (F=384)", c2_cat, x_cat),
                          ("cheb_bwd_gd (F=128)", c2, x)):
        ff_ = xx.shape[2]
        out[label] = ("cheb_bwd_gd", [pos, xx, xx, cc, cell, inv],
                      [s, a, ff_, cc.shape[0],
                       ck.gd_slabs(a, ff_, "fp32"), rcut, d_min],
                      ck.cheb_conv_bwd_gd_plain(cc, pos, xx, xx, rcut,
                                                "fp32", d_min, **kw), "gd")
    return out


def runner(lib, fn, tensors, ints, ref, kind):
    """A callable launching ``fn`` of ``lib`` into fresh outputs, and the
    output it writes (the callable holds every tensor it points at)."""
    out = torch.empty_like(ref)
    if kind == "rows":
        held = [*tensors, out]
    else:
        s, a, _, _, n_slabs, _, _ = ints
        held = [*tensors, torch.empty(s, a, 3, device=ref.device),
                torch.empty(s, n_slabs, a, 3, device=ref.device), out]
    args = [*map(_ptr, held), *ints]

    def call():
        assert held
        rc = getattr(lib, fn)(*args, 0, _stream())
        if rc:
            raise SystemExit(f"FAILED: {fn}: CUDA {rc}")

    return call, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build_all(Path(tempfile.mkdtemp()))
    order = [*libs, *reversed(list(libs))]  # in turns, base first and last
    for prec in ("bf16", "fp32"):
        ff, cfgs = cs._force_fields(dev, cs.BATCH, precision=prec)
        m = cs.cheb_orders(ff.schnet_config)
        for periodic in (False, True):
            for label, (fn, ptrs, ints, ref, kind) in cases(
                    ff, cfgs, dev, periodic).items():
                times = {name: [] for name in libs}
                for name in order:
                    call, out = runner(libs[name], fn, ptrs, ints, ref, kind)
                    call()
                    torch.cuda.synchronize()
                    rel = float((out - ref).abs().max() / ref.abs().max())
                    if name not in DIAGNOSTIC and rel > 1e-4:
                        raise SystemExit(f"FAILED: {name} {label}: {rel}")
                    times[name].append(cs.cuda_time_ms(call, iters=20))
                print(f"variants {label} fp32 fit {m} "
                      f"{'cell' if periodic else 'open'}: " + ", ".join(
                          f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                          for name, ts in times.items()) + " ms")
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
