"""Design variants of the fp32 (CUDA-core) cheb kernels, timed on the card.

    python3 tools/cheb_ffma_variants.py [--gxgd]

Each variant is an edited copy of flashmd_tpu_torch/csrc/cheb_kernels.cu
(text substitutions) compiled into a library of its own, in parallel with
the others; ptxas' registers and spills of its cheb_rows_ffma_kernel,
cheb_gd_ffma_kernel and cheb_gxgd_ffma_kernel instantiations are printed,
then cheb_fwd, cheb_bwd_gx and cheb_bwd_gd (stacked F = 384 and one block
F = 128), and cheb_bwd_gxgd beside the composition of cheb_bwd_gx and the
one-block cheb_bwd_gd, at fp32 on the slice's start positions (batch
128, 266 beads), open and folded into chip_smoke.py's per-molecule cells,
on the cheb slice's (48, 64) fit and the fp32 zoo's (128, 128) one, are
held against their twins and timed with CUDA events, the variants in
turns. The gxgd_* variants are timed on cheb_bwd_gxgd alone, the others
on the three other kernels; --gxgd builds and times base and the gxgd_*
variants only. The variants of cheb_rows_ffma_kernel and
cheb_gd_ffma_kernel:

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

Of cheb_gxgd_ffma_kernel (two product passes per 16-pair batch, each
one step of two orders at a time, one block of 8 warps per SM for the
register budget):

* gxgd_q2, gxgd_q4   -- the Wq pass unrolled twice or four times;
* gxgd_d2            -- the Wc pass unrolled twice;
* gxgd_minb2         -- two blocks of 8 warps per SM (128 registers);
* gxgd_one_pass      -- one pass per 8-pair batch: 4 pairs a lane, both
                        filters' 64 accumulators from one recurrence (16
                        FMAs per shared load), q and c2 in tables apart;
* gxgd_interleave    -- gxgd_one_pass with q_m and c2_m in alternate rows
                        of one table (zero rows past the shorter series);
* gxgd_no_orders     -- diagnostic, wrong results: both product passes
                        removed (scan, epilogues and staging alone).

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
GG_BATCH = """    seed();
    lf_product<1, false>(acc, ta, tb, z2, q_s + 4 * fg, MQ);
    gx_side(acc, nv);
    seed();
    lf_product<1, false>(acc, ta, tb, z2, c2_s + 4 * fg, M2);
    gd_side(acc, nv);"""
GG_ONE = """    seed();
    float ac[GG_PP][8];
    gg_both(acc, ac, ta, tb, z2, q_s + 4 * fg, c2_s + 4 * fg, GG_ST, MQ,
            M2);
    gx_side(acc, nv);
    gd_side(ac, nv);"""
GG_KERNEL = """template <bool HAS_CELL>
__global__ void __launch_bounds__(LF_W * 32, GG_MINB)
cheb_gxgd_ffma_kernel("""
GG_HELPERS = """constexpr int GG_ST = LF_FC;  // table row stride of q and c2
template <int PP>
__device__ __forceinline__ void gg_order(float (&acc)[PP][8],
                                         const float (&t)[PP],
                                         const float* cm) {
  const float4 lo = *reinterpret_cast<const float4*>(cm);
  const float4 hi = *reinterpret_cast<const float4*>(cm + LF_FC / 2);
  const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[p][k] = fmaf(t[p], c[k], acc[p][k]);
}
template <int PP>
__device__ __forceinline__ void gg_both(float (&aq)[PP][8],
                                        float (&ac)[PP][8], float (&ta)[PP],
                                        float (&tb)[PP],
                                        const float (&z2)[PP],
                                        const float* qs, const float* cs,
                                        int st, int MQ, int M2) {
#pragma unroll
  for (int p = 0; p < PP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) aq[p][k] = ac[p][k] = 0.0f;
  const int M = MQ > M2 ? MQ : M2;
#pragma unroll 2
  for (int m = 0; m < M; ++m) {
    if (m < MQ) gg_order(aq, ta, qs + m * st);
    if (m < M2) gg_order(ac, ta, cs + m * st);
#pragma unroll
    for (int p = 0; p < PP; ++p) {
      float t = fmaf(z2[p], tb[p], -ta[p]);
      ta[p] = tb[p];
      tb[p] = t;
    }
  }
}

""" + GG_KERNEL
GG_LAYOUT = """  float* q_s = reinterpret_cast<float*>(lf_smem4);  // [MQ][LF_FC]
  float* wl_s = q_s + (size_t)MQ * LF_FC;           // [LF_FC]: w_lin
  float* c2_s = wl_s + LF_FC;                       // [M2][LF_FC]"""
GG_LAYOUT_IL = """  const int MM = MQ > M2 ? MQ : M2;
  float* q_s = reinterpret_cast<float*>(lf_smem4);  // q_m at row 2 m
  float* c2_s = q_s + LF_FC;                        // c2_m at row 2 m + 1
  float* wl_s = q_s + (size_t)2 * MM * LF_FC;       // [LF_FC]: w_lin"""
GG_STAGE = """  lf_stage(q_s, q, w_lin, MQ, f0, F);
  lf_stage(c2_s, c2, nullptr, M2, f0, F);"""
GG_STAGE_IL = """  for (int e = threadIdx.x; e < (2 * MM + 1) * LF_FC; e += LF_W * 32) {
    int row = e / LF_FC, m = row >> 1, f = f0 + e % LF_FC;
    const float* src = row == 2 * MM ? w_lin : (row & 1) ? c2 : q;
    bool in = f < F && (row == 2 * MM ? w_lin != nullptr
                                      : m < ((row & 1) ? M2 : MQ));
    cp_async4(q_s + e, in ? src + (size_t)(row == 2 * MM ? 0 : m) * F + f
                          : q, in);
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
  __syncthreads();"""
GG_WQ = "float* wq_s = c2_s + (size_t)M2 * LF_FC + warp * GG_WARP;"
GG_SMEM = "((size_t)(MQ + 1 + M2) * LF_FC +\n                                   (size_t)LF_W * GG_WARP)"
ONE_PASS = {"constexpr int GG_PP = LF_PP;      // pairs per lane":
            "constexpr int GG_PP = 4;          // pairs per lane",
            GG_KERNEL: GG_HELPERS, GG_BATCH: GG_ONE,
            "lf_order(acc, low, wl_s": "gg_order(acc, low, wl_s"}
VARIANTS.update({
    "gxgd_q2": {"lf_product<1, false>(acc, ta, tb, z2, q_s":
                "lf_product<2, false>(acc, ta, tb, z2, q_s"},
    "gxgd_q4": {"lf_product<1, false>(acc, ta, tb, z2, q_s":
                "lf_product<4, false>(acc, ta, tb, z2, q_s"},
    "gxgd_d2": {"lf_product<1, false>(acc, ta, tb, z2, c2_s":
                "lf_product<2, false>(acc, ta, tb, z2, c2_s"},
    "gxgd_minb2": {"constexpr int GG_MINB = 1;": "constexpr int GG_MINB = 2;"},
    "gxgd_one_pass": ONE_PASS,
    "gxgd_interleave": {
        **ONE_PASS,
        "constexpr int GG_ST = LF_FC;": "constexpr int GG_ST = 2 * LF_FC;",
        GG_LAYOUT: GG_LAYOUT_IL, GG_STAGE: GG_STAGE_IL,
        GG_WQ: "float* wq_s = wl_s + LF_FC + warp * GG_WARP;",
        GG_SMEM: GG_SMEM.replace("(MQ + 1 + M2)",
                                 "(2 * (MQ > M2 ? MQ : M2) + 1)")},
    "gxgd_no_orders": {GG_BATCH: GG_BATCH.replace(", MQ);", ", 0);")
                       .replace(", M2);", ", 0);")},
})
DIAGNOSTIC = {"no_orders", "gxgd_no_orders"}
KERNELS = ("cheb_rows_ffma_kernel", "cheb_gd_ffma_kernel",
           "cheb_gxgd_ffma_kernel")


def build_all(tmp, names):
    """{variant: loaded library} of the variants ``names``; prints each
    variant's ptxas lines."""
    src = (_build.CSRC / "cheb_kernels.cu").read_text()
    procs = {}
    for name in names:
        subs = VARIANTS[name]
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
        for fn in ("cheb_fwd", "cheb_bwd_gx", "cheb_bwd_gd",
                   "cheb_bwd_gxgd"):
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
    out["cheb_bwd_gxgd"] = (
        "cheb_bwd_gxgd", [pos, x, x, q, c2, w0, w_lin, cell, inv],
        [s, a, f, q.shape[0], c2.shape[0], ck.gd_slabs(a, f, "fp32"), rcut,
         d_min],
        ck.cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, x, rcut, "fp32", d_min,
                                    w_lin, **kw), "gxgd")
    return out


def composition_ms(lib, case):
    """CUDA-event ms of cheb_bwd_gx then the one-block cheb_bwd_gd of
    ``lib`` on the operands of the gxgd case ``case``."""
    _, (pos, x, _, q, c2, w0, w_lin, cell, inv), ints, ref, _ = case
    s, a, f, mq, m2, _, rcut, d_min = ints
    gx, gpos = torch.empty_like(x), torch.empty_like(pos)
    row = torch.empty(s, a, 3, device=pos.device)
    n = ck.gd_slabs(a, f, "fp32")
    col = torch.empty(s, n, a, 3, device=pos.device)

    def call():
        rc = lib.cheb_bwd_gx(_ptr(pos), _ptr(x), _ptr(q), _ptr(w0),
                             _ptr(w_lin), _ptr(cell), _ptr(inv), _ptr(gx), s,
                             a, f, mq, rcut, d_min, 0, _stream())
        rc |= lib.cheb_bwd_gd(_ptr(pos), _ptr(x), _ptr(x), _ptr(c2),
                              _ptr(cell), _ptr(inv), _ptr(row), _ptr(col),
                              _ptr(gpos), s, a, f, m2, n, rcut, d_min, 0,
                              _stream())
        if rc:
            raise SystemExit(f"FAILED: composition: CUDA {rc}")

    return cs.cuda_time_ms(call, iters=20)


def runner(lib, fn, tensors, ints, ref, kind):
    """A callable launching ``fn`` of ``lib`` into fresh outputs, and the
    output it writes (the callable holds every tensor it points at)."""
    if kind == "gxgd":
        s, a, f, _, _, n_slabs, _, _ = ints
        gpos, out = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        held = [*tensors, out, torch.empty(s, a, 3, device=gpos.device),
                torch.empty(s, n_slabs, a, 3, device=gpos.device), gpos]
        out = (gpos, out)
    elif kind == "rows":
        out = torch.empty_like(ref)
        held = [*tensors, out]
    else:
        out = torch.empty_like(ref)
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


def _rel(out, ref):
    return max(float((o - r).abs().max() / r.abs().max())
               for o, r in zip(cs._tuple(out), cs._tuple(ref)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    dev = torch.device("cuda", 0)
    names = [n for n in VARIANTS
             if n == "base" or n.startswith("gxgd_") or "--gxgd" not in
             sys.argv]
    libs = build_all(Path(tempfile.mkdtemp()), names)
    for prec in ("bf16", "fp32"):
        ff, cfgs = cs._force_fields(dev, cs.BATCH, precision=prec)
        m = cs.cheb_orders(ff.schnet_config)
        for periodic in (False, True):
            for label, case in cases(ff, cfgs, dev, periodic).items():
                fn, ptrs, ints, ref, kind = case
                if "--gxgd" in sys.argv and kind != "gxgd":
                    continue
                mine = [n for n in libs if n == "base"
                        or n.startswith("gxgd_") == (kind == "gxgd")]
                times = {name: [] for name in mine}
                for name in [*mine, *reversed(mine)]:  # base first and last
                    call, out = runner(libs[name], fn, ptrs, ints, ref, kind)
                    call()
                    torch.cuda.synchronize()
                    rel = _rel(out, ref)
                    if name not in DIAGNOSTIC and rel > 1e-4:
                        raise SystemExit(f"FAILED: {name} {label}: {rel}")
                    times[name].append(cs.cuda_time_ms(call, iters=20))
                where = f"fp32 fit {m} {'cell' if periodic else 'open'}"
                print(f"variants {label} {where}: " + ", ".join(
                    f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
                    for name, ts in times.items()) + " ms")
                if kind == "gxgd":
                    comp = [composition_ms(libs["base"], case)
                            for _ in range(2)]
                    print(f"variants {label} {where}: composition (base "
                          "cheb_bwd_gx + one-block cheb_bwd_gd) " +
                          " / ".join(f"{t:.4f}" for t in comp) + " ms")
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
