"""Design variants of the general-width kernels (csrc/cfconv_general_kernels.cu
and csrc/cfconv_general_mma_kernels.cu):
the tensor-core tiles of the bf16 tier and the CUDA-core tiles of the fp32
tier, timed on the card in turns.

    python3 tools/general_variants.py [variant ...]

Each variant is an edited copy of the two general-width sources (text
substitutions), linked with the other sources of flashmd_tpu_torch/csrc
(compiled once) into a library of its own; every compile runs at once.
ptxas' registers and spills of each variant's gw_*_mma_kernel (bf16
variants) or gf_*_kernel (fp32 variants) instantiations are printed. Then,
in one process, the six general-width launches (dense_cfconv_fwd,
dense_cfconv_bwd with and without gx, cfconv_fwd, cfconv_bwd with and
without gx) at F 64, R 300 and F 256, R 50 (fp32 also at F 128, R 100) on
tools/tuned_ab.py's inputs (chip_smoke.py's slice shapes: S = 128, A =
266, the pallas slice's list) run on each variant's library in turns (base
first and last), bf16 for the bf16 variants and fp32 for the fp32 ones
(base: both), timed with CUDA events (chip_smoke.py's cuda_time_ms); each
variant's outputs are held bitwise to the base's, since no variant changes
the order of an operation. bf16 variants (the tensor-core tiles):

  base      -- the source as it is;
  fw16      -- the forward tiles at up to 16 warps a block (128 registers
               a thread; the source: 12, 170 registers);
  u2        -- the products' k-step loop unrolled by 2 (the source: not);
  recompute -- the backward computes a0 again for 1 - a0^2 at every
               width (the source keeps it in shared memory where that
               costs no warp: F 64 R 300 yes, F 256 R 50 no);
  bw8       -- the backward without gx at up to 8 warps a block (255
               registers a thread; the source: 10, 204);
  gx10      -- the dense backward with gx at up to 10 warps a block (the
               source: 8);
  src0      -- the forward tile loads its first chunk's src values before
               a0 (the source: before that chunk's W product);
  pipe      -- the products load the next k-step's A and B fragments
               before the MMAs of this one; pipe_fw8 the same with the
               forward tiles at up to 8 warps a block (255 registers).

fp32 variants (the CUDA-core tiles, gf_*; FP32_VARIANTS):

  f32_fw4, f32_fw12 -- the forward tiles at up to 4 or 12 warps a block
               (the source: 8);
  f32_bw4   -- the backward tiles at up to 4 warps a block (the source:
               8 where shared memory holds them: F 64 R 300);
  f32_kp16, f32_kp64 -- panels of 16 or 64 k-rows (the source: 32; 64
               holds fewer warps at F 256: the panels take 69.6 KB);
  f32_l2    -- every width on the first design's kernels (weights through
               L1/L2: the parent's fp32 tier, bitwise the same);
  f32_gf64  -- the forward and the gx pass at Fp 64 on the gf_* tiles
               (8 x 4 a lane there; the source: the first design's
               kernels, gf_kind_layout);
  f32_any   -- any number of warps a block that shared memory holds (the
               source: a multiple of 4 from 4 up: 6 -> 4 at F 256's
               forward).

Timing probes (PROBES; their outputs are wrong and not checked; base minus
probe is the phase's share): no_ring (no ring sum into the rows), no_tanh
(a0 without tanh), no_wprod (the forward tile without its W product).

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The two sources of the general-width kernels (the CUDA-core tiers, the
# tensor-core tiers): a variant edits whichever holds each substitution.
GENERAL = ("cfconv_general_kernels.cu", "cfconv_general_mma_kernels.cu")
VARIANTS = {
    "base": [],
    "fw16": [("constexpr int GM_FWD_MAX_WARPS = 12;",
              "constexpr int GM_FWD_MAX_WARPS = 16;")],
    "u2": [("#pragma unroll 1\n  for (int ks = 0; ks < nks; ++ks) {\n"
            "    const uint4 v",
            "#pragma unroll 2\n  for (int ks = 0; ks < nks; ++ks) {\n"
            "    const uint4 v")],
    "recompute": [("  keep = kind != GM_FWD && (fit_keep < most ? fit_keep : "
                   "most) == warps;", "  keep = fit_keep < 0;")],
    "bw8": [("constexpr int GM_BWD_MAX_WARPS = 10;",
             "constexpr int GM_BWD_MAX_WARPS = 8;")],
    "gx10": [("constexpr int GM_BWD_GX_MAX_WARPS = 8;",
              "constexpr int GM_BWD_GX_MAX_WARPS = 10;")],
    "src0": [("  gm_filter_a0(rbf_f, act_f, nullptr, d, cut, coeff, a, w, lane);\n"
              "  __syncwarp();  // rbf_f is read before v_s takes its place\n",
              "  float sp[2][GW_TILE];\n"
              "  gm_load_src(sp, ring, head, nv, src, 0, a.Fq, lane);\n"
              "  gm_filter_a0(rbf_f, act_f, nullptr, d, cut, coeff, a, w, lane);\n"
              "  __syncwarp();  // rbf_f is read before v_s takes its place\n"),
             ("    float sp[2][GW_TILE], acc[GM_NT][4];\n"
              "    gm_load_src(sp, ring, head, nv, src, c0, a.Fq, lane);\n"
              "    gm_prod<true>(acc, act_f, nkf,",
              "    float acc[GM_NT][4];\n"
              "    if (c0 > 0) gm_load_src(sp, ring, head, nv, src, c0, a.Fq, "
              "lane);\n"
              "    gm_prod<true>(acc, act_f, nkf,")],
}
# The products' next k-step's A and B fragments loaded before the MMAs of
# this one (gm_prod software-pipelined): the source's gm_prod, and its
# replacement with the ldmatrix half of gm_kstep split out (gm_ldsm).
PIPE = ('''template <bool TRANS>
__device__ __forceinline__ void gm_prod(float (&acc)[GM_NT][4],
                                        const uint4* af, int nks,
                                        const __nv_bfloat16* w, int ldw,
                                        int np_end, int lane) {
  gm_zero(acc);
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const uint4 v = af[32 * ks + lane];
    const unsigned a[4] = {v.x, v.y, v.z, v.w};
    gm_kstep<TRANS>(acc, a, w, ldw, 16 * ks, np_end, lane);
  }
}
''', '''template <bool TRANS>
__device__ __forceinline__ void gm_ldsm(unsigned (&b)[GM_NT / 2][4],
                                        const __nv_bfloat16* w, int ldw,
                                        int k0, int np_end, int lane) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < GM_NT / 2; ++np) {
    if (np >= np_end) break;
    const int n0 = 16 * np;
    const __nv_bfloat16* p =
        TRANS ? w + (size_t)(k0 + 8 * (mat & 1) + r) * ldw + n0 + 8 * (mat >> 1)
              : w + (size_t)(n0 + 8 * (mat >> 1) + r) * ldw + k0 + 8 * (mat & 1);
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    if (TRANS)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\\n"
          : "=r"(b[np][0]), "=r"(b[np][1]), "=r"(b[np][2]), "=r"(b[np][3])
          : "r"(addr));
    else
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
          : "=r"(b[np][0]), "=r"(b[np][1]), "=r"(b[np][2]), "=r"(b[np][3])
          : "r"(addr));
  }
}

template <bool TRANS>
__device__ __forceinline__ void gm_prod(float (&acc)[GM_NT][4],
                                        const uint4* af, int nks,
                                        const __nv_bfloat16* w, int ldw,
                                        int np_end, int lane) {
  gm_zero(acc);
  uint4 av = af[lane];
  unsigned b[GM_NT / 2][4] = {};
  gm_ldsm<TRANS>(b, w, ldw, 0, np_end, lane);
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const unsigned a[4] = {av.x, av.y, av.z, av.w};
    unsigned bc[GM_NT / 2][4];
#pragma unroll
    for (int np = 0; np < GM_NT / 2; ++np)
#pragma unroll
      for (int i = 0; i < 4; ++i) bc[np][i] = b[np][i];
    if (ks + 1 < nks) {
      av = af[32 * (ks + 1) + lane];
      gm_ldsm<TRANS>(b, w, ldw, 16 * (ks + 1), np_end, lane);
    }
#pragma unroll
    for (int np = 0; np < GM_NT / 2; ++np) {
      if (np >= np_end) break;
      mma_bf16(acc[2 * np], a, bc[np][0], bc[np][1]);
      mma_bf16(acc[2 * np + 1], a, bc[np][2], bc[np][3]);
    }
  }
}
''')
VARIANTS["pipe"] = [PIPE]
VARIANTS["pipe_fw8"] = [PIPE, ("constexpr int GM_FWD_MAX_WARPS = 12;",
                               "constexpr int GM_FWD_MAX_WARPS = 8;")]

# The fp32 tier's variants (the CUDA-core tiles gf_*).
FP32_VARIANTS = {
    "f32_fw4": [("constexpr int GF_FWD_MAX_WARPS = 8;",
                 "constexpr int GF_FWD_MAX_WARPS = 4;")],
    "f32_fw12": [("constexpr int GF_FWD_MAX_WARPS = 8;",
                  "constexpr int GF_FWD_MAX_WARPS = 12;")],
    "f32_bw4": [("constexpr int GF_BWD_MAX_WARPS = 8;",
                 "constexpr int GF_BWD_MAX_WARPS = 4;")],
    "f32_kp16": [("constexpr int GF_KP = 32;", "constexpr int GF_KP = 16;")],
    "f32_kp64": [("constexpr int GF_KP = 32;", "constexpr int GF_KP = 64;")],
    "f32_l2": [("int gf_layout(int Fp, int R, int Rq) {\n",
                "int gf_layout(int Fp, int R, int Rq) {\n  return GF_NONE;\n")],
    "f32_any": [("  if (warps >= 4) warps &= ~3;\n", "")],
    "f32_gf64": [("  return kind == GF_FWD && Fp == 64 ? GF_NONE : "
                  "gf_layout(Fp, R, Rq);", "  return gf_layout(Fp, R, Rq);")],
}
VARIANTS.update(FP32_VARIANTS)

# Timing probes: each removes one phase of the tiles, so its outputs are
# wrong and are not held to the base's; base minus probe is that phase's
# share of the time.
PROBES = {
    "no_ring": [("    const int c = c0 + GM_VCW * half + lane;\n    if (c < Fq) {",
                 "    const int c = c0 + GM_VCW * half + lane;\n    if (c < 0) {")],
    "no_tanh": [("    acc[nt][0] = tanhf(acc[nt][0] + b.x);\n"
                 "    acc[nt][1] = tanhf(acc[nt][1] + b.y);\n"
                 "    acc[nt][2] = tanhf(acc[nt][2] + b.x);\n"
                 "    acc[nt][3] = tanhf(acc[nt][3] + b.y);",
                 "    acc[nt][0] += b.x;\n    acc[nt][1] += b.y;\n"
                 "    acc[nt][2] += b.x;\n    acc[nt][3] += b.y;")],
    "no_wprod": [("    gm_prod<true>(acc, act_f, nkf, w.w1 + c0, w.ldw, np_end, lane);\n"
                  "    gm_wcut_sum(acc, cut, sp, v_s,",
                  "    gm_zero(acc);\n    gm_wcut_sum(acc, cut, sp, v_s,")],
}
VARIANTS.update(PROBES)
WIDTHS = {"bf16": ((64, 300), (256, 50)),
          "fp32": ((64, 300), (256, 50), (128, 100))}


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise SystemExit(f"FAILED: {' '.join(cmd)}\n{log}")
    return logs


def build_all(tmp, names):
    """{variant: loaded library}, each with the wrappers' signatures."""
    import chip_smoke as cs
    from flashmd_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    flags = [*_build._FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC)]
    others = [s for s in _build.sources() if s.name not in GENERAL]
    cmds = [[nvcc, *flags, "-c", "-o", str(tmp / f"{s.stem}.o"), str(s)]
            for s in others]
    texts = {g: (_build.CSRC / g).read_text() for g in GENERAL}
    for name in names:
        srcs = dict(texts)
        for old, new in VARIANTS[name]:
            where = [g for g in GENERAL if old in srcs[g]]
            if not where:
                raise SystemExit(f"FAILED: variant {name}: {old!r} not in "
                                 "the sources")
            for g in where:
                srcs[g] = srcs[g].replace(old, new)
        (tmp / name).mkdir()
        for i, g in enumerate(GENERAL):
            (tmp / name / g).write_text(srcs[g])
            cmds.append([nvcc, *flags, "-c", "-o",
                         str(tmp / name / f"g{i}.o"), str(tmp / name / g)])
    logs = _run_all(cmds)
    _run_all([[nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
               str(tmp / name / "lib.so"),
               *(str(tmp / name / f"g{i}.o") for i in range(len(GENERAL))),
               *(str(tmp / f"{s.stem}.o") for s in others)]
              for name in names])
    libs = {}
    logs = logs[len(others):]
    logs = ["".join(logs[k:k + len(GENERAL)])
            for k in range(0, len(logs), len(GENERAL))]
    for name, log in zip(names, logs):
        fp32 = name in FP32_VARIANTS or name == "base"
        for line in cs.ptxas_summary(log):
            if "_mma_kernel" in line and "gw_" in line and name != "base" \
                    and not fp32:
                print(f"general_variants: {name}: "
                      f"{line[line.index('gw_'):]}")
            if fp32 and "gf_" in line:
                print(f"general_variants: {name}: "
                      f"{line[line.index('gf_'):]}")
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cases(dev, prec):
    """{(name, (f, r)): callable} of the six launches at tier ``prec`` at
    each of its widths."""
    import torch

    import chip_smoke as cs
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops import cfconv_dense as cd

    out = {}
    for f, r in WIDTHS[prec]:
        ff, cfgs = cs.width_field(dev, cs.BATCH, f, r, "pallas")
        pos = collate(cfgs, device=dev).pos
        w = cs.filter_weights(ff)
        rcut = float(ff.schnet_config.cutoff.cutoff_upper)
        gen = torch.Generator(device=dev).manual_seed(f + r)
        x = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
        g = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
        nbr = build_neighbors(ff, pos, skin=1.0)
        csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
        out.update({
            ("dense_cfconv_fwd", (f, r)): lambda pos=pos, x=x, w=w, rc=rcut:
                (cd.dense_cfconv_fwd(pos, x, *w, rc, prec),),
            ("dense_cfconv_bwd", (f, r)): lambda pos=pos, x=x, g=g, w=w,
                rc=rcut: cd.dense_cfconv_bwd(pos, x, g, *w, rc, prec),
            ("dense_cfconv_bwd (no gx)", (f, r)): lambda pos=pos, x=x, g=g,
                w=w, rc=rcut: cd.dense_cfconv_bwd(pos, x, g, *w, rc, prec,
                                                  need_gx=False)[:1],
            ("cfconv_fwd", (f, r)): lambda pos=pos, x=x, w=w, rc=rcut,
                n=nbr: (cf.cfconv_fwd(pos, n.idx, n.mask, x, *w, rc,
                                      prec),),
            ("cfconv_bwd", (f, r)): lambda pos=pos, x=x, g=g, w=w, rc=rcut,
                c=csr: cf.cfconv_bwd(pos, *c, x, g, *w, rc, prec),
            ("cfconv_bwd (no gx)", (f, r)): lambda pos=pos, x=x, g=g, w=w,
                rc=rcut, c=csr: cf.cfconv_bwd(pos, *c, x, g, *w, rc, prec,
                                              need_gx=False)[:1],
        })
    return out


def main():
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from flashmd_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    print(f"general_variants: {cs.nvidia_smi_line()}")
    names = sys.argv[1:] or list(VARIANTS)
    names = ["base"] + [n for n in names if n != "base"]
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), names)
        calls = {prec: cases(dev, prec) for prec in ("bf16", "fp32")}
        ref = {}
        for name in names + ["base"]:
            _build._loaded[_build.library_path()] = libs[name]
            precs = (("fp32",) if name in FP32_VARIANTS else
                     ("bf16", "fp32") if name == "base" else ("bf16",))
            for key, call in ((k + (p,), c) for p in precs
                              for k, c in calls[p].items()):
                outs = call()
                torch.cuda.synchronize()
                if name == "base" and key not in ref:
                    ref[key] = [t.clone() for t in outs if t is not None]
                same = all(torch.equal(a, b) for a, b in
                           zip([t for t in outs if t is not None], ref[key]))
                ms = cs.cuda_time_ms(call)
                print(f"general_variants: {name} {key[0]} {key[2]} "
                      f"F={key[1][0]}"
                      f" R={key[1][1]}: {ms:.4f} ms; "
                      + ("a timing probe, outputs not checked"
                         if name in PROBES else
                         f"bitwise the base's: {same}"))
                if not same and name not in PROBES:
                    raise SystemExit(f"FAILED: {name} {key} differs")


if __name__ == "__main__":
    main()
