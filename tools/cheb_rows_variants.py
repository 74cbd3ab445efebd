"""Design variants of the tensor-core fwd/gx kernel, timed on the card.

    python3 tools/cheb_rows_variants.py

Each variant is an edited copy of flashmd_tpu_torch/csrc/cheb_kernels.cu
(one text substitution) compiled into a library of its own, in parallel
with the others; ptxas' registers and spills of its cheb_rows_mma_kernel
instantiations are printed, then cheb_fwd and cheb_bwd_gx at the cheb
slice's shapes (bf16 (48, 64) and bf16x3 (64, 96) fits, batch 128, 266
beads, open boundaries) are held against their twins and timed with CUDA
events. The variants are the alternatives recorded in the kernel's note:

* base        -- the source as it is;
* fwd_run1    -- the forward's product over one fragment per scaling;
* fwd_run3    -- over three;
* gx_x3_acc   -- gx at bf16x3 summing every order's three passes in the
                 mma accumulator (no fresh accumulator per order);
* cell_in_reg -- the cell's lattice read once and held in registers.

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
from flashmd_tpu_torch.ops._launch import TIER_CODES, _ptr, _stream  # noqa: E402

NJ = "constexpr int RM_NJ = GX ? 1 : 2;"
GX_X3 = """          float p[4];
          mma_bf16(p, ah[jj], bh[0], bh[1], zero);
          mma_bf16(p, al[jj], bh[0], bh[1], p);
          mma_bf16(p, ah[jj], bl[0], bl[1], p);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] += p[e];"""
GX_X3_ACC = """          mma_bf16(acc[t], ah[jj], bh[0], bh[1], acc[t]);
          mma_bf16(acc[t], al[jj], bh[0], bh[1], acc[t]);
          mma_bf16(acc[t], ah[jj], bl[0], bl[1], acc[t]);"""
GEO = "geo[k] = reinterpret_cast<const volatile float*>(geo_s)[k];"
VARIANTS = {
    "base": {},
    "fwd_run1": {NJ: "constexpr int RM_NJ = GX ? 1 : 1;"},
    "fwd_run3": {NJ: "constexpr int RM_NJ = GX ? 1 : 3;"},
    "gx_x3_acc": {GX_X3: GX_X3_ACC},
    "cell_in_reg": {GEO: "geo[k] = geo_s[k];"},
}
KERNEL = "cheb_rows_mma_kernel"


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
            key = cs._mma_match(line.split(":")[0])
            if key and key[0] == "rows":
                print(f"variant {name}: {cs._mma_label(*key)}: "
                      f"{line.split(': ', 1)[1]}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn in ("cheb_fwd", "cheb_bwd_gx"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build_all(Path(tempfile.mkdtemp()))
    for prec in ("bf16", "bf16x3"):
        ff, cfgs = cs._force_fields(dev, cs.BATCH, precision=prec)
        pos = collate(cfgs, device=dev).pos
        c, c2, w0 = ff.schnet_params["cheb_fit"][0]
        w_lin = _lin_slope(c2)
        rcut, d_min = float(ff.rcut), float(ff.schnet_config.cheb_d_min)
        s, a, f = pos.shape[0], pos.shape[1], c.shape[1]
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn(s, a, f, generator=gen, device=dev)
        q = ck._to_that_basis(c).contiguous()
        cases = {
            "cheb_fwd": (c, ck.cheb_conv_fwd_plain),
            "cheb_bwd_gx": (q, ck.cheb_conv_bwd_gx_plain),
        }
        for fn, (coef, plain) in cases.items():
            ref = plain(c, w0, pos, x, rcut, prec, d_min, w_lin)
            ref32 = plain(c, w0, pos, x, rcut, "fp32", d_min, w_lin)
            for name, lib in libs.items():
                out = torch.empty_like(x)

                def call():
                    rc = getattr(lib, fn)(
                        _ptr(pos), _ptr(x), _ptr(coef), _ptr(w0),
                        _ptr(w_lin), None, None, _ptr(out), s, a, f,
                        coef.shape[0], rcut, d_min, TIER_CODES[prec],
                        _stream())
                    if rc:
                        raise SystemExit(f"FAILED: {name} {fn}: CUDA {rc}")

                call()
                torch.cuda.synchronize()
                rel = float((out - ref).abs().max() / ref.abs().max())
                near = float(torch.linalg.norm(out - ref)
                             / torch.linalg.norm(out - ref32))
                ms = cs.cuda_time_ms(call, warmup=2, iters=20)
                print(f"variant {name} {fn} {prec}: max|k-p|/max|p| "
                      f"{rel:.3e}, ||k-p|| / ||k-p_fp32|| {near:.3e}, "
                      f"{ms:.4f} ms")
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
