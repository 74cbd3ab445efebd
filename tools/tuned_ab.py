"""The exact-filter kernels from this tree or another: the tuned kernels at the
zoo's widths (F 128, R 50) and at two widths padded onto them (F 96, R 50;
F 64, R 32), and the general-width kernels at SchNet's published widths
(F 64, R 300), at F 256, R 50, at F 128, R 100 and at the Open Catalyst
SchNet's filter (F 256, R 200): their outputs, bit for bit, and their
times.

    python3 tools/tuned_ab.py [--tree DIR] --save FILE [--against FILE]

Runs dense_cfconv_fwd, dense_cfconv_bwd (with and without gx), cfconv_fwd
and cfconv_bwd (with and without gx) at fp32, bf16 and bf16x3 at each
width on chip_smoke.py's slice shapes: the zoo's start positions (S = 128,
A = 266), the pallas slice's list (K from the zoo's rule, rc + skin 1.0), the
first block's filter weights (the zoo's at F 128, R 50, chip_smoke.py's
width_field at the other widths), x and g drawn from seed 12 (F 128, R
50) or F + R. Prints each one's CUDA-event time (chip_smoke.py's
cuda_time_ms) and family (ops/cfconv_general.py route), saves the
outputs' sha256 digests, the families and the times to FILE and, with
``--against``, says whether every output equals bitwise the one that
another run saved where both runs routed it to the same family (no kernel
changes an operation's order), and prints every time beside that run's
(where the family differs, e.g. F 256, R 200 at bf16: "wide" in a parent
without the streamed tensor-core tiles, "streamed" after them, the times
only). ``--tree DIR`` imports chip_smoke.py and
flashmd_tpu_torch from DIR (a parent's ``git archive`` unpacked under
``_chip/``, which .gitignore lists), so that two trees run on one card in
turns, each in its own process: parent, change, change, parent. Prints the
tree and nvidia-smi's name and power limit first; exits non-zero if an
output differs.
"""

import argparse
import hashlib
import sys
from pathlib import Path

# (F, R) of each run: the tuned kernels' width, two padded onto it, then
# the general widths.
WIDTHS = ((128, 50), (96, 50), (64, 32), (64, 300), (256, 50), (128, 100),
          (256, 200))
PRECISIONS = ("fp32", "bf16", "bf16x3")


def _digest(t):
    """sha256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("--save", required=True)
    parser.add_argument("--against")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import chip_smoke as cs
    import flashmd_tpu_torch
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops import cfconv_general as cg

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    for mod in (cs, flashmd_tpu_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"FAILED: {mod.__name__} imported from "
                             f"{mod.__file__}")
    print(f"tuned_ab: tree {tree}; {cs.nvidia_smi_line()}")
    dev = torch.device("cuda", 0)
    outs, times, families = {}, {}, {}
    for f, r in WIDTHS:
        if (f, r) == (128, 50):
            ff, cfgs = cs._force_fields(dev, cs.BATCH,
                                        message_passing="pallas")
            seed = 12
        else:
            ff, cfgs = cs.width_field(dev, cs.BATCH, f, r, "pallas")
            seed = f + r
        pos = collate(cfgs, device=dev).pos
        w = cs.filter_weights(ff)
        assert tuple(w[0].shape) == (r, f)
        rcut = float(ff.schnet_config.cutoff.cutoff_upper)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
        g = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
        nbr = build_neighbors(ff, pos, skin=1.0)
        csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
        calls = {
            "dense_cfconv_fwd": lambda p: cd.dense_cfconv_fwd(
                pos, x, *w, rcut, p),
            "dense_cfconv_bwd": lambda p: cd.dense_cfconv_bwd(
                pos, x, g, *w, rcut, p),
            "dense_cfconv_bwd (no gx)": lambda p: cd.dense_cfconv_bwd(
                pos, x, g, *w, rcut, p, need_gx=False)[0],
            "cfconv_fwd": lambda p: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x,
                                                  *w, rcut, p),
            "cfconv_bwd": lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut,
                                                  p),
            "cfconv_bwd (no gx)": lambda p: cf.cfconv_bwd(
                pos, *csr, x, g, *w, rcut, p, need_gx=False)[0],
        }
        for name, call in calls.items():
            for prec in PRECISIONS:
                key = f"{name} {prec} F={f} R={r}"
                out = call(prec)
                outs[key] = [_digest(t) for t in
                             (out if isinstance(out, tuple) else (out,))]
                times[key] = cs.cuda_time_ms(lambda: call(prec))
                families[key] = cg.route(f, r, prec)[0]
                print(f"tuned_ab: {key} K={nbr.capacity} "
                      f"({families[key]}): {times[key]:.4f} ms")
    torch.save({"outs": outs, "ms": times, "families": families}, args.save)
    if args.against:
        ref = torch.load(args.against)
        moved = {key for key in outs
                 if ref.get("families", {}).get(key, families[key])
                 != families[key]}
        for key, ms in times.items():
            if key in ref["ms"]:
                fam = (f" ({ref['families'][key]} there, {families[key]} "
                       "here)" if key in moved else "")
                print(f"tuned_ab: {key}: {ms:.4f} ms here, "
                      f"{ref['ms'][key]:.4f} ms in {args.against} "
                      f"(ratio {ms / ref['ms'][key]:.3f}){fam}")
        same = {key: outs[key] == ref["outs"][key]
                for key in sorted(outs) if key in ref["outs"]
                and key not in moved}
        bad = [key for key, ok in same.items() if not ok]
        ok = not bad and len(same) == len(outs) - len(moved)
        print(f"tuned_ab: every kernel ({len(same)} outputs of one family "
              f"in both runs) bitwise equal to {args.against}: {ok} "
              f"{bad or ''}; {len(moved)} on another family, timed only")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
