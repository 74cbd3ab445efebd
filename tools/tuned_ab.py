"""The exact-filter kernels from this tree or another: the tuned kernels at the
zoo's widths (F 128, R 50) and at two widths padded onto them (F 96, R 50;
F 64, R 32), and the general-width kernels at SchNet's published widths
(F 64, R 300), at F 256, R 50 and at F 128, R 100: their outputs, bit for
bit, and their times.

    python3 tools/tuned_ab.py [--tree DIR] --save FILE [--against FILE]

Runs dense_cfconv_fwd, dense_cfconv_bwd (with and without gx), cfconv_fwd
and cfconv_bwd (with and without gx) at fp32 and bf16 at each width on
chip_smoke.py's slice shapes: the zoo's start positions (S = 128, A =
266), the pallas slice's list (K from the zoo's rule, rc + skin 1.0), the
first block's filter weights (the zoo's at F 128, R 50, chip_smoke.py's
width_field at the other widths), x and g drawn from seed 12 (F 128, R
50) or F + R. Prints each one's CUDA-event time (chip_smoke.py's
cuda_time_ms), saves the outputs' sha256 digests and the times to FILE
and, with ``--against``, says whether every output equals bitwise the one
that another run saved (no kernel changes an operation's order: the
general fp32 kernels' redesign keeps the first design's sums), and prints
every time beside that run's. ``--tree DIR`` imports chip_smoke.py and
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
WIDTHS = ((128, 50), (96, 50), (64, 32), (64, 300), (256, 50), (128, 100))


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

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    for mod in (cs, flashmd_tpu_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"FAILED: {mod.__name__} imported from "
                             f"{mod.__file__}")
    print(f"tuned_ab: tree {tree}; {cs.nvidia_smi_line()}")
    dev = torch.device("cuda", 0)
    outs, times = {}, {}
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
            for prec in ("fp32", "bf16"):
                key = f"{name} {prec} F={f} R={r}"
                out = call(prec)
                outs[key] = [_digest(t) for t in
                             (out if isinstance(out, tuple) else (out,))]
                times[key] = cs.cuda_time_ms(lambda: call(prec))
                print(f"tuned_ab: {key} K={nbr.capacity}: "
                      f"{times[key]:.4f} ms")
    torch.save({"outs": outs, "ms": times}, args.save)
    if args.against:
        ref = torch.load(args.against)
        for key, ms in times.items():
            if key in ref["ms"]:
                print(f"tuned_ab: {key}: {ms:.4f} ms here, "
                      f"{ref['ms'][key]:.4f} ms in {args.against} "
                      f"(ratio {ms / ref['ms'][key]:.3f})")
        same = {key: outs[key] == ref["outs"][key]
                for key in sorted(outs) if key in ref["outs"]}
        bad = [key for key, ok in same.items() if not ok]
        print(f"tuned_ab: every kernel ({len(same)} outputs) bitwise equal "
              f"to {args.against}: {not bad and len(same) == len(outs)} "
              f"{bad or ''}")
        if bad or len(same) != len(outs):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
