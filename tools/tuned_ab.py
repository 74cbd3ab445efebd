"""The tuned exact-filter kernels at the zoo's widths (F 128, R 50), from this
tree or another: their outputs, bit for bit, and their times.

    python3 tools/tuned_ab.py [--tree DIR] --save FILE [--against FILE]

Runs dense_cfconv_fwd, dense_cfconv_bwd (with and without gx), cfconv_fwd
and cfconv_bwd (with and without gx) at fp32 and bf16 on chip_smoke.py's
slice shapes: the zoo's start positions (S = 128, A = 266), the pallas
slice's list (K from the zoo's rule, rc + skin 1.0), the first block's
filter weights, x and g drawn from seed 12. Prints each one's CUDA-event
time (chip_smoke.py's cuda_time_ms), saves the outputs to FILE and, with
``--against``, says whether they equal bitwise those that another run
saved. ``--tree DIR`` imports chip_smoke.py and flashmd_tpu_torch from DIR
(a parent's ``git archive`` unpacked under ``_chip/``, which .gitignore
lists), so that two trees run on one card in turns, each in its own
process: parent, change, change, parent. Prints the tree and nvidia-smi's
name and power limit first; exits non-zero if the outputs differ.
"""

import argparse
import sys
from pathlib import Path


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
    ff, cfgs = cs._force_fields(dev, cs.BATCH, message_passing="pallas")
    pos = collate(cfgs, device=dev).pos
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    w = (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
         rbf["coeff"])
    rcut = float(ff.schnet_config.cutoff.cutoff_upper)
    gen = torch.Generator(device=dev).manual_seed(12)
    f = w[0].shape[1]
    x = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
    g = torch.randn(*pos.shape[:2], f, generator=gen, device=dev)
    nbr = build_neighbors(ff, pos, skin=1.0)
    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    calls = {
        "dense_cfconv_fwd": lambda p: cd.dense_cfconv_fwd(pos, x, *w, rcut,
                                                          p),
        "dense_cfconv_bwd": lambda p: cd.dense_cfconv_bwd(pos, x, g, *w,
                                                          rcut, p),
        "dense_cfconv_bwd (no gx)": lambda p: cd.dense_cfconv_bwd(
            pos, x, g, *w, rcut, p, need_gx=False)[0],
        "cfconv_fwd": lambda p: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w,
                                              rcut, p),
        "cfconv_bwd": lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, p),
        "cfconv_bwd (no gx)": lambda p: cf.cfconv_bwd(
            pos, *csr, x, g, *w, rcut, p, need_gx=False)[0],
    }
    outs = {}
    for name, call in calls.items():
        for prec in ("fp32", "bf16"):
            out = call(prec)
            outs[name, prec] = [t.cpu() for t in
                                (out if isinstance(out, tuple) else (out,))]
            ms = cs.cuda_time_ms(lambda: call(prec))
            print(f"tuned_ab: {name} {prec} F={f} R={w[0].shape[0]} "
                  f"K={nbr.capacity}: {ms:.4f} ms")
    torch.save(outs, args.save)
    if args.against:
        ref = torch.load(args.against)
        same = {key: all(torch.equal(a, b) for a, b in zip(v, ref[key]))
                for key, v in outs.items()}
        print(f"tuned_ab: outputs bitwise equal to {args.against}: "
              f"{all(same.values())} {same if not all(same.values()) else ''}")
        if not all(same.values()):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
