"""chip_smoke.py's fp32 exact-filter slices alone, from this tree or another.

    python3 tools/slice_ab.py [--tree DIR] [pallas_fp32] [dense_fp32]

Runs the named slices (both when none is named) as chip_smoke.py runs
them: 40 Langevin steps of the zoo's field at fp32 on the pallas or the
dense path, batch 128, 266 beads, launch counts and twin calls gated,
second-half throughput and a torch.profiler window. ``--tree DIR`` imports
chip_smoke.py and flashmd_tpu_torch from DIR instead of this tree (a
parent's ``git archive`` unpacked under ``_chip/``, which .gitignore
lists), so that two trees run the same slices on one card in turns, each
in its own process: parent, change, change, parent. The bf16 slice beside
which chip_smoke.py prints the ratio is not run (its throughput prints as
nan). Prints the tree and nvidia-smi's name and power limit first.
"""

import argparse
import sys
from pathlib import Path

SLICES = ("pallas_fp32", "dense_fp32")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parent.parent))
    parser.add_argument("slices", nargs="*", choices=SLICES)
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import chip_smoke as cs
    import flashmd_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    for mod in (cs, flashmd_tpu_torch):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"FAILED: {mod.__name__} imported from "
                             f"{mod.__file__}")
    smi = cs.nvidia_smi_line()
    print(f"slice_ab: tree {tree}; {smi}")
    dev = torch.device("cuda", 0)
    _, cfgs = cs._force_fields(dev, cs.BATCH, message_passing="pallas")
    for name in args.slices or SLICES:
        phase = getattr(cs, f"phase_{name}_slice")
        phase(cfgs, dev, float("nan"), smi)


if __name__ == "__main__":
    main()
