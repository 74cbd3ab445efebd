"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):

1. device   -- a CUDA card must be present (exit 1 otherwise); name,
               count, and nvidia-smi's name and power limit.
2. build    -- nvcc builds flashmd_tpu_torch/csrc/cheb_kernels.cu for
               sm_90a with -Xptxas -v (registers, spills per kernel).
3. kernels  -- each kernel vs its plain PyTorch twin on the card at the
               slice's shapes, fp32 and bf16 tiers, and CUDA-event times.
4. forces   -- compute_energy_forces at full width, batch 4, on the card
               (kernels) vs the same model on the CPU (plain twins).
5. slice    -- LangevinSimulation at the bench configuration (batch 128,
               266 beads, 3 blocks, bf16, cheb (48, 64), d_min 2.0) for
               120 steps; launch counts must be 3/2/1 per force
               evaluation; second-half throughput.

Then a kernels JSON line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys

import numpy as np
import torch

BATCH = 128
N_ATOMS = 266
STEPS = 120
SAVE_INTERVAL = 20
FORCE_BATCH = 4
# Bounds on max|kernel - plain| / max|plain|: the JAX suite's own kernel
# tolerances at fp32 (tests/ops/test_cheb_kernel.py); in bf16 only the
# summation order and recurrence ulps differ between kernel and twin.
BOUNDS = {
    ("cheb_fwd", "fp32"): 1e-5,
    ("cheb_bwd_gx", "fp32"): 1e-4,
    ("cheb_bwd_gd", "fp32"): 1e-4,
    ("cheb_fwd", "bf16"): 2e-3,
    ("cheb_bwd_gx", "bf16"): 2e-3,
    ("cheb_bwd_gd", "bf16"): 2e-3,
}
FORCE_BOUND = 2e-3
REPLACES = {
    "cheb_fwd": "flashmd_tpu/ops/pallas/cheb_kernel.py:394",
    "cheb_bwd_gx": "flashmd_tpu/ops/pallas/cheb_kernel.py:476",
    "cheb_bwd_gd": "flashmd_tpu/ops/pallas/cheb_kernel.py:476",
}
SOURCE = "flashmd_tpu_torch/csrc/cheb_kernels.cu"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """'kernel: N registers, S B spill stores' per compiled entry."""
    lines, name = [], None
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            lines.append(
                f"{name}: {m.group(1)} regs, "
                f"{smem.group(1) if smem else 0} B static smem, {spill}"
            )
            name, spill = None, ""
    return lines


def cuda_time_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(ff, pos, dev):
    from flashmd_tpu_torch.models.cheb import _lin_slope
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    cfg = ff.schnet_config
    rcut = float(cfg.cutoff.cutoff_upper)
    d_min = float(cfg.cheb_d_min)
    fits = ff.schnet_params["cheb_fit"]
    c, c2, w0 = fits[0]
    w_lin = _lin_slope(c2)
    c2_cat = torch.cat([f[1] for f in fits], dim=1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(11)
    s, a = pos.shape[0], pos.shape[1]
    f = c.shape[1]
    x = torch.randn(s, a, f, generator=gen, device=dev)
    g = torch.randn(s, a, f, generator=gen, device=dev)
    nb = len(fits)
    x_cat = torch.randn(s, a, nb * f, generator=gen, device=dev)
    g_cat = torch.randn(s, a, nb * f, generator=gen, device=dev)

    cases = {
        "cheb_fwd": (
            lambda p: ck.cheb_conv_fwd(c, w0, pos, x, rcut, p, d_min, w_lin),
            lambda p: ck.cheb_conv_fwd_plain(c, w0, pos, x, rcut, p, d_min,
                                             w_lin),
        ),
        "cheb_bwd_gx": (
            lambda p: ck.cheb_conv_bwd_gx(c, w0, pos, g, rcut, p, d_min,
                                          w_lin),
            lambda p: ck.cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, p,
                                                d_min, w_lin),
        ),
        "cheb_bwd_gd": (
            lambda p: ck.cheb_conv_bwd_gd(c2_cat, pos, x_cat, g_cat, rcut, p,
                                          d_min),
            lambda p: ck.cheb_conv_bwd_gd_plain(c2_cat, pos, x_cat, g_cat,
                                                rcut, p, d_min),
        ),
    }
    print(f"kernels: shapes S={s} A={a} F={f} (gd {nb * f}) "
          f"M1={c.shape[0]} M2={c2.shape[0]} d_min={d_min}")
    results = {}
    for name, (kern, plain) in cases.items():
        for prec in ("fp32", "bf16"):
            out_k = kern(prec)
            torch.cuda.synchronize()
            out_p = plain(prec)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out_k).all()),
                  f"{name} {prec}: non-finite kernel output")
            abs_err = float((out_k - out_p).abs().max())
            rel = abs_err / float(out_p.abs().max())
            bound = BOUNDS[(name, prec)]
            ms = cuda_time_ms(lambda: kern(prec))
            plain_ms = cuda_time_ms(lambda: plain(prec), warmup=1, iters=3)
            print(f"kernels: {name} {prec} max|k-p|/max|p| = {rel:.3e} "
                  f"(bound {bound:.0e}) max_abs_err {abs_err:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            check(rel <= bound, f"{name} {prec}: {rel:.3e} > {bound:.0e}")
            if prec == "bf16":
                results[name] = {"max_abs_err": abs_err, "ms": ms,
                                 "plain_ms": plain_ms}
    return results


def phase_forces(dev):
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    out = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = cgschnet_1enh_like(
            n_atoms=N_ATOMS, batch_size=FORCE_BATCH, device=device
        )
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                      ff.schnet_config))
        sys_ = collate(cfgs, beta=1.67, device=device)
        e, f, _ = compute_energy_forces(ff, sys_.pos, sys_.atom_types)
        out[device.type] = (e.cpu(), f.cpu())
    (e_k, f_k), (e_p, f_p) = out["cuda"], out["cpu"]
    check(bool(torch.isfinite(f_k).all()), "forces: non-finite on the card")
    f_rel = float((f_k - f_p).abs().max() / f_p.abs().max())
    e_rel = float((e_k - e_p).abs().max() / e_p.abs().max())
    print(f"forces: batch {FORCE_BATCH} card vs cpu plain: "
          f"max|dF|/max|F| = {f_rel:.3e}, max|dE|/max|E| = {e_rel:.3e} "
          f"(bound {FORCE_BOUND:.0e})")
    check(f_rel <= FORCE_BOUND and e_rel <= FORCE_BOUND,
          "forces: card and CPU disagree")


def main():
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    from flashmd_tpu_torch.ops import _build

    info = _build.build(ptxas_verbose=True)
    print(f"build: nvcc {' '.join(_build.ARCH_FLAGS)} -> {info['path'].name} "
          f"in {info['seconds']:.1f} s")
    for line in ptxas_summary(info["log"]):
        print(f"build: ptxas {line}")

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    ff, cfgs = cgschnet_1enh_like(batch_size=BATCH, device=dev)
    sim = LangevinSimulation(
        dt=0.004, friction=1.0, n_timesteps=STEPS,
        save_interval=SAVE_INTERVAL, random_seed=103838, device=dev,
    )
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    cfg = sim.model.schnet_config
    check((cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min,
           cfg.precision) == (48, 64, 2.0, "bf16"),
          f"unexpected slice config {cfg}")

    pos = collate(cfgs, device=dev).pos
    kernel_stats = phase_kernels(sim.model, pos, dev)
    phase_forces(dev)

    ck.reset_launch_counts()
    coords = sim.simulate()
    counts = ck.launch_counts()
    n_evals = STEPS + 1
    expect = {"cheb_fwd": 3 * n_evals, "cheb_bwd_gx": 2 * n_evals,
              "cheb_bwd_gd": 1 * n_evals}
    finite = bool(np.isfinite(coords).all())
    m = sim.get_throughput_metrics()
    print(f"slice: {STEPS} steps batch {BATCH} A={N_ATOMS}: finite={finite} "
          f"launches={counts} expected={expect}; second-half throughput "
          f"{m['throughput']:.1f} timestep*mol/s ({m['ms_per_timestep']:.3f}"
          f" ms/step) on {smi}")
    check(finite, "slice: non-finite positions")
    check(counts == expect, "slice: launch counts differ from 3/2/1 per "
          "force evaluation")
    check(coords.shape == (BATCH, STEPS // SAVE_INTERVAL, N_ATOMS, 3),
          f"slice: frames of shape {coords.shape}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
         **kernel_stats[name]}
        for name in ("cheb_fwd", "cheb_bwd_gx", "cheb_bwd_gd")
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
