"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device   -- a CUDA card must be present (exit 1 otherwise); name,
               count, and nvidia-smi's name and power limit.
2. build    -- nvcc builds every flashmd_tpu_torch/csrc/*.cu for sm_90a
               (one process per source, in parallel) with -Xptxas -v
               (registers, spills per kernel). The tensor-core gd
               kernel's four instantiations (bf16, bf16x3; open, cell),
               the fwd/gx kernel's eight (also fwd, gx), the combined
               gx+gd kernel's four (bf16, bf16x3; open, cell), the
               dense backward's two (bf16; with and without gx), the
               dense forward, the neighbour-matrix forward and the
               neighbour-matrix backward's two passes (bf16) must not
               spill and must hold tensor-core MMA instructions in their
               SASS (cuobjdump); their counts are printed. The fp32
               CUDA-core live-pair kernels' fourteen instantiations
               (FFMA_LABELS: cheb_rows_ffma_kernel fwd, gx;
               cheb_gd_ffma_kernel; cheb_gxgd_ffma_kernel; open, cell;
               dense_bwd_ffma_kernel and nbr_bwd_ffma_kernel with and
               without gx; dense_fwd_ffma_kernel, nbr_fwd_ffma_kernel)
               must be built; their registers and spills are printed.
3. kernels  -- each kernel vs its plain PyTorch twin on the card at the
               slices' shapes, fp32 and bf16 tiers, CUDA-event times, and
               each kernel's bound (bytes or operations over the card's
               published peak; the operations of the pairs within the
               cutoff only, which the data needs). Every kernel is
               compared and timed at the slice's S = 128, beside the
               live pairs and the live pair fragments that the
               tensor-core kernels run (16 x 8 gd, 16 x 16 fwd/gx and
               gx+gd), and the executed pairs or slots of the dense and
               neighbour-matrix kernels, bf16 and fp32 (16-pair tiles of
               each work item's live pairs or slots); the
               dense and the neighbour-matrix
               backward in both of their variants (with gx, and without
               it as block 1 runs it). The neighbour-matrix kernels run
               on the pallas slice's own list (K from the zoo rule, rc +
               skin, start positions), and once more in fp32 and bf16 on
               an overflowed list (capacity 32: an asymmetric list); the
               peak device memory of one cfconv_bwd above its inputs is
               gated at bf16 (no [S, A, K, F] workspace); the
               neighbour build + source CSR is timed at S = 128. The
               four cheb kernels' periodic-cell variants run on the
               start positions folded into per-molecule cells (half
               cubic 60 A, half triclinic), where live pairs cross faces.
               The per-block schedule's kernels: the combined gx+gd
               backward, and the gd-only one on one block's F = 128; the
               composition gx + one-block gd on the same operands is
               timed beside the combined kernel.
               Then the four cheb kernels and the F = 128 gd launch at the
               bf16x3 tier, open and on the folded cells, on the bf16x3
               slice's own fits (64, 96); each also nearer its bf16x3
               twin than its fp32 twin (Frobenius norms), which holds
               only if the kernel takes the hi/lo splits. Then the four
               and the F = 128 gd launch at fp32 alone, open and on the
               folded cells, on the fp32 slice's own fits (128, 128) on
               d_min 0 (keys "_fp32"). Every fp32 line of the four cheb
               kernels (also at the slice's (48, 64)), of the dense
               forward and backward and of the neighbour-matrix forward
               and backward adds the pairs (slots) the live-pair kernel
               runs against S A^2 (S A K), its registers and spills, and
               two launches gated bitwise equal; the neighbour-matrix
               kernels on the overflowed list also without gx.
4. forces   -- compute_energy_forces at full width, batch 4, on the card
               (kernels) vs the same model on the CPU (plain twins), for
               the cheb (stacked and per-block schedules), the dense and
               the pallas force field and the periodic cheb one (folded
               positions, the kernels' cells; both schedules); then,
               each gated as the same function, the per-block vs the
               stacked cheb fp32 forces (open and periodic), the pallas
               fp32 forces vs the dense fp32 forces on the same weights
               and positions, and the periodic fp32 network forces on
               folded positions vs the open ones on unfolded positions.
               bf16x3 (all gated at BF16X3_BOUND): card vs CPU forces,
               stacked and per-block, open and periodic on folded
               positions; per-block vs stacked; bf16x3 vs fp32 network
               forces on the same (64, 96) fit. The fp32 slice's field
               (128, 128) on d_min 0: card vs CPU (CROSS_BOUND), and its
               total and network forces against the dense fp32 field
               (fidelity, printed, not gated).
5. slice    -- LangevinSimulation at the bench configuration (batch 128,
               266 beads, 3 blocks, bf16, cheb (48, 64), d_min 2.0) for
               120 steps; launch counts must be 3/2/1 per force
               evaluation and none of a cell variant; second-half
               throughput; torch.profiler over PROFILE_STEPS more steps.
   periodic -- the same run with benchmarks/pbc_ab.py's cell (cubic
               60 A on every molecule): the cell variants 3/2/1 per
               force evaluation, the open ones never; its throughput
               beside the open slice's; the profiler window.
   per-block - the open slice under FLASHMD_CHEB_STACK=0 (set in this
               process for these runs only): cheb_fwd 3, cheb_bwd_gxgd 2,
               cheb_bwd_gd 1 per force evaluation, cheb_bwd_gx and every
               cell variant 0; throughput beside the stacked slice's; the
               profiler window. Then PERBLOCK_PERIODIC_STEPS steps of it
               under the periodic slice's cell, on the cell variants only.
   bf16x3   -- cgschnet_1enh_like(precision="bf16x3", message_passing=
               "cheb"): (64, 96) on d_min
               2.0, the slice's other settings, BF16X3_STEPS steps on the
               stacked schedule (launches 3/2/1 per force evaluation on the
               *_bf16x3 counters, every other counter 0), throughput beside
               the bf16 slice's, a profiler window; then
               TIER_SHORT_STEPS steps each periodic, per-block and
               per-block periodic, each on its own counters.
   fp32     -- cgschnet_1enh_like(precision="fp32", message_passing=
               "cheb") at the zoo's fp32 defaults, (128, 128) on d_min 0,
               the slice's other settings and gptq None, STEPS steps on
               the stacked schedule: launches 3/2/1 per force evaluation
               on the *_fp32 counters, every other counter 0; throughput
               beside the bf16 and bf16x3 slices'; a profiler window;
               then TIER_SHORT_STEPS steps periodic, STEPS steps
               per-block (FLASHMD_CHEB_STACK=0: cheb_fwd 3, cheb_bwd_gxgd
               2 and one-block cheb_bwd_gd 1 on the fp32 counters, every
               other counter 0, no twin call; throughput beside the
               stacked fp32 slice's and a profiler window) and
               TIER_SHORT_STEPS per-block periodic, each on its own
               counters.
6. dense    -- the same Langevin run on the dense exact-filter force
               field (message_passing="dense", bf16) for the same
               steps; launch counts must be 3 fwd + 3 bwd per force
               evaluation; second-half throughput; then torch.profiler
               over PROFILE_STEPS more steps. "dense fp32":
               cgschnet_1enh_like(precision="fp32", message_passing=
               "dense") at the slice's shapes, gptq None, DENSE_FP32_STEPS
               steps: 3 fwd + 3 bwd per force evaluation, every cheb
               counter 0, no twin call, throughput beside the bf16 dense
               slice's and a profiler window.
7. pallas   -- the same Langevin run on the neighbour-matrix force field
               (message_passing="pallas", bf16, Verlet skin 1.0, list
               rebuilt every step); launch counts must be 3 fwd + 3 bwd
               per force evaluation; n_max against K; second-half
               throughput; then torch.profiler over PROFILE_STEPS more
               steps: device time by kernel and the device idle share.
               "pallas fp32": cgschnet_1enh_like(precision="fp32",
               message_passing="pallas") at the slice's shapes, gptq
               None, PALLAS_FP32_STEPS steps: 3 fwd + 3 bwd per force
               evaluation, every cheb and dense counter 0, no twin call,
               throughput beside the bf16 pallas slice's and a profiler
               window, which must name nbr_fwd_ffma_kernel.
8. xla      -- the exact xla path (plain PyTorch, no kernel of its own:
               every kernel counter must stay 0 on it). Forces at batch 4:
               bf16 card vs CPU (FORCE_BOUND); fp32 against pallas fp32
               and dense fp32, and fp32 folded periodic (the kernels'
               cells) vs open, each CROSS_BOUND. The slice: the zoo's
               default configuration cgschnet_1enh_like(message_passing=
               "xla") (bf16, K from the zoo rule, skin 1.0, remat
               "block") for XLA_STEPS steps with throughput and a profiler
               window; at batch 128 two force evaluations bitwise equal
               (forces and energies) and the peak device memory of one
               under remat "block" and "none" (block gated below none);
               XLA_CELL_STEPS steps under the periodic slice's cubic
               60 A cell (minimum image, Verlet rebuild under the cell).
               Then XLA_IMAGE_ATOMS beads in XLA_IMAGE_CELL, below the
               minimum-image regime: the engine switches to image
               replication, XLA_IMAGE_STEPS steps stay finite, and the
               fp32 network forces equal those of the 2 x 1 x 1
               supercell without images (CROSS_BOUND).
   checkpoint - a full-width model_and_prior.pt and configurations.pt
               written in the reference's pickled layout (GradientsOut(
               SumOut({SchNet, bonds, angles, dihedrals, repulsion})),
               flashmd.* module paths removed before reading, BATCH
               structures of the zoo chain, random weights and type
               tables from seed 0), read by checkpoint_io and bound with
               optimize=True: the frontier's d_min, bf16 floor, budget,
               candidate errors and chosen orders, the attach time (load,
               frontier, fit). The four cheb kernels on the frontier's
               (96, 96) fit against their twins. Forces at batch 4: the
               optimize=False (fp32 xla) field against the written
               modules' own fp32 autograd forces (CROSS_BOUND), the cheb
               bf16 field network-only within 1.05x the frontier's budget.
               STEPS steps at batch 128 with launches 3/2/1 per force
               evaluation and no twin call, throughput beside the cheb
               slice's, a profiler window; a second identical run
               bitwise equal; the nine other prior kinds card vs CPU
               (PRIOR_BOUND); CKPT_SHORT_STEPS steps each of the
               optimize=False field and of structures with
               exc_pair_index (xla bf16), every kernel counter 0. Then
               the same layout written with a plain-number basis cutoff
               (the reference's GaussianBasis makes it an IdentityCutoff)
               and max_num_neighbors CKPT_MAX_NEIGHBORS: optimize=True
               lands on cheb bf16 (gated) with max_num_neighbors carried
               (gated); the frontier's (m1, m2, d_min), the attach time
               (load, frontier, fit), one force evaluation's launches
               3/2/1 (gated), its network forces within 1.05x the
               frontier's budget of the modules' own fp32 ones (gated).
   cli      -- the console entry points' mains (sys.argv as the command
               line gives it) on that checkpoint's two files, with
               examples/*.yaml read and written by the port's own YAML
               code (model_file, structure_file, output_dir and
               n_timesteps, CLI_STEPS, replaced).
               "langevin": examples/langevin.yaml at --batch_size
               BATCH; launches 3/2/1 per force evaluation (the steps, the
               start and each frontier candidate of the binding), no twin
               call; the file names the config implies; coordinates
               (BATCH, frames, A, 3) finite; the echo read back equal to
               the parsed config; final positions and frames bitwise those
               of the engine driven directly (build_forcefield with the
               command line's arguments, LangevinSimulation with the
               YAML's options); attach seconds, throughput, peak memory.
               "pt": examples/parallel_tempering.yaml at --batch_size
               PT_INDEP (x 3 betas): the acceptance npys sum to the
               matrix. "nve": the Langevin example through the NVE entry
               point for CLI_NVE_STEPS (its friction warned as unknown),
               finite energies. "disable_optim": CLI_OFF_STEPS steps of
               the fp32 xla field, every kernel counter 0, gptq None.
9. fidelity -- max|F - F_dense_fp32| / max|F_dense_fp32| at batch 4: the
               cheb bf16 (48, 64), the dense bf16, the pallas bf16 and
               the xla bf16 force fields against the dense fp32 one on
               the same weights and positions, with and without the
               priors, and the cheb bf16x3 (64, 96) one; the xla one
               also with float32 cotangents in its filter MLP; the cheb
               bf16 (48, 64) one also on its wls and lawson host fits
               (printed, not gated).
   fit      -- the Chebyshev fit in its other forms. The host fits of
               the slice's field by proj, wls and lawson, each timed on
               the host (before the fidelity lines, which use them). The
               in-graph fit (models.cheb.fit_chebyshev_filter) of the 3
               blocks on the card at FIT_NODES nodes, (48, 64) on d_min
               2.0: its CUDA-event time, and per block c, c2 and w0
               against the float64 host fit (FIT_BOUND). compute_energy_
               forces at S = BATCH with no fit attached: launches 3/2/1
               (gated), fp32 network forces against the attached host
               fit's (CROSS_BOUND), bf16 printed; a fit attached at
               (32, 32) and called at (48, 64) refits, bitwise the
               unattached run (gated). wls and lawson: coefficient L1
               norms beside proj's, the three stacked cheb kernels on
               their coefficients against the twins (phase 3's bounds),
               and STEPS steps of the slice on each, interleaved proj,
               wls, lawson, proj: launches 3/2/1 per force evaluation,
               finite positions, the fit attached not redone (gated);
               the pair floor and the throughputs printed.
   envelope -- the slice's weights under the radial-basis envelopes of
               ENVELOPES (the conv cutoff stays the cosine; the basis of
               a plain-number reference cutoff is IdentityCutoff): the
               proj host fit's seconds; the three stacked cheb kernels on
               its coefficients against their twins (phase 3's bounds);
               forces at batch 4 card vs CPU twins (FORCE_BOUND, bf16)
               and the network's fp32 and bf16 forces against the xla
               fp32 field of the same envelope, the cosine's beside them
               (printed; dense computes the cosine basis and refuses
               these); STEPS steps of the slice on
               each, interleaved cosine, each envelope, cosine: launches
               3/2/1 per force evaluation and finite positions (gated),
               the throughputs printed.

10. integrators -- the open cheb slice once more at this point of the
               process ("cheb again"), then beside it: NVESimulation
               (launches 3/2/1 per force evaluation, the total-energy
               excursion printed, not gated: the cheb forces are not the
               gradient of the cheb energy), OverdampedSimulation
               (friction 1.0; the same launch gate), and PTSimulation at
               benchmarks/run_all.py:_cfg_pt's configuration (PT_INDEP
               structures x PT_BETAS, exchange every PT_EXCHANGE_INTERVAL
               steps): the cheb launches, the attempts, the int32
               matrix's off-diagonal sum, two runs with one seed bitwise
               equal, each replica's kinetic energy per degree of freedom
               beside 1/(2 beta) (hotter reads higher), throughput and a
               profiler window. "pt exchange": one exchange at full width
               on the pallas path (open) and the xla path (positions
               folded into the BOX cell) under
               torch.cuda.set_sync_debug_mode("error"), the permuted
               list, shifts, Verlet reference positions and source CSR
               and the forces from them bitwise equal to a fresh build's.
               "nve drift": NVE on the dense fp32 field at two steps over
               the same time; the excursion ratio shows velocity Verlet's
               O(dt^2) error (gated >= DRIFT_RATIO_MIN).

11. export -- the export loop on the cheb slice's field. "export":
               bench.py's corroboration run (EXPORT_STEPS steps saved
               every EXPORT_SAVE, exported every EXPORT_INTERVAL, forces
               and energies, the default gptq) with files and without,
               interleaved A, B in EXPORT_PAIRS pairs: each throughput,
               each pair's ratio and the ratio of the medians, ms per
               launch fetched (the wait for its copy) and
               written; gated: the exact file names, their (S, frames,
               ...) shapes and float32, the files equal to the frames, the
               coordinates bitwise those of the run without files, 3/2/1
               launches per force evaluation. "components": every energy
               component, the SchNet force component and the shape log
               over COMPONENT_STEPS: one more evaluation's launches per
               save point, the components summing to the potential.
               "resume": 2 RESUME_N steps straight against RESUME_N and a
               resume from the checkpoint, on the cheb slice and on PT at
               126 slots: frames bitwise equal; PT's acceptance npys sum
               to its cumulative matrix. "pair floor":
               benchmarks/pair_floor_traj.py's protocol cut to
               FLOOR_STEPS steps (its 5,000 to keep the run inside half
               its time limit), saved every FLOOR_SAVE, launches of
               FLOOR_LAUNCH: the
               smallest pair distance at the save points and its step
               beside the reference's FLOOR_REFERENCE (measured, not
               gated). "guard": NVE on the dense fp32 field at GUARD_DT
               in launches of GUARD_LAUNCH_STEPS raises at the launch
               after the blow-up's.

12. mixed -- mixed-size batches through a list of per-molecule fields.
               "mixed forces": 2 x 266 + 2 x 532 beads padded to 532 at
               MIXED_ORDERS on the shared weights: card vs CPU plain on
               cheb, pallas, dense and xla (bf16, FORCE_BOUND; xla with
               every counter 0), the padded rows' forces exactly 0 on the
               card; at fp32 each molecule's rows against its own
               homogeneous evaluation on the card (CROSS_BOUND). "mixed":
               benchmarks/run_all.py:_cfg_mixed (MIXED_HALF x 266 +
               MIXED_HALF x 532, gptq None) for STEPS steps: launches
               3/2/1 per force evaluation, every other counter 0, no twin
               call, every frame's padded rows bitwise the initial ladder,
               the real atoms moved, <filename>_atom_mask.npy equal to the
               mask; throughput, the pair floor, a profiler window, the
               three stacked cheb kernels at S = 32, A = 532 against their
               twins (live pairs, bound), and the padding overhead against
               the same molecules as two homogeneous batches. "mixed
               pallas": MIXED_PALLAS_STEPS steps on the neighbour-matrix
               kernels (list rebuilt every step; the padding's rows
               empty): launches 3 + 3 per force evaluation, frozen
               padding, n_max <= K.

13. widths -- the exact-filter kernels at other widths than the zoo's F
               128, R 50 (ops/cfconv_general.py: F <= 128, R <= 64 on the
               tuned kernels zero-padded to F 128, every other width on
               the general-width kernels of
               csrc/cfconv_general_kernels.cu: at bf16 the tensor-core
               tiles, gw_*_mma_kernel with the weights staged whole in
               each block or, where they do not fit, gp_*_kernel with
               them streamed in panels (the "streamed" family), whose
               registers, spills (gated 0) and HMMA count (gated above 0)
               print with the build's MMA lines; at fp32 and for the
               "wide" bf16 family (widths where neither fits) the
               CUDA-core instantiations: gf_*_kernel with the weights
               staged in shared memory or streamed through it in panels
               (the library's cfconv_general_layout), gw_*_kernel (the
               first design) where neither fits and for the forward and
               gx pass at Fp 64, whose registers and
               spills print with the build lines, spills gated 0 where
               the tiles are in shared memory, HMMA gated 0). Each of the
               four kernels at each (F, R) of WIDTHS (F 640, R 8: the
               first design's kernels at fp32, the streamed tiles at
               bf16, on 16 molecules), at S = BATCH, A = N_ATOMS on the
               start positions and the pallas slice's list rule: fp32 and
               bf16, the backwards with and without gx, two launches
               bitwise equal at each tier, against its twin, timed beside
               its bound (2 (R F + F^2) FLOP per live pair or slot
               forward, twice that backward; the fp32 line names the
               CUDA-core kernels that ran with their layout, registers,
               spills and warps a block, the bf16 line the family and
               tensor-core kernels with their registers, spills, HMMA
               count and warps a block); the padded widths beside the F
               128, R 50 kernels' times; the neighbour backward's peak
               memory at F 256, R 50 (gated below NBR_BWD_MEMORY_LIMIT at
               both tiers). Then the widths slices at WIDTH_SLICES
               (SchNet's published widths F 64, R 300 with CGSchNet's
               tanh filter, and F 256, R 50), each a SchNet of
               hidden_channels = num_filters = F, num_rbf = R, 3 blocks
               from SchNetConfig and init_schnet on the zoo's chain,
               priors and head: pallas bf16, pallas fp32 (gptq None),
               dense bf16 and dense fp32 (gptq None); and at OC20_WIDTHS
               (the Open Catalyst SchNet: hidden 1,024, F 256, R 200, 5
               blocks, on the streamed tiles) pallas bf16 and dense bf16.
               Each: forces at FORCE_BATCH card (no twin call) vs CPU
               twins (FORCE_BOUND, CROSS_BOUND at fp32), then WIDTH_STEPS
               BAOAB steps (WIDTH_SHORT_STEPS at WIDTH_SLICES)
               with the routed family's forward and backward once per
               block and force evaluation, every other counter 0, no twin
               call, finite positions; throughput, ms/step, peak device
               memory, the filter weights' preparations
               (ops/cfconv_general.py general_weights) and a profiler
               window.

Then a kernels JSON line (the general family's entries after the others:
each slice's forward and backward with its launches and the kernel-level
numbers at its width and tier), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

BATCH = 128
N_ATOMS = 266
STEPS = 120
SAVE_INTERVAL = 20
FORCE_BATCH = 4
PROFILE_STEPS = 5
# Bounds on max|kernel - plain| / max|plain|: the JAX suite's own kernel
# tolerances at fp32 (tests/ops/test_cheb_kernel.py); in bf16 only the
# summation order and recurrence ulps differ between kernel and twin; at
# bf16x3 (near float32) also the order of the three bf16 products.
BOUNDS = {
    ("cheb_fwd", "fp32"): 1e-5,
    ("cheb_bwd_gx", "fp32"): 1e-4,
    ("cheb_bwd_gd", "fp32"): 1e-4,
    ("cheb_bwd_gxgd", "fp32"): 1e-4,
    ("cheb_fwd", "bf16"): 2e-3,
    ("cheb_bwd_gx", "bf16"): 2e-3,
    ("cheb_bwd_gd", "bf16"): 2e-3,
    ("cheb_bwd_gxgd", "bf16"): 2e-3,
    ("cheb_fwd", "bf16x3"): 1e-4,
    ("cheb_bwd_gx", "bf16x3"): 1e-4,
    ("cheb_bwd_gd", "bf16x3"): 1e-4,
    ("cheb_bwd_gxgd", "bf16x3"): 1e-4,
    ("dense_cfconv_fwd", "fp32"): 1e-5,
    ("dense_cfconv_bwd", "fp32"): 1e-4,
    ("dense_cfconv_fwd", "bf16"): 2e-3,
    ("dense_cfconv_bwd", "bf16"): 2e-3,
    ("cfconv_fwd", "fp32"): 1e-5,
    ("cfconv_bwd", "fp32"): 1e-4,
    ("cfconv_fwd", "bf16"): 2e-3,
    ("cfconv_bwd", "bf16"): 2e-3,
}
FORCE_BOUND = 2e-3
# The fit phase: the in-graph fit at the slice's (48, 64) on d_min 2.0
# against the float64 host fit, max|d|/max|host| per block and series
# (float32 tanhf/expf within 2 ulp; about 1e-6 on the CPU), and the host
# fit's other two methods.
FIT_NODES = 512
FIT_BOUND = 1e-4
FIT_METHODS = ("wls", "lawson")
# radial-basis envelopes of the envelope phase, on the slice's rc = 10
ENVELOPES = (("identity", "IdentityCutoff", (0.0, 10.0)),
             ("shifted cosine", "ShiftedCosineCutoff", (0.0, 10.0, 0.5)))
# pallas fp32 vs dense fp32 forces, periodic (folded) vs open (unfolded)
# fp32 network forces, and per-block vs stacked cheb fp32 forces: one
# function, two summation orders.
CROSS_BOUND = 1e-4
# The periodic per-block run's steps: shorter than the slices', to stay
# well inside the time limit.
PERBLOCK_PERIODIC_STEPS = 40
# The bf16x3 slice's stacked run; the short periodic and per-block periodic
# runs of the bf16x3 and fp32 slices and the bf16x3 per-block run, which
# put each variant of the tier on a path.
BF16X3_STEPS = 40
TIER_SHORT_STEPS = 10
# The dense fp32 slice (the port's fidelity yardstick at full width) and the
# pallas fp32 slice (the neighbour-matrix kernels at fp32).
DENSE_FP32_STEPS = 40
PALLAS_FP32_STEPS = 40
# bf16x3 forces against another near-fp32 evaluation of the same function
# (card vs CPU, per-block vs stacked, fp32 on the same fit): summation and
# product order, and the splits' ~5e-6 of max|F| against fp32.
BF16X3_BOUND = 1e-4
OVERFLOW_CAPACITY = 32
# Peak device memory of one bf16 cfconv_bwd above its inputs: gd [S, A, K],
# gpos and gx take 29 MB at the pallas slice's shape, the [S, A, K, F]
# workspace that the bf16 backward must not allocate 1.5 GB.
NBR_BWD_MEMORY_LIMIT = 100 * 10**6
# The xla slice: its run under the periodic slice's cubic cell, and the
# image-replicated run at reduced size. That run's cell is below the
# minimum-image regime along x only (15 A < 2 (rcut + skin) = 22 A, and
# < 2 rcut: a pair has two x images within rcut), 21 A along y and z, so
# that its 2 x 1 x 1 supercell (30 x 21 x 21) is sound at rcut without
# images.
XLA_STEPS = 40
XLA_CELL_STEPS = 20
XLA_IMAGE_ATOMS = 64
XLA_IMAGE_STEPS = 10
XLA_IMAGE_CELL = np.diag([15.0, 21.0, 21.0])
# The integrator phases. NVE drift: dense fp32 (forces the autograd of its
# energy) at batch NVE_DRIFT_BATCH over the same time at two steps, 20 save
# points each; velocity Verlet's energy error is O(dt^2), 4x at half the
# step, gated at DRIFT_RATIO_MIN. Parallel tempering:
# benchmarks/run_all.py:_cfg_pt (42 structures x 3 betas = 126 slots),
# exchanging every 10 steps (examples/parallel_tempering.yaml: 100, which
# would give one exchange in STEPS).
NVE_DRIFT_BATCH = 16
NVE_DRIFT_RUNS = ((0.004, 200), (0.002, 400))
DRIFT_RATIO_MIN = 3.0
PT_INDEP = 42
PT_BETAS = [1.67, 1.42, 1.16]
PT_SAVE_INTERVAL = 10
PT_EXCHANGE_INTERVAL = 10
# The export loop: bench.py's corroboration run (bench.py:184-211: 400
# steps saved every 100, exported every 200, forces and energies, the list
# rebuilt every 10) cut to half its steps, save and export intervals (two
# export segments as there), with and without files, interleaved A, B in
# EXPORT_PAIRS pairs (late in the process the same slice reads 0.69-1.08x
# its first run, and a pair's two runs differ by up to 20 % on this
# host-bound slice; PERF.md section 7). A short run with the
# energy and force components and the shape log (COMPONENT_STEPS). Resume:
# the cheb slice and PT (126 slots, exchange every RESUME_EXCHANGE: an odd
# count per segment) over 2 N steps straight, and N plus a resume to 2 N. The
# guard: the dense fp32 field at GUARD_DT. The pair floor:
# benchmarks/pair_floor_traj.py's protocol (5000 steps saved every 25,
# launches of 1000 steps) cut to FLOOR_STEPS in launches of FLOOR_LAUNCH,
# the reference's 2.047 A beside it. (These cuts, and those of the xla,
# mesh, command-line and widths runs, keep the whole run inside half its
# time limit.)
EXPORT_STEPS = 200
EXPORT_SAVE = 50
EXPORT_INTERVAL = 100
EXPORT_REBUILD = 10
EXPORT_PAIRS = 2
COMPONENT_STEPS = 40
RESUME_N = 100
RESUME_SAVE = 20
RESUME_EXCHANGE = 20
GUARD_DT = 10.0
GUARD_LAUNCH_STEPS = 10
GUARD_MAX_STEPS = 400
FLOOR_STEPS = 500
FLOOR_SAVE = 25
FLOOR_LAUNCH = 125
FLOOR_REFERENCE = 2.047
# The command line: examples/langevin.yaml at BATCH and
# examples/parallel_tempering.yaml at PT_INDEP x 3 betas as they are but
# for their 500 steps, cut to CLI_STEPS; the NVE and the optimisations-off
# runs (no kernel of their own) cut shorter.
CLI_STEPS = 200
CLI_NVE_STEPS = 120
CLI_OFF_STEPS = 40
# Mixed-size batches: benchmarks/run_all.py:_cfg_mixed (16 molecules of 266
# beads and 16 of 532 in one batch, padded to 532; cheb bf16 with the
# explicit orders (64, 64) on d_min 2.0 that both sizes share, as the
# size-aware defaults differ at 266 and 532; seed 0; dt 0.004, friction
# 1.0, beta 1.67), STEPS steps; its neighbour-matrix run is shorter.
MIXED_SIZES = (266, 532)
MIXED_HALF = 16
MIXED_ORDERS = dict(cheb_order=64, cheb_order_deriv=64, cheb_d_min=2.0)
MIXED_PALLAS_STEPS = 20
# The other prior kinds, card vs CPU: float32 elementwise terms, summed in
# another order.
PRIOR_BOUND = 1e-5
# benchmarks/pbc_ab.py's cell, and a sound triclinic one (smallest
# perpendicular width 59.04 A; rows are lattice vectors).
BOX = 60.0
CELL_TRICLINIC = [[60.0, 0.0, 0.0], [10.0, 60.0, 0.0], [5.0, 5.0, 60.0]]
# float32 operations of one minimum-image wrap of a pair displacement:
# frac (15), rint (3), rel -= n cell (18).
WRAP_FLOPS = 36
REPLACES = {
    "cheb_fwd": "flashmd_tpu/ops/pallas/cheb_kernel.py:394",
    "cheb_bwd_gx": "flashmd_tpu/ops/pallas/cheb_kernel.py:476",
    "cheb_bwd_gd": "flashmd_tpu/ops/pallas/cheb_kernel.py:476",
    "cheb_fwd_cell": "flashmd_tpu/ops/pallas/cheb_kernel.py:394 (has_cell)",
    "cheb_bwd_gx_cell":
        "flashmd_tpu/ops/pallas/cheb_kernel.py:476 (has_cell)",
    "cheb_bwd_gd_cell":
        "flashmd_tpu/ops/pallas/cheb_kernel.py:476 (has_cell)",
    "cheb_bwd_gxgd": "flashmd_tpu/ops/pallas/cheb_kernel.py:476 "
                     "(need_gx, need_gd)",
    "cheb_bwd_gxgd_cell": "flashmd_tpu/ops/pallas/cheb_kernel.py:476 "
                          "(need_gx, need_gd, has_cell)",
    "dense_cfconv_fwd": "flashmd_tpu/ops/pallas/cfconv_dense.py:126",
    "dense_cfconv_bwd": "flashmd_tpu/ops/pallas/cfconv_dense.py:147",
    "cfconv_fwd": "flashmd_tpu/ops/pallas/cfconv.py:137",
    "cfconv_bwd": "flashmd_tpu/ops/pallas/cfconv.py:163",
}
# The bf16x3 tier of the four cheb kernels: the same kernels with their
# products through _mxu_dot's three bf16 passes.
_CHEB = [n for n in REPLACES if n.startswith("cheb")]
REPLACES.update({
    name + "_bf16x3": f"{REPLACES[name]} bf16x3 (_mxu_dot :358)"
    for name in _CHEB
})
# Its fp32 tier: all four on the CUDA-core live-pair kernels; and the
# exact-filter kernels' fp32 tier, launched by the dense fp32 and pallas
# fp32 slices.
REPLACES.update({name + "_fp32": f"{REPLACES[name]} fp32"
                 for name in [*_CHEB, "dense_cfconv_fwd", "dense_cfconv_bwd",
                              "cfconv_fwd", "cfconv_bwd"]})
SOURCES = {
    "cheb": "flashmd_tpu_torch/csrc/cheb_kernels.cu",
    "dense": "flashmd_tpu_torch/csrc/cfconv_dense_kernels.cu",
    "cfconv": "flashmd_tpu_torch/csrc/cfconv_kernels.cu",
}
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W). bf16x3
# takes three bf16 passes per product: a third of the bf16 rate.
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "bf16x3": 989e12 / 3}
PEAK_BYTES = 3.35e12
# The exact-filter kernels at other widths than the zoo's (F 128, R 50),
# routed by ops/cfconv_general.py: the kernel-level (F, R) at S = BATCH,
# A = N_ATOMS (SchNet's published widths, F 256, two widths padded onto the
# tuned kernels and R 100), and the two configurations of the widths
# slices: SchNet's published widths (Schuett et al., NeurIPS 2017: 64
# features, 300 Gaussians) with CGSchNet's tanh filter, and F 256 at R 50
# (the width of the JAX package's TPU lane, tests/ops/test_tpu_lane.py).
# F 640 at R 8 is the narrowest width that the first design's CUDA-core
# kernels take at fp32 (gw_*; the streamed tensor-core tiles at bf16), on
# the first 16 molecules (WIDTH_BATCHES): its dense twins hold [S, A, A,
# 640] float32 tensors (23 GB each at S = BATCH). F 256 at R 200 is the
# Open Catalyst SchNet's filter (OC20_WIDTHS), a streamed width at bf16.
# The OC20 slices run WIDTH_STEPS steps, those at WIDTH_SLICES
# WIDTH_SHORT_STEPS.
WIDTHS = ((64, 300), (256, 50), (96, 50), (64, 32), (128, 100), (640, 8),
          (256, 200))
WIDTH_BATCHES = {(640, 8): 16}
WIDTH_SLICES = ((64, 300), (256, 50))
WIDTH_RUNS = (("pallas", "bf16"), ("pallas", "fp32"), ("dense", "bf16"),
              ("dense", "fp32"))
# The Open Catalyst Project's SchNet baseline (Chanussot et al., ACS Catal.
# 2021; configs/s2ef/all/schnet/schnet.yml: hidden_channels 1024,
# num_filters 256, num_interactions 5, num_gaussians 200) as (F, R, hidden,
# blocks), on the zoo's chain, priors, head and 10 A cutoff with CGSchNet's
# tanh filter (OC20's 6 A cutoff and shifted-softplus filter belong to its
# atomistic systems; the dense and pallas kernels take tanh only, as the
# reference's do). Its filter, F 256 R 200, is a "streamed" width at bf16;
# its slices run pallas and dense at bf16.
OC20_WIDTHS = (256, 200, 1024, 5)
OC20_RUNS = (("pallas", "bf16"), ("dense", "bf16"))
WIDTH_STEPS = 40
WIDTH_SHORT_STEPS = 20
WIDTH_SEED = 11
GENERAL_SOURCE = "flashmd_tpu_torch/csrc/cfconv_general_kernels.cu"
MMA_SOURCE = "flashmd_tpu_torch/csrc/cfconv_general_mma_kernels.cu"


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


# The tensor-core kernels' template arguments in their mangled names:
# cheb_gd_mma_kernel<TIER, HAS_CELL>, cheb_rows_mma_kernel<TIER, GX,
# HAS_CELL>, cheb_gxgd_mma_kernel<TIER, HAS_CELL>, dense_bwd_mma_kernel<GX>;
# dense_fwd_mma_kernel, nbr_fwd_mma_kernel, nbr_bwd_mma_kernel and
# nbr_gx_mma_kernel (bf16, no template arguments).
MMA_KERNELS = {
    "gd": re.compile(r"cheb_gd_mma_kernelILi(\d)ELb([01])E"),
    "rows": re.compile(r"cheb_rows_mma_kernelILi(\d)ELb([01])ELb([01])E"),
    "gxgd": re.compile(r"cheb_gxgd_mma_kernelILi(\d)ELb([01])E"),
    "dense": re.compile(r"dense_bwd_mma_kernelILb([01])E"),
    "dense fwd": re.compile(r"(?<!gw_)dense_fwd_mma_kernel"),
    "cfconv fwd": re.compile(r"(?<!gw_)nbr_fwd_mma_kernel"),
    "cfconv": re.compile(r"nbr_bwd_mma_kernel"),
    "cfconv gx": re.compile(r"(?<!gw_)nbr_gx_mma_kernel"),
    "general dense fwd": re.compile(r"gw_dense_fwd_mma_kernel"),
    "general nbr fwd": re.compile(r"gw_nbr_fwd_mma_kernel"),
    "general gx": re.compile(r"gw_nbr_gx_mma_kernel"),
    "general bwd": re.compile(r"gw_bwd_mma_kernelILb([01])ELb([01])E"),
    "streamed dense fwd": re.compile(r"gp_dense_fwd_kernel"),
    "streamed nbr fwd": re.compile(r"gp_nbr_fwd_kernel"),
    "streamed gx": re.compile(r"gp_nbr_gx_kernel"),
    "streamed bwd": re.compile(r"gp_bwd_kernelILb([01])ELb([01])E"),
}
# The labels of the kernels without template arguments.
MMA_SINGLE = {
    "dense fwd": "dense_fwd_mma_kernel (dense_cfconv_fwd)",
    "cfconv fwd": "nbr_fwd_mma_kernel (cfconv_fwd)",
    "cfconv": "nbr_bwd_mma_kernel (cfconv_bwd, first pass)",
    "cfconv gx": "nbr_gx_mma_kernel (cfconv_bwd, gx pass)",
    "general dense fwd": "gw_dense_fwd_mma_kernel (general-width "
                         "dense_cfconv_fwd)",
    "general nbr fwd": "gw_nbr_fwd_mma_kernel (general-width cfconv_fwd)",
    "general gx": "gw_nbr_gx_mma_kernel (general-width cfconv_bwd, gx pass)",
    "streamed dense fwd": "gp_dense_fwd_kernel (general-width "
                          "dense_cfconv_fwd, weights streamed)",
    "streamed nbr fwd": "gp_nbr_fwd_kernel (general-width cfconv_fwd, "
                        "weights streamed)",
    "streamed gx": "gp_nbr_gx_kernel (general-width cfconv_bwd, gx pass, "
                   "weights streamed)",
}
# gw_bwd_mma_kernel<GX, NBR>'s and gp_bwd_kernel<GX, NBR>'s instantiations:
# dense with and without gx, the neighbour matrix.
MMA_GENERAL_BWD = (("1", "0"), ("0", "0"), ("0", "1"))
# {label: (registers, spill stores, spill loads, tensor-core instructions)}
# of the tensor-core kernels, read by mma_kernel_report at the build.
MMA_BUILD = {}
MMA_TIERS = {"1": "bf16", "3": "bf16x3"}


def _mma_match(name):
    """(kind, template arguments) of a tensor-core kernel's mangled name,
    or None."""
    for kind, pat in MMA_KERNELS.items():
        m = pat.search(name)
        if m:
            return kind, m.groups()
    return None


def _mma_label(kind, args):
    if kind in MMA_SINGLE:
        return f"{kind} kernel {MMA_SINGLE[kind]} bf16"
    if kind in ("gd", "gxgd"):
        t, c = args
        return (f"{kind} kernel cheb_{kind}_mma_kernel {MMA_TIERS[t]} "
                f"{'cell' if c == '1' else 'open'}")
    if kind == "dense":
        return (f"dense kernel dense_bwd_mma_kernel bf16 "
                f"{'with gx' if args[0] == '1' else 'no gx'}")
    if kind in ("general bwd", "streamed bwd"):
        gx, nbr = args
        return (f"general kernel "
                f"{'gw_bwd_mma' if kind == 'general bwd' else 'gp_bwd'}"
                "_kernel bf16 "
                + ("nbr" if nbr == "1" else
                   "dense with gx" if gx == "1" else "dense no gx"))
    t, gx, c = args
    return (f"rows kernel cheb_rows_mma_kernel {'gx' if gx == '1' else 'fwd'}"
            f" {MMA_TIERS[t]} {'cell' if c == '1' else 'open'}")


# Pairs per batch of the fp32 CUDA-core kernels (LF_PB in
# csrc/cheb_kernels.cu): a warp pads its last batch up to it.
LF_PB = 16
# {label: (registers, spill stores, spill loads)} of the fp32 CUDA-core
# kernels, read from ptxas by ffma_kernel_report at the build.
FFMA_BUILD = {}
# The fp32 CUDA-core live-pair kernels' template arguments in their mangled
# names: cheb_rows_ffma_kernel<GX, HAS_CELL>, cheb_gd_ffma_kernel<HAS_CELL>,
# cheb_gxgd_ffma_kernel<HAS_CELL>, dense_bwd_ffma_kernel<GX>,
# nbr_bwd_ffma_kernel<GX>; dense_fwd_ffma_kernel and nbr_fwd_ffma_kernel (no
# template arguments).
FFMA_KERNELS = {
    "rows": re.compile(r"cheb_rows_ffma_kernelILb([01])ELb([01])E"),
    "gd": re.compile(r"cheb_gd_ffma_kernelILb([01])E"),
    "gxgd": re.compile(r"cheb_gxgd_ffma_kernelILb([01])E"),
    "dense": re.compile(r"dense_bwd_ffma_kernelILb([01])E"),
    "nbr": re.compile(r"nbr_bwd_ffma_kernelILb([01])E"),
    "dense fwd": re.compile(r"dense_fwd_ffma_kernel"),
    "nbr fwd": re.compile(r"nbr_fwd_ffma_kernel"),
}
# The fp32 CUDA-core live-pair kernels' labels, as ffma_label gives them.
FFMA_LABELS = (
    *(f"cheb_rows_ffma_kernel {kind} {c}" for kind in ("fwd", "gx")
      for c in ("open", "cell")),
    *(f"cheb_{kind}_ffma_kernel {c}" for kind in ("gd", "gxgd")
      for c in ("open", "cell")),
    *(f"{name}_ffma_kernel {gx}" for name in ("dense_bwd", "nbr_bwd")
      for gx in ("with gx", "no gx")),
    "dense_fwd_ffma_kernel", "nbr_fwd_ffma_kernel",
)


def ffma_label(name):
    """"cheb_rows_ffma_kernel fwd open", ... of a mangled kernel name, or
    None for another kernel."""
    m = FFMA_KERNELS["rows"].search(name)
    if m:
        return (f"cheb_rows_ffma_kernel {'gx' if m.group(1) == '1' else 'fwd'}"
                f" {'cell' if m.group(2) == '1' else 'open'}")
    for kind in ("dense", "nbr"):
        m = FFMA_KERNELS[kind].search(name)
        if m:
            return (f"{kind}_bwd_ffma_kernel "
                    f"{'with gx' if m.group(1) == '1' else 'no gx'}")
    for kind in ("dense", "nbr"):
        if FFMA_KERNELS[f"{kind} fwd"].search(name):
            return f"{kind}_fwd_ffma_kernel"
    for kind in ("gd", "gxgd"):
        m = FFMA_KERNELS[kind].search(name)
        if m:
            return (f"cheb_{kind}_ffma_kernel "
                    f"{'cell' if m.group(1) == '1' else 'open'}")
    return None


def ffma_kernel_report(log):
    """{label: (registers, spill stores, spill loads)} of the fourteen fp32
    CUDA-core live-pair instantiations (FFMA_LABELS: cheb fwd, gx, gd,
    gx+gd, open and cell; the dense and the neighbour-matrix backward with
    and without gx; the dense and the neighbour-matrix forward), printed;
    fails if one is missing."""
    seen = {}
    for line in ptxas_summary(log):
        label = ffma_label(line.split(":")[0])
        if label:
            regs = int(re.search(r": (\d+) regs", line).group(1))
            st, ld = map(int, re.search(r"spill (\d+)/(\d+) B",
                                        line).groups())
            seen[label] = (regs, st, ld)
    for label in FFMA_LABELS:
        check(label in seen, f"{label}: not built")
    for label, (regs, st, ld) in sorted(seen.items()):
        print(f"build: fp32 kernel {label}: {regs} regs, spill {st}/{ld} B")
    FFMA_BUILD.update(seen)
    return seen


# {label: (registers, spill stores, spill loads)} of the general-width
# CUDA-core kernels, read from ptxas by general_kernel_report at the build:
# the first design's gw_dense_fwd_kernel<GT>, gw_nbr_fwd_kernel<GT>,
# gw_nbr_gx_kernel<GT> and gw_bwd_kernel<GX, NBR, GT> (GT: the tiles in
# device memory), and gf_dense_fwd_kernel<PANEL>, gf_nbr_fwd_kernel<PANEL>,
# gf_nbr_gx_kernel<PANEL> and gf_bwd_kernel<GX, NBR, PANEL> (the weights
# staged in shared memory, or streamed through it in panels).
GENERAL_BUILD = {}
_GENERAL_KINDS = ("dense_fwd_kernel", "nbr_fwd_kernel", "nbr_gx_kernel",
                  "bwd_kernel dense with gx", "bwd_kernel dense no gx",
                  "bwd_kernel nbr")
GENERAL_LABELS = (
    *(f"gw_{k}{gt}" for k in _GENERAL_KINDS
      for gt in ("", " (tiles in device memory)")),
    *(f"gf_{k}{pn}" for k in _GENERAL_KINDS
      for pn in (" (weights staged)", " (weights in panels)")),
)
# (prefix, label suffix) of each layout code of the library's
# cfconv_general_layout: staged, panels, the first design's kernels.
LAYOUT_LABEL = {0: ("gf_", " (weights staged)"),
                1: ("gf_", " (weights in panels)"), -1: ("gw_", "")}


def general_label(name):
    """The GENERAL_LABELS entry of a mangled general-width CUDA-core kernel
    name, or None for another kernel (the tensor-core ones included)."""
    if "_mma_kernel" in name:
        return None
    m = re.search(r"(g[wf]_\w+?_kernel)I((?:Lb[01]E)+)E", name)
    if not m:
        return None
    flags = re.findall(r"Lb([01])E", m.group(2))
    label = m.group(1)
    if label.endswith("_bwd_kernel"):
        gx, nbr, _ = flags
        label += (" nbr" if nbr == "1" else
                  " dense with gx" if gx == "1" else " dense no gx")
    if label.startswith("gf_"):
        return label + (" (weights in panels)" if flags[-1] == "1"
                        else " (weights staged)")
    return label + (" (tiles in device memory)" if flags[-1] == "1" else "")


def general_kernels(f, r):
    """{case: [(label, kind)]} of the CUDA-core kernels that the fp32 tier
    runs at F filters and R radial functions, as the library's
    cfconv_general_layout routes each kind (0 forward and gx pass, 1
    backward, 2 dense backward with gx; the kinds of
    cfconv_general_warps)."""
    from flashmd_tpu_torch.ops._build import load

    fp, rq = -(-f // 64) * 64, -(-r // 64) * 64

    def label(kernel, kind):
        pre, sfx = LAYOUT_LABEL[load().cfconv_general_layout(kind, fp, r,
                                                             rq)]
        return f"{pre}{kernel}{sfx}", kind

    return {
        "dense fwd": [label("dense_fwd_kernel", 0)],
        "dense bwd": [label("bwd_kernel dense with gx", 2)],
        "dense bwd (no gx)": [label("bwd_kernel dense no gx", 1)],
        "nbr fwd": [label("nbr_fwd_kernel", 0)],
        "nbr bwd": [label("bwd_kernel nbr", 1), label("nbr_gx_kernel", 0)],
        "nbr bwd (no gx)": [label("bwd_kernel nbr", 1)],
    }


def general_kernel_report(log):
    """Registers and spills of the general-width CUDA-core kernels'
    instantiations (GENERAL_LABELS), printed; fails if one is missing or
    one with its tiles in shared memory spills."""
    for line in ptxas_summary(log):
        label = general_label(line.split(":")[0])
        if label:
            regs = int(re.search(r": (\d+) regs", line).group(1))
            st, ld = map(int, re.search(r"spill (\d+)/(\d+) B",
                                        line).groups())
            GENERAL_BUILD[label] = (regs, st, ld)
    for label in GENERAL_LABELS:
        check(label in GENERAL_BUILD, f"{label}: not built")
        regs, st, ld = GENERAL_BUILD[label]
        print(f"build: general kernel {label}: {regs} regs, spill {st}/{ld} "
              "B")
        check("device memory" in label or st == ld == 0, f"{label} spills")


def mma_kernel_report(log, lib_path, nvcc):
    """The tensor-core kernels' instantiations: cheb_gd_mma_kernel and
    cheb_gxgd_mma_kernel (bf16, bf16x3; open, cell), cheb_rows_mma_kernel
    (also fwd, gx), dense_bwd_mma_kernel (with and without gx), the bf16
    kernels of MMA_SINGLE and the general-width gw_bwd_mma_kernel and
    gp_bwd_kernel (MMA_GENERAL_BWD): ptxas registers, static shared memory
    and spills, and the tensor-core instructions (HMMA/HGMMA) in their SASS
    (kept in MMA_BUILD). Fails if one is missing, spills or holds no
    tensor-core instruction, or if one of the general-width CUDA-core
    kernels (GENERAL_LABELS, fp32 and the wide bf16 family) holds one."""
    from pathlib import Path

    seen, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        key = _mma_match(name) if m and name else None
        if key:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            seen[key] = [int(m.group(1)), smem.group(1) if smem else "0",
                         spill or (0, 0), 0]
        if m:
            name, spill = None, None
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    cuda_core = {}
    for part in sass.split("Function : ")[1:]:
        fname = part.split("\n", 1)[0]
        key = _mma_match(fname)
        label = general_label(fname)
        if key not in seen and not label:
            continue
        n_mma = part.count("HMMA.") + part.count("HGMMA.")
        if key in seen:
            seen[key][3] = n_mma
        if label:
            cuda_core[label] = n_mma
    expected = [("gd", (t, c)) for t in MMA_TIERS for c in "01"]
    expected += [("rows", (t, gx, c)) for gx in "01" for t in MMA_TIERS
                 for c in "01"]
    expected += [("gxgd", (t, c)) for t in MMA_TIERS for c in "01"]
    expected += [("dense", (gx,)) for gx in "01"]
    expected += [(kind, ()) for kind in MMA_SINGLE]
    expected += [(kind, args) for args in MMA_GENERAL_BWD
                 for kind in ("general bwd", "streamed bwd")]
    for label in GENERAL_LABELS:
        check(label in cuda_core, f"{label}: not in the SASS")
        print(f"build: general kernel {label}: {cuda_core[label]} "
              "tensor-core MMA instructions in SASS (CUDA cores: 0)")
        check(cuda_core[label] == 0,
              f"{label}: tensor-core instructions in a CUDA-core kernel")
    for key in expected:
        label = _mma_label(*key)
        check(key in seen, f"{label}: not built")
        regs, smem, (st, ld), n_mma = seen[key]
        print(f"build: {label}: {regs} regs, {smem} B static smem (+ dynamic "
              f"per launch), spill {st}/{ld} B, {n_mma} tensor-core MMA "
              "instructions in SASS")
        check(st == 0 and ld == 0, f"{label} spills")
        check(n_mma > 0, f"{label}: no tensor-core instruction in its SASS")
        MMA_BUILD[label] = (regs, st, ld, n_mma)


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


def bound(flops, nbytes, tier, fp32_flops=0.0):
    """(ms, "operations" or "bytes"): the least time the card could take;
    ``flops`` are products at the tier's peak, ``fp32_flops`` float32
    elementwise work at the float32 peak."""
    t_ops = (flops / PEAK_FLOPS[tier] + fp32_flops / PEAK_FLOPS["fp32"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _nearer_split(out_k, out_p, out_f):
    """max over outputs of ||kernel - bf16x3 twin|| / ||kernel - fp32
    twin|| (Frobenius): below 1 only if the kernel takes the splits."""
    return max(float(torch.linalg.norm(k - p) / torch.linalg.norm(k - f))
               for k, p, f in zip(out_k, out_p, out_f))


# {(label, tier): numbers} of every compare_and_time call of this run.
TIER_STATS = {}


def compare_and_time(name, kern, plain, flops, nbytes, label=None,
                     fp32_flops=0.0, precs=("fp32", "bf16"), fp32_note="",
                     repeat=False, bf16_note="", plain_iters=3):
    """Kernel vs twin (callables of the tier) and their CUDA-event times,
    held to ``name``'s bounds, at the tiers ``precs`` (returning the last
    one's numbers: bf16, the tier of the slices, by default); at bf16x3
    the kernel must also lie nearer its bf16x3 twin than the fp32 twin on
    the same inputs. The fp32 line ends with ``fp32_note``, the bf16 one
    with ``bf16_note``; with ``repeat``, a second fp32 launch must equal
    the first bitwise. The twin is timed over ``plain_iters`` calls after
    one more (1: the call just compared, which warmed it, is the only
    warm-up)."""
    results = {}
    for prec in precs:
        out_k = _tuple(kern(prec))
        torch.cuda.synchronize()
        note = f"; {bf16_note}" if prec == "bf16" and bf16_note else ""
        if prec == "fp32":
            note = f"; {fp32_note}" if fp32_note else ""
            if repeat:
                same = all(torch.equal(a, b)
                           for a, b in zip(out_k, _tuple(kern(prec))))
                note += f"; two launches bitwise equal: {same}"
                check(same, f"{label or name} fp32: two launches differ")
        out_p = _tuple(plain(prec))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(o).all()) for o in out_k),
              f"{name} {prec}: non-finite kernel output")
        abs_err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
        rel = max(float((k - p).abs().max() / p.abs().max())
                  for k, p in zip(out_k, out_p))
        ms = cuda_time_ms(lambda: kern(prec))
        plain_ms = cuda_time_ms(lambda: plain(prec),
                                warmup=int(plain_iters > 1),
                                iters=plain_iters)
        bound_ms, bound_by = bound(flops, nbytes, prec, fp32_flops)
        limit = BOUNDS[(name, prec)]
        print(f"kernels: {label or name} {prec} max|k-p|/max|p| = {rel:.3e} "
              f"(bound {limit:.0e}) max_abs_err {abs_err:.3e} kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms; least time "
              f"{bound_ms:.4f} ms by {bound_by} ({flops:.4e} FLOP, "
              f"{nbytes} B), {bound_ms / ms:.1%} of the kernel's{note}")
        check(rel <= limit,
              f"{label or name} {prec}: {rel:.3e} > {limit:.0e}")
        if prec == "bf16x3":
            near = _nearer_split(out_k, out_p, _tuple(plain("fp32")))
            print(f"kernels: {label or name} bf16x3 ||k-p_bf16x3|| / "
                  f"||k-p_fp32|| = {near:.3e} (must be < 1)")
            check(near < 1.0, f"{label or name}: nearer the fp32 twin than "
                              f"the bf16x3 one ({near:.3e})")
        results[prec] = {"max_abs_err": abs_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
        TIER_STATS[label or name, prec] = results[prec]
    return results[prec]


def cheb_pair_counts(pos, rcut, d_min, cell=None):
    """(pairs i != j with d < rcut, of which d < d_min, 16 x 8 pair
    fragments holding such a pair, all 16 x 8 fragments, 16 x 16
    fragments holding a pair with z != 1, all 16 x 16 fragments, pairs
    with z != 1) of the batch, minimum-imaged under ``cell``: the pairs
    whose basis, and whose sub-floor linear term, is nonzero, the only
    ones the cheb products need; the 16 x 8 fragments are the tensor-core
    gd kernel's mma tiles, the 16 x 16 ones the fwd/gx kernel's (its rule
    z != 1 keeps the diagonal), of which each runs the live ones; the fp32
    kernels run the pairs themselves (z != 1 for fwd/gx, the first count
    for gd)."""
    from flashmd_tpu_torch.ops.cheb_kernel import _geometry, pair_rel
    from flashmd_tpu_torch.ops.neighborlist import _inv_3x3

    rel = pair_rel(pos) if cell is None else pair_rel(pos, cell,
                                                      _inv_3x3(cell))
    d, z = _geometry(rel, rcut, d_min)
    off = ~torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
    live = (d < rcut) & off
    return (int(live.sum()), int(((d < d_min) & off).sum()),
            *live_chunks(live, rows=16, cols=8),
            *live_chunks(z != 1.0, rows=16, cols=16), int((z != 1.0).sum()))


def phase_cheb_kernels(ff, pos, dev, cell=None, tier=None, tag="",
                       stacked_only=False):
    """The four cheb kernels, open or, with ``cell`` [S, 3, 3], their
    cell variants (keys with "_cell"), at the slice's shapes, at fp32 and
    bf16 or, with ``tier`` "bf16x3" or "fp32", at that tier alone under
    keys with "_bf16x3" or "_fp32". The bounds count the products of the
    live pairs only (d < rcut off the diagonal; the linear term's d <
    d_min), as the basis is exactly zero beyond the cutoff. Each fp32 line
    of fwd, gx and gd adds the pairs the fp32 kernel runs, its registers
    and spills (FFMA_BUILD) and a bitwise repeat. ``tag`` ends every key
    and label; ``stacked_only`` times the three kernels of the stacked
    schedule alone."""
    from flashmd_tpu_torch.models.cheb import _lin_slope
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.ops.neighborlist import _inv_3x3

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
    m1, m2 = c.shape[0], c2.shape[0]
    n_live, n_low, n_frag, all_frag, n_rows, all_rows, n_z = (
        cheb_pair_counts(pos, rcut, d_min, cell))
    pair_flops = 2.0 * n_live
    low_flops = 2.0 * n_low * f if w_lin is not None else 0.0
    kw, suffix, wrap, cell_bytes = {}, "", 0.0, 0
    if cell is not None:
        # every pair is wrapped before its distance is known
        kw = {"cell": cell, "inv": _inv_3x3(cell)}
        suffix, wrap, cell_bytes = "_cell", WRAP_FLOPS * s * a * a, 72 * s
    if tier is not None:
        suffix += "_" + tier
    suffix += tag
    precs = ("fp32", "bf16") if tier is None else (tier,)
    variant = "cell" if cell is not None else "open"

    def fp32_note(kernel, pairs):
        regs = FFMA_BUILD.get(f"{kernel} {variant}")
        return (f"pairs run {pairs} of {s * a * a} (+ at most {LF_PB - 1} "
                f"padding slots per warp); {kernel} {variant}: "
                + (f"{regs[0]} regs, spill {regs[1]}/{regs[2]} B" if regs
                   else "registers not read"))

    notes = {
        "cheb_fwd": fp32_note("cheb_rows_ffma_kernel fwd", n_z),
        "cheb_bwd_gx": fp32_note("cheb_rows_ffma_kernel gx", n_z),
        "cheb_bwd_gd": fp32_note("cheb_gd_ffma_kernel", n_live),
        "cheb_bwd_gxgd": fp32_note("cheb_gxgd_ffma_kernel", n_z),
    }

    cases = {
        "cheb_fwd": (
            lambda p: ck.cheb_conv_fwd(c, w0, pos, x, rcut, p, d_min, w_lin,
                                       **kw),
            lambda p: ck.cheb_conv_fwd_plain(c, w0, pos, x, rcut, p, d_min,
                                             w_lin, **kw),
            pair_flops * f * m1 + low_flops,
            4 * (s * a * 3 + 2 * s * a * f + m1 * f + 2 * f),
        ),
        "cheb_bwd_gx": (
            lambda p: ck.cheb_conv_bwd_gx(c, w0, pos, g, rcut, p, d_min,
                                          w_lin, **kw),
            lambda p: ck.cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, p,
                                                d_min, w_lin, **kw),
            pair_flops * f * (m1 + 1) + low_flops,
            4 * (s * a * 3 + 2 * s * a * f + m1 * f + 2 * f),
        ),
        "cheb_bwd_gd": (
            lambda p: ck.cheb_conv_bwd_gd(c2_cat, pos, x_cat, g_cat, rcut, p,
                                          d_min, **kw),
            lambda p: ck.cheb_conv_bwd_gd_plain(c2_cat, pos, x_cat, g_cat,
                                                rcut, p, d_min, **kw),
            pair_flops * nb * f * m2,
            4 * (2 * s * a * 3 + 2 * s * a * nb * f + m2 * nb * f),
        ),
        # the per-block schedule's blocks 2..B: gx and gpos in one launch
        "cheb_bwd_gxgd": (
            lambda p: ck.cheb_conv_bwd_gxgd(c, c2, w0, pos, x, g, rcut, p,
                                            d_min, w_lin, **kw),
            lambda p: ck.cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, g, rcut,
                                                  p, d_min, w_lin, **kw),
            pair_flops * f * (m1 + 1 + m2) + low_flops,
            4 * (2 * s * a * 3 + 3 * s * a * f + (m1 + 1 + m2) * f + 2 * f),
        ),
    }
    if stacked_only:
        del cases["cheb_bwd_gxgd"]
    print(f"kernels: cheb{suffix} shapes S={s} A={a} F={f} (gd {nb * f}) "
          f"M1={m1} M2={m2} d_min={d_min}; live pairs (d < rc) {n_live} of "
          f"{s * a * a}, below d_min {n_low}; live 16x8 fragments (gd "
          f"kernel) {n_frag} of {all_frag} ({n_frag / all_frag:.4f}), "
          f"{128 * n_frag / (s * a * a):.4f} x all pairs; live 16x16 "
          f"fragments (fwd/gx kernel, z != 1) {n_rows} of {all_rows} "
          f"({n_rows / all_rows:.4f}), {256 * n_rows / (s * a * a):.4f} x "
          "all pairs")
    stats = {
        name + suffix: compare_and_time(name, kern, plain, flops,
                                        nbytes + cell_bytes,
                                        label=name + suffix, fp32_flops=wrap,
                                        precs=precs,
                                        fp32_note=notes.get(name, ""),
                                        repeat=name in notes)
        for name, (kern, plain, flops, nbytes) in cases.items()
    }
    if stacked_only:
        return stats
    # the combined kernel beside the composition of the two kernels that
    # compute its halves apart on the same operands, at each tier
    for prec in precs:
        def composition():
            ck.cheb_conv_bwd_gx(c, w0, pos, g, rcut, prec, d_min, w_lin,
                                **kw)
            ck.cheb_conv_bwd_gd(c2, pos, x, g, rcut, prec, d_min, **kw)

        comp_ms = cuda_time_ms(composition)
        gxgd_ms = TIER_STATS["cheb_bwd_gxgd" + suffix, prec]["ms"]
        runs = (f"pairs at z != 1 (run by the live-pair kernel) {n_z} of "
                f"{s * a * a}" if prec == "fp32" else
                f"live 16x16 fragments (z != 1, run by the combined kernel) "
                f"{n_rows} of {all_rows} ({n_rows / all_rows:.4f})")
        print(f"kernels: cheb_bwd_gxgd{suffix} {runs}; {prec} combined "
              f"{gxgd_ms:.4f} ms")
        print(f"kernels: cheb_bwd_gxgd{suffix} composition {prec} fit "
              f"({m1}, {m2}) {variant} (cheb_bwd_gx + one-block cheb_bwd_gd, "
              f"same operands) {comp_ms:.4f} ms beside the combined "
              f"{gxgd_ms:.4f} ms (ratio {gxgd_ms / comp_ms:.4f})")
    # the per-block schedule's block 1: the gd-only kernel on one block's
    # [S, A, F] operands
    stats[f"cheb_bwd_gd{suffix} (F={f})"] = compare_and_time(
        "cheb_bwd_gd",
        lambda p: ck.cheb_conv_bwd_gd(c2, pos, x, g, rcut, p, d_min, **kw),
        lambda p: ck.cheb_conv_bwd_gd_plain(c2, pos, x, g, rcut, p, d_min,
                                            **kw),
        pair_flops * f * m2, 4 * (2 * s * a * 3 + 2 * s * a * f + m2 * f)
        + cell_bytes, label=f"cheb_bwd_gd{suffix} (F={f}, one block)",
        precs=precs, fp32_note=notes["cheb_bwd_gd"], repeat=True,
        fp32_flops=wrap,
    )
    return stats


def kernel_cells(n, dev=None):
    """Per-molecule cells [n, 3, 3] (float64 numpy, or float32 on ``dev``):
    cubic BOX on even molecules, CELL_TRICLINIC on odd ones."""
    cells = np.stack([BOX * np.eye(3) if i % 2 == 0
                      else np.asarray(CELL_TRICLINIC) for i in range(n)])
    if dev is None:
        return cells
    return torch.as_tensor(cells, dtype=torch.float32, device=dev)


def fold(pos, cells):
    """Positions [S, A, 3] (float64) translated atom by atom into their
    molecule's cell: pos - floor(pos inv) cell."""
    inv = np.linalg.inv(cells)
    frac = np.einsum("sak,skl->sal", pos, inv)
    return pos - np.einsum("sak,skl->sal", np.floor(frac), cells)


def crossing_pairs(pos, cell, rcut):
    """(live pairs, live pairs whose minimum image crosses a face) of the
    batch under ``cell`` [S, 3, 3]."""
    from flashmd_tpu_torch.ops.cheb_kernel import pair_rel
    from flashmd_tpu_torch.ops.neighborlist import _inv_3x3

    raw = pair_rel(pos)
    wrapped = pair_rel(pos, cell, _inv_3x3(cell))
    a = pos.shape[1]
    eye = torch.eye(a, dtype=torch.bool, device=pos.device)
    live = (torch.sqrt(torch.sum(wrapped * wrapped, dim=-1)) < rcut) & ~eye
    crossed = live & (torch.abs(wrapped - raw).amax(dim=-1) > 1.0)
    return int(live.sum()), int(crossed.sum())


def live_chunks(live, rows, cols):
    """(chunks holding a live entry, all chunks) of the kernels' rows x
    cols tiling of live [S, A, n] (each row's entries in walk order)."""
    s, a, n = live.shape
    rp, cp = -(-a // rows) * rows, -(-n // cols) * cols
    padded = torch.zeros(s, rp, cp, dtype=torch.bool, device=live.device)
    padded[:, :a, :n] = live
    chunks = padded.view(s, rp // rows, rows, cp // cols, cols).any(4).any(2)
    return int(chunks.sum()), chunks.numel()


# Rows of one work item of the tensor-core kernels (DM_RW in
# csrc/cfconv_tile.cuh).
ITEM_ROWS = 4


def executed_pairs(per_row):
    """Pairs the tensor-core kernels run for ``per_row`` [S, A] live pairs
    (or slots) of each row: each work item's live ones in 16-pair
    tiles."""
    s, a = per_row.shape
    rows = -(-a // ITEM_ROWS) * ITEM_ROWS
    padded = torch.zeros(s, rows, dtype=torch.long, device=per_row.device)
    padded[:, :a] = per_row
    per_item = padded.view(s, -1, ITEM_ROWS).sum(dim=2)
    return int((16 * ((per_item + 15) // 16)).sum())


def live_counts(pos, rcut):
    """(ordered pairs i != j with d_ij < rcut, pairs the live-pair kernels
    (forward and backward, bf16 and fp32) execute: each work item's live
    pairs in 16-pair tiles), whole batch."""
    a = pos.shape[1]
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    d = torch.sqrt(torch.sum(rel * rel, dim=-1))
    eye = torch.eye(a, dtype=torch.bool, device=pos.device)
    live = (d < rcut) & ~eye
    return int(live.sum()), executed_pairs(live.sum(dim=2))


def phase_dense_kernels(ff, pos, dev):
    """Returns the two kernels' bf16 numbers and the bf16 time of the
    backward's no-gx variant."""
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops._build import load

    cfg = ff.schnet_config
    rcut = float(cfg.cutoff.cutoff_upper)
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    w = (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
         rbf["coeff"])
    gen = torch.Generator(device=dev).manual_seed(12)
    s, a = pos.shape[0], pos.shape[1]
    r, f = w[0].shape
    x = torch.randn(s, a, f, generator=gen, device=dev)
    g = torch.randn(s, a, f, generator=gen, device=dev)
    n_live, n_exec = live_counts(pos, rcut)
    n_all = s * a * (a - 1)
    mlp = r * f + f * f
    fwd_pair, bwd_pair = 2 * mlp + 3 * f, 4 * mlp + 12 * f + 6 * r
    nogx_pair = bwd_pair - 3 * f
    wbytes = 4 * (r * f + 2 * f + f * f + r + 1)
    smem = [load().dense_cfconv_smem_bytes(b) for b in range(8)]
    print(f"kernels: dense shapes S={s} A={a} F={f} R={r} rcut={rcut}; "
          f"dynamic shared memory per block fwd fp32 (CUDA cores) {smem[0]} "
          f"B ({smem[6]} warps of {smem[7]} B beside "
          f"{smem[0] - smem[6] * smem[7]} B of float32 weights) bf16 "
          f"(tensor cores) {smem[3]} B, bwd fp32 (CUDA cores) {smem[1]} B "
          f"({smem[4]} warps of {smem[5]} B) bf16 (tensor cores) {smem[2]} "
          f"B; live pairs (d < rc) {n_live} of {n_all} "
          f"({n_live / n_all:.4f}); pairs run by the live-pair kernels (fwd "
          f"and bwd, bf16 and fp32: 16-pair tiles per {ITEM_ROWS}-row work "
          f"item) {n_exec} ({n_exec / n_live:.4f} x live, "
          f"{n_exec / n_all:.4f} of all); FLOP per pair fwd {fwd_pair} bwd "
          f"{bwd_pair} (no gx {nogx_pair}); all-pairs FLOP fwd "
          f"{n_all * fwd_pair:.4e} bwd {n_all * bwd_pair:.4e}; on the pairs "
          f"run fwd {n_exec * fwd_pair:.4e} bwd {n_exec * bwd_pair:.4e}")

    def note(kernel):
        regs = FFMA_BUILD.get(kernel)
        return (f"pairs run {n_exec} of {n_all}; {kernel}: "
                + (f"{regs[0]} regs, spill {regs[1]}/{regs[2]} B" if regs
                   else "registers not read"))

    stats = {
        "dense_cfconv_fwd": compare_and_time(
            "dense_cfconv_fwd",
            lambda p: cd.dense_cfconv_fwd(pos, x, *w, rcut, p),
            lambda p: cd.dense_cfconv_fwd_plain(pos, x, *w, rcut, p),
            float(n_live * fwd_pair), 4 * (s * a * 3 + 2 * s * a * f) + wbytes,
            fp32_note=note("dense_fwd_ffma_kernel"), repeat=True,
        ),
        "dense_cfconv_bwd": compare_and_time(
            "dense_cfconv_bwd",
            lambda p: cd.dense_cfconv_bwd(pos, x, g, *w, rcut, p),
            lambda p: cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, p),
            float(n_live * bwd_pair),
            4 * (2 * s * a * 3 + 3 * s * a * f) + wbytes,
            fp32_note=note("dense_bwd_ffma_kernel with gx"), repeat=True,
        ),
    }
    # Block 1's variant: gpos only (gx is None on both sides).
    no_gx = compare_and_time(
        "dense_cfconv_bwd",
        lambda p: cd.dense_cfconv_bwd(pos, x, g, *w, rcut, p,
                                      need_gx=False)[0],
        lambda p: cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, p,
                                            need_gx=False)[0],
        float(n_live * nogx_pair), 4 * (2 * s * a * 3 + 2 * s * a * f) + wbytes,
        label="dense_cfconv_bwd (no gx)",
        fp32_note=note("dense_bwd_ffma_kernel no gx"), repeat=True,
    )
    bwd = stats["dense_cfconv_bwd"]
    bwd["max_abs_err"] = max(bwd["max_abs_err"], no_gx["max_abs_err"])
    return stats, no_gx["ms"]


def nbr_slot_counts(pos, nbr, rcut):
    """(live slots, slots the live-slot kernels (the forward and the
    backward's first pass, bf16 and fp32) execute: each work item's live
    slots in 16-slot tiles, and the bf16 backward's gx pass: each item's
    live incoming slots in 16-slot tiles), whole batch."""
    s, a = pos.shape[:2]
    b = torch.arange(s, device=pos.device)[:, None, None]
    rel = pos[b, nbr.idx.long()] - pos[:, :, None, :]
    live = nbr.mask & (torch.sqrt(torch.sum(rel * rel, dim=-1)) < rcut)
    incoming = torch.zeros(s * a, dtype=torch.long, device=pos.device)
    incoming.index_add_(0, (b * a + nbr.idx.long())[live],
                        torch.ones(int(live.sum()), dtype=torch.long,
                                   device=pos.device))
    return (int(live.sum()), executed_pairs(live.sum(dim=2)),
            executed_pairs(incoming.view(s, a)))


def phase_nbr_kernels(ff, pos, dev):
    """Returns the two kernels' bf16 numbers and the bf16 time of the
    backward's no-gx variant, on the slice's own list (rc + skin 1.0)."""
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops._build import load

    cfg = ff.schnet_config
    rcut = float(cfg.cutoff.cutoff_upper)
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    w = (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
         rbf["coeff"])
    gen = torch.Generator(device=dev).manual_seed(13)
    s, a = pos.shape[0], pos.shape[1]
    r, f = w[0].shape
    x = torch.randn(s, a, f, generator=gen, device=dev)
    g = torch.randn(s, a, f, generator=gen, device=dev)
    build_ms = cuda_time_ms(lambda: build_neighbors(ff, pos, skin=1.0))
    nbr = build_neighbors(ff, pos, skin=1.0)
    k = nbr.capacity
    n_live, n_exec, n_exec_gx = nbr_slot_counts(pos, nbr, rcut)
    n_list = int(nbr.mask.sum())
    mlp = r * f + f * f
    fwd_slot, bwd_slot = 2 * mlp + 3 * f, 4 * mlp + 12 * f + 6 * r
    nogx_slot = bwd_slot - 3 * f
    wbytes = 4 * (r * f + 2 * f + f * f + r + 1)
    lbytes = 5 * s * a * k  # idx (int32) and mask (one byte)
    csr_bytes = 4 * (s * a + 1 + n_list)
    smem = [load().cfconv_smem_bytes(b) for b in (0, 1, 2, 3)]
    print(f"kernels: cfconv shapes S={s} A={a} K={k} F={f} R={r} rcut="
          f"{rcut} skin 1.0; n_max {int(nbr.n_max.max())}; dynamic shared "
          f"memory per block fwd fp32 (CUDA cores) {smem[0]} B bf16 (tensor "
          f"cores) {smem[3]} B, bwd fp32 {smem[1]} B, bwd bf16 (tensor "
          f"cores) first pass {smem[2]} B gx pass {smem[3]} B; list slots "
          f"{n_list}, live slots (d < rc) {n_live} of {s * a * k} "
          f"({n_live / (s * a * k):.4f}); executed slots: 16-slot tiles per "
          f"{ITEM_ROWS}-row work item (fwd and bwd first pass, bf16 and "
          f"fp32) {n_exec} ({n_exec / n_live:.4f} x live), bf16 bwd gx pass "
          f"{n_exec_gx} ({n_exec_gx / n_live:.4f} x live); FLOP per slot fwd "
          f"{fwd_slot} bwd {bwd_slot} (no gx {nogx_slot}); live-slot FLOP "
          f"fwd {n_live * fwd_slot:.4e} bwd {n_live * bwd_slot:.4e}; "
          f"executed FLOP fwd {n_exec * fwd_slot:.4e}, bwd fp32 (pass 1 + "
          f"gx pass) {n_exec * nogx_slot + n_live * 3 * f:.4e}, bwd bf16 "
          f"(pass 1 + gx pass) "
          f"{n_exec * nogx_slot + n_exec_gx * fwd_slot:.4e}; "
          f"neighbour build + source CSR {build_ms:.4f} ms")

    def note(kernel, what=""):
        regs = FFMA_BUILD.get(kernel)
        return (f"slots run {n_exec} of {s * a * k}{what}; {kernel}: "
                + (f"{regs[0]} regs, spill {regs[1]}/{regs[2]} B" if regs
                   else "registers not read"))

    csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
    stats = {
        "cfconv_fwd": compare_and_time(
            "cfconv_fwd",
            lambda p: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, rcut, p),
            lambda p: cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w,
                                          rcut, p),
            float(n_live * fwd_slot),
            4 * (s * a * 3 + 2 * s * a * f) + lbytes + wbytes,
            fp32_note=note("nbr_fwd_ffma_kernel"), repeat=True,
        ),
        "cfconv_bwd": compare_and_time(
            "cfconv_bwd",
            lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, p),
            lambda p: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w,
                                          rcut, p),
            float(n_live * bwd_slot),
            4 * (2 * s * a * 3 + 3 * s * a * f) + lbytes + csr_bytes + wbytes,
            fp32_note=note("nbr_bwd_ffma_kernel with gx", " (first pass)"),
            repeat=True,
        ),
    }
    no_gx = compare_and_time(
        "cfconv_bwd",
        lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, p,
                                need_gx=False)[0],
        lambda p: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, rcut,
                                      p, need_gx=False)[0],
        float(n_live * nogx_slot),
        4 * (2 * s * a * 3 + 2 * s * a * f) + lbytes + csr_bytes + wbytes,
        label="cfconv_bwd (no gx)",
        fp32_note=note("nbr_bwd_ffma_kernel no gx", " (first pass)"),
        repeat=True,
    )
    bwd = stats["cfconv_bwd"]
    bwd["max_abs_err"] = max(bwd["max_abs_err"], no_gx["max_abs_err"])
    nbr_bwd_memory(pos, csr, x, g, w, rcut)

    # An overflowed list: each row keeps its nearest 32, so the list is
    # asymmetric and the column side is not the row side's mirror.
    over = build_neighbors(ff.replace(neighbor_capacity=OVERFLOW_CAPACITY),
                           pos, skin=1.0)
    n_max = int(over.n_max.max())
    check(n_max > OVERFLOW_CAPACITY, f"capacity {OVERFLOW_CAPACITY} does "
          f"not overflow (n_max {n_max})")
    for prec in ("fp32", "bf16"):
        out_k = cf.cfconv_fwd(pos, over.idx, over.mask, x, *w, rcut, prec)
        out_p = cf.cfconv_fwd_plain(pos, over.idx, over.mask, x, *w, rcut,
                                    prec)
        ocsr = (over.idx, over.mask, over.csr_offsets, over.csr_slots)
        gpos_k, gx_k = cf.cfconv_bwd(pos, *ocsr, x, g, *w, rcut, prec)
        gpos_n, _ = cf.cfconv_bwd(pos, *ocsr, x, g, *w, rcut, prec,
                                  need_gx=False)
        gpos_p, gx_p = cf.cfconv_bwd_plain(pos, over.idx, over.mask, x, g,
                                           *w, rcut, prec)
        torch.cuda.synchronize()
        pairs = (("fwd", out_k, out_p), ("gpos", gpos_k, gpos_p),
                 ("gx", gx_k, gx_p), ("gpos (no gx)", gpos_n, gpos_p))
        rel = {name: float((k_ - p_).abs().max() / p_.abs().max())
               for name, k_, p_ in pairs}
        lim_f = BOUNDS[("cfconv_fwd", prec)]
        lim_b = BOUNDS[("cfconv_bwd", prec)]
        print(f"kernels: cfconv overflowed list (capacity "
              f"{OVERFLOW_CAPACITY}, n_max {n_max}) {prec} max|k-p|/max|p|: "
              f"fwd {rel['fwd']:.3e} (bound {lim_f:.0e}), bwd gpos "
              f"{rel['gpos']:.3e} gx {rel['gx']:.3e}, without gx gpos "
              f"{rel['gpos (no gx)']:.3e} (bound {lim_b:.0e})")
        check(rel["fwd"] <= lim_f
              and max(rel["gpos"], rel["gx"], rel["gpos (no gx)"]) <= lim_b,
              f"cfconv {prec} on the overflowed list: kernel and twin "
              "disagree")
    return stats, no_gx["ms"]


def nbr_bwd_peak(pos, csr, x, g, w, rcut):
    """{tier: peak device memory of one cfconv_bwd with gx above what was
    allocated before it (its inputs)} at bf16 and fp32."""
    from flashmd_tpu_torch.ops import cfconv as cf

    extra = {}
    for prec in ("bf16", "fp32"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, prec)
        torch.cuda.synchronize()
        extra[prec] = torch.cuda.max_memory_allocated() - before
        del out
    return extra


def nbr_bwd_memory(pos, csr, x, g, w, rcut):
    """nbr_bwd_peak at bf16 (gated below NBR_BWD_MEMORY_LIMIT: no
    [S, A, K, F] workspace) and at fp32 (which keeps one, printed)."""
    extra = nbr_bwd_peak(pos, csr, x, g, w, rcut)
    s, a, k = csr[0].shape
    print(f"kernels: cfconv_bwd memory at S={s} A={a} K={k}: peak above its "
          f"inputs bf16 {extra['bf16']} B ({extra['bf16'] / 1e6:.1f} MB; "
          f"bound {NBR_BWD_MEMORY_LIMIT / 1e6:.0f} MB), fp32 "
          f"{extra['fp32']} B ({extra['fp32'] / 1e6:.1f} MB, with its W "
          "workspace)")
    check(extra["bf16"] < NBR_BWD_MEMORY_LIMIT,
          "the bf16 cfconv_bwd allocates a workspace of the size of W")


def cheb_orders(cfg):
    """(cheb_order, derivative order) of a config, None resolved."""
    from flashmd_tpu_torch.models.cheb import resolved_order_deriv

    return cfg.cheb_order, resolved_order_deriv(cfg)


def _force_fields(device, batch, message_passing="cheb", **kw):
    """The zoo's field on ``message_passing`` (the Chebyshev kernels unless
    another path is named; the zoo itself defaults to "xla"), with its host
    fit attached on cheb."""
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(n_atoms=N_ATOMS, batch_size=batch,
                                  message_passing=message_passing,
                                  device=device, **kw)
    if ff.schnet_config.message_passing == "cheb":
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                      ff.schnet_config))
    return ff, cfgs


def _forces(ff, cfgs, device):
    """compute_energy_forces on the collated configurations, with their
    cells when they carry them."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    sys_ = collate(cfgs, beta=1.67, device=device)
    e, f, _ = compute_energy_forces(ff, sys_.pos, sys_.atom_types,
                                    cell=sys_.cell)
    return e.cpu(), f.cpu()


def with_cells(cfgs, cells, folded=False):
    """The configurations with per-molecule ``cells`` [S, 3, 3], their
    positions folded into the cells when ``folded``."""
    pos = np.stack([c.pos for c in cfgs])
    if folded:
        pos = fold(pos, cells)
    return [dataclasses.replace(c, pos=p, cell=cl)
            for c, p, cl in zip(cfgs, pos, cells)]


def phase_forces(dev, message_passing, label=None, bound=FORCE_BOUND, **kw):
    """Forces and energies at FORCE_BATCH on the card (kernels) and on the
    CPU (twins) of the zoo's field on ``message_passing`` (``kw``: more of
    its arguments), held to ``bound`` of their maxima."""
    label = label or message_passing
    out = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = _force_fields(device, FORCE_BATCH,
                                 message_passing=message_passing, **kw)
        out[device.type] = _forces(ff, cfgs, device)
    (e_k, f_k), (e_p, f_p) = out["cuda"], out["cpu"]
    check(bool(torch.isfinite(f_k).all()),
          f"forces {label}: non-finite on the card")
    f_rel = float((f_k - f_p).abs().max() / f_p.abs().max())
    e_rel = float((e_k - e_p).abs().max() / e_p.abs().max())
    print(f"forces: {label} batch {FORCE_BATCH} card vs cpu plain: "
          f"max|dF|/max|F| = {f_rel:.3e}, max|dE|/max|E| = {e_rel:.3e} "
          f"(bound {bound:.0e})")
    check(f_rel <= bound and e_rel <= bound,
          f"forces {label}: card and CPU disagree")


@contextlib.contextmanager
def cheb_schedule(value):
    """FLASHMD_CHEB_STACK set to ``value`` ("0": one conv per block) in
    this process for the block, and restored after it."""
    old = os.environ.get("FLASHMD_CHEB_STACK")
    os.environ["FLASHMD_CHEB_STACK"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["FLASHMD_CHEB_STACK"]
        else:
            os.environ["FLASHMD_CHEB_STACK"] = old


def cheb_counts(n_evals, per_block=False, cell=False, tier="bf16"):
    """Every cheb launch counter's expected value over ``n_evals`` force
    evaluations of the 3-block slice on one schedule, open or with cells,
    at the tier (bf16, bf16x3 or fp32): fwd 3, gx 2, gd 1 (stacked) or fwd
    3, gxgd 2, gd 1 (per block)."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    per = ({"cheb_fwd": 3, "cheb_bwd_gxgd": 2, "cheb_bwd_gd": 1} if per_block
           else {"cheb_fwd": 3, "cheb_bwd_gx": 2, "cheb_bwd_gd": 1})
    sfx = ("_cell" if cell else "") + ("" if tier == "bf16" else "_" + tier)
    return {**dict.fromkeys(ck.launch_counts(), 0),
            **{k + sfx: v * n_evals for k, v in per.items()}}


def phase_schedule_check(dev):
    """Per-block vs stacked cheb fp32 forces on the card, same weights and
    positions, open and on the folded positions with the kernels' cells:
    one function on two schedules."""
    ff, cfgs = _force_fields(dev, FORCE_BATCH, precision="fp32")
    folded = with_cells(cfgs, kernel_cells(FORCE_BATCH), folded=True)
    for label, c in (("open", cfgs), ("periodic (folded, cells)", folded)):
        with cheb_schedule("1"):
            f_s = _forces(ff, c, dev)[1]
        with cheb_schedule("0"):
            f_b = _forces(ff, c, dev)[1]
        rel = float((f_b - f_s).abs().max() / f_s.abs().max())
        print(f"forces: per-block vs stacked cheb fp32, {label}, batch "
              f"{FORCE_BATCH}: max|dF|/max|F| = {rel:.3e} (bound "
              f"{CROSS_BOUND:.0e})")
        check(rel <= CROSS_BOUND,
              f"per-block and stacked fp32 forces disagree ({label})")


def phase_bf16x3_forces(dev):
    """bf16x3 forces at batch 4, each held to BF16X3_BOUND of max|F|: card
    (kernels) vs CPU (twins) on both schedules, open (total forces) and
    periodic (network forces on the start positions folded into the
    kernels' cells: folding breaks the bonds the priors see); then on the
    card per-block vs stacked, and bf16x3 vs fp32 network forces on the
    same (64, 96) fit."""
    cpu = torch.device("cpu")
    fields = {}
    for device in (dev, cpu):
        ff, cfgs = _force_fields(device, FORCE_BATCH, precision="bf16x3")
        folded = with_cells(cfgs, kernel_cells(FORCE_BATCH), folded=True)
        fields[device.type] = (ff, cfgs, folded)
    kinds = ("open", "periodic (folded, cells) network")
    out = {}
    for stack in ("1", "0"):
        with cheb_schedule(stack):
            for device in (dev, cpu):
                ff, cfgs, folded = fields[device.type]
                out[stack, device.type] = (
                    _forces(ff, cfgs, device)[1],
                    _forces(ff.replace(priors={}), folded, device)[1],
                )

    def gate(label, f, ref):
        rel = float((f - ref).abs().max() / ref.abs().max())
        print(f"forces: bf16x3 {label}, batch {FORCE_BATCH}: max|dF|/max|F| "
              f"= {rel:.3e} (bound {BF16X3_BOUND:.0e})")
        check(bool(torch.isfinite(f).all()) and rel <= BF16X3_BOUND,
              f"bf16x3 forces: {label}")

    for stack, sched in (("1", "stacked"), ("0", "per-block")):
        for i, kind in enumerate(kinds):
            gate(f"{sched} {kind} card vs cpu plain", out[stack, "cuda"][i],
                 out[stack, "cpu"][i])
    for i, kind in enumerate(kinds):
        gate(f"per-block vs stacked {kind} on the card", out["0", "cuda"][i],
             out["1", "cuda"][i])
    ff, cfgs, _ = fields["cuda"]
    net = ff.replace(priors={})
    fp32 = net.replace(schnet_config=dataclasses.replace(net.schnet_config,
                                                         precision="fp32"))
    with cheb_schedule("1"):
        gate("vs fp32 on the same (64, 96) fit, network only, on the card",
             _forces(net, cfgs, dev)[1], _forces(fp32, cfgs, dev)[1])


def phase_periodic_forces(dev, label="cheb periodic"):
    """Periodic cheb forces, card vs CPU plain path, at batch 4 on the
    start positions folded into the kernels' cells (so live pairs cross
    faces). Folding breaks the chain's bonds in the raw coordinates the
    priors see, so the network alone is compared; its difference is held
    to FORCE_BOUND of the physical force scale, the total open forces on
    the unfolded positions, as the open phase is (the priors add the same
    term on both sides). The network-only ratios, periodic and open, are
    printed beside it."""
    out = {}
    for device in (dev, torch.device("cpu")):
        ff, cfgs = _force_fields(device, FORCE_BATCH)
        net = ff.replace(priors={})
        folded = with_cells(cfgs, kernel_cells(FORCE_BATCH), folded=True)
        out[device.type] = (_forces(net, folded, device),
                            _forces(net, cfgs, device)[1],
                            _forces(ff, cfgs, device)[1])
    ((e_k, f_k), open_k, _), ((e_p, f_p), open_p, total_p) = (
        out["cuda"], out["cpu"])
    check(bool(torch.isfinite(f_k).all()),
          f"forces {label}: non-finite on the card")
    scale = float(total_p.abs().max())
    f_rel = float((f_k - f_p).abs().max()) / scale
    e_rel = float((e_k - e_p).abs().max() / e_p.abs().max())
    net_rel = float((f_k - f_p).abs().max() / f_p.abs().max())
    open_rel = float((open_k - open_p).abs().max() / open_p.abs().max())
    print(f"forces: {label} (folded, cubic/triclinic cells) network "
          f"batch {FORCE_BATCH} card vs cpu plain: max|dF|/max|F_total| = "
          f"{f_rel:.3e}, max|dE|/max|E| = {e_rel:.3e} (bound "
          f"{FORCE_BOUND:.0e}); network only max|dF|/max|F_net| = "
          f"{net_rel:.3e} periodic, {open_rel:.3e} open (unfolded), "
          "not gated")
    check(f_rel <= FORCE_BOUND and e_rel <= FORCE_BOUND,
          f"forces {label}: card and CPU disagree")


def phase_image_check(dev, message_passing="cheb"):
    """fp32 network forces (priors removed) on positions folded into the
    kernels' cells, with the cells, vs on the unfolded positions with open
    boundaries: one function while every molecule's diameter is more than
    rcut below the smallest perpendicular cell width (no live pair then
    has a second image within rcut)."""
    from flashmd_tpu_torch.ops.neighborlist import min_cell_width

    ff, cfgs = _force_fields(dev, FORCE_BATCH, precision="fp32",
                             message_passing=message_passing)
    ff = ff.replace(priors={})
    cells = kernel_cells(FORCE_BATCH)
    pos = np.stack([c.pos for c in cfgs])
    diam = max(float(np.sqrt(np.sum((p[:, None] - p[None]) ** 2, -1)).max())
               for p in pos)
    width = min(min_cell_width(c) for c in cells)
    print(f"forces: periodic image check: molecule diameter {diam:.3f} A, "
          f"smallest cell width {width:.3f} A, width - diameter "
          f"{width - diam:.3f} A vs rcut {ff.rcut}")
    check(width - diam > ff.rcut, "image check: a second image is in range")
    f_cell = _forces(ff, with_cells(cfgs, cells, folded=True), dev)[1]
    f_open = _forces(ff, cfgs, dev)[1]
    rel = float((f_cell - f_open).abs().max() / f_open.abs().max())
    print(f"forces: {message_passing} periodic fp32 (folded, cells) vs "
          f"open fp32 (unfolded), network only, batch {FORCE_BATCH}: "
          f"max|dF|/max|F| = {rel:.3e} (bound {CROSS_BOUND:.0e})")
    check(rel <= CROSS_BOUND,
          f"{message_passing}: periodic and open fp32 forces disagree")


def phase_cross_check(dev):
    """pallas fp32 vs dense fp32 forces on the same weights and positions:
    one function (the list holds every pair within rc), two orders."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import build_neighbors

    ff_p, cfgs = _force_fields(dev, FORCE_BATCH, precision="fp32",
                               message_passing="pallas")
    ff_d, _ = _force_fields(dev, FORCE_BATCH, precision="fp32",
                            message_passing="dense")
    n_max = int(build_neighbors(ff_p, collate(cfgs, device=dev).pos)
                .n_max.max())
    check(n_max <= ff_p.neighbor_capacity,
          f"cross-check list overflows ({n_max} > {ff_p.neighbor_capacity})")
    f_p, f_d = _forces(ff_p, cfgs, dev)[1], _forces(ff_d, cfgs, dev)[1]
    rel = float((f_p - f_d).abs().max() / f_d.abs().max())
    print(f"forces: pallas fp32 vs dense fp32, batch {FORCE_BATCH} (n_max "
          f"{n_max}, K {ff_p.neighbor_capacity}): max|dF|/max|F| = "
          f"{rel:.3e} (bound {CROSS_BOUND:.0e})")
    check(rel <= CROSS_BOUND, "pallas and dense fp32 forces disagree")


class _RoundForwardOnly(torch.autograd.Function):
    """bf16 rounding whose backward passes the cotangent through in
    float32 (autograd's cast rounds it to bf16, as JAX's does)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        return grad


@contextlib.contextmanager
def float32_cotangents():
    """models.mlp's bf16 rounding with float32 cotangents, for the block."""
    from flashmd_tpu_torch.models import mlp

    old = mlp.round_bf16
    mlp.round_bf16 = _RoundForwardOnly.apply
    try:
        yield
    finally:
        mlp.round_bf16 = old


def phase_fidelity(dev, method_fits):
    """Printed, not gated: the (48, 64) frontier on this card is open. The
    xla bf16 field also with float32 cotangents in its filter MLP, which
    tells its own bf16 error from the cotangent rounding at the casts.
    ``method_fits``: {method: the slice's host fits}; each wls or lawson
    fit on the cheb bf16 field, beside proj's."""
    ff_c, cfgs = _force_fields(dev, FORCE_BATCH)
    ff_methods = {m: ff_c.replace(schnet_params={**ff_c.schnet_params,
                                                 "cheb_fit": fits})
                  for m, fits in method_fits.items() if m != "proj"}
    ff_d, _ = _force_fields(dev, FORCE_BATCH, precision="fp32",
                            message_passing="dense")
    ff_db, _ = _force_fields(dev, FORCE_BATCH, message_passing="dense")
    ff_pb, _ = _force_fields(dev, FORCE_BATCH, message_passing="pallas")
    ff_x3, _ = _force_fields(dev, FORCE_BATCH, precision="bf16x3")
    ff_xla, _ = _force_fields(dev, FORCE_BATCH, message_passing="xla")
    for label, keep_priors in (("total", True), ("network only", False)):
        def forces(ff):
            ff = ff if keep_priors else ff.replace(priors={})
            return _forces(ff, cfgs, dev)[1]

        f_ref = forces(ff_d)
        scale = float(f_ref.abs().max())
        rel_cheb = float((forces(ff_c) - f_ref).abs().max()) / scale
        rel_dense = float((forces(ff_db) - f_ref).abs().max()) / scale
        rel_pallas = float((forces(ff_pb) - f_ref).abs().max()) / scale
        rel_x3 = float((forces(ff_x3) - f_ref).abs().max()) / scale
        rel_xla = float((forces(ff_xla) - f_ref).abs().max()) / scale
        with float32_cotangents():
            rel_xla32 = float((forces(ff_xla) - f_ref).abs().max()) / scale
        rel_methods = "".join(
            f"; cheb bf16 (48, 64) d_min 2.0 {m} = "
            f"{float((forces(f) - f_ref).abs().max()) / scale:.4e}"
            for m, f in ff_methods.items())
        print(f"fidelity: {label} forces, batch {FORCE_BATCH}, max|F - "
              f"F_dense_fp32|/max|F_dense_fp32|: cheb bf16 (48, 64) d_min "
              f"2.0 = {rel_cheb:.4e}; dense bf16 = {rel_dense:.4e}; pallas "
              f"bf16 = {rel_pallas:.4e}; cheb bf16x3 (64, 96) d_min 2.0 = "
              f"{rel_x3:.4e}; xla bf16 = {rel_xla:.4e} (float32 cotangents "
              f"{rel_xla32:.4e}){rel_methods}")


def host_fit_methods(ff):
    """{method: the slice field's float64 host fits} for proj, wls and
    lawson, each timed on the host as attach makes it."""
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit

    out = {}
    for method in ("proj",) + FIT_METHODS:
        cfg = dataclasses.replace(ff.schnet_config, cheb_fit_method=method)
        t0 = time.perf_counter()
        out[method] = attach_cheb_fit(ff.schnet_params, cfg)["cheb_fit"]
        seconds = time.perf_counter() - t0
        print(f"fit: host fit {method} of the slice's {len(out[method])} "
              f"blocks x {cfg.num_filters} features at {cheb_orders(cfg)} "
              f"on d_min {cfg.cheb_d_min}: "
              f"{seconds:.3f} s on the host (attach)")
    return out


def _unattached(ff, **config):
    """The field without its attached fit, its config changed by
    ``config``."""
    params = {k: v for k, v in ff.schnet_params.items() if k != "cheb_fit"}
    return ff.replace(schnet_params=params, schnet_config=dataclasses.replace(
        ff.schnet_config, **config))


def _l1(fits, i):
    return sum(float(f[i].abs().sum()) for f in fits)


def phase_fit(ff, cfgs, dev, smi, method_fits):
    """The fit phase (the module docstring's): the in-graph fit against
    the float64 host fit, forces with no fit and with a stale one, the
    wls and lawson fits through the kernels and the Langevin slice."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.cheb import (
        attach_cheb_fit,
        fit_chebyshev_filter,
    )
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    cfg, params = ff.schnet_config, ff.schnet_params
    m1, m2 = cheb_orders(cfg)

    def fit_all():
        return [fit_chebyshev_filter(bp, params["rbf"], cfg, order=m1,
                                     n_nodes=FIT_NODES, order_deriv=m2)
                for bp in params["interactions"]]

    fits = fit_all()
    fit_ms = cuda_time_ms(fit_all)
    print(f"fit: in-graph fit of {len(fits)} blocks, F = {cfg.num_filters}, "
          f"{FIT_NODES} nodes, ({m1}, {m2}) on d_min {cfg.cheb_d_min}: "
          f"{fit_ms:.3f} ms on the card (CUDA events, after a warm-up) on "
          f"{smi}")
    for b, (got, host) in enumerate(zip(fits, method_fits["proj"])):
        rels = [float((g - h).abs().max() / h.abs().max())
                for g, h in zip(got, host)]
        check(all(g.device == dev and g.dtype == torch.float32 for g in got),
              "fit: the in-graph fit left the card or float32")
        print(f"fit: block {b + 1} in-graph vs float64 host fit "
              f"max|d|/max|host|: c {rels[0]:.3e}, c2 {rels[1]:.3e}, w0 "
              f"{rels[2]:.3e} (bound {FIT_BOUND:.0e})")
        check(max(rels) <= FIT_BOUND,
              f"fit: block {b + 1} in-graph fit off the host fit")

    # forces at the slice's batch with no fit attached, and a stale fit
    system = collate(cfgs, beta=1.67, device=dev)

    def evaluate(field):
        ck.reset_launch_counts()
        e, f, _ = compute_energy_forces(field, system.pos, system.atom_types)
        counts = ck.launch_counts()
        check(counts == cheb_counts(1, tier=field.schnet_config.precision),
              f"fit: launches {counts}, expected 3/2/1")
        return e, f

    for precision in ("fp32", "bf16"):
        net = ff.replace(priors={})
        bare = _unattached(net, precision=precision)
        attached = bare.replace(schnet_params={**bare.schnet_params,
                                               "cheb_fit": params["cheb_fit"]})
        _, f_u = evaluate(bare)
        _, f_a = evaluate(attached)
        rel = float((f_u - f_a).abs().max() / f_a.abs().max())
        gated = precision == "fp32"
        print(f"fit: {precision} network forces, S = {system.n_sims}, A = "
              f"{system.n_atoms}, no fit attached (in-graph fit) vs the "
              f"attached host fit: max|dF|/max|F| = {rel:.3e}"
              + (f" (bound {CROSS_BOUND:.0e})" if gated else " (not gated)")
              + "; launches 3/2/1")
        if gated:
            check(rel <= CROSS_BOUND, "fit: unattached fp32 forces differ")
    bare = _unattached(ff)
    stale_cfg = dataclasses.replace(cfg, cheb_order=32, cheb_order_deriv=32)
    stale = bare.replace(schnet_params=attach_cheb_fit(bare.schnet_params,
                                                       stale_cfg))
    e_u, f_u = evaluate(bare)
    e_s, f_s = evaluate(stale)
    same = torch.equal(f_u, f_s) and torch.equal(e_u, e_s)
    print(f"fit: stale fit attached at (32, 32), called at ({m1}, {m2}): "
          f"refit in the graph, forces and energies bitwise the unattached "
          f"run's: {same}")
    check(same, "fit: the stale run differs from the unattached one")

    # wls and lawson: coefficients, kernels against their twins, the slice
    pos = system.pos
    for method in FIT_METHODS:
        mf = method_fits[method]
        print(f"fit: {method} coefficient L1 norms (3 blocks): c "
              f"{_l1(mf, 0):.4e}, c2 {_l1(mf, 1):.4e}; proj's c "
              f"{_l1(method_fits['proj'], 0):.4e}, c2 "
              f"{_l1(method_fits['proj'], 1):.4e} (ratios "
              f"{_l1(mf, 0) / _l1(method_fits['proj'], 0):.4f}, "
              f"{_l1(mf, 1) / _l1(method_fits['proj'], 1):.4f})")
        field = ff.replace(schnet_params={**params, "cheb_fit": mf})
        phase_cheb_kernels(field, pos, dev, tag=f" {method}",
                           stacked_only=True)
    n_evals = STEPS + 1
    tps = {}
    for method in ("proj",) + FIT_METHODS + ("proj",):
        field = _unattached(ff, cheb_fit_method=method)
        field = field.replace(schnet_params={
            **field.schnet_params, "cheb_fit": method_fits[method]})
        _, _, sim = run_slice(f"fit {method}", field, cfgs, dev, STEPS,
                              SAVE_INTERVAL, ck, cheb_counts(n_evals), smi)
        check(all(torch.equal(a, b) for got, want in zip(
            sim.model.schnet_params["cheb_fit"], method_fits[method])
            for a, b in zip(got, want)),
            f"fit {method}: the simulation ran another fit")
        tps.setdefault(method, []).append(
            sim.get_throughput_metrics()["throughput"])
    proj_tp = float(np.mean(tps["proj"]))
    print(f"fit: second-half throughput proj {tps['proj'][0]:.1f} and "
          f"{tps['proj'][1]:.1f} (runs 1 and 4), "
          + ", ".join(f"{m} {tps[m][0]:.1f} (ratio to proj's mean "
                      f"{tps[m][0] / proj_tp:.4f})" for m in FIT_METHODS)
          + f" timestep*mol/s on {smi}")


def phase_envelopes(ff, cfgs, dev, smi):
    """The envelope phase (the module docstring's): the slice's weights
    under each radial-basis envelope of ENVELOPES."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models import cutoff
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    bare = _unattached(ff)
    pos = collate(cfgs, device=dev).pos
    fields = {}
    for label, name, args in ENVELOPES:
        env = getattr(cutoff, name)(*args)
        cfg = dataclasses.replace(bare.schnet_config, rbf_cutoff=env)
        t0 = time.perf_counter()
        fits = attach_cheb_fit(bare.schnet_params, cfg)["cheb_fit"]
        seconds = time.perf_counter() - t0
        print(f"envelope {label}: rbf_cutoff {env}, cutoff {cfg.cutoff}: "
              f"host fit proj of {len(fits)} blocks x {cfg.num_filters} "
              f"features at {cheb_orders(cfg)} on d_min {cfg.cheb_d_min}: "
              f"{seconds:.3f} s on the host (attach)")
        field = bare.replace(schnet_config=cfg, schnet_params={
            **bare.schnet_params, "cheb_fit": fits})
        fields[label] = field
        phase_cheb_kernels(field, pos, dev, tag=f" {label}",
                           stacked_only=True)
        # forces at batch 4, card against the CPU twins on the same fit
        out = []
        for device in (dev, torch.device("cpu")):
            f_dev, c_dev = _force_fields(device, FORCE_BATCH)
            f_dev = _unattached(f_dev, rbf_cutoff=env)
            f_dev = f_dev.replace(schnet_params={
                **f_dev.schnet_params, "cheb_fit": tuple(
                    tuple(t.to(device) for t in fit) for fit in fits)})
            out.append(_forces(f_dev, c_dev, device)[1])
        f_card, f_cpu = out
        check(bool(torch.isfinite(f_card).all()),
              f"envelope {label}: non-finite forces on the card")
        rel = float((f_card - f_cpu).abs().max() / f_cpu.abs().max())
        print(f"forces: envelope {label} batch {FORCE_BATCH} card vs cpu "
              f"plain: max|dF|/max|F| = {rel:.3e} (bound {FORCE_BOUND:.0e})")
        check(rel <= FORCE_BOUND, f"envelope {label}: card and CPU disagree")
    # the network's cheb forces against the xla fp32 field of the same
    # basis, the slice's cosine beside the envelopes: fp32 (the fit's
    # truncation alone) and bf16
    f_dev, c_dev = _force_fields(dev, FORCE_BATCH)
    net = f_dev.replace(priors={})
    for label, field in (("cosine", ff), *fields.items()):
        env = field.schnet_config.rbf_cutoff
        exact = _unattached(net, rbf_cutoff=env, message_passing="xla",
                            precision="fp32")
        f_x = _forces(exact, c_dev, dev)[1]
        rels = []
        for precision in ("fp32", "bf16"):
            cheb = _unattached(net, rbf_cutoff=env, precision=precision)
            cheb = cheb.replace(schnet_params={
                **cheb.schnet_params,
                "cheb_fit": field.schnet_params["cheb_fit"]})
            f_c = _forces(cheb, c_dev, dev)[1]
            rels.append(float((f_c - f_x).abs().max() / f_x.abs().max()))
        print(f"fidelity: envelope {label} network forces, batch "
              f"{FORCE_BATCH}, max|F - F_xla_fp32|/max|F_xla_fp32| of the "
              f"cheb field {cheb_orders(field.schnet_config)} d_min "
              f"{field.schnet_config.cheb_d_min}: fp32 {rels[0]:.4e}, bf16 "
              f"{rels[1]:.4e} (printed, not gated)")
    n_evals = STEPS + 1
    tps = []
    for label in ("cosine",) + tuple(e[0] for e in ENVELOPES) + ("cosine",):
        field = fields.get(label, ff)
        _, _, sim = run_slice(f"envelope {label}", field, cfgs, dev, STEPS,
                              SAVE_INTERVAL, ck, cheb_counts(n_evals), smi)
        tps.append((label, sim.get_throughput_metrics()["throughput"]))
    cos_tp = float(np.mean([tp for label, tp in tps if label == "cosine"]))
    print("envelope: second-half throughput " + ", ".join(
        f"{label} {tp:.1f}" for label, tp in tps)
        + " timestep*mol/s (ratios to the cosine runs' mean: "
        + ", ".join(f"{label} {tp / cos_tp:.4f}" for label, tp in tps)
        + f") on {smi}")


class AllKernels:
    """The launch counters of every kernel module, read and set to 0 as
    one (run_slice's ``kernels``): a path that runs none of the kernels
    must leave every counter at 0."""

    @staticmethod
    def modules():
        from flashmd_tpu_torch.ops import (cfconv, cfconv_dense,
                                           cfconv_general, cheb_kernel)

        return (cheb_kernel, cfconv_dense, cfconv, cfconv_general)

    @classmethod
    def reset_launch_counts(cls):
        for mod in cls.modules():
            mod.reset_launch_counts()

    @classmethod
    def launch_counts(cls):
        return {k: v for mod in cls.modules()
                for k, v in mod.launch_counts().items()}

    @classmethod
    def zeros(cls):
        return dict.fromkeys(cls.launch_counts(), 0)


def phase_xla_forces(dev):
    """The exact xla path at batch 4 on the start positions: fp32 against
    the pallas and the dense fp32 force fields (one function), with every
    kernel counter at 0 over the xla evaluations; bf16 card vs CPU is
    phase_forces(dev, "xla")."""
    ff_x, cfgs = _force_fields(dev, FORCE_BATCH, precision="fp32",
                               message_passing="xla")
    AllKernels.reset_launch_counts()
    f_x = _forces(ff_x, cfgs, dev)[1]
    counts = AllKernels.launch_counts()
    check(counts == AllKernels.zeros(), f"xla launched kernels: {counts}")
    for other in ("pallas", "dense"):
        ff_o, _ = _force_fields(dev, FORCE_BATCH, precision="fp32",
                                message_passing=other)
        f_o = _forces(ff_o, cfgs, dev)[1]
        rel = float((f_x - f_o).abs().max() / f_o.abs().max())
        print(f"forces: xla fp32 vs {other} fp32, batch {FORCE_BATCH} (K "
              f"{ff_x.neighbor_capacity}): max|dF|/max|F| = {rel:.3e} (bound "
              f"{CROSS_BOUND:.0e})")
        check(rel <= CROSS_BOUND, f"xla and {other} fp32 forces disagree")


def phase_xla_batch(ff, cfgs, dev):
    """At batch 128: two force evaluations (list build included) bitwise
    equal in forces and energies, then the peak device memory of one
    evaluation under remat "block" and "none"."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    system = collate(cfgs, beta=1.67, device=dev)
    args = (system.pos, system.atom_types)
    e1, f1, _ = compute_energy_forces(ff, *args)
    e2, f2, _ = compute_energy_forces(ff, *args)
    same = bool(torch.equal(f1, f2) and torch.equal(e1, e2))
    print(f"forces: xla bf16 batch {BATCH}: two evaluations bitwise equal "
          f"(forces and energies) = {same}; max|dF| = "
          f"{float((f1 - f2).abs().max()):.3e}")
    check(same, "xla forces or energies differ between two evaluations")
    del e1, f1, e2, f2
    peaks = {}
    for remat in ("block", "none"):
        one = ff.replace(schnet_config=dataclasses.replace(ff.schnet_config,
                                                           remat=remat))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = compute_energy_forces(one, *args)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated()
        del out
        print(f"memory: xla bf16 batch {BATCH} A={N_ATOMS} K "
              f"{ff.neighbor_capacity}, one force evaluation, remat "
              f"{remat!r}: peak {peaks[remat]} B ({peaks[remat] / 1e9:.3f} "
              f"GB), {peaks[remat] - base} B above the "
              f"{base / 1e9:.3f} GB held before it")
    w_bytes = BATCH * N_ATOMS * ff.neighbor_capacity * 128 * 4
    print(f"memory: one [S, A, K, F] float32 tensor at this shape: {w_bytes} "
          f"B ({w_bytes / 1e9:.3f} GB); peak none / block = "
          f"{peaks['none'] / peaks['block']:.3f}")
    check(peaks["block"] < peaks["none"],
          "remat='block' does not lower the peak memory")
    gather_times(ff, system.pos, dev)


def gather_times(ff, pos, dev):
    """The xla path's neighbour gather of h [S, A, F] on the slice's list
    (CUDA events): forward, and forward plus the CSR segment-sum backward,
    beside index_add_ (atomic, not deterministic; used nowhere in the
    port) on the same cotangents."""
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops.gather import neighbor_gather

    nbr = build_neighbors(ff, pos, skin=1.0)
    s, a, k = nbr.idx.shape
    gen = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn(s, a, 128, generator=gen, device=dev, requires_grad=True)
    cot = torch.randn(s, a, k, 128, generator=gen, device=dev)
    cot = cot * nbr.mask[..., None]
    flat = (torch.arange(s, device=dev)[:, None, None] * a
            + nbr.idx.long()).reshape(-1)
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: neighbor_gather(h, nbr))
    both = cuda_time_ms(
        lambda: torch.autograd.grad(neighbor_gather(h, nbr), h, cot))
    atomic = cuda_time_ms(lambda: torch.zeros(s * a, 128, device=dev)
                          .index_add_(0, flat, cot.reshape(-1, 128)))
    print(f"gather: h [{s}, {a}, 128] at K {k} ({int(nbr.mask.sum())} live "
          f"slots): forward {fwd:.3f} ms, forward + CSR segment-sum backward "
          f"{both:.3f} ms (backward {both - fwd:.3f} ms); index_add_ on the "
          f"same cotangents {atomic:.3f} ms")


def image_configs(dev, cell, copies=1):
    """The xla fp32 field at XLA_IMAGE_ATOMS beads with its priors removed,
    and its first FORCE_BATCH configurations in ``cell``, each repeated
    ``copies`` times along the cell's first lattice vector (a supercell,
    whose first lattice vector is ``copies`` times as long)."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ff, cfgs = cgschnet_1enh_like(n_atoms=XLA_IMAGE_ATOMS,
                                  batch_size=FORCE_BATCH, precision="fp32",
                                  message_passing="xla", device=dev)
    big = np.array(cell, dtype=np.float64)
    big[0] *= copies
    return ff.replace(priors={}), [
        dataclasses.replace(
            c, pos=np.concatenate([c.pos + r * big[0] / copies
                                   for r in range(copies)]),
            atom_types=np.tile(c.atom_types, copies),
            masses=np.tile(c.masses, copies), neighbor_lists={}, cell=big,
        )
        for c in cfgs
    ]


def phase_xla_images(dev, smi):
    """The image-replicated run at reduced size: XLA_IMAGE_ATOMS beads in
    XLA_IMAGE_CELL, where rcut + skin reaches past half the width, so the
    engine switches the xla field to image replication; XLA_IMAGE_STEPS
    steps stay finite with every kernel counter at 0. Then fp32 network
    forces against the same system as a 2 x 1 x 1 supercell without
    images (tests/models/test_pbc_images.py::test_supercell_invariance),
    within CROSS_BOUND of max|F|. K holds every neighbour within rcut +
    skin, counted once with a capacity of every candidate column."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops.neighborlist import (
        compute_image_shifts,
        suggest_capacity,
    )
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    ff, cfgs = image_configs(dev, XLA_IMAGE_CELL)
    skin = 1.0
    images = compute_image_shifts(XLA_IMAGE_CELL, ff.rcut + skin)
    probe = ff.replace(pbc_images=tuple(map(tuple, images.tolist())),
                       neighbor_capacity=len(images) * XLA_IMAGE_ATOMS)
    system = collate(cfgs, device=dev)
    n_true = int(build_neighbors(probe, system.pos, skin=skin,
                                 cell=system.cell).n_max.max())
    cap = suggest_capacity(n_true, slack=1.35)
    ff = ff.replace(neighbor_capacity=cap)
    sim = LangevinSimulation(
        dt=0.004, friction=1.0, n_timesteps=XLA_IMAGE_STEPS,
        save_interval=XLA_IMAGE_STEPS // 2, random_seed=103838, device=dev,
        neighbor_skin=skin, gptq=None,
    )
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    bound = sim.model.pbc_images
    check(bound is not None, "the engine did not switch to image replication")
    AllKernels.reset_launch_counts()
    coords = sim.simulate()
    counts = AllKernels.launch_counts()
    n_max = int(sim.final_carry["nbr_n_max"])
    finite = bool(np.isfinite(coords).all())
    print(f"xla images: {XLA_IMAGE_STEPS} steps batch {FORCE_BATCH} "
          f"A={XLA_IMAGE_ATOMS} fp32 network in cell diag"
          f"{np.diag(XLA_IMAGE_CELL).tolist()} (rcut {ff.rcut} + skin "
          f"{skin}): switched to {len(bound)} lattice images; K {cap} (true "
          f"max {n_true} at the start), n_max over the run {n_max}; "
          f"finite={finite}; every kernel counter 0: "
          f"{counts == AllKernels.zeros()} on {smi}")
    check(finite and coords.shape[1] == 2, "xla images: bad trajectory")
    check(n_max <= cap, "xla images: the list overflowed")
    check(counts == AllKernels.zeros(), "xla images launched kernels")

    e_s, f_s = _forces(sim.model, cfgs, dev)
    ff_super, super_cfgs = image_configs(dev, XLA_IMAGE_CELL, copies=2)
    e_b, f_b = _forces(ff_super.replace(neighbor_capacity=cap), super_cfgs,
                       dev)
    a = XLA_IMAGE_ATOMS
    rel = max(float((f_b[:, r * a:(r + 1) * a] - f_s).abs().max())
              for r in range(2)) / float(f_s.abs().max())
    e_rel = float((e_b - 2 * e_s).abs().max() / (2 * e_s).abs().max())
    print(f"forces: xla images vs the 2 x 1 x 1 supercell without images "
          f"(cell diag{np.diag(super_cfgs[0].cell).tolist()}), fp32 network, "
          f"batch {FORCE_BATCH}: max|dF|/max|F| = {rel:.3e}, "
          f"max|E_super - 2 E|/max|2 E| = {e_rel:.3e} (bound "
          f"{CROSS_BOUND:.0e})")
    check(rel <= CROSS_BOUND and e_rel <= CROSS_BOUND,
          "xla images and the supercell disagree")


def run_slice(label, ff, cfgs, dev, steps, save_interval, kernels, expect,
              smi, cls=None, beta=1.67, **kw):
    """Simulate with the launch counts of ``kernels`` (a kernel module)
    set to 0 just before and read just after; returns the counts, the
    second-half ms/step and the simulation. ``cls`` is the integrator
    (BAOAB Langevin at friction 1.0 when None), ``kw`` its options."""
    if cls is None:
        from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

        cls = LangevinSimulation
        kw.setdefault("friction", 1.0)
    sim = cls(dt=0.004, n_timesteps=steps, save_interval=save_interval,
              random_seed=103838, device=dev, **kw)
    sim.attach_model_and_configurations(ff, cfgs, beta)
    kernels.reset_launch_counts()
    coords = sim.simulate()
    counts = kernels.launch_counts()
    finite = bool(np.isfinite(coords).all())
    m = sim.get_throughput_metrics()
    print(f"{label}: {steps} steps batch {sim.n_sims} A={sim.n_atoms}: "
          f"finite={finite} launches={counts} expected={expect}; second-half "
          f"throughput {m['throughput']:.1f} timestep*mol/s "
          f"({m['ms_per_timestep']:.3f} ms/step) on {smi}")
    check(finite, f"{label}: non-finite positions")
    check(counts == expect, f"{label}: launch counts differ from {expect}")
    check(coords.shape == (sim.n_sims, steps // save_interval, sim.n_atoms,
                           3),
          f"{label}: frames of shape {coords.shape}")
    if "pair_d_min" in sim.simulated_frames:
        d_seen = float(sim.simulated_frames["pair_d_min"].min())
        floor = sim.model.schnet_config.cheb_d_min
        print(f"{label}: smallest pair distance at the save points "
              f"{d_seen:.4f} A, cheb_d_min {floor}"
              + (" (crossed: the run warned)" if d_seen < floor else ""))
    return counts, m["ms_per_timestep"], sim


def run_tier_slices(ff, cfgs, pbc_cfgs, dev, steps, beside, smi,
                    perblock_steps=TIER_SHORT_STEPS):
    """The slice of a field at another tier than bf16 (bf16x3 or fp32):
    ``steps`` steps on the stacked schedule (launches 3/2/1 per force
    evaluation on the tier's counters, every other counter 0), its
    throughput beside those of ``beside`` ({slice: throughput} of this
    process), a profiler window; then TIER_SHORT_STEPS steps periodic,
    ``perblock_steps`` per-block (above TIER_SHORT_STEPS with its
    throughput beside the stacked run's, no twin call and a profiler
    window) and TIER_SHORT_STEPS per-block periodic, each with its own
    counters set to 0 just before and read just after. Returns the tier's
    counters as the runs that launch them read them, and the stacked
    run's throughput."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    cfg = ff.schnet_config
    tier = cfg.precision
    n_short = TIER_SHORT_STEPS + 1
    short = (TIER_SHORT_STEPS, TIER_SHORT_STEPS // 2)  # two frames
    with cheb_schedule("1"):
        counts, _, sim = run_slice(
            tier, ff, cfgs, dev, steps, SAVE_INTERVAL, ck,
            cheb_counts(steps + 1, tier=tier), smi, gptq=None,
        )
        tp = sim.get_throughput_metrics()["throughput"]
        print(f"{tier}: second-half throughput {tp:.1f} timestep*mol/s "
              f"({steps} steps, orders {cheb_orders(cfg)} on d_min "
              f"{cfg.cheb_d_min}) beside " + ", ".join(
                  f"the {name} slice's {v:.1f} (ratio {tp / v:.4f})"
                  for name, v in beside.items()) + f" in this run, on {smi}")
        profile_steps(sim, dev, PROFILE_STEPS, tier)
        pbc, _, _ = run_slice(
            f"{tier} periodic", ff, pbc_cfgs, dev, *short, ck,
            cheb_counts(n_short, cell=True, tier=tier), smi, gptq=None,
        )
    with cheb_schedule("0"):
        pb_run = ((perblock_steps, SAVE_INTERVAL)
                  if perblock_steps > TIER_SHORT_STEPS else short)
        with counting_twins() as twins:
            pb, _, sim = run_slice(
                f"{tier} per-block", ff, cfgs, dev, *pb_run, ck,
                cheb_counts(pb_run[0] + 1, per_block=True, tier=tier), smi,
                gptq=None,
            )
        check(not any(twins.values()), f"{tier} per-block: twin calls "
                                       f"{twins}")
        if perblock_steps > TIER_SHORT_STEPS:
            pb_tp = sim.get_throughput_metrics()["throughput"]
            print(f"{tier} per-block: second-half throughput {pb_tp:.1f} "
                  f"timestep*mol/s ({perblock_steps} steps, "
                  f"FLASHMD_CHEB_STACK=0, twin calls 0) beside the stacked "
                  f"{tier} slice's {tp:.1f} in this run (ratio "
                  f"{pb_tp / tp:.4f}), on {smi}")
            profile_steps(sim, dev, PROFILE_STEPS, f"{tier} per-block")
        pb_pbc, _, _ = run_slice(
            f"{tier} per-block periodic", ff, pbc_cfgs, dev, *short, ck,
            cheb_counts(n_short, per_block=True, cell=True, tier=tier),
            smi, gptq=None,
        )
    sfx = "_" + tier
    out = {k: v for k, v in counts.items() if k.endswith(sfx)}
    out.update({k: v for k, v in pbc.items() if k.endswith("_cell" + sfx)})
    out["cheb_bwd_gxgd" + sfx] = pb["cheb_bwd_gxgd" + sfx]
    out["cheb_bwd_gxgd_cell" + sfx] = pb_pbc["cheb_bwd_gxgd_cell" + sfx]
    return out, tp


def phase_dense_fp32_slice(cfgs, dev, bf16_tp, smi):
    """cgschnet_1enh_like(precision="fp32", message_passing="dense") at the
    slice's shapes, gptq None: DENSE_FP32_STEPS BAOAB steps with dense
    fwd 3 and bwd 3 per force evaluation (every other counter 0) and no
    twin call, the throughput beside the bf16 dense slice's, a profiler
    window. Returns the launch counts under the fp32 keys."""
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    ff, _ = _force_fields(dev, BATCH, message_passing="dense",
                          precision="fp32")
    check((ff.schnet_config.precision, ff.schnet_config.message_passing)
          == ("fp32", "dense"),
          f"unexpected dense fp32 config {ff.schnet_config}")
    n_evals = DENSE_FP32_STEPS + 1
    ck.reset_launch_counts()
    with counting_twins("dense") as twins:
        counts, _, sim = run_slice(
            "dense fp32", ff, cfgs, dev, DENSE_FP32_STEPS, SAVE_INTERVAL, cd,
            {"dense_cfconv_fwd": 3 * n_evals,
             "dense_cfconv_bwd": 3 * n_evals}, smi, gptq=None)
    check(not any(twins.values()), f"dense fp32: twin calls {twins}")
    check(not any(ck.launch_counts().values()),
          f"dense fp32: cheb launches {ck.launch_counts()}")
    tp = sim.get_throughput_metrics()["throughput"]
    print(f"dense fp32: second-half throughput {tp:.1f} timestep*mol/s "
          f"({DENSE_FP32_STEPS} steps, twin calls 0, every cheb counter 0) "
          f"beside the bf16 dense slice's {bf16_tp:.1f} in this run (ratio "
          f"{tp / bf16_tp:.4f}), on {smi}")
    profile_steps(sim, dev, PROFILE_STEPS, "dense fp32")
    return {k + "_fp32": v for k, v in counts.items()}


def phase_pallas_fp32_slice(cfgs, dev, bf16_tp, smi):
    """cgschnet_1enh_like(precision="fp32", message_passing="pallas") at the
    slice's shapes (K from the zoo rule, skin 1.0, the list rebuilt every
    step), gptq None: PALLAS_FP32_STEPS BAOAB steps with cfconv_fwd 3 and
    cfconv_bwd 3 per force evaluation (every cheb and dense counter 0) and
    no twin call, the throughput beside the bf16 pallas slice's, a profiler
    window that must name the fp32 forward's kernel. Returns the launch
    counts under the fp32 keys."""
    from flashmd_tpu_torch.ops import cfconv as cf

    ff, _ = _force_fields(dev, BATCH, message_passing="pallas",
                          precision="fp32")
    check((ff.schnet_config.precision, ff.schnet_config.message_passing)
          == ("fp32", "pallas"),
          f"unexpected pallas fp32 config {ff.schnet_config}")
    n_evals = PALLAS_FP32_STEPS + 1
    AllKernels.reset_launch_counts()
    with counting_twins("pallas") as twins:
        counts, _, sim = run_slice(
            "pallas fp32", ff, cfgs, dev, PALLAS_FP32_STEPS, SAVE_INTERVAL,
            cf, {"cfconv_fwd": 3 * n_evals, "cfconv_bwd": 3 * n_evals}, smi,
            gptq=None)
    check(not any(twins.values()), f"pallas fp32: twin calls {twins}")
    others = {k: v for k, v in AllKernels.launch_counts().items()
              if k not in counts}
    check(not any(others.values()), f"pallas fp32: other launches {others}")
    tp = sim.get_throughput_metrics()["throughput"]
    print(f"pallas fp32: second-half throughput {tp:.1f} timestep*mol/s "
          f"({PALLAS_FP32_STEPS} steps, K {ff.neighbor_capacity}, skin "
          f"{sim.neighbor_skin}, rebuild every "
          f"{sim.neighbor_rebuild_interval} step(s), twin calls 0, every "
          f"cheb and dense counter 0) beside the bf16 pallas slice's "
          f"{bf16_tp:.1f} in this run (ratio {tp / bf16_tp:.4f}), on {smi}")
    seen = profile_steps(sim, dev, PROFILE_STEPS, "pallas fp32")
    check(not seen or any("nbr_fwd_ffma_kernel" in k for k in seen),
          "pallas fp32: the profile shows no nbr_fwd_ffma_kernel")
    return {k + "_fp32": v for k, v in counts.items()}


def phase_fp32_forces(dev):
    """The fp32 slice's field at FORCE_BATCH: card (kernels) vs CPU (twins)
    at CROSS_BOUND (two fp32 evaluations of one function); then its total
    and network forces against the dense fp32 field on the same weights
    and positions (printed, not gated: the fidelity of the zoo's fp32
    orders on the full domain)."""
    phase_forces(dev, "cheb", label="cheb fp32 (the zoo's fp32 defaults)",
                 bound=CROSS_BOUND, precision="fp32")
    ff_c, cfgs = _force_fields(dev, FORCE_BATCH, precision="fp32")
    ff_d, _ = _force_fields(dev, FORCE_BATCH, precision="fp32",
                            message_passing="dense")
    for label, keep_priors in (("total", True), ("network only", False)):
        def forces(ff):
            return _forces(ff if keep_priors else ff.replace(priors={}),
                           cfgs, dev)[1]

        f_ref = forces(ff_d)
        rel = float((forces(ff_c) - f_ref).abs().max() / f_ref.abs().max())
        print(f"fidelity: {label} forces, batch {FORCE_BATCH}, max|F - "
              f"F_dense_fp32|/max|F_dense_fp32|: cheb fp32 "
              f"{cheb_orders(ff_c.schnet_config)} d_min "
              f"{ff_c.schnet_config.cheb_d_min} = {rel:.4e} (printed, not "
              "gated)")


def profile_steps(sim, dev, steps, label, ops=0):
    """torch.profiler over ``steps`` more steps of a simulated run: the
    kernels by device time, and the device's busy and idle share of the
    wall time (kernels run on one stream, so their times add); with
    ``ops``, also that many PyTorch ops by the device time of the kernels
    each launched itself. Returns the names of the kernels seen (none when
    the profiler saw no device time)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(7)
    carry = sim.final_carry
    # the steps after the run's last, with their draws made up front
    first = sim.n_timesteps
    draws = [sim._step_draws(gen, first + i) for i in range(steps)]
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (xi, u) in enumerate(draws):
            carry = sim._step_with_hooks(carry, xi, first + i, u)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy_ms == 0:
        print(f"profile: {label}: the profiler saw no device time: not "
              "measured")
        return []
    print(f"profile: {label}: {steps} steps: wall {wall_ms:.3f} ms/step, "
          f"device kernel time {busy_ms:.3f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    for e in kernels[:12]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"profile: {label}: {ms:8.3f} ms/step {e.count / steps:6.1f}"
              f"/step {ms / wall_ms:.4f} {e.key[:90]}")
    host_ops = sorted(
        (e for e in prof.key_averages()
         if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    for e in host_ops[:ops]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"profile: {label}: op {ms:8.3f} ms/step {e.count / steps:6.1f}"
              f"/step {ms / busy_ms:.4f} of device {e.key[:60]}")
    return [e.key for e in kernels]


# ---------------------------------------------------------------------------
# The other integrators: NVE, overdamped, parallel tempering
# ---------------------------------------------------------------------------

def total_energy_excursion(sim):
    """max over save points of |E_tot - E_tot(0)| per molecule, [S], in
    float64 on the host; E_tot(0) from the start positions and velocities
    (one more force evaluation, after the run's counters were read)."""
    from flashmd_tpu_torch.simulation.langevin import kinetic_energy

    system = sim.initial_system
    with torch.no_grad():
        e0 = (sim._init_carry(system)["potential"]
              + kinetic_energy(system.velocities, system.masses))
    e0 = e0.double().cpu().numpy()
    e = (sim.simulated_potential.astype(np.float64)
         + sim.simulated_kinetic_energies.astype(np.float64))
    return np.abs(e - e0).max(axis=0), np.abs(e0)


def phase_nve_overdamped(ff, cfgs, dev, open_tp, smi):
    """NVE and overdamped runs of the cheb slice: launches 3/2/1 per force
    evaluation, finite positions, throughput beside the open cheb slice's;
    NVE's total-energy excursion printed, not gated (the cheb forces are
    not the gradient of the cheb energy: the derivative series is a fit of
    its own)."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation import (
        NVESimulation,
        OverdampedSimulation,
    )

    expect = cheb_counts(STEPS + 1)
    _, _, sim = run_slice("nve", ff, cfgs, dev, STEPS, SAVE_INTERVAL, ck,
                          expect, smi, cls=NVESimulation, save_energies=True)
    tp = sim.get_throughput_metrics()["throughput"]
    exc, e0 = total_energy_excursion(sim)
    print(f"nve: second-half throughput {tp:.1f} timestep*mol/s beside the "
          f"open cheb slice's {open_tp:.1f} in this run (ratio "
          f"{tp / open_tp:.4f}); cheb bf16 max|E_tot - E_tot(0)| per "
          f"molecule: median {np.median(exc):.4e}, max {exc.max():.4e} "
          f"(mean |E_tot(0)| {e0.mean():.4e}); not gated")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Masses were provided")
        _, _, sim = run_slice("overdamped", ff, cfgs, dev, STEPS,
                              SAVE_INTERVAL, ck, expect, smi,
                              cls=OverdampedSimulation, friction=1.0)
    tp = sim.get_throughput_metrics()["throughput"]
    print(f"overdamped: friction 1.0, second-half throughput {tp:.1f} "
          f"timestep*mol/s beside the open cheb slice's {open_tp:.1f} "
          f"(ratio {tp / open_tp:.4f})")


def phase_nve_drift(dev):
    """Velocity Verlet on the dense fp32 field (forces = autograd of its
    energy) from the same start velocities, over the same time at two
    steps: the total-energy excursion falls as dt^2."""
    from flashmd_tpu_torch.simulation import NVESimulation

    ff, cfgs = _force_fields(dev, NVE_DRIFT_BATCH, message_passing="dense",
                             precision="fp32")
    exc = {}
    for dt, steps in NVE_DRIFT_RUNS:
        sim = NVESimulation(dt=dt, n_timesteps=steps,
                            save_interval=steps // 20, save_energies=True,
                            random_seed=103838, device=dev, gptq=None)
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
        coords = sim.simulate()
        check(bool(np.isfinite(coords).all()),
              f"nve drift: non-finite positions at dt {dt}")
        per_mol, e0 = total_energy_excursion(sim)
        exc[dt] = per_mol.max()
        print(f"nve drift: dense fp32 batch {NVE_DRIFT_BATCH}, dt {dt}, "
              f"{steps} steps: max|E_tot - E_tot(0)| {exc[dt]:.6e} (median "
              f"per molecule {np.median(per_mol):.6e}; mean |E_tot(0)| "
              f"{e0.mean():.6e})")
    (dt1, _), (dt2, _) = NVE_DRIFT_RUNS
    ratio = exc[dt1] / exc[dt2]
    print(f"nve drift: excursion ratio dt {dt1} / dt {dt2} = {ratio:.4f} "
          f"(velocity Verlet: {(dt1 / dt2) ** 2:.0f}; gated >= "
          f"{DRIFT_RATIO_MIN})")
    check(ratio >= DRIFT_RATIO_MIN, "nve drift: no O(dt^2) energy error")


def phase_pt(dev, open_tp, open_ms, smi):
    """benchmarks/run_all.py:_cfg_pt's configuration on the cheb slice's
    field: PT_INDEP structures x PT_BETAS, two runs with one seed. Gates:
    the cheb launches (the exchange launches none), the attempts, the
    matrix's off-diagonal sum, the bitwise repeat, hotter replicas
    reading a higher kinetic energy. Returns the first run."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation import PTSimulation

    ff, cfgs = _force_fields(dev, PT_INDEP)
    runs = []
    for label in ("pt", "pt repeat"):
        _, ms, sim = run_slice(
            label, ff, cfgs, dev, STEPS, PT_SAVE_INTERVAL, ck,
            cheb_counts(STEPS + 1), smi, cls=PTSimulation, beta=PT_BETAS,
            friction=1.0, exchange_interval=PT_EXCHANGE_INTERVAL,
            save_energies=True,
        )
        runs.append((ms, sim))
    (ms, sim), (_, again) = runs
    attempted = int(sim.final_carry["n_exchange_attempted"])
    approved = int(sim.final_carry["n_exchange_approved"])
    acc = sim.final_carry["acceptance_matrix"].cpu().numpy()
    off_diag = int(acc.sum() - np.trace(acc))
    n_exchanges = STEPS // PT_EXCHANGE_INTERVAL
    print(f"pt: {n_exchanges} exchanges (every {PT_EXCHANGE_INTERVAL} steps; "
          f"the example's 100 would give 1 in {STEPS}): attempted "
          f"{attempted} (expected {n_exchanges * PT_INDEP}), approved "
          f"{approved}, rate {approved / attempted:.4f}; final int32 "
          f"matrix {acc.tolist()} (off-diagonal sum {off_diag})")
    check(attempted == n_exchanges * PT_INDEP, "pt: attempts")
    check(off_diag == attempted, "pt: matrix off-diagonal sum != attempts")
    same = (torch.equal(sim.final_carry["pos"], again.final_carry["pos"])
            and np.array_equal(sim.simulated_acceptance,
                               again.simulated_acceptance))
    print(f"pt: two runs with one seed: final positions and matrices "
          f"bitwise equal: {same}")
    check(same, "pt: two runs with one seed differ")
    per_dof = [kinetic_per_dof(sim, slice(r * PT_INDEP, (r + 1) * PT_INDEP))
               for r in range(sim.n_replicas)]
    print("pt: mean kinetic energy per degree of freedom over the second "
          "half: " + ", ".join(
              f"beta {b}: {k:.5f} (1/(2 beta) {0.5 / b:.5f})"
              for b, k in zip(PT_BETAS, per_dof)))
    check(all(a < b for a, b in zip(per_dof, per_dof[1:])),
          "pt: hotter replicas do not read a higher kinetic energy")
    tp = sim.get_throughput_metrics()["throughput"]
    print(f"pt: second-half throughput {tp:.1f} timestep*mol/s ({ms:.3f} "
          f"ms/step at {sim.n_sims} slots) beside the open cheb slice's "
          f"{open_tp:.1f} ({open_ms:.3f} ms/step at {BATCH}) in this run "
          f"(ratio {tp / open_tp:.4f})")
    profile_steps(sim, dev, PT_EXCHANGE_INTERVAL, "pt")


def phase_pt_exchange(dev):
    """One exchange at full width on the pallas path (open) and on the xla
    path in the BOX cell (positions folded into it), with distinct
    positions per slot, the list
    rebuilt, and potentials set so that every pair of the even group
    swaps, under torch.cuda.set_sync_debug_mode("error"). Gates: the
    permuted list entries and the CSR built again equal a fresh build at
    the permuted positions, and so do its forces, bitwise."""
    from flashmd_tpu_torch.simulation import PTSimulation

    for label, mp, cell in (("pallas", "pallas", None),
                            ("xla", "xla", BOX)):
        ff, cfgs = _force_fields(dev, PT_INDEP, message_passing=mp)
        if cell is not None:
            # folded into the cell, so that live pairs cross its faces
            cfgs = with_cells(cfgs, np.stack([cell * np.eye(3)] * PT_INDEP),
                              folded=True)
        sim = PTSimulation(friction=1.0, dt=0.004, n_timesteps=10,
                           save_interval=10, exchange_interval=10,
                           neighbor_rebuild_interval=2, device=dev)
        sim.attach_model_and_configurations(ff, cfgs, PT_BETAS)
        gen = torch.Generator(device=dev).manual_seed(11)
        with torch.no_grad():
            carry = sim._init_carry(sim.initial_system)
            carry["pos"] = carry["pos"] + 0.2 * torch.randn(
                carry["pos"].shape, generator=gen, device=dev)
            carry = sim._rebuild_neighbors(carry)
            carry["potential"], carry["forces"], _ = sim._forces(
                carry, carry["pos"])
            # U_a - U_b > 0 with beta_a > beta_b on every adjacent pair
            carry["potential"] = 100.0 * (
                sim.n_replicas - 1 - sim._slot_to_replica).float()
            u = torch.rand(sim._subroutine_draw_shape(), generator=gen,
                           device=dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                new = sim._device_subroutine(carry, u)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ms = cuda_time_ms(lambda: sim._device_subroutine(carry, u))
            n = PT_INDEP
            perm = torch.cat([torch.arange(n, 2 * n), torch.arange(n),
                              torch.arange(2 * n, 3 * n)]).to(dev)
            nbr, fresh = new["nbr"], sim._rebuild_neighbors(dict(new))
            equal = {
                "approved": int(new["n_exchange_approved"]) == n,
                "pos": torch.equal(new["pos"], carry["pos"][perm]),
                "nbr_ref_pos": torch.equal(new["nbr_ref_pos"],
                                           fresh["nbr_ref_pos"]),
            }
            for leaf in ("idx", "mask", "shifts", "csr_offsets",
                         "csr_slots"):
                a, b = getattr(nbr, leaf), getattr(fresh["nbr"], leaf)
                equal[leaf] = (a is None and b is None) or torch.equal(a, b)
            equal["forces"] = torch.equal(sim._forces(new, new["pos"])[1],
                                          sim._forces(fresh,
                                                      fresh["pos"])[1])
        shifts = ("" if cell is None else
                  f", {int(nbr.shifts.abs().sum(-1).gt(0).sum())} slots "
                  "with a nonzero shift")
        print(f"pt exchange: {label} at {sim.n_sims} slots"
              f" (K {ff.neighbor_capacity}, skin {sim.neighbor_skin}"
              f"{shifts}): one exchange under set_sync_debug_mode('error') "
              f"in {ms:.3f} ms; equal to a fresh build at the permuted "
              f"positions, bitwise: {equal}")
        check(all(equal.values()),
              f"pt exchange {label}: the permuted carry differs from a "
              "fresh build")


# ---------------------------------------------------------------------------
# The checkpoint slice: a full-width model_and_prior.pt in the reference's
# pickled module layout, ingested with the port
# ---------------------------------------------------------------------------

CKPT_TYPES = 25
CKPT_SHORT_STEPS = 10
CKPT_MAX_NEIGHBORS = 64
# The reference's module paths, registered while the files are written and
# removed after, so that the loader meets them as unimportable symbols.
CKPT_MODULES = ("flashmd", "flashmd.models", "flashmd.models.schnet",
                "flashmd.prior", "flashmd.data")


def reference_layout_classes():
    """Classes with the reference checkpoint's names, module paths and
    attributes (GradientsOut(SumOut({SchNet, priors})), AtomicData), each
    with its own forward: the ground truth here computes through them and
    not through the port. SchNet.forward(pos [S, A, 3], types [A]) sums
    every pair within the cutoff; a prior's forward(pos, types, mapping)
    gathers its type tables per term."""
    import math
    import types as pytypes

    nn = torch.nn

    class CosineCutoff(nn.Module):
        def __init__(self, lower, upper):
            super().__init__()
            self.cutoff_lower = lower
            self.cutoff_upper = upper

        def forward(self, d):
            return 0.5 * (torch.cos(d * math.pi / self.cutoff_upper)
                          + 1.0) * (d < self.cutoff_upper)

    class IdentityCutoff(nn.Module):
        """What the reference's GaussianBasis makes of a plain number."""

        def __init__(self, lower, upper):
            super().__init__()
            self.cutoff_lower = lower
            self.cutoff_upper = upper

        def forward(self, d):
            return torch.ones_like(d)

    class GaussianBasis(nn.Module):
        def __init__(self, cutoff, num_rbf):
            super().__init__()
            self.cutoff = cutoff
            offset = torch.linspace(0.0, cutoff.cutoff_upper, num_rbf)
            self.register_buffer("offset", offset)
            self.register_buffer("coeff",
                                 -0.5 / (offset[1] - offset[0]) ** 2)

        def forward(self, d):
            d = d[..., None]
            return torch.exp(self.coeff * (d - self.offset) ** 2) \
                * self.cutoff(d)

    class MLP(nn.Module):
        def __init__(self, widths, last_bias=True):
            super().__init__()
            layers = []
            for w_in, w_out in zip(widths[:-2], widths[1:-1]):
                layers += [nn.Linear(w_in, w_out), nn.Tanh()]
            layers.append(nn.Linear(widths[-2], widths[-1], bias=last_bias))
            self.layers = nn.Sequential(*layers)

        def forward(self, x):
            return self.layers(x)

    class CFConv(nn.Module):
        def __init__(self, hidden, filters, num_rbf, cutoff):
            super().__init__()
            self.lin1 = nn.Linear(hidden, filters, bias=False)
            self.lin2 = nn.Linear(filters, hidden)
            self.filter_network = MLP([num_rbf, filters, filters],
                                      last_bias=False)
            self.cutoff = cutoff

        def forward(self, x, rbf, d, live):
            w = self.filter_network(rbf) * (self.cutoff(d) * live)[..., None]
            return self.lin2(torch.einsum("sijf,sjf->sif", w, self.lin1(x)))

    class InteractionBlock(nn.Module):
        def __init__(self, conv, hidden):
            super().__init__()
            self.conv = conv
            self.lin = nn.Linear(hidden, hidden)

        def forward(self, x, rbf, d, live):
            return self.lin(torch.tanh(self.conv(x, rbf, d, live)))

    class SchNet(nn.Module):
        def __init__(self, hidden=128, filters=128, num_rbf=50, blocks=3,
                     rcut=10.0, embedding=100, head=(128, 64),
                     identity_basis=False):
            super().__init__()
            cutoff = CosineCutoff(0.0, rcut)
            self.embedding_layer = nn.Embedding(embedding, hidden)
            self.rbf_layer = GaussianBasis(
                IdentityCutoff(0.0, rcut) if identity_basis else cutoff,
                num_rbf)
            self.interaction_blocks = nn.Sequential(*[
                InteractionBlock(CFConv(hidden, filters, num_rbf, cutoff),
                                 hidden) for _ in range(blocks)])
            self.output_network = MLP([hidden, *head, 1], last_bias=False)
            self.max_num_neighbors = 1000

        def forward(self, pos, types):
            rel = pos[:, None, :, :] - pos[:, :, None, :]
            d2 = torch.sum(rel * rel, dim=-1)
            off = ~torch.eye(pos.shape[1], dtype=torch.bool,
                             device=pos.device)
            d = torch.sqrt(torch.where(off, d2, torch.ones_like(d2)))
            live = off & (d < self.rbf_layer.cutoff.cutoff_upper)
            rbf = self.rbf_layer(d)
            x = self.embedding_layer(types).expand(pos.shape[0], -1, -1)
            for block in self.interaction_blocks:
                x = x + block(x, rbf, d, live)
            return self.output_network(x)[..., 0].sum(dim=-1)

    def _gather(table, types, mapping):
        return table[tuple(types[m] for m in mapping)]

    def _cos_angle(pos, mapping):
        dr1 = pos[:, mapping[0]] - pos[:, mapping[1]]
        dr2 = pos[:, mapping[2]] - pos[:, mapping[1]]
        return torch.sum(dr1 * dr2, -1) / (dr1.norm(dim=-1)
                                          * dr2.norm(dim=-1))

    def _torsion(pos, mapping):
        def unit(v):
            return v / v.norm(dim=-1, keepdim=True)

        b1 = unit(pos[:, mapping[1]] - pos[:, mapping[0]])
        b2 = unit(pos[:, mapping[2]] - pos[:, mapping[1]])
        b3 = unit(pos[:, mapping[3]] - pos[:, mapping[2]])
        n1, n2 = torch.cross(b1, b2, dim=-1), torch.cross(b2, b3, dim=-1)
        m1 = torch.cross(n1, b2, dim=-1)
        return torch.atan2(-torch.sum(m1 * n2, -1), torch.sum(n1 * n2, -1))

    class HarmonicBonds(nn.Module):
        def __init__(self, x_0, k):
            super().__init__()
            self.order = 2
            self.register_buffer("x_0", x_0)
            self.register_buffer("k", k)

        def forward(self, pos, types, mapping):
            x = (pos[:, mapping[1]] - pos[:, mapping[0]]).norm(dim=-1)
            return torch.sum(_gather(self.k, types, mapping) * (
                x - _gather(self.x_0, types, mapping)) ** 2, dim=-1)

    class HarmonicAngles(HarmonicBonds):
        def __init__(self, x_0, k):
            super().__init__(x_0, k)
            self.order = 3

        def forward(self, pos, types, mapping):
            x = _cos_angle(pos, mapping)
            return torch.sum(_gather(self.k, types, mapping) * (
                x - _gather(self.x_0, types, mapping)) ** 2, dim=-1)

    class Dihedral(nn.Module):
        def __init__(self, k1s, k2s, v_0):
            super().__init__()
            self.order = 4
            self.n_degs = k1s.shape[0]
            self.register_buffer("k1s", k1s)
            self.register_buffer("k2s", k2s)
            self.register_buffer("v_0", v_0)

        def forward(self, pos, types, mapping):
            theta = _torsion(pos, mapping)
            v = _gather(self.v_0, types, mapping)
            for n in range(self.n_degs):
                v = v + _gather(self.k1s[n], types, mapping) * torch.sin(
                    (n + 1) * theta) + _gather(self.k2s[n], types,
                                               mapping) * torch.cos(
                    (n + 1) * theta)
            return torch.sum(v, dim=-1)

    class Repulsion(nn.Module):
        def __init__(self, sigma):
            super().__init__()
            self.order = 2
            self.register_buffer("sigma", sigma)

        def forward(self, pos, types, mapping):
            x = (pos[:, mapping[1]] - pos[:, mapping[0]]).norm(dim=-1)
            return torch.sum((_gather(self.sigma, types, mapping) / x) ** 6,
                             dim=-1)

    class GradientsOut(nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

    class SumOut(nn.Module):
        def __init__(self, models):
            super().__init__()
            self.models = nn.ModuleDict(models)

    class AtomicData:
        """Pickles as a PyG Data: its fields in a nested storage dict."""

        def __init__(self, **fields):
            self._store = pytypes.SimpleNamespace(_mapping=fields)

    paths = {"flashmd.models.schnet": (CosineCutoff, IdentityCutoff,
                                       GaussianBasis, MLP,
                                       CFConv, InteractionBlock, SchNet,
                                       GradientsOut, SumOut),
             "flashmd.prior": (HarmonicBonds, HarmonicAngles, Dihedral,
                               Repulsion),
             "flashmd.data": (AtomicData,)}
    classes = {}
    for module, group in paths.items():
        for cls in group:
            cls.__module__ = module
            cls.__qualname__ = cls.__name__
            classes[cls.__name__] = cls
    return paths, classes


def _seeded_(module, gen):
    """Every parameter of ``module`` drawn from ``gen``: weights Xavier
    uniform, biases uniform in +-0.1, embeddings standard normal."""
    import math

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.2 * torch.rand(p.shape, generator=gen) - 0.1)
            elif "embedding" in name:
                p.copy_(torch.randn(p.shape, generator=gen))
            else:
                a = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.copy_((2 * torch.rand(p.shape, generator=gen) - 1) * a)
    return module


def write_reference_checkpoint(directory, seed=0, identity_basis=False,
                               max_num_neighbors=1000):
    """model_and_prior.pt and configurations.pt under ``directory``: a
    CGSchNet at the zoo's 1ENH widths (hidden and filters 128, 3 blocks,
    50 RBF, CosineCutoff(0, 10), embedding 100, head [128, 128, 64, 1],
    tanh) with bonds, cos angles, Fourier dihedrals (3 degrees) and a
    repulsion over the non-bonded pairs, type tables over the 25 bead
    types; BATCH structures of random_cg_protein's chain with noise. Every
    number is drawn from ``seed``. With ``identity_basis`` the basis
    carries IdentityCutoff(0, 10), as a plain-number cutoff gives it.
    Returns (the modules, the structures' positions [BATCH, A, 3]
    float64, the types [A], the term lists)."""
    import sys
    import types as pytypes

    from flashmd_tpu_torch.models.zoo import random_cg_protein

    paths, cls = reference_layout_classes()
    gen = torch.Generator().manual_seed(seed)
    t = CKPT_TYPES

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    schnet = _seeded_(cls["SchNet"](identity_basis=identity_basis), gen)
    schnet.max_num_neighbors = max_num_neighbors
    priors = {
        "bonds": cls["HarmonicBonds"](uniform(3.7, 3.9, t, t),
                                      uniform(40.0, 80.0, t, t)),
        "angles": cls["HarmonicAngles"](uniform(-0.4, 0.0, t, t, t),
                                        uniform(5.0, 15.0, t, t, t)),
        "dihedrals": cls["Dihedral"](uniform(-0.5, 0.5, 3, t, t, t, t),
                                     uniform(-0.5, 0.5, 3, t, t, t, t),
                                     uniform(-0.1, 0.1, t, t, t, t)),
        "repulsion": cls["Repulsion"](uniform(2.9, 3.1, t, t)),
    }
    model = cls["GradientsOut"](cls["SumOut"](
        {"SchNet": cls["GradientsOut"](schnet),
         **{k: cls["GradientsOut"](v) for k, v in priors.items()}}))

    base = random_cg_protein(n_atoms=N_ATOMS, n_types=t, seed=seed)
    rng = np.random.default_rng(seed + 7)
    pos = np.stack([base.pos + rng.normal(scale=0.05, size=base.pos.shape)
                    for _ in range(BATCH)])
    lists = {k: tl.index_mapping.astype(np.int64)
             for k, tl in base.neighbor_lists.items()}
    # one dict for every structure: pickled once
    nls = {k: dict(tag=k, order=m.shape[0], index_mapping=torch.tensor(m),
                   mapping_batch=torch.zeros(m.shape[1], dtype=torch.long),
                   cell_shifts=None, rcut=None, self_interaction=False)
           for k, m in lists.items()}
    data = [cls["AtomicData"](pos=torch.tensor(p, dtype=torch.float32),
                              atom_types=torch.tensor(base.atom_types),
                              masses=torch.tensor(base.masses,
                                                  dtype=torch.float32),
                              neighbor_list=nls, tag=base.tag)
            for p in pos]
    for name in CKPT_MODULES:
        sys.modules[name] = pytypes.ModuleType(name)
    try:
        for module, group in paths.items():
            for c in group:
                setattr(sys.modules[module], c.__name__, c)
        torch.save(model, os.path.join(directory, "model_and_prior.pt"))
        torch.save(data, os.path.join(directory, "configurations.pt"))
    finally:
        for name in CKPT_MODULES:
            del sys.modules[name]
    return (schnet, priors), pos, base.atom_types, lists


def reference_forces(modules, pos, types, lists, dev, network_only=False):
    """[S, A, 3] fp32 autograd forces of the written modules' own forward
    on the card (the SchNet term, and the priors unless
    ``network_only``)."""
    schnet, priors = modules
    p = torch.tensor(pos, dtype=torch.float32, device=dev,
                     requires_grad=True)
    t = torch.as_tensor(types, device=dev)
    e = schnet.to(dev)(p, t)
    if not network_only:
        for k, prior in priors.items():
            e = e + prior.to(dev)(p, t, torch.as_tensor(lists[k],
                                                        device=dev))
    (g,) = torch.autograd.grad(e.sum(), p)
    return -g


class FrontierLog(logging.Handler):
    """Keeps the FrontierReport that models.frontier logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.reports = []

    def emit(self, record):
        if hasattr(record, "frontier"):
            self.reports.append(record.frontier)


@contextlib.contextmanager
def counting_twins(kind="cheb"):
    """Every twin of the cheb (``kind`` "cheb"), dense ("dense") or
    neighbour-matrix ("pallas") kernels counted while the block runs;
    yields the counts."""
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    mod, names = {
        "cheb": (ck, ("cheb_conv_fwd_plain", "cheb_conv_bwd_gx_plain",
                      "cheb_conv_bwd_gd_plain", "cheb_conv_bwd_gxgd_plain")),
        "dense": (cd, ("dense_cfconv_fwd_plain", "dense_cfconv_bwd_plain")),
        "pallas": (cf, ("cfconv_fwd_plain", "cfconv_bwd_plain")),
    }[kind]
    counts = dict.fromkeys(names, 0)
    old = {n: getattr(mod, n) for n in names}

    def counted(name):
        def twin(*args, **kw):
            counts[name] += 1
            return old[name](*args, **kw)
        return twin

    for n in names:
        setattr(mod, n, counted(n))
    try:
        yield counts
    finally:
        for n, fn in old.items():
            setattr(mod, n, fn)


def build_with_frontier(ref, cfgs, dev):
    """build_forcefield(optimize=True) on the card: (the field, the
    frontier's report, the seconds it took after a synchronize)."""
    from flashmd_tpu_torch.models import checkpoint_io as cio

    log = FrontierLog()
    frontier_logger = logging.getLogger("flashmd_tpu_torch.models.frontier")
    frontier_logger.addHandler(log)
    frontier_logger.setLevel(logging.INFO)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs,
                                  device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        frontier_logger.removeHandler(log)
    check(len(log.reports) == 1, "the frontier logged no measurement")
    return ff, log.reports[0], seconds


def phase_checkpoint(dev, open_tp, smi, tmp):
    """The checkpoint slice (the module docstring's `checkpoint` phase);
    the checkpoint's two files stay in the directory ``tmp``."""
    import time

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models import checkpoint_io as cio
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    t0 = time.perf_counter()
    modules, pos, types, lists = write_reference_checkpoint(tmp)
    t1 = time.perf_counter()
    ref = cio.load_reference_checkpoint(
        os.path.join(tmp, "model_and_prior.pt"))
    cfgs = cio.load_reference_configurations(
        os.path.join(tmp, "configurations.pt"))
    t2 = time.perf_counter()
    check(len(cfgs) == BATCH and ref.schnet_config.hidden_channels == 128
          and ref.schnet_config.num_interactions == 3
          and sorted(p.kind for p in ref.priors) == [
              "dihedral", "harmonic_angles", "harmonic_bonds", "repulsion"],
          f"checkpoint ingested as {ref.schnet_config}, "
          f"{[p.kind for p in ref.priors]}")
    ff, rep, frontier_s = build_with_frontier(ref, cfgs, dev)
    cfg = ff.schnet_config
    print(f"checkpoint: wrote model_and_prior.pt + configurations.pt "
          f"({BATCH} structures, A={N_ATOMS}, {CKPT_TYPES} types) in "
          f"{t1 - t0:.2f} s; ingested as {cfg.message_passing} "
          f"{cfg.precision}, priors "
          f"{ {k: p.kind for k, p in ff.priors.items()} }, K "
          f"{ff.neighbor_capacity}")
    print(f"checkpoint: frontier on {rep.n_structures} structures: d_min "
          f"{rep.d_min}, bf16 floor {rep.floor:.4e}, budget "
          f"{rep.budget:.4e}, errors "
          f"{ {f'{m1},{m2}': round(e, 6) for (m1, m2), e in rep.errors.items()} }"
          f" -> chosen {rep.chosen} -> (m1, m2, d_min) = "
          f"{(*cheb_orders(cfg), cfg.cheb_d_min)}")
    check(cfg.message_passing == "cheb" and cfg.precision == "bf16",
          f"checkpoint not on the cheb bf16 path: {cfg}")

    # the frontier's 96-order series on the card against its twins
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit
    from flashmd_tpu_torch.models.frontier import MAX_ORDER

    cfg96 = dataclasses.replace(cfg, cheb_order=MAX_ORDER,
                                cheb_order_deriv=MAX_ORDER,
                                cheb_d_min=rep.d_min)
    ff96 = ff.replace(schnet_config=cfg96, schnet_params=attach_cheb_fit(
        ff.schnet_params, cfg96))
    print(f"checkpoint: the four cheb kernels on the frontier's fit at "
          f"M1 = M2 = {MAX_ORDER}, d_min {rep.d_min} (the sweep's orders), "
          f"on the {BATCH} ingested structures:")
    phase_cheb_kernels(ff96, collate(cfgs, device=dev).pos, dev)

    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    def simulation(model, structures, steps, save_interval=SAVE_INTERVAL):
        sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=steps,
                                 save_interval=save_interval,
                                 random_seed=103838, device=dev, gptq=None)
        sim.attach_model_and_configurations(model, structures, beta=1.67)
        return sim

    torch.cuda.synchronize()
    t5 = time.perf_counter()
    sim = simulation(ff, cfgs, STEPS)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    print(f"checkpoint: attach {(t2 - t1) + frontier_s + (t6 - t5):.3f} s = "
          f"load {t2 - t1:.3f} s + frontier (build_forcefield) "
          f"{frontier_s:.3f} s "
          f"+ fit and collate (attach_model_and_configurations) "
          f"{t6 - t5:.3f} s")

    # fidelity on the tuning structures against the modules' own forces
    tune = pos[:FORCE_BATCH]
    system = collate(cfgs[:FORCE_BATCH], device=dev)
    ff_exact = cio.build_forcefield(ref, cfgs[0], optimize=False, device=dev)
    for label, network_only in (("total", False), ("network only", True)):
        f_ref = reference_forces(modules, tune, types, lists, dev,
                                 network_only)
        scale = float(f_ref.abs().max())
        strip = (lambda m: m.replace(priors={})) if network_only else (
            lambda m: m)
        f_exact = compute_energy_forces(strip(ff_exact), system.pos,
                                        system.atom_types)[1]
        f_cheb = compute_energy_forces(strip(sim.model), system.pos,
                                       system.atom_types)[1]
        rel_exact = float((f_exact - f_ref).abs().max()) / scale
        rel_cheb = float((f_cheb - f_ref).abs().max()) / scale
        print(f"forces: checkpoint {label}, batch {FORCE_BATCH}, against the "
              f"written modules' fp32 autograd forces: xla fp32 (optimize="
              f"False) {rel_exact:.3e} (bound {CROSS_BOUND:.0e}); cheb bf16 "
              f"{cheb_orders(cfg)} d_min "
              f"{cfg.cheb_d_min} {rel_cheb:.4e}")
        check(rel_exact <= CROSS_BOUND,
              f"checkpoint {label}: the ingested fp32 field disagrees")
        if network_only:
            # the frontier's own budget, with its 5 % measurement slack
            check(rel_cheb <= 1.05 * rep.budget,
                  f"checkpoint cheb forces {rel_cheb:.3e} past the budget "
                  f"{rep.budget:.3e}")

    n_evals = STEPS + 1
    with counting_twins() as twins:
        ck.reset_launch_counts()
        coords = sim.simulate()
        counts = ck.launch_counts()
    m = sim.get_throughput_metrics()
    expect = cheb_counts(n_evals)
    finite = bool(np.isfinite(coords).all())
    print(f"checkpoint: {STEPS} steps batch {BATCH} A={N_ATOMS}: finite="
          f"{finite} launches={counts} expected={expect}; twin calls "
          f"{twins}; second-half throughput {m['throughput']:.1f} "
          f"timestep*mol/s ({m['ms_per_timestep']:.3f} ms/step) beside the "
          f"zoo cheb slice's {open_tp:.1f} in this run (ratio "
          f"{m['throughput'] / open_tp:.4f}) on {smi}")
    check(finite, "checkpoint: non-finite positions")
    check(counts == expect, f"checkpoint: launch counts differ from {expect}")
    check(not any(twins.values()), f"checkpoint: twins ran: {twins}")
    profile_steps(sim, dev, PROFILE_STEPS, "checkpoint")

    again = simulation(ff, cfgs, STEPS)
    again.simulate()
    same = bool(torch.equal(sim.final_carry["forces"],
                            again.final_carry["forces"])
                and np.array_equal(sim.coords, again.coords))
    print(f"checkpoint: two identical {STEPS}-step runs: final forces and "
          f"every saved frame bitwise equal = {same}")
    check(same, "checkpoint: two identical runs differ")

    phase_prior_kinds(dev)

    for label, model, structures in (
            ("optimize=False (xla fp32)", ff_exact, cfgs),
            ("exc_pair_index (xla bf16)", *exclusion_field(ref, cfgs, dev))):
        check(model.schnet_config.message_passing == "xla",
              f"checkpoint {label}: {model.schnet_config}")
        AllKernels.reset_launch_counts()
        short = simulation(model, structures, CKPT_SHORT_STEPS,
                           CKPT_SHORT_STEPS // 2)
        coords = short.simulate()
        counts = AllKernels.launch_counts()
        finite = bool(np.isfinite(coords).all())
        print(f"checkpoint: {label}: {CKPT_SHORT_STEPS} steps batch {BATCH}: "
              f"finite={finite}; every kernel counter 0: "
              f"{counts == AllKernels.zeros()}; second-half throughput "
              f"{short.get_throughput_metrics()['throughput']:.1f} "
              "timestep*mol/s")
        check(finite and counts == AllKernels.zeros(),
              f"checkpoint {label} run failed")


def phase_checkpoint_identity_basis(dev, smi, tmp):
    """The checkpoint phase's ingestion of the same layout with a
    plain-number basis cutoff (IdentityCutoff) and max_num_neighbors
    CKPT_MAX_NEIGHBORS, under ``tmp``: optimize=True lands on cheb."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models import checkpoint_io as cio
    from flashmd_tpu_torch.models.cutoff import IdentityCutoff
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    modules, pos, types, lists = write_reference_checkpoint(
        tmp, identity_basis=True, max_num_neighbors=CKPT_MAX_NEIGHBORS)
    t0 = time.perf_counter()
    ref = cio.load_reference_checkpoint(
        os.path.join(tmp, "model_and_prior.pt"))
    cfgs = cio.load_reference_configurations(
        os.path.join(tmp, "configurations.pt"))
    t1 = time.perf_counter()
    ff, rep, frontier_s = build_with_frontier(ref, cfgs, dev)
    cfg = ff.schnet_config
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=STEPS,
                             save_interval=SAVE_INTERVAL, random_seed=103838,
                             device=dev, gptq=None)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"checkpoint identity basis: ingested as {cfg.message_passing} "
          f"{cfg.precision}, rbf_cutoff {cfg.rbf_cutoff}, cutoff "
          f"{cfg.cutoff}, max_num_neighbors {cfg.max_num_neighbors}; "
          f"frontier on {rep.n_structures} structures: bf16 floor "
          f"{rep.floor:.4e}, budget {rep.budget:.4e}, errors "
          f"{ {f'{m1},{m2}': round(e, 6) for (m1, m2), e in rep.errors.items()} }"
          f" -> chosen {rep.chosen} -> (m1, m2, d_min) = "
          f"{(*cheb_orders(cfg), cfg.cheb_d_min)}")
    print(f"checkpoint identity basis: attach "
          f"{t1 - t0 + frontier_s + t3 - t2:.3f} s = load {t1 - t0:.3f} s + "
          f"frontier (build_forcefield) {frontier_s:.3f} s + fit and collate "
          f"(attach_model_and_configurations) {t3 - t2:.3f} s")
    check(cfg.message_passing == "cheb" and cfg.precision == "bf16"
          and isinstance(cfg.rbf_cutoff, IdentityCutoff),
          f"identity basis checkpoint not on cheb bf16: {cfg}")
    check(cfg.max_num_neighbors == CKPT_MAX_NEIGHBORS,
          f"max_num_neighbors not carried: {cfg.max_num_neighbors}")
    system = collate(cfgs[:FORCE_BATCH], device=dev)
    network = sim.model.replace(priors={})
    ck.reset_launch_counts()
    f_cheb = compute_energy_forces(network, system.pos,
                                   system.atom_types)[1]
    counts = ck.launch_counts()
    f_ref = reference_forces(modules, pos[:FORCE_BATCH], types, lists, dev,
                             network_only=True)
    rel = float((f_cheb - f_ref).abs().max() / f_ref.abs().max())
    print(f"checkpoint identity basis: network forces, batch {FORCE_BATCH}, "
          f"cheb bf16 {cheb_orders(cfg)} d_min {cfg.cheb_d_min} against the "
          f"written modules' fp32 autograd forces {rel:.4e} (bound 1.05 x "
          f"budget = {1.05 * rep.budget:.4e}); launches {counts} on {smi}")
    check(counts == cheb_counts(1),
          f"identity basis: launches {counts}, expected 3/2/1")
    check(rel <= 1.05 * rep.budget,
          f"identity basis cheb forces {rel:.3e} past the budget "
          f"{rep.budget:.3e}")


def exclusion_field(ref, cfgs, dev):
    """The structures with pair exclusions (each bead with its third
    neighbour along the chain) and the field built for them: optimize=True
    takes the xla path at bf16."""
    from flashmd_tpu_torch.models import checkpoint_io as cio

    i = np.arange(N_ATOMS - 3)
    exc = np.stack([i, i + 3])
    with_exc = [dataclasses.replace(c, exc_pair_index=exc) for c in cfgs]
    ff = cio.build_forcefield(ref, with_exc[0], device=dev)
    check(ff.schnet_config.precision == "bf16", f"{ff.schnet_config}")
    return ff, with_exc


def phase_prior_kinds(dev):
    """The nine prior kinds the checkpoint does not carry, on the chain's
    term lists with per-term parameters drawn from a seed: energies and
    forces on the card against the CPU, batch 4, each within
    PRIOR_BOUND of max|CPU|."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.zoo import random_cg_protein
    from flashmd_tpu_torch.prior import priors as pr

    base = random_cg_protein(n_atoms=N_ATOMS, n_types=CKPT_TYPES)
    rng = np.random.default_rng(3)
    lists = {"distance": base.neighbor_lists["bonds"],
             "angle_cos": base.neighbor_lists["angles"],
             "angle_raw": base.neighbor_lists["angles"],
             "torsion": base.neighbor_lists["dihedrals"],
             "torsion_shifted": base.neighbor_lists["dihedrals"]}
    kinds = {
        "harmonic_angles_raw": {"x0": (1.5, 2.5), "k": (5.0, 15.0)},
        "harmonic_impropers": {"x0": (-3.0, 3.0), "k": (1.0, 5.0)},
        "shifted_periodic_harmonic_impropers": {"x0": (-0.5, 0.5),
                                                "k": (1.0, 5.0)},
        "general_bonds": {"x0": (3.7, 3.9), "k": (40.0, 80.0)},
        "general_angles": {"x0": (-0.4, 0.0), "k": (5.0, 15.0)},
        "repulsion": {"sigma": (2.9, 3.1)},
        "polynomial": {"ks": (-1.0, 1.0, 4), "v_0": (-0.1, 0.1)},
        "quartic_angles": {"ks": (-1.0, 1.0, 4), "v_0": (-0.1, 0.1)},
        "restricted_quartic": {"a": (-1.0, 1.0), "b": (-1.0, 1.0),
                               "c": (-1.0, 1.0), "d": (-1.0, 1.0),
                               "k": (0.1, 0.5), "v_0": (-0.1, 0.1)},
    }
    cfgs = [dataclasses.replace(base, pos=base.pos + rng.normal(
        scale=0.05, size=base.pos.shape)) for _ in range(FORCE_BATCH)]
    worst = {}
    for kind, spec in kinds.items():
        feature = pr._KIND_FEATURES[kind]
        mapping = (base.neighbor_lists["repulsion"] if kind == "repulsion"
                   else lists[feature]).index_mapping
        n = mapping.shape[1]
        params = {k: rng.uniform(v[0], v[1], (v[2], n) if len(v) > 2
                                 else n) for k, v in spec.items()}
        out = []
        for device in (dev, torch.device("cpu")):
            prior = pr.Prior(
                index_mapping=torch.as_tensor(mapping, dtype=torch.int64,
                                              device=device),
                params={k: torch.as_tensor(v, dtype=torch.float32,
                                           device=device)
                        for k, v in params.items()},
                kind=kind, name=kind, feature=feature)
            pos = collate(cfgs, device=device).pos.requires_grad_(True)
            e = pr.prior_energy(prior, pos)
            (g,) = torch.autograd.grad(e.sum(), pos)
            out.append((e.detach().cpu(), -g.cpu()))
        (e_k, f_k), (e_p, f_p) = out
        worst[kind] = max(float((e_k - e_p).abs().max() / e_p.abs().max()),
                          float((f_k - f_p).abs().max() / f_p.abs().max()))
    print(f"forces: the other prior kinds, batch {FORCE_BATCH}, card vs cpu, "
          f"max over energy and forces of max|d|/max|cpu|: "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (bound "
          f"{PRIOR_BOUND:.0e})")
    check(all(v <= PRIOR_BOUND for v in worst.values()),
          "a prior kind differs between the card and the CPU")


# ---------------------------------------------------------------------------
# The export loop: files, resume, the per-launch guard, the pair floor
# ---------------------------------------------------------------------------

def cli_config(name, tmp, out):
    """examples/<name>.yaml read and written by the port's own YAML code
    with model_file and structure_file (the checkpoint phase's files in
    ``tmp``), simulation.output_dir (``out``) and simulation.n_timesteps
    (CLI_STEPS) replaced, and nothing else; returns its path and the
    config."""
    from flashmd_tpu_torch.utils.io import dump_yaml, load_yaml

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_yaml(os.path.join(here, "examples", f"{name}.yaml"))
    cfg["model_file"] = os.path.join(tmp, "model_and_prior.pt")
    cfg["structure_file"] = os.path.join(tmp, "configurations.pt")
    cfg["simulation"]["output_dir"] = out
    cfg["simulation"]["n_timesteps"] = CLI_STEPS
    path = os.path.join(tmp, f"{os.path.basename(out)}.yaml")
    dump_yaml(path, cfg)
    return path, cfg


class _Messages(logging.Handler):
    """Keeps the messages of the port's logger."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def cli_run(main, path, *args):
    """A console entry point's ``main`` as the command line runs it
    (sys.argv: --config ``path`` and ``args``), with every kernel counter
    and every cheb twin call counted over the whole call (the checkpoint's
    binding included: its frontier evaluates its candidates on the cheb
    kernels), the frontier's reports, the port's log messages, the
    seconds from the call to the run's first step (YAML, load, frontier,
    fit, attach) and of the run, and the peak device memory."""
    from flashmd_tpu_torch.simulation import base

    log, messages = FrontierLog(), _Messages()
    frontier_logger = logging.getLogger("flashmd_tpu_torch.models.frontier")
    frontier_logger.addHandler(log)
    frontier_logger.setLevel(logging.INFO)
    port_logger = logging.getLogger("flashmd_tpu_torch")
    port_logger.addHandler(messages)
    simulate, marks = base.Simulation.simulate, {}

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        marks["run"] = time.perf_counter()
        return simulate(self, *a, **kw)

    argv = sys.argv
    sys.argv = [main.__name__, "--config", path, *args]
    base.Simulation.simulate = timed
    try:
        with counting_twins() as twins:
            AllKernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = main()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = AllKernels.launch_counts()
            twins = dict(twins)
    finally:
        sys.argv = argv
        base.Simulation.simulate = simulate
        frontier_logger.removeHandler(log)
        port_logger.removeHandler(messages)
    return {"sim": sim, "counts": counts, "twins": twins,
            "candidates": sum(len(r.errors) for r in log.reports),
            "messages": messages.messages, "attach": marks["run"] - t0,
            "run": t1 - marks["run"], "peak": torch.cuda.max_memory_allocated()}


def cli_expect(r, steps):
    """Every kernel counter over a cheb run of ``steps`` steps through the
    command line: 3/2/1 per force evaluation, one evaluation per step, one
    for the start and one per frontier candidate; every other counter 0."""
    return {**AllKernels.zeros(), **cheb_counts(steps + 1 + r["candidates"])}


def cli_line(label, r, smi):
    sim = r["sim"]
    cfg = sim.model.schnet_config
    m = sim.get_throughput_metrics()
    print(f"cli: {label}: {cfg.message_passing} {cfg.precision} "
          f"{cheb_orders(cfg)} d_min "
          f"{cfg.cheb_d_min}, batch {sim.n_sims}, {sim.n_timesteps} steps; "
          f"launches {r['counts']} ({r['candidates']} frontier candidates); "
          f"twin calls {r['twins']}; attach {r['attach']:.3f} s (YAML, "
          f"load, frontier, fit, collate), run {r['run']:.3f} s, second-half "
          f"throughput {m['throughput']:.1f} timestep*mol/s "
          f"({m['ms_per_timestep']:.3f} ms/step), peak device memory "
          f"{r['peak'] / 2 ** 30:.3f} GiB on {smi}")


def phase_cli(tmp, dev, smi):
    """The cli phase (the module docstring's)."""
    from flashmd_tpu_torch.models import checkpoint_io as cio
    from flashmd_tpu_torch.simulation import scripts
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
    from flashmd_tpu_torch.utils.io import load_yaml

    # langevin: examples/langevin.yaml as it is
    out = os.path.join(tmp, "langevin")
    path, cfg = cli_config("langevin", tmp, out)
    r = cli_run(scripts.nvt_langevin_main, path, "--batch_size", str(BATCH))
    sim, opts = r["sim"], cfg["simulation"]
    steps, save, name = (opts["n_timesteps"], opts["save_interval"],
                         opts["filename"])
    cli_line("langevin", r, smi)
    check(r["counts"] == cli_expect(r, steps),
          f"cli: langevin: launches differ from {cli_expect(r, steps)}")
    check(not any(r["twins"].values()), "cli: langevin: twins ran")
    n_exports = steps // opts["export_interval"]
    kinds = (["coords"] + ["forces"] * opts["save_forces"]
             + ["potential", "kineticenergy"] * opts["save_energies"])
    names = {f"{name}_{kind}_{i:04d}.npy" for i in range(n_exports)
             for kind in kinds}
    names |= {f"{name}_checkpoint_{i:04d}.npz" for i in range(n_exports)}
    names |= {f"{name}_{tail}" for tail in (
        "checkpoint_init.npz", "log.txt", "config.yaml",
        "specialized_model_and_config.pkl")}
    found = set(os.listdir(out))
    coords = sim.coords
    echo = load_yaml(os.path.join(out, f"{name}_config.yaml"))
    parsed = {**cfg, "batch_size": BATCH, "profile": ""}
    print(f"cli: langevin: {len(found)} files, the expected "
          f"{len(names)} {found == names}; coordinates {coords.shape} "
          f"finite {bool(np.isfinite(coords).all())}; the echo read back "
          f"equals the parsed config {echo == parsed}")
    check(found == names, f"cli: langevin: files {sorted(found ^ names)}")
    check(coords.shape == (BATCH, steps // save, N_ATOMS, 3)
          and np.isfinite(coords).all(), "cli: langevin: coordinates")
    check(echo == parsed, f"cli: langevin: echo {echo} != {parsed}")

    # the engine driven directly with the same options and binding
    ref = cio.load_reference_checkpoint(cfg["model_file"])
    structures = cio.load_reference_configurations(cfg["structure_file"])
    ff = cio.build_forcefield(ref, structures[0], optimize=True,
                              allow_missing_priors=False,
                              tune_configurations=structures, device=dev)
    direct = LangevinSimulation(**{**opts, "output_dir": out + "_direct",
                                   "device": dev})
    direct.attach_model_and_configurations(ff, structures, cfg["betas"][0])
    direct.simulate()
    same = (torch.equal(direct.final_carry["pos"], sim.final_carry["pos"])
            and np.array_equal(direct.coords, coords))
    print(f"cli: langevin: final positions and every saved frame bitwise "
          f"those of the engine driven directly (build_forcefield(optimize="
          f"True, tune_configurations=the {len(structures)} structures) "
          f"and LangevinSimulation with the YAML's options): {same}")
    check(same, "cli: langevin: the command line changed the trajectory")

    # pt: examples/parallel_tempering.yaml, PT_INDEP structures x 3 betas
    out = os.path.join(tmp, "pt")
    path, cfg = cli_config("parallel_tempering", tmp, out)
    r = cli_run(scripts.nvt_pt_langevin_main, path, "--batch_size",
                str(PT_INDEP))
    sim, opts = r["sim"], cfg["simulation"]
    steps, name = opts["n_timesteps"], opts["filename"]
    cli_line("pt", r, smi)
    acc = sum(np.load(os.path.join(out, f"{name}_acceptance_{i:04d}.npy"))
              for i in range(steps // opts["export_interval"]))
    cum = sim.final_carry["acceptance_matrix"].cpu().numpy()
    attempted = int(sim.final_carry["n_exchange_attempted"])
    approved = int(sim.final_carry["n_exchange_approved"])
    coords = sim.coords
    print(f"cli: pt: {sim.n_sims} slots, exchange every "
          f"{opts['exchange_interval']}: {attempted} attempts, rate "
          f"{approved / max(attempted, 1):.4f}; acceptance npys sum to the "
          f"matrix {np.array_equal(acc, cum)}; coordinates {coords.shape} "
          f"finite {bool(np.isfinite(coords).all())}")
    check(r["counts"] == cli_expect(r, steps)
          and not any(r["twins"].values()), "cli: pt: launches or twins")
    check(np.array_equal(acc, cum) and attempted > 0,
          "cli: pt: the acceptance files do not sum to the matrix")
    check(sim.n_sims == PT_INDEP * len(cfg["betas"])
          and np.isfinite(coords).all(), "cli: pt: coordinates")

    # nve: the Langevin example through the NVE entry point, cut short;
    # its friction is not an option of NVE
    out = os.path.join(tmp, "nve")
    path, cfg = cli_config("langevin", tmp, out)
    r = cli_run(scripts.nve_verlet_main, path, "--batch_size", str(BATCH),
                "--simulation.n_timesteps", str(CLI_NVE_STEPS),
                "--simulation.save_energies", "true")
    sim = r["sim"]
    cli_line("nve", r, smi)
    warned = any("Ignoring unknown simulation options" in m
                 and "friction" in m for m in r["messages"])
    energies = (np.isfinite(sim.simulated_potential).all()
                and np.isfinite(sim.simulated_kinetic_energies).all())
    print(f"cli: nve: friction warned as unknown {warned}; potential and "
          f"kinetic energies finite {bool(energies)}")
    check(r["counts"] == cli_expect(r, CLI_NVE_STEPS)
          and not any(r["twins"].values()), "cli: nve: launches or twins")
    check(warned and energies, "cli: nve: warning or energies")

    # --disable_optim: the exact fp32 xla field, no kernel, gptq None
    out = os.path.join(tmp, "disable_optim")
    path, cfg = cli_config("langevin", tmp, out)
    r = cli_run(scripts.nvt_langevin_main, path, "--batch_size", str(BATCH),
                "--disable_optim", "--simulation.n_timesteps",
                str(CLI_OFF_STEPS))
    sim = r["sim"]
    cfg_off = sim.model.schnet_config
    m = sim.get_throughput_metrics()
    finite = bool(np.isfinite(sim.coords).all())
    print(f"cli: disable_optim: {cfg_off.message_passing} "
          f"{cfg_off.precision}, gptq {sim.gptq}, {CLI_OFF_STEPS} steps "
          f"batch {sim.n_sims}: every kernel counter 0 "
          f"{r['counts'] == AllKernels.zeros()}, finite {finite}; attach "
          f"{r['attach']:.3f} s, second-half throughput "
          f"{m['throughput']:.1f} timestep*mol/s, peak device memory "
          f"{r['peak'] / 2 ** 30:.3f} GiB")
    check((cfg_off.message_passing, cfg_off.precision, sim.gptq)
          == ("xla", "fp32", None) and r["candidates"] == 0,
          f"cli: disable_optim: {cfg_off}, gptq {sim.gptq}")
    check(r["counts"] == AllKernels.zeros() and finite,
          "cli: disable_optim: a kernel ran or positions not finite")


class _Timed:
    """Host seconds spent in a simulation's fetches (waiting for a
    launch's copy) and writes (``_export_segment``), per call."""

    def __init__(self, sim):
        from flashmd_tpu_torch.simulation import base

        self.fetch, self.write = [], []
        timed = self

        class Copy(base.HostCopy):
            def result(self):
                t0 = time.perf_counter()
                out = super().result()
                timed.fetch.append(time.perf_counter() - t0)
                return out

        export = sim._export_segment

        def write(*args):
            t0 = time.perf_counter()
            export(*args)
            timed.write.append(time.perf_counter() - t0)

        self._base, self._orig = base, base.HostCopy
        base.HostCopy = Copy
        sim._export_segment = write

    def close(self):
        self._base.HostCopy = self._orig


def phase_export(ff, cfgs, dev, smi):
    """bench.py's corroboration run with files (A) and without (B), A, B
    in EXPORT_PAIRS pairs: throughputs, each pair's ratio and the ratio of
    the medians, ms per launch fetched and written;
    gates: the file names, their (S, frames, ...) shapes and dtypes, the
    coordinates bitwise those of the run without files, launches 3/2/1
    per force evaluation. Then COMPONENT_STEPS with every energy
    component, the SchNet force component and the shape log: one more
    force evaluation's launches per save point, the components summing to
    the potential."""
    import tempfile

    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    n_frames = EXPORT_STEPS // EXPORT_SAVE
    per_file = n_frames * EXPORT_INTERVAL // EXPORT_STEPS
    expect = cheb_counts(EXPORT_STEPS + 1)
    names = {"bench_log.txt", "bench_specialized_model_and_config.pkl"}
    for i in range(EXPORT_STEPS // EXPORT_INTERVAL):
        names |= {f"bench_{k}_{i:04d}.npy" for k in (
            "coords", "forces", "potential", "kineticenergy")}
    tps = {"files": [], "none": []}
    with tempfile.TemporaryDirectory() as td:
        coords = {}
        for i, tag in enumerate(("files", "none") * EXPORT_PAIRS):
            out = os.path.join(td, str(i))
            kw = (dict(filename="bench", output_dir=out,
                       export_interval=EXPORT_INTERVAL)
                  if tag == "files" else {})
            sim = LangevinSimulation(
                dt=0.004, friction=1.0, n_timesteps=EXPORT_STEPS,
                save_interval=EXPORT_SAVE, save_forces=True,
                save_energies=True, random_seed=103838, neighbor_skin=1.0,
                neighbor_rebuild_interval=EXPORT_REBUILD, device=dev, **kw)
            sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
            timed = _Timed(sim)
            ck.reset_launch_counts()
            try:
                sim.simulate()
            finally:
                timed.close()
            counts = ck.launch_counts()
            tp = sim.get_throughput_metrics()["throughput"]
            tps[tag].append(tp)
            print(f"export: run {i + 1} ({'with' if kw else 'without'} "
                  f"files): {EXPORT_STEPS} steps batch {sim.n_sims}, "
                  f"second-half throughput {tp:.1f} timestep*mol/s; "
                  f"launches {counts == expect} ({counts['cheb_fwd']}/"
                  f"{counts['cheb_bwd_gx']}/{counts['cheb_bwd_gd']}); per "
                  f"launch fetch {1e3 * np.mean(timed.fetch):.3f} ms, write "
                  f"{1e3 * np.mean(timed.write):.3f} ms "
                  f"({len(timed.fetch)} launches)")
            check(counts == expect, f"export: launch counts differ from "
                  f"{expect}")
            coords.setdefault(tag, sim.coords)
            if not kw:
                continue
            found = set(os.listdir(out))
            check(found == names, f"export: files {sorted(found)}")
            ok = True
            for kind, tail in (("coords", (N_ATOMS, 3)),
                               ("forces", (N_ATOMS, 3)), ("potential", ()),
                               ("kineticenergy", ())):
                for j in range(EXPORT_STEPS // EXPORT_INTERVAL):
                    a = np.load(os.path.join(out, f"bench_{kind}_{j:04d}.npy"))
                    ok &= (a.shape == (BATCH, per_file) + tail
                           and a.dtype == np.float32)
            check(ok, "export: npy shapes or dtypes")
            files = np.concatenate(
                [np.load(os.path.join(out, f"bench_coords_{j:04d}.npy"))
                 for j in range(EXPORT_STEPS // EXPORT_INTERVAL)], axis=1)
            check(np.array_equal(files, sim.coords),
                  "export: files differ from the run's frames")
        same = np.array_equal(coords["files"], coords["none"])
        print(f"export: {len(names)} files {sorted(names)}; shapes (S, "
              f"frames, ...) = ({BATCH}, {per_file}, ...) float32; "
              f"coordinates bitwise those of the run without files: {same}")
        check(same, "export: the files change the trajectory")
        files_tp, none_tp = np.median(tps["files"]), np.median(tps["none"])
        pairs = [a / b for a, b in zip(tps["files"], tps["none"])]
        print(f"export: throughput with files "
              f"{', '.join(f'{t:.1f}' for t in tps['files'])}; without "
              f"{', '.join(f'{t:.1f}' for t in tps['none'])}; pair ratios "
              f"{', '.join(f'{r:.4f}' for r in pairs)}; ratio of the "
              f"medians {files_tp / none_tp:.4f} on {smi}")

        out = os.path.join(td, "components")
        names = ["SchNet", "bonds", "angles", "dihedrals", "repulsion"]
        sim = LangevinSimulation(
            dt=0.004, friction=1.0, n_timesteps=COMPONENT_STEPS,
            save_interval=COMPONENT_STEPS // 2, random_seed=103838,
            save_energies=True, save_energy_components=True,
            energy_components=names, save_force_components=True,
            force_components=["SchNet"], print_shape=True, filename="c",
            output_dir=out, export_interval=COMPONENT_STEPS, device=dev)
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
        ck.reset_launch_counts()
        sim.simulate()
        counts = ck.launch_counts()
        expect = cheb_counts(COMPONENT_STEPS + 1 + 2)
        energies = np.load(os.path.join(out, "c_energy_components_0000.npz"))
        total = sum(energies[k].astype(np.float64) for k in names)
        pot = np.load(os.path.join(out, "c_potential_0000.npy"))
        rel = float(np.abs(total - pot).max() / np.abs(pot).max())
        forces = np.load(os.path.join(out, "c_force_components_0000.npz"))
        log = open(os.path.join(out, "c_print_shape.log")).read()
        print(f"components: {COMPONENT_STEPS} steps, 2 save points: launches "
              f"{counts['cheb_fwd']}/{counts['cheb_bwd_gx']}/"
              f"{counts['cheb_bwd_gd']} (steps + 1 + one evaluation per save "
              f"point: {counts == expect}); sum of the energy components vs "
              f"the potential {rel:.3e}; SchNet force component "
              f"{forces['SchNet'].shape}; shape log {len(log.splitlines())} "
              "lines")
        check(counts == expect, f"components: launch counts != {expect}")
        check(rel <= 1e-5, "components: they do not sum to the potential")
        check(forces["SchNet"].shape == (BATCH, 2, N_ATOMS, 3)
              and "frame outputs" in log, "components: files")


def phase_resume(ff, cfgs, dev):
    """2 N steps straight and N steps plus a resume to 2 N from the
    checkpoint, on the cheb slice and on PT at 126 slots: the frames
    bitwise equal (the generator's state restored); PT's acceptance npys
    sum to its cumulative matrix."""
    import tempfile

    from flashmd_tpu_torch.simulation import PTSimulation
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    pt_ff, pt_cfgs = _force_fields(dev, PT_INDEP)
    cases = (("cheb", LangevinSimulation, ff, cfgs, 1.67, {}),
             ("pt", PTSimulation, pt_ff, pt_cfgs, PT_BETAS,
              dict(exchange_interval=RESUME_EXCHANGE)))
    with tempfile.TemporaryDirectory() as td:
        for label, cls, field, structures, beta, extra in cases:
            sims = {}
            for tag, steps, more in (("a", 2 * RESUME_N, {}),
                                     ("b", RESUME_N, {}),
                                     ("b", 2 * RESUME_N,
                                      dict(read_checkpoint_file=True))):
                sim = cls(dt=0.004, friction=1.0, n_timesteps=steps,
                          save_interval=RESUME_SAVE,
                          export_interval=RESUME_N, create_checkpoints=True,
                          filename=label, output_dir=os.path.join(td, tag),
                          random_seed=103838, device=dev, **extra, **more)
                sim.attach_model_and_configurations(field, structures, beta)
                sim.simulate()
                sims[tag, steps] = sim
            a, b = sims["a", 2 * RESUME_N], sims["b", 2 * RESUME_N]
            half = RESUME_N // RESUME_SAVE
            same = (np.array_equal(a.simulated_coords[half:],
                                   b.simulated_coords)
                    and np.array_equal(a.simulated_coords[:half],
                                       sims["b", RESUME_N].simulated_coords))
            line = (f"resume: {label}: {2 * RESUME_N} steps straight vs "
                    f"{RESUME_N} + a resume to {2 * RESUME_N} at batch "
                    f"{a.n_sims}: frames bitwise equal {same}")
            if label == "pt":
                acc = [np.load(os.path.join(td, "a", f"pt_acceptance_{j:04d}"
                                            ".npy")) for j in range(2)]
                cum = a.final_carry["acceptance_matrix"].cpu().numpy()
                summed = np.array_equal(acc[0] + acc[1], cum)
                resumed = np.array_equal(
                    acc[1], np.load(os.path.join(td, "b",
                                                 "pt_acceptance_0001.npy")))
                counters = all(torch.equal(a.final_carry[k],
                                           b.final_carry[k])
                               for k in ("n_exchange_attempted",
                                         "n_exchange_approved"))
                line += (f"; acceptance npys sum to the cumulative matrix "
                         f"{summed} ({int(cum.sum())} attempts), the resumed "
                         f"run's second npy equal {resumed}, counters equal "
                         f"{counters}")
                same = same and summed and resumed and counters
            print(line)
            check(same, f"resume: {label}: the resumed run differs")


def phase_guard(dev):
    """The dense fp32 field at GUARD_DT blows up; the run raises at the
    launch after the blow-up's (launches of GUARD_LAUNCH_STEPS), not at
    its end."""
    from flashmd_tpu_torch.simulation import NVESimulation

    ff, cfgs = _force_fields(dev, BATCH, message_passing="dense",
                             precision="fp32")
    sim = NVESimulation(dt=GUARD_DT, n_timesteps=GUARD_MAX_STEPS,
                        save_interval=GUARD_LAUNCH_STEPS,
                        max_steps_per_launch=GUARD_LAUNCH_STEPS,
                        random_seed=103838, device=dev, gptq=None)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    starts = []
    launch = sim._launch

    def counted(carry, gen, step, n_frames, halfway):
        starts.append(step)
        return launch(carry, gen, step, n_frames, halfway)

    sim._launch = counted
    blew = None
    try:
        sim.simulate()
    except RuntimeError as err:
        m = re.search(r"blew up at #timestep=(\d+)", str(err))
        blew = None if m is None else int(m.group(1))
    # pipelined: the launch after the blow-up's is the last dispatched
    within = blew is not None and max(starts) <= blew
    print(f"guard: dense fp32 NVE at dt {GUARD_DT}, launches of "
          f"{GUARD_LAUNCH_STEPS} steps over {GUARD_MAX_STEPS}: raised at "
          f"#timestep={blew}; launches dispatched {len(starts)} (last from "
          f"step {max(starts)}): within one launch of the blow-up {within}")
    check(within, "guard: the blow-up was not raised within one launch")


def phase_pair_floor(ff, cfgs, dev, smi):
    """benchmarks/pair_floor_traj.py's protocol on the port's zoo weights:
    the smallest pair distance at the save points and its step, beside
    the reference's record. Measured, not gated (the guard warns)."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.simulation.langevin import LangevinSimulation

    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=FLOOR_STEPS,
                             save_interval=FLOOR_SAVE,
                             max_steps_per_launch=FLOOR_LAUNCH,
                             random_seed=103838, device=dev)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    ck.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim.simulate()
    counts = ck.launch_counts()
    d = sim.simulated_frames["pair_d_min"]
    k = int(np.argmin(d))
    floor_warned = sum("fit-domain floor" in str(w.message) for w in caught)
    tp = sim.get_throughput_metrics()
    print(f"pair floor: {FLOOR_STEPS} steps, batch {sim.n_sims}, saved every "
          f"{FLOOR_SAVE}, launches of {FLOOR_LAUNCH} steps: smallest pair "
          f"distance at the save points {float(d[k]):.4f} A at step "
          f"{(k + 1) * FLOOR_SAVE} (the reference's record "
          f"{FLOOR_REFERENCE} A; cheb_d_min "
          f"{sim.model.schnet_config.cheb_d_min}); frames below d_min "
          f"{int((d < sim.model.schnet_config.cheb_d_min).sum())} of "
          f"{d.size}; warnings {floor_warned} (one per launch that "
          f"crossed); launches {counts == cheb_counts(FLOOR_STEPS + 1)}; "
          f"second-half throughput {tp['throughput']:.1f} timestep*mol/s "
          f"({tp['ms_per_timestep']:.3f} ms/step) on {smi}")
    check(counts == cheb_counts(FLOOR_STEPS + 1),
          "pair floor: launch counts")
    check(bool(np.isfinite(sim.simulated_coords).all()),
          "pair floor: non-finite positions")


def kinetic_per_dof(sim, slots=slice(None)):
    """Mean kinetic energy per degree of freedom over the second half of
    the save points, over ``slots``."""
    ke = sim.simulated_kinetic_energies
    return float(ke[ke.shape[0] // 2:, slots].mean()) / (3 * sim.n_atoms)


# ---------------------------------------------------------------------------
# Mixed-size batches
# ---------------------------------------------------------------------------

def mixed_fields(device, half, message_passing="cheb", **kw):
    """(per-molecule fields, configurations) of benchmarks/run_all.py:
    _cfg_mixed: ``half`` copies each of the zoo's MIXED_SIZES molecules
    (seed 0, MIXED_ORDERS, the shared network), the smaller first, on the
    Chebyshev path unless another is named."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    ffs, cfgs = [], []
    for a in MIXED_SIZES:
        ff, c = cgschnet_1enh_like(n_atoms=a, batch_size=1, device=device,
                                   message_passing=message_passing,
                                   **MIXED_ORDERS, **kw)
        ffs += [ff] * half
        cfgs += c * half
    return ffs, cfgs


def _with_fit(ff):
    from flashmd_tpu_torch.models.cheb import attach_cheb_fit

    if ff.schnet_config.message_passing != "cheb":
        return ff
    return ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                    ff.schnet_config))


def _mixed_forces(ffs, cfgs, device):
    """compute_energy_forces of the stacked field on the padded batch:
    (energies, forces, the padded System)."""
    from flashmd_tpu_torch.data.system import collate_padded
    from flashmd_tpu_torch.models.forcefield import (
        compute_energy_forces,
        stack_forcefields,
    )

    sys_ = collate_padded(cfgs, beta=1.67, device=device)
    e, f, _ = compute_energy_forces(_with_fit(stack_forcefields(ffs)),
                                    sys_.pos, sys_.atom_types,
                                    atom_mask=sys_.atom_mask)
    return e.cpu(), f.cpu(), sys_


def padded_rows(sys_):
    """[S, A] bool of the padded atoms, on the host."""
    return sys_.atom_mask.cpu().numpy() == 0


def phase_mixed_forces(dev):
    """Forces of a mixed batch (2 x 266 + 2 x 532, padded to 532) on the
    run's shared weights: card vs CPU plain on cheb, pallas, dense (bf16)
    and xla (every counter 0), the padded rows' forces exactly 0 on the
    card; at fp32 each molecule's rows against its own homogeneous
    evaluation on the card."""
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    t0 = time.perf_counter()
    for mp in ("cheb", "pallas", "dense", "xla"):
        ffs, cfgs = mixed_fields(dev, 2, message_passing=mp)
        AllKernels.reset_launch_counts()
        e_k, f_k, sys_ = _mixed_forces(ffs, cfgs, dev)
        counts = AllKernels.launch_counts()
        ffs, cfgs = mixed_fields("cpu", 2, message_passing=mp)
        e_p, f_p, _ = _mixed_forces(ffs, cfgs, "cpu")
        pad = padded_rows(sys_)
        check(bool(torch.isfinite(f_k).all()),
              f"mixed forces {mp}: non-finite on the card")
        f_rel = float((f_k - f_p).abs().max() / f_p.abs().max())
        e_rel = float((e_k - e_p).abs().max() / e_p.abs().max())
        zero = bool((f_k[torch.from_numpy(pad)] == 0).all())
        print(f"mixed forces: {mp} bf16 batch 4 ({' + '.join(f'2 x {a}' for a in MIXED_SIZES)}, "
              f"padded to {sys_.n_atoms}) card vs cpu plain: max|dF|/max|F| "
              f"= {f_rel:.3e}, max|dE|/max|E| = {e_rel:.3e} (bound "
              f"{FORCE_BOUND:.0e}); the {int(pad.sum())} padded rows' forces "
              f"exactly 0 on the card: {zero}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        check(f_rel <= FORCE_BOUND and e_rel <= FORCE_BOUND,
              f"mixed forces {mp}: card and CPU disagree")
        check(zero, f"mixed forces {mp}: a padded row's force is not 0")
        if mp == "xla":
            check(counts == AllKernels.zeros(),
                  f"mixed forces xla launched kernels: {counts}")
    for mp in ("cheb", "pallas", "dense"):
        ffs, cfgs = mixed_fields(dev, 2, message_passing=mp,
                                 precision="fp32")
        _, f, _ = _mixed_forces(ffs, cfgs, dev)
        worst = 0.0
        for s, (ff, cfg) in enumerate(zip(ffs, cfgs)):
            one = collate([cfg], device=dev)
            _, f1, _ = compute_energy_forces(_with_fit(ff), one.pos,
                                             one.atom_types)
            f1 = f1[0].cpu()
            worst = max(worst, float((f[s, :cfg.n_atoms] - f1).abs().max()
                                     / f1.abs().max()))
        print(f"mixed forces: {mp} fp32 each molecule's rows vs its own "
              f"homogeneous evaluation on the card: max|dF|/max|F| = "
              f"{worst:.3e} (bound {CROSS_BOUND:.0e})")
        check(worst <= CROSS_BOUND,
              f"mixed forces {mp} fp32: mixed and homogeneous disagree")
    print(f"mixed forces: {time.perf_counter() - t0:.1f} s")


def frozen_padding(sim, label):
    """Gate: every saved frame's padded rows bitwise the initial ladder,
    and every molecule's real atoms moved; returns the smallest real-atom
    displacement over the run."""
    coords = sim.coords  # [S, frames, A, 3]
    start = sim.initial_system.pos.cpu().numpy()
    pad = padded_rows(sim.initial_system)
    frozen = all(np.array_equal(coords[s][:, pad[s]],
                                np.broadcast_to(start[s][pad[s]],
                                                coords[s][:, pad[s]].shape))
                 for s in range(coords.shape[0]))
    moved = min(float(np.abs(coords[s, -1][~pad[s]]
                             - start[s][~pad[s]]).max())
                for s in range(coords.shape[0]))
    print(f"{label}: padded rows ({int(pad.sum())}) of every frame bitwise "
          f"the initial ladder: {frozen}; the least moved molecule's "
          f"largest real-atom displacement {moved:.4f} A")
    check(frozen, f"{label}: a padded row moved")
    check(moved > 0, f"{label}: a molecule's real atoms did not move")
    return moved


def phase_mixed(dev, smi):
    """benchmarks/run_all.py:_cfg_mixed through LangevinSimulation with a
    list of fields (gptq None): launches 3/2/1 per force evaluation, no
    twin call, padding frozen, the atom mask file; throughput, a profiler
    window, the three stacked cheb kernels at S = 32, A = 532 against
    their twins, and the padding overhead against the same molecules in
    two homogeneous batches. Then the neighbour-matrix kernels on the
    same batch (MIXED_PALLAS_STEPS steps, the list rebuilt every step)."""
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    t0 = time.perf_counter()
    ffs, cfgs = mixed_fields(dev, MIXED_HALF)
    n_evals = STEPS + 1
    expect = {**AllKernels.zeros(), **cheb_counts(n_evals)}
    with tempfile.TemporaryDirectory() as out, counting_twins() as twins:
        _, ms_mixed, sim = run_slice(
            "mixed", ffs, cfgs, dev, STEPS, SAVE_INTERVAL, AllKernels,
            expect, smi, gptq=None, filename="mixed", output_dir=out)
        mask = np.load(os.path.join(out, "mixed_atom_mask.npy"))
    system = sim.initial_system
    cfg = sim.model.schnet_config
    print(f"mixed: {MIXED_HALF} x {MIXED_SIZES[0]} + {MIXED_HALF} x "
          f"{MIXED_SIZES[1]} beads padded to {system.n_atoms}, cheb "
          f"{cfg.precision} {cheb_orders(cfg)} on "
          f"d_min {cfg.cheb_d_min}; twin calls {twins}; mixed_atom_mask.npy "
          f"{mask.shape} {mask.dtype} equal to the system's mask: "
          f"{np.array_equal(mask, system.atom_mask.cpu().numpy())}")
    check(not any(twins.values()), f"mixed: twin calls {twins}")
    check(np.array_equal(mask, system.atom_mask.cpu().numpy()),
          "mixed: the atom mask file differs from the system's mask")
    frozen_padding(sim, "mixed")
    tp = sim.get_throughput_metrics()["throughput"]
    profile_steps(sim, dev, PROFILE_STEPS, "mixed")
    t1 = time.perf_counter()
    phase_cheb_kernels(sim.model, system.pos, dev, tag=" mixed",
                       stacked_only=True)
    t_kernels = time.perf_counter() - t1
    # the same molecules as two homogeneous batches on the same fit
    ms = {}
    for i, a in enumerate(MIXED_SIZES):
        part = slice(i * MIXED_HALF, (i + 1) * MIXED_HALF)
        _, ms[a], _ = run_slice(
            f"mixed homogeneous {a}", ffs[part.start], cfgs[part], dev,
            STEPS, SAVE_INTERVAL, AllKernels, expect, smi, gptq=None)
    two = sum(ms.values())
    print(f"mixed: padding overhead: the mixed batch {ms_mixed:.3f} ms/step "
          f"({tp:.1f} timestep*mol/s) against the same {2 * MIXED_HALF} "
          f"molecules in two homogeneous batches "
          + " + ".join(f"{ms[a]:.3f} ({a})" for a in MIXED_SIZES)
          + f" = {two:.3f} ms/step ({2 * MIXED_HALF * 1e3 / two:.1f} "
          f"timestep*mol/s): mixed / two batches throughput "
          f"{two / ms_mixed:.4f} on {smi}")
    # the neighbour-matrix kernels: the padded atoms' rows are empty
    n = MIXED_PALLAS_STEPS + 1
    ffs_p, cfgs_p = mixed_fields(dev, MIXED_HALF, message_passing="pallas")
    counts, _, sim = run_slice(
        "mixed pallas", ffs_p, cfgs_p, dev, MIXED_PALLAS_STEPS,
        MIXED_PALLAS_STEPS // 2, AllKernels,
        {**AllKernels.zeros(), "cfconv_fwd": 3 * n, "cfconv_bwd": 3 * n},
        smi, gptq=None)
    frozen_padding(sim, "mixed pallas")
    n_max = int(sim.final_carry["nbr_n_max"])
    cap = sim.model.neighbor_capacity
    print(f"mixed pallas: K {cap} (the larger molecule's), n_max over the "
          f"run {n_max}; rows without a neighbour (the padding) "
          f"{int(padded_rows(sim.initial_system).sum())}")
    check(n_max <= cap, f"mixed pallas: n_max {n_max} > K {cap}")
    print(f"mixed: {time.perf_counter() - t0:.1f} s, of which the kernel "
          f"comparisons {t_kernels:.1f} s")


# ---------------------------------------------------------------------------
# Host utilities and replica sharding
# ---------------------------------------------------------------------------

def host_ms(fn, repeats=5):
    """Median host milliseconds of ``fn()`` over ``repeats`` calls, and its
    last result."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def chain_geometry(coords):
    """Bond lengths, bend angles (rad) and dihedrals (rad) along each
    chain of ``coords`` [..., A, 3], flattened, in float64."""
    x = np.asarray(coords, dtype=np.float64)
    b = x[..., 1:, :] - x[..., :-1, :]
    bonds = np.linalg.norm(b, axis=-1)
    u, v = b[..., :-1, :], b[..., 1:, :]
    cos = np.sum(-u * v, -1) / (np.linalg.norm(u, axis=-1)
                                * np.linalg.norm(v, axis=-1))
    angles = np.arccos(np.clip(cos, -1.0, 1.0))
    b1, b2, b3 = b[..., :-2, :], b[..., 1:-1, :], b[..., 2:, :]
    n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
    m1 = np.cross(n1, b2 / np.linalg.norm(b2, axis=-1, keepdims=True))
    dihedrals = np.arctan2(np.sum(m1 * n2, -1), np.sum(n1 * n2, -1))
    return bonds.ravel(), angles.ravel(), dihedrals.ravel()


def free_energy(values, bins, beta=1.67):
    """(populated bin centres, -ln p / beta) of a histogram of
    ``values``."""
    hist, edges = np.histogram(values, bins=bins, density=True)
    centres = 0.5 * (edges[1:] + edges[:-1])
    nz = hist > 0
    return centres[nz], -np.log(hist[nz]) / beta


def phase_host(ff, cfgs, dev, open_tp, smi):
    """The host utilities (ROADMAP A18) on the main path's field: the
    radius engine built from radius.cpp and held against its numpy twin on
    three inputs; the term list of the 266-bead start; the zoo's dense
    repulsion sparsified and densified back; the field with the term-list
    repulsion against the dense one; STEPS steps built from the package
    root's names with files, read back by utils.render.load_coords; the
    prior fits on the run's own histograms."""
    import flashmd_tpu_torch as fm
    from flashmd_tpu_torch import native
    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.ops import configuration2term_list
    from flashmd_tpu_torch.prior import fitting
    from flashmd_tpu_torch.prior import sparsify_repulsion
    from flashmd_tpu_torch.prior.priors import densify_repulsion
    from flashmd_tpu_torch.utils.render import load_coords

    t_phase = time.perf_counter()
    info = native.build(force=True)
    print(f"host: radius engine: g++ {' '.join(native._FLAGS)} radius.cpp "
          f"-> {info['path'].name} in {info['seconds']:.2f} s")
    rcut = ff.rcut + 1.0  # the capacity rule's search radius
    start = cfgs[0].pos
    big = cgschnet_1enh_like(n_atoms=MIXED_SIZES[1], batch_size=1,
                             device="cpu", **MIXED_ORDERS)[1][0].pos
    box = BOX * np.eye(3)
    inputs = [(f"{N_ATOMS}-bead start", start, None),
              (f"{MIXED_SIZES[1]}-bead start (_cfg_mixed)", big, None),
              (f"{N_ATOMS}-bead start folded into the cubic {BOX:g} A cell",
               np.mod(start, BOX), box)]
    for label, pos, cell in inputs:
        ms_n, counts = host_ms(lambda: native.neighbor_counts(pos, rcut,
                                                              cell))
        ms_p, twin = host_ms(lambda: native.neighbor_counts(
            pos, rcut, cell, native=False))
        same = np.array_equal(counts, twin)
        line = (f"host: neighbor_counts at {rcut:g} A, {label}: equal to "
                f"the numpy twin: {same} (max {int(counts.max())}); host "
                f"{ms_n:.3f} ms (engine) vs {ms_p:.3f} ms (numpy)")
        check(same, f"host: neighbor_counts differ from the twin ({label})")
        if cell is None:
            ms_n, pairs = host_ms(lambda: native.radius_pairs(pos, rcut))
            ms_p, twin = host_ms(lambda: native.radius_pairs(pos, rcut,
                                                             native=False))
            same = all(np.array_equal(a, b) for a, b in zip(pairs, twin))
            line += (f"; radius_pairs {len(pairs[0])} pairs equal: {same}, "
                     f"{ms_n:.3f} ms vs {ms_p:.3f} ms")
            check(same, f"host: radius_pairs differ from the twin ({label})")
        print(f"{line} on {smi} (host CPU)")
    terms = configuration2term_list(start, rcut)
    src, dst = native.radius_pairs(start, rcut, native=False)
    same = np.array_equal(terms.index_mapping, np.stack([src, dst]))
    print(f"host: configuration2term_list of the {N_ATOMS}-bead start at "
          f"{rcut:g} A: {terms.n_terms} terms, equal to the numpy pairs: "
          f"{same}")
    check(same, "host: the term list differs from the numpy pairs")
    dense = ff.priors["repulsion"]
    sparse = sparsify_repulsion(dense)
    back = densify_repulsion(sparse, N_ATOMS)
    same = torch.equal(back.params["sigma6"], dense.params["sigma6"])
    print(f"host: sparsify_repulsion of the zoo's dense repulsion: "
          f"{sparse.n_terms} terms on {sparse.params['sigma'].device}; "
          f"densified back bitwise: {same}")
    check(same, "host: sparsify/densify round trip is not bitwise")
    ff_sparse = ff.replace(priors={**ff.priors, "repulsion": sparse})
    sys_ = collate(cfgs, beta=1.67, device=dev)
    _, f_dense, _ = compute_energy_forces(ff, sys_.pos, sys_.atom_types)
    _, f_sparse, _ = compute_energy_forces(ff_sparse, sys_.pos,
                                           sys_.atom_types)
    rel = float((f_sparse - f_dense).abs().max() / f_dense.abs().max())
    print(f"host: forces with the term-list repulsion vs the dense one at "
          f"batch {BATCH} on the card: max|dF|/max|F| = {rel:.3e} (bound "
          f"{CROSS_BOUND:.0e})")
    check(rel <= CROSS_BOUND, "host: term-list and dense repulsion disagree")
    # the run, through the package root's names
    field = fm.ForceField(schnet_params=ff.schnet_params,
                          priors=ff_sparse.priors,
                          schnet_config=ff.schnet_config,
                          neighbor_capacity=ff.neighbor_capacity)
    structures = [fm.Configuration(pos=c.pos, atom_types=c.atom_types,
                                   masses=c.masses) for c in cfgs]
    with tempfile.TemporaryDirectory() as out, counting_twins() as twins:
        sim = fm.LangevinSimulation(
            friction=1.0, dt=0.004, n_timesteps=STEPS,
            save_interval=SAVE_INTERVAL, export_interval=STEPS // 2,
            random_seed=103838, device=dev, filename="host",
            output_dir=out)
        sim.attach_model_and_configurations(field, structures, 1.67)
        ck.reset_launch_counts()
        coords = sim.simulate()
        counts = ck.launch_counts()
        read = load_coords(os.path.join(out, "host"))
        n_files = sum(f.startswith("host_coords_") for f in os.listdir(out))
    expect = cheb_counts(STEPS + 1)
    tp = sim.get_throughput_metrics()["throughput"]
    finite = bool(np.isfinite(coords).all())
    same = np.array_equal(read, sim.coords)
    print(f"host: {STEPS} steps batch {sim.n_sims} from the package root's "
          f"names (fm.LangevinSimulation, fm.ForceField with the term-list "
          f"repulsion, fm.Configuration): finite={finite} launches={counts} "
          f"expected={expect}; twin calls {twins}; second-half throughput "
          f"{tp:.1f} timestep*mol/s beside the open cheb slice's "
          f"{open_tp:.1f} in this run (ratio {tp / open_tp:.4f}) on {smi}")
    print(f"host: utils.render.load_coords on the {n_files} coordinate "
          f"files: {read.shape}, equal to simulated_coords: {same}")
    check(finite and counts == expect, "host: the run's launches differ")
    check(not any(twins.values()), f"host: twin calls {twins}")
    check(same and n_files == 2, "host: load_coords differs from the run")
    # prior fits on the run's own histograms
    bonds, angles, dihedrals = chain_geometry(coords)
    last = np.asarray(coords[:8, -1], dtype=np.float64)
    far = []
    for pos in last:
        i, j = native.radius_pairs(pos, 6.0)
        keep = np.abs(i - j) > 3
        far.append(np.linalg.norm(pos[i[keep]] - pos[j[keep]], axis=-1))
    fits = [
        ("bonds harmonic", fitting.fit_harmonic_from_potential_estimates,
         free_energy(bonds, 100)),
        ("angles harmonic", fitting.fit_harmonic_from_potential_estimates,
         free_energy(angles, 100)),
        ("dihedrals fourier", fitting.fit_fourier_from_potential_estimates,
         free_energy(dihedrals, np.linspace(-np.pi, np.pi, 61))),
        ("non-bonded repulsion", fitting.fit_repulsion_from_values,
         (np.concatenate(far),)),
    ]
    for label, fn, args in fits:
        ms, stat = host_ms(lambda: fn(*args), repeats=3)
        flat = [v for x in stat.values()
                for v in (x.values() if isinstance(x, dict) else [x])]
        finite = all(np.isfinite(flat))
        shown = {k: (round(v, 5) if isinstance(v, float) else
                     {kk: round(vv, 5) for kk, vv in v.items()})
                 for k, v in stat.items()}
        print(f"host: fit {label} on the run's {len(args[0])} "
              f"{'samples' if len(args) == 1 else 'populated bins'}: "
              f"{shown}, finite={finite}; host {ms:.2f} ms")
        check(finite, f"host: the {label} fit is not finite")
    print(f"host: {time.perf_counter() - t_phase:.1f} s")


# The mesh phase's workers: torch.distributed.run with one rank per process
# (an NCCL group of one on this card; two gloo ranks sharing it), each
# running this file with --mesh-worker. The repeats of the timed calls, and
# the steps of each Langevin and PT run (STEPS before they were cut to keep
# the whole run inside half its time limit).
MESH_TIMED = 20
MESH_STEPS = 40
# Two ranks on one card over gloo with CUDA tensors, held to the JAX
# suite's PT bounds (tests/simulation/test_parallel.py:111).
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6


def mesh_worker(args):
    """One rank of the mesh phase. ``args``: the mode and the output
    directory. "nccl": one rank joins through mesh="auto" (NCCL); the
    batch-128 cheb Langevin slice and PT at _cfg_pt, each without a mesh
    and with mesh="auto" in this process, in turns. "gloo": the ranks
    join over gloo with CUDA tensors; PT sharded. "cards": NCCL over every
    card; the Langevin slice without a mesh (each rank on its card) and
    sharded, in turns. Rank 0 prints the lines and writes the results."""
    mode, out = args
    from flashmd_tpu_torch.ops import cheb_kernel as ck
    from flashmd_tpu_torch.parallel import mesh as mesh_mod
    from flashmd_tpu_torch.simulation import LangevinSimulation, PTSimulation

    sys.stdout.reconfigure(line_buffering=True)
    logging.getLogger("flashmd_tpu_torch").setLevel(logging.WARNING)
    if mode == "gloo":
        mesh_mod.initialize_distributed(backend="gloo")
    mesh = mesh_mod.as_mesh("auto")
    dev = mesh.device
    torch.cuda.set_device(dev)
    rank, size = mesh.rank, mesh.size
    tag = f"mesh: {mode} {size} rank{'s' if size > 1 else ''}"

    def say(msg):
        if rank == 0:
            print(f"{tag}: {msg}")

    def run(cls, ff, cfgs, beta, mesh_opt, **kw):
        kw = {"n_timesteps": MESH_STEPS, "save_interval": SAVE_INTERVAL,
              "random_seed": 103838, **kw}
        sim = cls(dt=0.004, device=dev, friction=1.0, mesh=mesh_opt, **kw)
        sim.attach_model_and_configurations(ff, cfgs, beta)
        ck.reset_launch_counts()
        sim.simulate()
        return sim, ck.launch_counts()

    def timed(fn, n=MESH_TIMED):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    results = {"size": size}
    workloads = {"nccl": ["langevin", "pt", "small"], "gloo": ["pt", "small"],
                 "cards": ["langevin"]}[mode]
    for name in workloads:
        if name == "langevin":
            ff, cfgs = _force_fields(dev, BATCH)
            cls, beta, kw = LangevinSimulation, 1.67, {}
        elif name == "pt":
            ff, cfgs = _force_fields(dev, PT_INDEP)
            cls, beta = PTSimulation, PT_BETAS
            kw = dict(exchange_interval=PT_EXCHANGE_INTERVAL)
        else:  # tests/test_torch_cuda.py's mesh case, at bf16
            from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

            ff, cfgs = cgschnet_1enh_like(n_atoms=64, batch_size=2,
                                          message_passing="cheb",
                                          device=dev)
            cls, beta = PTSimulation, [1.67, 1.5]
            kw = dict(exchange_interval=5, n_timesteps=40, save_interval=10,
                      random_seed=9)
        if mode != "gloo":
            # in turns: without, with, with, without
            runs = [run(cls, ff, cfgs, beta, m, **kw)
                    for m in (None, mesh, mesh, None)]
            ref = runs[0][0]
            sim, counts = runs[1]
            tps = [r[0].get_throughput_metrics()["throughput"]
                   for r in runs]
        else:
            ref = None
            sim, counts = run(cls, ff, cfgs, beta, mesh, **kw)
            tps = [sim.get_throughput_metrics()["throughput"]]
        expect = cheb_counts(sim.n_timesteps + 1)
        shown = {k: v for k, v in counts.items() if v}
        finite = bool(np.isfinite(sim.coords).all())
        say(f"{name}: {sim.n_timesteps} steps, {sim.n_sims} molecules, "
            f"{sim.initial_system.n_sims} on rank 0; launches {shown} "
            f"(expected {({k: v for k, v in expect.items() if v})}); finite "
            f"{finite}; second-half throughput "
            + (f"without / with / with / without a mesh, in turns: "
               + " / ".join(f"{t:.1f}" for t in tps)
               if ref is not None else f"{tps[0]:.1f}")
            + " timestep*mol/s")
        res = {"launches_ok": counts == expect, "finite": finite,
               "throughput": tps}
        if ref is not None and name != "small":
            same = all(
                np.array_equal(s.coords, ref.coords)
                and torch.equal(s.final_carry["pos"], ref.final_carry["pos"])
                and (name != "pt" or np.array_equal(
                    s.simulated_acceptance, ref.simulated_acceptance))
                for s, _ in runs[1:])
            dx = max(float(np.abs(s.coords - ref.coords).max())
                     for s, _ in runs[1:])
            res.update(bitwise=same, max_dx=dx)
            say(f"{name}: frames, final positions"
                + (" and acceptance" if name == "pt" else "")
                + f" of the three runs bitwise equal to the first run "
                  f"without a mesh: {same} (max|dx| {dx:.3e})")
        if name in ("pt", "small") and rank == 0:
            keep = ("acceptance_matrix", "n_exchange_approved",
                    "n_exchange_attempted")
            for label, r in (((mode, sim), ("ref", ref)) if ref is not None
                             else ((mode, sim),)):
                np.savez(os.path.join(out, f"{name}_{label}.npz"),
                         coords=r.coords, acceptance=r.simulated_acceptance,
                         **{k: r.final_carry[k].cpu().numpy() for k in keep})
        if name == "small":
            continue
        # the costs the mesh adds, per call, on this run's state
        gen = torch.Generator(device=dev).manual_seed(1)
        draw_ms = timed(lambda: sim._step_draws(gen, 0))
        carry = mesh_mod.shard_carry(sim.final_carry, mesh)
        frame = {k: v[None] for k, v in sim._frame_outputs(carry).items()}
        gather_ms = timed(lambda: sim._gather_frames(frame))
        res.update(draw_ms=draw_ms, gather_ms=gather_ms)
        say(f"{name}: the whole batch's normal draw "
            f"({sim.n_sims} x {sim.n_atoms} x 3 floats, of which this rank "
            f"keeps {sim.initial_system.n_sims} rows) {draw_ms:.4f} ms per "
            f"step; all-gather of one save point's frames "
            f"({', '.join(frame)}) {gather_ms:.4f} ms")
        if name == "pt":
            u = torch.rand(sim._subroutine_draw_shape(), generator=gen,
                           device=dev)
            ex_ms = timed(lambda: sim._device_subroutine(carry, u))
            res["exchange_ms"] = ex_ms
            say(f"pt: one exchange ({sim.n_sims} slots over {size} "
                f"rank{'s' if size > 1 else ''}, potentials all-gathered, "
                f"every per-slot entry moved) {ex_ms:.4f} ms")
        results[name] = res
    if rank == 0:
        with open(os.path.join(out, f"{mode}.json"), "w") as f:
            json.dump(results, f)
    torch.distributed.destroy_process_group()


def launch_mesh_workers(mode, nproc, out, timeout):
    """This file under torch.distributed.run with ``nproc`` ranks in mesh
    worker mode; returns the exit code, with the ranks' output printed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__),
           "--mesh-worker", mode, out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith("mesh:"):
            print(line)
    print(f"mesh: {mode} x{nproc}: exit {proc.returncode} after "
          f"{time.perf_counter() - t0:.1f} s (process start included)")
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], sep="\n",
              file=sys.stderr)
    return proc.returncode


def phase_mesh(smi):
    """Replica sharding (ROADMAP A17) under torch.distributed.run: one NCCL
    rank, each workload bitwise equal to the run without a mesh; two gloo
    ranks sharing this card, PT held to the JAX suite's bounds against the
    one-rank run's; NCCL over every card where there are several."""
    torch.cuda.empty_cache()  # the workers share this card
    with tempfile.TemporaryDirectory() as out:
        rc = launch_mesh_workers("nccl", 1, out, 600)
        check(rc == 0, "mesh: the NCCL rank failed")
        res = json.load(open(os.path.join(out, "nccl.json")))
        for name in ("langevin", "pt"):
            r = res[name]
            check(r["launches_ok"] and r["finite"],
                  f"mesh: nccl {name}: launches or positions")
            check(r["bitwise"], f"mesh: nccl {name} differs from the run "
                                "without a mesh")
        rc = launch_mesh_workers("gloo", 2, out, 600)
        check(rc == 0, "mesh: a gloo rank failed")
        for name, label in (("pt", f"PT at {3 * PT_INDEP} slots"),
                            ("small", "PT at 4 slots of 64 beads, 40 steps "
                                      "(not gated)")):
            got = dict(np.load(os.path.join(out, f"{name}_gloo.npz")))
            want = dict(np.load(os.path.join(out, f"{name}_ref.npz")))
            err = np.abs(got["coords"] - want["coords"])
            beyond = int(np.sum(err > MESH_ATOL + MESH_RTOL
                                * np.abs(want["coords"])))
            exact = all(np.array_equal(got[k], want[k]) for k in (
                "acceptance", "acceptance_matrix", "n_exchange_approved",
                "n_exchange_attempted"))
            print(f"mesh: gloo 2 ranks on one card: {label} vs the "
                  f"one-process run: max|dx| {float(err.max()):.3e}, "
                  f"{beyond} of {err.size} coordinates beyond rtol "
                  f"{MESH_RTOL:.0e} + atol {MESH_ATOL:.0e}; acceptance "
                  f"counts and matrix exactly equal: {exact} "
                  f"({int(want['n_exchange_approved'])} of "
                  f"{int(want['n_exchange_attempted'])} approved)")
            if name == "pt":
                check(beyond == 0 and exact,
                      "mesh: two gloo ranks differ from one process")
        n = torch.cuda.device_count()
        if n > 1:
            rc = launch_mesh_workers("cards", n, out, 600)
            check(rc == 0, f"mesh: NCCL over {n} cards failed")
            r = json.load(open(os.path.join(out, "cards.json")))["langevin"]
            check(r["launches_ok"] and r["finite"],
                  f"mesh: NCCL over {n} cards: launches or positions")
            print(f"mesh: NCCL over {n} cards: the sharded Langevin slice "
                  f"against one card's run: max|dx| {r['max_dx']:.3e} "
                  f"(not gated: each rank's fewer rows may take other "
                  f"cuBLAS kernels); throughput "
                  + " / ".join(f"{t:.1f}" for t in r["throughput"])
                  + " (without / with / with / without)")
        else:
            print("mesh: NCCL across several cards: this machine has one "
                  "card; the check waits for a machine with more")


# ---------------------------------------------------------------------------
# The exact-filter kernels at every width (ops/cfconv_general.py)
# ---------------------------------------------------------------------------

def width_field(device, batch, f, r, message_passing, precision="bf16",
                hidden=None, blocks=None):
    """The zoo's chain at ``batch`` (priors, head, capacity rule and
    configurations of cgschnet_1enh_like) with a SchNet of num_filters = f,
    num_rbf = r, hidden_channels = ``hidden`` (f when None) and
    ``blocks`` interaction blocks (the zoo's 3 when None) from
    SchNetConfig and init_schnet on a seeded generator: the zoo takes no
    width arguments, as the JAX zoo has none."""
    from flashmd_tpu_torch.models.schnet import init_schnet

    ff, cfgs = _force_fields(device, batch, message_passing=message_passing,
                             precision=precision)
    cfg = dataclasses.replace(
        ff.schnet_config, hidden_channels=hidden or f, num_filters=f,
        num_rbf=r,
        num_interactions=blocks or ff.schnet_config.num_interactions)
    params = init_schnet(cfg, torch.Generator().manual_seed(WIDTH_SEED),
                         device)
    return ff.replace(schnet_params=params, schnet_config=cfg), cfgs


def filter_weights(ff):
    """(w0, b0, w1, offset, coeff) of the first block's filter MLP."""
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    return (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
            rbf["coeff"])


def general_note(family, kernels, what, f, r):
    """The fp32 line's note: the pairs or slots run and the registers,
    spills and warps a block of the general-width CUDA-core kernels that
    ran (general_kernels; the tuned ones' registers are in the build
    lines)."""
    if family == "tuned":
        return f"{what}; tuned kernels, padded to F = 128"
    from flashmd_tpu_torch.ops._build import load

    fp, rq = -(-f // 64) * 64, -(-r // 64) * 64
    parts = []
    for k, kind in kernels:
        warps = load().cfconv_general_warps(kind, fp, r, rq)
        parts.append(f"{k}: {GENERAL_BUILD[k][0]} regs, spill "
                     f"{GENERAL_BUILD[k][1]}/{GENERAL_BUILD[k][2]} B, "
                     f"{warps} warps a block" if k in GENERAL_BUILD else
                     f"{k}: registers not read, {warps} warps a block")
    return f"{what}; " + "; ".join(parts)


# The tensor-core kernels of each case of phase_width_kernels at bf16, as
# MMA_BUILD's labels begin, with their kind of cfconv_general_mma_warps (0
# forward and gx pass, 1 backward, 2 dense backward with gx): {case:
# [(staged kernel, streamed kernel, kind)]}.
MMA_CASES = {
    "dense fwd": [("general dense fwd kernel gw_dense_fwd_mma_kernel",
                   "streamed dense fwd kernel gp_dense_fwd_kernel", 0)],
    "dense bwd": [("general kernel gw_bwd_mma_kernel bf16 dense with gx",
                   "general kernel gp_bwd_kernel bf16 dense with gx", 2)],
    "dense bwd (no gx)": [("general kernel gw_bwd_mma_kernel bf16 dense no gx",
                           "general kernel gp_bwd_kernel bf16 dense no gx",
                           1)],
    "nbr fwd": [("general nbr fwd kernel gw_nbr_fwd_mma_kernel",
                 "streamed nbr fwd kernel gp_nbr_fwd_kernel", 0)],
    "nbr bwd": [("general kernel gw_bwd_mma_kernel bf16 nbr",
                 "general kernel gp_bwd_kernel bf16 nbr", 1),
                ("general gx kernel gw_nbr_gx_mma_kernel",
                 "streamed gx kernel gp_nbr_gx_kernel", 0)],
    "nbr bwd (no gx)": [("general kernel gw_bwd_mma_kernel bf16 nbr",
                         "general kernel gp_bwd_kernel bf16 nbr", 1)],
}


def mma_note(family, case, f, r):
    """The bf16 line's note: the family and the tensor-core kernels that
    ran (the weights staged whole or streamed in panels, the library's
    cfconv_general_mma_layout) with their registers, spills and
    tensor-core instructions from the build and their warps a block; the
    CUDA-core kernels' names for the wide family."""
    if family == "tuned":
        return "tuned kernels, padded to F = 128"
    from flashmd_tpu_torch.ops._build import load

    fq, rq = -(-f // 16) * 16, -(-r // 16) * 16
    layout = load().cfconv_general_mma_layout(fq, rq)
    if layout < 0:
        return (f"family {family}: the CUDA-core kernels at bf16 "
                f"({', '.join(k for k, _ in general_kernels(f, r)[case])})")
    parts = []
    for staged, streamed, kind in MMA_CASES[case]:
        label = streamed if layout == 1 else staged
        regs, st, ld, n_mma = next(
            (v for k, v in MMA_BUILD.items() if k.startswith(label)),
            ("?", "?", "?", "?"))
        parts.append(f"{label.split(' kernel ')[1]}: {regs} regs, spill "
                     f"{st}/{ld} B, {n_mma} tensor-core MMA instructions, "
                     f"{load().cfconv_general_mma_warps(kind, fq, rq)} warps "
                     "a block")
    return (f"family {family} (weights "
            f"{'streamed in panels' if layout == 1 else 'staged whole'}); "
            + "; ".join(parts))


def phase_width_kernels(pos_all, dev):
    """Each of the four exact-filter kernels at each width of WIDTHS, at
    fp32 and bf16, the backwards with and without gx, against its twin on
    the slice's start positions (S = BATCH, or WIDTH_BATCHES' first
    molecules, A = N_ATOMS; the neighbour matrix from the zoo's capacity
    rule at rc + skin 1.0): two launches
    bitwise equal at each tier, then compare_and_time with the bound of
    2 (R F + F^2) FLOP per live pair or slot forward and twice that
    backward. The padded widths print the padding's work factor beside the
    F 128, R 50 kernels' times; at F 256, R 50 the neighbour backward's
    peak memory. Returns {(name, tier, (f, r)): numbers}."""
    from flashmd_tpu_torch.models.forcefield import build_neighbors
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops import cfconv_general as cg

    out = {}
    for f, r in WIDTHS:
        pos = pos_all[:WIDTH_BATCHES.get((f, r), len(pos_all))]
        s, a = pos.shape[:2]
        ff, _ = width_field(dev, 1, f, r, "pallas")
        rcut = float(ff.schnet_config.cutoff.cutoff_upper)
        w = filter_weights(ff)
        gen = torch.Generator(device=dev).manual_seed(f + r)
        x = torch.randn(s, a, f, generator=gen, device=dev)
        g = torch.randn(s, a, f, generator=gen, device=dev)
        nbr = build_neighbors(ff, pos, skin=1.0)
        k = nbr.capacity
        csr = (nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots)
        n_pairs, exec_pairs = live_counts(pos, rcut)
        n_slots, exec_slots = nbr_slot_counts(pos, nbr, rcut)[:2]
        mlp = r * f + f * f
        family = cg.route(f, r, "fp32")[0]
        bf16_family = cg.route(f, r, "bf16")[0]
        pad = (r * 128 + 128 * 128) / mlp
        wbytes = 4 * (r * f + 2 * f + f * f + r + 1)
        lbytes = 5 * s * a * k
        csr_bytes = 4 * (s * a + 1 + int(nbr.mask.sum()))
        print(f"widths: kernels F={f} R={r} S={s} A={a} K={k}: the "
              f"{family} kernels (bf16: {bf16_family})"
              + (f" (padded to F = 128: {pad:.3f} x the useful MLP work)"
                 if family == "tuned" else " (general width)")
              + f"; live pairs {n_pairs} (run {exec_pairs}), live slots "
              f"{n_slots} (run {exec_slots}); MLP multiply-adds per live "
              f"pair {mlp}; FLOP fwd {n_pairs * 2 * mlp:.4e} bwd "
              f"{n_pairs * 4 * mlp:.4e} (dense)")
        gk = general_kernels(f, r)
        cases = (
            ("dense_cfconv_fwd", "",
             lambda p: cd.dense_cfconv_fwd(pos, x, *w, rcut, p),
             lambda p: cd.dense_cfconv_fwd_plain(pos, x, *w, rcut, p),
             n_pairs * 2 * mlp, 4 * (s * a * 3 + 2 * s * a * f) + wbytes,
             gk["dense fwd"], "dense fwd", f"pairs run {exec_pairs}"),
            ("dense_cfconv_bwd", "",
             lambda p: cd.dense_cfconv_bwd(pos, x, g, *w, rcut, p),
             lambda p: cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, p),
             n_pairs * 4 * mlp, 4 * (2 * s * a * 3 + 3 * s * a * f) + wbytes,
             gk["dense bwd"], "dense bwd", f"pairs run {exec_pairs}"),
            ("dense_cfconv_bwd", " (no gx)",
             lambda p: cd.dense_cfconv_bwd(pos, x, g, *w, rcut, p,
                                           need_gx=False)[0],
             lambda p: cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, p,
                                                 need_gx=False)[0],
             n_pairs * 4 * mlp, 4 * (2 * s * a * 3 + 2 * s * a * f) + wbytes,
             gk["dense bwd (no gx)"], "dense bwd (no gx)",
             f"pairs run {exec_pairs}"),
            ("cfconv_fwd", "",
             lambda p: cf.cfconv_fwd(pos, nbr.idx, nbr.mask, x, *w, rcut, p),
             lambda p: cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w,
                                           rcut, p),
             n_slots * 2 * mlp,
             4 * (s * a * 3 + 2 * s * a * f) + lbytes + wbytes,
             gk["nbr fwd"], "nbr fwd", f"slots run {exec_slots}"),
            ("cfconv_bwd", "",
             lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, p),
             lambda p: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w,
                                           rcut, p),
             n_slots * 4 * mlp,
             4 * (2 * s * a * 3 + 3 * s * a * f) + lbytes + csr_bytes
             + wbytes, gk["nbr bwd"], "nbr bwd",
             f"slots run {exec_slots}"),
            ("cfconv_bwd", " (no gx)",
             lambda p: cf.cfconv_bwd(pos, *csr, x, g, *w, rcut, p,
                                     need_gx=False)[0],
             lambda p: cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w,
                                           rcut, p, need_gx=False)[0],
             n_slots * 4 * mlp,
             4 * (2 * s * a * 3 + 2 * s * a * f) + lbytes + csr_bytes
             + wbytes, gk["nbr bwd (no gx)"], "nbr bwd (no gx)",
             f"slots run {exec_slots}"),
        )
        for (name, sfx, kern, plain, flops, nbytes, kernels, case,
             what) in cases:
            label = f"{name}{sfx} F{f} R{r}"
            for prec in ("fp32", "bf16"):
                first, again = _tuple(kern(prec)), _tuple(kern(prec))
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in zip(first, again))
                print(f"kernels: {label} {prec}: two launches bitwise equal: "
                      f"{same}")
                check(same, f"{label} {prec}: two launches differ")
            compare_and_time(name, kern, plain, float(flops), nbytes,
                             label=label,
                             fp32_note=general_note(family, kernels, what,
                                                    f, r),
                             bf16_note=mma_note(bf16_family, case, f, r),
                             plain_iters=1)
            for prec in ("fp32", "bf16"):
                out[name + sfx, prec, (f, r)] = TIER_STATS[label, prec]
            if family == "tuned" and not sfx:
                main = TIER_STATS.get((name, "bf16"))
                if main:
                    print(f"widths: padding overhead {label}: bf16 "
                          f"{TIER_STATS[label, 'bf16']['ms']:.4f} ms, fp32 "
                          f"{TIER_STATS[label, 'fp32']['ms']:.4f} ms beside "
                          f"the F 128, R 50 kernel's {main['ms']:.4f} and "
                          f"{TIER_STATS[name, 'fp32']['ms']:.4f} ms; the "
                          f"padded MLP does {pad:.3f} x the useful work")
        if (f, r) == (256, 50):
            # the gx pass computes W again at both tiers: no workspace
            extra = nbr_bwd_peak(pos, csr, x, g, w, rcut)
            print(f"widths: cfconv_bwd memory at S={s} A={a} K={k} F={f} "
                  f"R={r}: peak above its inputs bf16 {extra['bf16']} B, "
                  f"fp32 {extra['fp32']} B (bound "
                  f"{NBR_BWD_MEMORY_LIMIT / 1e6:.0f} MB at both tiers)")
            check(max(extra.values()) < NBR_BWD_MEMORY_LIMIT,
                  "the general-width cfconv_bwd allocates a workspace of "
                  "the size of W")
    return out


def phase_widths(dev, smi):
    """The widths slices: for each configuration of WIDTH_SLICES (3 blocks,
    hidden = F), the pallas field (K from the zoo's capacity rule, skin
    1.0, the list rebuilt every step) and the dense field at bf16 and fp32
    (WIDTH_RUNS), and for OC20_WIDTHS (hidden 1,024, 5 blocks) both at
    bf16 (OC20_RUNS), each at full width (BATCH x N_ATOMS, the zoo's head
    and priors): forces at FORCE_BATCH card (no twin call) vs CPU twins
    (FORCE_BOUND at bf16, CROSS_BOUND at fp32), then WIDTH_STEPS BAOAB
    steps (dt 0.004; WIDTH_SHORT_STEPS at WIDTH_SLICES)
    with the routed family's forward and backward once per block and force
    evaluation and every other counter 0, no twin call, finite positions;
    throughput, ms/step, peak device memory and a profiler window (the
    device idle share). Returns {(f, r, path, tier): launch counts}."""
    from flashmd_tpu_torch.ops import cfconv_general as cg

    slices = [(f, r, None, 3, WIDTH_RUNS) for f, r in WIDTH_SLICES]
    slices.append((*OC20_WIDTHS, OC20_RUNS))
    runs = {}
    for f, r, hidden, blocks, width_runs in slices:
        for mp, prec in width_runs:
            label = (f"widths: {mp} {prec} F{f} R{r}"
                     + (f" H{hidden}" if hidden else ""))
            bound = FORCE_BOUND if prec == "bf16" else CROSS_BOUND
            shape = dict(hidden=hidden, blocks=blocks)
            forces = {}
            for device in (dev, torch.device("cpu")):
                ff, cfgs = width_field(device, FORCE_BATCH, f, r, mp, prec,
                                       **shape)
                with counting_twins(mp) as twins:
                    forces[device.type] = _forces(ff, cfgs, device)[1]
                if device.type == "cuda":
                    check(not any(twins.values()),
                          f"{label}: twin calls on the card {twins}")
            f_k, f_p = forces["cuda"], forces["cpu"]
            check(bool(torch.isfinite(f_k).all()),
                  f"{label}: non-finite forces on the card")
            rel = float((f_k - f_p).abs().max() / f_p.abs().max())
            print(f"forces: {label[8:]} batch {FORCE_BATCH} card vs cpu "
                  f"plain: max|dF|/max|F| = {rel:.3e} (bound {bound:.0e})")
            check(rel <= bound, f"{label}: card and CPU forces disagree")

            ff, cfgs = width_field(dev, BATCH, f, r, mp, prec, **shape)
            name = "cfconv" if mp == "pallas" else "dense_cfconv"
            family = cg.route(f, r, prec)[0]
            fwd, bwd = f"{name}_fwd_{family}", f"{name}_bwd_{family}"
            steps = WIDTH_STEPS if hidden else WIDTH_SHORT_STEPS
            n_evals = steps + 1
            expect = {**dict.fromkeys(cg.launch_counts(), 0),
                      fwd: blocks * n_evals, bwd: blocks * n_evals}
            AllKernels.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prep = cg.weight_preparations()
            t0 = time.perf_counter()
            with counting_twins(mp) as twins:
                counts, ms, sim = run_slice(
                    label, ff, cfgs, dev, steps, SAVE_INTERVAL, cg, expect,
                    smi, **({"gptq": None} if prec == "fp32" else {}))
            wall = time.perf_counter() - t0
            prep = cg.weight_preparations() - prep
            peak = torch.cuda.max_memory_allocated()
            check(not any(twins.values()), f"{label}: twin calls {twins}")
            others = {k: v for k, v in AllKernels.launch_counts().items()
                      if k not in counts}
            check(not any(others.values()),
                  f"{label}: other launches {others}")
            tp = sim.get_throughput_metrics()["throughput"]
            k = f", K {ff.neighbor_capacity}" if mp == "pallas" else ""
            print(f"{label}: {steps} steps, batch {BATCH}, {N_ATOMS} beads, "
                  f"{blocks} blocks, hidden {hidden or f}{k}: launches per "
                  f"force evaluation {fwd} {counts[fwd] // n_evals} and "
                  f"{bwd} {counts[bwd] // n_evals} (every other counter 0), "
                  f"twin calls 0; second-half throughput {tp:.1f} "
                  f"timestep*mol/s ({ms:.3f} ms/step); peak device memory "
                  f"{peak} B ({peak / 1e9:.3f} GB); filter weights prepared "
                  f"{prep} times in the run ({blocks} blocks); {wall:.1f} s; "
                  f"on {smi}")
            profile_steps(sim, dev, PROFILE_STEPS, label)
            runs[f, r, mp, prec] = counts
    return runs


def width_kernel_entries(kernel_stats, runs):
    """The kernels JSON line's entries of the general-width kernels that
    the widths slices launched: per configuration, the forward and the
    backward of each slice's path and tier, with the slice's launches and
    the kernel-level numbers at that width (the backward's error the
    larger of its runs with and without gx)."""
    from flashmd_tpu_torch.ops import cfconv_general as cg

    entries = []
    for (f, r, mp, prec), counts in runs.items():
        base = "cfconv" if mp == "pallas" else "dense_cfconv"
        family = cg.route(f, r, prec)[0]
        for kind in ("fwd", "bwd"):
            name = f"{base}_{kind}"
            st = dict(kernel_stats[name, prec, (f, r)])
            if kind == "bwd":
                st["max_abs_err"] = max(
                    st["max_abs_err"],
                    kernel_stats[name + " (no gx)", prec, (f, r)][
                        "max_abs_err"])
            entries.append({
                "name": f"{name}_{family}{'' if prec == 'bf16' else '_fp32'}"
                        f" F{f} R{r}",
                "route": "cuda",
                "source": (MMA_SOURCE if prec == "bf16" and family != "wide"
                           else GENERAL_SOURCE),
                "replaces": f"{REPLACES[name]} {prec} at F {f}, R {r}",
                "launches": counts[f"{name}_{family}"], **st})
    return entries


_T0 = time.perf_counter()


def mark(what):
    """Prints the seconds since the script started after ``what``: where
    the run's time goes."""
    print(f"time: {what} done at {time.perf_counter() - _T0:.1f} s")


def main():
    sys.stdout.reconfigure(line_buffering=True)  # in order with warnings
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
    print(f"build: nvcc {' '.join(_build.ARCH_FLAGS)} "
          f"{[p.name for p in _build.sources()]} -> {info['path'].name} "
          f"in {info['seconds']:.1f} s")
    for line in ptxas_summary(info["log"]):
        print(f"build: ptxas {line}")
    mma_kernel_report(info["log"], info["path"], _build._nvcc())
    ffma_kernel_report(info["log"])
    general_kernel_report(info["log"])
    mark("build")

    from flashmd_tpu_torch.data.system import collate
    from flashmd_tpu_torch.ops import cfconv as cf
    from flashmd_tpu_torch.ops import cfconv_dense as cd
    from flashmd_tpu_torch.ops import cheb_kernel as ck

    ff, cfgs = _force_fields(dev, BATCH)
    cfg = ff.schnet_config
    check((*cheb_orders(cfg), cfg.cheb_d_min, cfg.precision,
           cfg.message_passing) == (48, 64, 2.0, "bf16", "cheb"),
          f"unexpected slice config {cfg}")
    ff_dense, _ = _force_fields(dev, BATCH, message_passing="dense")
    check((ff_dense.schnet_config.precision,
           ff_dense.schnet_config.message_passing) == ("bf16", "dense"),
          f"unexpected dense slice config {ff_dense.schnet_config}")
    ff_pallas, _ = _force_fields(dev, BATCH, message_passing="pallas")
    check((ff_pallas.schnet_config.precision,
           ff_pallas.schnet_config.message_passing) == ("bf16", "pallas"),
          f"unexpected pallas slice config {ff_pallas.schnet_config}")
    ff_xla, _ = _force_fields(dev, BATCH, message_passing="xla")
    check((ff_xla.schnet_config.precision,
           ff_xla.schnet_config.message_passing,
           ff_xla.schnet_config.remat) == ("bf16", "xla", "block"),
          f"unexpected xla slice config {ff_xla.schnet_config}")
    ff_x3, _ = _force_fields(dev, BATCH, precision="bf16x3")
    cfg_x3 = ff_x3.schnet_config
    check((*cheb_orders(cfg_x3), cfg_x3.cheb_d_min, cfg_x3.precision,
           cfg_x3.message_passing) == (64, 96, 2.0, "bf16x3", "cheb"),
          f"unexpected bf16x3 slice config {cfg_x3}")
    ff_32, _ = _force_fields(dev, BATCH, precision="fp32")
    cfg_32 = ff_32.schnet_config
    check((*cheb_orders(cfg_32), cfg_32.cheb_d_min, cfg_32.precision,
           cfg_32.message_passing) == (128, 128, 0.0, "fp32", "cheb"),
          f"unexpected fp32 slice config {cfg_32}")

    pos = collate(cfgs, device=dev).pos
    stats = phase_cheb_kernels(ff, pos, dev)
    cells = kernel_cells(BATCH)
    folded = collate(with_cells(cfgs, cells, folded=True), device=dev)
    n_live, n_cross = crossing_pairs(folded.pos, folded.cell, ff.rcut)
    print(f"kernels: cheb_cell inputs: start positions folded into "
          f"{BATCH // 2} cubic {BOX:g} A and {BATCH // 2} triclinic "
          f"{CELL_TRICLINIC} cells; live pairs (d < rc) {n_live}, of which "
          f"{n_cross} cross a face")
    check(n_cross > 0, "no live pair crosses a face")
    stats.update(phase_cheb_kernels(ff, folded.pos, dev, cell=folded.cell))
    stats.update(phase_cheb_kernels(ff_x3, pos, dev, tier="bf16x3"))
    stats.update(phase_cheb_kernels(ff_x3, folded.pos, dev, cell=folded.cell,
                                    tier="bf16x3"))
    # the fp32 tier at the fp32 slice's own fits (128, 128) on d_min 0
    stats.update(phase_cheb_kernels(ff_32, pos, dev, tier="fp32"))
    stats.update(phase_cheb_kernels(ff_32, folded.pos, dev, cell=folded.cell,
                                    tier="fp32"))
    dense_stats, no_gx_ms = phase_dense_kernels(ff_dense, pos, dev)
    stats.update(dense_stats)
    nbr_stats, nbr_no_gx_ms = phase_nbr_kernels(ff_pallas, pos, dev)
    stats.update(nbr_stats)
    mark("kernel phases")
    with cheb_schedule("1"):
        phase_forces(dev, "cheb")
        phase_periodic_forces(dev)
    with cheb_schedule("0"):
        phase_forces(dev, "cheb", label="cheb per-block")
        phase_periodic_forces(dev, label="cheb per-block periodic")
    phase_schedule_check(dev)
    phase_forces(dev, "dense")
    phase_forces(dev, "pallas")
    phase_cross_check(dev)
    phase_image_check(dev)
    phase_bf16x3_forces(dev)
    phase_fp32_forces(dev)
    phase_forces(dev, "xla")
    phase_xla_forces(dev)
    phase_image_check(dev, "xla")
    mark("forces")

    n_evals = STEPS + 1
    with cheb_schedule("1"):
        counts, _, sim = run_slice("slice", ff, cfgs, dev, STEPS,
                                   SAVE_INTERVAL, ck, cheb_counts(n_evals),
                                   smi)
        open_tp = sim.get_throughput_metrics()["throughput"]
        profile_steps(sim, dev, PROFILE_STEPS, "slice")
        # benchmarks/pbc_ab.py's configuration: cubic BOX on every molecule.
        pbc_cfgs = with_cells(cfgs, np.stack([BOX * np.eye(3)] * BATCH))
        pbc_counts, _, sim = run_slice(
            "periodic", ff, pbc_cfgs, dev, STEPS, SAVE_INTERVAL, ck,
            cheb_counts(n_evals, cell=True), smi,
        )
    counts.update({k: v for k, v in pbc_counts.items() if k.endswith("_cell")})
    pbc_tp = sim.get_throughput_metrics()["throughput"]
    print(f"periodic: second-half throughput {pbc_tp:.1f} timestep*mol/s "
          f"beside the open cheb slice's {open_tp:.1f} in this run "
          f"(ratio {pbc_tp / open_tp:.4f})")
    profile_steps(sim, dev, PROFILE_STEPS, "periodic")
    with cheb_schedule("0"):
        pb_counts, _, sim = run_slice(
            "per-block", ff, cfgs, dev, STEPS, SAVE_INTERVAL, ck,
            cheb_counts(n_evals, per_block=True), smi,
        )
        pb_tp = sim.get_throughput_metrics()["throughput"]
        print(f"per-block: second-half throughput {pb_tp:.1f} timestep*mol/s "
              f"beside the stacked open slice's {open_tp:.1f} in this run "
              f"(ratio {pb_tp / open_tp:.4f})")
        profile_steps(sim, dev, PROFILE_STEPS, "per-block")
        n_pbc = PERBLOCK_PERIODIC_STEPS + 1
        pbc_pb_counts, _, sim = run_slice(
            "per-block periodic", ff, pbc_cfgs, dev, PERBLOCK_PERIODIC_STEPS,
            SAVE_INTERVAL, ck, cheb_counts(n_pbc, per_block=True, cell=True),
            smi,
        )
    counts["cheb_bwd_gxgd"] = pb_counts["cheb_bwd_gxgd"]
    counts["cheb_bwd_gxgd_cell"] = pbc_pb_counts["cheb_bwd_gxgd_cell"]
    print(f"per-block periodic: second-half throughput "
          f"{sim.get_throughput_metrics()['throughput']:.1f} timestep*mol/s "
          f"({PERBLOCK_PERIODIC_STEPS} steps) beside the stacked periodic "
          f"slice's {pbc_tp:.1f}")
    x3_counts, x3_tp = run_tier_slices(ff_x3, cfgs, pbc_cfgs, dev,
                                       BF16X3_STEPS, {"bf16 cheb": open_tp},
                                       smi)
    counts.update(x3_counts)
    counts.update(run_tier_slices(ff_32, cfgs, pbc_cfgs, dev, STEPS,
                                  {"bf16 cheb": open_tp, "bf16x3": x3_tp},
                                  smi, perblock_steps=STEPS)[0])
    dense_counts, ms_step, sim = run_slice(
        "dense", ff_dense, cfgs, dev, STEPS, SAVE_INTERVAL, cd,
        {"dense_cfconv_fwd": 3 * n_evals, "dense_cfconv_bwd": 3 * n_evals},
        smi,
    )
    counts.update(dense_counts)
    kernel_ms = (3 * stats["dense_cfconv_fwd"]["ms"]
                 + 2 * stats["dense_cfconv_bwd"]["ms"] + no_gx_ms)
    print(f"dense: per step 3 fwd + 2 bwd + 1 bwd (no gx) at the start "
          f"positions' kernel times = {kernel_ms:.3f} ms of {ms_step:.3f} "
          f"ms/step ({kernel_ms / ms_step:.3f}); an estimate, not a trace")
    dense_tp = sim.get_throughput_metrics()["throughput"]
    profile_steps(sim, dev, PROFILE_STEPS, "dense")
    counts.update(phase_dense_fp32_slice(cfgs, dev, dense_tp, smi))
    mark("cheb, tier and dense slices")
    pallas_counts, ms_step, sim = run_slice(
        "pallas", ff_pallas, cfgs, dev, STEPS, SAVE_INTERVAL, cf,
        {"cfconv_fwd": 3 * n_evals, "cfconv_bwd": 3 * n_evals}, smi,
    )
    counts.update(pallas_counts)
    kernel_ms = (3 * stats["cfconv_fwd"]["ms"] + 2 * stats["cfconv_bwd"]["ms"]
                 + nbr_no_gx_ms)
    print(f"pallas: K {ff_pallas.neighbor_capacity}, skin {sim.neighbor_skin}"
          f", rebuild every {sim.neighbor_rebuild_interval} step(s); n_max "
          f"over the run {int(sim.final_carry['nbr_n_max'])}; per step 3 fwd "
          f"+ 2 bwd + 1 bwd (no gx) at the start positions' kernel times = "
          f"{kernel_ms:.3f} ms of {ms_step:.3f} ms/step "
          f"({kernel_ms / ms_step:.3f}); an estimate, not a trace")
    pallas_tp = sim.get_throughput_metrics()["throughput"]
    profile_steps(sim, dev, PROFILE_STEPS, "pallas")
    counts.update(phase_pallas_fp32_slice(cfgs, dev, pallas_tp, smi))
    mark("pallas slices")
    _, ms_step, sim = run_slice("xla", ff_xla, cfgs, dev, XLA_STEPS,
                                SAVE_INTERVAL, AllKernels, AllKernels.zeros(),
                                smi)
    print(f"xla: K {ff_xla.neighbor_capacity}, skin {sim.neighbor_skin}, "
          f"rebuild every {sim.neighbor_rebuild_interval} step(s), remat "
          f"{ff_xla.schnet_config.remat!r}; n_max over the run "
          f"{int(sim.final_carry['nbr_n_max'])}; every kernel counter 0")
    xla_tp = sim.get_throughput_metrics()["throughput"]
    profile_steps(sim, dev, PROFILE_STEPS, "xla", ops=16)
    phase_xla_batch(ff_xla, cfgs, dev)
    _, _, sim = run_slice("xla periodic", ff_xla, pbc_cfgs, dev,
                          XLA_CELL_STEPS, SAVE_INTERVAL, AllKernels,
                          AllKernels.zeros(), smi)
    check(sim.model.pbc_images is None,
          "the 60 A cell should stay in the minimum-image regime")
    print(f"xla periodic: second-half throughput "
          f"{sim.get_throughput_metrics()['throughput']:.1f} timestep*mol/s "
          f"({XLA_CELL_STEPS} steps, minimum image, Verlet rebuild under the "
          f"cell) beside the open xla slice's {xla_tp:.1f}")
    phase_xla_images(dev, smi)
    mark("xla slices")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        phase_checkpoint(dev, open_tp, smi, ckpt_dir)
        phase_cli(ckpt_dir, dev, smi)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        phase_checkpoint_identity_basis(dev, smi, ckpt_dir)
        mark("checkpoint and cli")
    method_fits = host_fit_methods(ff)
    phase_fidelity(dev, method_fits)
    with cheb_schedule("1"):
        phase_fit(ff, cfgs, dev, smi, method_fits)
        phase_envelopes(ff, cfgs, dev, smi)
        mark("fidelity, fit and envelopes")
    # The integrators, beside a second run of the open cheb slice at this
    # point of the process.
    with cheb_schedule("1"):
        _, late_ms, sim = run_slice("cheb again", ff, cfgs, dev, STEPS,
                                    SAVE_INTERVAL, ck, cheb_counts(n_evals),
                                    smi, save_energies=True)
        late_tp = sim.get_throughput_metrics()["throughput"]
        print(f"cheb again: second-half throughput {late_tp:.1f} "
              f"timestep*mol/s beside the first open cheb slice's "
              f"{open_tp:.1f} in this run (ratio {late_tp / open_tp:.4f}); "
              f"kinetic energy per degree of freedom over the second half "
              f"{kinetic_per_dof(sim):.5f} at beta 1.67 (1/(2 beta) "
              f"{0.5 / 1.67:.5f})")
        phase_nve_overdamped(ff, cfgs, dev, late_tp, smi)
        phase_pt(dev, late_tp, late_ms, smi)
    phase_pt_exchange(dev)
    phase_nve_drift(dev)
    mark("integrators and pt")
    with cheb_schedule("1"):
        phase_export(ff, cfgs, dev, smi)
        phase_resume(ff, cfgs, dev)
        phase_pair_floor(ff, cfgs, dev, smi)
    phase_guard(dev)
    mark("export, resume, floor and guard")
    with cheb_schedule("1"):
        phase_mixed_forces(dev)
        phase_mixed(dev, smi)
        mark("mixed")
        phase_host(ff, cfgs, dev, open_tp, smi)
        phase_mesh(smi)
        mark("host and mesh")
    width_stats = phase_width_kernels(pos, dev)
    mark("widths kernels")
    width_runs = phase_widths(dev, smi)
    mark("widths slices")

    for name in ("dense_cfconv_fwd", "dense_cfconv_bwd", "cfconv_fwd",
                 "cfconv_bwd"):
        st = dict(TIER_STATS[name, "fp32"])
        no_gx = TIER_STATS.get((name + " (no gx)", "fp32"))
        if no_gx:
            st["max_abs_err"] = max(st["max_abs_err"], no_gx["max_abs_err"])
        stats[name + "_fp32"] = st
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": SOURCES[name.split("_")[0]],
         "replaces": REPLACES[name], "launches": counts[name],
         **stats[name]}
        for name in REPLACES
    ] + width_kernel_entries(width_stats, width_runs)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    else:
        main()
