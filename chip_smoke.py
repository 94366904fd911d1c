#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

The paths, each at full width with random weights from a seed:

* serving: the online hybrid coupled step that ``bench.py`` builds for
  the JAX package: the flagship BiGRU emulator (``RNNAutoreg``, nx 6,
  nneur 192/192, nh_mem 16, bf16 policy, the fused channel-major kernel)
  inside ``HybridLoop`` (spherical FV transport through the fused
  multi-tracer stencil, water and energy fixers) on a 120 x 180 proxy grid
  of 21,600 columns and 60 levels;
* training: rollout training of the same model through ``RolloutTrainer``
  as ``bench.py::build_train`` configures it (W 4 BPTT window, remat on
  each window step, MSE loss, Adam at 1e-4, 21,600 columns): B1 runs
  forward and in the remat recompute, the backward kernel B3 once per
  step; and the same training of the batch-major scan arm (which
  ``conf/autoreg_gru.yaml`` trains) and of the v4 arm (B10 forward and
  recompute, its backward through B7 and B8);
* evaluation of the physics-constrained emulator: ``PhysicalRNNAutoreg``
  in ``conf/autoreg_physrnn.yaml``'s configuration (nneur 128/128, nh_mem
  16, nreg 8, McICA, qv variability, stored precipitation, ice
  sedimentation, physical radiation with ng 8/8, f32) with the trunk the
  yaml builds (the scan: two ``RNNLayer`` sweeps, the yaml setting no
  ``use_pallas``) and beside it the fused trunk (kernel B7), through
  ``RolloutTrainer.run_epoch(train=False)`` with the raw state
  (``pass_x_raw``) on one W 3 window of 21,600 columns: per model step
  B12 and B11 run the LW and SW solvers;
* training of the physics-constrained emulator: the same models through
  ``RolloutTrainer.update`` with the yaml's loss and optimizer (huber,
  w_hcon 5e-6, w_wcon 3e7, Adam 5e-4, the curriculum's last window W 3,
  teacher-forced radiation state, no remat, f32), as
  cli/train_rollout.py wires ``type: physrnn``: per step B11 and B12
  forward and their backward kernels B13 and B14, with the fused trunk
  also B7 and B8;
* the coupled step's other serving arms (ARMS below) at the same width and
  grid: the four other emulator arms that bench.py times (v5 channel-major
  with kernel B4, v2 batch-major with B7 at H 192, the scan with the fused
  stencil and with the per-field plain stencil), the batch-major fused
  arms v3 (kernel B9) and v4 (kernel B10), and the flagship on the other
  transport configurations (flat FV through the fused B5 and one field at
  a time through B6, semi-Lagrangian transport on the sphere with
  vertical advection);
* the coupled step's CLI, ``cli/run_hybrid.py``, as a user runs it on a
  384-column grid file at its defaults: the JAX CLI's emulator (the
  batch-major scan arm, nneur 192, f32) in ``HybridLoop`` with each
  transport scheme, from ``data.synthetic.generate_state``'s state.
* the rollout-training CLI, ``cli/train_rollout.py``, as a user runs it on
  the physics yaml and the GRU yaml: synthetic data, normalization, the
  yaml's model, fused epochs through the curriculum, validation, the
  scoreboard, checkpoints and resume;
* the latitude-sharded coupled step, ``online/host_loop.py::
  sharded_hybrid_step``, of the v4 arm (B10) on a one-rank NCCL group at
  21,600 columns (two ranks where the machine has two cards), and the
  scaling CLI ``cli/scale_bench.py``;
* the offline baselines' trainer, ``cli/train_offline.py``, on
  ``conf/mlp_v1.yaml`` and ``conf/cnn_v1.yaml`` as written (BASELINE.json
  configs 1 and 2: the MLP 768-640-512-640-640 at batch 1536, the CNN of
  12 blocks of 406 channels at batch 768, f32), the weighted scoreboard's
  CLI ``cli/evaluate.py``, the data-parallel rollout epoch and the
  multi-device dry run ``cli/dryrun_multichip.py``.

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (one nvcc
     per source, all started together), print each kernel's registers and
     spills, and count the tensor-core instructions (HMMA/HGMMA) of the
     bf16 designs of B1, B3, B4 and B7-B10 in their SASS (cuobjdump):
     each must have some; and the f32 cluster design of B7 and B8 must
     have FFMA and no tensor-core (so no TF32) instruction;
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (and a ragged batch): B1, B2 (also at 384
     columns; check_fv_design: the band tile that fv_design names,
     recorded on the wrapper, a second call bit-identical, the kernel's
     shared memory fv_design's, the first design within the gate of the
     tile), B3, then B7 at the
     physics trunk's L 50, H 128 (f32 and, as an extra tiling of the
     tensor-core design, bf16, at 21,600 and 1,000 columns), B11 and B12
     (21,600 x 60 x 8), B11 through its wrapper also at RAD_SHAPES (the
     staged design everywhere but ng 6, which runs the first; a second
     call bit-identical; the design rad_design names recorded on the
     wrapper; the first design, which the timings use, held to the same
     tolerance against the staged one; the kernel's shared memory equal
     to rad_tile_smem's); then B4 (f32
     and bf16, projections hoisted and not, at 21,600 and 1,000 columns),
     B5 (6, 60, 120, 180) and B6 (60, 120, 180), each through
     check_fv_design as B2, and B5 on each tracer bit-identical to B6 on
     that field alone,
     B7 at the v2 arm's L 60,
     H 192 (f32 and bf16), B8 at the v4 arm's L 60, H 192 (f32 and
     bf16), B9 and B10 (f32 and bf16 at 21,600 and 1,000 columns);
     bf16 B1, B3, B4 and B7-B10 run the tensor-core designs, f32 B7 and
     B8 the cluster FFMA design (two calls bit-identical), the other f32
     kinds the CUDA-core ones;
  3. 20 coupled steps at 21,600 columns, with every launch counter set to
     0 just before and read just after: B1 and B2 must launch 20 times and
     no other kernel, B2 in the band-tile design; then the same for each
     other serving arm, whose kernels must each launch their count per
     step and no other kernel (B5 and B6 in the band-tile design, as
     their arms' own tensors chose it);
  4. 3 coupled steps at 384 columns on the card and on the CPU (plain
     versions), compared, for every serving arm; then the coupled step's
     CLI (``python -m climsim_tpu_torch.cli.run_hybrid``, through its
     main) on a 384-column grid file written under build/: at its
     defaults on the card (nneur 192, 48 steps, scheme fv; no kernel may
     launch, as its JAX counterpart launches no Pallas kernel), with its
     wall time, then 4 steps of each scheme at nneur 32 on the card
     against ``--device cpu``, and 4 at the defaults, there within 4x the
     CPU's own movement under a 1e-6 change of the initial T (compare_cli);
  5. gradients through the differentiable fused layers (v6: B1 + B3; v5:
     B4 + B3; v3: B9 + B7 + B8; v4: B10 + B7 + B8) at 384 columns, on the
     card and on the CPU, compared;
  6. the training paths: one chunk of 16 steps (4 updates) at 21,600
     columns for the v6, scan and v4 arms, every counter set to 0 just
     before and read just after: per update B1 2W and B3 W times (v6), B10
     2W and B7 and B8 W times (v4), no kernel (scan); finite loss and
     memory, parameters changed; then one update of each at 384 columns on
     the card and on the CPU, compared (v4's also on the card through the
     CUDA-core designs of B10, B7 and B8, a witness of the rounding noise
     in its parameter steps); then the flagship at nneur (512,
     512), past the resident-weight design's width: B1 and B3 (weights
     streamed) against their plain versions at 1,000 columns and timed, 3
     coupled steps and one training update at 384 columns with their
     launches counted; the scan arm's sweeps (RNNLayer, bf16, H 192) at
     21,600 columns bit for bit against the earlier select loop
     (check_c1_bits: outputs and every gradient); then the width phase
     (check_widths): every GRU
     kind at 1,000 columns and L 60 in bf16 at H 840 (B7 and B8 also
     968) and in f32 at H 384 and 512 against its plain version, with
     the design the selector chose, its time and its launch count; one
     f32 v6 update and one fused-trunk physics update at nneur (384,
     384);
  7. the physics evaluation window at 21,600 columns with each trunk,
     every physics counter set to 0 just before and read just after: B11
     and B12 (and with the fused trunk B7) must launch W times each and no
     other; finite loss, outputs and memory, non-negative stored and
     surface precipitation; then the same window at 384 columns on the
     card and on the CPU, compared after counting the McICA sample indices
     that differ, for each trunk;
  8. physics training: B8 (f32 and bf16 at 21,600 and 1,000 columns),
     B13 (21,600 x 60 x 8 and 1,000 x 50 x 8) and B14 (21,600 x 60 x 8,
     and at RAD_SHAPES as B11 in phase 2) against their plain versions;
     one
     chunk of 6 steps (2 updates of W 3) with each trunk, counters set to
     0 just before and read just after: B11, B12, B13 and B14 (and with
     the fused trunk B7 and B8) must each launch W times per update; finite
     loss and memory, non-negative stored precipitation, every parameter
     with a gradient changed (the scan trunk at 21,600 columns, halved
     until its update fits in the card's memory, the cut printed); then
     one update of each trunk at 384 columns on the card and on the CPU,
     compared after counting the McICA sample indices that differ;
  9. the rollout-training CLI (``python -m climsim_tpu_torch.cli.
     train_rollout``, through its main) on a 384-column grid file under
     build/, every launch counter set to 0 just before each run and read
     just after: ``conf/autoreg_physrnn.yaml`` as written (scan trunk,
     w_wcon read as the float 3e7) at 10,800 columns through W 1, 2 and 3
     with validation, eval_report and best-K checkpoints (index.json
     sorted, at most 3), B11 and B12 once per model step and B13 and B14
     once per model step of an update (W per update) and no other kernel;
     then resume=true, which must start at the best epoch + 1;
     ``conf/autoreg_gru.yaml`` at 21,600 columns as written (the scan
     arm: no kernel) and with model.use_pallas=true (the v2 arm: B7 per
     model step, B8 W per update, both in the f32 cluster design); each
     with its wall time, seconds per epoch, updates, column-steps/s and
     peak memory, and one more epoch of each under torch.profiler (device
     idle share; the host-to-device copies, which with the device cache
     must hold no data window); then both yamls at 384 columns for one
     epoch on the card and with device=cpu, loss and val_loss within 1e-4
     plus 4x the CPU's own movement under a 1e-6 change of the learning
     rate, with the McICA sample indices that differ counted; one chunk
     of the GRU yaml's scan epoch with the earlier select loop in turns
     with the unbind sweep (ms per update, peak memory);
 10. the sharded coupled step (check_sharded): ``sharded_hybrid_step`` of
     the v4 arm on a one-rank NCCL group at 21,600 columns in the
     production configuration, with and without the overlap, against
     ``coupled_step`` (fields rtol 1e-5 / atol 1e-8, u and v atol 1e-5 of
     their largest magnitude, memory atol 5e-7), every counter set to 0
     just before 20 steps and read just after (B10 twice a step with the
     overlap, once without, no other kernel), ms per step beside the
     single-device step and the idle share; semi-Lagrangian and vertical
     transport at 384 columns against ``coupled_step``; ``python -m
     climsim_tpu_torch.cli.scale_bench --devices 1``; two NCCL ranks
     against the single-device step where the machine has two cards;
 11. timings with CUDA events (median of 5 repeats for the v6 coupled
     step and training update and the kernels; 2 for the other arms'
     coupled steps and training and the physics paths), peak memory and
     profiler splits; every serving arm's
     coupled step with its device idle share (v6 and v5 also at 384
     columns), the three training arms, both physics trunks; B2 (also
     at 384 columns), B5 and B6 (the band tile) in turns with their first
     designs; B13
     against its first design (device scratch, four sweeps) in turns; B11
     and B14 (the staged design) in turns with their first designs; B1,
     B3, B4, B7 and B8 (at the v2 and v4 arms' shapes), B9 and B10 in
     bf16 as the tensor-core design against
     the CUDA-core design (f32's, instantiated in bf16 under a second C
     symbol or called with the bf16 type by a function that no wrapper
     selects), timed in turns (old, new, new, old), each with every device
     kernel of one call by name beside the call's CUDA-event time, B7 also
     on a wider column tile against its plan's, and B1, B3, B7 and B8 in
     f32; the library yardstick of B7 and B8, cuDNN's GRU (gru_pair: two
     torch.nn.GRU with the v2 layer's weights, which the port never
     calls), first held to the plain version, then timed forward against
     FusedBiGRULayer's forward and backward against B8, in bf16 (fp16
     where cuDNN takes no bf16) at the v2 arm's shapes and in f32 (no
     TF32) at the physics trunk's, each with its kernels by name; f32 B7
     and B8 at the physics trunk's shapes as the cluster FFMA design in
     turns with the CUDA-core design (and that design's tiles in device
     scratch in turns with shared memory), each with its kernels by name;
     the f32 CUDA-core B9 and B10 and the f32 bounds of B1, B3, B4, B9
     and B10; the
     library yardstick of B4 and B9 (heads_yardstick: the same pair, in
     fp16, then the latent and output heads as two torch.nn.Linear, for
     B4 with its inputs and outputs permuted between the channel-major and
     the pair's layout), first held to the plain version, then timed
     beside the kernel; the scan arm's training update and the physics
     scan trunk's update at 10,800 columns with the earlier select loop
     in turns with the unbind sweep (C.1: ms per update, peak memory);
 12. the offline baselines (check_offline): ``python -m
     climsim_tpu_torch.cli.train_offline`` through its main on
     conf/mlp_v1.yaml and conf/cnn_v1.yaml as written (f32, TF32 off), the
     MLP yaml with model.name=ed, and the MLP yaml at 500 steps (100
     updates an epoch), each with no kernel of the port launched, its
     wall time, seconds an epoch, samples/s, FLOP rate against the f32
     bound and peak memory, and one more epoch of the CNN and of the
     500-step MLP under torch.profiler (idle share; host-to-device bytes,
     the shuffle's permutation alone); the
     MLP run's validation block exported and scored by ``cli/evaluate``
     (equal to the training CLI's scoreboard within rtol 1e-5); the
     rollout CLI's ``pred_export`` scored by ``cli/evaluate --raw``; both
     yamls small on the card against device=cpu within 1e-4 plus 4x the
     movement of one witness (initial weights x (1 + 1e-6)); the
     data-parallel fused epoch (A.17) of the v4 arm at 21,600 columns, W
     4, on a one-rank NCCL group against the single-device epoch (its
     launches counted, ms an update of each), and on 2 NCCL ranks where
     the machine has two GPUs; ``cli.dryrun_multichip --devices 1``;
 13. a JSON line of the kernels (B7's and B8's entries: the bf16
     tensor-core design at the v2/v4 arms' shapes, with the f32 design at
     the physics trunk's under "f32"; their "library_ms" the cuDNN pair's
     forward and backward, B4's and B9's the pair with the heads), the
     card line, and the result line.
The end of each phase prints the wall time since the start and the
phase's own; phase 12 prints each of its steps' seconds.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# published peaks of one H100 SXM at its 700 W limit (dense)
PEAK_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_TF32 = 495e12          # FLOP/s, tensor cores (not used by f32 code)
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12        # B/s, HBM3

NLAT, NLON, NLEV = 120, 180, 60          # 21,600 columns
LO_NLAT, LO_NLON = 16, 24                # 384 columns
# timing repeats; the coupled steps and training of the arms other than
# v6 (earlier slices' paths) take fewer, to hold the run's time as the
# paths grow
N_STEPS, REPEATS, OLD_REPEATS = 20, 5, 2
W_TRAIN, T_CHUNK, LR = 4, 16, 1e-4      # bench.py::build_train
XSCALE = [250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0]
YSCALE = [1e-5, 1e-8, 1e-9, 1e-9, 1e-5, 1e-5]
# operations per element of one tracer and level in the FV step: two face
# fluxes (two MC slopes of ~14 operations and ~6 for the upwind value)
# and the update, per sweep
FV_OPS_PER_ELEMENT = 80
# the physics evaluation path: conf/autoreg_physrnn.yaml's last window, and
# the output scales of tests/test_phys_rnn.py
PHYS_W = 3
PHYS_YSCALE = dict(yscale_t=1e5, yscale_qv=1e8, yscale_qn=1e8,
                   yscale_precc=1e7)
# operations per (column, g-point, level) of the radiation solvers,
# counting a division as one: SW 13 in the up sweep and 13 in the down
# sweep, LW 2 in each accumulation
SW_OPS_PER_ELEMENT = 26
LW_OPS_PER_ELEMENT = 4
# their backward kernels (B13, B14), counted from the sources the same way:
# SW replay 23, down-sweep backward 41, up-sweep backward 50; LW replay 4,
# up backward 3, down backward 4
SW_BWD_OPS_PER_ELEMENT = 114
LW_BWD_OPS_PER_ELEMENT = 11
# physics training: conf/autoreg_physrnn.yaml's loss and optimizer as
# cli/train_rollout.py:251-403 wires type: physrnn (w_hcon, w_wcon at
# :352-353), one chunk of 6 steps (2 updates of the schedule's last W), and
# per-channel output scales matching PHYS_YSCALE, passed to the trainer as
# cli/train_rollout.py:401-402 does: levels (T, qv, qn, u, v) and surface
# (NETSW, FLWDS, PRECSC, PRECC, SOLS, SOLL, SOLSD, SOLLD)
PHYS_LR = 5e-4
PHYS_TRAIN = dict(w_main=1.0, w_energy=5e-6, w_water=3e7, optimizer="adam",
                  lr=PHYS_LR)
PHYS_T_TRAIN = 6
PHYS_YSCALE_LEV = [1e5, 1e8, 1e8, 1e5, 1e5]
PHYS_YSCALE_SFC = [1e-2, 1e-2, 1e7, 1e7, 1e-2, 1e-2, 1e-2, 1e-2]
# the coupled step's serving arms: the RNNAutoreg flags on top of the
# flagship's (use_pallas, bf16), the HostLoopConfig fields on top of the
# production step's (sphere FV through the fused stencil, both fixers,
# channel-major), and the kernels each launches per coupled step. "v6" is
# the main path of phase 3; v5, v2, scan and scan_xla are the other arms
# bench.py:341-345 times; the last three run the flagship on the other
# transport configurations. A flat raster takes the proxy grid's mean
# spacing as its cell size (flat_spacing). With vertical advection the
# winds start smooth (initial_state): bench.py's white-noise winds of
# 10 m/s give a divergence of ~1 per step next to the poles of the 2-degree
# grid and, through 60 layers of 1,000 Pa, vertical Courant numbers of ~8,
# beyond what the first-order upwind transport (which has no clip, in JAX
# as here) keeps stable.
V6_FLAGS = dict(fuse_heads=True, fuse_init=True, level_major=True)
BATCH_MAJOR = dict(emulator_level_major=False)
ARMS = {
    "v6": (V6_FLAGS, {}, {"b1": 1, "b2": 1}),
    "v5": (dict(fuse_heads=True, level_major=True), {}, {"b4": 1, "b2": 1}),
    "v2": ({}, BATCH_MAJOR, {"b7": 1, "b2": 1}),
    "scan": (dict(use_pallas=False), BATCH_MAJOR, {"b2": 1}),
    "scan_xla": (dict(use_pallas=False), dict(BATCH_MAJOR, use_pallas=False),
                 {}),
    "v6_flat": (V6_FLAGS, dict(geometry="flat"), {"b1": 1, "b5": 1}),
    "v6_sl_vertical": (V6_FLAGS, dict(scheme="semi_lagrangian",
                                      vertical_advection=True), {"b1": 1}),
    "v6_flat_per_field": (V6_FLAGS, dict(geometry="flat", use_pallas=False),
                          {"b1": 1, "b6": 6}),
    "v3": (dict(fuse_heads=True), BATCH_MAJOR, {"b9": 1, "b2": 1}),
    "v4": (dict(fuse_heads=True, fuse_init=True), BATCH_MAJOR,
           {"b10": 1, "b2": 1}),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


T_START = time.perf_counter()
PHASE_START = [T_START]


def phase_done(n: int) -> None:
    """Print the wall time since the script started and the phase's own,
    at the end of phase n."""
    now = time.perf_counter()
    print(f"phase {n} done at {now - T_START:.1f} s (the phase took "
          f"{now - PHASE_START[0]:.1f} s)")
    PHASE_START[0] = now


# the bf16 designs that must run their products on tensor cores: B1, B4,
# B9 and B10 (one kernel body, bigru_mma_fwd.cuh; B4's two roundings and
# B10's and B9's resident instances by their template arguments <kBM,
# kRoundXP, kStream, kLoadX>), B3 and B8 (bigru_mma_bwd.cuh), B7
# (bigru_lbh.cu)
MMA_KERNELS = {"bigru_heads_init_cm": ("mma_fwd_kernel",),
               "bigru_heads_cm": ("mma_fwd_kernelILb0ELb1ELb0ELb1E",
                                  "mma_fwd_kernelILb0ELb0ELb0ELb1E"),
               "bigru_heads_cm_bwd": ("b3_mma_kernel", "wgrad_mma_kernel"),
               "bigru_lbh_bwd": ("b8_mma_kernel", "wgrad_mma_kernel"),
               "bigru_heads_lbh": ("mma_fwd_kernelILb1ELb0ELb0ELb0E",
                                   "mma_fwd_kernelILb1ELb0ELb0ELb1E"),
               "bigru_lbh": ("b7_mma_kernel",)}


# the f32 cluster design of B7 and B8 (bigru_f32.cuh): FFMA on the CUDA
# cores, no tensor-core (HMMA/HGMMA, and so no TF32) instruction
F32_KERNELS = {"bigru_lbh": ("f32_sweep_kernel",),
               "bigru_lbh_bwd": ("f32_sweep_kernel", "f32_bptt_kernel",
                                 "f32_wgrad_kernel")}


def check_tensor_core_sass(card):
    """Count the tensor-core instructions (HMMA, HGMMA) of each bf16
    tensor-core kernel in its built library (``cuobjdump -sass``); each
    must have some. Then the f32 cluster design's kernels: each must have
    FFMA and no tensor-core instruction. Without cuobjdump the counts are
    not measured."""
    from climsim_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"tensor-core instructions: no cuobjdump, not measured "
              f"[{card}]")
        return
    for name, kernels in MMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = next((k for k in kernels if k in line), None)
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                op = "HGMMA" if "HGMMA" in line else "HMMA"
                counts[(fn, op)] = counts.get((fn, op), 0) + 1
        print(f"tensor-core instructions in {name}: "
              + ", ".join(f"{k} {op} x{n}" for (k, op), n in
                          sorted(counts.items())) + f" [{card}]")
        for k in kernels:
            check(any(kk == k for kk, _ in counts),
                  f"{k}: no HMMA/HGMMA instruction in its SASS")
    for name, kernels in F32_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {k: {"FFMA": 0, "HMMA": 0} for k in kernels}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = next((k for k in kernels if k in line), None)
            elif fn is not None:
                for op in ("FFMA", "HMMA", "HGMMA"):
                    if op in line:
                        counts[fn][op[:4] if op != "HGMMA" else "HMMA"] += 1
        print(f"f32 cluster design in {name}: "
              + ", ".join(f"{k} FFMA x{c['FFMA']}, HMMA/HGMMA x{c['HMMA']}"
                          for k, c in counts.items()) + f" [{card}]")
        for k, c in counts.items():
            check(c["FFMA"] > 0 and c["HMMA"] == 0,
                  f"{k}: the f32 design must run FFMA and no tensor-core "
                  f"instruction: {c}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, launches: int, repeats: int = REPEATS,
              queue_ahead: bool = True) -> float:
    """Median over ``repeats`` of the device time per call of ``fn``, from
    CUDA events around ``launches`` calls. With ``queue_ahead`` the card
    first spins for a while so the host queues every call before the
    first runs: the events then time the device alone, not the host's
    launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


# ------------------------------------------------------------ the main path


class ProxyGrid:
    """bench.py's stand-in grid for 21,600 columns: latitude bands with a
    little jitter, unit mass weights, no area weights."""

    def __init__(self, nlat, nlon, nlev, device):
        rng = np.random.default_rng(0)
        ncol = nlat * nlon
        self.lat = np.repeat(np.linspace(-88, 88, nlat), nlon) \
            + rng.uniform(-0.1, 0.1, ncol)
        self.lon = np.tile(np.linspace(0, 360 - 360 / nlon, nlon), nlat)
        self.nlev = nlev
        self.device = device

    def mass_weights(self, ps):
        return torch.ones((ps.shape[0], self.nlev), device=ps.device)

    def layer_thickness(self, ps):
        return torch.full((ps.shape[0], self.nlev), 1e3, device=ps.device)


def make_model(policy, device, seed=0, arm="v6", H=192):
    """bench.py's emulator (nx 6, nneur 192/192, nh_mem 16) with the
    arm's flags (or another hidden width H)."""
    from climsim_tpu_torch.models import RNNAutoreg
    flags = {"use_pallas": True, **ARMS[arm][0]}
    return RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(H, H),
                      nh_mem=16, add_pres=False, policy=policy,
                      device=device, seed=seed, **flags)


def flat_spacing(nlat, nlon):
    """A flat raster's cell sizes (dx, dy) in m: the proxy grid's mean
    zonal and meridional spacing, 2 pi a / nlon and pi a / nlat."""
    from climsim_tpu_torch.constants import EARTH_RADIUS
    return 2 * np.pi * EARTH_RADIUS / nlon, np.pi * EARTH_RADIUS / nlat


def make_loop(model, grid, nlat, nlon, device, arm="v6"):
    """bench.py's step: normalise -> model -> scale, inside the hybrid
    loop in the arm's configuration (by default the production step: the
    fused spherical stencil and both fixers)."""
    from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
    dev = next(model.parameters()).device
    over = dict(ARMS[arm][1])
    if over.get("geometry") == "flat":
        over["dx"], over["dy"] = flat_spacing(nlat, nlon)
    cfg = HostLoopConfig(**{**dict(nlat=nlat, nlon=nlon, scheme="fv",
                                   geometry="sphere", use_pallas=True,
                                   fix_water=True, fix_energy=True,
                                   emulator_level_major=True), **over})
    col = (lambda t: t[:, None]) if cfg.emulator_level_major else \
        (lambda t: t)
    xsc = col(torch.tensor(XSCALE, device=dev))
    ysc = col(torch.tensor(YSCALE, device=dev))

    def emulator(x_main_raw, x_sfc_raw, mem):
        out, out_sfc, mem = model(x_main_raw / xsc, x_sfc_raw, mem)
        return out * ysc, out_sfc, mem

    return HybridLoop(emulator, grid, cfg, device=device)


def initial_state(ncol, nlev, device, level_major=True, lat=None):
    """bench.py's initial state (np.random.default_rng(1)); the memory in
    the emulator contract's layout. Given the columns' latitudes ``lat``
    (degrees), the winds are a smooth flow instead: a zonal jet u = 10 m/s
    cos(lat) and a Hadley-like meridional cell v = 3 m/s sin(2 lat)."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    state = {
        "T": t(rng.uniform(220, 300, (ncol, nlev))),
        "qv": t(np.abs(rng.normal(1e-3, 3e-4, (ncol, nlev)))),
        "qc": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
        "qi": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
        "u": t(rng.normal(0, 10, (ncol, nlev))),
        "v": t(rng.normal(0, 3, (ncol, nlev))),
    }
    if lat is not None:
        phi = np.deg2rad(np.asarray(lat, np.float64))[:, None]
        state["u"] = t(np.repeat(10 * np.cos(phi), nlev, axis=1))
        state["v"] = t(np.repeat(3 * np.sin(2 * phi), nlev, axis=1))
    mem = torch.zeros((nlev, 16, ncol) if level_major else
                      (ncol, nlev, 16), device=device)
    x_sfc = torch.cat([torch.full((ncol, 1), 1e5), torch.ones((ncol, 23))],
                      dim=1).to(device)
    return state, mem, x_sfc


def smooth_lat(arm, grid):
    """The columns' latitudes where the arm's winds start smooth (with
    vertical advection), else None."""
    if not ARMS[arm][1].get("vertical_advection"):
        return None
    lat = grid.lat
    return lat.cpu().numpy() if isinstance(lat, torch.Tensor) else lat


def all_wrappers() -> dict:
    """Every kernel wrapper of the port, by id, for its launch counter."""
    from climsim_tpu_torch import ops
    return {"b1": ops.fused_bigru_heads_init_cm,
            "b2": ops.fv_advect_tracers_sphere, "b3": ops.bigru_heads_cm_bwd,
            "b4": ops.fused_bigru_heads_cm, "b5": ops.fv_advect_tracers,
            "b6": ops.fv_advect_levels, "b7": ops.fused_bigru_lbh,
            "b8": ops.bigru_bwd_lbh, "b9": ops.fused_bigru_heads_lbh,
            "b10": ops.fused_bigru_heads_init_lbh,
            "b11": ops.adding_sw_fast, "b12": ops.lw_solver_noscat_fast,
            "b13": ops.adding_sw_bwd, "b14": ops.lw_solver_noscat_bwd}


def run_arm(arm, card):
    """One serving arm at 21,600 columns: N_STEPS coupled steps with every
    launch counter set to 0 just before and read just after. Each of the
    arm's kernels must launch its count per step and no other kernel at
    all; the state must stay finite with mean T in [150, 350] K. Returns
    (loop, inputs, launches)."""
    from climsim_tpu_torch.models import BF16
    ncol = NLAT * NLON
    dev = torch.device("cuda")
    model = make_model(BF16, None, arm=arm)     # device=None: the card
    grid = ProxyGrid(NLAT, NLON, NLEV, dev)
    loop = make_loop(model, grid, NLAT, NLON, None, arm)
    inputs = initial_state(ncol, NLEV, dev, model.level_major,
                           smooth_lat(arm, grid))
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    st, mem, diags = loop.rollout(*inputs, N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    want = {k: n * N_STEPS for k, n in ARMS[arm][2].items()}
    print(f"serving arm {arm} ({model.arm} emulator): {N_STEPS} coupled "
          f"steps at {ncol} columns in {wall:.3f} s (first run); launches "
          f"{launches} [{card}]")
    check(launches == want, f"arm {arm}: launches {launches}, want {want}")
    for k, v in st.items():
        check(bool(torch.isfinite(v).all()), f"arm {arm}: state {k}")
    check(bool(torch.isfinite(mem).all()), f"arm {arm}: mem not finite")
    mean_t = diags["mean_T"].cpu()
    check(bool(((mean_t > 150) & (mean_t < 350)).all()),
          f"arm {arm}: mean_T out of [150, 350] K: {mean_t.tolist()}")
    print(f"serving arm {arm}: mean_T {mean_t[0].item():.4f} -> "
          f"{mean_t[-1].item():.4f} K")
    return loop, inputs, launches


# ------------------------------------------------------------ phase 2


def b1_args(model, B, dtype, seed):
    """Random activations at the main path's shapes with the model's
    (lecun-normal) weights, in the layout the fused layer passes."""
    layer = model.bigru_fused
    g = torch.Generator().manual_seed(seed)
    H, L = layer.hidden, NLEV
    dev = next(model.parameters()).device
    r = lambda *s: torch.randn(s, generator=g).to(dev, dtype)
    tw = lambda t: t.detach().to(dtype).t()
    tb = lambda t: t.detach().to(dtype)[:, None]
    CH = layer.init_width
    return (r(L, 6, B), 0.5 * r(L, 16, B), torch.tanh(r(H, B)),
            torch.tanh(r(H, B)), tw(layer.w_init), tb(layer.b_init),
            tw(layer.win1[:CH]), tw(layer.win1[CH:]), tb(layer.bin1),
            tw(layer.whh_up), tb(layer.bhh_up), tw(layer.win2),
            tb(layer.bin2), tw(layer.whh_dn), tb(layer.bhh_dn),
            tw(layer.wlat), tb(layer.blat), tw(layer.wout), tb(layer.bout))


def max_err(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def check_b1(model, card):
    """B1 against its plain version on the card. f32 is held to a tight
    tolerance (summation order only, amplified by the 120 recurrent
    steps); bf16 to 4x the plain version's own bf16-vs-f32 error on the
    same inputs, since a 60-level recurrence magnifies honest rounding
    differences: both outputs are rounded to bf16, so where the plain
    version's own error is the half-ulp rounding of its outputs, a one-ulp
    flip between kernel and plain is already 2x that."""
    from climsim_tpu_torch.ops import (bigru_heads_init_cm_reference as ref,
                                       fused_bigru_heads_init_cm as kern)
    errs = []
    for B in (NLAT * NLON, 1000):
        a32 = b1_args(model, B, torch.float32, seed=B)
        got, want = kern(*a32), ref(*a32)
        e = max_err(got, want)
        scale = max(t.abs().max().item() for t in want)
        print(f"B1 f32 (CUDA-core design) B={B}: max_abs_err {e:.3e} "
              f"(outputs up to "
              f"{scale:.3f}; tolerance 1e-5 + 1e-5*|x|) [{card}]")
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        errs.append(e)
        a16 = tuple(t.to(torch.bfloat16) for t in a32)
        got16, want16 = kern(*a16), ref(*a16)
        e16 = max_err(got16, want16)
        own = max_err(want16, ref(*(t.float() for t in a16)))
        print(f"B1 bf16 (tensor-core design) B={B}: max_abs_err "
              f"{e16:.3e}, plain bf16-vs-f32 "
              f"{own:.3e}; tolerance 4x that [{card}]")
        check(e16 <= 4.0 * own, f"B1 bf16 B={B}: {e16} > 4 x {own}")
        errs.append(e16)
    return max(errs)


def check_fv_design(card, kind, wrapper, call, first, got, shape):
    """B2 (kind "b2"), B5 ("b5") or B6 ("b6") at shape (ntrac, L, nlat,
    nlon) after
    a wrapper call that gave ``got``: the design it launched is the one
    fv_design names, the band tile at every shape this script runs; a
    second call is bit-identical; the kernel's own shared-memory size
    (csrc's Geom::smem, <entry>_smem) is fv_design's; and the first
    design, which the timings use, is within the gate 1e-5 + 1e-5*|x| of
    the tile (both contract a*b+c into FMAs as nvcc chooses, so they need
    not agree bit for bit). Returns the tile's max_abs_err against the
    first design."""
    import ctypes
    from climsim_tpu_torch.ops import _build, pallas_stencil as pst
    d = pst.fv_design(kind, *shape, sms=torch.cuda.get_device_properties(
        0).multi_processor_count)
    check(wrapper.design == d["design"] == "tile",
          f"{kind} {shape}: launched the {wrapper.design} design, "
          f"fv_design names {d['design']}")
    same = torch.equal(got, call())
    src = "fv_tracers_sphere" if kind == "b2" else "fv_tracers_flat"
    entry = src + "_tile"
    smem_of = getattr(_build.load(src), entry + "_smem")
    smem_of.restype = ctypes.c_longlong
    kernel_smem = smem_of(shape[0], shape[3], d["R"])
    old = first()
    e = (got - old).abs().max().item()
    print(f"{kind.upper()} {shape}: tile design (R {d['R']}, {d['groups']} "
          f"groups of {d['threads'] // d['groups']} threads, {d['blocks']} "
          f"CTAs, {d['smem']} bytes of shared memory; the kernel's own "
          f"{kernel_smem}), a second call "
          f"bit-identical {same}; against the first design max_abs_err "
          f"{e:.3e} [{card}]")
    check(same, f"{kind} {shape}: two calls differ")
    check(kernel_smem == d["smem"], f"{kind} {shape}: the kernel's shared "
          f"memory {kernel_smem} is not fv_design's {d['smem']}")
    torch.testing.assert_close(got, old, rtol=1e-5, atol=1e-5)
    return e


def check_b2(loop, card):
    """B2 against its plain version on the card at (6, 60, 120, 180) and on
    the 384-column grid's (6, 60, 16, 24), with winds strong enough to hit
    the Courant clip in both sweeps. nvcc contracts a*b+c into FMAs, so the
    two differ by a few ulps: tolerance 1e-5 + 1e-5*|x| on fields of order
    1. Each shape also goes through check_fv_design. Returns the worst
    max_abs_err against the plain version and the inputs of both shapes."""
    from climsim_tpu_torch.constants import DT_STEP
    from climsim_tpu_torch.online.advection import (metric_rows,
                                                    spherical_metric)
    from climsim_tpu_torch.ops import (first_fv_tracers_sphere,
                                       fv_advect_tracers_sphere as kern,
                                       fv_tracers_sphere_reference as ref)
    dev = loop.device
    lo_rows = metric_rows(spherical_metric(np.linspace(-88, 88, LO_NLAT),
                                           LO_NLON, DT_STEP), dev)
    worst, inputs = 0.0, []
    for (nlat, nlon), rows in (((NLAT, NLON), loop.metric_rows),
                               ((LO_NLAT, LO_NLON), lo_rows)):
        g = torch.Generator().manual_seed(2)
        qs = (1 + 0.3 * torch.randn((6, NLEV, nlat, nlon),
                                    generator=g)).to(dev)
        scale = NLAT / nlat
        u = (60 * scale * torch.randn((NLEV, nlat, nlon),
                                      generator=g)).to(dev)
        v = (100 * scale * torch.randn((NLEV, nlat, nlon),
                                       generator=g)).to(dev)
        cz = (u * rows.dtdx[:, None]).abs() > rows.cfl_max
        cm = (v * rows.cf_fac[:nlat, None]).abs() > rows.cfl_max
        check(bool(cz.any()) and bool(cm.any()),
              "the Courant clip never binds")
        call = lambda: kern(qs, u, v, rows)
        got, want = call(), ref(qs, u, v, rows)
        e = (got - want).abs().max().item()
        print(f"B2 {tuple(qs.shape)}: max_abs_err {e:.3e}; clipped zonal "
              f"{cz.float().mean().item():.3f}, meridional "
              f"{cm.float().mean().item():.3f} of faces [{card}]")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        check_fv_design(card, "b2", kern, call,
                        lambda: first_fv_tracers_sphere(qs, u, v, rows),
                        got, tuple(qs.shape))
        worst = max(worst, e)
        inputs.append((qs, u, v, rows))
    return worst, inputs


def b3_args(model, B, dtype, seed):
    """Residuals and cotangents of the backward at the training shapes:
    the model's weights as the fused layer passes them, a tanh stream x
    [L, H, B] (the initial MLP's output), random memory and h0s."""
    layer = model.bigru_fused
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    H, L = layer.hidden, NLEV
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    tw = lambda t: t.detach().to(dtype).t()
    tb = lambda t: t.detach().to(dtype)[:, None]
    CH = layer.init_width
    nm = layer.nh_mem
    res = (torch.tanh(r(L, H, B)), 0.5 * r(L, nm, B), torch.tanh(r(H, B)),
           torch.tanh(r(H, B)), tw(layer.win1[:CH]), tw(layer.win1[CH:]),
           tb(layer.bin1), tw(layer.whh_up), tb(layer.bhh_up),
           tw(layer.win2), tb(layer.bin2), tw(layer.whh_dn),
           tb(layer.bhh_dn), tw(layer.wlat), tb(layer.blat),
           tw(layer.wout), tb(layer.bout))
    return res, r(L, nm + layer.ny, B), r(H, B)


B3_NAMES = ("dx", "dmem", "dh0u", "dh0d", "dwin1h", "dwin1m", "dbin1",
            "dwhh_up", "dbhh_up", "dwin2", "dbin2", "dwhh_dn", "dbhh_dn",
            "dwlat", "dblat", "dwout", "dbout")


def rel_err(got, want) -> float:
    """Largest |got - want| relative to the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def bf16_ok(got, want, want32):
    """check_b1's bf16 check, per tensor: the difference from the plain
    bf16 result may be 4x the plain version's own bf16-vs-f32 difference,
    plus 1e-3 of the tensor's scale (a quarter of a bf16 ulp) for a tensor
    whose own difference happens to be tiny. Returns (ok, err, own)."""
    own = (want.float() - want32.float()).abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err <= 4.0 * own + 1e-3 * want32.float().abs().max().item(), \
        err, own


def check_b3(model, card):
    """B3 against its plain version on the card at the training shapes, at
    21,600 columns and at a ragged 1,000, every one of its 17 outputs. f32:
    2e-5 of each output's largest magnitude (summation order over 240
    recurrent levels and the 1.3 M-term gradient sums; measured on an H100:
    5.2e-6 at 21,600 columns); bf16: as check_b1, per output."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_bwd as kern,
                                       bigru_heads_cm_bwd_reference as ref)
    errs = []
    for B in (NLAT * NLON, 1000):
        res, dom, dlh = b3_args(model, B, torch.float32, seed=B)
        got, want = kern(res, dom, dlh), ref(res, dom, dlh)
        rel = [rel_err(g, w) for g, w in zip(got, want)]
        worst = int(np.argmax(rel))
        print(f"B3 f32 (CUDA-core design) B={B}: worst relative error "
              f"{rel[worst]:.3e} "
              f"({B3_NAMES[worst]}); tolerance 2e-5 of each output's "
              f"scale [{card}]")
        for name, e in zip(B3_NAMES, rel):
            check(e <= 2e-5, f"B3 f32 B={B} {name}: {e:.3e}")
        errs.append(max_err(got, want))
        del got, want
        r16 = tuple(t.to(torch.bfloat16) for t in res)
        d16 = (dom.to(torch.bfloat16), dlh.to(torch.bfloat16))
        got16, want16 = kern(r16, *d16), ref(r16, *d16)
        want32 = ref(tuple(t.float() for t in r16), *(t.float() for t in d16))
        ratio = 0.0
        for name, g, w, w32 in zip(B3_NAMES, got16, want16, want32):
            ok, e16, own = bf16_ok(g, w, w32)
            check(ok, f"B3 bf16 B={B} {name}: {e16:.3e} > 4 x {own:.3e}")
            ratio = max(ratio, e16 / max(own, 1e-30))
        print(f"B3 bf16 (tensor-core design) B={B}: difference up to "
              f"{ratio:.3f} x the plain "
              f"version's own bf16-vs-f32 error (tolerance 4x) [{card}]")
        errs.append(max_err(got16, want16))
        del got16, want16, want32
    return max(errs)


def b3_bound(res):
    """Least time for B3's work from its shapes: multiply-adds of phases A
    (replay), B (heads + down BPTT + their weight gradients) and C (up
    BPTT + its weight gradients) at the bf16 tensor-core peak, against
    each input read once and each output written once."""
    x, mem_in = res[0], res[1]
    L, CH, B = x.shape
    nm_in, H = mem_in.shape[1], res[7].shape[1]
    nm, ny = res[13].shape[0], res[15].shape[0]
    macs = (3 * H * (CH + nm_in) + 9 * H * H                  # A
            + 12 * H * H + 3 * nm * H + 2 * ny * nm          # B
            + 6 * H * H + 6 * H * (CH + nm_in))              # C
    flops = 2.0 * macs * L * B
    n_in = sum(t.numel() for t in res) + L * (nm + ny) * B + H * B
    n_out = x.numel() + mem_in.numel() + 2 * H * B \
        + sum(t.numel() for t in res[4:])
    nbytes = float(x.element_size() * (n_in + n_out))
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops > t_bytes else "bytes", flops, nbytes


def kernel_split(fn, event_ms, card, label):
    """Every device kernel of one call of ``fn`` by name (torch.profiler's
    full kernel list, no name filter) and their sum beside the call's
    CUDA-event time, so a kernel missing from the profile shows as a gap
    between the two. The profile records device activity alone: with CPU
    activity as well (``profile_kernels``), B3's main kernel, launched
    from ctypes, went missing from the key averages."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):          # once more where the profile came back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(((ev.key, ev.device_time_total / 1e3)
                          for ev in prof.key_averages()
                          if ev.device_time_total > 0), key=lambda kv: -kv[1])
        if kernels:
            break
    busy = sum(ms for _, ms in kernels)
    if busy <= 0:
        print(f"{label} by kernel: the profiler saw no device time: not "
              f"measured [{card}]")
        return
    print(f"{label} by kernel, one call (torch.profiler device time): "
          + "; ".join(f"{k[:60]} {ms:.4f} ms" for k, ms in kernels)
          + f"; sum {busy:.4f} ms against {event_ms:.4f} ms from CUDA "
          f"events [{card}]")


def in_turns(old, new, launches, repeats=3):
    """Device ms per call of two versions of one function, timed in turns
    (old, new, new, old) with CUDA events: ([old, old], [new, new])."""
    t = {old: [], new: []}
    for fn in (old, new, new, old):
        t[fn].append(median_ms(fn, launches, repeats=repeats))
    return t[old], t[new]


def designs_in_turns(name, cudacore, tensor_core, card, launches=3,
                     repeats=3, new="tensor-core", dt="bf16") -> float:
    """A kernel's CUDA-core design and its redesign (bf16: the tensor-core
    design; f32 B7 and B8: the cluster FFMA design) at 21,600 columns
    timed in turns and printed; returns the redesign's mean ms."""
    old, nw = in_turns(cudacore, tensor_core, launches, repeats)
    print(f"{name} {dt} at {NLAT * NLON} columns in turns (CUDA-core, "
          f"{new}, {new}, CUDA-core): CUDA-core design "
          f"{old[0]:.4f} / {old[1]:.4f} ms, {new} design {nw[0]:.4f} "
          f"/ {nw[1]:.4f} ms [{card}]")
    return statistics.mean(nw)


@contextlib.contextmanager
def tiles_in_scratch():
    """Inside, the CUDA-core designs keep their tiles in device scratch at
    every width (their mode past the widths whose tiles fit a block's
    shared memory): for timing that mode against shared memory."""
    from climsim_tpu_torch.ops import pallas_rnn as pr
    saved = pr._tile_scratch

    def scratch(kind, dims, B, dev):
        rows = pr.cudacore_rows(kind, *dims)
        return torch.empty((-(-B // 32), rows, 32), dtype=torch.float32,
                           device=dev)

    pr._tile_scratch = scratch
    try:
        yield
    finally:
        pr._tile_scratch = saved


def b4_args(model, B, dtype, seed):
    """B4's arguments at the v5 arm's shapes: a tanh stream x [L, 192, B]
    (the initial MLP's output), random memory and h0s, and the v5 model's
    (lecun-normal) weights in the layout the fused layer passes."""
    layer = model.bigru_fused
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    H, L, CH = layer.hidden, NLEV, layer.ch
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    tw = lambda t: t.detach().to(dtype).t()
    tb = lambda t: t.detach().to(dtype)[:, None]
    return (torch.tanh(r(L, CH, B)), 0.5 * r(L, layer.nm_in, B),
            torch.tanh(r(H, B)), torch.tanh(r(H, B)), tw(layer.win1[:CH]),
            tw(layer.win1[CH:]), tb(layer.bin1), tw(layer.whh_up),
            tb(layer.bhh_up), tw(layer.win2), tb(layer.bin2),
            tw(layer.whh_dn), tb(layer.bhh_dn), tw(layer.wlat),
            tb(layer.blat), tw(layer.wout), tb(layer.bout))


def check_b4(model, card):
    """B4 against its plain version on the card at the v5 arm's shapes,
    at 21,600 and a ragged 1,000 columns, with the projections hoisted
    (rounded to the storage type, the serving default) and not (f32). f32
    (the CUDA-core design) to 1e-5 + 1e-5*|x| as B1 (in f32 the two
    variants are one function); bf16 (the tensor-core design) to 4x the
    plain version's own bf16-vs-f32 error, as check_b1."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference as ref,
                                       fused_bigru_heads_cm as kern)
    errs = []
    for B in (NLAT * NLON, 1000):
        a32 = b4_args(model, B, torch.float32, seed=B + 2)
        a16 = tuple(t.to(torch.bfloat16) for t in a32)
        for hoist in (True, False):
            got = kern(*a32, hoist_proj=hoist)
            want = ref(*a32, hoist_proj=hoist)
            e = max_err(got, want)
            print(f"B4 f32 (CUDA-core design) B={B} hoist_proj={hoist}: "
                  f"max_abs_err {e:.3e}; tolerance 1e-5 + 1e-5*|x| [{card}]")
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
            errs.append(e)
            got16 = kern(*a16, hoist_proj=hoist)
            want16 = ref(*a16, hoist_proj=hoist)
            e16 = max_err(got16, want16)
            own = max_err(want16, ref(*(t.float() for t in a16),
                                      hoist_proj=hoist))
            print(f"B4 bf16 (tensor-core design) B={B} hoist_proj={hoist}: "
                  f"max_abs_err {e16:.3e}, plain bf16-vs-f32 {own:.3e} "
                  f"({e16 / max(own, 1e-30):.3f}x; tolerance 4x) [{card}]")
            check(e16 <= 4.0 * own, f"B4 bf16 B={B} hoist {hoist}: {e16} "
                  f"> 4 x {own}")
            errs.append(e16)
        del a32, a16, got, want, got16, want16
    return max(errs)


def b9_args(model, B, dtype, seed):
    """B9's arguments at the v3 arm's shapes: x [L, B, 208] = a tanh stream
    (the initial MLP's 192 channels) || random memory (16), level-major,
    tanh h0s, and the v3 model's (lecun-normal) weights as the fused layer
    passes them ([in, out], flat biases)."""
    layer = model.bigru_fused
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    H, nm = layer.hidden, layer.nh_mem
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    w = lambda t: t.detach().to(dtype)
    x = torch.cat([torch.tanh(r(NLEV, B, layer.win1.shape[0] - nm)),
                   0.5 * r(NLEV, B, nm)], dim=-1)
    return (w(x), w(torch.tanh(r(B, H))), w(torch.tanh(r(B, H))),
            *(w(getattr(layer, k)) for k in HEADS_WEIGHTS))


def b10_args(model, B, dtype, seed):
    """B10's arguments at the v4 arm's shapes: raw features [L, B, 6] and
    memory [L, B, 16], level-major, tanh h0s, and the v4 model's weights
    (the initial MLP's w_init [6, 192] and b_init first)."""
    layer = model.bigru_fused
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    H = layer.hidden
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    w = lambda t: t.detach().to(dtype)
    return (w(r(NLEV, B, layer.w_init.shape[0])),
            w(0.5 * r(NLEV, B, layer.nh_mem)), w(torch.tanh(r(B, H))),
            w(torch.tanh(r(B, H))), w(layer.w_init), w(layer.b_init),
            *(w(getattr(layer, k)) for k in HEADS_WEIGHTS))


# the fused layer's weights after the up projection's input, in the order
# the v3/v4 wrappers take them
HEADS_WEIGHTS = ("win1", "bin1", "whh_up", "bhh_up", "win2", "bin2",
                 "whh_dn", "bhh_dn", "wlat", "blat", "wout", "bout")


def check_b9_b10(models, card):
    """B9 (v3) and B10 (v4) against their plain versions on the card at the
    arms' shapes, at 21,600 and a ragged 1,000 columns (not a multiple of
    the 32-column tile). f32 to 1e-5 + 1e-5*|x| (summation order only,
    through the 120 recurrent levels), bf16 to 4x the plain version's own
    bf16-vs-f32 error, as check_b1. Returns the largest errors by id."""
    from climsim_tpu_torch.ops import (bigru_heads_init_lbh_reference,
                                       bigru_heads_lbh_reference,
                                       fused_bigru_heads_init_lbh,
                                       fused_bigru_heads_lbh)
    errs = {}
    for key, name, args_fn, kern, ref in (
            ("b9", "B9", b9_args, fused_bigru_heads_lbh,
             bigru_heads_lbh_reference),
            ("b10", "B10", b10_args, fused_bigru_heads_init_lbh,
             bigru_heads_init_lbh_reference)):
        model = models[key]
        errs[key] = 0.0
        for B in (NLAT * NLON, 1000):
            a32 = args_fn(model, B, torch.float32, seed=B + 3)
            got, want = kern(*a32), ref(*a32)
            e = max_err(got, want)
            print(f"{name} f32 (CUDA-core design) B={B}: max_abs_err "
                  f"{e:.3e}; tolerance 1e-5 + 1e-5*|x| [{card}]")
            for x, y in zip(got, want):
                check(x.shape == y.shape and x.is_contiguous(),
                      f"{name} output layout")
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
            a16 = tuple(t.to(torch.bfloat16) for t in a32)
            got16, want16 = kern(*a16), ref(*a16)
            e16 = max_err(got16, want16)
            own = max_err(want16, ref(*(t.float() for t in a16)))
            print(f"{name} bf16 (tensor-core design) B={B}: max_abs_err "
                  f"{e16:.3e}, plain bf16-vs-f32 {own:.3e}; tolerance 4x "
                  f"that [{card}]")
            check(e16 <= 4.0 * own, f"{name} bf16 B={B}: {e16} > 4 x {own}")
            errs[key] = max(errs[key], e, e16)
            del a32, a16, got, want, got16, want16
    return errs


def check_flat(card):
    """B5 at (6, 60, 120, 180) and B6 at (60, 120, 180), f32, against their
    plain version on the card, on the flat arm's raster (flat_spacing,
    dt 1200 s) with winds of 60 and 40 m/s rms, whose Courant numbers
    reach past 1 (the flat stencil has no clip). nvcc contracts a*b+c into
    FMAs: tolerance 1e-5 + 1e-5*|x|, as B2. B5 and B6 also go through
    check_fv_design, and B5 on each tracer must equal B6 on that field
    alone bit for bit (one compiled tile kernel, the Flat form). Returns
    (errors, inputs)."""
    from climsim_tpu_torch.constants import DT_STEP
    from climsim_tpu_torch.ops import (first_fv_levels_flat,
                                       first_fv_tracers_flat,
                                       fv_advect_levels, fv_advect_tracers,
                                       fv_tracers_reference as ref)
    dx, dy = flat_spacing(NLAT, NLON)
    dt_dx, dt_dy = DT_STEP / dx, DT_STEP / dy
    g = torch.Generator(device="cuda").manual_seed(21)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    qs = 1 + 0.3 * r(6, NLEV, NLAT, NLON)
    u, v = 60 * r(NLEV, NLAT, NLON), 40 * r(NLEV, NLAT, NLON)
    courant = max((u * dt_dx).abs().max().item(),
                  (v * dt_dy).abs().max().item())
    errs, outs = {}, {}
    for name, kern, first, q in (
            ("B5", fv_advect_tracers, first_fv_tracers_flat, qs),
            ("B6", fv_advect_levels, first_fv_levels_flat,
             qs[0].contiguous())):
        got, want = kern(q, u, v, dt_dx, dt_dy), ref(q, u, v, dt_dx, dt_dy)
        errs[name] = (got - want).abs().max().item()
        print(f"{name} {tuple(q.shape)}: max_abs_err {errs[name]:.3e}; "
              f"Courant numbers up to {courant:.2f} [{card}]")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        check_fv_design(card, name.lower(), kern,
                        lambda: kern(q, u, v, dt_dx, dt_dy),
                        lambda: first(q, u, v, dt_dx, dt_dy), got,
                        tuple(q.shape) if q.ndim == 4 else (1, *q.shape))
        outs[name] = got
    same = [torch.equal(outs["B5"][t], fv_advect_levels(
        qs[t].contiguous(), u, v, dt_dx, dt_dy)) for t in range(len(qs))]
    print(f"B5 against B6 tracer by tracer (both the tile): bit-identical "
          f"{same} [{card}]")
    check(all(same), f"B5's tracers differ from B6 on the same fields: "
          f"{same}")
    return errs, (qs, u, v, dt_dx, dt_dy)


def time_fv_designs(card, name, args):
    """B2 (``args`` = (qs, u, v, rows)), B5 ((qs, u, v, dt_dx, dt_dy)) or
    B6 ((q, u, v, dt_dx, dt_dy)) through its wrapper, the band tile at
    this script's shapes, in turns with its first design (first, tile,
    tile, first; 50 launches each), printed. Returns (the tile's mean ms,
    the first design's mean ms)."""
    from climsim_tpu_torch.ops import (first_fv_levels_flat,
                                       first_fv_tracers_flat,
                                       first_fv_tracers_sphere,
                                       fv_advect_levels, fv_advect_tracers,
                                       fv_advect_tracers_sphere)
    new, first = {"B2": (fv_advect_tracers_sphere, first_fv_tracers_sphere),
                  "B5": (fv_advect_tracers, first_fv_tracers_flat),
                  "B6": (fv_advect_levels, first_fv_levels_flat)}[name]
    old, nw = in_turns(lambda: first(*args), lambda: new(*args), 50)
    print(f"{name} f32 at {tuple(args[0].shape)} in turns (first, tile, "
          f"tile, first): first design {old[0]:.4f} / {old[1]:.4f} ms, "
          f"tile design {nw[0]:.4f} / {nw[1]:.4f} ms [{card}]")
    return statistics.mean(nw), statistics.mean(old)


def check_vjp_384(card, arm="v6"):
    """Gradients of every input through the arm's differentiable fused
    layer at 384 columns: for v6 fused_bigru_heads_init_cm (B1 forward,
    B3 backward), for v5 fused_bigru_heads_cm (B4 forward, B3 backward),
    for v3 and v4 fused_bigru_heads_lbh and fused_bigru_heads_init_lbh (B9
    or B10 forward; the backward replays with B7 and differentiates with
    B8), on the card against the plain versions on the CPU, f32 to 1e-4 of
    each gradient's scale, bf16 as check_b3."""
    from climsim_tpu_torch.models import F32
    from climsim_tpu_torch import ops
    model = make_model(F32, "cpu", arm=arm)
    args_fn, op = {"v6": (b1_args, ops.fused_bigru_heads_init_cm),
                   "v5": (b4_args, ops.fused_bigru_heads_cm),
                   "v3": (b9_args, ops.fused_bigru_heads_lbh),
                   "v4": (b10_args, ops.fused_bigru_heads_init_lbh)}[arm]
    a = args_fn(model, LO_NLAT * LO_NLON, torch.float32, seed=9)

    def grads(dev, dt):
        x = [t.to(dev, dt, copy=True).requires_grad_(True) for t in a]
        with torch.enable_grad():
            sum((o.float() ** 2).sum() for o in op(*x)).backward()
        return [t.grad.float().cpu() for t in x]

    cpu32 = grads("cpu", torch.float32)
    worst = max(rel_err(g, w) for g, w in zip(grads("cuda", torch.float32),
                                              cpu32))
    print(f"{arm} VJP, 384 columns, f32: card vs CPU worst relative "
          f"difference {worst:.3e} over {len(a)} gradients (tolerance "
          f"1e-4) [{card}]")
    check(worst <= 1e-4, f"{arm} VJP f32: {worst:.3e}")
    ratio = 0.0
    for i, (g, w, w32) in enumerate(zip(grads("cuda", torch.bfloat16),
                                        grads("cpu", torch.bfloat16),
                                        cpu32)):
        ok, err, own = bf16_ok(g, w, w32)
        check(ok, f"{arm} VJP bf16 gradient {i}: {err:.3e} > 4 x "
              f"{own:.3e}")
        ratio = max(ratio, err / max(own, 1e-30))
    print(f"{arm} VJP, 384 columns, bf16: card vs CPU difference up to "
          f"{ratio:.3f} x the CPU's own bf16-vs-f32 difference "
          f"(tolerance 4x) [{card}]")


def train_chunk(T, ncol, device, seed=3):
    """bench.py::build_train's data (np.random.default_rng(3), scale 0.3)
    in the trainer's layout; sp is unused by the MSE loss."""
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.as_tensor(rng.normal(0, 0.3, s).astype(np.float32))
    chunk = {"x_lev": r(T, ncol, NLEV, 6), "x_sfc": r(T, ncol, 24),
             "y_lev": r(T, ncol, NLEV, 6), "y_sfc": r(T, ncol, 8),
             "sp": torch.full((T, ncol), 1e5)}
    return {k: v.to(device) for k, v in chunk.items()}


def make_trainer(model, device):
    """bench.py::build_train's update: W 4 window, remat, MSE, Adam 1e-4,
    with a channel-major model behind the trainer's [B, L, C] layout (a
    batch-major one takes it as it is)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         channel_major_apply)
    grid = Grid.synthetic(4, NLEV)
    cfg = RolloutConfig(rollout_schedule={0: W_TRAIN}, loss="mse", lr=LR,
                        optimizer="adam", remat=True)
    return RolloutTrainer(model, cfg, grid.hyai.numpy(), grid.hybi.numpy(),
                          apply_fn=(channel_major_apply if model.level_major
                                    else None), device=device)


@contextlib.contextmanager
def b7_tiling(C, BT):
    """Inside, B7's tensor-core design runs clusters of C CTAs over BT
    columns in place of its plan's (the kernel refuses a tiling outside
    the design): for timing another tiling against the plan's."""
    from climsim_tpu_torch.ops import pallas_rnn as pr
    plan = pr.find_mma_plan
    pr.find_mma_plan = lambda kind, *a, **k: dict(plan(kind, *a, **k), C=C,
                                                  BT=BT) \
        if kind == "b7" else plan(kind, *a, **k)
    try:
        yield
    finally:
        pr.find_mma_plan = plan


@contextlib.contextmanager
def cudacore_twins():
    """Inside, bf16 B10, B7 and B8 run their CUDA-core designs (the twins
    no wrapper selects) in place of the tensor-core ones: a second card
    version of the v4 update that shares no code with the designs under
    test."""
    from climsim_tpu_torch.ops import pallas_rnn as pr
    saved = (pr._launch_heads_lbh_mma, pr._launch_lbh_mma,
             pr._launch_bwd_lbh_mma)
    pr._launch_heads_lbh_mma = lambda args, dims, init, pl: \
        pr._launch_heads_lbh(args, dims, init, cudacore_bf16=True)
    pr._launch_lbh_mma = lambda args, dims, pl: pr._launch_lbh(
        args, dims, twin=True)
    pr._launch_bwd_lbh_mma = lambda res, dd, dl, dims, pl: \
        pr._launch_bwd_lbh(res, dd, dl, dims, twin=True)
    try:
        yield
    finally:
        (pr._launch_heads_lbh_mma, pr._launch_lbh_mma,
         pr._launch_bwd_lbh_mma) = saved


def compare_train_384(card, arm="v6"):
    """One update (W 4) of the arm's model at 384 columns on the card and
    on the CPU from the same seeded model and data. f32: loss to 1e-5,
    memory and gradients to 1e-4 of their scale, parameters to 1e-5 of
    their size plus 2% of one Adam step (lr): Adam's first step moves a
    parameter by lr g/(|g| + eps), which amplifies the last bits of a
    gradient near zero by lr/eps (the tests hold the CPU update to the JAX
    one to the same 2%). bf16:
    loss, memory, gradients and each parameter's change to 4x the CPU's
    own bf16-vs-f32 difference, as check_b3; v4's parameter changes as
    v4_steps holds them."""
    from climsim_tpu_torch.models import BF16, F32
    from climsim_tpu_torch.ops import (bigru_bwd_lbh,
                                       fused_bigru_heads_init_lbh,
                                       fused_bigru_lbh)
    runs = [("f32", F32, "cuda"), ("f32", F32, "cpu"),
            ("bf16", BF16, "cuda"), ("bf16", BF16, "cpu")]
    if arm == "v4":
        runs.append(("bf16", BF16, "twin"))
    out = {}
    for name, policy, key in runs:
        dev = "cpu" if key == "cpu" else "cuda"
        model = make_model(policy, dev, arm=arm)
        p0 = {n: p.detach().float().cpu().clone()
              for n, p in model.named_parameters()}
        tr = make_trainer(model, dev)
        fused_bigru_heads_init_lbh.launches = bigru_bwd_lbh.launches = 0
        fused_bigru_lbh.launches = 0
        with torch.enable_grad(), (cudacore_twins() if key == "twin"
                                   else contextlib.nullcontext()):
            mem, rec = tr.run_epoch(
                None, [train_chunk(W_TRAIN, LO_NLAT * LO_NLON, dev, 4)], 0)
        check(rec["updates"] == 1 and np.isfinite(rec["loss"]),
              f"{arm} 384 update {name} {key}: {rec}")
        if key == "twin":
            check(fused_bigru_heads_init_lbh.launches == 0
                  and fused_bigru_lbh.launches == 0
                  and bigru_bwd_lbh.launches == 0,
                  "the twins' update launched a tensor-core design")
        prm = {n: p.detach().float().cpu()
               for n, p in model.named_parameters()}
        out[name, key] = {
            "loss": torch.tensor([rec["loss"]]), "mem": mem.float().cpu(),
            "params": prm, "steps": {n: prm[n] - p0[n] for n in prm},
            "grads": {n: p.grad.float().cpu()
                      for n, p in model.named_parameters()}}
    c, p = out["f32", "cuda"], out["f32", "cpu"]
    check(rel_err(c["loss"], p["loss"]) <= 1e-5,
          f"{arm} 384 update f32 loss {c['loss']} vs {p['loss']}")
    check(rel_err(c["mem"], p["mem"]) <= 1e-4, f"{arm} 384 update f32 memory")
    worst_g = max(rel_err(c["grads"][n], p["grads"][n]) for n in p["grads"])
    worst_p = max(((c["params"][n] - p["params"][n]).abs()
                   - 1e-5 * p["params"][n].abs()).max().item() / LR
                  for n in p["params"])
    check(worst_g <= 1e-4, f"{arm} 384 update f32 gradients {worst_g:.3e}")
    check(worst_p <= 2e-2, f"{arm} 384 update f32 parameters {worst_p:.3e} lr")
    print(f"{arm}, 384 columns, one update, f32: card vs CPU loss "
          f"{c['loss'].item():.7f} vs {p['loss'].item():.7f}; gradients "
          f"worst relative {worst_g:.3e} (tolerance 1e-4); parameters within "
          f"{max(worst_p, 0.0):.3e} lr beyond 1e-5 relative (tolerance "
          f"2e-2 lr) [{card}]")
    ratio = 0.0
    c16, p16, p32 = out["bf16", "cuda"], out["bf16", "cpu"], out["f32", "cpu"]
    twin = out.get(("bf16", "twin"))
    for key in ("loss", "mem", "steps", "grads"):
        if key == "steps" and twin is not None:
            ratio = max(ratio, v4_steps(c16, twin, p16, p32, card))
            continue
        if isinstance(p32[key], dict):
            pairs = [(c16[key][n], p16[key][n], p32[key][n], n)
                     for n in p32[key]]
        else:
            pairs = [(c16[key], p16[key], p32[key], None)]
        for g, w, w32, n in pairs:
            ok, err, own = bf16_ok(g, w, w32)
            check(ok, f"{arm} 384 update bf16 {key}"
                  f"{'' if n is None else ' ' + n}: {err:.3e} > 4 x "
                  f"{own:.3e}")
            ratio = max(ratio, err / max(own, 1e-30))
    print(f"{arm}, 384 columns, one update, bf16: card vs CPU difference "
          f"up to "
          f"{ratio:.3f} x the CPU's own bf16-vs-f32 difference over loss, "
          f"memory, parameter steps and gradients (tolerance 4x) [{card}]")


def v4_steps(c16, twin, p16, p32, card):
    """The v4 update's bf16 parameter steps, card against CPU. Adam's
    first step lr g / (|g| + eps) is a whole lr either way wherever the
    gradient's sign is rounding noise, and which of those elements a
    version flips differs from version to version: the other arms' check
    of every element against 4x the CPU's own bf16-vs-f32 difference in
    its tensor passes only where the CPU's bf16 run happens to flip an
    element of the same tensor. So the elements whose step has the other
    sign than the CPU's bf16 one, or is zero, and lies more than lr / 2
    from it are counted, each no larger than Adam's first step can be
    (lr), and their count must stay within 4x the larger of two witnesses
    that share nothing with the designs under test: the same update
    through the CUDA-core designs of B10 and B8 on the card
    (``cudacore_twins``: B10, B7 and B8), and the CPU's bf16 run against
    its f32 one.
    Every other element is held as the other arms' are. Printed beside:
    where the other arms' check and a per-element test (an element held
    where its f32 gradient exceeds 4x the CPU's and the other card
    version's difference) would fail for either card version, and the
    gradients' RMS difference from the CPU's bf16. Returns the worst ratio
    of the held steps' difference to their own."""
    runs = {"card": c16, "twins": twin}
    flips = dict.fromkeys(("card", "twins", "cpu"), 0)
    every = {k: (0.0, "") for k in runs}
    per_element = dict.fromkeys(runs, 0)
    sq, n_el, ratio = dict.fromkeys(runs, 0.0), 0, 0.0
    for n, s16 in p16["steps"].items():
        s32, g16, g32 = p32["steps"][n], p16["grads"][n], p32["grads"][n]
        tol_s = 1e-3 * s32.abs().max().item()
        # a step of the other sign or none (a gradient that sums to an
        # exact zero), more than lr / 2 away
        flip = lambda t: (t * s16 <= 0) & ((t - s16).abs() > LR / 2)
        flips["cpu"] += int(flip(s32).sum())
        n_el += s16.numel()
        for who, run in runs.items():
            s, g = run["steps"][n], run["grads"][n]
            other = runs["twins" if who == "card" else "card"]["grads"][n]
            off = flip(s)
            flips[who] += int(off.sum())
            sq[who] += float(((g - g16) ** 2).sum())
            noise = torch.maximum((g16 - g32).abs(), (other - g16).abs())
            per_element[who] += int((off & (g32.abs() > 4 * noise)).sum())
            _, err, own = bf16_ok(s, s16, s32)
            r = err / max(4 * own + tol_s, 1e-30)
            if r > every[who][0]:
                i = int((s - s16).abs().argmax())
                f = lambda t: t.flatten()[i].item()
                every[who] = (r, f"{n}[{i}]: gradient {f(c16['grads'][n]):.3e} "
                               f"/ {f(twin['grads'][n]):.3e} / {f(g16):.3e} "
                               f"/ {f(g32):.3e}, step "
                               f"{f(c16['steps'][n]):.3e} / "
                               f"{f(twin['steps'][n]):.3e} / {f(s16):.3e} / "
                               f"{f(s32):.3e}")
        off = flip(c16["steps"][n])
        big = c16["steps"][n][off].abs().max().item() if off.any() else 0.0
        check(big <= 1.001 * LR, f"v4 384 update bf16 steps {n}: a step "
              f"of {big:.3e} against Adam's first-step bound lr")
        keep = ~off
        if keep.any():
            ok, err, own = bf16_ok(c16["steps"][n][keep], s16[keep],
                                   s32[keep])
            check(ok, f"v4 384 update bf16 steps {n}: {err:.3e} > 4 x "
                  f"{own:.3e}")
            ratio = max(ratio, err / max(own, 1e-30))
    bound = 4 * max(flips["twins"], flips["cpu"])
    check(flips["card"] <= bound, f"v4 384 update bf16: {flips['card']} "
          f"steps of the other sign or zero > 4 x max({flips['twins']} "
          f"with the CUDA-core twins, {flips['cpu']} of the CPU's bf16 vs "
          f"f32)")
    rms = {k: np.sqrt(v / n_el) for k, v in sq.items()}
    print(f"v4, 384 columns, one update, bf16 parameter steps: "
          f"{flips['card']} of {n_el} of the other sign than the CPU's bf16 "
          f"ones (or zero) and more than lr / 2 away on the card (tolerance {bound}: "
          f"4 x max({flips['twins']} with the CUDA-core twins of B10, B7 and B8, {flips['cpu']} of the "
          f"CPU's bf16 against its f32), the others within {ratio:.3f} x "
          f"their own difference (tolerance 4x); the other arms' check of "
          f"every element would reach {every['card'][0]:.3f} of its "
          f"tolerance on the card (at {every['card'][1]}; card / twins / "
          f"CPU bf16 / CPU f32) and {every['twins'][0]:.3f} with the twins "
          f"(at {every['twins'][1]}); the per-element test would fail at "
          f"{per_element['card']} elements on the card and "
          f"{per_element['twins']} with the twins; gradients' RMS "
          f"difference from the CPU's bf16 {rms['card']:.3e} on the card, "
          f"{rms['twins']:.3e} with the twins [{card}]")
    return ratio


# kernels launched per window step of a training update with remat: the
# forward kernel twice (the checkpointed forward and its recompute in the
# backward) and the backward's once. v4's backward differentiates its
# composition, whose recurrent core replays with B7 and differentiates with
# B8; the scan arm launches no kernel.
TRAIN_LAUNCHES = {"v6": {"b1": 2, "b3": 1},
                  "v4": {"b10": 2, "b7": 1, "b8": 1}, "scan": {}}


def run_training(card, arm="v6", chunk=None):
    """The training path of an arm's model at 21,600 columns: one chunk of
    T_CHUNK steps, i.e. T_CHUNK / W updates, with every launch counter set
    to 0 just before and read just after; the arm's kernels must launch
    TRAIN_LAUNCHES[arm] times per window step and no other kernel at all.
    Returns (trainer, chunk, launches, updates)."""
    from climsim_tpu_torch.models import BF16
    ncol = NLAT * NLON
    model = make_model(BF16, None, arm=arm)      # device=None: the card
    trainer = make_trainer(model, None)
    if chunk is None:
        chunk = train_chunk(T_CHUNK, ncol, "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        mem, rec = trainer.run_epoch(None, [chunk], epoch=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    n = rec["updates"]
    want = {k: c * W_TRAIN * n for k, c in TRAIN_LAUNCHES[arm].items()}
    print(f"training path, arm {arm} ({model.arm} model): {n} updates "
          f"(W {W_TRAIN}, {ncol} columns) in {wall:.3f} s (first run), loss "
          f"{rec['loss']:.6f}; launches {launches} [{card}]")
    check(n == T_CHUNK // W_TRAIN, f"{n} updates")
    check(launches == want, f"arm {arm}: per update the launches must be "
          f"{ {k: c * W_TRAIN for k, c in TRAIN_LAUNCHES[arm].items()} }, "
          f"got {launches} in {n}")
    check(np.isfinite(rec["loss"]), f"loss {rec['loss']}")
    check(mem.shape == (ncol, NLEV, 16) and bool(torch.isfinite(mem).all()),
          "training memory")
    for name, p in model.named_parameters():
        check(not torch.equal(p.detach(), before[name]),
              f"{name} did not change")
    return trainer, chunk, launches, n


WIDE_H = 512


def check_wide(card):
    """The flagship model at nneur (512, 512) in bf16, past the width the
    tensor-core design holds with resident weights (its plan streams
    them): B1 and B3 at 1,000 columns against their plain versions (as
    check_b1 and check_b3, bf16) and timed; then the model serves (3
    coupled steps at 384 columns: B1 once a step, B2 once) and trains (one
    update, W 4: B1 2W, B3 W) on the card, with every counter set to 0
    just before and read just after, finite state, loss and parameters.
    Returns the kernels' ms."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.ops import (bigru_heads_cm_bwd,
                                       bigru_heads_cm_bwd_reference,
                                       bigru_heads_init_cm_reference,
                                       fused_bigru_heads_init_cm)
    from climsim_tpu_torch.ops.pallas_rnn import mma_plan
    model = make_model(BF16, None, arm="v6", H=WIDE_H)
    plans = {k: mma_plan(k, WIDE_H, WIDE_H, 16, 16, 6, 6) for k in
             ("b1", "b3")}
    check(all(p["stream"] for p in plans.values()),
          f"H {WIDE_H}: the plan must stream the weights: {plans}")
    B = 1000
    a1 = b1_args(model, B, torch.bfloat16, seed=41)
    got, want = fused_bigru_heads_init_cm(*a1), \
        bigru_heads_init_cm_reference(*a1)
    own = max_err(want, bigru_heads_init_cm_reference(
        *(t.float() for t in a1)))
    e1 = max_err(got, want)
    check(e1 <= 4.0 * own, f"B1 bf16 H {WIDE_H}: {e1} > 4 x {own}")
    a3 = b3_args(model, B, torch.bfloat16, seed=43)
    got3, want3 = bigru_heads_cm_bwd(*a3), bigru_heads_cm_bwd_reference(*a3)
    want32 = bigru_heads_cm_bwd_reference(
        tuple(t.float() for t in a3[0]), a3[1].float(), a3[2].float())
    ratio = 0.0
    for name, g, w, w32 in zip(B3_NAMES, got3, want3, want32):
        ok, e16, own3 = bf16_ok(g, w, w32)
        check(ok, f"B3 bf16 H {WIDE_H} {name}: {e16:.3e} > 4 x {own3:.3e}")
        ratio = max(ratio, e16 / max(own3, 1e-30))
    del got3, want3, want32
    ms1 = median_ms(lambda: fused_bigru_heads_init_cm(*a1), 3, repeats=3)
    ms3 = median_ms(lambda: bigru_heads_cm_bwd(*a3), 2, repeats=3)
    print(f"H {WIDE_H} bf16, {B} columns, weights streamed (B1 plan "
          f"C {plans['b1']['C']}, BT {plans['b1']['BT']}, "
          f"{plans['b1']['smem']} B smem; B3 C {plans['b3']['C']}, BT "
          f"{plans['b3']['BT']}): B1 max_abs_err {e1:.3e} against the plain "
          f"version's own bf16-vs-f32 {own:.3e} (tolerance 4x), kernel "
          f"{ms1:.4f} ms; B3 up to {ratio:.3f} x its own error (tolerance "
          f"4x), kernel {ms3:.4f} ms [{card}]")
    del a1, a3
    dev = torch.device("cuda")
    ncol = LO_NLAT * LO_NLON
    loop = make_loop(model, Grid.synthetic(ncol, NLEV, device=dev), LO_NLAT,
                     LO_NLON, None)
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    st, mem, diags = loop.rollout(*initial_state(ncol, NLEV, dev), 3)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(launches == {"b1": 3, "b2": 3},
          f"H {WIDE_H} serving: launches {launches}")
    check(all(bool(torch.isfinite(v).all()) for v in st.values())
          and bool(torch.isfinite(mem).all()), f"H {WIDE_H} serving state")
    trainer = make_trainer(model, None)
    for w in wrappers.values():
        w.launches = 0
    with torch.enable_grad():
        _, rec = trainer.run_epoch(
            None, [train_chunk(W_TRAIN, ncol, "cuda", 4)], 0)
    torch.cuda.synchronize()
    tl = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(tl == {"b1": 2 * W_TRAIN, "b3": W_TRAIN},
          f"H {WIDE_H} training: launches {tl}")
    check(rec["updates"] == 1 and np.isfinite(rec["loss"]),
          f"H {WIDE_H} training: {rec}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"H {WIDE_H} training: parameters")
    print(f"H {WIDE_H} bf16 RNNAutoreg (v6): 3 coupled steps at {ncol} "
          f"columns, launches {launches}, mean_T "
          f"{diags['mean_T'][-1].item():.4f} K; one training update (W "
          f"{W_TRAIN}), launches {tl}, loss {rec['loss']:.6f} [{card}]")


# the width phase: every GRU kind at the widths its earlier designs
# refused (bf16 past the tensor-core plan's H 832, B7 and B8 also past
# 960; f32 past the CUDA-core tiles' shared memory), with the arm whose
# fused layer passes the kind its weights
WIDTH_ARMS = {"b1": "v6", "b3": "v6", "b4": "v5", "b7": "v2", "b8": "v2",
              "b9": "v3", "b10": "v4"}
WIDTH_CASES = ([(k, torch.bfloat16, H) for k in WIDTH_ARMS
                for H in ((840, 968) if k in ("b7", "b8") else (840,))]
               + [(k, torch.float32, H) for k in WIDTH_ARMS
                  for H in (384, 512)])
WIDTH_B = 1000


def width_case(kind, model, dtype, seed):
    """(wrapper, plain version, arguments, is a backward) of one GRU kind
    at the model's width, L 60 and WIDTH_B columns, from the arm's
    (lecun-normal) weights."""
    from climsim_tpu_torch import ops
    B = WIDTH_B
    if kind == "b1":
        return (ops.fused_bigru_heads_init_cm,
                ops.bigru_heads_init_cm_reference,
                b1_args(model, B, dtype, seed), False)
    if kind == "b3":
        return (ops.bigru_heads_cm_bwd, ops.bigru_heads_cm_bwd_reference,
                b3_args(model, B, dtype, seed), True)
    if kind == "b4":
        return (ops.fused_bigru_heads_cm, ops.bigru_heads_cm_reference,
                b4_args(model, B, dtype, seed), False)
    if kind == "b7":
        return (ops.fused_bigru_lbh, ops.bigru_reference_lbh,
                b7_args(model, B, dtype, seed, L=NLEV), False)
    if kind == "b8":
        return (ops.bigru_bwd_lbh, ops.bigru_bwd_reference_lbh,
                b8_args(model, B, dtype, seed, L=NLEV), True)
    if kind == "b9":
        return (ops.fused_bigru_heads_lbh, ops.bigru_heads_lbh_reference,
                b9_args(model, B, dtype, seed), False)
    return (ops.fused_bigru_heads_init_lbh,
            ops.bigru_heads_init_lbh_reference,
            b10_args(model, B, dtype, seed), False)


def check_widths(card):
    """Every GRU kind at WIDTH_B columns and L 60 against its plain
    version, in bf16 at H 840 (B7 and B8 also 968) and in f32 at H 384 and
    512, under the existing gates (f32 forwards 1e-5 + 1e-5*|x|, backwards
    2e-5 of each output's scale; bf16 4x the plain version's own
    bf16-vs-f32 error), each printed with the design the selector chose,
    its time (CUDA events) and its launch count. Then one v6 RNNAutoreg
    update (W 4, 384 columns) and one PhysicalRNNAutoreg(use_pallas=True)
    update (W 3, 384 columns) at f32 nneur (384, 384), with their
    launches counted and finite loss and parameters."""
    from climsim_tpu_torch.models import BF16, F32
    model, key = None, None
    for kind, dtype, H in WIDTH_CASES:
        if key != (WIDTH_ARMS[kind], H):
            del model
            torch.cuda.empty_cache()
            key = (WIDTH_ARMS[kind], H)
            model = make_model(BF16, None, arm=key[0], H=H)
        wrapper, plain, args, bwd = width_case(kind, model, dtype, seed=H)
        before = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        n, design = wrapper.launches - before, wrapper.design
        check(n == 1, f"{kind} H {H}: {n} launches")
        want = plain(*args)
        dt = str(dtype).replace("torch.", "")
        if dtype == torch.bfloat16:
            a32 = ([tuple(t.float() for t in args[0]), args[1].float(),
                    args[2].float()] if bwd else [t.float() for t in args])
            ratio = 0.0
            for g, w, w32 in zip(got, want, plain(*a32)):
                ok, e16, own = bf16_ok(g, w, w32)
                check(ok, f"{kind} bf16 H {H}: {e16:.3e} > 4 x {own:.3e}")
                ratio = max(ratio, e16 / max(own, 1e-30))
            err = f"up to {ratio:.3f} x the plain version's own bf16-vs-f32 " \
                  f"error (tolerance 4x)"
        elif bwd:
            worst = max(rel_err(g, w) for g, w in zip(got, want))
            check(worst <= 2e-5, f"{kind} f32 H {H}: {worst:.3e}")
            err = f"worst relative error {worst:.3e} (tolerance 2e-5)"
        else:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
            err = f"max_abs_err {max_err(got, want):.3e} (tolerance " \
                  f"1e-5 + 1e-5*|x|)"
        del got, want
        ms = median_ms(lambda: wrapper(*args), 1, repeats=1)
        print(f"width phase: {kind.upper()} {dt} H {H} (L {NLEV}, "
              f"{WIDTH_B} columns): {design} design, {n} launch, kernel "
              f"{ms:.4f} ms; {err} [{card}]")
        del args
    del model
    torch.cuda.empty_cache()
    wrappers = all_wrappers()
    ncol = LO_NLAT * LO_NLON
    model = make_model(F32, None, arm="v6", H=384)
    trainer = make_trainer(model, None)
    for w in wrappers.values():
        w.launches = 0
    with torch.enable_grad():
        _, rec = trainer.run_epoch(
            None, [train_chunk(W_TRAIN, ncol, "cuda", 4)], 0)
    torch.cuda.synchronize()
    tl = {k: w.launches for k, w in wrappers.items() if w.launches}
    designs = {k: wrappers[k].design for k in tl}
    check(tl == {"b1": 2 * W_TRAIN, "b3": W_TRAIN},
          f"f32 (384, 384) v6 update: launches {tl}")
    check(rec["updates"] == 1 and np.isfinite(rec["loss"])
          and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"f32 (384, 384) v6 update: {rec}")
    print(f"width phase: f32 RNNAutoreg v6 nneur (384, 384), one update (W "
          f"{W_TRAIN}, {ncol} columns): loss {rec['loss']:.6f}, finite "
          f"parameters; launches {tl}, designs {designs} [{card}]")
    del model, trainer
    pmodel = make_phys_model(None, use_pallas=True, H=384)
    trainer = make_phys_trainer(pmodel, None, train=True)
    pw = phys_wrappers()
    for w in pw.values():
        w.launches = 0
    with torch.enable_grad():
        _, rec = trainer.run_epoch(None, [phys_chunk(PHYS_W, ncol, "cuda",
                                                     seed=7)], 0)
    torch.cuda.synchronize()
    pl = {k: w.launches for k, w in pw.items() if w.launches}
    want = phys_launches(pmodel, True, PHYS_W)
    check(pl == want, f"physics (384, 384) update: launches {pl}, want "
          f"{want}")
    check(rec["updates"] == 1 and np.isfinite(rec["loss"])
          and all(bool(torch.isfinite(p).all())
                  for p in pmodel.parameters()),
          f"physics (384, 384) update: {rec}")
    print(f"width phase: PhysicalRNNAutoreg(use_pallas=True) nneur (384, "
          f"384), one update (W {PHYS_W}, {ncol} columns, f32): loss "
          f"{rec['loss']:.6e}, finite parameters; launches {pl}, designs "
          f"B7 {pw['b7'].design}, B8 {pw['b8'].design} [{card}]")


# ------------------------------------------------------------ phase 4


def write_grid_file(path, ncol):
    """Grid.synthetic(ncol)'s arrays (lat, lon, area, hyai, hybi, hyam,
    hybm) and P0 as a classic netCDF grid file, as the ClimSim grid file
    holds them."""
    from scipy.io import netcdf_file
    from climsim_tpu_torch import Grid
    g = Grid.synthetic(ncol, NLEV, dtype=torch.float64)
    with netcdf_file(path, "w") as f:
        for d, n in (("ncol", ncol), ("lev", NLEV), ("ilev", NLEV + 1)):
            f.createDimension(d, n)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5


def cli_run(args):
    """``cli/run_hybrid.py``'s main(args) as a user runs it, every launch
    counter set to 0 just before and read just after. Returns (exit code,
    its printed lines, the kernels launched, the wall seconds)."""
    from climsim_tpu_torch.cli import run_hybrid
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run_hybrid.main(args)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    return rc, out.getvalue().splitlines(), launches, wall


CLI_STEPS, CLI_COMPARE_STEPS, CLI_SMALL = 48, 4, 32


def compare_cli(card, grid, tmp, nneur, scheme, witness=False):
    """CLI_COMPARE_STEPS steps of the CLI at ``nneur`` with ``scheme`` on
    the card and with --device cpu, no kernel launched on either, held to
    tests/test_torch_run_hybrid.py's tolerances (T 1e-4 K; the other
    fields rtol 1e-5 plus 1e-5 of their largest change; mean T and precc
    1e-5 / 1e-6). With ``witness`` each field's tolerance also takes 4x
    the CPU's own movement when the initial T is scaled by 1 + 1e-6
    (through ``run_hybrid.run`` on the CLI's model and state, which must
    first reproduce the CPU run to the bit): at the CLI's default width
    the smoke-mode emulator (random weights fed raw units) amplifies
    rounding past any fixed tolerance."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.cli import run_hybrid
    runs = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"{scheme}_{nneur}_{dev}.npz")
        rc, lines, launches, _ = cli_run(
            ["--grid", grid, "--steps", str(CLI_COMPARE_STEPS), "--nneur",
             str(nneur), "--scheme", scheme, "--device", dev, "--out", path])
        check(rc == 0 and "finite: True" in lines and not launches,
              f"the CLI failed on {dev} (scheme {scheme}, nneur {nneur})")
        runs[dev] = dict(np.load(path))
    card_run, host = runs["cuda"], runs["cpu"]
    cpu_grid = Grid.from_file(grid, device="cpu")
    state, x_sfc = run_hybrid.initial_state(cpu_grid,
                                            torch.Generator().manual_seed(0))
    keys = (*run_hybrid.PROGNOSTIC, "mean_T", "precc")
    move = dict.fromkeys(keys, 0.0)
    if witness:
        model = run_hybrid.build_model(cpu_grid, nneur, 16, "cpu")
        fin, _, diags, _ = run_hybrid.run(model, cpu_grid, state, x_sfc,
                                          CLI_COMPARE_STEPS, scheme, 1e-6,
                                          "cpu")
        base = {**{k: v.numpy() for k, v in fin.items()},
                "mean_T": diags["mean_T"].numpy(),
                "precc": diags["precc"].numpy()}
        check(all(np.array_equal(base[k], host[k]) for k in keys),
              "run_hybrid.run does not reproduce the CLI's CPU run")
        bumped = dict(state, T=state["T"] * (1 + 1e-6))
        fin, _, diags, _ = run_hybrid.run(model, cpu_grid, bumped, x_sfc,
                                          CLI_COMPARE_STEPS, scheme, 1e-6,
                                          "cpu")
        moved = {**{k: v.numpy() for k, v in fin.items()},
                 "mean_T": diags["mean_T"].numpy(),
                 "precc": diags["precc"].numpy()}
        move = {k: float(np.abs(moved[k] - base[k]).max()) for k in keys}
    worst = {}
    for k in keys:
        rtol, atol = {"T": (1e-6, 1e-4), "u": (1e-5, 1e-5), "v": (1e-5, 1e-5),
                      "mean_T": (1e-5, 1e-6),
                      "precc": (1e-5, 1e-6)}.get(k, (1e-5, 1e-12))
        if k in run_hybrid.PROGNOSTIC:
            atol = max(atol, 1e-5 * np.abs(host[k] - state[k].numpy()).max())
        worst[k] = float(np.abs(card_run[k] - host[k]).max())
        np.testing.assert_allclose(card_run[k], host[k], rtol=rtol,
                                   atol=atol + 4 * move[k],
                                   err_msg=f"{scheme} nneur {nneur} {k}")
    print(f"cli run_hybrid --scheme {scheme} --nneur {nneur}, "
          f"{CLI_COMPARE_STEPS} steps, card against --device cpu: "
          "max_abs_err " + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + ("; the CPU's own movement under a 1e-6 change of the initial "
             "T " + ", ".join(f"{k} {e:.3e}" for k, e in move.items())
             if witness else "") + f" [{card}]")


def check_cli(card):
    """The port's coupled-step CLI on a 384-column grid file written into a
    git-ignored directory (build/cli...): at its defaults (nneur 192, 60
    levels, --scheme fv, 48 steps) on the card, where it must exit 0 with
    finite fields and mean T in [150, 350] K and launch no kernel (its
    emulator is the scan arm, its transport the plain per-field step, as
    the JAX CLI launches no Pallas kernel); then compare_cli for every
    scheme at nneur 32 and, with the witness, at the defaults. Returns the
    defaults' wall seconds."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli", dir=root)
    try:
        grid = os.path.join(tmp, "grid.nc")
        ncol = LO_NLAT * LO_NLON
        write_grid_file(grid, ncol)
        out = os.path.join(tmp, "defaults.npz")
        rc, lines, launches, wall = cli_run(["--grid", grid, "--out", out])
        for line in lines:
            print(f"  cli: {line}")
        d = np.load(out)
        mean_t = d["mean_T"]
        print(f"cli run_hybrid at its defaults ({CLI_STEPS} coupled steps, "
              f"{ncol} columns, {NLEV} levels, nneur 192, scheme fv) on the "
              f"card: wall {wall:.3f} s with the build of the model and the "
              f"state, exit {rc}, launches {launches}, mean_T "
              f"{mean_t[0]:.4f} -> {mean_t[-1]:.4f} K [{card}]")
        check(rc == 0 and "finite: True" in lines, "the CLI failed")
        check(launches == {}, f"the CLI launched kernels: {launches}")
        check(d["mean_T"].shape == (CLI_STEPS,) and all(
            np.isfinite(d[k]).all() for k in d.files), "the CLI's output")
        check(bool(((mean_t > 150) & (mean_t < 350)).all()),
              f"the CLI's mean_T out of [150, 350] K: {mean_t.tolist()}")
        for scheme in ("fv", "semi_lagrangian", "none"):
            compare_cli(card, grid, tmp, CLI_SMALL, scheme)
        compare_cli(card, grid, tmp, 192, "fv", witness=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return wall


def compare_384(card, arm="v6"):
    """3 coupled steps of a serving arm at 384 columns (Grid.synthetic,
    16 x 24) on the card and on the CPU, where the wrappers take the plain
    versions. In f32 the two agree to summation order: tolerance 1e-5 of
    each field's largest magnitude. In bf16 the card-vs-CPU difference is
    held to 4x the CPU's own bf16-vs-f32 difference, field by field (as
    for B1: a one-ulp flip of a bf16 output is 2x its half-ulp
    rounding)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, F32
    ncol = LO_NLAT * LO_NLON
    results = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        for dev in ("cuda", "cpu"):
            model = make_model(policy, dev, arm=arm)
            grid = Grid.synthetic(ncol, NLEV, device=dev)
            loop = make_loop(model, grid, LO_NLAT, LO_NLON, dev, arm)
            state, mem, x_sfc = initial_state(ncol, NLEV, dev,
                                              model.level_major,
                                              smooth_lat(arm, grid))
            st, mem, diags = loop.rollout(state, mem, x_sfc, 3)
            flat = {**{f"state.{k}": v for k, v in st.items()}, "mem": mem,
                    **{f"diag.{k}": v for k, v in diags.items()}}
            results[name, dev] = {k: v.float().cpu() for k, v in flat.items()}
    worst = 0.0
    for key, want in results["f32", "cpu"].items():
        got = results["f32", "cuda"][key]
        check(bool(torch.isfinite(got).all()),
              f"{arm} 384 f32 {key} not finite")
        scale = max(want.abs().max().item(), 1e-30)
        err = (got - want).abs().max().item()
        check(err <= 1e-5 * scale, f"{arm} 384 f32 {key}: card vs CPU "
              f"{err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / scale)
    print(f"{arm}, 384 columns, 3 steps, f32: card vs CPU worst relative "
          f"difference {worst:.3e} (tolerance 1e-5) [{card}]")
    worst = 0.0
    for key, want in results["bf16", "cpu"].items():
        got = results["bf16", "cuda"][key]
        check(bool(torch.isfinite(got).all()),
              f"{arm} 384 bf16 {key} not finite")
        own = (want - results["f32", "cpu"][key]).abs().max().item()
        err = (got - want).abs().max().item()
        tiny = 1e-6 * want.abs().max().item()
        check(err <= 4.0 * own + tiny, f"{arm} 384 bf16 {key}: card vs "
              f"CPU {err:.3e} > 4 x {own:.3e}")
        worst = max(worst, err / max(own, tiny, 1e-30))
    print(f"{arm}, 384 columns, 3 steps, bf16: card vs CPU difference up to "
          f"{worst:.3f} x the CPU's own bf16-vs-f32 difference "
          f"(tolerance 4x) [{card}]")


# ------------------------------------------------------------ physics path


def make_phys_model(device, seed=0, use_pallas=False, H=128):
    """conf/autoreg_physrnn.yaml's model at full width (nx 15, nx_sfc 24 as
    tests/test_phys_rnn.py; the trunk on the 50 CRM levels), hybrid
    coefficients from Grid.synthetic, f32. The yaml sets no use_pallas, so
    cli/train_rollout.py:294 builds the scan trunk (two RNNLayer sweeps);
    ``use_pallas=True`` is the fused trunk (kernel B7, and B8 for its
    gradients); ``H`` another trunk width than the yaml's 128."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import PhysicalRNNAutoreg
    g = Grid.synthetic(4, NLEV)
    tt = lambda a: tuple(a.tolist())
    return PhysicalRNNAutoreg(
        nx=15, nx_sfc=24, ny=5, ny_sfc=8, nneur=(H, H), nh_mem=16,
        nreg=8, store_precip=True, ice_sedimentation=True, use_physrad=True,
        use_mcica=True, use_tc=False, use_qv_variability=True,
        learned_cloud_optics=False, ng_lw=8, ng_sw=8, use_pallas=use_pallas,
        pallas_acc32=True, hyai=tt(g.hyai), hybi=tt(g.hybi),
        hyam=tt(g.hyam), hybm=tt(g.hybm), sp_mean=9.8e4, sp_div=1e3,
        **PHYS_YSCALE, device=device, seed=seed)


def phys_chunk(T, ncol, device, seed=5):
    """Synthetic data from a seeded numpy generator in the trainer's layout:
    normalized inputs and targets, and the raw state x_lev_raw in physical
    ranges (T 200-300 K, small positive q, as tests/test_phys_rnn.py)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    xd = np.zeros((T, ncol, NLEV, 6), np.float32)
    xd[..., 0] = rng.uniform(200, 300, (T, ncol, NLEV))
    xd[..., 2] = np.abs(1e-5 * n(T, ncol, NLEV))
    xd[..., 3] = np.abs(1e-5 * n(T, ncol, NLEV))
    xd[..., 5] = np.abs(1e-3 + 3e-4 * n(T, ncol, NLEV))
    chunk = {"x_lev": n(T, ncol, NLEV, 15), "x_sfc": n(T, ncol, 24),
             "y_lev": 0.3 * n(T, ncol, NLEV, 5), "y_sfc": 0.3 * n(T, ncol, 8),
             "sp": np.full((T, ncol), 1e5, np.float32), "x_lev_raw": xd}
    return {k: torch.as_tensor(v).to(device) for k, v in chunk.items()}


def make_phys_trainer(model, device, record=None, train=False):
    """The evaluation path as cli/train_rollout.py wires the physics model:
    pass_x_raw (and pass_y_true, which evaluation does not use), the
    physics memory shape, huber loss, the yaml's W 3 window. With
    ``train`` the training path: the yaml's energy and water terms and
    Adam (PHYS_TRAIN) and the per-channel output scales. With ``record``
    (a list) every model call appends its outputs, memory and area
    fractions."""
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         phys_apply, phys_mem_shape)

    def recording_apply(m, xl, xs, mem, xr, yt=None):
        res = phys_apply(m, xl, xs, mem, xr, yt)
        record.append((res[0], res[1], res[2], res[3]["area_frac"]))
        return res

    cfg = RolloutConfig(rollout_schedule={0: PHYS_W}, loss="huber",
                        pass_x_raw=True, pass_y_true=True,
                        **(PHYS_TRAIN if train else {}))
    scales = dict(yscale_lev=np.array(PHYS_YSCALE_LEV, np.float32)[None, None],
                  yscale_sca=np.array(PHYS_YSCALE_SFC, np.float32)) \
        if train else {}
    return RolloutTrainer(model, cfg, model.hyai.cpu().numpy(),
                          model.hybi.cpu().numpy(),
                          apply_fn=phys_apply if record is None
                          else recording_apply,
                          mem_shape=phys_mem_shape(model), device=device,
                          **scales)


def b7_args(model, B, dtype, seed, L=None):
    """The trunk's v2 inputs at the physics path's shapes (L 50; or L
    levels): xp = x win1 + bin1 of a random feature stream [B, L, nx] with
    the model's (lecun-normal) weights, tanh initial states. For the
    flagship's v2 arm nx is 208 (the initial MLP's 192 and the memory's
    16)."""
    layer = model.bigru_fused
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    L = NLEV - model.ilev_crm if L is None else L
    H = layer.hidden
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    x = torch.tanh(r(B, L, layer.win1.shape[0]))
    xp = torch.matmul(x.transpose(0, 1), layer.win1) + layer.bin1
    w = lambda t: t.detach().to(dtype)
    return (w(xp), w(torch.tanh(r(B, H))), w(torch.tanh(r(B, H))),
            w(layer.whh_up), w(layer.bhh_up), w(layer.win2), w(layer.bin2),
            w(layer.whh_dn), w(layer.bhh_dn))


def check_b7(model, card, L=None):
    """B7 against its plain version on the card at (L 50, B 21,600,
    H 128), or with ``L`` at the flagship v2 arm's (L 60, H 192), and a
    ragged 1,000 columns (not a multiple of the 32- or 64-column tiles).
    f32 (the cluster FFMA design, which must run, and give the same bits
    in a second call) to 1e-5 + 1e-5*|x| (summation order only,
    through 2L recurrent levels; the states are of order 1); bf16 (the
    tensor-core design) to 4x the plain version's own bf16-vs-f32 error on
    the same inputs, as check_b1."""
    from climsim_tpu_torch.ops import (bigru_reference_lbh as ref,
                                       fused_bigru_lbh as kern)
    errs = []
    label = "B7" if L is None else f"B7 H {model.bigru_fused.hidden}"
    for B in (NLAT * NLON, 1000):
        a32 = b7_args(model, B, torch.float32, seed=B, L=L)
        got, want = kern(*a32), ref(*a32)
        design = kern.design
        check(design == "f32_cluster", f"{label} f32 ran {design}")
        same = all(torch.equal(x, y) for x, y in zip(got, kern(*a32)))
        check(same, f"{label} f32 B={B}: two calls differ")
        e = max_err(got, want)
        print(f"{label} f32 ({design} design) B={B}: max_abs_err {e:.3e}; "
              f"tolerance 1e-5 + 1e-5*|x|; a second call bit-identical "
              f"[{card}]")
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        errs.append(e)
        a16 = tuple(t.to(torch.bfloat16) for t in a32)
        got16, want16 = kern(*a16), ref(*a16)
        e16 = max_err(got16, want16)
        own = max_err(want16, ref(*(t.float() for t in a16)))
        print(f"{label} bf16 (tensor-core design) B={B}: max_abs_err "
              f"{e16:.3e}, plain bf16-vs-f32 {own:.3e}; tolerance 4x that "
              f"[{card}]")
        check(e16 <= 4.0 * own, f"{label} bf16 B={B}: {e16} > 4 x {own}")
        errs.append(e16)
        del a32, got, want, a16, got16, want16
    return max(errs)


def radiation_args(ncol, device, seed=3, nlev=NLEV, ng=8):
    """Solver inputs at the physics path's shapes (ncol, 60, 8) (or nlev
    layers, ng g-points) through the plain optics: SW two-stream
    coefficients of random optical properties (tau spanning clear to thick
    cloud), LW Pade sources of random Planck terms. Returns (sw args, lw
    args)."""
    from climsim_tpu_torch.physics import radiation as R
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(
        s, generator=g, device=device)
    shape = (ncol, nlev, ng)
    layers = R.calc_ref_trans_sw(u(0.05, 1.0, ncol, 1, 1),
                                 torch.exp(u(-6.0, 4.0, *shape)),
                                 u(0.3, 0.999, *shape), u(0.0, 0.85, *shape))
    sw = (u(0.0, 300.0, ncol, ng), u(0.05, 0.8, ncol, ng),
          u(0.05, 0.8, ncol, ng)) + tuple(layers)
    sup, sdn, trans = R.reftrans_lw(u(1.0, 60.0, *shape),
                                    u(1.0, 60.0, *shape),
                                    torch.exp(u(-6.0, 3.0, *shape)))
    lw = (trans, sdn, sup, u(10.0, 60.0, ncol, ng), torch.ones(
        (ncol, ng), device=device))
    return sw, lw


# the shapes at which B11's and B14's designs are gated: the physics path's,
# a ragged batch at 50 levels, PhysRad's default ng 16, nlev 128, and ng 6,
# which the staged tile does not take (the first design runs)
RAD_SHAPES = ((NLAT * NLON, NLEV, 8), (1003, 50, 8), (NLAT * NLON, NLEV, 16),
              (1000, 128, 8), (1000, NLEV, 6))


def check_staged(card, kind):
    """B11 (kind "b11") or B14 ("b14"), through its wrapper, against its
    plain version at RAD_SHAPES: each output to 1e-5 of its scale (as
    check_radiation), finite, a second call bit-identical, the design
    recorded on the wrapper the one rad_design names (the staged tile at
    every shape but ng 6, which runs the first design), and the kernel's
    own shared-memory size (csrc's Geom::smem) rad_tile_smem's at the
    geometry rad_design picks. At every staged shape the first design,
    which the timings use, is held to the same tolerance against the
    staged one (B11's staged down sweep multiplies by the up sweep's
    reciprocal where the first divides, so they need not agree bit for
    bit). Returns the worst max_abs_err of the wrapper."""
    import ctypes
    from climsim_tpu_torch.ops import _build, pallas_radiation as prad
    from climsim_tpu_torch.physics.radiation import adding_sw
    sw_kind = kind == "b11"
    src = "adding_sw" if sw_kind else "lw_noscat_bwd"
    smem_of = getattr(_build.load(src), src + "_staged_smem")
    smem_of.restype = ctypes.c_longlong
    wrapper = prad.adding_sw_fast if sw_kind else prad.lw_solver_noscat_bwd
    worst = 0.0
    for i, (B, nlev, ng) in enumerate(RAD_SHAPES):
        sw, lw = radiation_args(B, "cuda", seed=30 + i, nlev=nlev, ng=ng)
        args = sw if sw_kind else lw
        cts = () if sw_kind else radiation_cts(args, 2, seed=40 + i)
        if sw_kind:
            call = lambda: wrapper(*args)
            first = lambda: prad.first_adding_sw(*args)
            want = adding_sw(*args)
        else:
            call = lambda: wrapper(args, cts)
            first = lambda: prad.first_lw_solver_noscat_bwd(args, cts)
            want = prad.lw_solver_noscat_bwd_reference(args, cts)
        got, again = call(), call()
        torch.cuda.synchronize()
        design = prad.rad_design(kind, B, nlev, ng)
        check(wrapper.design == design["design"]
              == ("first" if ng % 4 else "staged"),
              f"{kind} {(B, nlev, ng)}: launched {wrapper.design}, "
              f"rad_design names {design['design']}")
        rel = [rel_err(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err = max_err(got, want)
        if i == 0:
            worst = err
        print(f"{kind.upper()} f32 {(B, nlev, ng)}: {wrapper.design} design"
              + (f" (C {design['C']}, {design['blocks']} CTAs, "
                 f"{design['smem']} bytes of shared memory)"
                 if design["design"] == "staged" else "")
              + f", max_abs_err {err:.3e}, worst relative to an output's "
              f"scale {max(rel):.2e} (tolerance 1e-5), a second call "
              f"bit-identical {same} [{card}]")
        check(same, f"{kind} {(B, nlev, ng)}: two calls differ")
        for j, (e, g) in enumerate(zip(rel, got)):
            check(e <= 1e-5, f"{kind} {(B, nlev, ng)} output {j}: {e:.3e}")
            check(bool(torch.isfinite(g).all()),
                  f"{kind} {(B, nlev, ng)} output {j} not finite")
        if design["design"] == "staged":
            kernel_smem = smem_of(nlev, ng, design["C"])
            check(kernel_smem == design["smem"],
                  f"{kind} {(B, nlev, ng)}: the kernel's shared memory "
                  f"{kernel_smem} is not rad_tile_smem's {design['smem']}")
            vs = [rel_err(a, b) for a, b in zip(got, first())]
            print(f"{kind.upper()} staged against first design at "
                  f"{(B, nlev, ng)}: worst relative to an output's scale "
                  f"{max(vs):.2e} (tolerance 1e-5) [{card}]")
            check(max(vs) <= 1e-5, f"{kind} {(B, nlev, ng)} staged against "
                  f"first: {max(vs):.3e}")
        del sw, lw, args, cts, got, again, want
    return worst


def time_staged(card, kind, args, cts=()):
    """The staged design of B11 or B14 at the physics path's shape, in
    turns with its first design (first, staged, staged, first), printed.
    Returns (the wrapper's mean ms, the first design's mean ms)."""
    from climsim_tpu_torch.ops import pallas_radiation as prad
    if kind == "b11":
        new = lambda: prad.adding_sw_fast(*args)
        first = lambda: prad.first_adding_sw(*args)
    else:
        new = lambda: prad.lw_solver_noscat_bwd(args, cts)
        first = lambda: prad.first_lw_solver_noscat_bwd(args, cts)
    shape = tuple(args[3 if kind == "b11" else 0].shape)
    old, nw = in_turns(first, new, 50)
    print(f"{kind.upper()} f32 at {shape} in turns (first, staged, staged, "
          f"first): first design {old[0]:.4f} / {old[1]:.4f} ms, staged "
          f"design {nw[0]:.4f} / {nw[1]:.4f} ms [{card}]")
    return statistics.mean(nw), statistics.mean(old)


def check_radiation(card):
    """B11 and B12 against their plain versions on the card at
    (21,600, 60, 8) f32, each of the five fluxes to 1e-5 of its largest
    magnitude (nvcc contracts a*b+c into FMAs; the recurrences carry the
    rounding through 60 levels and the SW up sweep's divisions)."""
    from climsim_tpu_torch.ops import adding_sw_fast, lw_solver_noscat_fast
    from climsim_tpu_torch.physics.radiation import (adding_sw,
                                                     lw_solver_noscat)
    sw, lw = radiation_args(NLAT * NLON, "cuda")
    errs = {}
    for name, kern, ref, args, outs in (
            ("B11", adding_sw_fast, adding_sw, sw, ("fup", "fdiff", "fdir")),
            ("B12", lw_solver_noscat_fast, lw_solver_noscat, lw,
             ("fdn", "fup"))):
        got, want = kern(*args), ref(*args)
        rel = {o: rel_err(g, w) for o, g, w in zip(outs, got, want)}
        errs[name] = max_err(got, want)
        print(f"{name} f32 ({NLAT * NLON}, {NLEV}, 8): max_abs_err "
              f"{errs[name]:.3e}; relative to each flux's scale "
              + ", ".join(f"{o} {e:.2e}" for o, e in rel.items())
              + f" (tolerance 1e-5) [{card}]")
        for o, e in rel.items():
            check(e <= 1e-5, f"{name} {o}: {e:.3e}")
            check(bool(torch.isfinite(got[outs.index(o)]).all()),
                  f"{name} {o} not finite")
    return errs


def trunk_of(model) -> str:
    return "fused" if model.use_pallas else "scan"


def phys_launches(model, train: bool, steps: int) -> dict:
    """The physics path's launches over ``steps`` model steps: per step B11
    and B12 (and in training their backward B13, B14), with the fused
    trunk also B7 (and B8); the scan trunk launches no BiGRU kernel."""
    keys = ["b11", "b12"] + (["b13", "b14"] if train else [])
    if model.use_pallas:
        keys += ["b7"] + (["b8"] if train else [])
    return {k: steps for k in PHYS_KERNELS if k in keys}


def run_phys_eval(model, card):
    """The physics evaluation path at 21,600 columns: one W 3 window
    through RolloutTrainer.run_epoch(train=False) with pass_x_raw, every
    physics counter set to 0 just before and read just after."""
    ncol = NLAT * NLON
    record = []
    trainer = make_phys_trainer(model, None, record)   # None: the card
    chunk = phys_chunk(PHYS_W, ncol, "cuda")
    wrappers = phys_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    mem, rec = trainer.run_epoch(None, [chunk], 0, train=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    trunk = trunk_of(model)
    print(f"physics evaluation, {trunk} trunk: {rec['updates']} window of W "
          f"{PHYS_W} at {ncol} columns in {wall:.3f} s (first run), loss "
          f"{rec['loss']:.6f}; launches {launches} [{card}]")
    check(rec["updates"] == 1, f"{rec['updates']} windows")
    want = phys_launches(model, False, PHYS_W)
    check(launches == want, f"{trunk} trunk: launches {launches}, want "
          f"{want}")
    check(np.isfinite(rec["loss"]), f"loss {rec['loss']}")
    Lc = NLEV - model.ilev_crm
    check(mem.shape == (ncol, Lc, model.nh_mem + 1)
          and bool(torch.isfinite(mem).all()), "physics memory")
    check(bool((mem[..., -1] >= 0).all()), "stored precipitation < 0")
    check(len(record) == PHYS_W, f"{len(record)} model calls")
    for out, out_sfc, _, _ in record:
        check(out.shape == (ncol, NLEV, 5) and out_sfc.shape == (ncol, 8),
              "physics output shapes")
        check(bool(torch.isfinite(out).all())
              and bool(torch.isfinite(out_sfc).all()),
              "physics outputs not finite")
        check(bool((out_sfc[:, 2:4] >= 0).all()),
              "surface precipitation (PRECSC, PRECC) < 0")
    print(f"physics evaluation, {trunk} trunk: stored precipitation in "
          f"[{mem[..., -1].min().item():.4e}, {mem[..., -1].max().item():.4e}]"
          f", PRECC up to {record[-1][1][:, 3].max().item():.4e} [{card}]")
    return launches


def compare_phys_384(card, use_pallas=False):
    """The physics window (W 3) of the model with the scan (or, with
    ``use_pallas``, the fused) trunk at 384 columns on the card and on the
    CPU from the same seeded model and data. McICA's stratified sampling turns
    each layer's area fractions into g-point indices; a last-ulp difference
    in a fraction can move an index, and with it that column's cloud in
    every later step. So the check first counts the indices that differ,
    then compares the outputs and memory of the columns whose indices all
    agree (they must be at least 99% of the columns) to 1e-4 of each
    field's scale (f32 summation order through a 128-wide GRU's 100 levels
    and the radiation; the CPU tests hold the plain versions to JAX at the
    same widths to 2.9e-5), and the loss to 1e-4 when no index differs."""
    from climsim_tpu_torch.physics.radiation import stratified_sample
    ncol = LO_NLAT * LO_NLON
    runs = {}
    for dev in ("cuda", "cpu"):
        model = make_phys_model(dev, use_pallas=use_pallas)
        record = []
        trainer = make_phys_trainer(model, dev, record)
        mem, rec = trainer.run_epoch(
            None, [phys_chunk(PHYS_W, ncol, dev, seed=6)], 0, train=False)
        runs[dev] = (rec["loss"], mem.cpu(),
                     [tuple(t.cpu() for t in r) for r in record], model)
    (lc, mc, rc, model), (lp, mp, rp, _) = runs["cuda"], runs["cpu"]
    nreg, Lc = model.nreg, NLEV - model.ilev_crm
    n_diff, n_idx = 0, 0
    bad = torch.zeros(ncol, dtype=torch.bool)
    for (_, _, _, af_c), (_, _, _, af_p) in zip(rc, rp):
        for G in (model.ng_sw, model.ng_lw):
            ic = stratified_sample(af_c.cuda().reshape(-1, nreg), G).cpu()
            ip = stratified_sample(af_p.reshape(-1, nreg), G)
            d = (ic != ip).reshape(ncol, Lc * G)
            n_diff += int(d.sum())
            n_idx += d.numel()
            bad |= d.any(1)
    keep = ~bad
    trunk = trunk_of(model)
    print(f"physics 384 columns, {trunk} trunk, W {PHYS_W}: {n_diff} of "
          f"{n_idx} McICA sample indices differ card vs CPU, in "
          f"{int(bad.sum())} columns [{card}]")
    check(keep.float().mean().item() >= 0.99,
          f"McICA indices differ in {int(bad.sum())} of {ncol} columns")
    worst = 0.0
    pairs = [("mem", mc, mp)] + [
        (f"step {i} {k}", c[j], p[j]) for i, (c, p) in enumerate(zip(rc, rp))
        for j, k in ((0, "out"), (1, "out_sfc"), (2, "mem"))]
    for name, c, p in pairs:
        check(bool(torch.isfinite(c).all()),
              f"384 physics {trunk} {name} not finite")
        e = rel_err(c[keep], p[keep])
        check(e <= 1e-4, f"384 physics {trunk} {name}: card vs CPU {e:.3e}")
        worst = max(worst, e)
    if n_diff == 0:
        check(abs(lc - lp) <= 1e-4 * abs(lp),
              f"384 physics {trunk} loss {lc} vs {lp}")
    print(f"physics 384 columns, {trunk} trunk: card vs CPU worst relative "
          f"difference {worst:.3e} over {int(keep.sum())} columns "
          f"(tolerance 1e-4); loss {lc:.7f} vs {lp:.7f} [{card}]")


def profile_kernels(fn, top=8):
    """``fn()`` under torch.profiler: the device time of every kernel
    summed (busy ms), and the kernels with the most device time. Returns
    (busy ms, [(name, ms), ...]). Only the device-side events count: an
    operator's own event repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(ev.key, ev.self_device_time_total / 1e3)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(key=lambda kv: -kv[1])
    return sum(ms for _, ms in kernels), kernels[:top]


def phys_profile(trainer, chunk, top=8, train=False):
    """profile_kernels of one evaluation window (or, with ``train``, the
    updates of ``chunk``)."""
    def run():
        with torch.set_grad_enabled(train):
            trainer.run_epoch(None, [chunk], 0, train=train)
    return profile_kernels(run, top)


def arm_split(loop, inputs, step_ms, card, label):
    """Device busy time per coupled step of a serving arm (torch.profiler
    over 3 steps) against its unprofiled step time: the idle share, and
    the four kernels with the most device time."""
    busy, top = profile_kernels(lambda: loop.rollout(*inputs, 3), top=4)
    if busy <= 0:
        print(f"{label} by kernel: the profiler saw no device time: not "
              f"measured [{card}]")
        return
    print(f"{label} by kernel (torch.profiler device time, per step): busy "
          f"{busy / 3:.4f} ms of {step_ms:.4f} ms, idle share "
          f"{max(0.0, 1 - busy / 3 / step_ms):.3f}; "
          + "; ".join(f"{k[:40]} {ms / 3:.4f} ms" for k, ms in top)
          + f" [{card}]")


def phys_bounds(a7, sw, lw):
    """Least times of B7, B11 and B12 from this run's inputs: operations
    at the card's f32 rate (the f32 policy rules out TF32) against each
    input read once and each output written once."""
    xp = a7[0]
    L, B, H3 = xp.shape
    H = H3 // 3
    n_in = sum(t.numel() for t in a7)
    b7_flops = 2.0 * 3 * H3 * H * L * B
    b7_bytes = float(xp.element_size() * (n_in + L * B * H + B * H))
    out = {"b7": (b7_flops, b7_bytes)}
    for key, args, n_out, ops in (("b11", sw, 3, SW_OPS_PER_ELEMENT),
                                  ("b12", lw, 2, LW_OPS_PER_ELEMENT)):
        Bc, nlev, ng = args[3 if key == "b11" else 0].shape
        nbytes = 4.0 * (sum(t.numel() for t in args)
                        + n_out * Bc * (nlev + 1) * ng)
        out[key] = (float(ops * Bc * nlev * ng), nbytes)
    res = {}
    for key, (flops, nbytes) in out.items():
        t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
        res[key] = (max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops > t_bytes else "bytes", flops,
                    nbytes)
    return res


# ------------------------------------------------------------ physics training


B8_NAMES = ("d_xp", "dh0_up", "dh0_dn", "dwhh_up", "dbhh_up", "dwin2",
            "dbin2", "dwhh_dn", "dbhh_dn")
PHYS_KERNELS = ("b7", "b8", "b11", "b12", "b13", "b14")


def phys_wrappers() -> dict:
    """The physics path's kernel wrappers, by id, for their launch
    counters."""
    from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_fast,
                                       bigru_bwd_lbh, fused_bigru_lbh,
                                       lw_solver_noscat_bwd,
                                       lw_solver_noscat_fast)
    return dict(zip(PHYS_KERNELS, (fused_bigru_lbh, bigru_bwd_lbh,
                                   adding_sw_fast, lw_solver_noscat_fast,
                                   adding_sw_bwd, lw_solver_noscat_bwd)))


def b8_args(model, B, dtype, seed, L=None):
    """B8's residuals (B7's inputs at the physics path's shapes, or with
    L at the v2/v4 arms' L 60, H 192) and random cotangents of (down,
    last_h)."""
    res = b7_args(model, B, dtype, seed, L=L)
    L, H = res[0].shape[0], res[1].shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return res, r(L, B, H), r(B, H)


def check_b8(model, card, L=None):
    """B8 against its plain version on the card at (L 50, B 21,600, H 128),
    or with ``L`` at the v4 arm's (L 60, H 192), and a ragged 1,000
    columns, every one of its nine outputs. f32 (the cluster FFMA design,
    which must run, and give the same bits in a second call): 2e-5 of each
    output's largest magnitude, as B3 (summation order over
    2 x 50 levels of BPTT and the 1.08 M-term gradient sums); bf16 (the
    tensor-core design): as check_b3, per output."""
    from climsim_tpu_torch.ops import (bigru_bwd_lbh as kern,
                                       bigru_bwd_reference_lbh as ref)
    errs = []
    label = "B8" if L is None else f"B8 H {model.bigru_fused.hidden} L {L}"
    for B in (NLAT * NLON, 1000):
        res, dd, dl = b8_args(model, B, torch.float32, seed=B + 1, L=L)
        got, want = kern(res, dd, dl), ref(res, dd, dl)
        design = kern.design
        check(design == "f32_cluster", f"{label} f32 ran {design}")
        check(all(torch.equal(x, y) for x, y in zip(got, kern(res, dd, dl))),
              f"{label} f32 B={B}: two calls differ")
        rel = [rel_err(g, w) for g, w in zip(got, want)]
        worst = int(np.argmax(rel))
        print(f"{label} f32 ({design} design) B={B}: worst relative error "
              f"{rel[worst]:.3e} ({B8_NAMES[worst]}); tolerance 2e-5 of each "
              f"output's scale; a second call bit-identical [{card}]")
        for name, e in zip(B8_NAMES, rel):
            check(e <= 2e-5, f"{label} f32 B={B} {name}: {e:.3e}")
        errs.append(max_err(got, want))
        del got, want
        r16 = [t.to(torch.bfloat16) for t in res]
        d16 = (dd.to(torch.bfloat16), dl.to(torch.bfloat16))
        got16, want16 = kern(r16, *d16), ref(r16, *d16)
        want32 = ref([t.float() for t in r16], *(t.float() for t in d16))
        ratio = 0.0
        for name, g, w, w32 in zip(B8_NAMES, got16, want16, want32):
            ok, e16, own = bf16_ok(g, w, w32)
            check(ok, f"{label} bf16 B={B} {name}: {e16:.3e} > 4 x "
                  f"{own:.3e}")
            ratio = max(ratio, e16 / max(own, 1e-30))
        print(f"{label} bf16 (tensor-core design) B={B}: difference up to "
              f"{ratio:.3f} x the plain version's own bf16-vs-f32 error "
              f"(tolerance 4x) [{card}]")
        errs.append(max_err(got16, want16))
        del got16, want16, want32, res, r16
        torch.cuda.empty_cache()
    return max(errs)


def radiation_cts(args, n_out, seed=4):
    """Seeded cotangents [B, nlev+1, ng] of a solver's n_out fluxes."""
    B, nlev, ng = args[3 if n_out == 3 else 0].shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, nlev + 1, ng), generator=g, device="cuda")
            for _ in range(n_out)]


def check_radiation_bwd(card):
    """B13 and B14 against their plain versions on the card at
    (21,600, 60, 8) f32 on radiation_args' inputs, B13 (the two-pass
    design) also at a ragged (1,000, 50, 8): each gradient to 1e-5 of its
    largest magnitude (FMA contraction through the replay and both
    backward sweeps, the SW ones through 240 divisions)."""
    from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_bwd_reference,
                                       lw_solver_noscat_bwd,
                                       lw_solver_noscat_bwd_reference)
    sw, lw = radiation_args(NLAT * NLON, "cuda")
    sw50, _ = radiation_args(1000, "cuda", seed=6, nlev=50)
    errs = {}
    for name, kern, ref, args, n_out in (
            ("B13", adding_sw_bwd, adding_sw_bwd_reference, sw, 3),
            ("B13", adding_sw_bwd, adding_sw_bwd_reference, sw50, 3),
            ("B14", lw_solver_noscat_bwd, lw_solver_noscat_bwd_reference, lw,
             2)):
        cts = radiation_cts(args, n_out)
        got, want = kern(args, cts), ref(args, cts)
        rel = [rel_err(g, w) for g, w in zip(got, want)]
        errs[name] = max(errs.get(name, 0.0), max_err(got, want))
        print(f"{name} f32 {tuple(args[3 if n_out == 3 else 0].shape)}: "
              f"max_abs_err {max_err(got, want):.3e}; worst relative to a "
              f"gradient's scale {max(rel):.2e} (tolerance 1e-5) [{card}]")
        for i, (e, g) in enumerate(zip(rel, got)):
            check(e <= 1e-5, f"{name} gradient {i}: {e:.3e}")
            check(bool(torch.isfinite(g).all()), f"{name} gradient {i}")
    return errs


def run_phys_training(card, use_pallas=False):
    """The physics training path of the model with the scan (or, with
    ``use_pallas``, the fused) trunk: one chunk of PHYS_T_TRAIN steps,
    PHYS_T_TRAIN / W updates, with every physics counter set to 0 just
    before and read just after, at 21,600 columns. The scan trunk keeps
    every level's activations for its backward; where the W 3 update does
    not fit in the card's memory, the columns are halved until it does,
    and the cut is printed. Returns (trainer, chunk, launches, updates,
    columns)."""
    ncol = NLAT * NLON
    trunk = "fused" if use_pallas else "scan"
    while True:
        try:
            return _phys_training_at(card, use_pallas, ncol)
        except torch.cuda.OutOfMemoryError as err:
            reason = str(err).splitlines()[0][:160]
        gc.collect()
        torch.cuda.empty_cache()
        check(ncol >= 2 * 1000, f"physics training, {trunk} trunk: does "
              f"not fit at {ncol} columns")
        print(f"physics training, {trunk} trunk: the W {PHYS_W} update does "
              f"not fit in the card's memory at {ncol} columns ({reason}); "
              f"CUT to {ncol // 2} columns [{card}]")
        ncol //= 2


def _phys_training_at(card, use_pallas, ncol):
    model = make_phys_model(None, use_pallas=use_pallas)   # None: the card
    trainer = make_phys_trainer(model, None, train=True)
    chunk = phys_chunk(PHYS_T_TRAIN, ncol, "cuda", seed=7)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    wrappers = phys_wrappers()
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        mem, rec = trainer.run_epoch(None, [chunk], 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    n = rec["updates"]
    trunk = trunk_of(model)
    print(f"physics training, {trunk} trunk: {n} updates (W {PHYS_W}, "
          f"{ncol} columns) in {wall:.3f} s (first run), loss "
          f"{rec['loss']:.6e}; launches {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({resident:.3f} "
          f"GB resident before) [{card}]")
    check(n == PHYS_T_TRAIN // PHYS_W, f"{n} updates")
    want = phys_launches(model, True, PHYS_W * n)
    check(launches == want, f"{trunk} trunk: launches {launches} in {n} "
          f"updates, want {want}")
    check(np.isfinite(rec["loss"]), f"loss {rec['loss']}")
    Lc = NLEV - model.ilev_crm
    check(mem.shape == (ncol, Lc, model.nh_mem + 1)
          and bool(torch.isfinite(mem).all()), "physics training memory")
    check(bool((mem[..., -1] >= 0).all()), "stored precipitation < 0")
    # the surface-output head feeds only channels that the physics
    # overwrites (precipitation and the radiative scalars), so its
    # gradient is zero and Adam leaves it; every other parameter moves
    still = sorted(n for n, p in model.named_parameters()
                   if torch.equal(p.detach(), before[n]))
    no_grad = sorted(n for n, p in model.named_parameters()
                     if not bool(p.grad.any()))
    check(still == no_grad == ["mlp_surface_output.bias",
                               "mlp_surface_output.kernel"],
          f"{trunk} trunk: unchanged {still}, without gradient {no_grad}")
    return trainer, chunk, launches, n, ncol


def compare_phys_train_384(card, use_pallas=False):
    """One physics training update (W 3) of the model with the scan (or,
    with ``use_pallas``, the fused) trunk at 384 columns on the card and on
    the CPU from the same seeded model and data. The McICA sample indices
    that differ are counted first (compare_phys_384). When none differ:
    the loss to 1e-5; each gradient to 1e-4 of its scale (f32 order of
    summation through the BPTT, the radiation and the gradient sums) plus
    4x the farthest the CPU's own gradient moves when the parameters are
    scaled by 1 + 1e-6 N(0, 1), over three draws. With random weights and
    PHYS_YSCALE every stored-precipitation pool hits its cap, so the
    precipitation release no longer changes the outputs: its gradient is
    exactly zero, and what is computed is the float32 residue of g wn -
    g wn (tests/test_torch_phys_train.py), which such a draw moves by more
    than 10% of its size (well-conditioned gradients move by less than
    1%). Such a residue is held to 4x the largest the CPU's runs give it.
    Each parameter to 1e-5 of its size
    plus 2% of one Adam step (lr), as compare_train_384, plus the
    difference that Adam's first step lr g / (|g| + eps) makes of the two
    gradients (up to 2 lr where a residue's sign differs). When some
    differ: the count is printed, and finite values and the loss to 1e-3
    are required."""
    from climsim_tpu_torch.physics.radiation import stratified_sample
    ncol = LO_NLAT * LO_NLON
    trunk = "fused" if use_pallas else "scan"
    runs = {}
    for key, dev, seed in (("cuda", "cuda", None), ("cpu", "cpu", None),
                           ("moved9", "cpu", 9), ("moved10", "cpu", 10),
                           ("moved11", "cpu", 11)):
        model = make_phys_model(dev, use_pallas=use_pallas)
        if seed is not None:
            g = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g))
        record = []
        trainer = make_phys_trainer(model, dev, record, train=True)
        with torch.enable_grad():
            mem, rec = trainer.run_epoch(
                None, [phys_chunk(PHYS_W, ncol, dev, seed=8)], 0)
        prm = {n: p.detach().cpu() for n, p in model.named_parameters()}
        runs[key] = {"loss": rec["loss"], "mem": mem.cpu(),
                     "af": [r[3].detach().cpu() for r in record],
                     "grads": {n: p.grad.cpu()
                               for n, p in model.named_parameters()},
                     "params": prm}
        check(rec["updates"] == 1,
              f"384 physics update ({trunk}) {key}: {rec}")
        nreg, ngs = model.nreg, (model.ng_sw, model.ng_lw)
        del model, trainer, record
    c, p = runs["cuda"], runs["cpu"]
    moved = [runs[f"moved{s}"]["grads"] for s in (9, 10, 11)]
    n_diff = n_idx = 0
    for af_c, af_p in zip(c["af"], p["af"]):
        for G in ngs:
            ic = stratified_sample(af_c.cuda().reshape(-1, nreg), G).cpu()
            ip = stratified_sample(af_p.reshape(-1, nreg), G)
            n_diff += int((ic != ip).sum())
            n_idx += ic.numel()
    print(f"physics training 384 columns, {trunk} trunk, W {PHYS_W}: "
          f"{n_diff} of {n_idx} "
          f"McICA sample indices differ card vs CPU [{card}]")
    check(np.isfinite(c["loss"]) and bool(torch.isfinite(c["mem"]).all())
          and all(bool(torch.isfinite(g).all()) for g in c["grads"].values()),
          f"384 physics update ({trunk}): non-finite values on the card")
    lrel = abs(c["loss"] - p["loss"]) / abs(p["loss"])
    if n_diff:
        check(lrel <= 1e-3, f"384 physics update ({trunk}) loss "
              f"{c['loss']} vs "
              f"{p['loss']}")
        print(f"physics training 384 columns, {trunk} trunk: McICA indices "
              f"differ; loss "
              f"{c['loss']:.7e} vs {p['loss']:.7e} (tolerance 1e-3) "
              f"[{card}]")
        return
    check(lrel <= 1e-5, f"384 physics update ({trunk}) loss {c['loss']} vs "
          f"{p['loss']}")
    worst_g = worst_p = 0.0
    residue = []
    for n in p["grads"]:
        g_c, g_p = c["grads"][n], p["grads"][n]
        scale = g_p.abs().max().item()
        move = max((g[n] - g_p).abs().max().item() for g in moved)
        if move > 0.1 * scale:
            residue.append(n)
            size = max([scale] + [g[n].abs().max().item() for g in moved])
            check(g_c.abs().max().item() <= 4 * size,
                  f"384 physics update ({trunk}) gradient {n}: residue "
                  f"{g_c.abs().max().item():.3e} > 4 x {size:.3e}")
            continue
        err = (g_c - g_p).abs().max().item()
        tol = 1e-4 * scale + 4 * move
        check(err <= tol, f"384 physics update ({trunk}) gradient {n}: "
              f"{err:.3e} > "
              f"{tol:.3e}")
        worst_g = max(worst_g, err / max(tol, 1e-30))
        adam = lambda g: g / (g.abs() + 1e-8)       # the first step / lr
        err = ((c["params"][n] - p["params"][n]).abs()
               - 1e-5 * p["params"][n].abs()
               - PHYS_LR * (adam(g_c) - adam(g_p)).abs()).max().item()
        check(err <= 0.02 * PHYS_LR, f"384 physics update ({trunk}) "
              f"parameter {n}: "
              f"{err:.3e} > 2e-2 lr beyond its tolerance")
        worst_p = max(worst_p, err / (0.02 * PHYS_LR))
    print(f"physics training 384 columns, {trunk} trunk, one update: card "
          f"vs CPU loss "
          f"{c['loss']:.7e} vs {p['loss']:.7e}; gradients within "
          f"{worst_g:.3f} and parameters within {max(worst_p, 0.0):.3f} of "
          f"their tolerances; rounding-residue gradients {residue} [{card}]")


def b8_work(a8):
    """B8's operations and bytes from its inputs: 27 H^2 multiply-adds per
    column and level (the replay 9 H^2, the two BPTT sweeps' transposed
    products 9 H^2, the three weight gradients 9 H^2), each input read
    once and each output written once."""
    res, dd, dl = a8
    L, B, H3 = res[0].shape
    H = H3 // 3
    n_in = sum(t.numel() for t in res) + dd.numel() + dl.numel()
    n_out = res[0].numel() + 2 * B * H + sum(t.numel() for t in res[3:])
    return (2.0 * 27 * H * H * L * B,
            float(res[0].element_size() * (n_in + n_out)))


def phys_bwd_bounds(a8, sw, lw):
    """Least times of B8, B13 and B14 from this run's inputs: operations at
    the card's f32 rate against each input read once and each output
    written once. B8: 27 H^2 multiply-adds per column and level (the
    replay 9 H^2, the two BPTT sweeps' transposed products 9 H^2, the
    three weight gradients 9 H^2)."""
    out = {"b8": b8_work(a8)}
    for key, args, n_ct, ops in (("b13", sw, 3, SW_BWD_OPS_PER_ELEMENT),
                                 ("b14", lw, 2, LW_BWD_OPS_PER_ELEMENT)):
        Bc, nlev, ng = args[3 if key == "b13" else 0].shape
        n_args = sum(t.numel() for t in args)
        out[key] = (float(ops * Bc * nlev * ng),
                    4.0 * (2 * n_args + n_ct * Bc * (nlev + 1) * ng))
    res_ = {}
    for key, (flops, nbytes) in out.items():
        t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
        res_[key] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops > t_bytes else "bytes", flops,
                     nbytes)
    return res_


def time_training(trainer, chunk, n, arm, card, repeats=REPEATS,
                  split=False):
    """ms per training update of an arm at 21,600 columns (the median over
    ``repeats`` epochs of ``chunk``, n updates each, float(loss) included)
    with the epoch's peak memory; with ``split`` also the device idle share
    of one update and its kernels with the most device time
    (torch.profiler). Returns the ms per update."""
    ncol = chunk["x_lev"].shape[1]

    def epoch(c=chunk):
        with torch.enable_grad():
            trainer.run_epoch(None, [c], epoch=0)

    ms = median_ms(epoch, 1, repeats=repeats, queue_ahead=False) / n
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    epoch()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"training update, arm {arm} (W {W_TRAIN}, remat, MSE, Adam, "
          f"{ncol} columns, bf16): {ms:.4f} ms/update, "
          f"{ncol * W_TRAIN / ms * 1e3:,.0f} column-steps/s; peak memory "
          f"{peak:.3f} GB ({resident:.3f} GB resident before the epoch) "
          f"[{card}]")
    if split:
        one = {k: v[:W_TRAIN] for k, v in chunk.items()}
        busy, top = profile_kernels(lambda: epoch(one), top=6)
        print(f"training update, arm {arm}, by kernel (torch.profiler "
              + (f"device time): busy {busy:.4f} ms of {ms:.4f} ms, idle "
                 f"share {max(0.0, 1 - busy / ms):.3f}; "
                 + "; ".join(f"{k[:40]} {t:.4f} ms" for k, t in top)
                 if busy > 0 else "device time): the profiler saw no device "
                 "time: not measured") + f" [{card}]")
    return ms


def time_phys_eval(model, card):
    """ms per model step of the physics evaluation window (W 3, 21,600
    columns) with the model's trunk, its peak memory, and the window's
    device idle share and largest kernels (torch.profiler). Returns the ms
    per model step."""
    ncol = NLAT * NLON
    chunk = phys_chunk(PHYS_W, ncol, "cuda")
    trainer = make_phys_trainer(model, None)
    ms = median_ms(lambda: trainer.run_epoch(
        None, [chunk], 0, train=False), 1, repeats=OLD_REPEATS,
        queue_ahead=False) / PHYS_W
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    trainer.run_epoch(None, [chunk], 0, train=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    trunk = trunk_of(model)
    print(f"physics evaluation, {trunk} trunk (W {PHYS_W}, {ncol} columns, "
          f"f32): {ms:.4f} ms per model step, {ncol / ms * 1e3:,.0f} "
          f"column-steps/s; peak memory {peak:.3f} GB ({resident:.3f} GB "
          f"resident before the window) [{card}]")
    busy, top = phys_profile(trainer, chunk)
    window = ms * PHYS_W
    print(f"physics evaluation window, {trunk} trunk, by kernel "
          + (f"(torch.profiler device time): busy {busy:.4f} ms of the "
             f"window's {window:.4f} ms unprofiled, idle share "
             f"{max(0.0, 1 - busy / window):.3f}; "
             + "; ".join(f"{k[:48]} {t:.4f} ms" for k, t in top)
             if busy > 0 else "(torch.profiler): the profiler saw no device "
             "time: not measured") + f" [{card}]")
    return ms


def time_phys_update(trainer, chunk, n, ncol, card):
    """ms per physics training update (W 3, f32) of the trainer's model on
    ``chunk`` (n updates, ncol columns), its peak memory, and one update's
    device idle share and largest kernels. Returns the ms per update."""
    def epoch():
        with torch.enable_grad():
            trainer.run_epoch(None, [chunk], 0)

    ms = median_ms(epoch, 1, repeats=OLD_REPEATS, queue_ahead=False) / n
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    epoch()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    trunk = trunk_of(trainer.model)
    print(f"physics training update, {trunk} trunk (W {PHYS_W}, huber + "
          f"energy + water, Adam, {ncol} columns, f32): {ms:.4f} ms/update, "
          f"{ncol * PHYS_W / ms * 1e3:,.0f} column-steps/s; peak memory "
          f"{peak:.3f} GB ({resident:.3f} GB resident before the epoch) "
          f"[{card}]")
    busy, top = phys_profile(trainer, {k: v[:PHYS_W] for k, v in
                                       chunk.items()}, top=12, train=True)
    print(f"physics training update, {trunk} trunk, by kernel "
          + (f"(torch.profiler device time): busy {busy:.4f} ms of the "
             f"update's {ms:.4f} ms unprofiled, idle share "
             f"{max(0.0, 1 - busy / ms):.3f}; "
             + "; ".join(f"{k[:48]} {t:.4f} ms" for k, t in top)
             if busy > 0 else "(torch.profiler): the profiler saw no device "
             "time: not measured") + f" [{card}]")
    return ms


def lbh_bounds(a9, a10) -> dict:
    """Least times of B9 and B10 from this run's inputs: their multiply-adds
    per column and level (the up projection nx 3H, for B10 the initial MLP
    nf CH and the projection (CH + nm_in) 3H; the three 3H x H products of
    the recurrences and the down projection; the heads nm H + ny nm) at the
    bf16 tensor-core peak, against each input read once and each output
    (out, mem, last_h) written once."""
    res = {}
    for key, a in (("b9", a9), ("b10", a10)):
        init = key == "b10"
        L, B = a[0].shape[:2]
        win1, whh = (a[6], a[8]) if init else (a[3], a[5])
        wlat, wout = a[-4], a[-2]
        H, (nm, ny) = whh.shape[0], wout.shape
        macs = win1.numel() + 3 * whh.numel() + wlat.numel() + wout.numel() \
            + (a[4].numel() if init else 0)
        flops = 2.0 * macs * L * B
        nbytes = float(a[0].element_size()
                       * (sum(t.numel() for t in a) + L * B * (nm + ny)
                          + B * H))
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
        res[key] = (max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops > t_bytes else "bytes", flops,
                    nbytes)
    return res


def serving_bounds(a4, flat, q6, a7h) -> dict:
    """Least times of B4, B5, B6 and B7 at H 192 from this run's inputs,
    each the larger of its operations over the card's peak rate for their
    type and its bytes (each input read once, each output written once)
    over 3.35 TB/s. B4: 3H (CH + nm_in + 3H) + nm H + ny nm multiply-adds
    per column and level; B5 and B6: FV_OPS_PER_ELEMENT per element of
    every field; B7: 9 H^2 per column and level, as phys_bounds."""
    x, mem_in = a4[0], a4[1]
    L, CH, B = x.shape
    nm_in, H = mem_in.shape[1], a4[7].shape[1]
    nm, ny = a4[13].shape[0], a4[15].shape[0]
    macs = 3 * H * (CH + nm_in + 3 * H) + nm * H + ny * nm
    out = {"b4": (2.0 * macs * L * B, PEAK_BF16,
                  float(x.element_size() * (sum(t.numel() for t in a4)
                                            + L * (nm + ny) * B + H * B)))}
    qs, u, v = flat
    for key, q in (("b5", qs), ("b6", q6)):
        out[key] = (float(FV_OPS_PER_ELEMENT * q.numel()), PEAK_F32,
                    4.0 * (2 * q.numel() + u.numel() + v.numel()))
    xp = a7h[0]
    L7, B7, H3 = xp.shape
    out["b7h"] = (2.0 * 3 * H3 * (H3 // 3) * L7 * B7, PEAK_BF16,
                  float(xp.element_size() * (sum(t.numel() for t in a7h)
                                             + L7 * B7 * H3 // 3
                                             + B7 * H3 // 3)))
    res = {}
    for key, (flops, peak, nbytes) in out.items():
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        res[key] = (max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops > t_bytes else "bytes", flops,
                    nbytes)
    return res


# ------------------------------------------------------------ the library
# yardstick of B7 and B8


LAYER_WEIGHTS = ("win1", "bin1", "whh_up", "bhh_up", "win2", "bin2",
                 "whh_dn", "bhh_dn")


def gru_pair(layer, dtype):
    """cuDNN's GRU with a FusedBiGRULayer's weights: PyTorch's cell is JAX's
    ``_gru_step`` (gates r, z, n; n = tanh(xn + r (Whh_n h + bhh_n)); h =
    (1 - z) n + z h), so with weight_ih = win.T, weight_hh = whh.T, bias_ih
    = bin and bias_hh = bhh the up GRU over the flipped levels, then the
    down GRU over the up states compute what the layer's xp GEMM and B7
    compute. Returns (run(x [L, B, nx], h0_up, h0_dn) -> (down [L, B, H],
    last_h [B, H]), its parameters). The port never calls it."""
    nx, H = layer.win1.shape[0], layer.hidden
    up, dn = torch.nn.GRU(nx, H), torch.nn.GRU(H, H)
    with torch.no_grad():
        for gru, (win, bin_, whh, bhh) in ((up, LAYER_WEIGHTS[:4]),
                                           (dn, LAYER_WEIGHTS[4:])):
            gru.weight_ih_l0.copy_(getattr(layer, win).t())
            gru.weight_hh_l0.copy_(getattr(layer, whh).t())
            gru.bias_ih_l0.copy_(getattr(layer, bin_))
            gru.bias_hh_l0.copy_(getattr(layer, bhh))
    dev = layer.win1.device
    up.to(dev, dtype)
    dn.to(dev, dtype)

    def run(x, h0_up, h0_dn):
        ups = up(x.flip(0), h0_up[None])[0].flip(0)
        down, last = dn(ups, h0_dn[None])
        return down, last[0]

    return run, [*up.parameters(), *dn.parameters()]


def library_yardstick(layer, L, B, dtype, card, label):
    """The cuDNN pair (gru_pair) at the layer's widths, L levels and B
    columns, beside FusedBiGRULayer's forward (the xp GEMM and B7) on the
    same inputs. First the pair's result is held to the plain version
    (bigru_reference_lbh on the layer's projection, f32): in bf16 within
    4x the plain version's own bf16-vs-f32 error, so that the yardstick
    computes the same function to the bf16 class, in f32 to 1e-4 of the
    states' scale. cuDNN takes no bf16 where
    torch.backends.cudnn.is_acceptable refuses it; the pair then runs in
    fp16, at the same tensor-core rate. Then the pair's forward and
    autograd's backward through it (the gradients of x, the h0s and its
    eight weights: B8's outputs and the up projection's) are timed, each
    with its device kernels by name. Returns (forward ms, backward ms, the
    layer's forward ms)."""
    from climsim_tpu_torch.ops import bigru_reference_lbh
    g = torch.Generator(device="cuda").manual_seed(L + B)
    H, nx = layer.hidden, layer.win1.shape[0]
    x = torch.tanh(torch.randn((L, B, nx), generator=g, device="cuda"))
    h0 = torch.tanh(torch.randn((2, B, H), generator=g, device="cuda"))
    w = [getattr(layer, k).detach().float() for k in LAYER_WEIGHTS]

    def plain(dt):
        xp = torch.matmul(x.to(dt), w[0].to(dt)) + w[1].to(dt)
        return bigru_reference_lbh(xp, h0[0].to(dt), h0[1].to(dt),
                                   *(t.to(dt) for t in w[2:]))

    want = plain(torch.float32)
    pdt = dtype
    if (dtype == torch.bfloat16
            and not torch.backends.cudnn.is_acceptable(x.to(dtype))):
        pdt = torch.float16
    run, params = gru_pair(layer, pdt)
    xin, hu, hd = x.to(pdt), h0[0].to(pdt), h0[1].to(pdt)
    with torch.no_grad():
        got = run(xin, hu, hd)
    err = max_err(got, want)
    if dtype == torch.float32:
        tol = 1e-4 * max(t.abs().max().item() for t in want)
        gate = "1e-4 of the states' scale"
    else:
        tol = 4.0 * max_err(plain(dtype), want)
        gate = "4x the plain version's own bf16-vs-f32 error"
    how = ("fp16: torch.backends.cudnn.is_acceptable refuses bf16"
           if pdt != dtype else str(pdt).replace("torch.", ""))
    print(f"cuDNN GRU pair {label} ({how}; torch.backends.cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}): against the plain f32 "
          f"version max_abs_err {err:.3e} (tolerance {tol:.3e}: {gate}) "
          f"[{card}]")
    check(err <= tol, f"cuDNN GRU pair {label}: {err:.3e} > {tol:.3e}")
    del got, want
    with torch.no_grad():
        fwd_ms = median_ms(lambda: run(xin, hu, hd), 3)
        xbm = x.transpose(0, 1).to(dtype).contiguous()
        hl = (h0[0].to(dtype), h0[1].to(dtype))
        layer_ms = median_ms(lambda: layer(xbm, *hl), 3)
    kernel_split(lambda: run(xin, hu, hd), fwd_ms, card,
                 f"cuDNN GRU pair forward {label}")
    ins = [xin.clone().requires_grad_(True), hu.clone().requires_grad_(True),
           hd.clone().requires_grad_(True)]
    with torch.enable_grad():
        outs = run(*ins)
    cts = [torch.randn(o.shape, generator=g, device="cuda").to(pdt)
           for o in outs]

    def bwd():
        torch.autograd.grad(outs, ins + params, cts, retain_graph=True)

    bwd_ms = median_ms(bwd, 3)
    kernel_split(bwd, bwd_ms, card, f"cuDNN GRU pair backward {label}")
    print(f"cuDNN GRU pair {label} (L {L}, H {H}, nx {nx}, B {B}, {how}): "
          f"forward {fwd_ms:.4f} ms against FusedBiGRULayer's forward (the "
          f"xp GEMM and B7, {str(dtype).replace('torch.', '')}) "
          f"{layer_ms:.4f} ms; autograd's backward through the pair "
          f"{bwd_ms:.4f} ms [{card}]")
    del outs, ins, cts
    return fwd_ms, bwd_ms, layer_ms


def heads_yardstick(layer, a, cm, card, label):
    """The library yardstick of B4 (``cm``: channel-major arguments ``a`` as
    b4_args makes them) or B9 (batch-major, b9_args): cuDNN's GRU pair
    with the fused layer's weights (gru_pair), then the latent head and
    the output head as two torch.nn.Linear (weight = wlat.T, wout.T; bias
    blat, bout), which the port never calls. For B4 the inputs are first
    permuted to the pair's [L, B, CH + nm_in] and the heads' outputs back
    to [L, nm + ny, B] (inside the timed call: they are part of what the
    library needs to compute B4's function). In bf16, fp16 where
    torch.backends.cudnn.is_acceptable refuses bf16. First held to the
    plain f32 version within 4x the plain version's own bf16-vs-f32
    error, then timed. Returns its ms."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       bigru_heads_lbh_reference)
    pdt = a[0].dtype
    if not torch.backends.cudnn.is_acceptable(a[0]):
        pdt = torch.float16
    pair, _ = gru_pair(layer, pdt)
    H, (nm, ny) = layer.hidden, layer.wout.shape
    lat, out = torch.nn.Linear(H, nm), torch.nn.Linear(nm, ny)
    with torch.no_grad():
        for lin, w, b in ((lat, "wlat", "blat"), (out, "wout", "bout")):
            lin.weight.copy_(getattr(layer, w).t())
            lin.bias.copy_(getattr(layer, b))
    lat.to(a[0].device, pdt)
    out.to(a[0].device, pdt)
    ins = [t.to(pdt) for t in (a[:4] if cm else a[:3])]

    def run():
        if cm:
            x, mem_in, h0u, h0d = ins
            xb = torch.cat([x, mem_in], 1).permute(0, 2, 1).contiguous()
            down, last = pair(xb, h0u.t().contiguous(), h0d.t().contiguous())
            mem = lat(down)
            om = torch.cat([mem, out(mem)], -1).permute(0, 2, 1).contiguous()
            return om, last.t().contiguous()
        down, last = pair(*ins)
        mem = lat(down)
        return out(mem), mem, last

    ref = bigru_heads_cm_reference if cm else bigru_heads_lbh_reference
    with torch.no_grad():
        want = ref(*(t.float() for t in a))
        own = max_err(ref(*a), want)
        got = run()
        err = max_err(got, want)
        how = ("fp16: torch.backends.cudnn.is_acceptable refuses bf16"
               if pdt != a[0].dtype else str(pdt).replace("torch.", ""))
        print(f"library yardstick of {label} (cuDNN GRU pair + 2 Linear"
              f"{', permuted' if cm else ''}; {how}): against the plain f32 "
              f"version max_abs_err {err:.3e} (tolerance {4 * own:.3e}: 4x "
              f"the plain version's own bf16-vs-f32 error) [{card}]")
        check(err <= 4 * own, f"yardstick of {label}: {err:.3e} > 4 x "
              f"{own:.3e}")
        del got, want
        ms = median_ms(run, 3)
    kernel_split(run, ms, card, f"library yardstick of {label}")
    return ms


# ------------------------------------------------------------ C.1: the
# scan sweep's backward (ROADMAP C.1), timed in turns with the earlier code

@functools.lru_cache(maxsize=None)
def select_layer_cls():
    """``RNNLayer`` with its earlier forward, which indexed the projection
    a level at a time (``xs_proj[:, l]``): each select's backward adds a
    whole zero [B, L, 3H] gradient. Kept here only, to time against."""
    from climsim_tpu_torch.models.cells import RNNLayer

    class SelectRNNLayer(RNNLayer):
        def forward(self, xs, h0):
            xs_proj = self.input_proj(xs)
            h = h0.to(xs_proj.dtype)
            L = xs.shape[1]
            ys = [None] * L
            for l in (range(L - 1, -1, -1) if self.reverse else range(L)):
                h = self.cell(h, xs_proj[:, l])
                ys[l] = h
            return torch.stack(ys, dim=1), h

    return SelectRNNLayer


@contextlib.contextmanager
def select_loop(model):
    """Every ``RNNLayer`` of ``model`` steps with the select loop inside."""
    from climsim_tpu_torch.models.cells import RNNLayer
    layers = [m for m in model.modules() if type(m) is RNNLayer]
    check(bool(layers), "no RNNLayer to switch")
    for m in layers:
        m.__class__ = select_layer_cls()
    try:
        yield
    finally:
        for m in layers:
            m.__class__ = RNNLayer


def check_c1_bits(model, card):
    """The scan arm's sweeps (bf16, H 192) at 21,600 columns: outputs,
    final carries and the gradients of the input, the carries and every
    parameter, the unbind sweep against the select loop, bit for bit."""
    from climsim_tpu_torch.models.cells import RNNLayer
    ncol = NLAT * NLON
    g = torch.Generator(device="cuda").manual_seed(41)
    for layer in [m for m in model.modules() if type(m) is RNNLayer]:
        nx = layer.input_proj.kernel.shape[0]
        H = layer.cell.hidden
        x = torch.randn((ncol, NLEV, nx), generator=g, device="cuda")
        h0 = torch.randn((ncol, H), generator=g, device="cuda")

        def run():
            xx, hh = x.clone().requires_grad_(True), h0.clone().requires_grad_(True)
            layer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                ys, h = layer(xx, hh)
                (ys.float().square().sum() + h.float().sum()).backward()
            return [ys.detach(), h.detach(), xx.grad, hh.grad] + \
                [p.grad.clone() for p in layer.parameters()]

        new = run()
        with select_loop(layer):
            old = run()
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(new, old))
        print(f"C.1: RNNLayer (reverse {layer.reverse}, {ncol} x {NLEV}, "
              f"nx {nx}, H {H}, {new[0].dtype}): outputs and {len(new) - 2} "
              f"gradients of the unbind sweep equal to the select loop's "
              f"bit for bit: {same} [{card}]")
        check(same, "C.1: the unbind sweep differs from the select loop")
        del new, old, x, h0
    model.zero_grad(set_to_none=True)


def c1_in_turns(label, model, run, n_updates, card):
    """``run()`` (n_updates training updates) with the select loop and with
    the unbind sweep in turns (select, unbind, unbind, select) after one
    run of each: ms per update from CUDA events, and each side's peak
    memory."""
    times, peaks = {True: [], False: []}, {True: 0.0, False: 0.0}
    with select_loop(model):
        run()
    run()
    for old in (True, False, False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = select_loop(model) if old else contextlib.nullcontext()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with ctx:
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
        times[old].append(e0.elapsed_time(e1) / n_updates)
        peaks[old] = max(peaks[old], torch.cuda.max_memory_allocated() / 1e9)
    print(f"C.1 in turns (select, unbind, unbind, select), {label}: select "
          f"loop {times[True][0]:.4f} / {times[True][1]:.4f} ms per update "
          f"(peak {peaks[True]:.3f} GB), unbind sweep {times[False][0]:.4f} "
          f"/ {times[False][1]:.4f} ms (peak {peaks[False]:.3f} GB) [{card}]")


def phys_c1_in_turns(card, ncol):
    """The physics model's W 3 update with the yaml's scan trunk at
    ``ncol`` columns, where the select loop's update fits the card, in
    turns with the select loop."""
    model = make_phys_model(None)
    trainer = make_phys_trainer(model, None, train=True)
    chunk = phys_chunk(PHYS_T_TRAIN, ncol, "cuda", seed=7)

    def run():
        with torch.enable_grad():
            trainer.run_epoch(None, [chunk], 0)
    c1_in_turns(f"physics update, scan trunk (W {PHYS_W}, {ncol} columns, "
                f"f32)", model, run, PHYS_T_TRAIN // PHYS_W, card)


# ------------------------------------------------------------ phase 10:
# the sharded coupled step

# the sharded step's other transports, at 384 columns against coupled_step
SHARDED_OTHER = {"semi_lagrangian": dict(scheme="semi_lagrangian"),
                 "vertical": dict(vertical_advection=True)}


def sharded_loop(model, grid, nlat, nlon, device=None, **over):
    """The v4 arm's coupled step in the production configuration (sphere
    FV, both fixers, batch-major) with the per-field plain transport, the
    one the sharded step runs (``use_pallas=False``)."""
    import dataclasses
    from climsim_tpu_torch.online import HybridLoop
    loop = make_loop(model, grid, nlat, nlon, device, "v4")
    cfg = dataclasses.replace(loop.cfg, use_pallas=False, **over)
    return HybridLoop(loop.emulator, grid, cfg, device=device)


def to_bands(loop, state, mem, x_sfc, rank=0, nranks=1):
    """Rank ``rank``'s latitude band of the columns' state in the sharded
    step's layout: fields [nlat/n, nlon, nlev], mem [nlat/n * nlon, L, nm]
    (the band's columns in grid order), x_sfc [nlat/n, nlon, ns]."""
    from climsim_tpu_torch.online import to_grid
    nlat, nlon = loop.cfg.nlat, loop.cfg.nlon
    n = nlat // nranks
    rows = slice(rank * n, (rank + 1) * n)
    tog = lambda a: to_grid(a, loop.gather_idx, nlat, nlon)[rows].contiguous()
    return ({k: tog(v) for k, v in state.items()},
            mem[loop.gather_idx][rank * n * nlon:(rank + 1) * n * nlon]
            .contiguous(), tog(x_sfc))


def sharded_rollout(step, state, mem, x_sfc, n):
    for _ in range(n):
        state, mem, diags = step(state, mem, x_sfc)
    return state, mem, diags


def sharded_err(loop, got, want):
    """The largest error of the sharded step's bands ``got`` (state, mem,
    diagnostics) against coupled_step's ``want`` in the bound of
    tests/test_online.py:416-446 (fields rtol 1e-5 / atol 1e-8, u and v
    atol 1e-5 of their largest magnitude; mem rtol 1e-5 / atol 5e-7), as a
    multiple of the bound (<= 1 passes); and the largest absolute field
    error."""
    from climsim_tpu_torch.online import to_grid
    nlat, nlon = loop.cfg.nlat, loop.cfg.nlon
    tog = lambda a: to_grid(a, loop.gather_idx, nlat, nlon)
    worst, abs_err = 0.0, 0.0
    for k, w in want[0].items():
        w = tog(w)
        atol = 1e-5 * float(w.abs().max()) if k in ("u", "v") else 1e-8
        d = (got[0][k] - w).abs()
        abs_err = max(abs_err, float(d.max()))
        worst = max(worst, float((d / (atol + 1e-5 * w.abs())).max()))
    wm = want[1][loop.gather_idx]
    worst = max(worst, float(((got[1] - wm).abs()
                              / (5e-7 + 1e-5 * wm.abs())).max()))
    return worst, abs_err


def sharded_ranks(rank, nprocs, rendezvous, out_dir):
    """One of ``nprocs`` NCCL ranks, one card each: the v4 arm's sharded
    step at 21,600 columns on this rank's band (overlap on), one step
    saved, then N_STEPS timed with CUDA events (rank 0 writes the ms)."""
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.online import sharded_hybrid_step
    from climsim_tpu_torch.parallel import init_distributed, make_mesh
    os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(rendezvous, nprocs, rank)
    try:
        dev = torch.device("cuda", rank)
        model = make_model(BF16, None, arm="v4")
        loop = sharded_loop(model, ProxyGrid(NLAT, NLON, NLEV, dev), NLAT,
                            NLON)
        bands = to_bands(loop, *initial_state(NLAT * NLON, NLEV, dev, False),
                         rank=rank, nranks=nprocs)
        step = sharded_hybrid_step(loop, make_mesh(nprocs, axis="col"))
        with torch.no_grad():
            out = step(*bands)
            torch.save({"state": {k: v.cpu() for k, v in out[0].items()},
                        "mem": out[1].cpu()},
                       os.path.join(out_dir, f"rank{rank}.pt"))
            ms = median_ms(lambda: sharded_rollout(step, *bands, N_STEPS), 1,
                           repeats=OLD_REPEATS, queue_ahead=False) / N_STEPS
        if rank == 0:
            with open(os.path.join(out_dir, "ms.json"), "w") as f:
                json.dump({"ms": ms}, f)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def check_sharded(card, model):
    """Phase 10: ``sharded_hybrid_step`` of the v4 arm (B10, bf16) on a
    one-rank NCCL group at 21,600 columns in the production configuration:
    with and without the overlap against coupled_step (sharded_err's
    bound), B10's launches per step (bulk and ghost rows with the overlap,
    the bulk alone without), ms per step (N_STEPS steps, CUDA events,
    median of OLD_REPEATS) beside the single-device step of the same
    configuration, the device idle share; semi-Lagrangian and vertical
    transport at 384 columns against coupled_step; the scaling benchmark's
    CLI at its defaults on one card; and where the machine has two cards,
    two NCCL ranks against the single-device step. Returns B10's launches
    in the 20-step run with the overlap."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.online import sharded_hybrid_step
    from climsim_tpu_torch.parallel import init_distributed, make_mesh
    ncol = NLAT * NLON
    dev = torch.device("cuda")
    init_distributed()                       # one rank, NCCL, this card
    try:
        mesh = make_mesh(1, axis="col")
        loop = sharded_loop(model, ProxyGrid(NLAT, NLON, NLEV, dev), NLAT,
                            NLON)
        inputs = initial_state(ncol, NLEV, dev, level_major=False)
        bands = to_bands(loop, *inputs)
        want = loop.coupled_step(*inputs)
        wrappers = all_wrappers()
        steps, ms, launches = {}, {}, {}
        for overlap, per_step in ((True, 2), (False, 1)):
            step = steps[overlap] = sharded_hybrid_step(loop, mesh,
                                                        overlap=overlap)
            worst, abs_err = sharded_err(loop, step(*bands), want)
            print(f"sharded step, world size 1, overlap {overlap}, {ncol} "
                  f"columns, v4 arm (B10 bf16): against coupled_step "
                  f"{worst:.3f} of the bound, largest field error "
                  f"{abs_err:.3e} [{card}]")
            check(worst <= 1.0, f"sharded step (overlap {overlap}) against "
                  f"coupled_step: {worst:.3f} of the bound")
            for w in wrappers.values():
                w.launches = 0
            st, _, diags = sharded_rollout(step, *bands, N_STEPS)
            torch.cuda.synchronize()
            launches[overlap] = {k: w.launches for k, w in wrappers.items()
                                 if w.launches}
            check(launches[overlap] == {"b10": per_step * N_STEPS},
                  f"sharded step (overlap {overlap}): launches "
                  f"{launches[overlap]} in {N_STEPS} steps, want B10 "
                  f"{per_step} a step")
            check(all(bool(torch.isfinite(v).all()) for v in st.values()),
                  "sharded state not finite")
            mean_t = float(diags["mean_T"])
            check(150 < mean_t < 350, f"sharded mean_T {mean_t}")
            ms[overlap] = median_ms(
                lambda: sharded_rollout(step, *bands, N_STEPS), 1,
                repeats=OLD_REPEATS, queue_ahead=False) / N_STEPS
        single = median_ms(lambda: loop.rollout(*inputs, N_STEPS), 1,
                           repeats=OLD_REPEATS, queue_ahead=False) / N_STEPS
        busy, top = profile_kernels(
            lambda: sharded_rollout(steps[True], *bands, 3), top=4)
        print(f"sharded step, world size 1, {ncol} columns: overlap "
              f"{ms[True]:.4f} ms/step (B10 {launches[True]['b10']} launches "
              f"in {N_STEPS} steps), no overlap {ms[False]:.4f} ms/step (B10 "
              f"{launches[False]['b10']}), coupled_step of the same "
              f"configuration {single:.4f} ms/step [{card}]")
        print("sharded step, overlap, by kernel "
              + (f"(torch.profiler device time, per step): busy "
                 f"{busy / 3:.4f} ms of {ms[True]:.4f} ms, idle share "
                 f"{max(0.0, 1 - busy / 3 / ms[True]):.3f}; "
                 + "; ".join(f"{k[:40]} {t / 3:.4f} ms" for k, t in top)
                 if busy > 0 else "(torch.profiler): the profiler saw no "
                 "device time: not measured") + f" [{card}]")
        del steps, want
        lo = LO_NLAT * LO_NLON
        grid = Grid.synthetic(lo, NLEV, device=dev)
        for name, over in SHARDED_OTHER.items():
            lloop = sharded_loop(model, grid, LO_NLAT, LO_NLON, **over)
            lin = initial_state(lo, NLEV, dev, level_major=False)
            worst, abs_err = sharded_err(lloop, sharded_hybrid_step(
                lloop, mesh)(*to_bands(lloop, *lin)), lloop.coupled_step(*lin))
            print(f"sharded step, {name}, {lo} columns: against coupled_step "
                  f"{worst:.3f} of the bound, largest field error "
                  f"{abs_err:.3e} [{card}]")
            check(worst <= 1.0, f"sharded step, {name}: {worst:.3f} of the "
                  "bound")
        run_scale_bench(card)
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            print(f"sharded step on 2 NCCL ranks: not run, this machine has "
                  f"{n_cards} GPU and NCCL takes one rank a card [{card}]")
        else:
            with tempfile.TemporaryDirectory() as tmp:
                mp.spawn(sharded_ranks, nprocs=2, join=True,
                         args=(2, "file://" + os.path.join(tmp, "rdv"), tmp))
                parts = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                         for r in range(2)]
                with open(os.path.join(tmp, "ms.json")) as f:
                    ms2 = json.load(f)["ms"]
            got = ({k: torch.cat([p["state"][k] for p in parts]).to(dev)
                    for k in parts[0]["state"]},
                   torch.cat([p["mem"] for p in parts]).to(dev))
            worst, abs_err = sharded_err(loop, got, loop.coupled_step(*inputs))
            print(f"sharded step on 2 NCCL ranks, {ncol} columns: against "
                  f"coupled_step {worst:.3f} of the bound, largest field "
                  f"error {abs_err:.3e}; {ms2:.4f} ms/step against "
                  f"{ms[True]:.4f} on one card, scaling efficiency "
                  f"{ms[True] / (2 * ms2):.3f} [{card}]")
            check(worst <= 1.0, f"2 ranks: {worst:.3f} of the bound")
    finally:
        dist.destroy_process_group()
    return launches[True]["b10"]


def run_scale_bench(card):
    """``python -m climsim_tpu_torch.cli.scale_bench --devices 1`` at its
    defaults, from a directory holding a grid file at its default place."""
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="scale_bench", dir=root)
    try:
        path = os.path.join(tmp, "grid_info", "ClimSim_low-res_grid-info.nc")
        os.makedirs(os.path.dirname(path))
        write_grid_file(path, LO_NLAT * LO_NLON)
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m",
                              "climsim_tpu_torch.cli.scale_bench",
                              "--devices", "1"], cwd=tmp, env=env,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(out.returncode == 0, f"scale_bench exit {out.returncode}: "
              f"{out.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in out.stdout.splitlines()
                 if ln.startswith("{")]
        check(len(lines) == 1 and set(lines[0]) == {
            "devices", "gridpoints_per_s", "scaling_efficiency"},
            f"scale_bench printed {out.stdout[-500:]}")
        print(f"cli scale_bench --devices 1 (64 x 128 x 60, 10 steps, one "
              f"NCCL rank): {lines[0]}; wall {wall:.1f} s with the rank's "
              f"start [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 9

# the training CLI's full-width runs: the physics yaml at the widest data
# whose scan-trunk W 3 update fits 80 GB, the GRU yaml at the full width;
# each data set is the CLI's synthetic series (24 steps, 19 for training)
PHYS_CLI_NCOL, GRU_CLI_NCOL = NLAT * NLON // 2, NLAT * NLON
PHYS_CLI_SCHEDULE = "rollout.schedule={0: 1, 1: 2, 2: 3}"
# the largest host-to-device copy an epoch may make with the device cache:
# the model's index tensors are bytes; a data window is megabytes
CLI_MAX_H2D_BYTES = 1 << 16


class ForwardCounter:
    """Counts the calls of a model class's forward with autograd on (the
    training updates) and off (validation and the scoreboard); with
    ``keep_area`` keeps each call's area fractions (the physics model's
    aux), on the host."""

    def __init__(self, cls, keep_area=False):
        self.cls, self.grad, self.nograd = cls, 0, 0
        self.keep_area, self.area_fracs = keep_area, []

    def __enter__(self):
        orig = self.orig = self.cls.forward
        counter = self

        def forward(model, *args, **kwargs):
            out = orig(model, *args, **kwargs)
            if torch.is_grad_enabled():
                counter.grad += 1
            else:
                counter.nograd += 1
            if counter.keep_area:
                counter.area_fracs.append(out[3]["area_frac"].detach().cpu())
            return out
        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


def train_cli_run(args, model_cls, keep_area=False):
    """``cli/train_rollout.py``'s main(args) as a user runs it, every launch
    counter set to 0 just before and read just after, the peak memory
    reset before, the model's forward calls counted (ForwardCounter) and
    the CLI's Run (its trainer and chunk source) kept. Returns a
    namespace: rc, lines, records, launches, wall, peak_gb, calls, run."""
    import types
    from climsim_tpu_torch.cli import train_rollout as cli
    runs = []
    orig_setup = cli.setup

    def setup(cfg):
        runs.append(orig_setup(cfg))
        return runs[-1]
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    cli.setup = setup
    try:
        with ForwardCounter(model_cls, keep_area) as calls, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        cli.setup = orig_setup
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    lines = out.getvalue().splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith('{"epoch"')]
    return types.SimpleNamespace(
        rc=rc, lines=lines, records=records, launches=launches, wall=wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, calls=calls,
        run=runs[0] if runs else None)


def cli_summary(label, r, ncol, card):
    """Print a run's records, wall time, seconds per epoch, updates,
    column-steps/s of the training epochs and peak memory."""
    for ln in r.lines:
        if ln.startswith(('{"epoch"', "resumed", "init_from")):
            print(f"  cli: {ln[:400]}")
    steps = sum(rec["updates"] * rec["window"] for rec in r.records)
    train_s = sum(rec["seconds"] for rec in r.records)
    print(f"cli train_rollout {label}: wall {r.wall:.3f} s (data, model, "
          f"{len(r.records)} epochs with validation), training "
          f"{train_s / max(len(r.records), 1):.3f} s per epoch, "
          f"{sum(rec['updates'] for rec in r.records)} updates, "
          f"{steps * ncol / max(train_s, 1e-9):,.0f} column-steps/s in the "
          f"training epochs, peak {r.peak_gb:.3f} GB, launches {r.launches} "
          f"[{card}]")


def check_cli_records(label, r, windows):
    check(r.rc == 0, f"{label}: exit {r.rc}")
    check([rec["window"] for rec in r.records] == windows,
          f"{label}: windows {[rec['window'] for rec in r.records]}")
    for rec in r.records:
        check(np.isfinite(rec["loss"]) and np.isfinite(rec["val_loss"]),
              f"{label}: record not finite: {rec}")


def check_cli_launches(label, r, kernels):
    """Per update W launches of each forward kernel and W of each backward
    one (the counted training forward calls are the updates' model steps),
    and one forward launch per validation or scoreboard model step; no
    other kernel. ``kernels``: (forward ids, backward ids)."""
    steps = sum(rec["updates"] * rec["window"] for rec in r.records)
    check(r.calls.grad == steps, f"{label}: {r.calls.grad} training model "
          f"steps, the records give {steps}")
    fwd, bwd = kernels
    want = {**{k: r.calls.grad + r.calls.nograd for k in fwd},
            **{k: r.calls.grad for k in bwd}}
    check(r.launches == want, f"{label}: launches {r.launches}, want {want}")


def profile_epoch(fn, trace_path):
    """``fn()`` once under torch.profiler (device activity only): returns
    (its result, synchronized wall ms, kernel ms, kernels launched, the
    byte counts of its host-to-device copies, None where the trace gives
    none), read from the exported chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace_path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e3
    sizes = [e.get("args", {}).get("bytes") for e in events
             if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return out, wall, busy, len(kernels), sizes


def h2d_text(sizes, detail):
    """The host-to-device copies of a profiled epoch for a summary line:
    their count and bytes (``detail(known sizes)`` appended), or "not
    measured" where the trace left their bytes out."""
    known = [b for b in sizes if b is not None]
    return f"host-to-device copies {len(sizes)}, " + (
        f"{sum(known)} bytes{detail(known)}" if len(known) == len(sizes)
        else "their bytes not in the trace: not measured")


def cli_epoch_profile(label, r, epoch, ncol, card, trace_path):
    """One more training epoch of the run's own trainer and chunks (the
    curriculum's window of ``epoch``) under torch.profiler, its launches
    not counted: the device idle share (1 - kernel time / synchronized
    wall time) and the host-to-device copies of the epoch (from the
    trace's memcpy events), which with the device cache must not include
    a data window."""
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    run = r.run
    chunks = run.chunks(0, run.ntr, True, seed=epoch)
    (_, rec), wall, busy, _, sizes = profile_epoch(
        lambda: run_epoch_fused(run.trainer, None, chunks, epoch), trace_path)
    known = [b for b in sizes if b is not None]
    window_bytes = rec["window"] * ncol * NLEV * 15 * 4
    print(f"cli train_rollout {label}: one epoch (W {rec['window']}, "
          f"{rec['updates']} updates) under torch.profiler: wall "
          f"{wall:.3f} ms, kernels {busy:.3f} ms, device idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; "
          + h2d_text(sizes, lambda k: f", the largest {max(k, default=0)} "
                     f"(one x_lev window is {window_bytes} bytes)")
          + f" [{card}]")
    check(busy > 0, f"{label}: the profiler saw no device time")
    check(len(known) < len(sizes) or max(known, default=0)
          <= CLI_MAX_H2D_BYTES,
          f"{label}: an epoch copied {max(known)} bytes to the card at once")


def witness_compare(name, records, witnesses, keys):
    """Hold a run on the card to the same run with device=cpu, given
    ``records``: each run's epoch records by tag ("cuda", "cpu" and the
    tags in ``witnesses``, CPU runs from the CPU run's initial weights
    times 1 +- 1e-6). Every epoch's value of each of ``keys`` on the card
    must lie within 1e-4 of the CPU's plus 4x the largest witness
    movement: a change at the rounding level of every weight moves the
    run as the card's rounding does, and the updates carry it on. Returns
    a description of each comparison."""
    out = []
    for e, (c_rec, p_rec) in enumerate(zip(records["cuda"], records["cpu"])):
        for k in keys:
            c, p = c_rec[k], p_rec[k]
            move = max(abs(records[t][e][k] - p) for t in witnesses)
            tol = 1e-4 * abs(p) + 4 * move
            out.append(f"epoch {e} {k} {c!r} vs {p!r} (difference "
                       f"{abs(c - p):.3e}, witness movement {move:.3e}, "
                       f"tolerance {tol:.3e})")
            check(np.isfinite(c) and abs(c - p) <= tol,
                  f"{name}: epoch {e} {k} card {c} vs CPU {p}, tolerance "
                  f"{tol}")
    return out


def compare_cli_384(card, grid, yaml, model_cls):
    """One epoch of the CLI at its default 384 columns on the card and with
    device=cpu (no kernel launched there), and two witnesses: the CPU runs
    from the CLI's own initial weights times 1 + 1e-6 and 1 - 1e-6
    (through init_from). The card's epoch-0 loss and val_loss must lie
    within 1e-4 of the CPU's (the CPU tests hold the CLI to JAX at 1e-4)
    plus 4x the larger witness movement: a change at the rounding level of
    every weight moves the forward as the card's rounding does, and the
    epoch's updates carry it on. With random weights on synthetic data
    that movement depends on the data, which the hash-salted fill of the
    v4_rnn set's dynamics inputs makes differ from process to process
    (ROADMAP C): on one CPU the physics yaml's val_loss moved 1.5e-4 under
    one salt and 3.1e-3 under another. With McICA the sample indices that
    differ card vs CPU are counted over every model call of the epoch
    (stratified_sample of each call's area fractions)."""
    from climsim_tpu_torch.cli import train_rollout as cli
    from climsim_tpu_torch.physics.radiation import stratified_sample
    from climsim_tpu_torch.train.config import load_config
    base = [yaml, f"grid_path={grid}", "epochs=1"]
    run = cli.setup(load_config(yaml, base[1:] + ["device=cpu"]))
    witnesses = []
    for sign in (1, -1):
        path = os.path.join(os.path.dirname(grid), f"witness{sign}.pt")
        torch.save({k: v * (1 + sign * 1e-6) if v.is_floating_point() else v
                    for k, v in run.trainer.model.state_dict().items()}, path)
        witnesses.append((f"witness{sign}", ["device=cpu",
                                             f"init_from={path}"]))
    run = None
    keep = model_cls.__name__ == "PhysicalRNNAutoreg"
    runs = {}
    for tag, extra in [("cuda", ["device=cuda"]), ("cpu", ["device=cpu"])] \
            + witnesses:
        r = train_cli_run(base + extra, model_cls, keep_area=keep)
        check(r.rc == 0 and len(r.records) == 1, f"{yaml} 384 {tag}: exit "
              f"{r.rc}")
        if tag != "cuda":
            check(not r.launches, f"{yaml} 384 {tag} launched {r.launches}")
        r.run = None
        runs[tag] = r
    name = os.path.basename(yaml)
    mc = ""
    if keep:
        fc, fp = runs["cuda"].calls.area_fracs, runs["cpu"].calls.area_fracs
        check(len(fc) == len(fp) > 0, "model calls card vs CPU")
        n_diff = n_idx = 0
        for af_c, af_p in zip(fc, fp):
            nreg = af_p.shape[-1]
            for G in (8, 8):            # the yaml's ng_sw, ng_lw
                ic = stratified_sample(af_c.cuda().reshape(-1, nreg), G)
                ip = stratified_sample(af_p.reshape(-1, nreg), G)
                n_diff += int((ic.cpu() != ip).sum())
                n_idx += ip.numel()
        mc = f"; {n_diff} of {n_idx} McICA sample indices differ card vs " \
             f"CPU over the epoch's {len(fp)} model calls"
        print(f"cli train_rollout {os.path.basename(yaml)} at 384 columns"
              f"{mc} [{card}]")
    worst = witness_compare(f"{name} 384",
                            {t: r.records for t, r in runs.items()},
                            [t for t, _ in witnesses], ("loss", "val_loss"))
    print(f"cli train_rollout {name} at 384 columns, 1 epoch, card against "
          f"device=cpu: " + "; ".join(worst) + mc + f" [{card}]")


def gru_c1_in_turns(r, card):
    """One chunk of the GRU yaml's scan-arm epoch (W 1) through the run's
    own trainer, the select loop in turns with the unbind sweep."""
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    run = r.run
    chunk = next(run.chunks(0, run.ntr, True, seed=1))
    n = run_epoch_fused(run.trainer, None, [chunk], 1)[1]["updates"]
    c1_in_turns(f"GRU yaml, scan arm (W 1, {GRU_CLI_NCOL} columns, f32, one "
                f"chunk of {n} updates)", run.trainer.model,
                lambda: run_epoch_fused(run.trainer, None, [chunk], 1), n,
                card)


def check_train_cli(card):
    """The training CLI (``python -m climsim_tpu_torch.cli.train_rollout``,
    through its main) on a 384-column grid file under build/: the physics
    yaml as written at 10,800 columns through the curriculum W 1, 2, 3
    with validation, the scoreboard and best-K checkpoints, then resumed
    from its best checkpoint; the GRU yaml as written (the scan arm, no
    kernel) and with model.use_pallas=true (the v2 arm: B7 and B8 in the
    f32 cluster design) at 21,600 columns; one epoch of each full-width
    run under the profiler; both yamls at 384 columns card against CPU."""
    from climsim_tpu_torch.models import PhysicalRNNAutoreg, RNNAutoreg
    from climsim_tpu_torch.ops import bigru_bwd_lbh, fused_bigru_lbh
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_cli", dir=root)
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf")
    phys_yaml = os.path.join(conf, "autoreg_physrnn.yaml")
    gru_yaml = os.path.join(conf, "autoreg_gru.yaml")
    try:
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        ck = os.path.join(tmp, "ck")
        log = os.path.join(tmp, "phys.jsonl")
        phys_args = [phys_yaml, f"grid_path={grid}",
                     f"data.ncol={PHYS_CLI_NCOL}", "epochs=3",
                     PHYS_CLI_SCHEDULE, "eval_report=true",
                     f"checkpoint_dir={ck}", f"log_path={log}"]
        torch.cuda.empty_cache()
        r = train_cli_run(phys_args, PhysicalRNNAutoreg)
        cli_summary(f"physics yaml, {PHYS_CLI_NCOL} columns", r,
                    PHYS_CLI_NCOL, card)
        check_cli_records("physics yaml", r, [1, 2, 3])
        w_water = r.run.trainer.cfg.w_water
        check(isinstance(w_water, float) and w_water == 3e7,
              f"the physics yaml's w_wcon read as {w_water!r}")
        check(r.run.trainer.model.use_pallas is False, "the physics yaml "
              "must build the scan trunk")
        check(any(ln.startswith('{"eval_report"') for ln in r.lines),
              "no eval_report")
        check_cli_launches("physics yaml", r,
                           (("b11", "b12"), ("b13", "b14")))
        with open(os.path.join(ck, "index.json")) as f:
            index = json.load(f)
        vals = [e["val_loss"] for e in index]
        check(0 < len(index) <= 3 and vals == sorted(vals),
              f"index.json {index}")
        cli_epoch_profile("physics yaml", r, 2, PHYS_CLI_NCOL, card,
                          os.path.join(tmp, "trace.json"))
        best = index[0]["epoch"]
        r = None
        gc.collect()
        torch.cuda.empty_cache()
        r = train_cli_run(phys_args[:3] + [
            "epochs=4", PHYS_CLI_SCHEDULE, f"checkpoint_dir={ck}",
            f"log_path={log}", "resume=true"], PhysicalRNNAutoreg)
        cli_summary(f"physics yaml resumed, {PHYS_CLI_NCOL} columns", r,
                    PHYS_CLI_NCOL, card)
        check(f"resumed from {ck} at epoch {best}" in r.lines,
              f"resume did not start from the best epoch {best}")
        check_cli_records("physics yaml resumed", r,
                          [min(e + 1, 3) for e in range(best + 1, 4)])
        check([rec["epoch"] for rec in r.records] == list(range(best + 1, 4)),
              "resumed epochs")
        check_cli_launches("physics yaml resumed", r,
                           (("b11", "b12"), ("b13", "b14")))
        r = None
        gc.collect()
        torch.cuda.empty_cache()

        gru_args = [gru_yaml, f"grid_path={grid}",
                    f"data.ncol={GRU_CLI_NCOL}", "epochs=2"]
        r = train_cli_run(gru_args, RNNAutoreg)
        cli_summary(f"GRU yaml (scan arm), {GRU_CLI_NCOL} columns", r,
                    GRU_CLI_NCOL, card)
        check_cli_records("GRU yaml", r, [1, 1])
        check(r.run.trainer.model.arm == "scan", r.run.trainer.model.arm)
        check(r.launches == {}, f"the scan arm launched {r.launches}")
        cli_epoch_profile("GRU yaml (scan arm)", r, 1, GRU_CLI_NCOL, card,
                          os.path.join(tmp, "trace.json"))
        gru_c1_in_turns(r, card)
        r = None
        gc.collect()
        torch.cuda.empty_cache()
        fused_bigru_lbh.design = bigru_bwd_lbh.design = None
        r = train_cli_run(gru_args + ["model.use_pallas=true"], RNNAutoreg)
        cli_summary(f"GRU yaml with model.use_pallas=true (v2 arm), "
                    f"{GRU_CLI_NCOL} columns", r, GRU_CLI_NCOL, card)
        check_cli_records("GRU yaml v2", r, [1, 1])
        check(r.run.trainer.model.arm == "v2", r.run.trainer.model.arm)
        check_cli_launches("GRU yaml v2", r, (("b7",), ("b8",)))
        designs = (fused_bigru_lbh.design, bigru_bwd_lbh.design)
        print(f"cli train_rollout GRU yaml v2: B7 design {designs[0]}, B8 "
              f"design {designs[1]} [{card}]")
        check(designs == ("f32_cluster", "f32_cluster"),
              f"the v2 arm's designs {designs}")
        cli_epoch_profile("GRU yaml (v2 arm)", r, 1, GRU_CLI_NCOL, card,
                          os.path.join(tmp, "trace.json"))
        r = None
        gc.collect()
        torch.cuda.empty_cache()

        compare_cli_384(card, grid, phys_yaml, PhysicalRNNAutoreg)
        compare_cli_384(card, grid, gru_yaml, RNNAutoreg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 12

# the offline baselines (BASELINE.json configs 1 and 2) as written, the ED
# arm on the MLP yaml, and the MLP yaml with enough data for 100 updates an
# epoch (500 steps: 153,600 training rows at batch 1536), 3 epochs
MLP_STEADY_STEPS, MLP_STEADY_EPOCHS = 500, 3
# the card-vs-CPU runs: the MLP yaml at 6 steps, and the CNN yaml at 6
# steps, depth 2 and 32 channels (its full width takes minutes a CPU
# update)
OFFLINE_SMALL = {"mlp_v1.yaml": ["data.steps=6", "epochs=2"],
                 "cnn_v1.yaml": ["data.steps=6", "epochs=2", "model.depth=2",
                                 "model.channels=32"]}


def offline_run(args, scale=None):
    """``cli/train_offline.py``'s main(args) as a user runs it, every
    launch counter set to 0 just before and read just after, the peak
    memory reset before, and the CLI's setup (its Offline: data, model,
    normalizer) kept; with ``scale`` every floating parameter of the model
    is multiplied by it after setup (the witnesses). Returns a namespace:
    rc, lines, records, launches, wall, peak_gb (above the memory held
    before the run, which earlier phases may leave), run."""
    import types
    from climsim_tpu_torch.cli import train_offline as cli
    runs = []
    orig_setup = cli.setup

    def setup(cfg):
        runs.append(orig_setup(cfg))
        if scale is not None:
            with torch.no_grad():
                for p in runs[-1].model.parameters():
                    p.mul_(scale)
        return runs[-1]
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = io.StringIO()
    cli.setup = setup
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        cli.setup = orig_setup
    lines = out.getvalue().splitlines()
    return types.SimpleNamespace(
        rc=rc, lines=lines, wall=wall, run=runs[0] if runs else None,
        records=[json.loads(ln) for ln in lines if ln.startswith('{"epoch"')],
        launches={k: w.launches for k, w in wrappers.items() if w.launches},
        peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9)


def offline_flops(model, batch):
    """Multiply-adds x 2 of one forward of ``model``'s dense and
    convolution layers on ``batch`` flat columns (60 levels for the
    convolutions and the CNN's per-level heads)."""
    from climsim_tpu_torch.models.cells import Dense
    from climsim_tpu_torch.models.cnn import CNN, Conv
    per_level = NLEV if isinstance(model, CNN) else 1
    total = 0
    for m in model.modules():
        if isinstance(m, Conv):
            k, nin, nout = m.kernel.shape
            total += 2 * batch * NLEV * k * nin * nout
        elif isinstance(m, Dense):
            nin, nout = m.kernel.shape
            total += 2 * batch * per_level * nin * nout
    return float(total)


def offline_summary(label, r, card):
    """Check a run (exit 0, finite records, no kernel launched, the
    scoreboard printed) and print its records, wall time, seconds an
    epoch (the first and the mean of the rest), samples/s, the training
    FLOP rate against the f32 CUDA-core bound, and peak memory."""
    run = r.run
    check(r.rc == 0, f"{label}: exit {r.rc}")
    check(len(r.records) == run.fc.epochs, f"{label}: {len(r.records)} "
          f"records for {run.fc.epochs} epochs")
    for rec in r.records:
        check(np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"]),
              f"{label}: record not finite: {rec}")
    check(not r.launches, f"{label} launched {r.launches}")
    check(any(ln.startswith("ptend_t ") for ln in r.lines),
          f"{label}: no scoreboard")
    for ln in r.lines:
        if ln.startswith('{"epoch"'):
            print(f"  cli: {ln[:300]}")
    bs = run.fc.batch_size
    updates = run.ntr // bs
    secs = [rec["seconds"] for rec in r.records]
    rest = secs[1:] or secs
    upd_flop = 3 * offline_flops(run.model, bs)
    rate = updates * bs / statistics.mean(rest)
    ms_update = statistics.mean(rest) / updates * 1e3
    print(f"cli train_offline {label}: wall {r.wall:.3f} s ({len(secs)} "
          f"epochs with validation and the scoreboard), training epoch "
          f"{secs[0]:.4f} s first, {statistics.mean(rest):.4f} s mean of the "
          f"rest; {updates} updates an epoch at batch {bs} ({ms_update:.3f} "
          f"ms an update), {rate:,.0f} samples/s; an update "
          f"{upd_flop / 1e9:.2f} GFLOP, {upd_flop / ms_update / 1e9:.2f} "
          f"TFLOP/s, bound {upd_flop / PEAK_F32 * 1e3:.3f} ms at the f32 "
          f"CUDA-core peak; peak {r.peak_gb:.3f} GB above the memory held "
          f"before the run; no kernel of the port "
          f"launched [{card}]")
    return ms_update


def offline_epoch_profile(label, r, card, trace_path):
    """One more training epoch of the run's model (a fresh Adam state, the
    run's batches) under torch.profiler: the device idle share (1 - kernel
    time / synchronized wall time) and the host-to-device copies the
    trace records (the shuffle's permutation, ntr x 8 bytes, and the
    512-byte feature weights are expected; the trace has been seen to
    leave such small pageable copies out)."""
    from dataclasses import replace
    from climsim_tpu_torch.train import fit, init_state
    run = r.run
    fc = replace(run.fc, epochs=1, log_path=None)
    state = init_state(run.model, fc)
    rng = np.random.default_rng(1)
    _, wall, busy, n_kernels, sizes = profile_epoch(
        lambda: fit(run.model, run.vset, fc, lambda: run.train_batches(rng),
                    None, state=state), trace_path)
    known = [b for b in sizes if b is not None]
    updates = run.ntr // fc.batch_size
    print(f"cli train_offline {label}: one training epoch ({updates} "
          f"updates) under torch.profiler: wall {wall:.3f} ms, kernels "
          f"{busy:.3f} ms ({n_kernels} launches, "
          f"{n_kernels / max(updates, 1):.1f} an update), device idle "
          f"share {max(0.0, 1 - busy / wall):.3f}; "
          + h2d_text(sizes, lambda k: f" (the permutation is {run.ntr * 8})")
          + f" [{card}]")
    check(busy > 0, f"{label}: the profiler saw no device time")
    check(len(known) < len(sizes) or sum(known) <= run.ntr * 8 + 4096,
          f"{label}: an epoch copied {sum(known)} bytes to the card")


@contextlib.contextmanager
def conv_through_cudnn():
    """Within: ``models.cnn.Conv`` computes its function through cuDNN's
    ``conv1d`` on the [B, C, L] transpose (the library call the port's one
    GEMM of the shifted copies replaces)."""
    import torch.nn.functional as F
    from climsim_tpu_torch.models.cnn import Conv
    gemm = Conv.forward

    def cudnn(self, x):
        dt = self.dtype
        return F.conv1d(x.to(dt).transpose(1, 2),
                        self.kernel.to(dt).permute(2, 1, 0),
                        self.bias.to(dt), padding="same").transpose(1, 2)
    Conv.forward = cudnn
    try:
        yield
    finally:
        Conv.forward = gemm


def cnn_conv_yardstick(card, r):
    """The CNN yaml's model (12 blocks, 406 channels, f32, no TF32): its
    forward on one batch through cuDNN's conv1d held to the port's GEMM
    (within 1e-4 of the output's scale), then one training update (MAE,
    Adam) each way timed in turns with CUDA events, and the GEMM update's
    kernels with the most device time."""
    run = r.run
    bs = run.fc.batch_size
    x, y = run.xn[:bs], run.yn[:bs]
    model = run.model
    opt = torch.optim.Adam(model.parameters(), lr=1e-6)

    def update():
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            (model(x) - y).abs().mean().backward()
        opt.step()

    def cudnn_update():
        with conv_through_cudnn():
            update()
    want = model(x)
    with conv_through_cudnn():
        got = model(x)
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= 1e-4, f"the CNN through cuDNN's conv1d differs from the "
          f"GEMM by {err:.3e} of the output's scale")
    lib, gemm = in_turns(cudnn_update, update, 1, repeats=1)
    busy, top = profile_kernels(update, top=4)
    print(f"cli train_offline cnn_v1.yaml: one update (batch {bs}) with the "
          f"convolutions as one GEMM each {gemm[0]:.3f} / {gemm[1]:.3f} ms "
          f"in turns with cuDNN's conv1d {lib[0]:.3f} / {lib[1]:.3f} ms "
          f"(forward differs by {err:.2e} of its scale); the GEMM update's "
          f"kernels: " + "; ".join(f"{k[:50]} {t:.3f} ms" for k, t in top)
          + f" of {busy:.3f} ms [{card}]")


def compare_offline_small(card, grid, yaml, over):
    """The CLI on ``yaml`` at a small size on the card and with device=cpu
    (no kernel launched on either), and one CPU witness whose initial
    weights are the CLI's times 1 + 1e-6: every epoch's train_loss and
    val_loss held by ``witness_compare`` (one witness: on an H100 either
    sign moved these losses by 0 to 1 ulp)."""
    base = [yaml, f"grid_path={grid}"] + over
    runs = {"cuda": offline_run(base + ["device=cuda"]),
            "cpu": offline_run(base + ["device=cpu"]),
            "witness": offline_run(base + ["device=cpu"], scale=1 + 1e-6)}
    for tag, r in runs.items():
        check(r.rc == 0 and len(r.records) == 2, f"{yaml} small {tag}: exit "
              f"{r.rc}")
        check(not r.launches, f"{yaml} small {tag} launched {r.launches}")
    name = os.path.basename(yaml)
    worst = witness_compare(f"{name} small",
                            {t: r.records for t, r in runs.items()},
                            ["witness"], ("train_loss", "val_loss"))
    print(f"cli train_offline {name} {' '.join(over)}, card against "
          f"device=cpu: " + "; ".join(worst) + f" [{card}]")


def write_norm_files(root, vset, nz):
    """The normalizer ``nz`` as the ClimSim norm files under
    ``root/preprocessing/normalizations`` (input mean, max = the divisor,
    min = 0, output scale), from which ``Normalizer.from_files`` gives
    ``nz`` back exactly."""
    from scipy.io import netcdf_file
    base = os.path.join(root, "preprocessing", "normalizations")
    for sub in ("inputs", "outputs"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    flat = lambda t: np.asarray(t.cpu().numpy(), np.float64)
    files = {"inputs/input_mean.nc": (vset.inputs, flat(nz.mean)),
             "inputs/input_max.nc": (vset.inputs, flat(nz.div)),
             "inputs/input_min.nc": (vset.inputs, 0 * flat(nz.div)),
             "outputs/output_scale.nc": (vset.outputs, flat(nz.scale))}
    for name, (layout, values) in files.items():
        with netcdf_file(os.path.join(base, name), "w") as f:
            f.createDimension("lev", NLEV)
            for var in layout.names:
                sl = layout.slices[var]
                dims = ("lev",) if sl.stop - sl.start == NLEV else ()
                f.createVariable(var, "d", dims)[...] = values[sl]


def boards_close(got, want, rtol=1e-5):
    """The largest difference of two scoreboards in units of rtol x |want|
    + 1e-6 x the column's largest finite magnitude (<= 1 passes); NaN and
    infinities must match."""
    worst = 0.0
    for col in next(iter(want.values())):
        w = np.array([row[col] for row in want.values()])
        g = np.array([got[n][col] for n in want])
        fin = np.isfinite(w)
        check(np.array_equal(fin, np.isfinite(g))
              and np.array_equal(w[~fin], g[~fin], equal_nan=True),
              f"scoreboard {col}: non-finite entries differ")
        scale = np.abs(w[fin]).max(initial=0.0)
        tol = rtol * np.abs(w[fin]) + 1e-6 * scale
        worst = max(worst, float(np.max(np.abs(g[fin] - w[fin])
                                        / np.maximum(tol, 1e-300),
                                        initial=0.0)))
    return worst


def check_evaluate(card, r, tmp):
    """``cli/evaluate.py`` on the MLP yaml run's validation block exported
    as flat npy files (normalized inputs, scaled targets, the trained
    model's predictions) with the run's normalizer as norm files, on the
    card: its scoreboard must equal the training CLI's (rtol 1e-5; it
    recovers ps from the normalized inputs). Its CSV path needs pandas,
    which this machine may not have."""
    import importlib.util
    from climsim_tpu_torch.cli import evaluate as ev
    from climsim_tpu_torch.cli import train_offline as cli
    run = r.run
    nval = (len(run.xn) - run.ntr) // 384 * 384
    lo, hi = run.ntr, run.ntr + nval
    with torch.no_grad():
        pred = run.model(run.xn[lo:hi])
    for name, t in (("x", run.xn[lo:hi]), ("y", run.yn[lo:hi]), ("p", pred)):
        np.save(os.path.join(tmp, f"{name}.npy"), t.cpu().numpy())
    write_norm_files(tmp, run.vset, run.nz)
    want = cli.score(run)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        board, levels, _ = ev.score(["--input", "x.npy", "--target", "y.npy",
                                     "--pred", "p.npy", "--out-lev", "l.csv",
                                     "--grid", "grid.nc"])
        wall = time.perf_counter() - t0
        has_pandas = importlib.util.find_spec("pandas") is not None
        if has_pandas:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = ev.main(["--input", "x.npy", "--target", "y.npy",
                              "--pred", "p.npy", "--grid", "grid.nc"])
            check(rc == 0 and os.path.getsize("metrics.csv") > 0,
                  "cli evaluate main")
    finally:
        os.chdir(cwd)
    worst = boards_close(board, want)
    check(worst <= 1.0, f"cli evaluate against train_offline's scoreboard: "
          f"{worst:.3f} of the bound")
    check(len(levels) == 8 and all(v.shape == (NLEV,)
                                   for v in levels.values()), "levels")
    print(f"cli evaluate on the MLP yaml's exported validation block "
          f"({nval} rows): scoreboard {worst:.3f} of the bound (rtol 1e-5) "
          f"against train_offline's, in {wall:.3f} s; ptend_t "
          f"{board['ptend_t']}; "
          + ("the CSV written through pandas" if has_pandas else
             "pandas is not installed here: the CSV path not run")
          + f" [{card}]")


def check_scoreboard_pipeline(card, grid, tmp):
    """The published scoreboard's pipeline: the rollout CLI's GRU yaml at
    384 columns for one epoch with ``pred_export`` (the raw one-step
    predictions of the validation split, flat), then ``cli/evaluate.py
    --raw --ps`` on them (v4_rnn) on the card: finite MAE and RMSE for
    every variable."""
    from climsim_tpu_torch.cli import evaluate as ev
    from climsim_tpu_torch.models import RNNAutoreg
    gru = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                       "autoreg_gru.yaml")
    out = os.path.join(tmp, "pred")
    r = train_cli_run([gru, f"grid_path={grid}", "epochs=1",
                       f"pred_export={out}"], RNNAutoreg)
    check(r.rc == 0, f"train_rollout pred_export: exit {r.rc}")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        board, _, _ = ev.score(["--vset", "v4_rnn", "--raw", "--ps",
                                "pred/scoring_ps.npy", "--target",
                                "pred/scoring_target.npy", "--pred",
                                "pred/scoring_pred.npy", "--grid", "grid.nc"])
    finally:
        os.chdir(cwd)
    check(len(board) == 14 and all(np.isfinite(v["MAE"])
                                   and np.isfinite(v["RMSE"])
                                   for v in board.values()),
          f"pred_export scoreboard {board}")
    print(f"scoreboard pipeline (train_rollout GRU yaml, 384 columns, "
          f"pred_export, then cli evaluate --raw --ps, v4_rnn): ptend_t "
          f"{board['ptend_t']}, cam_out_PRECC {board['cam_out_PRECC']} "
          f"[{card}]")


def epoch_ranks(rank, nprocs, rendezvous, out_dir):
    """One of ``nprocs`` NCCL ranks: the v4 arm's data-parallel fused
    epoch at 21,600 columns on this rank's columns; rank 0 saves the
    record and the parameters."""
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.parallel import init_distributed, make_mesh
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(rendezvous, nprocs, rank)
    try:
        tr = make_trainer(make_model(BF16, None, arm="v4"), None)
        chunk = train_chunk(T_CHUNK, NLAT * NLON, torch.device("cuda", rank))
        _, rec = run_epoch_fused(tr, None, [chunk], 0,
                                 mesh=make_mesh(nprocs, axis="data"))
        if rank == 0:
            torch.save({"rec": rec, "params": {
                k: v.cpu() for k, v in tr.model.state_dict().items()}},
                os.path.join(out_dir, "rank0.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def param_distance(model, ref):
    """The largest parameter difference in units of rtol 1e-5 x |ref| +
    0.02 x LR (<= 1 passes), and the largest absolute difference."""
    worst = largest = 0.0
    p1 = ref.state_dict()
    for k, v in model.state_dict().items():
        d = (v - p1[k]).abs()
        largest = max(largest, float(d.max()))
        worst = max(worst, float((d / (1e-5 * p1[k].abs()
                                       + 0.02 * LR)).max()))
    return worst, largest


def check_sharded_epoch(card):
    """A.17: ``run_epoch_fused(mesh=)`` of the v4 arm (bf16, B10 forward,
    B7/B8 backward) at 21,600 columns, W 4, one 16-step chunk (4
    updates), on a one-rank NCCL group against the single-device epoch
    from the same weights: the records' loss within rtol 1e-5 and every
    parameter within rtol 1e-5 plus 2% of one update's size (the learning
    rate), as tests/test_torch_train.py holds two Adam runs (at world
    size 1 the all-reduce divides by 1, so only a kernel that is not
    bit-reproducible could move them; the largest difference is printed),
    the launches (B10 2W, B7 W, B8 W an update), ms an update of each; and
    on 2 NCCL ranks where the machine has 2 cards."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.parallel import init_distributed, make_mesh
    from climsim_tpu_torch.train.rollout import run_epoch_fused
    ncol = NLAT * NLON
    chunk = train_chunk(T_CHUNK, ncol, "cuda")
    init_distributed()                       # one rank, NCCL, this card
    try:
        mesh = make_mesh(1, axis="data")
        single = make_trainer(make_model(BF16, None, arm="v4"), None)
        sharded = make_trainer(make_model(BF16, None, arm="v4"), None)
        _, rec1 = run_epoch_fused(single, None, [chunk], 0)
        wrappers = all_wrappers()
        for w in wrappers.values():
            w.launches = 0
        _, rec2 = run_epoch_fused(sharded, None, [chunk], 0, mesh=mesh)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        n = rec2["updates"]
        want = {k: c * W_TRAIN * n for k, c in TRAIN_LAUNCHES["v4"].items()}
        check(launches == want, f"sharded epoch launches {launches}, want "
              f"{want}")
        worst, largest = param_distance(sharded.model, single.model)
        check(rec1["updates"] == n == T_CHUNK // W_TRAIN, "updates")
        check(abs(rec2["loss"] - rec1["loss"]) <= 1e-5 * abs(rec1["loss"])
              and worst <= 1.0, f"sharded epoch against single-device: "
              f"loss {rec2['loss']!r} vs {rec1['loss']!r}, parameters "
              f"{worst:.3f} of the bound")
        ms = {}
        for label, fn in (("single", lambda: run_epoch_fused(
                single, None, [chunk], 0)), ("sharded", lambda: run_epoch_fused(
                sharded, None, [chunk], 0, mesh=mesh))):
            ms[label] = median_ms(fn, 1, repeats=OLD_REPEATS,
                                  queue_ahead=False) / n
        print(f"sharded fused epoch (A.17), world size 1, v4 arm bf16, "
              f"{ncol} columns, W {W_TRAIN}, {n} updates: loss "
              f"{rec2['loss']!r} vs single-device {rec1['loss']!r}, "
              f"parameters {worst:.3f} of the bound (largest difference "
              f"{largest:.3e}); launches "
              f"{launches}; {ms['sharded']:.3f} ms an update against "
              f"{ms['single']:.3f} single-device [{card}]")
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            print(f"sharded fused epoch on 2 NCCL ranks: not run, this "
                  f"machine has {n_cards} GPU and NCCL takes one rank a card "
                  f"[{card}]")
        else:
            fresh = make_trainer(make_model(BF16, None, arm="v4"), None)
            _, rec0 = run_epoch_fused(fresh, None, [chunk], 0)
            with tempfile.TemporaryDirectory() as tmp:
                mp.spawn(epoch_ranks, nprocs=2, join=True,
                         args=(2, "file://" + os.path.join(tmp, "rdv"), tmp))
                got = torch.load(os.path.join(tmp, "rank0.pt"))
            p0 = fresh.model.state_dict()
            worst2 = max(float(((v.cuda() - p0[k]).abs()
                                / (1e-5 * p0[k].abs() + 0.02 * LR)).max())
                         for k, v in got["params"].items())
            print(f"sharded fused epoch on 2 NCCL ranks, {ncol} columns: "
                  f"loss {got['rec']['loss']!r} vs {rec0['loss']!r}, "
                  f"parameters {worst2:.3f} of the bound [{card}]")
            check(worst2 <= 1.0, "2-rank sharded epoch")
    finally:
        dist.destroy_process_group()


def run_dryrun(card):
    """``python -m climsim_tpu_torch.cli.dryrun_multichip --devices 1``
    from a directory holding a grid file at its default place: its three
    OK lines."""
    gc.collect()
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dryrun", dir=os.path.join(repo, "build"))
    try:
        path = os.path.join(tmp, "grid_info", "ClimSim_low-res_grid-info.nc")
        os.makedirs(os.path.dirname(path))
        write_grid_file(path, LO_NLAT * LO_NLON)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m",
                              "climsim_tpu_torch.cli.dryrun_multichip",
                              "--devices", "1"], cwd=tmp,
                             env=dict(os.environ, PYTHONPATH=repo),
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(out.returncode == 0, f"dryrun_multichip exit {out.returncode}: "
              f"{out.stderr[-2000:]}")
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("dryrun_multichip(1)")]
        check(len(lines) == 3 and all(ln.endswith("OK") for ln in lines),
              f"dryrun_multichip printed {out.stdout[-1000:]}")
        for ln in lines:
            print(f"  {ln}")
        print(f"cli dryrun_multichip --devices 1 (one NCCL rank): 3 parts OK, "
              f"wall {wall:.1f} s with the rank's start [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_offline(card):
    """Phase 12: the offline baselines through ``python -m
    climsim_tpu_torch.cli.train_offline``'s main on a 384-column grid file
    under build/: conf/mlp_v1.yaml and conf/cnn_v1.yaml as written
    (f32, TF32 off), the MLP yaml with model.name=ed, and the MLP yaml at
    MLP_STEADY_STEPS steps (100 updates an epoch); one more epoch of the
    CNN and of the steady MLP under the profiler (the MLP yaml's 8
    updates and the ED's are launch-bound as the steady MLP's 100 are);
    both yamls small card against CPU; cli/evaluate on the MLP run's
    exported arrays and on the rollout CLI's pred_export; the
    data-parallel fused epoch (A.17); the dry run. Each step's seconds
    are printed."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="offline", dir=root)
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf")
    mlp, cnn = (os.path.join(conf, y) for y in ("mlp_v1.yaml", "cnn_v1.yaml"))
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"  phase 12: {what} took {now - last[0]:.1f} s")
        last[0] = now
    try:
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        trace = os.path.join(tmp, "trace.json")
        steady = (f"mlp_v1.yaml data.steps={MLP_STEADY_STEPS} "
                  f"epochs={MLP_STEADY_EPOCHS}")
        for label, args in (
                ("mlp_v1.yaml", [mlp]), ("cnn_v1.yaml", [cnn]),
                ("mlp_v1.yaml model.name=ed", [mlp, "model.name=ed"]),
                (steady, [mlp, f"data.steps={MLP_STEADY_STEPS}",
                          f"epochs={MLP_STEADY_EPOCHS}"])):
            gc.collect()
            torch.cuda.empty_cache()
            r = offline_run(args + [f"grid_path={grid}"])
            offline_summary(label, r, card)
            if label in ("cnn_v1.yaml", steady):
                offline_epoch_profile(label, r, card, trace)
            if label == "mlp_v1.yaml":
                check_evaluate(card, r, tmp)
            if label == "cnn_v1.yaml":
                cnn_conv_yardstick(card, r)
            r = None
            lap(label)
        check_scoreboard_pipeline(card, grid, tmp)
        lap("the scoreboard pipeline")
        for yaml, over in OFFLINE_SMALL.items():
            compare_offline_small(card, grid, os.path.join(conf, yaml), over)
            lap(f"{yaml} small, card against CPU")
        check_sharded_epoch(card)
        lap("the sharded epoch")
        run_dryrun(card)
        lap("dryrun_multichip")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from climsim_tpu_torch.ops import (_build, fused_bigru_heads_init_cm,
                                       fv_advect_tracers_sphere,
                                       bigru_heads_init_cm_reference,
                                       fv_tracers_sphere_reference,
                                       bigru_heads_cm_bwd,
                                       bigru_heads_cm_bwd_reference,
                                       bigru_reference_lbh, fused_bigru_lbh,
                                       adding_sw_fast, lw_solver_noscat_bwd)
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16

    # ---- 1. device and build
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    print(f"kernels built in {build_s:.1f} s (one nvcc per source, in "
          f"parallel)")
    for name in _build.SOURCES:
        fn = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][-60:]
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {fn}: {line.strip()}")
    check_tensor_core_sass(card)
    phase_done(1)

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    ncol = NLAT * NLON
    model = make_model(BF16, None)            # device=None: the card
    loop = make_loop(model, ProxyGrid(NLAT, NLON, NLEV, dev), NLAT, NLON,
                     None)

    # ---- 2. each kernel against its plain version
    b1_err = check_b1(model, card)
    b2_err, b2_inputs = check_b2(loop, card)
    b3_err = check_b3(model, card)
    pmodel = make_phys_model(None, use_pallas=True)  # the fused trunk
    b7_err = check_b7(pmodel, card)
    rad_errs = check_radiation(card)
    rad_errs["B11"] = max(rad_errs["B11"], check_staged(card, "b11"))
    v5model = make_model(BF16, None, arm="v5")
    b4_err = check_b4(v5model, card)
    flat_errs, flat_inputs = check_flat(card)
    v2model = make_model(BF16, None, arm="v2")
    b7h_err = check_b7(v2model, card, L=NLEV)
    b8h_err = check_b8(v2model, card, L=NLEV)
    lbh_models = {"b9": make_model(BF16, None, arm="v3"),
                  "b10": make_model(BF16, None, arm="v4")}
    b9_b10_errs = check_b9_b10(lbh_models, card)
    phase_done(2)

    # ---- 3. the main path at 21,600 columns
    state, mem, x_sfc = initial_state(ncol, NLEV, dev)
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    fv_advect_tracers_sphere.design = None
    t0 = time.perf_counter()
    st, mem1, diags = loop.rollout(state, mem, x_sfc, N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    b2_design = fv_advect_tracers_sphere.design
    check(b2_design == "tile", f"the main path's B2 ran the {b2_design} "
          "design")
    print(f"main path: {N_STEPS} coupled steps at {ncol} columns in "
          f"{wall:.3f} s (first run); launches {launches} [{card}]")
    check(launches == {"b1": N_STEPS, "b2": N_STEPS},
          f"B1 and B2 must each launch {N_STEPS} times and no other kernel, "
          f"got {launches}")
    for k, v in st.items():
        check(bool(torch.isfinite(v).all()), f"state {k} not finite")
    check(bool(torch.isfinite(mem1).all()), "mem not finite")
    mean_t = diags["mean_T"].cpu()
    check(bool(((mean_t > 150) & (mean_t < 350)).all()),
          f"mean_T out of [150, 350] K: {mean_t.tolist()}")
    check(mem1.shape == (NLEV, 16, ncol) and st["T"].shape == (ncol, NLEV),
          "output shapes")
    print(f"main path: mean_T {mean_t[0].item():.4f} -> "
          f"{mean_t[-1].item():.4f} K, energy_int "
          f"{diags['energy_int'][-1].item():.6e}")
    # the other serving arms, each with every counter set to 0 just before;
    # B5's and B6's designs as their arms' own tensors chose them
    wrappers["b5"].design = wrappers["b6"].design = None
    arm_runs = {arm: run_arm(arm, card) for arm in ARMS if arm != "v6"}
    arm_launches = {arm: run[2] for arm, run in arm_runs.items()}
    b5_design, b6_design = wrappers["b5"].design, wrappers["b6"].design
    check(b5_design == "tile", f"the v6_flat arm's B5 ran the {b5_design} "
          "design")
    check(b6_design == "tile", f"the v6_flat_per_field arm's B6 ran the "
          f"{b6_design} design")
    phase_done(3)

    # ---- 4. every serving arm at 384 columns, card against CPU; the
    # coupled step's CLI on a 384-column grid file
    for arm in ARMS:
        compare_384(card, arm)
    check_cli(card)
    phase_done(4)

    # ---- 5. gradients through the fused layers, card against CPU
    for arm in ("v6", "v5", "v3", "v4"):
        check_vjp_384(card, arm)
    phase_done(5)

    # ---- 6. the training paths at 21,600 columns (v6, and the scan and
    # v4 arms on the same data); one update of each at 384
    trainer, chunk, t_launches, n_upd = run_training(card)
    arm_trainers = {arm: run_training(card, arm, chunk)
                    for arm in ("scan", "v4")}
    v4_launches = arm_trainers["v4"][2]
    for arm in ("v6", "scan", "v4"):
        compare_train_384(card, arm)
    check_c1_bits(arm_trainers["scan"][0].model, card)
    check_wide(card)
    check_widths(card)
    phase_done(6)

    # ---- 7. the physics evaluation path at 21,600 columns, with the
    # yaml's scan trunk and the fused trunk; 384 vs CPU
    smodel = make_phys_model(None)              # the scan trunk
    run_phys_eval(smodel, card)
    adding_sw_fast.design = None
    p_launches = run_phys_eval(pmodel, card)
    b11_design = adding_sw_fast.design
    check(b11_design == "staged", f"the physics evaluation's B11 ran the "
          f"{b11_design} design")
    for use_pallas in (False, True):
        compare_phys_384(card, use_pallas)
    phase_done(7)

    # ---- 8. physics training: B8, B13 and B14 against their plain
    # versions; 2 updates at 21,600 columns with each trunk; one update of
    # each at 384 vs CPU
    b8_err = check_b8(pmodel, card)
    rad_bwd_errs = check_radiation_bwd(card)
    rad_bwd_errs["B14"] = max(rad_bwd_errs["B14"], check_staged(card, "b14"))
    torch.cuda.empty_cache()
    s_ptrainer, s_pchunk, _, _, s_pcols = run_phys_training(card)
    lw_solver_noscat_bwd.design = None
    ptrainer, pchunk, pt_launches, n_pupd, _ = run_phys_training(card, True)
    b14_design = lw_solver_noscat_bwd.design
    check(b14_design == "staged", f"the physics training's B14 ran the "
          f"{b14_design} design")
    for use_pallas in (False, True):
        compare_phys_train_384(card, use_pallas)

    phase_done(8)

    # ---- 9. the training CLI on both yamls: full width on the card, and
    # 384 columns card against CPU
    check_train_cli(card)
    phase_done(9)

    # ---- 10. the sharded coupled step (v4, B10) on a one-rank NCCL group
    # at 21,600 columns, its other transports at 384, the scaling CLI
    sharded_b10 = check_sharded(card, lbh_models["b10"])
    phase_done(10)

    # ---- 11. timings; the paths of earlier slices with OLD_REPEATS

    def step_ms(lp, s, m, x, repeats=OLD_REPEATS):
        return median_ms(lambda: lp.rollout(s, m, x, N_STEPS), 1,
                         repeats=repeats, queue_ahead=False) / N_STEPS

    hi_ms = step_ms(loop, state, mem, x_sfc, REPEATS)
    lo_ncol = LO_NLAT * LO_NLON
    lo_loop = make_loop(model, Grid.synthetic(lo_ncol, NLEV, device=dev),
                        LO_NLAT, LO_NLON, None)
    lo_state, lo_mem, lo_x = initial_state(lo_ncol, NLEV, dev)
    lo_ms = step_ms(lo_loop, lo_state, lo_mem, lo_x, REPEATS)
    print(f"coupled step, {ncol} columns: {hi_ms:.4f} ms, "
          f"{ncol / hi_ms * 1e3:,.0f} columns/s [{card}]")
    arm_split(loop, (state, mem, x_sfc), hi_ms, card, "coupled step, arm v6")
    print(f"coupled step, {lo_ncol} columns: {lo_ms:.4f} ms, "
          f"{lo_ncol / lo_ms * 1e3:,.0f} columns/s [{card}]")
    lo_v5 = make_loop(v5model, Grid.synthetic(lo_ncol, NLEV, device=dev),
                      LO_NLAT, LO_NLON, None, "v5")
    lo_v5_ms = step_ms(lo_v5, *initial_state(lo_ncol, NLEV, dev), REPEATS)
    print(f"coupled step, {lo_ncol} columns, arm v5: {lo_v5_ms:.4f} ms, "
          f"{lo_ncol / lo_v5_ms * 1e3:,.0f} columns/s [{card}]")
    del lo_v5
    for arm, (aloop, ainputs, _) in arm_runs.items():
        ms = step_ms(aloop, *ainputs)
        print(f"coupled step, {ncol} columns, arm {arm}: {ms:.4f} ms, "
              f"{ncol / ms * 1e3:,.0f} columns/s [{card}]")
        arm_split(aloop, ainputs, ms, card, f"coupled step, arm {arm}")
    del arm_runs, aloop, ainputs

    from climsim_tpu_torch.ops.pallas_rnn import (
        cudacore_bigru_heads_cm_bwd, cudacore_bigru_heads_init_cm)
    a1 = b1_args(model, ncol, torch.bfloat16, seed=7)
    b1_ms = designs_in_turns("B1", lambda: cudacore_bigru_heads_init_cm(*a1),
                             lambda: fused_bigru_heads_init_cm(*a1), card)
    kernel_split(lambda: fused_bigru_heads_init_cm(*a1), b1_ms, card,
                 "B1 bf16")
    b1_plain = median_ms(lambda: bigru_heads_init_cm_reference(*a1), 1)
    a1_32 = tuple(t.float() for t in a1)
    b1_f32 = median_ms(lambda: fused_bigru_heads_init_cm(*a1_32), 3,
                       repeats=3)
    print(f"B1 f32 (CUDA-core design) at {ncol} columns: kernel "
          f"{b1_f32:.4f} ms [{card}]")
    del a1_32
    a1_lo = b1_args(model, lo_ncol, torch.bfloat16, seed=8)
    b1_lo_ms = median_ms(lambda: fused_bigru_heads_init_cm(*a1_lo), 3)
    print(f"B1 bf16 at {lo_ncol} columns: kernel {b1_lo_ms:.4f} ms "
          f"[{card}]")
    b2_ms, b2_first = time_fv_designs(card, "B2", b2_inputs[0])
    time_fv_designs(card, "B2", b2_inputs[1])
    qs, u, v, rows = b2_inputs[0]
    b2_plain = median_ms(lambda: fv_tracers_sphere_reference(qs, u, v, rows),
                         5)

    # bounds from this run's shapes
    L, nf, B = a1[0].shape
    H, nm_in, nm, ny = a1[9].shape[1], a1[1].shape[1], a1[15].shape[0], \
        a1[17].shape[0]
    macs = H * nf + 3 * H * (H + nm_in) + 3 * 3 * H * H + nm * H + ny * nm
    b1_flops = 2.0 * macs * L * B
    b1_bytes = 2.0 * (sum(t.numel() for t in a1)
                      + L * (nm + ny) * B + H * B)
    b1_bound = max(b1_flops / PEAK_BF16, b1_bytes / PEAK_BYTES) * 1e3
    b1_by = "operations" if b1_flops / PEAK_BF16 > b1_bytes / PEAK_BYTES \
        else "bytes"
    n_el = qs.numel()
    b2_bytes = 4.0 * (2 * n_el + u.numel() + v.numel()
                      + sum(t.numel() for t in rows[:4]))
    b2_flops = float(FV_OPS_PER_ELEMENT * n_el)
    b2_bound = max(b2_flops / PEAK_F32, b2_bytes / PEAK_BYTES) * 1e3
    b2_by = "operations" if b2_flops / PEAK_F32 > b2_bytes / PEAK_BYTES \
        else "bytes"
    print(f"B1 bf16 (L {L}, H {H}, B {B}): kernel {b1_ms:.4f} ms, plain "
          f"{b1_plain:.4f} ms, bound {b1_bound:.4f} ms "
          f"({b1_flops / 1e12:.3f} TFLOP at 989 TFLOP/s; "
          f"{b1_bytes / 1e6:.1f} MB) [{card}]")
    print(f"B2 f32 {tuple(qs.shape)}: kernel {b2_ms:.4f} ms, plain "
          f"{b2_plain:.4f} ms, bound {b2_bound:.4f} ms "
          f"({b2_bytes / 1e6:.1f} MB at 3.35 TB/s) [{card}]")
    time_training(trainer, chunk, n_upd, "v6", card)
    # the scan arm (conf/autoreg_gru.yaml trains it) and the v4 arm on the
    # same data
    for arm, (atr, achunk, _, an) in arm_trainers.items():
        time_training(atr, achunk, an, arm, card, repeats=OLD_REPEATS,
                      split=True)
        if arm == "scan":
            def scan_epoch(tr=atr, c=achunk):
                with torch.enable_grad():
                    tr.run_epoch(None, [c], epoch=0)
            c1_in_turns(f"training update, arm scan (W {W_TRAIN}, remat, "
                        f"{ncol} columns, bf16)", atr.model, scan_epoch, an,
                        card)
    del arm_trainers, atr, achunk
    a3 = b3_args(model, ncol, torch.bfloat16, seed=11)
    b3_ms = designs_in_turns("B3", lambda: cudacore_bigru_heads_cm_bwd(*a3),
                             lambda: bigru_heads_cm_bwd(*a3), card, 2, 2)
    b3_plain = median_ms(lambda: bigru_heads_cm_bwd_reference(*a3), 1)
    a3_32 = (tuple(t.float() for t in a3[0]), a3[1].float(), a3[2].float())
    b3_f32 = median_ms(lambda: bigru_heads_cm_bwd(*a3_32), 1, repeats=2)
    print(f"B3 f32 (CUDA-core design) at {ncol} columns: kernel "
          f"{b3_f32:.4f} ms [{card}]")
    del a3_32
    b3_bnd, b3_by, b3_flops, b3_bytes = b3_bound(a3[0])
    print(f"B3 bf16 (L {NLEV}, H {a3[0][7].shape[1]}, B {ncol}): kernel "
          f"{b3_ms:.4f} ms, plain {b3_plain:.4f} ms, bound {b3_bnd:.4f} ms "
          f"({b3_flops / 1e12:.3f} TFLOP at 989 TFLOP/s; "
          f"{b3_bytes / 1e6:.1f} MB) [{card}]")
    kernel_split(lambda: bigru_heads_cm_bwd(*a3), b3_ms, card, "B3 bf16")

    # B4, B5, B6 and B7 at H 192 (after the training peak, so that peak
    # counts what it counted before these inputs existed)
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       fused_bigru_heads_cm,
                                       fv_tracers_reference)
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_fused_bigru_heads_cm
    a4 = b4_args(v5model, ncol, torch.bfloat16, seed=23)
    b4_ms = designs_in_turns("B4", lambda: cudacore_fused_bigru_heads_cm(*a4),
                             lambda: fused_bigru_heads_cm(*a4), card)
    kernel_split(lambda: fused_bigru_heads_cm(*a4), b4_ms, card, "B4 bf16")
    b4_f32xp_ms = median_ms(lambda: fused_bigru_heads_cm(
        *a4, hoist_proj=False), 3)
    b4_plain = median_ms(lambda: bigru_heads_cm_reference(*a4), 1)
    a4_32 = tuple(t.float() for t in a4)
    b4_f32 = median_ms(lambda: fused_bigru_heads_cm(*a4_32), 1, repeats=3)
    print(f"B4 f32 (CUDA-core design) at {ncol} columns: kernel "
          f"{b4_f32:.4f} ms [{card}]")
    del a4_32
    lib4 = heads_yardstick(v5model.bigru_fused, a4, True, card,
                           "B4 (v5 arm's shapes)")
    q5, u5, v5, dtx, dty = flat_inputs
    q6 = q5[0].contiguous()
    b5_ms, b5_first = time_fv_designs(card, "B5", (q5, u5, v5, dtx, dty))
    b5_plain = median_ms(lambda: fv_tracers_reference(q5, u5, v5, dtx, dty),
                         5)
    b6_ms, b6_first = time_fv_designs(card, "B6", (q6, u5, v5, dtx, dty))
    b6_plain = median_ms(lambda: fv_tracers_reference(q6, u5, v5, dtx, dty),
                         5)
    # B7 at the v2 arm's shapes (L 60, H 192, bf16): the tensor-core
    # design in turns with the CUDA-core one, its kernels by name; then
    # the lever of a wider column tile (clusters of 8 CTAs over 96
    # columns, the widest the warp layout takes) in turns with the plan's
    # (4 CTAs over 64 columns). Every output sums over k in the same order
    # in both, so they must agree to the bit.
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_fused_bigru_lbh
    a7h = b7_args(v2model, ncol, torch.bfloat16, seed=29, L=NLEV)
    b7h_ms = designs_in_turns("B7", lambda: cudacore_fused_bigru_lbh(*a7h),
                              lambda: fused_bigru_lbh(*a7h), card)
    kernel_split(lambda: fused_bigru_lbh(*a7h), b7h_ms, card, "B7 bf16")
    def wide():
        with b7_tiling(8, 96):
            return fused_bigru_lbh(*a7h)

    check(all(torch.equal(x, y) for x, y in zip(wide(), fused_bigru_lbh(*a7h))),
          "B7 bf16 on 96-column tiles differs from the plan's tiling")
    b7w_old, b7w_new = in_turns(lambda: fused_bigru_lbh(*a7h), wide, 3)
    print(f"B7 bf16 tiling lever in turns (plan, wider, wider, plan): "
          f"clusters of 4 over 64 columns {b7w_old[0]:.4f} / "
          f"{b7w_old[1]:.4f} ms, clusters of 8 over 96 columns "
          f"{b7w_new[0]:.4f} / {b7w_new[1]:.4f} ms (bit-identical "
          f"outputs) [{card}]")
    b7h_plain = median_ms(lambda: bigru_reference_lbh(*a7h), 1)
    # B8 at the v4 arm's shapes (L 60, H 192, bf16): its residuals are
    # B7's inputs at H 192; the tensor-core design in turns with the
    # CUDA-core one, its kernels by name, and the plain version
    from climsim_tpu_torch.ops import bigru_bwd_lbh, bigru_bwd_reference_lbh
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_bigru_bwd_lbh
    g8 = torch.Generator(device="cuda").manual_seed(30)
    a8h = (a7h, torch.randn((NLEV, ncol, a7h[1].shape[1]), generator=g8,
                            device="cuda").to(torch.bfloat16),
           torch.randn((ncol, a7h[1].shape[1]), generator=g8,
                       device="cuda").to(torch.bfloat16))
    b8h_ms = designs_in_turns("B8", lambda: cudacore_bigru_bwd_lbh(*a8h),
                              lambda: bigru_bwd_lbh(*a8h), card, 2, 2)
    b8h_plain = median_ms(lambda: bigru_bwd_reference_lbh(*a8h), 1,
                          repeats=2)
    b8h_flops, b8h_bytes = b8_work(a8h)
    b8h_bound = max(b8h_flops / PEAK_BF16, b8h_bytes / PEAK_BYTES) * 1e3
    b8h_by = ("operations" if b8h_flops / PEAK_BF16 > b8h_bytes / PEAK_BYTES
              else "bytes")
    print(f"B8 bf16 (L {NLEV}, H {a7h[1].shape[1]}, B {ncol}, the v4 "
          f"arm's shapes): kernel {b8h_ms:.4f} ms, plain {b8h_plain:.4f} "
          f"ms, bound {b8h_bound:.4f} "
          f"ms ({b8h_flops / 1e12:.4f} TFLOP at 989 TFLOP/s; "
          f"{b8h_bytes / 1e6:.1f} MB) [{card}]")
    kernel_split(lambda: bigru_bwd_lbh(*a8h), b8h_ms, card, "B8 bf16")
    del a8h
    lib_fwd, lib_bwd, layer_ms = library_yardstick(
        v2model.bigru_fused, NLEV, ncol, torch.bfloat16, card,
        "at the v2 arm's shapes")
    print(f"library yardstick, v2 arm's shapes: B7 bf16 (tensor-core) "
          f"{b7h_ms:.4f} ms, FusedBiGRULayer forward {layer_ms:.4f} ms, "
          f"cuDNN pair forward {lib_fwd:.4f} ms (layer / pair "
          f"{layer_ms / lib_fwd:.3f}); B8 bf16 (tensor-core) {b8h_ms:.4f} "
          f"ms, cuDNN pair backward {lib_bwd:.4f} ms (B8 / pair "
          f"{b8h_ms / lib_bwd:.3f}) [{card}]")
    sb = serving_bounds(a4, (q5, u5, v5), q6, a7h)
    print(f"B4 bf16 (L {NLEV}, CH {a4[0].shape[1]}, H {a4[7].shape[1]}, "
          f"B {ncol}): kernel {b4_ms:.4f} ms (tensor-core design, "
          f"projections rounded, the serving default; {b4_f32xp_ms:.4f} ms "
          f"with f32 projections), plain {b4_plain:.4f} ms, bound "
          f"{sb['b4'][0]:.4f} ms ({sb['b4'][2] / 1e12:.3f} TFLOP at 989 "
          f"TFLOP/s; {sb['b4'][3] / 1e6:.1f} MB), library yardstick "
          f"{lib4:.4f} ms (B4 / yardstick {b4_ms / lib4:.3f}) [{card}]")
    for key, name, ms, plain, shape in (
            ("b5", "B5", b5_ms, b5_plain, tuple(q5.shape)),
            ("b6", "B6", b6_ms, b6_plain, tuple(q6.shape))):
        print(f"{name} f32 {shape}: kernel {ms:.4f} ms, plain {plain:.4f} "
              f"ms, bound {sb[key][0]:.4f} ms ({sb[key][3] / 1e6:.1f} MB at "
              f"3.35 TB/s) [{card}]")
    print(f"B7 bf16 (L {NLEV}, H {a7h[1].shape[1]}, B {ncol}, the v2 arm): "
          f"kernel {b7h_ms:.4f} ms, plain {b7h_plain:.4f} ms, bound "
          f"{sb['b7h'][0]:.4f} ms ({sb['b7h'][2] / 1e12:.4f} TFLOP at 989 "
          f"TFLOP/s; {sb['b7h'][3] / 1e6:.1f} MB) [{card}]")
    from climsim_tpu_torch.ops import (bigru_heads_init_lbh_reference,
                                       bigru_heads_lbh_reference,
                                       fused_bigru_heads_init_lbh,
                                       fused_bigru_heads_lbh)
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_bigru_heads_lbh
    a9 = b9_args(lbh_models["b9"], ncol, torch.bfloat16, seed=31)
    b9_ms = designs_in_turns("B9", lambda: cudacore_bigru_heads_lbh(*a9),
                             lambda: fused_bigru_heads_lbh(*a9), card)
    kernel_split(lambda: fused_bigru_heads_lbh(*a9), b9_ms, card, "B9 bf16")
    b9_plain = median_ms(lambda: bigru_heads_lbh_reference(*a9), 1)
    lib9 = heads_yardstick(lbh_models["b9"].bigru_fused, a9, False, card,
                           "B9 (v3 arm's shapes)")
    print(f"library yardstick, v3 arm's shapes: B9 bf16 (tensor-core) "
          f"{b9_ms:.4f} ms, cuDNN pair + heads {lib9:.4f} ms (B9 / "
          f"yardstick {b9_ms / lib9:.3f}) [{card}]")
    a10 = b10_args(lbh_models["b10"], ncol, torch.bfloat16, seed=37)
    from climsim_tpu_torch.ops.pallas_rnn import cudacore_bigru_heads_init_lbh
    b10_ms = designs_in_turns(
        "B10", lambda: cudacore_bigru_heads_init_lbh(*a10),
        lambda: fused_bigru_heads_init_lbh(*a10), card)
    kernel_split(lambda: fused_bigru_heads_init_lbh(*a10), b10_ms, card,
                 "B10 bf16")
    b10_plain = median_ms(lambda: bigru_heads_init_lbh_reference(*a10), 1,
                          repeats=2)
    lb = lbh_bounds(a9, a10)
    for key, name, ms, plain, a in (("b9", "B9", b9_ms, b9_plain, a9),
                                    ("b10", "B10", b10_ms, b10_plain, a10)):
        print(f"{name} bf16 (L {NLEV}, x {tuple(a[0].shape)}, H "
              f"{a[2].shape[1]}, B {ncol}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {lb[key][0]:.4f} ms "
              f"({lb[key][2] / 1e12:.4f} TFLOP at 989 TFLOP/s; "
              f"{lb[key][3] / 1e6:.1f} MB) [{card}]")
    # the f32 instances of B9 and B10 (the CUDA-core design), and the f32
    # bounds of the kinds whose f32 runs that design: their operations at
    # the card's f32 rate against twice the bf16 bytes
    a9_32, a10_32 = tuple(t.float() for t in a9), tuple(t.float() for t in a10)
    f32_ms = {"b9": median_ms(lambda: fused_bigru_heads_lbh(*a9_32), 1,
                              repeats=3),
              "b10": median_ms(lambda: fused_bigru_heads_init_lbh(*a10_32),
                               1, repeats=3),
              "b1": b1_f32, "b3": b3_f32, "b4": b4_f32}
    del a9_32, a10_32
    f32_bound = {}
    for key, (flops, nbytes) in (("b1", (b1_flops, b1_bytes)),
                                 ("b3", (b3_flops, b3_bytes)),
                                 ("b4", (sb["b4"][2], sb["b4"][3])),
                                 ("b9", (lb["b9"][2], lb["b9"][3])),
                                 ("b10", (lb["b10"][2], lb["b10"][3]))):
        t_ops, t_bytes = flops / PEAK_F32, 2 * nbytes / PEAK_BYTES
        f32_bound[key] = (max(t_ops, t_bytes) * 1e3,
                          "operations" if t_ops > t_bytes else "bytes")
        print(f"{key.upper()} f32 (CUDA-core design, {ncol} columns): kernel "
              f"{f32_ms[key]:.4f} ms, bound {f32_bound[key][0]:.4f} ms "
              f"({flops / 1e12:.4f} TFLOP at 67 TFLOP/s f32; "
              f"{2 * nbytes / 1e6:.1f} MB) [{card}]")

    # the physics path's inputs are made here, after the training peak, so
    # that peak counts what it counted before this path existed
    sw_args, lw_args = radiation_args(ncol, "cuda")
    time_phys_eval(pmodel, card)
    time_phys_eval(smodel, card)
    from climsim_tpu_torch.ops import adding_sw_fast, lw_solver_noscat_fast
    from climsim_tpu_torch.physics.radiation import (adding_sw,
                                                     lw_solver_noscat)
    # B7 f32 at the physics trunk's shapes: the cluster FFMA design in
    # turns with the CUDA-core design (its twin), its kernels by name; the
    # CUDA-core design's tiles in device scratch in turns with shared
    # memory (the cost of the scratch mode)
    from climsim_tpu_torch.ops.pallas_rnn import (cudacore_bigru_bwd_lbh,
                                                  cudacore_fused_bigru_lbh)
    a7 = b7_args(pmodel, ncol, torch.float32, seed=13)
    b7_ms = designs_in_turns("B7", lambda: cudacore_fused_bigru_lbh(*a7),
                             lambda: fused_bigru_lbh(*a7), card,
                             new="cluster", dt="f32")
    kernel_split(lambda: fused_bigru_lbh(*a7), b7_ms, card, "B7 f32")

    def b7_scratch():
        with tiles_in_scratch():
            return cudacore_fused_bigru_lbh(*a7)

    s7_old, s7_new = in_turns(lambda: cudacore_fused_bigru_lbh(*a7),
                              b7_scratch, 3)
    print(f"B7 f32 CUDA-core design, tiles in shared memory against device "
          f"scratch, in turns (shared, scratch, scratch, shared): "
          f"{s7_old[0]:.4f} / {s7_old[1]:.4f} ms against {s7_new[0]:.4f} / "
          f"{s7_new[1]:.4f} ms [{card}]")
    b7_plain = median_ms(lambda: bigru_reference_lbh(*a7), 1)
    sw_ms, sw_first = time_staged(card, "b11", sw_args)
    sw_plain = median_ms(lambda: adding_sw(*sw_args), 3)
    lw_ms = median_ms(lambda: lw_solver_noscat_fast(*lw_args), 50)
    lw_plain = median_ms(lambda: lw_solver_noscat(*lw_args), 3)
    pb = phys_bounds(a7, sw_args, lw_args)
    L7, B7, H7 = a7[0].shape[0], a7[0].shape[1], a7[0].shape[2] // 3
    print(f"B7 f32 (L {L7}, H {H7}, B {B7}): kernel {b7_ms:.4f} ms, plain "
          f"{b7_plain:.4f} ms, bound {pb['b7'][0]:.4f} ms "
          f"({pb['b7'][2] / 1e12:.4f} TFLOP at 67 TFLOP/s f32, "
          f"{pb['b7'][2] / PEAK_TF32 * 1e3:.4f} ms at the 495 TFLOP/s TF32 "
          f"rate the f32 policy does not permit; {pb['b7'][3] / 1e6:.1f} MB)"
          f" [{card}]")
    lib7_32, lib8_32, _ = library_yardstick(
        pmodel.bigru_fused, L7, B7, torch.float32, card,
        "at the physics trunk's shapes")
    for key, name, ms, plain in (("b11", "B11", sw_ms, sw_plain),
                                 ("b12", "B12", lw_ms, lw_plain)):
        print(f"{name} f32 ({ncol}, {NLEV}, 8): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {pb[key][0]:.4f} ms "
              f"({pb[key][3] / 1e6:.1f} MB at 3.35 TB/s) [{card}]")

    # the physics training update: its time, peak memory and profiler split.
    # Its peak needs most of the card, so the earlier phases' inputs go
    # first (the solvers' inputs are made again, from their seed, for the
    # backward kernels' timings)
    del a1, a1_lo, a3, trainer, chunk, a7, sw_args, lw_args
    del a4, a7h, a9, a10, flat_inputs, q5, u5, v5, q6
    torch.cuda.empty_cache()

    time_phys_update(s_ptrainer, s_pchunk, n_pupd, s_pcols, card)
    del s_ptrainer, s_pchunk
    gc.collect()
    torch.cuda.empty_cache()
    phys_c1_in_turns(card, PHYS_CLI_NCOL)
    gc.collect()
    torch.cuda.empty_cache()
    time_phys_update(ptrainer, pchunk, n_pupd, ncol, card)
    from climsim_tpu_torch.ops import (adding_sw_bwd, adding_sw_bwd_reference,
                                       bigru_bwd_lbh, bigru_bwd_reference_lbh,
                                       lw_solver_noscat_bwd,
                                       lw_solver_noscat_bwd_reference)
    sw_args, lw_args = radiation_args(ncol, "cuda")
    a8 = b8_args(pmodel, ncol, torch.float32, seed=17)
    b8_ms = designs_in_turns("B8", lambda: cudacore_bigru_bwd_lbh(*a8),
                             lambda: bigru_bwd_lbh(*a8), card, 2, 2,
                             new="cluster", dt="f32")
    kernel_split(lambda: bigru_bwd_lbh(*a8), b8_ms, card, "B8 f32")

    def b8_scratch():
        with tiles_in_scratch():
            return cudacore_bigru_bwd_lbh(*a8)

    s8_old, s8_new = in_turns(lambda: cudacore_bigru_bwd_lbh(*a8),
                              b8_scratch, 1, 2)
    print(f"B8 f32 CUDA-core design, tiles in shared memory against device "
          f"scratch, in turns (shared, scratch, scratch, shared): "
          f"{s8_old[0]:.4f} / {s8_old[1]:.4f} ms against {s8_new[0]:.4f} / "
          f"{s8_new[1]:.4f} ms [{card}]")
    b8_plain = median_ms(lambda: bigru_bwd_reference_lbh(*a8), 1)
    sw_cts, lw_cts = radiation_cts(sw_args, 3), radiation_cts(lw_args, 2)
    from climsim_tpu_torch.ops.pallas_radiation import scratch_adding_sw_bwd
    b13_old, b13_new = in_turns(lambda: scratch_adding_sw_bwd(sw_args, sw_cts),
                                lambda: adding_sw_bwd(sw_args, sw_cts), 50)
    b13_ms = statistics.mean(b13_new)
    print(f"B13 f32 at ({ncol}, {NLEV}, 8) in turns (first, second, second, "
          f"first): first design (device scratch, four sweeps) "
          f"{b13_old[0]:.4f} / {b13_old[1]:.4f} ms, second design (two "
          f"passes, the replay parked in shared memory) {b13_new[0]:.4f} / "
          f"{b13_new[1]:.4f} ms [{card}]")
    b13_plain = median_ms(lambda: adding_sw_bwd_reference(sw_args, sw_cts), 3)
    b14_ms, b14_first = time_staged(card, "b14", lw_args, lw_cts)
    b14_plain = median_ms(lambda: lw_solver_noscat_bwd_reference(lw_args,
                                                                 lw_cts), 3)
    pbb = phys_bwd_bounds(a8, sw_args, lw_args)
    print(f"B8 f32 (L {L7}, H {H7}, B {B7}): kernel {b8_ms:.4f} ms, plain "
          f"{b8_plain:.4f} ms, bound {pbb['b8'][0]:.4f} ms "
          f"({pbb['b8'][2] / 1e12:.4f} TFLOP at 67 TFLOP/s f32; "
          f"{pbb['b8'][3] / 1e6:.1f} MB) [{card}]")
    for key, name, ms, plain in (("b13", "B13", b13_ms, b13_plain),
                                 ("b14", "B14", b14_ms, b14_plain)):
        print(f"{name} f32 ({ncol}, {NLEV}, 8): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {pbb[key][0]:.4f} ms "
              f"({pbb[key][3] / 1e6:.1f} MB at 3.35 TB/s; "
              f"{pbb[key][2] / 1e9:.3f} GFLOP) [{card}]")

    phase_done(11)

    # ---- 12. the offline baselines and their scoreboard, the
    # data-parallel rollout epoch and the dry run
    check_offline(card)
    phase_done(12)

    # ---- 13. the kernels line, the card line, the result
    kernels = [
        {"name": "bigru_heads_init_cm", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_init_cm.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:1877",
         "launches": launches["b1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None},
        {"name": "fv_tracers_sphere", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/fv_tracers_sphere.cu",
         "replaces": "climsim_tpu/ops/pallas_stencil.py:226",
         "launches": launches["b2"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None, "design": b2_design,
         "first_design_ms": b2_first},
        {"name": "bigru_heads_cm_bwd", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_cm_bwd.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:1281",
         "launches": t_launches["b3"], "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bnd,
         "bound_by": b3_by, "library_ms": None},
        {"name": "bigru_lbh", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_lbh.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:98",
         "launches": arm_launches["v2"]["b7"], "max_abs_err": b7h_err,
         "ms": b7h_ms, "plain_ms": b7h_plain, "bound_ms": sb["b7h"][0],
         "bound_by": sb["b7h"][1], "library_ms": lib_fwd,
         "f32": {"launches": p_launches["b7"], "max_abs_err": b7_err,
                 "ms": b7_ms, "plain_ms": b7_plain, "bound_ms": pb["b7"][0],
                 "bound_by": pb["b7"][1], "library_ms": lib7_32}},
        {"name": "adding_sw", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/adding_sw.cu",
         "replaces": "climsim_tpu/ops/pallas_radiation.py:30",
         "launches": p_launches["b11"], "max_abs_err": rad_errs["B11"],
         "ms": sw_ms, "plain_ms": sw_plain, "bound_ms": pb["b11"][0],
         "bound_by": pb["b11"][1], "library_ms": None,
         "design": b11_design, "first_design_ms": sw_first},
        {"name": "lw_noscat", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/lw_noscat.cu",
         "replaces": "climsim_tpu/ops/pallas_radiation.py:123",
         "launches": p_launches["b12"], "max_abs_err": rad_errs["B12"],
         "ms": lw_ms, "plain_ms": lw_plain, "bound_ms": pb["b12"][0],
         "bound_by": pb["b12"][1], "library_ms": None},
        {"name": "bigru_lbh_bwd", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_lbh_bwd.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:391",
         "launches": v4_launches["b8"], "max_abs_err": b8h_err,
         "ms": b8h_ms, "plain_ms": b8h_plain, "bound_ms": b8h_bound,
         "bound_by": b8h_by, "library_ms": lib_bwd,
         "f32": {"launches": pt_launches["b8"], "max_abs_err": b8_err,
                 "ms": b8_ms, "plain_ms": b8_plain,
                 "bound_ms": pbb["b8"][0], "bound_by": pbb["b8"][1],
                 "library_ms": lib8_32}},
        {"name": "adding_sw_bwd", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/adding_sw_bwd.cu",
         "replaces": "climsim_tpu/ops/pallas_radiation.py:189",
         "launches": pt_launches["b13"], "max_abs_err": rad_bwd_errs["B13"],
         "ms": b13_ms, "plain_ms": b13_plain, "bound_ms": pbb["b13"][0],
         "bound_by": pbb["b13"][1], "library_ms": None},
        {"name": "lw_noscat_bwd", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/lw_noscat_bwd.cu",
         "replaces": "climsim_tpu/ops/pallas_radiation.py:336",
         "launches": pt_launches["b14"], "max_abs_err": rad_bwd_errs["B14"],
         "ms": b14_ms, "plain_ms": b14_plain, "bound_ms": pbb["b14"][0],
         "bound_by": pbb["b14"][1], "library_ms": None,
         "design": b14_design, "first_design_ms": b14_first},
        {"name": "bigru_heads_cm", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_cm.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:887",
         "launches": arm_launches["v5"]["b4"], "max_abs_err": b4_err,
         "ms": b4_ms, "plain_ms": b4_plain, "bound_ms": sb["b4"][0],
         "bound_by": sb["b4"][1], "library_ms": lib4},
        {"name": "fv_tracers_flat", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/fv_tracers_flat.cu",
         "replaces": "climsim_tpu/ops/pallas_stencil.py:108",
         "launches": arm_launches["v6_flat"]["b5"],
         "max_abs_err": flat_errs["B5"], "ms": b5_ms, "plain_ms": b5_plain,
         "bound_ms": sb["b5"][0], "bound_by": sb["b5"][1],
         "library_ms": None, "design": b5_design,
         "first_design_ms": b5_first},
        {"name": "fv_levels_flat", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/fv_tracers_flat.cu",
         "replaces": "climsim_tpu/ops/pallas_stencil.py:35",
         "launches": arm_launches["v6_flat_per_field"]["b6"],
         "max_abs_err": flat_errs["B6"], "ms": b6_ms, "plain_ms": b6_plain,
         "bound_ms": sb["b6"][0], "bound_by": sb["b6"][1],
         "library_ms": None, "design": b6_design,
         "first_design_ms": b6_first},
        {"name": "bigru_heads_lbh", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_lbh.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:635",
         "launches": arm_launches["v3"]["b9"],
         "max_abs_err": b9_b10_errs["b9"], "ms": b9_ms, "plain_ms": b9_plain,
         "bound_ms": lb["b9"][0], "bound_by": lb["b9"][1],
         "library_ms": lib9},
        {"name": "bigru_heads_init_lbh", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_lbh.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:1650",
         "launches": arm_launches["v4"]["b10"],
         "max_abs_err": b9_b10_errs["b10"], "ms": b10_ms,
         "plain_ms": b10_plain, "bound_ms": lb["b10"][0],
         "bound_by": lb["b10"][1], "library_ms": None,
         "sharded_step_launches": sharded_b10},
    ]
    # the f32 instances of the kinds whose f32 runs the CUDA-core design
    f32_of = {"bigru_heads_init_cm": "b1", "bigru_heads_cm_bwd": "b3",
              "bigru_heads_cm": "b4", "bigru_heads_lbh": "b9",
              "bigru_heads_init_lbh": "b10"}
    for k in kernels:
        if k["name"] in f32_of:
            key = f32_of[k["name"]]
            k["f32"] = {"ms": f32_ms[key], "bound_ms": f32_bound[key][0],
                        "bound_by": f32_bound[key][1]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
