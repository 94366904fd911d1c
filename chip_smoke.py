#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # every phase, ending in the result line
    python3 chip_smoke.py 14       # the build, then phase 14 alone
    python3 chip_smoke.py 15       # the build, then phase 15 alone
    python3 chip_smoke.py 16       # the build, then phase 16 alone
    python3 chip_smoke.py 17       # the build, then phase 17 alone
    python3 chip_smoke.py 18       # the build, then phase 18 alone
    python3 chip_smoke.py previous DIR   # B1 and B10 against the build of
                                         # an earlier checkout at DIR, in
                                         # turns; then phase 16

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
* the deployment export: the rollout CLI's emulator at
  conf/autoreg_gru.yaml's widths in the raw-units ``OnlineWrapper``,
  exported as a ``torch.export`` program whose kernel is a ``climsim::``
  custom op, reloaded in a fresh process, validated, and served in int8;
  the physics yaml's ``export_path``.
* stochastic ensemble training and the optimizers: the rollout CLI on
  ``conf/autoreg_srnn.yaml`` (the stochastic third layer, AR(1) noise, a
  4-member ensemble on CRPS) and ``conf/autoreg_longwindows.yaml`` (SOAP,
  windows up to 11 steps with remat); both run the scan trunk and launch
  no kernel, as in JAX. Before them, C.2's repair: no coupled step or
  wrapper step waits on the host.
* the offline trainer's other arms, ``cli/train_offline.py`` on
  ``conf/mlp_v1.yaml``: the stochastic stack (RPN ensembles of 8 and 32
  members, HSR, cVAE; BASELINE.json config 4's offline half) ending in
  the CRPS scoreboard, the ClimSim-Online U-Net on v4 at its published
  width and the v5 cloud classifier with its checkpoint and
  ``init_from``; none reaches a Pallas kernel in JAX, so no kernel of the
  port may launch. The dry run's ensemble-parallel RPN step on a (1, 1)
  NCCL mesh.
* the physics model's other options (TripleClouds, learned cloud optics,
  the BF16 policy, the ML radiation heads, separate radiation) in
  evaluation and training at 10,800 columns, and semi-online rollout
  training of the v4 arm at 21,600 columns.

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (one nvcc
     per source, all started together), print each kernel's registers and
     spills, and count the tensor-core instructions (HMMA/HGMMA) of the
     bf16 designs of B1, B3, B4 and B7-B10 in their SASS (cuobjdump):
     each must have some; and the f32 cluster design of B7 and B8 must
     have FFMA and no tensor-core (so no TF32) instruction; B1's and
     B10's libraries: every bf16-gate instance packed bf16 arithmetic,
     MUFU.EX2 and MUFU.RCP, the f32-gate instances' listing unchanged
     (F32_GATE_SASS);
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
     arm: no kernel; one epoch) and with model.use_pallas=true (the v2 arm: B7 per
     model step, B8 W per update, both in the f32 cluster design); each
     with its wall time, seconds per epoch, updates, column-steps/s and
     peak memory, and one more epoch of each under torch.profiler (device
     idle share; the host-to-device copies, which with the device cache
     must hold no data window); then both yamls at 384 columns for one
     epoch on the card, held to device=cpu in lockstep
     (compare_cli_384): from the card's state before each update the
     CPU's loss and gradients, the CPU's Adam step from the card's
     gradients, and the CPU's validation of the card's final weights,
     with the physics model's discrete choices replayed;
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
 11. timings with CUDA events (one repeat after a warm-up call
     everywhere; earlier versions of this script took 2 to 5),
     peak memory and
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
     beside the kernel;
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
 13. the deployment export (check_export): the rollout CLI's v4_rnn
     emulator at conf/autoreg_gru.yaml's widths (nneur 192/192, nh_mem
     16, add_pres, nx 15, ny 5, bf16) in its v4, v2 and v3 arms, each in
     ``export.OnlineWrapper`` (mp_mode 1) and exported with
     ``export_wrapper`` at 384 and 21,600 columns: the graph holds the
     arm's kernel as one climsim:: node, the eager wrapper launches it
     once a call (ms a step, and the pre-processing's and the model's);
     all six artifacts reloaded in one fresh process that builds no model
     (reload_exports): the kernel once a call, the outputs bit-equal to
     the eager wrapper's (or within 1e-6 of their scale), ms a step;
     ``validate_export`` of the reloaded 384-column v4 artifact over an
     8-step synthetic raw series against the eager wrapper (passed, no
     error); ``conf/autoreg_physrnn.yaml`` as written through the rollout
     CLI at 384 columns, 1 epoch, with export_path: the artifact reloaded
     launches B11 and B12 as the eager forward and equals it; the v6 (B1)
     and v5 (B4) models' forward through ``export_step`` at 21,600
     columns, reloaded equal; ``QuantGRUForward`` at 21,600 columns
     against the f32 scan forward (JAX's gates: relative RMS < 0.05,
     correlation > 0.99; ms of each); ``cli.profile --steps 3`` (its trace
     holds device kernels); each forward kernel through its climsim:: op
     in turns with its CUDA implementation called directly;
 14. the slice of the stochastic ensemble and the optimizers
     (check_stochastic_slice): C.2 first, a coupled step of every
     RNNAutoreg arm (v6, v5, v4, v3, v2, scan) at 21,600 columns and the
     eager wrapper step (v4, v2, v3 at 384 and 21,600 columns) with no
     synchronizing CUDA operation (``set_sync_debug_mode`` "warn" lists
     none, "error" raises none), each timed in turns against the list
     index of before (ListToaIndex), the coupled steps at 384 columns;
     ``conf/autoreg_srnn.yaml`` (stochastic sgru layer, AR(1) noise rho
     0.95, a 4-member ensemble on CRPS) through the CLI with
     model.use_pallas=true at the widest of 21,600, 10,800, 5,400 or
     2,700 columns whose W 3 update fits (srnn_width: one update measured
     at 2,700 columns, its peak scaled), its curriculum compressed to
     W 1, 2, 3, no kernel launched, ms an update for each W, member
     column-steps/s, the peak, and one more epoch under the profiler (the
     idle share); ``conf/autoreg_longwindows.yaml`` (SOAP, remat, mixed
     replay) through the CLI at 21,600 columns with W 1, 5 and 11, no
     kernel launched, ms an update for each W and the peak; SOAP's plain
     and refresh steps, Muon's, schedule-free AdamW's and Adam's on that
     model's parameters; both yamls at 384 columns held to device=cpu in
     lockstep (compare_cli_384: the ensemble's noise draws replayed on the
     CPU, SOAP fed the card's state and gradient);
 15. the offline CLI's other arms (check_offline_new_arms): through
     ``python -m climsim_tpu_torch.cli.train_offline``'s main on a
     384-column grid file, conf/mlp_v1.yaml as written (10 epochs, 40
     steps, batch 1536) with model.name=rpn (8 members, and 32), hsr and
     cvae (each ending in the scoreboard with CRPS), vset=v4
     model.name=unet at the published width (128 channels, (1, 2, 2, 2),
     4 blocks, attention at 16, output prune), and vset=v5
     model.name=classifier_gradout with max_grad_norm 1.0 and a
     checkpoint, then init_from that checkpoint for 1 epoch (its first
     train_ce below the cold start's); each with no kernel of the port
     launched, seconds an epoch, ms an update, samples/s (member
     samples/s for RPN), the update's FLOP rate (FlopCounterMode) against
     the f32 bound and the peak; one more epoch of RPN, HSR, cVAE and the
     classifier through the CLI's own epoch (``stochastic_epoch``,
     ``classifier_epoch``) under the profiler (idle share), with the
     classifier's kernels by name and its update timed with and without
     the gradout statistics and clipping; one more U-Net epoch under the
     profiler (idle share) and one update's kernels by name (GEMMs, no
     FFT kernel); each arm small (6 steps, narrow; HSR 3 epochs) on the
     card against device=cpu, the stochastic arms' draws replayed
     (NoiseLog, through main's ``noise_source``), every epoch's losses
     within 1e-4 plus 4x the movement of a witness (the weights x (1 +
     1e-6)) and every scoreboard entry (CRPS included) within 1e-4 plus
     4x the larger movement of that witness and a data witness (the CPU
     run on the card's data); the dry run's ensemble step
     (``dryrun_multichip.ensemble_step``) on a one-rank NCCL group, a
     (1, 1) mesh, bit-equal to the single-device step; ``python3
     chip_smoke.py 15`` runs the build and phase 15 alone;
 16. the GRU forwards' bf16-gate mode (check_gate_mode_and_a12): the
     bf16-gate step (ops/csrc/gates16.cuh) against the accurate forms it
     replaced on all 65,536 bf16 inputs of the sigmoid and the typed tanh
     and on 10^7 seeded operand sets, 0 mismatches (check_gate_step);
     in each fused arm (v6, v5 with both hoist_proj bodies, v2, v3, v4)
     built with pallas_acc32=False on the acc32=True model's weights, one
     coupled step at 21,600 columns with every counter at 0 (the arm's
     kernel once, its design "tensor_core+bf16_gates"), each field held to
     the same step run through the plain bf16-gate version on the card
     (plain_kernels) by g16_ok: its mean distance from it at most half the mean distance
     between the plain bf16-gate and f32-gate steps and below its own
     distance from the f32-gate step (a launch that ran f32 gates fails),
     its largest within 4x the modes' largest plus 1e-3 of scale; the v6
     step timed in turns with f32 gates; each of B1, B4 (both bodies), B7,
     B9 and B10 alone at the flagship's bf16 shapes against its plain
     bf16-gate version (g16_ok), timed in turns with its f32-gate mode,
     the tie rule's expf inputs among the plain version's counted; the
     v6 model's gradients at 2,700 columns under both
     modes bit-equal (fixed cotangents; B3 linearises the f32-gate
     forward); a v4 OnlineWrapper over a pallas_acc32=False model exported
     at 384 columns, its climsim:: node carrying acc32=False, reloaded
     bit-equal with the bf16-gate B10 once; the library yardsticks of B1
     and B10 (the cuDNN pair, the initial MLP and the heads as torch
     modules) and B3 (autograd's backward through B4's yardstick), and
     with TF32 off those of the f32 B1, B4, B9, B10 and B3; then
     RNNAutoreg's other options (ROADMAP A.12: lstm, ln_lstm, sru, qrnn,
     separate_radiation with 16 level inputs and a 50-level memory,
     memory None) at nneur 192/192, f32, A12_STEPS coupled steps at
     21,600 columns (no emulator kernel: B2 once a step) and 2 steps at
     384 columns card against device=cpu within 1e-5 of scale plus 4x the
     CPU's movement under weights x (1 + 1e-6); the training CLI on
     conf/autoreg_gru.yaml with model.cell=lstm and with
     model.memory=None, one epoch at 384 columns each; ``python3
     chip_smoke.py 16`` runs the build and phase 16 alone;
 17. the physics model's other options (check_phys_options, ROADMAP
     A.11): six arms of conf/autoreg_physrnn.yaml's model at 10,800
     columns (PHYS17_ARMS: TripleClouds, learned cloud optics and the BF16
     policy with the fused trunk on the yaml as written; the ML radiation
     heads with the fused trunk on all 60 levels, separate radiation with
     the scan and the fused trunk), each a W 3 evaluation window and a W 1
     update with every counter at 0 (the arm's kernels once a model step:
     B7/B8 for the fused trunk, B12/B14 with physical radiation and
     B11/B13 but under TripleClouds, whose SW is the plain adding_sw_tc),
     the first launch of each kernel held to its plain version on the same
     inputs (captured_launches, held_to_plain), ms a model step and a W 1
     update, peak GB and idle share; each arm's W 1 update at 384 columns
     and nneur 32 against device=cpu in lockstep (the McICA and top-2
     choices replayed); then the semi-online update (A.7) of the v4 arm
     (bf16, W 3, remat) at 21,600 columns (B10 6, B7 3, B8 3 launches,
     each held to its plain version); ``python3 chip_smoke.py 17`` runs
     the build and phase 17 alone;
 18. the last modules of the JAX package (check_last_modules, ROADMAP
     A.13, A.14): the CfC liquid network (models/ncp.py) dense and wired
     over AutoNCP(192, 6, 0.5), both with the LSTM memory, at 21,600
     columns x 60 levels x 6 inputs (units 192, backbone 128, f32, TF32
     off): a forward (its kernels counted by torch.profiler) and an Adam
     update timed, the update's peak memory, and at 384 columns outputs
     and gradients against device=cpu within 1e-5 of scale;
     train/hpo.py's random_search over the flagship v6 model (bf16):
     four trials of two W 1 updates at 2,700 columns and a validation
     window, each with every counter at 0 (a solo update's B1 and B3
     launches x 2, B1 2 in validation), every score finite and one attempt
     a trial, B1 and B3 held to their plain versions at those shapes;
     parallel_random_search of 16 dense-CfC trials (SGD through
     torch.func at 2,700 columns) in vmapped batches of 8 grouped by
     width, its device passes counted and each score within 1e-4 of the
     sequential search's; the data tools at 21,600 columns against
     device=cpu: pack_pair of two classic netCDF v5 pairs (relative
     humidity and a LevelNormalizer on the card), expand_features on 24
     steps (bit-equal), export_kaggle_files from a Normalizer on the card
     (byte-equal); whether tensorstore and h5py are present (their paths
     run in the CPU tests only); ``python3 chip_smoke.py 18`` runs the
     build and phase 18 alone;
 19. a JSON line of the kernels (B7's and B8's entries: the bf16
     tensor-core design at the v2/v4 arms' shapes, with the f32 design at
     the physics trunk's under "f32"; their "library_ms" the cuDNN pair's
     forward and backward, B4's and B9's the pair with the heads, B1's and
     B10's the pair with the heads and the initial MLP, B3's autograd's
     backward through B4's, the f32 CUDA-core instances of B1, B3, B4, B9
     and B10 under "f32" with their f32 yardsticks; the five forwards'
     bf16-gate mode under "bf16_gates" (with the share of its
     exponentials the tie rule sends to expf), B4's other body under its
     "hoist_proj_false"; the
     launches and errors of phase 17 under "phys_options"; B1's and B3's
     launches a trial of phase 18's search under "hpo"), the card line,
     and the result line.
The end of each phase prints the wall time since the start and the
phase's own; phases 12, 13, 14, 15 and 18 print each of their steps'
seconds.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import io
import json
import os
import re
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
# timing repeats: 1 for every timing after a warm-up call (earlier
# versions of this script took 2 to 5), to hold the run's time as the
# paths grow: with 2 the whole run took 1,183 s of its 1,200 on a slow
# host; comparisons stay in turns (old, new, new, old)
N_STEPS, REPEATS, OLD_REPEATS = 20, 1, 1
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
# kRoundXP, kStream, kLoadX, kG16>), B3 and B8 (bigru_mma_bwd.cuh), B7
# (bigru_lbh.cu); the forwards' bf16-gate (kG16) resident instances are
# listed first, so that the names they extend do not take them
MMA_KERNELS = {"bigru_heads_init_cm": ("mma_fwd_kernelILb0ELb1ELb0ELb0ELb1E",
                                       "mma_fwd_kernel"),
               "bigru_heads_cm": ("mma_fwd_kernelILb0ELb1ELb0ELb1ELb1E",
                                  "mma_fwd_kernelILb0ELb1ELb0ELb1E",
                                  "mma_fwd_kernelILb0ELb0ELb0ELb1E"),
               "bigru_heads_cm_bwd": ("b3_mma_kernel", "wgrad_mma_kernel"),
               "bigru_lbh_bwd": ("b8_mma_kernel", "wgrad_mma_kernel"),
               "bigru_heads_lbh": ("mma_fwd_kernelILb1ELb1ELb0ELb0ELb1E",
                                   "mma_fwd_kernelILb1ELb1ELb0ELb1ELb1E",
                                   "mma_fwd_kernelILb1ELb0ELb0ELb0E",
                                   "mma_fwd_kernelILb1ELb0ELb0ELb1E"),
               "bigru_lbh": ("b7_mma_kernelILb0ELb1E", "b7_mma_kernel")}


# the f32 cluster design of B7 and B8 (bigru_f32.cuh): FFMA on the CUDA
# cores, no tensor-core (HMMA/HGMMA, and so no TF32) instruction
F32_KERNELS = {"bigru_lbh": ("f32_sweep_kernel",),
               "bigru_lbh_bwd": ("f32_sweep_kernel", "f32_bptt_kernel",
                                 "f32_wgrad_kernel")}


# B1's and B10's libraries, whose bf16-gate step check_gate_sass reads
GATE_LIBS = ("bigru_heads_init_cm", "bigru_heads_lbh")
# a GRU forward kernel's last template argument, kG16, in its mangled name
G16_OF = re.compile(r"Lb([01])EEEv")
# an instruction of cuobjdump's listing, its address and encoding dropped
SASS_INSN = re.compile(r"/\*[0-9a-f]+\*/\s+(.*?)\s*;")
# the f32-gate instances of GATE_LIBS as they were before the bf16-gate
# step's redesign, which leaves them alone: (functions, instructions), the
# same from every build directory (the listing itself and its mix of
# opcodes are not: constants move with the source's path), H100 80GB
# HBM3, torch 2.11.0+cu128, CUDA 12.8 (``chip_smoke.py previous`` prints
# them for an earlier checkout)
F32_GATE_SASS = {"bigru_heads_init_cm": (6, 59480),
                 "bigru_heads_lbh": (12, 108696)}


def sass_functions(tool, path) -> dict:
    """Each function of a built library's SASS (``cuobjdump -sass``) by its
    mangled name: its instructions, without addresses or encodings."""
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
        elif fn is not None:
            m = SASS_INSN.search(line)
            if m:
                funcs[fn].append(m.group(1))
    return funcs


def gate_sass(funcs):
    """The GRU forwards of one library split by kG16: for each bf16-gate
    instance the count of its packed bf16 operations (HADD2, HMUL2, HFMA2
    on BF16), MUFU.EX2, MUFU.RCP and instructions; for the f32-gate
    instances together (functions, instructions)."""
    g16, f32 = {}, []
    for name, ins in sorted(funcs.items()):
        flag = G16_OF.findall(name)
        if not flag:
            continue
        if flag[-1] == "1":
            g16[name] = {
                "packed_bf16": sum(op in i and "BF16" in i for i in ins
                                   for op in ("HADD2", "HMUL2", "HFMA2")),
                "MUFU.EX2": sum("MUFU.EX2" in i for i in ins),
                "MUFU.RCP": sum("MUFU.RCP" in i for i in ins),
                "instructions": len(ins)}
        else:
            f32.append((name, ins))
    return g16, (len(f32), sum(len(i) for _, i in f32))


def check_gate_sass(card, tool):
    """B1's and B10's libraries: every bf16-gate instance runs packed bf16
    arithmetic and the SFU's exp2 and reciprocal; the f32-gate instances'
    listing is F32_GATE_SASS's."""
    from climsim_tpu_torch.ops import _build
    for name in GATE_LIBS:
        g16, f32 = gate_sass(sass_functions(tool, _build._lib_path(name)))
        print(f"bf16-gate step in {name}: " + "; ".join(
            f"{k[-48:]} " + ", ".join(f"{op} x{n}" for op, n in c.items())
            for k, c in g16.items()) + f"; the f32-gate instances: {f32[0]} "
            f"functions, {f32[1]} instructions (before the redesign "
            f"{F32_GATE_SASS.get(name)}) [{card}]")
        for k, c in g16.items():
            check(c["packed_bf16"] > 0 and c["MUFU.EX2"] > 0
                  and c["MUFU.RCP"] > 0, f"{k}: the bf16-gate step's SASS "
                  f"lacks packed bf16 or SFU operations: {c}")
        check(f32 == F32_GATE_SASS.get(name), f"{name}: the f32-gate "
              f"instances' SASS changed: {f32}")


def check_tensor_core_sass(card):
    """Count the tensor-core instructions (HMMA, HGMMA) of each bf16
    tensor-core kernel in its built library (``cuobjdump -sass``); each
    must have some. Then the f32 cluster design's kernels: each must have
    FFMA and no tensor-core instruction; and B1's and B10's bf16-gate
    step (check_gate_sass). Without cuobjdump the counts are not
    measured."""
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
    check_gate_sass(card, tool)


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


def make_model(policy, device, seed=0, arm="v6", H=192, **over):
    """bench.py's emulator (nx 6, nneur 192/192, nh_mem 16) with the
    arm's flags (or another hidden width H) and the options ``over``."""
    from climsim_tpu_torch.models import RNNAutoreg
    flags = {"use_pallas": True, **ARMS[arm][0], **over}
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


def g16_ok(got, want16, want32):
    """A bf16-gate launch's output against the plain bf16-gate version
    (``want16``) and the plain float32-gate version on the same bf16
    inputs (``want32``). The mean |got - want16| must be at most half the
    modes' own mean distance, mean |want16 - want32|, and below mean
    |got - want32|: a launch that ran float32 gates would land about the
    modes' distance from want16 and near want32. The largest differences
    cannot tell the modes apart (where one rounding of the same bf16
    operation flips with the summation order, a 60-level recurrence
    carries it about as far as the modes' difference), so they are held
    as bf16_ok holds them. A tensor the mode does not change (distance 0)
    is held by bf16_ok alone. Returns (ok, ratio, err, separates): ratio
    the mean distance over the modes', err the largest difference."""
    g, w, w32 = got.float(), want16.float(), want32.float()
    gap = (w - w32).abs().mean().item()
    m16 = (g - w).abs().mean().item()
    m32 = (g - w32).abs().mean().item()
    ok, err, _ = bf16_ok(got, want16, want32)
    if gap == 0.0:
        return ok, 0.0, err, False
    return ok and m16 <= 0.5 * gap and m16 < m32, m16 / gap, err, True


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
    between the two (``profile_kernels``)."""
    busy, kernels = profile_kernels(fn, top=None)
    if busy <= 0:
        print(f"{label} by kernel: the profiler saw no device time: not "
              f"measured [{card}]")
        return
    print(f"{label} by kernel, one call (torch.profiler device time): "
          + "; ".join(f"{k[:60]} {ms:.4f} ms" for k, ms in kernels)
          + f"; sum {busy:.4f} ms against {event_ms:.4f} ms from CUDA "
          f"events [{card}]")


def in_turns(old, new, launches, repeats=REPEATS):
    """Device ms per call of two versions of one function, timed in turns
    (old, new, new, old) with CUDA events: ([old, old], [new, new])."""
    t = {old: [], new: []}
    for fn in (old, new, new, old):
        t[fn].append(median_ms(fn, launches, repeats=repeats))
    return t[old], t[new]


def designs_in_turns(name, cudacore, tensor_core, card, launches=3,
                     repeats=REPEATS, new="tensor-core", dt="bf16") -> float:
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


def make_trainer(model, device, W=W_TRAIN, lr=LR):
    """bench.py::build_train's update: W 4 window, remat, MSE, Adam 1e-4
    (or the window W and the learning rate lr), with a channel-major model
    behind the trainer's [B, L, C] layout (a batch-major one takes it as
    it is)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         channel_major_apply)
    grid = Grid.synthetic(4, NLEV)
    cfg = RolloutConfig(rollout_schedule={0: W}, loss="mse", lr=lr,
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
    pr._launch_heads_lbh_mma = lambda args, dims, init, pl, g16=False: \
        pr._launch_heads_lbh(args, dims, init, cudacore_bf16=True, g16=g16)
    pr._launch_lbh_mma = lambda args, dims, pl, g16=False: pr._launch_lbh(
        args, dims, twin=True, g16=g16)
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
    ms1 = median_ms(lambda: fused_bigru_heads_init_cm(*a1), 3, repeats=REPEATS)
    ms3 = median_ms(lambda: bigru_heads_cm_bwd(*a3), 2, repeats=REPEATS)
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


def make_phys_model(device, seed=0, use_pallas=False, H=128, **over):
    """conf/autoreg_physrnn.yaml's model at full width (nx 15, nx_sfc 24 as
    tests/test_phys_rnn.py; the trunk on the 50 CRM levels), hybrid
    coefficients from Grid.synthetic, f32. The yaml sets no use_pallas, so
    cli/train_rollout.py:294 builds the scan trunk (two RNNLayer sweeps);
    ``use_pallas=True`` is the fused trunk (kernel B7, and B8 for its
    gradients); ``H`` another trunk width than the yaml's 128; ``over``
    the model's other options (``policy="bf16"`` the BF16 policy)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, F32, PhysicalRNNAutoreg
    g = Grid.synthetic(4, NLEV)
    tt = lambda a: tuple(a.tolist())
    kw = dict(nx=15, nx_sfc=24, ny=5, ny_sfc=8, nneur=(H, H), nh_mem=16,
              nreg=8, store_precip=True, ice_sedimentation=True,
              use_physrad=True, use_mcica=True, use_tc=False,
              use_qv_variability=True, learned_cloud_optics=False, ng_lw=8,
              ng_sw=8, use_pallas=use_pallas, pallas_acc32=True,
              hyai=tt(g.hyai), hybi=tt(g.hybi), hyam=tt(g.hyam),
              hybm=tt(g.hybm), sp_mean=9.8e4, sp_div=1e3, **PHYS_YSCALE)
    kw.update(over)
    kw["policy"] = BF16 if kw.get("policy") == "bf16" else F32
    return PhysicalRNNAutoreg(**kw, device=device, seed=seed)


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


def make_phys_trainer(model, device, record=None, train=False, W=PHYS_W):
    """The evaluation path as cli/train_rollout.py wires the physics model:
    pass_x_raw (and pass_y_true, which evaluation does not use), the
    physics memory shape, huber loss, the yaml's W 3 window. With
    ``train`` the training path: the yaml's energy and water terms and
    Adam (PHYS_TRAIN) and the per-channel output scales. With ``record``
    (a list) every model call appends its outputs, memory and area
    fractions. ``W``: the window (the yaml's last, 3, by default)."""
    from climsim_tpu_torch.train import (RolloutConfig, RolloutTrainer,
                                         phys_apply, phys_mem_shape)

    def recording_apply(m, xl, xs, mem, xr, yt=None):
        res = phys_apply(m, xl, xs, mem, xr, yt)
        record.append((res[0], res[1], res[2], res[3]["area_frac"]))
        return res

    cfg = RolloutConfig(rollout_schedule={0: W}, loss="huber",
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
    """``fn()`` under torch.profiler, recording device activity alone: the
    device time of every kernel summed (busy ms), and the kernels with the
    most device time (all with ``top`` None). Returns (busy ms, [(name,
    ms), ...]). With host activity as well, B3's main kernel, launched
    from ctypes, went missing from the key averages, and the host's
    events took seconds to average where a call launches tens of
    thousands of kernels (TripleClouds' sweeps). A profile that comes back
    empty is taken once more."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(((ev.key, ev.device_time_total / 1e3)
                          for ev in prof.key_averages()
                          if ev.device_time_total > 0), key=lambda kv: -kv[1])
        if kernels:
            break
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


def policy_of(model) -> str:
    """The name of the model's compute dtype: bf16 or f32."""
    return "bf16" if model.policy.compute_dtype == torch.bfloat16 else "f32"


def time_phys_eval(model, card, ncol=NLAT * NLON, chunk=None,
                   label="physics evaluation", profile=True):
    """ms per model step of a physics evaluation window (W 3 of ``chunk``,
    or of ``ncol`` seeded columns) with the model's trunk, its peak
    memory, and with ``profile`` the window's device idle share and
    largest kernels (torch.profiler, which takes seconds where a window
    launches tens of thousands of kernels). Returns the ms per model
    step."""
    if chunk is None:
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
    print(f"{label}, {trunk} trunk (W {PHYS_W}, {ncol} columns, "
          f"{policy_of(model)}): {ms:.4f} ms per model step, "
          f"{ncol / ms * 1e3:,.0f} column-steps/s; peak memory {peak:.3f} GB "
          f"({resident:.3f} GB resident before the window) [{card}]")
    if not profile:
        return ms
    busy, top = phys_profile(trainer, chunk)
    window = ms * PHYS_W
    print(f"{label} window, {trunk} trunk, by kernel "
          + (f"(torch.profiler device time): busy {busy:.4f} ms of the "
             f"window's {window:.4f} ms unprofiled, idle share "
             f"{max(0.0, 1 - busy / window):.3f}; "
             + "; ".join(f"{k[:48]} {t:.4f} ms" for k, t in top)
             if busy > 0 else "(torch.profiler): the profiler saw no device "
             "time: not measured") + f" [{card}]")
    return ms


def time_phys_update(trainer, chunk, n, ncol, card,
                     label="physics training update"):
    """ms per physics training update (W of the trainer's schedule, huber
    + energy + water, Adam) of the trainer's model on ``chunk`` (n
    updates, ncol columns), its peak memory, and one update's device idle
    share and largest kernels. Returns the ms per update."""
    W = trainer.cfg.rollout_schedule[0]

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
    print(f"{label}, {trunk} trunk (W {W}, huber + energy + water, Adam, "
          f"{ncol} columns, {policy_of(trainer.model)}): {ms:.4f} ms/update, "
          f"{ncol * W / ms * 1e3:,.0f} column-steps/s; peak memory "
          f"{peak:.3f} GB ({resident:.3f} GB resident before the epoch) "
          f"[{card}]")
    busy, top = phys_profile(trainer, {k: v[:W] for k, v in chunk.items()},
                             top=12, train=True)
    print(f"{label}, {trunk} trunk, by kernel "
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


def heads_yardstick(layer, a, cm, card, label, init=False, backward=False):
    """The library yardstick of B4 (``cm``: channel-major arguments ``a`` as
    b4_args makes them) or B9 (batch-major, b9_args): cuDNN's GRU pair
    with the fused layer's weights (gru_pair), then the latent head and
    the output head as two torch.nn.Linear (weight = wlat.T, wout.T; bias
    blat, bout), which the port never calls. For B4 the inputs are first
    permuted to the pair's [L, B, CH + nm_in] and the heads' outputs back
    to [L, nm + ny, B] (inside the timed call: they are part of what the
    library needs to compute B4's function). With ``init``, B1's (``cm``,
    b1_args) or B10's (b10_args): the initial MLP first, a torch.nn.Linear
    (weight = w_init.T, bias b_init) and tanh on the raw features,
    concatenated with the memory. With ``backward``, B3's: autograd's
    backward through B4's yardstick (``a`` the residuals of b3_args) to
    the inputs, the pair's weights and the heads', with seeded
    cotangents, timed in place of the forward. In bf16, fp16 where
    torch.backends.cudnn.is_acceptable refuses bf16. First the forward is
    held to the plain f32 version within 4x the plain version's own
    bf16-vs-f32 error (f32 arguments: within 1e-4 of 1 + the outputs'
    scale, cuDNN's f32 sums taken in another order over 120 serial
    steps), then timed. Returns its ms."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_reference,
                                       bigru_heads_init_cm_reference,
                                       bigru_heads_init_lbh_reference,
                                       bigru_heads_lbh_reference)
    pdt = a[0].dtype
    if not torch.backends.cudnn.is_acceptable(a[0]):
        pdt = torch.float16
    pair, params = gru_pair(layer, pdt)
    H, (nm, ny) = layer.hidden, layer.wout.shape
    lat, out = torch.nn.Linear(H, nm), torch.nn.Linear(nm, ny)
    with torch.no_grad():
        for lin, w, b in ((lat, "wlat", "blat"), (out, "wout", "bout")):
            lin.weight.copy_(getattr(layer, w).t())
            lin.bias.copy_(getattr(layer, b))
    lat.to(a[0].device, pdt)
    out.to(a[0].device, pdt)
    heads = [*lat.parameters(), *out.parameters()]
    if init:
        ini = torch.nn.Linear(*layer.w_init.shape)
        with torch.no_grad():
            ini.weight.copy_(layer.w_init.t())
            ini.bias.copy_(layer.b_init)
        ini.to(a[0].device, pdt)
        heads += list(ini.parameters())
    ins = [t.to(pdt) for t in (a[:4] if cm or init else a[:3])]

    def run(*ins):
        if cm:
            x, mem_in, h0u, h0d = ins
            x = x.permute(0, 2, 1)
            if init:
                x = torch.tanh(ini(x))
            xb = torch.cat([x, mem_in.permute(0, 2, 1)], -1).contiguous()
            down, last = pair(xb, h0u.t().contiguous(), h0d.t().contiguous())
            mem = lat(down)
            om = torch.cat([mem, out(mem)], -1).permute(0, 2, 1).contiguous()
            return om, last.t().contiguous()
        if init:
            feat, mem_in, h0u, h0d = ins
            ins = (torch.cat([torch.tanh(ini(feat)), mem_in], -1), h0u, h0d)
        down, last = pair(*ins)
        mem = lat(down)
        return out(mem), mem, last

    ref = {(True, False): bigru_heads_cm_reference,
           (False, False): bigru_heads_lbh_reference,
           (True, True): bigru_heads_init_cm_reference,
           (False, True): bigru_heads_init_lbh_reference}[cm, init]
    with torch.no_grad():
        want = ref(*(t.float() for t in a))
        own = max_err(ref(*a), want)
        got = run(*ins)
        err = max_err(got, want)
        how = ("fp16: torch.backends.cudnn.is_acceptable refuses bf16"
               if pdt != a[0].dtype else str(pdt).replace("torch.", ""))
        if pdt == torch.float32:
            how += ", TF32 off" if not torch.backends.cudnn.allow_tf32 \
                else ", TF32 on"
            scale = max(t.abs().max().item() for t in want)
            tol, why = 1e-4 * (1.0 + scale), "1e-4 of 1 + the outputs' scale"
        else:
            tol, why = 4 * own, "4x the plain version's own bf16-vs-f32 error"
        print(f"library yardstick of {label} (cuDNN GRU pair + 2 Linear"
              f"{' + the initial MLP' if init else ''}"
              f"{', permuted' if cm else ''}; {how}): against the plain f32 "
              f"version max_abs_err {err:.3e} (tolerance {tol:.3e}: {why}) "
              f"[{card}]")
        check(err <= tol, f"yardstick of {label}: {err:.3e} > {tol:.3e}")
        del got, want
        if not backward:
            ms = median_ms(lambda: run(*ins), 3)
    if not backward:
        kernel_split(lambda: run(*ins), ms, card,
                     f"library yardstick of {label}")
        return ms
    ins = [t.clone().requires_grad_(True) for t in ins]
    with torch.enable_grad():
        outs = run(*ins)
    g = torch.Generator(device="cuda").manual_seed(17)
    cts = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
           for o in outs]

    def bwd():
        torch.autograd.grad(outs, ins + params + heads, cts,
                            retain_graph=True)

    ms = median_ms(bwd, 2)
    kernel_split(bwd, ms, card, f"library yardstick of {label}")
    return ms


# ------------------------------------------------------------ C.1: the
# scan sweep's backward (ROADMAP C.1) against the earlier code

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
# the lockstep at 384 columns: 6 steps of data (4 training steps, one
# chunk of 4 W 1 updates; 2 validation steps), to hold the run's time
CLI_384 = ("data.steps=6",)
# the largest host-to-device copy an epoch may make with the device cache:
# the model's index tensors are bytes; a data window is megabytes
CLI_MAX_H2D_BYTES = 1 << 16


class ForwardCounter:
    """Counts the calls of a model class's forward with autograd on (the
    training updates) and off (validation and the scoreboard)."""

    def __init__(self, cls):
        self.cls, self.grad, self.nograd = cls, 0, 0

    def __enter__(self):
        orig = self.orig = self.cls.forward
        counter = self

        def forward(model, *args, **kwargs):
            out = orig(model, *args, **kwargs)
            if torch.is_grad_enabled():
                counter.grad += 1
            else:
                counter.nograd += 1
            return out
        self.cls.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.orig


class ChoiceReplay:
    """The discrete choices of the physics model in call order: McICA's
    sample indices (``radiation.stratified_sample``, SW then LW each
    forward) and the qv variability's two largest regions
    (``phys_rnn.largest_regions``). Without ``recorded`` each call's
    result is kept in ``calls`` as (name, indices on the CPU); with it
    each call returns the recorded result of the same call instead of its
    own, after checking name and shape, and counts how many of its own
    indices differ (``n_diff`` of ``n_idx``). Used as a context manager
    around a run; ``done()`` checks that every recorded call was
    replayed."""

    def __init__(self, recorded=None):
        self.recorded, self.calls = recorded, []
        self.n_diff = self.n_idx = 0

    def __enter__(self):
        from climsim_tpu_torch.models import phys_rnn
        from climsim_tpu_torch.physics import radiation
        self.orig = [(radiation, "stratified_sample"),
                     (phys_rnn, "largest_regions")]
        self.orig = [(m, n, getattr(m, n)) for m, n in self.orig]
        for mod, name, fn in self.orig:
            setattr(mod, name, functools.partial(self._call, name, fn))
        return self

    def _call(self, name, fn, *args):
        own = fn(*args)
        if self.recorded is None:
            self.calls.append((name, own.detach().cpu()))
            return own
        i = len(self.calls)
        check(i < len(self.recorded) and self.recorded[i][0] == name
              and self.recorded[i][1].shape == own.shape,
              f"choice replay: call {i} {name} {tuple(own.shape)} against "
              f"{len(self.recorded)} recorded calls")
        rec = self.recorded[i][1].to(own.device)
        self.calls.append(self.recorded[i])
        self.n_diff += int((own != rec).sum())
        self.n_idx += own.numel()
        return rec

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)

    def done(self, what):
        check(len(self.calls) == len(self.recorded), f"{what}: replayed "
              f"{len(self.calls)} of {len(self.recorded)} recorded choices")


def cpu_copy(obj):
    """``obj`` (a state dict: nested dicts and lists of tensors and
    numbers) with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(cpu_copy(v) for v in obj)
    return obj


@contextlib.contextmanager
def recorded_draws(draws):
    """Every ensemble noise draw of the trainers' default source
    (``KeyedNoise``) appended to ``draws`` in call order, as (step,
    member, the draw on the CPU)."""
    from climsim_tpu_torch.train.rollout import KeyedNoise
    orig = KeyedNoise.__call__

    def call(self, step, member, shape):
        out = orig(self, step, member, shape)
        draws.append((step, member, out.detach().cpu().clone()))
        return out
    KeyedNoise.__call__ = call
    try:
        yield draws
    finally:
        KeyedNoise.__call__ = orig


class ReplayDraws:
    """A trainer's ``noise_source`` that returns recorded draws in order,
    each checked against the (step, member, shape) asked for."""

    def __init__(self, draws):
        self.draws, self.i = draws, 0

    def __call__(self, step, member, shape):
        check(self.i < len(self.draws), "noise replay: more draws asked "
              f"for than the {len(self.draws)} recorded")
        s, m, d = self.draws[self.i]
        self.i += 1
        check((s, m, tuple(d.shape)) == (step, member, tuple(shape)),
              f"noise replay: draw {self.i - 1} was ({s}, {m}, "
              f"{tuple(d.shape)}), asked for ({step}, {member}, {shape})")
        return d.clone()

    def done(self, what):
        check(self.i == len(self.draws), f"{what}: replayed {self.i} of "
              f"{len(self.draws)} recorded draws")


class UpdateLog:
    """Records every ``RolloutTrainer.update`` of a run, on the CPU: the
    model's state before it, its window, memory and mix mask, its loss
    and gradients, the range of ``choices.calls`` (a recording
    ChoiceReplay) and of ``draws`` (recorded_draws) that it made, and with
    ``opt_state`` the optimizer's state before it. Used as a context
    manager around a run."""

    def __init__(self, choices, draws=(), opt_state=False):
        self.choices, self.updates = choices, []
        self.draws, self.opt_state = draws, opt_state

    def __enter__(self):
        import types
        from climsim_tpu_torch.train.rollout import RolloutTrainer
        self.cls, orig = RolloutTrainer, RolloutTrainer.update
        self.orig, log = orig, self
        cpu = lambda t: None if t is None else t.detach().cpu().clone()

        def update(tr, window, mem, mix_mask, group=None):
            state = {k: cpu(v) for k, v in tr.model.state_dict().items()}
            opt = cpu_copy(tr.opt.state_dict()) if log.opt_state else None
            start, d0 = len(log.choices.calls), len(log.draws)
            new_mem, loss = orig(tr, window, mem, mix_mask, group=group)
            log.updates.append(types.SimpleNamespace(
                state=state, window={k: cpu(v) for k, v in window.items()},
                mem=cpu(mem), mask=cpu(mix_mask), loss=float(loss),
                grads={n: cpu(p.grad)
                       for n, p in tr.model.named_parameters()},
                calls=(start, len(log.choices.calls)),
                draws=(d0, len(log.draws)), opt=opt))
            return new_mem, loss
        RolloutTrainer.update = update
        return self

    def __exit__(self, *exc):
        self.cls.update = self.orig


# the witnesses of a lockstep optimizer step: 3 random patterns, each
# with both signs
STEP_WITNESSES = [(seed, sign) for seed in (11, 12, 13) for sign in (1, -1)]


def jittered(state, grads, jitter=None):
    """Copies of an optimizer state dict and of the gradients (the
    tensors cloned: a loaded state is stepped in place); with ``jitter``
    (seed, sign) each floating tensor of the per-parameter state and each
    gradient times 1 + sign 1e-6 r, r a random +-1 pattern from the seed:
    a witness of rounding-level changes of both."""
    state, grads = cpu_copy(state), cpu_copy(grads)
    if jitter is not None:
        seed, sign = jitter
        g = torch.Generator().manual_seed(seed)
        tensors = [v for st in state["state"].values() for v in st.values()
                   if torch.is_tensor(v) and v.is_floating_point()
                   and v.dim() > 0] + list(grads.values())
        for v in tensors:
            v.mul_(1 + sign * 1e-6 * (2 * torch.randint(
                0, 2, v.shape, generator=g) - 1))
    return state, grads


def train_cli_run(args, model_cls):
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
        with ForwardCounter(model_cls) as calls, \
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
          f"{label}: an epoch copied {max(known, default=0)} bytes to the "
          f"card at once")


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


def compare_cli_384(card, grid, yaml, model_cls, extra=(),
                    lockstep_opt=False):
    """One epoch of the CLI at its default 384 columns on the card, held to
    device=cpu in lockstep: from the card's own state at each step the
    CPU computes what the card computed, so the comparison is
    well-conditioned. One epoch of Adam is not: on the CPU alone, initial
    weights times 1 +- 1e-6 moved the physics yaml's val_loss by up to 7%
    and its epoch loss by up to 2.7e-4 (tests/torch_witness_sweep.py),
    since rounding-level gradients take steps of the full learning rate.

    The card run records every update (UpdateLog) and the physics model's
    discrete choices (ChoiceReplay), which the CPU replays. For each
    update, from the card's weights before it, on its window, memory and
    mask, the card's loss must lie within 1e-4 of the CPU's (the CPU tests
    hold the CLI to JAX at 1e-4) plus 4x the larger movement of two
    witnesses, the same weights times 1 +- 1e-6 on the CPU; and each
    parameter's gradient, in the norm of its difference, within 1e-4 of
    the CPU's norm plus 4x the witness movement plus 1e-6 of the whole
    gradient's norm (the level of a float32 residue, where a gradient is
    zero in exact arithmetic). The CPU's Adam, fed the card's gradient
    from the card's weights, must give the card's next weights within
    1e-5 of (|w| + lr) elementwise. The card's val_loss is held like the
    loss to the CPU's validation of the card's final weights. No kernel
    launches on the CPU.

    An ensemble's noise draws on the card are recorded and replayed on the
    CPU (recorded_draws, ReplayDraws), update by update and in the
    validation. With ``lockstep_opt`` the CPU's optimizer is fed the
    card's optimizer state before each step too (SOAP's bases: a
    degenerate eigenvalue leaves the CPU's own eigh free to rotate
    them), and its step is held within 1e-5 of (|w| + lr) plus 4x the
    largest movement of the step when that state and the gradient are
    jittered elementwise by 1e-6 (jittered, STEP_WITNESSES): SOAP's Adam
    in the eigenbasis turns a rounding-level component of the projected
    gradient into a step of up to the learning rate's size. (On the CPU,
    a float64 step differs from the float32 one by up to 5,400x the
    plain tolerance and by 0.31x this one, at the long-window yaml's
    first SOAP steps.) ``extra``: overrides for both runs."""
    from climsim_tpu_torch.cli import train_rollout as cli
    from climsim_tpu_torch.train.config import load_config
    base = [yaml, f"grid_path={grid}", "epochs=1", *extra]
    name = os.path.basename(yaml)
    with ChoiceReplay() as choices, recorded_draws([]) as draws, \
            UpdateLog(choices, draws, lockstep_opt) as log:
        r = train_cli_run(base + ["device=cuda"], model_cls)
    check(r.rc == 0 and len(r.records) == 1,
          f"{name} 384 cuda: exit {r.rc}")
    rec = r.records[0]
    check(rec["updates"] == len(log.updates) > 0, f"{name} 384: "
          f"{len(log.updates)} updates logged, the record gives "
          f"{rec['updates']}")
    final = {k: v.detach().cpu().clone()
             for k, v in r.run.trainer.model.state_dict().items()}
    r = None
    run = cli.setup(load_config(yaml, base[1:] + ["device=cpu"]))
    tr, model = run.trainer, run.trainer.model
    # remat recomputes the same bits on the CPU (tests/test_torch_train.py::
    # test_remat_changes_nothing); without it the CPU's side takes less time
    tr.cfg.remat = False
    params = dict(model.named_parameters())
    scaled = lambda st, f: {k: v * f if v.is_floating_point() else v
                            for k, v in st.items()}
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    replays = []

    def replay(calls):
        rp = ChoiceReplay(calls)
        replays.append(rp)
        return rp

    def grad_at(state, u):
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        calls = choices.calls[u.calls[0]:u.calls[1]]
        tr.noise_source = noise = ReplayDraws(draws[u.draws[0]:u.draws[1]])
        with replay(calls) as rp, torch.enable_grad():
            loss, _ = tr._window_loss(u.window, u.mem, u.mask)
            loss.backward()
        rp.done(f"{name} 384 update")
        noise.done(f"{name} 384 update")
        return float(loss.detach()), {n: p.grad.clone()
                                      for n, p in params.items()}

    def held(what, diff, p, moves, floor=0.0):
        """``diff`` (the card's difference from the CPU's ``p``) within
        1e-4 of |p| plus 4x the larger witness movement plus ``floor``;
        returns its share of that tolerance."""
        tol = 1e-4 * abs(p) + 4 * max(moves) + floor
        check(np.isfinite(diff) and diff <= tol,
              f"{name} 384: {what}: the card differs from the CPU's {p!r} "
              f"by {diff!r}, tolerance {tol!r}")
        return diff / max(tol, 1e-300)

    worst = {"loss": 0.0, "grad": 0.0, "adam": 0.0}
    worst_grad = ""
    norm = lambda t: float(torch.linalg.vector_norm(t))
    for k, u in enumerate(log.updates):
        lp, gp = grad_at(u.state, u)
        wit = [grad_at(scaled(u.state, 1 + s * 1e-6), u) for s in (1, -1)]
        worst["loss"] = max(worst["loss"], held(
            f"update {k} loss", abs(u.loss - lp), lp,
            [abs(lw - lp) for lw, _ in wit]))
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                     for g in gp.values())))
        for n, g in gp.items():
            share = held(f"update {k} gradient of {n} (norm {norm(g)!r})",
                         norm(u.grads[n] - g), norm(g),
                         [norm(gw[n] - g) for _, gw in wit], 1e-6 * gnorm)
            if share > worst["grad"]:
                worst["grad"], worst_grad = share, f" ({n}, update {k})"
        # the step: the CPU's optimizer fed the card's gradient (and with
        # lockstep_opt the card's optimizer state, and two witnesses of
        # that state jittered at the rounding level)
        lr = tr._schedule(k + getattr(tr.opt, "schedule_offset", 0))

        def step_at(jitter=None):
            model.load_state_dict(u.state)
            grads = u.grads
            if lockstep_opt:
                opt, grads = jittered(u.opt, u.grads, jitter)
                tr.opt.load_state_dict(opt)
            for n, p in params.items():
                p.grad = grads[n].clone()
            for g in tr.opt.param_groups:
                g["lr"] = lr
            tr.opt.step()
            return {n: p.detach().clone() for n, p in params.items()}
        stepped = step_at()
        moved = {n: 0.0 for n in params}
        for jitter in (STEP_WITNESSES if lockstep_opt else ()):
            w = step_at(jitter)
            moved = {n: torch.maximum(torch.as_tensor(moved[n]),
                                      (w[n] - stepped[n]).abs())
                     for n in params}
        nxt = final if k + 1 == len(log.updates) \
            else log.updates[k + 1].state
        for n in params:
            d = (stepped[n] - nxt[n]).abs()
            tol = 1e-5 * (nxt[n].abs() + lr) + 4 * moved[n]
            worst["adam"] = max(worst["adam"], float((d / tol).max()))
            check(bool((d <= tol).all()), f"{name} 384: update {k} "
                  f"{type(tr.opt).__name__} step of {n} differs by "
                  f"{float(d.max()):.3e} from the card's")
    # validation of the card's final weights
    vcalls = choices.calls[log.updates[-1].calls[1]:]
    vdraws = draws[log.updates[-1].draws[1]:]

    def val_at(state):
        model.load_state_dict(state)
        tr.noise_source = noise = ReplayDraws(vdraws)
        with replay(vcalls) as rp:
            _, v = tr.run_epoch(None, run.chunks(run.ntr, None, False), 0,
                                train=False)
        rp.done(f"{name} 384 validation")
        noise.done(f"{name} 384 validation")
        return v["loss"]
    vp = val_at(final)
    vw = [val_at(scaled(final, 1 + s * 1e-6)) for s in (1, -1)]
    vc = rec["val_loss"]
    held("val_loss on the card's final weights", abs(vc - vp), vp,
         [abs(v - vp) for v in vw])
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    check(not launched, f"{name} 384 on the CPU launched {launched}")
    n_diff = sum(rp.n_diff for rp in replays)
    n_idx = sum(rp.n_idx for rp in replays)
    print(f"cli train_rollout {name} {' '.join(extra)} at 384 columns, 1 "
          f"epoch, card against device=cpu in lockstep: {len(log.updates)} "
          f"updates, loss {rec['loss']!r}; the largest difference as a "
          f"share of its tolerance: update loss {worst['loss']:.3f}, "
          f"gradient {worst['grad']:.3f}{worst_grad}, "
          f"{type(tr.opt).__name__} step {worst['adam']:.3f} (fed the "
          f"card's {'state and ' if lockstep_opt else ''}gradient); "
          f"{len(draws)} noise draws replayed; val_loss {vc!r} vs the CPU's on the card's "
          f"weights {vp!r} (difference "
          f"{abs(vc - vp):.3e}, witness movement "
          f"{max(abs(v - vp) for v in vw):.3e}); {len(choices.calls)} "
          f"discrete choices replayed, {n_diff} of {n_idx} of the CPU's "
          f"own indices (with witnesses) differ from the card's [{card}]")


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
                    f"data.ncol={GRU_CLI_NCOL}", "epochs=1"]
        r = train_cli_run(gru_args, RNNAutoreg)
        cli_summary(f"GRU yaml (scan arm), {GRU_CLI_NCOL} columns", r,
                    GRU_CLI_NCOL, card)
        check_cli_records("GRU yaml", r, [1])
        check(r.run.trainer.model.arm == "scan", r.run.trainer.model.arm)
        check(r.launches == {}, f"the scan arm launched {r.launches}")
        cli_epoch_profile("GRU yaml (scan arm)", r, 1, GRU_CLI_NCOL, card,
                          os.path.join(tmp, "trace.json"))
        r = None
        gc.collect()
        torch.cuda.empty_cache()
        fused_bigru_lbh.design = bigru_bwd_lbh.design = None
        r = train_cli_run(gru_args + ["model.use_pallas=true"], RNNAutoreg)
        cli_summary(f"GRU yaml with model.use_pallas=true (v2 arm), "
                    f"{GRU_CLI_NCOL} columns", r, GRU_CLI_NCOL, card)
        check_cli_records("GRU yaml v2", r, [1])
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

        # 6 steps of data for the yamls' 24 (4 updates), to hold the run's
        # time: the lockstep's CPU side is most of the phase
        compare_cli_384(card, grid, phys_yaml, PhysicalRNNAutoreg,
                        CLI_384)
        compare_cli_384(card, grid, gru_yaml, RNNAutoreg, CLI_384)
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


def offline_run(args, scale=None, noise_source=None, data=None):
    """``cli/train_offline.py``'s main(args) as a user runs it, every
    launch counter set to 0 just before and read just after, the peak
    memory reset before, and the CLI's setup (its Offline: data, model,
    normalizer) kept; with ``scale`` every floating parameter of the model
    is multiplied by it after setup (the witnesses); with ``data`` (another
    run's Offline) the run trains and scores that run's data, normalizer
    and labels, moved to its device (the data witness); ``noise_source``
    goes to main (the stochastic arms' draws). Returns a namespace:
    rc, lines, records, launches, wall, peak_gb (above the memory held
    before the run, which earlier phases may leave), run."""
    import types
    from climsim_tpu_torch.cli import train_offline as cli
    runs = []
    orig_setup = cli.setup

    def setup(cfg):
        runs.append(orig_setup(cfg))
        if data is not None:
            run = runs[-1]
            dev = run.xn.device
            run.x, run.xn, run.yn = (t.to(dev) for t in (data.x, data.xn,
                                                         data.yn))
            run.nz = data.nz.to(dev)
            if data.labels is not None:
                run.labels = data.labels.to(dev)
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
            rc = cli.main(args, noise_source=noise_source)
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


# ------------------------------------------------------------ phase 13

# the deployment export (climsim_tpu_torch/export): the rollout CLI's
# v4_rnn emulator at conf/autoreg_gru.yaml's widths (nneur 192/192,
# nh_mem 16, add_pres, output_prune; nx 15, nx_sfc 24, ny 5 for mp_mode
# 1, ny_sfc 8) in bf16, in the arm whose kernel the wrapper reaches, in
# OnlineWrapper, exported at the ne4 contract's 384 columns and at 21,600
EXPORT_NX, EXPORT_NX_SFC, EXPORT_NY, EXPORT_NM = 15, 24, 5, 16
EXPORT_ARMS = {"v4": (dict(use_pallas=True, fuse_heads=True, fuse_init=True),
                      "b10", "fused_bigru_heads_init_lbh"),
               "v2": (dict(use_pallas=True), "b7", "fused_bigru_lbh"),
               "v3": (dict(use_pallas=True, fuse_heads=True), "b9",
                      "fused_bigru_heads_lbh")}
EXPORT_NCOLS = (LO_NLAT * LO_NLON, NLAT * NLON)
# the v4_rnn level outputs' scales (dT, dqv, dqn, du, dv): tendencies of
# 1e-4 K/s and 1e-7 kg/kg/s at a scaled output of order 1
EXPORT_SCALE_LEV = [1e4, 1e7, 1e7, 1e4, 1e4]
VALIDATE_STEPS = 8
# the fresh process that reloads the wrapper artifacts (reload_exports)
RELOAD_CHILD = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.reload_exports(sys.argv[1]))")


def counted(fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after (synchronized): (its result, the launches)."""
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items() if w.launches}


def raw_state(ncol, seed, device="cuda"):
    """Raw-unit wrapper inputs of realistic magnitudes, the same numbers
    in every process from ``seed``: T 220-300 K, RH 0-1.4, cloud liquid
    and ice |N(0, 1e-5)|, winds N(0, 10) m/s, the other level inputs
    N(0, 1); surface inputs |N(0.5, 0.2)| with the surface pressure
    9.6e4-1.03e5 Pa; memory N(0, 0.5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = lambda sd, *s: sd * torch.randn(s, generator=g, device=device)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(
        s, generator=g, device=device)
    x = n(1.0, ncol, NLEV, EXPORT_NX)
    x[..., 0] = u(220.0, 300.0, ncol, NLEV)
    x[..., 1] = u(0.0, 1.4, ncol, NLEV)
    x[..., 2:4] = n(1e-5, ncol, NLEV, 2).abs()
    x[..., 4:6] = n(10.0, ncol, NLEV, 2)
    xs = (0.5 + n(0.2, ncol, EXPORT_NX_SFC)).abs()
    xs[:, 0] = u(9.6e4, 1.03e5, ncol)
    return x, xs, n(0.5, ncol, NLEV, EXPORT_NM)


def export_norm():
    """A LevelNormalizer for raw_state's inputs: per-level means and 3x
    the standard deviations of a 384-column draw (the condensates 0 and 1:
    they are normalized after their exp transform), the output scales
    EXPORT_SCALE_LEV and 1 at the surface."""
    from climsim_tpu_torch.data import LevelNormalizer
    x, xs, _ = raw_state(LO_NLAT * LO_NLON, seed=99)
    mean_lev, div_lev = x.mean(0), 3 * x.std(0) + 1e-3
    mean_lev[:, 2:4], div_lev[:, 2:4] = 0.0, 1.0
    return LevelNormalizer(mean_lev, div_lev, xs.mean(0),
                           3 * xs.std(0) + 1e-3,
                           torch.tensor([EXPORT_SCALE_LEV], device="cuda"),
                           torch.ones(8, device="cuda"))


def export_wrapper_of(arm, norm, **over):
    """The wrapper of arm's emulator at the yaml's widths, bf16, on the
    card (device=None), seeded weights, with the model options ``over``;
    per-level exp-transform coefficients from 1e3 at the top to 1e5 at the
    surface."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.export import OnlineWrapper, WrapperConfig
    from climsim_tpu_torch.models import BF16, RNNAutoreg
    g = Grid.synthetic(LO_NLAT * LO_NLON, NLEV)
    model = RNNAutoreg(nx=EXPORT_NX, nx_sfc=EXPORT_NX_SFC, ny=EXPORT_NY,
                       ny_sfc=8, nneur=(192, 192), nh_mem=EXPORT_NM,
                       add_pres=True, output_prune=True,
                       hyam=tuple(g.hyam.tolist()),
                       hybm=tuple(g.hybm.tolist()),
                       sp_mean=float(norm.mean_sfc[0]),
                       sp_div=float(norm.div_sfc[0]), policy=BF16,
                       device=None, **EXPORT_ARMS[arm][0], **over)
    check(model.arm == arm, f"the {arm} flags built the {model.arm} arm")
    lbd = torch.logspace(3.0, 5.0, NLEV)
    return OnlineWrapper(model, norm, lbd, lbd, lbd, WrapperConfig(mp_mode=1))


def host_syncs(fn) -> list[str]:
    """The synchronizing CUDA operations of one call of ``fn``
    (``torch.cuda.set_sync_debug_mode("warn")``), each as the file:line
    of the Python frame that made it."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def reload_exports(manifest_path) -> int:
    """The fresh process of phase 13: load each wrapper artifact of the
    manifest through ``load_step`` (building no model: the constructors
    and ``load_state_dict`` raise here), read the climsim:: ops its graph
    calls, call it on raw_state's inputs with every counter set to 0 just
    before, hold its outputs to the eager
    wrapper's (saved by the parent), time it, and write the results
    beside the manifest."""
    from climsim_tpu_torch import models as M

    def refuse(*a, **k):
        raise RuntimeError("the reloading process built a model or loaded "
                           "parameters")
    M.RNNAutoreg.__init__ = M.PhysicalRNNAutoreg.__init__ = refuse
    torch.nn.Module.load_state_dict = refuse
    from climsim_tpu_torch.export import load_step
    from climsim_tpu_torch.ops.library import exported_ops
    torch.set_grad_enabled(False)
    with open(manifest_path) as f:
        manifest = json.load(f)
    results = []
    for e in manifest:
        t0 = time.perf_counter()
        step = load_step(e["path"])
        load_s = time.perf_counter() - t0
        inputs = raw_state(e["ncol"], seed=e["ncol"])
        outs, launches = counted(lambda: step(*inputs))
        want = torch.load(e["eager"], map_location="cuda")
        results.append(dict(
            e, ops=exported_ops(step.graph), launches=launches, load_s=load_s,
            equal=all(torch.equal(a, b) for a, b in zip(outs, want)),
            max_abs_diff=max_err(outs, want),
            scale=max(t.abs().max().item() for t in want),
            ms=median_ms(lambda: step(*inputs), 1, repeats=REPEATS)))
    with open(manifest_path.replace(".json", "_reloaded.json"), "w") as f:
        json.dump(results, f)
    return 0


def check_wrapper_exports(card, root):
    """The v4, v2 and v3 wrappers: exported at 384 and 21,600 columns,
    called eagerly (the kernel once a call; ms a step, and at 21,600
    columns the pre-processing's and the model's ms), then all reloaded in
    one fresh process (the graph one climsim:: node, the arm's kernel; the
    kernel once a call; outputs bit-equal to the eager wrapper's, or
    within 1e-6 of their scale; ms a step). Returns the wrappers by
    arm."""
    from climsim_tpu_torch.export import export_wrapper
    norm = export_norm()
    wrappers, manifest = {}, []
    inputs = {n: raw_state(n, seed=n) for n in EXPORT_NCOLS}
    for arm, (_, kernel, op) in EXPORT_ARMS.items():
        w = wrappers[arm] = export_wrapper_of(arm, norm)
        for ncol in EXPORT_NCOLS:
            x, xs, mem = inputs[ncol]
            path = os.path.join(root, f"{arm}_{ncol}.pt2")
            t0 = time.perf_counter()
            nbytes = export_wrapper(w, ncol, NLEV, EXPORT_NX, EXPORT_NX_SFC,
                                    EXPORT_NM, path)
            export_s = time.perf_counter() - t0
            outs, launches = counted(lambda: w(x, xs, mem))
            check(launches == {kernel: 1}, f"{arm} {ncol}: the eager "
                  f"wrapper launched {launches}")
            check(all(bool(torch.isfinite(t).all()) for t in outs),
                  f"{arm} {ncol}: eager outputs not finite")
            check(outs[0].shape == (ncol, NLEV, 6), f"{arm}: out shape")
            eager = os.path.join(root, f"{arm}_{ncol}_eager.pt")
            torch.save(outs, eager)
            if ncol == LO_NLAT * LO_NLON:
                syncs = host_syncs(lambda: w(x, xs, mem))
                print(f"export wrapper {arm}: {len(syncs)} synchronizing "
                      f"operations in one eager step, at {syncs}")
            ms = median_ms(lambda: w(x, xs, mem), 1, repeats=REPEATS)
            split = ""
            if ncol == NLAT * NLON:
                xn, xsn = w.preprocess(x, xs)
                pre = median_ms(lambda: w.preprocess(x, xs), 1, repeats=REPEATS)
                core = median_ms(lambda: w.model(xn, xsn, mem), 1,
                                 repeats=REPEATS)
                split = (f"; pre-processing {pre:.4f} ms, the model "
                         f"{core:.4f} ms, post-processing and scrub (the "
                         f"rest) {ms - pre - core:.4f} ms")
            print(f"export wrapper {arm} ({kernel.upper()}), {ncol} columns:"
                  f" {nbytes} bytes of torch.export program, exported in "
                  f"{export_s:.2f} s; eager {ms:.4f} ms a step{split} "
                  f"[{card}]")
            manifest.append(dict(arm=arm, ncol=ncol, path=path, eager=eager,
                                 kernel=kernel, op=op, bytes=nbytes,
                                 eager_ms=ms))
    mpath = os.path.join(root, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", RELOAD_CHILD, mpath], cwd=here,
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"the reloading process failed:\n"
          f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    with open(mpath.replace(".json", "_reloaded.json")) as f:
        results = json.load(f)
    check(len(results) == len(manifest), "reloaded results")
    for res in results:
        label = f"reloaded {res['arm']} {res['ncol']}"
        check(res["ops"] == [f"climsim.{res['op']}.default"],
              f"{label}: the exported graph calls {res['ops']}")
        check(res["launches"] == {res["kernel"]: 1},
              f"{label}: launched {res['launches']}")
        check(res["equal"] or res["max_abs_diff"] <= 1e-6 * res["scale"],
              f"{label}: differs from the eager wrapper by "
              f"{res['max_abs_diff']} (scale {res['scale']})")
        print(f"export wrapper {res['arm']}, {res['ncol']} columns, "
              f"reloaded in a fresh process (no model built): loaded in "
              f"{res['load_s']:.2f} s, {res['kernel'].upper()} launched "
              f"{res['launches'][res['kernel']]} a call, outputs "
              f"{'bit-equal to' if res['equal'] else 'within 1e-6 of scale of'}"
              f" the eager wrapper's (max |diff| {res['max_abs_diff']:.3e}); "
              f"{res['ms']:.4f} ms a step against eager "
              f"{res['eager_ms']:.4f} [{card}]")
    print(f"export: the fresh process took {time.perf_counter() - t0:.1f} s "
          f"wall")
    return wrappers


def check_validate_export(card, root, w):
    """validate_export of the reloaded v4 384-column artifact over an
    8-step synthetic raw series, against the eager wrapper's teacher-forced
    rollout as truth: it must pass, with no error."""
    from climsim_tpu_torch.export import load_step
    from climsim_tpu_torch.export.validate import (offline_rollout,
                                                   validate_export)
    ncol = LO_NLAT * LO_NLON
    series = [raw_state(ncol, seed=1000 + t) for t in range(VALIDATE_STEPS)]
    xm = torch.stack([s[0] for s in series])
    xs = torch.stack([s[1] for s in series])
    mem0 = series[0][2]
    outs, sfcs, _ = offline_rollout(w, xm, xs, mem0)
    step = load_step(os.path.join(root, f"v4_{ncol}.pt2"))
    t0 = time.perf_counter()
    rep = validate_export(step, xm, xs, outs, sfcs, mem0)
    wall = time.perf_counter() - t0
    worst = max(rep["rel_rmse"])
    print(f"validate_export of the reloaded v4 artifact, {VALIDATE_STEPS} "
          f"steps x {ncol} columns: passed {rep['passed']}, nan_frac "
          f"{rep['nan_frac']}, worst rel_rmse against the eager wrapper "
          f"{worst:.3e}, {wall:.3f} s [{card}]")
    check(rep["passed"] and worst <= 1e-6, f"validate_export: {rep}")


def check_phys_cli_export(card, tmp, grid):
    """conf/autoreg_physrnn.yaml as written (the scan trunk) through the
    rollout CLI at its default 384 columns, 1 epoch (W 1), with
    export_path: the artifact reloaded (load_step) holds B11 and B12 as
    climsim:: nodes, launches them as the eager forward does, and equals
    it."""
    from climsim_tpu_torch.export import load_step, serialize
    from climsim_tpu_torch.models import PhysicalRNNAutoreg
    from climsim_tpu_torch.ops.library import exported_ops
    yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                        "autoreg_physrnn.yaml")
    path = os.path.join(tmp, "physrnn.pt2")
    seen, orig = {}, serialize.export_step

    def spy(fn, example_args, p):
        seen.update(fn=fn, args=example_args)
        return orig(fn, example_args, p)
    serialize.export_step = spy
    try:
        r = train_cli_run([yaml, f"grid_path={grid}", "epochs=1",
                           f"export_path={path}"], PhysicalRNNAutoreg)
    finally:
        serialize.export_step = orig
    check_cli_records("physics yaml export", r, [1])
    nbytes = os.path.getsize(path)
    check(f"exported {nbytes} bytes of torch.export program to {path}"
          in r.lines, "the CLI's export line")
    step = load_step(path)
    ops = sorted(set(exported_ops(step.graph)))
    check(ops == ["climsim.adding_sw_fast.default",
                  "climsim.lw_solver_noscat_fast.default"],
          f"the physics artifact calls {ops}")
    fn, args = seen["fn"], seen["args"]
    want, e_launch = counted(lambda: fn(*args))
    got, r_launch = counted(lambda: step(*args))
    check(set(r_launch) == {"b11", "b12"} and r_launch == e_launch,
          f"the reloaded physics step launched {r_launch}, eager {e_launch}")
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    diff = max_err(got, want)
    scale = max(t.abs().max().item() for t in want)
    check(equal or diff <= 1e-6 * scale, f"the reloaded physics step "
          f"differs by {diff} (scale {scale})")
    e_ms = median_ms(lambda: fn(*args), 1, repeats=REPEATS, queue_ahead=False)
    r_ms = median_ms(lambda: step(*args), 1, repeats=REPEATS, queue_ahead=False)
    print(f"cli train_rollout physics yaml, {args[0].shape[0]} columns, 1 "
          f"epoch, export_path: {nbytes} bytes (scan trunk unrolled), "
          f"wall {r.wall:.2f} s; reloaded: launches {r_launch} a call as "
          f"eager, outputs {'bit-equal' if equal else 'within 1e-6 of scale'}"
          f" (max |diff| {diff:.3e}); {r_ms:.4f} ms a step against eager "
          f"{e_ms:.4f} (host clock included) [{card}]")


def check_level_major_export(card, root, models):
    """export_step of the v6 (B1) and v5 (B4) models' channel-major
    forward at 21,600 columns, reloaded in process: one climsim:: node,
    the kernel once a call, outputs equal to the eager forward's."""
    from climsim_tpu_torch.export import export_step, load_step
    from climsim_tpu_torch.ops.library import exported_ops
    ncol = NLAT * NLON
    g = torch.Generator(device="cuda").manual_seed(43)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    args = (r(NLEV, 6, ncol), r(ncol, 24), 0.5 * r(NLEV, 16, ncol))
    for name, model, kernel, op in models:
        path = os.path.join(root, f"{name}_{ncol}.pt2")
        nbytes = export_step(model.forward, args, path)
        step = load_step(path)
        ops = exported_ops(step.graph)
        check(ops == [f"climsim.{op}.default"], f"{name}: {ops}")
        want, e_launch = counted(lambda: model(*args))
        got, r_launch = counted(lambda: step(*args))
        check(r_launch == e_launch == {kernel: 1}, f"{name}: launches "
              f"{r_launch}, eager {e_launch}")
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        diff = max_err(got, want)
        scale = max(t.abs().max().item() for t in want)
        check(equal or diff <= 1e-6 * scale, f"{name}: reloaded differs by "
              f"{diff}")
        e_ms = median_ms(lambda: model(*args), 1, repeats=REPEATS)
        r_ms = median_ms(lambda: step(*args), 1, repeats=REPEATS)
        print(f"export_step of the {name} model ({kernel.upper()}), {ncol} "
              f"columns: {nbytes} bytes, {kernel.upper()} once a call, "
              f"outputs {'bit-equal' if equal else 'within 1e-6 of scale'}; "
              f"{r_ms:.4f} ms a step against eager {e_ms:.4f} [{card}]")


# the int8 forward's (relative RMS, correlation) against the f32 scan
# forward at 21,600 columns and the GRU yaml's widths, on this script's
# seeded weights and inputs (out, out_sfc, mem), as three runs of
# check_quantized on an H100 read them alike to every printed digit; at
# 384 columns the card's and the CPU's readings agree within 1.1%, and
# the CPU's equal JAX's (tests/test_torch_quantize.py)
INT8_FULL_WIDTH = ((0.0788, 0.99690), (0.0204, 0.99979), (0.0620, 0.99806))


def int8_accuracy(got, want) -> list:
    """(relative RMS error, correlation) of each int8 output against the
    float32 one, as JAX's accuracy test computes them."""
    out = []
    for a, b in zip(got, want):
        a, b = a.flatten().double(), b.flatten().double()
        rel = ((a - b).square().mean().sqrt()
               / b.square().mean().sqrt().clamp(min=1e-12)).item()
        out.append((rel, torch.corrcoef(torch.stack([a, b]))[0, 1].item()))
    return out


def check_quantized(card):
    """QuantGRUForward (int8 weights and activations, torch._int_mm on the
    card): JAX's accuracy gates (relative RMS below 0.05, correlation
    above 0.99 on every output) at the configuration JAX's test sets them
    for (nneur 64/64, nh_mem 8, ny 6, 32 columns); at the yaml's widths
    (nneur 192/192, nh_mem 16, ny 5) the int8 products on the card equal
    the CPU's bit for bit (int32, on the same int8 operands, at the input
    projection's and the recurrence's shapes of 21,600 columns and the
    TOA MLP's K 2), and at 384 columns the card's int8 forward is as
    accurate against its f32 forward as the CPU's against its own (the
    two relative RMS errors within 5% of each other: a value within an
    ulp of a rounding boundary lands on either int8 step, and the
    recurrence carries each such flip on, so the two int8 forwards differ
    elementwise by more than the accuracy they share; the readings
    differed by 1.1% at most); then at 21,600 columns its accuracy
    against the f32 scan forward, held to INT8_FULL_WIDTH, and the ms of
    each, host clock included (both are launch-bound). At the yaml's
    widths the two packages' int8 accuracy is the same
    (tests/test_torch_quantize.py), so what 21,600 columns shows is the
    reference algorithm's."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.export.quantize import QuantGRUForward, _int_mm
    from climsim_tpu_torch.models import RNNAutoreg
    g = Grid.synthetic(LO_NLAT * LO_NLON, NLEV)
    gen = torch.Generator().manual_seed(47)

    def build(nneur, nh_mem, ny, device):
        return RNNAutoreg(nx=EXPORT_NX, nx_sfc=EXPORT_NX_SFC, ny=ny, ny_sfc=8,
                          nneur=nneur, nh_mem=nh_mem,
                          hyam=tuple(g.hyam.tolist()),
                          hybm=tuple(g.hybm.tolist()), sp_mean=9.8e4,
                          sp_div=1e4, device=device)

    def inputs(ncol, nh_mem):
        r = lambda sd, *s: sd * torch.randn(s, generator=gen)
        return (r(1.0, ncol, NLEV, EXPORT_NX), r(1.0, ncol, EXPORT_NX_SFC),
                r(0.3, ncol, NLEV, nh_mem))

    text = []
    model = build((64, 64), 8, 6, None)
    args = [t.cuda() for t in inputs(32, 8)]
    acc = int8_accuracy(QuantGRUForward(model)(*args), model(*args))
    for name, (rel, corr) in zip(("out", "out_sfc", "mem"), acc):
        check(rel < 0.05 and corr > 0.99, f"int8 {name} at JAX's test "
              f"configuration: rel {rel}, corr {corr}")
    text.append("JAX's test configuration (nneur 64, 32 columns): "
                + ", ".join(f"rel RMS {r:.4f} corr {c:.5f}" for r, c in acc)
                + " (gates 0.05, 0.99: met)")
    ncol = NLAT * NLON
    for M, K, N in ((ncol * NLEV, 208, 576), (ncol, 192, 576), (ncol, 2, 192)):
        a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
        got = _int_mm(a.cuda(), b.cuda()).cpu()
        check(torch.equal(got, _int_mm(a, b)), f"int8 product {M}x{K}x{N}: "
              f"card and CPU differ")
    text.append("int8 products card vs CPU bit-equal at (M, K, N) = "
                f"({ncol * NLEV}, 208, 576), ({ncol}, 192, 576), ({ncol}, 2, "
                f"192)")
    cpu = build((192, 192), EXPORT_NM, EXPORT_NY, "cpu")
    model = build((192, 192), EXPORT_NM, EXPORT_NY, None)
    check(model.arm == "scan", model.arm)
    model.load_state_dict(cpu.state_dict())
    args = inputs(LO_NLAT * LO_NLON, EXPORT_NM)
    acc_cpu = int8_accuracy(QuantGRUForward(cpu)(*args), cpu(*args))
    args = [t.cuda() for t in args]
    acc_card = int8_accuracy(QuantGRUForward(model)(*args), model(*args))
    for name, (rc, _), (rg, _) in zip(("out", "out_sfc", "mem"), acc_cpu,
                                      acc_card):
        check(abs(rg - rc) <= 0.05 * rc, f"int8 {name} at 384 columns: "
              f"relative RMS {rg} on the card, {rc} on the CPU")
        text.append(f"{name} at 384 columns rel RMS against f32 {rg:.4f} on "
                    f"the card, {rc:.4f} on the CPU")
    args = [t.cuda() for t in inputs(ncol, EXPORT_NM)]
    q = QuantGRUForward(model)
    (want, got), launches = counted(lambda: (model(*args), q(*args)))
    check(not launches, f"the scan forwards launched {launches}")
    check(all(bool(torch.isfinite(t).all()) for t in got), "int8 not finite")
    acc = int8_accuracy(got, want)
    for name, (rel, corr), (rel0, corr0) in zip(
            ("out", "out_sfc", "mem"), acc, INT8_FULL_WIDTH):
        check(abs(rel - rel0) <= 0.05 * rel0 and corr >= corr0 - 1e-3,
              f"int8 {name} at {ncol} columns: rel RMS {rel} (reading "
              f"{rel0}, band 5%), corr {corr} (reading {corr0}, band 1e-3)")
    q_ms = median_ms(lambda: q(*args), 1, repeats=REPEATS, queue_ahead=False)
    f_ms = median_ms(lambda: model(*args), 1, repeats=REPEATS, queue_ahead=False)
    print(f"QuantGRUForward (int8): {'; '.join(text)} [{card}]")
    print(f"QuantGRUForward (int8) at {ncol} columns, the yaml's widths, "
          f"against the f32 scan forward: " + ", ".join(
              f"{n} rel RMS {r:.4f} corr {c:.5f}" for n, (r, c) in
              zip(("out", "out_sfc", "mem"), acc))
          + f"; int8 {q_ms:.4f} ms, f32 scan {f_ms:.4f} ms a forward "
          f"[{card}]")


def run_profile_cli(card, tmp):
    """``python -m climsim_tpu_torch.cli.profile --steps 3`` through its
    main, from a directory holding a 384-column grid file at
    run_hybrid.DEFAULT_GRID: its trace must hold device kernels."""
    from climsim_tpu_torch.cli import profile, run_hybrid
    d = os.path.join(tmp, "profile")
    os.makedirs(os.path.join(d, os.path.dirname(run_hybrid.DEFAULT_GRID)))
    write_grid_file(os.path.join(d, run_hybrid.DEFAULT_GRID),
                    LO_NLAT * LO_NLON)
    here, out = os.getcwd(), io.StringIO()
    os.chdir(d)
    try:
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = profile.main(["--steps", "3", "--logdir", "trace"])
            wall = time.perf_counter() - t0
    finally:
        os.chdir(here)
    traces = [f for f in os.listdir(os.path.join(d, "trace"))
              if f.startswith("trace_")]
    check(rc == 0 and len(traces) == 1, f"cli.profile: exit {rc}, traces "
          f"{traces}")
    with open(os.path.join(d, "trace", traces[0])) as f:
        kernels = sum(e.get("cat") == "kernel"
                      for e in json.load(f)["traceEvents"])
    check(kernels > 0, "cli.profile's trace holds no device kernel")
    for ln in out.getvalue().splitlines():
        print(f"  cli.profile: {ln}")
    print(f"cli.profile --steps 3 (batch 1536, scan arm, f32): wall "
          f"{wall:.2f} s, {kernels} device kernels in its trace [{card}]")


def host_us(fn, n) -> float:
    """Host microseconds a call of ``fn`` over ``n`` calls enqueued
    without a synchronize (the card syncs before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def op_hop_in_turns(card, model, v5model, v2model, lbh_models):
    """Each forward kernel through its climsim:: op against its CUDA
    implementation called directly (the launch path before the ops were
    registered), device ms in turns (direct, op, op, direct) at the main
    paths' shapes: the op adds a dispatch on the host and nothing on the
    card."""
    from climsim_tpu_torch.ops import pallas_radiation as PRad
    from climsim_tpu_torch.ops import pallas_rnn as PR
    ncol, bf = NLAT * NLON, torch.bfloat16
    ops = torch.ops.climsim
    a = {"b1": list(b1_args(model, ncol, bf, seed=7)),
         "b4": list(b4_args(v5model, ncol, bf, seed=23)),
         "b7": list(b7_args(v2model, ncol, bf, seed=29, L=NLEV)),
         "b9": list(b9_args(lbh_models["b9"], ncol, bf, seed=31)),
         "b10": list(b10_args(lbh_models["b10"], ncol, bf, seed=37))}
    sw, lw = radiation_args(ncol, "cuda")
    a["b11"], a["b12"] = list(sw), list(lw)
    pairs = {
        "b1": (lambda: PR._b1_cuda(True, a["b1"]),
               lambda: ops.fused_bigru_heads_init_cm(True, a["b1"]), 3),
        "b4": (lambda: PR._b4_cuda(True, True, a["b4"]),
               lambda: ops.fused_bigru_heads_cm(True, True, a["b4"]), 3),
        "b7": (lambda: PR._b7_cuda(True, a["b7"]),
               lambda: ops.fused_bigru_lbh(True, a["b7"]), 3),
        "b9": (lambda: PR._heads_lbh_cuda(a["b9"], False),
               lambda: ops.fused_bigru_heads_lbh(True, a["b9"]), 3),
        "b10": (lambda: PR._heads_lbh_cuda(a["b10"], True),
                lambda: ops.fused_bigru_heads_init_lbh(True, a["b10"]), 3),
        "b11": (lambda: PRad._b11_cuda(a["b11"]),
                lambda: ops.adding_sw_fast(a["b11"]), 50),
        "b12": (lambda: PRad._b12_cuda(a["b12"]),
                lambda: ops.lw_solver_noscat_fast(a["b12"]), 50)}
    for k, (direct, op, n) in pairs.items():
        old, new = in_turns(direct, op, n)
        ratio = statistics.mean(new) / statistics.mean(old)
        print(f"{k.upper()} through its climsim:: op in turns with its CUDA "
              f"implementation called directly (direct, op, op, direct): "
              f"{old[0]:.4f} / {old[1]:.4f} ms direct, {new[0]:.4f} / "
              f"{new[1]:.4f} ms through the op ({ratio:.4f}x) [{card}]")
    # the host's side: B10 at 384 columns, whose device time covers the
    # enqueueing of 100 calls, timed on the host clock in turns
    a10 = list(b10_args(lbh_models["b10"], LO_NLAT * LO_NLON, bf, seed=37))
    host = {"direct": [], "op": []}
    for name in ("direct", "op", "op", "direct"):
        fn = (lambda: PR._heads_lbh_cuda(a10, True)) if name == "direct" \
            else (lambda: ops.fused_bigru_heads_init_lbh(True, a10))
        host[name].append(host_us(fn, 100))
    print(f"B10 at {LO_NLAT * LO_NLON} columns, host time a call in turns "
          f"(direct, op, op, direct): {host['direct'][0]:.1f} / "
          f"{host['direct'][1]:.1f} us direct, {host['op'][0]:.1f} / "
          f"{host['op'][1]:.1f} us through the op [{card}]")


@torch.no_grad()
def check_export(card, model, v5model, v2model, lbh_models):
    """Phase 13, the deployment export on the card: the wrappers
    (check_wrapper_exports), validate_export, the physics yaml's CLI
    export, the level-major models' export, the int8 forward, the
    profiling CLI and the op dispatch in turns; each step's seconds
    printed."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="export", dir=os.path.join(here, "build"))
    try:
        steps = []

        def step(name, fn, *args):
            t0 = time.perf_counter()
            res = fn(*args)
            steps.append(f"{name} {time.perf_counter() - t0:.1f} s")
            return res
        wrappers = step("wrappers", check_wrapper_exports, card, tmp)
        step("validate_export", check_validate_export, card, tmp,
             wrappers["v4"])
        del wrappers
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        step("physics CLI export", check_phys_cli_export, card, tmp, grid)
        step("v6 and v5 export", check_level_major_export, card, tmp,
             (("v6", model, "b1", "fused_bigru_heads_init_cm"),
              ("v5", v5model, "b4", "fused_bigru_heads_cm")))
        step("int8 forward", check_quantized, card)
        step("cli.profile", run_profile_cli, card, tmp)
        step("op dispatch in turns", op_hop_in_turns, card, model, v5model,
             v2model, lbh_models)
        print("phase 13 steps: " + ", ".join(steps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 14

# C.2's arms (every batch- and channel-major RNNAutoreg arm of ARMS)
C2_ARMS = ("v6", "v5", "v4", "v3", "v2", "scan")
# conf/autoreg_srnn.yaml: the widths to try, widest first; the W 3 update
# of the widest whose peak, scaled from one measured at the narrowest,
# stays under SRNN_PEAK_GB runs (the card holds 80 GB)
SRNN_NCOLS = (NLAT * NLON, NLAT * NLON // 2, NLAT * NLON // 4,
              NLAT * NLON // 8)
SRNN_PEAK_GB = 72.0
# the curricula compressed so that each yaml's windows run in 3 epochs:
# the stochastic yaml's W 1, 2, 3 and the long-window yaml's W 1, 5, 11
SRNN_SCHEDULE = "rollout.schedule={0: 1, 1: 2, 2: 3}"
LW_SCHEDULE = "rollout.schedule={0: 1, 1: 5, 2: 11}"
# the long-window yaml at 21,600 columns on 24 steps of data for its 48
# (19 training steps: one chunk of 12, so 12, 2 and 1 updates at W 1, 5
# and 11), to hold the phase's time
LW_STEPS = "data.steps=24"
# the card-vs-CPU lockstep runs at 384 columns: the stochastic yaml at 3
# steps (2 W 1 updates of the 4-member ensemble; the CPU's side of each
# costs 3 evaluations of 1,536 model columns), the long-window yaml at 14
# (11 W 1 SOAP updates: the first basis, 9 preconditioned steps and the
# refresh at step 10)
SRNN_384 = ("data.steps=3", "model.use_pallas=true")
LW_384 = ("data.steps=14",)
# the optimizers' steps timed on the long-window yaml's model: SOAP's
# plain steps apart from its refresh steps (every 10th), and beside it
# Muon, schedule-free AdamW and Adam
OPT_STEPS = 21


class ListToaIndex:
    """``RNNAutoreg``'s TOA input as it was before C.2's repair, switched
    on for the calls of ``fn`` wrapped by ``old(fn)``: ``x_sfc[:, [1,
    6]]``, the list index that becomes a host index tensor copied to the
    card at every call. Hooks on the model (capturing x_sfc) and on
    ``mlp_toa1`` (replacing its input) do it; off, they change nothing."""

    def __init__(self, model):
        self.on, self.box = False, {}
        self.hooks = [
            model.register_forward_pre_hook(self._capture),
            model.mlp_toa1.register_forward_pre_hook(self._replace)]
        self.cast = model.policy.cast_in

    def _capture(self, module, args):
        self.box["x_sfc"] = args[1]

    def _replace(self, module, args):
        if self.on:
            return (self.cast(self.box["x_sfc"])[:, [1, 6]],)
        return None

    def old(self, fn):
        def run():
            self.on = True
            try:
                return fn()
            finally:
                self.on = False
        return run

    def remove(self):
        for h in self.hooks:
            h.remove()


def no_host_sync(fn, label):
    """``fn()`` holds no synchronizing CUDA operation: listed with
    ``set_sync_debug_mode("warn")`` (host_syncs), then run once more under
    ``"error"``, where one would raise."""
    syncs = host_syncs(fn)
    check(not syncs, f"{label}: synchronizing operations at {syncs}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def check_c2(card):
    """C.2: a coupled step of every arm at 21,600 columns and the eager
    wrapper step (v4, v2, v3 at 384 and 21,600 columns) with no
    synchronizing operation (no_host_sync); then each timed in turns
    against the list index of before (ListToaIndex), the coupled steps at
    384 columns: (old, new, new, old) with CUDA events behind a queued
    wait (median_ms, 2 repeats), as phase 13 timed the eager wrapper.
    Returns the timings by label."""
    from climsim_tpu_torch.models import BF16
    dev = torch.device("cuda")
    out = {}
    for arm in C2_ARMS:
        model = make_model(BF16, None, arm=arm)
        check(model.arm == arm, f"{arm} flags built {model.arm}")
        toa = ListToaIndex(model)
        for nlat, nlon in ((NLAT, NLON), (LO_NLAT, LO_NLON)):
            ncol = nlat * nlon
            loop = make_loop(model, ProxyGrid(nlat, nlon, NLEV, dev), nlat,
                             nlon, None, arm)
            inputs = initial_state(ncol, NLEV, dev, model.level_major)
            step = functools.partial(loop.coupled_step, *inputs)
            step()
            if ncol == NLAT * NLON:
                no_host_sync(step, f"coupled step {arm}")
                old_syncs = host_syncs(toa.old(step))
                check(len(old_syncs) > 0, f"{arm}: the list index made no "
                      f"synchronizing operation")
                print(f"C.2 coupled step {arm} at {ncol} columns: no "
                      f"synchronizing operation (the list index of before: "
                      f"{len(old_syncs)}, at {old_syncs[0]})")
                continue
            old, new = in_turns(toa.old(step), step, 1, 2)
            out[f"coupled {arm} {ncol}"] = (old, new)
            print(f"C.2 coupled step {arm} at {ncol} columns in turns (list "
                  f"index, view, view, list index): {old[0]:.4f} / "
                  f"{old[1]:.4f} ms against {new[0]:.4f} / {new[1]:.4f} ms "
                  f"[{card}]")
        toa.remove()
        del model, loop, inputs
    norm = export_norm()
    for arm in EXPORT_ARMS:
        w = export_wrapper_of(arm, norm)
        toa = ListToaIndex(w.model)
        for ncol in EXPORT_NCOLS:
            x, xs, mem = raw_state(ncol, seed=ncol)
            step = functools.partial(w, x, xs, mem)
            step()
            no_host_sync(step, f"eager wrapper {arm} {ncol}")
            old, new = in_turns(toa.old(step), step, 1, 2)
            out[f"wrapper {arm} {ncol}"] = (old, new)
            print(f"C.2 eager wrapper step {arm} at {ncol} columns, no "
                  f"synchronizing operation; in turns (list index, view, "
                  f"view, list index): {old[0]:.4f} / {old[1]:.4f} ms "
                  f"against {new[0]:.4f} / {new[1]:.4f} ms [{card}]")
        toa.remove()
    torch.cuda.empty_cache()
    return out


def srnn_width(grid, card):
    """The widest of SRNN_NCOLS whose W 3 update of conf/autoreg_srnn.yaml
    (model.use_pallas=true: the scan trunk all the same) should stay
    under SRNN_PEAK_GB: one update measured at the narrowest, its peak
    scaled by the columns."""
    from climsim_tpu_torch.cli import train_rollout as cli
    from climsim_tpu_torch.train.config import load_config
    n0 = SRNN_NCOLS[-1]
    run = cli.setup(load_config(SRNN_YAML, [
        f"grid_path={grid}", f"data.ncol={n0}", "model.use_pallas=true",
        "device=cuda"]))
    tr = run.trainer
    chunk = next(iter(run.chunks(0, run.ntr, False)))
    mem = tr.init(chunk)
    window = tr._window(chunk, 0, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.update(window, mem, None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    fits = [n for n in SRNN_NCOLS if peak * n / n0 <= SRNN_PEAK_GB]
    print(f"srnn yaml: one W 3 update at {n0} columns peaks at "
          f"{peak:.3f} GB; scaled by the columns: "
          + ", ".join(f"{n} {peak * n / n0:.1f} GB" for n in SRNN_NCOLS)
          + f"; runs at {fits[0]} columns [{card}]")
    del run, tr, chunk, mem, window
    gc.collect()
    torch.cuda.empty_cache()
    return fits[0]


def yaml_run(label, args, ncol, members, card):
    """The rollout CLI on ``args`` as a user runs it (train_cli_run), three
    epochs: no kernel may launch (as in JAX, both yamls' models run the
    scan trunk); ms per update for each window, member column-steps/s and
    the peak. Returns the run."""
    from climsim_tpu_torch.models import RNNAutoreg
    r = train_cli_run(args, RNNAutoreg)
    check(r.rc == 0, f"{label}: exit {r.rc}")
    check(r.run.trainer.model.arm == "scan", f"{label}: arm "
          f"{r.run.trainer.model.arm}")
    check(r.launches == {}, f"{label}: launched {r.launches}")
    for rec in r.records:
        check(np.isfinite(rec["loss"]) and np.isfinite(rec["val_loss"]),
              f"{label}: record not finite: {rec}")
        ms = rec["seconds"] / rec["updates"] * 1e3
        rate = rec["updates"] * rec["window"] * ncol * members \
            / rec["seconds"]
        print(f"cli train_rollout {label}, {ncol} columns: epoch "
              f"{rec['epoch']}, W {rec['window']}: {rec['updates']} updates "
              f"in {rec['seconds']:.3f} s, {ms:.2f} ms an update, "
              f"{rate:,.0f} member column-steps/s [{card}]")
    print(f"cli train_rollout {label}, {ncol} columns: wall {r.wall:.3f} s "
          f"for {len(r.records)} epochs with validation, peak "
          f"{r.peak_gb:.3f} GB [{card}]")
    check(r.peak_gb < 80.0, f"{label}: peak {r.peak_gb} GB")
    return r


def time_optimizers(model, card):
    """One step of each optimizer on ``model``'s parameters from fixed
    random gradients, synchronized wall ms (the host's per-parameter loop
    included): SOAP's first step (its first basis, eigh), its plain steps
    and its refresh steps (every 10th: power iteration, QR and a host
    synchronization of eigh/qr's checks) apart, Muon, schedule-free AdamW
    and Adam (torch's, as the port runs optax's adam)."""
    from climsim_tpu_torch.train.muon import Muon
    from climsim_tpu_torch.train.schedule_free import ScheduleFreeAdamW
    from climsim_tpu_torch.train.soap import SOAP
    params = [p for p in model.parameters()]
    saved = [p.detach().clone() for p in params]
    g = torch.Generator(device="cuda").manual_seed(5)
    grads = [1e-3 * torch.randn(p.shape, generator=g, device="cuda")
             for p in params]
    made = {"SOAP": lambda ps: SOAP(ps, lr=5e-4),
            "Muon": lambda ps: Muon(ps, lr=5e-4),
            "schedule-free AdamW": lambda ps: ScheduleFreeAdamW(ps, lr=5e-4),
            "Adam": lambda ps: torch.optim.Adam(ps, lr=5e-4, eps=1e-8)}
    res = {}
    for name, make in made.items():
        opt = make(params)
        times = []
        for _ in range(OPT_STEPS):
            for p, gr in zip(params, grads):
                p.grad = gr
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if name == "SOAP":
            res["SOAP first step (eigh)"] = times[0]
            res["SOAP refresh step"] = statistics.median(times[10::10])
            res["SOAP plain step"] = statistics.median(
                [t for i, t in enumerate(times) if i % 10])
        else:
            res[name] = statistics.median(times[1:])
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
    n = sum(p.numel() for p in params)
    print(f"optimizer steps on the long-window yaml's model ({len(params)} "
          f"parameters, {n:,} weights), synchronized wall ms a step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.items())
          + f" [{card}]")
    for p in params:
        p.grad = None
    return res


SRNN_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                         "autoreg_srnn.yaml")
LW_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                       "autoreg_longwindows.yaml")


def check_stochastic_slice(card):
    """Phase 14: C.2 (check_c2); conf/autoreg_srnn.yaml through the CLI at
    the widest width that fits (srnn_width) with model.use_pallas=true
    (no kernel launches: the stochastic model runs the scan trunk) and
    one more epoch under the profiler; conf/autoreg_longwindows.yaml
    through the CLI at 21,600 columns; the optimizers' steps; both yamls
    at 384 columns held to device=cpu in lockstep (compare_cli_384, the
    ensemble's noise replayed, SOAP fed the card's state)."""
    from climsim_tpu_torch.models import RNNAutoreg
    t0 = time.perf_counter()
    c2 = check_c2(card)
    print(f"phase 14: C.2 took {time.perf_counter() - t0:.1f} s")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="stoch_cli", dir=root)
    try:
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        t0 = time.perf_counter()
        ncol = srnn_width(grid, card)
        r = yaml_run("srnn yaml (model.use_pallas=true)", [
            SRNN_YAML, f"grid_path={grid}", f"data.ncol={ncol}", "epochs=3",
            SRNN_SCHEDULE, "model.use_pallas=true"], ncol, 4, card)
        check([rec["window"] for rec in r.records] == [1, 2, 3],
              "srnn windows")
        check(r.run.trainer.cfg.ensemble_size == 4
              and r.run.trainer.model.add_stochastic_layer
              and r.run.trainer.model.ar_noise_rho == 0.95,
              "the srnn yaml's ensemble, stochastic layer and rho")
        cli_epoch_profile("srnn yaml", r, 2, ncol, card,
                          os.path.join(tmp, "trace.json"))
        srnn = (ncol, r.records, r.peak_gb)
        r = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 14: the srnn yaml took {time.perf_counter() - t0:.1f} "
              f"s")
        t0 = time.perf_counter()
        r = yaml_run("long-window yaml", [
            LW_YAML, f"grid_path={grid}", f"data.ncol={NLAT * NLON}",
            "epochs=3", LW_SCHEDULE, LW_STEPS], NLAT * NLON, 1, card)
        check([rec["window"] for rec in r.records] == [1, 5, 11],
              "long-window windows")
        check(type(r.run.trainer.opt).__name__ == "SOAP",
              f"the long-window yaml's optimizer {type(r.run.trainer.opt)}")
        lw = (r.records, r.peak_gb)
        opts = time_optimizers(r.run.trainer.model, card)
        r = None
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 14: the long-window yaml took "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        compare_cli_384(card, grid, SRNN_YAML, RNNAutoreg, SRNN_384, True)
        compare_cli_384(card, grid, LW_YAML, RNNAutoreg, LW_384, True)
        print(f"phase 14: the 384-column lockstep took "
              f"{time.perf_counter() - t0:.1f} s ({torch.get_num_threads()} "
              f"CPU threads)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return c2, srnn, lw, opts


# ------------------------------------------------------------ phase 15

# the offline CLI's other arms at their published widths: the stochastic
# stack on conf/mlp_v1.yaml as written (BASELINE.json config 4's offline
# half; RPN at the CLI's 8 members and at RPNEnsemble's own 32), the
# ClimSim-Online U-Net on v4 at its defaults (128 channels, (1, 2, 2, 2),
# 4 blocks, attention at 16, output prune) and the v5 cloud classifier's
# gradout variant at its defaults (64 channels, (1, 2, 2), 2 blocks)
NEW_ARMS = {
    "rpn": ["model.name=rpn"],
    "rpn members=32": ["model.name=rpn", "model.members=32"],
    "hsr": ["model.name=hsr"],
    "cvae": ["model.name=cvae"],
    "unet": ["vset=v4", "model.name=unet"],
    "classifier_gradout": ["vset=v5", "model.name=classifier_gradout",
                           "optimizer.max_grad_norm=1.0"],
}
# each arm small (6 steps, 1 epoch, narrow; HSR 3 epochs, so that its
# NLL follows the warm epoch) on the card against device=cpu
NEW_ARMS_SMALL = {
    "hsr": ["model.name=hsr", "model.hidden=64", "epochs=3"],
    "rpn": ["model.name=rpn", "model.features=[64,64]", "model.members=4"],
    "cvae": ["model.name=cvae", "model.hidden=64"],
    "unet": ["vset=v4", "model.name=unet", "model.model_channels=16",
             "model.num_blocks=1"],
    "classifier": ["vset=v5", "model.name=classifier", "batch_size=384",
                   "model.model_channels=16", "model.num_blocks=1"],
    "classifier_gradout": ["vset=v5", "model.name=classifier_gradout",
                           "batch_size=384", "model.model_channels=16",
                           "model.num_blocks=1",
                           "optimizer.max_grad_norm=1.0"],
}


class NoiseLog:
    """The stochastic arms' draws, recorded from the card's run
    (``recorder(inner)``, a noise source that draws from ``inner``) and
    replayed, in order, to a CPU run (``replayer()``)."""

    def __init__(self):
        self.draws = []

    def recorder(self, inner):
        def draw(what, shape):
            t = inner(what, shape)
            self.draws.append((what, t.cpu()))
            return t
        return draw

    def replayer(self):
        queue = list(self.draws)

        def draw(what, shape):
            want, t = queue.pop(0)
            check(want == what and tuple(t.shape) == tuple(shape),
                  f"replayed draw {want} {tuple(t.shape)} for {what} {shape}")
            return t
        return draw


def update_closure(run):
    """One training update's loss of the run's arm on its first batch, as
    a closure (for the FLOP count): the CLI's own loss for the stochastic
    arms (``stochastic_loss``, after the warm phase) and the classifiers
    (``classifier_ce``); the U-Net's squared error (the FLOP count sees
    only its products and convolutions)."""
    from climsim_tpu_torch.cli import train_offline as cli
    bs = run.fc.batch_size
    xb, yb = run.xn[:bs], run.yn[:bs]
    if run.name in cli.STOCHASTIC:
        loss_fn = cli.stochastic_loss(run, cli.SeededNoise(1, xb.device))
        return lambda: loss_fn(xb, yb, run.fc.epochs)
    if run.name in cli.CLASSIFIERS:
        return lambda: cli.classifier_ce(run, 0)
    return lambda: torch.mean(torch.square(run.model(xb) - yb))


def update_flops(run) -> float:
    """The FLOPs of one update's forward and backward (products,
    convolutions and attention; torch's FlopCounterMode), the prior's
    forward included for RPN."""
    from torch.utils.flop_counter import FlopCounterMode
    loss = update_closure(run)
    with torch.enable_grad(), FlopCounterMode(display=False) as fc:
        loss().backward()
    run.model.zero_grad(set_to_none=True)
    return float(fc.get_total_flops())


def new_arm_summary(label, r, card):
    """Check a run of a new arm (exit 0, a finite record an epoch, no port
    kernel launched, JAX's final lines) and print its wall time, seconds
    an epoch, ms an update, samples/s (member samples/s for RPN), the
    update's FLOP rate against the f32 bound, and the peak. Returns ms an
    update."""
    run = r.run
    name = run.name
    check(r.rc == 0, f"{label}: exit {r.rc}")
    check(len(run.history) == run.fc.epochs, f"{label}: {len(run.history)} "
          f"records for {run.fc.epochs} epochs")
    for rec in run.history:
        check(all(np.isfinite(v) for v in rec.values()),
              f"{label}: record not finite: {rec}")
    check(not r.launches, f"{label} launched {r.launches}")
    if name.startswith("classifier"):
        check(r.lines[-1].startswith('{"val_accuracy"'), f"{label}: no "
              "accuracy line")
        print(f"  cli: {r.lines[-1][:300]}")
    else:
        check(any(ln.startswith("ptend_t ") for ln in r.lines),
              f"{label}: no scoreboard")
        if name in ("hsr", "rpn", "cvae"):
            check("CRPS" in run.scores.columns, f"{label}: no CRPS column")
    for rec in run.history[:1] + run.history[-1:]:
        print(f"  cli: {json.dumps(rec)[:300]}")
    bs = run.fc.batch_size
    updates = run.ntr // bs
    secs = [rec["seconds"] for rec in run.history]
    rest = statistics.mean(secs[1:] or secs)
    ms = rest / updates * 1e3
    flop = update_flops(run)
    members = getattr(run.model, "num_members", 1)
    rate = updates * bs / rest
    print(f"cli train_offline {label}: wall {r.wall:.3f} s ({len(secs)} "
          f"epochs and the final scoring), training epoch {secs[0]:.4f} s "
          f"first, {rest:.4f} s mean of the rest; {updates} updates an "
          f"epoch at batch {bs}: {ms:.3f} ms an update"
          + (" (the epoch's validation included)"
             if name.startswith("classifier") else "")
          + f", {rate:,.0f} samples/s"
          + (f" ({rate * members:,.0f} member samples/s, {members} members)"
             if name == "rpn" else "")
          + f"; an update {flop / 1e9:.2f} GFLOP (FlopCounterMode), "
          f"{flop / ms / 1e9:.3f} TFLOP/s, bound {flop / PEAK_F32 * 1e3:.3f} "
          f"ms at the f32 CUDA-core peak ({flop / PEAK_F32 * 1e3 / ms:.3f} "
          f"of it); peak {r.peak_gb:.3f} GB above the memory held before "
          f"the run; no kernel of the port launched [{card}]")
    return ms


def arm_epoch_profile(card, label, r, trace_path):
    """One more training epoch of a stochastic or classifier arm through
    the CLI's own epoch (``stochastic_epoch``, ``classifier_epoch``; a
    fresh Adam, no validation) under torch.profiler: the device idle
    share (1 - kernel time / synchronized wall time) and launches an
    update. For the classifiers also one update's kernels with the most
    device time, and its epoch timed without the profiler in turns (as run,
    with the clipping but not the gradout statistics, with neither, then
    back; synchronized wall time): ms an update, and what the statistics
    and the clipping cost."""
    from dataclasses import replace
    from climsim_tpu_torch.cli import train_offline as cli
    run = r.run
    updates = run.ntr // run.fc.batch_size
    opt = torch.optim.Adam(run.model.parameters(), lr=run.fc.lr)
    if run.name in cli.STOCHASTIC:
        noise = cli.SeededNoise(1, run.xn.device)
        loss_fn = cli.stochastic_loss(run, noise)
        epoch = lambda: cli.stochastic_epoch(run, opt, loss_fn,
                                             run.fc.epochs)
    else:
        gradout = run.name == "classifier_gradout"
        epoch = lambda: cli.classifier_epoch(run, opt, gradout)
    epoch()
    _, wall, busy, n_kernels, _ = profile_epoch(epoch, trace_path)
    check(busy > 0, f"{label}: the profiler saw no device time")
    print(f"cli train_offline {label}: one training epoch ({updates} "
          f"updates, the CLI's own epoch, no validation) under "
          f"torch.profiler: wall {wall:.3f} ms, kernels {busy:.3f} ms "
          f"({n_kernels / updates:.1f} launches an update), device idle "
          f"share {max(0.0, 1 - busy / wall):.3f} [{card}]")
    if run.name in cli.STOCHASTIC:
        return
    one = replace(run, ntr=run.fc.batch_size)       # the first batch alone
    busy, top = profile_kernels(
        lambda: cli.classifier_epoch(one, opt, gradout), top=6)
    print(f"cli train_offline {label}: one update's kernels with the most "
          f"device time: " + "; ".join(f"{k[:60]} {t:.3f} ms"
                                       for k, t in top)
          + f", of {busy:.3f} ms [{card}]")
    bare_run = replace(run, fc=replace(run.fc, max_grad_norm=None))
    arms = {"as run": epoch,
            "clipping only": lambda: cli.classifier_epoch(run, opt, False),
            "neither": lambda: cli.classifier_epoch(bare_run, opt, False)}
    ms = {k: [] for k in arms}
    for k in list(arms) + list(arms)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arms[k]()
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) * 1e3 / updates)
    print(f"cli train_offline {label}: ms an update without validation, "
          f"epochs timed in turns on the synchronized wall clock (gradout "
          f"statistics and clipping at {run.fc.max_grad_norm}): "
          + "; ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in ts)
                      for k, ts in ms.items()) + f" [{card}]")


def unet_kernels(card, r):
    """One U-Net update (fit's train step) under torch.profiler: every
    kernel by name; the convolutions must run as GEMMs, with no FFT
    kernel."""
    from climsim_tpu_torch.train.loop import init_state, make_train_step
    run = r.run
    bs = run.fc.batch_size
    state = init_state(run.model, run.fc)
    step = make_train_step(run.vset, run.fc, run.xn.device)
    xb, yb = run.xn[:bs], run.yn[:bs]
    step(state, xb, yb)
    busy, kernels = profile_kernels(lambda: step(state, xb, yb), top=None)
    names = [k for k, _ in kernels]
    check(not any("fft" in k.lower() for k in names),
          f"an FFT kernel in the U-Net update: {names}")
    check(any("gemm" in k.lower() or "sm90" in k.lower() for k in names),
          f"no GEMM kernel in the U-Net update: {names[:8]}")
    print(f"cli train_offline unet (v4): one update's kernels ({len(names)} "
          f"kinds, {busy:.3f} ms on the device, no FFT kernel): "
          + "; ".join(f"{k[:60]} {t:.3f} ms" for k, t in kernels[:6])
          + f" [{card}]")


@contextlib.contextmanager
def scored_inputs(store):
    """Within: the offline CLI's scoreboard (``metrics.evaluate``) appends
    its arguments, (args, kwargs), to ``store``."""
    from climsim_tpu_torch import metrics
    orig = metrics.evaluate

    def evaluate(*args, **kw):
        store.append((args, kw))
        return orig(*args, **kw)
    metrics.evaluate = evaluate
    try:
        yield
    finally:
        metrics.evaluate = orig


def score_on_cpu(scored, grid, sign=0):
    """``metrics.evaluate`` of a run's scoreboard arguments (``scored``,
    from ``scored_inputs``) on the CPU, with ``grid`` the CPU's. With
    ``sign`` +-1 every input with a leading time axis is first multiplied
    by 1 + sign (-1)^t 2^-23 at step t (a rounding witness: about one ulp,
    in the direction that moves a sum of squares about the time mean
    most)."""
    from climsim_tpu_torch.metrics import evaluate
    (pred, target, ps_raw, vset, _), kw = scored
    alt = sign * (-1.0) ** torch.arange(pred.shape[0], dtype=torch.float64)

    def cpu(t, timed=True):
        t = t.detach().cpu()
        if not (sign and timed):
            return t
        u = alt.to(t.dtype).view((-1,) + (1,) * (t.dim() - 1))
        return t * (1 + u * 2.0 ** -23)
    kw = {k: None if v is None else cpu(v, k != "scale")
          for k, v in kw.items()}
    return evaluate(cpu(pred), cpu(target), cpu(ps_raw), vset, grid, **kw)


def frame_compare(name, frames, witnesses):
    """Hold the card's scoreboard frame to the CPU's as ``witness_compare``
    holds a record: given ``frames`` by tag ("cuda", "cpu" and the tags in
    ``witnesses``), every entry (MAE, RMSE, R2, bias, and CRPS where the
    arm samples) on the card within 1e-4 of the CPU's plus 4x the largest
    witness movement; an entry that is not finite on the CPU (R2 where a
    target is constant) must be the same on the card. R2 divides by a
    target's sum of squares over the validation steps, which for a
    near-constant target is set by the last bits of the data and of the
    weighting, so the witnesses must move those too; an entry that a
    witness makes not finite is bounded by nothing, and is named. Returns
    a description of the comparison."""
    cuda, cpu = frames["cuda"], frames["cpu"]
    check(list(cuda.index) == list(cpu.index)
          and list(cuda.columns) == list(cpu.columns),
          f"{name}: the card's scoreboard has other rows or columns")
    c, p = cuda.to_numpy(float), cpu.to_numpy(float)
    fin = np.isfinite(p)
    with np.errstate(invalid="ignore"):       # inf - inf where not finite
        moves = [np.abs(frames[t].to_numpy(float) - p) for t in witnesses]
        diff = np.where(fin, np.abs(c - p), 0.0)
    # a witness that leaves an entry not finite bounds it by nothing
    move = np.where(fin, np.nan_to_num(np.max(moves, axis=0), nan=np.inf,
                                       posinf=np.inf), 0.0)
    tol = 1e-4 * np.abs(p) + 4 * move
    free = fin & np.isinf(tol)
    check(np.array_equal(c[~fin], p[~fin], equal_nan=True),
          f"{name}: non-finite scoreboard entries differ")
    bad = fin & ~(diff <= tol)
    where = lambda ij: f"{cpu.index[ij[0]]} {cpu.columns[ij[1]]}"
    check(not bad.any(), f"{name}: scoreboard entries outside tolerance: "
          + "; ".join(f"{where(ij)} card {float(c[ij])!r} vs CPU "
                      f"{float(p[ij])!r}, tolerance {float(tol[ij])!r}"
                      for ij in zip(*np.nonzero(bad))))
    ratio = np.where(fin & ~free, diff / np.maximum(tol, 1e-300), 0.0)
    ij = np.unravel_index(np.argmax(ratio), ratio.shape)
    return (f"scoreboard {int(fin.sum())} finite entries of "
            f"{'/'.join(cpu.columns)} within tolerance ({int((~fin).sum())} "
            f"not finite, equal; {int(free.sum())} made not finite by a "
            f"witness: " + (", ".join(where(ij) for ij in zip(
                *np.nonzero(free))) or "none")
            + f"), the closest {where(ij)}: card "
            f"{float(c[ij])!r} vs CPU {float(p[ij])!r}, tolerance "
            f"{tol[ij]:.3e}")


def compare_new_arm_small(card, grid, yaml, arm, over):
    """An arm small on the card and with device=cpu, the card's draws
    replayed to the CPU, and two CPU witnesses with the same draws: the
    initial weights x (1 + 1e-6), and the CPU run on the card's data,
    normalizer and labels (the data witness). Every epoch's losses held by
    ``witness_compare`` with the weight witness; no kernel launched on any
    run. For the arms that end in the scoreboard, every entry (CRPS of
    the samples included) is held by ``frame_compare`` twice: the card's
    model and sampler, as the card run's predictions, samples and targets
    scored on the CPU against the CPU run, with both witnesses; and the
    metric code on the card, as the card's own frame against that CPU
    scoring of the same inputs, with two rounding witnesses (every input
    x (1 +- (-1)^t 2^-23) at step t)."""
    from climsim_tpu_torch.cli.train_offline import SeededNoise
    base = [yaml, f"grid_path={grid}", "data.steps=6", "epochs=1"] + over
    log = NoiseLog()
    scored = []
    with scored_inputs(scored):
        runs = {"cuda": offline_run(base + ["device=cuda"], noise_source=(
            log.recorder(SeededNoise(0, "cuda"))))}
    runs["cpu"] = offline_run(base + ["device=cpu"],
                              noise_source=log.replayer())
    runs["witness"] = offline_run(base + ["device=cpu"], scale=1 + 1e-6,
                                  noise_source=log.replayer())
    runs["data"] = offline_run(base + ["device=cpu"],
                               noise_source=log.replayer(),
                               data=runs["cuda"].run)
    epochs = runs["cpu"].run.fc.epochs
    for tag, r in runs.items():
        check(r.rc == 0 and len(r.run.history) == epochs, f"{arm} small "
              f"{tag}: exit {r.rc}")
        check(not r.launches, f"{arm} small {tag} launched {r.launches}")
    keys = (("train_ce", "val_ce") if arm.startswith("classifier") else
            ("train_loss", "val_loss") if arm == "unet" else
            ("train_loss",))
    worst = witness_compare(f"{arm} small",
                            {t: r.run.history for t, r in runs.items()},
                            ["witness"], keys)
    if not arm.startswith("classifier"):
        frames = {t: r.run.scores for t, r in runs.items()}
        grid_cpu = runs["cpu"].run.grid
        frames["cuda"] = score_on_cpu(scored[-1], grid_cpu)
        worst.append("the card's samples scored on the CPU: " + frame_compare(
            f"{arm} small", frames, ["witness", "data"]))
        metric = {"cuda": runs["cuda"].run.scores, "cpu": frames["cuda"]}
        for sign in (1, -1):
            metric[sign] = score_on_cpu(scored[-1], grid_cpu, sign)
        worst.append("the metric on the card: " + frame_compare(
            f"{arm} small, the metric on the card", metric, [1, -1]))
    print(f"cli train_offline {arm} small ({epochs} epochs), card against "
          f"device=cpu ({len(log.draws)} draws replayed): "
          + "; ".join(worst) + f" [{card}]")


def check_ensemble_dryrun(card):
    """The dry run's fourth part (``dryrun_multichip.ensemble_step``) on a
    one-rank NCCL group, a (1, 1) (data, ensemble) mesh: the step of the
    4-member RPN (each member's averaged gradient, then its weights after
    the Adam step) must equal the single-device step bit for bit."""
    import torch.distributed as dist
    from climsim_tpu_torch.cli import dryrun_multichip
    from climsim_tpu_torch.parallel import init_distributed
    init_distributed()                       # one rank, NCCL, this card
    try:
        loss = dryrun_multichip.ensemble_step(1, 1, torch.device("cuda"),
                                              np.random.default_rng(0))
    finally:
        dist.destroy_process_group()
    print(f"dryrun_multichip ensemble-parallel part on a (1, 1) NCCL mesh: "
          f"loss={loss:.4f}, every member's gradient and step bit-equal to "
          f"the single-device step's [{card}]")


def check_offline_new_arms(card):
    """Phase 15: the offline CLI's stochastic and U-Net arms, through
    ``python -m climsim_tpu_torch.cli.train_offline``'s main on a
    384-column grid file: NEW_ARMS at their published widths
    (conf/mlp_v1.yaml's 10 epochs, 40 steps, batch 1536), each with no
    kernel of the port launched, its seconds an epoch, ms an update,
    samples/s, FLOP rate and peak; one more epoch of each stochastic arm
    and of the classifier through the CLI's own epoch under the profiler
    (idle share; the classifier's kernels and its update timed with and
    without the gradout statistics and clipping); one more U-Net epoch
    under the profiler (idle share) and its update's kernels (GEMMs, no
    FFT); the classifier's checkpoint, then ``init_from`` it for 1 epoch
    (its first train_ce below the cold start's); each arm small against
    device=cpu (NEW_ARMS_SMALL, the draws replayed, the scoreboards
    held); the dry run's ensemble step on a (1, 1) NCCL mesh.
    Each step's seconds are printed."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="offline_new", dir=root)
    mlp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                       "mlp_v1.yaml")
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"  phase 15: {what} took {now - last[0]:.1f} s")
        last[0] = now
    try:
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        ck = os.path.join(tmp, "ck")
        for label, over in NEW_ARMS.items():
            gc.collect()
            torch.cuda.empty_cache()
            extra = [f"checkpoint_dir={ck}"] \
                if label == "classifier_gradout" else []
            r = offline_run([mlp, f"grid_path={grid}"] + over + extra)
            new_arm_summary(label, r, card)
            if label in ("rpn", "hsr", "cvae", "classifier_gradout"):
                arm_epoch_profile(card, label, r,
                                  os.path.join(tmp, "trace.json"))
            if label == "unet":
                offline_epoch_profile("unet (v4)", r, card,
                                      os.path.join(tmp, "trace.json"))
                unet_kernels(card, r)
            if label == "classifier_gradout":
                cold = r.run.history[0]["train_ce"]
                w = offline_run([mlp, f"grid_path={grid}", "epochs=1",
                                 f"init_from={ck}"] + over)
                check(w.rc == 0 and any(ln.startswith("init_from: loaded")
                                        for ln in w.lines), "init_from")
                warm = w.run.history[0]["train_ce"]
                check(warm < cold, f"init_from: first train_ce {warm} not "
                      f"below the cold start's {cold}")
                print(f"cli train_offline classifier_gradout init_from the "
                      f"checkpoint, 1 epoch: "
                      f"{[ln for ln in w.lines if ln.startswith('init_from')]}"
                      f", first train_ce {warm!r} against the cold start's "
                      f"{cold!r} [{card}]")
            r = None
            lap(label)
        for arm, over in NEW_ARMS_SMALL.items():
            compare_new_arm_small(card, grid, mlp, arm, over)
        lap("each arm small, card against CPU")
        check_ensemble_dryrun(card)
        lap("the ensemble dry run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ phase 16

# the forwards' bf16-gate mode (pallas_acc32=False) in each fused arm: the
# arm of chip_smoke.ARMS, its kernel, and the model's other flags
G16_ARMS = {"v6": ("v6", "b1", {}), "v5": ("v5", "b4", {}),
            "v5_unhoisted": ("v5", "b4", {"pallas_hoist_proj": False}),
            "v2": ("v2", "b7", {}), "v3": ("v3", "b9", {}),
            "v4": ("v4", "b10", {})}
# the plain version of each fused layer's wrapper, by its name in
# models/cells.py
PLAIN_OF = {"fused_bigru_heads_init_cm": "bigru_heads_init_cm_reference",
            "fused_bigru_heads_cm": "bigru_heads_cm_reference",
            "fused_bigru_lbh": "bigru_reference_lbh",
            "fused_bigru_heads_lbh": "bigru_heads_lbh_reference",
            "fused_bigru_heads_init_lbh": "bigru_heads_init_lbh_reference"}
# the other options of RNNAutoreg (ROADMAP A.12), each at nneur 192/192,
# f32 (JAX's LayerNorm cells cannot run bf16); separate radiation takes 16
# level inputs and keeps its memory on the CRM's 50 bottom levels
A12_ARMS = {"lstm": dict(cell="lstm"), "ln_lstm": dict(cell="ln_lstm"),
            "sru": dict(cell="sru"), "qrnn": dict(cell="qrnn"),
            "separate_radiation": dict(separate_radiation=True),
            "memory_none": dict(use_memory=False)}
A12_STEPS, A12_NX_RAD, A12_L_CRM = 3, 16, 50


def _plain_of(name, acc32):
    """The plain version of the wrapper ``name`` in the gate mode
    ``acc32``, whatever mode its caller asks for."""
    from climsim_tpu_torch import ops
    ref = getattr(ops, PLAIN_OF[name])

    def call(*args, **kw):
        return ref(*args, **{**kw, "acc32": acc32})
    return call


@contextlib.contextmanager
def plain_kernels(acc32):
    """Inside, the fused layers run their kernels' plain versions on the
    card in the gate mode ``acc32`` (the wrappers' names in
    models/cells.py rebound): the plain coupled step."""
    from climsim_tpu_torch.models import cells
    old = {k: getattr(cells, k) for k in PLAIN_OF}
    try:
        for k in PLAIN_OF:
            setattr(cells, k, _plain_of(k, acc32))
        yield
    finally:
        for k, f in old.items():
            setattr(cells, k, f)


def step_fields(out) -> dict:
    """A rollout's (state, mem, diagnostics) as one flat dict, float32."""
    st, mem, diags = out
    return {**{f"state.{k}": v for k, v in st.items()}, "mem": mem,
            **{f"diag.{k}": v for k, v in diags.items()}}


def steps_in_turns(old, new, steps, repeats=REPEATS):
    """Host ms a coupled step of two rollouts of ``steps`` steps, in turns
    (old, new, new, old), each synchronized: ([old, old], [new, new])."""
    t = {old: [], new: []}
    for fn in (old, new, new, old):
        t[fn].append(median_ms(fn, 1, repeats=repeats, queue_ahead=False)
                     / steps)
    return t[old], t[new]


def g16_arm(card, name, res):
    """One fused arm with pallas_acc32=False at 21,600 columns: one coupled
    step with every counter at 0 (its kernel launched once, in the
    bf16-gate design), held field by field to the same step with the plain
    bf16-gate version on the card by g16_ok (against the plain step with
    float32 gates); the v6 step also timed in turns with the acc32=True
    model on the same weights."""
    from climsim_tpu_torch.models import BF16
    arm, kernel, over = G16_ARMS[name]
    ncol, dev = NLAT * NLON, torch.device("cuda")
    mt = make_model(BF16, None, arm=arm, **over)
    mf = make_model(BF16, None, arm=arm, pallas_acc32=False, **over)
    mf.load_state_dict(mt.state_dict())
    grid = ProxyGrid(NLAT, NLON, NLEV, dev)
    lt, lf = (make_loop(m, grid, NLAT, NLON, None, arm) for m in (mt, mf))
    inputs = initial_state(ncol, NLEV, dev, mf.level_major)
    wrapper = all_wrappers()[kernel]
    wrapper.design = None
    got, launches = counted(lambda: lf.rollout(*inputs, 1))
    design = wrapper.design
    want = dict(ARMS[arm][2])
    print(f"bf16 gates, arm {name}: one coupled step at {ncol} columns, "
          f"launches {launches}, {kernel.upper()} design {design} [{card}]")
    check(launches == want, f"bf16 gates {name}: launches {launches}, "
          f"want {want}")
    check(design == "tensor_core+bf16_gates", f"bf16 gates {name}: "
          f"{kernel.upper()} ran {design}")
    with plain_kernels(False):
        plain, pl_launches = counted(lambda: lf.rollout(*inputs, 1))
    with plain_kernels(True):
        plain32 = lf.rollout(*inputs, 1)
    check(kernel not in pl_launches, f"the plain step launched {kernel}")
    got, plain, plain32 = (step_fields(o) for o in (got, plain, plain32))
    worst, moved = 0.0, 0
    for key, w in plain.items():
        g = got[key]
        check(bool(torch.isfinite(g.float()).all()),
              f"bf16 gates {name}: {key}")
        ok, ratio, err, sep = g16_ok(g, w, plain32[key])
        check(ok, f"bf16 gates {name} {key}: kernel vs plain bf16 gates "
              f"{err:.3e}, mean distance {ratio:.3f} of the modes'")
        worst, moved = max(worst, ratio), moved + sep
    check(moved > 0, f"bf16 gates {name}: no field tells the modes apart")
    print(f"bf16 gates, arm {name}: the step against the plain bf16-gate "
          f"step on the card: in each of the {moved} fields the modes "
          f"change, the mean distance is at most {worst:.4f} of the "
          f"modes' own (tolerance 0.5, and nearer the bf16 gates than the "
          f"float32 ones) [{card}]")
    res.setdefault("launches", {})[kernel] = launches[kernel]
    if name == "v6":
        old, new = steps_in_turns(lambda: lt.rollout(*inputs, 5),
                                  lambda: lf.rollout(*inputs, 5), 5)
        print(f"coupled step, {ncol} columns, arm v6 in turns (f32 gates, "
              f"bf16 gates, bf16 gates, f32 gates): f32 gates {old[0]:.4f} "
              f"/ {old[1]:.4f} ms, bf16 gates {new[0]:.4f} / {new[1]:.4f} "
              f"ms [{card}]")
        res["v6_step"] = (old, new)
    return mf


def g16_kernel(card, kind, model, res, hoist=True):
    """One kernel at the flagship bf16 shapes (21,600 columns): its
    bf16-gate launch against its plain bf16-gate version on the card
    (g16_ok, against the plain float32-gate version on the same inputs),
    then timed in turns with its float32-gate mode and its plain version
    timed."""
    from climsim_tpu_torch import ops
    ncol, bf = NLAT * NLON, torch.bfloat16
    kern, plain, a = {
        "b1": (ops.fused_bigru_heads_init_cm,
               ops.bigru_heads_init_cm_reference, lambda: b1_args(
                   model, ncol, bf, seed=7)),
        "b4": (ops.fused_bigru_heads_cm, ops.bigru_heads_cm_reference,
               lambda: b4_args(model, ncol, bf, seed=23)),
        "b7": (ops.fused_bigru_lbh, ops.bigru_reference_lbh,
               lambda: b7_args(model, ncol, bf, seed=29, L=NLEV)),
        "b9": (ops.fused_bigru_heads_lbh, ops.bigru_heads_lbh_reference,
               lambda: b9_args(model, ncol, bf, seed=31)),
        "b10": (ops.fused_bigru_heads_init_lbh,
                ops.bigru_heads_init_lbh_reference,
                lambda: b10_args(model, ncol, bf, seed=37))}[kind]
    a = a()
    kw = {} if hoist else {"hoist_proj": False}
    label = kind.upper() + ("" if hoist else " (hoist_proj=False)")
    got = kern(*a, acc32=False, **kw)
    tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    with expf_lanes(res["expf_table"], tally):
        want = plain(*a, acc32=False, **kw)
    sent, lanes = (int(t) for t in tally)
    want32 = plain(*a, acc32=True, **kw)
    errs, ratios = [], []
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        ok, ratio, err, sep = g16_ok(g, w, w32)
        check(ok and sep, f"{label} bf16 gates output {i}: {err:.3e}, mean "
              f"distance {ratio:.3f} of the modes'")
        errs.append(err)
        ratios.append(ratio)
    del got, want, want32
    old, new = in_turns(lambda: kern(*a, **kw),
                        lambda: kern(*a, acc32=False, **kw), 3)
    plain_ms = median_ms(lambda: plain(*a, acc32=False, **kw), 1,
                         repeats=1)
    print(f"{label} bf16 at {ncol} columns against its plain bf16-gate "
          f"version: max_abs_err {max(errs):.3e}, mean distance "
          f"{max(ratios):.4f} of the modes' (tolerance 0.5); in turns "
          f"(f32 gates, "
          f"bf16 gates, bf16 gates, f32 gates): f32 gates {old[0]:.4f} / "
          f"{old[1]:.4f} ms, bf16 gates {new[0]:.4f} / {new[1]:.4f} ms "
          f"({statistics.mean(new) / statistics.mean(old):.3f}x); plain "
          f"bf16-gate version {plain_ms:.4f} ms; the tie rule sends "
          f"{sent:,} of the plain version's {lanes:,} typed-sigmoid inputs "
          f"to expf ({sent / max(lanes, 1):.2e}) [{card}]")
    key = kind if hoist else "b4_unhoisted"
    res.setdefault("kernels", {})[key] = dict(
        max_abs_err=max(errs), ms=statistics.mean(new),
        f32_gates_ms=statistics.mean(old), plain_ms=plain_ms,
        expf_share=sent / max(lanes, 1))


def g16_grads(card, model16, model32):
    """One update's gradients of the v6 model at 2,700 columns under
    pallas_acc32=False and True, on the same weights, inputs and output
    cotangents: B3 linearises the float32-gate forward from the saved
    inputs in both modes, so the gradient of every parameter of the fused
    layer and of the layers before it is the same bits. The surface head
    ``mlp_surface_output`` reads the kernel's last state, which the modes
    compute differently, so its gradient differs (printed)."""
    dev, B = torch.device("cuda"), NLAT * NLON // 8
    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((NLEV, 6, B), generator=g, device=dev)
    xs = torch.randn((B, 24), generator=g, device=dev)
    mem = 0.5 * torch.randn((NLEV, 16, B), generator=g, device=dev)
    grads = []
    with torch.enable_grad():
        for m in (model32, model16):
            m.zero_grad(set_to_none=True)
            outs, launches = counted(lambda: m(x, xs, mem))
            cg = torch.Generator(device=dev).manual_seed(43)
            cts = [torch.randn(o.shape, generator=cg, device=dev).to(o.dtype)
                   for o in outs]
            _, bl = counted(lambda: torch.autograd.backward(outs, cts))
            check(launches == {"b1": 1} and bl == {"b3": 1},
                  f"v6 update launches {launches}, {bl}")
            grads.append({k: p.grad.clone() for k, p in
                          m.named_parameters() if p.grad is not None})
    check(set(grads[0]) == set(grads[1]) and len(grads[0]) > 0,
          "the two modes' gradients cover different parameters")
    head = [k for k in grads[0] if k.startswith("mlp_surface_output.")]
    rest = [k for k in grads[0] if k not in head]
    same = [k for k in rest if torch.equal(grads[0][k], grads[1][k])]
    moved = max(rel_err(grads[1][k], grads[0][k]) for k in head)
    print(f"v6 update at {B} columns: {len(same)} of the {len(rest)} "
          f"gradients of the fused layer and the layers before it under "
          f"pallas_acc32=False equal those under True, bit for bit; the "
          f"surface head's ({len(head)}, on the kernel's last state) moved "
          f"by {moved:.3e} of scale (B1 1, B3 1 launch each) [{card}]")
    check(len(same) == len(rest), "v6 gradients differ between the gate "
          f"modes: {sorted(set(rest) - set(same))}")


def g16_export(card):
    """A v4 OnlineWrapper at the GRU yaml's widths over a pallas_acc32=False
    bf16 model, exported at 384 columns: its graph's climsim:: node carries
    acc32=False, and the program loaded in this process launches the
    bf16-gate B10 once and gives the eager wrapper's bits."""
    from climsim_tpu_torch.export import export_wrapper, load_step
    from climsim_tpu_torch.ops import fused_bigru_heads_init_lbh, library
    norm = export_norm()
    w = export_wrapper_of("v4", norm, pallas_acc32=False)
    ncol = LO_NLAT * LO_NLON
    x, xs, mem = raw_state(ncol, seed=ncol)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="export16", dir=root)
    try:
        path = os.path.join(tmp, "v4_bf16_gates.pt2")
        export_wrapper(w, ncol, NLEV, EXPORT_NX, EXPORT_NX_SFC, EXPORT_NM,
                       path)
        program = torch.export.load(path)
        nodes = [n for n in program.graph.nodes if str(n.target) in
                 library.exported_ops(program.graph)]
        check(len(nodes) == 1 and nodes[0].args[0] is False,
              f"the exported node's gate mode: "
              f"{[(str(n.target), n.args[0]) for n in nodes]}")
        step = load_step(path)
        fused_bigru_heads_init_lbh.design = None
        got, launches = counted(lambda: step(x, xs, mem))
        design = fused_bigru_heads_init_lbh.design
        eager = w(x, xs, mem)
        same = all(torch.equal(a, b) for a, b in zip(got, eager))
        print(f"export of a pallas_acc32=False v4 wrapper at {ncol} columns: "
              f"node {nodes[0].target} with acc32={nodes[0].args[0]}; the "
              f"loaded program launched {launches} ({design}); "
              f"{'bit-equal to' if same else 'DIFFERS FROM'} the eager "
              f"wrapper [{card}]")
        check(launches == {"b10": 1} and design == "tensor_core+bf16_gates",
              f"the loaded program launched {launches}, {design}")
        check(same, "the loaded program differs from the eager wrapper")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def a12_model(flags, device, seed=0):
    from climsim_tpu_torch.models import F32, RNNAutoreg
    nx = A12_NX_RAD if flags.get("separate_radiation") else 6
    return RNNAutoreg(nx=nx, nx_sfc=24, ny=6, ny_sfc=8, nneur=(192, 192),
                      nh_mem=16, add_pres=False, policy=F32, device=device,
                      seed=seed, **flags)


def a12_loop(model, grid, nlat, nlon, device):
    """The coupled step around an A.12 model, batch-major, with the
    production transport (B2 and both fixers). Separate radiation reads
    16 level inputs: the six fields and ten fixed profiles (its gases are
    channels 12-14), which the loop's feature hook makes from the state."""
    from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
    dev = next(model.parameters()).device
    cfg = HostLoopConfig(nlat=nlat, nlon=nlon, scheme="fv",
                         geometry="sphere", use_pallas=True, fix_water=True,
                         fix_energy=True, emulator_level_major=False)
    xsc = torch.tensor(XSCALE, device=dev)
    ysc = torch.tensor(YSCALE, device=dev)
    sepr = model.separate_radiation

    def features(state, x_sfc):
        six = torch.stack([state[k] for k in ("T", "qv", "qc", "qi", "u",
                                              "v")], dim=-1)
        ncol, L = six.shape[:2]
        lev = torch.linspace(0.0, 1.0, L, device=six.device)
        extra = torch.stack([lev * (c + 1) / 10 for c in range(10)], -1)
        return torch.cat([six, extra.expand(ncol, L, 10)], -1), x_sfc

    def emulator(x_main_raw, x_sfc_raw, mem):
        x = torch.cat([x_main_raw[..., :6] / xsc, x_main_raw[..., 6:]], -1)
        out, out_sfc, mem = model(x, x_sfc_raw, mem)
        return out * ysc, out_sfc, mem

    return HybridLoop(emulator, grid, cfg,
                      feature_builder=features if sepr else None,
                      device=device)


def a12_inputs(model, ncol, device):
    state, mem, x_sfc = initial_state(ncol, NLEV, device, False)
    if model.separate_radiation:
        mem = torch.zeros((ncol, A12_L_CRM, 16), device=device)
    return state, mem, x_sfc


def a12_arm(card, name):
    """One A.12 option at 21,600 columns: A12_STEPS coupled steps, every
    counter at 0 (no emulator kernel: the transport's B2 once a step, as
    JAX's scan runs no kernel), finite, then their ms a step (the median of
    REPEATS synchronized runs); then 2 steps at 384 columns on the
    card against device="cpu" by the file's witness rule: each field
    within 1e-5 of its scale plus 4x the CPU's own movement when every
    weight is scaled by 1 + 1e-6."""
    from climsim_tpu_torch import Grid
    flags = A12_ARMS[name]
    ncol, dev = NLAT * NLON, torch.device("cuda")
    model = a12_model(flags, None)
    loop = a12_loop(model, ProxyGrid(NLAT, NLON, NLEV, dev), NLAT, NLON,
                    None)
    inputs = a12_inputs(model, ncol, dev)
    t0 = time.perf_counter()
    out, launches = counted(lambda: loop.rollout(*inputs, A12_STEPS))
    wall = time.perf_counter() - t0
    check(launches == {"b2": A12_STEPS}, f"A.12 {name}: launches "
          f"{launches}")
    fields = step_fields(out)
    for k, v in fields.items():
        check(bool(torch.isfinite(v).all()), f"A.12 {name}: {k}")
    ms = median_ms(lambda: loop.rollout(*inputs, A12_STEPS), 1,
                   repeats=REPEATS, queue_ahead=False) / A12_STEPS
    print(f"A.12 arm {name} ({model.arm} trunk, nneur 192/192, f32): "
          f"{A12_STEPS} coupled steps at {ncol} columns in {wall:.3f} s "
          f"(first run), then {ms:.4f} ms a step, launches {launches}, "
          f"mean_T {out[2]['mean_T'][-1].item():.4f} K [{card}]")
    lo = LO_NLAT * LO_NLON
    res = {}
    for key, device, bump in (("card", "cuda", 1.0), ("cpu", "cpu", 1.0),
                              ("witness", "cpu", 1.0 + 1e-6)):
        m = a12_model(flags, device)
        if bump != 1.0:
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(bump)
        lp = a12_loop(m, Grid.synthetic(lo, NLEV, device=device), LO_NLAT,
                      LO_NLON, device)
        res[key] = {k: v.float().cpu() for k, v in step_fields(
            lp.rollout(*a12_inputs(m, lo, device), 2)).items()}
    worst = 0.0
    for k, want in res["cpu"].items():
        got = res["card"][k]
        wit = (res["witness"][k] - want).abs().max().item()
        err = (got - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item() + 4.0 * wit
        check(err <= tol, f"A.12 {name} 384 {k}: card vs CPU {err:.3e} > "
              f"{tol:.3e}")
        worst = max(worst, err / max(tol, 1e-30))
    print(f"A.12 arm {name}, 384 columns, 2 steps: card vs CPU within "
          f"{worst:.3f} of the witness tolerance [{card}]")


def a12_cli(card):
    """The training CLI on conf/autoreg_gru.yaml with model.cell=lstm and
    with model.memory=None: one epoch each on a 384-column grid file at
    the yaml's widths, finite records, no kernel launched (the scan
    trunk)."""
    from climsim_tpu_torch.models import RNNAutoreg
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_cli16", dir=root)
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf")
    try:
        grid = os.path.join(tmp, "grid.nc")
        write_grid_file(grid, LO_NLAT * LO_NLON)
        for over in (["model.cell=lstm"], ["model.memory=None"]):
            args = [os.path.join(conf, "autoreg_gru.yaml"),
                    f"grid_path={grid}", f"data.ncol={LO_NLAT * LO_NLON}",
                    "epochs=1", "data.steps=12"] + over
            r = train_cli_run(args, RNNAutoreg)
            cli_summary(f"GRU yaml with {over[0]}", r, LO_NLAT * LO_NLON,
                        card)
            check_cli_records(f"GRU yaml {over[0]}", r, [1])
            check(r.run.trainer.model.arm == "scan", r.run.trainer.model.arm)
            check(r.launches == {}, f"{over[0]} launched {r.launches}")
            r = None
            gc.collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the bf16-gate step's card checks (ops/gates16.py): operand sets of the
# step, and the special values among them
G16_STEP_SETS = 10_000_000
G16_SPECIALS = (0.0, -0.0, 1.0, -1.0, 2.0 ** -133, -2.0 ** -133,
                2.0 ** -126, 1.0 + 2.0 ** -7, 1.0 - 2.0 ** -8, 2.0 ** -9,
                44.0, -44.0, 88.0, -88.0, 1e30, -1e30)
# gates16.cuh's bound on the SFU exponential, in float32 ulps: 2.5 +
# 1.223 S |x| (ex2.approx, then the rounded argument)
G16_EX2_ULPS, G16_ARG_ULPS = 2.5, 1.223


def g16_operands(n, seed):
    """n seeded operand sets of the bf16-gate step on the card (sums [n, 6]
    float32, bf [n, 4] bf16 bits as int16; ops/gates16.py::check_step):
    each value of order 2^-12 to 2^4 (80%), a random finite bf16 bit
    pattern (10%) or one of G16_SPECIALS (10%)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sp = torch.tensor(G16_SPECIALS, device=dev)

    def mix(shape):
        scale = torch.exp2(torch.randint(-12, 5, shape, generator=g,
                                         device=dev).float())
        v = torch.randn(shape, generator=g, device=dev) * scale
        b = torch.randint(-32768, 32768, shape, generator=g, device=dev,
                          dtype=torch.int32).to(torch.int16)
        b = b.view(torch.bfloat16).float()
        b = torch.where(torch.isfinite(b), b, torch.zeros_like(b))
        pick = sp[torch.randint(0, sp.numel(), shape, generator=g,
                                device=dev)]
        u = torch.rand(shape, generator=g, device=dev)
        return torch.where(u < 0.8, v, torch.where(u < 0.9, b, pick))
    sums = mix((n, 6)).contiguous()
    bf = mix((n, 4)).to(torch.bfloat16).view(torch.int16).contiguous()
    return sums, bf


def check_gate_step(card) -> torch.Tensor:
    """The bf16-gate step of ops/csrc/gates16.cuh against the accurate
    forms it replaced (every operation in f32, then rounded; IEEE expf and
    division): the sigmoid and the typed tanh on all 65,536 bf16 inputs
    (0 mismatches; NaNs match any NaN), the SFU exponential's error within
    gates16.cuh's bound wherever exp(-S x) is a normal float32, the tie
    rule's expf inputs counted; then the step on G16_STEP_SETS seeded
    operand sets (0 mismatches). Returns the tie rule's table: for each
    bf16 bit pattern, whether the sigmoid's exponential takes expf."""
    from climsim_tpu_torch.ops import gates16
    x = gates16.all_bf16()
    out, slow, ulps = gates16.check_unary(x)
    bad_s = int((~gates16.same_bits(out[:, 0], out[:, 1])).sum())
    bad_t = int((~gates16.same_bits(out[:, 2], out[:, 3])).sum())
    xv = x.view(torch.bfloat16).float().abs()
    worst, sent = [], []
    for S in (1, 2):
        e, normal = ulps[:, S - 1], ulps[:, S - 1] >= 0
        worst.append((e[normal] / (G16_EX2_ULPS + G16_ARG_ULPS * S
                                   * xv[normal])).max().item())
        sent.append((int(slow[normal, S - 1].sum()), int(normal.sum()),
                     int(slow[:, S - 1].sum())))
    print(f"bf16-gate step, all 65,536 bf16 inputs against the accurate "
          f"forms: sigmoid {bad_s} mismatches, typed tanh {bad_t}; "
          f"the SFU exponential at most {worst[0]:.3f} (sigmoid) and "
          f"{worst[1]:.3f} (tanh) of gates16.cuh's bound 2.5 + 1.223 S |x| "
          f"ulps; the tie rule sends {sent[0][0]} of {sent[0][1]} inputs "
          f"with a normal exp(-x) to expf (sigmoid; {sent[0][2]} of all "
          f"65,536) and {sent[1][0]} of {sent[1][1]} (tanh; {sent[1][2]}) "
          f"[{card}]")
    check(bad_s == 0 and bad_t == 0, f"the bf16-gate sigmoid / tanh differ "
          f"from the accurate forms on {bad_s} / {bad_t} inputs")
    check(max(worst) <= 1.0, f"the SFU exponential exceeds gates16.cuh's "
          f"bound: {worst}")
    sums, bf = g16_operands(G16_STEP_SETS, seed=24)
    st = gates16.check_step(sums, bf)
    bad = int((~gates16.same_bits(st[:, 0], st[:, 1])).sum())
    moved = int((st[:, 1] != bf[:, 3]).sum())
    print(f"bf16-gate step on {G16_STEP_SETS:,} seeded operand sets "
          f"(pairs as the kernels pack them) against the accurate step: "
          f"{bad} mismatches ({moved:,} states moved) [{card}]")
    check(bad == 0, f"the bf16-gate step differs from the accurate one on "
          f"{bad} operand sets")
    table = torch.zeros(65536, dtype=torch.bool, device=x.device)
    table[x.long() & 0xFFFF] = slow[:, 0].bool()
    del sums, bf, st
    return table


@contextlib.contextmanager
def expf_lanes(table, tally):
    """Inside, the plain bf16-gate versions count, in ``tally`` (a
    [2] int64 tensor on the card: the exponentials whose bf16 input the
    tie rule sends to expf, and all of them), the inputs of every typed
    sigmoid they take (ops/pallas_rnn.py::_sigmoid_typed, which the typed
    tanh reaches with 2x)."""
    from climsim_tpu_torch.ops import pallas_rnn
    typed = pallas_rnn._sigmoid_typed

    def counted(x):
        if x.dtype == torch.bfloat16:
            tally[0] += table[x.view(torch.int16).long() & 0xFFFF].sum()
            tally[1] += x.numel()
        return typed(x)
    pallas_rnn._sigmoid_typed = counted
    try:
        yield
    finally:
        pallas_rnn._sigmoid_typed = typed


def f32_yardsticks(card, models) -> dict:
    """The library yardsticks of the f32 instances of B1, B4, B9, B10 (the
    forwards) and B3 (autograd's backward through B4's) at 21,600 columns:
    cuDNN's f32 GRU pair with TF32 off (main turns it off for the whole
    run), since the f32 policy rules it out and cuDNN's RNN takes it by
    default. Returns {kind: ms}."""
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    ncol, f32 = NLAT * NLON, torch.float32
    v6, v5, v3, v4 = (models[k] for k in ("v6", "v5", "v3", "v4"))
    out = {
        "b1": heads_yardstick(v6.bigru_fused, b1_args(v6, ncol, f32, 7),
                              True, card, "B1 f32 (v6 arm's shapes)",
                              init=True),
        "b4": heads_yardstick(v5.bigru_fused, b4_args(v5, ncol, f32, 23),
                              True, card, "B4 f32 (v5 arm's shapes)"),
        "b9": heads_yardstick(v3.bigru_fused, b9_args(v3, ncol, f32, 31),
                              False, card, "B9 f32 (v3 arm's shapes)"),
        "b10": heads_yardstick(v4.bigru_fused, b10_args(v4, ncol, f32, 37),
                               False, card, "B10 f32 (v4 arm's shapes)",
                               init=True),
        "b3": heads_yardstick(v6.bigru_fused, b3_args(v6, ncol, f32, 11)[0],
                              True, card, "B3 f32 (v6 arm's shapes)",
                              backward=True)}
    print("library yardsticks, f32 at 21600 columns (cuDNN FMA math, TF32 "
          "off): " + ", ".join(f"{k.upper()} {v:.4f} ms"
                               for k, v in out.items()) + f" [{card}]")
    return out


def check_gate_mode_and_a12(card) -> dict:
    """Phase 16: the forwards' bf16-gate mode in every fused arm and each
    kernel alone, the v6 update's gradients in both modes, the export with
    the mode; the yardsticks of B1, B3 and B10; RNNAutoreg's other options
    at full width and at 384 columns against the CPU, and two of them
    through the training CLI. Returns the measurements for the kernels
    line."""
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.ops import bigru_heads_cm_bwd
    res = {"expf_table": check_gate_step(card)}
    models = {}
    for name in G16_ARMS:
        models[name] = g16_arm(card, name, res)
        gc.collect()
    for kind, name in (("b1", "v6"), ("b4", "v5"), ("b7", "v2"),
                       ("b9", "v3"), ("b10", "v4")):
        g16_kernel(card, kind, models[name], res)
    g16_kernel(card, "b4", models["v5"], res, hoist=False)
    m32 = make_model(BF16, None, arm="v6")
    m32.load_state_dict(models["v6"].state_dict())
    g16_grads(card, models["v6"], m32)
    g16_export(card)
    ncol, bf = NLAT * NLON, torch.bfloat16
    v6, v4 = models["v6"], models["v4"]
    a1 = b1_args(v6, ncol, bf, seed=7)
    res["library_b1"] = heads_yardstick(v6.bigru_fused, a1, True, card,
                                        "B1 (v6 arm's shapes)", init=True)
    a10 = b10_args(v4, ncol, bf, seed=37)
    res["library_b10"] = heads_yardstick(v4.bigru_fused, a10, False, card,
                                         "B10 (v4 arm's shapes)", init=True)
    a3 = b3_args(v6, ncol, bf, seed=11)
    res["library_b3"] = heads_yardstick(v6.bigru_fused, a3[0], True, card,
                                        "B3 (v6 arm's shapes)",
                                        backward=True)
    b3_ms = median_ms(lambda: bigru_heads_cm_bwd(*a3), 2)
    print(f"library yardstick: B1 bf16 at {ncol} columns, cuDNN pair + "
          f"initial MLP + 2 Linear {res['library_b1']:.4f} ms; B10 "
          f"{res['library_b10']:.4f} ms; B3 {b3_ms:.4f} ms against "
          f"autograd's backward through the pair + 2 Linear "
          f"{res['library_b3']:.4f} ms [{card}]")
    for kind in ("b1", "b10"):
        m = res["kernels"][kind]
        lib = res[f"library_{kind}"]
        print(f"{kind.upper()} bf16 gates at {ncol} columns: "
              f"{m['ms']:.4f} ms, {m['ms'] / m['f32_gates_ms']:.3f}x its "
              f"f32-gate mode in turns ({m['f32_gates_ms']:.4f} ms), "
              f"{m['ms'] / lib:.3f}x its library yardstick ({lib:.4f} ms) "
              f"[{card}]")
    del a1, a10, a3
    gc.collect()
    torch.cuda.empty_cache()
    res["library_f32"] = f32_yardsticks(card, models)
    del models, v6, v4, m32
    gc.collect()
    torch.cuda.empty_cache()
    for name in A12_ARMS:
        a12_arm(card, name)
    a12_cli(card)
    return res


# ------------------------------- an earlier checkout's B1 and B10, in turns

# the kernels of GATE_LIBS by kind: library, arm, arguments and their seed
PREVIOUS = {"b1": ("bigru_heads_init_cm", "v6", b1_args, 7),
            "b10": ("bigru_heads_lbh", "v4", b10_args, 37)}


def build_previous(root) -> dict:
    """GATE_LIBS from an earlier checkout's sources (``root`` its top
    directory), built as _build builds them into build/previous/; returns
    {name: (CDLL, library path)}."""
    from climsim_tpu_torch.ops import _build
    src = os.path.join(root, "climsim_tpu_torch", "ops", "csrc")
    out = os.path.join(os.path.dirname(str(_build.BUILD_DIR)), "previous")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in GATE_LIBS:
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"the earlier {name}.cu: {log}")
        libs[name] = ctypes.CDLL(lib), lib
    return libs


@contextlib.contextmanager
def previous_libs(libs):
    """Inside, the wrappers launch the earlier build's kernels."""
    from climsim_tpu_torch.ops import _build
    saved = {n: _build._libs.get(n) for n in libs}
    _build._libs.update({n: lib for n, (lib, _) in libs.items()})
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _build._libs.pop(n, None)
            else:
                _build._libs[n] = lib


def previous_in_turns(card, root) -> None:
    """B1 and B10 against the same kernels built from an earlier checkout
    (``root``), on the card: the SASS of both builds (the f32-gate
    instances' F32_GATE_SASS values, the bf16-gate step's counts); at
    21,600 and 1,000 columns, both gate modes' outputs bit-equal to the
    earlier build's; at 21,600 columns the bf16-gate mode timed in turns
    with the earlier build's and with the f32-gate mode, beside the
    library yardstick."""
    from climsim_tpu_torch import ops
    from climsim_tpu_torch.ops import _build
    from climsim_tpu_torch.models import BF16
    libs = build_previous(root)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(tool):
        for name, (_, path) in libs.items():
            for when, lib in (("earlier", path), ("this", _build._lib_path(
                    name))):
                g16, f32 = gate_sass(sass_functions(tool, lib))
                print(f"{name}, {when} build: f32-gate instances {f32}; "
                      f"bf16-gate instances " + "; ".join(
                          f"{k[-48:]} {c}" for k, c in g16.items())
                      + f" [{card}]")
    wrappers = {"b1": ops.fused_bigru_heads_init_cm,
                "b10": ops.fused_bigru_heads_init_lbh}
    for kind, (name, arm, args, seed) in PREVIOUS.items():
        kern = wrappers[kind]
        model = make_model(BF16, None, arm=arm)
        for B in (1000, NLAT * NLON):
            a = args(model, B, torch.bfloat16, seed)
            a32 = tuple(t.float() for t in a)
            new = [kern(*a, acc32=False), kern(*a), kern(*a32)]
            with previous_libs(libs):
                old = [kern(*a, acc32=False), kern(*a), kern(*a32)]
            same = [all(torch.equal(x, y) for x, y in zip(n, o))
                    for n, o in zip(new, old)]
            print(f"{kind.upper()} at {B} columns against the earlier "
                  f"build: bf16 gates {'bit-equal' if same[0] else 'DIFFER'}"
                  f", f32 gates {'bit-equal' if same[1] else 'DIFFER'}, "
                  f"f32 {'bit-equal' if same[2] else 'DIFFER'} [{card}]")
            check(all(same), f"{kind.upper()} at {B} columns differs from "
                  f"the earlier build: {same}")
            del new, old
        kern.design = None
        kern(*a, acc32=False)
        check(kern.design == "tensor_core+bf16_gates", f"{kind}: "
              f"{kern.design}")

        def earlier():
            with previous_libs(libs):
                kern(*a, acc32=False)
        prev, now = in_turns(earlier, lambda: kern(*a, acc32=False), 3)
        f32g, now2 = in_turns(lambda: kern(*a), lambda: kern(*a, acc32=False),
                              3)
        lib = heads_yardstick(model.bigru_fused, a, kind == "b1", card,
                              f"{kind.upper()} ({arm} arm's shapes)",
                              init=True)
        print(f"{kind.upper()} bf16 gates at {NLAT * NLON} columns in turns "
              f"(earlier, this, this, earlier): earlier build "
              f"{prev[0]:.4f} / {prev[1]:.4f} ms, this build {now[0]:.4f} / "
              f"{now[1]:.4f} ms "
              f"({statistics.mean(now) / statistics.mean(prev):.3f}x); "
              f"in turns with f32 gates: f32 gates {f32g[0]:.4f} / "
              f"{f32g[1]:.4f} ms, bf16 gates {now2[0]:.4f} / {now2[1]:.4f} "
              f"ms ({statistics.mean(now2) / statistics.mean(f32g):.3f}x); "
              f"library yardstick {lib:.4f} ms [{card}]")
        del a, a32, model
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------ phase 17: A.11's options, A.7

# conf/autoreg_physrnn.yaml's model with each option of ROADMAP A.11, at
# the yaml's widths: arms 1, 2 and 6 on the yaml as written (physical
# radiation, McICA, qv variability, the scan trunk) plus their option, 3-5
# without physical radiation (the ML radiation heads; the separate
# radiation BiGRU); 10,800 columns, the widest at which the yaml's W 3
# update fits 80 GB (PERF.md §4)
PHYS17_ARMS = {
    "use_tc": dict(use_tc=True),
    "learned_cloud_optics": dict(learned_cloud_optics=True),
    "ml_radiation_fused": dict(use_physrad=False, use_pallas=True),
    "separate_radiation_scan": dict(use_physrad=False,
                                    separate_radiation=True),
    "separate_radiation_fused": dict(use_physrad=False,
                                     separate_radiation=True,
                                     use_pallas=True),
    "bf16_fused": dict(policy="bf16", use_pallas=True),
}
PHYS17_NCOL = NLAT * NLON // 2
# the semi-online update of the v4 arm (bf16, W 3, remat): per window step
# B10 forward and in the remat recompute, B7 and B8 in its backward
SEMI_W, SEMI_LAUNCHES = 3, {"b10": 2, "b7": 1, "b8": 1}


def phys17_step_launches(model, train: bool) -> dict:
    """The kernels of one model step of a physics option arm (and of its
    backward with ``train``): the fused trunk B7 (B8); with physical
    radiation B12 (B14) and, but with TripleClouds, whose SW is the plain
    adding_sw_tc, B11 (B13)."""
    keys = []
    if model.use_pallas:
        keys += ["b7"] + (["b8"] if train else [])
    if model.use_physrad:
        keys += ["b12"] + (["b14"] if train else [])
        if not model.use_tc:
            keys += ["b11"] + (["b13"] if train else [])
    return {k: 1 for k in keys}


class _Captured:
    """A kernel wrapper that keeps the inputs, keyword arguments and
    outputs of its first call (detached copies) and forwards every
    attribute to the wrapper, so that its launch counter and design
    record stay the wrapper's own."""

    def __init__(self, fn, store, kind):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_store", store)
        object.__setattr__(self, "_kind", kind)

    def __call__(self, *args, **kw):
        out = self._fn(*args, **kw)
        if self._kind not in self._store:
            copy = lambda x: [copy(y) for y in x] \
                if isinstance(x, (list, tuple)) else (
                    x.detach().clone() if torch.is_tensor(x) else x)
            self._store[self._kind] = (copy(args), dict(kw), copy(out))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def captured_launches():
    """Inside, the first call of every kernel wrapper on the physics and
    v4 training paths is kept (kind -> (args, kwargs, outputs)): the
    names the models and autograd functions call are rebound."""
    from climsim_tpu_torch.models import cells, phys_rad
    from climsim_tpu_torch.ops import pallas_radiation, pallas_rnn
    store = {}
    targets = [("b7", cells, "fused_bigru_lbh"),
               ("b7", pallas_rnn, "fused_bigru_lbh"),
               ("b8", pallas_rnn, "bigru_bwd_lbh"),
               ("b10", cells, "fused_bigru_heads_init_lbh"),
               ("b11", phys_rad, "adding_sw_fast"),
               ("b12", phys_rad, "lw_solver_noscat_fast"),
               ("b13", pallas_radiation, "adding_sw_bwd"),
               ("b14", pallas_radiation, "lw_solver_noscat_bwd")]
    old = [(mod, name, getattr(mod, name)) for _, mod, name in targets]
    try:
        for kind, mod, name in targets:
            setattr(mod, name, _Captured(getattr(mod, name), store, kind))
        yield store
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def _plain_call(kind):
    """The plain version of kernel ``kind`` as its wrapper is called."""
    from climsim_tpu_torch import ops
    from climsim_tpu_torch.physics import radiation as R
    return {"b7": ops.bigru_reference_lbh, "b8": ops.bigru_bwd_reference_lbh,
            "b10": ops.bigru_heads_init_lbh_reference, "b11": R.adding_sw,
            "b12": R.lw_solver_noscat, "b13": ops.adding_sw_bwd_reference,
            "b14": ops.lw_solver_noscat_bwd_reference}[kind]


def held_to_plain(card, label, store) -> dict:
    """Each kept launch's outputs against its plain version on the same
    inputs, on the card: float32 B7 to 1e-5 + 1e-5 |x| (check_b7), B8 to
    2e-5 of each output's scale (check_b8), B11-B14 to 1e-5 (check_
    radiation); bfloat16 by bf16_ok (4x the plain version's own
    bf16-vs-f32 difference). Returns kind -> max_abs_err."""
    errs = {}
    f32 = lambda x: [f32(y) for y in x] if isinstance(x, (list, tuple)) \
        else (x.float() if torch.is_tensor(x) and x.is_floating_point()
              else x)
    with torch.no_grad():
        for kind, (args, kw, got) in sorted(store.items()):
            ref = _plain_call(kind)
            want = ref(*args, **kw)
            got, want = list(got), list(want)
            bf16 = got[0].dtype == torch.bfloat16
            if bf16:
                want32 = list(ref(*f32(args), **kw))
                for i, (g, w, w32) in enumerate(zip(got, want, want32)):
                    ok, e, own = bf16_ok(g, w, w32)
                    check(ok, f"{label} {kind.upper()} bf16 output {i}: "
                          f"{e:.3e} > 4 x {own:.3e}")
            else:
                for i, (g, w) in enumerate(zip(got, want)):
                    check(bool(torch.isfinite(g).all()),
                          f"{label} {kind.upper()} output {i} not finite")
                    if kind == "b7":
                        torch.testing.assert_close(g, w, rtol=1e-5,
                                                   atol=1e-5)
                    else:
                        e = rel_err(g, w)
                        tol = 2e-5 if kind == "b8" else 1e-5
                        check(e <= tol, f"{label} {kind.upper()} output "
                              f"{i}: {e:.3e} of its scale > {tol}")
            errs[kind] = max_err(got, want)
            flat = lambda x: [t for y in x for t in flat(y)] \
                if isinstance(x, (list, tuple)) else (
                    [x] if torch.is_tensor(x) else [])
            shape = tuple(max(flat(args), key=lambda t: t.numel()).shape)
            print(f"{label}: {kind.upper()} {'bf16' if bf16 else 'f32'} "
                  f"{shape} against its plain version on the same inputs: "
                  f"max_abs_err {errs[kind]:.3e} [{card}]")
    return errs


def phys17_arm(card, name) -> dict:
    """One physics option arm at PHYS17_NCOL columns: a W 3 evaluation
    window and a W 1 update, each with every counter at 0 just before and
    read just after (the arm's kernels once a model step, none other),
    each kernel's first launch held to its plain version, finite values;
    then time_phys_eval on the window (ms a model step, peak memory; its
    profile would double the phase's time) and time_phys_update on the
    update (ms a W 1 update, peak memory, idle share)."""
    over = PHYS17_ARMS[name]
    ncol = PHYS17_NCOL
    t = [time.perf_counter()]
    model = make_phys_model(None, **over)
    ev = make_phys_trainer(model, None)
    up = make_phys_trainer(model, None, train=True, W=1)
    chunk = phys_chunk(PHYS_W, ncol, "cuda")
    one = phys_chunk(1, ncol, "cuda", seed=7)
    per = phys17_step_launches(model, False)
    per_t = phys17_step_launches(model, True)
    t.append(time.perf_counter())
    with captured_launches() as store:
        (mem, rec), launches = counted(
            lambda: ev.run_epoch(None, [chunk], 0, train=False))
        check(launches == {k: PHYS_W * c for k, c in per.items()},
              f"phys17 {name} evaluation: launches {launches}, want "
              f"{PHYS_W} x {per}")
        check(np.isfinite(rec["loss"]) and bool(torch.isfinite(mem).all()),
              f"phys17 {name} evaluation: loss {rec['loss']}")
        with torch.enable_grad():
            (mem1, rec1), launches_t = counted(
                lambda: up.run_epoch(None, [one], 0))
        check(launches_t == per_t, f"phys17 {name} update: launches "
              f"{launches_t}, want {per_t}")
        check(rec1["updates"] == 1 and np.isfinite(rec1["loss"])
              and all(bool(torch.isfinite(p).all())
                      for p in model.parameters()),
              f"phys17 {name} update: {rec1}")
    t.append(time.perf_counter())
    errs = held_to_plain(card, f"phys17 {name}", store)
    del store
    t.append(time.perf_counter())
    label = f"phys17 arm {name}"
    time_phys_eval(model, card, ncol, chunk, label, profile=False)
    t.append(time.perf_counter())
    time_phys_update(up, one, 1, ncol, card, label)
    t.append(time.perf_counter())
    print(f"{label} ({trunk_of(model)} trunk, nneur 128/128, "
          f"{policy_of(model)} policy, {ncol} columns): launches a W "
          f"{PHYS_W} window {launches}, a W 1 update {launches_t}; steps: "
          + ", ".join(f"{k} {b - a:.1f} s" for k, a, b in zip(
              ("model and data", "counted runs", "held to plain",
               "evaluation timing", "update timing"), t, t[1:]))
          + f" [{card}]")
    return {"launches_window": launches, "launches_update": launches_t,
            "errs": errs}


def phys17_lockstep(card, name):
    """One W 1 update of the arm at 384 columns and nneur 32 on the card
    and on the CPU from the same seeded model and data, the card's McICA
    and top-2 choices replayed on the CPU (ChoiceReplay), held as
    compare_cli_384 holds an update: the loss within 1e-4 of the CPU's
    plus 4x the larger movement of two witnesses (the CPU's weights times
    1 +- 1e-6); each parameter's gradient, in the norm of its difference,
    within 1e-4 of the CPU's norm plus 4x the witness movement plus 1e-6
    of the whole gradient's norm; the card's Adam step from the common
    initial weights within 1e-5 of (|w| + lr) of the first Adam step
    lr g / (|g| + eps) of the card's own gradient."""
    over = PHYS17_ARMS[name]
    ncol = LO_NLAT * LO_NLON
    runs, calls, init = {}, None, None
    for key, dev, scale in (("cuda", "cuda", 1.0), ("cpu", "cpu", 1.0),
                            ("plus", "cpu", 1 + 1e-6),
                            ("minus", "cpu", 1 - 1e-6)):
        model = make_phys_model(dev, H=32, **over)
        if init is None:
            init = {n: p.detach().cpu().clone()
                    for n, p in model.named_parameters()}
        if scale != 1.0:
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(scale)
        tr = make_phys_trainer(model, dev, train=True, W=1)
        chunk = phys_chunk(1, ncol, dev, seed=8)
        with ChoiceReplay(calls) as ch, torch.enable_grad():
            _, rec = tr.run_epoch(None, [chunk], 0)
        if calls is None:
            calls = ch.calls
        else:
            ch.done(f"phys17 {name} 384 {key}")
        runs[key] = {"loss": rec["loss"],
                     "grads": {n: p.grad.detach().cpu().double()
                               for n, p in model.named_parameters()},
                     "params": {n: p.detach().cpu()
                                for n, p in model.named_parameters()}}
    c, p = runs["cuda"], runs["cpu"]
    wit = [runs["plus"], runs["minus"]]
    norm = lambda t: float(torch.linalg.vector_norm(t))
    tol = 1e-4 * abs(p["loss"]) + 4 * max(abs(w["loss"] - p["loss"])
                                          for w in wit)
    check(abs(c["loss"] - p["loss"]) <= tol, f"phys17 {name} 384: loss "
          f"{c['loss']!r} vs the CPU's {p['loss']!r} (tolerance {tol!r})")
    gnorm = float(torch.sqrt(sum((g ** 2).sum()
                                 for g in p["grads"].values())))
    worst = worst_step = 0.0
    for n, gp in p["grads"].items():
        gc_ = c["grads"][n]
        check(bool(torch.isfinite(gc_).all()), f"phys17 {name} 384 {n}")
        tol = 1e-4 * norm(gp) + 4 * max(norm(w["grads"][n] - gp)
                                        for w in wit) + 1e-6 * gnorm
        err = norm(gc_ - gp)
        check(err <= tol, f"phys17 {name} 384 gradient {n}: {err:.3e} > "
              f"{tol:.3e}")
        worst = max(worst, err / max(tol, 1e-300))
        # Adam's first step from the common initial weights
        g32 = gc_.float()
        want = init[n] - PHYS_LR * g32 / (g32.abs() + 1e-8)
        d = (c["params"][n] - want).abs()
        steptol = 1e-5 * (want.abs() + PHYS_LR)
        check(bool((d <= steptol).all()), f"phys17 {name} 384: the Adam "
              f"step of {n} differs by {float(d.max()):.3e}")
        worst_step = max(worst_step, float((d / steptol).max()))
    print(f"phys17 arm {name}, 384 columns, nneur 32, one W 1 update card "
          f"vs CPU in lockstep ({len(calls)} choices replayed): loss "
          f"{c['loss']:.7e} vs {p['loss']:.7e}; gradients within "
          f"{worst:.3f} and the Adam step within {worst_step:.3f} of their "
          f"tolerances [{card}]")


def semi_online_v4(card) -> dict:
    """The semi-online update of the v4 arm (bench.py's model, bf16, W 3,
    remat, MSE, Adam) at 21,600 columns: the raw state and raw true
    tendencies of seeded numpy series in physical ranges, the state
    normalizer and the cloud-exp coefficients; the launches of one update
    (every counter at 0: B10 twice, B7 and B8 once a window step), each
    kernel's first launch held to its plain version (bf16_ok), finite;
    then its ms (one synchronized update after the counted one) and peak
    memory."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16
    from climsim_tpu_torch.train import RolloutConfig, RolloutTrainer
    ncol = NLAT * NLON
    model = make_model(BF16, None, arm="v4")
    grid = Grid.synthetic(4, NLEV)
    cfg = RolloutConfig(rollout_schedule={0: SEMI_W}, loss="mse", lr=LR,
                        optimizer="adam", remat=True, semi_online=True,
                        n_prog=6)
    tr = RolloutTrainer(
        model, cfg, grid.hyai.numpy(), grid.hybi.numpy(),
        yscale_lev=1.0 / np.array(YSCALE, np.float32),
        xmean_prog=np.array([[250.0, 1e-3, 0.5, 0.5, 0.0, 0.0]], np.float32),
        xdiv_prog=np.array([[20.0, 1e-3, 0.5, 0.5, 10.0, 10.0]], np.float32),
        lbd_qc=np.full(NLEV, 1e5, np.float32),
        lbd_qi=np.full(NLEV, 1e5, np.float32), device=None)
    chunk = train_chunk(SEMI_W, ncol, "cuda", seed=12)
    rng = np.random.default_rng(13)
    shape = (SEMI_W, ncol, NLEV)
    raw = np.stack([rng.uniform(200, 300, shape),
                    np.abs(rng.normal(1e-3, 3e-4, shape)),
                    np.abs(rng.normal(0, 1e-5, shape)),
                    np.abs(rng.normal(0, 1e-5, shape)),
                    rng.normal(0, 10, shape), rng.normal(0, 5, shape)], -1)
    chunk["x_lev_raw"] = torch.as_tensor(raw, dtype=torch.float32,
                                         device="cuda")
    chunk["y_lev_raw"] = torch.as_tensor(
        rng.normal(0, 1, shape + (6,)) * np.array(YSCALE), dtype=torch.float32,
        device="cuda")
    mem = tr.init(chunk)
    window = tr._window(chunk, 0, SEMI_W)
    with captured_launches() as store:
        torch.cuda.reset_peak_memory_stats()
        (mem1, loss), launches = counted(lambda: tr.update(window, mem,
                                                           None))
        peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: c * SEMI_W for k, c in SEMI_LAUNCHES.items()}
    check(launches == want, f"semi-online v4 update: launches {launches}, "
          f"want {want}")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(mem1).all())
          and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          f"semi-online v4 update: loss {loss}")
    errs = held_to_plain(card, "semi-online v4 update", store)
    del store
    ms = median_ms(lambda: tr.update(window, mem, None), 1,
                   repeats=OLD_REPEATS, queue_ahead=False)
    print(f"semi-online update, arm v4 (bf16, W {SEMI_W}, remat, {ncol} "
          f"columns): {ms:.4f} ms an update, peak {peak:.3f} GB, loss "
          f"{float(loss):.6f}; launches {launches} [{card}]")
    return {"ms": ms, "peak_gb": peak, "launches": launches, "errs": errs}


def check_phys_options(card) -> dict:
    """Phase 17: each physics option arm at PHYS17_NCOL columns (launches,
    each kernel against its plain version, times, peak memory, idle
    share) and at 384 columns card against CPU in lockstep, then the
    semi-online update of the v4 arm. Returns the measurements for the
    kernels line."""
    res = {"arms": {}}
    for name in PHYS17_ARMS:
        t0 = time.perf_counter()
        res["arms"][name] = phys17_arm(card, name)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        phys17_lockstep(card, name)
        print(f"phys17 arm {name}: {t1 - t0:.1f} s on the card, "
              f"{time.perf_counter() - t1:.1f} s in lockstep")
    t0 = time.perf_counter()
    res["semi_online"] = semi_online_v4(card)
    print(f"semi-online v4 update: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------ phase 18: A.13's and A.14's modules

# the CfC liquid network (models/ncp.py) at the flagship's column shape:
# 21,600 columns as the batch, the 60 levels as the sequence, the 6 level
# inputs; units 192 and backbone 128, the LSTM memory, a 6-wide head
P18_NCOL, P18_UNITS, P18_BACKBONE, P18_NX = NLAT * NLON, 192, 128, 6
# the hyperparameter search (train/hpo.py) over the flagship: four trials
# of two W 1 updates at 2,700 columns, then a validation loss
HPO_NCOL, HPO_TRIALS, HPO_UPDATES = NLAT * NLON // 8, 4, 2
HPO_SPACE = {"lr": ("loguniform", 1e-4, 1e-2)}
# the vmapped search over dense CfCs: the learning rate batched, the width
# the static field (its groups run as separate passes)
VMAP_SPACE = {"lr": ("loguniform", 1e-3, 1e-1),
              "units": ("choice", [64, 128])}
VMAP_TRIALS, VMAP_BATCH, VMAP_STEPS = 16, 8, 2
# the data tools at 21,600 columns: two v5 file pairs through pack_pair,
# 24 steps through expand_features, the Kaggle files of the v2 set
P18_PAIRS, EXPAND_T = 2, 24
P18_SMALL = LO_NLAT * LO_NLON


def check_launches(got, want, label):
    check(got == want, f"{label}: launches {got}, want {want}")


def cfc_models(device, seed=0):
    """The dense CfC and the CfC wired over AutoNCP(192, 6, 0.5), both
    with the LSTM memory, from one seed."""
    from climsim_tpu_torch.models import AutoNCP, CfC
    dense = CfC(P18_NX, P18_UNITS, proj_size=6, mixed_memory=True,
                backbone_units=P18_BACKBONE, device=device, seed=seed)
    wired = CfC.wired(AutoNCP(P18_UNITS, 6, sparsity_level=0.5), P18_NX,
                      mixed_memory=True, device=device, seed=seed)
    return {"dense": dense, "wired": wired}


def cfc_data(ncol, device, seed=18):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(ncol, NLEV, P18_NX, generator=g)
    y = 0.5 * torch.randn(ncol, NLEV, 6, generator=g)
    return x.to(device), y.to(device)


def cfc_update_fn(model, x, y, lr=1e-3):
    """One Adam update of ``model`` on the MSE of its outputs."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def update():
        with torch.enable_grad():
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((model(x)[0] - y) ** 2)
            loss.backward()
        opt.step()
        return loss
    return update


def cfc_flops(model, ncol) -> float:
    """Multiply-adds x 2 of one forward: every Dense of a step (the masked
    kernels counted dense, as they run) over the levels."""
    macs = sum(p.numel() for n, p in model.named_parameters()
               if n.endswith("kernel"))
    return 2.0 * macs * ncol * NLEV


def kernel_count(fn):
    """The kernels ``fn()`` launches on the card and their device time in
    ms (torch.profiler, device activity alone)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages() if ev.device_time_total > 0]
    return (sum(ev.count for ev in kernels),
            sum(ev.device_time_total for ev in kernels) / 1e3)


def check_cfc(card, device="cuda", ncol=P18_NCOL) -> None:
    """The dense and the wired CfC at 21,600 columns on the card: a
    forward and one Adam update timed, the update's peak memory, the
    kernels a forward launches (torch.profiler); then at 384 columns
    outputs and parameter gradients against device=cpu on the same
    weights, within 1e-5 of each array's scale."""
    x, y = cfc_data(ncol, device)
    for name, model in cfc_models(device).items():
        with torch.no_grad():
            out, _ = model(x)
        check(tuple(out.shape) == (ncol, NLEV, 6)
              and bool(torch.isfinite(out).all()), f"CfC {name} forward")
        fwd_ms = median_ms(lambda: model(x), 1)
        n_kernels, busy = kernel_count(lambda: model(x))
        update = cfc_update_fn(model, x, y)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        upd_ms = median_ms(update, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        loss = float(update())
        check(np.isfinite(loss), f"CfC {name} update loss {loss}")
        flops = cfc_flops(model, ncol)
        print(f"CfC {name} (units {P18_UNITS}, f32, TF32 off) at "
              f"{ncol} columns x {NLEV} levels: forward {fwd_ms:.4f} ms "
              f"({n_kernels} kernels, device busy {busy:.4f} ms; bound "
              f"{flops / PEAK_F32 * 1e3:.4f} ms by f32 operations), Adam "
              f"update {upd_ms:.4f} ms (bound {3 * flops / PEAK_F32 * 1e3:.4f}"
              f" ms), peak {peak:.2f} GB, loss {loss:.6f} [{card}]")
        del update
        gc.collect()
        torch.cuda.empty_cache()
    # 384 columns: the card against the CPU on the same weights
    xs, ys = cfc_data(P18_SMALL, "cpu", seed=19)
    ct = torch.randn(P18_SMALL, NLEV, 6,
                     generator=torch.Generator().manual_seed(20))
    cpu_models = cfc_models("cpu", seed=1)
    for name, model in cfc_models(device, seed=1).items():
        cm = cpu_models[name]
        outs, grads = {}, {}
        for tag, m, dev in (("card", model, device), ("cpu", cm, "cpu")):
            with torch.enable_grad():
                out, _ = m(xs.to(dev))
                (out * ct.to(dev)).sum().backward()
            outs[tag] = out.detach().cpu()
            grads[tag] = {n: p.grad.cpu() for n, p in m.named_parameters()}
        err = rel_err(outs["card"], outs["cpu"])
        gerr = max(rel_err(grads["card"][n], grads["cpu"][n])
                   for n in grads["cpu"])
        print(f"CfC {name} at {P18_SMALL} columns, card against CPU: output "
              f"{err:.3e}, gradients up to {gerr:.3e} of their scale "
              f"(tolerance 1e-5) [{card}]")
        check(err <= 1e-5 and gerr <= 1e-5, f"CfC {name} card vs CPU: "
              f"{err:.3e}, gradients {gerr:.3e}")



def hpo_trainer(lr, device):
    """A fresh flagship v6 model (bf16, nneur 192/192, nh_mem 16, seed 0)
    behind bench.py::build_train's trainer with a W 1 window and the
    trial's learning rate."""
    from climsim_tpu_torch.models import BF16
    return make_trainer(make_model(BF16, device), device, W=1, lr=lr)


def hold_b1_b3(model, card, B):
    """B1 and B3 at the trials' shapes (bf16, B columns) against their
    plain versions, as check_b1 and check_b3 hold them."""
    from climsim_tpu_torch.ops import (bigru_heads_cm_bwd,
                                       bigru_heads_cm_bwd_reference,
                                       bigru_heads_init_cm_reference,
                                       fused_bigru_heads_init_cm)
    a16 = tuple(t.to(torch.bfloat16)
                for t in b1_args(model, B, torch.float32, seed=B))
    got = fused_bigru_heads_init_cm(*a16)
    want = bigru_heads_init_cm_reference(*a16)
    own = max_err(want, bigru_heads_init_cm_reference(
        *(t.float() for t in a16)))
    e1 = max_err(got, want)
    check(e1 <= 4.0 * own, f"B1 bf16 B={B}: {e1} > 4 x {own}")
    res, dom, dlh = b3_args(model, B, torch.float32, seed=B)
    r16 = tuple(t.to(torch.bfloat16) for t in res)
    d16 = (dom.to(torch.bfloat16), dlh.to(torch.bfloat16))
    got3 = bigru_heads_cm_bwd(r16, *d16)
    want3 = bigru_heads_cm_bwd_reference(r16, *d16)
    want32 = bigru_heads_cm_bwd_reference(tuple(t.float() for t in r16),
                                          *(t.float() for t in d16))
    for name, g, w, w32 in zip(B3_NAMES, got3, want3, want32):
        ok, e, own3 = bf16_ok(g, w, w32)
        check(ok, f"B3 bf16 B={B} {name}: {e:.3e} > 4 x {own3:.3e}")
    e3 = max_err(got3, want3)
    print(f"B1 and B3 bf16 at the trials' {B} columns against their plain "
          f"versions: max_abs_err {e1:.3e} (plain bf16-vs-f32 {own:.3e}; "
          f"tolerance 4x) and {e3:.3e} (each output within 4x its own) "
          f"[{card}]")
    return e1, e3


def check_hpo_flagship(card, device="cuda", ncol=HPO_NCOL) -> dict:
    """random_search over the flagship: a solo W 1 update counts B1's and
    B3's launches; each of HPO_TRIALS trials (lr log-uniform in [1e-4,
    1e-2]) trains a fresh model by HPO_UPDATES W 1 updates at HPO_NCOL
    columns with every counter at 0 just before and read just after (the
    solo update's launches x HPO_UPDATES, no other kernel), then takes a
    validation loss (B1 once a step); every score finite and every trial
    one attempt (a CUDA error inside a trial would become an inf score).
    B1 and B3 held to their plain versions at the trials' shapes."""
    from climsim_tpu_torch.train import SearchSpace, random_search
    wrappers = all_wrappers()
    data = train_chunk(HPO_UPDATES, ncol, device, seed=3)
    val = train_chunk(2, ncol, device, seed=4)
    solo = hpo_trainer(LR, device)
    one = {k: v[:1] for k, v in data.items()}
    for w in wrappers.values():
        w.launches = 0
    with torch.enable_grad():
        solo.run_epoch(None, [one], 0)
    torch.cuda.synchronize()
    per_update = {k: w.launches for k, w in wrappers.items() if w.launches}
    check_launches(per_update, {"b1": 2, "b3": 1}, "a W 1 update of the v6 "
                   "model")
    errs = hold_b1_b3(solo.model, card, ncol)
    del solo
    attempts, log = [], []

    def trial(cfg):
        attempts.append(cfg)
        t0 = time.perf_counter()
        trainer = hpo_trainer(cfg["lr"], device)
        for w in wrappers.values():
            w.launches = 0
        with torch.enable_grad():
            _, rec = trainer.run_epoch(None, [data], 0)
        torch.cuda.synchronize()
        train_l = {k: w.launches for k, w in wrappers.items() if w.launches}
        for w in wrappers.values():
            w.launches = 0
        _, vrec = trainer.run_epoch(None, [val], 0, train=False)
        val_l = {k: w.launches for k, w in wrappers.items() if w.launches}
        log.append({"lr": cfg["lr"], "train_loss": rec["loss"],
                    "updates": rec["updates"], "val_loss": vrec["loss"],
                    "train_launches": train_l, "val_launches": val_l,
                    "seconds": time.perf_counter() - t0})
        return vrec["loss"]

    t0 = time.perf_counter()
    top = random_search(trial, SearchSpace(HPO_SPACE),
                        num_trials=HPO_TRIALS, top_k=HPO_TRIALS, seed=0)
    wall = time.perf_counter() - t0
    check(len(attempts) == HPO_TRIALS, f"{len(attempts)} attempts for "
          f"{HPO_TRIALS} trials: a trial raised")
    check(len(top) == HPO_TRIALS, f"{HPO_TRIALS - len(top)} trials scored "
          f"inf or nan")
    want = {k: v * HPO_UPDATES for k, v in per_update.items()}
    for i, r in enumerate(log):
        print(f"hpo trial {i}: lr {r['lr']:.6g}, {r['updates']} W 1 updates "
              f"at {ncol} columns, train loss {r['train_loss']:.6f}, "
              f"validation loss {r['val_loss']:.6f}, {r['seconds']:.3f} s"
              f"{' (with its warm-up)' if i == 0 else ''}; launches "
              f"{r['train_launches']} training, {r['val_launches']} "
              f"validation [{card}]")
        check(r["updates"] == HPO_UPDATES, f"trial {i}: {r['updates']}")
        check_launches(r["train_launches"], want, f"hpo trial {i} training")
        check_launches(r["val_launches"], {"b1": 2},
                       f"hpo trial {i} validation")
    print(f"random_search over the flagship: {HPO_TRIALS} trials in "
          f"{wall:.3f} s, best lr {top[0]['config']['lr']:.6g} (validation "
          f"loss {top[0]['score']:.6f}) [{card}]")
    return {"training": want, "validation": {"b1": 2}, "b1_err": errs[0],
            "b3_err": errs[1], "trials": HPO_TRIALS}


def cfc_trial_fn(units, x, y, device, steps=VMAP_STEPS):
    """The vmapped search's trial: a dense CfC of ``units`` (built once,
    seed 0) trained by ``steps`` SGD steps through torch.func at a
    learning rate, then its loss; a function of the learning rate."""
    from climsim_tpu_torch.models import CfC
    model = CfC(x.shape[-1], units, proj_size=y.shape[-1], mixed_memory=True,
                backbone_units=P18_BACKBONE, device=device, seed=0)
    params0 = {k: v.detach() for k, v in model.named_parameters()}

    def loss(p):
        out, _ = torch.func.functional_call(model, (p,), (x,))
        return torch.mean((out - y) ** 2)

    def train(lr):
        params = params0
        for _ in range(steps):
            g = torch.func.grad(loss)(params)
            params = {k: params[k] - lr * g[k] for k in params}
        return loss(params)
    return train


def check_hpo_vmap(card, device="cuda", ncol=HPO_NCOL) -> None:
    """parallel_random_search of VMAP_TRIALS dense-CfC trials in batches of
    VMAP_BATCH, each batch one torch.func.vmap over the learning rate: the
    device passes one per batch of each width's group, and every score
    equal to the sequential random_search of the same trials within 1e-4
    (relative)."""
    from climsim_tpu_torch.train import (SearchSpace,
                                         parallel_random_search,
                                         random_search)
    x, y = cfc_data(ncol, device, seed=21)
    passes = []

    def batched(static_cfg, vec_cfg):
        passes.append(len(vec_cfg["lr"]))
        lrs = torch.as_tensor(vec_cfg["lr"], dtype=torch.float32,
                              device=device)
        train = cfc_trial_fn(static_cfg["units"], x, y, device)
        return torch.func.vmap(train)(lrs).detach().cpu().numpy()

    t0 = time.perf_counter()
    top = parallel_random_search(batched, SearchSpace(VMAP_SPACE),
                                 num_trials=VMAP_TRIALS,
                                 batch_size=VMAP_BATCH, top_k=VMAP_TRIALS,
                                 seed=0)
    t_vmap = time.perf_counter() - t0
    groups = {}
    for i in range(VMAP_TRIALS):
        u = SearchSpace(VMAP_SPACE).sample(np.random.default_rng((0, i)))
        groups[u["units"]] = groups.get(u["units"], 0) + 1
    want_passes = sum(-(-n // VMAP_BATCH) for n in groups.values())
    check(len(passes) == want_passes and sum(passes) == VMAP_TRIALS,
          f"vmapped search: passes {passes}, want {want_passes}")
    check(len(top) == VMAP_TRIALS, "vmapped search: a score not finite")
    t0 = time.perf_counter()
    seq = random_search(
        lambda cfg: float(cfc_trial_fn(cfg["units"], x, y, device)(
            torch.tensor(cfg["lr"], dtype=torch.float32, device=device))),
        SearchSpace(VMAP_SPACE), num_trials=VMAP_TRIALS,
        top_k=VMAP_TRIALS, seed=0)
    t_seq = time.perf_counter() - t0
    check(len(seq) == VMAP_TRIALS, "sequential search: a score not finite")
    by_trial = {r["trial"]: r["score"] for r in seq}
    worst = max(abs(r["score"] - by_trial[r["trial"]])
                / abs(by_trial[r["trial"]]) for r in top)
    print(f"parallel_random_search (torch.func.vmap): {VMAP_TRIALS} CfC "
          f"trials ({VMAP_STEPS} SGD steps at {ncol} columns) in "
          f"{len(passes)} device passes {passes} (groups {groups}), "
          f"{t_vmap:.3f} s; sequential random_search {t_seq:.3f} s; scores "
          f"within {worst:.3e} (relative; tolerance 1e-4) of the sequential "
          f"ones; best lr {top[0]['config']['lr']:.6g} units "
          f"{top[0]['config']['units']} [{card}]")
    check(worst <= 1e-4, f"vmapped scores {worst:.3e} from the sequential")


P18_DERIVED = {"state_rh", "state_qn", "liq_partition", "icol", "clat",
               "slat", "state_qn_prvphy", "tm_state_qn_prvphy"}
P18_CAM_OUT = ("cam_out_NETSW", "cam_out_FLWDS", "cam_out_PRECSC",
               "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL",
               "cam_out_SOLSD", "cam_out_SOLLD")


def write_v5_pair(path_mli, ncol, seed):
    """A classic netCDF mli/mlo pair of the v5 set at ``ncol`` columns,
    float64 as E3SM writes them: the state, the surface fluxes and every
    input that ingestion does not derive."""
    from scipy.io import netcdf_file
    from climsim_tpu_torch import variables as V
    rng = np.random.default_rng(seed)
    lev = (ncol, NLEV)
    base = {"state_t": rng.uniform(200, 300, lev),
            "state_q0001": np.abs(rng.normal(1e-3, 3e-4, lev)),
            "state_q0002": np.abs(rng.normal(1e-5, 3e-6, lev)),
            "state_q0003": np.abs(rng.normal(1e-5, 3e-6, lev)),
            "state_u": rng.normal(0, 10, lev),
            "state_v": rng.normal(0, 3, lev),
            "state_ps": rng.uniform(9.6e4, 1.03e5, ncol)}
    need = (set(V.get("v5").inputs.names) - P18_DERIVED) | {
        "state_q0002_prvphy", "state_q0003_prvphy",
        "tm_state_q0002_prvphy", "tm_state_q0003_prvphy"}
    mli = dict(base)
    for n in sorted(need - set(mli)):
        mli[n] = np.abs(rng.normal(0.5, 0.2, lev if V.var_len(n) == NLEV
                                   else (ncol,)))
    mlo = {k: v + rng.normal(0, 1e-3 * np.abs(v).mean(), v.shape)
           for k, v in base.items()}
    for n in P18_CAM_OUT:
        mlo[n] = np.abs(rng.normal(100, 40, ncol))
    for path, d in ((path_mli, mli),
                    (path_mli.replace(".mli.", ".mlo."), mlo)):
        with netcdf_file(path, "w") as f:
            f.createDimension("ncol", ncol)
            f.createDimension("lev", NLEV)
            for k, v in d.items():
                f.createVariable(k, "d", ("ncol", "lev") if v.ndim == 2
                                 else ("ncol",))[:] = v


def v5_level_normalizer():
    from climsim_tpu_torch import variables as V
    from climsim_tpu_torch.data import LevelNormalizer
    vs = V.get("v5")
    rng = np.random.default_rng(5)
    size = lambda n: NLEV if V.var_len(n) == NLEV else 1
    mean = {n: rng.uniform(-1, 1, size(n)) for n in vs.inputs.names}
    maxv = {n: v + rng.uniform(1, 2, v.shape) for n, v in mean.items()}
    minv = {n: v - rng.uniform(1, 2, v.shape) for n, v in mean.items()}
    scale = {n: rng.uniform(0.5, 2, size(n)) for n in vs.outputs.names}
    return LevelNormalizer.from_var_stats(vs, mean, maxv, minv, scale)


def check_data_tools(card, device="cuda", ncol=P18_NCOL) -> None:
    """The data tools at ``ncol`` columns, each on the card (ms) against the
    same call with device="cpu": pack_pair of P18_PAIRS classic netCDF v5
    pairs (the relative humidity and a LevelNormalizer on the card) within
    1e-6 of each array's scale; expand_features on [EXPAND_T, ncol, 60]
    for its five default variables bit-equal; export_kaggle_files from a
    Normalizer on the card byte-equal. tensorstore and h5py are looked up
    and reported: their paths (tsstore, ingest's keeplev H5, save_as_npy's
    h5 twins) are not run here."""
    import filecmp
    import importlib.util
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch import variables as V
    from climsim_tpu_torch.data import (Normalizer, expand_features,
                                        export_kaggle_files, pack_pair)
    with tempfile.TemporaryDirectory() as tmp:
        gpath = os.path.join(tmp, "grid.nc")
        write_grid_file(gpath, ncol)
        t0 = time.perf_counter()
        mlis = [os.path.join(tmp, f"E3SM-MMF.mli.0001-02-0{i + 1}-00000.nc")
                for i in range(P18_PAIRS)]
        for i, p in enumerate(mlis):
            write_v5_pair(p, ncol, seed=i)
        print(f"data tools: {P18_PAIRS} v5 pairs of {ncol} columns written "
              f"in {time.perf_counter() - t0:.1f} s")
        grid, cgrid = Grid.from_file(gpath, device=device), \
            Grid.from_file(gpath, device="cpu")
        nz = v5_level_normalizer()
        vs = V.get("v5")
        ms, errs = [], []
        for p in mlis:
            t0 = time.perf_counter()
            got = pack_pair(p, p.replace(".mli.", ".mlo."), vs, grid,
                            nz.to(device), device=device)
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want = pack_pair(p, p.replace(".mli.", ".mlo."), vs, cgrid, nz,
                             device="cpu")
            cpu_ms = (time.perf_counter() - t0) * 1e3
            for g, w in zip(got, want):
                check(g.shape == w.shape and np.isfinite(g).all(),
                      f"pack_pair {g.shape}")
                errs.append(float(np.abs(g - w).max()
                                  / max(np.abs(w).max(), 1e-30)))
            print(f"pack_pair (v5, {ncol} columns) on the card "
                  f"{ms[-1]:.1f} ms, with device=cpu {cpu_ms:.1f} ms "
                  f"(file reads included); shapes "
                  f"{[tuple(a.shape) for a in got]} [{card}]")
        err = max(errs)
        print(f"pack_pair card against CPU: up to {err:.3e} of each array's "
              f"scale (tolerance 1e-6) [{card}]")
        check(err <= 1e-6, f"pack_pair card vs CPU {err:.3e}")
        # expand_features: 24 steps of the five default variables
        g = torch.Generator(device=device).manual_seed(24)
        names = ("state_t", "state_q0001", "state_q0002", "state_q0003",
                 "state_u")
        shape = (EXPAND_T, ncol, NLEV)
        mli = {n: torch.rand(shape, generator=g, device=device)
               for n in names}
        mlo = {n: mli[n] + 1e-3 * torch.rand(shape, generator=g,
                                             device=device) for n in names}
        got = expand_features(mli, mlo)
        ex_ms = median_ms(lambda: expand_features(mli, mlo), 1)
        t0 = time.perf_counter()
        want = expand_features({k: v.cpu() for k, v in mli.items()},
                               {k: v.cpu() for k, v in mlo.items()})
        cpu_ms = (time.perf_counter() - t0) * 1e3
        check(list(got) == list(want), "expand_features keys")
        for k in want:
            check(torch.equal(got[k].cpu(), want[k]),
                  f"expand_features {k}: card and CPU differ")
        nbytes = sum(t.numel() * 4 for t in (*mli.values(), *mlo.values(),
                                            *got.values()))
        print(f"expand_features [{EXPAND_T}, {ncol}, {NLEV}] x "
              f"{len(names)} variables -> {len(got)} features: "
              f"{ex_ms:.3f} ms on the card (bound "
              f"{nbytes / PEAK_BYTES * 1e3:.3f} ms by bytes), {cpu_ms:.1f} "
              f"ms on the CPU, bit-equal [{card}]")
        del mli, mlo, got, want
        # the Kaggle files from a normalizer on the card
        v2 = V.get("v2")
        rng = np.random.default_rng(6)
        mean = rng.normal(0, 100, v2.input_feature_len)
        span = rng.uniform(1, 50, v2.input_feature_len)
        scale = 10.0 ** rng.uniform(-3, 8, v2.target_feature_len)
        nzf = Normalizer.from_arrays(mean, mean + span, mean - span, scale)
        t0 = time.perf_counter()
        info = export_kaggle_files(nzf.to(device), os.path.join(tmp, "kc"))
        k_ms = (time.perf_counter() - t0) * 1e3
        export_kaggle_files(nzf, os.path.join(tmp, "kh"))
        names = sorted(os.listdir(os.path.join(tmp, "kh")))
        same = [filecmp.cmp(os.path.join(tmp, "kc", f),
                            os.path.join(tmp, "kh", f), shallow=False)
                for f in names]
        print(f"export_kaggle_files from a Normalizer on the card: {info}, "
              f"{k_ms:.1f} ms; {sum(same)} of {len(names)} files "
              f"byte-equal to the CPU's [{card}]")
        check(len(names) == 5 and all(same), "Kaggle files differ")
    for mod, paths in (("tensorstore", "data/tsstore.py"),
                       ("h5py", "data/ingest.py::ingest (the keeplev H5) "
                        "and save_as_npy(save_h5=True)")):
        found = importlib.util.find_spec(mod) is not None
        print(f"{mod}: {'present' if found else 'absent'} on this machine; "
              f"{paths} not run here (CPU tests only)")


def check_last_modules(card) -> dict:
    """Phase 18: the CfC networks, the hyperparameter search over the
    flagship and over vmapped CfCs, the data tools. Returns the flagship
    search's launches and errors for the kernels line."""
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"  phase 18: {what} took {now - last[0]:.1f} s")
        last[0] = now
        gc.collect()
        torch.cuda.empty_cache()

    check_cfc(card)
    lap("CfC")
    hpo = check_hpo_flagship(card)
    lap("random_search over the flagship")
    check_hpo_vmap(card)
    lap("the vmapped search")
    check_data_tools(card)
    lap("the data tools")
    return hpo

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
    if sys.argv[1:2] == ["previous"]:
        # B1 and B10 against an earlier checkout's build (its top directory
        # the next argument), then phase 16; no result line
        torch.set_grad_enabled(False)
        previous_in_turns(card, sys.argv[2])
        check_gate_mode_and_a12(card)
        phase_done(16)
        return 0
    check_tensor_core_sass(card)
    phase_done(1)
    if sys.argv[1:] == ["14"]:
        # phase 14 alone (a shorter run while it is developed): no result
        # line
        check_stochastic_slice(card)
        phase_done(14)
        return 0
    if sys.argv[1:] == ["15"]:
        # phase 15 alone, as phase 14, with autograd off as in the whole run
        torch.set_grad_enabled(False)
        check_offline_new_arms(card)
        phase_done(15)
        return 0
    if sys.argv[1:] == ["16"]:
        # phase 16 alone, as phase 14
        torch.set_grad_enabled(False)
        check_gate_mode_and_a12(card)
        phase_done(16)
        return 0
    if sys.argv[1:] == ["17"]:
        torch.set_grad_enabled(False)
        check_phys_options(card)
        phase_done(17)
        return 0
    if sys.argv[1:] == ["18"]:
        torch.set_grad_enabled(False)
        check_last_modules(card)
        phase_done(18)
        return 0

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
                       repeats=REPEATS)
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
    b4_f32 = median_ms(lambda: fused_bigru_heads_cm(*a4_32), 1, repeats=REPEATS)
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
                              repeats=REPEATS),
              "b10": median_ms(lambda: fused_bigru_heads_init_lbh(*a10_32),
                               1, repeats=REPEATS),
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

    # ---- 13. the deployment export: wrappers exported and reloaded in a
    # fresh process, validate_export, the physics yaml's export_path, the
    # v6 and v5 models, the int8 forward, cli.profile, the ops in turns
    torch.cuda.empty_cache()
    check_export(card, model, v5model, v2model, lbh_models)
    phase_done(13)

    # ---- 14. C.2 (no host synchronization in any arm's step, timed in
    # turns with the list index of before), the stochastic ensemble yaml
    # and the long-window yaml (SOAP) through the CLI, the optimizers'
    # steps, both yamls at 384 columns in lockstep with the CPU
    del model, v5model, v2model, lbh_models
    gc.collect()
    torch.cuda.empty_cache()
    check_stochastic_slice(card)
    phase_done(14)

    # ---- 15. the offline CLI's other arms: the stochastic stack (RPN,
    # HSR, cVAE with CRPS), the U-Net and the cloud classifier, each small
    # against the CPU; the dry run's ensemble step
    gc.collect()
    torch.cuda.empty_cache()
    check_offline_new_arms(card)
    phase_done(15)

    # ---- 16. the forwards' bf16-gate mode (pallas_acc32=False) in every
    # fused arm and each kernel alone, timed in turns with the f32 gates;
    # the v6 update's gradients in both modes; the export with the mode;
    # the library yardsticks of B1, B3 and B10; RNNAutoreg's other options
    # (ROADMAP A.12) at full width and against the CPU, and through the CLI
    gc.collect()
    torch.cuda.empty_cache()
    g16 = check_gate_mode_and_a12(card)
    phase_done(16)

    # ---- 17. the physics model's other options (ROADMAP A.11) at 10,800
    # columns and against the CPU, and the semi-online update (A.7)
    gc.collect()
    torch.cuda.empty_cache()
    p17 = check_phys_options(card)
    phase_done(17)

    # ---- 18. the last modules of the JAX package (ROADMAP A.13, A.14): the
    # CfC networks, the hyperparameter search over the flagship (B1, B3)
    # and over vmapped CfCs, the data tools
    gc.collect()
    torch.cuda.empty_cache()
    hpo = check_last_modules(card)
    phase_done(18)

    # ---- 19. the kernels line, the card line, the result
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
    # the library yardsticks of phase 16, and the forwards' bf16-gate mode
    # (acc32=False) beside each: its launches on its arm's coupled step,
    # its error against its plain bf16-gate version and its times there;
    # its bound is the float32-gate mode's, the same products
    by_name = {k["name"]: k for k in kernels}
    for name, key in (("bigru_heads_init_cm", "library_b1"),
                      ("bigru_heads_cm_bwd", "library_b3"),
                      ("bigru_heads_init_lbh", "library_b10")):
        by_name[name]["library_ms"] = g16[key]
    for name, key in f32_of.items():
        by_name[name]["f32"]["library_ms"] = g16["library_f32"][key]
    for name, key in (("bigru_heads_init_cm", "b1"),
                      ("bigru_heads_cm", "b4"), ("bigru_lbh", "b7"),
                      ("bigru_heads_lbh", "b9"),
                      ("bigru_heads_init_lbh", "b10")):
        k, m = by_name[name], g16["kernels"][key]
        k["bf16_gates"] = {
            "launches": g16["launches"][key], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "f32_gates_ms": m["f32_gates_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "expf_share": m["expf_share"]}
    m = g16["kernels"]["b4_unhoisted"]
    by_name["bigru_heads_cm"]["bf16_gates"]["hoist_proj_false"] = {
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "f32_gates_ms": m["f32_gates_ms"], "plain_ms": m["plain_ms"]}
    # phase 17: each kernel's launches on the physics option arms (a W 3
    # evaluation window, a W 1 update) and in the semi-online v4 update,
    # with its first launch's error against its plain version
    for name, key in (("bigru_lbh", "b7"), ("bigru_lbh_bwd", "b8"),
                      ("adding_sw", "b11"), ("lw_noscat", "b12"),
                      ("adding_sw_bwd", "b13"), ("lw_noscat_bwd", "b14"),
                      ("bigru_heads_init_lbh", "b10")):
        arms = {arm: {"window": r["launches_window"].get(key, 0),
                      "update": r["launches_update"].get(key, 0),
                      "max_abs_err": r["errs"].get(key)}
                for arm, r in p17["arms"].items()
                if key in r["launches_window"] or key in r["launches_update"]}
        semi = p17["semi_online"]
        if key in semi["launches"]:
            arms["semi_online_v4"] = {"update": semi["launches"][key],
                                      "max_abs_err": semi["errs"].get(key)}
        if arms:
            by_name[name]["phys_options"] = arms
    # phase 18: B1's and B3's launches in each trial of the search over the
    # flagship (two W 1 updates, then a validation window of 2 steps), and
    # their error at the trials' shapes
    for name, key in (("bigru_heads_init_cm", "b1"),
                      ("bigru_heads_cm_bwd", "b3")):
        by_name[name]["hpo"] = {
            "trials": hpo["trials"],
            "launches_per_trial": hpo["training"].get(key, 0)
            + hpo["validation"].get(key, 0),
            "max_abs_err": hpo[f"{key}_err"]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
