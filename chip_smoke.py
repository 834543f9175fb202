"""Build the PyTorch port's CUDA kernels and drive its main path on one GPU.

Usage: python3 chip_smoke.py   (from the repository root, on a machine with
an NVIDIA H100 and the CUDA toolkit)

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the path from spnerf_torch/csrc with nvcc, the
     six sources in parallel, and print how many clusters of the wide
     kernel fit on the card at once at 768 and 1024 (2 CTAs), 1536 and
     2048 (4) and 3072 and 4096 (8);
  3. hold the fused-field kernel (B1) against its plain PyTorch version at
     the flagship width (8x512 Siren, bf16) on a ragged 131,195-point batch
     for every head subset, on n = 1, 63, 65 and 187 (three tiles, the last
     ragged), and at widths 96, 160 and 256 (semantic and beta heads) for
     every head subset; then B1's float32 route
     (`csrc/field_eval_f32.cu`, "wgmma_f32", 3xTF32 on wgmma) against the
     plain float32 version with TF32 off (F32_ATOL): the flagship width,
     every head subset on the 131,195 points and n = 1, 63, 65, 187; every
     head subset at widths 32, 80, 96, 160, 256, 480 and 512 with and
     without a beta head (96 with a transient code of 20), n = 1,000; then
     B1's general route (`csrc/field_eval_general.cu`, FFMA) against the
     plain version (F32_ATOL in float32, KERNEL_ATOL in bf16): float32 at
     the flagship width packed for it (the parent's route), all heads and
     the solar pass on the 131,195 points; every head subset in float32 at
     736, 768, 800 and 1024 (the widths the float32 route refuses) and in
     bf16 at 96, 160 and 256 (packed for the general kernel) and 736, 768,
     800 and 1024, with and without a beta head; bf16 at fc_units 80 and
     with a transient code of 32;
  4. render a synthetic 256x256 view (65,536 rays) through the eval renderer
     at the flagship configuration with random weights from seed 0: outputs
     finite and in range, every chunk's three field passes launched the
     kernel, a 1,024-ray subset agrees with the same render through the plain
     field, and the view is timed (median of 3 after a warm-up). The same
     subset rendered through the plain field in float32 is printed beside it
     as a control: the size of a change of the rounding policy, which the
     render limits must sit below. The bf16 view launches the wgmma kernel
     only. The subset rendered with compute_dtype="float32" on the card
     launches the wgmma_f32 kernel 3 times a chunk (no other) and agrees
     with that plain float32 render within F32_ATOL; the float32 view
     launches it 3 times a chunk and no other, and is timed (once, each
     route warmed up by its check) through it, through the general
     kernel (weights packed for it: the parent's route) and through the
     module (the float32 route before that, a yardstick), in turns;
  5. at the main path's shapes (chunk x n_samples points for the coarse and
     guided passes, chunk x the merged samples per ray for the solar pass),
     hold each launch against its plain version and time both (CUDA events,
     and the kernel's device time from torch.profiler), beside the same
     launch's products alone as back-to-back bf16 `torch.matmul` calls
     (`gemm_ms`, a yardstick the port never calls); the log line also gives
     the weight bytes the launch reads from L2 as the design reckons them
     (every tile streams every weight stage; a reckoning, not a
     measurement); then both float32 kernels (wgmma_f32 and the general
     route) at the same two shapes: each held within F32_ATOL and timed
     (events, profiler device time) beside the bound of three TF32
     products at 495 TFLOP/s and of FFMA at the float32 units' 67 TFLOP/s,
     the plain version, the same products as float32 `torch.matmul` with
     TF32 off (`gemm_ms_f32`) and the `SPNeRF` module in float32 on the
     same inputs (`module_ms`; yardsticks the port never calls on this
     path); then B1's wide route (`csrc/field_eval_wide.cu`, "wgmma_wide",
     a 64-point tile split across a cluster of two CTAs) against the plain
     version, every head subset on n = 1,000: float32 at 544, 768 and 1024
     (F32_ATOL), bf16 at 736, 768 and 1024 (KERNEL_ATOL), each with and
     without a beta head, bf16 at 80 and with a transient code of 32, and at
     1024 with a beta head in both dtypes on n = 1, 63, 65 and 187; then at
     768 and 1024, at both launch shapes and in both dtypes, the wide kernel
     and the general kernel (weights packed for it) held and timed in the
     same call (events; the wide kernel's profiler device time), beside the
     plain version, the tensor-core bound (bf16 at 989 TFLOP/s, three TF32
     products at 495) and the FFMA bound, `gemm_ms`, `gemm_ms_f32` and the
     float32 module (`module_ms`);
  6. the table-gradient kernels B2 (dtab_dense) and B3 (dtab_sorted) on the
     inputs of the hash train step: one backward of the hash configuration
     (L8 F4 T=2^19, batch 1024, 64 + 64 + 128 samples) through the plain
     version records the 24 (ids, cotangent) pairs the step hands the table
     gradient; each is sent to the kernel the router picks and held against
     the plain version, plus a skewed case (half the rows on 64 ids) for
     both kernels and the edge cases (`spnerf_torch/utils/dtab_cases.py`:
     every row on one id, ids outside [0, t_eff) at both ends, int64 ones
     at -2^40 included, M = 1 and 0, M not a multiple of the partition
     tile, t_eff not a multiple of a slice, F = 1, 3 and 8, more table
     windows than slices with split slices; int64 and int32 ids) for B3 in
     both layouts and B2 in the flat table's feature-major one; B3 must give
     the same bits twice. Every call is timed (CUDA events, host launches
     included) beside the plain version, the library call `index_add_` into
     a zeroed table and with its zero fill, and its bytes bound, and the
     kernels' own device time and device launches per call are read from
     torch.profiler (B2's zero-fill memset, in its C call, included);
  7. the hash train step at full width on a 65,536-ray synthetic scene
     (seed 0): the same step's table gradient and loss through the kernels
     and through the plain version agree; one step through the trainer
     launches B2 3 times and B3 21 times; then 1 warm-up and 10 timed
     steps;
  8. the flagship Siren train step (8x512, bf16, batch 1024) and its one
     kernel, S1 (`csrc/siren_act.cu`, the Siren epilogue, one launch each
     way a Siren activation): one step with `SineLayer`'s counters set to
     0 launches it SIREN_ACTS (37) times each way and the plain version
     never; every launch of a recorded step (65,536 and 131,072 rows, 512
     and 256 wide, w0 30 and 1) is held bit for bit against the plain
     composition (`sine_layer_plain`, `sine_layer_grad_plain`) on its own
     inputs; each shape timed through the wrapper (CUDA events) beside the
     plain composition and its bytes bound (8 B an element each way in
     bf16), and each kernel's device time and launches in one profiled
     step; then 1 warm-up and 3 timed steps;
  9. the hash step with the (L, T, F) table (hash_flat_table=False): its
     24 t-major table gradients recorded and held on B2 and B3 (t-major
     layout) against the plain version and timed, B2 also on the edge cases
     in the t-major layout; the step's loss and table
     gradient through the kernels agree with the plain run; one step
     launches B2 3 times and B3 21 times; then 1 warm-up and 10 timed steps;
 10. SPNERF_HASH_SW_ACC=0 on the flat step: B3′ (dtab_sorted_partials) held
     against the plain version on the step's own 21 window-route inputs,
     the skewed case and the edge cases of phase 6, timed beside the plain
     version, `index_add_` and its bound, with profiler device times (its
     zero fill, a memset in the same C call, included);
     the step through the kernels agrees with the plain step; one step
     launches B2 3 times and B3′ 21 times; then timed;
 11. SPNERF_HASH_SW_BATCHED=1 on the (L, T, F) step: B4 (dtab_batched) held
     against dtab_batched_plain on the step's 3 recorded batched inputs, a
     skewed level and a level of direct-coarse ids, and the batched edge
     cases of `dtab_cases.py` (L = 1, M = 0 and 1, M not a multiple of 32,
     ids at -2^40, -1, T and T + 2^32 in one level, a level of one id,
     F = 1, 3 and 8; int64 and int32 ids), two calls within DTAB_RTOL of
     each other (float atomics); timed as in 10 (`index_add_` on the
     flattened table, with and without its zero fill), with profiler device
     times, the memset included; the step through the kernels agrees with
     the plain step; one step launches B4 3 times and no B2, B3 or B3′; then
     timed;
 12. a DFC2019 scene from disk (`spnerf_torch/utils/synth_scene.py`): a
     synthetic AOI at the bundled AOI's size (4 images of 813x793 px, 3
     train and 1 test, a 512x512 lidar ROI at 0.5 m in UTM 17N, DFC2019
     class ids, MicMac depth of the train images) written to
     <project>/dataset/DFC2019_269 in a temporary project directory and
     loaded twice with semantics and depth (fitting scene.loc and casting
     every image, then from the ray cache, which phase 13's flagship run
     reads);
     `scene_to_device_arrays` -> `Trainer.to_device`; 3 flagship train
     steps at batch 1024 with finite losses; `run_validation` on both
     validation views (save_images=False: the card's machine has no
     matplotlib, so the image grid prints its ImportError) with its B1
     launches counted (3 a chunk) and a finite MAE asserted here; then
     on the test view alone: the render timed (B1 launches counted; one
     render under torch.profiler gives B1's device time, the view's whole
     device time and that render's wall time), its first chunk and its
     ragged last chunk held against the plain render (per-ray p99 and max,
     as phase 4, with the plain float32 render as a control), the
     DSM splat (`index_add_` on the card) held against the same splat on
     the CPU (empty cells equal, values within 1e-4 m) and timed,
     registration and MAE timed (then `compute_shift` on the same ROI
     through its C++ and its numpy backend, timed and held equal), and
     the known-surface check: the AOI's
     own ray-surface points of the view through `latlonalt_from_depth`,
     the DSM and the MAE against its lidar DSM, below 0.05 m;
 13. the training CLI on that project (`spnerf_torch.cli.train.main`, the
     flagship flags at full width: 8x512 Siren, 64 samples, bf16, batch
     1024, windows of 5): 10 steps, its final validation launching B1 666
     times (2 views x 111 chunks x 3) and a checkpoint at step 10; the
     same command with --max_train_steps 20 --auto_resume, whose restore
     gives back the step-10 state bit for bit (parameters and Adam
     moments, read through a wrapper of `CheckpointManager.restore`), 666
     B1 launches and a checkpoint at 20; `tools render --step best`, whose
     PSNR and SSIM equal the logged ones of that step within 1e-3 dB and
     1e-4 (666 B1 launches); the hash family (`--encoding hash
     --img_downscale 4`) for 10 steps, 3 B2 and 21 B3 launches a step, and
     its checkpoint (the whole table and its Adam state) restored bit for
     bit into the run's trainer and scene rebuilt from its flags, on which
     every B2 and B3 call of one step is held against the plain version
     (phase 6's tolerances) and the step's table gradient and loss against
     the plain step's (phase 7's); `eval_torch.py --skip_lpips` on the flagship outputs (finite
     means); LPIPS on the card against the CPU on random weights of the
     .npz spec, within 1e-5. Each run's seconds, validation, save and
     restore seconds, checkpoint bytes, steps a second and launches go on
     one `{"cli": ...}` line;
 14. the other render paths through the CLI on that project, the rays
     cached by phases 12 and 13: (a) the occupancy-grid flagship
     (`--n_samples 32 --occgrid`, 10 steps), its final validation through
     B1 with the trained grid (3 launches a chunk of 11,718 rays, 56
     chunks a view, 336 for the two views), B1 held on the grid-placed test
     view's first and ragged last chunk against the plain render (per-ray
     p99 within RENDER_P99; the max within RENDER_MAX on the depth, and on
     the other outputs within that of the plain float32 render, the
     control, which exceeds RENDER_MAX on this trained field's grid-placed
     samples) and each of
     the first chunk's launches on its own inputs within KERNEL_ATOL, one
     grid refresh on the card against the CPU (same parameters and
     jitter, within KERNEL_ATOL); (b) a multi-AOI hash
     run (`--aoi_id JAX_269,JAX_269 --img_downscale 4`, 10 steps: 3 B2 at
     t_eff 16,384 and 21 B3 at 131,072 and 524,288 a step), every B2 and B3
     call of one step of the restored run held on its frame-XORed ids
     (phase 6's tolerances), the step against the plain step (phase 7's),
     the per-AOI validation MAEs, and B1 on the second frame's test view's
     first chunk (origins near x = 3) against the plain render
     (RENDER_P99/RENDER_MAX) and per launch (KERNEL_ATOL) with the
     flagship's random weights; (c) the fine pass (`--n_importance 64
     --img_downscale 4`, 5 steps) and (d) the proposal sampler
     (`--proposal`, no depth or guided flags, `--img_downscale 4`, 5 steps:
     8 B2 calls a step on the proposal's table, F = 2), whose validations
     render through the modules (no B1 launch), with every proposal-table
     B2 call of one step held against the plain version. Each run's
     seconds, launches and validation metrics go on one `{"paths": ...}`
     line;
 15. data parallelism over ranks and the four pass layouts: (a) a mesh of
     one rank (NCCL) against no mesh, 3 flagship and 3 hash steps with
     deterministic algorithms on (the hash table's gradient through its
     plain version: B2's float atomics do not repeat their last bits), the
     no-mesh run made twice: the mesh run equals it bit for bit where it
     repeats itself, else stays within twice its repeat spread; (b) two
     ranks sharing the card (Gloo on CUDA tensors, spawned processes), 5
     full-width hash steps (512 rays a rank) and 5 flagship steps: the
     ranks' parameters and optimizer state equal bit for bit, 24 table
     gradients a step a rank (the router's B2/B3 split at the halved
     batch printed), every B2/B3 call of rank 0's first step held on its
     own inputs (phase 6's tolerances), step 0's averaged table gradient
     within phase 7's bar of the mean of the two ranks' gradients
     recomputed here through the plain version, the step and all-reduce
     ms and bytes of each rank printed; (c) the training CLI over two
     ranks as `torchrun --nproc_per_node 2 main_torch.py --data_axis 2`
     starts it (env:// on localhost) on phase 12's AOI, flagship, 10
     steps: each rank launches B1 666 times (2 views x 111 chunks of
     5,858 rays, 2,929 a rank, x 3), rank 0 alone writes, the test view
     rendered over the two ranks equals the 1-rank render of the same
     checkpoint (RENDER_P99/RENDER_MAX) and B1 is held on each rank's
     share of its first chunk, the logged MAE equals a 1-rank
     `run_validation` of the checkpoint within 1e-4 m, and a resume with
     --data_axis 1 trains to 15; (d) phase 4's view under each of
     SPNERF_BATCH_SC, SPNERF_BATCH_SOLAR, SPNERF_NO_MERGE and
     SPNERF_NO_PRUNE: B1 launches 24, 36, 36 and 36, each launch of the
     first chunk held at KERNEL_ATOL, the view against the default
     layout's at RENDER_P99/RENDER_MAX; the hash step under BATCH_SOLAR and
     BATCH_SC: 16 table gradients (2 passes x 8 levels), each held, the
     loss and table gradient against the default layout's (phase 7's
     bars). Times of two ranks on one card are printed as such;
 16. the data-prep tail in a temporary project: (a) a raw DFC2019 AOI at
     full size (`write_raw_aoi`: 4 images whose crop to the 512x512 lidar
     ROI at 0.5 m is about 810 px a side, the RPCs in tag 50844, the sun
     angles in tag 42112) prepared by `python -m
     spnerf_torch.data.create_dataset` as a subprocess (crop, JSONs whose
     sun angles must be the tags', seeded splits: 2 train, 2 test), MicMac
     depth from the lidar (`synthesize_depth_from_lidar`, stride 2),
     `tools utm-to-geocentric` on a UTM copy of one depth file (back within
     UTM_ROUND_TRIP_BAR), `tools cal-rmse-depth` on the card (the same
     score as on the CPU within 1e-5 m, the MAE of the lidar's own surface
     below DEPTH_MAE_BAR; the splat timed), `convert-tiff` and `viz-dsm`
     (which names the PNG it skips where matplotlib is missing), each
     step's seconds printed; (b) the flagship through the CLI (phase 13's
     flags without --sem: the prepared data has no semantic labels, as
     the JAX package's create_dataset writes none) for PREP_STEPS steps at
     --img_downscale 1, validated (B1 launches counted), then each B1
     launch of the test view's first and ragged last chunk held at
     KERNEL_ATOL on the trained field's samples (each output's distance
     recorded beside its float32 control and its tensor-core control, the
     plain bf16 field with TF32 on; `spnerf_torch/utils/hold_b1.py`) and
     the render against
     the plain render at RENDER_P99/RENDER_MAX, the plain float32 control
     beside it; (c) the hash family 10 steps at --img_downscale 4 on the
     same dataset, 30 B2 and 210 B3 launches, every B2/B3 call of one step
     of the restored run held (phase 6's tolerances); (d)
     `dryrun_torch.dryrun_multichip(2)`: the eight train-step variants of
     the JAX dry run over two Gloo ranks sharing the card, its lines
     printed. Its numbers on one `{"prep": ...}` line;
 17. the float32 CLI on phase 12's AOI: phase 13's flagship flags plus
     `--precision fp32`, 10 steps (the module trains), its final
     validation through the wgmma_f32 kernel (launches counted per route,
     held to views x chunks x 3, no other route), each launch of the test
     view's first and ragged last chunk held against the plain float32
     version (F32_ATOL), a finite MAE; `tools render --step best` (the
     logged PSNR and SSIM again, the same launches) and `eval_torch.py
     --skip_lpips` on its outputs; then a bf16 field of fc_units 768
     (random weights, seed 768) renders the test view's first and ragged
     last chunk through the wide kernel (its launches counted), held
     at RENDER_P99/RENDER_MAX against the plain bf16 render (the plain
     float32 control beside it) and each launch at KERNEL_ATOL. Its
     numbers on one `{"fp32": ...}` line;
 18. `python3 bench_torch.py` as a user runs it, a subprocess from the
     repository root (the bench's program: the flagship step at batch
     1024, a warm-up window of 100 steps, then two timed windows of 100;
     S1 its only hand-written kernel): it must exit 0 within BENCH_TIMEOUT_S with a last line
     under BENCH_METRIC, a finite value > 0 and this card's name. Its
     record, with phase 8's ms/step beside it, on one `{"bench": ...}`
     line and under `train_steps` on the `kernels` line;
 19. the wide route's path at full width: the training CLI at `--fc_units
     1024` in bf16 (phase 13's flagship flags at `--img_downscale 4`, phase
     13's hash run's ray cache), 10 steps and its final validation, every
     B1 launch on the wide kernel (launches counted by route, held to 3 a
     chunk of every validation view), finite losses and metrics, each
     launch of the test view's first chunk held at KERNEL_ATOL (past it,
     every output within WIDE_CONTROL_SHARE of its plain float32 control
     and within TC_CONTROL_SHARE of its tensor-core control, the plain
     bf16 field with TF32 on, on that launch; each output's distances
     recorded), and that chunk's render
     beside the plain render with TF32 off, the plain float32 render and
     the plain render with TF32 on (recorded); then phase 4's 65,536-ray
     view with a 1024-wide field in
     float32 (random weights, seed 0), rendered and timed through the wide
     kernel and through the general kernel (weights packed for it) in
     turns, 3 launches a chunk on the one route each, the first and the
     ragged last chunk of each within F32_ATOL of the plain float32
     render. Its numbers on one `{"wide": ...}` line;
 20. the wide kernel's soak (`spnerf_torch/utils/wide_checks.py` `soak`,
     seed 0; within ~60 s): at least SOAK_LAUNCHES_MIN launches through
     `fused_field_wide` at 768 and 1024 on clusters of two and at 768 on
     clusters of 4 and 8, bf16 and float32, all heads and
     the solar pass's, on 1, 63, 64, 65, 4,223, 4,224, 4,225, 8,449,
     131,195 and 374,976 points in a shuffled order; each input's first
     launch held against the plain version (KERNEL_ATOL, F32_ATOL), every
     later launch equal to it bit for bit (the kernel's sums are in a
     fixed order, so a race in its cluster meetings shows as a mismatch);
     its launches, mismatches and traps (a launch that fails, with the
     kernel's wait record) and the cluster meetings reckoned from each
     launch's points (not counted by the kernel) on one `{"soak": ...}`
     line;
 21. the wide route past 1,024 wide and past 16 classes (`cluster_pass`):
     (a) random fields of 1,536 and 2,048 wide (clusters of 4) and 3,072
     and 4,096 (clusters of 8) in bf16 and float32, all heads and the
     solar pass's, on 8,192 and 9,217 points, each launch held against the
     plain version (KERNEL_ATOL; F32_ATOL) and equal bit for bit to a
     second one; (b) the same for 150-class fields at 1,024 in bf16 and 512
     in float32 (clusters of two, the logits in passes of 16 columns); (c)
     the training CLI at `--fc_units 2048` in bf16 (phase 13's flagship
     flags at `--img_downscale 8`, 3 steps at batch 1024, halved until the
     step fits; the batch and the peak memory recorded), its validation
     through the wide kernel on clusters of 4 (launches counted by route,
     3 a chunk of every view), every launch of a validation render of both
     views held (KERNEL_ATOL; past it, every output within
     WIDE_CONTROL_SHARE of its float32 control and TC_CONTROL_SHARE of its
     tensor-core control), `tools render --step best` (the same launches,
     the logged PSNR and SSIM); (d) the all-head launch at 2,048 and 4,096
     in both dtypes on 65,536 points, timed (CUDA events and profiler
     device time) beside its tensor-core bound, the plain version,
     `gemm_ms`, `gemm_ms_f32` and the float32 module (`wide_times` and
     `yardsticks`, as phase 5's);
     (e) the clusters of 2, 4 and 8 that fit the card. Its numbers on one
     `{"cluster": ...}` line;
  and print the `kernels` line (B1's `launches_cli`, B2's and B3's from
  phase 13's runs with their errors there, `max_abs_err_cli`; phase 14's
  under `launches_occgrid`, `launches_second_frame`, `launches_multi`,
  `launches_proposal` and their `max_abs_err_*`; phase 15's under
  `launches_dp`, `launches_batch_sc`, `launches_batch_solar`,
  `launches_no_merge`, `launches_no_prune` and their `max_abs_err_*`;
  phase 16's under `launches_prep` and `max_abs_err_prep`; the float32
  route's entry `field_eval_f32`: phase 5's times, its launches at phase
  17's validation, `launches_view` of phase 4's float32 view; the general
  route's entry `field_eval_general`: phase 5's float32 times, its
  launches on phase 19's float32 view packed for it, its errors in
  float32 and bf16; the wide route's entry `field_eval_wide`: its launches
  in phase 19's CLI run, phase 5's times at 1024 in bf16 (the CLI run's
  launch), every time of phase 5 under `times`, phase 20's counts under
  `soak` and phase 19's held launches by output under
  `held_cli_by_output`, phase 21's under `launches_cli_2048`,
  `launches_render_best_2048`, `launches_clusters_held`,
  `max_abs_err_clusters`, `held_cli_2048_by_output`, `cli_2048`,
  `times_clusters` and `clusters_by_size`; the general route's
  `launches_on_routes`, its launches on the CLI runs of phases 19 and 21:
  0, since `route` names it for no field; S1's entry `siren_act`: phase
  8's launches each way, plain calls and mismatches, `ms`, `plain_ms` and
  `bound_ms` a launch (the mean over the step's launches) and a step,
  `by_direction`, the profiler's `device_ms_per_step` and
  `kernel_launches_per_step`, each shape's times under `shapes`).
  The env of phases 10, 11 and 15 (d) is set around its use only and
  restored after.

The last line of standard output is {"ok": true, "device": {...}}.
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

try:
    # B1's bars (KERNEL_ATOL, F32_ATOL, the wide route's control shares) and
    # the one reckoning that holds a launch against them and its controls
    from spnerf_torch.utils import hold_b1
    from spnerf_torch.utils.hold_b1 import (F32_ATOL, KERNEL_ATOL,
                                            TC_CONTROL_SHARE,
                                            WIDE_CONTROL_SHARE, p99_max)
    from spnerf_torch.utils.synth import FLAGSHIP_CLI_FLAGS as CLI_FLAGS
except ImportError as e:
    sys.exit(f"FAIL: the spnerf_torch package is not beside this script: {e}")
# per-ray outputs, kernel vs plain field: 99th percentile and max. The sound
# render reads at most 3.1e-4 and 6.1e-4; the plain float32 render of the
# same rays differs from it by up to 1.8e-3 and 2.8e-3.
RENDER_P99 = 1e-3
RENDER_MAX = 2e-3
# table gradient, kernel vs plain on the same inputs: max abs error over the
# largest entry (the step's cotangents are small, so the limit is relative),
# float32 sums of up to thousands of rows in another order
DTAB_RTOL = 1e-5
# the hash step through the kernels vs through the plain version: the
# cotangents reaching the table differ in their last bits too (the
# renderer's gathers have atomic backwards), so the table gradient is held
# to 1e-4 of its largest entry and the loss, a forward quantity, to 1e-6
STEP_GRAD_RTOL = 1e-4
STEP_LOSS_RTOL = 1e-6
BATCH = 1024
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_F32 = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
N_CHECK = 131_072 + 123
N_VIEW = 256 * 256
# Siren activations of a flagship train step, each one S1 launch each way:
# the coarse and the guided field call with every head (8 trunk layers,
# rgb0, sun0-2, sem0: 13 each) and the solar call pruned to the sun head (11)
SIREN_ACTS = 37


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_check(out, ref, tag):
    """Max abs error of out against ref, and that error over ref's largest
    entry; fails above DTAB_RTOL of it or on a non-finite value."""
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (err <= DTAB_RTOL * scale) or not torch.isfinite(out).all():
        fail(f"{tag}: max abs err {err} against max |dtab| {scale}")
    return err, (err / scale if scale else 0.0)


# names of the port's table-gradient kernels (the zero fill of B2, B3′ and
# B4, a memset in their C call, counts as their own)
PORT_KERNEL_KEYS = ("dtab_scatter", "slice_", "tile_agg")
MEMSET_KEYS = ("Memset",)


def device_ms(run, n_calls, keys=PORT_KERNEL_KEYS, attempts=3):
    """Device time and device launches per call of `run` (which makes
    n_calls calls) under torch.profiler: {"kernel": ms of the kernels whose
    names hold one of `keys`, "launches": those kernels' launches, "names":
    launches per call by kernel name, "device": ms of all device activity,
    "wall": host ms of the same profiled calls}. Each pass opens with a
    fill of its own, synchronised, because the first device activity of a
    pass now and then goes unrecorded. A profiling pass that records no device activity (seen
    now and then after several passes in one process) is run again, up to
    `attempts` times; then every value is None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        us, us_all, n, names = 0.0, 0.0, 0, {}
        seen = False
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            seen = True
            us_all += e.time_range.end - e.time_range.start
            if any(k in e.name for k in keys):
                us += e.time_range.end - e.time_range.start
                n += 1
                name = e.name.split("(")[0].removeprefix("void ")
                names[name] = names.get(name, 0) + 1 / n_calls
        if seen:
            return {"kernel": us / 1e3 / n_calls, "launches": n / n_calls,
                    "names": names, "device": us_all / 1e3 / n_calls,
                    "wall": wall / n_calls}
    return dict.fromkeys(("kernel", "launches", "names", "device", "wall"))


@contextlib.contextmanager
def env_set(name, value):
    """os.environ[name] = value inside the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def field_inputs(n, seed, device, num_sem_classes):
    g = np.random.default_rng(seed)
    xyz = g.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = g.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = g.integers(-1, num_sem_classes, size=n)
    sems = np.where(sems < 0, -100, sems)
    return (torch.from_numpy(xyz).to(device), torch.from_numpy(sun).to(device),
            torch.from_numpy(sems).to(device))


def launch_shapes(rc, chunk, all_heads):
    """{tag: (heads, points)} of a view's two B1 launch shapes: all heads on
    chunk x n_samples points (the coarse and guided passes), ("sun",) on
    chunk x the merged samples (the solar pass)."""
    merged = rc.n_samples * (2 if rc.guidedsample else 1)
    return {"all": (all_heads, chunk * rc.n_samples),
            "sun": (("sun",), chunk * merged)}


def gemm_fn(cfg, heads, n, device, dtype=torch.bfloat16):
    """A launch's products alone: one (n, K) x (K, N) `torch.matmul` in
    `dtype` per layer the call runs, back to back (a yardstick, never the
    port's; float32 with TF32 off, as main sets it)."""
    from spnerf_torch.models.spnerf import layer_specs
    from spnerf_torch.ops.field_eval import layers_run

    shapes = {nm: (sum(segs), out) for nm, segs, out, _ in layer_specs(cfg)}
    ops = []
    for nm in layers_run(cfg, heads):
        k, m = shapes[nm]
        ops.append((torch.randn(n, k, device=device, dtype=dtype),
                    torch.randn(k, m, device=device, dtype=dtype)))
    return lambda: [torch.matmul(a, b) for a, b in ops]


def wide_times(pk, dtype, args, heads, reps):
    """One launch shape of the wide route (phases 5 and 21): its time (CUDA
    events over `reps` launches), its device time (profiler), the plain
    version's time, and its bound at `dtype`: the larger of its products
    at the tensor cores' rate (three TF32 products in float32) and its
    bytes (the inputs, the outputs and the packed weights once) at the
    memory's; "flops" and "bytes" beside it."""
    from spnerf_torch.ops import field_eval as fe

    cfg, n = pk.cfg, args[0].shape[0]
    field, plain = fe.FusedField(pk, dtype), fe.PlainField(pk, dtype)
    flops = fe.flops_per_point(cfg, heads) * n
    outs = sum(w for _, w in fe.active_outputs(cfg, heads))
    nbytes = (n * (fe.in_width(cfg) + 3 + outs) * 4
              + pk.w_all.numel() * 4 + pk.b_all.numel() * 4)
    tensor = (flops / PEAK_BF16 if dtype == "bfloat16"
              else 3 * flops / PEAK_TF32)
    return {"ms": cuda_ms(lambda: field(*args, heads=heads), reps),
            "device_ms": device_ms(lambda: field(*args, heads=heads), 1,
                                   keys=("field_eval_wide",))["kernel"],
            "plain_ms": cuda_ms(lambda: plain(*args, heads=heads), 1),
            "bound_ms": max(tensor, nbytes / PEAK_BYTES) * 1e3,
            "bound_by": ("operations" if tensor >= nbytes / PEAK_BYTES
                         else "bytes"),
            "flops": flops, "bytes": nbytes}


def yardsticks(cfg, heads, args, module, device):
    """A launch shape's yardsticks (phases 5 and 21), never the port's:
    `gemm_ms`, the same products as bf16 `torch.matmul`; `gemm_ms_f32`,
    as float32 ones; `module_ms`, the float32 module on the inputs."""
    n = args[0].shape[0]
    rec = {}
    for key, dtype, reps in (("gemm_ms", torch.bfloat16, 2),
                             ("gemm_ms_f32", torch.float32, 1)):
        gemm = gemm_fn(cfg, heads, n, device, dtype)
        rec[key] = cuda_ms(gemm, reps)
        del gemm
    with torch.no_grad():
        rec["module_ms"] = cuda_ms(lambda: module(*args, heads=heads), 1)
    return rec


def module_render_fn(model, rc, *args):
    """`build_render_fn` with the field through the `SPNeRF` module, as the
    float32 route before the general kernel rendered (a yardstick)."""
    import spnerf_torch.render as rmod

    real = rmod.uses_fused_kernel
    rmod.uses_fused_kernel = lambda *a: False
    try:
        return rmod.build_render_fn(model, rc, *args)
    finally:
        rmod.uses_fused_kernel = real


def general_render_fn(model, rc, *args):
    """`build_render_fn` whose renders pack the field for the general
    kernel, as the parent rendered float32 (a yardstick of the wgmma_f32
    kernel): each render swaps the packing in for its own duration."""
    import spnerf_torch.render as rmod

    render = rmod.build_render_fn(model, rc, *args)
    real = rmod.pack_params

    def run(*a, **kw):
        rmod.pack_params = lambda m, cd: real(m, cd, kernel="general")
        try:
            return render(*a, **kw)
        finally:
            rmod.pack_params = real

    return run


def reset_b1():
    """Set B1's launch counts, the total and each route's, to 0."""
    from spnerf_torch.ops import field_eval as fe

    fe.FusedField.launches = 0
    for k in fe.FusedField.route_launches:
        fe.FusedField.route_launches[k] = 0


AOI_ID = "JAX_269"
FLAGSHIP_EXP = "flagship"  # phase 13's flagship run, whose ray cache phase 12 fills


def validation_pass(device, card, project, width=813, height=793,
                    roi_size=512):
    """Phase 12: a synthetic DFC2019 AOI at the bundled AOI's size written
    to <project>/dataset/DFC2019_269, loaded (the ray cache under
    <project>/output/flagship/cache, phase 13's), trained 3 flagship steps,
    validated; the parts of one validation view timed and checked. Returns
    the record it prints."""
    import argparse

    from spnerf_torch.cli.train import run_validation
    from spnerf_torch.data import load_scene
    from spnerf_torch.evaluation import registration
    from spnerf_torch.evaluation.dsm import dsm_from_latlonalt, rasterize_dsm
    from spnerf_torch.evaluation.mae import compute_mae_and_save_dsm_diff
    from spnerf_torch.geo import latlon_to_utm
    from spnerf_torch.io import read_geotiff
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.train.loop import Trainer, scene_to_device_arrays
    from spnerf_torch.utils.logging import MetricLogger
    from spnerf_torch.utils.synth import (FLAGSHIP_LR, flagship_configs,
                                          flagship_loss_config)
    from spnerf_torch.utils.synth_scene import (surface_points,
                                                write_synthetic_aoi)

    aoi_id = AOI_ID
    rec = {"card": card}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec[tag] = time.perf_counter() - t0
        return out

    tmp = os.path.join(project, "phase12")
    os.makedirs(tmp, exist_ok=True)
    aoi = timed("write_s", lambda: write_synthetic_aoi(
        os.path.join(project, "dataset", "DFC2019_269"), aoi_id=aoi_id,
        width=width, height=height, roi_size=roi_size, n_train=3,
        seed=0))
    dirs = (aoi["json_dir"], aoi["img_dir"], aoi["depth_dir"],
            aoi["sem_dir"], aoi_id)
    kw = dict(sem=True, num_sem_classes=3, load_depth=True,
              cache_dir=os.path.join(project, "output", FLAGSHIP_EXP,
                                     "cache"), verbose=False)
    timed("load_uncached_s", lambda: load_scene(*dirs, **kw))
    scene = timed("load_cached_s", lambda: load_scene(*dirs, **kw))
    n_view = width * height
    if len(scene) != 3 * n_view:
        fail(f"scene has {len(scene)} rays, expected {3 * n_view}")
    log(f"AOI {width}x{height} px, 3 train + 1 test images, ROI "
        f"{roi_size} cells at 0.5 m: written in {rec['write_s']:.1f} s, "
        f"loaded in {rec['load_uncached_s']:.1f} s (fitting scene.loc, "
        f"casting every image) and {rec['load_cached_s']:.1f} s (cached rays); "
        f"{len(scene)} rays, {int(scene.valid_depth.sum())} with depth, "
        f"{int((scene.sems >= 0).sum())} with a semantic label")

    mc, rc = flagship_configs()
    trainer = Trainer(mc, rc, flagship_loss_config(), lr=FLAGSHIP_LR,
                      steps_per_epoch=max(len(scene) // BATCH, 1),
                      max_steps=30000, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    arrays = scene_to_device_arrays(scene)
    data = timed("to_device_s", lambda: trainer.to_device(arrays))
    rec["scene_bytes"] = sum(v.nbytes for v in arrays.values())
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = trainer.train_step(state, data, BATCH)["loss"].item()
        steps.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            fail(f"train step on the loaded scene: loss {loss}")
    rec.update(step_ms_runs=steps, loss=loss)
    log(f"to_device {rec['to_device_s']:.3f} s ({rec['scene_bytes']} "
        f"bytes); 3 flagship steps at batch {BATCH}: {steps} ms, last "
        f"loss {loss:.5f}")
    del data

    # the entry point: every validation view through B1, DSM, MAE
    logs = os.path.join(tmp, "logs")
    args = argparse.Namespace(aoi_id=aoi_id, gt_dir=aoi["gt_dir"],
                              logs_dir=logs, chunk=40960, sem=True,
                              num_sem_classes=3)
    logger = MetricLogger(logs)
    n_chunks = -(-n_view // chunk_size(rc))
    fe.FusedField.launches = 0
    mean = timed("validation_s", lambda: run_validation(
        trainer, scene, state, args, 0, logger, False))
    launches = fe.FusedField.launches
    logger.close()
    rec.update(val_launches=launches, val=mean)
    log(f"run_validation: {len(scene.val_images)} views in "
        f"{rec['validation_s']:.1f} s, B1 launches {launches}: "
        f"{json.dumps(mean)}")
    if launches != 3 * n_chunks * len(scene.val_images):
        fail(f"validation launched B1 {launches} times, expected "
             f"{3 * n_chunks * len(scene.val_images)}")
    if not np.isfinite(mean.get("mae", np.nan)):
        fail(f"validation gave no finite MAE: {mean}")

    # its parts, on the test view
    view_rec = scene.val_images[-1]
    sample = scene.load_val_image(view_rec, with_sem=True)
    render = build_render_fn(state.model, rc, state.t_embed)
    fe.FusedField.launches = 0
    out = timed("view_s", lambda: render(sample["rays"], 0,
                                         sample["sems"]))
    rec["view_launches"] = fe.FusedField.launches
    rec["rays_per_s"] = n_view / rec["view_s"]
    for k, v in out.items():
        if v.shape[0] != n_view or not torch.isfinite(v).all():
            fail(f"view {k}: shape {tuple(v.shape)} or non-finite")
    # B1's share, from one profiled render: of the view's device time,
    # and of that render's wall time (the profiler's own cost included)
    dev = device_ms(lambda: render(sample["rays"], 0, sample["sems"]), 1,
                    keys=("field_eval",))
    share = lambda a, b: a / b if a is not None and b else None
    rec.update(b1_device_ms=dev["kernel"],
               b1_device_launches=dev["launches"],
               view_device_ms=dev["device"],
               view_profiled_ms=dev["wall"],
               b1_share_of_device=share(dev["kernel"], dev["device"]),
               b1_share_of_profiled_wall=share(dev["kernel"],
                                               dev["wall"]))
    log(f"test view: {n_view} rays in {rec['view_s']:.3f} s "
        f"({rec['rays_per_s']:.0f} rays/s), {n_chunks} chunks, B1 "
        f"launches {rec['view_launches']}; one profiled render: B1 "
        f"launches {dev['launches']}, B1 device {dev['kernel']} ms of "
        f"{dev['device']} ms of device time "
        f"({rec['b1_share_of_device']}) and of {dev['wall']} ms wall "
        f"({rec['b1_share_of_profiled_wall']})")
    if rec["view_launches"] != 3 * n_chunks:
        fail(f"the view launched B1 {rec['view_launches']} times")

    # B1 on this path's own inputs (the loaded scene's RPC rays, its
    # sparse labels, the ragged last chunk) against the plain render,
    # the plain float32 render beside it as a control
    chunk = chunk_size(rc)
    plain = build_render_fn(state.model, rc, state.t_embed,
                            field="plain")
    plain32 = build_render_fn(state.model,
                              replace(rc, compute_dtype="float32"),
                              state.t_embed, field="plain")
    rec["view_vs_plain"] = {}
    rec["view_ignored_labels"] = int((sample["sems"] < 0).sum())
    log(f"  test view labels: {rec['view_ignored_labels']} of {n_view} "
        f"ignored")
    for tag, sl in (("first", slice(0, chunk)),
                    ("last", slice((n_chunks - 1) * chunk, n_view))):
        args_sl = (sample["rays"][sl], 0, sample["sems"][sl])
        ref, ctl = plain(*args_sl), plain32(*args_sl)
        errs = {}
        for k, v in ref.items():
            p99, mx = p99_max(out[k][sl], v)
            c99, cmx = p99_max(out[k][sl], ctl[k])
            errs[k] = {"p99": p99, "max": mx, "control_p99": c99,
                       "control_max": cmx}
            log(f"  test view, {tag} chunk ({len(args_sl[0])} rays), "
                f"{k}: kernel vs plain render, p99 {p99:.3g}, max "
                f"{mx:.3g}; control (vs plain float32) p99 {c99:.3g}, "
                f"max {cmx:.3g}")
            if not (p99 <= RENDER_P99 and mx <= RENDER_MAX):
                fail(f"test view, {tag} chunk, {k}: kernel render "
                     f"disagrees with the plain render")
        rec["view_vs_plain"][tag] = errs
        del ref, ctl

    depth = out["depth_coarse"].float().cpu().numpy()
    lats, lons, alts = scene.latlonalt_from_depth(sample["rays"], depth)
    pred = os.path.join(tmp, "pred_dsm.tif")
    _, (xoff, yoff, res, xs, ys) = dsm_from_latlonalt(
        lats, lons, alts, dsm_path=pred, device=device)
    easts, norths, _, _ = latlon_to_utm(lats, lons)
    grid = dict(xoff=xoff, yoff=yoff, resolution=res, xsize=xs, ysize=ys)
    splat = lambda dv: rasterize_dsm(easts, norths, alts, device=dv,
                                     **grid)
    card_dsm = splat(device).cpu().numpy()
    cpu_dsm = splat("cpu").numpy()
    if not np.array_equal(np.isnan(card_dsm), np.isnan(cpu_dsm)):
        fail("the card's DSM splat has other empty cells than the CPU's")
    splat_err = float(np.nanmax(np.abs(card_dsm - cpu_dsm)))
    if not splat_err <= 1e-4:
        fail(f"DSM splat, card vs CPU: max abs err {splat_err} m")
    rec.update(splat_ms=cuda_ms(lambda: splat(device), 5),
               splat_max_abs_err_m=splat_err, dsm_cells=xs * ys,
               dsm_filled=int(np.isfinite(card_dsm).sum()))
    # registration + MAE, with compute_shift's inputs kept to time both
    # of its backends on them
    shift_args = []
    real_shift = registration.compute_shift
    registration.compute_shift = (
        lambda ref, sec, **kw: shift_args.append((ref, sec, kw))
        or real_shift(ref, sec, **kw))
    try:
        t0 = time.perf_counter()
        mae = compute_mae_and_save_dsm_diff(pred, view_rec.img_id, aoi_id,
                                            aoi["gt_dir"], tmp, 0,
                                            save=False)
        rec.update(mae_s=time.perf_counter() - t0, view_mae_m=mae)
    finally:
        registration.compute_shift = real_shift
    ref, sec, kw = shift_args[0]
    rec["registration_backend"] = registration.backend()
    shifts = {}
    for native in (True, False, True, False):
        tag = "native" if native else "numpy"
        t0 = time.perf_counter()
        shifts[tag] = real_shift(ref, sec, use_native=native, **kw)
        rec.setdefault(f"shift_{tag}_s", []).append(
            time.perf_counter() - t0)
    if (shifts["native"][:2] != shifts["numpy"][:2] or not np.allclose(
            shifts["native"][2:], shifts["numpy"][2:], rtol=0, atol=1e-9)):
        fail(f"registration: native {shifts['native']} vs numpy "
             f"{shifts['numpy']}")
    log(f"DSM splat of {n_view} points into {xs}x{ys} cells: "
        f"{rec['splat_ms']:.3f} ms (host float64 prep and copy "
        f"included), card vs CPU max abs err {splat_err:.3g} m, empty "
        f"cells equal; registration ({rec['registration_backend']}) + MAE "
        f"{rec['mae_s']:.3f} s, MAE {mae:.4f} m; compute_shift on the "
        f"{ref.shape} ROI: native {rec['shift_native_s']} s, numpy "
        f"{rec['shift_numpy_s']} s, both {shifts['numpy'][:2]}")

    # the known surface: the AOI's own ray-surface points of the view
    lidar, _ = read_geotiff(os.path.join(aoi["gt_dir"],
                                         f"{aoi_id}_DSM.tif"))
    t0 = time.perf_counter()
    pts2d, pts3d, _ = surface_points(view_rec.meta, lidar, aoi["roi"])
    rec["surface_s"] = time.perf_counter() - t0
    rays = sample["rays"][pts2d[:, 1] * width + pts2d[:, 0]]
    sdepth = np.linalg.norm(scene.norm.normalize_points(pts3d)
                            - rays[:, :3], axis=1)
    known = os.path.join(tmp, "known_dsm.tif")
    dsm_from_latlonalt(*scene.latlonalt_from_depth(rays, sdepth),
                       dsm_path=known, device=device)
    rec["known_surface_mae_m"] = compute_mae_and_save_dsm_diff(
        known, view_rec.img_id, aoi_id, aoi["gt_dir"], tmp, 0,
        save=False)
    log(f"known surface: {len(pts2d)} points of the test view "
        f"({rec['surface_s']:.1f} s to intersect), DSM MAE against the "
        f"AOI's lidar {rec['known_surface_mae_m']:.4f} m")
    if not rec["known_surface_mae_m"] < 0.05:
        fail(f"known-surface MAE {rec['known_surface_mae_m']} m")
    return rec


# the flagship and hash command lines of phase 13: CLI_FLAGS
# (`FLAGSHIP_CLI_FLAGS`, on AOI_ID) and the hash family's flags after them
HASH_ARGS = ["--encoding", "hash", "--img_downscale", "4"]
LPIPS_ATOL = 1e-5
RENDER_PSNR_ATOL = 1e-3
RENDER_SSIM_ATOL = 1e-4


def cli_pass(device, card, project, hold_hash, n_view=813 * 793):
    """Phase 13: the training CLI, resume, `tools render`, a hash run and
    the offline evaluation, on phase 12's AOI under `project`.
    hold_hash(trainer, state, data) holds B2 and B3 on the hash run's own
    inputs and returns its record. Returns the record it prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.cli.evaluate import _load_rgb
    from spnerf_torch.cli.evaluate import main as eval_main
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     render_config_from_args)
    from spnerf_torch.evaluation import registration
    from spnerf_torch.evaluation.lpips import LPIPS, weight_spec
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import chunk_size
    from spnerf_torch.tools import main as tools_main
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.train.loop import scene_to_device_arrays

    rec = {"card": card, "registration_backend": registration.backend()}
    spans = {"validation_s": [], "save_s": [], "restore_s": []}
    restored = []

    def timed_span(key, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    def snapshot(state):
        """The state's parameters and Adam moments, cloned."""
        out = {f"model.{k}": v.detach().clone()
               for k, v in state.model.state_dict().items()}
        for i, st in state.optimizer.state_dict()["state"].items():
            out.update({f"opt.{i}.{k}": v.detach().clone()
                        for k, v in st.items()})
        return out

    def equal(a, b, tag):
        if set(a) != set(b):
            fail(f"{tag}: other tensors {sorted(set(a) ^ set(b))}")
        for k in a:
            if not torch.equal(a[k].cpu(), b[k].cpu()):
                fail(f"{tag}: {k} differs")

    save, restore = CheckpointManager.save, CheckpointManager.restore
    validate = cli_train.run_validation

    def restore_spy(self, target, step=None):
        out = timed_span("restore_s", restore)(self, target, step)
        if out is not None:
            restored.append((out.step, snapshot(out)))
        return out

    CheckpointManager.save = timed_span("save_s", save)
    CheckpointManager.restore = restore_spy
    cli_train.run_validation = timed_span("validation_s", validate)

    def run(tag, fn):
        for k in dt.launches:
            dt.launches[k] = 0
        fe.FusedField.launches = 0
        for v in spans.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = {"s": time.perf_counter() - t0, "b1": fe.FusedField.launches,
             "b2": dt.launches["dtab_dense"], "b3": dt.launches["dtab_sorted"],
             **{k: list(v) for k, v in spans.items()}}
        rec[tag] = r
        log(f"{tag}: {json.dumps(r)}")
        return out

    def train_rows(exp):
        path = os.path.join(project, "output", exp, "logs", "metrics.jsonl")
        with open(path) as f:
            return [json.loads(ln) for ln in f]

    def ckpt_bytes(exp, step):
        return os.path.getsize(os.path.join(
            project, "output", exp, "ckpts", str(step), "state.pt"))

    base = CLI_FLAGS + ["--project_dir", project, "--device", str(device)]
    flagship = base + ["--exp_name", FLAGSHIP_EXP]
    try:
        # 1. the flagship run, 10 steps
        state10 = run("flagship_run", lambda: cli_train.main(
            flagship + ["--max_train_steps", "10"]))
        args = finalize_args(build_train_parser().parse_args(
            flagship + ["--max_train_steps", "10"]), make_dirs=False)
        rc = render_config_from_args(args)
        expect_b1 = 3 * -(-n_view // chunk_size(rc, args.chunk)) * 2
        r = rec["flagship_run"]
        if r["b1"] != expect_b1:
            fail(f"the flagship run's validation launched B1 {r['b1']} "
                 f"times, expected {expect_b1}")
        mgr = CheckpointManager(args.ckpts_dir)
        if mgr.all_steps() != [10]:
            fail(f"flagship checkpoints {mgr.all_steps()}, expected [10]")
        saved10 = snapshot(state10)
        rows = train_rows(FLAGSHIP_EXP)
        r["steps_per_s"] = [x["rays_per_sec"] / args.batch_size
                            for x in rows if x["split"] == "train"]
        r["ckpt_bytes"] = ckpt_bytes(FLAGSHIP_EXP, 10)
        del state10

        # 2. resume to 20
        restored.clear()
        state20 = run("flagship_resume", lambda: cli_train.main(
            flagship + ["--max_train_steps", "20", "--auto_resume"]))
        if [st for st, _ in restored] != [10]:
            fail(f"the resumed run restored steps {[st for st, _ in restored]}")
        equal(saved10, restored[0][1], "restored state vs saved state")
        r = rec["flagship_resume"]
        if r["b1"] != expect_b1 or state20.step != 20:
            fail(f"resume: B1 {r['b1']}, step {state20.step}")
        if mgr.all_steps() != [10, 20]:
            fail(f"flagship checkpoints {mgr.all_steps()}, expected [10, 20]")
        r["restored_step"] = restored[0][0]
        r["restored_tensors_equal"] = len(saved10)
        del state20, saved10
        restored.clear()

        # 3. render the best checkpoint
        best = mgr.best_step()
        out = run("render_best", lambda: tools_main([
            "render", "--run_dir", args.output_dir, "--step", "best",
            "--device", str(device), "--out_dir",
            os.path.join(project, "render_best")]))
        logged = [x for x in train_rows(FLAGSHIP_EXP)
                  if x["split"] == "val" and x["step"] == best][-1]
        r = rec["render_best"]
        r.update(step=out["step"], psnr=out["psnr"], ssim=out["ssim"],
                 logged_psnr=logged["psnr"], logged_ssim=logged["ssim"])
        if (out["step"] != best
                or not abs(out["psnr"] - logged["psnr"]) <= RENDER_PSNR_ATOL
                or not abs(out["ssim"] - logged["ssim"]) <= RENDER_SSIM_ATOL
                or r["b1"] != expect_b1):
            fail(f"render --step best: {json.dumps(r)}")

        # 4. the hash family, 10 steps at img_downscale 4
        hash_argv = base + HASH_ARGS + ["--exp_name", "hash",
                                        "--max_train_steps", "10"]
        hstate = run("hash_run", lambda: cli_train.main(hash_argv))
        r = rec["hash_run"]
        if (r["b2"], r["b3"]) != (3 * 10, 21 * 10):
            fail(f"the hash run launched B2 {r['b2']} and B3 {r['b3']} "
                 "times, expected 30 and 210")
        # the run's trainer and scene, rebuilt from its flags; the
        # checkpoint restored into it, then B2 and B3 held on this path's
        # own inputs (the loaded scene's rays, the restored state)
        hargs = finalize_args(build_train_parser().parse_args(hash_argv),
                              make_dirs=False)
        htr, hscene, _ = cli_train.build_trainer_and_scene(hargs, device)
        fresh = htr.init_state(torch.Generator().manual_seed(1))
        if CheckpointManager(hargs.ckpts_dir).restore(fresh) is None:
            fail("the hash run's checkpoint does not restore")
        equal(snapshot(hstate), restored[-1][1], "hash checkpoint")
        r["restore_s"] = list(spans["restore_s"])
        r["ckpt_bytes"] = ckpt_bytes("hash", 10)
        r["steps_per_s"] = [x["rays_per_sec"] / hargs.batch_size
                            for x in train_rows("hash")
                            if x["split"] == "train"]
        del hstate
        r["held"] = hold_hash(htr, fresh, htr.to_device(
            scene_to_device_arrays(hscene)))
        del fresh, htr, hscene
        restored.clear()
        torch.cuda.empty_cache()

        # 5. the offline evaluation of the flagship run's outputs
        means = run("eval", lambda: eval_main([
            "--project_dir", project, "--exp_name", FLAGSHIP_EXP,
            "--dataset_dir", os.path.join(project, "dataset", "DFC2019_269"),
            "--epoch_number", "0", "--skip_lpips", "--device", str(device)]))
        if not all(np.isfinite(means[k]) for k in ("psnr", "ssim", "mae")):
            fail(f"eval_torch --skip_lpips: {means}")
        rec["eval"]["means"] = {k: v if np.isfinite(v) else None
                                for k, v in means.items()}
    finally:
        CheckpointManager.save, CheckpointManager.restore = save, restore
        cli_train.run_validation = validate

    # LPIPS on the card against the CPU, random weights of the spec, on the
    # saved test view and its ground truth
    g = np.random.default_rng(0)
    weights = {k: (np.abs(g.normal(size=sh)) if k.startswith("lin")
                   else g.normal(size=sh) * 0.05).astype(np.float32)
               for k, sh in weight_spec().items()}
    pred = _load_rgb(os.path.join(project, "output", FLAGSHIP_EXP, "logs",
                                  "val", "rgb", f"{AOI_ID}_003_RGB_epoch0.tif"))
    gt = _load_rgb(os.path.join(project, "dataset", "DFC2019_269", "RGB",
                                AOI_ID, f"{AOI_ID}_003_RGB.tif"))
    t0 = time.perf_counter()
    on_card = float(LPIPS(weights, device)(pred, gt))
    rec["lpips_card_s"] = time.perf_counter() - t0
    on_cpu = float(LPIPS(weights, "cpu")(pred, gt))
    rec.update(lpips_card=on_card, lpips_cpu=on_cpu,
               lpips_abs_err=abs(on_card - on_cpu))
    if not abs(on_card - on_cpu) <= LPIPS_ATOL:
        fail(f"LPIPS card {on_card} vs CPU {on_cpu}")
    return rec


# phase 17's run: the flagship of phase 13 in float32 (the wgmma_f32
# kernel), and the width of the bf16 field rendered through the wide kernel
# beside it
FP32_EXP = "flagship_fp32"
FP32_ARGS = ["--precision", "fp32", "--max_train_steps", "10"]
WIDE_UNITS = 768


def fp32_pass(device, card, project, n_view=813 * 793):
    """Phase 17: the float32 CLI on phase 12's AOI under `project` (its
    ray cache): 10 flagship steps at --precision fp32, the final validation
    through the wgmma_f32 kernel, each launch of the test view's first and
    last chunk held, `tools render --step best` and `eval_torch.py
    --skip_lpips` on its outputs; then a bf16 field of fc_units WIDE_UNITS
    on the test view's first and last chunk. Returns the record it
    prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.cli.evaluate import main as eval_main
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     model_config_from_args,
                                     render_config_from_args)
    from spnerf_torch.models import load_model
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.tools import main as tools_main
    from spnerf_torch.train.checkpoints import CheckpointManager

    rec = {"card": card}
    argv = CLI_FLAGS + FP32_ARGS + ["--project_dir", project, "--device",
                                    str(device), "--exp_name", FP32_EXP]
    os.makedirs(os.path.join(project, "output", FP32_EXP), exist_ok=True)
    os.symlink(os.path.join(project, "output", FLAGSHIP_EXP, "cache"),
               os.path.join(project, "output", FP32_EXP, "cache"))

    def run(tag, fn):
        """fn(), its seconds and B1's launches by route (counts set to 0
        just before and read just after)."""
        reset_b1()
        for k in dt.launches:
            dt.launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = {"s": time.perf_counter() - t0, "b1": fe.FusedField.launches,
             "b1_routes": dict(fe.FusedField.route_launches),
             "b2": dt.launches["dtab_dense"], "b3": dt.launches["dtab_sorted"]}
        rec[tag] = r
        log(f"{tag}: {json.dumps(r)}")
        return out

    args = finalize_args(build_train_parser().parse_args(argv),
                         make_dirs=False)
    mc, rc = model_config_from_args(args), render_config_from_args(args)
    if (rc.compute_dtype != "float32"
            or fe.route(mc, "float32") != "wgmma_f32"):
        fail(f"--precision fp32: compute_dtype {rc.compute_dtype}, route "
             f"{fe.route(mc, rc.compute_dtype)}")
    chunk = chunk_size(rc, args.chunk)
    expect = 3 * -(-n_view // chunk) * 2
    routes = {"wgmma": 0, "general": 0, "wgmma_f32": expect, "wgmma_wide": 0}

    # (a) 10 steps at --precision fp32, validated through the wgmma_f32
    #     kernel
    state = run("run", lambda: cli_train.main(argv))
    r = rec["run"]
    with open(os.path.join(project, "output", FP32_EXP, "logs",
                           "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    r["val"] = {x["split"]: {k: x[k] for k in ("psnr", "ssim", "mae")}
                for x in rows if x["split"].startswith("val")}
    r["steps_per_s"] = [x["rays_per_sec"] / args.batch_size for x in rows
                        if x["split"] == "train"]
    r["loss"] = [x["loss"] for x in rows if x["split"] == "train"]
    if r["b1_routes"] != routes or r["b2"] or r["b3"]:
        fail(f"the float32 run launched B1 {r['b1_routes']} (expected "
             f"{expect} wgmma_f32), B2 {r['b2']}, B3 {r['b3']}")
    if not np.isfinite(r["val"]["val"]["mae"]):
        fail(f"the float32 run's MAE: {r['val']}")

    # each launch of the test view's first and last chunk on its own
    # inputs, against the plain float32 version
    _, scene, _ = cli_train.build_trainer_and_scene(args, device)
    view = scene.val_images[-1]
    sample = scene.load_val_image(view, with_sem=True)
    rays, sems = sample["rays"], sample["sems"]
    n_chunks = -(-n_view // chunk)
    slices = {"first": slice(0, chunk),
              "last": slice((n_chunks - 1) * chunk, n_view)}
    render = build_render_fn(state.model, rc, state.t_embed, chunk=args.chunk)
    r["held"] = {}
    for tag, sl in slices.items():
        r["held"][tag] = hold_b1_launches(
            lambda: render(rays[sl], 0, sems[sl]), f"float32 run, {tag} chunk")
        if r["held"][tag]["routes"] != ["wgmma_f32"]:
            fail(f"float32 run, {tag} chunk: routes {r['held'][tag]}")
    r["launch_max_abs_err"] = max(h["max_abs_err"] for h in r["held"].values())
    log(f"float32 run: 10 steps in {r['s']:.1f} s, MAE "
        f"{r['val']['val']['mae']:.4f} m, B1 {json.dumps(r['b1_routes'])}, "
        f"each held launch within {r['launch_max_abs_err']:.3g} of the plain "
        f"float32 version (F32_ATOL {F32_ATOL}) ({card})")
    del state, render

    # (b) the best checkpoint re-rendered, and the offline evaluation
    best = CheckpointManager(args.ckpts_dir).best_step()
    out = run("render_best", lambda: tools_main([
        "render", "--run_dir", args.output_dir, "--step", "best", "--device",
        str(device), "--out_dir", os.path.join(project, "render_fp32")]))
    logged = [x for x in rows if x["split"] == "val" and x["step"] == best][-1]
    r = rec["render_best"]
    r.update(step=out["step"], psnr=out["psnr"], ssim=out["ssim"],
             logged_psnr=logged["psnr"], logged_ssim=logged["ssim"])
    if (out["step"] != best
            or not abs(out["psnr"] - logged["psnr"]) <= RENDER_PSNR_ATOL
            or not abs(out["ssim"] - logged["ssim"]) <= RENDER_SSIM_ATOL
            or r["b1_routes"] != routes):
        fail(f"render --step best of the float32 run: {json.dumps(r)}")
    means = run("eval", lambda: eval_main([
        "--project_dir", project, "--exp_name", FP32_EXP, "--dataset_dir",
        os.path.join(project, "dataset", "DFC2019_269"), "--epoch_number",
        "0", "--skip_lpips", "--device", str(device)]))
    if not all(np.isfinite(means[k]) for k in ("psnr", "ssim", "mae")):
        fail(f"eval_torch --skip_lpips on the float32 run: {means}")
    rec["eval"]["means"] = {k: v if np.isfinite(v) else None
                            for k, v in means.items()}

    # (c) a bf16 field of fc_units WIDE_UNITS (random weights) through the
    #     wide kernel on the test view's first and last chunk, its
    #     launches counted (counts set to 0 just before each render and read
    #     just after, before the launches that hold it)
    wc = replace(mc, fc_units=WIDE_UNITS)
    wrc = replace(rc, compute_dtype="bfloat16")
    if fe.route(wc, "bfloat16") != "wgmma_wide":
        fail(f"fc_units {WIDE_UNITS} in bf16 routes to {fe.route(wc, 'bfloat16')}")
    wide = load_model(wc, "bfloat16", device=device,
                      generator=torch.Generator().manual_seed(WIDE_UNITS))
    render = build_render_fn(wide, wrc, chunk=args.chunk)
    plain = build_render_fn(wide, wrc, chunk=args.chunk, field="plain")
    plain32 = build_render_fn(wide, rc, chunk=args.chunk, field="plain")
    w = rec["wide"] = {"fc_units": WIDE_UNITS, "launches": 0}
    for tag, sl in slices.items():
        outs, counts = [], []

        def wide_render():
            reset_b1()
            outs.append(render(rays[sl], 0, sems[sl]))
            counts.append(dict(fe.FusedField.route_launches))

        held = hold_b1_launches(wide_render,
                                f"bf16 fc_units {WIDE_UNITS}, {tag} chunk")
        if (held["routes"] != ["wgmma_wide"] or held["launches_held"] != 3
                or counts[0] != {"wgmma": 0, "general": 0, "wgmma_f32": 0,
                                 "wgmma_wide": 3}):
            fail(f"bf16 fc_units {WIDE_UNITS}, {tag} chunk: B1 {held}, "
                 f"launches {counts}")
        w["launches"] += counts[0]["wgmma_wide"]
        out, ref, ctl = (outs[0], plain(rays[sl], 0, sems[sl]),
                         plain32(rays[sl], 0, sems[sl]))
        errs = {"launch_max_abs_err": held["max_abs_err"]}
        for k, v in ref.items():
            p99, mx = p99_max(out[k], v)
            c99, cmx = p99_max(out[k], ctl[k])
            errs[k] = {"p99": p99, "max": mx, "control_p99": c99,
                       "control_max": cmx}
            log(f"  bf16 fc_units {WIDE_UNITS}, {tag} chunk "
                f"({len(rays[sl])} rays), {k}: kernel vs plain render p99 "
                f"{p99:.3g}, max {mx:.3g}; control (vs plain float32) p99 "
                f"{c99:.3g}, max {cmx:.3g}")
            if not (p99 <= RENDER_P99 and mx <= RENDER_MAX):
                fail(f"bf16 fc_units {WIDE_UNITS}, {tag} chunk, {k}: the "
                     f"wide kernel's render disagrees with the plain "
                     f"render")
        w[tag] = errs
    w["launch_max_abs_err"] = max(w[t]["launch_max_abs_err"] for t in slices)
    return rec


# phase 19's run: phase 13's flagship flags at the widest field the wide
# kernel takes, on the AOI at a quarter of its size (phase 13's hash run
# cached its rays), and the width of the float32 view beside it
WIDE_EXP = "wide1024"
WIDE_ARGS = ["--fc_units", "1024", "--img_downscale", "4",
             "--max_train_steps", "10"]
WIDE_VIEW_UNITS = 1024


def wide_pass(device, card, project, n_view=N_VIEW):
    """Phase 19: the training CLI at fc_units 1024 in bf16 on phase 12's
    AOI under `project` (the ray cache of phase 13's `--img_downscale 4`
    run), 10 steps and the final validation through the wide kernel, each
    launch of the test view's first chunk held (KERNEL_ATOL; past it, every
    output within WIDE_CONTROL_SHARE of its plain float32 control and
    within TC_CONTROL_SHARE of its tensor-core control), and that chunk's
    render beside both controls' renders; then
    phase 4's view with a WIDE_VIEW_UNITS-wide
    float32 field through the wide and the general kernel in turns, held
    on its first and its ragged last chunk against the plain float32
    render. Returns the record it prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     model_config_from_args,
                                     render_config_from_args)
    from spnerf_torch.models import load_model
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.utils.synth import fake_batch, flagship_configs

    rec = {"card": card}
    argv = CLI_FLAGS + WIDE_ARGS + ["--project_dir", project, "--device",
                                    str(device), "--exp_name", WIDE_EXP]
    os.makedirs(os.path.join(project, "output", WIDE_EXP), exist_ok=True)
    os.symlink(os.path.join(project, "output", "hash", "cache"),
               os.path.join(project, "output", WIDE_EXP, "cache"))
    args = finalize_args(build_train_parser().parse_args(argv),
                         make_dirs=False)
    mc, rc = model_config_from_args(args), render_config_from_args(args)
    units = int(WIDE_ARGS[WIDE_ARGS.index("--fc_units") + 1])
    if (mc.fc_units != units or rc.compute_dtype != "bfloat16"
            or fe.route(mc, rc.compute_dtype) != "wgmma_wide"):
        fail(f"--fc_units {units}: compute_dtype {rc.compute_dtype}, route "
             f"{fe.route(mc, rc.compute_dtype)}")
    chunk = chunk_size(rc, args.chunk)

    # (a) 10 steps at fc_units 1024, validated through the wide kernel; its
    #     launches counted by route (counts set to 0 just before the run and
    #     read just after)
    reset_b1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = cli_train.main(argv)
    torch.cuda.synchronize()
    r = rec["run"] = {"s": time.perf_counter() - t0,
                      "b1": fe.FusedField.launches,
                      "b1_routes": dict(fe.FusedField.route_launches)}
    with open(os.path.join(project, "output", WIDE_EXP, "logs",
                           "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    r["loss"] = [x["loss"] for x in rows if x["split"] == "train"]
    r["steps_per_s"] = [x["rays_per_sec"] / args.batch_size for x in rows
                        if x["split"] == "train"]
    r["val"] = {x["split"]: {k: x[k] for k in ("psnr", "ssim", "mae")}
                for x in rows if x["split"].startswith("val")}
    _, scene, _ = cli_train.build_trainer_and_scene(args, device)
    samples = [scene.load_val_image(v, with_sem=True)
               for v in scene.val_images]
    expect = sum(3 * -(-len(smp["rays"]) // chunk) for smp in samples)
    routes = {k: 0 for k in fe.ROUTES} | {"wgmma_wide": expect}
    r["expected_launches"] = expect
    if (r["b1_routes"] != routes or not r["loss"]
            or not np.isfinite(r["loss"]).all()
            or not np.isfinite(r["val"]["val"]["psnr"])
            or not np.isfinite(r["val"]["val"]["mae"])):
        fail(f"the fc_units {units} run: B1 {r['b1_routes']} (expected "
             f"{expect} wgmma_wide), losses {r['loss']}, {r['val']}")
    rays, sems = samples[-1]["rays"][:chunk], samples[-1]["sems"][:chunk]
    render = build_render_fn(state.model, rc, state.t_embed, chunk=args.chunk)
    outs = []
    r["held"] = hold_b1_launches(lambda: outs.append(render(rays, 0, sems)),
                                 f"fc_units {units} run, first chunk",
                                 controls=True,
                                 control_share=WIDE_CONTROL_SHARE,
                                 tc_share=TC_CONTROL_SHARE)
    if r["held"]["routes"] != ["wgmma_wide"]:
        fail(f"fc_units {units} run, first chunk: {r['held']}")
    # the first chunk's render against the plain render, beside its float32
    # and its tensor-core control (recorded; the launches carry the bars)
    r["render"] = hold_b1.render_rows(outs[0], *(
        build_render_fn(state.model, c, state.t_embed, chunk=args.chunk,
                        field="plain")
        for c in (rc, replace(rc, compute_dtype="float32"))), rays, 0, sems)
    log(f"fc_units {units} run: 10 steps and validation in {r['s']:.1f} s, "
        f"B1 {json.dumps(r['b1_routes'])}, val {json.dumps(r['val'])}, held "
        f"launches within {r['held']['max_abs_err']:.3g}; past KERNEL_ATOL "
        f"at most {r['held']['max_ratio_past_atol']} of the plain float32 "
        f"control and {r['held']['max_tc_ratio_past_atol']} of the "
        f"tensor-core control; each output's largest distances "
        f"{json.dumps(r['held']['by_output'])}; the first chunk's render "
        f"{json.dumps(r['render'])} ({card})")
    del state, render, scene, samples
    torch.cuda.empty_cache()

    # (b) phase 4's view with a WIDE_VIEW_UNITS-wide float32 field, through
    #     the wide kernel and through the general kernel in turns
    fmc, frc = flagship_configs()
    wmc = replace(fmc, fc_units=WIDE_VIEW_UNITS)
    rc32 = replace(frc, compute_dtype="float32")
    model = load_model(wmc, "float32", device=device,
                       generator=torch.Generator().manual_seed(0))
    if fe.route(wmc, "float32") != "wgmma_wide":
        fail(f"float32 fc_units {WIDE_VIEW_UNITS} routes to "
             f"{fe.route(wmc, 'float32')}")
    batch = fake_batch(np.random.default_rng(0), n_view)
    vrays = torch.from_numpy(batch["rays"]).to(device)
    vsems = torch.from_numpy(batch["sems"]).to(device)
    vchunk = chunk_size(rc32)
    n_chunks = -(-n_view // vchunk)
    # the first and the ragged last chunk, against the plain float32 render
    held = {"first": slice(0, vchunk),
            "last": slice((n_chunks - 1) * vchunk, n_view)}
    plain_fn = build_render_fn(model, rc32, field="plain")
    plain32 = {tag: plain_fn(vrays[sl], 0, vsems[sl])
               for tag, sl in held.items()}
    renders = {"wgmma_wide": build_render_fn(model, rc32),
               "general": general_render_fn(model, rc32)}
    v = rec["view"] = {"fc_units": WIDE_VIEW_UNITS, "rays": n_view,
                       "chunks": n_chunks}
    for name, fn in renders.items():
        reset_b1()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(vrays, 0, vsems)
        end.record()
        torch.cuda.synchronize()
        routes = dict(fe.FusedField.route_launches)
        want = {k: 0 for k in fe.ROUTES} | {name: 3 * n_chunks}
        if routes != want:
            fail(f"the float32 fc_units {WIDE_VIEW_UNITS} view on {name} "
                 f"launched {routes}")
        for k, x in out.items():
            if x.shape[0] != n_view or not torch.isfinite(x).all():
                fail(f"{name} view {k}: shape {tuple(x.shape)} or non-finite")
        err = max((out[k][sl] - plain32[tag][k]).abs().max().item()
                  for tag, sl in held.items() for k in plain32[tag])
        if not err <= F32_ATOL:
            fail(f"the float32 fc_units {WIDE_VIEW_UNITS} view on {name}: "
                 f"{err} from the plain float32 render on its first and "
                 f"last chunk")
        v[name] = {"ms": start.elapsed_time(end), "launches": routes[name],
                   "max_abs_err": err}
        del out
    log(f"float32 fc_units {WIDE_VIEW_UNITS} view ({n_view} rays): "
        f"{json.dumps(v)} ({card})")
    return rec


# phase 20: the least launches of the wide kernel's soak
SOAK_LAUNCHES_MIN = 20_000


def soak_pass(device, card):
    """Phase 20: one schedule of `spnerf_torch.utils.wide_checks.soak`
    (the wide kernel through `fused_field_wide` at 768 and 1024, bf16 and
    float32, all heads and the solar pass's, n from 1 to 374,976: each
    input's first launch held against the plain version, every later one
    equal to it bit for bit), its launches counted (counts set to 0 just
    before and read just after). Returns the record it prints."""
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.utils import wide_checks

    reset_b1()
    try:
        r = wide_checks.soak(device, seed=0, log=log)
    except hold_b1.B1Mismatch as e:
        fail(str(e))
    r["route_launches"] = dict(fe.FusedField.route_launches)
    r["card"] = card
    log(f"wide kernel soak: {r['launches']} launches, "
        f"{r['meetings_reckoned']} cluster meetings (reckoned from n), "
        f"{r['mismatches']} bit mismatches, {r['traps']} "
        f"traps in {r['s']:.1f} s (reckoned {r['reckoned']['seconds']:.1f} "
        f"s with its set-up); first launches within "
        f"{r['max_abs_err_first']:.3g} of the plain version ({card})")
    want = {k: 0 for k in fe.ROUTES} | {"wgmma_wide": r["scheduled"]}
    if (r["traps"] or r["mismatches"] or r["launches"] < SOAK_LAUNCHES_MIN
            or r["route_launches"] != want):
        fail(f"the wide kernel's soak: {json.dumps(r)}")
    return r


# phase 21: B1's wide route on clusters of 4 and 8 CTAs and with semantic
# heads of more than 16 classes. Widths of each cluster size (1,536 and
# 2,048 on 4 CTAs, 3,072 and 4,096 on 8), their launches' points (a whole
# number of tiles and a ragged odd count), the 150-class fields (ADE20K's
# count: 1,024 in bf16, 512 in float32, both on clusters of two), the CLI
# run at 2,048 (phase 13's flagship flags, 3 steps, its validation at a
# sixty-fourth of the AOI's pixels: the views' rays are the path, the
# training only gives the field its weights) and the timed launches'
# points
CLUSTER_WIDTHS = (1536, 2048, 3072, 4096)
CLUSTER_POINTS = (8_192, 9_217)
SEM_FIELDS = ((1024, "bfloat16"), (512, "float32"))
SEM_CLASSES = 150
CLUSTER_EXP = "wide2048"
CLUSTER_ARGS = ["--fc_units", "2048", "--img_downscale", "8",
                "--max_train_steps", "3"]
CLUSTER_BATCHES = (1024, 512, 256)  # halved where the step does not fit
CLUSTER_TIMED = (2048, 4096)
N_TIME = 65_536


def cluster_pass(device, card, project):
    """Phase 21: the wide route on clusters of 4 and 8 CTAs and with wide
    semantic heads. (a) every width of CLUSTER_WIDTHS in both dtypes (random
    weights), all heads and the solar pass's, on CLUSTER_POINTS points:
    each launch held against the plain version (KERNEL_ATOL; F32_ATOL)
    and equal bit for bit to a second one; (b) the same for SEM_FIELDS at
    SEM_CLASSES classes; (c) the training CLI at --fc_units 2048 in bf16 on
    phase 12's AOI under `project`, 3 steps (the batch halved where the step
    does not fit the card), its validation through the wide kernel on
    clusters of 4 (launches counted by route), every launch of a
    validation pass's render held under the bar of a trained field
    (KERNEL_ATOL; past it, within WIDE_CONTROL_SHARE of the plain float32
    control and TC_CONTROL_SHARE of the tensor-core control, which are
    taken only for such a launch), then `tools
    render --step best` (its launches counted, its PSNR and SSIM the
    logged ones); (d) the all-head launch at CLUSTER_TIMED widths in both
    dtypes on N_TIME points, timed beside its tensor-core bound, the plain
    version, `gemm_ms`, `gemm_ms_f32` and the float32 module (`wide_times`
    and `yardsticks`, as phase 5's); (e) the
    clusters of each size that fit the card. Returns the record it
    prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     model_config_from_args,
                                     render_config_from_args)
    from spnerf_torch.models import load_model
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import build_render_fn, chunk_size, module_at
    from spnerf_torch.tools import main as tools_main
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.utils.synth import flagship_configs

    rec = {"card": card, "clusters": {}, "held": {}}
    fmc, frc = flagship_configs()
    for width, c in ((1024, 2), (2048, 4), (4096, 8)):
        for dtype in ("bfloat16", "float32"):
            rec["clusters"][f"{dtype} {width} on {c}"] = fe.wide_clusters(
                width, dtype, c)
    log(f"wide kernel: clusters that fit the card at once by size "
        f"{json.dumps(rec['clusters'])} ({card})")
    if min(rec["clusters"].values()) < 1:
        fail(f"a cluster size of the wide kernel does not fit: "
             f"{rec['clusters']}")

    def held_twice(pk, dtype, n, heads, tag):
        """One launch against the plain version and a second one, equal bit
        for bit; counted on the wide route. Returns the max abs error."""
        xyz, sun, sems = field_inputs(n, n + pk.cfg.fc_units, device,
                                      pk.cfg.num_sem_classes)
        args = (xyz, sun, None, sems)
        before = fe.FusedField.route_launches["wgmma_wide"]
        field = fe.FusedField(pk, dtype)
        a = field(*args, heads=heads)
        b = field(*args, heads=heads)
        torch.cuda.synchronize()
        if fe.FusedField.route_launches["wgmma_wide"] != before + 2:
            fail(f"{tag}: not two launches on the wide route")
        ref = fe.PlainField(pk, dtype)(*args, heads=heads)
        atol = F32_ATOL if dtype == "float32" else KERNEL_ATOL
        err = 0.0
        for k in ref:
            e = (a[k] - ref[k]).abs().max().item()
            if not (e <= atol) or not torch.isfinite(a[k]).all():
                fail(f"{tag} {k}: max abs err {e} > {atol}")
            if not torch.equal(a[k], b[k]):
                fail(f"{tag} {k}: a second launch differs")
            err = max(err, e)
        return err

    # (a), (b) the clusters of 4 and 8, and the 150-class heads
    cases = ([(w, dtype, fmc.num_sem_classes) for w in CLUSTER_WIDTHS
              for dtype in ("bfloat16", "float32")]
             + [(w, dtype, SEM_CLASSES) for w, dtype in SEM_FIELDS])
    reset_b1()
    for width, dtype, classes in cases:
        cfg = replace(fmc, fc_units=width, num_sem_classes=classes)
        pk = fe.pack_params(load_model(
            cfg, dtype, device=device,
            generator=torch.Generator().manual_seed(width + classes)), dtype)
        want = 2 if width <= 1024 else 4 if width <= 2048 else 8
        if pk.route != "wgmma_wide" or pk.cluster != want:
            fail(f"{dtype} fc_units {width}, {classes} classes: packed for "
                 f"{pk.route} on clusters of {pk.cluster}")
        tag = f"{dtype} {width} {classes} classes on {pk.cluster}"
        rec["held"][tag] = max(
            held_twice(pk, dtype, n, heads, f"{tag}, n={n}, {h}")
            for n in CLUSTER_POINTS
            for h, heads in (("all", fe.ALL_HEADS), ("sun", ("sun",))))
        del pk
        torch.cuda.empty_cache()
    rec["launches_held"] = fe.FusedField.route_launches["wgmma_wide"]
    log(f"wide kernel on clusters of 4 and 8 and at {SEM_CLASSES} classes, "
        f"{rec['launches_held']} launches, each equal bit for bit to a "
        f"second one: max abs err {json.dumps(rec['held'])} ({card})")

    # (c) the CLI at fc_units 2048, its validation and tools render
    units = int(CLUSTER_ARGS[CLUSTER_ARGS.index("--fc_units") + 1])
    r = rec["run"] = {"fc_units": units, "tried": []}
    state = None
    for batch in CLUSTER_BATCHES:
        exp = f"{CLUSTER_EXP}_b{batch}"
        argv = CLI_FLAGS + CLUSTER_ARGS + [
            "--batch_size", str(batch), "--project_dir", project, "--device",
            str(device), "--exp_name", exp]
        args = finalize_args(build_train_parser().parse_args(argv),
                             make_dirs=False)
        mc, rc = model_config_from_args(args), render_config_from_args(args)
        r["cluster"] = fe.wide_cluster(units)
        if (mc.fc_units != units or rc.compute_dtype != "bfloat16"
                or fe.route(mc, rc.compute_dtype) != "wgmma_wide"
                or (units == 2048 and r["cluster"] != 4)):
            fail(f"--fc_units {units}: compute_dtype {rc.compute_dtype}, "
                 f"route {fe.route(mc, rc.compute_dtype)} on clusters of "
                 f"{r['cluster']}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reset_b1()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state = cli_train.main(argv)
        except torch.cuda.OutOfMemoryError as e:
            r["tried"].append({"batch": batch, "error": str(e)[:200]})
            log(f"fc_units {units} at batch {batch}: out of memory")
            state = None
            continue
        torch.cuda.synchronize()
        r.update(batch=batch, s=time.perf_counter() - t0,
                 peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                 b1=fe.FusedField.launches,
                 b1_routes=dict(fe.FusedField.route_launches))
        break
    if state is None:
        fail(f"fc_units {units}: no batch of {CLUSTER_BATCHES} fits")
    with open(os.path.join(project, "output", exp, "logs",
                           "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    r["loss"] = [x["loss"] for x in rows if x["split"] == "train"]
    r["val"] = {x["split"]: {k: x[k] for k in ("psnr", "ssim", "mae")}
                for x in rows if x["split"].startswith("val")}
    trainer, scene, _ = cli_train.build_trainer_and_scene(args, device)
    samples = [scene.load_val_image(v, with_sem=True)
               for v in scene.val_images]
    chunk = chunk_size(rc, args.chunk)
    expect = sum(3 * -(-len(s["rays"]) // chunk) for s in samples)
    routes = {k: 0 for k in fe.ROUTES} | {"wgmma_wide": expect}
    r["expected_launches"] = expect
    if (r["b1_routes"] != routes or not r["loss"]
            or not np.isfinite(r["loss"]).all()
            or not np.isfinite(r["val"]["val"]["psnr"])
            or not np.isfinite(r["val"]["val"]["mae"])):
        fail(f"the fc_units {units} run: B1 {r['b1_routes']} (expected "
             f"{expect} wgmma_wide), losses {r['loss']}, {r['val']}")
    # every launch of the validation views' render, each on its own inputs
    render = build_render_fn(state.model, rc, state.t_embed, chunk=args.chunk)
    r["held"] = hold_b1_launches(
        lambda: [render(s["rays"], 0, s["sems"]) for s in samples],
        f"fc_units {units} run, validation views",
        control_share=WIDE_CONTROL_SHARE, tc_share=TC_CONTROL_SHARE)
    if (r["held"]["routes"] != ["wgmma_wide"]
            or r["held"]["launches_held"] != expect):
        fail(f"fc_units {units} run, validation views: {r['held']}")
    log(f"fc_units {units} run (clusters of {r['cluster']}): "
        f"{args.max_train_steps} steps at "
        f"batch {r['batch']} and validation in {r['s']:.1f} s, peak "
        f"{r['peak_gb']:.2f} GB, B1 {json.dumps(r['b1_routes'])}, val "
        f"{json.dumps(r['val'])}; {r['held']['launches_held']} launches "
        f"held within {r['held']['max_abs_err']:.3g}; past KERNEL_ATOL at "
        f"most {r['held']['max_ratio_past_atol']} of the plain float32 "
        f"control and {r['held']['max_tc_ratio_past_atol']} of the "
        f"tensor-core control; each output's largest distances "
        f"{json.dumps(r['held']['by_output'])} ({card})")
    del state, render, trainer, scene, samples
    torch.cuda.empty_cache()
    best = CheckpointManager(args.ckpts_dir).best_step()
    reset_b1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tools_main(["render", "--run_dir", args.output_dir, "--step",
                      "best", "--device", str(device), "--out_dir",
                      os.path.join(project, "render_wide2048")])
    torch.cuda.synchronize()
    logged = [x for x in rows if x["split"] == "val" and x["step"] == best][-1]
    rb = rec["render_best"] = {
        "s": time.perf_counter() - t0, "step": out["step"],
        "psnr": out["psnr"], "ssim": out["ssim"],
        "logged_psnr": logged["psnr"], "logged_ssim": logged["ssim"],
        "b1_routes": dict(fe.FusedField.route_launches)}
    if (out["step"] != best or rb["b1_routes"] != routes
            or not abs(out["psnr"] - logged["psnr"]) <= RENDER_PSNR_ATOL
            or not abs(out["ssim"] - logged["ssim"]) <= RENDER_SSIM_ATOL):
        fail(f"render --step best of the fc_units {units} run: "
             f"{json.dumps(rb)}")
    log(f"fc_units {units} tools render --step best: {json.dumps(rb)}")

    # (d) the all-head launch at 2048 and 4096, timed beside its bound and
    #     the yardsticks
    times = rec["times"] = {}
    for width in CLUSTER_TIMED:
        cfg = replace(fmc, fc_units=width)
        xyz, sun, sems = field_inputs(N_TIME, 3, device, cfg.num_sem_classes)
        args = (xyz, sun, None, sems)
        t = times[str(width)] = {"n": N_TIME,
                                 "cluster": fe.wide_cluster(width)}
        module = None
        for dtype in ("bfloat16", "float32"):
            model = load_model(cfg, dtype, device=device,
                               generator=torch.Generator().manual_seed(0))
            pk = fe.pack_params(model, dtype)
            d = t[dtype] = wide_times(pk, dtype, args, fe.ALL_HEADS,
                                      2 if dtype == "bfloat16" else 1)
            d["share_of_bound"] = d["bound_ms"] / d["ms"]
            if dtype == "float32":
                module = module_at(model, "float32")
            del model, pk
            torch.cuda.empty_cache()
        t.update(yardsticks(cfg, fe.ALL_HEADS, args, module, device))
        del module, args, xyz, sun, sems
        torch.cuda.empty_cache()
        b16, f32 = t["bfloat16"], t["float32"]
        log(f"field_eval wgmma_wide fc_units {width} (clusters of "
            f"{t['cluster']}), all heads on {N_TIME} points: bf16 "
            f"{b16['ms']:.3f} ms (device {b16['device_ms']} ms; "
            f"{b16['share_of_bound']:.1%} of its bound "
            f"{b16['bound_ms']:.3f}), float32 {f32['ms']:.3f} ms (device "
            f"{f32['device_ms']} ms; {f32['share_of_bound']:.1%} of "
            f"{f32['bound_ms']:.3f}); plain "
            f"{t['bfloat16']['plain_ms']:.3f} / {t['float32']['plain_ms']:.3f}"
            f" ms, bf16 matmuls alone {t['gemm_ms']:.3f} ms, float32 "
            f"{t['gemm_ms_f32']:.3f} ms, float32 module {t['module_ms']:.3f}"
            f" ms ({card})")
    return rec


# phase 14's runs: the occupancy-grid flagship (the JAX package's fast
# preset, at 10 steps), a multi-AOI hash run, a fine-pass and a proposal
# flagship run, each as the training CLI takes it
OCC_ARGS = ["--n_samples", "32", "--occgrid"]
MULTI_ARGS = ["--encoding", "hash", "--img_downscale", "4", "--aoi_id",
              f"{AOI_ID},{AOI_ID}"]
FINE_ARGS = ["--n_importance", "64", "--img_downscale", "4"]
# the proposal sampler without depth supervision and guided sampling
PROPOSAL_DROP = ("--guidedsample", "--depth")
PROPOSAL_ARGS = ["--proposal", "--img_downscale", "4"]


def paths_pass(device, card, project, hold_hash, hold_proposal,
               n_view=813 * 793):
    """Phase 14: the other render paths through the training CLI on phase
    12's AOI under `project` (the rays cached by phases 12 and 13):
    (a) the occupancy-grid flagship, its validation through B1 with the
    trained grid, B1 held on the grid-placed test view's first and last
    chunk and one grid refresh card vs CPU; (b) a multi-AOI hash run, every
    B2 and B3 call of one step held on its frame-XORed ids, per-AOI MAEs,
    B1 on the second frame's points; (c) the fine pass and (d) the proposal
    sampler, whose validations take the module (no B1 launch), with every
    proposal-table B2 call of one step held. hold_hash(trainer, state,
    data) and hold_proposal(trainer, state, data) hold the table-gradient
    calls. Returns the record it prints."""
    import copy

    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     render_config_from_args)
    from spnerf_torch.models import load_model
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.ops.occgrid import update_grid
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.train.loop import scene_to_device_arrays
    from spnerf_torch.utils.synth import flagship_configs

    rec = {"card": card}
    base = CLI_FLAGS + ["--project_dir", project, "--device", str(device)]

    def argv(exp, extra, drop=()):
        return ([a for a in base if a not in drop] + extra
                + ["--exp_name", exp])

    def link_cache(exp, src):
        """The run's ray cache is `src`'s (same images, same scale)."""
        os.makedirs(os.path.join(project, "output", exp), exist_ok=True)
        os.symlink(os.path.join(project, "output", src, "cache"),
                   os.path.join(project, "output", exp, "cache"))

    def run(tag, args):
        """main(args), its seconds and the kernels' launches (counts set
        to 0 just before and read just after)."""
        for k in dt.launches:
            dt.launches[k] = 0
        fe.FusedField.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cli_train.main(args)
        torch.cuda.synchronize()
        r = {"s": time.perf_counter() - t0, "b1": fe.FusedField.launches,
             "b2": dt.launches["dtab_dense"], "b3": dt.launches["dtab_sorted"]}
        rows = os.path.join(project, "output", args[args.index("--exp_name")
                                                    + 1], "logs",
                            "metrics.jsonl")
        with open(rows) as f:
            r["val"] = {x["split"]: {k: x[k] for k in ("psnr", "ssim", "mae")}
                        for x in map(json.loads, f)
                        if x["split"].startswith(("train_", "val"))}
        rec[tag] = r
        log(f"{tag}: {json.dumps(r)}")
        return state, finalize_args(build_train_parser().parse_args(args),
                                    make_dirs=False)

    def hold_launches(tag, model, rc, t_embed, rays, sems, **kw):
        """B1 against its plain version on the field inputs of every launch
        of a render of `rays`, within KERNEL_ATOL; their max abs errors."""
        seen = []
        real = fe.FusedField.__call__

        def recording(self, xyz, sun_d, t_emb=None, sem_labels=None,
                      heads=None):
            seen.append((self.packed, xyz, sun_d, t_emb, sem_labels, heads))
            return real(self, xyz, sun_d, t_emb, sem_labels, heads=heads)

        fe.FusedField.__call__ = recording
        try:
            build_render_fn(model, rc, t_embed)(rays, 0, sems, **kw)
        finally:
            fe.FusedField.__call__ = real
        if not seen:
            fail(f"{tag}: the render launched no B1")
        errs = []
        for packed, xyz, sun, t_emb, sem, heads in seen:
            out = fe.FusedField(packed)(xyz, sun, t_emb, sem, heads=heads)
            ref = fe.PlainField(packed)(xyz, sun, t_emb, sem, heads=heads)
            errs.append(max((out[k] - ref[k]).abs().max().item()
                            for k in ref))
            if not errs[-1] <= KERNEL_ATOL:
                fail(f"{tag}: B1 launch on {xyz.shape[0]} points, heads "
                     f"{heads}: max abs err {errs[-1]} > {KERNEL_ATOL}")
        log(f"{tag}: {len(errs)} B1 launches on their own inputs, max abs "
            f"err {errs} (KERNEL_ATOL {KERNEL_ATOL})")
        return errs

    def hold_views(tag, model, rc, t_embed, rays, sems, slices,
                   below_control=False, **kw):
        """B1's render of `rays` against the plain render on each slice:
        per-ray p99 of every output within RENDER_P99, the max within
        RENDER_MAX; with below_control, the max of every output but the
        depth within that of the plain float32 render (the control) where
        it exceeds RENDER_MAX. Then each launch of the first slice's render
        on its own inputs (`hold_launches`)."""
        fe.FusedField.launches = 0
        out = build_render_fn(model, rc, t_embed)(rays, 0, sems, **kw)
        torch.cuda.synchronize()
        launches = fe.FusedField.launches
        plain = build_render_fn(model, rc, t_embed, field="plain")
        plain32 = build_render_fn(model, replace(rc, compute_dtype="float32"),
                                  t_embed, field="plain")
        errs = {}
        for name, sl in slices.items():
            ref, ctl = plain(rays[sl], 0, sems[sl], **kw), plain32(
                rays[sl], 0, sems[sl], **kw)
            for k, v in ref.items():
                p99, mx = p99_max(out[k][sl], v)
                c99, cmx = p99_max(ctl[k], v)
                bound = (max(RENDER_MAX, cmx) if below_control
                         and not k.startswith("depth") else RENDER_MAX)
                errs[f"{name}.{k}"] = {"p99": p99, "max": mx,
                                       "control_p99": c99, "control_max": cmx,
                                       "max_bound": bound}
                log(f"  {tag}, {name} chunk, {k}: B1 vs plain render p99 "
                    f"{p99:.3g}, max {mx:.3g} (bound {bound:.3g}); control "
                    f"(plain float32 vs plain) p99 {c99:.3g}, max {cmx:.3g}")
                if not (p99 <= RENDER_P99 and mx <= bound) or not \
                        torch.isfinite(out[k]).all():
                    fail(f"{tag}, {name} chunk, {k}: B1 render vs plain "
                         f"p99 {p99}, max {mx}")
            del ref, ctl
        first = next(iter(slices.values()))
        launch_errs = hold_launches(tag, model, rc, t_embed, rays[first],
                                    sems[first], **kw)
        worst = max(e["max"] for e in errs.values())
        log(f"{tag}: B1 launches {launches}, B1 render vs plain on "
            f"{sorted(slices)}: max {worst:.3g}, p99 "
            f"{max(e['p99'] for e in errs.values()):.3g}")
        return {"launches": launches, "max_abs_err": worst,
                "launch_max_abs_err": max(launch_errs), "errs": errs}

    # (a) the occupancy-grid flagship, 10 steps, its validation through B1
    link_cache("occgrid", FLAGSHIP_EXP)
    state, args = run("occgrid", argv("occgrid", OCC_ARGS
                                      + ["--max_train_steps", "10"]))
    rc = render_config_from_args(args)
    chunk = chunk_size(rc, args.chunk)
    n_chunks = -(-n_view // chunk)
    expect = 3 * n_chunks * 2
    r = rec["occgrid"]
    r.update(chunk=chunk, chunks_per_view=n_chunks, expect_b1=expect)
    if r["b1"] != expect or r["b2"] or r["b3"]:
        fail(f"the occgrid run launched B1 {r['b1']} times (expected "
             f"{expect}), B2 {r['b2']}, B3 {r['b3']}")
    if not (state.occ != 1.0).any():
        fail("the occgrid run left its grid all ones")
    tr, scene, _ = cli_train.build_trainer_and_scene(args, device)
    view = scene.val_images[-1]
    sample = scene.load_val_image(view, with_sem=True)
    rays = torch.from_numpy(sample["rays"]).to(device)
    sems = torch.from_numpy(sample["sems"]).to(device)
    r["view"] = hold_views(
        "occgrid test view", state.model, rc, state.t_embed, rays, sems,
        {"first": slice(0, chunk),
         "last": slice((n_chunks - 1) * chunk, n_view)},
        below_control=True, occ=state.occ)
    if r["view"]["launches"] != 3 * n_chunks:
        fail(f"the occgrid view launched B1 {r['view']['launches']} times")
    # one grid refresh on the card against the CPU: the same parameters,
    # slab and jitter
    u = torch.rand((tr.occ_rows, 3), generator=torch.Generator().manual_seed(
        14)).to(device)
    cpu_model = copy.deepcopy(state.model).cpu()
    on_card = update_grid(state.occ.clone(), tr.sigma_fn(state.model), u, 10,
                          rc.occ_res, tr.occ_rows, tr.occ_decay)
    on_cpu = update_grid(state.occ.cpu().clone(), tr.sigma_fn(cpu_model),
                         u.cpu(), 10, rc.occ_res, tr.occ_rows, tr.occ_decay)
    grid_err = (on_card.cpu() - on_cpu).abs().max().item()
    r.update(grid_rows=tr.occ_rows, grid_refresh_max_abs_err=grid_err,
             grid_changed=int((on_card != state.occ).sum()))
    log(f"one grid refresh ({tr.occ_rows} cells, slab 10) card vs CPU: max "
        f"abs err {grid_err:.3g}, {r['grid_changed']} cells changed")
    if not grid_err <= KERNEL_ATOL or r["grid_changed"] == 0:
        fail(f"grid refresh card vs CPU: max abs err {grid_err}")
    del state, tr, scene, cpu_model, on_card, on_cpu, rays, sems
    torch.cuda.empty_cache()

    # (b) multi-AOI hash, 10 steps: 3 B2 and 21 B3 a step
    link_cache("multi", "hash")
    state, args = run("multi", argv("multi", MULTI_ARGS
                                    + ["--max_train_steps", "10"]))
    r = rec["multi"]
    if (r["b2"], r["b3"], r["b1"]) != (30, 210, 0):
        fail(f"the multi-AOI run launched B2 {r['b2']}, B3 {r['b3']}, B1 "
             f"{r['b1']}; expected 30, 210, 0")
    maes = {k: v["mae"] for k, v in r["val"].items() if k != "val"}
    if len(maes) != 4 or not all(np.isfinite(list(maes.values()))):
        fail(f"multi-AOI per-AOI MAEs {maes}")
    log(f"multi-AOI validation, per view and frame: MAE {json.dumps(maes)}")
    tr, scene, _ = cli_train.build_trainer_and_scene(args, device)
    fresh = tr.init_state(torch.Generator().manual_seed(1))
    if CheckpointManager(args.ckpts_dir).restore(fresh) is None:
        fail("the multi-AOI run's checkpoint does not restore")
    if fresh.model.encoding.frames != 2:
        fail("the multi-AOI hash field has one frame")
    r["held"] = hold_hash(tr, fresh, tr.to_device(
        scene_to_device_arrays(scene)))
    want = {"dense": [16384], "sorted": [131072, 524288]}
    if r["held"]["t_eff"] != want:
        fail(f"multi-AOI table gradients at t_eff {r['held']['t_eff']}, "
             f"expected {want}")
    # B1 on the second frame's points: its test view's first chunk, the
    # flagship's random weights
    mc, frc = flagship_configs()
    fmodel = load_model(mc, frc.compute_dtype, device=device,
                        generator=torch.Generator().manual_seed(0))
    s2 = scene.scenes[1].load_val_image(scene.scenes[1].val_images[-1],
                                        with_sem=True)
    rays = torch.from_numpy(s2["rays"]).to(device)
    x0 = rays[:, 0].mean().item()
    fchunk = chunk_size(frc)
    r["second_frame"] = hold_views(
        "second frame's test view, first chunk", fmodel, frc, None,
        rays[:fchunk], torch.from_numpy(s2["sems"][:fchunk]).to(device),
        {"first": slice(0, fchunk)})
    r["second_frame"]["mean_origin_x"] = x0
    if r["second_frame"]["launches"] != 3 or not 2.0 < x0 < 4.0:
        fail(f"second frame: B1 launches {r['second_frame']['launches']}, "
             f"mean origin x {x0}")
    del state, tr, scene, fresh, fmodel, rays
    torch.cuda.empty_cache()

    # (c) the fine pass, 5 steps: the validation takes the module
    link_cache("fine", "hash")
    state, args = run("fine", argv("fine", FINE_ARGS
                                   + ["--max_train_steps", "5"]))
    r = rec["fine"]
    if r["b1"] or r["b2"] or r["b3"] or state.fine is None:
        fail(f"the fine-pass run launched B1 {r['b1']}, B2 {r['b2']}, B3 "
             f"{r['b3']}; expected none")
    if not all(np.isfinite(v["mae"]) for v in r["val"].values()):
        fail(f"fine-pass validation: {r['val']}")
    del state
    torch.cuda.empty_cache()

    # (d) the proposal sampler, 5 steps: 8 proposal-table B2 calls a step
    link_cache("proposal", "hash")
    state, args = run("proposal", argv("proposal", PROPOSAL_ARGS
                                       + ["--max_train_steps", "5"],
                                       drop=PROPOSAL_DROP))
    r = rec["proposal"]
    if (r["b1"], r["b2"], r["b3"]) != (0, 40, 0):
        fail(f"the proposal run launched B1 {r['b1']}, B2 {r['b2']}, B3 "
             f"{r['b3']}; expected 0, 40, 0")
    tr, scene, _ = cli_train.build_trainer_and_scene(args, device)
    fresh = tr.init_state(torch.Generator().manual_seed(1))
    if CheckpointManager(args.ckpts_dir).restore(fresh) is None:
        fail("the proposal run's checkpoint does not restore")
    r["held"] = hold_proposal(tr, fresh, tr.to_device(
        scene_to_device_arrays(scene)))
    del state, tr, scene, fresh
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- phase 15
# data parallelism over ranks and the four opt-in pass layouts
DP_WORLD = 2
DP_STEPS = 5
DP_TIMEOUT_S = 600  # per collective, and per group of rank processes
DP_EXP = "dp2"
SWITCHES = ("SPNERF_BATCH_SC", "SPNERF_BATCH_SOLAR", "SPNERF_NO_MERGE",
            "SPNERF_NO_PRUNE")


def hold_dtab_calls(calls, tag):
    """Each recorded table-gradient call (ids, ct, t_eff, fmajor) on the
    kernel the router picks for it, against the plain version at
    DTAB_RTOL (phase 6's); {route: [{t_eff, M, err, rel}]}."""
    from spnerf_torch.ops import dtab as dt

    kernels = {"dense": dt.dtab_dense, "sorted": dt.dtab_sorted,
               "partials": dt.dtab_sorted_partials}
    out = {}
    for ids, ct, t_eff, fmajor in calls:
        n_feat = ct.shape[0] if fmajor else ct.shape[1]
        name = dt.route(t_eff, n_feat, ids.shape[0])
        got = kernels[name](ids, ct, t_eff, fmajor)
        err, rel = rel_check(got, dt.dtab_plain(ids, ct, t_eff, fmajor),
                             f"{tag}: dtab_{name} t_eff={t_eff} "
                             f"M={ids.shape[0]}")
        out.setdefault(name, []).append(
            {"t_eff": t_eff, "M": ids.shape[0], "err": err, "rel": rel})
    return out


@contextlib.contextmanager
def recording_dtab(calls):
    """The hash field's table-gradient router, wrapped to record the inputs
    of every call (ids, ct, t_eff, fmajor) and pass them on."""
    from spnerf_torch.models import hashgrid as hg

    real = hg.dtab

    def recording(ids, ct, t_eff, F, impl=None, fmajor=True, sw_acc=None):
        calls.append((ids, ct.contiguous(), t_eff, fmajor))
        return real(ids, ct, t_eff, F, impl=impl, fmajor=fmajor,
                    sw_acc=sw_acc)

    hg.dtab = recording
    try:
        yield calls
    finally:
        hg.dtab = real


def hold_b1_launches(run, tag, **bars):
    """`spnerf_torch.utils.hold_b1.hold_b1_launches`, its failure fatal."""
    try:
        return hold_b1.hold_b1_launches(run, tag, **bars)
    except hold_b1.B1Mismatch as e:
        fail(str(e))


def table_snapshot(state):
    """Every parameter and optimizer tensor of `state`, on the host."""
    out = {f"p.{k}": v.detach().cpu().clone()
           for k, v in state.model.named_parameters()}
    for i, st in enumerate(state.optimizer.state.values()):
        out.update({f"o.{i}.{k}": v.detach().cpu().clone()
                    for k, v in st.items() if torch.is_tensor(v)})
    return out


def _rank_env(rank, world):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))


def _dp_rank(rank, world, init, out_dir):
    """Phase 15 (b), one rank sharing the card with the others (Gloo on
    CUDA tensors): DP_STEPS full-width hash steps and DP_STEPS flagship
    steps over the mesh; writes its record, its final states and (rank 0)
    step 0's averaged table gradient and the holds of its B2/B3 calls."""
    _rank_env(rank, world)
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.parallel import data_mesh
    from spnerf_torch.parallel.mesh import DataMesh
    from spnerf_torch.utils.synth import train_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = data_mesh(world, "cuda", init_method=init, timeout_s=DP_TIMEOUT_S)
    spans = []
    real = DataMesh.all_reduce_

    def timed(self, t, mean=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, t, mean)
        torch.cuda.synchronize()
        spans.append(((time.perf_counter() - t0) * 1e3,
                      t.numel() * t.element_size()))
        return out

    DataMesh.all_reduce_ = timed
    rec = {"rank": rank, "backend": mesh.backend, "device": str(mesh.device)}
    try:
        for family in ("hash", "siren"):
            tr, data = train_setup(family, device=mesh.device, mesh=mesh)
            state = tr.replicate_state(tr.init_state(
                torch.Generator().manual_seed(0)))
            for k in dt.launches:
                dt.launches[k] = 0
            spans.clear()
            calls, step_ms = [], []
            for step in range(DP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if step == 0 and family == "hash":
                    with recording_dtab(calls):
                        ld = tr.train_step(state, data, BATCH, seed=1)
                    grad0 = state.model.encoding.table.grad.detach().clone()
                else:
                    ld = tr.train_step(state, data, BATCH, seed=1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if not np.isfinite(ld["loss"].item()):
                    fail(f"rank {rank} {family} step {step}: loss "
                         f"{ld['loss'].item()}")
            launches = dict(dt.launches)
            grads = [s for s in spans if s[1] > 4 * 64]  # not the loss terms
            r = {"step_ms_runs": step_ms, "loss": ld["loss"].item(),
                 "launches": launches,
                 "launches_per_step": {k: v / DP_STEPS
                                       for k, v in launches.items()},
                 "all_reduce_ms_runs": [s[0] for s in grads],
                 "all_reduce_bytes": grads[0][1] if grads else None,
                 "local_batch": BATCH // world,
                 "shard_rays": int(data["rays"].shape[0])}
            torch.save(table_snapshot(state),
                       os.path.join(out_dir, f"{family}.{rank}.pt"))
            if family == "hash":
                r["table_calls"] = len(calls)
                if rank == 0:
                    torch.save(grad0.cpu(), os.path.join(out_dir, "grad0.pt"))
                    r["held"] = hold_dtab_calls(calls, f"rank 0 {family}")
                del calls, grad0
            rec[family] = r
            del tr, data, state
            torch.cuda.empty_cache()
        torch.save(rec, os.path.join(out_dir, f"rec.{rank}.pt"))
    finally:
        DataMesh.all_reduce_ = real
        mesh.close()


def _cli_rank(rank, world, port, argv, out_dir):
    """Phase 15 (c), one rank of `main_torch.py --data_axis 2` as
    `torchrun --nproc_per_node 2` starts it (the launcher's variables, an
    env:// group on localhost): the run with its kernel launches counted,
    then the test view rendered over the mesh from the final state with
    B1 held on its first chunk's launches."""
    _rank_env(rank, world)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import build_train_parser, finalize_args
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.parallel import data_mesh
    from spnerf_torch.render import build_render_fn, chunk_size

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = data_mesh(world, "cuda", timeout_s=DP_TIMEOUT_S)
    try:
        for k in dt.launches:
            dt.launches[k] = 0
        fe.FusedField.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = cli_train.main(argv)
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0, "b1": fe.FusedField.launches,
               "b2": dt.launches["dtab_dense"],
               "b3": dt.launches["dtab_sorted"], "backend": mesh.backend}
        args = finalize_args(build_train_parser().parse_args(argv),
                             make_dirs=False)
        tr, scene, _ = cli_train.build_trainer_and_scene(args, mesh.device,
                                                         mesh)
        sample = scene.load_val_image(scene.val_images[-1], with_sem=True)
        render = build_render_fn(state.model, tr.rc, state.t_embed,
                                 chunk=args.chunk, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(sample["rays"], 0, sample["sems"])
        torch.cuda.synchronize()
        rec["view_ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            torch.save({k: v.cpu() for k, v in out.items()},
                       os.path.join(out_dir, "view.pt"))
        # B1 on this rank's share of the view's first chunk
        first = slice(0, chunk_size(tr.rc, args.chunk) // world * world)
        rec["held"] = hold_b1_launches(lambda: build_render_fn(
            state.model, tr.rc, state.t_embed, chunk=args.chunk, mesh=mesh)(
            sample["rays"][first], 0, sample["sems"][first]),
            f"rank {rank} test view, first chunk")
        torch.save(rec, os.path.join(out_dir, f"cli.{rank}.pt"))
    finally:
        mesh.close()


def run_ranks(target, world, args, tag):
    """`target(rank, world, *args)` in `world` spawned processes; fails
    when one fails or outlasts DP_TIMEOUT_S (the others are killed)."""
    import multiprocessing as mproc

    ctx = mproc.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        fail(f"{tag}: rank exit codes {codes}")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_pass(device, card, project, n_view=813 * 793):
    """Phase 15: (a) a 1-rank NCCL mesh against no mesh; (b) two ranks
    sharing the card, the full-width hash and flagship steps; (c) the CLI
    over two ranks on phase 12's AOI, its test view and MAE against one
    rank, a resume with --data_axis 1; (d) the four pass layouts on phase
    4's view and on the hash step. Returns the record it prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     render_config_from_args)
    from spnerf_torch.models import load_model
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.parallel import DataMesh, data_mesh
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.utils.logging import MetricLogger
    from spnerf_torch.utils.synth import (fake_batch, flagship_configs,
                                          train_setup)

    import argparse

    rec = {"card": card}

    def params_of(state):
        return {k: p.detach().clone() for k, p in
                state.model.named_parameters()}

    def max_diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    # (a) a mesh of one rank (NCCL) against no mesh: 3 steps each of the
    #     flagship and the hash step, deterministic algorithms on and the
    #     hash table's gradient through its plain version (B2's float
    #     atomics do not repeat their last bits; B2 and B3 are held on the
    #     mesh's inputs in (b)); the no-mesh run twice, to show it repeats
    #     itself: then the mesh run must equal it bit for bit, else stay
    #     within twice its repeat spread
    mesh = data_mesh(1, "cuda", timeout_s=DP_TIMEOUT_S)
    rec["one_rank"] = {"backend": mesh.backend}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for family in ("siren", "hash"):
            runs = []
            for m in (None, None, mesh):
                tr, data = train_setup(family, device=device, mesh=m)
                state = tr.replicate_state(tr.init_state(
                    torch.Generator().manual_seed(0)))
                if family == "hash":
                    state.model.encoding.dtab_impl = "plain"
                losses = [tr.train_step(state, data, BATCH, seed=1)["loss"]
                          .item() for _ in range(3)]
                runs.append((losses, params_of(state)))
                del tr, data, state
            (la, pa), (la2, pa2), (lb, pb) = runs
            spread, diff = max_diff(pa, pa2), max_diff(pa, pb)
            r = {"losses_no_mesh": la, "losses_mesh": lb,
                 "losses_no_mesh_again": la2,
                 "param_max_diff_mesh": diff,
                 "param_max_diff_repeat": spread}
            rec["one_rank"][family] = r
            log(f"(a) {family}, 1-rank {mesh.backend} mesh vs no mesh: "
                + json.dumps(r))
            if la[0] != lb[0]:
                fail(f"(a) {family}: step 0's loss {lb[0]} != {la[0]}")
            if spread == 0.0 and (la != lb or diff != 0.0):
                fail(f"(a) {family}: the 1-rank mesh differs from no mesh")
            if spread > 0.0 and not diff <= 2 * spread:
                fail(f"(a) {family}: mesh vs no mesh {diff} beyond twice "
                     f"the no-mesh repeat spread {spread}")
    finally:
        torch.use_deterministic_algorithms(False)
        mesh.close()
    torch.cuda.empty_cache()

    # (b) two ranks sharing the card (Gloo on CUDA tensors)
    with tempfile.TemporaryDirectory(dir=project) as tmp:
        t0 = time.time()
        run_ranks(_dp_rank, DP_WORLD,
                  ("file://" + os.path.join(tmp, "store"), tmp), "(b)")
        ranks = [torch.load(os.path.join(tmp, f"rec.{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
        dp = {"s": time.time() - t0, "card": card, "ranks": ranks}
        for family in ("hash", "siren"):
            snaps = [torch.load(os.path.join(tmp, f"{family}.{r}.pt"))
                     for r in range(DP_WORLD)]
            for k, v in snaps[0].items():
                if not torch.equal(v, snaps[1][k]):
                    fail(f"(b) {family}: the ranks' {k} differ")
            for r in ranks:
                per = r[family]["launches_per_step"]
                if family == "hash" and (per["dtab_dense"]
                                         + per["dtab_sorted"] != 24
                                         or r["hash"]["table_calls"] != 24):
                    fail(f"(b) rank {r['rank']}: table gradients a step "
                         f"{per}, step 0 {r['hash']['table_calls']}")
        # step 0's averaged table gradient against the two ranks' own,
        # recomputed in this process through the plain table gradient
        grad0 = torch.load(os.path.join(tmp, "grad0.pt")).to(device)
        mean = torch.zeros_like(grad0)
        for rank in range(DP_WORLD):
            fake = DataMesh(rank=rank, world=DP_WORLD, group=None,
                            backend="gloo", device=device)
            tr, data = train_setup("hash", device=device, mesh=fake)
            state = tr.init_state(torch.Generator().manual_seed(0))
            g = tr.step_generator(0, seed=1, rank=rank)
            batch = tr.sample_batch(data, BATCH // DP_WORLD, g)
            state.model.encoding.dtab_impl = "plain"
            loss, _ = tr.loss_fn(state, batch, 0, generator=g)
            loss.backward()
            mean += state.model.encoding.table.grad / DP_WORLD
            del tr, data, state, batch, loss
        gerr = ((grad0 - mean).abs().max() / mean.abs().max()).item()
        dp["grad0_rel_err"] = gerr
        log(f"(b) step 0's averaged table gradient vs the mean of the ranks' "
            f"plain gradients: max abs err / max {gerr:.3g}")
        if not gerr <= STEP_GRAD_RTOL:
            fail(f"(b) averaged table gradient off by {gerr}")
        del grad0, mean
    held = ranks[0]["hash"]["held"]
    dp["held"] = {n: {"calls": len(v), "max_abs_err": max(x["err"] for x in v),
                      "max_rel_err": max(x["rel"] for x in v),
                      "t_eff": sorted({x["t_eff"] for x in v}),
                      "M": sorted({x["M"] for x in v})}
                  for n, v in held.items()}
    for r in ranks:
        for family in ("hash", "siren"):
            x = r[family]
            log(f"(b) rank {r['rank']} ({r['backend']}, {r['device']}) "
                f"{family}: {DP_STEPS} steps at {x['local_batch']} rays a "
                f"rank, step ms {[round(v, 1) for v in x['step_ms_runs']]}, "
                f"launches a step {x['launches_per_step']}, all-reduce "
                f"{x['all_reduce_bytes']} bytes a step in "
                f"{[round(v, 2) for v in x['all_reduce_ms_runs']]} ms ({card}"
                f"; two ranks sharing one card)")
    log(f"(b) rank 0's B2/B3 calls of step 0 on their own inputs: "
        f"{json.dumps(dp['held'])}")
    rec["dp"] = dp
    torch.cuda.empty_cache()

    # (c) the CLI over two ranks, on phase 12's AOI with the flagship's
    #     ray cache
    base = CLI_FLAGS + ["--project_dir", project, "--exp_name", DP_EXP,
                        "--device", str(device)]
    os.makedirs(os.path.join(project, "output", DP_EXP), exist_ok=True)
    os.symlink(os.path.join(project, "output", FLAGSHIP_EXP, "cache"),
               os.path.join(project, "output", DP_EXP, "cache"))
    with tempfile.TemporaryDirectory(dir=project) as tmp:
        t0 = time.time()
        run_ranks(_cli_rank, DP_WORLD,
                  (free_port(), base + ["--max_train_steps", "10",
                                        "--data_axis", str(DP_WORLD)], tmp),
                  "(c)")
        cli = {"s": time.time() - t0, "card": card,
               "ranks": [torch.load(os.path.join(tmp, f"cli.{r}.pt"),
                                    weights_only=False)
                         for r in range(DP_WORLD)]}
        view2 = torch.load(os.path.join(tmp, "view.pt"))
    args = finalize_args(build_train_parser().parse_args(
        base + ["--max_train_steps", "10"]), make_dirs=False)
    rc = render_config_from_args(args)
    chunk = chunk_size(rc, args.chunk) // DP_WORLD * DP_WORLD
    expect = 3 * -(-n_view // chunk) * 2
    cli.update(chunk=chunk, expect_b1=expect)
    for r in cli["ranks"]:
        if r["b1"] != expect or r["b2"] or r["b3"]:
            fail(f"(c) a rank launched B1 {r['b1']} times (expected "
                 f"{expect}), B2 {r['b2']}, B3 {r['b3']}")
    mgr = CheckpointManager(args.ckpts_dir)
    if mgr.all_steps() != [10]:
        fail(f"(c) checkpoints {mgr.all_steps()}, expected [10]")
    with open(os.path.join(args.logs_dir, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    keys = [(x["step"], x["split"]) for x in rows]
    if len(keys) != len(set(keys)):
        fail(f"(c) metrics.jsonl rows written twice: {keys}")
    logged = next(x for x in rows if (x["step"], x["split"]) == (10, "val"))
    # one rank, the same checkpoint: the test view and the MAE
    tr1, scene1, _ = cli_train.build_trainer_and_scene(args, device)
    state1 = tr1.init_state(torch.Generator().manual_seed(1))
    mgr.restore(state1)
    sample = scene1.load_val_image(scene1.val_images[-1], with_sem=True)
    view1 = build_render_fn(state1.model, tr1.rc, state1.t_embed,
                            chunk=args.chunk)(sample["rays"], 0,
                                              sample["sems"])
    errs = {k: p99_max(view2[k].to(device), v) for k, v in view1.items()}
    cli["view_vs_one_rank"] = errs
    if not all(p <= RENDER_P99 and m <= RENDER_MAX for p, m in errs.values()):
        fail(f"(c) the 2-rank test view vs one rank: {errs}")
    with tempfile.TemporaryDirectory(dir=project) as tmp:
        vargs = argparse.Namespace(**{**vars(args), "logs_dir": tmp})
        logger = MetricLogger(tmp, tensorboard=False)
        try:
            mean = cli_train.run_validation(tr1, scene1, state1, vargs, 0,
                                            logger, False)
        finally:
            logger.close()
    cli.update(mae_two_ranks=logged["mae"], mae_one_rank=mean["mae"],
               psnr_two_ranks=logged["psnr"], psnr_one_rank=mean["psnr"])
    if not abs(mean["mae"] - logged["mae"]) <= 1e-4:
        fail(f"(c) MAE {logged['mae']} (2 ranks) vs {mean['mae']} (1 rank)")
    del tr1, scene1, state1, view1, view2
    torch.cuda.empty_cache()
    # resume with one rank
    fe.FusedField.launches = 0
    t0 = time.time()
    state = cli_train.main(base + ["--max_train_steps", "15", "--data_axis",
                                   "1", "--auto_resume"])
    cli["resume"] = {"s": time.time() - t0, "step": state.step,
                     "b1": fe.FusedField.launches,
                     "ckpts": mgr.all_steps()}
    if state.step != 15 or mgr.all_steps() != [10, 15] or \
            fe.FusedField.launches != 3 * -(-n_view // chunk_size(
                rc, args.chunk)) * 2:
        fail(f"(c) the resume with --data_axis 1: {cli['resume']}")
    del state
    log(f"(c) the CLI over {DP_WORLD} ranks: " + json.dumps(cli))
    rec["cli"] = cli
    torch.cuda.empty_cache()

    # (d) the pass layouts: phase 4's view, each B1 launch of its first
    #     chunk held, the view against the default layout's
    mc, frc = flagship_configs()
    model = load_model(mc, frc.compute_dtype, device=device,
                       generator=torch.Generator().manual_seed(0))
    batch = fake_batch(np.random.default_rng(0), N_VIEW)
    rays = torch.from_numpy(batch["rays"]).to(device)
    vsems = torch.from_numpy(batch["sems"]).to(device)
    render = build_render_fn(model, frc)
    vchunk = chunk_size(frc)

    def view_ms():
        """The view's ms, median of 3 (CUDA events)."""
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render(rays, 0, vsems)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        return float(np.median(runs)), runs

    default = render(rays, 0, vsems)
    layouts = {"default": dict(zip(("view_ms", "view_ms_runs"), view_ms()))}
    # 3 launches a chunk; BATCH_SC 2 (the solar pass rides the second);
    # BATCH_SOLAR 3 (B1 takes no solar tail: separate passes)
    n_chunks = -(-N_VIEW // vchunk)
    expect = {"SPNERF_BATCH_SC": 2 * n_chunks, "SPNERF_BATCH_SOLAR":
              3 * n_chunks, "SPNERF_NO_MERGE": 3 * n_chunks,
              "SPNERF_NO_PRUNE": 3 * n_chunks}
    for name in SWITCHES:
        with env_set(name, "1"):
            fe.FusedField.launches = 0
            view = render(rays, 0, vsems)
            torch.cuda.synchronize()
            launches = fe.FusedField.launches
            ms, runs = view_ms()
            held = hold_b1_launches(lambda: render(rays[:vchunk], 0,
                                                   vsems[:vchunk]),
                                    f"(d) {name}, first chunk")
        errs = {k: p99_max(view[k], v) for k, v in default.items()}
        worst = max(m for _, m in errs.values())
        layouts[name] = {"launches": launches, "view_ms": ms,
                         "view_ms_runs": runs, "held": held,
                         "view_vs_default_max": worst,
                         "view_vs_default_p99": max(p for p, _ in
                                                    errs.values())}
        log(f"(d) {name}: view {ms:.1f} ms (default layout "
            f"{layouts['default']['view_ms']:.1f}; {card}), "
            f"B1 launches {launches}, first chunk's launches held "
            f"{json.dumps(held)}, view vs the default layout p99 "
            f"{layouts[name]['view_vs_default_p99']:.3g} max {worst:.3g}")
        if launches != expect[name]:
            fail(f"(d) {name}: B1 launches {launches}, expected "
                 f"{expect[name]}")
        if not all(p <= RENDER_P99 and m <= RENDER_MAX
                   for p, m in errs.values()):
            fail(f"(d) {name}: the view vs the default layout {errs}")
        del view
    del render, default, model, rays, vsems
    torch.cuda.empty_cache()

    # the hash step under BATCH_SOLAR and BATCH_SC: 2 passes x 8 levels of
    # table gradients, each held; loss and table gradient vs the default
    htr, hdata = train_setup("hash", device=device)
    hstate = htr.init_state(torch.Generator().manual_seed(0))

    def grads(calls=None):
        hstate.optimizer.zero_grad(set_to_none=True)
        g = htr.step_generator(0, seed=1)
        batch = htr.sample_batch(hdata, BATCH, g)
        loss, _ = htr.loss_fn(hstate, batch, 0, generator=g)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), hstate.model.encoding.table.grad.clone()

    loss_d, grad_d = grads()
    for name in ("SPNERF_BATCH_SOLAR", "SPNERF_BATCH_SC"):
        with env_set(name, "1"):
            calls = []
            for k in dt.launches:
                dt.launches[k] = 0
            with recording_dtab(calls):
                loss_s, grad_s = grads()
            launches = dict(dt.launches)
        lerr = abs(loss_s - loss_d) / abs(loss_d)
        gerr = ((grad_s - grad_d).abs().max() / grad_d.abs().max()).item()
        held = hold_dtab_calls(calls, f"(d) hash step, {name}")
        r = {"launches": launches, "loss_rel_err": lerr, "grad_rel_err": gerr,
             "held": {n: {"calls": len(v),
                          "max_abs_err": max(x["err"] for x in v),
                          "max_rel_err": max(x["rel"] for x in v),
                          "M": sorted({x["M"] for x in v})}
                      for n, v in held.items()}}
        layouts[name + "_hash"] = r
        log(f"(d) hash step, {name}: " + json.dumps(r))
        if len(calls) != 16 or (launches["dtab_dense"]
                                + launches["dtab_sorted"]) != 16:
            fail(f"(d) hash step, {name}: {len(calls)} table gradients, "
                 f"launches {launches}")
        if not (lerr <= STEP_LOSS_RTOL and gerr <= STEP_GRAD_RTOL):
            fail(f"(d) hash step, {name}: loss {lerr}, table gradient {gerr}"
                 " vs the default layout")
        del calls, grad_s
    del htr, hdata, hstate, grad_d
    rec["layouts"] = layouts
    torch.cuda.empty_cache()
    return rec




# ---------------------------------------------------------------- phase 16
# the data-prep tail: a raw AOI prepared, scored, trained and validated
PREP_STEPS = 300
DEPTH_MAE_BAR = 0.05  # m: the lidar's own surface through the splat
UTM_ROUND_TRIP_BAR = 1e-4  # m: UTM text and back to ECEF
# the flagship's flags as phase 13 takes them, without --sem: the prepared
# data has no semantic labels (the JAX package's create_dataset writes none)
PREP_FLAGS = ["--aoi_id", AOI_ID, "--model", "sp-nerf", "--mapping",
              "--guidedsample", "--sc_lambda", "0.1", "--depth",
              "--ds_lambda", "1.0", "--chunk", "40960", "--log_every", "50",
              "--no_timestamp_exp_name"]


def prep_pass(device, card, hold_hash):
    """Phase 16 in a temporary project: (a) a raw DFC2019 AOI at full size
    prepared by `python -m spnerf_torch.data.create_dataset`, depth made
    from its lidar, `tools utm-to-geocentric` on a UTM copy of one depth
    file, `tools cal-rmse-depth` on the card (held against the CPU), and
    `convert-tiff` and `viz-dsm`; (b) the flagship trained PREP_STEPS steps
    on it through the CLI and validated, B1 held per launch and the render
    against the plain render on the test view's first and ragged last
    chunk; (c) the hash family 10 steps on it, B2 and B3 held on one step's
    inputs (hold_hash); (d) `dryrun_torch.dryrun_multichip(2)` on the card.
    Returns the record it prints."""
    from spnerf_torch.cli import train as cli_train
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     render_config_from_args)
    from spnerf_torch.data.micmac import cal_rmse_depth, dense_depth_to_dsm
    from spnerf_torch.data.synth_depth import synthesize_depth_from_lidar
    from spnerf_torch.evaluation.dsm import rasterize_dsm
    from spnerf_torch.geo import ecef_to_latlon, latlon_to_utm
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.ops import field_eval as fe
    from spnerf_torch.render import build_render_fn, chunk_size
    from spnerf_torch.tools import main as tools_main
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.train.loop import scene_to_device_arrays
    from spnerf_torch.utils.synth_scene import write_raw_aoi

    import dryrun_torch

    rec = {"card": card, "s": {}}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec["s"][tag] = time.perf_counter() - t0
        log(f"  {tag}: {rec['s'][tag]:.2f} s")
        return out

    with tempfile.TemporaryDirectory() as project:
        # (a) the raw AOI to a prepared dataset
        raw = os.path.join(project, "raw")
        written = timed("write_raw", lambda: write_raw_aoi(
            raw, crop_px=800, roi_size=512, seed=0))
        timed("create_dataset", lambda: subprocess.run(
            [sys.executable, "-m", "spnerf_torch.data.create_dataset",
             "--aoi_id", AOI_ID, "--dataset_dir", raw, "--output_dir",
             os.path.join(project, "prepared"), "--seed", "0"],
            cwd=HERE, check=True))
        data_dir = os.path.join(project, "prepared", AOI_ID)
        json_dir, gt_dir = (os.path.join(data_dir, "JSON"),
                            os.path.join(data_dir, "Truth"))
        metas = {}
        for name in sorted(os.listdir(json_dir)):
            if name.endswith(".json"):
                with open(os.path.join(json_dir, name)) as f:
                    m = json.load(f)
                metas[m["img"]] = (m["width"], m["height"],
                                   m["sun_elevation"], m["sun_azimuth"])
        with open(os.path.join(json_dir, "train.txt")) as f:
            train = f.read().split()
        rec["images"] = metas
        log(f"prepared {len(metas)} images (width, height, sun el, az): "
            f"{json.dumps(metas)}; train {train}")
        if len(metas) != 4 or len(train) != 2:
            fail(f"prepared images {metas}, train split {train}")
        for img, (_, _, el, az) in metas.items():
            if (el, az) != tuple(written["sun"][img]):
                fail(f"{img}: sun angles {el}, {az} in its JSON, "
                     f"{written['sun'][img]} in its tag 42112")
        ids = timed("synthesize_depth", lambda: synthesize_depth_from_lidar(
            json_dir, gt_dir, AOI_ID, os.path.join(data_dir, "Depth"),
            stride=2, verbose=False))
        pts_path = os.path.join(data_dir, "Depth", f"{ids[0]}_3DPts_ecef.txt")
        ecef = np.loadtxt(pts_path)
        rec["depth_points"] = len(ecef)

        # a UTM copy of the depth file, back to ECEF through the tool
        utm_dir = os.path.join(project, "utm")
        os.makedirs(utm_dir)
        lat, lon, alt = ecef_to_latlon(ecef[:, 0], ecef[:, 1], ecef[:, 2])
        east, north, _, _ = latlon_to_utm(lat, lon, 17, True)
        np.savetxt(os.path.join(utm_dir, f"{ids[0]}_3DPts.txt"),
                   np.stack([east, north, alt], -1))
        back, = timed("utm_to_geocentric", lambda: tools_main([
            "utm-to-geocentric", "--file_dir", utm_dir, "--aoi_id", AOI_ID]))
        rec["utm_round_trip_m"] = float(np.abs(np.loadtxt(back)
                                               - ecef).max())
        log(f"utm-to-geocentric: {len(ecef)} points back within "
            f"{rec['utm_round_trip_m']:.3g} m")
        if not rec["utm_round_trip_m"] <= UTM_ROUND_TRIP_BAR:
            fail(f"utm-to-geocentric round trip {rec['utm_round_trip_m']} m")

        # the depth scored on the card, against the CPU's score
        stats = timed("cal_rmse_depth", lambda: tools_main([
            "cal-rmse-depth", "--pts3d_ecef", pts_path, "--gt_dir", gt_dir,
            "--aoi_id", AOI_ID, "--out_dir", os.path.join(project, "rmse"),
            "--device", str(device)]))
        on_cpu = cal_rmse_depth(pts_path, gt_dir, AOI_ID, device="cpu")
        roi_txt = os.path.join(gt_dir, f"{AOI_ID}_DSM.txt")
        xoff, yoff, size, res = np.loadtxt(roi_txt)
        rec.update(depth=stats, depth_cpu=on_cpu, depth_dsm_ms=cuda_ms(
            lambda: dense_depth_to_dsm(ecef, roi_txt, device=device), 5),
            splat_ms=cuda_ms(lambda: rasterize_dsm(
                east, north, alt, xoff, yoff + size * res, res,
                xsize=int(size), ysize=int(size), device=device), 5))
        log(f"cal-rmse-depth on the card: MAE {stats['mae']:.4f} m, RMSE "
            f"{stats['rmse']:.4f} m, coverage {stats['coverage']:.4f} "
            f"({len(ecef)} points; CPU {json.dumps(on_cpu)}); the splat "
            f"{rec['splat_ms']:.3f} ms from UTM (its float64 origin "
            f"subtraction and copy included), "
            f"{rec['depth_dsm_ms']:.3f} ms from ECEF (the host geodesy "
            f"included) ({card})")
        if (abs(stats["mae"] - on_cpu["mae"]) > 1e-5
                or abs(stats["rmse"] - on_cpu["rmse"]) > 1e-5
                or stats["coverage"] != on_cpu["coverage"]):
            fail(f"cal-rmse-depth card {stats} vs CPU {on_cpu}")
        if not stats["mae"] < DEPTH_MAE_BAR:
            fail(f"depth from the lidar scores MAE {stats['mae']} m, not "
                 f"below {DEPTH_MAE_BAR}")
        img = os.path.join(data_dir, "RGB", AOI_ID, f"{ids[0]}.tif")
        timed("convert_tiff", lambda: tools_main(
            ["convert-tiff", img, "--out_dir", os.path.join(project, "mm")]))
        rec["viz_dsm"] = tools_main(["viz-dsm", os.path.join(
            gt_dir, f"{AOI_ID}_DSM.tif"), os.path.join(project, "dsm.png")])

        # (b) the flagship, PREP_STEPS steps, validated through B1
        argv = PREP_FLAGS + ["--project_dir", project, "--device",
                             str(device), "--dataset_dir", data_dir]

        def run(tag, args):
            """main(args), its seconds and launches (counts set to 0 just
            before, read just after)."""
            for k in dt.launches:
                dt.launches[k] = 0
            fe.FusedField.launches = 0
            state = timed(tag, lambda: cli_train.main(args))
            r = {"s": rec["s"][tag], "b1": fe.FusedField.launches,
                 "b2": dt.launches["dtab_dense"],
                 "b3": dt.launches["dtab_sorted"]}
            exp = args[args.index("--exp_name") + 1]
            with open(os.path.join(project, "output", exp, "logs",
                                   "metrics.jsonl")) as f:
                rows = [json.loads(ln) for ln in f]
            r["val"] = {x["split"]: {k: x[k] for k in ("psnr", "ssim", "mae")}
                        for x in rows if x["split"].startswith("val")}
            r["steps_per_s"] = [x["rays_per_sec"] / 1024 for x in rows
                                if x["split"] == "train"]
            r["loss"] = [x["loss"] for x in rows if x["split"] == "train"]
            rec[tag] = r
            log(f"{tag}: {json.dumps(r)}")
            return state, finalize_args(build_train_parser().parse_args(args),
                                        make_dirs=False)

        fargs = argv + ["--exp_name", "prep_flagship", "--max_train_steps",
                        str(PREP_STEPS)]
        state, args = run("flagship", fargs)
        r = rec["flagship"]
        _, scene, _ = cli_train.build_trainer_and_scene(args, device)
        rc = render_config_from_args(args)
        chunk = chunk_size(rc, args.chunk)
        view = scene.val_images[-1]
        n_view = view.h * view.w
        n_chunks = -(-n_view // chunk)
        expect = 3 * sum(-(-v.h * v.w // chunk) for v in scene.val_images)
        if r["b1"] != expect or r["b2"] or r["b3"]:
            fail(f"the prepared flagship run launched B1 {r['b1']} times "
                 f"(expected {expect}), B2 {r['b2']}, B3 {r['b3']}")
        if not np.isfinite(r["val"]["val"]["mae"]):
            fail(f"the prepared flagship run's MAE: {r['val']}")
        # C7: B1 on the trained field's own samples of the test view
        sample = scene.load_val_image(view)
        rays = sample["rays"]
        render = build_render_fn(state.model, rc, state.t_embed)
        plain = build_render_fn(state.model, rc, state.t_embed,
                                field="plain")
        plain32 = build_render_fn(state.model,
                                  replace(rc, compute_dtype="float32"),
                                  state.t_embed, field="plain")
        r["view"] = {"img": view.img_id, "rays": n_view, "chunk": chunk}
        launch_errs = []
        for tag, sl in (("first", slice(0, chunk)),
                        ("last", slice((n_chunks - 1) * chunk, n_view))):
            outs = []
            held = hold_b1_launches(lambda: outs.append(render(rays[sl], 0)),
                                    f"prepared flagship, {tag} chunk",
                                    controls=True)
            launch_errs.append(held["max_abs_err"])
            out, ref, ctl = outs[0], plain(rays[sl], 0), plain32(rays[sl], 0)
            errs = {"launches_held": held["launches_held"],
                    "launch_max_abs_err": held["max_abs_err"],
                    "launch_outputs": held["outputs"],
                    "launch_by_output": held["by_output"]}
            log(f"  prepared flagship, {tag} chunk: each output's largest "
                f"distance from plain over its launches, beside its float32 "
                f"and tensor-core controls: {json.dumps(held['by_output'])}")
            for k, v in ref.items():
                p99, mx = p99_max(out[k], v)
                c99, cmx = p99_max(out[k], ctl[k])
                errs[k] = {"p99": p99, "max": mx, "control_p99": c99,
                           "control_max": cmx}
                log(f"  prepared flagship, {tag} chunk ({len(rays[sl])} "
                    f"rays), {k}: kernel vs plain render p99 {p99:.3g}, max "
                    f"{mx:.3g}; control (vs plain float32) p99 {c99:.3g}, "
                    f"max {cmx:.3g}")
                if not (p99 <= RENDER_P99 and mx <= RENDER_MAX):
                    fail(f"prepared flagship, {tag} chunk, {k}: kernel "
                         f"render disagrees with the plain render")
            r["view"][tag] = errs
        r["launch_max_abs_err"] = max(launch_errs)
        log(f"prepared flagship: {PREP_STEPS} steps in {r['s']:.1f} s, MAE "
            f"{r['val']['val']['mae']:.4f} m, B1 launches {r['b1']}, each "
            f"held launch within {r['launch_max_abs_err']:.3g} of its plain "
            f"version (KERNEL_ATOL {KERNEL_ATOL}) ({card})")
        del state, scene, render, plain, plain32
        torch.cuda.empty_cache()

        # (c) the hash family on the same dataset, B2 and B3 held
        hargv = argv + HASH_ARGS + ["--exp_name", "prep_hash",
                                    "--max_train_steps", "10"]
        hstate, hargs = run("hash", hargv)
        r = rec["hash"]
        if (r["b2"], r["b3"]) != (3 * 10, 21 * 10):
            fail(f"the prepared hash run launched B2 {r['b2']} and B3 "
                 f"{r['b3']} times, expected 30 and 210")
        del hstate
        htr, hscene, _ = cli_train.build_trainer_and_scene(hargs, device)
        fresh = htr.init_state(torch.Generator().manual_seed(1))
        if CheckpointManager(hargs.ckpts_dir).restore(fresh) is None:
            fail("the prepared hash run's checkpoint does not restore")
        r["held"] = hold_hash(htr, fresh, htr.to_device(
            scene_to_device_arrays(hscene)))
        del fresh, htr, hscene
        torch.cuda.empty_cache()

    # (d) every train-step variant over two ranks sharing the card
    results = timed("dryrun", lambda: dryrun_torch.dryrun_multichip(2))
    rec["dryrun"] = [{"program": x["program"], "loss": x["loss"]}
                     for x in results[0]]
    return rec


# ---------------------------------------------------------------- phase 18
BENCH_TIMEOUT_S = 300
BENCH_METRIC = "flagship_train_rays_per_sec_per_gpu"


def siren_pass(tr, state, data, card, reps=20):
    """Phase 8's hold of S1, the Siren epilogue (`csrc/siren_act.cu`), on
    the flagship train step. One step with `SineLayer`'s counters set to 0
    must launch each kernel once per Siren activation (SIREN_ACTS) and the
    plain version never; one step records the inputs of every launch, and
    each launch is held bit for bit (`torch.equal`) against the plain
    composition on them; each distinct shape is timed through the wrapper
    (CUDA events) beside the plain composition and its bytes bound; one
    profiled step gives each kernel's device time and device launches.
    Returns S1's entry of the `kernels` line: per launch, the mean over the
    step's launches; per step, their sum."""
    from spnerf_torch.models.spnerf import (SineLayer, sine_layer_grad_plain,
                                            sine_layer_plain)
    from spnerf_torch.ops import siren_act

    for counts in (SineLayer.launches, SineLayer.plain_calls):
        for way in counts:
            counts[way] = 0
    tr.train_step(state, data, BATCH, seed=1)
    torch.cuda.synchronize()
    launches, plain = dict(SineLayer.launches), dict(SineLayer.plain_calls)
    log(f"siren train step launches: {json.dumps(launches)}, plain "
        f"{json.dumps(plain)}")
    if launches != dict.fromkeys(launches, SIREN_ACTS) or any(
            plain.values()):
        fail(f"siren train step: expected {SIREN_ACTS} launches each way "
             f"and no plain call, got {launches} and plain {plain}")

    calls = {"forward": [], "backward": []}
    forward, backward = siren_act.forward, siren_act.backward

    def recording_forward(y, bias, w0, cd):
        calls["forward"].append((y.clone(), bias.clone(), w0, cd))
        return forward(y, bias, w0, cd)

    def recording_backward(gs, z, w0):
        calls["backward"].append((gs.clone(), z.clone(), w0))
        return backward(gs, z, w0)

    siren_act.forward, siren_act.backward = (recording_forward,
                                             recording_backward)
    try:
        tr.train_step(state, data, BATCH, seed=1)
        torch.cuda.synchronize()
    finally:
        siren_act.forward, siren_act.backward = forward, backward
    if any(len(c) != SIREN_ACTS for c in calls.values()):
        fail(f"siren train step recorded {len(calls['forward'])} forward "
             f"and {len(calls['backward'])} backward calls")

    mismatches = {"forward": 0, "backward": 0}
    for y, bias, w0, cd in calls["forward"]:
        s, z = forward(y, bias, w0, cd)
        s_plain, z_plain = sine_layer_plain(y, bias, w0, cd)
        mismatches["forward"] += not (torch.equal(s, s_plain)
                                      and torch.equal(z, z_plain))
    for gs, z, w0 in calls["backward"]:
        mismatches["backward"] += not torch.equal(
            backward(gs, z, w0), sine_layer_grad_plain(gs, z, w0))
    log(f"siren epilogue held on the step's {SIREN_ACTS} + {SIREN_ACTS} "
        f"launches: mismatches {json.dumps(mismatches)}")
    if any(mismatches.values()):
        fail(f"siren epilogue differs from the plain composition: "
             f"{mismatches}")

    # each distinct (rows, width, w0, dtype) once, on its first call's inputs
    shapes = {}
    for way, fn, plain_fn in (("forward", forward, sine_layer_plain),
                              ("backward", backward, sine_layer_grad_plain)):
        for args in calls[way]:
            rows, width = args[0].shape  # y or gs, both (N, W)
            dtype = args[3] if way == "forward" else args[1].dtype
            key = (rows, width, args[2], str(dtype).removeprefix("torch."))
            rec = shapes.setdefault(key, dict(
                zip(("rows", "width", "w0", "dtype"), key), launches=0))
            if way == "forward":
                rec["launches"] += 1
            if f"{way}_ms" in rec:
                continue
            # bytes: the forward reads y and bias and writes s and z; the
            # backward reads gs and z and writes the float32 gy
            nbytes = (4 + 2 * torch.finfo(dtype).bits // 8) * rows * width
            if way == "forward":
                nbytes += 4 * width
            rec[f"{way}_ms"] = cuda_ms(lambda: fn(*args), reps)
            rec[f"{way}_plain_ms"] = cuda_ms(lambda: plain_fn(*args), reps)
            rec[f"{way}_bound_ms"] = nbytes / PEAK_BYTES * 1e3
    del calls
    torch.cuda.empty_cache()
    for rec in shapes.values():
        log(f"siren epilogue {json.dumps(rec)}")

    dev = {way: device_ms(lambda: tr.train_step(state, data, BATCH, seed=1),
                          1, keys=(f"siren_act_{way}",))
           for way in ("forward", "backward")}
    log(f"siren epilogue device time in a step (profiler): "
        f"{json.dumps(dev)}")

    n = 2 * SIREN_ACTS
    step = {k: sum(r["launches"] * (r[f"forward{k}"] + r[f"backward{k}"])
                   for r in shapes.values())
            for k in ("_ms", "_plain_ms", "_bound_ms")}
    ways = {way: {k: sum(r["launches"] * r[f"{way}{k}"]
                         for r in shapes.values()) / SIREN_ACTS
                  for k in ("_ms", "_plain_ms", "_bound_ms")}
            for way in ("forward", "backward")}
    kernel_ms = [dev[w]["kernel"] for w in dev]
    return {
        "name": "siren_act",
        "route": "cuda",
        "source": "spnerf_torch/csrc/siren_act.cu",
        "replaces": "none: the JAX package leaves the Siren epilogue to "
                    "XLA's fusion",
        "launches": launches,
        "plain_calls": plain,
        "mismatches": mismatches,
        "ms": step["_ms"] / n,
        "plain_ms": step["_plain_ms"] / n,
        "bound_ms": step["_bound_ms"] / n,
        "bound_by": "bytes",
        "per_launch": "mean over the step's launches, both ways, at their "
                      "own shapes",
        "by_direction": {w: {k.removeprefix("_"): v for k, v in r.items()}
                         for w, r in ways.items()},
        "ms_per_step": step["_ms"],
        "plain_ms_per_step": step["_plain_ms"],
        "bound_ms_per_step": step["_bound_ms"],
        "device_ms_per_step": (None if None in kernel_ms
                               else sum(kernel_ms)),
        "kernel_launches_per_step": {w: dev[w]["launches"] for w in dev},
        "step_device_ms": dev["forward"]["device"],
        "shapes": list(shapes.values()),
        "card": card,
    }


def bench_pass():
    """Phase 18:`python3 bench_torch.py` as a user runs it, a subprocess
    from the repository root. It must exit 0 with a last line that parses,
    under BENCH_METRIC, a finite value > 0 and this card's name; returns
    that record with the phase's seconds."""
    t0 = time.time()
    try:
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=HERE,
                              capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"bench_torch.py ran past {BENCH_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"bench_torch.py exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"bench_torch.py's last line is not JSON: {proc.stdout[-500:]}")
    value = rec.get("value")
    if (rec.get("metric") != BENCH_METRIC
            or not isinstance(value, (int, float))
            or not np.isfinite(value) or value <= 0
            or rec.get("device") != torch.cuda.get_device_name(0)):
        fail(f"bench_torch.py's record: {json.dumps(rec)}")
    rec["phase_s"] = time.time() - t0
    return rec


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from spnerf_torch.config import ModelConfig
        from spnerf_torch.device import card_info
        from spnerf_torch.models import load_model
        from spnerf_torch.ops import _build
        from spnerf_torch.ops import field_eval as fe
        from spnerf_torch.render import build_render_fn, chunk_size
        from spnerf_torch.models import hashgrid as hg
        from spnerf_torch.ops import dtab as dt
        from spnerf_torch.utils.dtab_cases import (BATCHED_CASES, EDGE_CASES,
                                                   batched_edge_case,
                                                   edge_case)
        from spnerf_torch.utils.synth import (fake_batch, flagship_configs,
                                              train_setup)
    except ImportError as e:
        fail(f"the spnerf_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    device = torch.device("cuda", 0)
    t_start = time.time()

    # 1. the card
    info = card_info(device)
    if info is None:
        fail("nvidia-smi lists no card of this device's UUID")
    card = ", ".join(info)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log(f"-- phase 2 at {time.time() - t_start:.1f} s")
    # 2. build the path's kernel sources, one nvcc each, in parallel
    t0 = time.time()
    texts = _build.build_all(["field_eval", "field_eval_general",
                              "field_eval_f32", "field_eval_wide", "dtab",
                              "siren_act"])
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in texts.items():
        # ptxas's notes that it fenced a wgmma's registers (C7519), counted
        injected = sum("C7519" in line for line in text.splitlines())
        for line in text.splitlines():
            if ("registers" in line or "spill" in line) and (
                    "C7519" not in line):
                log(f"  {name}: {line.strip()}")
        if injected:
            log(f"  {name}: {injected} warpgroup.arrive injected by ptxas "
                f"(C7519)")
    clusters = {f"{dtype} {width} on {fe.wide_cluster(width)}":
                fe.wide_clusters(width, dtype)
                for width in (768, 1024, 1536, 2048, 3072, 4096)
                for dtype in ("bfloat16", "float32")}
    log(f"wide kernel: clusters of 2, 4 and 8 CTAs on the card at once "
        f"{json.dumps(clusters)} "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs)")
    if min(clusters.values()) < 1:
        fail(f"no cluster of the wide kernel fits the card: {clusters}")

    log(f"-- phase 3 at {time.time() - t_start:.1f} s")
    # 3. the kernel against its plain version at flagship width
    mc, rc = flagship_configs()
    model = load_model(mc, rc.compute_dtype, device=device,
                       generator=torch.Generator().manual_seed(0))
    packed = fe.pack_params(model)
    xyz, sun, sems = field_inputs(N_CHECK, 1, device, mc.num_sem_classes)
    kernel_err = 0.0

    def hold_field(pk, args, heads, tag, dtype="bfloat16"):
        """One B1 launch (on the route `pk` is packed for) against
        PlainField; returns the max abs error."""
        before = fe.FusedField.route_launches[pk.route]
        out = fe.FusedField(pk, dtype)(*args, heads=heads)
        torch.cuda.synchronize()
        if fe.FusedField.route_launches[pk.route] != before + 1:
            fail(f"{tag}: no launch on the {pk.route} route")
        ref = fe.PlainField(pk, dtype)(*args, heads=heads)
        if set(out) != set(ref):
            fail(f"{tag}: kernel outputs {sorted(out)} != plain {sorted(ref)}")
        atol = F32_ATOL if dtype == "float32" else KERNEL_ATOL
        err = 0.0
        for k in ref:
            e = (out[k] - ref[k]).abs().max().item()
            if not (e <= atol) or not torch.isfinite(out[k]).all():
                fail(f"{tag} {pk.route} {dtype} heads={heads} {k}: max abs "
                     f"err {e} > {atol}")
            err = max(err, e)
        return err

    subsets = [h for r in range(len(fe.ALL_HEADS) + 1)
               for h in itertools.combinations(fe.ALL_HEADS, r)]
    xyz, sun, sems = field_inputs(N_CHECK, 1, device, mc.num_sem_classes)
    errs = [hold_field(packed, (xyz, sun, None, sems), h, f"n={N_CHECK}")
            for h in subsets]
    log(f"kernel vs plain, flagship, n={N_CHECK}, every head subset: max "
        f"abs err {max(errs):.6f}")
    kernel_err = max(kernel_err, max(errs))
    for heads in (fe.ALL_HEADS, ("sun",)):
        field = fe.FusedField(packed)
        ms = cuda_ms(lambda: field(xyz, sun, None, sems, heads=heads), 5)
        log(f"  kernel at n={N_CHECK}, heads={heads}: {ms:.3f} ms, "
            f"{fe.flops_per_point(mc, heads) * N_CHECK / ms / 1e9:.1f} TFLOP/s")
    del xyz, sun, sems
    for n in (1, 63, 65, 187):
        args = field_inputs(n, n, device, mc.num_sem_classes)
        for heads in (fe.ALL_HEADS, ("sun",)):
            kernel_err = max(kernel_err, hold_field(
                packed, (args[0], args[1], None, args[2]), heads, f"n={n}"))
    log(f"kernel vs plain, flagship, n = 1, 63, 65, 187: within "
        f"{KERNEL_ATOL}")
    widths = {}
    for width in (96, 160, 256):
        wc = ModelConfig(mapping=True, sem=True, beta=True, num_sem_classes=3,
                         fc_units=width)
        wp = fe.pack_params(load_model(
            wc, "bfloat16", device=device,
            generator=torch.Generator().manual_seed(width)))
        xyz, sun, sems = field_inputs(1000, width, device, 3)
        t_emb = torch.from_numpy(np.random.default_rng(width).normal(
            size=(1000, wc.t_embedding_dims)).astype(np.float32)).to(device)
        widths[width] = max(hold_field(wp, (xyz, sun, t_emb, sems), h,
                                       f"width {width}") for h in subsets)
    log(f"kernel vs plain, widths 96, 160, 256, every head subset, n=1000: "
        f"max abs err {json.dumps(widths)}")
    kernel_err = max([kernel_err, *widths.values()])

    # the float32 route against the plain float32 version: the flagship
    # width, every head subset, then across its envelope
    f32_err = 0.0
    packed32 = fe.pack_params(model, "float32")
    if packed32.route != "wgmma_f32":
        fail(f"the float32 flagship packs for {packed32.route}")
    xyz, sun, sems = field_inputs(N_CHECK, 1, device, mc.num_sem_classes)
    f32_err = max(hold_field(packed32, (xyz, sun, None, sems), h,
                             f"n={N_CHECK}", "float32") for h in subsets)
    for heads in (fe.ALL_HEADS, ("sun",)):
        field = fe.FusedField(packed32, "float32")
        ms = cuda_ms(lambda: field(xyz, sun, None, sems, heads=heads), 3)
        log(f"  wgmma_f32 kernel at n={N_CHECK}, heads={heads}: "
            f"{ms:.3f} ms, "
            f"{fe.flops_per_point(mc, heads) * N_CHECK / ms / 1e9:.1f} "
            f"TFLOP/s")
    for n in (1, 63, 65, 187):
        args = field_inputs(n, n, device, mc.num_sem_classes)
        for heads in (fe.ALL_HEADS, ("sun",)):
            f32_err = max(f32_err, hold_field(
                packed32, (args[0], args[1], None, args[2]), heads, f"n={n}",
                "float32"))
    log(f"wgmma_f32 kernel vs plain float32, flagship, n={N_CHECK} every "
        f"head subset and n = 1, 63, 65, 187: max abs err {f32_err}")
    f32_widths = {}
    f32_cases = [(width, beta, 20 if width == 96 else 16)
                 for width in (32, 80, 96, 160, 256, 480, 512)
                 for beta in (False, True)]
    for width, beta, t_dims in f32_cases:
        wc = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                         fc_units=width, t_embedding_dims=t_dims)
        wp = fe.pack_params(load_model(
            wc, "float32", device=device,
            generator=torch.Generator().manual_seed(width)), "float32")
        if wp.route != "wgmma_f32":
            fail(f"float32 fc_units {width} packs for {wp.route}")
        xyz, sun, sems = field_inputs(1000, width, device, 3)
        t_emb = (torch.from_numpy(np.random.default_rng(width).normal(
            size=(1000, t_dims)).astype(np.float32)).to(device)
            if beta else None)
        tag = f"w{width}{' beta' if beta else ''} t{t_dims}"
        f32_widths[tag] = max(hold_field(wp, (xyz, sun, t_emb, sems), h,
                                         f"wgmma_f32 {tag}", "float32")
                              for h in subsets)
        del wp
    f32_err = max([f32_err, *f32_widths.values()])
    log(f"wgmma_f32 kernel vs plain float32, every head subset, n=1000: max "
        f"abs err {json.dumps(f32_widths)}")

    # the general route against the plain version: float32 at the flagship
    # width packed for it (the parent's route) and at the widths the
    # float32 route refuses; bf16 at the wgmma widths (packed for the
    # general kernel) and past the wgmma kernel's envelope
    gen_err = {"float32": 0.0, "bfloat16": 0.0}
    packed_gen = fe.pack_params(model, "float32", kernel="general")
    xyz, sun, sems = field_inputs(N_CHECK, 1, device, mc.num_sem_classes)
    gen_err["float32"] = max(hold_field(
        packed_gen, (xyz, sun, None, sems), h, f"n={N_CHECK}", "float32")
        for h in (fe.ALL_HEADS, ("sun",)))
    del xyz, sun, sems
    log(f"general kernel vs plain, float32, flagship, n={N_CHECK}, all heads "
        f"and the solar pass: max abs err {gen_err['float32']}")
    gen_widths = {}
    gen_cases = [(dtype, width, beta, 16)
                 for width in (96, 160, 256, 736, 768, 800, 1024)
                 for beta in (False, True)
                 for dtype in ("float32", "bfloat16")
                 if dtype == "bfloat16" or width > fe.F32_W_MAX]
    gen_cases += [("bfloat16", 80, True, 16), ("bfloat16", 512, True, 32)]
    for dtype, width, beta, t_dims in gen_cases:
        wc = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                         fc_units=width, t_embedding_dims=t_dims)
        wp = fe.pack_params(load_model(
            wc, dtype, device=device,
            generator=torch.Generator().manual_seed(width)), dtype,
            kernel="general")
        xyz, sun, sems = field_inputs(1000, width, device, 3)
        t_emb = (torch.from_numpy(np.random.default_rng(width).normal(
            size=(1000, t_dims)).astype(np.float32)).to(device)
            if beta else None)
        tag = f"{dtype} w{width}{' beta' if beta else ''} t{t_dims}"
        gen_widths[tag] = max(hold_field(wp, (xyz, sun, t_emb, sems), h,
                                         f"general {tag}", dtype)
                              for h in subsets)
        gen_err[dtype] = max(gen_err[dtype], gen_widths[tag])
        del wp
    log(f"general kernel vs plain, every head subset, n=1000: max abs err "
        f"{json.dumps(gen_widths)}")
    log(f"general kernel: max abs err float32 {gen_err['float32']} "
        f"(F32_ATOL {F32_ATOL}), bf16 {gen_err['bfloat16']} (KERNEL_ATOL "
        f"{KERNEL_ATOL})")
    torch.cuda.empty_cache()

    log(f"-- phase 4 at {time.time() - t_start:.1f} s")
    # 4. the main path: one synthetic view through the eval renderer
    batch = fake_batch(np.random.default_rng(0), N_VIEW)
    rays = torch.from_numpy(batch["rays"]).to(device)
    vsems = torch.from_numpy(batch["sems"]).to(device)
    render = build_render_fn(model, rc)
    chunk = chunk_size(rc)
    n_chunks = -(-N_VIEW // chunk)
    reset_b1()
    view = render(rays, 0, vsems)
    torch.cuda.synchronize()
    launches = fe.FusedField.launches
    routes = dict(fe.FusedField.route_launches)
    log(f"view: {N_VIEW} rays, chunk {chunk} rays, {n_chunks} chunks, "
        f"field kernel launches {launches} {json.dumps(routes)}")
    if launches != 3 * n_chunks or routes["wgmma"] != launches:
        fail(f"expected {3 * n_chunks} wgmma kernel launches, got {routes}")
    for k, v in view.items():
        if v.shape[0] != N_VIEW or not torch.isfinite(v).all():
            fail(f"{k}: shape {tuple(v.shape)} or non-finite values")
    rgb, depth = view["rgb_coarse"], view["depth_coarse"]
    if rgb.min() < 0 or rgb.max() > 1:
        fail("rgb_coarse outside [0, 1]")
    if depth.min() < rays[:, 6].min() - 1e-4 or depth.max() > rays[:, 7].max() + 1e-4:
        fail("depth_coarse outside [near, far]")
    sub = (rays[:1024], 0, vsems[:1024])
    plain = build_render_fn(model, rc, field="plain")(*sub)
    plain32 = build_render_fn(model, replace(rc, compute_dtype="float32"),
                              field="plain")(*sub)

    # a float32 render on the card takes the wgmma_f32 kernel, 3 a chunk
    rc32 = replace(rc, compute_dtype="float32")
    render32 = build_render_fn(model, rc32)
    reset_b1()
    kernel32 = render32(*sub)
    torch.cuda.synchronize()
    routes32 = dict(fe.FusedField.route_launches)
    if routes32 != {"wgmma": 0, "general": 0, "wgmma_f32": 3,
                    "wgmma_wide": 0}:
        fail(f"the float32 subset launched {routes32}, expected 3 wgmma_f32")
    render32_err = max((kernel32[k] - plain32[k]).abs().max().item()
                       for k in plain32)
    log(f"  float32 render on the card: B1 launches {json.dumps(routes32)}, "
        f"max abs err against the plain float32 render {render32_err:.3g}")
    if not render32_err <= F32_ATOL:
        fail(f"float32 render disagrees with the plain float32 render: "
             f"{render32_err}")
    del kernel32
    for k, v in plain.items():
        p99, mx = p99_max(view[k][:1024], v)
        c99, cmx = p99_max(view[k][:1024], plain32[k])
        log(f"  {k}: kernel vs plain render, p99 {p99:.3g}, max {mx:.3g}; "
            f"control (vs plain float32) p99 {c99:.3g}, max {cmx:.3g}")
        if not (p99 <= RENDER_P99 and mx <= RENDER_MAX):
            fail(f"{k}: kernel render disagrees with the plain render")

    times = []
    for _ in range(4):  # one warm-up, then 3 timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render(rays, 0, vsems)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    view_ms = float(np.median(times[1:]))
    log(json.dumps({"view_ms": view_ms, "rays_per_s": N_VIEW / view_ms * 1e3,
                    "view_ms_runs": times[1:], "card": card}))

    # the float32 view through the wgmma_f32 kernel, through the general
    # kernel (the parent's route) and through the module (the route before
    # it), in turns: one timed round (the renders above warmed each up)
    module32 = module_render_fn(model, rc32)
    general32 = general_render_fn(model, rc32)
    reset_b1()
    view32 = render32(rays, 0, vsems)
    torch.cuda.synchronize()
    launches32 = fe.FusedField.route_launches["wgmma_f32"]
    if (launches32 != 3 * n_chunks
            or fe.FusedField.launches != launches32):
        fail(f"the float32 view launched {fe.FusedField.route_launches}")
    ref32 = module32(rays, 0, vsems)
    vs_module = max((view32[k] - ref32[k]).abs().max().item() for k in ref32)
    reset_b1()
    ref32 = general32(rays, 0, vsems)
    torch.cuda.synchronize()
    if fe.FusedField.route_launches["general"] != launches32:
        fail(f"the float32 view packed for the general kernel launched "
             f"{fe.FusedField.route_launches}")
    vs_general = max((view32[k] - ref32[k]).abs().max().item()
                     for k in ref32)
    del view32, ref32
    runs32 = {}
    for tag, fn in (("kernel", render32), ("general", general32),
                    ("module", module32)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(rays, 0, vsems)
        end.record()
        torch.cuda.synchronize()
        runs32[tag] = start.elapsed_time(end)
    view32_rec = {"view_ms_f32": runs32["kernel"],
                  "view_ms_f32_general": runs32["general"],
                  "view_ms_f32_module": runs32["module"],
                  "launches": launches32,
                  "max_abs_diff_vs_module": vs_module,
                  "max_abs_diff_vs_general": vs_general, "card": card}
    log(json.dumps(view32_rec))
    del render32, module32, general32

    log(f"-- phase 5 at {time.time() - t_start:.1f} s")
    # 5. each launch of the path at its shapes: the coarse and guided passes
    #    (all heads) on chunk x n_samples points, the solar pass ("sun",) on
    #    the merged samples, chunk x n_samples x (2 if guided)
    field, plain_field = fe.FusedField(packed), fe.PlainField(packed)
    rec = {}
    for tag, (heads, n_pts) in launch_shapes(rc, chunk,
                                             fe.ALL_HEADS).items():
        xyz, sun, sems = field_inputs(n_pts, 2, device, mc.num_sem_classes)
        out = field(xyz, sun, None, sems, heads=heads)
        ref = plain_field(xyz, sun, None, sems, heads=heads)
        errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
        log(f"kernel vs plain, heads={tag}, n={n_pts}: max abs err "
            + json.dumps({k: round(v, 6) for k, v in errs.items()}))
        for k, v in errs.items():
            if not (v <= KERNEL_ATOL) or not torch.isfinite(out[k]).all():
                fail(f"kernel {k}: max abs err {v} > {KERNEL_ATOL}")
        kernel_err = max(kernel_err, max(errs.values()))
        del out, ref
        ms = cuda_ms(lambda: field(xyz, sun, None, sems, heads=heads), 10)
        plain_ms = cuda_ms(lambda: plain_field(xyz, sun, None, sems,
                                               heads=heads), 3)
        flops = fe.flops_per_point(mc, heads) * n_pts
        outs = sum(w for _, w in fe.active_outputs(mc, heads))
        nbytes = (n_pts * (packed.k0_pad + fe.KPAD) * 2 + n_pts * outs * 4
                  + packed.w_all.numel() * 2 + packed.b_all.numel() * 4)
        dev = device_ms(lambda: field(xyz, sun, None, sems, heads=heads), 1,
                        keys=("field_eval",))["kernel"]
        gemm = gemm_fn(mc, heads, n_pts, device)
        gemm_ms = cuda_ms(gemm, 5)
        del gemm
        # the design's reckoning, not a measurement: every tile streams
        # every weight stage of the layers it runs
        l2_reckoned = -(-n_pts // 64) * fe.stream_bytes(packed, heads)
        rec[tag] = dict(n=n_pts, ms=ms, plain_ms=plain_ms, device_ms=dev,
                        gemm_ms=gemm_ms,
                        bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
                        * 1e3,
                        bound_by=("operations" if flops / PEAK_BF16
                                  >= nbytes / PEAK_BYTES else "bytes"))
        log(f"field_eval heads={tag}: {n_pts} points, kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), device {dev} ms, plain "
            f"{plain_ms:.3f} ms, bound {rec[tag]['bound_ms']:.3f} ms, "
            f"matmuls alone {gemm_ms:.3f} ms; L2 weight bytes as the design "
            f"reckons them (not measured) {l2_reckoned / 1e9:.2f} GB")
        del xyz, sun, sems
    per_view = {"all": 2 * n_chunks, "sun": n_chunks}
    kernel_view_ms = sum(per_view[t] * rec[t]["ms"] for t in rec)
    bound_view_ms = sum(per_view[t] * rec[t]["bound_ms"] for t in rec)
    log(f"field kernel time per view (from the per-launch times): "
        f"{kernel_view_ms:.1f} ms of {view_ms:.1f} ms; "
        f"bound {bound_view_ms:.1f} ms")
    # both float32 kernels at the same shapes, beside the bounds of three
    # TF32 products and of FFMA, float32 `torch.matmul` and the module
    from spnerf_torch.render import module_at

    fields32 = {"wgmma_f32": fe.FusedField(packed32, "float32"),
                "general": fe.FusedField(packed_gen, "float32")}
    keys32 = {"wgmma_f32": ("field_eval_f32",),
              "general": ("field_eval_general",)}
    plainf32 = fe.PlainField(packed32, "float32")
    module = module_at(model, "float32")
    rec32 = {}
    for tag, (heads, n_pts) in launch_shapes(rc, chunk,
                                             fe.ALL_HEADS).items():
        xyz, sun, sems = field_inputs(n_pts, 2, device, mc.num_sem_classes)
        ref = plainf32(xyz, sun, None, sems, heads=heads)
        r = rec32[tag] = {"n": n_pts}
        for name, f32_field in fields32.items():
            call = lambda: f32_field(xyz, sun, None, sems, heads=heads)
            out = call()
            errs = {k: (out[k] - ref[k]).abs().max().item() for k in ref}
            log(f"{name} kernel vs plain, float32, heads={tag}, n={n_pts}: "
                f"max abs err " + json.dumps({k: float(f"{v:.3g}")
                                              for k, v in errs.items()}))
            for k, v in errs.items():
                if not (v <= F32_ATOL) or not torch.isfinite(out[k]).all():
                    fail(f"{name} kernel {k}: max abs err {v} > {F32_ATOL}")
            if name == "wgmma_f32":
                f32_err = max(f32_err, max(errs.values()))
            else:
                gen_err["float32"] = max(gen_err["float32"],
                                         max(errs.values()))
            del out
            r[name] = {"ms": cuda_ms(call, 5),
                       "device_ms": device_ms(call, 1,
                                              keys=keys32[name])["kernel"]}
        del ref
        r["plain_ms"] = cuda_ms(lambda: plainf32(xyz, sun, None, sems,
                                                 heads=heads), 2)
        with torch.no_grad():
            r["module_ms"] = cuda_ms(lambda: module(xyz, sun, None, sems,
                                                    heads=heads), 2)
        gemm = gemm_fn(mc, heads, n_pts, device, torch.float32)
        r["gemm_ms_f32"] = cuda_ms(gemm, 3)
        del gemm
        flops = fe.flops_per_point(mc, heads) * n_pts
        outs = sum(w for _, w in fe.active_outputs(mc, heads))
        nbytes = 4 * (n_pts * (fe.in_width(mc) + 3 + outs)
                      + sum(w.numel() for w in packed32.ws)
                      + sum(b.numel() for b in packed32.bs))
        # the least time: three TF32 products on the tensor cores, or the
        # float32 products on the FFMA units; either way above the bytes
        r["bound_ms"] = max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3
        r["bound_ms_ffma"] = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
        r["bound_by"] = ("operations" if 3 * flops / PEAK_TF32
                         >= nbytes / PEAK_BYTES else "bytes")
        for name, bound in (("wgmma_f32", r["bound_ms"]),
                            ("general", r["bound_ms_ffma"])):
            ms = r[name]["ms"]
            log(f"field_eval {name} float32 heads={tag}: {n_pts} points, "
                f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bound / ms:.1%} of its bound {bound:.3f} ms), device "
                f"{r[name]['device_ms']} ms ({card})")
        log(f"  float32 heads={tag}: plain {r['plain_ms']:.3f} ms, module "
            f"{r['module_ms']:.3f} ms, float32 matmuls alone "
            f"{r['gemm_ms_f32']:.3f} ms; bounds 3xTF32 {r['bound_ms']:.3f} ms,"
            f" FFMA {r['bound_ms_ffma']:.3f} ms ({card})")
        del xyz, sun, sems
    view_ms32 = {name: sum(per_view[t] * rec32[t][name]["ms"] for t in rec32)
                 for name in fields32}
    bound_view32 = {k: sum(per_view[t] * rec32[t][k] for t in rec32)
                    for k in ("bound_ms", "bound_ms_ffma")}
    log(f"float32 kernel time per view (from the per-launch times): "
        f"wgmma_f32 {view_ms32['wgmma_f32']:.1f} ms (bound "
        f"{bound_view32['bound_ms']:.1f} ms), general "
        f"{view_ms32['general']:.1f} ms (bound "
        f"{bound_view32['bound_ms_ffma']:.1f} ms); the view "
        f"{view32_rec['view_ms_f32']:.1f} ms")

    def f32_fields(name, bound_key):
        """One float32 kernel's numbers of phase 5 at both launch shapes."""
        a32, s32 = rec32["all"], rec32["sun"]
        return {
            "ms": a32[name]["ms"],
            "plain_ms": a32["plain_ms"],
            "device_ms": a32[name]["device_ms"],
            "bound_ms": a32[bound_key],
            "bound_by": a32["bound_by"],
            "library_ms": None,
            "gemm_ms_f32": a32["gemm_ms_f32"],
            "module_ms": a32["module_ms"],
            "points_per_launch": {t: rec32[t]["n"] for t in rec32},
            "heads": "all",
            "ms_sun": s32[name]["ms"],
            "device_ms_sun": s32[name]["device_ms"],
            "plain_ms_sun": s32["plain_ms"],
            "bound_ms_sun": s32[bound_key],
            "gemm_ms_f32_sun": s32["gemm_ms_f32"],
            "module_ms_sun": s32["module_ms"],
            "launches_per_view": per_view,
            "ms_per_view": view_ms32[name],
            "bound_ms_per_view": bound_view32[bound_key],
            "card": card,
        }

    f32_entry = {
        "name": "field_eval_f32",
        "route": "cuda",
        "source": "spnerf_torch/csrc/field_eval_f32.cu",
        "replaces": "spnerf_tpu/ops/pallas/field_eval.py:104",
        "compute_dtype": "float32",
        "launches_view": launches32,
        **f32_fields("wgmma_f32", "bound_ms"),
        "bound_ms_ffma": rec32["all"]["bound_ms_ffma"],
        "general_ms": rec32["all"]["general"]["ms"],
        "general_ms_sun": rec32["sun"]["general"]["ms"],
        "view_ms": view32_rec["view_ms_f32"],
        "view_ms_general": view32_rec["view_ms_f32_general"],
        "view_ms_module": view32_rec["view_ms_f32_module"],
    }
    general_entry = {
        "name": "field_eval_general",
        "route": "cuda",
        "source": "spnerf_torch/csrc/field_eval_general.cu",
        "replaces": "spnerf_tpu/ops/pallas/field_eval.py:104",
        "compute_dtype": "float32 (phase 5; bfloat16 on phase 17's wide "
                         "field)",
        **f32_fields("general", "bound_ms_ffma"),
        "tile_points": fe.general_tile_rows(mc.fc_units, packed_gen.k0_pad,
                                            0),
        "view_ms_packed_for_it": view32_rec["view_ms_f32_general"],
    }
    del fields32, plainf32, module, packed32, packed_gen
    torch.cuda.empty_cache()

    # the wide route against the plain version across its envelope
    wide_err = {"float32": 0.0, "bfloat16": 0.0}
    wide_cases = ([("float32", w, b, 16) for w in (544, 768, 1024)
                   for b in (False, True)]
                  + [("bfloat16", w, b, 16) for w in (736, 768, 1024)
                     for b in (False, True)]
                  + [("bfloat16", 80, True, 16), ("bfloat16", 512, True, 32)])
    wide_holds = {}
    for dtype, width, beta, t_dims in wide_cases:
        wc = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                         fc_units=width, t_embedding_dims=t_dims)
        wp = fe.pack_params(load_model(
            wc, dtype, device=device,
            generator=torch.Generator().manual_seed(width)), dtype)
        if wp.route != "wgmma_wide":
            fail(f"{dtype} fc_units {width} packs for {wp.route}")
        tag = f"{dtype} w{width}{' beta' if beta else ''} t{t_dims}"
        sizes = (1000, 1, 63, 65, 187) if (width, beta) == (1024, True) else (
            1000,)
        errs = []
        for n in sizes:
            xyz, sun, sems = field_inputs(n, width + n, device, 3)
            t_emb = (torch.from_numpy(np.random.default_rng(n).normal(
                size=(n, t_dims)).astype(np.float32)).to(device)
                if beta else None)
            errs += [hold_field(wp, (xyz, sun, t_emb, sems), h,
                                f"wgmma_wide {tag} n={n}", dtype)
                     for h in subsets]
        wide_holds[tag] = max(errs)
        wide_err[dtype] = max(wide_err[dtype], wide_holds[tag])
        del wp
    log(f"wgmma_wide kernel vs plain, every head subset, n=1000 (and n = 1, "
        f"63, 65, 187 at 1024 with beta): max abs err "
        f"{json.dumps(wide_holds)}")

    # the wide and the general kernel at 768 and 1024, both launch shapes,
    # both dtypes, in the same call, beside the bounds and the yardsticks
    wide_rec = {}
    for width in (768, 1024):
        wc = replace(mc, fc_units=width)
        models = {dtype: load_model(wc, dtype, device=device,
                                    generator=torch.Generator().manual_seed(0))
                  for dtype in ("bfloat16", "float32")}
        module = module_at(models["float32"], "float32")
        for tag, (heads, n_pts) in launch_shapes(rc, chunk,
                                                 fe.ALL_HEADS).items():
            xyz, sun, sems = field_inputs(n_pts, 2, device, mc.num_sem_classes)
            args = (xyz, sun, None, sems)
            r = wide_rec[f"{width} {tag}"] = {"fc_units": width, "n": n_pts,
                                              "heads": tag}
            for dtype in ("bfloat16", "float32"):
                pk = fe.pack_params(models[dtype], dtype)
                if pk.route != "wgmma_wide":
                    fail(f"{dtype} fc_units {width} packs for {pk.route}")
                fields = {"wgmma_wide": fe.FusedField(pk, dtype),
                          "general": fe.FusedField(fe.pack_params(
                              models[dtype], dtype, kernel="general"), dtype)}
                plain_w = fe.PlainField(pk, dtype)
                ref = plain_w(xyz, sun, None, sems, heads=heads)
                atol = F32_ATOL if dtype == "float32" else KERNEL_ATOL
                d = r[dtype] = {}
                for name, fw in fields.items():
                    out = fw(xyz, sun, None, sems, heads=heads)
                    err = max((out[k] - ref[k]).abs().max().item()
                              for k in ref)
                    if not (err <= atol) or not all(
                            torch.isfinite(out[k]).all() for k in ref):
                        fail(f"{name} {dtype} fc_units {width} heads={tag}: "
                             f"max abs err {err} > {atol}")
                    if name == "wgmma_wide":
                        wide_err[dtype] = max(wide_err[dtype], err)
                    else:
                        gen_err[dtype] = max(gen_err[dtype], err)
                    del out
                    d[name] = {"max_abs_err": err}
                del ref
                t = wide_times(pk, dtype, args, heads, 2)
                d["wgmma_wide"].update(ms=t.pop("ms"),
                                       device_ms=t.pop("device_ms"))
                d.update(t)
                d["general"]["ms"] = cuda_ms(
                    lambda: fields["general"](*args, heads=heads), 1)
                d["bound_ms_ffma"] = max(d["flops"] / PEAK_F32,
                                         d["bytes"] / PEAK_BYTES) * 1e3
                for name, bound in (("wgmma_wide", d["bound_ms"]),
                                    ("general", d["bound_ms_ffma"])):
                    ms = d[name]["ms"]
                    log(f"field_eval {name} {dtype} fc_units {width} "
                        f"heads={tag}: {n_pts} points, {ms:.3f} ms "
                        f"({d['flops'] / ms / 1e9:.1f} TFLOP/s, "
                        f"{bound / ms:.1%} of its bound {bound:.3f} ms), max "
                        f"abs err {d[name]['max_abs_err']:.3g} ({card})")
                del fields, plain_w, pk
            r.update(yardsticks(wc, heads, args, module, device))
            log(f"  fc_units {width} heads={tag}: wide device "
                f"{r['bfloat16']['wgmma_wide']['device_ms']} / "
                f"{r['float32']['wgmma_wide']['device_ms']} ms (bf16 / "
                f"float32), plain {r['bfloat16']['plain_ms']:.3f} / "
                f"{r['float32']['plain_ms']:.3f} ms, bf16 matmuls alone "
                f"{r['gemm_ms']:.3f} ms, float32 matmuls alone "
                f"{r['gemm_ms_f32']:.3f} ms, float32 module "
                f"{r['module_ms']:.3f} ms ({card})")
            del xyz, sun, sems, args
            torch.cuda.empty_cache()
        del models, module
    log("wide: " + json.dumps(wide_rec))
    w1024 = wide_rec["1024 all"]["bfloat16"]
    wide_entry = {
        "name": "field_eval_wide",
        "route": "cuda",
        "source": "spnerf_torch/csrc/field_eval_wide.cu",
        "replaces": "spnerf_tpu/ops/pallas/field_eval.py:104",
        "compute_dtype": "bfloat16 (phase 19's 1024-wide run; float32 under "
                         "times)",
        "fc_units": 1024,
        "ms": w1024["wgmma_wide"]["ms"],
        "plain_ms": w1024["plain_ms"],
        "device_ms": w1024["wgmma_wide"]["device_ms"],
        "bound_ms": w1024["bound_ms"],
        "bound_by": w1024["bound_by"],
        "library_ms": None,
        "gemm_ms": wide_rec["1024 all"]["gemm_ms"],
        "gemm_ms_f32": wide_rec["1024 all"]["gemm_ms_f32"],
        "module_ms": wide_rec["1024 all"]["module_ms"],
        "general_ms": w1024["general"]["ms"],
        "points_per_launch": {t: wide_rec[f"1024 {t}"]["n"]
                              for t in ("all", "sun")},
        "heads": "all",
        "clusters": clusters,
        "times": wide_rec,
        "max_abs_err_holds": wide_holds,
        "card": card,
    }
    a = rec["all"]
    field_entry = {
        "name": "field_eval",
        "route": "cuda",
        "source": "spnerf_torch/csrc/field_eval.cu",
        "replaces": "spnerf_tpu/ops/pallas/field_eval.py:104",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "device_ms": a["device_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": None,
        "points_per_launch": {t: rec[t]["n"] for t in rec},
        "heads": "all",
        "ms_sun": rec["sun"]["ms"],
        "device_ms_sun": rec["sun"]["device_ms"],
        "plain_ms_sun": rec["sun"]["plain_ms"],
        "bound_ms_sun": rec["sun"]["bound_ms"],
        "gemm_ms": a["gemm_ms"],
        "gemm_ms_sun": rec["sun"]["gemm_ms"],
        "launches_per_view": per_view,
        "ms_per_view": kernel_view_ms,
        "bound_ms_per_view": bound_view_ms,
        "card": card,
    }
    del render, view, plain, plain32, model, packed, field, plain_field
    torch.cuda.empty_cache()

    log(f"-- phase 6 at {time.time() - t_start:.1f} s")
    # 6. the table-gradient kernels on the hash train step's own inputs
    htr, hdata = train_setup("hash", device=device)
    hstate = htr.init_state(torch.Generator().manual_seed(0))
    n_feat = htr.mc.hash_features
    n_levels = htr.mc.hash_levels
    T = hstate.model.encoding.table_size

    def step_grads(tr, state, data, impl):
        """Loss and table gradient of step 0's batch and draws, with the
        table gradient through `impl` (None: the kernels)."""
        enc = state.model.encoding
        enc.dtab_impl = impl
        state.optimizer.zero_grad(set_to_none=True)
        g = tr.step_generator(0, seed=1)
        batch = tr.sample_batch(data, BATCH, g)
        loss, _ = tr.loss_fn(state, batch, 0, generator=g)
        loss.backward()
        enc.dtab_impl = None
        torch.cuda.synchronize()
        return loss.detach(), enc.table.grad.clone()

    def record_plain(tr, state, data, batched=False):
        """step_grads through the plain version, with the table-gradient
        router wrapped: (the inputs of every call, loss, table gradient).
        Per-level calls record (ids, ct, t_eff, fmajor), batched calls
        (ids, ct, T)."""
        calls = []
        name = "dtab_levels" if batched else "dtab"
        real = getattr(hg, name)

        def recording_levels(ids, ct, T_, impl=None):
            calls.append((ids, ct.contiguous(), T_))
            return real(ids, ct, T_, impl=impl)

        def recording(ids, ct, t_eff, F, impl=None, fmajor=True, sw_acc=None):
            calls.append((ids, ct.contiguous(), t_eff, fmajor))
            return real(ids, ct, t_eff, F, impl=impl, fmajor=fmajor,
                        sw_acc=sw_acc)

        setattr(hg, name, recording_levels if batched else recording)
        try:
            loss, grad = step_grads(tr, state, data, "plain")
        finally:
            setattr(hg, name, real)
        return calls, loss, grad

    def bound_ms(M, t_eff, F=None, id_bytes=8):
        """Each input read once (the ids at their own width, int64 from the
        step) and the table written once, at the card's memory rate."""
        F = n_feat if F is None else F
        return (M * (id_bytes + 4 * F) + F * t_eff * 4) / PEAK_BYTES * 1e3

    kernels = {"dense": dt.dtab_dense, "sorted": dt.dtab_sorted,
               "partials": dt.dtab_sorted_partials}

    def hold(name, ids, ct, t_eff, fmajor, tag, timed=True):
        """Kernel `name` against the plain version on one call (B3 also
        against itself), then timed beside the plain version, `index_add_`
        into a zeroed table, `index_add_` with its zero fill (the function
        the wrapper computes) and the bytes bound. The plain version drops
        ids outside [0, t_eff), as the kernels do."""
        fn = kernels[name]
        out = fn(ids, ct, t_eff, fmajor)
        ref = dt.dtab_plain(ids, ct, t_eff, fmajor)
        err, rel = rel_check(out, ref, f"dtab_{name} {tag}")
        if name == "sorted" and not torch.equal(out, fn(ids, ct, t_eff,
                                                        fmajor)):
            fail(f"dtab_sorted {tag}: two calls differ")
        M = ids.shape[0]
        rec = dict(t_eff=t_eff, M=M, err=err, rel=rel)
        if not timed:
            return rec
        ids_long = ids.long()
        dim = 1 if fmajor else 0
        lib_out = torch.zeros_like(ref)
        rec.update(
            ms=cuda_ms(lambda: fn(ids, ct, t_eff, fmajor), 5),
            plain_ms=cuda_ms(lambda: dt.dtab_plain(ids, ct, t_eff, fmajor), 3),
            library_ms=cuda_ms(lambda: lib_out.index_add_(dim, ids_long, ct),
                               3),
            library_zero_ms=cuda_ms(lambda: torch.zeros_like(ref).index_add_(
                dim, ids_long, ct), 3),
            bound_ms=bound_ms(M, t_eff, id_bytes=ids.element_size()))
        log(f"dtab_{name} {tag}: max abs err {err:.3g} ({rel:.3g} of the "
            f"largest entry), kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, index_add_ {rec['library_ms']:.3f} ms"
            f" ({rec['library_zero_ms']:.3f} ms with its zero fill), bound "
            f"{rec['bound_ms']:.4f} ms")
        return rec

    def hold_edges(name, layouts=(True, False)):
        """Kernel `name` on every edge case of `utils/dtab_cases.py` in the
        layouts given (fmajor flags), int64 and int32 ids; {kind: max
        relative error}."""
        rels = {}
        for kind in EDGE_CASES:
            for fmajor in layouts:
                for ids64 in (True, False):
                    ids, ct, t_eff = edge_case(kind, device, fmajor, ids64)
                    r = hold(name, ids, ct, t_eff, fmajor, f"edge {kind}",
                             timed=False)
                    rels[kind] = max(rels.get(kind, 0.0), r["rel"])
        log(f"dtab_{name} edge cases, fmajor {layouts}, int64 and int32 ids, "
            f"max err / largest entry: {json.dumps(rels)}")
        return rels

    def hold_calls(calls, sw_acc, names, timed=True):
        """Every recorded per-level call on the kernel its route names, held
        and (if timed) timed; {route: [records]} and the profiler's device
        times (None untimed)."""
        per = {n: [] for n in names}
        by = {n: [] for n in names}
        for ids, ct, t_eff, fmajor in calls:
            name = dt.route(t_eff, n_feat, ids.shape[0], sw_acc)
            if name not in per:
                continue
            layout = "f-major" if fmajor else "t-major"
            per[name].append(hold(name, ids, ct, t_eff, fmajor,
                                  f"{layout} t_eff={t_eff} M={ids.shape[0]}",
                                  timed=timed))
            by[name].append((ids, ct, t_eff, fmajor))
        if not timed:
            return per, None
        dev = {n: device_ms(lambda: [kernels[n](*c) for c in by[n]],
                            len(by[n]), keys=PORT_KERNEL_KEYS
                            + (MEMSET_KEYS if n != "sorted" else ()))
               for n in names}
        log(f"device time per launch (profiler): {json.dumps(dev)}")
        return per, dev

    def step_match(tag, tr, state, data, loss_plain, grad_plain):
        loss_k, grad_k = step_grads(tr, state, data, None)
        gerr = ((grad_k - grad_plain).abs().max()
                / grad_plain.abs().max()).item()
        lerr = (abs(loss_k - loss_plain) / abs(loss_plain)).item()
        log(f"{tag}, kernels vs plain: table gradient max abs err / max "
            f"{gerr:.3g}, loss rel err {lerr:.3g} (loss {loss_k.item():.6f})")
        if not (gerr <= STEP_GRAD_RTOL and lerr <= STEP_LOSS_RTOL):
            fail(f"{tag} through the kernels disagrees with the plain version")
        return {"grad_rel_err": gerr, "loss_rel_err": lerr}

    def step_launches(tag, tr, state, data, expect):
        """The kernel launches of one train step (counts set to 0 just
        before it and read just after)."""
        for k in dt.launches:
            dt.launches[k] = 0
        tr.train_step(state, data, BATCH, seed=1)
        torch.cuda.synchronize()
        got = dict(dt.launches)
        log(f"{tag} launches: {json.dumps(got)}")
        want = dict.fromkeys(dt.launches, 0)
        want.update(expect)
        if got != want:
            fail(f"{tag}: expected launches {want}, got {got}")
        return got

    def time_steps(tr, state, data, n, blocks=3):
        """1 warm-up, then `blocks` runs of n steps, each timed with CUDA
        events: ms/step is the median run's, and every run is kept (the
        host-bound steps vary)."""
        tr.train_step(state, data, BATCH, seed=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(blocks):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                ld = tr.train_step(state, data, BATCH, seed=1)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / n)
            loss = ld["loss"].item()
            if not np.isfinite(loss):
                fail(f"train step loss {loss}")
        ms = float(np.median(runs))
        return {"ms_per_step": ms, "rays_per_s": BATCH / ms * 1e3,
                "ms_per_step_runs": runs, "loss": loss, "steps": n * blocks,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": card}

    calls, loss_plain, grad_plain = record_plain(htr, hstate, hdata)
    if len(calls) != 3 * n_levels:
        fail(f"expected {3 * n_levels} table gradients per step, "
             f"recorded {len(calls)}")
    per, dev6 = hold_calls(calls, True, ("dense", "sorted"))
    # skewed ids: half the rows of a hashed level's view-pass call on 64 ids
    ids, ct6, t_eff6, _ = next(c for c in calls if c[2] == T
                               and c[0].shape[0] == BATCH * 64 * 8)
    skew = ids.clone()
    half = skew.shape[0] // 2
    skew[:half] = torch.randint(0, 64, (half,), device=device,
                                generator=torch.Generator(device).manual_seed(3))
    skew_err = {name: hold(name, skew, ct6, t_eff6, True, "skewed",
                           timed=False) for name in ("dense", "sorted")}
    log(f"skewed (half the rows on 64 ids), t_eff={t_eff6} "
        f"M={skew.shape[0]}: " + json.dumps(skew_err))
    edge6 = hold_edges("sorted")
    edge6_dense = hold_edges("dense", (True,))
    del calls, ids
    torch.cuda.empty_cache()

    log(f"-- phase 7 at {time.time() - t_start:.1f} s")
    # 7. the hash train step: kernels vs plain, launches, time
    step_match("hash step", htr, hstate, hdata, loss_plain, grad_plain)
    del grad_plain
    launches7 = step_launches("hash train step", htr, hstate, hdata,
                              {"dtab_dense": 3, "dtab_sorted": 21})
    hash_rec = time_steps(htr, hstate, hdata, 10)
    log("hash train step: " + json.dumps(hash_rec))
    del htr, hdata, hstate
    torch.cuda.empty_cache()

    log(f"-- phase 8 at {time.time() - t_start:.1f} s")
    # 8. the flagship Siren train step and S1, its epilogue kernel
    s_tr, s_data = train_setup("siren", device=device)
    s_state = s_tr.init_state(torch.Generator().manual_seed(0))
    siren_entry = siren_pass(s_tr, s_state, s_data, card)
    siren_rec = time_steps(s_tr, s_state, s_data, 3)
    log("siren train step: " + json.dumps(siren_rec))
    del s_tr, s_data, s_state
    torch.cuda.empty_cache()

    log(f"-- phase 9 at {time.time() - t_start:.1f} s")
    # 9. the (L, T, F) table: t-major B2 and B3, the step
    ttr, tdata = train_setup("hash", device=device, flat_table=False)
    tstate = ttr.init_state(torch.Generator().manual_seed(0))
    shape = tuple(tstate.model.encoding.table.shape)
    if shape != (n_levels, T, n_feat):
        fail(f"(L, T, F) table has shape {shape}")
    calls, loss_plain, grad_plain = record_plain(ttr, tstate, tdata)
    if len(calls) != 3 * n_levels or any(c[3] for c in calls):
        fail(f"expected {3 * n_levels} t-major table gradients per step")
    per9, dev9 = hold_calls(calls, True, ("dense", "sorted"))
    edge9_dense = hold_edges("dense", (False,))
    del calls
    match9 = step_match("(L, T, F) hash step", ttr, tstate, tdata, loss_plain,
                        grad_plain)
    del grad_plain
    launches9 = step_launches("(L, T, F) hash train step", ttr, tstate, tdata,
                              {"dtab_dense": 3, "dtab_sorted": 21})
    tlf_rec = time_steps(ttr, tstate, tdata, 10)
    tlf_rec.update(match9)
    log("(L, T, F) hash train step: " + json.dumps(tlf_rec))
    del ttr, tdata, tstate
    torch.cuda.empty_cache()

    log(f"-- phase 10 at {time.time() - t_start:.1f} s")
    # 10. SPNERF_HASH_SW_ACC=0 on the flat step: B3'
    with env_set("SPNERF_HASH_SW_ACC", "0"):
        htr, hdata = train_setup("hash", device=device)
        hstate = htr.init_state(torch.Generator().manual_seed(0))
        calls, loss_plain, grad_plain = record_plain(htr, hstate, hdata)
        per10, dev10 = hold_calls(calls, False, ("partials",))
        if len(per10["partials"]) != 21:
            fail(f"expected 21 window-route calls, got "
                 f"{len(per10['partials'])}")
        skew10 = hold("partials", skew, ct6, t_eff6, True, "skewed",
                      timed=False)
        log(f"dtab_sorted_partials skewed: {json.dumps(skew10)}")
        edge10 = hold_edges("partials")
        del calls
        match10 = step_match("hash step, SW_ACC=0", htr, hstate, hdata,
                             loss_plain, grad_plain)
        del grad_plain
        launches10 = step_launches(
            "hash train step, SW_ACC=0", htr, hstate, hdata,
            {"dtab_dense": 3, "dtab_sorted_partials": 21})
        acc0_rec = time_steps(htr, hstate, hdata, 10)
        acc0_rec.update(match10)
        log("hash train step, SW_ACC=0: " + json.dumps(acc0_rec))
        del htr, hdata, hstate
    del skew, ct6
    torch.cuda.empty_cache()

    log(f"-- phase 11 at {time.time() - t_start:.1f} s")
    # 11. SPNERF_HASH_SW_BATCHED=1 on the (L, T, F) step: B4
    def hold_batched(ids, ct, T_, tag, timed=True):
        """B4 against dtab_batched_plain and against a second call of
        itself (float atomics: within DTAB_RTOL, not bitwise), then timed
        beside the plain version, `index_add_` on the flattened (L * T, F)
        table with and without its zero fill, and the bytes bound."""
        out = dt.dtab_batched(ids, ct, T_)
        ref = dt.dtab_batched_plain(ids, ct, T_)
        err, rel = rel_check(out, ref, f"dtab_batched {tag}")
        _, rel2 = rel_check(dt.dtab_batched(ids, ct, T_), out,
                            f"dtab_batched {tag}, a second call")
        L_, M = ids.shape
        F = ct.shape[2]
        rec = dict(L=L_, M=M, t_eff=T_, err=err, rel=rel)
        if timed:
            keys = (ids.long() + torch.arange(L_, device=device)[:, None]
                    * T_).reshape(-1)
            flat_ct = ct.reshape(L_ * M, F)
            lib_out = torch.zeros((L_ * T_, F), device=device)
            rec.update(
                ms=cuda_ms(lambda: dt.dtab_batched(ids, ct, T_), 5),
                plain_ms=cuda_ms(lambda: dt.dtab_batched_plain(ids, ct, T_),
                                 3),
                library_ms=cuda_ms(lambda: lib_out.index_add_(0, keys,
                                                              flat_ct), 3),
                library_zero_ms=cuda_ms(lambda: torch.zeros_like(
                    lib_out).index_add_(0, keys, flat_ct), 3),
                bound_ms=L_ * bound_ms(M, T_, F, ids.element_size()))
            log(f"dtab_batched {tag}: max abs err {err:.3g} ({rel:.3g} of "
                f"the largest entry), kernel {rec['ms']:.3f} ms, plain "
                f"{rec['plain_ms']:.3f} ms, index_add_ "
                f"{rec['library_ms']:.3f} ms ({rec['library_zero_ms']:.3f} "
                f"ms with its zero fill), bound {rec['bound_ms']:.4f} ms")
        else:
            log(f"dtab_batched {tag}: max abs err {err:.3g} ({rel:.3g} of "
                f"the largest entry); two calls within {rel2:.3g}")
        return rec

    def hold_batched_edges():
        """B4 on every batched edge case of `utils/dtab_cases.py`, int64
        and int32 ids; {kind: max relative error}."""
        rels = {}
        for kind in BATCHED_CASES:
            for ids64 in (True, False):
                ids, ct, T_ = batched_edge_case(kind, device, ids64)
                r = hold_batched(ids, ct, T_, f"edge {kind}", timed=False)
                rels[kind] = max(rels.get(kind, 0.0), r["rel"])
        log(f"dtab_batched edge cases, int64 and int32 ids, max err / "
            f"largest entry: {json.dumps(rels)}")
        return rels

    with env_set("SPNERF_HASH_SW_BATCHED", "1"):
        ttr, tdata = train_setup("hash", device=device, flat_table=False)
        tstate = ttr.init_state(torch.Generator().manual_seed(0))
        bcalls, loss_plain, grad_plain = record_plain(ttr, tstate, tdata,
                                                      batched=True)
        if len(bcalls) != 3:
            fail(f"expected 3 batched table gradients, got {len(bcalls)}")
        per11 = [hold_batched(ids, ct, T_,
                              f"L={ids.shape[0]} M={ids.shape[1]}")
                 for ids, ct, T_ in bcalls]
        # a skewed level (half its rows on 64 ids) and a level of
        # direct-coarse ids (below 4,913) in the coarse pass's call
        ids, ct, T_ = bcalls[0]
        extra = ids.clone()
        M = extra.shape[1]
        gen = torch.Generator(device).manual_seed(4)
        extra[1] = torch.randint(0, 4913, (M,), device=device, generator=gen)
        extra[2, :M // 2] = torch.randint(0, 64, (M // 2,), device=device,
                                          generator=gen)
        extra11 = hold_batched(extra, ct, T_, "skewed and direct-coarse "
                               "levels", timed=False)
        edge11 = hold_batched_edges()
        dev11 = device_ms(lambda: [dt.dtab_batched(*c) for c in bcalls],
                          len(bcalls), keys=PORT_KERNEL_KEYS + MEMSET_KEYS)
        log(f"device time per launch (profiler): {json.dumps(dev11)}")
        del bcalls, ids, ct, extra
        match11 = step_match("(L, T, F) hash step, SW_BATCHED=1", ttr, tstate,
                             tdata, loss_plain, grad_plain)
        del grad_plain
        launches11 = step_launches(
            "(L, T, F) hash train step, SW_BATCHED=1", ttr, tstate, tdata,
            {"dtab_batched": 3})
        bat_rec = time_steps(ttr, tstate, tdata, 10)
        bat_rec.update(match11)
        log("(L, T, F) hash train step, SW_BATCHED=1: " + json.dumps(bat_rec))
        del ttr, tdata, tstate
    torch.cuda.empty_cache()

    def hold_cli_hash(tr, state, data):
        """Phase 13's hash run: every B2 and B3 call of one step on its own
        inputs against the plain version, at phase 6's tolerances, then the
        step's table gradient and loss through the kernels against the
        plain version's."""
        if tr.mc.hash_features != n_feat:
            fail(f"the CLI's hash field has {tr.mc.hash_features} features, "
                 f"phase 6's {n_feat}")
        calls, loss_plain, grad_plain = record_plain(tr, state, data)
        if len(calls) != 3 * tr.mc.hash_levels:
            fail(f"the CLI's hash step: {len(calls)} table gradients")
        per_cli, _ = hold_calls(calls, True, ("dense", "sorted"), timed=False)
        del calls
        if (len(per_cli["dense"]), len(per_cli["sorted"])) != (3, 21):
            fail(f"the CLI's hash step routes "
                 f"{ {k: len(v) for k, v in per_cli.items()} }")
        out = {f"{n}_{k}": max(r[k] for r in recs)
               for n, recs in per_cli.items() for k in ("err", "rel")}
        out["t_eff"] = {n: sorted({r["t_eff"] for r in recs})
                        for n, recs in per_cli.items()}
        out.update(step_match("the CLI's hash step", tr, state, data,
                              loss_plain, grad_plain))
        log(f"the CLI's hash run, B2 and B3 on its own inputs: "
            f"{json.dumps(out)}")
        return out

    def hold_proposal(tr, state, data):
        """Phase 14's proposal run: every table-gradient call of one step
        on the proposal field's table (F = 2), recorded through the plain
        version, routed to B2 and held against the plain version at phase
        6's tolerance."""
        calls = []
        real = hg.dtab

        def recording(ids, ct, t_eff, F, impl=None, fmajor=True, sw_acc=None):
            calls.append((ids, ct.contiguous(), t_eff, fmajor))
            return real(ids, ct, t_eff, F, impl=impl, fmajor=fmajor,
                        sw_acc=sw_acc)

        enc = state.proposal.encoding
        hg.dtab = recording
        enc.dtab_impl = "plain"
        try:
            state.optimizer.zero_grad(set_to_none=True)
            g = tr.step_generator(0, seed=1)
            batch = tr.sample_batch(data, BATCH, g)
            loss, _ = tr.loss_fn(state, batch, 0, generator=g)
            loss.backward()
        finally:
            hg.dtab = real
            enc.dtab_impl = None
        routes = [dt.route(t_eff, enc.n_features, ids.shape[0])
                  for ids, _, t_eff, _ in calls]
        if len(calls) != enc.n_levels or set(routes) != {"dense"}:
            fail(f"the proposal step's table gradients: {len(calls)} calls, "
                 f"routes {routes}")
        recs = [hold("dense", ids, ct, t_eff, fmajor,
                     f"proposal F={ct.shape[0]} t_eff={t_eff} "
                     f"M={ids.shape[0]}", timed=False)
                for ids, ct, t_eff, fmajor in calls]
        del calls
        out = {"calls": len(recs), "dense_err": max(r["err"] for r in recs),
               "dense_rel": max(r["rel"] for r in recs),
               "t_eff": sorted({r["t_eff"] for r in recs}),
               "M": sorted({r["M"] for r in recs})}
        log(f"the proposal run, B2 on its own table's inputs: "
            f"{json.dumps(out)}")
        return out

    log(f"-- phase 12 at {time.time() - t_start:.1f} s")
    # 12. a DFC2019 scene from disk: load, train, validate down to the MAE
    with tempfile.TemporaryDirectory() as project:
        t12 = time.time()
        val_rec = validation_pass(device, card, project)
        val_rec["phase_s"] = time.time() - t12
        field_entry["launches_validation"] = val_rec["val_launches"]
        log("validation pass: " + json.dumps(val_rec))
        torch.cuda.empty_cache()

        log(f"-- phase 13 at {time.time() - t_start:.1f} s")
        # 13. the training CLI, resume, tools render, a hash run, eval
        t13 = time.time()
        cli_rec = cli_pass(device, card, project, hold_cli_hash)
        cli_rec["phase_s"] = time.time() - t13
        torch.cuda.empty_cache()

        log(f"-- phase 14 at {time.time() - t_start:.1f} s")
        # 14. the occupancy grid, multi-AOI frames, the fine pass and the
        #     proposal sampler through the CLI
        t14 = time.time()
        paths_rec = paths_pass(device, card, project, hold_cli_hash,
                               hold_proposal)
        paths_rec["phase_s"] = time.time() - t14
        torch.cuda.empty_cache()

        log(f"-- phase 15 at {time.time() - t_start:.1f} s")
        # 15. data parallelism over ranks and the four pass layouts
        t15 = time.time()
        mesh_rec = mesh_pass(device, card, project)
        mesh_rec["phase_s"] = time.time() - t15
        torch.cuda.empty_cache()

        log(f"-- phase 16 at {time.time() - t_start:.1f} s")
        # 16. a raw AOI prepared, scored, trained and validated; every
        #     train-step variant over two ranks
        t16 = time.time()
        prep_rec = prep_pass(device, card, hold_cli_hash)
        prep_rec["phase_s"] = time.time() - t16
        torch.cuda.empty_cache()

        log(f"-- phase 17 at {time.time() - t_start:.1f} s")
        # 17. the float32 CLI through the wgmma_f32 kernel, and a bf16 field
        #     wider than the wgmma kernel takes through the general one
        t17 = time.time()
        fp32_rec = fp32_pass(device, card, project)
        fp32_rec["phase_s"] = time.time() - t17
        torch.cuda.empty_cache()

        log(f"-- phase 18 at {time.time() - t_start:.1f} s")
        # 18. bench_torch.py: the bench's program, beside phase 8's step
        bench_rec = bench_pass()
        bench_rec["phase8_siren_ms_per_step"] = siren_rec["ms_per_step"]
        bench_rec["vs_phase8"] = (bench_rec["ms_per_step"]
                                  / siren_rec["ms_per_step"])
        bench_rec["card"] = card
        print(json.dumps({"bench": bench_rec}), flush=True)

        log(f"-- phase 19 at {time.time() - t_start:.1f} s")
        # 19. the wide route's path: the CLI at fc_units 1024, then a
        #     1024-wide float32 view through the wide and the general kernel
        t19 = time.time()
        wide_run = wide_pass(device, card, project)
        wide_run["phase_s"] = time.time() - t19
        print(json.dumps({"wide": wide_run}), flush=True)
        torch.cuda.empty_cache()

        log(f"-- phase 20 at {time.time() - t_start:.1f} s")
        # 20. the wide kernel's soak: its cluster meetings, on clusters of
        #     2, 4 and 8, over >= 20,000 launches
        t20 = time.time()
        soak_rec = soak_pass(device, card)
        soak_rec["phase_s"] = time.time() - t20
        print(json.dumps({"soak": soak_rec}), flush=True)
        torch.cuda.empty_cache()

        log(f"-- phase 21 at {time.time() - t_start:.1f} s")
        # 21. the wide route on clusters of 4 and 8 and with 150 classes:
        #     launches held, the CLI at fc_units 2048, the timed launches
        t21 = time.time()
        cluster_rec = cluster_pass(device, card, project)
        cluster_rec["phase_s"] = time.time() - t21
        print(json.dumps({"cluster": cluster_rec}), flush=True)
        torch.cuda.empty_cache()
    field_entry["launches_cli"] = cli_rec["flagship_run"]["b1"]
    occ, multi = paths_rec["occgrid"], paths_rec["multi"]
    field_entry.update(
        launches_occgrid=occ["b1"],
        max_abs_err_occgrid=occ["view"]["max_abs_err"],
        launches_second_frame=multi["second_frame"]["launches"],
        max_abs_err_second_frame=multi["second_frame"]["max_abs_err"],
        launches_fine=paths_rec["fine"]["b1"],
        launches_proposal=paths_rec["proposal"]["b1"])
    cli_dp, layouts = mesh_rec["cli"], mesh_rec["layouts"]
    field_entry.update(
        launches_dp=[r["b1"] for r in cli_dp["ranks"]],
        max_abs_err_dp=max(r["held"]["max_abs_err"] for r in cli_dp["ranks"]))
    for name in SWITCHES:
        tag = name.removeprefix("SPNERF_").lower()
        field_entry[f"launches_{tag}"] = layouts[name]["launches"]
        field_entry[f"max_abs_err_{tag}"] = layouts[name]["held"][
            "max_abs_err"]

    field_entry.update(
        launches_prep=prep_rec["flagship"]["b1"],
        max_abs_err_prep=prep_rec["flagship"]["launch_max_abs_err"])
    wide = fp32_rec["wide"]
    view = wide_run["view"]
    f32_entry.update(
        launches=fp32_rec["run"]["b1_routes"]["wgmma_f32"],
        launches_render_best=fp32_rec["render_best"]["b1_routes"][
            "wgmma_f32"],
        max_abs_err=max(f32_err, fp32_rec["run"]["launch_max_abs_err"]),
        max_abs_err_cli=fp32_rec["run"]["launch_max_abs_err"])
    general_entry.update(
        launches=view["general"]["launches"],
        max_abs_err=max(gen_err["float32"], gen_err["bfloat16"],
                        view["general"]["max_abs_err"]),
        max_abs_err_f32=max(gen_err["float32"],
                            view["general"]["max_abs_err"]),
        max_abs_err_bf16=gen_err["bfloat16"],
        launches_view_f32_1024=view["general"]["launches"],
        view_ms_f32_1024=view["general"]["ms"])
    run19 = wide_run["run"]
    run21 = cluster_rec["run"]
    # the general kernel on the main paths' CLI runs (route names it for
    # none; it runs packed for it by name only)
    general_entry["launches_on_routes"] = (run19["b1_routes"]["general"]
                                           + run21["b1_routes"]["general"])
    cl_err = {d: max(v for k, v in cluster_rec["held"].items()
                     if k.startswith(d)) for d in ("bfloat16", "float32")}
    wide_entry.update(
        launches=run19["b1_routes"]["wgmma_wide"],
        max_abs_err=max(wide_err["float32"], wide_err["bfloat16"],
                        run19["held"]["max_abs_err"], wide["launch_max_abs_err"],
                        view["wgmma_wide"]["max_abs_err"], *cl_err.values(),
                        run21["held"]["max_abs_err"]),
        max_abs_err_f32=max(wide_err["float32"],
                            view["wgmma_wide"]["max_abs_err"],
                            cl_err["float32"]),
        max_abs_err_bf16=max(wide_err["bfloat16"],
                             run19["held"]["max_abs_err"],
                             wide["launch_max_abs_err"], cl_err["bfloat16"],
                             run21["held"]["max_abs_err"]),
        max_abs_err_cli=run19["held"]["max_abs_err"],
        launches_wide_bf16_768=wide["launches"],
        launches_view_f32_1024=view["wgmma_wide"]["launches"],
        view_ms_f32_1024=view["wgmma_wide"]["ms"],
        soak={k: soak_rec[k] for k in ("launches", "mismatches", "traps",
                                       "s", "max_abs_err_first", "clusters")},
        held_cli_by_output=run19["held"]["by_output"],
        launches_cli_2048=run21["b1_routes"]["wgmma_wide"],
        launches_render_best_2048=cluster_rec["render_best"]["b1_routes"][
            "wgmma_wide"],
        launches_clusters_held=cluster_rec["launches_held"],
        max_abs_err_clusters=cluster_rec["held"],
        max_abs_err_cli_2048=run21["held"]["max_abs_err"],
        held_cli_2048_by_output=run21["held"]["by_output"],
        cli_2048={k: run21[k] for k in ("batch", "peak_gb", "s")},
        times_clusters=cluster_rec["times"],
        clusters_by_size=cluster_rec["clusters"])

    log(f"-- all phases in {time.time() - t_start:.1f} s")

    def entry(name, source_line, recs, launches, extra_recs, dev, **more):
        n = len(recs)
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "library_zero_ms",
                         "bound_ms")}
        e = {
            "name": name,
            "route": "cuda",
            "source": "spnerf_torch/csrc/dtab.cu",
            "replaces": source_line,
            "launches": launches,
            "max_abs_err": max(r["err"] for r in recs + extra_recs),
            "max_rel_err": max(r["rel"] for r in recs + extra_recs),
            "ms": tot["ms"] / n,
            "plain_ms": tot["plain_ms"] / n,
            "bound_ms": tot["bound_ms"] / n,
            "bound_by": "bytes",
            "library_ms": tot["library_ms"] / n,
            "per_launch": "mean over the step's launches at their own ids",
            "ms_per_step": tot["ms"],
            "plain_ms_per_step": tot["plain_ms"],
            "library_ms_per_step": tot["library_ms"],
            "bound_ms_per_step": tot["bound_ms"],
            "device_ms": dev["kernel"],
            "kernel_launches_per_call": dev["launches"],
            "kernels_per_call": dev["names"],
            "library_zero_ms": tot["library_zero_ms"] / n,
            "calls": [{k: v for k, v in r.items() if k not in ("err", "rel")}
                      for r in recs],
            "card": card,
        }
        e.update(more)
        return e

    def tmajor(recs, dev):
        """The same kernel's numbers on the (L, T, F) step's t-major calls."""
        n = len(recs)
        return {k: sum(r[k] for r in recs) / n
                for k in ("ms", "library_ms", "library_zero_ms", "bound_ms")
                } | {"device_ms": dev["kernel"],
                     "kernel_launches_per_call": dev["launches"],
                     "max_rel_err": max(r["rel"] for r in recs)}

    src = "spnerf_tpu/ops/pallas/dtab.py"
    dense = entry("dtab_dense", f"{src}:127", per["dense"],
                  launches7["dtab_dense"], [skew_err["dense"]], dev6["dense"],
                  edge_rel_err={"fmajor": edge6_dense,
                                "tmajor": edge9_dense},
                  tmajor=tmajor(per9["dense"], dev9["dense"]))
    sorted_ = entry("dtab_sorted", f"{src}:307", per["sorted"],
                    launches7["dtab_sorted"], [skew_err["sorted"]],
                    dev6["sorted"], edge_rel_err=edge6,
                    tmajor=tmajor(per9["sorted"], dev9["sorted"]))
    partials = entry("dtab_sorted_partials", f"{src}:307 (branch :475)",
                     per10["partials"], launches10["dtab_sorted_partials"],
                     [skew10], dev10["partials"], edge_rel_err=edge10)
    batched = entry("dtab_batched", f"{src}:584", per11,
                    launches11["dtab_batched"], [extra11], dev11,
                    edge_rel_err=edge11)
    held = cli_rec["hash_run"]["held"]
    dense.update(launches_cli=cli_rec["hash_run"]["b2"],
                 max_abs_err_cli=held["dense_err"],
                 max_rel_err_cli=held["dense_rel"])
    sorted_.update(launches_cli=cli_rec["hash_run"]["b3"],
                   max_abs_err_cli=held["sorted_err"],
                   max_rel_err_cli=held["sorted_rel"])
    mheld, pheld = multi["held"], paths_rec["proposal"]["held"]
    dense.update(launches_multi=multi["b2"],
                 max_abs_err_multi=mheld["dense_err"],
                 max_rel_err_multi=mheld["dense_rel"],
                 launches_proposal=paths_rec["proposal"]["b2"],
                 max_abs_err_proposal=pheld["dense_err"],
                 max_rel_err_proposal=pheld["dense_rel"])
    sorted_.update(launches_multi=multi["b3"],
                   max_abs_err_multi=mheld["sorted_err"],
                   max_rel_err_multi=mheld["sorted_rel"])
    dp_held = mesh_rec["dp"]["held"]
    dp_launches = mesh_rec["dp"]["ranks"][0]["hash"]["launches"]
    for e, route in ((dense, "dense"), (sorted_, "sorted")):
        e.update(launches_dp=dp_launches[e["name"]],
                 max_abs_err_dp=dp_held.get(route, {}).get("max_abs_err"))
        for name in ("SPNERF_BATCH_SOLAR", "SPNERF_BATCH_SC"):
            tag = name.removeprefix("SPNERF_").lower()
            r = layouts[name + "_hash"]
            e[f"launches_{tag}"] = r["launches"][e["name"]]
            e[f"max_abs_err_{tag}"] = r["held"].get(route, {}).get(
                "max_abs_err")
    pheld16 = prep_rec["hash"]["held"]
    dense.update(launches_prep=prep_rec["hash"]["b2"],
                 max_abs_err_prep=pheld16["dense_err"],
                 max_rel_err_prep=pheld16["dense_rel"])
    sorted_.update(launches_prep=prep_rec["hash"]["b3"],
                   max_abs_err_prep=pheld16["sorted_err"],
                   max_rel_err_prep=pheld16["sorted_rel"])
    print(json.dumps({"cli": cli_rec}), flush=True)
    print(json.dumps({"prep": prep_rec}), flush=True)
    print(json.dumps({"mesh": mesh_rec}), flush=True)
    print(json.dumps({"paths": paths_rec}), flush=True)
    print(json.dumps({"fp32": fp32_rec, "view_f32": view32_rec}), flush=True)
    print(json.dumps({
        "kernels": [field_entry, f32_entry, general_entry, wide_entry, dense,
                    sorted_, partials, batched, siren_entry],
        "train_steps": {"hash": hash_rec, "siren": siren_rec,
                        "hash_tlf": tlf_rec, "hash_sw_acc0": acc0_rec,
                        "hash_tlf_batched": bat_rec, "bench": bench_rec},
        "launches_per_step": {"hash": launches7, "hash_tlf": launches9,
                              "hash_sw_acc0": launches10,
                              "hash_tlf_batched": launches11}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
