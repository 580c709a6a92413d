#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfstudio_thermal_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build every kernel from csrc/ with nvcc (sm_90a): the fused-MLP forward
   and backward, the hash-grid kernels and the fused ray-march /
   whole-field forward and backward, one nvcc per source, started
   together; build seconds and registers; then `cuobjdump -sass` of the
   built libraries: every exact-f32 kernel (the forward over each x0
   fill, the backward's walk and dW stage) runs FFMA and holds no
   tensor-core instruction (HMMA, HGMMA, ...), or the run fails;
3. the fused-MLP forward kernel against its plain PyTorch version on the
   card, at the main path's shape and in the other supported modes, each
   line naming the path that ran (the wgmma kernel of the 8 x 256 stacks,
   the one-pass narrow kernel of the 64-wide ones, the f32 kernel);
   kernel, plain, library (a chain of torch.matmul calls, a yardstick the
   port never calls) and bound times: bf16 at the base stack, f32 (bound
   at 67 TFLOP/s FMA) at the base stack (1,048,576 points), a 3 x 64
   proposal stack (4,194,304) and the colour head (1,048,576), and f32 at
   a ragged N (100,003: the base, the RGBT head, a stack with 288-wide
   hidden layers run in column passes) untimed;
4. the fused-MLP backward kernel against its plain version (dx, every dW,
   every db) in the same modes; at the base shape (N = 262,144, the RGB
   field's points per training step), bf16 and f32, and at f32 also the
   proposal stack (4,194,304) and the colour head (1,048,576), kernel,
   plain, bound, library (forward + torch.autograd.grad through the
   torch.matmul chain) and forward + backward kernel times, and the
   workspace's bytes;
5. the three hash-grid kernels (forward, table gradient, position
   gradient) against their plain versions, in bf16 and f32, at the
   thermal-nerfacto base field's shape (L = 16, T = 2^19, 8192 rays x 48
   samples), a proposal field's (L = 5, T = 2^17, 8192 x 256) and a table of
   4096 rows (the shape of the TPU's one-hot route), with points on grid
   coordinates and points zeroed as the fields' selector zeroes them;
   kernel, plain, bound and (table gradient: one Tensor.index_add_ of the
   precomputed contributions) library times. These uniform points are not
   the model's: its points are ray-major, the samples of a ray consecutive
   and sorted by depth, so phase 8b times the same kernels on the model's
   own points;
6. the fused ray-march kernels (forward and backward, with and without
   input gradients) and the whole-field kernels (C = 3 and 1) against
   their plain versions, bf16 and f32, at thermal-nerfacto-tpu's shapes:
   the cross density (8 x 256 base, 1,048,576 points per render chunk,
   65,536 per training step), both proposal stacks (3 x 64; x 128 and x 48
   samples) and the fields (1,048,576 / 262,144 points), with rays whose
   samples leave the unit ball and the box and samples with tied inf-norm
   components; the whole-field forward's head input (written for the
   backward) equal to the plain version's bitwise, and its output the same
   without it; in both dtypes kernel (the field forward as a training step calls it,
   writing the head input, and as ms_render as a render chunk does, with
   none), plain, library (a chain of
   PyTorch ops and torch.matmul calls, a yardstick the port never calls)
   and bound times;
7. the render path of each method at full width (seeded random weights):
   thermal-nerfacto-tpu, thermal-nerfacto and thermal-nerfacto-tpu+fused
   (thermal-nerfacto-tpu with fused_raymarch, fused_field and
   fused_raymarch_proposals, the knobs bench.py sets for its fused
   candidates) answer render requests through get_outputs_for_camera /
   render_camera_device: 1920x1080 and 640x512. Every image output must be
   finite and of the right shape, the launch counts per chunk must be what
   the method implies (4 fused-MLP forwards; 8 hash forwards: two
   proposals, the field and the cross density per modality; 6 ray-march
   forwards, four proposals and two cross densities, and 2 whole-field
   forwards, none writing the head input), and a small render must agree
   with the same model evaluated on the CPU;
8. the training path of each method: a scene of its own (8 RGB 640x480
   and 8 thermal 640x512 frames of a ray-traced textured sphere) trains
   the method at full width through setup_trainer -> Trainer.setup ->
   Trainer.train for 30 steps of 8192 rays. Every loss is finite on every
   step, or else the step is run once more from its starting state on the
   card and on the CPU's plain path (same batch, the card's own jitter
   draws) and both must give non-finite values in exactly the same losses;
   every parameter is finite after the run, every
   param group (and every hash table) changes, each step's launch counts
   are what the code implies (the proposal backwards only on steps that
   update the proposal nets), the proposal update counter follows
   proposal_updated, and the batches come from the native (C++) batch
   sampler; train ms/step and rays/s over steps 10-29, peak memory;
8b. the hash kernels on the model's own points: the 8 hash calls of one
   thermal-nerfacto render chunk (recorded in phase 7 from one 512 x 64
   chunk of the 1080p camera) and the 8 of its training step 9 (phase 8;
   every step before 10 updates the proposals), with the cotangents that
   step's backward gave them. Each call's forward (in its dtype and in f32)
   and, for the step, its table and position gradients are held against
   the plain versions under the tolerances of phase 5 and timed with
   bound, rows touched and (table gradient) the index_add_ yardstick; the
   `hash_model` lines give each call and the sums per chunk and per step;
9. for each method one full-width step of 256 rays on the card against the
   same step on the CPU (same params, batch and jitter): every loss term
   and every group's gradient; then the same for thermal-nerfacto-tpu and
   its +fused variant with f32 compute, where the kernels' products are
   exact f32 (and for thermal-nerfacto-tpu with 4 encoding frequencies,
   where every group is held to 1e-3); each f32 step also runs on the card
   in bf16, a control held against the CPU's f32 step, which must break
   every f32 limit in at least one loss or group; the f32 card steps'
   launches are counted (every kernel of the method's step launched, every
   fused-MLP forward on the f32 path) for the JSON line's f32 entries;
10. the stage split of every timed backward of phases 4 and 6 (device ms
   per call from torch.profiler: the one-pass kernel of a narrow stack, or
   the walk, the dW tiles and the slab sums, and the per-point and per-ray
   passes), after the timed phases; then the field_split line: the
   whole-field forward at 1,048,576 points as a training step and as a
   render chunk call it, its time (CUDA events) and each kernel's device
   ms (torch.profiler), beside row 3's cross density on the same rays;
11. the entry points, for each method: a second sphere scene (10 RGB and
   10 thermal frames, so the 0.9 split holds one of each out for eval);
   `scripts.train.main` (ns-train) trains the method at full width for 41
   steps with an eval ray batch and an eval image at steps 20 and 40 and the
   whole eval set at 40 (for +fused, the three knobs set by flags), and
   must write finite eval_* batch losses, an eval image's PSNR, SSIM and
   LPIPS, the eval_all means of both modalities and the eval PNGs (a
   failed eval, which the trainer prints and trains past, fails the
   phase); every kernel of the method's path must have launched;
   `scripts.eval.main` (ns-eval) reloads config.yml and the checkpoint,
   launches the render kernels, and must give the step-40 eval_all metrics
   within 1e-4; the card's PSNR, SSIM and LPIPS of each eval image must
   equal the CPU's on the same pixels within 1e-4 relative; ms/step with
   evals on, s per eval image, rays/s, and the SSIM and LPIPS ms per
   640x480 image on the card;
12. a JSON line of the ported kernels (rows 3 and 4 at their three shapes:
   the cross density and both proposal stacks, each with the launches of
   its stack in the fused training run; the hash kernels with their sums
   on the model's points as the extra fields model_render_chunk and
   model_train_step; row 5 and 6 at C = 4 as the extra field c4; rows
   1-6 at f32 compute as the entries fused_mlp_fwd_f32 ...
   fused_field_mlp_bwd_f32, with the launches of phase 9's f32 steps and
   the NeRF stacks' f32 numbers of phase 16; phase 13's numbers as the
   extra fields below), then the total wall time and the contract line.
13. the rest of thermal-nerfacto's config surface and the nerfacto family
   (after phase 11; the JSON line reads it):
   - rows 1-2 on the density TV loss's 7 x 5000 raw points (the base
     stack of thermal-nerfacto-tpu, most points zeroed outside (0, 1)^3,
     the TV loss's density-only cotangent) against their plain versions,
     bf16 and f32, timed with bound (extra field tv_points); rows 5-6 at
     C = 4 run in phase 6 beside C = 3 and 1;
   - eight configurations (SURFACE), each trained 12 steps (timed 2-11)
     through train_phase's checks and rendered (640x512; the shared modes
     also 1920x1080) with finite outputs of the configuration's names and
     launches per chunk as it implies: thermal-nerfacto in the shared and
     rgb_only density modes, thermal-nerfacto-tpu+fused in shared (the
     whole field at C = 4), thermal-nerfacto with both density TV losses
     at TV_SMOKE_MULT, gradient scaling and one RGB proposal net for both
     iterations (called twice a chunk), and nerfacto, nerfacto-tpu,
     nerfacto-big and nerfacto-huge on an RGB-only Nerfstudio-layout
     sphere scene; ms/step, rays/s, peak memory, s/frame; each kernel's
     launches per configuration (extra field config_surface_launches);
   - 13b: the hash kernels on nerfacto-huge's (base L16 T 2^21 to 8192, the
     second proposal's L7 T 2^17 to 2048) and nerfacto-big's (L16 T 2^21
     to 4096) own points of training step 1, as phase 8b (extra fields
     model_<configuration>_train_step);
   - the f32 card-vs-CPU step (phase 9's limits and bf16 control) of
     thermal-nerfacto-tpu+fused in shared mode and of thermal-nerfacto-tpu
     in rgb_only (4 frequencies; thermal-nerfacto's bf16 control stays
     within the loss limit);
   - ns-train of thermal-nerfacto with --pipeline.model.density-mode
     shared, RAdam with max_norm and a cosine schedule on the fields group
     and --trainer.gradient-accumulation-steps 2 for 6 steps (parameters
     change only on every second step, every group then), then ns-eval on
     its config.yml.
14. the render surface, fused_modalities and the trainer's profiler (after
   phase 13; the JSON line's extra fields ns_render_launches and
   fused_modalities_launches read it):
   - ns-render (`scripts.render.main`, as a user runs it) on phase 11's
     thermal-nerfacto run: camera-path, a 3-frame JSON path at 1920x1080
     with rgb, rgb_thermal, depth, removal and removal_thermal, and a
     1-frame path with --removal-min-density-diff 0.1 (every render must
     see the threshold); interpolated --rgb-poses-only true, spiral (30
     frames) and dataset at the eval cameras' sizes; and the 3-frame path on
     the thermal-nerfacto-tpu+fused run. Every PNG frame must decode to its
     camera's size and each run's launches must be what its chunks imply
     (row 8: 8 hash forwards a chunk; rows 3 and 5: 6 ray-march and 2
     whole-field forwards). Seconds per 1080p frame through the command,
     split into render (render_camera_device + synchronize) and host work
     (PNG encodes and depth colormaps timed apart, the rest transfers);
   - every camera type (and a perspective frame with crop_aabb): a 32x24
     frame through render_camera_device on the card and on the CPU's plain
     path from the run's checkpoint, phase 7's tolerance (the crop frame's
     faint rays, whose expected depth is a ratio of rounding residues,
     held to the frame's clip range, and their weight sums logged); one 1920x1080
     frame with include_per_sample and one without, with their peak memory;
   - thermal-nerfacto-tpu and thermal-nerfacto with fused_modalities in
     turns with the same method unfused (unfused, fused, fused, unfused),
     30 steps each through phase 8's checks (losses finite or witnessed,
     every group changes, each step's launches: the flag runs the
     sequential path with a 3-channel thermal head, so a step launches what
     an unfused step does); ms/step of each run;
   - ns-train of thermal-nerfacto with --trainer.profiler xla for 16
     steps: its profiler_traces/trace.json must name the hash kernels.

15. the data path and the instant-ngp family (after phase 14; the JSON
   line's hash kernels carry its numbers as extra fields):
   - the JPEG fixtures of tests/data/jpeg decode (the port's baseline
     decoder, built with g++) to the Pillow hashes of their manifest, the
     progressive one is refused; a 1920x1080 decode and its 0.5x BILINEAR
     resize are timed on the host;
   - the blender, instant_ngp and COLMAP (JPEG) scenes parse through
     build_dataparser (camera counts, sizes, scene boxes);
   - instant-ngp trains 48 steps through ns-train at full width (16
     levels, T = 2^19, 192 samples, 4096 rays to start, bf16) on a 10-frame
     RGB sphere scene: the grid updates at steps 0, 16 and 32 (occupied
     cells, live samples per ray), the dynamic batch after each, launches
     per step (row 8 once, twice on a grid update; rows 7/9 once; row 10
     never), every loss finite, ms/step over steps 34-47 (one batch size),
     rays/s and samples/s, peak memory; step 32's hash calls (the grid
     update's 2^18 points and the step's samples) go through phase 8b's
     checks and timings (rows 7-9 only); an f32 256-ray step on the card
     against the CPU's (phase 9's limits, the grid after the update within
     1e-5 rel L2 and the same live samples) with a bf16 control that must
     break a limit; a 1920x1080 and a 640x512 frame from the run's
     checkpoint (every sample, no grid: one hash forward a chunk), and
     ns-eval of the run;
   - instant-ngp-bounded trains 24 steps through ns-train on an
     instant_ngp-format scene (no contraction, near 0.01) and renders a
     640x480 frame whose black background keeps rgb <= accumulation;
   - nerfacto trains 20 steps on the COLMAP JPEG scene through phase 8's
     checks (rows 7-10 with camera gradients).
16. vanilla-nerf, mipnerf, tensorf and depth-nerfacto (after phase 15; the
   JSON line's rows 1-2 and hash kernels carry its numbers as extra
   fields: nerf_stacks, model_<method>_train_step, <method>_launches):
   - rows 1-2 on the frequency NeRF's base stacks (8 x 256, skip at 4, the
     last layer 256, over a 63- or 99-wide input encoded outside the
     kernel), bf16 and f32, against their plain versions: the forward at
     1,048,576 points, the backward at 262,144, with plain, library and
     bound times;
   - vanilla-nerf (4096 rays) and mipnerf (1024 rays) train 30 steps each
     through ns-train on an 8-frame 800x800 blender scene, with the
     default use_pallas off (no launch) and on (rows 1-2 twice a step,
     the coarse and the fine pass); every loss finite, the field changed;
     step 9's two fused-MLP calls held against the plain versions on their
     own inputs and cotangents and timed; frames from the reloaded run
     (vanilla-nerf 1920x1080 and 640x512, mipnerf 640x512; row 1 twice a
     chunk), ns-eval, and an f32 256-ray step against the CPU's at 4
     position frequencies with a bf16 control (phase 9's limits);
   - tensorf trains 30 steps with its grids upsampled after steps 10 and
     20 (128 -> 196 -> 300: the grids, zero moments and the kept count
     checked after each), renders 640x512, and its ns-eval must raise as
     the JAX package's reload does (the checkpoint's 300^2 grids against
     the config's 128);
   - depth-nerfacto trains 30 steps on a 10-frame sphere scene with 16-bit
     depth PNGs (depth_loss and depth_mae finite every step, eval batches'
     depth_mae, rows 7-10 by proposal update), its step-9 hash calls go
     through phase 8b's checks and timings, a 640x512 frame, ns-eval;
   - ms/step, seconds per frame and peak memory of each method.

--profile DIR additionally writes torch.profiler tables of one 1080p chunk
and of one training step of each method to DIR. Exits non-zero without
CUDA; imports nothing of JAX.
"""

import argparse
import collections
import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BASE_FREQ = (10, 0.0, 9.0, True)
BASE_DIMS = (256,) * 7 + (16,)
# bf16: one flipped bf16 rounding in an early layer moves the output by
# about one bf16 step (2^-8 relative); f32: same exact products and sums in
# another order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Backward, per tensor, relative L2 error: f32 exact products summed in
# another order over N; bf16 one flipped rounding of dh or of a relu mask
# at a tie moves a layer's dW by about 2^-8 relative.
BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# One training step, card against CPU (bf16 MLPs): losses relative; each
# group's gradient relative L2 per method (METHODS' step_grad_tol).
STEP_LOSS_TOL = 2e-2
# The same step with f32 compute (the kernels' f32 paths: exact f32
# products, no TF32). A control shows that each limit tells the f32 path
# from a bf16 one: the card's bf16 step from the same params, batch and
# jitter, held against the CPU's f32 step, must exceed each limit in at
# least one loss or group. Readings below: H100, f32 step / bf16 control.
# - Losses relative 4e-4: the interlevel and distortion losses are small
#   sums of differences of prefix sums over ~200 samples a ray (f32 at most
#   1.35e-4, interlevel; the control at least 1.11e-3, rgb).
# - Gradients, relative L2 per group, 1e-3 for the field and proposal
#   groups, the limit the port's CPU step holds against the JAX package's
#   f32 step (tests/test_torch_train.py): the same f32 arithmetic in other
#   orders (f32 at most 2.7e-4; the control 2.3e-3-1.1e-2).
# - The camera groups' gradients reach the poses through the base field's
#   frequency encoding, whose backward multiplies the card's and the CPU's
#   one-ulp differences in sin and cos by the frequency (up to 2 pi 2^9).
#   The gap grows with the top frequency (camera_opt 3.4e-5 with 4
#   frequencies, 5.7e-3 with the method's 10), so they are held to 1e-3
#   with 4 frequencies (F32_CHECK_FREQS; every group then must read
#   <= 1e-3; the control's cameras 1.2e-2 and 2.5e-2) and to 2e-2 with 10
#   (the control 3.6e-2-1.6e-1).
STEP_LOSS_TOL_F32, STEP_GRAD_TOL_F32, STEP_CAMERA_GRAD_TOL_F32 = 4e-4, 1e-3, 2e-2
F32_CHECK_FREQS = 4
TRAIN_STEPS, TIMED_FROM = 30, 10
# The entry-point phase: ns-train for 41 steps with an eval batch and an eval
# image at steps 20 and 40 and the whole eval set at 40, on a scene of 10
# pairs, whose 0.9 split holds one RGB and one thermal frame out for eval
# (in that order: the scene writes its RGB frames first). ns-eval reloads the
# run (the final checkpoint, written after step 40 with the same parameters)
# and must give the step-40 eval_all metrics within ENTRY_EVAL_TOL absolute:
# the same deterministic renders and metrics. The card's metrics of one eval
# image must equal the CPU's on the same pixels within ENTRY_CPU_TOL
# relative (f32 both, no TF32; a layout or TF32 fault in the VGG would show).
ENTRY_STEPS, ENTRY_EVERY, ENTRY_EVAL_ALL, ENTRY_PAIRS = 41, 20, 40, 10
ENTRY_EVAL_HEIGHTS = {20: 480, 40: 512}  # the eval image of each eval step: RGB, then thermal
ENTRY_EVAL_TOL, ENTRY_CPU_TOL = 1e-4, 1e-4
# Hash kernels against their plain versions. Forward: the same f32 products
# and sums in the same order (no FMA contraction), so equal up to 1e-6
# absolute, plus one bf16 step (2^-8 relative) for a bf16 output. Table
# gradient: atomics add the same f32 terms in a run-dependent order, up to
# ~10^3 signed terms per coarse-level row: relative L2 1e-4. Position
# gradient: the same arithmetic with the sum over levels in another order:
# relative L2 1e-5.
HASH_FWD_TOL, HASH_TABLE_TOL, HASH_POS_TOL = 1e-6, 1e-4, 1e-5
# Launches per render chunk, and per training step (given whether the step
# updates the RGB proposal nets), of each method. thermal-nerfacto-tpu: the
# base field's fused MLP, twice per modality (its samples and the cross
# density). thermal-nerfacto: per modality two proposal fields, the field
# and the cross density run the hash forward; each one's backward runs
# (table and positions: camera gradients reach every hash field) except
# the RGB proposals' on a step that does not update them (their densities
# are detached then); the thermal proposals update every step.
# thermal-nerfacto-tpu+fused: per modality two proposal fields and the
# cross density run the ray-march forward and the field the whole-field
# forward; each one's backward runs except the RGB proposals' on a step
# that does not update them, and only the cross densities' backward takes
# input gradients (the proposals see detached rays:
# proposal_camera_gradients is off).
# step_grad_tol, the card-against-CPU step's gradient limit:
# thermal-nerfacto-tpu's camera groups sum small signed terms through 8 x
# 256 bf16 layers, where a flipped bf16 rounding weighs most (read ~3e-2);
# thermal-nerfacto's narrow bf16 MLPs flip less, and its table gradients
# differ only in the atomics' summation order (read <= 1.6e-3).
FUSED_KNOBS = ("fused_raymarch", "fused_field", "fused_raymarch_proposals")
METHODS = {
    "thermal-nerfacto-tpu": dict(
        chunk={"fused_mlp_fwd": 4},
        step=lambda updated: {"fused_mlp_fwd": 4, "fused_mlp_bwd": 4},
        step_grad_tol=5e-2,
    ),
    "thermal-nerfacto": dict(
        chunk={"hash_encode_fwd": 8},
        step=lambda updated: {
            "hash_encode_fwd": 8,
            "hash_encode_bwd_table": 6 + 2 * updated,
            "hash_encode_bwd_pos": 6 + 2 * updated,
        },
        step_grad_tol=1e-2,
    ),
    "thermal-nerfacto-tpu+fused": dict(
        chunk={"fused_ray_mlp_fwd": 6, "fused_field_mlp_fwd": 2},
        step=lambda updated: {
            "fused_ray_mlp_fwd": 6,
            "fused_field_mlp_fwd": 2,
            "fused_field_mlp_fwd_head_input": 2,
            "fused_ray_mlp_bwd": 4 + 2 * updated,
            "fused_ray_mlp_bwd_input_grads": 2,
            "fused_field_mlp_bwd": 2,
        },
        step_grad_tol=5e-2,
    ),
}

# Phase 13, the rest of thermal-nerfacto's config surface and the nerfacto
# family: each configuration ("method:tag" for settings on a registered
# method) trains SURFACE_STEPS steps (timed from SURFACE_TIMED_FROM) and
# renders its frames. Launch counts: one field and one proposal stack in
# shared and rgb_only (3 hash forwards a chunk: two proposals and the
# field; no thermal hierarchy, no cross density); +fused shared: the two
# proposals through the ray march and the field (C = 4) through the
# whole-field kernel; the TV configuration: one RGB proposal net called by
# both proposal iterations, and each step two more hash forwards and table
# gradients for the density TV losses (their points need no position
# gradient); the nerfacto family: one modality (hash: 3 forwards;
# nerfacto-tpu: the fused base MLP once).
TV_SMOKE_MULT = 0.1  # tv_rgb_loss_mult and tv_thermal_loss_mult of the TV configuration
SURFACE_STEPS, SURFACE_TIMED_FROM, SURFACE_CAPTURE_STEP = 12, 2, 1
ONE_PROPOSAL = [{"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 128, "use_linear": False}]
# the model settings a "method:tag" name stands for
TAGS = {
    "shared": dict(density_mode="shared"),
    "rgb_only": dict(density_mode="rgb_only"),
    "tv+scaling+one-proposal": dict(
        tv_rgb_loss_mult=TV_SMOKE_MULT, tv_thermal_loss_mult=TV_SMOKE_MULT, use_gradient_scaling=True,
        use_same_proposal_network=True, proposal_net_args_list=ONE_PROPOSAL),
    "fused_modalities": dict(fused_modalities=True),
}


def _hash_step(fixed: int, proposals: int = 2, tv: int = 0):
    """Hash launches of a step: `fixed` fields with every backward (the
    field, the cross density), `proposals` proposal calls whose backward
    runs only on an updating step, `tv` TV calls (forward and table
    gradient only)."""
    return lambda updated: {
        "hash_encode_fwd": fixed + proposals + tv,
        "hash_encode_bwd_table": fixed + proposals * updated + tv,
        "hash_encode_bwd_pos": fixed + proposals * updated,
    }


SURFACE = {
    "thermal-nerfacto:shared": dict(
        scene="rgbt", renders=("640x512", "1080p"),
        chunk={"hash_encode_fwd": 3}, step=_hash_step(1), step_grad_tol=1e-2),
    "thermal-nerfacto:rgb_only": dict(
        scene="rgbt", renders=("640x512",),
        chunk={"hash_encode_fwd": 3}, step=_hash_step(1), step_grad_tol=1e-2),
    "thermal-nerfacto-tpu+fused:shared": dict(
        scene="rgbt", renders=("640x512", "1080p"),
        chunk={"fused_ray_mlp_fwd": 2, "fused_field_mlp_fwd": 1},
        step=lambda updated: {"fused_ray_mlp_fwd": 2, "fused_field_mlp_fwd": 1, "fused_field_mlp_fwd_head_input": 1,
                              "fused_ray_mlp_bwd": 2 * updated, "fused_field_mlp_bwd": 1},
        step_grad_tol=5e-2),
    "thermal-nerfacto:tv+scaling+one-proposal": dict(
        scene="rgbt", renders=("640x512",), chunk={"hash_encode_fwd": 8},
        # per modality the field and the cross density; the thermal
        # proposals update every step, the RGB one only on updating steps
        step=_hash_step(6, tv=2), step_grad_tol=1e-2),
    "nerfacto": dict(scene="rgb", renders=("640x512",), chunk={"hash_encode_fwd": 3}, step=_hash_step(1)),
    "nerfacto-tpu": dict(scene="rgb", renders=("640x512",), chunk={"fused_mlp_fwd": 1},
                         step=lambda updated: {"fused_mlp_fwd": 1, "fused_mlp_bwd": 1}),
    "nerfacto-big": dict(scene="rgb", renders=("640x512",), chunk={"hash_encode_fwd": 3}, step=_hash_step(1)),
    "nerfacto-huge": dict(scene="rgb", renders=("640x512",), chunk={"hash_encode_fwd": 3}, step=_hash_step(1)),
}
# the hash calls of phase 13's model points to hold and time (phase 13b):
# (configuration, (levels, log2 T) of the calls kept)
SURFACE_HASH = {"nerfacto-huge": ((16, 21), (7, 17)), "nerfacto-big": ((16, 21),)}

# Phase 14, the render surface. ns-render renders RENDER_PATH_FRAMES frames
# of a camera path at 1920x1080 with RENDER_NAMES on the entry points' runs;
# each camera type renders a TYPE_HW frame on the card and on the CPU.
# fused_modalities runs the sequential path with a 3-channel thermal head:
# every field, proposal net and cross density once per modality
# (thermal-nerfacto-tpu: the fused MLP for the two fields and the two cross
# densities).
RENDER_PATH_FRAMES = 3
RENDER_NAMES = ("rgb", "rgb_thermal", "depth", "removal", "removal_thermal")
RENDER_HW = (1080, 1920)
TYPE_HW = (24, 32)
CROP_BOX = [[-0.3, -0.3, -0.3], [0.3, 0.3, 0.3]]
PROFILE_STEPS = 16  # the "xla" profiler traces the steps after 10 through 15
FUSED_MODALITIES = {
    f"{m}:fused_modalities": dict(chunk=METHODS[m]["chunk"], step=METHODS[m]["step"],
                                  step_grad_tol=METHODS[m]["step_grad_tol"])
    for m in ("thermal-nerfacto-tpu", "thermal-nerfacto")
}


def method_config(name: str):
    """The registered method, with the fused knobs on for a "+fused" name
    and, for a "method:tag" name (phase 13), the settings TAGS gives."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config

    method_name, _, tag = name.partition(":")
    base, _, variant = method_name.partition("+")
    method = get_method_config(base)
    if variant:
        assert variant == "fused", name
        for knob in FUSED_KNOBS:
            setattr(method.model, knob, True)
    if tag == "colmap":  # phase 15: the method on a COLMAP scene
        from nerfstudio_thermal_torch.data.dataparsers.colmap_dataparser import ColmapDataParserConfig

        method.dataparser = ColmapDataParserConfig()
        return method
    for key, value in TAGS[tag].items() if tag else ():
        setattr(method.model, key, copy.deepcopy(value))
    return method


def spec(name: str) -> dict:
    """A configuration's launch counts (and step limits): METHODS, SURFACE,
    FUSED_MODALITIES or DATA_SURFACE."""
    return METHODS.get(name) or SURFACE.get(name) or FUSED_MODALITIES.get(name) or DATA_SURFACE[name]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (label, function, arguments) of each timed backward, for the stage split
# printed after the timed render and training phases (a profiler session
# slows the host ops that follow it); the tensor arguments wait on the host,
# so the card's memory holds none of them through those phases
STAGE_CALLS = []
STAGES = (("one-pass", "fused_mlp_bwd_narrow"), ("walk", "fused_mlp_bwd_walk"), ("dW", "fused_mlp_bwd_dw"),
          ("sums", "sum_slabs"))


def stage_split(fn, iters: int = 5) -> dict:
    """Device ms per call of each stage of a fused-MLP backward (the
    one-pass kernel, or the walk, the dW tiles and the slab sums; "other"
    holds the per-point and per-ray passes), read from torch.profiler over
    `iters` calls."""
    split = {}
    for name, ms in kernel_split(fn, iters).items():
        stage = next((stage for stage, key in STAGES if key in name), "other")
        split[stage] = split.get(stage, 0.0) + ms
    return split


def kernel_split(fn, iters: int = 5) -> dict:
    """Device ms per call of each kernel fn launches, by kernel name
    (template arguments kept), from torch.profiler over `iters` calls."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        if us <= 0:
            continue
        name = re.sub(r"\(anonymous namespace\)::", "", ev.key).split("(")[0].replace("void ", "").strip()
        split[name] = split.get(name, 0.0) + us / 1e3 / iters
    if not split:
        raise AssertionError("torch.profiler saw no device time")
    return split


def park_stage_call(label: str, fn, *args) -> None:
    STAGE_CALLS.append((label, fn, tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)))


def stage_lines():
    """The stage split of each parked backward, its arguments back on the
    card for the split only."""
    while STAGE_CALLS:
        label, fn, args = STAGE_CALLS.pop(0)
        args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
        yield stage_line(label, stage_split(lambda: fn(*args)))
        del args
        torch.cuda.empty_cache()


def stage_line(name: str, split: dict) -> str:
    return f"bwd_stages {name}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())


def mlp_params(gen, in_dim, dims, skips, freq):
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    enc_dim = fm.encoding_dim(in_dim, freq)
    ws, bs, prev = [], [], enc_dim
    for i, dout in enumerate(dims):
        din = prev + (enc_dim if (i in skips and i != 0) else 0)
        ws.append((torch.randn(din, dout, generator=gen) / math.sqrt(din)).cuda())
        bs.append((torch.randn(dout, generator=gen) * 0.1).cuda())
        prev = dout
    return ws, bs


def library_mlp(x, ws, bs, skips, freq, out_act, dtype):
    """The same MLP as a chain of torch.matmul calls in the compute dtype
    (cuBLAS): a yardstick only."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    x0 = (fm.encode(x, freq) if freq is not None else x).to(dtype)
    h = x0
    for li, (w, b) in enumerate(zip(ws, bs)):
        inp = torch.cat([x0, h], -1) if (li in skips and li != 0) else h
        h = torch.matmul(inp, w) + b
        h = torch.relu(h) if li < len(ws) - 1 else (torch.sigmoid(h) if out_act else h)
    return h


# The f32 kernels' functions in each library that holds them (mangled-name
# parts): the forward over each fill, the walk and the dW stage. None of them
# may hold a tensor-core instruction: f32 compute is exact f32 FMA on the
# CUDA cores (the TPU's Precision.HIGHEST), never TF32 or bf16 products.
F32_FUNCTIONS = {
    "fused_mlp_fwd": ("fused_mlp_fwd_f32INS_5XFill",),
    "fused_mlp_bwd": ("fused_mlp_bwd_walk_f32", "fused_mlp_bwd_dw_f32"),
    "fused_ray_fwd": ("fused_mlp_fwd_f32INS_7RayFill", "fused_mlp_fwd_f32INS_8HeadFill"),
    "fused_ray_bwd": ("fused_mlp_bwd_walk_f32", "fused_mlp_bwd_dw_f32"),
}
TENSOR_CORE_OPS = {"HMMA", "HGMMA", "IMMA", "IGMMA", "BMMA", "BGMMA", "DMMA", "QGMMA", "OMMA"}


def sass_check() -> dict:
    """cuobjdump -sass of each built library that holds an f32 kernel: every
    function of F32_FUNCTIONS is there, runs FFMA, and holds no tensor-core
    instruction. Returns {function: FFMA count}."""
    from nerfstudio_thermal_torch.ops.cuda import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    found = {}
    for lib, wanted in F32_FUNCTIONS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(lib))], capture_output=True, text=True,
                              check=True).stdout
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            fname = body.split("\n", 1)[0].strip()
            key = next((w for w in wanted if w in fname), None)
            if key is None:
                continue
            ops = {op.split(".")[0] for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)}
            bad = sorted(ops & TENSOR_CORE_OPS)
            ffma = len(re.findall(r"\bFFMA\b", body))
            if bad or not ffma:
                raise AssertionError(f"sass_check: {lib} {fname}: tensor-core instructions {bad}, {ffma} FFMA")
            found[f"{lib}:{key}"] = ffma
        missing = [w for w in wanted if f"{lib}:{w}" not in found]
        if missing:
            raise AssertionError(f"sass_check: {lib} holds no function named like {missing}")
    log("sass_check: f32 kernels without a tensor-core instruction: "
        + ", ".join(f"{k} ({v} FFMA)" for k, v in found.items()))
    return found


def kernel_phase():
    """Kernel vs plain on the card. Returns the timed cases' records by
    name (base_8x256_skip4_bf16 is row 1's main shape)."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    cases = [
        # name, in_dim, dims, skips, freq, out_act, dtype, n, timed
        ("base_8x256_skip4_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 1 << 20, True),
        # the f32 kernel (exact f32 on the CUDA cores): the base stack, a
        # proposal stack and the colour head at phase 6's points, and ragged N
        ("base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 1 << 20, True),
        ("proposal_f5_3x64_f32", 3, (64, 64, 1), (), (5, 0.0, 4.0, True), None, torch.float32, 4_194_304, True),
        ("colour_head_3x64_f32", 63, (64, 64, 3), (), None, "sigmoid", torch.float32, 1 << 20, True),
        ("ragged_n_base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 100_003, False),
        ("ragged_n_rgbt_head_f32", 63, (64, 64, 4), (), None, "sigmoid", torch.float32, 100_003, False),
        # products wider than 256 in column passes (288-wide hidden layers
        # that overwrite what they read: the spill rows)
        ("column_passes_f32", 12, (288, 288, 20), (1,), None, "sigmoid", torch.float32, 100_003, False),
        ("sigmoid_4x128_bf16", 3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 1 << 18, False),
        ("no_encoding_bf16", 32, (128,) * 4 + (16,), (2,), None, None, torch.bfloat16, 1 << 18, False),
        ("no_skip_8x256_bf16", 3, BASE_DIMS, (), BASE_FREQ, None, torch.bfloat16, 1 << 18, False),
        ("ragged_n_base_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 777_777, False),
        ("colour_head_3x64_bf16", 63, (64, 64, 3), (), None, "sigmoid", torch.bfloat16, 1 << 20, False),
        ("ragged_n_head_bf16", 63, (64, 64, 3), (), None, "sigmoid", torch.bfloat16, 100_003, False),
    ]
    gen = torch.Generator().manual_seed(0)
    recs = {}
    for name, in_dim, dims, skips, freq, out_act, dtype, n, timed in cases:
        ws, bs = mlp_params(gen, in_dim, dims, skips, freq)
        x = torch.rand(n, in_dim, generator=gen).cuda()
        packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, dtype)
        got = fm.fused_mlp(x, ws, bs, "relu", out_act, skips, freq, dtype)
        torch.cuda.synchronize()
        want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, freq, dtype)
        max_err = check_fwd(f"fused_mlp_fwd {name} ({packed.fwd_path} path)", got, want, dtype)
        line = (f"kernel_vs_plain {name} [{packed.fwd_path} path]: n={n} max_abs_err={max_err:.3e} "
                f"(tol {TOL[dtype]:g} abs+rel) ok")
        if timed:
            ms = cuda_ms(lambda: fm.launch(x, packed), iters=20)
            plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, freq, dtype), iters=5)
            wb = [w.to(dtype) for w in ws]
            bb = [b.to(dtype) for b in bs]
            library_ms = cuda_ms(lambda: library_mlp(x, wb, bb, skips, freq, out_act, dtype), iters=10)
            flops = 2.0 * n * mlp_macs(ws)
            if dtype == torch.bfloat16:
                nbytes = n * (in_dim * 4 + dims[-1] * 2) + param_bytes(ws, bs, False)
                bound_ms, bound_by, _ = bound3(nbytes, flops, 0.0)
            else:
                nbytes = n * (in_dim + dims[-1]) * 4 + 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
                bound_ms, bound_by, _ = bound3(nbytes, 0.0, flops)  # f32 products at the FMA peak
            recs[name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": max_err, "flops": flops, "n": n,
            }
            line += (
                f" | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms,"
                f" torch.matmul chain {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})"
            )
        log(line)
        del ws, bs, x, got, want
    torch.cuda.empty_cache()
    return recs


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def backward_phase():
    """Backward kernel vs plain on the card. Returns the timed cases'
    records by name (base_8x256_skip4_bf16 is row 2's main shape)."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    cases = [
        # name, in_dim, dims, skips, freq, out_act, dtype, n, timed
        ("base_8x256_skip4_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 1 << 18, True),
        # the f32 walk and dW stage (exact f32 on the CUDA cores): the base
        # stack, a proposal stack and the colour head at the forward's
        # points, ragged N, and column passes
        ("base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 1 << 18, True),
        ("proposal_f5_3x64_f32", 3, (64, 64, 1), (), (5, 0.0, 4.0, True), None, torch.float32, 4_194_304, True),
        ("colour_head_3x64_f32", 63, (64, 64, 3), (), None, "sigmoid", torch.float32, 1 << 20, True),
        ("ragged_n_base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 100_003, False),
        ("ragged_n_rgbt_head_f32", 63, (64, 64, 4), (), None, "sigmoid", torch.float32, 100_003, False),
        ("column_passes_f32", 12, (288, 288, 20), (1,), None, "sigmoid", torch.float32, 100_003, False),
        ("sigmoid_4x128_bf16", 3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 1 << 18, False),
        ("no_encoding_bf16", 32, (128,) * 4 + (16,), (2,), None, None, torch.bfloat16, 1 << 18, False),
        ("no_skip_8x256_bf16", 3, BASE_DIMS, (), BASE_FREQ, None, torch.bfloat16, 1 << 17, False),
        ("ragged_n_base_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 100_003, False),
    ]
    gen = torch.Generator().manual_seed(1)
    recs = {}
    for name, in_dim, dims, skips, freq, out_act, dtype, n, timed in cases:
        ws, bs = mlp_params(gen, in_dim, dims, skips, freq)
        x = torch.rand(n, in_dim, generator=gen).cuda()
        g = torch.randn(n, dims[-1], generator=gen).cuda().to(dtype)
        dx, dws, dbs = fm.fused_mlp_bwd(x, g, ws, bs, "relu", out_act, skips, freq, dtype)
        torch.cuda.synchronize()
        want = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, freq, dtype)
        named = [("dx", dx, want[0])]
        named += [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want[1]))]
        named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want[2]))]
        worst, key, max_err = check_bwd(f"fused_mlp_bwd {name}", named, dtype)
        line = (
            f"bwd_kernel_vs_plain {name}: n={n} worst rel L2 {worst:.3e} ({key}),"
            f" max |err| {max_err:.3e} (tol {BWD_TOL[dtype]:g} rel L2) ok"
        )
        if timed:
            packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, dtype, transposed=True)
            ms = cuda_ms(lambda: fm.launch_bwd(x, g, packed), iters=10)
            plain_ms = cuda_ms(lambda: fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, freq, dtype), iters=3)
            pair_ms = cuda_ms(lambda: (fm.launch(x, packed), fm.launch_bwd(x, g, packed)), iters=10)
            wb = [w.to(dtype).requires_grad_(True) for w in ws]
            bb = [b.to(dtype).requires_grad_(True) for b in bs]
            xr = x.clone().requires_grad_(True)

            def library():
                out = library_mlp(xr, wb, bb, skips, freq, out_act, dtype)
                return torch.autograd.grad(out, [xr, *wb, *bb], g)

            library_ms = cuda_ms(library, iters=10)
            park_stage_call(f"fused_mlp_bwd {name} n={n}", fm.launch_bwd, x, g, packed)
            flops = 6.0 * n * mlp_macs(ws)  # recompute + dX + dW
            es = 2 if dtype == torch.bfloat16 else 4
            nbytes = n * (in_dim * 4 + dims[-1] * es + in_dim * 4) + sum(
                w.numel() * (es + 4) + b.numel() * (4 + 4) for w, b in zip(ws, bs)
            )
            bound_ms, bound_by, _ = bound3(nbytes, flops, 0.0) if es == 2 else bound3(nbytes, 0.0, flops)
            sizes = fm.bwd_sizes(fm.load_library("bwd"), packed, n, x)
            recs[name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "pair_ms": pair_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err, "n": n,
                "workspace_bytes": sizes.ws_elems * es, "scratch_bytes": sizes.scratch_floats * 4,
            }
            line += (
                f" | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms,"
                f" fwd+bwd kernels {pair_ms:.3f} ms, torch.matmul chain fwd+grad {library_ms:.3f} ms,"
                f" bound {bound_ms:.3f} ms ({bound_by})"
            )
        log(line)
        del ws, bs, x, g, dx, dws, dbs, want, named
    torch.cuda.empty_cache()
    return recs


def counters():
    """Every kernel wrapper's launch counter, by kernel name: (wrapper,
    attribute). fused_ray_mlp_bwd_input_grads counts the ray backward's
    launches that computed input gradients, fused_field_mlp_fwd_head_input
    the whole-field forward's launches that wrote the head input (a render
    chunk's write none)."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    return {
        "fused_mlp_fwd": (fm.fused_mlp, "launches"), "fused_mlp_bwd": (fm.fused_mlp_bwd, "launches"),
        "hash_encode_fwd": (th.hash_encode_fwd, "launches"),
        "hash_encode_bwd_table": (th.hash_encode_bwd_table, "launches"),
        "hash_encode_bwd_pos": (th.hash_encode_bwd_pos, "launches"),
        "fused_ray_mlp_fwd": (fr.fused_ray_mlp, "launches"), "fused_ray_mlp_bwd": (fr.fused_ray_mlp_bwd, "launches"),
        "fused_ray_mlp_bwd_input_grads": (fr.fused_ray_mlp_bwd, "input_grad_launches"),
        "fused_field_mlp_fwd": (fr.fused_field_mlp, "launches"),
        "fused_field_mlp_fwd_head_input": (fr.fused_field_mlp, "head_input_launches"),
        "fused_field_mlp_bwd": (fr.fused_field_mlp_bwd, "launches"),
    }


def reset_counts() -> None:
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    fm.fused_mlp.path_launches.clear()
    fr.fused_ray_mlp.stack_launches.clear()
    fr.fused_ray_mlp_bwd.stack_launches.clear()


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def expected_counts(per_unit: dict, units: int = 1) -> dict:
    return {name: per_unit.get(name, 0) * units for name in counters()}


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


HASH_CASES = [
    # name, levels, log2 T, points, min_res, max_res
    ("base_L16_T2^19", 16, 19, 8192 * 48, 16, 2048),
    ("proposal_L5_T2^17", 5, 17, 8192 * 256, 16, 256),
    ("onehot_route_L5_T2^12", 5, 12, 8192 * 96, 16, 128),
]


def hash_inputs(gen, levels, log2_t, n, min_res, max_res, dtype):
    """Table, positions, scalings and cotangent of one hash case: 1/8 of the
    points on level-0 grid coordinates (floor == ceil), 1/8 zeroed as the
    fields' selector zeroes them, the rest uniform in [0, 1). g is zero at
    the zeroed points, as on the main path, except for 64 of them."""
    from nerfstudio_thermal_torch.ops.encodings import hash_grid_scalings

    table = (torch.randn(levels * 2**log2_t, 2, generator=gen) * 1e-2).cuda()
    pos = torch.rand(n, 3, generator=gen)
    k = n // 8
    pos[:k] = torch.floor(pos[:k] * min_res) / min_res
    pos[k : 2 * k] = 0.0
    g = torch.randn(n, 2 * levels, generator=gen)
    g[k + 64 : 2 * k] = 0.0
    scal = torch.from_numpy(hash_grid_scalings(levels, min_res, max_res))
    return table, pos.cuda(), scal.cuda(), g.cuda().to(dtype)


def hash_rows_touched(pos, scal, table_size) -> int:
    """The distinct table rows, over all levels, that the 8 corners of
    these positions fall on."""
    from nerfstudio_thermal_torch.ops import encodings as enc

    levels = scal.shape[0]
    hf, hc, _, _ = enc._hash_factors(pos, scal, table_size)
    offset = enc._level_offset(levels, table_size, pos.device)
    seen = torch.zeros(levels * table_size, dtype=torch.bool, device=pos.device)
    for bits in enc._CORNER_BITS:
        seen[enc._corner_index(hf, hc, bits, offset).reshape(-1)] = True
    return int(seen.sum())


def hash_library_scatter(pos, g, scal, table_size):
    """One Tensor.index_add_ of the precomputed g * w contributions of
    every corner: the table gradient's library yardstick."""
    from nerfstudio_thermal_torch.ops import encodings as enc

    levels = scal.shape[0]
    hf, hc, wf, wc = enc._hash_factors(pos, scal, table_size)
    offset = enc._level_offset(levels, table_size, pos.device)
    gl = g.float().reshape(-1, levels, 2).transpose(0, 1)  # [L, N, 2]
    idx, contrib = [], []
    for bits in enc._CORNER_BITS:
        wx, wy, wz = enc._corner_weights(wf, wc, bits)
        idx.append(enc._corner_index(hf, hc, bits, offset).reshape(-1))
        contrib.append((gl * (wx * wy * wz)[..., None]).reshape(-1, 2))
    idx, contrib = torch.cat(idx), torch.cat(contrib)
    return lambda: torch.zeros(levels * table_size, 2, device=pos.device).index_add_(0, idx, contrib)


def hash_cost(kname: str, n: int, levels: int, t: int, rows: int, dtype):
    """Bytes each hash function must move (inputs once, outputs once) and
    its f32 operations, per (point, level): 15 for the corners and weights,
    then per corner 6 (forward), 6 (scatter: 2 weight products, 2 products,
    2 adds) or 12 (position gradient). The forward and the position gradient
    read only the table rows these positions touch (a coarse level reaches
    far fewer than T); the table gradient writes its dense d_table in full."""
    es, nl = (2 if dtype == torch.bfloat16 else 4), n * levels
    return {
        "hash_encode_fwd": (n * 12 + rows * 8 + nl * 2 * es, nl * (15 + 8 * 6)),
        "hash_encode_bwd_table": (n * 12 + nl * 2 * es + levels * t * 8, nl * (15 + 8 * 6)),
        "hash_encode_bwd_pos": (n * 24 + rows * 8 + nl * 2 * es, nl * (15 + 8 * 12 + 6)),
    }[kname]


def hash_calls(table, pos, scal, t, g, dtype, with_pos: bool = True) -> dict:
    """(kernel, plain version) of each hash function on one case, by kernel
    name: the forward in `dtype`, and with a cotangent g the table and (with
    `with_pos`: the call's positions need a gradient) position gradients."""
    from nerfstudio_thermal_torch.ops import encodings as enc
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    calls = {"hash_encode_fwd": (lambda: th.hash_encode_fwd(table, pos, scal, t, dtype),
                                 lambda: enc.hash_encode_plain(table, pos, scal, t, dtype))}
    if g is not None:
        calls["hash_encode_bwd_table"] = (lambda: th.hash_encode_bwd_table(pos, g, scal, t),
                                          lambda: enc.hash_encode_bwd_table_plain(pos, g, scal, t, 2))
    if g is not None and with_pos:
        calls["hash_encode_bwd_pos"] = (lambda: th.hash_encode_bwd_pos(table, pos, g, scal, t),
                                        lambda: enc.hash_encode_bwd_pos_plain(table, pos, g, scal, t))
    return calls


def check_hash_kernel(kname: str, what: str, kernel, plain, dtype):
    """One hash kernel's result against its plain version's on the same
    inputs, under the hash tolerances. Returns (max |err|, relative L2,
    the tolerance as text); raises where they disagree."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{kname} {what}: shape {tuple(got.shape)} or not finite")
    diff = (got.float() - want.float()).abs()
    max_err, rel = float(diff.max()), rel_l2(got.float(), want.float())
    if kname == "hash_encode_fwd":
        step = 2.0**-8 if dtype == torch.bfloat16 else 0.0
        ok = not bool((diff > HASH_FWD_TOL + step * want.float().abs()).any())
        tol = f"{HASH_FWD_TOL:g} abs" + (" + 2^-8 rel" if step else "")
    else:
        limit = HASH_TABLE_TOL if kname == "hash_encode_bwd_table" else HASH_POS_TOL
        ok, tol = rel <= limit, f"{limit:g} rel L2"
    if not ok:
        raise AssertionError(f"{kname} disagrees with its plain version in {what}: "
                             f"max |err| {max_err:.3e}, rel L2 {rel:.3e} (tol {tol})")
    return max_err, rel, tol


@contextlib.contextmanager
def recording_hash_calls():
    """While open, every call of the port's hash_encode (the hash fields'
    entry to the kernels) appends a record to the yielded list: the table,
    the positions as the kernels take them ([N, 3] f32), the scalings, T,
    the compute dtype and, where the call's backward runs, the cotangent g
    [N, 2L] it receives (taken by a hook on the output). Positions and g
    are copied to the host, so that they hold no card memory through the
    phases that follow (hash_model_phase brings them back). The wrapped
    call computes and counts as before."""
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    calls, inner = [], th.hash_encode

    def recorded(table, positions, scalings, table_size, compute_dtype=torch.float32):
        out = inner(table, positions, scalings, table_size, compute_dtype)
        rec = {"table": table.detach(), "pos": positions.detach().reshape(-1, 3).float().cpu(),
               "scal": scalings.detach(), "t": table_size, "dtype": compute_dtype, "g": None}
        if out.requires_grad:
            out.register_hook(lambda g: rec.update(g=g.detach().reshape(rec["pos"].shape[0], -1).cpu()))
        calls.append(rec)
        return out

    th.hash_encode = recorded
    try:
        yield calls
    finally:
        th.hash_encode = inner


# the hash calls of one thermal-nerfacto render chunk and of one training
# step that updates the proposal nets, recorded by slice_phase and
# train_phase, for hash_model_phase
HASH_MODEL_CALLS = {}
HASH_METHOD = "thermal-nerfacto"
HASH_CAPTURE_STEP = TIMED_FROM - 1  # updates the proposals (every step < 10 does), not timed


def hash_model_phase(scopes=None):
    """The hash kernels on the positions (and cotangents) the model itself
    produced: the 8 calls of one thermal-nerfacto render chunk (forward) and
    the 8 of one training step (forward, table gradient, position
    gradient). Each case is held against the plain versions as in
    hash_kernel_phase (the forward in the call's dtype and in f32) and
    timed with its bound, rows touched and, for the table gradient, the
    index_add_ yardstick; then the sums per chunk and per step. Returns
    {scope: {kernel name: sums}}."""
    scopes = HASH_MODEL_CALLS if scopes is None else scopes
    result = {}
    for scope, calls in scopes.items():
        sums = collections.defaultdict(lambda: {"ms": 0.0, "bound_ms": 0.0, "library_ms": None, "cases": 0,
                                                "rows": 0, "points": 0})
        for i, rec in enumerate(calls):
            table, scal, t = rec["table"], rec["scal"], rec["t"]
            pos = rec["pos"].to(table.device).contiguous()
            g = None if rec["g"] is None else rec["g"].to(table.device).contiguous()
            n, levels = pos.shape[0], scal.shape[0]
            rows = hash_rows_touched(pos, scal, t)
            name = f"{scope}[{i}] L{levels} T2^{t.bit_length() - 1}"
            calls = hash_calls(table, pos, scal, t, g, rec["dtype"], rec.get("with_pos", True))
            for kname, (kernel, plain) in calls.items():
                checks = [(rec["dtype"], kernel, plain)]
                if kname == "hash_encode_fwd" and rec["dtype"] != torch.float32:
                    # f32, where the kernel must equal the plain version
                    checks.append((torch.float32, *hash_calls(table, pos, scal, t, None, torch.float32)[kname]))
                errs = []
                for dt, k, p in checks:
                    max_err, rel, tol = check_hash_kernel(kname, f"{name} {dt}", k, p, dt)
                    errs.append(f"{str(dt)[6:]} max_abs_err={max_err:.3e} rel L2 {rel:.3e} (tol {tol})")
                dtype = rec["dtype"] if kname == "hash_encode_fwd" else g.dtype
                ms = cuda_ms(kernel, iters=20)
                bound_ms, bound_by = bound(*hash_cost(kname, n, levels, t, rows, dtype))
                library_ms = None
                if kname == "hash_encode_bwd_table":
                    library_ms = cuda_ms(hash_library_scatter(pos, g, scal, t), iters=5)
                s = sums[kname]
                s["ms"] += ms
                s["bound_ms"] += bound_ms
                s["cases"] += 1
                s["rows"] += rows
                s["points"] += n
                if library_ms is not None:
                    s["library_ms"] = (s["library_ms"] or 0.0) + library_ms
                library = "none" if library_ms is None else f"{library_ms:.4f} ms"
                log(f"hash_model {kname} {name}: n={n} " + "; ".join(errs) + f" ok; table rows touched {rows} of "
                    f"{levels * t} | kernel {ms:.4f} ms, library {library}, bound {bound_ms:.4f} ms ({bound_by})")
            del pos, g, calls
            torch.cuda.empty_cache()
        for kname, s in sums.items():
            library = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f} ms"
            log(f"hash_model {kname} per {scope.replace('_', ' ')}: {s['cases']} calls, {s['points']} points, "
                f"kernel {s['ms']:.4f} ms, library {library}, bound {s['bound_ms']:.4f} ms, "
                f"rows touched {s['rows']}")
        result[scope] = dict(sums)
    return result


def hash_kernel_phase():
    """The three hash kernels against their plain versions on the card, at
    the main path's shapes, bf16 and f32. Returns the records of the base
    shape in bf16, by kernel name."""
    gen = torch.Generator().manual_seed(2)
    main = None
    for name, levels, log2_t, n, lo, hi in HASH_CASES:
        t = 2**log2_t
        for dtype in (torch.bfloat16, torch.float32):
            table, pos, scal, g = hash_inputs(gen, levels, log2_t, n, lo, hi, dtype)
            calls = hash_calls(table, pos, scal, t, g, dtype)
            rows = hash_rows_touched(pos, scal, t)
            recs = {}
            for kname, (kernel, plain) in calls.items():
                max_err, rel, tol = check_hash_kernel(kname, f"{name} {dtype}", kernel, plain, dtype)
                line = (f"hash_kernel_vs_plain {kname} {name} {str(dtype)[6:]}: n={n} max_abs_err={max_err:.3e} "
                        f"rel L2 {rel:.3e} (tol {tol}) ok; table rows touched {rows} of {levels * t}")
                if dtype == torch.bfloat16:
                    ms = cuda_ms(kernel, iters=20)
                    plain_ms = cuda_ms(plain, iters=3)
                    library_ms = None
                    if kname == "hash_encode_bwd_table":
                        library_ms = cuda_ms(hash_library_scatter(pos, g, scal, t), iters=5)
                    bound_ms, bound_by = bound(*hash_cost(kname, n, levels, t, rows, dtype))
                    recs[kname] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err}
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                             f"library {'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
                             f"bound {bound_ms:.4f} ms ({bound_by})")
                log(line)
            if main is None:
                main = recs
            del table, pos, scal, g, calls
            torch.cuda.empty_cache()
    return main


def bound3(nbytes: float, mma_flops: float, f32_ops: float):
    """The least time (ms) of a ray-march or whole-field function: the
    largest of its bf16 tensor-core FLOP at the bf16 peak, its f32 work
    outside the products (positions, contraction, encoding, SH; a sin or cos
    counts as one operation) at the f32 peak, and its bytes at the memory
    rate. Returns (ms, "operations" or "bytes", the term that wins)."""
    terms = {"bf16 products": mma_flops / PEAK_BF16_FLOPS * 1e3, "f32 work": f32_ops / PEAK_F32_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def ray_inputs(gen, r, s):
    """Rays from inside the scene box with unit directions, sorted midpoints
    from the near plane out to 6 (outside the unit ball); one ray in 64 ends
    at 1e8 (contracted to the box's edge: selector 0); one ray in 16 from
    the origin along (a, +-a, b) (tied inf-norm components)."""
    o = torch.rand(r, 3, generator=gen) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn(r, 3, generator=gen), dim=-1)
    t = torch.sort(torch.rand(r, s, generator=gen) * 6.0 + 0.05, dim=-1).values
    t[::64, -1] = 1e8
    o[1::16] = 0.0
    d[1::16] = torch.tensor([0.6, 0.6, 0.52915025])
    d[2::16] = torch.tensor([0.6, -0.6, 0.52915025])
    o[2::16] = 0.0
    return o.cuda(), d.cuda(), t.reshape(-1, 1).cuda()


def library_ray(o, d, t, s, ws, bs, skips, freq, dtype):
    """The ray-march function as a chain of PyTorch ops (posgen,
    contraction, encoding, torch.matmul layers): a yardstick only."""
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    c = fr.contract(o, d, t, s)
    return torch.cat([library_mlp(c.x, ws, bs, skips, freq, None, dtype), c.sel.to(dtype)], -1)


def library_field(o, d, t, e, s, bw, bb, hw, hb, skips, freq, dtype):
    """The whole-field function as a chain of PyTorch ops (posgen,
    contraction, encoding, torch.matmul layers, SH, colour head)."""
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
    from nerfstudio_thermal_torch.ops.encodings import sh_encoding

    c = fr.contract(o, d, t, s)
    base = library_mlp(c.x, bw, bb, skips, freq, None, dtype)
    head_in = torch.cat([sh_encoding(d, 4).to(dtype).repeat_interleave(s, 0), base[:, 1:],
                         e.to(dtype).repeat_interleave(s, 0)], -1)
    rgb = library_mlp(head_in, hw, hb, (), None, "sigmoid", dtype)
    return torch.cat([rgb, base[:, :1], c.sel.to(dtype)], -1)


def mlp_macs(ws) -> int:
    return sum(w.shape[0] * w.shape[1] for w in ws)


def input_grad_macs(ws, skips) -> int:
    """MACs of the dX products that feed only the input gradient: layer 0's
    and the encoding rows of each skip layer's."""
    enc = ws[0].shape[0]
    return enc * ws[0].shape[1] + sum(enc * ws[li].shape[1] for li in skips if li != 0)


def param_bytes(ws, bs, grads: bool) -> int:
    """Weights and biases read in bf16 (and, for a backward, dW and db
    written in f32)."""
    return sum((w.numel() + b.numel()) * (2 + (4 if grads else 0)) for w, b in zip(ws, bs))


def check_fwd(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()) or bool(
        (err > TOL[dtype] * (1.0 + want.float().abs())).any()
    ):
        raise AssertionError(f"{name}: kernel disagrees with plain version: max |err| {max_err}")
    return max_err


def check_bwd(name, named, dtype):
    """named: (tensor name, kernel's, plain's). Returns the worst relative
    L2 error and the largest absolute one."""
    errs, max_err = {}, 0.0
    for key, a, b in named:
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {key} has shape {tuple(a.shape)} or is not finite")
        errs[key] = rel_l2(a, b)
        max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    worst = max(errs, key=errs.get)
    if errs[worst] > BWD_TOL[dtype]:
        raise AssertionError(f"{name}: backward kernel disagrees with plain version: {worst} rel L2 {errs[worst]:.3e}")
    return errs[worst], worst, max_err


# name, base layer widths (incl. output), skips, frequencies, rays (forward,
# backward), samples, backward with input gradients
RAY_CASES = [
    ("cross_density", BASE_DIMS, (4,), BASE_FREQ, 32768, 2048, 32, True),
    ("proposal_0", (64, 64, 1), (), (5, 0.0, 4.0, True), 32768, 8192, 128, False),
    ("proposal_1", (64, 64, 1), (), (7, 0.0, 6.0, True), 32768, 8192, 48, False),
]


def ray_kernel_phase():
    """The ray-march forward and backward kernels against their plain
    versions at the main path's shapes, bf16 and f32, each timed. Returns
    the records by kernel name (f32: the name with _f32) and case."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    gen = torch.Generator().manual_seed(3)
    recs = {k + sfx: {} for k in ("fused_ray_mlp_fwd", "fused_ray_mlp_bwd") for sfx in ("", "_f32")}
    for name, dims, skips, freq, r_fwd, r_bwd, s, need in RAY_CASES:
        ws, bs = mlp_params(gen, 3, dims, skips, freq)
        nf = freq[0]
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{name} {str(dtype)[6:]}"
            packed = fm.prepare(3, ws, bs, None, skips, freq, dtype, transposed=True)
            # forward
            o, d, t = ray_inputs(gen, r_fwd, s)
            n = r_fwd * s
            got = fr.launch_ray(o, d, t, s, packed)
            torch.cuda.synchronize()
            want = fr.fused_ray_mlp_plain(o, d, t, ws, bs, s, None, skips, freq, dtype)
            max_err = check_fwd(f"fused_ray_mlp_fwd {tag} ({packed.fwd_path} path)", got, want, dtype)
            zeros = int((want[:, -1] == 0).sum())
            line = (f"kernel_vs_plain fused_ray_mlp_fwd {tag} [{packed.fwd_path} path]: n={n} ({r_fwd} x {s}) "
                    f"max_abs_err={max_err:.3e} (tol {TOL[dtype]:g} abs+rel), {zeros} samples with selector 0, ok")
            del got, want
            bf16, sfx = dtype == torch.bfloat16, "" if dtype == torch.bfloat16 else "_f32"
            ms = cuda_ms(lambda: fr.launch_ray(o, d, t, s, packed), iters=10 if bf16 else 3)
            plain_ms = cuda_ms(lambda: fr.fused_ray_mlp_plain(o, d, t, ws, bs, s, None, skips, freq, dtype), iters=3)
            wb, bb = [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]
            library_ms = cuda_ms(lambda: library_ray(o, d, t, s, wb, bb, skips, freq, dtype), iters=5)
            if bf16:
                nbytes = r_fwd * 24 + n * (4 + (dims[-1] + 1) * 2) + param_bytes(ws, bs, False)
                bound_ms, bound_by, term = bound3(nbytes, 2.0 * n * mlp_macs(ws), n * (40 + 9 * nf))
            else:
                nbytes = r_fwd * 24 + n * (4 + (dims[-1] + 1) * 4) + 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
                bound_ms, bound_by, term = bound3(nbytes, 0.0, n * (40 + 9 * nf) + 2.0 * n * mlp_macs(ws))
            recs["fused_ray_mlp_fwd" + sfx][name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": max_err, "n": n, "stack": tuple(packed.desc),
            }
            line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
                     f"bound {bound_ms:.4f} ms ({term})")
            log(line)
            # backward
            o, d, t = ray_inputs(gen, r_bwd, s)
            n = r_bwd * s
            g = torch.randn(n, dims[-1] + 1, generator=gen).cuda().to(dtype)
            gk = g[:, :-1].contiguous()
            (d_o, d_d, d_t), dw, db = fr.fused_ray_mlp_bwd(o, d, t, gk, s, packed, need)
            torch.cuda.synchronize()
            dws, dbs = fm.unpack_grads(dw, db, packed.desc, packed.shapes)
            w_o, w_d, w_t, w_dws, w_dbs = fr.fused_ray_mlp_bwd_plain(o, d, t, g, ws, bs, s, None, skips, freq, dtype, need)
            named = [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, w_dws))]
            named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, w_dbs))]
            if need:
                named += [("d_o", d_o, w_o), ("d_d", d_d, w_d), ("d_t", d_t, w_t)]
            worst, key, max_err = check_bwd(f"fused_ray_mlp_bwd {tag}", named, dtype)
            line = (f"bwd_kernel_vs_plain fused_ray_mlp_bwd {tag}: n={n} ({r_bwd} x {s}) input grads {need}, "
                    f"worst rel L2 {worst:.3e} ({key}), max |err| {max_err:.3e} (tol {BWD_TOL[dtype]:g} rel L2) ok")
            del named, dws, dbs, w_dws, w_dbs, dw, db
            ms = cuda_ms(lambda: fr.fused_ray_mlp_bwd(o, d, t, gk, s, packed, need), iters=5 if bf16 else 3)
            plain_ms = cuda_ms(lambda: fr.fused_ray_mlp_bwd_plain(o, d, t, g, ws, bs, s, None, skips, freq, dtype, need), iters=2)
            wb = [w.to(dtype).requires_grad_(True) for w in ws]
            bb = [b.to(dtype).requires_grad_(True) for b in bs]
            ins = [x.clone().requires_grad_(need) for x in (o, d, t)]

            def library():
                out = library_ray(*ins, s, wb, bb, skips, freq, dtype)
                return torch.autograd.grad(out, (ins if need else []) + wb + bb, g)

            library_ms = cuda_ms(library, iters=3)
            park_stage_call(f"fused_ray_mlp_bwd {tag} n={n}", fr.fused_ray_mlp_bwd, o, d, t, gk, s, packed, need)
            es = 2 if bf16 else 4
            nbytes = (r_bwd * 24 + n * (4 + dims[-1] * es) + (param_bytes(ws, bs, True) if bf16 else 8 * sum(
                      w.numel() + b.numel() for w, b in zip(ws, bs))) + (r_bwd * 24 + n * 4 if need else 0))
            f32_ops = n * (40 + 9 * nf + ((21 * nf + 45) if need else 0))
            macs = 3 * mlp_macs(ws) - (0 if need else input_grad_macs(ws, skips))
            bound_ms, bound_by, term = (bound3(nbytes, 2.0 * n * macs, f32_ops) if bf16
                                        else bound3(nbytes, 0.0, f32_ops + 2.0 * n * macs))
            recs["fused_ray_mlp_bwd" + sfx][name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": max_err, "n": n, "stack": tuple(packed.desc),
            }
            line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library (forward + autograd.grad) "
                     f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({term})")
            log(line)
            del o, d, t, g, gk, packed
            torch.cuda.empty_cache()
    return recs


# channels, rays (forward, backward), samples
FIELD_CASES = [(3, 32768, 8192, 32), (1, 32768, 8192, 32), (4, 32768, 8192, 32)]


def check_head_input(name, out, head_in, d, emb, s, c, dtype):
    """The head input a whole-field forward wrote equals, bitwise, the
    plain version's _head_input of the same base output (its raw density
    column out[:, C], its geo columns as written): SH4 and the embedding
    rounded to the compute dtype, each ray's broadcast to its samples."""
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    geo = head_in.shape[1] - 16 - emb.shape[1]
    base = torch.cat([out[:, c : c + 1], head_in[:, 16 : 16 + geo].to(dtype)], -1)
    if not torch.equal(head_in, fr._head_input(d, emb, base, s, dtype).float()):
        raise AssertionError(f"{name}: the head input differs from the plain _head_input")


def field_split_phase():
    """Row 5 at its main shape, bf16: the whole-field forward (C = 3, E =
    32, 32,768 rays x 32 samples, the rays of ray_inputs) as a training step
    calls it (head input written) and as a render chunk does (no head
    input), each timed with CUDA events and split by kernel (device ms per
    call, torch.profiler), and row 3's cross density (the same base stack
    on the same rays). Prints the field_split line; returns its numbers."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    c, r, _, s = FIELD_CASES[0]
    gen, e, skips, dtype = torch.Generator().manual_seed(5), 32, (4,), torch.bfloat16
    bw, bb = mlp_params(gen, 3, BASE_DIMS, skips, BASE_FREQ)
    hw, hb = mlp_params(gen, 63, (64, 64, c), (), None)
    base = fm.prepare(3, bw, bb, None, skips, BASE_FREQ, dtype)
    head = fm.prepare(63, hw, hb, "sigmoid", (), None, dtype)
    o, d, t = ray_inputs(gen, r, s)
    emb = torch.randn(r, e, generator=gen).cuda()
    forms = {"train": lambda: fr.launch_field(o, d, t, emb, s, base, head),
             "render": lambda: fr.launch_field(o, d, t, emb, s, base, head, head_input=False)}
    result = {form: {"ms": cuda_ms(fn, iters=10)} for form, fn in forms.items()}
    result["row3_cross_density_ms"] = cuda_ms(lambda: fr.launch_ray(o, d, t, s, base), iters=10)
    for form, fn in forms.items():
        result[form]["kernels"] = kernel_split(fn)
    parts = [f"{form}: {rec['ms']:.4f} ms = " + " + ".join(f"{k} {v:.4f}" for k, v in rec["kernels"].items())
             for form, rec in result.items() if form in forms]
    log(f"field_split C={c} bf16 n={r * s} ({r} x {s}): " + "; ".join(parts)
        + f"; row 3 cross density (same base stack, same rays) {result['row3_cross_density_ms']:.4f} ms")
    del o, d, t, emb, base, head
    torch.cuda.empty_cache()
    return result


def field_kernel_phase():
    """The whole-field forward and backward kernels against their plain
    versions at the main path's shapes (base 8 x 256, head 63 -> 64 -> 64
    -> C, E = 32), bf16 and f32, each timed. Returns the records by kernel
    name (f32: the name with _f32) and C."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    gen = torch.Generator().manual_seed(4)
    recs = {k + sfx: {} for k in ("fused_field_mlp_fwd", "fused_field_mlp_bwd") for sfx in ("", "_f32")}
    e, skips = 32, (4,)
    for c, r_fwd, r_bwd, s in FIELD_CASES:
        bw, bb = mlp_params(gen, 3, BASE_DIMS, skips, BASE_FREQ)
        hw, hb = mlp_params(gen, 63, (64, 64, c), (), None)
        macs = mlp_macs(bw) + mlp_macs(hw)
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"C={c} {str(dtype)[6:]}"
            base = fm.prepare(3, bw, bb, None, skips, BASE_FREQ, dtype, transposed=True)
            head = fm.prepare(63, hw, hb, "sigmoid", (), None, dtype, transposed=True)
            o, d, t = ray_inputs(gen, r_fwd, s)
            emb = torch.randn(r_fwd, e, generator=gen).cuda()
            n = r_fwd * s
            got, head_in = fr.launch_field(o, d, t, emb, s, base, head)
            torch.cuda.synchronize()
            want = fr.fused_field_mlp_plain(o, d, t, emb, bw, bb, hw, hb, s, skips, BASE_FREQ, dtype)
            paths = f"{base.fwd_path} base, {head.fwd_path} head"
            max_err = check_fwd(f"fused_field_mlp_fwd {tag} ({paths})", got, want, dtype)
            check_head_input(f"fused_field_mlp_fwd {tag}", got, head_in, d, emb, s, c, dtype)
            bare, none = fr.launch_field(o, d, t, emb, s, base, head, head_input=False)
            if none is not None or not torch.equal(bare, got):
                raise AssertionError(f"fused_field_mlp_fwd {tag}: without the head input the output differs "
                                     "or a head input came back")
            line = (f"kernel_vs_plain fused_field_mlp_fwd {tag} [{paths}]: n={n} ({r_fwd} x {s}) "
                    f"max_abs_err={max_err:.3e} (tol {TOL[dtype]:g} abs+rel), head input equal to the plain "
                    f"_head_input, output without it bitwise equal, ok")
            del got, want, head_in, bare
            bf16, sfx = dtype == torch.bfloat16, "" if dtype == torch.bfloat16 else "_f32"
            # a training step's call (head input written), and a render
            # chunk's (none)
            ms = cuda_ms(lambda: fr.launch_field(o, d, t, emb, s, base, head), iters=10 if bf16 else 3)
            ms_render = cuda_ms(lambda: fr.launch_field(o, d, t, emb, s, base, head, head_input=False),
                                iters=10 if bf16 else 3)
            plain_ms = cuda_ms(lambda: fr.fused_field_mlp_plain(o, d, t, emb, bw, bb, hw, hb, s, skips, BASE_FREQ, dtype), iters=3)
            wbs = [[x.to(dtype) for x in z] for z in (bw, bb, hw, hb)]
            library_ms = cuda_ms(lambda: library_field(o, d, t, emb, s, *wbs, skips, BASE_FREQ, dtype), iters=5)
            f32_ops = n * (40 + 9 * BASE_FREQ[0]) + r_fwd * 30
            if bf16:
                nbytes = r_fwd * (24 + 4 * e) + n * (4 + (c + 2) * 2) + param_bytes(bw + hw, bb + hb, False)
                bound_ms, bound_by, term = bound3(nbytes, 2.0 * n * macs, f32_ops)
            else:
                nbytes = r_fwd * (24 + 4 * e) + n * (4 + (c + 2) * 4) + 4 * sum(
                    w.numel() + b.numel() for w, b in zip(bw + hw, bb + hb))
                bound_ms, bound_by, term = bound3(nbytes, 0.0, f32_ops + 2.0 * n * macs)
            recs["fused_field_mlp_fwd" + sfx][c] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": max_err, "n": n, "ms_render": ms_render,
            }
            line += (f" | kernel {ms:.3f} ms ({ms_render:.3f} ms without the head input), plain {plain_ms:.3f} "
                     f"ms, library {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({term})")
            log(line)
            o, d, t = ray_inputs(gen, r_bwd, s)
            emb = torch.randn(r_bwd, e, generator=gen).cuda()
            n = r_bwd * s
            g = torch.randn(n, c + 2, generator=gen).cuda().to(dtype)
            _, head_in = fr.launch_field(o, d, t, emb, s, base, head)
            d_o, d_d, d_t, d_e, (gbw, gbb, ghw, ghb) = fr.fused_field_mlp_bwd(o, d, t, emb, g, head_in, s, base, head)
            torch.cuda.synchronize()
            dbw, dbb = fm.unpack_grads(gbw, gbb, base.desc, base.shapes)
            dhw, dhb = fm.unpack_grads(ghw, ghb, head.desc, head.shapes)
            want = fr.fused_field_mlp_bwd_plain(o, d, t, emb, g, bw, bb, hw, hb, s, skips, BASE_FREQ, dtype)
            named = list(zip(("d_o", "d_d", "d_t", "d_emb"), (d_o, d_d, d_t, d_e), want[:4]))
            for key, got_l, want_l in zip(("dWb", "dbb", "dWh", "dbh"), (dbw, dbb, dhw, dhb), want[4:]):
                named += [(f"{key}{i}", a, b) for i, (a, b) in enumerate(zip(got_l, want_l))]
            worst, key, max_err = check_bwd(f"fused_field_mlp_bwd {tag}", named, dtype)
            line = (f"bwd_kernel_vs_plain fused_field_mlp_bwd {tag}: n={n} ({r_bwd} x {s}) worst rel L2 {worst:.3e} "
                    f"({key}), max |err| {max_err:.3e} (tol {BWD_TOL[dtype]:g} rel L2) ok")
            del named, want
            ms = cuda_ms(lambda: fr.fused_field_mlp_bwd(o, d, t, emb, g, head_in, s, base, head),
                         iters=5 if bf16 else 3)
            plain_ms = cuda_ms(lambda: fr.fused_field_mlp_bwd_plain(o, d, t, emb, g, bw, bb, hw, hb, s, skips, BASE_FREQ, dtype), iters=2)
            wbs = [[x.to(dtype).requires_grad_(True) for x in z] for z in (bw, bb, hw, hb)]
            ins = [x.clone().requires_grad_(True) for x in (o, d, t, emb)]

            def library():
                out = library_field(*ins, s, *wbs, skips, BASE_FREQ, dtype)
                return torch.autograd.grad(out, ins + [x for z in wbs for x in z], g)

            library_ms = cuda_ms(library, iters=3)
            park_stage_call(f"fused_field_mlp_bwd {tag} n={n}", fr.fused_field_mlp_bwd, o, d, t, emb, g, head_in,
                            s, base, head)
            es = 2 if bf16 else 4
            nbytes = (r_bwd * (24 + 4 * e) * 2 + n * (4 + (c + 2) * es + 4)
                      + (param_bytes(bw + hw, bb + hb, True) if bf16
                         else 8 * sum(w.numel() + b.numel() for w, b in zip(bw + hw, bb + hb))))
            f32_ops = n * (40 + 30 * BASE_FREQ[0] + 45 + 54) + r_bwd * 100
            bound_ms, bound_by, term = (bound3(nbytes, 6.0 * n * macs, f32_ops) if bf16
                                        else bound3(nbytes, 0.0, f32_ops + 6.0 * n * macs))
            recs["fused_field_mlp_bwd" + sfx][c] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": max_err, "n": n,
            }
            line += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library (forward + autograd.grad) "
                     f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({term})")
            log(line)
            del o, d, t, emb, g, head_in, base, head
            torch.cuda.empty_cache()
    return recs


def make_camera(width, height, focal, c2w):
    from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType

    return Cameras(
        camera_to_worlds=torch.as_tensor(c2w, dtype=torch.float32)[None],
        fx=torch.full((1,), focal), fy=torch.full((1,), focal),
        cx=torch.full((1,), width / 2.0), cy=torch.full((1,), height / 2.0),
        width=torch.full((1,), width, dtype=torch.int32),
        height=torch.full((1,), height, dtype=torch.int32),
        distortion_params=torch.zeros(1, 6),
        camera_type=torch.full((1,), CameraType.PERSPECTIVE.value, dtype=torch.int32),
    )


def check_image_outputs(outputs, h, w, expect):
    for key, channels in expect.items():
        if key not in outputs:
            raise AssertionError(f"render output {key} missing")
        v = outputs[key]
        v = torch.as_tensor(v) if isinstance(v, np.ndarray) else v
        if tuple(v.shape) not in ((h * w, channels), (h, w, channels)):
            raise AssertionError(f"render output {key} has shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"render output {key} is not finite")


def scale_hash_tables(model, factor: float = 300.0) -> None:
    """Scale every hash table up from its +-1e-3 init, so that a render
    check sees the tables (the same on the card and on the CPU)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("hash_table"):
                p.mul_(factor)


def slice_phase(method_name: str):
    """Render requests to one method at full width. Returns (launch counts
    of the render run, seconds of the last 1080p frame, a profiler
    callback)."""
    from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel

    cfg = method_config(method_name).model
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    kwargs = dict(num_train_data=2, metadata={"is_thermal": [0, 1]}, seed=0)
    model = ThermalNerfactoModel(cfg, aabb, device="cuda", **kwargs)
    scale_hash_tables(model)
    chunk = cfg.eval_num_rays_per_chunk

    # the bench.py camera at 1920x1080, and a second, rotated pose
    c2w_a = np.eye(4, dtype=np.float32)[:3]
    c2w_a[0, 3] = 2.0
    ang = 0.6
    rot = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0], [-math.sin(ang), 0, math.cos(ang)]], np.float32)
    c2w_b = np.concatenate([rot, np.array([[0.8], [0.3], [1.5]], np.float32)], 1)
    cam_a = make_camera(1920, 1080, 1400.0, c2w_a)
    cam_b = make_camera(640, 512, 500.0, c2w_b)
    expect = {
        "rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1,
        "prop_depth_0": 1, "prop_depth_1": 1, "removal": 3,
        "rgb_thermal": 1, "accumulation_thermal": 1, "depth_thermal": 1,
        "expected_depth_thermal": 1, "prop_depth_0_thermal": 1,
        "prop_depth_1_thermal": 1, "removal_thermal": 1,
    }

    # reference: a small render of the same seeded model on the CPU (plain
    # versions of every kernel, smaller chunks) against the card
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.eval_num_rays_per_chunk = 400
    cpu_model = ThermalNerfactoModel(ref_cfg, aabb, device="cpu", **kwargs)
    scale_hash_tables(cpu_model)
    small = make_camera(40, 30, 30.0, c2w_b)
    ref = cpu_model.get_outputs_for_camera(small, 0)
    got = model.get_outputs_for_camera(small, 0)
    for key in expect:
        a, b = ref[key], got[key]
        ok = np.abs(a - b) <= 2e-2 * (1.0 + np.abs(a))
        # the median depths are step functions of the cumulative weight, so
        # a one-ulp difference can move a pixel by a whole sample
        if ok.mean() < 0.99 or not np.isfinite(b).all():
            raise AssertionError(f"{method_name} render {key} disagrees with the CPU reference: "
                                 f"{ok.mean():.4f} of pixels agree")
        log(f"{method_name} render_vs_cpu {key}: {ok.mean() * 100:.2f}% of pixels within 2e-2, "
            f"max |diff| {np.abs(a - b).max():.3e}")
    del cpu_model

    if method_name == HASH_METHOD:
        # the hash calls of one 1080p chunk (512 x 64 rays), for hash_model_phase
        with recording_hash_calls() as calls:
            model.render_camera_device(cam_a, 0, width=chunk // 64, height=64)
            torch.cuda.synchronize()
        if len(calls) != METHODS[method_name]["chunk"]["hash_encode_fwd"]:
            raise AssertionError(f"{method_name}: one render chunk made {len(calls)} hash calls")
        HASH_MODEL_CALLS["render_chunk"] = calls

    requests = [("1080p", cam_a, 1920, 1080), ("640x512", cam_b, 640, 512), ("1080p", cam_a, 1920, 1080)]
    per_chunk = METHODS[method_name]["chunk"]
    reset_counts()
    total_chunks = 0
    timings = []
    for name, cam, w, h in requests:
        n_chunks = -(-(w * h) // chunk)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "1080p":
            out = model.render_camera_device(cam, 0)
            torch.cuda.synchronize()
        else:
            out = model.get_outputs_for_camera(cam, 0)
        dt = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in read_counts().items()}
        check_image_outputs(out, h, w, expect)
        if launches != expected_counts(per_chunk, n_chunks):
            raise AssertionError(f"{method_name} {name}: launches {launches}, expected {per_chunk} x {n_chunks} chunks")
        total_chunks += n_chunks
        timings.append((name, dt))
        log(
            f"{method_name} render {name}: {n_chunks} chunks, launches {per_chunk} per chunk, "
            f"{dt:.3f} s/frame, {w * h / dt:,.0f} rays/s"
        )
    counts = read_counts()
    if counts != expected_counts(per_chunk, total_chunks):
        raise AssertionError(f"{method_name} render: launches {counts}, expected {per_chunk} x {total_chunks}")
    return counts, timings[-1][1], lambda out_dir: profile_chunk(model, cam_a, out_dir, method_name)


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world looking at the origin, z up."""
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, eye
    return c2w


def render_sphere(c2w: np.ndarray, w: int, h: int, focal: float, thermal: bool) -> np.ndarray:
    """Ray-trace a unit sphere with a latitude/longitude checker texture
    (RGB) or a smooth temperature field (thermal) over a gradient sky."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -np.ones_like(xs)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - (o @ o - 1.0)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    n = o + t[..., None] * d
    shade = 0.35 + 0.65 * np.clip(n @ np.array([0.5, 0.3, 0.8]) / np.linalg.norm([0.5, 0.3, 0.8]), 0, 1)
    if thermal:
        value = np.where(hit, 0.35 + 0.45 * (0.5 + 0.5 * n[..., 2]) * shade, 0.08 + 0.04 * d[..., 2])
        return (np.clip(value, 0, 1)[..., None] * 255).astype(np.uint8)
    lon = np.arctan2(n[..., 1], n[..., 0])
    lat = np.arccos(np.clip(n[..., 2], -1, 1))
    checker = (np.floor(lon / (np.pi / 6)) + np.floor(lat / (np.pi / 6))) % 2
    colour = np.where(checker[..., None] > 0, [0.9, 0.45, 0.15], [0.15, 0.55, 0.85]) * shade[..., None]
    sky = np.stack([0.55 + 0.2 * d[..., 2], 0.65 + 0.2 * d[..., 2], 0.8 + 0.1 * d[..., 2]], -1)
    return (np.clip(np.where(hit[..., None], colour, sky), 0, 1) * 255).astype(np.uint8)


def write_scene(root: Path, num_pairs: int = 8, thermal: bool = True) -> Path:
    """transforms.json + images/ (RGB 640x480) + images_thermal/ (grey
    640x512): the ThermalNerf layout, RGB frames first; without `thermal`
    the RGB frames alone, the Nerfstudio layout (no is_thermal)."""
    from nerfstudio_thermal_torch.utils.writer import write_png

    frames = []
    modalities = (("rgb", (640, 480), "images"), ("thermal", (640, 512), "images_thermal"))
    for modality, (w, h), sub in modalities[: 1 + thermal]:
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(num_pairs):
            ang = 2 * np.pi * i / num_pairs
            c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
            focal = 0.8 * w
            name = f"frame_{i:04d}.png"
            write_png(root / sub / name, render_sphere(c2w, w, h, focal, modality == "thermal"))
            frames.append({
                "file_path": f"{sub}/{name}", "transform_matrix": c2w.tolist(),
                "fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
                **({"is_thermal": int(modality == "thermal")} if thermal else {}),
            })
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return root


def train_method(method_name: str, scene_dir: Path, rays: int = None):
    """The configuration on a scene; rays per batch, or the method's own."""
    method = method_config(method_name)
    method.data = scene_dir
    if rays is not None:
        method.datamanager.train_num_rays_per_batch = rays
    return method


def train_phase(method_name: str, scene_dir: Path, run_dir: Path, steps: int = TRAIN_STEPS,
                timed_from: int = TIMED_FROM, capture=None):
    """`steps` full-width steps (the method's own rays per batch) through
    setup_trainer -> Trainer.setup -> Trainer.train, with the launch counts
    read around Trainer.train; timed from step `timed_from`. capture
    (step, scope): the hash calls of that step go to HASH_MODEL_CALLS[scope].
    Returns (counts, s/step, rays, profiler callback, ray launches by stack,
    the trainer)."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.models.nerfacto import proposal_updated
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    method = train_method(method_name, scene_dir)
    method.trainer.max_num_iterations = steps
    if capture is None and method_name == HASH_METHOD:
        capture = (HASH_CAPTURE_STEP, "train_step")
    step_counts = spec(method_name)["step"]
    t0 = time.perf_counter()
    trainer = setup_trainer(method, base_dir=run_dir, device="cuda")
    trainer.setup()
    if not trainer.datamanager.uses_native_sampler:
        raise AssertionError(f"{method_name}: the native batch sampler did not build or the scene did not qualify")
    log(f"{method_name} train setup (parse, model, optimizers; native batch sampler): "
        f"{time.perf_counter() - t0:.2f} s")
    groups = trainer.model.param_groups()
    before = {name: [p.detach().clone() for p in params] for name, params in groups.items()}
    tables = {name: p for name, p in trainer.model.named_parameters() if name.endswith("hash_table")}
    tables_before = {name: p.detach().clone() for name, p in tables.items()}
    records, step_times, starts = [], [], {}
    iteration = trainer.train_iteration

    def counted_iteration(step):
        """One Trainer iteration (host sampling included), synchronized and
        timed, with its kernel launches and proposal counter; the state it
        started from is kept when a loss came out non-finite."""
        c0 = read_counts()
        ssu = trainer.state.steps_since_update
        start = step_start(trainer)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        if capture is not None and step == capture[0]:
            # the hash calls of this step and their cotangents, for
            # hash_model_phase (the step is not timed; it updates the
            # proposals, so every call has a backward)
            with recording_hash_calls() as calls:
                out = iteration(step)
            want = step_counts(True)["hash_encode_fwd"]
            if len(calls) != want or any(rec["g"] is None for rec in calls):
                raise AssertionError(f"{method_name} step {step}: {len(calls)} hash calls, "
                                     f"{sum(rec['g'] is not None for rec in calls)} with a cotangent; expected {want}")
            HASH_MODEL_CALLS[capture[1]] = calls
        else:
            out = iteration(step)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t_start)
        launches = {k: v - c0[k] for k, v in read_counts().items()}
        records.append((step, ssu, trainer.state.steps_since_update, launches, out))
        if not all(bool(torch.isfinite(v).all()) for k, v in out.items() if "loss" in k):
            starts[step] = start
        return out

    trainer.train_iteration = counted_iteration
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # this trainer's state and what earlier phases keep
    reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    stacks = {"fwd": dict(fr.fused_ray_mlp.stack_launches), "bwd": dict(fr.fused_ray_mlp_bwd.stack_launches)}
    for way, key in (("fwd", "fused_ray_mlp_fwd"), ("bwd", "fused_ray_mlp_bwd")):
        if sum(stacks[way].values()) != counts[key]:
            raise AssertionError(f"{method_name}: ray {way} launches by stack {stacks[way]} do not add up to "
                                 f"{counts[key]}")

    if len(records) != steps:
        raise AssertionError(f"{method_name}: {len(records)} train steps ran, expected {steps}")
    losses = {k: torch.stack([r[4][k].float() for r in records]) for k in records[0][4] if "loss" in k}
    # Every loss must be finite on every step. The trunc_exp forward is a
    # bare exp, as in the JAX package (ops/activations.py:12-15, kept by the
    # port), so a density can overflow to inf, and with it the density
    # loss, while its gradient (the exp of the input clamped to 15) stays
    # finite. A step with a non-finite loss therefore passes only where the
    # plain path agrees (overflow_witness): run again from the state it
    # started from on the card and on the CPU, it must give non-finite
    # values in exactly the same losses, and the finite ones must agree.
    # Every parameter must be finite after the run.
    witnessed = []
    for step in sorted({s for v in losses.values() for s in (~torch.isfinite(v)).nonzero().flatten().tolist()}):
        bad = sorted(k for k, v in losses.items() if not bool(torch.isfinite(v[step])))
        overflow_witness(method, method_name, step, starts[step], bad, run_dir / f"witness_{step}")
        witnessed.append(f"{step} ({', '.join(bad)})")
    nonfinite = [name for name, p in trainer.model.named_parameters() if not bool(torch.isfinite(p).all())]
    if nonfinite:
        raise AssertionError(f"{method_name} train: parameters {nonfinite} are not finite")
    skipped = 0
    for step, ssu, new_ssu, launches, _ in records:
        updated, want = proposal_updated(step, ssu, method.model.proposal_warmup, method.model.proposal_update_every)
        if new_ssu != want:
            raise AssertionError(f"{method_name} train step {step}: steps_since_update {new_ssu}, "
                                 f"proposal_updated says {want}")
        expected = expected_counts(step_counts(updated))
        if launches != expected:
            raise AssertionError(f"{method_name} train step {step} (proposal update {updated}): "
                                 f"launches {launches}, expected {expected}")
        skipped += step >= timed_from and not updated
    if skipped == 0:
        raise AssertionError(f"no step from {timed_from} on skipped the proposal update")
    unchanged = [
        name for name, params in groups.items()
        if all(torch.equal(a, p.detach()) for a, p in zip(before[name], params))
    ] + [name for name, p in tables.items() if torch.equal(tables_before[name], p.detach())]
    if unchanged:
        raise AssertionError(f"{method_name}: {unchanged} did not change in training")
    if not (run_dir / "nerfstudio_models" / f"step-{steps:09d}.ckpt").exists():
        raise AssertionError("Trainer.train saved no final checkpoint")
    step_s = float(np.mean(step_times[timed_from:]))
    rays = method.datamanager.train_num_rays_per_batch
    trends = ", ".join(f"{float(losses[k][0]):.4f} -> {float(losses[k][-1]):.4f} ({k.split('_')[0]})"
                       for k in ("rgb_loss", "thermal_loss") if k in losses)
    log(
        f"{method_name} train: {steps} steps of {rays} rays, param groups {sorted(groups)} "
        f"and {len(tables)} hash tables all changed, launches {counts}, "
        f"{skipped} of steps {timed_from}-{steps - 1} without proposal update; "
        f"non-finite losses on steps {', '.join(witnessed) or 'none'} (each witnessed by the CPU's plain path; "
        f"parameters finite); loss {trends}"
    )
    log(f"{method_name} train steps {timed_from}-{steps - 1}: {step_s * 1e3:.2f} ms/step, "
        f"{rays / step_s:,.0f} rays/s (peak memory {peak / 2**30:.2f} GiB, {resident / 2**30:.2f} GiB of it "
        f"allocated when training started)")
    trainer.train_iteration = iteration
    return counts, step_s, rays, lambda out_dir: profile_step(trainer, out_dir, method_name), stacks, trainer


def entry_points_phase(name: str, scene_dir: Path, out_dir: Path) -> dict:
    """ns-train with its eval cadences, then ns-eval, for one configuration
    at full width, through the scripts' main() as a user runs them. Fails on
    any eval record, image or metric that is missing or wrong: the trainer
    prints a failed eval and trains on, so a quiet log is no success."""
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.scripts import train as ns_train
    from nerfstudio_thermal_torch.utils.colormaps import apply_depth_colormap
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
    from nerfstudio_thermal_torch.utils.lpips import lpips, lpips_metric_name
    from nerfstudio_thermal_torch.utils.math import psnr, ssim

    method, _, variant = name.partition("+")
    argv = [method, "--data", str(scene_dir), "--max-num-iterations", str(ENTRY_STEPS), "--output-dir", str(out_dir),
            "--trainer.steps-per-eval-batch", str(ENTRY_EVERY), "--trainer.steps-per-eval-image", str(ENTRY_EVERY),
            "--trainer.steps-per-eval-all-images", str(ENTRY_EVAL_ALL)]
    if variant:
        argv += [a for knob in FUSED_KNOBS for a in (f"--model.{knob.replace('_', '-')}", "True")]
    path_kernels = sorted(set(METHODS[name]["chunk"]) | set(METHODS[name]["step"](True)))

    reset_counts()
    t0 = time.perf_counter()
    rc = ns_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0:
        raise AssertionError(f"{name}: ns-train returned {rc}")
    idle = [k for k in path_kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"{name}: ns-train launched no {idle} (launches {counts})")
    runs = list(out_dir.glob(f"*/{method}/*/config.yml"))
    if len(runs) != 1:
        raise AssertionError(f"{name}: ns-train left {len(runs)} runs under {out_dir}")
    run = runs[0].parent

    records = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]

    def group(prefix, step):
        return [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)} for r in records
                if r["step"] == step and any(k.startswith(prefix) for k in r)]

    def finite(values, keys, what):
        bad = [k for k in keys if k not in values or not math.isfinite(values[k])]
        if bad:
            raise AssertionError(f"{name} {what}: {bad} missing or not finite in {sorted(values)}")

    evals = {}
    for step in (ENTRY_EVERY, ENTRY_EVAL_ALL):
        recs = group("eval/", step)
        batch = [r for r in recs if "eval_rgb_loss" in r]
        image = [r for r in recs if "psnr_rgb" in r or "psnr_thermal" in r]
        if len(batch) != 1 or len(image) != 1:
            raise AssertionError(f"{name} step {step}: {len(batch)} eval batch and {len(image)} eval image records")
        finite(batch[0], [k for k in batch[0]] + ["eval_thermal_loss", "eval_psnr_rgb"], f"eval batch {step}")
        modality = "rgb" if "psnr_rgb" in image[0] else "thermal"
        finite(image[0], [f"psnr_{modality}", f"ssim_{modality}", lpips_metric_name(modality)], f"eval image {step}")
        evals[step] = (batch[0], image[0])
        h = ENTRY_EVAL_HEIGHTS[step]
        for img, width in (("img", 3 * 640), ("depth", 2 * 640), ("accumulation", 640), ("prop_depth_0", 640),
                           ("prop_depth_1_thermal", 640)):
            shape = decode_png(run / "images" / f"eval_{img}" / f"step-{step:09d}.png").shape
            if shape != (h, width, 3):
                raise AssertionError(f"{name}: eval image {img} at step {step} has shape {shape}")
    eval_all = group("eval_all/", ENTRY_EVAL_ALL)
    if len(eval_all) != 1 or any(group("eval_all/", s) for s in range(ENTRY_EVAL_ALL)):
        raise AssertionError(f"{name}: eval_all records at steps "
                             f"{sorted({r['step'] for r in records if any(k.startswith('eval_all/') for k in r)})}")
    eval_all = eval_all[0]
    metric_keys = [f"{m}_{mod}" for mod in ("rgb", "thermal") for m in ("psnr", "ssim")]
    metric_keys += [lpips_metric_name(mod) for mod in ("rgb", "thermal")]
    finite(eval_all, metric_keys + ["num_rays_per_sec", "fps"], "eval_all")

    reset_counts()
    t0 = time.perf_counter()
    rc = ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(run / "eval.json")])
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts()
    if rc != 0:
        raise AssertionError(f"{name}: ns-eval returned {rc}")
    idle = [k for k in METHODS[name]["chunk"] if eval_counts[k] == 0]
    if idle:
        raise AssertionError(f"{name}: ns-eval launched no {idle}")
    result = json.loads((run / "eval.json").read_text())
    if set(result) != {"experiment_name", "method_name", "checkpoint", "lpips_provenance", "results"}:
        raise AssertionError(f"{name}: ns-eval wrote {sorted(result)}")
    diffs = {k: abs(result["results"][k] - eval_all[k]) for k in metric_keys + [k + "_std" for k in metric_keys]}
    if max(diffs.values()) > ENTRY_EVAL_TOL:
        raise AssertionError(f"{name}: ns-eval results differ from the step-{ENTRY_EVAL_ALL} eval_all: {diffs}")

    # the card's metrics of each eval image against the CPU's on the same pixels
    _, trainer = eval_setup(run / "config.yml", device="cuda")
    pipeline = trainer.pipeline
    cpu_errs, ms = {}, {}
    for idx in range(len(pipeline.datamanager.eval_dataset)):
        pred = pipeline.render_eval_camera(idx)
        modality = "thermal" if pipeline.datamanager.eval_dataset.get_is_thermal(idx) else "rgb"
        gt = torch.as_tensor(pipeline.datamanager.eval_dataset.get_image(idx)[..., :3], device=pred["rgb"].device)
        pred = pred["rgb"] if modality == "rgb" else pred["rgb_thermal"].repeat(1, 1, 3)
        if modality == "thermal":
            gt = gt[..., :1].repeat(1, 1, 3)
        card = {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt)), "lpips": lpips(pred, gt)}
        cpu = {"psnr": float(psnr(pred.cpu(), gt.cpu())), "ssim": float(ssim(pred.cpu(), gt.cpu())),
               "lpips": lpips(pred.cpu(), gt.cpu())}
        for k in card:
            cpu_errs[f"{k}_{modality}"] = abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
        if modality == "rgb":
            # where an eval image's time goes: the render, then its metrics and
            # images (of which LPIPS and SSIM on the card, the depth colormaps
            # on the host)
            batch = {"image": pipeline.datamanager.eval_dataset.get_image(idx), "is_thermal": 0.0}
            ms["render"] = cuda_ms(lambda: pipeline.render_eval_camera(idx), 3, warmup=1)
            outputs = pipeline.render_eval_camera(idx)
            ms["metrics_and_images"] = cuda_ms(lambda: pipeline.compute_image_metrics(outputs, batch), 3, warmup=1)
            host = {k: v.float().cpu().numpy() for k, v in outputs.items()}
            depths = [k for k in host if k.startswith(("depth", "prop_depth_"))]
            ms["colormaps"] = cuda_ms(lambda: [apply_depth_colormap(host[k], accumulation=host["accumulation"])
                                               for k in depths], 3, warmup=1)
            ms["ssim"] = cuda_ms(lambda: ssim(pred, gt), 10)
            ms["lpips"] = cuda_ms(lambda: lpips(pred, gt), 10)
    if len(cpu_errs) != 6 or max(cpu_errs.values()) > ENTRY_CPU_TOL:
        raise AssertionError(f"{name}: the card's eval metrics differ from the CPU's: {cpu_errs}")
    del trainer, pipeline
    torch.cuda.empty_cache()

    s_per_image = 1.0 / result["results"]["fps"]
    batch_losses = {step: round(b["eval_rgb_loss"], 5) for step, (b, _) in evals.items()}
    path_counts = {k: counts[k] for k in path_kernels}
    log(f"{name} entry points: ns-train {ENTRY_STEPS} steps with evals at {ENTRY_EVERY} and {ENTRY_EVAL_ALL} "
        f"(eval_all at {ENTRY_EVAL_ALL}) in {train_s:.2f} s, {train_s / ENTRY_STEPS * 1e3:.1f} ms/step with evals on "
        f"(setup included); launches {path_counts}; eval batch rgb losses {batch_losses}; "
        f"eval_all psnr rgb {eval_all['psnr_rgb']:.3f} / thermal {eval_all['psnr_thermal']:.3f} dB, "
        f"ssim {eval_all['ssim_rgb']:.4f} / {eval_all['ssim_thermal']:.4f}, "
        f"{lpips_metric_name('rgb')} {eval_all[lpips_metric_name('rgb')]:.4f}")
    log(f"{name} ns-eval: {eval_s:.2f} s (setup included), results equal to the step-{ENTRY_EVAL_ALL} eval_all "
        f"within {max(diffs.values()):.2e} (limit {ENTRY_EVAL_TOL}); {s_per_image:.3f} s per eval image (1 / fps), "
        f"{result['results']['num_rays_per_sec']:,.0f} rays/s, {result['results']['fps']:.2f} fps "
        f"(in training: {1.0 / eval_all['fps']:.3f} s, {eval_all['num_rays_per_sec']:,.0f} rays/s); "
        f"card vs CPU metrics max rel {max(cpu_errs.values()):.2e} (limit {ENTRY_CPU_TOL}); "
        f"on the card per 640x480 image: ssim {ms['ssim']:.3f} ms, lpips {ms['lpips']:.3f} ms")
    log(f"{name} eval image split (640x480, RGB): render {ms['render']:.1f} ms, then metrics and images "
        f"{ms['metrics_and_images']:.1f} ms, of which {len(depths)} depth colormaps on the host "
        f"{ms['colormaps']:.1f}, lpips {ms['lpips']:.1f}, ssim {ms['ssim']:.2f}")
    return {"run": run, "train_s": train_s, "eval_s": eval_s, "s_per_image": s_per_image,
            "rays_per_sec": result["results"]["num_rays_per_sec"], "fps": result["results"]["fps"], **ms}


def step_start(trainer):
    """What a training step starts from: the model's tensors, the jitter
    generator's state and the step counters."""
    st = trainer.state
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return params, st.generator.get_state(), st.step, st.steps_since_update, st.steps_since_update_thermal


def overflow_witness(method, method_name: str, step: int, start, bad, run_dir: Path) -> None:
    """Training step `step` once more from the state it started from, on
    the card and on the CPU (the plain PyTorch versions of every kernel),
    with the same batch and the card's own jitter draws (recorded as the
    card draws them again from the same generator state). Raises unless
    both give non-finite values in exactly the losses `bad`, as the
    training run did, and the finite losses agree within STEP_LOSS_TOL."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.model_components import ray_samplers
    from nerfstudio_thermal_torch.models import thermal_nerfacto

    if method.model.background_color == "random":
        raise AssertionError(f"{method_name}: the witness does not replay a random background's draw")
    params, gen_state, st, ssu, ssu_t = start
    trainers = {}
    for dev in ("cuda", "cpu"):
        tr = setup_trainer(copy.deepcopy(method), base_dir=run_dir / dev, device=dev)
        tr.setup()
        tr.model.load_state_dict(params)
        tr.state.step, tr.state.steps_since_update, tr.state.steps_since_update_thermal = st, ssu, ssu_t
        trainers[dev] = tr
    trainers["cuda"].state.generator.set_state(gen_state)
    batch = trainers["cpu"].datamanager.next_train(step)
    draws, draw = [], ray_samplers._uniforms
    tv_draws, tv_draw = [], thermal_nerfacto.draw_tv_uniforms

    def recorded(*args):
        u = draw(*args)
        if args[2] is None:  # a draw from the generator, not uniforms passed through
            draws.append(u)
        return u

    def recorded_tv(*args):
        u = tv_draw(*args)
        tv_draws.append(u)
        return u

    ray_samplers._uniforms, thermal_nerfacto.draw_tv_uniforms = recorded, recorded_tv
    try:
        card = trainers["cuda"]._train_step(
            trainers["cuda"].state, {k: torch.as_tensor(v).cuda() for k, v in batch.items()})
    finally:
        ray_samplers._uniforms, thermal_nerfacto.draw_tv_uniforms = draw, tv_draw
    levels = len(method.model.num_proposal_samples_per_ray) + 1
    modalities = ("rgb", "thermal")[: len(getattr(trainers["cuda"].model, "output_suffixes", ("",)))]
    if len(draws) != len(modalities) * levels:
        raise AssertionError(f"{method_name} witness: {len(draws)} jitter draws, expected "
                             f"{len(modalities) * levels}")
    uniforms = {m: [u.cpu() for u in draws[i * levels : (i + 1) * levels]] for i, m in enumerate(modalities)}
    tv_names = [k for k, mult in (("rgb", getattr(method.model, "tv_rgb_loss_mult", 0.0)),
                                  ("thermal", getattr(method.model, "tv_thermal_loss_mult", 0.0)))
                if mult > 0 and (k == "rgb" or len(modalities) == 2)]
    tv_uniforms = {k: u.cpu() for k, u in zip(tv_names, tv_draws)}
    t0 = time.perf_counter()
    cpu = trainers["cpu"]._train_step(
        trainers["cpu"].state, {k: torch.as_tensor(v) for k, v in batch.items()}, uniforms=uniforms,
        tv_uniforms=tv_uniforms)
    cpu_s = time.perf_counter() - t0
    card = {k: float(v) for k, v in card.items() if "loss" in k}
    cpu = {k: float(v) for k, v in cpu.items() if "loss" in k}
    card_bad = sorted(k for k, v in card.items() if not math.isfinite(v))
    cpu_bad = sorted(k for k, v in cpu.items() if not math.isfinite(v))
    log(f"{method_name} witness of step {step}: training run non-finite in {bad}; again from its start, card "
        f"{card_bad}, CPU plain path {cpu_bad} ({cpu_s:.1f} s); card / CPU "
        + ", ".join(f"{k} {card[k]:.6g} / {cpu[k]:.6g}" for k in sorted(card)))
    if card_bad != bad:
        raise AssertionError(f"{method_name} step {step}: the card does not repeat its non-finite losses {bad} "
                             f"from the same start ({card_bad})")
    if cpu_bad != bad:
        raise AssertionError(f"{method_name} step {step}: the CPU's plain path gives non-finite losses {cpu_bad} "
                             f"where the kernels gave {bad}")
    for k in card:
        if k not in bad and abs(card[k] - cpu[k]) > STEP_LOSS_TOL * max(abs(cpu[k]), 1e-3):
            raise AssertionError(f"{method_name} step {step} witness: {k} card {card[k]:.6g} CPU {cpu[k]:.6g}")


def step_vs_cpu_phase(method_name: str, scene_dir: Path, run_dir: Path, f32_freqs: int = None):
    """One full-width step of 256 rays on the card and on the CPU from the
    same seeded params, batch and jitter. With f32_freqs the MLPs run in f32
    and the base field's encoding has that many frequencies (the f32
    limits), and the card also runs the step in bf16: a control that must
    exceed every f32 limit in at least one loss or group. Returns, for an
    f32 step, the card step's launch counts (the f32 kernels: every kernel
    of the method's training step must have launched, every fused-MLP
    forward on the f32 path)."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    method = train_method(method_name, scene_dir, 256)
    loss_tol, tag = STEP_LOSS_TOL, method.model.compute_dtype
    grad_tols = collections.defaultdict(lambda: spec(method_name)["step_grad_tol"])
    if f32_freqs is not None:
        method.model.compute_dtype, method.model.freq_num_frequencies = "float32", f32_freqs
        tag, loss_tol = f"float32, {f32_freqs} frequencies", STEP_LOSS_TOL_F32
        camera_tol = STEP_GRAD_TOL_F32 if f32_freqs <= F32_CHECK_FREQS else STEP_CAMERA_GRAD_TOL_F32
        grad_tols = collections.defaultdict(lambda: STEP_GRAD_TOL_F32, camera_opt=camera_tol,
                                            camera_opt_thermal=camera_tol)
    runs = {"cpu": ("cpu", method), "cuda": ("cuda", method)}
    if f32_freqs is not None:
        control = copy.deepcopy(method)
        control.model.compute_dtype = "bfloat16"
        runs["control"] = ("cuda", control)
    trainers = {}
    for label, (dev, m) in runs.items():
        trainers[label] = setup_trainer(copy.deepcopy(m), base_dir=run_dir / label, device=dev)
        trainers[label].setup()
    for label, tr in trainers.items():
        for (k, a), b in zip(trainers["cpu"].model.state_dict().items(), tr.model.state_dict().values()):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"{method_name} step_vs_cpu: the seeded models ({label}) differ at {k}")
    batch = trainers["cpu"].datamanager.next_train(0)
    gen = torch.Generator().manual_seed(7)
    levels = len(method.model.num_proposal_samples_per_ray) + 1
    uniforms = {m: [torch.rand(256, 1, generator=gen) for _ in range(levels)] for m in ("rgb", "thermal")}
    results, f32_counts = {}, None
    for label, tr in trainers.items():
        dev = runs[label][0]
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        u = {m: [t.to(dev) for t in us] for m, us in uniforms.items()}
        if label == "cuda" and f32_freqs is not None:
            torch.cuda.synchronize()
            reset_counts()
            scalars = tr._train_step(tr.state, b, uniforms=u)
            torch.cuda.synchronize()
            f32_counts = {**read_counts(), "fused_mlp_fwd_f32_path": fm.fused_mlp.path_launches["f32"]}
            tables = (METHODS, SURFACE, FUSED_MODALITIES, DATA_SURFACE)  # a tagged name may have no entry
            step = next(t[k] for k in (method_name, method_name.split(":")[0]) for t in tables if k in t)["step"]
            missed = [k for k, v in step(True).items() if v and not f32_counts[k]]
            if missed or f32_counts["fused_mlp_fwd_f32_path"] != f32_counts["fused_mlp_fwd"]:
                raise AssertionError(f"{method_name} f32 step: kernels {missed} never launched, or a fused-MLP "
                                     f"forward left the f32 path ({f32_counts})")
        else:
            scalars = tr._train_step(tr.state, b, uniforms=u)
        grads = {
            name: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten().float().cpu() for p in ps])
            for name, ps in tr.model.param_groups().items()
        }
        results[label] = ({k: float(v) for k, v in scalars.items()}, grads)
    (want_s, want_g), (got_s, got_g) = results["cpu"], results["cuda"]
    loss_err = {k: abs(got_s[k] - w) / max(abs(w), 1e-3) for k, w in want_s.items()}
    worst_loss = max(loss_err, key=loss_err.get)
    worst_grad = {name: rel_l2(got_g[name], w) for name, w in want_g.items()}
    log(
        f"{method_name} step_vs_cpu {tag} (256 rays, full width): {len(want_s)} losses/metrics within "
        f"{loss_err[worst_loss]:.2e} rel ({worst_loss}; tol {loss_tol:g}); gradients rel L2 "
        + ", ".join(f"{k} {v:.2e} (tol {grad_tols[k]:g})" for k, v in worst_grad.items())
    )
    for k, err in loss_err.items():
        if not math.isfinite(got_s[k]) or err > loss_tol:
            raise AssertionError(f"{method_name} step_vs_cpu {tag}: {k} card {got_s[k]:.6g} cpu {want_s[k]:.6g}")
    for name, err in worst_grad.items():
        if not bool(torch.isfinite(got_g[name]).all()) or err > grad_tols[name]:
            raise AssertionError(f"{method_name} step_vs_cpu {tag}: gradient of {name} rel L2 {err:.3e}")
    if "control" not in results:
        return None
    ctl_s, ctl_g = results["control"]
    ctl_loss = {k: abs(ctl_s[k] - w) / max(abs(w), 1e-3) for k, w in want_s.items()}
    ctl_grad = {name: rel_l2(ctl_g[name], w) for name, w in want_g.items()}
    log(
        f"{method_name} step_vs_cpu control, card bfloat16 against CPU {tag}: losses up to "
        f"{max(ctl_loss.values()):.2e} rel ({max(ctl_loss, key=ctl_loss.get)}; f32 tol {loss_tol:g}); gradients rel L2 "
        + ", ".join(f"{k} {v:.2e} (f32 tol {grad_tols[k]:g})" for k, v in ctl_grad.items())
    )
    limits = [("losses", loss_tol, ctl_loss)] + [
        (f"gradients held to {tol:g}", tol, {k: v for k, v in ctl_grad.items() if grad_tols[k] == tol})
        for tol in sorted({grad_tols[k] for k in ctl_grad})
    ]
    for what, tol, reads in limits:
        if max(reads.values()) <= tol:
            raise AssertionError(f"{method_name} step_vs_cpu {tag}: the bf16 control keeps its {what} within the "
                                 f"f32 limit {tol:g} (at most {max(reads.values()):.3e}): the limit cannot tell "
                                 "the f32 path from a bf16 one")
    log(f"{method_name} f32 step launches on the card: " + ", ".join(f"{k} {v}" for k, v in f32_counts.items() if v))
    return f32_counts


TV_POINTS = 7 * 5000  # the density TV loss's points: num_density_tv_samples and 6 neighbours each


def tv_points_phase():
    """Rows 1-2 on the density TV loss's points: thermal-nerfacto-tpu's
    base stack (8 x 256, skip at 4, 10 frequencies) on 7 x 5000 raw points
    of the sphere scene's aabb ([-1, 1]^3; the points outside (0, 1)^3, most
    of them, zeroed), as `density_tv_points` makes them, with the TV loss's
    cotangent (the density column only). Forward and backward against their
    plain versions in bf16 and f32; bf16 timed with bound and library.
    Returns {"fwd": record, "bwd": record}."""
    from nerfstudio_thermal_torch.fields.nerfacto_field import density_tv_points
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    gen = torch.Generator().manual_seed(13)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device="cuda")
    x = density_tv_points(aabb, torch.rand(TV_POINTS // 7, 3, generator=gen).cuda(), 2048.0).contiguous()
    zeroed = int((x == 0).all(-1).sum())
    ws, bs = mlp_params(gen, 3, BASE_DIMS, (4,), BASE_FREQ)
    n, skips, recs = x.shape[0], (4,), {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        g = torch.zeros(n, BASE_DIMS[-1], device="cuda", dtype=dtype)
        g[:, 0] = torch.randn(n, generator=gen).cuda().to(dtype) / n
        packed = fm.prepare(3, ws, bs, None, skips, BASE_FREQ, dtype, transposed=True)
        got = fm.fused_mlp(x, ws, bs, "relu", None, skips, BASE_FREQ, dtype)
        torch.cuda.synchronize()
        max_err = check_fwd(f"fused_mlp_fwd TV points {tag}", got, fm.fused_mlp_plain(x, ws, bs, "relu", None, skips,
                                                                                       BASE_FREQ, dtype), dtype)
        dx, dws, dbs = fm.fused_mlp_bwd(x, g, ws, bs, "relu", None, skips, BASE_FREQ, dtype)
        torch.cuda.synchronize()
        want = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", None, skips, BASE_FREQ, dtype)
        named = [("dx", dx, want[0])] + [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want[1]))]
        named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want[2]))]
        worst, key, bwd_err = check_bwd(f"fused_mlp_bwd TV points {tag}", named, dtype)
        line = (f"tv_points rows 1-2 {tag} [{packed.fwd_path} path]: n={n} ({zeroed} zeroed outside (0, 1)^3); "
                f"forward max_abs_err={max_err:.3e} (tol {TOL[dtype]:g} abs+rel), backward worst rel L2 {worst:.3e} "
                f"({key}; tol {BWD_TOL[dtype]:g}) ok")
        if dtype == torch.bfloat16:
            macs = mlp_macs(ws)
            wb = [w.to(dtype) for w in ws]
            bb = [b.to(dtype) for b in bs]
            fwd = {"ms": cuda_ms(lambda: fm.launch(x, packed), iters=20),
                   "plain_ms": cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, "relu", None, skips, BASE_FREQ, dtype), 5),
                   "library_ms": cuda_ms(lambda: library_mlp(x, wb, bb, skips, BASE_FREQ, None, dtype), iters=10),
                   "max_abs_err": max_err, "n": n}
            fwd["bound_ms"], fwd["bound_by"], _ = bound3(n * (12 + BASE_DIMS[-1] * 2) + param_bytes(ws, bs, False),
                                                         2.0 * n * macs, 0.0)
            wr = [w.requires_grad_(True) for w in (wb + bb)]
            xr = x.clone().requires_grad_(True)

            def library():
                out = library_mlp(xr, wr[: len(ws)], wr[len(ws):], skips, BASE_FREQ, None, dtype)
                return torch.autograd.grad(out, [xr, *wr], g)

            bwd = {"ms": cuda_ms(lambda: fm.launch_bwd(x, g, packed), iters=10),
                   "plain_ms": cuda_ms(lambda: fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", None, skips, BASE_FREQ,
                                                                      dtype), 3),
                   "library_ms": cuda_ms(library, iters=10), "max_abs_err": bwd_err, "n": n}
            bwd["bound_ms"], bwd["bound_by"], _ = bound3(
                n * (12 + BASE_DIMS[-1] * 2 + 12) + sum(w.numel() * 6 + b.numel() * 8 for w, b in zip(ws, bs)),
                6.0 * n * macs, 0.0)
            recs = {"fwd": fwd, "bwd": bwd}
            line += "".join(f" | {way} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, library "
                            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                            for way, r in recs.items())
        log(line)
        del got, dx, dws, dbs, want, named, packed, g
    torch.cuda.empty_cache()
    return recs


SURFACE_RENDERS = {"640x512": (640, 512, 500.0), "1080p": (1920, 1080, 1400.0)}


def surface_expect(cfg) -> dict:
    """The image outputs (name: channels) a configuration renders."""
    base = {"rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1,
            **{f"prop_depth_{i}": 1 for i in range(cfg.num_proposal_iterations)}}
    mode = getattr(cfg, "density_mode", None)
    if mode == "shared":
        return {**base, "rgbt": 4, "rgb_thermal": 1}
    if mode == "separate":
        thermal = {f"{k}_thermal": 1 for k in base}
        return {**base, **thermal, "removal": 3, "removal_thermal": 1}
    return base


def surface_phase(name: str, scene_dir: Path, run_dir: Path) -> dict:
    """One configuration of phase 13: SURFACE_STEPS training steps through
    train_phase (every loss finite or witnessed, every param group and hash
    table changes, each step's launch counts, the native sampler; ms/step
    over steps SURFACE_TIMED_FROM on, rays/s, peak memory), then its renders
    through render_camera_device: finite outputs of the configuration's
    names and shapes, launches per chunk as SURFACE says (with one shared
    proposal net: that net called twice a chunk). The hash calls of step
    SURFACE_CAPTURE_STEP are kept for phase 13b where SURFACE_HASH names
    the configuration."""
    sp = SURFACE[name]
    capture = (SURFACE_CAPTURE_STEP, f"{name} train step") if name in SURFACE_HASH else None
    counts, step_s, rays, _, _, trainer = train_phase(name, scene_dir, run_dir, SURFACE_STEPS, SURFACE_TIMED_FROM,
                                                      capture)
    peak = torch.cuda.max_memory_allocated()
    if capture is not None:
        keep = SURFACE_HASH[name]
        calls = HASH_MODEL_CALLS[capture[1]]
        HASH_MODEL_CALLS[capture[1]] = [c for c in calls if (c["scal"].shape[0], c["t"].bit_length() - 1) in keep]
        if len(HASH_MODEL_CALLS[capture[1]]) != len(keep):
            raise AssertionError(f"{name}: recorded hash calls {[(c['scal'].shape[0], c['t']) for c in calls]}")
    model, cfg = trainer.model, trainer.model.config
    expect = surface_expect(cfg)
    calls = []
    hooks = []
    if cfg.use_same_proposal_network:
        if len(model.proposal_networks) != 1:
            raise AssertionError(f"{name}: {len(model.proposal_networks)} RGB proposal nets, expected one")
        hooks.append(model.proposal_networks[0].register_forward_hook(lambda *a: calls.append(1)))
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[0, 3] = 0.5
    frames = {}
    total = collections.Counter(counts)
    for label in sp["renders"]:
        w, h, focal = SURFACE_RENDERS[label]
        cam = make_camera(w, h, focal, c2w)
        n_chunks = -(-(w * h) // cfg.eval_num_rays_per_chunk)
        calls.clear()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.render_camera_device(cam, 0)
        torch.cuda.synchronize()
        frames[label] = time.perf_counter() - t0
        launches = read_counts()
        total.update(launches)
        check_image_outputs(out, h, w, expect)
        if set(out) != set(expect):
            raise AssertionError(f"{name} render {label}: outputs {sorted(out)}, expected {sorted(expect)}")
        if launches != expected_counts(sp["chunk"], n_chunks):
            raise AssertionError(f"{name} render {label}: launches {launches}, expected {sp['chunk']} x {n_chunks}")
        if hooks and len(calls) != 2 * n_chunks:
            raise AssertionError(f"{name} render {label}: the shared proposal net ran {len(calls)} times in "
                                 f"{n_chunks} chunks, expected two a chunk")
        log(f"{name} render {label}: {n_chunks} chunks, launches {sp['chunk']} per chunk"
            + (", the one proposal net twice a chunk" if hooks else "")
            + f", outputs {sorted(expect)} finite; {frames[label]:.3f} s/frame, {w * h / frames[label]:,.0f} rays/s")
        del out
    for hook in hooks:
        hook.remove()
    del trainer, model
    torch.cuda.empty_cache()
    return {"step_s": step_s, "rays": rays, "peak": peak, "frames": frames,
            "launches": {k: v for k, v in total.items() if v}}


def surface_entry_phase(scene_dir: Path, out_dir: Path, steps: int = 6) -> dict:
    """ns-train of thermal-nerfacto with --pipeline.model.density-mode
    shared, RAdam with clipping on the fields group by flags
    (--optimizers.fields.optimizer.optimizer-type radam, .max-norm 1.0) and
    --trainer.gradient-accumulation-steps 2, and a cosine schedule on the
    fields group (set on the registered config before ns-train reads it: no
    flag of either package swaps a scheduler's class), for `steps` steps.
    The parameters change on the 2nd, 4th, ... step only, every group then;
    the groups count one update per two steps; the run's config.yml holds
    the settings. Then ns-eval on it: finite metrics of both modalities."""
    from nerfstudio_thermal_torch.configs.serialization import load_config
    from nerfstudio_thermal_torch.engine import trainer as trainer_mod
    from nerfstudio_thermal_torch.engine.optimizers import MultiSteps
    from nerfstudio_thermal_torch.engine.schedulers import CosineDecaySchedulerConfig
    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.scripts import train as ns_train

    argv = ["thermal-nerfacto", "--data", str(scene_dir), "--max-num-iterations", str(steps),
            "--output-dir", str(out_dir), "--pipeline.model.density-mode", "shared",
            "--optimizers.fields.optimizer.optimizer-type", "radam", "--optimizers.fields.optimizer.max-norm", "1.0",
            "--trainer.gradient-accumulation-steps", "2"]
    registered = ns_train.get_method_config

    def with_cosine(name):
        config = registered(name)
        # no warm-up: a warm-up starts from a learning rate of 0, which would
        # leave the first update without effect on this group
        config.optimizers["fields"].scheduler = CosineDecaySchedulerConfig(warm_up_end=0, max_steps=steps)
        return config

    inner = trainer_mod.Trainer.train_iteration
    seen = []

    def watched(self, step):
        groups = self.model.param_groups()
        before = {g: [p.detach().clone() for p in ps] for g, ps in groups.items()}
        out = inner(self, step)
        changed = {g: any(not torch.equal(a, p.detach()) for a, p in zip(before[g], ps)) for g, ps in groups.items()}
        seen.append((step, changed, {g: o.count for g, o in self.optimizers.groups.items()},
                     isinstance(self.optimizers, MultiSteps)))
        return out

    ns_train.get_method_config, trainer_mod.Trainer.train_iteration = with_cosine, watched
    reset_counts()
    t0 = time.perf_counter()
    try:
        rc = ns_train.main(argv)
    finally:
        ns_train.get_method_config, trainer_mod.Trainer.train_iteration = registered, inner
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0 or len(seen) != steps:
        raise AssertionError(f"surface ns-train returned {rc} after {len(seen)} steps")
    for step, changed, updates, multi in seen:
        applied = step % 2 == 1
        if not multi or set(changed.values()) != {applied} or set(updates.values()) != {(step + 1) // 2}:
            raise AssertionError(f"surface ns-train step {step}: parameters changed {changed}, updates {updates} "
                                 f"(accumulating: {multi}); expected {'every' if applied else 'no'} group to change")
    idle = [k for k in sorted(SURFACE["thermal-nerfacto:shared"]["step"](True)) if counts[k] == 0]
    if idle:
        raise AssertionError(f"surface ns-train launched no {idle}")
    runs = list(out_dir.glob("*/thermal-nerfacto/*/config.yml"))
    if len(runs) != 1:
        raise AssertionError(f"surface ns-train left {len(runs)} runs")
    saved = load_config(runs[0])
    fields = saved.optimizers["fields"]
    if (saved.model.density_mode, fields.optimizer.optimizer_type, fields.optimizer.max_norm,
            type(fields.scheduler).__name__, saved.trainer.gradient_accumulation_steps) != (
            "shared", "radam", 1.0, "CosineDecaySchedulerConfig", 2):
        raise AssertionError(f"surface ns-train config.yml: {saved.model.density_mode}, {fields}, "
                             f"{saved.trainer.gradient_accumulation_steps}")
    reset_counts()
    rc = ns_eval.main(["--load-config", str(runs[0]), "--output-path", str(runs[0].parent / "eval.json")])
    eval_counts = read_counts()
    if rc != 0:
        raise AssertionError(f"surface ns-eval returned {rc}")
    results = json.loads((runs[0].parent / "eval.json").read_text())["results"]
    keys = [f"{m}_{mod}" for mod in ("rgb", "thermal") for m in ("psnr", "ssim")]
    bad = [k for k in keys if k not in results or not math.isfinite(results[k])]
    if bad or eval_counts["hash_encode_fwd"] == 0:
        raise AssertionError(f"surface ns-eval: {bad} missing or not finite in {sorted(results)}; "
                             f"launches {eval_counts}")
    log(f"surface entry points: ns-train thermal-nerfacto, density mode shared, RAdam + clipping 1.0 and a cosine "
        f"schedule on fields, gradient accumulation 2: {steps} steps in {train_s:.2f} s (setup included), parameters "
        f"changed on steps {[st for st, ch, _, _ in seen if all(ch.values())]} only, every group then, "
        f"{seen[-1][2]['fields']} updates; launches {({k: v for k, v in counts.items() if v})}; config.yml reloads "
        f"these settings; ns-eval psnr rgb {results['psnr_rgb']:.3f} / thermal {results['psnr_thermal']:.3f} dB, "
        f"ssim {results['ssim_rgb']:.4f} / {results['ssim_thermal']:.4f}")
    return {"train_s": train_s}


@contextlib.contextmanager
def timed_render():
    """While ns-render runs: the seconds of its eval_setup and of each
    render_camera_device call (ended by torch.cuda.synchronize), the
    removal threshold each render saw, and of the host work the seconds
    of the depth colormaps and of the PNG encodes (with their bytes)."""
    from nerfstudio_thermal_torch.models import base_model
    from nerfstudio_thermal_torch.scripts import render as render_script
    from nerfstudio_thermal_torch.utils import colormaps, eval_utils

    render_fn, setup_fn = base_model.Model.render_camera_device, eval_utils.eval_setup
    png_fn, depth_fn = render_script.write_png, colormaps.apply_depth_colormap
    times = {"setup": 0.0, "render": [], "removal_min_density_diff": set(), "png": 0.0, "png_bytes": 0,
             "colormap": 0.0}

    def png(path, img):
        t0 = time.perf_counter()
        png_fn(path, img)
        times["png"] += time.perf_counter() - t0
        times["png_bytes"] += Path(path).stat().st_size

    def depth(*args, **kwargs):
        t0 = time.perf_counter()
        out = depth_fn(*args, **kwargs)
        times["colormap"] += time.perf_counter() - t0
        return out

    def render(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_fn(self, *args, **kwargs)
        torch.cuda.synchronize()
        times["render"].append(time.perf_counter() - t0)
        times["removal_min_density_diff"].add(getattr(self.config, "removal_min_density_diff", None))
        return out

    def setup(*args, **kwargs):
        t0 = time.perf_counter()
        out = setup_fn(*args, **kwargs)
        times["setup"] += time.perf_counter() - t0
        return out

    base_model.Model.render_camera_device, eval_utils.eval_setup = render, setup
    render_script.write_png, colormaps.apply_depth_colormap = png, depth
    try:
        yield times
    finally:
        base_model.Model.render_camera_device, eval_utils.eval_setup = render_fn, setup_fn
        render_script.write_png, colormaps.apply_depth_colormap = png_fn, depth_fn


def write_camera_path(path: Path, cameras, frames: int, hw) -> Path:
    """A camera-path JSON of `frames` poses from the first eval camera
    toward the second, at the first one's vertical fov, rendered at hw."""
    from nerfstudio_thermal_torch.cameras import camera_paths

    poses = camera_paths.get_interpolated_camera_path(cameras, steps=frames).camera_to_worlds.numpy()
    fov = math.degrees(2 * math.atan(float(cameras.height[0]) / (2 * float(cameras.fy[0]))))
    bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "render_height": hw[0], "render_width": hw[1],
        "camera_path": [{"camera_to_world": np.concatenate([p, bottom]).ravel().tolist(), "fov": fov}
                        for p in poses[:frames]],
    }))
    return path


def ns_render(name: str, mode: str, run: Path, out: Path, args, names, shapes) -> dict:
    """ns-render through its main() on the card, rendering `names`: `shapes`
    the (h, w) of each camera it renders. Every output's PNG frames must
    decode to their camera's size, and the kernels of the method's render
    path must have launched what its chunks imply (counts zeroed just
    before, read just after)."""
    from nerfstudio_thermal_torch.configs.serialization import load_config
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.scripts import render as ns_render_script

    chunk = load_config(run / "config.yml").model.eval_num_rays_per_chunk
    root = out / f"{name}_{mode}"
    target = root if mode == "dataset" else root / "frames"
    reset_counts()
    t0 = time.perf_counter()
    with timed_render() as times:
        rc = ns_render_script.main([mode, "--load-config", str(run / "config.yml"), "--output-path", str(target),
                                    "--rendered-output-names", *names, *args])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"{name}: ns-render {mode} returned {rc}")
    chunks = sum(-(-(h * w) // chunk) for h, w in shapes)
    want = expected_counts(METHODS[name]["chunk"], chunks)
    if counts != want:
        raise AssertionError(f"{name} ns-render {mode}: launches {counts}, expected {want} ({chunks} chunks)")
    if len(times["render"]) != len(shapes):
        raise AssertionError(f"{name} ns-render {mode}: {len(times['render'])} renders for {len(shapes)} cameras")
    pngs = sorted(root.rglob("*.png"))
    got = collections.Counter(decode_png(p).shape for p in pngs)
    expect = collections.Counter((h, w, 3) for h, w in shapes for _ in names)
    if got != expect:
        raise AssertionError(f"{name} ns-render {mode}: PNG frames {dict(got)}, expected {dict(expect)}")
    render_s = sum(times["render"])
    return {"total": total, "setup": times["setup"], "render": render_s,
            "host": total - times["setup"] - render_s, "frames": len(shapes), "pngs": len(pngs),
            "png": times["png"], "png_bytes": times["png_bytes"], "colormap": times["colormap"],
            "counts": counts, "diffs": times["removal_min_density_diff"]}


def type_camera(kind, c2w: np.ndarray, h: int, w: int):
    """A camera of type `kind` at the pose c2w, its intrinsics sized so the
    frame sees the scene (the spherical types: the full sphere, fx = w / 2,
    fy = h), with twelve distortion parameters (OpenCV coefficients in the
    first six for the types that undistort; fisheye624's twelve for it)."""
    from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType

    focal = {CameraType.FISHEYE: w / 2.0, CameraType.ORTHOPHOTO: 2.0 * w}.get(kind, 0.9 * w)
    fx, fy = (w / 2.0, float(h)) if kind in (
        CameraType.EQUIRECTANGULAR, CameraType.OMNIDIRECTIONALSTEREO_L, CameraType.OMNIDIRECTIONALSTEREO_R,
        CameraType.VR180_L, CameraType.VR180_R) else (focal, focal)
    dist = np.zeros(12, np.float32)
    if kind == CameraType.FISHEYE624:
        dist[:] = [0.02, -0.01, 0.005, 0.0, 0.0, 0.0, 0.001, -0.001, 0.0005, 0.0, 0.0005, 0.0]
    else:
        dist[[0, 4]] = [0.02, 0.001]
    return Cameras(
        camera_to_worlds=torch.as_tensor(c2w[:3, :4], dtype=torch.float32)[None],
        fx=torch.full((1,), fx), fy=torch.full((1,), fy), cx=torch.full((1,), w / 2.0),
        cy=torch.full((1,), h / 2.0), width=torch.full((1,), w, dtype=torch.int32),
        height=torch.full((1,), h, dtype=torch.int32), distortion_params=torch.as_tensor(dist)[None],
        camera_type=torch.full((1,), kind.value, dtype=torch.int32),
    )


def crop_depth_check(name, key, cam, h, w, cpu_depth, card_depth, close, cpu_acc, card_acc):
    """The expected depths of a crop_aabb frame. On a ray with accumulation
    above 1e-3 (CPU) the depth must agree with the CPU's (`close`, returned
    for those rays). A ray that misses the box has near == far, so its
    sample deltas are rounding residues of either sign, and so are its
    weights and their sum; its expected depth, their ratio, is bound only
    by the clip to the chunk's sample range (render_depth_expected). On
    those faint rays the card's and the CPU's depths must each lie in
    [least near, greatest far] of the frame (crop_near_far of its rays),
    and the log line reads their weight sums and how far the two differ."""
    from nerfstudio_thermal_torch.models.base_model import crop_near_far

    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords = torch.stack([ys, xs], dim=-1).reshape(-1, 2).float() + 0.5
    rays = cam.generate_rays(torch.zeros(h * w, dtype=torch.long), coords)
    nears, fars = (t.reshape(-1).numpy() for t in crop_near_far(rays.origins, rays.directions,
                                                                 torch.tensor(CROP_BOX, dtype=torch.float32)))
    a, b, close = cpu_depth.reshape(-1), card_depth.reshape(-1), close.reshape(-1)
    cpu_acc, card_acc = cpu_acc.reshape(-1), card_acc.reshape(-1)
    faint = cpu_acc <= 1e-3
    if not faint.any():
        return close
    lo, hi = float(nears.min()), float(fars.max())
    tol = 1e-4 * (1.0 + hi)
    inside = lambda d: (d >= lo - tol) & (d <= hi + tol)  # noqa: E731
    bad = faint & ~(inside(a) & inside(b))
    if bad.any():
        raise AssertionError(f"{name} crop_aabb {key}: {int(bad.sum())} faint rays outside [{lo}, {hi}], e.g. "
                             f"card {b[bad][:3]}, CPU {a[bad][:3]}")
    diff = np.abs(a - b)[faint]
    log(f"{name} crop_aabb {key}: {int(faint.sum())} of {faint.size} rays with accumulation <= 1e-3 "
        f"({int((faint & (nears == fars)).sum())} miss the box, near == far), each inside [least near {lo:.4f}, "
        f"greatest far {hi:.4f}] on the card and the CPU; their weight sums card [{card_acc[faint].min():.3g}, "
        f"{card_acc[faint].max():.3g}], CPU [{cpu_acc[faint].min():.3g}, {cpu_acc[faint].max():.3g}]; depth card - "
        f"CPU max {diff.max():.4g}, median {np.median(diff):.4g}, {close[faint].mean() * 100:.2f}% within 2e-2")
    return close[~faint]


def camera_types_phase(name: str, run: Path, smi: str) -> dict:
    """Every camera type through render_camera_device on the card and on the
    CPU's plain path (the run's checkpoint on both): each per-ray output
    within 2e-2 x (1 + |CPU|) on 99% of pixels (as phase 7's render check;
    the median depths are step functions of the cumulative weight). One
    perspective frame also with crop_aabb (its expected depths as
    crop_depth_check holds them); then one 1920x1080 frame with
    include_per_sample and one without, with their peak memory."""
    from nerfstudio_thermal_torch.cameras.cameras import CameraType
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    _, card = eval_setup(run / "config.yml", device="cuda")
    _, cpu = eval_setup(run / "config.yml", device="cpu")
    c2w = cpu.datamanager.eval_cameras.camera_to_worlds[0].numpy()
    h, w = TYPE_HW
    cpu.model.config.eval_num_rays_per_chunk = h * w  # one unpadded chunk: the CPU renders no padding rays
    cases = [(kind.name, kind, None) for kind in CameraType] + [("PERSPECTIVE+crop_aabb", CameraType.PERSPECTIVE,
                                                                 CROP_BOX)]
    per_chunk = METHODS[name]["chunk"]
    chunk = card.model.config.eval_num_rays_per_chunk
    agree, plain_acc = {}, None
    for label, kind, crop in cases:
        cam = type_camera(kind, c2w, h, w)
        reset_counts()
        got = card.model.get_outputs_for_camera(cam, 0, crop_aabb=crop)
        torch.cuda.synchronize()
        launches = read_counts()
        if launches != expected_counts(per_chunk, -(-(h * w) // chunk)):
            raise AssertionError(f"{name} camera {label}: launches {launches}")
        ref = cpu.model.get_outputs_for_camera(cam, 0, crop_aabb=crop)
        if set(got) != set(ref):
            raise AssertionError(f"{name} camera {label}: outputs {sorted(got)} on the card, {sorted(ref)} on the CPU")
        worst = 1.0
        for key, a in ref.items():
            b = got[key]
            ok = np.abs(a - b) <= 2e-2 * (1.0 + np.abs(a))
            if crop is not None and key.startswith("expected_depth"):
                ok = crop_depth_check(name, key, cam, h, w, a, b, ok, ref["accumulation" + key[len("expected_depth"):]],
                                      got["accumulation" + key[len("expected_depth"):]])
            if ok.mean() < 0.99 or not np.isfinite(b).all():
                raise AssertionError(f"{name} camera {label} {key}: {ok.mean():.4f} of pixels agree with the CPU")
            worst = min(worst, float(ok.mean()))
        if label == "PERSPECTIVE":
            plain_acc = got["accumulation"]
        elif crop is not None and np.allclose(got["accumulation"], plain_acc):
            raise AssertionError(f"{name}: crop_aabb did not change the render")
        agree[label] = worst
    log(f"{name} camera types {w}x{h} on the card against the CPU's plain path: "
        + ", ".join(f"{k} {v * 100:.2f}%" for k, v in agree.items())
        + " of pixels within 2e-2 (the worst output of each)")
    del cpu

    cam = make_camera(RENDER_HW[1], RENDER_HW[0], 1400.0, c2w)
    peaks = {}
    for per_sample in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        out = card.model.render_camera_device(cam, 0, include_per_sample=per_sample)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peaks[per_sample] = (torch.cuda.max_memory_allocated() - resident, resident, dt, read_counts())
        shapes = {k: tuple(v.shape) for k, v in out.items() if v.dim() == 3}
        if per_sample != bool(shapes) or any(s[0] != RENDER_HW[0] * RENDER_HW[1] or s[2] != 1 for s in shapes.values()):
            raise AssertionError(f"{name} 1080p include_per_sample={per_sample}: per-sample outputs {shapes}")
        if per_sample:
            per_sample_shapes = shapes
        del out
    if peaks[True][3] != peaks[False][3] or not any(peaks[True][3].values()):
        raise AssertionError(f"{name}: per-sample render launches {peaks[True][3]}, per-ray {peaks[False][3]}")
    log(f"{name} 1920x1080 render_camera_device with include_per_sample: {per_sample_shapes}, peak memory "
        f"{peaks[True][0] / 2**30:.2f} GiB above the {peaks[True][1] / 2**30:.2f} GiB resident, "
        f"{peaks[True][2]:.3f} s; "
        f"per-ray outputs only: {peaks[False][0] / 2**30:.2f} GiB, {peaks[False][2]:.3f} s ({smi})")
    del card
    torch.cuda.empty_cache()
    return {"agree": agree, "per_sample_peak": peaks[True][0], "per_ray_peak": peaks[False][0]}


def render_surface_phase(entries: dict, scene_dir: Path, out_dir: Path, smi: str) -> dict:
    """Phase 14: ns-render through the command on the entry points' runs,
    every camera type, fused_modalities training and the "xla" profiler."""
    from nerfstudio_thermal_torch.scripts import train as ns_train
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    result = {"ns_render": {}}
    name = HASH_METHOD
    run = entries[name]["run"]
    _, trainer = eval_setup(run / "config.yml", device="cpu")
    eval_cams = trainer.datamanager.eval_cameras
    rgb = [i for i, t in enumerate(trainer.datamanager.eval_dataset.is_thermal) if t == 0]
    eval_hw = [(int(eval_cams.height[i]), int(eval_cams.width[i])) for i in range(len(eval_cams))]
    del trainer
    path = write_camera_path(out_dir / "camera_path.json", eval_cams, RENDER_PATH_FRAMES, RENDER_HW)
    one = write_camera_path(out_dir / "camera_path_1.json", eval_cams, 1, RENDER_HW)
    diff = ["--removal-min-density-diff", "0.1"]
    runs = [  # (method, mode, flags, output names, each camera's (h, w))
        (name, "camera-path", ["--camera-path-filename", str(path)], RENDER_NAMES, [RENDER_HW] * RENDER_PATH_FRAMES),
        (name, "camera-path", ["--camera-path-filename", str(one), *diff], ("removal", "removal_thermal"),
         [RENDER_HW]),
        (name, "interpolated", ["--rgb-poses-only", "true", "--interpolation-steps", "2"], ("rgb",),
         [eval_hw[rgb[0]]] * 2),
        (name, "spiral", [], ("rgb",), [eval_hw[0]] * 30),
        (name, "dataset", [], ("rgb", "rgb_thermal", "depth_thermal"), eval_hw),
        ("thermal-nerfacto-tpu+fused", "camera-path", ["--camera-path-filename", str(path)], RENDER_NAMES,
         [RENDER_HW] * RENDER_PATH_FRAMES),
    ]
    for i, (m, mode, args, names, shapes) in enumerate(runs):
        r = ns_render(m, mode, entries[m]["run"], out_dir / str(i), args, names, shapes)
        per_frame = (r["total"] - r["setup"]) / r["frames"]
        flags = " ".join(a for a in args if a != "--camera-path-filename" and not a.endswith(".json"))
        log(f"{m} ns-render {mode} {flags}: {r['frames']} frames "
            f"at {shapes[0][1]}x{shapes[0][0]}, outputs {list(names)}, {r['pngs']} PNGs decoded at their cameras' "
            f"sizes; launches {({k: v for k, v in r['counts'].items() if v})} ({METHODS[m]['chunk']} per chunk); "
            f"{per_frame:.3f} s per frame through the command: render {r['render'] / r['frames']:.3f} s "
            f"(render_camera_device + synchronize), host {r['host'] / r['frames']:.3f} s (PNG encodes "
            f"{r['png'] / r['frames']:.3f} s of {r['png_bytes'] / r['frames'] / 2**20:.2f} MiB, depth colormaps "
            f"{r['colormap'] / r['frames']:.3f} s, the rest transfers and frame arithmetic); "
            f"setup {r['setup']:.2f} s ({smi})")
        if diff[0] in args and r["diffs"] != {0.1}:
            raise AssertionError(f"{m}: ns-render rendered with removal_min_density_diff {r['diffs']}")
        if mode == "camera-path" and diff[0] not in args:
            result["ns_render"][m] = {"s_per_frame": per_frame, "render_s": r["render"] / r["frames"],
                                      "host_s": r["host"] / r["frames"], "png_s": r["png"] / r["frames"],
                                      "counts": r["counts"]}
            log(f"{m} ns-render 1080p: {per_frame:.3f} s per frame through the command (render "
                f"{r['render'] / r['frames']:.3f} + host {r['host'] / r['frames']:.3f}) beside PERF.md's "
                f"render_camera_device line of 1.42-2.94 s per 1080p frame ({smi})")

    result["camera_types"] = camera_types_phase(name, run, smi)

    log(f"phase 14 ns-render and camera types: {time.perf_counter() - t_phase:.1f} s")
    # fused_modalities against the same method unfused, in turns (unfused,
    # fused, fused, unfused) at this point of the run: the host-bound steps
    # drift over a run, so phase 8's earlier runs are no fair yardstick
    fused = {}
    for m in FUSED_MODALITIES:
        base = m.partition(":")[0]
        runs = collections.defaultdict(list)
        for i, config in enumerate((base, m, m, base)):
            run_dir = out_dir / f"{i}_{config.replace(':', '_')}"
            counts, step_s, _, _, _, trainer = train_phase(config, scene_dir, run_dir)
            del trainer
            HASH_MODEL_CALLS.pop("train_step", None)  # phase 8b read its own
            torch.cuda.empty_cache()
            runs[config].append((step_s, counts))
        per_step = {c: {k: round(v / TRAIN_STEPS, 2) for k, v in runs[c][0][1].items() if v} for c in (base, m)}
        if per_step[m] != per_step[base]:
            raise AssertionError(f"{m}: kernel launches a step {per_step[m]}, unfused {per_step[base]}")
        ms = {c: [r[0] * 1e3 for r in runs[c]] for c in (base, m)}
        fused[m] = {"step_s": float(np.mean(ms[m])) / 1e3, "unfused_step_s": float(np.mean(ms[base])) / 1e3,
                    "counts": runs[m][0][1], "runs_ms": ms}
        log(f"{m}: train {' / '.join(f'{v:.2f}' for v in ms[m])} ms/step (steps {TIMED_FROM}-{TRAIN_STEPS - 1}), "
            f"unfused {' / '.join(f'{v:.2f}' for v in ms[base])}, in turns (unfused, fused, fused, unfused); kernel "
            f"launches per step {per_step[m]}, as unfused ({smi})")
    result["fused_modalities"] = fused
    log(f"phase 14 fused_modalities: {time.perf_counter() - t_phase:.1f} s")

    reset_counts()
    out = out_dir / "profiled"
    rc = ns_train.main([name, "--data", str(scene_dir), "--max-num-iterations", str(PROFILE_STEPS),
                        "--output-dir", str(out), "--trainer.profiler", "xla"])
    counts = read_counts()
    traces = list(out.glob(f"*/{name}/*/profiler_traces/trace.json"))
    if rc != 0 or len(traces) != 1:
        raise AssertionError(f"ns-train --trainer.profiler xla returned {rc}, traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = collections.Counter(match.group(0) for e in events if e.get("cat") == "kernel"
                                  for match in [re.search(r"hash_encode\w*", e.get("name", ""))] if match)
    idle = [k for k in METHODS[name]["step"](True) if counts[k] == 0]
    if not kernels or idle:
        raise AssertionError(f"the profiler trace names no hash kernel ({len(events)} events) or ns-train launched "
                             f"no {idle}")
    log(f"{name} ns-train --trainer.profiler xla, {PROFILE_STEPS} steps: {traces[0].name} "
        f"({traces[0].stat().st_size / 2**20:.1f} MiB, {len(events)} events) names the port's kernels "
        f"{dict(kernels)}")
    result["profiler_kernels"] = dict(kernels)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return result




# Phase 15: the data path and the instant-ngp family. The JPEG fixtures of
# tests/data/jpeg decode to the Pillow hashes of their manifest (the card's
# machine has no Pillow); the blender, instant_ngp and COLMAP (JPEG) scenes
# parse through build_dataparser; instant-ngp trains NGP_STEPS steps through
# ns-train at full width on a 10-frame RGB sphere scene (the dynamic batch
# and the occupancy grid live; launches per step: row 8 once for the field,
# twice on a grid-update step, whose density pass runs it on 2^18 points;
# rows 7/9 once; row 10 never: no camera optimizer, so no position needs a
# gradient), its step NGP_CAPTURE_STEP (a grid update and a step) is
# recorded for the hash kernels, an f32 card step is held against the CPU's
# with a bf16 control, a 1920x1080 and a 640x512 frame render (every sample,
# no grid: 254 and 40 chunks of 8192 rays), and ns-eval reloads the run;
# instant-ngp-bounded trains NGP_BOUNDED_STEPS steps through ns-train on an
# instant_ngp-format scene and renders with its black background; nerfacto
# trains COLMAP_STEPS steps on the COLMAP JPEG scene through train_phase
# (rows 7-10 with camera gradients).
JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
NGP_STEPS, NGP_BOUNDED_STEPS, COLMAP_STEPS = 48, 24, 20
NGP_CAPTURE_STEP = 32  # a grid update (2^18 points) and the step's own hash calls
NGP_TIMED = range(34, 48)  # after the update of step 32 the batch holds until step 48
NGP_PAIRS = 10  # the 0.9 split holds one frame out for ns-eval
NGP_SAMPLES = 192  # instant-ngp's samples per ray
NGP_RENDERS = {"1080p": (1920, 1080, 1400.0), "640x512": (640, 512, 500.0)}
# f32 card step against the CPU's (phase 9's limits): instant-ngp's step has
# one hash field and narrow f32 MLPs; the grid after the step's update must
# agree within NGP_GRID_TOL relative L2 (f32 densities, the hash forward
# equal up to 1e-6 absolute) and give the same live samples per ray.
NGP_GRID_TOL = 1e-5
DATA_SURFACE = {
    "nerfacto:colmap": dict(scene="colmap", chunk={"hash_encode_fwd": 3}, step=_hash_step(1)),
}


def ngp_step_counts(step: int, every: int = 16) -> dict:
    """Hash launches of an instant-ngp training step."""
    return {"hash_encode_fwd": 1 + (step % every == 0), "hash_encode_bwd_table": 1}


def image_io_phase(smi: str) -> dict:
    """The JPEG fixtures against their manifest, the progressive one raises;
    host times of a 1920x1080 decode and of its 0.5x resize (medians of 5)."""
    import hashlib

    from nerfstudio_thermal_torch.data import jpeg
    from nerfstudio_thermal_torch.data.datasets import resize_like_pil

    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    manifest = json.loads((JPEG_DIR / "manifest.json").read_text())
    checked, refused = 0, []
    for name, rec in sorted(manifest.items()):
        if rec.get("port_raises"):
            try:
                jpeg.decode_jpeg(JPEG_DIR / name)
            except NotImplementedError as e:
                refused.append(f"{name}: {str(e).split(': ', 1)[-1]}")
                continue
            raise AssertionError(f"{name} decoded; the baseline decoder must refuse it")
        arr = jpeg.decode_jpeg(JPEG_DIR / name)
        if hashlib.sha256(arr.tobytes()).hexdigest() != rec["sha256"] or list(arr.shape) != rec["shape"]:
            raise AssertionError(f"{name}: the decode does not match Pillow's ({arr.shape}, manifest {rec['shape']})")
        checked += 1
    if not refused:
        raise AssertionError("no fixture exercised the decoder's refusal")
    big = JPEG_DIR / "frame_1920x1080.jpg"
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        arr = jpeg.decode_jpeg(big)
        times.append(time.perf_counter() - t0)
    decode_ms = float(np.median(times)) * 1e3
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        small = resize_like_pil(arr, 960, 540)
        times.append(time.perf_counter() - t0)
    resize_ms = float(np.median(times)) * 1e3
    if small.shape != (540, 960, 3):
        raise AssertionError(f"resize gave {small.shape}")
    log(f"image_io: decoder built in {build_s:.2f} s; {checked} JPEG fixtures decode to their manifest's Pillow "
        f"hashes; refused: {'; '.join(refused)}; 1920x1080 decode {decode_ms:.1f} ms, 0.5x BILINEAR resize "
        f"{resize_ms:.1f} ms (host, median of 5) ({smi})")
    return {"decode_ms": decode_ms, "resize_ms": resize_ms, "fixtures": checked}


def write_ingp_scene(root: Path, num: int = NGP_PAIRS, w: int = 640, h: int = 480) -> Path:
    """An instant_ngp-format scene of the sphere: one transforms.json with
    shared intrinsics and aabb_scale 4, PNG frames."""
    from nerfstudio_thermal_torch.utils.writer import write_png

    (root / "images").mkdir(parents=True, exist_ok=True)
    frames, focal = [], 0.8 * w
    for i in range(num):
        ang = 2 * np.pi * i / num
        c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
        write_png(root / "images" / f"f_{i:03d}.png", render_sphere(c2w, w, h, focal, False))
        frames.append({"file_path": f"images/f_{i:03d}.png", "transform_matrix": c2w.tolist()})
    meta = {"fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2, "w": w, "h": h, "aabb_scale": 4,
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def write_blender_scene(root: Path, num: int = 4, size: int = 200) -> Path:
    from nerfstudio_thermal_torch.utils.writer import write_png

    (root / "train").mkdir(parents=True, exist_ok=True)
    frames, angle_x = [], 0.69
    focal = 0.5 * size / np.tan(0.5 * angle_x)
    for i in range(num):
        c2w = look_at(np.array([4.0 * np.cos(i), 4.0 * np.sin(i), 1.0]))
        write_png(root / "train" / f"r_{i}.png", render_sphere(c2w, size, size, focal, False))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "val", "test"):
        (root / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": angle_x, "frames": frames}))
    return root


def parsers_phase(tmp: Path) -> dict:
    """The blender, instant_ngp and COLMAP (JPEG) scenes through
    build_dataparser, as the trainer builds its parser."""
    from nerfstudio_thermal_torch.configs.dataparser_configs import build_dataparser, dataparser_configs
    from nerfstudio_thermal_torch.data.datasets import load_image

    scenes = {
        "blender-data": write_blender_scene(tmp / "blender"),
        "instant-ngp-data": write_ingp_scene(tmp / "ingp"),
        "colmap": JPEG_DIR / "colmap_sphere",
    }
    for key, data in scenes.items():
        cfg = copy.deepcopy(dataparser_configs[key])
        cfg.data = data
        t0 = time.perf_counter()
        out = build_dataparser(cfg).get_dataparser_outputs("train")
        img = load_image(out.image_filenames[0])
        dt = time.perf_counter() - t0
        c = out.cameras
        if img.shape[:2] != (int(c.height[0]), int(c.width[0])) or not np.isfinite(img).all():
            raise AssertionError(f"{key}: first image {img.shape} against camera {int(c.height[0])}x{int(c.width[0])}")
        if not bool(torch.isfinite(c.camera_to_worlds).all()):
            raise AssertionError(f"{key}: non-finite poses")
        log(f"parsers {key} ({type(build_dataparser(cfg)).__name__}): {len(out.image_filenames)} train cameras "
            f"{int(c.width[0])}x{int(c.height[0])}, fx {float(c.fx[0]):.1f}, scene box "
            f"{np.asarray(out.scene_box).tolist()}, scale {out.dataparser_scale:.4f}, first image "
            f"{Path(out.image_filenames[0]).suffix} {img.shape} ({dt:.2f} s with the decode)")
    return scenes


@contextlib.contextmanager
def capturing_trainer(on_setup):
    """While open, every trainer that ns-train (scripts.train) sets up is
    handed to on_setup first."""
    from nerfstudio_thermal_torch.scripts import train as ns_train

    inner = ns_train.setup_trainer

    def wrapped(*args, **kwargs):
        trainer = inner(*args, **kwargs)
        on_setup(trainer)
        return trainer

    ns_train.setup_trainer = wrapped
    try:
        yield
    finally:
        ns_train.setup_trainer = inner


def ngp_train(name: str, scene: Path, out_dir: Path, steps: int, capture_step=None) -> dict:
    """ns-train of an instant-ngp method at full width for `steps` steps,
    each synchronized and timed, with its launches (against
    ngp_step_counts), its ray batch, the dynamic batch's override after it,
    the grid on update steps, and every loss finite. Returns the records,
    the run directory and the peak memory."""
    from nerfstudio_thermal_torch.scripts import train as ns_train

    records, holder = [], {}

    def on_setup(trainer):
        holder["trainer"] = trainer
        iteration = trainer.train_iteration
        every = trainer.model.config.grid_update_every

        def counted(step):
            rays = trainer.datamanager.num_rays_override or trainer.datamanager.config.train_num_rays_per_batch
            c0 = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == capture_step:
                with recording_hash_calls() as calls:
                    out = iteration(step)
                HASH_MODEL_CALLS[f"{name} train step {step}"] = calls
            else:
                out = iteration(step)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v - c0[k] for k, v in read_counts().items()}
            if launches != expected_counts(ngp_step_counts(step, every)):
                raise AssertionError(f"{name} step {step}: launches {launches}, expected {ngp_step_counts(step, every)}")
            rec = {"step": step, "rays": rays, "s": dt, "override": trainer.datamanager.num_rays_override,
                   **{k: float(v) for k, v in out.items()}}
            if not all(math.isfinite(rec[k]) for k in out if "loss" in k):
                raise AssertionError(f"{name} step {step}: non-finite loss {rec}")
            if step % every == 0:
                grid = trainer.state.extra
                rec["occupied"] = float((grid.densities > trainer.model.config.alpha_thre).float().mean())
            records.append(rec)
            return out

        trainer.train_iteration = counted

    argv = [name, "--data", str(scene), "--output-dir", str(out_dir), "--experiment-name", "smoke",
            "--max-num-iterations", str(steps)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with capturing_trainer(on_setup):
        if ns_train.main(argv, device="cuda") != 0:
            raise AssertionError(f"ns-train {name} failed")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    (run,) = (out_dir / "smoke" / name).glob("*")
    if len(records) != steps:
        raise AssertionError(f"{name}: {len(records)} steps ran, expected {steps}")
    del holder
    return {"records": records, "run": run, "peak": peak, "counts": counts}


def ngp_render(model, label: str, w: int, h: int, focal: float, c2w) -> tuple:
    """One frame through render_camera_device (every sample, no grid):
    launches (one hash forward a chunk), finite outputs; seconds."""
    cam = make_camera(w, h, focal, c2w)
    n_chunks = -(-(w * h) // model.config.eval_num_rays_per_chunk)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.render_camera_device(cam, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if read_counts() != expected_counts({"hash_encode_fwd": 1}, n_chunks):
        raise AssertionError(f"render {label}: launches {read_counts()}, expected one hash forward x {n_chunks}")
    check_image_outputs(out, h, w, {"rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1})
    return out, dt, n_chunks


def ngp_step_vs_cpu(scene: Path, run_dir: Path) -> None:
    """One f32 instant-ngp step of 256 rays at full width on the card and
    on the CPU from the same seeded params, batch, sampler jitter, grid
    draws (2^18 cells and jitters) and background; a bf16 card step is the
    control that must break a limit."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer

    method = get_method_config("instant-ngp")
    method.data = scene
    method.datamanager.train_num_rays_per_batch = 256
    method.model.compute_dtype = "float32"
    control = copy.deepcopy(method)
    control.model.compute_dtype = "bfloat16"
    runs = {"cpu": ("cpu", method), "cuda": ("cuda", method), "control": ("cuda", control)}
    gen = torch.Generator().manual_seed(11)
    res, samples = method.model.grid_resolution, method.model.num_samples_per_ray
    draws = (torch.randint(0, res**3, (2**18,), generator=gen), torch.rand(2**18, 3, generator=gen))
    uniforms = {"rgb": [torch.rand(256, samples + 1, generator=gen)]}
    background = torch.rand(256, 3, generator=gen)
    results, batch = {}, None
    for label, (dev, m) in runs.items():
        tr = setup_trainer(copy.deepcopy(m), base_dir=run_dir / label, device=dev)
        tr.setup()
        batch = batch or tr.datamanager.next_train(0)
        t0 = time.perf_counter()
        scalars = tr._train_step(
            tr.state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
            uniforms={"rgb": [u.to(dev) for u in uniforms["rgb"]]}, background_uniforms=background.to(dev),
            extra_draws=tuple(d.to(dev) for d in draws))
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten().float().cpu()
                           for p in tr.model.param_groups()["fields"]])
        results[label] = ({k: float(v) for k, v in scalars.items()}, grads, tr.state.extra.densities.cpu(),
                          time.perf_counter() - t0)
        del tr
    want_s, want_g, want_grid, cpu_s = results["cpu"]
    reads = {}
    for label in ("cuda", "control"):
        got_s, got_g, got_grid, _ = results[label]
        losses = {k: abs(got_s[k] - w) / max(abs(w), 1e-3) for k, w in want_s.items() if k != "num_samples_per_ray"}
        reads[label] = (losses, rel_l2(got_g, want_g), rel_l2(got_grid, want_grid),
                        got_s["num_samples_per_ray"], want_s["num_samples_per_ray"])
        log(f"instant-ngp step_vs_cpu {'float32' if label == 'cuda' else 'bfloat16 control'} (256 rays, full width, "
            f"CPU step {cpu_s:.1f} s): losses/metrics up to {max(losses.values()):.2e} rel (tol "
            f"{STEP_LOSS_TOL_F32:g}); fields gradient rel L2 {reads[label][1]:.2e} (tol {STEP_GRAD_TOL_F32:g}); grid "
            f"after the update rel L2 {reads[label][2]:.2e} (tol {NGP_GRID_TOL:g}); live samples per ray "
            f"{reads[label][3]:.4f} / CPU {reads[label][4]:.4f}")
    losses, grad, grid, spr, cpu_spr = reads["cuda"]
    if max(losses.values()) > STEP_LOSS_TOL_F32 or grad > STEP_GRAD_TOL_F32 or grid > NGP_GRID_TOL or spr != cpu_spr:
        raise AssertionError(f"instant-ngp f32 step disagrees with the CPU: {reads['cuda']}")
    losses, grad, _, _, _ = reads["control"]
    if max(losses.values()) <= STEP_LOSS_TOL_F32 and grad <= STEP_GRAD_TOL_F32:
        raise AssertionError("instant-ngp: the bf16 control stays within every f32 limit: the limits cannot tell "
                             "the f32 path from a bf16 one")


def ngp_phase(rgb_scene: Path, ingp_scene: Path, tmp: Path, smi: str) -> dict:
    """Phase 15's instant-ngp family (see the comment above JPEG_DIR)."""
    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    result = {}
    ngp = ngp_train("instant-ngp", rgb_scene, tmp / "ngp", NGP_STEPS, capture_step=NGP_CAPTURE_STEP)
    recs = ngp["records"]
    for r in recs:
        if "occupied" in r:
            log(f"instant-ngp step {r['step']}: grid update, {r['occupied'] * 100:.2f}% of the 128^3 cells above "
                f"alpha_thre; live samples per ray {r['num_samples_per_ray']:.2f} of {NGP_SAMPLES}; {r['rays']} rays this "
                f"step, dynamic batch -> {r['override']} rays")
    sizes = [r["rays"] for r in recs]
    if len(set(sizes)) < 2:
        raise AssertionError(f"instant-ngp: the ray batch never changed ({sorted(set(sizes))})")
    timed = [r for r in recs if r["step"] in NGP_TIMED]
    if len({r["rays"] for r in timed}) != 1:
        raise AssertionError(f"instant-ngp: the timed stretch changed its batch ({[r['rays'] for r in timed]})")
    step_s = float(np.mean([r["s"] for r in timed]))
    rays = timed[0]["rays"]
    live = float(np.mean([r["num_samples_per_ray"] for r in timed]))
    result["instant-ngp"] = {"step_s": step_s, "rays": rays, "live": live, "peak": ngp["peak"],
                             "sizes": sizes, "update_s": [r["s"] for r in recs if r["step"] % 16 == 0]}
    log(f"instant-ngp train: {NGP_STEPS} steps through ns-train, batches {sizes[0]} -> {sorted(set(sizes))}, "
        f"launches per step {ngp_step_counts(1)} ({ngp_step_counts(0)} on a grid update; hash_encode_bwd_pos 0), "
        f"losses finite; steps {NGP_TIMED.start}-{NGP_TIMED.stop - 1}: {step_s * 1e3:.2f} ms/step at {rays} rays, "
        f"{rays / step_s:,.0f} rays/s, {rays * NGP_SAMPLES / step_s:,.0f} samples/s evaluated, {rays * live / step_s:,.0f} "
        f"live samples/s ({live:.2f} live a ray); grid-update steps {[round(s * 1e3, 1) for s in result['instant-ngp']['update_s']]} ms; "
        f"peak memory {ngp['peak'] / 2**30:.2f} GiB ({smi})")
    step_calls = HASH_MODEL_CALLS[f"instant-ngp train step {NGP_CAPTURE_STEP}"]
    if [rec["g"] is not None for rec in step_calls] != [False, True] or step_calls[0]["pos"].shape[0] != 2**18:
        raise AssertionError(f"instant-ngp step {NGP_CAPTURE_STEP}: recorded "
                             f"{[(r['pos'].shape[0], r['g'] is not None) for r in step_calls]}, expected the grid "
                             "update's 2^18 points (no cotangent) and the step's samples (with one)")
    for rec in step_calls:
        rec["with_pos"] = False  # no position gradient on this path
    ngp_step_vs_cpu(rgb_scene, tmp / "ngp_step")

    config_path = ngp["run"] / "config.yml"
    _, trainer = eval_setup(config_path, device="cuda")
    model = trainer.model
    c2w = trainer.datamanager.train_cameras.camera_to_worlds[0].numpy()
    frames, render_launches = {}, {}
    for label, (w, h, focal) in NGP_RENDERS.items():
        out, dt, n_chunks = ngp_render(model, label, w, h, focal, c2w)
        frames[label] = dt
        render_launches[label] = read_counts()
        log(f"instant-ngp render {label}: {n_chunks} chunks of {model.config.eval_num_rays_per_chunk} rays x {NGP_SAMPLES} "
            f"samples, one hash forward a chunk, outputs finite; {dt:.3f} s/frame, {w * h / dt:,.0f} rays/s, "
            f"{w * h * NGP_SAMPLES / dt:,.0f} samples/s ({smi})")
        del out
    result["instant-ngp"].update(frames=frames, render_launches=render_launches, counts=ngp["counts"])
    del trainer, model
    torch.cuda.empty_cache()
    out_json = tmp / "ngp_eval.json"
    t0 = time.perf_counter()
    if ns_eval.main(["--load-config", str(config_path), "--output-path", str(out_json)], device="cuda") != 0:
        raise AssertionError("ns-eval of the instant-ngp run failed")
    scores = json.loads(out_json.read_text())["results"]
    if not all(math.isfinite(v) for v in scores.values()) or "psnr_rgb" not in scores:
        raise AssertionError(f"ns-eval of the instant-ngp run: {scores}")
    log(f"instant-ngp ns-eval: {time.perf_counter() - t0:.2f} s, psnr_rgb {scores['psnr_rgb']:.3f}, ssim_rgb "
        f"{scores['ssim_rgb']:.4f}")

    bounded = ngp_train("instant-ngp-bounded", ingp_scene, tmp / "ngp_bounded", NGP_BOUNDED_STEPS)
    recs = bounded["records"]
    timed = [r for r in recs if r["step"] >= 17]
    step_s = float(np.mean([r["s"] for r in timed]))
    _, trainer = eval_setup(bounded["run"] / "config.yml", device="cuda")
    out, dt, n_chunks = ngp_render(trainer.model, "640x480", 640, 480, 0.8 * 640,
                                   trainer.datamanager.train_cameras.camera_to_worlds[0].numpy())
    over = float((out["rgb"] - out["accumulation"]).max())
    if over > 1e-3:
        raise AssertionError(f"instant-ngp-bounded: rgb exceeds the accumulation by {over} (the background is not black)")
    log(f"instant-ngp-bounded train: {NGP_BOUNDED_STEPS} steps through ns-train, batches "
        f"{sorted({r['rays'] for r in recs})}, losses finite; steps 17-{NGP_BOUNDED_STEPS - 1}: {step_s * 1e3:.2f} "
        f"ms/step at {timed[0]['rays']} rays; render 640x480 {dt:.3f} s, black background (rgb <= accumulation "
        f"+ {max(over, 0.0):.1e}); peak memory {bounded['peak'] / 2**30:.2f} GiB ({smi})")
    result["instant-ngp-bounded"] = {"step_s": step_s, "rays": timed[0]["rays"], "frame_s": dt}
    del trainer, out
    torch.cuda.empty_cache()

    counts, step_s, rays, _, _, trainer = train_phase("nerfacto:colmap", JPEG_DIR / "colmap_sphere",
                                                      tmp / "nerfacto_colmap", COLMAP_STEPS, 2)
    log(f"nerfacto on the COLMAP JPEG scene: {COLMAP_STEPS} steps, {step_s * 1e3:.2f} ms/step, "
        f"{rays / step_s:,.0f} rays/s; launches {dict((k, v) for k, v in counts.items() if v)} ({smi})")
    result["nerfacto:colmap"] = {"step_s": step_s, "rays": rays, "launches": {k: v for k, v in counts.items() if v}}
    del trainer
    torch.cuda.empty_cache()
    log(f"phase 15 instant-ngp family and COLMAP: {time.perf_counter() - t_phase:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 16: vanilla-nerf, mipnerf, tensorf and depth-nerfacto.
#
# vanilla-nerf and mipnerf run their 8 x 256 base stacks (skip at 4, the last
# layer 256 wide) over an input encoded outside the kernel: 63 wide (10
# frequencies) and 99 wide (mipnerf's 16-frequency integrated encoding). With
# use_pallas each training step runs rows 1 and 2 twice (the coarse and the
# fine pass's field), each render chunk row 1 twice; without it nothing
# launches. tensorf launches no kernel (XLA gathers and a 2 x 128 head in
# JAX). depth-nerfacto launches what nerfacto does (rows 7-10; its camera
# optimizer gives row 10). The f32 card-vs-CPU step holds phase 9's limits
# at 4 position frequencies (CLASSIC_F32_FREQS): at the methods' 10 or 16
# the card's and the CPU's ray positions differ in the last bit, and the
# top frequencies (up to 2 pi 2^15 rad per unit) amplify that (ROADMAP C4).

CLASSIC_STEPS, CLASSIC_TIMED_FROM, CLASSIC_CAPTURE_STEP = 30, 10, 9
BLENDER_FRAMES, BLENDER_SIZE, BLENDER_VAL = 8, 800, 2  # the synthetic scenes' frames; val frames kept
DEPTH_FRAMES = 10  # the 0.9 split holds one frame out for ns-eval
CLASSIC_RENDERS = {"1080p": (1920, 1080, 1400.0), "640x512": (640, 512, 500.0)}
NERF_STACKS = {"vanilla-nerf": 63, "mipnerf": 99}  # the base stack's input width
NERF_DIMS = (256,) * 8
NERF_FWD_N, NERF_BWD_N = 1 << 20, 1 << 18
CLASSIC_F32_FREQS = 4
TENSORF_UPSAMPLES = (10, 20)  # within the run: 128 -> 196 -> 300
CLASSIC = {
    # launches a training step / a render chunk; renders; the run's flags
    "vanilla-nerf": dict(step={"fused_mlp_fwd": 2, "fused_mlp_bwd": 2}, chunk={"fused_mlp_fwd": 2},
                         renders=("1080p", "640x512"), flags=["--pipeline.model.use-pallas", "True"]),
    "mipnerf": dict(step={"fused_mlp_fwd": 2, "fused_mlp_bwd": 2}, chunk={"fused_mlp_fwd": 2},
                    renders=("640x512",), flags=["--pipeline.model.use-pallas", "True"]),
    "tensorf": dict(step={}, chunk={}, renders=("640x512",),
                    flags=["--pipeline.model.upsampling-iters", ",".join(map(str, TENSORF_UPSAMPLES))]),
    "depth-nerfacto": dict(step=None, chunk={"hash_encode_fwd": 3}, renders=("640x512",),
                           flags=["--pipeline.datamanager.dataparser.auto-scale-poses", "False",
                                  "--steps-per-eval-batch", "10"]),
}


def write_classic_blender(root: Path) -> Path:
    """The blender scene at the synthetic scenes' size: BLENDER_FRAMES
    frames of 800 x 800, the val (and test) split cut to BLENDER_VAL."""
    write_blender_scene(root, num=BLENDER_FRAMES, size=BLENDER_SIZE)
    for split in ("val", "test"):
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        meta["frames"] = meta["frames"][:BLENDER_VAL]
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    return root


def write_depth_scene(root: Path, num: int = DEPTH_FRAMES, w: int = 640, h: int = 480) -> Path:
    """The RGB sphere scene in the Nerfstudio layout with a 16-bit depth PNG
    per frame: the z-depth of the ray-sphere hit in millimetres, 0 (no
    depth) where the ray misses."""
    from nerfstudio_thermal_torch.utils.writer import write_png

    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "depths").mkdir(parents=True, exist_ok=True)
    frames, focal = [], 0.8 * w
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    cam = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -np.ones_like(xs)], -1)
    for i in range(num):
        ang = 2 * np.pi * i / num
        c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
        write_png(root / "images" / f"frame_{i:04d}.png", render_sphere(c2w, w, h, focal, False))
        norm = np.linalg.norm(cam, axis=-1)
        d = (cam @ c2w[:3, :3].T) / norm[..., None]
        o = c2w[:3, 3]
        b = d @ o
        disc = b * b - (o @ o - 1.0)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        z_mm = np.where(disc > 0, np.rint(t / norm * 1000.0), 0.0).astype(np.uint16)
        write_png(root / "depths" / f"frame_{i:04d}.png", z_mm[..., None])
        frames.append({"file_path": f"images/frame_{i:04d}.png", "depth_file_path": f"depths/frame_{i:04d}.png",
                       "transform_matrix": c2w.tolist(), "fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2,
                       "w": w, "h": h})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return root


@contextlib.contextmanager
def recording_mlp_calls():
    """While open, every fused-MLP call of the port's MLP modules (the
    models' entry to rows 1 and 2) appends a record to the yielded list:
    its input, weights and biases (cloned: the step's update follows), spec
    and, where its backward runs, the cotangent its output receives. The
    call computes and counts as before."""
    from nerfstudio_thermal_torch.ops import mlp as mlp_module

    calls, inner = [], mlp_module.fused_mlp

    def recorded(x, weights, biases, activation, out_activation, skips, freq, dtype, cache=None):
        out = inner(x, weights, biases, activation, out_activation, skips, freq, dtype, cache)
        rec = {"x": x.detach().clone(), "ws": [w.detach().clone() for w in weights],
               "bs": [b.detach().clone() for b in biases], "spec": (out_activation, tuple(skips), freq, dtype),
               "g": None}
        if out.requires_grad:
            out.register_hook(lambda g: rec.update(g=g.detach().clone()))
        calls.append(rec)
        return out

    mlp_module.fused_mlp = recorded
    try:
        yield calls
    finally:
        mlp_module.fused_mlp = inner


def mlp_model_phase(scope: str, calls) -> dict:
    """Rows 1 and 2 on the inputs and cotangents a model's training step
    gave them (recording_mlp_calls), each held against its plain version
    (phase 3's and 4's tolerances) and timed with its bound. Returns the
    sums per step by kernel name."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    sums = {k: {"ms": 0.0, "bound_ms": 0.0, "calls": 0, "points": 0} for k in ("fused_mlp_fwd", "fused_mlp_bwd")}
    for i, rec in enumerate(calls):
        out_act, skips, freq, dtype = rec["spec"]
        x, ws, bs, g = rec["x"].float().contiguous(), rec["ws"], rec["bs"], rec["g"]
        n, in_dim = x.shape
        packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, dtype, transposed=True)
        got = fm.launch(x, packed)
        torch.cuda.synchronize()
        fwd_err = check_fwd(f"{scope}[{i}] fused_mlp_fwd", got, fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips,
                                                                                   freq, dtype), dtype)
        macs = mlp_macs(ws)
        peak = (lambda f: bound3(*f, 0.0)) if dtype == torch.bfloat16 else (lambda f: bound3(f[0], 0.0, f[1]))
        line = f"mlp_model {scope}[{i}] {str(dtype)[6:]} [{packed.fwd_path} path] n={n} in {in_dim}: forward " \
               f"max_abs_err={fwd_err:.3e}"
        ms = cuda_ms(lambda: fm.launch(x, packed), iters=10)
        b_ms = peak((n * (in_dim * 4 + ws[-1].shape[1] * 2) + param_bytes(ws, bs, False), 2.0 * n * macs))[0]
        s = sums["fused_mlp_fwd"]
        s["ms"], s["bound_ms"], s["calls"], s["points"] = s["ms"] + ms, s["bound_ms"] + b_ms, s["calls"] + 1, s["points"] + n
        line += f" kernel {ms:.3f} ms (bound {b_ms:.3f})"
        if g is not None:
            g = g.to(dtype).contiguous()
            dx, dw, db = fm.launch_bwd(x, g, packed)
            dws, dbs = fm.unpack_grads(dw, db, packed.desc, packed.shapes)
            torch.cuda.synchronize()
            want = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, freq, dtype)
            named = [("dx", dx.to(dtype).float(), want[0].float())]
            named += [(f"dW{j}", a, b) for j, (a, b) in enumerate(zip(dws, want[1]))]
            named += [(f"db{j}", a, b) for j, (a, b) in enumerate(zip(dbs, want[2]))]
            worst, key, _ = check_bwd(f"{scope}[{i}] fused_mlp_bwd", named, dtype)
            ms = cuda_ms(lambda: fm.launch_bwd(x, g, packed), iters=5)
            b_ms = peak((n * (in_dim * 8 + ws[-1].shape[1] * 2) + param_bytes(ws, bs, True), 6.0 * n * macs))[0]
            s = sums["fused_mlp_bwd"]
            s["ms"], s["bound_ms"] = s["ms"] + ms, s["bound_ms"] + b_ms
            s["calls"], s["points"] = s["calls"] + 1, s["points"] + n
            line += f"; backward worst rel L2 {worst:.3e} ({key}) kernel {ms:.3f} ms (bound {b_ms:.3f})"
            del dx, dw, db, dws, dbs, want, named
        log(line + " ok")
        del got, packed
    torch.cuda.empty_cache()
    for kname, s in sums.items():
        log(f"mlp_model {kname} per {scope}: {s['calls']} calls, {s['points']} points, kernel {s['ms']:.3f} ms, "
            f"bound {s['bound_ms']:.3f} ms")
    return sums


def nerf_stack_phase() -> dict:
    """Rows 1 and 2 on the frequency NeRF's base stacks (63- and 99-wide
    encoded inputs, 8 x 256, skip at 4, the last layer 256), bf16 and f32,
    against their plain versions: the forward at NERF_FWD_N points, the
    backward at NERF_BWD_N; each timed with plain, library (the
    torch.matmul chain) and bound. Returns {"fwd": {case: record}, "bwd":
    {...}}."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    gen = torch.Generator().manual_seed(16)
    out = {"fwd": {}, "bwd": {}}
    for name, in_dim in NERF_STACKS.items():
        ws, bs = mlp_params(gen, in_dim, NERF_DIMS, (4,), None)
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{name.replace('-', '_')}_{in_dim}_{str(dtype)[6:]}"
            bf16 = dtype == torch.bfloat16
            macs = mlp_macs(ws)
            wb, bb = [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]

            def timed_bound(nbytes, flops):
                return bound3(nbytes, flops, 0.0) if bf16 else bound3(nbytes, 0.0, flops)

            x = (torch.rand(NERF_FWD_N, in_dim, generator=gen) * 2 - 1).cuda().to(dtype).float()
            packed = fm.prepare(in_dim, ws, bs, None, (4,), None, dtype, transposed=True)
            got = fm.launch(x, packed)
            torch.cuda.synchronize()
            err = check_fwd(f"fused_mlp_fwd {tag}", got, fm.fused_mlp_plain(x, ws, bs, "relu", None, (4,), None, dtype),
                            dtype)
            rec = {"ms": cuda_ms(lambda: fm.launch(x, packed), iters=10 if bf16 else 5),
                   "plain_ms": cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, "relu", None, (4,), None, dtype), 2),
                   "library_ms": cuda_ms(lambda: library_mlp(x, wb, bb, (4,), None, None, dtype), iters=5),
                   "max_abs_err": err, "n": NERF_FWD_N, "path": packed.fwd_path}
            rec["bound_ms"], rec["bound_by"], _ = timed_bound(
                NERF_FWD_N * (in_dim * 4 + NERF_DIMS[-1] * 2) + param_bytes(ws, bs, False), 2.0 * NERF_FWD_N * macs)
            out["fwd"][tag] = rec
            log(f"nerf_stack rows 1 {tag} [{packed.fwd_path} path]: n={NERF_FWD_N} max_abs_err={err:.3e} (tol "
                f"{TOL[dtype]:g} abs+rel) ok | kernel {rec['ms']:.3f} ms ({2.0 * NERF_FWD_N * macs / rec['ms'] / 1e9:.1f} "
                f"TFLOP/s), plain {rec['plain_ms']:.3f} ms, torch.matmul chain {rec['library_ms']:.3f} ms, bound "
                f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})")
            del x, got
            x = x_b = (torch.rand(NERF_BWD_N, in_dim, generator=gen) * 2 - 1).cuda().to(dtype).float()
            g = (torch.randn(NERF_BWD_N, NERF_DIMS[-1], generator=gen) / NERF_BWD_N).cuda().to(dtype)
            dx, dw, db = fm.launch_bwd(x_b, g, packed)
            dws, dbs = fm.unpack_grads(dw, db, packed.desc, packed.shapes)
            torch.cuda.synchronize()
            want = fm.fused_mlp_bwd_plain(x_b, g, ws, bs, "relu", None, (4,), None, dtype)
            named = [("dx", dx.to(dtype).float(), want[0].float())]
            named += [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want[1]))]
            named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want[2]))]
            worst, key, berr = check_bwd(f"fused_mlp_bwd {tag}", named, dtype)
            del dx, dw, db, dws, dbs, want, named
            wr = [w.requires_grad_(True) for w in (wb + bb)]
            xr = x_b.to(dtype).clone().requires_grad_(True)

            def library():
                o = library_mlp(xr, wr[: len(ws)], wr[len(ws):], (4,), None, None, dtype)
                return torch.autograd.grad(o, [xr, *wr], g)

            rec = {"ms": cuda_ms(lambda: fm.launch_bwd(x_b, g, packed), iters=5),
                   "plain_ms": cuda_ms(lambda: fm.fused_mlp_bwd_plain(x_b, g, ws, bs, "relu", None, (4,), None, dtype), 1),
                   "library_ms": cuda_ms(library, iters=3), "max_abs_err": berr, "n": NERF_BWD_N}
            rec["bound_ms"], rec["bound_by"], _ = timed_bound(
                NERF_BWD_N * (in_dim * 8 + NERF_DIMS[-1] * 2) + param_bytes(ws, bs, True), 6.0 * NERF_BWD_N * macs)
            out["bwd"][tag] = rec
            log(f"nerf_stack rows 2 {tag}: n={NERF_BWD_N} worst rel L2 {worst:.3e} ({key}; tol {BWD_TOL[dtype]:g}) ok | "
                f"kernel {rec['ms']:.3f} ms ({6.0 * NERF_BWD_N * macs / rec['ms'] / 1e9:.1f} TFLOP/s), plain "
                f"{rec['plain_ms']:.3f} ms, torch.matmul chain fwd+grad {rec['library_ms']:.3f} ms, bound "
                f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})")
            del x, g, packed, wr, xr
            torch.cuda.empty_cache()
    return out


def classic_train(name: str, scene: Path, out_dir: Path, flags, per_step, steps: int = CLASSIC_STEPS,
                  capture_step=None, on_step=None) -> dict:
    """ns-train of `name` at full width for `steps` steps, each synchronized
    and timed, with its launches (`per_step`, or with None nerfacto's, by
    proposal_updated), every loss finite, every param group changed. capture_step: that step's fused-MLP and hash calls are
    recorded for mlp_model_phase / hash_model_phase. on_step(trainer, step,
    scalars) runs after each step. Returns the records, the run, the counts,
    the peak memory and the trainer."""
    from nerfstudio_thermal_torch.models.nerfacto import proposal_updated
    from nerfstudio_thermal_torch.scripts import train as ns_train

    records, holder, captured = [], {}, {}

    def on_setup(trainer):
        holder["trainer"] = trainer
        iteration = trainer.train_iteration
        groups = trainer.model.param_groups()
        holder["before"] = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}

        def counted(step):
            ssu = trainer.state.steps_since_update
            c0 = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == capture_step:
                with recording_mlp_calls() as mlp_calls, recording_hash_calls() as hash_calls:
                    out = iteration(step)
                torch.cuda.synchronize()
                captured.update(mlp=mlp_calls, hash=hash_calls)
            else:
                out = iteration(step)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v - c0[k] for k, v in read_counts().items()}
            want = per_step
            if want is None:
                cfg = trainer.model.config
                updated, _ = proposal_updated(step, ssu, cfg.proposal_warmup, cfg.proposal_update_every)
                want = _hash_step(1)(updated)
            if launches != expected_counts(want):
                raise AssertionError(f"{name} step {step}: launches {launches}, expected {want}")
            scalars = {k: float(v) for k, v in out.items()}
            bad = [k for k, v in scalars.items() if "loss" in k and not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{name} step {step}: non-finite losses {bad}")
            records.append({"step": step, "s": dt, **scalars})
            if on_step is not None:
                on_step(trainer, step, scalars)
            return out

        trainer.train_iteration = counted

    argv = [name, "--data", str(scene), "--output-dir", str(out_dir), "--experiment-name", "smoke",
            "--max-num-iterations", str(steps), *flags]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with capturing_trainer(on_setup):
        if ns_train.main(argv, device="cuda") != 0:
            raise AssertionError(f"ns-train {name} failed")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    trainer = holder["trainer"]
    if len(records) != steps:
        raise AssertionError(f"{name}: {len(records)} steps ran, expected {steps}")
    groups = trainer.model.param_groups()
    unchanged = [k for k, ps in groups.items()
                 if all(a.shape == p.shape and torch.equal(a, p.detach()) for a, p in zip(holder["before"][k], ps))]
    nonfinite = [k for k, p in trainer.model.named_parameters() if not bool(torch.isfinite(p).all())]
    if unchanged or nonfinite:
        raise AssertionError(f"{name}: groups {unchanged} unchanged, parameters {nonfinite} not finite")
    (run,) = (out_dir / "smoke" / name).glob("*")
    step_s = float(np.mean([r["s"] for r in records[CLASSIC_TIMED_FROM:]]))
    return {"records": records, "run": run, "counts": counts, "peak": peak, "step_s": step_s, "trainer": trainer,
            **captured}


def classic_render(model, name: str, label: str, c2w) -> float:
    """One frame through render_camera_device: launches (CLASSIC's per
    chunk), finite outputs of the right shapes; seconds."""
    w, h, focal = CLASSIC_RENDERS[label]
    cam = make_camera(w, h, focal, c2w)
    n_chunks = -(-(w * h) // model.config.eval_num_rays_per_chunk)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.render_camera_device(cam, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if read_counts() != expected_counts(CLASSIC[name]["chunk"], n_chunks):
        raise AssertionError(f"{name} render {label}: launches {read_counts()}, expected {CLASSIC[name]['chunk']} x "
                             f"{n_chunks}")
    check_image_outputs(out, h, w, {"rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1})
    return dt, n_chunks, read_counts()


def classic_step_vs_cpu(name: str, scene: Path, run_dir: Path) -> dict:
    """One f32 step of 256 rays (use_pallas: rows 1-2 in f32) on the card and
    on the CPU from the same seeded params, batch and both jitter draws, the
    fields at CLASSIC_F32_FREQS position frequencies; a bf16 card step is
    the control that must break a limit (phase 9's)."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
    from nerfstudio_thermal_torch.fields.vanilla_nerf_field import NeRFField
    from nerfstudio_thermal_torch.models import mipnerf, vanilla_nerf

    def field(**kw):
        kw["position_num_frequencies"] = CLASSIC_F32_FREQS
        return NeRFField(**kw)

    method = get_method_config(name)
    method.data = scene
    method.datamanager.train_num_rays_per_batch = 256
    method.model.compute_dtype, method.model.use_pallas = "float32", True
    control = copy.deepcopy(method)
    control.model.compute_dtype = "bfloat16"
    runs = {"cpu": ("cpu", method), "cuda": ("cuda", method), "control": ("cuda", control)}
    m = method.model
    gen = torch.Generator().manual_seed(21)
    uniforms = [torch.rand(256, m.num_coarse_samples + 1, generator=gen),
                torch.rand(256, m.num_importance_samples + 1, generator=gen)]
    inner = vanilla_nerf.NeRFField, mipnerf.NeRFField
    vanilla_nerf.NeRFField = mipnerf.NeRFField = field
    try:
        trainers = {label: setup_trainer(copy.deepcopy(mm), base_dir=run_dir / label, device=dev)
                    for label, (dev, mm) in runs.items()}
    finally:
        vanilla_nerf.NeRFField, mipnerf.NeRFField = inner
    batch = trainers["cpu"].datamanager.next_train(0)
    results, launches = {}, {}
    for label, tr in trainers.items():
        dev = runs[label][0]
        tr.setup()
        c0 = read_counts()
        scalars = tr._train_step(tr.state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
                                 uniforms={"rgb": [u.to(dev) for u in uniforms]})
        launches[label] = {k: v - c0[k] for k, v in read_counts().items() if v - c0[k]}
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten().float().cpu()
                           for p in tr.model.param_groups()["fields"]])
        results[label] = ({k: float(v) for k, v in scalars.items()}, grads)
    del trainers
    if launches["cuda"] != {"fused_mlp_fwd": 2, "fused_mlp_bwd": 2}:
        raise AssertionError(f"{name} f32 step: launches {launches['cuda']}")
    want_s, want_g = results["cpu"]
    reads = {}
    for label in ("cuda", "control"):
        got_s, got_g = results[label]
        losses = {k: abs(got_s[k] - w) / max(abs(w), 1e-3) for k, w in want_s.items()}
        reads[label] = (max(losses.values()), rel_l2(got_g, want_g))
        log(f"{name} step_vs_cpu {'float32' if label == 'cuda' else 'bfloat16 control'} (256 rays, "
            f"{CLASSIC_F32_FREQS} position frequencies, use_pallas): losses/metrics up to {reads[label][0]:.2e} rel "
            f"(tol {STEP_LOSS_TOL_F32:g}); fields gradient rel L2 {reads[label][1]:.2e} (tol {STEP_GRAD_TOL_F32:g})")
    if reads["cuda"][0] > STEP_LOSS_TOL_F32 or reads["cuda"][1] > STEP_GRAD_TOL_F32 or not all(
            math.isfinite(v) for v in results["cuda"][0].values()):
        raise AssertionError(f"{name} f32 step disagrees with the CPU: {reads['cuda']}")
    if reads["control"][0] <= STEP_LOSS_TOL_F32 and reads["control"][1] <= STEP_GRAD_TOL_F32:
        raise AssertionError(f"{name}: the bf16 control stays within every f32 limit")
    return {"f32": reads["cuda"], "control": reads["control"]}


def classic_eval(name: str, config_path: Path, out_json: Path, expect) -> tuple:
    """ns-eval of a run: finite metrics including `expect`; (seconds,
    metrics)."""
    from nerfstudio_thermal_torch.scripts import eval as ns_eval

    t0 = time.perf_counter()
    if ns_eval.main(["--load-config", str(config_path), "--output-path", str(out_json)], device="cuda") != 0:
        raise AssertionError(f"ns-eval of the {name} run failed")
    scores = json.loads(out_json.read_text())["results"]
    if not all(math.isfinite(v) for v in scores.values()) or not set(expect) <= set(scores):
        raise AssertionError(f"ns-eval of the {name} run: {scores}")
    return time.perf_counter() - t0, scores


def classic_renders(name: str, model, c2w, smi: str) -> tuple:
    frames, launches = {}, {}
    for label in CLASSIC[name]["renders"]:
        dt, n_chunks, counts = classic_render(model, name, label, c2w)
        frames[label], launches[label] = dt, counts
        log(f"{name} render {label}: {n_chunks} chunks of {model.config.eval_num_rays_per_chunk} rays, launches "
            f"{CLASSIC[name]['chunk'] or 'none'} a chunk, outputs finite; {dt:.3f} s/frame ({smi})")
    return frames, launches


def train_line(name: str, run: dict, smi: str, extra: str = "") -> str:
    rays = run["trainer"].datamanager.config.train_num_rays_per_batch
    recs = run["records"]
    return (f"{name} train: {CLASSIC_STEPS} steps of {rays} rays through ns-train, every loss finite, every "
            f"param group changed, launches {dict((k, v) for k, v in run['counts'].items() if v) or 'none'}; "
            f"steps {CLASSIC_TIMED_FROM}-{CLASSIC_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, "
            f"{rays / run['step_s']:,.0f} rays/s, peak memory {run['peak'] / 2**30:.2f} GiB; loss "
            f"{recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}{extra} ({smi})")


def classic_phase(tmp: Path, smi: str) -> dict:
    """Phase 16: vanilla-nerf, mipnerf, tensorf and depth-nerfacto (see the
    comment above CLASSIC_STEPS). Returns each method's records, and rows
    1-2 on the NeRF stacks ("stacks") and rows 7-10 on depth-nerfacto's
    points ("depth_hash")."""
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    result = {"stacks": nerf_stack_phase()}
    t0 = time.perf_counter()
    blender = write_classic_blender(tmp / "blender")
    depth_scene = write_depth_scene(tmp / "depth")
    log(f"scenes: blender {BLENDER_FRAMES} x {BLENDER_SIZE}x{BLENDER_SIZE}, depth sphere {DEPTH_FRAMES} x 640x480 "
        f"with 16-bit depth PNGs (mm), written in {time.perf_counter() - t0:.2f} s")

    for name in ("vanilla-nerf", "mipnerf"):
        sp = CLASSIC[name]
        # the default use_pallas=False runs the eager stacks: no kernel
        plain = classic_train(name, blender, tmp / name / "eager", [], {})
        plain_s, plain_peak = plain["step_s"], plain["peak"]
        del plain
        run = classic_train(name, blender, tmp / name / "fused", sp["flags"], sp["step"],
                            capture_step=CLASSIC_CAPTURE_STEP)
        calls = run.pop("mlp")
        run.pop("hash")
        if [c["x"].shape[1] for c in calls] != [NERF_STACKS[name]] * 2 or any(c["g"] is None for c in calls):
            raise AssertionError(f"{name} step {CLASSIC_CAPTURE_STEP}: recorded fused-MLP calls "
                                 f"{[(tuple(c['x'].shape), c['g'] is not None) for c in calls]}")
        log(train_line(name, run, smi, f"; eager (use_pallas off) {plain_s * 1e3:.2f} ms/step, peak "
                                      f"{plain_peak / 2**30:.2f} GiB, no launches"))
        model_sums = mlp_model_phase(f"{name} train step {CLASSIC_CAPTURE_STEP}", calls)
        del calls
        c2w = run["trainer"].datamanager.train_cameras.camera_to_worlds[0].numpy()
        rays = run["trainer"].datamanager.config.train_num_rays_per_batch
        del run["trainer"]
        torch.cuda.empty_cache()
        _, trainer = eval_setup(run["run"] / "config.yml", device="cuda")
        frames, render_launches = classic_renders(name, trainer.model, c2w, smi)
        del trainer
        torch.cuda.empty_cache()
        eval_s, scores = classic_eval(name, run["run"] / "config.yml", tmp / f"{name}.json", ("psnr_rgb", "ssim_rgb"))
        log(f"{name} ns-eval: {eval_s:.2f} s for {BLENDER_VAL} {BLENDER_SIZE}x{BLENDER_SIZE} eval images, psnr_rgb "
            f"{scores['psnr_rgb']:.3f}, ssim_rgb {scores['ssim_rgb']:.4f}")
        step_check = classic_step_vs_cpu(name, blender, tmp / name / "step")
        result[name] = {"step_s": run["step_s"], "eager_step_s": plain_s, "rays": rays, "peak": run["peak"],
                        "frames": frames, "render_launches": render_launches, "counts": run["counts"],
                        "model_train_step": model_sums, "eval_s": eval_s, **step_check}
        torch.cuda.empty_cache()

    name = "tensorf"
    schedule = {}

    def grids_grow(trainer, step, scalars):
        """After each upsample: the grids and their moments at the new
        resolution, the moments zero, the step count kept."""
        model = trainer.model
        if not schedule:
            schedule.update(model.resolution_schedule())
        if step not in schedule:
            return
        r, f = schedule[step], model.field
        opt = trainer.optimizers.groups["fields"]
        shapes = {k: tuple(getattr(f, k).shape) for k in ("density_planes", "density_lines", "color_planes",
                                                           "color_lines")}
        moments = [(m, p) for m, p in zip(opt.mu, opt.params) if p.dim() in (3, 4)]
        if (f.resolution != r or shapes["density_planes"][1:3] != (r, r) or shapes["color_lines"][1] != r
                or any(m.shape != p.shape or bool(m.any()) for m, p in moments) or opt.count != step + 1):
            raise AssertionError(f"tensorf after step {step}: resolution {f.resolution}, grids {shapes}, count "
                                 f"{opt.count}; expected {r} with zero moments and count {step + 1}")
        log(f"tensorf step {step}: grids upsampled to {r}^2 ({shapes}), their Adam moments zero, count {opt.count}")

    run = classic_train(name, blender, tmp / name, CLASSIC[name]["flags"], {}, on_step=grids_grow)
    if sorted(schedule) != list(TENSORF_UPSAMPLES) or schedule[TENSORF_UPSAMPLES[-1]] != 300:
        raise AssertionError(f"tensorf's schedule {schedule}")
    log(train_line(name, run, smi, f"; grids {sorted(schedule.values())} after steps {sorted(schedule)}, every "
                                  "later step finite"))
    trainer = run.pop("trainer")
    rays = trainer.datamanager.config.train_num_rays_per_batch
    frames, render_launches = classic_renders(name, trainer.model, trainer.datamanager.train_cameras
                                              .camera_to_worlds[0].numpy(), smi)
    del trainer
    torch.cuda.empty_cache()
    # the run's checkpoint holds 300^2 grids; as in JAX the reload builds the
    # field at the config's 128 and the first evaluation raises
    try:
        classic_eval(name, run["run"] / "config.yml", tmp / "tensorf.json", ())
    except ValueError as e:
        if "density_planes" not in str(e) or "resolution 128" not in str(e):
            raise
        log(f"tensorf ns-eval of the upsampled run raises, as the JAX package's first apply does: {e}")
    else:
        raise AssertionError("tensorf: ns-eval reloaded a run with upsampled grids")
    result[name] = {"step_s": run["step_s"], "rays": rays, "peak": run["peak"], "frames": frames,
                    "render_launches": render_launches, "schedule": schedule}
    torch.cuda.empty_cache()

    name = "depth-nerfacto"
    depth_losses = []
    run = classic_train(name, depth_scene, tmp / name, CLASSIC[name]["flags"], None,
                        capture_step=CLASSIC_CAPTURE_STEP,
                        on_step=lambda tr, step, s: depth_losses.append((s.get("depth_loss"), s.get("depth_mae"))))
    if any(d is None or not math.isfinite(d) or m is None or not math.isfinite(m) for d, m in depth_losses):
        raise AssertionError(f"depth-nerfacto: depth_loss / depth_mae missing or not finite: {depth_losses}")
    run.pop("mlp")
    calls = run.pop("hash")
    if len(calls) != 3 or any(rec["g"] is None for rec in calls):
        raise AssertionError(f"depth-nerfacto step {CLASSIC_CAPTURE_STEP}: {len(calls)} hash calls")
    HASH_MODEL_CALLS[f"depth-nerfacto train step {CLASSIC_CAPTURE_STEP}"] = calls
    events = [json.loads(line) for line in (run["run"] / "events.jsonl").read_text().splitlines()]
    eval_mae = [e["eval/eval_depth_mae"] for e in events if "eval/eval_depth_mae" in e]
    if len(eval_mae) < 2 or not all(math.isfinite(v) for v in eval_mae):
        raise AssertionError(f"depth-nerfacto: eval batches' depth_mae {eval_mae}")
    log(train_line(name, run, smi, f"; depth_loss {depth_losses[0][0]:.4g} -> {depth_losses[-1][0]:.4g}, depth_mae "
                                  f"{depth_losses[0][1]:.4f} -> {depth_losses[-1][1]:.4f} (train), eval batches "
                                  f"{[round(v, 4) for v in eval_mae]}"))
    c2w = run["trainer"].datamanager.train_cameras.camera_to_worlds[0].numpy()
    rays = run["trainer"].datamanager.config.train_num_rays_per_batch
    del run["trainer"]
    torch.cuda.empty_cache()
    _, trainer = eval_setup(run["run"] / "config.yml", device="cuda")
    frames, render_launches = classic_renders(name, trainer.model, c2w, smi)
    del trainer
    torch.cuda.empty_cache()
    eval_s, scores = classic_eval(name, run["run"] / "config.yml", tmp / "depth.json", ("psnr_rgb",))
    log(f"depth-nerfacto ns-eval: {eval_s:.2f} s, psnr_rgb {scores['psnr_rgb']:.3f}")
    result[name] = {"step_s": run["step_s"], "rays": rays, "peak": run["peak"], "frames": frames,
                    "render_launches": render_launches, "counts": run["counts"], "eval_s": eval_s}
    result["depth_hash"] = hash_model_phase({k: v for k, v in HASH_MODEL_CALLS.items() if k.startswith(name)})
    HASH_MODEL_CALLS.clear()
    torch.cuda.empty_cache()
    log(f"phase 16 vanilla-nerf, mipnerf, tensorf, depth-nerfacto: {time.perf_counter() - t_phase:.1f} s")
    return result


def profile_step(trainer, out_dir: Path, tag: str) -> None:
    """torch.profiler over one training step: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    step = trainer.state.step
    trainer.train_iteration(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_iteration(step + 1)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    path = out_dir / f"{tag}_train_step_profile.txt"
    path.write_text(table)
    log(f"profile of one {tag} training step written to {path}")


def profile_chunk(model, cam, out_dir: Path, tag: str) -> None:
    """torch.profiler over one chunk of 512x64 rays: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    width = model.config.eval_num_rays_per_chunk // 64
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.render_camera_device(cam, 0, width=width, height=64)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = out_dir / f"{tag}_chunk_profile.txt"
    path.write_text(table)
    log(f"profile of one {tag} {width}x64 chunk written to {path}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None,
                        help="write profiler tables of one render chunk and one training step here")
    args = parser.parse_args()

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import nerfstudio_thermal_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    from nerfstudio_thermal_torch.ops.cuda import build
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)

    for name, (path, seconds, build_log) in build.build().items():
        regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
        log(f"build {path.name}: {seconds:.2f} s; " + "; ".join(regs))
    for kind in ("fwd", "bwd"):
        fm.load_library(kind)
        fr.load_library(kind)
    th.load_library()
    sass_check()

    fwd_kernel = kernel_phase()
    bwd_kernel = backward_phase()
    hash_kernels = hash_kernel_phase()
    ray_kernels = ray_kernel_phase()
    field_kernels = field_kernel_phase()
    renders = {m: slice_phase(m) for m in METHODS}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = write_scene(Path(tmp) / "sphere")
        log(f"scene: 8 RGB 640x480 + 8 thermal 640x512 frames written in {time.perf_counter() - t0:.2f} s")
        trains = {m: train_phase(m, scene, Path(tmp) / m / "run") for m in METHODS}
        hash_model = hash_model_phase()
        HASH_MODEL_CALLS.clear()
        torch.cuda.empty_cache()
        for m in METHODS:
            step_vs_cpu_phase(m, scene, Path(tmp) / m / "step")
        f32_steps = {}
        for m, freqs in (("thermal-nerfacto-tpu", 10), ("thermal-nerfacto-tpu+fused", 10),
                         ("thermal-nerfacto-tpu", F32_CHECK_FREQS)):
            f32_steps[(m, freqs)] = step_vs_cpu_phase(m, scene, Path(tmp) / m / f"step_f32_{freqs}", f32_freqs=freqs)
        for line in stage_lines():
            log(line)
        field_split_phase()
        t0 = time.perf_counter()
        entry_scene = write_scene(Path(tmp) / "sphere_eval", num_pairs=ENTRY_PAIRS)
        log(f"scene: {ENTRY_PAIRS} RGB 640x480 + {ENTRY_PAIRS} thermal 640x512 frames written in "
            f"{time.perf_counter() - t0:.2f} s (1 + 1 held out for eval)")
        entries = {m: entry_points_phase(m, entry_scene, Path(tmp) / m / "outputs") for m in METHODS}
        # phase 13: the rest of thermal-nerfacto's config surface and the nerfacto family
        tv_points = tv_points_phase()
        t0 = time.perf_counter()
        rgb_scene = write_scene(Path(tmp) / "sphere_rgb", thermal=False)
        log(f"scene: 8 RGB 640x480 frames, Nerfstudio layout, written in {time.perf_counter() - t0:.2f} s")
        surface = {m: surface_phase(m, scene if sp["scene"] == "rgbt" else rgb_scene, Path(tmp) / m / "run")
                   for m, sp in SURFACE.items()}
        surface_hash = hash_model_phase({k: v for k, v in HASH_MODEL_CALLS.items() if k.endswith(" train step")})
        HASH_MODEL_CALLS.clear()
        torch.cuda.empty_cache()
        step_vs_cpu_phase("thermal-nerfacto-tpu+fused:shared", scene, Path(tmp) / "shared_fused" / "step_f32",
                          f32_freqs=10)
        # rgb_only's f32 step on thermal-nerfacto-tpu: on the hash method the
        # f32 step reads losses within 6e-7, but its bf16 control stays
        # within the 4e-4 loss limit too (3.3e-4), so that limit cannot tell
        # the two paths apart there
        step_vs_cpu_phase("thermal-nerfacto-tpu:rgb_only", scene, Path(tmp) / "rgb_only" / "step_f32",
                          f32_freqs=F32_CHECK_FREQS)
        surface_entry_phase(entry_scene, Path(tmp) / "surface_entry")
        # phase 14: the render surface (ns-render, camera types), fused_modalities and the profiler
        render_surface = render_surface_phase(entries, scene, Path(tmp) / "render_surface", smi)
        # phase 15: the data path (JPEG, parsers) and the instant-ngp family
        image_io = image_io_phase(smi)
        data_scenes = parsers_phase(Path(tmp) / "parsers")
        ngp_scene = write_scene(Path(tmp) / "sphere_ngp", num_pairs=NGP_PAIRS, thermal=False)
        ngp = ngp_phase(ngp_scene, data_scenes["instant-ngp-data"], Path(tmp) / "ngp", smi)
        ngp_hash = hash_model_phase({k: v for k, v in HASH_MODEL_CALLS.items() if k.startswith("instant-ngp")})
        HASH_MODEL_CALLS.clear()
        torch.cuda.empty_cache()
        # phase 16: vanilla-nerf, mipnerf, tensorf and depth-nerfacto
        classic = classic_phase(Path(tmp) / "classic", smi)
        if args.profile is not None:
            # after every timed phase: a profiler session slows the host ops
            # that follow it
            for m in METHODS:
                renders[m][2](Path(args.profile))
                trains[m][3](Path(args.profile))

    tpu_counts, hash_counts = trains["thermal-nerfacto-tpu"][0], trains["thermal-nerfacto"][0]
    fused_counts = trains["thermal-nerfacto-tpu+fused"][0]
    # rows 3 and 4's launches by stack: the cross densities' and each proposal's
    fused_stacks = trains["thermal-nerfacto-tpu+fused"][4]
    for way in ("fwd", "bwd"):
        recs = ray_kernels[f"fused_ray_mlp_{way}"]
        if set(fused_stacks[way]) != {rec["stack"] for rec in recs.values()}:
            raise AssertionError(f"fused training ran the ray {way} on stacks {sorted(fused_stacks[way])}, "
                                 f"not on those of {sorted(recs)}")
    ray_fwd, ray_bwd = ray_kernels["fused_ray_mlp_fwd"], ray_kernels["fused_ray_mlp_bwd"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def hash_entry(kname):
        """A hash kernel's fields: the uniform base case's, and as extra
        fields its sums on the model's own positions (model_render_chunk:
        the forward; model_train_step: all three)."""
        model = {f"model_{scope}": sums[kname] for scope, sums in hash_model.items() if kname in sums}
        return {**{k: hash_kernels[kname][k] for k in keys}, **model}

    pallas = "nerfstudio_thermal_tpu/ops/pallas/"
    hash_source = "nerfstudio_thermal_torch/csrc/hash_encoding.cu"
    ray_fwd_source = "nerfstudio_thermal_torch/csrc/fused_ray_fwd.cu"
    ray_bwd_source = "nerfstudio_thermal_torch/csrc/fused_ray_bwd.cu"
    kernels = [
        {"name": "fused_mlp_fwd", "route": "cuda", "source": "nerfstudio_thermal_torch/csrc/fused_mlp_fwd.cu",
         "replaces": pallas + "fused_mlp.py:318 (row 1)", "launches": tpu_counts["fused_mlp_fwd"],
         **{k: fwd_kernel["base_8x256_skip4_bf16"][k] for k in keys}},
        {"name": "fused_mlp_bwd", "route": "cuda", "source": "nerfstudio_thermal_torch/csrc/fused_mlp_bwd.cu",
         "replaces": pallas + "fused_mlp.py:413 (row 2)", "launches": tpu_counts["fused_mlp_bwd"],
         **{k: bwd_kernel["base_8x256_skip4_bf16"][k] for k in keys}},
        {"name": "hash_encode_fwd", "route": "cuda", "source": hash_source,
         "replaces": pallas + "hash_encoding.py:103 (row 8; also the XLA row-gather forward of row 7, "
                     "hash_gather.py:229)",
         "launches": hash_counts["hash_encode_fwd"], **hash_entry("hash_encode_fwd")},
        {"name": "hash_encode_bwd_table", "route": "cuda", "source": hash_source,
         "replaces": pallas + "hash_gather.py:100 (row 7), " + pallas + "hash_encoding.py:123 (row 9)",
         "launches": hash_counts["hash_encode_bwd_table"],
         **hash_entry("hash_encode_bwd_table")},
        {"name": "hash_encode_bwd_pos", "route": "cuda", "source": hash_source,
         "replaces": pallas + "hash_encoding.py:145 (row 10)", "launches": hash_counts["hash_encode_bwd_pos"],
         **hash_entry("hash_encode_bwd_pos")},
        # row 3 at its three main-path shapes, each with the launches of its
        # stack: the cross densities (8 x 256, the wgmma kernel) and the two
        # proposal stacks (3 x 64, the one-pass narrow kernel)
        *({"name": "fused_ray_mlp_fwd" + ("" if case == "cross_density" else f"_{case}"), "route": "cuda",
           "source": ray_fwd_source,
           "replaces": pallas + f"fused_mlp.py:774 (row 3: fused_ray_mlp -> _ray_fwd_kernel; {case})",
           "launches": fused_stacks["fwd"][ray_fwd[case]["stack"]], **{k: ray_fwd[case][k] for k in keys}}
          for case in ("cross_density", "proposal_0", "proposal_1")),
        # row 4 at its three main-path shapes, each with the launches of its
        # stack: the cross densities (8 x 256, input gradients) and the two
        # proposal stacks (3 x 64, none)
        *({"name": "fused_ray_mlp_bwd" + ("" if case == "cross_density" else f"_{case}"), "route": "cuda",
           "source": ray_bwd_source,
           "replaces": pallas + f"fused_mlp.py:797 (row 4: _fused_ray_bwd -> _ray_bwd_kernel; {case})",
           "launches": fused_stacks["bwd"][ray_bwd[case]["stack"]], **{k: ray_bwd[case][k] for k in keys}}
          for case in ("cross_density", "proposal_0", "proposal_1")),
        {"name": "fused_field_mlp_fwd", "route": "cuda", "source": ray_fwd_source,
         "replaces": pallas + "fused_mlp.py:1160 (row 5: fused_field_mlp -> _field_fwd_kernel)",
         "launches": fused_counts["fused_field_mlp_fwd"],
         **{k: field_kernels["fused_field_mlp_fwd"][3][k] for k in keys + ("ms_render",)},
         "c4": {k: field_kernels["fused_field_mlp_fwd"][4][k] for k in keys + ("ms_render",)}},
        {"name": "fused_field_mlp_bwd", "route": "cuda", "source": ray_bwd_source,
         "replaces": pallas + "fused_mlp.py:1185 (row 6: _fused_field_bwd -> _field_bwd_kernel)",
         "launches": fused_counts["fused_field_mlp_bwd"],
         **{k: field_kernels["fused_field_mlp_bwd"][3][k] for k in keys},
         "c4": {k: field_kernels["fused_field_mlp_bwd"][4][k] for k in keys}},
    ]
    # rows 1-6 at f32 compute: the exact-f32 kernels (csrc/fused_mlp_f32.cuh),
    # each with its launches in phase 9's f32 card steps at 10 frequencies
    # (thermal-nerfacto-tpu: rows 1-2; +fused: rows 3-6) and its other timed
    # shapes as extra fields
    tpu32, fused32 = f32_steps[("thermal-nerfacto-tpu", 10)], f32_steps[("thermal-nerfacto-tpu+fused", 10)]
    f32_note = " at f32 compute: the exact-f32 kernel"
    kernels += [
        {"name": "fused_mlp_fwd_f32", "route": "cuda", "source": "nerfstudio_thermal_torch/csrc/fused_mlp_fwd.cu",
         "replaces": pallas + "fused_mlp.py:318 (row 1" + f32_note + ")", "launches": tpu32["fused_mlp_fwd_f32_path"],
         **{k: fwd_kernel["base_f32"][k] for k in keys},
         **{case: {k: fwd_kernel[case][k] for k in keys + ("n",)}
            for case in ("proposal_f5_3x64_f32", "colour_head_3x64_f32")}},
        {"name": "fused_mlp_bwd_f32", "route": "cuda", "source": "nerfstudio_thermal_torch/csrc/fused_mlp_bwd.cu",
         "replaces": pallas + "fused_mlp.py:413 (row 2" + f32_note + ")", "launches": tpu32["fused_mlp_bwd"],
         **{k: bwd_kernel["base_f32"][k] for k in keys + ("workspace_bytes", "scratch_bytes")},
         **{case: {k: bwd_kernel[case][k] for k in keys + ("n",)}
            for case in ("proposal_f5_3x64_f32", "colour_head_3x64_f32")}},
        {"name": "fused_ray_mlp_fwd_f32", "route": "cuda", "source": ray_fwd_source,
         "replaces": pallas + "fused_mlp.py:774 (row 3" + f32_note + ")", "launches": fused32["fused_ray_mlp_fwd"],
         **{k: ray_kernels["fused_ray_mlp_fwd_f32"]["cross_density"][k] for k in keys},
         **{case: {k: ray_kernels["fused_ray_mlp_fwd_f32"][case][k] for k in keys + ("n",)}
            for case in ("proposal_0", "proposal_1")}},
        {"name": "fused_ray_mlp_bwd_f32", "route": "cuda", "source": ray_bwd_source,
         "replaces": pallas + "fused_mlp.py:797 (row 4" + f32_note + ")", "launches": fused32["fused_ray_mlp_bwd"],
         **{k: ray_kernels["fused_ray_mlp_bwd_f32"]["cross_density"][k] for k in keys},
         **{case: {k: ray_kernels["fused_ray_mlp_bwd_f32"][case][k] for k in keys + ("n",)}
            for case in ("proposal_0", "proposal_1")}},
        {"name": "fused_field_mlp_fwd_f32", "route": "cuda", "source": ray_fwd_source,
         "replaces": pallas + "fused_mlp.py:1160 (row 5" + f32_note + ")", "launches": fused32["fused_field_mlp_fwd"],
         **{k: field_kernels["fused_field_mlp_fwd_f32"][3][k] for k in keys + ("ms_render",)},
         **{f"c{c}": {k: field_kernels["fused_field_mlp_fwd_f32"][c][k] for k in keys + ("ms_render",)} for c in (1, 4)}},
        {"name": "fused_field_mlp_bwd_f32", "route": "cuda", "source": ray_bwd_source,
         "replaces": pallas + "fused_mlp.py:1185 (row 6" + f32_note + ")", "launches": fused32["fused_field_mlp_bwd"],
         **{k: field_kernels["fused_field_mlp_bwd_f32"][3][k] for k in keys},
         **{f"c{c}": {k: field_kernels["fused_field_mlp_bwd_f32"][c][k] for k in keys} for c in (1, 4)}},
    ]
    # phase 13's numbers as extra fields: rows 1-2 on the TV points, the
    # hash kernels on nerfacto-big's and nerfacto-huge's points, and each
    # kernel's launches in each configuration's run (training and renders)
    kernels[0]["tv_points"], kernels[1]["tv_points"] = tv_points["fwd"], tv_points["bwd"]
    for rec in kernels:
        name = rec["name"]
        for scope, sums in surface_hash.items():
            if name in sums:
                rec[f"model_{scope.replace(' ', '_')}"] = sums[name]
        counted = {m: r["launches"][name] for m, r in surface.items() if r["launches"].get(name)}
        if counted:
            rec["config_surface_launches"] = counted
        # phase 14: launches of the 1080p ns-render camera paths and of the fused_modalities runs
        for field, runs in (("ns_render_launches", render_surface["ns_render"]),
                            ("fused_modalities_launches", render_surface["fused_modalities"])):
            counted = {m: r["counts"][name] for m, r in runs.items() if r["counts"].get(name)}
            if counted:
                rec[field] = counted
        # phase 15: the hash kernels on instant-ngp's own points, and their
        # launches in its ns-train run, a 1080p render and the COLMAP run
        for scope, sums in ngp_hash.items():
            if name in sums:
                rec["model_" + scope.replace(" ", "_").replace("-", "_")] = sums[name]
        if name.startswith("hash_encode"):
            rec["instant_ngp_launches"] = {
                "train": ngp["instant-ngp"]["counts"][name],
                "per_step": ngp_step_counts(1).get(name, 0), "per_grid_update_step": ngp_step_counts(0).get(name, 0),
                "render_1080p": ngp["instant-ngp"]["render_launches"]["1080p"][name],
            }
            rec["nerfacto_colmap_launches"] = ngp["nerfacto:colmap"]["launches"].get(name, 0)
    # phase 16's numbers as extra fields: rows 1-2 on the NeRF stacks and on
    # vanilla-nerf's and mipnerf's own inputs, their launches in those runs;
    # rows 7-10 on depth-nerfacto's points and their launches
    for rec, way in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        rec["nerf_stacks"] = {tag: r for tag, r in classic["stacks"][way].items() if not tag.endswith("float32")}
        for m in NERF_STACKS:
            c = classic[m]
            rec["model_" + m.replace("-", "_") + "_train_step"] = c["model_train_step"][rec["name"]]
            rec[m.replace("-", "_") + "_launches"] = {
                "train": c["counts"][rec["name"]], "per_step": CLASSIC[m]["step"][rec["name"]],
                **{f"render_{k}": v[rec["name"]] for k, v in c["render_launches"].items()}}
    for rec in kernels:
        way = {"fused_mlp_fwd_f32": "fwd", "fused_mlp_bwd_f32": "bwd"}.get(rec["name"])
        if way:
            rec["nerf_stacks"] = {tag: r for tag, r in classic["stacks"][way].items() if tag.endswith("float32")}
    for rec in kernels:
        if rec["name"].startswith("hash_encode"):
            c = classic["depth-nerfacto"]
            sums = classic["depth_hash"].get(f"depth-nerfacto train step {CLASSIC_CAPTURE_STEP}", {})
            if rec["name"] in sums:
                rec["model_depth_nerfacto_train_step"] = sums[rec["name"]]
            rec["depth_nerfacto_launches"] = {
                "train": c["counts"][rec["name"]],
                **{f"render_{k}": v[rec["name"]] for k, v in c["render_launches"].items()}}
    for m in METHODS:
        counts, frame_s, _ = renders[m]
        _, step_s, rays, _, _, _ = trains[m]
        log(f"{m}: 1080p frame {frame_s:.3f} s, {1920 * 1080 / frame_s:,.0f} rays/s; "
            f"train {step_s * 1e3:.2f} ms/step, {rays / step_s:,.0f} rays/s ({smi})")
    for m, e in entries.items():
        log(f"{m}: ns-train {e['train_s'] / ENTRY_STEPS * 1e3:.1f} ms/step with evals on; ns-eval "
            f"{e['s_per_image']:.3f} s per eval image, {e['rays_per_sec']:,.0f} rays/s; ssim {e['ssim']:.3f} ms, "
            f"lpips {e['lpips']:.3f} ms per 640x480 image ({smi})")
    for m, r in surface.items():
        frames = ", ".join(f"{label} frame {dt:.3f} s" for label, dt in r["frames"].items())
        log(f"{m}: train {r['step_s'] * 1e3:.2f} ms/step (steps {SURFACE_TIMED_FROM}-{SURFACE_STEPS - 1}), "
            f"{r['rays'] / r['step_s']:,.0f} rays/s, peak memory {r['peak'] / 2**30:.2f} GiB; {frames} ({smi})")
    for m, r in render_surface["ns_render"].items():
        log(f"{m}: ns-render camera-path 1920x1080 {r['s_per_frame']:.3f} s per frame through the command (render "
            f"{r['render_s']:.3f} s, host {r['host_s']:.3f} s) ({smi})")
    for m, r in render_surface["fused_modalities"].items():
        log(f"{m}: train {r['step_s'] * 1e3:.2f} ms/step, unfused {r['unfused_step_s'] * 1e3:.2f} ms/step (means of "
            f"two runs each, in turns) ({smi})")
    log(f"thermal-nerfacto 1080p include_per_sample peak memory "
        f"{render_surface['camera_types']['per_sample_peak'] / 2**30:.2f} GiB (per-ray outputs only "
        f"{render_surface['camera_types']['per_ray_peak'] / 2**30:.2f} GiB) ({smi})")
    log(f"image_io: 1920x1080 JPEG decode {image_io['decode_ms']:.1f} ms, 0.5x resize {image_io['resize_ms']:.1f} ms "
        f"(host) ({smi})")
    r = ngp["instant-ngp"]
    log(f"instant-ngp: train {r['step_s'] * 1e3:.2f} ms/step at {r['rays']} rays ({r['rays'] / r['step_s']:,.0f} rays/s, "
        f"{r['live']:.2f} live samples a ray), batches {sorted(set(r['sizes']))}, peak memory {r['peak'] / 2**30:.2f} "
        f"GiB; " + ", ".join(f"{k} frame {v:.3f} s" for k, v in r["frames"].items()) + f" ({smi})")
    r = ngp["instant-ngp-bounded"]
    log(f"instant-ngp-bounded: train {r['step_s'] * 1e3:.2f} ms/step at {r['rays']} rays; 640x480 frame "
        f"{r['frame_s']:.3f} s ({smi})")
    r = ngp["nerfacto:colmap"]
    log(f"nerfacto on the COLMAP JPEG scene: train {r['step_s'] * 1e3:.2f} ms/step at {r['rays']} rays ({smi})")
    for m in CLASSIC:
        r = classic[m]
        frames = ", ".join(f"{label} frame {dt:.3f} s" for label, dt in r["frames"].items())
        extra = f" (eager {r['eager_step_s'] * 1e3:.2f} ms/step)" if "eager_step_s" in r else ""
        log(f"{m}: train {r['step_s'] * 1e3:.2f} ms/step at {r['rays']} rays{extra}, peak memory "
            f"{r['peak'] / 2**30:.2f} GiB; {frames} ({smi})")
    log(f"chip_smoke total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
