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
   - the JPEG and PNG fixtures of tests/data/jpeg decode (the port's
     decoders, the JPEG one built with g++; progressive JPEGs and an
     Adam7-interlaced PNG among them) to the Pillow hashes of their
     manifest, the CMYK one is refused; a 1920x1080 decode and its 0.5x
     BILINEAR resize are timed on the host, and a progressive 1920x1080
     decode against the baseline file of its pixels at the same quality;
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
17. neus, neus-facto and semantic-nerfw (after phase 16; the JSON line's
   hash_encode_bwd_pos_vjp entry and the hash kernels' extra fields
   model_neus_facto_train_step_9, neus_facto_launches and
   semantic_nerfw_launches read it):
   - neus-facto (2048 rays, (256, 96) + 48 samples, the 16-level 2^19 SDF
     grid to 2048, two 5-level proposal grids) trains 30 steps through
     ns-train on phase 15's RGB sphere scene: every loss finite, every
     group changed, each step's launches (rows 7-10 and the position
     gradient's VJP: 3 forwards, 3 table gradients, 2 position gradients,
     1 VJP); ms/step over steps 10-29, peak memory. The SDF's first-order
     gradient alone launches one forward and one position gradient and no
     table scatter, with and without create_graph;
   - step 9's VJP call (the SDF grid's, on the model's points) against its
     plain version (dg, d_table, d_pos2) and timed with plain and bound (no
     library call computes it), and step 9's three hash calls through
     phase 8b's checks and timings;
   - ns-eval of the run, a 640x512 frame (rgb, depth, normal, normal_vis;
     3 forwards and 1 position gradient a chunk), ns-render of the eval
     frame;
   - an f32 256-ray step on the card against the CPU's from the run's
     parameters (every loss, each group's gradient), and before it the
     eikonal loss alone: its SDF-grid table gradient, which only the
     second derivative reaches, must match the CPU's plain path and not be
     zero (its norm's ratio to the full step's printed);
   - neus (1024 rays, 64 + 4 x 16 samples, 8 x 256 SDF net, background
     NeRFField) 12 steps through ns-train and a 640x512 frame;
   - semantic-nerfw 12 steps on a Sitcoms3D-format scene the script writes
     with semantic labels (semantics_loss finite every step) and a 640x512
     frame whose semantics_colormap holds class colours only;
   - neus-facto 6 steps on an sdfstudio-format scene with the sphere's
     analytic depth and normals as monocular priors (normal_loss and
     depth_loss finite every step).
18. ns-export and ns-texture on the card (after phase 17; the JSON line's
   fused_mlp_fwd and hash kernels carry their launches as export_launches),
   through `scripts.exporter.main` and `scripts.texture.main` with the
   default device, each command's launches counted by kernel:
   - neus-facto (phase 17's run): marching-cubes of its SDF at 128 and at
     256, each exactly one row-8 forward a z-slab (ceil(R / max(1, 262144 //
     R^2))) and no other launch; one 256-slab's SDF on the card against the
     CPU's plain path (EXPORT_SDF_TOL); the PLY reads back with V > 0,
     F > 0, every face index below V and unit normals; then ns-texture of
     the 128 mesh (rows 8 and 10 a render chunk of the bake's rays);
   - thermal-nerfacto (phase 11's run): pointcloud --use-thermal-color true
     (non-empty, colours in [0, 1]), tsdf, poisson, texture and cameras
     (cameras.json equals the train cameras), each launching row 8 only
     (8 a render chunk, 1 a grid slab); one eval camera's point cloud at
     1/16 resolution on the card against the CPU's plain path (the rays
     whose accumulation lies within EXPORT_ACC_EPS of the threshold are
     counted and printed, and only they may fall on the other side), the
     TSDF volume of the card's own depth maps against the CPU's update of
     the same maps, and the Poisson indicator (cuFFT) against the CPU's
     solve of the same splat;
   - thermal-nerfacto-tpu (phase 11's run): marching-cubes through row 1
     (one fused-MLP forward a slab);
   - per export: seconds, split into setup (eval_setup), card (renders,
     grid evaluation, TSDF update and Poisson solve, synchronised) and
     host (the rest: marching cubes, splats, PLY / OBJ / PNG writes),
     vertex, face and point counts, and the card's name and power limit.

19. splatfacto and generfacto (after phase 18; the JSON line's hash
   kernels carry generfacto's launches and step-9 sums as extra fields):
   - 19a, splatfacto at the method's defaults (300,000 slots, 50,000
     random gaussians, SH degree 3, 16 x 16 tiles of capacity 512, window
     4, random background) on phase 15's RGB sphere scene: 30 steps
     through ns-train (every loss finite, every group changed, no kernel
     launch; ms/step over steps 10-29, peak memory); a step split on the
     device's timeline (binning, forward, losses, backward, Adam) with its
     wall and busy time; the splat ops (binning, the tile compositing
     forward and forward + backward) timed at 640x480 and 1080p beside
     their bounds; 640x512 and 1080p frames; a 320x256 frame card against
     CPU (SPLAT_FRAME_TOL); tiles against scan and the scan's two-pass
     backward against autograd of the plain scan on the card; ns-eval,
     ns-render of a 3-frame camera path and ns-export gaussian-splat
     (vertices = the alive count); then a 16-step run with refinements at
     steps 5, 10 and 15 and an opacity reset, each checked against the
     CPU's refinement of the same state (the alive mask, parameters
     within SPLAT_REFINE_TOL, the moments, zero in the touched rows);
   - 19b, generfacto at the JAX config's widths (64 x 64, (256, 96) + 48
     samples, the field L12 T 2^19, proposals L5 T 2^17, f32, ColorMatch):
     30 steps through ns-train without --data (launches a step: 3 hash
     forwards, 3 table gradients, 1 position gradient, 1 VJP), a profiled
     step by kernel, step 9's hash calls and VJP through phases 8b's and
     17's checks and timings, a step with the normals and shading on,
     card against CPU with the draws given (phase 9's f32 limits), and
     ns-render of the 8 eval-ring cameras (3 forwards and 1 position
     gradient a frame).

20. the web viewer (after phase 19), on phase 11's runs of
   thermal-nerfacto, thermal-nerfacto-tpu and thermal-nerfacto-tpu+fused:
   - 20a, ns-viewer (`scripts.viewer.serve`, as ns-viewer-torch runs it)
     driven over the port's own websocket client: the outputs greeting
     (the probed names), the whole ladder of a 16:9 camera at width 1920
     (256, 512, 1024, 1920, `final` on the last), each frame byte-equal to
     the JPEG (`encode_jpeg`) of `make_model_render_fn`'s direct render of
     its camera on the card, a second and a third camera that drop the
     second's refinements, a split view and a depth colormap (each equal to
     its direct render), a point cloud export and a saved camera path;
     every viewer render's launches must be the method's per-chunk
     launches times its chunks (rows 8; 1; 3 and 5), counted from 0 over
     the phase; per bucket: render ms (the server's), encode ms and the
     launches, and the time from the camera message to the first frame;
   - 20b, ns-train thermal-nerfacto --vis viewer for 20 steps: a client
     pauses (the step holds), grants one step, renders the 512 ladder while
     paused, resumes, and reads train_stats to the end; every loss finite;
   - 20c, encode_jpeg of a 1920x1080 render on the host, in ms.

21. data-parallel training of every method and multi-scene training
   (after phase 20; the JSON line's rows 1-2 and 7-10 and the VJP carry
   their launches per rank-step as
   data_parallel_launches_per_rank_step, rows 7-10 the two-scene run's as
   multi_scene_launches):
   - 21a, thermal-nerfacto and thermal-nerfacto-tpu at full width (8192
     rays) for 10 steps plain and in a one-rank NCCL group (the
     data-parallel path: shard, contributions, gradient and scalar
     all-reduces): step 0's loss bitwise the plain step's, its scalars
     and every later step's losses within phase 9's loss limit, the same
     launches; ms/step of both, peak memory, gradient bytes;
   - 21b, two gloo ranks sharing the card (this script with --dp-rank, a
     process each, with a timeout), 4096 rays each of the global 8192,
     against 21a's plain runs; rank 0 launches what
     the plain run does, rank 1 on thermal-nerfacto-tpu two base-MLP
     forwards and backwards a step fewer (the cross-density prefix of
     2048 rays lies in rank 0's rows); step 0's scalars and the later
     steps' total loss within phase 9's limit; ms/step of each rank, the
     gradient all-reduce's ms a step and its bytes;
   - 21c, `scripts.train.main` (ns-train) thermal-nerfacto --data A,B for
     20 steps on two 10 + 10 frame scenes: every scalar finite, scene 0's
     step-0 scalars and later total losses within phase 9's limit of
     ns-train --data A's (step 0's loss bitwise), twice the one-scene
     run's launches, ns-eval of each
     scene's run; ms a step of both scenes against the one-scene run's;
   - 21d, every other method (DP_METHODS: the nerfacto family,
     depth-nerfacto, semantic-nerfw, instant-ngp and -bounded,
     vanilla-nerf and mipnerf with use_pallas, tensorf, neus, neus-facto,
     splatfacto, generfacto) at its ns-train defaults on an earlier
     phase's scene, 3 steps plain and in a one-rank NCCL group: step 0's
     loss bitwise, the rest within phase 9's limit, the same launches,
     each kernel of DP_KERNELS launched; ms/step of both; then nerfacto
     and splatfacto (the replicated whole-image step) in 21b's two gloo
     ranks at f32 compute against plain runs, the ranks' parameters
     equal after 3 steps; their launches per rank-step join
     data_parallel_launches_per_rank_step.
22. ns-benchmark (`scripts.benchmarking.main`, on the card): full-width
   nerfacto with the reference's Blender benchmark overrides trains
   BENCH_STEPS steps on phase 16's 800 x 800 blender scene (laid out as
   blender/lego by a symlink) and ns-eval scores its val images, under the
   smoke's temporary directory. rc 0, benchmark.json's scene record equal
   to ns-eval's JSON, a finite mean PSNR, every training loss finite, and
   the hash kernels' launches in ns-train and in ns-eval (counts zeroed
   just before each) equal to `benchmark_expected`'s prediction from the
   code: row 8 and rows 7/9 as the proposal schedule runs them, row 10
   none; a `benchmark` line with the seconds of each, ms/step, the PSNR
   and the launches; the hash kernels' JSON records carry them as
   ns_benchmark_launches.

--profile DIR additionally writes torch.profiler tables of one 1080p chunk
and of one training step of each method to DIR. Exits non-zero without
CUDA; imports nothing of JAX.
"""

import argparse
import asyncio
import collections
import contextlib
import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
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
        "hash_encode_bwd_pos_vjp": (th.hash_encode_bwd_pos_vjp, "launches"),
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
               "scal": scalings.detach(), "t": table_size, "dtype": compute_dtype, "g": None,
               "with_pos": positions.requires_grad}
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
    card draws them again from the same generator state, in the samplers'
    `_uniforms`). Raises unless
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
    """The JPEG and PNG fixtures against their manifest (progressive JPEGs
    and the Adam7 PNG included), the CMYK one raises; host times of a
    1920x1080 decode and of its 0.5x resize, and of a progressive 1920x1080
    decode against the baseline file of the same pixels and quality (the
    port's encoder writes it from the progressive file's decode), medians
    of 5."""
    import hashlib

    from nerfstudio_thermal_torch.data import jpeg
    from nerfstudio_thermal_torch.data.datasets import read_image_array, resize_like_pil

    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    manifest = json.loads((JPEG_DIR / "manifest.json").read_text())
    checked, refused, kinds = 0, [], set()
    for name, rec in sorted(manifest.items()):
        if rec.get("port_raises"):
            try:
                jpeg.decode_jpeg(JPEG_DIR / name)
            except NotImplementedError as e:
                refused.append(f"{name}: {str(e).split(': ', 1)[-1]}")
                continue
            raise AssertionError(f"{name} decoded; the decoder must refuse it")
        arr = read_image_array(JPEG_DIR / name)
        if hashlib.sha256(arr.tobytes()).hexdigest() != rec["sha256"] or list(arr.shape) != rec["shape"]:
            raise AssertionError(f"{name}: the decode does not match Pillow's ({arr.shape}, manifest {rec['shape']})")
        data = (JPEG_DIR / name).read_bytes()
        # SOF2 (0xFF 0xC2 is a marker only: coded data stuffs every 0xFF); IHDR's interlace byte
        kinds.add("progressive" if b"\xff\xc2" in data else "interlaced" if name.endswith(".png") and data[28] else
                  "other")
        checked += 1
    if not refused:
        raise AssertionError("no fixture exercised the decoder's refusal")
    if not {"progressive", "interlaced"} <= kinds:
        raise AssertionError(f"no progressive JPEG or interlaced PNG among the fixtures ({sorted(kinds)})")

    def median_ms(fn) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3, out

    big = JPEG_DIR / "frame_1920x1080.jpg"
    decode_ms, arr = median_ms(lambda: jpeg.decode_jpeg(big))
    resize_ms, small = median_ms(lambda: resize_like_pil(arr, 960, 540))
    if small.shape != (540, 960, 3):
        raise AssertionError(f"resize gave {small.shape}")
    progressive = (JPEG_DIR / "progressive_1920x1080.jpg").read_bytes()
    prog_ms, prog = median_ms(lambda: jpeg.decode_jpeg_bytes(progressive))
    baseline = jpeg.encode_jpeg(prog, quality=90)
    twin_ms, twin = median_ms(lambda: jpeg.decode_jpeg_bytes(baseline))
    if prog.shape != (1080, 1920, 3) or twin.shape != prog.shape:
        raise AssertionError(f"progressive decode {prog.shape}, baseline twin {twin.shape}")
    log(f"image_io: decoder built in {build_s:.2f} s; {checked} JPEG / PNG fixtures (progressive and Adam7 "
        f"included) decode to their manifest's Pillow hashes; refused: {'; '.join(refused)}; 1920x1080 decode "
        f"{decode_ms:.1f} ms, 0.5x BILINEAR resize {resize_ms:.1f} ms; progressive 1920x1080 decode {prog_ms:.1f} "
        f"ms ({len(progressive)} bytes) against {twin_ms:.1f} ms for the baseline file of its pixels at the same "
        f"quality ({len(baseline)} bytes) (host, medians of 5) ({smi})")
    return {"decode_ms": decode_ms, "resize_ms": resize_ms, "fixtures": checked, "progressive_ms": prog_ms,
            "baseline_twin_ms": twin_ms}


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
                  capture_step=None, on_step=None, timed_from: int = CLASSIC_TIMED_FROM) -> dict:
    """ns-train of `name` at full width for `steps` steps, each synchronized
    and timed (from step `timed_from`), with its launches (`per_step`, or
    with None nerfacto's, by proposal_updated), every loss finite, every
    param group changed. capture_step: that step's fused-MLP, hash and
    hash-VJP calls are recorded for mlp_model_phase / hash_model_phase /
    vjp_model_phase. on_step(trainer, step, scalars) runs after each step.
    Returns the records, the run, the counts, the peak memory and the
    trainer."""
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
                with recording_mlp_calls() as mlp_calls, recording_hash_calls() as hash_calls, \
                        recording_vjp_calls() as vjp_calls:
                    out = iteration(step)
                torch.cuda.synchronize()
                captured.update(mlp=mlp_calls, hash=hash_calls, vjp=vjp_calls)
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

    data = ["--data", str(scene)] if scene is not None else []  # generfacto trains without data
    argv = [name, *data, "--output-dir", str(out_dir), "--experiment-name", "smoke",
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
    step_s = float(np.mean([r["s"] for r in records[timed_from:]]))
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


# Phase 17: the surface methods (neus, neus-facto) and semantic-nerfw. neus-facto
# trains SURF_STEPS steps through ns-train (timed from SURF_TIMED_FROM; its hash
# calls and the position gradient's VJP calls recorded at SURF_CAPTURE_STEP);
# neus and semantic-nerfw SURF_SHORT_STEPS (timed from SURF_SHORT_TIMED_FROM), the
# mono-prior neus-facto run MONO_STEPS. Launches a neus-facto training step: the
# two proposal grids' forward and table gradient (their positions need no
# gradient; the proposals update every step), the SDF grid's forward, the
# normals' position gradient (create_graph: the new node's forward is row 10),
# and in the backward the VJP of that position gradient (dg and d_table: the
# step differentiates the parameters only, so the detached sample positions,
# a leaf of the graph, get no gradient, no second row-10 launch and no
# d_pos2) and the SDF grid's table gradient; a render chunk: the three
# forwards and the normals' position gradient (no graph). neus runs no hash
# kernel (no grid; its background NeRFField runs eager, as in JAX).
SURF_STEPS, SURF_TIMED_FROM, SURF_CAPTURE_STEP = 30, 10, 9
SURF_SHORT_STEPS, SURF_SHORT_TIMED_FROM, MONO_STEPS = 12, 2, 6
SURF_RENDER = (640, 512, 500.0)
NEUS_FACTO_STEP = {"hash_encode_fwd": 3, "hash_encode_bwd_table": 3, "hash_encode_bwd_pos": 1,
                   "hash_encode_bwd_pos_vjp": 1}
NEUS_FACTO_CHUNK = {"hash_encode_fwd": 3, "hash_encode_bwd_pos": 1}
SEMANTIC_CHUNK = {"hash_encode_fwd": 3}
# The VJP kernel against its plain version: dg (the corners in the same
# order) and d_pos2 (the levels in another order) relative L2 1e-5, d_table
# (row 7's atomics) 1e-4.
VJP_TOLS = {"dg": 1e-5, "d_table": 1e-4, "d_pos2": 1e-5}
# The VJP's outputs (dg, d_table, d_pos2) a neus-facto step asks for, and all three.
VJP_STEP_OUTPUTS, VJP_ALL_OUTPUTS = (True, True, False), (True, True, True)
# The f32 neus-facto step, card against CPU (256 rays, the 30-step run's
# parameters): the same f32 functions in other orders, and the SDF's second
# derivative through softplus(100 x) / 100 scales a rounding by up to 100
# (the CPU step against JAX's reads up to ~1e-3, tests/
# test_torch_surface_models.py): losses 1e-3 relative, each group's gradient
# 5e-3 relative L2 (H100: losses 4.8e-7, groups <= 3.3e-6; the step's
# SDF-grid table gradient alone reads 5.9e-3, a few rays' final samples
# moving where an inverse-CDF lookup meets a flat step of the proposal
# weights). The eikonal loss alone, on the same final samples on both
# devices: its SDF-grid table gradient 1e-4 relative L2 (H100: 3.2e-6,
# the CPU against itself with every parameter one ulp away 2.5e-6); a
# dropped second derivative reads 1 (the gradient missing).
SURF_STEP_LOSS_TOL, SURF_STEP_GRAD_TOL, EIKONAL_TABLE_TOL = 1e-3, 5e-3, 1e-4


@contextlib.contextmanager
def recording_vjp_calls():
    """While open, every backward of the hash grid's position-gradient node
    (`_HashEncodeBwdPos`: the VJP kernel on the card) appends a record: the
    table, positions, g, the cotangent v, the scalings, T and which outputs
    it forms (dg, d_table, d_pos2). Positions, g and v are copied to the
    host. The backward computes and counts as before."""
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    calls, inner = [], th._HashEncodeBwdPos.backward

    def recorded(ctx, v):
        table, positions, g, scalings = ctx.saved_tensors
        calls.append({"table": table.detach(), "pos": positions.detach().float().cpu(), "g": g.detach().float().cpu(),
                      "v": v.detach().float().cpu(), "scal": scalings.detach(), "t": ctx.table_size,
                      "need": tuple(th._wanted(ctx, i) for i in (2, 0, 1))})
        return inner(ctx, v)

    th._HashEncodeBwdPos.backward = staticmethod(recorded)
    try:
        yield calls
    finally:
        th._HashEncodeBwdPos.backward = staticmethod(inner)


def vjp_cost(n: int, levels: int, t: int, rows: int, need) -> tuple:
    """Bytes the VJP must move (positions, v and g in; the rows its
    positions touch; dg, the dense d_table and d_pos2 out, as asked) and
    its f32 operations per (point, level): 15 for the corners and weights,
    then per corner 9 (a_c), 4 (dg), 2 (scatter) and 17 (d_pos2)."""
    need_g, need_table, need_pos = need
    nl = n * levels
    nbytes = n * 24 + nl * 8 + rows * 8 + need_g * nl * 8 + need_table * levels * t * 8 + need_pos * n * 12
    ops = nl * (15 + 8 * (9 + 4 * need_g + 2 * need_table + 17 * need_pos))
    return nbytes, ops


def vjp_model_phase(scope: str, calls) -> dict:
    """The VJP kernel on the calls a training step recorded, for the output
    set each call asked for and for all three outputs: each held against
    hash_encode_bwd_pos_vjp_plain (VJP_TOLS, dg bitwise) and timed with its
    plain version and its bound (no single PyTorch call computes it).
    Returns the sums over the calls of the asked-for set (and under
    "all_outputs" those of all three)."""
    from nerfstudio_thermal_torch.ops import encodings as enc
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    if not calls:
        raise AssertionError(f"{scope}: no VJP call recorded")
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
    sums = {k: 0.0 for k in keys}
    sums.update(cases=0, points=0, rows=0, all_outputs={k: 0.0 for k in keys})
    for i, rec in enumerate(calls):
        table, scal, t = rec["table"], rec["scal"], rec["t"]
        pos, g, v = (rec[k].to(table.device).contiguous() for k in ("pos", "g", "v"))
        n, levels = pos.shape[0], scal.shape[0]
        rows = hash_rows_touched(pos, scal, t)
        for need in dict.fromkeys((tuple(rec["need"]), VJP_ALL_OUTPUTS)):
            into = sums if need == tuple(rec["need"]) else sums["all_outputs"]
            kernel = lambda: th.hash_encode_bwd_pos_vjp(table, pos, g, v, scal, t, *need)  # noqa: E731
            plain = lambda: enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t, *need)  # noqa: E731
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            errs, max_err = [], 0.0
            for name, a, b in zip(("dg", "d_table", "d_pos2"), got, want):
                if (a is None) != (b is None):
                    raise AssertionError(f"{scope}[{i}] VJP: {name} formed by one side only")
                if a is None:
                    continue
                if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{scope}[{i}] VJP {name}: shape {tuple(a.shape)} or not finite")
                err, rel = float((a - b).abs().max()), rel_l2(a, b)
                if rel > VJP_TOLS[name] or (name == "dg" and err != 0.0):
                    raise AssertionError(f"{scope}[{i}] VJP {name} disagrees with its plain version: max |err| "
                                         f"{err:.3e}, rel L2 {rel:.3e} (tol {VJP_TOLS[name]:g}; dg bitwise)")
                max_err = max(max_err, err)
                errs.append(f"{name} max_abs_err={err:.3e} rel L2 {rel:.3e} (tol {VJP_TOLS[name]:g})")
            ms, plain_ms = cuda_ms(kernel, iters=20), cuda_ms(plain, iters=3)
            bound_ms, bound_by = bound(*vjp_cost(n, levels, t, rows, need))
            for k, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                into[k] += val
            into["max_abs_err"] = max(into["max_abs_err"], max_err)
            into["bound_by"] = bound_by
            formed = "+".join(k for k, w in zip(("dg", "d_table", "d_pos2"), need) if w)
            which = "the step's set" if into is sums else "all three"
            log(f"vjp_model hash_encode_bwd_pos_vjp {scope}[{i}] L{levels} T2^{t.bit_length() - 1}: n={n}, outputs "
                f"{formed} ({which}); " + "; ".join(errs) + f" ok; table rows touched "
                f"{rows} | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library none, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            del got, want
        sums["cases"] += 1
        sums["points"] += n
        sums["rows"] += rows
        del pos, g, v
        torch.cuda.empty_cache()
    return sums


def sphere_geometry(c2w: np.ndarray, w: int, h: int, focal: float):
    """Per pixel: the unit ray direction, whether it hits the unit sphere,
    the distance to the hit and the normal there (render_sphere's rays)."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -np.ones_like(xs)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - (o @ o - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return d, disc > 0, t, o + t[..., None] * d


def ring_pose(i: int, num: int) -> np.ndarray:
    ang = 2 * np.pi * i / num
    return look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))


def write_sitcoms_scene(root: Path, num: int = 8, w: int = 640, h: int = 480) -> Path:
    """A Sitcoms3D-format sphere scene with semantics: images_4/ (w x h, the
    full-resolution intrinsics 4x), segmentations_4/thing/ label images (1
    where the ray hits the sphere, 0 for the sky), cameras.json (the poses
    rotated back by the parser's z-up rotation) and panoptic_classes.json
    (classes sky and sphere)."""
    from nerfstudio_thermal_torch.utils.writer import write_png

    (root / "images_4").mkdir(parents=True, exist_ok=True)
    (root / "segmentations_4" / "thing").mkdir(parents=True, exist_ok=True)
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
    frames, focal = [], 0.8 * w
    for i in range(num):
        c2w = ring_pose(i, num)
        write_png(root / "images_4" / f"f{i:03d}.png", render_sphere(c2w, w, h, focal, False))
        hit = sphere_geometry(c2w, w, h, focal)[1]
        write_png(root / "segmentations_4" / "thing" / f"f{i:03d}.png", hit.astype(np.uint8)[..., None])
        pose = np.eye(4)
        pose[:3] = rot.T @ c2w[:3]
        frames.append({"image_name": f"f{i:03d}.png", "camtoworld": pose.tolist(),
                       "intrinsics": [[4 * focal, 0, 2.0 * w], [0, 4 * focal, 2.0 * h], [0, 0, 1]]})
    (root / "cameras.json").write_text(json.dumps({"frames": frames, "bbox": [[-1.5] * 3, [1.5] * 3]}))
    (root / "panoptic_classes.json").write_text(json.dumps(
        {"thing": ["sky", "sphere"], "thing_colors": [[90, 160, 220], [230, 120, 40]]}))
    return root


def write_sdfstudio_scene(root: Path, num: int = 8, w: int = 320, h: int = 240) -> Path:
    """An sdfstudio-format sphere scene with monocular priors: the analytic
    distance to the sphere (npy, in the parser's millimetres; 6 where the
    ray misses) and the sphere's normal mapped to [0, 1] (0.5 where it
    misses), OpenCV camera-to-world poses."""
    from nerfstudio_thermal_torch.utils.writer import write_png

    root.mkdir(parents=True, exist_ok=True)
    frames, focal = [], 0.8 * w
    for i in range(num):
        c2w = ring_pose(i, num)
        write_png(root / f"rgb_{i:03d}.png", render_sphere(c2w, w, h, focal, False))
        _, hit, t, n = sphere_geometry(c2w, w, h, focal)
        np.save(root / f"depth_{i:03d}.npy", (np.where(hit, t, 6.0) * 1000.0).astype(np.float32))
        np.save(root / f"normal_{i:03d}.npy", np.where(hit[..., None], (n + 1.0) / 2.0, 0.5).astype(np.float32))
        cv = c2w.copy()
        cv[:3, 1:3] *= -1
        frames.append({"rgb_path": f"rgb_{i:03d}.png", "camtoworld": cv.tolist(),
                       "intrinsics": [[focal, 0, w / 2, 0], [0, focal, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                       "mono_depth_path": f"depth_{i:03d}.npy", "mono_normal_path": f"normal_{i:03d}.npy"})
    meta = {"height": h, "width": w, "scene_box": {"aabb": [[-1.5] * 3, [1.5] * 3]}, "frames": frames,
            "has_mono_prior": True}
    (root / "meta_data.json").write_text(json.dumps(meta))
    return root


def direct_train(name: str, method, run_dir: Path, steps: int, per_step, timed_from: int, check=None) -> dict:
    """`steps` steps of a method config through setup_trainer ->
    Trainer.setup -> train_iteration (a scene that ns-train's flags cannot
    name the parser of), each synchronized and timed, with its launches
    (`per_step`, or None: nerfacto's by proposal_updated), every loss
    finite, every param group changed; check(step, scalars) per step."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.models.nerfacto import proposal_updated

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = setup_trainer(method, base_dir=run_dir, device="cuda")
    trainer.setup()
    groups = trainer.model.param_groups()
    before = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
    records = []
    reset_counts()
    for step in range(steps):
        ssu = trainer.state.steps_since_update
        c0 = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_iteration(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v - c0[k] for k, v in read_counts().items()}
        want = per_step
        if want is None:
            cfg = trainer.model.config
            want = _hash_step(1)(proposal_updated(step, ssu, cfg.proposal_warmup, cfg.proposal_update_every)[0])
        if launches != expected_counts(want):
            raise AssertionError(f"{name} step {step}: launches {launches}, expected {want}")
        scalars = {k: float(v) for k, v in out.items()}
        bad = [k for k, v in scalars.items() if "loss" in k and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} step {step}: non-finite losses {bad}")
        if check is not None:
            check(step, scalars)
        records.append({"step": step, "s": dt, **scalars})
    unchanged = [k for k, ps in groups.items() if all(torch.equal(a, p.detach()) for a, p in zip(before[k], ps))]
    nonfinite = [k for k, p in trainer.model.named_parameters() if not bool(torch.isfinite(p).all())]
    if unchanged or nonfinite:
        raise AssertionError(f"{name}: groups {unchanged} unchanged, parameters {nonfinite} not finite")
    return {"records": records, "counts": read_counts(), "peak": torch.cuda.max_memory_allocated(),
            "step_s": float(np.mean([r["s"] for r in records[timed_from:]])), "trainer": trainer}


def surface_render(model, name: str, chunk: dict, expect: dict, c2w) -> tuple:
    """One SURF_RENDER frame through render_camera_device: launches `chunk`
    a chunk, finite outputs of `expect`'s channels; (seconds, chunks)."""
    w, h, focal = SURF_RENDER
    cam = make_camera(w, h, focal, c2w)
    n_chunks = -(-(w * h) // model.config.eval_num_rays_per_chunk)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = model.render_camera_device(cam, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if read_counts() != expected_counts(chunk, n_chunks):
        raise AssertionError(f"{name} render: launches {read_counts()}, expected {chunk} x {n_chunks}")
    check_image_outputs(out, h, w, expect)
    return dt, n_chunks, out


def first_order_launches(field) -> None:
    """The SDF's first-order gradient (the normals), with and without its
    graph: one grid forward and one position gradient, no table scatter."""
    pts = torch.rand(8192, 3, generator=torch.Generator().manual_seed(4)).cuda() * 2.0 - 1.0
    for train in (True, False):
        torch.cuda.synchronize()
        reset_counts()
        _, _, grad = field.get_sdf_and_gradient(pts, train=train)
        torch.cuda.synchronize()
        want = expected_counts({"hash_encode_fwd": 1, "hash_encode_bwd_pos": 1})
        if read_counts() != want or grad.requires_grad != train or not bool(torch.isfinite(grad).all()):
            raise AssertionError(f"neus-facto first-order SDF gradient (create_graph={train}): launches "
                                 f"{read_counts()}, expected {want}")
        del grad
    log("neus-facto first-order SDF gradient (8192 points): one grid forward and one position-gradient launch, no "
        "table scatter, with and without create_graph")


def second_derivative_share(scene: Path, run_dir: Path, state: dict, smi: str) -> dict:
    """neus-facto's training steps (2048 rays, from the 30-step run's
    parameters) with the SDF gradient's graph (create_graph: the eikonal
    loss's double backward, the VJP kernel among it) and without it (the
    gradient taken without its graph, so the eikonal loss sends nothing
    back): wall ms/step over 8 steps after 2, and device ms/step summed
    from torch.profiler over 3 steps, of each. The difference is the
    second derivative's share of the step."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
    from nerfstudio_thermal_torch.fields.sdf_field import SDFField

    method = get_method_config("neus-facto")
    method.data = scene
    trainer = setup_trainer(method, base_dir=run_dir, device="cuda")
    trainer.model.load_state_dict(state)
    trainer.setup()
    step = [SURF_STEPS]

    def one():
        trainer.train_iteration(step[0])
        step[0] += 1

    def measure():
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            one()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 8 * 1e3, sum(kernel_split(one, iters=3).values())

    def first_order_only(self, positions, train=True):
        shape = positions.shape[:-1]
        with torch.enable_grad():
            x = positions.reshape(-1, 3).detach().requires_grad_(True)
            out = self.forward_geonetwork(x)
            (grad,) = torch.autograd.grad(out[:, :1], x, grad_outputs=torch.ones_like(out[:, :1]), retain_graph=True)
        return out[:, :1].reshape(*shape, 1), out[:, 1:].reshape(*shape, -1), grad.reshape(*shape, 3)

    with_graph = measure()
    inner = SDFField.get_sdf_and_gradient
    SDFField.get_sdf_and_gradient = first_order_only
    try:
        without = measure()
    finally:
        SDFField.get_sdf_and_gradient = inner
    del trainer
    torch.cuda.empty_cache()
    share = {"wall": 1.0 - without[0] / with_graph[0], "device": 1.0 - without[1] / with_graph[1]}
    log(f"neus-facto second derivative: {with_graph[0]:.2f} ms/step wall, {with_graph[1]:.2f} ms/step on the device; "
        f"without the SDF gradient's graph {without[0]:.2f} / {without[1]:.2f} ms: the second derivative takes "
        f"{share['wall'] * 100:.1f}% of the wall time and {share['device'] * 100:.1f}% of the device time ({smi})")
    return {"with_ms": with_graph, "without_ms": without, "share": share}


def surface_step_vs_cpu(scene: Path, run_dir: Path, state: dict) -> dict:
    """One f32 neus-facto step of 256 rays on the card and on the CPU from
    the 30-step run's parameters (`state`), the same batch and jitter: every
    loss, each group's gradient; before it, the eikonal loss alone (times
    eikonal_loss_mult, as the step weighs it) of the SDF field on the CPU
    model's final samples of the batch, whose SDF-grid table gradient
    (reached only through the second derivative: the VJP on the card, its
    plain version on the CPU) must match and not be zero."""
    from nerfstudio_thermal_torch.cameras.rays import map_tensors
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
    from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
    from nerfstudio_thermal_torch.model_components.ray_generators import RayGenerator

    method = get_method_config("neus-facto")
    method.data = scene
    method.datamanager.train_num_rays_per_batch = 256
    trainers = {}
    for dev in ("cpu", "cuda"):
        trainers[dev] = setup_trainer(copy.deepcopy(method), base_dir=run_dir / dev, device=dev)
        trainers[dev].model.load_state_dict(state)
        trainers[dev].setup()
    batch = trainers["cpu"].datamanager.next_train(0)
    gen = torch.Generator().manual_seed(17)
    uniforms = [torch.rand(256, 1, generator=gen) for _ in range(3)]
    witness, results = {}, {}

    # the witness's samples: the CPU model's final (SDF) samples of the
    # batch, the same on both devices (an inverse-CDF lookup into a flat
    # CDF step would move a sample on a rounding difference of the
    # proposal densities)
    cpu = trainers["cpu"]
    with torch.no_grad():
        bundle = cpu.model.collider(RayGenerator(cpu.cameras)(torch.as_tensor(batch["ray_indices"])), train=True)
        samples = cpu.model.sample_and_forward_field(bundle, train=True, uniforms=uniforms, generator=None,
                                                     cos_anneal_ratio=0.5)["ray_samples"]
    samples = map_tensors(samples, torch.Tensor.detach)

    def eikonal_table_grad(tr, b, u):
        model = tr.model
        model.zero_grad(set_to_none=True)
        c0 = read_counts()
        out = model.field(map_tensors(samples, lambda x: x.to(model.device)), train=True)
        eik = torch.mean((torch.linalg.vector_norm(out[FieldHeadNames.GRADIENT], dim=-1) - 1.0) ** 2)
        eik = eik * method.model.eikonal_loss_mult
        eik.backward()
        launches = {k: v - c0[k] for k, v in read_counts().items() if v - c0[k]}
        table = model.field.grid_encoding.hash_table.grad.detach().cpu().clone()
        model.zero_grad(set_to_none=True)
        return float(eik.detach()), table, launches

    for dev, tr in trainers.items():
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        u = {"rgb": [x.to(dev) for x in uniforms]}
        model = tr.model
        witness[dev] = eikonal_table_grad(tr, b, u)
        if dev == "cpu":  # the CPU's own spread: every parameter one ulp away
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1.0 + 2.0**-23 * torch.randint(-1, 2, p.shape, generator=gen).float())
            witness["cpu_ulp"] = eikonal_table_grad(tr, b, u)
            model.load_state_dict(state)
        scalars = tr._train_step(tr.state, b, uniforms=u)
        grads = {name: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten().float().cpu()
                                  for p in ps]) for name, ps in model.param_groups().items()}
        table = model.field.grid_encoding.hash_table.grad.detach().cpu().clone()
        results[dev] = ({k: float(v) for k, v in scalars.items()}, grads, table)
    del trainers
    torch.cuda.empty_cache()
    (want_s, want_g, want_t), (got_s, got_g, got_t) = results["cpu"], results["cuda"]
    loss_err = {k: abs(got_s[k] - w) / max(abs(w), 1e-3) for k, w in want_s.items()}
    grad_err = {name: rel_l2(got_g[name], w) for name, w in want_g.items()}
    log("neus-facto step_vs_cpu float32 (256 rays, full width, the 30-step run's parameters): losses/metrics up to "
        f"{max(loss_err.values()):.2e} rel ({max(loss_err, key=loss_err.get)}; tol {SURF_STEP_LOSS_TOL:g}); "
        "gradients rel L2 " + ", ".join(f"{k} {v:.2e}" for k, v in grad_err.items()) + f" (tol {SURF_STEP_GRAD_TOL:g})")
    if (any(not math.isfinite(got_s[k]) or e > SURF_STEP_LOSS_TOL for k, e in loss_err.items())
            or any(e > SURF_STEP_GRAD_TOL or not bool(torch.isfinite(got_g[k]).all()) for k, e in grad_err.items())):
        raise AssertionError(f"neus-facto f32 step disagrees with the CPU: losses {loss_err}, gradients {grad_err}")
    (cpu_eik, cpu_table, _), (eik, table, launches) = witness["cpu"], witness["cuda"]
    err, norm = rel_l2(table, cpu_table), float(table.norm())
    spread = rel_l2(witness["cpu_ulp"][1], cpu_table)
    ratio = norm / max(float(got_t.norm()), 1e-30)
    log(f"neus-facto eikonal-alone witness: loss card {eik:.6g} cpu {cpu_eik:.6g}; SDF-grid table gradient rel L2 "
        f"{err:.2e} against the CPU's plain path (tol {EIKONAL_TABLE_TOL:g}; the CPU against itself with every "
        f"parameter one ulp away: {spread:.2e}), norm {norm:.4e}, {ratio:.4f} of the full step's table gradient "
        f"({float(got_t.norm()):.4e}; the step's table gradient card vs CPU rel L2 {rel_l2(got_t, want_t):.2e}); "
        f"launches {launches}")
    if norm == 0.0 or err > EIKONAL_TABLE_TOL or launches.get("hash_encode_bwd_pos_vjp") != 1:
        raise AssertionError(f"neus-facto eikonal witness: table gradient norm {norm}, rel L2 {err:.3e}, launches "
                             f"{launches}")
    if abs(eik - cpu_eik) > SURF_STEP_LOSS_TOL * max(abs(cpu_eik), 1e-3):
        raise AssertionError(f"neus-facto eikonal witness: loss card {eik} cpu {cpu_eik}")
    return {"loss_err": max(loss_err.values()), "grad_err": grad_err, "eikonal_table_err": err,
            "eikonal_table_norm": norm, "eikonal_ratio": ratio, "eikonal_ulp_spread": spread}


def surface_methods_phase(tmp: Path, scene: Path, smi: str) -> dict:
    """Phase 17: neus-facto (ns-train, the first-order gradient's launches,
    the VJP on the model's calls, rows 7-10 on its grid's calls, ns-eval, a
    640x512 frame, an ns-render frame, the card-vs-CPU step with the
    eikonal witness), neus (12 steps, a frame), semantic-nerfw on a
    Sitcoms3D scene with semantics (12 steps, a frame with
    semantics_colormap) and neus-facto with the mono priors on an
    sdfstudio scene (6 steps). `scene` is an RGB Nerfstudio-layout sphere
    scene with an eval frame."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config
    from nerfstudio_thermal_torch.data.dataparsers.scene_parsers import Sitcoms3DDataParserConfig
    from nerfstudio_thermal_torch.data.dataparsers.sdfstudio_dataparser import SDFStudioDataParserConfig
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.scripts import render as ns_render_script
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    result = {}
    c2w = ring_pose(1, 8)

    # neus-facto through ns-train, with its calls recorded at one step
    run = classic_train("neus-facto", scene, tmp / "neus-facto", [], NEUS_FACTO_STEP, steps=SURF_STEPS,
                        capture_step=SURF_CAPTURE_STEP, timed_from=SURF_TIMED_FROM)
    trainer = run.pop("trainer")
    vjp_calls, hash_calls = run.pop("vjp"), run.pop("hash")
    run.pop("mlp")
    levels = [rec["scal"].shape[0] for rec in hash_calls]
    sdf_levels = trainer.model.field.grid_encoding.num_levels
    want = sorted([net.encoding.num_levels for net in trainer.model.proposal_networks] + [sdf_levels])
    # one VJP, of the SDF grid, forming dg and d_table (the step's backward
    # differentiates the parameters only: no d_pos2 for the detached positions)
    if (sorted(levels) != want or len(vjp_calls) != 1 or vjp_calls[0]["scal"].shape[0] != sdf_levels
            or vjp_calls[0]["need"] != VJP_STEP_OUTPUTS):
        raise AssertionError(f"neus-facto step {SURF_CAPTURE_STEP}: hash calls of {levels} levels, {len(vjp_calls)} VJP "
                             f"calls ({[rec['need'] for rec in vjp_calls]}); expected the two proposals, the SDF grid "
                             f"and one VJP forming {VJP_STEP_OUTPUTS}")
    recs = run["records"]
    rays = trainer.datamanager.config.train_num_rays_per_batch
    samples = rays * trainer.model.config.num_neus_samples_per_ray
    log(f"neus-facto train: {SURF_STEPS} steps of {rays} rays ({samples} SDF points a step, each with its second "
        f"derivative) through ns-train, every loss finite, every param group changed, launches a step "
        f"{NEUS_FACTO_STEP}; steps {SURF_TIMED_FROM}-{SURF_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, "
        f"{rays / run['step_s']:,.0f} rays/s, peak memory {run['peak'] / 2**30:.2f} GiB; loss {recs[0]['loss']:.4f} -> "
        f"{recs[-1]['loss']:.4f}, eikonal {recs[0]['eikonal_loss']:.4f} -> {recs[-1]['eikonal_loss']:.4f} ({smi})")
    first_order_launches(trainer.model.field)
    state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    result["second_derivative"] = second_derivative_share(scene, tmp / "neus-facto_share", state, smi)
    result["vjp"] = vjp_model_phase(f"neus-facto train step {SURF_CAPTURE_STEP}", vjp_calls)
    result["hash"] = hash_model_phase({f"neus-facto train step {SURF_CAPTURE_STEP}": hash_calls})
    del vjp_calls, hash_calls
    eval_s, scores = classic_eval("neus-facto", run["run"] / "config.yml", tmp / "neus-facto.json", ("psnr_rgb",))
    log(f"neus-facto ns-eval: {eval_s:.2f} s, psnr_rgb {scores['psnr_rgb']:.3f}")
    _, reloaded = eval_setup(run["run"] / "config.yml", device="cuda")
    frame_s, n_chunks, _ = surface_render(reloaded.model, "neus-facto", NEUS_FACTO_CHUNK,
                                          {"rgb": 3, "depth": 1, "normal": 3, "normal_vis": 3}, c2w)
    del reloaded
    torch.cuda.empty_cache()
    log(f"neus-facto render 640x512: {n_chunks} chunks of 2048 rays, launches {NEUS_FACTO_CHUNK} a chunk, rgb, depth, "
        f"normal and normal_vis finite; {frame_s:.3f} s/frame ({smi})")
    frames = tmp / "neus-facto_render"
    reset_counts()
    t0 = time.perf_counter()
    if ns_render_script.main(["dataset", "--load-config", str(run["run"] / "config.yml"), "--output-path", str(frames),
                              "--rendered-output-names", "rgb", "normal_vis"]) != 0:
        raise AssertionError("neus-facto ns-render failed")
    render_s = time.perf_counter() - t0
    pngs = sorted(frames.rglob("*.png"))
    frame = json.loads((scene / "transforms.json").read_text())["frames"][0]
    h, w = int(frame["h"]), int(frame["w"])
    want = expected_counts(NEUS_FACTO_CHUNK, -(-(h * w) // 2048))
    if len(pngs) != 2 or any(decode_png(p).shape != (h, w, 3) for p in pngs) or read_counts() != want:
        raise AssertionError(f"neus-facto ns-render: {[decode_png(p).shape for p in pngs]}, launches {read_counts()}, "
                             f"expected {want}")
    log(f"neus-facto ns-render dataset: 1 eval frame ({w}x{h}), rgb and normal_vis, launches {NEUS_FACTO_CHUNK} a "
        f"chunk, {render_s:.2f} s through the command ({smi})")
    result["neus-facto"] = {"step_s": run["step_s"], "rays": rays, "peak": run["peak"], "frame_s": frame_s,
                            "counts": run["counts"], "eval_s": eval_s, "ns_render_s": render_s, "run": run["run"],
                            **surface_step_vs_cpu(scene, tmp / "neus-facto_step", state)}
    del state
    torch.cuda.empty_cache()

    # neus at full width: no hash kernel
    run = classic_train("neus", scene, tmp / "neus", [], {}, steps=SURF_SHORT_STEPS,
                        timed_from=SURF_SHORT_TIMED_FROM)
    trainer = run.pop("trainer")
    rays = trainer.datamanager.config.train_num_rays_per_batch
    frame_s, n_chunks, _ = surface_render(trainer.model, "neus", {}, {"rgb": 3, "depth": 1, "normal_vis": 3,
                                                                      "bg_rgb": 3}, c2w)
    del trainer
    torch.cuda.empty_cache()
    log(f"neus train: {SURF_SHORT_STEPS} steps of {rays} rays through ns-train (64 + 4 x 16 samples a ray, 8 x 256 "
        f"SDF net, background NeRFField), every loss finite, every param group changed, no kernel launch; steps "
        f"{SURF_SHORT_TIMED_FROM}-{SURF_SHORT_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, peak memory "
        f"{run['peak'] / 2**30:.2f} GiB; render 640x512: {n_chunks} chunks, {frame_s:.3f} s/frame ({smi})")
    result["neus"] = {"step_s": run["step_s"], "rays": rays, "peak": run["peak"], "frame_s": frame_s}

    # semantic-nerfw on a Sitcoms3D scene with semantic labels
    sitcoms = write_sitcoms_scene(tmp / "sitcoms")
    method = get_method_config("semantic-nerfw")
    method.dataparser = Sitcoms3DDataParserConfig(data=sitcoms)
    method.data = sitcoms
    sem_losses = []
    run = direct_train("semantic-nerfw", method, tmp / "semantic-nerfw", SURF_SHORT_STEPS, None,
                       SURF_SHORT_TIMED_FROM, check=lambda s, sc: sem_losses.append(sc.get("semantics_loss")))
    if any(v is None or not math.isfinite(v) for v in sem_losses):
        raise AssertionError(f"semantic-nerfw: semantics_loss {sem_losses}")
    trainer = run.pop("trainer")
    rays = trainer.datamanager.config.train_num_rays_per_batch
    frame_s, n_chunks, out = surface_render(trainer.model, "semantic-nerfw", SEMANTIC_CHUNK,
                                            {"rgb": 3, "semantics": 2, "semantics_colormap": 3}, c2w)
    palette = trainer.model.semantic_colormap
    if not bool((out["semantics_colormap"][:, None, :] == palette[None]).all(-1).any(-1).all()):
        raise AssertionError("semantic-nerfw: a semantics_colormap pixel is not a class colour")
    del trainer, out
    torch.cuda.empty_cache()
    log(f"semantic-nerfw train: {SURF_SHORT_STEPS} steps of {rays} rays on a Sitcoms3D scene (8 frames 640x480, "
        f"classes sky and sphere), semantics_loss {sem_losses[0]:.4f} -> {sem_losses[-1]:.4f}, every loss finite, "
        f"launches {dict((k, v) for k, v in run['counts'].items() if v)}; steps {SURF_SHORT_TIMED_FROM}-"
        f"{SURF_SHORT_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, peak memory {run['peak'] / 2**30:.2f} GiB; "
        f"render 640x512 with semantics_colormap: {n_chunks} chunks, {frame_s:.3f} s/frame ({smi})")
    result["semantic-nerfw"] = {"step_s": run["step_s"], "rays": rays, "peak": run["peak"], "frame_s": frame_s,
                                "counts": run["counts"]}

    # neus-facto with the monocular priors on an sdfstudio scene
    sdf_scene = write_sdfstudio_scene(tmp / "sdfstudio")
    method = get_method_config("neus-facto")
    method.dataparser = SDFStudioDataParserConfig(data=sdf_scene, include_mono_prior=True)
    method.data = sdf_scene
    method.model.mono_normal_loss_mult, method.model.mono_depth_loss_mult = 0.05, 0.1
    priors = []
    run = direct_train("neus-facto:mono", method, tmp / "neus-facto_mono", MONO_STEPS, NEUS_FACTO_STEP, 1,
                       check=lambda s, sc: priors.append((sc.get("normal_loss"), sc.get("depth_loss"))))
    if any(n is None or d is None or not (math.isfinite(n) and math.isfinite(d)) for n, d in priors):
        raise AssertionError(f"neus-facto mono priors: normal_loss / depth_loss {priors}")
    del run["trainer"]
    torch.cuda.empty_cache()
    log(f"neus-facto with mono priors: {MONO_STEPS} steps on an sdfstudio scene (8 frames 320x240, the sphere's "
        f"analytic depth and normals), normal_loss {priors[0][0]:.4f} -> {priors[-1][0]:.4f}, depth_loss "
        f"{priors[0][1]:.4f} -> {priors[-1][1]:.4f}, launches a step {NEUS_FACTO_STEP}; {run['step_s'] * 1e3:.2f} "
        f"ms/step ({smi})")
    result["mono"] = {"step_s": run["step_s"]}
    log(f"phase 17 neus, neus-facto, semantic-nerfw: {time.perf_counter() - t_phase:.1f} s")
    return result


# Phase 18: ns-export and ns-texture through the commands. evaluate_sdf_grid
# hands the field slabs of at most EXPORT_SLAB_POINTS points. The SDF slab
# on the card against the CPU's plain path: f32 both (weight-normalised f32
# MLPs, no TF32, the hash forward's same products and sums), EXPORT_SDF_TOL
# absolute. The point cloud at EXPORT_CLOUD_SCALE of one eval camera: bf16
# MLPs, so depths and colours as phase 7's renders (99% of pixels within
# 2e-2 (1 + |x|)); a ray whose accumulation lies within EXPORT_ACC_EPS of the
# threshold may fall on either side and is counted. The TSDF volume from
# the card's own depth maps against the CPU's update of the same maps:
# values and colours within EXPORT_TSDF_TOL; a voxel whose projection sits
# on a pixel, view or truncation edge may decide otherwise on the two
# devices (f32 products in another order): at most EXPORT_TSDF_FLIPS of the
# touched voxels. The Poisson indicator: relative L2 EXPORT_CHI_TOL (cuFFT
# against the CPU's FFT). Exported normals: unit within EXPORT_NORMAL_TOL.
EXPORT_SLAB_POINTS = 262144
EXPORT_MC_RES = (128, 256)
EXPORT_SDF_TOL = 1e-4
EXPORT_CLOUD_SCALE, EXPORT_ACC_EPS = 0.0625, 1e-2  # 40 x 30 rays: the CPU's full-width render takes ~10 s
EXPORT_TSDF_TOL, EXPORT_TSDF_FLIPS = 1e-5, 1e-3
EXPORT_CHI_TOL = 1e-5
EXPORT_NORMAL_TOL = 1e-3
EXPORT_TEXTURE_FACES = 20000  # ns-texture's --target-num-faces on the neus-facto mesh
EXPORT_DENSITY_TEXTURE = ["--resolution", "48", "--px-per-uv-triangle", "4"]  # thermal-nerfacto's texture export


@contextlib.contextmanager
def export_spans():
    """While open, the export modules' card work is synchronised and
    timed: renders (get_outputs_for_camera: its chunks counted; the
    texture bake's render_ray_bundle_chunked: its rays and chunks), the
    field's grid slabs (counted), the TSDF update and the Poisson solve
    ("card"), and eval_setup ("setup"). Yields (seconds by span, counts)."""
    import functools

    from nerfstudio_thermal_torch.exporter import poisson, tsdf_utils
    from nerfstudio_thermal_torch.models import base_model
    from nerfstudio_thermal_torch.scripts import exporter
    from nerfstudio_thermal_torch.utils import eval_utils

    spans, calls = collections.Counter(), collections.Counter()

    def timed(kind, fn, count=None):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if count is not None:
                count(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[kind] += time.perf_counter() - t0
            return out
        return wrapper

    def camera_chunks(model, cameras, i, *args, **kwargs):
        calls["renders"] += 1
        calls["chunks"] += -(-int(cameras.height[i]) * int(cameras.width[i]) // model.config.eval_num_rays_per_chunk)

    def bundle_chunks(model, bundle, *args, **kwargs):
        n = bundle.origins.shape[0]
        calls["bake_rays"] += n
        calls["chunks"] += -(-n // model.config.eval_num_rays_per_chunk)

    def slab(*args):
        calls["grid"] += 1

    inner_field = exporter.field_callable

    def field_callable(model):
        fn, sign = inner_field(model)
        return timed("card", fn, slab), sign

    patches = [
        (eval_utils, "eval_setup", timed("setup", eval_utils.eval_setup)),
        (base_model.Model, "get_outputs_for_camera", timed("card", base_model.Model.get_outputs_for_camera,
                                                           camera_chunks)),
        (base_model.Model, "render_ray_bundle_chunked", timed("card", base_model.Model.render_ray_bundle_chunked,
                                                              bundle_chunks)),
        (tsdf_utils.TSDF, "integrate_tsdf", timed("card", tsdf_utils.TSDF.integrate_tsdf)),
        (poisson, "solve_indicator", timed("card", poisson.solve_indicator)),
        (exporter, "field_callable", field_callable),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield spans, calls
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def read_ply_mesh_normals(path: Path):
    """(vertices [V, 3], faces [F, 3], normals [V, 3]) of a PLY that
    exporter_utils.write_ply_mesh wrote with normals."""
    data = path.read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    nv = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
    nf = int(next(line for line in header if line.startswith("element face")).split()[-1])
    props = [line.split()[1:] for line in header if line.startswith("property") and "list" not in line]
    vdtype = np.dtype([(name, "<f4" if typ == "float" else "u1") for typ, name in props])
    vdata = np.frombuffer(data, vdtype, nv, end)
    fdata = np.frombuffer(data, [("n", "u1"), ("idx", "<i4", (3,))], nf, end + vdtype.itemsize * nv)
    if not (fdata["n"] == 3).all() or end + vdtype.itemsize * nv + fdata.itemsize * nf != len(data):
        raise AssertionError(f"{path}: malformed PLY mesh")
    stack = lambda *keys: np.stack([vdata[k] for k in keys], -1)  # noqa: E731
    return stack("x", "y", "z"), np.asarray(fdata["idx"]), stack("nx", "ny", "nz")


def check_mesh(label: str, path: Path) -> tuple:
    verts, faces, normals = read_ply_mesh_normals(path)
    norm = np.linalg.norm(normals, axis=-1)
    if not (len(verts) > 0 and len(faces) > 0 and faces.min() >= 0 and faces.max() < len(verts)
            and np.isfinite(verts).all() and np.abs(norm - 1).max() <= EXPORT_NORMAL_TOL):
        raise AssertionError(f"{label}: {len(verts)} vertices, {len(faces)} faces (indices {faces.min()}.."
                             f"{faces.max()}), normals' norms {norm.min():.6f}..{norm.max():.6f}")
    return len(verts), len(faces)


def export_phase(entries: dict, neus_run: Path, out: Path, smi: str) -> dict:
    """Phase 18: ns-export (every mode the port has) and ns-texture on the
    card, through the commands with their default device."""
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.exporter import exporter_utils as eu
    from nerfstudio_thermal_torch.exporter import poisson, texture_utils, tsdf_utils
    from nerfstudio_thermal_torch.scripts import exporter as ns_export
    from nerfstudio_thermal_torch.scripts import texture as ns_texture
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    launches, lines = collections.Counter(), {}

    def run(label, main, argv, per_chunk, per_slab):
        """One command: its launches must be per_chunk a render chunk plus
        per_slab a grid slab, exactly."""
        reset_counts()
        with export_spans() as (spans, calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = main(argv)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        counts = read_counts()
        want = {k: per_chunk.get(k, 0) * calls["chunks"] + per_slab.get(k, 0) * calls["grid"] for k in counts}
        if rc != 0 or counts != want:
            raise AssertionError(f"{label}: returned {rc}, launches {counts}, expected {want} ({dict(calls)})")
        launches.update(counts)
        rec = {"s": total, "setup_s": spans["setup"], "card_s": spans["card"],
               "host_s": total - spans["setup"] - spans["card"], "calls": dict(calls),
               "counts": {k: v for k, v in counts.items() if v}}
        lines[label] = rec
        return rec

    def report(label, rec, what):
        log(f"export {label}: {rec['s']:.2f} s (setup {rec['setup_s']:.2f}, card {rec['card_s']:.2f}, host "
            f"{rec['host_s']:.2f}); {what}; launches {rec['counts']} ({rec['calls']}) ({smi})")

    # neus-facto: marching cubes of the SDF at two resolutions, then ns-texture
    cfg = neus_run / "config.yml"
    per_chunk_nf = NEUS_FACTO_CHUNK
    for res in EXPORT_MC_RES:
        d = out / f"neus-facto_mc{res}"
        rec = run(f"neus-facto marching-cubes {res}", ns_export.main,
                  ["marching-cubes", "--load-config", str(cfg), "--output-dir", str(d), "--resolution", str(res)],
                  per_chunk_nf, {"hash_encode_fwd": 1})
        slabs = -(-res // max(1, EXPORT_SLAB_POINTS // res**2))
        if rec["calls"] != {"grid": slabs}:
            raise AssertionError(f"neus-facto marching-cubes {res}: {rec['calls']}, expected {slabs} slabs and no render")
        rec["verts"], rec["faces"] = check_mesh(f"neus-facto marching-cubes {res}", d / "sdf_marching_cubes_mesh.ply")
        report(f"neus-facto marching-cubes {res}^3", rec, f"{slabs} slabs of {EXPORT_SLAB_POINTS // res**2} x {res}^2 "
               f"points, {rec['verts']} vertices, {rec['faces']} faces, unit normals, indices in range")
    # one 256^3 slab on the card against the CPU's plain path
    res = EXPORT_MC_RES[-1]
    xs = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs[: EXPORT_SLAB_POINTS // res**2], xs, xs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    _, card = eval_setup(cfg, device="cuda")
    _, cpu = eval_setup(cfg, device="cpu")
    got = ns_export.field_callable(card.pipeline.model)[0](pts)
    want = ns_export.field_callable(cpu.pipeline.model)[0](pts)
    err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or err > EXPORT_SDF_TOL:
        raise AssertionError(f"neus-facto SDF slab: card vs CPU max |diff| {err:.3e} (limit {EXPORT_SDF_TOL})")
    log(f"export neus-facto SDF slab ({len(pts)} points of the {res}^3 grid): card vs CPU max |diff| {err:.3e} "
        f"(limit {EXPORT_SDF_TOL}), SDF {want.min():.4f}..{want.max():.4f}")
    chunk_nf = card.pipeline.model.config.eval_num_rays_per_chunk
    del card, cpu
    torch.cuda.empty_cache()
    mesh = out / f"neus-facto_mc{EXPORT_MC_RES[0]}" / "sdf_marching_cubes_mesh.ply"
    d = out / "neus-facto_texture"
    rec = run("neus-facto ns-texture", ns_texture.main,
              ["--load-config", str(cfg), "--input-mesh-filename", str(mesh), "--output-dir", str(d),
               "--target-num-faces", str(EXPORT_TEXTURE_FACES)], per_chunk_nf, {})
    faces = min(lines[f"neus-facto marching-cubes {EXPORT_MC_RES[0]}"]["faces"], EXPORT_TEXTURE_FACES)
    uv, tw, th, P = texture_utils.unwrap_mesh_per_face(faces, 4)
    rays = int((texture_utils._texel_to_face(tw, th, P, 4, faces)[0] >= 0).sum())
    if rec["calls"] != {"bake_rays": rays, "chunks": -(-rays // chunk_nf)} or decode_png(d / "texture.png").shape != (
            th, tw, 3) or not (d / "mesh.obj").exists():
        raise AssertionError(f"neus-facto ns-texture: {rec['calls']}, expected {rays} rays; texture "
                             f"{decode_png(d / 'texture.png').shape}, expected {(th, tw, 3)}")
    report("neus-facto ns-texture", rec, f"{faces} faces, {rays} texel rays, texture {tw}x{th}")

    # thermal-nerfacto: every mode of the paper's method
    run_t = entries["thermal-nerfacto"]["run"]
    cfg = run_t / "config.yml"
    per_chunk = METHODS["thermal-nerfacto"]["chunk"]
    _, cpu = eval_setup(cfg, device="cpu")
    dm = cpu.datamanager

    def chunks(cams):
        c = cpu.pipeline.model.config.eval_num_rays_per_chunk
        return sum(-(-int(cams.height[i]) * int(cams.width[i]) // c) for i in range(len(cams)))

    d = out / "thermal_pointcloud"
    rec = run("thermal-nerfacto pointcloud", ns_export.main,
              ["pointcloud", "--load-config", str(cfg), "--output-dir", str(d), "--use-thermal-color", "true"],
              per_chunk, {})
    points, colors = eu.read_ply(d / "point_cloud.ply")
    if (rec["calls"] != {"renders": len(dm.eval_cameras), "chunks": chunks(dm.eval_cameras)} or len(points) == 0
            or colors is None or not (np.isfinite(points).all() and 0 <= colors.min() and colors.max() <= 1)
            or not (colors == colors[:, :1]).all()):
        raise AssertionError(f"thermal-nerfacto pointcloud: {rec['calls']}, {len(points)} points, colours "
                             f"{None if colors is None else (colors.min(), colors.max())}")
    rec["points"] = len(points)
    report("thermal-nerfacto pointcloud --use-thermal-color true", rec,
           f"{len(points)} points of {len(dm.eval_cameras)} eval cameras (stride 4, accumulation > 0.5), grey "
           f"thermal colours in [0, 1]")

    seen = {}
    get_mesh, renders = tsdf_utils.TSDF.get_mesh, tsdf_utils.render_cameras_for_export

    def recording_mesh(self):
        seen["tsdf"] = self
        return get_mesh(self)

    def recording_renders(*args, **kwargs):
        seen["renders"] = renders(*args, **kwargs)
        return seen["renders"]

    tsdf_utils.TSDF.get_mesh, tsdf_utils.render_cameras_for_export = recording_mesh, recording_renders
    try:
        d = out / "thermal_tsdf"
        rec = run("thermal-nerfacto tsdf", ns_export.main, ["tsdf", "--load-config", str(cfg), "--output-dir", str(d)],
                  per_chunk, {})
    finally:
        tsdf_utils.TSDF.get_mesh, tsdf_utils.render_cameras_for_export = get_mesh, renders
    half = dm.train_cameras.rescale_output_resolution(0.5)
    if rec["calls"] != {"renders": len(half), "chunks": chunks(half)}:
        raise AssertionError(f"thermal-nerfacto tsdf: {rec['calls']}, expected {len(half)} renders")
    rec["verts"], rec["faces"] = check_mesh("thermal-nerfacto tsdf", d / "tsdf_mesh.ply")
    rgbs, depths, c2ws, Ks = seen["renders"]
    card_tsdf = seen.pop("tsdf")
    ref = tsdf_utils.TSDF.from_aabb(np.asarray([[-1.0] * 3, [1.0] * 3], np.float32), [128] * 3, "cpu")
    for i in range(len(c2ws)):
        ref.integrate_tsdf(c2ws[i:i + 1], Ks[i:i + 1], depths[i][None], color_images=rgbs[i][None])
    a, b = (np.concatenate([t.values.cpu().numpy()[..., None], t.weights.cpu().numpy()[..., None],
                            t.colors.cpu().numpy()], -1) for t in (card_tsdf, ref))
    same = (a[..., 1] == b[..., 1]) & (np.abs(a - b).max(-1) <= EXPORT_TSDF_TOL)
    touched = int((b[..., 1] > 0).sum())
    if touched == 0 or (~same).sum() > EXPORT_TSDF_FLIPS * touched:
        raise AssertionError(f"thermal-nerfacto tsdf: {(~same).sum()} of {touched} touched voxels differ from the "
                             f"CPU's update of the same depth maps")
    report("thermal-nerfacto tsdf 128^3", rec, f"{len(c2ws)} train cameras at 1/2, {rec['verts']} vertices, "
           f"{rec['faces']} faces; the card's volume against the CPU's update of the same maps: {(~same).sum()} of "
           f"{touched} touched voxels differ (limit {EXPORT_TSDF_FLIPS:.0e} of them), elsewhere within "
           f"{EXPORT_TSDF_TOL}")
    del card_tsdf, ref, seen["renders"]

    solve = poisson.solve_indicator

    def recording_solve(V, h, sigma, device):
        seen["chi"] = (V, h, sigma, solve(V, h, sigma, device))
        return seen["chi"][-1]

    poisson.solve_indicator = recording_solve
    try:
        d = out / "thermal_poisson"
        rec = run("thermal-nerfacto poisson", ns_export.main,
                  ["poisson", "--load-config", str(cfg), "--output-dir", str(d)], per_chunk, {})
    finally:
        poisson.solve_indicator = solve
    rec["verts"], rec["faces"] = check_mesh("thermal-nerfacto poisson", d / "poisson_mesh.ply")
    V, h, sigma, chi = seen.pop("chi")
    ref = solve(V, h, sigma, "cpu")
    chi_err = float(np.linalg.norm(chi - ref) / np.linalg.norm(ref))
    if rec["calls"]["renders"] != len(dm.eval_cameras) or not chi_err <= EXPORT_CHI_TOL:
        raise AssertionError(f"thermal-nerfacto poisson: {rec['calls']}, chi card vs CPU rel L2 {chi_err:.3e}")
    report("thermal-nerfacto poisson 128^3", rec, f"{rec['verts']} vertices, {rec['faces']} faces; chi (cuFFT) "
           f"against the CPU's solve of the same splat: rel L2 {chi_err:.3e} (limit {EXPORT_CHI_TOL})")

    d = out / "thermal_texture"
    rec = run("thermal-nerfacto texture", ns_export.main,
              ["texture", "--load-config", str(cfg), "--output-dir", str(d), *EXPORT_DENSITY_TEXTURE], per_chunk,
              {"hash_encode_fwd": 1})
    res = int(EXPORT_DENSITY_TEXTURE[1])
    slabs = -(-res // max(1, EXPORT_SLAB_POINTS // res**2))
    if rec["calls"]["grid"] not in (slabs, 2 * slabs) or decode_png(d / "texture.png").ndim != 3:
        raise AssertionError(f"thermal-nerfacto texture: {rec['calls']}, expected {slabs} slabs (twice after a "
                             f"fallback to the median level)")
    report(f"thermal-nerfacto texture ({' '.join(EXPORT_DENSITY_TEXTURE)})", rec,
           f"{rec['calls']['grid']} density slabs, {rec['calls']['bake_rays']} texel rays, texture "
           f"{decode_png(d / 'texture.png').shape[1]}x{decode_png(d / 'texture.png').shape[0]}")

    d = out / "thermal_cameras"
    rec = run("thermal-nerfacto cameras", ns_export.main, ["cameras", "--load-config", str(cfg), "--output-dir",
                                                          str(d)], per_chunk, {})
    if json.loads((d / "cameras.json").read_text()) != ns_export.camera_frames(dm.train_cameras) or rec["calls"]:
        raise AssertionError("thermal-nerfacto cameras: cameras.json differs from the train cameras")
    report("thermal-nerfacto cameras", rec, f"{len(dm.train_cameras)} train cameras, equal to the run's")

    # one eval camera's point cloud at 1/16 resolution: the card against the CPU
    _, card = eval_setup(cfg, device="cuda")
    small = dm.eval_cameras.rescale_output_resolution(EXPORT_CLOUD_SCALE)
    clouds, accs = {}, {}
    for name, trainer in (("card", card), ("cpu", cpu)):
        model = trainer.pipeline.model
        render = model.get_outputs_for_camera

        def recording(*args, name=name, render=render, **kwargs):
            out = render(*args, **kwargs)
            accs[name] = out["accumulation"].reshape(-1)
            return out

        model.get_outputs_for_camera = recording  # the cloud's own render gives its accumulation
        try:
            clouds[name] = eu.generate_point_cloud(model, small, num_cameras=1, min_accumulation=-1.0, stride=1,
                                                   use_thermal_color=True)
        finally:
            del model.get_outputs_for_camera
    (p_card, c_card), (p_cpu, c_cpu) = clouds["card"], clouds["cpu"]
    near = np.abs(accs["cpu"] - 0.5) < EXPORT_ACC_EPS
    flipped = (accs["card"] > 0.5) != (accs["cpu"] > 0.5)
    close = (np.abs(p_card - p_cpu) <= 2e-2 * (1 + np.abs(p_cpu))).all(-1)
    close &= (np.abs(c_card - c_cpu) <= 2e-2 * (1 + np.abs(c_cpu))).all(-1)
    if (flipped & ~near).any() or close.mean() < 0.99:
        raise AssertionError(f"thermal-nerfacto point cloud: {int((flipped & ~near).sum())} rays off the threshold "
                             f"change sides; {close.mean():.4f} of points agree")
    log(f"export thermal-nerfacto point cloud card vs CPU (eval camera 0 at {int(small.width[0])}x"
        f"{int(small.height[0])}): {close.mean() * 100:.2f}% of points and thermal colours within 2e-2, "
        f"{int((accs['cpu'] > 0.5).sum())} / {int((accs['card'] > 0.5).sum())} rays above the threshold (CPU / card), "
        f"{int(near.sum())} within {EXPORT_ACC_EPS} of it, {int(flipped.sum())} on the other side (all of them near)")
    del card, cpu
    torch.cuda.empty_cache()

    # thermal-nerfacto-tpu: the density through row 1
    cfg = entries["thermal-nerfacto-tpu"]["run"] / "config.yml"
    d = out / "tpu_mc"
    rec = run("thermal-nerfacto-tpu marching-cubes", ns_export.main,
              ["marching-cubes", "--load-config", str(cfg), "--output-dir", str(d)], {}, {"fused_mlp_fwd": 1})
    slabs = -(-128 // max(1, EXPORT_SLAB_POINTS // 128**2))
    if rec["calls"]["grid"] not in (slabs, 2 * slabs) or set(rec["calls"]) != {"grid"}:
        raise AssertionError(f"thermal-nerfacto-tpu marching-cubes: {rec['calls']}")
    rec["verts"], rec["faces"] = check_mesh("thermal-nerfacto-tpu marching-cubes", d / "sdf_marching_cubes_mesh.ply")
    report("thermal-nerfacto-tpu marching-cubes 128^3", rec, f"{rec['calls']['grid']} density slabs (one fused-MLP "
           f"forward each), {rec['verts']} vertices, {rec['faces']} faces")
    total = time.perf_counter() - t_phase
    log(f"phase 18 ns-export and ns-texture: {total:.1f} s, launches {dict(launches)}")
    return {"lines": lines, "launches": dict(launches), "s": total}



# Phase 19: splatfacto and generfacto. Splatfacto runs no kernel of the
# table (its ops are torch ops, XLA in the JAX package); its numbers are
# the splat ops' times with bounds, a CUDA rasterizer's yardstick.
SPLAT_STEPS, SPLAT_TIMED_FROM = 30, 10
# the refinement run: refinements after steps 5, 10 and 15, the opacity
# reset at 10 (reset_alpha_every x refine_every), a densification
# threshold that a random init's gradients pass
SPLAT_REFINE_STEPS = 16
SPLAT_REFINE_FLAGS = ["--pipeline.model.warmup-length", "4", "--pipeline.model.refine-every", "5",
                      "--pipeline.model.reset-alpha-every", "2", "--pipeline.model.densify-grad-thresh", "2e-5"]
SPLAT_REFINE_TOL = 1e-6  # parameters, card against the CPU's refinement of the same state
SPLAT_TILE_TOL = 3e-5  # tiles against scan: the JAX package's test's tolerance
SPLAT_VJP_TOL = 1e-4  # the two-pass backward against autograd of the plain scan, relative L2
SPLAT_FRAME_TOL = 1e-4  # a frame of the trained model, card against CPU
SPLAT_CHECK_HW = (256, 320)  # the card-vs-CPU frame (the CPU rasterizes it too)
SPLAT_SCAN_HW, SPLAT_SCAN_N = (128, 160), 4096  # tiles against scan: a size the scan affords
SPLAT_RENDERS = {"640x512": (640, 512, 500.0), "1080p": (1920, 1080, 1400.0)}
SPLAT_OPS = {"train 640x480": (640, 480, 512.0), "1080p": SPLAT_RENDERS["1080p"]}  # the splat ops' timed frames
SPLAT_OP_OPS = 30  # f32 operations per (pixel, slot) pair of the compositing forward
GEN_STEPS, GEN_TIMED_FROM, GEN_CAPTURE_STEP = 30, 10, 9
GEN_STEP = {"hash_encode_fwd": 3, "hash_encode_bwd_table": 3, "hash_encode_bwd_pos": 1,
            "hash_encode_bwd_pos_vjp": 1}
GEN_FRAME = {"hash_encode_fwd": 3, "hash_encode_bwd_pos": 1}
GEN_KERNELS = {"hash_encode_fwd": "hash_encode_fwd_kernel", "hash_encode_bwd_table": "hash_encode_bwd_table_kernel",
               "hash_encode_bwd_pos": "hash_encode_bwd_pos_kernel",
               "hash_encode_bwd_pos_vjp": "hash_encode_bwd_pos_vjp_kernel"}


def splat_step_split(trainer, step: int) -> dict:
    """One splatfacto step split on the device's timeline by CUDA events:
    binning, the forward without it (projection, SH, gather, compositing),
    the losses, the backward (with the refinement statistics) and Adam;
    the step's wall time; and its busy device time from torch.profiler over
    the next step (host = wall - busy)."""
    from nerfstudio_thermal_torch.ops import splat_tiles

    model, opt = trainer.model, trainer.optimizers
    ev = {}

    def mark(key):
        ev[key] = torch.cuda.Event(enable_timing=True)
        ev[key].record()

    def wrap(obj, name, before, after):
        inner = getattr(obj, name)

        def wrapped(*args, **kwargs):
            mark(before)
            out = inner(*args, **kwargs)
            mark(after)
            return out

        setattr(obj, name, wrapped)
        return inner

    saved = [(splat_tiles, "bin_gaussians", wrap(splat_tiles, "bin_gaussians", "bin0", "bin1")),
             (model, "render_camera", wrap(model, "render_camera", "fwd0", "fwd1")),
             (model, "get_loss_dict", wrap(model, "get_loss_dict", "loss0", "loss1")),
             (opt, "step", wrap(opt, "step", "adam0", "adam1"))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        trainer.train_iteration(step)
        mark("end")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, name, inner in saved:
            if obj is model or obj is opt:
                delattr(obj, name) if name in vars(obj) else None
            else:
                setattr(obj, name, inner)
    ms = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
    binning = ms("bin0", "bin1")
    split = {"binning": binning, "forward": ms("fwd0", "fwd1") - binning, "losses": ms("loss0", "loss1"),
             "backward": ms("loss1", "adam0"), "adam": ms("adam0", "adam1"), "timeline": ms("start", "end"),
             "wall": wall}
    busy = sum(kernel_split(lambda: trainer.train_iteration(step + 1), iters=1).values())
    split["busy"], split["host"] = busy, wall - busy
    return split


def splat_op_cost(n: int, h: int, w: int, capacity: int, feats: int, channels: int) -> dict:
    """Bytes and f32 operations of the splat ops at N slots and an h x w
    frame: binning reads each slot's centre, depth, radius and mask and
    writes the [T, K] lists, the mask and the order (its ops: the two
    sorts' comparisons, N log N and 16 N log 16 N); the compositing
    forward reads the tiles' feature rows and writes rgb, alpha and depth,
    SPLAT_OP_OPS a (pixel, slot) pair; its backward reads those again with
    the outputs' cotangents and writes the rows' gradients, three times
    the forward's operations (the checkpointed forward, then the chain)."""
    tiles = -(-h // 16) * -(-w // 16)
    m = 16 * n
    pairs = tiles * 256 * capacity
    rows = tiles * capacity * feats * 4
    pixels = h * w * (channels + 2) * 4
    return {
        "binning": (n * 17 + tiles * capacity * 9 + n * 8, n * math.log2(n) + m * math.log2(m)),
        "forward": (rows + pixels, pairs * SPLAT_OP_OPS),
        "forward+backward": (2 * rows + 2 * pixels, 4 * pairs * SPLAT_OP_OPS),
    }


def splat_ops_phase(model, label: str, w: int, h: int, focal: float, c2w, smi: str) -> dict:
    """The splat ops on the trained model's projection of a w x h camera:
    binning, the tile compositing forward and forward + backward (a sum
    loss over rgb, alpha and depth), each timed (CUDA events) beside its
    bound; no PyTorch call computes a splat rasterizer (library none)."""
    from nerfstudio_thermal_torch.models import splatfacto as sf
    from nerfstudio_thermal_torch.ops import splat_tiles

    cfg = model.config
    cam = make_camera(w, h, focal, c2w).to("cuda")
    alive = model._alive()
    with torch.no_grad():
        xys, depths, conics, radii, comp = sf.project_gaussians(
            model.xyz, torch.exp(model.scales), model.quats, cam.camera_to_worlds[0], cam.fx[0], cam.fy[0],
            cam.cx[0], cam.cy[0], w, h)
        viewdir = torch.nn.functional.normalize(model.xyz - cam.camera_to_worlds[0][:3, 3], dim=-1)
        basis = sf.sh_basis(cfg.sh_degree, viewdir)
        feats = torch.cat([model.features_dc[:, None], model.features_rest], 1)
        colors = torch.clamp(torch.einsum("nb,nbc->nc", basis, feats) + 0.5, min=0.0)
        opac = torch.sigmoid(model.opacities) * comp
    valid = alive & (radii > 0)
    bg = torch.zeros(3, device="cuda")
    kw = dict(capacity=cfg.tile_capacity, window=cfg.tile_window)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xys, conics, opac, colors)]

    def forward():
        with torch.no_grad():
            return splat_tiles.rasterize_tiles(xys, depths, conics, radii, opac, colors, alive, h, w, bg, **kw)

    def forward_backward():
        rgb, acc, dep = splat_tiles.rasterize_tiles(leaves[0], depths, leaves[1], radii, leaves[2], leaves[3], alive,
                                                    h, w, bg, **kw)
        torch.autograd.grad(rgb.sum() + acc.sum() + dep.sum(), leaves)

    calls = {"binning": lambda: splat_tiles.bin_gaussians(xys, depths, radii, valid, h, w, 16, 16, **kw),
             "forward": forward, "forward+backward": forward_backward}
    costs = splat_op_cost(xys.shape[0], h, w, cfg.tile_capacity, 10, 3)
    gauss_idx, slot_mask, _ = calls["binning"]()
    full = int(slot_mask.all(dim=1).sum())
    out = {}
    for name, fn in calls.items():
        ms = cuda_ms(fn, iters=5)
        bound_ms, bound_by = bound(*costs[name])
        out[name] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"splat_op {name} {label} ({w}x{h}, {xys.shape[0]} slots, {int(valid.sum())} live and in front, "
            f"{gauss_idx.shape[0]} tiles, {full} tiles at capacity {cfg.tile_capacity}): {ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), library none ({smi})")
    del leaves, gauss_idx, slot_mask
    torch.cuda.empty_cache()
    return out


def splat_refine_checked(trainer, checks: list) -> None:
    """Wrap the trainer's refinement: before each, the card's state (the
    model, the optimizers' moments, the extra state) is copied to the
    CPU; after it, the CPU's refinement of that copy must give the same
    alive mask, parameters within SPLAT_REFINE_TOL and the same moments,
    zero in every row that was culled or filled."""
    from nerfstudio_thermal_torch.models.splatfacto import PARAM_KEYS

    inner = trainer._maybe_refine

    def checked(step):
        model = trainer.model
        if not model.wants_host_refinement(step):
            return inner(step)
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu_opt = copy.deepcopy(trainer.optimizers)
        for g in cpu_opt.groups.values():
            g.params, g.mu, g.nu = [p.cpu() for p in g.params], [t.cpu() for t in g.mu], [t.cpu() for t in g.nu]
        extra = trainer.state.extra
        cpu_extra = dataclasses.replace(extra, **{f.name: getattr(extra, f.name).cpu()
                                                  for f in dataclasses.fields(extra)})
        before = extra.alive.clone()
        t0 = time.perf_counter()
        inner(step)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        want = cpu_model.refine_host(cpu_opt, step, cpu_extra)
        after = trainer.state.extra.alive
        if not torch.equal(after.cpu(), want.alive):
            raise AssertionError(f"splatfacto refinement at step {step}: the card's alive mask differs from the CPU's "
                                 f"({int((after.cpu() != want.alive).sum())} slots)")
        errs = {k: float((getattr(model, k).detach().cpu() - getattr(cpu_model, k).detach()).abs().max())
                for k in PARAM_KEYS}
        if max(errs.values()) > SPLAT_REFINE_TOL:
            raise AssertionError(f"splatfacto refinement at step {step}: parameters {errs} (tol {SPLAT_REFINE_TOL})")
        touched = ((after & ~before) | (before & ~after)).cpu()
        for name, g in trainer.optimizers.groups.items():
            for got, ref in zip(g.mu + g.nu, cpu_opt.groups[name].mu + cpu_opt.groups[name].nu):
                got = got.cpu()
                if not torch.equal(got, ref) or bool(got[touched].any()):
                    raise AssertionError(f"splatfacto refinement at step {step}: group {name}'s moments differ from "
                                         f"the CPU's or are not zero in the touched rows")
        reset = step % (model.config.reset_alpha_every * model.config.refine_every) == 0
        checks.append({"step": step, "alive_before": int(before.sum()), "alive_after": int(after.sum()),
                       "culled": int((before & ~after).sum()), "touched": int(touched.sum()), "reset": reset,
                       "max_err": max(errs.values()), "card_s": card_s})
        del cpu_model, cpu_opt

    trainer._maybe_refine = checked


def splat_scan_check(smi: str) -> dict:
    """Tiles against scan and the scan's two-pass backward against autograd
    of the plain scan, on the card, on SPLAT_SCAN_N seeded gaussians over a
    SPLAT_SCAN_HW frame (no tile at capacity, so the two rasterizers
    composite the same lists); with the scan's forward + backward times."""
    from nerfstudio_thermal_torch.models import splatfacto as sf
    from nerfstudio_thermal_torch.ops import splat_compose, splat_tiles

    h, w = SPLAT_SCAN_HW
    n = SPLAT_SCAN_N
    r = np.random.default_rng(19)
    sig = r.uniform(0.8, 3.0, n)
    arrays = (r.uniform([-4, -4], [w + 4, h + 4], (n, 2)), r.uniform(0.5, 5.0, n),
              np.stack([1 / sig**2, r.uniform(-0.2, 0.2, n) / sig**2, 1 / sig**2], -1), np.ceil(3 * sig),
              r.uniform(0.05, 1.0, n), r.uniform(0, 1, (n, 3)))
    xys, depths, conics, radii, opac, colors = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays)
    alive = torch.tensor(r.uniform(0, 1, n) > 0.1, device="cuda")
    bg = torch.tensor([0.2, 0.4, 0.6], device="cuda")
    _, slot_mask, _ = splat_tiles.bin_gaussians(xys, depths, radii, alive & (radii > 0), h, w, 16, 16, 512, 4)
    if bool(slot_mask.all(dim=1).any()):
        raise AssertionError("splat scan check: a tile reached capacity; the scene does not hold the comparison")
    with torch.no_grad():
        scan = sf.rasterize(xys, depths, conics, radii, opac, colors, alive, h, w, bg, chunk=256)
        tiles = splat_tiles.rasterize_tiles(xys, depths, conics, radii, opac, colors, alive, h, w, bg)
    tile_err = max(float((a - b).abs().max()) for a, b in zip(tiles[:2], scan[:2]))
    if tile_err > SPLAT_TILE_TOL:
        raise AssertionError(f"splat tiles against scan: max |err| {tile_err:.3e} (tol {SPLAT_TILE_TOL})")
    # the scan's chunks, depth-sorted, and seeded cotangents
    order = torch.sort(torch.where(alive & (radii > 0), depths, torch.full_like(depths, float("inf"))),
                       stable=True).indices
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda") + 0.5, torch.arange(w, device="cuda") + 0.5,
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    chunks = [t[order].reshape(n // 256, 256, *t.shape[1:]).clone()
              for t in (xys, conics, radii, opac * alive, colors, depths)]
    leaves = [c.requires_grad_(i != 2) for i, c in enumerate(chunks)]
    cot = [torch.tensor(r.normal(size=s), dtype=torch.float32, device="cuda") for s in ((h * w, 3), (h * w, 1), (h * w,))]
    diff = [leaves[i] for i in (0, 1, 3, 4, 5)]
    got = torch.autograd.grad(splat_compose.composite_chunks(pix, *leaves), diff, cot)
    want = torch.autograd.grad(splat_compose.composite_chunks_plain(pix, *leaves), diff, cot)
    errs = {name: rel_l2(a, b) for name, a, b in zip(("xys", "conics", "opacities", "colours", "depths"), got, want)}
    if max(errs.values()) > SPLAT_VJP_TOL:
        raise AssertionError(f"splat composite backward against the plain scan: {errs} (tol {SPLAT_VJP_TOL})")
    times = {
        "two-pass": cuda_ms(lambda: torch.autograd.grad(splat_compose.composite_chunks(pix, *leaves), diff, cot), 3),
        "plain": cuda_ms(lambda: torch.autograd.grad(splat_compose.composite_chunks_plain(pix, *leaves), diff, cot), 3),
    }
    log(f"splat tiles vs scan on the card ({w}x{h}, {n} gaussians, no tile at capacity): rgb and alpha max |err| "
        f"{tile_err:.3e} (tol {SPLAT_TILE_TOL}); scan two-pass backward vs autograd of the plain scan: rel L2 "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {SPLAT_VJP_TOL}); scan forward + backward "
        f"{times['two-pass']:.2f} ms, plain {times['plain']:.2f} ms ({smi})")
    return {"tile_err": tile_err, "vjp_errs": errs, **times}


def splat_phase(scene: Path, tmp: Path, smi: str) -> dict:
    """Phase 19a: splatfacto at the method's defaults on phase 15's RGB
    sphere scene (640x480 frames): 30 steps through ns-train, a step split,
    the splat ops timed on the trained model, a refinement run checked
    against the CPU, tiles vs scan and the scan's backward on the card, a
    frame card vs CPU, 640x512 and 1080p frames, ns-eval, ns-render of a
    camera path and ns-export gaussian-splat."""
    from nerfstudio_thermal_torch.configs.serialization import load_config
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.scripts import exporter as ns_export
    from nerfstudio_thermal_torch.scripts import render as ns_render_script
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    t_phase = time.perf_counter()
    result = {}
    run = classic_train("splatfacto", scene, tmp / "train", [], {}, steps=SPLAT_STEPS, timed_from=SPLAT_TIMED_FROM)
    trainer = run["trainer"]
    model = trainer.model
    cfg = model.config
    recs = run["records"]
    alive = int(trainer.state.extra.alive.sum())
    log(f"splatfacto train: {SPLAT_STEPS} steps through ns-train ({cfg.max_num_gaussians} slots, {alive} live, SH "
        f"degree {cfg.sh_degree}, tiles 16x16 capacity {cfg.tile_capacity} window {cfg.tile_window}, random "
        f"background), every loss finite, every group changed, no kernel launch; steps {SPLAT_TIMED_FROM}-"
        f"{SPLAT_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, peak memory {run['peak'] / 2**30:.2f} GiB; loss "
        f"{recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}, psnr {recs[0]['psnr']:.3f} -> {recs[-1]['psnr']:.3f} "
        f"({smi})")
    split = splat_step_split(trainer, SPLAT_STEPS)
    log("splatfacto step split (device timeline, CUDA events): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in split.items() if k not in ("wall", "busy", "host"))
        + f"; wall {split['wall']:.2f} ms, device busy {split['busy']:.2f} ms (torch.profiler), host "
        f"{split['host']:.2f} ms ({smi})")
    c2w = ring_pose(1, 8)
    ops = {label: splat_ops_phase(model, label, w, h, f, c2w, smi) for label, (w, h, f) in SPLAT_OPS.items()}
    frames = {}
    for label, (w, h, f) in SPLAT_RENDERS.items():
        cam = make_camera(w, h, f, c2w)
        model.render_camera_device(cam, 0)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = model.render_camera_device(cam, 0)
        torch.cuda.synchronize()
        frames[label] = time.perf_counter() - t0
        if any(read_counts().values()):
            raise AssertionError(f"splatfacto render {label}: kernel launches {read_counts()}")
        check_image_outputs(out, h, w, {"rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1})
        log(f"splatfacto render {label}: rgb, accumulation and depth finite; {frames[label]:.4f} s/frame ({smi})")
    # one frame of the trained model, card against CPU
    h, w = SPLAT_CHECK_HW
    cam = make_camera(w, h, 0.8 * w, c2w)
    card = model.render_camera_device(cam, 0)["rgb"].cpu()
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu = cpu_model.render_camera_device(cam, 0)["rgb"]
    frame_err = float((card - cpu).abs().max())
    if frame_err > SPLAT_FRAME_TOL:
        raise AssertionError(f"splatfacto frame card vs CPU: max |err| {frame_err:.3e} (tol {SPLAT_FRAME_TOL})")
    log(f"splatfacto frame {w}x{h} of the trained model, card vs CPU: rgb max |err| {frame_err:.3e} (tol "
        f"{SPLAT_FRAME_TOL})")
    del cpu_model, card, cpu
    result.update(scan=splat_scan_check(smi), ops=ops, frames=frames, split=split, frame_err=frame_err)

    # ns-eval, ns-render of a camera path and ns-export gaussian-splat of the run
    config_path = run["run"] / "config.yml"
    eval_s, scores = classic_eval("splatfacto", config_path, tmp / "eval.json", ("psnr_rgb", "ssim_rgb"))
    _, reloaded = eval_setup(config_path, device="cuda")
    path = write_camera_path(tmp / "path.json", reloaded.datamanager.eval_cameras, 3, (512, 640))
    del reloaded
    frames_dir = tmp / "render"
    reset_counts()
    t0 = time.perf_counter()
    if ns_render_script.main(["camera-path", "--load-config", str(config_path), "--camera-path-filename", str(path),
                              "--output-path", str(frames_dir / "frames"), "--rendered-output-names", "rgb",
                              "depth"]) != 0:
        raise AssertionError("splatfacto ns-render failed")
    render_s = time.perf_counter() - t0
    pngs = sorted(frames_dir.rglob("*.png"))
    if len(pngs) != 6 or any(decode_png(p).shape != (512, 640, 3) for p in pngs) or any(read_counts().values()):
        raise AssertionError(f"splatfacto ns-render: {len(pngs)} frames, launches {read_counts()}")
    t0 = time.perf_counter()
    if ns_export.main(["gaussian-splat", "--load-config", str(config_path), "--output-dir", str(tmp / "export")]) != 0:
        raise AssertionError("splatfacto ns-export gaussian-splat failed")
    export_s = time.perf_counter() - t0
    ply = (tmp / "export" / "splat.ply").read_bytes()
    vertices = int(re.search(rb"element vertex (\d+)", ply).group(1))
    if vertices != alive:
        raise AssertionError(f"splatfacto gaussian-splat: {vertices} vertices, {alive} alive")
    log(f"splatfacto ns-eval {eval_s:.2f} s (psnr_rgb {scores['psnr_rgb']:.3f}); ns-render camera-path 3 frames "
        f"640x512 (rgb, depth) {render_s:.2f} s; ns-export gaussian-splat {export_s:.2f} s, {vertices} vertices = "
        f"the alive count ({smi})")
    result.update(step_s=run["step_s"], peak=run["peak"], alive=alive, eval_s=eval_s, render_s=render_s,
                  export_s=export_s)
    del trainer, model, run
    torch.cuda.empty_cache()

    # refinement and an opacity reset on the card, each checked against the CPU
    checks = []
    with capturing_trainer(lambda t: splat_refine_checked(t, checks)):
        refine = classic_train("splatfacto", scene, tmp / "refine", SPLAT_REFINE_FLAGS, {}, steps=SPLAT_REFINE_STEPS,
                               timed_from=1)
    del refine["trainer"]
    if [c["step"] for c in checks] != [5, 10, 15] or not any(c["reset"] for c in checks) or not any(
            c["touched"] for c in checks):
        raise AssertionError(f"splatfacto refinement run: {checks}")
    for c in checks:
        log(f"splatfacto refinement at step {c['step']}: alive {c['alive_before']} -> {c['alive_after']} ({c['culled']} "
            f"culled, {c['touched']} rows touched){', opacity reset' if c['reset'] else ''}; the CPU's refinement of "
            f"the same state: the same alive mask, parameters max |err| {c['max_err']:.2e} (tol {SPLAT_REFINE_TOL}), "
            f"the same moments, zero in the touched rows; {c['card_s'] * 1e3:.1f} ms on the card ({smi})")
    torch.cuda.empty_cache()
    result["refinements"] = checks
    log(f"phase 19a splatfacto: {time.perf_counter() - t_phase:.1f} s")
    return result


@contextlib.contextmanager
def recording_samples(into: list):
    """While open, each generfacto forward's proposal sampling appends its
    (final samples, every proposal level's samples) to `into`."""
    from nerfstudio_thermal_torch.models import generfacto

    inner = generfacto.proposal_sample

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        into.append((out[0], out[2]))
        return out

    generfacto.proposal_sample = recorded
    try:
        yield
    finally:
        generfacto.proposal_sample = inner


@contextlib.contextmanager
def replaying_samples(recorded: list, device):
    """While open, each generfacto forward samples what `recording_samples`
    recorded (on `device`): every proposal net runs on the recorded
    samples of its level and weights them as proposal_sample does, so two
    devices' steps see the same sample positions. The hash grid's position
    gradient is piecewise constant, so a position ~1e-5 away (sampling on
    another device) may cross a cell face and turn a normal."""
    from nerfstudio_thermal_torch.cameras.rays import map_tensors
    from nerfstudio_thermal_torch.models import generfacto

    inner, queue = generfacto.proposal_sample, list(recorded)

    def replayed(bundle, density_fns, **kwargs):
        final, levels = queue.pop(0)
        move = lambda samples: map_tensors(samples, lambda t: t.to(device))  # noqa: E731
        samples = [move(s) for s in levels]
        return move(final), [s.get_weights(fn(s)) for s, fn in zip(samples, density_fns)], samples

    generfacto.proposal_sample = replayed
    try:
        yield
    finally:
        generfacto.proposal_sample = inner


def generfacto_draws(num_rays: int, levels: int):
    """Seeded draws of a generfacto step whose shaded branch runs (shade >
    0.75, choice > 0.5)."""
    r = np.random.default_rng(18)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return {"light": t(r.normal(size=3)), "shade": t(0.9), "background": t(r.uniform(size=3)), "choice": t(0.7),
            "uniforms": [t(r.uniform(size=(num_rays, 1))) for _ in range(levels)]}


def generfacto_step_vs_cpu(state: dict, tmp: Path) -> dict:
    """One full-width generfacto step with start_normals_training and
    start_lambertian_training at 0 (the VJP carries a nonzero cotangent)
    on the card and on the CPU's plain path, from the trained run's
    parameters, the same batch and draws, and the CPU's samples replayed
    on the card (`replaying_samples`): every loss within
    STEP_LOSS_TOL_F32, every group's gradient within STEP_GRAD_TOL_F32."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer

    out, samples = {}, []
    for device in ("cpu", "cuda"):
        method = get_method_config("generfacto")
        method.model.start_normals_training = method.model.start_lambertian_training = 0
        trainer = setup_trainer(method, base_dir=tmp / device, device=device)
        trainer.model.load_state_dict(state)
        trainer.setup()
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in trainer.datamanager.next_train(9).items()}
        levels = len(method.model.num_proposal_samples_per_ray) + 1
        draws = generfacto_draws(method.model.render_resolution ** 2, levels)
        draws = {k: [u.to(device) for u in v] if isinstance(v, list) else v.to(device) for k, v in draws.items()}
        c0 = read_counts()
        t0 = time.perf_counter()
        with recording_samples(samples) if device == "cpu" else replaying_samples(samples, device):
            scalars = trainer._train_step(trainer.state, batch, draws=draws)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v - c0[k] for k, v in read_counts().items()}
        grads = {g: [p.grad.detach().cpu() for p in ps] for g, ps in trainer.model.param_groups().items()}
        out[device] = ({k: float(v) for k, v in scalars.items()}, grads, launches, dt)
        del trainer
    (cpu_s, cpu_g, _, cpu_dt), (card_s, card_g, launches, card_dt) = out["cpu"], out["cuda"]
    if launches != expected_counts(GEN_STEP):
        raise AssertionError(f"generfacto card step: launches {launches}, expected {GEN_STEP}")
    losses = {k: abs(card_s[k] - w) / max(abs(w), 1e-3) for k, w in cpu_s.items()}
    groups = {g: rel_l2(torch.cat([t.reshape(-1) for t in card_g[g]]), torch.cat([t.reshape(-1) for t in w]))
              for g, w in cpu_g.items()}
    if max(losses.values()) > STEP_LOSS_TOL_F32 or max(groups.values()) > STEP_GRAD_TOL_F32:
        raise AssertionError(f"generfacto step card vs CPU: losses {losses}, groups {groups}")
    if not cpu_s["orientation_loss"] > 0:
        raise AssertionError(f"generfacto step: orientation_loss {cpu_s['orientation_loss']} (the normals' term off)")
    log("generfacto step card vs CPU (normals and shading on, shaded branch, the CPU's samples): losses rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in losses.items()) + f" (tol {STEP_LOSS_TOL_F32}); groups rel L2 "
        + ", ".join(f"{k} {v:.2e}" for k, v in groups.items()) + f" (tol {STEP_GRAD_TOL_F32}); launches {GEN_STEP}; "
        f"CPU {cpu_dt:.1f} s, card {card_dt * 1e3:.1f} ms")
    return {"losses": losses, "groups": groups}


def generfacto_phase(tmp: Path, smi: str) -> dict:
    """Phase 19b: generfacto at the JAX config's widths (64 x 64 render,
    (256, 96) + 48 samples, the field L12 T 2^19, proposals L5 T 2^17, f32,
    ColorMatch guidance): 30 steps through ns-train without --data (rows
    8, 7, 10 and the VJP each step), a profiled step by kernel, step 9's
    hash and VJP calls on the model's points, a card-vs-CPU step with the
    normals and shading on, and ns-render of the eval ring."""
    from nerfstudio_thermal_torch.data.datasets import decode_png
    from nerfstudio_thermal_torch.scripts import render as ns_render_script

    t_phase = time.perf_counter()
    run = classic_train("generfacto", None, tmp, [], GEN_STEP, steps=GEN_STEPS, capture_step=GEN_CAPTURE_STEP,
                        timed_from=GEN_TIMED_FROM)
    trainer = run.pop("trainer")
    hash_calls, vjp_calls = run.pop("hash"), run.pop("vjp")
    run.pop("mlp")
    cfg = trainer.model.config
    levels = sorted(rec["scal"].shape[0] for rec in hash_calls)
    if levels != sorted([cfg.num_levels] + [a["num_levels"] for a in cfg.proposal_net_args_list]) or len(
            vjp_calls) != 1 or vjp_calls[0]["scal"].shape[0] != cfg.num_levels:
        raise AssertionError(f"generfacto step {GEN_CAPTURE_STEP}: hash calls of {levels} levels, {len(vjp_calls)} VJP "
                             f"calls; expected both proposals, the field and one VJP of the field's grid")
    recs = run["records"]
    rays = cfg.render_resolution ** 2
    log(f"generfacto train: {GEN_STEPS} steps through ns-train without --data ({rays} rays a step, "
        f"{tuple(cfg.num_proposal_samples_per_ray)} + {cfg.num_nerf_samples_per_ray} samples, field L{cfg.num_levels} "
        f"T2^{cfg.log2_hashmap_size}, f32, {cfg.diffusion_model} guidance), every loss finite, every group changed, "
        f"launches a step {GEN_STEP} ({dict((k, v) for k, v in run['counts'].items() if v)} in all); steps "
        f"{GEN_TIMED_FROM}-{GEN_STEPS - 1}: {run['step_s'] * 1e3:.2f} ms/step, peak memory "
        f"{run['peak'] / 2**30:.2f} GiB; loss {recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}, sds "
        f"{recs[0]['sds_loss']:.4f} -> {recs[-1]['sds_loss']:.4f} ({smi})")
    # a profiled step: each kernel's device ms, and the launches of the step
    c0 = read_counts()
    split = kernel_split(lambda: trainer.train_iteration(GEN_STEPS), iters=1)
    launches = {k: (v - c0[k]) // 2 for k, v in read_counts().items()}
    if launches != expected_counts(GEN_STEP):
        raise AssertionError(f"generfacto profiled step: launches {launches}, expected {GEN_STEP}")
    kernels = {k: sum(ms for name, ms in split.items() if name == kname or name.startswith(kname + "<"))
               for k, kname in GEN_KERNELS.items()}
    if not all(kernels.values()):
        raise AssertionError(f"generfacto profiled step: kernels {kernels} (each must have run)")
    busy = sum(split.values())
    log(f"generfacto profiled step: device busy {busy:.2f} ms, the hash kernels "
        + ", ".join(f"{k} {v:.3f} ms ({GEN_STEP[k]} launch{'es' if GEN_STEP[k] > 1 else ''})"
                    for k, v in kernels.items()) + f", other kernels {busy - sum(kernels.values()):.2f} ms ({smi})")
    state = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    result = {"counts": run["counts"], "step_s": run["step_s"], "peak": run["peak"], "busy": busy,
              "kernels": kernels,
              "hash": hash_model_phase({f"generfacto train step {GEN_CAPTURE_STEP}": hash_calls}),
              "vjp": vjp_model_phase(f"generfacto train step {GEN_CAPTURE_STEP}", vjp_calls)}
    del hash_calls, vjp_calls
    result["step_vs_cpu"] = generfacto_step_vs_cpu(state, tmp / "step")
    # ns-render of the eval ring
    frames = tmp / "ring"
    reset_counts()
    t0 = time.perf_counter()
    if ns_render_script.main(["dataset", "--load-config", str(run["run"] / "config.yml"), "--output-path", str(frames),
                              "--rendered-output-names", "rgb", "depth", "normals"]) != 0:
        raise AssertionError("generfacto ns-render failed")
    render_s = time.perf_counter() - t0
    pngs = sorted(frames.rglob("*.png"))
    res = cfg.render_resolution
    want = expected_counts(GEN_FRAME, 8)
    if len(pngs) != 24 or any(decode_png(p).shape != (res, res, 3) for p in pngs) or read_counts() != want:
        raise AssertionError(f"generfacto ns-render: {len(pngs)} frames, launches {read_counts()}, expected {want}")
    result.update(render_counts=read_counts(), render_s=render_s)
    log(f"generfacto ns-render dataset: the 8 eval-ring cameras at {res}x{res} (rgb, depth, normals), launches "
        f"{GEN_FRAME} a frame, {render_s:.2f} s through the command ({smi})")
    log(f"phase 19b generfacto: {time.perf_counter() - t_phase:.1f} s")
    return result


# Phase 20: the web viewer. ns-viewer (scripts/viewer.serve, as
# ns-viewer-torch runs it) on phase 11's run of each method, driven over the
# port's own websocket client: the outputs greeting, the whole resolution
# ladder of a 16:9 camera at width 1920, each frame byte-equal to the JPEG
# of a direct render of the same camera, stale refinements dropped, a split
# view, a depth colormap, a point cloud export and a saved camera path; each
# frame's launches must be the method's per-chunk launches times its
# chunks. Then ns-train --vis viewer: pause, one granted step, a 512 frame
# while paused, resume.
VIEWER_METHODS = ("thermal-nerfacto", "thermal-nerfacto-tpu", "thermal-nerfacto-tpu+fused")
VIEWER_TRAIN_METHOD = "thermal-nerfacto"
VIEWER_TRAIN_STEPS = 20
VIEWER_TIMEOUT = 120.0  # seconds for any one websocket message
VIEWER_EYES = ([2.6, 1.2, 0.9], [1.4, -2.4, 0.7], [-2.2, 1.6, 1.1])
VIEWER_LADDER = (256, 512, 1024, 1920)  # viewer/server.py's RESOLUTION_BUCKETS


def viewer_camera(c2w, width: int, **extra) -> str:
    return json.dumps({"type": "camera", "c2w": c2w.tolist(), "width": width, "aspect": 16 / 9, **extra})


async def viewer_recv(client, kind=None):
    """The next message (of `kind`, skipping others when given): a dict for
    text, bytes for binary."""
    while True:
        raw = await asyncio.wait_for(client.recv(), VIEWER_TIMEOUT)
        msg = json.loads(raw) if isinstance(raw, str) else raw
        if kind is None or (isinstance(msg, dict) and msg.get("type") == kind):
            return msg


async def viewer_frame(client):
    stats = await viewer_recv(client, "stats")
    if "error" in stats:
        raise AssertionError(f"viewer render failed: {stats}")
    jpeg = await asyncio.wait_for(client.recv(), VIEWER_TIMEOUT)
    if not isinstance(jpeg, bytes):
        raise AssertionError(f"viewer sent {jpeg!r} where a JPEG was due")
    return stats, jpeg


def viewer_method(name: str, run: Path, encode_ms: dict, smi: str) -> dict:
    """ns-viewer on one run, as the module comment above describes."""
    from nerfstudio_thermal_torch.configs.serialization import load_config
    from nerfstudio_thermal_torch.data.jpeg import decode_jpeg_bytes
    from nerfstudio_thermal_torch.exporter.exporter_utils import read_ply
    from nerfstudio_thermal_torch.scripts import viewer as ns_viewer
    from nerfstudio_thermal_torch.viewer import server as vs
    from nerfstudio_thermal_torch.viewer import websocket as ws

    chunk = load_config(run / "config.yml").model.eval_num_rays_per_chunk
    low, top = VIEWER_LADDER[0], VIEWER_LADDER[-1]
    per_chunk = METHODS[name]["chunk"]
    t0 = time.perf_counter()
    server = ns_viewer.serve(run / "config.yml", vs.free_port_pair())
    setup_s = time.perf_counter() - t0
    direct = server.render_fn
    frames = []  # every render the server made: size, output, launches, ms

    def counted(c2w, width, height, output, **kwargs):
        before = read_counts()
        t = time.perf_counter()
        img = direct(c2w, width, height, output, **kwargs)  # ends with the host copy
        ms = (time.perf_counter() - t) * 1e3
        after = read_counts()
        frames.append({"width": width, "height": height, "output": output, "ms": ms,
                       "launches": {k: after[k] - before[k] for k in after}})
        return img

    server.render_fn = counted
    cams = [look_at(np.asarray(e, np.float32))[:3] for e in VIEWER_EYES]

    async def drive():
        client = await ws.connect(f"ws://127.0.0.1:{server.port + 1}/")
        out = {"hello": await viewer_recv(client)}
        t_send = time.perf_counter()
        await client.send(viewer_camera(cams[0], top))
        ladder, first = [], None
        for _ in VIEWER_LADDER:
            ladder.append(await viewer_frame(client))
            first = first or (time.perf_counter() - t_send) * 1e3
        out["ladder"], out["first_frame_ms"] = ladder, first
        # a second camera, then a third while the second climbs: the second's
        # refinements are dropped
        await client.send(viewer_camera(cams[1], top))
        stale = [await viewer_frame(client)]
        await client.send(viewer_camera(cams[2], top))
        while not stale[-1][0]["final"]:
            stale.append(await viewer_frame(client))
        out["stale"] = stale
        await client.send(viewer_camera(cams[0], low, output="rgb", output_split="depth", split_fraction=0.4))
        out["split"] = await viewer_frame(client)
        cmap = {"name": "turbo", "invert": True}
        await client.send(viewer_camera(cams[0], low, output="depth", colormap=cmap))
        out["depth"] = await viewer_frame(client)
        await client.send(json.dumps({"type": "export", "kind": "pointcloud"}))
        out["export"] = await viewer_recv(client, "exported")
        await client.send(json.dumps({"type": "save_path", "keyframes": [c.tolist() for c in cams], "fps": 10,
                                      "seconds": 2.0}))
        out["saved"] = await viewer_recv(client, "saved")
        await client.close()
        return out

    try:
        got = asyncio.run(asyncio.wait_for(drive(), 10 * VIEWER_TIMEOUT))
    finally:
        server.stop()
    names = got["hello"].get("names", [])
    if got["hello"].get("type") != "outputs" or names != server.output_names or names[:1] != ["rgb"] \
            or "rgb_thermal" not in names:
        raise AssertionError(f"{name}: viewer greeting {got['hello']}, probed {server.output_names}")
    sent = [(s["seq"], s["width"], s["final"]) for s, _ in got["ladder"] + got["stale"]]
    want = ([(1, w, w == top) for w in VIEWER_LADDER] + [(2, low, False)]
            + [(3, w, w == top) for w in VIEWER_LADDER])
    if sent != want:
        raise AssertionError(f"{name}: frames sent {sent}, expected {want} (stale refinements dropped)")
    rendered = [(f["width"], f["output"]) for f in frames[:10]]
    if rendered[4:6] != [(low, "rgb"), (VIEWER_LADDER[1], "rgb")]:
        raise AssertionError(f"{name}: the second camera's renders {rendered[4:6]}: its 512 refinement, rendered "
                             "while the third camera arrived, should be the one dropped")
    # every frame byte-equal to the JPEG of a direct render of its camera
    checks = [(cams[0], s, j, "rgb", {}) for s, j in got["ladder"]]
    checks += [(cams[2], s, j, "rgb", {}) for s, j in got["stale"][1:]]
    checks.append((cams[0], *got["depth"], "depth", {"colormap": {"name": "turbo", "invert": True}}))
    images = {}
    checks_from = read_counts()  # the direct renders below are comparisons: left out of the phase's counts
    for c2w, stats, jpeg, output, kwargs in checks:
        w, h = stats["width"], stats["height"]
        img = direct(c2w, w, h, output, **kwargs)
        if jpeg != vs.to_jpeg(img):
            raise AssertionError(f"{name}: the viewer's {w}x{h} {output} frame differs from the JPEG of a direct "
                                 "render of its camera")
        if decode_jpeg_bytes(jpeg).shape != (h, w, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name}: the {w}x{h} frame decodes to the wrong shape or is not finite")
        images[(w, output)] = img
    split_stats, split_jpeg = got["split"]
    split = vs.ViewerServer(direct, [])._render_split(cams[0], low, split_stats["height"], "rgb", None, 60.0,
                                                       "depth", 0.4)
    if split_jpeg != vs.to_jpeg(split):
        raise AssertionError(f"{name}: the split frame differs from a direct split render")
    checks_to = read_counts()
    check_launches = {k: checks_to[k] - checks_from[k] for k in checks_to}
    if "error" in got["export"] or "error" in got["saved"]:
        raise AssertionError(f"{name}: export {got['export']}, save_path {got['saved']}")
    points, colors = read_ply(Path(got["export"]["path"]))
    if len(points) == 0 or not np.isfinite(points).all():
        raise AssertionError(f"{name}: the viewer's point cloud holds {len(points)} points")
    path_frames = len(json.loads(Path(got["saved"]["path"]).read_text())["camera_path"])
    if path_frames != 20:
        raise AssertionError(f"{name}: the saved camera path has {path_frames} frames, not 20")
    # launches: each render is the method's per-chunk launches times its chunks
    for f in frames:
        n_chunks = -(-f["width"] * f["height"] // chunk)
        want_counts = expected_counts(per_chunk, n_chunks)
        if f["launches"] != want_counts:
            raise AssertionError(f"{name}: a {f['width']}x{f['height']} {f['output']} viewer render launched "
                                 f"{f['launches']}, expected {want_counts}")
    buckets = {}
    for (stats, _), f in zip(got["ladder"], frames[:4]):
        w = stats["width"]
        buckets[w] = {"height": stats["height"], "render_ms": stats["render_ms"], "fn_ms": f["ms"],
                      "encode_ms": encode_ms[name][w][0],
                      "launches": {k: v for k, v in f["launches"].items() if v}}
    line = "; ".join(f"{w}x{b['height']} render {b['render_ms']:.1f} ms (render fn {b['fn_ms']:.1f}), encode "
                     f"{b['encode_ms']:.2f} ms, launches {b['launches']}" for w, b in buckets.items())
    log(f"viewer {name}: ns-viewer setup {setup_s:.2f} s; camera to first frame {got['first_frame_ms']:.1f} ms; "
        f"{line}; stale refinement dropped; frames byte-equal to direct renders; split, depth colormap, "
        f"export ({len(points)} points) and camera path ({path_frames} frames) ({smi})")
    return {"buckets": buckets, "first_frame_ms": got["first_frame_ms"], "setup_s": setup_s,
            "image_top": images[(top, "rgb")], "renders": len(frames), "check_launches": check_launches}


def viewer_train(scene_dir: Path, out_dir: Path, smi: str) -> dict:
    """ns-train --vis viewer (phase 20b): pause, one granted step, a 512
    frame while paused, resume; every logged loss finite."""
    from nerfstudio_thermal_torch.scripts import train as ns_train
    from nerfstudio_thermal_torch.viewer import server as vs
    from nerfstudio_thermal_torch.viewer import websocket as ws

    port = vs.free_port_pair()
    argv = [VIEWER_TRAIN_METHOD, "--data", str(scene_dir), "--max-num-iterations", str(VIEWER_TRAIN_STEPS),
            "--output-dir", str(out_dir), "--vis", "viewer", "--viewer-port", str(port),
            "--trainer.steps-per-log", "1"]
    result = {}

    def run():
        try:
            result["rc"] = ns_train.main(argv)
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            result["error"] = e

    async def status(client):
        await client.send(json.dumps({"type": "train_control", "action": "status"}))
        return await viewer_recv(client, "train_state")

    async def drive():
        for _ in range(600):  # ns-train sets up the run before the viewer listens
            if "error" in result:
                raise result["error"]
            try:
                client = await ws.connect(f"ws://127.0.0.1:{port + 1}/")
                break
            except OSError:
                await asyncio.sleep(0.5)
        else:
            raise AssertionError("ns-train's viewer never came up")
        stats = []
        await viewer_recv(client, "outputs")
        while not stats or stats[-1]["step"] < 3:
            stats.append(await viewer_recv(client, "train_stats"))
        await client.send(json.dumps({"type": "train_control", "action": "pause"}))
        if not (await viewer_recv(client, "train_state"))["paused"]:
            raise AssertionError("pause did not take")
        await asyncio.sleep(1.0)
        held = (await status(client))["step"]
        await asyncio.sleep(1.5)
        if (await status(client))["step"] != held:
            raise AssertionError("training went on while paused")
        await client.send(json.dumps({"type": "train_control", "action": "step"}))
        await viewer_recv(client, "train_state")
        for _ in range(300):
            if (await status(client))["step"] == held + 1:
                break
            await asyncio.sleep(0.1)
        await asyncio.sleep(1.0)
        granted = await status(client)
        if granted["step"] != held + 1 or not granted["paused"]:
            raise AssertionError(f"a step grant while paused ran to step {granted['step']}, not {held + 1}")
        t = time.perf_counter()
        await client.send(viewer_camera(look_at(np.asarray(VIEWER_EYES[0], np.float32))[:3], VIEWER_LADDER[1]))
        paused_frames = [await viewer_frame(client)]
        while not paused_frames[-1][0]["final"]:
            paused_frames.append(await viewer_frame(client))
        paused_ms = (time.perf_counter() - t) * 1e3
        if [s["width"] for s, _ in paused_frames] != list(VIEWER_LADDER[:2]) or (await status(client))["step"] != held + 1:
            raise AssertionError("the 512 ladder while paused failed or training moved")
        await client.send(json.dumps({"type": "train_control", "action": "resume"}))
        if (await viewer_recv(client, "train_state"))["paused"]:
            raise AssertionError("resume did not take")
        try:  # train_stats until training ends and the viewer closes
            while True:
                msg = await viewer_recv(client)
                if isinstance(msg, dict) and msg.get("type") == "train_stats":
                    stats.append(msg)
        except ws.ConnectionClosed:
            pass
        return {"stats": stats, "steps": [s["step"] for s in stats], "held": held, "paused_ms": paused_ms}

    reset_counts()
    thread = threading.Thread(target=run)
    t0 = time.perf_counter()
    thread.start()
    try:
        got = asyncio.run(asyncio.wait_for(drive(), 20 * VIEWER_TIMEOUT))
    finally:
        thread.join(20 * VIEWER_TIMEOUT)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    if "error" in result:
        raise result["error"]
    if result.get("rc") != 0 or thread.is_alive():
        raise AssertionError(f"ns-train --vis viewer returned {result.get('rc')}")
    (run,) = out_dir.glob(f"*/{VIEWER_TRAIN_METHOD}/*/events.jsonl")
    losses = [r["train/loss"] for r in map(json.loads, run.read_text().splitlines()) if "train/loss" in r]
    if len(losses) != VIEWER_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ns-train --vis viewer logged losses {losses}")
    if any("loss" not in s or not math.isfinite(s["loss"]) for s in got["stats"]):
        raise AssertionError(f"a train_stats message lacks a finite loss: {got['stats']}")
    if got["steps"] != sorted(got["steps"]) or max(got["steps"]) <= got["held"] + 1:
        raise AssertionError(f"train_stats steps {got['steps']}")
    idle = [k for k in ("hash_encode_fwd", "hash_encode_bwd_table", "hash_encode_bwd_pos") if counts[k] == 0]
    if idle:
        raise AssertionError(f"ns-train --vis viewer launched no {idle}")
    log(f"viewer ns-train --vis viewer ({VIEWER_TRAIN_METHOD}): {VIEWER_TRAIN_STEPS} steps in {wall_s:.1f} s with "
        f"a pause at step {got['held']}, one granted step, a 256 + 512 ladder while paused in "
        f"{got['paused_ms']:.1f} ms; {len(got['stats'])} train_stats, losses finite; launches "
        f"{ {k: v for k, v in counts.items() if v} } ({smi})")
    return {"counts": counts, "wall_s": wall_s, "paused_ms": got["paused_ms"]}


def viewer_phase(entries: dict, scene_dir: Path, out_dir: Path, smi: str) -> dict:
    """Phase 20: ns-viewer on each of VIEWER_METHODS' phase-11 runs (launches
    counted from 0 over all of them), ns-train --vis viewer, and the time of
    encode_jpeg on a 1920x1080 render (host)."""
    from nerfstudio_thermal_torch.data.jpeg import encode_jpeg, load_encoder
    from nerfstudio_thermal_torch.viewer import server as vs

    # the encoder's library builds with g++ at first use: built here, so the
    # frames' encode ms are steady-state
    t = time.perf_counter()
    load_encoder()
    log(f"viewer: JPEG encoder built and loaded in {time.perf_counter() - t:.2f} s (host, first use)")
    if tuple(vs.RESOLUTION_BUCKETS) != VIEWER_LADDER:
        raise AssertionError(f"the viewer's buckets are {vs.RESOLUTION_BUCKETS}, the phase expects {VIEWER_LADDER}")
    encode_ms = {}
    current = {}
    plain_to_jpeg = vs.to_jpeg

    def timed_to_jpeg(img):
        t = time.perf_counter()
        out = plain_to_jpeg(img)
        encode_ms.setdefault(current["name"], {}).setdefault(img.shape[1], []).append((time.perf_counter() - t) * 1e3)
        return out

    reset_counts()
    out = {}
    vs.to_jpeg = timed_to_jpeg
    try:
        for name in VIEWER_METHODS:
            current["name"] = name
            out[name] = viewer_method(name, entries[name]["run"], encode_ms, smi)
    finally:
        vs.to_jpeg = plain_to_jpeg
    counts = {k: v - sum(out[name]["check_launches"][k] for name in VIEWER_METHODS) for k, v in read_counts().items()}
    path_kernels = sorted({k for name in VIEWER_METHODS for k in METHODS[name]["chunk"]})
    idle = [k for k in path_kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"the viewer's renders launched no {idle} (launches {counts})")
    out["counts"] = counts
    out["train"] = viewer_train(scene_dir, out_dir / "train", smi)
    img = (np.clip(out[VIEWER_METHODS[0]]["image_top"], 0, 1) * 255).astype(np.uint8)
    times = []
    for _ in range(5):
        t = time.perf_counter()
        encode_jpeg(img)
        times.append((time.perf_counter() - t) * 1e3)
    out["encode_1080_ms"] = float(np.median(times))
    log(f"viewer: encode_jpeg of a 1920x1080 {VIEWER_METHODS[0]} render {out['encode_1080_ms']:.2f} ms (median of 5, "
        f"host) ({smi})")
    return out


# Phase 21: data-parallel training (parallel/mesh.py) and multi-scene
# training (engine/multi_scene.py) at full width. 21a: each method's
# PAR_STEPS steps plain and in a one-rank NCCL group (the data-parallel
# path: shard, contributions, all-reduces), step 0's loss bitwise, the
# rest within phase 9's limit, the same launches. 21b: two gloo ranks
# sharing the card (processes of this script, `--dp-rank`), the global
# batch of 8192 rays split 4096 / 4096, against a plain run; on
# thermal-nerfacto-tpu the cross-density prefix (2048 rays) lies in rank
# 0's rows, so rank 1 launches the base MLP twice a step, not 4 times.
# 21c: ns-train thermal-nerfacto --data A,B for MULTI_STEPS steps, against
# ns-train --data A (scene 0), then ns-eval of each scene. 21b and 21c
# compare runs whose gradients are summed in other orders (two ranks; the
# hash table gradient's atomics), so they run with f32 compute, where the
# trajectories part by f32 roundings only and every loss of every step
# holds phase 9's limit: in bf16 a small term moved 2.9% by step 9 (21b)
# and 1.2% by step 19 (21c). 21b also holds the ranks' parameters after
# the steps: equal on the two ranks, and against the plain run's by
# tests/test_torch_parallel.py's flip rule on each group's update.
PAR_METHODS = ("thermal-nerfacto", "thermal-nerfacto-tpu")
PAR_KERNELS = {"thermal-nerfacto": ("hash_encode_fwd", "hash_encode_bwd_table", "hash_encode_bwd_pos"),
               "thermal-nerfacto-tpu": ("fused_mlp_fwd", "fused_mlp_bwd")}
PAR_STEPS, PAR_TIMED_FROM = 10, 3
PAR_RANK_TIMEOUT = 420  # seconds for a 21b rank
PAR_RENDEZVOUS_ATTEMPTS = 3  # ports tried for 21b's store: another process may take a free port first
MULTI_STEPS = 20
# 21b's parameters. Step 0's summed gradient, each optimizer group's,
# against the plain step's within phase 9's f32 limits (relative L2:
# STEP_GRAD_TOL_F32, the camera groups STEP_CAMERA_GRAD_TOL_F32): both
# runs start from the same parameters and rays. After the steps,
# tests/test_torch_parallel.py's flip rule on each group's update: an
# entry whose update differs from the plain run's by more than PAR_FLIP
# of the group's largest update moved the other way (Adam moves an entry
# whose gradient is rounding noise by ~lr either way); fewer than
# PAR_MAX_FLIPPED of a group's entries may, and the others' updates hold
# PAR_PARAM_TOL relative L2. The camera groups' updates are logged, not
# held: step 0's camera gradients agreed exactly in every run, but after
# 10 steps 1.0-14.6% of camera_opt's and 18.8-44.8% of
# camera_opt_thermal's entries had moved the other way (four runs; the
# field and proposal groups 0-12.5%). The scene's poses are exact, so the
# pose gradients are small and their signs follow the other groups'
# rounding-sized differences, and Adam (eps 1e-15) moves each entry by
# about lr whatever its gradient's size.
PAR_FLIP, PAR_MAX_FLIPPED, PAR_PARAM_TOL = 1e-3, 0.25, 1e-3


def dp_run(name: str, scene: Path, run_dir: Path, mesh=None, time_all_reduce: bool = False, f32: bool = False,
           params_to: Path = None, method=None, steps: int = PAR_STEPS, timed_from: int = PAR_TIMED_FROM) -> dict:
    """`steps` full-width steps of a method (`method`, else
    train_method(name, scene)) through setup_trainer and
    Trainer.train_iteration on `mesh` (default: create_mesh's, the process
    group's when one runs), with f32 compute where asked: each step's global
    losses, the launches (counts zeroed just before the steps, read just
    after), ms/step from step `timed_from` (a float of each step's scalars
    ends it), peak memory, and with time_all_reduce the gradient
    all-reduce's ms a step (synchronised around it) and the bytes it
    reduces. `params_to` gets each optimizer group's trained parameters,
    flat, before and after the steps, and their gradients at step 0 as the
    optimizers take them (summed over the ranks; rank 0's for a replicated
    step)."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.engine import trainer as trainer_lib
    from nerfstudio_thermal_torch.parallel.mesh import grad_bytes

    method = method if method is not None else train_method(name, scene)
    if f32 and hasattr(method.model, "compute_dtype"):
        method.model.compute_dtype = "float32"
    trainer = setup_trainer(method, base_dir=run_dir, device="cuda", mesh=mesh)
    trainer.setup()

    def group_params(grad: bool = False) -> dict:
        def flat(p):
            t = (p.grad if p.grad is not None else torch.zeros_like(p)) if grad else p
            return t.detach().reshape(-1)

        return {g: torch.cat([flat(p) for p in opt.params if p.requires_grad]).cpu()
                for g, opt in trainer.optimizers.groups.items()}

    init, grads0, optimizer_step = None, {}, trainer.optimizers.step
    if params_to is not None:
        init = group_params()

        def step_and_keep_grads():
            if not grads0:
                grads0.update(group_params(grad=True))
            return optimizer_step()

        trainer.optimizers.step = step_and_keep_grads
    reduce_s, original = [], trainer_lib.all_reduce_grads

    def timed_all_reduce(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = original(params)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        return nbytes

    if time_all_reduce:
        trainer_lib.all_reduce_grads = timed_all_reduce
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            scalars = trainer.train_iteration(step)
            losses.append({k: float(v) for k, v in scalars.items()})
            step_s.append(time.perf_counter() - t0)
        counts = read_counts()
    finally:
        trainer_lib.all_reduce_grads = original
    if params_to is not None:
        trainer.optimizers.step = optimizer_step
        torch.save({"init": init, "final": group_params(), "grads0": grads0}, params_to)
    bad = [(i, k) for i, rec in enumerate(losses) for k, v in rec.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{name}: non-finite scalars {bad[:5]}")
    timed = step_s[timed_from:]
    out = {
        "losses": losses, "counts": counts, "ms": 1e3 * sum(timed) / len(timed), "peak": torch.cuda.max_memory_allocated(),
        "grad_bytes": grad_bytes(trainer_lib.trained_params(trainer.optimizers)),
        "reduce_ms": 1e3 * sum(reduce_s[timed_from:]) / len(timed) if reduce_s else None,
        "rays": None if trainer._whole_batch() else method.datamanager.train_num_rays_per_batch,
    }
    del trainer
    torch.cuda.empty_cache()
    return out


def is_loss(key: str) -> bool:
    return key == "loss" or key.endswith("_loss") or key.startswith("camera_opt_regularizer")


def check_dp_losses(label: str, got: list, want: list, step0_bitwise: bool) -> float:
    """Step 0's scalars and the later steps' losses within phase 9's loss
    limit (STEP_LOSS_TOL relative to max(|value|, 1e-3)); step 0's loss
    bitwise where asked.
    Phase 9's limit is a step's from the same parameters; the later steps'
    metrics (the camera adjustments' norms, the PSNRs) are left out: they
    follow parameters that several bf16 steps have moved apart (Adam
    moves a parameter whose gradient is rounding noise either way).
    Returns the largest relative difference."""
    worst = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"{label} step {step}: scalars {sorted(set(g) ^ set(w))} differ")
        if step == 0 and step0_bitwise and g["loss"] != w["loss"]:
            raise AssertionError(f"{label}: step 0's loss {g['loss']!r} is not the plain step's {w['loss']!r}")
        for k in (w if step == 0 else [k for k in w if is_loss(k)]):
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-3)
            worst = max(worst, rel)
            if rel > STEP_LOSS_TOL:
                raise AssertionError(f"{label} step {step} {k}: {g[k]} against {w[k]}")
    return worst


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30))


def check_dp_params(label: str, got: dict, want: dict) -> dict:
    """A run's saved parameters (dp_run's `params_to`) against the plain
    run's: step 0's gradients and, by the flip rule, the updates (see
    PAR_FLIP); returns each group's (gradient rel L2, flipped share, the
    other updates' rel L2)."""
    if set(got["final"]) != set(want["final"]) or set(got["grads0"]) != set(want["final"]):
        raise AssertionError(f"{label}: groups {sorted(got['final'])} against {sorted(want['final'])}")
    readings = {}
    for g in want["final"]:
        camera = "camera_opt" in g
        grad_err = rel_l2(got["grads0"][g].double(), want["grads0"][g].double())
        got_d, want_d = (got["final"][g] - want["init"][g]).double(), (want["final"][g] - want["init"][g]).double()
        flipped = (got_d - want_d).abs() > PAR_FLIP * want_d.abs().max()
        share = float(flipped.double().mean())
        err = rel_l2(got_d[~flipped], want_d[~flipped])
        readings[g] = (grad_err, share, err)
        if grad_err > (STEP_CAMERA_GRAD_TOL_F32 if camera else STEP_GRAD_TOL_F32) or (
            not camera and (share >= PAR_MAX_FLIPPED or err > PAR_PARAM_TOL)
        ):
            raise AssertionError(f"{label} {g}: step 0's gradient rel L2 {grad_err:.3g}; {share:.3%} of the updates "
                                 f"flipped, the others' rel L2 {err:.3g} (the groups so far: {readings})")
    return readings


# 21d: every other method (thermal-nerfacto-tpu is 21a's) at its ns-train
# defaults on the scene an earlier phase trained it on, DP_STEPS steps
# plain and in a one-rank NCCL group: step 0's loss bitwise, the scalars
# within phase 9's limit (check_dp_losses), the same launches, and each
# DP_KERNELS kernel launched. vanilla-nerf and mipnerf with use_pallas (as
# phase 16), depth-nerfacto without pose auto-scaling (phase 16's flag).
# Then DP_GLOO_METHODS in 21b's two gloo ranks (f32 compute) against plain
# runs: the ranks' parameters equal (splatfacto's replicated step takes
# rank 0's gradients), the updates by the flip rule.
DP_METHODS = ("nerfacto", "nerfacto-tpu", "nerfacto-big", "nerfacto-huge", "depth-nerfacto", "semantic-nerfw",
              "instant-ngp", "instant-ngp-bounded", "vanilla-nerf", "mipnerf", "tensorf", "neus", "neus-facto",
              "splatfacto", "generfacto")
DP_GLOO_METHODS = ("nerfacto", "splatfacto")
DP_STEPS, DP_TIMED_FROM = 3, 1
_HASH_STEP = ("hash_encode_fwd", "hash_encode_bwd_table", "hash_encode_bwd_pos")
DP_KERNELS = {
    **{m: _HASH_STEP for m in ("nerfacto", "nerfacto-big", "nerfacto-huge", "depth-nerfacto", "semantic-nerfw")},
    **{m: ("fused_mlp_fwd", "fused_mlp_bwd") for m in ("nerfacto-tpu", "vanilla-nerf", "mipnerf")},
    **{m: ("hash_encode_fwd", "hash_encode_bwd_table") for m in ("instant-ngp", "instant-ngp-bounded")},
    **{m: _HASH_STEP + ("hash_encode_bwd_pos_vjp",) for m in ("neus-facto", "generfacto")},
    **{m: () for m in ("tensorf", "neus", "splatfacto")},  # no kernel of the TPU's on their path
}
# each method's scene: earlier phases' (phases 13, 15, 16, 17 and 19)
DP_SCENE = {
    **{m: "rgb" for m in ("nerfacto", "nerfacto-tpu", "nerfacto-big", "nerfacto-huge")},
    **{m: "ngp" for m in ("instant-ngp", "neus", "neus-facto", "splatfacto")},
    "instant-ngp-bounded": "ingp", "depth-nerfacto": "depth", "semantic-nerfw": "sitcoms",
    **{m: "blender" for m in ("vanilla-nerf", "mipnerf", "tensorf")}, "generfacto": None,
}


def dp_scenes(tmp: Path, rgb: Path, ngp: Path, ingp: Path) -> dict:
    """DP_SCENE's scenes: phase 16's blender and depth scenes and phase
    17's Sitcoms3D scene where those phases wrote them under `tmp`, else
    written here."""
    found = {"blender": (tmp / "classic" / "blender", write_classic_blender),
             "depth": (tmp / "classic" / "depth", write_depth_scene),
             "sitcoms": (tmp / "surface17" / "sitcoms", write_sitcoms_scene)}
    scenes = {"rgb": rgb, "ngp": ngp, "ingp": ingp}
    for key, (path, write) in found.items():
        scenes[key] = path if path.exists() else write(tmp / "dp_scenes" / key)
    return {k: str(v) for k, v in scenes.items()}


def dp_method(name: str, scenes: dict):
    """A DP_METHODS method at its ns-train defaults on its scene."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config
    from nerfstudio_thermal_torch.data.dataparsers.scene_parsers import Sitcoms3DDataParserConfig

    method = get_method_config(name)
    if name == "semantic-nerfw":
        method.dataparser = Sitcoms3DDataParserConfig()
    if name in ("vanilla-nerf", "mipnerf"):
        method.model.use_pallas = True
    if name == "depth-nerfacto":
        method.dataparser.auto_scale_poses = False
    if DP_SCENE[name] is not None:
        method.data = Path(scenes[DP_SCENE[name]])
    return method


def dp_methods_phase(scenes: dict, tmp: Path, smi: str) -> dict:
    """21d: each DP_METHODS method plain and in a one-rank NCCL group."""
    import torch.distributed as dist

    from nerfstudio_thermal_torch.parallel import mesh as mesh_lib

    out, t0 = {}, time.perf_counter()
    mesh_lib.initialize_distributed("tcp://localhost:0", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the one-rank group runs {dist.get_backend()}, not NCCL")
        for name in DP_METHODS:
            runs = {}
            for label, mesh in (("plain", mesh_lib.SINGLE), ("nccl", None)):
                runs[label] = dp_run(name, None, tmp / name / label, mesh=mesh, method=dp_method(name, scenes),
                                     steps=DP_STEPS, timed_from=DP_TIMED_FROM)
            plain, nccl = runs["plain"], runs["nccl"]
            worst = check_dp_losses(f"21d {name}", nccl["losses"], plain["losses"], step0_bitwise=True)
            if nccl["counts"] != plain["counts"]:
                raise AssertionError(f"21d {name}: launches {nccl['counts']} against the plain run's {plain['counts']}")
            idle = [k for k in DP_KERNELS[name] if nccl["counts"][k] == 0]
            if idle:
                raise AssertionError(f"21d {name}: the NCCL run launched no {idle}")
            per_step = {k: v / DP_STEPS for k, v in nccl["counts"].items() if v}
            batch = f"{nccl['rays']} rays" if nccl["rays"] else "whole-image / pose batches"
            log(f"phase 21d {name}: NCCL world 1 {nccl['ms']:.2f} ms/step against plain {plain['ms']:.2f} ms/step "
                f"(steps {DP_TIMED_FROM}-{DP_STEPS - 1}, {batch}); step 0 loss bitwise "
                f"{nccl['losses'][0]['loss']!r}; worst scalar rel diff {worst:.3g}; launches per step {per_step}; "
                f"peak {nccl['peak'] / 2**30:.2f} GiB (plain {plain['peak'] / 2**30:.2f}); gradient bytes "
                f"{nccl['grad_bytes']:,} ({smi})")
            out[name] = runs
    finally:
        dist.destroy_process_group()
    log(f"phase 21d (NCCL world 1, {len(DP_METHODS)} methods): {time.perf_counter() - t0:.1f} s")
    return out


def dp_nccl_phase(scene: Path, tmp: Path, smi: str) -> dict:
    """21a: each method plain and in a one-rank NCCL group."""
    import torch.distributed as dist

    from nerfstudio_thermal_torch.parallel import mesh as mesh_lib

    out = {}
    mesh_lib.initialize_distributed("tcp://localhost:0", 1, 0, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"the one-rank group runs {dist.get_backend()}, not NCCL")
        for name in PAR_METHODS:
            plain = dp_run(name, scene, tmp / name / "plain", mesh=mesh_lib.SINGLE)
            nccl = dp_run(name, scene, tmp / name / "nccl")
            worst = check_dp_losses(f"21a {name}", nccl["losses"], plain["losses"], step0_bitwise=True)
            if nccl["counts"] != plain["counts"]:
                raise AssertionError(f"21a {name}: launches {nccl['counts']} against the plain run's {plain['counts']}")
            idle = [k for k in PAR_KERNELS[name] if nccl["counts"][k] == 0]
            if idle:
                raise AssertionError(f"21a {name}: the NCCL run launched no {idle}")
            per_step = {k: nccl["counts"][k] / PAR_STEPS for k in PAR_KERNELS[name]}
            log(f"phase 21a {name}: NCCL world 1 {nccl['ms']:.2f} ms/step against plain {plain['ms']:.2f} ms/step "
                f"(steps {PAR_TIMED_FROM}-{PAR_STEPS - 1}, {nccl['rays']} rays); step 0 loss bitwise "
                f"{nccl['losses'][0]['loss']!r}; worst scalar rel diff {worst:.3g}; launches per step {per_step}; peak "
                f"{nccl['peak'] / 2**30:.2f} GiB (plain {plain['peak'] / 2**30:.2f}); gradient bytes "
                f"{nccl['grad_bytes']:,} ({smi})")
            out[name] = {"plain": plain, "nccl": nccl}
    finally:
        dist.destroy_process_group()
    return out


def dp_rank_main(spec_path: str, rank: int) -> int:
    """A 21b rank: join the gloo group on the card, run every PAR_METHODS
    method, then 21d's DP_GLOO_METHODS, write their results."""
    import torch.distributed as dist

    from nerfstudio_thermal_torch.parallel.mesh import initialize_distributed

    spec = json.loads(Path(spec_path).read_text())
    initialize_distributed(f"tcp://localhost:{spec['port']}", 2, rank, backend="gloo", device="cuda")
    try:
        results = {}
        for name in PAR_METHODS:
            out = Path(spec["out"])
            results[name] = dp_run(name, Path(spec["scene"]), out / f"{name}_rank{rank}", time_all_reduce=True,
                                   f32=True, params_to=out / f"{name}_rank{rank}.pt")
        for name in DP_GLOO_METHODS:
            results[name] = dp_run(name, None, out / f"{name}_rank{rank}", time_all_reduce=True, f32=True,
                                   params_to=out / f"{name}_rank{rank}.pt", method=dp_method(name, spec["dp_scenes"]),
                                   steps=DP_STEPS, timed_from=DP_TIMED_FROM)
        (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(results))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def run_gloo_ranks(spec_path: Path) -> tuple:
    """The two 21b ranks as processes of this script, each with a timeout;
    rank 1 is stopped as soon as rank 0 fails (it would wait for a store
    that never comes). Returns the processes and their logs."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(spec_path), str(r)],
                              cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PAR_RANK_TIMEOUT)[0].decode(errors="replace"))
            if p.returncode:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs[len(logs):]:
        logs.append(p.communicate()[0].decode(errors="replace"))
    return procs, logs


def dp_gloo_phase(scene: Path, tmp: Path, smi: str, scenes: dict) -> dict:
    """21b (and 21d's DP_GLOO_METHODS on `scenes`): two gloo ranks on the
    card, processes of this script, each with a timeout, against plain
    runs, all with f32 compute."""
    from nerfstudio_thermal_torch.parallel.mesh import SINGLE, free_port

    tmp.mkdir(parents=True, exist_ok=True)
    plains = {name: dp_run(name, scene, tmp / name / "plain", mesh=SINGLE, f32=True, params_to=tmp / f"{name}_plain.pt")
              for name in PAR_METHODS}
    plains.update({name: dp_run(name, None, tmp / name / "plain", mesh=SINGLE, f32=True,
                                params_to=tmp / f"{name}_plain.pt", method=dp_method(name, scenes), steps=DP_STEPS,
                                timed_from=DP_TIMED_FROM)
                   for name in DP_GLOO_METHODS})
    spec_path = tmp / "spec.json"
    t0 = time.perf_counter()
    for attempt in range(PAR_RENDEZVOUS_ATTEMPTS):
        spec_path.write_text(json.dumps({"scene": str(scene), "out": str(tmp), "port": free_port(),
                                         "dp_scenes": scenes}))
        procs, logs = run_gloo_ranks(spec_path)
        if not (procs[0].returncode and "EADDRINUSE" in logs[0]):
            break
        log(f"phase 21b: rank 0's store found its port taken (attempt {attempt + 1}); another port")
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"21b rank {r} exited {p.returncode}:\n{text[-3000:]}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    out = {"wall_s": time.perf_counter() - t0}
    for name in PAR_METHODS + DP_GLOO_METHODS:
        plain = plains[name]
        r0, r1 = ranks[0][name], ranks[1][name]
        if r0["losses"] != r1["losses"]:
            raise AssertionError(f"21b {name}: the ranks logged different global scalars")
        worst = check_dp_losses(f"21b {name}", r0["losses"], plain["losses"], step0_bitwise=False)
        p0, p1, pp = (torch.load(tmp / f"{name}_{tag}.pt", weights_only=True) for tag in ("rank0", "rank1", "plain"))
        for g in pp["final"]:
            if not (torch.equal(p0["final"][g], p1["final"][g]) and torch.equal(p0["init"][g], pp["init"][g])):
                raise AssertionError(f"21b {name} {g}: the ranks' parameters differ, or their start from the plain run's")
        params = check_dp_params(f"21b {name}", p0, pp)
        if r0["counts"] != plain["counts"]:
            raise AssertionError(f"21b {name}: rank 0 launched {r0['counts']}, the plain run {plain['counts']}")
        want1 = dict(plain["counts"])
        if name == "thermal-nerfacto-tpu":
            # rank 1 holds no ray of the 2048-ray cross-density prefix
            for k in ("fused_mlp_fwd", "fused_mlp_bwd"):
                want1[k] -= 2 * PAR_STEPS
        if r1["counts"] != want1:
            raise AssertionError(f"21b {name}: rank 1 launched {r1['counts']}, expected {want1}")
        steps = DP_STEPS if name in DP_GLOO_METHODS else PAR_STEPS
        kernels = DP_KERNELS[name] if name in DP_GLOO_METHODS else PAR_KERNELS[name]
        per_step = [{k: r["counts"][k] / steps for k in kernels} for r in (r0, r1)]
        reduce = (f"all-reduce {r0['reduce_ms']:.2f} / {r1['reduce_ms']:.2f} ms a step of {r0['grad_bytes']:,} gradient "
                  f"bytes" if r0["reduce_ms"] is not None else f"rank 0's {r0['grad_bytes']:,} gradient bytes broadcast")
        log(f"phase {'21d' if name in DP_GLOO_METHODS else '21b'} {name} (f32 compute): 2 gloo ranks on one card "
            f"{r0['ms']:.2f} / {r1['ms']:.2f} ms/step (ranks 0 / 1; plain {plain['ms']:.2f}), {reduce}; worst scalar "
            f"rel diff {worst:.3g} against the plain run; parameters after {steps} steps equal on both ranks; "
            f"against the plain run by group (step 0's gradient rel L2, updates flipped, the others' rel L2) "
            + ", ".join(f"{g} {a:.3g} {b:.3%} {c:.3g}" for g, (a, b, c) in params.items()) + "; launches "
            f"per rank-step {per_step[0]} / {per_step[1]}; peak {r0['peak'] / 2**30:.2f} / {r1['peak'] / 2**30:.2f} "
            f"GiB ({smi})")
        out[name] = {"rank0": r0, "rank1": r1}
    return out


def multi_scene_phase(scene_a: Path, tmp: Path, smi: str) -> dict:
    """21c: ns-train --data A,B (two scenes in turn on the card) against
    ns-train --data A, then ns-eval of each scene."""
    from nerfstudio_thermal_torch.engine import multi_scene
    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.scripts import train as ns_train
    from nerfstudio_thermal_torch.utils.writer import EventName

    scene_b = write_scene(tmp / "sphere_b", num_pairs=ENTRY_PAIRS)
    common = ["--max-num-iterations", str(MULTI_STEPS), "--trainer.steps-per-log", "1",
              "--pipeline.model.compute-dtype", "float32"]
    captured, original = {}, multi_scene.train_multi_scene

    def capture(*args, **kwargs):
        captured["summary"] = original(*args, **kwargs)
        return captured["summary"]

    multi_scene.train_multi_scene = capture
    try:
        reset_counts()
        rc = ns_train.main(["thermal-nerfacto", "--data", f"{scene_a},{scene_b}", "--output-dir", str(tmp / "multi"),
                            *common])
        multi_counts = read_counts()
    finally:
        multi_scene.train_multi_scene = original
    if rc != 0:
        raise AssertionError(f"21c: ns-train --data A,B returned {rc}")
    summary = captured["summary"]
    runs = sorted(summary.checkpoint_dir.glob("scene_*"))
    if [r.name for r in runs] != [f"scene_0_{scene_a.name}", f"scene_1_{scene_b.name}"]:
        raise AssertionError(f"21c: scene runs {[r.name for r in runs]}")

    def train_records(run: Path) -> list:
        recs = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
        recs = [r for r in recs if "train/loss" in r]
        if [r["step"] for r in recs] != list(range(MULTI_STEPS)):
            raise AssertionError(f"21c {run.name}: train records of steps {[r['step'] for r in recs]}")
        bad = [(r["step"], k) for r in recs for k, v in r.items() if k.startswith("train/") and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"21c {run.name}: non-finite {bad[:5]}")
        return recs

    scenes = [train_records(r) for r in runs]
    reset_counts()
    rc = ns_train.main(["thermal-nerfacto", "--data", str(scene_a), "--output-dir", str(tmp / "solo"),
                        "--experiment-name", "solo", *common])
    solo_counts = read_counts()
    if rc != 0:
        raise AssertionError(f"21c: ns-train --data A returned {rc}")
    (solo_run,) = (tmp / "solo" / "solo" / "thermal-nerfacto").iterdir()
    solo = train_records(solo_run)
    keys = [k for k in scenes[0][0] if k.startswith("train/") and k in solo[0]]
    worst = check_dp_losses("21c scene 0 against ns-train --data A",
                            [{k[len("train/"):]: r[k] for k in keys} for r in scenes[0]],
                            [{k[len("train/"):]: r[k] for k in keys} for r in solo], step0_bitwise=True)
    if multi_counts != {k: 2 * v for k, v in solo_counts.items()}:
        raise AssertionError(f"21c: two scenes launched {multi_counts}, one scene {solo_counts}")
    idle = [k for k in PAR_KERNELS["thermal-nerfacto"] if multi_counts[k] == 0]
    if idle:
        raise AssertionError(f"21c: the multi-scene run launched no {idle}")
    evals = {}
    for run in runs:
        rc = ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(run / "eval.json")])
        result = json.loads((run / "eval.json").read_text())["results"] if rc == 0 else {}
        if rc != 0 or not all(math.isfinite(v) for v in result.values() if isinstance(v, (int, float))):
            raise AssertionError(f"21c: ns-eval of {run.name} returned {rc}: {result}")
        evals[run.name] = result
    solo_ms = 1e3 * float(np.mean([r[f"train/{EventName.ITER_TRAIN_TIME}"] for r in solo[1:]]))
    log(f"phase 21c: ns-train thermal-nerfacto --data A,B (f32 compute), {MULTI_STEPS} steps: K=2 {summary.step_s * 1e3:.2f} ms a "
        f"step of both scenes against K=1 (ns-train --data A) {solo_ms:.2f} ms/step (steps 1-{MULTI_STEPS - 1}, each "
        f"logged); scene 0 against the one-scene run: step 0 bitwise, worst rel diff {worst:.3g}; launches "
        f"{ {k: multi_counts[k] for k in PAR_KERNELS['thermal-nerfacto']} } (2 x the one-scene run's); ns-eval psnr "
        + ", ".join(f"{n} {r.get('psnr_rgb', float('nan')):.2f} / {r.get('psnr_thermal', float('nan')):.2f}"
                    for n, r in evals.items()) + f" ({smi})")
    return {"counts": multi_counts, "solo_counts": solo_counts, "k2_ms": summary.step_s * 1e3, "k1_ms": solo_ms}


# Phase 22: ns-benchmark (scripts/benchmarking.py) on phase 16's blender scene.
# The launches it must show, predicted from the code: a
# nerfacto training step runs the hash forward (row 8) of each proposal grid
# and of the field's grid, and the table gradient (rows 7/9) of the field's
# grid and, on the steps the proposal schedule updates them
# (`models.nerfacto.proposal_updated`: every step below 10, then every other
# at the default warmup), of each proposal grid (on the other steps the
# proposal densities are detached); no position asks for a gradient (camera
# optimizer off, no predicted normals), so the position gradient (row 10)
# never launches. No eval cadence falls inside BENCH_STEPS (nerfacto's are
# every 500 steps and later; step 0 runs none). ns-eval renders each val
# image in ceil(H * W / eval_num_rays_per_chunk) chunks of one forward per
# grid, and differentiates nothing; `get_average_eval_image_metrics` first
# renders camera 0 once more, untimed (a warm-up).
BENCH_STEPS = 30


def benchmark_expected(model) -> dict:
    """The hash kernels' launches of ns-benchmark's ns-train and ns-eval
    for nerfacto's model config `model` (see above)."""
    from nerfstudio_thermal_torch.models.nerfacto import proposal_updated

    grids = model.num_proposal_iterations + 1
    updated, since = 0, 0
    for step in range(BENCH_STEPS):
        u, since = proposal_updated(step, since, model.proposal_warmup, model.proposal_update_every)
        updated += u
    chunks = (BLENDER_VAL + 1) * math.ceil(BLENDER_SIZE * BLENDER_SIZE / model.eval_num_rays_per_chunk)
    return {"train": expected_counts({"hash_encode_fwd": grids * BENCH_STEPS,
                                      "hash_encode_bwd_table": BENCH_STEPS + (grids - 1) * updated}),
            "eval": expected_counts({"hash_encode_fwd": grids * chunks})}


def benchmark_phase(blender: Path, tmp: Path, smi: str) -> dict:
    """Phase 22: `benchmarking.main` of nerfacto on `blender` (phase 16's
    scene, linked as tmp/blender/lego), its output under tmp. Returns the
    launches of its ns-train ("train") and ns-eval ("eval")."""
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config
    from nerfstudio_thermal_torch.scripts import benchmarking
    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.scripts import train as ns_train

    t_phase = time.perf_counter()
    repo_outputs = Path(__file__).resolve().parent / "benchmarks"
    had_outputs = repo_outputs.exists()
    data = tmp / "blender"
    data.mkdir(parents=True)
    (data / "lego").symlink_to(blender.resolve(), target_is_directory=True)
    expected = benchmark_expected(get_method_config("nerfacto").model)
    spans, scripts = {}, {"train": ns_train, "eval": ns_eval}
    originals = {kind: module.main for kind, module in scripts.items()}

    def counted(kind):
        def run(argv, **kw):
            reset_counts()
            t0 = time.perf_counter()
            rc = originals[kind](argv, **kw)
            torch.cuda.synchronize()
            spans[kind] = {"s": time.perf_counter() - t0, "counts": read_counts(), "rc": rc}
            return rc
        return run

    for kind, module in scripts.items():
        module.main = counted(kind)
    try:
        rc = benchmarking.main(["--method", "nerfacto", "--data-dir", str(data), "--scenes", "lego", "--output-dir",
                                str(tmp / "out"), "--", "--max-num-iterations", str(BENCH_STEPS)])
    finally:
        for kind, module in scripts.items():
            module.main = originals[kind]
    if rc != 0 or set(spans) != {"train", "eval"} or any(s["rc"] != 0 for s in spans.values()):
        raise AssertionError(f"ns-benchmark returned {rc}; ns-train / ns-eval: "
                             f"{ {k: s['rc'] for k, s in spans.items()} }")
    if not had_outputs and repo_outputs.exists():
        raise AssertionError(f"ns-benchmark wrote {repo_outputs}")
    (summary_path,) = (tmp / "out").glob("*/benchmark.json")
    summary = json.loads(summary_path.read_text())
    metrics = json.loads((summary_path.parent / "lego_metrics.json").read_text())
    if summary["scenes"] != {"lego": metrics["results"]}:
        raise AssertionError(f"benchmark.json's scenes {summary['scenes']} are not ns-eval's {metrics['results']}")
    psnr = summary["mean_psnr"]
    if psnr is None or not math.isfinite(psnr):
        raise AssertionError(f"ns-benchmark's mean PSNR {psnr}")
    (run,) = summary_path.parent.glob("lego/nerfacto/*")
    records = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
    losses = {(r["step"], k): v for r in records for k, v in r.items() if k.startswith("train/") and k.endswith("loss")}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"ns-benchmark's training losses {losses}")
    iter_s = [r["train/Train Iter (time)"] for r in records if r.get("step", 0) >= 20 and "train/Train Iter (time)" in r]
    for kind in ("train", "eval"):
        got = spans[kind]["counts"]
        if got != expected[kind]:
            raise AssertionError(f"ns-benchmark's ns-{kind} launched {got}; predicted {expected[kind]}")
    launches = {kind: {k: v for k, v in spans[kind]["counts"].items() if v} for kind in spans}
    ms_step = iter_s[0] * 1e3 if iter_s else float("nan")
    log(f"benchmark: ns-benchmark nerfacto on blender/lego ({BLENDER_FRAMES} x {BLENDER_SIZE}x{BLENDER_SIZE}, "
        f"{BLENDER_VAL} val): ns-train {BENCH_STEPS} steps {spans['train']['s']:.2f} s, {ms_step:.2f} ms/step "
        f"(steps 11-20), ns-eval {spans['eval']['s']:.2f} s ({spans['eval']['s'] / BLENDER_VAL:.2f} s per "
        f"{BLENDER_SIZE}x{BLENDER_SIZE} frame), mean_psnr {psnr:.4f} (= ns-eval's psnr_rgb); launches train "
        f"{launches['train']}, eval {launches['eval']} (as predicted); phase {time.perf_counter() - t_phase:.1f} s "
        f"({smi})")
    return {"train": spans["train"]["counts"], "eval": spans["eval"]["counts"], "train_s": spans["train"]["s"],
            "eval_s": spans["eval"]["s"], "ms_step": ms_step, "psnr": psnr}


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
    parser.add_argument("--dp-rank", nargs=2, default=None, metavar=("SPEC", "RANK"),
                        help="(internal) run one rank of phase 21b")
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
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank[0], int(args.dp_rank[1]))
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
        # phase 17: neus, neus-facto (the hash grid's second derivative) and semantic-nerfw
        surface17 = surface_methods_phase(Path(tmp) / "surface17", ngp_scene, smi)
        # phase 18: ns-export and ns-texture on phase 17's and phase 11's runs
        export = export_phase(entries, surface17["neus-facto"]["run"], Path(tmp) / "export", smi)
        # phase 19: splatfacto (on phase 15's RGB scene) and generfacto (no data)
        splat = splat_phase(ngp_scene, Path(tmp) / "splatfacto", smi)
        gen = generfacto_phase(Path(tmp) / "generfacto", smi)
        # phase 20: the web viewer on phase 11's runs, and ns-train --vis viewer
        viewer = viewer_phase(entries, entry_scene, Path(tmp) / "viewer", smi)
        # phase 21: data-parallel (one NCCL rank, two gloo ranks) of every
        # method and multi-scene training
        t0 = time.perf_counter()
        dp = dp_nccl_phase(scene, Path(tmp) / "dp", smi)
        scenes = dp_scenes(Path(tmp), rgb_scene, ngp_scene, data_scenes["instant-ngp-data"])
        dp_all = dp_methods_phase(scenes, Path(tmp) / "dp_methods", smi)
        dp_gloo = dp_gloo_phase(scene, Path(tmp) / "dp_gloo", smi, scenes)
        multi = multi_scene_phase(entry_scene, Path(tmp) / "multi_scene", smi)
        log(f"phase 21: {time.perf_counter() - t0:.1f} s (the two gloo ranks {dp_gloo['wall_s']:.1f} s)")
        # phase 22: ns-benchmark on phase 16's blender scene
        bench = benchmark_phase(Path(tmp) / "classic" / "blender", Path(tmp) / "benchmark", smi)
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
    # phase 17: the position gradient's VJP (no TPU kernel: JAX differentiates
    # hash_encode's jnp backward), timed on neus-facto's own SDF-grid call,
    # with its launches; rows 7-10 on neus-facto's grids as extra fields
    nf = surface17["neus-facto"]
    vjp = surface17["vjp"]
    kernels.append({
        "name": "hash_encode_bwd_pos_vjp", "route": "cuda", "source": hash_source,
        "replaces": "none: no pallas_call computes it (XLA differentiates the jnp backward of hash_encode's custom "
                    "VJP, nerfstudio_thermal_tpu/ops/encodings.py:159 _hash_encode_bwd)",
        "launches": nf["counts"]["hash_encode_bwd_pos_vjp"],
        **{k: vjp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        # what ms, bound_ms and max_abs_err measure: the outputs the step asks
        # for (all three: model_neus_facto_train_step's all_outputs)
        "outputs": "+".join(k for k, w in zip(("dg", "d_table", "d_pos2"), VJP_STEP_OUTPUTS) if w),
        "model_neus_facto_train_step": vjp, "per_step": NEUS_FACTO_STEP["hash_encode_bwd_pos_vjp"],
        "per_render_chunk": NEUS_FACTO_CHUNK.get("hash_encode_bwd_pos_vjp", 0),
    })
    for rec in kernels:
        if rec["name"].startswith("hash_encode"):
            for scope, sums in surface17["hash"].items():
                if rec["name"] in sums:
                    rec["model_" + scope.replace(" ", "_").replace("-", "_")] = sums[rec["name"]]
            rec["neus_facto_launches"] = {"train": nf["counts"][rec["name"]],
                                          "per_step": NEUS_FACTO_STEP.get(rec["name"], 0),
                                          "per_render_chunk": NEUS_FACTO_CHUNK.get(rec["name"], 0)}
            rec["semantic_nerfw_launches"] = surface17["semantic-nerfw"]["counts"][rec["name"]]
    # phase 18: each kernel's launches over the export commands
    for rec in kernels:
        if export["launches"].get(rec["name"]):
            rec["export_launches"] = export["launches"][rec["name"]]
    # phase 19: rows 7-10 and the VJP on generfacto's path: launches in its
    # ns-train run (counts zeroed just before) and ns-render of the eval
    # ring, and step 9's calls on its own points
    for rec in kernels:
        if rec["name"].startswith("hash_encode"):
            rec["generfacto_launches"] = {"train": gen["counts"][rec["name"]], "per_step": GEN_STEP[rec["name"]],
                                          "ns_render_ring": gen["render_counts"][rec["name"]]}
            for scope, sums in gen["hash"].items():
                if rec["name"] in sums:
                    rec["model_" + scope.replace(" ", "_")] = sums[rec["name"]]
            if rec["name"] == "hash_encode_bwd_pos_vjp":
                rec[f"model_generfacto_train_step_{GEN_CAPTURE_STEP}"] = gen["vjp"]
    # phase 20: each render kernel's launches per viewer frame, by method and
    # bucket, and over the whole phase (ns-viewer renders, then ns-train --vis viewer)
    for rec in kernels:
        per_frame = {m: {str(w): b["launches"][rec["name"]] for w, b in viewer[m]["buckets"].items()
                         if rec["name"] in b["launches"]} for m in VIEWER_METHODS}
        per_frame = {m: v for m, v in per_frame.items() if v}
        if per_frame:
            rec["viewer_launches_per_frame"] = per_frame
            rec["viewer_launches"] = viewer["counts"][rec["name"]]
        if viewer["train"]["counts"].get(rec["name"]):
            rec["viewer_train_launches"] = viewer["train"]["counts"][rec["name"]]
    # phase 21: the launches of rows 1-2 (thermal-nerfacto-tpu) and 7-10
    # (thermal-nerfacto) per rank-step of the data-parallel runs, and over
    # the two-scene ns-train run
    for rec in kernels:
        for name in PAR_METHODS:
            if rec["name"] in PAR_KERNELS[name]:
                rec["data_parallel_launches_per_rank_step"] = {
                    f"{name} nccl world 1": dp[name]["nccl"]["counts"][rec["name"]] / PAR_STEPS,
                    **{f"{name} gloo rank {r}": dp_gloo[name][f"rank{r}"]["counts"][rec["name"]] / PAR_STEPS
                       for r in (0, 1)},
                }
        # 21d: every other method's NCCL world-1 run, and its two gloo ranks
        # where it ran them
        for name in DP_METHODS:
            # (a row 3 / 4 record of one stack has no count of its own: none of these runs launches it)
            per_rank = {f"{name} nccl world 1": dp_all[name]["nccl"]["counts"].get(rec["name"], 0) / DP_STEPS}
            if name in DP_GLOO_METHODS:
                per_rank.update({f"{name} gloo rank {r}": dp_gloo[name][f"rank{r}"]["counts"].get(rec["name"], 0)
                                 / DP_STEPS for r in (0, 1)})
            if any(per_rank.values()):
                rec.setdefault("data_parallel_launches_per_rank_step", {}).update(per_rank)
        if rec["name"] in PAR_KERNELS["thermal-nerfacto"]:
            rec["multi_scene_launches"] = {"two scenes": multi["counts"][rec["name"]],
                                           "one scene": multi["solo_counts"][rec["name"]]}
        # phase 22: ns-benchmark's ns-train and ns-eval
        if rec["name"] in bench["train"]:
            rec["ns_benchmark_launches"] = {"train": bench["train"][rec["name"]], "eval": bench["eval"][rec["name"]]}
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
    log(f"image_io: 1920x1080 JPEG decode {image_io['decode_ms']:.1f} ms, 0.5x resize {image_io['resize_ms']:.1f} ms; "
        f"progressive 1920x1080 {image_io['progressive_ms']:.1f} ms against baseline {image_io['baseline_twin_ms']:.1f} "
        f"ms (host) ({smi})")
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
    for m in ("neus-facto", "neus", "semantic-nerfw"):
        r = surface17[m]
        log(f"{m}: train {r['step_s'] * 1e3:.2f} ms/step at {r['rays']} rays, peak memory {r['peak'] / 2**30:.2f} GiB; "
            f"640x512 frame {r['frame_s']:.3f} s ({smi})")
    log(f"neus-facto with mono priors: {surface17['mono']['step_s'] * 1e3:.2f} ms/step ({smi})")
    for label, r in export["lines"].items():
        counts = ", ".join(f"{k} {r[k]}" for k in ("verts", "faces", "points") if k in r)
        log(f"export {label}: {r['s']:.2f} s (setup {r['setup_s']:.2f}, card {r['card_s']:.2f}, host "
            f"{r['host_s']:.2f}){'; ' + counts if counts else ''} ({smi})")
    label, ops = next(iter(splat["ops"].items()))
    log(f"splatfacto: train {splat['step_s'] * 1e3:.2f} ms/step, peak memory {splat['peak'] / 2**30:.2f} GiB; "
        + ", ".join(f"{k} frame {v:.4f} s" for k, v in splat["frames"].items())
        + f"; {label}: binning {ops['binning']['ms']:.3f} ms, compositing forward {ops['forward']['ms']:.3f} ms, "
        f"forward + backward {ops['forward+backward']['ms']:.3f} ms ({smi})")
    log(f"generfacto: train {gen['step_s'] * 1e3:.2f} ms/step, peak memory {gen['peak'] / 2**30:.2f} GiB, device "
        f"busy {gen['busy']:.2f} ms a step; ns-render of the eval ring {gen['render_s']:.2f} s ({smi})")
    for m in VIEWER_METHODS:
        r = viewer[m]
        log(f"viewer {m}: camera to first frame {r['first_frame_ms']:.1f} ms; "
            + ", ".join(f"{w} bucket render {b['render_ms']:.1f} ms + encode {b['encode_ms']:.2f} ms"
                        for w, b in r["buckets"].items()) + f" ({smi})")
    log(f"viewer: encode_jpeg 1920x1080 {viewer['encode_1080_ms']:.2f} ms (host); ns-train --vis viewer "
        f"{VIEWER_TRAIN_STEPS} steps in {viewer['train']['wall_s']:.1f} s ({smi})")
    log(f"chip_smoke total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
