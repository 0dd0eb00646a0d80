"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (``point_diffusion_refinement_tpu_torch/
   csrc/*.cu``, one ``nvcc`` per source, all in parallel) and prints the
   build time.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path: indices and counts must be equal, other outputs
   within the stated tolerance.  Prints each kernel's time, the plain
   version's time, the time of one PyTorch library call that computes the
   same function where there is one, and the least time the card could take
   (``bound_ms``: the larger of bytes over 3.35 TB/s and operations over the
   peak rate of their type, 67 TFLOP/s in float32 and 989 TFLOP/s for the
   attention sweeps' bf16 products, counted for this run's data).  The idx-only FPS is held
   at the mirror-preprocessing shapes (64 clouds of 4096 points, with exact
   duplicates, padding and an all-padding cloud, to 3072 and 2048) and at a
   row beyond shared memory (16384 points), where the coordinates kernel
   runs too.  FPS with coordinates is swept at npoint 1024 over N = 1024 to
   12288 (B=4), the wrapper's (threads, points a thread) beside the
   runners-up the kernel builds, each bit-equal to the plain version, with
   µs a pick and the line through the wrapper's times (per-pick latency +
   per-point work).  The ball query is held and timed at every shape one
   denoise step of the model below launches it at, on the tensors the step
   gives it.  The fused ball group is held at every queries-a-warp choice it
   takes and timed with its scan alone (counts and idx, no grouped output)
   beside the whole launch: the scan/write split.  kNN is held at every lane
   count a query at B=4 and B=32, at k = 8, 32 and N, and through ``query_and_group`` with
   ``neighbor_definition="nn"`` at nsample 32.  Kernel times of FPS are
   CUDA-event means over wrapper calls; those of the ball query, the fused
   ball group and kNN are the profiler's device time a launch (the
   wrapper's host time, ``wrapper_ms``, is beside them).
3. Builds ``DEFAULT_POINTNET_CONFIG`` in bfloat16 with seeded random weights
   and runs ``make_coarse_sampler`` end to end at B=4, 2048 points, a
   3072 x 4 condition, over a schedule of STEPS steps, with every launch count
   reset just before and read just after; fails if a kernel of the path was
   never launched or the output is not a finite (4, 2048, 3) cloud.
4. Runs one denoise step through the kernels and through the plain versions
   on the card and checks their relative difference.
   Then ``EXPERIMENTS["ddpm_avg_max"]`` (global self-attention) in bf16
   at full width: one B=4 encode + denoise step through the kernels, launch
   counts reset just before and read just after, against ``plain_ops()``.
   Then ``DEFAULT_POINTNET_CONFIG`` with nsample 96 (radius 0.5) at level 0
   of the x_t set abstraction and the feature-transfer pair: one B=4 denoise
   step with ``fused=True``, whose fused ball groups run past their 64-slot
   pass, against ``plain_ops()``.
5. Traces three denoise steps with ``torch.profiler`` and prints the
   device-busy share of the window, the ops that take the most device
   time, and the device ms a denoise step of the ``fps``, ``fps_idx``,
   ``ball_query``, ``ball_group`` and ``knn`` kernels.
6. Preprocessing: ``generate_mirrored_partials`` over 256 seeded partials of
   2048 points at batch 64 to 3072 points; checks shape, flags and one
   ``fps_idx`` launch a batch, and prints clouds/s.
7. The two-stage completion pipeline at B=4, launch counts reset just
   before and read just after: raw partials -> ``mirror_and_concat`` ->
   FastDPM-50 coarse generation (the ``refine_fast50`` plan: VAR,
   quadratic, kappa 0.5) -> the ``upsample_16384`` refine net (bf16,
   x8, seeded weights) -> CD-p / CD-t / F1 through ``evaluate``; fails unless
   the output is a finite (4, 16384, 3) cloud and every kernel was launched.
   Then the same pipeline once more under the profiler (CUDA activity only):
   device ms of those five kernels a pipeline.
8. The ``upsample_16384`` refine forward at B=32: ms a batch,
   completions/s, and one forward through the kernels against one under
   ``plain_ops()`` (relative error of the displacement); then a profile of
   one forward, with the device ms of those five kernels in it.
9. Evaluation cost: ``calc_cd`` at (32, 16384) against (32, 16384) and
   ``earth_mover_distance`` at (32, 2048) against (32, 2048).
10. Training kernels against their plain versions: the fused ball group at
   K = 96 and 160 and the fused ball query + gather at K = 160 and K > N
   (any nsample); the fused ball query + gather (``ball_query_group``) at
   the level-0 feature-transfer shape and at a deep level with a wide table
   (idx and counts equal, gathered rows equal), at B=4 and at the training
   batch B=32, each queries-a-warp choice at both; the idx output of the
   fused ball group against the ball-query kernel; the atomic scatter-add
   B (``group_scatter_add(deterministic=False)``) against ``index_add_`` at
   the level-0 cotangent shape in float32 and bfloat16, and at B=4 and
   B=32 in float32 and on a bfloat16 channel slice of a wider row (as
   ``ball_group_train``'s backward passes it), at each balls-a-thread
   choice; the ordered scatter-add (``ordered_scatter_row``: the default of
   every caller) at those shapes, with and without counts, and at
   chamfer's re-gather in the x8 refine step, bit-equal run to run and to
   the plain version on CPU copies, timed beside B and the deterministic
   ``index_put_``; the three gradients
   of ``ball_group_train`` against autograd through the plain version in
   both empty-ball modes.  Both kernels' times are the profiler's device
   time a launch, with ``wrapper_ms`` beside them.
11. DDPM training at full width through ``train/loop.py::train``:
   ``DEFAULT_POINTNET_CONFIG`` in bfloat16, seeded weights, synthetic
   2048-point clouds with mirrored 3072 x 4 conditions, the largest power of
   two batch up to 32 that fits (printed with the peak memory), both fused
   training routes on, launch counts reset just before and read just after;
   fails unless every kernel of the path was launched, the losses are
   finite and every parameter got a finite gradient and moved.  Then the
   same steps with both routes off, step ms and samples/s of both routes,
   the relative difference of the first-step loss and of the gradients
   between the routes, one step through the kernels against one under
   ``plain_ops()``, and a profile of one training step with the device ms
   and launches of the hand-written kernels in it.  Before those, every
   shape the fused ball query + gather and the scatter-add are launched at
   in one training step, with the launches and the device ms a launch of
   each (spies on their wrappers, replayed under the profiler), the
   scatter-add's both through the ordered kernel and the atomic B.
12. Refine training: the ``upsample_16384`` net, task ``refine_completion``,
   x8 upsampling, cd_t with the intermediate loss on and the output-scale
   schedule ticking, in-loop eval, the same checks; a run stopped at a
   checkpoint and resumed is held against the uninterrupted one.
13. The accelerated inference configuration (``fused_attention``,
   ``fused_knn``, ``packed``; all off by default), run before the training
   phases.  Prints every attention site of one denoise step (M, K, Cq, Ck,
   Cv, c_out) and holds the fused attention pool against its plain version
   and against the unfused pool at each of them, on the tensors the step
   gives it and with the other kind of counts (none, or counts that include
   0 and K); at each site the profiler's device ms and grid of each sweep
   and of the finishing launch (the query-row pass), their bounds (the
   finishing's on the bytes the function must move), the row tiles and
   the rows of partial sums (one a thread-block cluster) of sweeps 1 and 2,
   and the CUDA launches of one fused pool call (at most
   POOL_MAX_LAUNCHES), by the profiler's records and as the nodes of a CUDA
   graph of one call (with its four hand-written kernels launched once
   each), summed over the step; the sweeps, the query-row pass and the
   finishing work as the functions F0 and F1 were (sweep 1's finish + the
   query rows, sweep 2's finish) one by one against their plain versions,
   two calls bit-equal (device ms, ``wrapper_ms``) at the level-0 feature
   transfer, the level-0 set abstraction, the level-0 kNN feature
   propagation and the deepest site (weights beyond shared memory); a pool
   with K = 96 slots, launched and held against plain; ``knn_group`` at the level-0 feature propagation (k = 8 and 32),
   at a small support with duplicates and k = N, and at B = 32.
   Then the pipeline of phase 7 once more with ``fused_attention`` and
   ``fused_knn`` on, launch counts reset just before and read just after:
   fails unless the three sweeps and ``knn_group`` were launched on every
   denoise step and in the refine forward.  One denoise step and one B=32
   refine forward with the variants on against off and against
   ``plain_ops()``, one denoise step with ``packed`` against off, and what
   each variant costs: step ms and device-busy share of the denoise step,
   ms of the B=32 refine forward.
14. The README's file-driven pipeline through the port's CLIs, run after
   the training phases, at full width on seeded random weights, every launch
   count reset before each call and read after it: the ``ddpm`` config
   written as JSON in the reference's schema (lists as strings) with a
   ``synthetic`` dataset of FILE_ITEMS 2048-point clouds with mirrored
   3072 x 4 partials -> ``train_cli`` with both fused training routes,
   FILE_STEPS steps at B=32 (one checkpoint and its in-loop FastDPM-50 eval
   of FILE_TESTED clouds a split, then the last) -> ``generate_cli
   --fast_sampling`` on FILE_TESTED test clouds at batch 4 -> ``generate_cli
   --phase test_trainset --num_trials 2 --augment_data_during_generation``
   -> the ``upsample_16384`` config through ``train_from_file`` (2 steps)
   and ``run_generation_from_file``, with the first trial's clouds as the
   coarse input, held in memory -> ``gather_eval_results`` and
   ``plot_result``.  Where ``h5py`` imports, the same chain runs on files
   instead: ``write_mvp_style_h5`` -> ``preprocess_cli`` -> ``train_cli`` ->
   ``generate_cli`` (test, trials, and the bare train split the random trial
   choice can pick) -> ``train_cli`` and ``generate_cli`` on the refine
   config, which reads the generated h5.  Prints the route, the wall time
   and launches of each call, the checkpoint ``generate_cli`` used, every
   save directory, the train step ms through the CLI beside phase 11's and
   FastDPM-50 ms a batch of 4 through ``generate_cli`` beside phase 7's.
   Fails if a checkpoint, ``eval_result.pkl`` or save directory is not at
   its path, a kernel of a call was not launched, a CD is not finite, or the
   in-loop eval did not evaluate exactly FILE_TESTED clouds.
16. The networks and model options of the tenth slice, run after phase 14,
   every launch count reset before each run and read after it.  (a)
   ``network_type: "pvd"`` (PVCNN2Completion at its class defaults: 2048
   points joined with the 3072-point condition, embed_dim 64, voxel
   attention, four SA and four FP blocks) through ``train()`` on phase 11's
   kind of data, the largest power-of-two batch up to 32 (printed with the
   peak memory), TRAIN_STEPS steps: FPS idx (#6), the ball query (#3) and
   3-NN (#4) held against their plain versions on the joined 5120-point
   cloud, each launched on every step (the run's launches are TRAIN_STEPS
   times one step's), finite losses, every parameter with a finite
   gradient and moved (but for tensors whose gradient is all zero: a
   squeeze-excitation's hidden ReLU units can all be off); a forward and
   gradient through the kernels against ``plain_ops()``; step ms and
   samples/s; a profile of one step (device-busy share, the top device
   ops, the device ms and launches of the hand-written kernels); one
   refine-task forward.  (b) ``network_type: "pointwise_net"`` at its
   defaults, TRAIN_STEPS steps at B=32: finite losses, parameters moved,
   step ms; no kernel.  (c) ``DEFAULT_POINTNET_CONFIG`` with the
   feature-propagation grouper in bf16: one B=4 encode + ``denoise(fused=
   True)`` against ``plain_ops()``, one DDPM training step with both fused
   routes at the largest batch up to 32, and the launches inside each FP
   module (the grouper's ball query, #3, or fused gather, #8).  (d)
   ``concate_partial_with_noisy_input``: one B=4 forward over the
   5120-point joined cloud against ``plain_ops()``.  (e)
   ``record_neighbor_stats``: 2 DDPM steps at B=32 with both fused routes
   through ``train()``; every module's histogram sums to B x centres x
   steps, the one-shot and the accumulated reports, and one step's
   histograms through the kernels equal to those under ``plain_ops()``.
17. The two-stage demo of the eleventh slice, after phase 16
   (``cli/two_stage_demo.py::run_demo``): ``DEFAULT_POINTNET_CONFIG`` in
   bf16, T = DEMO_T, batch DEMO_BATCH, the fused training routes on, on
   synthetic shapes cut to DEMO_SHAPES a split (78 train clouds), the first
   DEMO_TESTED test clouds and one augmented train-set trial, DEMO_DDPM_STEPS
   + DEMO_REFINE_STEPS steps; launch counts reset just before and read just
   after.  Prints each stage's seconds, the DDPM loss over its first and
   last 10 steps, coarse CD-t at 2048 and refined CD-t at 4096 points and
   ``refined_beats_coarse`` (reported, not a check); fails if a loss or CD
   is not finite, the last 10 steps' mean loss is not below the first 10's,
   a cloud has the wrong shape or a kernel of DEMO_PATH_KERNELS was not
   launched.  (b) Two B=32 DDPM steps through ``train(mesh=make_mesh())`` on
   an NCCL process group of one (``tcp://127.0.0.1``, a free port) against
   the same steps with no process group, from the same weights and
   batches: the first loss must be equal, the second loss and the
   parameters after step 2 (relative L2) within RESUME_REL_TOL; then one
   FastDPM-10 ``run_generation(mesh=)`` batch; the group is destroyed.  (c)
   ``compute_all_metrics`` and ``jsd_between_point_cloud_sets`` on the
   demo's coarse test clouds against their 2048-point GT, with their ms:
   every value finite, 1-NN-CD-acc in [0, 1].  (d) ``StepTimer`` over demo
   DDPM steps at B = DEMO_BATCH, then ``trace`` + ``summarize_trace`` over
   three: the top 10 device ops; fails if no device row is returned in
   three trace windows.
18. The mesh's ``model`` axis and the FLOP count, after phase 17.  (a)
   The same MODEL_AXIS_STEPS B=TRAIN_BATCH DDPM steps (``ddpm`` config in
   bf16 at full width, fused training routes on) once in this process and
   once through ``train(mesh=)`` in two spawned processes on the one card
   (gloo on CUDA tensors, ``tcp://127.0.0.1`` on a free port, a (1, 2) mesh,
   half the rows a rank), from the same weights, rows and draws (the
   reference takes each rank's shard in ``train()``'s shuffled order, and t
   and z from a generator seeded rank + 1, as the ranks draw them; this
   process frees its cached memory before they start).  Holds the first
   loss within TRAIN_PLAIN_LOSS_REL_TOL, the second loss and the gathered
   parameters after the last step (relative L2) within RESUME_REL_TOL, the
   losses equal on both ranks, the tensors each rank stores sharded equal to
   the port's rule (104 of 837 at this config) with their shapes halved, the
   launches of #1, #2, #4, #8 and B non-zero on each rank, and rank 0's
   last checkpoint loaded into one process equal to the gathered
   parameters; prints each rank's bytes of parameters and Adam moments
   beside the one process's, its peak memory, and both step times (two
   processes share one card: no speed record).  (b) ``dot_flops`` of one
   B=4 denoise step with the variants off and with ``fused_attention`` on,
   whose ``model + pallas`` must be equal, and of one B=TRAIN_BATCH DDPM
   training step with the fused routes: model GFLOP and MFU (FLOPs over
   the step's host-clock ms and 989 TFLOP/s).  ``python3 chip_smoke.py
   --model-axis-cards 4`` runs (a) alone across four cards instead, NCCL, a
   card a rank, a (2, 2) mesh, against one process on card 0, and then
   the compiled mesh steps of phase 21 on four cards.
19. Compiled generation, after phase 13 on its model (the JAX package
   jits its samplers and refiner; here a captured CUDA graph of a reverse
   step, ``utils/graphs.py``): (a) STEPS ancestral steps at B=4 through
   ``make_coarse_sampler(segment_size=GRAPH_SEGMENT)`` (segments of 4, 4
   and 2) with t-slices at GRAPH_SLICES, then eagerly from the same
   generator seed: x0 and each slice within the JAX package's variants
   bound relative to the eager run's magnitude (0 expected), every
   kernel's launch count equal and those of the coarse path non-zero;
   (b) the same with ``fused_attention`` and ``fused_knn`` on, so the
   attention sweeps and ``knn_group`` replay inside the graph; (c) for
   both, the step ms of each kind from the host clock around STEPS
   synchronised reverse steps, the device-busy share of STEPS reverse
   steps each way (the profiler's CUDA activity over the host clock), and
   the capture's ms and pool bytes; (d) FastDPM-50 at B=4
   graphed whole against eager: equal as in (a), ms a batch; (e) the
   ``upsample_16384`` x8 refine forward at B=32 through ``CapturedFunction``
   against eager: the displacement's difference within REFINE_REL_TOL,
   equal launch counts, ms a batch.  Phase 17's coarse generation runs
   through the graphed ``run_generation``; it prints its seconds and ms a
   step beside the eager demo CLI's record in ``PERF.md``.
20. Compiled training, after phase 12 (the JAX package jits its train
   step; here one captured CUDA graph a step signature: forward, loss,
   ``backward()`` through #2/#8 and the ordered scatter-add, and the fused
   capturable Adam, ``compiled=True``): the ``ddpm`` step at B=TRAIN_BATCH
   with the fused
   routes on, then off, and the ``upsample_16384`` x8 refine step with the
   fused routes on and its output scale ramping 0.01 -> 0.001 over the
   steps.  Each from one state (after an eager step, so the moments exist;
   restored in place before each run) and the same draws, eager and
   compiled.  The first step twice each way (the first replay follows the
   capture, the second replays the same graph): the replays' losses equal
   to the eager step's bit for bit, their gradients bit-equal to the eager
   ones and within GRAPH_GRAD_REL_TOL (of the norm, and every entry of the
   largest), every pair's readings printed, and two planted faults run
   eagerly (half the batch; the next step's draws or output scale) beyond
   that bound and beyond LOSS_TRAJ_RTOL.  Adam's update on each step's own
   gradients bit-equal to an eager step of the same Adam from the state
   before it, with every step count advanced by one, at the first two
   replays and the last of the run (and at the eager steps alike); a
   planted fault (the step count one off) must differ.  Then
   COMPILED_STEPS steps twice each way: every loss, and the parameters,
   Adam moments and step counts after them, bit-equal across the two eager
   and the two compiled runs, the compiled losses within LOSS_TRAJ_RTOL of
   the eager ones, the parameters within 2 * lr * steps, the launch counts
   equal and one graph, the losses printed; COMPILED_STEPS replays more,
   each loss equal bit for bit to an eager forward of the state the replay
   starts from; prints the host ms of every step (ending in
   ``float(loss)``, as ``train()`` does), the peak allocated and reserved
   memory, a BUSY_STEPS device-busy window each way, and the capture's ms
   and pool bytes.  The three steps are ``training_setup``'s.  Then, on
   the same setup, ``scatter_cost`` of the B=32 DDPM (fused routes) and x8
   refine steps: the compiled step with the ordered scatter-add and with
   the atomic kernel B (``scatter_kernel(deterministic=False)``) in turns
   ordered, atomic, atomic, ordered, host ms and device ms a step each
   turn; each kind launches only its kernel, the ordered turns' losses
   bit-equal.  Each graph is released before the next; the phase fails
   after the three steps if a check failed.  Phases 11, 12, 14, 16 and 17 train through
   ``train()``, which replays the compiled step on the card; phase 16 also
   times the PVD and pointwise steps compiled beside eager (the step
   makers' ``compiled=False``).
21. The compiled mesh step, after phase 20 (the JAX package jits its step
   over the mesh; here ``jit_step_for_mesh(compiled=True)`` over an NCCL
   process group of one, ``tcp://127.0.0.1`` on a free port: one captured
   graph of forward, ``backward()``, the gradients' flat all-reduce over
   the world, the fused capturable Adam and the loss's all-reduce): the
   ``ddpm`` step at B=TRAIN_BATCH, full width, bf16, fused routes on,
   three ways from one state (after an eager step; restored in place) and
   the same draws: the compiled mesh step, the eager DDP step
   (``compiled=False``) and the one-process compiled step, each graph
   released before the next run.  Each: two steps (warm-up and capture),
   then COMPILED_STEPS steps with the host clock around each (ending in
   ``float(loss)``), a BUSY_STEPS device-busy window, capture ms, pool
   bytes and peak memory; then the mesh step's COMPILED_STEPS replays
   once more, untimed.  Fails unless the mesh step's first loss equals
   the one-process compiled step's bit for bit, each replayed loss equals
   an eager forward of the state it starts from, its parameters after the
   steps are within 2 * lr * steps of both others, it holds one graph, and
   its launch counts equal the DDP step's with #1, #2, #4, #8 and the
   ordered scatter-add launched.  (b) Over the same group, the compiled
   ``upsample_16384`` x8 refine step beside the one-process compiled step
   (``training_setup("refine_x8")``, MESH_REFINE_STEPS steps after a
   warm-up and a capture each): its first loss equal bit for bit (the
   check), the later losses and the state at the end printed beside.
   ``--model-axis-cards N``
   adds, across N cards, the compiled (N, 1) and (N / 2, 2) mesh steps
   against the eager ones and one process (``mesh_steps_across_cards``).
22. The training step run to run, after phase 21 (the JAX package's
   jitted step repeats bit for bit; every backward of a gather in the
   port sums in a fixed order through the ordered scatter-add).  (a)
   ``order_diagnosis``: for each DIAGNOSED configuration two eager steps
   from one state on the same draws, every gradient compared bit for bit,
   the unequal tensors printed by module, then the same pair under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (only
   here) with what PyTorch flags; fails if a pair without the flag
   differs.  (b) ``repeat_check`` of each REPEATED configuration
   (``refine_x2``, ``refine_x4``, ``denoise``, new on the card, and
   ``pvd``, ``pointwise``) at B=TRAIN_BATCH, full width, bf16 (PVD in
   float32): two eager and two compiled runs of REPEAT_STEPS steps from
   one state, every loss, the parameters, Adam moments and step counts at
   the end, and the first step's gradients bit-equal across the four,
   launches equal, host ms, device ms and busy share (a SHORT_BUSY_STEPS
   window) each way; phase 20 ran the same on ``ddpm`` (both routes) and
   x8 refine.  Then a table of the eight configurations; fails after all
   parts if a check failed.
15. Prints the card's name and power limit, a ``{"kernels": [...]}`` line
   (``launches``: the sum over the driven paths, the ``ddpm_avg_max`` step,
   the two pipelines, the two training runs, the file-driven pipeline,
   the five runs of phase 16, the demo of phase 17 and the two ranks of
   phase 18 (a), the four graphed runs of phase 19, the three compiled
   runs of phase 20, the compiled mesh steps of phase 21 and the compiled
   runs of phase 22 (b), each counted from zero; kernel B launches only
   in phase 20's scatter-cost turns, ``atomic_scatter_steps``, as every
   caller takes the ordered kernel;
   ``launches_by_path``
   splits it; the FPS rows add ``latency_floor_ms``, the sweep's per-pick
   time at its smallest N times the row's npoint - 1, beside the roofline
   ``bound_ms``; the rows of those five kernels add their device ms a
   denoise step, a pipeline and a training step; the #8 and B rows their
   B=32 times and bounds; the ordered scatter-add's row its B=32 and
   chamfer times and bounds, the atomic B's and the deterministic
   ``index_put_``'s beside them; ``attention_finish_h``, h's GroupNorm
   vectors, is folded into sweep 2 (``folded_into``: no launch of its own,
   0 launches, null ms and bound, its error that of sweep 2's vectors
   against the plain F1), and ``attention_qn`` is what is left as a launch
   of the first design's ``attention_finish_stats``), and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 in the tensor cores
# position channels of the fused group are bf16 of float32 values computed
# the same way by both versions: they must agree exactly like the features
DENOISE_REL_TOL = 1e-2  # kernels vs plain versions, one bf16 denoise step
KNN_DIST_TOL = 0.0  # both compute the same separately rounded float32 sums
STEPS = 10  # reverse steps of the main-path run: enough for a steady step time
REFINE_REL_TOL = 1e-2  # kernels vs plain versions, one bf16 refine forward
FAST_STEPS = 50  # FastDPM length of the refine_fast50 experiment
# float32 sums of the same terms in another order (kernel B's atomics, or
# index_add_ on the card against the ordered kernel), relative to the
# largest: the gradients of ball_group_train
SCATTER_REL_TOL = 1e-5
# ... relative to each element's own sum of its terms' magnitudes, the scale
# of a reordered float32 sum's rounding error (every scatter-add check): a
# (b, row) that the empty balls of a batch row all land in takes tens of
# thousands of terms of either sign, whose signed sum is far below that
# scale, so a bound relative to the largest sum fails at random
SCATTER_ABS_REL_TOL = 1e-5
SCATTER_ABS_FLOOR = 1e-12
# a training step's gradients replayed from a captured graph against the
# eager step's, relative to the gradient's norm and to its largest entry
# (beside it, phase 20 holds them bit-equal).  Until PR 16 the x8 refine
# step's first-step gradients took one of two values run to run on the
# H100, eager and replayed alike (kernel B's float32 atomics: 1.46e-4 of
# the norm, 2.03e-4 of the largest entry), and this bound was 1e-3; every
# backward of a gather now sums in a fixed order.  The planted faults of
# phase 20 (half the batch, the next step's draws or output scale) read
# 0.081 or more.
GRAPH_GRAD_REL_TOL = 1e-5
TRAIN_BATCH = 32  # the JAX package's training benchmark batch
TRAIN_STEPS = 4  # steps of each training run
TIMED_STEPS = 2  # steps of each timed block (routes on, off, off, on)
POINTWISE_TIMED_STEPS = 20  # a pointwise step is ~25 ms
# the file-driven pipeline (phase 14): train items, clouds evaluated in the
# loop and generated from the test set, train_cli steps (at B = TRAIN_BATCH:
# one checkpoint with its in-loop eval at the end of the first epoch, then
# the last)
FILE_ITEMS = 64
FILE_TESTED = 8
FILE_STEPS = 3
# One bf16 training step, fused routes against unfused.  The forward values
# are the same (the first Dense rounds the unfused float32 group to bf16 as
# the fused group already is); the backward differs: the fused routes sum
# cotangents in float32, PyTorch's index backward sums them in the table's
# bf16, and bf16 roundings downstream amplify either.
ROUTE_LOSS_REL_TOL = 1e-2
ROUTE_GRAD_NORM_REL_TOL = 2e-2
ROUTE_GRAD_WORST_REL_TOL = 0.25
# kernels against plain versions, one training step: same forward values,
# float32 sums in another order in the backward, amplified by bf16 roundings
TRAIN_PLAIN_LOSS_REL_TOL = 1e-3
TRAIN_PLAIN_GRAD_REL_TOL = 1e-2
# a resumed run against the uninterrupted one: same state, same draws (set
# while kernel B's atomics summed the backward in an order that changed
# from run to run)
RESUME_REL_TOL = 1e-2

# The attention sweeps repeat their plain versions' rounding points and add
# the same float32 products in another order, so a few bf16 roundings flip
# (2^-8 of one term each).  Statistics: float32 sums of bf16 values, relative
# to the largest.  Output: relative to the largest output value.
ATTENTION_STATS_REL_TOL = 2e-3
ATTENTION_OUT_REL_TOL = 2e-2
# the fused pool keeps float32 softmax weights and a float32 result where the
# unfused pool rounds both to bf16
ATTENTION_UNFUSED_REL_TOL = 4e-2
# One bf16 network evaluation with the variants on against off: the JAX
# package's own bound for its whole network with its fused kernels on against
# off (absolute, outputs of order 1).
VARIANT_MAX_TOL = 8e-2
VARIANT_MEAN_TOL = 1.5e-2
# The same evaluation with the variants on, kernels against plain versions
# (relative L2).  The other kernels equal their plain versions bit for bit;
# the sweeps do not (up to 2.3e-3 of the largest output at the wide kNN-FP
# sites, above), and a bf16 network amplifies that like any other bf16
# perturbation: 0.8e-2 found at the B=4 denoise step, 1.2e-2 at the B=32
# refine forward, the size of the on-against-off difference itself.
VARIANT_PLAIN_REL_TOL = 3e-2
# PVCNN2 is float32 throughout.  Through the kernels against plain_ops() the
# kernels' outputs are equal; index_add_ (voxelize, the backward of every
# gather) adds float32 terms in another order, which the voxel attention's
# unscaled softmax amplifies (3e-5 of the output's scale between the JAX
# package and the port on the CPU, tests/test_torch_pvcnn.py)
PVD_PLAIN_LOSS_REL_TOL = 1e-4
PVD_PLAIN_GRAD_REL_TOL = 1e-3
# the kernels of a PVD training step: idx-only FPS, ball query, 3-NN
PVD_PATH_KERNELS = ("fps_idx", "ball_query", "knn")
# the two-stage demo of phase 17 (the JAX demo's T and batch; its data cut
# to 2 shapes a split, 16 test clouds and one train-set trial, and its steps
# to 40 + 20, to keep the phase near 3 minutes): DDPM training (#1, #8, B,
# #4, and #3 where no fused route serves), coarse generation (#1, #2, #3,
# #4), x2 refine training and evaluation (#1, #3, #4, #8, B)
DEMO_T = 100
DEMO_BATCH = 8
DEMO_SHAPES = 2
DEMO_TESTED = 16
DEMO_DDPM_STEPS = 40
DEMO_REFINE_STEPS = 20
DEMO_PATH_KERNELS = ("fps", "ball_group", "ball_query", "knn", "ball_query_group",
                     "group_scatter_ordered")
VARIANTS = (
    ("off", {}),
    ("attention", dict(fused_attention=True)),
    ("knn", dict(fused_knn=True)),
    ("packed", dict(packed=True)),
    ("all", dict(fused_attention=True, fused_knn=True, packed=True)),
    ("off again", {}),
)

TPU_KERNELS = {
    "fps_coords": "point_diffusion_refinement_tpu/ops/pallas_fps.py:197",
    "fps_idx": "point_diffusion_refinement_tpu/ops/pallas_fps.py:250",
    "ball_group": "point_diffusion_refinement_tpu/ops/pallas_window.py:853",
    "ball_query": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:88",
    "knn": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:169",
    "ball_query_group": "point_diffusion_refinement_tpu/ops/pallas_neighbors.py:287",
    # no Pallas kernel: the JAX backwards are one-hot einsums at these lines
    "group_scatter_add": "point_diffusion_refinement_tpu/models/grouping.py:51",
    "group_scatter_ordered": "point_diffusion_refinement_tpu/models/grouping.py:51",
    "attention_stats": "point_diffusion_refinement_tpu/ops/pallas_attention.py:79",
    "attention_hstats": "point_diffusion_refinement_tpu/ops/pallas_attention.py:110",
    "attention_out": "point_diffusion_refinement_tpu/ops/pallas_attention.py:138",
    # the XLA glue between the TPU sweeps: _group_mul_add (its statistics
    # and vectors now finished in sweep 1's last cluster, the query rows in
    # attention_qn), _pgn_mu_s_b (h's: in sweep 2's last cluster)
    "attention_qn": "point_diffusion_refinement_tpu/ops/pallas_attention.py:187",
    "attention_finish_h": "point_diffusion_refinement_tpu/ops/pallas_attention.py:204",
    # and its layout twin _knn_window_kernel_t at pallas_window.py:1385
    "knn_group": "point_diffusion_refinement_tpu/ops/pallas_window.py:1156",
}
LAUNCH_NAMES = {"fps_coords": "fps", "fps_idx": "fps_idx", "ball_group": "ball_group",
                "ball_query": "ball_query", "knn": "knn",
                "ball_query_group": "ball_query_group",
                "group_scatter_add": "group_scatter_add",
                "group_scatter_ordered": "group_scatter_ordered",
                "attention_stats": "attention_stats", "attention_hstats": "attention_hstats",
                "attention_out": "attention_out", "attention_qn": "attention_qn",
                # folded into sweep 2: no launch of its own
                "attention_finish_h": None, "knn_group": "knn_group"}
# the kernels of a training step with both fused routes on (the fused
# gather supersedes the ball-query kernel there)
TRAIN_PATH_KERNELS = ("ball_query_group", "group_scatter_ordered", "ball_group", "fps", "knn")
# the profiler's names of the kernels whose device time a denoise step, a
# pipeline and a training step is reported (fps_reg_kernel<kCoords, threads,
# per> and the workspace path's fps_global_kernel<kCoords>;
# group_scatter_add_kernel<float> and <__nv_bfloat16>; the four
# scatter_ordered_* kernels of one group_scatter_ordered launch)
PROFILED_KERNELS = {
    "fps": ("fps_reg_kernel<true", "fps_global_kernel<true"),
    "fps_idx": ("fps_reg_kernel<false", "fps_global_kernel<false"),
    "ball_query": ("ball_query_kernel",),
    "ball_group": ("ball_group_kernel",),
    "knn": ("knn_kernel",),
    "knn_group": ("knn_group_kernel",),
    "ball_query_group": ("ball_query_group_kernel",),
    "group_scatter_add": ("group_scatter_add_kernel",),
    "group_scatter_ordered": ("scatter_ordered_",),
}
FPS_SWEEP_N = (1024, 2048, 3072, 4096, 12288)  # npoint 1024, B = 4
# the kernels of ancestral coarse generation (phase 3); fps_idx serves
# mirror preprocessing
COARSE_PATH_KERNELS = ("fps", "ball_group", "ball_query", "knn")
# the kernels of the two-stage serving pipeline (phase 7)
PIPELINE_PATH_KERNELS = ("fps", "fps_idx", "ball_group", "ball_query", "knn")
# ... and what the accelerated inference configuration adds, on every denoise
# step and in the refine forward
VARIANT_PATH_KERNELS = ("attention_stats", "attention_qn", "attention_hstats", "attention_out",
                        "knn_group")
ATTENTION_KERNELS = VARIANT_PATH_KERNELS[:4]  # launched once each a fused pool call
SOURCES = {
    "fps_coords": "point_diffusion_refinement_tpu_torch/csrc/fps.cu",
    "fps_idx": "point_diffusion_refinement_tpu_torch/csrc/fps.cu",
    "ball_group": "point_diffusion_refinement_tpu_torch/csrc/ball_group.cu",
    "ball_query": "point_diffusion_refinement_tpu_torch/csrc/ball_query.cu",
    "knn": "point_diffusion_refinement_tpu_torch/csrc/knn.cu",
    "ball_query_group": "point_diffusion_refinement_tpu_torch/csrc/ball_query_group.cu",
    "group_scatter_add": "point_diffusion_refinement_tpu_torch/csrc/group_scatter.cu",
    "group_scatter_ordered": "point_diffusion_refinement_tpu_torch/csrc/group_scatter_ordered.cu",
    "attention_stats": "point_diffusion_refinement_tpu_torch/csrc/attention_pool.cu",
    "attention_hstats": "point_diffusion_refinement_tpu_torch/csrc/attention_pool.cu",
    "attention_out": "point_diffusion_refinement_tpu_torch/csrc/attention_pool.cu",
    "attention_qn": "point_diffusion_refinement_tpu_torch/csrc/attention_pool.cu",
    "attention_finish_h": "point_diffusion_refinement_tpu_torch/csrc/attention_pool.cu",
    "knn_group": "point_diffusion_refinement_tpu_torch/csrc/knn_group.cu",
}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
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


def free_port() -> int:
    """A free TCP port on the loopback address, for a process group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scanned_pairs(idx: torch.Tensor, counts: torch.Tensor, n: int) -> float:
    """(centre, point) pairs a first-K-in-index-order scan visits: up to the
    K-th hit for a full ball, the whole support otherwise."""
    K = idx.shape[-1]
    last = idx[..., K - 1].to(torch.float64) + 1.0
    full = counts >= K
    return float(torch.where(full, last, torch.full_like(last, float(n))).sum())


def kernel_sums(avgs) -> dict:
    """{kernel: (device ms, launches)} of PROFILED_KERNELS in a profile's
    ``key_averages()``."""
    out = {name: [0.0, 0] for name in PROFILED_KERNELS}
    for e in avgs:
        for name, keys in PROFILED_KERNELS.items():
            if any(k in e.key for k in keys):
                out[name][0] += e.self_device_time_total / 1e3
                out[name][1] += e.count
    return {name: tuple(v) for name, v in out.items()}


def format_sums(sums: dict, per: int = 1) -> str:
    return " ".join(f"{name}={ms / per:.4f} ms ({n / per:g} launches)"
                    for name, (ms, n) in sums.items())


def device_ms(fn, name: str, iters: int = 30) -> float:
    """Median device time a launch of kernel ``name`` (PROFILED_KERNELS)
    over ``iters`` calls of ``fn``, from the profiler: a CUDA-event time of a
    small kernel would measure its wrapper's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the trace on the card can miss device records of a window (5 of 10,
    # 8 of 30, and in whole windows of 10 all of them) and keep some too
    # short (a mean of 21 seen read half the kernel's time), so each window
    # pads the timed launches with as many before and after them, the
    # median is over the launches it saw, and a window that saw none is
    # taken again; after three such windows the time is CUDA events' mean
    # a call, said so, which counts the wrapper's host time where that is
    # the longer
    keys = PROFILED_KERNELS[name]
    calls = 3 * iters
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and any(k in e.name for k in keys))
        if us:
            break
        print(f"profiler: no device record of {name} in a window of {calls}", flush=True)
    n = len(us)
    if n > calls:
        raise AssertionError(f"profiler saw {n} launches of {name} in a window of {calls}")
    if n == 0:
        ms = time_ms(fn, iters, warmup=1)
        print(f"profiler: no device record of {name} in three windows; {ms:.4f} ms a call "
              f"by CUDA events instead", flush=True)
        return ms
    if n < calls:
        print(f"profiler: {n} of {calls} device records of {name} in its window", flush=True)
    mid = n // 2
    return (us[mid] if n % 2 else 0.5 * (us[mid - 1] + us[mid])) / 1e3


def window_device_ms(fn, calls: int = 30) -> float:
    """Device ms a call of ``fn`` summed over every device activity it
    starts (a wrapper that launches several kernels and a memset), from the
    profiler over ``calls`` calls after a warm-up; CUDA events' mean a call
    where the window holds no device record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us == 0:
        print("profiler: no device record in the window; CUDA events instead", flush=True)
        return time_ms(fn, calls, warmup=1)
    return us / 1e3 / calls


def launch_breakdown(fn, calls: int = 10) -> str:
    """The profiler's device ms a call of ``fn`` by kernel (and memset), over
    ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(re.sub(r"^(?:void )?(?:\(anonymous namespace\)::)?", "", e.key).split("(")[0],
             e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return " ".join(f"{k}={v:.4f}" for k, v in sorted(rows, key=lambda kv: -kv[1]))


# kernels and memsets a call of the ordered scatter-add starts (count, scan,
# fill, sum and the memset of the counts), at every shape
ORDERED_LAUNCHES = 5
# the node types of a CUDA graph (CUgraphNodeType) that launch device work
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_launches(fn, launched: dict = None) -> dict:
    """The device work one call of ``fn`` starts, counted exactly: the call
    (after a warm-up) is captured in a CUDA graph, and the graph's nodes
    are counted by type through libcuda (``cuGraphGetNodes``), which drops
    nothing, as the profiler's records may.  ``launched``, where given,
    receives the wrappers' launch counts of the capture."""
    import ctypes

    from point_diffusion_refinement_tpu_torch.ops import kernels

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = dict(kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        fn()
    if launched is not None:
        launched.update({n: kernels.LAUNCHES[n] - before[n] for n in before
                         if kernels.LAUNCHES[n] != before[n]})
    kernels.LAUNCHES.update(before)
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = GRAPH_NODE_KINDS.get(kind.value, f"type {kind.value}")
        kinds[name] = kinds.get(name, 0) + 1
    graph.reset()
    return kinds


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"


def ball_query_row(sup, q, r: float, K: int, name: str) -> dict:
    """Kernel vs plain (idx and counts equal) and the times of one ball-query
    shape."""
    from point_diffusion_refinement_tpu_torch.ops import neighbors

    idx, cnt = neighbors.ball_query(sup, q, r, K)
    ridx, rcnt = neighbors.ball_query_plain(sup, q, r, K)
    torch.cuda.synchronize()
    if not (torch.equal(idx, ridx) and torch.equal(cnt, rcnt)):
        raise AssertionError(f"ball_query: differs at {name}")
    run = lambda: neighbors.ball_query(sup, q, r, K)
    ms = device_ms(run, "ball_query")
    wrapper_ms = time_ms(run, 20)
    plain_ms = time_ms(lambda: neighbors.ball_query_plain(sup, q, r, K), 5)
    b_ms, b_by = bound(nbytes(sup, q, ridx, rcnt), 9.0 * scanned_pairs(ridx, rcnt, sup.shape[1]))
    return dict(name="ball_query", shape=name, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, wrapper_ms=wrapper_ms,
                mean_count=float(rcnt.float().mean()))


def fps_sweep(dev, rng) -> float:
    """Phase 2: FPS with coordinates at npoint 1024 over FPS_SWEEP_N (B = 4):
    the wrapper's (threads, points a thread), marked *, and every runner-up
    the kernel builds that holds N in at most twice N slots, each bit-equal
    to the plain version.  Returns the latency floor a pick: the wrapper's
    time at the smallest N over npoint - 1."""
    from point_diffusion_refinement_tpu_torch.ops import sampling

    B, npoint = 4, 1024
    chosen = []
    for N in FPS_SWEEP_N:
        pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)).to(dev)
        ridx, rco = sampling.furthest_point_sample_and_gather_plain(pts, npoint)
        best = sampling.fps_block_config(N)
        configs = [best] + [c for c in sampling.FPS_CONFIGS
                            if c != best and N <= c[0] * c[1] <= 2 * N]
        cells = []
        for cfg in configs:
            run = lambda cfg=cfg: sampling._fps_launch(pts, npoint, True, config=cfg)
            idx, co = run()
            torch.cuda.synchronize()
            if not (torch.equal(idx, ridx) and torch.equal(co, rco)):
                raise AssertionError(f"fps: {cfg[0]}x{cfg[1]} differs from plain at N={N}")
            ms = time_ms(run, 10)
            if cfg == best:
                chosen.append(ms)
            cells.append(f"{cfg[0]}x{cfg[1]}{'*' if cfg == best else ''} ms={ms:.4f} "
                         f"us_per_pick={ms * 1e3 / (npoint - 1):.4f}")
        print(f"fps sweep (4,{N})->{npoint} equal to plain: " + "; ".join(cells), flush=True)
    slope, intercept = np.polyfit(np.array(FPS_SWEEP_N, dtype=np.float64), chosen, 1)
    print(f"fps sweep fit: ms = {intercept:.4f} + {slope * 1e3:.6f} us x N, i.e. "
          f"{intercept * 1e3 / (npoint - 1):.4f} us a pick + "
          f"{slope * 1e6 / (npoint - 1):.4f} ns a point a pick", flush=True)
    return chosen[0] / (npoint - 1)


def check_kernels(dev, rng, pick_floor_ms: float):
    """Phase 2: every kernel against its plain version at main-path shapes;
    ``pick_floor_ms`` is the FPS sweep's latency floor a pick."""
    from point_diffusion_refinement_tpu_torch.ops import ball_group, ball_group_plain
    from point_diffusion_refinement_tpu_torch.ops import neighbors, sampling

    B = 4
    x_t = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 3072, 3)).astype(np.float32)).to(dev)
    rows = []

    # -- FPS with coordinates: SA level 0 of x_t every step (2048 -> 1024) and
    #    of the condition once (3072 -> 1024)
    worst = 0.0
    for pts in (x_t, cond):
        idx, co = sampling.furthest_point_sample_and_gather(pts, 1024)
        ridx, rco = sampling.furthest_point_sample_and_gather_plain(pts, 1024)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            raise AssertionError(f"fps: indices differ at N={pts.shape[1]}")
        err = float((co - rco).abs().max())
        if err != 0.0:
            raise AssertionError(f"fps: coordinates differ by {err}")
        worst = max(worst, err)
    pts = x_t
    ms = time_ms(lambda: sampling.furthest_point_sample_and_gather(pts, 1024), 10)
    plain_ms = time_ms(lambda: sampling.furthest_point_sample_and_gather_plain(pts, 1024), 2, 1)
    N = pts.shape[1]
    b_ms, b_by = bound(nbytes(pts) + B * 1024 * 16, 10.0 * B * 1023 * N)
    rows.append(dict(name="fps_coords", shape="(4,2048,3)->1024", max_abs_err=worst,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, latency_floor_ms=pick_floor_ms * 1023))

    # -- fused ball group: the level-0 feature-transfer pair (two tables,
    #    queries = x_t, support = condition) and the x_t SA level-0 grouping
    _, sa_centres = sampling.furthest_point_sample_and_gather_plain(x_t, 1024)
    t_enc = torch.randn(B, 3072, 4, device=dev).to(torch.bfloat16)
    t_dec = torch.randn(B, 3072, 32, device=dev).to(torch.bfloat16)
    t_sa = torch.randn(B, 2048, 35, device=dev).to(torch.bfloat16)
    cases = [
        ("ft0", cond, [t_enc, t_dec], x_t, "center_zero"),
        ("sa0", x_t, [t_sa], sa_centres, "row0"),
    ]
    worst = 0.0
    for tag, sup, tabs, q, mode in cases:
        outs, cnt = ball_group(sup, tabs, q, 0.1, 32, include_center=True,
                                      empty_mode=mode)
        routs, rcnt = ball_group_plain(sup, tabs, q, 0.1, 32, include_center=True,
                                              empty_mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(cnt, rcnt):
            raise AssertionError(f"ball_group {tag}: counts differ")
        for o, r in zip(outs, routs):
            err = float((o.float() - r.float()).abs().max())
            if err != 0.0:
                raise AssertionError(f"ball_group {tag}: grouped values differ by {err}")
            worst = max(worst, err)
    sup, tabs, q, mode = cond, [t_enc, t_dec], x_t, "center_zero"
    run = lambda: ball_group(sup, tabs, q, 0.1, 32, True, mode)
    ms = device_ms(run, "ball_group")
    wrapper_ms = time_ms(run, 20)
    plain_ms = time_ms(lambda: ball_group_plain(sup, tabs, q, 0.1, 32, True, mode), 5)
    ridx, rcnt = neighbors.ball_query_plain(sup, q, 0.1, 32)
    outs, _ = ball_group_plain(sup, tabs, q, 0.1, 32, True, mode)
    pairs = scanned_pairs(ridx, rcnt, sup.shape[1])
    b_ms, b_by = bound(nbytes(sup, q, *tabs, *outs, rcnt), 9.0 * pairs)
    scan_ms = ball_group_split(sup, tabs, q, mode, outs, rcnt, ridx)
    rows.append(dict(name="ball_group", shape="FT0 sup (4,3072) q (4,2048) K=32 C=4+32",
                     max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, wrapper_ms=wrapper_ms,
                     scan_ms=scan_ms, mean_count=float(rcnt.float().mean())))

    # -- ball query: condition SA level 0 (3072 support, 1024 centres) and the
    #    K > N case of the 16-point level (decoder FT 4: 16 support points)
    _, c_centres = sampling.furthest_point_sample_and_gather_plain(cond, 1024)
    small = c_centres[:, :16].contiguous()
    for sup, q, r in ((cond, c_centres, 0.1), (small, x_t, 1.6)):
        idx, cnt = neighbors.ball_query(sup, q, r, 32)
        ridx, rcnt = neighbors.ball_query_plain(sup, q, r, 32)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(cnt, rcnt)):
            raise AssertionError(f"ball_query: differs at N={sup.shape[1]}, M={q.shape[1]}")
    rows.append(ball_query_row(cond, c_centres, 0.1, 32, "sup (4,3072) centres (4,1024) K=32"))

    # -- kNN: the x_t feature propagation at level 0 (2048 queries, 1024 known)
    unknown, known = x_t, sa_centres
    err = check_knn(unknown, known, t_sa)
    run = lambda: neighbors.knn(unknown, known, 8)
    ms = device_ms(run, "knn")
    wrapper_ms = time_ms(run, 20)
    rd, ri = neighbors.knn_plain(unknown, known, 8)
    plain_ms = time_ms(lambda: neighbors.knn_plain(unknown, known, 8), 5)
    lib_ms = time_ms(
        lambda: torch.topk(torch.cdist(unknown, known), 8, dim=-1, largest=False), 20)
    M, N = unknown.shape[1], known.shape[1]
    b_ms, b_by = bound(nbytes(unknown, known, rd, ri), 10.0 * B * M * N)
    rows.append(dict(name="knn", shape="q (4,2048) pts (4,1024) k=8", max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms, wrapper_ms=wrapper_ms))
    for r in rows:
        print_row(r)
    return rows


def ball_group_split(sup, tabs, q, mode, routs, rcnt, ridx) -> float:
    """Phase 2, kernel #2 at FT0: every queries-a-warp choice the kernel
    takes, bit-equal to the plain version, with its device ms (the wrapper's
    choice marked *), and the scan alone (counts and idx, no grouped
    output) at the wrapper's choice.  Returns the scan's device ms."""
    from point_diffusion_refinement_tpu_torch.ops.ball_group import (
        BALL_GROUP_QUERIES_PER_WARP,
        _launch,
    )

    cnt, idx = torch.empty_like(rcnt), torch.empty_like(ridx)
    outs = [torch.empty_like(o) for o in routs]
    cells = []
    for qpw in (1, 2, 4):
        run = lambda: _launch(sup, tabs, q, 0.1, 32, True, mode, outs, cnt, idx, qpw)
        run()
        torch.cuda.synchronize()
        if not (torch.equal(cnt, rcnt) and torch.equal(idx, ridx)
                and all(torch.equal(o, r) for o, r in zip(outs, routs))):
            raise AssertionError(f"ball_group: {qpw} queries a warp differ from plain")
        star = "*" if qpw == BALL_GROUP_QUERIES_PER_WARP else ""
        cells.append(f"{qpw}{star} ms={device_ms(run, 'ball_group'):.4f}")
    scan = lambda: _launch(sup, tabs, q, 0.1, 32, True, mode, None, cnt, idx)
    scan_ms = device_ms(scan, "ball_group")
    if not (torch.equal(cnt, rcnt) and torch.equal(idx, ridx)):
        raise AssertionError("ball_group: the scan alone differs from plain")
    print(f"ball_group FT0 queries a warp, equal to plain: {'; '.join(cells)}; "
          f"scan alone (no grouped output) ms={scan_ms:.4f}", flush=True)
    return scan_ms


def check_knn(unknown, known, feats) -> float:
    """Phase 2, kernel #4 at FP0: every lane count a query the kernel takes,
    at B=4 and at B=32 (the batch of the refine forward and of training),
    bit-equal to the plain version, with its device ms (the wrapper's choice
    marked *); k = 32 and k = N; and ``query_and_group`` with
    ``neighbor_definition="nn"`` at nsample 32 (SA level 0's shapes) through
    the kernel against the plain route.  Returns the largest distance
    difference (0)."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.models.grouping import query_and_group
    from point_diffusion_refinement_tpu_torch.ops import neighbors

    worst = 0.0
    gen = torch.Generator(device=unknown.device)
    gen.manual_seed(31)
    wide_q = torch.randn(32, *unknown.shape[1:], generator=gen, device=unknown.device)
    wide_p = torch.randn(32, *known.shape[1:], generator=gen, device=unknown.device)
    for q, pts in ((unknown, known), (wide_q, wide_p)):
        B, M, N = q.shape[0], q.shape[1], pts.shape[1]
        cells = []
        for k in ((8, 32, N) if B == unknown.shape[0] else (8,)):
            rd, ri = neighbors.knn_plain(q, pts, k)
            for lanes in ((1, 2, 4, 8) if k == 8 else (None,)):
                run = lambda: neighbors._knn_launch(q, pts, k, lanes)
                d, i = run()
                torch.cuda.synchronize()
                err = float((d - rd).abs().max())
                if not torch.equal(i, ri) or err > KNN_DIST_TOL:
                    raise AssertionError(f"knn: B={B} k={k}, {lanes} lanes a query differ")
                worst = max(worst, err)
                if k == 8:
                    star = "*" if lanes == neighbors.knn_lanes(B * M) else ""
                    cells.append(f"{lanes}{star} ms={device_ms(run, 'knn'):.4f}")
        print(f"knn FP0 q ({B},{M}) pts ({B},{N}) k=8 lanes a query, equal to plain"
              f"{' (and k=32, k=N)' if B == unknown.shape[0] else ''}: " + "; ".join(cells),
              flush=True)
    kw = dict(radius=0.1, nsample=32, neighbor_def="nn", include_abs_coordinate=True,
              include_center_coordinate=True)
    ops.reset_launch_counts()
    got = query_and_group(unknown, known, feats[:, :unknown.shape[1]], **kw)
    launched = ops.launch_counts()["knn"]
    with ops.plain_ops():
        ref = query_and_group(unknown, known, feats[:, :unknown.shape[1]], **kw)
    torch.cuda.synchronize()
    if launched != 1 or not torch.equal(got.features, ref.features):
        raise AssertionError("query_and_group nn 32: differs from plain or took no kernel")
    print(f"query_and_group(nn, 32) q ({tuple(known.shape[:2])}) support "
          f"{tuple(unknown.shape[:2])}: knn launches=1, equal to plain", flush=True)
    return worst


def mirrored_partials(rng, B: int, n: int) -> np.ndarray:
    """Seeded partials of the MVP kind: some points on z = 0 (their mirror
    images are exact duplicates) and zero padding at the end of each."""
    p = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    p[:, : n // 8, 2] = 0.0
    p[:, n - n // 16:] = 0.0
    return p


def check_fps_idx(dev, rng, pick_floor_ms: float):
    """Phase 2, idx-only FPS: the mirror-preprocessing shapes and a row
    beyond shared memory, against the plain version."""
    from point_diffusion_refinement_tpu_torch.ops import gather_points, sampling

    def mirrored_xyz(B, n):
        p = mirrored_partials(rng, B, n)
        p[-1] = 0.0  # an all-padding cloud
        return torch.from_numpy(np.concatenate([p, p * np.float32([1, 1, -1])], 1)).to(dev)

    pre = mirrored_xyz(64, 2048)
    big = mirrored_xyz(2, 8192)
    for pts, npoint in ((pre, 3072), (pre, 2048), (big, 2048)):
        idx = sampling.furthest_point_sample(pts, npoint)
        ridx = sampling.furthest_point_sample_plain(pts, npoint)
        torch.cuda.synchronize()
        if not torch.equal(idx, ridx):
            raise AssertionError(f"fps_idx: indices differ at {tuple(pts.shape)} -> {npoint}")
    cidx, co = sampling.furthest_point_sample_and_gather(big, 2048)
    torch.cuda.synchronize()
    if not (torch.equal(cidx, ridx) and torch.equal(co, gather_points(big, ridx))):
        raise AssertionError("fps: the coordinates kernel differs at N=16384")
    big_ms = time_ms(lambda: sampling.furthest_point_sample(big, 2048), 3, 1)
    print(f"kernel fps_idx (2,16384)->2048 equal to plain; ms={big_ms:.4f} "
          f"(global-memory rows)", flush=True)
    B, N, npoint = 64, pre.shape[1], 3072
    ms = time_ms(lambda: sampling.furthest_point_sample(pre, npoint), 5)
    plain_ms = time_ms(lambda: sampling.furthest_point_sample_plain(pre, npoint), 1, 1)
    b_ms, b_by = bound(nbytes(pre) + B * npoint * 4, 10.0 * B * (npoint - 1) * N)
    row = dict(name="fps_idx", shape="(64,4096)->3072", max_abs_err=0.0, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
               latency_floor_ms=pick_floor_ms * (npoint - 1))
    print_row(row)
    return row


ROW_EXTRAS = ("latency_floor_ms", "wrapper_ms", "scan_ms", "mean_count", "ms_bf16_slice",
              "bound_ms_bf16_slice", "ms_b32", "wrapper_ms_b32", "bound_ms_b32",
              "ms_bf16_slice_b32", "library_ms_b32", "ms_chamfer", "bound_ms_chamfer",
              "library_ms_chamfer", "atomic_ms", "atomic_ms_b32", "atomic_ms_chamfer",
              "launches_a_call", "ms_pair", "ms_two_singles")
# words a row carries into the kernels line (work folded into another kernel)
ROW_NOTES = ("folded_into", "folds")


def print_row(r) -> None:
    def num(k, spec):  # a row folded into another kernel has no ms or bound
        return "null" if r[k] is None else format(r[k], spec)

    extras = "".join(f" {k}={r[k]:.4f}" for k in ROW_EXTRAS if k in r)
    print(f"kernel {r['name']:<17} {r['shape']:<42} max_abs_err={r['max_abs_err']:.3g} "
          f"ms={num('ms', '.4f')} plain_ms={r['plain_ms']:.4f} "
          f"bound_ms={num('bound_ms', '.5f')} ({r['bound_by']}) "
          f"library_ms={r['library_ms']}{extras}", flush=True)


def profile_window(what: str, fn, steps: int = 3, grad: bool = False,
                   table: bool = True, kernels: str = ""):
    """Device time by op and the device-busy share of a window of ``steps``
    calls of ``fn`` (one stream, so kernel times do not overlap); ``grad``
    keeps autograd on, for a training step; ``table=False`` prints the
    summary line only; ``kernels`` names one call (``"a denoise step"``) and
    prints the device ms of PROFILED_KERNELS a call, which it returns."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.set_grad_enabled(grad), profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in avgs
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy = dev_us / 1e3 / wall_ms
    print(f"profile: {steps} {what}, wall_ms={wall_ms:.2f} (profiled) "
          f"device_ms={dev_us / 1e3:.2f} device_busy={busy:.3f}", flush=True)
    if table:
        print(avgs.table(sort_by="self_device_time_total", row_limit=25), flush=True)
    if kernels:
        sums = kernel_sums(avgs)
        print(f"kernel device ms {kernels}: {format_sums(sums, steps)}", flush=True)
        return {name: ms / steps for name, (ms, _) in sums.items()}
    return None


def check_denoise_ball_queries(model, cond, label, dev) -> None:
    """Phase 2: the ball query at every shape one denoise step launches it at
    (SA and FT levels >= 2, and the decoder FT's 16-point level, where
    K > N), on the tensors the step gives it."""
    from point_diffusion_refinement_tpu_torch.models import grouping

    B = cond.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn(B, 2048, 3, generator=gen, device=dev)
    ts = torch.full((B,), 5.0, device=dev)
    seen, calls, orig = {}, {}, grouping.ball_query

    def spy(xyz, new_xyz, radius, nsample):
        key = (xyz.shape[1], new_xyz.shape[1], float(radius), int(nsample))
        calls[key] = calls.get(key, 0) + 1
        seen.setdefault(key, (xyz.clone(), new_xyz.clone()))
        return orig(xyz, new_xyz, radius, nsample)

    with torch.no_grad():
        cf = model.encode_condition(cond)
        grouping.ball_query = spy
        try:
            model.denoise(x, ts, label, cf, fused=True)
        finally:
            grouping.ball_query = orig
    print(f"ball queries of one denoise step, (N, M, r, K): launches = {calls}", flush=True)
    if not calls:
        raise AssertionError("the denoise step launched no ball query")
    for (N, M, r, K), (sup, q) in seen.items():
        print_row(ball_query_row(sup, q, r, K, f"step sup ({B},{N}) centres ({B},{M}) K={K} r={r}"))


def avg_max_step(rng, dev) -> dict:
    """Phase 4b: ``EXPERIMENTS["ddpm_avg_max"]`` (avg_max pooling, global
    self-attention after the two coarsest set abstractions and kNN feature
    propagations) in bf16 at full width with seeded weights: one B=4 encode
    and denoise step through the kernels, launch counts reset just before
    and read just after, against the same step under ``plain_ops()``."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.ops import kernels

    B = 4
    cfg = dict(EXPERIMENTS["ddpm_avg_max"]()["pointnet_config"], compute_dtype="bfloat16")
    model = PointNet2CloudCondition.from_config(cfg, device="cuda", seed=3)
    cond = conditions(rng, B, dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    x = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    ts = torch.full((B,), 5.0, device=dev)
    with torch.no_grad():
        model.denoise(x, ts, label, model.encode_condition(cond), fused=True)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        y_k = model.denoise(x, ts, label, model.encode_condition(cond), fused=True).float()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        with kernels.plain_ops():
            y_p = model.denoise(x, ts, label, model.encode_condition(cond), fused=True).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    finite = bool(torch.isfinite(y_k).all())
    print(f"ddpm_avg_max: encode + denoise step B={B} ms={ms:.2f} out={tuple(y_k.shape)} "
          f"finite={finite} launches={counts} kernels vs plain rel_err={rel:.3g} "
          f"(tol {DENOISE_REL_TOL})", flush=True)
    if tuple(y_k.shape) != (B, 2048, 3) or not finite:
        raise AssertionError("ddpm_avg_max: the denoise step is not a finite (4, 2048, 3) cloud")
    if not rel <= DENOISE_REL_TOL:
        raise AssertionError("ddpm_avg_max: the step through the kernels disagrees with plain")
    for name in COARSE_PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"ddpm_avg_max: kernel {name} was not launched")
    return counts


def wide_ball_step(cond, label, dev) -> None:
    """Phase 4c: ``DEFAULT_POINTNET_CONFIG`` with nsample 96 (radius 0.5) at
    level 0 of the x_t set abstraction and of the feature-transfer pair, in
    bf16 at full width: one denoise step with ``fused=True`` (both take the
    fused ball group at K = 96, past its 64-slot pass) through the kernels
    against ``plain_ops()``."""
    import copy

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import DEFAULT_POINTNET_CONFIG
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.ops import kernels

    cfg = copy.deepcopy(dict(DEFAULT_POINTNET_CONFIG))
    cfg["compute_dtype"] = "bfloat16"
    cfg["architecture"]["nsample"][0] = 96
    cfg["architecture"]["radius"][0] = 0.5
    fm = cfg["feature_mapper_architecture"]
    fm["encoder_nsample"][0] = fm["decoder_nsample"][0] = 96
    fm["encoder_radius"][0] = fm["decoder_radius"][0] = 0.5
    model = PointNet2CloudCondition.from_config(cfg, device="cuda", seed=4)
    B = cond.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    x = torch.randn(B, 2048, 3, generator=gen, device=dev)
    ts = torch.full((B,), 5.0, device=dev)
    _, centres = ops.furthest_point_sample_and_gather(x, 1024)
    _, n = ops.ball_query(x, centres, 0.5, 96)
    with torch.no_grad():
        cf = model.encode_condition(cond)
        ops.reset_launch_counts()
        y_k = model.denoise(x, ts, label, cf, fused=True).float()
        torch.cuda.synchronize()
        launched = ops.launch_counts()["ball_group"]
        with kernels.plain_ops():
            y_p = model.denoise(x, ts, label, model.encode_condition(cond), fused=True).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    print(f"nsample 96 at level 0: denoise step B={B} ball_group launches={launched}, "
          f"x_t SA0 balls above 64 points={float((n > 64).float().mean()):.3f} "
          f"full={float((n == 96).float().mean()):.3f}; kernels vs plain rel_err={rel:.3g} "
          f"(tol {DENOISE_REL_TOL}) finite={bool(torch.isfinite(y_k).all())}", flush=True)
    if launched < 2 or not bool((n > 64).any()):
        raise AssertionError("nsample 96: the fused ball group ran no ball past 64 points")
    if not (rel <= DENOISE_REL_TOL and bool(torch.isfinite(y_k).all())):
        raise AssertionError("nsample 96: the denoise step through the kernels disagrees")


def check_any_nsample(dev) -> None:
    """Phase 10: kernels #2 and #8 past their 64-slot pass, bit-equal to
    their plain versions: #2 at K = 96 and 160 (both empty modes, two tables
    and one, with and without the centre channels), #8 at K = 160 and at
    K > N; idx and counts equal the ball-query kernel's."""
    from point_diffusion_refinement_tpu_torch import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    sup = torch.rand(4, 3072, 3, generator=gen, device=dev) * 2 - 1
    q = torch.rand(4, 1000, 3, generator=gen, device=dev) * 2 - 1
    q[:, ::7] += 5.0  # empty balls
    tabs = [torch.randn(4, 3072, 4, generator=gen, device=dev),
            torch.randn(4, 3072, 32, generator=gen, device=dev)]
    table = torch.randn(4, 3072, 35, generator=gen, device=dev)
    seen = []
    for K in (96, 160):
        qi, qn = ops.ball_query(sup, q, 0.5, K)
        for mode in ("center_zero", "row0"):
            for t in (tabs, tabs[1:]):
                for center in (False, True):
                    outs, n, i = ops.ball_group(sup, t, q, 0.5, K, center, mode, return_idx=True)
                    routs, rn, ri = ops.ball_group_plain(sup, t, q, 0.5, K, center, mode,
                                                         return_idx=True)
                    torch.cuda.synchronize()
                    if not (torch.equal(n, rn) and torch.equal(i, ri) and torch.equal(n, qn)
                            and torch.equal(i, qi)
                            and all(torch.equal(o, r) for o, r in zip(outs, routs))):
                        raise AssertionError(f"ball_group K={K} {mode}: differs from plain")
        seen.append(qn)
    small = sup[:, :40].contiguous()
    for s_, K, r in ((sup, 160, 0.5), (small, 64, 1.0), (small, 160, 9.0)):
        g, i, n = ops.ball_query_group(s_, q, table[:, :s_.shape[1]].contiguous(), r, K)
        rg, ri, rn = ops.ball_query_group_plain(s_, q, table[:, :s_.shape[1]], r, K)
        qi, qn = ops.ball_query(s_, q, r, K)
        torch.cuda.synchronize()
        if not (torch.equal(g, rg) and torch.equal(i, ri) and torch.equal(n, rn)
                and torch.equal(i, qi) and torch.equal(n, qn)):
            raise AssertionError(f"ball_query_group N={s_.shape[1]} K={K}: differs from plain")
        seen.append(n)
    n = torch.cat([c.flatten() for c in seen])
    if not (bool((n == 0).any()) and bool(((n > 64) & (n < 160)).any())
            and bool((n == 160).any())):
        raise AssertionError("any nsample: the cases hold no empty, no 65..159 or no full ball")
    print("kernels ball_group (K=96, 160; both modes, 1 and 2 tables, centre on and off) and "
          "ball_query_group (K=160; K=64 and 160 > N=40) equal to plain and to ball_query",
          flush=True)


def preprocess(rng) -> None:
    """Phase 6: mirror preprocessing at the preprocessing CLI's sizes."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.data import generate_mirrored_partials

    partials = mirrored_partials(rng, 256, 2048)
    generate_mirrored_partials(partials[:64], 3072)  # warm-up, uncounted
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_mirrored_partials(partials, 3072, batch_size=64)
    secs = time.perf_counter() - t0
    n = ops.launch_counts()["fps_idx"]
    flags = np.unique(out[..., 3])
    print(f"preprocess: 256 partials x 2048 -> {out.shape} in {secs * 1e3:.1f} ms, "
          f"{256 / secs:.1f} clouds/s, fps_idx launches={n}, flags={flags.tolist()}",
          flush=True)
    if out.shape != (256, 3072, 4) or n != 4 or set(flags.tolist()) != {-1.0, 1.0}:
        raise AssertionError("preprocessing output or launches are wrong")


def upsample_refiner(seed: int, **routes):
    """The ``upsample_16384`` refine net (bf16, include_t=False, x8) with
    seeded weights, and its refiner (``routes``: the opt-in inference
    routes of ``make_refiner``)."""
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.sample import make_refiner

    cfg = EXPERIMENTS["upsample_16384"]()
    pc = cfg["pointnet_config"]
    model = PointNet2CloudCondition.from_config(pc, device="cuda", seed=seed)
    refine = make_refiner(model, int(pc["point_upsample_factor"]),
                          bool(pc["include_displacement_center_to_final_output"]), **routes)
    return model, refine, float(cfg["refine_config"]["output_scale_factor"])


def conditions(rng, B: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, 3072, 3)),
         rng.integers(0, 2, (B, 3072, 1)) * 2.0 - 1.0], axis=-1).astype(np.float32)).to(dev)


def pipeline(model, rng, dev, tag: str = "pipeline", kernel_ms_out=None, timings_out=None,
             **routes):
    """Phase 7: mirror -> FastDPM-50 -> refine x8 -> CD/F1 at B=4, with the
    launch counts of the whole run.  ``routes`` turns on the opt-in inference
    routes of the sampler and the refiner; their kernels must then have been
    launched on every denoise step and in the refine forward.  Given a dict
    ``kernel_ms_out``, mirror -> FastDPM-50 -> refine runs once more under the
    profiler and the device ms of PROFILED_KERNELS go into it; given a dict
    ``timings_out``, the FastDPM time (``fastdpm_ms``) goes into it."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.data import mirror_and_concat
    from point_diffusion_refinement_tpu_torch.diffusion import (
        calc_diffusion_hyperparams,
        make_fast_sampling_plan,
    )
    from point_diffusion_refinement_tpu_torch.sample import evaluate, make_coarse_sampler

    B = 4
    dc = EXPERIMENTS["refine_fast50"]()["diffusion_config"]
    T, b0, bT = int(dc["T"]), float(dc["beta_0"]), float(dc["beta_T"])
    schedule = calc_diffusion_hyperparams(T, b0, bT)
    plan = make_fast_sampling_plan(schedule, T, b0, bT, length=FAST_STEPS,
                                   sampling_method="var", noise_schedule="quadratic",
                                   kappa=0.5)
    sampler = make_coarse_sampler(model, schedule, 2048, fast_plan=plan, **routes)
    refiner_model, refine, osf = upsample_refiner(seed=1, **routes)
    raw = torch.from_numpy(mirrored_partials(rng, B, 2048)).to(dev)
    gt = rng.uniform(-0.5, 0.5, (B, 16384, 3)).astype(np.float32)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    with torch.no_grad():  # warm-up of the refine net's first-use allocations
        refine(torch.randn(B, 2048, 3, device=dev), conditions(rng, B, dev), label, osf)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cond = mirror_and_concat(raw, 3072)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen.manual_seed(3)
    coarse = sampler(cond, label, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sampler_counts = ops.launch_counts()
    timing = {}

    def generate(batch):
        t = time.perf_counter()
        out = refine(coarse, cond, label, osf)
        torch.cuda.synchronize()
        timing["refine_ms"] = (time.perf_counter() - t) * 1e3
        return out

    res = evaluate(generate, [{"complete": gt, "label": np.zeros(B)}], compute_emd=False,
                   keep_generated=True, print_every=1)
    counts = ops.launch_counts()
    fast_ms = (t2 - t1) * 1e3
    if timings_out is not None:
        timings_out["fastdpm_ms"] = fast_ms
    out = res.generated
    finite = bool(np.isfinite(out).all())
    print(f"{tag}: B={B} routes={routes} mirror_ms={(t1 - t0) * 1e3:.2f} fastdpm{FAST_STEPS}_ms={fast_ms:.1f} "
          f"fastdpm_step_ms={fast_ms / FAST_STEPS:.2f} "
          f"fastdpm_ms_per_completion={fast_ms / B:.1f} refine_ms={timing['refine_ms']:.2f}",
          flush=True)
    print(f"{tag} metrics: cd_p={res.metrics['cd_p'].tolist()} "
          f"cd_t={res.metrics['cd_distance'].tolist()} f1={res.metrics['f1'].tolist()}",
          flush=True)
    print(f"{tag} output: coarse={tuple(coarse.shape)} refined={out.shape} "
          f"finite={finite} launches={counts}", flush=True)
    if out.shape != (B, 16384, 3) or not finite or tuple(coarse.shape) != (B, 2048, 3):
        raise AssertionError("pipeline output is not a finite (4, 16384, 3) cloud")
    if not all(np.isfinite(res.metrics[k]).all() for k in ("cd_p", "cd_distance", "f1")):
        raise AssertionError("pipeline metrics are not finite")
    for name in PIPELINE_PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the {tag} run")
    if kernel_ms_out is not None:
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            cond2 = mirror_and_concat(raw, 3072)
            gen.manual_seed(4)
            refine(sampler(cond2, label, generator=gen), cond2, label, osf)
            torch.cuda.synchronize()
        sums = kernel_sums(prof.key_averages())
        print(f"kernel device ms a pipeline (B={B}: mirror, FastDPM-{FAST_STEPS}, refine x8; "
              f"profiled again): {format_sums(sums)}", flush=True)
        kernel_ms_out.update({name: ms for name, (ms, _) in sums.items()})
    if routes:
        # encode_condition takes none of these routes, so the sampler's
        # launches are those of its FAST_STEPS denoise steps
        per_step = {n: sampler_counts[n] / FAST_STEPS for n in VARIANT_PATH_KERNELS}
        in_refine = {n: counts[n] - sampler_counts[n] for n in VARIANT_PATH_KERNELS}
        print(f"{tag} launches of the routes: per_denoise_step={per_step} "
              f"refine_forward={in_refine}", flush=True)
        for name in VARIANT_PATH_KERNELS:
            if per_step[name] < 1 or per_step[name] != int(per_step[name]):
                raise AssertionError(f"kernel {name} was not launched on every denoise step")
            if in_refine[name] < 1:
                raise AssertionError(f"kernel {name} was not launched in the refine forward")
    del refiner_model
    return counts


def refine_at_batch(rng, dev) -> None:
    """Phase 8: the x8 refine forward at B=32: time, kernels vs plain, and a
    profile of one forward."""
    from point_diffusion_refinement_tpu_torch.ops import kernels

    B = 32
    model, refine, osf = upsample_refiner(seed=2)
    coarse = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 2048, 3)).astype(np.float32)).to(dev)
    cond = conditions(rng, B, dev)
    label = torch.from_numpy(rng.integers(0, 16, (B,))).to(dev)
    refine(coarse, cond, label, osf)  # warm-up
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = refine(coarse, cond, label, osf)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"refine x8: B={B} ms_per_batch={ms:.2f} completions_per_s={B / ms * 1e3:.1f} "
          f"out={tuple(out.shape)} finite={bool(torch.isfinite(out).all())}", flush=True)
    with torch.no_grad():
        y_k = model(coarse, cond, None, label).float()
        with kernels.plain_ops():
            y_p = model(coarse, cond, None, label).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    print(f"refine kernels vs plain: rel_err={rel:.3g} (tol {REFINE_REL_TOL})", flush=True)
    if not rel <= REFINE_REL_TOL:
        raise AssertionError("refine forward through the kernels disagrees with the plain path")
    profile_window("refine forwards at B=32", lambda: model(coarse, cond, None, label), 1,
                   kernels="a refine forward at B=32")


def evaluation_cost(rng, dev) -> None:
    """Phase 9: chamfer at the x8 output size and EMD at 2048 points."""
    from point_diffusion_refinement_tpu_torch.ops.chamfer import calc_cd
    from point_diffusion_refinement_tpu_torch.ops.emd import earth_mover_distance

    a, b = (torch.from_numpy(rng.uniform(-0.5, 0.5, (32, 16384, 3)).astype(np.float32)).to(dev)
            for _ in range(2))
    cd = calc_cd(a, b, True)
    cd_ms = time_ms(lambda: calc_cd(a, b, True), 2, 1)
    x, y = a[:, :2048].contiguous(), b[:, :2048].contiguous()
    e = earth_mover_distance(x, y)
    emd_ms = time_ms(lambda: earth_mover_distance(x, y), 2, 1)
    finite = all(bool(torch.isfinite(t).all()) for t in (*cd, e))
    print(f"eval cost: calc_cd (32,16384)x(32,16384) ms={cd_ms:.1f}; "
          f"emd (32,2048)x(32,2048) ms={emd_ms:.1f}; finite={finite} "
          f"cd_t_mean={float(cd[1].mean()):.6g} emd_mean={float(e.mean()):.6g}", flush=True)
    if not finite:
        raise AssertionError("evaluation metrics are not finite")


def capture_calls(model, kinds, call):
    """(name, module, args, kwargs) of every forward of ``model``'s submodules
    of the classes ``kinds`` during ``call()``, in call order."""
    seen, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, kinds):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, kwargs, name=name: seen.append((name, m, args, kwargs)),
                with_kwargs=True))
    try:
        with torch.no_grad():
            call()
    finally:
        for h in hooks:
            h.remove()
    return seen


def rel_to_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


# the profiler's names of the three sweeps' kernels and of the finishing
# launch (the query-row pass), for the per-site table of phase 13
# (attention_kernel<MODE> is the single
# templated kernel of the earlier three-sweep design, so the table can be
# taken on such a tree too)
SWEEP_KERNELS = {
    "attention_stats": ("attention_kernel<1>", "attn_stats"),
    "attention_hstats": ("attention_kernel<2>", "attn_hstats"),
    "attention_out": ("attention_kernel<3>", "attn_out"),
    "attention_finish": ("attn_qn",),
}
# ... the part of them that the finishing work touched: what the two
# designs compare on
STATS_AND_FINISH = ("attention_stats", "attention_hstats", "attention_finish")
# a fused pool call: the three sweeps, the query-row pass, the q path's two
# products and the casts of its inputs
POOL_MAX_LAUNCHES = 9
# the finishing work against its plain versions: float32 vectors as the
# statistics; bf16 outputs (qn, the GroupNorm vectors) may flip one
# rounding, 2^-8 of a value, relative to the largest
ATTENTION_FINISH_BF16_TOL = 2.0 ** -7


def trace_device_events(fn, calls: int):
    """Device activities (kernels, memsets, memcpys) of ``calls`` calls of
    ``fn`` from a profiler trace, as {name: (launches seen, mean
    microseconds, blocks of its grid)}, and the launches a call: each
    name's records a call, rounded up (the trace on the card can miss a few
    records; the host-side runtime trace does not see launches from the
    kernels' own statically linked CUDA runtime)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as fh:
            trace = json.load(fh)
    seen = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            n, us, _ = seen.get(e["name"], (0, 0.0, 0))
            grid = int(np.prod(e.get("args", {}).get("grid", [0])))
            seen[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)), grid)
    launches = sum(-(-n // calls) for n, _, _ in seen.values())
    return {k: (n, us / n, grid) for k, (n, us, grid) in seen.items()}, launches


def sweep_split(events, calls: int) -> dict:
    """{sweep: (device ms a call, launches a call)} of SWEEP_KERNELS in
    ``events``: each kernel's mean time over the launches seen, times its
    launches a call (rounded up: a missed record loses less than a call)."""
    split = {}
    for sweep, keys in SWEEP_KERNELS.items():
        ms = n_call = 0.0
        for name, (n, us, _) in events.items():
            if any(k in name for k in keys):
                per_call = -(-n // calls)
                ms += us / 1e3 * per_call
                n_call += per_call
        split[sweep] = (ms, n_call)
    return split


def finishing_bytes(B: int, M: int, c1: int, c2: int, I: int, Co: int):
    """The bytes the finishing work between the sweeps must move, whatever
    implements it (the yardstick of both designs): after sweep 1 (F0 of the
    first design) mm read and qn written in bf16, a row of k's and v's
    column sums read a batch row, mul_k / add_k written in float32 and the
    values' (mu, s, b) in bf16; after sweep 2 (F1) a row of h's column sums
    read and h's (mu, s, b) written."""
    f0 = B * M * c1 * 2 * 2 + B * 2 * (c2 + Co) * 4 + B * (c2 * 8 + Co * 6)
    f1 = B * 2 * I * 4 + B * I * 6
    return f0, f1


def check_attention(sites, dev):
    """Phase 13, kernel #7: the fused attention pool at every attention site
    of one denoise step, on the tensors the step gives it."""
    from point_diffusion_refinement_tpu_torch.ops import attention_pool as ap
    from point_diffusion_refinement_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    pool_rows = {}
    sweep_totals = {sweep: [0.0, 0.0, 0.0] for sweep in SWEEP_KERNELS}
    launch_worst = 0.0
    print("attention sites of one denoise step: name (M, K, Cq, Ck, Cv, c_out) counts",
          flush=True)
    for name, pool, (feat, grouped, gfo, counts), kw in sites:
        B, M, K, Ck = grouped.shape
        Cq, Cv, w = feat.shape[-1], gfo.shape[-1], pool.widths
        given = "all" if isinstance(counts, str) else "ball counts"
        if not (kw.get("fused") and pool.fused_eligible(True, kw.get("key_pre"))):
            raise AssertionError(f"attention site {name} did not take the fused pool")
        synthetic = torch.randint(0, K + 1, (B, M), generator=gen, device=dev, dtype=torch.int32)
        synthetic[:, 0], synthetic[:, 1] = 0, K
        other = synthetic if isinstance(counts, str) else "all"
        worst = worst_unfused = 0.0
        with torch.no_grad():
            for cnt in (counts, other):
                out = pool(feat, grouped, gfo, cnt, fused=True)
                with kernels.plain_ops():
                    ref = pool(feat, grouped, gfo, cnt, fused=True)
                unfused = pool(feat, grouped, gfo, cnt)
                torch.cuda.synchronize()
                if tuple(out.shape) != (B, M, w["c_out"]) or not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"attention {name}: output is not finite (B, M, c_out)")
                worst = max(worst, rel_to_max(out, ref))
                worst_unfused = max(worst_unfused, rel_to_max(out, unfused))
            if not worst <= ATTENTION_OUT_REL_TOL:
                raise AssertionError(f"attention {name}: kernels differ from plain by {worst}")
            if not worst_unfused <= ATTENTION_UNFUSED_REL_TOL:
                raise AssertionError(
                    f"attention {name}: fused differs from unfused by {worst_unfused}")
            fused_ms = time_ms(lambda: pool(feat, grouped, gfo, counts, fused=True), 10)
            unfused_ms = time_ms(lambda: pool(feat, grouped, gfo, counts), 10)
            with kernels.plain_ops():
                plain_ms = time_ms(lambda: pool(feat, grouped, gfo, counts, fused=True), 3, 1)
        rows_total = float(B * M * K)
        ops_once = 2.0 * rows_total * (Ck * w["c2"] + w["c2"] * w["inter_c"]
                                       + w["inter_c"] * w["c_out"] + Cv * w["c_out"])
        b_ms, b_by = bound(nbytes(feat, grouped, gfo) + B * M * w["c_out"] * 4, ops_once,
                           BF16_OPS_PER_S)
        pool_rows[name] = dict(pool_ms=fused_ms, pool_unfused_ms=unfused_ms,
                               pool_plain_ms=plain_ms, pool_bound_ms=b_ms, pool_bound_by=b_by)
        print(f"attention site {name:<10} ({M}, {K}, {Cq}, {Ck}, {Cv}, {w['c_out']}) {given:<11} "
              f"vs_plain={worst:.3g} (tol {ATTENTION_OUT_REL_TOL} of max) "
              f"vs_unfused={worst_unfused:.3g} (tol {ATTENTION_UNFUSED_REL_TOL}) "
              f"fused_ms={fused_ms:.4f} unfused_ms={unfused_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        # where the sweeps' device time goes at this site, and what one fused
        # pool call launches on the card: the profiler's records, and the
        # nodes of a CUDA graph of one call with the wrappers' launches in it
        calls = 5
        graph_wrappers = {}
        with torch.no_grad():
            events, launches = trace_device_events(
                lambda: pool(feat, grouped, gfo, counts, fused=True), calls)
            nodes = graph_launches(lambda: pool(feat, grouped, gfo, counts, fused=True),
                                   graph_wrappers)
        split = sweep_split(events, calls)
        c1, c2, I, Co = w["c1"], w["c2"], w["inter_c"], w["c_out"]
        rows_bf16 = B * M * K * 2
        row_tiles = ap.sweep_row_blocks(B, M, K, Ck, Cv, c2, I, Co)
        part_rows = ap.sweep_partial_rows(B, M, K, Ck, Cv, c2, I, Co)
        sweep_bounds = {
            "attention_stats": bound(rows_bf16 * (Ck + Cv) + B * 2 * (c2 + Co) * 4,
                                     rows_total * 2.0 * (Ck * c2 + Cv * Co), BF16_OPS_PER_S),
            "attention_hstats": bound(rows_bf16 * Ck + B * M * I * 2 + B * 2 * I * 4,
                                      rows_total * 2.0 * (Ck * c2 + c2 * I), BF16_OPS_PER_S),
            "attention_out": bound(rows_bf16 * (Ck + Cv) + B * M * (I * 2 + Co * 4),
                                   ops_once, BF16_OPS_PER_S),
            "attention_finish": bound(sum(finishing_bytes(B, M, c1, c2, I, Co)), 0.0),
        }
        blocks = {sw: max((g for nm, (_, _, g) in events.items()
                           if any(k in nm for k in keys)), default=0)
                  for sw, keys in SWEEP_KERNELS.items()}
        for sweep, (ms, n) in split.items():
            sweep_totals[sweep][0] += ms
            sweep_totals[sweep][1] += n
            sweep_totals[sweep][2] += sweep_bounds[sweep][0]
        n_nodes = sum(nodes.values())
        launch_worst = max(launch_worst, launches, n_nodes)
        print(f"attention sweeps {name:<10} "
              + " ".join(f"{sw.split('_', 1)[1]}: ms={ms:.4f} launches={n:g} "
                         f"blocks={blocks.get(sw, '-')} "
                         f"bound_ms={sweep_bounds[sw][0]:.5f} ({sweep_bounds[sw][1]});"
                         for sw, (ms, n) in split.items())
              + f" stats+hstats+finish ms={sum(split[sw][0] for sw in STATS_AND_FINISH):.4f}"
              f" row tiles a batch row={row_tiles['attention_stats']}/"
              f"{row_tiles['attention_hstats']} partial rows (one a cluster)="
              f"{part_rows['attention_stats']}/{part_rows['attention_hstats']}"
              f" launches a pool call={launches:g}"
              f" ({len(events)} kernel names); a graph of one call: {nodes}, wrappers "
              f"{graph_wrappers}", flush=True)
        if n_nodes > POOL_MAX_LAUNCHES or graph_wrappers != {n: 1 for n in ATTENTION_KERNELS}:
            raise AssertionError(f"attention {name}: a graph of one pool call holds {nodes}, "
                                 f"its wrappers launched {graph_wrappers}")

    print("attention sweeps of one denoise step (sum over its sites): "
          + " ".join(f"{sw.split('_', 1)[1]}: ms={v[0]:.4f} launches={v[1]:g} "
                     f"bound_ms={v[2]:.5f};" for sw, v in sweep_totals.items())
          + f" total_ms={sum(v[0] for v in sweep_totals.values()):.4f}"
          f" stats+hstats+finish ms={sum(sweep_totals[sw][0] for sw in STATS_AND_FINISH):.4f}"
          f" most launches of one pool call={launch_worst:g} (at most {POOL_MAX_LAUNCHES})",
          flush=True)
    if launch_worst > POOL_MAX_LAUNCHES:
        raise AssertionError(f"a fused pool call launched {launch_worst} times")

    # -- the sweeps one by one, at four sites; rows at the level-0 decoder
    #    feature transfer (the most rows, 2048 x 32 a cloud)
    by_name = {name: (pool, args) for name, pool, args, _ in sites}
    rows = []
    deepest = max(by_name, key=lambda n: by_name[n][1][1].shape[-1])  # the widest key
    for tag, name in (("FT0", "dec_map_0"), ("SA0", "sa_0"), ("FP0", "fp_0"), ("deepest", deepest)):
        pool, (feat, grouped, gfo, counts) = by_name[name]
        B, M, K, Ck = grouped.shape
        Cv, w = gfo.shape[-1], pool.widths
        c2, I, Co = w["c2"], w["inter_c"], w["c_out"]
        p = pool._fused_weights()
        g2 = grouped.reshape(B, M * K, Ck).contiguous()
        gfo2 = gfo.reshape(B, M * K, Cv).contiguous()
        cnt = None if isinstance(counts, str) else counts.to(torch.int32).contiguous()

        def vec(c, centre, spread, dtype=torch.float32):
            return (centre + spread * torch.randn(B, c, generator=gen, device=dev)).to(dtype)

        mul_k, add_k = vec(c2, 1.0, 0.2), vec(c2, 0.0, 0.1)
        qp = torch.randn(B, M, I, generator=gen, device=dev).to(torch.bfloat16)
        gn1 = (vec(I, 0.1, 0.1), vec(I, 1.0, 0.2), vec(I, 0.0, 0.1))
        gn2 = (vec(Co, 0.1, 0.1), vec(Co, 1.0, 0.2), vec(Co, 0.0, 0.1))
        c1 = w["c1"]
        mm = torch.matmul(feat.to(torch.bfloat16), p.w0)
        mul_q, add_q = vec(c1, 1.0, 0.2), vec(c1, 0.0, 0.1)
        kst, vst = ap.attention_stats_plain(g2, gfo2, p.key, p.value)
        hst = ap.attention_hstats_plain(g2, qp, p.key, p.hidden, mul_k, add_k, K)

        def flat(parts):
            out = []
            for t in parts:
                out += flat(t) if isinstance(t, tuple) else [t]
            return out

        def stats_run():  # the vectors, then the column totals of k, v and q
            *vectors, part = ap._stats_launch(mm, g2, gfo2, p, c1, K)
            return flat(tuple(vectors)) + [part[:, -1]]

        def hstats_run():  # h's vectors, then its column totals
            gn1_, part = ap._hstats_launch(g2, qp, p, mul_k, add_k, K)
            return [*gn1_, part[:, -1]]

        def finish_stats_run():  # F0's outputs from their new places
            mq, aq, mk, ak, gn2_ = ap.attention_stats(mm, g2, gfo2, p, c1, K)
            return [ap.attention_qn(mm, p.b0, mq, aq), mk, ak, *gn2_]

        f0_bytes, f1_bytes = finishing_bytes(B, M, c1, c2, I, Co)
        rows1 = ap.sweep_row_blocks(B, M, K, Ck, Cv, c2, I, Co)
        rows1.update({f"{k} partial rows": v
                      for k, v in ap.sweep_partial_rows(B, M, K, Ck, Cv, c2, I, Co).items()})
        # name: (run, plain version, bytes, multiply-adds a row, tolerance (None:
        # each output by its type; 0: bit-equal), SWEEP_KERNELS entry of its ms)
        sweeps = {
            "attention_stats": (
                stats_run,
                lambda: flat(ap.attention_stats_vectors_plain(mm, g2, gfo2, p, c1, K))
                + [torch.cat([kst, vst, ap.attention_qsums_plain(mm, p.b0)], -1)],
                nbytes(g2, gfo2, mm) + B * (c1 * 8 + c2 * 8 + Co * 6), Ck * c2 + Cv * Co, None,
                "attention_stats"),
            "attention_qn": (
                lambda: [ap.attention_qn(mm, p.b0, mul_q, add_q)],
                lambda: [ap.attention_qn_plain(mm, p.b0, mul_q, add_q)],
                nbytes(mm) * 2 + B * c1 * 8, 0, 0.0, "attention_finish"),
            "attention_hstats": (
                hstats_run,
                lambda: [*ap.attention_hstats_vectors_plain(g2, qp, p, mul_k, add_k, K), hst],
                nbytes(g2, qp) + B * c2 * 8 + B * I * 6, Ck * c2 + c2 * I, None,
                "attention_hstats"),
            "attention_out": (
                lambda: [ap.attention_out(g2, gfo2, qp, cnt, p.key, p.hidden, p.score, p.value,
                                          mul_k, add_k, gn1, gn2, K)],
                lambda: [ap.attention_out_plain(g2, gfo2, qp, cnt, p.key, p.hidden, p.score,
                                                p.value, mul_k, add_k, gn1, gn2, K)],
                nbytes(g2, gfo2, qp) + B * M * (Co + 1) * 4,
                Ck * c2 + c2 * I + I * Co + Cv * Co, ATTENTION_OUT_REL_TOL, "attention_out"),
            # the first design's finishing kernels as functions: F0 (sweep 1's
            # finish + the query rows), F1 (folded into sweep 2); bound on what
            # the function moves
            "attention_finish_stats": (
                finish_stats_run,
                lambda: flat(ap.attention_finish_stats_plain(
                    mm, torch.cat([kst, vst], -1)[:, None], p, c1, c2, Co, K)),
                f0_bytes, 0, None, "attention_finish"),
            "attention_finish_h": (
                lambda: list(ap.attention_hstats(g2, qp, p, mul_k, add_k, K)),
                lambda: list(ap.attention_finish_h_plain(hst[:, None], p, I, M, K)),
                f1_bytes, 0, None, "attention_hstats"),
        }
        for sweep, (run, run_plain, moved, macs, tol, ms_key) in sweeps.items():
            got, again, ref = run(), run(), run_plain()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{sweep} at {tag}: two calls differ")
            if tol is None:  # each output on its own, by its type
                rels = [rel_to_max(a, b) for a, b in zip(got, ref)]
                ok = all(r <= (ATTENTION_FINISH_BF16_TOL if b.dtype == torch.bfloat16
                               else ATTENTION_STATS_REL_TOL) for r, b in zip(rels, ref))
                rel = max(rels)
                tol = f"{ATTENTION_STATS_REL_TOL} float32, {ATTENTION_FINISH_BF16_TOL} bf16"
            else:
                rel = max(rel_to_max(a, b) for a, b in zip(got, ref))
                ok = rel <= tol if tol else all(torch.equal(a, b) for a, b in zip(got, ref))
            got = torch.cat([t.float().flatten() for t in got])
            ref = torch.cat([t.float().flatten() for t in ref])
            if not ok:
                raise AssertionError(f"{sweep} at {tag}: differs from plain by {rel} of max")
            # the profiler's device time a call; the wrapper's host time beside it
            events, _ = trace_device_events(run, 10)
            ms = sweep_split(events, 10)[ms_key][0]
            wrapper_ms = time_ms(run, 10)
            plain_ms = time_ms(run_plain, 3, 1)
            b_ms, b_by = bound(moved, 2.0 * B * M * K * macs, BF16_OPS_PER_S)
            row = dict(name=sweep,
                       shape=f"{tag} {name} ({B},{M},{K}) Ck={Ck} Cv={Cv} c_out={Co}",
                       max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None, wrapper_ms=wrapper_ms)
            if sweep == "attention_finish_h":  # no launch, time or bound of its own
                row.update(folded_into="attention_hstats (its launches and ms)", ms=None,
                           bound_ms=None, bound_by=None)
            if sweep == "attention_qn":
                row["folds"] = ("the statistics and vectors of the first design's "
                                "attention_finish_stats run in attention_stats's last cluster")
            print_row(row)
            print(f"       {sweep} at {tag}: rel_to_max={rel:.3g} (tol {tol}), two calls "
                  f"bit-equal; row blocks a batch row {rows1}", flush=True)
            if tag == "FT0" and sweep in LAUNCH_NAMES:
                if sweep == "attention_out":
                    row.update(pool_rows[name])
                rows.append(row)

    # -- fault shape: more slots than a 64-row tile (K = 96), with counts that
    #    include 0 and K and with "all", at the level-0 decoder widths
    pool, (feat, grouped, _, _) = by_name["dec_map_0"]
    B, Mk, Kk = 4, 256, 96
    Cv = by_name["dec_map_0"][1][2].shape[-1]
    feat96 = torch.randn(B, Mk, feat.shape[-1], generator=gen, device=dev)
    g96 = torch.randn(B, Mk, Kk, grouped.shape[-1], generator=gen, device=dev).to(torch.bfloat16)
    v96 = torch.randn(B, Mk, Kk, Cv, generator=gen, device=dev).to(torch.bfloat16)
    c96 = torch.randint(0, Kk + 1, (B, Mk), generator=gen, device=dev, dtype=torch.int32)
    c96[:, 0], c96[:, 1] = 0, Kk
    with torch.no_grad():
        for cnt in (c96, "all"):
            kernels.reset_launch_counts()
            out = pool(feat96, g96, v96, cnt, fused=True)
            launched = {n: kernels.launch_counts()[n] for n in ATTENTION_KERNELS}
            with kernels.plain_ops():
                ref = pool(feat96, g96, v96, cnt, fused=True)
            torch.cuda.synchronize()
            rel = rel_to_max(out, ref)
            print(f"attention pool at K={Kk} (B={B}, M={Mk}, Ck={g96.shape[-1]}, Cv={Cv}) "
                  f"counts={'all' if isinstance(cnt, str) else 'with 0 and K'}: launches="
                  f"{launched} vs_plain={rel:.3g} (tol {ATTENTION_OUT_REL_TOL} of max)",
                  flush=True)
            if any(v != 1 for v in launched.values()) or not rel <= ATTENTION_OUT_REL_TOL:
                raise AssertionError(f"attention pool at K={Kk}: not launched or differs")
    return rows


def check_knn_group(fp_call, dev, rng):
    """Phase 13, kernels #9/#10: ``knn_group`` at the level-0 feature
    propagation of one denoise step and at a small support with duplicates
    and k = N."""
    from point_diffusion_refinement_tpu_torch import ops

    _, fp, (unknown, known, _, known_feats), _ = fp_call
    small_pts = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 3)).astype(np.float32)).to(dev)
    small_pts[:, 4:6] = small_pts[:, :2]  # duplicate points: ties
    small_q = torch.from_numpy(rng.uniform(-1, 1, (2, 130, 3)).astype(np.float32)).to(dev)
    small_tab = torch.randn(2, 8, 5, device=dev)
    cases = [("FP0", unknown.float().contiguous(), known.float().contiguous(), known_feats, fp.k),
             ("small", small_q, small_pts, small_tab, 8),
             # fault shape: more neighbours than one thread's list held
             ("FP0 k=32", unknown.float().contiguous(), known.float().contiguous(),
              known_feats, 32)]
    for tag, q, pts, table, k in cases:
        C = table.shape[-1]
        before = ops.launch_counts()["knn_group"]
        out = ops.knn_group(q, pts, table, k)
        if ops.launch_counts()["knn_group"] != before + 1:
            raise AssertionError(f"knn_group {tag}: the kernel was not launched")
        ref = ops.knn_group_plain(q, pts, table, k)
        d, i = ops.knn(q, pts, k)
        torch.cuda.synchronize()
        if tuple(out.shape) != (*q.shape[:2], k, C + 11) or out.dtype != torch.bfloat16:
            raise AssertionError(f"knn_group {tag}: wrong shape or type")
        if not torch.equal(out[..., :C], ops.group_points(table.to(torch.bfloat16), i)):
            raise AssertionError(f"knn_group {tag}: rows are not those of knn's indices")
        if not torch.equal(out[..., C], d.to(torch.bfloat16)):
            raise AssertionError(f"knn_group {tag}: distances differ from knn's")
        if not torch.equal(out, ref):
            err = float((out.float() - ref.float()).abs().max())
            raise AssertionError(f"knn_group {tag}: differs from plain by {err}")
        print(f"knn_group {tag} q {tuple(q.shape[:2])} pts {tuple(pts.shape[:2])} k={k} C={C}: "
              f"launched, equal to plain", flush=True)
    tag, q, pts, table, k = cases[0]
    B, M, N, C = *q.shape[:2], pts.shape[1], table.shape[-1]

    def library():
        _, i = torch.topk(torch.cdist(q, pts), k, dim=-1, largest=False)
        return torch.gather(table[:, None].expand(B, M, N, C), 2,
                            i[..., None].expand(B, M, k, C))

    run = lambda: ops.knn_group(q, pts, table, k)
    ms = device_ms(run, "knn_group")
    wrapper_ms = time_ms(run, 20)
    plain_ms = time_ms(lambda: ops.knn_group_plain(q, pts, table, k), 5)
    lib_ms = time_ms(library, 20)
    b_ms, b_by = bound(nbytes(q, pts, table) + B * M * k * (C + 11) * 2, 10.0 * B * M * N)
    row = dict(name="knn_group", shape=f"FP0 q ({B},{M}) pts ({B},{N}) k={k} C={C}",
               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, wrapper_ms=wrapper_ms)
    print_row(row)
    # the same shapes at B=32, the refine forward's batch, on seeded data
    B32 = 32
    q32 = torch.from_numpy(rng.uniform(-1, 1, (B32, M, 3)).astype(np.float32)).to(dev)
    p32 = torch.from_numpy(rng.uniform(-1, 1, (B32, N, 3)).astype(np.float32)).to(dev)
    t32 = torch.randn(B32, N, C, device=dev).to(torch.bfloat16)
    run32 = lambda: ops.knn_group(q32, p32, t32, k)
    if not torch.equal(run32(), ops.knn_group_plain(q32, p32, t32, k)):
        raise AssertionError("knn_group at B=32: differs from plain")
    b32_ms, b32_by = bound(nbytes(q32, p32, t32) + B32 * M * k * (C + 11) * 2,
                           10.0 * B32 * M * N)
    print(f"knn_group FP0 at B=32 q ({B32},{M}) pts ({B32},{N}) k={k} C={C}, equal to plain: "
          f"ms={device_ms(run32, 'knn_group', 10):.4f} (device) "
          f"wrapper_ms={time_ms(run32, 10):.4f} bound_ms={b32_ms:.5f} ({b32_by})", flush=True)
    del q32, p32, t32
    return row


def compare_variants(what: str, call) -> None:
    """One network evaluation ``call(**routes)`` with the variants on
    against off and against the plain versions, and packed against off."""
    from point_diffusion_refinement_tpu_torch.ops import kernels

    on = dict(fused_attention=True, fused_knn=True)
    with torch.no_grad():
        y_off = call().float()
        y_on = call(**on).float()
        y_packed = call(packed=True).float()
        with kernels.plain_ops():
            y_plain = call(**on).float()
    d_on, d_packed = (y_on - y_off).abs(), (y_packed - y_off).abs()
    rel = float((y_on - y_plain).norm() / y_plain.norm())
    print(f"{what} variants on vs off: max={float(d_on.max()):.3g} (tol {VARIANT_MAX_TOL}) "
          f"mean={float(d_on.mean()):.3g} (tol {VARIANT_MEAN_TOL}) "
          f"output_abs_mean={float(y_off.abs().mean()):.3g}; "
          f"on vs plain rel_err={rel:.3g} (tol {VARIANT_PLAIN_REL_TOL}); "
          f"packed vs off: max={float(d_packed.max()):.3g} mean={float(d_packed.mean()):.3g} "
          f"(same tolerances)", flush=True)
    if not (float(d_on.max()) <= VARIANT_MAX_TOL and float(d_on.mean()) <= VARIANT_MEAN_TOL):
        raise AssertionError(f"{what}: the variants on disagree with the variants off")
    if not rel <= VARIANT_PLAIN_REL_TOL:
        raise AssertionError(f"{what}: the variants' kernels disagree with their plain versions")
    if not (float(d_packed.max()) <= VARIANT_MAX_TOL
            and float(d_packed.mean()) <= VARIANT_MEAN_TOL):
        raise AssertionError(f"{what}: packed disagrees with unpacked")


def variant_costs(what: str, call, reps: int, steps: int) -> None:
    """What each variant of ``call(**routes)`` costs, in turn (off first and
    last, so the spread shows): host-clock ms of ``reps`` calls, each ending
    in a synchronise (mean and least: the host's load moves the mean), then
    device time and device-busy share of a profiled window of ``steps``."""
    for tag, routes in VARIANTS:
        fn = lambda: call(**routes)
        times = []
        with torch.no_grad():
            fn()  # warm-up of this variant's allocations
            torch.cuda.synchronize()
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        print(f"{what} cost: variant={tag:<9} ms_mean={np.mean(times):.2f} "
              f"ms_min={min(times):.2f}", flush=True)
        profile_window(f"{what} ({tag})", fn, steps, table=tag == "attention")


def accelerated_inference(model, cf, x, ts, label, rng, dev):
    """Phase 13: the accelerated inference configuration."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.models.attention import AttentionPool
    from point_diffusion_refinement_tpu_torch.models.modules import KnnFeaturePropagation

    def denoise(**routes):
        return model.denoise(x, ts, label, cf, fused=True, **routes)

    on = dict(fused_attention=True, fused_knn=True)
    ops.reset_launch_counts()
    calls = capture_calls(model, (AttentionPool, KnnFeaturePropagation), lambda: denoise(**on))
    step_counts = {n: ops.launch_counts()[n] for n in VARIANT_PATH_KERNELS}
    # a pool is named by the module that owns it (``fp_0.AttentionPool_0``)
    sites = [(c[0].rsplit(".", 1)[0], *c[1:]) for c in calls if isinstance(c[1], AttentionPool)]
    fps = [c for c in calls if isinstance(c[1], KnnFeaturePropagation)]
    print(f"one denoise step with the variants on: {len(sites)} attention pools, "
          f"launches={step_counts}", flush=True)
    if any(step_counts[n] != len(sites) for n in ATTENTION_KERNELS):
        raise AssertionError("an attention site of the denoise step was not fused")
    eligible = [c[0] for c in fps if c[1].fused_knn_eligible(c[2][0], c[2][1], c[2][3], True)]
    print(f"kNN feature propagations eligible for knn_group: {eligible} of "
          f"{[c[0] for c in fps]}", flush=True)
    if step_counts["knn_group"] != len(eligible) or not eligible:
        raise AssertionError("knn_group launches do not match the eligible sites")
    rows = check_attention(sites, dev)
    rows.append(check_knn_group(next(c for c in fps if c[0] == eligible[0]), dev, rng))
    del calls, sites, fps

    counts = pipeline(model, rng, dev, tag="pipeline with variants", **on)
    compare_variants("denoise step B=4", denoise)
    variant_costs("denoise step B=4", denoise, 5, 3)
    return rows, counts


def refine_variants(rng, dev) -> None:
    """Phase 13 at the refine net: the B=32 x8 forward with the variants on
    against off and against the plain versions, and what each costs."""
    B = 32
    model, _, _ = upsample_refiner(seed=2)
    coarse = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 2048, 3)).astype(np.float32)).to(dev)
    cond = conditions(rng, B, dev)
    label = torch.from_numpy(rng.integers(0, 16, (B,))).to(dev)
    with torch.no_grad():
        cf = model.encode_condition(cond)

    def forward(**routes):
        return model.denoise(coarse, None, label, cf, fused=True, **routes)

    compare_variants("refine forward B=32", forward)

    variant_costs("refine forward B=32", forward, 3, 1)
    with torch.no_grad():
        encode_ms = time_ms(lambda: model.encode_condition(cond), 3, 1)
        shipped_ms = time_ms(lambda: model(coarse, cond, None, label), 3, 1)
    print(f"refine forward B=32 cost: the condition branch, which no variant touches, "
          f"ms={encode_ms:.2f}; forward() whole, the shipped refiner's route, "
          f"ms={shipped_ms:.2f} (CUDA events)", flush=True)


def check_training_kernels(dev, rng):
    """Phase 10: the kernels of the training routes against their plain
    versions, at the shapes of a training step (B = 4)."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.ops import kernels, neighbors, scatter

    B, K = 4, 32
    x_t = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    cond = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 3072, 3)).astype(np.float32)).to(dev)
    rows = []

    # -- #8 at feature-transfer level 0 (support 3072, 2048 centres, table
    #    [xyz, 32 features]) and at a deep level (support 64, 16 centres, a
    #    wide table): idx, counts and gathered rows equal
    deep_sup = cond[:, :64].contiguous() * 2.0
    deep_q = deep_sup[:, :16] + 0.01
    deep_q[:, ::5] += 9.0  # empty balls
    cases = [("ft0", cond, x_t, torch.randn(B, 3072, 35, device=dev), 0.1),
             ("deep", deep_sup, deep_q, torch.randn(B, 64, 3 + 512, device=dev), 1.6)]
    seen_empty = seen_full = False
    for tag, sup, q, table, r in cases:
        g, i, n = ops.ball_query_group(sup, q, table, r, K)
        rg, ri, rn = ops.ball_query_group_plain(sup, q, table, r, K)
        qi, qn = ops.ball_query(sup, q, r, K)
        torch.cuda.synchronize()
        if not (torch.equal(i, ri) and torch.equal(n, rn) and torch.equal(i, qi)
                and torch.equal(n, qn)):
            raise AssertionError(f"ball_query_group {tag}: idx or counts differ")
        err = float((g - rg).abs().max())
        if err != 0.0:
            raise AssertionError(f"ball_query_group {tag}: gathered rows differ by {err}")
        seen_empty |= bool((n == 0).any())
        seen_full |= bool((n == K).any())
    if not (seen_empty and seen_full):
        raise AssertionError("ball_query_group: the cases hold no empty or no overfull ball")
    tag, sup, q, table, r = cases[0]
    # the same level at the training batch, B = 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    sup32 = torch.rand(TRAIN_BATCH, 3072, 3, generator=gen, device=dev) - 0.5
    q32 = torch.randn(TRAIN_BATCH, 2048, 3, generator=gen, device=dev)
    table32 = torch.randn(TRAIN_BATCH, 3072, table.shape[-1], generator=gen, device=dev)
    timed = {}
    for b, (s_, q_, t_) in ((B, (sup, q, table)), (TRAIN_BATCH, (sup32, q32, table32))):
        # every queries-a-warp choice, bit-equal to plain, the wrapper's marked *
        rg, ri, rn = ops.ball_query_group_plain(s_, q_, t_, r, K)
        cells = []
        g = torch.empty(b, q_.shape[1], K, t_.shape[-1], device=dev)
        idx = torch.empty(b, q_.shape[1], K, dtype=torch.int32, device=dev)
        cnt = torch.empty(b, q_.shape[1], dtype=torch.int32, device=dev)
        for qpw in (1, 2, 4, 8):
            run = lambda: neighbors._gather_launch(s_, q_, t_, r, g, idx, cnt, qpw)
            run()
            torch.cuda.synchronize()
            if not (torch.equal(idx, ri) and torch.equal(cnt, rn) and torch.equal(g, rg)):
                raise AssertionError(f"ball_query_group: {qpw} queries a warp differ from plain "
                                     f"at B={b}")
            star = ("*" if qpw == neighbors.gather_queries_per_warp(b, q_.shape[1], s_.shape[1])
                    else "")
            cells.append(f"{qpw}{star} ms={device_ms(run, 'ball_query_group'):.4f}")
        print(f"ball_query_group FT0 B={b} queries a warp, equal to plain: {'; '.join(cells)}",
              flush=True)
        del rg, ri, rn
        run = lambda: ops.ball_query_group(s_, q_, t_, r, K)
        timed[b] = (device_ms(run, "ball_query_group"), time_ms(run, 20),
                 bound(nbytes(s_, q_, t_, g, idx, cnt),
                       9.0 * scanned_pairs(idx, cnt, s_.shape[1])))
        del g
    g, idx, cnt = ops.ball_query_group(sup, q, table, r, K)
    plain_ms = time_ms(lambda: ops.ball_query_group_plain(sup, q, table, r, K), 5)
    (ms, wrapper_ms, (b_ms, b_by)), (ms32, wrapper_ms32, (b_ms32, _)) = (
        timed[B], timed[TRAIN_BATCH])
    rows.append(dict(name="ball_query_group", shape="FT0 sup (4,3072) q (4,2048) K=32 C=3+32",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, wrapper_ms=wrapper_ms, ms_b32=ms32,
                     wrapper_ms_b32=wrapper_ms32, bound_ms_b32=b_ms32))

    # -- the fused group's idx output against the ball-query kernel
    for mode in ("center_zero", "row0"):
        _, n2, i2 = ops.ball_group(sup, [table[..., 3:]], q, r, K, True, mode, return_idx=True)
        if not (torch.equal(i2, idx) and torch.equal(n2, cnt)):
            raise AssertionError(f"ball_group {mode}: idx output differs from ball_query")
    print("kernel ball_group idx output equal to ball_query (both empty modes)", flush=True)

    # -- scatter-add at the cotangent shape of that gather, float32 and
    #    bfloat16, against index_add_
    N, M, C = sup.shape[1], q.shape[1], table.shape[-1]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dg = torch.randn(B, M, K, C, device=dev).to(dtype)
        for counts in (None, cnt):
            out = ops.group_scatter_add(dg, idx, N, counts, deterministic=False)
            ref = ops.group_scatter_add_plain(dg, idx, N, counts)
            scale = ops.group_scatter_add_plain(dg.abs(), idx, N, counts)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            excess = (out - ref).abs() - (SCATTER_ABS_REL_TOL * scale + SCATTER_ABS_FLOOR)
            if not float(excess.max()) <= 0.0:
                at = tuple(int(v) for v in torch.nonzero(excess == excess.max())[0])
                raise AssertionError(
                    f"group_scatter_add {dtype}: differs by {float((out - ref)[at])} at {at}, "
                    f"its sum of magnitudes {float(scale[at])}")
            worst = max(worst, err)
            del scale, excess
    # times: float32 cotangents of the gather, and a bf16 channel slice of a
    # wider grouped row (ld = C + 9, as ball_group_train's backward passes
    # it), at B = 4 and at the training batch; the cast is not timed
    _, idx32, _ = ops.ball_query_group(sup32, q32, table32, r, K)
    timed = {}
    for b, ix in ((B, idx), (TRAIN_BATCH, idx32)):
        dg = torch.randn(b, M, K, C, generator=gen, device=dev)
        wide = torch.randn(b, M, K, C + 9, generator=gen, device=dev).to(torch.bfloat16)
        sl = wide[..., :C]
        for d in (dg, sl):
            out = ops.group_scatter_add(d, ix, N, deterministic=False)
            ref = ops.group_scatter_add_plain(d, ix, N)
            scale = ops.group_scatter_add_plain(d.abs(), ix, N)
            torch.cuda.synchronize()
            excess = (out - ref).abs() - (SCATTER_ABS_REL_TOL * scale + SCATTER_ABS_FLOOR)
            if not float(excess.max()) <= 0.0:
                at = tuple(int(v) for v in torch.nonzero(excess == excess.max())[0])
                raise AssertionError(
                    f"group_scatter_add B={b} {d.dtype}: differs by {float((out - ref)[at])} "
                    f"at {at}, its sum of magnitudes {float(scale[at])}")
            del out, ref, scale, excess
        # every balls-a-thread choice, the wrapper's marked *
        for d in (dg, sl):
            bpt = scatter.scatter_balls_per_thread(b * M, C, N)
            cells = []
            for n_b in (1, 2, 4, 8):
                ms_c = device_ms(lambda: scatter._scatter_launch(d, d.stride(2), ix, N, None, n_b),
                                 "group_scatter_add")
                cells.append(f"{n_b}{'*' if n_b == bpt else ''} ms={ms_c:.4f}")
            print(f"group_scatter_add FT0 B={b} {str(d.dtype).split('.')[-1]} ld={d.stride(2)} "
                  f"balls a thread: {'; '.join(cells)}", flush=True)
        run = lambda: ops.group_scatter_add(dg, ix, N, deterministic=False)
        timed[b] = (device_ms(run, "group_scatter_add"), time_ms(run, 20),
                 device_ms(lambda: ops.group_scatter_add(sl, ix, N, deterministic=False),
                           "group_scatter_add"),
                 bound(nbytes(dg, ix) + b * N * C * 4, float(dg.numel())),
                 bound(nbytes(dg, ix) // 2 + b * N * C * 4 + ix.numel() * 2,
                       float(dg.numel()))[0])
        if b == B:
            plain_ms = time_ms(lambda: ops.group_scatter_add_plain(dg, ix, N), 5)
            flat = (ix.long() + torch.arange(B, device=dev)[:, None, None] * N).reshape(-1)
            vals = dg.reshape(-1, C)
            acc = torch.zeros(B * N, C, device=dev)
            lib_ms = time_ms(lambda: acc.zero_().index_add_(0, flat, vals), 20)
        del dg, wide, sl
    (ms, wrapper_ms, ms_sl, (b_ms, b_by), b_sl), (ms32, wrapper_ms32, ms_sl32, (b_ms32, _),
                                                  _) = timed[B], timed[TRAIN_BATCH]
    rows.append(dict(name="group_scatter_add", shape="dg (4,2048,32,35) f32 -> (4,3072,35)",
                     max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms, wrapper_ms=wrapper_ms,
                     ms_bf16_slice=ms_sl, bound_ms_bf16_slice=b_sl, ms_b32=ms32,
                     wrapper_ms_b32=wrapper_ms32,
                     bound_ms_b32=b_ms32, ms_bf16_slice_b32=ms_sl32))
    rows.append(ordered_scatter_row(dev, gen, idx, cnt, idx32, N, M, K, C))
    del sup32, q32, table32, idx32

    # -- ball_group_train: gradients to features, support and queries against
    #    autograd through the plain version (x_t SA level 0: 1024 centres)
    _, centres = ops.furthest_point_sample_and_gather(x_t, 1024)
    centres = centres.clone()
    centres[:, ::7] += 9.0  # empty balls
    feats = torch.randn(B, 2048, 35, device=dev)
    for mode in ("row0", "center_zero"):
        leaves = [t.clone().requires_grad_() for t in (x_t, feats, centres)]
        g, _, _ = ops.ball_group_train(*leaves, 0.1, K, True, mode)
        w = torch.randn(g.shape, device=dev)
        grads = torch.autograd.grad((g.float() * w).sum(), leaves)
        with kernels.plain_ops():
            (rg,), _ = ops.ball_group_plain(leaves[0], [leaves[1]], leaves[2], 0.1, K, True, mode)
            refs = torch.autograd.grad((rg.float() * w).sum(), leaves)
        torch.cuda.synchronize()
        if not torch.equal(g, rg):
            raise AssertionError(f"ball_group_train {mode}: forward differs")
        errs = []
        for a, b, what in zip(grads, refs, ("support", "features", "queries")):
            err = float((a - b).abs().max())
            errs.append(err)
            if not err <= SCATTER_REL_TOL * float(b.abs().max()):
                raise AssertionError(f"ball_group_train {mode}: d_{what} differs by {err}")
        print(f"kernel ball_group_train {mode}: max_abs_err support/features/queries="
              f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol {SCATTER_REL_TOL} of max)",
              flush=True)
    for row in rows:
        print_row(row)
    return rows


def ordered_scatter_row(dev, gen, idx4, cnt4, idx32, N: int, M: int, K: int, C: int) -> dict:
    """Phase 10: the ordered scatter-add (``group_scatter_add``'s default,
    ``csrc/group_scatter_ordered.cu``) at the level-0 feature transfer's
    cotangent (``idx4`` / ``cnt4`` of B=4, ``idx32`` of B=32: N rows, M
    balls of K slots, C channels; float32, a bf16 slice of a wider row,
    with and without ``counts``) and at chamfer's re-gather in the x8
    refine step (B=32, the nearest of 16384 points among 16384 that are
    eight jittered copies of a 2048-point cloud, K=1, C=3).  Each: two
    launches bit-equal and equal to the plain version run on CPU copies,
    bit for bit; at B=4 also the two-table form (the bf16 slice and float32
    positions, as ``ball_group_train``'s backward passes them: one launch,
    each result equal to its single call and to the plain version) and a
    captured graph of it replayed on new cotangents.  Launches a call: the
    kernel and memset nodes of a CUDA graph of one call (graph_launches),
    ORDERED_LAUNCHES at each of the four shapes.  Times: the profiler's
    device ms of a call (every launch of it), by kernel at FT0 B=32 and
    chamfer's shape, beside the atomic kernel B,
    the plain version on the card, and ``index_put_(accumulate=True)``
    under ``use_deterministic_algorithms`` (library_ms, the one PyTorch call
    that sums the same deterministically); bound_ms: the bytes of dg, idx
    and the result at 3.35 TB/s (what the function moves; the kernel's own
    inverse index and partials are not counted)."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.ops.chamfer import nn_sqdist
    from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction

    def agree(what, dg, ix, n_rows, counts=None):
        out = ops.group_scatter_add(dg, ix, n_rows, counts)
        again = ops.group_scatter_add(dg, ix, n_rows, counts)
        ref = ops.group_scatter_add_plain(dg.cpu(), ix.cpu(), n_rows,
                                          None if counts is None else counts.cpu())
        torch.cuda.synchronize()
        err = float((out.cpu() - ref).abs().max())
        flat = (ix.long() + torch.arange(ix.shape[0], device=dev)[:, None, None]
                * n_rows).reshape(-1)
        lists = torch.bincount(flat, minlength=ix.shape[0] * n_rows)
        starts = torch.ones_like(ix, dtype=torch.bool)
        starts[..., 1:] = ix[..., 1:] != ix[..., :-1]
        runs = torch.bincount(flat[starts.reshape(-1)], minlength=ix.shape[0] * n_rows)
        print(f"group_scatter_ordered {what}: two launches equal={torch.equal(out, again)} "
              f"equal to plain on CPU copies={err == 0.0} max_abs_err={err:.3g} (longest "
              f"list {int(lists.max())} slots in {int(runs.max())} runs; lists over 32 runs: "
              f"{int((runs > 32).sum())}, runs in all {int(runs.sum())} of {ix.numel()} slots)",
              flush=True)
        if not (torch.equal(out, again) and err == 0.0):
            raise AssertionError(f"group_scatter_ordered {what}: not bit-equal")
        return out, err

    def library_ms(dg, ix, n_rows, ordered_out):
        B_ = dg.shape[0]
        flat = (ix.long() + torch.arange(B_, device=dev)[:, None, None] * n_rows).reshape(-1)
        vals = dg.reshape(-1, dg.shape[-1]).to(torch.float32).contiguous()
        acc = torch.zeros(B_ * n_rows, dg.shape[-1], device=dev)
        torch.use_deterministic_algorithms(True)
        try:
            ms = time_ms(lambda: acc.zero_().index_put_((flat,), vals, accumulate=True), 10)
            equal = torch.equal(acc.view_as(ordered_out), ordered_out)
        finally:
            torch.use_deterministic_algorithms(False)
        return ms, equal

    def launches_of(what, fn, breakdown=False):
        nodes = graph_launches(fn)
        n = nodes.get("kernel", 0) + nodes.get("memset", 0)
        text = f"device ms a call by kernel: {launch_breakdown(fn)}; " if breakdown else ""
        print(f"group_scatter_ordered {what}: {text}launches a call: {n} (a graph of one call: "
              f"{nodes})", flush=True)
        if n != ORDERED_LAUNCHES or set(nodes) - {"kernel", "memset"}:
            raise AssertionError(f"group_scatter_ordered {what}: {nodes} in a call, not "
                                 f"{ORDERED_LAUNCHES} kernels and memsets")
        return n

    wide = torch.randn(4, M, K, C + 9, generator=gen, device=dev).to(torch.bfloat16)
    dg = torch.randn(4, M, K, C, generator=gen, device=dev)
    worst = 0.0
    for what, d, counts in (("FT0 B=4 float32", dg, None), ("FT0 B=4 float32 counts", dg, cnt4),
                            ("FT0 B=4 bf16 slice", wide[..., :C], None),
                            ("FT0 B=4 bf16 slice counts", wide[..., 3:3 + C], cnt4)):
        out, err = agree(what, d, idx4, N, counts)
        worst = max(worst, err)
    out4 = ops.group_scatter_add(dg, idx4, N)
    row = dict(name="group_scatter_ordered", shape="dg (4,2048,32,35) f32 -> (4,3072,35)",
               max_abs_err=worst)
    run = lambda: ops.group_scatter_add(dg, idx4, N)  # noqa: E731
    row["ms"], row["wrapper_ms"] = window_device_ms(run), time_ms(run, 20)
    launches_of("FT0 B=4 float32", run)
    run_sl = lambda: ops.group_scatter_add(wide[..., :C], idx4, N)  # noqa: E731
    row["ms_bf16_slice"] = window_device_ms(run_sl)
    launches_of("FT0 B=4 bf16 slice", run_sl)
    row["atomic_ms"] = device_ms(lambda: ops.group_scatter_add(dg, idx4, N, deterministic=False),
                                 "group_scatter_add")
    row["plain_ms"] = time_ms(lambda: ops.group_scatter_add_plain(dg, idx4, N), 5)
    row["library_ms"], lib_equal = library_ms(dg, idx4, N, out4)
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(dg, idx4) + out4.numel() * 4, float(dg.numel()))

    # the two-table form (features and positions of one gather) and its replay
    pos = torch.randn(4, M, K, 3, generator=gen, device=dev)
    for counts in (None, cnt4):
        ops.reset_launch_counts()
        pair = ops.group_scatter_add_pair(wide[..., :C], pos, idx4, N, counts)
        launched = ops.launch_counts()["group_scatter_ordered"]
        singles = [ops.group_scatter_add(d, idx4, N, counts) for d in (wide[..., :C], pos)]
        refs = [ops.group_scatter_add_plain(d.cpu(), idx4.cpu(), N,
                                            None if counts is None else counts.cpu())
                for d in (wide[..., :C], pos)]
        ok = (launched == 1 and all(torch.equal(a, b) for a, b in zip(pair, singles))
              and all(torch.equal(a.cpu(), b) for a, b in zip(pair, refs)))
        print(f"group_scatter_ordered pair FT0 B=4 (bf16 slice of {C}, float32 positions of 3)"
              f"{' counts' if counts is not None else ''}: launches={launched} equal to the "
              f"single calls and to plain on CPU copies={ok}", flush=True)
        if not ok:
            raise AssertionError("group_scatter_ordered pair: not bit-equal or not one launch")
    row["ms_pair"] = window_device_ms(
        lambda: ops.group_scatter_add_pair(wide[..., :C], pos, idx4, N, cnt4))
    row["ms_two_singles"] = window_device_ms(lambda: [
        ops.group_scatter_add(d, idx4, N, cnt4) for d in (wide[..., :C], pos)])
    graphed = CapturedFunction(lambda a, b, i, n: ops.group_scatter_add_pair(a, b, i, N, n))
    replays = []
    for step in range(4):  # the warm-up, the capture, two replays on new cotangents
        a = torch.randn(wide.shape, generator=gen, device=dev).to(torch.bfloat16)[..., :C]
        b = torch.randn(pos.shape, generator=gen, device=dev)
        got = graphed(a, b, idx4, cnt4)
        want = ops.group_scatter_add_pair(a, b, idx4, N, cnt4)
        replays.append(all(torch.equal(x, y) for x, y in zip(got, want)))
    print(f"group_scatter_ordered pair in a captured graph: replays equal to eager={replays} "
          f"graph launches={graphed.stats()[0]['launches']}; pair ms={row['ms_pair']:.4f} "
          f"against two single calls {row['ms_two_singles']:.4f}", flush=True)
    graphed.release()
    if not all(replays):
        raise AssertionError("group_scatter_ordered pair: a replay differs from eager")
    del wide, out4, pos, graphed

    dg = torch.randn(TRAIN_BATCH, M, K, C, generator=gen, device=dev)
    out32, _ = agree("FT0 B=32 float32", dg, idx32, N)
    run = lambda: ops.group_scatter_add(dg, idx32, N)  # noqa: E731
    row["ms_b32"], row["wrapper_ms_b32"] = window_device_ms(run, 10), time_ms(run, 10)
    launches_of("FT0 B=32 float32", run, breakdown=True)
    row["atomic_ms_b32"] = device_ms(
        lambda: ops.group_scatter_add(dg, idx32, N, deterministic=False), "group_scatter_add")
    row["library_ms_b32"], lib32_equal = library_ms(dg, idx32, N, out32)
    row["bound_ms_b32"] = bound(nbytes(dg, idx32) + out32.numel() * 4, float(dg.numel()))[0]
    del dg, out32

    arrays = training_arrays(TRAIN_BATCH, 16384, seed=41)
    gt = torch.from_numpy(arrays["complete"]).to(dev)
    coarse = torch.from_numpy(arrays["generated"]).to(dev)
    refined = coarse.repeat_interleave(8, dim=1)
    refined = refined + 1e-3 * torch.randn(refined.shape, generator=gen, device=dev)
    _, nn_idx = nn_sqdist(gt, refined)
    ix = nn_idx[:, :, None].contiguous()
    n_rows = refined.shape[1]
    dg = torch.randn(TRAIN_BATCH, gt.shape[1], 1, 3, generator=gen, device=dev)
    outc, _ = agree("chamfer (32,16384) into 16384, K=1, C=3", dg, ix, n_rows)
    run = lambda: ops.group_scatter_add(dg, ix, n_rows)  # noqa: E731
    row["ms_chamfer"] = window_device_ms(run, 10)
    row["launches_a_call"] = launches_of("chamfer", run, breakdown=True)
    row["atomic_ms_chamfer"] = device_ms(
        lambda: ops.group_scatter_add(dg, ix, n_rows, deterministic=False), "group_scatter_add")
    row["library_ms_chamfer"], libc_equal = library_ms(dg, ix, n_rows, outc)
    row["bound_ms_chamfer"] = bound(nbytes(dg, ix) + outc.numel() * 4, float(dg.numel()))[0]
    print(f"group_scatter_ordered: the deterministic index_put_ equal to it bit for bit: FT0 B=4 "
          f"{lib_equal}, B=32 {lib32_equal}, chamfer {libc_equal}", flush=True)
    del dg, outc, gt, coarse, refined, nn_idx, ix
    return row


def training_arrays(n: int, complete_points: int, seed: int):
    """``n`` synthetic samples in the MVP training scale: complete clouds
    spanning [-1, 1], mirrored 3072 x 4 conditions (the mirror and its FPS
    run on the card), labels, and a noisy 2048-point subsample of the
    complete cloud as the coarse input of the refine task."""
    from point_diffusion_refinement_tpu_torch.data import (
        generate_mirrored_partials,
        make_synthetic_clouds,
    )

    shapes = -(-n // 26)
    completes, partials, labels = make_synthetic_clouds(shapes, complete_points, 2048, seed=seed)
    complete = np.repeat(completes, 26, axis=0)[:n].astype(np.float32) * 2.0
    cond = generate_mirrored_partials(partials[:n], 3072)
    cond[..., :3] *= 2.0
    rng = np.random.default_rng(seed + 1)
    coarse = complete[:, :2048] + 0.02 * rng.standard_normal((n, 2048, 3)).astype(np.float32)
    return dict(complete=complete, partial=cond, label=labels[:n], generated=coarse)


def grads_at(model, loss_call):
    """(loss, {name: gradient}) of ``loss_call()`` at the model's state."""
    model.zero_grad(set_to_none=True)
    loss = loss_call()
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}


def grad_difference(got, ref):
    """Relative difference of the global gradient norm, and the worst
    tensor's ||a - b|| / ||b|| among the tensors that carry at least 1e-4
    of the global norm."""
    sq = lambda t: float(t.double().pow(2).sum())
    total = sum(sq(v) for v in ref.values()) ** 0.5
    diff = sum(sq(got[k] - ref[k]) for k in ref) ** 0.5
    worst, worst_name = 0.0, ""
    for k, b in ref.items():
        nb = sq(b) ** 0.5
        if nb >= 1e-4 * total:
            rel = sq(got[k] - b) ** 0.5 / nb
            if rel > worst:
                worst, worst_name = rel, k
    return diff / total, worst, worst_name


def fit_batch(what: str, step_at, batch: int):
    """The largest power-of-two batch <= ``batch`` at which ``step_at(B)``
    (one whole training step on a fresh model) fits the card's memory, and
    the peak of that step."""
    import gc

    while True:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            step_at(batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            print(f"{what}: batch {batch} fits, peak_memory_GiB={peak / 2 ** 30:.2f}", flush=True)
            return batch
        except torch.cuda.OutOfMemoryError:
            print(f"{what}: batch {batch} does not fit the card's memory", flush=True)
            if batch == 1:
                raise
            batch //= 2


def check_trained(tag: str, result, fresh_model, counts) -> None:
    """What every training run must show: finite losses, every kernel of the
    training path launched, every parameter with a finite gradient and moved
    away from its seeded start."""
    losses = result["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: losses are not {TRAIN_STEPS} finite values: {losses}")
    for name in TRAIN_PATH_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched by the training run")
    start = dict(fresh_model.named_parameters())
    for name, p in result["model"].named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{tag}: parameter {name} has no finite gradient")
        if torch.equal(p.detach(), start[name].detach()):
            raise AssertionError(f"{tag}: parameter {name} did not move")


def compare_routes(tag: str, model, loss_for, step_for, state, batch_size: int,
                   timings_out=None) -> dict:
    """Step time of both routes (on, off, off, on), the gradients of the
    fused routes against the unfused ones at one state and one draw, one
    step through the kernels against one under ``plain_ops()``, and a
    profile of one step of each route (device time; the op table and the
    device ms of PROFILED_KERNELS for the fused routes, which it returns).
    Given a dict ``timings_out``, the fused routes' step ms goes into it as
    ``"<tag> fused_ms"``."""
    from point_diffusion_refinement_tpu_torch.ops import kernels

    times = {True: [], False: []}
    for fused in (True, False, False, True):
        step = step_for(fused)
        step()  # warm-up of this route's allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step()
        torch.cuda.synchronize()
        times[fused].append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
    on, off = float(np.mean(times[True])), float(np.mean(times[False]))
    if timings_out is not None:
        timings_out[f"{tag} fused_ms"] = on
    print(f"{tag} step: B={batch_size} fused_ms={on:.1f} ({batch_size / on * 1e3:.1f} samples/s) "
          f"unfused_ms={off:.1f} ({batch_size / off * 1e3:.1f} samples/s) "
          f"blocks fused={[round(t, 1) for t in times[True]]} "
          f"unfused={[round(t, 1) for t in times[False]]}", flush=True)

    loss_on, g_on = grads_at(model, loss_for(True))
    loss_off, g_off = grads_at(model, loss_for(False))
    rel_loss = abs(loss_on - loss_off) / abs(loss_off)
    rel_norm, worst, worst_name = grad_difference(g_on, g_off)
    print(f"{tag} routes: fused vs unfused loss_rel={rel_loss:.3g} (tol {ROUTE_LOSS_REL_TOL}) "
          f"grad_norm_rel={rel_norm:.3g} (tol {ROUTE_GRAD_NORM_REL_TOL}) "
          f"worst_tensor_rel={worst:.3g} at {worst_name} (tol {ROUTE_GRAD_WORST_REL_TOL})",
          flush=True)
    if not (rel_loss <= ROUTE_LOSS_REL_TOL and rel_norm <= ROUTE_GRAD_NORM_REL_TOL
            and worst <= ROUTE_GRAD_WORST_REL_TOL):
        raise AssertionError(f"{tag}: the fused routes disagree with the unfused ones")

    with kernels.plain_ops():
        loss_p, g_p = grads_at(model, loss_for(True))
    rel_loss = abs(loss_on - loss_p) / abs(loss_p)
    rel_norm, worst, worst_name = grad_difference(g_on, g_p)
    print(f"{tag} kernels vs plain: loss_rel={rel_loss:.3g} (tol {TRAIN_PLAIN_LOSS_REL_TOL}) "
          f"grad_norm_rel={rel_norm:.3g} (tol {TRAIN_PLAIN_GRAD_REL_TOL}) "
          f"worst_tensor_rel={worst:.3g} at {worst_name}", flush=True)
    if not (rel_loss <= TRAIN_PLAIN_LOSS_REL_TOL and rel_norm <= TRAIN_PLAIN_GRAD_REL_TOL):
        raise AssertionError(f"{tag}: a step through the kernels disagrees with the plain path")
    model.zero_grad(set_to_none=True)
    del g_on, g_off, g_p
    profile_window(f"{tag} steps at B={batch_size} (unfused)", step_for(False), 1, grad=True,
                   table=False)
    return profile_window(f"{tag} steps at B={batch_size} (fused routes)", step_for(True), 1,
                          grad=True, kernels=f"a {tag} step (fused routes)")


def launch_shapes(step, batch: int) -> None:
    """Phase 11: every shape kernel #8 and the scatter-add are launched at in
    one training step, by spies on their wrappers (as
    check_denoise_ball_queries does): (B, N, M, K, C) of #8 and (B, N, M, K,
    C, dtype, ld, masked) of the scatter-add (the ordered kernel, from the
    grouping backwards and the gathers' backward; a two-table launch of the
    fused ball group's backward as "C+C2"), the launches of each, and the
    profiler's device ms a launch, replayed on copies of the tensors the
    step gave it (a channel slice keeps its row stride); each scatter-add
    shape also through the atomic kernel B (a launch a table).  The spies
    must see every launch of the step."""
    import importlib

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.models import grouping
    from point_diffusion_refinement_tpu_torch.ops import neighbors, sampling, scatter

    # the module, not the function that ops re-exports under its name
    ball_group_mod = importlib.import_module("point_diffusion_refinement_tpu_torch.ops.ball_group")

    seen = {}  # (kernel, shape) -> [launches, replay, atomic replays, bytes moved]
    gather, scatter_add = neighbors.ball_query_group, scatter.group_scatter_add
    scatter_pair = scatter.group_scatter_add_pair

    def copy_of(dg):
        """A copy of ``dg`` with its row stride (a channel slice stays one)."""
        B, M, K, C = dg.shape
        ld = dg.stride(2)
        off = dg.storage_offset() % ld
        d = torch.empty(B, M, K, ld, dtype=dg.dtype, device=dg.device)[..., off:off + C]
        d.copy_(dg)
        return d

    def moved(dgs, n_rows, counts):  # the tables' values, idx, the counts, the results
        B, M, K, _ = dgs[0].shape
        return (sum(d.numel() * d.element_size() + B * n_rows * d.shape[-1] * 4 for d in dgs)
                + B * M * K * 4 + (B * M * 4 if counts is not None else 0))

    def gather_spy(xyz, new_xyz, table, radius, nsample):
        key = ("ball_query_group",
               (xyz.shape[0], xyz.shape[1], new_xyz.shape[1], int(nsample), table.shape[-1]))
        if key not in seen:
            a, b, t = xyz.clone(), new_xyz.clone(), table.clone()
            seen[key] = [0, lambda: gather(a, b, t, radius, nsample), None, None]
        seen[key][0] += 1
        return gather(xyz, new_xyz, table, radius, nsample)

    def scatter_spy(dg, idx, n_rows, counts=None):
        B, M, K, C = dg.shape
        key = ("group_scatter_ordered", (B, n_rows, M, K, C, str(dg.dtype).split(".")[-1],
                                         dg.stride(2), counts is not None))
        if key not in seen:
            d = copy_of(dg)
            i, n = idx.clone(), counts.clone() if counts is not None else None
            seen[key] = [0, lambda: scatter_add(d, i, n_rows, n),
                         [lambda: scatter_add(d, i, n_rows, n, deterministic=False)],
                         moved([dg], n_rows, counts)]
        seen[key][0] += 1
        return scatter_add(dg, idx, n_rows, counts)

    def pair_spy(dg, dg2, idx, n_rows, counts=None):
        B, M, K, C = dg.shape
        key = ("group_scatter_ordered", (
            B, n_rows, M, K, f"{C}+{dg2.shape[-1]}",
            "+".join(str(d.dtype).split(".")[-1] for d in (dg, dg2)),
            f"{dg.stride(2)}+{dg2.stride(2)}", counts is not None))
        if key not in seen:
            d, d2 = copy_of(dg), copy_of(dg2)
            i, n = idx.clone(), counts.clone() if counts is not None else None
            seen[key] = [0, lambda: scatter_pair(d, d2, i, n_rows, n),
                         [lambda x=x: scatter_add(x, i, n_rows, n, deterministic=False)
                          for x in (d, d2)],
                         moved([dg, dg2], n_rows, counts)]
        seen[key][0] += 1
        return scatter_pair(dg, dg2, idx, n_rows, counts)

    spots = ((grouping, "ball_query_group", gather_spy),
             (grouping, "group_scatter_add", scatter_spy),
             (ball_group_mod, "group_scatter_add", scatter_spy),
             (ball_group_mod, "group_scatter_add_pair", pair_spy),
             (sampling, "group_scatter_add", scatter_spy))
    saved = [getattr(mod, name) for mod, name, _ in spots]
    ops.reset_launch_counts()
    try:
        for mod, name, spy in spots:
            setattr(mod, name, spy)
        step()
        torch.cuda.synchronize()
    finally:
        for (mod, name, _), orig in zip(spots, saved):
            setattr(mod, name, orig)
    counts = ops.launch_counts()
    total, bounds = {}, {}
    for (kernel, shape), (n, replay, atomic_replays, bytes_moved) in sorted(
            seen.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        atomic = ""
        if kernel == "ball_query_group":  # inputs, gathered rows, idx, counts
            ms = device_ms(replay, kernel, iters=10)
            B, N, M, K, C = shape
            bytes_moved = (B * N * (3 + C) * 4 + B * M * 3 * 4 + B * M * K * (C + 1) * 4
                           + B * M * 4)
        else:
            ms = window_device_ms(replay, 10)
            atomic_ms = sum(device_ms(f, "group_scatter_add", iters=10) for f in atomic_replays)
            total["group_scatter_add (atomic B)"] = (total.get("group_scatter_add (atomic B)", 0.0)
                                                     + n * atomic_ms)
            atomic = f" atomic_B_device_ms={atomic_ms:.4f}"
        b_ms, _ = bound(bytes_moved, 0.0)
        total[kernel] = total.get(kernel, 0.0) + n * ms
        bounds[kernel] = bounds.get(kernel, 0.0) + n * b_ms
        print(f"train step launch shape: {kernel} {shape} launches={n} device_ms={ms:.4f} "
              f"bound_ms={b_ms:.5f} (bytes){atomic}", flush=True)
    for kernel in ("ball_query_group", "group_scatter_ordered"):
        spied = sum(v[0] for (k, _), v in seen.items() if k == kernel)
        if spied != counts[kernel]:
            raise AssertionError(f"launch shapes: the spies saw {spied} launches of {kernel}, "
                                 f"the step made {counts[kernel]}")
    print(f"train step launch shapes at B={batch}: device ms a step (launches x replayed "
          f"device ms) " + " ".join(f"{k}={v:.4f}" + (f" (bound {bounds[k]:.4f})" if k in bounds
                                                        else "")
                                    for k, v in total.items()), flush=True)


def ddpm_training(dev, workdir: str, timings_out=None):
    """Phase 11: DDPM training at full width through ``train()``; its fused
    step ms goes into ``timings_out``."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.train.loop import build_model, train

    arrays = training_arrays(TRAIN_BATCH * TRAIN_STEPS, 2048, seed=10)
    dc = EXPERIMENTS["ddpm"]()["diffusion_config"]
    schedule = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])

    def config(root: str, batch: int) -> dict:
        cfg = EXPERIMENTS["ddpm"]()
        cfg["train_config"].update(root_directory=root, n_epochs=1, epochs_per_ckpt=1,
                                   iters_per_logging=1, shuffle_seed=0)
        cfg["mvp_dataset_config"].update(batch_size=batch, num_samples_tested=0)
        return cfg

    pc = config("", 1)["pointnet_config"]

    def tensors(batch: int):
        return (torch.from_numpy(arrays["complete"][:batch]).to(dev),
                torch.from_numpy(arrays["partial"][:batch]).to(dev),
                torch.from_numpy(arrays["label"][:batch]).to(dev))

    def step_at(batch: int):
        model = build_model(pc, device=dev, seed=0)
        step = tr.make_completion_train_step(model, schedule, fused_gather=True, fused_sa=True)
        step(tr.create_train_state(model, seed=1), *tensors(batch))

    B = fit_batch("ddpm train", step_at, TRAIN_BATCH)
    ds = ArrayDataset(**{k: v[: B * TRAIN_STEPS] for k, v in arrays.items()})

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = train(config(f"{workdir}/ddpm_fused", B), dataset_override=ds,
                   fused_gather=True, fused_sa=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"ddpm train: {TRAIN_STEPS} steps at B={B} through train() in "
          f"{time.perf_counter() - t0:.1f} s (model build and checkpoints included), "
          f"losses={[round(v, 5) for v in result['losses']]}", flush=True)
    print(f"ddpm train launches: {counts} per_step="
          f"{ {k: v / TRAIN_STEPS for k, v in counts.items()} }", flush=True)
    check_trained("ddpm train", result, build_model(pc, device=dev, seed=0), counts)

    plain = train(config(f"{workdir}/ddpm_unfused", B), dataset_override=ds)
    rel = abs(result["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    print(f"ddpm train unfused: losses={[round(v, 5) for v in plain['losses']]} "
          f"first_step_loss_rel={rel:.3g} (tol {ROUTE_LOSS_REL_TOL})", flush=True)
    if not rel <= ROUTE_LOSS_REL_TOL:
        raise AssertionError("ddpm train: the routes' first-step losses disagree")
    del plain

    model, state = result["model"], result["state"]
    x0, cond, label = tensors(B)
    sched = schedule.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    t = torch.randint(0, sched.T, (B,), generator=gen, device=dev)
    z = torch.randn(x0.shape, generator=gen, device=dev)

    def loss_for(fused: bool):
        fn = tr.make_completion_loss(model, sched, fused_gather=fused, fused_sa=fused)
        return lambda: fn(x0, cond, label, t, z)

    def step_for(fused: bool):
        step = tr.make_completion_train_step(model, schedule, fused_gather=fused, fused_sa=fused)
        return lambda: step(state, x0, cond, label)

    launch_shapes(step_for(True), B)
    return counts, compare_routes("ddpm train", model, loss_for, step_for, state, B,
                                  timings_out)


def refine_training(dev, workdir: str):
    """Phase 12: x8 refine training through ``train()``, with a checkpoint
    resumed from."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.train.loop import build_model, train

    arrays = training_arrays(TRAIN_BATCH * 2, 16384, seed=20)

    def config(root: str, batch: int) -> dict:
        cfg = EXPERIMENTS["upsample_16384"]()
        cfg["pointnet_config"]["intermediate_refined_X_loss_weight"] = 1.0
        cfg["train_config"].update(root_directory=root, n_epochs=2, epochs_per_ckpt=1,
                                   iters_per_logging=1, shuffle_seed=0,
                                   only_save_the_best_model=False, compute_emd=False)
        cfg["mvp_dataset_config"].update(batch_size=batch, num_samples_tested=batch,
                                         eval_batch_size=batch)
        cfg["refine_config"].update(
            cd_loss_type="cd_t", use_output_scale_factor_schedule=True,
            output_scale_factor_schedule={"init_epoch": 0, "final_epoch": 2, "init_value": 0.01},
            decrease_epochs_per_ckpt_for_fine_tuning=False)
        return cfg

    cfg0 = config("", 1)
    pc, rc = cfg0["pointnet_config"], cfg0["refine_config"]
    opts = dict(scale=1.0, cd_loss_type=rc["cd_loss_type"],
                point_upsample_factor=int(pc["point_upsample_factor"]),
                include_displacement_center=bool(
                    pc["include_displacement_center_to_final_output"]),
                intermediate_loss_weight=float(pc["intermediate_refined_X_loss_weight"]))
    osf = float(rc["output_scale_factor"])

    def tensors(batch: int):
        return tuple(torch.from_numpy(arrays[k][:batch]).to(dev)
                     for k in ("complete", "partial", "label", "generated"))

    def step_at(batch: int):
        model = build_model(pc, device=dev, seed=0)
        step = tr.make_refine_train_step(model, fused_gather=True, fused_sa=True, **opts)
        step(tr.create_train_state(model, seed=1), *tensors(batch), osf)

    B = fit_batch("refine train", step_at, TRAIN_BATCH)
    ds = ArrayDataset(**{k: v[: B * 2] for k, v in arrays.items()})
    eval_ds = ArrayDataset(**{k: v[:B] for k, v in arrays.items()})
    kw = dict(dataset_override=ds, eval_dataset_override=eval_ds,
              trainset_eval_dataset_override=eval_ds, fused_gather=True, fused_sa=True)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = train(config(f"{workdir}/refine_fused", B), **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"refine train: {TRAIN_STEPS} steps at B={B} (x8, cd_t + intermediate, output "
          f"scale 0.01 -> 0.001) through train() in {time.perf_counter() - t0:.1f} s "
          f"(two in-loop evals and checkpoints included), "
          f"losses={[round(v, 6) for v in result['losses']]} "
          f"eval_cd={result['eval_records']['avg_cd']}", flush=True)
    print(f"refine train launches: {counts}", flush=True)
    check_trained("refine train", result, build_model(pc, device=dev, seed=0), counts)
    if not np.isfinite(result["eval_records"]["avg_cd"]).all():
        raise AssertionError("refine train: in-loop eval CD is not finite")

    # stop at the first checkpoint (end of epoch 0), then resume from it
    part = train(config(f"{workdir}/refine_resumed", B), max_steps=2, **kw)
    cfg = config(f"{workdir}/refine_resumed", B)
    cfg["train_config"]["ckpt_iter"] = 1
    rest = train(cfg, **kw)
    full = result["losses"]
    rels = [abs(a - b) / abs(b) for a, b in zip(part["losses"] + rest["losses"], full)]
    print(f"refine train resumed: losses={[round(v, 6) for v in part['losses'] + rest['losses']]} "
          f"rel_to_uninterrupted={[float(f'{r:.3g}') for r in rels]} (tol {RESUME_REL_TOL})",
          flush=True)
    if len(rest["losses"]) != 2 or rest["n_iter"] != TRAIN_STEPS or not max(rels) <= RESUME_REL_TOL:
        raise AssertionError("refine train: the resumed run disagrees with the uninterrupted one")
    del part, rest

    model, state = result["model"], result["state"]
    batch = tensors(B)

    def loss_for(fused: bool):
        fn = tr.make_refine_loss(model, fused_gather=fused, fused_sa=fused, **opts)
        return lambda: fn(*batch, osf)

    def step_for(fused: bool):
        step = tr.make_refine_train_step(model, fused_gather=fused, fused_sa=fused, **opts)
        return lambda: step(state, *batch, osf)

    return counts, compare_routes("refine train", model, loss_for, step_for, state, B)


def stringify_lists(tree):
    """The reference's JSON schema: every list stored as its repr, which
    ``load_config`` restores."""
    if isinstance(tree, dict):
        return {k: stringify_lists(v) for k, v in tree.items()}
    return str(tree) if isinstance(tree, list) else tree


def file_pipeline(dev, workdir: str, direct: dict) -> dict:
    """Phase 14: the README's file-driven pipeline through the port's CLIs,
    at full width on seeded random weights; returns the launch counts of the
    whole phase.  ``direct`` holds phase 7's FastDPM ms and phase 11's fused
    train step ms, printed beside the same work through the CLIs."""
    import importlib.util

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.cli import generate_cli, preprocess_cli, train_cli
    from point_diffusion_refinement_tpu_torch.cli.eval_results import (
        gather_eval_results,
        plot_result,
    )
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.data import (
        ArrayDataset,
        synthetic_dataset,
        write_mvp_style_h5,
    )
    from point_diffusion_refinement_tpu_torch.sample.pipeline import (
        generation_save_dir,
        run_generation_from_file,
    )
    from point_diffusion_refinement_tpu_torch.train import find_max_epoch
    from point_diffusion_refinement_tpu_torch.train.loop import (
        local_experiment_path,
        make_dataset,
        train_from_file,
    )

    files = importlib.util.find_spec("h5py") is not None
    print(f"file pipeline: route={'h5 files' if files else 'in memory (h5py does not import)'}",
          flush=True)
    data_dir, root = f"{workdir}/mvp", f"{workdir}/exp"
    total = {}

    def run(tag: str, kernels, call):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        print(f"file pipeline {tag}: wall_s={secs:.2f} "
              f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"file pipeline {tag}: kernels {missing} were not launched")
        return out

    def evaluated(eval_dir: str, it: int, tag: str = "") -> int:
        with open(os.path.join(eval_dir, f"eval_result_ckpt_{it}_rank_0{tag}.pkl"), "rb") as f:
            cd = pickle.load(f)["cd_distance"]
        if not np.isfinite(cd).all():
            raise AssertionError(f"file pipeline: in-loop CD at {it}{tag} is not finite")
        return len(cd)

    def saved(path: str) -> str:
        if not os.path.isfile(os.path.join(path, "eval_result.pkl")):
            raise AssertionError(f"file pipeline: no eval_result.pkl under {path}")
        print(f"file pipeline saved: {os.path.relpath(path, workdir)} "
              f"{sorted(os.listdir(path))}", flush=True)
        return path

    def finite(tag: str, res, shape) -> None:
        ok = (res.generated.shape == shape and np.isfinite(res.generated).all()
              and all(np.isfinite(v).all() for v in res.metrics.values())
              and len(res.metrics["cd_distance"]) == shape[0])
        print(f"file pipeline {tag}: generated={res.generated.shape} avg_cd={res.avg_cd:.6g} "
              f"avg_emd={res.avg_emd:.6g} finite={ok}", flush=True)
        if not ok:
            raise AssertionError(f"file pipeline {tag}: not {shape[0]} finite clouds and CDs")

    # 1. the DDPM config, in the reference's schema
    ddpm = EXPERIMENTS["ddpm"]()
    ddpm["train_config"].update(root_directory=root, n_epochs=2, epochs_per_ckpt=1,
                                iters_per_logging=1, eval_sampling_steps=FAST_STEPS,
                                shuffle_seed=0)
    mc = ddpm["mvp_dataset_config"]
    mc.update(data_dir=data_dir, batch_size=TRAIN_BATCH, eval_batch_size=FILE_TESTED,
              num_samples_tested=FILE_TESTED)
    refine = EXPERIMENTS["upsample_16384"]()
    # 2048-point coarse clouds, 3072 x 4 mirrored partials, 16384-point GT
    n_coarse, n_partial = mc["npoints"], mc["number_partial_points"]
    n_fine = refine["mvp_dataset_config"]["npoints"]
    spec = dict(num_samples=FILE_ITEMS, npoints=n_coarse, partial_points=n_coarse, seed=30,
                mirror_to=n_partial)
    if files:  # 3 GT shapes a split, 78 partials; the GT at n_fine points too
        for npoints in (n_fine, n_coarse):
            write_mvp_style_h5(data_dir, num_shapes=2, npoints=npoints, partial_points=n_coarse)
        run("preprocess_cli", ("fps_idx",), lambda: preprocess_cli.main(
            ["--data_dir", data_dir, "--num_points", str(n_partial)]))
    else:
        mc["synthetic"] = spec
    ddpm_path = f"{workdir}/config_ddpm.json"
    with open(ddpm_path, "w") as f:
        json.dump(stringify_lists(ddpm), f)

    # 2. train: one checkpoint with its in-loop eval, then the last
    result = run("train_cli ddpm", TRAIN_PATH_KERNELS + ("ball_query",), lambda: train_cli.main(
        ["-c", ddpm_path, "--max_steps", str(FILE_STEPS), "--fused_gather", "--fused_sa"]))
    exp = os.path.join(root, local_experiment_path(ddpm))
    ckpt_dir, eval_dir = os.path.join(exp, "logs", "checkpoint"), os.path.join(exp, "eval_result")
    ckpts = find_max_epoch(ckpt_dir, "all")
    n_eval = (evaluated(eval_dir, 1), evaluated(eval_dir, 1, "_trainset"))
    steps_ms = [round(s * 1e3, 1) for s in result["step_seconds"]]
    print(f"file pipeline ddpm: checkpoints={ckpts} under {os.path.relpath(ckpt_dir, workdir)} "
          f"in-loop eval clouds (test, trainset)={n_eval} of num_samples_tested={FILE_TESTED}",
          flush=True)
    print(f"file pipeline ddpm train step B={TRAIN_BATCH}: through train_cli step_ms={steps_ms} "
          f"(batch assembly included; median of the later steps "
          f"{float(np.median(steps_ms[1:])):.1f}) direct train() step_ms "
          f"{direct.get('ddpm train fused_ms', float('nan')):.1f} (phase 11)", flush=True)
    if ckpts != [FILE_STEPS, 1] or n_eval != (FILE_TESTED, FILE_TESTED):
        raise AssertionError("file pipeline ddpm: checkpoints or in-loop eval are wrong")
    if not np.isfinite(result["losses"]).all():
        raise AssertionError("file pipeline ddpm: losses are not finite")

    # 3. generate the test set with FastDPM on the newest checkpoint
    it = find_max_epoch(ckpt_dir, "max")
    print(f"file pipeline generate_cli checkpoint: "
          f"{os.path.relpath(ckpt_dir, workdir)}/pointnet_ckpt_{it}", flush=True)
    fs = {"length": FAST_STEPS, "sampling_method": "var", "schedule": "quadratic", "kappa": 0.5}
    fast = ["--fast_sampling", "--fast_sampling_length", str(FAST_STEPS)]
    (test_res,) = run("generate_cli test", COARSE_PATH_KERNELS, lambda: generate_cli.main(
        ["-c", ddpm_path, "--batch_size", "4", "--num_samples_tested", str(FILE_TESTED)]
        + fast))
    if files:  # the refine stage reads the generations of the whole split: rewrite them
        run("generate_cli test (whole split)", COARSE_PATH_KERNELS, lambda: generate_cli.main(
            ["-c", ddpm_path, "--batch_size", str(TRAIN_BATCH)] + fast))
    test_dir = saved(generation_save_dir(ddpm, it, fast_sampling=True, fast_sampling_config=fs))
    finite("generate_cli test", test_res, (FILE_TESTED, n_coarse, 3))
    print(f"file pipeline FastDPM-{FAST_STEPS} B=4: through generate_cli ms_per_batch="
          f"{test_res.total_generation_time / (FILE_TESTED // 4) * 1e3:.1f} (first batch "
          f"included) direct fastdpm{FAST_STEPS}_ms "
          f"{direct.get('fastdpm_ms', float('nan')):.1f} (phase 7)", flush=True)

    # 4. generate the train set: two augmented trials (and the bare
    # directory, which random trial selection can pick, where files are read)
    n_train = len(make_dataset(mc, "train")) if files else FILE_ITEMS
    trials = run("generate_cli test_trainset", COARSE_PATH_KERNELS, lambda: generate_cli.main(
        ["-c", ddpm_path, "--phase", "test_trainset", "--num_trials", "2",
         "--augment_data_during_generation", "--batch_size", str(TRAIN_BATCH)] + fast))
    for i, res in enumerate(trials, 1):
        saved(generation_save_dir(ddpm, it, fast_sampling=True, fast_sampling_config=fs,
                                  trial_index=i, phase="test_trainset"))
        finite(f"generate_cli trial {i}", res, (n_train, n_coarse, 3))
    if files:
        run("generate_cli test_trainset bare", COARSE_PATH_KERNELS, lambda: generate_cli.main(
            ["-c", ddpm_path, "--phase", "test_trainset", "--batch_size", str(TRAIN_BATCH)]
            + fast))

    # 5. refine x8 on the generated clouds
    refine["train_config"].update(root_directory=root, n_epochs=1, iters_per_logging=1,
                                  shuffle_seed=0)
    refine["mvp_dataset_config"].update(
        data_dir=data_dir, batch_size=TRAIN_BATCH, eval_batch_size=FILE_TESTED,
        generated_sample_path=os.path.relpath(os.path.dirname(test_dir), data_dir))
    refine["refine_config"].update(epochs_per_ckpt=1, num_samples_tested=FILE_TESTED)
    refine_path = f"{workdir}/config_refine.json"
    with open(refine_path, "w") as f:
        json.dump(stringify_lists(refine), f)
    refine_kernels = ("fps", "ball_query", "knn")  # the unfused refine forward
    if files:
        rresult = run("train_cli refine", TRAIN_PATH_KERNELS, lambda: train_cli.main(
            ["-c", refine_path, "--max_steps", "2", "--fused_gather", "--fused_sa"]))
        (refined,) = run("generate_cli refine", refine_kernels, lambda: generate_cli.main(
            ["-c", refine_path, "--num_samples_tested", str(FILE_TESTED)]))
    else:
        # the two-stage hand-off in memory: the generated clouds back at the
        # data's scale (evaluate divides by 2 * scale) beside the same items'
        # n_fine-point GT (parametric shapes: the same surfaces)
        s = 2.0 * mc["scale"]
        tr = make_dataset(mc, "train").arrays
        big = synthetic_dataset(FILE_ITEMS, n_fine, n_coarse, seed=spec["seed"]).arrays
        train_ds = ArrayDataset(complete=big["complete"], partial=tr["partial"],
                                label=tr["label"], generated=trials[0].generated * s)
        te = make_dataset(mc, "test", eval_subset=FILE_TESTED).arrays
        te_big = make_dataset({"synthetic": {**spec, "npoints": n_fine, "mirror_to": 0}},
                              "test", eval_subset=FILE_TESTED).arrays
        test_ds = ArrayDataset(complete=te_big["complete"], partial=te["partial"],
                               label=te["label"], generated=test_res.generated * s)
        trainset_ds = ArrayDataset(**{k: v[:FILE_TESTED] for k, v in train_ds.arrays.items()})
        rresult = run("train_from_file refine", TRAIN_PATH_KERNELS, lambda: train_from_file(
            refine_path, max_steps=2, dataset_override=train_ds, eval_dataset_override=test_ds,
            trainset_eval_dataset_override=trainset_ds, fused_gather=True, fused_sa=True))
        (refined,) = run("run_generation refine", refine_kernels, lambda: run_generation_from_file(
            refine_path, dataset_override=test_ds))
    rexp = os.path.join(root, local_experiment_path(refine))
    rckpt = os.path.join(rexp, "logs", "checkpoint")
    rit = find_max_epoch(rckpt, "max")
    print(f"file pipeline refine: checkpoints={sorted(os.listdir(rckpt))} under "
          f"{os.path.relpath(rckpt, workdir)} losses={[round(v, 6) for v in rresult['losses']]} "
          f"in-loop eval clouds={evaluated(os.path.join(rexp, 'eval_result'), 1)}", flush=True)
    if (rit != 2 or not os.path.isdir(os.path.join(rckpt, "pointnet_ckpt_1_best_cd"))
            or not np.isfinite(rresult["losses"]).all()
            or evaluated(os.path.join(rexp, "eval_result"), 1) != FILE_TESTED):
        raise AssertionError("file pipeline refine: checkpoints, losses or eval are wrong")
    saved(generation_save_dir(refine, rit))
    finite("refine generation", refined, (FILE_TESTED, n_fine, 3))

    # 6. gather and plot the DDPM's eval results
    gathered = gather_eval_results(eval_dir)
    plot = plot_result(gathered, save_path=f"{workdir}/ddpm_eval.png")
    print(f"file pipeline gathered: iter={gathered['iter']} avg_cd={gathered['avg_cd']} "
          f"plot={'drawn' if plot and os.path.isfile(plot) else 'not drawn (no matplotlib)'}",
          flush=True)
    if gathered["iter"] != [1] or not np.isfinite(gathered["avg_cd"]).all():
        raise AssertionError("file pipeline: the gathered eval results are wrong")
    return total


# ---- phase 16: the networks and model options of the tenth slice ----------


def moved_check(tag: str, model, fresh_model) -> int:
    """Every parameter has a finite gradient and moved from its seeded start,
    but for tensors whose gradient is exactly zero (a squeeze-excitation's
    hidden ReLU units all off); returns their count."""
    start = dict(fresh_model.named_parameters())
    dead = 0
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{tag}: parameter {name} has no finite gradient")
        if torch.equal(p.detach(), start[name].detach()):
            if bool(p.grad.any()):
                raise AssertionError(f"{tag}: parameter {name} did not move")
            dead += 1
    return dead


def pvd_kernels_at_its_shapes(x0, cond) -> None:
    """The PVD path's kernels on the joined (B, 5120) cloud, against their
    plain versions: FPS to 1024 (#6), the level-0 ball query (#3, r=0.1,
    K=32) and the level-3 feature propagation's 3-NN (#4, 5120 queries over
    1024 points)."""
    from point_diffusion_refinement_tpu_torch.ops import neighbors, sampling

    pts = torch.cat([x0, cond[..., :3]], dim=1).contiguous()
    B, N, _ = pts.shape
    idx = sampling.furthest_point_sample(pts, 1024)
    ridx = sampling.furthest_point_sample_plain(pts, 1024)
    centers = sampling.gather_points(pts, idx)
    bidx, bcnt = neighbors.ball_query(pts, centers, 0.1, 32)
    rbidx, rbcnt = neighbors.ball_query_plain(pts, centers, 0.1, 32)
    d, kidx = neighbors.knn(pts, centers, 3)
    rd, rkidx = neighbors.knn_plain(pts, centers, 3)
    torch.cuda.synchronize()
    equal = (torch.equal(idx, ridx), torch.equal(bidx, rbidx) and torch.equal(bcnt, rbcnt),
             torch.equal(kidx.long(), rkidx.long()) and torch.equal(d, rd))
    runs = (
        ("fps_idx", f"({B},{N})->1024", lambda: sampling.furthest_point_sample(pts, 1024),
         lambda: sampling.furthest_point_sample_plain(pts, 1024)),
        ("ball_query", f"sup ({B},{N}) q 1024 r=0.1 K=32",
         lambda: neighbors.ball_query(pts, centers, 0.1, 32),
         lambda: neighbors.ball_query_plain(pts, centers, 0.1, 32)),
        ("knn", f"q ({B},{N}) pts 1024 k=3", lambda: neighbors.knn(pts, centers, 3),
         lambda: neighbors.knn_plain(pts, centers, 3)),
    )
    for (name, shape, run, plain), ok in zip(runs, equal):
        print(f"pvd kernel {name} {shape}: equal to plain: {ok} "
              f"device_ms={device_ms(run, name, iters=10):.4f} "
              f"plain_ms={time_ms(plain, 2, warmup=1):.4f}", flush=True)
        if not ok:
            raise AssertionError(f"pvd: kernel {name} differs from its plain version")


def pvd_training(dev, workdir: str):
    """Phase 16a: PVCNN2Completion at the class defaults through ``train()``
    (task completion, the ``ddpm`` schedule), the largest power-of-two batch
    up to TRAIN_BATCH."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.ops import kernels
    from point_diffusion_refinement_tpu_torch.sample import make_refiner
    from point_diffusion_refinement_tpu_torch.train.loop import build_model, train

    arrays = training_arrays(TRAIN_BATCH * TRAIN_STEPS, 2048, seed=30)
    pc = {"network_type": "pvd", "model_name": "pvd", "network_args": {}}
    schedule = option_schedule()

    def tensors(batch: int):
        return tuple(torch.from_numpy(arrays[k][:batch]).to(dev)
                     for k in ("complete", "partial", "label", "generated"))

    def step_at(batch: int):
        model = build_model(pc, device=dev, seed=0)
        step = tr.make_completion_train_step(model, schedule)
        step(tr.create_train_state(model, seed=1), *tensors(batch)[:3])

    B = fit_batch("pvd train", step_at, TRAIN_BATCH)
    x0, cond, label, coarse = tensors(B)
    pvd_kernels_at_its_shapes(x0, cond)

    ds = ArrayDataset(**{k: v[: B * TRAIN_STEPS] for k, v in arrays.items()})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = train(option_config(f"{workdir}/pvd", B, pc), dataset_override=ds)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = result["losses"]
    print(f"pvd train: {TRAIN_STEPS} steps at B={B} through train() in "
          f"{time.perf_counter() - t0:.1f} s, losses={[round(v, 5) for v in losses]}", flush=True)
    model, state = result["model"], result["state"]

    # one step's launches: the run made TRAIN_STEPS times as many of each
    step = tr.make_completion_train_step(model, schedule)
    ops.reset_launch_counts()
    step(state, x0, cond, label)
    torch.cuda.synchronize()
    one = ops.launch_counts()
    print(f"pvd train launches: run={counts} one_step={one}", flush=True)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"pvd train: losses are not {TRAIN_STEPS} finite values")
    for name in PVD_PATH_KERNELS:
        if one[name] <= 0 or counts[name] != TRAIN_STEPS * one[name]:
            raise AssertionError(f"pvd train: kernel {name} was not launched on every step")
    dead = moved_check("pvd train", model, build_model(pc, device=dev, seed=0))
    print(f"pvd train: every parameter finite and moved, but {dead} tensors with an all-zero "
          f"gradient", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    sched = schedule.to(dev)
    t = torch.randint(0, sched.T, (B,), generator=gen, device=dev)
    z = torch.randn(x0.shape, generator=gen, device=dev)
    loss_fn = tr.make_completion_loss(model, sched)
    loss_k, g_k = grads_at(model, lambda: loss_fn(x0, cond, label, t, z))
    with kernels.plain_ops():
        loss_p, g_p = grads_at(model, lambda: loss_fn(x0, cond, label, t, z))
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_norm, worst, worst_name = grad_difference(g_k, g_p)
    print(f"pvd train kernels vs plain: loss_rel={rel_loss:.3g} (tol {PVD_PLAIN_LOSS_REL_TOL}) "
          f"grad_norm_rel={rel_norm:.3g} (tol {PVD_PLAIN_GRAD_REL_TOL}) "
          f"worst_tensor_rel={worst:.3g} at {worst_name}", flush=True)
    if not (rel_loss <= PVD_PLAIN_LOSS_REL_TOL and rel_norm <= PVD_PLAIN_GRAD_REL_TOL):
        raise AssertionError("pvd train: a step through the kernels disagrees with the plain path")
    model.zero_grad(set_to_none=True)
    del g_k, g_p

    run = lambda: step(state, x0, cond, label)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"pvd train step: B={B} step_ms={ms:.1f} ({B / ms * 1e3:.1f} samples/s)", flush=True)
    profile_window(f"pvd train steps at B={B}", run, 1, grad=True, kernels="a pvd train step")
    model.zero_grad(set_to_none=True)
    compiled = tr.make_completion_train_step(model, schedule, compiled=True)
    run = lambda: compiled(state, x0, cond, label)  # noqa: E731
    run()  # the warm-up
    run()  # the capture and a replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        run()
    torch.cuda.synchronize()
    cms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    print(f"pvd train step compiled: B={B} step_ms={cms:.1f} ({B / cms * 1e3:.1f} samples/s) "
          f"against eager {ms:.1f}", flush=True)
    graph_stats("pvd train step", compiled.graphs)
    compiled.graphs.release()
    del compiled, run

    with torch.no_grad():
        refined = make_refiner(model)(coarse, cond, label, 0.001)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(refined).all())
    print(f"pvd refine forward: B={B} out={tuple(refined.shape)} finite={finite}", flush=True)
    if tuple(refined.shape) != (B, 2048, 3) or not finite:
        raise AssertionError("pvd refine forward is not a finite (B, 2048, 3) cloud")
    return counts, arrays


def pointwise_training(dev, workdir: str, arrays):
    """Phase 16b: PointwiseNet at its defaults through ``train()`` at
    B = TRAIN_BATCH on phase 16a's data; it runs no kernel.  Then its step
    eager and compiled from the step maker, timed alike, as the PVD step
    is."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.train.loop import build_model, train

    pc = {"network_type": "pointwise_net", "model_name": "pointwise", "network_args": {}}
    ds = ArrayDataset(**{k: v[: TRAIN_BATCH * TRAIN_STEPS] for k, v in arrays.items()})
    ops.reset_launch_counts()
    result = train(option_config(f"{workdir}/pointwise", TRAIN_BATCH, pc), dataset_override=ds)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = result["losses"]
    step_ms = [round(s * 1e3, 1) for s in result["step_seconds"]]
    print(f"pointwise train: {TRAIN_STEPS} steps at B={TRAIN_BATCH} losses="
          f"{[round(v, 5) for v in losses]} step_ms={step_ms} (host, from batch to loss; the "
          f"first a warm-up, the second the capture) launches={counts}", flush=True)
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"pointwise train: losses are not {TRAIN_STEPS} finite values")
    cond_w = arrays["partial"].shape[-1]
    dead = moved_check("pointwise train", result["model"],
                       build_model(pc, device=dev, seed=0, condition_features=cond_w))
    print(f"pointwise train: every parameter finite and moved, but {dead} tensors with an "
          f"all-zero gradient", flush=True)

    model = build_model(pc, device=dev, seed=0, condition_features=cond_w)
    state = tr.create_train_state(model, seed=1)
    batch = tuple(torch.from_numpy(arrays[k][:TRAIN_BATCH]).to(dev)
                  for k in ("complete", "partial", "label"))
    ms = {}
    for compiled in (False, True):
        step = tr.make_completion_train_step(model, option_schedule(), compiled=compiled)
        step(state, *batch)  # the warm-up
        step(state, *batch)  # compiled: the capture and a replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POINTWISE_TIMED_STEPS):
            float(step(state, *batch)[1])  # a step ends on the host, as in train()
        ms[compiled] = (time.perf_counter() - t0) * 1e3 / POINTWISE_TIMED_STEPS
        if compiled:
            graph_stats("pointwise train step", step.graphs)
            step.graphs.release()
    print(f"pointwise train step: B={TRAIN_BATCH} compiled step_ms={ms[True]:.2f} against "
          f"eager {ms[False]:.2f}", flush=True)
    return counts


def fp_launches(model, call) -> dict:
    """{FP module: launches inside its forward} of one ``call()``."""
    from point_diffusion_refinement_tpu_torch import ops

    seen, hooks = {}, []
    for name, m in model.named_children():
        if name.startswith("fp"):
            def pre(mod, args, name=name):
                seen[name] = ops.launch_counts()

            def post(mod, args, out, name=name):
                after = ops.launch_counts()
                seen[name] = {k: after[k] - seen[name][k] for k in after
                              if after[k] != seen[name][k]}

            hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        call()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return seen


def option_model(dev, **overrides):
    """``DEFAULT_POINTNET_CONFIG`` in bf16 with seeded weights, with
    ``overrides`` (``grouper=True`` sets ``include_grouper`` in both
    ladders)."""
    import copy

    from point_diffusion_refinement_tpu_torch.config import DEFAULT_POINTNET_CONFIG
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition

    cfg = copy.deepcopy(dict(DEFAULT_POINTNET_CONFIG))
    cfg["compute_dtype"] = "bfloat16"
    if overrides.pop("grouper", False):
        for arch in ("architecture", "condition_net_architecture"):
            cfg[arch]["include_grouper"] = True
    cfg.update(overrides)
    return cfg, PointNet2CloudCondition.from_config(cfg, device=dev, seed=0)


def fp_grouper(dev, rng):
    """Phase 16c: the feature-propagation grouper at the default config in
    bf16: one B=4 ``denoise(fused=True)`` step against ``plain_ops()``, one
    DDPM training step with both fused routes, and the launches inside each
    FP module (the grouper's: #3 at inference, #8 under ``fused_gather``)."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.ops import kernels

    B = 4
    _, model = option_model(dev, grouper=True)
    cond = conditions(rng, B, dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    x = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    ts = torch.full((B,), 5.0, device=dev)
    with torch.no_grad():
        model.denoise(x, ts, label, model.encode_condition(cond), fused=True)  # warm-up
        ops.reset_launch_counts()
        out = {}
        by_fp = fp_launches(model, lambda: out.update(y=model.denoise(
            x, ts, label, model.encode_condition(cond), fused=True).float()))
        counts = ops.launch_counts()
        with kernels.plain_ops():
            y_p = model.denoise(x, ts, label, model.encode_condition(cond), fused=True).float()
    y_k = out["y"]
    rel = float((y_k - y_p).norm() / y_p.norm())
    finite = bool(torch.isfinite(y_k).all())
    print(f"fp grouper: encode + denoise step B={B} out={tuple(y_k.shape)} finite={finite} "
          f"launches={counts} kernels vs plain rel_err={rel:.3g} (tol {DENOISE_REL_TOL})",
          flush=True)
    print(f"fp grouper: launches inside each FP module of encode + denoise: {by_fp}",
          flush=True)
    if tuple(y_k.shape) != (B, 2048, 3) or not finite or not rel <= DENOISE_REL_TOL:
        raise AssertionError("fp grouper: the denoise step is wrong or disagrees with plain")
    if any(c.get("ball_query", 0) < 1 for c in by_fp.values()):
        raise AssertionError("fp grouper: an FP level did not launch the ball query")
    del model

    schedule = option_schedule()
    arrays = training_arrays(TRAIN_BATCH, 2048, seed=31)

    def tensors(batch: int):
        return tuple(torch.from_numpy(arrays[k][:batch]).to(dev)
                     for k in ("complete", "partial", "label"))

    def step_at(batch: int):
        _, m = option_model(dev, grouper=True)
        tr.make_completion_train_step(m, schedule, fused_gather=True, fused_sa=True)(
            tr.create_train_state(m, seed=1), *tensors(batch))

    Bt = fit_batch("fp grouper train", step_at, TRAIN_BATCH)
    _, model = option_model(dev, grouper=True)
    state = tr.create_train_state(model, seed=1)
    step = tr.make_completion_train_step(model, schedule, fused_gather=True, fused_sa=True)
    batch = tensors(Bt)
    step(state, *batch)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = {}
    t0 = time.perf_counter()
    by_fp_train = fp_launches(model, lambda: got.update(loss=step(state, *batch)[1]))
    ms = (time.perf_counter() - t0) * 1e3
    train_counts = ops.launch_counts()
    print(f"fp grouper train step: B={Bt} fused routes loss={float(got['loss']):.5f} "
          f"step_ms={ms:.1f} launches={train_counts}", flush=True)
    print(f"fp grouper: launches inside each FP module of the train step (forward): "
          f"{by_fp_train}", flush=True)
    if not np.isfinite(float(got["loss"])):
        raise AssertionError("fp grouper: the training loss is not finite")
    if any(c.get("ball_query_group", 0) < 1 for c in by_fp_train.values()):
        raise AssertionError("fp grouper: an FP level did not launch the fused gather")
    return {k: counts[k] + train_counts[k] for k in counts}


def concat_partial(dev, rng):
    """Phase 16d: ``concate_partial_with_noisy_input`` (local and global
    features off) in bf16: one B=4 forward over the 5120-point joined cloud
    against ``plain_ops()``."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.ops import kernels

    B = 4
    _, model = option_model(dev, include_local_feature=False, include_global_feature=False,
                            concate_partial_with_noisy_input=True)
    cond = conditions(rng, B, dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    x = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    ts = torch.full((B,), 5.0, device=dev)
    with torch.no_grad():
        model(x, cond, ts, label)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        y_k = model(x, cond, ts, label).float()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        with kernels.plain_ops():
            y_p = model(x, cond, ts, label).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    finite = bool(torch.isfinite(y_k).all())
    print(f"concat partial: forward B={B} over {2048 + 3072} points ms={ms:.2f} "
          f"out={tuple(y_k.shape)} finite={finite} launches={counts} kernels vs plain "
          f"rel_err={rel:.3g} (tol {DENOISE_REL_TOL})", flush=True)
    if tuple(y_k.shape) != (B, 2048, 3) or not finite or not rel <= DENOISE_REL_TOL:
        raise AssertionError("concat partial: the forward is wrong or disagrees with plain")
    for name in ("fps", "ball_query", "knn"):
        if counts[name] <= 0:
            raise AssertionError(f"concat partial: kernel {name} was not launched")
    return counts


def expected_centres(cfg: dict, name: str) -> int:
    """Centres a recording module queries a forward, per cloud."""
    arch, cond_arch = cfg["architecture"], cfg["condition_net_architecture"]
    kind, level = name.split("/")[0].rsplit("_", 1)
    level = int(level)
    if kind == "sa":
        return int(arch["npoint"][level])
    if kind == "sa_cond":
        return int(cond_arch["npoint"][level])
    if kind == "fp_cond":
        return 3072 if level == 0 else int(cond_arch["npoint"][level - 1])
    # enc_map, dec_map and fp query the x_t cloud's level
    return 2048 if level == 0 else int(arch["npoint"][level - 1])


def neighbor_stats_training(dev, workdir: str):
    """Phase 16e: ``record_neighbor_stats`` for 2 DDPM steps at B =
    TRAIN_BATCH with both fused routes through ``train()``: every module's
    histogram sums to B * centres * steps; one step's histograms through the
    kernels equal those under ``plain_ops()``."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.ops import kernels
    from point_diffusion_refinement_tpu_torch.train.loop import train

    steps = 2
    cfg, _ = option_model(dev, record_neighbor_stats=True)
    cfg["model_name"] = "stats"
    arrays = training_arrays(TRAIN_BATCH * steps, 2048, seed=32)
    ds = ArrayDataset(**arrays)
    ops.reset_launch_counts()
    result = train(option_config(f"{workdir}/stats", TRAIN_BATCH, cfg), dataset_override=ds,
                   fused_gather=True, fused_sa=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    acc = result["neighbor_stats"]
    sums = {k: float(v.sum()) for k, v in sorted(acc.hists.items())}
    want = {k: float(TRAIN_BATCH * expected_centres(cfg, k) * steps) for k in sums}
    print(f"neighbor stats: {steps} steps at B={TRAIN_BATCH} forwards={acc.forwards} "
          f"launches={counts} histogram sums={sums}", flush=True)
    acc.report()
    if acc.forwards != steps or sums != want or not sums:
        raise AssertionError(f"neighbor stats: histogram sums {sums}, expected {want}")

    model = result["model"]
    x0, cond, label = (torch.from_numpy(arrays[k][:TRAIN_BATCH]).to(dev)
                       for k in ("complete", "partial", "label"))
    sched = option_schedule().to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    t = torch.randint(0, sched.T, (TRAIN_BATCH,), generator=gen, device=dev)
    z = torch.randn(x0.shape, generator=gen, device=dev)
    loss_fn = tr.make_completion_loss(model, sched, fused_gather=True, fused_sa=True,
                                      record_stats=True)
    with torch.no_grad():
        _, st_k = loss_fn(x0, cond, label, t, z)
        with kernels.plain_ops():
            _, st_p = loss_fn(x0, cond, label, t, z)
    same = sorted(st_k) == sorted(st_p) and all(torch.equal(st_k[k], st_p[k]) for k in st_k)
    print(f"neighbor stats: one step's {len(st_k)} histograms through the kernels equal "
          f"plain: {same}", flush=True)
    if not same:
        raise AssertionError("neighbor stats: the kernels' counts differ from the plain path's")
    return counts


def option_schedule():
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams

    dc = EXPERIMENTS["ddpm"]()["diffusion_config"]
    return calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])


def option_config(root: str, batch: int, pointnet_config: dict) -> dict:
    """The ``ddpm`` experiment with ``pointnet_config`` in place of its
    network: one epoch, a checkpoint at its end, no in-loop eval."""
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS

    cfg = EXPERIMENTS["ddpm"]()
    cfg["pointnet_config"] = dict(pointnet_config)
    cfg["train_config"].update(root_directory=root, n_epochs=1, epochs_per_ckpt=1,
                               iters_per_logging=1, shuffle_seed=0)
    cfg["mvp_dataset_config"].update(batch_size=batch, num_samples_tested=0)
    return cfg


def model_options(dev, workdir: str, rng) -> dict:
    """Phase 16: every network and model option of the tenth slice, each
    path's launch counts reset before and read after."""
    paths = {}
    paths["pvd_train"], arrays = pvd_training(dev, workdir)
    paths["pointwise_train"] = pointwise_training(dev, workdir, arrays)
    paths["fp_grouper"] = fp_grouper(dev, rng)
    paths["concat_partial"] = concat_partial(dev, rng)
    paths["neighbor_stats_train"] = neighbor_stats_training(dev, workdir)
    return paths


# ---- phase 17: the two-stage demo, data parallelism, metrics, profiling --


def ddp_world1(dev, workdir: str) -> None:
    """Phase 17 (b): two B=32 DDPM steps through ``train(mesh=)`` on an NCCL
    process group of one, against the same steps with no process group, and
    one ``run_generation(mesh=)`` batch; the group is destroyed after."""
    import torch.distributed as dist

    from point_diffusion_refinement_tpu_torch.cli.two_stage_demo import demo_configs
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.parallel import initialize_distributed, make_mesh
    from point_diffusion_refinement_tpu_torch.sample.pipeline import run_generation
    from point_diffusion_refinement_tpu_torch.train.loop import train

    arrays = training_arrays(2 * TRAIN_BATCH, 2048, seed=40)
    ds = ArrayDataset(**{k: arrays[k] for k in ("complete", "partial", "label")})

    def run(tag: str, mesh):
        cfg, _ = demo_configs(f"{workdir}/ddp_{tag}", f"{workdir}/ddp_{tag}/mvp", DEMO_T,
                              TRAIN_BATCH, 2048, 3072)
        cfg["train_config"]["shuffle_seed"] = 0
        t0 = time.perf_counter()
        res = train(cfg, max_steps=2, dataset_override=ds, fused_gather=True, fused_sa=True,
                    mesh=mesh, device=None if mesh is not None else dev)
        torch.cuda.synchronize()
        print(f"ddp {tag}: 2 steps at B={TRAIN_BATCH} in {time.perf_counter() - t0:.1f} s "
              f"losses={res['losses']} step_ms={[round(s * 1e3, 1) for s in res['step_seconds']]}",
              flush=True)
        return cfg, res

    _, plain = run("plain", None)
    initialize_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    try:
        mesh = make_mesh()
        print(f"ddp mesh: rank={mesh.rank} world={mesh.world} shape={mesh.shape} "
              f"device={mesh.device} backend={dist.get_backend()}", flush=True)
        cfg, ddp = run("world1", mesh)
        a = {k: v.detach().double() for k, v in ddp["model"].state_dict().items()}
        b = {k: v.detach().double() for k, v in plain["model"].state_dict().items()}
        num = sum(float((a[k] - b[k]).pow(2).sum()) for k in b) ** 0.5
        den = sum(float(b[k].pow(2).sum()) for k in b) ** 0.5
        worst = max(b, key=lambda k: float((a[k] - b[k]).norm() / (b[k].norm() + 1e-30)))
        loss2 = abs(ddp["losses"][1] - plain["losses"][1]) / abs(plain["losses"][1])
        print(f"ddp world 1 vs no process group: first_loss_equal="
              f"{ddp['losses'][0] == plain['losses'][0]} second_loss_rel={loss2:.3g} "
              f"params_rel_l2_after_2={num / den:.3g} (tol {RESUME_REL_TOL}; worst tensor "
              f"{worst}) ddp_step_ms={[round(s * 1e3, 1) for s in ddp['step_seconds']]} "
              f"plain_step_ms={[round(s * 1e3, 1) for s in plain['step_seconds']]}", flush=True)
        if ddp["losses"][0] != plain["losses"][0] or not (
                num / den <= RESUME_REL_TOL and loss2 <= RESUME_REL_TOL):
            raise AssertionError("ddp: the world-1 DDP steps disagree with the plain steps")
        test = ArrayDataset(**{k: v[:DEMO_BATCH] for k, v in ds.arrays.items()})
        t0 = time.perf_counter()
        (gen,) = run_generation(cfg, state_override=ddp["state"], dataset_override=test,
                                batch_size=DEMO_BATCH, save_generated=False,
                                keep_generated=True, compute_emd=False, mesh=mesh,
                                fast_sampling=True, fast_sampling_config={"length": 10})
        torch.cuda.synchronize()
        ok = gen.generated.shape == (DEMO_BATCH, 2048, 3) and np.isfinite(gen.generated).all()
        print(f"ddp run_generation(mesh=) world 1: FastDPM-10 B={DEMO_BATCH} "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms generated={gen.generated.shape} "
              f"avg_cd={gen.avg_cd:.6g} finite={ok}", flush=True)
        if not ok:
            raise AssertionError("ddp: run_generation(mesh=) output is wrong")
    finally:
        dist.destroy_process_group()


def generation_metrics(art) -> None:
    """Phase 17 (c): MMD / COV / 1-NNA and the occupancy JSD of the demo's
    coarse test clouds against their 2048-point GT, on the card."""
    from point_diffusion_refinement_tpu_torch.metrics import (
        compute_all_metrics,
        jsd_between_point_cloud_sets,
    )

    sample = torch.from_numpy(art["coarse"]).cuda()
    ref = torch.from_numpy(art["coarse_gt"]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = compute_all_metrics(sample, ref)
    all_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    jsd = jsd_between_point_cloud_sets(art["coarse"], art["coarse_gt"])
    jsd_ms = (time.perf_counter() - t0) * 1e3
    print(f"generation metrics: {tuple(sample.shape)} vs {tuple(ref.shape)} "
          f"compute_all_metrics_ms={all_ms:.1f} jsd_ms={jsd_ms:.1f} jsd={jsd:.6g} "
          f"{ {k: round(float(v), 6) for k, v in res.items()} }", flush=True)
    if not (all(np.isfinite(float(v)) for v in res.values()) and np.isfinite(jsd)
            and 0.0 <= res["1-NN-CD-acc"] <= 1.0):
        raise AssertionError("generation metrics: a value is not finite or 1-NNA is out of [0, 1]")


def demo_profile(art, dev, workdir: str) -> None:
    """Phase 17 (d): ``StepTimer`` over demo DDPM steps at the demo's batch,
    then ``trace`` + ``summarize_trace`` over three of them."""
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.train import make_completion_train_step
    from point_diffusion_refinement_tpu_torch.utils.profiling import (
        StepTimer,
        summarize_trace,
        trace,
    )

    model, state = art["ddpm"]["model"], art["ddpm"]["state"]
    step = make_completion_train_step(model, calc_diffusion_hyperparams(DEMO_T, 1e-4, 0.02),
                                      fused_gather=True, fused_sa=True)
    arrays = training_arrays(DEMO_BATCH, 2048, seed=41)
    batch = [torch.from_numpy(arrays[k]).to(dev) for k in ("complete", "partial", "label")]
    timer = StepTimer(warmup=1)
    for _ in range(5):
        with timer:
            step(state, *batch)
    print(f"demo ddpm step B={DEMO_BATCH} (StepTimer, warm-up discarded): "
          f"ms={[round(t * 1e3, 2) for t in timer.times]} mean_ms={timer.mean * 1e3:.2f} "
          f"best_ms={timer.best * 1e3:.2f}", flush=True)
    rows = []
    for window in range(3):
        log_dir = f"{workdir}/demo_trace_{window}"
        with trace(log_dir):
            for _ in range(3):
                step(state, *batch)
        rows = summarize_trace(log_dir, top=10, host_fallback=False)
        if rows:
            break
        print(f"profile: no device record in trace window {window}", flush=True)
    print("demo ddpm steps, 3 under trace(): top device ops (name, total_us, count)", flush=True)
    for name, us, count in rows:
        print(f"  {us:12.1f} us {count:6d}x {name[:110]}", flush=True)
    if not rows:
        raise AssertionError("profile: summarize_trace returned no device row")


def two_stage(dev, workdir: str) -> dict:
    """Phase 17: the two-stage demo at full width (launch counts reset just
    before and read just after), then (b)-(d)."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.cli.two_stage_demo import run_demo

    art = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_demo(steps_ddpm=DEMO_DDPM_STEPS, steps_refine=DEMO_REFINE_STEPS, T=DEMO_T,
                       num_shapes=DEMO_SHAPES, batch_size=DEMO_BATCH, workdir=f"{workdir}/demo",
                       device=dev, num_tested=DEMO_TESTED, trainset_trials=1, in_memory=True,
                       artifacts=art)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    losses = art["ddpm"]["losses"]
    print(f"two-stage demo: wall_s={time.perf_counter() - t0:.1f} stage_seconds="
          f"{summary['stage_seconds']} train={summary['num_train']} test={summary['num_test']}",
          flush=True)
    print(f"two-stage demo: ddpm loss first10={summary['ddpm_loss_first10']:.6f} "
          f"last10={summary['ddpm_loss_last10']:.6f} steps={len(losses)} "
          f"step_ms_median={float(np.median(art['ddpm']['step_seconds'][1:])) * 1e3:.1f}; "
          f"refine loss first={art['refine']['losses'][0]:.6f} "
          f"last={art['refine']['losses'][-1]:.6f}", flush=True)
    print(f"two-stage demo: coarse_cd_t_2048={summary['coarse_cd_t_2048']:.6f} "
          f"refined_cd_t_4096={summary['refined_cd_t_4096']:.6f} "
          f"refined_beats_coarse={summary['refined_beats_coarse']} (reported, not a check)",
          flush=True)
    print(f"two-stage demo launches: { {k: v for k, v in counts.items() if v} }", flush=True)
    # coarse generation runs through run_generation's captured reverse step:
    # the test clouds and one train-set trial, batches of DEMO_BATCH, DEMO_T
    # steps each
    steps = DEMO_T * sum(-(-n // DEMO_BATCH) for n in (summary["num_test"],
                                                       summary["num_train"]))
    coarse_s = summary["stage_seconds"]["coarse_generation"]
    print(f"two-stage demo coarse generation (graphed): seconds={coarse_s} steps={steps} "
          f"ms_a_step={coarse_s / steps * 1e3:.2f} (the demo CLI at the TPU settings, eager: "
          f"847.1 s, ~72 ms a step; PERF.md section 5)", flush=True)
    values = [summary[k] for k in ("coarse_cd_t_2048", "refined_cd_t_4096",
                                   "ddpm_loss_first10", "ddpm_loss_last10")]
    if not (np.isfinite(values).all() and np.isfinite(losses).all()
            and np.isfinite(art["refine"]["losses"]).all()):
        raise AssertionError("two-stage demo: a loss or CD is not finite")
    if not summary["ddpm_loss_last10"] < summary["ddpm_loss_first10"]:
        raise AssertionError("two-stage demo: the DDPM loss did not fall")
    shapes = {"coarse": (art["coarse"].shape, (DEMO_TESTED, 2048, 3)),
              "refined": (art["refined"].shape, (DEMO_TESTED, 4096, 3)),
              "trial": (art["trials"][0].generated.shape, (summary["num_train"], 2048, 3))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise AssertionError(f"two-stage demo: {name} clouds are {got}, not {want}")
    missing = [k for k in DEMO_PATH_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"two-stage demo: kernels {missing} were not launched")

    at_phase = time.perf_counter()
    ddp_world1(dev, workdir)
    print(f"ddp phase: {time.perf_counter() - at_phase:.1f} s", flush=True)
    generation_metrics(art)
    demo_profile(art, dev, workdir)
    return {"two_stage_demo": counts}


# ---- phase 18: the mesh's model axis and the FLOP count -----------------

MODEL_AXIS_RANKS = 2  # on the one card
MODEL_AXIS_PARALLEL = 2  # ranks a model row
MODEL_AXIS_STEPS = 2
MODEL_AXIS_TIMEOUT_S = 600  # all the processes, start to end


def model_axis_config(root: str, batch: int) -> dict:
    """The ``ddpm`` experiment at full width in bf16, ``batch`` rows a
    process, no in-loop eval, a checkpoint an epoch."""
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS

    cfg = EXPERIMENTS["ddpm"]()
    cfg["train_config"].update(root_directory=root, n_epochs=1, epochs_per_ckpt=1,
                               iters_per_logging=1, shuffle_seed=0)
    cfg["mvp_dataset_config"].update(batch_size=batch, num_samples_tested=0)
    return cfg


def model_axis_rank(rank: int, port: int, workdir: str, world: int, backend: str) -> None:
    """Phase 18 (a), one of ``world`` processes: a ``backend`` group (gloo
    on CUDA tensors on the one card; NCCL a card a rank), the
    (world / MODEL_AXIS_PARALLEL, MODEL_AXIS_PARALLEL) mesh,
    MODEL_AXIS_STEPS DDPM steps through ``train(mesh=)`` at TRAIN_BATCH //
    world rows a rank; what it stores, its losses, step seconds and
    launches, and (rank 0) the gathered parameters go to
    ``model_axis_rank_<r>.pt``."""
    import torch.distributed as dist

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.parallel import (
        full_state_dict,
        initialize_distributed,
        make_mesh,
        sharding_of,
    )
    from point_diffusion_refinement_tpu_torch.train.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    initialize_distributed(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    try:
        mesh = make_mesh(model_parallel=MODEL_AXIS_PARALLEL)
        with np.load(os.path.join(workdir, "model_axis_data.npz")) as f:
            ds = ArrayDataset(**{k: f[k] for k in ("complete", "partial", "label")})
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = train(model_axis_config(os.path.join(workdir, "model_axis"),
                                      TRAIN_BATCH // world),
                    max_steps=MODEL_AXIS_STEPS, dataset_override=ds, fused_gather=True,
                    fused_sa=True, mesh=mesh)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        model, state = res["model"], res["state"]
        out = {
            "mesh": (mesh.shape, mesh.model_index, str(mesh.device), dist.get_backend()),
            "losses": res["losses"], "step_seconds": res["step_seconds"], "counts": counts,
            "dims": dict(sharding_of(model).dims),
            "stored": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "bytes": state_bytes(model, state.optimizer),
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
            "output_directory": res["output_directory"],
        }
        full = {k: v.detach().cpu() for k, v in full_state_dict(model).items()}
        if rank == 0:
            out["params"] = full
        torch.save(out, os.path.join(workdir, f"model_axis_rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def state_bytes(model, optimizer) -> int:
    """Bytes of a model's parameters and its optimizer's moments."""
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(v.numel() * v.element_size() for s in optimizer.state.values()
                  for v in s.values() if v.dim() > 0))


def params_rel_l2(a: dict, b: dict) -> float:
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in b) ** 0.5
    den = sum(float(b[k].double().pow(2).sum()) for k in b) ** 0.5
    return num / den


def model_axis_reference(dev, ds, schedule, pc, world: int):
    """Phase 18 (a)'s reference: the same MODEL_AXIS_STEPS steps in this one
    process at TRAIN_BATCH from the same weights, on the rows and draws the
    ``world`` ranks take (each rank's shard of ``ds`` in ``train()``'s
    shuffled order, t and z from a generator seeded rank + 1)."""
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.data import iterate_batches
    from point_diffusion_refinement_tpu_torch.parallel import Mesh, shard_dataset
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    half = TRAIN_BATCH // world
    ranks = []
    for r in range(world):
        shard = shard_dataset(ds, Mesh(r, world, torch.device("cpu")), pad=True)
        batches = iterate_batches(shard, half, shuffle=True, drop_last=True, seed=0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(r + 1)
        ranks.append(([next(batches) for _ in range(MODEL_AXIS_STEPS)], gen))
    model = build_model(pc, device=dev, seed=0)
    state = tr.create_train_state(model, seed=1)
    step = tr.make_completion_train_step(model, schedule, fused_gather=True, fused_sa=True)
    sched = schedule.to(dev)
    losses, step_ms = [], []
    for k in range(MODEL_AXIS_STEPS):
        t, z = [], []
        for _, gen in ranks:  # a rank's step draws t, then z
            t.append(torch.randint(0, sched.T, (half,), generator=gen, device=dev))
            z.append(torch.randn((half, 2048, 3), generator=gen, device=dev))
        batch = {key: torch.from_numpy(np.concatenate(
            [np.asarray(b[k][key]) for b, _ in ranks])).to(dev)
            for key in ("complete", "partial", "label")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch["complete"], batch["partial"], batch["label"].long(),
                           t=torch.cat(t), z=torch.cat(z))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return losses, step_ms, params, state_bytes(model, state.optimizer)


def model_axis(dev, workdir: str) -> dict:
    """Phase 18: (a) the sharded DDPM step on two processes of the one card
    against one process; (b) the FLOP count."""
    counts, ds = sharded_training(dev, workdir, MODEL_AXIS_RANKS, "gloo")
    flop_count(dev, ds)
    return {"model axis": counts}


def model_axis_network():
    """Phase 18's network config and DDPM schedule (the ``ddpm`` experiment)."""
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams

    cfg = model_axis_config("", TRAIN_BATCH)
    dc = cfg["diffusion_config"]
    return cfg["pointnet_config"], calc_diffusion_hyperparams(dc["T"], dc["beta_0"],
                                                              dc["beta_T"])


def sharded_training(dev, workdir: str, world: int, backend: str):
    """Phase 18 (a): MODEL_AXIS_STEPS DDPM steps through ``train(mesh=)``
    in ``world`` processes on a (world / 2, 2) mesh against the same steps
    in this process.  Returns the ranks' summed launch counts and the
    dataset."""
    import gc

    import torch.multiprocessing as mp

    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.data import ArrayDataset
    from point_diffusion_refinement_tpu_torch.parallel import Mesh, param_sharding_rule
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    pc, schedule = model_axis_network()
    arrays = training_arrays(2 * TRAIN_BATCH, 2048, seed=50)
    ds = ArrayDataset(**{k: arrays[k] for k in ("complete", "partial", "label")})
    np.savez(os.path.join(workdir, "model_axis_data.npz"), **ds.arrays)
    ref_losses, ref_ms, ref_params, ref_bytes = model_axis_reference(dev, ds, schedule, pc,
                                                                     world)
    print(f"model axis one process: {MODEL_AXIS_STEPS} steps at B={TRAIN_BATCH} "
          f"losses={ref_losses} step_ms={[round(v, 1) for v in ref_ms]} "
          f"param_and_moment_bytes={ref_bytes}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks take the card's memory now

    t0 = time.perf_counter()
    procs = mp.start_processes(model_axis_rank, args=(free_port(), workdir, world, backend),
                               nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MODEL_AXIS_TIMEOUT_S
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise AssertionError("model axis: the processes did not finish in time")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"model_axis_rank_{r}.pt"), weights_only=False)
             for r in range(world)]

    rule = param_sharding_rule(Mesh(0, world, dev, MODEL_AXIS_PARALLEL))
    want = {n: rule(n, tuple(v.shape)) for n, v in ref_params.items()}
    want = {n: d for n, d in want.items() if d is not None}
    sharded_params = sum(ref_params[n].numel() for n in want)
    total_params = sum(v.numel() for v in ref_params.values())
    print(f"model axis: {world} processes (wall {wall:.1f} s with start-up) mesh="
          f"{[r['mesh'] for r in ranks]}; rule shards {len(want)} of {len(ref_params)} "
          f"tensors, {sharded_params} of {total_params} parameters "
          f"({sharded_params / total_params:.3f})", flush=True)
    for r, res in enumerate(ranks):
        shapes_ok = all(
            res["stored"][n] == tuple(s // MODEL_AXIS_PARALLEL if i == want.get(n) else s
                                      for i, s in enumerate(v.shape))
            for n, v in ref_params.items())
        kernels_ok = all(res["counts"][k] > 0 for k in TRAIN_PATH_KERNELS)
        print(f"model axis rank {r}: sharded={len(res['dims'])} shapes_ok={shapes_ok} "
              f"losses={res['losses']} step_ms="
              f"{[round(s * 1e3, 1) for s in res['step_seconds']]} "
              f"param_and_moment_bytes={res['bytes']} "
              f"bytes_vs_one_process={res['bytes'] / ref_bytes:.4f} "
              f"peak_memory_GiB={res['peak_GiB']:.2f} launches="
              f"{ {k: v for k, v in res['counts'].items() if v} }", flush=True)
        if res["dims"] != want or not shapes_ok:
            raise AssertionError(f"model axis rank {r}: the stored tensors are not the rule's")
        if not kernels_ok:
            raise AssertionError(f"model axis rank {r}: a kernel of the training path was "
                                 "not launched")
    losses = ranks[0]["losses"]
    loss1 = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    loss2 = abs(losses[1] - ref_losses[1]) / abs(ref_losses[1])
    rel = params_rel_l2(ranks[0]["params"], ref_params)
    print(f"model axis vs one process: first_loss_rel={loss1:.3g} (tol "
          f"{TRAIN_PLAIN_LOSS_REL_TOL}) second_loss_rel={loss2:.3g} params_rel_l2_after_"
          f"{MODEL_AXIS_STEPS}={rel:.3g} (tol {RESUME_REL_TOL}); losses equal on the ranks: "
          f"{all(r['losses'] == losses for r in ranks)}", flush=True)
    if not (loss1 <= TRAIN_PLAIN_LOSS_REL_TOL and loss2 <= RESUME_REL_TOL
            and rel <= RESUME_REL_TOL and all(r["losses"] == losses for r in ranks)):
        raise AssertionError("model axis: the sharded steps disagree with one process")

    model = build_model(pc, device=dev, seed=5)
    state = tr.create_train_state(model)
    tr.load_checkpoint(ranks[0]["output_directory"], MODEL_AXIS_STEPS, state)
    equal = all(torch.equal(v.cpu(), ranks[0]["params"][k])
                for k, v in model.state_dict().items())
    print(f"model axis checkpoint: pointnet_ckpt_{MODEL_AXIS_STEPS} loads in one process, "
          f"equal to the gathered parameters: {equal}", flush=True)
    if not equal:
        raise AssertionError("model axis: the checkpoint does not hold the gathered state")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    return counts, ds


def flop_count(dev, ds) -> None:
    """Phase 18 (b): ``dot_flops`` of one B=4 denoise step with the
    variants off and with ``fused_attention`` on (``model + pallas`` must be
    the same), and of one B=TRAIN_BATCH DDPM training step with the fused
    routes; model GFLOP and MFU against each step's host-clock time."""
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.train.loop import build_model
    from point_diffusion_refinement_tpu_torch.utils.flops import H100_BF16_PEAK_FLOPS, dot_flops

    pc, schedule = model_axis_network()

    def host_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    model = build_model(pc, device=dev, seed=0)
    rng = np.random.default_rng(18)
    B = 4
    cond = conditions(rng, B, dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    x = torch.from_numpy(rng.standard_normal((B, 2048, 3)).astype(np.float32)).to(dev)
    ts = torch.full((B,), 500.0, device=dev)
    with torch.no_grad():
        cf = model.encode_condition(cond)
        steps = {name: (lambda r=routes: model.denoise(x, ts, label, cf, fused=True, **r))
                 for name, routes in (("off", {}), ("fused_attention", {"fused_attention": True}))}
        counted = {name: dot_flops(fn) for name, fn in steps.items()}
        ms = {name: host_ms(fn, 10) for name, fn in steps.items()}
    off, on = counted["off"], counted["fused_attention"]
    for name, c in counted.items():
        print(f"flops denoise step B={B} {name}: model_gflops={c['model'] / 1e9:.4f} "
              f"pallas_gflops={c['pallas'] / 1e9:.4f} gather={c['gather']} "
              f"step_ms={ms[name]:.2f} mfu={(c['model'] + c['pallas']) / (ms[name] * 1e-3 * H100_BF16_PEAK_FLOPS):.6f}",
              flush=True)
    if not (on["pallas"] > 0 and on["model"] + on["pallas"] == off["model"]):
        raise AssertionError("flops: model + pallas with fused_attention differs from model "
                             "without it")
    del cf, steps

    state = tr.create_train_state(model, seed=1)
    step = tr.make_completion_train_step(model, schedule, fused_gather=True, fused_sa=True)
    x0, c, lab = (torch.from_numpy(ds.arrays[k][:TRAIN_BATCH]).to(dev)
                  for k in ("complete", "partial", "label"))
    lab = lab.long()
    train_flops = dot_flops(step, state, x0, c, lab)
    train_ms = host_ms(lambda: step(state, x0, c, lab), 2)
    print(f"flops ddpm train step B={TRAIN_BATCH} (fused routes): model_gflops="
          f"{train_flops['model'] / 1e9:.4f} pallas_gflops={train_flops['pallas'] / 1e9:.4f} "
          f"step_ms={train_ms:.1f} mfu="
          f"{train_flops['model'] / (train_ms * 1e-3 * H100_BF16_PEAK_FLOPS):.6f} "
          f"(peak {H100_BF16_PEAK_FLOPS:.3g} FLOP/s bf16 dense)", flush=True)
    if not train_flops["model"] > 0:
        raise AssertionError("flops: the training step counted no product")


def model_axis_across_cards(cards: int) -> int:
    """``--model-axis-cards N``: phase 18 (a) alone on N cards, NCCL, a card
    a rank, a (N / 2, 2) mesh, against one process on card 0; then the
    compiled (N, 1) and (N / 2, 2) mesh steps of phase 21 against the eager
    mesh steps and one process (``mesh_steps_across_cards``)."""
    from point_diffusion_refinement_tpu_torch.ops import kernels

    if torch.cuda.device_count() < cards or cards % MODEL_AXIS_PARALLEL:
        print(f"chip_smoke: {cards} cards asked, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    print(f"build: {kernels.build()}", flush=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        counts, _ = sharded_training(torch.device("cuda", 0), workdir, cards, "nccl")
        print(f"model axis across {cards} cards: {time.perf_counter() - t0:.1f} s, "
              f"launches={ {k: v for k, v in counts.items() if v} }", flush=True)
        t0 = time.perf_counter()
        counts = mesh_steps_across_cards(torch.device("cuda", 0), workdir, cards)
        print(f"compiled mesh steps across {cards} cards: {time.perf_counter() - t0:.1f} s, "
              f"launches={ {m: {k: v for k, v in c.items() if v} for m, c in counts.items()} }",
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip())
    return 0


# ---- phase 19: compiled generation (captured CUDA graphs) -----------------
GRAPH_SEGMENT = 4  # STEPS = 10 reverse steps in segments of 4, 4 and 2
GRAPH_SLICES = (7, 2)  # the t-slices recorded in (a) and (b)
GRAPH_REPS = 2  # timed calls of each kind, in turns (eager, graphed, graphed, eager)


def graph_diff(what: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    """Max and mean |got - ref|, relative to the largest and the mean |ref|,
    against the JAX package's variants bound (0 is expected: a replay runs
    the eager run's kernels on the same inputs)."""
    d = (got.float() - ref.float()).abs()
    rel_max = float(d.max()) / max(float(ref.float().abs().max()), 1e-30)
    rel_mean = float(d.mean()) / max(float(ref.float().abs().mean()), 1e-30)
    print(f"{what} graphed vs eager: max={float(d.max()):.3g} mean={float(d.mean()):.3g} "
          f"rel_max={rel_max:.3g} (tol {VARIANT_MAX_TOL}) rel_mean={rel_mean:.3g} "
          f"(tol {VARIANT_MEAN_TOL})", flush=True)
    if not (rel_max <= VARIANT_MAX_TOL and rel_mean <= VARIANT_MEAN_TOL):
        raise AssertionError(f"{what}: the graphed run disagrees with the eager run")


def same_launches(what: str, graphed: dict, eager: dict, path) -> None:
    """The graphed run's launch counts equal the eager run's, and every
    kernel of ``path`` was launched."""
    print(f"{what} launches: graphed={ {k: v for k, v in graphed.items() if v} } "
          f"equal to eager: {graphed == eager}", flush=True)
    if graphed != eager:
        raise AssertionError(f"{what}: launch counts differ from the eager run's {eager}")
    missing = [k for k in path if graphed[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} were not launched")


def graph_stats(what: str, graphs) -> None:
    for st in graphs.stats():
        print(f"{what} graph: capture_ms={st['capture_ms']:.1f} "
              f"pool_bytes={st['pool_bytes']} launches_a_replay={st['launches']}", flush=True)


def timed_turns(calls: dict, reps: int = GRAPH_REPS) -> dict:
    """{name: [host ms of each call]} over ``calls`` (name -> fn), each call
    ending in a synchronise, in turns: the order, then reversed, ``reps``
    rounds in all."""
    out = {name: [] for name in calls}
    order = list(calls)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def device_busy(what: str, fn, grad: bool = False, with_ms: bool = False):
    """The device-busy share of one call of ``fn``: the profiler's device
    time (CUDA activity alone, which is cheap to collect) over the host
    clock around the synchronised call; ``grad`` keeps autograd on, for
    training steps.  ``with_ms``: (share, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.set_grad_enabled(grad), profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the profiler's raw device records: parsing a window of two B=32 PVD
    # steps into events took 0.96-1.15 s, summing its raw records 0.05-0.08
    # s, to the same device time (tools/time_ordered_scatter.py, NVIDIA H100
    # 80GB HBM3)
    events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    dev_ms = sum(us for _, us in events) / 1e3
    # the ordered scatter-add's kernels in the window (its share of a step)
    ordered = [us for name, us in events
               if any(k in name for k in PROFILED_KERNELS["group_scatter_ordered"])]
    share = (f" scatter_ordered_device_ms={sum(ordered) / 1e3:.4f} ({len(ordered)} kernels)"
             if ordered else "")
    print(f"profile: {what}, wall_ms={wall_ms:.2f} (profiled) device_ms={dev_ms:.2f} "
          f"device_busy={dev_ms / wall_ms:.3f}{share}", flush=True)
    return (dev_ms / wall_ms, dev_ms) if with_ms else dev_ms / wall_ms


def graphed_ancestral(model, cond, label, dev, tag: str, **routes) -> dict:
    """Phase 19 (a)/(b) and (c): STEPS ancestral steps through
    ``make_coarse_sampler(segment_size=GRAPH_SEGMENT)`` with t-slices, then
    eagerly from the same generator seed: x0, every slice and every launch
    count must agree.  Then steady-state step ms of both, a device-busy
    window of each, and the capture's ms and pool bytes.  Returns the
    graphed run's launch counts."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams, ddpm
    from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler

    schedule = calc_diffusion_hyperparams(STEPS, 1e-4, 0.02)
    kinds = {
        "eager": make_coarse_sampler(model, schedule, 2048, t_slices=GRAPH_SLICES, **routes),
        "graphed": make_coarse_sampler(model, schedule, 2048, t_slices=GRAPH_SLICES,
                                       segment_size=GRAPH_SEGMENT, **routes),
    }
    gen = torch.Generator(device=dev)
    runs = {}
    for name in ("graphed", "eager"):
        gen.manual_seed(19)
        ops.reset_launch_counts()
        x0, slices = kinds[name](cond, label, generator=gen)
        torch.cuda.synchronize()
        runs[name] = (x0, slices, ops.launch_counts())
    (gx, gs, gc), (ex, es, ec) = runs["graphed"], runs["eager"]
    if tuple(gx.shape) != (cond.shape[0], 2048, 3) or not bool(torch.isfinite(gx).all()):
        raise AssertionError(f"{tag}: the graphed x0 is not a finite (B, 2048, 3) cloud")
    graph_diff(f"{tag} x0", gx, ex)
    for t in GRAPH_SLICES:
        graph_diff(f"{tag} slice t={t}", gs[t], es[t])
    same_launches(tag, gc, ec, COARSE_PATH_KERNELS
                  + (VARIANT_PATH_KERNELS if routes.get("fused_attention") else ()))
    graph_stats(tag, kinds["graphed"].graphs)

    # STEPS reverse steps alone, eager and replayed: host ms around
    # synchronised work, then the device-busy share of a window of each
    ts, coefs = ddpm.reverse_inputs(schedule, STEPS - 1, cond.shape[0], dev)
    with torch.no_grad():
        cf = model.encode_condition(cond)
    x = torch.randn(cond.shape[0], 2048, 3, generator=gen, device=dev)
    z = torch.randn(x.shape, generator=gen, device=dev)
    graph = kinds["graphed"].graphs

    def denoise(x_, ts_):
        return model.denoise(x_, ts_, label, cf, fused=True, **routes)

    steps = {"eager": lambda: [ddpm.reverse_step(denoise, x, ts[i], coefs[i], z)
                               for i in range(STEPS)],
             "graphed": lambda: [graph(x, ts[i], coefs[i], z, (label, cf))
                                 for i in range(STEPS)]}
    with torch.no_grad():
        times = timed_turns(steps)
    print(f"{tag} step ms (host clock, {STEPS} steps a call): " + "; ".join(
        f"{name} mean={np.mean(v) / STEPS:.2f} min={min(v) / STEPS:.2f}"
        for name, v in times.items()), flush=True)
    for name, fn in steps.items():
        device_busy(f"{tag} {name}, {STEPS} reverse steps", fn)
    if graph.num_graphs != 1:
        raise AssertionError(f"{tag}: {graph.num_graphs} graphs of one step shape")
    graph.release()
    return gc


def compiled_generation(model, cond, label, dev, rng) -> dict:
    """Phase 19: the JAX package's compiled generation as captured CUDA
    graphs, against eager generation, on the main path's model and B=4
    condition: (a) ancestral, (b) with the variants on, (c) their step ms,
    (d) FastDPM-50, (e) the x8 refine forward at B=32.  Every graph is
    released before the next part."""
    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.diffusion import (
        calc_diffusion_hyperparams,
        make_fast_sampling_plan,
    )
    from point_diffusion_refinement_tpu_torch.models.upsample import point_upsample
    from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler
    from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction

    t0 = time.perf_counter()

    def took(part: str) -> None:
        print(f"phase 19 {part}: {time.perf_counter() - t0:.1f} s", flush=True)

    counts = {"graphed_ancestral": graphed_ancestral(model, cond, label, dev, "ancestral")}
    took("(a)")
    counts["graphed_ancestral_variants"] = graphed_ancestral(
        model, cond, label, dev, "ancestral variants", fused_attention=True, fused_knn=True)
    took("(b)")
    torch.cuda.empty_cache()

    # (d) FastDPM-50 at B=4
    dc = EXPERIMENTS["refine_fast50"]()["diffusion_config"]
    T, b0, bT = int(dc["T"]), float(dc["beta_0"]), float(dc["beta_T"])
    schedule = calc_diffusion_hyperparams(T, b0, bT)
    plan = make_fast_sampling_plan(schedule, T, b0, bT, length=FAST_STEPS,
                                   sampling_method="var", noise_schedule="quadratic",
                                   kappa=0.5)
    kinds = {"eager": make_coarse_sampler(model, schedule, 2048, fast_plan=plan),
             "graphed": make_coarse_sampler(model, schedule, 2048, fast_plan=plan,
                                            segment_size=plan.S)}
    gen = torch.Generator(device=dev)
    runs = {}
    for name in ("graphed", "eager"):
        gen.manual_seed(20)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = kinds[name](cond, label, generator=gen)
        torch.cuda.synchronize()
        runs[name] = (out, ops.launch_counts(), (time.perf_counter() - t1) * 1e3)
    graph_diff("fastdpm50", runs["graphed"][0], runs["eager"][0])
    same_launches("fastdpm50", runs["graphed"][1], runs["eager"][1], COARSE_PATH_KERNELS)
    counts["graphed_fastdpm50"] = runs["graphed"][1]
    graph_stats("fastdpm50", kinds["graphed"].graphs)
    # the eager run above is steady (the model ran eagerly before); the
    # graphed one held the warm-up and the capture, so time two more
    times = timed_turns({"graphed": lambda: kinds["graphed"](cond, label, generator=gen)})
    print(f"fastdpm50 B=4 ms a batch (host clock): eager {runs['eager'][2]:.1f}; graphed "
          f"mean={np.mean(times['graphed']):.1f} min={min(times['graphed']):.1f} (first call, "
          f"with its warm-up and capture: {runs['graphed'][2]:.1f})", flush=True)
    kinds["graphed"].graphs.release()
    del kinds, runs
    torch.cuda.empty_cache()
    took("(d)")

    # (e) the x8 refine forward at B=32
    B = 32
    rmodel, refine, osf = upsample_refiner(seed=2)
    graphed = CapturedFunction(refine)
    coarse = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, 2048, 3)).astype(np.float32)).to(dev)
    rcond = conditions(rng, B, dev)
    rlabel = torch.from_numpy(rng.integers(0, 16, (B,))).to(dev)
    # the refined cloud with a zero displacement: what the network adds is
    # the difference from it
    pc = EXPERIMENTS["upsample_16384"]()["pointnet_config"]
    factor = int(pc["point_upsample_factor"])
    centre = bool(pc["include_displacement_center_to_final_output"])
    zero = torch.zeros(B, 2048, 3 * (factor if centre else factor + 1), device=dev)
    base, _ = point_upsample(coarse, zero, factor, centre, osf)
    ops.reset_launch_counts()
    eager_out = refine(coarse, rcond, rlabel, osf)
    torch.cuda.synchronize()
    eager_counts = ops.launch_counts()
    graphed(coarse, rcond, rlabel, osf)  # warm-up
    ops.reset_launch_counts()
    graphed_out = graphed(coarse, rcond, rlabel, osf)  # capture and replay
    torch.cuda.synchronize()
    counts["graphed_refine"] = ops.launch_counts()
    rel = float((graphed_out - eager_out).norm() / (eager_out - base).norm())
    print(f"refine x8 B=32 graphed vs eager: displacement rel_err={rel:.3g} "
          f"(tol {REFINE_REL_TOL}) out={tuple(graphed_out.shape)}", flush=True)
    if not rel <= REFINE_REL_TOL:
        raise AssertionError("refine x8: the graphed forward disagrees with the eager one")
    same_launches("refine x8", counts["graphed_refine"], eager_counts,
                  ("fps", "ball_query", "knn"))
    graph_stats("refine x8", graphed)
    calls = {"eager": lambda: refine(coarse, rcond, rlabel, osf),
             "graphed": lambda: graphed(coarse, rcond, rlabel, osf)}
    times = timed_turns(calls, reps=4)
    print(f"refine x8 B={B} ms a batch (host clock): " + "; ".join(
        f"{name} mean={np.mean(v):.2f} min={min(v):.2f}" for name, v in times.items()),
        flush=True)
    graphed.release()
    del graphed, rmodel, refine
    torch.cuda.empty_cache()
    took("(e)")
    return counts


# ---- phase 20: compiled training (captured CUDA graphs) -------------------
COMPILED_STEPS = 10  # steps of each kind from one state
# steps of each device-busy window of phases 20 and 21
BUSY_STEPS = 3
# ... of phase 22 (b) and of the scatter-cost turns: one, as parsing a
# window's trace into events (some 15k kernels a training step) took ~6 s
# a window of three steps on the card (device_busy now sums the raw records)
SHORT_BUSY_STEPS = 1
# the losses of COMPILED_STEPS compiled steps against COMPILED_STEPS eager
# ones from the same state, relative; and the loss a planted fault must
# move (the planted faults' first losses read 1.6e-3 or more off).  Every
# backward of a gather sums in a fixed order (``ops/scatter.py``), so the
# runs are also held bit-equal, two eager and two compiled; until PR 16
# the B=32 DDPM step (fused routes) took one of two trajectories run to
# run, 6.61e-4 apart from the fifth step (kernel B's float32 atomics,
# amplified by Adam; NVIDIA H100 80GB HBM3)
LOSS_TRAJ_RTOL = 1e-4


def snapshot_state(state):
    """Copies of what a step changes: the parameters and the optimizer's
    state."""
    import copy

    return ([p.detach().clone() for p in state.model.parameters()],
            copy.deepcopy(state.optimizer.state_dict()))


def restore_state(state, snap) -> None:
    """``snap`` copied back into the tensors the state holds, which a
    captured step reads where they are."""
    import copy

    from point_diffusion_refinement_tpu_torch.utils.weights import load_optimizer_state

    params, osd = snap
    with torch.no_grad():
        for p, v in zip(state.model.parameters(), params):
            p.copy_(v)
    load_optimizer_state(state.optimizer, copy.deepcopy(osd))


def adam_check(state, before, step_shift: int = 0):
    """One step of the state's Adam run eagerly from ``before``
    (``snapshot_state``; its step counts shifted by ``step_shift``, a
    planted fault) on copies of the parameters, with the gradients the step
    left in ``.grad`` (a replay's: the graph's pool), against the state's
    parameters and moments now.  Returns whether they are bit-equal, and
    whether every step count advanced by exactly one.  (On the H100
    PyTorch's fused Adam departs from Adam's float64 formula by more than
    the float32 rounding of its sums, eager or replayed alike, so the
    reference is its own eager step.)"""
    import copy
    import warnings

    params, osd = before
    osd = copy.deepcopy(osd)
    for st in osd["state"].values():
        st["step"] = st["step"] + step_shift
    live = list(state.model.parameters())
    copies = [p0.clone() for p0 in params]
    for c, p in zip(copies, live):
        c.grad = p.grad.detach().clone()
    opt = type(state.optimizer)(copies, **state.optimizer.defaults)
    opt.load_state_dict(copy.deepcopy(osd))  # the step updates what it loads
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt.step()
    equal, advanced = True, True
    for i, (p, c) in enumerate(zip(live, copies)):
        s1, sc = state.optimizer.state[p], opt.state[c]
        equal &= torch.equal(p, c) and all(torch.equal(s1[k], sc[k])
                                           for k in ("exp_avg", "exp_avg_sq"))
        advanced &= float(s1["step"]) == float(osd["state"][i]["step"]) + 1
    return equal, advanced


def end_state(state) -> list:
    """Copies of the parameters, Adam's moments and step counts, in the
    model's parameter order."""
    out = []
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        out += [p.detach().clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                torch.as_tensor(st["step"]).clone()]
    return out


def runs_equal(runs: dict) -> dict:
    """Per run, against the first: whether every loss, and the parameters,
    moments and step counts at the end (``end``) are bit-equal."""
    ref = next(iter(runs.values()))
    return {k: r["losses"] == ref["losses"] and all(
        torch.equal(a, b) for a, b in zip(r["end"], ref["end"])) for k, r in runs.items()}


def stepwise_equal(state, start, step, loss_fn, inputs) -> list:
    """From ``start`` (restored in place), COMPILED_STEPS calls of ``step``
    (args -> (state, loss)), untimed: whether each one's loss equals, bit
    for bit, ``loss_fn``'s eager forward (no autograd) of the state and
    inputs that step starts from."""
    restore_state(state, start)
    equal = []
    for i in range(COMPILED_STEPS):
        with torch.no_grad():
            ref = loss_fn(*inputs(i))
        equal.append(bool(torch.equal(step(inputs(i))[1], ref)))
    torch.cuda.synchronize()
    return equal


def worst_grad_err(got: dict, ref: dict):
    """The largest |got - ref| over the gradient tensors relative to the
    largest |ref| of the tree (the error of a float32 sum taken in another
    order grows with its terms, not with its value, and a tensor whose
    gradient is a cancelling sum, such as a bias before a GroupNorm, is
    rounding noise on both sides), and its tensor."""
    top = max(float(b.abs().max()) for b in ref.values())
    worst, name = 0.0, ""
    for k, b in ref.items():
        err = float((got[k] - b).abs().max()) / top
        if err > worst:
            worst, name = err, k
    return worst, name


def compiled_vs_eager(tag: str, state, make_step, loss_fn, inputs, faults, path,
                      lr: float):
    """Phase 20 for one step: ``make_step(compiled=)``'s eager and compiled
    steps from one state (taken after an eager step, so the moments exist)
    and the same inputs (``inputs(i)`` -> the step's arguments after the
    state, draws included).  Readings: the first step's loss and gradients
    twice each way (the first replay follows the capture; the second
    replays the same graph), against each other and against planted faults
    (``faults``: name -> arguments, each a wrong step run eagerly); Adam's
    update on each step's own gradients (``adam_check``) at the first, the
    second and the last replay, and at eager steps alike; COMPILED_STEPS
    steps each way with the host clock around every step (ending in
    ``float(loss)``, as ``train()`` ends a step), their losses, launch
    counts, parameters and peak memory; COMPILED_STEPS replays more, each
    loss against ``loss_fn``'s eager forward of the state the replay starts
    from (``stepwise_equal``); a device-busy window of each kind; the
    graph's capture ms and pool bytes.  The COMPILED_STEPS steps run twice
    each way: every loss, and the parameters, Adam moments and step counts
    after them, bit-equal across the four runs, and the compiled losses
    within LOSS_TRAJ_RTOL of the eager ones.  Returns the compiled run's
    launch counts, the failed checks and a summary for phase 22's table."""
    import gc

    from point_diffusion_refinement_tpu_torch import ops

    model = state.model
    steps = {"eager": make_step(compiled=False), "compiled": make_step(compiled=True)}
    call = lambda kind, args: steps[kind](state, *args)  # noqa: E731
    call("eager", inputs(COMPILED_STEPS))
    torch.cuda.synchronize()
    start = snapshot_state(state)
    adam = {}

    def first_step(kind, args, name):
        restore_state(state, start)
        loss = call(kind, args)[1]
        torch.cuda.synchronize()
        adam[name] = adam_check(state, start)
        if name == "replay 1":  # a planted fault: the bias correction one step off
            adam["planted fault (step count + 1) at replay 1"] = adam_check(
                state, start, step_shift=1)
        return loss.clone(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def run(kind, name):
        restore_state(state, start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms, losses = [], []
        for i in range(COMPILED_STEPS):
            if i == COMPILED_STEPS - 1:
                before = snapshot_state(state)
            t0 = time.perf_counter()
            losses.append(float(call(kind, inputs(i))[1]))
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out = dict(ms=ms, losses=losses, counts=ops.launch_counts(),
                   params=[p.detach().clone() for p in model.parameters()],
                   end=end_state(state), peak=torch.cuda.max_memory_allocated(),
                   reserved=torch.cuda.max_memory_reserved())
        adam[f"{name} step {COMPILED_STEPS}"] = adam_check(state, before)
        return out

    first = {"eager 1": first_step("eager", inputs(0), "eager 1"),
             "eager 2": first_step("eager", inputs(0), "eager 2")}
    planted = {name: first_step("eager", args(), f"fault {name}")
               for name, args in faults.items()}
    runs = {"eager": run("eager", "eager"), "eager 2": run("eager", "eager 2")}
    restore_state(state, start)
    busy = {"eager": device_busy(f"{tag} eager, {BUSY_STEPS} steps",
                                 lambda: [call("eager", inputs(i)) for i in range(BUSY_STEPS)],
                                 grad=True, with_ms=True)}
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    restore_state(state, start)
    call("compiled", inputs(0))  # the warm-up: an eager step on a side stream
    torch.cuda.synchronize()
    first["replay 1"] = first_step("compiled", inputs(0), "replay 1")  # the capture, a replay
    first["replay 2"] = first_step("compiled", inputs(0), "replay 2")
    graphs = steps["compiled"].graphs
    runs["compiled"] = run("compiled", "compiled")
    runs["compiled 2"] = run("compiled", "compiled 2")
    stepwise = stepwise_equal(state, start, lambda args: call("compiled", args), loss_fn,
                              inputs)
    restore_state(state, start)
    busy["compiled"] = device_busy(
        f"{tag} compiled, {BUSY_STEPS} steps",
        lambda: [call("compiled", inputs(i)) for i in range(BUSY_STEPS)], grad=True,
        with_ms=True)

    loss_e, g_e = first["eager 1"]

    def reading(got, ref):
        (loss, g), (loss_r, g_r) = got, ref
        return dict(largest=worst_grad_err(g, g_r)[0], at=worst_grad_err(g, g_r)[1],
                    norm=grad_difference(g, g_r)[0],
                    loss_rel=abs(float(loss) - float(loss_r)) / abs(float(loss_r)),
                    equal=all(torch.equal(g[k], g_r[k]) for k in g_r))

    readings = {f"{k} vs {r}": reading(first[k], first[r]) for k, r in (
        ("eager 2", "eager 1"), ("replay 1", "eager 1"), ("replay 2", "eager 1"),
        ("replay 2", "replay 1"))}
    faulted = {k: reading(v, first["eager 1"]) for k, v in planted.items()}
    for k, r in {**readings, **{f"planted fault ({k}) vs eager 1": r
                                for k, r in faulted.items()}}.items():
        print(f"{tag} first step, {k}: loss_rel={r['loss_rel']:.3g} grads_equal={r['equal']} "
              f"err_of_largest={r['largest']:.3g} at {r['at'] or '-'} "
              f"err_of_norm={r['norm']:.3g}", flush=True)
    sound = ("replay 1", "replay 2")
    worst_sound = max(max(readings[f"{k} vs eager 1"]["largest"],
                          readings[f"{k} vs eager 1"]["norm"]) for k in sound)
    least_fault = min(min(r["largest"], r["norm"]) for r in faulted.values())
    least_fault_loss = min(r["loss_rel"] for r in faulted.values())
    print(f"{tag} gradient bound {GRAPH_GRAD_REL_TOL}: worst sound reading {worst_sound:.3g}, "
          f"least planted fault {least_fault:.3g}; loss bound {LOSS_TRAJ_RTOL}: least planted "
          f"fault {least_fault_loss:.3g}", flush=True)
    print(f"{tag} Adam on the step's own gradients against an eager step of the same Adam "
          f"(bit-equal; step counts advanced by one): " + "; ".join(
              f"{k} {'equal' if eq else 'UNEQUAL'} {'advanced' if ok else 'NOT ADVANCED'}"
              for k, (eq, ok) in adam.items()), flush=True)
    traj = max(abs(a - b) / abs(b) for a, b in
               zip(runs["compiled"]["losses"], runs["eager"]["losses"]))
    moved = max(float((a - b).abs().max())
                for a, b in zip(runs["compiled"]["params"], runs["eager"]["params"]))
    repeats = runs_equal(runs)
    print(f"{tag} {COMPILED_STEPS} steps: losses_max_rel={traj:.3g} (tol {LOSS_TRAJ_RTOL}) "
          f"params_max_diff={moved:.3g} (tol {2 * lr * COMPILED_STEPS:.3g}); losses, parameters, "
          f"moments and step counts at the end bit-equal to eager's: {repeats}; each replayed "
          f"loss equal to an eager forward of its state: {stepwise}; losses: " + "; ".join(
              f"{k} {[float(f'{v:.9g}') for v in r['losses']]}" for k, r in runs.items()),
          flush=True)
    same_launches(tag, runs["compiled"]["counts"], runs["eager"]["counts"], path)
    graph_stats(tag, graphs)
    print(f"{tag} host ms a step over {COMPILED_STEPS} steps: " + "; ".join(
        f"{k} mean={np.mean(r['ms']):.2f} median={np.median(r['ms']):.2f} "
        f"min={min(r['ms']):.2f} peak_allocated_GiB={r['peak'] / 2 ** 30:.2f} "
        f"peak_reserved_GiB={r['reserved'] / 2 ** 30:.2f}"
        for k, r in runs.items()) + " (a replay allocates nothing: the graph's pool, "
        "reserved at capture, holds its tensors)", flush=True)

    checks = {
        "one graph of one step signature": graphs.num_graphs == 1,
        "the replayed first losses equal the eager one": all(
            torch.equal(first[k][0], loss_e) for k in sound),
        f"the replayed gradients within {GRAPH_GRAD_REL_TOL} of the eager ones":
            worst_sound <= GRAPH_GRAD_REL_TOL,
        "the first step's gradients bit-equal, eager against eager and replayed against "
        "eager": all(r["equal"] for r in readings.values()),
        f"the compiled losses within {LOSS_TRAJ_RTOL} of the eager ones over {COMPILED_STEPS} "
        f"steps": traj <= LOSS_TRAJ_RTOL,
        "two eager and two compiled runs bit-equal (losses; parameters, moments and step "
        "counts at the end)": all(repeats.values()),
        f"every planted fault's gradients beyond {GRAPH_GRAD_REL_TOL}":
            least_fault > GRAPH_GRAD_REL_TOL,
        f"every planted fault's loss beyond {LOSS_TRAJ_RTOL}": least_fault_loss > LOSS_TRAJ_RTOL,
        "Adam's update on every step's own gradients, and the step counts": all(
            eq and ok for k, (eq, ok) in adam.items() if not k.startswith("planted")),
        "the planted Adam fault seen": not any(
            eq for k, (eq, _) in adam.items() if k.startswith("planted")),
        f"each of {COMPILED_STEPS} replayed losses equal to an eager forward of its state":
            all(stepwise),
        f"the parameters within {2 * lr * COMPILED_STEPS:.3g} after {COMPILED_STEPS} steps":
            moved <= 2 * lr * COMPILED_STEPS,
        "finite compiled losses": bool(np.isfinite(runs["compiled"]["losses"]).all()),
    }
    failed = [f"{tag}: {k}" for k, ok in checks.items() if not ok]
    counts = runs["compiled"]["counts"]
    summary = dict(repeat=all(repeats.values()), grads_equal=all(
        r["equal"] for r in readings.values()), steps=COMPILED_STEPS, **{
            f"{kind}_ms": float(np.mean(runs[kind]["ms"] + runs[f"{kind} 2"]["ms"]))
            for kind in ("eager", "compiled")},
        **{f"{kind}_device_ms": busy[kind][1] / BUSY_STEPS for kind in busy},
        **{f"{kind}_busy": busy[kind][0] for kind in busy})
    graphs.release()
    del steps, graphs, runs, first, planted, start
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, failed, summary


def half_batch(args):
    """A step's arguments with every batch tensor cut to its first half."""
    b = args[0].shape[0]
    return tuple(a[: b // 2] if torch.is_tensor(a) and a.dim() and a.shape[0] == b else a
                 for a in args)


def compiled_training(dev, summaries: dict) -> dict:
    """Phase 20: the training step as one captured CUDA graph
    (``compiled=True``) against the eager step at B=TRAIN_BATCH, full width:
    the ``ddpm`` step with the fused routes on and off, and the
    ``upsample_16384`` x8 refine step with the fused routes on under an
    output scale that ramps over the steps (one graph); the steps of
    ``training_setup``.  Planted faults: a dropped half batch, and the next
    step's draws (DDPM) or output scale (refine).  Then ``scatter_cost`` of
    the SCATTER_COST steps on the same setup.  Each graph is released
    before the next step's; the phase fails after all three if any check
    failed.  Fills ``summaries`` (name -> ``compiled_vs_eager``'s summary)
    for phase 22's table; returns the launch counts by path."""
    counts, failed = {}, {}
    paths = {"ddpm_fused": ("compiled_ddpm_train_fused", "compiled ddpm train (fused routes)"),
             "ddpm_unfused": ("compiled_ddpm_train_unfused", "compiled ddpm train (unfused)"),
             "refine_x8": ("compiled_refine_train",
                           "compiled refine train (x8, fused routes, output scale 0.01 -> 0.001)")}
    for name, (path, tag) in paths.items():
        s = training_setup(name, dev, COMPILED_STEPS)
        faults = {"half batch": lambda: half_batch(s.inputs(0)),
                  ("next step's output scale" if name == "refine_x8" else "next step's draws"):
                      lambda: s.inputs(1)}
        counts[path], failed[name], summaries[name] = compiled_vs_eager(
            tag, s.state, s.make, s.loss_fn, s.inputs, faults, s.path, s.lr)
        if name in SCATTER_COST:
            atomic, bad = scatter_cost(name, s)
            failed[name] += bad
            counts["atomic_scatter_steps"] = {k: counts.get("atomic_scatter_steps", {}).get(k, 0)
                                              + v for k, v in atomic.items()}
        del s, faults
    bad = [b for v in failed.values() for b in v]
    if bad:
        raise AssertionError("phase 20: " + "; ".join(bad))
    return counts


# ---- phase 21: the compiled mesh step (one captured CUDA graph on NCCL) ---
MESH_CARD_STEPS = 10  # steps of each kind across cards: warm-up, capture, 8 replays
MESH_CARD_TIMEOUT_S = 900  # all the processes, start to end
MESH_REFINE_STEPS = 3  # steps of the x8 refine step over the group of one, each way


def timed_mesh_run(tag: str, state, start, step, inputs) -> dict:
    """Phase 21, one kind of step from ``start`` (restored in place): two
    steps on ``inputs(0)`` (the compiled step's warm-up and capture), then
    from ``start`` again COMPILED_STEPS steps with the host clock around
    each (ending in ``float(loss)``, as ``train()`` ends a step), their
    losses, launch counts, parameters and peak memory, and a BUSY_STEPS
    device-busy window."""
    from point_diffusion_refinement_tpu_torch import ops

    restore_state(state, start)
    for _ in range(2):
        step(state, *inputs(0))
    restore_state(state, start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ms, losses, first = [], [], None
    for i in range(COMPILED_STEPS):
        t0 = time.perf_counter()
        loss = step(state, *inputs(i))[1]
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = loss.clone()
    torch.cuda.synchronize()
    out = dict(first=first, losses=losses, ms=ms, counts=ops.launch_counts(),
               params=[p.detach().clone() for p in state.model.parameters()],
               peak=torch.cuda.max_memory_allocated(),
               reserved=torch.cuda.max_memory_reserved())
    restore_state(state, start)
    out["busy"] = device_busy(f"{tag}, {BUSY_STEPS} steps",
                              lambda: [step(state, *inputs(i)) for i in range(BUSY_STEPS)],
                              grad=True)
    return out


def compiled_mesh_step(dev) -> dict:
    """Phase 21: the ``ddpm`` step at B=TRAIN_BATCH, full width, bf16, fused
    routes on, over an NCCL process group of one (``tcp://127.0.0.1``, a
    free port), three ways from one state (after an eager step, so the
    moments exist; restored in place before each) and the same draws: the
    compiled mesh step (``jit_step_for_mesh(compiled=True)``: one captured
    graph of forward, backward, the flat all-reduce of the gradients, fused
    Adam and the loss's mean), the eager DDP step (``compiled=False``) and
    the one-process compiled step; then the mesh step's COMPILED_STEPS
    replays once more, each against an eager forward of its state
    (``stepwise_equal``).  Each graph is released before the next run; the
    phase fails after all three if a check failed."""
    import gc

    import torch.distributed as dist

    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.parallel import initialize_distributed, make_mesh
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    cfg = EXPERIMENTS["ddpm"]()
    dc, pc = cfg["diffusion_config"], cfg["pointnet_config"]
    lr = float(cfg["train_config"].get("learning_rate", 2e-4))
    schedule = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])
    arrays = training_arrays(TRAIN_BATCH, 2048, seed=40)
    x0, cond, label = (torch.from_numpy(arrays[k]).to(dev)
                       for k in ("complete", "partial", "label"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    draws = [(torch.randint(0, schedule.T, (TRAIN_BATCH,), generator=gen, device=dev),
              torch.randn(x0.shape, generator=gen, device=dev))
             for _ in range(COMPILED_STEPS + 1)]
    inputs = lambda i: (x0, cond, label, *draws[i])  # noqa: E731
    routes = dict(schedule=schedule, fused_gather=True, fused_sa=True)
    model = build_model(pc, device=dev, seed=0)
    state = tr.create_train_state(model, seed=1, learning_rate=lr)
    loss_fn = tr.make_completion_loss(model, schedule.to(dev), fused_gather=True, fused_sa=True)
    tr.make_completion_train_step(model, **routes)(state, *inputs(COMPILED_STEPS))
    torch.cuda.synchronize()
    start = snapshot_state(state)

    initialize_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    runs, graphs = {}, {}
    try:
        mesh = make_mesh()
        print(f"mesh step: rank={mesh.rank} world={mesh.world} shape={mesh.shape} "
              f"device={mesh.device} backend={dist.get_backend()} "
              f"compiled={tr.mesh_step_compiled(mesh)}", flush=True)
        makers = {
            "one process compiled": lambda: tr.make_completion_train_step(
                model, compiled=True, **routes),
            "mesh compiled": lambda: tr.jit_step_for_mesh(
                tr.make_completion_train_step, mesh, state, compiled=True, **routes)[0],
            "mesh eager (DDP)": lambda: tr.jit_step_for_mesh(
                tr.make_completion_train_step, mesh, state, compiled=False, **routes)[0],
        }
        for kind, make in makers.items():
            step = make()
            runs[kind] = timed_mesh_run(f"mesh step {kind}", state, start, step, inputs)
            if kind == "mesh compiled":
                stepwise = stepwise_equal(state, start, lambda args: step(state, *args),
                                          loss_fn, inputs)
            if step.graphs is not None:
                graphs[kind] = (step.graphs.num_graphs, step.graphs.stats())
                graph_stats(f"mesh step {kind}", step.graphs)
                step.graphs.release()
            del step
            model.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()
        refine = mesh_refine_step(dev, mesh)
    finally:
        dist.destroy_process_group()

    got, one, ddp = (runs[k] for k in makers)
    for kind, r in runs.items():
        print(f"mesh step {kind}: {COMPILED_STEPS} steps at B={TRAIN_BATCH} host ms "
              f"mean={np.mean(r['ms']):.2f} median={np.median(r['ms']):.2f} "
              f"min={min(r['ms']):.2f} device_busy={r['busy']:.3f} "
              f"peak_allocated_GiB={r['peak'] / 2 ** 30:.2f} "
              f"peak_reserved_GiB={r['reserved'] / 2 ** 30:.2f} "
              f"losses={[float(f'{v:.9g}') for v in r['losses']]}", flush=True)

    def traj(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))

    def moved(a, b):
        return max(float((p - q).abs().max()) for p, q in zip(a["params"], b["params"]))

    bound = 2 * lr * COMPILED_STEPS
    print(f"mesh step compiled vs one process compiled: first_loss_equal="
          f"{torch.equal(got['first'], one['first'])} losses_max_rel={traj(got, one):.3g} "
          f"params_max_diff={moved(got, one):.3g}; vs eager DDP: first_loss_equal="
          f"{torch.equal(got['first'], ddp['first'])} losses_max_rel={traj(got, ddp):.3g} "
          f"params_max_diff={moved(got, ddp):.3g} (tol {bound:.3g}); each replayed mesh loss "
          f"equal to an eager forward of its state: {stepwise}", flush=True)
    same_launches("mesh step compiled vs eager DDP", got["counts"], ddp["counts"],
                  TRAIN_PATH_KERNELS)
    checks = {
        "the first loss equal to the one-process compiled step's":
            torch.equal(got["first"], one["first"]),
        "the x8 refine step's first loss equal to the one-process compiled step's":
            refine["first_loss_equal"],
        f"each of {COMPILED_STEPS} replayed losses equal to an eager forward of its state":
            all(stepwise),
        f"the parameters within {bound:.3g} of both":
            max(moved(got, one), moved(got, ddp)) <= bound,
        "one graph": graphs["mesh compiled"][0] == 1,
        "finite losses": bool(np.isfinite(got["losses"]).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("phase 21: " + "; ".join(failed))
    del runs, start, state, model, draws
    gc.collect()
    torch.cuda.empty_cache()
    return {"compiled_mesh_step": got["counts"], "compiled_mesh_refine_step": refine["counts"]}


def mesh_refine_step(dev, mesh) -> dict:
    """Phase 21 (b): the compiled ``refine_x8`` step (``training_setup``)
    over ``mesh`` (``jit_step_for_mesh(compiled=True)``) beside the
    one-process compiled step, from one state (after an eager step;
    restored in place) and the same inputs: each a warm-up and a capture,
    then MESH_REFINE_STEPS steps, host ms around each; the first losses
    compared bit for bit (the check), the later losses and the state at
    the end printed beside.  Each graph is released before the next."""
    import gc

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr

    s = training_setup("refine_x8", dev, MESH_REFINE_STEPS)
    s.make(False)(s.state, *s.inputs(MESH_REFINE_STEPS))
    torch.cuda.synchronize()
    start = snapshot_state(s.state)
    makers = {"one process compiled": lambda: s.make(True),
              "mesh compiled": lambda: tr.jit_step_for_mesh(
                  s.maker, mesh, s.state, compiled=True, **s.kwargs)[0]}
    runs = {}
    for kind, make in makers.items():
        step = make()
        restore_state(s.state, start)
        for _ in range(2):  # the warm-up, the capture
            step(s.state, *s.inputs(0))
        restore_state(s.state, start)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms, losses = [], []
        for i in range(MESH_REFINE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(s.state, *s.inputs(i))[1]))
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        runs[kind] = dict(losses=losses, ms=ms, end=end_state(s.state),
                          counts=ops.launch_counts(), graphs=step.graphs.num_graphs)
        graph_stats(f"mesh refine x8 {kind}", step.graphs)
        step.graphs.release()
        del step
        s.state.model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
    one, got = runs["one process compiled"], runs["mesh compiled"]
    first_equal = got["losses"][0] == one["losses"][0]
    for kind, r in runs.items():
        print(f"mesh refine x8 {kind}: {MESH_REFINE_STEPS} steps at B={TRAIN_BATCH} host ms "
              f"{[round(v, 2) for v in r['ms']]} losses={r['losses']} graphs={r['graphs']}",
              flush=True)
    print(f"mesh refine x8 compiled vs one process compiled: first_loss_equal={first_equal} "
          f"all_losses_and_state_equal={all(runs_equal(runs).values())}", flush=True)
    same_launches("mesh refine x8 compiled vs one process", got["counts"], one["counts"],
                  s.path)
    del s, start, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"first_loss_equal": first_equal, "counts": got["counts"]}


# ---- phase 22: the training step run to run ------------------------------
# the training configurations of phase 22 (a), the order diagnosis
DIAGNOSED = ("ddpm_fused", "ddpm_unfused", "refine_x8", "pvd", "pointwise")
# ... and of its repeat check (b); phase 20 holds the other three the same way
REPEATED = ("refine_x2", "refine_x4", "denoise", "pvd", "pointwise")
# steps of each of (b)'s runs (phase 20 runs COMPILED_STEPS): fewer, so that
# the script stays within its time
REPEAT_STEPS = 2
REFINE_SETUPS = {  # name -> (experiment, task)
    "refine_x8": ("upsample_16384", "refine_completion"),
    "refine_x2": ("upsample_4096", "refine_completion"),
    "refine_x4": ("upsample_8192", "refine_completion"),
    "denoise": ("refine", "denoise"),
}
DENOISE_NOISE = 0.01  # the refine configs' noise_magnitude_for_generated_samples


def training_setup(name: str, dev, steps: int):
    """One training configuration at B=TRAIN_BATCH, full width, seeded
    weights and draws, as a namespace: ``state``; ``maker`` and ``kwargs``
    (``maker(model, compiled=, **kwargs)`` is the step, as
    ``jit_step_for_mesh`` takes them); ``make(compiled)``, the step on the
    state's model; ``loss_fn``, its loss function; ``inputs(i)``, the
    step's arguments after the state for i <= ``steps``; ``path``, the
    kernels it must launch.  ``ddpm_fused`` / ``ddpm_unfused``: the
    ``ddpm`` config in bf16, the fused routes on / off; ``refine_x8``:
    ``upsample_16384`` with cd_t, the intermediate loss on and the output
    scale ramping 0.01 -> 0.001 over ``steps``; ``refine_x2`` /
    ``refine_x4``: ``upsample_4096`` / ``upsample_8192`` at their own loss
    settings; ``denoise``: the ``refine`` config with task ``denoise`` (the
    input x_gt + noise of scale DENOISE_NOISE); the refine steps take the
    fused routes; ``pvd`` (float32) and ``pointwise``: their class
    defaults on the ``ddpm`` schedule."""
    from types import SimpleNamespace

    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    if name not in REFINE_SETUPS:
        extra, routes, path = {}, {}, ()
        if name.startswith("ddpm"):
            pc = EXPERIMENTS["ddpm"]()["pointnet_config"]
            if name == "ddpm_fused":
                routes, path = dict(fused_gather=True, fused_sa=True), TRAIN_PATH_KERNELS
            else:
                path = ("fps", "knn", "ball_query")
        else:
            network = "pvd" if name == "pvd" else "pointwise_net"
            pc = {"network_type": network, "model_name": name, "network_args": {}}
            extra = {"condition_features": 4} if name == "pointwise" else {}
            path = PVD_PATH_KERNELS if name == "pvd" else ()
        schedule = option_schedule()
        arrays = training_arrays(TRAIN_BATCH, 2048, seed=40)
        x0, cond, label = (torch.from_numpy(arrays[k]).to(dev)
                           for k in ("complete", "partial", "label"))
        draws = [(torch.randint(0, schedule.T, (TRAIN_BATCH,), generator=gen, device=dev),
                  torch.randn(x0.shape, generator=gen, device=dev)) for _ in range(steps + 1)]
        model = build_model(pc, device=dev, seed=0, **extra)
        maker, kwargs = tr.make_completion_train_step, dict(schedule=schedule, **routes)
        loss_fn = tr.make_completion_loss(model, schedule.to(dev), **routes)
        inputs = lambda i: (x0, cond, label, *draws[i])  # noqa: E731
    else:
        exp, task = REFINE_SETUPS[name]
        cfg = EXPERIMENTS[exp]()
        pc, rc = cfg["pointnet_config"], cfg["refine_config"]
        factor = int(pc.get("point_upsample_factor", 1))
        osf_end = float(rc["output_scale_factor"])
        if name == "refine_x8":
            loss = dict(cd_loss_type="cd_t", intermediate_loss_weight=1.0)
            ramp = tr.QuantityScheduler(0, 1, 0.01, osf_end, steps)
            scale_at = lambda i: ramp.get_quantity(i % steps)  # noqa: E731
        else:
            loss = dict(cd_loss_type=rc["cd_loss_type"], intermediate_loss_weight=float(
                pc.get("intermediate_refined_X_loss_weight", 0.0)) if factor > 1 else 0.0)
            scale_at = lambda i: osf_end  # noqa: E731
        arrays = training_arrays(TRAIN_BATCH, int(cfg["mvp_dataset_config"]["npoints"]),
                                 seed=41)
        batch = tuple(torch.from_numpy(arrays[k]).to(dev)
                      for k in ("complete", "partial", "label", "generated"))
        noise = [DENOISE_NOISE * torch.randn(batch[0].shape, generator=gen, device=dev)
                 for _ in range(steps + 1)] if task == "denoise" else None
        osf = torch.zeros((), dtype=torch.float32, device=dev)
        model = build_model(pc, device=dev, seed=0)
        kwargs = dict(scale=1.0, point_upsample_factor=factor, task=task,
                      include_displacement_center=bool(
                          pc.get("include_displacement_center_to_final_output", False)),
                      fused_gather=True, fused_sa=True, **loss)
        maker, loss_fn = tr.make_refine_train_step, tr.make_refine_loss(model, **kwargs)
        inputs = lambda i: (*batch, osf.fill_(scale_at(i)),  # noqa: E731
                            *((noise[i],) if noise is not None else ()))
        path = TRAIN_PATH_KERNELS
    lr = 2e-4  # the shipped configs' learning_rate
    state = tr.create_train_state(model, seed=1, learning_rate=lr)
    return SimpleNamespace(
        state=state, maker=maker, kwargs=kwargs, loss_fn=loss_fn, inputs=inputs, path=path,
        lr=lr, make=lambda compiled: maker(model, compiled=compiled, **kwargs))


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def unequal_tensors(got: dict, ref: dict) -> dict:
    """name -> max |got - ref| over max |ref| of every tensor that is not
    bit-equal."""
    return {n: float((got[n] - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for n, r in ref.items() if not torch.equal(got[n], r)}


def where_unequal(unequal: dict) -> str:
    """The unequal tensors by module (the first two parts of their names),
    and the six that differ most."""
    by_module: dict = {}
    for n in unequal:
        key = ".".join(n.split(".")[:2])
        by_module[key] = by_module.get(key, 0) + 1
    worst = sorted(unequal.items(), key=lambda kv: -kv[1])[:6]
    return (f"by module {by_module}; largest {[(n, float(f'{v:.3g}')) for n, v in worst]}"
            if unequal else "none")


def order_diagnosis(dev) -> list:
    """Phase 22 (a): for each DIAGNOSED configuration, two eager steps from
    one state (after an eager step, so the moments exist; restored in
    place) on the same draws: the loss and every parameter's gradient
    compared bit for bit, the tensors that differ printed by module; then
    the same pair under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (only here), with what PyTorch flags.  Returns the
    configurations whose pair differed without the flag."""
    import gc
    import warnings

    failed = []
    for name in DIAGNOSED:
        setup = training_setup(name, dev, 1)
        state, inputs = setup.state, setup.inputs
        step = setup.make(False)
        step(state, *inputs(1))
        torch.cuda.synchronize()
        start = snapshot_state(state)

        def once():
            restore_state(state, start)
            loss = step(state, *inputs(0))[1]
            torch.cuda.synchronize()
            return loss.clone(), grads_of(state.model)

        pair = (once(), once())
        fill = torch.utils.deterministic.fill_uninitialized_memory
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            # what the flag swaps and flags, without its NaN fill of every
            # new tensor (the kernels write all they return)
            torch.utils.deterministic.fill_uninitialized_memory = False
            try:
                flagged_pair = (once(), once())
            finally:
                torch.use_deterministic_algorithms(False)
                torch.utils.deterministic.fill_uninitialized_memory = fill
        flagged = sorted({" ".join(str(w.message).split())[:200] for w in caught})
        for what, ((la, ga), (lb, gb)) in (("", pair), (
                " under use_deterministic_algorithms(True, warn_only=True)", flagged_pair)):
            unequal = unequal_tensors(ga, gb)
            print(f"order diagnosis {name}{what}: two eager steps from one state, loss_equal="
                  f"{torch.equal(la, lb)} grads_equal={len(gb) - len(unequal)} of {len(gb)} "
                  f"tensors; unequal: {where_unequal(unequal)}", flush=True)
            if not what and (unequal or not torch.equal(la, lb)):
                failed.append(name)
        print(f"order diagnosis {name}: flagged by PyTorch: {flagged or 'nothing'}", flush=True)
        del setup, state, step, start, pair, flagged_pair
        gc.collect()
        torch.cuda.empty_cache()
    return failed


def repeat_check(name: str, dev, steps: int = REPEAT_STEPS):
    """Phase 22 (b) for one configuration (``training_setup``): two eager
    and two compiled runs of ``steps`` steps from one state (after an eager
    step, so the moments exist; restored in place) on the same inputs.
    Checks: every loss, and the parameters, Adam moments and step counts at
    the end, bit-equal across the four runs; the first step's gradients
    bit-equal across them; the launch counts compiled equal to eager.
    Prints host ms a step (ending in ``float(loss)``), and device ms and
    busy share over SHORT_BUSY_STEPS steps, each way.  Returns (summary, launch
    counts of a compiled run, failed checks)."""
    import gc

    from point_diffusion_refinement_tpu_torch import ops

    tag = f"repeat {name}"
    s = training_setup(name, dev, steps)
    state, model = s.state, s.state.model
    steps_of = {"eager": s.make(False), "compiled": s.make(True)}
    steps_of["eager"](state, *s.inputs(steps))
    torch.cuda.synchronize()
    start = snapshot_state(state)

    def run(kind):
        step = steps_of[kind]
        restore_state(state, start)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms, losses, grads = [], [], None
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step(state, *s.inputs(i))[1]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads = grads_of(model)
        torch.cuda.synchronize()
        return dict(ms=ms, losses=losses, grads=grads, end=end_state(state),
                    counts=ops.launch_counts())

    def busy(kind):
        restore_state(state, start)
        return device_busy(f"{tag} {kind}, {SHORT_BUSY_STEPS} steps", lambda: [
            steps_of[kind](state, *s.inputs(i)) for i in range(SHORT_BUSY_STEPS)], grad=True,
            with_ms=True)

    runs = {"eager 1": run("eager"), "eager 2": run("eager")}
    busy_of = {"eager": busy("eager")}
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    restore_state(state, start)
    for _ in range(2):  # the warm-up, the capture
        steps_of["compiled"](state, *s.inputs(0))
    runs["compiled 1"] = run("compiled")
    runs["compiled 2"] = run("compiled")
    busy_of["compiled"] = busy("compiled")
    graph_stats(tag, steps_of["compiled"].graphs)

    repeats = runs_equal(runs)
    ref = runs["eager 1"]["grads"]
    grads = {k: unequal_tensors(r["grads"], ref) for k, r in runs.items()}
    for k, r in runs.items():
        print(f"{tag} {k}: losses={r['losses']} host ms {[round(v, 2) for v in r['ms']]}; "
              f"against eager 1: run bit-equal={repeats[k]} first-step gradients unequal: "
              f"{where_unequal(grads[k])}", flush=True)
    same_launches(tag, runs["compiled 1"]["counts"], runs["eager 1"]["counts"], s.path)
    summary = dict(repeat=all(repeats.values()), grads_equal=not any(grads.values()),
                   steps=steps, **{
                       f"{kind}_ms": float(np.mean(runs[f"{kind} 1"]["ms"]
                                                   + runs[f"{kind} 2"]["ms"]))
                       for kind in ("eager", "compiled")},
                   **{f"{kind}_device_ms": busy_of[kind][1] / SHORT_BUSY_STEPS for kind in busy_of},
                   **{f"{kind}_busy": busy_of[kind][0] for kind in busy_of})
    failed = [f"{tag}: {k}" for k, ok in {
        "two eager and two compiled runs bit-equal (losses; parameters, moments and step "
        "counts at the end)": summary["repeat"],
        "the first step's gradients bit-equal across the four runs": summary["grads_equal"],
        "finite losses": bool(np.isfinite(runs["compiled 1"]["losses"]).all()),
    }.items() if not ok]
    counts = runs["compiled 1"]["counts"]
    steps_of["compiled"].graphs.release()
    del s, state, model, steps_of, runs, start
    gc.collect()
    torch.cuda.empty_cache()
    return summary, counts, failed


# the configurations of phase 20 that also run ``scatter_cost``, its turns,
# and the steps of each turn's timed run
SCATTER_COST = ("ddpm_fused", "refine_x8")
SCATTER_COST_TURNS = ("ordered", "atomic", "atomic", "ordered")
SCATTER_COST_STEPS = 3
# the port's modules that call ops/scatter.py::group_scatter_add, and those
# that call its two-table form group_scatter_add_pair
SCATTER_CALLERS = ("models.grouping", "ops.ball_group", "ops.sampling", "ops.voxelize")
SCATTER_PAIR_CALLERS = ("ops.ball_group",)


@contextlib.contextmanager
def scatter_kernel(deterministic: bool):
    """Inside the context every caller of ``group_scatter_add`` in the port
    (SCATTER_CALLERS: the grouping backwards, the gathers' backward, the
    voxel transfers) passes ``deterministic``: the port reaches the atomic
    kernel B only through that keyword, so a whole step is timed with it by
    binding the keyword where the callers look the function up.  With
    ``deterministic=False`` the two-table form (SCATTER_PAIR_CALLERS) becomes
    two launches of B, one a table."""
    import functools
    import importlib

    from point_diffusion_refinement_tpu_torch.ops import scatter

    def atomic_pair(dg, dg2, idx, n_rows, counts=None):
        return tuple(scatter.group_scatter_add(d, idx, n_rows, counts, deterministic=False)
                     for d in (dg, dg2))

    patches = [(importlib.import_module(f"point_diffusion_refinement_tpu_torch.{m}"),
                "group_scatter_add",
                functools.partial(scatter.group_scatter_add, deterministic=deterministic))
               for m in SCATTER_CALLERS]
    if not deterministic:
        patches += [(importlib.import_module(f"point_diffusion_refinement_tpu_torch.{m}"),
                     "group_scatter_add_pair", atomic_pair) for m in SCATTER_PAIR_CALLERS]
    saved = [getattr(m, name) for m, name, _ in patches]
    try:
        for m, name, f in patches:
            setattr(m, name, f)
        yield
    finally:
        for (m, name, _), f in zip(patches, saved):
            setattr(m, name, f)


def scatter_cost(name: str, s):
    """Phase 20, after ``compiled_vs_eager`` of ``name`` on the same setup
    ``s`` (``training_setup``): the compiled step with the ordered
    scatter-add against the same step with the atomic kernel B
    (``scatter_kernel`` around each graph's warm-up and capture), in the
    turns SCATTER_COST_TURNS from one state.  Two graphs of a B=32 step do
    not fit the card together (a pool holds ~40 GB), so a turn of the other
    kind releases the graph and captures its own.  A turn: SCATTER_COST_STEPS
    steps with the host clock around each (ending in ``float(loss)``), then
    a device window of SHORT_BUSY_STEPS steps.  Checks: each kind launches
    its kernel and not the other; the ordered turns' losses bit-equal.
    Returns (the atomic turns' launch counts, the failed checks)."""
    import gc

    from point_diffusion_refinement_tpu_torch import ops

    tag = f"scatter cost {name}"
    state = s.state
    start = snapshot_state(state)
    host, device, losses, counts = {}, {}, {}, {}
    step, live = None, None
    for kind in SCATTER_COST_TURNS:
        if kind != live:
            if step is not None:
                step.graphs.release()
                state.model.zero_grad(set_to_none=True)
                gc.collect()
                torch.cuda.empty_cache()
            step, live = s.make(True), kind
            restore_state(state, start)
            with scatter_kernel(deterministic=kind == "ordered"):
                for _ in range(2):  # the warm-up, the capture
                    step(state, *s.inputs(0))
        restore_state(state, start)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms, turn = [], []
        for i in range(SCATTER_COST_STEPS):
            t0 = time.perf_counter()
            turn.append(float(step(state, *s.inputs(i))[1]))
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        counts[kind] = {k: counts.get(kind, {}).get(k, 0) + v for k, v in got.items()}
        restore_state(state, start)
        _, dev_ms = device_busy(
            f"{tag} compiled, {kind} scatter, {SHORT_BUSY_STEPS} steps",
            lambda step=step: [step(state, *s.inputs(i)) for i in range(SHORT_BUSY_STEPS)],
            grad=True, with_ms=True)
        host.setdefault(kind, []).append(float(np.mean(ms)))
        device.setdefault(kind, []).append(dev_ms / SHORT_BUSY_STEPS)
        losses.setdefault(kind, []).append(turn)
    step.graphs.release()
    state.model.zero_grad(set_to_none=True)
    restore_state(state, start)

    def diff(of):
        o, a = np.mean(of["ordered"]), np.mean(of["atomic"])
        return f"{o - a:+.2f} ms ({(o - a) / a:+.2%})"

    same = {k: all(v == ls[0] for v in ls) for k, ls in losses.items()}
    print(f"{tag} B={TRAIN_BATCH} compiled step in turns {'/'.join(SCATTER_COST_TURNS)}: "
          f"host_ms a step (mean over {SCATTER_COST_STEPS}) " + " ".join(
              f"{k}={[round(v, 2) for v in host[k]]}" for k in host) + "; device_ms a step " +
          " ".join(f"{k}={[round(v, 2) for v in device[k]]}" for k in device) +
          f"; ordered minus atomic: host {diff(host)} device {diff(device)}; the turns' losses "
          f"bit-equal: ordered {same['ordered']} atomic {same['atomic']}", flush=True)
    checks = {
        "the ordered turns launch only the ordered scatter-add":
            counts["ordered"]["group_scatter_ordered"] > 0
            and counts["ordered"]["group_scatter_add"] == 0,
        "the atomic turns launch only kernel B": counts["atomic"]["group_scatter_add"] > 0
            and counts["atomic"]["group_scatter_ordered"] == 0,
        "the ordered turns' losses bit-equal": same["ordered"],
    }
    del step, start
    gc.collect()
    torch.cuda.empty_cache()
    return counts["atomic"], [f"{tag}: {k}" for k, ok in checks.items() if not ok]


def training_repeats(dev, summaries: dict) -> dict:
    """Phase 22: (a) ``order_diagnosis``; (b) ``repeat_check`` of every
    REPEATED configuration (phase 20 ran the same checks on ``ddpm_fused``,
    ``ddpm_unfused`` and ``refine_x8``: their summaries come in
    ``summaries``); a table of the eight configurations.  Fails after all
    parts if a check failed.  Returns the launch counts by path."""
    t0 = time.perf_counter()
    failed = [f"order diagnosis {n}: two eager steps differ" for n in order_diagnosis(dev)]
    took = {"a": time.perf_counter() - t0}
    counts = {}
    for name in REPEATED:
        summaries[name], counts[f"repeat_{name}"], bad = repeat_check(name, dev)
        failed += bad
    took["b"] = time.perf_counter() - t0 - took["a"]
    print("phase 22 seconds: " + " ".join(f"({k}) {v:.1f}" for k, v in took.items()),
          flush=True)
    print("training steps run to run (B=32, full width; host ms a step ending in float(loss); "
          f"device ms and busy over {BUSY_STEPS} profiled steps in phase 20, "
          f"{SHORT_BUSY_STEPS} in phase 22):", flush=True)
    for name, r in summaries.items():
        print(f"  {name}: runs bit-equal={r['repeat']} first-step gradients bit-equal="
              f"{r['grads_equal']} ({r['steps']} steps, 2 eager + 2 compiled) host_ms eager="
              f"{r['eager_ms']:.2f} compiled={r['compiled_ms']:.2f} device_ms eager="
              f"{r['eager_device_ms']:.2f} compiled={r['compiled_device_ms']:.2f} busy eager="
              f"{r['eager_busy']:.3f} compiled={r['compiled_busy']:.3f}", flush=True)
    if failed:
        raise AssertionError("phase 22: " + "; ".join(failed))
    return counts


def mesh_step_rank(rank: int, port: int, workdir: str, world: int) -> None:
    """``--model-axis-cards N``, one of N processes, a card each, NCCL: on
    the (N, 1) and the (N / 2, 2) mesh, MESH_CARD_STEPS ``ddpm`` steps
    compiled and eager (DDP on the data-only mesh), each from the seed-0
    weights on this rank's rows and draws (``mesh_steps_data.npz``); its
    losses, host ms, launch counts, graphs and peak memory, and rank 0's
    gathered parameters, go to ``mesh_steps_rank_<r>.pt``."""
    import gc

    import torch.distributed as dist

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.parallel import (
        full_state_dict,
        initialize_distributed,
        make_mesh,
        shard_batch,
    )
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="nccl", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    try:
        pc, schedule = model_axis_network()
        with np.load(os.path.join(workdir, "mesh_steps_data.npz")) as f:
            data = {k: f[k] for k in f.files}
        out = {}
        for m in (1, MODEL_AXIS_PARALLEL):
            mesh = make_mesh(model_parallel=m)
            dev = mesh.device
            rows = {k: torch.from_numpy(shard_batch(v, mesh)).to(dev)
                    for k, v in data.items() if k != "t" and k != "z"}
            t, z = (torch.from_numpy(np.stack([shard_batch(v, mesh) for v in data[k]])).to(dev)
                    for k in ("t", "z"))
            for compiled in (True, False):
                model = build_model(pc, device=dev, seed=0)
                state = tr.create_train_state(model, seed=rank + 1)
                step, state = tr.jit_step_for_mesh(
                    tr.make_completion_train_step, mesh, state, compiled=compiled,
                    schedule=schedule, fused_gather=True, fused_sa=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                losses, ms = [], []
                for i in range(MESH_CARD_STEPS):
                    t0 = time.perf_counter()
                    _, loss = step(state, rows["complete"], rows["partial"],
                                   rows["label"].long(), t=t[i].long(), z=z[i])
                    losses.append(float(loss))
                    ms.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                res = dict(shape=mesh.shape, losses=losses, ms=ms, counts=ops.launch_counts(),
                           peak_GiB=torch.cuda.max_memory_allocated() / 2 ** 30,
                           graphs=None if step.graphs is None else
                           (step.graphs.num_graphs, step.graphs.stats()))
                full = {k: v.detach().cpu() for k, v in full_state_dict(model).items()}
                if rank == 0:
                    res["params"] = full
                out[m, compiled] = res
                if step.graphs is not None:
                    step.graphs.release()
                del step, state, model
                gc.collect()
                torch.cuda.empty_cache()
        out["backend"] = dist.get_backend()
        torch.save(out, os.path.join(workdir, f"mesh_steps_rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_steps_across_cards(dev, workdir: str, world: int) -> dict:
    """``--model-axis-cards N``: the compiled (N, 1) and (N / 2, 2) mesh
    steps, a process a card over NCCL, against the eager mesh steps (DDP;
    the uncaptured sharded step) and one process on card 0, from the same
    weights, rows and draws.  Holds on every mesh: one graph on every rank,
    launch counts equal to the eager step's, the losses equal on the ranks;
    the first loss equal to the eager step's and within
    TRAIN_PLAIN_LOSS_REL_TOL of one process; the later losses and the
    gathered parameters after the last step (relative L2) within
    RESUME_REL_TOL of both.  Prints each rank's host ms a step over the
    replays, capture ms, pool bytes and peak memory."""
    import gc

    import torch.multiprocessing as mp

    from point_diffusion_refinement_tpu_torch import train as tr
    from point_diffusion_refinement_tpu_torch.train.loop import build_model

    pc, schedule = model_axis_network()
    arrays = training_arrays(TRAIN_BATCH, 2048, seed=60)
    rng = np.random.default_rng(61)
    data = {k: arrays[k] for k in ("complete", "partial", "label")}
    data["t"] = rng.integers(0, schedule.T, (MESH_CARD_STEPS, TRAIN_BATCH))
    data["z"] = rng.standard_normal((MESH_CARD_STEPS, TRAIN_BATCH, 2048, 3)).astype(np.float32)
    np.savez(os.path.join(workdir, "mesh_steps_data.npz"), **data)

    model = build_model(pc, device=dev, seed=0)
    state = tr.create_train_state(model, seed=1)
    step = tr.make_completion_train_step(model, schedule, fused_gather=True, fused_sa=True,
                                         compiled=True)
    x0, cond, label = (torch.from_numpy(data[k]).to(dev) for k in ("complete", "partial", "label"))
    ref = []
    for i in range(MESH_CARD_STEPS):
        _, loss = step(state, x0, cond, label.long(), t=torch.from_numpy(data["t"][i]).to(dev),
                       z=torch.from_numpy(data["z"][i]).to(dev))
        ref.append(float(loss))
    ref_params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    print(f"mesh steps one process: {MESH_CARD_STEPS} compiled steps at B={TRAIN_BATCH} "
          f"losses={[float(f'{v:.9g}') for v in ref]}", flush=True)
    step.graphs.release()
    del step, state, model, x0, cond, label
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    procs = mp.start_processes(mesh_step_rank, args=(free_port(), workdir, world),
                               nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_CARD_TIMEOUT_S
    while not procs.join(timeout=5):
        if time.monotonic() > deadline:
            for p in procs.processes:
                p.kill()
            raise AssertionError("mesh steps: the processes did not finish in time")
    print(f"mesh steps: {world} processes in {time.perf_counter() - t0:.1f} s with start-up",
          flush=True)
    ranks = [torch.load(os.path.join(workdir, f"mesh_steps_rank_{r}.pt"), weights_only=False)
             for r in range(world)]
    failed, counts = [], {}
    for m in (1, MODEL_AXIS_PARALLEL):
        got, eager = ranks[0][m, True], ranks[0][m, False]
        tag = f"mesh steps {got['shape']} across {world} cards ({ranks[0]['backend']})"
        for r, res in enumerate(ranks):
            for compiled in (True, False):
                x = res[m, compiled]
                timed = x["ms"][2:]
                print(f"{tag} rank {r} {'compiled' if compiled else 'eager'}: host ms a step "
                      f"over steps 3-{MESH_CARD_STEPS} mean={np.mean(timed):.2f} "
                      f"median={np.median(timed):.2f} first two={[round(v, 1) for v in x['ms'][:2]]} "
                      f"peak_memory_GiB={x['peak_GiB']:.2f}"
                      + ("" if x["graphs"] is None else
                         f" graphs={x['graphs'][0]} capture_ms={x['graphs'][1][0]['capture_ms']:.1f}"
                         f" pool_bytes={x['graphs'][1][0]['pool_bytes']}"), flush=True)
        rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
        checks = {
            "one graph on every rank": all(res[m, True]["graphs"] is not None
                                           and res[m, True]["graphs"][0] == 1 for res in ranks),
            "launches equal to the eager step's on every rank": all(
                res[m, True]["counts"] == res[m, False]["counts"] for res in ranks),
            "kernels of the training path launched": all(
                got["counts"][k] > 0 for k in TRAIN_PATH_KERNELS),
            "losses equal on the ranks": all(res[m, c]["losses"] == ranks[0][m, c]["losses"]
                                             for res in ranks for c in (True, False)),
            "first loss equal to the eager step's": got["losses"][0] == eager["losses"][0],
            f"first loss within {TRAIN_PLAIN_LOSS_REL_TOL} of one process":
                rel(got["losses"][0], ref[0]) <= TRAIN_PLAIN_LOSS_REL_TOL,
            f"losses within {RESUME_REL_TOL} of eager and one process": max(
                rel(a, b) for other in (eager["losses"], ref)
                for a, b in zip(got["losses"], other)) <= RESUME_REL_TOL,
            f"parameters within {RESUME_REL_TOL} (relative L2) of eager and one process": max(
                params_rel_l2(got["params"], eager["params"]),
                params_rel_l2(got["params"], ref_params)) <= RESUME_REL_TOL,
        }
        print(f"{tag}: compiled losses={[float(f'{v:.9g}') for v in got['losses']]} eager "
              f"losses={[float(f'{v:.9g}') for v in eager['losses']]}; params_rel_l2 vs eager="
              f"{params_rel_l2(got['params'], eager['params']):.3g} vs one process="
              f"{params_rel_l2(got['params'], ref_params):.3g}; launches a rank="
              f"{ {k: v for k, v in got['counts'].items() if v} }; "
              + "; ".join(f"{k}: {ok}" for k, ok in checks.items()), flush=True)
        failed += [f"{tag}: {k}" for k, ok in checks.items() if not ok]
        counts[f"mesh_steps_{m}"] = {k: sum(res[m, True]["counts"][k] for res in ranks)
                                     for k in got["counts"]}
    if failed:
        raise AssertionError("mesh steps across cards: " + "; ".join(failed))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--model-axis-cards"]:
        return model_axis_across_cards(int(sys.argv[2]))

    from point_diffusion_refinement_tpu_torch import ops
    from point_diffusion_refinement_tpu_torch.config import DEFAULT_POINTNET_CONFIG
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
    from point_diffusion_refinement_tpu_torch.ops import kernels
    from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def at(phase: str) -> None:
        print(f"at {time.perf_counter() - t_start:.1f} s: {phase}", flush=True)

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          + ", ".join(f"{k}={v:.1f}s" for k, v in took.items()), flush=True)

    at("2 kernels vs plain")
    # 2. kernels vs plain versions
    rng = np.random.default_rng(0)
    pick_floor_ms = fps_sweep(dev, rng)
    rows = check_kernels(dev, rng, pick_floor_ms)
    rows.insert(1, check_fps_idx(dev, rng, pick_floor_ms))

    cfg = dict(DEFAULT_POINTNET_CONFIG)
    cfg["compute_dtype"] = "bfloat16"
    model = PointNet2CloudCondition.from_config(cfg, device="cuda", seed=0)
    B = 4
    cond = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, 3072, 3)),
         rng.integers(0, 2, (B, 3072, 1)) * 2.0 - 1.0], axis=-1).astype(np.float32)).to(dev)
    label = torch.zeros(B, dtype=torch.int64, device=dev)
    check_denoise_ball_queries(model, cond, label, dev)

    at("3 main path")
    # 3. the main path at full width
    T = STEPS
    schedule = calc_diffusion_hyperparams(T, 1e-4, 0.02)
    sampler = make_coarse_sampler(model, schedule, num_points=2048)
    gen = torch.Generator(device=dev)

    # warm-up (first-use allocations, cuBLAS handles), uncounted
    gen.manual_seed(1)
    with torch.no_grad():
        model.encode_condition(cond)
    short = make_coarse_sampler(model, calc_diffusion_hyperparams(2, 1e-4, 0.02), 2048)
    short(cond, label, generator=gen)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cf = model.encode_condition(cond)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    enc_counts = ops.launch_counts()

    gen.manual_seed(2)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sampler(cond, label, generator=gen)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    step_ms = (total_ms - encode_ms) / T
    per_step = {k: (counts[k] - enc_counts[k]) / T for k in counts}
    print(f"main path: T={T} total_ms={total_ms:.1f} encode_ms={encode_ms:.2f} "
          f"step_ms={step_ms:.2f}", flush=True)
    print(f"launches: run={counts} encode={enc_counts} per_step={per_step}", flush=True)
    finite = bool(torch.isfinite(out).all())
    print(f"output: shape={tuple(out.shape)} finite={finite} "
          f"std={float(out.float().std()):.4f}", flush=True)
    if tuple(out.shape) != (B, 2048, 3) or not finite:
        raise AssertionError("main path output is not a finite (4, 2048, 3) cloud")
    for name in COARSE_PATH_KERNELS:
        if counts[name] <= 0 or per_step[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on every denoise step")

    at("4 denoise vs plain")
    # 4. one denoise step, kernels vs plain versions on the card
    x = torch.randn(B, 2048, 3, generator=gen, device=dev)
    ts = torch.full((B,), float(T // 2), device=dev)
    with torch.no_grad():
        y_k = model.denoise(x, ts, label, cf, fused=True).float()
        with kernels.plain_ops():
            cf_p = model.encode_condition(cond)
            y_p = model.denoise(x, ts, label, cf_p, fused=True).float()
    rel = float((y_k - y_p).norm() / y_p.norm())
    print(f"denoise kernels vs plain: rel_err={rel:.3g} (tol {DENOISE_REL_TOL})", flush=True)
    if not rel <= DENOISE_REL_TOL:
        raise AssertionError("denoise step through the kernels disagrees with the plain path")

    wide_ball_step(cond, label, dev)

    kernel_ms = {"per_denoise_step_ms": profile_window(
        "denoise steps", lambda: model.denoise(x, ts, label, cf, fused=True),
        kernels="a denoise step")}

    at("4b-9")
    path_counts = {"ddpm_avg_max_step": avg_max_step(rng, dev)}
    preprocess(rng)
    kernel_ms["per_pipeline_ms"] = {}
    direct = {}  # direct-call times the CLIs' are printed beside (phase 14)
    path_counts["pipeline"] = pipeline(model, rng, dev,
                                       kernel_ms_out=kernel_ms["per_pipeline_ms"],
                                       timings_out=direct)
    refine_at_batch(rng, dev)
    evaluation_cost(rng, dev)

    at("13 inference variants")
    # 13. the accelerated inference configuration
    variant_rows, path_counts["pipeline_variants"] = accelerated_inference(
        model, cf, x, ts, label, rng, dev)
    rows += variant_rows
    refine_variants(rng, dev)

    at("19 compiled generation")
    path_counts.update(compiled_generation(model, cond, label, dev, rng))
    del model, cf, cf_p, sampler, short

    at("10 training kernels")
    # 10-12. training
    check_any_nsample(dev)
    rows += check_training_kernels(dev, rng)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        at("11 ddpm training")
        path_counts["ddpm_train"], kernel_ms["per_ddpm_train_step_ms"] = ddpm_training(
            dev, workdir, direct)
        at("12 refine training")
        path_counts["refine_train"], kernel_ms["per_refine_train_step_ms"] = refine_training(
            dev, workdir)
        at("20 compiled training")
        repeat_summaries = {}
        path_counts.update(compiled_training(dev, repeat_summaries))
        at("21 compiled mesh step")
        path_counts.update(compiled_mesh_step(dev))
        at("22 training run to run")
        path_counts.update(training_repeats(dev, repeat_summaries))
        at("14 file pipeline")
        path_counts["file_pipeline"] = file_pipeline(dev, workdir, direct)
        at("16 model options")
        path_counts.update(model_options(dev, workdir, rng))
        at("17 two-stage demo")
        path_counts.update(two_stage(dev, workdir))
        at("18 model axis")
        path_counts.update(model_axis(dev, workdir))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    at("15 report")
    # 15. report
    print(card_line())
    kern = []
    for r in rows:
        launch_name = LAUNCH_NAMES[r["name"]]
        by_path = ({} if launch_name is None else
                   {path: c[launch_name] for path, c in path_counts.items()})
        if launch_name is not None and sum(by_path.values()) <= 0:
            raise AssertionError(f"kernel {r['name']} was launched on no driven path")
        kern.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": TPU_KERNELS[r["name"]],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            # the whole fused pool at the row's site beside the unfused pool
            **{k: v for k, v in r.items() if k.startswith("pool_")},
            **{k: r[k] for k in ROW_EXTRAS if k in r},
            **{k: r[k] for k in ROW_NOTES if k in r},
            **{k: v[launch_name] for k, v in kernel_ms.items() if launch_name in v},
        })
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
