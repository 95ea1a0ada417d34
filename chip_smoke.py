#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nrhints_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compile every kernel from nrhints_torch/csrc with nvcc (one nvcc
   per source, in parallel, all before phase 3, so no build runs beside a
   timed phase) and print each kernel's registers, shared memory and
   spills;
3. kernels: run kernels A (SDF core), B (march round machinery), C
   (shadow final sweep), D and E (the SDF stash op's forward and backward),
   F and G (the reflectance trunk's stash op), H (the SDF core's recompute
   backward) and I and J (the trunk's forward and recompute backward) at
   the shapes of one 512-ray chunk or train step of the full-width model,
   hold each against its plain PyTorch version on the same inputs (E, G, H
   and J also against a second run, bit for bit), and time both with CUDA
   events beside the kernel's bound; A and D by device time from one
   profiled call each, beside the bound and their design's byte floor; E's
   chain (E1) and dW passes by device time from one profiled call, each
   beside its own bound, and H's H1, H2 and dW passes the same way; F and
   I, G's chain (G1) and dW passes, and J's recompute pass (J1), chain (J2)
   and dW passes the same way, with each design's byte floor;
4. eval path: render one 128x128 view of the nr-hints model (random
   weights from a fixed seed) with Evaluator.render_image on the card
   (the first call runs the eager sweep and captures it as a CUDA graph;
   a second call replays the graph), check the outputs, the launches of
   both calls, and the replay's images against the eager sweep's bit for
   bit, time the replay, the eager sweep and the first call, then render
   64 of its pixels on the CPU (plain versions) and compare;
4b. the same view with eval_reflectance_impl="pallas" (kernel I for the
   trunk), through its view graph as phase 4: its launches, and its images
   against phase 4's;
5. train path: train the nr-hints-cam-opt model at full width on 512-ray
   PixelSampler batches from 8 views of the procedural scene (3 warm-up
   steps, 20 timed), check the loss, that the parameters moved and the
   launches per step, profile one step, and hold one 64-ray step's
   gradients on the card against the same step on the CPU;
6. recompute train path: the same under core_backward="recompute"
   (kernels A, H, I, J instead of D, E, F, G) on the same batches, 3
   warm-up steps and 10 timed, with the same checks;
7. round-4 march views: the view of phase 4 with the monolithic marches
   (kernel M for the camera rays, N for the shadow rays) and with the
   split march (K then L for the camera rays, M then C for the shadow
   rays, both by the rank merge), each through its view graph as phase 4:
   launches, and images against phase 4's; one profiled view (a replay)
   of each and of phase 4b;
8. round-4 train path: nr-hints-cam-opt with the monolithic marches, 3
   warm-up steps and 5 timed, with phase 5's checks (M and N once per step);
9. training entry point: ``python -m nrhints_torch``'s main, in this
   process, trains nr-hints-cam-opt at full width for 30 steps on a
   procedural scene written to disk (log, checkpoint at 20, video), writes
   the mesh, registers, renders and scores both test views; its files and
   every kernel's launches are checked, and a second main resumes at step
   20 bit for bit and logs step 30's loss again; it prints the Trainer's
   own rays/s beside phase 5's timed step and what a registration, a test
   view, the mesh and a video frame take, a registration's device busy
   time and idle share from one profiled call, and the parser's seconds a
   frame on 512x512 RGBA PNGs written under the Paeth row filter and under
   none (the scene above is written under none).  Its registrations and
   views run as CUDA graphs;
10. the one-dispatch paths as CUDA graphs: (a) 16 train steps of phase 5's
   configuration through make_train_step_scan (one graph) against 16 eager
   steps from the same state, batches and generators (params, Adam's state
   and the last metrics), s/step and rays/s of both, device busy and idle
   share of one profiled dispatch; (b) the same at K = 2 under
   core_backward="recompute" and under the round-4 monolith; (c) a test
   view's registration through its graph against the eager loop over 50
   steps, and a full 500-step registration timed; (d) phase 9's main with
   parallel.steps_per_dispatch=10: its logs and checkpoint at the same
   crossings, its losses against phase 9's, its launches exactly, and a
   resumed run;
11. data parallelism over ranks (``--data-parallel``: 11(a)-(c) alone);
12. the unfused renderer and what rides on it (``--offpath``: alone);
13. core_backward="stash_all" (``--stash-all``: alone): (a) D's and E's
   variants, which also stash and read the reverse sweep's u_i and g_enc,
   at phase 3's shapes against plain D (bit for bit where they share
   outputs) and their plain versions, timed and profiled beside plain D's
   and E1's device time; (b) 16 train steps as one CUDA graph against 16
   eager steps, bit for bit, under "stash" and "stash_all" in one call
   (s/step, peak device memory, idle share); (c) a registration through
   its graph against the eager loop; (d) a fake checkpoint of the original
   PyTorch code at full width imported by ``python -m
   nrhints_torch.import_ckpt``'s main, and the Trainer resumed from it on
   the card for 5 steps.
14. march_dtype="float32" (``--march-f32``: alone): (a) the f32 instances
   of C, K, L, M and N at phase 3's shapes against their plain f32
   versions, L = B's steps between K's sweeps, M = L(K(.)) and N = C(M(.))
   bit for bit, each timed and profiled beside the bf16 instance and its
   f32 bound; (b) the full-width view at f32 through its graph on the
   shipping route, the round-4 monolith and the split march: exact
   launches, graph against eager bit for bit, 64 pixels against the CPU;
   (c) a K = 16 graph of f32-march stash steps against its eager steps;
15. sample-axis sharding (``--sample-axis``: alone): (a) two gloo ranks on
   the card as a 1 x 2 ('data', 'sample') grid, the marches flatten-sharded
   (shipping) or sample-sharded (fused_kernels="off") against the same
   marches with no grid, 3 eager steps against the world-1 gradients;
   (b) where four cards are visible (``--chips 4``), four NCCL ranks as a
   2 x 2 grid, a K = 16 graph holding the all-gathers against its eager
   steps;
16. the SDF core at compute_dtype="float32" and stash_dtype="float32"
   (``--core-f32``: alone): (a) A's and H's f32 instances and D's, E's and
   their stash_all variants' instances at f32 operands and stash, f32
   operands and a bf16 stash, and bf16 operands and an f32 stash, at phase
   3's 65,536 points against their plain versions (D = A bit for bit; E and
   H repeat bit for bit; f32 E against f32 H), each timed beside the bf16
   instance's device time and its bound; (b) fused_sdf_value_feat_grad at
   compute_dtype="float32" under each backward schedule and
   fused_sdf_value_feat_grad_stash at f32 stashes against autograd over the
   plain forward, with the launches of every f32 instance.
17. the reflectance trunk at compute_dtype="float32" and
   stash_dtype="float32" (``--trunk-f32``: alone): (a) F's and G's
   instances at the same three dtype pairs and I's and J's f32 instances at
   phase 3's 65,536 points and full width against their plain versions (I =
   F, G and J repeat, J = G at F's f32 stash, bf16 operands with an f32
   stash = the bf16 pair, all bit for bit; J also against the wholly plain
   backward by the norm), each timed beside the bf16 instance's device time
   and its bound; (b) fused_mlp_apply at compute_dtype="float32" under each
   backward schedule, fused_mlp_apply_stash at each dtype pair and with
   bwd_impl="xla", and fused_reflectance_forward at compute_dtype="float32"
   against autograd over the plain forward (at the kernels' own ReLU masks,
   and wholly plain by the norm), with the launches of every f32 instance.
18. the SDF above the presets' widths (``--wide-sdf``: alone):
   nr-hints-cam-opt at sdf_network.d_hidden=512 on its default routes: (a)
   A's, D's, E's and H's wide instances and D's and E's stash_all variants'
   at phase 3's 65,536 points, and at d_out_feat=512, multi_res=12, against
   their plain versions (D = A, the variant = D, E and H repeat, E without
   its dW passes, bit for bit), and C's, K's, L's, M's and N's wide bf16
   and f32 instances at phase 3's 512 rays (L = B/K, M = L(K), N = C(M)
   bit for bit under both merges), each by device time beside the 256-wide
   instance's and its bound; (b) a K = 16 graph of wide stash steps against
   its eager steps, a 64-ray step's gradients against the CPU, one
   recompute and one stash_all step, a profiled monolith step and the split
   and f32 routes' steps, launches exact; (c) a 128x128 view through its
   graph on the shipping route and on the monolith, each against its eager
   sweep and 64 pixels on the CPU; (d) python -m nrhints_torch's main for
   10 steps; (e) an SDF 528 wide and one with a 144-wide encoding raise
   NotImplementedError at march_dtype="float32" before any launch, at the
   march kernels (kernel C in the shadow march): their bf16 huge class
   takes them (phase 23).
19. the reflectance trunk above the presets' widths (``--wide-trunk``:
   alone): nr-hints-cam-opt at sdf_network d_hidden 512 and d_out_feat 512
   and reflectance_network d_hidden 512 (the trunk 617 -> 4 x 512 -> 3):
   (a) F's, G's, I's and J's wide instances, bf16, f32 and F's and G's
   mixed pairs, at phase 3's 65,536 points against their plain versions
   (I = F, J = G at F's stash, G and J repeat, bit for bit; J also against
   the wholly plain backward by the norm), each by device time beside the
   256-wide instance's and its bound, and the f32 instances through the
   trunk's entry points; (b) a K = 16 graph of stash steps against its
   eager steps, a 64-ray step's gradients against the CPU, one recompute
   and one stash_all step, launches exact; (c) a 128x128 view with
   eval_reflectance_impl="pallas" through its graph, against its eager
   sweep and 64 pixels on the CPU; (d) python -m nrhints_torch's main for
   10 steps; (e) a trunk 528 wide and one with 661 inputs raise
   NotImplementedError before any launch.
20. march geometries other than 64 + 4 x 16 (``--march-geometry``: alone;
   the plain run runs it so, in a process of its own):
   the run-time geometry instances of B, K, L, M and N at six geometries
   (rounds x n_new: 2 x 32, 8 x 8, 3 x 16, 5 x 12, 1 x 64, 1 x 126) on
   phase 3's 512 rays, bf16 and f32 march weights, at the 256-wide SDF and
   at d_hidden 512: (a) each against its plain version, L = B's steps
   between K's sweeps, M = L(K(.)) and N = C(M(.)) bit for bit under both
   merges, each by device time beside the 64 + 4 x 16 instance's and its
   bound; (b) fused_importance_z and fused_shadow_tau on every route, each
   against the plain march, with exact launches; (c) geometries out of the
   range raise NotImplementedError before any launch.
21. the SDF core's wide f32 instances (``--wide-core-f32``: alone; the plain
   run runs it so, in a process of its own): phase 16 at d_hidden 512 and
   multi_res 11 (a 69-wide encoding): (a) A's and H's wide f32 instances and
   D's, E's and their stash_all variants' at every (operand, stash) dtype
   pair with an f32 in it, at phase 3's 65,536 points against their plain
   versions, with phase 16's identities, each by device time beside the
   wide bf16 instance's and the 64-point instance's of the same dtypes and
   its f32 bound; (b) both entry points at every (compute_dtype,
   stash_dtype, stash_us) against autograd, launches exact;
22. networks deeper than the kernels' parameter tables (``--deep``: alone;
   the plain run runs it so, in a process of its own): nr-hints-cam-opt at
   the presets' widths with 20 SDF layers and a 20-layer reflectance trunk:
   (a) A, D, E, H and D's and E's variants at bf16 and f32, F, G, I, J, and
   C, K, L, M, N at bf16 and f32 march weights, at phase 3's shapes against
   their plain versions with the identities (L = B/K, M = L(K), N = C(M) bit
   for bit), each by device time beside the 8-layer instance's; (b) a
   K = 16 graph of stash steps, a recompute, a stash_all and a split-route
   step, and a view on the shipping route and on the monolith, each with
   exact launches, s/step or s/view and the device idle share.
23. the SDF above the wide class (``--huge-core``: alone; the plain run
   runs it after phases 21 and 22 in their process): nr-hints-cam-opt at
   sdf_network.d_hidden=1024 on its default routes: (a) A's, D's, E's and
   H's huge instances and D's and E's stash_all variants' at phase 3's
   65,536 points, and at d_hidden 256 with multi_res 24 (an encoding 147
   wide, padded 160), against their plain versions (D = A, the variant = D,
   E and H repeat, E without its dW passes, bit for bit); every huge march
   entry point equal to the narrow instance bit for bit at phase 3's SDF,
   and C's, K's, L's, M's and N's huge instances at phase 3's 512 rays at
   both SDFs against their plain versions (L = B/K, M = L(K), N = C(M) bit
   for bit under both merges) and K-N's run-time geometry ones at 5 x 12;
   each by device time beside the wide instance's at d_hidden 512 in the
   same call and its bound; (b) a K = 16 graph of stash steps against its
   eager steps, a 64-ray step's gradients against the CPU, one recompute,
   one stash_all, one monolith and one split step, launches exact, s/step
   and idle shares; (c) 128x128 views through their graphs on the default
   route and the monolith, each against its eager sweep and 64 pixels on
   the CPU; (d) python -m nrhints_torch's main for 10 steps; (e) the same
   SDF at march_dtype="float32" and the core's entry points at
   compute_dtype="float32" or stash_dtype="float32" raise
   NotImplementedError naming item 15 before any launch.
The run prints its total seconds on a line of its own.
Phase 3 also holds kernels K (initial march sweep), L (refinement rounds),
M (K and L in one kernel) and N (M and C's final sweep in one kernel), and
B under the rank merge, against their plain versions, L = B's steps between
K's sweeps, M = L(K(.)) and N = C(M(.)) bit for bit (N under both merges),
and times B (the 4 steps of one march), C, K, L, M and N by device time from
one profiled call each.  C and K-N sweep on 4-ray blocks through the row
engine (csrc/mma_rows.cuh); B and the rounds of L-N run one warp a ray.  Its
inputs (march_chunk) are shared with scripts/compare_march.py and
scripts/probe_march_parts.py.
It prints a {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12  # f32 peak outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

# Tolerances, each as max |kernel - plain| <= tol * max(1, max |plain|).
# A: both sides round the dot operands to bf16 but accumulate in another
# order, so an activation near a bf16 rounding boundary can round the other
# way and move later layers by a few bf16 ulps.  B: the merge is exact
# (same comparisons, so z and sdf must match bit for bit); the draw sums in
# the same order on both sides, so new_z differs only by exp/log/division
# ulps.  C: as A, plus the bf16 activations between layers.
# D, F and I: as A.  E, G, H and J: each gradient against its own scale;
# the backward chains twice as many bf16-operand products as the forward,
# and the dW sums over the points run in another order (H's plain version,
# autograd, also rounds each dot's result to bf16 where H rounds operands).
# J's plain version recomputes the z_i in its own summation order, and a z_i
# within rounding of 0 takes the other side of the ReLU there: that point's
# dx then moves by a whole unit's share (51 flips among 67M z_i moved dx by
# 6.9e-2 of its scale in a CPU trial).  So J is held entry by entry (2e-2 of
# each gradient's scale) against the plain backward at the forward's own
# z_i (kernel I's, which J recomputes bit for bit), and against the wholly
# plain backward by the relative norm of the error, 2e-2 per gradient.
# B's last-round step merges its draws in: its z equals the plain merge of
# the kernel's own draw step bit for bit, and the plain last step's z within
# B's tolerance.  K: as A.  N: as C.  L: bit for bit equal to its schedule
# run as kernel B steps between kernel K sweeps, so L is exactly B's
# machinery and K's sweep, each held to its plain version above; M = L(K(.))
# and N = C(M(.)) bit for bit (one kernel template, whose sweeps give a row
# the same floats wherever it lies in a pass).  Against the wholly plain marches, L's and M's z are sorted,
# keep every stratified sample, and at least Z_NN_SHARE of their samples lie
# within 1e-4 of a sample of the plain version: where a ray's pdf is nearly
# uniform (random weights, most of the ray far from the surface), a cdf
# value and the u grid nearly coincide, so a bf16 rounding flip in a sweep
# sends a draw to the next interval and later rounds draw around it; phase 3
# prints the same shares for the plain march on the card against the plain
# march on the CPU (two summation orders of one program).  B under the rank
# merge: z equal to the bitonic network's bit for bit.
TOL = {"sdf_core_fwd": 1e-2, "round_machinery": 1e-4, "shadow_final": 1e-2, "sdf_stash_fwd": 1e-2,
       "sdf_stash_bwd": 2e-2, "mlp_stash_fwd": 1e-2, "mlp_stash_bwd": 2e-2, "sdf_core_bwd": 2e-2,
       "mlp_fwd": 1e-2, "mlp_bwd": 2e-2, "march_sweep": 1e-2, "shadow_march": 1e-2}
Z_TOL, Z_NN_SHARE = 1e-4, 0.75
# The CPU re-render of 64 pixels runs every plain version on the host: its
# march sweeps and core sum in other orders, so bf16 rounding flips move a
# few samples; the composite absorbs that to well below these bounds.
CPU_TOL = {"rgb": 2e-2, "depth": 2e-2, "shadow_map": 2e-2}
# The 64-ray train step on the card against the CPU, every gradient leaf
# against its own scale: the kernels and the plain versions sum in other
# orders, so bf16 rounding flips (and a few march samples they move) shift
# each gradient by a few per cent of its largest entry at most.
GRAD_TOL = 5e-2
# Phase 11's ranks against the world-1 step on the card, the same kernels on
# the same params: a rank's dW passes sum its 256 rays, so only the order of
# the sums differs (PR 14's runs read 5.9e-6 to 8.7e-6 of a leaf's scale).
# Faults in the global loss (a mean of per-rank means, a metric share left
# out) move a leaf by far more.  The params after several Adam steps drift
# further and keep GRAD_TOL.
DP_GRAD_TOL = 1e-4
TRAIN_STEPS, TRAIN_WARMUP = 20, 3
RECOMPUTE_STEPS = 10
ROUND4_STEPS = 5
# Phase 9's resumed run replays steps 21-30 from the step-20 checkpoint with
# the same batches (the sampler's restored streams) and jitter (seeded by
# the step), and the kernels repeat bit for bit; PyTorch's backward of the
# pose table's gather may accumulate in another order run to run, and Adam
# carries such a rounding through 10 steps, so step 30's loss is held to
# 1e-4 of itself (the run prints the difference).
RESUME_TOL = 1e-4
# Device-time groups of a profiled view or train step: (substring of the
# kernel's name, group), the first match wins.  A, D and H1 are the modes
# of the 64-point forward of csrc/sdf_fwd.cuh, E1 and H2 of the 64-point
# chain of csrc/sdf_bwd.cuh; D's and E1's stash_all variants (phase 13) are
# the forward's fourth mode and the chain's third; I, F and J1 the three
# modes of the trunk's forward in csrc/mlp_stash.cu, whose one chain kernel
# is G1 in a stash step and J2 in a recompute step (CORE_MODES, by template
# arguments after the operand and stash types: core_group names each bf16
# instance as before and the f32 and mixed instances of phases 16 and 17 by
# their dtypes).  NCCL's kernels (phase 11) have their own group.
DW_GROUP = "dW passes of E/G/H/J (dw_sum.cuh)"
D_ALL_GROUP = "kernel D stash_all variant sdf_stash_all_fwd"
E1_ALL_GROUP = "kernel E stash_all variant sdf_stash_all_bwd (E1)"
TRUNK_CHAIN_GROUP = "trunk chain: G1, or J2 after J1"
# The SDF core's and the trunk's kernel templates: (template, the arguments
# after <T, S>) -> (the bf16 instance's group, the kernel's label in an f32
# or mixed instance's group, core_f32_group).
CORE_MODES = {
    ("sdf_core_fwd_kernel", "0"): ("kernel A sdf_core_fwd", "kernel A"),
    ("sdf_core_fwd_kernel", "1"): ("kernel D sdf_stash_fwd", "kernel D"),
    ("sdf_core_fwd_kernel", "2"): ("kernel H, forward pass (H1)", "kernel H1"),
    ("sdf_core_fwd_kernel", "3"): (D_ALL_GROUP, "kernel D stash_all"),
    ("sdf_bwd_chain_kernel", "false, false"): ("kernel E sdf_stash_bwd (E1)", "kernel E1"),
    ("sdf_bwd_chain_kernel", "true, false"): ("kernel H chain (H2)", "kernel H2"),
    ("sdf_bwd_chain_kernel", "false, true"): (E1_ALL_GROUP, "kernel E1 stash_all"),
    ("mlp_fwd_kernel", "0"): ("kernel I mlp_fwd", "kernel I"),
    ("mlp_fwd_kernel", "1"): ("kernel F mlp_stash_fwd", "kernel F"),
    ("mlp_fwd_kernel", "2"): ("kernel J, recompute pass (J1)", "kernel J1"),
    ("mlp_bwd_chain_kernel", ""): (TRUNK_CHAIN_GROUP, "trunk chain"),
}
_CORE_KERNEL = re.compile(
    r"(sdf_core_fwd_kernel|sdf_bwd_chain_kernel|mlp_fwd_kernel|mlp_bwd_chain_kernel)<([\w:]+), ([\w:]+)(?:, ([a-z0-9, ]+))?>")
# The SDF core's wide bf16 instances (phase 18): (template, its arguments
# after <T, S>) -> group; each named "kernel X <launch counter> ..." where
# it has one.  Its f32 and mixed instances (phase 21) take wide_group's
# "kernel A wide float32/float32".
WIDE_MODES = {
    ("sdf_core_fwd_wide_kernel", "0"): "kernel A sdf_core_fwd_wide",
    ("sdf_core_fwd_wide_kernel", "1"): "kernel D sdf_stash_fwd_wide",
    ("sdf_core_fwd_wide_kernel", "2"): "kernel H wide, forward pass (H1)",
    ("sdf_core_fwd_wide_kernel", "3"): "kernel D' sdf_stash_all_fwd_wide",
    ("sdf_bwd_chain_wide_kernel", "false, false"): "kernel E sdf_stash_bwd_wide (E1)",
    ("sdf_bwd_chain_wide_kernel", "true, false"): "kernel H wide chain (H2)",
    ("sdf_bwd_chain_wide_kernel", "false, true"): "kernel E' sdf_stash_all_bwd_wide (E1)",
}
_WIDE_KERNEL = re.compile(r"(sdf_core_fwd_wide_kernel|sdf_bwd_chain_wide_kernel)<([\w:]+), ([\w:]+), ([a-z0-9, ]+)>")
# The SDF core's huge instances (phase 23, bf16 only): (template, its
# arguments after <T, S>) -> group.
HUGE_MODES = {
    ("sdf_core_fwd_huge_kernel", "0"): "kernel A sdf_core_fwd_huge",
    ("sdf_core_fwd_huge_kernel", "1"): "kernel D sdf_stash_fwd_huge",
    ("sdf_core_fwd_huge_kernel", "2"): "kernel H huge, forward pass (H1)",
    ("sdf_core_fwd_huge_kernel", "3"): "kernel D' sdf_stash_all_fwd_huge",
    ("sdf_bwd_chain_huge_kernel", "false, false"): "kernel E sdf_stash_bwd_huge (E1)",
    ("sdf_bwd_chain_huge_kernel", "true, false"): "kernel H huge chain (H2)",
    ("sdf_bwd_chain_huge_kernel", "false, true"): "kernel E' sdf_stash_all_bwd_huge (E1)",
}
_HUGE_KERNEL = re.compile(r"(sdf_core_fwd_huge_kernel|sdf_bwd_chain_huge_kernel)<[\w:]+, [\w:]+, ([a-z0-9, ]+)>")
# The trunk's wide instances (phase 19): their templates, grouped by the
# label of the 64-point template's mode (CORE_MODES) and their dtypes,
# wide_group: "kernel F wide bfloat16/bfloat16".
_WIDE_TRUNK_KERNEL = re.compile(r"(mlp_fwd_wide_kernel|mlp_bwd_chain_wide_kernel)<([\w:]+), ([\w:]+)(?:, (\d))?>")
# The march template's instances: (SWEEP, ROUNDS, FINAL) template
# arguments, kernel, C entry point; and the device-time groups of the march
# kernels' wide instances (phase 18), "kernel K wide march_sweep_wide" and
# "kernel K f32 wide march_sweep_f32_wide" for K.
MARCH_TEMPLATES = (("false, false, true", "C", "shadow_final"), ("true, false, false", "K", "march_sweep"),
                   ("false, true, false", "L", "march_rounds"), ("true, true, false", "M", "importance_march"),
                   ("true, true, true", "N", "shadow_march"))
WIDE_MARCH_GROUPS = tuple((f"march_kernel{t}<{args}", f"kernel {k}{' f32' if t == '_f32_wide' else ''} wide {fn}{t}")
                          for t in ("_wide", "_f32_wide") for args, k, fn in MARCH_TEMPLATES)
# The march kernels' huge instances (phase 23): "kernel K huge march_sweep_huge".
HUGE_MARCH_GROUPS = tuple((f"march_kernel_huge<{args}", f"kernel {k} huge {fn}_huge") for args, k, fn in MARCH_TEMPLATES)
STEP_GROUPS = (
    ("dw_partial", DW_GROUP), ("dw_reduce", DW_GROUP), ("colsum", DW_GROUP),
    ("round_machinery", "kernel B round_machinery"),
    ("march_kernel<false, false, true", "kernel C shadow_final"),
    ("march_kernel<true, false, false", "kernel K march_sweep"),
    ("march_kernel<false, true, false", "kernel L march_rounds"),
    ("march_kernel<true, true, false", "kernel M importance_march"),
    ("march_kernel<true, true, true", "kernel N shadow_march"),
    ("march_kernel_f32<false, false, true", "kernel C f32 shadow_final_f32"),
    ("march_kernel_f32<true, false, false", "kernel K f32 march_sweep_f32"),
    ("march_kernel_f32<false, true, false", "kernel L f32 march_rounds_f32"),
    ("march_kernel_f32<true, true, false", "kernel M f32 importance_march_f32"),
    ("march_kernel_f32<true, true, true", "kernel N f32 shadow_march_f32"),
    *WIDE_MARCH_GROUPS,
    *HUGE_MARCH_GROUPS,
    ("nccl", "NCCL collectives"),
)
# The round-4 march configurations of phases 7 and 8.
MONOLITH = {"march_sweep_impl": "pallas", "march_rounds_impl": "pallas", "shadow_split": False}
SPLIT = {"importance_split": True, "march_sweep_impl": "pallas", "march_rounds_impl": "pallas", "march_merge": "rank"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(kernel_outs, plain_outs) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |plain|)) over outputs."""
    abs_e = rel_e = 0.0
    for k, p in zip(kernel_outs, plain_outs):
        if k is None:
            continue
        e = (k.float() - p.float()).abs().max().item()
        abs_e = max(abs_e, e)
        rel_e = max(rel_e, e / max(1.0, p.abs().max().item()))
    return abs_e, rel_e


def grad_err(kernel_outs, plain_outs) -> tuple[float, float]:
    """(max abs error, max over outputs of error / max |plain|): gradients
    are compared against their own scale, which can be far below 1."""
    abs_e = rel_e = 0.0
    for k, p in zip(kernel_outs, plain_outs):
        e = (k.float() - p.float()).abs().max().item()
        abs_e = max(abs_e, e)
        rel_e = max(rel_e, e / max(p.abs().max().item(), 1e-30))
    return abs_e, rel_e


def norm_err(kernel_outs, plain_outs) -> tuple[float, float]:
    """(max abs error, max over outputs of |kernel - plain| / |plain| in
    the 2-norm): how phase 22 holds a bf16 instance past the parameter
    tables' depth, where a bf16 rounding flip in one layer crosses every
    later one (DEEP_SDF)."""
    abs_e = rel_e = 0.0
    for k, p in zip(kernel_outs, plain_outs):
        d = k.float() - p.float()
        abs_e = max(abs_e, d.abs().max().item())
        rel_e = max(rel_e, d.norm().item() / max(p.float().norm().item(), 1e-30))
    return abs_e, rel_e


def tree_to(tree, dev):
    """A detached copy of a nested dict of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.detach().clone().to(dev)


def train_snapshot(state) -> dict:
    """A copy of a train state: its step, every parameter leaf and Adam's
    state of each, by the leaf's path."""
    from nrhints_torch.utils import tree_items

    out = {"step": state.step}
    for name, t in tree_items(state.params):
        out[name] = t.detach().clone()
        for k, v in state.optimizer.state.get(t, {}).items():
            out[f"{name} {k}"] = v.detach().clone()
    return out


def train_restore(state, snap: dict) -> None:
    """Copy a ``train_snapshot`` back into the state's own tensors (a
    captured graph reads them), Adam's state included; Adam's state that the
    snapshot did not have yet is zeroed, as a fresh optimizer starts it."""
    import torch

    from nrhints_torch.utils import tree_items

    state.step = snap["step"]
    with torch.no_grad():
        for name, t in tree_items(state.params):
            t.copy_(snap[name])
            for k, v in state.optimizer.state.get(t, {}).items():
                if f"{name} {k}" in snap:
                    v.copy_(snap[f"{name} {k}"])
                else:
                    v.zero_()


def snapshot_err(a: dict, b: dict) -> tuple[float, str]:
    """(largest |a - b| over an entry's leaf's max |b|, that entry) over two
    snapshots or two dicts of tensors; 0.0 means equal bit for bit."""
    import torch

    if sorted(a) != sorted(b):
        raise AssertionError(f"snapshots of different trees: {sorted(a)} vs {sorted(b)}")
    worst, where = 0.0, ""
    for k in a:
        if k == "step":
            if a[k] != b[k]:
                return float("inf"), k
            continue
        x, y = a[k].float(), b[k].float()
        if torch.equal(x, y):
            continue
        e = (x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
        if e > worst:
            worst, where = e, k
    return worst, where


def core_group(key: str) -> str | None:
    """The group of an SDF core or trunk kernel by its name (CORE_MODES),
    else None: the bf16 instance's group, or core_f32_group's label of an
    f32 or mixed instance."""
    trunk = _WIDE_TRUNK_KERNEL.search(key)
    if trunk is not None:
        label = CORE_MODES[(trunk.group(1).replace("_wide", ""), trunk.group(4) or "")][1]
        t, s = ("bfloat16" if "bfloat16" in a else "float32" for a in (trunk.group(2), trunk.group(3)))
        return wide_group(label, t, s)
    huge = _HUGE_KERNEL.search(key)
    if huge is not None:
        return HUGE_MODES.get((huge.group(1), huge.group(2)))
    wide = _WIDE_KERNEL.search(key)
    if wide is not None:
        t, s = ("bfloat16" if "bfloat16" in a else "float32" for a in (wide.group(2), wide.group(3)))
        if t == s == "bfloat16":
            return WIDE_MODES.get((wide.group(1), wide.group(4)))
        return wide_group(CORE_MODES[(wide.group(1).replace("_wide", ""), wide.group(4))][1], t, s)
    m = _CORE_KERNEL.search(key)
    if m is None or (m.group(1), m.group(4) or "") not in CORE_MODES:
        return None
    bf16_group, label = CORE_MODES[(m.group(1), m.group(4) or "")]
    t, s = ("bfloat16" if "bfloat16" in a else "float32" for a in (m.group(2), m.group(3)))
    return bf16_group if t == s == "bfloat16" else core_f32_group(label, t, s)


def device_groups(prof) -> dict[str, float]:
    """Device ms by group from a torch.profiler run; kernels outside
    STEP_GROUPS and the SDF core's count as cuBLAS or other PyTorch
    kernels."""
    import torch

    out: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = core_group(e.key) or next((label for key, label in STEP_GROUPS if key in e.key), None)
        if g is None:
            low = e.key.lower()
            g = "matmul (cuBLAS)" if ("gemm" in low or "cutlass" in low) else "other PyTorch kernels"
        out[g] = out.get(g, 0.0) + us / 1e3
    return out


def profiled_groups(fn, tries: int = 3) -> dict[str, float]:
    """Device ms by STEP_GROUPS group of one call of ``fn`` under
    torch.profiler (after the call's own warm-up elsewhere).  Now and then
    the profiler records no kernel of so short a window (it then reads
    0.0000 ms); then the call is profiled again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = device_groups(prof)
        if groups.keys() - {"matmul (cuBLAS)", "other PyTorch kernels"}:
            break
    return groups


def kernel_device_ms(fn, group: str | tuple, tries: int = 3) -> float:
    """``group``'s device ms in a profiled call of ``fn`` (a tuple of groups:
    their sum): the median of the first ``tries`` profiled calls that record
    every group, out of at most 3 ``tries`` calls (the profiler now and then
    drops or splits a short window's kernels: one smoke run on an H100 lost
    one of J's three kernels in three calls in a row).  Raises if none
    records it."""
    groups = (group,) if isinstance(group, str) else group
    seen = []
    for _ in range(3 * tries):
        g = profiled_groups(fn)
        if all(g.get(k, 0.0) > 0 for k in groups):
            seen.append(sum(g[k] for k in groups))
            if len(seen) == tries:
                break
    if not seen:
        raise RuntimeError(f"no profiled call of {3 * tries} recorded {group!r}")
    return statistics.median(seen)


def launch_device_ms(fn, key: str, tries: int = 3) -> float:
    """Device ms a launch of the kernels whose profiled name holds ``key``
    in a profiled call of ``fn``: their device time over the launches the
    profiler recorded (it now and then drops some of a short window's
    records; the mean of those it kept does not move), the median of the
    first ``tries`` calls that record one, of at most 3 ``tries``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(3 * tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key and e.count]
        if hits:
            seen.append(sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits) / 1e3)
            if len(seen) == tries:
                break
    if not seen:
        raise RuntimeError(f"no profiled call of {3 * tries} recorded a kernel named {key!r}")
    return statistics.median(seen)


def z_err(kernel_z, plain_z, z0) -> tuple[float, float, float, bool]:
    """(max abs error slot by slot, share of the slots within Z_TOL, share
    of the kernel's samples within Z_TOL of a plain sample of their ray,
    whether the kernel's z are sorted and hold every stratified sample z0)."""
    e = (kernel_z - plain_z).abs()
    nn = (kernel_z[:, :, None] - plain_z[:, None, :]).abs().amin(-1)
    ok = bool((kernel_z[:, 1:] >= kernel_z[:, :-1]).all()) and bool(
        (kernel_z[:, :, None] == z0[:, None, :]).any(1).all())
    return e.max().item(), (e <= Z_TOL).float().mean().item(), (nn <= Z_TOL).float().mean().item(), ok


def sweep16(o, d, weights, cfg):
    """A round's 16-sample sweep by kernel K: the samples repeated to 64,
    then the first 16 columns of K's output.  K's 128-row passes hold the
    rows elsewhere than L's 64-row round passes; the row engine gives a row
    the same floats wherever it lies."""
    from nrhints_torch.kernels import march

    def sweep(new_z, *_):
        return march.march_sweep(new_z.repeat(1, 4).contiguous(), o, d, weights, cfg)[:, :16].contiguous()

    return sweep


def view_through_graph(label: str, ev_, params: dict, view, smi: str) -> tuple:
    """A view through ``ev_.render_image`` on the card: the first call (the
    eager sweep, then its capture) and a replay of the view graph, each
    timed and its launches counted, then the eager sweep (``_render_eager``)
    timed, and the graph's images held against the eager sweep's bit for
    bit.  -> (the replay's images, its seconds, the first call's
    launches)."""
    import torch

    from nrhints_torch.kernels import cuda_lib

    H, W = view.h_indices.shape
    times, counts = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        img_ = ev_.render_image(params, view)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(dict(cuda_lib.launch_counts))
    if counts[0] != counts[1]:
        raise AssertionError(f"{label}: the replay counted {counts[1]} launches, the first view {counts[0]}")
    t0 = time.perf_counter()
    eager = ev_._render_eager(params, view)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    graph = ev_._render_graph(params, view)
    unequal = [k for k in eager if not torch.equal(graph[k], eager[k])]
    if unequal or sorted(graph) != sorted(eager):
        raise AssertionError(f"{label}: the view graph's images differ from the eager sweep's on {unequal}")
    log(f"[{label}] {H}x{W} view through the CUDA graph: {times[1]:.4f} s, {H * W / times[1]:.1f} rays/s; the "
        f"eager sweep {eager_s:.4f} s, {H * W / eager_s:.1f} rays/s; the first call (eager sweep, then the "
        f"capture) {times[0]:.4f} s; graph images = eager images bit for bit ({len(eager)} outputs); on {smi}")
    return img_, times[1], counts[0]


def step_grads(cfg, state, camera, buffers, b64, u64: dict, where: str) -> tuple[dict, float]:
    """One 64-ray step from ``state``'s params on ``where`` ("cuda": the
    kernels; "cpu": the plain versions), the pixels ``b64`` and uniforms
    ``u64``.  -> ({leaf name: its gradient on the CPU}, loss)."""
    import torch

    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.train.step import init_train_state, loss_and_grads, make_optimizer
    from nrhints_torch.utils import tree_items

    p_ = tree_to(state.params, where)
    st = init_train_state(p_, make_optimizer(cfg, p_))
    st.step = state.step
    bt = PixelBundle(**{f: getattr(b64, f).to(where) for f in ("h_indices", "w_indices", "poses", "pls",
                                                               "img_indices", "rgb_gt")})
    m_ = loss_and_grads(st, cfg, camera, tree_to(buffers, where), bt,
                        uniforms={k: torch.tensor(v, device=where) for k, v in u64.items()})
    return {name: t.grad.detach().cpu() for name, t in tree_items(p_)}, float(m_["loss"])


def card_cpu_grads(label: str, cfg, state, camera, buffers, b64, u64: dict, relu_by_norm: bool = False) -> float:
    """One 64-ray step from ``state``'s params on the card and on the CPU
    (plain versions), the same pixels ``b64`` and uniforms ``u64``: every
    gradient leaf against its CPU twin's scale, within GRAD_TOL.  With
    ``relu_by_norm`` (phase 23) the ReLU trunk's leaves ("/renderer/color/")
    are held by the relative norm of their error at GRAD_TOL, as J is held
    against the wholly plain backward: a sum that rounds otherwise moves a
    trunk unit across its ReLU's 0, and that point's whole share with it;
    the log gives their largest entry's reading too.  -> the worst leaf's
    error."""
    grads = {where: step_grads(cfg, state, camera, buffers, b64, u64, where) for where in ("cuda", "cpu")}
    worst, worst_leaf, by_max = 0.0, "", (0.0, "")
    for name, g in grads["cpu"][0].items():
        d = grads["cuda"][0][name] - g
        e_max = d.abs().max().item() / max(g.abs().max().item(), 1e-30)
        by_max = max(by_max, (e_max, name))
        e = d.norm().item() / max(g.norm().item(), 1e-30) if relu_by_norm and "/renderer/color/" in name else e_max
        if e > worst:
            worst, worst_leaf = e, name
    how = "the trunk's leaves by the relative norm, the rest by max over scale" if relu_by_norm else "of its scale"
    log(f"[{label}] 64-ray step, card vs CPU plain: loss {grads['cuda'][1]:.6f} vs {grads['cpu'][1]:.6f}; worst "
        f"gradient leaf {worst_leaf}: {worst:.3e} ({how}; tol {GRAD_TOL}) over {len(grads['cpu'][0])} leaves; the "
        f"largest max over scale: {by_max[1]} {by_max[0]:.3e}")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"card and CPU gradients disagree: {worst_leaf} {worst:.3e}")
    return worst


def with_renderer(cfg, **kw):
    """``cfg`` with its renderer's fields replaced."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, renderer=dataclasses.replace(cfg.model.renderer, **kw)))


def grad_norm_err(kernel_outs, plain_outs) -> float:
    """max over outputs of |kernel - plain|_2 / |plain|_2."""
    return max((k.float() - p.float()).norm().item() / max(p.float().norm().item(), 1e-30)
               for k, p in zip(kernel_outs, plain_outs))


def bound(flops: float, bytes_: float, peak_flops: float) -> tuple[float, str]:
    top_bytes, t_bytes = flops / peak_flops * 1e3, bytes_ / H100_BYTES_PER_S * 1e3
    return (top_bytes, "operations") if top_bytes >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(text: str) -> list[str]:
    """Per kernel function: registers, shared memory, spills."""
    out, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
        if fn and ("registers" in line or "spill" in line):
            out.append(f"  {fn}: {line.split(':', 1)[-1].strip()}")
    return out


def log_build(info: dict, t0: float) -> None:
    """Log a build: the wall since ``t0``, each source's seconds, its
    kernels' registers, shared memory and spills."""
    log(f"[build] {time.perf_counter() - t0:.1f} s wall for {', '.join(info)}")
    for name, rec in info.items():
        log(f"[build] csrc/{name}.cu: {rec['seconds']:.1f} s")
        for line in ptxas_summary(rec["ptxas"]):
            log(line)


def march_chunk(dev) -> dict:
    """Phase 3's inputs at the main path's shapes, made on ``dev``: the
    full-width ``nr-hints`` model (random weights from seed 0), one 512-ray
    chunk of the 128x128 view (4 rows through the middle), its camera rays'
    stratified z0, the four steps of kernel B in a march, as (arguments,
    last) (inputs captured from the kernel's own run between plain 16-sample
    sweeps) and the refined z,
    kernel A at the refined sections' midpoints, and the shadow rays from the
    light to the chunk's hits: their z0, sample_dist and refined z (plain
    sweeps and kernel B), inv_s and cos_anneal = 1."""
    import numpy as np
    import torch
    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.camera.rays import generate_rays
    from nrhints_torch.configs.config import nr_hints
    from nrhints_torch.core.sampling import linspace01, stratified_z_vals, transmittance
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.data.synthetic import look_at_pose
    from nrhints_torch.fields.variance import inv_s_from_params
    from nrhints_torch.kernels import core_mlp, march
    from nrhints_torch.render.renderer import _neus_alpha, init_model_params

    cfg = nr_hints()
    mcfg, scfg = cfg.model, cfg.model.sdf_network
    H = W = 128
    focal = 0.5 * W / math.tan(0.5 * 0.8)
    camera = CameraModel(H, W, W / 2.0, H / 2.0, focal, focal, 0.1, 6.0)
    eye = 2.7 * np.array([math.cos(0.7) * math.sin(0.9), math.cos(0.9), math.sin(0.7) * math.sin(0.9)])
    lt, lp = 2.2, 0.6
    light = 3.2 * np.array([math.cos(lt) * math.sin(lp), math.cos(lp), math.sin(lt) * math.sin(lp)])
    pose = torch.tensor(look_at_pose(eye), dtype=torch.float32)
    pl = torch.tensor(light, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    renderer_params = init_model_params(mcfg, gen, device=dev)

    idx = torch.arange(62 * W, 62 * W + 512, device=dev)  # 4 rows through the middle
    chunk = PixelBundle(
        h_indices=(idx // W).float(), w_indices=(idx % W).float(),
        poses=pose.to(dev).expand(512, 4, 4), pls=pl.to(dev).expand(512, 3),
    )
    rays = generate_rays({}, {}, camera, cfg.ray_generator, chunk)
    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    mw = march.march_weights(renderer_params["sdf"], scfg, mcfg.renderer.march_dtype)
    z0 = stratified_z_vals(rays.nears, rays.fars, 64)
    sweep0 = march._mlp_sdf_3d(o[:, None, :] + d[:, None, :] * z0[..., None], mw, scfg)

    # B: the four steps of one march, inputs captured from the kernel's own
    # run; the last merges its draws in.
    steps = []
    z = torch.cat([z0, torch.full((512, 64), march.BIG_Z, device=dev)], -1)
    sdf = torch.cat([sweep0, torch.zeros((512, 64), device=dev)], -1)
    new_z = new_sdf = None
    for i in range(3):
        vn = 64 + 16 * i
        args = (z, sdf, o, d, new_z, new_sdf, None if i == 0 else vn - 16, vn, 64.0 * 2**i)
        steps.append((args, False))
        new_z, z, sdf = march.round_machinery(*args)
        new_sdf = march._mlp_sdf_3d(o[:, None, :] + d[:, None, :] * new_z[..., None], mw, scfg)
    steps.append(((z, sdf, o, d, new_z, new_sdf, 96, 112, 64.0 * 2**3), True))
    z_imp = march.round_machinery(*steps[-1][0], last=True)[1]

    dists = torch.cat([z_imp[:, 1:] - z_imp[:, :-1], torch.full((512, 1), 2.0 / 64, device=dev)], -1)
    x = (o[:, None, :] + d[:, None, :] * (z_imp + dists * 0.5)[..., None]).reshape(-1, 3).contiguous()
    aw = core_mlp.materialize_sdf_weights_full(renderer_params["sdf"], scfg)
    k_out = core_mlp.sdf_core_fwd(aw, x, scfg)

    # The shadow rays, from the light to the chunk's hits.
    sd, _, grads = k_out
    inv_s = inv_s_from_params(renderer_params["variance"])
    alpha = _neus_alpha(sd, grads, d[:, None, :].expand(512, 128, 3).reshape(-1, 3), dists.reshape(-1), inv_s, 1.0)
    alpha = alpha.reshape(512, 128)
    depth = torch.sum((z_imp + dists * 0.5) * alpha * transmittance(alpha), -1, keepdim=True)
    hits = o + d * depth
    sl = pl.to(dev).expand(512, 3).contiguous()
    dl = hits - sl
    norm = torch.linalg.norm(dl, dim=-1, keepdim=True)
    sdist, sdir = (norm / 64).contiguous(), (dl / norm).contiguous()
    z0s = (linspace01(64, device=dev)[None, :] * norm * 0.99).contiguous()
    sz = march.fused_importance_z(renderer_params["sdf"], scfg, sl, sdir, z0s, mlp_dtype=mcfg.renderer.march_dtype,
                                  split=True, sweep_impl="xla", rounds_impl="xla")
    anneal = torch.tensor(1.0, device=dev)
    return dict(cfg=cfg, camera=camera, pose=pose, pl=pl, renderer_params=renderer_params, o=o, d=d, mw=mw, z0=z0,
                steps=steps, x=x, aw=aw, k_out=k_out, sl=sl, sdir=sdir, sdist=sdist, z0s=z0s, sz=sz,
                inv_s=inv_s, anneal=anneal)


def paeth_png_bytes(img):
    """An 8-bit RGBA PNG of ``img`` [H, W, 4] uint8 with every row under
    the Paeth filter (type 4), the one image libraries choose most for
    smooth content."""
    import struct
    import zlib

    import numpy as np

    H, W, C = img.shape
    x = img.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8), ((x - pred) % 256).astype(np.uint8).reshape(H, W * C)], 1)

    def chunk(ctype, data):
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def loader_timing(tmp: Path, smi: str, frames: int = 16, size: int = 512) -> None:
    """Phase 9's loader: ``parse_load_nr_data`` on one train split of
    ``frames`` smooth random RGBA frames at ``size`` x ``size``, written
    once under the Paeth filter and once under none (``write_png``); both
    parses must give the same images, equal to the frames composited over
    white within 1e-6.  Prints seconds a frame of each."""
    import numpy as np

    from nrhints_torch.data.parser import parse_load_nr_data
    from nrhints_torch.data.png import write_png

    rng = np.random.default_rng(0)
    imgs = (np.cumsum(np.cumsum(rng.integers(0, 3, (frames, size, size, 4)), 1), 2) % 256).astype(np.uint8)
    meta = {"camera_angle_x": 0.69, "frames": [
        {"file_path": f"./train/r_{i}", "transform_matrix": np.eye(4).tolist(), "pl_pos": [0.0, 0.0, 4.0]}
        for i in range(frames)]}
    secs, parsed = {}, {}
    for name in ("paeth", "none"):
        root = tmp / f"loader_{name}"
        (root / "train").mkdir(parents=True)
        (root / "transforms_train.json").write_text(json.dumps(meta))
        for i, img in enumerate(imgs):
            if name == "paeth":
                (root / "train" / f"r_{i}.png").write_bytes(paeth_png_bytes(img))
            else:
                write_png(root / "train" / f"r_{i}.png", img)
        t0 = time.perf_counter()
        parsed[name] = parse_load_nr_data(root, splits=["train"]).images
        secs[name] = (time.perf_counter() - t0) / frames
    f = imgs / 255.0
    ref = (f[..., :3] * f[..., 3:] + (1.0 - f[..., 3:])).astype(np.float32)
    err = float(np.abs(parsed["paeth"] - ref).max())
    if not (np.array_equal(parsed["paeth"], parsed["none"]) and err <= 1e-6):
        raise AssertionError(f"the parser's images differ between filters or from the frames: max err {err:.3e}")
    log(f"[entry loader] parse_load_nr_data on {frames} {size}x{size} RGBA frames: {secs['paeth']:.4f} s a frame "
        f"under the Paeth filter, {secs['none']:.4f} s under none (images equal, max err {err:.1e}); on {smi}")


class Timed:
    """Wrap ``cls.name`` for the duration of a ``with``: each call is timed
    on the host clock between two device synchronizations, and counted."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.secs = cls, name, []

    def __enter__(self):
        import torch

        self.orig = orig = getattr(self.cls, self.name)

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def train_entry_phase(smi: str, phase5_step_s: float, tmp: Path) -> dict:
    """Phase 9: ``python -m nrhints_torch``'s main, called in this process so
    the launch counts are readable, trains nr-hints-cam-opt at full width on
    a procedural scene written to disk (8 train, 1 val, 2 test views at
    128x128): one rank on one card (``data_axis_size`` 1, whatever the
    host's count of cards), 512-ray batches, 30 steps, a log every 10 steps, a checkpoint
    at 20, the video (2 + 2 frames) at 30, then the final mesh at resolution
    128 and both test views registered (500 Adam steps each), rendered and
    scored.  Checks the run directory's files and every kernel's launches
    (B-G in every train step, D, E, B and C in every registration step, A,
    B and C in every chunk of a view).  A second main on the same directory
    with end_iter 40 resumes at step 20 from the checkpoint's params, bit for
    bit, and logs step 30's loss again.  ``tmp``: the directory of the
    scene and the runs.  -> what phase 10(d) repeats: the first main's
    argument list and its logged losses by step."""
    import numpy as np
    import torch

    from nrhints_torch.__main__ import main as nrhints_main
    from nrhints_torch.data.synthetic import make_hints_scene
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.train.trainer import Trainer

    H = W = 128
    steps, frames, reg_steps, mesh_res = 30, 4, 500, 128
    t0 = time.perf_counter()
    scene = make_hints_scene(tmp / "scene", 8, 1, 2, H, W, seed=0)
    log(f"[entry] wrote the procedural scene (8 + 1 + 2 views, {H}x{W}) in {time.perf_counter() - t0:.2f} s")
    argv = ["config:nr-hints-cam-opt", "--config.data.path", str(scene), "--config.base-dir", str(tmp / "runs"),
            "--config.model.batch-size", "512", "--config.intervals.log-metrics", "10",
            "--config.intervals.save-ckpt", "20", "--config.intervals.render-video", "30",
            "--config.data.video-frame-num", "2", "--config.final-mesh-resolution", str(mesh_res),
            "--config.parallel.data-axis-size", "1"]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with Timed(Evaluator, "register_view") as reg, Timed(Trainer, "render_test_views") as views, \
            Timed(Trainer, "dump_mesh") as mesh, Timed(Trainer, "render_video") as video:
        t0 = time.perf_counter()
        trainer = nrhints_main(argv + ["--config.model.end-iter", str(steps)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    log(f"[entry] main(): {steps} steps, the video, the mesh and 2 registered test views in {run_s:.2f} s on {smi}; "
        f"launches {launches}")
    run_dir = trainer.log_dir
    lines = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = {r["step"]: r for r in lines if "loss" in r}
    if sorted(train) != [10, 20, 30] or not all(math.isfinite(r["loss"]) and r["rays_per_sec"] > 0
                                                for r in train.values()):
        raise AssertionError(f"metrics.jsonl's train lines are not finite lines at 10, 20, 30: {train}")
    val = [r for r in lines if "val/psnr" in r]
    if len(val) != 1 or not (math.isfinite(val[0]["val/psnr"]) and math.isfinite(val[0]["val/ssim"])):
        raise AssertionError(f"the test views were not scored: {val}")
    if not (run_dir / "ckpt" / "step_0000020" / "state.pt").is_file():
        raise AssertionError("no checkpoint at step 20")
    dumps = run_dir / "test_views" / f"step_{steps:07d}"
    missing = [f for f in ("rgb_000.png", "rgb_001.png", "shadow_map_001.png", "depth_001.npy")
               if not (dumps / f).is_file()]
    frame_dir = run_dir / "video" / f"step_{steps:07d}"
    missing += [f"video {i:03d}.png" for i in range(frames) if not (frame_dir / f"{i:03d}.png").is_file()]
    if missing:
        raise AssertionError(f"missing outputs: {missing}")
    obj = run_dir / "mesh" / f"step_{steps:07d}_res_{mesh_res}.obj"
    n_tris = sum(1 for line in open(obj) if line.startswith("f ")) if obj.is_file() else 0
    if n_tris == 0:
        raise AssertionError(f"no triangles in {obj}")
    if len(reg.secs) != 2:
        raise AssertionError(f"{len(reg.secs)} registrations, expected 2")
    chunks = (H * W // 512) * (2 + frames)
    march = steps + 2 * reg_steps + chunks
    expected = dict({k: 0 for k in launches}, sdf_stash_fwd=steps + 2 * reg_steps,
                    sdf_stash_bwd=steps + 2 * reg_steps, mlp_stash_fwd=steps, mlp_stash_bwd=steps,
                    sdf_core_fwd=chunks, shadow_final=march, round_machinery=8 * march)
    if launches != expected:
        raise AssertionError(f"entry-point launch counts {launches}, expected {expected}")
    log(f"[entry] metrics at steps {sorted(train)}: loss {[round(train[k]['loss'], 5) for k in sorted(train)]}; "
        f"val/psnr {val[0]['val/psnr']:.4f}, val/ssim {val[0]['val/ssim']:.4f}; checkpoint at 20; "
        f"{n_tris} triangles at resolution {mesh_res}; {frames} video frames")
    for k in sorted(train):
        r = train[k]
        log(f"[entry] Trainer's own log at step {k}: {r['rays_per_sec']:.1f} rays/s, "
            f"{1.0 / r['steps_per_sec']:.5f} s/step (the 10 steps before it) on {smi}")
    view_s = (sum(views.secs) - sum(reg.secs)) / 2
    # The host's share of a Trainer step, alone: a batch drawn, copied to
    # the card, and the step's jitter generator.
    dm = trainer.data_manager
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(100):
        dm.next_train_batch().to(trainer.device)
        trainer._jitter_generator(i)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 10.0
    log(f"[entry] the Trainer's host work a step, timed alone over 100 steps (draw a batch, copy it to the card, "
        f"seed the jitter generator): {batch_ms:.3f} ms")
    log(f"[entry] phase 5's timed step in this call: {phase5_step_s:.5f} s/step, {512 / phase5_step_s:.1f} rays/s; "
        f"one registration (500 steps) {reg.secs[0]:.3f} / {reg.secs[1]:.3f} s; one test view (render, metrics, "
        f"dumps) {view_s:.3f} s; the mesh at resolution {mesh_res} {mesh.secs[0]:.3f} s; one video frame "
        f"{video.secs[0] / frames:.3f} s; on {smi}")

    # A registration's device time: the same call, 20 steps, unprofiled
    # and then under torch.profiler (after a warm-up of 5 steps).
    from torch.profiler import ProfilerActivity, profile

    ev, pixels, n = trainer.evaluator, trainer.data_manager.get_test_view(0), 20
    ev.register_view(trainer.state.params, pixels, steps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.register_view(trainer.state.params, pixels, steps=n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.register_view(trainer.state.params, pixels, steps=n)
        torch.cuda.synchronize()
    groups = {k: v / n for k, v in sorted(device_groups(prof).items(), key=lambda kv: -kv[1])}
    busy_ms = sum(groups.values())
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time in a registration")
    log(f"[entry registration] a step: {wall_ms:.3f} ms wall unprofiled, device busy {busy_ms:.3f} ms, idle share "
        f"{1.0 - busy_ms / wall_ms:.3f}; by group (ms a step) "
        + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()) + f"; on {smi}")
    loader_timing(tmp, smi)

    resumed = check_resume("entry resume", argv, run_dir, {k: r["loss"] for k, r in train.items()})
    val40 = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    val40 = [r for r in val40 if "val/psnr" in r and r["step"] == 40]
    views = {"run_dir": run_dir, "base": tmp / "runs", "argv": argv,
             "raygen": {k: v.detach().cpu().clone() for k, v in resumed.state.params["raygen"].items()},
             "means": {k: v for k, v in val40[-1].items() if k.startswith("val/")}}
    return {"argv": argv, "losses": {k: r["loss"] for k, r in train.items()}, "views": views}


def check_resume(label: str, argv: list, run_dir: Path, losses: dict):
    """A second main on ``argv``'s run directory, to step 40: it must load
    the step-20 checkpoint's params bit for bit, log steps 30 and 40, and
    log step 30's loss within RESUME_TOL of ``losses[30]``, the first run's.
    -> the second main's trainer."""
    import torch

    from nrhints_torch.__main__ import main as nrhints_main
    from nrhints_torch.train.trainer import Trainer
    from nrhints_torch.utils import tree_items

    loaded = {}
    load = Trainer._load_ckpt

    def spy(self):
        load(self)
        loaded["step"] = self.global_step
        loaded["params"] = {n: t.detach().cpu().clone() for n, t in tree_items(self.state.params)}

    Trainer._load_ckpt = spy
    try:
        n_lines = len((run_dir / "metrics.jsonl").read_text().splitlines())
        t0 = time.perf_counter()
        resumed = nrhints_main(argv + ["--config.model.end-iter", "40"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        Trainer._load_ckpt = load
    saved = torch.load(run_dir / "ckpt" / "step_0000020" / "state.pt", map_location="cpu", weights_only=True)
    if loaded.get("step") != 20:
        raise AssertionError(f"{label}: the second run started at step {loaded.get('step')}, not 20")
    unequal = [n for n, t in loaded["params"].items() if not torch.equal(t, saved["params"][n])]
    if unequal or sorted(loaded["params"]) != sorted(saved["params"]):
        raise AssertionError(f"{label}: resumed params differ from the step-20 checkpoint: {unequal}")
    again = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()[n_lines:]]
    again = {r["step"]: r for r in again if "loss" in r}
    if sorted(again) != [30, 40]:
        raise AssertionError(f"{label}: the resumed run logged train steps {sorted(again)}, expected [30, 40]")
    rel = abs(again[30]["loss"] - losses[30]) / abs(losses[30])
    log(f"[{label}] second main(): resumed at step 20 with the checkpoint's {len(saved['params'])} params "
        f"bit for bit; ran to 40 in {resume_s:.2f} s; step 30's loss {again[30]['loss']:.7f} against the first "
        f"run's {losses[30]:.7f}: rel {rel:.3e} (tol {RESUME_TOL})")
    if not rel <= RESUME_TOL:
        raise AssertionError(f"{label}: the resumed run's step-30 loss differs: rel {rel:.3e}")
    return resumed


def dispatch_entry_phase(smi: str, tmp: Path, eager_run: dict) -> None:
    """Phase 10(d): phase 9's first main again with
    ``parallel.steps_per_dispatch=10``: three 10-step graph dispatches (the
    first one eager, then captured; two replays), the hooks at the same
    crossings as JAX's trainer (logs at 10, 20 and 30, the checkpoint at
    20, the video at 30), the two test views registered and scored through
    their graphs, the launches of phase 9 exactly (a replay counts its
    capture's launches), each logged loss within RESUME_TOL of phase 9's
    single-step run (the same batches and jitter), and a resumed run."""
    import torch

    from nrhints_torch.__main__ import main as nrhints_main
    from nrhints_torch.kernels import cuda_lib

    steps, k, reg_steps, frames, chunks = 30, 10, 500, 4, 32
    argv = [str(tmp / "runs_k10") if a == str(tmp / "runs") else a for a in eager_run["argv"]]
    argv += ["--config.parallel.steps-per-dispatch", str(k)]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = nrhints_main(argv + ["--config.model.end-iter", str(steps)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    views = chunks * (2 + frames)
    march = steps + 2 * reg_steps + views
    expected = dict({n: 0 for n in launches}, sdf_stash_fwd=steps + 2 * reg_steps, sdf_stash_bwd=steps + 2 * reg_steps,
                    mlp_stash_fwd=steps, mlp_stash_bwd=steps, sdf_core_fwd=views, shadow_final=march,
                    round_machinery=8 * march)
    log(f"[dispatch 10(d)] main() with steps_per_dispatch={k}: {steps} steps, the video, the mesh and 2 registered "
        f"test views in {run_s:.2f} s on {smi}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"steps_per_dispatch={k}: launch counts {launches}, expected {expected}")
    if list(trainer._scan_steps) != [(False, k)]:
        raise AssertionError(f"dispatches built {list(trainer._scan_steps)}, expected [(False, {k})]")
    run_dir = trainer.log_dir
    lines = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = {r["step"]: r for r in lines if "loss" in r}
    if sorted(train) != [10, 20, 30] or len([r for r in lines if "val/psnr" in r]) != 1:
        raise AssertionError(f"steps_per_dispatch={k}: logs at {sorted(train)}, expected [10, 20, 30] and one val")
    if trainer.ckpt_io.available_steps() != [20]:
        raise AssertionError(f"checkpoints at {trainer.ckpt_io.available_steps()}, expected [20]")
    frame_dir = run_dir / "video" / f"step_{steps:07d}"
    if not all((frame_dir / f"{i:03d}.png").is_file() for i in range(frames)):
        raise AssertionError("steps_per_dispatch: video frames missing")
    for s_ in sorted(train):
        r, ref = train[s_], eager_run["losses"][s_]
        rel = abs(r["loss"] - ref) / abs(ref)
        log(f"[dispatch 10(d)] step {s_}: loss {r['loss']:.7f} against phase 9's single-step run's {ref:.7f} (rel "
            f"{rel:.3e}, tol {RESUME_TOL}); the Trainer's own log: {r['rays_per_sec']:.1f} rays/s, "
            f"{1.0 / r['steps_per_sec']:.5f} s/step (the 10 steps before it) on {smi}")
        if not rel <= RESUME_TOL:
            raise AssertionError(f"steps_per_dispatch={k}: step {s_}'s loss differs from the single-step run's")
    check_resume("dispatch 10(d) resume", argv, run_dir, {s_: r["loss"] for s_, r in train.items()})


def train_data(dev, H: int, W: int) -> dict:
    """Phase 5's training data: the nr-hints-cam-opt config, 8 procedural
    views at H x W on ``dev`` and their camera, and ``next_batch(n_rays)``,
    the next PixelSampler batch (512 rays, or its first ``n_rays``)."""
    import torch

    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.configs.config import nr_hints_cam_opt
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.data.sampler import PixelSampler
    from nrhints_torch.data.synthetic import scene_views

    tcfg = nr_hints_cam_opt()
    n_views = 8
    sc = scene_views(n_views, H, W, seed=0)
    sampler = PixelSampler(n_views, H, W, tcfg.model.batch_size)
    images, poses, pls = (torch.tensor(sc[k], device=dev) for k in ("images", "poses", "pls"))

    def next_batch(n_rays=None):
        s_ = sampler.sample_batch()
        img, hi, wi = (torch.as_tensor(a[:n_rays], device=dev) for a in (s_.img_indices, s_.h_indices, s_.w_indices))
        return PixelBundle(h_indices=hi.float(), w_indices=wi.float(), poses=poses[img], pls=pls[img],
                           img_indices=img, rgb_gt=images[img, hi, wi])

    return {"cfg": tcfg, "n_views": n_views, "camera": CameraModel(H, W, W / 2.0, H / 2.0, sc["focal"], sc["focal"],
                                                                    0.1, 6.0),
            "images": images, "poses": poses, "pls": pls, "next_batch": next_batch}


# Phase 11: data parallelism.  The K of the captured dispatch, the eager
# steps of the two-rank runs, and how long spawned ranks may take (each set
# takes under a minute; a rank that fails leaves its group undestroyed, since
# a peer may wait in a collective, and the parent kills the set).
DP_K, DP_EAGER_STEPS, DP_JOIN_S = 16, 3, 300.0


def dp_grads(state) -> dict:
    """Every leaf's gradient, on the host."""
    from nrhints_torch.utils import tree_items

    return {name: t.grad.detach().cpu().clone() for name, t in tree_items(state.params)}


def scaled_err(a: dict, b: dict) -> tuple[float, str]:
    """(largest max |a - b| over max |b| among the leaves, that leaf)."""
    worst, where = 0.0, ""
    for k in b:
        e = (a[k].float() - b[k].float()).abs().max().item() / max(b[k].float().abs().max().item(), 1e-30)
        if e > worst:
            worst, where = e, k
    return worst, where


def spawn_ranks(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes; join them
    within DP_JOIN_S seconds, killing them all on a failure or at the
    deadline, and raise then."""
    import torch

    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_JOIN_S
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks of {fn.__name__} did not finish in {DP_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def dp_rank_steps(rank: int, world: int, backend: str, one_card: bool, start_file: str, out_dir: str) -> None:
    """A rank of phase 11(b) or (c): the start state of ``start_file`` on
    this rank's card, its rows of the same global batches, and either
    DP_EAGER_STEPS eager steps (gloo: each step's gradients and the params
    after it kept) or one DP_K-step dispatch as a CUDA graph (NCCL: the
    first call, then two replays from the same start, the last one timed;
    the params, the last step's gradients and metrics kept)."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    if one_card:  # two "hosts" of one rank each, both on cuda:0
        os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = "1", "0"
    from nrhints_torch.parallel.mesh import initialize_multihost, make_mesh
    from nrhints_torch.utils import resolve_device

    out = Path(out_dir)
    initialize_multihost(f"file://{out / 'rendezvous'}", rank, world, device=resolve_device("cuda"), backend=backend)
    torch.save(dp_steps_body(make_mesh(world, device="cuda"), backend, start_file), out / f"rank{rank}.pt")
    gc.collect()  # the dispatch's graph goes before the group: NCCL keeps a communicator a live graph uses
    torch.cuda.synchronize()
    dist.destroy_process_group()


def dp_steps_body(mesh, backend: str, start_file: str) -> dict:
    """``dp_rank_steps``' work on this rank -> what it keeps."""
    import torch

    from nrhints_torch.parallel.mesh import rank_rows
    from nrhints_torch.train.step import init_train_state, make_optimizer, make_train_step, make_train_step_scan, \
        stack_bundles
    from nrhints_torch.utils import tree_items

    world = mesh.world_size
    blob = torch.load(start_file, map_location=mesh.device, weights_only=False)
    cfg, cam, buffers, params = blob["cfg"], blob["camera"], blob["buffers"], blob["params"]
    state = init_train_state(params, make_optimizer(cfg, params))
    live = [(g["base_lr"], g["lr"]) for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(blob["optimizer"])
    for g, (base, lr) in zip(state.optimizer.param_groups, live):
        g["base_lr"], g["lr"] = base, lr
    state.step = blob["step"]
    start = train_snapshot(state)
    # This rank's rows of each global batch (one host of two ranks, or
    # two hosts of one: rank r takes the r-th block either way).
    rows = [b[rank_rows(mesh, b.h_indices.shape[0] // world)] for b in blob["batches"]]
    res = {"mesh": (mesh.rank, mesh.world_size, mesh.backend, str(mesh.device))}
    if backend == "gloo":
        step_fn = make_train_step(cfg, cam, buffers, state.optimizer, mesh=mesh)
        res["grads"], res["params"], secs = [], [], []
        for i, b in enumerate(rows[:DP_EAGER_STEPS]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b, torch.Generator(device=mesh.device).manual_seed(2000 + i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            res["grads"].append(dp_grads(state))
            res["params"].append({n: t.detach().cpu().clone() for n, t in tree_items(state.params)})
        res["secs"] = secs
    else:
        scan = make_train_step_scan(cfg, cam, buffers, state.optimizer, n_steps=DP_K, mesh=mesh)
        stacked = stack_bundles(rows[:DP_K])
        secs = []
        for _ in range(3):  # the first call (eager, then the capture), then two replays
            train_restore(state, start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = scan(state, stacked, [torch.Generator(device=mesh.device).manual_seed(2000 + i)
                                                   for i in range(DP_K)])
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / DP_K)
        res.update(secs=secs, grads=dp_grads(state),
                   params={n: t.detach().cpu().clone() for n, t in tree_items(state.params)},
                   metrics={k: float(v) for k, v in metrics.items()})
        # One eager step from the start: its gradients against the world-1 gradients.
        train_restore(state, start)
        make_train_step(cfg, cam, buffers, state.optimizer, mesh=mesh)(
            state, rows[0], torch.Generator(device=mesh.device).manual_seed(2000))
        res["first_grads"] = dp_grads(state)
    return res


def dp_rank_views(rank: int, world: int, argv: list, out_dir: str) -> None:
    """A rank of phase 11(d): gloo on the one card, the Trainer of
    ``argv`` (resuming its run directory's checkpoint) registers, renders
    and scores its share of the test views through ``render_test_views``;
    the merged raygen tables and the val/ means kept."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = "1", "0"
    from nrhints_torch.configs.cli import parse_cli
    from nrhints_torch.configs.config import DEFAULT_PRESET, PRESETS
    from nrhints_torch.parallel.mesh import initialize_multihost
    from nrhints_torch.train.trainer import Trainer

    out = Path(out_dir)
    initialize_multihost(f"file://{out / 'rendezvous'}", rank, world, device="cuda", backend="gloo")
    trainer = Trainer(parse_cli(PRESETS, DEFAULT_PRESET, argv), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = trainer.render_test_views(is_final=True)
    torch.cuda.synchronize()
    torch.save({"step": trainer.global_step, "means": means, "secs": time.perf_counter() - t0,
                "raygen": {k: v.detach().cpu().clone() for k, v in trainer.state.params["raygen"].items()}},
               out / f"rank{rank}.pt")
    dist.destroy_process_group()


def data_parallel_phase(smi: str, dev, td: dict, batches: list, tmp: Path, views: dict | None) -> None:
    """Phase 11, data parallelism over ranks (nrhints_torch/parallel/mesh.py):
    (a) rank 0 of a world-1 NCCL group trains phase 10(a)'s steps eagerly
    and as a DP_K-step CUDA graph with its collectives captured, each bit
    for bit against the group-less eager steps, timed, and one dispatch
    profiled; (b) two gloo ranks on this card take DP_EAGER_STEPS eager
    steps of the same 512-ray global batches: equal to each other bit for
    bit after each step, each step's gradients within DP_GRAD_TOL of each
    leaf's scale of the world-1 gradients at the same params, and the
    params within GRAD_TOL of the world-1 steps'; (c) where two cards are
    visible, two NCCL ranks the DP_K-step graph: equal to each other, a
    first eager step's gradients within DP_GRAD_TOL and the params after
    the graph within GRAD_TOL of the world-1 steps'; (d) with ``views`` (phase 9's resumed
    run), two gloo ranks on this card register, render and score phase 9's
    two test views from its step-40 checkpoint: the merged raygen tables
    equal phase 9's single-rank registration bit for bit, the val/ means
    within 1e-6."""
    import shutil

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.parallel.mesh import initialize_multihost, make_mesh
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, loss_and_grads, make_optimizer, make_train_step, \
        make_train_step_scan, stack_bundles
    from nrhints_torch.utils import tree_items

    tcfg, tcam, n_views = td["cfg"], td["camera"], td["n_views"]
    # Phase 10(a)'s start: a fresh seed-0 state after eager warm-up steps,
    # set to step 1000 (the learning rate and cos_anneal_ratio change every
    # step there).
    gen = torch.Generator().manual_seed(0)
    params = {"renderer": init_model_params(tcfg.model, gen, device=dev)}
    params["raygen"], buffers = ray_generator_init(gen, tcfg.ray_generator, n_views, device=dev)
    state = init_train_state(params, make_optimizer(tcfg, params))
    plain = make_train_step(tcfg, tcam, buffers, state.optimizer)
    warm = torch.Generator(device=dev).manual_seed(0)
    for b in batches[-TRAIN_WARMUP:]:
        state, _ = plain(state, b, warm)
    state.step = 1000
    start = train_snapshot(state)
    run = batches[:DP_K]

    def gens():
        return [torch.Generator(device=dev).manual_seed(2000 + i) for i in range(DP_K)]

    def timed(fn, n_steps=DP_K):
        """(fn(), seconds a step over ``n_steps`` steps)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n_steps

    def eager(step_fn):
        m = None
        for b, g in zip(run, gens()):
            _, m = step_fn(state, b, g)
        return m

    m_ref, plain_s = timed(lambda: eager(plain))
    ref = train_snapshot(state)
    per_step = dict(sdf_stash_fwd=1, sdf_stash_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1, round_machinery=8,
                    shadow_final=1)

    # (a) Rank 0 of a world-1 NCCL group.
    initialize_multihost(f"file://{tmp / 'rendezvous_11a'}", 0, 1, device="cuda")
    try:
        mesh = make_mesh(1, device="cuda")
        if (mesh.world_size, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"11(a): a world-1 NCCL mesh expected, got {mesh}")
        train_restore(state, start)
        m_eager, mesh_eager_s = timed(lambda: eager(make_train_step(tcfg, tcam, buffers, state.optimizer,
                                                                    mesh=mesh)))
        err = max(snapshot_err(train_snapshot(state), ref), snapshot_err(m_eager, m_ref))
        if err[0] != 0.0:
            raise AssertionError(f"11(a): the world-1 NCCL eager steps differ from the group-less steps: {err}")
        scan = make_train_step_scan(tcfg, tcam, buffers, state.optimizer, n_steps=DP_K, mesh=mesh)
        stacked = stack_bundles(run)
        expected = {k: v * DP_K for k, v in dict({k: 0 for k in cuda_lib.launch_counts}, **per_step).items()}
        secs = []
        for i in range(3):  # the first call (eager, then the capture), then two replays
            train_restore(state, start)
            cuda_lib.reset_launch_counts()
            (_, m_graph), s_ = timed(lambda: scan(state, stacked, gens()))
            secs.append(s_)
            if dict(cuda_lib.launch_counts) != expected:
                raise AssertionError(f"11(a) dispatch {i}: launches {dict(cuda_lib.launch_counts)}, expected {expected}")
            err = max(snapshot_err(train_snapshot(state), ref), snapshot_err(m_graph, m_ref))
            if err[0] != 0.0:
                raise AssertionError(f"11(a) dispatch {i}: the NCCL graph's steps differ from the group-less steps: "
                                     f"{err}")
        train_restore(state, start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            scan(state, stacked, gens())
            torch.cuda.synchronize()
        groups = device_groups(prof)
        busy = sum(groups.values()) / DP_K
        bs = tcfg.model.batch_size
        log(f"[data-parallel 11(a)] rank 0 of a world-1 NCCL group, {DP_K} stash steps of {bs} rays: group-less eager "
            f"{plain_s:.5f} s/step; NCCL eager {mesh_eager_s:.5f} s/step ({bs / mesh_eager_s:.1f} rays/s); NCCL CUDA "
            f"graph replay {secs[2]:.5f} s/step ({bs / secs[2]:.1f} rays/s; the other replay {secs[1]:.5f}; the "
            f"first call, eager then the capture, {secs[0]:.5f}); params, Adam's state and the last metrics against "
            f"the group-less eager steps: bit for bit, eager and graph; launches {DP_K} x {per_step}; on {smi}")
        if busy > 0:
            log(f"[profile] one 11(a) NCCL dispatch: device busy {busy:.3f} ms a step; idle share "
                f"{1 - busy / (secs[2] * 1e3):.3f} of the unprofiled replay ({secs[2] * 1e3:.3f} ms a step); by group "
                f"(ms a step) " + ", ".join(f"{g} {ms / DP_K:.3f}" for g, ms in
                                          sorted(groups.items(), key=lambda kv: -kv[1])))
        else:
            log("[profile] the profiler recorded no device time in the 11(a) dispatch: not measured")
    finally:
        scan = None  # its graph goes before the group: NCCL keeps a communicator a live graph uses
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()

    # The start state and the global batches for the spawned ranks, and the
    # world-1 eager steps they are held to.
    train_restore(state, start)
    start_file = tmp / "dp_start.pt"
    torch.save({"cfg": tcfg, "camera": tcam, "buffers": tree_to(buffers, "cpu"), "params": tree_to(state.params, "cpu"),
                "optimizer": state.optimizer.state_dict(), "step": state.step,
                "batches": [b.to("cpu") for b in run]}, start_file)
    w1_params, w1_secs = [], []
    for b, g in list(zip(run, gens()))[:DP_EAGER_STEPS]:
        _, s_ = timed(lambda: plain(state, b, g), 1)
        w1_secs.append(s_)
        w1_params.append({n: t.detach().cpu().clone() for n, t in tree_items(state.params)})
    torch.cuda.empty_cache()

    # (b) Two gloo ranks on this card.
    out_b = tmp / "dp_11b"
    out_b.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(dp_rank_steps, 2, 2, "gloo", True, str(start_file), str(out_b))
    wall_b = time.perf_counter() - t0
    ranks = [torch.load(out_b / f"rank{r}.pt", weights_only=False) for r in range(2)]
    # Each step's gradients against the world-1 gradients at the same
    # parameters (the ranks' before that step) and the same global batch
    # and jitter; the params against the world-1 steps' after each step.
    g_errs, p_errs = [], []
    for i in range(DP_EAGER_STEPS):
        for what in ("grads", "params"):
            a, b_ = ranks[0][what][i], ranks[1][what][i]
            if any(not torch.equal(a[n], b_[n]) for n in a):
                raise AssertionError(f"11(b) step {i}: the two ranks' {what} differ")
        before = ranks[0]["params"][i - 1] if i else start
        with torch.no_grad():
            for n, t in tree_items(state.params):
                t.copy_(before[n])
        state.step = start["step"] + i
        loss_and_grads(state, tcfg, tcam, buffers, run[i], gens()[i])
        g_errs.append(scaled_err(ranks[0]["grads"][i], dp_grads(state)))
        p_errs.append(scaled_err(ranks[0]["params"][i], w1_params[i]))
    log(f"[data-parallel 11(b)] two gloo ranks on one card ({ranks[0]['mesh']}, {ranks[1]['mesh']}), {DP_EAGER_STEPS} "
        f"eager steps of a {tcfg.model.batch_size}-ray global batch ({tcfg.model.batch_size // 2} rays a rank): the "
        f"ranks' gradients and params equal bit for bit after every step; each step's gradients against the world-1 "
        f"gradients at the same params, worst leaf a step (of its scale, tol {DP_GRAD_TOL}): "
        + ", ".join(f"{e:.3e} {n}" for e, n in g_errs) + f"; params against the world-1 steps' (tol {GRAD_TOL}): "
        + ", ".join(f"{e:.3e} {n}" for e, n in p_errs)
        + f"; s/step after the first step, rank 0 {sum(ranks[0]['secs'][1:]) / (DP_EAGER_STEPS - 1):.5f}, rank 1 "
        f"{sum(ranks[1]['secs'][1:]) / (DP_EAGER_STEPS - 1):.5f} (world-1 eager {sum(w1_secs[1:]) / (DP_EAGER_STEPS - 1):.5f} "
        f"in this process); the first step {ranks[0]['secs'][0]:.3f} s; both ranks' processes {wall_b:.1f} s; on {smi}")
    if not max(g_errs)[0] <= DP_GRAD_TOL or not max(p_errs)[0] <= GRAD_TOL:
        raise AssertionError(f"11(b): the two-rank steps differ from the world-1 steps: gradients {max(g_errs)}, "
                             f"params {max(p_errs)}")

    # (c) Two NCCL ranks, one card each, the captured dispatch.
    if torch.cuda.device_count() < 2:
        log(f"[data-parallel 11(c)] not run: {torch.cuda.device_count()} card visible, two NCCL ranks need two")
    else:
        out_c = tmp / "dp_11c"
        out_c.mkdir()
        t0 = time.perf_counter()
        spawn_ranks(dp_rank_steps, 2, 2, "nccl", False, str(start_file), str(out_c))
        wall_c = time.perf_counter() - t0
        ranks = [torch.load(out_c / f"rank{r}.pt", weights_only=False) for r in range(2)]
        for what in ("first_grads", "grads", "params"):
            if any(not torch.equal(ranks[0][what][n], ranks[1][what][n]) for n in ranks[0][what]):
                raise AssertionError(f"11(c): the two ranks' {what} differ")
        train_restore(state, start)
        loss_and_grads(state, tcfg, tcam, buffers, run[0], gens()[0])
        g_err = scaled_err(ranks[0]["first_grads"], dp_grads(state))
        p_err = scaled_err(ranks[0]["params"], {n: v.cpu() for n, v in ref.items() if " " not in n and n != "step"})
        s_c = ranks[0]["secs"][2]
        log(f"[data-parallel 11(c)] two NCCL ranks on two cards ({ranks[0]['mesh']}, {ranks[1]['mesh']}), a "
            f"{DP_K}-step CUDA graph with its collectives: the ranks equal bit for bit; a first step's gradients "
            f"against the world-1 gradients at the same params, worst leaf {g_err[1]}: {g_err[0]:.3e} of its scale "
            f"(tol {DP_GRAD_TOL}); params after {DP_K} steps against the world-1 steps', worst leaf {p_err[1]}: "
            f"{p_err[0]:.3e} (tol {GRAD_TOL}); graph replay {s_c:.5f} s/step, {tcfg.model.batch_size / s_c:.1f} global rays/s (rank 1 "
            f"{ranks[1]['secs'][2]:.5f}; the first call {ranks[0]['secs'][0]:.5f}); loss {ranks[0]['metrics']['loss']:.6f} "
            f"against the world-1 run's {float(m_ref['loss']):.6f}; both ranks' processes {wall_c:.1f} s; on {smi}")
        if not g_err[0] <= DP_GRAD_TOL or not p_err[0] <= GRAD_TOL:
            raise AssertionError(f"11(c): the two NCCL ranks differ from the world-1 steps: gradients {g_err}, "
                                 f"params {p_err}")

    # (d) Phase 9's test views at two gloo ranks on this card.
    if views is None:
        return
    src = views["run_dir"]
    base = tmp / "runs_11d"
    dst = base / src.relative_to(views["base"])
    shutil.copytree(src / "ckpt" / "step_0000040", dst / "ckpt" / "step_0000040")
    argv = [str(base) if a == str(views["base"]) else a for a in views["argv"]]
    argv[argv.index("--config.parallel.data-axis-size") + 1] = "2"
    argv += ["--config.model.end-iter", "40"]
    out_d = tmp / "dp_11d"
    out_d.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(dp_rank_views, 2, 2, argv, str(out_d))
    wall_d = time.perf_counter() - t0
    ranks = [torch.load(out_d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for res in ranks:
        if res["step"] != 40:
            raise AssertionError(f"11(d): a rank resumed at step {res['step']}, not 40")
        unequal = [k for k, v in views["raygen"].items() if not torch.equal(res["raygen"][k], v)]
        if unequal:
            raise AssertionError(f"11(d): merged raygen tables differ from phase 9's registration: {unequal}")
        if res["means"].keys() != views["means"].keys():
            raise AssertionError(f"11(d): val/ keys {sorted(res['means'])} against {sorted(views['means'])}")
    rel = max(abs(res["means"][k] - v) / abs(v) for res in ranks for k, v in views["means"].items())
    log(f"[data-parallel 11(d)] two gloo ranks on one card, render_test_views on phase 9's 2 test views from its step-40 "
        f"checkpoint: the merged raygen tables equal phase 9's single-rank registration bit for bit on both ranks; "
        f"val/ means {ranks[0]['means']} against {views['means']}: worst rel {rel:.3e} (tol 1e-6); the views "
        f"{ranks[0]['secs']:.2f} / {ranks[1]['secs']:.2f} s a rank; both ranks' processes {wall_d:.1f} s; on {smi}")
    if not rel <= 1e-6:
        raise AssertionError(f"11(d): val/ means differ from phase 9's: rel {rel:.3e}")


# Phase 12: the unfused renderer and what rides on it.  PARITY.md's
# trajectory geometry (16 + 2 x 8 camera samples, 16 + 16 shadow samples);
# the eager steps of each training sub-phase; the K of 12(a)'s graph.  The
# hash table is JAX's default (16 levels of 2^19 rows of 2 features, 64 MiB).
PARITY_GEOMETRY = dict(n_samples=16, n_importance_samples=16, up_sample_steps=2, n_shadow_samples=16,
                       n_shadow_importance_samples=16)
OFFPATH_WARMUP, OFFPATH_STEPS, OFFPATH_SHORT, OFFPATH_K = 3, 10, 5, 4
# The partial hint's shadow map is the transmittance of one shadow ray per
# pixel that ends at the camera ray's largest-weight sample, on the
# surface, where its last samples lie; the bf16 march's draws there move
# between the card's kernels and the CPU's plain versions (see z_err), and
# the tau of a ray grazing the surface moves with them, more than at the
# full hint's blended hit, so it is held at the gradients' GRAD_TOL.
PARTIAL_SHADOW_TOL = 5e-2
# A step's gradients can move with the last bits of its rays: the march's
# draws where a ray's pdf is nearly uniform, and the background NeRF's
# alpha, which weights the march's last samples by their spacing.  So phase
# 12 measures each 64-ray step's conditioning, the CPU step again with the
# camera origins an ulp away (on the CPU that moved a bg-NeRF step's
# variance gradient by 0.115 of itself), and holds the card against the CPU
# leaf by leaf at the larger of GRAD_TOL and CONTROL_FACTOR times that
# control (the factor of the JAX package's trajectory test).
CONTROL_FACTOR = 3.0
# The hash table's gradient takes the eikonal term's share through the
# spatial derivative of each point's trilinear weights, which jumps where a
# point crosses a cell face (1,024 cells a side at the finest level), and a
# row sums few points: a point whose position differs in its last bits
# sends its share to other rows.  Card and CPU positions differ by more
# than an ulp (an ulp of the origins alone moved the table's gradient by
# 0.024-0.059 in relative norm, and 0.24 of its largest entry).  So 12(d)
# holds the encoding on the same points on both devices at HASH_TOL (its
# value, and the table's gradient through a loss with the eikonal term),
# and a step's table gradient by the relative norm of its error at
# HASH_STEP_TOL, which a wrong row or a missing term (an error of the
# gradient's own size) crosses.
HASH_TABLE = "/renderer/sdf/hash/table"
HASH_TOL, HASH_STEP_TOL = 1e-5, 0.25
# A sphere-traced depth stops at the first step whose |sdf| is below 1e-4.
# A ray that grazes the surface may land within that band on one device and
# step past it on the other, to a later crossing: its depth then jumps
# (on an H100, 2 of the 64 pixels by up to 0.109).  The depth is held at
# CPU_TOL on this share of the 64 pixels.
SPHERE_DEPTH_SHARE = 0.9


def with_model(cfg, sdf=None, **model_kw):
    """``cfg`` with its SDF network's fields ``sdf`` and its model's
    ``model_kw`` replaced."""
    m = cfg.model
    if sdf:
        m = dataclasses.replace(m, sdf_network=dataclasses.replace(m.sdf_network, **sdf))
    return dataclasses.replace(cfg, model=dataclasses.replace(m, **model_kw))


def fresh_state(cfg, n_views: int, dev):
    """A seed-0 train state of ``cfg`` on ``dev`` and its raygen buffers."""
    import torch

    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, make_optimizer

    gen = torch.Generator().manual_seed(0)
    params = {"renderer": init_model_params(cfg.model, gen, device=dev)}
    params["raygen"], buffers = ray_generator_init(gen, cfg.ray_generator, n_views, device=dev)
    return init_train_state(params, make_optimizer(cfg, params)), buffers


def scan_phase(smi: str, dev, td: dict, batches: list, label: str, scfg_, n_steps: int, per_step: dict) -> dict:
    """From a fresh seed-0 state of ``scfg_`` after TRAIN_WARMUP eager
    steps, set to step 1000 (the learning rate and cos_anneal_ratio both
    change every step there): ``n_steps`` eager steps of
    ``make_train_step`` on ``batches``, then the same steps from the same
    state, batches and generators through ``make_train_step_scan``: the
    first call (eager on a side stream, then the capture) and two
    replays, each timed and its launches counted (``per_step`` each
    step).  Params, Adam's state and the last metrics against the eager
    steps'; the peak of allocated device memory over them all, above what
    was allocated before; one profiled replay: device busy and idle share.
    ``td``: phase 5's training data.  -> the eager and graph s/step, the
    peak and the last dispatch's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import (
        init_train_state, make_optimizer, make_train_step, make_train_step_scan, stack_bundles,
    )

    n_views, tcam = td["n_views"], td["camera"]
    tgen = torch.Generator().manual_seed(0)
    tparams = {"renderer": init_model_params(scfg_.model, tgen, device=dev)}
    tparams["raygen"], tbuffers = ray_generator_init(tgen, scfg_.ray_generator, n_views, device=dev)
    opt = make_optimizer(scfg_, tparams)
    state = init_train_state(tparams, opt)
    step_fn = make_train_step(scfg_, tcam, tbuffers, opt)
    warm_gen = torch.Generator(device=dev).manual_seed(0)
    for b in batches[-TRAIN_WARMUP:]:
        state, _ = step_fn(state, b, warm_gen)
    state.step = 1000
    start = train_snapshot(state)
    run = batches[:n_steps]

    def gens():
        return [torch.Generator(device=dev).manual_seed(2000 + i) for i in range(n_steps)]

    gc.collect()  # an earlier call's graph and its pool
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b, g in zip(run, gens()):
        state, m_eager = step_fn(state, b, g)
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t0) / n_steps
    eager = train_snapshot(state)
    scan = make_train_step_scan(scfg_, tcam, tbuffers, opt, n_steps=n_steps)
    stacked = stack_bundles(run)
    expected_ = {k: v * n_steps for k, v in dict({k: 0 for k in cuda_lib.launch_counts}, **per_step).items()}
    secs_, worst = [], (0.0, "")
    for i in range(3):  # the first call, then two replays
        train_restore(state, start)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        state, m_graph = scan(state, stacked, gens())
        torch.cuda.synchronize()
        secs_.append((time.perf_counter() - t0) / n_steps)
        if dict(cuda_lib.launch_counts) != expected_:
            raise AssertionError(f"[{label}] dispatch {i}: launches {dict(cuda_lib.launch_counts)}, expected "
                                 f"{expected_}")
        err = max(snapshot_err(train_snapshot(state), eager), snapshot_err(m_graph, m_eager))
        worst = max(worst, err)
    graph_s = secs_[2]
    peak_gb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e9
    launches_ = dict(cuda_lib.launch_counts)
    if worst[0] == 0.0:
        verdict = "bit for bit"
    elif worst[0] <= 1e-6:
        verdict = f"within {worst[0]:.3e} of the scale of {worst[1]}"
    else:
        raise AssertionError(f"[{label}] the graph's steps differ from the eager steps: {worst[1]} {worst[0]:.3e}")
    bs = scfg_.model.batch_size
    log(f"[{label}] {n_steps} steps, core_backward={scfg_.model.renderer.core_backward!r}: eager "
        f"{eager_s:.5f} s/step ({bs / eager_s:.1f} rays/s); CUDA graph replay {graph_s:.5f} s/step "
        f"({bs / graph_s:.1f} rays/s; the other replay {secs_[1]:.5f}); the first call (eager, then the "
        f"capture) {secs_[0]:.5f} s/step; params, Adam's state and the last metrics against the eager steps: "
        f"{verdict}; launches {n_steps} x {per_step}; loss {float(m_graph['loss']):.6f}; peak device memory "
        f"{peak_gb:.3f} GB above the {base_bytes / 1e9:.3f} GB allocated before; on {smi}")
    train_restore(state, start)
    scan(state, stacked, gens())  # the replay before the profile, as the timed ones
    train_restore(state, start)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan(state, stacked, gens())
        torch.cuda.synchronize()
    groups = device_groups(prof)
    busy = sum(groups.values()) / n_steps
    if busy > 0:
        log(f"[profile] one {label} dispatch: device busy {busy:.3f} ms a step; idle share "
            f"{1 - busy / (graph_s * 1e3):.3f} of the unprofiled replay ({graph_s * 1e3:.3f} ms a step); by group "
            f"(ms a step) " + ", ".join(f"{g} {ms / n_steps:.3f}" for g, ms in
                                      sorted(groups.items(), key=lambda kv: -kv[1])))
    else:
        log(f"[profile] the profiler recorded no device time in the {label} dispatch: not measured")
    return {"eager_s": eager_s, "graph_s": graph_s, "peak_gb": peak_gb, "launches": launches_,
            "idle": 1 - busy / (graph_s * 1e3) if busy > 0 else float("nan")}


def launches_check(label: str, got: dict, per: dict, times: int = 1) -> None:
    """Every kernel's launches equal ``per`` times ``times`` (0 for a kernel
    ``per`` omits)."""
    from nrhints_torch.kernels import cuda_lib

    want = {k: per.get(k, 0) * times for k in cuda_lib.launch_counts}
    if got != want:
        raise AssertionError(f"[{label}] launches {got}, expected {want}")


def offpath_train(label: str, smi: str, cfg, td: dict, batches: list, n_steps: int, per_step: dict, *,
                  k_graph: int = 0, profile_step: bool = False) -> dict:
    """Train a seed-0 state of ``cfg`` eagerly on ``batches`` (OFFPATH_WARMUP
    steps, then ``n_steps`` timed, launches checked against ``per_step``),
    optionally profile one more step (device busy, idle share) and run
    ``k_graph`` steps as one CUDA graph against the same steps eager from the
    same state; then hold one 64-ray step's gradients on the card against
    the CPU's, leaf by leaf, at the larger of GRAD_TOL and CONTROL_FACTOR
    times the CPU step's own change under an ulp of the rays (the hash
    table at HASH_STEP_TOL).
    -> {"s_step": ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.render.renderer import train_uniforms
    from nrhints_torch.train.step import (
        init_train_state, loss_and_grads, make_optimizer, make_train_step, make_train_step_scan, stack_bundles,
    )
    from nrhints_torch.utils import tree_items

    dev, tcam = batches[0].h_indices.device, td["camera"]
    state, buffers = fresh_state(cfg, td["n_views"], dev)
    start = {name: t.detach().clone() for name, t in tree_items(state.params)}
    step_fn = make_train_step(cfg, tcam, buffers, state.optimizer)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in batches[:OFFPATH_WARMUP]:
        state, metrics = step_fn(state, b, gen)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for b in batches[OFFPATH_WARMUP:OFFPATH_WARMUP + n_steps]:
        state, metrics = step_fn(state, b, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_steps
    launches_check(label, dict(cuda_lib.launch_counts), per_step, n_steps)
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[{label}] non-finite training loss: {losses}")
    moved = sum(not torch.equal(t.detach(), start[name]) for name, t in tree_items(state.params))
    if not any(not torch.equal(t.detach(), start[n]) for n, t in tree_items(state.params) if n.startswith("/raygen/")):
        raise AssertionError(f"[{label}] the pose deltas did not move")
    bs = cfg.model.batch_size
    log(f"[{label}] {n_steps} eager steps of {bs} rays: {s_step:.5f} s/step, {bs / s_step:.1f} train rays/s on {smi}; "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; {moved} of {len(start)} leaves moved; launches a step "
        f"{per_step or 'none'}")
    nxt = OFFPATH_WARMUP + n_steps
    if profile_step:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step_fn(state, batches[nxt], gen)
            torch.cuda.synchronize()
        groups = device_groups(prof)
        busy = sum(groups.values())
        if busy > 0:
            log(f"[profile] one {label} step: device busy {busy:.2f} ms; idle share {1 - busy / (s_step * 1e3):.3f} "
                f"of the unprofiled step ({s_step * 1e3:.2f} ms); by group (ms) " + ", ".join(
                    f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
        else:
            log(f"[profile] the profiler recorded no device time in the {label} step: not measured")
    if k_graph:
        run = batches[:k_graph]
        snap = train_snapshot(state)

        def gens():
            return [torch.Generator(device=dev).manual_seed(3000 + i) for i in range(k_graph)]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b, g in zip(run, gens()):
            state, m_eager = step_fn(state, b, g)
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - t0) / k_graph
        eager = train_snapshot(state)
        scan = make_train_step_scan(cfg, tcam, buffers, state.optimizer, n_steps=k_graph)
        stacked = stack_bundles(run)
        secs, worst = [], (0.0, "")
        for i in range(2):  # the first call (eager, then the capture), then a replay
            train_restore(state, snap)
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            state, m_graph = scan(state, stacked, gens())
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / k_graph)
            launches_check(f"{label} graph dispatch {i}", dict(cuda_lib.launch_counts), per_step, k_graph)
            worst = max(worst, snapshot_err(train_snapshot(state), eager), snapshot_err(m_graph, m_eager))
        if worst[0] > 1e-6:
            raise AssertionError(f"[{label}] the graph's steps differ from the eager steps: {worst[1]} {worst[0]:.3e}")
        verdict = "bit for bit" if worst[0] == 0.0 else f"within {worst[0]:.3e} of the scale of {worst[1]}"
        log(f"[{label}] K = {k_graph} steps as one CUDA graph: replay {secs[1]:.5f} s/step "
            f"({bs / secs[1]:.1f} rays/s), the first call {secs[0]:.5f} s/step, eager {eager_s:.5f} s/step; params, "
            f"Adam's state and the last metrics against the eager steps: {verdict}; on {smi}")
    # One 64-ray step from the trained state on the card and on the CPU, and
    # the CPU's control: the same step with the camera origins an ulp away.
    b64 = td["next_batch"](64)
    shifted = PixelBundle(**{f: getattr(b64, f) for f in ("h_indices", "w_indices", "img_indices", "rgb_gt", "pls")},
                          poses=b64.poses.clone())
    shifted.poses[:, :3, 3] = torch.nextafter(shifted.poses[:, :3, 3], torch.full_like(shifted.poses[:, :3, 3], 9.0))
    u64 = train_uniforms(cfg.model, 64, torch.Generator().manual_seed(7), "cpu")
    grads = []
    for where, bt in ((dev, b64), (torch.device("cpu"), b64), (torch.device("cpu"), shifted)):
        p_ = tree_to(state.params, where)
        st = init_train_state(p_, make_optimizer(cfg, p_))
        st.step = state.step
        m_ = loss_and_grads(st, cfg, tcam, tree_to(buffers, where), bt.to(where),
                            uniforms={k: v.to(where) for k, v in u64.items()})
        grads.append(({name: t.grad.detach().cpu() for name, t in tree_items(p_)}, float(m_["loss"])))
    card, cpu, ctrl = (g for g, _ in grads)

    def leaf_err(a, b, name):  # the hash table by the relative norm of its error (see HASH_STEP_TOL)
        return ((a - b).norm() / b.norm()).item() if name == HASH_TABLE else scaled_err({0: a}, {0: b})[0]

    rows = []
    for n in cpu:
        err, c_err = leaf_err(card[n], cpu[n], n), leaf_err(ctrl[n], cpu[n], n)
        allowed = HASH_STEP_TOL if n == HASH_TABLE else max(GRAD_TOL, CONTROL_FACTOR * c_err)
        rows.append((err / allowed, n, err, allowed, c_err))
    ratio, leaf, err, allowed, _ = max(rows)
    c_worst, c_leaf = max((r[4], r[1]) for r in rows)
    msg = (f"worst gradient leaf {leaf}: {err:.3e} of its scale, allowed {allowed:.3e} (the larger of {GRAD_TOL} and "
           f"{CONTROL_FACTOR} x the CPU control; {HASH_STEP_TOL} in relative norm for the hash table) over {len(cpu)} "
           f"leaves; the control (origins an ulp away) moves {c_leaf} most, by {c_worst:.3e}")
    log(f"[{label}] 64-ray step, card vs CPU: loss {grads[0][1]:.6f} vs {grads[1][1]:.6f} (control "
        f"{grads[2][1]:.6f}); {msg}")
    if not ratio <= 1.0:
        raise AssertionError(f"[{label}] card and CPU gradients disagree: {msg}")
    return {"s_step": s_step}


def offpath_view(label: str, smi: str, dev, cfg, camera, params, pose, pl, per_chunk: dict, *,
                 graph: bool = True, extra: dict | None = None, tols: dict | None = None,
                 shares: dict | None = None) -> dict:
    """One camera.H x camera.W view of ``params`` through
    ``Evaluator.render_image`` on the card: through its view graph (the
    first call, then a replay against the eager sweep bit for bit) or, with
    ``graph=False``, the eager sweep the evaluator runs; launches against
    ``per_chunk`` times the chunks (``extra`` added once a view); finite
    outputs; then 64 of its pixels rendered on the CPU at CPU_TOL (``tols``
    overrides an entry), every pixel, or the share of them ``shares``
    names.  -> the host images."""
    import numpy as np
    import torch

    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.kernels import cuda_lib

    H, W = camera.H, camera.W
    hh, ww = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    view = PixelBundle(h_indices=hh.float(), w_indices=ww.float(), poses=pose.expand(H, W, 4, 4),
                       pls=pl.expand(H, W, 3))
    ev = Evaluator(cfg, camera, {}, device=dev)
    times, counts = [], []
    for _ in range(2 if graph else 1):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        img = ev.render_image(params, view)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(dict(cuda_lib.launch_counts))
    n_chunks = -(-H * W // cfg.model.inference_chunk_size)
    want = {k: v * n_chunks for k, v in per_chunk.items()}
    for k, v in (extra or {}).items():
        want[k] = want.get(k, 0) + v
    for c in counts:
        launches_check(label, c, want)
    secs = times[-1]
    how = "eager sweep (no graph)"
    if graph:
        t0 = time.perf_counter()
        eager = ev._render_eager(params, view)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        replay = ev._render_graph(params, view)
        unequal = [k for k in eager if not torch.equal(replay[k], eager[k])]
        if unequal or sorted(replay) != sorted(eager):
            raise AssertionError(f"[{label}] the view graph's images differ from the eager sweep's on {unequal}")
        how = (f"CUDA graph replay; the eager sweep {eager_s:.4f} s, the first call {times[0]:.4f} s; graph images = "
               f"eager images bit for bit")
    for k, v in img.items():
        if v.shape[:2] != (H, W) or not np.all(np.isfinite(v)):
            raise AssertionError(f"[{label}] output {k} malformed or not finite: {v.shape}")
    log(f"[{label}] {H}x{W} view: {secs:.4f} s, {H * W / secs:.1f} rays/s ({how}); launches "
        f"{ {k: v for k, v in want.items() if v} or 'none'}; on {smi}")
    rows, cols = (torch.arange(n // 4, n // 4 + 8 * (n // 16), n // 16)[:8] for n in (H, W))
    ph, pw = torch.meshgrid(rows, cols, indexing="ij")
    sub = PixelBundle(h_indices=ph.reshape(1, -1).float(), w_indices=pw.reshape(1, -1).float(),
                      poses=pose.expand(1, 64, 4, 4), pls=pl.expand(1, 64, 3))
    cpu_img = Evaluator(cfg, camera, {}, device="cpu").render_image(tree_to(params, "cpu"), sub)
    tols = dict(CPU_TOL, **(tols or {}))
    errs = {k: np.abs(img[k][ph.numpy(), pw.numpy()].reshape(1, 64, -1) - cpu_img[k]).reshape(64, -1).max(-1)
            for k in tols if k in img}
    log(f"[{label}] 64 pixels, card vs CPU, max / mean / pixels over tol: " + ", ".join(
        f"{k} {e.max():.3e} / {e.mean():.3e} / {int((e > tols[k]).sum())} (tol {tols[k]}"
        + (f", at least {shares[k]:.0%} within" if k in (shares or {}) else "") + ")" for k, e in errs.items()))
    shares = shares or {}
    bad = [k for k, e in errs.items() if not (e <= tols[k]).mean() >= shares.get(k, 1.0)]
    if bad:
        raise AssertionError(f"[{label}] CPU and card renders disagree on {bad}")
    return img


def hash_check(smi: str, dev, hcfg) -> None:
    """The hash encoding at JAX's default grid on the same 65,536 points in
    [0, 1]^3 on the card and the CPU: its value, and the table's gradient
    of sum(enc . c) + |d(enc . c)/dx|^2 (the eikonal term's path), each at
    HASH_TOL of its scale; the encoding's forward timed on the card."""
    import torch

    from nrhints_torch.core.encodings import hash_encoding_apply, hash_encoding_init

    gen = torch.Generator().manual_seed(1)
    table = hash_encoding_init(gen, hcfg, device="cpu")["table"]
    x = torch.rand((65536, 3), generator=gen)
    c = torch.randn((hcfg.out_dim,), generator=gen)
    outs = []
    for where in (dev, torch.device("cpu")):
        t, xx, cc = table.to(where).requires_grad_(True), x.to(where).requires_grad_(True), c.to(where)
        enc = hash_encoding_apply({"table": t}, xx, hcfg)
        (gx,) = torch.autograd.grad((enc @ cc).sum(), xx, create_graph=True)
        ((enc @ cc).sum() + (gx**2).sum()).backward()
        outs.append({"value": enc.detach().cpu(), "table gradient": t.grad.cpu()})
    err, which = scaled_err(outs[0], outs[1])
    ms = cuda_ms(lambda: hash_encoding_apply({"table": table.to(dev)}, x.to(dev), hcfg), 20)
    log(f"[offpath 12(d) hash encoding] {hcfg.num_levels} levels of 2^{hcfg.log2_hashmap_size} rows, 65,536 points, "
        f"card vs CPU on the same points: worst {which} {err:.3e} of its scale (tol {HASH_TOL}); the forward "
        f"{ms:.4f} ms on {smi}")
    if not err <= HASH_TOL:
        raise AssertionError(f"the hash encoding differs between card and CPU: {which} {err:.3e}")


def offpath_phase(smi: str, dev, mc: dict, td: dict) -> None:
    """Phase 12, the unfused renderer and what rides on it, at full
    published width (8x256 SDF with a skip at 4, 4x256 trunk, the 8x256
    background NeRF, the default hash grid; random weights from seed 0):
    (a) nr-hints-cam-opt at PARITY.md's geometry with shadow_hint_gradient,
    the slice's main path: 3 + 10 eager steps of 512 rays (D, E, F and G once
    a step, no march kernel), a profiled step, K = 4 steps as one CUDA graph
    against 4 eager steps, a 64-ray step against the CPU; (b)
    fused_kernels="off" at the shipping geometry: a 128x128 view through its
    graph and the eager sweep, 5 train steps, no kernel at all; (c) the
    partial shadow hint (n_shadow_importance_clip=32): a 64x64 view, B and C
    once per shadow sub-chunk of 2048 rays; (d) the hash encoding and (e)
    the background NeRF: 5 train steps and a 64x64 view each; (f) a
    maximum_point 64x64 view through its graph and a sphere_tracing 32x32
    view, eager, with the tracer's iterations."""
    import torch

    from nrhints_torch.camera.model import CameraModel
    from nrhints_torch.camera.rays import generate_rays
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.render.renderer import init_model_params, sphere_trace_depth

    t_phase = time.perf_counter()
    tcfg = td["cfg"]
    batches = [td["next_batch"]() for _ in range(OFFPATH_WARMUP + OFFPATH_STEPS + 1)]
    stash = dict(sdf_stash_fwd=1, sdf_stash_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1)
    shipping_step = dict(stash, round_machinery=8, shadow_final=1)
    shipping_view = dict(sdf_core_fwd=1, round_machinery=8, shadow_final=1)

    # (a) The slice's main path.
    cfg_a = with_renderer(tcfg, **PARITY_GEOMETRY, shadow_hint_gradient=True)
    offpath_train("offpath 12(a) parity geometry, shadow_hint_gradient", smi, cfg_a, td, batches, OFFPATH_STEPS,
                  stash, k_graph=OFFPATH_K, profile_step=True)

    # The views: the nr-hints model of phase 4, its camera, and the same
    # field of view at 64x64 and 32x32.
    cfg, cam, pose, pl, params0 = (mc[k] for k in ("cfg", "camera", "pose", "pl", "renderer_params"))
    cam64, cam32 = (CameraModel(n, n, n / 2.0, n / 2.0, cam.fx * n / cam.W, cam.fy * n / cam.H, cam.zn, cam.zf)
                    for n in (64, 32))
    params = {"renderer": params0, "raygen": {}}

    def model_params(cfg_):
        return {"renderer": init_model_params(cfg_.model, torch.Generator().manual_seed(0), device=dev), "raygen": {}}

    # (b) The unfused path everywhere.
    cfg_b = with_renderer(cfg, fused_kernels="off")
    offpath_view("offpath 12(b) fused_kernels='off'", smi, dev, cfg_b, cam, params, pose, pl, {})
    offpath_train("offpath 12(b) fused_kernels='off'", smi, with_renderer(tcfg, fused_kernels="off"), td, batches,
                  OFFPATH_SHORT, {})

    # (c) The partial hint: 64 x 64 = 8 chunks of 512 rays, each 512 x 32
    # shadow rays in 8 sub-chunks of 2048, each sub-chunk one fused march.
    cfg_c = with_renderer(cfg, n_shadow_importance_clip=32)
    sub = -(-cfg_c.model.inference_chunk_size * 32 // cfg_c.model.shadow_mini_chunk_size)
    offpath_view("offpath 12(c) partial shadow hint", smi, dev, cfg_c, cam64, params, pose, pl,
                 dict(sdf_core_fwd=1, round_machinery=4 + 4 * sub, shadow_final=sub),
                 tols={"shadow_map": PARTIAL_SHADOW_TOL})

    # (d) The hash encoding: the unfused path, no kernel.
    cfg_d, tcfg_d = (with_model(c, sdf=dict(encoding="hash")) for c in (cfg, tcfg))
    hash_check(smi, dev, cfg_d.model.sdf_network.hash_config)
    offpath_train("offpath 12(d) hash encoding", smi, tcfg_d, td, batches, OFFPATH_SHORT, {})
    offpath_view("offpath 12(d) hash encoding", smi, dev, cfg_d, cam64, model_params(cfg_d), pose, pl, {})

    # (e) The background NeRF on the shipping kernels.
    cfg_e, tcfg_e = (with_renderer(c, use_outside_nerf=True) for c in (cfg, tcfg))
    offpath_train("offpath 12(e) use_outside_nerf", smi, tcfg_e, td, batches, OFFPATH_SHORT, shipping_step)
    offpath_view("offpath 12(e) use_outside_nerf", smi, dev, cfg_e, cam64, model_params(cfg_e), pose, pl,
                 shipping_view)

    # (f) The depth modes.
    offpath_view("offpath 12(f) maximum_point", smi, dev, with_renderer(cfg, depth_type="maximum_point"), cam64, params,
                 pose, pl, shipping_view)
    cfg_s = with_renderer(cfg, depth_type="sphere_tracing")
    offpath_view("offpath 12(f) sphere_tracing", smi, dev, cfg_s, cam32, params, pose, pl, shipping_view, graph=False,
                 shares={"depth": SPHERE_DEPTH_SHARE})
    hh, ww = torch.meshgrid(torch.arange(32.0, device=dev), torch.arange(32.0, device=dev), indexing="ij")
    rays = generate_rays({}, {}, cam32, cfg_s.ray_generator, PixelBundle(
        h_indices=hh.reshape(-1), w_indices=ww.reshape(-1), poses=pose.to(dev).expand(1024, 4, 4),
        pls=pl.to(dev).expand(1024, 3)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, iters = sphere_trace_depth(params0, cfg_s.model, rays.origins, rays.directions)
    torch.cuda.synchronize()
    log(f"[offpath 12(f) sphere_tracing] the 32x32 view's 1024 rays: {iters} iterations (convergence tested every "
        f"16), {time.perf_counter() - t0:.4f} s; {int((depth < 100.0).sum())} rays hit, depth range "
        f"[{float(depth.min()):.4f}, {float(depth.max()):.4f}]; on {smi}")
    log(f"[offpath] phase 12 took {time.perf_counter() - t_phase:.1f} s")


# Phase 13: core_backward="stash_all".  The K of 13(b)'s graphs, the steps
# of 13(c)'s registration check and of 13(d)'s resumed Trainer, and the
# global step of 13(d)'s fake checkpoint of the original code.
STASH_ALL_K, STASH_ALL_REG, IMPORT_STEPS, IMPORT_GLOBAL_STEP = 16, 50, 5, 123_456


def stash_all_kernels(smi: str, dev, mc: dict) -> dict:
    """13(a): D's and E's stash_all variants at phase 3's 65,536 points,
    weights and cotangents.  D's variant against plain D (sdf, feat, grad
    and the h_i bit for bit) and its plain version (with the u_i and
    g_enc); E's variant twice (bit for bit), against its plain version at
    D's variant's stash, and without its dW passes (dx bit for bit); each
    timed with CUDA events and by device time from one profiled call,
    beside its bound and plain D's and E1's device time in this call.  ->
    the numbers of the kernels line."""
    import numpy as np
    import torch

    from nrhints_torch.fields.sdf import _layer_dims
    from nrhints_torch.kernels import core_stash

    x, aw, scfg = mc["x"], mc["aw"], mc["cfg"].model.sdf_network
    n_pts, n_w, L = x.shape[0], sum(w.numel() for w in aw), scfg.n_layers
    io, dims = _layer_dims(scfg)
    hidden, d_last, d_feat = sum(i * o_ for i, o_ in io), dims[-2], scfg.d_out_feat
    gt, width = core_stash.sdf_stash_width(scfg), core_stash.sdf_stash_width(scfg, stash_us=True)
    cols = core_stash.sdf_stash_columns(scfg, stash_us=True)
    crng = np.random.default_rng(5)
    cots = tuple(torch.tensor(crng.normal(size=shape).astype(np.float32), device=dev)
                 for shape in ((n_pts,), (n_pts, d_feat), (n_pts, 3)))

    d_all = core_stash.sdf_stash_fwd(aw, x, scfg, stash_us=True)
    d_ref = core_stash.sdf_stash_fwd(aw, x, scfg)
    if not (all(torch.equal(a, b) for a, b in zip(d_all[:3], d_ref[:3])) and torch.equal(d_all[3][:, :gt], d_ref[3])):
        raise AssertionError("kernel D's stash_all variant's sdf, feat, grad or h_i differ from plain D's")
    plain = core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, "bfloat16", "bfloat16", return_us=True)
    d_abs, d_rel = max_err([*d_all[:3], *core_stash.split_stash(d_all[3], cols)],
                           [*plain[:3], *plain[3], *plain[4], plain[5]])
    del plain
    d_ms = cuda_ms(lambda: core_stash.sdf_stash_fwd(aw, x, scfg, stash_us=True), 10)
    d_plain_ms = cuda_ms(lambda: core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, "bfloat16", "bfloat16", return_us=True),
                         3, warmup=1)
    # D's operations; its inputs, outputs and the wider stash.
    d_flops = 2.0 * n_pts * (2 * hidden + d_last * (1 + d_feat))
    d_bound, d_by = bound(d_flops, n_pts * (4 * (3 + 1 + d_feat + 3) + 2 * width) + 2 * n_w, H100_BF16_FLOPS)
    d_dev = profiled_groups(lambda: core_stash.sdf_stash_fwd(aw, x, scfg, stash_us=True)).get(D_ALL_GROUP, 0.0)
    d0_dev = profiled_groups(lambda: core_stash.sdf_stash_fwd(aw, x, scfg)).get("kernel D sdf_stash_fwd", 0.0)
    log(f"[13(a) kernel D stash_all] sdf_stash_all_fwd: N={n_pts}, stash [{n_pts}, {width}] bf16 "
        f"({n_pts * width * 2 / 1e6:.1f} MB against plain D's {n_pts * gt * 2 / 1e6:.1f} MB); sdf, feat, grad and the "
        f"h_i equal plain D's bit for bit; max abs err against its plain version {d_abs:.3e} (rel {d_rel:.3e}, tol "
        f"{TOL['sdf_stash_fwd']}); {d_ms:.4f} ms, plain {d_plain_ms:.4f} ms, bound {d_bound:.4f} ms ({d_by}); one "
        f"profiled call, device time {d_dev:.4f} ms against plain D's {d0_dev:.4f} ms in this call; on {smi}")
    if not d_rel <= TOL["sdf_stash_fwd"]:
        raise AssertionError(f"kernel D's stash_all variant disagrees with its plain version: rel {d_rel:.3e}")

    e_dws, e_dx = core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, stash_us=True)
    e2_dws, e2_dx = core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, stash_us=True)
    if not (torch.equal(e_dx, e2_dx) and all(torch.equal(a, b) for a, b in zip(e_dws, e2_dws))):
        raise AssertionError("kernel E's stash_all variant's gradients differ between two runs")
    del e2_dws, e2_dx
    parts = core_stash.split_stash(d_all[3], cols)

    def e_plain():
        return core_stash.sdf_core_bwd_stash_all_plain(aw, x, parts[:L], parts[L : 2 * L], parts[2 * L], cots, scfg,
                                                       "bfloat16")

    p_dws, p_dx = e_plain()
    e_abs, e_rel = grad_err([e_dx, *e_dws], [p_dx, *p_dws])
    del p_dws, p_dx
    e_ms = cuda_ms(lambda: core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, stash_us=True), 10)
    e_plain_ms = cuda_ms(e_plain, 3, warmup=1)
    # Multiply-adds per point: E's without the recomputed reverse sweep
    # (the sweep's VJP, the z-chain and the two dW halves, 4 x hidden), the
    # feature head's VJP and dW, the sdf head's two columns; it reads the
    # wider stash.
    e_flops = 2.0 * n_pts * (4 * hidden + 2 * d_last * d_feat + 2 * d_last)
    in_out = n_pts * (2 * width + 4 * (3 + 1 + d_feat + 3) + 4 * 3)
    e_bound, e_by = bound(e_flops, in_out + 2 * n_w + 4 * n_w, H100_BF16_FLOPS)
    layers_pk = [(w_.shape[0], w_.shape[1]) for w_ in aw[0 : 2 * L : 2]]
    op_bytes = 2.0 * (2 * n_pts * sum(i + o_ for i, o_ in layers_pk) + n_pts * (d_last + d_feat))
    e1_bound, e1_by = bound(2.0 * n_pts * (2 * hidden + d_last * d_feat + 2 * d_last), in_out + op_bytes + 2 * n_w,
                            H100_BF16_FLOPS)
    e_parts = profiled_groups(lambda: core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, stash_us=True))
    e0_parts = profiled_groups(lambda: core_stash.sdf_stash_bwd(aw, x, d_ref[3], cots, scfg))
    e1_dev, e1_plain_dev = e_parts.get(E1_ALL_GROUP, 0.0), e0_parts.get("kernel E sdf_stash_bwd (E1)", 0.0)
    none, dx_only = core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, need_dw=False, stash_us=True)
    if none is not None or not torch.equal(dx_only, e_dx):
        raise AssertionError("kernel E's stash_all variant without its dW passes gives another dx")
    nodw = profiled_groups(lambda: core_stash.sdf_stash_bwd(aw, x, d_all[3], cots, scfg, need_dw=False,
                                                           stash_us=True))
    log(f"[13(a) kernel E stash_all] sdf_stash_all_bwd: N={n_pts}, repeats bit for bit, max abs err against its plain "
        f"version {e_abs:.3e} (rel to each gradient {e_rel:.3e}, tol {TOL['sdf_stash_bwd']}), {e_ms:.4f} ms, plain "
        f"{e_plain_ms:.4f} ms, bound {e_bound:.4f} ms ({e_by}, {e_flops / 1e9:.1f} GFLOP); one profiled call, device "
        f"time: E1 {e1_dev:.4f} ms (bound {e1_bound:.4f} ms, {e1_by}) against plain E's E1 {e1_plain_dev:.4f} ms in "
        f"this call, dW passes {e_parts.get(DW_GROUP, 0.0):.4f} ms against {e0_parts.get(DW_GROUP, 0.0):.4f} ms; "
        f"need_dw=False: dx bit for bit, {sum(nodw.values()):.4f} ms (dW passes {nodw.get(DW_GROUP, 0.0):.4f} ms); "
        f"on {smi}")
    if not e_rel <= TOL["sdf_stash_bwd"]:
        raise AssertionError(f"kernel E's stash_all variant disagrees with its plain version: rel {e_rel:.3e}")
    return {"d": (d_abs, d_ms, d_plain_ms, d_bound, d_by), "e": (e_abs, e_ms, e_plain_ms, e_bound, e_by)}


def stash_all_registration(smi: str, dev, td: dict) -> None:
    """13(c): a test view's registration under stash_all (no weight needs a
    gradient: E's variant without its dW passes) through its graph against
    the eager loop, STASH_ALL_REG steps from one generator, bit for bit;
    D's and E's variants once a step; one profiled call's device time by
    group, with no dW pass in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.render.renderer import init_model_params

    cfg = with_renderer(td["cfg"], core_backward="stash_all")
    gen = torch.Generator().manual_seed(0)
    params = {"renderer": init_model_params(cfg.model, gen, device=dev)}
    params["raygen"], buffers = ray_generator_init(gen, cfg.ray_generator, td["n_views"], device=dev)
    H, W = td["camera"].H, td["camera"].W
    hh, ww = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    view = PixelBundle(h_indices=hh.float(), w_indices=ww.float(), poses=td["poses"][0].expand(H, W, 4, 4),
                       pls=td["pls"][0].expand(H, W, 3), img_indices=torch.zeros((H, W), dtype=torch.long, device=dev),
                       rgb_gt=td["images"][0])
    ev = Evaluator(cfg, td["camera"], buffers, device="cuda")
    n = STASH_ALL_REG
    ref = ev._register_view_eager(params, view, steps=n)["raygen"]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = ev.register_view(params, view, steps=n)["raygen"]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / n
    launches_check("13(c) registration", dict(cuda_lib.launch_counts),
                   dict(sdf_stash_all_fwd=1, sdf_stash_all_bwd=1, shadow_final=1, round_machinery=8), n)
    worst = snapshot_err(out, ref)
    if worst[0] > 1e-6:
        raise AssertionError(f"the stash_all registration graph differs from the eager loop: {worst}")
    if all(torch.equal(out[k], params["raygen"][k]) for k in out):
        raise AssertionError("the stash_all registration moved no raygen leaf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.register_view(params, view, steps=n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.register_view(params, view, steps=n)
        torch.cuda.synchronize()
    groups = {k: v / n for k, v in sorted(device_groups(prof).items(), key=lambda kv: -kv[1])}
    if groups.get(E1_ALL_GROUP, 0.0) <= 0.0 or groups.get(DW_GROUP, 0.0) > 0.0:
        raise AssertionError(f"a stash_all registration step should run E's variant and no dW pass: {groups}")
    busy = sum(groups.values())
    verdict = "bit for bit" if worst[0] == 0.0 else f"within {worst[0]:.3e} of {worst[1]}'s scale"
    log(f"[13(c) registration stash_all] {n} steps of a {H}x{W} test view: against the eager loop {verdict}; "
        f"{wall_ms:.3f} ms a step through the graph (the first call {first_ms:.3f}); device busy {busy:.3f} ms a step, "
        f"idle share {1 - busy / wall_ms:.3f}; by group (ms a step) "
        + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()) + f"; on {smi}")


# The original code's names of the background NeRF's layers other than
# pts_linears.{i}.
BG_NAMES = {"views_lin0": "views_linears.0", "feature": "feature_linear", "alpha": "alpha_linear",
            "rgb": "rgb_linear"}


def reference_state_dict(cfg, n_images: int, seed: int) -> dict:
    """A ``pipeline.state_dict()`` of the original PyTorch code for ``cfg``
    with random values from ``seed``: its key names, the shapes of a fresh
    init of ``cfg`` (weights stored [out, in], weight norm's g [out, 1], the
    background NeRF where the config has it) and the raygen tables
    [n_images, .] the config learns."""
    import torch

    from nrhints_torch.render.renderer import init_model_params

    fresh = init_model_params(cfg.model, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for net, sub in (("sdf_network", "sdf"), ("color_network", "color")):
        for name, p in fresh[sub].items():
            d_in, d_out = p["v"].shape
            key = f"renderer.{net}.{name}"
            sd[f"{key}.weight_v"] = torch.randn((d_out, d_in), generator=g) / math.sqrt(d_in)
            sd[f"{key}.weight_g"] = 1.0 + 0.1 * torch.randn((d_out, 1), generator=g)
            sd[f"{key}.bias"] = 0.01 * torch.randn((d_out,), generator=g)
    sd["renderer.deviation_network.variance"] = torch.tensor(0.3)
    for name, p in fresh.get("bg", {}).items():
        key = "renderer.outside_nerf." + BG_NAMES.get(name, name.replace("pts_lin", "pts_linears."))
        d_in, d_out = p["w"].shape
        sd[f"{key}.weight"] = torch.randn((d_out, d_in), generator=g) / math.sqrt(d_in)
        sd[f"{key}.bias"] = 0.01 * torch.randn((d_out,), generator=g)
    if cfg.ray_generator.cam_opt_mode != "off":
        sd["ray_generator.cam_pose_adjustment"] = 0.001 * torch.randn((n_images, 6), generator=g)
    if cfg.ray_generator.pl_opt:
        sd["ray_generator.pl_adjustment"] = 0.001 * torch.randn((n_images, 3), generator=g)
    return sd


def import_phase(smi: str, tmp: Path) -> None:
    """13(d): a fake checkpoint of the original code at full
    nr-hints-cam-opt width (phase 9's scene: 8 + 1 + 2 views at 128x128),
    imported by ``python -m nrhints_torch.import_ckpt``'s main in this
    process on the card, then the Trainer on the card under stash_all
    resumes from it: its params equal the converted ones bit for bit, and
    IMPORT_STEPS steps (D's and E's variants once each) give finite
    losses."""
    import torch

    from nrhints_torch.configs.cli import parse_cli
    from nrhints_torch.configs.config import DEFAULT_PRESET, PRESETS
    from nrhints_torch.data.synthetic import make_hints_scene
    from nrhints_torch.import_ckpt import convert_pipeline_state_dict, main as import_main
    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.train.trainer import Trainer
    from nrhints_torch.utils import tree_items

    scene = make_hints_scene(tmp / "scene13", 8, 1, 2, 128, 128, seed=0)
    argv = ["config:nr-hints-cam-opt", "--config.data.path", str(scene), "--config.base-dir", str(tmp / "runs13"),
            "--config.model.batch-size", "512", "--config.model.renderer.core-backward", "stash_all",
            "--config.parallel.data-axis-size", "1"]
    cfg = parse_cli(PRESETS, DEFAULT_PRESET, argv)
    sd = reference_state_dict(cfg, 11, seed=13)
    ckpt = tmp / "Scene_step_0123456.ckpt"
    torch.save({"world_size": 1, "global_step": IMPORT_GLOBAL_STEP, "pipeline": {f"module.{k}": v for k, v in sd.items()},
                "optimizer": {}, "scheduler": {}}, ckpt)
    t0 = time.perf_counter()
    out = import_main([str(ckpt), *argv])
    import_s = time.perf_counter() - t0
    trainer = Trainer(cfg)
    if trainer.global_step != IMPORT_GLOBAL_STEP or out != trainer.ckpt_io.ckpt_dir / f"step_{IMPORT_GLOBAL_STEP:07d}":
        raise AssertionError(f"the Trainer resumed at {trainer.global_step} from {out}")
    converted = dict(tree_items(convert_pipeline_state_dict(sd)[0]))
    live = {k: t.detach().cpu() for k, t in tree_items(trainer.state.params)}
    if sorted(live) != sorted(converted) or not all(torch.equal(live[k], t) for k, t in converted.items()):
        raise AssertionError("the resumed Trainer's params differ from the imported ones")
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(IMPORT_STEPS):
        losses.append(trainer.train_iter()["loss"])
        trainer.global_step += 1
    losses = [float(v) for v in losses]
    step_s = (time.perf_counter() - t0) / IMPORT_STEPS
    launches_check("13(d) imported run", dict(cuda_lib.launch_counts),
                   dict(sdf_stash_all_fwd=1, sdf_stash_all_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1, round_machinery=8,
                        shadow_final=1), IMPORT_STEPS)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses after the import: {losses}")
    log(f"[13(d) import] main() wrote {out.relative_to(tmp)} in {import_s:.2f} s; the Trainer on the card resumed at "
        f"step {IMPORT_GLOBAL_STEP} with the {len(converted)} imported leaves bit for bit and trained {IMPORT_STEPS} "
        f"steps under stash_all, {step_s:.4f} s/step on {smi}: losses {[round(v, 5) for v in losses]}")
    del trainer


def entry(name, source, replaces, launches_, err, ms, plain_ms, bound_ms, by) -> dict:
    """One kernel of the kernels line."""
    return {"name": name, "route": "cuda", "source": f"nrhints_torch/csrc/{source}",
            "replaces": f"nrhints_tpu/kernels/{replaces}", "launches": launches_, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def stash_all_entries(sa: dict) -> list:
    """The kernels line's entries of D's and E's stash_all variants, their
    launches those of phase 13(b)'s stash_all dispatch."""
    return [entry("sdf_stash_all_fwd", "sdf_core.cu", "core_stash.py:369", sa["launches"]["sdf_stash_all_fwd"],
                  *sa["d"]),
            entry("sdf_stash_all_bwd", "sdf_stash.cu", "core_stash.py:422", sa["launches"]["sdf_stash_all_bwd"],
                  *sa["e"])]


def stash_all_phase(smi: str, dev, mc: dict, td: dict, tmp: Path) -> dict:
    """Phase 13, core_backward="stash_all" and the import: (a) D's and E's
    variants at phase 3's shapes; (b) K = STASH_ALL_K train steps of
    nr-hints-cam-opt as one CUDA graph against as many eager steps, under
    "stash" and then "stash_all" in this call (s/step, peak memory, idle
    share), D's and E's variants once a step; (c) a registration; (d) the
    import of a checkpoint of the original code and a resumed run.  -> the
    numbers of the kernels line, with the launches of (b)'s dispatch."""
    t_phase = time.perf_counter()
    out = stash_all_kernels(smi, dev, mc)
    batches = [td["next_batch"]() for _ in range(max(STASH_ALL_K, TRAIN_WARMUP))]
    march = dict(round_machinery=8, shadow_final=1)
    trunk = dict(mlp_stash_fwd=1, mlp_stash_bwd=1)
    stash = scan_phase(smi, dev, td, batches, "graph 13(b) stash", td["cfg"], STASH_ALL_K,
                       dict(sdf_stash_fwd=1, sdf_stash_bwd=1, **trunk, **march))
    sa = scan_phase(smi, dev, td, batches, "graph 13(b) stash_all", with_renderer(td["cfg"], core_backward="stash_all"),
                    STASH_ALL_K, dict(sdf_stash_all_fwd=1, sdf_stash_all_bwd=1, **trunk, **march))
    log(f"[13(b)] {STASH_ALL_K}-step graphs in this call: stash_all {sa['graph_s']:.5f} s/step (eager "
        f"{sa['eager_s']:.5f}), stash {stash['graph_s']:.5f} s/step (eager {stash['eager_s']:.5f}); peak device memory "
        f"{sa['peak_gb']:.3f} GB against {stash['peak_gb']:.3f} GB; idle share {sa['idle']:.3f} against "
        f"{stash['idle']:.3f}; on {smi}")
    out["launches"] = sa["launches"]
    stash_all_registration(smi, dev, td)
    import_phase(smi, tmp)
    log(f"[13] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 14: march_dtype="float32".  The f32 instances of C, K, L, M and N
# against their plain f32 versions on phase 3's inputs: the same f32
# products summed in another order (sequential FMAs against the card's f32
# GEMM), so sdf0 differs by a few ulps of a sweep's sums and tau by those
# passed through sigmoid(inv_s x) and 127 log factors; K's sdf0 at
# F32_TOL["sdf0"] and C's and N's tau at F32_TOL["tau"] of max(1, scale).
# L's and M's z by Z_NN_SHARE as in bf16 (phase 3), their shares printed
# beside bf16's.  The views of (b) against the CPU at CPU_TOL, and the
# K = F32_K graph of (c) against its eager steps bit for bit.
F32_TOL = {"sdf0": 1e-5, "tau": 1e-4}
F32_K = 16
F32_ROUTES = {  # 14(b)'s views: renderer settings, launches a chunk beside sdf_core_fwd's one
    "shipping": ({}, dict(round_machinery=8, shadow_final_f32=1)),
    "monolith": (MONOLITH, dict(importance_march_f32=1, shadow_march_f32=1)),
    "split": (SPLIT, dict(march_sweep_f32=1, march_rounds_f32=1, importance_march_f32=1, shadow_final_f32=1)),
}


def march_f32_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 14(a): K, L, M, N and C's f32 instances at phase 3's shapes
    against their plain f32 versions; L = B's steps between K's sweeps, M =
    L(K(.)) and N = C(M(.)) (both merges) bit for bit; each timed by CUDA
    events beside its plain version, and by device time from one profiled
    call beside the bf16 instance's in this call and the f32 bound.  ->
    per kernel (max abs err, ms, plain ms, bound ms, bound by)."""
    import torch

    from nrhints_torch.fields.sdf import _layer_dims
    from nrhints_torch.kernels import march

    cfg = mc["cfg"]
    scfg = cfg.model.sdf_network
    o, d, z0, w16 = mc["o"], mc["d"], mc["z0"], mc["mw"]
    sl, sdir, sdist, z0s, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "z0s", "inv_s", "anneal"))
    sdf_params = mc["renderer_params"]["sdf"]
    w32 = march.march_weights(sdf_params, scfg, "float32")
    sz = march.fused_importance_z(sdf_params, scfg, sl, sdir, z0s, mlp_dtype="float32", split=True,
                                  sweep_impl="xla", rounds_impl="xla")
    io, dims = _layer_dims(scfg)
    vm = sum(i * o_ for i, o_ in io) + dims[-2]  # multiply-adds of a value sweep a point
    w_bytes = 4 * vm
    bounds = {
        "C": bound(2.0 * 512 * 128 * 2 * vm, 512 * 4 * (128 + 3 + 3 + 1 + 1) + w_bytes, H100_F32_FLOPS),
        "K": bound(2.0 * 512 * 64 * vm, 512 * 4 * (64 + 3 + 3 + 64) + w_bytes, H100_F32_FLOPS),
        "L": bound(2.0 * 512 * 48 * vm, 512 * 4 * (64 + 64 + 3 + 3 + 128) + w_bytes, H100_F32_FLOPS),
        "M": bound(2.0 * 512 * 112 * vm, 512 * 4 * (64 + 3 + 3 + 128) + w_bytes, H100_F32_FLOPS),
        "N": bound(2.0 * 512 * (112 * vm + 128 * 2 * vm), 512 * 4 * (64 + 3 + 3 + 1 + 1) + w_bytes, H100_F32_FLOPS),
    }

    def scaled(k, p) -> tuple[float, float]:
        e = (k - p).abs().max().item()
        return e, e / max(1.0, p.abs().max().item())

    k_sdf0 = march.march_sweep(z0, o, d, w32, scfg)
    k_err = scaled(k_sdf0, march.march_sweep_plain(z0, o, d, w32, scfg))
    c_tau = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, w32, scfg)
    c_err = scaled(c_tau, march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, w32, scfg))
    l_z = march.march_rounds(z0, k_sdf0, o, d, w32, scfg)
    l_is_bk = torch.equal(l_z, march._rounds(w32, scfg, o, d, z0, k_sdf0, 4, 16, 64.0, "bitonic",
                                             march.round_machinery, sweep16(o, d, w32, scfg)))
    l_abs, l_slots, l_share, l_sorted = z_err(l_z, march.march_rounds_plain(z0, k_sdf0, o, d, w32, scfg), z0)
    m_z = march.importance_march(z0, o, d, w32, scfg)
    m_abs, m_slots, m_share, m_sorted = z_err(m_z, march.importance_march_plain(z0, o, d, w32, scfg), z0)
    m_is_lk = torch.equal(m_z, l_z)
    n_err, n_is_cm = (0.0, 0.0), {}
    for merge in ("bitonic", "rank"):
        n_tau = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w32, scfg, merge=merge)
        n_is_cm[merge] = torch.equal(n_tau, march.shadow_final(
            march.importance_march(z0s, sl, sdir, w32, scfg, merge=merge), sl, sdir, sdist, inv_s, anneal, w32, scfg))
        n_err = max(n_err, scaled(n_tau, march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, w32, scfg,
                                                                   merge=merge)))
    calls = {
        "C": (lambda w: march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, w, scfg),
              lambda: march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, w32, scfg), "shadow_final"),
        "K": (lambda w: march.march_sweep(z0, o, d, w, scfg),
              lambda: march.march_sweep_plain(z0, o, d, w32, scfg), "march_sweep"),
        "L": (lambda w: march.march_rounds(z0, k_sdf0, o, d, w, scfg),
              lambda: march.march_rounds_plain(z0, k_sdf0, o, d, w32, scfg), "march_rounds"),
        "M": (lambda w: march.importance_march(z0, o, d, w, scfg),
              lambda: march.importance_march_plain(z0, o, d, w32, scfg), "importance_march"),
        "N": (lambda w: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, scfg),
              lambda: march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, w32, scfg), "shadow_march"),
    }
    errs = {"C": c_err, "K": k_err, "L": (l_abs, 0.0), "M": (m_abs, 0.0), "N": n_err}
    out = {}
    for name, (kern, plain, fn) in calls.items():
        ms, plain_ms = cuda_ms(lambda: kern(w32), 10), cuda_ms(plain, 3, warmup=1)
        dev32 = kernel_device_ms(lambda: kern(w32), f"kernel {name} f32 {fn}_f32")
        dev16 = kernel_device_ms(lambda: kern(w16), f"kernel {name} {fn}")
        bd, by = bounds[name]
        out[name] = (errs[name][0], ms, plain_ms, bd, by)
        log(f"[14(a) kernel {name} f32] {fn}_f32: B=512, max abs err against its plain f32 version "
            f"{errs[name][0]:.3e}; {ms:.4f} ms, plain {plain_ms:.4f} ms; device time (median of the profiled calls that "
            f"record it) {dev32:.4f} ms against the bf16 instance's {dev16:.4f} ms in this run; f32 bound {bd:.4f} ms ({by}, at "
            f"{H100_F32_FLOPS / 1e12:.0f} TFLOP/s f32), {dev32 / bd:.2f}x it; on {smi}")
    log(f"[14(a)] K's sdf0 {k_err[1]:.3e} of its scale (tol {F32_TOL['sdf0']}); C's tau {c_err[1]:.3e}, N's "
        f"{n_err[1]:.3e} (tol {F32_TOL['tau']}); L's z: {l_share:.4f} of the samples within {Z_TOL} of a plain "
        f"sample, slot by slot {l_slots:.4f}; M's {m_share:.4f} and {m_slots:.4f} (bf16's M, PR 4: 0.9100 and "
        f"0.8637; tol {Z_NN_SHARE}); L = B's steps between K's sweeps bit for bit: {l_is_bk}; M = L(K(.)): "
        f"{m_is_lk}; N = C(M(.)): {n_is_cm}")
    if not (k_err[1] <= F32_TOL["sdf0"] and c_err[1] <= F32_TOL["tau"] and n_err[1] <= F32_TOL["tau"]):
        raise AssertionError(f"14(a): an f32 instance disagrees with its plain version: K {k_err}, C {c_err}, N {n_err}")
    if not (l_sorted and m_sorted and l_share >= Z_NN_SHARE and m_share >= Z_NN_SHARE):
        raise AssertionError(f"14(a): L's or M's f32 z disagree with the plain march: {l_share:.4f}, {m_share:.4f}")
    if not (l_is_bk and m_is_lk and all(n_is_cm.values())):
        raise AssertionError(f"14(a): an f32 identity fails: L = B/K {l_is_bk}, M = L(K) {m_is_lk}, N = C(M) {n_is_cm}")
    return out


def march_f32_phase(smi: str, dev, mc: dict, td: dict) -> dict:
    """Phase 14, march_dtype="float32" on the card: (a) the f32 instances at
    phase 3's shapes (``march_f32_kernels``); (b) phase 4's full-width
    128x128 view at march_dtype="float32" through its graph on the shipping
    route (kernel C's f32 instance), the round-4 monolith (M and N's) and
    the split march (K, L, M and C's), each with its exact launches, its
    graph against its eager sweep bit for bit and 64 pixels against the
    CPU; (c) a K = F32_K graph of stash train steps of nr-hints-cam-opt at
    march_dtype="float32" against as many eager steps, bit for bit.  -> the
    kernels line's entries of the five f32 instances, their launches those
    of (b)'s views."""
    t_phase = time.perf_counter()
    out = march_f32_kernels(smi, dev, mc)
    cfg, camera = mc["cfg"], mc["camera"]
    n_chunks = -(-camera.H * camera.W // cfg.model.inference_chunk_size)
    launches = {}
    for name, (kw, per_chunk) in F32_ROUTES.items():
        offpath_view(f"14(b) f32 {name}", smi, dev, with_renderer(cfg, march_dtype="float32", **kw), camera,
                     {"renderer": mc["renderer_params"], "raygen": {}}, mc["pose"], mc["pl"],
                     dict(sdf_core_fwd=1, **per_chunk))
        launches.update({k: v * n_chunks for k, v in per_chunk.items() if k.endswith("_f32")})
    batches = [td["next_batch"]() for _ in range(max(F32_K, TRAIN_WARMUP))]
    scan_phase(smi, dev, td, batches, "graph 14(c) f32 march", with_renderer(td["cfg"], march_dtype="float32"), F32_K,
               dict(sdf_stash_fwd=1, sdf_stash_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1, round_machinery=8,
                    shadow_final_f32=1))
    log(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    where = {"C": ("shadow_final_f32", "march.cu", "march.py:574"),
             "K": ("march_sweep_f32", "march_fused.cu", "march.py:507"),
             "L": ("march_rounds_f32", "march_fused.cu", "march.py:522"),
             "M": ("importance_march_f32", "march_fused.cu", "march.py:488"),
             "N": ("shadow_march_f32", "march_fused.cu", "march.py:595")}
    return {"entries": [entry(fn, src, rep, launches[fn], *out[k]) for k, (fn, src, rep) in where.items()]}


# Phase 16: the SDF core's f32 instances (compute_dtype="float32", and the
# f32 stash of stash_dtype="float32").  Tolerances against the plain
# versions on the card (f32 matmuls without TF32), as tests/test_torch_gpu.py
# holds them: exact f32 dots on both sides summed in other orders, so the
# outputs and an f32 stash within CORE_F32_TOL["out"] of max(1, scale) and
# each gradient within CORE_F32_TOL["grad"] of its own scale; a bf16 stash
# within TOL["sdf_stash_fwd"] (an f32 value within an ulp of a bf16 rounding
# boundary rounds the other way), E read at the kernel's own stash on both
# sides; the instance with bf16 operands and an f32 stash at the bf16
# instances' TOL.  16(b)'s entry points against autograd over the plain
# forward at the same dtype: CORE_F32_TOL at f32 operands and stash, TOL's
# gradient tolerance where a bf16 stash or bf16 operands enter the
# backward (autograd's backward dots run on f32 cotangents there).
CORE_F32_TOL = {"out": 1e-5, "grad": 1e-4}
# (compute, stash) of D's and E's instances in 16(a).
CORE_F32_PAIRS = (("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"))
# 16(b)'s calls: (label, entry point keywords or a backward schedule).
CORE_F32_CALLS = (
    ("fused_sdf_value_feat_grad recompute", dict(backward="recompute")),
    ("fused_sdf_value_feat_grad stash", dict(backward="stash")),
    ("fused_sdf_value_feat_grad stash_all", dict(backward="stash_all")),
    ("fused_sdf_value_feat_grad stash_xla", dict(backward="stash_xla")),
    ("fused_sdf_value_feat_grad_stash f32/f32", dict(stash_dtype="float32")),
    ("fused_sdf_value_feat_grad_stash f32/f32 stash_us", dict(stash_dtype="float32", stash_us=True)),
    ("fused_sdf_value_feat_grad_stash bf16/f32", dict(compute_dtype="bfloat16", stash_dtype="float32")),
    ("fused_sdf_value_feat_grad_stash bf16/f32 stash_us", dict(compute_dtype="bfloat16", stash_dtype="float32",
                                                              stash_us=True)),
)


# Phase 21: the SDF core's wide f32 instances (A, D, E, H and D's and E's
# stash_all variants above the presets' widths at every dtype pair with an
# f32 in it), as phase 16 at WIDE_CORE_F32: 512 wide with multi_res 11 (a
# 69-wide encoding, padded 80), so every width of the wide class's f32 path
# and its encoding path run; each instance against its plain f32 version
# at CORE_F32_TOL (TOL where bf16 operands or a bf16 stash enter), beside
# the wide bf16 instance's and the 64-point f32 instance's device time in
# the same call and its f32 bound; then both entry points at every
# (compute_dtype, stash_dtype, stash_us), launches exact.  The plain run
# runs it as --wide-core-f32 in a process of its own, as phase 20.
WIDE_CORE_F32 = {"d_hidden": 512, "multi_res": 11}
# The 64-point bf16 instances' device-time groups -> the wide ones'.
BF16_WIDE_GROUPS = {
    "kernel A sdf_core_fwd": WIDE_MODES[("sdf_core_fwd_wide_kernel", "0")],
    "kernel D sdf_stash_fwd": WIDE_MODES[("sdf_core_fwd_wide_kernel", "1")],
    "kernel H, forward pass (H1)": WIDE_MODES[("sdf_core_fwd_wide_kernel", "2")],
    D_ALL_GROUP: WIDE_MODES[("sdf_core_fwd_wide_kernel", "3")],
    "kernel E sdf_stash_bwd (E1)": WIDE_MODES[("sdf_bwd_chain_wide_kernel", "false, false")],
    "kernel H chain (H2)": WIDE_MODES[("sdf_bwd_chain_wide_kernel", "true, false")],
    E1_ALL_GROUP: WIDE_MODES[("sdf_bwd_chain_wide_kernel", "false, true")],
}


def core_f32_group(kernel: str, compute: str, stash: str | None) -> str:
    """The group of an SDF core or trunk instance: the kernel's label, then
    the instance's dtypes (f32 operands and stash, or the mixed pair)."""
    return f"{kernel} {compute}/{stash or compute}"


def instance_record(phase: str, out: dict, base_dev: dict, n_pts: int, smi: str, name: str, checks, fn, plain_fn,
                    group, base_fn, base_group, bd, *, base: str = "the bf16 instance's", iters: int = 10,
                    tries: int = 3, extra=None) -> None:
    """Time an instance and log it (phases 16(a), 17(a), 18(a) and 21(a)):
    CUDA events around ``fn`` (``iters`` launches) and its plain version,
    ``group``'s device time (the median of the ``tries`` profiled calls that
    record it) beside ``base``'s device time in this call (``base_fn``'s
    ``base_group``: the bf16 instance's for an f32 or mixed one, the
    256-wide instance's for a wide one; profiled ``tries`` times once a
    call into ``base_dev``), beside ``extra``'s = (label, fn, group) where
    given (21(a): the 64-point instance of the same dtypes), and the bound
    ``bd``; checks: (what, (abs err, rel err), tol) against the plain
    version, each raising past its tol.  -> out[name] = (max abs err, ms,
    plain ms, bound ms, bound by)."""
    ms, plain_ms = cuda_ms(fn, iters), cuda_ms(plain_fn, 3, warmup=1)
    dev_ms = kernel_device_ms(fn, group, tries)
    if base_group not in base_dev:
        base_dev[base_group] = kernel_device_ms(base_fn, base_group, tries)
    also = ""
    if extra is not None:
        extra_ms = kernel_device_ms(extra[1], extra[2], tries)
        also = f", and {extra[0]} {extra_ms:.4f} ms ({dev_ms / extra_ms:.2f}x)"
    out[name] = (max(e[0] for _, e, _ in checks), ms, plain_ms, bd[0], bd[1])
    errs = "; ".join(f"{what} {e[0]:.3e} (rel {e[1]:.3e}, tol {tol})" for what, e, tol in checks)
    log(f"[{phase} {name}] N={n_pts}: max abs err against its plain version: {errs}; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; device time {dev_ms:.4f} ms against {base} {base_dev[base_group]:.4f} ms in this "
        f"call ({dev_ms / base_dev[base_group]:.2f}x){also}; bound {bd[0]:.4f} ms ({bd[1]}), {dev_ms / bd[0]:.2f}x "
        f"it; on {smi}")
    for what, e, tol in checks:
        if not e[1] <= tol:
            raise AssertionError(f"{phase}: {name}'s {what} disagree with its plain version: rel {e[1]:.3e} "
                                 f"(tol {tol})")


def core_f32_case(dev, mc: dict, wide: bool) -> tuple:
    """(SDF config, its f32 core weights, its weight-norm params, launch
    counter suffix) of phase 16 (phase 3's nr-hints SDF) or, with ``wide``,
    of phase 21 (WIDE_CORE_F32, random weights from seed 0)."""
    import torch

    from nrhints_torch.fields.sdf import sdf_init
    from nrhints_torch.kernels import core_mlp

    if not wide:
        return mc["cfg"].model.sdf_network, mc["aw"], mc["renderer_params"]["sdf"], ""
    scfg = dataclasses.replace(mc["cfg"].model.sdf_network, **WIDE_CORE_F32)
    if core_mlp.core_class(scfg) is not core_mlp.WIDE:
        raise AssertionError(f"21: {WIDE_CORE_F32} does not take the wide instances")
    params = sdf_init(torch.Generator().manual_seed(0), scfg, dev)
    return scfg, core_mlp.materialize_sdf_weights_full(params, scfg), params, core_mlp.WIDE.suffix


def core_f32_kernels(smi: str, dev, mc: dict, wide: bool = False) -> dict:
    """Phase 16(a): at phase 3's 65,536 points and the full nr-hints width,
    A's and H's f32 instances and D's, E's and their stash_all variants'
    instances at each CORE_F32_PAIRS pair against their plain versions; D's
    outputs equal A's at the same operand dtype bit for bit; E and H repeat
    bit for bit and E's dx is the same without its dW passes; f32 E against
    f32 H.  Each timed by CUDA events beside its plain version and by device
    time (the median of the profiled calls that record it) beside the bf16
    instance's in this call and its bound.  With ``wide``, phase 21(a): the
    same for the wide instances at WIDE_CORE_F32 (``core_f32_case``), each
    beside the wide bf16 instance's device time and the 64-point instance's
    of the same dtypes at phase 3's weights.  -> {instance name: (max abs
    err, ms, plain ms, bound ms, bound by)}."""
    import numpy as np
    import torch

    from nrhints_torch.fields.sdf import _layer_dims
    from nrhints_torch.kernels import core_mlp, core_stash

    torch.backends.cuda.matmul.allow_tf32 = False
    phase = "21(a)" if wide else "16(a)"
    x, nw, ncfg = mc["x"], mc["aw"], mc["cfg"].model.sdf_network
    scfg, aw, _, sfx = core_f32_case(dev, mc, wide)
    n_pts, n_w, L = x.shape[0], sum(w.numel() for w in aw), scfg.n_layers
    io, dims = _layer_dims(scfg)
    hidden, d_last, d_feat = sum(i * o_ for i, o_ in io), dims[-2], scfg.d_out_feat

    def cotangents(d):
        crng = np.random.default_rng(5)
        return tuple(torch.tensor(crng.normal(size=shape).astype(np.float32), device=dev)
                     for shape in ((n_pts,), (n_pts, d), (n_pts, 3)))

    cots, ncots = cotangents(d_feat), cotangents(ncfg.d_out_feat)
    io_bytes = n_pts * 4 * (3 + 1 + d_feat + 3)  # x in; sdf, feat and grad out (the cotangents and dx alike)
    fwd_flops = 2.0 * n_pts * (2 * hidden + d_last * (1 + d_feat))
    bwd_flops = {False: 2.0 * n_pts * (5 * hidden + 2 * d_last * d_feat + 2 * d_last),
                 True: 2.0 * n_pts * (4 * hidden + 2 * d_last * d_feat + 2 * d_last)}

    def size(dt):
        return 4 if dt == "float32" else 2

    def peak(compute):
        return H100_F32_FLOPS if compute == "float32" else H100_BF16_FLOPS

    def group(label, compute, stash):
        return (wide_group if wide else core_f32_group)(label, compute, stash)

    def bf16_group(g):
        """The bf16 instance's group of this class."""
        return BF16_WIDE_GROUPS.get(g, g) if wide else g

    def narrow(label, fn, groups):
        """extra: the 64-point instance of the same dtypes (21(a) only)."""
        return (f"the 64-point {label}", fn, groups) if wide else None

    out: dict = {}
    # Phase 21 reads each device time from one profiled call (its process is
    # fresh), phase 16 the median of three.
    record = functools.partial(instance_record, phase, out, {}, n_pts, smi, tries=1 if wide else 3,
                               base="the wide bf16 instance's" if wide else "the bf16 instance's")

    # A.
    a32 = core_mlp.sdf_core_fwd(aw, x, scfg, compute_dtype="float32")
    a16 = core_mlp.sdf_core_fwd(aw, x, scfg)
    record("sdf_core_fwd_f32" + sfx,
           [("outputs", max_err(a32, core_mlp.sdf_core_plain(aw, x, scfg, "float32")), CORE_F32_TOL["out"])],
           lambda: core_mlp.sdf_core_fwd(aw, x, scfg, compute_dtype="float32"),
           lambda: core_mlp.sdf_core_plain(aw, x, scfg, "float32"), group("kernel A", "float32", None),
           lambda: core_mlp.sdf_core_fwd(aw, x, scfg), bf16_group("kernel A sdf_core_fwd"),
           bound(fwd_flops, io_bytes + 4 * n_w, H100_F32_FLOPS),
           extra=narrow("sdf_core_fwd_f32", lambda: core_mlp.sdf_core_fwd(nw, x, ncfg, compute_dtype="float32"),
                        core_f32_group("kernel A", "float32", None)))

    # D, E and their stash_all variants at each pair.
    e_f32 = None
    for us in (False, True):
        width = core_stash.sdf_stash_width(scfg, us)
        cols = core_stash.sdf_stash_columns(scfg, us)
        fwd, bwd = ("sdf_stash_all_fwd", "sdf_stash_all_bwd") if us else ("sdf_stash_fwd", "sdf_stash_bwd")
        d_label, e_label = ("kernel D stash_all", "kernel E1 stash_all") if us else ("kernel D", "kernel E1")
        d16_group = bf16_group(D_ALL_GROUP if us else "kernel D sdf_stash_fwd")
        e16_group = bf16_group(E1_ALL_GROUP if us else "kernel E sdf_stash_bwd (E1)")
        d16 = core_stash.sdf_stash_fwd(aw, x, scfg, stash_us=us)
        for compute, stash_dt in CORE_F32_PAIRS:
            kw = dict(stash_us=us, compute_dtype=compute, stash_dtype=stash_dt)
            out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["sdf_stash_fwd"]
            stash_tol = out_tol if stash_dt == "float32" else TOL["sdf_stash_fwd"]
            grad_tol = CORE_F32_TOL["grad"] if compute == "float32" else TOL["sdf_stash_bwd"]
            d_out = core_stash.sdf_stash_fwd(aw, x, scfg, **kw)
            a_same = a32 if compute == "float32" else a16
            if not all(torch.equal(u, v) for u, v in zip(d_out[:3], a_same)):
                raise AssertionError(f"{phase}: {fwd}{sfx} at {compute}/{stash_dt}: outputs differ from kernel A's")
            plain = core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, compute, stash_dt, return_us=us)
            parts = core_stash.split_stash(d_out[3], cols)
            checks = [("outputs", max_err(d_out[:3], plain[:3]), out_tol),
                      ("stash", max_err(parts, [*plain[3], *plain[4], plain[5]] if us else plain[3]), stash_tol)]
            del plain
            name = core_mlp.instance_name(fwd, compute, stash_dt) + sfx
            record(name, checks, lambda: core_stash.sdf_stash_fwd(aw, x, scfg, **kw),
                   lambda: core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, compute, stash_dt, return_us=us),
                   group(d_label, compute, stash_dt),
                   lambda: core_stash.sdf_stash_fwd(aw, x, scfg, stash_us=us), d16_group,
                   bound(fwd_flops, io_bytes + n_pts * width * size(stash_dt) + size(compute) * n_w, peak(compute)),
                   extra=narrow(core_mlp.instance_name(fwd, compute, stash_dt),
                                lambda: core_stash.sdf_stash_fwd(nw, x, ncfg, **kw),
                                core_f32_group(d_label, compute, stash_dt)))

            e_dws, e_dx = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, **kw)
            e2_dws, e2_dx = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, **kw)
            none, dx_only = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, need_dw=False, **kw)
            bwd_name = core_mlp.instance_name(bwd, compute, stash_dt) + sfx
            if not (torch.equal(e_dx, e2_dx) and all(torch.equal(u, v) for u, v in zip(e_dws, e2_dws))):
                raise AssertionError(f"{phase}: {bwd_name}'s gradients differ between two runs")
            if none is not None or not torch.equal(dx_only, e_dx):
                raise AssertionError(f"{phase}: {bwd_name} without its dW passes gives another dx")
            del e2_dws, e2_dx, dx_only

            def e_plain(parts=parts, compute=compute, us=us):
                if us:
                    return core_stash.sdf_core_bwd_stash_all_plain(aw, x, parts[:L], parts[L : 2 * L], parts[2 * L],
                                                                   cots, scfg, compute)
                return core_stash.sdf_core_bwd_stash_plain(aw, x, parts, cots, scfg, compute)

            p_dws, p_dx = e_plain()
            err = grad_err([e_dx, *e_dws], [p_dx, *p_dws])
            del p_dws, p_dx
            if (compute, stash_dt, us) == ("float32", "float32", False):
                e_f32 = (e_dx, e_dws)
            del e_dws, e_dx
            n_stash = core_stash.sdf_stash_fwd(nw, x, ncfg, **kw)[3] if wide else None
            record(bwd_name, [("gradients", err, grad_tol)],
                   lambda: core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, **kw),
                   e_plain, (group(e_label, compute, stash_dt), DW_GROUP),
                   lambda: core_stash.sdf_stash_bwd(aw, x, d16[3], cots, scfg, stash_us=us), (e16_group, DW_GROUP),
                   bound(bwd_flops[us], io_bytes + n_pts * width * size(stash_dt) + (size(compute) + 4) * n_w,
                         peak(compute)),
                   extra=narrow(core_mlp.instance_name(bwd, compute, stash_dt),
                                lambda: core_stash.sdf_stash_bwd(nw, x, n_stash, ncots, ncfg, **kw),
                                (core_f32_group(e_label, compute, stash_dt), DW_GROUP)))
            del d_out, parts, n_stash
        del d16

    # H, and f32 E against f32 H.
    h_dws, h_dx = core_mlp.sdf_core_bwd(aw, x, cots, scfg, compute_dtype="float32")
    h2_dws, h2_dx = core_mlp.sdf_core_bwd(aw, x, cots, scfg, compute_dtype="float32")
    if not (torch.equal(h_dx, h2_dx) and all(torch.equal(u, v) for u, v in zip(h_dws, h2_dws))):
        raise AssertionError(f"{phase}: sdf_core_bwd_f32{sfx}'s gradients differ between two runs")
    del h2_dws, h2_dx
    hp_dws, hp_dx = core_mlp.sdf_core_bwd_plain(aw, x, cots, scfg, "float32")
    err = grad_err([h_dx, *h_dws], [hp_dx, *hp_dws])
    del hp_dws, hp_dx
    he = grad_err([e_f32[0], *e_f32[1]], [h_dx, *h_dws])[1]
    h16 = core_mlp.sdf_core_bwd(aw, x, cots, scfg)
    e16 = core_stash.sdf_stash_bwd(aw, x, core_stash.sdf_stash_fwd(aw, x, scfg)[3], cots, scfg)
    he16 = grad_err([e16[1], *e16[0]], [h16[1], *h16[0]])[1]
    del h_dws, h_dx, h16, e16, e_f32
    h_groups = tuple(group(k, "float32", None) for k in ("kernel H1", "kernel H2")) + (DW_GROUP,)
    record("sdf_core_bwd_f32" + sfx, [("gradients", err, CORE_F32_TOL["grad"])],
           lambda: core_mlp.sdf_core_bwd(aw, x, cots, scfg, compute_dtype="float32"),
           lambda: core_mlp.sdf_core_bwd_plain(aw, x, cots, scfg, "float32"), h_groups,
           lambda: core_mlp.sdf_core_bwd(aw, x, cots, scfg),
           tuple(bf16_group(g) for g in ("kernel H, forward pass (H1)", "kernel H chain (H2)")) + (DW_GROUP,),
           bound(bwd_flops[False] + 2.0 * n_pts * hidden, io_bytes + 8 * n_w, H100_F32_FLOPS),
           extra=narrow("sdf_core_bwd_f32", lambda: core_mlp.sdf_core_bwd(nw, x, ncots, ncfg, compute_dtype="float32"),
                        tuple(core_f32_group(k, "float32", None) for k in ("kernel H1", "kernel H2")) + (DW_GROUP,)))
    log(f"[{phase}] E's f32 instance (f32 stash) against H's f32 instance: {he:.3e} of each gradient's scale; the bf16 "
        f"instances E against H: {he16:.3e} (E's gates 1 - exp(-100 h) of the stash, H's sigmoid(100 z): equal in "
        f"exact arithmetic, so the f32 pair differs by rounding and the bf16 pair by bf16's)")
    return out


def core_f32_phase(smi: str, dev, mc: dict, wide: bool = False) -> list:
    """Phase 16, the SDF core at compute_dtype="float32" and
    stash_dtype="float32": (a) every f32 instance at phase 3's shapes
    (``core_f32_kernels``); (b) the entry points a user calls, at the same
    65,536 points with the nr-hints weight-norm params:
    ``fused_sdf_value_feat_grad(compute_dtype="float32")`` under each
    backward schedule and ``fused_sdf_value_feat_grad_stash`` at f32 stashes
    (CORE_F32_CALLS), each against torch.autograd over ``sdf_core_plain`` at
    its operand dtype: the outputs, and the gradients of x and of every
    weight-norm leaf at random cotangents; the launch counts, set to 0
    before (b) and read after, show that every f32 instance ran and no bf16
    core instance did.  With ``wide``, phase 21: the same for the wide
    instances at WIDE_CORE_F32 (``core_f32_case``).  -> the kernels line's
    entries of the f32 instances, their launches (b)'s."""
    import numpy as np
    import torch

    from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib
    from nrhints_torch.utils import tree_items

    t_phase = time.perf_counter()
    nums = core_f32_kernels(smi, dev, mc, wide)
    phase = "21" if wide else "16"
    scfg, _, sdf_params, sfx = core_f32_case(dev, mc, wide)
    x = mc["x"]
    n_pts = x.shape[0]
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(sdf_params)}
    params = {}
    for name, t in leaves.items():
        layer, key = name.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    crng = np.random.default_rng(7)
    cots = [torch.tensor(crng.normal(size=s).astype(np.float32), device=dev)
            for s in ((n_pts,), (n_pts, scfg.d_out_feat), (n_pts, 3))]
    refs = {}
    for compute in ("float32", "bfloat16"):
        xr = x.detach().clone().requires_grad_(True)
        o = core_mlp.sdf_core_plain(core_mlp.materialize_sdf_weights_full(params, scfg), xr, scfg, compute)
        refs[compute] = ([t.detach() for t in o], torch.autograd.grad(o, [xr, *leaves.values()], cots))
        del o
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        nograd = core_mlp.fused_sdf_value_feat_grad(params, scfg, x, compute_dtype="float32")
    e = max_err(nograd, refs["float32"][0])
    results = [("fused_sdf_value_feat_grad, no gradient", e[1], 0.0, CORE_F32_TOL["out"], 0.0)]
    for label, kw in CORE_F32_CALLS:
        compute = kw.get("compute_dtype", "float32")
        stash_dt = kw.get("stash_dtype", None if kw.get("backward") == "recompute" else "bfloat16")
        xx = x.detach().clone().requires_grad_(True)
        if "backward" in kw:
            o = core_mlp.fused_sdf_value_feat_grad(params, scfg, xx, compute_dtype="float32", **kw)
        else:
            o = core_stash.fused_sdf_value_feat_grad_stash(params, scfg, xx, **dict(dict(compute_dtype="float32"),
                                                                                     **kw))
        g = torch.autograd.grad(o, [xx, *leaves.values()], cots)
        ref_o, ref_g = refs[compute]
        exact = compute == "float32" and stash_dt in (None, "float32")
        out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["sdf_core_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if exact else TOL["sdf_stash_bwd"]
        results.append((label, max_err(o, ref_o)[1], grad_err(g, ref_g)[1], out_tol, grad_tol))
        del o, g
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    for label, oe, ge, ot, gt_ in results:
        log(f"[{phase}(b) {label}] N={n_pts}: outputs {oe:.3e} of max(1, scale) (tol {ot}), gradients of x and the "
            f"weight-norm leaves {ge:.3e} of each scale (tol {gt_}) against autograd over sdf_core_plain")
        if not (oe <= ot and ge <= gt_):
            raise AssertionError(f"{phase}(b): {label} disagrees with autograd: outputs {oe:.3e}, gradients {ge:.3e}")
    ran = {k: v for k, v in launches.items() if v}
    want = {"sdf_core_fwd_f32": 2, "sdf_core_bwd_f32": 1, "sdf_stash_fwd_f32_bf16stash": 2,
            "sdf_stash_bwd_f32_bf16stash": 1, "sdf_stash_all_fwd_f32_bf16stash": 1,
            "sdf_stash_all_bwd_f32_bf16stash": 1, "sdf_stash_fwd_f32": 1, "sdf_stash_bwd_f32": 1,
            "sdf_stash_all_fwd_f32": 1, "sdf_stash_all_bwd_f32": 1, "sdf_stash_fwd_f32stash": 1,
            "sdf_stash_bwd_f32stash": 1, "sdf_stash_all_fwd_f32stash": 1, "sdf_stash_all_bwd_f32stash": 1}
    want = {k + sfx: v for k, v in want.items()}
    log(f"[{phase}(b)] launches of the entry points' run: {ran}")
    if ran != want:
        raise AssertionError(f"{phase}(b): launches {ran}, expected {want}")
    log(f"[{phase}] phase {phase} took {time.perf_counter() - t_phase:.1f} s")
    where = {"sdf_core_fwd": ("sdf_core.cu", "core_mlp.py:227"), "sdf_core_bwd": ("sdf_core_bwd.cu", "core_mlp.py:260"),
             "sdf_stash_fwd": ("sdf_core.cu", "core_stash.py:369"), "sdf_stash_all_fwd": ("sdf_core.cu",
                                                                                         "core_stash.py:369"),
             "sdf_stash_bwd": ("sdf_stash.cu", "core_stash.py:422"), "sdf_stash_all_bwd": ("sdf_stash.cu",
                                                                                          "core_stash.py:422")}
    entries = []
    for name, num in nums.items():
        base = re.sub(r"_f32.*$", "", name)
        entries.append(entry(name, *where[base], launches[name], *num))
    return entries


# Phase 17: the reflectance trunk's f32 instances (compute_dtype="float32",
# and the f32 stash of stash_dtype="float32"), held as phase 16 holds the
# SDF core's: CORE_F32_TOL at f32 operands (a bf16 stash at the bf16
# instances' TOL), TOL at bf16 operands.  The ReLU backward jumps at z_i = 0,
# so J, whose plain version recomputes the z_i in another summation order,
# is held two ways, as phase 3 holds bf16 J: entry by entry against the
# plain backward at the forward's own z_i (F's, which J1 recomputes bit for
# bit), and against the wholly plain backward by the relative norm of the
# error, TRUNK_F32_NORM_TOL.  A z_i within f32 rounding of 0 takes the other
# side of the ReLU there and moves one point's dx by a unit's share, about
# 2.5e-4 of dx's norm at 65,536 points; tens of such flips fit the bound, a
# wrong mask or layer moves the norm by O(1).  17(b)'s entry points the
# same two ways: against autograd over the plain forward at the kernel's
# own ReLU masks (z_i from F at the call's operand dtype with an f32 stash)
# entry by entry, and against autograd over the wholly plain forward by the
# norm (TOL["mlp_bwd"] where bf16 enters).
TRUNK_F32_NORM_TOL = 1e-2
# 17(b)'s calls: (label, entry point, keywords, operand dtype, stash dtype).
TRUNK_F32_CALLS = (
    ("fused_mlp_apply recompute", "apply", dict(backward="recompute"), "float32", None),
    ("fused_mlp_apply stash", "apply", dict(backward="stash"), "float32", "bfloat16"),
    ("fused_mlp_apply stash_all", "apply", dict(backward="stash_all"), "float32", "bfloat16"),
    ("fused_mlp_apply stash_xla", "apply", dict(backward="stash_xla"), "float32", "bfloat16"),
    ("fused_mlp_apply_stash f32/f32", "stash", dict(stash_dtype="float32"), "float32", "float32"),
    ("fused_mlp_apply_stash f32/bf16", "stash", dict(stash_dtype="bfloat16"), "float32", "bfloat16"),
    ("fused_mlp_apply_stash bf16/f32", "stash", dict(stash_dtype="float32"), "bfloat16", "float32"),
    ("fused_mlp_apply_stash bf16/f32 xla", "stash", dict(stash_dtype="float32", bwd_impl="xla"), "bfloat16",
     "float32"),
    ("fused_reflectance_forward recompute", "reflectance", {}, "float32", None),
)
# 17(b)'s launches: the calls above and one undifferentiated fused_mlp_apply.
TRUNK_F32_LAUNCHES = {"mlp_fwd_f32": 3, "mlp_bwd_f32": 2, "mlp_stash_fwd_f32": 1, "mlp_stash_bwd_f32": 1,
                      "mlp_stash_fwd_f32_bf16stash": 4, "mlp_stash_bwd_f32_bf16stash": 3,
                      "mlp_stash_fwd_f32stash": 2, "mlp_stash_bwd_f32stash": 1}


def trunk_kernel_masks(tw, x, n_lay: int, compute: str) -> list:
    """The ReLU masks [z_i > 0] of the trunk kernels at dot operands of
    ``compute``: the z_i of kernel F with an f32 stash (I and J1 compute
    them bit for bit the same; a bf16 stash keeps their signs)."""
    import torch

    from nrhints_torch.kernels import core_mlp, core_stash

    with torch.no_grad():
        _, zs = core_stash.mlp_stash_fwd(tw, x, n_lay, compute_dtype=compute, stash_dtype="float32")
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(tw, n_lay))
    return [(z > 0).float() for z in core_stash.split_stash(zs, cols)]


def trunk_masked_plain(weights, x, n_lay: int, compute: str, masks):
    """mlp_relu_plain with each ReLU replaced by the given masks: the plain
    forward on the kernel's side of every z_i = 0, so its autograd backward
    is the plain backward at the kernel's own masks."""
    from nrhints_torch.kernels.common import dot

    h = x
    for i in range(n_lay + 1):
        h = dot(h, weights[2 * i], compute) + weights[2 * i + 1]
        if i < n_lay:
            h = h * masks[i]
    return h


def trunk_f32_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 17(a): at phase 3's 65,536 points and the full nr-hints trunk
    (361 -> 4 x 256 -> 3), F's and G's instances at each CORE_F32_PAIRS
    pair and I's and J's f32 instances against their plain versions; I
    equals F's (f32, f32) output, G and J repeat, J equals G at F's f32
    stash, and bf16 operands with an f32 stash give the (bf16, bf16) pair's
    output and gradients, all bit for bit; J against the wholly plain
    backward by the norm (TRUNK_F32_NORM_TOL), with its ReLU flips counted.
    Each timed as phase 16(a)'s instances.  -> {instance name: (max abs err,
    ms, plain ms, bound ms, bound by)}."""
    import numpy as np
    import torch

    from nrhints_torch.kernels import core_mlp, core_stash

    torch.backends.cuda.matmul.allow_tf32 = False
    n_pts = mc["x"].shape[0]
    n_lay = mc["cfg"].model.reflectance_network.n_layers
    tw = core_mlp.materialize_mlp_weights(mc["renderer_params"]["color"], n_lay)
    d_tin, n_tw = tw[0].shape[0], sum(w.numel() for w in tw)
    trng = np.random.default_rng(6)  # phase 3's trunk inputs
    xt = torch.tensor(trng.normal(size=(n_pts, d_tin)).astype(np.float32), device=dev)
    gt = torch.tensor(trng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(tw, n_lay))
    zt = sum(w for _, w in cols)
    macs = sum(w.shape[0] * w.shape[1] for w in tw[0::2])
    io_bytes = n_pts * 4 * (d_tin + 3)  # x in, the output out (g in, dx out: twice in a backward)

    def size(dt):
        return 4 if dt == "float32" else 2

    def peak(compute):
        return H100_F32_FLOPS if compute == "float32" else H100_BF16_FLOPS

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def flat(r):
        return [r[1], *r[0]]

    out: dict = {}
    record = functools.partial(instance_record, "17(a)", out, {}, n_pts, smi)
    chain = (TRUNK_CHAIN_GROUP, DW_GROUP)
    f16_out, f16_zs = core_stash.mlp_stash_fwd(tw, xt, n_lay)
    g16 = core_stash.mlp_stash_bwd(tw, xt, f16_zs, gt, n_lay)
    f32_out = g32 = zs32 = None
    for compute, stash_dt in CORE_F32_PAIRS:
        kw = dict(compute_dtype=compute, stash_dtype=stash_dt)
        out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["mlp_stash_fwd"]
        stash_tol = out_tol if stash_dt == "float32" else TOL["mlp_stash_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if compute == "float32" else TOL["mlp_stash_bwd"]
        f_out, zs = core_stash.mlp_stash_fwd(tw, xt, n_lay, **kw)
        p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, compute, stash_dt)
        checks = [("output", max_err([f_out], [p_out]), out_tol),
                  ("stash", max_err(core_stash.split_stash(zs, cols), p_zs), stash_tol)]
        del p_out, p_zs
        if compute == "bfloat16" and not (torch.equal(f_out, f16_out) and torch.equal(zs.to(torch.bfloat16), f16_zs)):
            raise AssertionError("17(a): F at bf16/f32 differs from F at bf16/bf16 (output, or the stash rounded)")
        record(core_mlp.instance_name("mlp_stash_fwd", compute, stash_dt), checks,
               lambda: core_stash.mlp_stash_fwd(tw, xt, n_lay, **kw),
               lambda: core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, compute, stash_dt),
               core_f32_group("kernel F", compute, stash_dt), lambda: core_stash.mlp_stash_fwd(tw, xt, n_lay),
               "kernel F mlp_stash_fwd",
               bound(2.0 * n_pts * macs, io_bytes + n_pts * zt * size(stash_dt) + size(compute) * n_tw, peak(compute)))

        g = core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw)
        if not same(flat(g), flat(core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw))):
            raise AssertionError(f"17(a): G at {compute}/{stash_dt} differs between two runs")
        if compute == "bfloat16" and not same(flat(g), flat(g16)):
            raise AssertionError("17(a): G at bf16/f32 differs from G at bf16/bf16 at the same forward")

        def g_plain(zs=zs, compute=compute):
            return core_stash.mlp_relu_bwd_stash_plain(tw, xt, core_stash.split_stash(zs, cols), gt, n_lay, compute)

        p_dws, p_dx = g_plain()
        err = grad_err(flat(g), [p_dx, *p_dws])
        del p_dws, p_dx
        record(core_mlp.instance_name("mlp_stash_bwd", compute, stash_dt), [("gradients", err, grad_tol)],
               lambda: core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw), g_plain,
               (core_f32_group("trunk chain", compute, stash_dt), DW_GROUP),
               lambda: core_stash.mlp_stash_bwd(tw, xt, f16_zs, gt, n_lay), chain,
               bound(4.0 * n_pts * macs, 2 * io_bytes + n_pts * zt * size(stash_dt) + (size(compute) + 4) * n_tw,
                     peak(compute)))
        if (compute, stash_dt) == ("float32", "float32"):
            f32_out, g32, zs32 = f_out, g, zs
        del f_out, zs, g

    # I and J, f32: I = F's output; J = G at F's stash; J repeats.
    i_out = core_mlp.mlp_fwd(tw, xt, n_lay, compute_dtype="float32")
    if not torch.equal(i_out, f32_out):
        raise AssertionError("17(a): I's f32 output differs from F's (f32, f32) output")
    record("mlp_fwd_f32", [("output", max_err([i_out], [core_mlp.mlp_relu_plain(tw, xt, n_lay, "float32")]),
                            CORE_F32_TOL["out"])],
           lambda: core_mlp.mlp_fwd(tw, xt, n_lay, compute_dtype="float32"),
           lambda: core_mlp.mlp_relu_plain(tw, xt, n_lay, "float32"), core_f32_group("kernel I", "float32", None),
           lambda: core_mlp.mlp_fwd(tw, xt, n_lay), "kernel I mlp_fwd",
           bound(2.0 * n_pts * macs, io_bytes + 4 * n_tw, H100_F32_FLOPS))
    del i_out
    j = core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype="float32")
    j2 = core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype="float32")
    jl = flat(j)
    if not same(jl, flat(j2)):
        raise AssertionError("17(a): J's f32 gradients differ between two runs")
    if not same(jl, flat(g32)):
        raise AssertionError("17(a): J's f32 gradients differ from G's (f32, f32) at F's f32 stash")
    del j2, g32
    zsplit = core_stash.split_stash(zs32, cols)
    z_dws, z_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, "float32", zs=zsplit)
    err_z = grad_err(jl, [z_dx, *z_dws])
    del z_dws, z_dx
    p_dws, p_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, "float32")
    norm, err_p = grad_norm_err(jl, [p_dx, *p_dws]), grad_err(jl, [p_dx, *p_dws])
    del p_dws, p_dx
    _, p_zs = core_mlp.mlp_relu_plain(tw, xt, n_lay, "float32", return_zs=True)
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(zsplit, p_zs))
    del p_zs, zsplit, jl
    log(f"[17(a) mlp_bwd_f32] N={n_pts}: repeats bit for bit and equals G's (f32, f32) at F's f32 stash; against the "
        f"wholly plain backward: relative norm of the error {norm:.3e} (tol {TRUNK_F32_NORM_TOL}), largest entry "
        f"{err_p[1]:.3e} of its gradient's scale, {flips} of {n_pts * zt} z_i on the other side of 0 in the plain "
        f"forward")
    if not norm <= TRUNK_F32_NORM_TOL:
        raise AssertionError(f"17(a): J's f32 gradients disagree with the plain backward: relative norm {norm:.3e}")
    record("mlp_bwd_f32", [("gradients at F's z_i", err_z, CORE_F32_TOL["grad"])],
           lambda: core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype="float32"),
           lambda: core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, "float32"),
           (core_f32_group("kernel J1", "float32", None), core_f32_group("trunk chain", "float32", None), DW_GROUP),
           lambda: core_mlp.mlp_bwd(tw, xt, gt, n_lay), ("kernel J, recompute pass (J1)",) + chain,
           bound(6.0 * n_pts * macs, 2 * io_bytes + 8 * n_tw, H100_F32_FLOPS))
    del j, f32_out, zs32, f16_out, f16_zs, g16
    torch.cuda.empty_cache()
    return out


def trunk_f32_phase(smi: str, dev, mc: dict) -> list:
    """Phase 17, the reflectance trunk at compute_dtype="float32" and
    stash_dtype="float32": (a) every f32 instance at phase 3's shapes
    (``trunk_f32_kernels``); (b) the entry points a user calls, at 65,536
    points with the nr-hints color params' weight-norm leaves:
    ``fused_mlp_apply(compute_dtype="float32")`` under each backward
    schedule, ``fused_mlp_apply_stash`` at each dtype pair and with
    ``bwd_impl="xla"``, and ``fused_reflectance_forward(compute_dtype=
    "float32")`` on the shadow and specular hints' inputs (TRUNK_F32_CALLS),
    each against torch.autograd over the plain forward at its operand dtype
    the two ways above: the outputs, and the gradients of the trunk's input
    (the reflectance call's seven inputs) and of every weight-norm leaf at
    random cotangents; the launch counts, set to 0 before (b) and read
    after, show that every f32 trunk instance ran (TRUNK_F32_LAUNCHES) and
    no bf16 trunk instance did.  -> the kernels line's entries of the f32
    instances, their launches (b)'s."""
    import numpy as np
    import torch

    from nrhints_torch.core.encodings import nerf_encoding
    from nrhints_torch.fields.reflectance import reflectance_forward
    from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib
    from nrhints_torch.utils import tree_items

    t_phase = time.perf_counter()
    nums = trunk_f32_kernels(smi, dev, mc)
    rcfg = mc["cfg"].model.reflectance_network
    n_lay, n_pts = rcfg.n_layers, mc["x"].shape[0]
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in tree_items(mc["renderer_params"]["color"])}
    params = {}
    for name, t in leaves.items():
        layer, key = name.strip("/").split("/")
        params.setdefault(layer, {})[key] = t
    d_tin = params["lin0"]["v"].shape[0]
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(n_pts, d_tin)).astype(np.float32), device=dev)
    cot = torch.tensor(rng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    # The reflectance call's inputs: points, normals, view dirs, features,
    # point lights, the shadow hint [N, 1] and the specular hint [N, 4].
    d_feat = d_tin - (4 * 3 + 2 * 3 * 2 * rcfg.multi_res + (1 + 2 * rcfg.multi_res) + 4 * (1 + 2 * rcfg.multi_res))
    shapes = ((n_pts, 3), (n_pts, 3), (n_pts, 3), (n_pts, d_feat), (n_pts, 3), (n_pts, 1), (n_pts, 4))
    r_ins = [torch.tensor(rng.normal(size=sh).astype(np.float32), device=dev) for sh in shapes]
    r_ins[5], r_ins[6] = r_ins[5].abs(), r_ins[6].abs()
    pts, nrm, vd, feat, pl_, vis, spec = r_ins
    r_in = torch.cat([pts, nerf_encoding(vd, rcfg.multi_res), nrm, nerf_encoding(pl_, rcfg.multi_res), feat,
                      nerf_encoding(vis, rcfg.multi_res), nerf_encoding(spec, rcfg.multi_res)], dim=-1)
    if r_in.shape[1] != d_tin:
        raise AssertionError(f"17(b): the reflectance input is {r_in.shape[1]} wide, the trunk takes {d_tin}")

    def grads_of(o, ins):
        return torch.autograd.grad(o, [*ins, *leaves.values()], cot)

    # References, before the counts are reset: autograd over the plain
    # forward at the kernel's ReLU masks, and over the wholly plain forward.
    refs = {}
    for compute in ("float32", "bfloat16"):
        masks = trunk_kernel_masks(core_mlp.materialize_mlp_weights(params, n_lay), x, n_lay, compute)
        xr = x.detach().clone().requires_grad_(True)
        om = trunk_masked_plain(core_mlp.materialize_mlp_weights(params, n_lay), xr, n_lay, compute, masks)
        op = core_mlp.mlp_relu_plain(core_mlp.materialize_mlp_weights(params, n_lay), xr, n_lay, compute)
        refs[compute] = (om.detach(), grads_of(om, [xr]), grads_of(op, [xr]))
        del masks, om, op
    rins = [t.detach().clone().requires_grad_(True) for t in r_ins]
    rr = torch.cat([rins[0], nerf_encoding(rins[2], rcfg.multi_res), rins[1], nerf_encoding(rins[4], rcfg.multi_res),
                    rins[3], nerf_encoding(rins[5], rcfg.multi_res), nerf_encoding(rins[6], rcfg.multi_res)], dim=-1)
    masks = trunk_kernel_masks(core_mlp.materialize_mlp_weights(params, n_lay), r_in, n_lay, "float32")
    om = torch.sigmoid(trunk_masked_plain(core_mlp.materialize_mlp_weights(params, n_lay), rr, n_lay, "float32",
                                          masks))
    op = reflectance_forward(params, dataclasses.replace(rcfg, compute_dtype="float32"), *rins)
    refs["reflectance"] = (om.detach(), grads_of(om, rins), grads_of(op, rins))
    del masks, om, op, rr, rins
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        nograd = core_mlp.fused_mlp_apply(params, n_lay, x, compute_dtype="float32")
    results = [("fused_mlp_apply, no gradient", max_err([nograd], [refs["float32"][0]])[1], 0.0, 0.0,
                CORE_F32_TOL["out"], 0.0, 0.0)]
    del nograd
    for label, fn, kw, compute, stash_dt in TRUNK_F32_CALLS:
        if fn == "reflectance":
            ins = [t.detach().clone().requires_grad_(True) for t in r_ins]
            o = core_mlp.fused_reflectance_forward(params, rcfg, *ins, compute_dtype=compute, **kw)
            ref_o, ref_m, ref_p = refs["reflectance"]
        else:
            ins = [x.detach().clone().requires_grad_(True)]
            call = core_mlp.fused_mlp_apply if fn == "apply" else core_stash.fused_mlp_apply_stash
            o = call(params, n_lay, ins[0], compute_dtype=compute, **kw)
            ref_o, ref_m, ref_p = refs[compute]
        g = grads_of(o, ins)
        exact = compute == "float32" and stash_dt in (None, "float32")
        out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["mlp_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if exact else TOL["mlp_stash_bwd"]
        norm_tol = TRUNK_F32_NORM_TOL if exact else TOL["mlp_bwd"]
        results.append((label, max_err([o], [ref_o])[1], grad_err(g, ref_m)[1], grad_norm_err(g, ref_p), out_tol,
                        grad_tol, norm_tol))
        del o, g, ins
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    for label, oe, ge, ne, ot, gt_, nt in results:
        log(f"[17(b) {label}] N={n_pts}: outputs {oe:.3e} of max(1, scale) (tol {ot}); gradients of the inputs and "
            f"the weight-norm leaves against autograd at the kernel's ReLU masks {ge:.3e} of each scale (tol {gt_}), "
            f"against autograd over the wholly plain forward by the relative norm {ne:.3e} (tol {nt})")
        if not (oe <= ot and ge <= gt_ and ne <= nt):
            raise AssertionError(f"17(b): {label} disagrees with autograd: outputs {oe:.3e}, gradients {ge:.3e}, "
                                 f"norm {ne:.3e}")
    ran = {k: v for k, v in launches.items() if v}
    log(f"[17(b)] launches of the entry points' run: {ran}")
    if ran != TRUNK_F32_LAUNCHES:
        raise AssertionError(f"17(b): launches {ran}, expected {TRUNK_F32_LAUNCHES}")
    del refs
    torch.cuda.empty_cache()
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    where = {"mlp_fwd": "core_mlp.py:397", "mlp_bwd": "core_mlp.py:420", "mlp_stash_fwd": "core_stash.py:588",
             "mlp_stash_bwd": "core_stash.py:622"}
    return [entry(name, "mlp_stash.cu", where[re.sub(r"_f32.*$", "", name)], launches[name], *num)
            for name, num in nums.items()]


# Phase 18: the SDF above the presets' widths: the SDF core's wide instances
# (32-point blocks, padded widths up to 512, encodings up to 128, bf16) and
# the march kernels' (the row engine's wide class, bf16 and f32 march
# weights).  The model is nr-hints-cam-opt at sdf_network.d_hidden=512 (8
# layers, a skip at 4, multi_res 6, a 256-wide feature head, so the trunk
# keeps its 361 inputs) on its default routes, kernel C's wide instance on
# the shipping shadow route.  (a) every wide instance of the core at phase
# 3's 65,536 points against its plain version at TOL, with D = A, the
# variant = D where they share outputs, E and H repeating and E without its
# dW passes, bit for bit; a kernel-level case WIDE_FEAT takes the feature
# head's and the encoding's wide paths; and every wide instance of C, K, L,
# M and N at phase 3's 512 rays, bf16 (both merges) at TOL and f32 at
# F32_TOL, L's and M's z by Z_NN_SHARE, with L = B/K, M = L(K), N = C(M) bit
# for bit; each instance's device ms from one profiled call beside the
# 256-wide instance's in the same call.  (b) a K = WIDE_K graph of stash
# steps against its eager steps; a 64-ray step's gradients against the CPU;
# one recompute and one stash_all step; one profiled monolith step (M, N);
# the split route's step (K, L, M, C) and both f32 routes' steps, each with
# exact launches.  (c) a 128x128 view through its graph on the shipping
# route and on the monolith.  (d) python -m nrhints_torch's main for
# WIDE_ENTRY_STEPS steps.  (e) the limits: on these default routes at
# march_dtype="float32" an SDF 528 wide and one with a 144-wide encoding
# (multi_res 21) raise NotImplementedError before any launch, naming the
# march kernels (kernel C of the shadow march): their huge class takes them
# at bf16 march weights (phase 23).
WIDE_SDF = {"d_hidden": 512}
WIDE_FEAT = {"d_out_feat": 512, "multi_res": 12}
WIDE_K, WIDE_ENTRY_STEPS = 16, 10
WIDE_WHERE = {"sdf_core_fwd_wide": ("sdf_core.cu", "core_mlp.py:227"),
              "sdf_stash_fwd_wide": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_all_fwd_wide": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_bwd_wide": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_stash_all_bwd_wide": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_core_bwd_wide": ("sdf_core_bwd.cu", "core_mlp.py:260"),
              **{f"{fn}{t}": ("march.cu" if k == "C" else "march_fused_wide.cu", f"march.py:{line}")
                 for t in ("_wide", "_f32_wide") for k, fn, line in (
                     ("C", "shadow_final", 574), ("K", "march_sweep", 507), ("L", "march_rounds", 522),
                     ("M", "importance_march", 488), ("N", "shadow_march", 595))}}
# The wide train steps of 18(b) by route: renderer settings and the launches
# of one step.
WIDE_CORE_STEP = dict(sdf_stash_fwd_wide=1, sdf_stash_bwd_wide=1, mlp_stash_fwd=1, mlp_stash_bwd=1)
WIDE_STEPS = {
    "monolith": (MONOLITH, dict(importance_march_wide=1, shadow_march_wide=1)),
    "split": (SPLIT, dict(march_sweep_wide=1, march_rounds_wide=1, importance_march_wide=1, shadow_final_wide=1)),
    "f32 monolith": (dict(MONOLITH, march_dtype="float32"), dict(importance_march_f32_wide=1,
                                                                  shadow_march_f32_wide=1)),
    "f32 split": (dict(SPLIT, march_dtype="float32"), dict(march_sweep_f32_wide=1, march_rounds_f32_wide=1,
                                                            importance_march_f32_wide=1, shadow_final_f32_wide=1)),
}


def wide_cfg(cfg, **renderer_kw):
    """``cfg`` with WIDE_SDF's SDF network and ``renderer_kw``'s renderer
    settings."""
    return with_renderer(with_model(cfg, sdf=WIDE_SDF), **renderer_kw)


def wide_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 18(a): at phase 3's 65,536 points, A's, D's, E's and H's wide
    instances and D's and E's stash_all variants' at WIDE_SDF, and the same
    at WIDE_FEAT (a 512-wide feature head, multi_res 12: d0 = 75), against
    their plain versions, with the identities; each timed (CUDA events,
    WIDE_SDF only) and by device time from one profiled call, beside the
    256-wide instance's in this call and its bound.  -> {instance name:
    (max abs err, ms, plain ms, bound ms, bound by)} of the WIDE_SDF
    instances."""
    import numpy as np
    import torch

    from nrhints_torch.fields.sdf import _layer_dims, sdf_init
    from nrhints_torch.kernels import core_mlp, core_stash

    x, aw, ncfg = mc["x"], mc["aw"], mc["cfg"].model.sdf_network
    n_pts = x.shape[0]
    out, base_dev = {}, {}

    def cotangents(d_feat):
        crng = np.random.default_rng(5)
        return tuple(torch.tensor(crng.normal(size=s).astype(np.float32), device=dev)
                     for s in ((n_pts,), (n_pts, d_feat), (n_pts, 3)))

    ncots = cotangents(ncfg.d_out_feat)
    for case, kw in (("d512", WIDE_SDF), ("feat512", WIDE_FEAT)):
        scfg = dataclasses.replace(ncfg, **kw)
        if core_mlp.core_class(scfg) is not core_mlp.WIDE:
            raise AssertionError(f"18(a): {kw} does not take the wide instances")
        w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), scfg, dev), scfg)
        n_w, L = sum(t.numel() for t in w), scfg.n_layers
        io, dims = _layer_dims(scfg)
        hidden, d_last, d_feat = sum(i * o_ for i, o_ in io), dims[-2], scfg.d_out_feat
        cots = cotangents(d_feat)
        io_bytes = n_pts * 4 * (3 + 1 + d_feat + 3)
        fwd_flops = 2.0 * n_pts * (2 * hidden + d_last * (1 + d_feat))
        bwd_flops = {us: 2.0 * n_pts * ((4 if us else 5) * hidden + 2 * d_last * d_feat + 2 * d_last)
                     for us in (False, True)}
        timed = case == "d512"
        label = "" if timed else f" {case}"

        def record(name, checks, fn, plain_fn, group, base_fn, base_group, bd, timed=timed, label=label):
            instance_record("18(a)", out if timed else {}, base_dev, n_pts, smi, name + label, checks, fn, plain_fn,
                            group, base_fn, base_group, bd, base="the 256-wide instance's", iters=10 if timed else 2,
                            tries=1)

        a = core_mlp.sdf_core_fwd(w, x, scfg)
        if not all(torch.equal(u, v) for u, v in zip(a, core_mlp.sdf_core_fwd(w, x, scfg))):
            raise AssertionError(f"18(a) {case}: kernel A's wide instance differs between two runs")
        record("sdf_core_fwd_wide", [("outputs", max_err(a, core_mlp.sdf_core_plain(w, x, scfg, "bfloat16")),
                                      TOL["sdf_core_fwd"])],
               lambda: core_mlp.sdf_core_fwd(w, x, scfg), lambda: core_mlp.sdf_core_plain(w, x, scfg, "bfloat16"),
               WIDE_MODES[("sdf_core_fwd_wide_kernel", "0")], lambda: core_mlp.sdf_core_fwd(aw, x, ncfg),
               "kernel A sdf_core_fwd", bound(fwd_flops, io_bytes + 2 * n_w, H100_BF16_FLOPS))
        d16 = None
        for us in (False, True):
            fn_d, fn_e = ("sdf_stash_all_fwd", "sdf_stash_all_bwd") if us else ("sdf_stash_fwd", "sdf_stash_bwd")
            width = core_stash.sdf_stash_width(scfg, us)
            d = core_stash.sdf_stash_fwd(w, x, scfg, stash_us=us)
            if not all(torch.equal(u, v) for u, v in zip(d[:3], a)):
                raise AssertionError(f"18(a) {case}: {fn_d}_wide's outputs differ from kernel A's")
            if us and not torch.equal(d[3][:, : core_stash.sdf_stash_width(scfg)], d16[3]):
                raise AssertionError(f"18(a) {case}: the stash_all variant's h_i differ from kernel D's")
            plain = core_stash.sdf_core_fwd_hs_plain(w, x, scfg, "bfloat16", "bfloat16", return_us=us)
            parts = core_stash.split_stash(d[3], core_stash.sdf_stash_columns(scfg, us))
            checks = [("outputs", max_err(d[:3], plain[:3]), TOL["sdf_stash_fwd"]),
                      ("stash", max_err(parts, [*plain[3], *plain[4], plain[5]] if us else plain[3]),
                       TOL["sdf_stash_fwd"])]
            del plain
            record(f"{fn_d}_wide", checks, lambda us=us: core_stash.sdf_stash_fwd(w, x, scfg, stash_us=us),
                   lambda us=us: core_stash.sdf_core_fwd_hs_plain(w, x, scfg, "bfloat16", "bfloat16", return_us=us),
                   WIDE_MODES[("sdf_core_fwd_wide_kernel", "3" if us else "1")],
                   lambda us=us: core_stash.sdf_stash_fwd(aw, x, ncfg, stash_us=us),
                   D_ALL_GROUP if us else "kernel D sdf_stash_fwd",
                   bound(fwd_flops, io_bytes + 2 * n_pts * width + 2 * n_w, H100_BF16_FLOPS))

            e_dws, e_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, stash_us=us)
            e2_dws, e2_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, stash_us=us)
            none, dx_only = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, need_dw=False, stash_us=us)
            if not (torch.equal(e_dx, e2_dx) and all(torch.equal(u, v) for u, v in zip(e_dws, e2_dws))):
                raise AssertionError(f"18(a) {case}: {fn_e}_wide's gradients differ between two runs")
            if none is not None or not torch.equal(dx_only, e_dx):
                raise AssertionError(f"18(a) {case}: {fn_e}_wide without its dW passes gives another dx")
            del e2_dws, e2_dx, dx_only

            def e_plain(parts=parts, us=us):
                if us:
                    return core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L],
                                                                   cots, scfg, "bfloat16")
                return core_stash.sdf_core_bwd_stash_plain(w, x, parts, cots, scfg, "bfloat16")

            p_dws, p_dx = e_plain()
            err = grad_err([e_dx, *e_dws], [p_dx, *p_dws])
            del p_dws, p_dx, e_dws, e_dx
            base_stash = core_stash.sdf_stash_fwd(aw, x, ncfg, stash_us=us)[3]
            record(f"{fn_e}_wide", [("gradients", err, TOL["sdf_stash_bwd"])],
                   lambda us=us, st=d[3]: core_stash.sdf_stash_bwd(w, x, st, cots, scfg, stash_us=us), e_plain,
                   (WIDE_MODES[("sdf_bwd_chain_wide_kernel", "false, true" if us else "false, false")], DW_GROUP),
                   lambda us=us, st=base_stash: core_stash.sdf_stash_bwd(aw, x, st, ncots, ncfg, stash_us=us),
                   (E1_ALL_GROUP if us else "kernel E sdf_stash_bwd (E1)", DW_GROUP),
                   bound(bwd_flops[us], io_bytes + 2 * n_pts * width + 6 * n_w, H100_BF16_FLOPS))
            del base_stash
            if us:
                del d16
            else:
                d16 = d

        h_dws, h_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg)
        h2_dws, h2_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg)
        if not (torch.equal(h_dx, h2_dx) and all(torch.equal(u, v) for u, v in zip(h_dws, h2_dws))):
            raise AssertionError(f"18(a) {case}: kernel H's wide instance differs between two runs")
        hp_dws, hp_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, "bfloat16")
        err = grad_err([h_dx, *h_dws], [hp_dx, *hp_dws])
        del h_dws, h_dx, h2_dws, h2_dx, hp_dws, hp_dx, d
        record("sdf_core_bwd_wide", [("gradients", err, TOL["sdf_core_bwd"])],
               lambda: core_mlp.sdf_core_bwd(w, x, cots, scfg),
               lambda: core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, "bfloat16"),
               (WIDE_MODES[("sdf_core_fwd_wide_kernel", "2")], WIDE_MODES[("sdf_bwd_chain_wide_kernel", "true, false")],
                DW_GROUP),
               lambda: core_mlp.sdf_core_bwd(aw, x, ncots, ncfg),
               ("kernel H, forward pass (H1)", "kernel H chain (H2)", DW_GROUP),
               bound(bwd_flops[False] + 2.0 * n_pts * hidden, io_bytes + 6 * n_w, H100_BF16_FLOPS))
        torch.cuda.empty_cache()
    return out


def march_class_kernels(smi: str, dev, mc: dict, sdf_kw=None, phase: str = "18(a)",
                        base: str = "the 256-wide instance's", dtypes=("bfloat16", "float32"),
                        base_kw=None) -> dict:
    """Phase 18(a), the march kernels: C, K, L, M and N's wide instances at
    WIDE_SDF on phase 3's 512 camera and shadow rays (a random 512-wide SDF
    from seed 0), bf16 and f32 march weights, against their plain versions
    (K's sdf0 and C's and N's tau at TOL in bf16 and F32_TOL in f32, L's and
    M's z by Z_NN_SHARE), with L = B's steps between K's sweeps, M = L(K(.))
    and N = C(M(.)) bit for bit under both merges; each timed by CUDA events
    beside its plain version, and by device time from one profiled call
    beside ``base``, the same kernel's on phase 3's SDF in this call, and its
    bound.  Phase 22(a) runs the same at ``sdf_kw`` = DEEP_SDF (the instances
    of that SDF's class), phase 23(a) at HUGE_SDF and HUGE_ENC at bf16 alone
    (``dtypes``), beside the instance of ``base_kw``'s SDF (random weights
    from seed 0; None: phase 3's SDF).  -> {instance name: (max abs err, ms,
    plain ms, bound ms, bound by)}."""
    import torch

    from nrhints_torch.fields.sdf import _layer_dims, sdf_init
    from nrhints_torch.kernels import core_mlp, march

    ncfg = mc["cfg"].model.sdf_network
    sdf_kw = WIDE_SDF if sdf_kw is None else sdf_kw
    wcfg = dataclasses.replace(ncfg, **sdf_kw)
    cls = core_mlp.core_class(wcfg, with_feat=False)
    if sdf_kw is WIDE_SDF and cls is not core_mlp.ROWS_WIDE:
        raise AssertionError(f"18(a): {WIDE_SDF} does not take the march kernels' wide instances")
    sfx, wide = cls.suffix, f" {cls.suffix[1:]}" if cls.suffix else ""
    o, d, z0 = mc["o"], mc["d"], mc["z0"]
    bcfg = ncfg if base_kw is None else dataclasses.replace(ncfg, **base_kw)
    bparams = (mc["renderer_params"]["sdf"] if base_kw is None
               else sdf_init(torch.Generator().manual_seed(0), bcfg, dev))
    bsfx = core_mlp.core_class(bcfg, with_feat=False).suffix
    bwide = f" {bsfx[1:]}" if bsfx else ""
    sl, sdir, sdist, z0s, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "z0s", "inv_s", "anneal"))
    wparams = sdf_init(torch.Generator().manual_seed(0), wcfg, dev)
    io, dims = _layer_dims(wcfg)
    vm = sum(i * o_ for i, o_ in io) + dims[-2]  # multiply-adds of a value sweep a point
    out = {}
    for dt, label, tol_sdf0, tol_tau, peak in (
            ("bfloat16", "", TOL["march_sweep"], TOL["shadow_march"], H100_BF16_FLOPS),
            ("float32", "_f32", F32_TOL["sdf0"], F32_TOL["tau"], H100_F32_FLOPS)):
        if dt not in dtypes:
            continue
        ww = march.march_weights(wparams, wcfg, dt)
        nw = mc["mw"] if dt == "bfloat16" and base_kw is None else march.march_weights(bparams, bcfg, dt)
        sz = march.fused_importance_z(wparams, wcfg, sl, sdir, z0s, mlp_dtype=dt, split=True, sweep_impl="xla",
                                      rounds_impl="xla")
        w_bytes = (2 if dt == "bfloat16" else 4) * vm
        bounds = {
            "C": bound(2.0 * 512 * 128 * 2 * vm, 512 * 4 * (128 + 3 + 3 + 1 + 1) + w_bytes, peak),
            "K": bound(2.0 * 512 * 64 * vm, 512 * 4 * (64 + 3 + 3 + 64) + w_bytes, peak),
            "L": bound(2.0 * 512 * 48 * vm, 512 * 4 * (64 + 64 + 3 + 3 + 128) + w_bytes, peak),
            "M": bound(2.0 * 512 * 112 * vm, 512 * 4 * (64 + 3 + 3 + 128) + w_bytes, peak),
            "N": bound(2.0 * 512 * (112 * vm + 128 * 2 * vm), 512 * 4 * (64 + 3 + 3 + 1 + 1) + w_bytes, peak),
        }
        # Past the parameter tables' depth a bf16 instance is held by the
        # error's norm (norm_err), as in deep_kernels.
        err_fn = norm_err if dt == "bfloat16" and wcfg.n_layers > core_mlp.MAX_LAYERS else max_err
        k_sdf0 = march.march_sweep(z0, o, d, ww, wcfg)
        errs = {"K": err_fn([k_sdf0], [march.march_sweep_plain(z0, o, d, ww, wcfg)]),
                "C": err_fn([march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, ww, wcfg)],
                            [march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, ww, wcfg)])}
        checks = {}
        for merge in ("bitonic", "rank"):
            l_z = march.march_rounds(z0, k_sdf0, o, d, ww, wcfg, merge=merge)
            l_is_bk = torch.equal(l_z, march._rounds(ww, wcfg, o, d, z0, k_sdf0, 4, 16, 64.0, merge,
                                                     march.round_machinery, sweep16(o, d, ww, wcfg)))
            m_z = march.importance_march(z0, o, d, ww, wcfg, merge=merge)
            n_tau = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, ww, wcfg, merge=merge)
            n_is_cm = torch.equal(n_tau, march.shadow_final(march.importance_march(z0s, sl, sdir, ww, wcfg, merge=merge),
                                                            sl, sdir, sdist, inv_s, anneal, ww, wcfg))
            n_err = err_fn([n_tau], [march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, ww, wcfg,
                                                              merge=merge)])
            z_l = z_err(l_z, march.march_rounds_plain(z0, k_sdf0, o, d, ww, wcfg, merge=merge), z0)
            z_m = z_err(m_z, march.importance_march_plain(z0, o, d, ww, wcfg, merge=merge), z0)
            for name, e in (("N", n_err), ("L", (z_l[0], 0.0)), ("M", (z_m[0], 0.0))):
                errs[name] = tuple(max(a, b) for a, b in zip(errs.get(name, (0.0, 0.0)), e))
            checks[merge] = (l_is_bk, torch.equal(m_z, l_z), n_is_cm, z_l, z_m)
        calls = {
            "C": (lambda w, c, z=sz: march.shadow_final(z, sl, sdir, sdist, inv_s, anneal, w, c),
                  lambda: march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, ww, wcfg), "shadow_final"),
            "K": (lambda w, c: march.march_sweep(z0, o, d, w, c),
                  lambda: march.march_sweep_plain(z0, o, d, ww, wcfg), "march_sweep"),
            "L": (lambda w, c: march.march_rounds(z0, k_sdf0, o, d, w, c),
                  lambda: march.march_rounds_plain(z0, k_sdf0, o, d, ww, wcfg), "march_rounds"),
            "M": (lambda w, c: march.importance_march(z0, o, d, w, c),
                  lambda: march.importance_march_plain(z0, o, d, ww, wcfg), "importance_march"),
            "N": (lambda w, c: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, c),
                  lambda: march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, ww, wcfg), "shadow_march"),
        }
        for name, (kern, plain, fn) in calls.items():
            ms, plain_ms = cuda_ms(lambda: kern(ww, wcfg), 5), cuda_ms(plain, 2, warmup=1)
            f32 = " f32" if dt == "float32" else ""
            dev_w = kernel_device_ms(lambda: kern(ww, wcfg), f"kernel {name}{f32}{wide} {fn}{label}{sfx}", tries=1)
            narrow = (lambda: kern(nw, bcfg, mc["sz"])) if name == "C" else (lambda: kern(nw, bcfg))
            dev_n = kernel_device_ms(narrow, f"kernel {name}{f32}{bwide} {fn}{label}{bsfx}", tries=1)
            bd, by = bounds[name]
            inst = f"{fn}{label}{sfx}"
            out[inst] = (errs[name][0], ms, plain_ms, bd, by)
            log(f"[{phase} kernel {name}] {inst}: B=512 at {sdf_kw}, max abs err against its "
                f"plain version {errs[name][0]:.3e} (rel {errs[name][1]:.3e}); {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                f"device time {dev_w:.4f} ms against {base} {dev_n:.4f} ms in this call "
                f"({dev_w / dev_n:.2f}x); bound {bd:.4f} ms ({by}, at {peak / 1e12:.0f} TFLOP/s), {dev_w / bd:.2f}x "
                f"it; on {smi}")
        for merge, (l_is_bk, m_is_lk, n_is_cm, z_l, z_m) in checks.items():
            log(f"[{phase} {dt} {merge}] L's z: {z_l[2]:.4f} of the samples within {Z_TOL} of a plain sample, slot by "
                f"slot {z_l[1]:.4f}; M's {z_m[2]:.4f} and {z_m[1]:.4f} (tol {Z_NN_SHARE}); L = B's steps between K's "
                f"sweeps bit for bit: {l_is_bk}; M = L(K(.)): {m_is_lk}; N = C(M(.)): {n_is_cm}")
            if not (z_l[3] and z_m[3] and z_l[2] >= Z_NN_SHARE and z_m[2] >= Z_NN_SHARE):
                raise AssertionError(f"{phase} {dt} {merge}: L's or M's z disagree with the plain march: "
                                     f"{z_l[2]:.4f}, {z_m[2]:.4f}")
            if not (l_is_bk and m_is_lk and n_is_cm):
                raise AssertionError(f"{phase} {dt} {merge}: an identity fails: L = B/K {l_is_bk}, M = L(K) {m_is_lk}, "
                                     f"N = C(M) {n_is_cm}")
        measure = "of the plain output's norm" if err_fn is norm_err else "of max(1, scale)"
        log(f"[{phase} {dt}] K's sdf0 {errs['K'][1]:.3e}, C's tau {errs['C'][1]:.3e}, N's {errs['N'][1]:.3e} "
            f"{measure} (tol {tol_sdf0}, {tol_tau})")
        if not (errs["K"][1] <= tol_sdf0 and errs["C"][1] <= tol_tau and errs["N"][1] <= tol_tau):
            raise AssertionError(f"{phase} {dt}: a march instance disagrees with its plain version: {errs}")
    torch.cuda.empty_cache()
    return out


def wide_one_step(label: str, smi: str, dev, cfg, td: dict, batch, per_step: dict, profiled: bool = False) -> dict:
    """One eager step of a fresh seed-0 state of ``cfg`` (18(b)): a finite
    loss and exactly ``per_step``'s launches; with ``profiled``, a second
    step under the profiler, its device busy split by group.  -> the first
    step's launches."""
    import torch

    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.train.step import make_train_step

    state, buffers = fresh_state(cfg, td["n_views"], dev)
    step_fn = make_train_step(cfg, td["camera"], buffers, state.optimizer)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    launches_check(label, launches, per_step)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"[{label}] non-finite loss {loss}")
    log(f"[{label}] one eager step (the first of a fresh state), core_backward="
        f"{cfg.model.renderer.core_backward!r}: {secs:.4f} s, loss {loss:.6f}; launches {per_step}; on {smi}")
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        t0 = time.perf_counter()
        state, _ = step_fn(state, batch, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch, torch.Generator(device=dev).manual_seed(2))
            torch.cuda.synchronize()
        groups = device_groups(prof)
        busy = sum(groups.values())
        log(f"[{label}] the second eager step {secs:.4f} s; a profiled third: device busy {busy:.3f} ms, idle share "
            f"{1 - busy / (secs * 1e3):.3f} of the unprofiled second; by group (ms) "
            + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    return launches


def wide_view(label: str, smi: str, mc: dict, vcfg, params: dict, per_chunk: dict, cpu_check: bool = True) -> dict:
    """A 128x128 view of ``vcfg`` through its graph (18(c)): exact launches
    (``per_chunk`` a 512-ray chunk), finite images, one profiled replay's
    device busy split, and (``cpu_check``) 64 pixels against the CPU.  ->
    the first call's launches."""
    import numpy as np
    import torch

    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.eval.evaluator import Evaluator

    camera, pose, pl = mc["camera"], mc["pose"], mc["pl"]
    H, W = camera.H, camera.W
    hh, ww = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    view = PixelBundle(h_indices=hh.float(), w_indices=ww.float(), poses=pose.expand(H, W, 4, 4),
                       pls=pl.expand(H, W, 3))
    ev = Evaluator(vcfg, camera, {}, device="cuda")
    img, secs, launches = view_through_graph(label, ev, params, view, smi)
    n_chunks = -(-H * W // vcfg.model.inference_chunk_size)
    launches_check(label, launches, per_chunk, n_chunks)
    if not all(np.all(np.isfinite(v)) for v in img.values()):
        raise AssertionError(f"{label}: non-finite values in the view")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.render_image(params, view)
        torch.cuda.synchronize()
    groups = device_groups(prof)
    busy = sum(groups.values())
    log(f"[{label}] {H}x{W}: {secs:.4f} s through the graph; one profiled replay: device busy {busy:.1f} ms, idle "
        f"share {1 - busy / (secs * 1e3):.3f} of the unprofiled view; by group (ms) "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    if cpu_check:
        rows = torch.arange(36, 100, 8)
        ph, pw = torch.meshgrid(rows, rows, indexing="ij")
        sub = PixelBundle(h_indices=ph.reshape(1, -1).float(), w_indices=pw.reshape(1, -1).float(),
                          poses=pose.expand(1, 64, 4, 4), pls=pl.expand(1, 64, 3))
        cpu_img = Evaluator(vcfg, camera, {}, device="cpu").render_image(params, sub)
        for k, tol in CPU_TOL.items():
            e = float(np.abs(img[k][ph.numpy(), pw.numpy()].reshape(1, 64, -1) - cpu_img[k]).max())
            log(f"[{label}] CPU plain vs card, 64 pixels, {k}: max abs err {e:.3e} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"{label}: CPU and card renders disagree on {k}: {e:.3e}")
    del ev, img
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def wide_entry(smi: str, tmp: Path, label: str, width_argv: list, per_step: dict) -> None:
    """Phases 18(d) and 19(d): ``python -m nrhints_torch``'s main in this
    process on a procedural scene (8 train, 1 val, no test views: no
    registration), ``config:nr-hints-cam-opt`` with ``width_argv``'s widths
    on its default routes, WIDE_ENTRY_STEPS steps of 512 rays, a log at the
    last, the final mesh at resolution 32 (plain sweeps); the logged loss
    finite and every kernel's launches exactly ``per_step`` a step."""
    import torch

    from nrhints_torch.__main__ import main as nrhints_main
    from nrhints_torch.data.synthetic import make_hints_scene
    from nrhints_torch.kernels import cuda_lib

    scene = make_hints_scene(tmp / f"wide_scene_{label}", 8, 1, 0, 128, 128, seed=0)
    steps = WIDE_ENTRY_STEPS
    argv = ["config:nr-hints-cam-opt", "--config.data.path", str(scene), "--config.base-dir",
            str(tmp / f"wide_runs_{label}"), *width_argv,
            "--config.model.batch-size", "512", "--config.intervals.log-metrics", str(steps),
            "--config.final-mesh-resolution", "32", "--config.parallel.data-axis-size", "1",
            "--config.model.end-iter", str(steps)]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = nrhints_main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_check(f"{label} entry", dict(cuda_lib.launch_counts), per_step, steps)
    lines = [json.loads(line) for line in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]
    train = {r["step"]: r for r in lines if "loss" in r}
    if sorted(train) != [steps] or not math.isfinite(train[steps]["loss"]):
        raise AssertionError(f"{label}: metrics.jsonl's train lines {train}, expected one finite line at {steps}")
    r = train[steps]
    for flag, value in zip(width_argv[::2], width_argv[1::2]):
        got = trainer.config
        for part in flag.removeprefix("--config.").split("."):
            got = getattr(got, part.replace("-", "_"))
        if str(got) != value:
            raise AssertionError(f"{label}: the CLI did not set {flag} to {value} (got {got})")
    log(f"[{label} entry] python -m nrhints_torch's main with {' '.join(width_argv)}: {steps} steps and the final mesh "
        f"in {run_s:.2f} s; loss {r['loss']:.6f} at step {steps}; the Trainer's own log: {r['rays_per_sec']:.1f} "
        f"rays/s, {1.0 / r['steps_per_sec']:.5f} s/step; launches exact; on {smi}")
    del trainer


def wide_limits(label: str, dev, td: dict, batch, cases, what: str) -> None:
    """Phases 18(e) and 19(e): a train step of each of ``cases`` ((label,
    config)) raises NotImplementedError naming ROADMAP item 15 and ``what``
    before any launch."""
    import torch

    from nrhints_torch.kernels import cuda_lib
    from nrhints_torch.train.step import make_train_step

    for case, cfg in cases:
        state, buffers = fresh_state(cfg, td["n_views"], dev)
        step_fn = make_train_step(cfg, td["camera"], buffers, state.optimizer)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        try:
            step_fn(state, batch, torch.Generator(device=dev).manual_seed(0))
        except NotImplementedError as e:
            msg = str(e)
        else:
            raise AssertionError(f"{label}: a step at {case} ran")
        torch.cuda.synchronize()
        if "item 15" not in msg or what not in msg or any(cuda_lib.launch_counts.values()):
            raise AssertionError(f"{label}: {case}: {msg!r}, launches {dict(cuda_lib.launch_counts)}")
        log(f"[{label} limits] a step at {case} raises NotImplementedError before any launch: {msg}")


def wide_sdf_phase(smi: str, dev, mc: dict, tmp: Path) -> list:
    """Phase 18, the SDF above the presets' widths (see above).  -> the
    kernels line's entries of the WIDE_SDF instances, each with its
    launches from the path that runs it: A's and C's from (c)'s shipping
    view, M's and N's from its monolith view, D's and E's from (b)'s K =
    WIDE_K dispatch, H's from the recompute step, the variants' from the
    stash_all step, K's and L's from the split step, the f32 instances'
    from the f32 steps."""
    import numpy as np
    import torch

    from nrhints_torch.render.renderer import init_model_params

    t_phase = time.perf_counter()
    nums = wide_kernels(smi, dev, mc)
    nums.update(march_class_kernels(smi, dev, mc))
    t_a = time.perf_counter() - t_phase

    # (b) The train path.
    td = train_data(dev, 128, 128)
    wcfg = wide_cfg(td["cfg"])
    batches = [td["next_batch"]() for _ in range(WIDE_K + TRAIN_WARMUP)]
    b64 = td["next_batch"](64)
    ship = dict(round_machinery=8, shadow_final_wide=1)
    sc = scan_phase(smi, dev, td, batches, "18(b) wide graph", wcfg, WIDE_K, dict(WIDE_CORE_STEP, **ship))
    state, buffers = fresh_state(wcfg, td["n_views"], dev)
    from nrhints_torch.train.step import make_train_step

    step_fn = make_train_step(wcfg, td["camera"], buffers, state.optimizer)
    state, _ = step_fn(state, batches[0], torch.Generator(device=dev).manual_seed(0))
    urng = np.random.default_rng(7)
    u64 = {"strat": urng.random((64, 1), dtype=np.float32),
           "shadow": urng.random((64, wcfg.model.renderer.n_shadow_samples), dtype=np.float32)}
    card_cpu_grads("18(b) wide train path", wcfg, state, td["camera"], buffers, b64, u64)
    del state, step_fn, buffers
    rec_step = dict(sdf_core_fwd_wide=1, sdf_core_bwd_wide=1, mlp_fwd=1, mlp_bwd=1, **ship)
    rec = wide_one_step("18(b) wide recompute step", smi, dev, with_renderer(wcfg, core_backward="recompute"), td,
                        batches[1], rec_step)
    all_step = dict(sdf_stash_all_fwd_wide=1, sdf_stash_all_bwd_wide=1, mlp_stash_fwd=1, mlp_stash_bwd=1, **ship)
    sa = wide_one_step("18(b) wide stash_all step", smi, dev, with_renderer(wcfg, core_backward="stash_all"), td,
                       batches[2], all_step)
    routes = {name: wide_one_step(f"18(b) wide {name} step", smi, dev, with_renderer(wcfg, **kw), td, batches[3],
                                  dict(WIDE_CORE_STEP, **per), profiled=name == "monolith")
              for name, (kw, per) in WIDE_STEPS.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The eval path: a 128x128 view of nr-hints at d_hidden 512 on the
    # shipping route and on the round-4 monolith.
    vcfg = wide_cfg(mc["cfg"])
    params = {"renderer": init_model_params(vcfg.model, torch.Generator().manual_seed(0), device=dev), "raygen": {}}
    ship_view = wide_view("18(c) wide view", smi, mc, vcfg, params,
                          dict(sdf_core_fwd_wide=1, round_machinery=8, shadow_final_wide=1))
    mono_view = wide_view("18(c) wide monolith view", smi, mc, wide_cfg(mc["cfg"], **MONOLITH), params,
                          dict(sdf_core_fwd_wide=1, importance_march_wide=1, shadow_march_wide=1))
    del params

    # (d) The entry point; (e) the limits.
    wide_entry(smi, tmp, "18(d)", ["--config.model.sdf-network.d-hidden", str(WIDE_SDF["d_hidden"])],
               dict(WIDE_CORE_STEP, round_machinery=8, shadow_final_wide=1))
    wide_limits("18(e)", dev, td, batches[0], (
        ("d_hidden 528 at march_dtype float32",
         with_renderer(with_model(td["cfg"], sdf={"d_hidden": 528}), march_dtype="float32")),
        ("multi_res 21 (encoding 129, padded 144) at march_dtype float32",
         with_renderer(with_model(td["cfg"], sdf={"multi_res": 21}), march_dtype="float32"))), "march kernels")
    log(f"[18] phase 18 took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    got = dict(sdf_core_fwd_wide=ship_view["sdf_core_fwd_wide"],
               sdf_stash_fwd_wide=sc["launches"]["sdf_stash_fwd_wide"],
               sdf_stash_bwd_wide=sc["launches"]["sdf_stash_bwd_wide"],
               sdf_core_bwd_wide=rec["sdf_core_bwd_wide"],
               sdf_stash_all_fwd_wide=sa["sdf_stash_all_fwd_wide"],
               sdf_stash_all_bwd_wide=sa["sdf_stash_all_bwd_wide"],
               shadow_final_wide=ship_view["shadow_final_wide"],
               importance_march_wide=mono_view["importance_march_wide"],
               shadow_march_wide=mono_view["shadow_march_wide"],
               march_sweep_wide=routes["split"]["march_sweep_wide"],
               march_rounds_wide=routes["split"]["march_rounds_wide"],
               **{k: routes["f32 split"][k] for k in ("shadow_final_f32_wide", "march_sweep_f32_wide",
                                                      "march_rounds_f32_wide", "importance_march_f32_wide")},
               shadow_march_f32_wide=routes["f32 monolith"]["shadow_march_f32_wide"])
    return [entry(name, *WIDE_WHERE[name], got[name], *num) for name, num in nums.items()]


# Phase 19: the reflectance trunk above the presets' widths: F's, G's, I's
# and J's wide instances (32-point blocks, padded hidden widths up to 512 and
# inputs up to 640, bf16 and f32).  The model is nr-hints-cam-opt at
# WIDE_MODEL (sdf_network d_hidden 512 and d_out_feat 512, the reflectance
# network 512 wide), so the trunk is 617 -> 4 x 512 -> 3 and every fused
# kernel of a step runs a wide instance.  (a) every wide trunk instance at
# phase 3's 65,536 points against its plain version, as phase 17 holds the
# 256-wide ones (bf16 at TOL, f32 at CORE_F32_TOL, a bf16 stash at TOL; J
# entry by entry at F's z_i and by the norm against the wholly plain
# backward), with I = F, J = G at F's stash, G and J repeating, and bf16
# operands with an f32 stash giving the bf16 pair's output and gradients,
# bit for bit; each by device ms from one profiled call beside the 256-wide
# instance's (phase 3's trunk, the same dtypes) in the same call and its
# bound; then the f32 instances through the entry points a user calls, their
# launches exact.  (b) a K = WIDE_K graph of stash steps against its eager
# steps; a 64-ray step's gradients against the CPU; one recompute and one
# stash_all step, launches exact.  (c) a 128x128 view of nr-hints at
# WIDE_MODEL with eval_reflectance_impl="pallas" through its graph, against
# its eager sweep and 64 pixels on the CPU.  (d) python -m nrhints_torch's
# main for WIDE_ENTRY_STEPS steps.  (e) a trunk 528 wide, and one whose
# padded input exceeds 640 (reflectance multi_res 6: 661 inputs), raise
# NotImplementedError naming item 15 before any launch.
WIDE_MODEL_SDF = {"d_hidden": 512, "d_out_feat": 512}
WIDE_MODEL_REFL = {"d_hidden": 512}
WIDE_TRUNK_STEP = dict(sdf_stash_fwd_wide=1, sdf_stash_bwd_wide=1, mlp_stash_fwd_wide=1, mlp_stash_bwd_wide=1,
                       round_machinery=8, shadow_final_wide=1)
# 19(a)'s entry-point run of the f32 wide instances: (label, entry point,
# keywords, operand dtype, stash dtype) and the launches it makes.
WIDE_TRUNK_CALLS = (
    ("fused_mlp_apply recompute f32", "apply", dict(backward="recompute"), "float32", None),
    ("fused_mlp_apply_stash f32/f32", "stash", dict(stash_dtype="float32"), "float32", "float32"),
    ("fused_mlp_apply_stash f32/bf16", "stash", dict(stash_dtype="bfloat16"), "float32", "bfloat16"),
    ("fused_mlp_apply_stash bf16/f32", "stash", dict(stash_dtype="float32"), "bfloat16", "float32"),
)
WIDE_TRUNK_CALL_LAUNCHES = {"mlp_fwd_f32_wide": 1, "mlp_bwd_f32_wide": 1, "mlp_stash_fwd_f32_wide": 1,
                            "mlp_stash_bwd_f32_wide": 1, "mlp_stash_fwd_f32_bf16stash_wide": 1,
                            "mlp_stash_bwd_f32_bf16stash_wide": 1, "mlp_stash_fwd_f32stash_wide": 1,
                            "mlp_stash_bwd_f32stash_wide": 1}


def wide_group(label: str, compute: str, stash: str | None) -> str:
    """The device-time group of a wide trunk instance (phase 19) or of a
    wide f32 or mixed SDF core instance (phase 21)."""
    return f"{label} wide {compute}/{stash or compute}"


def wide_model_cfg(cfg, refl=None, **renderer_kw):
    """``cfg`` at WIDE_MODEL's SDF and reflectance widths (the reflectance
    network's fields ``refl`` on top), with ``renderer_kw``'s renderer
    settings."""
    rn = dataclasses.replace(cfg.model.reflectance_network, **{**WIDE_MODEL_REFL, **(refl or {})})
    return with_renderer(with_model(cfg, sdf=WIDE_MODEL_SDF, reflectance_network=rn), **renderer_kw)


def wide_trunk_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 19(a): at phase 3's 65,536 points, the wide trunk of
    WIDE_MODEL's color params (617 -> 4 x 512 -> 3, seed 0): F's and G's
    wide instances at (bf16, bf16) and each CORE_F32_PAIRS pair, I's and J's
    at bf16 and f32, against their plain versions with the identities, each
    timed (CUDA events) and by device ms beside the 256-wide instance's at
    the same dtypes on phase 3's trunk, and its bound; then the f32
    instances through the entry points (WIDE_TRUNK_CALLS), their launches
    exact.  -> ({instance name: (max abs err, ms, plain ms, bound ms, bound
    by)}, the entry points' launches)."""
    import numpy as np
    import torch

    from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib
    from nrhints_torch.render.renderer import init_model_params

    torch.backends.cuda.matmul.allow_tf32 = False
    n_pts = mc["x"].shape[0]
    wcfg = wide_model_cfg(mc["cfg"])
    n_lay = wcfg.model.reflectance_network.n_layers
    color = init_model_params(wcfg.model, torch.Generator().manual_seed(0), device=dev)["color"]
    tw = core_mlp.materialize_mlp_weights(color, n_lay)
    d_tin, n_tw = tw[0].shape[0], sum(w.numel() for w in tw)
    pk = core_mlp.pack_mlp(tw, n_lay)
    if d_tin != 617 or pk["cls"] is not core_mlp.TRUNK_WIDE:
        raise AssertionError(f"19(a): the wide model's trunk takes {d_tin} inputs, class {pk['cls']}")
    # The 256-wide trunk of phase 3 on its own inputs (phase 3's seed).
    nw = core_mlp.materialize_mlp_weights(mc["renderer_params"]["color"], n_lay)
    nrng = np.random.default_rng(6)
    nx = torch.tensor(nrng.normal(size=(n_pts, nw[0].shape[0])).astype(np.float32), device=dev)
    ng = torch.tensor(nrng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    trng = np.random.default_rng(9)
    xt = torch.tensor(trng.normal(size=(n_pts, d_tin)).astype(np.float32), device=dev)
    gt = torch.tensor(trng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    cols = core_stash.mlp_stash_columns(pk)
    zt = sum(w for _, w in cols)
    macs = sum(w.shape[0] * w.shape[1] for w in tw[0::2])
    io_bytes = n_pts * 4 * (d_tin + 3)

    def size(dt):
        return 4 if dt == "float32" else 2

    def peak(compute):
        return H100_F32_FLOPS if compute == "float32" else H100_BF16_FLOPS

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def flat(r):
        return [r[1], *r[0]]

    def narrow_group(label, bf16_group, compute, stash):
        return bf16_group if compute == (stash or compute) == "bfloat16" else core_f32_group(label, compute, stash)

    out: dict = {}
    record = functools.partial(instance_record, "19(a)", out, {}, n_pts, smi, base="the 256-wide instance's",
                               tries=1)
    fwd, g16, f_zs = {}, None, {}
    for compute, stash_dt in (("bfloat16", "bfloat16"), *CORE_F32_PAIRS):
        kw = dict(compute_dtype=compute, stash_dtype=stash_dt)
        out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["mlp_stash_fwd"]
        stash_tol = out_tol if stash_dt == "float32" else TOL["mlp_stash_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if compute == "float32" else TOL["mlp_stash_bwd"]
        f_out, zs = core_stash.mlp_stash_fwd(tw, xt, n_lay, **kw)
        p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, compute, stash_dt)
        checks = [("output", max_err([f_out], [p_out]), out_tol),
                  ("stash", max_err(core_stash.split_stash(zs, cols), p_zs), stash_tol)]
        del p_out, p_zs
        if (compute, stash_dt) == ("bfloat16", "float32") and not (
                torch.equal(f_out, fwd["bfloat16"]) and torch.equal(zs.to(torch.bfloat16), f_zs["bfloat16"])):
            raise AssertionError("19(a): wide F at bf16/f32 differs from wide F at bf16/bf16")
        name = core_mlp.instance_name("mlp_stash_fwd", compute, stash_dt)
        record(name + "_wide", checks, lambda kw=kw: core_stash.mlp_stash_fwd(tw, xt, n_lay, **kw),
               lambda c=compute, s_=stash_dt: core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, c, s_),
               wide_group("kernel F", compute, stash_dt), lambda kw=kw: core_stash.mlp_stash_fwd(nw, nx, n_lay, **kw),
               narrow_group("kernel F", "kernel F mlp_stash_fwd", compute, stash_dt),
               bound(2.0 * n_pts * macs, io_bytes + n_pts * zt * size(stash_dt) + size(compute) * n_tw, peak(compute)))

        g = core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw)
        if not same(flat(g), flat(core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw))):
            raise AssertionError(f"19(a): wide G at {compute}/{stash_dt} differs between two runs")
        if (compute, stash_dt) == ("bfloat16", "float32") and not same(flat(g), flat(g16)):
            raise AssertionError("19(a): wide G at bf16/f32 differs from wide G at bf16/bf16 at the same forward")

        def g_plain(zs=zs, compute=compute):
            return core_stash.mlp_relu_bwd_stash_plain(tw, xt, core_stash.split_stash(zs, cols), gt, n_lay, compute)

        p_dws, p_dx = g_plain()
        err = grad_err(flat(g), [p_dx, *p_dws])
        del p_dws, p_dx
        n_zs = core_stash.mlp_stash_fwd(nw, nx, n_lay, **kw)[1]
        record(core_mlp.instance_name("mlp_stash_bwd", compute, stash_dt) + "_wide", [("gradients", err, grad_tol)],
               lambda zs=zs, kw=kw: core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay, **kw), g_plain,
               (wide_group("trunk chain", compute, stash_dt), DW_GROUP),
               lambda nz=n_zs, kw=kw: core_stash.mlp_stash_bwd(nw, nx, nz, ng, n_lay, **kw),
               (narrow_group("trunk chain", TRUNK_CHAIN_GROUP, compute, stash_dt), DW_GROUP),
               bound(4.0 * n_pts * macs, 2 * io_bytes + n_pts * zt * size(stash_dt) + (size(compute) + 4) * n_tw,
                     peak(compute)))
        del n_zs
        if stash_dt == compute:
            fwd[compute], f_zs[compute] = f_out, zs
            if compute == "bfloat16":
                g16 = g
            else:
                fwd["g32"] = g
        del f_out, zs, g

    # I and J at each operand dtype: I = F's output, J = G at F's stash, J
    # repeats; J at F's z_i entry by entry and against the wholly plain
    # backward by the norm.
    for compute in ("bfloat16", "float32"):
        out_tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["mlp_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if compute == "float32" else TOL["mlp_bwd"]
        norm_tol = TRUNK_F32_NORM_TOL if compute == "float32" else TOL["mlp_bwd"]
        sfx = "_f32" if compute == "float32" else ""
        i_out = core_mlp.mlp_fwd(tw, xt, n_lay, compute_dtype=compute)
        if not torch.equal(i_out, fwd[compute]):
            raise AssertionError(f"19(a): wide I's output differs from wide F's at {compute}")
        record(f"mlp_fwd{sfx}_wide", [("output", max_err([i_out], [core_mlp.mlp_relu_plain(tw, xt, n_lay, compute)]),
                                       out_tol)],
               lambda c=compute: core_mlp.mlp_fwd(tw, xt, n_lay, compute_dtype=c),
               lambda c=compute: core_mlp.mlp_relu_plain(tw, xt, n_lay, c), wide_group("kernel I", compute, None),
               lambda c=compute: core_mlp.mlp_fwd(nw, nx, n_lay, compute_dtype=c),
               narrow_group("kernel I", "kernel I mlp_fwd", compute, None),
               bound(2.0 * n_pts * macs, io_bytes + size(compute) * n_tw, peak(compute)))
        del i_out
        j = core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype=compute)
        jl = flat(j)
        if not same(jl, flat(core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype=compute))):
            raise AssertionError(f"19(a): wide J's gradients at {compute} differ between two runs")
        if not same(jl, flat(g16 if compute == "bfloat16" else fwd["g32"])):
            raise AssertionError(f"19(a): wide J's gradients at {compute} differ from wide G's at F's stash")
        zsplit = [z.float() for z in core_stash.split_stash(f_zs[compute], cols)]
        z_dws, z_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, compute, zs=zsplit)
        err_z = grad_err(jl, [z_dx, *z_dws])
        del z_dws, z_dx
        p_dws, p_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, compute)
        norm, err_p = grad_norm_err(jl, [p_dx, *p_dws]), grad_err(jl, [p_dx, *p_dws])
        del p_dws, p_dx
        _, p_zs = core_mlp.mlp_relu_plain(tw, xt, n_lay, compute, return_zs=True)
        flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(zsplit, p_zs))
        del p_zs, zsplit, jl, j
        log(f"[19(a) mlp_bwd{sfx}_wide] N={n_pts}: repeats bit for bit and equals wide G's at F's stash; against the "
            f"wholly plain backward: relative norm of the error {norm:.3e} (tol {norm_tol}), largest entry "
            f"{err_p[1]:.3e} of its gradient's scale, {flips} of {n_pts * zt} z_i on the other side of 0 in the plain "
            f"forward")
        if not norm <= norm_tol:
            raise AssertionError(f"19(a): wide J's gradients at {compute} disagree with the plain backward: relative "
                                 f"norm {norm:.3e}")
        record(f"mlp_bwd{sfx}_wide", [("gradients at F's z_i", err_z, grad_tol)],
               lambda c=compute: core_mlp.mlp_bwd(tw, xt, gt, n_lay, compute_dtype=c),
               lambda c=compute: core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, c),
               (wide_group("kernel J1", compute, None), wide_group("trunk chain", compute, None), DW_GROUP),
               lambda c=compute: core_mlp.mlp_bwd(nw, nx, ng, n_lay, compute_dtype=c),
               (narrow_group("kernel J1", "kernel J, recompute pass (J1)", compute, None),
                narrow_group("trunk chain", TRUNK_CHAIN_GROUP, compute, None), DW_GROUP),
               bound(6.0 * n_pts * macs, 2 * io_bytes + (size(compute) + 4) * n_tw, peak(compute)))
    del fwd, f_zs, g16

    # The f32 wide instances through the entry points a user calls, with
    # the weight-norm params (no render path passes compute_dtype).
    params = {name: {k: t.detach().clone().requires_grad_(True) for k, t in layer.items()}
              for name, layer in color.items()}
    leaves = [t for layer in params.values() for t in layer.values()]
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    for label, fn, kw, compute, stash_dt in WIDE_TRUNK_CALLS:
        xr = xt.detach().clone().requires_grad_(True)
        call = core_mlp.fused_mlp_apply if fn == "apply" else core_stash.fused_mlp_apply_stash
        o = call(params, n_lay, xr, compute_dtype=compute, **kw)
        grads = torch.autograd.grad(o, [xr, *leaves], gt)
        e = max_err([o], [core_mlp.mlp_relu_plain(tw, xt, n_lay, compute)])[1]
        tol = CORE_F32_TOL["out"] if compute == "float32" else TOL["mlp_fwd"]
        if not (e <= tol and all(bool(torch.isfinite(t).all()) for t in grads)):
            raise AssertionError(f"19(a): {label}: output {e:.3e} of scale (tol {tol}), or non-finite gradients")
        log(f"[19(a) {label}] N={n_pts}: output within {e:.3e} of the plain forward's scale (tol {tol}); "
            f"{len(grads)} finite gradients")
        del o, grads, xr
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    if launches != WIDE_TRUNK_CALL_LAUNCHES:
        raise AssertionError(f"19(a): the entry points launched {launches}, expected {WIDE_TRUNK_CALL_LAUNCHES}")
    log(f"[19(a)] launches of the entry points' run: {launches}")
    del params, leaves, color
    torch.cuda.empty_cache()
    return out, launches


def wide_trunk_phase(smi: str, dev, mc: dict, tmp: Path) -> list:
    """Phase 19, the reflectance trunk above the presets' widths (see
    above).  -> the kernels line's entries of the wide trunk instances,
    each with its launches from the path that runs it: F's and G's bf16
    from (b)'s K = WIDE_K dispatch, I's from (c)'s view, J's from the
    recompute step, the f32 instances' from (a)'s entry-point run."""
    import numpy as np
    import torch

    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    nums, call_launches = wide_trunk_kernels(smi, dev, mc)
    t_a = time.perf_counter() - t_phase

    # (b) The train path.
    td = train_data(dev, 128, 128)
    wcfg = wide_model_cfg(td["cfg"])
    batches = [td["next_batch"]() for _ in range(WIDE_K + TRAIN_WARMUP)]
    b64 = td["next_batch"](64)
    sc = scan_phase(smi, dev, td, batches, "19(b) wide-trunk graph", wcfg, WIDE_K, WIDE_TRUNK_STEP)
    state, buffers = fresh_state(wcfg, td["n_views"], dev)
    step_fn = make_train_step(wcfg, td["camera"], buffers, state.optimizer)
    state, _ = step_fn(state, batches[0], torch.Generator(device=dev).manual_seed(0))
    urng = np.random.default_rng(7)
    u64 = {"strat": urng.random((64, 1), dtype=np.float32),
           "shadow": urng.random((64, wcfg.model.renderer.n_shadow_samples), dtype=np.float32)}
    card_cpu_grads("19(b) wide-trunk train path", wcfg, state, td["camera"], buffers, b64, u64)
    del state, step_fn, buffers
    ship = dict(round_machinery=8, shadow_final_wide=1)
    rec = wide_one_step("19(b) wide-trunk recompute step", smi, dev, with_renderer(wcfg, core_backward="recompute"),
                        td, batches[1], dict(sdf_core_fwd_wide=1, sdf_core_bwd_wide=1, mlp_fwd_wide=1, mlp_bwd_wide=1,
                                             **ship), profiled=True)
    wide_one_step("19(b) wide-trunk stash_all step", smi, dev, with_renderer(wcfg, core_backward="stash_all"), td,
                  batches[2], dict(sdf_stash_all_fwd_wide=1, sdf_stash_all_bwd_wide=1, mlp_stash_fwd_wide=1,
                                   mlp_stash_bwd_wide=1, **ship))
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The eval path with the fused trunk (kernel I's wide instance).
    vcfg = wide_model_cfg(mc["cfg"], eval_reflectance_impl="pallas")
    params = {"renderer": init_model_params(vcfg.model, torch.Generator().manual_seed(0), device=dev), "raygen": {}}
    view = wide_view("19(c) wide-trunk view", smi, mc, vcfg, params,
                     dict(sdf_core_fwd_wide=1, round_machinery=8, shadow_final_wide=1, mlp_fwd_wide=1))
    del params

    # (d) The entry point; (e) the limits.
    wide_entry(smi, tmp, "19(d)", [
        "--config.model.sdf-network.d-hidden", str(WIDE_MODEL_SDF["d_hidden"]),
        "--config.model.sdf-network.d-out-feat", str(WIDE_MODEL_SDF["d_out_feat"]),
        "--config.model.reflectance-network.d-hidden", str(WIDE_MODEL_REFL["d_hidden"])], WIDE_TRUNK_STEP)
    wide_limits("19(e)", dev, td, batches[0], (
        ("reflectance d_hidden 528", wide_model_cfg(td["cfg"], refl={"d_hidden": 528})),
        ("reflectance multi_res 6 (661 inputs, padded 672)", wide_model_cfg(td["cfg"], refl={"multi_res": 6}))),
        "trunk kernels")
    log(f"[19] phase 19 took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    got = dict(call_launches, mlp_stash_fwd_wide=sc["launches"]["mlp_stash_fwd_wide"],
               mlp_stash_bwd_wide=sc["launches"]["mlp_stash_bwd_wide"], mlp_fwd_wide=view["mlp_fwd_wide"],
               mlp_bwd_wide=rec["mlp_bwd_wide"])
    where = {"mlp_fwd": "core_mlp.py:397", "mlp_bwd": "core_mlp.py:420", "mlp_stash_fwd": "core_stash.py:588",
             "mlp_stash_bwd": "core_stash.py:622"}
    return [entry(name, "mlp_stash.cu", where[re.sub(r"(_f32.*)?_wide$", "", name)], got[name], *num)
            for name, num in nums.items()]


# Phase 20: the fused marches at geometries other than 64 + 4 x 16, the
# run-time geometry instances of B, K, L, M and N (kernel C refines none and
# runs behind them).  At phase 3's 512 camera and shadow rays, stratified
# anew at each geometry's n0, on each class of the march kernels: bf16 and
# f32 march weights at phase 3's 256-wide SDF, and at WIDE_SDF (a random
# 512-wide SDF from seed 0).  (a) at every geometry of GEOMETRIES and under
# both merges (5 x 12: bitonic alone, as JAX asks a power-of-two n_new of
# the rank merge): K's sdf0, B's steps, L's and M's z and N's tau against
# their plain versions (as phase 3 and 18(a) hold them), L = B's steps
# between K's sweeps, M = L(K(.)) and N = C(M(.)) bit for bit; each kernel
# by device time from one profiled call beside the 64 + 4 x 16 instance's
# in this call and the geometry's bound.  (b) fused_importance_z and
# fused_shadow_tau on every route at every geometry and merge, each against
# the plain march, the monolith against the split kernels bit for bit, and
# the launches of every instance exact.  (c) geometries out of the range
# raise before any launch.
GEOMETRIES = ((2, 32), (8, 8), (3, 16), (5, 12), (1, 64), (1, 126))  # (rounds, n_new)
GEOM_JSON_AT = (5, 12)  # the kernels line's geometry: every kernel there runs its run-time instance
# (label, march dtype, the wide SDF)
GEOM_CLASSES = (("bf16", "bfloat16", False), ("f32", "float32", False), ("wide bf16", "bfloat16", True),
                ("wide f32", "float32", True))
GEOM_Z_ROUTES = {
    "monolith": {}, "split": dict(split=True), "xla sweep": dict(split=True, sweep_impl="xla"),
    "xla rounds": dict(split=True, rounds_impl="xla"),
    "shipping": dict(split=True, sweep_impl="xla", rounds_impl="xla"),
}
GEOM_TAU_ROUTES = {"monolith": {}, **{f"split {s}/{r}/{f}": dict(split=True, sweep_impl=s, rounds_impl=r, final_impl=f)
                                      for s in ("pallas", "xla") for r in ("pallas", "xla") for f in ("pallas", "xla")}}
# (rounds, n_new, merge) out of the range: n_new = 1, n0 = 1, no round, and
# a rank merge of 12 (the entry points raise ValueError for it, as JAX).
GEOM_OUT_OF_RANGE = ((10, 1, "bitonic"), (1, 127, "bitonic"), (0, 16, "bitonic"), (5, 12, "rank"))


def geometry_instance(fn: str, suffix: str, rounds: int, n_new: int) -> str:
    """The launch counter of march kernel ``fn`` (with its dtype and class
    ``suffix``) at a geometry: the compile-time instance at 64 + 4 x 16
    (K: n0 = 64; B, round_machinery: n_new = 16), else ``*_geom``."""
    from nrhints_torch.kernels import march

    if fn == "round_machinery":
        return fn if n_new == march.FIXED_GEOMETRY[1] else f"{fn}_geom"
    if fn == "shadow_final":
        return fn + suffix
    fixed = (128 - rounds * n_new == 64) if fn == "march_sweep" else (rounds, n_new) == march.FIXED_GEOMETRY
    return fn + suffix + ("" if fixed else "_geom")


def route_launches(z_kw: dict, tau: bool, suffix: str, rounds: int, n_new: int) -> dict:
    """The launches of one entry-point call: fused_importance_z's route
    ``z_kw``, or with ``tau`` fused_shadow_tau's."""
    inst = functools.partial(geometry_instance, suffix=suffix, rounds=rounds, n_new=n_new)
    if not z_kw.get("split"):
        return {inst("shadow_march" if tau else "importance_march"): 1}
    sweep, rnd = z_kw.get("sweep_impl", "pallas"), z_kw.get("rounds_impl", "pallas")
    if tau and sweep == rnd == "pallas":
        got = {inst("importance_march"): 1}
    else:
        got = {inst("march_sweep"): 1} if sweep == "pallas" else {}
        got.update({inst("march_rounds"): 1} if rnd == "pallas" else {inst("round_machinery"): rounds})
    if tau and z_kw.get("final_impl", "pallas") == "pallas":
        got[inst("shadow_final")] = 1
    return got


def geometry_inputs(mc: dict, n0: int) -> tuple:
    """Phase 3's camera and shadow rays stratified at n0 samples: (z0 [512,
    n0] between each camera ray's near and far, z0s [512, n0] along each
    shadow ray to 0.99 of its hit)."""
    from nrhints_torch.core.sampling import linspace01

    z0, z0s = mc["z0"], mc["z0s"]
    t = linspace01(n0, device=z0.device)[None, :]
    return (z0[:, :1] + (z0[:, -1:] - z0[:, :1]) * t).contiguous(), (t * z0s[:, -1:]).contiguous()


def b_steps(w, cfg, o, d, z0, sdf0, rounds: int, n_new: int, merge: str) -> list:
    """The (arguments, last) of kernel B's steps of one march at a geometry,
    the inputs captured from the kernel's own run between kernel K's sweeps
    of the new samples; the last merges its draws in."""
    import torch

    from nrhints_torch.kernels import march

    b, n0 = z0.shape
    z = torch.cat([z0, torch.full((b, 128 - n0), march.BIG_Z, device=z0.device)], -1)
    sdf = torch.cat([sdf0, torch.zeros((b, 128 - n0), device=z0.device)], -1)
    steps, new_z, new_sdf = [], None, None
    for i in range(rounds):
        vn, last = n0 + n_new * i, i + 1 == rounds
        args = (z, sdf, o, d, new_z, new_sdf, None if i == 0 else vn - n_new, vn, 64.0 * 2**i, n_new, merge)
        steps.append((args, last))
        if not last:
            new_z, z, sdf = march.round_machinery(*args)
            new_sdf = march.march_sweep(new_z, o, d, w, cfg)
    return steps


def march_geometry_kernels(smi: str, dev, mc: dict, classes: dict, geometries=GEOMETRIES,
                           phase: str = "20(a)") -> dict:
    """Phase 20(a) (see above), at ``geometries`` (phase 23(a): the huge
    class at GEOM_JSON_AT alone).  ``classes``: label -> (march weights, SDF
    config, the entry point's params, mlp_dtype, class suffix).  -> {kernel
    instance: (max abs err, ms, plain ms, bound ms, bound by)} at
    GEOM_JSON_AT."""
    import torch

    from nrhints_torch.fields.sdf import _layer_dims
    from nrhints_torch.kernels import march

    o, d = mc["o"], mc["d"]
    sl, sdir, sdist, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "inv_s", "anneal"))
    out = {}
    for label, (w, cfg, _, dt, suffix) in classes.items():
        f32 = dt == "float32"
        tol_sdf0, tol_tau = (F32_TOL["sdf0"], F32_TOL["tau"]) if f32 else (TOL["march_sweep"], TOL["shadow_march"])
        peak = H100_F32_FLOPS if f32 else H100_BF16_FLOPS
        io, dims = _layer_dims(cfg)
        vm = sum(i * o_ for i, o_ in io) + dims[-2]  # multiply-adds of a value sweep a point
        w_bytes = (4 if f32 else 2) * vm
        # Each kernel's name in a profile (its template and SWEEP, ROUNDS,
        # FINAL), and how often one timed call runs it: B's steps and L's
        # short launches (no sweep at one round) 4 times, so a window keeps
        # a record.
        template = f"march_kernel{suffix}<"
        keys = {k: template + args for args, k, _ in MARCH_TEMPLATES if k in "KLMN"}
        keys["B"] = "round_machinery_kernel<"
        reps = {"B": 4, "L": 4}

        def calls(z0, z0s, sdf0, rounds, n_new, merge="bitonic"):
            kw = dict(rounds=rounds, n_new=n_new, merge=merge)
            steps = b_steps(w, cfg, o, d, z0, sdf0, rounds, n_new, merge)
            return {
                "B": lambda: [march.round_machinery(*a, last=la) for a, la in steps],
                "K": lambda: march.march_sweep(z0, o, d, w, cfg),
                "L": lambda: march.march_rounds(z0, sdf0, o, d, w, cfg, **kw),
                "M": lambda: march.importance_march(z0, o, d, w, cfg, **kw),
                "N": lambda: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg, **kw),
            }, steps

        def device_ms(k, fn):
            n = reps.get(k, 1)
            return launch_device_ms(lambda: [fn() for _ in range(n)], keys[k], tries=3 if n > 1 else 1)

        # The 64 + 4 x 16 instances' device time in this call.
        z0_16, z0s_16 = geometry_inputs(mc, 64)
        ref_calls, _ = calls(z0_16, z0s_16, march.march_sweep(z0_16, o, d, w, cfg), 4, 16)
        ref_ms = {k: device_ms(k, fn) for k, fn in ref_calls.items()}
        for rounds, n_new in geometries:
            n0 = 128 - rounds * n_new
            z0, z0s = geometry_inputs(mc, n0)
            k_sdf0 = march.march_sweep(z0, o, d, w, cfg)
            errs = {"K": max_err([k_sdf0], [march.march_sweep_plain(z0, o, d, w, cfg)])}
            if errs["K"][1] > tol_sdf0:
                raise AssertionError(f"{phase} {label} {rounds} x {n_new}: K's sdf0 rel {errs['K'][1]:.3e}")
            for merge in ("bitonic", "rank") if n_new & (n_new - 1) == 0 else ("bitonic",):
                kw = dict(rounds=rounds, n_new=n_new, merge=merge)
                steps = b_steps(w, cfg, o, d, z0, k_sdf0, rounds, n_new, merge)
                b_err = (0.0, 0.0)
                for args, last in steps:
                    k_out = march.round_machinery(*args, last=last)
                    p_out = march.round_machinery_plain(*args, last=last)
                    if last:
                        nz, z_, sdf_ = march.round_machinery(*args)
                        tail = march.round_machinery_plain(z_, sdf_, o, d, nz, torch.zeros_like(nz), args[7], None,
                                                           None, n_new, merge)
                        if not torch.equal(k_out[1], tail[1]):
                            raise AssertionError(f"{phase} {label} {rounds} x {n_new} {merge}: B's last step differs "
                                                 "from its draw step and the plain merge of its draws")
                    elif not (torch.equal(k_out[1], p_out[1]) and torch.equal(k_out[2], p_out[2])):
                        raise AssertionError(f"{phase} {label} {rounds} x {n_new} {merge}: B's merge differs from the "
                                             f"plain merge at {args[6:8]}")
                    b_err = tuple(max(a, b) for a, b in zip(b_err, max_err(k_out, p_out)))
                l_z = march.march_rounds(z0, k_sdf0, o, d, w, cfg, **kw)
                l_is_bk = torch.equal(l_z, march._rounds(
                    w, cfg, o, d, z0, k_sdf0, rounds, n_new, 64.0, merge, march.round_machinery,
                    lambda new_z, *_: march.march_sweep(new_z.contiguous(), o, d, w, cfg)))
                m_z = march.importance_march(z0, o, d, w, cfg, **kw)
                n_tau = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg, **kw)
                c_tau = march.shadow_final(march.importance_march(z0s, sl, sdir, w, cfg, **kw), sl, sdir, sdist, inv_s,
                                           anneal, w, cfg)
                z_l = z_err(l_z, march.march_rounds_plain(z0, k_sdf0, o, d, w, cfg, **kw), z0)
                z_m = z_err(m_z, march.importance_march_plain(z0, o, d, w, cfg, **kw), z0)
                n_err = max_err([n_tau], [march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg, **kw)])
                for name, e in (("B", b_err), ("L", (z_l[0], 0.0)), ("M", (z_m[0], 0.0)), ("N", n_err)):
                    errs[name] = tuple(max(a, b) for a, b in zip(errs.get(name, (0.0, 0.0)), e))
                ok = (l_is_bk and torch.equal(m_z, l_z) and torch.equal(n_tau, c_tau) and z_l[3] and z_m[3]
                      and min(z_l[2], z_m[2]) >= Z_NN_SHARE and b_err[1] <= TOL["round_machinery"]
                      and n_err[1] <= tol_tau)
                log(f"[{phase} {label} {rounds} x {n_new} {merge}] n0 {n0}: B's {len(steps)} steps rel err "
                    f"{b_err[1]:.3e}; L's z {z_l[2]:.4f} of the samples within {Z_TOL} of a plain sample (slot by slot "
                    f"{z_l[1]:.4f}), M's {z_m[2]:.4f} ({z_m[1]:.4f}); N's tau rel err {n_err[1]:.3e}; L = B's steps "
                    f"between K's sweeps bit for bit: {l_is_bk}; M = L(K(.)): {torch.equal(m_z, l_z)}; N = C(M(.)): "
                    f"{torch.equal(n_tau, c_tau)}")
                if not ok:
                    raise AssertionError(f"{phase} {label} {rounds} x {n_new} {merge}: a check fails (see above)")
            sweeps = rounds - 1  # rounds whose samples are swept
            rows = {"K": n0, "L": sweeps * n_new, "M": n0 + sweeps * n_new}
            # Bytes a ray of a launch, on average over the march's: z and sdf
            # in, o and d, z out; the previous draws (z, sdf) where it merges,
            # the draws and sdf out but in the last.
            per_ray = 4 * ((2 * 128 + 6 + 128) + (2 * n_new + n_new + 128) * (rounds - 1) / rounds)
            bounds = {
                "B": bound(512 * 128 * 64, 512 * per_ray, H100_F32_FLOPS),
                "K": bound(2.0 * 512 * n0 * vm, 512 * 4 * (2 * n0 + 6) + w_bytes, peak),
                "L": bound(2.0 * 512 * rows["L"] * vm, 512 * 4 * (2 * n0 + 6 + 128) + w_bytes, peak),
                "M": bound(2.0 * 512 * rows["M"] * vm, 512 * 4 * (n0 + 6 + 128) + w_bytes, peak),
                "N": bound(2.0 * 512 * (rows["M"] + 128 * 2) * vm, 512 * 4 * (n0 + 6 + 2) + w_bytes, peak),
            }
            geo_calls, steps = calls(z0, z0s, k_sdf0, rounds, n_new)
            for k, fn in geo_calls.items():
                dev_ms = device_ms(k, fn)
                bd, by = bounds[k]
                log(f"[{phase} kernel {k} {label}] {rounds} x {n_new} (n0 {n0}): device time {dev_ms:.4f} ms"
                    f"{' a launch' if k == 'B' else ''}, the 64 + 4 x 16 instance's {ref_ms[k]:.4f} ms in this call "
                    f"({dev_ms / ref_ms[k]:.2f}x); bound {bd:.5f} ms ({by}), {dev_ms / bd:.2f}x it; max abs err "
                    f"{errs[k][0]:.3e} (rel {errs[k][1]:.3e}); on {smi}")
                if (rounds, n_new) == GEOM_JSON_AT:
                    plain = {
                        "B": lambda: [march.round_machinery_plain(*a, last=la) for a, la in steps],
                        "K": lambda: march.march_sweep_plain(z0, o, d, w, cfg),
                        "L": lambda: march.march_rounds_plain(z0, k_sdf0, o, d, w, cfg, rounds=rounds, n_new=n_new),
                        "M": lambda: march.importance_march_plain(z0, o, d, w, cfg, rounds=rounds, n_new=n_new),
                        "N": lambda: march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg,
                                                              rounds=rounds, n_new=n_new),
                    }[k]
                    div = rounds if k == "B" else 1
                    inst = geometry_instance({"B": "round_machinery", "K": "march_sweep", "L": "march_rounds",
                                              "M": "importance_march", "N": "shadow_march"}[k], suffix, rounds, n_new)
                    if inst not in out:
                        out[inst] = (errs[k][0], cuda_ms(fn, 5) / div, cuda_ms(plain, 2, warmup=1) / div, bd, by)
    return out


def march_geometry_phase(smi: str, dev, mc: dict) -> list:
    """Phase 20 (see above).  -> the kernels line's entries of the run-time
    geometry instances, their launches those of (b)'s entry-point calls,
    their numbers (a)'s at GEOM_JSON_AT."""
    import torch

    from nrhints_torch.fields.sdf import sdf_init
    from nrhints_torch.kernels import core_mlp, cuda_lib, march

    t_phase = time.perf_counter()
    ncfg = mc["cfg"].model.sdf_network
    wcfg = dataclasses.replace(ncfg, **WIDE_SDF)
    nparams = mc["renderer_params"]["sdf"]
    wparams = sdf_init(torch.Generator().manual_seed(0), wcfg, dev)
    classes = {}
    for label, dt, wide in GEOM_CLASSES:
        cfg, params = (wcfg, wparams) if wide else (ncfg, nparams)
        suffix = ("_f32" if dt == "float32" else "") + core_mlp.core_class(cfg, with_feat=False).suffix
        classes[label] = (march.march_weights(params, cfg, dt), cfg, params, dt, suffix)
    nums = march_geometry_kernels(smi, dev, mc, classes)
    t_a = time.perf_counter() - t_phase

    # (b) Both entry points on every route, launches exact.
    o, d = mc["o"], mc["d"]
    sl, sdir, sdist, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "inv_s", "anneal"))
    want: dict[str, int] = {}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    n_calls = 0
    for label, (w, cfg, params, dt, suffix) in classes.items():
        tol_tau = F32_TOL["tau"] if dt == "float32" else TOL["shadow_march"]
        for rounds, n_new in GEOMETRIES:
            z0, z0s = geometry_inputs(mc, 128 - rounds * n_new)
            for merge in ("bitonic", "rank") if n_new & (n_new - 1) == 0 else ("bitonic",):
                kw = dict(rounds=rounds, n_new=n_new, merge=merge, mlp_dtype=dt)
                plain_z = march.importance_march_plain(z0, o, d, w, cfg, rounds=rounds, n_new=n_new, merge=merge)
                plain_tau = march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, w, cfg, rounds=rounds,
                                                     n_new=n_new, merge=merge)
                zs = {}
                for route, rkw in GEOM_Z_ROUTES.items():
                    zs[route] = march.fused_importance_z(params, cfg, o, d, z0, **kw, **rkw)
                    for k, v in route_launches(rkw, False, suffix, rounds, n_new).items():
                        want[k] = want.get(k, 0) + v
                    e = z_err(zs[route], plain_z, z0)
                    if not (e[3] and e[2] >= Z_NN_SHARE):
                        raise AssertionError(f"20(b) {label} {rounds} x {n_new} {merge} fused_importance_z {route}: "
                                             f"z against the plain march {e}")
                taus = {}
                for route, rkw in GEOM_TAU_ROUTES.items():
                    taus[route] = march.fused_shadow_tau(params, cfg, sl, sdir, z0s, sdist, inv_s, anneal, **kw, **rkw)
                    for k, v in route_launches(rkw, True, suffix, rounds, n_new).items():
                        want[k] = want.get(k, 0) + v
                    e = max_err([taus[route]], [plain_tau])
                    if not e[1] <= tol_tau:
                        raise AssertionError(f"20(b) {label} {rounds} x {n_new} {merge} fused_shadow_tau {route}: "
                                             f"tau rel err {e[1]:.3e} against the plain march")
                n_calls += len(zs) + len(taus)
                if not (torch.equal(zs["monolith"], zs["split"])
                        and torch.equal(taus["monolith"], taus["split pallas/pallas/pallas"])):
                    raise AssertionError(f"20(b) {label} {rounds} x {n_new} {merge}: the monolith differs from the "
                                         "split kernels")
    torch.cuda.synchronize()
    got = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    if got != want:
        raise AssertionError(f"20(b): launches {got}, expected {want}")
    log(f"[20(b)] fused_importance_z on {len(GEOM_Z_ROUTES)} routes and fused_shadow_tau on {len(GEOM_TAU_ROUTES)} at "
        f"{len(GEOMETRIES)} geometries, both merges where allowed, {len(classes)} classes: {n_calls} calls, each "
        f"against the plain march, the monoliths equal to the split kernels bit for bit; launches exact: "
        f"{json.dumps(got, sort_keys=True)}")

    # (c) Out of the range: raised before any launch.
    w, cfg, params, dt, _ = classes["bf16"]
    cuda_lib.reset_launch_counts()
    for rounds, n_new, merge in GEOM_OUT_OF_RANGE:
        n0 = 128 - rounds * n_new
        z0 = torch.zeros((o.shape[0], n0), device=dev)
        for what, call in (
                ("fused_importance_z", lambda: march.fused_importance_z(params, cfg, o, d, z0, rounds=rounds,
                                                                        n_new=n_new, merge=merge)),
                ("fused_shadow_tau split", lambda: march.fused_shadow_tau(
                    params, cfg, sl, sdir, z0, sdist, inv_s, anneal, rounds=rounds, n_new=n_new, merge=merge,
                    split=True)),
                ("march_rounds", lambda: march.march_rounds(z0, z0, o, d, w, cfg, rounds=rounds, n_new=n_new,
                                                            merge=merge)),
                ("importance_march", lambda: march.importance_march(z0, o, d, w, cfg, rounds=rounds, n_new=n_new,
                                                                    merge=merge)),
                ("shadow_march", lambda: march.shadow_march(z0, sl, sdir, sdist, inv_s, anneal, w, cfg, rounds=rounds,
                                                            n_new=n_new, merge=merge))):
            exc = ValueError if what.startswith("fused") and merge == "rank" else NotImplementedError
            try:
                call()
            except exc as err:
                msg = str(err)
            else:
                raise AssertionError(f"20(c) {what} at {rounds} x {n_new} {merge} did not raise {exc.__name__}")
        log(f"[20(c)] {rounds} x {n_new} (n0 {n0}) {merge}: the entry points and L, M, N raise before any launch: "
            f"{msg[:120]}")
    if any(cuda_lib.launch_counts.values()):
        raise AssertionError(f"20(c): launches out of the range: {dict(cuda_lib.launch_counts)}")
    log(f"[20] phase 20 took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    where = {"round_machinery": ("march.cu", 392), "march_sweep": ("march_geom.cu", 507),
             "march_rounds": ("march_geom.cu", 522), "importance_march": ("march_geom.cu", 488),
             "shadow_march": ("march_geom.cu", 595)}
    entries = []
    for name, num in nums.items():
        src, line = where[re.sub(r"(_f32)?(_wide)?_geom$", "", name)]
        entries.append(dict(entry(name, src, f"march.py:{line}", got.get(name, 0), *num),
                            geometry=f"{GEOM_JSON_AT[0]} x {GEOM_JSON_AT[1]}"))
    return entries


def phase_subprocess(flags: list, prefixes: tuple, timeout: int = 900) -> list:
    """Phases in a process of their own (``flags``, the kernels already
    built), their lines that begin with one of ``prefixes`` relayed: late in
    the plain run, after some thousand profiled calls in one process, the
    profiler kept no record of whole launches or halved them (two runs of
    phase 20 inside it), where the same phase in a fresh process reads every
    kernel.  -> their kernels line's entries.  Raises if it fails."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *flags], capture_output=True, text=True,
                          timeout=timeout)
    entries = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernels": '):
            entries = json.loads(line)["kernels"]
        elif line.startswith(prefixes):
            log(line)
    if proc.returncode != 0 or entries is None:
        raise AssertionError(f"{' '.join(flags)} failed (rc {proc.returncode}): {proc.stderr[-4000:]}")
    return entries


# Phase 22: networks deeper than the kernels' parameter tables (16 layers):
# every MLP kernel then reads its per-layer tables from the meta vector's
# copy on the card, and the dW passes run in groups of kMaxJobs products.
# The model is nr-hints-cam-opt at the presets' widths with DEEP_SDF (20
# SDF layers, the skip at 4) and DEEP_REFL (a 20-layer reflectance trunk:
# 361 -> 20 x 256 -> 3).  (a) at phase 3's shapes, A, D, E, H and D's and
# E's stash_all variants at bf16 and at f32 operands and stash, F, G, I and
# J at bf16 (deep_kernels), and C, K, L, M and N at bf16 and f32 march
# weights (march_class_kernels at DEEP_SDF), each against its plain version
# at phase 3's tolerances (CORE_F32_TOL and F32_TOL at f32) with the
# identities (D = A, the variant = D, I = F, J = G at F's stash, E, G, H
# and J repeating, L = B/K, M = L(K), N = C(M), bit for bit), each by device
# time beside the 8-layer instance's in this call and its bound.  (b) the
# whole model: a K = DEEP_K graph of stash steps against its eager steps, a
# profiled recompute, stash_all and split-route step, and 128x128 views
# through their graphs on the shipping route and the monolith, each with
# exact launches, s/step or s/view and the device idle share.
DEEP_SDF = {"n_layers": 20, "skip_in": (4,)}
DEEP_REFL = {"n_layers": 20}
DEEP_K = 16
DEEP_STEP = dict(sdf_stash_fwd=1, sdf_stash_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1, round_machinery=8,
                 shadow_final=1)
DEEP_WHERE = {"sdf_core_fwd": ("sdf_core.cu", "core_mlp.py:227"), "sdf_stash_fwd": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_all_fwd": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_bwd": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_stash_all_bwd": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_core_bwd": ("sdf_core_bwd.cu", "core_mlp.py:260"),
              "mlp_stash_fwd": ("mlp_stash.cu", "core_stash.py:588"),
              "mlp_stash_bwd": ("mlp_stash.cu", "core_stash.py:622"), "mlp_fwd": ("mlp_stash.cu", "core_mlp.py:397"),
              "mlp_bwd": ("mlp_stash.cu", "core_mlp.py:420"), "round_machinery": ("march.cu", "march.py:392"),
              "shadow_final": ("march.cu", "march.py:574"), "march_sweep": ("march_fused.cu", "march.py:507"),
              "march_rounds": ("march_fused.cu", "march.py:522"),
              "importance_march": ("march_fused.cu", "march.py:488"),
              "shadow_march": ("march_fused.cu", "march.py:595")}


def deep_model_cfg(cfg, **renderer_kw):
    """``cfg`` with DEEP_SDF's SDF and DEEP_REFL's reflectance trunk, and
    ``renderer_kw``'s renderer settings."""
    rn = dataclasses.replace(cfg.model.reflectance_network, **DEEP_REFL)
    return with_renderer(with_model(cfg, sdf=DEEP_SDF, reflectance_network=rn), **renderer_kw)


def deep_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 22(a), the SDF core and the trunk at depth 20 (see above).  ->
    {instance name: (max abs err, ms, plain ms, bound ms, bound by)} of the
    bf16 instances (the f32 ones are logged)."""
    import numpy as np
    import torch

    from nrhints_torch.fields.mlp import torch_default_linear_init
    from nrhints_torch.fields.sdf import _layer_dims, sdf_init
    from nrhints_torch.kernels import core_mlp, core_stash

    torch.backends.cuda.matmul.allow_tf32 = False
    x, aw, ncfg = mc["x"], mc["aw"], mc["cfg"].model.sdf_network
    scfg = dataclasses.replace(ncfg, **DEEP_SDF)
    if scfg.d_out_feat != ncfg.d_out_feat or core_mlp.core_class(scfg) is not core_mlp.NARROW or \
            scfg.n_layers <= core_mlp.MAX_LAYERS:
        raise AssertionError(f"22(a): {DEEP_SDF} is not a 64-point SDF deeper than the parameter tables")
    w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), scfg, dev), scfg)
    n_pts, n_w, L = x.shape[0], sum(t.numel() for t in w), scfg.n_layers
    io, dims = _layer_dims(scfg)
    hidden, d_last, d_feat = sum(i * o_ for i, o_ in io), dims[-2], scfg.d_out_feat
    crng = np.random.default_rng(5)
    cots = tuple(torch.tensor(crng.normal(size=sh).astype(np.float32), device=dev)
                 for sh in ((n_pts,), (n_pts, d_feat), (n_pts, 3)))
    io_bytes = n_pts * 4 * (3 + 1 + d_feat + 3)
    fwd_flops = 2.0 * n_pts * (2 * hidden + d_last * (1 + d_feat))
    bwd_flops = {us: 2.0 * n_pts * ((4 if us else 5) * hidden + 2 * d_last * d_feat + 2 * d_last)
                 for us in (False, True)}
    out, logged, base_dev = {}, {}, {}

    def record(name, checks, fn, plain_fn, group, base_fn, bd):
        instance_record("22(a)", out if "_f32" not in name else logged, base_dev, n_pts, smi, name, checks, fn,
                        plain_fn, group, base_fn, group, bd, base="the 8-layer instance's", iters=5, tries=1)

    for compute in ("bfloat16", "float32"):
        f32 = compute == "float32"
        kw = dict(compute_dtype=compute)
        size, peak = (4, H100_F32_FLOPS) if f32 else (2, H100_BF16_FLOPS)
        out_tol = CORE_F32_TOL["out"] if f32 else TOL["sdf_core_fwd"]
        grad_tol = CORE_F32_TOL["grad"] if f32 else TOL["sdf_stash_bwd"]
        # f32: exact dots on both sides, entry by entry; bf16: by the norm.
        out_err, g_err = (max_err, grad_err) if f32 else (norm_err, norm_err)

        def grp(label, bf16_group):
            return core_f32_group(label, compute, None) if f32 else bf16_group

        a = core_mlp.sdf_core_fwd(w, x, scfg, **kw)
        if not all(torch.equal(u, v) for u, v in zip(a, core_mlp.sdf_core_fwd(w, x, scfg, **kw))):
            raise AssertionError(f"22(a): kernel A at {compute} differs between two runs")
        record(core_mlp.instance_name("sdf_core_fwd", compute),
               [("outputs", out_err(a, core_mlp.sdf_core_plain(w, x, scfg, compute)), out_tol)],
               lambda kw=kw: core_mlp.sdf_core_fwd(w, x, scfg, **kw),
               lambda c=compute: core_mlp.sdf_core_plain(w, x, scfg, c), grp("kernel A", "kernel A sdf_core_fwd"),
               lambda kw=kw: core_mlp.sdf_core_fwd(aw, x, ncfg, **kw), bound(fwd_flops, io_bytes + size * n_w, peak))
        d_h = None
        for us in (False, True):
            fn_d, fn_e = ("sdf_stash_all_fwd", "sdf_stash_all_bwd") if us else ("sdf_stash_fwd", "sdf_stash_bwd")
            skw = dict(kw, stash_dtype=compute, stash_us=us)
            width = core_stash.sdf_stash_width(scfg, us)
            d = core_stash.sdf_stash_fwd(w, x, scfg, **skw)
            if not all(torch.equal(u, v) for u, v in zip(d[:3], a)):
                raise AssertionError(f"22(a): {fn_d} at {compute}: outputs differ from kernel A's")
            if us and not torch.equal(d[3][:, : core_stash.sdf_stash_width(scfg)], d_h):
                raise AssertionError(f"22(a): {fn_d} at {compute}: the h_i differ from kernel D's")
            d_h = d[3]
            plain = core_stash.sdf_core_fwd_hs_plain(w, x, scfg, compute, compute, return_us=us)
            parts = core_stash.split_stash(d[3], core_stash.sdf_stash_columns(scfg, us))
            checks = [("outputs", out_err(d[:3], plain[:3]), out_tol),
                      ("stash", out_err(parts, [*plain[3], *plain[4], plain[5]] if us else plain[3]), out_tol)]
            del plain
            d_label, e_label = ("kernel D stash_all", "kernel E1 stash_all") if us else ("kernel D", "kernel E1")
            record(core_mlp.instance_name(fn_d, compute, compute), checks,
                   lambda skw=skw: core_stash.sdf_stash_fwd(w, x, scfg, **skw),
                   lambda c=compute, us=us: core_stash.sdf_core_fwd_hs_plain(w, x, scfg, c, c, return_us=us),
                   grp(d_label, D_ALL_GROUP if us else "kernel D sdf_stash_fwd"),
                   lambda skw=skw: core_stash.sdf_stash_fwd(aw, x, ncfg, **skw),
                   bound(fwd_flops, io_bytes + size * (n_pts * width + n_w), peak))
            e_dws, e_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, **skw)
            e2_dws, e2_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, **skw)
            if not (torch.equal(e_dx, e2_dx) and all(torch.equal(u, v) for u, v in zip(e_dws, e2_dws))):
                raise AssertionError(f"22(a): {fn_e} at {compute}: the gradients differ between two runs")
            del e2_dws, e2_dx

            def e_plain(parts=parts, us=us, c=compute):
                if us:
                    return core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L],
                                                                   cots, scfg, c)
                return core_stash.sdf_core_bwd_stash_plain(w, x, parts, cots, scfg, c)

            p_dws, p_dx = e_plain()
            err = g_err([e_dx, *e_dws], [p_dx, *p_dws])
            del p_dws, p_dx, e_dws, e_dx
            n_stash = core_stash.sdf_stash_fwd(aw, x, ncfg, **skw)[3]
            record(core_mlp.instance_name(fn_e, compute, compute), [("gradients", err, grad_tol)],
                   lambda skw=skw, st=d[3]: core_stash.sdf_stash_bwd(w, x, st, cots, scfg, **skw), e_plain,
                   (grp(e_label, E1_ALL_GROUP if us else "kernel E sdf_stash_bwd (E1)"), DW_GROUP),
                   lambda skw=skw, st=n_stash: core_stash.sdf_stash_bwd(aw, x, st, cots, ncfg, **skw),
                   bound(bwd_flops[us], io_bytes + size * n_pts * width + (size + 4) * n_w, peak))
            del d, parts
        h_dws, h_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg, **kw)
        h2_dws, h2_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg, **kw)
        if not (torch.equal(h_dx, h2_dx) and all(torch.equal(u, v) for u, v in zip(h_dws, h2_dws))):
            raise AssertionError(f"22(a): kernel H at {compute}: the gradients differ between two runs")
        hp_dws, hp_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, compute)
        err = g_err([h_dx, *h_dws], [hp_dx, *hp_dws])
        del h_dws, h_dx, h2_dws, h2_dx, hp_dws, hp_dx, d_h
        h_groups = ((core_f32_group("kernel H1", compute, None), core_f32_group("kernel H2", compute, None)) if f32
                    else ("kernel H, forward pass (H1)", "kernel H chain (H2)"))
        record(core_mlp.instance_name("sdf_core_bwd", compute), [("gradients", err, TOL["sdf_core_bwd"] if not f32
                                                                   else CORE_F32_TOL["grad"])],
               lambda kw=kw: core_mlp.sdf_core_bwd(w, x, cots, scfg, **kw),
               lambda c=compute: core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, c), (*h_groups, DW_GROUP),
               lambda kw=kw: core_mlp.sdf_core_bwd(aw, x, cots, ncfg, **kw),
               bound(bwd_flops[False] + 2.0 * n_pts * hidden, io_bytes + (size + 4) * n_w, peak))
        gc.collect()
        torch.cuda.empty_cache()

    # The trunk, 361 -> 20 x 256 -> 3, against the presets' 361 -> 4 x 256 -> 3.
    rn = mc["cfg"].model.reflectance_network
    d_in = 361
    trunks = {}
    for n_lay in (DEEP_REFL["n_layers"], rn.n_layers):
        tdims = (d_in,) + (rn.d_hidden,) * n_lay + (3,)
        gen = torch.Generator().manual_seed(1)
        tw = []
        for i in range(len(tdims) - 1):
            tw += list(torch_default_linear_init(gen, tdims[i], tdims[i + 1], dev))
        trunks[n_lay] = (tw, tdims)
    tw, tdims = trunks[DEEP_REFL["n_layers"]]
    bw, _ = trunks[rn.n_layers]
    n_lay, b_lay = DEEP_REFL["n_layers"], rn.n_layers
    trng = np.random.default_rng(6)
    xt = torch.tensor(trng.normal(size=(n_pts, d_in)).astype(np.float32), device=dev)
    gt = torch.tensor(trng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    macs = sum(a_ * b_ for a_, b_ in zip(tdims[:-1], tdims[1:]))
    zt = rn.d_hidden * n_lay
    t_bytes = n_pts * 4 * (d_in + 3)
    f_out, zs = core_stash.mlp_stash_fwd(tw, xt, n_lay)
    p_out, p_zs = core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, "bfloat16", "bfloat16")
    cols = core_stash.mlp_stash_columns(core_mlp.pack_mlp(tw, n_lay))
    record("mlp_stash_fwd", [("output", norm_err([f_out], [p_out]), TOL["mlp_stash_fwd"]),
                             ("stash", norm_err(core_stash.split_stash(zs, cols), p_zs), TOL["mlp_stash_fwd"])],
           lambda: core_stash.mlp_stash_fwd(tw, xt, n_lay),
           lambda: core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, "bfloat16", "bfloat16"), "kernel F mlp_stash_fwd",
           lambda: core_stash.mlp_stash_fwd(bw, xt, b_lay), bound(2.0 * n_pts * macs, t_bytes + 2 * n_pts * zt,
                                                                  H100_BF16_FLOPS))
    i_out = core_mlp.mlp_fwd(tw, xt, n_lay)
    if not torch.equal(i_out, f_out):
        raise AssertionError("22(a): kernel I's output differs from kernel F's")
    record("mlp_fwd", [("output", norm_err([i_out], [p_out]), TOL["mlp_fwd"])],
           lambda: core_mlp.mlp_fwd(tw, xt, n_lay), lambda: core_mlp.mlp_relu_plain(tw, xt, n_lay, "bfloat16"),
           "kernel I mlp_fwd", lambda: core_mlp.mlp_fwd(bw, xt, b_lay),
           bound(2.0 * n_pts * macs, t_bytes, H100_BF16_FLOPS))
    g_dws, g_dx = core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay)
    g2_dws, g2_dx = core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay)
    if not (torch.equal(g_dx, g2_dx) and all(torch.equal(u, v) for u, v in zip(g_dws, g2_dws))):
        raise AssertionError("22(a): kernel G's gradients differ between two runs")
    pg_dws, pg_dx = core_stash.mlp_relu_bwd_stash_plain(tw, xt, core_stash.split_stash(zs, cols), gt, n_lay,
                                                        "bfloat16")
    b_zs = core_stash.mlp_stash_fwd(bw, xt, b_lay)[1]
    record("mlp_stash_bwd", [("gradients", norm_err([g_dx, *g_dws], [pg_dx, *pg_dws]), TOL["mlp_stash_bwd"])],
           lambda: core_stash.mlp_stash_bwd(tw, xt, zs, gt, n_lay),
           lambda: core_stash.mlp_relu_bwd_stash_plain(tw, xt, core_stash.split_stash(zs, cols), gt, n_lay,
                                                       "bfloat16"), (TRUNK_CHAIN_GROUP, DW_GROUP),
           lambda: core_stash.mlp_stash_bwd(bw, xt, b_zs, gt, b_lay),
           bound(4.0 * n_pts * macs, t_bytes + 2 * n_pts * zt + 4 * n_pts * d_in, H100_BF16_FLOPS))
    j_dws, j_dx = core_mlp.mlp_bwd(tw, xt, gt, n_lay)
    if not (torch.equal(j_dx, g_dx) and all(torch.equal(u, v) for u, v in zip(j_dws, g_dws))):
        raise AssertionError("22(a): kernel J's gradients differ from kernel G's at F's stash")
    record("mlp_bwd", [("gradients", norm_err([j_dx, *j_dws], [pg_dx, *pg_dws]), TOL["mlp_bwd"])],
           lambda: core_mlp.mlp_bwd(tw, xt, gt, n_lay),
           lambda: core_mlp.mlp_relu_bwd_plain(tw, xt, gt, n_lay, "bfloat16"),
           ("kernel J, recompute pass (J1)", TRUNK_CHAIN_GROUP, DW_GROUP),
           lambda: core_mlp.mlp_bwd(bw, xt, gt, b_lay),
           bound(6.0 * n_pts * macs, t_bytes + 4 * n_pts * d_in, H100_BF16_FLOPS))
    log(f"[22(a)] I = F, J = G at F's stash, E, G, H and J repeat, D = A and the variant's h_i = D's, bit for bit, "
        f"at {DEEP_SDF} and a {n_lay}-layer trunk; the f32 instances above: {sorted(logged)}")
    del trunks, tw, bw, zs, b_zs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def deep_phase(smi: str, dev, mc: dict) -> list:
    """Phase 22, networks deeper than the parameter tables (see above).  ->
    the kernels line's entries of the bf16 instances at depth 20 (marked
    "depth"), each with its launches from the whole-model run that runs it:
    A's and C's from the shipping view, M's and N's from the monolith view,
    D's, E's, F's and G's from (b)'s K = DEEP_K dispatch, H's, I's and J's
    from the recompute step, the variants' from the stash_all step, K's and
    L's from the split step."""
    import torch

    from nrhints_torch.render.renderer import init_model_params

    t_phase = time.perf_counter()
    nums = deep_kernels(smi, dev, mc)
    nums.update({k: v for k, v in march_class_kernels(smi, dev, mc, DEEP_SDF, "22(a)",
                                                     "the 8-layer instance's").items() if "_f32" not in k})
    t_a = time.perf_counter() - t_phase

    # (b) The whole model: the train path, then the views.
    td = train_data(dev, 128, 128)
    dcfg = deep_model_cfg(td["cfg"])
    batches = [td["next_batch"]() for _ in range(DEEP_K + TRAIN_WARMUP)]
    sc = scan_phase(smi, dev, td, batches, "22(b) deep graph", dcfg, DEEP_K, DEEP_STEP)
    ship = dict(round_machinery=8, shadow_final=1)
    rec = wide_one_step("22(b) deep recompute step", smi, dev, with_renderer(dcfg, core_backward="recompute"), td,
                        batches[1], dict(sdf_core_fwd=1, sdf_core_bwd=1, mlp_fwd=1, mlp_bwd=1, **ship), profiled=True)
    sa = wide_one_step("22(b) deep stash_all step", smi, dev, with_renderer(dcfg, core_backward="stash_all"), td,
                       batches[2], dict(sdf_stash_all_fwd=1, sdf_stash_all_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1,
                                        **ship), profiled=True)
    split = wide_one_step("22(b) deep split-route step", smi, dev, with_renderer(dcfg, **SPLIT), td, batches[3],
                          dict(DEEP_STEP, round_machinery=0, shadow_final=1, march_sweep=1, march_rounds=1,
                               importance_march=1))
    gc.collect()
    torch.cuda.empty_cache()
    vcfg = deep_model_cfg(mc["cfg"])
    params = {"renderer": init_model_params(vcfg.model, torch.Generator().manual_seed(0), device=dev), "raygen": {}}
    ship_view = wide_view("22(b) deep view", smi, mc, vcfg, params, dict(sdf_core_fwd=1, **ship))
    # The monolith's M and N were held against the plain march in (a); the
    # shipping view holds the model against the CPU.
    mono_view = wide_view("22(b) deep monolith view", smi, mc, deep_model_cfg(mc["cfg"], **MONOLITH), params,
                          dict(sdf_core_fwd=1, importance_march=1, shadow_march=1), cpu_check=False)
    del params
    log(f"[22] phase 22 took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    got = dict(sdf_core_fwd=ship_view["sdf_core_fwd"], shadow_final=ship_view["shadow_final"],
               importance_march=mono_view["importance_march"], shadow_march=mono_view["shadow_march"],
               **{k: sc["launches"][k] for k in ("sdf_stash_fwd", "sdf_stash_bwd", "mlp_stash_fwd", "mlp_stash_bwd")},
               **{k: rec[k] for k in ("sdf_core_bwd", "mlp_fwd", "mlp_bwd")},
               **{k: sa[k] for k in ("sdf_stash_all_fwd", "sdf_stash_all_bwd")},
               **{k: split[k] for k in ("march_sweep", "march_rounds")})
    return [dict(entry(name, *DEEP_WHERE[name], got[name], *num), depth=DEEP_SDF["n_layers"])
            for name, num in nums.items()]


# Phase 23: the SDF above the wide class: the SDF core's huge instances (A,
# D, E, H and D's and E's stash_all variants: 64-point blocks whose
# activations, carry and encoding are rows of device memory; any width, bf16
# only) and the march kernels' (C, K, L, M and N on the row engine's huge
# class: 64 rows a pass in device memory; bf16 march weights only).  The
# model is nr-hints-cam-opt at HUGE_SDF (d_hidden 1024, 8 layers, skip at 4,
# multi_res 6, a 256-wide feature head) on its default routes: kernel C's
# final shadow sweep after plain sweeps between kernel B's steps, the core
# and the trunk (361 -> 4 x 256 -> 3) fused.  (a) every huge core instance
# at phase 3's 256-wide SDF (its pack's class set to CORE_HUGE) equal to the
# 64-point instance bit for bit, then at phase 3's 65,536 points at HUGE_SDF
# and at HUGE_ENC (d_hidden 256, multi_res 24: an encoding 147 wide, padded
# 160, the class taken by the encoding alone) against its plain version at
# TOL, with D = A, the variant = D, E and H repeating and E without its dW
# passes, bit for bit; each timed (CUDA events, HUGE_SDF only) and by device
# ms from one profiled call beside the wide instance's at WIDE_SDF in the
# same call and its bound.  Then the march kernels: every huge entry point
# at phase 3's SDF (the pack's class set to ROWS_HUGE) equal to the narrow
# instance bit for bit, at 64 + 4 x 16 under both merges and at the
# run-time geometry GEOM_JSON_AT; C, K, L, M and N huge at phase 3's 512
# rays at HUGE_SDF and HUGE_ENC against their plain versions, with L = B/K,
# M = L(K), N = C(M) bit for bit under both merges, each by device ms beside
# the wide instance's at WIDE_SDF (HUGE_SDF timed); and K, L, M and N's
# run-time geometry instances at GEOM_JSON_AT and HUGE_SDF, as phase 20(a)
# holds them, then the entry points at that geometry on the monolith and the
# split march, launches exact.  (b) a K = HUGE_K graph of stash steps on the
# default route against its eager steps; a 64-ray step's gradients against
# the CPU; one recompute and one stash_all step; a profiled monolith step
# (M, N) and the split route's step (K, L, M, C): exact launches, s/step and
# idle shares.  (c) 128x128 views through their graphs on the default route
# and on the monolith, each against its eager sweep and 64 pixels on the
# CPU.  (d) python -m nrhints_torch's main for WIDE_ENTRY_STEPS steps at
# d_hidden 1024 on the default routes.  (e) the limits: HUGE_SDF at
# march_dtype="float32" raises NotImplementedError naming the march kernels
# and item 15 before any launch, and so do the core's entry points at
# compute_dtype="float32" (every schedule) and at stash_dtype="float32".
HUGE_SDF = {"d_hidden": 1024}
HUGE_ENC = {"d_hidden": 256, "multi_res": 24}
HUGE_K = 16
HUGE_WHERE = {"sdf_core_fwd_huge": ("sdf_core.cu", "core_mlp.py:227"),
              "sdf_stash_fwd_huge": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_all_fwd_huge": ("sdf_core.cu", "core_stash.py:369"),
              "sdf_stash_bwd_huge": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_stash_all_bwd_huge": ("sdf_stash.cu", "core_stash.py:422"),
              "sdf_core_bwd_huge": ("sdf_core_bwd.cu", "core_mlp.py:260"),
              **{f"{fn}_huge{g}": ("march.cu" if k == "C" else "march_fused_huge.cu", f"march.py:{line}")
                 for k, fn, line in (("C", "shadow_final", 574), ("K", "march_sweep", 507),
                                     ("L", "march_rounds", 522), ("M", "importance_march", 488),
                                     ("N", "shadow_march", 595))
                 for g in ("", "_geom") if k != "C" or not g}}
# One step's launches on the default routes: the core, the 256-wide trunk,
# B's 8 steps and kernel C.
HUGE_SHIP = dict(round_machinery=8, shadow_final_huge=1)
HUGE_CORE_STEP = dict(sdf_stash_fwd_huge=1, sdf_stash_bwd_huge=1, mlp_stash_fwd=1, mlp_stash_bwd=1)
HUGE_STEP = dict(HUGE_CORE_STEP, **HUGE_SHIP)
HUGE_ROUTES = {"monolith": (MONOLITH, dict(importance_march_huge=1, shadow_march_huge=1)),
               "split": (SPLIT, dict(march_sweep_huge=1, march_rounds_huge=1, importance_march_huge=1,
                                     shadow_final_huge=1))}


def huge_cfg(cfg, **renderer_kw):
    """``cfg`` with HUGE_SDF's SDF network and ``renderer_kw``."""
    return with_renderer(with_model(cfg, sdf=HUGE_SDF), **renderer_kw)


def huge_kernels(smi: str, dev, mc: dict) -> dict:
    """Phase 23(a) (see above).  -> {instance name: (max abs err, ms, plain
    ms, bound ms, bound by)} of the HUGE_SDF instances."""
    import numpy as np
    import torch

    from nrhints_torch.fields.sdf import _layer_dims, sdf_init
    from nrhints_torch.kernels import core_mlp, core_stash

    x, ncfg = mc["x"], mc["cfg"].model.sdf_network
    n_pts = x.shape[0]
    out, base_dev = {}, {}

    def cotangents(d_feat):
        crng = np.random.default_rng(5)
        return tuple(torch.tensor(crng.normal(size=s).astype(np.float32), device=dev)
                     for s in ((n_pts,), (n_pts, d_feat), (n_pts, 3)))

    # The huge instances at the presets' widths (phase 3's SDF, its pack's
    # class set to CORE_HUGE) give the 64-point instances' outputs bit for
    # bit: the same products in the same k order, the tiles elsewhere.
    def flat(out):
        return [t for o in out for t in (o if isinstance(o, (tuple, list)) else (o,))]

    ncots = cotangents(ncfg.d_out_feat)
    pk = core_mlp.pack_sdf_mlp(mc["aw"], ncfg, with_feat=True)
    same = {}
    for name, call in (("A", lambda p: core_mlp.sdf_core_fwd(mc["aw"], x, ncfg, p)),
                       ("H", lambda p: core_mlp.sdf_core_bwd(mc["aw"], x, ncots, ncfg, p)),
                       *((f"D{u}", lambda p, us=us: core_stash.sdf_stash_fwd(mc["aw"], x, ncfg, p, stash_us=us))
                         for us, u in ((False, ""), (True, "'"))),
                       *((f"E{u}", lambda p, us=us: core_stash.sdf_stash_bwd(
                           mc["aw"], x, core_stash.sdf_stash_fwd(mc["aw"], x, ncfg, pk, stash_us=us)[3], ncots, ncfg,
                           p, stash_us=us)) for us, u in ((False, ""), (True, "'")))):
        same[name] = all(torch.equal(u, v) for u, v in zip(flat(call(dict(pk, cls=core_mlp.CORE_HUGE))),
                                                            flat(call(pk))))
    log(f"[23(a)] the huge instances at phase 3's 256-wide SDF against the 64-point instances, bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"23(a): a huge instance differs from the 64-point one at the presets' widths: {same}")
    del pk
    torch.cuda.empty_cache()

    # The base: the wide instances at WIDE_SDF on the same points.
    bcfg = dataclasses.replace(ncfg, **WIDE_SDF)
    bw = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), bcfg, dev), bcfg)
    bcots = cotangents(bcfg.d_out_feat)
    for case, kw in (("d1024", HUGE_SDF), ("enc160", HUGE_ENC)):
        scfg = dataclasses.replace(ncfg, **kw)
        if core_mlp.core_class(scfg) is not core_mlp.CORE_HUGE:
            raise AssertionError(f"23(a): {kw} does not take the huge instances")
        w = core_mlp.materialize_sdf_weights_full(sdf_init(torch.Generator().manual_seed(0), scfg, dev), scfg)
        n_w, L = sum(t.numel() for t in w), scfg.n_layers
        io, dims = _layer_dims(scfg)
        hidden, d_last, d_feat = sum(i * o_ for i, o_ in io), dims[-2], scfg.d_out_feat
        cots = cotangents(d_feat)
        io_bytes = n_pts * 4 * (3 + 1 + d_feat + 3)
        fwd_flops = 2.0 * n_pts * (2 * hidden + d_last * (1 + d_feat))
        bwd_flops = {us: 2.0 * n_pts * ((4 if us else 5) * hidden + 2 * d_last * d_feat + 2 * d_last)
                     for us in (False, True)}
        timed = case == "d1024"
        label = "" if timed else f" {case}"

        def record(name, checks, fn, plain_fn, group, base_fn, base_group, bd, timed=timed, label=label):
            instance_record("23(a)", out if timed else {}, base_dev, n_pts, smi, name + label, checks, fn, plain_fn,
                            group, base_fn, base_group, bd, base="the wide instance's at d_hidden 512",
                            iters=5 if timed else 1, tries=1)

        a = core_mlp.sdf_core_fwd(w, x, scfg)
        if not all(torch.equal(u, v) for u, v in zip(a, core_mlp.sdf_core_fwd(w, x, scfg))):
            raise AssertionError(f"23(a) {case}: kernel A's huge instance differs between two runs")
        record("sdf_core_fwd_huge", [("outputs", max_err(a, core_mlp.sdf_core_plain(w, x, scfg, "bfloat16")),
                                      TOL["sdf_core_fwd"])],
               lambda: core_mlp.sdf_core_fwd(w, x, scfg), lambda: core_mlp.sdf_core_plain(w, x, scfg, "bfloat16"),
               HUGE_MODES[("sdf_core_fwd_huge_kernel", "0")], lambda: core_mlp.sdf_core_fwd(bw, x, bcfg),
               "kernel A sdf_core_fwd_wide", bound(fwd_flops, io_bytes + 2 * n_w, H100_BF16_FLOPS))
        d16 = None
        for us in (False, True):
            fn_d, fn_e = ("sdf_stash_all_fwd", "sdf_stash_all_bwd") if us else ("sdf_stash_fwd", "sdf_stash_bwd")
            width = core_stash.sdf_stash_width(scfg, us)
            d = core_stash.sdf_stash_fwd(w, x, scfg, stash_us=us)
            if not all(torch.equal(u, v) for u, v in zip(d[:3], a)):
                raise AssertionError(f"23(a) {case}: {fn_d}_huge's outputs differ from kernel A's")
            if us and not torch.equal(d[3][:, : core_stash.sdf_stash_width(scfg)], d16[3]):
                raise AssertionError(f"23(a) {case}: the stash_all variant's h_i differ from kernel D's")
            plain = core_stash.sdf_core_fwd_hs_plain(w, x, scfg, "bfloat16", "bfloat16", return_us=us)
            parts = core_stash.split_stash(d[3], core_stash.sdf_stash_columns(scfg, us))
            checks = [("outputs", max_err(d[:3], plain[:3]), TOL["sdf_stash_fwd"]),
                      ("stash", max_err(parts, [*plain[3], *plain[4], plain[5]] if us else plain[3]),
                       TOL["sdf_stash_fwd"])]
            del plain
            record(f"{fn_d}_huge", checks, lambda us=us: core_stash.sdf_stash_fwd(w, x, scfg, stash_us=us),
                   lambda us=us: core_stash.sdf_core_fwd_hs_plain(w, x, scfg, "bfloat16", "bfloat16", return_us=us),
                   HUGE_MODES[("sdf_core_fwd_huge_kernel", "3" if us else "1")],
                   lambda us=us: core_stash.sdf_stash_fwd(bw, x, bcfg, stash_us=us),
                   WIDE_MODES[("sdf_core_fwd_wide_kernel", "3" if us else "1")],
                   bound(fwd_flops, io_bytes + 2 * n_pts * width + 2 * n_w, H100_BF16_FLOPS))

            e_dws, e_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, stash_us=us)
            e2_dws, e2_dx = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, stash_us=us)
            none, dx_only = core_stash.sdf_stash_bwd(w, x, d[3], cots, scfg, need_dw=False, stash_us=us)
            if not (torch.equal(e_dx, e2_dx) and all(torch.equal(u, v) for u, v in zip(e_dws, e2_dws))):
                raise AssertionError(f"23(a) {case}: {fn_e}_huge's gradients differ between two runs")
            if none is not None or not torch.equal(dx_only, e_dx):
                raise AssertionError(f"23(a) {case}: {fn_e}_huge without its dW passes gives another dx")
            del e2_dws, e2_dx, dx_only

            def e_plain(parts=parts, us=us):
                if us:
                    return core_stash.sdf_core_bwd_stash_all_plain(w, x, parts[:L], parts[L : 2 * L], parts[2 * L],
                                                                   cots, scfg, "bfloat16")
                return core_stash.sdf_core_bwd_stash_plain(w, x, parts, cots, scfg, "bfloat16")

            p_dws, p_dx = e_plain()
            err = grad_err([e_dx, *e_dws], [p_dx, *p_dws])
            del p_dws, p_dx, e_dws, e_dx
            base_stash = core_stash.sdf_stash_fwd(bw, x, bcfg, stash_us=us)[3]
            record(f"{fn_e}_huge", [("gradients", err, TOL["sdf_stash_bwd"])],
                   lambda us=us, st=d[3]: core_stash.sdf_stash_bwd(w, x, st, cots, scfg, stash_us=us), e_plain,
                   (HUGE_MODES[("sdf_bwd_chain_huge_kernel", "false, true" if us else "false, false")], DW_GROUP),
                   lambda us=us, st=base_stash: core_stash.sdf_stash_bwd(bw, x, st, bcots, bcfg, stash_us=us),
                   (WIDE_MODES[("sdf_bwd_chain_wide_kernel", "false, true" if us else "false, false")], DW_GROUP),
                   bound(bwd_flops[us], io_bytes + 2 * n_pts * width + 6 * n_w, H100_BF16_FLOPS))
            del base_stash
            if us:
                del d16
            else:
                d16 = d
            torch.cuda.empty_cache()

        h_dws, h_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg)
        h2_dws, h2_dx = core_mlp.sdf_core_bwd(w, x, cots, scfg)
        if not (torch.equal(h_dx, h2_dx) and all(torch.equal(u, v) for u, v in zip(h_dws, h2_dws))):
            raise AssertionError(f"23(a) {case}: kernel H's huge instance differs between two runs")
        hp_dws, hp_dx = core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, "bfloat16")
        err = grad_err([h_dx, *h_dws], [hp_dx, *hp_dws])
        del h_dws, h_dx, h2_dws, h2_dx, hp_dws, hp_dx, d
        torch.cuda.empty_cache()
        record("sdf_core_bwd_huge", [("gradients", err, TOL["sdf_core_bwd"])],
               lambda: core_mlp.sdf_core_bwd(w, x, cots, scfg),
               lambda: core_mlp.sdf_core_bwd_plain(w, x, cots, scfg, "bfloat16"),
               (HUGE_MODES[("sdf_core_fwd_huge_kernel", "2")], HUGE_MODES[("sdf_bwd_chain_huge_kernel", "true, false")],
                DW_GROUP),
               lambda: core_mlp.sdf_core_bwd(bw, x, bcots, bcfg),
               (WIDE_MODES[("sdf_core_fwd_wide_kernel", "2")], WIDE_MODES[("sdf_bwd_chain_wide_kernel", "true, false")],
                DW_GROUP),
               bound(bwd_flops[False] + 2.0 * n_pts * hidden, io_bytes + 6 * n_w, H100_BF16_FLOPS))
        torch.cuda.empty_cache()
    return out


def huge_march_kernels(smi: str, dev, mc: dict) -> tuple[dict, dict]:
    """Phase 23(a), the march kernels (see above).  -> ({instance name: (max
    abs err, ms, plain ms, bound ms, bound by)} of the HUGE_SDF instances and
    of the run-time geometry ones at GEOM_JSON_AT, {instance name: launches}
    of the geometry instances' entry-point calls)."""
    import torch

    from nrhints_torch.fields.sdf import sdf_init
    from nrhints_torch.kernels import core_mlp, cuda_lib, march

    o, d, mw, ncfg = mc["o"], mc["d"], mc["mw"], mc["cfg"].model.sdf_network
    sl, sdir, sdist, sz, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "sz", "inv_s", "anneal"))
    b, bs = o.shape[0], sl.shape[0]

    # Every huge entry point at phase 3's SDF (the pack's class set to
    # ROWS_HUGE) against the narrow instance, bit for bit.
    pk = core_mlp.pack_sdf_mlp(mw, ncfg, with_feat=False)
    packs = (("", pk), ("_huge", dict(pk, cls=core_mlp.ROWS_HUGE)))
    same = {}
    for geometry, merges in ((None, ("bitonic", "rank")), (GEOM_JSON_AT, ("bitonic",))):
        rounds, n_new = geometry or march.FIXED_GEOMETRY
        n0 = 128 - rounds * n_new
        z0, z0s = geometry_inputs(mc, n0)
        rays, srays = march._ray_inputs(z0, o, d, n0), march._ray_inputs(z0s, sl, sdir, n0)
        shadow = srays + [(sdist, (bs, 1), "sdist")] + [
            (torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1), (1,), name)
            for v, name in ((inv_s, "inv_s"), (anneal, "cos_anneal"))]
        g = None if geometry is None else geometry
        for merge in merges:
            rank = int(merge == "rank")
            outs = {}
            for sfx, k in packs:
                sdf0 = march._launch_pack("march_sweep" + sfx, k, ncfg, rays, n0, geometry=None if g is None else (n0,))
                rin = [rays[0], (sdf0, (b, n0), "sdf0"), *rays[1:]]
                outs[sfx] = {
                    "K": sdf0,
                    "L": march._launch_pack("march_rounds" + sfx, k, ncfg, rin, 128, (64.0, rank), g),
                    "M": march._launch_pack("importance_march" + sfx, k, ncfg, rays, 128, (64.0, rank), g),
                    "N": march._launch_pack("shadow_march" + sfx, k, ncfg, shadow, 1, (64.0, rank), g),
                    "C": march._launch_final("shadow_final" + sfx, k, ncfg, sz, sl, sdir, sdist, inv_s, anneal),
                }
            for name in outs[""]:
                same[f"{name} {rounds} x {n_new} {merge}"] = torch.equal(outs[""][name], outs["_huge"][name])
    log(f"[23(a)] the huge march instances at phase 3's 256-wide SDF against the narrow instances, bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"23(a): a huge march instance differs from the narrow one at the presets' widths: {same}")
    del pk, packs

    # C, K, L, M and N huge at HUGE_SDF (timed beside the wide instances at
    # WIDE_SDF) and at HUGE_ENC, bf16 march weights.
    out = march_class_kernels(smi, dev, mc, HUGE_SDF, "23(a)", "the wide instance's at d_hidden 512", ("bfloat16",),
                              WIDE_SDF)
    march_class_kernels(smi, dev, mc, HUGE_ENC, "23(a) enc160", "the wide instance's at d_hidden 512",
                        ("bfloat16",), WIDE_SDF)
    torch.cuda.empty_cache()

    # The run-time geometry instances at GEOM_JSON_AT, and the entry points
    # there on the monolith and the split march.
    hcfg = dataclasses.replace(ncfg, **HUGE_SDF)
    hparams = sdf_init(torch.Generator().manual_seed(0), hcfg, dev)
    hw = march.march_weights(hparams, hcfg, "bfloat16")
    if core_mlp.core_class(hcfg, with_feat=False) is not core_mlp.ROWS_HUGE:
        raise AssertionError(f"23(a): {HUGE_SDF} does not take the march kernels' huge instances")
    geo = march_geometry_kernels(smi, dev, mc, {"huge bf16": (hw, hcfg, hparams, "bfloat16", "_huge")},
                                 (GEOM_JSON_AT,), "23(a)")
    out.update({k: v for k, v in geo.items() if k.endswith("_huge_geom")})
    rounds, n_new = GEOM_JSON_AT
    z0, z0s = geometry_inputs(mc, 128 - rounds * n_new)
    kw = dict(rounds=rounds, n_new=n_new, mlp_dtype="bfloat16")
    launches = {}
    for route, rkw in (("monolith", {}), ("split", dict(split=True))):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        z = march.fused_importance_z(hparams, hcfg, o, d, z0, **kw, **rkw)
        tau = march.fused_shadow_tau(hparams, hcfg, sl, sdir, z0s, sdist, inv_s, anneal, **kw, **rkw)
        torch.cuda.synchronize()
        got = {k: v for k, v in cuda_lib.launch_counts.items() if v}
        want = dict(route_launches(rkw, False, "_huge", rounds, n_new))
        for k, v in route_launches(rkw, True, "_huge", rounds, n_new).items():
            want[k] = want.get(k, 0) + v
        z_p = march.importance_march_plain(z0, o, d, hw, hcfg, rounds=rounds, n_new=n_new)
        tau_p = march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, hw, hcfg, rounds=rounds, n_new=n_new)
        ze, te = z_err(z, z_p, z0), max_err([tau], [tau_p])
        log(f"[23(a) {route} {rounds} x {n_new}] fused_importance_z: {ze[2]:.4f} of the samples within {Z_TOL} of a "
            f"plain sample; fused_shadow_tau rel err {te[1]:.3e}; launches {got}")
        if got != want or not (ze[3] and ze[2] >= Z_NN_SHARE and te[1] <= TOL["shadow_march"]):
            raise AssertionError(f"23(a) {route} {rounds} x {n_new}: launches {got} (expected {want}) or a march "
                                 f"disagrees with the plain march")
        for k, v in got.items():
            if k.endswith("_huge_geom"):
                launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    return out, launches


def huge_dtype_limits(label: str, dev, mc: dict) -> None:
    """Phase 23(e), the dtypes: the core's entry points at HUGE_SDF with a
    gradient wanted, at compute_dtype="float32" under each schedule and at
    stash_dtype="float32", raise NotImplementedError naming item 15 before
    any launch."""
    import torch

    from nrhints_torch.fields.sdf import sdf_init
    from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib

    scfg = dataclasses.replace(mc["cfg"].model.sdf_network, **HUGE_SDF)
    params = sdf_init(torch.Generator().manual_seed(0), scfg, dev)
    params = {k: {n: t.requires_grad_(True) for n, t in v.items()} for k, v in params.items()}
    x = mc["x"][:4096]
    calls = [(f"compute_dtype float32, {b}", lambda b=b: core_mlp.fused_sdf_value_feat_grad(
        params, scfg, x, compute_dtype="float32", backward=b)) for b in ("recompute", "stash", "stash_all")]
    calls.append(("stash_dtype float32", lambda: core_stash.fused_sdf_value_feat_grad_stash(
        params, scfg, x, stash_dtype="float32")))
    for case, fn in calls:
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        try:
            fn()
        except NotImplementedError as e:
            msg = str(e)
        else:
            raise AssertionError(f"{label}: the core ran at {case}")
        if "item 15" not in msg or any(cuda_lib.launch_counts.values()):
            raise AssertionError(f"{label}: {case}: {msg!r}, launches {dict(cuda_lib.launch_counts)}")
        log(f"[{label} limits] the core's entry point at {case} raises NotImplementedError before any launch: {msg}")


def huge_core_phase(smi: str, dev, mc: dict, tmp: Path) -> list:
    """Phase 23, the SDF above the wide class (see above).  -> the kernels
    line's entries of the HUGE_SDF instances, each with its launches from
    the path that runs it: A's and C's from (c)'s default-route view, M's
    and N's from its monolith view, D's and E's from (b)'s K = HUGE_K
    dispatch, H's from the recompute step, the variants' from the stash_all
    step, K's and L's from the split step, the run-time geometry instances'
    from (a)'s entry-point calls."""
    import numpy as np
    import torch

    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    nums = huge_kernels(smi, dev, mc)
    gc.collect()
    torch.cuda.empty_cache()
    march_nums, geom_launches = huge_march_kernels(smi, dev, mc)
    nums.update(march_nums)
    gc.collect()
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    # (b) The train path, on the default routes.
    td = train_data(dev, 128, 128)
    hcfg = huge_cfg(td["cfg"])
    batches = [td["next_batch"]() for _ in range(HUGE_K + TRAIN_WARMUP)]
    b64 = td["next_batch"](64)
    sc = scan_phase(smi, dev, td, batches, "23(b) huge graph", hcfg, HUGE_K, HUGE_STEP)
    state, buffers = fresh_state(hcfg, td["n_views"], dev)
    step_fn = make_train_step(hcfg, td["camera"], buffers, state.optimizer)
    state, _ = step_fn(state, batches[0], torch.Generator(device=dev).manual_seed(0))
    urng = np.random.default_rng(7)
    u64 = {"strat": urng.random((64, 1), dtype=np.float32),
           "shadow": urng.random((64, hcfg.model.renderer.n_shadow_samples), dtype=np.float32)}
    card_cpu_grads("23(b) huge train path", hcfg, state, td["camera"], buffers, b64, u64, relu_by_norm=True)
    del state, step_fn, buffers
    rec = wide_one_step("23(b) huge recompute step", smi, dev, with_renderer(hcfg, core_backward="recompute"), td,
                        batches[1], dict(sdf_core_fwd_huge=1, sdf_core_bwd_huge=1, mlp_fwd=1, mlp_bwd=1, **HUGE_SHIP),
                        profiled=True)
    sa = wide_one_step("23(b) huge stash_all step", smi, dev, with_renderer(hcfg, core_backward="stash_all"), td,
                       batches[2], dict(sdf_stash_all_fwd_huge=1, sdf_stash_all_bwd_huge=1, mlp_stash_fwd=1,
                                        mlp_stash_bwd=1, **HUGE_SHIP), profiled=True)
    routes = {name: wide_one_step(f"23(b) huge {name} step", smi, dev, with_renderer(hcfg, **kw), td, batches[3],
                                  dict(HUGE_CORE_STEP, **per), profiled=name == "monolith")
              for name, (kw, per) in HUGE_ROUTES.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The eval path: 128x128 views of nr-hints at HUGE_SDF on the
    # default route and on the round-4 monolith.
    vcfg = huge_cfg(mc["cfg"])
    params = {"renderer": init_model_params(vcfg.model, torch.Generator().manual_seed(0), device=dev), "raygen": {}}
    view = wide_view("23(c) huge view", smi, mc, vcfg, params, dict(sdf_core_fwd_huge=1, **HUGE_SHIP))
    mono_view = wide_view("23(c) huge monolith view", smi, mc, huge_cfg(mc["cfg"], **MONOLITH), params,
                          dict(sdf_core_fwd_huge=1, importance_march_huge=1, shadow_march_huge=1))
    del params

    # (d) The entry point on the default routes; (e) the limits.
    wide_entry(smi, tmp, "23(d)", ["--config.model.sdf-network.d-hidden", str(HUGE_SDF["d_hidden"])], HUGE_STEP)
    wide_limits("23(e)", dev, td, batches[0], (("d_hidden 1024 at march_dtype float32",
                                                huge_cfg(td["cfg"], march_dtype="float32")),), "march kernels")
    huge_dtype_limits("23(e)", dev, mc)
    log(f"[23] phase 23 took {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f} s)")
    got = dict(sdf_core_fwd_huge=view["sdf_core_fwd_huge"],
               sdf_stash_fwd_huge=sc["launches"]["sdf_stash_fwd_huge"],
               sdf_stash_bwd_huge=sc["launches"]["sdf_stash_bwd_huge"],
               sdf_core_bwd_huge=rec["sdf_core_bwd_huge"],
               sdf_stash_all_fwd_huge=sa["sdf_stash_all_fwd_huge"],
               sdf_stash_all_bwd_huge=sa["sdf_stash_all_bwd_huge"],
               shadow_final_huge=view["shadow_final_huge"],
               importance_march_huge=mono_view["importance_march_huge"],
               shadow_march_huge=mono_view["shadow_march_huge"],
               march_sweep_huge=routes["split"]["march_sweep_huge"],
               march_rounds_huge=routes["split"]["march_rounds_huge"],
               **geom_launches)
    return [entry(name, *HUGE_WHERE[name], got[name], *num) for name, num in nums.items()]


# Phase 15: sample-axis sharding.  (a) two gloo ranks on this card as a 1 x 2
# ('data', 'sample') grid (LOCAL_WORLD_SIZE=1, so both take cuda:0: NCCL
# refuses two ranks on one card), SAMPLE_EAGER_STEPS eager steps under the
# shipping march (the fused kernels flatten-sharded: each rank marches half
# the rays, then the group all-gathers them) and under fused_kernels="off"
# (the sample-sharded plain march); (b) four NCCL ranks as a 2 x 2 grid, one
# card each, where four are visible: a SAMPLE_K-step graph holding the
# all-gathers against its eager steps.  A rank's gradients are held to the
# world-1 gradients at the same params at DP_GRAD_TOL, as phase 11's.
SAMPLE_EAGER_STEPS, SAMPLE_K = 3, 16
SAMPLE_CFGS = {"shipping": {}, "off": {"fused_kernels": "off"}}


def grid_marches(cfg, mesh, params, buffers, camera, batch) -> dict:
    """The importance and shadow marches of ``batch``'s rays under ``cfg``
    on ``mesh`` and with no mesh -> {march: (on the grid, alone)}."""
    import torch

    from nrhints_torch.camera.rays import generate_rays
    from nrhints_torch.core.sampling import stratified_z_vals
    from nrhints_torch.render import renderer as tr

    with torch.no_grad():
        rays = generate_rays(params["raygen"], buffers, camera, cfg.ray_generator, batch)
        o, d = rays.origins.detach(), rays.directions.detach()
        z0 = stratified_z_vals(rays.nears, rays.fars, cfg.model.renderer.n_samples)
        hits = o + d * 0.5 * (rays.nears + rays.fars)
        return {"z": tuple(tr._importance_sample_z(params["renderer"], cfg.model, o, d, z0, m) for m in (mesh, None)),
                "tau": tuple(tr._shadow_transmittance(params["renderer"], cfg.model, rays.pl_positions, hits, 1.0,
                                                      None, m) for m in (mesh, None))}


def grid_rank(rank: int, world: int, backend: str, start_file: str, out_dir: str) -> None:
    """A rank of phase 15: the start state of ``start_file`` on this rank's
    card (gloo: both ranks on cuda:0, two hosts of one rank; NCCL: one card
    a rank) as rank ``rank`` of a (world / 2) x 2 grid, its rows of the
    global batches (its data index's).  gloo: under each of SAMPLE_CFGS the
    marches of the first batch on the grid and alone, then
    SAMPLE_EAGER_STEPS eager steps (each step's gradients and the params
    after it kept).  NCCL: SAMPLE_K eager steps, then the same steps as one
    CUDA graph from the same start (the first call and two replays, the
    last timed), the params and Adam's state after each, and a first eager
    step's gradients."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    if backend == "gloo":  # two "hosts" of one rank each, both on cuda:0
        os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = "1", "0"
    from nrhints_torch.parallel.mesh import initialize_multihost, make_mesh, rank_rows
    from nrhints_torch.train.step import (
        init_train_state, make_optimizer, make_train_step, make_train_step_scan, stack_bundles,
    )
    from nrhints_torch.utils import resolve_device, tree_items

    out = Path(out_dir)
    initialize_multihost(f"file://{out / 'rendezvous'}", rank, world, device=resolve_device("cuda"), backend=backend)
    mesh = make_mesh(sample_axis_size=2, device="cuda")
    blob = torch.load(start_file, map_location=mesh.device, weights_only=False)
    cam, buffers = blob["camera"], blob["buffers"]
    rows = [b[rank_rows(mesh, b.h_indices.shape[0] // mesh.data_size)] for b in blob["batches"]]
    res = {"mesh": (mesh.rank, mesh.world_size, mesh.data_index, mesh.sample_index, mesh.backend, str(mesh.device))}

    def gens(n):
        return [torch.Generator(device=mesh.device).manual_seed(2000 + i) for i in range(n)]

    for name, kw in (SAMPLE_CFGS if backend == "gloo" else {"shipping": SAMPLE_CFGS["shipping"]}).items():
        cfg = with_renderer(blob["cfg"], **kw)
        params = tree_to(blob["params"], mesh.device)
        state = init_train_state(params, make_optimizer(cfg, params))
        live = [(g["base_lr"], g["lr"]) for g in state.optimizer.param_groups]
        state.optimizer.load_state_dict(blob["optimizer"])
        for g, (base, lr) in zip(state.optimizer.param_groups, live):
            g["base_lr"], g["lr"] = base, lr
        state.step = blob["step"]
        start = train_snapshot(state)
        step_fn = make_train_step(cfg, cam, buffers, state.optimizer, mesh=mesh)
        if backend == "gloo":
            r = res[name] = {"marches": grid_marches(cfg, mesh, state.params, buffers, cam, rows[0]),
                             "grads": [], "params": [], "secs": []}
            for b, g in zip(rows[:SAMPLE_EAGER_STEPS], gens(SAMPLE_EAGER_STEPS)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step_fn(state, b, g)
                torch.cuda.synchronize()
                r["secs"].append(time.perf_counter() - t0)
                r["grads"].append(dp_grads(state))
                r["params"].append({n: t.detach().cpu().clone() for n, t in tree_items(state.params)})
            r["marches"] = {k: tuple(t.cpu() for t in v) for k, v in r["marches"].items()}
            continue
        state, _ = step_fn(state, rows[0], gens(1)[0])
        res["first_grads"] = dp_grads(state)
        train_restore(state, start)
        for b, g in zip(rows[:SAMPLE_K], gens(SAMPLE_K)):
            state, m_eager = step_fn(state, b, g)
        eager = train_snapshot(state)
        scan = make_train_step_scan(cfg, cam, buffers, state.optimizer, n_steps=SAMPLE_K, mesh=mesh)
        stacked, secs, errs = stack_bundles(rows[:SAMPLE_K]), [], []
        for _ in range(3):  # the first call (eager, then the capture), then two replays
            train_restore(state, start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m_graph = scan(state, stacked, gens(SAMPLE_K))
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / SAMPLE_K)
            errs.append(max(snapshot_err(train_snapshot(state), eager), snapshot_err(m_graph, m_eager)))
        res.update(secs=secs, graph_errs=errs, loss=float(m_graph["loss"]),
                   params={n: t.detach().cpu().clone() for n, t in tree_items(state.params)})
        scan = None  # its graph goes before the group: NCCL keeps a communicator a live graph uses
    torch.save(res, out / f"rank{rank}.pt")
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()


def sample_axis_phase(smi: str, dev, td: dict, batches: list, tmp: Path) -> None:
    """Phase 15, sample-axis sharding (``parallel.sample_axis_size``): (a)
    two gloo ranks on this card as a 1 x 2 grid: under the shipping march
    the marches of a 512-ray batch flatten-sharded over the two ranks equal
    the marches with no grid bit for bit, and SAMPLE_EAGER_STEPS eager steps'
    gradients equal the world-1 gradients at the same params within
    DP_GRAD_TOL; under fused_kernels="off" the sample-sharded marches and
    the steps the same way, the marches held by phase 3's order-free share
    and tau within CPU_TOL's shadow bound; the two ranks bit for bit
    throughout.  (b) where four cards are visible, four NCCL ranks as a 2 x 2
    grid: a SAMPLE_K-step graph against its eager steps bit for bit on every
    rank, the ranks bit for bit, a first step's gradients against the
    world-1 gradients within DP_GRAD_TOL."""
    import torch

    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, loss_and_grads, make_optimizer, make_train_step
    from nrhints_torch.utils import tree_items

    t_phase = time.perf_counter()
    tcfg, tcam, n_views = td["cfg"], td["camera"], td["n_views"]
    gen = torch.Generator().manual_seed(0)
    params = {"renderer": init_model_params(tcfg.model, gen, device=dev)}
    params["raygen"], buffers = ray_generator_init(gen, tcfg.ray_generator, n_views, device=dev)
    state = init_train_state(params, make_optimizer(tcfg, params))
    plain = make_train_step(tcfg, tcam, buffers, state.optimizer)
    warm = torch.Generator(device=dev).manual_seed(0)
    for b in batches[-TRAIN_WARMUP:]:
        state, _ = plain(state, b, warm)
    state.step = 1000
    start = train_snapshot(state)
    n_run = SAMPLE_K if torch.cuda.device_count() >= 4 else SAMPLE_EAGER_STEPS
    run = batches[:n_run]
    start_file = tmp / "grid_start.pt"
    torch.save({"cfg": tcfg, "camera": tcam, "buffers": tree_to(buffers, "cpu"), "params": tree_to(state.params, "cpu"),
                "optimizer": state.optimizer.state_dict(), "step": state.step,
                "batches": [b.to("cpu") for b in run]}, start_file)

    def gens(n):
        return [torch.Generator(device=dev).manual_seed(2000 + i) for i in range(n)]

    def world1_grads(cfg, before: dict, i: int) -> dict:
        """The group-less step's gradients at the params ``before`` step i."""
        with torch.no_grad():
            for n, t in tree_items(state.params):
                t.copy_(before[n])
        state.step = start["step"] + i
        loss_and_grads(state, cfg, tcam, buffers, run[i], gens(i + 1)[i])
        return dp_grads(state)

    # (a) Two gloo ranks on this card.
    out_a = tmp / "grid_15a"
    out_a.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(grid_rank, 2, 2, "gloo", str(start_file), str(out_a))
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_a / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for name, kw in SAMPLE_CFGS.items():
        cfg = with_renderer(tcfg, **kw)
        a, b_ = ranks[0][name], ranks[1][name]
        for what in ("grads", "params"):
            for i in range(SAMPLE_EAGER_STEPS):
                if any(not torch.equal(a[what][i][n], b_[what][i][n]) for n in a[what][i]):
                    raise AssertionError(f"15(a) {name} step {i}: the two ranks' {what} differ")
        (z_g, z_1), (t_g, t_1) = a["marches"]["z"], a["marches"]["tau"]
        z_equal, t_equal = torch.equal(z_g, z_1), torch.equal(t_g, t_1)
        _, slots, share, ok = z_err(z_g, z_1, z_g[:, :0])
        t_abs = (t_g - t_1).abs().max().item()
        g_errs = [scaled_err(a["grads"][i], world1_grads(cfg, a["params"][i - 1] if i else start, i))
                  for i in range(SAMPLE_EAGER_STEPS)]
        log(f"[sample-axis 15(a) {name}] two gloo ranks on one card as a 1 x 2 grid ({ranks[0]['mesh']}, "
            f"{ranks[1]['mesh']}), a {tcfg.model.batch_size}-ray batch: the grid's marches against the same marches "
            f"with no grid: z equal bit for bit {z_equal} (order-free share {share:.4f}, slot by slot {slots:.4f}), "
            f"tau equal bit for bit {t_equal} (max abs err {t_abs:.3e}); {SAMPLE_EAGER_STEPS} eager steps, the ranks' "
            f"gradients and params equal bit for bit; each step's gradients against the world-1 gradients at the "
            f"same params, worst leaf a step (of its scale, tol {DP_GRAD_TOL}): "
            + ", ".join(f"{e:.3e} {n}" for e, n in g_errs)
            + f"; s/step after the first, rank 0 {sum(a['secs'][1:]) / (SAMPLE_EAGER_STEPS - 1):.5f}, rank 1 "
            f"{sum(b_['secs'][1:]) / (SAMPLE_EAGER_STEPS - 1):.5f}; on {smi}")
        if name == "shipping" and not (z_equal and t_equal):
            raise AssertionError("15(a): the flatten-sharded fused marches differ from the marches with no grid")
        if not (ok and share >= Z_NN_SHARE and t_abs <= CPU_TOL["shadow_map"]):
            raise AssertionError(f"15(a) {name}: the grid's marches differ from the marches with no grid")
        if not max(g_errs)[0] <= DP_GRAD_TOL:
            raise AssertionError(f"15(a) {name}: the grid's gradients differ from the world-1 steps': {max(g_errs)}")
    log(f"[sample-axis 15(a)] both ranks' processes {wall:.1f} s")

    # (b) Four NCCL ranks, one card each, the captured dispatch.
    if torch.cuda.device_count() < 4:
        log(f"[sample-axis 15(b)] not run: {torch.cuda.device_count()} card(s) visible, a 2 x 2 grid of NCCL ranks "
            f"needs four")
    else:
        out_b = tmp / "grid_15b"
        out_b.mkdir()
        t0 = time.perf_counter()
        spawn_ranks(grid_rank, 4, 4, "nccl", str(start_file), str(out_b))
        wall = time.perf_counter() - t0
        ranks = [torch.load(out_b / f"rank{r}.pt", weights_only=False) for r in range(4)]
        for r in ranks[1:]:
            for what in ("first_grads", "params"):
                if any(not torch.equal(ranks[0][what][n], r[what][n]) for n in r[what]):
                    raise AssertionError(f"15(b): rank {r['mesh']}'s {what} differ from rank 0's")
        worst = max(e for r in ranks for e in r["graph_errs"])
        g_err = scaled_err(ranks[0]["first_grads"], world1_grads(tcfg, start, 0))
        s_b = ranks[0]["secs"][2]
        log(f"[sample-axis 15(b)] four NCCL ranks as a 2 x 2 grid ({', '.join(str(r['mesh']) for r in ranks)}), a "
            f"{SAMPLE_K}-step CUDA graph with the marches' all-gathers and the data group's all-reduces: against its "
            f"eager steps on every rank, worst {worst[1] or 'none'} {worst[0]:.3e}; the ranks bit for bit; a first "
            f"step's gradients against the world-1 gradients, worst leaf {g_err[1]}: {g_err[0]:.3e} of its scale (tol "
            f"{DP_GRAD_TOL}); graph replay {s_b:.5f} s/step, {tcfg.model.batch_size / s_b:.1f} global rays/s (the "
            f"first call {ranks[0]['secs'][0]:.5f}); loss {ranks[0]['loss']:.6f}; the ranks' processes {wall:.1f} s; "
            f"on {smi}")
        if worst[0] != 0.0:
            raise AssertionError(f"15(b): the graph's steps differ from the eager steps: {worst}")
        if not g_err[0] <= DP_GRAD_TOL:
            raise AssertionError(f"15(b): the grid's gradients differ from the world-1 gradients: {g_err}")
    log(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card", file=sys.stderr)
        return 1
    if not (REPO / "nrhints_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no nrhints_torch package next to {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from nrhints_torch.camera.rays import ray_generator_init
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.fields.sdf import _layer_dims
    from nrhints_torch.kernels import core_mlp, core_stash, cuda_lib, march
    from nrhints_torch.render.renderer import init_model_params
    from nrhints_torch.train.step import init_train_state, loss_and_grads, make_optimizer, make_train_step
    from nrhints_torch.utils import resolve_device, tree_items

    # 1. Device.
    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. Build: one nvcc a source, all at once.
    t0 = time.perf_counter()
    log_build(cuda_lib.build(), t0)

    if sys.argv[1:] == ["--data-parallel"]:  # phase 11 (a)-(c) alone, after the build
        import tempfile

        td = train_data(dev, 128, 128)
        with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
            data_parallel_phase(smi, dev, td, [td["next_batch"]() for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)],
                                Path(tmp), None)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--offpath"]:  # phase 12 alone, after the build
        offpath_phase(smi, dev, march_chunk(dev), train_data(dev, 128, 128))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--stash-all"]:  # phase 13 alone, after the build
        import tempfile

        with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
            sa = stash_all_phase(smi, dev, march_chunk(dev), train_data(dev, 128, 128), Path(tmp))
        print(json.dumps({"kernels": stash_all_entries(sa)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--march-f32"]:  # phase 14 alone, after the build
        f32 = march_f32_phase(smi, dev, march_chunk(dev), train_data(dev, 128, 128))
        print(json.dumps({"kernels": f32["entries"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--core-f32"]:  # phase 16 alone, after the build
        entries = core_f32_phase(smi, dev, march_chunk(dev))
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--trunk-f32"]:  # phase 17 alone, after the build
        entries = trunk_f32_phase(smi, dev, march_chunk(dev))
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--march-geometry"]:  # phase 20 alone, after the build
        entries = march_geometry_phase(smi, dev, march_chunk(dev))
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    # Phases 18, 19, 21, 22 and 23, alone or together (in the order given),
    # after the build; the plain run runs 18 with 19, and 21 with 22 and 23,
    # so, each set in a process of its own.
    late_phases = {"--wide-sdf": wide_sdf_phase, "--wide-trunk": wide_trunk_phase,
                   "--wide-core-f32": lambda smi_, dev_, mc_, tmp_: core_f32_phase(smi_, dev_, mc_, wide=True),
                   "--deep": lambda smi_, dev_, mc_, tmp_: deep_phase(smi_, dev_, mc_),
                   "--huge-core": huge_core_phase}
    if sys.argv[1:] and all(a in late_phases for a in sys.argv[1:]):
        import tempfile

        mc = march_chunk(dev)
        entries = []
        for a in sys.argv[1:]:
            with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
                entries += late_phases[a](smi, dev, mc, Path(tmp))
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:] == ["--sample-axis"]:  # phase 15 alone, after the build
        import tempfile

        td = train_data(dev, 128, 128)
        with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
            sample_axis_phase(smi, dev, td, [td["next_batch"]() for _ in range(max(SAMPLE_K, TRAIN_WARMUP))],
                              Path(tmp))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return 0

    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; flags: --data-parallel, --offpath, --stash-all, "
              f"--march-f32, --sample-axis, --core-f32, --trunk-f32, --wide-sdf, --wide-trunk, --march-geometry, "
              f"--wide-core-f32, --deep, --huge-core (these three also together)",
              file=sys.stderr)
        return 2

    # 3. Kernels at the main path's shapes: one 512-ray chunk of the view.
    mc = march_chunk(dev)
    cfg, camera, pose, pl, renderer_params = (mc[k] for k in ("cfg", "camera", "pose", "pl", "renderer_params"))
    o, d, mw, z0, steps = (mc[k] for k in ("o", "d", "mw", "z0", "steps"))
    mcfg, scfg = cfg.model, cfg.model.sdf_network
    H, W = camera.H, camera.W
    params = {"renderer": renderer_params, "raygen": {}}

    def b_last_is_two_steps(args, merge="bitonic") -> bool:
        """B's last-round step against its draw step followed by the plain
        merge of those draws with a zero sdf, bit for bit."""
        k_last = march.round_machinery(*args, merge=merge, last=True)
        nz, z_, sdf_ = march.round_machinery(*args, merge=merge)
        tail = march.round_machinery_plain(z_, sdf_, o, d, nz, torch.zeros_like(nz), args[7], None, None, merge=merge)
        return k_last[0] is None and k_last[2] is None and torch.equal(k_last[1], tail[1])

    b_abs = b_rel = b_ms = b_plain_ms = b_bound = 0.0
    for args, last in steps:
        k_out = march.round_machinery(*args, last=last)
        p_out = march.round_machinery_plain(*args, last=last)
        if last and not b_last_is_two_steps(args):
            raise AssertionError("kernel B's last step differs from its draw step and the plain merge of its draws")
        if not last and not (torch.equal(k_out[1], p_out[1]) and torch.equal(k_out[2], p_out[2])):
            raise AssertionError(f"kernel B merge differs from the plain merge at step {args[6:8]}")
        a, r = max_err(k_out, p_out)
        b_abs, b_rel = max(b_abs, a), max(b_rel, r)
        b_ms += cuda_ms(lambda: march.round_machinery(*args, last=last), 200) / len(steps)
        b_plain_ms += cuda_ms(lambda: march.round_machinery_plain(*args, last=last), 20) / len(steps)
        # Bytes a ray: z and sdf in, o and d, the previous draws (z, sdf)
        # where it merges, z out, and the draws and sdf out but in the last.
        per_ray = 4 * (2 * 128 + 6 + (32 if args[6] is not None else 0) + 128 + (0 if last else 16 + 128))
        b_bound += bound(512 * 128 * 64, 512 * per_ray, H100_F32_FLOPS)[0] / len(steps)
    b_dev = profiled_groups(lambda: [march.round_machinery(*a, last=la) for a, la in steps]).get(
        "kernel B round_machinery", 0.0) / len(steps)
    log(f"[kernel B] round_machinery: the {len(steps)} steps of a march (the last merges its draws in: equal to its "
        f"draw step and the plain merge of its draws), max abs err {b_abs:.3e} (rel {b_rel:.3e}), {b_ms:.4f} ms/launch, "
        f"plain {b_plain_ms:.4f} ms, bound {b_bound:.5f} ms; one profiled call of the {len(steps)} steps, device time "
        f"{b_dev:.4f} ms a launch")
    if not b_rel <= TOL["round_machinery"]:
        raise AssertionError(f"kernel B disagrees with its plain version: rel {b_rel:.3e}")

    # A: the SDF core on the chunk's 128 section midpoints per ray.
    x, aw, k_out = mc["x"], mc["aw"], mc["k_out"]
    p_out = core_mlp.sdf_core_plain(aw, x, scfg, "bfloat16")
    a_abs, a_rel = max_err(k_out, p_out)
    for name, k, p in zip(("sdf", "feat", "grad"), k_out, p_out):
        log(f"[kernel A] {name}: max abs err {(k - p).abs().max().item():.3e}, max |plain| {p.abs().max().item():.3e}")
    a_ms = cuda_ms(lambda: core_mlp.sdf_core_fwd(aw, x, scfg), 10)
    a_plain_ms = cuda_ms(lambda: core_mlp.sdf_core_plain(aw, x, scfg, "bfloat16"), 3, warmup=1)
    io, dims = _layer_dims(scfg)
    hidden = sum(i * o_ for i, o_ in io)
    a_flops = 2.0 * x.shape[0] * (2 * hidden + dims[-2] * (1 + scfg.d_out_feat))
    a_bytes = x.shape[0] * 4 * (3 + 1 + scfg.d_out_feat + 3) + 2 * (hidden + dims[-2] * (1 + scfg.d_out_feat))
    a_bound, a_by = bound(a_flops, a_bytes, H100_BF16_FLOPS)
    log(f"[kernel A] sdf_core_fwd: N={x.shape[0]}, rel err {a_rel:.3e}, {a_ms:.4f} ms, plain {a_plain_ms:.4f} ms, "
        f"bound {a_bound:.4f} ms ({a_by}, {a_flops / 1e9:.1f} GFLOP)")
    if not a_rel <= TOL["sdf_core_fwd"]:
        raise AssertionError(f"kernel A disagrees with its plain version: rel {a_rel:.3e}")
    # A by device time from one profiled call (the CUDA events above include
    # the wrapper's weight packing), beside its bound and beside the byte
    # floor of its design: its inputs and outputs, and the f32 gate scratch
    # [padded N, gates_total] written in the forward and read back once.
    gt = sum(-(-o_ // 16) * 16 for _, o_ in io)
    gate_bytes = 2.0 * 4 * core_mlp.gate_layout(x.shape[0], gt)[2]
    a_dev = profiled_groups(lambda: core_mlp.sdf_core_fwd(aw, x, scfg)).get("kernel A sdf_core_fwd", 0.0)
    log(f"[kernel A] one profiled call, device time {a_dev:.4f} ms; bound {a_bound:.4f} ms ({a_by}); this design's "
        f"byte floor {(a_bytes + gate_bytes) / H100_BYTES_PER_S * 1e3:.4f} ms (the {gate_bytes / 1e9:.3f} GB of the "
        f"gate scratch written and read once with the inputs and outputs)")

    # C: the shadow march's final sweep, from the light to the chunk's hits.
    sl, sdir, sdist, z0s, sz, inv_s, anneal = (mc[k] for k in ("sl", "sdir", "sdist", "z0s", "sz", "inv_s", "anneal"))
    k_tau = march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, scfg)
    p_tau = march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, mw, scfg)
    c_abs, c_rel = max_err([k_tau], [p_tau])
    c_ms = cuda_ms(lambda: march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, scfg), 10)
    c_plain_ms = cuda_ms(lambda: march.shadow_final_plain(sz, sl, sdir, sdist, inv_s, anneal, mw, scfg), 3, warmup=1)
    c_flops = 2.0 * 512 * 128 * (2 * hidden + 2 * dims[-2])
    c_bytes = 512 * 4 * (128 + 3 + 3 + 1 + 1) + 2 * (hidden + dims[-2])
    c_bound, c_by = bound(c_flops, c_bytes, H100_BF16_FLOPS)
    log(f"[kernel C] shadow_final: B=512, max abs err {c_abs:.3e} (rel {c_rel:.3e}), tau range [{p_tau.min().item():.4f}, "
        f"{p_tau.max().item():.4f}], {c_ms:.4f} ms, plain {c_plain_ms:.4f} ms, bound {c_bound:.4f} ms ({c_by})")
    if not c_rel <= TOL["shadow_final"]:
        raise AssertionError(f"kernel C disagrees with its plain version: rel {c_rel:.3e}")
    # C (and N below) by device time from one profiled call: below ~1 ms the
    # CUDA events above carry the wrapper's weight packing.
    c_dev = profiled_groups(lambda: march.shadow_final(sz, sl, sdir, sdist, inv_s, anneal, mw, scfg)).get(
        "kernel C shadow_final", 0.0)
    log(f"[kernel C] one profiled call, device time {c_dev:.4f} ms; bound {c_bound:.4f} ms ({c_by}), "
        f"{c_flops / 1e9:.1f} GFLOP at {c_flops / max(c_dev, 1e-9) / 1e9:.1f} TFLOP/s")

    # B under the rank merge, on the four steps above: the merged z equal to
    # the bitonic network's, everything equal to the plain rank merge's but
    # the draws (as B); the last step as B's.
    br_abs = br_ms = 0.0
    for args, last in steps:
        kr, kb = march.round_machinery(*args, merge="rank"), march.round_machinery(*args)
        pr = march.round_machinery_plain(*args, merge="rank")
        if not (torch.equal(kr[1], kb[1]) and torch.equal(kr[1], pr[1]) and torch.equal(kr[2], pr[2])):
            raise AssertionError(f"kernel B's rank merge differs from the bitonic or the plain merge at {args[6:8]}")
        if last and not b_last_is_two_steps(args, "rank"):
            raise AssertionError("kernel B's last step under the rank merge differs from its draw step and merge")
        kr = march.round_machinery(*args, merge="rank", last=last)
        a, r = max_err(kr, march.round_machinery_plain(*args, merge="rank", last=last))
        if not r <= TOL["round_machinery"]:
            raise AssertionError(f"kernel B (rank) disagrees with its plain version: rel {r:.3e}")
        br_abs = max(br_abs, a)
        br_ms += cuda_ms(lambda: march.round_machinery(*args, merge="rank", last=last), 200) / len(steps)
    log(f"[kernel B rank] round_machinery, merge='rank': merged z equal to the bitonic merge's on all {len(steps)} "
        f"steps, max abs err {br_abs:.3e} against the plain rank merge, {br_ms:.4f} ms/launch (bitonic {b_ms:.4f} ms)")

    # K, L, M and N: the round-4 marches on the same chunk, K, L and M on
    # its camera rays' z0, N on the shadow rays' above.  Bounds: a value
    # sweep is hidden + d_last multiply-adds per point, the dual sweep twice
    # that; the bytes are the inputs and outputs once and the bf16 weights.
    value_macs, w_bytes = hidden + dims[-2], 2 * (hidden + dims[-2])
    k_sdf0 = march.march_sweep(z0, o, d, mw, scfg)
    k_abs, k_rel = max_err([k_sdf0], [march.march_sweep_plain(z0, o, d, mw, scfg)])
    k_ms = cuda_ms(lambda: march.march_sweep(z0, o, d, mw, scfg), 10)
    k_plain_ms = cuda_ms(lambda: march.march_sweep_plain(z0, o, d, mw, scfg), 3, warmup=1)
    k_bound, k_by = bound(2.0 * 512 * 64 * value_macs, 512 * 4 * (64 + 3 + 3 + 64) + w_bytes, H100_BF16_FLOPS)
    log(f"[kernel K] march_sweep: B=512 x 64, max abs err {k_abs:.3e} (rel {k_rel:.3e}), {k_ms:.4f} ms, plain "
        f"{k_plain_ms:.4f} ms, bound {k_bound:.4f} ms ({k_by})")
    if not k_rel <= TOL["march_sweep"]:
        raise AssertionError(f"kernel K disagrees with its plain version: rel {k_rel:.3e}")

    l_z = march.march_rounds(z0, k_sdf0, o, d, mw, scfg)
    l_is_bk = torch.equal(l_z, march._rounds(mw, scfg, o, d, z0, k_sdf0, 4, 16, 64.0, "bitonic", march.round_machinery,
                                             sweep16(o, d, mw, scfg)))
    l_abs, l_slots, l_share, l_sorted = z_err(l_z, march.march_rounds_plain(z0, k_sdf0, o, d, mw, scfg), z0)
    l_ms = cuda_ms(lambda: march.march_rounds(z0, k_sdf0, o, d, mw, scfg), 10)
    l_plain_ms = cuda_ms(lambda: march.march_rounds_plain(z0, k_sdf0, o, d, mw, scfg), 3, warmup=1)
    l_bound, l_by = bound(2.0 * 512 * 48 * value_macs, 512 * 4 * (64 + 64 + 3 + 3 + 128) + w_bytes, H100_BF16_FLOPS)
    m_z = march.importance_march(z0, o, d, mw, scfg)
    m_plain = march.importance_march_plain(z0, o, d, mw, scfg)
    m_abs, m_slots, m_share, m_sorted = z_err(m_z, m_plain, z0)
    _, pp_slots, pp_share, _ = z_err(m_plain, march.importance_march_plain(
        *(t.cpu() for t in (z0, o, d)), [w.cpu() for w in mw], scfg).to(dev), z0)
    m_ms = cuda_ms(lambda: march.importance_march(z0, o, d, mw, scfg), 10)
    m_plain_ms = cuda_ms(lambda: march.importance_march_plain(z0, o, d, mw, scfg), 3, warmup=1)
    m_bound, m_by = bound(2.0 * 512 * 112 * value_macs, 512 * 4 * (64 + 3 + 3 + 128) + w_bytes, H100_BF16_FLOPS)
    m_is_lk = torch.equal(m_z, l_z)
    for name, slots, share, srt, abs_e, ms, pms, bd, by in (
            ("L march_rounds", l_slots, l_share, l_sorted, l_abs, l_ms, l_plain_ms, l_bound, l_by),
            ("M importance_march", m_slots, m_share, m_sorted, m_abs, m_ms, m_plain_ms, m_bound, m_by)):
        log(f"[kernel {name}] B=512: z sorted with every stratified sample kept: {srt}; {share:.4f} of the samples "
            f"within {Z_TOL} of a plain sample (tol {Z_NN_SHARE}), slot by slot {slots:.4f} (max abs err "
            f"{abs_e:.3e}); {ms:.4f} ms, plain {pms:.4f} ms, bound {bd:.4f} ms ({by})")
        if not (srt and share >= Z_NN_SHARE):
            raise AssertionError(f"kernel {name} disagrees with its plain version: sorted {srt}, share {share:.4f}")
    log(f"[kernel M] the plain march on the card against the plain march on the CPU: {pp_share:.4f} of the samples "
        f"within {Z_TOL} of a sample of the other, slot by slot {pp_slots:.4f}")
    log(f"[kernel L] z equals kernel B's steps between kernel K's sweeps bit for bit: {l_is_bk}; [kernel M] z "
        f"equals L(K(.)) bit for bit: {m_is_lk}")
    if not (l_is_bk and m_is_lk):
        raise AssertionError(f"kernel L or M differs from its composition: L = B/K steps {l_is_bk}, M = L(K) {m_is_lk}")
    # K, L and M (and N below) by device time from one profiled call each.
    k_dev = profiled_groups(lambda: march.march_sweep(z0, o, d, mw, scfg)).get("kernel K march_sweep", 0.0)
    l_dev = profiled_groups(lambda: march.march_rounds(z0, k_sdf0, o, d, mw, scfg)).get("kernel L march_rounds", 0.0)
    m_dev = profiled_groups(lambda: march.importance_march(z0, o, d, mw, scfg)).get("kernel M importance_march", 0.0)
    for name, dev_ms, bd, by in (("K march_sweep", k_dev, k_bound, k_by), ("L march_rounds", l_dev, l_bound, l_by),
                                 ("M importance_march", m_dev, m_bound, m_by)):
        log(f"[kernel {name}] one profiled call, device time {dev_ms:.4f} ms; bound {bd:.4f} ms ({by})")

    n_tau = march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg)
    n_abs, n_rel = max_err([n_tau], [march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg)])
    n_is_cm = torch.equal(n_tau, march.shadow_final(march.importance_march(z0s, sl, sdir, mw, scfg), sl, sdir, sdist,
                                                    inv_s, anneal, mw, scfg))
    n_ms = cuda_ms(lambda: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg), 10)
    n_plain_ms = cuda_ms(lambda: march.shadow_march_plain(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg), 3, warmup=1)
    n_bound, n_by = bound(2.0 * 512 * (112 * value_macs + 128 * 2 * value_macs), 512 * 4 * (64 + 3 + 3 + 1 + 1) + w_bytes,
                          H100_BF16_FLOPS)
    log(f"[kernel N] shadow_march: B=512, max abs err {n_abs:.3e} (rel {n_rel:.3e}), tau equals C(M(.)) bit for bit: "
        f"{n_is_cm}; {n_ms:.4f} ms, plain {n_plain_ms:.4f} ms, bound {n_bound:.4f} ms ({n_by})")
    if not n_rel <= TOL["shadow_march"]:
        raise AssertionError(f"kernel N disagrees with its plain version: rel {n_rel:.3e}")
    if not n_is_cm:
        raise AssertionError("kernel N's tau differs from kernel C's after kernel M")
    n_rank_is_cm = torch.equal(
        march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg, merge="rank"),
        march.shadow_final(march.importance_march(z0s, sl, sdir, mw, scfg, merge="rank"), sl, sdir, sdist, inv_s,
                           anneal, mw, scfg))
    n_dev = profiled_groups(lambda: march.shadow_march(z0s, sl, sdir, sdist, inv_s, anneal, mw, scfg)).get(
        "kernel N shadow_march", 0.0)
    log(f"[kernel N] merge='rank': tau equals C(M(.)) bit for bit: {n_rank_is_cm}; one profiled call, device time "
        f"{n_dev:.4f} ms; bound {n_bound:.4f} ms ({n_by})")
    if not n_rank_is_cm:
        raise AssertionError("kernel N's tau under the rank merge differs from kernel C's after kernel M")

    # D and E: the SDF stash op on the same 65,536 points (one train step's
    # core call), E at random cotangents of (sdf, feat, grad).
    n_pts, n_w = x.shape[0], sum(w.numel() for w in aw)
    d_feat, d_last = scfg.d_out_feat, dims[-2]
    cols = core_stash.sdf_stash_columns(scfg)
    d_out = core_stash.sdf_stash_fwd(aw, x, scfg)
    if not all(torch.equal(a, b) for a, b in zip(d_out[:3], k_out)):
        raise AssertionError("kernel D's outputs differ from kernel A's")
    d_plain = core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, "bfloat16", "bfloat16")
    d_abs, d_rel = max_err([*d_out[:3], *core_stash.split_stash(d_out[3], cols)], [*d_plain[:3], *d_plain[3]])
    d_ms = cuda_ms(lambda: core_stash.sdf_stash_fwd(aw, x, scfg), 10)
    d_plain_ms = cuda_ms(lambda: core_stash.sdf_core_fwd_hs_plain(aw, x, scfg, "bfloat16", "bfloat16"), 3, warmup=1)
    d_bytes = n_pts * (4 * (3 + 1 + d_feat + 3) + 2 * gt) + 2 * n_w
    d_bound, d_by = bound(a_flops, d_bytes, H100_BF16_FLOPS)
    log(f"[kernel D] sdf_stash_fwd: N={n_pts}, outputs equal kernel A's, max abs err {d_abs:.3e} (rel {d_rel:.3e}), "
        f"{d_ms:.4f} ms, plain {d_plain_ms:.4f} ms, bound {d_bound:.4f} ms ({d_by})")
    if not d_rel <= TOL["sdf_stash_fwd"]:
        raise AssertionError(f"kernel D disagrees with its plain version: rel {d_rel:.3e}")
    d_dev = profiled_groups(lambda: core_stash.sdf_stash_fwd(aw, x, scfg)).get("kernel D sdf_stash_fwd", 0.0)
    log(f"[kernel D] one profiled call, device time {d_dev:.4f} ms; bound {d_bound:.4f} ms ({d_by}); this design's "
        f"byte floor {(d_bytes + gate_bytes) / H100_BYTES_PER_S * 1e3:.4f} ms (inputs, outputs, the stash and the "
        f"gate scratch written and read once)")

    crng = np.random.default_rng(5)
    cots = tuple(torch.tensor(crng.normal(size=shape).astype(np.float32), device=dev)
                 for shape in ((n_pts,), (n_pts, d_feat), (n_pts, 3)))
    e_dws, e_dx = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg)
    e2_dws, e2_dx = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg)
    if not (torch.equal(e_dx, e2_dx) and all(torch.equal(a, b) for a, b in zip(e_dws, e2_dws))):
        raise AssertionError("kernel E's gradients differ between two runs")
    p_dws, p_dx = core_stash.sdf_core_bwd_stash_plain(aw, x, core_stash.split_stash(d_out[3], cols), cots, scfg,
                                                     "bfloat16")
    e_abs, e_rel = grad_err([e_dx, *e_dws], [p_dx, *p_dws])
    e_ms = cuda_ms(lambda: core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg), 10)
    e_plain_ms = cuda_ms(lambda: core_stash.sdf_core_bwd_stash_plain(
        aw, x, core_stash.split_stash(d_out[3], cols), cots, scfg, "bfloat16"), 3, warmup=1)
    # Multiply-adds per point: the recomputed reverse sweep, the sweep's VJP,
    # the z-chain and the two dW halves (5 x hidden), the feature head's
    # VJP and dW, and the sdf head's two columns.
    e_flops = 2.0 * n_pts * (5 * hidden + 2 * d_last * d_feat + 2 * d_last)
    e_bytes = n_pts * (2 * gt + 4 * (3 + 1 + d_feat + 3) + 4 * 3) + 2 * n_w + 4 * n_w
    e_bound, e_by = bound(e_flops, e_bytes, H100_BF16_FLOPS)
    log(f"[kernel E] sdf_stash_bwd: N={n_pts}, repeats bit for bit, max abs err {e_abs:.3e} (rel to each gradient "
        f"{e_rel:.3e}), {e_ms:.4f} ms, plain {e_plain_ms:.4f} ms, bound {e_bound:.4f} ms ({e_by}, "
        f"{e_flops / 1e9:.1f} GFLOP)")
    if not e_rel <= TOL["sdf_stash_bwd"]:
        raise AssertionError(f"kernel E disagrees with its plain version: rel {e_rel:.3e}")
    # E's two parts by device time, from one profiled call (the CUDA events
    # above include the wrapper's weight packing), each beside its bound:
    # E1 does the three chain sweeps and the feature head's VJP, reads the
    # stash, x and the cotangents and writes dx and the dW operands; the dW
    # passes do both halves of every dW product and read those operands.
    layers_pk = [(w_.shape[0], w_.shape[1]) for w_ in aw[0 : 2 * scfg.n_layers : 2]]
    op_bytes = 2.0 * (2 * n_pts * sum(i + o_ for i, o_ in layers_pk) + n_pts * (d_last + d_feat))
    e1_bound, e1_by = bound(2.0 * n_pts * (3 * hidden + d_last * d_feat + 2 * d_last),
                            n_pts * (2 * gt + 4 * (3 + 1 + d_feat + 3) + 4 * 3) + op_bytes + 2 * n_w, H100_BF16_FLOPS)
    edw_bound, edw_by = bound(2.0 * n_pts * (2 * hidden + d_last * d_feat), op_bytes + 4 * n_w, H100_BF16_FLOPS)
    e_parts = profiled_groups(lambda: core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg))
    e1_dev, edw_dev = e_parts.get("kernel E sdf_stash_bwd (E1)", 0.0), e_parts.get(DW_GROUP, 0.0)
    log(f"[kernel E] one profiled call, device time: E1 (the chain) {e1_dev:.4f} ms, bound {e1_bound:.4f} ms "
        f"({e1_by}); dW passes {edw_dev:.4f} ms, bound {edw_bound:.4f} ms ({edw_by}, reading the "
        f"{op_bytes / 1e9:.3f} GB of bf16 operands once); other {sum(e_parts.values()) - e1_dev - edw_dev:.4f} ms")
    # Registration's E: no weight needs a gradient, so no dW pass runs; dx
    # must be the full backward's bit for bit.
    e_none, e_dx_only = core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, need_dw=False)
    if e_none is not None or not torch.equal(e_dx_only, e_dx):
        raise AssertionError("kernel E without its dW passes gives another dx than the full backward")
    e_nodw_parts = profiled_groups(lambda: core_stash.sdf_stash_bwd(aw, x, d_out[3], cots, scfg, need_dw=False))
    log(f"[kernel E] need_dw=False (registration): dx bit for bit the full backward's; one profiled call, device "
        f"time {sum(e_nodw_parts.values()):.4f} ms (dW passes {e_nodw_parts.get(DW_GROUP, 0.0):.4f} ms) against "
        f"{sum(e_parts.values()):.4f} ms with them")

    # H: the recompute backward at the same points and cotangents.
    h_dws, h_dx = core_mlp.sdf_core_bwd(aw, x, cots, scfg)
    h2_dws, h2_dx = core_mlp.sdf_core_bwd(aw, x, cots, scfg)
    if not (torch.equal(h_dx, h2_dx) and all(torch.equal(a, b) for a, b in zip(h_dws, h2_dws))):
        raise AssertionError("kernel H's gradients differ between two runs")
    hp_dws, hp_dx = core_mlp.sdf_core_bwd_plain(aw, x, cots, scfg, "bfloat16")
    h_abs, h_rel = grad_err([h_dx, *h_dws], [hp_dx, *hp_dws])
    he_rel = grad_err([h_dx, *h_dws], [e_dx, *e_dws])[1]
    del hp_dws, hp_dx, h2_dws, h2_dx
    h_ms = cuda_ms(lambda: core_mlp.sdf_core_bwd(aw, x, cots, scfg), 10)
    h_plain_ms = cuda_ms(lambda: core_mlp.sdf_core_bwd_plain(aw, x, cots, scfg, "bfloat16"), 3, warmup=1)
    # E's operations plus the recomputed forward layers; it must read x and
    # the cotangents and write dx and every dW.
    h_flops = e_flops + 2.0 * n_pts * hidden
    h_bytes = n_pts * 4 * (3 + 1 + d_feat + 3 + 3) + 2 * n_w + 4 * n_w
    h_bound, h_by = bound(h_flops, h_bytes, H100_BF16_FLOPS)
    log(f"[kernel H] sdf_core_bwd: N={n_pts}, repeats bit for bit, max abs err {h_abs:.3e} (rel to each gradient "
        f"{h_rel:.3e}; against kernel E's gradients {he_rel:.3e}), {h_ms:.4f} ms, plain {h_plain_ms:.4f} ms, "
        f"bound {h_bound:.4f} ms ({h_by}, {h_flops / 1e9:.1f} GFLOP)")
    if not h_rel <= TOL["sdf_core_bwd"]:
        raise AssertionError(f"kernel H disagrees with its plain version: rel {h_rel:.3e}")
    h_parts = profiled_groups(lambda: core_mlp.sdf_core_bwd(aw, x, cots, scfg))
    log(f"[kernel H] one profiled call, device time: H1 (the recompute pass) "
        f"{h_parts.get('kernel H, forward pass (H1)', 0.0):.4f} ms, H2 (the chain) "
        f"{h_parts.get('kernel H chain (H2)', 0.0):.4f} ms, dW passes {h_parts.get(DW_GROUP, 0.0):.4f} ms")

    # F and G: the reflectance trunk on 65,536 points of random 361-wide
    # inputs, G at a random cotangent of its 3 outputs.
    n_lay = mcfg.reflectance_network.n_layers
    tw = core_mlp.materialize_mlp_weights(renderer_params["color"], n_lay)
    d_tin, n_tw = tw[0].shape[0], sum(w.numel() for w in tw)
    trng = np.random.default_rng(6)
    xt = torch.tensor(trng.normal(size=(n_pts, d_tin)).astype(np.float32), device=dev)
    gt_out = torch.tensor(trng.normal(size=(n_pts, 3)).astype(np.float32), device=dev)
    tpk = core_mlp.pack_mlp(tw, n_lay)
    mcols = core_stash.mlp_stash_columns(tpk)
    f_out, f_zs = core_stash.mlp_stash_fwd(tw, xt, n_lay)
    fp_out, fp_zs = core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, "bfloat16", "bfloat16")
    f_abs, f_rel = max_err([f_out, *core_stash.split_stash(f_zs, mcols)], [fp_out, *fp_zs])
    f_ms = cuda_ms(lambda: core_stash.mlp_stash_fwd(tw, xt, n_lay), 10)
    f_plain_ms = cuda_ms(lambda: core_stash.mlp_relu_fwd_zs_plain(tw, xt, n_lay, "bfloat16", "bfloat16"), 3, warmup=1)
    trunk_macs = sum(w.shape[0] * w.shape[1] for w in tw[0::2])
    zt = f_zs.shape[1]
    f_bytes = n_pts * (4 * d_tin + 2 * zt + 4 * 3) + 2 * n_tw
    f_bound, f_by = bound(2.0 * n_pts * trunk_macs, f_bytes, H100_BF16_FLOPS)
    log(f"[kernel F] mlp_stash_fwd: N={n_pts}, max abs err {f_abs:.3e} (rel {f_rel:.3e}), {f_ms:.4f} ms, "
        f"plain {f_plain_ms:.4f} ms, bound {f_bound:.4f} ms ({f_by})")
    if not f_rel <= TOL["mlp_stash_fwd"]:
        raise AssertionError(f"kernel F disagrees with its plain version: rel {f_rel:.3e}")
    g_dws, g_dx = core_stash.mlp_stash_bwd(tw, xt, f_zs, gt_out, n_lay)
    g2_dws, g2_dx = core_stash.mlp_stash_bwd(tw, xt, f_zs, gt_out, n_lay)
    if not (torch.equal(g_dx, g2_dx) and all(torch.equal(a, b) for a, b in zip(g_dws, g2_dws))):
        raise AssertionError("kernel G's gradients differ between two runs")
    del g2_dws, g2_dx
    gp_dws, gp_dx = core_stash.mlp_relu_bwd_stash_plain(tw, xt, core_stash.split_stash(f_zs, mcols), gt_out, n_lay,
                                                        "bfloat16")
    g_abs, g_rel = grad_err([g_dx, *g_dws], [gp_dx, *gp_dws])
    g_ms = cuda_ms(lambda: core_stash.mlp_stash_bwd(tw, xt, f_zs, gt_out, n_lay), 10)
    g_plain_ms = cuda_ms(lambda: core_stash.mlp_relu_bwd_stash_plain(
        tw, xt, core_stash.split_stash(f_zs, mcols), gt_out, n_lay, "bfloat16"), 3, warmup=1)
    g_bytes = n_pts * (4 * d_tin + 2 * zt + 4 * 3 + 4 * d_tin) + 2 * n_tw + 4 * n_tw
    g_bound, g_by = bound(4.0 * n_pts * trunk_macs, g_bytes, H100_BF16_FLOPS)
    log(f"[kernel G] mlp_stash_bwd: N={n_pts}, max abs err {g_abs:.3e} (rel to each gradient {g_rel:.3e}), "
        f"{g_ms:.4f} ms, plain {g_plain_ms:.4f} ms, bound {g_bound:.4f} ms ({g_by})")
    if not g_rel <= TOL["mlp_stash_bwd"]:
        raise AssertionError(f"kernel G disagrees with its plain version: rel {g_rel:.3e}")

    # I and J: the trunk without a stash, on the same inputs.
    i_out = core_mlp.mlp_fwd(tw, xt, n_lay)
    if not torch.equal(i_out, f_out):
        raise AssertionError("kernel I's output differs from kernel F's")
    i_abs, i_rel = max_err([i_out], [core_mlp.mlp_relu_plain(tw, xt, n_lay, "bfloat16")])
    i_ms = cuda_ms(lambda: core_mlp.mlp_fwd(tw, xt, n_lay), 10)
    i_plain_ms = cuda_ms(lambda: core_mlp.mlp_relu_plain(tw, xt, n_lay, "bfloat16"), 3, warmup=1)
    i_bytes = n_pts * (4 * d_tin + 4 * 3) + 2 * n_tw
    i_bound, i_by = bound(2.0 * n_pts * trunk_macs, i_bytes, H100_BF16_FLOPS)
    log(f"[kernel I] mlp_fwd: N={n_pts}, output equals kernel F's, max abs err {i_abs:.3e} (rel {i_rel:.3e}), "
        f"{i_ms:.4f} ms, plain {i_plain_ms:.4f} ms, bound {i_bound:.4f} ms ({i_by})")
    if not i_rel <= TOL["mlp_fwd"]:
        raise AssertionError(f"kernel I disagrees with its plain version: rel {i_rel:.3e}")
    j_dws, j_dx = core_mlp.mlp_bwd(tw, xt, gt_out, n_lay)
    j2_dws, j2_dx = core_mlp.mlp_bwd(tw, xt, gt_out, n_lay)
    if not (torch.equal(j_dx, j2_dx) and all(torch.equal(a, b) for a, b in zip(j_dws, j2_dws))):
        raise AssertionError("kernel J's gradients differ between two runs")
    j_as_g = torch.equal(j_dx, g_dx) and all(torch.equal(a, b) for a, b in zip(j_dws, g_dws))
    if not j_as_g:
        raise AssertionError("kernel J's gradients differ from kernel G's at kernel F's stash")
    jp_dws, jp_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt_out, n_lay, "bfloat16")
    j_abs, j_rel_plain = grad_err([j_dx, *j_dws], [jp_dx, *jp_dws])
    j_norm = grad_norm_err([j_dx, *j_dws], [jp_dx, *jp_dws])
    jz_dws, jz_dx = core_mlp.mlp_relu_bwd_plain(tw, xt, gt_out, n_lay, "bfloat16",
                                                 zs=[z.float() for z in core_stash.split_stash(f_zs, mcols)])
    j_rel = grad_err([j_dx, *j_dws], [jz_dx, *jz_dws])[1]
    del jz_dws, jz_dx
    j_ms = cuda_ms(lambda: core_mlp.mlp_bwd(tw, xt, gt_out, n_lay), 10)
    j_plain_ms = cuda_ms(lambda: core_mlp.mlp_relu_bwd_plain(tw, xt, gt_out, n_lay, "bfloat16"), 3, warmup=1)
    # The recomputed forward, the dx chain and the dW products.
    j_bytes = n_pts * (4 * d_tin + 4 * 3 + 4 * d_tin) + 2 * n_tw + 4 * n_tw
    j_bound, j_by = bound(6.0 * n_pts * trunk_macs, j_bytes, H100_BF16_FLOPS)
    log(f"[kernel J] mlp_bwd: N={n_pts}, repeats bit for bit, equal to kernel G's at F's stash: {j_as_g}; against "
        f"the plain backward at the forward's z: rel to each gradient {j_rel:.3e}; against the plain backward: max "
        f"abs err {j_abs:.3e} (rel to each gradient {j_rel_plain:.3e}, ReLU mask flips), relative norm of the error "
        f"{j_norm:.3e}; {j_ms:.4f} ms, plain {j_plain_ms:.4f} ms, bound {j_bound:.4f} ms ({j_by})")
    if not (j_rel <= TOL["mlp_bwd"] and j_norm <= TOL["mlp_bwd"]):
        raise AssertionError(f"kernel J disagrees with its plain version: rel {j_rel:.3e}, norm {j_norm:.3e}")

    # F, I, G and J by device time, each part from one profiled call (the
    # CUDA events above include the wrapper's weight packing), beside its
    # bound and its design's byte floor.  F and I read x and write their
    # outputs (F also the stash); the chain (G1, and J2 after J1) reads x,
    # the stash and g, writes dx and the bf16 dW operands, which the dW
    # passes read; J1 recomputes the hidden layers into a transient stash.
    hidden_macs = trunk_macs - tw[-2].shape[0] * tw[-2].shape[1]
    npad_t = core_mlp.trunk_layout(n_pts, zt)[1]
    top_bytes = 2.0 * npad_t * sum(int(tpk["meta"][4 + 7 * i + 2]) + int(tpk["meta"][4 + 7 * i + 3])
                               for i in range(n_lay + 1))
    ch_bytes = n_pts * (4 * d_tin + 2 * zt + 4 * 3 + 4 * d_tin) + top_bytes + 2 * n_tw
    ch_bound, ch_by = bound(2.0 * n_pts * trunk_macs, ch_bytes, H100_BF16_FLOPS)
    tdw_bound, tdw_by = bound(2.0 * n_pts * trunk_macs, top_bytes + 4 * n_tw, H100_BF16_FLOPS)
    j1_bound, j1_by = bound(2.0 * n_pts * hidden_macs, n_pts * (4 * d_tin + 2 * zt) + 2 * n_tw, H100_BF16_FLOPS)
    f_dev = profiled_groups(lambda: core_stash.mlp_stash_fwd(tw, xt, n_lay, tpk)).get("kernel F mlp_stash_fwd", 0.0)
    i_dev = profiled_groups(lambda: core_mlp.mlp_fwd(tw, xt, n_lay, tpk)).get("kernel I mlp_fwd", 0.0)
    g_parts = profiled_groups(lambda: core_stash.mlp_stash_bwd(tw, xt, f_zs, gt_out, n_lay, tpk))
    j_parts = profiled_groups(lambda: core_mlp.mlp_bwd(tw, xt, gt_out, n_lay, tpk))
    g1_dev, gdw_dev = g_parts.get(TRUNK_CHAIN_GROUP, 0.0), g_parts.get(DW_GROUP, 0.0)
    j1_dev, j2_dev = j_parts.get("kernel J, recompute pass (J1)", 0.0), j_parts.get(TRUNK_CHAIN_GROUP, 0.0)
    jdw_dev = j_parts.get(DW_GROUP, 0.0)
    log(f"[kernel F] one profiled call, device time {f_dev:.4f} ms; bound {f_bound:.4f} ms ({f_by}), which is this "
        f"design's byte floor too (x, the stash and the output once)")
    log(f"[kernel I] one profiled call, device time {i_dev:.4f} ms; bound {i_bound:.4f} ms ({i_by}); this design's "
        f"byte floor {i_bytes / H100_BYTES_PER_S * 1e3:.4f} ms (x and the output once)")
    log(f"[kernel G] one profiled call, device time: G1 (the chain) {g1_dev:.4f} ms, bound {ch_bound:.4f} ms "
        f"({ch_by}); dW passes {gdw_dev:.4f} ms, bound {tdw_bound:.4f} ms ({tdw_by}); this design's byte floor "
        f"{(ch_bytes + top_bytes + 4 * n_tw) / H100_BYTES_PER_S * 1e3:.4f} ms (the {top_bytes / 1e9:.3f} GB of bf16 dW "
        f"operands written and read once with x, the stash, g and dx)")
    j_floor = n_pts * (4 * d_tin + 2 * zt) + ch_bytes + top_bytes + 4 * n_tw
    log(f"[kernel J] one profiled call, device time: J1 (the recompute pass) {j1_dev:.4f} ms, bound "
        f"{j1_bound:.4f} ms ({j1_by}); J2 (the chain) {j2_dev:.4f} ms, bound {ch_bound:.4f} ms ({ch_by}); dW passes "
        f"{jdw_dev:.4f} ms; this design's byte floor {j_floor / H100_BYTES_PER_S * 1e3:.4f} ms (G's, and x and the "
        f"{2 * n_pts * zt / 1e9:.3f} GB transient stash of J1)")
    del d_out, d_plain, e_dws, e_dx, e2_dws, e2_dx, p_dws, p_dx, f_zs, fp_zs, g_dws, g_dx, gp_dws, gp_dx
    del h_dws, h_dx, i_out, j_dws, j_dx, j2_dws, j2_dx, jp_dws, jp_dx
    torch.cuda.empty_cache()

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 4")
    # 4. Main path: one 128x128 view through Evaluator.render_image.
    hh, ww = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    view = PixelBundle(
        h_indices=hh.float(), w_indices=ww.float(),
        poses=pose.expand(H, W, 4, 4), pls=pl.expand(H, W, 3),
    )
    ev = Evaluator(cfg, camera, {}, device="cuda")
    img, secs, launches = view_through_graph("main path", ev, params, view, smi)
    n_chunks = -(-H * W // mcfg.inference_chunk_size)
    expected = {k: 0 for k in cuda_lib.launch_counts}
    expected.update(sdf_core_fwd=n_chunks, round_machinery=8 * n_chunks, shadow_final=n_chunks)
    log(f"[main path] {H}x{W} view: {secs:.4f} s, {H * W / secs:.1f} rays/s on {smi}; launches {launches}")
    channels = {"rgb": 3, "depth": 1, "normal": 3, "normalized_normal": 3, "shadow_map": 1,
                "specular_hint": len(mcfg.renderer.specular_roughness)}
    shapes = {k: v.shape for k, v in img.items()}
    if shapes != {k: (H, W, c) for k, c in channels.items()}:
        raise AssertionError(f"unexpected outputs {shapes}")
    for k, v in img.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"non-finite values in {k}")
    for k in ("rgb", "shadow_map"):
        if img[k].min() < 0.0 or img[k].max() > 1.0:
            raise AssertionError(f"{k} outside [0, 1]: [{img[k].min()}, {img[k].max()}]")
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    log(f"[main path] rgb mean {img['rgb'].mean():.4f}, shadow_map range [{img['shadow_map'].min():.4f}, "
        f"{img['shadow_map'].max():.4f}], depth range [{img['depth'].min():.4f}, {img['depth'].max():.4f}]")

    # Where the time of one view goes: a second render under torch.profiler,
    # device time by kernel group, and the device's idle share of the
    # unprofiled wall (the profiled wall carries the profiler's own host
    # overhead, so its idle share overstates the host's).
    from torch.profiler import ProfilerActivity, profile

    def profile_view(label: str, ev_, secs_: float, launches_: dict) -> None:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev_.render_image(params, view)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        groups = device_groups(prof)
        busy = sum(groups.values())
        if busy > 0:
            log(f"[profile] one {label} view: device busy {busy:.1f} ms; idle share {1 - busy / (secs_ * 1e3):.3f} of "
                f"the unprofiled view ({secs_ * 1e3:.1f} ms), {1 - busy / prof_wall:.3f} of the profiled wall "
                f"({prof_wall:.1f} ms)")
            for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
                # "kernel X <launch key> ...": the device time per launch too.
                n = launches_.get(g.split()[2], 0) if g.startswith("kernel ") else 0
                per = f", {ms / n:.4f} ms per launch over {n}" if n else ""
                log(f"[profile]   {g}: {ms:.2f} ms ({ms / busy:.3f} of device time{per})")
        else:
            log(f"[profile] the profiler recorded no device time in the {label} view: breakdown not measured")

    profile_view("phase 4", ev, secs, launches)

    # The same view's pixels on the CPU, plain versions, 64 rays.
    rows = torch.arange(36, 100, 8)
    ph, pw = torch.meshgrid(rows, rows, indexing="ij")
    sub = PixelBundle(
        h_indices=ph.reshape(1, -1).float(), w_indices=pw.reshape(1, -1).float(),
        poses=pose.expand(1, 64, 4, 4), pls=pl.expand(1, 64, 3),
    )
    cpu_img = Evaluator(cfg, camera, {}, device="cpu").render_image(params, sub)
    for k, tol in CPU_TOL.items():
        card = img[k][ph.numpy(), pw.numpy()].reshape(1, 64, -1)
        e = float(np.abs(card - cpu_img[k]).max())
        log(f"[main path] CPU plain vs card, 64 pixels, {k}: max abs err {e:.3e} (tol {tol})")
        if not e <= tol:
            raise AssertionError(f"CPU and card renders disagree on {k}: {e:.3e}")

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 4b")
    # 4b. The same view with the fused eval trunk (kernel I, never F).
    ev_p = Evaluator(with_renderer(cfg, eval_reflectance_impl="pallas"), camera, {}, device="cuda")
    img_p, secs_p, launches_p = view_through_graph("main path 4b", ev_p, params, view, smi)
    expected_p = dict(expected, mlp_fwd=n_chunks)
    log(f"[main path 4b] {H}x{W} view, eval_reflectance_impl='pallas': {secs_p:.4f} s, {H * W / secs_p:.1f} rays/s "
        f"on {smi}; launches {launches_p}")
    if launches_p != expected_p:
        raise AssertionError(f"launch counts {launches_p}, expected {expected_p}")
    if {k: v.shape for k, v in img_p.items()} != shapes or not all(np.all(np.isfinite(v)) for v in img_p.values()):
        raise AssertionError("the fused-trunk view's outputs are malformed or not finite")
    for k, tol in CPU_TOL.items():
        e = float(np.abs(img_p[k] - img[k]).max())
        log(f"[main path 4b] fused trunk vs phase 4's f32 trunk, whole view, {k}: max abs err {e:.3e} (tol {tol})")
        if not e <= tol:
            raise AssertionError(f"the fused-trunk view disagrees with phase 4's on {k}: {e:.3e}")

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 7")
    # 7. The same view under the round-4 marches: the monolith (M for the
    # camera rays, N for the shadow rays) and the split march (K then L for
    # the camera rays; the shadow refinement ignores importance_split, so M
    # then C), both by rank in the split case.
    round4 = {
        "monolith": (MONOLITH, dict(importance_march=n_chunks, shadow_march=n_chunks)),
        "split": (SPLIT, dict(march_sweep=n_chunks, march_rounds=n_chunks, importance_march=n_chunks,
                              shadow_final=n_chunks)),
    }
    view_launches, round4_evs = {}, {}
    for name, (kw, counts) in round4.items():
        ev7 = Evaluator(with_renderer(cfg, **kw), camera, {}, device="cuda")
        img7, secs7, launches7 = view_through_graph(f"round-4 {name}", ev7, params, view, smi)
        expected7 = dict({k: 0 for k in cuda_lib.launch_counts}, sdf_core_fwd=n_chunks, **counts)
        log(f"[round-4 {name}] {H}x{W} view {kw}: {secs7:.4f} s, {H * W / secs7:.1f} rays/s on {smi}; launches "
            f"{launches7}")
        if launches7 != expected7:
            raise AssertionError(f"launch counts {launches7}, expected {expected7}")
        if {k: v.shape for k, v in img7.items()} != shapes or not all(np.all(np.isfinite(v)) for v in img7.values()):
            raise AssertionError(f"the round-4 {name} view's outputs are malformed or not finite")
        for k, tol in CPU_TOL.items():
            e = float(np.abs(img7[k] - img[k]).max())
            log(f"[round-4 {name}] against phase 4's view, whole view, {k}: max abs err {e:.3e} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"the round-4 {name} view disagrees with phase 4's on {k}: {e:.3e}")
        view_launches[name], round4_evs[name] = launches7, (ev7, secs7)
    profile_view("phase 4b fused-trunk", ev_p, secs_p, launches_p)
    for name, (ev7, secs7) in round4_evs.items():
        profile_view(f"round-4 {name}", ev7, secs7, view_launches[name])

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 5")
    # 5. Train path: nr-hints-cam-opt at full width, 512-ray batches of 8
    # procedural views, through make_train_step.
    td = train_data(dev, H, W)
    tcfg, n_views, tcam, next_batch = td["cfg"], td["n_views"], td["camera"], td["next_batch"]
    images, poses, pls_v = td["images"], td["poses"], td["pls"]
    batches = [next_batch() for _ in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    b64 = next_batch(64)
    urng = np.random.default_rng(7)
    u64 = {"strat": urng.random((64, 1), dtype=np.float32),
           "shadow": urng.random((64, tcfg.model.renderer.n_shadow_samples), dtype=np.float32)}

    step_secs = {}

    def train_phase(label: str, scfg_, n_steps: int, per_step: dict) -> dict:
        """Train a fresh seed-0 state of ``scfg_`` on ``batches``: warm-up,
        ``n_steps`` timed steps (launches checked against ``per_step``, every
        kernel it omits at 0), one
        profiled step, and one 64-ray step's gradients against the CPU."""
        tgen = torch.Generator().manual_seed(0)
        tparams = {"renderer": init_model_params(scfg_.model, tgen, device=dev)}
        tparams["raygen"], tbuffers = ray_generator_init(tgen, scfg_.ray_generator, n_views, device=dev)
        start = {name: t.detach().clone() for name, t in tree_items(tparams)}
        opt = make_optimizer(scfg_, tparams)
        state = init_train_state(tparams, opt)
        step_fn = make_train_step(scfg_, tcam, tbuffers, opt)
        step_gen = torch.Generator(device=dev).manual_seed(0)
        for b in batches[:TRAIN_WARMUP]:
            state, metrics = step_fn(state, b, step_gen)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for b in batches[TRAIN_WARMUP : TRAIN_WARMUP + n_steps]:
            state, metrics = step_fn(state, b, step_gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s = step_secs[label] = (time.perf_counter() - t0) / n_steps
        launches_ = dict(cuda_lib.launch_counts)
        expected_ = dict({k: 0 for k in cuda_lib.launch_counts}, **per_step)
        losses = [float(v) for v in losses]
        log(f"[{label}] {scfg_.model.batch_size} rays/step, core_backward={scfg_.model.renderer.core_backward!r}: "
            f"{step_s:.5f} s/step, {scfg_.model.batch_size / step_s:.1f} train rays/s on {smi}; loss {losses[0]:.5f} "
            f"-> {losses[-1]:.5f}, psnr {float(metrics['psnr']):.3f}; launches over {n_steps} steps {launches_}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if launches_ != {k: v * n_steps for k, v in expected_.items()}:
            raise AssertionError(f"train launch counts {launches_}, expected {expected_} per step")
        moved = {group: any(not torch.equal(t.detach(), start[name]) for name, t in tree_items(tparams)
                            if name.startswith(f"/{group}/")) for group in ("renderer", "raygen")}
        if not all(moved.values()):
            raise AssertionError(f"parameters did not move: {moved}")
        n_moved = sum(not torch.equal(t.detach(), start[name]) for name, t in tree_items(tparams))
        log(f"[{label}] {n_moved} of {len(start)} parameter leaves moved, raygen's pose deltas included")

        # Where the time of one step goes: one more step under
        # torch.profiler; the idle share is taken against the unprofiled
        # step (the profiled wall carries the profiler's host overhead).
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[TRAIN_WARMUP + n_steps], step_gen)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        tgroups = device_groups(prof)
        tbusy = sum(tgroups.values())
        if tbusy > 0:
            log(f"[profile] one {label} step: device busy {tbusy:.2f} ms; idle share {1 - tbusy / (step_s * 1e3):.3f} "
                f"of the unprofiled step ({step_s * 1e3:.2f} ms), {1 - tbusy / prof_wall:.3f} of the profiled wall "
                f"({prof_wall:.2f} ms)")
            for g, ms in sorted(tgroups.items(), key=lambda kv: -kv[1]):
                log(f"[profile]   {g}: {ms:.3f} ms ({ms / tbusy:.3f} of device time)")
        else:
            log("[profile] the profiler recorded no device time: breakdown not measured")

        card_cpu_grads(label, scfg_, state, tcam, tbuffers, b64, u64)
        return launches_

    stash_step = dict(sdf_stash_fwd=1, sdf_stash_bwd=1, mlp_stash_fwd=1, mlp_stash_bwd=1)
    train_launches = train_phase("train path", tcfg, TRAIN_STEPS, dict(
        stash_step, round_machinery=8, shadow_final=1))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 6")
    # 6. The recompute schedule on the same batches.
    rec_launches = train_phase("recompute train path", with_renderer(tcfg, core_backward="recompute"),
                               RECOMPUTE_STEPS, dict(sdf_core_fwd=1, sdf_core_bwd=1, mlp_fwd=1, mlp_bwd=1,
                                                     round_machinery=8, shadow_final=1))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 8")
    # 8. The monolithic round-4 marches in training, on the same batches.
    train_phase("round-4 monolith train path", with_renderer(tcfg, **MONOLITH), ROUND4_STEPS,
                              dict(stash_step, importance_march=1, shadow_march=1))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 10 (a)-(b)")
    # 10 (a)-(b). K train steps as one CUDA graph against K eager steps.
    scan_phase(smi, dev, td, batches, "graph 10(a)", tcfg, 16, dict(stash_step, round_machinery=8, shadow_final=1))
    scan_phase(smi, dev, td, batches, "graph 10(b) recompute", with_renderer(tcfg, core_backward="recompute"), 2,
               dict(sdf_core_fwd=1, sdf_core_bwd=1, mlp_fwd=1, mlp_bwd=1, round_machinery=8, shadow_final=1))
    scan_phase(smi, dev, td, batches, "graph 10(b) round-4 monolith", with_renderer(tcfg, **MONOLITH), 2,
               dict(stash_step, importance_march=1, shadow_march=1))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 10 (c)")
    # 10 (c). A test view's registration through its graph against the
    # eager loop, from the same generator.
    tgen = torch.Generator().manual_seed(0)
    rparams = {"renderer": init_model_params(tcfg.model, tgen, device=dev)}
    rparams["raygen"], rbuffers = ray_generator_init(tgen, tcfg.ray_generator, n_views, device=dev)
    rev = Evaluator(tcfg, tcam, rbuffers, device="cuda")
    test_view = PixelBundle(h_indices=hh.float().to(dev), w_indices=ww.float().to(dev),
                            poses=poses[0].expand(H, W, 4, 4), pls=pls_v[0].expand(H, W, 3),
                            img_indices=torch.zeros((H, W), dtype=torch.long, device=dev), rgb_gt=images[0])
    n_reg = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rev._register_view_eager(rparams, test_view, steps=n_reg)["raygen"]
    torch.cuda.synchronize()
    reg_eager_ms = (time.perf_counter() - t0) * 1e3 / n_reg
    reg_ms, reg_worst = [], (0.0, "")
    for i in range(2):  # the first call (one eager step, the capture, replays), then replays only
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = rev.register_view(rparams, test_view, steps=n_reg)["raygen"]
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t0) * 1e3 / n_reg)
        want = dict({k: 0 for k in cuda_lib.launch_counts}, sdf_stash_fwd=n_reg, sdf_stash_bwd=n_reg,
                    shadow_final=n_reg, round_machinery=8 * n_reg)
        if dict(cuda_lib.launch_counts) != want:
            raise AssertionError(f"registration call {i}: launches {dict(cuda_lib.launch_counts)}, expected {want}")
        reg_worst = max(reg_worst, snapshot_err(out, ref))
        if not any(not torch.equal(out[k], rparams["raygen"][k]) for k in out):
            raise AssertionError("registration moved no raygen leaf")
    if reg_worst[0] > 1e-6:
        raise AssertionError(f"the registration graph differs from the eager loop: {reg_worst[1]} {reg_worst[0]:.3e}")
    reg_verdict = "bit for bit" if reg_worst[0] == 0.0 else f"within {reg_worst[0]:.3e} of {reg_worst[1]}'s scale"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rev.register_view(rparams, test_view, steps=500)
    torch.cuda.synchronize()
    reg500_s = time.perf_counter() - t0
    log(f"[registration 10(c)] {n_reg} steps of a {H}x{W} test view: eager loop {reg_eager_ms:.3f} ms a step; "
        f"through the graph {reg_ms[1]:.3f} ms a step (the first call, with its eager step and capture, "
        f"{reg_ms[0]:.3f}); registered raygen leaves against the eager loop's: {reg_verdict}; a full 500-step "
        f"registration through the graph {reg500_s:.3f} s; on {smi}")

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 9")
    # 9 and 10 (d). The training entry point, python -m nrhints_torch's main,
    # one step a dispatch and then ten.
    import tempfile

    with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
        eager_run = train_entry_phase(smi, step_secs["train path"], Path(tmp))
        dispatch_entry_phase(smi, Path(tmp), eager_run)
        # 11. Data parallelism over ranks.
        data_parallel_phase(smi, dev, td, batches, Path(tmp), eager_run["views"])

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 12")
    # 12. The unfused renderer and what rides on it, on batches of its own
    # (the same as ``--offpath`` draws).
    offpath_phase(smi, dev, mc, train_data(dev, H, W))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 13")
    # 13. core_backward="stash_all" and the import, on batches of its own
    # (the same as ``--stash-all`` draws).
    with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
        sa = stash_all_phase(smi, dev, mc, train_data(dev, H, W), Path(tmp))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 14")
    # 14. march_dtype="float32", on batches of its own (as ``--march-f32``).
    f32 = march_f32_phase(smi, dev, mc, train_data(dev, H, W))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 15")
    # 15. Sample-axis sharding, on batches of its own (as ``--sample-axis``).
    td15 = train_data(dev, H, W)
    with tempfile.TemporaryDirectory(prefix="nrhints_chip_smoke_") as tmp:
        sample_axis_phase(smi, dev, td15, [td15["next_batch"]() for _ in range(max(SAMPLE_K, TRAIN_WARMUP))],
                          Path(tmp))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 16")
    # 16. The SDF core at compute_dtype="float32" and stash_dtype="float32".
    core_f32 = core_f32_phase(smi, dev, mc)

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 17")
    # 17. The reflectance trunk at compute_dtype="float32" and
    # stash_dtype="float32".
    trunk_f32 = trunk_f32_phase(smi, dev, mc)

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phases 18 and 19")
    # 18. The SDF core above the presets' widths, and 19. the reflectance
    # trunk above them, together in a process of their own (as
    # ``--wide-sdf --wide-trunk``): late in this long process the profiler
    # dropped a whole phase-19 kernel's records.
    gc.collect()
    torch.cuda.empty_cache()
    wide = phase_subprocess(["--wide-sdf", "--wide-trunk"], ("[18", "[19", "[profile]", "[wide"))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 20")
    # 20. The fused marches at geometries other than 64 + 4 x 16, in a
    # process of its own (as ``--march-geometry``).
    gc.collect()
    torch.cuda.empty_cache()
    geometry = phase_subprocess(["--march-geometry"], ("[20",))

    log(f"[time] {time.perf_counter() - t_start:.1f} s before phase 21")
    # 21. The SDF core's wide f32 instances, 22. networks deeper than the
    # kernels' parameter tables, and 23. the SDF core above the wide class,
    # together in a process of their own (as ``--wide-core-f32 --deep
    # --huge-core``).
    late_entries = phase_subprocess(["--wide-core-f32", "--deep", "--huge-core"],
                                    ("[21", "[22", "[23", "[profile]"))
    log(f"[total] the smoke run took {time.perf_counter() - t_start:.1f} s")

    kernels = [
        entry("sdf_core_fwd", "sdf_core.cu", "core_mlp.py:227", launches["sdf_core_fwd"], a_abs, a_ms, a_plain_ms,
              a_bound, a_by),
        entry("round_machinery", "march.cu", "march.py:392", launches["round_machinery"], b_abs, b_ms, b_plain_ms,
              b_bound, "bytes"),
        entry("shadow_final", "march.cu", "march.py:574", launches["shadow_final"], c_abs, c_ms, c_plain_ms, c_bound,
              c_by),
        entry("sdf_stash_fwd", "sdf_core.cu", "core_stash.py:369", train_launches["sdf_stash_fwd"], d_abs, d_ms,
              d_plain_ms, d_bound, d_by),
        entry("sdf_stash_bwd", "sdf_stash.cu", "core_stash.py:422", train_launches["sdf_stash_bwd"], e_abs, e_ms,
              e_plain_ms, e_bound, e_by),
        entry("mlp_stash_fwd", "mlp_stash.cu", "core_stash.py:588", train_launches["mlp_stash_fwd"], f_abs, f_ms,
              f_plain_ms, f_bound, f_by),
        entry("mlp_stash_bwd", "mlp_stash.cu", "core_stash.py:622", train_launches["mlp_stash_bwd"], g_abs, g_ms,
              g_plain_ms, g_bound, g_by),
        entry("sdf_core_bwd", "sdf_core_bwd.cu", "core_mlp.py:260", rec_launches["sdf_core_bwd"], h_abs, h_ms,
              h_plain_ms, h_bound, h_by),
        entry("mlp_fwd", "mlp_stash.cu", "core_mlp.py:397", rec_launches["mlp_fwd"], i_abs, i_ms, i_plain_ms, i_bound,
              i_by),
        entry("mlp_bwd", "mlp_stash.cu", "core_mlp.py:420", rec_launches["mlp_bwd"], j_abs, j_ms, j_plain_ms, j_bound,
              j_by),
        entry("march_sweep", "march_fused.cu", "march.py:507", view_launches["split"]["march_sweep"], k_abs, k_ms,
              k_plain_ms, k_bound, k_by),
        entry("march_rounds", "march_fused.cu", "march.py:522", view_launches["split"]["march_rounds"], l_abs, l_ms,
              l_plain_ms, l_bound, l_by),
        entry("importance_march", "march_fused.cu", "march.py:488", view_launches["monolith"]["importance_march"],
              m_abs, m_ms, m_plain_ms, m_bound, m_by),
        entry("shadow_march", "march_fused.cu", "march.py:595", view_launches["monolith"]["shadow_march"], n_abs,
              n_ms, n_plain_ms, n_bound, n_by),
        *stash_all_entries(sa),
        *f32["entries"],
        *core_f32,
        *trunk_f32,
        *wide,
        *geometry,
        *late_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
