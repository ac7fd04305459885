"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a GPU

Every conv block is routed as the JAX package routes it with
backend="pallas" (``ops/envelope.py``): "fused" layers run kernel 1 or 2,
"split" layers the cuDNN conv and then kernel 3 (GroupNorm + activation).
Phases, each of which fails the run (non-zero exit, no final line):

1. Print the card and its power limit; build every Hopper kernel from
   ``action_conditioned_gans_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and print what ``ptxas -v`` says of the wgmma mainloop's
   instances in kernels 1 and 2, of kernel 2's narrow mainloop, of
   kernels 3 and 4's cluster kernels and of kernel 5's eight instances
   (registers, spills: none allowed).
2. Per-kernel parity of kernels 1-2 at the seven config1 generator layer
   shapes and the four config1 discriminator layer shapes (batch 8), at
   every other shape of kernels 1-2 on the main paths (the config3 and
   config5 fused layers, batch 2), and at ragged shapes: five on the edges
   of kernel 1's wgmma mainloop (Cin 12 and 20 with 8-byte copies, K no
   multiple of 64, 25- and 144-row planes, Cout 192 in three 64-wide tiles,
   the 64 x 256 tile), three on kernel 2's (a 5x6 plane with Cin 12 on
   8-byte copies, K 48 in one partial stage, and Cout 192; the 64 x 256
   tile on config3's dec_3 at B=32), two on its narrow mainloop (B=3 with
   8-row bands over 10 rows and Cin 20 copied by channel; Cout 16 on a 7x9
   plane); each line names the mainloop. float32 with
   TF32 off within 1e-3 abs + 1e-3 rel of the plain PyTorch version;
   bfloat16 within 3e-2 abs of the plain version
   run in float32 on the same bfloat16 inputs (a bfloat16 plain version
   rounds its pre-norm conv output, which moves outputs near 4 by one
   bfloat16 step, 0.031). Kernel 3 (one launch, one thread-block cluster
   per sample, csrc/group_norm_act.cu) against its plain version at its
   seven config5 generator shapes (B=2), config3 D conv_4 (B=8) and ragged
   shapes (C 40, 96, 520 and 36, groups lowered, odd planes, B=1, a plane of
   9 rows over a cluster of 8, more channels than a block's threads hold in
   one pass, a cluster of 2, and config5 dec_1 in float32, whose shares
   spill past shared memory), every activation: float32 within 1e-4 abs +
   1e-4 rel, bfloat16 within 3e-2 as above, its (mean, rstd) against
   float64 statistics, and a second launch on the same input bit-identical.
   The plan (``acg_gn_plan``) of every kernel-3 call of the whole run is
   held against its Python copy (``norm_act.gn_plan``) at the end.
3. The committed JAX fixture (tests/fixtures/torch_port_tiny_generator.npz)
   reproduced on cuda in float32 within 1e-3, and the full-width config1
   and config5 (B=1) generators on cuda against the same weights on the
   CPU's plain path.
4. Serving in bfloat16 with seeded weights: counts set to 0, then
   Predictor.predict and Predictor.rollout, counts read and held to
   EXPECTED (launches per generator call, of them kernel 1 on its wgmma
   mainloop, and routes): config1 at B=128 and T=10, B=16 (4 / 3 / 0
   launches of kernels 1 / 2 / 3; kernel 1 3 of 4 on wgmma, kernel 2 2 on
   wgmma and dec_0 on its narrow mainloop; 7 fused layers); config5 at
   256x256, B=32 and T=30, B=8 (2 / 0 / 7 launches, 2 of 2 on wgmma, 2
   fused and 9 split layers). Outputs finite in [-1, 1]; both
   timed with CUDA events.
5. The port's HTTP server answers /healthz, /predict and /rollout (float32
   and uint8) with exactly the direct calls' results (config1).
6. Per-layer kernel, plain, library and bound times of the config1
   generator layers at B=128 (the ``layer`` lines, which name the
   mainloop; config1 discriminator conv_1..3 at B=128 too, outside the
   per-predict sums), and of kernel 3 at each
   config5 layer that runs it at B=32 (the ``n3_layer`` lines, with the
   whole layer as the port splits it, as the fused conv kernel would run
   it, and as cuDNN + F.group_norm run it; each line gives kernel 3's plan,
   its registers and how many of its clusters the card holds at once, at
   the plan's size and at 16 blocks), then the same at the rollout's B=8.
   Kernel-level times are device times: 20 calls captured in a CUDA graph
   and replayed (``device_time_ms``).
7. The GroupNorm+activation backward kernel (kernel 4: one cluster launch,
   one thread-block cluster per sample, and a batch sum; csrc/gn_act_bwd.cu)
   against its plain version (``reference.gn_act_grads``) at every config1
   GroupNorm shape (B=8), at ragged shapes, at the 2 MB float32-y plane
   at B=2 (a cluster of 16) and at a plane past a cluster's shared memory
   (128x128x64, 8 MB a sample in bfloat16, 12 MB in float32: rows read
   twice, checked from the plan), for lrelu / relu / tanh / none: float32 within
   1e-4 abs + 1e-4 rel; bfloat16 dx within 1e-2 abs + 1e-2 rel of the plain
   version in float32 on the same inputs (one bfloat16 rounding of dx),
   dscale and dbias within the float32 bar; a second launch on the same
   inputs bit-identical (dx, dscale, dbias). The same with a bfloat16 y
   (the backward of kernel 3's layers) at kernel 3's shapes. The plan
   (``acg_gn_bwd_plan``) of every kernel-4 call of the whole run is held
   against its Python copy (``gn_bwd.gn_bwd_plan``) at the end.
8. Autograd parity in float32, TF32 off: every config1 G and D layer at B=4
   through the fused kernels' autograd Functions, and two split layers
   (config1 float32 D conv_3, config3 D conv_4) through the cuDNN conv and
   GroupNormActFn, against autograd of the plain composite on cuda; dx, dw,
   dscale, dbias within 1e-3 abs + 1e-3 rel.
9. The committed training fixture (tests/fixtures/torch_port_tiny_train.npz:
   the JAX package's tiny four-step run) replayed on cuda in float32; the
   (d_loss, g_loss, g_recon) trajectory within tests/test_golden.py's
   tolerances.
10. Training in bfloat16, T=1: config1 at B=128 with bfloat16 Adam moments
    (12 / 3 / 0 / 11 launches of kernels 1-4 per step, 9 of the 12 and 2
    of the 3 on wgmma, dec_0 narrow), then config3 at B=32 (128x128,
    d_extra_layers=1: 23 / 4 / 2 / 25, 20 of 23 and 3 of 4 on wgmma, kernel
    3 under
    autograd in the D update and the G head, kernel 4 reading its bfloat16
    input as y). Each: 3 warm-up steps; counts set to 0, one step, counts
    read and every kernel call of it recorded; then 20 steps timed with CUDA
    events and a torch.profiler breakdown of one step. Losses finite, both
    parameter sets moved, peak memory printed. Each distinct conv call and
    each kernel-3 call of the counted step held against its plain version
    as in phase 2 (bfloat16, 3e-2).
11. Per-call times of kernel 4 at the shapes of the config1 step and of
    the config3 step (the ``gnbwd_layer`` lines, with the call's plan and
    how many of its clusters the card holds at once), each checked against
    its plain version in float32 on the same inputs: dx within 1e-2 abs +
    1e-2 rel, dscale and dbias within 1e-4 of their largest magnitude +
    1e-4 rel.
12. The training loop through the ``train`` subcommand, in this process:
    config1 at B=128, bfloat16 moments, 16 steps a call, 64 steps, logs
    every 16, checkpoints and held-out rollouts every 32, 2 kept. Counts set
    to 0 just before and read just after: EXPECTED["config1 step"] x 64 plus
    EXPECTED["config1 serving"] for each held-out rollout's generator call
    (one at step 32, one at 64, B=8). Every metric line finite, checkpoints
    {32, 64} on disk, every batch a cuda tensor. The same command to 96
    resumes at 64; its parameters, moments and Adam counts are held
    bit for bit against an uninterrupted 96-step run (cuDNN in its
    deterministic algorithms for the three runs). ``train`` in a process of
    its own, SIGTERM after its first metric line: exit 0 and a checkpoint
    at the step it stopped at. The uninterrupted run traces steps 48-64
    (``--profile-steps 16``): its chrome trace must hold device kernels;
    their device ms and launches by chip_smoke's kernel table are printed
    (``profile: trace totals``) and the trace is kept for phase 17.
    Two more 96-step runs in cuDNN's default algorithms are compared with
    each other and the result printed (not checked).
    Then the synthetic data's ms per call (16 x 128 clips), one checkpoint
    save's ms (to the host, then torch.save), the loop's p50 dispatch
    cadence and the ``bench`` JSON line (config1 as above, 0 < roofline
    share <= 1), and bench's p50 with cudnn.deterministic on, each beside
    the card's name and power limit.

13. config4 training (64², state and action conditioning, B=64, T=10,
    bfloat16) with CONFIG4_OVERRIDES: EMA, D augmentation and a
    scheduled-sampling mix. The ``train`` subcommand for 32 steps (counts
    set to 0 just before and read just after: EXPECTED["config4 step"] x 32
    plus EXPECTED["config4 serving"] for each generator call of the
    held-out rollouts, of the parameters and of their EMA, at 16 and 32);
    its step-16 checkpoint resumed to 32 and held bit for bit against the
    uninterrupted run, g_ema included (cudnn.deterministic on); metric
    lines finite, ss_prob the schedule's, the ``*_ema`` held-out metrics
    present. Then, as phase 10, one counted step (48 / 30 / 0 / 56
    launches), every distinct conv and kernel-4 call of it against its
    plain version at phases 10 and 11's bars, 20 timed steps and a profile.
    Then in float32, TF32 off, B=2: the scheduled-sampling rollout with
    every step fed its prediction against ``Predictor.rollout``, and with
    none against the folded teacher-forced rollout, within 1e-5.
14. config5 training (256², B=32, T=30, remat, time chunks of 2) with
    CONFIG5_OVERRIDES (D in 4 chunks of 240 transitions): 2 warm-up steps,
    one counted step (92 / 0 / 266 / 223 launches: G's forward kernels
    twice under remat), every distinct call of kernels 1, 3 and 4 against
    its plain version (the kernel-4 calls that read rows twice print their
    plans), 3 timed steps, peak memory and a profile. Then at config5's
    widths, B=2, T=4, float32, TF32 off: G's gradients with remat against
    those without within 1e-5 relative (bit-identity printed), and
    disc_microbatch=2 against 0 within the JAX package's bars (losses rtol
    1e-5 / atol 1e-6, parameters atol 5e-6 / rtol 1e-4).

15. What ``train`` writes, served, in phase 13's directory: config4's
    step-32 checkpoint (EMA, state_dim 3, preset widths) restored by
    ``Predictor.from_checkpoint`` and with ``use_ema=True``, bit for bit what
    Predictors on the stored g_params / g_ema give (B=64 predict, T=10 B=16
    rollout); ``serve --workdir --ema --port 0`` in a process of its own,
    its /healthz, /predict and /rollout equal to the direct calls; ``export``
    to npz read back by ``from_npz`` with equal bits; ``export --format pt2
    --rollout-length 10``: the export traces EXPECTED["config4 serving"]'s
    routes 11 times and launches nothing, and ``AotPredictor`` on cuda
    (counts set to 0 just before, read just after) launches
    EXPECTED["config4 serving"] x 11 and gives the live predictor's bits;
    ``sample --num-clips 8`` writes its PNGs and GIFs (signatures checked)
    and ``eval`` gives finite metrics. config5 from seeded weights, its AOT
    program (predict and T=4) exported once on the CPU and once on cuda,
    both served on cuda: EXPECTED["config5 serving"] x 5 launches (kernel 3
    7 a generator call) and the live predictor's bits at B=32 and T=4 B=8.
    The export seconds, the artifacts' bytes, ``sample``'s and ``eval``'s
    seconds, and the AOT and live predictors' p50 predict ms (config1
    B=128, config5 B=32; CUDA events around each call, in turns live, AOT,
    AOT, live), beside the card's name and power limit.
16. The repairs of ROADMAP Queue 3. Fault 1: config5 at 512x512 with
    g_levels=6 and d_levels=7 (FAULT1_OVERRIDES), bfloat16 and float32, B=2:
    one predict and one training step (T=2) on cuda; the GroupNorms off
    kernel 3's envelope take the plain composite, counted in
    ROUTES["group_plain"] (FAULT1_GROUP_PLAIN, derived on meta tensors by
    tests/test_torch_routes.py), each within 1e-4 abs + 1e-4 rel (float32)
    or 3e-2 (bfloat16) of ``reference.norm_act`` in float32 on the same
    input; losses finite; peak memory printed. Fault 2: config2 (T=10, B=16,
    k=32) through ``train`` for 32 steps (counts set to 0 just before, read
    just after: EXPECTED["config2 step"] x 32 plus the held-out rollout's 10
    generator calls), then as phase 10 one counted step (12 / 3 / 0 / 11),
    its distinct conv and kernel-4 calls at phases 10 and 11's bars, 20
    timed steps and a profile.

17. Training on clip files (data.source=tfrecord_native): ``make-data``
    in two processes of their own writes 512 config1 clips (30 frames of
    64x64, raw, ~190 MB) and 64 held-out ones; they parse, and the TF-free
    reader's library is built under build/native/ with native/ unchanged
    (mtimes and hashes). ``train`` with phase 12's arguments, bf16 frames on
    the host and a checkpoint every 16 steps, for 32 steps (counts set to 0
    just before, read just after: EXPECTED["config1 step"] x 32 plus the
    held-out rollout's generator call; batches on cuda; held-out clips read
    from eval_data_dir), then a resume from its step-16 checkpoint
    bit-identical at step 32 under cudnn.deterministic (the file wraps
    inside every call); no reader thread outlives its loop. A ``file data``
    line: 64-step runs without checkpoints, the synthetic stream's p50
    cadence beside the files' read serially and on 4 decode threads, each
    with the fill thread's and the loop's wait ms a call, and from a trace
    of its last call the device's busy share and the H2D copies' device ms.
    ``doctor`` in its own process (exit 0; cuda, nvcc, the kernels' and the
    native build ok). ``profile-report --json`` on phase 12's trace: kernels
    1, 2 and 4's launches equal EXPECTED x 16 steps plus the held-out
    generator call, and kernels 1-2's and kernel 4's device ms within 2% of
    phase 12's own ``profile: trace totals`` line (chip_smoke's kernel table).
18. R1, batch norm and the engine knobs (PHASE18_OVERRIDES). The committed
    JAX fixture tests/fixtures/torch_port_tiny_r1_bn.npz (a tiny four-step
    run with R1 and one with batch norm) replayed on cuda in float32 within
    tests/test_golden.py's tolerances (d_r1 at d_loss's). (a) config1 with
    train.r1_weight=10: ``train`` with phase 12's arguments for 32 steps
    (counts set to 0 just before, read just after: EXPECTED["config1 r1
    step"] x 32, R1's inner D call on the plain route, 4 conv blocks a step
    in ROUTES["plain"], plus the held-out rollout's generator call), d_r1
    finite and positive on every metric line; one counted step, 20 timed
    steps, a profile, peak memory; then in float32 with float32 moments at
    B=4 one R1 step on cuda against the CPU's plain path (d_r1 within 1e-4
    relative, D's first moments within 1e-4 + 1e-3 rel) and, cuDNN off,
    disc_microbatch=2 against 0 at tests/test_train_step.py's R1 bars.
    (b) config1 with model.norm=batch: ``train`` likewise (EXPECTED["config1
    bn step"]: every batch-norm layer split, its conv a bare kernel-1 / 2
    call, 14 a step, D run on real and fake apart); one counted step whose
    distinct conv calls are held to their plain versions (bfloat16 3e-2;
    the bare ones also in float32 within 1e-3 + 1e-3 rel); a step with
    disc_microbatch=64 bit-identical to one without (cudnn.deterministic);
    Predictor.predict at B=128 and a T=10 B=16 rollout counted against
    EXPECTED["config1 bn serving"]. (c) config5 as phase 14 trains it with
    deconv=subpixel + conv0=s2d, and with wgrad=patches (the configs refuse
    either rewrite beside patches): 2 warm-up steps, one counted step (the
    engines' rewrites and im2col products in ROUTES: EXPECTED_ROUTES), 3
    timed steps, peak memory, a profile; at config5's widths, B=2, T=4,
    float32, each engine's step against the default step (see
    ``phase_engines_reduced``); each rewrite alone at config5's split shapes
    against the plain op (``phase_rewrites_alone``). (d) The phase's wall
    seconds.
19. Data parallelism (``parallel/``). (a) An NCCL group of one rank in this
    process: config1's step (B=128) through ``make_dp_train_step`` against
    the step without a group, 3 steps bit for bit under
    cudnn.deterministic, then both timed in turns (the all-reduces' cost);
    ``train`` over the group (phase 12's arguments, 32 steps, counted)
    against ``train`` without one, the step-32 checkpoints bit for bit.
    (b, c) Two gloo ranks, processes of this script (``--dp-rank``) sharing
    cuda:0: PHASE19_PATHS (config1 B=128 and config3 B=32 in bfloat16 and
    float32, config1 with batch norm in float32), 3 steps on each rank's
    half of the batch against the one-rank step on the whole batch here:
    bfloat16 losses within 3e-2 relative; float32 (cuDNN off, D's lr 0)
    G's and D's averaged gradients within 1e-4 normwise and the losses
    within 2e-4 relative, or twice the one-rank step's own spread over
    reordered clips where larger (batch norm's), the parameter entries
    beyond 5e-5 counted; the ranks' parameters bit for bit equal; each
    rank's first step counted against EXPECTED[path]. (d)
    ``train`` on two gloo ranks over two clip files (one a rank), 32 steps,
    and 16 resumed to 32: rank 0 alone prints, each rank's launches
    counted, the resumed step-32 checkpoint bit for bit the uninterrupted
    one's. (e) ``Predictor.with_mesh`` and ``AotPredictor(mesh=)`` over
    [cuda:0, cuda:0]: config1 bf16 predict B=128 and rollout T=10 B=16 bit
    for bit against one device (launches counted), config5 float32 within
    1e-3. Its times are correctness runs (two processes share one card).
20. Channel tensor parallelism (``parallel/tp.py``). (a-c) Gloo ranks,
    processes of this script (``--tp-rank``) sharing cuda:0, each holding
    its channel shard of the state and its data index's rows:
    PHASE20_PATHS (config1 B=128 in bfloat16 and float32 and config3 B=32
    on the 1x2 mesh, two ranks; config1 B=128 on 2x2, four), 3 steps
    against the one-rank step on the whole batch here at phase 19's bars;
    the replicated parameters bit for bit equal on every rank, each shard on
    the ranks of its model index; each rank's first step counted against
    EXPECTED[path], every kernel call recorded. (d) ``train`` on the 1x2
    mesh (phase 12's arguments, ``mesh.model=2``): 16 steps resumed to 32
    bit for bit equal to 32 uninterrupted; the step-32 checkpoint is the
    state the ranks gather, bit for bit, restored by a one-rank
    ``Predictor.from_checkpoint`` and resumed by a one-rank ``train`` (16
    steps, counted). (e) ``Predictor`` over the grid [[cuda:0, cuda:0]]:
    config5 predict B=32 and rollout T=30 B=8 against one device within
    3e-2 (counted), float32 within 1e-4. Then every distinct shard-shaped
    call of kernels 1-4 recorded in (a-c) and (e) against its plain version
    at phases 10 and 11's bars. Its times are correctness runs: the ranks
    share one card and gloo moves every gather through the host.
21. The serving half of ``bench`` (``bench.py``) at the reference's four
    serving geometries, bfloat16, seeded weights: ``run_infer_bench`` at
    config1 B=128 (k=32), config2 as the preset is (B=16, T=10) and config5
    B=8 (k=4, T=30), ``run_serving_bench`` at config1 B=128, T=10; each
    line printed with the card's name and power limit, its keys the
    reference line's plus ``peak_memory_gb``, every time and rate finite
    and positive; counts set to 0 just before each call and read just
    after, against EXPECTED ("config1 serving" for config1 and config2,
    "config5 serving") times every generator call of its windows. The
    config1 T=10 program exported (timed) and its B=128 rollout
    bit-identical to the live predictor's (counted). ROADMAP Queue 3 fault
    3: config1 with batch norm in float32 served over [cuda:0, cuda:0]
    (live and AOT) and [[cuda:0, cuda:0]] within 1e-5 of one device. Then
    ``bench --mode infer`` and ``--mode serving`` (config1 B=128, T=10) as
    processes of their own, one JSON line each.
22. ``train.flatten_optimizer`` (the JAX package's ``optax.flatten``):
    kernel 5 (``csrc/adam_flat.cu``, one fused clip-and-Adam pass over a
    flat vector) against its plain version at config1's and config5's G and
    D sizes (1,917,635 / 2,772,801 / 16,283,331 / 19,019,457), float32 and
    bfloat16 moments, with and without clipping, over 3 updates: the largest
    ULP distance and the entries that differ of p, mu and nu (bar 1 ULP);
    its device time (CUDA-graph replay), the plain version's, one
    ``torch._fused_adam_`` call over the same tensor (float32 moments) and
    the bound (28 or 20 bytes a parameter over the memory rate), the
    ``adam_layer`` lines. The config1 step (B=128) flat against per-tensor
    under cudnn.deterministic, 3 steps, float32 and bfloat16 moments, within
    atol 1e-9 + rtol 1e-6 (the bfloat16 flat steps counted: EXPECTED["config1
    flat step"] x 3), the Adam launches a step of both layouts (profiler, in
    a process of its own: ``chip_smoke.py --adam-launches``; the device's
    kernels must equal the host's launch calls) and their step
    times in turns. A flat ``train`` (phase 12's arguments, 48
    steps, counted) against one stopped by SIGTERM after its first call and
    resumed: bit for bit; its checkpoint served through
    ``Predictor.from_checkpoint``. A world-1 NCCL DP step with the flat
    layout, bit for bit against the step without a group (counted); the
    ``bench`` line of the flat path (phase 12's settings). Kernel
    times take turns over copies of the operands, so that each launch finds
    its own out of L2.

Then a ``kernels`` JSON line (per kernel: launches summed over every main
path, the config2, config4 and config5 steps, the config1 file, config2 and
config4 loops, the AOT programs, phase 18's paths, phases 19 and 20's ranks,
phase 21's benches and phase 22's flat paths included; max |err|,
kernel, plain, bound and library
times; kernel 4's over the config1 step's calls, and its config3 step's sums
beside them; kernel 5's over config1's G and D vectors with bfloat16
moments, the main path's, with its float32 and config5 numbers beside), then
the final line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_tiny_generator.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_tiny_train.npz")
R1_BN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_tiny_r1_bn.npz")
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_INFO = {
    "conv_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:177",
    ),
    "conv_transpose_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/conv_transpose_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/conv.py:392",
    ),
    "group_norm_act": dict(
        source="action_conditioned_gans_tpu_torch/csrc/group_norm_act.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/norm_act.py:59",
    ),
    "gn_act_bwd": dict(
        source="action_conditioned_gans_tpu_torch/csrc/gn_act_bwd.cu",
        replaces="action_conditioned_gans_tpu/ops/pallas/gn_bwd.py:120",
    ),
    # No Pallas counterpart: the XLA fusion of the reference's
    # optax.flatten(inner) optimizer chain (train.flatten_optimizer).
    "adam_flat": dict(
        source="action_conditioned_gans_tpu_torch/csrc/adam_flat.cu",
        replaces="action_conditioned_gans_tpu/train/state.py:182 (optax.flatten's fused "
                 "update; no Pallas kernel)",
    ),
}
# Per main path: each kernel's launches per generator call (serving) or per
# training step; kernels 1 and 2's launches by mainloop (kernel 1: wgmma,
# and WMMA for the first layers, Cin 3 and 10; kernel 2: wgmma, and narrow
# for dec_0); and the (fused, split) routes its conv blocks took, as the JAX
# package's envelope decides them (tests/test_torch_envelope.py,
# tests/test_torch_conv_wgmma.py, tests/test_torch_conv_transpose_wgmma.py).
EXPECTED = {
    "config1 serving": (dict(conv_norm_act=4, conv_transpose_norm_act=3, group_norm_act=0,
                             gn_act_bwd=0),
                        dict(conv_norm_act=dict(wgmma=3, wmma=1),
                             conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (7, 0)),
    "config1 step": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                          gn_act_bwd=11),
                     dict(conv_norm_act=dict(wgmma=9, wmma=3),
                          conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (15, 0), 0),
    # config2 (T=10, B=16): one generator call over the 160 transitions of the
    # teacher-forced fold, D at 320 (update) and 160 (G head): config1's layers
    # at other batches. Its generator is config1's (the same ModelConfig), so
    # its held-out rollouts count as "config1 serving".
    "config2 step": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                          gn_act_bwd=11),
                     dict(conv_norm_act=dict(wgmma=9, wmma=3),
                          conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (15, 0), 0),
    "config5 serving": (dict(conv_norm_act=2, conv_transpose_norm_act=0, group_norm_act=7,
                             gn_act_bwd=0),
                        dict(conv_norm_act=dict(wgmma=2)), (2, 9)),
    "config3 step": (dict(conv_norm_act=23, conv_transpose_norm_act=4, group_norm_act=2,
                          gn_act_bwd=25),
                     dict(conv_norm_act=dict(wgmma=20, wmma=3),
                          conv_transpose_norm_act=dict(wgmma=3, narrow=1)), (27, 2), 2),
    # config4: 10 generator calls a step (kernel 1 on wgmma for enc_1 / enc_2,
    # WMMA for enc_0 and the 263-channel bottleneck), D once in the update
    # (B*T*2 = 1280) and once in the G head (640).
    "config4 serving": (dict(conv_norm_act=4, conv_transpose_norm_act=3, group_norm_act=0,
                             gn_act_bwd=0),
                        dict(conv_norm_act=dict(wgmma=2, wmma=2),
                             conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (7, 0)),
    "config4 step": (dict(conv_norm_act=48, conv_transpose_norm_act=30, group_norm_act=0,
                          gn_act_bwd=56),
                     dict(conv_norm_act=dict(wgmma=26, wmma=22),
                          conv_transpose_norm_act=dict(wgmma=20, narrow=10)), (78, 0), 0),
    # config5 with disc_microbatch=240: 15 generator calls of 64 transitions
    # (time chunks of 2), each run twice (remat), D in 4 chunks of 480 in the
    # update and 4 of 240 in the G head.
    "config5 step": (dict(conv_norm_act=92, conv_transpose_norm_act=0, group_norm_act=266,
                          gn_act_bwd=223),
                     dict(conv_norm_act=dict(wgmma=92)), (92, 334), 161),
    # Phase 18. R1 adds a plain-route D call on the real half (EXPECTED_ROUTES);
    # its kernels are the config1 step's.
    "config1 r1 step": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                             gn_act_bwd=11),
                        dict(conv_norm_act=dict(wgmma=9, wmma=3),
                             conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (15, 0), 0),
    # Batch norm: enc_0, dec_0 and D conv_0 fused; every batch-norm layer
    # split, its conv a bare kernel-1 / kernel-2 call; D twice in the update
    # (real, fake) and once in the G head; no GroupNorm, so no kernel 4.
    "config1 bn step": (dict(conv_norm_act=16, conv_transpose_norm_act=3, group_norm_act=0,
                             gn_act_bwd=0),
                        dict(conv_norm_act=dict(wgmma=12, wmma=4),
                             conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (5, 14), 0),
    "config1 bn serving": (dict(conv_norm_act=4, conv_transpose_norm_act=3, group_norm_act=0,
                                gn_act_bwd=0),
                           dict(conv_norm_act=dict(wgmma=3, wmma=1),
                                conv_transpose_norm_act=dict(wgmma=2, narrow=1)), (2, 5)),
    # The engines change no kernel call of the config5 step: they rewrite
    # its split convs (EXPECTED_ROUTES).
    "config5 engines step": (dict(conv_norm_act=92, conv_transpose_norm_act=0, group_norm_act=266,
                                  gn_act_bwd=223),
                             dict(conv_norm_act=dict(wgmma=92)), (92, 334), 161),
    "config5 patches step": (dict(conv_norm_act=92, conv_transpose_norm_act=0, group_norm_act=266,
                                  gn_act_bwd=223),
                             dict(conv_norm_act=dict(wgmma=92)), (92, 334), 161),
    # Phase 19: one rank's step of two, on half the batch, in float32 (kernels 1-2
    # on their FMA mainloop; the float32 envelope splits config1 D conv_3, and
    # config3 G enc_3 / bottleneck / dec_3 and D conv_3 / conv_3_extra_0 / conv_4
    # / conv_4_extra_0; with batch norm 11 of the 14 split convs run bare). The
    # bfloat16 ranks' steps are "config1 step" / "config3 step" as they are.
    "config1 f32 step": (dict(conv_norm_act=10, conv_transpose_norm_act=3, group_norm_act=2,
                              gn_act_bwd=11),
                         dict(conv_norm_act=dict(fma=10), conv_transpose_norm_act=dict(fma=3)),
                         (13, 2), 0),
    "config3 f32 step": (dict(conv_norm_act=15, conv_transpose_norm_act=3, group_norm_act=11,
                              gn_act_bwd=25),
                         dict(conv_norm_act=dict(fma=15), conv_transpose_norm_act=dict(fma=3)),
                         (18, 11), 0),
    "config1 bn f32 step": (dict(conv_norm_act=13, conv_transpose_norm_act=3, group_norm_act=0,
                                 gn_act_bwd=0),
                            dict(conv_norm_act=dict(fma=13), conv_transpose_norm_act=dict(fma=3)),
                            (5, 14), 0),
    # Phase 20: one rank's step of a (data, model) mesh on its channel shard
    # (parallel/tp.py), and a generator call of a serving grid's row (each
    # sharded layer once a column). Each shard is routed as a layer of its
    # width: at Cout/2, config1's dec_1 (32 channels) takes kernel 2's WMMA
    # mainloop; config3's split layers fuse on their shards (no kernel 3);
    # config5's 64-channel shards fuse where the full layers split, and its
    # other split layers run kernel 3 on 2 x 4 shards, 7 of 21 block calls
    # staying split. dec_0 (3 channels) stays whole.
    "config1 step tp2": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                              gn_act_bwd=11),
                         dict(conv_norm_act=dict(wgmma=9, wmma=3),
                              conv_transpose_norm_act=dict(wgmma=1, wmma=1, narrow=1)),
                         (15, 0), 0),
    "config1 f32 step tp2": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                                  gn_act_bwd=11),
                             dict(conv_norm_act=dict(fma=12), conv_transpose_norm_act=dict(fma=3)),
                             (15, 0), 0),
    "config3 step tp2": (dict(conv_norm_act=25, conv_transpose_norm_act=4, group_norm_act=0,
                              gn_act_bwd=25),
                         dict(conv_norm_act=dict(wgmma=20, wmma=5),
                              conv_transpose_norm_act=dict(wgmma=2, wmma=1, narrow=1)),
                         (29, 0), 0),
    "config1 step dp2tp2": (dict(conv_norm_act=12, conv_transpose_norm_act=3, group_norm_act=0,
                                 gn_act_bwd=11),
                            dict(conv_norm_act=dict(wgmma=9, wmma=3),
                                 conv_transpose_norm_act=dict(wgmma=1, wmma=1, narrow=1)),
                            (15, 0), 0),
    "config5 tp2 serving": (dict(conv_norm_act=10, conv_transpose_norm_act=6, group_norm_act=4,
                                 gn_act_bwd=0),
                            dict(conv_norm_act=dict(wgmma=8, wmma=2),
                                 conv_transpose_norm_act=dict(wgmma=6)), (16, 5)),
}
# Kernel 5 (adam_flat) runs only with train.flatten_optimizer: 0 launches on
# every path above.
for _launches, *_ in EXPECTED.values():
    _launches["adam_flat"] = 0
# Phase 22: config1 as phase 10 trains it with train.flatten_optimizer: the
# config1 step's kernels, and one adam_flat launch for D's update and one
# for G's.
EXPECTED["config1 flat step"] = (dict(EXPECTED["config1 step"][0], adam_flat=2),
                                 *EXPECTED["config1 step"][1:])
# The routes beside (fused, split) per generator call or step, 0 where not
# given (ops/api.py): "bare" split convs on kernel 1 or 2, "plain" conv
# blocks of R1's inner D call, "s2d" / "subpixel" convs rewritten (G enc_0
# and D conv_0 under remat and microbatching: 30 + 8; G dec_4..0: 5 x 30),
# "patches" im2col weight gradients (G's 11 layers x 15 calls, D's 12 x 4
# chunks in the update; the G head's D is frozen). Derived on meta tensors
# by tests/test_torch_train_paths.py.
EXPECTED_ROUTES = {
    "config1 r1 step": dict(plain=4),
    "config1 bn step": dict(bare=14),
    "config1 bn serving": dict(bare=5),
    "config5 engines step": dict(s2d=38, subpixel=150),
    "config5 patches step": dict(patches=213),
    "config1 bn f32 step": dict(bare=11),
}
# Phase 13's overrides of config4 (B=64, T=10, k=16 as the preset has them):
# EMA, D augmentation, and a scheduled-sampling schedule that mixes from the
# start (the preset anneals from 0 over 50,000 steps, near 0 in a short run).
CONFIG4_OVERRIDES = ["train.ema_decay=0.999", "train.d_augment=color,translation,cutout",
                     "train.ss_start_prob=0.5"]
# Phase 14's override of config5 (remat, time chunks of 2, B=32, T=30): D in
# chunks of 240 of the 960 transitions, so that one card holds the step.
CONFIG5_OVERRIDES = ["train.disc_microbatch=240"]
# Phase 16's model for ROADMAP Queue 3 fault 1: config5 at 512x512 with a
# sixth G level and a seventh D level, B=2, T=2. Some of its GroupNorms lie
# off kernel 3's envelope and take the plain composite (ROUTES["group_plain"]):
# (in one generator call, in one training step with remat), derived on meta
# tensors by tests/test_torch_routes.py.
FAULT1_OVERRIDES = ["model.image_size=512", "model.g_levels=6", "model.d_levels=7",
                    "train.batch_size=2", "train.rollout_length=2"]
FAULT1_GROUP_PLAIN = (3, 12)  # in bfloat16 and in float32 alike
# Phase 18's paths: config1 as phase 12 trains it (B=128, bfloat16 moments)
# with R1 or batch norm, config5 as phase 14 trains it with the engines.
# deconv="subpixel" and conv0="s2d" go together; wgrad="patches" excludes
# both (the configs refuse the pairs, as the JAX package's do).
PHASE18_OVERRIDES = {
    "config1 r1 step": ["train.r1_weight=10"],
    "config1 bn step": ["model.norm=batch"],
    "config5 engines step": ["model.deconv=subpixel", "model.conv0=s2d"],
    "config5 patches step": ["model.wgrad=patches"],
}
# A step path's fourth field: its kernel-4 calls that read a bfloat16 y (the
# split layers' backward; kernel 3's launches less the remat recompute's).
# tests/test_golden.py's tolerances on (d_loss, g_loss, g_recon): (atol, rtol).
GOLDEN_TOL = ((2e-4, 1e-3), (2e-3, 1e-3), (2e-4, 1e-3))
TRAJECTORY = ("d_loss", "g_loss", "g_recon")


def say(*parts):
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed, so the host's launch rate (which varies from machine to
    machine) does not enter. For kernel-level numbers; end-to-end calls use
    :func:`cuda_time_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def card_state() -> str:
    """SM clock, its maximum, temperature and power draw, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- layer shapes of the main path ---------------------------------------------


def capture_layers(model, run, prefix=""):
    """(block name, ConvBlock, input shape) of every layer of ``model``, as
    ``run()`` calls them, recorded by forward pre-hooks."""
    seen = []
    hooks = [
        block.register_forward_pre_hook(
            lambda mod, args, name=prefix + name: seen.append((name, mod, tuple(args[0].shape)))
        )
        for name, block in model.named_children()
    ]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def discriminator_layers(batch=8):
    """The config1 discriminator's four layers at ``batch``, bfloat16."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.models import Discriminator

    m = get_preset("config1").model
    disc = Discriminator(m, generator=torch.Generator().manual_seed(3)).cuda()
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy(np.tanh(rng.standard_normal((batch, 64, 64, 3))).astype(np.float32)).cuda()
              for _ in range(2)]
    action = torch.from_numpy(rng.standard_normal((batch, 4)).astype(np.float32)).cuda()
    with torch.inference_mode():
        return capture_layers(disc, lambda: disc(frames[0], frames[1], action), prefix="D.")


def call_inputs(x_shape, w_shape, kind, dtype, seed):
    """Random operands for one conv call: x ~ N(0, 1), w ~ N(0, 1/fan_in) so
    the conv output is O(1), scale ~ 1 + 0.1 N, bias ~ 0.1 N."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, cin, cout = w_shape
    x = torch.randn(x_shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((kh, kw, cin, cout), generator=g, device="cuda") / (kh * kw * cin) ** 0.5
    scale = 1 + 0.1 * torch.randn(cout, generator=g, device="cuda") if kind != "none" else None
    bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
    return x, w, scale, bias


def layer_inputs(block, shape, batch, dtype, seed):
    return call_inputs((batch, *shape[1:]), tuple(block.kernel.shape), block.norm, dtype, seed)


def kernel_call(block):
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    name = "conv_transpose_norm_act" if block.transpose else "conv_norm_act"
    kw = dict(stride=block.stride, kind=block.norm, groups=block.groups, act=block.act,
              leak=block.leak)
    kernel, plain = getattr(conv, name), getattr(conv, f"{name}_plain")
    return (
        name,
        lambda x, w, s, b: kernel(x, w, s, b, **kw),
        lambda x, w, s, b: plain(x, w, s, b, **kw),
    )


def library_call(block, x, w, scale, bias):
    """One cuDNN conv + F.group_norm + activation on channels-last views of
    the same operands: the yardstick, never called by the port."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups

    xn = x.permute(0, 3, 1, 2)
    if block.transpose:
        wt = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1).contiguous()
        conv = lambda: F.conv_transpose2d(xn, wt, stride=2, padding=1)  # noqa: E731
    else:
        wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        pad = (w.shape[0] - 1) // 2 if block.stride == 1 else 1
        conv = lambda: F.conv2d(xn, wt, stride=block.stride, padding=pad)  # noqa: E731
    acts = {"lrelu": lambda t: F.leaky_relu(t, block.leak), "relu": F.relu, "tanh": torch.tanh}

    def run():
        y = conv()
        if block.norm == "group":
            y = F.group_norm(y, resolve_groups(w.shape[3], block.groups), scale.to(y.dtype),
                             bias.to(y.dtype))
        else:
            y = y + bias.to(y.dtype)[:, None, None]
        return acts[block.act](y)

    return run


def work(block, shape, itemsize):
    """(FLOPs, bytes) one call needs: each input read once, the output
    written once."""
    b, h, w, cin = shape
    kh, kw, _, cout = block.kernel.shape
    if block.transpose:
        oh, ow = 2 * h, 2 * w
        flops = 2 * b * h * w * kh * kw * cin * cout
    else:
        oh, ow = -(-h // block.stride), -(-w // block.stride)
        flops = 2 * b * oh * ow * kh * kw * cin * cout
    nbytes = (b * h * w * cin + kh * kw * cin * cout + b * oh * ow * cout) * itemsize
    nbytes += (2 if block.norm != "none" else 1) * cout * 4
    return flops, nbytes


# -- phases ----------------------------------------------------------------------


def edge_layers():
    """Shapes off the main path that stress masking: odd and non-square
    planes, channel counts that are no multiple of 8, groups of 2-4
    channels, narrow bfloat16 tiles with GroupNorm; the edges of kernel 1's
    wgmma mainloop (tests/test_torch_conv_wgmma.py): 8-byte copies (Cin 12,
    20), K no multiple of 64 (108, 180), planes of 25 and 144 rows (BM 64,
    128 with a partial second tile), Cout 192 as three 64-wide tiles, the
    64 x 256 tile (128 blocks) on a 25-row plane; and kernel 2's
    (tests/test_torch_conv_transpose_wgmma.py): wgmma on a 5x6 plane with Cin
    12 on 8-byte copies (K 48: one partial stage) and Cout 192, the 64 x 256
    tile on config3's dec_3 at B=32 (128 blocks); the narrow mainloop at B=3
    with 8-row bands over 10 rows (Cin 20: copied by channel, padded to 32),
    and with Cout 16 (two 8-wide n-tiles) on a 7x9 plane."""
    from action_conditioned_gans_tpu_torch.models.common import ConvBlock

    return [
        ("edge_k4s2_odd", ConvBlock(5, 12, kernel=4, stride=2, groups=4), (3, 9, 9, 5)),
        ("edge_k3s1_none", ConvBlock(7, 5, kernel=3, stride=1, norm="none", act="tanh"),
         (3, 7, 10, 7)),
        ("edge_t_gn8", ConvBlock(6, 8, transpose=True, groups=4, act="relu"), (3, 5, 6, 6)),
        ("edge_t_gn80", ConvBlock(20, 80, transpose=True, groups=32), (2, 3, 3, 20)),
        ("edge_wg_av4", ConvBlock(12, 192, kernel=3, stride=1), (3, 5, 5, 12)),
        ("edge_wg_bm128", ConvBlock(20, 128, kernel=3, stride=1, act="relu"), (2, 12, 12, 20)),
        ("edge_wg_none", ConvBlock(16, 64, kernel=4, stride=2, norm="none", act="tanh"),
         (3, 9, 9, 16)),
        ("edge_wg_bn64", ConvBlock(16, 192, kernel=4, stride=2), (2, 24, 24, 16)),
        ("edge_wg_bn256", ConvBlock(12, 256, kernel=3, stride=1), (128, 5, 5, 12)),
        ("edge_tw_odd", ConvBlock(12, 192, transpose=True), (3, 5, 6, 12)),
        ("edge_tw_bn256", ConvBlock(512, 256, transpose=True), (32, 8, 8, 512)),
        ("edge_tn_band", ConvBlock(20, 3, transpose=True, norm="none", act="tanh"),
         (3, 10, 16, 20)),
        ("edge_tn_c16", ConvBlock(16, 16, transpose=True, norm="none", act="lrelu"),
         (2, 7, 9, 16)),
    ]


def preset_conv_layers(preset, batch=2):
    """Kernels 1 and 2's distinct fused layers of ``preset``'s G and D in
    bfloat16, as (name, ConvBlock, input shape): the models run on the meta
    device, routed as on the card."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
    from action_conditioned_gans_tpu_torch.ops import envelope

    m = get_preset(preset).model
    with torch.device("meta"):
        gen, disc = Generator(m), Discriminator(m)
        s = m.image_size
        frame = torch.empty(batch, s, s, m.image_channels)
        action = torch.empty(batch, m.action_dim)
        with torch.no_grad():
            seen = capture_layers(gen, lambda: gen(frame, action), prefix=f"{preset}.G.")
            seen += capture_layers(disc, lambda: disc(frame, frame, action), prefix=f"{preset}.D.")
    layers, keys = [], set()
    for name, block, shape in seen:
        key = (shape[1:], tuple(block.kernel.shape), block.stride, block.transpose, block.norm,
               block.act)
        if key in keys or envelope.route(
                shape, tuple(block.kernel.shape), block.stride, block.transpose, block.norm,
                block.groups, torch.bfloat16) != "fused":
            continue
        keys.add(key)
        layers.append((name, block, shape))
    return layers


def mainloop_of(fn):
    """Runs ``fn`` and returns the kernel-1 / kernel-2 mainloop(s) it
    launched."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    before = dict(conv.LAUNCHES_BY_MAINLOOP)
    out = fn()
    ran = [k.split(":")[1] for k, v in conv.LAUNCHES_BY_MAINLOOP.items() if v > before[k]]
    return out, "+".join(ran) or "-"


def phase_parity(layers, batch=8):
    """Kernel vs plain version on the same inputs; returns the worst
    bfloat16 |err| per kernel over ``layers``."""
    worst = {}
    for i, (lname, block, shape) in enumerate(layers):
        name, kernel, plain = kernel_call(block)
        with torch.inference_mode():
            x, w, s, b = layer_inputs(block, shape, batch or shape[0], torch.float32, seed=100 + i)
            got, want = kernel(x, w, s, b), plain(x, w, s, b)
            torch.cuda.synchronize()
            err32 = float((got - want).abs().max())
            ok32 = bool(((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all())
            xb = x.to(torch.bfloat16)
            wb = w.to(torch.bfloat16)
            got16, mainloop = mainloop_of(lambda: kernel(xb, wb, s, b))
            want16 = plain(xb.float(), wb.float(), s, b)
            torch.cuda.synchronize()
            err16 = float((got16.float() - want16).abs().max())
        say(f"parity {lname:14s} {name:24s} x{tuple(x.shape)} f32 max|d|={err32:.3e} "
            f"bf16 max|d|={err16:.3e} ({mainloop})")
        check(ok32 and np.isfinite(err32), f"{lname}: float32 kernel vs plain beyond 1e-3")
        check(err16 <= 3e-2, f"{lname}: bfloat16 kernel vs plain beyond 3e-2 ({err16})")
        worst[name] = max(worst.get(name, 0.0), err16)
    return worst


def phase_fixture():
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    buf = io.BytesIO()
    np.savez(buf, **{k: v for k, v in arrays.items() if not k.startswith("fixture/")})
    buf.seek(0)
    p = Predictor.from_npz(buf, device="cuda")
    check(p.cfg.model.compute_dtype == "float32", "fixture is not float32")
    pred = p.predict(arrays["fixture/frame"], arrays["fixture/action"]).cpu().numpy()
    roll = p.rollout(arrays["fixture/frame"], arrays["fixture/actions"]).cpu().numpy()
    e_pred = float(np.abs(pred - arrays["fixture/predict"]).max())
    e_roll = float(np.abs(roll - arrays["fixture/rollout"]).max())
    say(f"fixture (JAX tiny generator) on cuda f32: predict max|d|={e_pred:.3e} "
        f"rollout max|d|={e_roll:.3e}")
    check(e_pred <= 1e-3 and e_roll <= 1e-3, "JAX fixture not reproduced within 1e-3")

    # Full config1 width: the kernel path on cuda against the plain path on
    # the CPU, same weights, float32.
    c1 = get_preset("config1")
    cfg = dataclasses.replace(c1, model=dataclasses.replace(c1.model, compute_dtype="float32"))
    params = seeded_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    frame = np.tanh(rng.standard_normal((4, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((4, 4)).astype(np.float32)
    on_gpu = Predictor(cfg, params, device="cuda").predict(frame, action).cpu().numpy()
    on_cpu = Predictor(cfg, params, device="cpu").predict(frame, action).numpy()
    e_full = float(np.abs(on_gpu - on_cpu).max())
    say(f"config1 generator f32, cuda kernels vs cpu plain: max|d|={e_full:.3e}")
    check(e_full <= 1e-3, "config1 generator on cuda differs from the CPU plain path")


def seeded_params(cfg, seed):
    """Flax-layout numpy weights in the JAX init distribution, from a seed."""
    from action_conditioned_gans_tpu_torch.convert import state_dict_to_flax
    from action_conditioned_gans_tpu_torch.models import Generator

    gen = Generator(cfg.model, generator=torch.Generator().manual_seed(seed))
    return state_dict_to_flax(gen.state_dict())


def preset_predictor(name):
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    cfg = get_preset(name)
    check(cfg.model.compute_dtype == "bfloat16", f"{name} does not serve in bfloat16")
    return Predictor(cfg, seeded_params(cfg, seed=0), device="cuda")


def phase_config5_f32():
    """The full-width config5 generator in float32 at B=1: cuda (in float32
    every layer is split: the cuDNN conv, then kernel 3 where it has a
    GroupNorm) against the same weights on the CPU's plain path, within
    1e-3."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    c5 = get_preset("config5")
    cfg = dataclasses.replace(c5, model=dataclasses.replace(c5.model, compute_dtype="float32"))
    params = seeded_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    frame = np.tanh(rng.standard_normal((1, 256, 256, 3))).astype(np.float32)
    action = rng.standard_normal((1, 4)).astype(np.float32)
    on_gpu = Predictor(cfg, params, device="cuda").predict(frame, action).cpu().numpy()
    on_cpu = Predictor(cfg, params, device="cpu").predict(frame, action).numpy()
    e = float(np.abs(on_gpu - on_cpu).max())
    say(f"config5 generator f32 B=1, cuda kernels vs cpu plain: max|d|={e:.3e}")
    check(np.isfinite(e) and e <= 1e-3, "config5 generator on cuda differs from the CPU plain path")


def reset_launches():
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.ops.kernels import adam, conv, gn_bwd, norm_act

    conv.reset_launches()
    norm_act.reset_launches()
    gn_bwd.reset_launches()
    adam.reset_launches()
    api.reset_routes()


def read_launches():
    from action_conditioned_gans_tpu_torch.ops.kernels import adam, conv, gn_bwd, norm_act

    return {**conv.LAUNCHES, **norm_act.LAUNCHES, **gn_bwd.LAUNCHES, **adam.LAUNCHES,
            **conv.LAUNCHES_BY_MAINLOOP}


def check_counts(path, launches, times):
    """The launch and route counts of ``times`` generator calls or training
    steps on ``path`` against EXPECTED."""
    check_runs(path, launches, {path: times})


def check_runs(label, launches, runs, routes=None):
    """The launch and route counts of a run made of ``runs`` ({EXPECTED path:
    generator calls or training steps}) against the sum of EXPECTED over it;
    ``routes`` are this process's ``ops.api.ROUTES`` unless given (a rank's,
    read in its own process)."""
    from action_conditioned_gans_tpu_torch.ops import api

    routes = dict(api.ROUTES) if routes is None else routes
    say(f"main path {label}: launches {launches}, routes {routes} over "
        + ", ".join(f"{n} {'steps' if 'step' in p else 'generator calls'} of {p}"
                    for p, n in runs.items()))
    check_launches(label, launches, runs)
    want = dict.fromkeys(api.ROUTES, 0)  # no preset has a GroupNorm off kernel 3's envelope
    for p, n in runs.items():
        want["fused"] += EXPECTED[p][2][0] * n
        want["split"] += EXPECTED[p][2][1] * n
        for route, per in EXPECTED_ROUTES.get(p, {}).items():
            want[route] += per * n
    check(routes == want, f"{label}: routes {routes}, want {want}")


def check_launches(label, launches, runs):
    """Kernels 1-5's launches, and kernels 1-2's by mainloop, against the sum
    of EXPECTED over ``runs``."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    for name in KERNEL_INFO:
        want = sum(EXPECTED[p][0][name] * n for p, n in runs.items())
        check(launches[name] == want, f"{label}: {name} launched {launches[name]} times, want {want}")
    by = {k: launches[k] for k in conv.LAUNCHES_BY_MAINLOOP}
    want = {k: sum(EXPECTED[p][1].get(k.split(":")[0], {}).get(k.split(":")[1], 0) * n
                   for p, n in runs.items()) for k in by}
    check(by == want, f"{label}: kernels 1-2 by mainloop {by}, want {want}")


def phase_serving(predictor, path, batch, horizon, roll_batch, timed=20):
    """Counts set to 0, one predict at ``batch`` and one rollout of
    ``horizon`` steps at ``roll_batch``, counts read; outputs checked; then
    both timed with CUDA events."""
    size = predictor.cfg.model.image_size
    rng = np.random.default_rng(0)
    frame = np.tanh(rng.standard_normal((batch, size, size, 3))).astype(np.float32)
    action = rng.standard_normal((batch, 4)).astype(np.float32)
    frame0 = frame[:roll_batch]
    actions = rng.standard_normal((roll_batch, horizon, 4)).astype(np.float32)
    predictor.predict(frame, action)  # warm-up
    predictor.rollout(frame0, actions)
    torch.cuda.synchronize()

    reset_launches()
    out = predictor.predict(frame, action)
    clip = predictor.rollout(frame0, actions)
    torch.cuda.synchronize()
    launches = read_launches()
    check_counts(path, launches, 1 + horizon)
    check(tuple(out.shape) == (batch, size, size, 3) and out.dtype == torch.bfloat16, "predict shape")
    check(tuple(clip.shape) == (roll_batch, horizon, size, size, 3), "rollout shape")
    for t in (out, clip):
        check(bool(torch.isfinite(t.float()).all()) and float(t.float().abs().max()) <= 1.0,
              "outputs not finite or outside [-1, 1]")

    f_t, a_t = (torch.from_numpy(a).cuda() for a in (frame, action))
    f0_t, as_t = (torch.from_numpy(a).cuda() for a in (frame0, actions))
    predict_ms = cuda_time_ms(lambda: predictor.predict(f_t, a_t), iters=timed)
    profile_call(f"{path} predict", lambda: predictor.predict(f_t, a_t), predict_ms)
    rollout_ms = cuda_time_ms(lambda: predictor.rollout(f0_t, as_t), iters=max(timed // 4, 2),
                              warmup=1)
    t0 = time.perf_counter()
    for _ in range(timed // 2):
        predictor.predict(frame, action)
    torch.cuda.synchronize()
    host_predict_ms = (time.perf_counter() - t0) / (timed // 2) * 1e3
    serving = {
        "path": path,
        f"predict_b{batch}_ms": predict_ms,
        "predict_frames_per_s": batch / predict_ms * 1e3,
        f"predict_b{batch}_from_numpy_ms": host_predict_ms,
        f"rollout_t{horizon}_b{roll_batch}_ms": rollout_ms,
        "rollout_frames_per_s": horizon * roll_batch / rollout_ms * 1e3,
    }
    say("serving " + json.dumps(serving))
    return launches


def phase_http(predictor):
    from action_conditioned_gans_tpu_torch.serve import client_predict, client_rollout, make_server, to_host

    srv = make_server(predictor, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            meta = json.loads(r.read())
        check(meta["ok"] is True and meta["device"] == torch.cuda.get_device_name(0), "healthz")
        rng = np.random.default_rng(5)
        frame = np.tanh(rng.standard_normal((4, 64, 64, 3))).astype(np.float32)
        action = rng.standard_normal((4, 4)).astype(np.float32)
        actions = rng.standard_normal((2, 3, 4)).astype(np.float32)
        direct_p = to_host(predictor.predict(frame, action))
        direct_r = to_host(predictor.rollout(frame[:2], actions))
        via_p = client_predict(url, frame, action)
        via_r = client_rollout(url, frame[:2], actions)
        check(np.array_equal(via_p, direct_p), "/predict differs from the direct call")
        check(np.array_equal(via_r, direct_r), "/rollout differs from the direct call")
        q_p = client_predict(url, frame, action, encoding="uint8")
        q_r = client_rollout(url, frame[:2], actions, encoding="uint8")
        tol = 1.0 / 255.0 + 1e-6
        check(float(np.abs(q_p - direct_p).max()) <= tol, "/predict?encoding=uint8")
        check(float(np.abs(q_r - direct_r).max()) <= tol, "/rollout?encoding=uint8")
        say(f"http: /healthz {meta['device']}, /predict {via_p.shape}, /rollout {via_r.shape}, "
            "float32 equal to direct, uint8 within 1/255")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def phase_kernel_times(layers, worst_b8, extra=()):
    """Each layer at its main-path shape (B=128, bfloat16): kernel, plain
    version and library composite times, and the bound. ``layers`` are
    summed into the per-kernel totals (one config1 predict); ``extra``
    layers get their ``layer`` lines only."""
    totals = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                      bound_ms=0.0, max_abs_err=worst_b8[n]) for n in worst_b8}
    with torch.inference_mode():
        for i, (lname, block, shape) in enumerate([*layers, *extra]):
            name, kernel, plain = kernel_call(block)
            shape = (128, *shape[1:])
            x, w, s, b = layer_inputs(block, shape, 128, torch.bfloat16, seed=200 + i)
            got, mainloop = mainloop_of(lambda: kernel(x, w, s, b))
            want = plain(x.float(), w.to(torch.bfloat16).float(), s, b)
            err = float((got.float() - want).abs().max())
            check(err <= 3e-2, f"{lname}: bfloat16 kernel vs plain at B={shape[0]} ({err})")
            ms = device_time_ms(lambda: kernel(x, w, s, b))
            plain_ms = device_time_ms(lambda: plain(x, w, s, b))
            library_ms = device_time_ms(library_call(block, x, w, s, b))
            flops, nbytes = work(block, shape, 2)
            ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(layer=lname, kernel=name, mainloop=mainloop, shape=list(shape), flops=flops,
                       bytes=nbytes, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err,
                       tflops=flops / ms / 1e9)
            say("layer " + json.dumps(row))
            if i >= len(layers):
                continue
            t = totals[name]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += row[key]
            t["ops_ms"] += ops_ms
            t["bytes_ms"] += bytes_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
    return totals


# -- training phases ---------------------------------------------------------------


ACTS = ("lrelu", "relu", "tanh", "none")


def gn_inputs(shape, groups, act, dtype, seed, y_dtype=torch.float32):
    """y (in ``y_dtype``), scale, out = act(GroupNorm(y)) and a cotangent g
    in ``dtype``, and the (mean, rstd) of y, on the card."""
    from action_conditioned_gans_tpu_torch.ops import common, reference

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    gr = common.resolve_groups(c, groups)
    y = (1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3).to(y_dtype).float()
    scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    out = reference.norm_act(y, scale, bias, groups=groups, act=act).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    yg = y.double().reshape(shape[0], -1, gr, c // gr)
    mean = yg.mean(dim=(1, 3))
    rstd = torch.rsqrt(yg.var(dim=(1, 3), unbiased=False) + 1e-5)
    return (y.to(y_dtype), scale, bias, out, g, mean.float().contiguous(),
            rstd.float().contiguous())


def gn_bwd_pair(shape, groups, act, dtype, seed, y_dtype=torch.float32):
    """(kernel result, plain result in float32 on the same inputs, inputs)."""
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    y, scale, bias, out, g, mean, rstd = gn_inputs(shape, groups, act, dtype, seed, y_dtype)
    kw = dict(groups=groups, act=act, leak=0.2)
    got = gn_bwd.gn_act_bwd(y, scale, out, g, mean, rstd, **kw)
    want = gn_bwd.gn_act_bwd_plain(y.float(), scale, out.float(), g.float(), mean, rstd, **kw)
    torch.cuda.synchronize()
    return got, want, (y, scale, bias, out, g, mean, rstd)


def within(got, want, atol, rtol):
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * want.float().abs()).all())


def phase_gn_bwd_parity():
    """Kernel 4 vs reference.gn_act_grads at the config1 GroupNorm shapes
    (B=8), at ragged ones, at a 2 MB plane and at a plane whose rows do not
    all fit its cluster, every activation, float32 and bfloat16; two
    launches bit-identical."""
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    shapes = [((8, 32, 32, 64), 32), ((8, 16, 16, 128), 32), ((8, 8, 8, 256), 32),
              ((8, 4, 4, 512), 32),
              # ragged: groups 32 -> 5, 32 -> 20, 8 -> 6, 32 -> 24; odd planes
              ((3, 7, 9, 5), 32), ((2, 5, 11, 80), 32), ((3, 9, 9, 12), 8), ((2, 13, 3, 48), 32),
              # the 2 MB plane of config3 G dec_1 at B=2 (a cluster of 16),
              # and a plane past a cluster's shared memory (rows read twice)
              ((2, 64, 64, 64), 32), ((2, 128, 128, 64), 32)]
    for dtype in (torch.float32, torch.bfloat16):
        plan = gn_bwd.kernel_plan(torch.float32, dtype, 2, 128 * 128, 64, 32)
        check(plan.reread > 0, f"gn_act_bwd: 128x128x64 in {dtype} should read rows twice: {plan}")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (shape, groups) in enumerate(shapes):
        for act in ACTS:
            for dtype in (torch.float32, torch.bfloat16):
                got, want, (y, scale, _, out, g, mean, rstd) = gn_bwd_pair(shape, groups, act,
                                                                           dtype, seed=400 + i)
                again = gn_bwd.gn_act_bwd(y, scale, out, g, mean, rstd, groups=groups, act=act,
                                          leak=0.2)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"gn_act_bwd: two launches differ at {shape} {act} {dtype}")
                dx_bar = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-2)
                e_dx, ok_dx = within(got[0], want[0], *dx_bar)
                e_s, ok_s = within(got[1], want[1], 1e-4, 1e-4)
                e_b, ok_b = within(got[2], want[2], 1e-4, 1e-4)
                tag = f"{shape} groups {groups} {act} {str(dtype)[6:]}"
                check(got[0].dtype == dtype and got[1].dtype == torch.float32, f"gn_act_bwd dtypes {tag}")
                check(ok_dx and ok_s and ok_b,
                      f"gn_act_bwd vs plain at {tag}: dx {e_dx:.3e} dscale {e_s:.3e} dbias {e_b:.3e}")
                worst[dtype] = max(worst[dtype], e_dx, e_s, e_b)
    say(f"gn_act_bwd parity ({len(shapes)} shapes x {len(ACTS)} activations): "
        f"f32 max|d|={worst[torch.float32]:.3e} (bar 1e-4 + 1e-4 rel), "
        f"bf16 max|d|={worst[torch.bfloat16]:.3e} (dx bar 1e-2 + 1e-2 rel), "
        "two launches bit-identical")


def phase_autograd_parity(layers, batch=4):
    """The autograd Functions on the kernels against autograd of the plain
    composite on cuda, float32, every G and D layer."""
    worst = 0.0
    for i, (lname, block, shape) in enumerate(layers):
        name, kernel, plain = kernel_call(block)
        x, w, s, b = layer_inputs(block, shape, batch, torch.float32, seed=300 + i)

        def grads(fn):
            ins = [None if t is None else t.clone().requires_grad_() for t in (x, w, s, b)]
            out = fn(*ins)
            ct = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                             device="cuda")
            return out, torch.autograd.grad(out, [t for t in ins if t is not None], ct)

        out_k, got = grads(kernel)
        _, want = grads(plain)
        check(out_k.grad_fn is not None and out_k.grad_fn.name().startswith("Conv"),
              f"{lname}: the kernel path did not go through its autograd Function")
        torch.cuda.synchronize()
        errs = []
        for label, a, r in zip(("dx", "dw", "dscale", "dbias") if s is not None else ("dx", "dw", "dbias"),
                               got, want):
            err, ok = within(a, r, 1e-3, 1e-3)
            check(ok, f"{lname}: {label} of the autograd Function vs the plain composite ({err:.3e})")
            errs.append(f"{label} {err:.2e}")
            worst = max(worst, err)
        say(f"grad parity {lname:14s} {name:24s} x{tuple(x.shape)} f32 " + " ".join(errs))
    return worst


def replay_train_fixture(arrays, keys, label):
    """A JAX package's tiny four-step run (``make_train_fixture``'s layout)
    replayed on cuda in float32: the trajectory of ``keys`` within
    tests/test_golden.py's tolerances (a key past its three at d_loss's).
    Returns the largest |d|."""
    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.train import make_train_step
    from action_conditioned_gans_tpu_torch.train.state import state_from_params

    cfg = config_from_dict(json.loads(str(arrays["__config__"])))
    check(cfg.model.compute_dtype == "float32", f"{label} is not float32")
    sds = [{k[2:].replace("/", "."): torch.from_numpy(np.array(v)) for k, v in arrays.items()
            if k.startswith(p)} for p in ("g/", "d/")]
    state = state_from_params(cfg, *sds, device="cuda")
    step = make_train_step(cfg, device="cuda")
    tols = GOLDEN_TOL + (GOLDEN_TOL[0],) * (len(keys) - len(GOLDEN_TOL))
    worst = 0.0
    for i, want in enumerate(arrays["trajectory"]):
        state, m = step(state, {k: arrays[f"batch{i}/{k}"] for k in ("frames", "actions")})
        got = [float(m[k]) for k in keys]
        for a, b, (atol, rtol) in zip(got, want, tols):
            check(abs(a - b) <= atol + rtol * abs(b), f"{label} step {i}: {got} vs JAX {want.tolist()}")
            worst = max(worst, abs(a - b))
    return worst


def phase_train_fixture():
    """The JAX package's tiny four-step training run, replayed on cuda."""
    with np.load(TRAIN_FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    worst = replay_train_fixture(arrays, TRAJECTORY, "training fixture")
    say(f"training fixture (JAX tiny 4-step run) on cuda f32: max|d| of (d_loss, g_loss, g_recon)="
        f"{worst:.3e} (bars of tests/test_golden.py)")


def config1_train_config(batch=128):
    """config1 at full width, bfloat16, B=128, T=1, bfloat16 Adam moments
    (bench.py's override)."""
    from action_conditioned_gans_tpu_torch.config import get_preset

    c1 = get_preset("config1")
    return c1.replace(train=dataclasses.replace(c1.train, batch_size=batch, rollout_length=1,
                                                adam_moment_dtype="bfloat16"))


@contextlib.contextmanager
def recorded_calls():
    """Every call of the kernel wrappers made inside, recorded (the calls
    themselves run): ``conv`` (kernels 1-2: name, x shape, dtype, w shape,
    keywords, bias is None), ``norm`` (kernel 3: x shape, dtype, keywords,
    under autograd) and ``gn_bwd`` (kernel 4: y shape, dtype, groups, act,
    leak, y dtype)."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv, gn_bwd, norm_act

    rec = {"conv": [], "norm": [], "gn_bwd": []}
    real = gn_bwd.gn_act_bwd
    real_conv = {name: getattr(conv, name) for name in ("conv_norm_act", "conv_transpose_norm_act")}
    real_norm = norm_act.group_norm_act

    def record(y, scale, out, g, mean=None, rstd=None, **kw):
        rec["gn_bwd"].append((tuple(y.shape), out.dtype, kw["groups"], kw["act"], kw["leak"],
                              y.dtype))
        return real(y, scale, out, g, mean, rstd, **kw)

    def record_conv(name):
        def wrapper(x, w, scale, bias, **kw):
            rec["conv"].append((name, tuple(x.shape), x.dtype, tuple(w.shape),
                                tuple(sorted(kw.items())), bias is None))
            return real_conv[name](x, w, scale, bias, **kw)
        return wrapper

    def record_norm(x, scale, bias, **kw):
        rec["norm"].append((tuple(x.shape), x.dtype, tuple(sorted(kw.items())), x.requires_grad))
        return real_norm(x, scale, bias, **kw)

    gn_bwd.gn_act_bwd = record
    norm_act.group_norm_act = record_norm
    for name in real_conv:
        setattr(conv, name, record_conv(name))
    try:
        yield rec
    finally:
        gn_bwd.gn_act_bwd = real
        norm_act.group_norm_act = real_norm
        for name, fn in real_conv.items():
            setattr(conv, name, fn)


def phase_training(cfg, path, steps=20, warmup=3, n_batches=4):
    """``cfg`` at full width with seeded weights and clips drawn on the card
    from a seed (B, T and the state as ``cfg`` has them): the warm-up steps,
    one counted step (counts set to 0 before and read after, every kernel
    wrapper's calls recorded), then ``steps`` steps timed."""
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
    from action_conditioned_gans_tpu_torch.train.state import param_count

    mc = cfg.model
    batch, size, horizon = cfg.train.batch_size, mc.image_size, max(cfg.train.rollout_length, 1)
    check(mc.compute_dtype == "bfloat16", f"{path} does not train in bfloat16")
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
    step = make_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)

    def clips():
        out = dict(frames=torch.tanh(torch.randn((batch, horizon + 1, size, size, 3), generator=gen,
                                                 device="cuda")),
                   actions=torch.randn((batch, horizon, mc.action_dim), generator=gen, device="cuda"))
        if mc.state_dim:
            out["states"] = torch.randn((batch, horizon, mc.state_dim), generator=gen, device="cuda")
        return out

    batches = [clips() for _ in range(n_batches)]
    g0 = {k: v.clone() for k, v in state.g_params.items()}
    d0 = {k: v.clone() for k, v in state.d_params.items()}
    for i in range(warmup):
        state, m = step(state, batches[i % n_batches])
    torch.cuda.synchronize()

    # The main path's counted step; every kernel wrapper's calls are recorded.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_calls() as rec:
        state, m = step(state, batches[warmup % n_batches])
        torch.cuda.synchronize()
    calls, conv_calls, norm_calls = rec["gn_bwd"], rec["conv"], rec["norm"]
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_counts(path, launches, 1)
    # Kernel 3 runs under autograd, and its backward reads its input, in the
    # compute dtype, as y.
    k3 = EXPECTED[path][0]["group_norm_act"]
    check(sum(1 for c in norm_calls if c[3]) == k3, f"{path}: kernel 3 calls under autograd")
    y_bf16, want = sum(1 for c in calls if c[5] == torch.bfloat16), EXPECTED[path][3]
    check(y_bf16 == want, f"{path}: {y_bf16} gn_act_bwd calls read a bfloat16 y, want {want}")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(steps):
        state, m = step(state, batches[i % n_batches])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    metrics = {k: float(v) for k, v in m.items()}
    check(all(np.isfinite(v) for v in metrics.values()), f"non-finite training metrics {metrics}")
    moved_g = max(float((state.g_params[k] - v).abs().max()) for k, v in g0.items())
    moved_d = max(float((state.d_params[k] - v).abs().max()) for k, v in d0.items())
    check(moved_g > 0 and moved_d > 0, "a parameter set did not move")
    n_g, n_d = param_count(state)
    train = dict(path=path, train_step_ms=ms, frames_per_s=batch * horizon / ms * 1e3,
                 batch=batch, horizon=horizon, steps_timed=steps, peak_memory_gb=peak_gb,
                 g_params=n_g, d_params=n_d, step=state.step, last_metrics=metrics)
    say("training " + json.dumps(train))
    profile_call(path, lambda: step(state, batches[0]), ms)
    return launches, calls, conv_calls, norm_calls


def phase_train_conv_parity(conv_calls, worst):
    """Each distinct conv call of the counted training step (the G layers at
    B=128, D at B=256 in its update and B=128 in the G head): the kernel in
    bfloat16 against its plain version in float32 on the same inputs, within
    3e-2 as in phase 2. Folds the errors into ``worst``."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    distinct = list(dict.fromkeys(conv_calls))
    with torch.inference_mode():
        for i, (name, x_shape, dtype, w_shape, kw, no_bias) in enumerate(distinct):
            kw = dict(kw)
            x, w, s, b = call_inputs(x_shape, w_shape, kw["kind"], dtype, seed=600 + i)
            b = None if no_bias else b  # a split batch-norm layer's bare conv
            got = getattr(conv, name)(x, w, s, b, **kw)
            kw.pop("wgrad", None)  # the backward's engine; the plain forward takes none
            want = getattr(conv, f"{name}_plain")(x.float(), w.to(dtype).float(), s, b, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            say(f"train parity {name:24s} x{x_shape} w{w_shape} {kw['kind']:5s} "
                f"{'bare ' if no_bias else ''}{str(dtype)[6:]} max|d|={err:.3e}")
            check(np.isfinite(err) and err <= 3e-2,
                  f"{name} at the training step's x{x_shape}: kernel vs plain beyond 3e-2 ({err})")
            worst[name]["max_abs_err"] = max(worst[name]["max_abs_err"], err)
    say(f"train parity: {len(distinct)} distinct conv calls of the training step within 3e-2")


# Kernel-name fragments of the port's own kernels (csrc/). The GroupNorm
# stats and apply passes (gn_common.cuh) are the conv kernels' epilogue;
# kernel 3 is one cluster launch of its own; kernel 4 a cluster launch
# (gn_bwd_cluster_kernel) and a batch sum (gn_bwd_batch_sum_kernel).
OWN_KERNELS = {"conv_wgmma_kernel": "conv fwd GEMM", "conv_wmma_kernel": "conv fwd GEMM",
               "conv_fma_kernel": "conv fwd GEMM", "pack_weights_kernel": "conv weight packing",
               "narrow_transpose_kernel": "conv-transpose narrow (whole layer)",
               "gn_cluster_kernel": "group_norm_act (one cluster launch)",
               "gn_stats_kernel": "GroupNorm stats (conv epilogue)",
               "gn_apply_kernel": "GroupNorm apply (conv epilogue)",
               "gn_bwd_cluster_kernel": "gn_act_bwd", "gn_bwd_batch_sum_kernel": "gn_act_bwd"}


def profile_call(path, fn, call_ms, top=14):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share: of the profiled call's wall time (which the
    profiler's own host work inflates) and of ``call_ms``, the call's time
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    if not by_name:
        say("profile: torch.profiler recorded no device time; device breakdown not measured")
        return
    groups = {}
    for name, (t, c) in by_name.items():
        label = next((v for k, v in OWN_KERNELS.items() if k in name), "other (cuDNN, cuBLAS, torch)")
        groups[label] = groups.get(label, 0.0) + t
    say("profile " + json.dumps(dict(
        path=path, wall_ms=wall_ms, device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
        busy_share_of_unprofiled_call=busy_ms / call_ms,
        kernels=n_kernels, by_group_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])))))
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"profile_kernel {t:8.4f} ms x{c:3d} {name[:110]}")


def library_gn_bwd(y, scale, bias, g, groups, act):
    """The backward alone of autograd through F.group_norm + the activation,
    on the same values in PyTorch's NCHW layout: the two aten ops autograd
    runs (the activation's backward, then native_group_norm_backward),
    called directly. The yardstick, never called by the port."""
    n, h, w, c = y.shape
    yl = y.float().permute(0, 3, 1, 2).contiguous()
    gl = g.float().permute(0, 3, 1, 2).contiguous()
    pre, mean, rstd = torch.ops.aten.native_group_norm(yl, scale, bias, n, c, h * w, groups, 1e-5)
    act_bwd = {
        "lrelu": lambda: torch.ops.aten.leaky_relu_backward(gl, pre, 0.2, False),
        "relu": lambda: torch.ops.aten.threshold_backward(gl, torch.relu(pre), 0),
        "tanh": lambda: torch.ops.aten.tanh_backward(gl, torch.tanh(pre)),
        "none": lambda: gl,
    }[act]
    return lambda: torch.ops.aten.native_group_norm_backward(
        act_bwd(), yl, mean, rstd, scale, n, c, h * w, groups, [True, True, True])


def kernel4_plan(shape, dtype, groups, y_dtype):
    """Kernel 4's plan for a call (``acg_gn_bwd_plan``) and how many of its
    clusters the card holds at once."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import build, gn_bwd

    b, h, w, c = shape
    gr = resolve_groups(c, groups)
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    return dict(plan=gn_bwd.kernel_plan(y_dtype, dtype, b, h * w, c, gr)._asdict(),
                resident_clusters=build.load("gn_act_bwd").acg_gn_bwd_max_active_clusters(
                    size(y_dtype), size(dtype), b, h * w, c, gr))


def gn_bwd_call_checked(call, seed):
    """Kernel 4 at one training-step call against its plain version in
    float32 on the same inputs: dx within 1e-2 abs + 1e-2 rel; dscale and
    dbias, float32 sums over B*H*W values on both sides, within 1e-4 of
    their largest magnitude plus 1e-4 relative. Returns (dx error, inputs)."""
    shape, dtype, groups, act, leak, y_dtype = call
    got, want, inputs = gn_bwd_pair(shape, groups, act, dtype, seed, y_dtype)
    err, ok = within(got[0], want[0], 1e-2, 1e-2)
    check(ok, f"gn_act_bwd at {shape}: bf16 dx vs plain ({err:.3e})")
    for label, a, r in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
        e, ok = within(a, r, 1e-4 * float(r.abs().max()), 1e-4)
        check(ok, f"gn_act_bwd at {shape}: {label} vs plain ({e:.3e}, max |{label}| "
                  f"{float(r.abs().max()):.3e})")
    return err, inputs


def phase_gn_bwd_times(calls, path):
    """Kernel 4 at each of a training step's calls: kernel, plain and
    library times, the bound, the call's plan and resident clusters, and the
    bfloat16 error against the plain version in float32 on the same inputs
    (:func:`gn_bwd_call_checked`)."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               max_abs_err=0.0)
    for i, call in enumerate(calls):
        shape, dtype, groups, act, leak, y_dtype = call
        err, (y, scale, bias, out, g, mean, rstd) = gn_bwd_call_checked(call, 500 + i)
        kw = dict(groups=groups, act=act, leak=leak)
        ms = device_time_ms(lambda: gn_bwd.gn_act_bwd(y, scale, out, g, mean, rstd, **kw))
        plain_ms = device_time_ms(lambda: gn_bwd.gn_act_bwd_plain(y, scale, out, g, mean, rstd, **kw))
        library_ms = device_time_ms(library_gn_bwd(y, scale, bias, g, resolve_groups(shape[-1], groups), act))
        n = int(np.prod(shape))
        b, c, gr = shape[0], shape[-1], resolve_groups(shape[-1], groups)
        # y in, out and g in, dx out; scale, mean, rstd in; dscale, dbias out.
        nbytes = n * (y.element_size() + 3 * out.element_size()) + 4 * c + 8 * b * gr + 8 * c
        flops = 12 * n  # act', xhat, two sums, dx: float32 on the CUDA cores
        ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(path=path, call=i, shape=list(shape), dtype=str(dtype)[6:],
                   y_dtype=str(y_dtype)[6:], groups=gr, act=act, bytes=nbytes, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err,
                   **kernel4_plan(shape, dtype, groups, y_dtype))
        say("gnbwd_layer " + json.dumps(row))
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += row[key]
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bytes_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return tot


def phase_gn_bwd_call_parity(calls, path, totals):
    """Kernel 4 at each distinct call of a training step against its plain
    version (:func:`gn_bwd_call_checked`); the plans of the calls that read
    rows twice are printed. Folds the errors into ``totals``."""
    distinct = list(dict.fromkeys(calls))
    reread = 0
    for i, call in enumerate(distinct):
        shape, dtype, groups, act, leak, y_dtype = call
        err, _ = gn_bwd_call_checked(call, 1200 + i)
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        plan = kernel4_plan(shape, dtype, groups, y_dtype)
        if plan["plan"]["reread"] > 0:
            reread += 1
            say(f"{path} gn_act_bwd x{shape} y {str(y_dtype)[6:]} {act}: rows read twice, "
                f"plan {json.dumps(plan)}, dx max|d|={err:.3e}")
    say(f"{path} parity: {len(distinct)} distinct gn_act_bwd calls within phase 11's bars "
        f"({reread} reading rows twice)")


# -- kernel 3: the standalone GroupNorm + activation -----------------------------------


# Kernel 3's inputs on the main paths and ragged ones: (label, shape, groups).
NORM_SHAPES = [
    ("c5.G.enc_1", (2, 64, 64, 128), 32), ("c5.G.enc_3", (2, 16, 16, 512), 32),
    ("c5.G.enc_4", (2, 8, 8, 512), 32), ("c5.G.dec_4", (2, 16, 16, 512), 32),
    ("c5.G.dec_3", (2, 32, 32, 256), 32), ("c5.G.dec_2", (2, 64, 64, 128), 32),
    ("c5.G.dec_1", (2, 128, 128, 64), 32),
    ("c3.D.conv_4", (8, 4, 4, 512), 32),  # also config1 float32 D conv_3's output
    # ragged: 40 -> 20 groups, 96 -> 16 groups of 6, 520 -> 26 groups; odd planes
    ("edge_c40", (3, 7, 5, 40), 32), ("edge_c96", (2, 9, 9, 96), 20),
    ("edge_c520", (2, 5, 7, 520), 32),
    # 36 channels: no multiple of 8, one-channel units in bfloat16; one sample;
    # 9 rows over a cluster of 8; 2560 channels: more units than threads; 3
    # rows: a cluster of 2; config5 dec_1, whose float32 shares spill.
    ("edge_c36", (3, 7, 5, 36), 32), ("edge_b1", (1, 16, 16, 512), 32),
    ("edge_hw9", (4, 3, 3, 64), 32), ("edge_c2560", (2, 3, 3, 2560), 32),
    ("edge_hw3", (5, 3, 1, 64), 32), ("edge_dec1_spill", (2, 128, 128, 64), 32),
]


def norm_inputs(shape, dtype, seed):
    """x ~ 1.5 N(0, 1) + 0.3 in ``dtype``, scale ~ 1 + 0.2 N, bias ~ 0.1 N."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype)
    return (x, 1 + 0.2 * torch.randn(c, generator=gen, device="cuda"),
            0.1 * torch.randn(c, generator=gen, device="cuda"))


def phase_norm_parity():
    """Kernel 3 vs its plain version (reference.norm_act) at every shape of
    NORM_SHAPES, every activation: float32 within 1e-4 abs + 1e-4 rel;
    bfloat16 within 3e-2 of the plain version run in float32 on the same
    bfloat16 input (the kernel activates before its cast). The returned
    (mean, rstd) against float64 statistics within 1e-4 abs + 1e-4 rel."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_stats = 0.0
    with torch.inference_mode():
        for i, (label, shape, groups) in enumerate(NORM_SHAPES):
            gr = resolve_groups(shape[-1], groups)
            for act in ACTS:
                for dtype in (torch.float32, torch.bfloat16):
                    x, s, b = norm_inputs(shape, dtype, seed=700 + i)
                    kw = dict(groups=groups, act=act, leak=0.2)
                    got, stats = norm_act.group_norm_act_with_stats(x, s, b, **kw)
                    again, stats_again = norm_act.group_norm_act_with_stats(x, s, b, **kw)
                    want = norm_act.group_norm_act_plain(x.float(), s, b, **kw)
                    torch.cuda.synchronize()
                    tag = f"{label} {shape} groups {gr} {act} {str(dtype)[6:]}"
                    check(torch.equal(got, again) and torch.equal(stats, stats_again),
                          f"group_norm_act: two launches differ at {tag}")
                    check(got.dtype == dtype and tuple(got.shape) == shape, f"group_norm_act {tag}")
                    bar = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 0.0)
                    err, ok = within(got, want, *bar)
                    check(ok and np.isfinite(err), f"group_norm_act vs plain at {tag}: {err:.3e}")
                    worst[dtype] = max(worst[dtype], err)
                    xg = x.double().reshape(shape[0], -1, gr, shape[-1] // gr)
                    ref = torch.stack([xg.mean(dim=(1, 3)),
                                       torch.rsqrt(xg.var(dim=(1, 3), unbiased=False) + 1e-5)])
                    e_st, ok_st = within(stats, ref, 1e-4, 1e-4)
                    check(tuple(stats.shape) == (2, shape[0], gr) and ok_st,
                          f"group_norm_act (mean, rstd) at {tag}: {e_st:.3e}")
                    worst_stats = max(worst_stats, e_st)
    say(f"group_norm_act parity ({len(NORM_SHAPES)} shapes x {len(ACTS)} activations): f32 "
        f"max|d|={worst[torch.float32]:.3e} (bar 1e-4 + 1e-4 rel), bf16 "
        f"max|d|={worst[torch.bfloat16]:.3e} (bar 3e-2), (mean, rstd) max|d|={worst_stats:.3e}, "
        "two launches bit-identical")
    return worst[torch.bfloat16]


def phase_gn_bwd_bf16_y():
    """Kernel 4 reading a bfloat16 y (the backward of kernel 3's layers) at
    kernel 3's shapes, every activation, against reference.gn_act_grads in
    float32 on the same values: phase 7's bars."""
    worst = 0.0
    for i, (label, shape, groups) in enumerate(NORM_SHAPES):
        for act in ACTS:
            got, want, _ = gn_bwd_pair(shape, groups, act, torch.bfloat16, 800 + i,
                                       y_dtype=torch.bfloat16)
            e_dx, ok_dx = within(got[0], want[0], 1e-2, 1e-2)
            e_s, ok_s = within(got[1], want[1], 1e-4, 1e-4)
            e_b, ok_b = within(got[2], want[2], 1e-4, 1e-4)
            check(ok_dx and ok_s and ok_b, f"gn_act_bwd with bf16 y at {label} {shape} {act}: "
                                           f"dx {e_dx:.3e} dscale {e_s:.3e} dbias {e_b:.3e}")
            worst = max(worst, e_dx, e_s, e_b)
    say(f"gn_act_bwd parity with bf16 y ({len(NORM_SHAPES)} shapes x {len(ACTS)} activations): "
        f"max|d|={worst:.3e} (dx bar 1e-2 + 1e-2 rel, dscale / dbias 1e-4 + 1e-4 rel)")


def phase_split_autograd(batch=4):
    """Autograd of a split layer on the card (cuDNN conv, then kernel 3
    through GroupNormActFn, backward through kernel 4) against autograd of
    the plain composite, float32, TF32 off, within 1e-3 abs + 1e-3 rel:
    config1 float32 D conv_3 and config3 D conv_4."""
    from action_conditioned_gans_tpu_torch.ops import api, reference

    cases = [("c1.f32.D.conv_3", (batch, 8, 8, 256), (4, 4, 256, 512)),
             ("c3.D.conv_4", (batch, 8, 8, 512), (4, 4, 512, 512))]
    kw = dict(kind="group", groups=32, act="lrelu", leak=0.2)
    for i, (label, x_shape, w_shape) in enumerate(cases):
        x, w, s, b = call_inputs(x_shape, w_shape, "group", torch.float32, seed=900 + i)

        def grads(fn):
            ins = [t.clone().requires_grad_() for t in (x, w, s, b)]
            out = fn(*ins)
            ct = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                             device="cuda")
            return out, torch.autograd.grad(out, ins, ct)

        api.reset_routes()
        out_k, got = grads(lambda *a: api.conv_norm_act(*a, stride=2, **kw))
        check(api.ROUTES == {**dict.fromkeys(api.ROUTES, 0), "split": 1},
              f"{label}: not on the split route")
        check(out_k.grad_fn.name() == "GroupNormActFnBackward", f"{label}: not through GroupNormActFn")
        _, want = grads(lambda xx, ww, ss, bb: reference.norm_act(
            reference.conv2d(xx, ww, stride=2), ss, bb, **kw))
        torch.cuda.synchronize()
        errs = []
        for name, a, r in zip(("dx", "dw", "dscale", "dbias"), got, want):
            err, ok = within(a, r, 1e-3, 1e-3)
            check(ok, f"{label}: {name} of the split layer vs the plain composite ({err:.3e})")
            errs.append(f"{name} {err:.2e}")
        say(f"split grad parity {label:16s} x{x_shape} f32 " + " ".join(errs))


def library_norm_act(x, scale, bias, groups, act):
    """F.group_norm + the activation on the NCHW view of the NHWC tensor
    (any layout copy F.group_norm makes is inside the call): the yardstick,
    never called by the port."""
    acts = {"lrelu": lambda t: F.leaky_relu(t, 0.2), "relu": F.relu, "tanh": torch.tanh,
            "none": lambda t: t}
    xn = x.permute(0, 3, 1, 2)
    s, b = scale.to(x.dtype), bias.to(x.dtype)
    return lambda: acts[act](F.group_norm(xn, groups, s, b))


def record_kernel3_calls():
    """Wraps kernel 3's launch so that every call of the run leaves its
    (dtype, B, HW, C, groups) in the returned set."""
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    seen, launch = set(), norm_act._launch

    def recording(x, scale, bias, o):
        b, h, w, c = x.shape
        seen.add((str(x.dtype)[6:], b, h * w, c, resolve_groups(c, o.groups)))
        return launch(x, scale, bias, o)

    norm_act._launch = recording
    return seen


def record_kernel4_calls():
    """Wraps kernel 4's launch so that every call of the run leaves its
    (y dtype, dtype, B, HW, C, groups) in the returned set."""
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd

    seen, launch = set(), gn_bwd._launch

    def recording(y, scale, out, g, mean, rstd, groups, act, leak):
        b, h, w, c = y.shape
        seen.add((str(y.dtype)[6:], str(out.dtype)[6:], b, h * w, c, groups))
        return launch(y, scale, out, g, mean, rstd, groups, act, leak)

    gn_bwd._launch = recording
    return seen


def check_plans(seen, seen4):
    """The kernels' plans (acg_gn_plan, acg_gn_bwd_plan) against their Python
    copies at every kernel-3 and kernel-4 call of the run."""
    from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd, norm_act

    for dtype, b, hw, c, g in sorted(seen):
        args = (getattr(torch, dtype), b, hw, c, g)
        lib, py = norm_act.kernel_plan(*args), norm_act.gn_plan(*args)
        check(lib == py, f"group_norm_act plan at {dtype} ({b}, {hw}, {c}) groups {g}: "
                         f"acg_gn_plan {lib}, Python copy {py}")
    say(f"group_norm_act plan: acg_gn_plan equals its Python copy at all {len(seen)} "
        "(dtype, B, HW, C, groups) of the run's kernel-3 calls")
    for y_dtype, dtype, b, hw, c, g in sorted(seen4):
        args = (getattr(torch, y_dtype), getattr(torch, dtype), b, hw, c, g)
        lib, py = gn_bwd.kernel_plan(*args), gn_bwd.gn_bwd_plan(*args)
        check(lib == py, f"gn_act_bwd plan at y {y_dtype} {dtype} ({b}, {hw}, {c}) groups {g}: "
                         f"acg_gn_bwd_plan {lib}, Python copy {py}")
    say(f"gn_act_bwd plan: acg_gn_bwd_plan equals its Python copy at all {len(seen4)} "
        "(y dtype, dtype, B, HW, C, groups) of the run's kernel-4 calls")


def kernel3_resources(shape, dtype, groups, act):
    """Kernel 3's plan for x ``shape``, the registers of the instance the
    call runs, and how many of its clusters the card holds at once, at the
    plan's cluster size and at 16 blocks (non-portable)."""
    from action_conditioned_gans_tpu_torch.ops.common import ACTIVATIONS, resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import build, norm_act

    b, h, w, c = shape
    gr = resolve_groups(c, groups)
    plan = norm_act.kernel_plan(dtype, b, h * w, c, gr)
    bf16 = int(dtype == torch.bfloat16)
    instance = (f"gn_cluster_kernelI{'13__nv_bfloat16' if bf16 else 'f'}Li{plan.vec}E"
                f"Li{ACTIVATIONS.index(act)}E")
    regs = [v["registers"] for k, v in build.ptxas_report("group_norm_act").items() if instance in k]
    check(len(regs) == 1, f"ptxas reported {len(regs)} instances {instance}")
    lib = build.load("group_norm_act")
    return dict(plan=plan._asdict(), registers=regs[0],
                resident_clusters=lib.acg_gn_max_active_clusters(bf16, b, h * w, c, gr, 0),
                resident_clusters_at_16=lib.acg_gn_max_active_clusters(bf16, b, h * w, c, gr, 16))


def phase_norm_times(layers, worst_bf16, batch=32):
    """Kernel 3 at each config5 generator layer that runs it, at ``batch``:
    its device time, the plain version's and the library's, the byte bound,
    its plan and resources; and the whole layer as the port runs it (cuDNN
    conv + kernel 3), as the fused conv kernel runs it, and as cuDNN +
    F.group_norm run it."""
    from action_conditioned_gans_tpu_torch.ops import api, envelope
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               max_abs_err=worst_bf16)
    with torch.inference_mode():
        for i, (lname, block, shape) in enumerate(layers):
            x_shape = (batch, *shape[1:])
            w_shape = tuple(block.kernel.shape)
            if block.norm != "group" or envelope.route(
                    x_shape, w_shape, block.stride, block.transpose, block.norm, block.groups,
                    torch.bfloat16) != "split":
                continue
            x, w, s, b = layer_inputs(block, x_shape, batch, torch.bfloat16, seed=1000 + i)
            conv = api.conv2d_transpose if block.transpose else api.conv2d
            y = conv(x, w, stride=block.stride)
            kw = dict(groups=block.groups, act=block.act, leak=block.leak)
            got = norm_act.group_norm_act(y, s, b, **kw)
            err, ok = within(got, norm_act.group_norm_act_plain(y.float(), s, b, **kw), 3e-2, 0.0)
            check(ok, f"{lname}: group_norm_act vs plain at x{tuple(y.shape)} ({err:.3e})")
            ms = device_time_ms(lambda: norm_act.group_norm_act(y, s, b, **kw))
            plain_ms = device_time_ms(lambda: norm_act.group_norm_act_plain(y, s, b, **kw))
            gr = resolve_groups(y.shape[-1], block.groups)
            library_ms = device_time_ms(library_norm_act(y, s, b, gr, block.act))
            _, fused, _ = kernel_call(block)
            block_kw = dict(stride=block.stride, transpose=block.transpose, kind=block.norm, **kw)
            split_layer_ms = device_time_ms(lambda: api.conv_norm_act(x, w, s, b, **block_kw))
            fused_layer_ms = device_time_ms(lambda: fused(x, w, s, b))
            library_layer_ms = device_time_ms(library_call(block, x, w, s, b))
            n, c = y.numel(), y.shape[-1]
            nbytes = 2 * n * y.element_size() + 2 * c * 4  # x in, out written; scale, bias
            flops = 10 * n  # two sums, normalise, affine, act: float32 on the CUDA cores
            ops_ms, bytes_ms = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = dict(layer=lname, shape=list(y.shape), groups=gr, act=block.act, bytes=nbytes,
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes", max_abs_err=err,
                       split_layer_ms=split_layer_ms, fused_kernel_layer_ms=fused_layer_ms,
                       library_layer_ms=library_layer_ms,
                       **kernel3_resources(tuple(y.shape), y.dtype, block.groups, block.act))
            say("n3_layer " + json.dumps(row))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += row[key]
            tot["ops_ms"] += ops_ms
            tot["bytes_ms"] += bytes_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return tot


def phase_train_norm_parity(norm_calls, totals):
    """Each distinct kernel-3 call of the counted training step in bfloat16
    against its plain version in float32 on the same input, within 3e-2."""
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    with torch.inference_mode():
        for i, (shape, dtype, kw, _) in enumerate(dict.fromkeys(norm_calls)):
            kw = dict(kw)
            x, s, b = norm_inputs(shape, dtype, seed=1100 + i)
            got = norm_act.group_norm_act(x, s, b, **kw)
            err, ok = within(got, norm_act.group_norm_act_plain(x.float(), s, b, **kw), 3e-2, 0.0)
            say(f"train parity group_norm_act x{shape} {str(dtype)[6:]} {kw['act']} max|d|={err:.3e}")
            check(ok, f"group_norm_act at the training step's x{shape}: kernel vs plain ({err:.3e})")
            totals["max_abs_err"] = max(totals["max_abs_err"], err)


# -- phase 12: the training loop, its checkpoints, resume, SIGTERM and bench ----------

# The `train` subcommand as phase 12 drives it: config1 at full width, B=128,
# bfloat16 moments, 16 steps a call.
LOOP_ARGS = ["--preset", "config1", "--set", "train.batch_size=128",
             "--set", "train.adam_moment_dtype=bfloat16", "--set", "train.steps_per_call=16",
             "--set", "train.log_every=16", "--set", "train.checkpoint_every=32",
             "--set", "train.sample_every=32", "--set", "train.checkpoint_keep=2"]


class _Tee(io.TextIOBase):
    """Standard output that is also kept."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()


def run_cli(argv):
    """``cli.main(argv)`` in this process; its standard output, also printed."""
    import contextlib

    from action_conditioned_gans_tpu_torch import cli

    tee = _Tee()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return "".join(tee.parts)


def metric_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def checkpoint_steps(workdir):
    return sorted(int(n) for n in os.listdir(os.path.join(workdir, "checkpoints")) if n.isdigit())


def final_params(workdir, step):
    """Parameters, moments and EMA (when the run keeps one) of the
    checkpoint at ``step``, on the host."""
    state = torch.load(os.path.join(workdir, "checkpoints", str(step), "state.pt"),
                       weights_only=True)
    flat = {}
    for name in ("g_params", "d_params", "g_ema"):
        flat.update({f"{name}/{k}": v for k, v in state.get(name, {}).items()})
    for name in ("g_opt", "d_opt"):
        for moments in ("mu", "nu"):
            m = state[name][moments]
            if isinstance(m, torch.Tensor):  # train.flatten_optimizer's one vector
                flat[f"{name}/{moments}"] = m
            else:
                flat.update({f"{name}/{moments}/{k}": v for k, v in m.items()})
        flat[f"{name}/count"] = torch.tensor(state[name]["count"])
    return flat


def compare_states(a, b):
    """(bit-identical, max |a - b| over every parameter and moment, the key
    of the largest)."""
    check(a.keys() == b.keys(), "the two checkpoints hold different keys")
    same = all(torch.equal(a[k], b[k]) for k in a)
    diffs = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a}
    worst = max(diffs, key=diffs.get)
    return same, diffs[worst], worst


def sigterm_run(workdir):
    """``train`` in a process of its own on the card, SIGTERM after its first
    metric line: it must exit 0 with a checkpoint at the step it stopped at."""
    cmd = [sys.executable, "-m", "action_conditioned_gans_tpu_torch", "train", *LOOP_ARGS,
           "--workdir", workdir, "--steps", "100000"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines, first_metric = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("{"):
                first_metric.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        check(first_metric.wait(timeout=300), "the train process wrote no metric line: "
              + "".join(lines[-20:]))
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        exit_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=60)
    out = "".join(lines)
    check(rc == 0, f"the train process exited {rc} after SIGTERM: {out[-2000:]}")
    stopped = [int(line.split("at step ")[1].split()[0]) for line in out.splitlines()
               if "SIGTERM received" in line]
    check(len(stopped) == 1, f"no SIGTERM line in the train process's output: {out[-2000:]}")
    check(stopped[0] in checkpoint_steps(workdir),
          f"no checkpoint at the SIGTERM step {stopped[0]}: {checkpoint_steps(workdir)}")
    return stopped[0], exit_s


def own_kernel_totals(events):
    """Device ms and launches of kernels 1-2 together (their GEMMs, weight
    packing, narrow conv-transpose and GroupNorm epilogue) and of kernel 4
    in a chrome trace's kernel events, by OWN_KERNELS' names: the count
    ``profile-report``'s attribution is held to in phase 17."""
    conv = [k for k, v in OWN_KERNELS.items() if v != "gn_act_bwd" and "gn_cluster" not in k]
    out = {"kernels 1-2 ms": 0.0, "kernel 4 ms": 0.0, "kernels 1-2 launches": 0,
           "kernel 4 launches": 0}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name, ms = e["name"], e.get("dur", 0.0) / 1e3
        if "gn_bwd_" in name:
            out["kernel 4 ms"] += ms
            out["kernel 4 launches"] += "gn_bwd_cluster_kernel" in name
        elif any(k in name for k in conv):
            out["kernels 1-2 ms"] += ms
            out["kernels 1-2 launches"] += any(k in name for k in (
                "conv_wgmma_kernel", "conv_wmma_kernel", "conv_fma_kernel", "narrow_transpose"))
    return out


def phase_loop(smi, keep):
    """Phase 12: the `train` subcommand on the card (counts set to 0 just
    before the first run and read just after), its checkpoints, an exact
    resume against an uninterrupted run, SIGTERM in a process of its own,
    the data's and a save's times, and the `bench` line. The trace of the
    uninterrupted run is copied to ``<keep>/profile`` for phase 17."""
    import re

    from action_conditioned_gans_tpu_torch.bench import run_bench
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.data import make_dataset
    from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips
    from action_conditioned_gans_tpu_torch.ops.kernels import build
    from action_conditioned_gans_tpu_torch.train.state import init_state, state_to_host
    from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    overrides = [LOOP_ARGS[i + 1] for i, a in enumerate(LOOP_ARGS) if a == "--set"]
    cfg = apply_overrides(get_preset("config1"), overrides)
    os.makedirs(os.path.dirname(build.BUILD_DIR), exist_ok=True)
    devices, real_batch_at = set(), SyntheticClips.batch_at

    def batch_at(self, index):
        out = real_batch_at(self, index)
        devices.update(v.device.type for v in out.values())
        return out

    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="loop-", dir=os.path.dirname(build.BUILD_DIR)) as tmp:
        first, whole = os.path.join(tmp, "first"), os.path.join(tmp, "whole")
        # Exact resume: cuDNN's backward convolutions in their deterministic
        # algorithms for the three runs compared (the port's kernels are
        # deterministic: no atomics).
        torch.backends.cudnn.deterministic = True
        SyntheticClips.batch_at = batch_at
        try:
            reset_launches()
            out = run_cli(["train", *LOOP_ARGS, "--workdir", first, "--steps", "64"])
            launches = read_launches()
        finally:
            SyntheticClips.batch_at = real_batch_at
        lines = metric_lines(out)
        evals = [r for r in lines if "eval_l2" in r]
        check([r["step"] for r in lines] == [16, 32, 32, 48, 64, 64],
              f"metric lines at steps {[r['step'] for r in lines]}")
        check(all(np.isfinite(v) for r in lines for v in r.values()), "a non-finite metric line")
        # 64 steps, and a held-out rollout of rollout_length (1) generator
        # calls at B=8 at each sample_every boundary (32, 64).
        check_runs("config1 train loop", launches, {"config1 step": 64, "config1 serving": len(evals)})
        check(checkpoint_steps(first) == [32, 64], f"checkpoints {checkpoint_steps(first)}")
        check(devices == {"cuda"}, f"the loop's batches were on {devices}")
        cadence = re.search(r"p50 dispatch cadence ([0-9.]+) ms", out)
        check(cadence is not None, "the train run printed no p50 cadence")

        resumed = run_cli(["train", *LOOP_ARGS, "--workdir", first, "--steps", "96"])
        check("resumed from checkpoint at step 64" in resumed, "the second run did not resume at 64")
        # The uninterrupted run also traces steps 48-64 (--profile-steps): the
        # profiler reads the card's timeline and changes no value.
        run_cli(["train", *LOOP_ARGS, "--workdir", whole, "--steps", "96", "--profile-steps", "16"])
        torch.backends.cudnn.deterministic = deterministic
        traces = os.listdir(os.path.join(whole, "profile"))
        check(len(traces) == 1, f"--profile-steps wrote {traces}")
        with open(os.path.join(whole, "profile", traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        say(f"profile: {traces[0]} holds {kernels} device kernel events of steps 48-64")
        check(kernels > 0, "the loop's trace holds no device kernel")
        trace_totals = own_kernel_totals(events)
        say("profile: trace totals by chip_smoke's kernel table " + json.dumps(trace_totals))
        os.makedirs(os.path.join(keep, "profile"))
        shutil.copy(os.path.join(whole, "profile", traces[0]), os.path.join(keep, "profile"))
        same, max_diff, where = compare_states(final_params(first, 96), final_params(whole, 96))
        say(f"resume: 64 + 32 steps against 96 uninterrupted, cudnn.deterministic=True: "
            f"bit-identical {same}, max |d| {max_diff:.3e} at {where}")
        check(same, f"the resumed run differs from the uninterrupted one: {max_diff:.3e} at {where}")

        # The same comparison without cudnn.deterministic: two uninterrupted
        # runs in cuDNN's default algorithms (a finding, not a check).
        for name in ("default_a", "default_b"):
            run_cli(["train", *LOOP_ARGS, "--workdir", os.path.join(tmp, name), "--steps", "96"])
        same_default, diff_default, where_default = compare_states(
            final_params(os.path.join(tmp, "default_a"), 96),
            final_params(os.path.join(tmp, "default_b"), 96))
        say(f"two 96-step runs in cuDNN's default algorithms: bit-identical {same_default}, "
            f"max |d| {diff_default:.3e} at {where_default}")

        stopped, exit_s = sigterm_run(os.path.join(tmp, "sigterm"))
        say(f"sigterm: exit 0, checkpoint at step {stopped}, {exit_s:.2f} s from the signal "
            f"to the exit ({smi})")

        # The data: one call makes k*B clips on the card.
        dataset = make_dataset(cfg, stack=cfg.train.steps_per_call, device="cuda")
        dataset.batch_at(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for i in range(1, 6):
            dataset.batch_at(i)
        end.record()
        torch.cuda.synchronize()
        data_ms = (time.perf_counter() - t0) / 5 * 1e3
        data_device_ms = start.elapsed_time(end) / 5
        # One synchronous save of the config1 state: device -> host, torch.save.
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
        mgr = CheckpointManager(os.path.join(tmp, "save"), keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = state_to_host(state, cfg)
        t1 = time.perf_counter()
        mgr.save(1, host)
        t2 = time.perf_counter()
        size_mb = os.path.getsize(os.path.join(tmp, "save", "1", "state.pt")) / 1e6
    loop = dict(data_ms_per_call=data_ms, data_device_ms_per_call=data_device_ms,
                clips_per_call=cfg.train.batch_size * cfg.train.steps_per_call,
                save_ms=(t2 - t0) * 1e3, save_to_host_ms=(t1 - t0) * 1e3,
                save_write_ms=(t2 - t1) * 1e3, checkpoint_mb=size_mb,
                p50_cadence_ms_per_call=float(cadence.group(1)),
                p50_cadence_ms_per_step=float(cadence.group(1)) / cfg.train.steps_per_call,
                resume_bit_identical=same, default_cudnn_runs_bit_identical=same_default,
                sigterm_stop_step=stopped, card=smi)
    say("loop " + json.dumps(loop))

    bench = run_bench(cfg, device="cuda")
    say("bench " + json.dumps(bench) + f" ({smi})")
    torch.backends.cudnn.deterministic = True
    try:
        exact = run_bench(cfg, steps=12, device="cuda")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    say(f"bench with cudnn.deterministic=True (the resume comparison's setting): p50 "
        f"{exact['p50_step_latency_ms']:.3f} ms, p90 {exact['p90_step_latency_ms']:.3f} ms "
        f"a step ({smi})")
    check(0 < bench["roofline_utilization_analytic"] <= 1, "bench roofline share outside (0, 1]")
    check(bench["device"] == torch.cuda.get_device_name(0), "bench names another device")
    say(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches, loop["p50_cadence_ms_per_call"], trace_totals


# -- phases 13 and 14: config4 and config5 training --------------------------------


def config4_loop_args():
    """The `train` subcommand as phase 13 drives it: config4 at the preset's
    B=64, T=10, k=16, with CONFIG4_OVERRIDES, logs, checkpoints and held-out
    rollouts every 16 steps, 2 kept."""
    sets = [a for o in CONFIG4_OVERRIDES for a in ("--set", o)]
    return ["--preset", "config4", *sets, "--set", "train.log_every=16",
            "--set", "train.checkpoint_every=16", "--set", "train.sample_every=16",
            "--set", "train.checkpoint_keep=2"]


def phase_rollout_f32():
    """config4's generator in float32, TF32 off, B=2, T=10: the training
    rollout with scheduled sampling against the served rollout (mask all
    true) and against the folded teacher-forced rollout (mask all false),
    each within 1e-5."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.train.rollout import (
        rollout_generator,
        rollout_teacher_forced,
    )

    c4 = get_preset("config4")
    cfg = c4.replace(model=dataclasses.replace(c4.model, compute_dtype="float32"))
    predictor = Predictor(cfg, seeded_params(cfg, seed=13), device="cuda")
    apply = lambda params, f, a, st: predictor.generator(f, a, st)  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(13)
    size, horizon = cfg.model.image_size, cfg.train.rollout_length
    frames = torch.tanh(torch.randn((2, horizon + 1, size, size, 3), generator=gen, device="cuda"))
    actions = torch.randn((2, horizon, 4), generator=gen, device="cuda")
    states = torch.randn((2, horizon, 3), generator=gen, device="cuda")
    mask = lambda on: torch.full((2, horizon), on, dtype=torch.bool, device="cuda")  # noqa: E731
    with torch.no_grad():
        always = rollout_generator(apply, None, frames, actions, states, mask(True))
        never = rollout_generator(apply, None, frames, actions, states, mask(False))
        folded = rollout_teacher_forced(apply, None, frames, actions, states)
    served = predictor.rollout(frames[:, 0], actions, states)
    e_served = float((always - served).abs().max())
    e_folded = float((never - folded).abs().max())
    say(f"config4 rollout f32 B=2 T={horizon}: scheduled sampling all true vs Predictor.rollout "
        f"max|d|={e_served:.3e}, all false vs the teacher-forced fold max|d|={e_folded:.3e}")
    check(e_served <= 1e-5 and e_folded <= 1e-5, "the training rollout differs from its references")


def phase_config4(smi, totals, tmp):
    """Phase 13: config4 training at full width (bf16, B=64, T=10, k=16) with
    EMA, D augmentation and a scheduled-sampling mix: the `train` subcommand
    for 32 steps (counts set to 0 just before and read just after), a resume
    from its step-16 checkpoint to 32 held bit for bit against it (g_ema
    included, cudnn.deterministic on), its metric lines; then one counted
    step, every distinct kernel call of it against its plain version, 20
    timed steps and a profile; then the float32 rollout checks. The runs
    write under ``tmp``; phase 15 serves what they wrote."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.train.rollout import scheduled_sampling_prob

    t_phase = time.perf_counter()
    cfg = apply_overrides(get_preset("config4"), CONFIG4_OVERRIDES)
    horizon = cfg.train.rollout_length
    say(f"phase 13: config4 with {' '.join(CONFIG4_OVERRIDES)} (B={cfg.train.batch_size}, "
        f"T={horizon}, k={cfg.train.steps_per_call})")
    args = config4_loop_args()
    deterministic = torch.backends.cudnn.deterministic
    whole, resumed = os.path.join(tmp, "whole"), os.path.join(tmp, "resumed")
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        out = run_cli(["train", *args, "--workdir", whole, "--steps", "32"])
        launches = read_launches()
        # 32 steps, and at each sample_every boundary two held-out
        # rollouts (the parameters and their EMA) of T generator calls
        # at B=8; read before the resumed run adds its own.
        n_evals = sum(1 for r in metric_lines(out) if "eval_l2" in r)
        check_runs("config4 train loop", launches,
                   {"config4 step": 32, "config4 serving": 2 * n_evals * horizon})
        os.makedirs(os.path.join(resumed, "checkpoints"))
        shutil.copytree(os.path.join(whole, "checkpoints", "16"),
                        os.path.join(resumed, "checkpoints", "16"))
        again = run_cli(["train", *args, "--workdir", resumed, "--steps", "32"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check("resumed from checkpoint at step 16" in again, "the resumed run did not start at 16")
    lines = metric_lines(out)
    steps = [r for r in lines if "ss_prob" in r]
    evals = [r for r in lines if "eval_l2" in r]
    check([r["step"] for r in steps] == [16, 32] and [r["step"] for r in evals] == [16, 32],
          f"metric lines at steps {[r['step'] for r in lines]}")
    check(all(np.isfinite(v) for r in lines for v in r.values()), "a non-finite metric line")
    for r in steps:
        want = float(np.float32(scheduled_sampling_prob(r["step"] - 1, cfg.train)))
        check(r["ss_prob"] == want, f"ss_prob {r['ss_prob']} at step {r['step']}, want {want}")
    check(all({"eval_l2_ema", "eval_psnr_ema", "eval_ssim_ema"} <= set(r) for r in evals),
          "the held-out lines lack the EMA metrics")
    check(checkpoint_steps(whole) == [16, 32], f"checkpoints {checkpoint_steps(whole)}")
    same, max_diff, where = compare_states(final_params(whole, 32), final_params(resumed, 32))
    say(f"config4 resume: 16 + 16 steps against 32 uninterrupted, cudnn.deterministic=True "
        f"(g_ema included): bit-identical {same}, max |d| {max_diff:.3e} at {where}")
    check(same, f"the resumed config4 run differs: {max_diff:.3e} at {where}")
    launches_step, calls, conv_calls, _ = phase_training(cfg, "config4 step")
    phase_train_conv_parity(conv_calls, totals)
    phase_gn_bwd_call_parity(calls, "config4 step", totals["gn_act_bwd"])
    phase_rollout_f32()
    say(f"phase 13 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, launches_step


def phase_config5_reduced():
    """config5's widths at B=2, T=4 in float32, TF32 off, cuDNN's
    deterministic algorithms. G's gradients through the chunked rollout with
    remat against those without, within 1e-5 relative (bit-identity
    printed). One step with disc_microbatch=2 (4 chunks) against
    disc_microbatch=0: the losses within rtol 1e-5 / atol 1e-6, and both
    Adam states' first moments, which after the first step are (1 - b1)
    times the accumulated gradients, within the parameter bars of the JAX
    package's test_disc_microbatch_equivalence (atol 5e-6, rtol 1e-4). That
    comparison runs PyTorch's own convolutions (cuDNN off), which compute a
    sample alike at every batch size: cuDNN picks its float32 algorithms by
    batch size, and 4- and 16-sample calls differ by up to ~1e-4 of a
    gradient's largest entry. The entries beyond the JAX bars are printed,
    of the moments and of the updated parameters, with cuDNN off and on:
    Adam's first step moves each entry by lr * g / (|g| + 1e-8), so an entry
    whose gradient sits at float32's rounding floor moves by up to +-lr on a
    rounding difference."""
    from torch.func import functional_call

    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.models import Generator
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
    from action_conditioned_gans_tpu_torch.train.rollout import rollout_teacher_forced
    from action_conditioned_gans_tpu_torch.train.state import state_to_device, state_to_host

    c5 = get_preset("config5")
    cfg = c5.replace(model=dataclasses.replace(c5.model, compute_dtype="float32"),
                     train=dataclasses.replace(c5.train, batch_size=2, rollout_length=4))
    gen = torch.Generator(device="cuda").manual_seed(21)
    size = cfg.model.image_size
    frames = torch.tanh(torch.randn((2, 5, size, size, 3), generator=gen, device="cuda"))
    actions = torch.randn((2, 4, 4), generator=gen, device="cuda")
    ct = torch.randn((2, 4, size, size, 3), generator=gen, device="cuda")
    model = Generator(cfg.model, generator=torch.Generator().manual_seed(21)).cuda()
    apply = lambda p, f, a, st: functional_call(model, p, (f, a, st))  # noqa: E731

    def grads(remat):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in model.state_dict().items()}
        preds = rollout_teacher_forced(apply, leaves, frames, actions, None, time_chunk=2,
                                       remat=remat)
        return torch.autograd.grad(preds, list(leaves.values()), ct)

    state0 = init_state(cfg, torch.Generator().manual_seed(22), device="cuda")
    batch = dict(frames=frames, actions=actions)

    def run(mb):
        c = cfg.replace(train=dataclasses.replace(cfg.train, disc_microbatch=mb))
        return make_train_step(c, device="cuda")(state_to_device(state_to_host(state0), "cuda"),
                                                  batch)

    enabled, deterministic = torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with_remat, without = grads(True), grads(False)
        with_cudnn = run(0), run(2)
        torch.backends.cudnn.enabled = False
        (full, m_full), (chunked, m_chunk) = run(0), run(2)
    finally:
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = enabled, deterministic
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(with_remat, without))
    bits = all(torch.equal(a, b) for a, b in zip(with_remat, without))
    say(f"config5 widths f32 B=2 T=4, chunks of 2: G gradients with remat vs without: max "
        f"relative |d| {rel:.3e} (bar 1e-5), bit-identical {bits}")
    check(rel <= 1e-5, f"remat changes G's gradients by {rel:.3e} relative")

    worst_loss = worst_moment = 0.0
    for k in ("d_loss", "g_loss", "g_adv", "g_recon"):
        a, b = float(m_chunk[k]), float(m_full[k])
        check(abs(a - b) <= 1e-6 + 1e-5 * abs(b), f"disc_microbatch=2 {k} {a} vs {b}")
        worst_loss = max(worst_loss, abs(a - b))

    def beyond_bars(full, chunked):
        """{params: [entries of the moments beyond the JAX bars, entries of
        the updated parameters beyond them, the largest |gradient| among
        the latter]} of a microbatched state against the full batch's."""
        out = {}
        for name, opt in (("g_params", "g_opt"), ("d_params", "d_opt")):
            n_mu = n_p = 0
            largest = 0.0
            for k, v in getattr(full, opt).mu.items():
                n_mu += int(((getattr(chunked, opt).mu[k] - v).abs() > 5e-6 + 1e-4 * v.abs()).sum())
                p, q = getattr(chunked, name)[k], getattr(full, name)[k]
                over = (p - q).abs() > 5e-6 + 1e-4 * q.abs()
                if bool(over.any()):
                    n_p += int(over.sum())
                    g = (v.float()[over] / (1 - cfg.train.adam_b1)).abs()
                    largest = max(largest, float(g.max()))
            out[name] = [n_mu, n_p, largest]
        return out

    for opt in ("g_opt", "d_opt"):
        for k, v in getattr(full, opt).mu.items():
            err, ok = within(getattr(chunked, opt).mu[k], v, 5e-6, 1e-4)
            check(ok, f"disc_microbatch=2 {opt}.mu/{k} (the gradient) differs from the full "
                      f"batch's ({err:.3e})")
            worst_moment = max(worst_moment, err)
    say(f"config5 widths f32 B=2 T=4: disc_microbatch=2 (4 chunks) vs 0, cuDNN off: losses "
        f"max|d| {worst_loss:.3e} (rtol 1e-5, atol 1e-6), first moments max|d| "
        f"{worst_moment:.3e} (atol 5e-6, rtol 1e-4); entries beyond those bars (moments, "
        f"updated parameters, largest |gradient| among the latter): "
        f"{json.dumps(beyond_bars(full, chunked))}; the same with cuDNN on (deterministic "
        f"algorithms; not checked): {json.dumps(beyond_bars(with_cudnn[0][0], with_cudnn[1][0]))}")


def phase_config5(smi, totals):
    """Phase 14: config5 training at full width (bf16, 256², B=32, T=30,
    remat, time chunks of 2) with CONFIG5_OVERRIDES: 2 warm-up steps, one
    counted step and every distinct kernel call of it against its plain
    version, 3 timed steps, peak memory and a profile; then the reduced-size
    remat and microbatch parity."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset

    t_phase = time.perf_counter()
    cfg = apply_overrides(get_preset("config5"), CONFIG5_OVERRIDES)
    t = cfg.train
    say(f"phase 14: config5 with {' '.join(CONFIG5_OVERRIDES)} (B={t.batch_size}, "
        f"T={t.rollout_length}, remat {t.remat_rollout}, time chunk {t.rollout_time_chunk})")
    launches, calls, conv_calls, norm_calls = phase_training(cfg, "config5 step", steps=3,
                                                             warmup=2, n_batches=2)
    phase_train_conv_parity(conv_calls, totals)
    phase_train_norm_parity(norm_calls, totals["group_norm_act"])
    phase_gn_bwd_call_parity(calls, "config5 step", totals["gn_act_bwd"])
    phase_config5_reduced()
    say(f"phase 14 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phases 15 and 16: what `train` writes, served; the repairs ----------------------

PNG_SIGNATURE, GIF_SIGNATURE = b"\x89PNG\r\n\x1a\n", b"GIF89a"


def p50_ms(fn, iters=100, warmup=3):
    """The median of ``iters`` calls of ``fn``, each between two CUDA events
    (host dispatch included where the host is the limit)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def serving_inputs(cfg, batch, horizon, roll_batch, seed):
    """(predict args, rollout args) as numpy arrays for ``cfg``'s generator."""
    m = cfg.model
    rng = np.random.default_rng(seed)
    frame = np.tanh(rng.standard_normal((batch, m.image_size, m.image_size, 3))).astype(np.float32)
    action = rng.standard_normal((batch, m.action_dim)).astype(np.float32)
    actions = rng.standard_normal((roll_batch, horizon, m.action_dim)).astype(np.float32)
    state = states = None
    if m.state_dim:
        state = rng.standard_normal((batch, m.state_dim)).astype(np.float32)
        states = rng.standard_normal((roll_batch, horizon, m.state_dim)).astype(np.float32)
    return (frame, action, state), (frame[:roll_batch], actions, states)


def same_outputs(a, b, predict_args, rollout_args):
    """Whether predictors ``a`` and ``b`` give the same bits on both calls."""
    return (torch.equal(a.predict(*predict_args), b.predict(*predict_args))
            and torch.equal(a.rollout(*rollout_args), b.rollout(*rollout_args)))


def check_program_runs(label, launches, runs):
    """An exported program's launches against EXPECTED (kernels 1-3, and
    kernels 1-2 by mainloop); its routes were fixed when it was traced, so
    serving it counts none."""
    from action_conditioned_gans_tpu_torch.ops import api

    say(f"main path {label}: launches {launches} over "
        + ", ".join(f"{n} generator calls of {p}" for p, n in runs.items()))
    check_launches(label, launches, runs)
    check(not any(api.ROUTES.values()), f"{label}: serving the program routed {api.ROUTES}")


def check_traced_routes(label, path, calls):
    """The routes an export traced: EXPECTED's per generator call, ``calls``
    times; tracing launches no kernel."""
    from action_conditioned_gans_tpu_torch.ops import api

    fused, split = EXPECTED[path][2]
    want = {**dict.fromkeys(api.ROUTES, 0), "fused": fused * calls, "split": split * calls}
    check(api.ROUTES == want, f"{label}: the export traced routes {api.ROUTES}, want {want}")
    launched = {k: v for k, v in read_launches().items() if v}
    check(not launched, f"{label}: tracing launched {launched}")


def serve_process(argv):
    """``serve ... --port 0`` in a process of its own; (process, base URL)
    once it prints its banner."""
    cmd = [sys.executable, "-m", "action_conditioned_gans_tpu_torch", "serve", *argv,
           "--port", "0"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines, banner = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith('{"serving"'):
                banner.set()

    threading.Thread(target=read, daemon=True).start()
    if not banner.wait(timeout=300):
        proc.kill()
        proc.wait()
        check(False, "the serve process printed no banner: " + "".join(lines[-20:]))
    url = json.loads(next(line for line in lines if line.startswith('{"serving"')))["serving"]
    return proc, url


def phase_served(smi, whole):
    """Phase 15: config4's step-32 checkpoint from phase 13 (EMA, state_dim 3,
    preset widths) restored, served over HTTP by `serve --workdir --ema` in a
    process of its own, exported as npz and as the AOT program (`export
    --format pt2`), sampled and evaluated; config5's AOT program from seeded
    weights, exported on the CPU and on cuda and served on cuda; the AOT and
    live predictors' p50 predict times."""
    from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.serve import client_predict, client_rollout, to_host

    t_phase = time.perf_counter()
    tmp = os.path.dirname(whole)
    cfg = apply_overrides(get_preset("config4"), CONFIG4_OVERRIDES)
    horizon = cfg.train.rollout_length
    check(checkpoint_steps(whole)[-1] == 32, f"checkpoints {checkpoint_steps(whole)}")
    stored = torch.load(os.path.join(whole, "checkpoints", "32", "state.pt"), weights_only=True)
    check("g_ema" in stored, "the step-32 checkpoint holds no EMA weights")
    say(f"phase 15: config4's step-32 checkpoint ({whole}), served ({smi})")
    args_p, args_r = serving_inputs(cfg, 64, horizon, 16, seed=15)

    # Restore, with and without EMA, against Predictors on the stored trees.
    live = {}
    for use_ema, key in ((False, "g_params"), (True, "g_ema")):
        restored = Predictor.from_checkpoint(cfg, whole, use_ema=use_ema, device="cuda")
        live[key] = Predictor(cfg, stored[key], device="cuda")
        check(same_outputs(restored, live[key], args_p, args_r),
              f"from_checkpoint(use_ema={use_ema}) differs from a Predictor on the stored {key}")
    differ = not torch.equal(live["g_params"].predict(*args_p), live["g_ema"].predict(*args_p))
    say(f"restore: from_checkpoint and use_ema=True equal Predictors on the stored g_params / "
        f"g_ema bit for bit (B=64 predict, T={horizon} B=16 rollout); EMA output differs from "
        f"the parameters' {differ}")

    # `serve --workdir --ema` in a process of its own.
    t0 = time.perf_counter()
    proc, url = serve_process(["--preset", "config4", "--workdir", whole, "--ema"])
    up_s = time.perf_counter() - t0
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        check(meta["ok"] is True and meta["state_dim"] == 3
              and meta["device"] == torch.cuda.get_device_name(0), f"healthz {meta}")
        (f, a, st), (f0, acts, sts) = args_p, args_r
        via_p = client_predict(url, f[:8], a[:8], st[:8])
        via_r = client_rollout(url, f0[:4], acts[:4], sts[:4])
        check(np.array_equal(via_p, to_host(live["g_ema"].predict(f[:8], a[:8], st[:8]))),
              "serve --workdir --ema: /predict differs from the direct call")
        check(np.array_equal(via_r, to_host(live["g_ema"].rollout(f0[:4], acts[:4], sts[:4]))),
              "serve --workdir --ema: /rollout differs from the direct call")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    say(f"serve --workdir --ema: up in {up_s:.1f} s; /healthz, /predict (B=8) and /rollout "
        f"(T={horizon}, B=4) equal the direct calls")

    # export (npz), read back.
    npz = os.path.join(tmp, "generator.npz")
    out = metric_lines(run_cli(["export", "--preset", "config4", "--workdir", whole,
                                "--out", npz]))[-1]
    check(out == {"exported": npz, "ema": False}, f"export printed {out}")
    check(same_outputs(Predictor.from_npz(npz, device="cuda"), live["g_params"], args_p, args_r),
          "from_npz of the exported archive differs from the checkpoint's parameters")
    say("export: the npz archive read back by from_npz gives the same bits")

    # export --format pt2, served by AotPredictor.
    aot_path = os.path.join(tmp, "generator.aot")
    reset_launches()
    t0 = time.perf_counter()
    out = metric_lines(run_cli(["export", "--preset", "config4", "--workdir", whole,
                                "--format", "pt2", "--rollout-length", str(horizon),
                                "--out", aot_path]))[-1]
    timings = {"config4_export_s": time.perf_counter() - t0, "config4_aot_bytes": out["bytes"]}
    check(out["rollout_lengths"] == [horizon] and out["bytes"] == os.path.getsize(aot_path),
          f"export --format pt2 printed {out}")
    check_traced_routes("config4 export", "config4 serving", 1 + horizon)
    aot = AotPredictor(aot_path, device="cuda")
    reset_launches()
    p_aot = aot.predict(*args_p)
    r_aot = aot.rollout(*args_r)
    torch.cuda.synchronize()
    launches = {"config4 AOT program": read_launches()}
    check_program_runs("config4 AOT program", launches["config4 AOT program"],
                       {"config4 serving": 1 + horizon})
    check(torch.equal(p_aot, live["g_params"].predict(*args_p))
          and torch.equal(r_aot, live["g_params"].rollout(*args_r)),
          "the config4 AOT program differs from the live predictor")
    say(f"export --format pt2: {out['bytes']} bytes in {timings['config4_export_s']:.1f} s; "
        f"AotPredictor on cuda: B=64 predict and T={horizon} B=16 rollout bit-identical to the "
        "live predictor")

    # sample and eval.
    samples = os.path.join(tmp, "samples")
    t0 = time.perf_counter()
    got = metric_lines(run_cli(["sample", "--preset", "config4", "--workdir", whole,
                                "--num-clips", "8", "--out", samples]))[-1]
    timings["sample_s"] = time.perf_counter() - t0
    files = ["pred_final_frame.png", "gt_final_frame.png"] + [
        f"{kind}_{i}.{ext}" for i in range(4) for kind, ext in (("rollout", "gif"), ("strip", "png"))]
    check(sorted(os.listdir(samples)) == sorted(files), f"sample wrote {os.listdir(samples)}")
    for name in files:
        with open(os.path.join(samples, name), "rb") as fh:
            head = fh.read(8)
        want = GIF_SIGNATURE if name.endswith(".gif") else PNG_SIGNATURE
        check(head.startswith(want), f"{name} does not start with its signature")
    check(all(np.isfinite(v) for v in got.values()), f"sample metrics {got}")
    t0 = time.perf_counter()
    ev = metric_lines(run_cli(["eval", "--preset", "config4", "--workdir", whole]))[-1]
    timings["eval_s"] = time.perf_counter() - t0
    check(ev["eval_batches"] == 8 and ev["eval_horizon"] == horizon
          and all(np.isfinite(v) for v in ev.values()), f"eval printed {ev}")
    say(f"sample: {len(files)} files with PNG / GIF signatures, {json.dumps(got)}; "
        f"eval: {json.dumps(ev)}")

    # config5 from seeded weights: exported on the CPU and on cuda, served on cuda.
    c5 = get_preset("config5")
    params5 = seeded_params(c5, seed=0)
    live5 = Predictor(c5, params5, device="cuda")
    args5_p, args5_r = serving_inputs(c5, 32, 4, 8, seed=16)
    for where in ("cpu", "cuda"):
        path = os.path.join(tmp, f"config5-{where}.aot")
        reset_launches()
        t0 = time.perf_counter()
        meta = export_aot(c5, flax_to_state_dict(params5), path, rollout_length=4, device=where)
        timings[f"config5_export_on_{where}_s"] = time.perf_counter() - t0
        timings[f"config5_aot_bytes_{where}"] = meta["bytes"]
        check_traced_routes(f"config5 export on {where}", "config5 serving", 5)
        program = AotPredictor(path, device="cuda")
        reset_launches()
        p_aot, r_aot = program.predict(*args5_p), program.rollout(*args5_r)
        torch.cuda.synchronize()
        label = f"config5 AOT program exported on {where}"
        launches[label] = read_launches()
        check_program_runs(label, launches[label], {"config5 serving": 5})
        check(torch.equal(p_aot, live5.predict(*args5_p))
              and torch.equal(r_aot, live5.rollout(*args5_r)),
              f"{label} differs from the live predictor")
        say(f"{label}: served on cuda, B=32 predict and T=4 B=8 rollout bit-identical to the "
            "live predictor")

    # p50 predict, AOT against live, in turns (live, AOT, AOT, live).
    c1 = get_preset("config1")
    params1 = seeded_params(c1, seed=0)
    path1 = os.path.join(tmp, "config1.aot")
    export_aot(c1, flax_to_state_dict(params1), path1, device="cuda")
    for name, (lv, program, (f, a, _)) in {
        "config1_b128": (Predictor(c1, params1, device="cuda"), AotPredictor(path1, device="cuda"),
                         serving_inputs(c1, 128, 1, 1, seed=17)[0]),
        "config5_b32": (live5, AotPredictor(os.path.join(tmp, "config5-cpu.aot"), device="cuda"),
                        args5_p),
    }.items():
        f_t, a_t = torch.from_numpy(f).cuda(), torch.from_numpy(a).cuda()
        runs = {"live": [], "aot": []}
        for side in ("live", "aot", "aot", "live"):
            fn = lv.predict if side == "live" else program.predict
            runs[side].append(p50_ms(lambda: fn(f_t, a_t)))
        timings[f"{name}_live_p50_ms"] = runs["live"]
        timings[f"{name}_aot_p50_ms"] = runs["aot"]
    say("aot " + json.dumps({**timings, "card": smi}))
    say(f"phase 15 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def phase_fault1(smi):
    """Phase 16, ROADMAP Queue 3 fault 1: config5 at 512x512, g_levels=6,
    d_levels=7, B=2, in bfloat16 and in float32: one predict and one training
    step (T=2) on cuda, ROUTES["group_plain"] held to FAULT1_GROUP_PLAIN, and
    each off-envelope GroupNorm's output against reference.norm_act in
    float32 on the same input (float32 within 1e-4 abs + 1e-4 rel, bfloat16
    within 3e-2); losses finite; peak memory printed."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.ops import api, envelope, reference
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    real = api.norm_act
    for dtype in ("bfloat16", "float32"):
        cfg = apply_overrides(get_preset("config5"),
                              FAULT1_OVERRIDES + [f"model.compute_dtype={dtype}"])
        seen = []

        def recording(x, scale, bias, **kw):
            out = real(x, scale, bias, **kw)
            if kw["kind"] == "group" and not envelope.group_norm_act_supported(x.shape):
                # The step updates scale and bias in place: keep this call's.
                seen.append((x.detach(), scale.detach().clone(), bias.detach().clone(), kw,
                             out.detach()))
            return out

        api.norm_act = recording
        try:
            predictor = Predictor(cfg, seeded_params(cfg, seed=31), device="cuda")
            (frame, action, _), _ = serving_inputs(cfg, 2, 1, 1, seed=31)
            api.reset_routes()
            out = predictor.predict(frame, action)
            torch.cuda.synchronize()
            n_predict = api.ROUTES["group_plain"]
            check(tuple(out.shape) == (2, 512, 512, 3) and bool(torch.isfinite(out.float()).all()),
                  f"fault 1 {dtype}: predict output")
            del predictor
            state = init_state(cfg, torch.Generator().manual_seed(32), device="cuda")
            step = make_train_step(cfg, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(33)
            batch = dict(frames=torch.tanh(torch.randn((2, 3, 512, 512, 3), generator=gen,
                                                       device="cuda")),
                         actions=torch.randn((2, 2, 4), generator=gen, device="cuda"))
            torch.cuda.reset_peak_memory_stats()
            api.reset_routes()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            n_step = api.ROUTES["group_plain"]
        finally:
            api.norm_act = real
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        metrics = {k: float(v) for k, v in metrics.items()}
        check((n_predict, n_step) == FAULT1_GROUP_PLAIN,
              f"fault 1 {dtype}: group_plain {n_predict} in a predict and {n_step} in a step, "
              f"want {FAULT1_GROUP_PLAIN}")
        check(all(np.isfinite(v) for v in metrics.values()), f"fault 1 {dtype}: metrics {metrics}")
        worst, shapes = 0.0, {}
        for x, scale, bias, kw, got in seen:
            want = reference.norm_act(x.float(), scale, bias, **kw)
            err, ok = within(got, want, *((1e-4, 1e-4) if dtype == "float32" else (3e-2, 0.0)))
            check(ok, f"fault 1 {dtype}: GroupNorm over x{tuple(x.shape)} is {err:.3e} from "
                      "reference.norm_act in float32")
            worst = max(worst, err)
            shapes[str(tuple(x.shape))] = shapes.get(str(tuple(x.shape)), 0) + 1
        say(f"fault 1 {dtype}: 512x512 g6 d7 B=2: {n_predict} off-envelope GroupNorms in a "
            f"predict, {n_step} in a training step (T=2, remat) on the plain composite "
            f"{json.dumps(shapes)}; max |d| against reference.norm_act in float32 {worst:.3e}; "
            f"losses {json.dumps(metrics)}; step peak memory {peak_gb:.2f} GB ({smi})")


def phase_config2(smi, totals, tmp):
    """Phase 16, ROADMAP Queue 3 fault 2: config2 (T=10, B=16, k=32) through
    `train` for 32 steps (counts set to 0 just before and read just after:
    EXPECTED["config2 step"] x 32 plus the held-out rollout's generator
    calls), then one counted step, its distinct conv and kernel-4 calls at
    phases 10 and 11's bars, 20 timed steps and a profile."""
    from action_conditioned_gans_tpu_torch.config import get_preset

    cfg = get_preset("config2")
    workdir = os.path.join(tmp, "config2")
    reset_launches()
    out = run_cli(["train", "--preset", "config2", "--workdir", workdir, "--steps", "32",
                   "--set", "train.sample_every=32"])
    launches = {"config2 train loop": read_launches()}
    lines = metric_lines(out)
    n_evals = sum(1 for r in lines if "eval_l2" in r)
    check(n_evals == 1 and [r["step"] for r in lines] == [32, 32],
          f"config2 metric lines at steps {[r['step'] for r in lines]}")
    check(all(np.isfinite(v) for r in lines for v in r.values()), "a non-finite metric line")
    check(checkpoint_steps(workdir) == [32], f"checkpoints {checkpoint_steps(workdir)}")
    check_runs("config2 train loop", launches["config2 train loop"],
               {"config2 step": 32, "config1 serving": n_evals * cfg.train.rollout_length})
    launches["config2 step"], calls, conv_calls, _ = phase_training(cfg, "config2 step")
    phase_train_conv_parity(conv_calls, totals)
    phase_gn_bwd_call_parity(calls, "config2 step", totals["gn_act_bwd"])
    return launches


# -- phase 17: training on clip files ---------------------------------------------------

FILE_CLIPS, EVAL_CLIPS = 512, 64  # config1 clips: 30 frames of 64x64, raw (~190 MB)


def native_state():
    """{file: (mtime_ns, sha256)} of ``native/``, which no build may touch."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(os.path.join(ROOT, "native"))):
        path = os.path.join(ROOT, "native", name)
        with open(path, "rb") as f:
            out[name] = (os.stat(path).st_mtime_ns, hashlib.sha256(f.read()).hexdigest())
    return out


def cli_process(argv, timeout=600):
    """The CLI in a process of its own: (exit code, standard output and error)."""
    proc = subprocess.run([sys.executable, "-m", "action_conditioned_gans_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def file_loop_args(data_dir, eval_dir, *extra):
    """Phase 12's `train` arguments on clip files (TF-free reader, bf16
    frames on the host), with ``extra`` overrides last."""
    sets = ["data.source=tfrecord_native", f"data.data_dir={data_dir}",
            f"data.eval_data_dir={eval_dir}", "data.device_dtype=bfloat16", *extra]
    return [*LOOP_ARGS, *[a for kv in sets for a in ("--set", kv)]]


def file_data_numbers(out):
    """The loop's p50 cadence and `file data per call` numbers."""
    import re

    cadence = re.search(r"p50 dispatch cadence ([0-9.]+) ms", out)
    data = re.search(r"file data per call: fill ([0-9.]+) ms \| wait ([0-9.]+) ms \| (\d+) calls",
                     out)
    check(cadence is not None and data is not None, "the file run printed no cadence or no "
          "`file data` line: " + out[-2000:])
    return dict(p50_cadence_ms_per_call=float(cadence.group(1)), fill_ms_per_call=float(data[1]),
                wait_ms_per_call=float(data[2]), calls=int(data[3]))


def phase_file_data(smi, phase12_dir, synthetic_cadence_ms, phase12_totals):
    """Phase 17: `make-data` writes config1 clips and a held-out split in a
    process of its own; `train` reads them through the TF-free reader at
    phase 12's settings (counts set to 0 just before the 32-step run, read
    just after), resumes from step 16 bit for bit across the files' epoch;
    the cadence and the reader's host and copy times, serially and with 4
    decode threads; `doctor` in a process of its own; `profile-report` on
    phase 12's trace, held to chip_smoke's own totals of that trace."""
    import re

    from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
    from action_conditioned_gans_tpu_torch.data import pipeline
    from action_conditioned_gans_tpu_torch.ops.kernels import build
    from action_conditioned_gans_tpu_torch.utils.trace_report import load_trace, summarize

    t_phase = time.perf_counter()
    say(f"phase 17: config1 on clip files ({smi})")
    before = native_state()
    deterministic = torch.backends.cudnn.deterministic
    with tempfile.TemporaryDirectory(prefix="files-", dir=os.path.dirname(build.BUILD_DIR)) as tmp:
        data_dir, eval_dir = os.path.join(tmp, "data"), os.path.join(tmp, "eval")
        # The two make-data processes run at once.
        t0, procs = time.perf_counter(), {}
        for label, n, out, seed in (("train", FILE_CLIPS, data_dir, 0),
                                     ("eval", EVAL_CLIPS, eval_dir, 1)):
            procs[label] = (subprocess.Popen(
                [sys.executable, "-m", "action_conditioned_gans_tpu_torch", "make-data",
                 "--preset", "config1", "--num-clips", str(n), "--set", f"train.seed={seed}",
                 "--workdir", tmp, "--out", os.path.join(out, "clips.tfrecord")],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
        made = {}
        for label, (proc, out) in procs.items():
            text, _ = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"make-data exited {proc.returncode}: {text[-2000:]}")
            made[label] = dict(seconds=time.perf_counter() - t0,
                               bytes=os.path.getsize(os.path.join(out, "clips.tfrecord")))
        say("make-data " + json.dumps(made) + f" ({smi})")
        lib = nt.library_path()
        check(os.path.exists(lib) and lib.startswith(os.path.join(ROOT, "build", "native")),
              f"the native library is not built under build/native: {lib}")
        for label, path, n in (("train", data_dir, FILE_CLIPS), ("eval", eval_dir, EVAL_CLIPS)):
            clips = list(nt.read_clips(os.path.join(path, "clips.tfrecord"), 30, 64, 64))
            check(len(clips) == n and clips[0][0].shape == (30, 64, 64, 3)
                  and clips[0][1].shape == (30, 4), f"the {label} file holds {len(clips)} clips")
        del clips

        devices, real_batch_at = set(), pipeline.Prefetcher.batch_at

        def batch_at(self, index):
            out = real_batch_at(self, index)
            devices.update(v.device.type for v in out.values())
            return out

        whole, first = os.path.join(tmp, "whole"), os.path.join(tmp, "first")
        args = file_loop_args(data_dir, eval_dir, "train.checkpoint_every=16")
        torch.backends.cudnn.deterministic = True
        pipeline.Prefetcher.batch_at = batch_at
        try:
            reset_launches()
            out = run_cli(["train", *args, "--workdir", whole, "--steps", "32"])
            launches = read_launches()
            # 32 steps and one held-out rollout (rollout_length 1: one generator call).
            check_runs("config1 file loop", launches, {"config1 step": 32, "config1 serving": 1})
            # The resume starts from the uninterrupted run's step-16 checkpoint.
            shutil.copytree(os.path.join(whole, "checkpoints", "16"),
                            os.path.join(first, "checkpoints", "16"))
            resumed = run_cli(["train", *args, "--workdir", first, "--steps", "32"])
        finally:
            pipeline.Prefetcher.batch_at = real_batch_at
            torch.backends.cudnn.deterministic = deterministic
        evals = [r for r in metric_lines(out) if "eval_l2" in r]
        check(len(evals) == 1 and all(np.isfinite(v) for v in evals[0].values()),
              f"held-out lines {evals}")
        check(devices == {"cuda"}, f"the file loop's batches were on {devices}")
        check("resumed from checkpoint at step 16" in resumed, "the second run did not resume")
        same, max_diff, where = compare_states(final_params(first, 32), final_params(whole, 32))
        say(f"file resume: 16 + 16 steps against 32 uninterrupted (the 512-clip file wraps in "
            f"each call), cudnn.deterministic=True: bit-identical {same}, max |d| {max_diff:.3e} "
            f"at {where}")
        check(same, f"the resumed file run differs: {max_diff:.3e} at {where}")
        fill = [t.name for t in threading.enumerate() if t.name == pipeline.FILL_THREAD]
        check(not fill, f"{len(fill)} reader fill thread(s) outlived their loop")

        # Cadence: 4 calls a run without checkpoints, the synthetic stream
        # beside the files read serially and on 4 decode threads; each file
        # run traces its last call for the device's busy share and the copies.
        timed = {}
        for label, extra in (("synthetic", None), ("files", "data.decode_threads=0"),
                             ("files, 4 decode threads", "data.decode_threads=4")):
            run_args = [*LOOP_ARGS, "--set", "train.checkpoint_every=0"]
            if extra:
                run_args = file_loop_args(data_dir, eval_dir, "train.checkpoint_every=0", extra)
            wd = os.path.join(tmp, f"timed{len(timed)}")
            out = run_cli(["train", *run_args, "--workdir", wd, "--steps", "64",
                           *(["--profile-steps", "16"] if extra else [])])
            if not extra:
                timed[label] = float(re.search(r"p50 dispatch cadence ([0-9.]+) ms", out).group(1))
                continue
            trace = load_trace(os.path.join(wd, "profile"))
            busy = summarize(trace)
            # The H2D copies in the traced call: the fill thread's copy of
            # the next batch (bf16 frames, actions, states) from pinned memory.
            h2d = [e for e in trace["traceEvents"] if e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", "")]
            timed[label] = dict(file_data_numbers(out), device_busy_share=busy.busy_share,
                                device_busy_ms=busy.busy_us / 1e3,
                                traced_window_ms=busy.window_us / 1e3,
                                h2d_copies_in_traced_call=len(h2d),
                                h2d_copy_device_ms_in_traced_call=sum(e["dur"] for e in h2d) / 1e3)
        line = dict(timed["files"], synthetic_p50_cadence_ms_per_call=timed["synthetic"],
                    phase12_synthetic_p50_cadence_ms_per_call=synthetic_cadence_ms,
                    decode_threads_4=timed["files, 4 decode threads"],
                    h2d_bytes_per_call=128 * 16 * (2 * 64 * 64 * 3 * 2 + 7 * 4),
                    clips_per_call=128 * 16, make_data=made, card=smi)
        say("file data " + json.dumps(line))

        rc, text = cli_process(["doctor", *file_loop_args(data_dir, eval_dir),
                                "--workdir", whole])
        check(rc == 0, f"doctor exited {rc}: {text[-3000:]}")
        report = json.loads(text[text.index("{"):text.rindex("}") + 1])
        for key in ("device", "kernels", "native_lib"):
            check(report[key]["ok"], f"doctor: {key} {report[key]}")
        check(report["toolchain"]["nvcc"]["ok"], f"doctor: nvcc {report['toolchain']['nvcc']}")
        say(f"doctor: ok; device {report['device']}, nvcc {report['toolchain']['nvcc']['version']}"
            f", kernels {report['kernels']['hash']}, native {report['native_lib']['path']}")

    # profile-report on phase 12's trace: steps 48-64 and the held-out rollout at 64.
    summary_path = os.path.join(phase12_dir, "report.json")
    rc, text = cli_process(["profile-report", "--workdir", phase12_dir, "--json", summary_path])
    check(rc == 0, f"profile-report exited {rc}: {text[-2000:]}")
    say("profile-report (phase 12's trace):\n" + text[-3000:])
    with open(summary_path) as f:
        report = json.load(f)
    k = report["kernels"]
    want = {name: EXPECTED["config1 step"][0][name] * 16 + EXPECTED["config1 serving"][0][name]
            for name in KERNEL_INFO}
    for name in ("conv_norm_act", "conv_transpose_norm_act", "gn_act_bwd", "adam_flat"):
        check(k[name]["launches"] == want[name], f"profile-report: {name} launched "
              f"{k[name]['launches']} times in the trace, want {want[name]}")
    mine = {"kernels 1-2 ms": (k["conv_norm_act"]["device_us"]
                               + k["conv_transpose_norm_act"]["device_us"]) / 1e3,
            "kernel 4 ms": k["gn_act_bwd"]["device_us"] / 1e3}
    for key, value in mine.items():
        ref = phase12_totals[key]
        check(abs(value - ref) <= 0.02 * ref, f"profile-report: {key} {value:.4f} against "
              f"phase 12's {ref:.4f}")
    say(f"profile-report: launches {[k[n]['launches'] for n in KERNEL_INFO]} (want {want}); "
        f"{json.dumps(mine)} against phase 12's {json.dumps(phase12_totals)}; steps "
        f"{report['steps']}, busy share {report['busy_share']:.4f}")
    after = native_state()
    check(after == before, f"native/ changed: {before} -> {after}")
    say(f"phase 17 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phase 18: R1, batch norm and the engine knobs -----------------------------------


def phase18_config(path):
    """Phase 18's config of ``path``: PHASE18_OVERRIDES on config1 as phase
    12 trains it (``config1_train_config``), or on config5 as phase 14 does."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset

    base = (config1_train_config() if path.startswith("config1")
            else apply_overrides(get_preset("config5"), CONFIG5_OVERRIDES))
    return apply_overrides(base, PHASE18_OVERRIDES[path])


def phase18_loop(path, serving, tmp):
    """``train`` with phase 12's arguments and ``path``'s overrides for 32
    steps (counts set to 0 just before, read just after): EXPECTED[path] x 32
    plus ``serving`` for the held-out rollout's generator call at step 32;
    every metric line finite. Returns (launches, the training metric lines)."""
    sets = [a for o in PHASE18_OVERRIDES[path] for a in ("--set", o)]
    reset_launches()
    out = run_cli(["train", *LOOP_ARGS, *sets, "--workdir", os.path.join(tmp, path.split()[1]),
                   "--steps", "32"])
    launches = read_launches()
    lines = metric_lines(out)
    check([r["step"] for r in lines] == [16, 32, 32], f"{path}: metric lines at steps "
          f"{[r['step'] for r in lines]}")
    check(all(np.isfinite(v) for r in lines for v in r.values()), f"{path}: a non-finite metric")
    evals = [r for r in lines if "eval_l2" in r]
    check_runs(path.replace("step", "train loop"), launches, {path: 32, serving: len(evals)})
    return launches, [r for r in lines if "eval_l2" not in r]


def fresh_copy(state, device):
    from action_conditioned_gans_tpu_torch.train.state import state_to_device, state_to_host

    return state_to_device(state_to_host(state), device)


def first_moments_within(a, b, atol, rtol, label, which=("g_opt", "d_opt")):
    """Check the Adam first moments (after one step, (1 - b1) times the
    gradients) of states ``a`` and ``b``; returns the largest |d|."""
    worst = 0.0
    for opt in which:
        for k, v in getattr(b, opt).mu.items():
            err, ok = within(getattr(a, opt).mu[k].cpu(), v.cpu(), atol, rtol)
            check(ok, f"{label}: {opt}.mu/{k} differs ({err:.3e}; its largest |entry| "
                      f"{float(v.abs().max()):.3e})")
            worst = max(worst, err)
    return worst


def phase_r1_f32():
    """config1 widths, B=4, float32 with float32 moments, TF32 off: one R1
    step on cuda against the same step on the CPU's plain path (d_r1 within
    1e-4 relative, D's first moments within 1e-4 abs + 1e-3 rel); then on
    cuda, cuDNN off, disc_microbatch=2 against 0 at the bars of
    tests/test_train_step.py::test_r1_microbatch_equivalence (d_r1 rtol 1e-5
    / atol 1e-7; both first moments atol 5e-6 / rtol 1e-4)."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    cfg = apply_overrides(phase18_config("config1 r1 step"), [
        "model.compute_dtype=float32", "train.adam_moment_dtype=float32", "train.batch_size=4"])
    state0 = init_state(cfg, torch.Generator().manual_seed(24), device="cpu")
    rng = np.random.default_rng(24)
    batch = dict(frames=np.tanh(rng.standard_normal((4, 2, 64, 64, 3))).astype(np.float32),
                 actions=rng.standard_normal((4, 1, 4)).astype(np.float32))

    def run(device, mb=0):
        c = apply_overrides(cfg, [f"train.disc_microbatch={mb}"])
        return make_train_step(c, device=device)(fresh_copy(state0, device), batch)

    (on_gpu, m_gpu), (on_cpu, m_cpu) = run("cuda"), run("cpu")
    a, b = float(m_gpu["d_r1"]), float(m_cpu["d_r1"])
    check(np.isfinite(a) and a > 0 and abs(a - b) <= 1e-4 * abs(b),
          f"R1 f32: d_r1 on cuda {a} vs the CPU's {b}")
    worst_cpu = first_moments_within(on_gpu, on_cpu, 1e-4, 1e-3, "R1 f32 cuda vs cpu", ("d_opt",))
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        (full, m_full), (chunked, m_chunk) = run("cuda", 0), run("cuda", 2)
    finally:
        torch.backends.cudnn.enabled = enabled
    c, f = float(m_chunk["d_r1"]), float(m_full["d_r1"])
    check(abs(c - f) <= 1e-7 + 1e-5 * abs(f), f"R1 disc_microbatch=2: d_r1 {c} vs {f}")
    worst_mb = first_moments_within(chunked, full, 5e-6, 1e-4, "R1 disc_microbatch=2 vs 0")
    say(f"config1 widths f32 B=4, R1: d_r1 cuda {a:.6e} vs cpu {b:.6e} (rel {abs(a - b) / b:.2e}, "
        f"bar 1e-4), D first moments max|d| {worst_cpu:.3e} (1e-4 + 1e-3 rel); "
        f"disc_microbatch=2 vs 0 (cuDNN off): d_r1 |d| {abs(c - f):.3e}, first moments max|d| "
        f"{worst_mb:.3e} (atol 5e-6, rtol 1e-4)")


def phase_bare_conv_f32(conv_calls):
    """Each distinct bare conv of the counted batch-norm step (kernel 1 or 2
    with kind "none", act "none", no bias) in float32 against its plain
    version, TF32 off: phase 2's float32 bar, 1e-3 abs + 1e-3 rel."""
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    bare = [c for c in dict.fromkeys(conv_calls) if c[5]]
    check(bare, "the batch-norm step made no bare conv call")
    with torch.inference_mode():
        for i, (name, x_shape, _, w_shape, kw, _) in enumerate(bare):
            kw = {k: v for k, v in kw if k != "wgrad"}
            x, w, _, _ = call_inputs(x_shape, w_shape, "none", torch.float32, seed=650 + i)
            got = getattr(conv, name)(x, w, None, None, **kw)
            want = getattr(conv, f"{name}_plain")(x, w, None, None, **kw)
            torch.cuda.synchronize()
            err, ok = within(got, want, 1e-3, 1e-3)
            say(f"bare conv f32 {name:24s} x{x_shape} w{w_shape} max|d|={err:.3e}")
            check(ok, f"{name} bare at x{x_shape}: float32 kernel vs plain beyond 1e-3 ({err})")


def phase_bn_microbatch_bits():
    """config1 with batch norm at full width (B=128, bf16): a step with
    disc_microbatch=64 is bit-identical to one without (batch norm keeps D
    in one chunk), cuDNN in its deterministic algorithms."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    cfg = phase18_config("config1 bn step")
    state0 = init_state(cfg, torch.Generator().manual_seed(25), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(25)
    batch = dict(frames=torch.tanh(torch.randn((128, 2, 64, 64, 3), generator=gen, device="cuda")),
                 actions=torch.randn((128, 1, 4), generator=gen, device="cuda"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [make_train_step(apply_overrides(cfg, [f"train.disc_microbatch={mb}"]), "cuda")(
            fresh_copy(state0, "cuda"), batch) for mb in (0, 64)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (a, ma), (b, mb) = runs
    same = all(torch.equal(getattr(a, n)[k], getattr(b, n)[k])
               for n in ("g_params", "d_params") for k in getattr(a, n))
    same = same and all(float(ma[k]) == float(mb[k]) for k in ma)
    say(f"config1 bn B=128 bf16: disc_microbatch=64 vs 0 bit-identical {same}")
    check(same, "batch norm: disc_microbatch changed the step")


def phase_engines_reduced():
    """config5 widths, B=2, T=4, float32, TF32 off, cuDNN off (PyTorch's own
    convolutions, as phase 14's microbatch comparison; in float32 every layer
    is split, so each rewrite runs at each of its layers), D's learning rate
    0 (so that G's gradient is taken against the same D: Adam's first step
    moves an entry of D whose gradient sits at float32's rounding floor by up
    to +-lr, ROADMAP Facts). The engines' step against the default step from
    one state, for deconv=subpixel + conv0=s2d and for wgrad=patches: losses
    within 1e-4 relative (tests/test_deconv.py's train-step bar). First
    moments: wgrad=patches computes the same convolutions, and its moments
    hold 1e-4 abs + 1e-3 rel everywhere. The rewrites change the forward's
    rounding, which flips the sign of pre-activations near 0 and so moves
    single gradient entries by more than that bar; the default engine
    itself misses it when only cuDNN's algorithms change. So their moments
    are held to that: at most as many entries beyond the bar, and no larger
    a |d|, as the default step with cuDNN on against the same step off."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    base = apply_overrides(phase18_config("config5 engines step"), [
        "model.deconv=xla", "model.conv0=xla", "model.compute_dtype=float32",
        "train.batch_size=2", "train.rollout_length=4", "train.d_lr=0"])
    state0 = init_state(base, torch.Generator().manual_seed(26), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(26)
    batch = dict(frames=torch.tanh(torch.randn((2, 5, 256, 256, 3), generator=gen, device="cuda")),
                 actions=torch.randn((2, 4, 4), generator=gen, device="cuda"))

    def run(knobs, cudnn):
        enabled, deterministic = torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = cudnn, True
        try:
            api.reset_routes()
            state, m = make_train_step(apply_overrides(base, knobs), "cuda")(
                fresh_copy(state0, "cuda"), batch)
            return state, m, dict(api.ROUTES)
        finally:
            torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = enabled, deterministic

    def beyond(st, ref):
        """(entries of both first moments beyond 1e-4 abs + 1e-3 rel, max |d|)."""
        n, worst = 0, 0.0
        for opt in ("g_opt", "d_opt"):
            for k, v in getattr(ref, opt).mu.items():
                d = (getattr(st, opt).mu[k] - v).abs()
                n += int((d > 1e-4 + 1e-3 * v.abs()).sum())
                worst = max(worst, float(d.max()))
        return n, worst

    ref, m_ref, _ = run([], False)
    floor = beyond(run([], True)[0], ref)
    say(f"config5 widths f32 B=2 T=4, d_lr 0: the default step with cuDNN on vs off: first-moment "
        f"entries beyond 1e-4 + 1e-3 rel {floor[0]}, max|d| {floor[1]:.3e}")
    for name, knobs in (("subpixel+s2d", PHASE18_OVERRIDES["config5 engines step"]),
                        ("patches", PHASE18_OVERRIDES["config5 patches step"])):
        st, m, routes = run(knobs, False)
        rel = max(abs(float(m[k]) - float(m_ref[k])) / max(abs(float(m_ref[k])), 1e-30)
                  for k in ("d_loss", "g_loss", "g_adv", "g_recon"))
        check(rel <= 1e-4, f"config5 widths f32 {name}: losses {rel:.3e} relative from the default")
        n, worst = beyond(st, ref)
        if name == "patches":
            check(n == 0, f"{name}: {n} first-moment entries beyond 1e-4 + 1e-3 rel ({worst:.3e})")
        else:
            check(n <= floor[0] and worst <= floor[1],
                  f"{name}: first moments ({n} beyond the bar, max|d| {worst:.3e}) farther from "
                  f"the default than cuDNN's algorithms move it ({floor[0]}, {floor[1]:.3e})")
        ran = {k: v for k, v in routes.items() if k in ("s2d", "subpixel", "patches") and v}
        check(len(ran) == (2 if "+" in name else 1), f"{name}: the engines did not run: {routes}")
        say(f"config5 widths f32 B=2 T=4, {name} vs the default engines (cuDNN off): losses max "
            f"rel |d| {rel:.3e} (bar 1e-4); first moments: {n} entries beyond 1e-4 + 1e-3 rel, "
            f"max|d| {worst:.3e}; engine routes {ran}")


def phase_rewrites_alone():
    """Each rewrite alone at config5's split shapes (B=2) against the
    default plain op on the same inputs, forward and the gradients of
    sum(sin(y)), cuDNN off: float64 within the float32 bars of
    tests/test_deconv.py, test_conv0.py and test_wgrad.py (2e-5; dw's atol
    scaled by its largest magnitude), bfloat16 within 2% of each quantity's
    largest magnitude; float32 printed as max|d| over the largest magnitude
    (at 512-channel contractions its rounding floor lies above an absolute
    2e-5: dec_4's dx differed by 7.7e-5). Subpixel at G dec_4..0, s2d at G
    enc_0 and D conv_0, patches at G enc_1, D conv_0_extra_0 and G dec_1."""
    from action_conditioned_gans_tpu_torch.ops import reference, wgrad

    # (label, x shape, w shape, stride, the rewrite, the default op)
    sub = lambda x, w: reference.conv2d_transpose_subpixel(x, w)  # noqa: E731
    dct = lambda x, w: reference.conv2d_transpose(x, w)  # noqa: E731
    s2d = lambda x, w: reference.conv2d_s2d(x, w, stride=2)  # noqa: E731
    c2 = lambda x, w: reference.conv2d(x, w, stride=2)  # noqa: E731
    c1 = lambda x, w: reference.conv2d(x, w, stride=1)  # noqa: E731
    cases = [(f"G dec_{i} subpixel", (2, 256 >> (i + 1), 256 >> (i + 1), cin), (4, 4, cin, cout), sub, dct)
             for i, (cin, cout) in zip(range(4, -1, -1), ((512, 512), (512, 256), (256, 128),
                                                           (128, 64), (64, 3)))]
    cases += [("G enc_0 s2d", (2, 256, 256, 3), (4, 4, 3, 64), s2d, c2),
              ("D conv_0 s2d", (2, 256, 256, 10), (4, 4, 10, 64), s2d, c2),
              ("G enc_1 patches", (2, 128, 128, 64), (4, 4, 64, 128),
               lambda x, w: wgrad.conv2d_patches_wgrad(x, w, 2), c2),
              ("D conv_0_extra_0 patches", (2, 128, 128, 64), (3, 3, 64, 64),
               lambda x, w: wgrad.conv2d_patches_wgrad(x, w, 1), c1),
              ("G dec_1 patches", (2, 64, 64, 128), (4, 4, 128, 64),
               lambda x, w: wgrad.conv2d_transpose_patches_wgrad(x, w), dct)]
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        for i, (label, x_shape, w_shape, fn, plain) in enumerate(cases):
            g = torch.Generator(device="cuda").manual_seed(700 + i)
            x0 = torch.randn(x_shape, generator=g, device="cuda")
            w0 = torch.randn(w_shape, generator=g, device="cuda") * 0.1
            errs = []
            for dtype in (torch.float64, torch.bfloat16, torch.float32):
                res = []
                for f in (fn, plain):
                    wd = torch.float64 if dtype == torch.float64 else torch.float32
                    x, w = x0.to(dtype).requires_grad_(), w0.to(wd).requires_grad_()
                    y = f(x, w)
                    dx, dw = torch.autograd.grad(torch.sin(y.to(wd)).sum(), (x, w))
                    res.append([t.to(wd) for t in (y.detach(), dx, dw)])
                for name, a, b in zip(("y", "dx", "dw"), *res):
                    scale = float(b.abs().max())
                    d = float((a - b).abs().max())
                    if dtype == torch.float32:
                        errs.append(f"f32 {name} {d / scale:.1e} rel")
                        continue
                    if dtype == torch.float64:
                        atol = 2e-5 * max(scale, 1.0) if name == "dw" else 2e-5
                        ok = bool(((a - b).abs() <= atol + 2e-5 * b.abs()).all())
                    else:
                        ok = bool(((a - b).abs() <= 0.02 * scale + 0.02 * b.abs()).all())
                    check(ok, f"{label} {str(dtype)[6:]} {name}: {d:.3e} from the default op")
                    errs.append(f"{str(dtype)[6:]} {name} {d:.2e}")
            say(f"rewrite parity {label:26s} x{x_shape} w{w_shape}: " + " ".join(errs))
    finally:
        torch.backends.cudnn.enabled = enabled


def phase18(smi, totals, tmp):
    """Phase 18: R1, batch norm and the engine knobs on the card; returns
    the launches of its counted runs by path."""
    from action_conditioned_gans_tpu_torch.infer import Predictor

    t_phase = time.perf_counter()
    say(f"phase 18: R1, batch norm and the engine knobs ({smi})")
    launches = {}
    # The JAX package's tiny R1 and batch-norm runs, replayed in float32.
    with np.load(R1_BN_FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    for name, keys in (("r1", TRAJECTORY + ("d_r1",)), ("bn", TRAJECTORY)):
        run = {k[len(name) + 1:]: v for k, v in arrays.items() if k.startswith(name + "/")}
        worst = replay_train_fixture(run, keys, f"{name} fixture")
        say(f"{name} fixture (JAX tiny 4-step run) on cuda f32: max|d| of {keys}={worst:.3e} "
            f"(bars of tests/test_golden.py)")

    # (a) config1 with R1.
    launches["config1 r1 train loop"], lines = phase18_loop("config1 r1 step", "config1 serving",
                                                           tmp)
    check(all(np.isfinite(r["d_r1"]) and r["d_r1"] > 0 for r in lines),
          f"d_r1 not finite and positive on every metric line: {lines}")
    launches["config1 r1 step"], _, _, _ = phase_training(phase18_config("config1 r1 step"),
                                                          "config1 r1 step")
    phase_r1_f32()

    # (b) config1 with batch norm.
    launches["config1 bn train loop"], _ = phase18_loop("config1 bn step", "config1 bn serving",
                                                        tmp)
    cfg = phase18_config("config1 bn step")
    launches["config1 bn step"], _, conv_calls, _ = phase_training(cfg, "config1 bn step")
    phase_train_conv_parity(conv_calls, totals)
    phase_bare_conv_f32(conv_calls)
    phase_bn_microbatch_bits()
    predictor = Predictor(cfg, seeded_params(cfg, seed=0), device="cuda")
    launches["config1 bn serving"] = phase_serving(predictor, "config1 bn serving", 128, 10, 16,
                                                   timed=8)
    del predictor

    # (c) config5 with the engine knobs.
    for path in ("config5 engines step", "config5 patches step"):
        cfg = phase18_config(path)
        say(f"{path}: config5 with {' '.join(CONFIG5_OVERRIDES + PHASE18_OVERRIDES[path])}")
        launches[path], _, _, _ = phase_training(cfg, path, steps=3, warmup=2, n_batches=2)
    phase_engines_reduced()
    phase_rewrites_alone()
    say(f"phase 18 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phase 19: data parallelism ------------------------------------------------------


# Phase 19 (b, c): what each of two gloo ranks sharing cuda:0 trains: (preset, overrides)
# at the global batch, of which each rank takes half (parallel.mesh.batch_slice). The
# float32 paths keep float32 Adam moments, TF32 and cuDNN off (phase19_gloo_steps), and
# D's learning rate 0 (as phase 18 holds the engines): G's gradient then meets one D on
# both sides, and the averaged gradients are compared as they are, not through an Adam
# step of D that amplifies their rounding (ROADMAP Facts).
PHASE19_WORLD = 2
PHASE19_STEPS = 3
PHASE19_F32 = ["model.compute_dtype=float32", "train.adam_moment_dtype=float32",
               "train.d_lr=0.0"]
PHASE19_PATHS = {
    "config1 step": ("config1", []),
    "config3 step": ("config3", []),
    "config1 f32 step": ("config1", PHASE19_F32),
    "config3 f32 step": ("config3", PHASE19_F32),
    "config1 bn f32 step": ("config1", ["model.norm=batch", *PHASE19_F32]),
}
# Phase 19 (d): clip files per rank file (two files, one a rank) for `train` on two ranks.
PHASE19_FILE_CLIPS = 128


def phase19_config(path, world=1):
    """Phase 19's config of ``path``: config1 as phase 10 trains it (B=128,
    bfloat16 moments) or the config3 preset (B=32), with the path's
    overrides, one step a call; the batch is each of ``world`` ranks'
    share."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset

    preset, overrides = PHASE19_PATHS[path]
    cfg = config1_train_config() if preset == "config1" else get_preset(preset)
    cfg = apply_overrides(cfg, overrides)
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=cfg.train.batch_size // world, steps_per_call=1))


def phase19_batches(cfg, n, seed=19):
    """``n`` global batches of ``cfg``'s shapes, drawn on the host from a seed
    (every rank and the one-rank reference draw the same ones)."""
    m, b, horizon = cfg.model, cfg.train.batch_size, max(cfg.train.rollout_length, 1)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {"frames": torch.tanh(torch.randn((b, horizon + 1, m.image_size, m.image_size, 3),
                                                  generator=gen)),
                 "actions": torch.randn((b, horizon, m.action_dim), generator=gen)}
        if m.state_dim:
            batch["states"] = torch.randn((b, horizon, m.state_dim), generator=gen)
        out.append(batch)
    return out


def first_moments(state):
    """Adam's first moments of G and D on the host, float32: after the first
    step, (1 - b1) times the step's gradients."""
    return {f"{t}/{k}": v.float().cpu() for t in ("g_opt", "d_opt")
            for k, v in getattr(state, t).mu.items()}


def losses_of(metrics):
    return {k: float(metrics[k]) for k in ("d_loss", "g_loss", "g_adv", "g_recon")}


def dp_rank_steps(job, rank):
    """A rank's share of phase 19 (b, c): each path's DP step on this rank's
    rows of the global batches, the first step counted, the others timed;
    writes the metrics, launches, routes and times as JSON and the final
    parameters with torch.save."""
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import batch_slice, make_mesh
    from action_conditioned_gans_tpu_torch.train import init_state

    results = {}
    for path in job["paths"]:
        cfg = phase19_config(path)
        # The float32 paths without cuDNN, as their one-rank reference runs.
        torch.backends.cudnn.enabled = "f32" not in path
        mesh = make_mesh(cfg.mesh, device="cuda")
        step = make_dp_train_step(cfg, mesh)
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
        out = dict(metrics=[], step_ms=[])
        for i, batch in enumerate(phase19_batches(cfg, PHASE19_STEPS)):
            local = batch_slice({k: v.cuda() for k, v in batch.items()}, mesh)
            torch.cuda.synchronize()
            if i == 0:
                reset_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, local)
            end.record()
            torch.cuda.synchronize()
            if i == 0:
                out["launches"], out["routes"] = read_launches(), dict(api.ROUTES)
                first_mu = first_moments(state)
            else:
                out["step_ms"].append(start.elapsed_time(end))
            out["metrics"].append({k: float(v) for k, v in m.items()})
        torch.save({"g_params": {k: v.cpu() for k, v in state.g_params.items()},
                    "d_params": {k: v.cpu() for k, v in state.d_params.items()},
                    "first_mu": first_mu},
                   os.path.join(job["dir"], f"{path.replace(' ', '_')}.rank{rank}.pt"))
        results[path] = out
        del state, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    return results


def dp_rank_train(job, rank):
    """A rank's share of phase 19 (d): ``train`` runs on clip files in turn
    (cudnn.deterministic), each with the counts set to 0 just before it and
    read just after, its standard output kept."""
    from action_conditioned_gans_tpu_torch.ops import api

    torch.backends.cudnn.deterministic = True
    results = []
    for argv in job["runs"]:
        reset_launches()
        out = run_cli(["train", *argv, "--device", "cuda:0"])
        torch.cuda.synchronize()
        results.append(dict(launches=read_launches(), routes=dict(api.ROUTES), stdout=out))
    return results


def dp_rank_main(argv):
    """``chip_smoke.py --dp-rank RANK WORLD INIT_FILE JOB.json`` (phase 19's
    ranks; ``--tp-rank``, phase 20's): one rank of a gloo group on cuda:0;
    writes
    ``JOB.json.rank<RANK>.json``."""
    import datetime

    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: a --dp-rank process needs a GPU", file=sys.stderr)
        return 1
    rank, world, init, path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        t0 = time.perf_counter()
        modes = {"steps": dp_rank_steps, "train": dp_rank_train, "tp_steps": tp_rank_steps,
                 "tp_train": tp_rank_train}
        # A list of jobs runs in turn, in one process: a list of results.
        results = ([modes[j["mode"]](j, rank) for j in job["jobs"]] if "jobs" in job
                   else modes[job["mode"]](job, rank))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{path}.rank{rank}.json", "w") as f:
        json.dump({"results": results, "seconds": time.perf_counter() - t0}, f)
    return 0


def run_dp_ranks(job, tmp, label, world=PHASE19_WORLD, timeout=900, flag="--dp-rank"):
    """``job`` on ``world`` rank processes of this script on cuda:0 (a gloo
    group, ``file://`` init under ``tmp``; ``flag`` names the phase's rank
    mode), joined by the deadline and killed after it; returns each rank's
    results and seconds."""
    path = os.path.join(tmp, f"{label}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    init = os.path.join(tmp, f"{label}.init")
    logs = [open(f"{path}.rank{r}.log", "w+") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(world), init, path], cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=max(t0 + timeout - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{label}: rank {r} exited {p.returncode}:\n{texts[r][-5000:]}")
    out = []
    for r in range(world):
        with open(f"{path}.rank{r}.json") as f:
            out.append(json.load(f))
    say(f"{label}: {world} gloo ranks on cuda:0 took {time.perf_counter() - t0:.1f} s "
        f"(in the ranks {[round(o['seconds'], 1) for o in out]} s)")
    return out


def phase19_nccl(smi, tmp):
    """Phase 19 (a): an NCCL group of one rank in this process. config1's
    step (B=128, bfloat16 moments) through the DP path against the step
    without a group: 3 steps from one state, bit for bit under
    cudnn.deterministic (config1 draws nothing); then both timed in turns
    (no group, DP, DP, no group, five times; 20 steps a window, CUDA
    events), and ``comm.mean_reduce_`` alone on D's and G's gradient sets
    (the step's two parameter-size all-reduces). Then
    `train` over the group (phase 12's arguments, 32 steps, counts set to 0
    just before, read just after) against `train` without one: the
    step-32 checkpoints bit for bit. Returns the counted run's launches."""
    import datetime

    import torch.distributed as dist

    from action_conditioned_gans_tpu_torch.parallel import comm
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
    from action_conditioned_gans_tpu_torch.train.state import state_to_host

    cfg = phase19_config("config1 step")
    batches = [{k: v.cuda() for k, v in b.items()} for b in phase19_batches(cfg, 4)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    plain_dir, group_dir = os.path.join(tmp, "nccl-none"), os.path.join(tmp, "nccl-group")
    try:
        loop = ["train", *LOOP_ARGS, "--steps", "32", "--device", "cuda:0"]
        run_cli([*loop, "--workdir", plain_dir])
        states, steps = {}, {"none": make_train_step(cfg, device="cuda")}
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl.init')}",
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh(cfg.mesh, device="cuda")
            check((mesh.world, mesh.data, dist.get_backend(mesh.group)) == (1, 1, "nccl"),
                  f"the NCCL mesh is {mesh}")
            steps["dp"] = make_dp_train_step(cfg, mesh)
            for name, step in steps.items():
                state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
                for i in range(3):
                    state, m = step(state, batches[i])
                states[name] = (state_to_host(state, cfg), losses_of(m))
            times = {"none": [], "dp": []}
            state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
            for name in ("none", "dp", "dp", "none") * 5:
                for i in range(3):
                    state, _ = steps[name](state, batches[i % 4])
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                torch.cuda.synchronize()
                start.record()
                for i in range(20):
                    state, m = steps[name](state, batches[i % 4])
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
            # The reduction alone: D's and G's gradient sets (the step's two
            # all-reduces of parameter size), 50 calls each.
            reduce_ms = {}
            for tree in ("d_params", "g_params"):
                grads = [v.clone() for v in getattr(state, tree).values()]
                reduce_ms[tree] = cuda_time_ms(lambda: comm.mean_reduce_(grads, mesh.group), 50)
            reset_launches()
            out = run_cli([*loop, "--workdir", group_dir])
            launches = read_launches()
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a, b) for tree in ("g_params", "d_params", "g_opt", "d_opt")
               for a, b in zip(_leaves(states["none"][0][tree]), _leaves(states["dp"][0][tree])))
    say(f"nccl world 1: 3 config1 steps (B=128) through the DP path against the step without a "
        f"group, cudnn.deterministic: bit-identical {same}; losses {states['dp'][1]} / "
        f"{states['none'][1]}")
    check(same, "the world-1 NCCL DP step differs from the step without a group")
    evals = [r for r in metric_lines(out) if "eval_l2" in r]
    check_runs("config1 nccl train loop", launches,
               {"config1 step": 32, "config1 serving": len(evals)})
    same, max_diff, where = compare_states(final_params(group_dir, 32),
                                           final_params(plain_dir, 32))
    say(f"nccl world 1: `train` 32 steps over the group against `train` without one, "
        f"cudnn.deterministic: bit-identical {same}, max |d| {max_diff:.3e} at {where}")
    check(same, f"`train` over a world-1 NCCL group differs: {max_diff:.3e} at {where}")
    line = dict(path="config1 step", batch=128, steps_a_window=20,
                step_ms_no_group=times["none"], step_ms_nccl_world1=times["dp"],
                median_ms_no_group=float(np.median(times["none"])),
                median_ms_nccl_world1=float(np.median(times["dp"])),
                all_reduce_ms_d_grads=reduce_ms["d_params"],
                all_reduce_ms_g_grads=reduce_ms["g_params"], card=smi)
    say("dp nccl " + json.dumps(line))
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def one_rank_steps(cfg, cudnn=True, order=None):
    """``cfg``'s step without a group on the whole of phase 19's batches:
    (the losses of each step, the first moments after the first step, the
    final state); ``cudnn=False`` runs the convolutions without cuDNN;
    ``order`` takes each batch's clips in that order (the same function,
    its sums in another order)."""
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    torch.backends.cudnn.enabled = cudnn
    try:
        step = make_train_step(cfg, device="cuda")
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
        losses = []
        for i, batch in enumerate(phase19_batches(cfg, PHASE19_STEPS)):
            state, m = step(state, {k: (v if order is None else v[order]).cuda()
                                    for k, v in batch.items()})
            losses.append(losses_of(m))
            if i == 0:
                mu = first_moments(state)
    finally:
        torch.backends.cudnn.enabled = True
    return losses, mu, state


def normwise(a, b):
    """{tensor: |a - b| / |b|, over the tensor} of two dicts of tensors."""
    return {k: float((a[k] - v).norm() / v.norm().clamp_min(1e-30)) for k, v in b.items()}


def phase19_gloo_steps(smi, tmp):
    """Phase 19 (b, c): two gloo ranks on cuda:0, each PHASE19_PATHS path
    for PHASE19_STEPS steps on its half of the batch, against the one-rank
    step on the whole batch in this process. Both ranks end with one state,
    bit for bit, and launch what EXPECTED[path] says a step launches.
    bfloat16: every loss within 3e-2 relative. float32, with cuDNN off on
    both sides (its default float32 algorithms are not deterministic:
    config3's one-rank step differs from itself, run to run, by up to 3e-3
    normwise in D's gradients with cuDNN on, and by nothing with it off;
    PERF.md §6): the averaged gradients (Adam's first moments after the
    first step) within 1e-4 of their norm, G's and D's each, and every loss
    within 2e-4 relative (tests/test_parallel.py's bar), or within twice the
    one-rank step's own spread where that is larger: the one-rank step on
    the batch's clips reordered (reversed, halves swapped, shuffled), the
    same function summed in other orders. The parameter entries more than
    5e-5 from the one-rank step's are counted and printed, not held (Adam
    moves an entry whose gradient sits at float32's rounding floor by up to
    its learning rate on a summation-order difference: ROADMAP Facts).
    Returns the ranks' counted launches by path."""
    ranks = run_dp_ranks({"mode": "steps", "dir": tmp, "paths": list(PHASE19_PATHS)}, tmp,
                         "dp-steps")
    launches = {}
    for path in PHASE19_PATHS:
        cfg, f32 = phase19_config(path), "f32" in path
        want, want_mu, state = one_rank_steps(cfg, cudnn=not f32)
        name = path.replace(" ", "_")
        saved = [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"), weights_only=True)
                 for r in range(PHASE19_WORLD)]
        one_state = all(torch.equal(saved[0][t][k], saved[1][t][k])
                        for t in ("g_params", "d_params") for k in saved[0][t])
        check(one_state, f"{path}: the two ranks hold different parameters")
        for r, o in enumerate(ranks):
            res = o["results"][path]
            check_runs(f"{path} rank {r} of {PHASE19_WORLD}", res["launches"], {path: 1},
                       routes=res["routes"])
            launches[f"{path} rank {r}"] = res["launches"]
        diffs = [(saved[0][t][k] - getattr(state, t)[k].cpu()).abs()
                 for t in ("g_params", "d_params") for k in saved[0][t]]
        got = ranks[0]["results"][path]["metrics"]
        loss_rel = max(abs(got[i][k] - w[k]) / abs(w[k]) for i, w in enumerate(want) for k in w)
        mine = normwise(saved[0]["first_mu"], want_mu)
        worst = max(mine, key=mine.get)
        # G's and D's gradients each as one vector: a tensor the loss does not
        # depend on (a normalised layer's scale ahead of another batch norm)
        # has a gradient of rounding noise alone, whose relative error means
        # nothing.
        def joined(moments, net):
            return {net: torch.cat([moments[k].reshape(-1) for k in sorted(want_mu)
                                    if k.startswith(net)])}

        nets = {net: normwise(joined(saved[0]["first_mu"], net), joined(want_mu, net))[net]
                for net in ("g_opt", "d_opt")}
        if f32:
            # The one-rank step's own spread: its clips reversed, their halves
            # swapped, and shuffled.
            b = cfg.train.batch_size
            spread, loss_spread = {"g_opt": 0.0, "d_opt": 0.0}, 0.0
            for order in (torch.arange(b - 1, -1, -1), torch.arange(b).roll(b // 2),
                          torch.randperm(b, generator=torch.Generator().manual_seed(19))):
                r_losses, r_mu, _ = one_rank_steps(cfg, cudnn=False, order=order)
                for net in spread:
                    spread[net] = max(spread[net], normwise(joined(r_mu, net),
                                                            joined(want_mu, net))[net])
                loss_spread = max([loss_spread] + [abs(rl[k] - w[k]) / abs(w[k])
                                                   for rl, w in zip(r_losses, want) for k in w])
        line = dict(path=path, world=PHASE19_WORLD, global_batch=cfg.train.batch_size,
                    steps=PHASE19_STEPS, cudnn=not f32, ranks_bit_identical=one_state,
                    max_rel_loss_diff_vs_one_rank=loss_rel,
                    normwise_first_moment_diff=nets,
                    **(dict(reordered_clips_normwise=spread, reordered_clips_loss_rel=loss_spread)
                       if f32 else {}),
                    max_normwise_first_moment_diff_of_a_tensor=[worst, mine[worst]],
                    max_abs_param_diff_vs_one_rank=max(float(d.max()) for d in diffs),
                    param_entries_beyond_5e_5=sum(int((d > 5e-5).sum()) for d in diffs),
                    param_entries=sum(d.numel() for d in diffs),
                    rank_step_ms=[o["results"][path]["step_ms"] for o in ranks],
                    note="a correctness run: two processes share one card", card=smi)
        say("dp gloo " + json.dumps(line))
        del state
        torch.cuda.empty_cache()
        if f32:
            for net, d in nets.items():
                check(d <= max(1e-4, 2 * spread[net]), f"{path}: {net} first moments {d:.3e} "
                      f"(normwise) from the one-rank step's; its own spread {spread[net]:.3e}")
            check(loss_rel <= max(2e-4, 2 * loss_spread), f"{path}: losses {loss_rel:.3e} from "
                  f"the one-rank step's; its own spread {loss_spread:.3e}")
        else:
            check(loss_rel <= 3e-2, f"{path}: losses {loss_rel:.3e} from the one-rank step's")
    return launches


def phase19_gloo_files(smi, tmp):
    """Phase 19 (d): `train` on two gloo ranks over clip files (two files,
    one a rank; config1 at phase 12's arguments, 64 clips a rank a step,
    cudnn.deterministic): 32 steps uninterrupted, and 16 steps resumed to
    32. Rank 0 alone prints and writes; each rank launches EXPECTED's
    kernels per step (rank 0 also the held-out rollout's); the resumed
    step-32 checkpoint equals the uninterrupted one bit for bit. Returns the
    counted launches by run and rank."""
    from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt

    nt.load_library()  # built once here, before the ranks load it
    data_dir = os.path.join(tmp, "data")
    for i in range(PHASE19_WORLD):
        run_cli(["make-data", "--preset", "config1", "--num-clips", str(PHASE19_FILE_CLIPS),
                 "--set", f"train.seed={i}", "--workdir", tmp, "--device", "cuda",
                 "--out", os.path.join(data_dir, f"clips{i}.tfrecord")])
    args = file_loop_args(data_dir, data_dir, "train.checkpoint_every=16")
    whole, resumed = os.path.join(tmp, "files-whole"), os.path.join(tmp, "files-resumed")
    runs = [[*args, "--workdir", whole, "--steps", "32"],
            [*args, "--workdir", resumed, "--steps", "16"],
            [*args, "--workdir", resumed, "--steps", "32"]]
    ranks = run_dp_ranks({"mode": "train", "runs": runs}, tmp, "dp-files")
    launches = {}
    for i, steps in enumerate((32, 16, 16)):
        lead = ranks[0]["results"][i]["stdout"]
        lines = metric_lines(lead)
        evals = sum("eval_l2" in r for r in lines)
        for r, o in enumerate(ranks):
            res = o["results"][i]
            runs_of = {"config1 step": steps, **({"config1 serving": evals} if r == 0 else {})}
            check_runs(f"config1 dp file loop run {i} rank {r}", res["launches"], runs_of,
                       routes=res["routes"])
            launches[f"config1 dp file loop run {i} rank {r}"] = res["launches"]
            if r:
                check("[acgan]" not in res["stdout"] and not metric_lines(res["stdout"]),
                      f"rank {r} printed: {res['stdout'][-1000:]}")
        check(lines and all(np.isfinite(v) for row in lines for v in row.values()),
              f"run {i}: rank 0's metric lines {lines}")
    check("resumed from checkpoint at step 16" in ranks[0]["results"][2]["stdout"],
          "the third run did not resume")
    same, max_diff, where = compare_states(final_params(resumed, 32), final_params(whole, 32))
    say(f"dp file resume on 2 gloo ranks: 16 + 16 steps against 32 uninterrupted, "
        f"cudnn.deterministic: bit-identical {same}, max |d| {max_diff:.3e} at {where}; "
        f"checkpoints {checkpoint_steps(whole)} / {checkpoint_steps(resumed)}")
    check(same, f"the resumed two-rank file run differs: {max_diff:.3e} at {where}")
    check(checkpoint_steps(whole) == [16, 32], f"checkpoints {checkpoint_steps(whole)}")
    return launches


def phase19_serving(smi, tmp):
    """Phase 19 (e): ``Predictor`` and ``AotPredictor`` over the mesh
    [cuda:0, cuda:0] (the batch in halves, one replica a device): config1
    (bfloat16, every layer fused) bit for bit against the one-device
    predictors, predict B=128 and rollout T=10 B=16, the launches counted;
    config5 in float32 (split layers on cuDNN) within 1e-3."""
    from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    mesh = ["cuda:0"] * PHASE19_WORLD
    cfg = get_preset("config1")
    params = seeded_params(cfg, seed=0)
    one = Predictor(cfg, params, device="cuda")
    sharded = one.with_mesh(mesh)
    predict_args = serving_inputs(cfg, 128, 10, 16, seed=19)
    p_args, r_args = predict_args
    launches = {}
    reset_launches()
    got_p, got_r = sharded.predict(*p_args), sharded.rollout(*r_args)
    torch.cuda.synchronize()
    launches["config1 dp serving"] = read_launches()
    check_runs("config1 dp serving", launches["config1 dp serving"],
               {"config1 serving": PHASE19_WORLD * (1 + 10)})
    same = torch.equal(got_p, one.predict(*p_args)) and torch.equal(got_r, one.rollout(*r_args))
    path = os.path.join(tmp, "config1.aot")
    export_aot(cfg, flax_to_state_dict(params), path, rollout_length=10, device="cuda")
    aot_one, aot_mesh = AotPredictor(path, device="cuda"), AotPredictor(path, mesh=mesh)
    reset_launches()
    aot_p, aot_r = aot_mesh.predict(*p_args), aot_mesh.rollout(*r_args)
    torch.cuda.synchronize()
    launches["config1 dp AOT program"] = read_launches()
    check_program_runs("config1 dp AOT program", launches["config1 dp AOT program"],
                       {"config1 serving": PHASE19_WORLD * (1 + 10)})
    same_aot = (torch.equal(aot_p, aot_one.predict(*p_args))
                and torch.equal(aot_r, aot_one.rollout(*r_args)))
    c5 = get_preset("config5")
    c5 = c5.replace(model=dataclasses.replace(c5.model, compute_dtype="float32"))
    p5 = Predictor(c5, seeded_params(c5, seed=5), device="cuda")
    args5, _ = serving_inputs(c5, 4, 1, 2, seed=20)
    e5 = float((p5.with_mesh(mesh).predict(*args5) - p5.predict(*args5)).abs().max())
    say(f"dp serving over {mesh}: config1 bf16 predict B=128 + rollout T=10 B=16 bit-identical "
        f"to one device: live {same}, AOT {same_aot}; config5 f32 predict B=4 max|d| {e5:.3e} "
        f"(bar 1e-3) ({smi})")
    check(same and same_aot, "DP serving differs from one device where every layer is fused")
    check(e5 <= 1e-3, f"config5 f32 DP predict differs by {e5:.3e}")
    return launches


def phase19(smi):
    """Phase 19: data parallelism. Returns the launches of its counted runs."""
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    say(f"phase 19: data parallelism ({smi})")
    launches = {}
    scratch = os.path.dirname(build.BUILD_DIR)
    with tempfile.TemporaryDirectory(prefix="phase19-", dir=scratch) as tmp:
        launches["config1 nccl train loop"] = phase19_nccl(smi, tmp)
        launches.update(phase19_gloo_steps(smi, tmp))
        launches.update(phase19_gloo_files(smi, tmp))
        launches.update(phase19_serving(smi, tmp))
    say(f"phase 19 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phase 20: channel tensor parallelism ----------------------------------------------


# Phase 20 (a-c): what each gloo rank of a (data, model) mesh sharing cuda:0 trains:
# (preset, overrides, (data, model)) at the global batch, one step a call. Each rank
# holds its channel shard of the state (parallel/tp.py) and its data index's rows of
# the batch. The float32 path is phase 19's (float32 moments, TF32 and cuDNN off, D's
# learning rate 0).
PHASE20_STEPS = 3
PHASE20_PATHS = {
    "config1 step tp2": ("config1", [], (1, 2)),
    "config1 f32 step tp2": ("config1", PHASE19_F32, (1, 2)),
    "config3 step tp2": ("config3", [], (1, 2)),
    "config1 step dp2tp2": ("config1", [], (2, 2)),
}
# Phase 20 (d): `train` as phase 12 drives it, on the 1x2 mesh, a checkpoint every 16 steps.
PHASE20_LOOP_ARGS = [*LOOP_ARGS, "--set", "mesh.model=2", "--set", "train.checkpoint_every=16"]


def phase20_config(path):
    """Phase 20's config of ``path`` at the global batch, with its mesh."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset

    preset, overrides, (data, model) = PHASE20_PATHS[path]
    cfg = config1_train_config() if preset == "config1" else get_preset(preset)
    cfg = apply_overrides(cfg, overrides)
    return cfg.replace(train=dataclasses.replace(cfg.train, steps_per_call=1),
                       mesh=dataclasses.replace(cfg.mesh, data=data, model=model))


def host_tree(params):
    return {k: v.detach().cpu() for k, v in params.items()}


def tp_rank_steps(job, rank):
    """A rank's share of phase 20 (a-c): each path's step on this rank's
    shard and rows of the global batches, the first step counted (every
    kernel call recorded), the others timed; writes the metrics, launches,
    routes and times as JSON, and the gathered state's parameters and first
    moments after the first step, this rank's shards and the recorded calls
    with torch.save."""
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import batch_slice, make_mesh
    from action_conditioned_gans_tpu_torch.parallel.tp import place_state, whole_state
    from action_conditioned_gans_tpu_torch.train import init_state

    results = {}
    for path in job["paths"]:
        cfg = phase20_config(path)
        torch.backends.cudnn.enabled = "f32" not in path
        mesh = make_mesh(cfg.mesh, device="cuda")
        step = make_dp_train_step(cfg, mesh)
        state = place_state(init_state(cfg, torch.Generator().manual_seed(0), device="cuda"), mesh)
        out = dict(metrics=[], step_ms=[])
        for i, batch in enumerate(phase19_batches(cfg, PHASE20_STEPS)):
            local = batch_slice({k: v.cuda() for k, v in batch.items()}, mesh)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if i == 0:
                reset_launches()
                with recorded_calls() as rec:
                    state, m = step(state, local)
                    torch.cuda.synchronize()
                out["launches"], out["routes"] = read_launches(), dict(api.ROUTES)
                first_mu = first_moments(whole_state(state, cfg, mesh))
            else:
                start.record()
                state, m = step(state, local)
                end.record()
                torch.cuda.synchronize()
                out["step_ms"].append(start.elapsed_time(end))
            out["metrics"].append({k: float(v) for k, v in m.items()})
        full = whole_state(state, cfg, mesh)
        torch.save({"g_params": host_tree(full.g_params), "d_params": host_tree(full.d_params),
                    "first_mu": first_mu, "calls": rec,
                    "shard": {t: host_tree(getattr(state, t)) for t in ("g_params", "d_params")}},
                   os.path.join(job["dir"], f"{path.replace(' ', '_')}.rank{rank}.pt"))
        results[path] = out
        del state, full, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    return results


def tp_rank_train(job, rank):
    """A rank's share of phase 20 (d): ``train`` runs in turn on the 1x2
    mesh (phase 12's arguments with ``mesh.model=2``, cudnn.deterministic),
    each with the counts set to 0 just before it and read just after, its
    standard output kept; after the last, rank 0 writes the state gathered
    over the model group."""
    import contextlib

    from action_conditioned_gans_tpu_torch import cli
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
    from action_conditioned_gans_tpu_torch.parallel.tp import whole_state
    from action_conditioned_gans_tpu_torch.train.loop import train

    torch.backends.cudnn.deterministic = True
    results = []
    for argv in job["runs"]:
        args = cli.build_parser().parse_args(["train", *argv])
        cfg = cli.apply_overrides(get_preset(args.preset), args.overrides)
        reset_launches()
        tee = _Tee()
        with contextlib.redirect_stdout(tee):
            state = train(cfg, max_steps=args.steps, workdir=args.workdir, device="cuda:0")
        torch.cuda.synchronize()
        results.append(dict(launches=read_launches(), routes=dict(api.ROUTES),
                            stdout="".join(tee.parts)))
    full = whole_state(state, cfg, make_mesh(cfg.mesh, device="cuda:0"))
    if rank == 0:
        torch.save({"g_params": host_tree(full.g_params), "d_params": host_tree(full.d_params)},
                   os.path.join(job["dir"], "tp-train-gathered.pt"))
    return results


def phase20_steps(smi, tmp, results):
    """Phase 20 (a-c): PHASE20_PATHS on two gloo ranks (the 1x2 mesh) and
    on four (2x2), all on cuda:0, for PHASE20_STEPS steps (``results``:
    each path's ranks' results, in rank order), against the
    one-rank step on the whole batch here: bfloat16 losses within 3e-2
    relative; float32 (cuDNN off, D's lr 0) the gathered first moments
    (the averaged gradients), G's and D's, within 1e-4 normwise and the
    losses within 2e-4 relative, or twice the one-rank step's own spread
    over reordered clips where larger (phase 19's bars). The replicated
    parameters bit-equal on every rank, a shard bit-equal on the ranks of
    its model index; each rank's first step counted against
    EXPECTED[path]. Returns the launches by path and rank, and the recorded
    kernel calls of every rank's counted step."""
    from action_conditioned_gans_tpu_torch.parallel.tp import tp_param_spec

    launches, calls = {}, {"conv": [], "norm": [], "gn_bwd": []}
    for path, out in results.items():
        cfg, f32 = phase20_config(path), "f32" in path
        world = cfg.mesh.data * cfg.mesh.model
        name = path.replace(" ", "_")
        saved = [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        same = {"replicated": True, "shard": True}
        for r in range(world):
            for tree in ("g_params", "d_params"):
                for k, v in saved[r]["shard"][tree].items():
                    kind = ("replicated" if tp_param_spec(tuple(saved[0][tree][k].shape),
                                                          cfg.mesh.model) is None else "shard")
                    peer = 0 if kind == "replicated" else r % cfg.mesh.model
                    same[kind] &= torch.equal(v, saved[peer]["shard"][tree][k])
        same_rep, same_shard = same["replicated"], same["shard"]
        check(same_rep and same_shard, f"{path}: the ranks' replicated parameters or shards differ")
        for r, res in enumerate(out):
            check_runs(f"{path} rank {r} of {world}", res["launches"], {path: 1},
                       routes=res["routes"])
            launches[f"{path} rank {r}"] = res["launches"]
            for kind in calls:
                calls[kind] += saved[r]["calls"][kind]
        want, want_mu, state = one_rank_steps(cfg, cudnn=not f32)
        got = out[0]["metrics"]
        loss_rel = max(abs(got[i][k] - w[k]) / abs(w[k]) for i, w in enumerate(want) for k in w)

        def joined(moments, net):
            return {net: torch.cat([moments[k].reshape(-1) for k in sorted(want_mu)
                                    if k.startswith(net)])}

        nets = {net: normwise(joined(saved[0]["first_mu"], net), joined(want_mu, net))[net]
                for net in ("g_opt", "d_opt")}
        diffs = [(saved[0][t][k] - getattr(state, t)[k].cpu()).abs()
                 for t in ("g_params", "d_params") for k in saved[0][t]]
        spread, loss_spread = {"g_opt": 0.0, "d_opt": 0.0}, 0.0
        reordered = f32 and (max(nets.values()) > 1e-4 or loss_rel > 2e-4)
        if reordered:
            # The one-rank step's own spread, needed only past the direct bars.
            b = cfg.train.batch_size
            for order in (torch.arange(b - 1, -1, -1), torch.arange(b).roll(b // 2),
                          torch.randperm(b, generator=torch.Generator().manual_seed(19))):
                r_losses, r_mu, _ = one_rank_steps(cfg, cudnn=False, order=order)
                for net in spread:
                    spread[net] = max(spread[net], normwise(joined(r_mu, net),
                                                            joined(want_mu, net))[net])
                loss_spread = max([loss_spread] + [abs(rl[k] - w[k]) / abs(w[k])
                                                   for rl, w in zip(r_losses, want) for k in w])
        line = dict(path=path, mesh=[cfg.mesh.data, cfg.mesh.model],
                    global_batch=cfg.train.batch_size, steps=PHASE20_STEPS, cudnn=not f32,
                    replicated_bit_identical=same_rep, shards_bit_identical=same_shard,
                    max_rel_loss_diff_vs_one_rank=loss_rel, normwise_first_moment_diff=nets,
                    **(dict(reordered_clips_normwise=spread, reordered_clips_loss_rel=loss_spread)
                       if reordered else {}),
                    max_abs_param_diff_vs_one_rank=max(float(d.max()) for d in diffs),
                    rank_step_ms=[res["step_ms"] for res in out],
                    note=f"a correctness run: {world} processes share one card, gloo moves "
                         "every gather through the host", card=smi)
        say("tp gloo " + json.dumps(line))
        del state
        torch.cuda.empty_cache()
        if f32:
            for net, d in nets.items():
                check(d <= max(1e-4, 2 * spread[net]), f"{path}: {net} first moments {d:.3e} "
                      f"(normwise) from the one-rank step's; its own spread {spread[net]:.3e}")
            check(loss_rel <= max(2e-4, 2 * loss_spread), f"{path}: losses {loss_rel:.3e} from "
                  f"the one-rank step's; its own spread {loss_spread:.3e}")
        else:
            check(loss_rel <= 3e-2, f"{path}: losses {loss_rel:.3e} from the one-rank step's")
    return launches, calls


def phase20_train_runs(tmp):
    """Phase 20 (d)'s `train` runs: 16 steps, resumed to 32; 32 uninterrupted."""
    whole, resumed = os.path.join(tmp, "tp-whole"), os.path.join(tmp, "tp-resumed")
    return [[*PHASE20_LOOP_ARGS, "--workdir", resumed, "--steps", "16"],
            [*PHASE20_LOOP_ARGS, "--workdir", resumed, "--steps", "32"],
            [*PHASE20_LOOP_ARGS, "--workdir", whole, "--steps", "32"]]


def phase20_train(smi, tmp, ranks):
    """Phase 20 (d): `train` on the 1x2 mesh (two gloo ranks on cuda:0,
    phase 12's arguments, cudnn.deterministic): 32 steps uninterrupted, and
    16 resumed to 32, bit for bit; the step-32 checkpoint equals the state
    the ranks gather, bit for bit, and is restored by a one-rank
    ``Predictor.from_checkpoint`` (its generator bit for bit the
    checkpoint's) and by a one-rank `train` resume to step 48 (counted).
    Rank 0 alone prints; each rank's launches counted. ``ranks``: each
    rank's results of the runs. Returns the launches by run and rank."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    whole, resumed = os.path.join(tmp, "tp-whole"), os.path.join(tmp, "tp-resumed")
    launches = {}
    for i, steps in enumerate((16, 16, 32)):
        lead = ranks[0][i]["stdout"]
        lines = metric_lines(lead)
        evals = sum("eval_l2" in r for r in lines)
        for r, runs_of_rank in enumerate(ranks):
            res = runs_of_rank[i]
            runs_of = {"config1 step tp2": steps, **({"config1 serving": evals} if r == 0 else {})}
            check_runs(f"config1 tp2 train loop run {i} rank {r}", res["launches"], runs_of,
                       routes=res["routes"])
            launches[f"config1 tp2 train loop run {i} rank {r}"] = res["launches"]
            if r:
                check("[acgan]" not in res["stdout"] and not metric_lines(res["stdout"]),
                      f"rank {r} printed: {res['stdout'][-1000:]}")
        check(lines and all(np.isfinite(v) for row in lines for v in row.values()),
              f"run {i}: rank 0's metric lines {lines}")
        check("mesh data=1 model=2" in lead, f"run {i} did not run on the 1x2 mesh")
    check("resumed from checkpoint at step 16" in ranks[0][1]["stdout"],
          "the second run did not resume")
    same, max_diff, where = compare_states(final_params(resumed, 32), final_params(whole, 32))
    ckpt = final_params(whole, 32)
    gathered = torch.load(os.path.join(tmp, "tp-train-gathered.pt"), weights_only=True)
    same_gathered = all(torch.equal(v, ckpt[f"{t}/{k}"]) for t in ("g_params", "d_params")
                        for k, v in gathered[t].items())
    cfg = apply_overrides(get_preset("config1"), PHASE20_LOOP_ARGS[3::2])
    served = Predictor.from_checkpoint(cfg, whole, device="cuda")
    same_served = all(torch.equal(v.cpu(), ckpt[f"g_params/{k}"])
                      for k, v in served.generator.state_dict().items())
    (p_args, _) = serving_inputs(cfg, 8, 1, 1, seed=20)
    served_ok = bool(torch.isfinite(served.predict(*p_args).float()).all())
    one = os.path.join(tmp, "tp-to-one")
    shutil.copytree(whole, one)
    reset_launches()
    out = run_cli(["train", *LOOP_ARGS, "--set", "train.checkpoint_every=16", "--workdir", one,
                   "--steps", "48", "--device", "cuda:0"])
    launches["config1 one-rank resume of a tp2 checkpoint"] = read_launches()
    check_runs("config1 one-rank resume of a tp2 checkpoint",
               launches["config1 one-rank resume of a tp2 checkpoint"], {"config1 step": 16})
    resumed_one = "resumed from checkpoint at step 32" in out
    say(f"tp2 train: 16 + 16 steps against 32 uninterrupted, cudnn.deterministic: bit-identical "
        f"{same}, max |d| {max_diff:.3e} at {where}; checkpoint = gathered state {same_gathered}; "
        f"one-rank Predictor.from_checkpoint bit for bit {same_served}, predicts finite "
        f"{served_ok}; one-rank `train` resumed at 32 {resumed_one}; checkpoints "
        f"{checkpoint_steps(whole)} / {checkpoint_steps(resumed)} ({smi})")
    check(same, f"the resumed tp2 run differs: {max_diff:.3e} at {where}")
    check(same_gathered and same_served and served_ok and resumed_one,
          "the tp2 checkpoint is not the gathered state, or does not restore on one rank")
    check(checkpoint_steps(whole) == [16, 32], f"checkpoints {checkpoint_steps(whole)}")
    return launches


def phase20_serving(smi):
    """Phase 20 (e): ``Predictor`` over the 1x2 grid [[cuda:0, cuda:0]]
    (each sharded layer's two channel shards computed in turn, concatenated)
    against one device, config5 (256x256): predict B=32 and rollout T=30
    B=8 in bfloat16, counted, every kernel call recorded. The predict, and
    every generator call of the rollout fed the one-device rollout's frames,
    within 3e-2 (the shards' kernels round otherwise than the whole
    layers'). The free-running bfloat16 rollout compounds those roundings
    over 30 steps, as the one-device bfloat16 rollout compounds its own
    against float32: its distance from the float32 rollout is held within
    twice the one-device one's (or 3e-2). In float32 (B=2) predict and a
    T=3 rollout within 1e-4; the T=30 float32 rollout's difference is
    printed (rounding compounds there too). Returns (launches, recorded
    calls)."""
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.infer import Predictor

    grid = [["cuda:0", "cuda:0"]]
    c5 = get_preset("config5")
    params = seeded_params(c5, seed=5)
    one = Predictor(c5, params, device="cuda")
    tp2 = one.with_mesh(grid)
    p_args, r_args = serving_inputs(c5, 32, 30, 8, seed=20)
    reset_launches()
    with recorded_calls() as rec:
        got_p, got_r = tp2.predict(*p_args), tp2.rollout(*r_args)
        torch.cuda.synchronize()
    launches = read_launches()
    check_runs("config5 tp2 serving", launches, {"config5 tp2 serving": 1 + 30})
    e_p = float((got_p.float() - one.predict(*p_args).float()).abs().max())
    want_r = one.rollout(*r_args)
    e_r = float((got_r.float() - want_r.float()).abs().max())
    frame0, actions, states = r_args
    e_step = 0.0
    for t in range(actions.shape[1]):
        x = torch.as_tensor(frame0) if t == 0 else want_r[:, t - 1].float().cpu()
        args = (x, actions[:, t], None if states is None else states[:, t])
        e_step = max(e_step, float((tp2.predict(*args).float() - want_r[:, t].float())
                                   .abs().max()))
    c5f = c5.replace(model=dataclasses.replace(c5.model, compute_dtype="float32"))
    f32 = Predictor(c5f, params, device="cuda")
    f32_r = f32.rollout(*r_args).float()
    drift_one = float((want_r.float() - f32_r).abs().max())
    drift_tp = float((got_r.float() - f32_r).abs().max())
    args, roll = serving_inputs(c5f, 2, 30, 2, seed=21)
    f32_grid = f32.with_mesh(grid)
    e_f32 = max(float((f32_grid.predict(*args) - f32.predict(*args)).abs().max()),
                float((f32_grid.rollout(roll[0], roll[1][:, :3], None) -
                       f32.rollout(roll[0], roll[1][:, :3], None)).abs().max()))
    # Not held: float32 rounding compounds over 30 steps too.
    e_f32_t30 = float((f32_grid.rollout(*roll) - f32.rollout(*roll)).abs().max())
    ms = {}
    for label, p in (("one device", one), ("1x2 grid", tp2)):
        ms[label] = cuda_time_ms(lambda p=p: p.predict(*p_args), 5)
    say(f"tp serving over {grid}: config5 bf16 predict B=32 max|d| {e_p:.3e}; rollout T=30 B=8: "
        f"each generator call on the one-device frames max|d| {e_step:.3e} (bar 3e-2), free "
        f"running max|d| {e_r:.3e}, from the float32 rollout {drift_tp:.3e} against the "
        f"one-device bf16 rollout's {drift_one:.3e}; float32 B=2 predict + T=3 rollout max|d| "
        f"{e_f32:.3e} (bar 1e-4), T=30 {e_f32_t30:.3e}; predict ms {ms} (a correctness run: both "
        f"shards on one card) ({smi})")
    check(e_p <= 3e-2 and e_step <= 3e-2,
          f"config5 tp2 serving differs: predict {e_p:.3e}, rollout steps {e_step:.3e}")
    check(drift_tp <= max(3e-2, 2 * drift_one),
          f"the tp2 bf16 rollout drifts {drift_tp:.3e} from float32, one device {drift_one:.3e}")
    check(e_f32 <= 1e-4, f"config5 float32 tp2 serving differs by {e_f32:.3e}")
    return launches, rec


def phase20(smi, totals):
    """Phase 20: channel tensor parallelism. Returns the launches of its
    counted runs; folds the shard-shaped calls' parity into ``totals``."""
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    say(f"phase 20: channel tensor parallelism ({smi})")
    launches = {}
    scratch = os.path.dirname(build.BUILD_DIR)
    with tempfile.TemporaryDirectory(prefix="phase20-", dir=scratch) as tmp:
        # One spawn of two ranks for the 1x2 steps and the `train` runs, one of
        # four for the 2x2 step.
        paths = {w: [p for p, (_, _, (d, m)) in PHASE20_PATHS.items() if d * m == w]
                 for w in (2, 4)}
        two = run_dp_ranks({"jobs": [
            {"mode": "tp_steps", "dir": tmp, "paths": paths[2]},
            {"mode": "tp_train", "dir": tmp, "runs": phase20_train_runs(tmp)}]}, tmp, "tp-1x2",
            world=2, flag="--tp-rank")
        four = run_dp_ranks({"jobs": [{"mode": "tp_steps", "dir": tmp, "paths": paths[4]}]},
                            tmp, "tp-2x2", world=4, flag="--tp-rank")
        results = {p: [o["results"][0][p] for o in out]
                   for out, ps in ((two, paths[2]), (four, paths[4])) for p in ps}
        step_launches, calls = phase20_steps(smi, tmp, results)
        launches.update(step_launches)
        launches.update(phase20_train(smi, tmp, [o["results"][1] for o in two]))
    serving, rec = phase20_serving(smi)
    launches["config5 tp2 serving"] = serving
    for kind in calls:
        calls[kind] += rec[kind]
    # Every distinct shard-shaped call of kernels 1-4 against its plain version.
    phase_train_conv_parity(calls["conv"], totals)
    phase_train_norm_parity(calls["norm"], totals["group_norm_act"])
    phase_gn_bwd_call_parity(calls["gn_bwd"], "phase 20", totals["gn_act_bwd"])
    say(f"phase 20 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phase 21: the serving half of bench ------------------------------------------------


# The reference's serving geometries (its root bench.py --infer): run_infer_bench at
# (EXPECTED path, preset, keywords), then run_serving_bench at config1 B=128, T=10.
# config2's generator is config1's.
PHASE21_INFER = (("config1 serving", "config1", dict(batch=128)),
                 ("config1 serving", "config2", dict()),
                 ("config5 serving", "config5", dict(batch=8, k=4)))
PHASE21_SERVING = dict(batch=128, rollout=10)
# The benches' windows (bench.py's defaults): one warm call, one warm window, then
# PHASE21_WINDOWS timed windows of PHASE21_PER_WINDOW[mode] calls.
PHASE21_WINDOWS, PHASE21_PER_WINDOW = 3, {"infer": 8, "serving": 4}
HEADER_KEYS = ("config", "image_size", "batch_size", "rollout_length", "device",
               "peak_memory_gb")
INFER_KEYS = ("infer_step_latency_ms", "infer_fps_per_chip", "rollout_latency_ms",
              "rollout_fps_per_chip", "barrier_round_trip_ms")
SERVING_KEYS = ("serving_live_ms", "serving_live_fps", "artifact_bytes", "serving_aot_ms",
                "serving_aot_fps", "aot_overhead_pct")


def check_bench_line(label, line, keys):
    """A serving bench line: its keys the reference line's plus peak_memory_gb,
    measured on this card; every time, rate and size finite and > 0, the AOT
    overhead (a signed share) finite."""
    check(sorted(line) == sorted([*HEADER_KEYS, *keys]), f"{label}: keys {sorted(line)}")
    check(line["device"] == torch.cuda.get_device_name(0), f"{label}: device {line['device']}")
    for k in keys:
        check(np.isfinite(line[k]) and (k == "aot_overhead_pct" or line[k] > 0),
              f"{label}: {k} = {line[k]}")


def bench_calls(mode):
    """Calls of the timed function in one bench run of ``mode`` at phase 21's
    windows."""
    return 1 + (1 + PHASE21_WINDOWS) * PHASE21_PER_WINDOW[mode]


def phase21_bench_calls(smi):
    """run_infer_bench at the reference's three geometries and
    run_serving_bench at config1 B=128, T=10, in this process: counts set to
    0 just before each call and read just after, against EXPECTED times the
    generator calls of every window of it (a call's k bank applications and
    T rollout steps; the serving bench's live and AOT rollouts)."""
    from action_conditioned_gans_tpu_torch.bench import run_infer_bench, run_serving_bench
    from action_conditioned_gans_tpu_torch.config import get_preset

    launches = {}
    for path, preset, kw in PHASE21_INFER:
        cfg = get_preset(preset)
        reset_launches()
        line = run_infer_bench(cfg, windows=PHASE21_WINDOWS,
                               calls_per_window=PHASE21_PER_WINDOW["infer"], device="cuda", **kw)
        torch.cuda.synchronize()
        label = f"{preset} bench infer"
        launches[label] = read_launches()
        k, t = kw.get("k", 32), line["rollout_length"]
        say(f"bench infer {json.dumps(line)} ({smi})")
        check_bench_line(label, line, INFER_KEYS)
        check((line["batch_size"], t) == (kw.get("batch", cfg.train.batch_size),
                                         max(cfg.train.rollout_length, 1)), f"{label} geometry")
        check_launches(label, launches[label], {path: bench_calls("infer") * (k + t)})
    cfg = get_preset("config1")
    reset_launches()
    line = run_serving_bench(cfg, windows=PHASE21_WINDOWS,
                             calls_per_window=PHASE21_PER_WINDOW["serving"], device="cuda",
                             **PHASE21_SERVING)
    torch.cuda.synchronize()
    launches["config1 bench serving"] = read_launches()
    say(f"bench serving {json.dumps(line)} ({smi})")
    check_bench_line("config1 bench serving", line, SERVING_KEYS)
    rollouts = 2 * bench_calls("serving")  # live and AOT
    check_launches("config1 bench serving", launches["config1 bench serving"],
                   {"config1 serving": rollouts * PHASE21_SERVING["rollout"]})
    return launches


def phase21_aot_bits(smi, tmp):
    """The config1 T=10 program exported (timed) and served at B=128 against
    the live predictor on the same weights and inputs: bit-identical frames,
    each run's launches counted."""
    from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    cfg = get_preset("config1")
    params = seeded_params(cfg, seed=21)
    path = os.path.join(tmp, "config1_t10.aot")
    t0 = time.perf_counter()
    meta = export_aot(cfg, flax_to_state_dict(params), path, rollout_length=10, device="cuda")
    export_s = time.perf_counter() - t0
    say(f"export of config1's T=10 program on cuda: {meta['bytes']} bytes in {export_s:.1f} s "
        f"({smi})")
    live, aot = Predictor(cfg, params, device="cuda"), AotPredictor(path, device="cuda")
    _, r_args = serving_inputs(cfg, 128, 10, 128, seed=21)
    live.rollout(*r_args)
    aot.rollout(*r_args)
    torch.cuda.synchronize()
    launches = {}
    reset_launches()
    got_live = live.rollout(*r_args)
    torch.cuda.synchronize()
    launches["config1 live rollout T=10 B=128"] = read_launches()
    check_runs("config1 live rollout T=10 B=128", launches["config1 live rollout T=10 B=128"],
               {"config1 serving": 10})
    reset_launches()
    got_aot = aot.rollout(*r_args)
    torch.cuda.synchronize()
    launches["config1 AOT rollout T=10 B=128"] = read_launches()
    check_program_runs("config1 AOT rollout T=10 B=128",
                       launches["config1 AOT rollout T=10 B=128"], {"config1 serving": 10})
    same = torch.equal(got_live, got_aot)
    say(f"config1 rollout T=10 B=128: AOT program bit-identical to the live predictor: {same}")
    check(same and tuple(got_aot.shape) == (128, 10, 64, 64, 3),
          "the AOT rollout differs from the live one")
    return launches


def phase21_cli(smi):
    """``bench --mode infer`` and ``--mode serving`` as processes of their
    own: one JSON line on standard output each, the reference line's keys."""
    base = ["--preset", "config1", "--set", "train.batch_size=128"]
    for mode, extra, keys in (("infer", [], INFER_KEYS),
                              ("serving", ["--rollout-length", "10"], SERVING_KEYS)):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "action_conditioned_gans_tpu_torch", "bench",
                               "--mode", mode, *base, *extra], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"bench --mode {mode} exited {proc.returncode}: "
              + proc.stderr[-2000:])
        lines = proc.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench --mode {mode} printed {len(lines)} lines: {lines[-5:]}")
        line = json.loads(lines[0])
        check((line["batch_size"], line["rollout_length"]) == (128, 10 if extra else 1),
              f"bench --mode {mode} geometry")
        check_bench_line(f"bench --mode {mode}", line, keys)
        say(f"cli bench --mode {mode} ({time.perf_counter() - t0:.1f} s in its process): "
            f"{lines[0]} ({smi})")


def phase21_batch_norm(smi, tmp):
    """ROADMAP Queue 3 fault 3 on the card: config1 with batch norm in
    float32, served over [cuda:0, cuda:0] and over the grid [[cuda:0,
    cuda:0]] live, and over [cuda:0, cuda:0] by its AOT program: predict B=16
    and rollout T=3 B=16 within 1e-5 of one device. Beside it, the gap the
    halves normalised alone would show."""
    from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    c1 = get_preset("config1")
    cfg = c1.replace(model=dataclasses.replace(c1.model, norm="batch", compute_dtype="float32"))
    params = seeded_params(cfg, seed=22)
    one = Predictor(cfg, params, device="cuda")
    path = os.path.join(tmp, "config1_bn_f32.aot")
    export_aot(cfg, flax_to_state_dict(params), path, rollout_length=3, device="cuda")
    p_args, r_args = serving_inputs(cfg, 16, 3, 16, seed=22)
    want_p, want_r = one.predict(*p_args), one.rollout(*r_args)
    served = {"live [cuda:0, cuda:0]": one.with_mesh(["cuda:0"] * 2),
              "live [[cuda:0, cuda:0]]": one.with_mesh([["cuda:0", "cuda:0"]]),
              "AOT [cuda:0, cuda:0]": AotPredictor(path, mesh=["cuda:0"] * 2)}
    errs = {}
    for label, p in served.items():
        errs[label] = max(float((p.predict(*p_args) - want_p).abs().max()),
                          float((p.rollout(*r_args) - want_r).abs().max()))
    halves = torch.cat([one.predict(*(None if a is None else a[i:i + 8] for a in p_args))
                        for i in (0, 8)])
    split_gap = float((halves - want_p).abs().max())
    say(f"batch-norm serving, config1 f32 predict B=16 + rollout T=3 B=16, max|d| from one "
        f"device: {json.dumps(errs)} (bar 1e-5); the two halves normalised alone would differ "
        f"by {split_gap:.3e} ({smi})")
    for label, e in errs.items():
        check(e <= 1e-5, f"batch-norm serving {label} differs from one device by {e:.3e}")


def phase21(smi):
    """Phase 21: the serving half of bench. Returns the launches of its
    counted runs."""
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    say(f"phase 21: the serving half of bench ({smi})")
    launches = phase21_bench_calls(smi)
    with tempfile.TemporaryDirectory(prefix="phase21-", dir=os.path.dirname(build.BUILD_DIR)) as tmp:
        launches.update(phase21_aot_bits(smi, tmp))
        phase21_batch_norm(smi, tmp)
    phase21_cli(smi)
    say(f"phase 21 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# -- phase 22: the flat optimizer (train.flatten_optimizer) ----------------------------

# Parameter counts of G and D at config1 and config5 (the flat vectors kernel 5
# updates; tests/test_torch_flat_optimizer.py pins the layouts).
ADAM_SIZES = {"config1 G": 1_917_635, "config1 D": 2_772_801, "config5 G": 16_283_331,
              "config5 D": 19_019_457}
ADAM_HYPER = dict(b1=0.5, b2=0.999, eps=1e-8, lr=2e-4)  # the presets' Adam
ADAM_OPS = 11  # float32 operations an element: 3 mul, 3 fma, 3 div, sqrt, add


def flat_train_config(batch=128):
    """config1 as phase 10 trains it, with train.flatten_optimizer."""
    cfg = config1_train_config(batch)
    return cfg.replace(train=dataclasses.replace(cfg.train, flatten_optimizer=True))


def ulp_distance(a, b):
    """(largest distance in units in the last place, entries whose bits
    differ) between two float32 or bfloat16 tensors (+0 and -0 equal)."""
    bits, mask = (torch.int32, 0x7FFFFFFF) if a.dtype == torch.float32 else (torch.int16, 0x7FFF)

    def ordered(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)

    d = (ordered(a) - ordered(b)).abs()
    return int(d.max()), int((d > 0).sum())


def adam_operands(n, moments, seed):
    """A flat parameter vector, its moments and three gradients on the card,
    from a seed: the gradients' global norms 0.5, 5 and 0.5 (the second is
    clipped by a clip of 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    mu = (torch.randn(n, device="cuda", generator=gen) * 1e-3).to(moments)
    nu = (torch.rand(n, device="cuda", generator=gen) * 1e-6).to(moments)
    grads = [torch.randn(n, device="cuda", generator=gen) * (s / n ** 0.5) for s in (0.5, 5.0, 0.5)]
    return p, mu, nu, grads


def adam_scalars(count, clip=0.0, g=None):
    return dict(ADAM_HYPER, bc1=1.0 - ADAM_HYPER["b1"] ** count,
                bc2=1.0 - ADAM_HYPER["b2"] ** count, clip=clip,
                norm=torch.linalg.vector_norm(g) if clip > 0 else None)


def phase22_parity():
    """Kernel 5 against its plain version on the card at config1's and
    config5's G and D sizes, float32 and bfloat16 moments, with and without
    clipping: three updates from one state, then each of p, mu and nu held
    to 1 ULP. Returns the largest |kernel - plain| over them."""
    from action_conditioned_gans_tpu_torch.ops.kernels import adam as K

    worst = 0.0
    for i, (label, n) in enumerate(ADAM_SIZES.items()):
        for moments in (torch.float32, torch.bfloat16):
            for clip in (0.0, 1.0):
                p, mu, nu, grads = adam_operands(n, moments, seed=220 + i)
                kp, kmu, knu = p.clone(), mu.clone(), nu.clone()
                for count, g in enumerate(grads, 1):
                    K.adam_flat(kp, g, kmu, knu, **adam_scalars(count, clip, g))
                    K.adam_flat_plain(p, g, mu, nu, **adam_scalars(count, clip, g))
                torch.cuda.synchronize()
                ulps = {name: ulp_distance(a, b) for name, a, b in (
                    ("p", kp, p), ("mu", kmu, mu), ("nu", knu, nu))}
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in ((kp, p), (kmu, mu), (knu, nu)))
                say(f"adam_flat parity {label} n={n} {str(moments)[6:]} moments clip={clip}: "
                    f"3 updates, (max ULP, entries differing) " + json.dumps(ulps)
                    + f", max |d|={err:.3e}")
                check(all(bool(torch.isfinite(t.float()).all()) for t in (kp, kmu, knu)),
                      f"adam_flat {label}: a non-finite value")
                check(all(u <= 1 for u, _ in ulps.values()),
                      f"adam_flat {label} {moments} clip={clip}: beyond 1 ULP of the plain version")
                worst = max(worst, err)
    return worst


def phase22_times(smi, worst):
    """Kernel 5, its plain version and (float32 moments) one
    ``torch._fused_adam_`` call over the same single tensor, device time by
    CUDA-graph replay, at each ADAM_SIZES vector, with the bound (bytes over
    the memory rate). Successive launches take turns over enough copies of
    the operands that each finds its own out of the 50 MB L2, as an update
    in a step finds them. Returns the kernels line's totals: config1's G + D
    with bfloat16 moments (the main path's), and its float32 numbers beside."""
    import itertools

    from action_conditioned_gans_tpu_torch.ops.kernels import adam as K

    rows = {}
    for label, n in ADAM_SIZES.items():
        for moments in (torch.float32, torch.bfloat16):
            nbytes = n * (28 if moments == torch.float32 else 20)
            copies = [adam_operands(n, moments, seed=229 + j)
                      for j in range(1 + -(-100_000_000 // nbytes))]
            kw = adam_scalars(1)
            step = torch.ones((), device="cuda")

            def rotating(fn, turn=itertools.count()):
                def call():
                    p, mu, nu, (g, *_) = copies[next(turn) % len(copies)]
                    fn(p, g, mu, nu)
                return call

            ms = device_time_ms(rotating(lambda p, g, mu, nu: K.adam_flat(p, g, mu, nu, **kw)))
            plain_ms = device_time_ms(rotating(
                lambda p, g, mu, nu: K.adam_flat_plain(p, g, mu, nu, **kw)))
            library_ms = None
            if moments == torch.float32:
                try:
                    library_ms = device_time_ms(rotating(lambda p, g, mu, nu: torch._fused_adam_(
                        [p], [g], [mu], [nu], [], [step], lr=kw["lr"], beta1=kw["b1"],
                        beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
                        maximize=False)))
                except (RuntimeError, TypeError) as e:
                    say(f"adam_flat: torch._fused_adam_ refused the call, library time not "
                        f"measured: {e}")
            bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ADAM_OPS * n / PEAK_F32_FLOPS * 1e3
            row = dict(vector=label, n=n, moments=str(moments)[6:], ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms), bytes=nbytes,
                       ops_ms=ops_ms, bytes_ms=bytes_ms, gb_per_s=nbytes / ms / 1e6,
                       operand_copies=len(copies), card=smi)
            del copies
            say("adam_layer " + json.dumps(row))
            rows[(label, row["moments"])] = row
    def total(key, moments, model="config1"):
        parts = [rows[(f"{model} {net}", moments)][key] for net in ("G", "D")]
        return None if None in parts else sum(parts)

    return dict(ms=total("ms", "bfloat16"), plain_ms=total("plain_ms", "bfloat16"),
                library_ms=None, bound_ms=total("bound_ms", "bfloat16"),
                ops_ms=total("ops_ms", "bfloat16"), bytes_ms=total("bytes_ms", "bfloat16"),
                max_abs_err=worst, f32_ms=total("ms", "float32"),
                f32_plain_ms=total("plain_ms", "float32"),
                f32_library_ms=total("library_ms", "float32"),
                f32_bound_ms=total("bound_ms", "float32"),
                config5_ms=total("ms", "bfloat16", "config5"),
                config5_bound_ms=total("bound_ms", "bfloat16", "config5"))


def optimizer_launches(cfg, state, tries=3):
    """Device kernels that one train step's Adam updates launch (G's, and
    D's once for each of ``disc_steps``), from torch.profiler over the
    updates alone on gradients shaped as the step's.

    Each launch runs one kernel, so the kernels a trace holds must equal the
    launch calls (``cudaLaunchKernel``) it holds on the host side. On an
    H100 a trace was seen to lose all or part of its device side now and
    then (0 of a flat step's 2 kernels, 98 of a per-tensor step's 148), so
    the window is padded by 50 ms at each end, and a trace whose two counts
    differ, or that holds no launch, is taken again, up to ``tries`` times.
    Returns the device count of the first trace whose counts agree; raises
    if none does."""
    from torch.profiler import ProfilerActivity, profile

    from action_conditioned_gans_tpu_torch.train.state import flat_grad, make_optimizers

    g_tx, d_tx = make_optimizers(cfg)
    work = []
    for tx, params, opt in ((d_tx, state.d_params, state.d_opt), (g_tx, state.g_params, state.g_opt)):
        grads = [torch.randn_like(v) * 1e-3 for v in params.values()]
        if tx.flat:
            grads = flat_grad(params, grads)
        work.append((tx, params, grads, opt))
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for tx, params, grads, opt in work:
                for _ in range(max(cfg.train.disc_steps, 1) if tx is d_tx else 1):
                    tx.update_(params, grads, opt)
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = list(prof.events())
        kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
        calls = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                    and "LaunchKernel" in e.name)
        if kernels == calls > 0:
            return kernels
        seen.append((kernels, calls))
    raise RuntimeError(f"torch.profiler's kernels and launch calls differed in {tries} traces "
                       f"(kernels, calls): {seen}")


def adam_launches_main() -> int:
    """``chip_smoke.py --adam-launches``: :func:`optimizer_launches` of the
    config1 step in both layouts, float32 and bfloat16 moments, as one JSON
    line. Phase 22 runs it in a process of its own: late in a long process
    that has traced before, torch.profiler was seen to miss device events
    (0 launches where a fresh process counts 20)."""
    from action_conditioned_gans_tpu_torch.train import init_state

    out = {}
    for moments in ("float32", "bfloat16"):
        for flat in (False, True):
            cfg = flat_train_config() if flat else config1_train_config()
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, adam_moment_dtype=moments))
            state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
            out[f"{moments} {'flat' if flat else 'per-tensor'}"] = optimizer_launches(cfg, state)
    print(json.dumps(out))
    return 0


def phase22_steps(smi):
    """The config1 step (B=128, bfloat16 compute) with train.flatten_optimizer
    against the step without it, under cudnn.deterministic: 3 steps from one
    init, float32 and bfloat16 moments, the parameters within the reference
    test's bar (atol 1e-9, rtol 1e-6); the flat bfloat16 steps counted
    (counts set to 0 just before, read just after). Then both layouts' Adam
    launches a step (profiler, :func:`adam_launches_main`) and their step
    times in turns. Returns the counted launches."""
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step

    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--adam-launches"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"chip_smoke.py --adam-launches exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    counted = json.loads(proc.stdout.strip().splitlines()[-1])
    deterministic = torch.backends.cudnn.deterministic
    launches = None
    for moments in ("float32", "bfloat16"):
        cfgs = {flat: (flat_train_config() if flat else config1_train_config()) for flat in (0, 1)}
        cfgs = {k: c.replace(train=dataclasses.replace(c.train, adam_moment_dtype=moments))
                for k, c in cfgs.items()}
        batches = [{k: v.cuda() for k, v in b.items()} for b in phase19_batches(cfgs[0], 4, 22)]
        states, steps = {}, {}
        torch.backends.cudnn.deterministic = True
        try:
            for flat, cfg in cfgs.items():
                state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
                steps[flat] = make_train_step(cfg, device="cuda")
                if flat and moments == "bfloat16":
                    torch.cuda.synchronize()
                    reset_launches()
                for i in range(3):
                    state, m = steps[flat](state, batches[i])
                torch.cuda.synchronize()
                if flat and moments == "bfloat16":
                    launches = read_launches()
                    check_counts("config1 flat step", launches, 3)
                states[flat] = state
        finally:
            torch.backends.cudnn.deterministic = deterministic
        worst, same = 0.0, True
        for tree in ("g_params", "d_params"):
            for k, want in getattr(states[0], tree).items():
                got = getattr(states[1], tree)[k]
                same &= torch.equal(got, want)
                excess = float(((got - want).abs() - (1e-9 + 1e-6 * want.abs())).max())
                worst = max(worst, excess)
        diff = max(float((getattr(states[1], t)[k] - v).abs().max())
                   for t in ("g_params", "d_params") for k, v in getattr(states[0], t).items())
        say(f"flat step: config1 B=128 {moments} moments, 3 steps flat against per-tensor, "
            f"cudnn.deterministic: bit-identical {same}, max |d| {diff:.3e}")
        check(worst <= 0, f"flat step ({moments} moments) beyond atol 1e-9 + rtol 1e-6 of the "
              f"per-tensor step (excess {worst:.3e})")
        adam = {0: counted[f"{moments} per-tensor"], 1: counted[f"{moments} flat"]}
        times = {0: [], 1: []}
        state = {flat: states[flat] for flat in (0, 1)}
        for flat in (0, 1, 1, 0):
            def window(flat=flat):
                for i in range(10):
                    state[flat], _ = steps[flat](state[flat], batches[i % 4])
            times[flat].append(cuda_time_ms(window, iters=1, warmup=1) / 10)
        line = dict(path="config1 step", batch=128, moments=moments,
                    adam_launches_per_step_per_tensor=adam[0], adam_launches_per_step_flat=adam[1],
                    step_ms_per_tensor=times[0], step_ms_flat=times[1],
                    median_ms_per_tensor=float(np.median(times[0])),
                    median_ms_flat=float(np.median(times[1])), card=smi)
        say("flat step " + json.dumps(line))
        check(adam[1] == 2 and adam[0] > 2,
              f"Adam launches a step: {adam[0]} per-tensor, {adam[1]} flat (want 2)")
    return launches


def phase22_train(smi, tmp):
    """A flat config1 ``train`` (phase 12's arguments with
    train.flatten_optimizer, cudnn.deterministic): 48 steps uninterrupted
    (counts set to 0 just before, read just after), and a run that SIGTERM
    stops after its first call (sent from inside the loop, as
    tests/test_torch_loop.py sends it; phase 12 covers the signal from
    outside) and that is resumed to 48: bit for bit. Its checkpoint served
    through ``Predictor.from_checkpoint``, equal to the checkpoint's weights
    served directly. Returns the counted launches."""
    from action_conditioned_gans_tpu_torch.cli import apply_overrides
    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import state_dict_to_flax
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.utils.metrics import MetricWriter

    flat = ["--set", "train.flatten_optimizer=true"]
    args = [*LOOP_ARGS, *flat]
    whole, stopped_dir = os.path.join(tmp, "whole"), os.path.join(tmp, "stopped")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        out = run_cli(["train", *args, "--workdir", whole, "--steps", "48"])
        launches = read_launches()
        evals = [r for r in metric_lines(out) if "eval_l2" in r]
        check_runs("config1 flat train loop", launches,
                   {"config1 flat step": 48, "config1 serving": len(evals)})
        tick = MetricWriter.tick

        def tick_and_term(self):
            tick(self)
            if not fired:
                fired.append(True)
                os.kill(os.getpid(), signal.SIGTERM)

        fired, MetricWriter.tick = [], tick_and_term
        try:
            out = run_cli(["train", *args, "--workdir", stopped_dir, "--steps", "48"])
        finally:
            MetricWriter.tick = tick
        stopped = [int(line.split("at step ")[1].split()[0]) for line in out.splitlines()
                   if "SIGTERM received" in line]
        check(len(stopped) == 1 and checkpoint_steps(stopped_dir) == stopped,
              f"the SIGTERM run: {stopped}, checkpoints {checkpoint_steps(stopped_dir)}")
        stop = stopped[0]
        check(stop < 48, f"the SIGTERM run stopped at {stop}, past the compared step 48")
        resumed = run_cli(["train", *args, "--workdir", stopped_dir, "--steps", "48"])
        check(f"resumed from checkpoint at step {stop}" in resumed,
              f"the flat run did not resume at {stop}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = final_params(whole, 48), final_params(stopped_dir, 48)
    check(a["g_opt/mu"].dim() == 1, "the flat checkpoint holds per-tensor moments")
    same, max_diff, where = compare_states(a, b)
    say(f"flat train: SIGTERM at step {stop}, resumed to 48, against 48 uninterrupted, "
        f"cudnn.deterministic: bit-identical {same}, max |d| {max_diff:.3e} at {where}")
    check(same, f"the resumed flat run differs: {max_diff:.3e} at {where}")
    cfg = apply_overrides(get_preset("config1"), [args[i + 1] for i, x in enumerate(args)
                                                  if x == "--set"])
    served = Predictor.from_checkpoint(cfg, workdir=whole, device="cuda")
    direct = Predictor(cfg, state_dict_to_flax({k[len("g_params/"):]: v for k, v in a.items()
                                                if k.startswith("g_params/")}), device="cuda")
    rng = np.random.default_rng(22)
    frame = np.tanh(rng.standard_normal((16, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((16, 4)).astype(np.float32)
    got, want = served.predict(frame, action), direct.predict(frame, action)
    check(bool(torch.isfinite(got.float()).all()) and torch.equal(got, want),
          "the flat checkpoint served through Predictor.from_checkpoint differs from its weights")
    say(f"flat train: step-48 checkpoint served through Predictor.from_checkpoint: predict "
        f"B=16 finite and equal to its weights served directly ({smi})")
    return launches


def phase22_nccl(tmp):
    """A world-1 NCCL group in this process: the flat config1 step through
    the DP path (the flat gradient all-reduced in place) against the step
    without a group, 3 steps, cudnn.deterministic, bit for bit; the DP
    steps counted. Returns their launches."""
    import datetime

    import torch.distributed as dist

    from action_conditioned_gans_tpu_torch.ops import api
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
    from action_conditioned_gans_tpu_torch.train import init_state, make_train_step
    from action_conditioned_gans_tpu_torch.train.state import state_to_host

    cfg = flat_train_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, steps_per_call=1))
    batches = [{k: v.cuda() for k, v in b.items()} for b in phase19_batches(cfg, 3, 23)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trees = {}
    try:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl22.init')}",
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh(cfg.mesh, device="cuda")
            for name, step in (("none", make_train_step(cfg, device="cuda")),
                               ("dp", make_dp_train_step(cfg, mesh))):
                state = init_state(cfg, torch.Generator().manual_seed(0), device="cuda")
                torch.cuda.synchronize()
                if name == "dp":
                    reset_launches()
                for b in batches:
                    state, _ = step(state, b)
                torch.cuda.synchronize()
                if name == "dp":
                    launches, routes = read_launches(), dict(api.ROUTES)
                trees[name] = state_to_host(state, cfg)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(trees["dp"]["g_opt"]["mu"].dim() == 1, "the DP state is not flat")
    same = all(torch.equal(a, b) for tree in ("g_params", "d_params", "g_opt", "d_opt")
               for a, b in zip(_leaves(trees["none"][tree]), _leaves(trees["dp"][tree])))
    say(f"flat nccl world 1: 3 flat config1 steps through the DP path against the step without "
        f"a group, cudnn.deterministic: bit-identical {same}")
    check(same, "the flat world-1 NCCL DP step differs from the step without a group")
    check_runs("config1 flat nccl step", launches, {"config1 flat step": 3}, routes)
    return launches


def phase22(smi):
    """Phase 22: train.flatten_optimizer. Returns the launches of its counted
    runs and the kernels line's totals for kernel 5."""
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t_phase = time.perf_counter()
    mark = [t_phase]

    def lap(label):
        now = time.perf_counter()
        say(f"phase 22 {label} took {now - mark[0]:.1f} s")
        mark[0] = now

    say(f"phase 22: the flat optimizer, kernel 5 ({smi})")
    worst = phase22_parity()
    lap("(a) parity")
    totals = phase22_times(smi, worst)
    lap("(a) times")
    launches = {"config1 flat step": phase22_steps(smi)}
    lap("(b) steps")
    with tempfile.TemporaryDirectory(prefix="phase22-", dir=os.path.dirname(build.BUILD_DIR)) as tmp:
        launches["config1 flat train loop"] = phase22_train(smi, tmp)
        lap("(c) train")
        launches["config1 flat nccl step"] = phase22_nccl(tmp)
        lap("(d) nccl")
    # `bench` over the flat path (phase 12's bench settings): one JSON line.
    out = run_cli(["bench", "--preset", "config1", "--set", "train.batch_size=128",
                   "--set", "train.adam_moment_dtype=bfloat16", "--set", "train.steps_per_call=16",
                   "--set", "train.flatten_optimizer=true"])
    line = metric_lines(out)[-1]
    say(f"flat bench {json.dumps(line)} ({smi})")
    check(line["device"] == torch.cuda.get_device_name(0) and line["p50_step_latency_ms"] > 0,
          f"the flat bench line: {line}")
    lap("(e) bench")
    say(f"phase 22 took {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say(smi)
    # The plain versions are the references: no TF32 in their convs/matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    say(f"card (clocks.sm, clocks.max.sm, temperature, power.draw): {card_state()}")
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    mark = [t0]

    def lap(label):
        """Print the seconds since the last mark: each phase's time."""
        now = time.perf_counter()
        say(f"{label} took {now - mark[0]:.1f} s")
        mark[0] = now

    paths = build.build_all()
    build_s = time.perf_counter() - t0
    say(f"built {sorted(paths)} for sm_90a in {build_s:.1f} s -> {build.BUILD_DIR}")
    for lib, kernel, want in (("conv_norm_act", "conv_wgmma_kernel", 10),
                              ("conv_transpose_norm_act", "conv_wgmma_kernel", 10),
                              ("conv_transpose_norm_act", "narrow_transpose_kernel", 4),
                              ("group_norm_act", "gn_cluster_kernel", 16),
                              ("gn_act_bwd", "gn_bwd_cluster_kernel", 24),
                              ("adam_flat", "adam_flat_kernel", 8)):
        found = {k: v for k, v in build.ptxas_report(lib).items() if kernel in k}
        check(len(found) == want, f"ptxas reported {len(found)} {kernel} instances in {lib}, want {want}")
        for k, v in sorted(found.items()):
            say(f"ptxas {lib} {kernel}<...>={k.split('kernel', 1)[1][:26]}: {v}")
            check(v["spill_stores"] == 0 and v["spill_loads"] == 0, f"{kernel} spills: {k} {v}")
    lap("phase 1")

    kernel3_calls, kernel4_calls = record_kernel3_calls(), record_kernel4_calls()
    predictor = preset_predictor("config1")
    rng = np.random.default_rng(2)
    frame = np.tanh(rng.standard_normal((8, 64, 64, 3))).astype(np.float32)
    action = rng.standard_normal((8, 4)).astype(np.float32)
    layers = capture_layers(predictor.generator, lambda: predictor.predict(frame, action))
    check(len(layers) == 7, f"expected 7 generator layers, saw {len(layers)}")
    d_layers = discriminator_layers()
    check(len(d_layers) == 4, f"expected 4 discriminator layers, saw {len(d_layers)}")
    worst = phase_parity(layers + d_layers)
    for preset in ("config3", "config5"):
        for name, err in phase_parity(preset_conv_layers(preset), batch=2).items():
            worst[name] = max(worst[name], err)
    phase_parity(edge_layers(), batch=None)
    worst_norm = phase_norm_parity()
    lap("phase 2")
    phase_fixture()
    phase_config5_f32()
    lap("phase 3")
    launches = {"config1 serving": phase_serving(predictor, "config1 serving", 128, 10, 16)}
    lap("phase 4, config1")
    phase_http(predictor)
    lap("phase 5")
    totals = phase_kernel_times(layers, worst, extra=d_layers[1:])
    lap("phase 6, config1 layers")
    del predictor

    predictor = preset_predictor("config5")
    frame = np.tanh(rng.standard_normal((2, 256, 256, 3))).astype(np.float32)
    c5_layers = capture_layers(predictor.generator, lambda: predictor.predict(frame, action[:2]))
    check(len(c5_layers) == 11, f"expected 11 config5 generator layers, saw {len(c5_layers)}")
    launches["config5 serving"] = phase_serving(predictor, "config5 serving", 32, 30, 8, timed=8)
    lap("phase 4, config5")
    totals["group_norm_act"] = phase_norm_times(c5_layers, worst_norm)
    phase_norm_times(c5_layers, worst_norm, batch=8)  # the rollout's batch
    lap("phase 6, kernel 3")
    del predictor

    phase_gn_bwd_parity()
    phase_gn_bwd_bf16_y()
    lap("phase 7")
    phase_autograd_parity(layers + d_layers)
    phase_split_autograd()
    lap("phase 8")
    phase_train_fixture()
    lap("phase 9")
    launches["config1 step"], calls, conv_calls, _ = phase_training(config1_train_config(),
                                                                    "config1 step")
    phase_train_conv_parity(conv_calls, totals)
    totals["gn_act_bwd"] = phase_gn_bwd_times(calls, "config1 step")
    lap("phases 10-11, config1")
    from action_conditioned_gans_tpu_torch.config import get_preset

    launches["config3 step"], calls3, conv_calls, norm_calls = phase_training(
        get_preset("config3"), "config3 step")
    phase_train_conv_parity(conv_calls, totals)
    phase_train_norm_parity(norm_calls, totals["group_norm_act"])
    config3 = phase_gn_bwd_times(calls3, "config3 step")
    totals["gn_act_bwd"]["max_abs_err"] = max(totals["gn_act_bwd"]["max_abs_err"],
                                              config3["max_abs_err"])
    lap("phases 10-11, config3")
    # Phase 12's trace is kept for phase 17's profile-report.
    with tempfile.TemporaryDirectory(prefix="phase12-", dir=os.path.dirname(build.BUILD_DIR)) as keep:
        launches["config1 train loop"], synthetic_cadence, phase12_totals = phase_loop(smi, keep)
        with tempfile.TemporaryDirectory(prefix="loop-c4-",
                                         dir=os.path.dirname(build.BUILD_DIR)) as tmp:
            launches["config4 train loop"], launches["config4 step"] = phase_config4(smi, totals,
                                                                                     tmp)
            launches["config5 step"] = phase_config5(smi, totals)
            launches.update(phase_served(smi, os.path.join(tmp, "whole")))
            mark[0] = time.perf_counter()
            say(f"phase 16: ROADMAP Queue 3 faults 1 and 2 ({smi})")
            phase_fault1(smi)
            launches.update(phase_config2(smi, totals, tmp))
            lap("phase 16")
        launches["config1 file loop"] = phase_file_data(smi, keep, synthetic_cadence,
                                                        phase12_totals)
        lap("phase 17")
    with tempfile.TemporaryDirectory(prefix="phase18-", dir=os.path.dirname(build.BUILD_DIR)) as tmp:
        launches.update(phase18(smi, totals, tmp))
    lap("phase 18")
    launches.update(phase19(smi))
    lap("phase 19")
    launches.update(phase20(smi, totals))
    lap("phase 20")
    launches.update(phase21(smi))
    lap("phase 21")
    flat_launches, totals["adam_flat"] = phase22(smi)
    launches.update(flat_launches)
    lap("phase 22")
    check_plans(kernel3_calls, kernel4_calls)
    say(f"card after the runs (clocks.sm, clocks.max.sm, temperature, power.draw): {card_state()}")

    kernels = []
    for name, info in KERNEL_INFO.items():
        t = totals[name]
        kernels.append(dict(
            name=name, route="cuda", source=info["source"], replaces=info["replaces"],
            launches=sum(path[name] for path in launches.values()),
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by="operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            library_ms=t["library_ms"],
        ))
        if name == "gn_act_bwd":  # kernel 4 over the config3 step's calls, beside config1's
            kernels[-1].update({f"config3_step_{k}": config3[k]
                                for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
        if name == "adam_flat":  # float32 moments and config5's vectors beside
            kernels[-1].update({k: v for k, v in t.items() if k.startswith(("f32_", "config5_"))})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--dp-rank"], ["--tp-rank"]):
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--adam-launches"]:
        sys.exit(adam_launches_main())
    sys.exit(main())
