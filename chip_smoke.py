#!/usr/bin/env python3
"""Smoke test of streamflow_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py      (from the root of a checkout, one GPU)

Phases, each printed on its own line; any failure raises (exit code != 0):
  1. device check (CUDA required; card name and power limit; TF32 off);
  2. kernel build (nvcc, from csrc/, into build/streamflow_tpu_torch/);
  3. every kernel against its plain PyTorch version, on the card, at the
     main path's shapes, in f32 and bf16, with times from CUDA events:
     the default SK layout's K2 forms, the pair layouts' (K2 ffn_pair and
     pw_ffn_pair), K5 dw_chain (dw_impl='pallas', with the cuDNN depthwise
     conv of the default layout timed beside it), K6 dw_banded_mxu and K7
     dw_banded_mxu_t (with cuDNN's bf16 depthwise conv as their library
     yardstick; K7 also equal to K6 bit for bit) and K8 sk_chain_banded
     (cuDNN's conv beside it, as K5),
     and K5, K6, K7 and K8 also at the edges of their bf16 tiles (every
     odd k, each copy width, ragged H and W, B = 1 and 3, images smaller
     than the halo, K7's strips of several tiles and bands: CHAIN_EDGES);
     K1 under three traffics (chip_smoke's +-30 px jitter, a smooth flow
     field, coordinates uniform over the frame; tools/kernel_bench.py
     makes the last two), each timed, and checked at the branches of its
     bf16 body (empty, mixed and multi-plane tiles at ragged sizes, C =
     32, 96, 128 and 512, fewer levels, a smaller radius, a level of size
     zero), K3 and K4 also at the tails of their tiles (one query row,
     fewer keys than a tile, one-window grids of two images), K2 at ragged row
     counts (1, 65, 21121) in all five forms at every width of the path,
     each K2 call timed beside its library composite (bf16 torch ops, the
     hidden activation through device memory: a yardstick, not a
     library_ms), and every timed case with its achieved TFLOP/s and GB/s;
     and the shapes of phase 32's ablation configs: K2 ffn_pair without
     its residual at the Twins MLP widths (Twins1DConv), the K2 forms of
     TAM v1's per-frame flow head (128 -> 2), K3 at d=32 over the B*T
     per-frame GSA images of stage 0 and K4 over the B*T per-frame LGA
     grids; and phase 35's UMT shapes (umt_cases: K3 at d=64 over the ViT
     blocks' 12 heads and at d=384 over GMA's frame pairs, with SDPA
     beside each and at the tails of their tiles; K1 at C=768 under the
     three traffics and at its bf16 body's branches; K2's forms at the
     six SK blocks' widths, the 1920-wide gru's and the 1152-wide flow
     head's on K2's wide path, also at 1, 65 and 5377 rows; K5-K8 at the
     gru's and flow head's dw stages, checked only);
  4. the full forward: StreamFlow, seeded random weights, 436x1024 padded
     to 440x1024, B=1, T=4, 12 iterations, bf16, test mode; launch counts
     of every kernel checked exactly; ms/clip, frames/s, peak memory; a
     torch.profiler breakdown of one forward (table in chiprun_out/);
  5. accuracy guards: the same clip at iters=1 through the kernel path on
     the card and the plain path on the CPU, in f32 and in bf16, relative
     EPE against the f32 plain path bounded (that f32 reference is the
     same function in every layout: computed once, reused by 10, 14, ...);
  6. the training path's kernels at its own shapes (432x960): every
     forward kernel against its plain version as in phase 3 (K3 with its
     logsumexp), B5 against its plain version (also at the tails of its
     tiles: one query row, fewer keys than a tile, ragged counts at d=128
     and d=32), and each kernel wrapper's forward and gradient against its
     plain version; and phase 36's UMT shapes at 432x960 (a 27x60 grid):
     K3 at d=64 (the ViT's 12 heads over fnet's 6480 and cnet's 4860
     tokens) and d=384 (GMA, 3 x 1620) with its logsumexp, K1 at C=768,
     K2's two default forms at the six SK blocks' widths, and B5 at those
     K3 calls' shapes in f32 and bf16 (bf16 timed beside its bound and
     SDPA's backward, named by the backend its dispatcher takes) and at the tails of its d=64 and d=384 tiles;
  7. the train step: seeded weights and batch, 432x960, T=4, 12
     iterations, bf16 compute with f32 parameters, remat, AdamW; launch
     counts checked exactly; ms/step, peak memory, every parameter moves,
     a torch.profiler breakdown of one step;
  8. training guard: one step's loss and gradients at 128x256 through the
     kernel path on the card against the plain path on the CPU;
  9-26. the other SK layouts (StreamFlowConfig.dw_impl), at the same sizes
     and depths, their accuracy guards at 216x512 (LAYOUT_GUARD_H x
     LAYOUT_GUARD_W, against one f32 reference at that size): phases 4, 5,
     7 and 8 again for 'pallas' (9-12: K2
     ffn_pair, K5 dw_chain, K2 pw_ffn_pair), 'banded_mxu' (13-16: K6 in
     place of K5), 'banded_chain' (17-20: K8) and 'banded_mxu_t' (21-24:
     K7), phases 4 and 5 for 'banded' (25-26: the banded composite, no dw
     kernel); their train steps' profiles record the card's activity
     alone (phase 7's keeps the host ops);
  27. the graphed forward (evaluation.GraphedForward: one CUDA graph per
     input shape) of phase 4's clip in 'auto', 'banded_chain' and
     'banded_mxu_t' (K7's persistent kernel under replay): the replay's
     flows against the eager forward's ('banded_mxu_t' bit for bit); the
     kernels of one
     profiled replay, by name, against EXPECTED_LAUNCHES (the Python
     launch counters count at capture, not at replay); ms/clip eager and
     graphed, each path's device time, idle share and peak memory; for
     'auto' also a KITTI bucket (375x1242 padded in 'kitti' mode to
     376x1248), the first bucket replayed again after it, a flow_init
     bucket against its eager call, and two replays on other clips that
     leave the first result unchanged; and, in a process of its own, a
     forward that cannot be captured makes GraphedForward raise;
  28. the serving harness: the validators' per-window steps (plain,
     warm-started and tiled windows; evaluation.py) on in-memory clips,
     three 436x1024 Sintel windows (one a tail window) and a 375x1242
     KITTI window in 432x960 tiles, graphed and eager: flows and metrics
     agree; the graphed side's launch counts (its warm-ups and captures)
     checked exactly;
  29. high resolution, the twin of tools/test_memory.py: 1080x1920 and
     1440x2560, T=4, 12 iterations, bf16, eager and graphed, as phase 27
     (finite flows, graph against eager, times, peak memory);
  30. the trainer (tools/train.py's loop, ``train``) at the sintel_kitti
     preset as given (B=8, 432x960, T=4, 12 iterations, bf16 with f32
     parameters, remat) on in-memory clips from the seed, after every
     kernel of its step and B5 against its plain version at B=8: 6 steps, a
     checkpoint and a validation (phase 28's Sintel windows through the
     run's one GraphedForward) at step 4; the loader's batches on the card
     equal to its numpy batches bit for bit; launches per step and of the
     validation checked exactly; finite loss and grad_norm; every
     parameter moves; the last checkpoint restored into a fresh state
     equal to the live one bit for bit, one more step from each giving the
     same loss; after the weights change and are copied in place, the held
     graph's replay equal to the eager forward; wall ms/step of the loop,
     device ms of a profiled step, idle share, peak memory, the
     checkpoint's save ms and size;
  31. the stage forms, one step each at B=1: things (T=3, 400x720), kitti
     (last pair only, 432x960) and bithings (T=3, the reversed clip folded
     into the batch), launches (derived from the shape), finite loss,
     every parameter moved; phase 8's training guard at T=3;
  32. the ablation configs (ZOO: the per-frame Twins family, the CNN
     encoders 'basic' and 'res18_3d' with their BatchNorm cnet, and on
     Twins_CSC the decoders sk_tam_v1, sk_tam_v3_noinit and use_gma=False),
     each in the default SK layout at 440x1024, B=1, T=4, 12 iterations,
     bf16, seeded random weights: phase 4's forward (exact launches and
     the Twins MLPs' K2 forms, ms/clip, device time, idle share, peak
     memory), phase 5's accuracy guards at 216x512, a GraphedForward
     replay of 'basic' equal to its eager forward bit for bit, and two
     train steps of phase 7's form for 'basic' (bidirectional: two
     applications, the running statistics one update from the reversed
     clip alone), 'twins_temporal_attention' and 'sk_tam_v1';
  33. the two-frame baselines (RAFT_MODELS: 'raft', 'raft_gma', 'skflow';
     models/raft.py), each at full width, bf16, seeded random weights, at
     validate_sintel_2f's shape and depth (436x1024 padded to 440x1024,
     32 iterations, B=1): the eager forward with exact launches
     (raft_launches: K1 32, K3 32 with GMA, K2 384 in skflow), ms/clip,
     device time, idle share, peak memory; GraphedForward2F's flows equal
     to eager bit for bit and its replay's kernel nodes; phase 5's
     accuracy guards at 216x512; two make_train_step_2f steps at
     train_2f's defaults (B=8, 368x496, 12 iterations): exact launches,
     every parameter moved, the BatchNorm statistics one update from the
     batch; then skflow through tools/train_2f.py's loop for 3 steps with
     a checkpoint and an exact resume. Phases 3 and 6 check and time the
     two-frame shapes (K1 on the bf16 C=256 fmaps at 1x55x128 and
     8x46x62, with the f32 body of JAX's f32 cast timed beside; K2's two
     default forms at SKFlow's six SK blocks, its gru 512 wide, and the
     384-wide gru without GMA; K3 and B5 on the two-frame GMA grids);
  34. data-parallel training (streamflow_tpu_torch/parallel/), in
     processes of its own (``chip_smoke.py --dp ...``): (a) a one-rank
     NCCL group: its all-reduce leaves a real step's gradients, loss and
     metric sums bit for bit as they were; phase 7's step as
     ``shard_train_step`` against two plain runs from the same weights,
     3 canonical steps and one 'basic' step (its BatchNorm synced): the
     first forward's metrics and the running statistics bit for bit, the
     rest within the card's own run-to-run spread (B5's atomic sums make
     the backward irreproducible; measured beside), launches as phase
     7's, wall and device ms a step of each, in turns;
     (b) two ranks sharing the card over gloo, f32, 432x960, a global
     batch of 2 at 2 iterations: the canonical, 'basic', bithings (fold),
     'basic' bidirectional and RAFT two-frame steps against one process's
     step on the whole batch, at JAX's tolerances for its sharded step,
     the ranks equal bit for bit after two steps, launches exact on both;
     (c) tools/train.py::train on two ranks over gloo (global batch 2,
     4 steps, a checkpoint and a validation every 2): checkpoints written
     by rank 0 alone, validations and best.npz on rank 0 alone, each rank
     resuming the last checkpoint bit for bit, the ranks' states equal;
  35. StreamFlow with the UMT video-ViT encoder at decoder_dim=768 (the one
     width at which JAX's model runs), served: seeded random weights,
     436x1024 padded to 448x1024 (a multiple of its ratio, 16), B=1, T=4,
     12 iterations, bf16, test mode: the eager forward with exact launches
     (umt_launches: K1 12, K3 20 (8 at d=64, 12 at d=384), K2 240: 2 per SK
     block and iteration, the gru's and the flow head's calls on K2's wide
     path, 2 and 4 launches each), finite flows; GraphedForward's flows
     against the eager ones, a second replay the same, its replay's
     kernel nodes; ms/clip eager and graphed, device time by op group,
     idle share, peak memory; phase 5's accuracy guards at 224x512;
  36. the UMT model trained: phase 7's step (remat, bf16 with f32
     parameters, AdamW + OneCycle + clip 1.0, gamma 0.85) on the UMT
     model at the sintel_kitti shape, 432x960 (a multiple of its ratio,
     16), B=1, T=4, 12 iterations: launches exact (umt_train_launches: K1
     24, K2 480, K3 32 (24 GMA at d=384 with remat's recompute, 8 ViT at
     d=64), B5 40), finite loss and gradient norm, every parameter moved,
     ms/step (mean of 3 after a warm-up), device ms, idle share and
     groups from a card-only profile, peak memory; then phase 8's
     training guard on the UMT model at 128x256, T=4, 2 iterations;
  37. trained dynamics (tools/probe_bf16.py and probe_guard.py cut to
     size): the path's kernels at its shapes (the train step at 192x384,
     the clip at 216x512; B5 too); the canonical StreamFlow (bf16 with f32
     parameters, remat, 'auto') from its own seeded initialisation,
     trained TD_STEPS steps at 192x384 on the probe's synthetic clips
     with its optimizer (launches exactly TD_STEPS x the step's at that
     shape), its bf16 clip at 216x512, 12 iterations (launches exact);
     the weights saved as a flax-layout npz (params.to_jax_variables,
     save_params_npz) and reloaded (load_variables_npz, load_jax): flows
     bit for bit; the f32 kernels on the card, the f32 and bf16 plain
     paths on the CPU; probe_guard's control A (the f32 plain path at the
     clip + 1e-4) at 2 and 12 iterations; the probe's EPE table (mean,
     p99, max px); phase 5's two guards held at 12 iterations where
     control A's relative EPE is below the f32 guard's bound (else
     reported, not judged);
  38. the tools: tools/sweep_e2e.py on 'default' and 'dw=banded_chain' in
     turns at 440x1024 (graphed ms/clip, device ms, idle share),
     tools/trace_e2e.py on the default (device time by op group, every
     kernel of the forward present), the native IO runtime (libsfio,
     g++) on .flo and .ppm files against the NumPy decoder and the bytes
     written, bit for bit, a garbage file refused; tools/bench_input.py
     in a process of its own where PIL is installed.
The line before the kernels line gives ms/clip for the six layouts and
the graphed 'auto'. The line before the last is a JSON object with one
entry per kernel and path ("inference": phases 3-4, per clip;
"train_step": phases 6-7, per step; "inference_dw_<layout>" and
"train_step_dw_<layout>": the same for each other layout, phases 3, 6
and that layout's forward and train step; "inference_<config>" and
"train_step_<config>": the same for each ZOO config, phases 3, 6 and
32, a bidirectional BatchNorm step's numbers for its two applications;
"inference_<model>" and "train_step_<model>": the same for each
two-frame model, phases 3, 6 and 33, per 440x1024 pair of 32
iterations and per B=8 step; "inference_umt": phases 3 and 35, per
448x1024 clip of the UMT model; "train_step_umt": phases 6 and 36, per
432x960 step of it; "trained_dynamics": phase 37's counted run (its
TD_STEPS training steps at 192x384 and the trained weights' bf16 clip at
216x512), with phase 37's kernel numbers per step times TD_STEPS plus
per clip;
"train_step_dp": phase 34 (a)'s
launches per step, with phase 6's numbers per step; "trainer_dp": phase
34 (c)'s rank 0 launches over its 4 steps, with phase 6's numbers times
4; "serving": phase 28's
launches, with phase 3's numbers per 440x1024 clip; "trainer": the
launches of phase 30's 6 steps, with phase 30's B=8 kernel numbers
summed over the same 6 steps, and its validation's launches apart under
"launches_validation"): "launches" is the
path's count, "ms", "plain_ms", "bound_ms" and "library_ms" are summed
over the same calls at the path's shapes (K1's under the jitter
traffic; its "ms_by_traffic" gives all three). The last line is {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

B, T, H, W = 1, 4, 436, 1024
ITERS = 12
SEED = 0
REPS = 5  # timed repetitions, after warm-up

# Tolerances of the kernel-vs-plain checks, elementwise.
# f32: |kernel - plain| <= 1e-4 + 1e-4 |plain|. Both sides accumulate in
# f32 in different orders (reductions of up to 1024 terms, O(1) values): a
# few 1e-6 relative (at most 2.4e-6 read on an H100); 1e-4 leaves margin.
# bf16: |kernel - plain| <= 2 ulp(plain) + 2^-9 max|plain|, ulp() the bf16
# spacing at that value. Both sides round to bf16 at the same points, so an
# output differs only where the two f32 sums straddle a rounding boundary:
# one ulp of that element (every bf16 reading on an H100 so far is at most
# one ulp of the output's largest magnitude). The 2^-9 max|plain| term
# covers a flipped intermediate reaching an output near zero. A wrong tile,
# mask or rounding point is many ulps.
F32_TOL = 1e-4
BF16_ULPS, BF16_FLOOR = 2, 2.0 ** -9

# Accuracy guards (phase 5), on the global relative EPE (max EPE /
# max(1, max |flow_ref|), as bench.py) and the per-pixel p99 of EPE /
# max(1, |flow_ref|); the reference is the f32 plain path on the CPU.
# f32 kernels on the card: both paths run the same math and differ only by
# summation order (1.6e-5 read on an H100); a wrong window, channel order
# or mask is O(1). Bound 1e-2 outright.
# bf16 kernels on the card: bf16 rounding alone moves these random-weight
# flows by up to ~9% (the bf16 plain path on the CPU reads 9.4e-2 global
# against f32 on an H100's host, and differs from the kernel path by as
# much), so bf16 is held to the plain bf16 path: its error against the
# f32 reference may exceed the plain path's by at most 1.5x. A kernel
# fault adds its own O(1) error on top.
F32_GUARD_TOL = 1e-2
BF16_GUARD_RATIO = 1.5

KERNELS = {
    "corr_lookup": ("streamflow_tpu_torch/csrc/corr_lookup.cu",
                    "streamflow_tpu/ops/pallas/_fused_lookup_kernel.py:325"),
    "ffn_pair": ("streamflow_tpu_torch/csrc/ffn_pair.cu",
                 "streamflow_tpu/ops/pallas/_ffn_kernel.py:304"),
    "flash_attention": ("streamflow_tpu_torch/csrc/flash_attn.cu",
                        "streamflow_tpu/ops/pallas/_attention_kernel.py:176"),
    "flash_attention_bwd": (
        "streamflow_tpu_torch/csrc/flash_attn_bwd.cu",
        "streamflow_tpu/ops/pallas/_attention_kernel.py:327"),
    "lga_attention": ("streamflow_tpu_torch/csrc/lga_attn.cu",
                      "streamflow_tpu/ops/pallas/_lga_kernel.py:116"),
    "dw_chain": ("streamflow_tpu_torch/csrc/dw_chain.cu",
                 "streamflow_tpu/ops/pallas/_dw_conv_kernel.py:170"),
    "dw_banded_mxu": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                      "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:122"),
    "dw_banded_mxu_t": ("streamflow_tpu_torch/csrc/dw_banded_t.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:223"),
    "sk_chain_banded": ("streamflow_tpu_torch/csrc/dw_banded.cu",
                        "streamflow_tpu/ops/pallas/_banded_dw_kernel.py:343"),
}
# the Twins GSA blocks run K3 above this many tokens an image
# (layers/twins.py)
GSA_FLASH_TOKENS = 16384


def gsa_flash_blocks(t: int, h: int, w: int) -> int:
    """GSA blocks that run K3 on a T=t clip of padded size h x w: fnet on t
    frames and cnet on t - 1, each stacked along H, at stage 0 (1/4 of the
    size) and stage 1 (1/8): all 4 at 440x1024 and 432x960 with T=4, the
    two of stage 0 at 400x720 with T=3."""
    return sum(tt * (h // s) * (w // s) > GSA_FLASH_TOKENS
               for s in (4, 8) for tt in (t, t - 1))


def forward_launches(iters: int = ITERS, t: int = T, h: int = 440,
                     w: int = 1024) -> dict:
    """Launches of each kernel in one forward: K1 once per iteration; K2 2
    per SK block (6 blocks) per iteration + 8 Twins MLPs; K3 once per
    iteration (GMA) + once per GSA block above GSA_FLASH_TOKENS; K4 2 LGA
    blocks in each of fnet and cnet."""
    return dict(dict.fromkeys(KERNELS, 0), corr_lookup=iters,
                ffn_pair=12 * iters + 8,
                flash_attention=iters + gsa_flash_blocks(t, h, w),
                lga_attention=4)


def train_launches(t: int = T, h: int = 432, w: int = 960,
                   iters: int = ITERS) -> dict:
    """Launches in one train step with remat: the refinement kernels run in
    the forward and again in each step's recompute (K1 2x12, K2 2x144 + the
    8 of the encoders, K3 2x12 GMA + the GSA calls), K4 once; B5's two
    kernels (dq pass, dk/dv pass) once per K3 forward that the loss
    reaches (12 GMA + the GSA calls). The batch size changes none."""
    gsa = gsa_flash_blocks(t, h, w)
    return dict(forward_launches(iters, t, h, w), corr_lookup=2 * iters,
                ffn_pair=2 * 12 * iters + 8,
                flash_attention=2 * iters + gsa,
                flash_attention_bwd=2 * (iters + gsa))


EXPECTED_LAUNCHES = forward_launches()
EXPECTED_TRAIN_LAUNCHES = train_launches()


def pair_layout(suffix, dw_kernel=None):
    """A pair layout: each SK block runs K2 twice (ffn_pair, pw_ffn_pair)
    in place of the default's two K2 forms, and its dw stack through
    ``dw_kernel`` once (the kxk stage; k=1 stages and gelus are elementwise
    or inside it), or through no kernel ('banded', the XLA composite)."""
    dw = {dw_kernel: 6} if dw_kernel else {}
    return (suffix,
            dict(EXPECTED_LAUNCHES, **{k: n * ITERS for k, n in dw.items()}),
            dict(EXPECTED_TRAIN_LAUNCHES,
                 **{k: 2 * n * ITERS for k, n in dw.items()}))


# per SK layout (the port's dw_impl): the suffix of its paths in the
# kernels line and the profile files, its launches per clip and per step
LAYOUTS = {"auto": ("", EXPECTED_LAUNCHES, EXPECTED_TRAIN_LAUNCHES),
           "pallas": pair_layout("_dw_pallas", "dw_chain"),
           "banded_mxu": pair_layout("_dw_banded_mxu", "dw_banded_mxu"),
           "banded_chain": pair_layout("_dw_banded_chain", "sk_chain_banded"),
           "banded_mxu_t": pair_layout("_dw_banded_mxu_t", "dw_banded_mxu_t"),
           "banded": pair_layout("_dw_banded")}
# the layouts whose train step and training guard run (phases 7-8, 11-12,
# 15-16, 19-20, 23-24); the other runs its forward and accuracy guards
TRAINED = ("auto", "pallas", "banded_mxu", "banded_chain", "banded_mxu_t")

# phase 32: the ablation configs (StreamFlowConfig fields beside the
# canonical ones), each in the default SK layout; their paths in the
# kernels line are "inference_<name>" and, for ZOO_TRAINED,
# "train_step_<name>"
ZOO = {"twins": dict(encoder="twins"),
       "twins_1dconv": dict(encoder="twins_1dconv"),
       "twins_temporal_attention": dict(encoder="twins_temporal_attention"),
       "twins_3dconv": dict(encoder="twins_3dconv"),
       "basic": dict(encoder="basic"),
       "res18_3d": dict(encoder="res18_3d"),
       "sk_tam_v1": dict(update_block="sk_tam_v1"),
       "sk_tam_v3_noinit": dict(update_block="sk_tam_v3_noinit"),
       "no_gma": dict(use_gma=False)}
# the trained ones (two steps each, phase 7's form), with the model
# applications a step makes: 'basic' steps bidirectionally, and its
# BatchNorm makes that two applications, one per direction
ZOO_TRAINED = {"basic": 2, "twins_temporal_attention": 1, "sk_tam_v1": 1}
# phase 32's numbers per config (ms/clip, device ms, idle share, peak GiB
# above what the process held before the config's model was built)
ZOO_TABLE = {}
# phase 32's accuracy guards run at this size (the f32 and bf16 plain
# paths on the CPU for each of nine functions at 440x1024 would take
# ~4 minutes)
ZOO_GUARD_H, ZOO_GUARD_W = 216, 512
# and so do the other SK layouts' (phases 10, 14, 18, 22, 26): the bf16
# plain path on the CPU takes 12.3 s at 436x1024, 1.3 s at 216x512 (an
# H100 machine's host), which makes room for phases 37 and 38
LAYOUT_GUARD_H, LAYOUT_GUARD_W = ZOO_GUARD_H, ZOO_GUARD_W


def zoo_kind(name: str) -> dict:
    """What of the path a config runs: a Twins encoder (``frame``: the
    per-frame family, ``csc``: the canonical token grid, ``hook``) or a
    CNN, GMA, the per-frame flow head (``v1``)."""
    from streamflow_tpu_torch.config import TWINS_ENCODERS

    kw = ZOO[name]
    grid, hook, _ = TWINS_ENCODERS.get(kw.get("encoder", "twins_csc"),
                                       (False, "none", False))
    twins = kw.get("encoder", "twins_csc") in TWINS_ENCODERS
    return dict(twins=twins, csc=twins and grid, frame=twins and not grid,
                hook=hook, gma=kw.get("use_gma", True),
                v1=kw.get("update_block") == "sk_tam_v1")


def zoo_launches(name: str, train: bool = False, t: int = T, h: int = 440,
                 w: int = 1024, iters: int = ITERS, apps=None) -> dict:
    """Launches of each kernel in one forward (or train step) of a ZOO
    config: as forward_launches / train_launches, with K3's GMA calls only
    under GMA, its GSA calls where a Twins encoder's GSA block has more
    than GSA_FLASH_TOKENS an image (the canonical grid stacks the frames;
    the per-frame family runs B*T images of one frame each: stage 0 only
    at 440x1024 and 432x960), K4 and the 8 K2 MLPs in the Twins encoders
    only; a bidirectional BatchNorm step makes every launch twice
    (``apps``: the step's model applications, ZOO_TRAINED's by
    default)."""
    k = zoo_kind(name)
    if k["csc"]:
        gsa = gsa_flash_blocks(t, h, w)
    elif k["frame"]:
        gsa = sum((h // s) * (w // s) > GSA_FLASH_TOKENS
                  for s in (4, 8) for _ in ("fnet", "cnet"))
    else:
        gsa = 0
    gma = iters if k["gma"] else 0
    enc, lga = (8, 4) if k["twins"] else (0, 0)
    base = dict.fromkeys(KERNELS, 0)
    if not train:
        return dict(base, corr_lookup=iters, ffn_pair=12 * iters + enc,
                    flash_attention=gma + gsa, lga_attention=lga)
    one = dict(base, corr_lookup=2 * iters, ffn_pair=2 * 12 * iters + enc,
               flash_attention=2 * gma + gsa,
               flash_attention_bwd=2 * (gma + gsa), lga_attention=lga)
    apps = ZOO_TRAINED[name] if apps is None else apps
    return {kk: apps * v for kk, v in one.items()}

# phase 33: the two-frame baselines (models/raft.py), each at full width,
# bf16, seeded random weights, in inference at validate_sintel_2f's shape
# and depth (436x1024 padded to 440x1024, 32 iterations, B=1) and in
# train steps at tools/train_2f.py's defaults (B=8, 368x496, 12
# iterations, no remat); their paths in the kernels line are
# "inference_<name>" and "train_step_<name>"
RAFT_MODELS = ("raft", "raft_gma", "skflow")
RAFT_ITERS = 32
RAFT_TRAIN_B, RAFT_TRAIN_H, RAFT_TRAIN_W, RAFT_TRAIN_ITERS = 8, 368, 496, 12
# tools/train_2f.py's lr, weight decay and gamma
RAFT_LR, RAFT_WD, RAFT_GAMMA = 4e-4, 1e-4, 0.8
RAFT_TRAINER_STEPS, RAFT_TRAINER_CKPT = 3, 2
RAFT_TRAINER_DIR = os.path.join(ROOT, "build", "chip_smoke_trainer_2f")
# phase 33's numbers per model (ms/clip eager and graphed, device ms,
# idle share, peak GiB; ms/step and device ms/step)
RAFT_TABLE = {}


def raft_launches(name: str, train: bool = False, iters=None) -> dict:
    """Launches of each kernel in one forward (RAFT_ITERS iterations) or
    one train step (RAFT_TRAIN_ITERS, no remat) of a two-frame model: K1
    once per iteration in every model; K3 once per iteration (the GMA
    aggregate) in raft_gma and skflow; K2 twice (ffn_pair_k1,
    dwres_pw_ffn_pair) per SK block per iteration in skflow (6 blocks:
    convc1, convc2, convf2, conv, gru, flow_head); in a step B5's two
    kernels per K3 call. The batch size changes none (``iters``: another
    depth)."""
    if iters is None:
        iters = RAFT_TRAIN_ITERS if train else RAFT_ITERS
    gma = 0 if name == "raft" else iters
    out = dict(dict.fromkeys(KERNELS, 0), corr_lookup=iters,
               flash_attention=gma,
               ffn_pair=12 * iters if name == "skflow" else 0)
    if train:
        out["flash_attention_bwd"] = 2 * gma
    return out


# phase 35: StreamFlow with the UMT video-ViT encoder at decoder_dim=768
# (the one width at which JAX's model runs), served: 436x1024 padded to a
# multiple of 16 (its ratio), 448x1024, a 28x64 grid; its path in the
# kernels line is "inference_umt"; phase 36 trains it at 432x960 (a 27x60
# grid; B5 at d=64 and d=384), path "train_step_umt"
UMT_KW = dict(encoder="umt", decoder_dim=768)
UMT_DEPTH = 4                      # ViT blocks in each of fnet and cnet
UMT_H, UMT_W = 448, 1024
UMT_GUARD_H, UMT_GUARD_W = 224, 512
# its six SK blocks (c_in, out_dim): the motion encoder's canonical widths
# (its last block 382 wide, the 384-wide hidden state less the flow), the
# 1920-wide gru and the 1152-wide joint flow head
UMT_SK = [(324, 256), (256, 192), (128, 64), (256, 382), (1920, 384),
          (1152, 6)]


def umt_launches(iters: int = ITERS) -> dict:
    """Launches of each kernel in one UMT forward: K1 once per iteration;
    K3 once per ViT block in fnet and cnet (d=64) and once per iteration
    (GMA, d=384); K2 twice per SK block per iteration (ffn_pair_k1,
    dwres_pw_ffn_pair), each call one launch where the fused plan holds its
    widths and one per stage on the wide path (the gru's and the flow
    head's: 2 and 4, ops/kernels/ffn_pair.py::wide_launches)."""
    from streamflow_tpu_torch.ops.kernels.ffn_pair import wide_launches

    k2 = sum(wide_launches(c, int(1.5 * c), c, False, False)
             + wide_launches(c, int(1.5 * c), co, True, True)
             for c, co in UMT_SK)
    return dict(dict.fromkeys(KERNELS, 0), corr_lookup=iters,
                ffn_pair=iters * k2,
                flash_attention=iters + 2 * UMT_DEPTH)


def umt_train_launches(iters: int = ITERS) -> dict:
    """Launches in one UMT train step with remat (phase 36): the refinement
    kernels (K1, K2 with its wide path's launches, K3 at d=384 in GMA) run
    in the forward and again in each step's recompute, the ViT blocks' K3
    (d=64) once each (remat never recomputes the encoders); B5's two
    kernels once per K3 forward that the loss reaches (12 GMA + 8 ViT).
    The batch size changes none."""
    one = umt_launches(iters)
    vit = 2 * UMT_DEPTH
    return dict(one, corr_lookup=2 * iters, ffn_pair=2 * one["ffn_pair"],
                flash_attention=2 * iters + vit,
                flash_attention_bwd=2 * (iters + vit))


# phase 37: trained dynamics (tools/probe_bf16.py cut to size): the
# canonical StreamFlow trained TD_STEPS steps at TD_H x TD_W (the probe's
# 400 at 288x512), evaluated on one TD_EVAL_H x TD_EVAL_W clip (the
# probe's 436x1024) at 12 iterations; its weights go through TD_DIR; its
# path in the kernels line is "trained_dynamics"
TD_STEPS = 100
TD_H, TD_W = 192, 384
TD_EVAL_H, TD_EVAL_W = 216, 512
TD_DIR = os.path.join(ROOT, "build", "chip_smoke_probe")
# phase 38: the sweep's specs (440x1024, in turns) and bench_input's short
# instance (stage 2's crops and batch)
SWEEP_SPECS = ("default", "dw=banded_chain")
BENCH_INPUT_ARGS = ("--workers", "4", "8")

# the training shapes (tools/train.py's sintel_kitti stage)
TRAIN_H, TRAIN_W = 432, 960
TRAIN_STEPS = 3          # timed, after one warm-up step
GUARD_H, GUARD_W, GUARD_ITERS = 128, 256, 2
# phase 8, f32: relative L2 error of each gradient <= GRAD_TOL +
# PERTURB_SLACK x its change under a 1e-6 relative weight perturbation, and
# of all gradients together <= GRAD_GLOBAL_TOL (read on an H100: 1.966e-7
# for the kernel path, 3.835e-6 for the perturbation; a kernel fault in a
# leaf of 1% of the gradient norm moves it by 1e-2 x that leaf's error)
GRAD_TOL, PERTURB_SLACK, GRAD_GLOBAL_TOL = 1e-3, 4.0, 1e-5

# K5-K8 beyond the main path's calls (phase 3, checked only; nb, h, w, c,
# ks; K6 and K7 take the kxk stage ks[-1] alone, K5 the even widths):
# every odd k, no k=1 stage and two, widths that take each copy width of
# the bf16 bodies (csrc/sk_chain.cuh; C % 8 == 0: 16-byte copies, K7's
# TMA; 324 and 36: 8-byte; 34: 4-byte; 35: 2-byte), H and W that fit no
# 32 x 32 tile, B = 1 and 3, images smaller than the halo, a grid smaller
# than the card; for K7's strips (csrc/dw_banded_t.cu: 16 channels, 56
# rows, runs of 16-column tiles), a row of tiles that ends in a part of
# one (200 columns), a strip of thirteen tiles that carries its halo to
# the last, a part one (3x54x200x640), and three bands (130 rows)
CHAIN_EDGES = [(3, 55, 128, 64, (1, k)) for k in (3, 5, 7, 9, 11, 13)] + [
    (3, 55, 128, 324, (15,)), (1, 55, 128, 384, (1, 1, 15)),
    (3, 54, 120, 640, (1, 1, 7)), (2, 54, 120, 36, (1, 15)),
    (1, 55, 128, 35, (1, 1, 9)), (1, 9, 40, 34, (1, 3)),
    (3, 7, 9, 40, (1, 15)), (1, 3, 5, 16, (11,)), (2, 1, 1, 24, (1, 5)),
    (1, 55, 200, 64, (15,)), (3, 54, 200, 640, (7,)),
    (1, 130, 70, 40, (1, 11))]


def chain_inputs(rnd, nb, h, w, c, ks, dt):
    """Seeded inputs of a K5, K6 or K8 call: x, the stages' weights and
    biases (the k=1 biases large enough that a halo of gelu(b) instead of
    0 shows)."""
    x = rnd(nb, h, w, c, dt=dt)
    ws = tuple(rnd(c, 1, k, k, scale=0.3 if k == 1 else 1 / k, dt=dt)
               for k in ks)
    bs = tuple(rnd(c, scale=0.5 if k == 1 else 0.1, dt=dt) for k in ks)
    return x, ws, bs


# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of FLOPs / peak rate of its io type and bytes / memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    """Print a line, and keep it in OUT_DIR/chip_smoke.log (the whole
    run's lines; a runner may return only the end of the output)."""
    print(msg, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as fh:
        fh.write(msg + "\n")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, dt) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[str(dt)[6:]]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_mem),
            "operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def init_weights(model, seed: int) -> None:
    """Fan-in-scaled random weights from ``seed``, the flow head's output
    layer scaled down (streamflow_tpu_torch/tools/common.py)."""
    from streamflow_tpu_torch.tools.common import init_weights as init

    init(model, seed)


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


# ---------------------------------------------------------------- phase 3
def check_close(label, got, want, dt) -> float:
    """Elementwise check of a kernel output against its plain version
    (F32_TOL / the bf16 ulp rule); returns the max abs error."""
    import torch

    assert got.shape == want.shape and got.dtype == want.dtype, (
        label, got.shape, want.shape, got.dtype, want.dtype)
    want_abs = want.float().abs()
    top = float(want_abs.max())
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if dt == torch.float32:
        bound = F32_TOL + F32_TOL * want_abs
        rule = f"atol = rtol = {F32_TOL}"
    else:
        bound = BF16_ULPS * bf16_ulp(want_abs) + BF16_FLOOR * top
        rule = (f"{BF16_ULPS} ulp + 2^-9 max|plain|; err = "
                f"{err / float(bf16_ulp(torch.tensor(top))):.3g} ulp of "
                f"max|plain|")
    ok = bool((diff <= bound).all()) and math.isfinite(err)
    line = (f"check {label} {str(dt)[6:]}: max_abs_err {err:.3e} "
            f"max_rel_err {err / max(top, 1e-30):.3e} ({rule}; |plain| max "
            f"{top:.3e})")
    log(line)
    if not ok:
        raise AssertionError(f"{label} {dt} disagrees with its plain "
                             f"version: {line}")
    return err


def new_summary():
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "ops_ms": 0.0, "mem_ms": 0.0, "library_ms": None}
            for k in KERNELS}


def scaled_summary(summary, n):
    """A copy of a path's kernel numbers (``new_summary``'s), the times
    times ``n``: the same calls made ``n`` times."""
    out = {}
    for name, s in summary.items():
        s = dict(s)
        for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "mem_ms"):
            s[k] *= n
        if s["library_ms"] is not None:
            s["library_ms"] *= n
        if "ms_by_traffic" in s:
            s["ms_by_traffic"] = {k: v * n for k, v in
                                  s["ms_by_traffic"].items()}
        out[name] = s
    return out


def add_timing(s, calls, ms, pms, flops, nbytes_, dt, lib_ms=None):
    """Add one case's per-call numbers, times its calls, to summary s."""
    b, _ = bound_ms(flops, nbytes_, dt)
    s["ms"] += calls * ms
    s["plain_ms"] += calls * pms
    s["bound_ms"] += calls * b
    s["ops_ms"] += calls * 1e3 * flops / PEAK_FLOPS[str(dt)[6:]]
    s["mem_ms"] += calls * 1e3 * nbytes_ / HBM_BYTES_PER_S
    if lib_ms is not None:
        s["library_ms"] = (s["library_ms"] or 0.0) + calls * lib_ms
    return b


def kernel_checks(dev, summaries, hp, wp, train, batch=1, tails=True):
    """Every forward kernel against its plain version at the shapes of
    ``batch`` hp x wp clips (padded size, T frames), in f32 and bf16;
    per-kernel bf16 numbers summed into ``summaries[layout]`` (per SK
    layout among the keys of LAYOUTS; cases of no layout in
    ``summaries`` are left out) over the calls of one inference clip, or
    of one train step (``train``: the refinement kernels run twice,
    forward and remat's recompute, and K3 also returns its logsumexp).
    The tails of the kernels' tiles (cases of no calls) and the K6/K7
    identity are checked at batch=1 only: they do not depend on the
    batch; ``tails=False`` leaves out every case of no calls (a path at
    other shapes, whose tails an earlier call checked)."""
    import torch
    import torch.nn.functional as F

    from streamflow_tpu_torch.ops.corr import pool_pyramid
    from streamflow_tpu_torch.ops.coords import coords_grid
    from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
    from streamflow_tpu_torch.ops.kernels import dw_banded as K6
    from streamflow_tpu_torch.ops.kernels import dw_chain as K5
    from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3
    from streamflow_tpu_torch.ops.kernels import lga_attention as K4
    from streamflow_tpu_torch.tools import kernel_bench as KB

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    # each make(dt) -> (kernel fn, plain fn, FLOPs, inputs, library fn,
    # None or (what, fn) timed beside it as a yardstick: the default
    # layout's cuDNN conv beside K5 and K8, K2's library composite)
    def ffn_case(variant, rows, c, ch, co):
        def make(dt):
            run, plain, flops, args, _, _ = make_k2(dt)
            if variant == "ffn_pair_nores":    # the 1D-conv Twins MLP
                return (run, plain, flops, args, None,
                        ("the library composite (bf16 torch ops, the hidden "
                         "activation through device memory)",
                         lambda: F.linear(F.gelu(F.linear(
                             args[0], args[1], args[2])), args[3], args[4])))
            names = {"ffn_pair": "x w1 b1 w2 b2",
                     "pw_ffn_pair": "x wp bp w1 b1 w2 b2",
                     "ffn_pair_k1": "x w1 b1 w2 b2 kw kb",
                     "dwres_pw_ffn_pair": "x yres db wp bp w1 b1 w2 b2",
                     "ln_ffn_pair": "x ln_g ln_b w1 b1 w2 b2"}[variant]
            a = dict(zip(names.split(), args))
            return (run, plain, flops, args, None,
                    ("the library composite (bf16 torch ops, the hidden "
                     "activation through device memory)",
                     lambda: KB.ffn_composite(variant, a)))

        def make_k2(dt):
            w = lambda i, o: rnd(o, i, scale=i ** -0.5, dt=dt)  # noqa: E731
            b = lambda n: rnd(n, scale=0.1, dt=dt)  # noqa: E731
            x = rnd(rows, c, dt=dt)
            flops = 2 * rows * (c * ch + ch * co)
            if variant in ("ffn_pair", "ffn_pair_nores"):
                res = variant == "ffn_pair"
                args = (x, w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.ffn_pair(*args, residual=res),
                        lambda: K2.ffn_pair_plain(*args, res),
                        flops, args, None, None)
            if variant == "pw_ffn_pair":
                args = (x, w(c, c), b(c), w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.pw_ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(x, *args[3:], False,
                                                  wp=args[1], bp=args[2]),
                        flops + 2 * rows * c * c, args, None, None)
            if variant == "ffn_pair_k1":
                args = (x, w(c, ch), b(ch), w(ch, co), b(co),
                        rnd(co, scale=0.3, dt=dt), b(co))
                return (lambda: K2.ffn_pair_k1(*args),
                        lambda: K2.ffn_pair_plain(*args[:5], True,
                                                  kw=args[5], kb=args[6]),
                        flops, args, None, None)
            if variant == "dwres_pw_ffn_pair":
                args = (x, rnd(rows, c, dt=dt), b(c), w(c, c), b(c),
                        w(c, ch), b(ch), w(ch, co), b(co))
                return (lambda: K2.dwres_pw_ffn_pair(*args),
                        lambda: K2.ffn_pair_plain(
                            x, *args[5:], False, wp=args[3], bp=args[4],
                            yres=args[1], db=args[2]),
                        flops + 2 * rows * c * c, args, None, None)
            args = (x, 1.0 + rnd(c, scale=0.1, dt=dt), b(c), w(c, ch),
                    b(ch), w(ch, co), b(co))
            return (lambda: K2.ln_ffn_pair(*args),
                    lambda: K2.ffn_pair_plain(x, *args[3:], False,
                                              ln=args[1:3], add_res=True),
                    flops, args, None, None)
        return make

    def dw_case(kind, nimg, c, k):
        """The SK block's dw stack (1, k) of one (nimg, h8, w8, c) tensor:
        K5 or K8 (the whole stack; cuDNN's conv of the default layout
        timed beside it), K6 or K7 (the kxk stage; the library yardstick
        is cuDNN's bf16 depthwise conv + bias, one call on the same
        tensor). The work counted is the conv's, 2 k^2 N C FLOP, and K8's
        k=1 stage, 3 N C."""
        def make(dt):
            x = rnd(nimg, h8, w8, c, dt=dt)
            ws = (rnd(c, 1, 1, 1, scale=0.3, dt=dt),
                  rnd(c, 1, k, k, scale=1 / k, dt=dt))
            bs = (rnd(c, scale=0.1, dt=dt), rnd(c, scale=0.1, dt=dt))
            flops = 2 * k * k * x.numel()

            def conv():
                # the default layout's conv of the same tensor, copies
                # included (layers/sk.py)
                y = x.permute(0, 3, 1, 2)
                y = y.contiguous() if k > 7 else y
                y = F.conv2d(y, ws[1], None, 1, k // 2, 1, c)
                return y.permute(0, 2, 3, 1).contiguous()
            cudnn = ("the default layout's cuDNN conv of the same tensor",
                     conv)
            if kind in ("dw_chain", "sk_chain_banded"):
                mod = K5 if kind == "dw_chain" else K6
                run, plain = getattr(mod, kind), getattr(mod, kind + "_plain")
                return (lambda: run(x, ws, bs, (1, k)),
                        lambda: plain(x, ws, bs, (1, k)),
                        flops + 3 * (kind != "dw_chain") * x.numel(),
                        (x, *ws, *bs), None, cudnn)
            run, plain = getattr(K6, kind), getattr(K6, kind + "_plain")
            return (lambda: run(x, ws[1], bs[1]),
                    lambda: plain(x, ws[1], bs[1]), flops,
                    (x, ws[1], bs[1]),
                    lambda: F.conv2d(x.permute(0, 3, 1, 2), ws[1], bs[1], 1,
                                     k // 2, 1, c), None)
        return make

    def edge_case(kind, nb, h, w, c, ks):
        """K5, K6 or K7 (ks = (k,)) or K8 at an edge of its tiles or
        arguments (checked only)."""
        mod = K5 if kind == "dw_chain" else K6
        run, plain = getattr(mod, kind), getattr(mod, kind + "_plain")

        def make(dt):
            x, ws, bs = chain_inputs(rnd, nb, h, w, c, ks, dt)
            args = (x, ws[0], bs[0]) if kind.startswith("dw_banded") else (
                x, ws, bs, ks)
            return (lambda: run(*args), lambda: plain(*args), 0,
                    (x, *ws, *bs), None, None)
        return make

    def flash_case(bh_shape, n, m, d):
        def make(dt):
            q = rnd(*bh_shape, n, d, scale=d ** -0.5, dt=dt)
            k, v = rnd(*bh_shape, m, d, dt=dt), rnd(*bh_shape, m, d, dt=dt)
            bh = math.prod(bh_shape)
            return (lambda: K3.flash_attention_fwd(q, k, v, return_lse=train),
                    lambda: K3.flash_attention_plain(q, k, v,
                                                     return_lse=train),
                    4 * bh * n * m * d, (q, k, v),
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           scale=1.0), None)
        return make

    def lga_case(hp, wp, c, nh, b=1):
        def make(dt):
            qkv = rnd(b, hp, wp, 3 * c, dt=dt)
            hd, ws = c // nh, 7
            windows = b * (hp // ws) * (wp // ws)
            # the yardstick: SDPA on the window-partitioned q, k, v
            parts = qkv.reshape(b, hp // ws, ws, wp // ws, ws, 3, nh, hd)
            parts = parts.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(
                3, windows, nh, ws * ws, hd).contiguous()
            return (lambda: K4.lga_attention(qkv, ws, nh),
                    lambda: K4.lga_attention_plain(qkv, ws, nh),
                    4 * windows * nh * (ws * ws) ** 2 * hd, (qkv,),
                    lambda: F.scaled_dot_product_attention(
                        parts[0], parts[1], parts[2], scale=hd ** -0.5),
                    None)
        return make

    def corr_case():
        def make(dt):
            bf, h, w, c, r = 3 * batch, h8, w8, 256, 4
            f1 = rnd(bf, h, w, c, dt=dt)
            levels = [lv.contiguous() for lv in
                      pool_pyramid(rnd(bf, h, w, c, dt=dt), 4)]
            coords = coords_grid(bf, h, w, dev) + 30.0 * (
                2 * torch.rand(bf, h, w, 2, generator=g, device=dev) - 1)
            coords[0, :4] = torch.tensor([1e4, -1e4], device=dev)  # far out
            coords[1, :2] = torch.tensor([-20.0, 70.0], device=dev)
            coords = coords.contiguous()
            shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
            return (lambda: K1.corr_lookup(f1, levels, coords, r),
                    lambda: K1.corr_lookup_plain(f1, levels, coords, r),
                    KB.corr_flops(coords, shapes, c, r),
                    (f1, *levels, coords), None, None)
        return make

    def corr_traffic_case(traffic, b, h, w, c, nl, r, patch=None):
        """K1 under one of kernel_bench's traffics; ``patch(coords)`` edits
        the coordinates in place (far-out tiles, mixed tiles)."""
        def make(dt):
            f1 = rnd(b, h, w, c, dt=dt)
            levels = [lv.contiguous() for lv in
                      pool_pyramid(rnd(b, h, w, c, dt=dt), nl)]
            coords = KB.corr_coords(traffic, b, h, w, g, dev)
            if patch is not None:
                patch(coords)
            shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
            return (lambda: K1.corr_lookup(f1, levels, coords, r),
                    lambda: K1.corr_lookup_plain(f1, levels, coords, r),
                    KB.corr_flops(coords, shapes, c, r),
                    (f1, *levels, coords), None, None)
        return make

    def mixed_tiles(coords):
        """Pair 0: whole 8x8 tiles far out (empty boxes at every level);
        pair 1: tiles whose first rows are far out; pair 2: rows 20 on
        uniform over the frame (boxes wider than one 128-column plane)."""
        coords[0, :16, :24] = torch.tensor([1e4, 1e4], device=dev)
        coords[1, :4] = torch.tensor([-1e4, 1e4], device=dev)
        h, w = coords.shape[1:3]
        coords[2, 20:] = KB.corr_coords("uniform", 1, h, w, g, dev)[0, 20:]

    def corr_2f_case(nb, h, w):
        """K1 on a two-frame model's pyramid, C=256, under the jitter
        traffic: the port feeds K1's bf16 body the bf16 fmaps; JAX's path
        casts them to f32 (models/raft.py:87), which would run K1's f32
        body, timed beside it on the same values."""
        inner = corr_traffic_case("jitter30", nb, h, w, 256, 4, 4)

        def make(dt):
            run, plain, flops, args, lib, _ = inner(dt)
            f32 = [t.float() for t in args[:-1]]
            return (run, plain, flops, args, lib,
                    ("K1's f32 body on the fmaps cast to f32 (JAX's path)",
                     lambda: K1.corr_lookup(f32[0], f32[1:], args[-1], 4)))
        return make

    # token grids at 1/8 and 1/4 of the padded clip; the refinement kernels
    # (SK pairs, GMA, K1) run on batch*(T-1) frame pairs, the flow head's
    # pair on batch grids with the pairs in their channels; the Twins
    # encoders (fnet on T frames, cnet on T-1, stacked along H, of each
    # clip) at 1/4 (stage 0) and 1/8 (stage 1)
    h8, w8 = hp // 8, wp // 8
    h4, w4 = 2 * h8, 2 * w8
    path = ("train step" if train else "clip") + (
        f" of B={batch}" if batch > 1 else "")
    refine = 2 * ITERS if train else ITERS
    # the six SK blocks (c_in, out_dim, images, dw k): convc1, convc2,
    # convf2, conv, gru, flow_head; cases tagged with the SK layouts whose
    # path runs them (LAYOUTS' keys: the default "auto" and the pair
    # layouts, each with its own dw kernel, none for "banded")
    sk = [(324, 256, 3 * batch, 15), (256, 192, 3 * batch, 15),
          (128, 64, 3 * batch, 15), (256, 126, 3 * batch, 15),
          (640, 128, 3 * batch, 7), (384, 6, batch, 15)]
    every, auto = tuple(LAYOUTS), ("auto",)
    pair = tuple(lt for lt in LAYOUTS if lt != "auto")
    # the ZOO configs among the paths (each in the default layout), by
    # what of the path they run
    zoo = [z for z in summaries if z in ZOO]

    def zoo_with(**want):
        return tuple(z for z in zoo
                     if all(zoo_kind(z)[k] == v for k, v in want.items()))
    zoo_all = tuple(zoo)
    dw_kernels = (("dw_chain", "pallas"), ("dw_banded_mxu", "banded_mxu"),
                  ("dw_banded_mxu_t", "banded_mxu_t"),
                  ("sk_chain_banded", "banded_chain"))
    cases = []  # (kernel, label, make, calls per clip or step, layouts)
    for i, (c, co, pairs, k) in enumerate(sk):
        ch, rows = int(1.5 * c), pairs * h8 * w8
        # the joint flow head (the last block) is not TAM v1's
        zoo_sk = zoo_with(v1=False) if i == len(sk) - 1 else zoo_all
        cases.append(("ffn_pair", f"ffn_pair_k1 {rows}x{c}-{ch}-{c}",
                      ffn_case("ffn_pair_k1", rows, c, ch, c), refine,
                      auto + zoo_sk))
        cases.append(("ffn_pair", f"dwres_pw_ffn_pair {rows}x{c}-{ch}-{co}",
                      ffn_case("dwres_pw_ffn_pair", rows, c, ch, co),
                      refine, auto + zoo_sk))
        cases.append(("ffn_pair", f"ffn_pair {rows}x{c}-{ch}-{c}",
                      ffn_case("ffn_pair", rows, c, ch, c), refine, pair))
        for kernel, layout in dw_kernels:
            cases.append((kernel, f"{pairs}x{h8}x{w8}x{c} ks (1, {k})",
                          dw_case(kernel, pairs, c, k), refine, (layout,)))
        cases.append(("ffn_pair", f"pw_ffn_pair {rows}x{c}-{ch}-{co}",
                      ffn_case("pw_ffn_pair", rows, c, ch, co), refine,
                      pair))
    # TAM v1's per-frame flow head, SK(128 -> 2) on the batch*(T-1) frame
    # pairs: its K2 forms in the default layout and (checked only) the
    # pair layouts' second pair
    c, ch, rows = 128, 192, 3 * batch * h8 * w8
    cases.append(("ffn_pair", f"v1 flow head ffn_pair_k1 {rows}x{c}-{ch}-{c}",
                  ffn_case("ffn_pair_k1", rows, c, ch, c), refine,
                  zoo_with(v1=True)))
    cases.append(("ffn_pair",
                  f"v1 flow head dwres_pw_ffn_pair {rows}x{c}-{ch}-2",
                  ffn_case("dwres_pw_ffn_pair", rows, c, ch, 2), refine,
                  zoo_with(v1=True)))
    if not train:
        cases.append(("ffn_pair", f"v1 flow head pw_ffn_pair {rows}x{c}-{ch}-2",
                      ffn_case("pw_ffn_pair", rows, c, ch, 2), 0, every))
    # the Twins MLPs (B*T frames' tokens for the fnet, B*(T-1) for the
    # cnet, at 1/4 and 1/8, in one grid or per frame: the same rows);
    # Twins1DConv's pair alone, without its LayerNorm and residual
    for c, rows in ((128, batch * T * h4 * w4),
                    (128, batch * (T - 1) * h4 * w4),
                    (256, batch * T * h8 * w8),
                    (256, batch * (T - 1) * h8 * w8)):
        cases.append(("ffn_pair", f"ln_ffn_pair {rows}x{c}-{4 * c}-{c}",
                      ffn_case("ln_ffn_pair", rows, c, 4 * c, c), 2,
                      every + zoo_with(twins=True, hook="none")
                      + zoo_with(hook="attn")))
        cases.append(("ffn_pair",
                      f"1dconv ffn_pair residual=False {rows}x{c}-{4 * c}-{c}",
                      ffn_case("ffn_pair_nores", rows, c, 4 * c, c), 2,
                      zoo_with(hook="1dconv")))
    # K2's tails (64-row tiles): one row, one row past a tile, one row past
    # the main path's 21120, in every form at every width of the path
    if not train:
        for rows in (1, 65, 3 * h8 * w8 + 1):
            for c, co, _, _ in sk:
                ch = int(1.5 * c)
                for form, out in (("ffn_pair_k1", c), ("dwres_pw_ffn_pair", co),
                                  ("ffn_pair", c), ("pw_ffn_pair", co)):
                    cases.append(("ffn_pair",
                                  f"tail {form} {rows}x{c}-{ch}-{out}",
                                  ffn_case(form, rows, c, ch, out), 0, every))
            for c in (128, 256):
                cases.append(("ffn_pair",
                              f"tail ln_ffn_pair {rows}x{c}-{4 * c}-{c}",
                              ffn_case("ln_ffn_pair", rows, c, 4 * c, c), 0,
                              every))
    if not train:
        for nb, h, w, c, ks in CHAIN_EDGES:
            for kind in ("sk_chain_banded", "dw_chain", "dw_banded_mxu",
                         "dw_banded_mxu_t"):
                if kind == "dw_chain" and c % 2:
                    continue   # K5 reads channel pairs
                kks = ks[-1:] if kind.startswith("dw_banded") else ks
                cases.append((kind, f"edge {nb}x{h}x{w}x{c} ks {kks}",
                              edge_case(kind, nb, h, w, c, kks), 0, every))
    n = h8 * w8
    cases.append(("flash_attention", f"gma bh{3 * batch} n{n} m{n} d128",
                  flash_case((3 * batch, 1), n, n, 128), refine,
                  every + zoo_with(gma=True)))
    # GSA: keys from a stride-sr conv of the frames stacked along H; in the
    # per-frame family of each of batch*t frames, K3 above
    # GSA_FLASH_TOKENS an image (stage 0 only at the path's sizes)
    for stage, nh, sr, hh, ww in ((0, 4, 8, h4, w4), (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            n, m = t * hh * ww, (t * hh // sr) * (ww // sr)
            cases.append(("flash_attention",
                          f"gsa{stage} {enc} b{batch} h{nh} n{n} m{m} d32",
                          flash_case((batch, nh), n, m, 32),
                          int(n > GSA_FLASH_TOKENS),
                          every + zoo_with(csc=True)))
            n, m = hh * ww, (hh // sr) * (ww // sr)
            if n > GSA_FLASH_TOKENS:
                cases.append((
                    "flash_attention",
                    f"per-frame gsa{stage} {enc} b{batch * t} h{nh} n{n} "
                    f"m{m} d32", flash_case((batch * t, nh), n, m, 32), 1,
                    zoo_with(frame=True)))
    # tails of K3's tiles (128 query rows; 128 keys at d=128, 64 at d=32):
    # fewer keys than one tile, ragged query and key counts, one query row
    for bh_shape, n, m, d in (((1, 2), 300, 1000, 128), ((2, 1), 1, 1000, 128),
                              ((1, 4), 300, 50, 32), ((1, 8), 1000, 1312, 32),
                              ((1, 4), 1, 70, 32)):
        cases.append(("flash_attention",
                      f"tail bh{math.prod(bh_shape)} n{n} m{m} d{d}",
                      flash_case(bh_shape, n, m, d), 0, every))
    # LGA: the qkv grid of the frames stacked along H, padded to 7x7 windows
    for stage, c, nh, hh, ww in ((0, 128, 4, h4, w4), (1, 256, 8, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            hq, wq = -(-t * hh // 7) * 7, -(-ww // 7) * 7
            cases.append(("lga_attention",
                          f"stage{stage} {enc} {batch}x{hq}x{wq}x{3 * c} "
                          f"h{nh}",
                          lga_case(hq, wq, c, nh, b=batch), 1,
                          every + zoo_with(csc=True)))
            hq = -(-hh // 7) * 7      # per frame: batch*t grids of one
            cases.append(("lga_attention",
                          f"per-frame stage{stage} {enc} {batch * t}x{hq}x"
                          f"{wq}x{3 * c} h{nh}",
                          lga_case(hq, wq, c, nh, b=batch * t), 1,
                          zoo_with(frame=True)))
    # K4's tails: one-window grids and a stage-1 grid, two images each
    for hq, wq, c, nh in ((7, 7, 128, 4), (7, 7, 256, 8), (14, 21, 256, 8)):
        cases.append(("lga_attention", f"tail b2 {hq}x{wq}x{3 * c} h{nh}",
                      lga_case(hq, wq, c, nh, b=2), 0, every))
    cases.append(("corr_lookup", f"{3 * batch}x{h8}x{w8}x256 4 levels r4",
                  corr_case(), refine, every + zoo_all, "jitter30"))
    # K1 under the other traffics (timed apart: the kernels line's ms is
    # the jitter30 case's), then checked only: the branches of its bf16
    # body (128-, 64- and 32-column planes, empty boxes, box rows of
    # several planes) at ragged sizes, channel counts that leave a part
    # or most of a 64-channel panel empty (96, 32), C = 128 and 512,
    # fewer levels, a smaller radius and a level of size zero
    for traffic in ("smooth", "uniform"):
        cases.append(("corr_lookup",
                      f"{traffic} {3 * batch}x{h8}x{w8}x256 4 levels r4",
                      corr_traffic_case(traffic, 3 * batch, h8, w8, 256,
                                        4, 4),
                      refine, every + zoo_all, traffic))
    for label, args in (
            ("mixed tiles 3x45x150x96 4 levels r4",
             ("smooth", 3, 45, 150, 96, 4, 4, mixed_tiles)),
            (f"jitter30 3x{h8}x{w8}x128 4 levels r4",
             ("jitter30", 3, h8, w8, 128, 4, 4)),
            ("uniform 2x13x21x32 2 levels r2",
             ("uniform", 2, 13, 21, 32, 2, 2)),
            ("uniform 1x20x40x512 3 levels r3",
             ("uniform", 1, 20, 40, 512, 3, 3)),
            ("jitter30 1x5x6x64 4 levels r4", ("jitter30", 1, 5, 6, 64, 4, 4)),
            ("uniform 1x30x300x256 4 levels r4",
             ("uniform", 1, 30, 300, 256, 4, 4))):
        cases.append(("corr_lookup", f"tail {label}",
                      corr_traffic_case(*args), 0, every))

    # phase 33's two-frame models among the paths, at their own shapes:
    # validate_sintel_2f's 440x1024 grid of one pair (RAFT_ITERS calls a
    # clip) or train_2f's RAFT_TRAIN_B pairs of 368x496 (RAFT_TRAIN_ITERS
    # a step); SKFlow's six SK blocks (its gru 512 wide, with GMA) in the
    # default layout; the 384-wide gru of SKFlow without GMA, on no path
    # of this run, checked and timed ("timed")
    two = tuple(m for m in summaries if m in RAFT_MODELS)
    if two:
        nb, gh, gw, calls2 = ((RAFT_TRAIN_B, RAFT_TRAIN_H // 8,
                               RAFT_TRAIN_W // 8, RAFT_TRAIN_ITERS) if train
                              else (1, 440 // 8, 1024 // 8, RAFT_ITERS))
        rows, n2 = nb * gh * gw, gh * gw
        cases.append(("corr_lookup",
                      f"2f jitter30 {nb}x{gh}x{gw}x256 4 levels r4",
                      corr_2f_case(nb, gh, gw), calls2, two))
        blocks = [(324, 256, calls2), (256, 192, calls2), (128, 64, calls2),
                  (256, 126, calls2), (512, 128, calls2), (128, 2, calls2),
                  (384, 128, "timed")]
        for c, co, where in blocks:
            ch = int(1.5 * c)
            paths = (("skflow",) if where != "timed" else ("timed",))
            for form, out in (("ffn_pair_k1", c), ("dwres_pw_ffn_pair", co)):
                cases.append(("ffn_pair", f"2f {form} {rows}x{c}-{ch}-{out}",
                              ffn_case(form, rows, c, ch, out), calls2,
                              paths))
        cases.append(("flash_attention", f"2f gma bh{nb} n{n2} m{n2} d128",
                      flash_case((nb, 1), n2, n2, 128), calls2,
                      tuple(m for m in two if m != "raft")))

    if "umt" in summaries:
        cases += umt_cases(ffn_case, flash_case, corr_traffic_case,
                           mixed_tiles, edge_case,
                           *((hp, wp) if train else (UMT_H, UMT_W)), train)

    for kernel, label, make, calls, layouts, *traffic in cases:
        traffic = traffic[0] if traffic else None
        timed_only = "timed" in layouts
        layouts = tuple(lt for lt in layouts if lt in summaries)
        if not (layouts or timed_only) or (
                (batch > 1 or not tails) and not calls):
            continue
        for dt in (torch.float32, torch.bfloat16):
            run, plain, flops, inputs, library, aside = make(dt)
            got, want = run(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            # the output, and K3's logsumexp (f32) when it returns one
            err = max(check_close(f"{kernel}{' lse' if i else ''} [{label}]",
                                  a, b, a.dtype)
                      for i, (a, b) in enumerate(zip(got, want)))
            if dt == torch.bfloat16 and calls:   # tails: checked only
                ms, pms = cuda_ms(run, REPS), cuda_ms(plain, REPS)
                lib_ms = cuda_ms(library, REPS) if library else None
                io = nbytes(*inputs, *got)
                b, _ = bound_ms(flops, io, dt)
                for layout in layouts:
                    s = summaries[layout][kernel]
                    s["err"] = max(s["err"], err)
                    if traffic is not None:   # K1: ms per traffic
                        s.setdefault("ms_by_traffic", {})[traffic] = (
                            calls * ms)
                    if traffic in (None, "jitter30"):
                        add_timing(s, calls, ms, pms, flops, io, dt, lib_ms)
                extra = ""
                if aside is not None:
                    extra = f"; {aside[0]} {cuda_ms(aside[1], REPS):.4f} ms"
                if kernel in ("dw_chain", "sk_chain_banded"):
                    extra += (f", f32 FMA floor (67 TFLOP/s) "
                              f"{1e3 * flops / PEAK_FLOPS['float32']:.4f} ms")
                log(f"time {kernel} [{label}] bf16: kernel {ms:.4f} ms "
                    f"plain {pms:.4f} ms bound {b:.4f} ms ({flops:.4g} "
                    f"FLOP, {io:.4g} B; achieved {flops / ms / 1e9:.1f} "
                    f"TFLOP/s, {io / ms / 1e6:.0f} GB/s) library "
                    + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
                    + f"; calls per {path} {calls} ("
                    + ("/".join(layouts) or "on no path of this run") + ")"
                    + extra)
            del got, want
        torch.cuda.empty_cache()
    # K7 and K6 compute one function, their bf16 sums on the tensor cores
    # in one order (csrc/dw_banded_t.cu, csrc/sk_chain.cuh): bit for bit
    # at the path's shapes (one band of 56 rows), so that 'banded_mxu_t'
    # and 'banded_mxu' give the same forward
    if batch > 1 or "banded_mxu_t" not in summaries:
        return
    for c, _, pairs, k in sk:
        x, ws, bs = chain_inputs(rnd, pairs, h8, w8, c, (k,), torch.bfloat16)
        a7 = K6.dw_banded_mxu_t(x, ws[0], bs[0])
        a6 = K6.dw_banded_mxu(x, ws[0], bs[0])
        assert torch.equal(a7, a6), f"K7 differs from K6 at {tuple(x.shape)}"
    log(f"check dw_banded_mxu_t equals dw_banded_mxu bit for bit (bf16) at "
        f"the six SK blocks' {path} shapes")


def umt_cases(ffn_case, flash_case, corr_traffic_case, mixed_tiles,
              edge_case, hp=UMT_H, wp=UMT_W, train=False) -> list:
    """Phase 3's cases at the UMT model's shapes (phase 35: a 448x1024 clip,
    a 28x64 grid of 1792 tokens, B=1), kernel_checks' case tuples for its
    "umt" path: K3 in the ViT blocks (12 heads of d=64 over fnet's 4 x
    1792 tokens and cnet's 3 x 1792, 4 calls each) and in GMA (d=384 over
    each of the 3 frame pairs' 1792, once per iteration), with SDPA as its
    yardstick, and at the tails of its tiles at both dims (one query row;
    fewer keys than a tile: 128 at d=64, 32 at d=384); K1 at C=768 under
    the three traffics (jitter30 timed into the path), and at its bf16
    body's branches at C=768 (mixed tiles, a smaller radius and fewer
    levels); K2's two default forms at the six SK blocks' widths (the
    gru's and the flow head's on the wide path), the pair layouts' two
    forms at the gru's and flow head's widths (timed, on no path of this
    run), and all four at ragged row counts 1, 65 and 5377; K5-K8 at the
    gru's dw stage (1920 channels, k=7) and the flow head's (1152, k=15),
    checked only. With ``train`` (phase 6, the hp x wp step of phase 36:
    432x960, a 27x60 grid), the path's cases alone, calls per step: K3 in
    the ViT once a block (with its logsumexp), GMA's K3, K1 and K2 twice
    an iteration (remat's recompute)."""
    gh, gw = hp // 16, wp // 16
    n = gh * gw
    refine = 2 * ITERS if train else ITERS
    path, timed, cases = ("umt",), ("timed",), []
    for enc, t in (("fnet", T), ("cnet", T - 1)):
        cases.append(("flash_attention", f"umt {enc} bh12 n{t * n} d64",
                      flash_case((B, 12), t * n, t * n, 64), UMT_DEPTH,
                      path))
    cases.append(("flash_attention", f"umt gma bh3 n{n} d384",
                  flash_case((3, 1), n, n, 384), refine, path))
    shape = (3, gh, gw, 768, 4, 4)
    for traffic in ("jitter30", "smooth", "uniform"):
        cases.append(("corr_lookup", f"umt {traffic} 3x{gh}x{gw}x768 4 "
                      f"levels r4", corr_traffic_case(traffic, *shape), refine,
                      path, traffic))
    for i, (c, co) in enumerate(UMT_SK):
        ch = int(1.5 * c)
        rows = B * n if i == len(UMT_SK) - 1 else 3 * B * n
        for form, out in (("ffn_pair_k1", c), ("dwres_pw_ffn_pair", co)):
            cases.append(("ffn_pair", f"umt {form} {rows}x{c}-{ch}-{out}",
                          ffn_case(form, rows, c, ch, out), refine, path))
    if train:
        return cases
    for bh_shape, nq, m, d in (((1, 12), 1, 1000, 64), ((1, 12), 300, 100, 64),
                               ((2, 3), 129, 1311, 64), ((1, 1), 1, 20, 384),
                               ((2, 1), 100, 45, 384), ((3, 1), 65, 31, 384)):
        cases.append(("flash_attention",
                      f"umt tail bh{math.prod(bh_shape)} n{nq} m{m} d{d}",
                      flash_case(bh_shape, nq, m, d), 0, timed))
    for label, args in (
            ("mixed tiles 3x45x150x768 4 levels r4",
             ("smooth", 3, 45, 150, 768, 4, 4, mixed_tiles)),
            ("uniform 1x20x40x768 3 levels r3",
             ("uniform", 1, 20, 40, 768, 3, 3))):
        cases.append(("corr_lookup", f"umt tail {label}",
                      corr_traffic_case(*args), 0, timed))
    for i, (c, co) in enumerate(UMT_SK):
        ch = int(1.5 * c)
        rows = B * n if i == len(UMT_SK) - 1 else 3 * B * n
        if c <= 640:
            continue
        for form, out in (("ffn_pair_k1", c), ("dwres_pw_ffn_pair", co),
                          ("ffn_pair", c), ("pw_ffn_pair", co)):
            if form in ("ffn_pair", "pw_ffn_pair"):
                cases.append(("ffn_pair", f"umt {form} {rows}x{c}-{ch}-{out}",
                              ffn_case(form, rows, c, ch, out), ITERS, timed))
            for r in (1, 65, 3 * n + 1):
                cases.append(("ffn_pair",
                              f"umt tail {form} {r}x{c}-{ch}-{out}",
                              ffn_case(form, r, c, ch, out), 0, timed))
    for kind in ("sk_chain_banded", "dw_chain", "dw_banded_mxu",
                 "dw_banded_mxu_t"):
        for nb, c, k in ((3 * B, 1920, 7), (B, 1152, 15)):
            ks = (k,) if kind.startswith("dw_banded") else (1, k)
            cases.append((kind, f"umt {nb}x{gh}x{gw}x{c} ks {ks}",
                          edge_case(kind, nb, gh, gw, c, ks), 0, timed))
    return cases


# ---------------------------------------------------------------- phase 4/5
def make_clip(dev, h=H, w=W, mode="sintel", seed=SEED, factor=8):
    """A seeded B x T x h x w clip of uint8-range values, padded in
    ``mode`` to a multiple of ``factor`` (the model's ratio), on
    ``dev``."""
    import torch

    from streamflow_tpu_torch.ops.padding import InputPadder

    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (B, T, h, w, 3), generator=g).float()
    padder = InputPadder((h, w, 3), mode=mode, factor=factor)
    imgs = padder.pad(imgs.reshape(B * T, h, w, 3))
    return imgs.reshape(B, T, *padder.padded_shape, 3).to(dev)


def full_forward(dev, dw_impl, zoo=None):
    """The test-mode forward of the SK layout ``dw_impl`` or, with ``zoo``,
    of that ZOO config in the default layout (its Twins MLPs' K2 forms
    counted apart); returns the launches and ms/clip, and for a ZOO
    config keeps its numbers in ZOO_TABLE."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.layers import twins
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    if zoo is None:
        suffix, expected, _ = LAYOUTS[dw_impl]
        tag = f"dw_impl={dw_impl!r}"
    else:
        suffix, expected, tag = f"_{zoo}", zoo_launches(zoo), f"config {zoo!r}"
    cfg = StreamFlowConfig(T=T, iters=ITERS, mixed_precision=True,
                           dw_impl=dw_impl, **ZOO.get(zoo, {}))
    held = torch.cuda.memory_allocated()    # by the phases before this one
    model = create_model("streamflow", cfg=cfg)
    init_weights(model, SEED)
    imgs = make_clip(dev)
    hp, wp = imgs.shape[2], imgs.shape[3]

    flows = model(imgs, test_mode=True)       # warm-up (builds nothing new)
    torch.cuda.synchronize()
    # the Twins encoders' K2 forms, counted where they are called
    forms = {"ln_ffn_pair": 0, "ffn_pair": 0}
    wrapped = {n: getattr(twins, n) for n in forms}

    def counting(name):
        def call(*a, **kw):
            forms[name] += 1
            return wrapped[name](*a, **kw)
        return call
    for name in forms:
        setattr(twins, name, counting(name))
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        flows = model(imgs, test_mode=True)
        torch.cuda.synchronize()
    finally:
        for name, fn in wrapped.items():
            setattr(twins, name, fn)
    counts = dict(LAUNCHES)
    kind = zoo_kind(zoo) if zoo else dict(twins=True, hook="none")
    want_forms = {"ln_ffn_pair": 8 * (kind["twins"]
                                      and kind["hook"] != "1dconv"),
                  "ffn_pair": 8 * (kind["hook"] == "1dconv")}
    log(f"forward {tag} launches {json.dumps(counts)} expected "
        f"{json.dumps(expected)}; the Twins MLPs' K2 forms {forms} expected "
        f"{want_forms}")
    assert counts == expected, "launch counts differ"
    assert forms == want_forms, "the Twins MLPs' K2 forms differ"
    assert flows.shape == (B, T - 1, hp, wp, 2), flows.shape
    assert bool(torch.isfinite(flows).all()), "non-finite flows"
    peak = torch.cuda.max_memory_allocated()
    mag = flows.norm(dim=-1)

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(imgs, test_mode=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)
    log(f"forward {tag} {tuple(flows.shape)} finite; ms/clip "
        f"{ms:.3f} (mean of "
        f"{REPS}, min {1e3 * min(times):.3f}); frames/s {T / (ms / 1e3):.3f};"
        f" max_memory_allocated {peak / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f}"
        f" of it held before the model was built); |flow| px mean "
        f"{float(mag.mean()):.4g} p99 "
        f"{float(torch.quantile(mag.flatten()[::7], 0.99)):.4g} max "
        f"{float(mag.max()):.4g}")
    prof = profile_device(lambda: model(imgs, test_mode=True), ms,
                          "forward" + suffix)
    if zoo is not None:
        ZOO_TABLE[zoo] = dict(ms_clip=round(ms, 3),
                              device_ms=round(prof["total_ms"], 3),
                              idle=round(prof["idle"], 4),
                              peak_gib=round((peak - held) / 2 ** 30, 3))
    return counts, ms


def profile_device(fn, wall_ms: float, name: str, host: bool = True
                   ) -> dict:
    """Device time of one call of ``fn`` by kernel group
    (tools/common.py::kernel_group; profiled after a traced warm-up call,
    tools/common.py::profiled; ``host=False``: the
    card's activity alone, no host ops in the table); the idle share
    compares the summed device time with the unprofiled wall time."""
    from streamflow_tpu_torch.tools.common import (device_time_by_group,
                                                   profiled)

    prof = profiled(fn, host)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=60)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as fh:
        fh.write(smi() + "\n" + table)
    total, by = device_time_by_group(prof)
    idle = max(0.0, 1 - total / 1e3 / wall_ms)
    log(f"profile {name} device time by group (ms): " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in sorted(by.items(),
                                                 key=lambda kv: -kv[1])})
        + f" total {total / 1e3:.3f}; K1 share "
        f"{by.get('corr_lookup', 0.0) / max(total, 1e-9):.4f}; device idle "
        f"share {idle:.4f} of {wall_ms:.3f} ms")
    return {"total_ms": total / 1e3, "idle": idle}


def accuracy_guards(dev, dw_impl, refs, zoo=None, h=H, w=W, fields=None,
                    factor=8) -> None:
    """iters=1, one h x w clip (padded to a multiple of ``factor``), the
    same weights, the SK layout ``dw_impl`` (and the ZOO config ``zoo``,
    or the config ``fields`` named ``zoo``): the kernel path on the card
    and the plain path on the CPU, each in f32 and bf16, against the f32
    plain path. Every layout computes the same function in f32, so that
    reference is made once, by the first call, and kept in ``refs`` (a
    ZOO config is a function of its own: give it refs of its own)."""
    import copy

    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    imgs = make_clip("cpu", h, w, factor=factor)
    fields = ZOO.get(zoo, {}) if fields is None else fields
    flows = {}
    for dtype in ("float32", "bfloat16"):
        cfg = StreamFlowConfig(T=T, iters=1,
                               mixed_precision=dtype == "bfloat16",
                               dw_impl=dw_impl, **fields)
        cpu_model = create_model("streamflow", cfg=cfg, device="cpu")
        init_weights(cpu_model, SEED + 1)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        flows[dtype, "card"] = gpu_model(imgs.to(dev),
                                         test_mode=True).float().cpu()
        if dtype == "bfloat16" or "f32" not in refs:
            flows[dtype, "cpu"] = cpu_model(imgs, test_mode=True).float()
        if dtype == "float32" and "f32" not in refs:
            refs["f32"] = (flows[dtype, "cpu"], dw_impl)
    from streamflow_tpu_torch.tools.common import rel_epe

    ref, ref_layout = refs["f32"]
    mag = ref.norm(dim=-1)
    f32 = rel_epe(flows["float32", "card"], ref)
    bf16, bf16_plain = (rel_epe(flows["bfloat16", where], ref)
                        for where in ("card", "cpu"))
    tag = f"dw_impl={dw_impl!r}" if zoo is None else f"config {zoo!r}"
    log(f"accuracy guard {tag} {h}x{w} iters=1 against the f32 plain "
        f"path (of dw_impl={ref_layout!r}; |flow_ref| px "
        f"mean {float(mag.mean()):.4g} max {float(mag.max()):.4g}), rel EPE "
        f"global / per-pixel p99: f32 kernels {f32[0]:.3e} / {f32[1]:.3e} "
        f"(bound {F32_GUARD_TOL} each); bf16 kernels {bf16[0]:.3e} / "
        f"{bf16[1]:.3e}, bf16 plain {bf16_plain[0]:.3e} / "
        f"{bf16_plain[1]:.3e} (bound {BF16_GUARD_RATIO}x the plain)")
    assert all(math.isfinite(v) and v < F32_GUARD_TOL for v in f32), f32
    assert all(math.isfinite(k) and k <= BF16_GUARD_RATIO * p
               for k, p in zip(bf16, bf16_plain)), (bf16, bf16_plain)


# ---------------------------------------------------------------- phase 6
def backward_checks(dev, summaries, batch=1, zoo=None,
                    two_frame=None, umt=None, h=TRAIN_H, w=TRAIN_W,
                    tails=True) -> None:
    """B5, with K3's output and lse, against their plain versions at the
    training shapes of ``batch`` clips (f32, bf16; bf16 timed beside its
    bound and SDPA's backward, on the backend its dispatcher picks, summed
    over one train step's calls into each of ``summaries`` and of the ZOO
    configs' ``zoo`` ({name: summary}) whose step runs that case), at the
    two-frame models' GMA grid (phase 33's step: RAFT_TRAIN_B pairs of
    368x496) into ``two_frame``'s ({name: summary}) with GMA, at the UMT
    step's K3 calls (phase 36: the ViT's 12 heads of d=64 over fnet's 4 x
    1620 and cnet's 3 x 1620 tokens, once a block; GMA at d=384 over 3 x
    1620, once an iteration) into ``umt``'s (a summary), and, at batch=1
    only, B5's tails (at d=64 and d=384 with ``umt``) and each kernel
    wrapper's forward (f32, bf16) and gradient (f32) against its plain
    version: neither depends on the batch. ``h`` x ``w``: another
    training size (GSA calls only above GSA_FLASH_TOKENS); ``tails=False``
    leaves out the tails and the wrappers' checks (a path at other
    shapes)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from streamflow_tpu_torch.ops.corr import pool_pyramid
    from streamflow_tpu_torch.ops.coords import coords_grid
    from streamflow_tpu_torch.ops.kernels import corr_lookup as K1
    from streamflow_tpu_torch.ops.kernels import dw_banded as K6
    from streamflow_tpu_torch.ops.kernels import dw_chain as K5
    from streamflow_tpu_torch.ops.kernels import ffn_pair as K2
    from streamflow_tpu_torch.ops.kernels import flash_attention as K3
    from streamflow_tpu_torch.ops.kernels import lga_attention as K4

    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    # GMA over 3 pairs a clip of (432/8) x (960/8) tokens; the four GSA
    # blocks (fnet on 4 frames, cnet on 3, stacked along H; keys from a
    # stride-sr conv, stage 0 sr 8, stage 1 sr 4), each above the
    # 16384-token switch; calls per train step
    h8, w8 = h // 8, w // 8
    zoo = zoo or {}

    def zoo_with(**want):
        return [zs for z, zs in zoo.items()
                if all(zoo_kind(z)[k] == v for k, v in want.items())]
    cases = [("gma", (3 * batch, 1), h8 * w8, h8 * w8, 128, ITERS,
              summaries + zoo_with(gma=True))]
    for stage, nh, sr, hh, ww in ((0, 4, 8, 2 * h8, 2 * w8),
                                  (1, 8, 4, h8, w8)):
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"gsa{stage} {enc}", (batch, nh), t * hh * ww,
                          (t * hh // sr) * (ww // sr), 32,
                          int(t * hh * ww > GSA_FLASH_TOKENS),
                          summaries + zoo_with(csc=True)))
            # the per-frame family: batch*t images of one frame
            if hh * ww > GSA_FLASH_TOKENS and zoo_with(frame=True):
                cases.append((f"per-frame gsa{stage} {enc}",
                              (batch * t, nh), hh * ww,
                              (hh // sr) * (ww // sr), 32, 1,
                              zoo_with(frame=True)))
    gma2 = [sm for m, sm in (two_frame or {}).items() if m != "raft"]
    if gma2:
        n2 = (RAFT_TRAIN_H // 8) * (RAFT_TRAIN_W // 8)
        cases.append(("2f gma", (RAFT_TRAIN_B, 1), n2, n2, 128,
                      RAFT_TRAIN_ITERS, gma2))
    if umt is not None:
        n = (TRAIN_H // 16) * (TRAIN_W // 16)
        for enc, t in (("fnet", T), ("cnet", T - 1)):
            cases.append((f"umt {enc}", (batch, 12), t * n, t * n, 64,
                          UMT_DEPTH, [umt]))
        cases.append(("umt gma", (3 * batch, 1), n, n, 384, ITERS, [umt]))
    # B5's tails (128 resident and 64 walked rows a block; at d=384 64 and
    # 32): one query row, fewer keys than one tile, ragged query and key
    # counts
    tail_cases = (((1, 2), 1, 1000, 128), ((2, 1), 300, 50, 128),
                  ((1, 2), 333, 777, 128), ((1, 4), 1, 70, 32),
                  ((1, 4), 300, 50, 32), ((1, 8), 1001, 1313, 32))
    if umt is not None:
        tail_cases += (((1, 1), 1, 1000, 64), ((1, 2), 333, 777, 64),
                       ((2, 1), 129, 65, 64), ((1, 1), 1, 20, 384),
                       ((2, 1), 100, 45, 384), ((1, 1), 65, 1311, 384))
    for bh_shape, n, m, d in tail_cases if batch == 1 and tails else ():
        cases.append(("tail", bh_shape, n, m, d, 0, []))
    for label, bh_shape, n, m, d, calls, paths in cases:
        label = f"{label} bh{math.prod(bh_shape)} n{n} m{m} d{d}"
        for dt in (torch.float32, torch.bfloat16):
            q = rnd(*bh_shape, n, d, scale=d ** -0.5, dt=dt)
            k, v = rnd(*bh_shape, m, d, dt=dt), rnd(*bh_shape, m, d, dt=dt)
            do = rnd(*bh_shape, n, d, dt=dt)
            o, lse = K3.flash_attention_fwd(q, k, v, return_lse=True)
            o_p, lse_p = K3.flash_attention_plain(q, k, v, return_lse=True)
            check_close(f"flash_attention [{label}]", o, o_p, dt)
            check_close(f"flash_attention lse [{label}]", lse, lse_p,
                        torch.float32)
            # both sides take the same inputs: the plain lse and delta
            delta = (do.float() * o_p.float()).sum(-1)
            run = lambda: K3.flash_attention_bwd(  # noqa: E731
                q, k, v, do, lse_p, delta)
            plain = lambda: K3.flash_attention_bwd_plain(  # noqa: E731
                q, k, v, do, lse_p, delta)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = max(check_close(f"flash_attention_bwd {name} [{label}]",
                                  a, b, dt)
                      for name, a, b in zip(("dq", "dk", "dv"), got, want))
            if dt == torch.bfloat16 and calls:   # tails: checked only
                ms, pms = cuda_ms(run, REPS), cuda_ms(plain, REPS)
                qs, ks, vs = (t.detach().clone().requires_grad_(True)
                              for t in (q, k, v))
                ref = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    ref, (qs, ks, vs), do, retain_graph=True), REPS)
                flops = 10 * math.prod(bh_shape) * n * m * d
                io = nbytes(q, k, v, do, lse, delta, *got)
                b, _ = bound_ms(flops, io, dt)
                for summary in paths:
                    s = summary["flash_attention_bwd"]
                    s["err"] = max(s["err"], err)
                    add_timing(s, calls, ms, pms, flops, io, dt, lib_ms)
                # the backend SDPA's dispatcher takes for these inputs
                # (its flash backend refuses d > 256)
                backend = SDPBackend(torch._fused_sdp_choice(
                    qs, ks, vs, scale=1.0)).name
                log(f"time flash_attention_bwd [{label}] bf16: kernel "
                    f"{ms:.4f} ms plain {pms:.4f} ms bound {b:.4f} ms "
                    f"({flops:.4g} FLOP, {io:.4g} B; achieved "
                    f"{flops / ms / 1e9:.1f} TFLOP/s) library (SDPA "
                    f"backward, {backend}) {lib_ms:.4f} ms; calls per train "
                    f"step of B={batch} {calls}")
                del ref, qs, ks, vs
            del q, k, v, do, o, lse, o_p, lse_p, got, want
            torch.cuda.empty_cache()
    if batch > 1 or not tails:
        return

    # each kernel wrapper (kernel forward, composite backward) at a training
    # shape: its forward against the plain version in bf16 (the train step's
    # dtype) and f32, then its f32 gradient against autograd of the plain
    # version. That backward IS autograd of the same composite on the same
    # saved inputs, so the gradient check tests only the wiring (each
    # gradient reaches its argument; it reads 0); the kernels' numerics are
    # held by the forward checks and by phase 8.
    def grad_check(label, fn, plain, inputs):
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.detach().to(t.dtype if name == "coords" else dt)
                   for name, t in inputs]
            with torch.no_grad():
                check_close(f"{label} forward", fn(*ins), plain(*ins), dt)
        ins = [t.detach().clone().requires_grad_(name != "coords")
               for name, t in inputs]
        out = fn(*ins)
        gout = rnd(*out.shape)
        wrt = [t for t in ins if t.requires_grad]
        got = torch.autograd.grad(out, wrt, gout)
        ins_p = [t.detach().clone().requires_grad_(t.requires_grad)
                 for t in ins]
        want = torch.autograd.grad(plain(*ins_p), [t for t in ins_p
                                                   if t.requires_grad], gout)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in zip(got, want):
            top = float(b.abs().max())
            diff = (a - b).abs()
            ok = bool((diff <= F32_TOL * (top + b.abs())).all())
            worst = max(worst, float(diff.max()) / max(top, 1e-30))
            if not ok:
                raise AssertionError(f"gradient of {label} disagrees with "
                                     f"autograd of its plain version")
        log(f"check grad {label} f32 (wiring): {len(got)} inputs, max abs err "
            f"/ max |plain grad| {worst:.3e} (bound {F32_TOL} of the largest "
            f"element + {F32_TOL} rtol)")

    rows, c = 3 * h8 * w8, 324
    w = lambda i, o: rnd(o, i, scale=i ** -0.5)  # noqa: E731
    b = lambda n: rnd(n, scale=0.1)  # noqa: E731
    x = rnd(rows, c)
    grad_check("ffn_pair_k1 [convc1]", K2.ffn_pair_k1,
               lambda *a: K2.ffn_pair_plain(*a[:5], True, kw=a[5], kb=a[6]),
               list(zip("xabcdef", (x, w(c, 486), b(486), w(486, c), b(c),
                                    rnd(c, scale=0.3), b(c)))))
    grad_check("dwres_pw_ffn_pair [convc1]", K2.dwres_pw_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[5:], False, wp=a[3],
                                            bp=a[4], yres=a[1], db=a[2]),
               list(zip("xyabcdefg", (x, rnd(rows, c), b(c), w(c, c), b(c),
                                      w(c, 486), b(486), w(486, 256),
                                      b(256)))))
    grad_check("ffn_pair [convc1, dw_impl='pallas']", K2.ffn_pair,
               lambda *a: K2.ffn_pair_plain(*a, True),
               list(zip("xabcd", (x, w(c, 486), b(486), w(486, c), b(c)))))
    grad_check("pw_ffn_pair [convc1, dw_impl='pallas']", K2.pw_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[3:], False, wp=a[1],
                                            bp=a[2]),
               list(zip("xabcdef", (x, w(c, c), b(c), w(c, 486), b(486),
                                    w(486, 256), b(256)))))
    xs = x.reshape(3, h8, w8, c)
    for cc, k, xk in ((c, 15, xs), (640, 7, rnd(3, h8, w8, 640))):
        stack = list(zip("xabcd", (xk, rnd(cc, 1, 1, 1, scale=0.3),
                                   rnd(cc, 1, k, k, scale=1 / k), b(cc),
                                   b(cc))))
        for mod, name in ((K5, "dw_chain"), (K6, "sk_chain_banded")):
            fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
            grad_check(f"{name} [{tuple(xk.shape)} ks (1, {k})]",
                       lambda a, w1, wk, b1, bk, k=k, fn=fn: fn(
                           a, (w1, wk), (b1, bk), (1, k)),
                       lambda a, w1, wk, b1, bk, k=k, fn=plain: fn(
                           a, (w1, wk), (b1, bk), (1, k)), stack)
        for name in ("dw_banded_mxu", "dw_banded_mxu_t"):
            grad_check(f"{name} [{tuple(xk.shape)} k {k}]",
                       getattr(K6, name), getattr(K6, name + "_plain"),
                       [stack[0], stack[2], stack[4]])
    xt = rnd(T * 2 * h8 * 2 * w8, 128)
    grad_check("ln_ffn_pair [twins stage 0 fnet]", K2.ln_ffn_pair,
               lambda *a: K2.ffn_pair_plain(a[0], *a[3:], False,
                                            ln=(a[1], a[2]), add_res=True),
               list(zip("xabcdef", (xt, 1.0 + rnd(128, scale=0.1), b(128),
                                    w(128, 512), b(512), w(512, 128),
                                    b(128)))))
    hp, wp = -(-T * 2 * h8 // 7) * 7, -(-2 * w8 // 7) * 7
    grad_check("lga_attention [twins stage 0 fnet]",
               lambda a: K4.lga_attention(a, 7, 4),
               lambda a: K4.lga_attention_plain(a, 7, 4),
               [("qkv", rnd(1, hp, wp, 384))])
    coords = (coords_grid(3, h8, w8, dev)
              + 4.0 * rnd(3, h8, w8, 2)).contiguous()
    f1, f2 = rnd(3, h8, w8, 256), rnd(3, h8, w8, 256)
    grad_check("corr_lookup [3x54x120x256]",
               lambda a, bb, cc: K1.FusedCorr(a, bb).lookup(cc),
               lambda a, bb, cc: K1.corr_lookup_plain(
                   a, pool_pyramid(bb, 4), cc),
               [("f1", f1), ("f2", f2), ("coords", coords)])
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7
def train_setup(dev, h, w, iters, mixed_precision, seed, dw_impl, t=T,
                zoo=None, bidir=False, fields=None):
    """A TrainState holding a training model (SK layout ``dw_impl``, T=t,
    the ZOO config ``zoo`` or the config ``fields``) with the seeded
    weights, and a seeded synthetic batch (uint8-range images, N(0, 4^2)
    px flows; the backward flows too with ``bidir``)."""
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState

    fields = ZOO.get(zoo, {}) if fields is None else fields
    cfg = StreamFlowConfig(T=t, iters=iters, mixed_precision=mixed_precision,
                           remat=True, dw_impl=dw_impl, **fields)
    model = create_model("streamflow", cfg=cfg, device=dev, train=True)
    init_weights(model, seed)
    state = TrainState.create(model, lr=1.75e-4, num_steps=180_000)
    return state, synthetic_batch(B, t, h, w, seed, dev, bidir)


def train_step_phase(dev, dw_impl, umt=False) -> dict:
    """Phase 7's train step in SK layout ``dw_impl`` (phases 11, 15, 19 and
    23 for the other layouts), or with ``umt`` phase 36's, of the UMT
    model (launches from umt_train_launches): a warm-up step, then
    TRAIN_STEPS timed ones, the first's launches exactly, finite loss and
    gradient norm, every parameter moved, peak memory, one profiled step
    (the default layout's with the host ops, the others' of the card
    alone). Returns the launches of one step."""
    import torch

    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.training.step import make_train_step

    suffix, _, expected = LAYOUTS[dw_impl]
    tag, fields = f"dw_impl={dw_impl!r}", None
    if umt:
        suffix, expected, tag, fields = ("_umt", umt_train_launches(), "umt",
                                         UMT_KW)
    state, batch = train_setup(dev, TRAIN_H, TRAIN_W, ITERS, True, SEED,
                               dw_impl, fields=fields)
    step = make_train_step(gamma=0.85, iters=ITERS)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    m = step(state, batch)                       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train step {tag} launches {json.dumps(counts)} "
        f"expected {json.dumps(expected)}")
    assert counts == expected, "train launch counts differ"
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    assert math.isfinite(loss) and math.isfinite(norm), (loss, norm)
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    assert not still, f"parameters that did not move: {still[:5]}"
    ms = 1e3 * sum(times) / len(times)
    log(f"train step {tag} {B}x{T}x{TRAIN_H}x{TRAIN_W} iters "
        f"{ITERS} bf16 + f32 "
        f"params + remat: ms/step {ms:.3f} (mean of {TRAIN_STEPS} after a "
        f"warm-up, each {[round(1e3 * t, 3) for t in times]}); steps/s "
        f"{1e3 / ms:.4f}; max_memory_allocated {peak / 2 ** 30:.3f} GiB; "
        f"loss {loss:.6g} grad_norm {norm:.6g} epe {float(m['epe']):.6g}; "
        f"all {len(before)} parameters moved")
    # the other layouts' steps: the card's activity alone (the host ops'
    # trace of a step costs ~20 s; the default layout's table keeps them)
    profile_device(lambda: step(state, batch), ms, "train_step" + suffix,
                   host=dw_impl == "auto" and not umt)
    return counts


def umt_train_phase(dev) -> dict:
    """Phase 36, the UMT model (encoder="umt", decoder_dim=768) trained:
    phase 7's step at 432x960 (train_step_phase with ``umt``: exact
    launches, every parameter moved, ms/step, a profile of the card
    alone, peak memory), then phase 8's training guard on the UMT model
    at GUARD_H x GUARD_W, T=4, GUARD_ITERS iterations. Returns the step's
    launches."""
    import torch

    counts = train_step_phase(dev, "auto", umt=True)
    torch.cuda.empty_cache()
    training_guard(dev, "auto", fields=UMT_KW)
    return counts


# ---------------------------------------------------------------- phase 8
def training_guard(dev, dw_impl, t=T, fields=None) -> None:
    """One step's loss and gradients at GUARD_H x GUARD_W, T=t, SK layout
    ``dw_impl`` (the config ``fields``, e.g. UMT_KW): the kernel path
    on the card against the plain path on the CPU, f32 and bf16, each
    against the f32 plain path (same seeded weights and batch). The f32
    bound of each gradient is GRAD_TOL plus PERTURB_SLACK times that
    gradient's own sensitivity: its relative change on the f32 plain path
    when every weight moves by a relative 1e-6 (f32 rounding of the
    forward). A few gradients (the cnet's and the mask head's, ~1e-6 of
    the total norm) are sums that cancel, and 1e-6 moves them by ~3e-3;
    a kernel fault is O(1). All gradients together are held to
    GRAD_GLOBAL_TOL, below the perturbation's global change."""
    import torch

    from streamflow_tpu_torch.training.step import make_loss_fn

    loss_fn = make_loss_fn(gamma=0.85, iters=GUARD_ITERS)
    res = {}
    runs = [(False, "cpu", "cpu", 0.0), (False, "cpu+1e-6", "cpu", 1e-6),
            (False, "card", dev, 0.0), (True, "cpu", "cpu", 0.0),
            (True, "card", dev, 0.0)]
    for mp, path, where, eps in runs:
        state, batch = train_setup(where, GUARD_H, GUARD_W, GUARD_ITERS, mp,
                                   SEED + 3, dw_impl, t, fields=fields)
        model = state.model
        if eps:
            g = torch.Generator().manual_seed(SEED + 4)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        loss, _ = loss_fn(model, batch)
        loss.backward()
        res[mp, path] = (float(loss.detach()),
                         {n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()})
        del state, batch, model, loss
    ref_loss, ref = res[False, "cpu"]

    def errors(key):
        loss, grads = res[key]
        per = {n: float((grads[n] - ref[n]).norm()
                        / ref[n].norm().clamp(min=1e-30)) for n in ref}
        glob = float(torch.sqrt(sum((grads[n] - ref[n]).pow(2).sum()
                                    for n in ref))
                     / torch.sqrt(sum(ref[n].pow(2).sum() for n in ref)))
        return abs(loss - ref_loss) / abs(ref_loss), per, glob

    f32, pert = errors((False, "card")), errors((False, "cpu+1e-6"))
    slack = {n: f32[1][n] / (GRAD_TOL + PERTURB_SLACK * pert[1][n])
             for n in ref}
    worst = max(slack, key=slack.get)
    bf, bfp = errors((True, "card")), errors((True, "cpu"))

    def median(d):
        return sorted(d.values())[len(d) // 2]

    config = f" {json.dumps(fields)}" if fields else ""
    log(f"training guard dw_impl={dw_impl!r}{config} T={t} "
        f"{GUARD_H}x{GUARD_W} iters {GUARD_ITERS} against "
        f"the f32 plain path (loss {ref_loss:.6g}): f32 kernels loss rel "
        f"err {f32[0]:.3e} (bound {GRAD_TOL}), gradients rel L2 global "
        f"{f32[2]:.3e} (bound {GRAD_GLOBAL_TOL}) median "
        f"{median(f32[1]):.3e} max "
        f"{max(f32[1].values()):.3e}; 1e-6 weight perturbation of the plain "
        f"path: global {pert[2]:.3e} median {median(pert[1]):.3e} max "
        f"{max(pert[1].values()):.3e}; closest to its bound {worst}: "
        f"{f32[1][worst]:.3e} against {GRAD_TOL} + {PERTURB_SLACK} x "
        f"{pert[1][worst]:.3e}; bf16 kernels loss {bf[0]:.3e} gradients "
        f"global {bf[2]:.3e} median {median(bf[1]):.3e}, bf16 plain loss "
        f"{bfp[0]:.3e} global {bfp[2]:.3e} median {median(bfp[1]):.3e} "
        f"(bounds: loss {GRAD_TOL}, global {BF16_GUARD_RATIO}x the plain)")
    # the loss is dominated by the ground truth (N(0, 4^2) px against
    # sub-px predictions), so both paths read ~1e-5: held to GRAD_TOL
    assert f32[0] < GRAD_TOL and slack[worst] <= 1.0, (f32[0], worst)
    assert f32[2] <= GRAD_GLOBAL_TOL, (f32[2], pert[2])
    assert bf[0] < GRAD_TOL, (bf[0], bfp[0])
    assert bf[2] <= BF16_GUARD_RATIO * bfp[2], (bf[2], bfp[2])


# ---------------------------------------------------------------- phase 27
# the serving phases' other shapes: a KITTI frame (padded in 'kitti' mode
# to 376x1248, or in 'kitti432' to 432x1248 for the tiled validator's
# 432x960 patches) and phase 29's high resolutions (multiples of 8)
KITTI_H, KITTI_W = 375, 1242
HIGH_RES = ((1080, 1920), (1440, 2560))


def node_kernel(name: str):
    """The port kernel (a key of KERNELS) of a CUDA kernel's name as the
    profiler gives it, mangled or not; None for PyTorch's and its
    libraries' kernels. The engine's kernel sk_chain_kernel<P, V> is K8,
    K5 or K6 by its policy P (csrc/sk_chain.cuh); dw_banded_t_kernel is
    K7 (csrc/dw_banded_t.cu). dw_banded_kernel is the f32 body of K6-K8
    (csrc/dw_banded.cu), which the bf16 forwards never run; it is counted
    as K7, whose f32 launch it is among others."""
    import re

    m = re.search(r"sk_chain_kernel(?:<|ILi)(\d)", name)
    if m:
        return ("sk_chain_banded", "dw_chain", "dw_banded_mxu")[
            int(m.group(1))]
    for pat, k in (("corr_lookup", "corr_lookup"), ("ffn_pair", "ffn_pair"),
                   ("flash_fwd", "flash_attention"),
                   ("lga_kernel", "lga_attention"),
                   ("dw_chain_kernel", "dw_chain"),
                   ("dw_banded_t_kernel", "dw_banded_mxu_t"),
                   ("dw_banded_kernel", "dw_banded_mxu_t")):
        if pat in name:
            return k
    return None


# throwaway kernels that open a counted call's profile window: its first
# kernels can go unrecorded even after a traced warm-up (on an H100 one
# 'auto' replay once lost its first ~50, 4 of them port kernels)
PROFILE_PAD = 256


def replay_kernel_counts(fn):
    """Kernels run by one profiled call of ``fn`` (a graph replay), by port
    kernel ({kernel: count}, the nonzero ones), and the count of all
    other kernels (PROFILE_PAD tiny PyTorch kernels run first in the same
    window, so that any it misses at its start are theirs)."""
    import torch

    from streamflow_tpu_torch.tools.common import device_events, profiled

    pad = torch.zeros(1, device="cuda")

    def padded():
        for _ in range(PROFILE_PAD):
            pad.add_(1)
        fn()

    counts, other = {}, 0
    for name, count, _ in device_events(profiled(padded)):
        k = node_kernel(name)
        if k is None:
            other += count
        else:
            counts[k] = counts.get(k, 0) + count
    return counts, other


def eager_then_graph(model, imgs, label):
    """The clip ``imgs`` through ``model`` eagerly (one call, then REPS
    timed), then through a GraphedForward of it (its first call warms up
    and captures, then REPS timed replays); each path profiled once
    (device time, idle share; OUT_DIR/profile_{eager,graph}_<label>.txt)
    and its peak memory (the graph's over its capture and replays).
    Returns (the GraphedForward, its flows, the eager flows, ms/clip
    graph, {path: (ms/clip, device ms, idle share, peak GiB)} for
    "eager" and "graph")."""
    import torch

    from streamflow_tpu_torch.evaluation import GraphedForward
    from streamflow_tpu_torch.tools.common import host_ms

    def eager():
        return model(imgs, test_mode=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = eager()
    ms_e = host_ms(eager, REPS, imgs.device)
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = GraphedForward(model, model.cfg.iters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = fwd(imgs)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ms_g = host_ms(lambda: fwd(imgs), REPS, imgs.device)
    peak_g = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_e = profile_device(eager, ms_e[0], f"eager_{label}")
    prof_g = profile_device(lambda: fwd(imgs), ms_g[0], f"graph_{label}")
    log(f"serving {label} dw_impl={model.cfg.dw_impl!r} "
        f"{tuple(imgs.shape)}: ms/clip eager {ms_e[0]:.3f} (mean of {REPS}, "
        f"min {ms_e[1]:.3f}), graph {ms_g[0]:.3f} (min {ms_g[1]:.3f}); "
        f"device ms eager {prof_e['total_ms']:.3f}, graph "
        f"{prof_g['total_ms']:.3f}; idle share eager {prof_e['idle']:.4f}, "
        f"graph {prof_g['idle']:.4f}; max_memory_allocated eager "
        f"{peak_e:.3f} GiB, graph {peak_g:.3f} GiB; first graphed call (2 "
        f"warm-ups + capture) {capture_s:.2f} s")
    nums = {"eager": (ms_e[0], prof_e["total_ms"], prof_e["idle"], peak_e),
            "graph": (ms_g[0], prof_g["total_ms"], prof_g["idle"], peak_g)}
    return fwd, got, want, ms_g[0], nums


def check_nodes(fwd, imgs, dw_impl, expected=None) -> None:
    """One replay of ``fwd``'s bucket of ``imgs`` runs each port kernel as
    many times as the eager forward launches it (LAYOUTS, or
    ``expected``)."""
    got, other = replay_kernel_counts(lambda: fwd(imgs))
    want = {k: v for k, v in (expected or LAYOUTS[dw_impl][1]).items() if v}
    log(f"graph dw_impl={dw_impl!r} kernel nodes in one replay "
        f"{json.dumps(got)} expected {json.dumps(want)} (and {other} "
        f"kernels of PyTorch and its libraries, {PROFILE_PAD} of them the "
        f"window's opening pad)")
    assert got == want, "the graph's kernels differ from the eager launches"


def graph_phase(dev) -> float:
    """The test-mode forward as GraphedForward captures it, 'auto',
    'banded_chain' and 'banded_mxu_t' at 440x1024: replays against the
    eager forward ('banded_mxu_t', whose K7 walks its strips in a fixed
    order with nothing in device memory to reset, bit for bit), kernel
    nodes against EXPECTED_LAUNCHES (one replay runs K7 72 times), times;
    for 'auto' also a KITTI bucket, a flow_init bucket and two replays that
    must not alias. Returns the 'auto' graph's ms/clip."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    imgs = make_clip(dev)
    ms = None
    for dw_impl in ("auto", "banded_chain", "banded_mxu_t"):
        model = create_model("streamflow", cfg=StreamFlowConfig(
            T=T, iters=ITERS, mixed_precision=True, dw_impl=dw_impl),
            device=dev)
        init_weights(model, SEED)
        fwd, got, want, ms_g, _ = eager_then_graph(model, imgs,
                                                   f"{dw_impl}_440x1024")
        tag = f"graph dw_impl={dw_impl!r}"
        check_close(f"{tag} 440x1024 flows vs eager", got, want,
                    torch.bfloat16)
        if dw_impl == "banded_mxu_t":
            assert torch.equal(got, want), "the graph's flows differ"
            again = fwd(imgs)
            assert torch.equal(again, got), "a second replay differs"
            log(f"{tag}: two replays give the eager flows bit for bit")
        check_nodes(fwd, imgs, dw_impl)
        if dw_impl != "auto":
            continue
        ms = ms_g
        kitti = make_clip(dev, KITTI_H, KITTI_W, "kitti", SEED + 3)
        assert kitti.shape[2:4] == (376, 1248), kitti.shape
        check_close(f"{tag} KITTI bucket {tuple(kitti.shape)} vs eager",
                    fwd(kitti), model(kitti, test_mode=True), torch.bfloat16)
        again = fwd(imgs)
        assert torch.equal(again, got), "the first bucket changed"
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        init = 2.0 * torch.randn(B, T - 1, imgs.shape[2] // 8,
                                 imgs.shape[3] // 8, 2, generator=g,
                                 device=dev)
        (gf, gl), (ef, el) = fwd(imgs, init), model(imgs, flow_init=init,
                                                     test_mode=True)
        check_close(f"{tag} flow_init bucket flows vs eager", gf, ef,
                    torch.bfloat16)
        check_close(f"{tag} flow_init bucket low-res flows vs eager", gl, el,
                    torch.bfloat16)
        other = make_clip(dev, seed=SEED + 5)
        first = fwd(imgs)
        kept = first.clone()
        second = fwd(other)
        assert torch.equal(first, kept) and torch.equal(first, got), (
            "a replay changed an earlier call's output")
        assert not torch.equal(first, second)
        log(f"{tag}: {len(fwd.buckets)} buckets (440x1024, 376x1248, "
            f"440x1024 with flow_init); the first bucket replays the same "
            f"flows after the others; an earlier output is unchanged by a "
            f"later replay")
        assert len(fwd.buckets) == 3, list(fwd.buckets)
    capture_failure_raises()
    return ms


# a forward that reads a value back to the host, which no graph can hold
CAPTURE_FAILS = """
import sys
import torch
from streamflow_tpu_torch.evaluation import GraphedForward

class HostRead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1, device="cuda"))

    def forward(self, images, iters=None, flow_init=None, test_mode=True):
        return images * self.w * float(images.sum())

try:
    GraphedForward(HostRead(), 1)(torch.ones(1, 4, 8, 8, 3, device="cuda"))
except RuntimeError as e:
    assert "capture of bucket" in str(e), e
    print(str(e).splitlines()[0][:300])
else:
    sys.exit("GraphedForward did not raise")
"""


def capture_failure_raises() -> None:
    """GraphedForward raises, naming the bucket, when a forward cannot be
    captured (run in a process of its own: a failed capture may leave its
    CUDA context unusable)."""
    res = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    log(f"graph: a forward that reads a value back to the host fails to "
        f"capture and GraphedForward raises: {res.stdout.strip()}")


# ---------------------------------------------------------------- phase 28
def memory_window(rng, h, w, ids) -> dict:
    """An eval window in memory, as the validators' datasets load one:
    uint8-range images, N(0, 4^2) px flows, 70% of pixels valid."""
    import numpy as np

    return {"images": rng.integers(0, 256, (T, h, w, 3)).astype(np.float32),
            "flows": 4.0 * rng.standard_normal((T - 1, h, w, 2)).astype(
                np.float32),
            "valids": (rng.random((T - 1, h, w)) < 0.7).astype(np.float32),
            "frame_ids": np.asarray(ids, np.int32)}


def sintel_windows(rng) -> list:
    """Three 436x1024 Sintel windows, the last a tail window whose two
    first pairs are marked -1 (counted by an earlier window)."""
    return [memory_window(rng, H, W, ids) for ids in
            ((0, 1, 2, 3), (3, 4, 5, 6), (-1, -1, 6, 7))]


def serving_phase(dev) -> dict:
    """The validators' per-window steps (evaluation.window_flows,
    warm_window_flows, tiled_window_flows, pair_epes, kitti_pair_metrics)
    on in-memory clips: three 436x1024 Sintel windows (the last a tail
    window with two pairs marked -1), the same three warm-started, and
    one 375x1242 KITTI window tiled in 432x960 patches; through a
    GraphedForward ('auto'), then through the eager forward. Flows and
    metrics must agree. Returns the launch counts of the graphed side
    (its warm-ups and captures: replays make no wrapper call)."""
    import numpy as np
    import torch

    from streamflow_tpu_torch import evaluation as ev
    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=True), device=dev)
    init_weights(model, SEED)
    rng = np.random.default_rng(SEED + 6)
    sintel = sintel_windows(rng)
    kitti = memory_window(rng, KITTI_H, KITTI_W, (8, 9, 10, 11))

    def run(fwd):
        flows = [ev.window_flows(fwd, s["images"], dev) for s in sintel]
        warm, warm_flows = None, []
        for s in sintel:
            f, warm = ev.warm_window_flows(fwd, s["images"], dev, warm)
            warm_flows.append(f)
        tiled = ev.tiled_window_flows(fwd, kitti["images"], dev)
        return flows, warm_flows, tiled

    fwd = ev.GraphedForward(model, ITERS)
    reset_launches()
    graphed = run(fwd)
    counts = dict(LAUNCHES)
    eager = run(lambda x, flow_init=None: model(
        x, flow_init=flow_init, test_mode=True))
    names = [f"sintel window {i}" for i in range(3)]
    names += [f"warm window {i}" for i in range(3)] + ["tiled KITTI window"]
    for name, got, want in zip(names, [*graphed[0], *graphed[1], graphed[2]],
                               [*eager[0], *eager[1], eager[2]]):
        check_close(f"serving {name} flows, graph vs eager",
                    torch.from_numpy(got), torch.from_numpy(want),
                    torch.bfloat16)

    def metrics(run_out):
        flows, warm_flows, tiled = run_out
        epe = np.concatenate([e for f, s in zip(flows, sintel)
                              for e in ev.pair_epes(f, s, T)])
        warm = np.concatenate([e for f, s in zip(warm_flows, sintel)
                               for e in ev.pair_epes(f, s, T)])
        k_epe, k_out = ev.kitti_pair_metrics(tiled, kitti, T)
        return {"epe": float(epe.mean()), "1px": float((epe < 1).mean()),
                "pairs_px": int(epe.size), "warm_epe": float(warm.mean()),
                "kitti_tile_epe": float(k_epe),
                "kitti_tile_f1": float(100 * k_out.mean())}

    got, want = metrics(graphed), metrics(eager)
    log(f"serving harness metrics, graph {json.dumps(got)}; eager "
        f"{json.dumps(want)}; buckets {[b[0] for b in fwd.buckets]}")
    assert got["pairs_px"] == 7 * H * W, got   # 3 + 3 + 1 pairs counted
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)
    # three buckets (440x1024, the same with flow_init, the 432x960 tile),
    # each two warm-ups and one capture
    assert len(fwd.buckets) == 3, list(fwd.buckets)
    expected = {k: 9 * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"serving launches (warm-ups and captures) {json.dumps(counts)} "
        f"expected {json.dumps(expected)}")
    assert counts == expected, "launch counts differ"
    return counts


# ---------------------------------------------------------------- phase 29
def high_res_phase(dev) -> None:
    """The twin of tools/test_memory.py: 1080x1920 and 1440x2560 clips,
    T=4, 12 iterations, bf16, 'auto', eager then graphed (times, device
    time, idle share, peak memory); finite flows, graph equal to eager."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model

    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=True), device=dev)
    init_weights(model, SEED)
    for h, w in HIGH_RES:
        imgs = make_clip(dev, h, w)
        fwd, got, want, _, _ = eager_then_graph(model, imgs, f"{h}x{w}")
        assert got.shape == (B, T - 1, h, w, 2), got.shape
        assert bool(torch.isfinite(got).all()), "non-finite flows"
        check_close(f"graph {h}x{w} flows vs eager", got, want,
                    torch.bfloat16)
        del fwd, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 30
# the trainer's run: steps, and the step of its one mid-run checkpoint and
# validation; metrics read every TRAINER_PRINT steps
TRAINER_STEPS, TRAINER_PRINT, TRAINER_VAL = 6, 2, 4
TRAINER_DIR = os.path.join(ROOT, "build", "chip_smoke_trainer")


class MemoryClips:
    """A training dataset in memory with the loader's interface (``len``,
    ``load(index, rng)``): each clip drawn from the generator the loader
    hands it at the preset's crop size, uint8-range images, N(0, 4^2) px
    flows, 90% of pixels valid; with ``bidir`` the backward flows too (the
    bithings keys). No files, no augmentor."""

    def __init__(self, n, t, h, w, bidir=False):
        self.n, self.t, self.h, self.w, self.bidir = n, t, h, w, bidir

    def __len__(self):
        return self.n

    def load(self, index, rng):
        import numpy as np

        f, h, w = self.t - 1, self.h, self.w

        def flows():
            return 4.0 * rng.standard_normal((f, h, w, 2), np.float32)

        def valids():
            return (rng.random((f, h, w), np.float32) < 0.9).astype(
                np.float32)

        s = {"images": rng.integers(0, 256, (self.t, h, w, 3),
                                    np.uint8).astype(np.float32),
             "flows": flows(), "valids": valids()}
        if self.bidir:
            s["flows_bw"], s["valids_bw"] = flows(), valids()
        return s


def trainer_phase(dev) -> tuple:
    """The trainer's own loop (tools/train.py::train) at the sintel_kitti
    preset as given (B=8, 432x960, T=4, 12 iterations, lr 1.75e-4, gamma
    0.85, bf16 with f32 parameters and remat) on in-memory clips, for
    TRAINER_STEPS steps, checkpointing and validating (phase 28's Sintel
    windows, through the run's one GraphedForward) at step TRAINER_VAL.
    First every kernel of the step, and B5, against its plain version at
    the preset's batch (phase 6's checks at B=8), timed per step. Checks:
    the loader's batches on the card equal its numpy batches bit for bit;
    launches per step; finite loss and grad_norm; every parameter moved;
    the checkpoint restored into a fresh state equals the live one bit for
    bit, and one more step from each gives the same loss; after the
    weights change and are copied in place, the held graph's replay equals
    the eval model's eager forward. Logs wall ms/step of the loop, device
    ms of one profiled step, idle share, peak memory, the checkpoint's
    save ms and size. Returns the launches of the run's steps, those of
    its validation, and the kernels' numbers summed over the run's
    steps."""
    import itertools
    import shutil

    import numpy as np
    import torch

    from streamflow_tpu_torch import evaluation as ev
    from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train as trainer
    from streamflow_tpu_torch.training.checkpoint import CheckpointManager
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    args = trainer.parse_args([
        "--preset", "sintel_kitti", "--validation", "sintel",
        "--num_steps", str(TRAINER_STEPS), "--print_freq", str(TRAINER_PRINT),
        "--val_freq", str(TRAINER_VAL), "--output", TRAINER_DIR])
    h, w = args.image_size
    b, t = args.batch_size, args.T
    assert (b, t, h, w, args.iters, args.lr, args.gamma, args.stage) == (
        8, 4, 432, 960, ITERS, 1.75e-4, 0.85, "sintel"), vars(args)
    assert args.mixed_precision and args.device == "cuda"

    # the step's kernels at the trainer's shapes, timed per step, then
    # summed over the run's steps (the calls its launches count)
    per_step_summary = {"auto": new_summary()}
    kernel_checks(dev, per_step_summary, h, w, True, batch=b)
    backward_checks(dev, list(per_step_summary.values()), batch=b)
    steps_summary = scaled_summary(per_step_summary["auto"], TRAINER_STEPS)

    dataset = MemoryClips(8 * b, t, h, w)

    # the loader's first batches (the run's: same dataset, batch and seed)
    # through the prefetch ring of 3 pinned buffers, the fourth refilling
    # the first's
    loader = DataLoader(dataset, b, num_workers=args.num_workers,
                        seed=args.seed)
    host = list(itertools.islice(loader.epoch(0), 4))
    for i, got in enumerate(prefetch_to_device(iter(host), dev)):
        for k, v in host[i].items():
            assert got[k].device == dev and torch.equal(
                got[k].cpu(), torch.from_numpy(v)), (i, k)
    first = {k: torch.from_numpy(v).to(dev) for k, v in host[0].items()}
    log(f"trainer: the loader's first 4 batches ({b}x{t}x{h}x{w}) through "
        f"prefetch_to_device equal its numpy batches bit for bit")

    windows = sintel_windows(np.random.default_rng(SEED + 6))
    val_counts = dict.fromkeys(KERNELS, 0)

    def validate(fwd):
        before = dict(LAUNCHES)
        epes = np.concatenate([
            e for s in windows
            for e in ev.pair_epes(ev.window_flows(fwd, s["images"], dev), s,
                                  t)])
        for k in KERNELS:
            val_counts[k] += LAUNCHES[k] - before[k]
        return {"clean_epe": float(epes.mean()),
                "clean_1px": float((epes < 1).mean()),
                "clean_3px": float((epes < 3).mean()),
                "clean_5px": float((epes < 5).mean())}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run = trainer.train(args, dataset, validate)
    run_s = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = train_launches(t, h, w)
    assert per_step == EXPECTED_TRAIN_LAUNCHES
    # the windows' bucket (padded to 440x1024): 2 warm-ups and the capture
    want_val = {k: 3 * v for k, v in forward_launches(
        args.val_iters, t, -(-H // 8) * 8, W).items()}
    steps_counts = {k: counts[k] - val_counts[k] for k in KERNELS}
    log(f"trainer launches: {TRAINER_STEPS} steps "
        f"{json.dumps(steps_counts)} expected {TRAINER_STEPS} x "
        f"{json.dumps(per_step)}; validation {json.dumps(val_counts)} "
        f"expected {json.dumps(want_val)}")
    assert steps_counts == {k: TRAINER_STEPS * v
                            for k, v in per_step.items()}, "step launches"
    assert val_counts == want_val, "validation launches"

    state = run.state
    assert state.step == TRAINER_STEPS and len(run.step_t) == TRAINER_STEPS
    out = os.path.join(TRAINER_DIR, args.name)
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train_rec = [r for r in records if "loss" in r]
    assert [r["step"] for r in train_rec] == list(
        range(TRAINER_PRINT, TRAINER_STEPS + 1, TRAINER_PRINT)), records
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in train_rec), train_rec
    assert [r["step"] for r in records if "val" in r] == [TRAINER_VAL]
    assert os.path.exists(os.path.join(out, "best.npz"))
    assert math.isfinite(run.val["clean_epe"]), run.val

    # every parameter moved from the seeded start
    fresh = create_model("streamflow", cfg=state.model.cfg, device=dev,
                         train=True)
    init_weights(fresh, args.seed)
    still = [n for (n, p), q in zip(state.model.named_parameters(),
                                    fresh.parameters()) if torch.equal(p, q)]
    assert not still, f"parameters that did not move: {still[:5]}"

    # the last checkpoint (step TRAINER_STEPS, written by the final save)
    # restored into a fresh state equals the live state bit for bit
    mgr = CheckpointManager(os.path.join(out, "ckpts"))
    assert mgr.all_steps() == [TRAINER_VAL, TRAINER_STEPS], mgr.all_steps()
    restored = mgr.restore(TrainState.create(
        fresh, args.lr, args.num_steps, args.wdecay, args.epsilon, args.clip))
    for (n, p), q in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(p, q), n
    live_opt = state.optimizer.state_dict()["state"]
    rest_opt = restored.optimizer.state_dict()["state"]
    assert live_opt.keys() == rest_opt.keys()
    for i, st in live_opt.items():
        for k, v in st.items():
            assert torch.equal(v, rest_opt[i][k]), (i, k)
    saved = (restored.step, restored.lr, restored.scheduler.last_epoch)
    assert saved == (state.step, state.lr, state.scheduler.last_epoch)
    step = make_train_step(args.gamma, args.iters)
    m_live, m_rest = step(state, first), step(restored, first)
    l_live, l_rest = float(m_live["loss"]), float(m_rest["loss"])
    rel = abs(l_rest - l_live) / abs(l_live)
    log(f"trainer checkpoint: step {TRAINER_STEPS} restored into a fresh "
        f"state equals the live one bit for bit ({len(live_opt)} parameters "
        f"with their AdamW moments and step counts; step, lr, last_epoch "
        f"{saved}); one more "
        f"step: loss live {l_live!r} restored {l_rest!r}, rel diff "
        f"{rel:.3e} (bound {GRAD_TOL}), grad_norm "
        f"{float(m_live['grad_norm']):.6g} / "
        f"{float(m_rest['grad_norm']):.6g}")
    assert rel <= GRAD_TOL, (l_live, l_rest)

    # the held graph reads the eval model's weights by address: after the
    # weights change, copied in place, its replay is the eager forward
    fwd = run.fwd
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    with torch.no_grad():
        for p in restored.model.parameters():
            p.add_(0.05 * p.abs().mean() * torch.randn(
                p.shape, generator=g, device=dev))
    img = windows[0]["images"]
    stale = ev.window_flows(fwd, img, dev)
    fwd.model.load_state_dict(restored.model.state_dict())
    got = ev.window_flows(fwd, img, dev)
    want = ev.window_flows(lambda x: fwd.model(x, iters=args.val_iters,
                                               test_mode=True), img, dev)
    err = check_close("trainer graph after the in-place copy vs eager",
                      torch.from_numpy(got), torch.from_numpy(want),
                      torch.bfloat16)
    stale_err = float(np.abs(stale - want).max())
    log(f"trainer graph: replay before the copy differs from the eager "
        f"forward by {stale_err:.4g} px, after it by {err:.4g}")
    assert stale_err > 10 * max(err, 1e-3), (stale_err, err)
    del restored, fresh, m_rest

    # times: the loop between the synchronizing prints of steps
    # TRAINER_PRINT and TRAINER_STEPS, less the checkpoint and validation
    n = TRAINER_STEPS - TRAINER_PRINT
    loop_ms = 1e3 * (run.step_t[-1] - run.step_t[TRAINER_PRINT - 1]
                     - run.save_s[0] - run.val_s[0]) / n
    prof = profile_device(lambda: step(state, first), loop_ms, "trainer")
    timing = CheckpointManager(os.path.join(TRAINER_DIR, "timing"))
    t0 = time.perf_counter()
    timing.save(state)
    snap_ms = 1e3 * (time.perf_counter() - t0)
    timing.wait_until_finished()
    write_ms = 1e3 * (time.perf_counter() - t0) - snap_ms
    size = os.path.getsize(timing.path(state.step))
    log(f"trainer {b}x{t}x{h}x{w} iters {args.iters} bf16 + f32 params + "
        f"remat, {TRAINER_STEPS} steps in {run_s:.1f} s: wall ms/step of the "
        f"loop {loop_ms:.3f} (steps {TRAINER_PRINT + 1}-{TRAINER_STEPS}, "
        f"checkpoint and validation taken out), device ms/step "
        f"{prof['total_ms']:.3f}, idle share {prof['idle']:.4f}; "
        f"max_memory_allocated {peak:.3f} GiB; checkpoint "
        f"{size / 2 ** 20:.1f} MiB: in the loop {1e3 * run.save_s[0]:.1f} ms "
        f"(host copy; write on a thread), final save (waited) "
        f"{1e3 * run.save_s[-1]:.1f} ms, alone host copy {snap_ms:.1f} ms + "
        f"write {write_ms:.1f} ms; validation (3 windows, capture of a "
        f"{args.val_iters}-iteration graph) {run.val_s[0]:.2f} s; val "
        f"{json.dumps(run.val)}")
    del run, state, fwd
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return steps_counts, val_counts, steps_summary


# ---------------------------------------------------------------- phase 31
def stage_forms_phase(dev) -> None:
    """One step each, B=1, of the stage forms the trainer selects at its
    presets' crops: things (T=3, 400x720), kitti (the sintel_kitti crop,
    T=4, 432x960, last pair only) and bithings (T=3, 400x720, the
    time-reversed clip folded into the batch); launches (derived from the
    shape: at 400x720, T=3 only stage 0's GSA blocks run K3), finite loss,
    every parameter moved. Then phase 8's training guard at T=3."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train as trainer
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step

    for preset, stage in (("things", "things"), ("sintel_kitti", "kitti"),
                          ("bithings", "bithings")):
        args = trainer.parse_args(["--preset", preset, "--stage", stage,
                                   "--batch_size", "1"])
        h, w = args.image_size
        t = args.T
        bidir = stage == "bithings"
        cfg = StreamFlowConfig(T=t, iters=args.iters,
                               mixed_precision=args.mixed_precision,
                               remat=True)
        model = create_model("streamflow", cfg=cfg, device=dev, train=True)
        init_weights(model, SEED)
        state = TrainState.create(model, args.lr, args.num_steps, args.wdecay,
                                  args.epsilon, args.clip)
        loader = DataLoader(MemoryClips(1, t, h, w, bidir), 1,
                            num_workers=1, seed=args.seed)
        batch = next(iter(prefetch_to_device(loader.epoch(0), dev)))
        step = make_train_step(args.gamma, args.iters,
                               kitti_last_pair_only=stage == "kitti",
                               bidirectional=bidir)
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(LAUNCHES)
        expected = train_launches(t, h, w)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        still = [n for (n, p), q in zip(model.named_parameters(), before)
                 if torch.equal(p, q)]
        log(f"stage {stage} (preset {preset}) B=1{'+1 reversed' * bidir} "
            f"T={t} {h}x{w}: launches {json.dumps(counts)} expected "
            f"{json.dumps(expected)}; loss {loss:.6g} grad_norm {norm:.6g} "
            f"epe {float(m['epe']):.6g}"
            + (f" epe_bw {float(m['epe_bw']):.6g}" if bidir else "")
            + f"; {len(before) - len(still)} of {len(before)} parameters "
            f"moved; first step {ms:.1f} ms")
        assert counts == expected, "launch counts differ"
        assert math.isfinite(loss) and math.isfinite(norm), (loss, norm)
        assert not still, f"parameters that did not move: {still[:5]}"
        del model, state, batch, m, before
        torch.cuda.empty_cache()
    training_guard(dev, "auto", t=3)


# ---------------------------------------------------------------- phase 32
def zoo_phase(dev) -> dict:
    """The ablation configs (ZOO), each in the default layout at 440x1024,
    B=1, T=4, 12 iterations, bf16, seeded random weights: phase 4's
    forward (exact launches, the Twins MLPs' K2 forms, ms/clip, device
    time, idle share, peak memory), phase 5's accuracy guards at
    ZOO_GUARD_H x ZOO_GUARD_W, for 'basic' one GraphedForward replay equal
    to the eager forward bit for bit (BatchNorm on its running
    statistics, which the capture leaves as they were), and for
    ZOO_TRAINED two train steps of phase 7's form. Returns the launches
    of each path."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.training.step import batch_stats

    counts = {}
    for name in ZOO:
        counts["inference_" + name], _ = full_forward(dev, "auto", name)
        accuracy_guards(dev, "auto", {}, name, ZOO_GUARD_H, ZOO_GUARD_W)
        if name == "basic":
            model = create_model("streamflow", cfg=StreamFlowConfig(
                T=T, iters=ITERS, mixed_precision=True, **ZOO[name]),
                device=dev)
            init_weights(model, SEED)
            stats = [t.clone() for t in batch_stats(model)]
            imgs = make_clip(dev)
            fwd, got, want, _, _ = eager_then_graph(model, imgs,
                                                    f"{name}_440x1024")
            assert torch.equal(got, want), "the graph's flows differ"
            check_nodes(fwd, imgs, "auto", zoo_launches(name))
            assert all(torch.equal(a, b) for a, b in
                       zip(batch_stats(model), stats)), "statistics moved"
            log(f"graph config {name!r}: a replay gives the eager flows bit "
                f"for bit; the {len(stats)} running statistics unchanged")
            del model, fwd
        if name in ZOO_TRAINED:
            counts["train_step_" + name] = zoo_train_steps(dev, name)
        torch.cuda.empty_cache()
    log("ms/clip, device ms, idle share and peak GiB (above what the "
        "process held before the model was built) by config, 440x1024 T=4 "
        "12 iterations bf16 ('auto'): " + json.dumps(ZOO_TABLE))
    return counts


def zoo_train_steps(dev, name) -> dict:
    """Two train steps of a ZOO config (432x960, B=1, T=4, 12 iterations,
    bf16 with f32 parameters, remat; 'basic' bidirectional, the reversed
    clip in a second application): launches of the first step exactly,
    finite losses, every parameter moved; with BatchNorm, the running
    statistics after the first step equal one update from the reversed
    clip alone (the cnet's train-mode forward of it from the pre-step
    statistics), not the forward clip's, and move again in the second."""
    import copy

    import torch

    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.training.step import (batch_stats,
                                                    make_train_step)

    bidir = ZOO_TRAINED[name] == 2
    state, batch = train_setup(dev, TRAIN_H, TRAIN_W, ITERS, True, SEED,
                               "auto", zoo=name, bidir=bidir)
    model = state.model
    step = make_train_step(gamma=0.85, iters=ITERS, bidirectional=bidir)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    derived = {}
    if batch_stats(model):
        x = (2.0 * (batch["images"].float() / 255.0) - 1.0).to(model.dtype)
        for clip, xx in (("reversed", x.flip(1)), ("forward", x)):
            ref = copy.deepcopy(model)
            with torch.no_grad():
                ref.cnet(xx[:, :-1], True)
            derived[clip] = [t.clone() for t in batch_stats(ref)]
            del ref
    torch.cuda.synchronize()
    reset_launches()
    times, losses = [], []
    for i in range(2):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            counts = dict(LAUNCHES)
            after1 = [t.clone() for t in batch_stats(model)]
    expected = zoo_launches(name, True, h=TRAIN_H, w=TRAIN_W)
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    extra = ""
    if derived:
        err = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
                  for a, b in zip(after1, derived["reversed"]))
        off = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
                  for a, b in zip(after1, derived["forward"]))
        moved = all(not torch.equal(a, b)
                    for a, b in zip(batch_stats(model), after1))
        extra = (f"; running statistics after step 1 against one update from "
                 f"the reversed clip alone: max rel err {err:.3e} (bound "
                 f"1e-3), against the forward clip's {off:.3e}; "
                 f"{len(after1)} moved again in step 2: {moved}")
    log(f"train step config {name!r} B=1{'+1 reversed' * bidir} T={T} "
        f"{TRAIN_H}x{TRAIN_W}: launches {json.dumps(counts)} expected "
        f"{json.dumps(expected)}; loss, grad_norm {losses}; ms per step "
        f"{[round(t, 1) for t in times]}; {len(before) - len(still)} of "
        f"{len(before)} parameters moved" + extra)
    assert counts == expected, "train launch counts differ"
    assert all(math.isfinite(v) for pair in losses for v in pair), losses
    assert not still, f"parameters that did not move: {still[:5]}"
    if derived:
        assert err <= 1e-3 < off and moved, (err, off, moved)
    del state, batch, model
    return counts


# ---------------------------------------------------------------- phase 33
def make_pair(dev, h=H, w=W, b=1, seed=SEED):
    """A seeded pair of b x h x w uint8-range images, padded in 'sintel'
    mode, on ``dev``."""
    import torch

    from streamflow_tpu_torch.ops.padding import InputPadder

    g = torch.Generator().manual_seed(seed)
    padder = InputPadder((h, w, 3), mode="sintel")
    return tuple(padder.pad(torch.randint(0, 256, (b, h, w, 3),
                                          generator=g).float()).to(dev)
                 for _ in range(2))


def raft_forward(dev, name) -> dict:
    """The two-frame model ``name`` at validate_sintel_2f's shape and depth
    (bf16, seeded random weights): the eager test-mode forward with exact
    launches (raft_launches), finite flows of the padded shape, ms/clip,
    device time, idle share and peak memory; then GraphedForward2F: its
    flows equal the eager ones bit for bit, one replay runs each port
    kernel as often as the eager forward launches it, ms/clip and device
    time. Keeps the numbers in RAFT_TABLE; returns the launches."""
    import torch

    from streamflow_tpu_torch.evaluation import GraphedForward2F
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools.common import host_ms

    held = torch.cuda.memory_allocated()
    model = create_model(name, device=dev, iters=RAFT_ITERS)
    init_weights(model, SEED)
    im1, im2 = make_pair(dev)
    hp, wp = im1.shape[1:3]

    def eager():
        return model(im1, im2, test_mode=True)

    eager()                                     # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lowres, flow = eager()
    torch.cuda.synchronize()
    counts, expected = dict(LAUNCHES), raft_launches(name)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    log(f"forward 2f {name!r} launches {json.dumps(counts)} expected "
        f"{json.dumps(expected)}")
    assert counts == expected, "launch counts differ"
    assert flow.shape == (1, hp, wp, 2) and lowres.shape == (
        1, hp // 8, wp // 8, 2), (flow.shape, lowres.shape)
    assert bool(torch.isfinite(flow).all()), "non-finite flows"
    mag = flow.norm(dim=-1)
    ms_e = host_ms(eager, REPS, dev)
    prof_e = profile_device(eager, ms_e[0], f"forward_{name}")

    fwd = GraphedForward2F(model, RAFT_ITERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = fwd(im1, im2)
    assert torch.equal(got, flow), "the graph's flows differ from eager"
    assert torch.equal(fwd(im1, im2), flow), "a second replay differs"
    peak_g = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    nodes, other = replay_kernel_counts(lambda: fwd(im1, im2))
    want = {k: v for k, v in expected.items() if v}
    log(f"graph 2f {name!r} kernel nodes in one replay {json.dumps(nodes)} "
        f"expected {json.dumps(want)} (and {other} kernels of PyTorch and "
        f"its libraries)")
    assert nodes == want, "the graph's kernels differ from the eager launches"
    ms_g = host_ms(lambda: fwd(im1, im2), REPS, dev)
    prof_g = profile_device(lambda: fwd(im1, im2), ms_g[0],
                            f"graph_{name}")
    RAFT_TABLE[name] = dict(
        ms_clip=round(ms_e[0], 3), ms_clip_graph=round(ms_g[0], 3),
        device_ms=round(prof_e["total_ms"], 3),
        device_ms_graph=round(prof_g["total_ms"], 3),
        idle=round(prof_e["idle"], 4), idle_graph=round(prof_g["idle"], 4),
        peak_gib=round(peak, 3), peak_gib_graph=round(peak_g, 3))
    log(f"forward 2f {name!r} {tuple(im1.shape)} {RAFT_ITERS} iterations "
        f"bf16: ms/clip eager {ms_e[0]:.3f} (mean of {REPS}, min "
        f"{ms_e[1]:.3f}), graph {ms_g[0]:.3f} (min {ms_g[1]:.3f}); device "
        f"ms {prof_e['total_ms']:.3f} / {prof_g['total_ms']:.3f}; idle "
        f"share {prof_e['idle']:.4f} / {prof_g['idle']:.4f}; peak GiB above "
        f"what the process held {peak:.3f} / {peak_g:.3f}; the graph's "
        f"flows equal eager bit for bit; |flow| px mean "
        f"{float(mag.mean()):.4g} max {float(mag.max()):.4g}")
    del model, fwd
    return counts


def raft_guards(dev, name, h=ZOO_GUARD_H, w=ZOO_GUARD_W) -> None:
    """Phase 5's accuracy guards for a two-frame model: iters=1, one h x w
    pair, the same weights, the kernel path on the card and the plain
    path on the CPU, each in f32 and bf16, against the f32 plain path."""
    import copy

    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.tools.common import rel_epe

    im1, im2 = make_pair("cpu", h, w)
    flows = {}
    for dtype in ("float32", "bfloat16"):
        cpu_model = create_model(name, device="cpu", iters=1,
                                 mixed_precision=dtype == "bfloat16")
        init_weights(cpu_model, SEED + 1)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        flows[dtype, "card"] = gpu_model(im1.to(dev), im2.to(dev),
                                         test_mode=True)[1].float().cpu()
        flows[dtype, "cpu"] = cpu_model(im1, im2, test_mode=True)[1].float()
    ref = flows["float32", "cpu"]
    mag = ref.norm(dim=-1)
    f32 = rel_epe(flows["float32", "card"], ref)
    bf16, bf16_plain = (rel_epe(flows["bfloat16", where], ref)
                        for where in ("card", "cpu"))
    log(f"accuracy guard 2f {name!r} {h}x{w} iters=1 against the f32 plain "
        f"path (|flow_ref| px mean {float(mag.mean()):.4g} max "
        f"{float(mag.max()):.4g}), rel EPE global / per-pixel p99: f32 "
        f"kernels {f32[0]:.3e} / {f32[1]:.3e} (bound {F32_GUARD_TOL} each);"
        f" bf16 kernels {bf16[0]:.3e} / {bf16[1]:.3e}, bf16 plain "
        f"{bf16_plain[0]:.3e} / {bf16_plain[1]:.3e} (bound "
        f"{BF16_GUARD_RATIO}x the plain)")
    assert all(math.isfinite(v) and v < F32_GUARD_TOL for v in f32), f32
    assert all(math.isfinite(k) and k <= BF16_GUARD_RATIO * p
               for k, p in zip(bf16, bf16_plain)), (bf16, bf16_plain)


def raft_train_steps(dev, name) -> dict:
    """Two make_train_step_2f steps of ``name`` (f32 parameters, bf16
    compute, seeded weights and batch) at train_2f's defaults: the first
    step's launches exactly (B5 counting its two kernels),
    finite losses, every parameter moved; the running statistics after
    the first step equal one update from the batch's first images (the
    cnet's train-mode forward of them from the pre-step statistics) and
    move again in the second; ms/step, device ms of a profiled step, idle
    share and peak memory."""
    import copy

    import torch

    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import (batch_stats,
                                                    make_train_step_2f)

    held = torch.cuda.memory_allocated()
    model = create_model(name, device=dev, train=True,
                         iters=RAFT_TRAIN_ITERS)
    init_weights(model, SEED)
    state = TrainState.create(model, lr=RAFT_LR, num_steps=100_000,
                              weight_decay=RAFT_WD)
    batch = synthetic_batch(RAFT_TRAIN_B, 2, RAFT_TRAIN_H, RAFT_TRAIN_W,
                            SEED, dev)
    step = make_train_step_2f(RAFT_GAMMA, RAFT_TRAIN_ITERS)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref = copy.deepcopy(model)
    with torch.no_grad():
        x = (2.0 * (batch["images"][:, 0] / 255.0) - 1.0).to(ref.dtype)
        ref.cnet(x, True)
    derived = [t.clone() for t in batch_stats(ref)]
    del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = [], []
    for i in range(2):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            counts = dict(LAUNCHES)
            after1 = [t.clone() for t in batch_stats(model)]
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    expected = raft_launches(name, True)
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    err = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
              for a, b in zip(after1, derived))
    moved = all(not torch.equal(a, b)
                for a, b in zip(batch_stats(model), after1))
    prof = profile_device(lambda: step(state, batch), times[1],
                          f"train_step_{name}")
    RAFT_TABLE.setdefault(name, {}).update(
        ms_step=[round(t, 3) for t in times],
        device_ms_step=round(prof["total_ms"], 3),
        idle_step=round(prof["idle"], 4), peak_gib_step=round(peak, 3))
    log(f"train step 2f {name!r} B={RAFT_TRAIN_B} {RAFT_TRAIN_H}x"
        f"{RAFT_TRAIN_W} iters {RAFT_TRAIN_ITERS} bf16 + f32 params: "
        f"launches {json.dumps(counts)} expected {json.dumps(expected)}; "
        f"loss, grad_norm {losses}; ms per step "
        f"{[round(t, 1) for t in times]} (the first with its warm-up), "
        f"device ms {prof['total_ms']:.3f}, idle share {prof['idle']:.4f}, "
        f"peak GiB above what the process held {peak:.3f}; "
        f"{len(before) - len(still)} of {len(before)} parameters moved; "
        f"running statistics after step 1 against one update from the "
        f"batch: max rel err {err:.3e} (bound 1e-3); {len(after1)} moved "
        f"again in step 2: {moved}")
    assert counts == expected, "train launch counts differ"
    assert all(math.isfinite(v) for pair in losses for v in pair), losses
    assert not still, f"parameters that did not move: {still[:5]}"
    assert len(after1) == 30 and err <= 1e-3 and moved, (err, moved)
    del state, batch, model
    torch.cuda.empty_cache()
    return counts


def raft_trainer(dev) -> None:
    """SKFlow through tools/train_2f.py's loop (``train``) at its defaults
    (B=8, 368x496, 12 iterations, bf16) on in-memory pairs for
    RAFT_TRAINER_STEPS steps, checkpointing at step RAFT_TRAINER_CKPT and
    at the end: launches per step exactly, finite metrics every step,
    the last checkpoint restored into a fresh state equal to the live one
    bit for bit (parameters, AdamW state, running statistics, step, lr),
    and one more step from each giving the same loss."""
    import shutil

    import torch

    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train_2f
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.checkpoint import CheckpointManager
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import make_train_step_2f

    shutil.rmtree(RAFT_TRAINER_DIR, ignore_errors=True)
    args = train_2f.build_parser().parse_args([
        "--model", "sk", "--num_steps", str(RAFT_TRAINER_STEPS),
        "--val_freq", str(RAFT_TRAINER_CKPT), "--print_freq", "1",
        "--output", RAFT_TRAINER_DIR])
    b, (h, w) = args.batch_size, args.image_size
    assert (b, h, w, args.iters, args.lr, args.wdecay, args.gamma) == (
        RAFT_TRAIN_B, RAFT_TRAIN_H, RAFT_TRAIN_W, RAFT_TRAIN_ITERS, RAFT_LR,
        RAFT_WD, RAFT_GAMMA), vars(args)
    assert args.mixed_precision and args.device == "cuda"
    dataset = MemoryClips(4 * b, 2, h, w)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    run = train_2f.train(args, dataset)
    run_s = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    want = {k: RAFT_TRAINER_STEPS * v
            for k, v in raft_launches("skflow", True).items()}
    state = run.state
    out = os.path.join(RAFT_TRAINER_DIR, args.name)
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    gaps = [round(1e3 * (t1 - t0), 1)
            for t0, t1 in zip(run.step_t, run.step_t[1:])]
    log(f"trainer 2f 'skflow': {RAFT_TRAINER_STEPS} steps in {run_s:.1f} s "
        f"(ms between the ends of steps {gaps}, checkpoint saves "
        f"{[round(1e3 * x, 1) for x in run.save_s]} ms); launches "
        f"{json.dumps(counts)} expected {json.dumps(want)}; losses "
        f"{[round(r['loss'], 6) for r in records]}")
    assert counts == want, "trainer launches"
    assert state.step == RAFT_TRAINER_STEPS
    assert [r["step"] for r in records] == list(
        range(1, RAFT_TRAINER_STEPS + 1)), records
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in records), records

    mgr = CheckpointManager(os.path.join(out, "ckpts"))
    assert mgr.all_steps() == [RAFT_TRAINER_CKPT, RAFT_TRAINER_STEPS]
    fresh = create_model("skflow", cfg=state.model.cfg, device=dev,
                         train=True)
    restored = mgr.restore(TrainState.create(
        fresh, args.lr, args.num_steps, args.wdecay, clip=args.clip))
    live_sd, rest_sd = state.model.state_dict(), restored.model.state_dict()
    for k, t in live_sd.items():
        assert torch.equal(t, rest_sd[k]), k
    live_opt = state.optimizer.state_dict()["state"]
    rest_opt = restored.optimizer.state_dict()["state"]
    for i, st in live_opt.items():
        for k, v in st.items():
            assert torch.equal(v, rest_opt[i][k]), (i, k)
    assert (restored.step, restored.lr) == (state.step, state.lr)
    batch = synthetic_batch(b, 2, h, w, SEED + 8, dev)
    step = make_train_step_2f(args.gamma, args.iters)
    l_live = float(step(state, batch)["loss"])
    l_rest = float(step(restored, batch)["loss"])
    rel = abs(l_rest - l_live) / abs(l_live)
    log(f"trainer 2f checkpoint: step {RAFT_TRAINER_STEPS} restored into a "
        f"fresh state equals the live one bit for bit ({len(live_sd)} "
        f"tensors, the 30 running statistics among them; AdamW state, step, "
        f"lr); one more step: loss live {l_live!r} restored {l_rest!r}, "
        f"rel diff {rel:.3e} (bound {GRAD_TOL})")
    assert rel <= GRAD_TOL, (l_live, l_rest)
    del run, state, restored, fresh
    shutil.rmtree(RAFT_TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def raft_phase(dev) -> dict:
    """The two-frame baselines (RAFT_MODELS): each one's forward and graph
    at 440x1024 with 32 iterations, its accuracy guards at
    ZOO_GUARD_H x ZOO_GUARD_W and two train steps at train_2f's defaults;
    then SKFlow through train_2f's loop with a checkpoint and an exact
    resume. Returns the launches of each path."""
    counts = {}
    for name in RAFT_MODELS:
        counts["inference_" + name] = raft_forward(dev, name)
        raft_guards(dev, name)
        counts["train_step_" + name] = raft_train_steps(dev, name)
    raft_trainer(dev)
    log("two-frame baselines (NVIDIA card as above): 440x1024 "
        f"{RAFT_ITERS} iterations bf16 B=1, and steps at B={RAFT_TRAIN_B} "
        f"{RAFT_TRAIN_H}x{RAFT_TRAIN_W} {RAFT_TRAIN_ITERS} iterations: "
        + json.dumps(RAFT_TABLE))
    return counts


# ---------------------------------------------------------------- phase 35
def umt_phase(dev) -> dict:
    """StreamFlow with the UMT encoder at decoder_dim=768, served: seeded
    random weights, a 436x1024 clip padded to 448x1024, B=1, T=4, 12
    iterations, bf16, test mode. The eager forward with exact launches
    (umt_launches), finite flows of the padded shape, ms/clip, device
    time by op group, idle share and peak memory; then GraphedForward:
    its flows against the eager ones (logged whether bit for bit), a
    second replay the same, one replay's kernel nodes against the eager
    launches, ms/clip, device time, idle share, peak memory; phase 5's
    accuracy guards at UMT_GUARD_H x UMT_GUARD_W. Returns the
    launches."""
    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    held = torch.cuda.memory_allocated()
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=ITERS, mixed_precision=True, **UMT_KW), device=dev)
    init_weights(model, SEED)
    imgs = make_clip(dev, factor=16)
    assert imgs.shape[2:4] == (UMT_H, UMT_W), imgs.shape
    model(imgs, test_mode=True)                 # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    flows = model(imgs, test_mode=True)
    torch.cuda.synchronize()
    counts, expected = dict(LAUNCHES), umt_launches()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    log(f"forward umt launches {json.dumps(counts)} expected "
        f"{json.dumps(expected)}")
    assert counts == expected, "launch counts differ"
    assert flows.shape == (B, T - 1, UMT_H, UMT_W, 2), flows.shape
    assert bool(torch.isfinite(flows).all()), "non-finite flows"
    mag = flows.norm(dim=-1)
    fwd, got, want, _, nums = eager_then_graph(model, imgs,
                                               f"umt_{UMT_H}x{UMT_W}")
    check_close("graph umt flows vs eager", got, want, torch.bfloat16)
    same = bool(torch.equal(got, want))
    assert torch.equal(fwd(imgs), got), "a second replay differs"
    check_nodes(fwd, imgs, "auto", expected)
    log(f"forward umt {tuple(imgs.shape)} {ITERS} iterations bf16, eager / "
        f"graph: ms/clip, device ms, idle share, peak GiB "
        + json.dumps({k: [round(v, 4) for v in n] for k, n in nums.items()})
        + f"; the counted eager forward's peak above what the process held "
        f"{peak:.3f} GiB; the graph's flows equal eager "
        + ("bit for bit" if same else "within the bf16 rule, not bit for "
           "bit") + f"; |flow| px mean {float(mag.mean()):.4g} max "
        f"{float(mag.max()):.4g}")
    del model, fwd
    torch.cuda.empty_cache()
    accuracy_guards(dev, "auto", {}, "umt", UMT_GUARD_H, UMT_GUARD_W,
                    fields=UMT_KW, factor=16)
    return counts


# ---------------------------------------------------------------- phase 34
# data-parallel training (streamflow_tpu_torch/parallel/), in processes of
# its own (``python chip_smoke.py --dp PART RANK WORLD BACKEND STORE``), so
# that no other phase holds a process group:
# (a) a one-rank NCCL group against the plain step (part "a");
# (b) two ranks sharing the card over gloo against one process on the
#     same global batch, f32, then (c) tools/train.py::train with two ranks
#     over gloo, in the same two processes (part "bc").
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")
DP_STEPS = 3                 # (a): steps of each side, canonical
# (a): the group's state after DP_STEPS steps against its nearest plain
# run, relative L2 of all parameters and buffers, of all first and of all
# second AdamW moments; its metrics against each plain run's. Two plain
# runs have differed by up to 4.2e-7, 5.4e-4 and 4.4e-4, their losses by
# 3.5e-5 (H100, B5's atomic sums amplified by random weights over 3
# steps): the bounds leave 18-28x
DP_A_REL = {"model": 1e-5, "exp_avg": 1e-2, "exp_avg_sq": 1e-2}
DP_A_METRIC_RTOL = 1e-3
# the px rates: a few of the 1.24M pixels a step crossing a threshold
DP_A_METRIC_ATOL = 1e-4
DP_TIMED = 2                 # (a): rounds of timed steps, 2 a side each
DP2_B, DP2_ITERS = 2, 2      # (b): the global batch, iterations
# (b): name -> (model, config fields, bidirectional)
DP2_FORMS = {"canonical": ("streamflow", {}, False),
             "basic": ("streamflow", {"encoder": "basic"}, False),
             "bithings": ("streamflow", {}, True),
             "basic_bidir": ("streamflow", {"encoder": "basic"}, True),
             "raft": ("raft", {}, False)}
# (b): JAX's tolerances for its sharded step against the unsharded one
# (tests/test_training_infra.py:173-182)
DP2_LOSS_RTOL, DP2_PARAM_ATOL, DP2_PARAM_RTOL = 1e-5, 3e-5, 2e-3
DP_TRAINER_STEPS, DP_TRAINER_VAL = 4, 2     # (c)
DP_TIMEOUT = 600             # seconds a part's processes may take


def dp_run(part: str, world: int, backend: str) -> list:
    """Part ``part`` of phase 34 in ``world`` processes on the card (a
    file store under DP_DIR for the rendezvous); returns each rank's
    record. Raises if a process fails or outlasts DP_TIMEOUT; kills every
    process it started before it returns or raises."""
    import shutil

    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    store = os.path.join(DP_DIR, f"store_{part}")
    # (a) compares two steps bit for bit: cuBLAS needs a fixed workspace
    # for deterministic results
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp", part, str(r),
         str(world), backend, store], cwd=ROOT, env=env)
        for r in range(world)]
    try:
        for p in procs:
            if p.wait(timeout=DP_TIMEOUT):
                raise AssertionError(f"phase 34 ({part}): a process exited "
                                     f"with {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r in range(world):
        with open(os.path.join(DP_DIR, f"{part}_{r}.json")) as fh:
            recs.append(json.load(fh))
    shutil.rmtree(DP_DIR, ignore_errors=True)
    return recs


def dp_worker(part, rank, world, backend, store) -> None:
    """One process of phase 34: joins the group, runs its part, writes
    its record to DP_DIR/<part>_<rank>.json."""
    t0 = time.perf_counter()
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from streamflow_tpu_torch import _build, parallel
    from streamflow_tpu_torch.parallel import multihost

    _build.library()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    t1 = time.perf_counter()
    assert parallel.initialize(f"file://{store}", world, rank,
                               backend=backend, device=dev) == (rank, world)
    log(f"phase 34 ({part}) rank {rank}: torch, the kernels and the card "
        f"{t1 - t0:.1f} s, the {backend} group {time.perf_counter() - t1:.1f}"
        f" s")
    try:
        if part == "a":
            rec = dp_one_rank(dev, rank, world)
        else:             # (b) then (c), in the same two processes
            rec = {"b": dp_two_ranks(dev, rank, world)}
            torch.cuda.empty_cache()
            rec["c"] = dp_trainer(dev, rank, world)
    finally:
        multihost.shutdown()
    with open(os.path.join(DP_DIR, f"{part}_{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def device_ms(fn) -> float:
    """The device time (ms, kernels and copies summed) of one call of
    ``fn``, from a profile that records the card's activity alone (a
    traced warm-up call first, as tools/common.py::profiled): a cheaper
    trace than profile_device's, which records the host's ops too."""
    from streamflow_tpu_torch.tools.common import device_events, profiled

    prof = profiled(fn, host=False)
    return sum(t for _, _, t in device_events(prof) if t > 0) / 1e3


def b5_repro(dev) -> None:
    """B5 twice on the same inputs, bf16, at the train step's GMA call and
    its stage-0 fnet GSA call: logs how many elements of dq, dk, dv
    differ between the two calls (the split passes' atomic sums)."""
    import torch

    from streamflow_tpu_torch.ops.kernels import flash_attention as K3

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    h8, w8 = TRAIN_H // 8, TRAIN_W // 8
    out = {}
    for label, bh, n, m, d in (
            ("gma", (3, 1), h8 * w8, h8 * w8, 128),
            ("gsa0 fnet", (1, 4), T * 4 * h8 * w8, (T * 2 * h8 // 8)
             * (2 * w8 // 8), 32)):
        def rnd(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=g, device=dev)
                    ).bfloat16()
        q = rnd(*bh, n, d, scale=d ** -0.5)
        k, v, do = rnd(*bh, m, d), rnd(*bh, m, d), rnd(*bh, n, d)
        o, lse = K3.flash_attention_fwd(q, k, v, return_lse=True)
        delta = (do.float() * o.float()).sum(-1)
        first = K3.flash_attention_bwd(q, k, v, do, lse, delta)
        second = K3.flash_attention_bwd(q, k, v, do, lse, delta)
        out[label] = {name: int((a != b).sum()) for name, a, b in
                      zip(("dq", "dk", "dv"), first, second)}
    log(f"phase 34 (a) B5 twice on the same bf16 inputs, elements that "
        f"differ: {json.dumps(out)}")


def state_diffs(a, b) -> tuple:
    """How two TrainStates differ: (the names of the tensors that differ
    (parameters, buffers, AdamW moments), {part: relative L2 difference
    of all its tensors together} for the parts 'model' (parameters and
    buffers), 'exp_avg' and 'exp_avg_sq')."""
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    parts = {"model": [(k, sa[k], sb[k]) for k in sa]}
    oa = a.optimizer.state_dict()["state"]
    ob = b.optimizer.state_dict()["state"]
    names = [n for n, _ in a.model.named_parameters()]
    for m in ("exp_avg", "exp_avg_sq"):
        parts[m] = [(f"{names[i]} {m}", s[m], ob[i][m])
                    for i, s in oa.items()]
    differ, rel = [], {}
    for part, pairs in parts.items():
        num = den = 0.0
        for k, x, y in pairs:
            if not torch.equal(x, y):
                differ.append(k)
                num += float((x.double() - y.double()).square().sum())
            den += float(y.double().square().sum())
        rel[part] = math.sqrt(num / max(den, 1e-300))
    return differ, rel


def dp_one_rank(dev, rank, world) -> dict:
    """(a) A group of one rank (NCCL), at phase 7's step (canonical,
    'auto', 432x960, T=4, 12 iterations, bf16 with f32 parameters, remat,
    B=1), with deterministic algorithms on:
    - what the group adds is exact: ``_all_reduce`` over the group leaves
      a real step's gradients, loss and metric sums bit for bit as they
      were;
    - DP_STEPS steps of shard_train_step against the plain step from the
      same seeded weights and batches (one step of 'basic', its
      BatchNorm synced over the group), launches as phase 7's: the plain
      step is run twice and the group's once, between the two, each from
      a fresh copy of the seeded model. Every run's first forward
      metrics and running statistics are bit for bit the group's. The
      backward is not reproducible on the card, even with deterministic
      algorithms: B5 adds the slices of its split passes into zeroed
      buffers with f32 atomics, in no fixed order (``b5_repro`` shows it),
      and random weights amplify each difference from step to step. So
      the log gives every pair of runs' differences (tensors that differ,
      relative L2), and the group's state after the steps is held within
      DP_A_REL of its nearest plain run, its metrics within
      DP_A_METRIC_RTOL of each;
    - wall and device ms a step of each, in turns."""
    import copy

    import torch

    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools.train_bench import synthetic_batch
    from streamflow_tpu_torch.training.loss import masked_means
    from streamflow_tpu_torch.training.state import TrainState
    from streamflow_tpu_torch.training.step import (_all_reduce,
                                                    batch_stats,
                                                    make_train_step)

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    b5_repro(dev)
    group = parallel.make_mesh()
    plain_step = make_train_step(gamma=0.85, iters=ITERS)
    group_step = parallel.shard_train_step(plain_step, group)
    batches = [synthetic_batch(B, T, TRAIN_H, TRAIN_W, SEED + i, dev)
               for i in range(DP_STEPS)]

    t0 = time.perf_counter()
    templates = {zoo: train_setup(dev, TRAIN_H, TRAIN_W, ITERS, True, SEED,
                                  "auto", zoo=zoo)[0].model
                 for zoo in (None, "basic")}

    def fresh(zoo=None):
        """A new TrainState holding a copy of the seeded model."""
        return TrainState.create(copy.deepcopy(templates[zoo]), lr=1.75e-4,
                                 num_steps=180_000)

    # the group's own arithmetic on a real step's buffers
    state = fresh()
    loss, sums = plain_step.loss_fn(state.model, batches[0], sums=True)
    loss.backward()
    grads = [p.grad for p in state.model.parameters()
             if p.grad is not None]
    before = [g.clone() for g in grads]
    loss = loss.detach()
    got_loss, got_sums = _all_reduce(grads, loss, sums, group)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, before))
    assert torch.equal(got_loss, loss)
    want, got = masked_means(sums), masked_means(got_sums)
    assert all(torch.equal(want[k], got[k]) for k in want), (want, got)
    log(f"phase 34 (a) the one-rank NCCL all-reduce of a step's "
        f"{len(grads)} gradients ({sum(g.numel() for g in grads)} f32), "
        f"loss and metric sums: each bit for bit as it was")
    del state, grads, before

    def run(step, zoo=None, n=DP_STEPS):
        state = fresh(zoo)
        metrics, counts = [], []
        for batch in batches[:n]:
            reset_launches()
            metrics.append(step(state, batch))
            torch.cuda.synchronize()
            counts.append(dict(LAUNCHES))
            if not counts[1:]:
                stats = [t.clone() for t in batch_stats(state.model)]
        return state, metrics, counts, stats

    def compare(label, zoo=None, n=DP_STEPS):
        runs = {}
        for name, step in (("plain 1", plain_step), ("group", group_step),
                           ("plain 2", plain_step)):
            runs[name] = run(step, zoo, n)
        forward = ("loss", "epe", "1px", "3px", "5px")
        g_state, g_m, g_counts, g_stats = runs["group"]
        for name, (st, m, _, stats) in runs.items():
            assert all(torch.equal(m[0][k], g_m[0][k]) for k in forward), (
                name, m[0], g_m[0])
            assert all(torch.equal(x, y) for x, y in zip(stats, g_stats))
        same = {}
        for a_name, b_name in (("group", "plain 1"), ("group", "plain 2"),
                               ("plain 1", "plain 2")):
            (sa, ma, _, _), (sb, mb, _, _) = runs[a_name], runs[b_name]
            differ, rel = state_diffs(sa, sb)
            differ += [f"step {i} {k}" for i, (x, y) in enumerate(zip(ma, mb))
                       for k in x if not torch.equal(x[k], y[k])]
            same[f"{a_name} / {b_name}"] = (len(differ), rel)
        near = {part: min(same[f"group / plain {i}"][1][part]
                          for i in (1, 2)) for part in DP_A_REL}
        log(f"phase 34 (a) {label}: one-rank NCCL group and plain steps from "
            f"the same state over {n} steps: step 1's forward metrics "
            f"{ {k: float(g_m[0][k]) for k in forward} } and "
            f"{len(g_stats)} running statistics bit for bit in every run; "
            f"losses {[float(m['loss']) for m in g_m]}, grad_norm "
            f"{[float(m['grad_norm']) for m in g_m]}; tensors and metrics "
            f"that differ, relative L2 (parameters and buffers, AdamW "
            f"moments): {json.dumps(same)}; the group from its nearest "
            f"plain run {json.dumps(near)} (bound {json.dumps(DP_A_REL)}); "
            f"{time.perf_counter() - t0:.1f} s into the part")
        assert all(near[k] <= DP_A_REL[k] for k in near), near
        for name in ("plain 1", "plain 2"):
            for g, m in zip(g_m, runs[name][1]):
                assert all(abs(float(g[k]) - float(m[k]))
                           <= DP_A_METRIC_RTOL * abs(float(m[k]))
                           + DP_A_METRIC_ATOL for k in m), (name, g, m)
        return g_counts

    counts = compare("canonical")
    for i, c in enumerate(counts):
        assert c == EXPECTED_TRAIN_LAUNCHES, (i, c, EXPECTED_TRAIN_LAUNCHES)
    log(f"phase 34 (a) launches per step {json.dumps(counts[0])} == "
        f"phase 7's")
    basic_counts = compare("basic", zoo="basic", n=1)
    want = zoo_launches("basic", train=True, t=T, h=TRAIN_H, w=TRAIN_W,
                        apps=1)
    assert basic_counts[0] == want, (basic_counts[0], want)

    # times: one state per side, steps in turns (plain, group, group,
    # plain), then one profiled step of each
    sides = {"plain": (plain_step, fresh()), "group": (group_step, fresh())}
    walls = {"plain": [], "group": []}
    for name in ("plain", "group", "group", "plain") * DP_TIMED:
        step, st = sides[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(st, batches[0])
        torch.cuda.synchronize()
        walls[name].append(1e3 * (time.perf_counter() - t0))
    out = {"launches": counts[0]}
    for name, (step, st) in sides.items():
        ms = sum(walls[name]) / len(walls[name])
        dms = device_ms(lambda: step(st, batches[0]))
        out[name] = {"wall_ms": ms, "walls": walls[name], "device_ms": dms,
                     "idle": max(0.0, 1 - dms / ms)}
    log(f"phase 34 (a) {B}x{T}x{TRAIN_H}x{TRAIN_W} iters {ITERS} bf16 + f32 "
        f"params + remat, deterministic algorithms: wall ms/step plain "
        f"{out['plain']['wall_ms']:.3f} group {out['group']['wall_ms']:.3f} "
        f"({DP_TIMED * 2} steps each, in turns); device ms/step plain "
        f"{out['plain']['device_ms']:.3f} group "
        f"{out['group']['device_ms']:.3f}; idle share plain "
        f"{out['plain']['idle']:.4f} group {out['group']['idle']:.4f}; "
        f"group / plain wall "
        f"{out['group']['wall_ms'] / out['plain']['wall_ms']:.4f}, device "
        f"{out['group']['device_ms'] / out['plain']['device_ms']:.4f}; "
        f"the steps' walls plain {[round(x, 3) for x in walls['plain']]} "
        f"group {[round(x, 3) for x in walls['group']]}; "
        f"{time.perf_counter() - t0:.1f} s into the part")
    return out


def dp_batch(kind, seed, dev):
    """(b)'s seeded global batch of DP2_B clips at 432x960 (two frames for
    RAFT, T for StreamFlow with the backward flows), valid masks of 90%
    and 35% on the two rows, so that the ranks' valid counts differ."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = 2 if kind == "raft" else T
    shape = (DP2_B, t - 1, TRAIN_H, TRAIN_W)
    dens = np.array([0.9, 0.35], np.float32)[:, None, None, None]

    def arr(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    out = {"images": arr(rng.integers(0, 256, (DP2_B, t, TRAIN_H, TRAIN_W,
                                               3))),
           "flows": arr(4.0 * rng.standard_normal(shape + (2,))),
           "valids": arr(rng.random(shape) < dens)}
    if kind == "streamflow":
        out["flows_bw"] = arr(4.0 * rng.standard_normal(shape + (2,)))
        out["valids_bw"] = arr(rng.random(shape) < dens)
    return out


def dp_state(dev, kind, fields):
    """(b)'s f32 train state of a form, from the seeded weights."""
    from streamflow_tpu_torch.config import RAFTConfig, StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.training.state import TrainState

    if kind == "raft":
        model = create_model("raft", cfg=RAFTConfig(
            iters=DP2_ITERS, mixed_precision=False, **fields), device=dev,
            train=True)
        init_weights(model, SEED)
        return TrainState.create(model, lr=RAFT_LR, num_steps=100_000,
                                 weight_decay=RAFT_WD)
    model = create_model("streamflow", cfg=StreamFlowConfig(
        T=T, iters=DP2_ITERS, mixed_precision=False, remat=True, **fields),
        device=dev, train=True)
    init_weights(model, SEED)
    return TrainState.create(model, lr=1.75e-4, num_steps=180_000)


def dp_two_ranks(dev, rank, world) -> dict:
    """(b) Two ranks in two processes sharing the card over gloo, f32 (TF32
    off), 432x960, global batch DP2_B (one clip a rank), DP2_ITERS
    iterations: for each of DP2_FORMS, one shard_train_step step of the
    two ranks against one process's step on the whole global batch (run
    in rank 0's process first), at DP2_*'s tolerances; after a second
    step the ranks' parameters, statistics and AdamW moments equal bit for
    bit; each rank's launches in each step exact."""
    import torch
    import torch.distributed as dist

    from streamflow_tpu_torch import parallel
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.training.step import (make_train_step,
                                                    make_train_step_2f)

    out = {}
    for name, (kind, fields, bidir) in DP2_FORMS.items():
        if kind == "raft":
            step = make_train_step_2f(RAFT_GAMMA, DP2_ITERS)
            want = raft_launches("raft", train=True, iters=DP2_ITERS)
        else:
            step = make_train_step(0.85, DP2_ITERS, bidirectional=bidir)
            want = (train_launches(iters=DP2_ITERS) if "encoder" not in fields
                    else zoo_launches(fields["encoder"], train=True, t=T,
                                      h=TRAIN_H, w=TRAIN_W, iters=DP2_ITERS,
                                      apps=2 if bidir else 1))
        batch = dp_batch(kind, SEED + 11, dev)
        t0 = time.perf_counter()
        if rank == 0:
            ref = dp_state(dev, kind, fields)
            m_ref = {k: float(v) for k, v in step(ref, batch).items()}
            ref_sd = {k: v.detach().to("cpu", copy=True) for k, v in
                      ref.model.state_dict().items()}
            del ref
        parallel.barrier(f"reference {name}")
        state = dp_state(dev, kind, fields)
        parallel.replicate(state.model)
        sharded = parallel.shard_train_step(step)
        local = parallel.shard_batch(batch, rank, world)
        counts = []
        for i in range(2):
            reset_launches()
            m = sharded(state, local)
            torch.cuda.synchronize()
            counts.append(dict(LAUNCHES))
            if i == 0:
                m1 = {k: float(v) for k, v in m.items()}
                sd1 = {k: v.detach().to("cpu", copy=True) for k, v in
                       state.model.state_dict().items()}
        for c in counts:
            assert c == want, (name, rank, c, want)
        # the ranks agree bit for bit: rank 0's tensors broadcast
        flat = torch.cat([v.reshape(-1).float() for v in
                          state.model.state_dict().values()]
                         + [v.reshape(-1).float() for s in
                            state.optimizer.state_dict()["state"].values()
                            for v in s.values() if v.is_cuda])
        ref_flat = flat.clone()
        dist.broadcast(ref_flat, 0)
        agree = torch.tensor([float(torch.equal(flat, ref_flat))],
                             device=dev)
        dist.all_reduce(agree)
        assert int(agree.item()) == world, f"{name}: the ranks differ"
        rec = {"metrics": m1, "launches": counts[0],
               "s": time.perf_counter() - t0}
        if rank == 0:
            keys = ("loss", "epe") + (("epe_bw",) if bidir else ())
            errs = {k: abs(m1[k] - m_ref[k]) / abs(m_ref[k]) for k in keys}
            assert all(e <= DP2_LOSS_RTOL for e in errs.values()), (
                name, m1, m_ref)
            worst, n_moved = 0.0, 0
            for k, want_p in ref_sd.items():
                got_p = sd1[k]
                excess = ((got_p - want_p).abs() - DP2_PARAM_ATOL
                          - DP2_PARAM_RTOL * want_p.abs()).max()
                worst = max(worst, float((got_p - want_p).abs().max()))
                assert float(excess) <= 0, (name, k, float(excess))
                n_moved += 1
            rec.update(ref=m_ref, rel_err=errs, param_max_abs=worst)
            log(f"phase 34 (b) {name}: 2 ranks on one card (gloo) vs one "
                f"process on the global batch of {DP2_B}, f32, "
                f"{TRAIN_H}x{TRAIN_W}, iters {DP2_ITERS}: loss "
                f"{m1['loss']!r} vs "
                f"{m_ref['loss']!r}, rel err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (bound {DP2_LOSS_RTOL}); {n_moved} parameters and "
                f"buffers within atol {DP2_PARAM_ATOL} + rtol "
                f"{DP2_PARAM_RTOL} (max abs diff {worst:.3e}); after 2 "
                f"steps the ranks equal bit for bit; launches per rank and "
                f"step {json.dumps({k: v for k, v in counts[0].items() if v})}"
                f" ({time.perf_counter() - t0:.1f} s)")
        out[name] = rec
        del state
        torch.cuda.empty_cache()
        parallel.barrier(f"done {name}")
    return out


def dp_trainer(dev, rank, world) -> dict:
    """(c) tools/train.py::train with two ranks sharing the card over gloo:
    global batch 2 (one clip a rank) of in-memory clips at 432x960, T=4,
    12 iterations, bf16 with f32 parameters and remat, DP_TRAINER_STEPS
    steps, a checkpoint and a validation (phase 28's Sintel windows)
    every DP_TRAINER_VAL steps. Each rank's checkpoint writes, validations
    and launches are counted; then the last checkpoint is restored into a
    fresh state on each rank and compared with the live one bit for bit,
    and the ranks' states with each other."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from streamflow_tpu_torch import evaluation as ev
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.tools import train as trainer
    from streamflow_tpu_torch.training import checkpoint
    from streamflow_tpu_torch.training.state import TrainState

    out_dir = os.path.join(DP_DIR, "trainer")
    args = trainer.parse_args([
        "--preset", "sintel_kitti", "--validation", "sintel",
        "--batch_size", str(world), "--num_steps", str(DP_TRAINER_STEPS),
        "--print_freq", "1", "--val_freq", str(DP_TRAINER_VAL),
        "--val_iters", str(ITERS), "--num_workers", "2", "--device",
        str(dev), "--output", out_dir])
    h, w = args.image_size
    writes, vals = [], []
    val_counts = dict.fromkeys(KERNELS, 0)
    write = checkpoint.CheckpointManager._write

    def counted(self, step, snapshot):
        writes.append(step)
        return write(self, step, snapshot)

    checkpoint.CheckpointManager._write = counted
    windows = sintel_windows(np.random.default_rng(SEED + 6))

    def validate(fwd):
        vals.append(rank)
        before = dict(LAUNCHES)
        epes = np.concatenate([
            e for s in windows
            for e in ev.pair_epes(ev.window_flows(fwd, s["images"], dev), s,
                                  args.T)])
        for k in KERNELS:
            val_counts[k] += LAUNCHES[k] - before[k]
        return {"clean_epe": float(epes.mean())}

    reset_launches()
    t0 = time.perf_counter()
    run = trainer.train(args, MemoryClips(8 * world, args.T, h, w),
                        validate)
    run_s = time.perf_counter() - t0
    steps_counts = {k: LAUNCHES[k] - val_counts[k] for k in KERNELS}
    per_step = train_launches(args.T, h, w)
    assert steps_counts == {k: DP_TRAINER_STEPS * v
                            for k, v in per_step.items()}, steps_counts
    model = create_model("streamflow", cfg=run.state.model.cfg, device=dev,
                         train=True)
    fresh = checkpoint.CheckpointManager(os.path.join(
        out_dir, args.name, "ckpts")).restore(TrainState.create(
            model, args.lr, args.num_steps, args.wdecay, args.epsilon,
            args.clip))
    bad, _ = state_diffs(run.state, fresh)
    if (run.state.step, run.state.lr) != (fresh.step, fresh.lr):
        bad.append("step, lr")
    assert not bad, f"rank {rank}: the resumed state differs in {bad[:5]}"
    flat = torch.cat([v.reshape(-1).float() for v in
                      run.state.model.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    agree = torch.tensor([float(torch.equal(flat, ref))], device=dev)
    dist.all_reduce(agree)
    assert int(agree.item()) == world, "the ranks' final states differ"
    best = os.path.exists(os.path.join(out_dir, args.name, "best.npz"))
    return {"writes": writes, "validations": len(vals), "best": best,
            "fwd": run.fwd is not None, "val": run.val,
            "launches": steps_counts, "val_launches": val_counts,
            "run_s": run_s,
            "step_ms": [1e3 * (b - a) for a, b in zip(run.step_t,
                                                       run.step_t[1:])]}


def dp_phase(dev) -> tuple:
    """Phase 34: data-parallel training, parts (a), (b), (c) in processes
    of their own. Returns (a)'s launches per step and (c)'s rank-0
    launches over its steps."""
    t0 = time.perf_counter()
    (a,) = dp_run("a", 1, "nccl")
    ta = time.perf_counter()
    bc = dp_run("bc", 2, "gloo")
    b, c = [r["b"] for r in bc], [r["c"] for r in bc]
    for name in DP2_FORMS:
        assert b[0][name]["launches"] == b[1][name]["launches"], name
        assert b[0][name]["metrics"] == b[1][name]["metrics"], name
    assert [r["writes"] for r in c] == [
        list(range(DP_TRAINER_VAL, DP_TRAINER_STEPS + 1, DP_TRAINER_VAL)),
        []], [r["writes"] for r in c]
    n_val = DP_TRAINER_STEPS // DP_TRAINER_VAL
    assert [r["validations"] for r in c] == [n_val, 0], c
    assert [r["fwd"] for r in c] == [True, False]
    assert c[0]["best"] and not any(c[1]["val_launches"].values())
    assert c[0]["launches"] == c[1]["launches"]
    log(f"phase 34 (c) trainer, 2 ranks on one card (gloo), global batch 2 "
        f"at 432x960 T=4 12 iterations bf16: {DP_TRAINER_STEPS} steps in "
        f"{c[0]['run_s']:.1f} s (ms between steps "
        f"{[round(x, 1) for x in c[0]['step_ms']]}); checkpoints written by "
        f"rank 0 at steps {c[0]['writes']} and by rank 1 at "
        f"{c[1]['writes']}; validations rank 0 {c[0]['validations']} "
        f"({c[0]['val']}), rank 1 {c[1]['validations']}; best.npz from "
        f"rank 0; both ranks resumed the last checkpoint bit for bit and "
        f"hold the same state; launches per rank "
        f"{json.dumps(c[0]['launches'])}")
    b_s = sum(r["s"] for r in b[0].values())
    log(f"phase 34 parts: (a) {ta - t0:.1f} s, (b) and (c) "
        f"{time.perf_counter() - ta:.1f} s ((b) {b_s:.1f} s in its forms, "
        f"(c) {c[0]['run_s']:.1f} s in train)")
    return a["launches"], c[0]["launches"]


# ---------------------------------------------------------------- phase 37
def sum_summaries(*summaries):
    """One path's kernel numbers from several parts' (``new_summary``'s):
    times and library times added, the largest error kept."""
    out = new_summary()
    for summary in summaries:
        for name, s in summary.items():
            o = out[name]
            o["err"] = max(o["err"], s["err"])
            for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "mem_ms"):
                o[k] += s[k]
            if s["library_ms"] is not None:
                o["library_ms"] = (o["library_ms"] or 0.0) + s["library_ms"]
            for t, v in s.get("ms_by_traffic", {}).items():
                d = o.setdefault("ms_by_traffic", {})
                d[t] = d.get(t, 0.0) + v
    return out


def trained_dynamics_phase(dev) -> tuple:
    """Phase 37, trained dynamics (tools/probe_bf16.py and probe_guard.py
    cut to size): the path's kernels at its shapes (kernel_checks and
    backward_checks at TD_H x TD_W for the train step, kernel_checks at
    TD_EVAL_H x TD_EVAL_W for the clip; tails left to phases 3 and 6);
    then, with the launch counts set to 0, the probe's training
    (TD_STEPS steps, launches exactly TD_STEPS x train_launches at its
    shape) and the trained weights' bf16 clip at 12 iterations (launches
    exactly forward_launches at its shape): the path "trained_dynamics".
    The weights go out through params.to_jax_variables and
    save_params_npz and back through load_variables_npz and load_jax:
    the reloaded model's flows equal the trained model's bit for bit. One
    more step is profiled on the card alone (device ms by group, idle
    share against the loop's ms a step).
    Then the f32 kernels on the card (launches as the clip's), the f32
    and bf16 plain paths on the CPU, control A of probe_guard (the f32
    plain path at the clip + 1e-4) at 2 and 12 iterations, the probe's
    EPE table, and phase 5's two guards at 12 iterations: judged where
    control A's global relative EPE is below F32_GUARD_TOL (the loop
    damps a 1e-4 input change: rounding cannot push the guard past its
    bound), reported otherwise. Returns the path's launches and kernel
    numbers."""
    import shutil

    import torch

    from streamflow_tpu_torch.config import StreamFlowConfig
    from streamflow_tpu_torch.models import create_model
    from streamflow_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from streamflow_tpu_torch.params import load_jax
    from streamflow_tpu_torch.tools import probe_bf16 as PB
    from streamflow_tpu_torch.tools import probe_guard as PG
    from streamflow_tpu_torch.tools.common import rel_epe
    from streamflow_tpu_torch.training.checkpoint import (load_variables_npz,
                                                          save_params_npz)
    from streamflow_tpu_torch.training.step import make_train_step

    s_train, s_clip = new_summary(), new_summary()
    kernel_checks(dev, {"auto": s_train}, TD_H, TD_W, True, tails=False)
    backward_checks(dev, [s_train], h=TD_H, w=TD_W, tails=False)
    kernel_checks(dev, {"auto": s_clip}, TD_EVAL_H, TD_EVAL_W, False,
                  tails=False)
    torch.cuda.empty_cache()

    want_step = train_launches(T, TD_H, TD_W)
    want_clip = forward_launches(ITERS, T, TD_EVAL_H, TD_EVAL_W)
    reset_launches()
    t0 = time.perf_counter()
    state, last = PB.train(PB.init_model(T, ITERS, dev), TD_STEPS, T, TD_H,
                           TD_W, ITERS,
                           log=lambda m: log(f"trained dynamics {m}"))
    train_s = time.perf_counter() - t0
    trained = dict(LAUNCHES)
    log(f"trained dynamics: {TD_STEPS} steps at {TD_H}x{TD_W} in "
        f"{train_s:.1f} s ({1e3 * train_s / TD_STEPS:.1f} ms/step); "
        f"launches {json.dumps(trained)} expected {TD_STEPS} x "
        f"{json.dumps(want_step)}")
    assert trained == {k: TD_STEPS * v for k, v in want_step.items()}, (
        "probe training launch counts differ")
    assert all(math.isfinite(v) for v in last.values()), last

    cfg = {mp: StreamFlowConfig(T=T, iters=ITERS, mixed_precision=mp)
           for mp in (False, True)}
    model = create_model("streamflow", cfg=cfg[True], device=dev)
    model.load_state_dict(state.model.state_dict())
    clip = PB.eval_clip(T, TD_EVAL_H, TD_EVAL_W)
    bf16 = PB.flows_of(model, clip)
    path = dict(LAUNCHES)
    clip_counts = {k: path[k] - trained[k] for k in path}
    log(f"trained dynamics: the bf16 clip ({tuple(clip.shape)}, {ITERS} "
        f"iterations) launches {json.dumps(clip_counts)} expected "
        f"{json.dumps(want_clip)}")
    assert clip_counts == want_clip, "clip launch counts differ"
    assert bool(torch.isfinite(bf16).all()), "non-finite flows"

    shutil.rmtree(TD_DIR, ignore_errors=True)
    os.makedirs(TD_DIR)
    npz = os.path.join(TD_DIR, "best.npz")
    save_params_npz(npz, PB.trained_variables(state))
    # where a step's time goes: one more step (the weights are saved),
    # profiled on the card alone, against the loop's wall ms a step
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             PB.synth_batch(TD_STEPS + 1, T, TD_H, TD_W).items()}
    step = make_train_step(gamma=PB.GAMMA, iters=ITERS)
    profile_device(lambda: step(state, batch), 1e3 * train_s / TD_STEPS,
                   "train_step_probe", host=False)
    del state, model, batch
    torch.cuda.empty_cache()
    variables = load_variables_npz(npz)
    reloaded = create_model("streamflow", cfg=cfg[True], device=dev)
    load_jax(reloaded, variables)
    assert torch.equal(PB.flows_of(reloaded, clip), bf16), (
        "the reloaded weights' flows differ from the trained model's")
    del reloaded
    mib = os.path.getsize(npz) / 2 ** 20
    log(f"trained dynamics: weights saved ({mib:.1f} MiB npz, flax layout) "
        f"and reloaded: flows bit for bit")

    reset_launches()
    f32 = PB.flows_of(PB.eval_model(variables, T, ITERS, False, dev), clip)
    assert dict(LAUNCHES) == want_clip, dict(LAUNCHES)
    t0 = time.perf_counter()
    plain = PB.eval_model(variables, T, ITERS, False, "cpu")
    ref_iters = PG.iter_flows(plain, clip, ITERS)
    ref = ref_iters[-1]
    ctrl_a = PG.control_a(plain, clip, (2, ITERS), ref_iters)
    bf16_plain = PB.flows_of(PB.eval_model(variables, T, ITERS, True,
                                           "cpu"), clip)
    cpu_s = time.perf_counter() - t0
    shutil.rmtree(TD_DIR, ignore_errors=True)

    mag = ref.norm(dim=-1)
    epe = {"f32": PB.epe_stats(f32, ref), "bf16": PB.epe_stats(bf16, ref)}
    g32, g16, g16p = (rel_epe(f, ref) for f in (f32, bf16, bf16_plain))
    a12 = ctrl_a[ITERS]["rel_epe"]
    judged = a12 < F32_GUARD_TOL
    log(f"trained dynamics at {TD_EVAL_H}x{TD_EVAL_W} (padded "
        f"{tuple(clip.shape[2:4])}), {ITERS} iterations, against the f32 "
        f"plain path (|flow| px mean {float(mag.mean()):.4g} max "
        f"{float(mag.max()):.4g}): f32 kernels EPE px mean "
        f"{epe['f32']['epe_mean']:.4g} p99 {epe['f32']['epe_p99']:.4g} max "
        f"{epe['f32']['epe_max']:.4g}; bf16 kernels mean "
        f"{epe['bf16']['epe_mean']:.4g} p99 {epe['bf16']['epe_p99']:.4g} "
        f"max {epe['bf16']['epe_max']:.4g}; control A (+{PG.EPS} input, f32 "
        f"plain): " + "; ".join(
            f"iters={k} max EPE {v['max_epe']:.4g} px mean "
            f"{v['mean_epe']:.4g} rel {v['rel_epe']:.3e}"
            for k, v in ctrl_a.items())
        + f"; CPU paths {cpu_s:.1f} s")
    log(f"trained dynamics guards at {ITERS} iterations, rel EPE global / "
        f"per-pixel p99: f32 kernels {g32[0]:.3e} / {g32[1]:.3e} (bound "
        f"{F32_GUARD_TOL} each); bf16 kernels {g16[0]:.3e} / {g16[1]:.3e}, "
        f"bf16 plain {g16p[0]:.3e} / {g16p[1]:.3e} (bound "
        f"{BF16_GUARD_RATIO}x the plain); "
        + (f"judged: control A's rel EPE at {ITERS} iterations "
           f"{a12:.3e} < {F32_GUARD_TOL}" if judged else
           f"NOT judged: control A's rel EPE at {ITERS} iterations "
           f"{a12:.3e} >= {F32_GUARD_TOL} (the loop amplifies a {PG.EPS} input change "
           f"past the guard's bound at this size and training)"))
    if judged:
        assert all(math.isfinite(v) and v < F32_GUARD_TOL for v in g32), g32
        assert all(math.isfinite(k) and k <= BF16_GUARD_RATIO * p
                   for k, p in zip(g16, g16p)), (g16, g16p)
    return path, sum_summaries(scaled_summary(s_train, TD_STEPS), s_clip)


# ---------------------------------------------------------------- phase 38
def tools_phase(dev) -> None:
    """Phase 38, the measuring tools and the native IO runtime:
    tools/sweep_e2e.py over SWEEP_SPECS in turns at 440x1024 (ms/clip
    graphed, device ms, idle share; its lines in
    chiprun_out/sweep_results.txt), tools/trace_e2e.py on the default
    (device time by op group: every kernel of the default forward has
    time), the runtime (libsfio, built with g++) on .flo files (one and a
    batch of three, 436x1024) against the NumPy decoder and on a .ppm
    against the bytes written, bit for bit, a garbage file raising; and
    tools/bench_input.py in a process of its own if PIL is installed
    (it writes and reads png frames), else says it is not run."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from streamflow_tpu_torch import runtime
    from streamflow_tpu_torch.data import frame_utils
    from streamflow_tpu_torch.tools import sweep_e2e, trace_e2e

    t0 = time.perf_counter()
    rows = sweep_e2e.main(list(SWEEP_SPECS) + ["--reps", "10"])
    for r in rows:
        assert math.isfinite(r["ms_per_clip"]) and r["device_ms"] > 0, r
    log("sweep_e2e 440x1024 T=4 12 iterations bf16, graphed, in turns: "
        + "; ".join(f"{r['spec']} {r['ms_per_clip']:.3f} ms/clip (rounds "
                    f"{[round(x, 3) for x in r['ms_per_clip_rounds']]}), "
                    f"device {r['device_ms']:.3f} ms, idle "
                    f"{r['idle_share']:.4f}" for r in rows)
        + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = trace_e2e.main(["default", "--raw", "12"])
    missing = [g for g in ("corr_lookup", "ffn_pair", "flash_fwd",
                           "lga_kernel") if tr["groups_ms"].get(g, 0) <= 0]
    assert not missing, f"trace_e2e: no device time in {missing}"
    log(f"trace_e2e default: device {tr['total_ms']:.3f} ms by group "
        + json.dumps({g: round(v, 3) for g, v in sorted(
            tr["groups_ms"].items(), key=lambda kv: -kv[1])})
        + f" ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    d = os.path.join(ROOT, "build", "chip_smoke_runtime")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    runtime.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    flos = [os.path.join(d, f"{i}.flo") for i in range(3)]
    for p in flos:
        frame_utils.write_flo(p, (8 * rng.standard_normal(
            (H, W, 2))).astype(np.float32))
    for p in flos:
        assert np.array_equal(frame_utils.read_flo(p),
                              frame_utils.read_flo_numpy(p)), p
    assert np.array_equal(runtime.read_flo_batch_native(flos), np.stack(
        [frame_utils.read_flo_numpy(p) for p in flos]))
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    ppm = os.path.join(d, "frame.ppm")
    with open(ppm, "wb") as fh:
        fh.write(b"P6\n# chip_smoke\n%d %d\n255\n" % (W, H))
        fh.write(img.tobytes())
    assert np.array_equal(frame_utils.read_image(ppm), img)
    bad = os.path.join(d, "bad.flo")
    with open(bad, "wb") as fh:
        fh.write(b"not a flow file")
    try:
        frame_utils.read_flo(bad)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("the native decoder took a garbage .flo")
    shutil.rmtree(d, ignore_errors=True)
    log(f"runtime: libsfio built in {build_s:.1f} s; .flo {H}x{W} (one, "
        f"and a batch of 3) equal to the NumPy decoder's and .ppm to the "
        f"bytes written, bit for bit; garbage refused ({refused})")

    if importlib.util.find_spec("PIL") is None:
        log("bench_input: not run (PIL is not installed on this machine; "
            "the tool writes and reads png frames)")
        return
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "streamflow_tpu_torch.tools.bench_input",
         *BENCH_INPUT_ARGS, "--root", os.path.join(ROOT, "build")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    log(f"bench_input {' '.join(BENCH_INPUT_ARGS)}: "
        + " | ".join(res.stdout.strip().splitlines())
        + f" ({time.perf_counter() - t0:.1f} s)")


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "streamflow_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(streamflow_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False)")
    dev = torch.device("cuda:0")
    os.makedirs(OUT_DIR, exist_ok=True)   # the log holds this run's lines
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    log(f"phase 1 device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")

    from streamflow_tpu_torch import _build

    _build.library()
    log(f"phase 2 build: {_build.build_seconds:.1f} s")
    log(_build.ptxas_summary())
    ptxas = _build._BUILD / "ptxas.log"
    if ptxas.exists():   # nvcc's own lines, registers and spills per kernel
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as fh:
            fh.write(ptxas.read_text())

    t_start = time.perf_counter()
    # per path: its SK layout and its phases (kernel checks, forward or
    # train step); phases 3 and 6 time each kernel for both layouts
    summary = {path + LAYOUTS[dw][0]: new_summary()
               for path in ("inference", "train_step") for dw in LAYOUTS}
    counts = {}

    def phase(n, what, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"phase {n} {what}: passed ({time.perf_counter() - t0:.1f} s)")
        return out

    def per_layout(path):
        return {dw: summary[path + LAYOUTS[dw][0]] for dw in LAYOUTS}

    for name in ZOO:
        summary["inference_" + name] = new_summary()
    for name in ZOO_TRAINED:
        summary["train_step_" + name] = new_summary()

    def per_zoo(path, names):
        return {z: summary[f"{path}_{z}"] for z in names}

    for name in RAFT_MODELS:
        summary["inference_" + name] = new_summary()
        summary["train_step_" + name] = new_summary()
    summary["inference_umt"] = new_summary()
    summary["train_step_umt"] = new_summary()

    phase(3, "kernels", kernel_checks, dev,
          {**per_layout("inference"), **per_zoo("inference", ZOO),
           **per_zoo("inference", RAFT_MODELS),
           "umt": summary["inference_umt"]}, 440, 1024, False)
    refs, refs_cut, ms_clip = {}, {}, {}
    counts["inference"], ms_clip["auto"] = phase(4, "forward", full_forward,
                                                 dev, "auto")
    phase(5, "accuracy guards", accuracy_guards, dev, "auto", refs)

    def training_kernels():
        zoo = per_zoo("train_step", ZOO_TRAINED)
        two = per_zoo("train_step", RAFT_MODELS)
        umt = summary["train_step_umt"]
        kernel_checks(dev, {**per_layout("train_step"), **zoo, **two,
                            "umt": umt}, TRAIN_H, TRAIN_W, True)
        backward_checks(dev, list(per_layout("train_step").values()),
                        zoo=zoo, two_frame=two, umt=umt)
        # a bidirectional BatchNorm step runs the path twice
        for name, apps in ZOO_TRAINED.items():
            for s in zoo[name].values():
                for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "mem_ms"):
                    s[k] *= apps
                if s["library_ms"] is not None:
                    s["library_ms"] *= apps
    phase(6, "training-shape kernels", training_kernels)
    counts["train_step"] = phase(7, "train step", train_step_phase, dev,
                                 "auto")
    phase(8, "training guard", training_guard, dev, "auto")
    n = 9
    for dw in LAYOUTS:
        if dw == "auto":
            continue
        suffix, tag = LAYOUTS[dw][0], f" dw_impl={dw!r}"
        counts["inference" + suffix], ms_clip[dw] = phase(
            n, "forward" + tag, full_forward, dev, dw)
        # at LAYOUT_GUARD_H x LAYOUT_GUARD_W (phase 5 holds the main path
        # at 436x1024), against one f32 reference at that size
        phase(n + 1, "accuracy guards" + tag, accuracy_guards, dev, dw,
              refs_cut, h=LAYOUT_GUARD_H, w=LAYOUT_GUARD_W)
        n += 2
        if dw in TRAINED:
            counts["train_step" + suffix] = phase(
                n, "train step" + tag, train_step_phase, dev, dw)
            phase(n + 1, "training guard" + tag, training_guard, dev, dw)
            n += 2
    ms_graph = phase(27, "graphed forward", graph_phase, dev)
    counts["serving"] = phase(28, "serving harness", serving_phase, dev)
    summary["serving"] = summary["inference"]
    phase(29, "high resolution", high_res_phase, dev)
    counts["trainer"], trainer_val, summary["trainer"] = phase(
        30, "trainer", trainer_phase, dev)
    phase(31, "stage forms", stage_forms_phase, dev)
    counts.update(phase(32, "ablation configs", zoo_phase, dev))
    counts.update(phase(33, "two-frame baselines", raft_phase, dev))
    counts["train_step_dp"], counts["trainer_dp"] = phase(
        34, "data-parallel training", dp_phase, dev)
    # (a) runs phase 7's step, (c) phase 7's step per rank and step
    summary["train_step_dp"] = summary["train_step"]
    summary["trainer_dp"] = scaled_summary(summary["train_step"],
                                           DP_TRAINER_STEPS)
    counts["inference_umt"] = phase(35, "UMT served", umt_phase, dev)
    counts["train_step_umt"] = phase(36, "UMT trained", umt_train_phase, dev)
    counts["trained_dynamics"], summary["trained_dynamics"] = phase(
        37, "trained dynamics", trained_dynamics_phase, dev)
    phase(38, "tools", tools_phase, dev)
    log(f"phases 3-38: {time.perf_counter() - t_start:.1f} s after the "
        f"build")
    log("ms/clip by SK layout (dw_impl), 440x1024 T=4 12 iterations bf16: "
        + json.dumps({dw: round(v, 3) for dw, v in ms_clip.items()})
        + f"; 'auto' graphed {ms_graph:.3f}")

    assert "jax" not in sys.modules, "the port must not import jax"
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("streamflow_tpu", "PIL", "cv2")]
    assert not loaded, f"chip_smoke's path loaded {loaded[:5]}"
    kernels = []
    for path, path_counts in counts.items():
        for k, (src, rep) in KERNELS.items():
            if not path_counts[k]:
                continue   # not on this path (B5 in inference, K5 default)
            s = summary[path][k]
            kernels.append({
                "name": k, "path": path, "route": "cuda", "source": src,
                "replaces": rep, "launches": path_counts[k],
                "max_abs_err": s["err"],
                "ms": round(s["ms"], 4), "plain_ms": round(s["plain_ms"], 4),
                "bound_ms": round(s["bound_ms"], 4),
                "bound_by": ("operations" if s["ops_ms"] >= s["mem_ms"]
                             else "bytes"),
                "library_ms": (None if s["library_ms"] is None
                               else round(s["library_ms"], 4)),
                **({"ms_by_traffic": {t: round(v, 4) for t, v in
                                      s["ms_by_traffic"].items()}}
                   if "ms_by_traffic" in s else {}),
                **({"launches_validation": trainer_val[k]}
                   if path == "trainer" else {})})
    log(smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp"]:      # a process of phase 34
        part, rank, world, backend, store = sys.argv[2:7]
        dp_worker(part, int(rank), int(world), backend, store)
    else:
        main()
