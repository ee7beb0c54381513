#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vdm4cdm_torch``) on one H100.

    python3 chip_smoke.py [--phases kernels,grads,...] [--port DIR]

Phases, each printing one JSON object per line (every failure propagates and
the script exits non-zero, printing no result; ``--phases`` runs a subset
while developing and then prints no ``kernels`` or ``ok`` line):

  1. card     - nvidia-smi name and power limit;
  2. build    - nvcc of ``vdm4cdm_torch/csrc/*.cu`` from this checkout, all
                sources at once;
  3. kernels  - the launch plans the conv and 1x1 sources report, against
                ``ops/kernels/conv3d.py``'s and ``lanemm.py``'s mirrors
                (``plans`` line, with the conv forward's sums fold); the
                conv forward twice on the same inputs at every z mode and
                dtype and on the f32 K split, outputs and sums equal bit for
                bit (``conv3d_k3s1_fwd (repeats)``, and ``repeats_bitwise``
                on every conv line); then each hand kernel against its plain
                PyTorch version on the card at the model's shapes (B=2,
                circular and zeros, f32 and bf16, TF32 off for the f32
                references), with kernel, plain, library and bound times:
                the conv forward, its use as the dx pass and the dw kernel
                (also against autograd through the plain conv), the
                GroupNorm sums/apply passes (apply also with dropout, which
                holds the kernel's Philox bits to the plain version's, timed
                at p = 0.1 beside p = 0), the GroupNorm backward passes with
                SiLU on/off and p in {0, 0.1}, their dropout masks bit for
                bit (``check_dropout_bwd``), a skip join with a straddling
                group forward and backward, and the 1x1 projection
                (``mm1x1_fwd`` with and without bias and residual, with the
                weight in f32 and in x's dtype, its use as the dx pass,
                ``mm1x1_dw``) at every ``skip_proj`` site of the flagship
                and past 256 channels; the sampler's batch-1 128^3 shapes;
                every conv site of the trained model (``VDM_GRF_c_c_32``,
                f32, circular: the forward at batch 12, dx and dw at batch
                8), one ``site`` line each with cuDNN f32 with TF32 off and
                on, the 3xTF32 and FFMA bounds, and the device times alone
                of the kernel and cuDNN f32 from CUDA-graph replays
                (``blessed_sites``);
                then every kernel again at the ``sfm`` phase's shapes (bf16,
                zeros padding, batch 4 forward and backward and batch 1
                forward, every site), where the ``kernels`` line's times,
                bounds and errors are taken, with one ``site`` line per conv
                site of ``conv_cases`` (forward, dx pass and dw), per
                ``skip_proj`` site (forward with and without the residual,
                dx pass, dw) and per GroupNorm shape (each pass at p = 0.1
                and p = 0) at batch 4, each with its kernel, library and
                bound times. Library yardsticks run cuDNN on
                ``channels_last_3d`` operands with ``cudnn.benchmark`` on
                (restored after); ``--phases sites`` runs only the site
                timings (the trained model's f32 sites first, the GroupNorm
                shapes also at batch 2, then the GroupNorm sites of
                ``train_uc_c`` at 256^2 b12 and of the trained model at
                32^3 b8, both f32, and a sharded rank's slab, bf16:
                ``reduction_sites``); ``--phases norm_sites`` only the
                GroupNorm ones; and with
                ``--port DIR`` times the kernels of the ``vdm4cdm_torch/``
                in DIR (an earlier commit, unpacked) for a before/after
                table on one card;
  4. parity   - eps_hat of the full-width VDM (chs 32..256) and the velocity
                of the full-width SFM at 32^3, f32, on the card through the
                kernels against the same weights on the CPU plain path;
  5. grads    - the same models, batch 2, dropout 0.1 with injected t, eps and
                seed: the loss and every parameter's gradient on the card
                against the CPU plain path (the dropout mask is the same
                function of seed and index on both); then the SFM's loss and
                gradients with ``remat=True`` against ``remat=False`` on the
                card;
  6. main     - the flagship sampler (128^3, batch 1, bf16, chs 32..256) via
                ``VDM.draw_samples`` for a few steps: s/step, s/field at 250
                steps, peak memory, kernel launches per UNet forward;
  7. train    - the flagship train step (128^3, batch 2, bf16, dropout 0.1,
                bf16 first moment, EMA) via ``make_train_step``: a warm-up
                step, then timed steps: s/step, voxels/s, peak memory, kernel
                launches per step, finite loss and gradient norm, parameters
                changed;
  8. sfm      - preset ``trainSFM3D128_c_c`` (128^3, batch 4, bf16, dropout
                0.1, x0 fed as the spatial conditioning, zeros padding): a
                warm-up and timed train steps without remat, one step's peak
                memory with the preset's ``remat=True``, then
                ``SFM.draw_samples`` with Heun steps at batch 1: s/step,
                s/field at 250 steps, peak memory, launches per forward;
  9. ddnm     - ``ddnm_sample`` on the flagship VDM at 32^3, f32, half-box
                mask, 10 steps with 2 steps of time travel: finite and
                consistent with the measurement;
 10. cli      - the entry points as a user runs them, in this process
                (``vdm4cdm_torch.cli.train.main`` and ``.generate.main``),
                for each preset at full width on GRF data with remat off
                (as the bare steps): train 6 steps (SFM 3) with a checkpoint
                and validation every 3, run again to 8 (SFM 4), which must
                resume from step 6 (3) and write the last step, then the
                CV_12_12 campaign from those checkpoints (2 sampler steps;
                the VDM 4 reps a call, the SFM Heun): 12 finite files of
                (12, 1, 128, 128, 128) f32. One line per model: the CLI
                trainer's s/step (median after the first step) beside the
                bare step's of the ``train`` / ``sfm`` phase, host ms to
                make one batch alone, the feed wait per step, launches per
                step of the resumed run (which validates nowhere) against
                the bare step's, checkpoint bytes and save ms, the files.
                Run directories go to ``chiprun_out/cli_runs/``; the
                checkpoints and samples are deleted after their checks.
                Per model also ``panel_data`` of the CLI's
                validation-figure hook on the card from the checkpoint (2
                sampler steps; the card's host has no matplotlib, so the
                trainer runs without the hook), and for the VDM
                ``cli.calc_ss`` of its 128^3 campaign (the scattering-
                transform branch) with one sample's ``get_stats`` on the
                card against the CPU (within 1e-4, log-PDF counts equal);
 11. blessed  - the repository's trained model (``VDM_GRF_c_c_32``, step
                20000, converted to the port's format and named in
                ``configs/models_torch.yaml``): eps_hat on the card against
                the CPU path (one test batch, f32), ``cli.generate`` of its
                CV_12_12 campaign from the name alone (100 steps, 12 reps
                a call), the acceptance gate's statistics on boxes 0 and 1
                (4 reps each) and DDNM (50 steps, l = 3) beside their
                thresholds and the JAX run's recorded values, then
                ``cli.calc_ss``; any threshold failed fails the run; then a
                warm-up and 3 timed f32 train steps of the same model from
                its preset (batch 8, 32^3, the trained weights);
 12. chain    - the trained model's chain from scratch
                (``vdm4cdm_torch.cli.blessed_chain`` in this process: stages
                train, bless, generate, calc_ss) at the preset's full width
                (``VDM_GRF_c_c_32``: chs 16..64, 32^3, b8, f32, dropout
                0.1): 300 steps through ``cli.train`` with a checkpoint
                every 100 and every step's loss logged, ``cli.bless`` of
                step 300, a CV_12_12 campaign at 20 sampler steps from the
                chain's own registry file, ``cli.calc_ss``; then 2 fields of
                box 0 (20 steps, one seed) from the blessed copy, from the
                run directory and from the copy again. Fails unless every
                kernel of the train step and the sampler launched, the
                blessed tensors equal the run's bit for bit, the three
                draws are the same bits (the repeat spread
                ``fields_repeat_max_abs_diff`` is 0), weights and losses are
                finite, the mean loss of the last 50 steps is below that
                of the first 50, and the summary is whole. Its launches are
                the ``kernels`` line's ``launches`` of the eight unsharded
                kernels (this slice's path), also as ``launches_chain``;
 13. sharded  - the spatially sharded (``sp``) path: the parent spawns two
                ranks on cuda:0, joined over gloo (NCCL refuses two ranks
                on one device; gloo stages the halo planes through pinned
                host memory), each seeing exactly the shapes of a rank of a
                real sp = 2 run. Each rank holds the z-halo kernels
                (forward with bias, residual and sums, dx, dw + db) against
                their plain versions at its flagship slab shapes (bf16 and
                f32, circular and zeros); holds the sharded against the
                unsharded port on the card: eps_hat of the full-width VDM
                at 32^3 f32, the loss and every gradient of one sharded
                step (dropout 0), parameters bitwise equal across ranks
                after two steps, the SFM's Heun sampler (5 steps); then
                times a warm-up and 3 sharded VDM train steps at 128^3,
                batch 2, bf16, dropout 0.1, and 3 steps of the sharded VDM
                sampler at batch 1 (s/step, per-rank peak memory, the wall
                time in ppermute and all_reduce, the bytes staged through
                the host, per-rank launches). Rank 0 alone times the z-halo
                kernels and the norm kernels at its slab shapes (their CP
                use) while rank 1 waits. The ranks send their lines to the
                parent, which prints them. These times are those of two
                processes sharing one card through host memory: no
                multi-card figure;
 14. sharded_cli - the sharded CLI at the flagship's full width: two ranks
                on cuda:0 over gloo (as ``sharded``) run ``cli.train
                --preset trainVDM3D128_c_c --set parallel.n_sp=2`` (128^3,
                b2, chs 32..256, bf16, GRF, remat off) for 3 steps with a
                checkpoint at 2, resumed to 4, then ``cli.generate`` of one
                CV_12_12 box (12 fields, 2 a sampler call, 5 steps) and one
                timed call of the sharded sampler. Fails unless the CLI
                exits 0 on both ranks, the losses and fields are finite, the
                ranks' parameter digests agree at every checkpoint (the
                trainer compares them), rank 0 wrote the checkpoints,
                ``metrics.csv`` and the file, and every z-halo and CP kernel
                launched. One line a rank and one for the phase: the
                per-rank s/step (median of steps 2-4), peak GiB a rank, the
                sharded sampler's s/field at 250 steps, the launches (the
                ``kernels`` line's ``launches_sharded_cli``);
 15. twod     - the 2D model family at the full width of its presets (256^2,
                batch 12, f32, chs 48..384, GRF data: circular), whose convs
                are all cuDNN's and whose norms and skip projections are the
                hand kernels: the library conv's precision with the process
                at PyTorch's default TF32 setting (``conv_nd`` forward, dx
                and dw against f64, at f32 accuracy); ``train_uc_c``'s
                eps_hat and every gradient (64^2 crop, b2, dropout 0.1) on
                the card against the CPU path; every distinct norm and
                ``skip_proj`` site of ``train_uc_c`` (read off a forward)
                checked and timed at b12 (``site`` lines, the 3D lines'
                names), and a decoder join whose group straddles its
                halves; 3 timed train steps of ``train_uc_c`` and of
                ``trainSFM_c_uc`` (mid_attn) with s/step, Mpixel/s, peak
                memory, launches per step, then their device time by
                category and idle share, and 3 sampler steps at b1 (VDM
                ancestral, SFM Heun): s/step, s/field at 250; then
                ``cli.train --preset smoke_vdm_2d`` to 3 steps, resumed to
                5 (launches per step equal to a bare step's of the preset),
                and ``cli.generate`` CV_12_12 from its checkpoints (12
                files of (12, 1, 32, 32)); then ``python -m
                vdm4cdm_torch.examples.smoke_test --steps 5`` in a process
                of its own (the panel's arrays without matplotlib);
 16. twod_sharded - the 2D presets under ``sp`` sharding: ``entry()`` of
                ``vdm4cdm_torch/parallel/dryrun.py`` once (the flagship's
                forward at 32^3, finite), then two ranks on cuda:0 over
                gloo (as ``sharded``), each holding ``train_uc_c`` (VDM)
                and ``trainSFM_c_uc`` (SFM, mid_attn: the gathered
                bottleneck attention) at full width (chs 48..384, f32,
                dropout off) split along H against unsharded on a 64^2
                crop, batch 2: eps_hat / velocity and 5 sampler steps within
                1e-4, the loss and every gradient within 2e-3; then
                ``cli.train --preset train_uc_c --set parallel.n_sp=2`` at
                256^2 (global batch 4, GRF, dropout 0.1) for 3 steps with a
                checkpoint at 2, resumed to 4, ``cli.generate`` of one
                CV_12_12 box (2 fields a call, 5 steps), one timed call of
                the sharded sampler and one bare step with the collectives'
                counters (``CommStats``). Fails unless the parity holds, the
                CLI exits 0 on both ranks, losses and fields are finite, the
                ranks' digests agree at every checkpoint, every norm and 1x1
                kernel launched and no conv3d kernel did. One line for the
                phase: per-rank s/step (median of steps 2-4), feed wait,
                peak GiB a rank, the sampler's s/field at 250 steps, the
                collectives a step, the launches (the ``kernels`` line's
                ``launches_twod_sharded``);
 17. profile  - device time by kernel and the device's idle share over UNet
                forwards and over a train step at 128^3 (VDM and SFM), and
                over the blessed model's forward at (12, 32^3) f32 with its
                3x3x3 convs' GFLOP, rate and share of the 3xTF32 bound
                (``blessed_conv_rate``), and over its f32 train step
                (``blessed_train_dw``: dw's device ms a step);
 18. the ``kernels`` line (``launches``: of the eight unsharded kernels,
     the ``chain`` phase's, this slice's path; the ``blessed`` phase's as
     ``launches_blessed`` and the CUDA kernels the conv forward's calls
     launched there as ``cuda_launches_blessed`` (an f32 call launches two
     or three); the whole ``cli`` phase's as ``launches_cli``; ``ms``,
     ``bound_ms`` and ``max_abs_err`` at the SFM's 128^3 batch-4 shape, named
     in ``shape`` and ``padding``; the earlier paths' launches as
     ``launches_sfm_train``, ``launches_vdm_train``, ``launches_sampler`` and
     ``launches_sfm_sampler``; the sharded train steps' launches on rank 0 as
     ``launches_sharded``, which is also the ``launches`` of the z-halo rows
     and of the norm kernels' CP rows; the ``sharded_cli`` phase's, rank
     0's, as ``launches_sharded_cli``; the ``twod`` phase's launches as
     ``launches_twod`` and, for the norm and 1x1 kernels, their largest 2D
     site's times as ``twod_site``; the ``twod_sharded`` phase's, rank 0's,
     as ``launches_twod_sharded``, on the CP rows too), the raw nvidia-smi
     line, and last
     {"ok": true, "device": {...}}.

``--phases trained`` (run only when asked) drives the whole chain of the
blessed model (20000 steps, bless, the 250-step CV_12_12 campaign, calc_ss,
the acceptance gate) in ``runs/blessed_chain``, resuming from the latest
checkpoint there, and fails unless the gate passes; an hour of steps does
not fit one chip call, so the first steps go through ``python -m
vdm4cdm_torch.cli.blessed_chain --until S --stages train`` and the latest
checkpoint is carried over (its log: ``chiprun_out/trained.log``).

``--phases precision`` (run only when asked) holds the trained model's f32
path with the process at PyTorch's default TF32 setting: eps_hat against
the CPU and the library convs' device ms, a forward and a train step; with
``--port DIR`` of an earlier commit, in the same call, the before column.

The models are built from their presets' names (``vdm4cdm_torch.presets`` and
``config.build_model``) with the crop size overridden and ``remat`` off where
the card is timed. The VDM phases set ``data.kind="grf"`` (periodic synthetic
fields, circular padding, as this script has always measured them); the SFM
keeps its preset's zeros padding at a 128^3 crop. Every parameter is drawn
from a seeded normal at fan-in scale: a fresh model has zero ``conv_out`` and
zero second ResBlock convs, so its output is 0 and would hide a broken kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s per type
# ("float32" on the FMA units, "tf32" on the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

# the two models, by preset: the flagship VDM (bench.py's model) and the SFM
VDM_PRESET, SFM_PRESET = "trainVDM3D128_c_c", "trainSFM3D128_c_c"
CHS = (32, 64, 128, 256)
MAIN_SIZE, MAIN_STEPS, FIELD_STEPS = 128, 3, 250
PARITY_SIZE = 32
TRAIN_BATCH, TRAIN_STEPS, EMA_DECAY = 2, 3, 0.999
SFM_BATCH, SFM_SIGMA = 4, 0.5
DDNM_STEPS, DDNM_L = 10, 2
PHASES = ("kernels", "parity", "grads", "main", "train", "sfm", "ddnm",
          "cli", "blessed", "chain", "sharded", "sharded_cli", "twod",
          "twod_sharded", "profile")  # in the order they run
# run only when asked: the conv, skip_proj and GroupNorm sites' timings
# alone (the kernels phase takes them too), or the GroupNorm sites' alone,
# for a before/after table with --port; the trained model's f32 path at
# PyTorch's default TF32 setting
EXTRA_PHASES = ("sites", "norm_sites", "precision", "trained")
# (size, channels) of the GroupNorm checks; the dropout checks; the skip join
# (size, Ca, Cb, groups) whose group of 48 channels straddles the boundary
NORM_CASES = ((128, 32), (128, 64), (64, 64), (64, 128), (32, 128),
              (32, 256), (16, 256))
DROPOUT_CASES = ((128, 32), (32, 128), (16, 30))  # 30: the per-element mask
PAIR_CASE = (32, 256, 128, 8)

# tolerances, as max |kernel - plain| / max(1, max |plain|):
#   f32 conv: 27*Cin-term f32 sums in another order -> 1e-4
#   bf16 conv / apply: output rounded to bf16 (2^-8 relative); the two orders
#   can land one bf16 ulp apart -> 1.6e-2
#   sums: f32 sums over up to 2M voxels in another order than the plain
#   version's (the reductions' partials, folded in a fixed order: the same
#   bits from run to run, which the checks hold too), relative to max |sum|
#   -> 1e-4
#   dw / db: f32 sums over up to 4.2M voxels, split over blocks and joined
#   by atomics in run-dependent order, relative to max |dw| -> 2e-4 (both
#   dtypes: bf16 products are exact in f32)
#   backward apply: as apply, but f32 gets 1e-4: dx is a difference of terms
#   up to 1e2 times larger than the result
#   mm1x1: as the conv (a K-term f32 sum in another order; one bf16
#   rounding), its dw as the conv's dw
TOL = {("conv", "float32"): 1e-4, ("conv", "bfloat16"): 1.6e-2,
       ("apply", "float32"): 1e-5, ("apply", "bfloat16"): 1.6e-2,
       ("sums", "float32"): 1e-4, ("sums", "bfloat16"): 1e-4,
       ("dw", "float32"): 2e-4, ("dw", "bfloat16"): 2e-4,
       ("bwd_apply", "float32"): 1e-4, ("bwd_apply", "bfloat16"): 1.6e-2}
PARITY_TOL = 1e-3  # eps_hat, f32 kernels on the card vs f32 CPU plain path
# loss and parameter gradients, f32 kernels on the card vs the f32 CPU plain
# path, each tensor relative to max(max |ref|, 1e-3 of the largest gradient):
# about 120 kernels deep with atomics and another summation order
GRADS_TOL = 2e-3
# remat on against off, both on the card: the recomputed forward repeats the
# same kernels, whose atomics sum in another order
REMAT_TOL = 1e-4
DROPOUT_P = 0.1
# the sharded phase: sp ranks sharing cuda:0, their job's time limit, the
# SFM sampler's steps; eps_hat and the SFM samples, sharded against
# unsharded on the card in f32: the same kernels' arithmetic, but the
# GroupNorm sums all-reduced from two halves and the conv's z taps read
# from exchanged planes, in another order -> 1e-4
SHARDED_RANKS, SHARDED_TIMEOUT, SFM_SHARDED_STEPS = 2, 900.0, 5
SHARDED_TOL = 1e-4


# the fewest timed launches of a norm or 1x1 kernel: at 5, one stall in a
# run of (4, 128^3) launches moved a mean by a quarter
TIMED_MIN = 20

LINES_FILE = OUT_DIR / "chip_smoke_lines.jsonl"  # every line, written through
# in a rank of the sharded phase, the list its lines go to (the parent
# prints them); None in the parent
_SINK = None


def emit(obj) -> None:
    if _SINK is not None:
        _SINK.append(obj)
        return
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LINES_FILE, "a") as fh:
        fh.write(line + "\n")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_us(fn, iters: int = 200) -> float:
    """Wall time per call over ``iters`` calls queued without waiting."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def bound_ms(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def cudnn_benchmark(tf32: bool = False):
    """``torch.backends.cudnn.benchmark`` on, so that cuDNN times its
    algorithms for these shapes and layouts and keeps the fastest (the
    warm-up calls pay for that search); with ``tf32`` cuDNN may also round
    f32 operands to TF32 (another function: one TF32 pass). The settings
    are restored after."""
    import torch

    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = before


def library_time_ms(fn, iters: int, tf32: bool = False) -> float:
    """The time of one library call (a yardstick, used nowhere in the port)
    under ``cudnn_benchmark(tf32)``."""
    with cudnn_benchmark(tf32):
        return cuda_time_ms(fn, iters, warmup=3)


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``, the host's launch cost left out:
    ``iters`` calls captured in one CUDA graph (after two warm-up calls on
    a side stream), replayed ``reps`` times between events. Where a call's
    kernels take less time than the host needs to launch them,
    ``cuda_time_ms`` reads the host's rate and this the card's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def f32_yardsticks(kern, lib, n, flops, nbytes):
    """An f32 conv's extra yardsticks: cuDNN with TF32 on, the bounds of
    the work in 3xTF32 (three TF32 products an f32 one, on the tensor
    cores) and on the FMA units, and the device time alone of the kernel
    and of cuDNN f32 (``graph_time_ms``)."""
    with cudnn_benchmark():
        lib_device = graph_time_ms(lib)
    return {"library_tf32_ms": library_time_ms(lib, n, tf32=True),
            "bound_3xtf32_ms": bound_ms(3 * flops, nbytes, "tf32")[0],
            "bound_ffma_ms": bound_ms(flops, nbytes, "float32")[0],
            "device_ms": graph_time_ms(kern), "library_device_ms": lib_device}


def channels_last(t):
    """An NCDHW-shaped tensor in ``channels_last_3d`` memory: the library
    conv's operands all in the layout the port keeps its activations in."""
    import torch

    return t.contiguous(memory_format=torch.channels_last_3d)


def conv_weight_grad(xc, ctc, wc, padding):
    """The library's weight gradient of a stride-1 conv: one
    ``aten.convolution_backward`` call asking for the weight's gradient
    only, given a real weight tensor ``wc`` so that its layout is defined
    (``torch.nn.grad.conv3d_weight`` passes an expanded, zero-stride one)."""
    import torch

    return torch.ops.aten.convolution_backward(
        ctc, xc, wc, None, [1, 1, 1], [padding] * 3, [1, 1, 1], False,
        [0, 0, 0], 1, (False, True, False))[1]


LIB_CONV = "F.conv3d, channels_last_3d operands, cudnn.benchmark"
LIB_WGRAD = ("aten.convolution_backward (weight only, no db), "
             "channels_last_3d operands, cudnn.benchmark")


def rel_err(got, ref) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def randomize_(module, seed: int) -> None:
    """Every parameter from a seeded normal: kernels at fan-in scale, norm
    scales 1 + 0.2 N, biases 0.2 N (the schedule keeps its init)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.startswith("schedule."):
                continue
            leaf = name.rsplit(".", 1)[-1]
            n = torch.randn(p.shape, generator=gen)
            if leaf == "kernel":
                if ".qkv." in name:
                    fan_in = p.shape[0]
                elif ".proj." in name and p.ndim == 3:
                    fan_in = p.shape[0] * p.shape[1]
                else:
                    fan_in = math.prod(p.shape[:-1])
                v = n / math.sqrt(fan_in)
            elif leaf == "scale":
                v = 1.0 + 0.2 * n
            else:
                v = 0.2 * n
            p.copy_(v.to(p.device))


# ------------------------------------------------------------------ kernels

def conv_cases():
    """(size, cin, cout, modes x dtypes) at the sampler's conv shapes;
    the main path runs bf16 circular, the flagship and the widest shapes get
    all four combinations."""
    full = [(m, d) for m in ("circular", "zeros")
            for d in ("bfloat16", "float32")]
    main = [("circular", "bfloat16")]
    return [
        (128, 32, 32, full),   # level-0 ResBlock convs
        (128, 64, 32, main),   # up_0_0 pair half (h)
        (128, 64, 64, main),   # upsample_1 conv
        (64, 64, 64, main),
        (64, 128, 64, main),   # up_1_0 pair half (h)
        (64, 32, 64, main),    # down_1_0 conv1
        (64, 128, 128, main),  # upsample_2 conv
        (32, 128, 128, main),
        (32, 256, 128, main),  # up_2_0 pair half (h)
        (32, 256, 256, main),  # upsample_3 conv
        (16, 256, 256, full),  # level-3 ResBlock convs, 256+256 pair halves
        (16, 128, 256, main),  # up_3_2 pair half (skip)
        # channel tails: widths that are not multiples of the kernels' 32 and
        # 64 channel tiles (the CUNet's default chs are 48, 96, ...)
        (16, 48, 96, full),
    ]


def blessed_conv_cases():
    """(size, cin, cout) of every distinct 3x3x3 conv site of the trained
    model (``VDM_GRF_c_c_32``: chs 16-64 at 32^3, f32, circular), the split
    pairs' halves included: 13 sites of its 59 convs a forward, traced from
    one forward (``conv_gflop`` holds the list to the forward on the
    card)."""
    return [(32, 16, 16), (32, 32, 16), (32, 32, 32),
            (16, 16, 32), (16, 32, 32), (16, 48, 32), (16, 48, 48),
            (8, 32, 48), (8, 48, 48), (8, 64, 48), (8, 64, 64),
            (4, 48, 64), (4, 64, 64)]


def check_conv(torch, K, size, cin, cout, mode, dtype_name, batch, timed,
               tf32=False):
    """The forward with bias, residual and sums against its plain version;
    ``timed`` adds kernel, plain, library and bound times, ``tf32`` the f32
    yardsticks (``f32_yardsticks``)."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 1000 + cin + cout)
    shape = (batch, size, size, size)
    x = torch.randn(*shape, cin, generator=gen, device="cuda").to(dtype)
    w = torch.randn(3, 3, 3, cin, cout, generator=gen, device="cuda")
    w = w / math.sqrt(27 * cin)
    bias = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    res = torch.randn(*shape, cout, generator=gen, device="cuda").to(dtype)
    circ = mode == "circular"
    with torch.inference_mode():
        y, s = K.conv3d_k3s1_fwd(x, w, bias, res, circ, True)
        y2, s2 = K.conv3d_k3s1_fwd(x, w, bias, res, circ, True)
        yr, sr = K.conv3d_k3s1_plain(x, w, bias, res, circ, True)
        torch.cuda.synchronize()
        abs_err, err = rel_err(y, yr)
        _, s_err = rel_err(s / sr.abs().max(), sr / sr.abs().max())
        tol, s_tol = TOL[("conv", dtype_name)], TOL[("sums", dtype_name)]
        repeats = bool(torch.equal(y, y2) and torch.equal(s, s2))
        line = {"phase": "kernel", "kernel": "conv3d_k3s1_fwd",
                "shape": [batch, size, size, size, cin, cout], "mode": mode,
                "dtype": dtype_name, "max_abs_err": abs_err,
                "rel_err": err, "tol": tol, "sums_rel_err": s_err,
                "sums_tol": s_tol, "repeats_bitwise": repeats}
        # a port whose sums are folded in a fixed order (``sums_plan``)
        # repeats bit for bit; an earlier one (``--port``) added them with
        # atomics
        if not (err <= tol and s_err <= s_tol
                and (repeats or not _folds_conv_sums(K))):
            emit(line)
            raise AssertionError(f"conv3d_k3s1_fwd disagrees: {line}")
        if timed:
            n = max(3, min(50, int(2e7 // (batch * size ** 3))))
            elt = x.element_size()
            vox = batch * size ** 3
            flops = 2.0 * 27 * cin * cout * vox
            nbytes = vox * (cin + 2 * cout) * elt + w.numel() * elt
            b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
            # x (B, D, H, W, C) seen as NCDHW is channels_last_3d already
            xc = x.permute(0, 4, 1, 2, 3)
            wc = channels_last(w.to(dtype).permute(4, 3, 0, 1, 2))
            bc = bias.to(dtype)
            if circ:
                xp = channels_last(F.pad(xc, (1,) * 6, mode="circular"))
                lib = lambda: F.conv3d(xp, wc, bc)  # noqa: E731
            else:
                lib = lambda: F.conv3d(xc, wc, bc, padding=1)  # noqa: E731
            line.update(
                ms=cuda_time_ms(lambda: K.conv3d_k3s1_fwd(
                    x, w, bias, res, circ, True), n),
                plain_ms=cuda_time_ms(lambda: K.conv3d_k3s1_plain(
                    x, w, bias, res, circ, True), max(2, n // 4)),
                library_ms=library_time_ms(lib, n), library_call=LIB_CONV,
                bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
            if tf32:
                line.update(f32_yardsticks(lambda: K.conv3d_k3s1_fwd(
                    x, w, bias, res, circ, True), lib, n, flops, nbytes))
    emit(line)
    return line


def _folds_conv_sums(K) -> bool:
    """Whether the port's conv forward folds its sums in a fixed order."""
    return hasattr(sys.modules[K.conv3d_k3s1_fwd.__module__], "sums_plan")


def check_fwd_repeats(torch, K):
    """The conv forward twice on the same inputs at every z mode (SAME,
    halo, and the full-in-z dx pass) in both dtypes and on the f32 K-split
    path: outputs and sums equal bit for bit."""
    from vdm4cdm_torch.ops.kernels import conv3d as C

    t0 = time.perf_counter()
    cases = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(91)
        x = torch.randn(2, 18, 32, 32, 32, generator=gen,
                        device="cuda").to(dtype)
        ct = torch.randn(2, 16, 32, 32, 64, generator=gen,
                         device="cuda").to(dtype)
        w = torch.randn(3, 3, 3, 32, 64, generator=gen, device="cuda") / 30
        b = torch.randn(64, generator=gen, device="cuda")
        calls = {
            "zmode 0": lambda: K.conv3d_k3s1_fwd(
                x[:, 1:17].contiguous(), w, b, None, True, True),
            "zmode 1": lambda: K.conv3d_k3s1_zhalo_fwd(x, w, b, None, True,
                                                       True),
            "zmode 2": lambda: (K.conv3d_k3s1_zhalo_dx(ct, w, True), None),
        }
        if dtype_name == "float32":
            xk = torch.randn(12, 4, 4, 4, 48, generator=gen, device="cuda")
            wk = torch.randn(3, 3, 3, 48, 64, generator=gen,
                             device="cuda") / 30
            calls["K split"] = lambda: K.conv3d_k3s1_fwd(xk, wk, b, None,
                                                         True, True)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ks = C.fwd_plan(dtype, 12, 4, 4, 4, 48, 64, sms).ksplit
            fail_unless(ks > 1, "the K-split case does not split K",
                        {"ksplit": ks})
        with torch.inference_mode():
            for name, call in calls.items():
                y1, s1 = call()
                y2, s2 = call()
                torch.cuda.synchronize()
                cases.append({"case": name, "dtype": dtype_name,
                              "out_equal": bool(torch.equal(y1, y2)),
                              "sums_equal": (s1 is None or
                                             bool(torch.equal(s1, s2)))})
    line = {"phase": "kernel", "kernel": "conv3d_k3s1_fwd (repeats)",
            "cases": cases, "all_equal": all(c["out_equal"] and c["sums_equal"]
                                             for c in cases),
            "seconds": time.perf_counter() - t0}
    fail_unless(line["all_equal"], "the conv forward does not repeat", line)
    emit(line)


def sums_plan_fields(torch, K, x, kind, repeats):
    """The launch plan a reduction (``kind`` "sums" for ``gn_sums``, "bwd"
    or "bwd_dropout" for ``gn_bwd_sums``) took on x, and whether a second
    call gave the same bits; empty for a port whose reductions have no such
    plan (an earlier commit, whose atomics sum in a run-dependent order)."""
    mod = sys.modules[K.gn_sums.__module__]
    if not hasattr(mod, "sums_plan"):
        return {}
    B, S, C = x.shape
    p = mod.sums_plan(B, S, C, x.element_size(),
                      torch.cuda.get_device_properties(
                          x.device).multi_processor_count, kind)
    return {"plan": {"block_c": p.block_c, "chunks": p.chunks,
                     "padded": p.padded, "runs": p.runs,
                     "row_blocks": p.row_blocks,
                     "programs": math.prod(p.grid)},
            "repeats_bitwise": repeats}


def check_norm(torch, K, size, C, dtype_name, batch, timed, S=None):
    """``S`` voxels (default size^3)."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 7 + C)
    S = S or size ** 3
    x = (1.5 * torch.randn(batch, S, C, generator=gen, device="cuda")
         + 0.4).to(dtype)
    a = 1.0 + 0.3 * torch.randn(batch, C, generator=gen, device="cuda")
    bv = 0.2 * torch.randn(batch, C, generator=gen, device="cuda")
    lines = []
    with torch.inference_mode():
        s, sr = K.gn_sums(x), K.gn_sums_plain(x)
        y, yr = K.gn_apply(x, a, bv, "silu"), K.gn_apply_plain(x, a, bv, True)
        repeats = torch.equal(K.gn_sums(x), s)
        torch.cuda.synchronize()
        elt = x.element_size()
        for name, got, ref, kind in (("gn_sums", s, sr, "sums"),
                                     ("gn_apply", y, yr, "apply")):
            abs_err, err = rel_err(got, ref)
            if kind == "sums":
                err = abs_err / ref.abs().max().item()
            tol = TOL[(kind, dtype_name)]
            line = {"phase": "kernel", "kernel": name,
                    "shape": [batch, S, C], "dtype": dtype_name,
                    "max_abs_err": abs_err, "rel_err": err, "tol": tol}
            if kind == "sums":
                line.update(sums_plan_fields(torch, K, x, "sums", repeats))
            if err > tol or not line.get("repeats_bitwise", True):
                emit(line)
                raise AssertionError(f"{name} disagrees: {line}")
            if timed:
                n = max(TIMED_MIN, min(100, int(4e8 // (batch * S * C))))
                if kind == "sums":
                    nbytes = batch * S * C * elt + batch * 2 * C * 4
                    flops = 3.0 * batch * S * C
                    line.update(
                        ms=cuda_time_ms(lambda: K.gn_sums(x), n),
                        plain_ms=cuda_time_ms(lambda: K.gn_sums_plain(x), n),
                        library_ms=cuda_time_ms(lambda: torch.var_mean(
                            x, dim=1, correction=0), n),
                        library_call="torch.var_mean(x, dim=1, correction=0)"
                                     " (the same per-(b, c) statistics)",
                        device_ms=graph_time_ms(lambda: K.gn_sums(x)),
                        library_device_ms=graph_time_ms(
                            lambda: torch.var_mean(x, dim=1, correction=0)))
                else:
                    nbytes = 2 * batch * S * C * elt + 2 * batch * C * 4
                    flops = 6.0 * batch * S * C
                    xg = x.permute(0, 2, 1)  # (B, C, S) view, channels-last
                    line.update(
                        ms=cuda_time_ms(lambda: K.gn_apply(x, a, bv, "silu"),
                                        n),
                        plain_ms=cuda_time_ms(
                            lambda: K.gn_apply_plain(x, a, bv, True), n),
                        library_ms=cuda_time_ms(
                            lambda: F.silu(F.group_norm(xg, 8)), n),
                        library_call="F.group_norm + F.silu (stats included)")
                line["bound_ms"], line["bound_by"] = bound_ms(
                    flops, nbytes, dtype_name)
            emit(line)
            lines.append(line)
    return lines


def check_pair_norm(torch, size, ca, cb, groups, dtype_name, nd=3):
    """A decoder skip join through both GroupNorm kernels: joint statistics
    over a Pair of ``nd``-dimensional halves whose group straddles the
    boundary, against GroupNorm + SiLU over the materialized concat in plain
    f32 torch."""
    from vdm4cdm_torch.ops.norm import norm_affine_act
    from vdm4cdm_torch.ops.pair import Pair

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size + ca + cb)
    shape = (2,) + (size,) * nd
    xa = (1.3 * torch.randn(*shape, ca, generator=gen, device="cuda")
          + 0.2).to(dtype)
    xb = (0.7 * torch.randn(*shape, cb, generator=gen, device="cuda")
          - 0.4).to(dtype)
    C = ca + cb
    a = 1.0 + 0.3 * torch.randn(2, C, generator=gen, device="cuda")
    b = 0.2 * torch.randn(2, C, generator=gen, device="cuda")
    with torch.inference_mode():
        y = norm_affine_act(Pair(xa, xb), a, b, groups, act="silu")
        x = torch.cat([xa, xb], -1).float().reshape(2, -1, groups, C // groups)
        mean = x.mean((1, 3), keepdim=True)
        var = x.var((1, 3), keepdim=True, unbiased=False)
        ref = ((x - mean) * torch.rsqrt(var + 1e-6)).reshape(2, -1, C)
        ref = torch.nn.functional.silu(ref * a[:, None] + b[:, None])
        got = torch.cat([y.a, y.b], -1).reshape(2, -1, C)
        torch.cuda.synchronize()
    abs_err, err = rel_err(got, ref)
    tol = TOL[("apply", dtype_name)]
    if dtype_name == "float32":
        tol = 1e-4  # two-pass sums vs torch's centred variance, in f32
    group = C // groups
    line = {"phase": "kernel", "kernel": "gn_sums+gn_apply (pair)",
            "shape": [2, size ** nd, ca, cb], "groups": groups,
            "straddling_group": [(ca // group) * group,
                                 (ca // group + 1) * group - 1],
            "dtype": dtype_name, "max_abs_err": abs_err, "rel_err": err,
            "tol": tol}
    emit(line)
    if ca % group == 0 or err > tol:
        raise AssertionError(f"pair GroupNorm check failed: {line}")


def fail_unless(ok: bool, what: str, line: dict) -> None:
    if not ok:
        emit(line)
        raise AssertionError(f"{what}: {line}")


def check_conv_bwd(torch, K, size, cin, cout, mode, dtype_name, batch, timed,
                   tf32=False):
    """The dx pass (the forward kernel on ct with flipped, transposed
    weights) and ``conv3d_k3s1_dw`` against autograd through the plain conv
    in f32, and dw/db also against the module's plain version. Returns the
    (dx, dw) lines."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 1000 + cin - cout)
    shape = (batch, size, size, size)
    x = torch.randn(*shape, cin, generator=gen, device="cuda").to(dtype)
    w = torch.randn(3, 3, 3, cin, cout, generator=gen, device="cuda")
    w = w / math.sqrt(27 * cin)
    ct = torch.randn(*shape, cout, generator=gen, device="cuda").to(dtype)
    circ = mode == "circular"
    with torch.no_grad():
        dx = K.conv3d_k3s1_dx(ct, w, circ)
        dw, db = K.conv3d_k3s1_dw(x, ct, circ)
        dw_p, db_p = K.conv3d_k3s1_dw_plain(x, ct, circ)
    # autograd through the plain conv: f32, weights rounded to x's dtype;
    # detached, so that in f32 (where .float() is the tensor itself) the
    # kernels' inputs do not come to require grad
    xr = x.float().detach().requires_grad_(True)
    wr = w.to(dtype).float().detach().requires_grad_(True)
    br = torch.zeros(cout, device="cuda", requires_grad=True)
    yr, _ = K.conv3d_k3s1_plain(xr, wr, br, None, circ, False)
    dx_r, dw_r, db_r = torch.autograd.grad(yr, (xr, wr, br), ct.float())
    torch.cuda.synchronize()
    del yr, xr
    tol_dx, tol_dw = TOL[("conv", dtype_name)], TOL[("dw", dtype_name)]
    dx_abs, dx_err = rel_err(dx, dx_r)

    def scaled(got, ref):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    dx_line = {"phase": "kernel", "kernel": "conv3d_k3s1_fwd (dx pass)",
               "shape": [batch, size, size, size, cout, cin], "mode": mode,
               "dtype": dtype_name, "max_abs_err": dx_abs, "rel_err": dx_err,
               "tol": tol_dx}
    fail_unless(dx_err <= tol_dx, "dx pass disagrees", dx_line)
    line = {"phase": "kernel", "kernel": "conv3d_k3s1_dw",
            "shape": [batch, size, size, size, cin, cout], "mode": mode,
            "dtype": dtype_name,
            "max_abs_err": (dw - dw_p).abs().max().item(),
            "rel_err": scaled(dw, dw_p), "db_rel_err": scaled(db, db_p),
            "rel_err_autograd": scaled(dw, dw_r),
            "db_rel_err_autograd": scaled(db, db_r), "tol": tol_dw}
    fail_unless(max(line["rel_err"], line["db_rel_err"],
                    line["rel_err_autograd"],
                    line["db_rel_err_autograd"]) <= tol_dw,
                "conv3d_k3s1_dw disagrees", line)
    if timed:
        n = max(3, min(30, int(1e7 // (batch * size ** 3))))
        elt = x.element_size()
        vox = batch * size ** 3
        flops = 2.0 * 27 * cin * cout * vox
        wbytes = 27 * cin * cout * elt
        pad = 0 if circ else 1

        def ncdhw(t):  # (B, D, H, W, C) as NCDHW, circular-padded if so
            t = t.permute(0, 4, 1, 2, 3)
            return channels_last(F.pad(t, (1,) * 6, mode="circular")) \
                if circ else t

        xc, ctc, ctp = ncdhw(x), ct.permute(0, 4, 1, 2, 3), ncdhw(ct)
        wc = channels_last(w.to(dtype).permute(4, 3, 0, 1, 2))
        wtc = channels_last(w.to(dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2))
        w_t = w.flip(0, 1, 2).transpose(3, 4)
        dx_bytes = vox * (cout + cin) * elt + wbytes
        b_ms, b_by = bound_ms(flops, dx_bytes, dtype_name)
        dx_lib = lambda: F.conv3d(ctp, wtc, padding=pad)  # noqa: E731
        dx_line.update(
            ms=cuda_time_ms(lambda: K.conv3d_k3s1_dx(ct, w, circ), n),
            plain_ms=cuda_time_ms(lambda: K.conv3d_k3s1_plain(
                ct, w_t, circular=circ), max(2, n // 4)),
            library_ms=library_time_ms(dx_lib, n),
            library_call=LIB_CONV + " (ct, flipped transposed weights)",
            bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
        dw_bytes = vox * (cin + cout) * elt + (27 * cin * cout + cout) * 4
        b_ms, b_by = bound_ms(flops, dw_bytes, dtype_name)
        dw_lib = lambda: conv_weight_grad(xc, ctc, wc, pad)  # noqa: E731
        line.update(
            ms=cuda_time_ms(lambda: K.conv3d_k3s1_dw(x, ct, circ), n),
            plain_ms=cuda_time_ms(
                lambda: K.conv3d_k3s1_dw_plain(x, ct, circ), 2, 1),
            library_ms=library_time_ms(dw_lib, n),
            library_call=LIB_WGRAD,
            bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
        if tf32:
            with torch.no_grad():
                dx_line.update(f32_yardsticks(
                    lambda: K.conv3d_k3s1_dx(ct, w, circ), dx_lib, n, flops,
                    dx_bytes))
                line.update(f32_yardsticks(
                    lambda: K.conv3d_k3s1_dw(x, ct, circ), dw_lib, n, flops,
                    dw_bytes))
    emit(dx_line)
    emit(line)
    return dx_line, line


def norm_inputs(torch, size, C, dtype_name, batch, groups=8, S=None):
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 11 + C)
    S = S or size ** 3
    x = (1.5 * torch.randn(batch, S, C, generator=gen, device="cuda")
         + 0.4).to(dtype)
    ct = torch.randn(batch, S, C, generator=gen, device="cuda").to(dtype)
    a = 1.0 + 0.3 * torch.randn(batch, C, generator=gen, device="cuda")
    b = 0.2 * torch.randn(batch, C, generator=gen, device="cuda")
    xg = x.float().reshape(batch, S, groups, C // groups)
    mean = xg.mean((1, 3)).repeat_interleave(C // groups, -1).contiguous()
    var = xg.var((1, 3), unbiased=False)
    inv = torch.rsqrt(var + 1e-6).repeat_interleave(C // groups, -1)
    return x, ct, mean, inv.contiguous(), a, b


def check_dropout_apply(torch, K, size, C, dtype_name, batch, S=None):
    """``gn_apply`` at p = 0.1 against its plain version: the kernel's Philox
    bits equal the plain version's (one differing bit is an O(1) error), and
    the keep rate lies within 4 sigma of 1 - p. ``S`` voxels (default
    size^3)."""
    x, _, mean, inv, a, b = norm_inputs(torch, size, C, dtype_name, batch,
                                        groups=math.gcd(C, 8), S=S)
    scale, shift = a * inv, b - mean * a * inv
    seed = 0x1234567890ABCDEF ^ (size * C)
    from vdm4cdm_torch.ops.kernels.philox import keep_mask_plain

    with torch.inference_mode():
        y = K.gn_apply(x, scale, shift, "silu", DROPOUT_P, seed)
        yr = K.gn_apply_plain(x, scale, shift, True, DROPOUT_P, seed)
        y2 = K.gn_apply(x, scale, shift, "silu", DROPOUT_P, seed + 1)
        # the kernel's mask, read off its zeros, against the plain mask; a
        # kept value that is itself (rounded to) zero cannot tell
        undropped = K.gn_apply_plain(x, scale, shift, True)
        keep = keep_mask_plain(seed, x.shape, DROPOUT_P, x.device)
        mismatch = ((y != 0) != keep) & (undropped.float().abs() > 1e-30)
        torch.cuda.synchronize()
    abs_err, err = rel_err(y, yr)
    n = y.numel()
    rate = (y != 0).sum().item() / n
    n_mismatch = int(mismatch.sum().item())
    differs = ((y == 0) != (y2 == 0)).any().item()
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / n)
    tol = TOL[("apply", dtype_name)]
    line = {"phase": "kernel", "kernel": "gn_apply (dropout)",
            "shape": list(x.shape), "dtype": dtype_name,
            "p": DROPOUT_P, "max_abs_err": abs_err, "rel_err": err,
            "tol": tol, "mask_mismatches": n_mismatch, "keep_rate": rate,
            "keep_rate_sigmas": abs(rate - (1 - DROPOUT_P)) / sigma,
            "other_seed_differs": differs}
    fail_unless(err <= tol and n_mismatch == 0 and differs
                and line["keep_rate_sigmas"] <= 4.0,
                "gn_apply with dropout disagrees", line)
    emit(line)


def check_dropout_bwd(torch, K, batch, S, C):
    """The mask the two backward kernels regenerate, bit for bit against
    the plain mask at p = 0.1, bf16. ``gn_bwd_apply`` with no activation,
    a = inv = 1, mean = 0 and zero group means returns dx = dy = ct * keep /
    (1 - p), so with ct = 1 its zeros are the dropped elements, at (batch,
    S, C). ``gn_bwd_sums`` sums over the voxels, so it runs on 12 voxels
    with x the powers 2^s: its sum of dy * xhat is, per (b, c), the 12-bit
    integer sum of keep_s 2^s times 1 / (1 - p), which it carries exactly,
    and its sum of dy the kept count times the same."""
    from vdm4cdm_torch.ops.kernels.philox import keep_mask_plain

    seed = 0x0FEDCBA987654321 ^ (S * C)
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(S + C)
    lines = []
    with torch.inference_mode():
        x = torch.randn(batch, S, C, generator=gen, device="cuda").to(dt)
        ones = torch.ones_like(x)
        z, u = (torch.zeros(batch, C, device="cuda"),
                torch.ones(batch, C, device="cuda"))
        dx = K.gn_bwd_apply(x, ones, z, u, u, z, z, z, None, DROPOUT_P, seed)
        keep = keep_mask_plain(seed, x.shape, DROPOUT_P, x.device)
        n_apply = int(((dx != 0) != keep).sum().item())
        del dx, keep, ones, x
        s12 = 12
        x = (2.0 ** torch.arange(s12, device="cuda", dtype=torch.float32))
        x = x[None, :, None].expand(batch, s12, C).contiguous().to(dt)
        sums = K.gn_bwd_sums(x, torch.ones_like(x), z, u, u, z, None,
                             DROPOUT_P, seed)
        keep = keep_mask_plain(seed, x.shape, DROPOUT_P, x.device)
        scale = torch.tensor(1.0 / (1.0 - DROPOUT_P), dtype=torch.float32)
        bits_k = torch.round(sums[:, 1].cpu() / scale).to(torch.int64)
        count_k = torch.round(sums[:, 0].cpu() / scale).to(torch.int64)
        pw = (2 ** torch.arange(s12, device="cuda"))[None, :, None]
        bits_p = (keep.to(torch.int64) * pw).sum(1).cpu()
        count_p = keep.to(torch.int64).sum(1).cpu()
        n_sums = int((bits_k != bits_p).sum().item()
                     + (count_k != count_p).sum().item())
    for name, shape, n_bad in (("gn_bwd_apply (dropout mask)",
                                [batch, S, C], n_apply),
                               ("gn_bwd_sums (dropout mask)",
                                [batch, s12, C], n_sums)):
        line = {"phase": "kernel", "kernel": name, "shape": shape,
                "dtype": "bfloat16", "p": DROPOUT_P,
                "per_element_mask": C % 4 != 0, "mask_mismatches": n_bad}
        fail_unless(n_bad == 0, f"{name} disagrees", line)
        emit(line)
        lines.append(line)
    return lines


def check_norm_bwd(torch, K, size, C, dtype_name, batch, act, p, timed,
                   S=None):
    """``S`` voxels (default size^3)."""
    import torch.nn.functional as F

    S, groups = S or size ** 3, 8
    x, ct, mean, inv, a, b = norm_inputs(torch, size, C, dtype_name, batch,
                                         S=S)
    count = float(S * (C // groups))
    seed = 0x0FEDCBA987654321 ^ (size * C)
    silu = act == "silu"

    def group_mean(v):
        g = v.reshape(batch, groups, C // groups).sum(-1) / count
        return g.repeat_interleave(C // groups, -1).contiguous()

    with torch.inference_mode():
        sums = K.gn_bwd_sums(x, ct, mean, inv, a, b, act, p, seed)
        sums_r = K.gn_bwd_sums_plain(x, ct, mean, inv, a, b, silu, p, seed)
        repeats = torch.equal(
            K.gn_bwd_sums(x, ct, mean, inv, a, b, act, p, seed), sums)
        m1, m2 = group_mean(a * sums_r[:, 0]), group_mean(a * sums_r[:, 1])
        dx = K.gn_bwd_apply(x, ct, mean, inv, a, b, m1, m2, act, p, seed)
        dx_r = K.gn_bwd_apply_plain(x, ct, mean, inv, a, b, m1, m2, silu, p,
                                    seed)
        torch.cuda.synchronize()
    elt = x.element_size()
    n = max(TIMED_MIN, min(100, int(4e8 // (batch * S * C))))
    lines = []
    lib_ms = None
    if timed:
        xg = x.permute(0, 2, 1).detach().requires_grad_(True)
        yg = F.silu(F.group_norm(xg, groups))
        ctg = ct.permute(0, 2, 1)
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            yg, xg, ctg, retain_graph=True), n)
        del yg, xg
    for name, got, ref, kind in (
            ("gn_bwd_sums", sums, sums_r, "sums"),
            ("gn_bwd_apply", dx, dx_r, "bwd_apply")):
        abs_err, err = rel_err(got, ref)
        if kind == "sums":
            err = abs_err / ref.abs().max().item()
        tol = TOL[(kind, dtype_name)]
        line = {"phase": "kernel", "kernel": name, "shape": [batch, S, C],
                "dtype": dtype_name, "act": act, "p": p,
                "max_abs_err": abs_err, "rel_err": err, "tol": tol}
        if kind == "sums":
            line.update(sums_plan_fields(
                torch, K, x, "bwd_dropout" if p > 0.0 else "bwd", repeats))
        fail_unless(err <= tol and line.get("repeats_bitwise", True),
                    f"{name} disagrees", line)
        if timed:
            if kind == "sums":
                nbytes = 2 * batch * S * C * elt + batch * 6 * C * 4
                flops = 16.0 * batch * S * C
                line.update(
                    ms=cuda_time_ms(lambda: K.gn_bwd_sums(
                        x, ct, mean, inv, a, b, act, p, seed), n),
                    plain_ms=cuda_time_ms(lambda: K.gn_bwd_sums_plain(
                        x, ct, mean, inv, a, b, silu, p, seed), 3, 1),
                    device_ms=graph_time_ms(lambda: K.gn_bwd_sums(
                        x, ct, mean, inv, a, b, act, p, seed)))
            else:
                nbytes = 3 * batch * S * C * elt + batch * 6 * C * 4
                flops = 18.0 * batch * S * C
                line.update(
                    ms=cuda_time_ms(lambda: K.gn_bwd_apply(
                        x, ct, mean, inv, a, b, m1, m2, act, p, seed), n),
                    plain_ms=cuda_time_ms(lambda: K.gn_bwd_apply_plain(
                        x, ct, mean, inv, a, b, m1, m2, silu, p, seed), 3, 1))
            line.update(
                library_ms=lib_ms,
                library_call="autograd of F.group_norm + F.silu, backward "
                             "only (both passes, no dropout)")
            line["bound_ms"], line["bound_by"] = bound_ms(flops, nbytes,
                                                          dtype_name)
        emit(line)
        lines.append(line)
    return lines


def check_pair_norm_bwd(torch, size, ca, cb, groups, dtype_name, nd=3):
    """The backward of a decoder skip join: the norm Function over a Pair
    of ``nd``-dimensional halves whose group straddles the boundary (joint
    group means in the finalize) against autograd through GroupNorm + SiLU
    over the materialized concat in plain f32 torch."""
    from vdm4cdm_torch.ops.norm import norm_affine_act
    from vdm4cdm_torch.ops.pair import Pair

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size + ca - cb)
    shape = (2,) + (size,) * nd
    xa = (1.3 * torch.randn(*shape, ca, generator=gen, device="cuda")
          + 0.2).to(dtype).requires_grad_(True)
    xb = (0.7 * torch.randn(*shape, cb, generator=gen, device="cuda")
          - 0.4).to(dtype).requires_grad_(True)
    C = ca + cb
    a = (1.0 + 0.3 * torch.randn(2, C, generator=gen, device="cuda"))
    b = 0.2 * torch.randn(2, C, generator=gen, device="cuda")
    a.requires_grad_(True)
    b.requires_grad_(True)
    ct = torch.randn(*shape, C, generator=gen, device="cuda").to(dtype)
    y = norm_affine_act(Pair(xa, xb), a, b, groups, act="silu")
    got = torch.autograd.grad(
        (y.a, y.b), (xa, xb, a, b),
        (ct[..., :ca].contiguous(), ct[..., ca:].contiguous()))
    xr = torch.cat([xa, xb], -1).detach().float().requires_grad_(True)
    ar, br = (t.detach().clone().requires_grad_(True) for t in (a, b))
    xg = xr.reshape(2, -1, groups, C // groups)
    mean = xg.mean((1, 3), keepdim=True)
    var = xg.var((1, 3), keepdim=True, unbiased=False)
    ref = ((xg - mean) * torch.rsqrt(var + 1e-6)).reshape(2, -1, C)
    ref = torch.nn.functional.silu(ref * ar[:, None] + br[:, None])
    dxr, dar, dbr = torch.autograd.grad(ref, (xr, ar, br),
                                        ct.float().reshape(2, -1, C))
    torch.cuda.synchronize()
    dx = torch.cat([got[0], got[1]], -1)
    abs_err, err = rel_err(dx, dxr)
    tol = TOL[("bwd_apply", dtype_name)]
    s_tol = TOL[("sums", dtype_name)]
    da_err = ((got[2] - dar).abs().max() / dar.abs().max()).item()
    db_err = ((got[3] - dbr).abs().max() / dbr.abs().max()).item()
    group = C // groups
    line = {"phase": "kernel", "kernel": "gn_bwd_sums+gn_bwd_apply (pair)",
            "shape": [2, size ** nd, ca, cb], "groups": groups,
            "straddling_group": [(ca // group) * group,
                                 (ca // group + 1) * group - 1],
            "dtype": dtype_name, "max_abs_err": abs_err, "rel_err": err,
            "tol": tol, "da_rel_err": da_err, "db_rel_err": db_err,
            "sums_tol": s_tol}
    fail_unless(ca % group != 0 and err <= tol and da_err <= s_tol
                and db_err <= s_tol, "pair GroupNorm backward failed", line)
    emit(line)


def mm1x1_cases():
    """(size, cin, cout) of every ``skip_proj`` site of the flagship (the
    decoder's per half of its Pair), and one shape with channel tails."""
    return [
        (128, 64, 32), (128, 32, 32),              # up_0_*
        (64, 32, 64),                              # down_1_0, up_1_2 (skip)
        (64, 128, 64), (64, 64, 64),               # up_1_*
        (32, 64, 128),                             # down_2_0, up_2_2 (skip)
        (32, 256, 128), (32, 128, 128),            # up_2_*
        (16, 128, 256),                            # down_3_0, up_3_2 (skip)
        (16, 256, 256),                            # up_3_*
        (16, 48, 96),                              # channel tails
        (16, 384, 384),  # past 256 channels (train3D_c_c's level 3)
    ]


def twod_mm1x1_cases():
    """(H W at 256^2, K, N) of every ``skip_proj`` site of ``train_uc_c``
    and ``trainSFM_c_uc`` (the decoder's per half of its Pair); the ``twod``
    phase holds it equal to the sites a forward records."""
    return [
        (65536, 48, 48), (65536, 96, 48),                    # level 0
        (16384, 48, 96), (16384, 96, 96), (16384, 192, 96),  # level 1
        (4096, 96, 192), (4096, 192, 192), (4096, 384, 192),  # level 2
        (1024, 192, 384), (1024, 384, 384),                  # level 3
    ]


def blessed_mm1x1_cases():
    """(size, K, N) of every ``skip_proj`` site of the trained model
    (``VDM_GRF_c_c_32``, chs 16-64, 32^3)."""
    return [
        (32, 16, 16), (32, 32, 16),
        (16, 16, 32), (16, 32, 32), (16, 48, 32),
        (8, 32, 48), (8, 48, 48), (8, 64, 48),
        (4, 48, 64), (4, 64, 64),
    ]


def mm1x1_f32_sites(torch, K, which=("twod", "blessed")):
    """Every f32 ``skip_proj`` site, checked and timed: the 2D models' at
    batch 12 (256^2) and the trained model's at its train step's batch 8
    (32^3), the forward with bias and residual, without the residual, the dx
    pass and dw, each with its kernel ``ms``, device time alone
    (``device_ms``), library and bound times (3xTF32 and FFMA). One ``site``
    line each; returns the lines of the largest site of each kernel."""
    heads, keys = {}, ("ms", "device_ms", "library_ms", "bound_ms",
                       "bound_by", "bound_3xtf32_ms", "bound_ffma_ms")
    cases = []
    if "twod" in which:
        cases += [(TWOD_VDM, int(round(math.sqrt(S))), cin, cout, 2,
                   TWOD_BATCH) for S, cin, cout in twod_mm1x1_cases()]
    if "blessed" in which:
        cases += [(BLESSED, size, cin, cout, 3, BLESSED_TRAIN_BATCH)
                  for size, cin, cout in blessed_mm1x1_cases()]
    for model, size, cin, cout, nd, batch in cases:
        fwd, dxl, dwl = check_mm1x1(torch, K, size, cin, cout, "float32",
                                    batch, True, nd=nd)
        emit({"phase": "site", "model": model, "kernel": "mm1x1",
              "shape": [batch * size ** nd, cin, cout], "dtype": "float32",
              "fwd": {k: fwd[k] for k in keys},
              "no_residual": {"ms": fwd["ms_no_residual"],
                              "library_ms": fwd["library_no_residual_ms"],
                              "bound_ms": fwd["bound_no_residual_ms"]},
              **{part: {k: ln[k] for k in keys}
                 for part, ln in (("dx", dxl), ("dw", dwl))}})
        for name, ln in (("mm1x1_fwd", fwd), ("mm1x1_dw", dwl)):
            if name not in heads or ln["bound_ms"] > heads[name]["bound_ms"]:
                heads[name] = ln
    return heads


def check_mm1x1(torch, K, size, cin, cout, dtype_name, batch, timed, nd=3):
    """``mm1x1_fwd`` with and without bias and residual, its use as the dx
    pass and ``mm1x1_dw`` against their plain versions, on ``nd``
    spatial dims of ``size``; returns the forward (bias and residual), dx
    and dw lines."""
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 999 + cin + cout)
    shape = (batch,) + (size,) * nd
    x = torch.randn(*shape, cin, generator=gen, device="cuda").to(dtype)
    w = torch.randn(cin, cout, generator=gen, device="cuda") / math.sqrt(cin)
    bias = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    res = torch.randn(*shape, cout, generator=gen, device="cuda").to(dtype)
    ct = torch.randn(*shape, cout, generator=gen, device="cuda").to(dtype)
    tol, tol_dw = TOL[("conv", dtype_name)], TOL[("dw", dtype_name)]
    dims = [batch * size ** nd, cin, cout]
    with torch.inference_mode():
        errs = {}
        for name, args in (("bias_residual", (x, w, bias, res)),
                           ("bias", (x, w, bias)), ("bare", (x, w)),
                           ("weight_in_x_dtype", (x, w.to(dtype), bias))):
            errs[name] = rel_err(K.mm1x1_fwd(*args), K.mm1x1_plain(*args))
        dx_abs, dx_err = rel_err(K.mm1x1_dx(ct, w),
                                 K.mm1x1_plain(ct, w.t()))
        dw, db = K.mm1x1_dw(x, ct)
        dw_p, db_p = K.mm1x1_dw_plain(x, ct)
        torch.cuda.synchronize()
        fwd = {"phase": "kernel", "kernel": "mm1x1_fwd", "shape": dims,
               "dtype": dtype_name, "max_abs_err": errs["bias_residual"][0],
               "rel_err": max(e[1] for e in errs.values()), "tol": tol}
        fail_unless(fwd["rel_err"] <= tol, "mm1x1_fwd disagrees", fwd)
        dxl = {"phase": "kernel", "kernel": "mm1x1_fwd (dx pass)",
               "shape": [dims[0], cout, cin], "dtype": dtype_name,
               "max_abs_err": dx_abs, "rel_err": dx_err, "tol": tol}
        fail_unless(dx_err <= tol, "mm1x1 dx pass disagrees", dxl)
        dwl = {"phase": "kernel", "kernel": "mm1x1_dw", "shape": dims,
               "dtype": dtype_name,
               "max_abs_err": (dw - dw_p).abs().max().item(),
               "rel_err": ((dw - dw_p).abs().max()
                           / dw_p.abs().max()).item(),
               "db_rel_err": ((db - db_p).abs().max()
                              / db_p.abs().max()).item(), "tol": tol_dw}
        fail_unless(max(dwl["rel_err"], dwl["db_rel_err"]) <= tol_dw,
                    "mm1x1_dw disagrees", dwl)
        if timed:
            rows, elt = dims[0], x.element_size()
            n = max(TIMED_MIN, min(100, int(4e8 // (rows * (cin + cout)))))
            flops = 2.0 * rows * cin * cout
            x2, r2, c2 = (t.reshape(rows, -1) for t in (x, res, ct))
            wd, bd = w.to(dtype), bias.to(dtype)
            wbytes = (cin + 1) * cout * 4  # the f32 weight and bias
            f32 = dtype_name == "float32"

            def bounds(nbytes):
                """The bound of the kernel's own path (in f32 3xTF32:
                three TF32 products a multiply-add) and what sets it; in
                f32 also the 3xTF32 and FFMA bounds apart."""
                if not f32:
                    return dict(zip(("bound_ms", "bound_by"),
                                    bound_ms(flops, nbytes, dtype_name)))
                b3 = bound_ms(3 * flops, nbytes, "tf32")
                return {"bound_ms": b3[0], "bound_by": b3[1],
                        "bound_3xtf32_ms": b3[0],
                        "bound_ffma_ms": bound_ms(flops, nbytes,
                                                  "float32")[0]}

            def device(fn):
                """f32 (the trained model's and the 2D sites, where the
                host's launch rate can set ``ms``): the device time alone."""
                return {"device_ms": graph_time_ms(fn)} if f32 else {}

            fwd.update(
                ms=cuda_time_ms(lambda: K.mm1x1_fwd(x, w, bias, res), n),
                plain_ms=cuda_time_ms(
                    lambda: K.mm1x1_plain(x, w, bias, res), max(2, n // 4)),
                library_ms=cuda_time_ms(
                    lambda: torch.addmm(r2, x2, wd).add_(bd), n),
                library_call="torch.addmm(residual, x, w) then add_(bias)",
                **bounds(rows * (cin + 2 * cout) * elt + wbytes),
                **device(lambda: K.mm1x1_fwd(x, w, bias, res)),
                ms_no_residual=cuda_time_ms(
                    lambda: K.mm1x1_fwd(x, w, bias), n),
                library_no_residual_ms=cuda_time_ms(
                    lambda: torch.addmm(bd, x2, wd), n),
                bound_no_residual_ms=bounds(
                    rows * (cin + cout) * elt + wbytes)["bound_ms"])
            # the wrapper on the host: wall time of a call in a long run of
            # unsynchronized calls (the larger of host and device time)
            fwd.update(
                wall_us_per_call=wall_us(
                    lambda: K.mm1x1_fwd(x, w, bias, res)))
            # dx: reads ct (rows, cout) and the f32 weight, writes (rows, cin)
            dxl.update(
                ms=cuda_time_ms(lambda: K.mm1x1_dx(ct, w), n),
                plain_ms=cuda_time_ms(lambda: K.mm1x1_plain(ct, w.t()),
                                      max(2, n // 4)),
                library_ms=cuda_time_ms(lambda: torch.mm(c2, wd.t()), n),
                library_call="torch.mm(ct, w.t()), w in ct's dtype",
                **bounds(rows * (cin + cout) * elt + cin * cout * 4),
                **device(lambda: K.mm1x1_dx(ct, w)))
            dwl.update(
                ms=cuda_time_ms(lambda: K.mm1x1_dw(x, ct), n),
                plain_ms=cuda_time_ms(lambda: K.mm1x1_dw_plain(x, ct),
                                      max(2, n // 4)),
                library_ms=cuda_time_ms(
                    lambda: (x2.t() @ c2, c2.sum(0)), n),
                library_call=("x.T @ ct and ct.sum(0) (two calls, out in x's "
                              "dtype)"),
                **bounds(rows * (cin + cout) * elt + (cin + 1) * cout * 4),
                **device(lambda: K.mm1x1_dw(x, ct)))
    for line in (fwd, dxl, dwl):
        emit(line)
    return fwd, dxl, dwl


def time_dropout_apply(torch, K, size, C, batch, dtype_name="bfloat16",
                       S=None):
    """``gn_apply`` with SiLU at p = 0.1 beside p = 0 on ``S`` voxels
    (default size^3), bf16 unless told otherwise (the check of its values
    is ``check_dropout_apply``)."""
    S = S or size ** 3
    x, _, mean, inv, a, b = norm_inputs(torch, size, C, dtype_name, batch,
                                        S=S)
    scale, shift = a * inv, b - mean * a * inv
    seed = 0x1234567890ABCDEF ^ (size * C)
    n = max(TIMED_MIN, min(100, int(4e8 // (batch * S * C))))
    with torch.inference_mode():
        line = {"phase": "kernel", "kernel": "gn_apply (dropout, timed)",
                "shape": [batch, S, C], "dtype": dtype_name, "p": DROPOUT_P,
                "ms": cuda_time_ms(lambda: K.gn_apply(
                    x, scale, shift, "silu", DROPOUT_P, seed), n),
                "ms_p0": cuda_time_ms(lambda: K.gn_apply(
                    x, scale, shift, "silu"), n),
                "plain_ms": cuda_time_ms(lambda: K.gn_apply_plain(
                    x, scale, shift, True, DROPOUT_P, seed), 3, 1)}
    line["bound_ms"], line["bound_by"] = bound_ms(
        6.0 * batch * S * C,
        2 * batch * S * C * x.element_size() + 2 * batch * C * 4, dtype_name)
    emit(line)
    return line


def phase_kernels(torch, K):
    check_plans(torch, K)
    check_fwd_repeats(torch, K)
    for size, cin, cout, combos in conv_cases():
        for mode, dtype_name in combos:
            check_conv(torch, K, size, cin, cout, mode, dtype_name, 2,
                       timed=(mode, dtype_name) == ("circular", "bfloat16"))
    for size, C in NORM_CASES:
        for dtype_name in ("bfloat16", "float32"):
            check_norm(torch, K, size, C, dtype_name, 2,
                       timed=dtype_name == "bfloat16")
    for dtype_name in ("bfloat16", "float32"):
        check_pair_norm(torch, *PAIR_CASE, dtype_name)
    # the sampler's headline shapes (batch 1, 128^3, bf16)
    check_conv(torch, K, MAIN_SIZE, 32, 32, "circular", "bfloat16", 1, True)
    check_norm(torch, K, MAIN_SIZE, 32, "bfloat16", 1, True)
    # the trained model's f32 path: forward, dx and dw at its every site
    blessed_sites(torch, K)

    # ---- the backward kernels, at the VDM train step's shapes (batch 2)
    for size, cin, cout, _ in conv_cases():
        for mode, dtype_name in [(m, d) for m in ("circular", "zeros")
                                 for d in ("bfloat16", "float32")]:
            check_conv_bwd(torch, K, size, cin, cout, mode, dtype_name,
                           TRAIN_BATCH,
                           (mode, dtype_name) == ("circular", "bfloat16"))
    for size, C in DROPOUT_CASES:
        for dtype_name in ("bfloat16", "float32"):
            check_dropout_apply(torch, K, size, C, dtype_name, TRAIN_BATCH)
    time_dropout_apply(torch, K, MAIN_SIZE, 32, TRAIN_BATCH)
    check_dropout_bwd(torch, K, TRAIN_BATCH, MAIN_SIZE ** 3, 32)
    check_dropout_bwd(torch, K, TRAIN_BATCH, 32 ** 3, 128)
    check_dropout_bwd(torch, K, TRAIN_BATCH, 16 ** 3, 30)
    # widths the reductions split into channel chunks (c0 > 0 in the
    # counters): 48 and 96 in chunks of 16 and 32, 384 in chunks of 128
    for C in (48, 96, 384):
        check_dropout_bwd(torch, K, TRAIN_BATCH, 16 ** 3, C)
    for size, C in NORM_CASES:
        for dtype_name in ("bfloat16", "float32"):
            for act, p in (("silu", DROPOUT_P), ("silu", 0.0), (None, 0.0),
                           (None, DROPOUT_P)):
                check_norm_bwd(torch, K, size, C, dtype_name, TRAIN_BATCH,
                               act, p,
                               dtype_name == "bfloat16" and act == "silu")
    for dtype_name in ("bfloat16", "float32"):
        check_pair_norm_bwd(torch, *PAIR_CASE, dtype_name)
    # the 1x1 projection at every skip_proj site, batch 2
    for size, cin, cout in mm1x1_cases():
        for dtype_name in ("bfloat16", "float32"):
            check_mm1x1(torch, K, size, cin, cout, dtype_name, TRAIN_BATCH,
                        timed=dtype_name == "bfloat16")
    return check_sfm_shapes(torch, K)


def blessed_sites(torch, K):
    """Every conv site of the trained model, f32, circular, checked and
    timed: the forward at the sampler's batch (``BLESSED_REPS``), the dx
    pass and dw at the train step's (``BLESSED_TRAIN_BATCH``). One ``site``
    line each: the kernel's ms beside cuDNN in f32 (TF32 off, the same
    function), cuDNN with TF32 on (one TF32 pass, another function), the
    3xTF32 and FFMA bounds, and the device time alone of the kernel and of
    cuDNN f32 (``device_ms``, ``library_device_ms``: at the small sites
    ``ms`` reads the host's launch rate)."""
    mode, dt = "circular", "float32"
    keys = ("ms", "device_ms", "library_ms", "library_device_ms",
            "library_tf32_ms", "bound_3xtf32_ms", "bound_ffma_ms", "rel_err",
            "tol")
    for size, cin, cout in blessed_conv_cases():
        fwd = check_conv(torch, K, size, cin, cout, mode, dt, BLESSED_REPS,
                         True, tf32=True)
        dx, dw = check_conv_bwd(torch, K, size, cin, cout, mode, dt,
                                BLESSED_TRAIN_BATCH, True, tf32=True)
        emit({"phase": "site", "model": BLESSED, "size": size, "cin": cin,
              "cout": cout, "mode": mode, "dtype": dt,
              "batch_fwd": BLESSED_REPS, "batch_bwd": BLESSED_TRAIN_BATCH,
              **{part: {k: ln[k] for k in keys}
                 for part, ln in (("fwd", fwd), ("dx", dx), ("dw", dw))}})


def conv_sites(torch, K):
    """Every conv site of ``conv_cases`` at the ``sfm`` phase's train-step
    shapes (batch 4, bf16, zeros padding), checked and timed: the forward,
    the dx pass and dw, each with its kernel, library and bound times. One
    ``site`` line each; returns the 128^3 32 -> 32 site's forward and dw
    lines (the ``kernels`` line's rows)."""
    mode, dt = "zeros", "bfloat16"
    heads = {}
    keys = ("ms", "library_ms", "bound_ms", "bound_by")
    for size, cin, cout, _ in conv_cases():
        fwd = check_conv(torch, K, size, cin, cout, mode, dt, SFM_BATCH,
                         True)
        dx, dw = check_conv_bwd(torch, K, size, cin, cout, mode, dt,
                                SFM_BATCH, True)
        emit({"phase": "site", "shape": [SFM_BATCH, size, size, size, cin,
                                         cout], "mode": mode, "dtype": dt,
              **{part: {k: ln[k] for k in keys}
                 for part, ln in (("fwd", fwd), ("dx", dx), ("dw", dw))}})
        if (size, cin, cout) == (MAIN_SIZE, 32, 32):
            heads["conv3d_k3s1_fwd"], heads["conv3d_k3s1_dw"] = fwd, dw
    return heads


def check_plans(torch, K):
    """The launch plans the compiled conv sources report against
    ``ops/kernels/conv3d.py``'s (``fwd_plan`` / ``dw_plan`` / ``sums_plan``,
    which the CPU tests hold) at every conv and z-halo site, both
    dtypes."""
    from vdm4cdm_torch.ops.kernels import conv3d as C

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sites = [(b, size, size, cin, cout) for b in (1, TRAIN_BATCH, SFM_BATCH)
             for size, cin, cout, _ in conv_cases()]
    sites += [(TRAIN_BATCH, local + dz, size, cin, cout)
              for local, size, cin, cout, _ in zhalo_cases()
              for dz in (0, 2)]
    sites += [(b, size, size, cin, cout)
              for b in (1, BLESSED_TRAIN_BATCH, BLESSED_REPS)
              for size, cin, cout in blessed_conv_cases()]
    bad = []
    for b, d, hw, cin, cout in sites:
        for dtype in (torch.bfloat16, torch.float32):
            for ci, co in ((cin, cout), (cout, cin)):
                want = (C.fwd_plan(dtype, b, d, hw, hw, ci, co, sms=sms),
                        C.dw_plan(dtype, b, d, hw, hw, ci, co, sms=sms),
                        C.sums_plan(dtype, b, d, hw, hw, ci, co, sms=sms))
                got = C.compiled_plans(dtype, b, d, hw, hw, ci, co)
                if got != want:
                    bad.append({"site": [b, d, hw, ci, co, str(dtype)],
                                "compiled": got, "python": want})
    # the 1x1 projection: forward and dx widths of every skip_proj site
    # (and the wide fallback), with and without a residual
    from vdm4cdm_torch.ops.kernels import lanemm as L

    mm_sites = [(b * size ** 3, k, n)
                for b in (1, TRAIN_BATCH, SFM_BATCH)
                for size, cin, cout in mm1x1_cases()
                for k, n in ((cin, cout), (cout, cin))]
    mm_sites += [(TWOD_BATCH * S, k, n)
                 for S, cin, cout in twod_mm1x1_cases()
                 for k, n in ((cin, cout), (cout, cin))]
    mm_sites += [(b * size ** 3, k, n)
                 for b in (BLESSED_TRAIN_BATCH, BLESSED_REPS)
                 for size, cin, cout in blessed_mm1x1_cases()
                 for k, n in ((cin, cout), (cout, cin))]
    for rows, k, n in mm_sites:
        for dtype in (torch.bfloat16, torch.float32):
            for has_res in (False, True):
                want = L.fwd_plan(dtype, rows, k, n, has_res, sms=sms)
                got = L.compiled_plan(dtype, rows, k, n, has_res)
                if got != want:
                    bad.append({"mm1x1": [rows, k, n, str(dtype), has_res],
                                "compiled": got, "python": want})
        want = L.dw_plan(rows, k, n, sms=sms)
        got = L.compiled_dw_plan(rows, k, n)
        if got != want:
            bad.append({"mm1x1_dw": [rows, k, n], "compiled": got,
                        "python": want})
    line = {"phase": "plans", "checked": 4 * len(sites),
            "mm1x1_checked": 4 * len(mm_sites),
            "mm1x1_dw_checked": len(mm_sites), "sms": sms,
            "mismatches": bad[:4]}
    fail_unless(not bad, "launch plans differ", line)
    emit(line)


def mm1x1_sites(torch, K):
    """Every ``skip_proj`` site of ``mm1x1_cases`` at the ``sfm`` phase's
    train-step shapes (batch 4, bf16), checked and timed: the forward with
    bias and residual, without the residual, the dx pass and dw, each with
    its kernel, library and bound times. One ``site`` line each; returns the
    (4, 128^3, 64 -> 32) site's forward and dw lines (the ``kernels`` line's
    rows)."""
    heads = {}
    for size, cin, cout in mm1x1_cases():
        fwd, dxl, dwl = check_mm1x1(torch, K, size, cin, cout, "bfloat16",
                                    SFM_BATCH, True)
        emit({"phase": "site", "kernel": "mm1x1",
              "shape": [SFM_BATCH * size ** 3, cin, cout], "dtype": "bfloat16",
              "fwd": {k: fwd[k] for k in ("ms", "library_ms", "bound_ms")},
              "no_residual": {"ms": fwd["ms_no_residual"],
                              "library_ms": fwd["library_no_residual_ms"],
                              "bound_ms": fwd["bound_no_residual_ms"]},
              **{part: {k: ln[k] for k in ("ms", "library_ms", "bound_ms")}
                 for part, ln in (("dx", dxl), ("dw", dwl))}})
        if (size, cin, cout) == (MAIN_SIZE, 64, 32):
            heads["mm1x1_fwd"], heads["mm1x1_dw"] = fwd, dwl
    return heads


def norm_site(torch, K, size, C, dtype_name, batch, S=None, model=None):
    """One GroupNorm site of ``S`` voxels (default size^3), checked and
    timed: ``gn_sums``, ``gn_apply`` at p = 0 and 0.1, and the backward
    pair (SiLU) at p = 0.1 and p = 0, so that the dropout mask's share of
    each is measured. One ``site`` line; returns the lines of ``gn_sums``,
    ``gn_apply`` and the backward pair at p = 0.1."""
    S = S or size ** 3
    keys = ("ms", "library_ms", "bound_ms")
    sums, apply = check_norm(torch, K, size, C, dtype_name, batch, True, S=S)
    drop = time_dropout_apply(torch, K, size, C, batch, dtype_name, S=S)
    bwd = check_norm_bwd(torch, K, size, C, dtype_name, batch, "silu",
                         DROPOUT_P, True, S=S)
    bwd0 = check_norm_bwd(torch, K, size, C, dtype_name, batch, "silu", 0.0,
                          True, S=S)
    emit({"phase": "site", **({"model": model} if model else {}),
          "kernel": "norm", "shape": [batch, S, C], "dtype": dtype_name,
          "p": DROPOUT_P,
          "gn_sums": {k: sums[k] for k in keys + (
              "device_ms", "library_device_ms")},
          "gn_apply": {"ms": drop["ms"], "ms_p0": drop["ms_p0"],
                       "library_ms": apply["library_ms"],
                       "bound_ms": drop["bound_ms"]},
          **{name: {"ms": ln["ms"], "ms_p0": ln0["ms"],
                    "library_ms": ln["library_ms"],
                    "bound_ms": ln["bound_ms"],
                    **({"device_ms": ln["device_ms"],
                        "device_ms_p0": ln0["device_ms"]}
                       if "device_ms" in ln else {})}
             for name, ln, ln0 in (("gn_bwd_sums", bwd[0], bwd0[0]),
                                   ("gn_bwd_apply", bwd[1], bwd0[1]))}})
    return sums, apply, bwd


def norm_sites(torch, K, batch=SFM_BATCH):
    """Every GroupNorm shape of ``NORM_CASES`` at ``batch``, bf16, checked
    and timed (``norm_site``); returns the 128^3, 32-channel lines (the
    ``kernels`` line's rows)."""
    heads = {}
    for size, C in NORM_CASES:
        sums, apply, bwd = norm_site(torch, K, size, C, "bfloat16", batch)
        if (size, C) == (MAIN_SIZE, 32):
            heads["gn_sums"], heads["gn_apply"] = sums, apply
            heads["gn_bwd_sums"], heads["gn_bwd_apply"] = bwd
    return heads


def cpu_norm_sites(torch, model, size, nd):
    """The (S, C) of every GroupNorm site (a Pair's halves each) of one
    forward of ``model``'s network on the CPU at crop ``size``."""
    net = getattr(model, "score_model", None) or model.unet
    gen = torch.Generator().manual_seed(0)
    spatial = (size,) * nd
    z = torch.randn(1, *spatial, net.shape[0], generator=gen)
    s = (torch.randn(1, *spatial, net.s_conditioning_channels, generator=gen)
         if net.s_conditioning_channels else None)
    vs = [torch.randn(1, d, generator=gen) for d in net.v_conditioning_dims]
    sites = set()
    with recorded_sites(sites), torch.no_grad():
        net(z, torch.tensor([0.5]), s_conditioning=s, v_conditionings=vs)
    return sorted(site[1:] for site in sites if site[0] == "norm")


def reduction_sites(torch, vt, K):
    """The GroupNorm sites the reductions' redesign is held at, beyond the
    3D ``NORM_CASES``: every norm site of ``train_uc_c`` (f32, b12, 256^2)
    and of the trained model (f32, b8, 32^3), read off a forward on the CPU
    at 32^2 and 8^3 and scaled, and a sharded rank's slab (bf16, b2, 64
    planes of 128^2, 32 channels: the CP rows), each through ``norm_site``.
    """
    model, _ = build_2d(vt, TWOD_VDM, 32, "cpu", 73)
    for S, C in cpu_norm_sites(torch, model, 32, 2):
        S *= (TWOD_SIZE // 32) ** 2
        norm_site(torch, K, int(round(math.sqrt(S))), C, "float32",
                  TWOD_BATCH, S=S, model=TWOD_VDM)
    model = vt.build_model(vt.preset(BLESSED, **{"data.cropsize": 8}),
                           device="cpu")
    for S, C in cpu_norm_sites(torch, model, 8, 3):
        S *= (32 // 8) ** 3
        norm_site(torch, K, int(round(S ** (1 / 3))), C, "float32",
                  BLESSED_TRAIN_BATCH, S=S, model=BLESSED)
    del model
    norm_site(torch, K, MAIN_SIZE, 32, "bfloat16", TRAIN_BATCH,
              S=MAIN_SIZE ** 3 // SHARDED_RANKS, model="sharded rank slab")


def check_sfm_shapes(torch, K):
    """Every kernel at the shapes the ``sfm`` phase gives it: bf16, zeros
    padding, batch 4 (the train steps; forward and backward at every conv,
    norm and ``skip_proj`` site, since the row splits of the dw kernels and
    the grids depend on the row count) and batch 1 (the Heun sampler; forward
    only). Returns the ``kernels`` line's rows: each kernel's times, bound
    and error at its 128^3 site at batch 4, the shapes whose launches that
    line counts."""
    size, dt = MAIN_SIZE, "bfloat16"
    heads = conv_sites(torch, K)
    for csize, cin, cout, _ in conv_cases():
        check_conv(torch, K, csize, cin, cout, "zeros", dt, 1, False)
    heads.update(norm_sites(torch, K))
    for nsize, C in NORM_CASES:
        check_norm_bwd(torch, K, nsize, C, dt, SFM_BATCH, None, 0.0, False)
        check_norm(torch, K, nsize, C, dt, 1, False)
    check_dropout_apply(torch, K, size, 32, dt, SFM_BATCH)
    heads.update(mm1x1_sites(torch, K))
    for msize, cin, cout in mm1x1_cases():
        check_mm1x1(torch, K, msize, cin, cout, dt, 1, False)
    return heads


# --------------------------------------------------------------- the model

def build(vt, name, size, dtype_name, device, seed, ctx=None, **overrides):
    """The preset's model at crop ``size``, every parameter randomized (from
    the seed alone: the ranks of the sharded phase get equal parameters);
    split over ``ctx``'s sp ranks when it is given."""
    if ctx is not None:
        overrides["parallel.n_sp"] = ctx.size
    cfg = vt.preset(name, **{"data.cropsize": size, "model.remat": False,
                             "model.compute_dtype": dtype_name, **overrides})
    if tuple(cfg.model.chs) != CHS:
        raise AssertionError(f"{name} is not at full width: {cfg.model.chs}")
    model = vt.build_model(cfg, device=device, ctx=ctx)
    randomize_(model, seed)
    return model.eval()


def build_vdm(vt, size, dtype_name, device, seed, ctx=None, **overrides):
    return build(vt, VDM_PRESET, size, dtype_name, device, seed, ctx,
                 **{"data.kind": "grf", **overrides})


def build_sfm(vt, size, dtype_name, device, seed, ctx=None, **overrides):
    return build(vt, SFM_PRESET, size, dtype_name, device, seed, ctx,
                 **overrides)


def sfm_batch(torch, size, batch, device, seed):
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, size, size, size, 1)
    x0 = torch.randn(shape, generator=gen)
    return {"x0": x0.to(device),
            "x1": (0.6 * x0 + 0.8 * torch.randn(shape, generator=gen)
                   ).to(device),
            "conditioning_values": [torch.randn(batch, 6, generator=gen)
                                    .to(device)]}


def conditioning(torch, size, batch, device, seed):
    gen = torch.Generator().manual_seed(seed)
    s = torch.randn(batch, size, size, size, 1, generator=gen)
    v = torch.randn(batch, 6, generator=gen)
    return s.to(device), v.to(device)


def phase_parity(torch, vt):
    t0 = time.perf_counter()
    size = PARITY_SIZE
    gpu = build_vdm(vt, size, "float32", "cuda", 1)
    cpu = build_vdm(vt, size, "float32", "cpu", 1)
    s, v = conditioning(torch, size, 2, "cpu", 2)
    z = torch.randn(2, size, size, size, 1,
                    generator=torch.Generator().manual_seed(3))
    t = torch.tensor([0.3, 0.8])
    with torch.inference_mode():
        ref = cpu.eps_hat(z, t, s, [v])
        got = gpu.eps_hat(z.cuda(), t.cuda(), s.cuda(), [v.cuda()]).cpu()
    abs_err, err = rel_err(got, ref)
    line = {"phase": "parity", "model": VDM_PRESET, "what": "eps_hat",
            "size": size, "chs": list(CHS),
            "dtype": "float32", "max_abs_ref": ref.abs().max().item(),
            "max_abs_err": abs_err, "rel_err": err, "tol": PARITY_TOL,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not (torch.isfinite(got).all() and err <= PARITY_TOL
            and ref.abs().max().item() > 0.1):
        raise AssertionError(f"eps_hat parity failed: {line}")

    t0 = time.perf_counter()
    gpu = build_sfm(vt, size, "float32", "cuda", 12)
    cpu = build_sfm(vt, size, "float32", "cpu", 12)
    with torch.inference_mode():
        ref = cpu.velocity(z, t, [v], s)
        got = gpu.velocity(z.cuda(), t.cuda(), [v.cuda()], s.cuda()).cpu()
    abs_err, err = rel_err(got, ref)
    line = {"phase": "parity", "model": SFM_PRESET, "what": "velocity",
            "size": size, "chs": list(CHS), "dtype": "float32",
            "padding": gpu.unet.conv_padding_mode,
            "max_abs_ref": ref.abs().max().item(), "max_abs_err": abs_err,
            "rel_err": err, "tol": PARITY_TOL,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not (torch.isfinite(got).all() and err <= PARITY_TOL
            and ref.abs().max().item() > 0.1):
        raise AssertionError(f"velocity parity failed: {line}")


def loss_batch(torch, size, batch, device, seed):
    s, v = conditioning(torch, size, batch, device, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(batch, size, size, size, 1, generator=gen)
    return {"x": x.to(device), "conditioning": s,
            "conditioning_values": [v]}


def loss_and_grads(model, batch, t, eps, seed):
    losses = model.loss(batch, train=True, t=t, eps=eps, dropout_seed=seed)
    losses.loss.backward()
    return losses, {k: p.grad.detach().cpu()
                    for k, p in model.named_parameters()}


def grad_errors(got_g, ref_g):
    """Each tensor's max error relative to max(max |ref|, 1e-3 of the largest
    gradient); returns (errors by name, the largest gradient)."""
    top = max(g.abs().max().item() for g in ref_g.values())
    return {k: (got_g[k] - g).abs().max().item()
            / max(g.abs().max().item(), 1e-3 * top)
            for k, g in ref_g.items()}, top


def sharded_grad_parity(torch, ref_m, sh_m, ref_l, sh_l, ctx):
    """After one backward of the unsharded model (loss terms ``ref_l``) and
    of the sharded one on this rank's slab (``sh_l``): the sharded
    gradients and loss terms averaged over the mesh against the unsharded
    ones. Returns (errors by parameter, the largest gradient, the worst
    parameter, the loss terms' largest error relative to max(1, |ref|))."""
    from vdm4cdm_torch.parallel import mean_over_mesh_

    flat = torch.cat([p.grad.reshape(-1) for _, p in sh_m.named_parameters()]
                     + [torch.stack([x.detach() for x in sh_l])])
    mean_over_mesh_(flat, ctx)
    got_g, i = {}, 0
    for k, p in sh_m.named_parameters():
        got_g[k] = flat[i:i + p.numel()].reshape(p.shape).cpu()
        i += p.numel()
    got_loss = flat[i:].cpu()
    ref_g = {k: p.grad.cpu() for k, p in ref_m.named_parameters()}
    errs, top = grad_errors(got_g, ref_g)
    loss_err = max(abs(got_loss[j].item() - x.item()) / max(1.0, abs(x.item()))
                   for j, x in enumerate(ref_l))
    return errs, top, max(errs, key=errs.get), loss_err


def synced_step(torch, step, state, batch, gen, ctx):
    """One more train step with the device synchronized around every
    collective, so that their wall time is their own and not the queued
    kernels': its seconds and the step's ``CommStats``."""
    ctx.stats.reset()
    ctx.stats.sync = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    synced = {"s_per_step": time.perf_counter() - t0, **ctx.stats.as_dict()}
    ctx.stats.sync = False
    return synced


def phase_grads(torch, vt, K):
    """Loss and every parameter's gradient of the full-width VDM and SFM at
    32^3, f32, batch 2, dropout 0.1: the card through the kernels against the
    CPU plain path, with the same injected t, eps and dropout seed. Then the
    SFM on the card with every ResBlock rematerialized against none."""
    size = PARITY_SIZE
    gen = torch.Generator().manual_seed(7)
    t = torch.tensor([0.35, 0.85])
    eps = torch.randn(2, size, size, size, 1, generator=gen)
    seed = 0x5EED5EED5EED
    makers = {
        VDM_PRESET: (lambda dev: build_vdm(vt, size, "float32", dev, 1),
                     lambda dev: loss_batch(torch, size, 2, dev, 8)),
        SFM_PRESET: (lambda dev: build_sfm(vt, size, "float32", dev, 12,
                                           **{"model.sfm_sigma": SFM_SIGMA}),
                     lambda dev: sfm_batch(torch, size, 2, dev, 13)),
    }
    for name, (make, make_batch) in makers.items():
        t0 = time.perf_counter()
        out = {}
        K.reset_launch_counts()
        for device in ("cuda", "cpu"):
            out[device] = loss_and_grads(make(device), make_batch(device), t,
                                         eps, seed)
        counts = K.launch_counts()
        check_grads(torch, name, out, counts, size, t0)

    # remat: the same loss and gradients with every ResBlock recomputed
    t0 = time.perf_counter()
    make, make_batch = makers[SFM_PRESET]
    out, fwd_counts = {}, {}
    for remat in (False, True):
        model = build_sfm(vt, size, "float32", "cuda", 12,
                          **{"model.sfm_sigma": SFM_SIGMA,
                             "model.remat": remat})
        K.reset_launch_counts()
        out[remat] = loss_and_grads(model, make_batch("cuda"), t, eps, seed)
        fwd_counts[remat] = K.launch_counts()
        n_remat = len(model.unet.remat_block_names())
    errs, top = grad_errors(out[True][1], out[False][1])
    worst = max(errs, key=errs.get)
    loss_err = abs(out[True][0].loss.item() - out[False][0].loss.item()) \
        / max(1.0, abs(out[False][0].loss.item()))
    forward = ("conv3d_k3s1_fwd", "gn_sums", "gn_apply", "mm1x1_fwd")
    line = {"phase": "grads", "model": SFM_PRESET, "what": "remat on vs off",
            "size": size, "batch": 2, "dtype": "float32",
            "dropout": DROPOUT_P, "remat_blocks": n_remat,
            "loss_rel_err": loss_err, "rel_err": errs[worst],
            "worst_param": worst, "tol": REMAT_TOL,
            "launches_remat": fwd_counts[True],
            "launches_no_remat": fwd_counts[False],
            "seconds": time.perf_counter() - t0}
    fail_unless(errs[worst] <= REMAT_TOL and loss_err <= REMAT_TOL
                and n_remat > 0 and all(
                    fwd_counts[True][k] > fwd_counts[False][k]
                    for k in forward), "remat check failed", line)
    emit(line)


def check_grads(torch, name, out, counts, size, t0,
                kernels=None):
    (got_l, got_g), (ref_l, ref_g) = out["cuda"], out["cpu"]
    loss_err = {k: abs(getattr(got_l, k).item() - getattr(ref_l, k).item())
                / max(1.0, abs(getattr(ref_l, k).item()))
                for k in ref_l._fields}
    errs, top = grad_errors(got_g, ref_g)
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got_g.values())
    line = {"phase": "grads", "model": name, "size": size, "batch": 2,
            "dtype": "float32",
            "dropout": DROPOUT_P, "loss": ref_l.loss.item(),
            "loss_rel_err": max(loss_err.values()),
            "n_params": len(errs), "rel_err": errs[worst],
            "worst_param": worst, "max_abs_grad": top, "tol": GRADS_TOL,
            "launches": counts, "seconds": time.perf_counter() - t0}
    fail_unless(finite and errs[worst] <= GRADS_TOL
                and line["loss_rel_err"] <= 1e-4 and top > 1e-3
                and min(counts[k] for k in kernels or UNSHARDED_KERNELS) > 0,
                "gradient parity failed", line)
    emit(line)


def resident_gib(torch) -> float:
    """Device memory held right now. Read where a phase starts, it is what
    the earlier phases' models and states still hold: the phase's peak
    memory includes it."""
    return torch.cuda.memory_allocated() / 2 ** 30


def timed_train_steps(torch, vt, K, model, batch, n_steps, gen_seed,
                      kernels=None, shard=None, lr=3e-4, moment="bfloat16",
                      ema_decay=EMA_DECAY):
    """One warm-up step, then ``n_steps`` timed steps of ``make_train_step``
    (Adam ``lr``, clip 0.5, first moment in ``moment`` (None: f32), EMA):
    checks that they gave finite, changed parameters through every kernel of
    ``kernels`` (default the unsharded path's), and returns the
    measurements and (state, step, batch, generator), with the U-Net's
    dtype, dropout and widths. With ``shard`` (a rank's ShardCtx) the
    measurements add its collectives' counters over the timed steps."""
    kernels = kernels or UNSHARDED_KERNELS
    net = model.score_model if hasattr(model, "score_model") else model.unet
    opt = vt.make_optimizer(learning_rate=lr, grad_clip=0.5,
                            moment_dtype=getattr(torch, moment)
                            if moment else None)
    state = vt.TrainState(0, model, opt.init(model), vt.init_ema(model))
    step = vt.make_train_step(model, opt, ema_decay=ema_decay)
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    # warm-up: Triton specializations and cuDNN plans for these shapes
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if shard is not None:
        shard.stats.reset()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(n_steps):
        state, metrics = step(state, batch, gen)
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    cuda_counts = K.cuda_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in model.named_parameters())
    ema_moved = max((state.ema_params[k] - before[k]).abs().max().item()
                    for k in before)
    finite = all(math.isfinite(v) for v in losses + norms) and all(
        bool(torch.isfinite(p).all()) for p in model.parameters())
    voxels = next(iter(batch.values())).numel()
    facts = {"dtype": str(net.compute_dtype).removeprefix("torch."),
             "dropout": net.dropout_prob,
             "moment_dtype": moment or "float32", "ema_decay": ema_decay,
             "chs": list(net.chs), "steps": n_steps, "seconds": dt,
             "s_per_step": dt / n_steps,
             "voxels_per_s": voxels * n_steps / dt,
             "peak_mem_gib": peak / 2 ** 30, "launches": counts,
             "launches_per_step": {k: c / n_steps for k, c in counts.items()},
             "cuda_launches_per_step": {k: c / n_steps
                                        for k, c in cuda_counts.items()},
             "loss": losses, "grad_norm": norms, "finite": finite,
             "max_param_change": moved, "max_ema_change": ema_moved,
             "state_step": state.step}
    if shard is not None:
        facts["comm"] = shard.stats.as_dict()
    fail_unless(finite and moved > 0.0 and ema_moved > 0.0
                and state.step == n_steps + 1
                and min(counts[k] for k in kernels) > 0,
                "the train steps did not give finite, changed parameters "
                "through every kernel", facts)
    return facts, (state, step, batch, gen)


def phase_train(torch, vt, K, kernels, bare):
    """The flagship train step at 128^3, batch 2, bf16, dropout 0.1, bf16
    first moment, EMA: one warm-up step, then timed steps. Its s/step and
    launches per step go to ``bare["vdm"]`` for the ``cli`` phase."""
    size = MAIN_SIZE
    held = resident_gib(torch)
    vdm = build_vdm(vt, size, "bfloat16", "cuda", 9)
    batch = loss_batch(torch, size, TRAIN_BATCH, "cuda", 10)
    facts, trainer = timed_train_steps(torch, vt, K, vdm, batch, TRAIN_STEPS,
                                       11)
    emit({"phase": "train", "preset": VDM_PRESET, "size": size,
          "batch": TRAIN_BATCH, "padding": vdm.score_model.conv_padding_mode,
          "held_by_earlier_phases_gib": held, **facts})
    for name in UNSHARDED_KERNELS:
        kernels[name]["launches_vdm_train"] = facts["launches"][name]
    bare["vdm"] = {k: facts[k] for k in ("s_per_step", "launches_per_step")}
    return trainer


def phase_main(torch, vt, K, kernels):
    size = MAIN_SIZE
    vdm = build_vdm(vt, size, "bfloat16", "cuda", 4)
    s, v = conditioning(torch, size, 1, "cuda", 5)
    gen = torch.Generator(device="cuda")
    kw = dict(batch_size=1, s_conditioning=s, v_conditionings=[v])
    # warm-up step: Triton specializations and cuDNN plans for these shapes
    vdm.draw_samples(gen.manual_seed(0), n_sampling_steps=1, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = vdm.draw_samples(gen.manual_seed(6), n_sampling_steps=MAIN_STEPS,
                           **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out).all())
    line = {"phase": "main", "size": size, "batch": 1, "dtype": "bfloat16",
            "chs": list(CHS), "steps": MAIN_STEPS,
            "seconds": dt, "s_per_step": dt / MAIN_STEPS,
            "s_per_field_250": dt / MAIN_STEPS * FIELD_STEPS,
            "peak_mem_gib": peak / 2 ** 30,
            "launches": counts,
            "launches_per_forward": {k: c / MAIN_STEPS
                                     for k, c in counts.items()},
            "out_shape": list(out.shape), "finite": finite,
            "out_std": out.float().std().item()}
    emit(line)
    if not finite or tuple(out.shape) != (1, size, size, size, 1):
        raise AssertionError("sampler output is not a finite field")
    if min(counts[k] for k in FORWARD_KERNELS) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    for name in FORWARD_KERNELS:
        kernels[name]["launches_sampler"] = counts[name]
    return vdm, s, v


def phase_sfm(torch, vt, K, kernels, bare):
    """Train steps of ``trainSFM3D128_c_c`` at 128^3, batch 4, bf16 without
    remat (their s/step and launches per step go to ``bare["sfm"]``), one
    step's peak memory with the preset's remat, then Heun sampler steps at
    batch 1."""
    size = MAIN_SIZE
    trainer = peak_no_remat = None
    for remat in (False, True):
        torch.cuda.empty_cache()
        held = resident_gib(torch)
        sfm = build_sfm(vt, size, "bfloat16", "cuda", 14,
                        **{"model.remat": remat})
        batch = sfm_batch(torch, size, SFM_BATCH, "cuda", 15)
        facts, run = timed_train_steps(torch, vt, K, sfm, batch,
                                       1 if remat else TRAIN_STEPS, 16)
        line = {"phase": "sfm", "what": "train", "preset": SFM_PRESET,
                "remat": remat,
                "remat_blocks": len(sfm.unet.remat_block_names()),
                "size": size, "batch": SFM_BATCH,
                "padding": sfm.unet.conv_padding_mode,
                "held_by_earlier_phases_gib": held, **facts}
        if remat:
            line["peak_mem_gib_no_remat"] = peak_no_remat
        else:
            peak_no_remat = facts["peak_mem_gib"]
            trainer = run
            for name in UNSHARDED_KERNELS:
                kernels[name]["launches_sfm_train"] = facts["launches"][name]
            bare["sfm"] = {k: facts[k]
                           for k in ("s_per_step", "launches_per_step")}
        emit(line)
        del sfm, batch, run

    state = trainer[0]
    sfm = state.model.eval()
    x0 = trainer[2]["x0"][:1]
    v = [trainer[2]["conditioning_values"][0][:1]]
    sfm.draw_samples(x0, 1, v, method="heun")
    torch.cuda.synchronize()
    held = resident_gib(torch)  # with this model and its training state
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = sfm.draw_samples(x0, MAIN_STEPS, v, method="heun")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    finite = bool(torch.isfinite(out).all())
    line = {"phase": "sfm", "what": "draw_samples", "preset": SFM_PRESET,
            "method": "heun", "size": size, "batch": 1, "dtype": "bfloat16",
            "steps": MAIN_STEPS, "forwards_per_step": 2, "seconds": dt,
            "s_per_step": dt / MAIN_STEPS,
            "s_per_field_250": dt / MAIN_STEPS * FIELD_STEPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "held_before_sampling_gib": held, "launches": counts,
            "launches_per_forward": {k: c / (2 * MAIN_STEPS)
                                     for k, c in counts.items()},
            "out_shape": list(out.shape), "finite": finite,
            "out_std": out.float().std().item()}
    emit(line)
    if not finite or tuple(out.shape) != (1, size, size, size, 1):
        raise AssertionError("SFM sampler output is not a finite field")
    if min(counts[k] for k in FORWARD_KERNELS) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    for name in FORWARD_KERNELS:
        kernels[name]["launches_sfm_sampler"] = counts[name]
    return trainer


def phase_ddnm(torch, vt, K):
    """``ddnm_sample`` on the full-width VDM at 32^3, f32: inpainting the
    half of the box that a mask hides. The projection makes the result agree
    with the measurement whatever the weights."""
    t0 = time.perf_counter()
    size = PARITY_SIZE
    vdm = build_vdm(vt, size, "float32", "cuda", 17)
    s, v = conditioning(torch, size, 1, "cuda", 18)
    x = torch.randn(1, size, size, size, 1, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(19))
    mask = torch.zeros_like(x)
    mask[:, : size // 2] = 1.0
    A = AT = lambda z: z * mask  # noqa: E731
    y = A(x)
    K.reset_launch_counts()
    x_hat = vt.ddnm_sample(
        vdm, y, A, AT, n_sampling_steps=DDNM_STEPS, l=DDNM_L,
        s_conditioning=s, v_conditionings=[v],
        generator=torch.Generator(device="cuda").manual_seed(20))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    consistency = (A(x_hat) - y).abs().max().item()
    forwards = sum(min(DDNM_L, i) + 1 for i in range(DDNM_STEPS))
    line = {"phase": "ddnm", "size": size, "dtype": "float32",
            "steps": DDNM_STEPS, "l": DDNM_L, "unet_forwards": forwards,
            "consistency": consistency, "tol": 1e-4,
            "finite": bool(torch.isfinite(x_hat).all()),
            "out_shape": list(x_hat.shape),
            "hole_std": x_hat[:, size // 2:].std().item(),
            "launches": counts, "seconds": time.perf_counter() - t0}
    fail_unless(line["finite"] and consistency < 1e-4
                and tuple(x_hat.shape) == tuple(x.shape)
                and counts["conv3d_k3s1_fwd"] == 59 * forwards,
                "ddnm check failed", line)
    emit(line)


# --------------------------------------------------------------- cli phase

# the entry points as a user runs them: (family, preset, steps of the first
# run, of the resumed run, checkpoint and validation interval, generation
# arguments). The first run validates and saves every third step; the
# resumed run's steps (7 and 8, or 4) validate nowhere, so its launches
# are the train steps' alone. remat is off, as in the bare steps of the
# ``train`` and ``sfm`` phases, whose launches per step the CLI's must equal.
CLI_RUNS = (
    ("vdm", VDM_PRESET, 6, 8, 3, ["--reps-per-batch", "4"]),
    ("sfm", SFM_PRESET, 3, 4, 3, ["--sfm-method", "heun"]),
)
CLI_CAMPAIGN, CLI_SAMPLING_STEPS, CLI_FILES = "CV_12_12", 2, 12


def run_cli(main, argv, log):
    """``main(argv)`` in this process, its printed lines appended to the
    file ``log``; returns (exit code, those lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    with open(log, "a") as fh:
        fh.write(f"$ {' '.join(map(str, argv))}\n{buf.getvalue()}")
    return rc, buf.getvalue().splitlines()


def read_metrics(path):
    import csv

    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


FIGURE_STEPS = 2  # the validation figure's sampler steps in the cli phase
STATS_TOL = 1e-4  # get_stats on the card against the CPU, each key
# relative to its own max |CPU value|


def figure_panel(torch, vt, K, cfg, dm, ckpt_dir):
    """``panel_data`` of the CLI's validation-figure hook on the card (the
    card's host has no matplotlib, so the CLI trainer runs without it):
    the checkpoint's weights, the first validation batch, FIGURE_STEPS
    sampler steps. Fails unless the panel is whole and finite."""
    from vdm4cdm_torch.cli._common import make_validation_figure_fn
    from vdm4cdm_torch.train.checkpoint import load_params

    cfg.model.remat = False
    cfg.run.n_figure_sampling_steps = FIGURE_STEPS
    model = vt.build_model(cfg, device="cuda").eval()
    load_params(str(ckpt_dir), model)
    draw = make_validation_figure_fn(cfg, model, dm)
    batch = {k: (None if v is None else
                 [torch.from_numpy(a).cuda() for a in v]
                 if isinstance(v, list) else torch.from_numpy(v).cuda())
             for k, v in next(iter(dm.val_dataloader())).items()}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    panel = draw.panel_data(dict(model.named_parameters()), batch,
                            torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0,
           "sampling_steps": FIGURE_STEPS,
           "images": {k: list(v.shape) for k, v in panel["images"].items()},
           "curves": {k: len(panel[k]) for k in ("hist", "pk", "cc")},
           "finite": all(np.isfinite(np.asarray(a, np.float64)).all()
                         for k in ("pk", "cc") for c in panel[k]
                         for a in c[1:]),
           "launches": K.launch_counts()}
    fail_unless(out["finite"] and len(out["images"]) == 3
                and out["curves"] == {"hist": 3, "pk": 3, "cc": 1}
                and min(out["launches"][k] for k in FORWARD_KERNELS) > 0,
                "the validation-figure panel is not whole", out)
    return out


def cli_calc_ss(torch, K, data_dir):
    """``cli.calc_ss`` of the VDM's 128^3 CV_12_12 campaign on the card
    (the scattering-transform branch), timed per sample; then one sample's
    ``get_stats`` on the card against the CPU. The GRF preset's fields are
    unnormalized by the identity: zero-mean, below the log-PDF bins, and
    their P(k) over their sum is a ratio to round-off; the card-CPU check
    standardizes the sample and takes it through 10^(0.3 y + 11) on the
    host first, a positive field whose every statistic is well
    conditioned."""
    import pickle

    from vdm4cdm_torch.cli import calc_ss

    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _ = run_cli(calc_ss.main, [
        VDM_PRESET, "--data-dir", str(data_dir), "--set", "data.kind=grf",
        "model.remat=False"], data_dir.parent / "calc_ss.log")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    with open(data_dir / "summary.pkl", "rb") as fh:
        stats = pickle.load(fh)[CLI_CAMPAIGN]["stats"]
    samples = {k: v for k, v in stats.items() if "_GT_" not in k}
    one = np.load(data_dir / CLI_CAMPAIGN / "gen_0.npy")[:1]
    one = (one - one.mean()) / one.std()  # a few steps' samples run large
    field = (10.0 ** (one * 0.3 + 11.0)).astype(np.float32)
    got, ms, rwst_ms = time_stats(torch, calc_ss,
                                  torch.from_numpy(field).cuda())
    got, ms, rwst_ms = time_stats(torch, calc_ss,  # warm: the second call
                                  torch.from_numpy(field).cuda())
    ref = calc_ss.get_stats(torch.from_numpy(field))
    errs, counts_equal = {}, True
    for k, want in ref.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(want, np.float64)
        if k.endswith("logpdf"):
            counts_equal = counts_equal and bool(np.array_equal(g, w))
        else:  # a CPU value of all zeros makes the error inf: a failure
            errs[k] = float(np.abs(g - w).max() / np.abs(w).max())
    out = {"seconds": seconds, "samples": len(stats),
           "ms_per_sample": seconds * 1e3 / len(stats),
           "get_stats_ms_128": ms, "rwst_ms_128": rwst_ms,
           "get_stats_ms_128_without_rwst": ms - rwst_ms,
           "rwst": sorted(k for k in samples["Mcdm_0_0"] if "rwst" in k),
           "finite": all(np.isfinite(np.asarray(v, np.float64)).all()
                         for st in samples.values() for v in st.values()),
           "card_vs_cpu_rel_err": errs, "tol": STATS_TOL,
           "logpdf_counts_equal": counts_equal,
           "logpdf_counted": float(np.asarray(ref["3d_logpdf"]).sum()),
           "launches": launches}
    fail_unless(rc == 0 and len(stats) == 12 + 144 and out["finite"]
                and out["rwst"] == ["2d_half_rwst", "2d_quarter_rwst"]
                and max(errs.values()) <= STATS_TOL and counts_equal
                and out["logpdf_counted"] > 0,
                "calc_ss of the 128^3 campaign failed", out)
    return out


def phase_cli(torch, vt, K, kernels, bare):
    """Train, resume and generate through ``vdm4cdm_torch.cli.train`` and
    ``.generate`` in this process, at full width on GRF data, for the VDM
    (128^3, batch 2) and the SFM (batch 4). The checkpoints and samples are
    deleted after their checks (they take gigabytes); ``metrics.csv`` and
    the CLI's printed lines stay under ``chiprun_out/cli_runs/``."""
    import shutil

    from vdm4cdm_torch.cli import generate, train

    root = OUT_DIR / "cli_runs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    total = {name: 0 for name in UNSHARDED_KERNELS}
    for family, preset, first, last, every, gen_args in CLI_RUNS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        held = resident_gib(torch)
        cfg = vt.preset(preset, **{"data.kind": "grf"})
        dm = vt.build_datamodule(cfg)
        t_batch = time.perf_counter()
        next(dm.train_batches(1))
        host_batch_ms = (time.perf_counter() - t_batch) * 1e3
        log = root / f"{family}.log"
        sets = ["data.kind=grf", "model.remat=False", f"run.out_dir={root}",
                f"run.ckpt_every_steps={every}",
                f"run.val_check_interval={every}", "run.n_val_batches=1",
                "run.log_every_steps=1",
                f"run.n_figure_sampling_steps={FIGURE_STEPS}"]
        counts = {}
        for what, steps in (("train", first), ("resume", last)):
            K.reset_launch_counts()
            rc, out = run_cli(train.main, ["--preset", preset, "--set", *sets,
                                           f"run.max_steps={steps}"], log)
            torch.cuda.synchronize()
            counts[what] = K.launch_counts()
            if rc != 0:
                raise AssertionError(f"cli.train {what} of {preset}: rc {rc}")
        resumed = [int(ln.rsplit(" ", 1)[1]) for ln in out
                   if ln.startswith("[trainer] resumed from step")]
        run_dir = root / preset
        ckpt_dir = run_dir / "checkpoints"
        steps_saved = sorted(int(p.name) for p in ckpt_dir.iterdir())
        rows = read_metrics(run_dir / "metrics.csv")
        train_rows = [r for r in rows if r["loss"]]
        first_rows = [r for r in train_rows if int(r["step"]) <= first]
        later = [float(r["step_s"]) for r in first_rows[1:]]
        waits = [float(r["feed_wait_s"]) for r in first_rows[1:]]
        resume_rows = [r for r in train_rows if int(r["step"]) > first]
        saves = [{"step": int(r["step"]), "bytes": int(float(r["ckpt_bytes"])),
                  "ms": float(r["ckpt_save_s"]) * 1e3}
                 for r in rows if r["ckpt_bytes"]]

        figure = figure_panel(torch, vt, K, cfg, dm, ckpt_dir)
        counts["figure"] = figure.pop("launches")

        gen_dir = root / f"{family}_samples" / CLI_CAMPAIGN
        K.reset_launch_counts()
        t_gen = time.perf_counter()
        rc, _ = run_cli(generate.main, [
            preset, str(gen_dir), CLI_CAMPAIGN, "--ckpt-dir", str(ckpt_dir),
            "--n-sampling-steps", str(CLI_SAMPLING_STEPS), *gen_args,
            "--set", "data.kind=grf", "model.remat=False"], log)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t_gen
        counts["generate"] = K.launch_counts()
        files, finite, max_abs = {}, True, 0.0
        for path in sorted(gen_dir.iterdir()):
            a = np.load(path)
            files[path.name] = [list(a.shape), str(a.dtype)]
            finite = finite and bool(np.isfinite(a).all())
            max_abs = max(max_abs, float(np.abs(a).max()))
        summary = None
        if family == "vdm":  # calc_ss reads VDM batches (x, conditioning)
            summary = cli_calc_ss(torch, K, gen_dir.parent)
            counts["calc_ss"] = summary.pop("launches")
        for c in counts.values():
            for name in total:
                total[name] += c[name]
        shutil.rmtree(gen_dir.parent)
        shutil.rmtree(ckpt_dir)

        n_resumed = last - first
        per_step = {k: c / n_resumed for k, c in counts["resume"].items()}
        want = bare.get(family, {}).get("launches_per_step")
        size = MAIN_SIZE
        line = {"phase": "cli", "model": family, "preset": preset,
                "size": size, "batch": cfg.data.batch_size,
                # the config's rule (models/cunet.py via build_model): GRF
                # data is periodic, so both models pad circularly here
                "padding": ("circular" if cfg.data.cropsize == 256
                            or cfg.data.kind == "grf" else "zeros"),
                "dtype": cfg.model.compute_dtype, "remat": False,
                "held_by_earlier_phases_gib": held,
                # the median of the steps after the first, and the mean:
                # validation and a checkpoint (about 2 s) let the feed
                # thread run up to three batches ahead, so the median of a
                # short run can be the bare step's while the feed sets the
                # pace
                "cli_s_per_step": statistics.median(later),
                "cli_s_per_step_mean": statistics.fmean(later),
                "cli_s_per_step_all": [float(r["step_s"]) for r in train_rows],
                "bare_s_per_step": bare.get(family, {}).get("s_per_step"),
                "host_batch_ms": host_batch_ms,
                "feed_wait_ms_per_step": 1e3 * statistics.median(waits),
                "feed_wait_ms_per_step_mean": 1e3 * statistics.fmean(waits),
                "feed_wait_ms_all": [1e3 * float(r["feed_wait_s"])
                                     for r in train_rows],
                "resume_first_step_s": float(resume_rows[0]["step_s"]),
                "launches_per_step": per_step,
                "bare_launches_per_step": want,
                "launches": counts,
                "resumed_from": resumed[0] if resumed else None,
                "checkpoint_steps": steps_saved, "checkpoints": saves,
                "campaign": CLI_CAMPAIGN,
                "sampling_steps": CLI_SAMPLING_STEPS,
                "generate_s": gen_s, "files": files,
                "max_abs": max_abs, "finite": finite,
                "figure_panel": figure, "calc_ss": summary,
                "seconds": time.perf_counter() - t0}
        emit(line)
        fail_unless(
            line["resumed_from"] == first
            and steps_saved == sorted({every, first, last})
            and [int(r["step"]) for r in train_rows]
            == list(range(1, last + 1)),
            "the CLI did not train, save and resume as asked", line)
        fail_unless(want is not None and all(
            per_step[k] == want[k] for k in UNSHARDED_KERNELS),
            "the CLI's launches per step differ from the bare step's", line)
        fail_unless(finite and len(files) == CLI_FILES and all(
            shape == [12, 1, size, size, size] and dtype == "float32"
            for shape, dtype in files.values())
            and min(counts["generate"][k] for k in FORWARD_KERNELS) > 0,
            "the campaign files are not 12 finite (12, 1, S, S, S) fields",
            line)
    for name in UNSHARDED_KERNELS:
        kernels[name]["launches_cli"] = total[name]
        kernels[name]["launches"] = total[name]


# ----------------------------------------------------------- blessed phase

# the repository's trained model, converted to the port's format and named
# in configs/models_torch.yaml; the acceptance gate's statistics and
# thresholds are vdm4cdm_torch/evals/acceptance.py's, and the JAX run's
# recorded values (tests/test_acceptance.py) stand beside them
BLESSED = "VDM_GRF_c_c_32"
BLESSED_CAMPAIGN, BLESSED_STEPS, BLESSED_REPS = "CV_12_12", 100, 12
BLESSED_TRAIN_BATCH = 8  # the preset's batch: the train step that made it


def time_stats(torch, calc_ss, field):
    """ms of ``get_stats`` on one field on the card, and of the scattering
    transforms inside it (0 where the projections are not 128 wide); the
    stats themselves."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = calc_ss.get_stats(field)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    rwst = 0.0
    if field.shape[-1] == calc_ss.RWST_SIZE:
        for depth in (field.shape[2] // 2, field.shape[2] // 4):
            f2d = field[:, :, :depth].sum(dim=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calc_ss._log_rwst(f2d)
            torch.cuda.synchronize()
            rwst += (time.perf_counter() - t0) * 1e3
    return stats, total, rwst


def phase_blessed(torch, vt, K, kernels):
    """The blessed chain on the card: eps_hat of the converted model
    against the CPU path, ``cli.generate VDM_GRF_c_c_32`` through the
    port's registry (CV_12_12, 100 steps, 12 reps a call), the acceptance
    gate's statistics and DDNM, then ``cli.calc_ss``. Fails on any
    threshold. Run from the repository root (the registry's paths are
    relative to it)."""
    import os
    import pickle
    import shutil

    from vdm4cdm_torch.cli import calc_ss, generate
    from vdm4cdm_torch.cli._common import read_registry
    from vdm4cdm_torch.evals import acceptance
    from vdm4cdm_torch.train.checkpoint import load_params

    t_phase = time.perf_counter()
    os.chdir(ROOT)
    entry = read_registry("configs/models_torch.yaml")[BLESSED]
    cfg = vt.preset(entry["preset"])
    counts = {}
    # the CUDA kernels those calls launched (an f32 forward call: the weight
    # split, the conv and, where K is split, the reduce)
    cuda_counts = {}

    # 1. eps_hat on the card against the CPU path, on one test batch
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = vt.build_model(cfg, device=dev).eval()
        load_params(entry["ckpt_dir"], models[dev], step=entry["ckpt_step"])
    batch = next(iter(vt.build_datamodule(cfg, stage="test")
                      .test_dataloader()))
    s = torch.from_numpy(batch["conditioning"])
    v = torch.from_numpy(batch["conditioning_values"][0])
    gen = torch.Generator().manual_seed(61)
    z = torch.randn(s.shape, generator=gen)
    t = torch.linspace(0.05, 0.95, s.shape[0])
    K.reset_launch_counts()
    with torch.inference_mode():
        got = models["cuda"].eps_hat(z.cuda(), t.cuda(), s.cuda(),
                                     [v.cuda()]).cpu()
    torch.cuda.synchronize()
    counts["eps_hat"] = K.launch_counts()
    cuda_counts["eps_hat"] = K.cuda_launch_counts()
    with torch.inference_mode():
        ref = models["cpu"].eps_hat(z, t, s, [v])
    abs_err, err = rel_err(got, ref)
    line = {"phase": "blessed", "what": "eps_hat", "model": BLESSED,
            "step": entry["ckpt_step"], "batch": list(z.shape),
            "chs": list(cfg.model.chs), "dtype": cfg.model.compute_dtype,
            "max_abs_ref": ref.abs().max().item(), "max_abs_err": abs_err,
            "rel_err": err, "tol": PARITY_TOL,
            "launches": counts["eps_hat"]}
    emit(line)
    fail_unless(bool(torch.isfinite(got).all()) and err <= PARITY_TOL,
                "blessed eps_hat parity failed", line)
    vdm = models["cuda"]
    del models

    # 2. the campaign through the entry point, from the registry
    root = OUT_DIR / "blessed_run"
    shutil.rmtree(root, ignore_errors=True)
    camp = root / BLESSED_CAMPAIGN
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _ = run_cli(generate.main, [
        BLESSED, str(camp), BLESSED_CAMPAIGN, "--n-sampling-steps",
        str(BLESSED_STEPS), "--reps-per-batch", str(BLESSED_REPS)],
        OUT_DIR / "blessed_generate.log")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts["generate"] = K.launch_counts()
    cuda_counts["generate"] = K.cuda_launch_counts()
    files = sorted(camp.iterdir())
    fields = [np.load(p) for p in files]
    n_fields = sum(len(a) for a in fields)
    line = {"phase": "blessed", "what": "generate", "campaign":
            BLESSED_CAMPAIGN, "sampling_steps": BLESSED_STEPS,
            "reps_per_batch": BLESSED_REPS, "files": len(files),
            "fields": n_fields, "seconds": gen_s,
            "s_per_field": gen_s / n_fields,
            "s_per_100_step_field": gen_s / n_fields * 100 / BLESSED_STEPS,
            "unet_forwards": n_fields // BLESSED_REPS * BLESSED_STEPS,
            "finite": all(bool(np.isfinite(a).all()) for a in fields),
            "launches": counts["generate"],
            "launches_per_forward": {
                k: c / (n_fields // BLESSED_REPS * BLESSED_STEPS)
                for k, c in counts["generate"].items()},
            "cuda_launches": cuda_counts["generate"],
            "cuda_launches_per_forward": {
                k: c / (n_fields // BLESSED_REPS * BLESSED_STEPS)
                for k, c in cuda_counts["generate"].items()}}
    emit(line)
    fail_unless(rc == 0 and len(files) == 12 and line["finite"] and all(
        a.shape == (12, 1, 32, 32, 32) for a in fields)
        and min(counts["generate"][k] for k in FORWARD_KERNELS) > 0,
        "the blessed campaign is not 12 finite (12, 1, 32^3) files", line)

    # 3. the gate (evals/acceptance.py::run_gate): the first reps of
    # boxes 0 and 1 of the campaign, DDNM on box 0
    boxes, reps = acceptance.GATE_BOXES, acceptance.GATE_REPS
    samples = np.concatenate([np.load(camp / f"gen_{i}.npy")[:reps]
                              for i in range(boxes)])
    K.reset_launch_counts()
    result = acceptance.run_gate(vdm, cfg,
                                 samples=torch.from_numpy(samples).cuda())
    counts["ddnm"] = K.launch_counts()
    cuda_counts["ddnm"] = K.cuda_launch_counts()
    line = {"phase": "blessed", "what": "gate", "boxes": boxes,
            "reps": reps, "gate": result.table(),
            "ddnm_steps": acceptance.DDNM_STEPS, "ddnm_l": acceptance.DDNM_L,
            "ddnm_s": result.ddnm_s, "launches_ddnm": counts["ddnm"]}
    emit(line)
    fail_unless(not result.failed, "the blessed model fails the gate", line)

    # 4. the summary statistics of the campaign
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _ = run_cli(calc_ss.main, [BLESSED, "--data-dir", str(root)],
                    OUT_DIR / "blessed_calc_ss.log")
    torch.cuda.synchronize()
    ss_s = time.perf_counter() - t0
    with open(root / "summary.pkl", "rb") as fh:
        summary = pickle.load(fh)[BLESSED_CAMPAIGN]
    n_stats = len(summary["stats"])
    one, one_ms, _ = time_stats(torch, calc_ss,
                                torch.from_numpy(fields[0][:1]).cuda())
    # the GRF ground truth has zero mean: its P(k) over its sum is a ratio
    # to round-off (inf where the f32 sum is 0), in the JAX CLI as here,
    # so finiteness is asked of the samples' statistics
    line = {"phase": "blessed", "what": "calc_ss", "seconds": ss_s,
            "samples": n_stats, "ms_per_sample": ss_s * 1e3 / n_stats,
            "get_stats_ms_32": one_ms, "keys": sorted(one),
            "finite": all(np.isfinite(np.asarray(val, np.float64)).all()
                          for name, st in summary["stats"].items()
                          if "_GT_" not in name for val in st.values())}
    emit(line)
    fail_unless(rc == 0 and n_stats == 12 + 144 and line["finite"],
                "calc_ss of the blessed campaign failed", line)
    shutil.rmtree(root)

    total = {name: sum(c.get(name, 0) for c in counts.values())
             for name in UNSHARDED_KERNELS}
    cuda_total = {name: sum(c[name] for c in cuda_counts.values())
                  for name in K.cuda_launch_counts()}
    emit({"phase": "blessed", "what": "launches", "by_step": counts,
          "total": total, "cuda_by_step": cuda_counts,
          "cuda_total": cuda_total,
          "seconds": time.perf_counter() - t_phase})
    fail_unless(min(total[k] for k in FORWARD_KERNELS) > 0,
                "the blessed chain did not launch every forward kernel",
                {"total": total})
    for name in UNSHARDED_KERNELS:
        kernels[name]["launches_blessed"] = total[name]
        if name in FORWARD_KERNELS:  # this slice's path runs these four
            kernels[name]["launches"] = total[name]
    kernels["conv3d_k3s1_fwd"]["cuda_launches_blessed"] = cuda_total[
        "conv3d_k3s1_fwd"]

    # 5. the f32 train step that made the model: its preset (model, batch 8
    # at 32^3, learning rate, f32 moments, EMA) from the trained weights
    model = vt.build_model(cfg, device="cuda")
    load_params(entry["ckpt_dir"], model, step=entry["ckpt_step"])
    batch = loss_batch(torch, cfg.data.cropsize, BLESSED_TRAIN_BATCH, "cuda",
                       62)
    facts, trainer = timed_train_steps(
        torch, vt, K, model, batch, TRAIN_STEPS, 63,
        lr=cfg.run.learning_rate, moment=None, ema_decay=cfg.run.ema_decay)
    emit({"phase": "blessed", "what": "train_step", "model": BLESSED,
          "size": cfg.data.cropsize, "batch": BLESSED_TRAIN_BATCH, **facts})
    for name in UNSHARDED_KERNELS:
        kernels[name]["launches_blessed_train"] = facts["launches"][name]
    # 6. its f32 skip projections, one site line each (device time beside
    # the launch-rate-bound ms)
    mm1x1_f32_sites(torch, K, ("blessed",))
    # the sampler's forward at the campaign's batch, for the profile phase
    reps = BLESSED_REPS
    return (vdm, s[:1].expand(reps, -1, -1, -1, -1).cuda(),
            v[:1].expand(reps, -1).cuda(), trainer)


# ---------------------------------------------------- the trained chain

# the chain of ``vdm4cdm_torch.cli.blessed_chain`` from scratch at the
# preset's full width (VDM_GRF_c_c_32: chs 16..64, 32^3, b8, f32, dropout
# 0.1): CHAIN_STEPS train steps with a checkpoint every CHAIN_CKPT_EVERY and
# every step's loss logged, bless, a CV_12_12 campaign at
# CHAIN_SAMPLING_STEPS, calc_ss; then CHAIN_REPS fields of box 0 from the
# blessed copy and from the run directory
CHAIN_STEPS, CHAIN_CKPT_EVERY, CHAIN_SAMPLING_STEPS, CHAIN_REPS = (
    300, 100, 20, 2)
CHAIN_WINDOW = 50  # the mean logged loss of the last steps must be lower
# the ``trained`` phase's chain directory: the whole 20000-step run, which
# resumes from the latest checkpoint there (one call does not hold it all:
# ``python -m vdm4cdm_torch.cli.blessed_chain --until S --stages train``
# first, then ``--phases trained``)
TRAINED_OUT = ROOT / "runs" / "blessed_chain"
# the chain phase's directory (its checkpoints are 57 MB each: under runs/,
# which git ignores, and outside chiprun_out)
CHAIN_OUT = ROOT / "runs" / "chip_smoke_chain"


def run_logged(main, argv, log):
    """``main(argv)`` in this process, its printed lines written through to
    the file ``log`` as they come (an hour-long run keeps its log if the
    call is cut); returns (exit code, the chain's JSON lines)."""
    with open(log, "a", buffering=1) as fh:
        start = fh.tell()
        fh.write(f"$ {' '.join(map(str, argv))}\n")
        with contextlib.redirect_stdout(fh):
            rc = main(argv)
    with open(log) as fh:
        fh.seek(start)
        lines = fh.read().splitlines()
    return rc, [json.loads(ln) for ln in lines if ln.startswith('{"chain"')]


def phase_chain(torch, vt, K, kernels):
    """The trained-model chain from scratch on the card (``cli.
    blessed_chain`` in this process, stages train, bless, generate and
    calc_ss at CHAIN_STEPS steps): every kernel of the train step and the
    sampler launched, the blessed copy bit-equal to the run's checkpoint,
    the blessed copy's fields bit-equal to the run's and to a second draw
    from the copy (the card's forward repeats bit for bit), finite weights
    and losses, a falling loss, a whole summary. Its directory is deleted
    after the checks; the log and ``metrics.csv`` go to chiprun_out."""
    import pickle
    import shutil

    from vdm4cdm_torch.cli import blessed_chain
    from vdm4cdm_torch.train.checkpoint import load_params, read_checkpoint

    root = CHAIN_OUT
    shutil.rmtree(root, ignore_errors=True)
    log = OUT_DIR / "chain.log"
    log.write_text("")
    overrides = [f"run.max_steps={CHAIN_STEPS}",
                 f"run.ckpt_every_steps={CHAIN_CKPT_EVERY}",
                 "run.log_every_steps=1"]
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, lines = run_logged(blessed_chain.main, [
        "--out", str(root), "--stages", "train,bless,generate,calc_ss",
        "--n-sampling-steps", str(CHAIN_SAMPLING_STEPS), "--set",
        *overrides], log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = K.launch_counts()
    by_stage = {ln["chain"]: ln for ln in lines}
    chain = blessed_chain.Chain(str(root), overrides, "cuda",
                                CHAIN_SAMPLING_STEPS)
    shutil.copy(pathlib.Path(chain.run_dir) / "metrics.csv",
                OUT_DIR / "chain_metrics.csv")

    # the blessed copy against the run's checkpoint, tensor by tensor
    run = read_checkpoint(chain.ckpt_dir, CHAIN_STEPS)
    blessed = read_checkpoint(chain.blessed_dir, CHAIN_STEPS)
    copy_equal = all(torch.equal(blessed[tree][k], run[tree][k])
                     for tree in ("params", "ema_params")
                     for k in run[tree])
    finite = all(bool(torch.isfinite(t).all()) for tree in
                 ("params", "ema_params") for t in run[tree].values())

    # fields of box 0, one seed, in this process: a warm-up draw (cuDNN's
    # benchmark search at these shapes), then from the blessed copy, the
    # run directory and the blessed copy again (the card's repeat spread)
    box = next(iter(vt.build_datamodule(chain.cfg, stage="test")
                    .test_dataloader()))
    s = torch.from_numpy(np.repeat(box["conditioning"][:1], CHAIN_REPS,
                                   axis=0)).cuda()
    v = torch.from_numpy(np.repeat(box["conditioning_values"][0][:1],
                                   CHAIN_REPS, axis=0)).cuda()
    model = vt.build_model(chain.cfg, device="cuda").eval()

    def draw(ckpt_dir):
        load_params(ckpt_dir, model, step=CHAIN_STEPS)
        return model.draw_samples(
            torch.Generator(device="cuda").manual_seed(71),
            batch_size=CHAIN_REPS, n_sampling_steps=CHAIN_SAMPLING_STEPS,
            s_conditioning=s, v_conditionings=[v])

    draw(chain.blessed_dir)
    fields = [draw(d) for d in (chain.blessed_dir, chain.ckpt_dir,
                                chain.blessed_dir)]
    scale = fields[0].abs().max().item()

    rows = [r for r in read_metrics(pathlib.Path(chain.run_dir)
                                    / "metrics.csv")
            if r.get("step_s") not in (None, "")]
    losses = [float(r["loss"]) for r in rows]
    with open(root / "summary.pkl", "rb") as fh:
        stats = pickle.load(fh)["CV_12_12"]["stats"]
    line = {"phase": "chain", "model": blessed_chain.NAME,
            "steps": CHAIN_STEPS, "ckpt_every": CHAIN_CKPT_EVERY,
            "sampling_steps": CHAIN_SAMPLING_STEPS, "seconds": seconds,
            "seconds_by_stage": {k: ln["seconds"]
                                 for k, ln in by_stage.items()},
            "step_s": by_stage["train"]["step_s"],
            "feed_wait_s": by_stage["train"]["feed_wait_s"],
            "loss_first": statistics.fmean(losses[:CHAIN_WINDOW]),
            "loss_last": statistics.fmean(losses[-CHAIN_WINDOW:]),
            "logged_steps": len(losses),
            "all_finite": finite and all(map(math.isfinite, losses)),
            "blessed_equal_run": copy_equal,
            "fields_equal": bool(torch.equal(fields[0], fields[1])),
            "fields_repeat_equal": bool(torch.equal(fields[0], fields[2])),
            "fields_max_abs": scale,
            "fields_max_abs_diff": (fields[0] - fields[1]).abs().max().item(),
            "fields_repeat_max_abs_diff": (fields[0] - fields[2]).abs().max()
            .item(),
            "fields_finite": bool(torch.isfinite(fields[0]).all()),
            "summary_samples": len(stats),
            "summary_finite": all(
                np.isfinite(np.asarray(val, np.float64)).all()
                for name, st in stats.items() if "_GT_" not in name
                for val in st.values()),
            "launches": counts}
    emit(line)
    fail_unless(
        rc == 0 and set(by_stage) == {"train", "bless", "generate",
                                      "calc_ss"}
        and line["logged_steps"] == CHAIN_STEPS and line["all_finite"]
        and line["loss_last"] < line["loss_first"]
        and copy_equal and line["fields_finite"]
        and line["fields_equal"] and line["fields_repeat_equal"]
        and line["fields_repeat_max_abs_diff"] == 0
        and line["summary_samples"] == 12 + 144 and line["summary_finite"]
        and min(counts[k] for k in UNSHARDED_KERNELS) > 0,
        "the trained-model chain failed", line)
    shutil.rmtree(root)
    for name in UNSHARDED_KERNELS:  # this slice's path runs all eight
        kernels[name]["launches_chain"] = counts[name]
        kernels[name]["launches"] = counts[name]


def phase_trained(torch, K):
    """The whole chain of the blessed model (20000 steps, bless, the
    250-step CV_12_12 campaign, calc_ss, the gate) in TRAINED_OUT, resumed
    from its latest checkpoint; fails unless the gate passes."""
    from vdm4cdm_torch.cli import blessed_chain

    K.reset_launch_counts()
    rc, lines = run_logged(blessed_chain.main, ["--out", str(TRAINED_OUT)],
                           OUT_DIR / "trained.log")
    for ln in lines:
        emit({"phase": "trained", **ln})
    emit({"phase": "trained", "what": "launches",
          "launches": K.launch_counts()})
    gate = [ln for ln in lines if ln["chain"] == "gate"]
    fail_unless(rc == 0 and gate and gate[0]["passed"],
                "the model trained by the port fails the gate",
                {"rc": rc, "failed": gate[0]["failed"] if gate else None})


# ------------------------------------------------------------- 2D phase

# the 2D models at the full width of their presets (reference
# train_uc_c / trainSFM_c_uc: 256^2 maps, batch 12, f32), on GRF data
# (periodic: circular padding); every conv of a 2D model is cuDNN's, the
# norms and the skip projections are the hand kernels
TWOD_VDM, TWOD_SFM, TWOD_CLI = "train_uc_c", "trainSFM_c_uc", "smoke_vdm_2d"
TWOD_CHS = (48, 96, 192, 384)
TWOD_SIZE, TWOD_BATCH, TWOD_PARITY_SIZE = 256, 12, 64
TWOD_KERNELS = ("gn_sums", "gn_apply", "gn_bwd_sums", "gn_bwd_apply",
                "mm1x1_fwd", "mm1x1_dw")
TWOD_FORWARD = ("gn_sums", "gn_apply", "mm1x1_fwd")
# the CLI drive: train to 3 (a checkpoint at 3), resume to 5 (steps 4 and
# 5 validate nowhere, so their launches are the train steps' alone)
TWOD_CLI_FIRST, TWOD_CLI_LAST = 3, 5
TWOD_PAIR = (64, 384, 192, 8)  # up_2_0's join: 576 channels, groups of 72


def build_2d(vt, name, size, device, seed, ctx=None, **overrides):
    """A 2D preset's model at crop ``size`` on GRF data, remat off, every
    parameter randomized from the seed (alike on the ranks of a sharded
    phase), split along H over ``ctx``'s sp ranks when it is given;
    returns (model, config)."""
    if ctx is not None:
        overrides["parallel.n_sp"] = ctx.size
    cfg = vt.preset(name, **{"data.kind": "grf", "data.cropsize": size,
                             "model.remat": False, **overrides})
    if tuple(cfg.model.chs) != TWOD_CHS or cfg.model.ndim != 2:
        raise AssertionError(f"{name} is not the full-width 2D model")
    model = vt.build_model(cfg, device=device, ctx=ctx)
    randomize_(model, seed)
    return model.eval(), cfg


def batch_2d(torch, vt, cfg, batch, device):
    """The preset's own GRF batch of ``batch`` fields, on ``device``."""
    cfg.data.batch_size = batch
    raw = next(vt.build_datamodule(cfg).train_batches(1))
    return {k: ([torch.from_numpy(a).to(device) for a in v]
                if isinstance(v, list) else torch.from_numpy(v).to(device))
            for k, v in raw.items()}


def check_library_conv_precision(torch):
    """The repair of the library conv's precision: ``conv_nd`` on f32 card
    tensors, with the process at PyTorch's default (TF32 on for cuDNN
    convolutions), against an f64 reference on the card: forward, dx and dw
    at f32 accuracy; the bare ``F.conv2d`` under the same setting beside it
    (one TF32 pass)."""
    import torch.nn.functional as F

    from vdm4cdm_torch.ops.conv import conv_nd

    gen = torch.Generator(device="cuda").manual_seed(81)
    B, H, C = 2, TWOD_SIZE, TWOD_CHS[0]
    x = torch.randn(B, H, H, C, generator=gen, device="cuda")
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") / math.sqrt(
        9 * C)
    ct = torch.randn(B, H, H, C, generator=gen, device="cuda")

    def ref_conv(xx, ww):
        xc = F.pad(xx.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="circular")
        return F.conv2d(xc, ww.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)

    x64, w64 = (t.double().requires_grad_(True) for t in (x, w))
    y64 = ref_conv(x64, w64)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), ct.double())
    xg, wg = (t.clone().requires_grad_(True) for t in (x, w))
    with cudnn_benchmark(tf32=True):
        y = conv_nd(xg, wg, padding_mode="circular")
        dx, dw = torch.autograd.grad(y, (xg, wg), ct)
        with torch.no_grad():
            y_raw = ref_conv(x, w)
        torch.cuda.synchronize()
    errs = {name: rel_err(got, ref)[1] for name, got, ref in (
        ("y", y, y64), ("dx", dx, dx64), ("dw", dw, dw64),
        ("y_bare_conv2d_tf32_default", y_raw, y64))}
    tol = TOL[("conv", "float32")]
    line = {"phase": "twod", "what": "library conv precision",
            "shape": [B, H, H, C, C], "mode": "circular",
            "process_tf32": True, "rel_err": errs, "tol": tol}
    fail_unless(max(errs["y"], errs["dx"], errs["dw"]) <= tol,
                "the library conv ran below f32 accuracy", line)
    emit(line)


def twod_parity(torch, vt, K):
    """``train_uc_c`` at full width on a 64^2 crop, batch 2, f32: eps_hat,
    then the loss and every parameter's gradient (dropout 0.1, injected t,
    eps and seed), on the card against the CPU plain path."""
    t0 = time.perf_counter()
    size = TWOD_PARITY_SIZE
    models = {dev: build_2d(vt, TWOD_VDM, size, dev, 71)[0]
              for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(72)
    z = torch.randn(2, size, size, 1, generator=gen)
    x = torch.randn(2, size, size, 1, generator=gen)
    eps = torch.randn(2, size, size, 1, generator=gen)
    v = torch.randn(2, 6, generator=gen)
    t = torch.tensor([0.3, 0.8])
    with torch.inference_mode():
        ref = models["cpu"].eps_hat(z, t, None, [v])
        got = models["cuda"].eps_hat(z.cuda(), t.cuda(), None,
                                     [v.cuda()]).cpu()
    abs_err, err = rel_err(got, ref)
    line = {"phase": "twod", "what": "eps_hat parity", "model": TWOD_VDM,
            "size": size, "batch": 2, "chs": list(TWOD_CHS),
            "dtype": "float32", "max_abs_ref": ref.abs().max().item(),
            "max_abs_err": abs_err, "rel_err": err, "tol": PARITY_TOL,
            "seconds": time.perf_counter() - t0}
    fail_unless(bool(torch.isfinite(got).all()) and err <= PARITY_TOL
                and ref.abs().max().item() > 0.1, "2D eps_hat parity failed",
                line)
    emit(line)

    t0 = time.perf_counter()
    out = {}
    K.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        batch = {"x": x.to(dev), "conditioning": None,
                 "conditioning_values": [v.to(dev)]}
        out[dev] = loss_and_grads(models[dev].train(), batch, t.to(dev),
                                  eps.to(dev), 0x2D5EED)
    check_grads(torch, f"{TWOD_VDM} (2D, {size}^2)", out,
                K.launch_counts(), size, t0, kernels=TWOD_KERNELS)


def twod_train(torch, vt, K, name, seed):
    """A warm-up and 3 timed f32 train steps of a 2D preset at 256^2, batch
    12, then its device time by category and idle share (profiled steps
    after the timed ones)."""
    torch.cuda.empty_cache()
    held = resident_gib(torch)
    model, cfg = build_2d(vt, name, TWOD_SIZE, "cuda", seed)
    batch = batch_2d(torch, vt, cfg, TWOD_BATCH, "cuda")
    facts, trainer = timed_train_steps(torch, vt, K, model, batch,
                                       TRAIN_STEPS, seed + 1,
                                       kernels=TWOD_KERNELS, moment=None)
    net = model.score_model if hasattr(model, "score_model") else model.unet
    line = {"phase": "twod", "what": "train", "preset": name,
            "size": TWOD_SIZE, "batch": TWOD_BATCH,
            "padding": net.conv_padding_mode, "mid_attn": net.mid_attn,
            "held_by_earlier_phases_gib": held,
            "mpixel_per_s": facts["voxels_per_s"] / 1e6, **facts}
    emit(line)
    prof = phase_profile_train(torch, *trainer, tag=f"twod_{name}",
                               library=LIBRARY_2D)
    return facts, prof, trainer


def twod_sampler(torch, K, model, batch, family):
    """3 sampler steps at batch 1 (the VDM's ancestral steps, the SFM's
    Heun steps) after a one-step warm-up: s/step and s/field at 250."""
    v = [a[:1] for a in batch["conditioning_values"]]
    if family == "vdm":
        gen = torch.Generator(device="cuda")

        def draw(n):
            return model.draw_samples(gen.manual_seed(5), batch_size=1,
                                      n_sampling_steps=n, v_conditionings=v)
        forwards = 1
    else:
        x0 = batch["x0"][:1]

        def draw(n):
            return model.draw_samples(x0, n, v, method="heun")
        forwards = 2
    model.eval()
    draw(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = draw(MAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    finite = bool(torch.isfinite(out).all())
    line = {"phase": "twod", "what": "draw_samples", "family": family,
            "method": "ancestral" if family == "vdm" else "heun",
            "size": TWOD_SIZE, "batch": 1, "steps": MAIN_STEPS,
            "forwards_per_step": forwards, "seconds": dt,
            "s_per_step": dt / MAIN_STEPS,
            "s_per_field_250": dt / MAIN_STEPS * FIELD_STEPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts,
            "launches_per_forward": {k: c / (forwards * MAIN_STEPS)
                                     for k, c in counts.items()},
            "out_shape": list(out.shape), "finite": finite}
    fail_unless(finite and tuple(out.shape) == (1, TWOD_SIZE, TWOD_SIZE, 1)
                and min(counts[k] for k in TWOD_FORWARD) > 0,
                "the 2D sampler did not give a finite field through every "
                "forward kernel", line)
    emit(line)
    return counts


@contextlib.contextmanager
def recorded_sites(sites):
    """Every call of the norm and 1x1 kernels, as ``ops/norm.py`` and
    ``ops/conv.py`` make them, adds its site to ``sites``: ("norm", S, C)
    for ``gn_apply`` and ("mm1x1", S, K, N) for a forward with bias (the
    projection itself, not its dx pass)."""
    from vdm4cdm_torch.ops import conv as ops_conv
    from vdm4cdm_torch.ops import norm as ops_norm

    apply, fwd = ops_norm.gn_apply, ops_conv.mm1x1_fwd

    def gn_apply(x, a, b, act, p=0.0, seed=0):
        sites.add(("norm", x.shape[1], x.shape[2]))
        return apply(x, a, b, act, p, seed)

    def mm1x1_fwd(x, w, bias=None, residual=None, w_transposed=False):
        if bias is not None:
            sites.add(("mm1x1", x.shape[1:-1].numel(), w.shape[0],
                       w.shape[1]))
        return fwd(x, w, bias, residual, w_transposed)

    ops_norm.gn_apply, ops_conv.mm1x1_fwd = gn_apply, mm1x1_fwd
    try:
        yield sites
    finally:
        ops_norm.gn_apply, ops_conv.mm1x1_fwd = apply, fwd


def twod_sites(torch, vt, K):
    """Every distinct norm and ``skip_proj`` site of ``train_uc_c`` (read
    off one forward at 256^2), checked and timed at batch 12 in f32: the
    norm's four passes (the apply and the backward pair at p = 0.1 beside
    p = 0, dropout checked bit for bit), the 1x1 projection's forward, dx
    pass and dw; then one decoder join whose group straddles the halves,
    forward and backward. One ``site`` line each, with the 3D site lines'
    names; returns the lines of the largest site of each kernel."""
    t0 = time.perf_counter()
    model, cfg = build_2d(vt, TWOD_VDM, TWOD_SIZE, "cuda", 73)
    batch = batch_2d(torch, vt, cfg, 1, "cuda")
    sites = set()
    with recorded_sites(sites), torch.inference_mode():
        model.eps_hat(batch["x"], torch.tensor([0.5], device="cuda"), None,
                      batch["conditioning_values"], train=True,
                      dropout_seed=1)
    del model
    dt, B = "float32", TWOD_BATCH
    norm = sorted(s[1:] for s in sites if s[0] == "norm")
    mm = sorted(s[1:] for s in sites if s[0] == "mm1x1")
    heads = {}
    for S, C in norm:
        size = int(round(math.sqrt(S)))
        check_dropout_apply(torch, K, size, C, dt, B, S=S)
        sums, apply, bwd = norm_site(torch, K, size, C, dt, B, S=S,
                                     model=TWOD_VDM)
        for name, ln in (("gn_sums", sums), ("gn_apply", apply),
                         ("gn_bwd_sums", bwd[0]), ("gn_bwd_apply", bwd[1])):
            if name not in heads or ln["bound_ms"] > heads[name]["bound_ms"]:
                heads[name] = ln
    fail_unless(mm == sorted(twod_mm1x1_cases()),
                "the 2D forward's skip_proj sites are not twod_mm1x1_cases()",
                {"recorded": mm})
    heads.update(mm1x1_f32_sites(torch, K, ("twod",)))
    size, ca, cb, groups = TWOD_PAIR
    check_pair_norm(torch, size, ca, cb, groups, dt, nd=2)
    check_pair_norm_bwd(torch, size, ca, cb, groups, dt, nd=2)
    emit({"phase": "twod", "what": "sites", "model": TWOD_VDM,
          "norm_sites": norm, "mm1x1_sites": mm,
          "seconds": time.perf_counter() - t0})
    fail_unless(len(norm) > 0 and len(mm) > 0 and any(
        S == TWOD_SIZE ** 2 for S, _ in norm), "no 2D sites recorded",
        {"sites": sorted(sites)})
    return heads


def twod_cli(torch, vt, K):
    """``cli.train --preset smoke_vdm_2d`` to step 3, resumed to 5, then
    ``cli.generate`` CV_12_12 from its checkpoints (2 sampler steps, 12
    reps a call): the resumed steps' launches must equal a bare step's of
    the same preset. Run directory in ``chiprun_out/cli_runs_2d/``;
    checkpoints and samples deleted after their checks."""
    import shutil

    from vdm4cdm_torch.cli import generate, train

    t0 = time.perf_counter()
    cfg = vt.preset(TWOD_CLI)
    model = vt.build_model(cfg, device="cuda")
    randomize_(model, 74)
    bare, _ = timed_train_steps(torch, vt, K, model.train(),
                                batch_2d(torch, vt, cfg,
                                         cfg.data.batch_size, "cuda"), 1, 75,
                                kernels=TWOD_KERNELS, moment=None)
    del model
    root = OUT_DIR / "cli_runs_2d"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log = root / "smoke_vdm_2d.log"
    sets = [f"run.out_dir={root}",
            f"run.ckpt_every_steps={TWOD_CLI_FIRST}",
            f"run.val_check_interval={TWOD_CLI_FIRST}",
            "run.n_val_batches=1", "run.log_every_steps=1",
            f"run.n_figure_sampling_steps={FIGURE_STEPS}"]
    counts, out = {}, []
    for what, steps in (("train", TWOD_CLI_FIRST), ("resume", TWOD_CLI_LAST)):
        K.reset_launch_counts()
        rc, out = run_cli(train.main, ["--preset", TWOD_CLI, "--set", *sets,
                                       f"run.max_steps={steps}"], log)
        torch.cuda.synchronize()
        counts[what] = K.launch_counts()
        fail_unless(rc == 0, f"cli.train {what} failed", {"rc": rc})
    resumed = [int(ln.rsplit(" ", 1)[1]) for ln in out
               if ln.startswith("[trainer] resumed from step")]
    ckpt_dir = root / TWOD_CLI / "checkpoints"
    steps_saved = sorted(int(p.name) for p in ckpt_dir.iterdir())
    gen_dir = root / "samples" / CLI_CAMPAIGN
    K.reset_launch_counts()
    rc, _ = run_cli(generate.main, [
        TWOD_CLI, str(gen_dir), CLI_CAMPAIGN, "--ckpt-dir", str(ckpt_dir),
        "--n-sampling-steps", str(CLI_SAMPLING_STEPS), "--reps-per-batch",
        "12"], log)
    torch.cuda.synchronize()
    counts["generate"] = K.launch_counts()
    files, finite = {}, rc == 0
    for path in sorted(gen_dir.iterdir()):
        a = np.load(path)
        files[path.name] = list(a.shape)
        finite = finite and bool(np.isfinite(a).all())
    shutil.rmtree(gen_dir.parent)
    shutil.rmtree(ckpt_dir)
    n = TWOD_CLI_LAST - TWOD_CLI_FIRST
    per_step = {k: c / n for k, c in counts["resume"].items()}
    size = cfg.data.cropsize
    line = {"phase": "twod", "what": "cli", "preset": TWOD_CLI,
            "size": size, "batch": cfg.data.batch_size,
            "chs": list(cfg.model.chs), "resumed_from":
            resumed[0] if resumed else None, "checkpoint_steps": steps_saved,
            "launches_per_step": per_step,
            "bare_launches_per_step": bare["launches_per_step"],
            "launches": counts, "files": files, "finite": finite,
            "seconds": time.perf_counter() - t0}
    emit(line)
    fail_unless(line["resumed_from"] == TWOD_CLI_FIRST
                and steps_saved == [TWOD_CLI_FIRST, TWOD_CLI_LAST]
                and all(per_step[k] == bare["launches_per_step"][k]
                        for k in TWOD_KERNELS),
                "the 2D CLI did not resume, or its launches per step differ "
                "from the bare step's", line)
    fail_unless(finite and len(files) == CLI_FILES and all(
        shape == [12, 1, size, size] for shape in files.values())
        and min(counts["generate"][k] for k in TWOD_FORWARD) > 0,
        "the 2D campaign files are not 12 finite (12, 1, S, S) fields",
        line)
    return counts


def twod_example(vt):
    """``python -m vdm4cdm_torch.examples.smoke_test --steps 5`` as a user
    runs it (its own process, on the card; the ``vdm4cdm_torch`` this
    script imported): ``smoke_vdm_2d`` trained 5 steps, 2 fields sampled,
    the panel written (its arrays, without matplotlib). Its output goes to
    ``chiprun_out/examples_smoke.log``."""
    import os

    t0 = time.perf_counter()
    port = str(pathlib.Path(vt.__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (port, os.environ.get("PYTHONPATH")))))
    proc = subprocess.run(
        [sys.executable, "-m", "vdm4cdm_torch.examples.smoke_test",
         "--steps", "5", "--out", str(OUT_DIR / "examples_smoke")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    (OUT_DIR / "examples_smoke.log").write_text(proc.stdout + proc.stderr)
    printed = proc.stdout.splitlines()
    line = {"phase": "twod", "what": "examples.smoke_test",
            "argv": "--steps 5", "rc": proc.returncode,
            "printed": [ln for ln in printed if ln.startswith(
                ("trained", "samples:", "figure:", "matplotlib"))],
            "seconds": time.perf_counter() - t0}
    fail_unless(proc.returncode == 0
                and any(ln.startswith("trained 5 steps") for ln in printed)
                and any(ln.startswith("figure: ") for ln in printed),
                "examples.smoke_test failed on the card", line)
    emit(line)


def phase_twod(torch, vt, K, kernels):
    """The 2D model family (see the module docstring); every kernel's
    launches over the phase's driven paths (the train steps, the samplers,
    the CLI) go to ``kernels[...]["launches_twod"]``."""
    t_phase = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    check_library_conv_precision(torch)
    twod_parity(torch, vt, K)
    lap("precision_and_parity")
    heads = twod_sites(torch, vt, K)
    lap("sites")
    total = {name: 0 for name in UNSHARDED_KERNELS}

    def add(counts):
        for name in total:
            total[name] += counts[name]

    summary = {}
    for name, family, seed in ((TWOD_VDM, "vdm", 76), (TWOD_SFM, "sfm", 78)):
        facts, prof, trainer = twod_train(torch, vt, K, name, seed)
        add(facts["launches"])
        add(twod_sampler(torch, K, trainer[0].model, trainer[2], family))
        summary[name] = {"s_per_step": facts["s_per_step"],
                         "peak_mem_gib": facts["peak_mem_gib"],
                         "idle_share": prof["idle_share"],
                         "by_category_ms": prof["by_category_ms"]}
        del trainer
        lap(name)
    cli = twod_cli(torch, vt, K)
    for counts in cli.values():
        add(counts)
    lap("cli")
    twod_example(vt)
    lap("example")
    emit({"phase": "twod", "what": "launches", "total": total,
          "summary": summary, "seconds_by_part": parts,
          "seconds": time.perf_counter() - t_phase})
    fail_unless(min(total[k] for k in TWOD_KERNELS) > 0
                and total["conv3d_k3s1_fwd"] == 0,
                "the 2D path did not run through every 2D kernel",
                {"total": total})
    for name in UNSHARDED_KERNELS:
        kernels[name]["launches_twod"] = total[name]
    for name, ln in heads.items():
        kernels[name]["twod_site"] = {
            "shape": ln["shape"], "ms": ln["ms"], "bound_ms": ln["bound_ms"],
            "library_ms": ln["library_ms"], "max_abs_err": ln["max_abs_err"]}


# ----------------------------------------------------------- twod_sharded

# the twod_sharded phase: 2D models split along H over two sp ranks that
# share cuda:0 over gloo. Parity at full width on a crop of TWOD_PARITY_SIZE,
# batch 2 (the samplers TWOD_SHARDED_SAMPLER_STEPS steps); then train_uc_c
# through the CLI at 256^2 as the sharded_cli phase runs the flagship, at a
# global batch of 4, not the preset's 12: at 12 the phase took 180 s, 67 s of
# it the first step's cuDNN benchmark search for the slab shapes on both
# ranks at once (NVIDIA H100 80GB HBM3, 700 W); its directory (under runs/,
# which git ignores) is deleted after the checks
TWOD_SHARDED_SAMPLER_STEPS = 5
TWOD_SHARDED_BATCH = 4
TWOD_SHARDED_OUT = ROOT / "runs" / "chip_smoke_twod_sharded"


def twod_parity_inputs(torch, family, size, seed):
    """Global f32 inputs of a 2D parity check at batch 2: z, t, the batch
    of one loss and its eps, the conditioning (v always; x0 for the SFM,
    its spatial conditioning)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (2, size, size, 1)

    def n(*s):
        return torch.randn(*s, generator=gen).cuda()

    v = [n(2, 6)] if family == "vdm" else []
    out = {"z": n(*shape), "t": torch.tensor([0.3, 0.8], device="cuda"),
           "tt": torch.tensor([0.35, 0.85], device="cuda"), "eps": n(*shape),
           "v": v}
    if family == "vdm":
        out["batch"] = {"x": n(*shape), "conditioning": None,
                        "conditioning_values": v}
    else:
        x0 = n(*shape)
        out["x0"] = x0
        out["batch"] = {"x0": x0, "x1": 0.6 * x0 + 0.8 * n(*shape),
                        "conditioning_values": v}
    return out


def twod_sharded_parity(torch, vt, K, ctx, name, family, seed):
    """One 2D preset at full width on a TWOD_PARITY_SIZE^2 crop, f32,
    dropout off, sharded along H against unsharded on the card: eps_hat
    (the SFM's velocity), TWOD_SHARDED_SAMPLER_STEPS sampler steps (the
    VDM's ancestral steps on injected noise, the SFM's Heun steps through
    ``make_sharded_sfm_sampler``), and the loss and every gradient of one
    step (injected t and eps; the gradients averaged over the mesh)."""
    from vdm4cdm_torch.parallel import local_slab, make_sharded_sfm_sampler

    t0 = time.perf_counter()
    size = TWOD_PARITY_SIZE
    over = {"model.dropout_prob": 0.0}
    ref, _ = build_2d(vt, name, size, "cuda", seed, **over)
    sh, _ = build_2d(vt, name, size, "cuda", seed, ctx=ctx, **over)
    inp = twod_parity_inputs(torch, family, size, seed + 1)
    v, t = inp["v"], inp["t"]

    def slab(x):
        return local_slab(x, ctx)

    errs = {}
    K.reset_launch_counts()
    with torch.inference_mode():
        if family == "vdm":
            want = slab(ref.eps_hat(inp["z"], t, None, v))
            got = sh.eps_hat(slab(inp["z"]), t, None, v)
        else:
            want = slab(ref.velocity(inp["z"], t, v, inp["x0"]))
            got = sh.velocity(slab(inp["z"]), t, v, slab(inp["x0"]))
        errs["forward"] = rel_err(got, want)
        max_ref = want.abs().max().item()
        n = TWOD_SHARDED_SAMPLER_STEPS
        if family == "vdm":
            gen = torch.Generator(device="cuda").manual_seed(seed + 2)
            z0 = torch.randn(2, size, size, 1, generator=gen, device="cuda")
            eps = [torch.randn(2, size, size, 1, generator=gen,
                               device="cuda") for _ in range(n)]
            want_s = slab(ref.draw_samples(batch_size=2, n_sampling_steps=n,
                                           v_conditionings=v,
                                           noise=(z0, eps)))
            got_s = sh.draw_samples(batch_size=2, n_sampling_steps=n,
                                    v_conditionings=v,
                                    noise=(slab(z0), [slab(e) for e in eps]))
        else:
            want_s = ref.draw_samples(inp["x0"], n, v, method="heun")
            got_s = make_sharded_sfm_sampler(sh, n)(inp["x0"], v)
        torch.cuda.synchronize()
        errs["sampler"] = rel_err(got_s, want_s)
    forward_counts = K.launch_counts()

    ref_l = ref.loss(inp["batch"], train=True, t=inp["tt"], eps=inp["eps"])
    ref_l.loss.backward()
    local = {k: (val if k == "conditioning_values" or val is None
                 else slab(val)) for k, val in inp["batch"].items()}
    sh_l = sh.loss(local, train=True, t=inp["tt"], eps=slab(inp["eps"]))
    sh_l.loss.backward()
    g_errs, top, worst, loss_err = sharded_grad_parity(torch, ref, sh, ref_l,
                                                       sh_l, ctx)
    net = ref.score_model if family == "vdm" else ref.unet
    line = {"phase": "twod_sharded", "what": "parity", "model": name,
            "family": family, "size": size, "batch": 2, "slab":
            list(got.shape), "chs": list(TWOD_CHS), "dtype": "float32",
            "dropout": 0.0, "mid_attn": net.mid_attn,
            "padding": net.conv_padding_mode,
            "max_abs_ref": max_ref,
            "forward_max_abs_err": errs["forward"][0],
            "forward_rel_err": errs["forward"][1],
            "sampler_steps": n,
            "sampler": "ancestral, injected noise" if family == "vdm"
            else "heun", "sampler_max_abs_err": errs["sampler"][0],
            "sampler_rel_err": errs["sampler"][1], "tol": SHARDED_TOL,
            "loss": ref_l.loss.item(), "loss_rel_err": loss_err,
            "grads_rel_err": g_errs[worst], "worst_param": worst,
            "max_abs_grad": top, "grads_tol": GRADS_TOL,
            "launches_forward_and_sampler": forward_counts,
            "seconds": time.perf_counter() - t0}
    fail_unless(bool(torch.isfinite(got).all()) and max_ref > 0.1
                and errs["forward"][1] <= SHARDED_TOL
                and errs["sampler"][1] <= SHARDED_TOL
                and g_errs[worst] <= GRADS_TOL and loss_err <= 1e-4
                and top > 1e-3
                and min(forward_counts[k] for k in TWOD_FORWARD) > 0,
                "2D sharded parity failed", line)
    emit(line)


def twod_sharded_step(torch, vt, K, ctx):
    """A warm-up and one bare sharded ``train_uc_c`` step at the CLI's
    shapes (a rank's slab of the global batch), then one with the device
    synchronized around every collective: the collectives' counters of one
    step (their wall time their own, not the queued kernels')."""
    from vdm4cdm_torch.parallel import local_slab

    torch.cuda.empty_cache()
    model, cfg = build_2d(vt, TWOD_VDM, TWOD_SIZE, "cuda", 95, ctx=ctx)
    g = batch_2d(torch, vt, cfg, TWOD_SHARDED_BATCH, "cuda")
    batch = {"x": local_slab(g["x"], ctx), "conditioning": None,
             "conditioning_values": g["conditioning_values"]}
    facts, (state, step, _, gen) = timed_train_steps(
        torch, vt, K, model.train(), batch, 1, 96, TWOD_KERNELS, ctx,
        moment=None)
    synced = synced_step(torch, step, state, batch, gen, ctx)
    emit({"phase": "twod_sharded", "what": "bare step", "preset": TWOD_VDM,
          "size": TWOD_SIZE, "global_batch": TWOD_SHARDED_BATCH,
          "slab": list(batch["x"].shape), "n_sp": ctx.size,
          "s_per_step": facts["s_per_step"],
          "peak_mem_gib": facts["peak_mem_gib"], "comm": facts["comm"],
          "synced_step": synced, "launches_per_step":
          facts["launches_per_step"]})
    return synced


def twod_sharded_sites(torch, vt, K, ctx, rank):
    """Every norm and ``skip_proj`` site of a rank's ``train_uc_c`` slab at
    TWOD_SIZE^2 (read off one sharded forward on every rank), checked
    against the plain versions on rank 0 while the others wait, untimed, in
    f32 at the CLI's batches: ``gn_sums`` and ``gn_apply`` at the train
    step's TWOD_SHARDED_BATCH and the sampler's SHARDED_CLI_REPS, the
    apply's dropout bits, the backward pair at p = 0.1, and the 1x1
    forward, dx pass and dw at TWOD_SHARDED_BATCH. Returns rank 0's worst
    check of each kernel over the sites (empty on the others)."""
    import torch.distributed as dist

    from vdm4cdm_torch.parallel import local_slab

    t0 = time.perf_counter()
    model, cfg = build_2d(vt, TWOD_VDM, TWOD_SIZE, "cuda", 97, ctx=ctx)
    batch = batch_2d(torch, vt, cfg, 1, "cuda")
    sites = set()
    with recorded_sites(sites), torch.inference_mode():
        model.eps_hat(local_slab(batch["x"], ctx),
                      torch.tensor([0.5], device="cuda"), None,
                      batch["conditioning_values"], train=True,
                      dropout_seed=1)
    del model
    norm = sorted(s[1:] for s in sites if s[0] == "norm")
    mm = sorted(s[1:] for s in sites if s[0] == "mm1x1")
    worst, dt, B = {}, "float32", TWOD_SHARDED_BATCH
    dist.barrier()
    if rank == 0:
        lines = []
        for S, C in norm:
            size = int(round(math.sqrt(S)))  # the inputs' seed alone
            check_dropout_apply(torch, K, size, C, dt, B, S=S)
            for b in (B, SHARDED_CLI_REPS):
                lines += check_norm(torch, K, size, C, dt, b, False, S=S)
            lines += check_norm_bwd(torch, K, size, C, dt, B, "silu",
                                    DROPOUT_P, False, S=S)
        for S, cin, cout in mm:  # rows of S voxels: the slab flattened
            lines += check_mm1x1(torch, K, S, cin, cout, dt, B, False, nd=1)
        for ln in lines:
            name = ln["kernel"].split(" ")[0]  # the dx pass is mm1x1_fwd
            w = worst.setdefault(name, {"sites": 0, "rel_err": -1.0})
            w["sites"] += 1
            if ln["rel_err"] > w["rel_err"]:
                w.update(rel_err=ln["rel_err"], shape=ln["shape"],
                         max_abs_err=ln["max_abs_err"], tol=ln["tol"])
    dist.barrier()
    emit({"phase": "twod_sharded", "what": "slab sites checked",
          "model": TWOD_VDM, "size": TWOD_SIZE, "norm_sites": norm,
          "mm1x1_sites": mm, "worst": worst,
          "seconds": time.perf_counter() - t0})
    fail_unless(len(norm) > 0 and len(mm) > 0 and all(
        S == TWOD_SIZE ** 2 // ctx.size for S, _ in norm[-1:]),
        "no 2D slab sites recorded", {"sites": sorted(sites)})
    return worst


def twod_sharded_rank(rank, world):
    """One rank of the twod_sharded phase (a process of its own on
    cuda:0): the parity checks, ``train_uc_c`` through ``run_sharded_cli``
    at global batch TWOD_SHARDED_BATCH, and one bare step with the
    collectives' counters. Returns its lines and exit codes."""
    global _SINK
    _SINK = []
    import torch

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.ops import kernels as K
    from vdm4cdm_torch.parallel import make_mesh, make_shard_ctx

    ctx = make_shard_ctx(make_mesh(1, world))
    parts, t0 = {}, time.perf_counter()
    for name, family, seed in ((TWOD_VDM, "vdm", 91), (TWOD_SFM, "sfm", 93)):
        twod_sharded_parity(torch, vt, K, ctx, name, family, seed)
    parts["parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = twod_sharded_sites(torch, vt, K, ctx, rank)
    parts["sites"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line = run_sharded_cli(torch, vt, K, ctx, rank, TWOD_SHARDED_OUT,
                           "twod_sharded", TWOD_VDM,
                           ["data.kind=grf", "model.remat=False",
                            f"data.batch_size={TWOD_SHARDED_BATCH}"])
    parts["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["comm_per_step"] = twod_sharded_step(torch, vt, K, ctx)
    parts["bare_step"] = time.perf_counter() - t0
    line["seconds_by_part"] = parts
    emit(line)
    return {"lines": _SINK, "rcs": line["rcs"], "checked": checked}


def phase_twod_sharded(torch, vt, kernels):
    """2D models under ``sp`` sharding at full width (chs 48..384, f32): two
    ranks on cuda:0 over gloo (as ``sharded``) check ``train_uc_c`` (VDM)
    and ``trainSFM_c_uc`` (SFM, the gathered bottleneck attention) split
    along H against unsharded at 64^2, then run ``cli.train --preset
    train_uc_c --set parallel.n_sp=2`` at 256^2 (global batch
    TWOD_SHARDED_BATCH, GRF, dropout 0.1) and ``cli.generate`` as the
    ``sharded_cli`` phase runs the flagship (``run_sharded_cli``). Before
    the ranks, in this process, ``parallel/dryrun.py``'s ``entry()`` once on
    the card. Fails unless the parity holds and ``check_sharded_cli``
    passes with every norm and 1x1 kernel launched and no conv3d kernel.
    Adds the launches to the ``kernels`` line as
    ``launches_twod_sharded``."""
    import shutil

    from vdm4cdm_torch.parallel.dryrun import entry
    from vdm4cdm_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    fn, args = entry()
    y = fn(*args)
    torch.cuda.synchronize()
    line = {"phase": "twod_sharded", "what": "entry", "shape": list(y.shape),
            "dtype": str(y.dtype).removeprefix("torch."),
            "finite": bool(torch.isfinite(y).all()),
            "seconds": time.perf_counter() - t0}
    fail_unless(line["finite"] and tuple(y.shape) == tuple(args[0].shape),
                "entry() did not give a finite forward on the card", line)
    emit(line)
    del fn, args, y

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    shutil.rmtree(TWOD_SHARDED_OUT, ignore_errors=True)
    store = OUT_DIR / "twod_sharded_store"
    store.mkdir(exist_ok=True)
    ranks = spawn_ranks(twod_sharded_rank, SHARDED_RANKS,
                        store_dir=str(store), timeout=SHARDED_TIMEOUT)
    counts = check_sharded_cli(
        torch, ranks, TWOD_SHARDED_OUT, "twod_sharded", TWOD_VDM,
        {"size": TWOD_SIZE, "global_batch": TWOD_SHARDED_BATCH,
         "dtype": "float32", "comm_per_step": [
             o["lines"][-1]["comm_per_step"] for o in ranks],
         "seconds": time.perf_counter() - t0},
        (12, 1, TWOD_SIZE, TWOD_SIZE), TWOD_KERNELS, CONV3D_KERNELS)
    # every norm launch of a sharded run is the CP form: the CP rows too;
    # the slab checks go to the CP and 1x1 rows
    checked = ranks[0]["checked"]
    fail_unless(set(checked) == set(TWOD_KERNELS),
                "a 2D slab kernel went unchecked", {"checked": checked})
    for name in META:
        row = kernels.setdefault(name, {})
        row["launches_twod_sharded"] = counts[name.removesuffix("_cp")]
        if name in CP_ROWS or name.startswith("mm1x1"):
            row["twod_sharded_checked"] = checked[name.removesuffix("_cp")]


# ------------------------------------------------------ precision (extra)

def phase_precision(torch, vt, K):
    """The trained model's f32 path with the process at PyTorch's default
    TF32 setting (on for cuDNN convolutions, as in a user's process):
    eps_hat on the card against the CPU path, and the library convs'
    device ms (and their kernels' names) over a forward at the sampler's
    batch and over a train step. Run with ``--port DIR`` for an earlier
    commit's port in the same call (before/after)."""
    import os

    from vdm4cdm_torch.cli._common import read_registry
    from vdm4cdm_torch.train.checkpoint import load_params

    os.chdir(ROOT)
    entry = read_registry("configs/models_torch.yaml")[BLESSED]
    cfg = vt.preset(entry["preset"])
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev] = vt.build_model(cfg, device=dev).eval()
            load_params(entry["ckpt_dir"], models[dev],
                        step=entry["ckpt_step"])
        batch = next(iter(vt.build_datamodule(cfg, stage="test")
                          .test_dataloader()))
        s = torch.from_numpy(batch["conditioning"])
        v = torch.from_numpy(batch["conditioning_values"][0])
        z = torch.randn(s.shape, generator=torch.Generator().manual_seed(61))
        t = torch.linspace(0.05, 0.95, s.shape[0])
        with torch.inference_mode():
            got = models["cuda"].eps_hat(z.cuda(), t.cuda(), s.cuda(),
                                         [v.cuda()]).cpu()
            ref = models["cpu"].eps_hat(z, t, s, [v])
        abs_err, err = rel_err(got, ref)
        vdm = models["cuda"]
        sc, vc = s.cuda(), v.cuda()
        fwd = phase_profile(
            torch, lambda zz, tt: vdm.eps_hat(zz, tt, sc, [vc]),
            tag="precision_forward", shape=tuple(s.shape[:-1]) + (1,))
        model = vt.build_model(cfg, device="cuda")
        load_params(entry["ckpt_dir"], model, step=entry["ckpt_step"])
        tbatch = loss_batch(torch, cfg.data.cropsize, BLESSED_TRAIN_BATCH,
                            "cuda", 62)
        _, trainer = timed_train_steps(
            torch, vt, K, model, tbatch, 1, 63, lr=cfg.run.learning_rate,
            moment=None, ema_decay=cfg.run.ema_decay)
        train = phase_profile_train(torch, *trainer, tag="precision_train")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "precision", "model": BLESSED, "process_tf32": True,
          "eps_hat_max_abs_err": abs_err, "eps_hat_rel_err": err,
          "max_abs_ref": ref.abs().max().item(),
          "library_conv_forward_ms": fwd["by_category_ms"].get(LIBRARY_3D),
          "library_conv_train_step_ms": train["by_category_ms"].get(
              LIBRARY_3D),
          "forward_library_kernels_ms": fwd["library_kernels_ms"],
          "train_library_kernels_ms": train["library_kernels_ms"]})


# ----------------------------------------------------------- sharded phase

def zhalo_cases():
    """(slab planes, size, cin, cout, modes x dtypes) of the z-halo kernels
    at a rank's shapes of the flagship split over two ranks: the conv sites
    of ``conv_cases`` with half the planes. The main path runs bf16 in both
    padding modes (the VDM circular, the SFM zeros); the flagship's first
    and deepest sites and the channel tails get f32 too."""
    full = [(m, d) for m in ("circular", "zeros")
            for d in ("bfloat16", "float32")]
    bf16 = [("circular", "bfloat16"), ("zeros", "bfloat16")]
    return [(size // SHARDED_RANKS, size, cin, cout,
             full if (size, cin, cout) in ((128, 32, 32), (16, 256, 256),
                                           (16, 48, 96)) else bf16)
            for size, cin, cout, _ in conv_cases()]


def check_zhalo(torch, K, local, size, cin, cout, mode, dtype_name, batch,
                timed):
    """The three z-halo kernels on a haloed slab (batch, local + 2, size,
    size, cin) against their plain versions: the forward with bias, residual
    and sums, dx, and dw + db. Returns their lines by kernel name."""
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(
        local * 1000 + cin * 3 + cout)
    plane = (size, size)
    xh = torch.randn(batch, local + 2, *plane, cin, generator=gen,
                     device="cuda").to(dtype)
    w = torch.randn(3, 3, 3, cin, cout, generator=gen, device="cuda")
    w = w / math.sqrt(27 * cin)
    bias = 0.3 * torch.randn(cout, generator=gen, device="cuda")
    res = torch.randn(batch, local, *plane, cout, generator=gen,
                      device="cuda").to(dtype)
    ct = torch.randn(batch, local, *plane, cout, generator=gen,
                     device="cuda").to(dtype)
    circ = mode == "circular"
    with torch.no_grad():
        y, s = K.conv3d_k3s1_zhalo_fwd(xh, w, bias, res, circ, True)
        yr, sr = K.conv3d_k3s1_zhalo_plain(xh, w, bias, res, circ, True)
        dx = K.conv3d_k3s1_zhalo_dx(ct, w, circ)
        dxr = K.conv3d_k3s1_zhalo_dx_plain(ct, w, circ)
        dw, db = K.conv3d_k3s1_zhalo_dw(xh, ct, circ)
        dwr, dbr = K.conv3d_k3s1_zhalo_dw_plain(xh, ct, circ)
        torch.cuda.synchronize()
    shape = [batch, local + 2, size, size, cin, cout]
    base = {"phase": "kernel", "shape": shape, "mode": mode,
            "dtype": dtype_name}
    tol, s_tol = TOL[("conv", dtype_name)], TOL[("sums", dtype_name)]
    dw_tol = TOL[("dw", dtype_name)]
    lines = {}
    abs_err, err = rel_err(y, yr)
    _, s_err = rel_err(s / sr.abs().max(), sr / sr.abs().max())
    lines["conv3d_k3s1_zhalo_fwd"] = dict(
        base, kernel="conv3d_k3s1_zhalo_fwd", max_abs_err=abs_err,
        rel_err=err, tol=tol, sums_rel_err=s_err, sums_tol=s_tol)
    fail_unless(err <= tol and s_err <= s_tol,
                "conv3d_k3s1_zhalo_fwd disagrees",
                lines["conv3d_k3s1_zhalo_fwd"])
    abs_err, err = rel_err(dx, dxr)
    lines["conv3d_k3s1_zhalo_dx"] = dict(
        base, kernel="conv3d_k3s1_zhalo_dx", max_abs_err=abs_err,
        rel_err=err, tol=tol)
    fail_unless(err <= tol, "conv3d_k3s1_zhalo_dx disagrees",
                lines["conv3d_k3s1_zhalo_dx"])

    def scaled(got, ref):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    lines["conv3d_k3s1_zhalo_dw"] = dict(
        base, kernel="conv3d_k3s1_zhalo_dw",
        max_abs_err=(dw - dwr).abs().max().item(), rel_err=scaled(dw, dwr),
        db_rel_err=scaled(db, dbr), tol=dw_tol)
    fail_unless(max(scaled(dw, dwr), scaled(db, dbr)) <= dw_tol,
                "conv3d_k3s1_zhalo_dw disagrees",
                lines["conv3d_k3s1_zhalo_dw"])
    if timed:
        n = max(3, min(30, int(1e7 // (batch * local * size ** 2))))
        elt = xh.element_size()
        vin, vout = batch * (local + 2) * size ** 2, batch * local * size ** 2
        flops = 2.0 * 27 * cin * cout * vout
        wbytes = 27 * cin * cout * elt
        pad = (1, 1, 1, 1, 0, 0)
        xc = xh.permute(0, 4, 1, 2, 3)
        xp = channels_last(F.pad(xc, pad, mode="circular") if circ
                           else F.pad(xc, pad))
        wc = channels_last(w.to(dtype).permute(4, 3, 0, 1, 2))
        ctc = ct.permute(0, 4, 1, 2, 3)
        ctp = F.pad(ctc, pad[:4] + (2, 2))
        if circ:
            ctp = F.pad(F.pad(ctc, (0, 0, 0, 0, 2, 2)), pad, mode="circular")
        ctp = channels_last(ctp)
        wtc = channels_last(w.to(dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2))
        biasc = bias.to(dtype)
        timings = {
            "conv3d_k3s1_zhalo_fwd": (
                lambda: K.conv3d_k3s1_zhalo_fwd(xh, w, bias, res, circ, True),
                lambda: K.conv3d_k3s1_zhalo_plain(xh, w, bias, res, circ,
                                                  True),
                lambda: F.conv3d(xp, wc, biasc),
                LIB_CONV + ", valid in z on the in-plane padded slab",
                (vin * cin + 2 * vout * cout) * elt + wbytes),
            "conv3d_k3s1_zhalo_dx": (
                lambda: K.conv3d_k3s1_zhalo_dx(ct, w, circ),
                lambda: K.conv3d_k3s1_zhalo_dx_plain(ct, w, circ),
                lambda: F.conv3d(ctp, wtc),
                LIB_CONV + ", on ct padded by 2 zero planes in z, flipped "
                "transposed weights",
                (vout * cout + vin * cin) * elt + wbytes),
            "conv3d_k3s1_zhalo_dw": (
                lambda: K.conv3d_k3s1_zhalo_dw(xh, ct, circ),
                lambda: K.conv3d_k3s1_zhalo_dw_plain(xh, ct, circ),
                lambda: conv_weight_grad(xp, ctc, wc, 0),
                LIB_WGRAD + ", on the in-plane padded slab",
                (vin * cin + vout * cout) * elt + (27 * cin * cout + cout)
                * 4),
        }
        for name, (kern, plain, lib, lib_call, nbytes) in timings.items():
            b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
            lines[name].update(
                ms=cuda_time_ms(kern, n), plain_ms=cuda_time_ms(plain, 2, 1),
                library_ms=library_time_ms(lib, n), library_call=lib_call,
                bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
    for line in lines.values():
        emit(line)
    return lines


def sharded_checks(torch, vt, K, ctx):
    """The sharded port against the unsharded one on the card, at 32^3 f32:
    eps_hat, the loss and every gradient of one step (dropout 0), two real
    train steps (for the parameters' digest), the SFM's Heun sampler.
    Returns the digest."""
    from vdm4cdm_torch.parallel import local_slab, make_sharded_sfm_sampler
    from vdm4cdm_torch.train.checkpoint import params_digest

    size = PARITY_SIZE
    t0 = time.perf_counter()
    z = torch.randn(2, size, size, size, 1,
                    generator=torch.Generator().manual_seed(3)).cuda()
    s, v = conditioning(torch, size, 2, "cuda", 2)
    t = torch.tensor([0.3, 0.8], device="cuda")
    ref_m = build_vdm(vt, size, "float32", "cuda", 1)
    sh_m = build_vdm(vt, size, "float32", "cuda", 1, ctx)
    with torch.inference_mode():
        want = local_slab(ref_m.eps_hat(z, t, s, [v]), ctx)
        got = sh_m.eps_hat(local_slab(z, ctx), t, local_slab(s, ctx), [v])
        torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    line = {"phase": "sharded", "what": "eps_hat", "model": VDM_PRESET,
            "size": size, "dtype": "float32", "slab": list(got.shape),
            "max_abs_ref": want.abs().max().item(), "max_abs_err": abs_err,
            "rel_err": err, "tol": SHARDED_TOL,
            "seconds": time.perf_counter() - t0}
    fail_unless(bool(torch.isfinite(got).all()) and err <= SHARDED_TOL
                and line["max_abs_ref"] > 0.1, "sharded eps_hat", line)
    emit(line)

    # the loss and every gradient of one step, averaged over the mesh
    t0 = time.perf_counter()
    over = {"model.dropout_prob": 0.0}
    ref_m = build_vdm(vt, size, "float32", "cuda", 1, **over)
    sh_m = build_vdm(vt, size, "float32", "cuda", 1, ctx, **over)
    batch = loss_batch(torch, size, 2, "cuda", 8)
    eps = torch.randn(2, size, size, size, 1,
                      generator=torch.Generator().manual_seed(7)).cuda()
    tt = torch.tensor([0.35, 0.85], device="cuda")
    ref_l = ref_m.loss(batch, train=True, t=tt, eps=eps)
    ref_l.loss.backward()
    local = {"x": local_slab(batch["x"], ctx),
             "conditioning": local_slab(batch["conditioning"], ctx),
             "conditioning_values": batch["conditioning_values"]}
    sh_l = sh_m.loss(local, train=True, t=tt, eps=local_slab(eps, ctx))
    sh_l.loss.backward()
    errs, top, worst, loss_err = sharded_grad_parity(torch, ref_m, sh_m,
                                                     ref_l, sh_l, ctx)
    line = {"phase": "sharded", "what": "loss and gradients of one step",
            "model": VDM_PRESET, "size": size, "batch": 2,
            "dtype": "float32", "dropout": 0.0, "n_params": len(errs),
            "loss": ref_l.loss.item(), "loss_rel_err": loss_err,
            "rel_err": errs[worst], "worst_param": worst,
            "max_abs_grad": top, "tol": GRADS_TOL,
            "seconds": time.perf_counter() - t0}
    fail_unless(errs[worst] <= GRADS_TOL and loss_err <= 1e-4 and top > 1e-3,
                "sharded gradients", line)
    emit(line)

    # two real sharded steps (dropout 0.1): the digest goes to the parent
    t0 = time.perf_counter()
    sh_m = build_vdm(vt, size, "float32", "cuda", 1, ctx)
    opt = vt.make_optimizer(learning_rate=3e-4, grad_clip=0.5)
    state = vt.TrainState(0, sh_m, opt.init(sh_m), vt.init_ema(sh_m))
    step = vt.make_train_step(sh_m, opt, ema_decay=EMA_DECAY)
    gen = torch.Generator(device="cuda").manual_seed(21)
    for _ in range(2):
        state, metrics = step(state, local, gen)
    digest = params_digest(state)
    emit({"phase": "sharded", "what": "two train steps", "size": size,
          "dropout": DROPOUT_P, "loss": metrics["loss"].item(),
          "grad_norm": metrics["grad_norm"].item(), "params_sha256": digest,
          "seconds": time.perf_counter() - t0})

    # the SFM's deterministic Heun sampler: the end-to-end halo test
    t0 = time.perf_counter()
    ref_s = build_sfm(vt, size, "float32", "cuda", 12)
    sh_s = build_sfm(vt, size, "float32", "cuda", 12, ctx)
    sb = sfm_batch(torch, size, 1, "cuda", 13)
    x0, vs = sb["x0"], sb["conditioning_values"]
    want = ref_s.draw_samples(x0, SFM_SHARDED_STEPS, vs, method="heun")
    got = make_sharded_sfm_sampler(sh_s, SFM_SHARDED_STEPS)(x0, vs)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    line = {"phase": "sharded", "what": "sfm heun sampler",
            "model": SFM_PRESET, "size": size, "dtype": "float32",
            "steps": SFM_SHARDED_STEPS, "padding": sh_s.unet.conv_padding_mode,
            "max_abs_err": abs_err, "rel_err": err, "tol": SHARDED_TOL,
            "moved": (want - x0).abs().max().item(),
            "seconds": time.perf_counter() - t0}
    fail_unless(err <= SHARDED_TOL and line["moved"] > 1e-2
                and tuple(got.shape) == tuple(x0.shape), "sharded sampler",
                line)
    emit(line)
    return digest


def sharded_timing(torch, vt, K, ctx):
    """The flagship's sharded train steps and sampler steps at 128^3 on this
    rank (both ranks run them together on the card)."""
    from vdm4cdm_torch.parallel import local_slab, make_sharded_vdm_sampler

    size = MAIN_SIZE
    torch.cuda.empty_cache()
    held = resident_gib(torch)
    vdm = build_vdm(vt, size, "bfloat16", "cuda", 9, ctx)
    g = loss_batch(torch, size, TRAIN_BATCH, "cuda", 10)
    batch = {"x": local_slab(g["x"], ctx),
             "conditioning": local_slab(g["conditioning"], ctx),
             "conditioning_values": g["conditioning_values"]}
    facts, (state, step, _, gen) = timed_train_steps(
        torch, vt, K, vdm, batch, TRAIN_STEPS, 11, SHARDED_KERNELS, ctx)
    synced = synced_step(torch, step, state, batch, gen, ctx)
    emit({"phase": "sharded", "what": "train", "preset": VDM_PRESET,
          "size": size, "global_batch": TRAIN_BATCH,
          "slab": list(batch["x"].shape), "n_sp": ctx.size,
          "padding": vdm.score_model.conv_padding_mode,
          "held_before_gib": held, **facts, "synced_step": synced,
          "note": "two ranks share one card over gloo; halo planes go "
                  "through pinned host memory: no multi-card figure"})

    sampler = vdm.eval()
    s, v = conditioning(torch, size, 1, "cuda", 5)
    warm = make_sharded_vdm_sampler(sampler, 1, 1)
    warm(torch.Generator(device="cuda").manual_seed(0), s, [v])
    run = make_sharded_vdm_sampler(sampler, 1, MAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ctx.stats.reset()
    t0 = time.perf_counter()
    out = run(torch.Generator(device="cuda").manual_seed(6), s, [v])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    line = {"phase": "sharded", "what": "draw_samples", "preset": VDM_PRESET,
            "size": size, "batch": 1, "dtype": "bfloat16",
            "steps": MAIN_STEPS, "seconds": dt, "s_per_step": dt / MAIN_STEPS,
            "s_per_field_250": dt / MAIN_STEPS * FIELD_STEPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches_per_forward": {k: c / MAIN_STEPS
                                     for k, c in counts.items()},
            "comm": ctx.stats.as_dict(), "out_shape": list(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "out_std": out.float().std().item()}
    fail_unless(line["finite"] and tuple(out.shape) == (1, size, size, size, 1)
                and min(counts[k] for k in SHARDED_FORWARD_KERNELS) > 0,
                "sharded sampler output is not a finite field through the "
                "kernels", line)
    emit(line)
    return facts["launches"]


def sharded_rank(rank, world):
    """One rank of the sharded phase (a process of its own on cuda:0): its
    lines, the parameters' digest and the launches of its timed steps."""
    global _SINK
    _SINK = []
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.ops import kernels as K
    from vdm4cdm_torch.parallel import make_mesh, make_shard_ctx

    ctx = make_shard_ctx(make_mesh(1, world))
    t0 = time.perf_counter()
    heads = {}
    for local, size, cin, cout, combos in zhalo_cases():
        for mode, dtype_name in combos:
            check_zhalo(torch, K, local, size, cin, cout, mode, dtype_name,
                        TRAIN_BATCH, False)
    emit({"phase": "sharded", "what": "z-halo kernel checks",
          "seconds": time.perf_counter() - t0})
    # rank 0 times the kernels at its slab shapes while the others wait
    dist.barrier()
    if rank == 0:
        local, size = MAIN_SIZE // world, MAIN_SIZE
        heads.update(check_zhalo(torch, K, local, size, 32, 32, "circular",
                                 "bfloat16", TRAIN_BATCH, True))
        S = local * size * size
        fwd = check_norm(torch, K, size, 32, "bfloat16", TRAIN_BATCH, True,
                         S=S)
        bwd = check_norm_bwd(torch, K, size, 32, "bfloat16", TRAIN_BATCH,
                             "silu", DROPOUT_P, True, S=S)
        for name, line in zip(("gn_sums", "gn_apply", "gn_bwd_sums",
                               "gn_bwd_apply"), fwd + bwd):
            heads[name + "_cp"] = line
    dist.barrier()
    digest = sharded_checks(torch, vt, K, ctx)
    launches = sharded_timing(torch, vt, K, ctx)
    return {"lines": _SINK, "digest": digest, "heads": heads,
            "launches": launches}


def phase_sharded(torch, kernels):
    """Spawn the sharded phase's ranks on cuda:0, print their lines, check
    the parameters' digests across ranks, and add the z-halo and CP rows to
    the ``kernels`` line."""
    from vdm4cdm_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    store = OUT_DIR / "sharded_store"
    store.mkdir(exist_ok=True)
    ranks = spawn_ranks(sharded_rank, SHARDED_RANKS, store_dir=str(store),
                        timeout=SHARDED_TIMEOUT)
    for r, out in enumerate(ranks):
        for line in out["lines"]:
            emit({**line, "rank": r})
    digests = [out["digest"] for out in ranks]
    line = {"phase": "sharded", "what": "parameters equal across ranks",
            "params_sha256": digests, "equal": len(set(digests)) == 1,
            "seconds": time.perf_counter() - t0}
    fail_unless(line["equal"], "ranks' parameters differ", line)
    emit(line)
    for name, row in ranks[0]["heads"].items():
        kernels[name] = row
    for name in kernels:
        base = name[:-3] if name.endswith("_cp") else name
        kernels[name]["launches_sharded"] = ranks[0]["launches"].get(base)
    for name in ZHALO_KERNELS + CP_ROWS:
        kernels[name]["launches"] = kernels[name]["launches_sharded"]


# the sharded_cli phase: the flagship through cli.train on two sp ranks
# sharing cuda:0 over gloo, STEPS steps with a checkpoint every CKPT, resumed
# to RESUME; then cli.generate of its first CV_12_12 box, REPS fields a
# sampler call, GEN_STEPS sampler steps; its directory (checkpoints of the
# flagship: under runs/, which git ignores) is deleted after the checks
SHARDED_CLI_STEPS, SHARDED_CLI_CKPT, SHARDED_CLI_RESUME = 3, 2, 4
SHARDED_CLI_REPS, SHARDED_CLI_GEN_STEPS = 2, 5
SHARDED_CLI_OUT = ROOT / "runs" / "chip_smoke_sharded_cli"


def run_sharded_cli(torch, vt, K, ctx, rank, out, tag, preset, overrides):
    """In a rank of a sharded CLI phase (a process of its own on cuda:0):
    ``cli.train --preset PRESET --set OVERRIDES parallel.n_sp=...`` to
    SHARDED_CLI_STEPS (a checkpoint every SHARDED_CLI_CKPT), resumed to
    SHARDED_CLI_RESUME, ``cli.generate`` of one CV_12_12 box
    (SHARDED_CLI_REPS fields a call, SHARDED_CLI_GEN_STEPS steps), then one
    timed call of the sharded sampler from the last checkpoint, as
    ``cli.generate`` builds it (the same shapes: no warm-up). The run goes
    to ``out``, the CLI's output to ``chiprun_out/<tag>_rank<r>.log``.
    Returns the rank's line: exit codes, seconds, peak memory, the
    sampler's times and collectives a step, the digest lines, launches."""
    from vdm4cdm_torch.cli import generate, train
    from vdm4cdm_torch.cli._common import apply_overrides, parse_overrides
    from vdm4cdm_torch.parallel import make_sharded_vdm_sampler
    from vdm4cdm_torch.train.checkpoint import load_params

    log = OUT_DIR / f"{tag}_rank{rank}.log"
    log.write_text("")
    overrides = [*overrides, f"parallel.n_sp={ctx.size}",
                 f"run.ckpt_every_steps={SHARDED_CLI_CKPT}",
                 "run.log_every_steps=1", f"run.out_dir={out}"]
    common = ["--device", "cuda:0", "--dist-backend", "gloo"]
    argv = ["--preset", preset, *common, "--set", *overrides]
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rcs = [run_logged(train.main, argv + [f"run.max_steps={n}"], log)[0]
           for n in (SHARDED_CLI_STEPS, SHARDED_CLI_RESUME)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_counts = K.launch_counts()

    ckpt_dir = out / preset / "checkpoints"
    gen_dir = out / "samples"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rcs.append(run_logged(generate.main, [
        preset, str(gen_dir), "CV_12_12", "--ckpt-dir", str(ckpt_dir),
        "--boxes", "1", "--reps-per-batch", str(SHARDED_CLI_REPS),
        "--n-sampling-steps", str(SHARDED_CLI_GEN_STEPS), *common, "--set",
        *overrides], log)[0])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = K.launch_counts()

    cfg = vt.preset(preset)
    apply_overrides(cfg, parse_overrides(overrides))
    model = vt.build_model(cfg, device="cuda", ctx=ctx)
    load_params(str(ckpt_dir), model)
    model.eval()
    box = next(iter(vt.build_datamodule(cfg, "test").test_dataloader()))

    def reps(a):
        return torch.from_numpy(np.repeat(a[:1], SHARDED_CLI_REPS, 0)).cuda()

    s = None if box.get("conditioning") is None else reps(box["conditioning"])
    v = ([reps(a) for a in box["conditioning_values"]]
         if cfg.data.conditioning_values else [])
    sample = make_sharded_vdm_sampler(model, SHARDED_CLI_REPS,
                                      SHARDED_CLI_GEN_STEPS)
    ctx.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = sample(torch.Generator(device="cuda").manual_seed(1), s, v)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    comm = ctx.stats.as_dict()
    del model

    with open(log) as fh:
        agree = [ln.strip() for ln in fh if "ranks' parameters are equal" in ln]
    return {"phase": tag, "what": "rank", "rcs": rcs,
            "train_seconds": train_s, "train_peak_gib": train_peak,
            "generate_seconds": gen_s, "generate_peak_gib": gen_peak,
            "sampler_call_s": call_s,
            "sampler_s_per_step": call_s / SHARDED_CLI_GEN_STEPS,
            "sampler_s_per_field_250": call_s / SHARDED_CLI_REPS
            * FIELD_STEPS / SHARDED_CLI_GEN_STEPS,
            "sampler_comm_per_step": {
                k: val / SHARDED_CLI_GEN_STEPS for k, val in comm.items()
                if k != "sync"},
            "sampler_finite": bool(torch.isfinite(field).all()),
            "digest_lines": agree, "launches_train": train_counts,
            "launches": counts}


def check_sharded_cli(torch, ranks, out, tag, preset, facts, field_shape,
                      launched, not_launched=()):
    """In the parent of a sharded CLI phase: print the ranks' lines, read
    rank 0's ``metrics.csv`` (copied to ``chiprun_out/<tag>_metrics.csv``),
    checkpoints and campaign file, emit the phase's line (``facts`` added)
    and fail unless every rank's CLI exited 0, the losses and fields are
    finite, the checkpoints and the digests agreeing at each are there, the
    file has ``field_shape``, every kernel of ``launched`` ran and none of
    ``not_launched``. Deletes the run's directory; returns rank 0's
    launches."""
    import shutil

    for r, o in enumerate(ranks):
        for ln in o["lines"]:
            emit({**ln, "rank": r})
    run_dir = out / preset
    rows = read_metrics(run_dir / "metrics.csv")
    shutil.copy(run_dir / "metrics.csv", OUT_DIR / f"{tag}_metrics.csv")
    steps = {int(r["step"]): r for r in rows if r.get("step_s") not in
             (None, "")}
    losses = [float(steps[k]["loss"]) for k in sorted(steps)]
    ckpts = sorted(int(n.name) for n in (run_dir / "checkpoints").iterdir()
                   if n.name.isdigit())
    field = np.load(out / "samples" / "gen_0.npy")
    rank_lines = [o["lines"][-1] for o in ranks]
    agree = rank_lines[0]["digest_lines"]
    counts = rank_lines[0]["launches"]
    line = {"phase": tag, "card": card_line(), "preset": preset, **facts,
            "n_sp": len(ranks), "backend": "gloo (two ranks, one card)",
            "steps": sorted(steps), "losses": losses,
            "s_per_step_median_2_4": statistics.median(
                float(steps[k]["step_s"]) for k in (2, 3, 4)),
            "feed_wait_s": [float(steps[k]["feed_wait_s"]) for k in (2, 3, 4)],
            "peak_gib_per_rank": [max(ln["train_peak_gib"],
                                      ln["generate_peak_gib"])
                                  for ln in rank_lines],
            "sampler_s_per_field_250": [ln["sampler_s_per_field_250"]
                                        for ln in rank_lines],
            "checkpoints": ckpts, "digest_lines": agree,
            "file": {"shape": list(field.shape), "dtype": str(field.dtype),
                     "finite": bool(np.isfinite(field).all()),
                     "std": float(field.std())},
            "launches": counts,
            "note": "two ranks share one card over gloo; halo planes go "
                    "through pinned host memory: no multi-card figure"}
    emit(line)
    fail_unless(
        all(o["rcs"] == [0, 0, 0] for o in ranks)
        and sorted(steps) == list(range(1, SHARDED_CLI_RESUME + 1))
        and all(map(math.isfinite, losses))
        and ckpts == [SHARDED_CLI_CKPT, SHARDED_CLI_STEPS, SHARDED_CLI_RESUME]
        and len(agree) == 3 and f"step {SHARDED_CLI_RESUME}:" in agree[-1]
        and line["file"]["shape"] == list(field_shape)
        and line["file"]["finite"]
        and all(ln["sampler_finite"] for ln in rank_lines)
        and min(counts[k] for k in launched) > 0
        and max((counts[k] for k in not_launched), default=0) == 0,
        f"the {tag} phase failed", line)
    shutil.rmtree(out)
    return counts


def sharded_cli_rank(rank, world):
    """One rank of the sharded_cli phase (a process of its own on cuda:0):
    the flagship through ``run_sharded_cli``. Returns its lines, launches
    and exit codes."""
    global _SINK
    _SINK = []
    import torch

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.ops import kernels as K
    from vdm4cdm_torch.parallel import make_mesh, make_shard_ctx

    ctx = make_shard_ctx(make_mesh(1, world))
    line = run_sharded_cli(torch, vt, K, ctx, rank, SHARDED_CLI_OUT,
                           "sharded_cli", VDM_PRESET,
                           ["data.kind=grf", "model.remat=False"])
    emit(line)
    return {"lines": _SINK, "rcs": line["rcs"]}


def phase_sharded_cli(torch, kernels):
    """The sharded CLI at the flagship's full width (128^3, b2, chs
    32..256, bf16, dropout 0.1, GRF, remat off) on two ``sp`` ranks that
    share cuda:0 over gloo: ``cli.train`` with ``parallel.n_sp=2`` for
    SHARDED_CLI_STEPS steps (a checkpoint at SHARDED_CLI_CKPT), resumed to
    SHARDED_CLI_RESUME, then ``cli.generate`` of one CV_12_12 box (12 fields,
    SHARDED_CLI_REPS a sampler call, SHARDED_CLI_GEN_STEPS steps). Fails
    unless every rank's CLI exits 0, the losses and fields are finite, the
    ranks' parameter digests agree at every checkpoint (the trainer compares
    them and raises otherwise; the resumed run's last one is read here), rank
    0 wrote the checkpoints, ``metrics.csv`` and the campaign's file, and
    every z-halo and CP kernel launched. Adds their launches to the
    ``kernels`` line as ``launches_sharded_cli``."""
    import shutil

    from vdm4cdm_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks need the card's memory
    shutil.rmtree(SHARDED_CLI_OUT, ignore_errors=True)
    store = OUT_DIR / "sharded_cli_store"
    store.mkdir(exist_ok=True)
    ranks = spawn_ranks(sharded_cli_rank, SHARDED_RANKS, store_dir=str(store),
                        timeout=SHARDED_TIMEOUT)
    counts = check_sharded_cli(
        torch, ranks, SHARDED_CLI_OUT, "sharded_cli", VDM_PRESET,
        {"size": MAIN_SIZE, "global_batch": TRAIN_BATCH, "dtype": "bfloat16",
         "seconds": time.perf_counter() - t0},
        (12, 1) + (MAIN_SIZE,) * 3,
        ZHALO_KERNELS + tuple(k.removesuffix("_cp") for k in CP_ROWS))
    for name in ZHALO_KERNELS + CP_ROWS:
        kernels.setdefault(name, {})["launches_sharded_cli"] = counts[
            name.removesuffix("_cp")]


UNSHARDED_KERNELS = ("conv3d_k3s1_fwd", "conv3d_k3s1_dw", "gn_sums",
                     "gn_apply", "gn_bwd_sums", "gn_bwd_apply", "mm1x1_fwd",
                     "mm1x1_dw")
ZHALO_KERNELS = ("conv3d_k3s1_zhalo_fwd", "conv3d_k3s1_zhalo_dx",
                 "conv3d_k3s1_zhalo_dw")
CP_ROWS = ("gn_sums_cp", "gn_apply_cp", "gn_bwd_sums_cp", "gn_bwd_apply_cp")
CONV3D_KERNELS = UNSHARDED_KERNELS[:2] + ZHALO_KERNELS
SHARDED_KERNELS = ZHALO_KERNELS + UNSHARDED_KERNELS[2:]
SHARDED_FORWARD_KERNELS = ("conv3d_k3s1_zhalo_fwd", "gn_sums", "gn_apply",
                           "mm1x1_fwd")


FORWARD_KERNELS = ("conv3d_k3s1_fwd", "gn_sums", "gn_apply", "mm1x1_fwd")
_TRITON = {"sums_kernel": "gn_sums", "apply_kernel": "gn_apply",
           "bwd_sums_kernel": "gn_bwd_sums",
           "bwd_apply_kernel": "gn_bwd_apply"}


LIBRARY_3D = "library conv (conv_in, downsample, conv_out)"
# the 2D models' category of the same kernels: every 3x3 conv of a 2D model
# is cuDNN's (the JAX package leaves 2D convs to XLA)
LIBRARY_2D = "cuDNN conv (every 2D conv: fwd, dgrad, wgrad)"


def _category(name: str, library: str = LIBRARY_3D) -> str:
    # conv3d_k3s1_{bf16,f32}_kernel and conv3d_dw_{bf16,f32}_kernel
    if "conv3d_k3s1_" in name and "_kernel" in name:
        return "conv3d_k3s1_fwd (forward and dx)"
    if "conv3d_dw_" in name and "_kernel" in name:
        return "conv3d_k3s1_dw"
    # mm1x1_fwd_{tc,f32}_kernel (persistent, bf16 / f32) and
    # mm1x1_fwd_kernel; mm1x1_dw_kernel (bf16) and mm1x1_dw_f32_kernel
    if "mm1x1_fwd" in name and "_kernel" in name:
        return "mm1x1_fwd (forward and dx)"
    if "mm1x1_dw" in name and "_kernel" in name:
        return "mm1x1_dw"
    if name in _TRITON:
        return _TRITON[name]
    if any(k in name for k in ("xmma", "cudnn", "convolve", "Nhwc", "Nchw",
                               "wgrad", "dgrad", "implicit_gemm",
                               "cutlass")):
        return library
    if "multi_tensor" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    if "nvjet" in name or "gemm" in name:
        return "matmul (cuBLAS: dense layers)"
    return "glue (copies, pads, casts, small elementwise)"


def phase_profile(torch, forward, tag="forward",
                  shape=(1, MAIN_SIZE, MAIN_SIZE, MAIN_SIZE, 1),
                  library=LIBRARY_3D):
    """Device time by kernel over two UNet forwards on z of ``shape``
    (default 128^3, batch 1; ``forward(z, t)``, after a profiled warm-up
    forward) and the device's idle share against an unprofiled forward's
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    z = torch.randn(shape, device="cuda")
    t = torch.full((shape[0],), 0.5, device="cuda")
    n_active = 2
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        forward(z, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_active):
            forward(z, t)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3 / n_active
        with profile(activities=acts):  # warm-up: the tracer's start-up
            forward(z, t)
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(n_active):
                forward(z, t)
            torch.cuda.synchronize()
    by_name, by_cat = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / n_active
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cat = _category(e.name, library)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    (OUT_DIR / f"chip_smoke_profile_{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=50))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    line = {"phase": f"profile_{tag}", "forward_ms": forward_ms,
            "device_busy_ms_per_forward": busy_ms,
            "idle_share": (max(0.0, 1.0 - busy_ms / forward_ms)
                           if busy_ms > 0 else None),
            "by_category_ms": {k: us / 1e3 for k, us in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "top_ms": [{"ms": us / 1e3, "name": n[:80]} for n, us in top],
            "library_kernels_ms": library_kernels(by_name, library)}
    emit(line)
    return line


def conv_gflop(torch, forward, shape):
    """GFLOP of the 3x3x3 convs of one ``forward(z, t)`` on z of ``shape``
    (2 * 27 * voxels * Cin * Cout each), from the shapes they are given,
    their count and their distinct (size, cin, cout) sites."""
    from vdm4cdm_torch.ops import conv as ops_conv

    table = ops_conv._K3S1_KERNELS[False]
    flops, sites = [], set()

    def counted(x, w, *args, **kwargs):
        flops.append(2 * 27 * x.shape[:-1].numel() * w.shape[3] * w.shape[4])
        sites.add((x.shape[1], w.shape[3], w.shape[4]))
        return table[0](x, w, *args, **kwargs)

    ops_conv._K3S1_KERNELS[False] = (counted,) + table[1:]
    try:
        with torch.inference_mode():
            forward(torch.randn(shape, device="cuda"),
                    torch.full((shape[0],), 0.5, device="cuda"))
    finally:
        ops_conv._K3S1_KERNELS[False] = table
    return sum(flops) / 1e9, len(flops), sites


def phase_profile_train(torch, state, step, batch, gen, tag="train",
                        library=LIBRARY_3D):
    """Device time by kernel over one train step (after a profiled warm-up
    step) and the device's idle share against unprofiled steps; returns
    the device ms by category."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n_wall = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_wall):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_wall
    with profile(activities=acts):
        step(state, batch, gen)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    by_name, by_cat = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cat = _category(e.name, library)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    (OUT_DIR / f"chip_smoke_profile_{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    by_cat = {k: us / 1e3 for k, us in by_cat.items()}
    line = {"phase": f"profile_{tag}", "step_ms": step_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": (max(0.0, 1.0 - busy_ms / step_ms)
                           if busy_ms > 0 else None),
            "by_category_ms": dict(sorted(by_cat.items(),
                                          key=lambda kv: -kv[1])),
            "top_ms": [{"ms": us / 1e3, "name": n[:80]} for n, us in top],
            "library_kernels_ms": library_kernels(by_name, library)}
    emit(line)
    return line


def library_kernels(by_name, library):
    """The library conv's kernels by name (their names tell which math
    cuDNN ran: a ``tf32`` in the name is one TF32 pass), ms each."""
    return {n[:120]: us / 1e3 for n, us in sorted(
        by_name.items(), key=lambda kv: -kv[1])
        if _category(n, library) == library}


META = {
    "conv3d_k3s1_fwd": ("cuda", "vdm4cdm_torch/csrc/conv3d_fwd.cu",
                        "vdm4cdm_tpu/ops/pallas/conv3d.py:446"),
    "conv3d_k3s1_dw": ("cuda", "vdm4cdm_torch/csrc/conv3d_dw.cu",
                       "vdm4cdm_tpu/ops/pallas/conv3d.py:531"),
    "gn_sums": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                "vdm4cdm_tpu/ops/pallas/fused_norm.py:387"),
    "gn_apply": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                 "vdm4cdm_tpu/ops/pallas/fused_norm.py:404"),
    "gn_bwd_sums": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                    "vdm4cdm_tpu/ops/pallas/fused_norm.py:435"),
    "gn_bwd_apply": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                     "vdm4cdm_tpu/ops/pallas/fused_norm.py:455"),
    "mm1x1_fwd": ("cuda", "vdm4cdm_torch/csrc/lanemm.cu",
                  "vdm4cdm_tpu/ops/pallas/lanemm.py:56"),
    "mm1x1_dw": ("cuda", "vdm4cdm_torch/csrc/lanemm.cu",
                 "vdm4cdm_tpu/ops/pallas/lanemm.py:64"),
    # the sharded path's entries: the z-halo conv and the CP GroupNorm
    "conv3d_k3s1_zhalo_fwd": ("cuda", "vdm4cdm_torch/csrc/conv3d_fwd.cu",
                              "vdm4cdm_tpu/ops/pallas/conv3d.py:995"),
    "conv3d_k3s1_zhalo_dx": ("cuda", "vdm4cdm_torch/csrc/conv3d_fwd.cu",
                             "vdm4cdm_tpu/ops/pallas/conv3d.py:1011"),
    "conv3d_k3s1_zhalo_dw": ("cuda", "vdm4cdm_torch/csrc/conv3d_dw.cu",
                             "vdm4cdm_tpu/ops/pallas/conv3d.py:1025"),
    "gn_sums_cp": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                   "vdm4cdm_tpu/ops/pallas/fused_norm.py:620"),
    "gn_apply_cp": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                    "vdm4cdm_tpu/ops/pallas/fused_norm.py:620"),
    "gn_bwd_sums_cp": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                       "vdm4cdm_tpu/ops/pallas/fused_norm.py:639"),
    "gn_bwd_apply_cp": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                        "vdm4cdm_tpu/ops/pallas/fused_norm.py:639"),
}
SOURCES = ("conv3d_fwd.cu", "conv3d_dw.cu", "lanemm.cu")


def phase_build(_build):
    """Compile every CUDA source at once (one nvcc each, side by side)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.library, SOURCES))
    ptxas = {}
    for src in SOURCES:
        log = _build.build_log.get(src, {})
        ptxas[src] = {"seconds": log.get("seconds"), "ptxas": [
            ln for ln in log.get("ptxas", "").splitlines()
            if "registers" in ln or "spill" in ln][:16]}
    emit({"phase": "build",
          "sources": [f"vdm4cdm_torch/csrc/{src}" for src in SOURCES],
          "seconds": time.perf_counter() - t0, "nvcc": ptxas})


def main() -> int:
    global LINES_FILE
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of "
                        + ",".join(PHASES + EXTRA_PHASES))
    parser.add_argument("--port", default=None, help=(
        "import vdm4cdm_torch from this directory instead of the one beside "
        "the script (e.g. an unpacked earlier commit, to time its kernels "
        "in the same call: --phases sites --port DIR); its lines go to "
        "chip_smoke_lines-<dir name>.jsonl"))
    args = parser.parse_args()
    phases = [ph for ph in args.phases.split(",") if ph]
    unknown = sorted(set(phases) - set(PHASES + EXTRA_PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    port = pathlib.Path(args.port).resolve() if args.port else ROOT
    if not (port / "vdm4cdm_torch" / "csrc").is_dir():
        print(f"chip_smoke: vdm4cdm_torch/ not found in {port}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(port))
    if args.port:
        LINES_FILE = OUT_DIR / f"chip_smoke_lines-{port.name}.jsonl"
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.ops import kernels as K
    from vdm4cdm_torch.ops.kernels import _build

    t_start = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    LINES_FILE.write_text("")
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "port": str(port.relative_to(ROOT) if port.is_relative_to(ROOT)
                      else port),
          "note": "TF32 off for the f32 references and the f32 parity "
                  "phases (torch.backends.cudnn.allow_tf32 = False)"})
    phase_build(_build)

    took, mark = {}, [time.perf_counter()]

    def lap(name):  # wall seconds of each phase run, for the last lines
        now = time.perf_counter()
        took[name], mark[0] = now - mark[0], now

    heads = {}
    if "sites" in phases:
        blessed_sites(torch, K)
        conv_sites(torch, K)
        mm1x1_sites(torch, K)
        mm1x1_f32_sites(torch, K)
        norm_sites(torch, K)
        norm_sites(torch, K, TRAIN_BATCH)
        reduction_sites(torch, vt, K)
        lap("sites")
    if "norm_sites" in phases:
        norm_sites(torch, K)
        norm_sites(torch, K, TRAIN_BATCH)
        reduction_sites(torch, vt, K)
        lap("norm_sites")
    if "kernels" in phases:
        heads = phase_kernels(torch, K)
        lap("kernels")
    if "parity" in phases:
        phase_parity(torch, vt)
        lap("parity")
    if "grads" in phases:
        phase_grads(torch, vt, K)
        lap("grads")
    heads = heads or {k: {} for k in UNSHARDED_KERNELS}
    sampler = trainer = sfm_trainer = None
    bare = {}  # the bare train steps' s/step and launches, by family
    if "main" in phases:
        sampler = phase_main(torch, vt, K, heads)
        lap("main")
    if "train" in phases:
        trainer = phase_train(torch, vt, K, heads, bare)
        lap("train")
    if "sfm" in phases:
        sfm_trainer = phase_sfm(torch, vt, K, heads, bare)
        lap("sfm")
    if "ddnm" in phases:
        phase_ddnm(torch, vt, K)
        lap("ddnm")
    if "cli" in phases:
        phase_cli(torch, vt, K, heads, bare)
        lap("cli")
    blessed = None
    if "blessed" in phases:
        blessed = phase_blessed(torch, vt, K, heads)
        lap("blessed")
    if "chain" in phases:
        phase_chain(torch, vt, K, heads)
        lap("chain")
    if "sharded" in phases:
        phase_sharded(torch, heads)
        lap("sharded")
    if "sharded_cli" in phases:
        phase_sharded_cli(torch, heads)
        lap("sharded_cli")
    if "twod" in phases:
        phase_twod(torch, vt, K, heads)
        lap("twod")
    if "twod_sharded" in phases:
        phase_twod_sharded(torch, vt, heads)
        lap("twod_sharded")
    if "precision" in phases:
        phase_precision(torch, vt, K)
        lap("precision")
    if "trained" in phases:
        phase_trained(torch, K)
        lap("trained")
    # the profiler runs last, so that tracing cannot touch a timed phase
    if "profile" in phases:
        if sampler is not None:
            vdm, s, v = sampler
            phase_profile(torch, lambda z, t: vdm.eps_hat(z, t, s, [v]))
        if trainer is not None:
            phase_profile_train(torch, *trainer)
        if blessed is not None:
            vdm_b, s_b, v_b, trainer_b = blessed
            fwd_b = lambda z, t: vdm_b.eps_hat(z, t, s_b, [v_b])  # noqa: E731
            shape = (BLESSED_REPS,) + (32,) * 3 + (1,)
            prof = phase_profile(torch, fwd_b, tag="blessed_forward",
                                 shape=shape)
            gflop, n_convs, sites = conv_gflop(torch, fwd_b, shape)
            conv_ms = prof["by_category_ms"][
                _category("conv3d_k3s1_f32_kernel")]
            bound_3x = 3 * gflop * 1e9 / PEAK_FLOPS["tf32"] * 1e3
            line = {"phase": "blessed_conv_rate", "shape": list(shape),
                    "dtype": "float32", "convs": n_convs,
                    "sites": sorted(sites), "conv_gflop_per_forward": gflop,
                    "conv_ms": conv_ms, "tflop_per_s": gflop / conv_ms,
                    "share_of_f32_peak": gflop / conv_ms * 1e12
                    / PEAK_FLOPS["float32"], "bound_3xtf32_ms": bound_3x,
                    "share_of_3xtf32_bound": bound_3x / conv_ms}
            fail_unless(sites == set(blessed_conv_cases()),
                        "the trained model's conv sites are not "
                        "blessed_conv_cases()", line)
            emit(line)
            by_cat = phase_profile_train(torch, *trainer_b,
                                         tag="blessed_train")[
                                             "by_category_ms"]
            emit({"phase": "blessed_train_dw", "model": BLESSED,
                  "batch": BLESSED_TRAIN_BATCH,
                  "dw_ms_per_step": by_cat[_category("conv3d_dw_f32_kernel")],
                  "conv_fwd_dx_ms_per_step": by_cat[
                      _category("conv3d_k3s1_f32_kernel")]})
        if sfm_trainer is not None:
            phase_profile_train(torch, *sfm_trainer, tag="sfm_train")
            sfm, batch = sfm_trainer[0].model, sfm_trainer[2]
            x0 = batch["x0"][:1]
            vs = [batch["conditioning_values"][0][:1]]
            phase_profile(torch, lambda z, t: sfm.velocity(z, t, vs, x0),
                          tag="sfm_forward")
        lap("profile")
    if phases != list(PHASES):
        print(card, flush=True)
        emit({"phase": "partial", "phases": phases,
              "seconds": time.perf_counter() - t_start,
              "seconds_by_phase": took})
        return 0

    emit({"kernels": [
        {"name": name, "route": META[name][0], "source": META[name][1],
         "replaces": META[name][2], "shape": h["shape"],
         "dtype": h["dtype"], "padding": h.get("mode"),
         "launches": h["launches"],
         "launches_blessed": h.get("launches_blessed"),
         "cuda_launches_blessed": h.get("cuda_launches_blessed"),
         "launches_blessed_train": h.get("launches_blessed_train"),
         "launches_cli": h.get("launches_cli"),
         "launches_chain": h.get("launches_chain"),
         "launches_sfm_train": h.get("launches_sfm_train"),
         "launches_vdm_train": h.get("launches_vdm_train"),
         "launches_sampler": h.get("launches_sampler"),
         "launches_sfm_sampler": h.get("launches_sfm_sampler"),
         "launches_sharded": h["launches_sharded"],
         "launches_sharded_cli": h.get("launches_sharded_cli"),
         "launches_twod": h.get("launches_twod"),
         "launches_twod_sharded": h.get("launches_twod_sharded"),
         "twod_sharded_checked": h.get("twod_sharded_checked"),
         "twod_site": h.get("twod_site"),
         "max_abs_err": h["max_abs_err"], "ms": h["ms"],
         "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
         "bound_by": h["bound_by"], "library_ms": h["library_ms"]}
        for name, h in ((n, heads[n]) for n in META)]})
    print(card, flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "seconds_by_phase": took})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
