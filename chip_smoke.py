#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vdm4cdm_torch``) on one H100.

    python3 chip_smoke.py [--phases kernels,grads,...]

Phases, each printing one JSON object per line (every failure propagates and
the script exits non-zero, printing no result; ``--phases`` runs a subset
while developing and then prints no ``kernels`` or ``ok`` line):

  1. card     - nvidia-smi name and power limit;
  2. build    - nvcc of ``vdm4cdm_torch/csrc/*.cu`` from this checkout, all
                sources at once;
  3. kernels  - each hand kernel against its plain PyTorch version on the card
                at the model's shapes (B=2, circular and zeros, f32 and bf16,
                TF32 off for the f32 references), with kernel, plain, library
                and bound times: the conv forward, its use as the dx pass and
                the dw kernel (also against autograd through the plain conv),
                the GroupNorm sums/apply passes (apply also with dropout,
                which holds the kernel's Philox bits to the plain version's),
                the GroupNorm backward passes with SiLU on/off and p in
                {0, 0.1}, and a skip join with a straddling group forward and
                backward; then the sampler's batch-1 128^3 shapes;
  4. parity   - eps_hat of the full-width model (chs 32..256) at 32^3, f32,
                on the card through the kernels against the same weights on
                the CPU plain path;
  5. grads    - the same model, batch 2, dropout 0.1 with injected t, eps and
                seed: the loss and every parameter's gradient on the card
                against the CPU plain path (the dropout mask is the same
                function of seed and index on both);
  6. main     - the flagship sampler (128^3, batch 1, bf16, chs 32..256) via
                ``VDM.draw_samples`` for a few steps: s/step, s/field at 250
                steps, peak memory, kernel launches per UNet forward;
  7. train    - the flagship train step (128^3, batch 2, bf16, dropout 0.1,
                bf16 first moment, EMA) via ``make_train_step``: a warm-up
                step, then timed steps: s/step, voxels/s, peak memory, kernel
                launches per step, finite loss and gradient norm, parameters
                changed;
  8. profile  - device time by kernel and the device's idle share over UNet
                forwards and over a train step at 128^3;
  9. the ``kernels`` line (launches from the train phase, and from the main
     phase as ``launches_sampler``), the raw nvidia-smi line, and last
     {"ok": true, "device": {...}}.

Every parameter is drawn from a seeded normal at fan-in scale: a fresh model
has zero ``conv_out`` and zero second ResBlock convs, so its eps_hat is 0 and
would hide a broken kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s per type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the flagship (bench.py's model, preset trainVDM3D128_c_c)
FLAGSHIP = dict(chs=(32, 64, 128, 256), s_conditioning_channels=1,
                v_conditioning_dims=(6,), norm_groups=8, mid_attn=False,
                dropout_prob=0.1, conv_padding_mode="circular")
MAIN_SIZE, MAIN_STEPS, FIELD_STEPS = 128, 3, 250
PARITY_SIZE = 32
TRAIN_BATCH, TRAIN_STEPS, EMA_DECAY = 2, 3, 0.999
PHASES = ("kernels", "parity", "grads", "main", "train", "profile")
# (size, channels) of the GroupNorm checks; the dropout checks; the skip join
# (size, Ca, Cb, groups) whose group of 48 channels straddles the boundary
NORM_CASES = ((128, 32), (128, 64), (64, 64), (64, 128), (32, 128),
              (32, 256), (16, 256))
DROPOUT_CASES = ((128, 32), (32, 128))
PAIR_CASE = (32, 256, 128, 8)

# tolerances, as max |kernel - plain| / max(1, max |plain|):
#   f32 conv: 27*Cin-term f32 sums in another order -> 1e-4
#   bf16 conv / apply: output rounded to bf16 (2^-8 relative); the two orders
#   can land one bf16 ulp apart -> 1.6e-2
#   sums: f32 sums over up to 2M voxels with atomics in run-dependent order,
#   relative to max |sum| -> 1e-4
#   dw / db: f32 sums over up to 4.2M voxels, split over blocks and joined
#   by atomics in run-dependent order, relative to max |dw| -> 2e-4 (both
#   dtypes: bf16 products are exact in f32)
#   backward apply: as apply, but f32 gets 1e-4: dx is a difference of terms
#   up to 1e2 times larger than the result
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
DROPOUT_P = 0.1


LINES_FILE = OUT_DIR / "chip_smoke_lines.jsonl"  # every line, written through


def emit(obj) -> None:
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


def bound_ms(flops: float, nbytes: float, dtype_name: str):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def check_conv(torch, K, size, cin, cout, mode, dtype_name, batch, timed):
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
        yr, sr = K.conv3d_k3s1_plain(x, w, bias, res, circ, True)
        torch.cuda.synchronize()
        abs_err, err = rel_err(y, yr)
        _, s_err = rel_err(s / sr.abs().max(), sr / sr.abs().max())
        tol, s_tol = TOL[("conv", dtype_name)], TOL[("sums", dtype_name)]
        line = {"phase": "kernel", "kernel": "conv3d_k3s1_fwd",
                "shape": [batch, size, size, size, cin, cout], "mode": mode,
                "dtype": dtype_name, "max_abs_err": abs_err,
                "rel_err": err, "tol": tol, "sums_rel_err": s_err,
                "sums_tol": s_tol}
        if not (err <= tol and s_err <= s_tol):
            emit(line)
            raise AssertionError(f"conv3d_k3s1_fwd disagrees: {line}")
        if timed:
            n = max(3, min(50, int(2e7 // (batch * size ** 3))))
            elt = x.element_size()
            vox = batch * size ** 3
            flops = 2.0 * 27 * cin * cout * vox
            nbytes = vox * (cin + 2 * cout) * elt + w.numel() * elt
            b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
            if circ:
                xp = F.pad(xc, (1,) * 6, mode="circular")
                lib = lambda: F.conv3d(xp, wc, bias.to(dtype))  # noqa: E731
            else:
                lib = lambda: F.conv3d(xc, wc, bias.to(dtype),  # noqa: E731
                                       padding=1)
            line.update(
                ms=cuda_time_ms(lambda: K.conv3d_k3s1_fwd(
                    x, w, bias, res, circ, True), n),
                plain_ms=cuda_time_ms(lambda: K.conv3d_k3s1_plain(
                    x, w, bias, res, circ, True), max(2, n // 4)),
                library_ms=cuda_time_ms(lib, n),
                bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
    emit(line)
    return line


def check_norm(torch, K, size, C, dtype_name, batch, timed):
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 7 + C)
    S = size ** 3
    x = (1.5 * torch.randn(batch, S, C, generator=gen, device="cuda")
         + 0.4).to(dtype)
    a = 1.0 + 0.3 * torch.randn(batch, C, generator=gen, device="cuda")
    bv = 0.2 * torch.randn(batch, C, generator=gen, device="cuda")
    lines = []
    with torch.inference_mode():
        s, sr = K.gn_sums(x), K.gn_sums_plain(x)
        y, yr = K.gn_apply(x, a, bv, "silu"), K.gn_apply_plain(x, a, bv, True)
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
            if err > tol:
                emit(line)
                raise AssertionError(f"{name} disagrees: {line}")
            if timed:
                n = max(5, min(100, int(4e8 // (batch * S * C))))
                if kind == "sums":
                    nbytes = batch * S * C * elt + batch * 2 * C * 4
                    flops = 3.0 * batch * S * C
                    line.update(
                        ms=cuda_time_ms(lambda: K.gn_sums(x), n),
                        plain_ms=cuda_time_ms(lambda: K.gn_sums_plain(x), n),
                        library_ms=None)
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


def check_pair_norm(torch, size, ca, cb, groups, dtype_name):
    """A decoder skip join through both GroupNorm kernels: joint statistics
    over a Pair whose group straddles the boundary, against GroupNorm + SiLU
    over the materialized concat in plain f32 torch."""
    from vdm4cdm_torch.ops.norm import norm_affine_act
    from vdm4cdm_torch.ops.pair import Pair

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size + ca + cb)
    shape = (2, size, size, size)
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
            "shape": [2, size ** 3, ca, cb], "groups": groups,
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


def check_conv_bwd(torch, K, size, cin, cout, mode, dtype_name, batch, timed):
    """The dx pass (the forward kernel on ct with flipped, transposed
    weights) and ``conv3d_k3s1_dw`` against autograd through the plain conv
    in f32, and dw/db also against the module's plain version."""
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
    # autograd through the plain conv: f32, weights rounded to x's dtype
    xr = x.float().requires_grad_(True)
    wr = w.to(dtype).float().requires_grad_(True)
    br = torch.zeros(cout, device="cuda", requires_grad=True)
    yr, _ = K.conv3d_k3s1_plain(xr, wr, br, None, circ, False)
    dx_r, dw_r, db_r = torch.autograd.grad(yr, (xr, wr, br), ct.float())
    torch.cuda.synchronize()
    del yr, xr
    tol_dx, tol_dw = TOL[("conv", dtype_name)], TOL[("dw", dtype_name)]
    dx_abs, dx_err = rel_err(dx, dx_r)

    def scaled(got, ref):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    line = {"phase": "kernel", "kernel": "conv3d_k3s1_fwd (dx pass)",
            "shape": [batch, size, size, size, cout, cin], "mode": mode,
            "dtype": dtype_name, "max_abs_err": dx_abs, "rel_err": dx_err,
            "tol": tol_dx}
    fail_unless(dx_err <= tol_dx, "dx pass disagrees", line)
    emit(line)
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
        nbytes = vox * (cin + cout) * elt + (27 * cin * cout + cout) * 4
        b_ms, b_by = bound_ms(flops, nbytes, dtype_name)
        xc = x.permute(0, 4, 1, 2, 3)
        if circ:
            xc = F.pad(xc, (1,) * 6, mode="circular")
        ctc = ct.permute(0, 4, 1, 2, 3)
        wshape = (cout, cin, 3, 3, 3)
        pad = 0 if circ else 1
        line.update(
            ms=cuda_time_ms(lambda: K.conv3d_k3s1_dw(x, ct, circ), n),
            plain_ms=cuda_time_ms(
                lambda: K.conv3d_k3s1_dw_plain(x, ct, circ), 2, 1),
            library_ms=cuda_time_ms(
                lambda: torch.nn.grad.conv3d_weight(xc, wshape, ctc,
                                                    padding=pad), n),
            library_call="torch.nn.grad.conv3d_weight (no db)",
            dx_ms=cuda_time_ms(lambda: K.conv3d_k3s1_dx(ct, w, circ), n),
            bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
    emit(line)
    return line


def norm_inputs(torch, size, C, dtype_name, batch, groups=8):
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size * 11 + C)
    S = size ** 3
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


def check_dropout_apply(torch, K, size, C, dtype_name, batch):
    """``gn_apply`` at p = 0.1 against its plain version: the kernel's Philox
    bits equal the plain version's (one differing bit is an O(1) error), and
    the keep rate lies within 4 sigma of 1 - p."""
    x, _, mean, inv, a, b = norm_inputs(torch, size, C, dtype_name, batch)
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
            "shape": [batch, size ** 3, C], "dtype": dtype_name,
            "p": DROPOUT_P, "max_abs_err": abs_err, "rel_err": err,
            "tol": tol, "mask_mismatches": n_mismatch, "keep_rate": rate,
            "keep_rate_sigmas": abs(rate - (1 - DROPOUT_P)) / sigma,
            "other_seed_differs": differs}
    fail_unless(err <= tol and n_mismatch == 0 and differs
                and line["keep_rate_sigmas"] <= 4.0,
                "gn_apply with dropout disagrees", line)
    emit(line)


def check_norm_bwd(torch, K, size, C, dtype_name, batch, act, p, timed):
    import torch.nn.functional as F

    x, ct, mean, inv, a, b = norm_inputs(torch, size, C, dtype_name, batch)
    S, groups = size ** 3, 8
    count = float(S * (C // groups))
    seed = 0x0FEDCBA987654321 ^ (size * C)
    silu = act == "silu"

    def group_mean(v):
        g = v.reshape(batch, groups, C // groups).sum(-1) / count
        return g.repeat_interleave(C // groups, -1).contiguous()

    with torch.inference_mode():
        sums = K.gn_bwd_sums(x, ct, mean, inv, a, b, act, p, seed)
        sums_r = K.gn_bwd_sums_plain(x, ct, mean, inv, a, b, silu, p, seed)
        m1, m2 = group_mean(a * sums_r[:, 0]), group_mean(a * sums_r[:, 1])
        dx = K.gn_bwd_apply(x, ct, mean, inv, a, b, m1, m2, act, p, seed)
        dx_r = K.gn_bwd_apply_plain(x, ct, mean, inv, a, b, m1, m2, silu, p,
                                    seed)
        torch.cuda.synchronize()
    elt = x.element_size()
    n = max(5, min(100, int(4e8 // (batch * S * C))))
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
        fail_unless(err <= tol, f"{name} disagrees", line)
        if timed:
            if kind == "sums":
                nbytes = 2 * batch * S * C * elt + batch * 6 * C * 4
                flops = 16.0 * batch * S * C
                line.update(
                    ms=cuda_time_ms(lambda: K.gn_bwd_sums(
                        x, ct, mean, inv, a, b, act, p, seed), n),
                    plain_ms=cuda_time_ms(lambda: K.gn_bwd_sums_plain(
                        x, ct, mean, inv, a, b, silu, p, seed), 3, 1))
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


def check_pair_norm_bwd(torch, size, ca, cb, groups, dtype_name):
    """The backward of a decoder skip join: the norm Function over a Pair
    whose group straddles the boundary (joint group means in the finalize)
    against autograd through GroupNorm + SiLU over the materialized concat
    in plain f32 torch."""
    from vdm4cdm_torch.ops.norm import norm_affine_act
    from vdm4cdm_torch.ops.pair import Pair

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(size + ca - cb)
    shape = (2, size, size, size)
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
            "shape": [2, size ** 3, ca, cb], "groups": groups,
            "straddling_group": [(ca // group) * group,
                                 (ca // group + 1) * group - 1],
            "dtype": dtype_name, "max_abs_err": abs_err, "rel_err": err,
            "tol": tol, "da_rel_err": da_err, "db_rel_err": db_err,
            "sums_tol": s_tol}
    fail_unless(ca % group != 0 and err <= tol and da_err <= s_tol
                and db_err <= s_tol, "pair GroupNorm backward failed", line)
    emit(line)


def phase_kernels(torch, K):
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

    # ---- the backward kernels, at the train step's shapes (batch 2)
    heads = {}
    for size, cin, cout, _ in conv_cases():
        for mode, dtype_name in [(m, d) for m in ("circular", "zeros")
                                 for d in ("bfloat16", "float32")]:
            timed = (mode, dtype_name) == ("circular", "bfloat16")
            line = check_conv_bwd(torch, K, size, cin, cout, mode, dtype_name,
                                  TRAIN_BATCH, timed)
            if timed and (size, cin, cout) == (MAIN_SIZE, 32, 32):
                heads["conv3d_k3s1_dw"] = line
    for size, C in DROPOUT_CASES:
        for dtype_name in ("bfloat16", "float32"):
            check_dropout_apply(torch, K, size, C, dtype_name, TRAIN_BATCH)
    for size, C in NORM_CASES:
        for dtype_name in ("bfloat16", "float32"):
            for act, p in (("silu", DROPOUT_P), ("silu", 0.0), (None, 0.0),
                           (None, DROPOUT_P)):
                timed = dtype_name == "bfloat16" and act == "silu"
                lines = check_norm_bwd(torch, K, size, C, dtype_name,
                                       TRAIN_BATCH, act, p, timed)
                if timed and p > 0 and (size, C) == (MAIN_SIZE, 32):
                    heads["gn_bwd_sums"], heads["gn_bwd_apply"] = lines
    for dtype_name in ("bfloat16", "float32"):
        check_pair_norm_bwd(torch, *PAIR_CASE, dtype_name)
    # the forward kernels at the train step's headline shapes (batch 2)
    heads["conv3d_k3s1_fwd"] = check_conv(
        torch, K, MAIN_SIZE, 32, 32, "circular", "bfloat16", TRAIN_BATCH,
        True)
    heads["gn_sums"], heads["gn_apply"] = check_norm(
        torch, K, MAIN_SIZE, 32, "bfloat16", TRAIN_BATCH, True)
    return heads


# --------------------------------------------------------------- the model

def build_vdm(torch, vt, size, dtype, device, seed):
    net = vt.CUNet(shape=(1, size, size, size), compute_dtype=dtype,
                   device=device, **FLAGSHIP)
    vdm = vt.VDM(net, vt.make_schedule("learned_linear", -13.3, 13.3,
                                       device=device))
    randomize_(vdm, seed)
    return vdm.eval()


def conditioning(torch, size, batch, device, seed):
    gen = torch.Generator().manual_seed(seed)
    s = torch.randn(batch, size, size, size, 1, generator=gen)
    v = torch.randn(batch, 6, generator=gen)
    return s.to(device), v.to(device)


def phase_parity(torch, vt):
    t0 = time.perf_counter()
    size = PARITY_SIZE
    gpu = build_vdm(torch, vt, size, torch.float32, "cuda", 1)
    cpu = build_vdm(torch, vt, size, torch.float32, "cpu", 1)
    s, v = conditioning(torch, size, 2, "cpu", 2)
    z = torch.randn(2, size, size, size, 1,
                    generator=torch.Generator().manual_seed(3))
    t = torch.tensor([0.3, 0.8])
    with torch.inference_mode():
        ref = cpu.eps_hat(z, t, s, [v])
        got = gpu.eps_hat(z.cuda(), t.cuda(), s.cuda(), [v.cuda()]).cpu()
    abs_err, err = rel_err(got, ref)
    line = {"phase": "parity", "size": size, "chs": list(FLAGSHIP["chs"]),
            "dtype": "float32", "max_abs_ref": ref.abs().max().item(),
            "max_abs_err": abs_err, "rel_err": err, "tol": PARITY_TOL,
            "seconds": time.perf_counter() - t0}
    emit(line)
    if not (torch.isfinite(got).all() and err <= PARITY_TOL
            and ref.abs().max().item() > 0.1):
        raise AssertionError(f"eps_hat parity failed: {line}")


def loss_batch(torch, size, batch, device, seed):
    s, v = conditioning(torch, size, batch, device, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(batch, size, size, size, 1, generator=gen)
    return {"x": x.to(device), "conditioning": s,
            "conditioning_values": [v]}


def phase_grads(torch, vt, K):
    """Loss and every parameter's gradient of the full-width model at 32^3,
    f32, batch 2, dropout 0.1: the card through the kernels against the CPU
    plain path, with the same injected t, eps and dropout seed."""
    t0 = time.perf_counter()
    size = PARITY_SIZE
    gen = torch.Generator().manual_seed(7)
    t = torch.tensor([0.35, 0.85])
    eps = torch.randn(2, size, size, size, 1, generator=gen)
    seed = 0x5EED5EED5EED
    out = {}
    K.reset_launch_counts()
    for device in ("cuda", "cpu"):
        vdm = build_vdm(torch, vt, size, torch.float32, device, 1)
        batch = loss_batch(torch, size, 2, device, 8)
        losses = vdm.loss(batch, train=True, t=t, eps=eps, dropout_seed=seed)
        losses.loss.backward()
        out[device] = (losses, {k: p.grad.detach().cpu()
                                for k, p in vdm.named_parameters()})
    counts = K.launch_counts()
    (got_l, got_g), (ref_l, ref_g) = out["cuda"], out["cpu"]
    loss_err = {k: abs(getattr(got_l, k).item() - getattr(ref_l, k).item())
                / max(1.0, abs(getattr(ref_l, k).item()))
                for k in ref_l._fields}
    top = max(g.abs().max().item() for g in ref_g.values())
    errs = {k: (got_g[k] - g).abs().max().item()
            / max(g.abs().max().item(), 1e-3 * top)
            for k, g in ref_g.items()}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in got_g.values())
    line = {"phase": "grads", "size": size, "batch": 2, "dtype": "float32",
            "dropout": DROPOUT_P, "loss": ref_l.loss.item(),
            "loss_rel_err": max(loss_err.values()),
            "n_params": len(errs), "rel_err": errs[worst],
            "worst_param": worst, "max_abs_grad": top, "tol": GRADS_TOL,
            "launches": counts, "seconds": time.perf_counter() - t0}
    fail_unless(finite and errs[worst] <= GRADS_TOL
                and line["loss_rel_err"] <= 1e-4 and top > 1e-3
                and min(counts.values()) > 0, "gradient parity failed", line)
    emit(line)


def phase_train(torch, vt, K, kernels):
    """The flagship train step at 128^3, batch 2, bf16, dropout 0.1, bf16
    first moment, EMA: one warm-up step, then timed steps."""
    size, batch_size = MAIN_SIZE, TRAIN_BATCH
    vdm = build_vdm(torch, vt, size, torch.bfloat16, "cuda", 9)
    batch = loss_batch(torch, size, batch_size, "cuda", 10)
    opt = vt.make_optimizer(learning_rate=3e-4, grad_clip=0.5,
                            moment_dtype=torch.bfloat16)
    state = vt.TrainState(0, vdm, opt.init(vdm), vt.init_ema(vdm))
    step = vt.make_train_step(vdm, opt, ema_decay=EMA_DECAY)
    gen = torch.Generator(device="cuda").manual_seed(11)
    before = {k: p.detach().clone() for k, p in vdm.named_parameters()}
    # warm-up: Triton specializations and cuDNN plans for these shapes
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch, gen)
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in vdm.named_parameters())
    ema_moved = max((state.ema_params[k] - before[k]).abs().max().item()
                    for k in before)
    finite = all(math.isfinite(v) for v in losses + norms) and all(
        bool(torch.isfinite(p).all()) for p in vdm.parameters())
    line = {"phase": "train", "size": size, "batch": batch_size,
            "dtype": "bfloat16", "dropout": DROPOUT_P,
            "moment_dtype": "bfloat16", "ema_decay": EMA_DECAY,
            "chs": list(FLAGSHIP["chs"]), "steps": TRAIN_STEPS,
            "seconds": dt, "s_per_step": dt / TRAIN_STEPS,
            "voxels_per_s": batch_size * size ** 3 * TRAIN_STEPS / dt,
            "peak_mem_gib": peak / 2 ** 30, "launches": counts,
            "launches_per_step": {k: c / TRAIN_STEPS
                                  for k, c in counts.items()},
            "loss": losses, "grad_norm": norms, "finite": finite,
            "max_param_change": moved, "max_ema_change": ema_moved,
            "state_step": state.step}
    emit(line)
    if not finite or moved <= 0.0 or ema_moved <= 0.0:
        raise AssertionError("the train step did not give finite, changed "
                             "parameters")
    if state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"state.step is {state.step}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    for name, c in counts.items():
        kernels[name]["launches"] = c
    return state, step, batch, gen


def phase_main(torch, vt, K, kernels):
    size = MAIN_SIZE
    vdm = build_vdm(torch, vt, size, torch.bfloat16, "cuda", 4)
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
            "chs": list(FLAGSHIP["chs"]), "steps": MAIN_STEPS,
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
    sampler = ("conv3d_k3s1_fwd", "gn_sums", "gn_apply")
    if min(counts[k] for k in sampler) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    for name in sampler:
        kernels[name]["launches_sampler"] = counts[name]
    return vdm, s, v


_TRITON = {"sums_kernel": "gn_sums", "apply_kernel": "gn_apply",
           "bwd_sums_kernel": "gn_bwd_sums",
           "bwd_apply_kernel": "gn_bwd_apply"}


def _category(name: str) -> str:
    if "conv3d_k3s1_kernel" in name:
        return "conv3d_k3s1_fwd (forward and dx)"
    if "conv3d_dw_kernel" in name:
        return "conv3d_k3s1_dw"
    if name in _TRITON:
        return _TRITON[name]
    if any(k in name for k in ("xmma", "cudnn", "convolve", "Nhwc", "Nchw",
                               "wgrad", "dgrad")):
        return "library conv (conv_in, downsample, conv_out)"
    if "multi_tensor" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    if "nvjet" in name or "gemm" in name:
        return "matmul (skip_proj, dense)"
    return "glue (copies, pads, casts, small elementwise)"


def phase_profile(torch, vdm, s, v):
    """Device time by kernel over two UNet forwards at 128^3 (after a
    profiled warm-up forward) and the device's idle share against an
    unprofiled forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    z = torch.randn(1, MAIN_SIZE, MAIN_SIZE, MAIN_SIZE, 1, device="cuda")
    t = torch.tensor([0.5], device="cuda")
    n_active = 2
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        vdm.eps_hat(z, t, s, [v])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_active):
            vdm.eps_hat(z, t, s, [v])
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3 / n_active
        with profile(activities=acts):  # warm-up: the tracer's start-up
            vdm.eps_hat(z, t, s, [v])
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(n_active):
                vdm.eps_hat(z, t, s, [v])
            torch.cuda.synchronize()
    by_name, by_cat = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / n_active
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=50))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "profile", "forward_ms": forward_ms,
          "device_busy_ms_per_forward": busy_ms,
          "idle_share": (max(0.0, 1.0 - busy_ms / forward_ms)
                         if busy_ms > 0 else None),
          "by_category_ms": {k: us / 1e3 for k, us in sorted(
              by_cat.items(), key=lambda kv: -kv[1])},
          "top_ms": [{"ms": us / 1e3, "name": n[:80]} for n, us in top]})


def phase_profile_train(torch, state, step, batch, gen):
    """Device time by kernel over one train step at 128^3 (after a profiled
    warm-up step) and the device's idle share against unprofiled steps."""
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
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    (OUT_DIR / "chip_smoke_profile_train.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile_train", "step_ms": step_ms,
          "device_busy_ms_per_step": busy_ms,
          "idle_share": (max(0.0, 1.0 - busy_ms / step_ms)
                         if busy_ms > 0 else None),
          "by_category_ms": {k: us / 1e3 for k, us in sorted(
              by_cat.items(), key=lambda kv: -kv[1])},
          "top_ms": [{"ms": us / 1e3, "name": n[:80]} for n, us in top]})


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
}
SOURCES = ("conv3d_fwd.cu", "conv3d_dw.cu")


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
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args()
    phases = [ph for ph in args.phases.split(",") if ph]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "vdm4cdm_torch" / "csrc").is_dir():
        print("chip_smoke: vdm4cdm_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
          "note": "TF32 off for the f32 references and the f32 parity "
                  "phases (torch.backends.cudnn.allow_tf32 = False)"})
    phase_build(_build)

    heads = {}
    if "kernels" in phases:
        heads = phase_kernels(torch, K)
    if "parity" in phases:
        phase_parity(torch, vt)
    if "grads" in phases:
        phase_grads(torch, vt, K)
    sampler = trainer = None
    if "main" in phases:
        sampler = phase_main(torch, vt, K, heads or {
            k: {} for k in ("conv3d_k3s1_fwd", "gn_sums", "gn_apply")})
    if "train" in phases:
        trainer = phase_train(torch, vt, K, heads or {k: {} for k in META})
    if "profile" in phases:
        if sampler is not None:
            phase_profile(torch, *sampler)
        if trainer is not None:
            phase_profile_train(torch, *trainer)
    if phases != list(PHASES):
        print(card, flush=True)
        emit({"phase": "partial", "phases": phases,
              "seconds": time.perf_counter() - t_start})
        return 0

    emit({"kernels": [
        {"name": name, "route": META[name][0], "source": META[name][1],
         "replaces": META[name][2], "launches": h["launches"],
         "launches_sampler": h.get("launches_sampler"),
         "max_abs_err": h["max_abs_err"], "ms": h["ms"],
         "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
         "bound_by": h["bound_by"], "library_ms": h["library_ms"]}
        for name, h in heads.items()]})
    print(card, flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
