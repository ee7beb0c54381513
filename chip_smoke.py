#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``vdm4cdm_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing one JSON object per line (every failure propagates and
the script exits non-zero, printing no result):

  1. card     - nvidia-smi name and power limit;
  2. build    - nvcc of ``vdm4cdm_torch/csrc/*.cu`` from this checkout;
  3. kernels  - each hand kernel against its plain PyTorch version on the card
                at the sampler's shapes (B=2, circular and zeros, f32 and
                bf16, TF32 off for the f32 references), with kernel, plain,
                library and bound times, then again at the main path's
                batch-1 128^3 shapes for the ``kernels`` line;
  4. parity   - eps_hat of the full-width model (chs 32..256) at 32^3, f32,
                on the card through the kernels against the same weights on
                the CPU plain path;
  5. main     - the flagship sampler (128^3, batch 1, bf16, chs 32..256) via
                ``VDM.draw_samples`` for a few steps: s/step, s/field at 250
                steps, peak memory, kernel launches per UNet forward;
  6. profile  - device time by kernel and the device's idle share over UNet
                forwards at 128^3;
  7. the ``kernels`` line (launches from the main phase), the raw nvidia-smi
     line, and last {"ok": true, "device": {...}}.

Every parameter is drawn from a seeded normal at fan-in scale: a fresh model
has zero ``conv_out`` and zero second ResBlock convs, so its eps_hat is 0 and
would hide a broken kernel.
"""

from __future__ import annotations

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

# tolerances, as max |kernel - plain| / max(1, max |plain|):
#   f32 conv: 27*Cin-term f32 sums in another order -> 1e-4
#   bf16 conv / apply: output rounded to bf16 (2^-8 relative); the two orders
#   can land one bf16 ulp apart -> 1.6e-2
#   sums: f32 sums over up to 2M voxels with atomics in run-dependent order,
#   relative to max |sum| -> 1e-4
TOL = {("conv", "float32"): 1e-4, ("conv", "bfloat16"): 1.6e-2,
       ("apply", "float32"): 1e-5, ("apply", "bfloat16"): 1.6e-2,
       ("sums", "float32"): 1e-4, ("sums", "bfloat16"): 1e-4}
PARITY_TOL = 1e-3  # eps_hat, f32 kernels on the card vs f32 CPU plain path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def phase_kernels(torch, K):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "kernels", "note": "TF32 off for the f32 references "
          "(torch.backends.cudnn.allow_tf32 = False)"})
    for size, cin, cout, combos in conv_cases():
        for mode, dtype_name in combos:
            check_conv(torch, K, size, cin, cout, mode, dtype_name, 2,
                       timed=(mode, dtype_name) == ("circular", "bfloat16"))
    for size, C in ((128, 32), (128, 64), (64, 64), (64, 128), (32, 128),
                    (32, 256), (16, 256)):
        for dtype_name in ("bfloat16", "float32"):
            check_norm(torch, K, size, C, dtype_name, 2,
                       timed=dtype_name == "bfloat16")
    for dtype_name in ("bfloat16", "float32"):
        check_pair_norm(torch, 32, 256, 128, 8, dtype_name)
    # the kernels at the main path's headline shapes (batch 1, 128^3, bf16)
    head_conv = check_conv(torch, K, MAIN_SIZE, 32, 32, "circular",
                           "bfloat16", 1, True)
    head_sums, head_apply = check_norm(torch, K, MAIN_SIZE, 32, "bfloat16", 1,
                                       True)
    return {"conv3d_k3s1_fwd": head_conv, "gn_sums": head_sums,
            "gn_apply": head_apply}


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
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    for name, c in counts.items():
        kernels[name]["launches"] = c
    return vdm, s, v


def _category(name: str) -> str:
    if "conv3d_k3s1_kernel" in name:
        return "conv3d_k3s1_fwd"
    if name in ("sums_kernel", "apply_kernel"):
        return "gn_sums" if name == "sums_kernel" else "gn_apply"
    if any(k in name for k in ("xmma", "cudnn", "convolve", "Nhwc", "Nchw")):
        return "library conv (conv_in, downsample, conv_out)"
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
    OUT_DIR.mkdir(exist_ok=True)
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


def main() -> int:
    import torch

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
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library("conv3d_fwd.cu")
    ptxas = [ln for ln in _build.build_log.get("conv3d_fwd.cu", {})
             .get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "sources": ["vdm4cdm_torch/csrc/conv3d_fwd.cu"],
          "seconds": time.perf_counter() - t0, "ptxas": ptxas[:12]})

    heads = phase_kernels(torch, K)
    phase_parity(torch, vt)
    vdm, s, v = phase_main(torch, vt, K, heads)
    phase_profile(torch, vdm, s, v)

    meta = {
        "conv3d_k3s1_fwd": ("cuda", "vdm4cdm_torch/csrc/conv3d_fwd.cu",
                            "vdm4cdm_tpu/ops/pallas/conv3d.py:446"),
        "gn_sums": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                    "vdm4cdm_tpu/ops/pallas/fused_norm.py:387"),
        "gn_apply": ("triton", "vdm4cdm_torch/ops/kernels/fused_norm.py",
                     "vdm4cdm_tpu/ops/pallas/fused_norm.py:404"),
    }
    emit({"kernels": [
        {"name": name, "route": meta[name][0], "source": meta[name][1],
         "replaces": meta[name][2], "launches": h["launches"],
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
