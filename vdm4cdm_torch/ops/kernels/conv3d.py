"""SAME 3x3x3 stride-1 convolution, forward and backward: the CUDA kernels and
their plain versions.

Replaces the Pallas TPU kernel ``vdm4cdm_tpu/ops/pallas/conv3d.py::
_fwd_kernel`` as reached through ``_conv_pallas_raw_packed`` (the packed,
bias-folding, stats-emitting entry ``conv3d_pallas_packed_bs``). The kernel is
``csrc/conv3d_fwd.cu``: an implicit GEMM (M = voxels, N = Cout, K = 27 * Cin)
with wrap or zero index math in its gather, bf16 on the tensor cores through
``mma.sync`` and f32 on FMAs, f32 accumulation, bias and an optional residual
added before the cast, and optional per-(batch, channel) sums (sum y, sum y^2)
of the f32 pre-cast output. On the H100 the tensor cores bound it at the
flagship widths (hundreds of operations per byte moved); its shared-memory
tiles keep the 27 tap re-reads of each input voxel in L2 and out of device
memory. The source file says more.

The plain version computes the same function with ``torch.nn.functional.
conv3d`` in f32. CPU tensors go to it; CUDA tensors go to the kernel.

The backward has two parts. The input gradient is the forward kernel again
(:func:`conv3d_k3s1_dx`): the same conv of the output gradient with the
weights flipped in space and transposed in (Cin, Cout), under the same padding
mode, as the TPU package runs ``_conv_pallas_raw_packed`` on ``ct``. The
weight and bias gradients are ``conv3d_k3s1_dw``, the kernel
``csrc/conv3d_dw.cu``, which replaces the Pallas ``_dw_kernel`` (reached
through ``_conv_pallas_dw``): per tap a GEMM with the voxels as the
contraction, split over blocks that add their f32 tiles with atomics (the sum
order is run-dependent), bf16 on the tensor cores and f32 on FMAs. Its plain
version is 27 shifted matrix products in f32.

The spatially sharded path adds the z-halo entries, the same two kernels
with another z mode (``csrc/conv3d_fwd.cu`` says more). They replace the
Pallas kernels under ``zmode="halo"`` (``conv3d_pallas_zhalo``, its backward
``_bwd_zh`` and the packed entries): the input is a slab with its two
exchanged halo planes, (B, D + 2, H, W, Cin), and the output has D planes,
valid in z and SAME in-plane. :func:`conv3d_k3s1_zhalo_fwd` is the forward
(bias, residual and sums as above, the sums being the slab's own),
:func:`conv3d_k3s1_zhalo_dx` its input gradient (full in z, (B, D + 2, H, W,
Cin), the forward kernel's third z mode on flipped, transposed weights) and
:func:`conv3d_k3s1_zhalo_dw` its weight and bias gradients. Each counts its
own launches. Their plain versions run the valid-in-z ``F.conv3d`` on the
haloed input and the 27 shifted products with no z pad.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._common import (DTYPE_CODE, check_aligned, check_forward_only,
                      check_operand, on_cuda)


def supports(cin: int, cout: int) -> bool:
    """Channel counts the kernel takes: multiples of 8 (16-byte vectors)."""
    return cin >= 8 and cout >= 8 and cin % 8 == 0 and cout % 8 == 0


def _in_plane_pad(xf, circular):
    """(B, C, D, H, W) f32 padded by one voxel in H and W (wrapped or
    zero), not in D."""
    return F.pad(xf, (1, 1, 1, 1, 0, 0),
                 mode="circular" if circular else "constant")


def _z_pad(x, circular):
    """(B, D, H, W, C) padded by one plane on each side of D (wrapped or
    zero): the SAME conv of x is the valid-in-z conv of this."""
    if circular:
        return torch.cat([x[:, -1:], x, x[:, :1]], 1)
    return F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))


def conv3d_k3s1_zhalo_plain(x, w, bias=None, residual=None, circular=False,
                            with_sums=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_fwd`: the valid-in-z
    conv of the haloed x (B, D + 2, H, W, Cin), SAME in-plane, in f32."""
    xf = _in_plane_pad(x.float().permute(0, 4, 1, 2, 3), circular)
    # the weights take x's dtype first, as the kernel (and JAX's conv_nd)
    # multiply in it
    wf = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    sums = None
    if with_sums:
        sums = torch.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], 1)
    return y.to(x.dtype).contiguous(), sums


def conv3d_k3s1_plain(x, w, bias=None, residual=None, circular=False,
                      with_sums=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_fwd` (same arguments)."""
    return conv3d_k3s1_zhalo_plain(_z_pad(x, circular), w, bias, residual,
                                   circular, with_sums)


def conv3d_k3s1_zhalo_dx_plain(ct, w, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_dx`: the output
    gradient padded with two zero planes on each side of z, then the
    valid-in-z conv with flipped, transposed weights."""
    ct_pad = F.pad(ct, (0, 0, 0, 0, 0, 0, 2, 2))
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    return conv3d_k3s1_zhalo_plain(ct_pad, w_t, circular=circular)[0]


def conv3d_k3s1_zhalo_dw_plain(x, ct, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_zhalo_dw`: per tap, the
    f32 product of the in-plane padded, shifted x (no z pad: x has the two
    halo planes) with ct over all voxels."""
    B, D, H, W, cout = ct.shape
    cin = x.shape[-1]
    xp = _in_plane_pad(x.float().permute(0, 4, 1, 2, 3), circular)
    xp = xp.permute(0, 2, 3, 4, 1)
    ctf = ct.float().reshape(-1, cout)
    taps = [xp[:, kz:kz + D, ky:ky + H, kx:kx + W].reshape(-1, cin).T @ ctf
            for kz in range(3) for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, cin, cout), ctf.sum(0)


def conv3d_k3s1_dw_plain(x, ct, circular=False):
    """Plain PyTorch version of :func:`conv3d_k3s1_dw` (same arguments): per
    tap, the f32 product of the shifted, padded x with ct over all
    voxels."""
    return conv3d_k3s1_zhalo_dw_plain(_z_pad(x, circular), ct, circular)


def _fn(source, name, n_ptrs, n_ints):
    from ._build import c_function

    p, i = ctypes.c_void_p, ctypes.c_int
    return c_function(source, name, [i] + [p] * n_ptrs + [i] * n_ints + [p])


def _check_weights(x, w, cin):
    if tuple(w.shape[:3]) != (3, 3, 3) or w.ndim != 5 or w.shape[3] != cin:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    cout = w.shape[4]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    return cout


def _launch_fwd(name, x, w, bias, residual, circular, with_sums, d_out,
                zmode):
    """Launch ``csrc/conv3d_fwd.cu`` in ``zmode`` on x (B, Din, H, W, Cin)
    for d_out output planes. Returns (out, sums)."""
    B, _, H, W, cin = x.shape
    cout = w.shape[4]
    dev = x.device
    for what, t in (("w", w), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{what} is on {t.device}, x on {dev}")
    wt = w.to(x.dtype).permute(0, 1, 2, 4, 3).reshape(27, cout, cin)
    wt = wt.contiguous()
    bias_f = bias.float().contiguous() if bias is not None else None
    out = torch.empty((B, d_out, H, W, cout), dtype=x.dtype, device=dev)
    sums = (torch.zeros((B, 2, cout), dtype=torch.float32, device=dev)
            if with_sums else None)
    operands = (x, wt, bias_f, residual, out, sums)
    check_aligned(name, *operands)
    ptrs = [t.data_ptr() if t is not None else None for t in operands]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("conv3d_fwd.cu", "conv3d_k3s1_fwd", 6, 8)(
        DTYPE_CODE[x.dtype], *ptrs, B, d_out, H, W, cin, cout,
        int(bool(circular)), zmode, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return out, sums


def _check_residual(x, residual, shape):
    if residual is not None:
        check_operand("residual", residual, 5, (x.dtype,), x.device)
        if tuple(residual.shape) != shape:
            raise ValueError(f"residual shape {tuple(residual.shape)}, "
                             f"expected {shape}")


def conv3d_k3s1_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    circular: bool = False,
    with_sums: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y = conv(x, w) + bias + residual with SAME k3 s1 padding (circular or
    zeros on every spatial dim). x (B, D, H, W, Cin) f32 or bf16, w
    (3, 3, 3, Cin, Cout) (cast to x's dtype), bias (Cout,) (added in f32),
    residual (B, D, H, W, Cout) in x's dtype. Returns (y in x's dtype, sums)
    where sums is the (B, 2, Cout) f32 (sum y, sum y^2) of the f32 value
    before the cast, or None without ``with_sums``. Forward only."""
    check_operand("x", x, 5)
    B, D, H, W, cin = x.shape
    cout = _check_weights(x, w, cin)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    _check_residual(x, residual, (B, D, H, W, cout))
    check_forward_only("conv3d_k3s1_fwd", x, w, bias, residual)
    if not on_cuda("conv3d_k3s1_fwd", x):
        return conv3d_k3s1_plain(x, w, bias, residual, circular, with_sums)
    out = _launch_fwd("conv3d_k3s1_fwd", x, w, bias, residual, circular,
                      with_sums, D, 0)
    conv3d_k3s1_fwd.launches += 1
    return out


def conv3d_k3s1_zhalo_fwd(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    circular: bool = False,
    with_sums: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`conv3d_k3s1_fwd` on a haloed slab: x (B, D + 2, H, W, Cin)
    whose first and last planes are the neighbours' halo planes; valid in z,
    SAME in-plane (``circular`` applies to H and W only). Returns y (B, D,
    H, W, Cout) and the slab's own sums. Forward only."""
    check_operand("x", x, 5)
    B, Dh, H, W, cin = x.shape
    if Dh < 3:
        raise ValueError(f"a haloed slab has at least 3 planes, got {Dh}")
    cout = _check_weights(x, w, cin)
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({cout},)")
    _check_residual(x, residual, (B, Dh - 2, H, W, cout))
    check_forward_only("conv3d_k3s1_zhalo_fwd", x, w, bias, residual)
    if not on_cuda("conv3d_k3s1_zhalo_fwd", x):
        return conv3d_k3s1_zhalo_plain(x, w, bias, residual, circular,
                                       with_sums)
    out = _launch_fwd("conv3d_k3s1_zhalo_fwd", x, w, bias, residual,
                      circular, with_sums, Dh - 2, 1)
    conv3d_k3s1_zhalo_fwd.launches += 1
    return out


def conv3d_k3s1_zhalo_dx(ct: torch.Tensor, w: torch.Tensor,
                         circular: bool = False) -> torch.Tensor:
    """The input gradient of :func:`conv3d_k3s1_zhalo_fwd`: ct (B, D, H, W,
    Cout) and w (3, 3, 3, Cin, Cout) give (B, D + 2, H, W, Cin) in ct's
    dtype, full in z (the forward kernel's third z mode on w flipped in
    space and transposed). The halo planes' share goes back to the
    neighbours in the halo exchange's backward. Forward only."""
    check_operand("ct", ct, 5)
    B, D, H, W, cout = ct.shape
    if w.ndim != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[4] != cout:
        raise ValueError(f"w shape {tuple(w.shape)} does not fit ct "
                         f"{tuple(ct.shape)}")
    if not supports(w.shape[3], cout):
        raise ValueError(f"channels {w.shape[3]}->{cout}: need multiples "
                         "of 8")
    check_forward_only("conv3d_k3s1_zhalo_dx", ct, w)
    if not on_cuda("conv3d_k3s1_zhalo_dx", ct):
        return conv3d_k3s1_zhalo_dx_plain(ct, w, circular)
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    out, _ = _launch_fwd("conv3d_k3s1_zhalo_dx", ct, w_t, None, None,
                         circular, False, D + 2, 2)
    conv3d_k3s1_zhalo_dx.launches += 1
    return out


def conv3d_k3s1_dx(ct: torch.Tensor, w: torch.Tensor,
                   circular: bool = False) -> torch.Tensor:
    """The input gradient of y = conv(x, w): the forward kernel on the output
    gradient ct (B, D, H, W, Cout) with w (3, 3, 3, Cin, Cout) flipped in
    space and transposed, same padding mode. Returns (B, D, H, W, Cin) in
    ct's dtype. Counts as a launch of ``conv3d_k3s1_fwd``."""
    w_t = w.flip(0, 1, 2).transpose(3, 4)
    return conv3d_k3s1_fwd(ct, w_t, circular=circular)[0]


def _launch_dw(name, x, ct, circular, zmode):
    B, D, H, W, cout = ct.shape
    cin = x.shape[-1]
    if not supports(cin, cout):
        raise ValueError(f"channels {cin}->{cout}: need multiples of 8")
    dw = torch.zeros((3, 3, 3, cin, cout), dtype=torch.float32,
                     device=x.device)
    db = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    check_aligned(name, x, ct, dw, db)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn("conv3d_dw.cu", "conv3d_k3s1_dw", 4, 8)(
        DTYPE_CODE[x.dtype], x.data_ptr(), ct.data_ptr(), dw.data_ptr(),
        db.data_ptr(), B, D, H, W, cin, cout, int(bool(circular)), zmode,
        stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return dw, db


def conv3d_k3s1_dw(x: torch.Tensor, ct: torch.Tensor,
                   circular: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of y = conv(x, w) + b with SAME k3 s1 padding: x
    (B, D, H, W, Cin) and the output gradient ct (B, D, H, W, Cout) in one
    dtype, f32 or bf16. Returns dw (3, 3, 3, Cin, Cout) and db (Cout,), both
    f32. No autograd of its own."""
    check_operand("x", x, 5)
    check_operand("ct", ct, 5, (x.dtype,), x.device)
    if ct.shape[:4] != x.shape[:4]:
        raise ValueError(f"ct shape {tuple(ct.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    if not supports(x.shape[4], ct.shape[4]):
        raise ValueError(f"channels {x.shape[4]}->{ct.shape[4]}: need "
                         "multiples of 8")
    check_forward_only("conv3d_k3s1_dw", x, ct)
    if not on_cuda("conv3d_k3s1_dw", x):
        return conv3d_k3s1_dw_plain(x, ct, circular)
    out = _launch_dw("conv3d_k3s1_dw", x, ct, circular, 0)
    conv3d_k3s1_dw.launches += 1
    return out


def conv3d_k3s1_zhalo_dw(x: torch.Tensor, ct: torch.Tensor,
                         circular: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw, db) of :func:`conv3d_k3s1_zhalo_fwd`: the haloed x (B, D + 2, H,
    W, Cin) and ct (B, D, H, W, Cout) in one dtype. Returns dw (3, 3, 3, Cin,
    Cout) and db (Cout,), both f32 and both this slab's own share."""
    check_operand("x", x, 5)
    check_operand("ct", ct, 5, (x.dtype,), x.device)
    B, D, H, W, _ = ct.shape
    if tuple(x.shape[:4]) != (B, D + 2, H, W):
        raise ValueError(f"x shape {tuple(x.shape)} is not ct "
                         f"{tuple(ct.shape)} with two halo planes")
    if not supports(x.shape[4], ct.shape[4]):
        raise ValueError(f"channels {x.shape[4]}->{ct.shape[4]}: need "
                         "multiples of 8")
    check_forward_only("conv3d_k3s1_zhalo_dw", x, ct)
    if not on_cuda("conv3d_k3s1_zhalo_dw", x):
        return conv3d_k3s1_zhalo_dw_plain(x, ct, circular)
    out = _launch_dw("conv3d_k3s1_zhalo_dw", x, ct, circular, 1)
    conv3d_k3s1_zhalo_dw.launches += 1
    return out


conv3d_k3s1_fwd.launches = 0
conv3d_k3s1_dw.launches = 0
conv3d_k3s1_zhalo_fwd.launches = 0
conv3d_k3s1_zhalo_dx.launches = 0
conv3d_k3s1_zhalo_dw.launches = 0
