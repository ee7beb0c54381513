"""Operations and bytes of the UNet's work, counted from its shapes, and the
H100's peaks they are held to.

``forward_sites(arch)`` lists every conv, GroupNorm and dense call of one
forward of one sample, with the flags the program's path gives them: whether
a call is inside a ResBlock (recomputed in the backward where the model
rematerializes ResBlocks), and whether a GroupNorm takes its sums from the
conv before it (a 3D k3 stride-1 conv whose widths are multiples of 8 runs
the hand kernel, which emits them). From those:

* ``model_flops``: conv (k3 and k1), dense and attention FLOPs of one
  forward; a train step counts three forwards and no recompute;
* ``conv_least_s``: the least time of every k3 conv call of a train step or
  of a forward (recompute included: it is work the conv kernels do), each
  call the larger of its FLOPs over the peak of its dtype and its bytes over
  HBM bandwidth. A call's bytes are its operands and its result, each once:
  forward x, w and y (and the residual it adds); dx: dy, w and dx; dw: x, dy
  and dw;
* ``norm_least_s``: the bytes over HBM bandwidth of every GroupNorm pass of
  a train step or a forward: sums (x), apply (x, y), backward sums (x, dy),
  backward apply (x, dy, dx).

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, dense: bf16 989
TFLOP/s; float32 work is held to the TF32 tensor-core rate, 495 TFLOP/s,
which the port's 3xTF32 kernels run on (the 67 TFLOP/s non-tensor rate is
one such a kernel passes); HBM 3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
from typing import List

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ELT = {"bfloat16": 2, "float32": 4}
PARAM_ELT = 4  # parameters and weight gradients are float32


@dataclasses.dataclass(frozen=True)
class Conv:
    nd: int
    cin: int
    cout: int
    k: int
    stride: int
    in_vox: int      # per sample
    out_vox: int
    in_block: bool   # inside a ResBlock
    residual: bool
    needs_dx: bool
    hand: bool       # the 3D hand kernel, which emits GroupNorm sums
    halves: int = 1  # 2 where the input is a decoder join: a call a half

    @property
    def flops(self) -> float:
        """Per sample."""
        return 2.0 * self.k ** self.nd * self.cin * self.cout * self.out_vox

    @property
    def weight_bytes(self) -> int:
        return self.k ** self.nd * self.cin * self.cout * PARAM_ELT


@dataclasses.dataclass(frozen=True)
class Norm:
    channels: int
    vox: int
    in_block: bool
    takes_sums: bool
    halves: int = 1


@dataclasses.dataclass(frozen=True)
class Dense:
    din: int
    dout: int
    rows_per_sample: int  # rows of the product for each sample


def forward_sites(arch) -> List[object]:
    """Every conv, GroupNorm and dense call of one forward, per sample."""
    nd, chs = arch.ndim, tuple(arch.chs)
    vox = [(arch.size >> lv) ** nd for lv in range(len(chs))]
    sites: List[object] = []

    def is_hand(cin, cout, k, stride):
        return (nd == 3 and k == 3 and stride == 1 and cin >= 8
                and cout >= 8 and cin % 8 == 0 and cout % 8 == 0)

    def conv(cin, cout, k, lv, stride=1, in_block=False, residual=False,
             needs_dx=True, halves=1):
        out_lv = lv + 1 if stride == 2 else lv
        sites.append(Conv(nd, cin, cout, k, stride, vox[lv], vox[out_lv],
                          in_block, residual, needs_dx,
                          is_hand(cin, cout, k, stride), halves))

    emb = 4 * chs[0]
    sites += [Dense(chs[0], emb, 1), Dense(emb, emb, 1)]
    for d in arch.v_dims:
        sites += [Dense(d, emb, 1), Dense(emb, emb, 1)]

    def res(cin, cout, lv, halves=1):
        sites.append(Norm(cin, vox[lv], True, False, halves))
        conv(cin, cout, 3, lv, in_block=True, halves=halves)
        sites.append(Dense(emb, 2 * cout, 1))
        sites.append(Norm(cout, vox[lv], True, is_hand(cin, cout, 3, 1)))
        if cin != cout:
            conv(cin, cout, 1, lv, in_block=True, halves=halves)
        conv(cout, cout, 3, lv, in_block=True, residual=True)

    conv(arch.in_channels + arch.s_channels, chs[0], 3, 0, needs_dx=False)
    skips, h = [chs[0]], chs[0]
    for lv, ch in enumerate(chs):
        for _ in range(arch.n_res):
            res(h, ch, lv)
            h = ch
            skips.append(h)
        if lv < len(chs) - 1:
            conv(ch, ch, 3, lv, stride=2)
            skips.append(ch)
    last = len(chs) - 1
    res(h, chs[-1], last)
    if arch.mid_attn:
        sites.append(Norm(chs[-1], vox[last], False, False))
        sites.append(Dense(chs[-1], 3 * chs[-1], vox[last]))
        sites.append(Dense(chs[-1], chs[-1], vox[last]))
    res(chs[-1], chs[-1], last)
    h = chs[-1]
    for lv in reversed(range(len(chs))):
        for _ in range(arch.n_res + 1):
            res(h + skips.pop(), chs[lv], lv, halves=2)
            h = chs[lv]
        if lv > 0:
            conv(h, h, 3, lv - 1)
    sites.append(Norm(h, vox[0], False, False))
    conv(h, arch.in_channels, 3, 0)
    return sites


def model_flops(arch, batch: int) -> float:
    """FLOPs of one forward of ``batch`` samples: convs, dense layers and
    attention (QK^T and AV)."""
    total = 0.0
    for s in forward_sites(arch):
        if isinstance(s, Conv):
            total += s.flops * batch
        elif isinstance(s, Dense):
            total += 2.0 * s.rows_per_sample * batch * s.din * s.dout
    if arch.mid_attn:
        seq = (arch.size >> (len(arch.chs) - 1)) ** arch.ndim
        total += 2 * 2.0 * batch * seq * seq * arch.chs[-1]
    return total


def _least(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def conv_least_s(arch, batch: int, dtype: str, train: bool,
                 remat: bool) -> float:
    """Least seconds of the k3 conv calls of one train step (``train``) or
    one forward."""
    elt = ELT[dtype]
    total = 0.0
    for c in forward_sites(arch):
        if not isinstance(c, Conv) or c.k != 3:
            continue
        f = c.flops * batch
        x = c.in_vox * c.cin * batch * elt
        y = c.out_vox * c.cout * batch * elt
        fwd = _least(f, x + y * (2 if c.residual else 1) + c.weight_bytes,
                     dtype)
        if not train:
            total += fwd
            continue
        total += fwd * (2 if remat and c.in_block else 1)
        if c.needs_dx:
            total += _least(f, y + x + c.weight_bytes, dtype)
        total += _least(f, x + y + c.weight_bytes, dtype)
    return total


def norm_least_s(arch, batch: int, dtype: str, train: bool,
                 remat: bool) -> float:
    """Least seconds (bytes over HBM bandwidth) of the GroupNorm passes of
    one train step or one forward."""
    elt = ELT[dtype]
    nbytes = 0.0
    for n in forward_sites(arch):
        if not isinstance(n, Norm):
            continue
        a = n.vox * n.channels * batch * elt
        fwd = (0 if n.takes_sums else a) + 2 * a
        if not train:
            nbytes += fwd
            continue
        nbytes += fwd * (2 if remat and n.in_block else 1)
        nbytes += 2 * a + 3 * a
    return nbytes / HBM_BYTES_PER_S


def launches(arch, train: bool, remat: bool) -> dict:
    """Launches of the port's hand-kernel wrappers in one train step or one
    forward, by the names of ``vdm4cdm_torch.ops.kernels.launch_counts``:
    the conv forward wrapper also runs each dx."""
    out = dict.fromkeys(("conv3d_k3s1_fwd", "conv3d_k3s1_dw", "gn_sums",
                         "gn_apply", "gn_bwd_sums", "gn_bwd_apply",
                         "mm1x1_fwd", "mm1x1_dw"), 0)
    bwd = 1 if train else 0
    for s in forward_sites(arch):
        if isinstance(s, Dense):
            continue
        fwd = 2 if (train and remat and s.in_block) else 1
        n = s.halves
        if isinstance(s, Conv) and s.hand:
            out["conv3d_k3s1_fwd"] += n * (fwd + bwd)
            out["conv3d_k3s1_dw"] += n * bwd
        elif isinstance(s, Conv) and s.k == 1 and s.cin % 8 == 0 \
                and s.cout % 8 == 0:
            out["mm1x1_fwd"] += n * (fwd + bwd)
            out["mm1x1_dw"] += n * bwd
        elif isinstance(s, Norm):
            out["gn_sums"] += 0 if s.takes_sums else n * fwd
            out["gn_apply"] += n * fwd
            out["gn_bwd_sums"] += n * bwd
            out["gn_bwd_apply"] += n * bwd
    return out
