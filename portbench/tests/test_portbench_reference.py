"""The plain reference agrees with the port at a tiny size on the CPU, where
the port runs its kernels' plain versions: the UNet with and without
dropout, the loss, a sampler step, the dropout mask and three train steps."""

import pytest
import torch

import vdm4cdm_torch as vt
from vdm4cdm_torch.ops.kernels.philox import keep_mask_plain
from vdm4cdm_torch.ops.kernels.philox import mix_seed as port_mix_seed

from portbench import harness
from portbench.kinds import train
from portbench.reference import cunet, philox, vdm

TOL = 1e-5  # f32 on both sides: rounding of sums in another order


def _pair(nd, in_field, padding):
    """The port's f32 model and the reference's arch and weights at 16^nd,
    widths (8, 16, 16, 16), with random weights made as the harness makes
    them."""
    name = "trainVDM3D192_c_c" if nd == 3 else "train_uc_c"
    cfg = vt.preset(name, **{"data.cropsize": 16,
                             "model.chs": (8, 16, 16, 16),
                             "model.compute_dtype": "float32",
                             "data.in_field": in_field,
                             "data.kind": ("grf" if padding == "circular"
                                           else "camels")})
    file = {"padding": padding, "config": cfg.to_dict()}
    model = harness.build(file, torch.device("cpu"))
    weights = harness.make_weights(model, file, 7, "cpu")
    return model, cunet.Arch.from_config(file), weights


def _inputs(arch, batch=2, seed=3):
    g = torch.Generator().manual_seed(seed)
    shape = (batch,) + (arch.size,) * arch.ndim
    z = torch.randn(shape + (1,), generator=g)
    s = torch.randn(shape + (1,), generator=g) if arch.s_channels else None
    v = [torch.rand(batch, 6, generator=g)]
    t = torch.rand(batch, generator=g)
    return z, s, v, t


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("nd,in_field,padding",
                         [(3, "Mstar", "zeros"), (2, None, "circular")])
@pytest.mark.parametrize("dropout", [False, True])
def test_the_unet_agrees_with_the_port(nd, in_field, padding, dropout):
    model, arch, w = _pair(nd, in_field, padding)
    z, s, v, t = _inputs(arch)
    seed = 12345 if dropout else None
    with torch.no_grad():
        got = model.score_model(z, t, s, v, train=dropout,
                                dropout_seed=seed)
        want = cunet.unet(arch, w, z, t, s, v, "f32", dropout_seed=seed)
    assert _rel(got, want) < TOL


def test_the_loss_and_a_sampler_step_agree_with_the_port():
    model, arch, w = _pair(3, "Mstar", "zeros")
    x, s, v, t = _inputs(arch)
    eps = torch.randn_like(x)
    batch = {"x": x, "conditioning": s, "conditioning_values": v}
    got = model.loss(batch, train=True, t=t, eps=eps, dropout_seed=99).loss
    want = vdm.loss(arch, w, batch, t, eps, "f32", dropout_seed=99)
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) / abs(want) < TOL
    with torch.no_grad():
        z_s = model.sample_zs_given_zt(x, 0.6, 0.596, s_conditioning=s,
                                       v_conditionings=v, eps=eps)
        ref, _, _ = vdm.sampler_step(arch, w, x, 0.6, 0.596, eps, s, v,
                                     "f32")
    assert _rel(z_s, ref) < TOL


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 5, 2 ** 64 - 3])
def test_the_mask_is_the_ports(seed):
    assert philox.mix_seed(seed, 7) == port_mix_seed(seed, 7)
    shape = (2, 37, 24)
    assert torch.equal(philox.keep_mask(seed, shape, 0.1, "cpu"),
                       keep_mask_plain(seed, shape, 0.1, "cpu"))


@pytest.mark.parametrize("ema_decay", [0.0, 0.999])
def test_three_train_steps_agree_with_the_port(ema_decay):
    """The harness's f32 run of the port's train step against the
    reference's steps from the same weights, batches and seeds: the
    configuration's step without an EMA, and with one."""
    from _portbench_cells import tiny_cell

    cell = tiny_cell("vdm3d192.train_b2")
    cell.config["config"]["model"]["compute_dtype"] = "float32"
    cell.config["config"]["run"]["ema_decay"] = ema_decay
    work = train.Work(cell.config, cell.traffic, 2 ** 33 + 1, "cpu")
    work.setup()
    numbers = work.numbers()
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4 and numbers["grad_med_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-3
    assert ("ema_gap" in numbers) == (ema_decay > 0)
    if ema_decay:
        assert numbers["ema_gap"] < 1e-3
