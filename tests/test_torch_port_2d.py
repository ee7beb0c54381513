"""The port's 2D model family against the JAX package on the CPU, f32, at a
small size (16^2, chs (8, 16, 16, 16), norm_groups 4, batch 2): the 2D CUNet's
eps_hat, the VDM's loss and every parameter gradient, the SFM's with the
bottleneck attention, one and two train steps, the VDM, SFM and DDNM
samplers, the 2D convolutions and resampling, and the CLI on the
``smoke_vdm_2d`` preset. Both sides get the same seeded numpy parameters
(``randomize_tree``, converted by ``params_from_jax``) and inputs; the JAX
side runs as its CPU tests run it (XLA convolutions, the XLA GroupNorm
composition), the port its plain versions. Times and noise are the JAX
side's own draws, handed to the port through ``t=``, ``eps=`` and
``noise=``; dropout is off on both sides, as the two frameworks' masks
cannot agree.

Tolerances are those of the 3D tests of the same functions (f32 sums in
another order): eps_hat 1e-4 absolute (``test_torch_port_cunet.py``); the
convolutions and resampling 1e-5 absolute on O(1) values; loss 1e-5 and
parameter gradients 1e-4 relative to max(1, max |ref|), after one and two
train steps params, second moments and EMA 1e-5 absolute
(``test_torch_port_train.py``, ``test_torch_port_sfm.py``); the SFM
samplers 1e-4 relative to max(1, max |ref|) (``test_torch_port_sfm.py``);
the VDM sampler 1e-3 relative + 1e-3 absolute after four steps from t = 1,
where x0t divides by alpha_1 ~ 1.3e-3 (``test_torch_port_vdm.py``); DDNM
1e-4 relative on a narrow schedule (``test_torch_port_ddnm.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import ddnm_sample as jddnm_sample
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.diffusion.schedule import alpha_sigma as jalpha_sigma
from vdm4cdm_tpu.flows import SFM as JSFM
from vdm4cdm_tpu.models import CUNet as JCUNet
from vdm4cdm_tpu.ops.conv import conv_nd as jconv_nd
from vdm4cdm_tpu.ops.resample import upsample_nearest as jupsample
from vdm4cdm_tpu.train import TrainState as JTrainState
from vdm4cdm_tpu.train import make_optimizer as jmake_optimizer
from vdm4cdm_tpu.train import make_train_step as jmake_train_step

import vdm4cdm_torch as vt
from vdm4cdm_torch.cli import generate, train
from vdm4cdm_torch.diffusion.vdm import VDM
from vdm4cdm_torch.ops import conv as ops_conv
from vdm4cdm_torch.ops import norm as ops_norm
from vdm4cdm_torch.ops.resample import upsample_nearest
from vdm4cdm_torch.parallel.halo import ShardCtx
from vdm4cdm_torch.train.checkpoint import CheckpointManager

N = 16
B = 2
SHAPE = (1, N, N)


def _kw(padding="circular", mid_attn=False, s_channels=1, v_dims=(6,)):
    return dict(shape=SHAPE, chs=(8, 16, 16, 16),
                s_conditioning_channels=s_channels,
                v_conditioning_dims=v_dims, norm_groups=4, mid_attn=mid_attn,
                dropout_prob=0.0, conv_padding_mode=padding)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The module's torch work is small; two threads keep it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _vdm_pair(seed, schedule=("learned_linear", -13.3, 13.3), **kw):
    jv = JVDM(JCUNet(**_kw(**kw)), jmake_schedule(*schedule))
    tree = seeded_tree(jv, seed)
    tv = vt.VDM(vt.CUNet(**_kw(**kw), device="cpu"),
                vt.make_schedule(*schedule, device="cpu"))
    tv.load_state_dict(vt.params_from_jax(tree, tv), strict=False)
    return jv, tree, tv


def _sfm_pair(seed, sigma=0.0):
    kw = _kw("zeros", mid_attn=True)
    js = JSFM(JCUNet(**kw), sigma=sigma)
    tree = seeded_tree(js, seed)
    ts = vt.SFM(vt.CUNet(**kw, device="cpu"), sigma=sigma)
    ts.load_state_dict(vt.params_from_jax(tree, ts))
    return js, tree, ts


def _vdm_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, N, N, 1)).astype(np.float32),
            "conditioning": rng.standard_normal((B, N, N, 1)).astype(
                np.float32),
            "conditioning_values": [rng.standard_normal((B, 6)).astype(
                np.float32)]}


def _sfm_batch(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, N, N, 1)).astype(np.float32)
    return {"x0": x0,
            "x1": (0.6 * x0 + 0.8 * rng.standard_normal(x0.shape)).astype(
                np.float32),
            "conditioning_values": [rng.standard_normal((B, 6)).astype(
                np.float32)]}


def _to_jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def _jax_loss_draws(key, shape):
    """t and eps as ``VDM.loss`` / ``SFM.loss`` of the JAX package draw them
    from key."""
    rng_t, rng_eps, _ = jax.random.split(key, 3)
    u0 = jax.random.uniform(rng_t, ())
    t = jnp.mod(u0 + jnp.arange(shape[0]) / shape[0], 1.0)
    eps = jax.random.normal(rng_eps, shape, jnp.float32)
    return np.array(t), np.array(eps)


# ------------------------------------------------------------ the UNet

@pytest.mark.parametrize("padding,mid_attn", [
    ("circular", False), ("circular", True), ("zeros", False),
    ("zeros", True)])
def test_eps_hat_matches_jax(padding, mid_attn):
    jv, tree, tv = _vdm_pair(1, padding=padding, mid_attn=mid_attn)
    b = _vdm_batch(2)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(jv.eps_hat)(
        tree, jnp.asarray(b["x"]), jnp.asarray(t),
        jnp.asarray(b["conditioning"]),
        [jnp.asarray(b["conditioning_values"][0])]))
    with torch.no_grad():
        got = tv.eps_hat(torch.from_numpy(b["x"]), torch.from_numpy(t),
                         torch.from_numpy(b["conditioning"]),
                         [torch.from_numpy(b["conditioning_values"][0])])
    assert got.dtype == torch.float32 and got.shape == (B, N, N, 1)
    assert np.abs(want).max() > 0.5  # far from the zero-init identity
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_2d_weights_take_the_2d_layout_and_fan_in():
    net = vt.CUNet(**_kw(), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert net.conv_in.kernel.shape == (3, 3, 2, 8)
    assert net.down_1_0.skip_proj.kernel.shape == (1, 1, 8, 16)
    assert net.downsample_0.kernel.shape == (3, 3, 8, 8)
    # LeCun-normal over k^2 * Cin inputs: the std of a 3x3 x 16 kernel
    std = net.down_2_0.Conv_0.kernel.std().item()
    assert abs(std * np.sqrt(9 * 16) - 1.0) < 0.1, std


def test_2d_cunet_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.CUNet(**_kw())
    cfg = vt.preset("smoke_vdm_2d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.build_model(cfg)


def test_2d_cunet_under_sp_sharding_raises():
    """A 2D net builds under a sharded ``ctx`` (its rows split over the
    ``sp`` ranks; ``test_torch_port_sharded_2d.py`` runs it): each rank's
    sample is its slab of H, a slab whose rows do not halve at every
    downsample raises before any collective, and a shape of neither rank
    still raises."""
    ctx = ShardCtx(group=object(), ranks=(0, 1))
    tv = vt.VDM(vt.CUNet(**_kw(), device="cpu", ctx=ctx),
                vt.make_schedule("learned_linear", device="cpu"))
    assert tv.score_model.ctx is ctx
    assert tv.local_sample_shape_nlast == (N // 2, N, 1)
    with pytest.raises(ValueError, match="do not divide by 8"):
        tv.eps_hat(torch.zeros(1, 4, N, 1), torch.zeros(1),
                   torch.zeros(1, 4, N, 1), [torch.zeros(1, 6)])
    # the CUNet checks the map's rows a rank as it builds: 24 / 2 rows do
    # not halve three times
    cfg = vt.preset("smoke_vdm_2d", **{"parallel.n_sp": 2})
    assert vt.build_model(cfg, device="cpu", ctx=ctx
                          ).local_sample_shape_nlast == (16, 32, 1)
    cfg.data.cropsize = 24
    with pytest.raises(ValueError, match="12 planes do not divide by 8"):
        vt.build_model(cfg, device="cpu", ctx=ctx)
    with pytest.raises(ValueError, match="shape"):
        vt.CUNet(**dict(_kw(), shape=(1, 8)), device="cpu")


def test_every_2d_norm_site_without_conv_sums_takes_its_own(monkeypatch):
    """A 2D conv is cuDNN's and emits no GroupNorm sums: every norm site,
    the ResBlocks' second norms included, runs the sums pass itself (the
    JAX monolith's sweep 0), over both halves of a decoder Pair."""
    calls = []
    real = ops_norm.gn_sums

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(ops_norm, "gn_sums", counted)
    _, _, tv = _vdm_pair(3, mid_attn=True)
    b = _to_torch(_vdm_batch(4))
    with torch.no_grad():
        tv.eps_hat(b["x"], torch.tensor([0.2, 0.6]), b["conditioning"],
                   b["conditioning_values"])
    net = tv.score_model
    n_blocks = len(list(net._block_levels()))
    n_pairs = len(net.chs) * (net.num_res_blocks + 1)
    # two norms a ResBlock, one a Pair half more at each decoder block's
    # first norm, the attention's, norm_out
    assert len(calls) == 2 * n_blocks + n_pairs + 2


@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, "circular"), (3, 1, "zeros"), (3, 2, "circular"),
    (3, 2, "zeros"), (1, 1, "zeros")])
def test_conv_nd_2d_matches_jax(k, stride, padding):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((k, k, 16, 24)) / np.sqrt(k * k * 16)).astype(
        np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jconv_nd(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), stride=stride,
                               padding_mode=padding))
    got = ops_conv.conv_nd(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride=stride,
                           padding_mode=padding)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pads", [(1, 1), (0, 1), (1, 1, 1), (0, 1, 1)])
def test_wrap_pad_is_a_circular_pad_with_its_gradient(pads):
    """The channels-last wrap pad against ``F.pad(mode="circular")`` of the
    NC* view, values and gradient (its adjoint folds the halo back)."""
    rng = np.random.default_rng(len(pads))
    shape = (2,) + (5,) * len(pads) + (3,)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x.requires_grad_(True)
    got = ops_conv.wrap_pad(x, pads)
    nd = len(pads)
    xc = x.permute(0, nd + 1, *range(1, nd + 1))
    pad = [p for q in reversed(pads) for p in (q, q)]
    want = F.pad(xc, pad, mode="circular").permute(
        0, *range(2, nd + 2), 1)
    assert torch.equal(got, want)
    ct = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    g_got, = torch.autograd.grad(got, x, ct)
    g_want, = torch.autograd.grad(want, x, ct)
    torch.testing.assert_close(g_got, g_want, rtol=0, atol=1e-5)


class _CudaLike:
    """Stands for a CUDA tensor in :func:`cudnn_settings`, which reads only
    ``is_cuda`` and ``dtype``."""
    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cudnn_settings_are_scoped_to_the_library_call(dtype):
    """Inside a library call on f32 CUDA operands cuDNN runs with TF32 off
    and in benchmark mode; bf16 operands leave both as the process has
    them. The process's settings come back after, also when the call
    raises. CPU operands change nothing."""
    cudnn = torch.backends.cudnn

    def tf32():
        return cudnn.conv.fp32_precision

    before = (cudnn.benchmark, tf32())
    with ops_conv.cudnn_settings(_CudaLike(dtype)):
        f32 = dtype == torch.float32
        assert (cudnn.benchmark, tf32() == "ieee") == (
            (True, True) if f32 else (before[0], before[1] == "ieee"))
    assert (cudnn.benchmark, tf32()) == before
    with pytest.raises(RuntimeError, match="inside"):
        with ops_conv.cudnn_settings(_CudaLike(dtype)):
            raise RuntimeError("inside")
    assert (cudnn.benchmark, tf32()) == before
    with ops_conv.cudnn_settings(torch.zeros(1)):
        assert (cudnn.benchmark, tf32()) == before


@pytest.mark.parametrize("shape", [(2, 4, 6, 3), (1, 3, 4, 5, 2)])
def test_upsample_nearest_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jupsample(jnp.asarray(x)))
    got = upsample_nearest(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_library_conv_gradients_match_autograd():
    """The library conv's own backward (one ``convolution_backward`` call
    for dx, dw and db, the bias added in the conv) against autograd through
    ``F.conv2d`` of the circularly padded input and a separate bias add."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) / 8).astype(
        np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(16).astype(
        np.float32)).requires_grad_(True)
    ct = torch.from_numpy(rng.standard_normal((2, 4, 4, 16)).astype(
        np.float32))
    out = ops_conv.conv_nd(x, w, b, stride=2, padding_mode="circular")
    got = torch.autograd.grad(out, (x, w, b), ct)
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="circular")
    ref = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)
    ref = ref + b
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    want = torch.autograd.grad(ref, (x, w, b), ct)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


# ------------------------------------------------------- loss, gradients

def test_vdm_loss_and_param_grads_match_jax():
    jv, tree, tv = _vdm_pair(21, mid_attn=True)
    batch = _vdm_batch(22)
    key = jax.random.PRNGKey(5)
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda l: (l.loss, l))(jv.loss(p, _to_jax(batch), key,
                                                   train=True)),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    t, eps = _jax_loss_draws(key, batch["x"].shape)
    got = tv.loss(_to_torch(batch), train=True, t=torch.from_numpy(t),
                  eps=torch.from_numpy(eps))
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), 1e-5)
    got.loss.backward()
    want_grads = vt.params_from_jax(_np(jgrads), tv)
    for name, p in tv.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want_grads[name].numpy(), 1e-4)


def test_sfm_loss_and_param_grads_match_jax_with_attention():
    js, tree, ts = _sfm_pair(31, sigma=0.5)
    batch = _sfm_batch(32)
    key = jax.random.PRNGKey(6)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: js.loss(p, _to_jax(batch), key, train=True).loss))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    t, eps = _jax_loss_draws(key, batch["x0"].shape)
    got = ts.loss(_to_torch(batch), train=True, t=torch.from_numpy(t),
                  eps=torch.from_numpy(eps))
    _close(got.loss, want, 1e-5)
    got.loss.backward()
    want_grads = vt.params_from_jax(_np(jgrads), ts)
    assert any(k.startswith("unet.mid_attn_block.") for k in want_grads)
    for name, p in ts.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want_grads[name].numpy(), 1e-4)


def test_vdm_train_steps_match_jax():
    """One and two 2D train steps from the same converted params, optimizer
    state and EMA (f32 moments, clipping on, weight decay, a warm-up)."""
    jv, tree, tv = _vdm_pair(23)
    batch = _vdm_batch(24)
    hyper = dict(learning_rate=1e-3, grad_clip=0.5, weight_decay=0.01,
                 warmup_steps=2)
    jopt = jmake_optimizer(**hyper)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = JTrainState(0, jparams, jopt.init(jparams),
                         jax.tree_util.tree_map(jnp.array, jparams))
    jstep = jmake_train_step(jv, jopt, ema_decay=0.9)
    topt = vt.make_optimizer(**hyper)
    tstate = vt.TrainState(0, tv, vt.opt_state_from_jax(
        _np(jstate.opt_state), tv), vt.params_from_jax(tree, tv))
    tstep = vt.make_train_step(tv, topt, ema_decay=0.9)
    key = jax.random.PRNGKey(7)
    for i in range(2):
        k = jax.random.fold_in(key, i)
        t, eps = _jax_loss_draws(k, batch["x"].shape)
        jstate, jmetrics = jstep(jstate, _to_jax(batch), k)
        tv.loss = lambda b, g, train=True, dropout_seed=None: VDM.loss(
            tv, b, g, train, t=torch.from_numpy(t),
            eps=torch.from_numpy(eps), dropout_seed=dropout_seed)
        tstate, tmetrics = tstep(tstate, _to_torch(batch),
                                 torch.Generator().manual_seed(0))
        assert tstate.step == i + 1
        for name in jmetrics:
            _close(tmetrics[name], jmetrics[name], 1e-4)
        want_p = vt.params_from_jax(_np(jstate.params), tv)
        want_e = vt.params_from_jax(_np(jstate.ema_params), tv)
        want_o = vt.opt_state_from_jax(_np(jstate.opt_state), tv)
        for name, p in tv.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_p[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(tstate.ema_params[name].numpy(),
                                       want_e[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(
                tstate.opt_state["nu"][name].numpy(),
                want_o["nu"][name].numpy(), rtol=1e-4, atol=1e-9,
                err_msg=name)


def test_train_step_with_dropout_on_a_2d_grf_batch():
    """The preset's own data: a GRF batch of ``train_uc_c`` (6 values, no
    field conditioning) cut to 16^2, dropout 0.1, two reproducible steps
    through ``Trainer``'s step function."""
    cfg = vt.preset("train_uc_c", **{"data.kind": "grf",
                                     "data.cropsize": N,
                                     "data.batch_size": B,
                                     "model.chs": (8, 16, 16, 16),
                                     "model.norm_groups": 4})
    batch = next(vt.build_datamodule(cfg).train_batches(1))
    losses = []
    for seed in (1, 1, 2):
        model = vt.build_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
        assert model.score_model.s_conditioning_channels == 0
        assert model.score_model.dropout_prob == 0.1
        opt = vt.make_optimizer()
        state = vt.TrainState(0, model, opt.init(model), vt.init_ema(model))
        step = vt.make_train_step(model, opt, ema_decay=0.99)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            state, metrics = step(state, _to_torch(batch), gen)
        assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] and losses[0] != losses[2]


# --------------------------------------------------------------- samplers

def test_vdm_draw_samples_with_injected_noise_matches_jax_loop():
    jv, tree, tv = _vdm_pair(11)
    b = _vdm_batch(12)
    s, v = b["conditioning"][:1], b["conditioning_values"][0][:1]
    n = 4
    rng = np.random.default_rng(15)
    z0 = rng.standard_normal((1, N, N, 1)).astype(np.float32)
    eps = rng.standard_normal((n, 1, N, N, 1)).astype(np.float32)
    steps = jnp.linspace(1.0, 0.0, n + 1)
    z = jnp.asarray(z0)
    coeffs = jax.jit(jv.ddnm_coeffs)
    for i in range(n):
        w_z, w_x0t, x0t, scale = coeffs(
            tree, z, steps[i], steps[i + 1], jnp.asarray(s), [jnp.asarray(v)])
        z = w_z * z + w_x0t * x0t + scale * jnp.asarray(eps[i])
    a0, _ = jalpha_sigma(jv.gamma(tree, jnp.float32(0.0)))
    want = np.asarray(z / a0)
    got = tv.draw_samples(batch_size=1, n_sampling_steps=n,
                          s_conditioning=torch.from_numpy(s),
                          v_conditionings=[torch.from_numpy(v)],
                          noise=(torch.from_numpy(z0), torch.from_numpy(eps)))
    assert got.shape == (1, N, N, 1) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("method", ["euler", "heun", "sde"])
def test_sfm_samplers_match_jax(method):
    """euler and heun from x0 (sigma 0); sde with sigma 0.5 and the JAX
    side's noise (its start point's and every step's)."""
    sigma = 0.5 if method == "sde" else 0.0
    js, tree, ts = _sfm_pair(33, sigma)
    batch = _sfm_batch(34)
    n = 3
    key = jax.random.PRNGKey(9)
    kw = dict(rng=key) if method == "sde" else {}
    want = js.draw_samples(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(batch["x0"]),
        n_sampling_steps=n,
        v_conditionings=_to_jax(batch["conditioning_values"]), method=method,
        **kw)
    noise = None
    if method == "sde":
        rng, rng_ic = jax.random.split(key)
        shape = batch["x0"].shape
        noise = (torch.from_numpy(np.array(jax.random.normal(
            rng_ic, shape, jnp.float32))),
            [torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(rng, i), shape, jnp.float32)))
             for i in range(n)])
    got = ts.draw_samples(torch.from_numpy(batch["x0"]), n,
                          _to_torch(batch["conditioning_values"]),
                          method=method, noise=noise)
    assert got.shape == (B, N, N, 1) and torch.isfinite(got).all()
    _close(got, want, 1e-4)


def test_ddnm_sample_matches_jax():
    jv, tree, tv = _vdm_pair(51, schedule=("fixed_linear", -4.0, 4.0))
    rng = np.random.default_rng(52)
    shape = (1, N, N, 1)
    x, s = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 6)).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[:, : N // 2] = 1.0
    n, l = 4, 2
    key = jax.random.PRNGKey(123)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    want = jddnm_sample(
        jv, jax.tree_util.tree_map(jnp.asarray, tree), key,
        jnp.asarray(x * mask), lambda z: z * jmask, lambda z: z * jmask,
        n_sampling_steps=n, l=l, s_conditioning=jnp.asarray(s),
        v_conditionings=[jnp.asarray(v)])
    # the normals the JAX function draws, in order: z, then per outer step
    # one re-noising key and L_i + 1 eps keys, each split off the running key
    k, rz = jax.random.split(key)
    noise = [jax.random.normal(rz, shape, jnp.float32)]
    for li in np.minimum(np.full(n, l), np.arange(n)).tolist():
        for _ in range(li + 2):
            k, sub = jax.random.split(k)
            noise.append(jax.random.normal(sub, shape, jnp.float32))
    got = vt.ddnm_sample(
        tv, torch.from_numpy(x * mask), lambda z: z * tmask,
        lambda z: z * tmask, n_sampling_steps=n, l=l,
        s_conditioning=torch.from_numpy(s),
        v_conditionings=[torch.from_numpy(v)],
        noise=iter(torch.from_numpy(np.array(a)) for a in noise))
    assert got.shape == shape and torch.isfinite(got).all()
    _close(got.numpy(), np.asarray(want), 1e-4)


# -------------------------------------------------------------------- CLI

SMOKE = "smoke_vdm_2d"
SMOKE_SET = ["data.cropsize=16", "model.chs=(8,8,8,8)",
             "model.norm_groups=4"]


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """``smoke_vdm_2d`` trained 2 steps, then resumed to 3, through the
    CLI on the CPU."""
    out = tmp_path_factory.mktemp("runs2d")
    args = ["--preset", SMOKE, "--device", "cpu", "--set", *SMOKE_SET,
            f"run.out_dir={out}", "run.ckpt_every_steps=2",
            "run.val_check_interval=2", "run.n_val_batches=1",
            "run.log_every_steps=1", "run.n_figure_sampling_steps=2"]
    assert train.main(args + ["run.max_steps=2"]) == 0
    assert train.main(args + ["run.max_steps=3"]) == 0
    return out / SMOKE


def test_cli_trains_and_resumes_the_2d_smoke_preset(smoke_run, capsys):
    assert CheckpointManager(str(smoke_run / "checkpoints")).all_steps() \
        == [2, 3]
    lines = (smoke_run / "metrics.csv").read_text().splitlines()
    header = lines[0].split(",")
    steps = [int(line.split(",")[0]) for line in lines[1:]
             if line.split(",")[header.index("loss")]]
    assert steps == [1, 2, 3]


def test_cli_generates_2d_fields(smoke_run, tmp_path):
    out = tmp_path / "CV_12_12"
    assert generate.main([SMOKE, str(out), "CV_12_12", "--ckpt-dir",
                          str(smoke_run / "checkpoints"), "--device", "cpu",
                          "--n-sampling-steps", "2", "--reps-per-batch",
                          "4", "--set", *SMOKE_SET]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(f"gen_{i}.npy" for i in range(12))
    for name in names:
        a = np.load(out / name)
        assert a.shape == (12, 1, 16, 16) and a.dtype == np.float32
        assert np.isfinite(a).all() and float(a.std()) > 0
