"""The port's SFM (loss, gradients, the three samplers, the train step) against
the JAX package on the CPU, f32, at a small size (chs (8, 16), 8^3, batch 2,
x0 fed as the spatial conditioning channel, 6 conditioning values). Both
sides get the same seeded numpy parameters and batch; times and noise are the
JAX side's own draws (``jax.random`` on the keys as ``SFM.loss`` and
``SFM.draw_samples`` split and fold them), handed to the port through ``t=``,
``eps=`` and ``noise=``; dropout is off on both sides (``dropout_prob=0``), as
the two frameworks' masks cannot agree.

Tolerances (f32 sums in another order): loss 1e-5 and parameter gradients
1e-4 relative to max(1, max |ref|); samplers 1e-4 relative to
max(1, max |ref|) after 4 steps; after one and two train steps params,
second moments and EMA 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.flows import SFM as JSFM
from vdm4cdm_tpu.models import CUNet as JCUNet
from vdm4cdm_tpu.train import TrainState as JTrainState
from vdm4cdm_tpu.train import make_optimizer as jmake_optimizer
from vdm4cdm_tpu.train import make_train_step as jmake_train_step

import vdm4cdm_torch as vt
from vdm4cdm_torch.flows.sfm import SFM


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two threads for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


KW = dict(shape=(1, 8, 8, 8), chs=(8, 16), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.0, conv_padding_mode="zeros")
B, N_STEPS = 2, 4


def _jax_model(sigma, **kw):
    return JSFM(JCUNet(**dict(KW, **kw)), sigma=sigma)


def _tree(js, seed=31):
    return seeded_tree(js, seed)


def _torch_model(tree, sigma, **kw):
    ts = vt.SFM(vt.CUNet(**dict(KW, **kw), device="cpu"), sigma=sigma)
    ts.load_state_dict(vt.params_from_jax(tree, ts))
    return ts


def _batch(seed=32):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, 8, 8, 8, 1)).astype(np.float32)
    return {
        "x0": x0,
        "x1": (0.6 * x0 + 0.8 * rng.standard_normal(x0.shape)).astype(
            np.float32),
        "conditioning_values": [rng.standard_normal((B, 6)).astype(
            np.float32)],
    }


def _to_jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def _jax_loss_draws(key, shape):
    """t (before the clip) and eps as the JAX ``SFM.loss`` draws them."""
    rng_t, rng_eps, _ = jax.random.split(key, 3)
    u0 = jax.random.uniform(rng_t, ())
    t = jnp.mod(u0 + jnp.arange(shape[0]) / shape[0], 1.0)
    eps = jax.random.normal(rng_eps, shape, jnp.float32)
    return np.array(t), np.array(eps)


def _close(got, want, tol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def test_state_dict_sits_under_unet_and_maps_from_the_jax_tree():
    js = _jax_model(0.0)
    tree = _tree(js)
    ts = _torch_model(tree, 0.0)
    assert all(k.startswith("unet.") for k in ts.state_dict())
    assert ts.sample_shape_nlast == js.sample_shape_nlast == (8, 8, 8, 1)
    assert ts.velocity_model is ts.unet
    with pytest.raises(KeyError, match="missing"):
        vt.params_from_jax({"unet": {k: v for k, v in tree["unet"].items()
                                     if k != "conv_in"}}, ts)
    with pytest.raises(KeyError, match="unknown top-level"):
        vt.params_from_jax({"unet": tree["unet"], "extra": {"w": 1.0}}, ts)


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("train", [False, True])
def test_loss_and_param_grads_match_jax(sigma, train):
    js = _jax_model(sigma)
    tree = _tree(js)
    batch = _batch()
    key = jax.random.PRNGKey(5)
    want, jgrads = jax.value_and_grad(
        lambda p: js.loss(p, _to_jax(batch), key, train=train).loss)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    t, eps = _jax_loss_draws(key, batch["x0"].shape)

    ts = _torch_model(tree, sigma)
    got = ts.loss(_to_torch(batch), train=train, t=torch.from_numpy(t),
                  eps=torch.from_numpy(eps))
    assert isinstance(got, vt.SFMLosses) and got._fields == ("loss",)
    _close(got.loss, want, 1e-5)
    got.loss.backward()
    want_grads = vt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), ts)
    for name, p in ts.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want_grads[name].numpy(), 1e-4)


@pytest.mark.parametrize("remat_kw", [
    dict(remat=True), dict(remat=True, remat_levels=1),
    dict(remat_blocks=("down_0_0", "mid_1"))],
    ids=["remat", "remat_levels_1", "remat_blocks"])
def test_remat_loss_and_param_grads_match_jax_remat(remat_kw):
    """Both sides rematerialize the same ResBlocks (the JAX CUNet through
    ``nn.remat``, the port through ``torch.utils.checkpoint``) on the same
    params and batch: the loss within 1e-5 and every gradient within 1e-4."""
    js = _jax_model(0.5, **remat_kw)
    tree = _tree(js, 43)
    batch = _batch(44)
    key = jax.random.PRNGKey(11)
    want, jgrads = jax.value_and_grad(
        lambda p: js.loss(p, _to_jax(batch), key, train=True).loss)(
            jax.tree_util.tree_map(jnp.asarray, tree))
    t, eps = _jax_loss_draws(key, batch["x0"].shape)

    ts = _torch_model(tree, 0.5, **remat_kw)
    assert ts.unet.remat_block_names()
    entered = []
    getattr(ts.unet, ts.unet.remat_block_names()[0]).register_forward_pre_hook(
        lambda *a: entered.append(1))
    got = ts.loss(_to_torch(batch), train=True, t=torch.from_numpy(t),
                  eps=torch.from_numpy(eps))
    _close(got.loss, want, 1e-5)
    got.loss.backward()
    assert len(entered) == 2  # the forward, and its recomputation
    want_grads = vt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), ts)
    for name, p in ts.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want_grads[name].numpy(), 1e-4)


def test_loss_clips_t_and_feeds_x0_as_spatial_conditioning():
    tree = _tree(_jax_model(0.5))
    ts = _torch_model(tree, 0.5)
    batch = _to_torch(_batch())
    eps = torch.zeros(B, 8, 8, 8, 1)
    a = ts.loss(batch, train=False, t=torch.tensor([0.0, 1.0]), eps=eps)
    b = ts.loss(batch, train=False,
                t=torch.tensor([ts.t_eps, 1.0 - ts.t_eps]), eps=eps)
    assert torch.isfinite(a.loss) and torch.equal(a.loss, b.loss)
    other = dict(batch, x0=batch["x0"] + 1.0)
    assert ts._s_cond(batch["x0"]) is batch["x0"]
    assert not torch.equal(
        ts.loss(other, train=False, t=torch.tensor([0.3, 0.8]),
                eps=eps).loss,
        ts.loss(batch, train=False, t=torch.tensor([0.3, 0.8]),
                eps=eps).loss)
    # a net without s channels gets no spatial conditioning
    kw = dict(KW, s_conditioning_channels=0)
    assert SFM(vt.CUNet(**kw, device="cpu"))._s_cond(batch["x0"]) is None


def test_loss_draws_from_generator():
    ts = _torch_model(_tree(_jax_model(0.5)), 0.5)
    batch = _to_torch(_batch())
    a = ts.loss(batch, torch.Generator().manual_seed(3), train=False)
    b = ts.loss(batch, torch.Generator().manual_seed(3), train=False)
    c = ts.loss(batch, torch.Generator().manual_seed(4), train=False)
    assert torch.equal(a.loss, b.loss) and not torch.equal(a.loss, c.loss)
    with pytest.raises(ValueError, match="Generator"):
        ts.loss(batch, None)
    with pytest.raises(ValueError, match="Generator"):
        ts.loss(batch, None, t=torch.tensor([0.2, 0.7]))  # sigma > 0: eps
    out = vt.make_eval_step(ts)(batch, torch.Generator().manual_seed(3))
    assert set(out) == {"loss"} and torch.equal(out["loss"], a.loss)
    assert not out["loss"].requires_grad


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_deterministic_samplers_match_jax(method):
    js = _jax_model(0.0)
    tree = _tree(js, 33)
    batch = _batch(34)
    want = js.draw_samples(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(batch["x0"]),
        n_sampling_steps=N_STEPS,
        v_conditionings=_to_jax(batch["conditioning_values"]), method=method)
    ts = _torch_model(tree, 0.0)
    got = ts.draw_samples(torch.from_numpy(batch["x0"]), N_STEPS,
                          _to_torch(batch["conditioning_values"]),
                          method=method)
    assert torch.isfinite(got).all() and not got.requires_grad
    _close(got, want, 1e-4)


@pytest.mark.parametrize("method", ["euler", "heun", "sde"])
def test_stochastic_start_and_sde_match_jax_with_injected_noise(method):
    """sigma > 0 and a noise source: the start point is noised, the time
    grid is warped, and ``sde`` adds each step's noise. The noise is what the
    JAX side draws from its key (``split`` for the start, ``fold_in(rng, i)``
    per step)."""
    js = _jax_model(0.5)
    tree = _tree(js, 35)
    batch = _batch(36)
    key = jax.random.PRNGKey(9)
    want = js.draw_samples(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(batch["x0"]),
        n_sampling_steps=N_STEPS,
        v_conditionings=_to_jax(batch["conditioning_values"]), method=method,
        rng=key, churn=0.7)
    rng, rng_ic = jax.random.split(key)
    shape = batch["x0"].shape
    eps_start = np.array(jax.random.normal(rng_ic, shape, jnp.float32))
    eps_steps = None
    if method == "sde":
        eps_steps = [torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(rng, i), shape, jnp.float32)))
            for i in range(N_STEPS)]
    ts = _torch_model(tree, 0.5)
    got = ts.draw_samples(torch.from_numpy(batch["x0"]), N_STEPS,
                          _to_torch(batch["conditioning_values"]),
                          method=method, churn=0.7,
                          noise=(torch.from_numpy(eps_start), eps_steps))
    _close(got, want, 1e-4)
    # the noise matters: without it the deterministic path starts at x0
    plain = ts.draw_samples(torch.from_numpy(batch["x0"]), N_STEPS,
                            _to_torch(batch["conditioning_values"]),
                            method="euler")
    assert (got - plain).abs().max() > 1e-3


def test_sampler_argument_checks_and_generator_noise():
    tree = _tree(_jax_model(0.0), 37)
    batch = _to_torch(_batch(38))
    x0, v = batch["x0"], batch["conditioning_values"]
    det = _torch_model(tree, 0.0)
    with pytest.raises(ValueError, match="sigma > 0"):
        det.draw_samples(x0, 2, v, method="sde",
                         generator=torch.Generator().manual_seed(0))
    sto = _torch_model(tree, 0.5)
    with pytest.raises(ValueError, match="sigma > 0"):
        sto.draw_samples(x0, 2, v, method="sde")  # no noise source
    with pytest.raises(ValueError, match="step noises"):
        sto.draw_samples(x0, 2, v, method="sde", noise=(x0, [x0]))
    with pytest.raises(ValueError, match="unknown method"):
        sto.draw_samples(x0, 2, v, method="rk4")
    a = sto.draw_samples(x0, 2, v, method="sde",
                         generator=torch.Generator().manual_seed(1))
    b = sto.draw_samples(x0, 2, v, method="sde",
                         generator=torch.Generator().manual_seed(1))
    c = sto.draw_samples(x0, 2, v, method="sde",
                         generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    # a generator with sigma = 0 changes nothing: the ODE from x0 itself
    assert torch.equal(
        det.draw_samples(x0, 2, v, generator=torch.Generator().manual_seed(1)),
        det.draw_samples(x0, 2, v))


@pytest.mark.parametrize("sigma", [0.0, 0.5])
def test_train_steps_match_jax(sigma):
    """One and two steps of an SFM from the same converted params, optimizer
    state and EMA, with weight decay and a warm-up so that every term is
    live."""
    js = _jax_model(sigma)
    tree = _tree(js, 39)
    batch = _batch(40)
    hyper = dict(learning_rate=1e-3, grad_clip=0.5, weight_decay=0.01,
                 warmup_steps=2)
    jopt = jmake_optimizer(**hyper)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = JTrainState(0, jparams, jopt.init(jparams),
                         jax.tree_util.tree_map(jnp.array, jparams))
    jstep = jmake_train_step(js, jopt, ema_decay=0.9)

    ts = _torch_model(tree, sigma)
    topt = vt.make_optimizer(**hyper)
    opt_state = vt.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state), ts)
    assert opt_state["count"] == 0 and set(opt_state["mu"]) == set(
        dict(ts.named_parameters()))
    tstate = vt.TrainState(0, ts, opt_state, vt.params_from_jax(tree, ts))
    tstep = vt.make_train_step(ts, topt, ema_decay=0.9)

    key = jax.random.PRNGKey(7)
    as_np = lambda tr: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), tr)
    for i in range(2):
        k = jax.random.fold_in(key, i)
        t, eps = _jax_loss_draws(k, batch["x0"].shape)
        jstate, jmetrics = jstep(jstate, _to_jax(batch), k)
        # inject this step's draws; the step itself passes the dropout seed
        ts.loss = lambda b, g, train=True, dropout_seed=None: SFM.loss(
            ts, b, g, train, t=torch.from_numpy(t),
            eps=torch.from_numpy(eps), dropout_seed=dropout_seed)
        tstate, tmetrics = tstep(tstate, _to_torch(batch),
                                 torch.Generator().manual_seed(0))
        assert tstate.step == i + 1 and tstate.opt_state["count"] == i + 1
        assert set(tmetrics) == set(jmetrics) == {"loss", "grad_norm"}
        for name in jmetrics:
            _close(tmetrics[name], jmetrics[name], 1e-4)
        want_p = vt.params_from_jax(as_np(jstate.params), ts)
        want_e = vt.params_from_jax(as_np(jstate.ema_params), ts)
        want_o = vt.opt_state_from_jax(as_np(jstate.opt_state), ts)
        for name, p in ts.named_parameters():
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
            np.testing.assert_allclose(
                tstate.opt_state["mu"][name].numpy(),
                want_o["mu"][name].numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_train_step_with_dropout_is_reproducible():
    tree = _tree(_jax_model(0.5), 41)
    losses = []
    for seed in (1, 1, 2):
        ts = _torch_model(tree, 0.5, dropout_prob=0.3)
        opt = vt.make_optimizer()
        state = vt.TrainState(0, ts, opt.init(ts), vt.init_ema(ts))
        step = vt.make_train_step(ts, opt, ema_decay=0.99)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            state, metrics = step(state, _to_torch(_batch(42)), gen)
        assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] and losses[0] != losses[2]
