"""The port's ``VDM.loss``, its parameter gradients and its train step against
the JAX package on the CPU, f32, at a small size (2 levels, chs (8, 16), 8^3,
batch 2). Both sides get the same seeded numpy parameters and batch; the
times and the noise are the JAX side's own draws (``jax.random`` on the step's
key, as ``VDM.loss`` splits it) handed to the port through ``t=`` and
``eps=``; dropout is off on both sides (``dropout_prob=0``, ``train=True``),
as the two frameworks' masks cannot agree.

Tolerances: loss fields 1e-5 and parameter gradients 1e-4, both relative to
max(1, max |ref|) (f32 sums in another order); after one and two train steps
params, second moments and EMA 1e-5 absolute, ``grad_norm`` 1e-4 relative; an
f32 first moment 1e-5 absolute, a bf16 one to two bf16 ulps of the tensor's
largest value (2^-7 max |ref|): both sides round their f32 value to bf16 on
store, an f32 difference in the last bit can flip that rounding, and the
second step's 0.9 mu + 0.1 g can cancel down to the size of that flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.models import CUNet as JCUNet
from vdm4cdm_tpu.train import TrainState as JTrainState
from vdm4cdm_tpu.train import make_optimizer as jmake_optimizer
from vdm4cdm_tpu.train import make_train_step as jmake_train_step

import vdm4cdm_torch as vt
from vdm4cdm_torch.diffusion.vdm import VDM

KW = dict(shape=(1, 8, 8, 8), chs=(8, 16), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.0, conv_padding_mode="circular")
B = 2


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The module's torch work is small; two threads keep it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_model():
    return JVDM(JCUNet(**KW), jmake_schedule("learned_linear", -13.3, 13.3))


def _tree(jv, seed=21):
    return seeded_tree(jv, seed)


def _torch_model(tree):
    tv = vt.VDM(vt.CUNet(**KW, device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    tv.load_state_dict(vt.params_from_jax(tree, tv))
    return tv


def _batch(seed=22):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, 8, 8, 8, 1)).astype(np.float32),
        "conditioning": rng.standard_normal((B, 8, 8, 8, 1)).astype(
            np.float32),
        "conditioning_values": [rng.standard_normal((B, 6)).astype(
            np.float32)],
    }


def _to_jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def _jax_draws(key, shape):
    """t and eps as ``VDM.loss`` of the JAX package draws them from key."""
    rng_t, rng_eps, _ = jax.random.split(key, 3)
    u0 = jax.random.uniform(rng_t, ())
    t = jnp.mod(u0 + jnp.arange(shape[0]) / shape[0], 1.0)
    eps = jax.random.normal(rng_eps, shape, jnp.float32)
    return np.array(t), np.array(eps)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def test_loss_fields_and_param_grads_match_jax():
    jv = _jax_model()
    tree = _tree(jv)
    batch = _batch()
    key = jax.random.PRNGKey(5)
    # compiled once: op by op, the JAX CPU backward takes minutes
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda l: (l.loss, l))(jv.loss(p, _to_jax(batch), key,
                                                   train=True)),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    t, eps = _jax_draws(key, batch["x"].shape)

    tv = _torch_model(tree)
    got = tv.loss(_to_torch(batch), train=True, t=torch.from_numpy(t),
                  eps=torch.from_numpy(eps))
    assert isinstance(got, vt.VDMLosses)
    assert got._fields == want._fields
    for name in want._fields:
        _close(getattr(got, name).detach(), getattr(want, name), 1e-5)
    got.loss.backward()
    want_grads = vt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), tv)
    for name, p in tv.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want_grads[name].numpy(), 1e-4)
    # the gradient reaches the schedule through z_t and through gamma'
    assert tv.schedule.w.grad.abs().item() > 0
    assert tv.schedule.b.grad.abs().item() > 0


def test_loss_draws_from_generator_and_eval_has_no_grad():
    tv = _torch_model(_tree(_jax_model()))
    batch = _to_torch(_batch())
    a = tv.loss(batch, torch.Generator().manual_seed(3), train=False)
    b = tv.loss(batch, torch.Generator().manual_seed(3), train=False)
    c = tv.loss(batch, torch.Generator().manual_seed(4), train=False)
    assert torch.equal(a.loss, b.loss) and not torch.equal(a.loss, c.loss)
    assert torch.isfinite(torch.stack(list(a))).all()
    with pytest.raises(ValueError, match="Generator"):
        tv.loss(batch, None)
    out = vt.make_eval_step(tv)(batch, torch.Generator().manual_seed(3))
    assert torch.equal(out["loss"], a.loss) and not out["loss"].requires_grad


def test_lr_schedule_matches_optax():
    from vdm4cdm_tpu.train.state import make_lr_schedule as jlr

    for warmup in (0, 5):
        want, got = jlr(3e-4, warmup), vt.make_lr_schedule(3e-4, warmup)
        for n in (0, 1, 4, 5, 9):
            np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1.0e6], ids=["clip_on", "clip_off"])
def test_train_steps_match_jax(clip, moment):
    """One and two steps from the same converted params, optimizer state and
    EMA, with weight decay and a warm-up so that every term is live."""
    jv = _jax_model()
    tree = _tree(jv, 23)
    batch = _batch(24)
    jdt = jnp.bfloat16 if moment == "bfloat16" else None
    hyper = dict(learning_rate=1e-3, grad_clip=clip, weight_decay=0.01,
                 warmup_steps=2)
    jopt = jmake_optimizer(moment_dtype=jdt, **hyper)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = JTrainState(0, jparams, jopt.init(jparams),
                         jax.tree_util.tree_map(jnp.array, jparams))
    jstep = jmake_train_step(jv, jopt, ema_decay=0.9)

    tv = _torch_model(tree)
    tdt = getattr(torch, moment)
    topt = vt.make_optimizer(moment_dtype=tdt, **hyper)
    opt_state = vt.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.opt_state), tv, tdt)
    assert opt_state["count"] == 0
    assert all(v.dtype == tdt for v in opt_state["mu"].values())
    tstate = vt.TrainState(0, tv, opt_state, vt.params_from_jax(tree, tv))
    tstep = vt.make_train_step(tv, topt, ema_decay=0.9)

    key = jax.random.PRNGKey(7)
    before = {k: p.detach().clone() for k, p in tv.named_parameters()}
    for i in range(2):
        k = jax.random.fold_in(key, i)
        t, eps = _jax_draws(k, batch["x"].shape)
        jstate, jmetrics = jstep(jstate, _to_jax(batch), k)
        # inject this step's draws; the step itself passes the dropout seed
        tv.loss = lambda b, g, train=True, dropout_seed=None: VDM.loss(
            tv, b, g, train, t=torch.from_numpy(t),
            eps=torch.from_numpy(eps), dropout_seed=dropout_seed)
        tstate, tmetrics = tstep(tstate, _to_torch(batch),
                                 torch.Generator().manual_seed(0))
        assert tstate.step == i + 1 and tstate.opt_state["count"] == i + 1
        assert set(tmetrics) == set(jmetrics)
        for name in jmetrics:
            _close(tmetrics[name], jmetrics[name], 1e-4)
        gnorm = float(jmetrics["grad_norm"])
        assert (gnorm > clip) == (clip == 0.5), gnorm

        as_np = lambda tr: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, np.float32), tr)
        want_p = vt.params_from_jax(as_np(jstate.params), tv)
        want_e = vt.params_from_jax(as_np(jstate.ema_params), tv)
        want_o = vt.opt_state_from_jax(as_np(jstate.opt_state), tv)
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
            mu = tstate.opt_state["mu"][name]
            assert mu.dtype == tdt
            if moment == "float32":
                np.testing.assert_allclose(mu.numpy(),
                                           want_o["mu"][name].numpy(),
                                           rtol=0, atol=1e-5, err_msg=name)
            else:
                want_mu = want_o["mu"][name].numpy()
                np.testing.assert_allclose(
                    mu.float().numpy(), want_mu, rtol=0,
                    atol=2.0 ** -7 * np.abs(want_mu).max(), err_msg=name)
    moved = max((p.detach() - before[k]).abs().max().item()
                for k, p in tv.named_parameters())
    assert moved > 1e-5


def test_train_step_with_dropout_runs_and_is_reproducible():
    """Dropout on: two fresh copies stepped with the same generator seed end
    bit-identical (the mask is a function of seed and index); another seed
    gives another loss."""
    tree = _tree(_jax_model(), 25)
    kw = dict(KW, dropout_prob=0.3)
    losses = []
    for seed in (1, 1, 2):
        tv = vt.VDM(vt.CUNet(**kw, device="cpu"),
                    vt.make_schedule("learned_linear", device="cpu"))
        tv.load_state_dict(vt.params_from_jax(tree, tv))
        opt = vt.make_optimizer()
        state = vt.TrainState(0, tv, opt.init(tv), vt.init_ema(tv))
        step = vt.make_train_step(tv, opt, ema_decay=0.99)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(2):
            state, metrics = step(state, _to_torch(_batch(26)), gen)
        assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] and losses[0] != losses[2]
    with pytest.raises(ValueError, match="dropout_seed"):
        tv.score_model(torch.zeros(1, 8, 8, 8, 1), torch.zeros(1),
                       torch.zeros(1, 8, 8, 8, 1), [torch.zeros(1, 6)],
                       train=True)
