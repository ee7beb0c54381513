"""The port's sharded path against the JAX package's and against the port
unsharded, on the CPU.

The port side runs as gloo jobs of CPU processes (``spawn_ranks``, a
FileStore in a temporary directory, a time limit on each job; rank functions
in ``_torch_dist_worker.py``); the JAX side under ``shard_map`` on the
virtual CPU devices of ``tests/conftest.py``, on its XLA path. Inputs are
seeded numpy arrays handed to both.

  * Ops at sp = 2 (the halo tests take sp = 4): the sharded ``conv_nd`` (k3 through the z-halo
    kernels' plain versions, k1, a ``conv_in``-style and a narrow k3 library
    conv, the stride-2 downsample, a Pair) and the context-parallel
    ``norm_affine_act`` (with the conv-style ``ext_sums``, over a Pair whose
    group straddles the halves), forward and every gradient of
    sum(out * ct), against JAX's sharded ``conv_nd`` / ``downsample_conv`` /
    ``norm_affine_act``: 1e-5 relative to max(1, max |ref|) (f32, sums in
    another order).
  * The z-halo plain versions against ``F.conv3d`` with a z pad and a crop
    (1e-5), and once against ``conv3d_pallas_zhalo`` in interpret mode.
  * A tiny CUNet (2 levels, chs (8, 16), 8^3, f32, dropout 0) on meshes
    (n_data, n_sp) = (1, 2) and (2, 2): eps_hat with ``mid_attn`` off and on
    against the port unsharded (1e-5); one and two train steps on injected
    per-rank draws against the port's unsharded steps on the same global
    draws (metrics 1e-4 relative, params and EMA 1e-5 absolute); one step
    against JAX's ``make_train_step(mesh=...)`` with the draws replayed
    from its keys (metrics 1e-4, params 1e-5); the sharded eval step's mesh
    mean against the unsharded eval (1e-4); parameters bitwise equal across
    ranks after two steps; the VDM sampler on injected noise slices against
    the unsharded one (1e-5) and the sharded VDM sampler's gathered field
    equal on every rank; the SFM's sharded Heun sampler against the
    unsharded one (1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as W
from _torch_port_util import randomize_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.models import CUNet as JCUNet
from vdm4cdm_tpu.ops.conv import conv_nd as jconv
from vdm4cdm_tpu.ops.norm import norm_affine_act as jnorm
from vdm4cdm_tpu.ops.resample import downsample_conv as jdown
from vdm4cdm_tpu.parallel.halo import ShardCtx as JShardCtx
from vdm4cdm_tpu.parallel.shard import batch_pspec
from vdm4cdm_tpu.train import TrainState as JTrainState
from vdm4cdm_tpu.train import make_optimizer as jmake_optimizer
from vdm4cdm_tpu.train import make_train_step as jmake_train_step
from vdm4cdm_tpu.utils.mesh import make_mesh as jmake_mesh

import vdm4cdm_torch as vt
from vdm4cdm_torch.ops.kernels import (conv3d_k3s1_zhalo_dw,
                                       conv3d_k3s1_zhalo_dx,
                                       conv3d_k3s1_zhalo_fwd)
from vdm4cdm_torch.parallel import NO_SHARD, eps_generator, seeded_generator
from vdm4cdm_torch.parallel.launch import spawn_ranks

TIMEOUT = 180.0
B = 2
JCTX = JShardCtx(axis="sp", spatial_dim=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers and this module's ranks use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


# ------------------------------------------------------------------- ops

def _ops_cases():
    rng = np.random.default_rng(50)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    sp_shape = (B, 8, 4, 4)
    cases = {}
    for mode in ("circular", "zeros"):
        for name, cin, cout, k, stride in (
                ("k3", 8, 8, 3, 1), ("k1", 8, 16, 1, 1),
                ("conv_in", 2, 8, 3, 1), ("narrow_k3", 6, 6, 3, 1),
                ("down", 8, 8, 3, 2)):
            cases[f"{name}_{mode}"] = dict(
                kind="conv", mode=mode, stride=stride,
                xs=[n(*sp_shape, cin)], w=n(k, k, k, cin, cout,
                                            s=(k ** 3 * cin) ** -0.5),
                b=n(cout, s=0.3),
                ct=n(B, 8 // stride, 4 // stride, 4 // stride, cout))
        cases[f"pair_{mode}"] = dict(
            kind="conv", mode=mode, stride=1,
            xs=[n(*sp_shape, 8), n(*sp_shape, 8)],
            w=n(3, 3, 3, 16, 8, s=(27 * 16) ** -0.5), b=n(8, s=0.3),
            ct=n(*sp_shape, 8))
    for act in ("silu", None):
        cases[f"norm_{act}"] = dict(
            kind="norm", act=act, groups=4, ext_sums=True,
            xs=[n(*sp_shape, 8, s=1.5) + 0.4], a=1.0 + n(B, 8, s=0.3),
            b=n(B, 8, s=0.2), ct=n(*sp_shape, 8))
        # groups of 4 channels over halves of 6 and 2: the second group
        # straddles the boundary
        cases[f"norm_pair_{act}"] = dict(
            kind="norm", act=act, groups=2, ext_sums=False,
            xs=[n(*sp_shape, 6, s=1.5), n(*sp_shape, 2) - 0.3],
            a=1.0 + n(B, 8, s=0.3), b=n(B, 8, s=0.2), ct=n(*sp_shape, 8))
    return cases


CASES = _ops_cases()


@pytest.fixture(scope="module")
def port_ops(tmp_path_factory):
    runs = {}

    def get(sp):
        if sp not in runs:
            runs[sp] = spawn_ranks(
                W.ops, sp, (CASES,), timeout=TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp("ops")))
        return runs[sp]

    return get


def _jax_case(case, sp):
    """JAX's sharded op on the case: (y, grads of sum(y * ct))."""
    mesh = jmake_mesh(n_data=1, n_sp=sp)
    nx = len(case["xs"])
    if case["kind"] == "conv":
        def op(*args):
            x = jnp.concatenate(args[:nx], -1)
            w, b = args[nx:]
            if case["stride"] == 2:
                return jdown(x, w, b, padding_mode=case["mode"], ctx=JCTX)
            return jconv(x, w, b, padding_mode=case["mode"], ctx=JCTX)
        params = [case["w"], case["b"]]
    else:
        def op(*args):
            x = jnp.concatenate(args[:nx], -1)
            a, b = args[nx:]
            return jnorm(x, a, b, case["groups"], act=case["act"], ctx=JCTX)
        params = [case["a"], case["b"]]
    f = jax.shard_map(op, mesh=mesh,
                      in_specs=(P(None, "sp"),) * nx + (P(), P()),
                      out_specs=P(None, "sp"), check_vma=False)
    args = [jnp.asarray(v) for v in case["xs"] + params]

    def run(*a):
        y, vjp = jax.vjp(f, *a)
        return y, vjp(jnp.asarray(case["ct"]))

    y, grads = jax.jit(run)(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_op_matches_jax(port_ops, name):
    sp = 2
    case = CASES[name]
    ranks = port_ops(sp)
    want_y, want_g = _jax_case(case, sp)
    nx = len(case["xs"])
    got_y = np.concatenate([r[name]["y"] for r in ranks], 1)
    _close(got_y, want_y, 1e-5, "y")
    for i in range(nx):
        got = np.concatenate([r[name]["grads"][i] for r in ranks], 1)
        _close(got, want_g[i], 1e-5, f"dx{i}")
    # parameters: each rank holds its slab's share; the mesh sums them
    for i in range(nx, nx + 2):
        got = sum(r[name]["grads"][i] for r in ranks)
        _close(got, want_g[i], 1e-5, f"param {i - nx}")


# ------------------------------------------------------- z-halo kernels

@pytest.mark.parametrize("circular", [True, False])
def test_zhalo_plain_versions_match_a_padded_conv_cropped(circular):
    """The valid-in-z conv of a haloed slab is the SAME conv of the slab's
    D + 2 planes with its outer output planes cropped; dx and dw are that
    function's gradients."""
    rng = np.random.default_rng(60)
    xh = torch.from_numpy(rng.standard_normal((2, 6, 5, 4, 8))
                          .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy((0.2 * rng.standard_normal((3, 3, 3, 8, 16)))
                         .astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 4, 5, 4, 16))
                          .astype(np.float32))
    xc = xh.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2)
    if circular:
        ref = F.conv3d(F.pad(xc, (1,) * 6, mode="circular"), wc)
    else:
        ref = F.conv3d(xc, wc, padding=1)
    ref = ref.permute(0, 2, 3, 4, 1)[:, 1:-1] + b
    ref_sums = torch.stack([ref.sum((1, 2, 3)), (ref * ref).sum((1, 2, 3))],
                           1)
    dx_ref, dw_ref = torch.autograd.grad((ref * ct).sum(), (xh, w))
    with torch.no_grad():
        y, sums = conv3d_k3s1_zhalo_fwd(xh, w, b, circular=circular,
                                        with_sums=True)
        dx = conv3d_k3s1_zhalo_dx(ct, w, circular)
        dw, db = conv3d_k3s1_zhalo_dw(xh, ct, circular)
    _close(y, ref.detach(), 1e-5, "y")
    _close(sums, ref_sums.detach(), 1e-5, "sums")
    _close(dx, dx_ref, 1e-5, "dx")
    _close(dw, dw_ref, 1e-5, "dw")
    _close(db, ct.sum((0, 1, 2, 3)), 1e-5, "db")


def test_zhalo_plain_versions_match_pallas_interpret():
    """``conv3d_pallas_zhalo`` (the TPU kernel under zmode="halo") in
    interpret mode, with its custom VJP, against the z-halo wrappers' plain
    versions at one small shape, circular in-plane."""
    from jax.experimental.pallas import tpu as pltpu

    from vdm4cdm_tpu.ops.pallas.conv3d import (conv3d_pallas_zhalo,
                                               supports_zhalo)

    rng = np.random.default_rng(61)
    xh = rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, 16, 16))).astype(np.float32)
    ct = rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    assert supports_zhalo(xh.shape, w.shape, itemsize=4)
    mode = "circular"
    f = lambda x, k: conv3d_pallas_zhalo(x, k, mode)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(f(jnp.asarray(xh), jnp.asarray(w)))
        wdx, wdw = jax.grad(lambda x, k: jnp.sum(f(x, k) * ct),
                            argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(w))
    circ = mode == "circular"
    tx, tw, tct = map(torch.from_numpy, (xh, w, ct))
    _close(conv3d_k3s1_zhalo_fwd(tx, tw, circular=circ)[0], want, 1e-5, "y")
    _close(conv3d_k3s1_zhalo_dx(tct, tw, circ), np.asarray(wdx), 1e-5, "dx")
    _close(conv3d_k3s1_zhalo_dw(tx, tct, circ)[0], np.asarray(wdw), 1e-5,
           "dw")


def test_zhalo_wrappers_check_shapes_and_count_launches():
    x = torch.zeros(1, 4, 4, 4, 8)
    w = torch.zeros(3, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="at least 3 planes"):
        conv3d_k3s1_zhalo_fwd(torch.zeros(1, 2, 4, 4, 8), w)
    with pytest.raises(ValueError, match="residual shape"):
        conv3d_k3s1_zhalo_fwd(x, w, residual=torch.zeros(1, 4, 4, 4, 8))
    with pytest.raises(ValueError, match="two halo planes"):
        conv3d_k3s1_zhalo_dw(x, torch.zeros(1, 4, 4, 4, 8))
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3d_k3s1_zhalo_dx(torch.zeros(1, 2, 4, 4, 12),
                             torch.zeros(3, 3, 3, 8, 12))
    counts = [k.launches for k in (conv3d_k3s1_zhalo_fwd,
                                   conv3d_k3s1_zhalo_dx,
                                   conv3d_k3s1_zhalo_dw)]
    conv3d_k3s1_zhalo_fwd(x, w)  # the plain version: no launch
    assert counts == [k.launches for k in (conv3d_k3s1_zhalo_fwd,
                                           conv3d_k3s1_zhalo_dx,
                                           conv3d_k3s1_zhalo_dw)]
    assert conv3d_k3s1_zhalo_fwd in vt.ops.kernels.KERNELS


# ----------------------------------------------------------------- models

NET = W._net_kw(False)
MESHES = [(1, 2), (2, 2)]
N_STEPS, SFM_STEPS, LR = 2, 3, W.LR


def _jax_vdm(ctx=None, mid_attn=False):
    kw = dict(NET, mid_attn=mid_attn)
    if ctx is not None:
        kw["ctx"] = ctx
    return JVDM(JCUNet(**kw), jmake_schedule("learned_linear", -13.3, 13.3))


@functools.lru_cache(maxsize=None)
def _trees():
    """Seeded JAX params trees of the tiny VDM without and with
    ``mid_attn``: every UNet leaf is a fresh draw, so only the tree's shapes
    are needed (``eval_shape``, no initialization run)."""
    trees = {}
    for name, attn, seed in (("vdm", False, 70), ("attn", True, 71)):
        jv = _jax_vdm(mid_attn=attn)
        unet = jax.eval_shape(lambda k: jv.init_params(k)["unet"],
                              jax.random.PRNGKey(0))
        tree = {"unet": jax.tree_util.tree_map(
                    lambda a: np.zeros(a.shape, np.float32), unet),
                "gamma": jax.tree_util.tree_map(
                    np.asarray, jv.schedule.init_params())}
        trees[name] = randomize_tree(tree, seed)
    return trees


def _port_state(tree, attn=False):
    tv = vt.VDM(vt.CUNet(**dict(NET, mid_attn=attn), device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    return {k: v.numpy() for k, v in vt.params_from_jax(tree, tv).items()}


def _sfm_state():
    """The tiny SFM's parameters, every one a seeded normal draw (kernels at
    fan-in scale): a fresh net's zero ``conv_out`` would give a zero
    velocity."""
    sfm = vt.SFM(vt.CUNet(**W._net_kw(False, "zeros"), device="cpu"))
    gen = torch.Generator().manual_seed(73)
    out = {}
    for k, p in sfm.state_dict().items():
        n = torch.randn(p.shape, generator=gen)
        if k.endswith("kernel"):
            v = n / np.sqrt(np.prod(p.shape[:-1]))
        elif k.endswith("scale"):
            v = 1.0 + 0.2 * n
        else:
            v = 0.2 * n
        out[k] = v.numpy()
    return out


def _batch(n_data):
    rng = np.random.default_rng(74)
    b = B * n_data
    return {"x": rng.standard_normal((b, 8, 8, 8, 1)).astype(np.float32),
            "conditioning": rng.standard_normal((b, 8, 8, 8, 1)).astype(
                np.float32),
            "conditioning_values": [rng.standard_normal((b, 6)).astype(
                np.float32)]}


def _replayed_draws(n_data, n_sp):
    """Per rank and step, (t, eps) as JAX's sharded step and ``VDM.loss``
    draw them from the step's key: the key folds in the data index, t comes
    from the first of its three splits, eps from the second folded with the
    sp index, at the rank's slab shape."""
    draws = {r: [] for r in range(n_data * n_sp)}
    local = (B, 8 // n_sp, 8, 8, 1)
    for i in range(N_STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(75), i)
        for d in range(n_data):
            rng_t, rng_eps, _ = jax.random.split(jax.random.fold_in(key, d),
                                                 3)
            u0 = jax.random.uniform(rng_t, ())
            t = np.asarray(jnp.mod(u0 + jnp.arange(B) / B, 1.0), np.float32)
            for s in range(n_sp):
                eps = jax.random.normal(jax.random.fold_in(rng_eps, s),
                                        local, jnp.float32)
                draws[d * n_sp + s].append((t, np.asarray(eps)))
    return draws


def _global_draws(draws, n_data, n_sp):
    """The global (t, eps) of each step from the ranks' slabs."""
    out = []
    for i in range(N_STEPS):
        t = np.concatenate([draws[d * n_sp][i][0] for d in range(n_data)])
        eps = np.concatenate([
            np.concatenate([draws[d * n_sp + s][i][1] for s in range(n_sp)],
                           1) for d in range(n_data)], 0)
        out.append((t, eps))
    return out


def _model_inputs(n_data, n_sp):
    trees = _trees()
    rng = np.random.default_rng(76)
    bsz = B * n_data
    x0 = rng.standard_normal((bsz, 8, 8, 8, 1)).astype(np.float32)
    return dict(
        vdm_state=_port_state(trees["vdm"]),
        attn_state=_port_state(trees["attn"], True),
        sfm_state=_sfm_state(),
        z=rng.standard_normal((bsz, 8, 8, 8, 1)).astype(np.float32),
        t=np.linspace(0.1, 0.9, bsz).astype(np.float32),
        batch=_batch(n_data), draws=_replayed_draws(n_data, n_sp), x0=x0,
        v0=rng.standard_normal((bsz, 6)).astype(np.float32),
        sfm_steps=SFM_STEPS,
        eps_steps=[rng.standard_normal((bsz, 8, 8, 8, 1)).astype(np.float32)
                   for _ in range(2)])


ARGS = ("vdm_state", "attn_state", "sfm_state", "z", "t", "batch", "draws",
        "x0", "v0", "sfm_steps", "eps_steps")


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            inputs = _model_inputs(*mesh)
            ranks = spawn_ranks(
                W.model, mesh[0] * mesh[1],
                mesh + tuple(inputs[k] for k in ARGS), timeout=TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp("model")))
            runs[mesh] = (inputs, ranks)
        return runs[mesh]

    return get


def _gather(ranks, key, n_data, n_sp):
    return np.concatenate([
        np.concatenate([ranks[d * n_sp + s][key] for s in range(n_sp)], 1)
        for d in range(n_data)], 0)


def _to_torch(batch):
    return {"x": torch.from_numpy(batch["x"]),
            "conditioning": torch.from_numpy(batch["conditioning"]),
            "conditioning_values": [torch.from_numpy(v) for v in
                                    batch["conditioning_values"]]}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("attn", [False, True], ids=["no_attn", "mid_attn"])
def test_sharded_eps_hat_matches_unsharded(port_model, mesh, attn):
    inputs, ranks = port_model(mesh)
    key = "eps_hat_attn" if attn else "eps_hat"
    vdm = W.build_vdm(inputs["attn_state" if attn else "vdm_state"],
                      NO_SHARD, attn)
    b = _to_torch(inputs["batch"])
    with torch.no_grad():
        want = vdm.eps_hat(torch.from_numpy(inputs["z"]),
                           torch.from_numpy(inputs["t"]), b["conditioning"],
                           b["conditioning_values"]).numpy()
    _close(_gather(ranks, key, *mesh), want, 1e-5)
    assert np.abs(want).max() > 0.1


@pytest.fixture(scope="module")
def unsharded_steps():
    runs = {}

    def get(mesh, inputs):
        if mesh not in runs:
            vdm = W.build_vdm(inputs["vdm_state"], NO_SHARD)
            W.inject(vdm, _global_draws(inputs["draws"], *mesh))
            runs[mesh] = W.run_steps(vdm, _to_torch(inputs["batch"]),
                                     N_STEPS, LR)
        return runs[mesh]

    return get


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("step", range(N_STEPS))
def test_sharded_train_steps_match_unsharded(port_model, unsharded_steps,
                                             mesh, step):
    inputs, ranks = port_model(mesh)
    want = unsharded_steps(mesh, inputs)
    got = ranks[0]["train"]
    for k, v in want["metrics"][step].items():
        _close(got["metrics"][step][k], v, 1e-4, k)
    for k, v in want["params"][step].items():
        np.testing.assert_allclose(got["params"][step][k], v, rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["ema"][step][k],
                                   want["ema"][step][k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_eval_step_matches_unsharded(port_model, mesh):
    inputs, ranks = port_model(mesh)
    vdm = W.build_vdm(inputs["vdm_state"], NO_SHARD)
    W.inject(vdm, _global_draws(inputs["draws"], *mesh)[:1])
    want = vt.make_eval_step(vdm)(_to_torch(inputs["batch"]),
                                  torch.Generator().manual_seed(0))
    for r in ranks:  # the mesh mean is on every rank
        for k, v in want.items():
            _close(r["eval"][k], v.item(), 1e-4, k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_vdm_sampler_matches_unsharded_on_injected_noise(port_model,
                                                                 mesh):
    """``VDM.draw_samples`` on each rank's slices of the same noise gives
    the unsharded samples' slabs; ``make_sharded_vdm_sampler`` gives every
    rank the same global field, its noise folded per rank."""
    inputs, ranks = port_model(mesh)
    vdm = W.build_vdm(inputs["vdm_state"], NO_SHARD)
    b = _to_torch(inputs["batch"])
    want = vdm.draw_samples(
        batch_size=B * mesh[0], n_sampling_steps=2,
        s_conditioning=b["conditioning"],
        v_conditionings=b["conditioning_values"],
        noise=(torch.from_numpy(inputs["z"]),
               [torch.from_numpy(e) for e in inputs["eps_steps"]])).numpy()
    _close(_gather(ranks, "vdm_noise", *mesh), want, 1e-5)
    gen = ranks[0]["vdm_gen"]
    assert gen.shape == want.shape and np.isfinite(gen).all()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["vdm_gen"], gen)
    # the two sp slabs of one sample drew different noise
    half = gen.shape[1] // 2
    assert np.abs(gen[:, :half] - gen[:, half:]).max() > 1e-3


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_params_stay_bitwise_equal_across_ranks(port_model, mesh):
    _, ranks = port_model(mesh)
    first = ranks[0]["train"]
    for r in ranks[1:]:
        for what in ("params", "ema", "mu"):
            for k, v in first[what][-1].items():
                np.testing.assert_array_equal(r["train"][what][-1][k], v,
                                              err_msg=f"{what} {k}")
        assert r["train"]["metrics"] == first["metrics"]
    start = port_model(mesh)[0]["vdm_state"]
    moved = max(np.abs(v - start[k]).max()
                for k, v in first["params"][-1].items())
    assert moved > 1e-5


def test_one_sharded_step_matches_jax(port_model):
    """The (2, 2) mesh: JAX's sharded step from the same params, on the same
    batch and keys, against the port's first step."""
    mesh = (2, 2)
    inputs, ranks = port_model(mesh)
    jmesh = jmake_mesh(n_data=2, n_sp=2)
    jv = _jax_vdm(JShardCtx(axis="sp", spatial_dim=0, data_axis="data"))
    tree = _trees()["vdm"]
    jopt = jmake_optimizer(learning_rate=LR, grad_clip=0.5)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = JTrainState(0, params, jopt.init(params),
                         jax.tree_util.tree_map(jnp.array, params))
    host = inputs["batch"]
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), host)
    step = jmake_train_step(jv, jopt, mesh=jmesh, batch_template=template,
                            ema_decay=0.9)
    bspec = NamedSharding(jmesh, batch_pspec(3))
    dev = {"x": jax.device_put(host["x"], bspec),
           "conditioning": jax.device_put(host["conditioning"], bspec),
           "conditioning_values": [jax.device_put(
               host["conditioning_values"][0],
               NamedSharding(jmesh, P("data")))]}
    key = jax.random.fold_in(jax.random.PRNGKey(75), 0)
    jstate, jmetrics = step(jstate, dev, key)
    got = ranks[0]["train"]
    for k in jmetrics:
        _close(got["metrics"][0][k], np.asarray(jmetrics[k]), 1e-4, k)
    tv = vt.VDM(vt.CUNet(**NET, device="cpu"),
                vt.make_schedule("learned_linear", device="cpu"))
    want = vt.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jstate.params), tv)
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][0][k], v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_sfm_heun_sampler_matches_unsharded(port_model, mesh):
    inputs, ranks = port_model(mesh)
    sfm = W.build_sfm(inputs["sfm_state"], NO_SHARD)
    want = sfm.draw_samples(torch.from_numpy(inputs["x0"]), SFM_STEPS,
                            [torch.from_numpy(inputs["v0"])],
                            method="heun").numpy()
    for r in ranks:  # every rank gathers the whole field
        _close(r["sfm"], want, 1e-5)
    assert np.abs(want - inputs["x0"]).max() > 1e-2


def _fake_ctx():
    """A ShardCtx of a 2-rank sp group, for the checks that refuse a model
    before any collective runs (no process group is needed)."""
    from vdm4cdm_torch.parallel import ShardCtx

    return ShardCtx(group=object(), ranks=(0, 1))


def test_build_model_checks_the_mesh_and_cunet_the_slab():
    ctx = _fake_ctx()
    cfg = vt.preset("trainVDM3D128_c_c", **{"data.cropsize": 16})
    with pytest.raises(ValueError, match="ctx mesh 1 x 2"):
        vt.build_model(cfg, device="cpu", ctx=ctx)
    cfg = vt.preset("trainVDM3D128_c_c",
                    **{"data.cropsize": 16, "parallel.n_sp": 2})
    vdm = vt.build_model(cfg, device="cpu", ctx=ctx)
    assert vdm.score_model.ctx is ctx
    assert vdm.local_sample_shape_nlast == (8, 16, 16, 1)
    # 4 planes a rank do not halve three times
    with pytest.raises(ValueError, match="do not divide by 8"):
        vdm.eps_hat(torch.zeros(1, 4, 16, 16, 1), torch.zeros(1),
                    torch.zeros(1, 4, 16, 16, 1), [torch.zeros(1, 6)])


def test_sharded_downsample_needs_an_even_slab():
    from vdm4cdm_torch.ops.resample import downsample_conv

    with pytest.raises(ValueError, match="local size must be even"):
        downsample_conv(torch.zeros(1, 3, 4, 4, 8),
                        torch.zeros(3, 3, 3, 8, 8), ctx=_fake_ctx())


def test_eps_generator_seeds_on_the_host_from_a_step_seed():
    """With the step's seed, a sharded loss's eps generator takes no draw
    from the caller's generator (so a CUDA one reads nothing back), is
    reproducible from (seed, sp index), and differs across sp ranks and from
    the t generator seeded by the same seed; without a seed it draws from
    the caller's generator."""
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()

    def draw(g):
        return torch.randn(64, generator=g)

    eps = draw(eps_generator(gen, 11, 0))
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(draw(eps_generator(gen, 11, 0)), eps)
    assert not torch.allclose(draw(eps_generator(gen, 11, 1)), eps)
    assert not torch.allclose(draw(seeded_generator("cpu", 11)), eps)
    eps_generator(gen, None, 0)
    assert not torch.equal(gen.get_state(), before)
