"""Rank functions of the multi-process tests of the port's sharded path
(``test_torch_port_halo.py``, ``test_torch_port_sharded.py``).

Each runs in a fresh process of a gloo job started by
``vdm4cdm_torch.parallel.launch.spawn_ranks``: it builds the (data, sp)
mesh, takes its slab of the numpy inputs it was handed, runs the port on the
CPU and returns numpy arrays. Nothing here imports JAX.
"""

import numpy as np
import torch

from vdm4cdm_torch.parallel import (halo_exchange, local_slab, make_mesh,
                                    make_shard_ctx)
from vdm4cdm_torch.parallel.halo import (all_gather_spatial, ppermute,
                                         take_local_spatial)


def _setup(n_data, n_sp):
    torch.set_num_threads(1)
    return make_shard_ctx(make_mesh(n_data, n_sp))


def _slab(x, ctx):
    return local_slab(torch.from_numpy(np.ascontiguousarray(x)), ctx)


def _chunk(x, ctx, n):
    """This sp rank's chunk of n planes of a (B, sp * n, ...) array."""
    return torch.from_numpy(np.ascontiguousarray(
        x[:, ctx.index * n:(ctx.index + 1) * n]))


def halo(rank, world, x, ct, gather_ct):
    """halo_exchange (1, 1) forward and backward for both padding modes,
    ppermute by +-1, all_gather_spatial / take_local_spatial and the
    gather's backward, on an sp-only mesh."""
    ctx = _setup(1, world)
    n = x.shape[1] // world
    out = {}
    for periodic in (True, False):
        xl = _slab(x, ctx).requires_grad_(True)
        h = halo_exchange(xl, ctx, 1, 1, periodic)
        (h * _chunk(ct, ctx, n + 2)).sum().backward()
        out[f"halo_{periodic}"] = h.detach().numpy()
        out[f"dx_{periodic}"] = xl.grad.numpy()
        for shift in (1, -1):
            out[f"pp_{shift}_{periodic}"] = ppermute(
                _slab(x, ctx), ctx, shift, periodic).numpy()
    xl = _slab(x, ctx).requires_grad_(True)
    full = all_gather_spatial(xl, ctx)
    (full * torch.from_numpy(gather_ct)).sum().backward()
    out["gather"] = full.detach().numpy()
    out["gather_dx"] = xl.grad.numpy()
    out["take"] = take_local_spatial(full.detach(), ctx).numpy()
    out["stats"] = ctx.stats.as_dict()
    return out


def fail_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def sleep(rank, world, seconds):
    import time

    time.sleep(seconds)
    return rank


def _grads(outs, cts, leaves):
    loss = sum((o * c).sum() for o, c in zip(outs, cts))
    loss.backward()
    return [t.grad.numpy().copy() for t in leaves]


def ops(rank, world, cases):
    """Each case: the sharded ``conv_nd`` or ``norm_affine_act`` of the port
    on this rank's slab, forward and the gradients of sum(out * ct)."""
    from vdm4cdm_torch.ops.conv import conv_nd
    from vdm4cdm_torch.ops.kernels import gn_sums_plain
    from vdm4cdm_torch.ops.norm import norm_affine_act
    from vdm4cdm_torch.ops.pair import Pair
    from vdm4cdm_torch.ops.resample import downsample_conv

    ctx = _setup(1, world)
    res = {}
    for name, case in cases.items():
        kind = case["kind"]
        xs = [_slab(x, ctx).requires_grad_(True) for x in case["xs"]]
        ct = _slab(case["ct"], ctx)
        x = Pair(*xs) if len(xs) == 2 else xs[0]
        if kind == "conv":
            w = torch.from_numpy(case["w"]).requires_grad_(True)
            b = torch.from_numpy(case["b"]).requires_grad_(True)
            if case["stride"] == 2:
                y = downsample_conv(x, w, b, case["mode"], ctx=ctx)
            else:
                y = conv_nd(x, w, b, padding_mode=case["mode"], ctx=ctx)
            leaves = xs + [w, b]
        else:
            a = torch.from_numpy(case["a"]).requires_grad_(True)
            bb = torch.from_numpy(case["b"]).requires_grad_(True)
            parts = xs
            ext = (torch.cat([gn_sums_plain(p.detach().reshape(
                p.shape[0], -1, p.shape[-1])) for p in parts], -1)
                if case["ext_sums"] else None)
            y = norm_affine_act(x, a, bb, case["groups"], act=case["act"],
                                ext_sums=ext, ctx=ctx)
            leaves = xs + [a, bb]
        if isinstance(y, Pair):
            y = y.materialize()
        grads = _grads([y], [ct], leaves)
        res[name] = {"y": y.detach().numpy(), "grads": grads}
    return res


# ------------------------------------------------------------------ models

def _net_kw(mid_attn, padding="circular"):
    return dict(shape=(1, 8, 8, 8), chs=(8, 16), s_conditioning_channels=1,
                v_conditioning_dims=(6,), norm_groups=4, mid_attn=mid_attn,
                n_attention_heads=2, dropout_prob=0.0,
                conv_padding_mode=padding)


def build_vdm(state, ctx, mid_attn=False):
    import vdm4cdm_torch as vt

    vdm = vt.VDM(vt.CUNet(**_net_kw(mid_attn), device="cpu", ctx=ctx),
                 vt.make_schedule("learned_linear", device="cpu"))
    vdm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return vdm


def build_sfm(state, ctx):
    import vdm4cdm_torch as vt

    sfm = vt.SFM(vt.CUNet(**_net_kw(False, "zeros"), device="cpu", ctx=ctx))
    sfm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return sfm


def inject(model, draws):
    """Hand ``model.loss`` the next (t, eps) of ``draws`` at each call, in
    place of the generator's: the train step is otherwise unchanged."""
    loss = model.loss
    queue = list(draws)

    def injected(batch, generator=None, train=True, **kw):
        t, eps = queue.pop(0)
        return loss(batch, generator, train, t=torch.from_numpy(t),
                    eps=torch.from_numpy(eps), **kw)

    model.loss = injected


def batch_slab(batch, ctx):
    return {"x": _slab(batch["x"], ctx),
            "conditioning": _slab(batch["conditioning"], ctx),
            "conditioning_values": [_slab(v, ctx) for v in
                                    batch["conditioning_values"]]}


# small enough that Adam's first steps, which move a parameter by about lr
# whatever its gradient's size, move a near-zero gradient's parameter by
# less than the tests' 1e-5 when the gradient changes in its last bits
LR = 1e-4


def run_steps(model, batch, n_steps, lr=LR):
    """``n_steps`` of ``make_train_step`` (Adam at ``lr``, clip 0.5, EMA
    0.9); per step: params, EMA, first moment and metrics."""
    import vdm4cdm_torch as vt

    opt = vt.make_optimizer(learning_rate=lr, grad_clip=0.5)
    state = vt.TrainState(0, model, opt.init(model), vt.init_ema(model))
    step = vt.make_train_step(model, opt, ema_decay=0.9)
    gen = torch.Generator().manual_seed(0)
    out = {"params": [], "ema": [], "mu": [], "metrics": []}
    for _ in range(n_steps):
        state, m = step(state, batch, gen)
        out["metrics"].append({k: v.item() for k, v in m.items()})
        out["params"].append({k: p.detach().numpy().copy()
                              for k, p in model.named_parameters()})
        out["ema"].append({k: v.numpy().copy()
                           for k, v in state.ema_params.items()})
        out["mu"].append({k: v.numpy().copy()
                          for k, v in state.opt_state["mu"].items()})
    return out


def model(rank, world, n_data, n_sp, vdm_state, attn_state, sfm_state, z,
          t, batch, draws, x0, v0, sfm_steps, eps_steps):
    """On this rank: the sharded eps_hat of the tiny VDM (mid_attn off and
    on), train steps and an eval step on injected per-rank (t, eps), the
    VDM sampler on injected noise and through ``make_sharded_vdm_sampler``,
    and the SFM's Heun sampler through ``make_sharded_sfm_sampler``."""
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.parallel import (make_sharded_sfm_sampler,
                                        make_sharded_vdm_sampler)

    ctx = _setup(n_data, n_sp)
    out = {}
    with torch.no_grad():
        for key, state, attn in (("eps_hat", vdm_state, False),
                                 ("eps_hat_attn", attn_state, True)):
            vdm = build_vdm(state, ctx, attn)
            b = batch_slab(batch, ctx)
            out[key] = vdm.eps_hat(_slab(z, ctx), _slab(t, ctx),
                                   b["conditioning"],
                                   b["conditioning_values"]).numpy()
    vdm = build_vdm(vdm_state, ctx)
    inject(vdm, [(tt, eps) for tt, eps in draws[rank]])
    out["train"] = run_steps(vdm, batch_slab(batch, ctx), len(draws[rank]))
    vdm = build_vdm(vdm_state, ctx)
    inject(vdm, draws[rank][:1])
    metrics = vt.make_eval_step(vdm)(batch_slab(batch, ctx),
                                     torch.Generator().manual_seed(0))
    out["eval"] = {k: v.item() for k, v in metrics.items()}
    vdm = build_vdm(vdm_state, ctx)
    b = batch_slab(batch, ctx)
    out["vdm_noise"] = vdm.draw_samples(
        batch_size=b["x"].shape[0], n_sampling_steps=len(eps_steps),
        s_conditioning=b["conditioning"],
        v_conditionings=b["conditioning_values"],
        noise=(_slab(z, ctx), [_slab(e, ctx) for e in eps_steps])).numpy()
    sample = make_sharded_vdm_sampler(vdm, z.shape[0], len(eps_steps))
    out["vdm_gen"] = sample(
        torch.Generator().manual_seed(5),
        torch.from_numpy(batch["conditioning"]),
        [torch.from_numpy(v) for v in batch["conditioning_values"]]).numpy()
    sfm = build_sfm(sfm_state, ctx)
    sample = make_sharded_sfm_sampler(sfm, sfm_steps, method="heun")
    out["sfm"] = sample(torch.from_numpy(x0),
                        [torch.from_numpy(v0)]).numpy()
    out["stats"] = ctx.stats.as_dict()
    return out
