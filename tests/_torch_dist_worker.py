"""Rank functions of the multi-process tests of the port's sharded path
(``test_torch_port_halo.py``, ``test_torch_port_sharded.py``,
``test_torch_port_sharded_cli.py``).

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


# ----------------------------------------------------------- the sharded CLI

def _cli_cfg(overrides):
    """The flagship preset under the CLI's ``--set`` overrides."""
    import vdm4cdm_torch as vt
    from vdm4cdm_torch.cli._common import apply_overrides, parse_overrides

    cfg = vt.preset("trainVDM3D128_c_c")
    apply_overrides(cfg, parse_overrides(overrides))
    return cfg


def _tree(tensors):
    """numpy copies: a rank's tensors would reach the parent through shared
    memory that the rank's exit takes away."""
    return {k: t.detach().numpy().copy() for k, t in tensors.items()}


def _run_cli(main, argv):
    """``main(argv)``'s exit code, or (code, what it wrote to stderr) where
    it stopped with ``SystemExit`` (argparse's errors)."""
    import contextlib
    import io

    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            return main(argv)
    except SystemExit as e:
        return e.code, err.getvalue()


def cli_sp(rank, world, out_dir, overrides, reps, steps, sfm_overrides):
    """On the (1, world) mesh: ``cli.train`` for 2 steps (a checkpoint at
    2), the same 2 steps of ``make_train_step`` driven by hand on the slabs
    of the same GRF stream, ``cli.train`` resumed to 3 and the hand run's
    third step; then ``cli.generate`` CV_12_12 (``reps`` a sampler call,
    ``steps`` sampler steps) from the last checkpoint and
    ``make_sharded_vdm_sampler`` driven by hand with the CLI's
    ``RngStream`` for its first two boxes; then an SFM of ``sigma`` > 0
    trained one step and its first box drawn by ``cli.generate
    --sfm-method sde`` and by ``make_sharded_sfm_sampler`` by hand."""
    import os

    import vdm4cdm_torch as vt
    from vdm4cdm_torch.cli import generate, train
    from vdm4cdm_torch.cli._common import apply_overrides, parse_overrides
    from vdm4cdm_torch.parallel import (make_sharded_sfm_sampler,
                                        make_sharded_vdm_sampler)
    from vdm4cdm_torch.train.checkpoint import (load_params, params_digest,
                                                read_checkpoint)
    from vdm4cdm_torch.utils.array import nlast_to_nchw
    from vdm4cdm_torch.utils.rng import RngStream, seeded_generator

    torch.set_num_threads(1)
    argv = ["--preset", "trainVDM3D128_c_c", "--device", "cpu", "--set",
            *overrides, f"run.out_dir={out_dir}"]
    out = {"train_rc": train.main(argv + ["run.max_steps=2"])}
    cfg = _cli_cfg(overrides)
    ckpt_dir = os.path.join(out_dir, cfg.run.experiment_name, "checkpoints")

    # the hand run: the model from the CLI's seed, each step's slab of the
    # GRF stream, the trainer's step generators
    ctx = make_shard_ctx(make_mesh(1, world))
    model = vt.build_model(cfg, device="cpu", ctx=ctx,
                           generator=torch.Generator().manual_seed(
                               cfg.run.seed))
    opt = vt.make_optimizer(cfg.run.learning_rate, cfg.run.grad_clip,
                            cfg.run.weight_decay, cfg.run.warmup_steps)
    state = vt.TrainState(0, model, opt.init(model), None)
    step = vt.make_train_step(model, opt)
    hand = {}
    for batch in vt.build_datamodule(cfg, "fit").train_batches(3):
        state, _ = step(state, {
            "x": _slab(batch["x"], ctx),
            "conditioning": _slab(batch["conditioning"], ctx),
            "conditioning_values": [_slab(v, ctx) for v in
                                    batch["conditioning_values"]]},
            seeded_generator("cpu", cfg.run.seed + 1, state.step))
        hand[state.step] = _tree(dict(model.named_parameters()))
        if state.step == 2:
            out["digest_2"] = params_digest(state)
    out["ckpt_2"] = _tree(read_checkpoint(ckpt_dir, 2)["params"])
    out["hand_2"], out["hand_3"] = hand[2], hand[3]
    out["resume_rc"] = train.main(argv + ["run.max_steps=3"])
    out["ckpt_3"] = _tree(read_checkpoint(ckpt_dir, 3)["params"])
    out["steps"] = sorted(int(n) for n in os.listdir(ckpt_dir)
                          if n.isdigit())
    out["figures"] = sorted(os.listdir(os.path.join(
        out_dir, cfg.run.experiment_name, "figures"))) if rank == 0 else []

    gen_dir = os.path.join(out_dir, "samples")
    out["generate_rc"] = generate.main([
        "trainVDM3D128_c_c", gen_dir, "CV_12_12", "--ckpt-dir", ckpt_dir,
        "--device", "cpu", "--n-sampling-steps", str(steps),
        "--reps-per-batch", str(reps), "--set", *overrides])
    gcfg = _cli_cfg(overrides)
    gcfg.data.set_name, gcfg.data.batch_size = "CV", 1
    model = vt.build_model(gcfg, device="cpu", ctx=ctx)
    load_params(ckpt_dir, model)
    model.eval()
    sample = make_sharded_vdm_sampler(model, reps, steps)
    rngs = RngStream(0, device="cpu")
    boxes = []
    for i, box in enumerate(vt.build_datamodule(gcfg, "test")
                            .test_dataloader()):
        if i == 2:
            break

        def tile(a):
            return torch.from_numpy(np.repeat(a, reps, axis=0))

        z = sample(rngs.next(), tile(box["conditioning"]),
                   [tile(v) for v in box["conditioning_values"]])
        boxes.append(nlast_to_nchw(z).float().numpy())
    out["hand_fields"] = boxes
    if rank == 0:  # each file's (shape, dtype, finite), the first two's data
        files = {n: np.load(os.path.join(gen_dir, n))
                 for n in sorted(os.listdir(gen_dir))}
        out["files"] = {n: (a.shape, str(a.dtype), bool(np.isfinite(a).all()))
                        for n, a in files.items()}
        out["file_fields"] = [files[f"gen_{i}.npy"] for i in range(2)]

    # the SFM campaign: the sharded SDE sampler, one box
    sfm_dir = os.path.join(out_dir, "sfm")
    sfm_argv = ["--device", "cpu", "--set", *sfm_overrides]
    out["sfm_train_rc"] = train.main(
        ["--preset", "trainSFM3D128_c_c", *sfm_argv,
         f"run.out_dir={sfm_dir}", "run.max_steps=1"])
    ckpt_dir = os.path.join(sfm_dir, "trainSFM3D128_c_c", "checkpoints")
    gen_dir = os.path.join(sfm_dir, "samples")
    out["sfm_generate_rc"] = generate.main([
        "trainSFM3D128_c_c", gen_dir, "CV_12_12", "--ckpt-dir", ckpt_dir,
        "--boxes", "1", "--sfm-method", "sde", "--n-sampling-steps",
        str(steps), "--reps-per-batch", str(reps), *sfm_argv])
    scfg = vt.preset("trainSFM3D128_c_c")
    apply_overrides(scfg, parse_overrides(sfm_overrides))
    scfg.data.set_name, scfg.data.batch_size = "CV", 1
    model = vt.build_model(scfg, device="cpu", ctx=ctx)
    load_params(ckpt_dir, model)
    model.eval()
    box = next(iter(vt.build_datamodule(scfg, "test").test_dataloader()))

    def tile(a):
        return torch.from_numpy(np.repeat(a, reps, axis=0))

    z = make_sharded_sfm_sampler(model, steps, method="sde")(
        tile(box["x0"]), [tile(v) for v in box["conditioning_values"]],
        RngStream(0, device="cpu").next())
    out["sfm_hand"] = nlast_to_nchw(z).float().numpy()
    if rank == 0:
        out["sfm_files"] = {n: np.load(os.path.join(gen_dir, n))
                            for n in sorted(os.listdir(gen_dir))}
    return out


def cli_data(rank, world, out_dir, overrides):
    """On the (world, 1) mesh: ``cli.train`` for one step (each data rank
    its row of the batch; the trainer compares the ranks' digests at the
    checkpoint) and the digest of the checkpoint it wrote, then
    ``cli.generate`` with reps that do not split over the data ranks."""
    import os

    from vdm4cdm_torch.cli import generate, train
    from vdm4cdm_torch.train.checkpoint import read_checkpoint

    torch.set_num_threads(1)
    out = {"train_rc": train.main([
        "--preset", "trainVDM3D128_c_c", "--device", "cpu", "--set",
        *overrides, f"run.out_dir={out_dir}", "run.max_steps=1"])}
    cfg = _cli_cfg(overrides)
    ckpt_dir = os.path.join(out_dir, cfg.run.experiment_name, "checkpoints")
    out["params"] = _tree(read_checkpoint(ckpt_dir, 1)["params"])
    out["reps_error"] = _run_cli(generate.main, [
        "trainVDM3D128_c_c", os.path.join(out_dir, "samples"), "CV_12_12",
        "--ckpt-dir", ckpt_dir, "--device", "cpu", "--reps-per-batch", "3",
        "--set", *overrides])
    return out
