"""The VDM's loss, its ancestral sampler step and the training update
(global-norm clip, Adam with decoupled weight decay, EMA), written out in
float32 torch operations on the reference UNet of ``cunet.py``.

Variance preserving: gamma(t) = b + |w| t, alpha^2 = sigmoid(-gamma),
sigma^2 = sigmoid(gamma). The loss of a batch x with times t and noise eps:

    z_t = alpha_t x + sigma_t eps
    diffusion = 1/2 mean_b(|w| mean(eps - eps_hat(z_t, t))^2)
    latent    = 1/2 (sigmoid(-g1) mean(x^2) + sigmoid(g1) - log sigmoid(g1) - 1)
    recon     = 1/2 (1 + log(2 pi sigmoid(g0) / sigmoid(-g0)))

with g0 = gamma(0), g1 = gamma(1). The times are one uniform offset u plus
the ladder i / B, mod 1. One sampler step t -> s, with c = -expm1(g_s - g_t):

    x0 = (z_t - sigma_t eps_hat) / alpha_t
    z_s = (alpha_s / alpha_t)(1 - c) z_t + alpha_s c x0 + sigma_s sqrt(c) eps

The training update: the gradient's global norm n; g * min(1, clip / n);
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, the update
(mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps) plus weight decay times
the parameter, times the learning rate; then ema = d ema + (1 - d) p.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .cunet import Arch, Params, precision, unet
from .philox import mix_seed


def gamma(params: Params, t) -> torch.Tensor:
    return params["schedule.b"] + params["schedule.w"].abs() * t


def times(u: torch.Tensor, batch: int) -> torch.Tensor:
    ladder = torch.arange(batch, device=u.device, dtype=torch.float32) / batch
    return torch.remainder(u + ladder, 1.0)


def diffusion_term(arch: Arch, params: Params, batch: dict, t, eps,
                   prec: str, dropout_seed=None, remat: bool = False,
                   rows=None) -> torch.Tensor:
    """The diffusion term's share of ``rows`` (a slice of the batch; all of
    it by default): 1/2 sum over those rows of |w| mse / B."""
    x = batch["x"].float()
    B = x.shape[0]
    rows = rows or slice(0, B)
    x, eps, t = x[rows], eps[rows], t[rows]
    s_cond = batch.get("conditioning")
    s_cond = None if s_cond is None else s_cond[rows]
    v_conds = [v[rows] for v in batch.get("conditioning_values") or ()]
    bshape = (-1,) + (1,) * (x.ndim - 1)
    g_t = gamma(params, t)
    z_t = (torch.sqrt(torch.sigmoid(-g_t)).reshape(bshape) * x
           + torch.sqrt(torch.sigmoid(g_t)).reshape(bshape) * eps)
    eps_hat = unet(arch, params, z_t, t, s_cond, v_conds, prec,
                   dropout_seed, remat, row=rows.start)
    mse = torch.mean(torch.square(eps - eps_hat), dim=tuple(range(1, x.ndim)))
    return 0.5 * torch.sum(params["schedule.w"].abs() * mse) / B


def prior_terms(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The latent term at t = 1 and the reconstruction term at t = 0."""
    g1, g0 = gamma(params, 1.0), gamma(params, 0.0)
    latent = 0.5 * (torch.sigmoid(-g1) * torch.mean(torch.square(x.float()))
                    + torch.sigmoid(g1) - torch.log(torch.sigmoid(g1)) - 1.0)
    recon = 0.5 * (1.0 + torch.log(2.0 * math.pi * torch.sigmoid(g0)
                                   / torch.sigmoid(-g0)))
    return latent + recon


def loss(arch: Arch, params: Params, batch: dict, t, eps, prec: str,
         dropout_seed=None, remat: bool = False) -> torch.Tensor:
    return (diffusion_term(arch, params, batch, t, eps, prec, dropout_seed,
                           remat) + prior_terms(params, batch["x"]))


def sampler_step(arch: Arch, params: Params, z_t, t: float, s: float, eps,
                 s_cond, v_conds, prec: str):
    """(z_s, eps_hat, d z_s / d eps_hat) of one ancestral step t -> s."""
    g_t, g_s = gamma(params, t), gamma(params, s)
    a_t, s_t = torch.sqrt(torch.sigmoid(-g_t)), torch.sqrt(torch.sigmoid(g_t))
    a_s, s_s = torch.sqrt(torch.sigmoid(-g_s)), torch.sqrt(torch.sigmoid(g_s))
    c = -torch.expm1(g_s - g_t)
    tb = torch.full((z_t.shape[0],), float(t), device=z_t.device)
    eps_hat = unet(arch, params, z_t, tb, s_cond, v_conds, prec)
    x0 = (z_t - s_t * eps_hat) / a_t
    z_s = (a_s / a_t) * (1.0 - c) * z_t + a_s * c * x0 + s_s * torch.sqrt(c) * eps
    return z_s, eps_hat, -a_s * c * s_t / a_t


def follow_training(arch: Arch, params0: Params, opt: dict,
                    batches: Sequence[dict], step_seed: int, prec: str,
                    remat: bool = True) -> Dict[str, object]:
    """Runs ``len(batches)`` train steps from ``params0`` with the times and
    noise drawn as the program draws them from a device generator seeded
    with ``step_seed`` (per step: one uniform, then a normal of x's shape)
    and the step's dropout seed ``mix_seed(step_seed, step)``. Returns each
    step's loss, each leaf's clipped-gradient norm at the first step, and
    each leaf's change and, where ``opt["ema_decay"]`` keeps an EMA, its EMA
    change (from params0) after the last."""
    device = next(iter(params0.values())).device
    names = list(params0)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params0.items()}
    nu = {k: torch.zeros_like(v) for k, v in params0.items()}
    ema = ({k: v.detach().clone() for k, v in params0.items()}
           if opt["ema_decay"] > 0 else {})
    b1, b2, eps_adam = opt["b1"], opt["b2"], opt["eps"]
    gen = torch.Generator(device=device).manual_seed(step_seed)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with precision(prec):
        for step, batch in enumerate(batches):
            x = batch["x"]
            u = torch.rand((), generator=gen, device=device)
            t = times(u, x.shape[0])
            eps = torch.randn(x.shape, generator=gen, device=device,
                              dtype=torch.float32)
            seed = mix_seed(step_seed, step)
            # one sample at a time (the sum of their terms is the loss)
            terms = [(lambda b=b: diffusion_term(
                arch, params, batch, t, eps, prec, seed, remat,
                rows=slice(b, b + 1))) for b in range(x.shape[0])]
            terms.append(lambda: prior_terms(params, x))
            g = [torch.zeros_like(params[k]) for k in names]
            value = 0.0
            for term in terms:
                part = term()
                grads = torch.autograd.grad(
                    part, [params[k] for k in names], allow_unused=True)
                value += float(part.detach())
                for acc, gr in zip(g, grads):
                    if gr is not None:
                        acc.add_(gr)
                del part, grads
            losses.append(value)
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(v * v) for v in g))
                if opt["grad_clip"] > 0 and float(norm) >= opt["grad_clip"]:
                    g = [v * (opt["grad_clip"] / norm) for v in g]
                if step == 0:
                    grad_norms = {k: float(v.norm()) for k, v in zip(names, g)}
                k_count = step + 1
                for k, v in zip(names, g):
                    mu[k].mul_(b1).add_(v, alpha=1.0 - b1)
                    nu[k].mul_(b2).addcmul_(v, v, value=1.0 - b2)
                    upd = (mu[k] / (1.0 - b1 ** k_count)) / (
                        torch.sqrt(nu[k] / (1.0 - b2 ** k_count)) + eps_adam)
                    if opt["weight_decay"]:
                        upd = upd + opt["weight_decay"] * params[k]
                    params[k].sub_(opt["learning_rate"] * upd)
                    if opt["ema_decay"] > 0:
                        ema[k].mul_(opt["ema_decay"]).add_(
                            params[k], alpha=1.0 - opt["ema_decay"])
    out = {"losses": losses, "grad_norms": grad_norms}
    with torch.no_grad():
        out["change"] = {k: float((params[k] - params0[k]).norm())
                         for k in names}
        if opt["ema_decay"] > 0:
            out["ema_change"] = {k: float((ema[k] - params0[k]).norm())
                                 for k in names}
    return out
