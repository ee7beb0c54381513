"""Variational Diffusion Model: the ELBO loss and the ancestral sampler,
counterpart of ``vdm4cdm_tpu/diffusion/vdm.py``.

Variance preserving, alpha^2 = sigmoid(-gamma), sigma^2 = sigmoid(gamma).
Ancestral step t -> s (s < t), with c = -expm1(gamma_s - gamma_t):

    x0t = (z_t - sigma_t eps_hat) / alpha_t
    z_s = (alpha_s / alpha_t)(1 - c) z_t + (alpha_s c) x0t + sigma_s sqrt(c) eps

Noise comes from an explicit ``torch.Generator`` on the model's device. JAX's
threefry streams cannot be reproduced in torch, so every entry also takes its
randomness injected (``eps=`` for one step, ``noise=(z_init, eps_steps)`` for
``draw_samples``, ``t=``, ``eps=`` and ``dropout_seed=`` for ``loss``), which
is how the tests hold it against the JAX package.

Under spatial sharding (the score model's ``ctx`` is sharded) every entry
runs on this rank's slab, as the JAX functions do inside ``shard_map``:
``loss`` draws t from ``generator`` (held in the same state on the ranks of
one ``sp`` group, so the slab's voxels share their sample's t) and its eps
from :func:`~vdm4cdm_torch.parallel.shard.eps_generator` with the ``sp``
index folded in (seeded on the host from a given ``dropout_seed``), and
folds that index into the dropout seed
(``vdm4cdm_tpu/diffusion/vdm.py:142-146``); ``draw_samples`` folds it into
its whole noise stream (:254-256). Injected noise is this rank's slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.cunet import CUNet
from ..ops.kernels.philox import mix_seed
from ..parallel.shard import eps_generator, rank_generator
from .schedule import NoiseSchedule, alpha_sigma


class VDMLosses(NamedTuple):
    loss: torch.Tensor
    diffusion: torch.Tensor
    latent: torch.Tensor
    recon: torch.Tensor
    gamma_0: torch.Tensor
    gamma_1: torch.Tensor


def _bshape(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-batch scalars v (B,) broadcast over x's trailing dims."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1)).to(x.dtype)


class VDM(nn.Module):
    """A CUNet score model and its noise schedule. ``state_dict`` keys are
    ``score_model.*`` and ``schedule.*`` (the JAX tree's ``unet`` and
    ``gamma``)."""

    def __init__(self, score_model: CUNet, schedule: NoiseSchedule):
        super().__init__()
        self.score_model = score_model
        self.schedule = schedule

    @property
    def sample_shape_nlast(self) -> Tuple[int, ...]:
        c, *spatial = self.score_model.shape
        return tuple(spatial) + (c,)

    @property
    def device(self) -> torch.device:
        return self.score_model.conv_in.kernel.device

    @property
    def local_sample_shape_nlast(self) -> Tuple[int, ...]:
        """This rank's slab of ``sample_shape_nlast``."""
        shape = list(self.sample_shape_nlast)
        ctx = self.score_model.ctx
        shape[ctx.spatial_dim] //= ctx.size
        return tuple(shape)

    def gamma(self, t) -> torch.Tensor:
        return self.schedule.gamma(t).to(self.device)

    def eps_hat(self, z, t, s_conditioning=None, v_conditionings=(),
                train: bool = False,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        return self.score_model(z, t, s_conditioning=s_conditioning,
                                v_conditionings=v_conditionings, train=train,
                                dropout_seed=dropout_seed)

    def _normal(self, shape, generator, eps):
        if eps is not None:
            return eps.to(self.device, torch.float32)
        if generator is None:
            raise ValueError("pass a torch.Generator or the noise itself")
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=torch.float32)

    def loss(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
        *,
        t: Optional[torch.Tensor] = None,
        eps: Optional[torch.Tensor] = None,
        dropout_seed: Optional[int] = None,
    ) -> VDMLosses:
        """The per-element ELBO terms of a batch ``{"x": (B, *spatial, C),
        "conditioning": (B, *spatial, Cs) or None, "conditioning_values":
        [(B, d), ...]}``, channels-last.

        Times are low-discrepancy: one uniform offset plus an arithmetic
        ladder mod 1. The reconstruction term at t = 0 is in closed form
        (1/2 (1 + log 2 pi sigma_0^2 / alpha_0^2)), so no second noise volume
        is drawn. ``t`` (B,), ``eps`` (x's shape) and ``dropout_seed`` (a host
        integer) can be injected; otherwise they come from ``generator``.
        Drawing the dropout seed reads one integer back from the generator's
        device; a caller that counts its steps passes the seed instead, and
        sharded that seed also seeds this rank's eps on the host.
        Sharded, ``batch`` and ``eps`` are this rank's slabs (see the module
        docstring)."""
        dev = self.device
        x = batch["x"].to(dev, torch.float32)
        s_cond = batch.get("conditioning")
        v_conds = batch.get("conditioning_values") or []
        if s_cond is not None:
            s_cond = s_cond.to(dev)
        v_conds = [v.to(dev) for v in v_conds]
        b = x.shape[0]
        if generator is None and (t is None or eps is None):
            raise ValueError("pass a torch.Generator or t and eps themselves")
        if t is None:
            u0 = torch.rand((), generator=generator, device=dev)
            ladder = torch.arange(b, device=dev, dtype=torch.float32) / b
            t = torch.remainder(u0 + ladder, 1.0)
        else:
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        shard = self.score_model.ctx
        if eps is None and shard.sharded:
            generator_eps = eps_generator(generator, dropout_seed,
                                          shard.index)
        else:
            generator_eps = generator
        eps = self._normal(x.shape, generator_eps, eps)
        drops = train and self.score_model.dropout_prob > 0.0
        if drops and dropout_seed is None:
            if generator is None:
                raise ValueError("train=True with dropout needs a "
                                 "torch.Generator or a dropout_seed")
            dropout_seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=generator,
                device=generator.device).item())
        if drops and shard.sharded:
            dropout_seed = mix_seed(int(dropout_seed), shard.index)

        g_t = self.gamma(t)
        alpha_t, sigma_t = alpha_sigma(g_t)
        z_t = _bshape(x, alpha_t) * x + _bshape(x, sigma_t) * eps
        eps_hat = self.eps_hat(z_t, t, s_cond, v_conds, train=train,
                               dropout_seed=dropout_seed if drops else None)

        mse = torch.mean(torch.square(eps - eps_hat),
                         dim=tuple(range(1, x.ndim)))
        g_prime = self.schedule.gamma_prime(t).to(dev)
        loss_diff = 0.5 * torch.mean(g_prime * mse)

        # latent (prior) loss at t = 1, per element
        g_1 = self.gamma(1.0)
        sigma_1_sq = torch.sigmoid(g_1)
        mean_sq = torch.sigmoid(-g_1) * torch.mean(torch.square(x))
        loss_latent = 0.5 * (mean_sq + sigma_1_sq - torch.log(sigma_1_sq)
                             - 1.0)

        # reconstruction loss at t = 0 (continuous Gaussian decoder)
        g_0 = self.gamma(0.0)
        var0 = torch.sigmoid(g_0) / torch.sigmoid(-g_0)
        loss_recon = 0.5 * (1.0 + torch.log(2.0 * math.pi * var0))

        total = loss_diff + loss_latent + loss_recon
        return VDMLosses(total, loss_diff, loss_latent, loss_recon, g_0, g_1)

    def sample_zt_given_zs(self, zs, t, s, generator=None,
                           eps: Optional[torch.Tensor] = None):
        """Forward diffusion q(z_t | z_s) for t > s."""
        g_t, g_s = self.gamma(t), self.gamma(s)
        alpha_t, _ = alpha_sigma(g_t)
        alpha_s, _ = alpha_sigma(g_s)
        c = -torch.expm1(g_s - g_t)
        eps = self._normal(zs.shape, generator, eps)
        return (alpha_t / alpha_s) * zs + torch.sqrt(torch.sigmoid(g_t) * c) * eps

    def ddnm_coeffs(self, zt, t, s, s_conditioning=None, v_conditionings=()):
        """(w_z, w_x0t, x0t, scale) with z_s = w_z z_t + w_x0t x0t + scale eps."""
        g_t, g_s = self.gamma(t), self.gamma(s)
        alpha_t, sigma_t = alpha_sigma(g_t)
        alpha_s, sigma_s = alpha_sigma(g_s)
        c = -torch.expm1(g_s - g_t)
        t_b = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        t_b = t_b.expand(zt.shape[0])
        eps_hat = self.eps_hat(zt, t_b, s_conditioning, v_conditionings)
        x0t = (zt - sigma_t * eps_hat) / alpha_t
        w_z = (alpha_s / alpha_t) * (1.0 - c)
        w_x0t = alpha_s * c
        scale = sigma_s * torch.sqrt(c)
        return w_z, w_x0t, x0t, scale

    def sample_zs_given_zt(self, zt, t, s, generator=None,
                           s_conditioning=None, v_conditionings=(),
                           eps: Optional[torch.Tensor] = None):
        w_z, w_x0t, x0t, scale = self.ddnm_coeffs(
            zt, t, s, s_conditioning, v_conditionings)
        eps = self._normal(zt.shape, generator, eps)
        return w_z * zt + w_x0t * x0t + scale * eps

    @torch.inference_mode()
    def draw_samples(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: int = 1,
        n_sampling_steps: int = 250,
        s_conditioning: Optional[torch.Tensor] = None,
        v_conditionings: Sequence[torch.Tensor] = (),
        sample_shape: Optional[Tuple[int, ...]] = None,
        noise: Optional[Tuple[torch.Tensor, Sequence[torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """Ancestral sampling from the prior: normalized samples, channels-
        last (B, *spatial, C), f32. ``generator`` draws the initial z and
        each step's eps on the model's device; ``noise=(z_init, eps_steps)``
        injects them instead (eps_steps[i] is step i's eps). Sharded, the
        samples, the conditioning and the injected noise are this rank's
        slabs (``sample_shape`` defaults to the local one) and the noise
        stream folds in the ``sp`` index."""
        shape = (batch_size,) + tuple(sample_shape
                                      or self.local_sample_shape_nlast)
        if noise is None and self.score_model.ctx.sharded:
            if generator is None:
                raise ValueError("pass a torch.Generator or the noise itself")
            generator = rank_generator(generator,
                                       self.score_model.ctx.index)
        if noise is not None:
            z_init, eps_steps = noise
            if len(eps_steps) != n_sampling_steps:
                raise ValueError(f"{len(eps_steps)} eps for "
                                 f"{n_sampling_steps} steps")
            z = z_init.to(self.device, torch.float32)
        else:
            z = self._normal(shape, generator, None)
        steps = torch.linspace(1.0, 0.0, n_sampling_steps + 1,
                               dtype=torch.float32).tolist()
        for i in range(n_sampling_steps):
            eps = eps_steps[i] if noise is not None else None
            z = self.sample_zs_given_zt(
                z, steps[i], steps[i + 1], generator,
                s_conditioning=s_conditioning,
                v_conditionings=v_conditionings, eps=eps)
        alpha_0, _ = alpha_sigma(self.gamma(0.0))
        return z / alpha_0
