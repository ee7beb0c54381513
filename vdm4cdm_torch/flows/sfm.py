"""SFM: (stochastic) flow matching on the shared CUNet backbone, counterpart
of ``vdm4cdm_tpu/flows/sfm.py``.

A velocity network is trained to transport the conditioning field x0 to the
target field x1, on batch dicts ``{"x0", "x1", "conditioning_values"}``.

    Stochastic interpolant:  x_t = (1 - t) x0 + t x1 + sigma sqrt(t (1 - t)) eps
    Velocity target:         v* = x1 - x0 + sigma d/dt[sqrt(t (1 - t))] eps

With sigma = 0 this is the deterministic linear interpolant (rectified flow)
objective || v_theta(x_t, t) - (x1 - x0) ||^2. Sampling integrates the learned
transport from x0 with Euler or Heun steps of the probability-flow ODE, or
with Euler-Maruyama steps of the marginal-preserving SDE.

Noise comes from an explicit ``torch.Generator`` on the model's device. JAX's
threefry streams cannot be reproduced in torch, so every entry also takes its
randomness injected (``t=``, ``eps=`` and ``dropout_seed=`` for ``loss``,
``noise=(eps_start, eps_steps)`` for ``draw_samples``), which is how the tests
hold it against the JAX package.

Under spatial sharding (the velocity model's ``ctx`` is sharded) ``loss``
runs on this rank's slab: t comes from ``generator`` (held in the same state
on the ranks of one ``sp`` group), eps from
:func:`~vdm4cdm_torch.parallel.shard.eps_generator` with the ``sp`` index
folded in (seeded on the host from the dropout seed where there is one), and
the dropout seed folds that index in too
(``vdm4cdm_tpu/flows/sfm.py:94-98``). ``draw_samples`` folds nothing: the
sharded sampler (``parallel/sampling.py``) hands it a rank's generator.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.cunet import CUNet
from ..ops.kernels.philox import mix_seed
from ..parallel.shard import eps_generator

METHODS = ("euler", "heun", "sde")


class SFMLosses(NamedTuple):
    loss: torch.Tensor


def _bshape(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-batch scalars v (B,) broadcast over x's trailing dims."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1)).to(x.dtype)


class SFM(nn.Module):
    """A CUNet velocity model. ``state_dict`` keys are ``unet.*`` (the JAX
    tree's ``unet``). ``sigma`` is the stochastic interpolant's noise scale
    (0 = deterministic); ``t_eps`` keeps t away from {0, 1}, where the
    derivative of sqrt(t (1 - t)) blows up."""

    def __init__(self, velocity_model: CUNet, sigma: float = 0.0,
                 t_eps: float = 1e-3):
        super().__init__()
        self.unet = velocity_model
        self.sigma = float(sigma)
        self.t_eps = float(t_eps)

    @property
    def velocity_model(self) -> CUNet:
        return self.unet

    @property
    def sample_shape_nlast(self) -> Tuple[int, ...]:
        c, *spatial = self.unet.shape
        return tuple(spatial) + (c,)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.kernel.device

    def velocity(self, x, t, v_conditionings=(), s_conditioning=None,
                 train: bool = False,
                 dropout_seed: Optional[int] = None) -> torch.Tensor:
        return self.unet(x, t, s_conditioning=s_conditioning,
                         v_conditionings=v_conditionings, train=train,
                         dropout_seed=dropout_seed)

    def _s_cond(self, x0: torch.Tensor) -> Optional[torch.Tensor]:
        """x0 doubles as the velocity net's spatial conditioning channel when
        the net was built with one; nets without s channels get None."""
        return x0 if self.unet.s_conditioning_channels else None

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
    ) -> SFMLosses:
        """The flow-matching loss of a batch ``{"x0": (B, *spatial, C), "x1":
        (B, *spatial, C), "conditioning_values": [(B, d), ...]}``,
        channels-last.

        Times are low-discrepancy (one uniform offset plus an arithmetic
        ladder mod 1) clipped to [t_eps, 1 - t_eps]; ``t`` is taken before
        the clip. ``t`` (B,), ``eps`` (x0's shape, used when sigma > 0) and
        ``dropout_seed`` (a host integer) can be injected; otherwise they
        come from ``generator``. Drawing the dropout seed reads one integer
        back from the generator's device; a caller that counts its steps
        passes the seed instead. Sharded, ``batch`` and ``eps`` are this
        rank's slabs (see the module docstring)."""
        dev = self.device
        x0 = batch["x0"].to(dev, torch.float32)
        x1 = batch["x1"].to(dev, torch.float32)
        v_conds = [v.to(dev) for v in batch.get("conditioning_values") or []]
        b = x0.shape[0]
        noisy = self.sigma > 0.0
        if generator is None and (t is None or (noisy and eps is None)):
            raise ValueError("pass a torch.Generator or t and eps themselves")
        if t is None:
            u0 = torch.rand((), generator=generator, device=dev)
            ladder = torch.arange(b, device=dev, dtype=torch.float32) / b
            t = torch.remainder(u0 + ladder, 1.0)
        else:
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        t = torch.clamp(t, self.t_eps, 1.0 - self.t_eps)
        tb = _bshape(x0, t)
        drops = train and self.unet.dropout_prob > 0.0
        if drops and dropout_seed is None:
            if generator is None:
                raise ValueError("train=True with dropout needs a "
                                 "torch.Generator or a dropout_seed")
            dropout_seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=generator,
                device=generator.device).item())
        shard = self.unet.ctx
        step_seed = dropout_seed
        if drops and shard.sharded:
            dropout_seed = mix_seed(int(dropout_seed), shard.index)

        xt = (1.0 - tb) * x0 + tb * x1
        target = x1 - x0
        if noisy:
            generator_eps = generator
            if eps is None and shard.sharded:
                generator_eps = eps_generator(generator, step_seed,
                                              shard.index)
            eps = self._normal(x0.shape, generator_eps, eps)
            g = torch.sqrt(tb * (1.0 - tb))
            gdot = (1.0 - 2.0 * tb) / (2.0 * g)
            xt = xt + self.sigma * g * eps
            target = target + self.sigma * gdot * eps

        v_hat = self.velocity(xt, t, v_conds, self._s_cond(x0), train=train,
                              dropout_seed=dropout_seed if drops else None)
        return SFMLosses(torch.mean(torch.square(v_hat - target)))

    @torch.inference_mode()
    def draw_samples(
        self,
        x0: torch.Tensor,
        n_sampling_steps: int = 250,
        v_conditionings: Sequence[torch.Tensor] = (),
        method: str = "heun",
        generator: Optional[torch.Generator] = None,
        churn: float = 1.0,
        noise: Optional[Tuple[torch.Tensor,
                              Optional[Sequence[torch.Tensor]]]] = None,
    ) -> torch.Tensor:
        """Transport x0 (the conditioning field, (B, *spatial, C)) to a sample
        of the target field; f32, channels-last.

        ``euler`` and ``heun`` integrate dx/dt = v_theta(x, t) and are
        deterministic given the start point. With a noise source (a
        ``generator`` or ``noise``) and sigma > 0 the start point is the
        interpolant's marginal at t0 = t_eps with its unknown O(t0) x1 term
        dropped, x_start = (1 - t0) x0 + sigma g(t0) eps, and the time grid is
        warped quadratically, ts = t0 + (1 - t0) u^2, which puts
        near-geometric steps where the ideal velocity expands the start noise
        at rate ~1/(2t). ``sde`` takes Euler-Maruyama steps of
        dx = [v + (a/2) s] dt + sqrt(a) dW with a(t) = churn sigma^2 t (1 - t)
        and the score s = (2 / sigma^2)(v - (x - x0) / t); it needs sigma > 0
        and a noise source.

        ``noise=(eps_start, eps_steps)`` injects the start noise and, for
        ``sde``, each step's noise (eps_steps[i] is step i's; None for the
        ODE methods). Step times are host floats computed once: the loop
        reads nothing back from the device."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}: one of {METHODS}")
        has_noise = generator is not None or noise is not None
        if method == "sde" and (self.sigma <= 0.0 or not has_noise):
            raise ValueError("sde sampling requires sigma > 0 and a "
                             "generator or injected noise")
        eps_start, eps_steps = noise if noise is not None else (None, None)
        if method == "sde" and noise is not None:
            if eps_steps is None or len(eps_steps) != n_sampling_steps:
                raise ValueError(f"sde needs {n_sampling_steps} step noises")
        dev = self.device
        x0 = x0.to(dev, torch.float32)
        v_conditionings = [v.to(dev) for v in v_conditionings]
        bsz = x0.shape[0]
        t0 = self.t_eps if (has_noise and self.sigma > 0.0) else 0.0
        u = torch.linspace(0.0, 1.0, n_sampling_steps + 1,
                           dtype=torch.float32)
        ts_t = t0 + (1.0 - t0) * u ** 2 if t0 > 0.0 else u
        ts = ts_t.tolist()
        dts = (ts_t[1:] - ts_t[:-1]).tolist()

        if t0 > 0.0:
            g0 = math.sqrt(t0 * (1.0 - t0))
            x = (1.0 - t0) * x0 + self.sigma * g0 * self._normal(
                x0.shape, generator, eps_start)
        else:
            x = x0
        s_cond = self._s_cond(x0)

        def velocity(x, t):
            return self.velocity(x, torch.full((bsz,), t, device=dev),
                                 v_conditionings, s_cond)

        for i in range(n_sampling_steps):
            t, dt = ts[i], dts[i]
            v = velocity(x, t)
            if method == "euler":
                x = x + dt * v
            elif method == "heun":
                v1 = velocity(x + dt * v, ts[i + 1])
                x = x + 0.5 * dt * (v + v1)
            else:
                a = churn * self.sigma ** 2 * t * (1.0 - t)
                drift = v + churn * t * (1.0 - t) * (v - (x - x0) / t)
                step_eps = self._normal(
                    x.shape, generator,
                    eps_steps[i] if eps_steps is not None else None)
                x = x + dt * drift + math.sqrt(a * dt) * step_eps
        return x
