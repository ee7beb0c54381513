"""Train state and optimizer: counterpart of ``vdm4cdm_tpu/train/state.py``.

The reference recipe is Adam at 3e-4 under a global-norm gradient clip of 0.5.
The JAX package builds it from optax (``clip_by_global_norm`` then ``adamw``);
here the same arithmetic is written out on lists of tensors with
``torch._foreach_*``, so that one step agrees with optax to f32 rounding:

  * clip: g if ||g|| < clip else g * clip / ||g|| (no epsilon in the
    denominator, unlike ``torch.nn.utils.clip_grad_norm_``);
  * Adam: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, update
    (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), b1 0.9, b2 0.999, eps
    1e-8 outside the square root; the first moment is stored in
    ``moment_dtype`` after the update used its f32 value;
  * decoupled weight decay added to the update, then the learning rate of the
    schedule at the count before this step.

Parameters, moments and EMA are updated in place: the step allocates no second
copy of the model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters; ``opt_state`` is the optimizer's
    ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``;
    ``ema_params`` maps parameter names to their moving averages (None =
    disabled)."""

    step: int
    model: nn.Module
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def make_lr_schedule(learning_rate: float,
                     warmup_steps: int = 0) -> Callable[[int], float]:
    """The learning rate at optimizer count n (0 for the first step): a
    linear warm-up from 0 over ``warmup_steps``, then constant."""
    if warmup_steps > 0:
        def schedule(count: int) -> float:
            frac = min(max(count, 0), warmup_steps) / warmup_steps
            return learning_rate * frac
        return schedule
    return lambda count: learning_rate


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's parameters, by name."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


class Optimizer:
    """Global-norm clip followed by AdamW, on the named parameters of a
    module. ``init(model)`` makes the state; ``update(model, grads, state)``
    applies one step in place and returns the gradient norm before the
    clip (a 0-d tensor: nothing is read back to the host)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 3.0e-4, grad_clip: float = 0.5,
                 weight_decay: float = 0.0, warmup_steps: int = 0,
                 moment_dtype: Optional[torch.dtype] = None):
        self.lr = make_lr_schedule(learning_rate, warmup_steps)
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.moment_dtype = moment_dtype or torch.float32

    def init(self, model: nn.Module) -> Dict[str, Any]:
        named = dict(model.named_parameters())
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=self.moment_dtype)
                   for k, p in named.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in named.items()},
        }

    @torch.no_grad()
    def update(self, model: nn.Module, grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        names = [k for k, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        g: List[torch.Tensor] = [grads[k].float() for k in names]
        mu_store = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]

        norm = torch.sqrt(torch.stack(
            [torch.sum(torch.square(t)) for t in g]).sum())
        if self.grad_clip and self.grad_clip > 0:
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            g = torch._foreach_mul(g, factor)

        count = state["count"] + 1
        mu = torch._foreach_mul([m.float() for m in mu_store], self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.lr(state["count"]))
        torch._foreach_copy_(mu_store, mu)
        state["count"] = count
        return norm


def make_optimizer(
    learning_rate: float = 3.0e-4,
    grad_clip: float = 0.5,
    weight_decay: float = 0.0,
    warmup_steps: int = 0,
    moment_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    """``moment_dtype``: dtype in which Adam's first moment is stored, e.g.
    ``torch.bfloat16`` to save device memory; None = float32."""
    return Optimizer(learning_rate, grad_clip, weight_decay, warmup_steps,
                     moment_dtype)
