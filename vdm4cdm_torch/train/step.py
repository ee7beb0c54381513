"""Train and eval steps on one device: counterpart of the unsharded branch of
``vdm4cdm_tpu/train/step.py`` (the mesh-sharded branch comes with the
parallelism slice).

One train step is ``model.loss(train=True)`` -> backward -> global-norm clip
-> AdamW -> EMA. It updates the model's parameters, the optimizer state and
the EMA **in place** and returns the same :class:`TrainState` with its step
advanced. Metrics are 0-d tensors on the model's device (the loss fields plus
the gradient norm before the clip): the step itself reads nothing back.

The model is a :class:`~vdm4cdm_torch.diffusion.vdm.VDM` or a
:class:`~vdm4cdm_torch.flows.sfm.SFM`: both take ``loss(batch, generator,
train=, dropout_seed=)`` and return a named tuple whose ``loss`` field is
differentiated and whose every field becomes a metric (an SFM's only field is
``loss``; its batch is ``{"x0", "x1", "conditioning_values"}``).

The step's dropout seed is mixed on the host from the generator's initial
seed and the step number, so the same generator seed and state give the same
masks and no device round trip is needed.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops.kernels.philox import mix_seed
from .state import Optimizer, TrainState

Metrics = Dict[str, torch.Tensor]


def make_train_step(
    model,
    optimizer: Optimizer,
    ema_decay: float = 0.0,
) -> Callable[[TrainState, dict, torch.Generator], Tuple[TrainState, Metrics]]:
    """Returns ``step(state, batch, generator) -> (state, metrics)`` for
    ``model`` (a VDM or an SFM), which must be ``state.model``. Updates in
    place."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        for p in model.parameters():
            p.grad = None
        seed = mix_seed(generator.initial_seed(), state.step)
        losses = model.loss(batch, generator, train=True, dropout_seed=seed)
        losses.loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in model.named_parameters()}
        metrics = {k: v.detach() for k, v in losses._asdict().items()}
        metrics["grad_norm"] = optimizer.update(model, grads, state.opt_state)
        for p in model.parameters():
            p.grad = None
        ema = state.ema_params
        if ema_decay > 0.0 and ema is not None:
            with torch.no_grad():
                avg = [ema[k] for k, _ in model.named_parameters()]
                torch._foreach_mul_(avg, ema_decay)
                torch._foreach_add_(avg, list(model.parameters()),
                                    alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model) -> Callable[[dict, torch.Generator], Metrics]:
    """Validation loss: no dropout, no gradient, no update."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator) -> Metrics:
        return model.loss(batch, generator, train=False)._asdict()

    return eval_step
