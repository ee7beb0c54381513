"""Train and eval steps: counterpart of ``vdm4cdm_tpu/train/step.py``.

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

Sharded (the model's UNet holds a ``ctx`` whose mesh has more than one rank,
``vdm4cdm_tpu/train/step.py:79-135``), each rank runs the loss on its slab
of the batch and its local-mean loss backward; then one all-reduce of the
flattened gradients over the whole (data x sp) job, divided by its size, is
JAX's ``pmean`` over both axes (equal slabs: the mean of local means is the
global mean). The metrics are averaged the same way, ``grad_norm`` is taken
after the reduction, and the optimizer step runs identically on every rank,
so parameters that start equal (built from one seed) stay bitwise equal.
The rank's generator for t is seeded on the host from the generator's
initial seed, the step number and the data index, so that t is shared across
``sp`` and differs across data; the same host seed goes to the loss, which
folds the ``sp`` index into it for eps and dropout, so a sharded step reads
nothing back from the device either.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..ops.kernels.philox import mix_seed
from ..parallel.halo import ShardCtx
from ..parallel.shard import (mean_over_mesh_, rank_generator,
                              seeded_generator)
from .state import Optimizer, TrainState

Metrics = Dict[str, torch.Tensor]


def make_train_step(
    model,
    optimizer: Optimizer,
    ema_decay: float = 0.0,
) -> Callable[[TrainState, dict, torch.Generator], Tuple[TrainState, Metrics]]:
    """Returns ``step(state, batch, generator) -> (state, metrics)`` for
    ``model`` (a VDM or an SFM), which must be ``state.model``. Updates in
    place. Sharded, ``batch`` is this rank's slab
    (:func:`~vdm4cdm_torch.parallel.shard.local_slab`) and ``generator`` is
    seeded alike on every rank."""
    shard = model_ctx(model)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        for p in model.parameters():
            p.grad = None
        seed = mix_seed(generator.initial_seed(), state.step)
        gen = generator
        if shard.world_size > 1:
            seed = mix_seed(seed, shard.data_index)
            gen = seeded_generator(generator.device, seed)
        losses = model.loss(batch, gen, train=True, dropout_seed=seed)
        losses.loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in model.named_parameters()}
        metrics = {k: v.detach() for k, v in losses._asdict().items()}
        if shard.world_size > 1:
            grads = _mesh_mean(grads, shard)
            metrics = _mesh_mean(metrics, shard)
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
    """Validation loss: no dropout, no gradient, no update. Sharded, the
    batch is this rank's slab, the generator's stream folds in the data
    index and the metrics are averaged over the mesh."""
    shard = model_ctx(model)

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator) -> Metrics:
        if shard.world_size == 1:
            return model.loss(batch, generator, train=False)._asdict()
        gen = rank_generator(generator, shard.data_index)
        return _mesh_mean(model.loss(batch, gen, train=False)._asdict(),
                          shard)

    return eval_step


def model_ctx(model) -> ShardCtx:
    """The :class:`ShardCtx` of a VDM's or an SFM's UNet."""
    net = getattr(model, "score_model", None) or model.velocity_model
    return net.ctx


def _mesh_mean(tensors: Dict[str, torch.Tensor], shard: ShardCtx
               ) -> Dict[str, torch.Tensor]:
    """Each tensor's mean over the mesh, through one all-reduce of them all
    flattened into one f32 buffer."""
    names = list(tensors)
    flat = torch.cat([tensors[k].detach().float().reshape(-1)
                      for k in names])
    mean_over_mesh_(flat, shard)
    out, i = {}, 0
    for k in names:
        t = tensors[k]
        out[k] = flat[i:i + t.numel()].reshape(t.shape).to(t.dtype)
        i += t.numel()
    return out
