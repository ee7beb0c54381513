"""The ``sample`` kind: ``VDM.draw_samples``, the ancestral sampler, checked
step by step against the plain reference's sampler step
(``portbench/reference/vdm.py::sampler_step``)."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.harness import (PICKS, SAMPLES, Inputs, Window, build,
                               make_weights, stamp, sub_seed, sync)
from portbench.reference import cunet as ref_cunet
from portbench.reference import vdm as ref_vdm

FAMILIES = {"vdm"}
NUMBERS = {"start_gap", "step_eps_err"}


class _Stop(Exception):
    """Raised from the sampler's hook to end a call the window no longer
    needs."""


class Work:
    """The ancestral sampler, ``n_steps`` steps a call, ``batch`` draws of
    one conditioning box a call, calls back to back until the window's time
    is up. A call's noise comes from a device generator seeded for that
    call. The window counts sampler steps completed (a partial call counts
    its steps); once it is closed, a call is ended as soon as the checked
    steps have run."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = cfg, seed
        self.device = torch.device(device)
        self.arch = ref_cunet.Arch.from_config(cfg)
        self.batch_size = traffic["batch"]
        self.n_steps = traffic["sampler_steps"]
        picks = torch.Generator().manual_seed(sub_seed(seed, PICKS))
        later = torch.randperm(self.n_steps // 2 - 1, generator=picks)[
            :traffic["checked_steps"] - 1] + 1
        self.checked = sorted([0] + later.tolist())
        self.keep = set(self.checked) | {i + 1 for i in self.checked}

    def setup(self) -> None:
        import vdm4cdm_torch  # noqa: F401

        stamp("port_import")
        self.model = build(self.cfg, self.device)
        stamp("build")
        self.weights = make_weights(self.model, self.cfg, self.seed,
                                    self.device)
        stamp("weights")
        inputs = Inputs(self.arch, self.seed, self.device)
        box = inputs.batch(1)
        b = self.batch_size
        self.s_cond = (None if box["conditioning"] is None else
                       box["conditioning"].expand(b, *box["conditioning"]
                                                  .shape[1:]).contiguous())
        self.v_conds = [v.expand(b, -1).contiguous()
                        for v in box["conditioning_values"]]
        self.model.draw_samples(
            torch.Generator(device=self.device).manual_seed(0), b, 2,
            self.s_cond, self.v_conds)
        sync(self.device)
        stamp("warm_up")
        # host buffers for the checked steps' states, filled on the stream
        # without a synchronize: what the check keeps adds nothing to the
        # device's peak
        shape = (b,) + (self.arch.size,) * self.arch.ndim + (
            self.arch.in_channels,)
        self.buffers = {i: torch.empty(shape, pin_memory=self.device.type
                                       == "cuda") for i in self.keep}
        self.captured: Dict[int, torch.Tensor] = {}
        stamp("host_buffers")

    def call_seed(self, call: int) -> int:
        return sub_seed(self.seed, SAMPLES) ^ call

    def run_window(self, window: Window) -> dict:
        issued, call, step = [0], [0], [0]

        def hook(_module, args):
            # runs as each step's forward starts: the steps before it are
            # issued
            i = step[0]
            step[0] += 1
            if call[0] == 0 and i in self.keep:
                self.captured[i] = self.buffers[i].copy_(args[0].detach(),
                                                         non_blocking=True)
            if not window.closed:
                window.progress(issued[0])
            if window.closed and len(self.captured) == len(self.keep):
                raise _Stop
            issued[0] += 1

        handle = self.model.score_model.register_forward_pre_hook(hook)
        try:
            window.open()
            while True:
                step[0] = 0
                gen = torch.Generator(device=self.device).manual_seed(
                    self.call_seed(call[0]))
                try:
                    self.model.draw_samples(gen, self.batch_size,
                                            self.n_steps, self.s_cond,
                                            self.v_conds)
                except _Stop:
                    break
                if not window.closed:
                    window.progress(issued[0])
                if window.closed:
                    break
                call[0] += 1
        finally:
            handle.remove()
        return {"steps": window.done, "traced_steps": window.traced,
                "samples": window.done * self.batch_size / self.n_steps}

    def free(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _steps(self, prec: Optional[str]):
        """Per checked step i: (z_{i+1} of ``prec`` put in the program's
        place, or the program's where None; the reference's z_{i+1}; |d z /
        d eps_hat| * ||eps_hat||), all from the program's z_i and the noise
        of call 0; and the reference's z_init."""
        sync(self.device)
        captured = {i: z.to(self.device) for i, z in self.captured.items()}
        gen = torch.Generator(device=self.device).manual_seed(
            self.call_seed(0))
        shape = tuple(captured[0].shape)
        z_init = torch.randn(shape, generator=gen, device=self.device)
        eps = {}
        for i in range(max(self.checked) + 1):
            e = torch.randn(shape, generator=gen, device=self.device)
            if i in self.checked:
                eps[i] = e
        grid = torch.linspace(1.0, 0.0, self.n_steps + 1).tolist()
        out = []
        with torch.no_grad():
            for i in self.checked:
                z_t = captured[i]
                args = (self.arch, self.weights, z_t, grid[i], grid[i + 1],
                        eps[i], self.s_cond, self.v_conds)
                with ref_cunet.precision("f32"):
                    z_ref, eps_hat, k = ref_vdm.sampler_step(*args, "f32")
                if prec is None:
                    z_got = captured[i + 1]
                else:
                    with ref_cunet.precision(prec):
                        z_got = ref_vdm.sampler_step(*args, prec)[0]
                out.append((z_got, z_ref, float(k.abs() * eps_hat.norm())))
        return out, z_init, captured[0]

    def _compare(self, prec: Optional[str]) -> Dict[str, float]:
        if set(self.captured) != self.keep:
            # the checked steps never reached the model
            return {"start_gap": math.inf, "step_eps_err": math.inf}
        steps, z_init, z_0 = self._steps(prec)
        start = z_0 if prec is None else z_init
        return {
            "start_gap": float((start - z_init).abs().max()),
            "step_eps_err": max(float((g - r).norm()) / scale
                                for g, r, scale in steps)}

    def numbers(self) -> Dict[str, float]:
        """start_gap: the program's initial z against the reference's draw
        of the same noise (exact). step_eps_err: at each checked step, the
        gap of the program's z_{i+1} from the reference's step taken from
        the program's z_i, in units of the reference eps_hat's norm times
        the step's d z / d eps_hat (the eps_hat error the step implies);
        the worst of them. Steps are drawn from the first half of the call,
        where the field's f32 rounding is far under that unit."""
        return self._compare(None)

    def control_numbers(self, prec: str) -> Dict[str, float]:
        return self._compare(prec)
