"""The ``train`` kind: the train step of
``vdm4cdm_torch.train.step.make_train_step`` on a batch drawn on the device
for each step, checked against the plain reference's training
(``portbench/reference/vdm.py::follow_training``)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.harness import (STEPS, Inputs, Window, batch_to, build,
                               make_weights, median, stamp, sub_seed)
from portbench.reference import cunet as ref_cunet
from portbench.reference import vdm as ref_vdm

FAMILIES = {"vdm"}
# every number ``Work.compare`` gives; a cell's limits file names those its
# check compares
NUMBERS = {"loss_gap", "grad_gap", "grad_med_gap", "change_gap", "ema_gap"}


class Work:
    """The train step (loss, backward, clip, AdamW, and the EMA where the
    configuration keeps one) on a batch drawn for each step. Set-up runs the
    first three steps, which the reference follows; the window runs steps
    until its time is up."""

    first_steps = 3

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = cfg, seed
        self.device = torch.device(device)
        self.arch = ref_cunet.Arch.from_config(cfg)
        self.batch_size = traffic["batch"]
        self.run_cfg = cfg["config"]["run"]

    # -- the program ------------------------------------------------------
    def setup(self) -> None:
        import vdm4cdm_torch as vt

        stamp("port_import")
        model = build(self.cfg, self.device)
        stamp("build")
        self.weights = make_weights(model, self.cfg, self.seed, self.device)
        stamp("weights")
        run = self.run_cfg
        opt = vt.make_optimizer(run["learning_rate"], run["grad_clip"],
                                run["weight_decay"], run["warmup_steps"])
        self.b1 = opt.b1
        ema = vt.init_ema(model) if run["ema_decay"] > 0 else None
        self.state = vt.TrainState(0, model, opt.init(model), ema)
        self.step = vt.make_train_step(model, opt, run["ema_decay"])
        self.step_seed = sub_seed(self.seed, STEPS)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.step_seed)
        self.inputs = Inputs(self.arch, self.seed, self.device)
        self.first = [self.inputs.batch(self.batch_size)
                      for _ in range(self.first_steps)]
        losses = []
        for i, batch in enumerate(self.first):
            self.state, metrics = self.step(self.state, batch, self.gen)
            losses.append(metrics["loss"])
            if i == 0:
                mu = self.state.opt_state["mu"]
                grads = dict(zip(mu, torch.stack(
                    [v.float().norm() for v in mu.values()]).div(
                        1.0 - self.b1).tolist()))
                stamp("first_step")
        stamp("steps_2_3")
        with torch.no_grad():
            self.readings = {"losses": torch.stack(losses).tolist(),
                             "grad_norms": grads,
                             "change": self._changes(
                                 dict(model.named_parameters()))}
            if self.state.ema_params is not None:
                self.readings["ema_change"] = self._changes(
                    self.state.ema_params)
        stamp("readings")
        self.first = [batch_to(b, "cpu") for b in self.first]
        stamp("keep_batches")

    def _changes(self, params: dict) -> Dict[str, float]:
        """Each leaf's norm of its change from the drawn weights, read in one
        transfer."""
        names = list(self.weights)
        return dict(zip(names, torch.stack(
            [(params[k] - self.weights[k]).norm() for k in names]).tolist()))

    def run_window(self, window: Window) -> dict:
        window.open()
        n = 0
        while not window.closed:
            batch = self.inputs.batch(self.batch_size)
            self.state, _ = self.step(self.state, batch, self.gen)
            n += 1
            window.progress(n)
        return {"steps": window.done, "traced_steps": window.traced,
                "samples": window.done * self.batch_size}

    def free(self) -> None:
        self.state = self.step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------
    def _reference(self, prec: str) -> dict:
        run = self.run_cfg
        opt = {"b1": 0.9, "b2": 0.999, "eps": 1e-8,
               "learning_rate": run["learning_rate"],
               "grad_clip": run["grad_clip"],
               "weight_decay": run["weight_decay"],
               "ema_decay": run["ema_decay"]}
        batches = [batch_to(b, self.device) for b in self.first]
        return ref_vdm.follow_training(self.arch, self.weights, opt,
                                       batches, self.step_seed, prec)

    @staticmethod
    def compare(got: dict, ref: dict) -> Dict[str, float]:
        """The gaps of ``got`` from ``ref``. ``loss_gap``: the first step's
        loss, relative (the later steps' losses follow Adam's first update,
        which moves every element by the learning rate whatever the size of
        its gradient, so elements whose gradient is near zero flip with the
        rounding and move those losses by amounts that swing from seed to
        seed). Each leaf's first clipped-gradient norm and its change after
        the three steps, as the gap of the norms over the larger of the
        reference's norm of that leaf and of the median leaf: the worst leaf
        (``grad_gap``, ``change_gap``) and, of the gradients, the median
        leaf (``grad_med_gap``: in a bf16 model the worst leaf can be a
        one-element bias whose gradient is a sum over every output voxel that
        all but cancels, and its gap swings from seed to seed; the median
        leaf's does not); with an EMA, the median
        leaf of its changes (``ema_gap``: a thousandth of the parameters'
        change, it carries the parameters' float32 rounding). Leaves whose
        reference gradient is under a thousandth of the median leaf's move
        by round-off alone under Adam, and are left out of the changes. A
        cell's limits file names the numbers it compares."""
        loss_gap = abs(got["losses"][0] - ref["losses"][0]) / abs(
            ref["losses"][0])

        def gaps(key, names):
            med = median([ref[key][k] for k in names])
            return [abs(got[key][k] - ref[key][k])
                    / max(ref[key][k], med, 1e-30) for k in names]

        g = ref["grad_norms"]
        med_g = median(list(g.values()))
        moving = [k for k in g if g[k] >= 1e-3 * med_g]
        grad, change = gaps("grad_norms", list(g)), gaps("change", moving)
        out = {"loss_gap": loss_gap, "grad_gap": max(grad),
               "grad_med_gap": median(grad), "change_gap": max(change)}
        if "ema_change" in got:
            out["ema_gap"] = median(gaps("ema_change", moving))
        return out

    def numbers(self) -> Dict[str, float]:
        self.ref = self._reference("f32")
        return self.compare(self.readings, self.ref)

    def control_numbers(self, prec: str) -> Dict[str, float]:
        """After ``numbers``: the control put in the program's place."""
        self.control = self._reference(prec)
        return self.compare(self.control, self.ref)
