"""The port's counterparts of ``__graft_entry__.py``'s ``entry()`` and
``dryrun_multichip(n)`` (``vdm4cdm_torch/parallel/dryrun.py``), on the CPU.

  * ``entry(device="cpu")``: the flagship's eps prediction at 32^3, batch 1,
    finite, f32, of its inputs' shape, from a model equal in its parameters'
    names and shapes to the JAX entry's tree (converted names); without a
    card and without a device it raises.
  * ``dryrun_multichip(2)`` and ``(4)``: gloo jobs on the meshes (1, 2) and
    (1, 4) of ``pick_mesh_shape`` (JAX's ``_pick_mesh_shape``); every
    stage runs within the default budget and gives a finite loss.
  * The budget: a stage whose estimate exceeds what is left is skipped on
    every rank, with the explicit line, in a one-rank group of this process.
"""

import datetime
import math
import time

import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
from vdm4cdm_torch.parallel import dryrun


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run one thread each; so does this process's part."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_entry_runs_the_flagship_forward_on_the_cpu(monkeypatch):
    fn, args = dryrun.entry(device="cpu")
    z, t, cond, vvals = args
    assert z.shape == cond.shape == (1, 32, 32, 32, 1)
    assert t.shape == (1,) and vvals.shape == (1, 6)
    y = fn(*args)
    assert y.dtype == torch.float32 and y.shape == z.shape
    assert bool(torch.isfinite(y).all())
    net = fn.model.score_model
    assert net.chs == (32, 64, 128, 256) and net.mid_attn is False
    assert net.conv_padding_mode == "circular"
    assert (net.s_conditioning_channels, net.v_conditioning_dims) == (1, (6,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


def test_mesh_shape_is_the_jax_dry_runs():
    for n in (1, 2, 3, 4, 6, 8, 12):
        assert dryrun.pick_mesh_shape(n) == jentry._pick_mesh_shape(n), n


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_completes(n, capfd):
    out = dryrun.dryrun_multichip(n)
    assert set(out) == {"vdm", "sfm", "mid_attn", "conv_norm"}
    for stage, loss in out.items():
        assert loss is not None and math.isfinite(loss), stage
    printed = capfd.readouterr().out
    assert f"mesh=(data=1, sp={n})" in printed
    assert printed.count(" OK") == 4 and "SKIPPED" not in printed


def test_a_stage_past_the_budget_is_skipped(tmp_path, capfd):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        now = time.monotonic()
        assert dryrun._run_stage(1, 0, now - 1e6, 0.0)  # stage 1 always runs
        assert dryrun._run_stage(4, 0, now, 600.0)
        assert not dryrun._run_stage(2, 0, now - 400.0, 420.0)
    finally:
        dist.destroy_process_group()
    printed = capfd.readouterr().out
    assert "[dryrun_multichip] stage 2 (SFM zeros) SKIPPED (budget:" in printed
    assert printed.count("SKIPPED") == 1
