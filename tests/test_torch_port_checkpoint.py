"""The port's checkpoints (``vdm4cdm_torch/train/checkpoint.py``): a format of
its own, one ``torch.save`` file per step. Save and restore round trip every
tensor bit for bit (a bf16 first moment stays bf16); every step is kept;
an EMA restored from a checkpoint without one is a copy of the parameters;
``load_params`` prefers the EMA. The errors are honest: a missing directory
or step is a ``FileNotFoundError``, a truncated file raises its own error
(never "no checkpoint"), and a JAX (orbax) checkpoint, such as the one in
``blessed/``, raises ``JaxCheckpointError``."""

import os
import pathlib

import pytest
import torch

import vdm4cdm_torch as vt
from vdm4cdm_torch.train.checkpoint import (CheckpointManager,
                                            JaxCheckpointError, all_steps,
                                            load_params, read_checkpoint)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLESSED = ROOT / "blessed" / "VDM_GRF_c_c_32" / "checkpoints"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(seed):
    cfg = vt.preset("smoke_sfm_3d", **{"data.cropsize": 8,
                                       "model.chs": (4, 8),
                                       "model.norm_groups": 2})
    return vt.build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def _state(seed, ema=True, moment_dtype=torch.bfloat16, step=0):
    model = _model(seed)
    opt = vt.make_optimizer(moment_dtype=moment_dtype)
    state = vt.TrainState(step, model, opt.init(model),
                          vt.init_ema(model) if ema else None)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():  # make every tensor distinct from a fresh state
        for t in (list(state.opt_state["mu"].values())
                  + list(state.opt_state["nu"].values())
                  + list((state.ema_params or {}).values())):
            t.copy_(torch.rand(t.shape, generator=gen))
    state.opt_state["count"] = step
    return state


def _flat(state):
    out = {f"p.{k}": p.detach() for k, p in state.model.named_parameters()}
    for part in ("mu", "nu"):
        out.update({f"{part}.{k}": t
                    for k, t in state.opt_state[part].items()})
    out.update({f"ema.{k}": t for k, t in (state.ema_params or {}).items()})
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step
    assert a.opt_state["count"] == b.opt_state["count"]


def test_save_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), every_steps=2)
    src = _state(1, step=4)
    path = mgr.save(src)
    assert path == str(tmp_path / "ckpt" / "4" / "checkpoint.pt")
    assert os.listdir(tmp_path / "ckpt" / "4") == ["checkpoint.pt"]
    assert mgr.last_save["step"] == 4
    assert mgr.last_save["bytes"] == os.path.getsize(path)
    dst = _state(2)
    assert mgr.restore(dst) is dst
    _assert_same(dst, src)
    assert all(t.dtype == torch.bfloat16
               for t in dst.opt_state["mu"].values())
    payload = read_checkpoint(str(tmp_path / "ckpt"))
    assert payload["step"] == 4
    assert all(t.dtype == torch.bfloat16 for t in payload["opt_state"]["mu"]
               .values())


def test_keep_all_and_maybe_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every_steps=2)
    assert mgr.latest_step() is None and mgr.restore(_state(0)) is None
    state = _state(3, ema=False)
    for step in range(1, 7):
        state.step = step
        assert mgr.maybe_save(state) == (step % 2 == 0)
    assert not mgr.maybe_save(state, force=True)  # step 6 is already there
    state.step = 7
    assert mgr.maybe_save(state, force=True)
    assert mgr.all_steps() == [2, 4, 6, 7] == all_steps(str(tmp_path))
    # an interrupted write leaves a temporary file, never a checkpoint
    os.makedirs(tmp_path / "9")
    (tmp_path / "9" / ".checkpoint.pt.abc").write_bytes(b"partial")
    assert mgr.latest_step() == 7
    restored = mgr.restore(_state(4, ema=False), step=4)
    assert restored.step == 4


def test_ema_restored_from_a_checkpoint_without_one_is_a_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(5, ema=False, step=3))
    dst = _state(6, ema=True)
    mgr.restore(dst)
    for k, p in dst.model.named_parameters():
        assert torch.equal(dst.ema_params[k], p.detach())
        assert dst.ema_params[k].data_ptr() != p.data_ptr()
    with torch.no_grad():
        next(dst.model.parameters()).add_(1.0)
    k0 = next(iter(dict(dst.model.named_parameters())))
    assert not torch.equal(dst.ema_params[k0],
                           dict(dst.model.named_parameters())[k0])


def test_load_params_prefers_the_ema(tmp_path):
    state = _state(7, step=2)
    CheckpointManager(str(tmp_path)).save(state)
    got = load_params(str(tmp_path))
    for k, t in state.ema_params.items():
        assert torch.equal(got[k], t)
    got = load_params(str(tmp_path), prefer_ema=False)
    for k, p in state.model.named_parameters():
        assert torch.equal(got[k], p.detach())
    model = _model(8)
    load_params(str(tmp_path), model, step=2)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[k])
    for chs, what in (((4, 4), "unused"), ((4, 12), "shape")):
        wrong = vt.build_model(vt.preset("smoke_sfm_3d", **{
            "data.cropsize": 8, "model.chs": chs, "model.norm_groups": 2}),
            device="cpu")
        with pytest.raises(ValueError, match=what):
            load_params(str(tmp_path), wrong)


def test_missing_directory_or_step_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        load_params(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="available steps"):
        load_params(str(tmp_path))  # exists, holds nothing
    CheckpointManager(str(tmp_path)).save(_state(9, step=5))
    with pytest.raises(FileNotFoundError, match=r"step=4 .*\[5\]"):
        load_params(str(tmp_path), step=4)


def test_a_truncated_file_raises_its_own_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(_state(10, step=1))
    data = pathlib.Path(path).read_bytes()
    pathlib.Path(path).write_bytes(data[: len(data) // 2])
    with pytest.raises(Exception) as info:
        load_params(str(tmp_path))
    assert not isinstance(info.value, FileNotFoundError)
    # the trainer's resume does not mistake it for "no checkpoint" either
    with pytest.raises(Exception) as info:
        mgr.restore(_state(11))
    assert not isinstance(info.value, FileNotFoundError)


def test_a_jax_checkpoint_is_named_as_such(tmp_path):
    assert (BLESSED / "20000" / "_CHECKPOINT_METADATA").exists()
    with pytest.raises(JaxCheckpointError, match="JAX"):
        load_params(str(BLESSED))
    with pytest.raises(JaxCheckpointError, match="JAX"):
        CheckpointManager(str(BLESSED)).restore(_state(12))
    with pytest.raises(JaxCheckpointError, match="JAX"):
        load_params(str(BLESSED / "20000"))
    # a foreign payload under the port's file name is no checkpoint of it
    os.makedirs(tmp_path / "1")
    torch.save({"params": {}}, tmp_path / "1" / "checkpoint.pt")
    with pytest.raises(ValueError, match="not a"):
        load_params(str(tmp_path))
