"""The port's sharded CLI (``cli.train`` / ``cli.generate`` under
``parallel.n_data`` / ``n_sp`` > 1) on the CPU, over gloo.

Two jobs of two CPU processes (``spawn_ranks``, rank functions in
``_torch_dist_worker.py``), each run once for the module: the flagship
preset ``trainVDM3D128_c_c`` cut by ``--set`` to GRF data at 16^3, chs (8, 8,
8, 8), f32, remat off.

  * In this process: a rank's fed batch (the trainer's feed under a rank's
    view of the mesh) is ``local_slab`` of the JAX package's GRF global
    batch, bit for bit, on the meshes (1, 2) and (2, 1); on (2, 2) a CAMELS
    "fit" module serves its data index's rows and the feed takes its sp
    index's planes of them, the four slabs tiling the global batch (the
    synthetic registry of ``test_torch_port_data.py``).
  * (1, 2): ``cli.train`` for 2 steps writes the parameters of 2 steps of
    the port's sharded train step driven by hand on the same feed (held
    against JAX in ``test_torch_port_sharded.py``), bit for bit on the CPU
    (the same ops in the same order); both ranks' hand parameters are the
    same bits; resumed to step 3 it equals the hand run's third step, bit
    for bit; the validation figure at step 2 comes from the sharded sampler
    and is written by rank 0 alone. ``cli.generate`` CV_12_12 writes the
    unsharded campaign's twelve (12, 1, 16, 16, 16) f32 files, and its first
    two boxes equal ``make_sharded_vdm_sampler`` driven by hand with the
    CLI's ``RngStream``, bit for bit; an SFM of ``sfm_sigma`` 0.5 through
    ``--sfm-method sde`` (its first box, ``--boxes 1``) equals
    ``make_sharded_sfm_sampler`` driven by hand, bit for bit.
  * (2, 1): ``cli.train`` takes a data-parallel step; ``cli.generate``
    refuses reps that do not split over ``n_data``, with the JAX CLI's
    message.
  * The other refusals, in this process: a world size that is not ``n_data
    * n_sp``, and a 2D model under ``n_sp`` > 1 (not ported yet).
"""

import dataclasses

import numpy as np
import pytest
import torch
from vdm4cdm_tpu.data.grf import GRFDataModule as JGRF

import _torch_dist_worker as W
from test_torch_port_data import registry  # noqa: F401 (a fixture)
import vdm4cdm_torch as vt
from vdm4cdm_torch.cli import generate, train
from vdm4cdm_torch.cli._common import require_unsharded
from vdm4cdm_torch.parallel.launch import spawn_ranks
from vdm4cdm_torch.train.loop import _DeviceFeeder

TIMEOUT = 300.0
SMALL = ["data.kind=grf", "data.cropsize=16", "model.chs=(8,8,8,8)",
         "model.remat=False", "model.compute_dtype=float32"]
SP = SMALL + ["parallel.n_sp=2", "run.ckpt_every_steps=2",
              "run.log_every_steps=1", "run.val_check_interval=2",
              "run.n_val_batches=1", "run.n_figure_sampling_steps=1"]
DATA = SMALL + ["parallel.n_data=2", "run.ckpt_every_steps=1",
                "run.val_check_interval=0"]
REPS, STEPS = 12, 1  # a sampler call's reps, the campaign's sampler steps
SFM = ["data.kind=grf", "data.cropsize=16", "model.chs=(8,8,8,8)",
       "model.remat=False", "model.sfm_sigma=0.5", "parallel.n_sp=2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run one thread each; so does this process's part."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sp_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    return spawn_ranks(W.cli_sp, 2,
                       (str(out / "runs"), SP, REPS, STEPS, SFM),
                       store_dir=str(out), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def data_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    return spawn_ranks(W.cli_data, 2, (str(out / "runs"), DATA),
                       store_dir=str(out), timeout=TIMEOUT)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


@dataclasses.dataclass(frozen=True)
class _RankView:
    """Rank ``rank``'s view of an (n_data, n_sp) mesh (rank = data index *
    n_sp + sp index): what ``local_slab`` and the feed read of a
    ``ShardCtx``, without a job."""
    n_data: int
    n_sp: int
    rank: int
    spatial_dim: int = 0

    sharded = property(lambda self: self.n_sp > 1)
    array_dim = property(lambda self: 1)
    size = property(lambda self: self.n_sp)
    index = property(lambda self: self.rank % self.n_sp)
    data_size = property(lambda self: self.n_data)
    data_index = property(lambda self: self.rank // self.n_sp)
    world_size = property(lambda self: self.n_data * self.n_sp)


@pytest.mark.parametrize("n_data,n_sp", [(1, 2), (2, 1)])
def test_rank_batches_are_slabs_of_the_jax_global_batch(n_data, n_sp):
    """Bit for bit: every rank draws the whole GRF stream and feeds its
    data index's rows and its sp index's planes of each global batch."""
    cfg = W._cli_cfg(SMALL)
    port = vt.build_datamodule(cfg, "fit").train_batches(2)
    ref = JGRF(size=16, ndim=3, batch_size=2, n_conditioning_values=6,
               mode="vdm", seed=cfg.run.seed).batches(n_batches=2)
    for batch, want in zip(port, ref):
        for rank in range(n_data * n_sp):
            view = _RankView(n_data, n_sp, rank)
            got = _DeviceFeeder(torch.device("cpu"), ctx=view).put(batch)
            rows = slice(view.data_index * 2 // n_data,
                         (view.data_index + 1) * 2 // n_data)
            planes = slice(view.index * 16 // n_sp,
                           (view.index + 1) * 16 // n_sp)
            for k in ("x", "conditioning"):
                assert got[k].shape == (2 // n_data, 16 // n_sp, 16, 16, 1)
                assert np.array_equal(got[k].numpy(),
                                      np.asarray(want[k])[rows, planes])
            assert np.array_equal(got["conditioning_values"][0].numpy(),
                                  np.asarray(want["conditioning_values"][0])
                                  [rows])


def test_camels_ranks_take_their_data_rows_and_sp_planes(registry,
                                                          monkeypatch):
    import torch.distributed as dist

    reg_dir, root = registry
    cfg = vt.preset("trainVDM3D128_c_c", **{
        "data.cropsize": 8, "data.batch_size": 2,
        "data.registry_dir": reg_dir, "data.data_root": root,
        "data.dataset_name": "CMD", "parallel.n_data": 2,
        "parallel.n_sp": 2})

    def first_val_batch(stage="fit"):
        dm = vt.build_datamodule(cfg, stage)
        dm.use_native = False
        return dm, next(dm.val_dataloader() if stage == "fit"
                        else dm.test_dataloader())

    _, full = first_val_batch()  # one process: the global batch
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    for rank in range(4):
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        dm, batch = first_val_batch()
        view = _RankView(2, 2, rank)
        assert (dm.process_index, dm.process_count) == (view.data_index, 2)
        got = _DeviceFeeder(torch.device("cpu"), ctx=view).put(
            batch, rows_local=True)
        rows = slice(view.data_index, view.data_index + 1)
        planes = slice(4 * view.index, 4 * view.index + 4)
        for k in ("x", "conditioning"):
            assert np.array_equal(got[k].numpy(), full[k][rows, planes])
        assert np.array_equal(got["conditioning_values"][0].numpy(),
                              full["conditioning_values"][0][rows])
        assert vt.build_datamodule(cfg, "test").process_count == 1


def test_cli_train_equals_the_hand_driven_sharded_steps(sp_job):
    for out in sp_job:
        assert out["train_rc"] == 0
        _equal(out["ckpt_2"], out["hand_2"])


def test_the_ranks_hold_the_same_parameters(sp_job):
    _equal(sp_job[1]["hand_2"], sp_job[0]["hand_2"])
    _equal(sp_job[1]["hand_3"], sp_job[0]["hand_3"])
    assert sp_job[0]["digest_2"] == sp_job[1]["digest_2"]


def test_resume_to_step_3_equals_the_uninterrupted_steps(sp_job):
    for out in sp_job:
        assert out["resume_rc"] == 0 and out["steps"] == [2, 3]
        _equal(out["ckpt_3"], out["hand_3"])
    # the third step moved the parameters
    assert any(not np.array_equal(sp_job[0]["hand_3"][k],
                                  sp_job[0]["hand_2"][k])
               for k in sp_job[0]["hand_2"])


def test_validation_figure_is_drawn_on_rank_0(sp_job):
    assert sp_job[0]["figures"] == ["validation_00000002.png"]


def test_generate_writes_the_unsharded_campaigns_files(sp_job):
    assert [out["generate_rc"] for out in sp_job] == [0, 0]
    files = sp_job[0]["files"]
    assert sorted(files) == sorted(f"gen_{i}.npy" for i in range(12))
    assert set(files.values()) == {((12, 1, 16, 16, 16), "float32", True)}
    first, second = sp_job[0]["file_fields"]
    assert not np.array_equal(first, second)


def test_generate_equals_the_sharded_sampler_driven_by_hand(sp_job):
    """Exact on the CPU: the same sampler, model, conditioning and
    generators (tolerance 0)."""
    for i, field in enumerate(sp_job[0]["file_fields"]):
        for out in sp_job:
            assert np.array_equal(out["hand_fields"][i], field)


def test_sfm_campaign_equals_the_sharded_sde_sampler_driven_by_hand(
        sp_job):
    """An SFM of sigma 0.5 through ``--sfm-method sde``: the first box's
    file, bit for bit, is ``make_sharded_sfm_sampler`` with the CLI's first
    generator (tolerance 0)."""
    assert [(o["sfm_train_rc"], o["sfm_generate_rc"]) for o in sp_job] == [
        (0, 0), (0, 0)]
    files = sp_job[0]["sfm_files"]
    assert sorted(files) == ["gen_0.npy"]
    field = files["gen_0.npy"]
    assert field.shape == (12, 1, 16, 16, 16) and np.isfinite(field).all()
    for out in sp_job:
        assert np.array_equal(out["sfm_hand"], field)


def test_data_parallel_cli_takes_a_step(data_job):
    assert [out["train_rc"] for out in data_job] == [0, 0]
    _equal(data_job[1]["params"], data_job[0]["params"])


def test_reps_must_be_a_multiple_of_n_data(data_job):
    for out in data_job:
        code, err = out["reps_error"]
        assert code == 2
        assert ("--reps-per-batch (3) must be a multiple of parallel.n_data "
                "(2)") in err


def test_the_world_size_must_equal_the_mesh(tmp_path):
    with pytest.raises(ValueError, match=r"1 rank\(s\) but parallel.n_data "
                       r"\* parallel.n_sp = 1 \* 2 = 2"):
        train.main(["--preset", "trainVDM3D128_c_c", "--device", "cpu",
                    "--set", *SMALL, "parallel.n_sp=2",
                    f"run.out_dir={tmp_path}"])
    with pytest.raises(ValueError, match=r"parallel.n_data \* parallel.n_sp"
                       r" = 2 \* 1"):
        generate.main(["trainVDM3D128_c_c", str(tmp_path / "g"), "CV_12_12",
                       "--ckpt-dir", str(tmp_path), "--device", "cpu",
                       "--set", *SMALL, "parallel.n_data=2"])


def test_a_2d_model_under_sp_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        train.main(["--preset", "smoke_vdm_2d", "--device", "cpu", "--set",
                    "parallel.n_sp=2", f"run.out_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        generate.main(["smoke_vdm_2d", str(tmp_path / "g"), "CV_12_12",
                       "--ckpt-dir", str(tmp_path), "--device", "cpu",
                       "--set", "parallel.n_sp=2"])
    # what runs: every 3D mesh, and a 2D model over data ranks alone
    for name, over in (("smoke_vdm_2d", {"n_data": 4}),
                       ("trainVDM3D128_c_c", {"n_sp": 4, "n_data": 2})):
        cfg = vt.preset(name)
        for k, v in over.items():
            setattr(cfg.parallel, k, v)
        require_unsharded(cfg)
