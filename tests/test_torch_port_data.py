"""The port's data modules (``vdm4cdm_torch/data/``, ``config.build_datamodule``)
against the JAX package's on the same seeds: the GRF batches in both modes,
2D and 3D, with the train replay and the val/test seeds; the transforms on
seeded arrays; the CAMELS module on a synthetic registry (fit and test
stages, the CV holdout, deterministic resume, per-process blocks); and the
native fastloader binding, on and off. Every comparison is bit for bit,
except the native path against the Python path (``log10f`` against numpy's
``log10``: two f32 ulps of the log, see the test).

The JAX side always runs its Python path (``use_native=False``): its native
binding builds ``native/libfastloader.so`` in place, which this file leaves
alone; the port builds its own copy under ``build/native/``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from vdm4cdm_tpu import config as jconfig
from vdm4cdm_tpu import presets as jpresets
from vdm4cdm_tpu.data import camels as jcamels
from vdm4cdm_tpu.data import grf as jgrf
from vdm4cdm_tpu.data import transforms as jtransforms

from vdm4cdm_torch import config as tconfig
from vdm4cdm_torch import presets as tpresets
from vdm4cdm_torch.data import camels as tcamels
from vdm4cdm_torch.data import grf as tgrf
from vdm4cdm_torch.data import native as tnative
from vdm4cdm_torch.data import transforms as ttransforms


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        if b is None:
            assert a is None
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- GRF

@pytest.mark.parametrize("ndim,size,mode", [(2, 16, "vdm"), (2, 16, "sfm"),
                                            (3, 8, "vdm"), (3, 8, "sfm")])
def test_grf_batches_are_bit_equal_to_jax(ndim, size, mode):
    kw = dict(size=size, ndim=ndim, batch_size=2, n_conditioning_values=6,
              mode=mode, slope=-2.0, seed=5)
    t, j = tgrf.GRFDataModule(**kw), jgrf.GRFDataModule(**kw)
    for a, b in zip(t.train_batches(4), j.train_batches(4)):
        _equal_batches(a, b)
    # replay from step 2 gives the uninterrupted run's batches 2 and 3
    full = list(t.train_batches(4))
    for a, b in zip(t.train_batches(4, start_step=2), full[2:]):
        _equal_batches(a, b)
    for a, b in zip(t.val_dataloader(), j.val_dataloader()):
        _equal_batches(a, b)
    test_t, test_j = list(t.test_dataloader()), list(j.test_dataloader())
    assert len(test_t) == len(test_j) == 12
    _equal_batches(test_t[11], test_j[11])


def test_grf_field_and_no_conditioning_values():
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(
        tgrf.gaussian_random_field(rng_t, 8, 3, slope=-1.5, amp=2.0),
        jgrf.gaussian_random_field(rng_j, 8, 3, slope=-1.5, amp=2.0))
    kw = dict(size=8, ndim=2, batch_size=1, n_conditioning_values=0)
    _equal_batches(next(tgrf.GRFDataModule(**kw).train_batches(1)),
                   next(jgrf.GRFDataModule(**kw).train_batches(1)))


# ------------------------------------------------------------ transforms

def test_transforms_are_equal_on_seeded_arrays():
    rng = np.random.default_rng(7)
    field = np.abs(rng.standard_normal((2, 12, 12, 12))).astype(np.float32)
    kw = dict(alphas=[1.0, 0.5], means=[0.1, -0.2], stds=[0.7, 1.3])
    tn, jn = ttransforms.FieldNormalizer(**kw), jtransforms.FieldNormalizer(**kw)
    for i in range(2):
        y = tn.normalize(field[i], i)
        np.testing.assert_array_equal(y, jn.normalize(field[i], i))
        np.testing.assert_array_equal(tn.unnormalize(y, i),
                                      jn.unnormalize(y, i))
        # a tensor goes through torch's log10, to f32 rounding of numpy's
        yt = tn.normalize(torch.from_numpy(field[i]), i)
        assert isinstance(yt, torch.Tensor)
        np.testing.assert_allclose(yt.numpy(), y, rtol=1e-6, atol=1e-6)
    for stack in (tn.normalize_stack(list(field)),):
        for a, b in zip(stack, jn.normalize_stack(list(field))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttransforms.crop_anchors(12, 4, 3),
                                  jtransforms.crop_anchors(12, 4, 3))
    for shift in (False, True):
        got = ttransforms.periodic_crop(field, [10, 3, 7], 5,
                                        np.random.default_rng(1), shift)
        want = jtransforms.periodic_crop(field, [10, 3, 7], 5,
                                         np.random.default_rng(1), shift)
        np.testing.assert_array_equal(got, want)
    got = ttransforms.flip_and_permute([field, field + 1],
                                       np.random.default_rng(2))
    want = jtransforms.flip_and_permute([field, field + 1],
                                        np.random.default_rng(2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- CAMELS

@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A synthetic CAMELS-like registry, built as ``tests/test_data.py``
    builds one: 6 sims of 16^3 for two fields, LH and CV params."""
    root = tmp_path_factory.mktemp("camels")
    rng = np.random.default_rng(0)
    nsims, size = 6, 16
    reg = root / "registries"
    os.makedirs(reg)
    paths = {}
    for field in ["Mstar", "Mcdm"]:
        arr = (np.abs(rng.standard_normal((nsims, size, size, size)) + 2)
               .astype(np.float32) * 1e10)
        p = root / f"{field}.npy"
        np.save(p, arr)
        paths[field] = str(p)
    (reg / "data_source_3d.json").write_text(json.dumps(
        {"CMD": {"Astrid": {"LH": {"z_0.0": paths}, "CV": {"z_0.0": paths}}}}))
    (reg / "normalizations_3d.json").write_text(json.dumps(
        {"Mstar_m": 10.0, "Mstar_s": 0.5, "Mcdm_m": 10.0, "Mcdm_s": 0.5}))
    (reg / "alphas_3d.json").write_text(json.dumps({"Mstar": 1.0, "Mcdm": 1.0}))
    os.makedirs(root / "params_new")
    np.savetxt(root / "params_new" / "params_LH_Astrid.txt",
               rng.uniform(size=(nsims, 6)))
    np.savetxt(root / "params_new" / "params_CV_Astrid.txt",
               rng.uniform(size=(nsims, 6)))
    return str(reg), str(root)


def _camels(mod, registry, return_func, use_native=False, **kw):
    reg_dir, root = registry
    rf = None if return_func is None else getattr(mod, return_func)
    args = dict(channel_names=["Mstar", "Mcdm"] if rf else ["Mcdm"],
                return_func=rf, batch_size=2, cropsize=8, ndim=3,
                data_root=root, num_workers=2)
    args.update(kw)
    dm = mod.get_dataset(reg_dir, **args)
    dm.use_native = use_native
    return dm


@pytest.mark.parametrize("return_func", ["vdm_cc_return_func",
                                         "sfm_return_func", None])
def test_camels_fit_batches_and_resume_are_bit_equal_to_jax(registry,
                                                            return_func):
    t = _camels(tcamels, registry, return_func, stage="fit")
    j = _camels(jcamels, registry, return_func, stage="fit")
    np.testing.assert_array_equal(t.train_indices, j.train_indices)
    np.testing.assert_array_equal(t.val_indices, j.val_indices)
    # 22 train samples of 2: 11 steps an epoch, so 13 steps cross an epoch
    run_t = list(t.train_batches(13))
    for a, b in zip(run_t, j.train_batches(13)):
        _equal_batches(a, b)
    for a, b in zip(t.train_batches(13, start_step=10), run_t[10:]):
        _equal_batches(a, b)
    for a, b in zip(t.val_dataloader(), j.val_dataloader()):
        _equal_batches(a, b)


def test_camels_cv_holdout_and_test_stage_are_bit_equal_to_jax(registry):
    t = _camels(tcamels, registry, "vdm_cc_return_func", stage="test",
                set_name="CV", cropsize=16, batch_size=1)
    j = _camels(jcamels, registry, "vdm_cc_return_func", stage="test",
                set_name="CV", cropsize=16, batch_size=1)
    assert t.nsims == j.nsims == 5  # sim 2 held out of 6
    np.testing.assert_array_equal(t.params, j.params)
    got, want = list(t.test_dataloader()), list(j.test_dataloader())
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        _equal_batches(a, b)
    x = got[0]["x"]
    np.testing.assert_allclose(t.norm_func(t.unnorm_func(x, 1), 1), x,
                               rtol=1e-4, atol=1e-5)


def test_camels_process_blocks_tile_the_global_batch(registry):
    full = next(_camels(tcamels, registry, "vdm_cc_return_func",
                        stage="test", batch_size=4).test_dataloader())
    parts = []
    for p in range(2):
        dm = _camels(tcamels, registry, "vdm_cc_return_func", stage="test",
                     batch_size=4, process_index=p, process_count=2)
        parts.append(next(dm.test_dataloader()))
    for key in ("x", "conditioning"):
        np.testing.assert_array_equal(
            np.concatenate([b[key] for b in parts]), full[key])


def test_build_datamodule_matches_jax(registry, monkeypatch):
    reg_dir, root = registry
    over = {"data.cropsize": 8, "data.batch_size": 2,
            "data.registry_dir": reg_dir, "data.data_root": root,
            "data.dataset_name": "CMD"}
    tdm = tconfig.build_datamodule(
        tpresets.preset("trainVDM3D128_c_c", **over), stage="fit")
    jdm = jconfig.build_datamodule(
        jpresets.preset("trainVDM3D128_c_c", **over), stage="fit")
    assert type(tdm) is tcamels.CAMELSDataModule
    assert (tdm.process_index, tdm.process_count) == (0, 1)
    tdm.use_native = jdm.use_native = False
    _equal_batches(next(tdm.train_batches(1)), next(jdm.train_batches(1)))
    tsfm = tconfig.build_datamodule(
        tpresets.preset("trainSFM3D128_c_c", **over), stage="test")
    assert tsfm.return_func is tcamels.sfm_return_func and tsfm.stage == "test"
    # GRF: the same module fields as the JAX package's
    grf = {"data.kind": "grf", "data.cropsize": 8}
    tg = tconfig.build_datamodule(tpresets.preset("trainSFM3D128_c_c", **grf))
    jg = jconfig.build_datamodule(jpresets.preset("trainSFM3D128_c_c", **grf))
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    # under torch.distributed, a CAMELS module serves this rank's block
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    dm = tconfig.build_datamodule(tpresets.preset("trainVDM3D128_c_c", **over))
    assert (dm.process_index, dm.process_count) == (1, 2)


# ---------------------------------------------------------------- native

def test_native_path_matches_the_python_path(registry):
    if not tnative.available():
        pytest.skip("no C++ compiler: the native fastloader is unavailable")
    so = tnative.library_path()
    assert so.parent == tnative.BUILD_DIR and so.exists()
    assert "build" in so.parts and so.name != "libfastloader.so"
    nat = _camels(tcamels, registry, "vdm_cc_return_func", use_native=True,
                  stage="test", batch_size=2, cropsize=8)
    assert nat._native_kind() == "vdm_cc"
    want = _camels(jcamels, registry, "vdm_cc_return_func", stage="test",
                   batch_size=2, cropsize=8)
    got_b, want_b = list(nat.test_dataloader()), list(want.test_dataloader())
    assert len(got_b) == len(want_b) > 0
    # log10f against numpy's log10 of fields near 1e10: values near 10,
    # whose f32 ulp is 9.5e-7, up to two ulps apart, then divided by the
    # std 0.5
    for a, b in zip(got_b, want_b):
        for k in ("x", "conditioning"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=4e-6)
        np.testing.assert_array_equal(a["conditioning_values"][0],
                                      b["conditioning_values"][0])
    # augmented batches draw their shifts, flips and permutations in one
    # batch-wide pass: deterministic, and a resume replays them
    aug = _camels(tcamels, registry, "sfm_return_func", use_native=True,
                  stage="fit")
    run = list(aug.train_batches(4))
    for a, b in zip(aug.train_batches(4, start_step=2), run[2:]):
        _equal_batches(a, b)


def test_without_a_compiler_the_native_path_is_off(registry, monkeypatch,
                                                   tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert not tnative.available()
    assert not (tmp_path / "native").exists() or not any(
        (tmp_path / "native").glob("*.so"))
    dm = _camels(tcamels, registry, "vdm_cc_return_func", use_native=True,
                 stage="test", batch_size=2)
    assert dm._native_kind() is None
    want = _camels(jcamels, registry, "vdm_cc_return_func", stage="test",
                   batch_size=2)
    for a, b in zip(dm.test_dataloader(), want.test_dataloader()):
        _equal_batches(a, b)


def test_crop_batch_checks_its_inputs():
    if not tnative.available():
        pytest.skip("no C++ compiler: the native fastloader is unavailable")
    idx = np.zeros(1, np.int64)
    anchors = np.zeros((1, 3), np.int64)
    flips = np.zeros((1, 3), np.int32)
    perms = np.arange(3, dtype=np.int32)[None]
    with pytest.raises(ValueError, match="float32"):
        tnative.crop_batch([np.zeros((1, 4, 4, 4))], idx, anchors, flips,
                           perms, 2)
    with pytest.raises(ValueError, match="shape"):
        tnative.crop_batch([np.zeros((1, 4, 4, 5), np.float32)], idx,
                           anchors, flips, perms, 2)
