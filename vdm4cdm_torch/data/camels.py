"""CAMELS grid/map data module — registry-driven, thread-prefetched.

Behavior parity with the reference's AstroDataset/AstroDataModule/get_dataset
(reference src/dataset/CAMELS_3D_dataset.py and CAMELS_2D_dataset.py):

  * fields loaded as whole .npy stacks (RAM or mmap), channel dim added;
  * CV set holds out sims {2, 8, 17} (3D; x15 slice blocks in 2D)
    (CAMELS_3D_dataset.py:112-117, CAMELS_2D_dataset.py:107-112);
  * cosmological params from params_{set}_{suite}.txt, repeated x15 for 2D
    slices (CAMELS_2D_dataset.py:119);
  * crop grid: idx -> (sim, crop) via divmod(idx, ncrops); periodic-wrap crops
    with random anchor shift when training (augmentation.py:108-127);
  * do_crop = cropsize != fullsize (get_dataset, CAMELS_3D_dataset.py:228);
  * train/val split 95/5 (3D) or 90/10 (2D) by shuffled index
    (CAMELS_3D_dataset.py:135-138, CAMELS_2D_dataset.py:130-132);
  * log+normalize transform with exact inverse (norm_func/unnorm_func);
  * train-time flip + axis-permutation augmentation;
  * batches are dicts built by a ``return_func(fields, params)``.

Counterpart of ``vdm4cdm_tpu/data/camels.py`` (this package's own copy: the
same registry, seeds and settings give bit-equal batches). Batches come out
channels-LAST numpy, pipelined by a producer thread (no process-based
dataloader workers needed: the transform path is numpy slicing); determinism
via an explicit epoch seed so training is resumable at a step boundary.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .registry import DataRegistry
from .transforms import FieldNormalizer, crop_anchors, flip_and_permute, periodic_crop

CV_HOLDOUT = (2, 8, 17)


def default_return_func(fields, params):
    """Unconditional: all channels stacked into x (reference
    CAMELS_3D_dataset.py:218-220)."""
    return {"x": np.concatenate(fields, axis=0), "conditioning": None,
            "conditioning_values": params}


def vdm_cc_return_func(fields, params):
    """Conditional field->field: fields[0] conditions fields[1] (reference
    trainVDM3D_c_c_from_field_name_thick_lowbatch.py:75-76)."""
    return {"conditioning": fields[0], "x": fields[1], "conditioning_values": [params]}


def sfm_return_func(fields, params):
    """Flow matching: transport fields[0] -> fields[1] (reference
    trainSFM3D_c_c_from_field_name_thick_lowbatch.py:71-72)."""
    return {"x0": fields[0], "x1": fields[1], "conditioning_values": [params]}


@dataclasses.dataclass
class CAMELSDataModule:
    registry: DataRegistry
    channel_names: Sequence[str]
    dataset_name: str = "CMD"
    suite_name: str = "Astrid"
    set_name: str = "LH"
    z_name: str = "z_0.0"
    stage: str = "fit"  # "fit" | "test"
    batch_size: int = 1
    cropsize: int = 256
    ndim: int = 3
    return_func: Optional[Callable] = None
    mmap: bool = True
    seed: int = 42
    num_workers: int = 8
    slices_per_sim_2d: int = 15
    # Use the C++ fastloader (native/fastloader.cpp) when available and the
    # return_func is one of the standard batch shapes: one fused gather pass
    # per batch instead of ~5 numpy intermediates per sample. The Python path
    # is the oracle (tests/test_torch_port_data.py holds the two together).
    use_native: bool = True
    # Multi-process data parallelism: this process serves block
    # process_index of process_count of each global batch (global
    # batch_size must divide evenly). One process by default.
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        assert self.stage in ("fit", "test"), f"stage {self.stage} not recognized"
        if self.return_func is None:
            self.return_func = default_return_func

        self.normalizer = FieldNormalizer(
            alphas=[self.registry.alpha(c) for c in self.channel_names],
            means=[self.registry.normalization(c)[0] for c in self.channel_names],
            stds=[self.registry.normalization(c)[1] for c in self.channel_names],
        )

        self.fields = []
        for name in self.channel_names:
            arr = self.registry.load_field(
                self.dataset_name, self.suite_name, self.set_name, self.z_name,
                name, mmap=self.mmap,
            )
            arr = arr[:, None] if arr.ndim == self.ndim + 1 else arr
            arr = arr[self._holdout_mask(len(arr))]
            self.fields.append(arr)
        self.fullsize = self.fields[0].shape[-1]
        self.nsims = len(self.fields[0])
        for f in self.fields:
            assert len(f) == self.nsims
            assert all(s == self.fullsize for s in f.shape[2:])

        params = self.registry.load_params(self.set_name, self.suite_name)
        if self.ndim == 2:
            params = np.repeat(params, self.slices_per_sim_2d, axis=0)
        self.params = params[self._holdout_mask(len(params))].astype(np.float32)
        assert len(self.params) == self.nsims, (
            f"params rows {len(self.params)} != sims {self.nsims}"
        )

        self.do_crop = self.cropsize != self.fullsize
        if self.do_crop:
            self.anchors = crop_anchors(self.fullsize, self.cropsize, self.ndim)
            self.ncrops = len(self.anchors)
        else:
            self.anchors = np.zeros((1, self.ndim), np.int64)
            self.ncrops = 1
        self.nsamples = self.nsims * self.ncrops

        if self.stage == "fit":
            frac = 0.95 if self.ndim == 3 else 0.9
            n_train = int(self.nsamples * frac)
            rng = np.random.default_rng(self.seed)
            order = rng.permutation(self.nsamples)
            self.train_indices = order[:n_train]
            self.val_indices = order[n_train:]
        else:
            self.test_indices = np.arange(self.nsamples)

    def _holdout_mask(self, n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        if self.set_name == "CV":
            block = self.slices_per_sim_2d if self.ndim == 2 else 1
            for h in CV_HOLDOUT:
                mask[h * block : (h + 1) * block] = False
        return mask

    # ------------------------------------------------------------- samples
    def norm_func(self, field, i_channel: int):
        return self.normalizer.normalize(field, i_channel)

    def unnorm_func(self, field, i_channel: int):
        return self.normalizer.unnormalize(field, i_channel)

    def _get_sample(self, idx: int, rng: Optional[np.random.Generator], augment: bool):
        isim, icrop = divmod(int(idx), self.ncrops)
        fields = []
        for f in self.fields:
            sample = f[isim]
            if self.do_crop:
                sample = periodic_crop(
                    np.asarray(sample), self.anchors[icrop], self.cropsize,
                    rng=rng, aug_shift=augment,
                )
            fields.append(np.asarray(sample, dtype=np.float32))
        fields = [self.norm_func(f, i) for i, f in enumerate(fields)]
        if augment:
            fields = flip_and_permute(fields, rng)
        return self.return_func(fields=fields, params=self.params[isim])

    def _collate(self, samples: list[dict]) -> dict:
        """Stack sample dicts; channels-first (C,*sp) fields become
        channels-last (B,*sp,C) device layout; non-field tensors (e.g. raw
        param vectors) are stacked as-is."""
        out = {}
        perm = (0,) + tuple(range(2, 2 + self.ndim)) + (1,)
        s0 = samples[0]
        for key in s0:
            if s0[key] is None:
                out[key] = None
            elif isinstance(s0[key], list):
                out[key] = [
                    np.stack([s[key][i] for s in samples]) for i in range(len(s0[key]))
                ]
            else:
                stacked = np.stack([s[key] for s in samples])
                if stacked.ndim == 2 + self.ndim:  # (B, C, *spatial) field
                    stacked = stacked.transpose(perm)
                out[key] = stacked
        return out

    # ------------------------------------------------------- native fast path
    def _native_kind(self) -> Optional[str]:
        if not self.use_native:
            return None
        from . import native

        if not native.available():
            return None
        if self.return_func is vdm_cc_return_func and len(self.fields) == 2:
            return "vdm_cc"
        if self.return_func is sfm_return_func and len(self.fields) == 2:
            return "sfm"
        if self.return_func is default_return_func:
            return "default"
        return None

    def _native_batch(self, batch_idx: np.ndarray, rng: Optional[np.random.Generator],
                      augment: bool, kind: str) -> dict:
        from . import native

        b = len(batch_idx)
        nd = self.ndim
        isims, icrops = np.divmod(np.asarray(batch_idx, np.int64), self.ncrops)
        anchors = self.anchors[icrops].astype(np.int64)
        if augment:
            anchors = anchors + rng.integers(0, self.cropsize, size=(b, nd))
            flips = rng.integers(0, 2, size=(b, nd)).astype(np.int32)
            perms = np.stack([rng.permutation(nd) for _ in range(b)]).astype(np.int32)
        else:
            flips = np.zeros((b, nd), np.int32)
            perms = np.tile(np.arange(nd, dtype=np.int32), (b, 1))
        out = native.crop_batch(
            self.fields, isims, anchors, flips, perms, self.cropsize,
            alphas=self.normalizer.alphas, means=self.normalizer.means,
            stds=self.normalizer.stds, channels_last=True,
        )
        params = self.params[isims]
        if kind == "vdm_cc":
            return {"conditioning": out[..., 0:1], "x": out[..., 1:2],
                    "conditioning_values": [params]}
        if kind == "sfm":
            return {"x0": out[..., 0:1], "x1": out[..., 1:2],
                    "conditioning_values": [params]}
        return {"x": out, "conditioning": None, "conditioning_values": params}

    # ------------------------------------------------------------- loaders
    def _iterate(self, indices, shuffle: bool, augment: bool, epoch_seed: int,
                 drop_last: bool) -> Iterator[dict]:
        rng = np.random.default_rng(epoch_seed)
        idxs = rng.permutation(indices) if shuffle else np.asarray(indices)
        bs = self.batch_size
        n_full = len(idxs) // bs
        tail = len(idxs) - n_full * bs
        work = queue.Queue(maxsize=4 * max(1, self.num_workers))

        native_kind = self._native_kind()
        if self.process_count > 1:
            assert bs % self.process_count == 0, (
                f"batch_size {bs} must divide over {self.process_count} "
                f"processes"
            )

        def make_batch(batch_idx, start):
            # multi-process: identical shuffles everywhere (same epoch_seed),
            # each process materializes only its BLOCK of the global batch,
            # in rank order
            if self.process_count > 1:
                loc = len(batch_idx) // self.process_count
                batch_idx = batch_idx[self.process_index * loc:
                                      (self.process_index + 1) * loc]
            sample_rng = np.random.default_rng((epoch_seed, int(start)))
            if native_kind is not None:
                return self._native_batch(batch_idx, sample_rng, augment, native_kind)
            samples = [self._get_sample(i, sample_rng, augment) for i in batch_idx]
            return self._collate(samples)

        def producer():
            try:
                for start in range(0, n_full * bs, bs):
                    work.put(make_batch(idxs[start : start + bs], start))
                if tail and not drop_last:
                    work.put(make_batch(idxs[n_full * bs :], n_full * bs))
                work.put(None)
            except BaseException as e:  # surface loader errors to the consumer
                work.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = work.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def train_dataloader(self, epoch: int = 0) -> Iterator[dict]:
        assert self.stage == "fit"
        return self._iterate(self.train_indices, shuffle=True, augment=True,
                             epoch_seed=self.seed + 1000 * epoch + 1, drop_last=True)

    def val_dataloader(self) -> Iterator[dict]:
        assert self.stage == "fit"
        return self._iterate(self.val_indices, shuffle=False, augment=False,
                             epoch_seed=self.seed, drop_last=False)

    def test_dataloader(self) -> Iterator[dict]:
        assert self.stage == "test"
        return self._iterate(self.test_indices, shuffle=False, augment=False,
                             epoch_seed=self.seed, drop_last=False)

    def train_batches(self, n_steps: int, start_step: int = 0) -> Iterator[dict]:
        """Step-based infinite stream (epoch boundaries handled internally) —
        deterministic resume: step k always sees the same batch."""
        steps_per_epoch = max(1, len(self.train_indices) // self.batch_size)
        step = start_step
        while step < n_steps:
            epoch = step // steps_per_epoch
            skip = step % steps_per_epoch
            it = self.train_dataloader(epoch=epoch)
            for j, batch in enumerate(it):
                if j < skip:
                    continue
                yield batch
                step += 1
                if step >= n_steps:
                    return


def get_dataset(
    registry_dir: str,
    dataset_name: str = "CMD",
    suite_name: str = "Astrid",
    set_name: str = "LH",
    z_name: str = "z_0.0",
    channel_names: Sequence[str] = ("Mcdm",),
    return_func: Optional[Callable] = None,
    stage: str = "fit",
    batch_size: int = 1,
    cropsize: int = 256,
    ndim: int = 3,
    num_workers: int = 8,
    mmap: bool = True,
    data_root: Optional[str] = None,
    seed: int = 42,
    process_index: int = 0,
    process_count: int = 1,
) -> CAMELSDataModule:
    """Factory mirroring the reference's get_dataset (CAMELS_3D_dataset.py:202-234).

    process_index/process_count: multi-process data parallelism — each
    process materializes only its block of every global batch (shuffles are
    shared through the epoch seed)."""
    registry = DataRegistry(
        registry_dir, suffix="_3d" if ndim == 3 else "", data_root=data_root
    )
    return CAMELSDataModule(
        registry=registry,
        channel_names=channel_names,
        dataset_name=dataset_name,
        suite_name=suite_name,
        set_name=set_name,
        z_name=z_name,
        stage=stage,
        batch_size=batch_size,
        cropsize=cropsize,
        ndim=ndim,
        return_func=return_func,
        mmap=mmap,
        num_workers=num_workers,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )
