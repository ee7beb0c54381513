"""Summary-statistics evaluator CLI: counterpart of
``vdm4cdm_tpu/cli/calc_ss.py`` (reference calc_SS.py).

    python -m vdm4cdm_torch.cli.calc_ss MODEL_NAME --data-dir DIR

For each generation campaign found under DIR ({CV_1_128, CV_12_12, 1P_24,
1P_128}), computes per sample (reference calc_SS.py:77-99):

    3D: mean, std, P(k), log-PDF (100 bins in log10(x+1))
    2D half/quarter-depth projections: mean, std, P(k), log-PDF, and, where
    the projection is 128 wide, the order-2 reduced wavelet scattering
    transform (N=128, NR=4, NT=4)

plus the same statistics of the ground-truth boxes and, for CV_1_128, the
posterior mean and std over the reps. Writes ``summary.pkl`` with the JAX
CLI's keys and numpy values. The statistics run on the device (the CUDA
card unless ``--device`` names another), one sample at a time; the model is
resolved by name as a preset, and ``--set`` must match the campaign's.
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..evals import lwt, pdfs, spectra
from ..utils.array import to_np
from ._common import add_device_arg, apply_overrides, parse_overrides

ONE_P_INDICES = [0, 4, 7, 23, 28]
ONE_P_NAMES = ["fid", "Om_m2", "Om_p2", "ASN1_m3", "ASN1_p3"]
RWST_SIZE = 128


@functools.lru_cache(maxsize=4)
def _wavelets(device: str):
    return lwt.make_wavelets(N=RWST_SIZE, NR=4, NT=4, sqrt=True,
                             device=device)


def _log_rwst(fields2d: torch.Tensor) -> np.ndarray:
    mms, vals = _wavelets(str(fields2d.device))
    wst = to_np(lwt.WST_abs2(fields2d[:, 0], mms, vals, m=2))
    rwst = lwt.get_rwst(wst, NR=4, NT=4)[:, 2:]
    return np.log(rwst + 1)


def _pk(fields: torch.Tensor) -> np.ndarray:
    axes = tuple(range(2, fields.ndim))
    return to_np(spectra.pk(fields / fields.sum(dim=axes, keepdim=True))[1])


def get_stats(fields: torch.Tensor) -> dict:
    """Statistics of unnormalized fields (B, 1, R, R, R) on their device:
    the 3D ones and those of the half- and quarter-depth projections
    (reference calc_SS.py:77-99). Values are numpy arrays and floats."""
    f = fields.float()
    half, quarter = f.shape[2] // 2, f.shape[2] // 4
    stats = {
        "3d_mean": float(f.mean()),
        "3d_std": float(f.std(correction=0)),
        "3d_pk": _pk(f),
        "3d_logpdf": to_np(pdfs.log_pdf(f, pdfs.BINS_3D)),
    }
    for name, depth in [("half", half), ("quarter", quarter)]:
        f2d = f[:, :, :depth].sum(dim=2)
        stats[f"2d_{name}_mean"] = float(f2d.mean())
        stats[f"2d_{name}_std"] = float(f2d.std(correction=0))
        stats[f"2d_{name}_pk"] = _pk(f2d)
        stats[f"2d_{name}_logpdf"] = to_np(pdfs.log_pdf(f2d, pdfs.BINS_2D))
        if f2d.shape[-1] == RWST_SIZE:
            stats[f"2d_{name}_rwst"] = _log_rwst(f2d)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compute summary statistics of generation campaigns")
    ap.add_argument("model_name", type=str)
    ap.add_argument("--data-dir", type=str, required=True,
                    help="directory holding campaign subdirs (gen_*.npy stacks)")
    ap.add_argument("--set", dest="overrides", nargs="*", metavar="SEC.KEY=VAL",
                    help="config overrides — must match the campaign's")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..config import build_datamodule
    from ..presets import preset as get_preset

    cfg = get_preset(args.model_name)
    apply_overrides(cfg, parse_overrides(args.overrides))
    device = resolve_device(args.device)
    resol = cfg.data.cropsize
    half, quarter = resol // 2, resol // 4

    def unnorm_nchw(dm, arr, i_channel):
        """A host (B, C, *spatial) array, on the device, unnormalized."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return dm.unnorm_func(t.to(device), i_channel)

    def project(u, depth):
        return to_np(u[:, :, :depth].sum(dim=2))

    summary = {}
    for key in ["CV_1_128", "CV_12_12", "1P_24", "1P_128"]:
        fol = os.path.join(args.data_dir, key)
        if not os.path.exists(fol):
            continue
        print(f"[calc_ss] processing {fol}", flush=True)
        cfg.data.set_name = key.split("_")[0]
        cfg.data.batch_size = 1
        dm = build_datamodule(cfg, stage="test")
        ss, images = {}, {}

        def sample_pass(data, prefix):
            for j in range(len(data)):
                xu = unnorm_nchw(dm, data[[j]], 1)
                ss[f"Mcdm_{prefix}_{j}"] = get_stats(xu)
                images[f"half_Mcdm_{prefix}_{j}"] = project(xu, half)
                images[f"quarter_Mcdm_{prefix}_{j}"] = project(xu, quarter)

        def gt_pass(wanted, name_fn):
            """Statistics of the test loader's batches whose index is in
            ``wanted``; the loader is not read past the last of them."""
            count = 0
            for i_batch, batch in enumerate(dm.test_dataloader()):
                if i_batch > max(wanted):
                    break
                if i_batch not in wanted:
                    continue
                # channels-last (1, *sp, C) -> channels-first (1, C, *sp)
                x = np.moveaxis(np.asarray(batch["x"]), -1, 1)
                c = np.moveaxis(np.asarray(batch["conditioning"]), -1, 1)
                xu = unnorm_nchw(dm, x, 1)
                cu = unnorm_nchw(dm, c, 0)
                name = name_fn(count, i_batch)
                ss[f"Mcdm_GT_{name}"] = get_stats(xu)
                images[f"half_Mcdm_GT_{name}"] = project(xu, half)
                images[f"quarter_Mcdm_GT_{name}"] = project(xu, quarter)
                images[f"half_cond_GT_{name}"] = project(cu, half)
                images[f"quarter_cond_GT_{name}"] = project(cu, quarter)
                count += 1
            return count

        if key == "CV_1_128":
            gt_pass({2}, lambda c, i: str(c))
            data = np.load(os.path.join(fol, "gen_0.npy"))
            sample_pass(data, "0")
            all_u = unnorm_nchw(dm, data, 1)
            summary[key] = {
                "stats": ss, "images": images,
                "post_means": to_np(all_u.mean(0, keepdim=True)),
                "post_stds": to_np(all_u.std(0, correction=0, keepdim=True)),
            }
        elif key == "CV_12_12":
            gt_pass(set(range(12)), lambda c, i: str(c))
            for i in range(12):
                sample_pass(np.load(os.path.join(fol, f"gen_{i}.npy")), str(i))
            summary[key] = {"stats": ss, "images": images}
        else:  # 1P campaigns
            rep = 24 if key == "1P_24" else 128
            gt_pass(set(ONE_P_INDICES),
                    lambda c, i: ONE_P_NAMES[ONE_P_INDICES.index(i)])
            for name in ONE_P_NAMES:
                path = os.path.join(fol, f"{name}_{rep}.npy")
                if not os.path.exists(path):
                    path = os.path.join(fol, f"{name}.npy")
                sample_pass(np.load(path), name)
            summary[key] = {"stats": ss, "images": images}

    out = os.path.join(args.data_dir, "summary.pkl")
    with open(out, "wb") as f:
        pickle.dump(summary, f)
    print(f"[calc_ss] wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
