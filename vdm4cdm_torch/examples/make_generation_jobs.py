"""Author sharded generation campaigns, the scripted equivalent of the
reference's model_test.ipynb / ICML_figures.ipynb job-authoring cells (which
write bash scripts splitting campaigns over 6 processes):

    python -m vdm4cdm_torch.examples.make_generation_jobs \
        VDM_Mstar_Mcdm_c_c_128 --ckpt-dir runs/.../checkpoints --out jobs/ \
        --n-shards 6

Each shard script runs ``python -m vdm4cdm_torch.cli.generate`` with a
distinct seed; concatenate the outputs or point ``cli.calc_ss`` at the
merged campaign directory.
"""

from __future__ import annotations

import argparse
import os
import shlex
import stat
import sys


def job_line(model_name: str, save: str, runtype: str, ckpt_dir: str,
             seed: int) -> str:
    """One shard's command line."""
    args = ["python", "-m", "vdm4cdm_torch.cli.generate", model_name, save,
            runtype, "--ckpt-dir", ckpt_dir, "--seed", str(seed)]
    return " ".join(shlex.quote(a) for a in args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_name")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default="jobs")
    ap.add_argument("--save-root", default="data/campaigns")
    ap.add_argument("--n-shards", type=int, default=6)
    ap.add_argument("--runtypes", nargs="*",
                    default=["CV_12_12", "CV_1_128", "1P_24"])
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for rt in args.runtypes:
        for shard in range(args.n_shards):
            path = os.path.join(args.out,
                                f"{args.model_name}_{rt}_{shard}.sh")
            save = os.path.join(args.save_root, args.model_name, rt,
                                f"shard{shard}")
            with open(path, "w") as f:
                f.write("#!/bin/bash\nset -e\n"
                        + job_line(args.model_name, save, rt, args.ckpt_dir,
                                   shard) + "\n")
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
            print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
