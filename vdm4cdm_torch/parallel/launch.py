"""Run a function on the ranks of a local ``torch.distributed`` job.

One fresh process per rank (the ``spawn`` start method), joined through a
``FileStore`` in a directory the caller names; nothing on the machine tells a
program of a cluster. Each rank runs ``fn(rank, world_size, *args)`` and
sends its return value (or its traceback) back through a queue. A rank that
raises, dies or outlasts the time limit fails the whole job: the other ranks
are stopped and the call raises. Used by the tests (gloo across CPU
processes) and by ``chip_smoke.py`` (two ranks sharing one card over gloo,
which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid


def _rank_main(fn, rank, world_size, store_path, timeout_s, results, args):
    import torch.distributed as dist

    try:
        # gloo picks its interface from the host name unless told; the ranks
        # of a local job meet on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn_ranks(fn, world_size: int, args=(), *, store_dir: str,
                timeout: float = 600.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` new processes joined
    over gloo; the return values in rank order. ``fn`` and ``args`` must
    pickle (``fn`` a module-level function). The ranks pick no device of
    their own, so NCCL, one card per rank, needs a launcher that does."""
    import torch.multiprocessing as mp

    mpc = mp.get_context("spawn")
    results = mpc.Queue()
    store_path = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    procs = [mpc.Process(target=_rank_main,
                         args=(fn, r, world_size, store_path, timeout,
                               results, tuple(args)), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"ranks {late} did not finish within "
                                   f"{timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world_size)]
