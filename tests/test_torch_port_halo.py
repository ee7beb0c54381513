"""The port's halo exchange (``vdm4cdm_torch/parallel/halo.py``) against the
JAX package's under ``shard_map``, at sp = 2 and 4, circular and zeros.

The port side is a gloo job of sp CPU processes (``spawn_ranks``, a
FileStore in ``tmp_path``, a time limit on the whole job); the JAX side runs
``halo_exchange``, ``_shift`` (its ``ppermute``) and ``all_gather_spatial``
on the virtual CPU devices of ``tests/conftest.py``. Both take the same
seeded numpy field, (2, 8, 4, 4, 3) f32. The forwards move data and must be
equal; the backwards add at most two f32 terms per voxel, in the same order
on both sides, so they are held to 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as W
from vdm4cdm_tpu.parallel.halo import ShardCtx as JShardCtx
from vdm4cdm_tpu.parallel.halo import _shift as jshift
from vdm4cdm_tpu.parallel.halo import all_gather_spatial as jall_gather
from vdm4cdm_tpu.parallel.halo import halo_exchange as jhalo
from vdm4cdm_tpu.utils.mesh import make_mesh as jmake_mesh

from vdm4cdm_torch.parallel import NO_SHARD, ShardCtx, halo_exchange
from vdm4cdm_torch.parallel.launch import spawn_ranks

SHAPE = (2, 8, 4, 4, 3)
TIMEOUT = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers and this module's ranks use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(sp):
    rng = np.random.default_rng(40 + sp)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    n = SHAPE[1] // sp
    ct = rng.standard_normal(
        (SHAPE[0], sp * (n + 2)) + SHAPE[2:]).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    return x, ct, g


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``port(sp)``: every rank's results of ``_torch_dist_worker.halo``,
    concatenated along the split dim where they are slabs; one job per sp,
    kept for the module."""
    runs = {}

    def get(sp):
        if sp not in runs:
            ranks = spawn_ranks(W.halo, sp, _inputs(sp),
                                store_dir=str(tmp_path_factory.mktemp(
                                    "halo")), timeout=TIMEOUT)
            out = {k: np.concatenate([r[k] for r in ranks], 1)
                   for k in ranks[0] if k not in ("gather", "stats")}
            out["gather"] = [r["gather"] for r in ranks]
            out["stats"] = [r["stats"] for r in ranks]
            runs[sp] = out
        return runs[sp]

    return get


def _sharded(fn, sp, out_spec=P(None, "sp")):
    mesh = jmake_mesh(n_data=1, n_sp=sp)
    return jax.shard_map(fn, mesh=mesh, in_specs=P(None, "sp"),
                         out_specs=out_spec, check_vma=False)


JCTX = JShardCtx(axis="sp", spatial_dim=0)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_forward_matches_jax(port, sp, periodic):
    x, _, _ = _inputs(sp)
    want = _sharded(lambda xs: jhalo(xs, JCTX, 1, 1, periodic), sp)(x)
    np.testing.assert_array_equal(port(sp)[f"halo_{periodic}"],
                                  np.asarray(want))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_backward_matches_jax(port, sp, periodic):
    x, ct, _ = _inputs(sp)
    f = _sharded(lambda xs: jhalo(xs, JCTX, 1, 1, periodic), sp)
    want = jax.grad(lambda v: jnp.sum(f(v) * ct))(jnp.asarray(x))
    np.testing.assert_allclose(port(sp)[f"dx_{periodic}"],
                               np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_matches_jax(port, sp, periodic, shift):
    x, _, _ = _inputs(sp)
    want = _sharded(lambda xs: jshift(xs, "sp", shift, periodic), sp)(x)
    np.testing.assert_array_equal(port(sp)[f"pp_{shift}_{periodic}"],
                                  np.asarray(want))


@pytest.mark.parametrize("sp", [2, 4])
def test_all_gather_and_its_transpose_match_jax(port, sp):
    x, _, g = _inputs(sp)
    res = port(sp)
    for full in res["gather"]:
        np.testing.assert_array_equal(full, x)
    np.testing.assert_array_equal(res["take"], x)
    f = _sharded(lambda xs: jall_gather(xs, JCTX), sp, out_spec=P())
    want = jax.grad(lambda v: jnp.sum(f(v) * g))(jnp.asarray(x))
    # every shard's loss reads the whole gathered field: its slab's
    # gradient is the sum over shards, sp * g here
    np.testing.assert_allclose(res["gather_dx"], np.asarray(want) * sp,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_comm_stats_count_the_collectives(port, sp):
    for stats in port(sp)["stats"]:
        # two modes x (2 halo + 2 backward + 2 ppermute), gather and its
        # backward; gloo on CPU tensors stages nothing through the host
        assert stats["ppermute_calls"] == 12
        assert stats["all_reduce_calls"] == 2
        assert stats["host_bytes"] == 0
        assert stats["ppermute_s"] > 0.0


@pytest.mark.parametrize("periodic", [True, False])
def test_unsharded_halo_is_the_local_pad(periodic):
    x, _, _ = _inputs(2)
    got = halo_exchange(torch.from_numpy(x), NO_SHARD, 1, 2, periodic)
    want = np.pad(x, ((0, 0), (1, 2), (0, 0), (0, 0), (0, 0)),
                  mode="wrap" if periodic else "constant")
    np.testing.assert_array_equal(got.numpy(), want)


def test_shard_ctx_checks_its_fields():
    with pytest.raises(NotImplementedError, match="first spatial dim"):
        ShardCtx(spatial_dim=1)
    with pytest.raises(ValueError, match="go together"):
        ShardCtx(ranks=(0, 1))
    assert not NO_SHARD.sharded
    assert (NO_SHARD.size, NO_SHARD.index, NO_SHARD.world_size) == (1, 0, 1)


def test_a_failing_rank_fails_the_job(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn_ranks(W.fail_on_rank_one, 2, store_dir=str(tmp_path),
                    timeout=TIMEOUT)


def test_a_rank_past_the_time_limit_fails_the_job(tmp_path):
    with pytest.raises(TimeoutError, match=r"ranks \[0\] did not finish"):
        spawn_ranks(W.sleep, 1, (60.0,), store_dir=str(tmp_path),
                    timeout=3.0)
