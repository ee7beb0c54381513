"""The port's 2D models under ``sp`` sharding (a map split along H over the
ranks) against the JAX package and against the port unsharded, on the CPU.

One gloo job of CPU processes per mesh (n_data, n_sp) = (1, 2), (2, 2) and
(1, 4) (``spawn_ranks``; rank function ``model_2d`` in
``_torch_dist_worker.py``), each run once for the module, on a (1, 32, 16)
CUNet with chs (8, 8, 8, 8), norm_groups 4 and the bottleneck attention
(``mid_attn``; its ranks gather the 4 x 2 bottleneck): at sp = 4 a rank holds
8 rows, which halve three times. Parameters are seeded JAX trees carried
over by ``params_from_jax``; every input is a seeded numpy array, the same
global batch of 4 on every mesh. The JAX package's 2D CUNet is its
unsharded one on its CPU path (its own sharded test, ``test_cunet.py``
``TestSharded``, holds its sharded output to that).

  * eps_hat, circular and zeros padding: the gathered slabs against JAX's
    unsharded eps_hat within 1e-4 of max |ref|, and against the port's
    unsharded one within 1e-5 (relative to max(1, max |ref|), as
    ``test_torch_port_sharded.py``);
  * two train steps on each rank's slices of the same global (t, eps):
    metrics within 1e-4 relative, parameters and EMA within 1e-5 absolute
    of the port's unsharded steps, and the ranks' parameters bitwise equal;
  * the SFM's Heun sampler (zeros padding) through
    ``make_sharded_sfm_sampler`` against the unsharded sampler (1e-5), on
    every rank; the sharded VDM sampler of a zero-output model (the sample
    is the noise's alone): the same field on every rank and from one seed
    twice, and no two ``sp`` blocks or data rows alike (the counterpart of
    ``test_sharded_sampling.py::test_vdm_sharded_noise_is_iid_across_shards``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from _torch_port_util import seeded_tree
from vdm4cdm_tpu.diffusion import VDM as JVDM
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule
from vdm4cdm_tpu.flows import SFM as JSFM
from vdm4cdm_tpu.models import CUNet as JCUNet

import vdm4cdm_torch as vt
from vdm4cdm_torch.parallel import NO_SHARD
from vdm4cdm_torch.parallel.launch import spawn_ranks

TIMEOUT = 180.0
B, H, WD = 4, 32, 16
MESHES = [(1, 2), (2, 2), (1, 4)]
N_STEPS, SFM_STEPS, NOISE_STEPS = 2, 3, 3
IDS = [f"{d}x{s}" for d, s in MESHES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run one thread each; so does this process's part."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kw(padding):
    return dict(shape=(1, H, WD), chs=(8, 8, 8, 8), s_conditioning_channels=1,
                v_conditioning_dims=(6,), norm_groups=4, mid_attn=True,
                n_attention_heads=2, dropout_prob=0.0,
                conv_padding_mode=padding)


def _sfm_kw():
    return dict(_kw("zeros"), s_conditioning_channels=0)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@functools.lru_cache(maxsize=None)
def _inputs():
    """The seeded JAX trees (VDM per padding, SFM) with their port
    parameters, and every numpy input, the same for every mesh."""
    vdm = {}
    trees = {}
    for i, padding in enumerate(("circular", "zeros")):
        jv = JVDM(JCUNet(**_kw(padding)),
                  jmake_schedule("learned_linear", -13.3, 13.3))
        trees[padding] = (jv, seeded_tree(jv, 90 + i))
        tv = vt.VDM(vt.CUNet(**_kw(padding), device="cpu"),
                    vt.make_schedule("learned_linear", device="cpu"))
        vdm[padding] = (_kw(padding), {
            k: v.numpy() for k, v in
            vt.params_from_jax(trees[padding][1], tv).items()})
    js = JSFM(JCUNet(**_sfm_kw()))
    ts = vt.SFM(vt.CUNet(**_sfm_kw(), device="cpu"))
    sfm = (_sfm_kw(), {k: v.numpy() for k, v in
                       vt.params_from_jax(seeded_tree(js, 92), ts).items()})
    rng = np.random.default_rng(93)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inputs = dict(
        vdm=vdm, sfm=sfm, z=n(B, H, WD, 1),
        t=np.linspace(0.1, 0.9, B).astype(np.float32),
        batch={"x": n(B, H, WD, 1), "conditioning": n(B, H, WD, 1),
               "conditioning_values": [n(B, 6)]},
        draws=[(rng.uniform(size=B).astype(np.float32), n(B, H, WD, 1))
               for _ in range(N_STEPS)],
        x0=n(B, H, WD, 1), v0=n(B, 6), sfm_steps=SFM_STEPS,
        noise_steps=NOISE_STEPS)
    return trees, inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    runs = {}

    def get(mesh):
        if mesh not in runs:
            runs[mesh] = spawn_ranks(
                W.model_2d, mesh[0] * mesh[1], mesh + (_inputs()[1],),
                timeout=TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp("model_2d")))
        return runs[mesh]

    return get


def _gather(ranks, get, n_data, n_sp):
    return np.concatenate([
        np.concatenate([get(ranks[d * n_sp + s]) for s in range(n_sp)], 1)
        for d in range(n_data)], 0)


def _torch_batch(batch):
    return {"x": torch.from_numpy(batch["x"]),
            "conditioning": torch.from_numpy(batch["conditioning"]),
            "conditioning_values": [torch.from_numpy(v) for v in
                                    batch["conditioning_values"]]}


@functools.lru_cache(maxsize=None)
def _unsharded():
    """The JAX package's eps_hat per padding, and the port's unsharded
    eps_hat, train steps and SFM Heun samples."""
    trees, inputs = _inputs()
    b = _torch_batch(inputs["batch"])
    out = {"jax": {}, "port": {}}
    for padding, (kw, state) in inputs["vdm"].items():
        jv, tree = trees[padding]
        out["jax"][padding] = np.asarray(jax.jit(jv.eps_hat)(
            tree, jnp.asarray(inputs["z"]), jnp.asarray(inputs["t"]),
            jnp.asarray(inputs["batch"]["conditioning"]),
            [jnp.asarray(inputs["batch"]["conditioning_values"][0])]))
        with torch.no_grad():
            out["port"][padding] = W._build_2d(
                "vdm", state, kw, NO_SHARD).eps_hat(
                    torch.from_numpy(inputs["z"]),
                    torch.from_numpy(inputs["t"]), b["conditioning"],
                    b["conditioning_values"]).numpy()
    kw, state = inputs["vdm"]["circular"]
    vdm = W._build_2d("vdm", state, kw, NO_SHARD)
    W.inject(vdm, inputs["draws"])
    out["train"] = W.run_steps(vdm, b, N_STEPS)
    kw, state = inputs["sfm"]
    out["sfm"] = W._build_2d("sfm", state, kw, NO_SHARD).draw_samples(
        torch.from_numpy(inputs["x0"]), SFM_STEPS,
        [torch.from_numpy(inputs["v0"])], method="heun").numpy()
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_sharded_2d_eps_hat_matches_jax_and_the_unsharded_port(job, mesh):
    ranks = job(mesh)
    want = _unsharded()
    for padding in ("circular", "zeros"):
        got = _gather(ranks, lambda r: r["eps_hat"][padding], *mesh)
        ref = want["jax"][padding]
        assert np.abs(ref).max() > 0.1, padding
        err = float(np.abs(got - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (padding, err)
        _close(got, want["port"][padding], 1e-5, f"port {padding}")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_sharded_2d_train_steps_match_unsharded(job, mesh):
    ranks = job(mesh)
    want = _unsharded()["train"]
    got = ranks[0]["train"]
    for step in range(N_STEPS):
        for k, v in want["metrics"][step].items():
            _close(got["metrics"][step][k], v, 1e-4, k)
        for what in ("params", "ema"):
            for k, v in want[what][step].items():
                np.testing.assert_allclose(got[what][step][k], v, rtol=0,
                                           atol=1e-5, err_msg=f"{what} {k}")
    for r in ranks[1:]:
        for k, v in got["params"][-1].items():
            np.testing.assert_array_equal(r["train"]["params"][-1][k], v,
                                          err_msg=k)
    start = _inputs()[1]["vdm"]["circular"][1]
    assert max(np.abs(v - start[k]).max()
               for k, v in got["params"][-1].items()) > 1e-5


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_sharded_2d_samplers(job, mesh):
    ranks = job(mesh)
    want = _unsharded()["sfm"]
    for r in ranks:  # every rank gathers the whole field
        _close(r["sfm"], want, 1e-5, "sfm heun")
    assert np.abs(want - _inputs()[1]["x0"]).max() > 1e-2
    n_data, n_sp = mesh
    first = ranks[0]["noise"][0]
    assert first.shape == (n_data, H, WD, 1) and np.isfinite(first).all()
    for r in ranks:
        for field in r["noise"]:
            np.testing.assert_array_equal(field, first)
    blocks = first.reshape(n_data, n_sp, H // n_sp, WD)
    for i in range(1, n_sp):
        assert np.abs(blocks[:, 0] - blocks[:, i]).max() > 1e-3, \
            "sp shards drew the same noise"
    if n_data > 1:
        assert np.abs(first[0] - first[1]).max() > 1e-3, \
            "data ranks drew the same noise"
