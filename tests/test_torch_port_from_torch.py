"""The port's reference-checkpoint converter (``interop/from_torch.py`` and
``python -m vdm4cdm_torch.cli.convert_ckpt``) on the CPU, against the torch
twin of the CUNet (``tools/torch_cunet.py``, the stand-in for mltools' CUNet
that ``tests/test_torch_parity.py`` converts with the JAX package) and against
the JAX package's converter.

Tolerance: the converted port's eps_hat within 1e-4 relative + 1e-4
absolute of the twin's forward, the bar of ``test_torch_parity.py`` (two
implementations of one f32 function, summed in other orders; the twin's
timestep embedding is ``torch.linspace``, the port's ``jnp.linspace``'s
formula). The state_dicts of the two converters agree exactly (the same
transposes and reshapes of the same numbers).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from torch_cunet import TorchCUNet  # noqa: E402
from vdm4cdm_tpu.diffusion import VDM as JVDM  # noqa: E402
from vdm4cdm_tpu.diffusion import make_schedule as jmake_schedule  # noqa: E402
from vdm4cdm_tpu.interop import torch_convert as jconvert  # noqa: E402
from vdm4cdm_tpu.models import CUNet as JCUNet  # noqa: E402

import vdm4cdm_torch as vt  # noqa: E402
from vdm4cdm_torch.cli import convert_ckpt, generate  # noqa: E402
from vdm4cdm_torch.interop import from_torch  # noqa: E402
from vdm4cdm_torch.train.checkpoint import load_params  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kw(nd, mid_attn, padding="circular", size=8, chs=(8, 8, 8, 8)):
    return dict(shape=(1,) + (size,) * nd, chs=chs,
                s_conditioning_channels=1, v_conditioning_dims=(6,),
                norm_groups=4, mid_attn=mid_attn, dropout_prob=0.0,
                conv_padding_mode=padding)


def _twin(nd, mid_attn, seed=0, perturb=False, **kw):
    """The twin at its own init (as ``test_torch_parity.py`` builds it), or
    with every parameter moved by 0.1 N(0, 1) so that the norms' affine
    carries signal too (``perturb``)."""
    torch.manual_seed(seed)
    tnet = TorchCUNet(**_kw(nd, mid_attn, **kw))
    if perturb:
        with torch.no_grad():
            for p in tnet.parameters():
                p.add_(0.1 * torch.randn(p.shape))
    return tnet.eval()


def _port(nd, mid_attn, **kw):
    return vt.VDM(vt.CUNet(**_kw(nd, mid_attn, **kw), device="cpu"),
                  vt.make_schedule("learned_linear", device="cpu"))


@pytest.mark.parametrize("nd,mid_attn", [(2, False), (2, True), (3, False),
                                         (3, True)])
def test_converted_forward_matches_the_torch_twin(nd, mid_attn):
    tnet = _twin(nd, mid_attn)
    tv = _port(nd, mid_attn)
    sd, report = vt.params_from_torch(tnet.state_dict(), tv)
    assert not report["missing"] and not report["unused"]
    assert not report["gamma_found"]
    tv.load_state_dict(sd)
    rng = np.random.default_rng(nd)
    sp = (8,) * nd
    z = rng.standard_normal((2, *sp, 1)).astype(np.float32)
    s = rng.standard_normal((2, *sp, 1)).astype(np.float32)
    v = rng.standard_normal((2, 6)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    first = (0, nd + 1) + tuple(range(1, nd + 1))
    last = (0,) + tuple(range(2, nd + 2)) + (1,)
    with torch.no_grad():
        got = tv.eps_hat(torch.from_numpy(z), torch.from_numpy(t),
                         torch.from_numpy(s), [torch.from_numpy(v)])
        want = tnet(torch.from_numpy(z.transpose(first)), torch.from_numpy(t),
                    s_conditioning=torch.from_numpy(s.transpose(first)),
                    v_conditionings=[torch.from_numpy(v)])
    want = want.numpy().transpose(last)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nd,mid_attn", [(2, True), (3, True), (3, False)])
def test_state_dict_equals_the_jax_converters(nd, mid_attn):
    """The port's converter and the JAX package's (then ``params_from_jax``)
    give the same state_dict from the same twin weights, schedule included."""
    tnet = _twin(nd, mid_attn, seed=1, perturb=True)
    raw = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    raw["gamma.b"] = np.asarray(-12.5, np.float32)
    raw["gamma.w"] = np.asarray(25.0, np.float32)
    jv = JVDM(JCUNet(**_kw(nd, mid_attn)),
              jmake_schedule("learned_linear", -13.3, 13.3))
    tree, jreport = jconvert.params_from_torch(raw, jv)
    tv = _port(nd, mid_attn)
    got, report = vt.params_from_torch(raw, tv)
    want = vt.params_from_jax(tree, tv)
    assert report == jreport and report["gamma_found"]
    assert sorted(got) == sorted(want) == sorted(tv.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["schedule.b"].item() == -12.5


def test_torch_key_names_follow_the_jax_tree():
    key = from_torch.torch_key
    assert key("down_0_0.GroupNorm_0.scale") == "down_0_0._GroupNorm_0.weight"
    assert key("up_1_0.Conv_1.kernel") == "up_1_0._Conv_1.weight"
    assert key("up_1_0.skip_proj.bias") == "up_1_0.skip_proj.bias"
    assert key("mid_attn_block.qkv.kernel") == "mid_attn_blk.qkv.weight"
    assert key("mid_attn_block.GroupNorm_0.bias") \
        == "mid_attn_blk._GroupNorm_0.bias"
    assert key("norm_out.scale") == "norm_out.weight"
    assert key("t_dense0.kernel") == "t_dense0.weight"
    assert key("mid_attn_block.proj.bias", {"mid_attn": "attn"}) \
        == "attn.proj.bias"


def test_missing_and_unused_keys():
    tnet = _twin(2, False)
    tv = _port(2, False)
    sd = dict(tnet.state_dict())
    sd.pop("conv_in.weight")
    sd["extra.weight"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        vt.params_from_torch(sd, tv)
    out, report = vt.params_from_torch(sd, tv, strict=False)
    assert report["missing"] == ["conv_in.weight"]
    assert report["unused"] == ["extra.weight"]
    assert "score_model.conv_in.kernel" not in out
    sd["conv_in.weight"] = torch.zeros(8, 3, 3, 3)  # the wrong Cin
    with pytest.raises(ValueError, match="conv_in"):
        vt.params_from_torch(sd, tv)
    sfm = vt.SFM(vt.CUNet(**_kw(2, False), device="cpu"))
    with pytest.raises(TypeError, match="VDM"):
        vt.params_from_torch(tnet.state_dict(), sfm)


@pytest.mark.parametrize("prefix,renames", [
    (None, []), ("model.score_model.", [("blockA", "down_0_0")]),
    ("", [("^model\\.", ""), ("score_model\\.", "")])])
def test_strip_and_rename_equals_the_jax_function(prefix, renames):
    sd = {"model.score_model.conv_in.weight": np.zeros(1),
          "model.score_model.blockA.w": np.zeros(1),
          "model.gamma.b": np.zeros(1), "other": np.zeros(1)}
    got = vt.strip_and_rename(sd, prefix, renames)
    want = jconvert.strip_and_rename(sd, prefix, renames)
    assert list(got) == list(want)


def test_convert_ckpt_round_trip_loads_in_generate(tmp_path, capsys):
    """A Lightning-style file of the twin's weights -> ``convert_ckpt`` ->
    ``cli.generate --ckpt-dir`` on the 2D smoke preset."""
    sets = ["data.cropsize=16", "model.chs=(8,8,8,8)", "model.norm_groups=4"]
    tnet = _twin(2, False, seed=2, perturb=True, size=16)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {f"model.score_model.{k}": v for k, v in
                               tnet.state_dict().items()},
                "epoch": 3}, ckpt)
    out = tmp_path / "converted"
    assert convert_ckpt.main([str(ckpt), str(out), "--preset",
                              "smoke_vdm_2d", "--set", *sets,
                              "--step", "7"]) == 0
    assert "no gamma" in capsys.readouterr().out
    tv = _port(2, False, size=16)
    params = load_params(str(out), tv)
    want, _ = vt.params_from_torch(tnet.state_dict(), tv)
    assert sorted(params) == sorted(want)
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    gen = tmp_path / "samples"
    assert generate.main(["smoke_vdm_2d", str(gen), "CV_12_12", "--ckpt-dir",
                          str(out), "--device", "cpu", "--n-sampling-steps",
                          "1", "--reps-per-batch", "12", "--set",
                          *sets]) == 0
    a = np.load(gen / "gen_0.npy")
    assert a.shape == (12, 1, 16, 16) and np.isfinite(a).all()
    with pytest.raises(SystemExit):
        convert_ckpt.main([str(ckpt), str(out), "--preset", "smoke_sfm_3d"])
