"""Where the port's GroupNorm loses digits: the sum-based f32 variance at an
ill-conditioned group, located on the CPU against the torch twin of the
CUNet (``tools/torch_cunet.py``) run in f64.

The set-up is ``test_torch_port_from_torch.py``'s 3D twin at 8^3, chs
(8, 8, 8, 8), GroupNorm(4), no ``mid_attn``, seed 0, with every parameter
moved by 0.1 N(0, 1) (``perturb``). Its deepest level is one voxel, so a
group there holds ``count = 2`` values (1 voxel x 2 channels).

Both packages take a group's variance as E[x^2] - E[x]^2 from f32 sums
(``vdm4cdm_torch/ops/norm.py::_finalize``, ``vdm4cdm_tpu/ops/norm.py``
``_xla_group_norm_stats``). Each of E[x^2] and E[x]^2 carries a rounding
error of about 2^-24 E[x^2]; their difference, the variance, keeps them
whole, so its relative error is about 2^-24 kappa with the group's
conditioning kappa = E[x^2] / (var + eps). 1/sigma takes half of that, and
the normalized values feed the rest of the net. So the eps_hat error of
either package against the f64 twin is bounded, to the order of the net's
gain, by

    2^-24 * kappa_max * max |eps_hat|,

which is ``_bound`` below. At this input kappa_max is about 1e5, at a
``count == 2`` site; everywhere else it is orders of magnitude smaller.

Then the test puts the loss where it is: with the per-channel sums
(``gn_sums``) and ``_finalize`` both in f64 the port's error falls to within
2x of the twin's own f32 error, while ``_finalize`` alone in f64 (the sums
still f32) leaves it well above that. The digits go in the f32 sums Sigma x,
Sigma x^2 and their difference, not in a kernel, a layout or another op.
The port keeps the reference's formula (ROADMAP section 3, a deliberate
difference of summation order, not a fault); no production group is that
small (the trained model's hold 512 values).
"""

import copy
import os
import sys

import jax
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
from vdm4cdm_torch.ops import norm as ops_norm  # noqa: E402
from vdm4cdm_torch.ops.kernels import gn_sums  # noqa: E402

KW = dict(shape=(1, 8, 8, 8), chs=(8, 8, 8, 8), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.0, conv_padding_mode="circular")
FIRST, LAST = (0, 4, 1, 2, 3), (0, 2, 3, 4, 1)  # channels-last <-> first
# the worst group's conditioning must be this ill (measured: ~1e5)
KAPPA_MIN = 1e3
# f64 sums and finalize bring the port within this factor of the twin's
# own f32 error (the remaining f32 ops of both nets)
RECOVERY = 2.0


def _inputs():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32)
    s = rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32)
    v = rng.standard_normal((2, 6)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    return z, t, s, v


def _twin():
    """The moved twin (as ``test_torch_port_from_torch.py::_twin(3, False,
    perturb=True)`` builds it)."""
    torch.manual_seed(0)
    tnet = TorchCUNet(**KW)
    with torch.no_grad():
        for p in tnet.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    return tnet.eval()


def _twin_eps(tnet, dtype):
    z, t, s, v = _inputs()
    net = copy.deepcopy(tnet).to(dtype)
    cast = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    # the twin casts the conditioning values (exact in f32) to f32 before
    # its dense layers, and makes its timestep embedding's frequencies in
    # the default type
    for m in net.modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_pre_hook(
                lambda mod, args: tuple(a.to(dtype) for a in args))
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.no_grad():
            out = net(cast(z.transpose(FIRST)), cast(t),
                      s_conditioning=cast(s.transpose(FIRST)),
                      v_conditionings=[cast(v)])
    finally:
        torch.set_default_dtype(before)
    return out.double().numpy().transpose(LAST)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work is tiny; one thread keeps it off the cores
    that the other test workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    tnet = _twin()
    raw = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    port = vt.VDM(vt.CUNet(**KW, device="cpu"),
                  vt.make_schedule("learned_linear", device="cpu"))
    sd, report = vt.params_from_torch(raw, port)
    assert not report["missing"] and not report["unused"]
    port.load_state_dict(sd)
    jv = JVDM(JCUNet(**KW), jmake_schedule("learned_linear", -13.3, 13.3))
    tree, _ = jconvert.params_from_torch(raw, jv)
    return {"twin": tnet, "port": port, "jax": (jv, tree),
            "f64": _twin_eps(tnet, torch.float64),
            "f32": _twin_eps(tnet, torch.float32)}


def _port_eps(port):
    z, t, s, v = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        return port.eps_hat(z, t, s, [v]).double().numpy()


def _jax_eps(jv, tree):
    z, t, s, v = _inputs()
    out = jax.jit(lambda p: jv.eps_hat(p, z, t, s, [v]))(tree)
    return np.asarray(out, np.float64)


def _err(got, want):
    return float(np.abs(got - want).max())


class _Sites:
    """``ops/norm.py::_finalize`` wrapped: at every GroupNorm site of a
    forward, the group count and the worst E[x^2] / (var + eps) over the
    site's groups, computed in f64 from the f32 sums the port used. With
    ``f64`` the finalize itself runs in f64 (the result cast back to f32);
    with ``f64_sums`` the per-channel sums ``gn_sums`` are taken in f64 too.
    The module's names are restored on exit."""

    def __init__(self, f64=False, f64_sums=False):
        self.f64, self.f64_sums, self.sites = f64, f64_sums, []

    def __enter__(self):
        self._finalize, self._sums = ops_norm._finalize, ops_norm.gn_sums

        def finalize(sums, groups, count, eps):
            B, _, C = sums.shape
            g = sums.double().reshape(B, 2, groups, C // groups).sum(-1)
            m1, m2 = g[:, 0] / count, g[:, 1] / count
            var = torch.clamp(m2 - m1 * m1, min=0.0)
            self.sites.append((count, float((m2 / (var + eps)).max())))
            if not self.f64:
                return self._finalize(sums, groups, count, eps)
            mean, inv = self._finalize(sums.double(), groups, count, eps)
            return mean.float(), inv.float()

        def gn_sums(x):
            xd = x.double()
            return torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)

        ops_norm._finalize = finalize
        if self.f64_sums:
            ops_norm.gn_sums = gn_sums
        return self

    def __exit__(self, *exc):
        ops_norm._finalize, ops_norm.gn_sums = self._finalize, self._sums


def _bound(kappa, eps_hat):
    return 2.0 ** -24 * kappa * float(np.abs(eps_hat).max())


def test_the_worst_group_is_a_two_value_bottleneck_site(setup):
    with _Sites() as rec:
        _port_eps(setup["port"])
    assert len(rec.sites) > 10
    count, kappa = max(rec.sites, key=lambda s: s[1])
    assert count == 2 and kappa > KAPPA_MIN
    # every site with more than 2 values a group is far better conditioned
    assert max(k for c, k in rec.sites if c > 2) < kappa / 10


def test_both_packages_within_the_conditioning_bound_of_the_f64_twin(setup):
    with _Sites() as rec:
        port = _port_eps(setup["port"])
    kappa = max(k for _, k in rec.sites)
    bound = _bound(kappa, setup["f64"])
    port_err = _err(port, setup["f64"])
    jax_err = _err(_jax_eps(*setup["jax"]), setup["f64"])
    assert port_err <= bound and jax_err <= bound
    # the twin in f32, whose GroupNorm is torch's two-pass variance, sees
    # none of it
    assert _err(setup["f32"], setup["f64"]) < min(port_err, jax_err)


def test_f64_sums_and_finalize_recover_the_twins_f32_error(setup):
    twin_f32 = _err(setup["f32"], setup["f64"])
    with _Sites(f64=True, f64_sums=True):
        both = _err(_port_eps(setup["port"]), setup["f64"])
    with _Sites(f64=True):
        finalize_only = _err(_port_eps(setup["port"]), setup["f64"])
    assert ops_norm.gn_sums is gn_sums
    assert both <= RECOVERY * twin_f32
    assert finalize_only > RECOVERY * twin_f32
