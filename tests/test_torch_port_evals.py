"""The port's evaluation modules (``vdm4cdm_torch/evals``) against the JAX
package's on the CPU, on the same seeded numpy inputs.

Tolerances: spectra k and N(k) equal (the same numpy grid, binned in the
same order), P(k) and r(k) within 1e-5 relative (f32 FFTs of two libraries
and another summation order over channels); ``log_pdf`` counts equal;
``WST_abs2`` within 1e-4 relative (f32 FFT round trips, 96 order-2 stacks),
``get_rwst`` equal (the same numpy); ``gpr`` within 1e-10 (the same numpy
and scipy code, one seeded generator); the figure's arrays within 1e-5
relative of what the JAX package's hooks compute, its histograms equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdm4cdm_tpu import presets as jpresets
from vdm4cdm_tpu.cli import _common as jcommon
from vdm4cdm_tpu.evals import figures as jfigures
from vdm4cdm_tpu.evals import gpr as jgpr
from vdm4cdm_tpu.evals import lwt as jlwt
from vdm4cdm_tpu.evals import pdfs as jpdfs
from vdm4cdm_tpu.evals import spectra as jspectra

import vdm4cdm_torch as vt
from vdm4cdm_torch.cli import _common as tcommon
from vdm4cdm_torch.evals import figures, gpr, lwt, pdfs, spectra

SPECTRA_SHAPES = [(2, 1, 16, 16), (2, 2, 15, 15), (2, 1, 12, 12, 12),
                  (3, 2, 9, 10, 11)]
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


@pytest.mark.parametrize("shape", SPECTRA_SHAPES, ids=str)
@pytest.mark.parametrize("second", [False, True], ids=["auto", "cross"])
def test_power_matches_jax(shape, second):
    x, y = _pair(shape, 1)
    y = y if second else None
    want = jspectra.power(jnp.asarray(x),
                          None if y is None else jnp.asarray(y))
    got = spectra.power(torch.from_numpy(x),
                        None if y is None else torch.from_numpy(y))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1], want[1])


@pytest.mark.parametrize("shape", SPECTRA_SHAPES, ids=str)
@pytest.mark.parametrize("second", [False, True], ids=["auto", "cross"])
def test_pk_matches_jax(shape, second):
    x, y = _pair(shape, 2)
    y = y if second else None
    want = jspectra.pk(jnp.asarray(x), None if y is None else jnp.asarray(y))
    got = spectra.pk(torch.from_numpy(x),
                     None if y is None else torch.from_numpy(y))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1], want[1])


@pytest.mark.parametrize("shape", SPECTRA_SHAPES, ids=str)
@pytest.mark.parametrize("full", [False, True], ids=["pairs", "full"])
def test_get_ccs_matches_jax(shape, full):
    x, y = _pair(shape, 3)
    wk, wc = jspectra.get_ccs(jnp.asarray(x), jnp.asarray(y), full=full)
    gk, gc = spectra.get_ccs(torch.from_numpy(x), torch.from_numpy(y),
                             full=full)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    _close(gc, wc)


def test_get_ccs_full_table_holds_every_pair():
    x, y = _pair((3, 1, 12, 12), 4)
    _, table = spectra.get_ccs(torch.from_numpy(x), torch.from_numpy(y[:2]),
                               full=True)
    for i in range(3):
        for j in range(2):
            _, one = spectra.get_ccs(torch.from_numpy(x[i:i + 1]),
                                     torch.from_numpy(y[j:j + 1]))
            _close(table[i, j], one[0], 1e-6)


def _bin_of(values, edges):
    """numpy's bin of each value (-1 outside), as np.histogram puts it."""
    idx = np.searchsorted(edges, values, side="right") - 1
    idx[values == edges[-1]] = len(edges) - 2
    idx[(values < edges[0]) | (values > edges[-1])] = -1
    return idx


@pytest.mark.parametrize("bins,shape,loc", [
    ("BINS_3D", (3, 1, 16, 16, 16), 11.5),
    ("BINS_2D", (3, 1, 32, 32), 13.0)])
def test_log_pdf_counts_equal_jax(bins, shape, loc):
    edges = getattr(jpdfs, bins)
    np.testing.assert_array_equal(getattr(pdfs, bins), edges)
    rng = np.random.default_rng(5)
    f = (10.0 ** rng.normal(loc, 1.2, shape)).astype(np.float32)
    want = np.asarray(jpdfs.log_pdf(jnp.asarray(f), edges))
    got = pdfs.log_pdf(torch.from_numpy(f), edges).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.sum() > 0.9 * f[0].size
    if not np.array_equal(got, want):
        # name the values that moved a bin, with their distance to the edge
        e32 = np.asarray(edges, np.float32)
        lj = np.asarray(jnp.log10(jnp.asarray(f.reshape(len(f), -1)) + 1.0))
        lt = torch.log10(torch.from_numpy(f.reshape(len(f), -1)) + 1.0)
        lt = lt.numpy()
        moved = np.nonzero(_bin_of(lj, e32) != _bin_of(lt, e32))
        lines = [f"x={f.reshape(len(f), -1)[i]!r}: log10 jax {lj[i]!r}, "
                 f"torch {lt[i]!r}, nearest edge distance "
                 f"{np.abs(e32 - lj[i]).min():.3g}" for i in zip(*moved)]
        pytest.fail("log_pdf bins differ:\n" + "\n".join(lines[:10]))


def test_histogram_has_numpy_edge_semantics():
    edges = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.float64)
    rows = torch.tensor([[-0.5, 0.0, 0.999, 1.0, 2.0, 3.0, 3.0, 3.5]])
    got = pdfs.histogram(rows, edges).numpy()
    want, _ = np.histogram(rows.numpy()[0], bins=edges.numpy())
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[0], [2, 1, 3])


@pytest.mark.parametrize("N", [32, 128])
def test_wst_abs2_matches_jax(N):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, N, N)).astype(np.float32)
    jm, jv = jlwt.make_wavelets(N=N, NR=4, NT=4, sqrt=True)
    tm, tv = lwt.make_wavelets(N=N, NR=4, NT=4, sqrt=True)
    assert tm == jm
    want = np.asarray(jlwt.WST_abs2(jnp.asarray(x), jm, jv, m=2))
    got = lwt.WST_abs2(torch.from_numpy(x), tm, tv, m=2).numpy()
    assert got.shape == want.shape == (2, 2 + 16 + 96)
    _close(got, want, 1e-4)
    one = lwt.WST_abs2(torch.from_numpy(x[0]), tm, tv, m=2).numpy()
    _close(one, want[0], 1e-4)
    np.testing.assert_array_equal(lwt.get_rwst(want), jlwt.get_rwst(want))
    np.testing.assert_array_equal(lwt.get_rwst(want[0]),
                                  jlwt.get_rwst(want[0]))


def test_wst_order_one_only_matches_jax():
    x = np.random.default_rng(7).standard_normal((1, 32, 32))
    x = x.astype(np.float32)
    jm, jv = jlwt.make_wavelets(N=32, NR=3, NT=2, sqrt=False)
    tm, tv = lwt.make_wavelets(N=32, NR=3, NT=2, sqrt=False)
    want = np.asarray(jlwt.WST_abs2(jnp.asarray(x), jm, jv, m=1))
    _close(lwt.WST_abs2(torch.from_numpy(x), tm, tv, m=1).numpy(), want,
           1e-4)


def _gpr_image(seed, n=48):
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(n)[:, None]
    ky = np.fft.rfftfreq(n)[None, :]
    amp = np.exp(-(kx**2 + ky**2) / (2 * 0.05**2))
    noise = rng.standard_normal((n, n // 2 + 1)) + 1j * rng.standard_normal(
        (n, n // 2 + 1))
    return np.fft.irfftn(noise * amp, s=(n, n), axes=(0, 1))


def test_gpr_matches_jax():
    im = _gpr_image(8)
    cov_t = gpr.get_radial_cov_func_image(
        im, r_cov_est=16, n_cov_est=200, return_stats=True,
        rng=np.random.default_rng(9))
    cov_j = jgpr.get_radial_cov_func_image(
        im, r_cov_est=16, n_cov_est=200, return_stats=True,
        rng=np.random.default_rng(9))
    rs = np.linspace(0, 20, 41)
    np.testing.assert_allclose(cov_t[0](rs), cov_j[0](rs), rtol=0, atol=1e-10)
    for a, b in zip(cov_t[1:], cov_j[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)

    def smooth(r):
        return 2.0 * np.exp(-0.3 * np.asarray(r)) + 0.1

    ft, pt = gpr.get_parametric_radial_cov_func(smooth, (0, 10),
                                                return_params=True)
    fj, pj = jgpr.get_parametric_radial_cov_func(smooth, (0, 10),
                                                 return_params=True)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)

    def cov(a, b):
        return smooth(np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :]))

    x_k = np.linspace(0, 10, 12)
    y_k = np.sin(x_k)
    x_uk = np.linspace(0.5, 9.5, 7)
    rt = gpr.get_gpr_result(x_uk, x_k, y_k, cov, n_samples=5, reg_diag=1e-6,
                            rng=np.random.default_rng(10))
    rj = jgpr.get_gpr_result(x_uk, x_k, y_k, cov, n_samples=5, reg_diag=1e-6,
                             rng=np.random.default_rng(10))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)

    mask = np.zeros((32, 32))
    mask[8:24, 4:20] = 1
    for a, b in zip(gpr.get_smooth_mask_boundary(mask, 2.0),
                    jgpr.get_smooth_mask_boundary(mask, 2.0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    weight = gpr.get_smooth_mask_boundary(mask, 2.0)[1]
    for grad in (True, False):
        zt = gpr.get_smoothness(im[:32, :32], weight, return_maps=True,
                                gradient=grad)
        zj = jgpr.get_smoothness(im[:32, :32], weight, return_maps=True,
                                 gradient=grad)
        for a, b in zip(zt, zj):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


# ------------------------------------------------------------ the figure

class _LogDM:
    """A data module whose unnormalization is not the identity (works on
    numpy arrays and on tensors)."""

    @staticmethod
    def unnorm_func(field, i_channel):
        return 10.0 ** (field * 0.5 + 0.1 * (i_channel + 1))


@dataclasses.dataclass
class _JaxFake:
    """Stands in for the JAX VDM / SFM in the JAX figure hook: its
    draw_samples returns given samples."""

    score_model: object
    samples: object

    def draw_samples(self, *args, **kwargs):
        return self.samples


class _Clonable:
    def clone(self, ctx):
        return self


class _TorchFake:
    """The same for the port's hook: no parameters, fixed samples."""

    def __init__(self, samples):
        self.samples = samples

    def named_parameters(self):
        return iter(())

    def draw_samples(self, *args, **kwargs):
        return self.samples


def _figure_case(family, size, seed):
    rng = np.random.default_rng(seed)
    shape = (2,) + (size,) * 3 + (1,)
    x, c, s = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v = rng.standard_normal((2, 6)).astype(np.float32)
    if family == "sfm":
        batch = {"x0": c, "x1": x, "conditioning_values": [v]}
    else:
        batch = {"x": x, "conditioning": c, "conditioning_values": [v]}
    return batch, s


@pytest.mark.parametrize("family", ["vdm", "sfm"])
def test_panel_data_matches_the_jax_hooks(family, monkeypatch):
    """The port's hook (``cli/_common.py::make_validation_figure_fn``,
    through ``panel_data``) against the arrays the JAX package's hooks
    compute for the same batch and samples (the JAX figure's histograms
    are matplotlib's: numpy's counts)."""
    name = "trainSFM3D128_c_c" if family == "sfm" else "trainVDM3D128_c_c"
    size = 16
    batch, samples = _figure_case(family, size, 11)
    jcfg = jpresets.preset(name, **{"data.cropsize": size})
    seen = {}

    def capture(batch_n, samp, **hooks):
        seen.update(batch=batch_n, samples=samp, hooks=hooks)
        return "figure"

    target = "draw_figure_sfm" if family == "sfm" else "draw_figure"
    monkeypatch.setattr(jfigures, target, capture)
    jdraw = jcommon.make_validation_figure_fn(
        jcfg, _JaxFake(_Clonable(), jnp.asarray(samples)), _LogDM())
    assert jdraw({}, {k: v for k, v in batch.items()}, None) == "figure"
    hooks = seen["hooks"]

    tcfg = vt.preset(name, **{"data.cropsize": size})
    tdraw = tcommon.make_validation_figure_fn(
        tcfg, _TorchFake(torch.from_numpy(samples)), _LogDM())
    tbatch = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
                  else torch.from_numpy(v)) for k, v in batch.items()}
    panel = tdraw.panel_data({}, tbatch, None)

    key_x, key_c = ("x1", "x0") if family == "sfm" else ("x", "conditioning")
    x = np.moveaxis(batch[key_x], -1, 1)[0]
    c = np.moveaxis(batch[key_c], -1, 1)[0]
    s = np.moveaxis(samples, -1, 1)[0]
    im = panel["images"]
    _close(im["GT Target"], hooks["x_to_im"](x))
    _close(im["Sampled Target"], hooks["x_to_im"](s))
    _close(im["Conditioning"], hooks["conditioning_to_im"](c))
    want_pk = [hooks["pk_func"](x[0], 0), hooks["pk_func"](s[0], 0),
               hooks["pk_func"](c[0], 0)]
    assert [p[0] for p in panel["pk"]] == [
        "GT Channel 0", "Sampled Channel 0", "Conditioning Channel 0"]
    for (_, gk, gp), (wk, wp) in zip(panel["pk"], want_pk):
        _close(gk, wk)
        _close(gp, wp)
    (label, gk, gc), = panel["cc"]
    wk, wc = hooks["cc_func"](x[0], s[0], 0)
    _close(gk, wk)
    _close(gc, wc)
    for (_, edges, counts), field in zip(panel["hist"], (x, s, c)):
        want, _ = np.histogram(field[0].ravel(), bins=np.linspace(-4, 4, 50))
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(edges, np.linspace(-4, 4, 50))
    assert panel["text"] == hooks["conditioning_values_to_str"](
        batch["conditioning_values"][0][0])


def test_render_draws_the_panel():
    pytest.importorskip("matplotlib")
    batch, samples = _figure_case("vdm", 8, 12)
    tbatch = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
                  else torch.from_numpy(v)) for k, v in batch.items()}
    cfg = vt.preset("trainVDM3D128_c_c", **{"data.cropsize": 8})
    draw = tcommon.make_validation_figure_fn(
        cfg, _TorchFake(torch.from_numpy(samples)), _LogDM())
    fig = draw({}, tbatch, None)
    try:
        axes = fig.axes
        assert len(axes) == 6
        assert [a.get_title() for a in axes] == [
            "Conditioning", "GT Target", "Sampled Target", "",
            "Powerspectra", "Cross Correlation"]
        assert len(axes[3].patches) == 3  # GT, sampled, conditioning
        assert len(axes[4].lines) == 3 and len(axes[5].lines) == 1
    finally:
        import matplotlib.pyplot as plt

        plt.close(fig)
    fig2 = figures.draw_figure_sfm(
        {"x0": tbatch["conditioning"], "x1": tbatch["x"]},
        torch.from_numpy(samples))
    try:
        assert len(fig2.axes[3].patches) == 3
    finally:
        import matplotlib.pyplot as plt

        plt.close(fig2)


def test_importing_the_evals_needs_no_matplotlib():
    import subprocess
    import sys

    code = ("import sys, vdm4cdm_torch.evals, vdm4cdm_torch.cli.calc_ss, "
            "vdm4cdm_torch.cli.train; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(__import__("pathlib").Path(__file__).parents[1]))
