"""Remat in the port's CUNet: the set of checkpointed ResBlocks follows the
JAX module's rule, and loss and gradients are the same with and without it.
On the CPU the plain path is deterministic and the recomputed forward
regenerates the same dropout mask from (seed, index), so the comparison is
exact (tolerance 1e-6 relative, for safety against a fused-op reordering)."""

import numpy as np
import pytest
import torch

import vdm4cdm_torch as vt


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One thread for the module's torch work: beside five other test
    workers, more only contend for the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


KW = dict(shape=(1, 8, 8, 8), chs=(8, 16, 16), s_conditioning_channels=1,
          v_conditioning_dims=(6,), norm_groups=4, mid_attn=False,
          dropout_prob=0.3, conv_padding_mode="circular", num_res_blocks=1)
ALL = ("down_0_0", "down_1_0", "down_2_0", "mid_0", "mid_1", "up_2_0",
       "up_2_1", "up_1_0", "up_1_1", "up_0_0", "up_0_1")


def _jax_rule(name, level, remat, remat_levels, remat_blocks):
    """``Res`` of vdm4cdm_tpu/models/cunet.py."""
    use = remat and (remat_levels is None or level < remat_levels)
    return use or name in tuple(remat_blocks)


def _level(name):
    return 2 if name.startswith("mid") else int(name.split("_")[1])


REMATS = [dict(remat=True), dict(remat=True, remat_levels=1),
          dict(remat_blocks=("down_0_0",)),
          dict(remat=True, remat_levels=2, remat_blocks=("mid_1",)),
          dict(remat_levels=1)]
IDS = ["remat", "remat_levels_1", "remat_blocks", "levels_and_blocks",
       "levels_without_remat"]


@pytest.mark.parametrize("kw", REMATS, ids=IDS)
def test_checkpointed_blocks_follow_the_jax_rule(kw):
    net = vt.CUNet(**KW, **kw, device="cpu")
    want = tuple(n for n in ALL if _jax_rule(
        n, _level(n), kw.get("remat", False), kw.get("remat_levels"),
        kw.get("remat_blocks", ())))
    assert net.remat_block_names() == want
    assert tuple(n for n, _ in net._block_levels()) == ALL
    assert vt.CUNet(**KW, device="cpu").remat_block_names() == ()


def _loss_and_grads(model, seed=7):
    rng = np.random.default_rng(61)
    x0 = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 1))
                          .astype(np.float32))
    batch = {"x0": x0, "x1": torch.from_numpy(
        rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32)),
        "conditioning_values": [torch.from_numpy(
            rng.standard_normal((2, 6)).astype(np.float32))]}
    eps = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 1))
                           .astype(np.float32))
    losses = model.loss(batch, train=True, t=torch.tensor([0.3, 0.8]),
                        eps=eps, dropout_seed=seed)
    losses.loss.backward()
    return losses.loss.detach(), {k: p.grad.clone()
                                  for k, p in model.named_parameters()}


def _randomized(gen_seed=5, **kw):
    net = vt.CUNet(**KW, **kw, device="cpu",
                   generator=torch.Generator().manual_seed(gen_seed))
    with torch.no_grad():  # zero-init convs would hide the blocks
        gen = torch.Generator().manual_seed(gen_seed + 1)
        for name, p in net.named_parameters():
            if p.abs().max() == 0:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return vt.SFM(net, sigma=0.5)


@pytest.mark.parametrize("kw", REMATS[:3], ids=IDS[:3])
def test_loss_and_grads_equal_with_and_without_remat(kw):
    ref_loss, ref = _loss_and_grads(_randomized())
    model = _randomized(**kw)
    assert model.unet.remat_block_names()
    loss, got = _loss_and_grads(model)
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * abs(ref_loss.item())
    top = max(g.abs().max().item() for g in ref.values())
    assert top > 1e-4
    for name, g in ref.items():
        assert (got[name] - g).abs().max().item() <= 1e-6 * top, name
    # another dropout seed is another loss: the mask is live in both passes
    other, _ = _loss_and_grads(_randomized(**kw), seed=8)
    assert other.item() != loss.item()


def test_remat_recomputes_only_under_grad():
    """A checkpointed block enters its forward a second time in the backward
    (and leaves it as soon as the saved tensors are back, so a pre-hook
    counts it); without gradients (eval, sampling) nothing is checkpointed."""
    model = _randomized(remat_blocks=("down_0_0",))
    calls = []
    model.unet.down_0_0.register_forward_pre_hook(lambda *a: calls.append(1))
    _loss_and_grads(model)
    assert len(calls) == 2
    calls.clear()
    with torch.no_grad():
        model.velocity(torch.zeros(1, 8, 8, 8, 1), torch.zeros(1),
                       [torch.zeros(1, 6)], torch.zeros(1, 8, 8, 8, 1))
    assert len(calls) == 1
