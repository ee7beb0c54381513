"""DDNM: zero-shot linear inverse problems on a trained VDM, counterpart of
``vdm4cdm_tpu/diffusion/ddnm.py``.

At each of the ``n_sampling_steps`` reverse steps, optionally time-travel back
``l`` steps by re-noising with q(z_t | z_s), then walk forward replacing the
data-space estimate x0t by its null-space projection

    x0t_r = AT(y) + x0t - AT(A(x0t))

so samples are consistent with the measurement y = A(x) while the model fills
the null space of A.

Both loops are Python loops over host integers (L_i = min(l[i], i)). Noise
comes from a ``torch.Generator`` on the model's device, or from an injected
sequence consumed in the order the JAX function consumes its keys: the
initial z, then per outer step one re-noising draw followed by L_i + 1 eps
draws.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .vdm import VDM


@torch.inference_mode()
def ddnm_sample(
    vdm: VDM,
    y: torch.Tensor,
    A: Callable[[torch.Tensor], torch.Tensor],
    AT: Callable[[torch.Tensor], torch.Tensor],
    n_sampling_steps: int = 250,
    l: Union[int, Sequence[int], np.ndarray] = 10,
    s_conditioning: Optional[torch.Tensor] = None,
    v_conditionings: Sequence[torch.Tensor] = (),
    return_all: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Iterable[torch.Tensor]] = None,
) -> torch.Tensor:
    """Returns the final null-space-corrected x0 estimate (B, *spatial, C),
    or with ``return_all=True`` every step's estimate stacked along a leading
    axis (n_sampling_steps, B, *spatial, C). ``noise`` is an iterable of
    tensors of z's shape, drawn from in order instead of ``generator``."""
    if isinstance(l, int):
        l = np.full(n_sampling_steps, l)
    l = np.asarray(l)
    if l.ndim != 1 or len(l) != n_sampling_steps:
        raise ValueError("l must have one entry per step")
    if not (np.issubdtype(l.dtype, np.integer) and np.all(l >= 0)):
        raise ValueError("l must hold non-negative integers")
    if generator is None and noise is None:
        raise ValueError("pass a torch.Generator or the noise itself")
    draws = iter(noise) if noise is not None else None

    dev = vdm.device
    y = y.to(dev)
    shape = (y.shape[0],) + vdm.sample_shape_nlast
    steps = torch.linspace(1.0, 0.0, n_sampling_steps + 1,
                           dtype=torch.float32).tolist()
    ls = np.minimum(l, np.arange(n_sampling_steps)).tolist()
    ATy = AT(y)

    def normal():
        return vdm._normal(shape, generator,
                           next(draws) if draws is not None else None)

    z = normal()
    x0t_rs = []
    for i, L in enumerate(ls):
        # time travel: re-noise from t = steps[i] back up to t = steps[i - L]
        z = vdm.sample_zt_given_zs(z, steps[i - L], steps[i], eps=normal())
        for j in range(L, -1, -1):
            w_z, w_x0t, x0t, scale = vdm.ddnm_coeffs(
                z, steps[i - j], steps[i + 1 - j], s_conditioning,
                v_conditionings)
            x0t_r = ATy + x0t - AT(A(x0t))
            z = w_z * z + w_x0t * x0t_r + scale * normal()
        if return_all:
            x0t_rs.append(x0t_r)
    return torch.stack(x0t_rs) if return_all else x0t_r
