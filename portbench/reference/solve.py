"""The learned iterative solve, step by step from its definition:

    r_0 = L 0 + k^2 0 - s = -s, with k^2 = (omega / c)^2
    u_{t+1} = u_t + net([u_t, 1e3 r_t, sigmas], states_t) / 1e3
    r_{t+1} = L u_{t+1} + k^2 u_{t+1} - s

and the per-sample root mean square of r after each step. With
`amplitude`, each sample's source is first scaled so that its peak
complex magnitude is `amplitude`, and every output is scaled back.
"""

from __future__ import annotations

import contextlib

import torch

from .physics import Operator, rmse
from .unet import step

RESIDUAL_SCALE = 1e3


@contextlib.contextmanager
def f32_products():
    """Products in f32 on the card: TF32 off for matmuls and cuDNN."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def solve(weights: dict, model: dict, op: Operator, sos: torch.Tensor,
          source: torch.Tensor, *, iterations: int, omega: float,
          amplitude=None, precision: dict):
    """sos [S, *grid]; source [S, *grid, 2]. Returns the last wavefield
    [S, *grid, 2] and the rmse history [iterations, S]."""
    depth, state_depth = model["depth"], model["state_depth"]
    k_sq = (omega / sos) ** 2
    src = source
    scale = None
    if amplitude is not None:
        peak = torch.sqrt(src[..., 0] ** 2 + src[..., 1] ** 2).flatten(1).amax(1)
        scale = torch.where(peak > 0, amplitude / peak, torch.ones_like(peak))
        src = src * scale.reshape((-1,) + (1,) * (src.dim() - 1))
    s, grid = sos.shape[0], tuple(sos.shape[1:])
    wf = torch.zeros(sos.shape + (2,), dtype=torch.float32, device=sos.device)
    res = op.residual(wf, k_sq, src, precision["operator"])
    states = [torch.zeros((s, model["state_channels"]) + tuple(n >> d for n in grid),
                          device=sos.device) for d in range(state_depth)]
    sig = op.sigmas[None].expand((s,) + tuple(op.sigmas.shape))
    history = []
    with f32_products():
        for _ in range(iterations):
            x = torch.cat([wf.movedim(-1, 1), RESIDUAL_SCALE * res.movedim(-1, 1), sig], 1)
            d, states = step(weights, x, states, depth=depth, state_depth=state_depth,
                             resample=model["resample"], precision=precision)
            wf = d.movedim(1, -1) / RESIDUAL_SCALE + wf
            res = op.residual(wf, k_sq, src, precision["operator"])
            history.append(rmse(res))
    history = torch.stack(history)
    if scale is not None:
        wf = wf / scale.reshape((-1,) + (1,) * (wf.dim() - 1))
        history = history / scale
    return wf, history
