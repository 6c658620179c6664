"""The first steps of unsupervised training, from their definition.

A step draws rows of the replay buffer (a wavefield, its residual, the
hidden states, k^2, the source and the row's age), runs `unroll` solver
steps with the gradient kept, and takes as loss

    amplify * mean over (steps, batch, grid, re/im) of r_t^2.

The optimizer clips each gradient value to [-clip, clip], adds the L2
term `weight_decay * p`, and takes an Adam step (b1, b2, eps, bias
corrections from step 1). Then each drawn row is written back: the row
after the kept unrolled step `pick` (age + pick + 1) where its mean r^2
there is under 1 and that age under `maxiter`, else a fresh restart (a
zero wavefield and states, the residual of the zero field, age 0) of
the step's fresh map and source. Everything here is plain PyTorch in
f32 on the weights in the npz's (JAX) layouts, whose leaf names are
`unet.leaf_names`'.
"""

from __future__ import annotations

import math

import torch

from .physics import Operator
from .solve import RESIDUAL_SCALE, f32_products
from .unet import step


def fresh_rows(op: Operator, sos: torch.Tensor, source: torch.Tensor, *, omega: float,
               state_channels: int, state_depth: int) -> dict:
    """Fresh experiences of maps sos [B, H, W] and sources [B, H, W, 2]:
    a zero wavefield and states, the residual of the zero field."""
    k_sq = (omega / sos) ** 2
    wf = torch.zeros_like(source)
    n = sos.shape[1]
    states = [torch.zeros((sos.shape[0], state_channels, n >> d, n >> d), device=sos.device)
              for d in range(state_depth)]
    return {"wavefield": wf, "residual": op.residual(wf, k_sq, source), "states": states,
            "k_sq": k_sq, "source": source}


def unrolled_loss(weights: dict, model: dict, op: Operator, batch: dict, *,
                  unroll: int, amplify: float, precision: dict):
    """batch: wavefield [B, H, W, 2], residual, states (list of [B, C, h, w]),
    k_sq [B, H, W], source [B, H, W, 2]. Returns (loss, the (wavefield,
    residual, states) after each step)."""
    wf, res, states = batch["wavefield"], batch["residual"], batch["states"]
    k_sq, src = batch["k_sq"], batch["source"]
    s = wf.shape[0]
    sig = op.sigmas[None].expand((s,) + tuple(op.sigmas.shape))
    after = []
    for _ in range(unroll):
        x = torch.cat([wf.movedim(-1, 1), RESIDUAL_SCALE * res.movedim(-1, 1), sig], 1)
        d, states = step(weights, x, states, depth=model["depth"],
                         state_depth=model["state_depth"], resample=model["resample"],
                         precision=precision)
        wf = d.movedim(1, -1) / RESIDUAL_SCALE + wf
        res = op.residual(wf, k_sq, src, precision["operator"])
        after.append((wf, res, states))
    residuals = torch.stack([r for _, r, _ in after])
    return amplify * torch.mean(residuals**2), after


def _split(rows: dict) -> list:
    """A batch of rows -> one dict a row (leading axis kept, length 1)."""
    n = rows["wavefield"].shape[0]
    return [{k: [s[j:j + 1] for s in v] if k == "states" else v[j:j + 1]
             for k, v in rows.items()} for j in range(n)]


def _stack(rows: list) -> dict:
    out = {k: torch.cat([r[k] for r in rows]) for k in ("wavefield", "residual", "k_sq",
                                                        "source")}
    out["states"] = [torch.cat(level) for level in zip(*(r["states"] for r in rows))]
    return out


class Adam:
    """Clip by value, L2 term, Adam; one state a leaf."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, clip: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.m, self.v, self.t = {}, {}, 0
        self.first = {}  # each leaf's first gradient as the moments took it

    def step(self, params: dict, grads: dict) -> dict:
        """The params after one step on `grads`."""
        self.t += 1
        out = {}
        for name, p in params.items():
            g = grads[name].clamp(-self.clip, self.clip) + self.weight_decay * p
            if self.t == 1:
                self.first[name] = g
            m = self.b1 * self.m.get(name, torch.zeros_like(p)) + (1 - self.b1) * g
            v = self.b2 * self.v.get(name, torch.zeros_like(p)) + (1 - self.b2) * g * g
            self.m[name], self.v[name] = m, v
            mh = m / (1 - self.b1**self.t)
            vh = v / (1 - self.b2**self.t)
            out[name] = p - self.lr * mh / (torch.sqrt(vh) + self.eps)
        return out


def train_steps(weights: dict, model: dict, op: Operator, draws: list, *, start, fresh,
                unroll: int, amplify: float, precision: dict, adam: Adam, block: int):
    """The steps of `draws`, each (slots, fresh maps, fresh sources, pick,
    maxiter): lists of ints a drawn row, the kept unrolled step and the
    age limit. `start(slots)` gives the rows the buffer was filled with
    and their ages (a list), `fresh(maps, sources)` fresh rows. Rows are
    run in blocks of `block`, whose losses are averaged as one batch's.
    Returns the losses, each leaf's first gradient as the optimizer took
    it, the params after the last step, and every drawn slot's row (with
    its `age`) after the last step."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    losses, slots = [], {}
    with f32_products():
        for slot_idx, fresh_idx, fresh_src, pick, maxiter in draws:
            new = [i for i in slot_idx if i not in slots]
            if new:
                rows, ages = start(new)
                for i, row, age in zip(new, _split(rows), ages):
                    slots[i] = dict(row, age=age)
            rows = [slots[i] for i in slot_idx]
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            total, grads = 0.0, {k: torch.zeros_like(v) for k, v in leaves.items()}
            evolved = []
            for a in range(0, len(rows), block):
                part = _stack(rows[a:a + block])
                loss, after = unrolled_loss(leaves, model, op, part, unroll=unroll,
                                            amplify=amplify, precision=precision)
                share = part["wavefield"].shape[0] / len(rows)
                got = torch.autograd.grad(loss * share, list(leaves.values()))
                for k, g in zip(leaves, got):
                    grads[k] += g
                total += float(loss.detach()) * share
                wf, res, states = after[pick]
                evolved += _split({"wavefield": wf.detach(), "residual": res.detach(),
                                   "states": [x.detach() for x in states],
                                   "k_sq": part["k_sq"], "source": part["source"]})
            losses.append(total)
            renew = _split(fresh(fresh_idx, fresh_src))
            for j, i in enumerate(slot_idx):
                age = rows[j]["age"] + pick + 1
                keep = float(torch.mean(evolved[j]["residual"] ** 2)) < 1.0 and age < maxiter
                slots[i] = dict(evolved[j], age=age) if keep else dict(renew[j], age=0)
            params = adam.step({k: v.detach() for k, v in leaves.items()}, grads)
    return {"losses": losses, "first_grad": adam.first, "params": params, "slots": slots}


def leaf_gap(got: float, want: float, scale: float) -> float:
    """|got - want| over max(want, scale): the gap of two norms against the
    reference's norm of the leaf, or the median leaf's where larger."""
    return abs(got - want) / max(want, scale) if math.isfinite(got) else math.inf
