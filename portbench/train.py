"""A training cell: the program's `Trainer` with its replay buffer on the
card, its window whole epochs of `Trainer.training_epoch`.

Set-up makes the weights from the seed (in the npz's layouts, on the
card, two large random draws) and the sound-speed maps, builds one
`Trainer` on them, and drives it through its first `check_steps` steps
by `Trainer.device_step`, the call its epochs make, with the age limit
`check_maxiter` (the curriculum's at a later epoch: the buffer is filled
with ages 0, 10, 20, ..., so about half the drawn rows carry their
evolved wavefield, residual and states back to their slots and the rest
restart fresh, and a row drawn again starts from what was written).
Those steps are the warm-up and what the reference follows; the rows
they wrote are copied to the host. The same object then runs the
window.

The reference (`reference/train.py`) takes, of the program, only the
slots, fresh maps, fresh sources and the kept unrolled step that the
Trainer's host RNG drew for each step (read where `mega_step` is
called) and the source index each slot got when the buffer was filled;
it works out every experience, the loss, the gradients, the optimizer
and the buffer's write-back itself. Numbers compared:
- `loss_gap`: the largest |loss - loss_ref| / loss_ref of the steps;
- `grad_gap`: the worst leaf's gap of the first gradient's norm as the
  optimizer took it (Adam's first moment after one step, over 1 - b1),
  against the larger of the leaf's reference norm and the median leaf's;
- `change_gap`: the same of the parameters' change over the steps, on
  the leaves whose first reference gradient is at least a thousandth of
  the median leaf's;
- `buffer_gap`: every slot the steps drew, as the buffer holds it after
  them: the largest ||row - row_ref|| / max(||row_ref||, the median
  slot's) of its wavefield, residual, hidden states, k^2 and source, and
  1 where its age differs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import counts, inputs
from .program import port_config
from .reference import train as ref
from .reference.physics import Operator
from .reference.unet import load_weights

def _port_name(path: str) -> str:
    return path.replace("[", ".").replace("]", "")


def seeded_weights(config: dict, seed: int, device) -> dict:
    """name -> tensor in the npz's layouts, of the trained npz's shapes:
    conv kernels Xavier-normal (gain 0.02), transposed-conv kernels and
    every bias uniform in +-1/sqrt(fan in), PReLU slopes 0.25."""
    m = config["model"]
    shapes = {k: v.shape for k, v in
              load_weights(config["weights"], m["depth"], m["state_depth"], "cpu").items()}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("act.a"):
            out[name] = torch.full(shape, 0.25, device=device)
        else:
            conv = name.rsplit(".", 1)[0]
            w = shapes[f"{conv}.w"]
            k = math.prod(w[:-2])
            fan_in = (w[-1] if conv.startswith("up.") else w[-2]) * k
            if name.endswith(".w") and not conv.startswith("up."):
                std = 0.02 * math.sqrt(2.0 / (w[-2] * k + w[-1] * k))
                out[name] = (std * normal[at:at + n]).reshape(shape)
            else:
                out[name] = (uniform[at:at + n] / math.sqrt(fan_in)).reshape(shape)
        at += n
    return out


def _nested(flat: dict) -> dict:
    """{'decode.0.c1.w': a, ...} -> {'decode': [{'c1': {'w': a}}], ...}."""
    tree: dict = {}
    for name, value in flat.items():
        node, keys = tree, name.split(".")
        for i, key in enumerate(keys[:-1]):
            nxt = keys[i + 1]
            if key.isdigit():
                continue
            default = [] if nxt.isdigit() else {}
            node = node.setdefault(key, default)
            if nxt.isdigit():
                while len(node) <= int(nxt):
                    node.append({})
                node = node[int(nxt)]
        node[keys[-1]] = value
    return tree


def circle_locations(n: int, pml: int) -> list:
    """The distinct integer points of the validation circle (720 angles),
    sorted: the random-source curriculum's locations."""
    half, radius = n // 2, n // 2 - pml - 2
    return sorted({(int(half + radius * np.cos(t)), int(half + radius * np.sin(t)))
                   for t in np.linspace(0, 2 * np.pi, 720, endpoint=False)})


class TrainCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from helmnet_tpu_torch.train.loop import Trainer
        from helmnet_tpu_torch.weights import from_jax_params

        self.config, self.traffic, self.device = config, traffic, device
        t = traffic
        cfg = port_config(config, traffic)
        cfg = cfg.replace(
            training=dataclasses.replace(
                cfg.training, buffer_size=t["buffer"], train_batch_size=t["batch"],
                unrolling_steps=t["unroll"], remat=t["remat"],
                learning_rate=t["learning_rate"], p_random_source=t["p_random_source"],
                adam_b1=t["adam_b1"], adam_b2=t["adam_b2"], weight_decay=t["weight_decay"],
                gradient_clip=t["gradient_clip"], loss_amplify=t["loss_amplify"]))
        self.weights = seeded_weights(config, seed, device)
        self.maps = inputs.ellipse_maps(inputs.rng_for(seed), t["maps_count"], t["grid"],
                                        device)
        self.maps_np = self.maps.cpu().numpy()
        params = from_jax_params(_nested({k: v.cpu().numpy() for k, v in self.weights.items()}),
                                 device=device)
        self.trainer = Trainer(cfg, params=params, device_buffer=True, device=device)
        # the draws (slots, fresh maps and sources, kept step) from the seed
        self.trainer.rng = inputs.rng_for(seed, 3)
        self.draws, self.fill = [], None
        self._capture()
        self.trainer.fill_buffer(self.maps_np)
        self.finite = []

    def _capture(self) -> None:
        """Keep the draws the reference takes: the fill's source indices,
        and each check step's slots, fresh maps, fresh sources and kept
        step."""
        tr = self.trainer
        init, mega = tr._init_dev_buffer, tr._mega_step

        def init_seen(op, src_pool, src_idx, sos_maps, ages):
            self.fill = src_idx.cpu()
            return init(op, src_pool, src_idx, sos_maps, ages)

        def mega_seen(buf, op, src_pool, sos_pool, slot_idx, fresh_idx, fresh_src_idx,
                      pick, maxiter):
            if len(self.draws) < self.traffic["check_steps"]:
                self.draws.append((slot_idx.tolist(), fresh_idx.tolist(),
                                   fresh_src_idx.tolist(), pick, maxiter))
            return mega(buf, op, src_pool, sos_pool, slot_idx, fresh_idx, fresh_src_idx,
                        pick, maxiter)

        tr._init_dev_buffer, tr._mega_step = init_seen, mega_seen

    @property
    def steps_per_unit(self) -> int:
        return max(self.traffic["maps_count"] // self.traffic["batch"], 1)

    @property
    def work_per_unit(self) -> float:
        return float(self.steps_per_unit * self.traffic["batch"] * self.traffic["unroll"])

    def warm_up(self) -> None:
        """The first steps, by the epochs' own call; kept for the check,
        with the rows they wrote to the buffer."""
        from helmnet_tpu_torch.models.hybridnet import iter_leaves

        tr = self.trainer
        leaves = [(_port_name(p), t) for p, t in iter_leaves(tr.params)]
        self.p0 = {n: t.detach().clone() for n, t in leaves}
        b1 = self.traffic["adam_b1"]
        self.losses = []
        for k in range(self.traffic["check_steps"]):
            self.losses.append(tr.device_step(self.traffic["check_maxiter"])["loss"])
            if k == 0:  # no moment where no optimizer step was taken
                self.first = {n: tr.optimizer.state.get(t, {}).get(
                    "exp_avg", torch.zeros_like(t)).clone() / (1 - b1) for n, t in leaves}
        self.p_end = {n: t.detach().clone() for n, t in leaves}
        self.losses = [float(x) for x in self.losses]
        drawn = sorted({i for d in self.draws for i in d[0]})
        at = torch.as_tensor(drawn, device=self.device)
        self.rows = (drawn, {k: v[at].cpu() for k, v in tr._dev_buf.items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def checked_work(self) -> None:
        """The work a check reads, alone: the first steps."""
        self.warm_up()

    def unit(self, i: int) -> None:
        stats = self.trainer.training_epoch(self.maps_np)
        self.finite.append(math.isfinite(stats["train_loss_mean"]))

    def failed(self) -> int:
        return sum(not f for f in self.finite)

    def free(self) -> None:
        self.trainer = None

    def layer_counts(self, units: int) -> dict:
        c, t = self.config, self.traffic
        m = c["model"]
        tree = counts.shape_tree(load_weights(c["weights"], m["depth"], m["state_depth"],
                                              "cpu"), m["depth"], m["state_depth"])
        n = t["grid"]
        # forward and backward (three convs' work a conv), remat's recompute
        # not counted; the fft operator as 5 N log2 N a complex transform,
        # three along each axis, forward and backward
        per_map = 3 * (counts.conv_flops(tree, m["depth"], n, 2)
                       + 2 * 3 * 5 * n * n * math.log2(n))
        steps = units * self.steps_per_unit
        return {"train_steps": steps, "flops": steps * t["batch"] * t["unroll"] * per_map,
                "peak": counts.PEAKS[c["peak"]], "bounds": {}}

    # -- correctness --------------------------------------------------------

    def check(self, seed: int, precision: dict, control=None) -> dict:
        c, t = self.config, self.traffic
        m, g = c["model"], c["geometry"]
        n = t["grid"]
        op = Operator((n, n), g["pml_size"], g["sigma_max"],
                      c["source"]["omega"] / c["medium"]["c0"], self.device)
        locs = [tuple(t["source_location"])]
        if t["p_random_source"] > 0:
            locs += circle_locations(n, g["pml_size"])
        s = c["source"]

        def rows(maps: list, sources: list) -> dict:
            src = torch.stack([inputs.point_source(op.shape, locs[i], s["amplitude"],
                                                   s["phase"], self.device) for i in sources])
            return ref.fresh_rows(op, self.maps[maps], src, omega=s["omega"],
                                  state_channels=m["state_channels"],
                                  state_depth=m["state_depth"])

        # slot i was filled with map i mod the maps' count, its drawn source
        # and age 10 i
        start = lambda slots: (rows([i % t["maps_count"] for i in slots],
                                    [int(self.fill[i]) for i in slots]),
                               [10 * i for i in slots])
        model = {"depth": m["depth"], "state_depth": m["state_depth"],
                 "state_channels": m["state_channels"],
                 "resample": {"pad": m["resample_padding"]}}
        adam = lambda: ref.Adam(t["learning_rate"], t["adam_b1"], t["adam_b2"],
                                t["adam_eps"], t["weight_decay"], t["gradient_clip"])
        run = lambda p: ref.train_steps(self.weights, model, op, self.draws, start=start,
                                        fresh=rows, unroll=t["unroll"],
                                        amplify=t["loss_amplify"], precision=p, adam=adam(),
                                        block=t["reference_block"])
        want = run(precision)
        if control is None:
            got_losses, got_first = self.losses, self.first
            got_change = {k: self.p_end[k] - self.p0[k] for k in self.p0}
            drawn, buf = self.rows
            got_rows = {i: {k: v[j] for k, v in buf.items()} for j, i in enumerate(drawn)}
        else:
            other = run(control)
            got_losses, got_first = other["losses"], other["first_grad"]
            got_change = {k: other["params"][k] - self.weights[k] for k in self.weights}
            got_rows = {i: _as_buffer_row(r) for i, r in other["slots"].items()}
        first_norm = {k: float(v.norm()) for k, v in want["first_grad"].items()}
        median = float(np.median(list(first_norm.values())))
        change = {k: float((want["params"][k] - self.weights[k]).norm()) for k in self.weights}
        median_change = float(np.median(list(change.values())))
        return {
            "loss_gap": max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                            for a, b in zip(got_losses, want["losses"])),
            "grad_gap": max(ref.leaf_gap(float(got_first[k].norm()), first_norm[k], median)
                            for k in first_norm),
            "change_gap": max(ref.leaf_gap(float(got_change[k].norm()), change[k],
                                           median_change)
                              for k in change if first_norm[k] >= 1e-3 * median),
            "buffer_gap": buffer_gap(got_rows, {i: _as_buffer_row(r)
                                                for i, r in want["slots"].items()}),
        }


def _as_buffer_row(row: dict) -> dict:
    """A reference row in the program's buffer layout: wavefield [H, W, 2],
    states [C, sum of the levels' h w], k_sq [H, W], residual, source,
    iteration (the age)."""
    return {"wavefield": row["wavefield"][0], "residual": row["residual"][0],
            "states": torch.cat([x.flatten(2) for x in row["states"]], 2)[0],
            "k_sq": row["k_sq"][0], "source": row["source"][0],
            "iteration": torch.tensor(row["age"])}


def buffer_gap(got: dict, want: dict) -> float:
    """The worst slot and field of `got` against `want` ({slot: row}):
    ||row - row_ref|| / max(||row_ref||, the median slot's ||row_ref||),
    and 1 where a slot's age differs."""
    if set(got) != set(want):
        return math.inf
    worst = 0.0
    for field in ("wavefield", "residual", "states", "k_sq", "source"):
        norms = {i: float(r[field].norm()) for i, r in want.items()}
        scale = max(float(np.median(list(norms.values()))), 1e-30)
        for i, r in want.items():
            g = got[i][field].to(r[field].device)
            gap = float((g - r[field]).norm()) / max(norms[i], scale)
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    if any(int(got[i]["iteration"]) != int(r["iteration"]) for i, r in want.items()):
        worst = max(worst, 1.0)
    return worst
