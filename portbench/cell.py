"""One cell of the benchmark: a configuration under a traffic mix.

`SolveCell` makes the inputs from the seed, builds the program's entry
(`program.ENTRIES[traffic["entry"]]`), runs whole solves of a batch as
the window's units, keeps a seeded few answers of every solve, and once
the window has closed compares a seeded sample of them with the plain
reference (`check`).

A solve's answers are its maps' last wavefields and rmse histories. Two
numbers are compared, each against its limit in `cells/<workload>.json`:
- `field_gap`: the largest ||u - u_ref|| / ||u_ref|| of a last wavefield;
- `rmse_gap`: the largest |rmse - rmse_ref| / rmse_ref over every
  iteration of every sampled map.
A sampled map whose answer is not finite in the program and in the
reference alike (a solve that diverges, as the trained 3D model does on
a few thick shells) agrees and is left out of both numbers; one that is
not finite in the program alone is a failed answer (`failed`), and one
not finite in the reference alone makes both numbers infinite.
"""

from __future__ import annotations

import numpy as np
import torch

from . import counts, inputs
from .program import ENTRIES, model_namespace
from .reference.physics import Operator
from .reference.solve import solve
from .reference.unet import load_weights

K1 = r"(?<![A-Za-z0-9_])double_conv_kernel"
MAPS = {"ellipses": inputs.ellipse_maps, "shells": inputs.shell_volumes}
MAX_UNITS = 1024  # kept-answer draws made before a window; more units reuse them


class SolveCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        n, nd = traffic["grid"], config["rank"]
        self.grid = (n,) * nd
        s = config["source"]
        self.source = inputs.point_source(self.grid, traffic["source_location"],
                                          s["amplitude"], s["phase"], device)
        rng = inputs.rng_for(seed)
        make = MAPS[traffic["maps"]]
        self.pool = [make(rng, traffic["batch"], n, device)
                     for _ in range(traffic["pool"])]
        # the answers kept of each solve, drawn before the window so that no
        # copy to the card waits on it
        keep = min(traffic["check_maps"], traffic["batch"])
        pick = inputs.rng_for(seed, 1)
        self.keep = torch.as_tensor(np.stack([
            pick.choice(traffic["batch"], keep, replace=False) for _ in range(MAX_UNITS)]),
            device=device)
        self.entry = ENTRIES[traffic["entry"]](config, traffic, self.source, device)
        self.kept = []  # (pool index, map indices, wavefields, rmse histories)
        self.failed_maps = 0  # sampled answers not finite in the program alone
        self.diverged_alike = 0  # sampled answers not finite in both

    @property
    def work_per_unit(self) -> float:
        t = self.traffic
        return float(t["batch"]) * t["grid"] ** self.config["rank"] * t["iterations"]

    def warm_up(self) -> None:
        """Every shape the window runs, on a short solve of a whole batch."""
        self.entry.run(self.pool[0], iterations=2)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self, i: int) -> None:
        p = i % len(self.pool)
        wf, hist = self.entry.run(self.pool[p])
        idx = self.keep[i % MAX_UNITS]
        self.kept.append((p, idx, wf.index_select(0, idx), hist.index_select(1, idx)))

    def checked_work(self) -> None:
        """The work a check reads, alone: one solve."""
        self.unit(0)

    def failed(self) -> int:
        """Answers that failed, known once `check` has run."""
        return self.failed_maps

    def free(self) -> None:
        """Drop the program's state (the kept answers stay)."""
        self.entry = None

    # -- the per-layer counts of traced units ------------------------------

    def layer_counts(self, units: int) -> dict:
        c, t = self.config, self.traffic
        m = c["model"]
        weights = load_weights(c["weights"], m["depth"], m["state_depth"], "cpu")
        tree = counts.shape_tree(weights, m["depth"], m["state_depth"])
        n, nd, b = t["grid"], c["rank"], t["batch"]
        per_map = counts.conv_flops(tree, m["depth"], n, nd) + counts.operator_flops(n, nd)
        steps = units * t["iterations"]
        out = {"steps": steps, "flops": steps * b * per_map,
               "peak": counts.PEAKS[c["peak"]], "bounds": {}}
        if nd == 2 and m["double_conv_mode"] == "pallas":
            out["bounds"] = {"k1": (K1, self._k1_bound(tree))}
        return out

    def _k1_bound(self, tree) -> float:
        """The bound, in seconds, of a step's 14 K1 calls."""
        t = self.traffic
        meta = lambda *shape: torch.empty(shape, device="meta")
        total = 0.0
        for _, p, n, chans in counts.step_calls(tree, model_namespace(self.config), t["grid"]):
            co = p["post"]["w"].shape[0] if "post" in p else p["c2"]["w"].shape[0]
            parts = [meta(t["batch"], n, n, c) for c in chans]
            _, ops_ms, bytes_ms, _ = counts.bound(p, parts, meta(t["batch"], n, n, co))
            total += max(ops_ms, bytes_ms) / 1e3
        return total

    # -- correctness --------------------------------------------------------

    def check(self, seed: int, precision: dict, control=None) -> dict:
        """The sampled answers against the reference computed in
        `precision`: {name: value}. With `control` (a precision), the
        answers are the reference's computed in it, put in the program's
        place."""
        t, c = self.traffic, self.config
        m = c["model"]
        pick = inputs.rng_for(seed, 2)
        rows = [(k, j) for k, kept in enumerate(self.kept) for j in range(len(kept[1]))]
        take = pick.choice(len(rows), min(t["check_maps"], len(rows)), replace=False)
        rows = [rows[i] for i in sorted(take)]
        weights = load_weights(c["weights"], m["depth"], m["state_depth"], self.device)
        op = Operator(self.grid, c["geometry"]["pml_size"], c["geometry"]["sigma_max"],
                      c["source"]["omega"] / c["medium"]["c0"], self.device)
        model = {"depth": m["depth"], "state_depth": m["state_depth"],
                 "state_channels": m["state_channels"],
                 "resample": {"pad": m["resample_padding"]}}
        field_gap = rmse_gap = 0.0
        self.failed_maps = self.diverged_alike = 0
        block = t["reference_block"]
        for start in range(0, len(rows), block):
            part = rows[start:start + block]
            sos = torch.stack([self.pool[self.kept[k][0]][self.kept[k][1][j]] for k, j in part])
            src = self.source[None].expand((len(part),) + tuple(self.source.shape))
            reference = lambda p: solve(
                weights, model, op, sos, src, iterations=t["iterations"],
                omega=c["source"]["omega"],
                amplitude=c["source"]["amplitude"] if c["normalize_source"] else None,
                precision=p)
            wf_ref, hist_ref = reference(precision)
            if control is None:
                wf = torch.stack([self.kept[k][2][j] for k, j in part])
                hist = torch.stack([self.kept[k][3][:, j] for k, j in part], dim=1)
            else:
                wf, hist = reference(control)
            bad, bad_ref = _diverged(wf, hist), _diverged(wf_ref, hist_ref)
            self.failed_maps += int((bad & ~bad_ref).sum())
            both = bad & bad_ref
            self.diverged_alike += int(both.sum())
            if bool(both.all()):
                continue
            keep = ~both
            wf, wf_ref = wf[keep], wf_ref[keep]
            hist, hist_ref = hist[:, keep], hist_ref[:, keep]
            gap = (wf - wf_ref).flatten(1).norm(dim=1) / wf_ref.flatten(1).norm(dim=1)
            field_gap = max(field_gap, _worst(gap))
            rmse_gap = max(rmse_gap, _worst((hist - hist_ref).abs() / hist_ref))
        return {"field_gap": field_gap, "rmse_gap": rmse_gap}


def _diverged(wf: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """[S] bool: the map's last wavefield or rmse history is not finite."""
    return ~(torch.isfinite(wf.flatten(1)).all(1) & torch.isfinite(hist).all(0))


def _worst(t: torch.Tensor) -> float:
    """The largest value, or inf where any is not finite."""
    return float(t.max()) if bool(torch.isfinite(t).all()) else float("inf")


def make_cell(config: dict, traffic: dict, seed: int, device):
    """The cell a traffic's entry runs: a training cell or a solve cell."""
    if traffic["entry"] == "train2d":
        from .train import TrainCell

        return TrainCell(config, traffic, seed, device)
    return SolveCell(config, traffic, seed, device)
