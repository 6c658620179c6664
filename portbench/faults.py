"""Faults planted in the program underneath a run, to see that `correct`
comes out false (`tests/test_portbench_faults.py`, on the CPU) and to
read a training cell's numbers under them on the card
(`python3 -m portbench.control --fault <name>`). Never used by a
benchmark run.

- `state_unchanged`: a step returns its state unchanged (a solver step
  its carry; a train step takes no optimizer step);
- `half_batch`: half of the batch is left out (a solve answers the rest
  with the first half's answers; a train step's loss is the mean over
  the first half);
- `answer_altered`: an answer altered where it is produced (a solve's
  last wavefield 5% off; a train step's loss 5% off);
- `not_written_back` (training): the device buffer keeps the rows a
  step drew as they were, instead of the step's evolved rows and fresh
  restarts.
"""

from __future__ import annotations

import contextlib

import torch

COMMON = ("state_unchanged", "half_batch", "answer_altered")
FAULTS = {"solve2d": COMMON, "solve3d": COMMON, "train2d": COMMON + ("not_written_back",)}


def _doubled(out: dict) -> dict:
    for key in ("final_wavefield", "wavefield", "rmse"):
        if key in out:
            out[key] = torch.cat([out[key]] * 2, dim=1 if key == "rmse" else 0)
    return out


def _patches(fault: str, entry: str) -> list:
    """(object, attribute, replacement) of the fault in the entry's path."""
    from helmnet_tpu_torch.solvers import iterative, iterative3d
    from helmnet_tpu_torch.train import loop
    from helmnet_tpu_torch.train.replay import ExperienceBatch

    if entry == "train2d":
        loss = loop.unrolled_loss
        if fault == "state_unchanged":
            return [(loop, "apply_gradients",
                     lambda optimizer, clip, check=None: torch.zeros(()))]
        if fault == "not_written_back":
            make = loop.make_device_buffer_fns

            def unwritten(*a, **kw):
                init, mega = make(*a, **kw)

                def step(buf, op, src_pool, sos_pool, slot_idx, *rest):
                    rows = {k: v[slot_idx].clone() for k, v in buf.items()}
                    metrics = mega(buf, op, src_pool, sos_pool, slot_idx, *rest)
                    for k, v in rows.items():
                        buf[k].index_copy_(0, slot_idx, v)
                    return metrics
                return init, step
            return [(loop, "make_device_buffer_fns", unwritten)]
        if fault == "half_batch":
            def half(params, op, batch, **kw):
                h = batch.wavefield.shape[0] // 2
                value, ys = loss(params, op, ExperienceBatch(
                    *(f[:h] for f in batch[:-1]), batch.indices[:h]), **kw)
                return value, {k: torch.cat([v, v], dim=1) for k, v in ys.items()}
            return [(loop, "unrolled_loss", half)]
        return [(loop, "unrolled_loss",
                 lambda *a, **kw: (lambda v, ys: (v * 1.05, ys))(*loss(*a, **kw)))]

    if fault == "state_unchanged":
        if entry == "solve3d":
            return [(iterative3d, "single_step3d", lambda *a, **kw: a[4])]
        return [(iterative, "single_step", lambda *a, **kw: a[4])]
    if fault == "half_batch":
        cls = iterative3d.IterativeSolver3D if entry == "solve3d" else iterative.IterativeSolver
        forward = cls.forward
        return [(cls, "forward", lambda self, sos, *a, **kw:
                 _doubled(forward(self, sos[: len(sos) // 2], *a, **kw)))]
    module, name = (iterative3d, "rollout3d") if entry == "solve3d" else (iterative, "rollout")
    fn = getattr(module, name)

    def altered(*a, **kw):
        out = fn(*a, **kw)
        out["wavefield"] = out["wavefield"] * 1.05
        return out
    return [(module, name, altered)]


@contextlib.contextmanager
def planted(fault: str, entry: str):
    """The program with `fault` planted in the path of the traffic entry
    `entry`, restored on exit."""
    if fault not in FAULTS[entry]:
        raise ValueError(f"unknown fault {fault!r} for {entry}; expected one of "
                         f"{FAULTS[entry]}")
    patches = _patches(fault, entry)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
