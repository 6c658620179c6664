"""Import of the reference PyTorch-Lightning checkpoint
(`trained_models/*.ckpt`), port of the importer half of
`helmnet_tpu/train/checkpoint.py` (:22-143).

The checkpoint stores tensors under names like
`f.enc.0.conv_signal.double_conv.0.weight`, already in the port's layouts
(OIHW convs, `[I, O, k, k]` transposed convs; models/blocks.py), so they
are taken as they are, with no round trip through the JAX package's HWIO.
Orbax checkpoint directories are not read here (ROADMAP Queue A item 3).
"""

from __future__ import annotations

import sys
import types
from typing import Any, Tuple

import torch

from ..core.config import Config, ModelConfig
from ..core.device import resolve_device


def _install_lightning_shim() -> None:
    """Make `pytorch_lightning.utilities.parsing.AttributeDict` importable
    for unpickling when lightning itself is not installed."""
    if "pytorch_lightning" in sys.modules:
        return
    try:
        import pytorch_lightning  # noqa: F401
        return
    except ImportError:
        pass
    m = types.ModuleType("pytorch_lightning")
    u = types.ModuleType("pytorch_lightning.utilities")
    p = types.ModuleType("pytorch_lightning.utilities.parsing")

    class AttributeDict(dict):
        def __getattr__(self, k):
            return self[k]

    p.AttributeDict = AttributeDict
    m.utilities = u
    u.parsing = p
    sys.modules["pytorch_lightning"] = m
    sys.modules["pytorch_lightning.utilities"] = u
    sys.modules["pytorch_lightning.utilities.parsing"] = p


def _load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """A lightning checkpoint's state_dict (f32 CPU tensors) and
    hyper_parameters."""
    _install_lightning_shim()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().to(torch.float32) for k, v in ckpt["state_dict"].items()}
    hparams = dict(ckpt.get("hyper_parameters", {}))
    return sd, hparams


def _conv(sd: dict, prefix: str) -> dict:
    return {"w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


def _double_conv(sd: dict, prefix: str) -> dict:
    out = {
        "c1": _conv(sd, f"{prefix}.double_conv.0"),
        "c2": _conv(sd, f"{prefix}.double_conv.2"),
    }
    # activation between the convs: PReLU stores a learnable slope at .1
    act_key = f"{prefix}.double_conv.1.weight"
    out["act"] = {"a": sd[act_key]} if act_key in sd else {}
    return out


def params_from_torch_state_dict(sd: dict, cfg: ModelConfig, device=None) -> dict:
    """Map the reference `f.*` tensors to the port's params tree."""
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "inc": _double_conv(sd, "f.inc"),
        "enc": [],
        "decode": [],
        "up": [],
        "outc": _conv(sd, "f.outc.conv"),
    }
    for d in range(cfg.depth):
        blk = {
            "conv_signal": _double_conv(sd, f"f.enc.{d}.conv_signal"),
            "down": _conv(sd, f"f.enc.{d}.down"),
        }
        if f"f.enc.{d}.conv_state.double_conv.0.weight" in sd:
            blk["conv_state"] = _double_conv(sd, f"f.enc.{d}.conv_state")
        params["enc"].append(blk)
    for i in range(cfg.depth + 1):
        params["decode"].append(_double_conv(sd, f"f.decode.{i}"))
    for d in range(cfg.depth):
        params["up"].append(_conv(sd, f"f.up.{d}"))

    from ..models.hybridnet import map_leaves

    return map_leaves(params, lambda _, t: t.contiguous().to(dev))


def load_reference_checkpoint(path: str, device=None) -> Tuple[dict, Config]:
    """Import the reference .ckpt -> (params, Config).

    As the reference's `load_from_checkpoint(strict=False)`: buffers that
    do not map (source, Lap.*) are ignored and rebuilt from the config."""
    sd, hp = _load_torch_state_dict(path)
    cfg = Config()
    cfg = cfg.replace(
        max_iterations=int(hp.get("max_iterations", cfg.max_iterations)),
        geometry=cfg.geometry.__class__(
            domain_size=int(hp.get("domain_size", 96)),
            pml_size=int(hp.get("PMLsize", 8)),
            sigma_max=float(hp.get("sigma_max", 2.0)),
        ),
        model=cfg.model.__class__(
            architecture=hp.get("architecture", "custom_unet"),
            activation_function=hp.get("activation_function", "prelu"),
            features=int(hp.get("features", 8)),
            depth=int(hp.get("depth", 4)),
            state_depth=int(hp.get("state_depth", 4)),
            state_channels=int(hp.get("state_channels", 2)),
        ),
        source=cfg.source.__class__(
            amplitude=float(hp.get("source_amplitude", 10.0)),
            location=tuple(hp.get("source_location", (82, 48))),
            omega=float(hp.get("omega", 1.0)),
            phase=float(hp.get("source_phase", 0.0)),
            smoothing=bool(hp.get("source_smoothing", False)),
        ),
    )
    params = params_from_torch_state_dict(sd, cfg.model, device=device)
    return params, cfg
