"""The system under test: the entries of `helmnet_tpu_torch` that a cell's
window drives, one class a traffic `entry`.

Each takes the configuration and traffic files' dicts and the device,
builds the program's own objects once (weights read by the program from
the same npz the reference reads), and `run(sos)` makes one solve of a
whole batch, returning its last wavefield [B, *grid, 2] and its rmse
history [iterations, B]. Nothing here imports the program at module
import: `portbench.run` imports it after its checks.
"""

from __future__ import annotations

import dataclasses


def port_config(config: dict, traffic: dict):
    """The program's `Config` for a configuration at a traffic's grid."""
    from helmnet_tpu_torch.core.config import (Config, GeometryConfig, MediumConfig,
                                               ModelConfig, SourceConfig)

    m, g, s = config["model"], config["geometry"], config["source"]
    loc = tuple(traffic["source_location"])
    return Config(
        geometry=GeometryConfig(domain_size=traffic["grid"], pml_size=g["pml_size"],
                                sigma_max=g["sigma_max"]),
        medium=MediumConfig(c0=config["medium"]["c0"]),
        model=ModelConfig(
            architecture=m["architecture"], activation_function=m["activation"],
            features=m["features"], depth=m["depth"], state_depth=m["state_depth"],
            state_channels=m["state_channels"], in_channels=m["in_channels"],
            precision=m["precision"], up_mode=m["up_mode"],
            double_conv_mode=m["double_conv_mode"]),
        source=SourceConfig(amplitude=s["amplitude"], location=loc[:2], omega=s["omega"],
                            phase=s["phase"]),
        operator_mode=config["operator_mode"],
    )


class Solve2D:
    """`IterativeSolver.forward` (source normalisation and best iterate on,
    as the CLIs run it); the last wavefield is `final_wavefield`."""

    def __init__(self, config: dict, traffic: dict, source, device):
        from helmnet_tpu_torch.solvers.iterative import IterativeSolver

        self.cfg = port_config(config, traffic)
        self.solver = IterativeSolver.from_params_npz(config["weights"], self.cfg,
                                                      device=device)
        self.solver.set_source_maps(source)
        self.iterations = traffic["iterations"]

    def run(self, sos, iterations=None):
        out = self.solver.forward(sos, num_iterations=iterations or self.iterations)
        return out["final_wavefield"], out["rmse"]


class Solve3D:
    """`IterativeSolver3D.forward` (best iterate on); the last wavefield is
    `final_wavefield`."""

    def __init__(self, config: dict, traffic: dict, source, device):
        from helmnet_tpu_torch.solvers.iterative3d import IterativeSolver3D

        cfg = port_config(config, traffic)
        self.solver = IterativeSolver3D.from_params_npz(config["weights"], cfg,
                                                        device=device)
        self.solver.set_source_maps(source)
        self.iterations = traffic["iterations"]

    def run(self, sos, iterations=None):
        out = self.solver.forward(sos, num_iterations=iterations or self.iterations)
        return out["final_wavefield"], out["rmse"]


ENTRIES = {"solve2d": Solve2D, "solve3d": Solve3D}


def model_namespace(config: dict):
    """The model fields that `counts.step_calls` reads."""
    m = config["model"]
    fields = ("features", "state_channels", "depth", "in_channels")
    return dataclasses.make_dataclass("Model", fields)(*(m[f] for f in fields))
