"""PyTorch and CUDA port of helmnet-tpu, for NVIDIA Hopper (H100).

A second package beside `helmnet_tpu/`, which stays the reference that
each module here is tested against. The layout mirrors it (`core/`,
`ops/`, `models/`, `solvers/`, `train/`, `eval/`, `cli/`), and the public
layout is the same: NHWC channel pairs `[B, H, W, 2]` for wavefields,
residuals and sources, and `[B, H, W]` for sound-speed maps (in 3D NDHWC
`[B, D, H, W, 2]` and `[B, D, H, W]`).

The port imports `torch` and numpy, never `jax` or `helmnet_tpu`. Entry
points put their tensors on `cuda` unless the caller passes
`device="cpu"`, and raise when no card is present and no device is given.
Importing the package initialises no CUDA context and builds no kernel:
the kernels are built at their first launch.

`__all__` holds the JAX package's public names, every one of them
ported, under the same names.
"""

__version__ = "0.1.0"

from .core.config import (  # noqa: F401
    Config,
    GeometryConfig,
    MediumConfig,
    ModelConfig,
    ParallelConfig,
    SourceConfig,
    TrainingConfig,
    load_settings,
)
from .core.meshes import make_mesh  # noqa: F401
from .core.sanitize import check_finite, checked, debug_nans  # noqa: F401
from .data.ellipses import make_dataset as make_ellipses_dataset  # noqa: F401
from .models import hybridnet, hybridnet3d, resnet  # noqa: F401
from .models.activations import get_activation  # noqa: F401
from .models.blocks import conv2d, conv_transpose2d, double_conv  # noqa: F401
from .models.convgru import convgru, init_convgru  # noqa: F401
from .models.registry import get_architecture  # noqa: F401
from .ops.source import point_source_map, source_batch_from_locations  # noqa: F401
from .ops.spectral import (  # noqa: F401
    SpectralPML,
    helmholtz_residual,
    laplacian,
    make_operator,
)
from .ops.spectral3d import (  # noqa: F401
    SpectralPML3D,
    helmholtz_residual3d,
    laplacian3d,
    make_operator3d,
    point_source_map3d,
)
from .ops.stencil import (  # noqa: F401
    StencilPML,
    helmholtz_residual_stencil,
    make_stencil_operator,
)
from .solvers.gmres import (  # noqa: F401
    solve_helmholtz,
    solve_helmholtz_batch,
    solve_helmholtz_checked,
    solve_helmholtz_chunked,
)
from .solvers.auto import (  # noqa: F401
    SolverPlan,
    choose_solver,
    solve_auto,
)
from .solvers.fgmres import solve_fgmres, solve_fgmres_learned  # noqa: F401
from .solvers.twolevel import (  # noqa: F401
    solve_fgmres_multilevel,
    solve_fgmres_two_level,
)
from .solvers.deflation import (  # noqa: F401
    gmres_deflated,
    solve_helmholtz_deflated,
)
from .solvers.hybrid import solve_hybrid  # noqa: F401
from .serve import ServeConfig, SolverService  # noqa: F401
from .solvers.iterative import IterativeSolver, rollout  # noqa: F401
from .solvers.timedomain import solve_cw, solve_cw3d, solve_cw3d_chunked  # noqa: F401
from .solvers.helm3d import solve_helmholtz3d, solve_helmholtz3d_batch  # noqa: F401
from .solvers.iterative3d import IterativeSolver3D, rollout3d  # noqa: F401
from .solvers.twolevel3d import solve_fgmres_two_level3d  # noqa: F401
from .train.checkpoint import load_reference_checkpoint  # noqa: F401
from .train.loop import Trainer  # noqa: F401
from .train.replay import ExperienceBatch, ReplayBuffer  # noqa: F401

__all__ = [
    "Config",
    "GeometryConfig",
    "MediumConfig",
    "ModelConfig",
    "ParallelConfig",
    "SourceConfig",
    "TrainingConfig",
    "load_settings",
    "make_mesh",
    "checked",
    "check_finite",
    "debug_nans",
    "make_ellipses_dataset",
    "hybridnet",
    "resnet",
    "hybridnet3d",
    "get_activation",
    "get_architecture",
    "conv2d",
    "conv_transpose2d",
    "double_conv",
    "convgru",
    "init_convgru",
    "point_source_map",
    "source_batch_from_locations",
    "SpectralPML",
    "StencilPML",
    "laplacian",
    "helmholtz_residual",
    "helmholtz_residual_stencil",
    "make_operator",
    "make_stencil_operator",
    "SpectralPML3D",
    "laplacian3d",
    "helmholtz_residual3d",
    "make_operator3d",
    "point_source_map3d",
    "solve_helmholtz3d",
    "solve_helmholtz3d_batch",
    "solve_fgmres_two_level3d",
    "IterativeSolver3D",
    "rollout3d",
    "solve_cw3d",
    "solve_cw3d_chunked",
    "solve_helmholtz",
    "solve_helmholtz_checked",
    "solve_helmholtz_batch",
    "solve_helmholtz_chunked",
    "SolverPlan",
    "choose_solver",
    "solve_auto",
    "solve_fgmres",
    "solve_fgmres_learned",
    "solve_fgmres_multilevel",
    "solve_fgmres_two_level",
    "gmres_deflated",
    "solve_helmholtz_deflated",
    "solve_hybrid",
    "solve_cw",
    "IterativeSolver",
    "ServeConfig",
    "SolverService",
    "rollout",
    "Trainer",
    "ReplayBuffer",
    "ExperienceBatch",
    "load_reference_checkpoint",
]
