"""Shared inputs of the classical-solver parity tests
(tests/test_torch_{classical,fgmres,twolevel,deflation,hybrid,
variable_source,solve_cli}.py): configs, problems and weights made the
same way for the JAX package and the port, from seeds, with numpy."""

import os

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.core import config as jconf
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu_torch.core import config as tconf
from helmnet_tpu_torch.weights import from_jax_params, load_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R2C_NPZ = os.path.join(ROOT, "trained_models", "tpu_r2c_best.npz")
R2C_ORBAX = os.path.join(ROOT, "checkpoints", "tpu_r2c")
N, PML = 32, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Imported by each test module: its shapes are small, one intra-op
    thread is faster than a pool, and a pool per test worker oversubscribes
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(n=N, pml=PML, omega=1.0, **model_kw):
    """(JAX Config, port Config) of an n^2 problem; `model_kw` goes to
    both ModelConfigs."""
    def make(mod):
        return mod.Config(
            max_iterations=50,
            geometry=mod.GeometryConfig(domain_size=n, pml_size=pml, sigma_max=2.0),
            model=mod.ModelConfig(**model_kw),
            source=mod.SourceConfig(amplitude=10.0, location=(n - 8, n // 2),
                                    omega=omega),
        )

    return make(jconf), make(tconf)


def heterogeneous(n=N, seed=3, sos_base=1.0):
    """tests/test_twolevel.py's problem: a random block of sound speed and
    a line source, as numpy (sos [n, n], source [n, n, 2])."""
    rng = np.random.default_rng(seed)
    sos = sos_base * np.ones((n, n), np.float32)
    r0, r1, c0, c1 = n // 3, 2 * n // 3, n // 4, 3 * n // 4
    sos[r0:r1, c0:c1] = sos_base + rng.random((r1 - r0, c1 - c0)).astype(np.float32)
    src = np.zeros((n, n, 2), np.float32)
    src[2 * n // 3, n // 4: 3 * n // 4, 0] = 10.0
    return sos, src


def r2c_params(jcfg, tcfg):
    """The tpu_r2c weights for both packages: JAX's tree read the way its
    `load_params_npz` reads it (without the op-by-op init), and the
    port's `load_params_npz`."""
    shapes = jax.eval_shape(lambda k: jh.init_params(k, jcfg.model),
                            jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shapes)
    with np.load(R2C_NPZ) as f:
        leaves = [f[f"p{i}"] for i in range(treedef.num_leaves)]
    return (jax.tree_util.tree_unflatten(treedef, leaves),
            load_params_npz(R2C_NPZ, tcfg, device="cpu"))


def random_params(jcfg, seed=0):
    """Random weights from JAX's init, and the same weights in the port."""
    params = jh.init_params(jax.random.PRNGKey(seed), jcfg.model)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, from_jax_params(tree, device="cpu")


def as_complex(pair) -> np.ndarray:
    pair = np.asarray(pair, np.float64)
    return pair[..., 0] + 1j * pair[..., 1]
