# coding=utf-8
"""fem_tpu — a hyperelastic finite-element framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the Taichi-based
Jukgei/Finite-Element-Method reference (see SURVEY.md): 2D triangle / 3D
tetrahedral Neo-Hookean soft bodies, explicit integration (analytic forces or
``jax.grad`` of the elastic energy) and implicit integration solved matrix-free
by weighted Jacobi or (preconditioned) conjugate gradient.
"""

from fem_tpu.api import Simulation
from fem_tpu.diff import (
    DiffParams,
    lame_from_young,
    make_diff_rollout_fn,
    make_diff_substep_fn,
    params_from_object,
    trajectory_loss_fn,
)
from fem_tpu.models.state import FemObject, Obstacles, SimState, build_object
from fem_tpu.sim import make_frame_fn, make_substep_fn, substep
from fem_tpu.utils.config import (
    BlockConfig,
    ObjectConfig,
    SimConfig,
    parse_config,
    read_config,
)

__version__ = "0.1.0"

__all__ = [
    "Simulation",
    "DiffParams",
    "lame_from_young",
    "make_diff_rollout_fn",
    "make_diff_substep_fn",
    "params_from_object",
    "trajectory_loss_fn",
    "FemObject",
    "Obstacles",
    "SimState",
    "build_object",
    "make_frame_fn",
    "make_substep_fn",
    "substep",
    "BlockConfig",
    "ObjectConfig",
    "SimConfig",
    "parse_config",
    "read_config",
    "__version__",
]
