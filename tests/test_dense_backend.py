# coding=utf-8
"""Dense backend vs matrix-free: identical operator, identical solves."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import dense_system_matrix
from fem_tpu.ops.element import hessian_blocks
from fem_tpu.solvers.dense import (
    assemble_dense_system,
    implicit_velocity_solve_dense,
)
from fem_tpu.solvers.implicit import implicit_velocity_solve
from tests.utils import make_2d_object, two_tet_object

DT = 5e-4


def _perturbed(state, scale, seed=9):
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=scale, size=state.pos.shape).astype(np.float32)
    vel = rng.normal(scale=0.1, size=state.pos.shape).astype(np.float32)
    return state.replace(
        pos=state.pos + jnp.asarray(noise), vel=jnp.asarray(vel)
    )


def test_dense_assembly_matches_numpy_dense():
    for maker, scale in ((make_2d_object, 0.004), (two_tet_object, 0.03)):
        cfg, obj, state = maker()
        state = _perturbed(state, scale)
        K = hessian_blocks(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda,
        )
        a_jax = np.asarray(assemble_dense_system(obj, K, DT))
        a_np = dense_system_matrix(obj, state, DT)
        np.testing.assert_allclose(a_jax, a_np, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "method,precond",
    [(1, 1), (1, 0), (0, 0)],
    ids=["cg-precond", "cg-plain", "jacobi"],
)
def test_dense_solve_matches_matrix_free(method, precond):
    cfg, obj, state = make_2d_object(subdivisions=4)
    state = _perturbed(state, 0.003)
    s_mf, aux_mf = implicit_velocity_solve(obj, state, DT, method, precond)
    s_d, aux_d = implicit_velocity_solve_dense(obj, state, DT, method, precond)
    np.testing.assert_allclose(
        np.asarray(s_d.vel), np.asarray(s_mf.vel), rtol=1e-3, atol=1e-5
    )
