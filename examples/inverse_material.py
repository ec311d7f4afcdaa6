# coding=utf-8
"""Inverse material estimation: recover Young's modulus from a trajectory.

A capability with no reference counterpart: the reference's only
autodiff is Taichi's per-substep force tape (main.py:107) — it cannot
differentiate THROUGH time.  Here the whole rollout is one pure JAX function
(fem_tpu/diff.py), so ``jax.grad`` flows from a trajectory-mismatch loss back
to the material parameters: simulate a "ground truth" body at E*, observe
only its positions, and recover E by gradient descent from a 2× wrong guess.

The implicit variant differentiates through the backward-Euler linear solve
via ``lax.custom_linear_solve`` (implicit-function-theorem adjoint — one
adjoint CG per substep, O(1) memory in solver iterations).

Run:  python examples/inverse_material.py [--implicit]
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import time

import jax
import jax.numpy as jnp
import optax

from fem_tpu.diff import DiffParams, lame_from_young, make_diff_rollout_fn
from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.utils.config import ObjectConfig, SimConfig

IMPLICIT = "--implicit" in sys.argv
# The smoke test sets FEM_TPU_EXAMPLE_FAST=1 — same code path, fewer
# substeps/descent iterations (too few to converge; it checks the machinery).
FAST = os.environ.get("FEM_TPU_EXAMPLE_FAST") == "1"

E_TRUE, NU = 4.0e4, 0.2
E_GUESS = 2.0e4  # start at half the true stiffness
N_SUBSTEPS = 6 if FAST else (25 if not IMPLICIT else 15)
N_ITERS = 3 if FAST else 60

ocfg = ObjectConfig(center=(0.5, 0.8), side_length=0.2, subdivisions=6,
                    E=E_TRUE, nu=NU)
cfg = SimConfig(
    dim=2,
    auto_diff=False,
    use_explicit_method=not IMPLICIT,
    implicit_method=1,
    preconditioned=1,
    objects=(ocfg,),
    blocks=(),
)
vertices, faces, elements = construct_2d_mesh(ocfg)
obj, state = build_object(ocfg, vertices, faces, elements)
obstacles = Obstacles.from_configs((), 2)

# Deform the body 25%/10% about its centroid — a rest-pose body in free fall
# exerts no elastic force, so the trajectory would carry no stiffness signal.
c = state.pos.mean(axis=0, keepdims=True)
state = state.replace(pos=c + (state.pos - c) * jnp.asarray([[1.25, 1.1]]))

rollout = make_diff_rollout_fn(obj, cfg, N_SUBSTEPS, n_cg_iters=48)


def trajectory(log_e):
    mu, lam = lame_from_young(jnp.exp(log_e), NU)
    _, traj = rollout(
        DiffParams(mu, lam, jnp.float32(obj.damping)), state, obstacles
    )
    return traj


target = trajectory(jnp.log(jnp.float32(E_TRUE)))  # "observed" positions


@jax.jit
def loss_and_grad(log_e):
    return jax.value_and_grad(
        lambda le: jnp.mean((trajectory(le) - target) ** 2) * 1e6
    )(log_e)


opt = optax.adam(0.1)
log_e = jnp.log(jnp.float32(E_GUESS))
opt_state = opt.init(log_e)

print(f"{'implicit' if IMPLICIT else 'explicit'} rollout, "
      f"{N_SUBSTEPS} substeps, {obj.element_cnt} elements")
print(f"true E = {E_TRUE:.0f}, initial guess = {E_GUESS:.0f}")
t0 = time.perf_counter()
for i in range(N_ITERS):
    val, g = loss_and_grad(log_e)
    updates, opt_state = opt.update(g, opt_state)
    log_e = optax.apply_updates(log_e, updates)
    if i % 10 == 0:
        print(f"  iter {i:3d}  loss {float(val):10.4g}  "
              f"E {float(jnp.exp(log_e)):9.1f}")
e_rec = float(jnp.exp(log_e))
print(f"recovered E = {e_rec:.1f}  ({abs(e_rec - E_TRUE) / E_TRUE:.2%} error, "
      f"{time.perf_counter() - t0:.1f}s)")
