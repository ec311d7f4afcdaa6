# coding=utf-8
"""Batched ensemble example: 32 perturbed simulations in one device dispatch.

A capability with no reference counterpart — one mesh, B initial
conditions, all substeps compiled into a single program (see fem_tpu/batch.py).

Run:  python examples/ensemble_sweep.py
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import time

import numpy as np

from fem_tpu.batch import make_batched_frame_fn, perturb_states
from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.utils.config import BlockConfig, ObjectConfig, SimConfig

# The smoke test sets FEM_TPU_EXAMPLE_FAST=1 — same code path, smaller run.
FAST = os.environ.get("FEM_TPU_EXAMPLE_FAST") == "1"
B = 4 if FAST else 32
SECONDS = 0.1 if FAST else 2.0
ocfg = ObjectConfig(center=(0.5, 0.8), side_length=0.2, subdivisions=10)
cfg = SimConfig(
    dim=2, auto_diff=False, use_explicit_method=True, sim_count=10,
    objects=(ocfg,),
    blocks=(
        BlockConfig(block_center=(0.8, 0.5), block_radius=0.21),
        BlockConfig(block_center=(0.2, 0.5), block_radius=0.21),
    ),
)
vertices, faces, elements = construct_2d_mesh(ocfg)
obj, state = build_object(ocfg, vertices, faces, elements)
obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim)

frame_fn = make_batched_frame_fn(obj, cfg)
states = perturb_states(state, B, scale=1e-3)

# 2 virtual seconds for all B members; the timed region ends when the final
# state reaches the host.
n_frames = int(SECONDS / (cfg.sim_count * cfg.delta_time))
s, _ = frame_fn(states, obstacles)  # compile
_ = np.asarray(s.pos)
t0 = time.perf_counter()
for _ in range(n_frames):
    s, _ = frame_fn(s, obstacles)
pos = np.asarray(s.pos)  # (B, N, 2)
wall = time.perf_counter() - t0
com_y = pos[:, :, 1].mean(axis=1)
through = (com_y < 0.5).sum()
total_steps = B * n_frames * cfg.sim_count
print(
    f"{B} ensemble members, {n_frames * cfg.sim_count} substeps each "
    f"in {wall:.2f}s  ({total_steps / wall:.0f} body-substeps/s)"
)
print(
    f"members through the passage: {through}/{B}; "
    f"final COM height mean={com_y.mean():.3f} std={com_y.std():.4f}"
)
