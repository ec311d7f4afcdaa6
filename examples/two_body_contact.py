# coding=utf-8
"""Two-body collision with penalty contact (round-4 extension).

The reference's bodies never interact — its main loop steps each object
independently (reference main.py:59-61), so stacked bodies interpenetrate.
With ``contact: "penalty"`` all bodies advance jointly, coupled by
particle-particle penalty forces every substep (fem_tpu/contact.py —
Newton's-third-law exact, momentum conserving; one matrix product per body
pair).

Run:  python examples/two_body_contact.py
Writes /tmp/fem_two_body_contact.gif (a soft square dropped onto a stiffer
one resting on the floor — they stack instead of merging).
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import fem_tpu

FAST = bool(os.environ.get("FEM_TPU_EXAMPLE_FAST"))

sim = fem_tpu.Simulation.from_dict(
    {
        "dim": 2,
        "delta_time": 5e-4,
        "sim_count": 10,
        "auto_diff": False,
        "use_explicit_method": True,
        "g_dir": [0, -1],
        "contact": "penalty",
        "objects": [
            {"id": 0, "rho": 1000, "center": [0.5, 0.2], "side_length": 0.2,
             "subdivisions": 8, "E": 8e4, "nu": 0.3, "damping": 10.0},
            {"id": 1, "rho": 500, "center": [0.55, 0.6], "side_length": 0.16,
             "subdivisions": 7, "E": 3e4, "nu": 0.25, "damping": 10.0},
        ],
    }
)

frames = []
n_frames = 12 if FAST else 240
capture_every = 4
for i in range(n_frames):
    sim.step_frame()
    if i % capture_every == 0:
        frames.append(sim.render())

for i in range(2):
    assert np.isfinite(sim.positions(i)).all()

# The upper body must rest ON the lower one, not inside it.
top_of_lower = sim.positions(0)[:, 1].max()
bottom_of_upper = sim.positions(1)[:, 1].min()
print(
    f"bodies stacked: lower top y={top_of_lower:.3f}, "
    f"upper bottom y={bottom_of_upper:.3f} "
    f"(overlap {top_of_lower - bottom_of_upper:+.4f})"
)

out = "/tmp/fem_two_body_contact.gif"
if not FAST:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        out, save_all=True, append_images=imgs[1:], duration=66, loop=0
    )
    print(f"wrote {out}")
print("two_body_contact OK")
