# coding=utf-8
"""Von-Mises plasticity: squash a block past yield, watch the permanent set.

The reference is purely hyperelastic (its entire material surface is the
Neo-Hookean energy/force pair, /root/reference/solver/explicit.py:23-28):
any deformation fully recovers.  With ``plastic_yield`` (multiplicative
von-Mises plasticity, fem_tpu/ops/inelastic.py) deviatoric strain beyond
the yield surface FLOWS into the per-element internal variable
``SimState.plastic_inv`` — release the load and the body keeps a
volume-preserving permanent set (squat AND widened).

The inelastic stress runs as *material layers* on every path — this demo
uses the implicit CG path, whose operator composes the dynamic effective
rest-edge inverse ``ref_inv·F_p⁻¹`` per element.

Two runs, same kinematic squash to 60% height:
  * elastic  (plastic_yield = 0):  recovers to ~100% of rest height
  * plastic  (plastic_yield = .05): stays squat, widened, at full volume

Run: python examples/plasticity_demo.py
"""

import os

import numpy as np

from fem_tpu.api import Simulation

FAST = os.environ.get("FEM_TPU_EXAMPLE_FAST") == "1"

BASE = {
    "dim": 2,
    "delta_time": 1e-4,
    "sim_count": 10,
    "use_explicit_method": False,
    "implicit_method": 1,
    "preconditioned": 0,
    "g_dir": [0.0, 0.0],
    "objects": [
        {
            "center": [0.5, 0.5],
            "E": 4e4,
            "nu": 0.25,
            "damping": 80.0,
            "side_length": 0.2,
            "subdivisions": 4 if FAST else 8,
        }
    ],
    "blocks": [],
}


def run(plastic_yield: float) -> dict:
    import jax.numpy as jnp

    from fem_tpu.ops.inelastic import advance_internal

    spec = dict(BASE)
    spec["objects"] = [dict(BASE["objects"][0], plastic_yield=plastic_yield)]
    sim = Simulation.from_dict(spec)
    body = sim.scene[0]
    rest = np.asarray(body.state.pos)
    rest_h = rest[:, 1].max() - rest[:, 1].min()
    rest_w = rest[:, 0].max() - rest[:, 0].min()

    # Kinematic squash to 60% height, then one internal-variable update at
    # the held configuration (the return map is rate-independent).
    squash = rest.copy()
    squash[:, 1] = squash[:, 1].min() + 0.6 * (
        squash[:, 1] - squash[:, 1].min()
    )
    body.state = body.state.replace(pos=jnp.asarray(squash.astype(np.float32)))
    if plastic_yield > 0.0:
        body.state = advance_internal(
            body.obj, body.state, spec["delta_time"]
        )

    # Release: heavily damped free relaxation.
    sim.run(frames=15 if FAST else 60)
    p = np.asarray(body.state.pos)
    assert np.isfinite(p).all()
    return {
        "height_pct": 100.0 * (p[:, 1].max() - p[:, 1].min()) / rest_h,
        "width_pct": 100.0 * (p[:, 0].max() - p[:, 0].min()) / rest_w,
    }


def main():
    elastic = run(0.0)
    plastic = run(0.05)
    print(f"elastic release:  height {elastic['height_pct']:.1f}% of rest, "
          f"width {elastic['width_pct']:.1f}%")
    print(f"plastic release:  height {plastic['height_pct']:.1f}% of rest, "
          f"width {plastic['width_pct']:.1f}%  <- permanent set")
    assert plastic["height_pct"] < elastic["height_pct"] - 3.0
    assert plastic["width_pct"] > elastic["width_pct"] + 3.0


if __name__ == "__main__":
    main()
