# coding=utf-8
"""High-level Simulation API, linear material, PD probe."""

import numpy as np

import fem_tpu
from fem_tpu.ops.element import energy_density
import jax.numpy as jnp


def _cfg_dict(**over):
    d = {
        "dim": 2,
        "delta_time": 5e-4,
        "sim_count": 2,
        "auto_diff": True,
        "use_explicit_method": True,
        "g_dir": [0, -1],
        "objects": [
            {"rho": 500, "center": [0.5, 0.8], "side_length": 0.2,
             "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5}
        ],
        "blocks": [{"block_center": [0.5, 0.4], "block_radius": 0.15}],
    }
    d.update(over)
    return d


def test_simulation_lifecycle(tmp_path):
    sim = fem_tpu.Simulation.from_dict(_cfg_dict())
    assert "Simulation" in repr(sim)
    y0 = sim.positions()[:, 1].mean()
    sim.run(frames=10, nan_guard=True)
    assert sim.frame_count == 10
    assert abs(sim.virtual_time - 10 * 2 * 5e-4) < 1e-9
    assert sim.positions()[:, 1].mean() < y0  # fell

    m = sim.metrics()
    assert not m.any_nan

    frame = sim.render()
    assert frame.shape == (640, 640, 3)

    ckpt = str(tmp_path / "s.npz")
    sim.save_checkpoint(ckpt)
    sim2 = fem_tpu.Simulation.from_dict(_cfg_dict())
    sim2.load_checkpoint(ckpt)
    np.testing.assert_allclose(sim2.positions(), sim.positions())
    assert sim2.frame_count == 10


def test_linear_material():
    f_id = jnp.broadcast_to(jnp.eye(2), (3, 2, 2))
    phi = energy_density(f_id, 1e4, 1e4, material="linear")
    np.testing.assert_allclose(np.asarray(phi), 0.0, atol=1e-6)
    # Pure rotation has nonzero linear-elastic energy (the known small-strain
    # artifact) while StVK is rotation-invariant — checks the formulas differ.
    c, s = np.cos(0.3), np.sin(0.3)
    rot = jnp.asarray(np.array([[[c, -s], [s, c]]], np.float32))
    phi_lin = float(energy_density(rot, 1e4, 1e4, material="linear")[0])
    phi_stvk = float(energy_density(rot, 1e4, 1e4, material="stvk")[0])
    assert phi_lin > 1.0
    assert abs(phi_stvk) < 1e-2


def test_linear_material_simulation():
    sim = fem_tpu.Simulation.from_dict(
        _cfg_dict(objects=[
            {"rho": 500, "center": [0.5, 0.8], "side_length": 0.2,
             "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5,
             "material": "linear"}
        ])
    )
    sim.run(frames=5, nan_guard=True)


def test_leading_principal_minors():
    from fem_tpu.solvers.diagnostics import leading_principal_minors

    spd = np.array([[2.0, 1.0], [1.0, 2.0]])
    assert (leading_principal_minors(spd) > 0).all()
    indef = np.array([[0.0, 1.0], [1.0, 0.0]])
    assert (leading_principal_minors(indef) <= 0).any()


def test_simulation_sharded_matches_single_device():
    """Simulation(sharded=True) — the high-level multi-chip entry — runs
    each frame under shard_map over all devices (8 virtual CPU devices via
    conftest) and matches the single-device trajectory."""
    import jax

    assert len(jax.devices()) >= 2  # conftest forces the 8-device CPU mesh
    # Implicit CG exercises the element-sharded operator path.
    cfg = _cfg_dict(
        auto_diff=False, use_explicit_method=False, implicit_method=1,
        preconditioned=1,
    )
    ref = fem_tpu.Simulation.from_dict(cfg)
    ref.run(frames=4, nan_guard=True)
    shd = fem_tpu.Simulation.from_dict(cfg, sharded=True)
    shd.run(frames=4, nan_guard=True)
    np.testing.assert_allclose(
        shd.positions(), ref.positions(), rtol=1e-5, atol=1e-6
    )


def test_api_buckling_and_harmonic():
    """Simulation.buckling / Simulation.harmonic smoke (extensions:
    solvers/buckling.py, solvers/harmonic.py)."""
    sim = fem_tpu.Simulation.from_dict(
        _cfg_dict(
            objects=[{
                "rho": 500, "center": [0.5, 0.5], "side_length": 0.2,
                "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5,
                "pin_boxes": [[[0.0, 0.695], [1.0, 1.0]]],
            }],
            blocks=[],
        )
    )
    pos = sim.positions()
    bottom = np.where(pos[:, 1] < pos[:, 1].min() + 1e-6)[0]
    f = np.zeros_like(pos)
    f[bottom, 1] = 0.4 / len(bottom)  # push the hanging edge UP = compression
    res = sim.buckling(k=2, f_ext=f, rounds=12)
    lam = np.asarray(res.load_factors)
    assert lam.shape == (2,) and np.all(np.isfinite(lam)) and lam[0] > 0

    freqs = np.linspace(5.0, 120.0, 8).astype(np.float32)
    h = sim.harmonic(f, freqs, k=4, beta=1e-4)
    assert h.amplitude.shape == (8,) + pos.shape
    assert np.all(np.isfinite(np.asarray(h.amplitude)))


def test_api_response_spectrum():
    """Simulation.response_spectrum smoke (extension: solvers/spectrum.py):
    combined peak is finite, non-negative, zero at pinned vertices, and the
    abssum combination bounds srss and cqc."""
    sim = fem_tpu.Simulation.from_dict(
        _cfg_dict(
            objects=[{
                "rho": 500, "center": [0.5, 0.5], "side_length": 0.2,
                "subdivisions": 4, "E": 4e4, "nu": 0.2, "damping": 14.5,
                "pin_boxes": [[[0.0, 0.695], [1.0, 1.0]]],
            }],
            blocks=[],
        )
    )
    dt = 2e-3
    t = np.arange(int(3.0 / dt)) * dt
    accel = (2.0 * np.sin(60.0 * t) + np.sin(150.0 * t)).astype(np.float32)
    modal = sim.modes(k=4)
    peaks = {}
    for comb in ("srss", "cqc", "abssum"):
        res = sim.response_spectrum(
            accel, dt, (1.0, 0.0), combination=comb, modal=modal
        )
        p = np.asarray(res.peak)
        assert p.shape == sim.positions().shape
        assert np.all(np.isfinite(p)) and np.all(p >= 0)
        peaks[comb] = p
    pos = sim.positions()
    pinned = pos[:, 1] > 0.695
    assert np.abs(peaks["cqc"][pinned]).max() < 1e-12
    assert peaks["cqc"][~pinned].max() > 0
    tiny = 1e-6 * peaks["abssum"].max()
    assert (peaks["srss"] <= peaks["abssum"] * (1 + 1e-3) + tiny).all()
    assert (peaks["cqc"] <= peaks["abssum"] * (1 + 1e-3) + tiny).all()
