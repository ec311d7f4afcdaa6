#!/usr/bin/env python3
# coding=utf-8
"""Smoke test of the simulator's main path on one GPU.

Run from the root of a checkout::

    python3 chip_smoke.py           # phases (a)-(e) on one GPU
    python3 chip_smoke.py --four    # only the sharded path on 4 GPUs

Phases, all through the entry points a user calls:

  (a) ``main.run`` on the flagship ``configs/demo_spot.json`` (1,007
      particles, 4,068 tets, implicit CG with the parity default
      ``preconditioned=1``) for 120 frames — past the first floor contact at
      about frame 74 — with OBJ export; checks the final checkpointed state
      and prints CG iterations per substep;
  (b) ``main.run`` on the 2D explicit demo ``configs/default.json``;
  (c) ``fem_tpu.Simulation`` on the flagship mesh for explicit-analytic,
      autodiff and Jacobi, with ``sim.metrics()`` finite;
  (d) a structured Kuhn-grid body of more than 10⁵ tets under implicit CG,
      parity default and ``cg_precond="none"``, with peak device memory,
      and a few substeps compared with the same jitted code on the CPU;
  (e) parity: several substeps of every method on the flagship mesh
      against the float64 oracle ``tests/oracle.py``.

Every phase prints its compile seconds and its steady steps/s, timed with
``block_until_ready`` after warm-up.  Any failure ends the run with a
non-zero exit code.  The last line of standard output is one JSON object
naming the device; it is printed only when every phase passed.  The script
refuses to run when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_CONFIG = os.path.join("configs", "demo_spot.json")
DEMO_2D_CONFIG = os.path.join("configs", "default.json")

# The >10⁵-tet body: a 26³-cell Kuhn grid (6·26³ = 105,456 tets, 19,683
# particles) of the flagship's material, 0.3 m on a side.  At dt = 2.5e-4 it
# lands on the floor and settles under the reference semantics with every
# field finite (checked over 200 frames); a body started far from its rest
# shape (squashed 5 %) is not stable at this dt — the integrator's dt ~ h
# wall — so it starts at rest shape.
LARGE_SUBDIVISIONS = 26
LARGE_DT = 2.5e-4

# Positions must agree with the float64 oracle within the tolerances the
# CPU parity tests hold (tests/test_oracle_parity.py): f32 accumulation.
ORACLE_ATOL = {"explicit": 3e-4, "autodiff": 3e-4, "jacobi": 5e-4,
               "cg_precond1": 5e-4, "cg_precond0": 5e-4}

# The same jitted code on two devices differs in summation order (and the
# GPU's scatter-add uses atomics, whose order varies from run to run).  CG
# stops at the reference's absolute rᵀr ≤ 1e-5 — ‖r‖ ≤ 3.2e-3 — so two runs
# may stop at different iterates; the implicit system A = I + dt²M⁻¹K has
# ‖A⁻¹‖ ≤ 1, bounding the velocity difference per substep by ~2·3.2e-3, and
# positions move by dt times that.
DEVICE_VEL_ATOL = 1e-2
DEVICE_POS_ATOL = 2e-5


def card_line() -> str:
    """The card's name and power limit from nvidia-smi (a child process
    that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _say(msg: str) -> None:
    print(msg, flush=True)


def _finite_state(state) -> bool:
    import jax

    return all(
        bool(np.isfinite(np.asarray(x)).all())
        for x in jax.tree_util.tree_leaves(state)
    )


def _squashed(state, factors):
    """Deform a body about its centroid so its elastic forces are large and
    CG iterates from the first substep."""
    import jax.numpy as jnp

    c = state.pos.mean(axis=0, keepdims=True)
    f = jnp.asarray([factors[: state.pos.shape[1]]], state.pos.dtype)
    return state.replace(pos=c + (state.pos - c) * f)


def time_frames(frame_fn, state, obstacles, sim_count, warm=2, frames=5):
    """(state, compile seconds, steady steps/s, mean solver iterations per
    substep): the first call compiles; ``warm`` more frames run untimed;
    ``frames`` are timed between two ``block_until_ready`` calls."""
    import jax

    t0 = time.perf_counter()
    state, _ = frame_fn(state, obstacles)
    jax.block_until_ready(state)
    compile_s = time.perf_counter() - t0
    for _ in range(warm):
        state, _ = frame_fn(state, obstacles)
    jax.block_until_ready(state)
    iters = []
    t0 = time.perf_counter()
    for _ in range(frames):
        state, aux = frame_fn(state, obstacles)
        iters.append(aux.solver_iterations)
    jax.block_until_ready(state)
    rate = frames * sim_count / (time.perf_counter() - t0)
    mean_iters = float(np.mean([np.asarray(i) for i in iters]))
    return state, compile_s, rate, mean_iters


# ---------------------------------------------------------------------------
# (a), (b): the CLI
# ---------------------------------------------------------------------------

_SUMMARY = re.compile(
    r"(\d+) frames in [0-9.]+ s: first frame ([0-9.]+) s \(includes "
    r"compilation\)(?:, then ([0-9.]+) steps/s)?"
    r"(?:; solver iters/substep \(mean\): ([0-9.]+))?"
)


def phase_cli(config: str, frames: int, out_dir: str) -> dict:
    """Run ``main.run`` with rendering off, a checkpoint at the last frame
    and OBJ export as the config asks; check the checkpointed state and any
    exported OBJ are finite."""
    import main as cli
    from fem_tpu.utils import io as fio

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.run([
            "--config", config, "--no-render", "--frames", str(frames),
            "--output", out_dir, "--print-every", "0",
            "--checkpoint-every", str(frames),
        ])
    text = buf.getvalue()
    for line in text.splitlines():
        _say(f"    | {line}")
    if rc != 0:
        raise RuntimeError(f"main.run({config}) returned {rc}")
    m = _SUMMARY.search(text)
    if m is None:
        raise RuntimeError(f"main.run({config}) printed no run summary")
    states, step, _, _ = fio.load_scene_checkpoint(
        os.path.join(out_dir, f"ckpt_{frames:06}.npz")
    )
    if step != frames or not all(_finite_state(s) for s in states):
        raise RuntimeError(f"main.run({config}): non-finite final state")
    objs = sorted(glob.glob(os.path.join(out_dir, "obj_*.obj")))
    for path in objs[-1:]:
        with open(path) as fh:
            v = np.array(
                [ln.split()[1:4] for ln in fh if ln.startswith("v ")], float
            )
        if v.size == 0 or not np.isfinite(v).all():
            raise RuntimeError(f"non-finite or empty OBJ export {path}")
    return {
        "frames": int(m.group(1)),
        "compile_s": float(m.group(2)),
        "steps_per_s": float(m.group(3)) if m.group(3) else None,
        "iters_per_substep": float(m.group(4)) if m.group(4) else 0.0,
        "obj_files": len(objs),
    }


# ---------------------------------------------------------------------------
# (c): the library API
# ---------------------------------------------------------------------------

METHODS = {
    # Explicit integration on the flagship mesh needs the small dt its
    # element size allows; the implicit methods run the config's dt.
    "explicit": dict(use_explicit_method=True, auto_diff=False,
                     delta_time=1e-4),
    "autodiff": dict(use_explicit_method=True, auto_diff=True,
                     delta_time=1e-4),
    "jacobi": dict(use_explicit_method=False, auto_diff=False,
                   implicit_method=0),
}


def phase_simulation(config_data: dict, method: str, warm=2, frames=5):
    """``fem_tpu.Simulation`` on ``config_data`` with ``method``'s
    overrides: time its frames and check ``sim.metrics()``."""
    import jax

    import fem_tpu

    with contextlib.redirect_stdout(io.StringIO()):
        sim = fem_tpu.Simulation.from_dict(
            {**config_data, **METHODS[method]}
        )

    def frame_fn(state, obstacles):
        sim.scene[0].state = state
        sim.step_frame()
        return sim.scene[0].state, sim.last_aux

    _, compile_s, rate, iters = time_frames(
        frame_fn, sim.scene[0].state, sim.obstacles, sim.cfg.sim_count,
        warm=warm, frames=frames,
    )
    jax.block_until_ready(sim.scene[0].state)
    m = sim.metrics()
    if m.any_nan or not all(
        np.isfinite(x) for x in (m.elastic_energy, m.kinetic_energy,
                                 m.min_det_f, m.max_speed)
    ):
        raise RuntimeError(f"Simulation[{method}]: metrics not finite {m}")
    return {"compile_s": compile_s, "steps_per_s": rate,
            "iters_per_substep": iters, "metrics": m}


# ---------------------------------------------------------------------------
# (d): a body of more than 10⁵ tets
# ---------------------------------------------------------------------------

def large_body(subdivisions: int = LARGE_SUBDIVISIONS):
    """(object config, FemObject, initial state) of the Kuhn-grid body: at
    rest shape, its lowest layer 2 mm above the floor, moving down at
    1 m/s — it lands in the first frame, so CG works from the start."""
    from fem_tpu.models.mesh import construct_3d_grid_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.utils.config import ObjectConfig

    ocfg = ObjectConfig(
        center=(0.35, 0.002, 0.35), side_length=0.3,
        subdivisions=subdivisions, rho=1000.0, E=4e4, nu=0.4, damping=10.0,
    )
    vertices, faces, elements = construct_3d_grid_mesh(ocfg)
    obj, state = build_object(ocfg, vertices, faces, elements)
    return ocfg, obj, state.replace(vel=state.vel.at[:, 1].set(-1.0))


def implicit_cg_config(ocfg, dt: float, **overrides):
    from fem_tpu.utils.config import SimConfig

    return SimConfig(
        dim=3, delta_time=dt, sim_count=10, use_explicit_method=False,
        auto_diff=False, implicit_method=1, preconditioned=1,
        g_dir=(0.0, -1.0, 0.0), objects=(ocfg,), blocks=(), **overrides,
    )


def compare_devices(obj, state, cfg, obstacles, device_a, device_b,
                    substeps: int = 3) -> dict:
    """Run ``substeps`` of the same jitted substep on two devices from the
    same state; return the largest position and velocity differences."""
    import jax

    from fem_tpu.sim import make_substep_fn

    out = []
    for dev in (device_a, device_b):
        o, s, obs = jax.device_put((obj, state, obstacles), dev)
        step = make_substep_fn(o, cfg)
        for _ in range(substeps):
            s, _ = step(s, obs)
        out.append(jax.device_get(s))
    a, b = out
    return {
        "pos": float(np.max(np.abs(np.asarray(a.pos) - np.asarray(b.pos)))),
        "vel": float(np.max(np.abs(np.asarray(a.vel) - np.asarray(b.vel)))),
        "finite": _finite_state(a) and _finite_state(b),
    }


def phase_large(subdivisions: int = LARGE_SUBDIVISIONS, warm=2, frames=5,
                compare_substeps: int = 3) -> dict:
    import jax

    from fem_tpu.models.state import Obstacles
    from fem_tpu.sim import make_frame_fn

    t0 = time.perf_counter()
    ocfg, obj, state = large_body(subdivisions)
    setup_s = time.perf_counter() - t0
    obstacles = Obstacles.from_configs((), 3)
    result = {"tets": obj.element_cnt, "particles": obj.particle_cnt,
              "setup_s": setup_s, "variants": {}}
    for name, over in (("precond1", {}), ("plain", {"cg_precond": "none"})):
        cfg = implicit_cg_config(ocfg, LARGE_DT, **over)
        s, compile_s, rate, iters = time_frames(
            make_frame_fn(obj, cfg), state, obstacles, cfg.sim_count,
            warm=warm, frames=frames,
        )
        if not _finite_state(s):
            raise RuntimeError(f"large body ({name}): non-finite state")
        result["variants"][name] = {
            "compile_s": compile_s, "steps_per_s": rate,
            "iters_per_substep": iters,
        }
    stats = jax.devices()[0].memory_stats() or {}
    result["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    diff = compare_devices(
        obj, state, implicit_cg_config(ocfg, LARGE_DT), obstacles,
        jax.devices()[0], jax.devices("cpu")[0], compare_substeps,
    )
    if not diff["finite"]:
        raise RuntimeError("large body: non-finite state in device compare")
    if diff["pos"] > DEVICE_POS_ATOL or diff["vel"] > DEVICE_VEL_ATOL:
        raise RuntimeError(f"large body: accelerator vs CPU {diff}")
    result["vs_cpu"] = diff
    return result


# ---------------------------------------------------------------------------
# (e): parity with the float64 oracle
# ---------------------------------------------------------------------------

PARITY_METHODS = {
    # name: (config overrides, oracle step, substeps)
    "explicit": (dict(use_explicit_method=True, delta_time=1e-4),
                 "explicit", 20),
    "autodiff": (dict(use_explicit_method=True, auto_diff=True,
                      delta_time=1e-4), "explicit", 20),
    "jacobi": (dict(implicit_method=0), "jacobi", 5),
    "cg_precond1": (dict(implicit_method=1, preconditioned=1), "cg", 8),
    "cg_precond0": (dict(implicit_method=1, preconditioned=0), "cg", 8),
}


def phase_parity(ocfg, vertices, faces, elements, methods=None) -> dict:
    """Several substeps of each method from a squashed state, against the
    float64 oracle started from the same state."""
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.sim import make_substep_fn
    from fem_tpu.utils.config import SimConfig
    from tests.oracle import Oracle

    obj, rest = build_object(ocfg, vertices, faces, elements)
    state0 = _squashed(rest, (1.1, 0.85, 1.1))
    obstacles = Obstacles.from_configs((), 3)
    g_dir = (0.0, -1.0, 0.0)
    out = {}
    for name in methods or PARITY_METHODS:
        over, kind, substeps = PARITY_METHODS[name]
        cfg = SimConfig(**{
            **dict(dim=3, delta_time=5e-4, sim_count=1, auto_diff=False,
                   use_explicit_method=False, implicit_method=1,
                   preconditioned=1, g_dir=g_dir, objects=(ocfg,),
                   blocks=()),
            **over,
        })
        oracle = Oracle(
            np.asarray(rest.pos, np.float64), elements, ocfg.rho, ocfg.mu,
            ocfg.s_lambda, ocfg.damping,
        )
        oracle.pos = np.asarray(state0.pos, np.float64)
        step = make_substep_fn(obj, cfg)
        s = state0
        for _ in range(substeps):
            s, _ = step(s, obstacles)
            if kind == "explicit":
                oracle.step_explicit(cfg.delta_time, g_dir, [])
            elif kind == "jacobi":
                oracle.step_implicit_jacobi(cfg.delta_time, g_dir, [])
            else:
                oracle.step_implicit_cg(
                    cfg.delta_time, g_dir, [], cfg.preconditioned
                )
        err = float(np.max(np.abs(np.asarray(s.pos) - oracle.pos)))
        out[name] = {"substeps": substeps, "max_pos_err": err,
                     "atol": ORACLE_ATOL[name]}
        if not err <= ORACLE_ATOL[name]:
            raise RuntimeError(f"parity {name}: {err} > {ORACLE_ATOL[name]}")
    return out


def flagship_mesh():
    """(object config, vertices, faces, elements) of the flagship body."""
    from fem_tpu.models.mesh import load_object_mesh
    from fem_tpu.utils.config import read_config

    ocfg = read_config(FLAGSHIP_CONFIG).objects[0]
    v, f, e, _ = load_object_mesh(ocfg)
    return ocfg, v, f, e


# ---------------------------------------------------------------------------
# --four: the sharded path
# ---------------------------------------------------------------------------

def phase_sharded(n_devices: int = 4, subdivisions: int = LARGE_SUBDIVISIONS,
                  warm=1, frames=3) -> dict:
    """The element-sharded frame over ``n_devices`` against the same body on
    one device: timings, and the state after one frame from the same
    start."""
    import jax

    from fem_tpu.models.state import Obstacles
    from fem_tpu.parallel.sharding import (
        make_element_mesh,
        make_sharded_frame_fn,
    )
    from fem_tpu.sim import make_frame_fn

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    ocfg, obj, state = large_body(subdivisions)
    cfg = implicit_cg_config(ocfg, LARGE_DT)
    obstacles = Obstacles.from_configs((), 3)
    sharded = make_sharded_frame_fn(
        obj, cfg, make_element_mesh(devices=devices)
    )
    single = make_frame_fn(obj, cfg)
    result = {"tets": obj.element_cnt, "devices": n_devices}
    one_frame = {}
    for name, fn in (("sharded", sharded), ("single", single)):
        s, compile_s, rate, iters = time_frames(
            fn, state, obstacles, cfg.sim_count, warm=warm, frames=frames,
        )
        if not _finite_state(s):
            raise RuntimeError(f"{name}: non-finite state")
        result[name] = {"compile_s": compile_s, "steps_per_s": rate,
                        "iters_per_substep": iters}
        one_frame[name] = jax.device_get(fn(state, obstacles)[0])
    a, b = one_frame["sharded"], one_frame["single"]
    diff = {
        "pos": float(np.max(np.abs(np.asarray(a.pos) - np.asarray(b.pos)))),
        "vel": float(np.max(np.abs(np.asarray(a.vel) - np.asarray(b.vel)))),
    }
    # One frame is 10 substeps: the per-substep bound times 10 for
    # positions; velocities stay within one solve's bound.
    if diff["pos"] > 10 * DEVICE_POS_ATOL or diff["vel"] > DEVICE_VEL_ATOL:
        raise RuntimeError(f"sharded vs single device: {diff}")
    result["vs_single"] = diff
    return result


# ---------------------------------------------------------------------------

def _fmt(d: dict) -> str:
    return ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in d.items() if k != "metrics" and not isinstance(v, dict)
    )


def run_one_card() -> None:
    ocfg, v, f, e = flagship_mesh()
    with tempfile.TemporaryDirectory() as out:
        _say("(a) main.run: flagship implicit CG, 120 frames")
        r = phase_cli(FLAGSHIP_CONFIG, 120, os.path.join(out, "a"))
        _say(f"(a) ok: {_fmt(r)}")
        _say("(b) main.run: 2D explicit demo, 120 frames")
        r = phase_cli(DEMO_2D_CONFIG, 120, os.path.join(out, "b"))
        _say(f"(b) ok: {_fmt(r)}")
    with open(FLAGSHIP_CONFIG) as fh:
        data = json.load(fh)
    for method in METHODS:
        frames = 2 if method == "jacobi" else 5
        r = phase_simulation(data, method, warm=1, frames=frames)
        _say(f"(c) Simulation[{method}] ok: {_fmt(r)} metrics={r['metrics']}")
    r = phase_large()
    for name, vr in r["variants"].items():
        _say(f"(d) {r['tets']} tets, {r['particles']} particles, "
             f"CG {name}: {_fmt(vr)}")
    _say(f"(d) setup {r['setup_s']:.2f} s, peak_bytes_in_use="
         f"{r['peak_bytes_in_use']}, vs CPU after 3 substeps: "
         f"max|dpos|={r['vs_cpu']['pos']:.3g} (tol {DEVICE_POS_ATOL}), "
         f"max|dvel|={r['vs_cpu']['vel']:.3g} (tol {DEVICE_VEL_ATOL})")
    r = phase_parity(ocfg, v, f, e)
    for name, pr in r.items():
        _say(f"(e) parity {name}: {pr['substeps']} substeps, max|pos - "
             f"oracle| = {pr['max_pos_err']:.3g} (tol {pr['atol']})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded path on 4 GPUs")
    args = parser.parse_args(argv)
    os.chdir(HERE)
    sys.path.insert(0, HERE)

    import jax

    from fem_tpu.utils.runtime import enable_compile_cache, require_gpu

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    enable_compile_cache()
    _say(f"card: {card_line()}")
    _say(f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
         f"{len(devices)} device(s)")
    if args.four:
        r = phase_sharded(4)
        devices = devices[:4]
        _say(f"(four) {r['tets']} tets over {r['devices']} devices: "
             f"sharded {_fmt(r['sharded'])} | single {_fmt(r['single'])} | "
             f"after one frame max|dpos|={r['vs_single']['pos']:.3g} "
             f"(tol {10 * DEVICE_POS_ATOL}), max|dvel|="
             f"{r['vs_single']['vel']:.3g} (tol {DEVICE_VEL_ATOL})")
    else:
        run_one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
