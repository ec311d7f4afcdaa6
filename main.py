# coding=utf-8
"""CLI driver for the fem_tpu FEM framework.

Headless equivalent of the reference's interactive loop (main.py:32-133):
``python main.py --config default.json --seconds 5`` advances the simulation,
captures frames at the configured fps, exports per-frame OBJs when enabled,
and builds gif/mp4 at the end.  Interactive pause/resume/camera keys have no
meaning on a display-less accelerator host; ``--seconds``/``--frames`` bound the run
instead, and ``--checkpoint-every`` / ``--resume`` add restartable state
(capability the reference lacks, SURVEY §5).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Hyperelastic FEM simulation (JAX)"
    )
    parser.add_argument(
        "--config", type=str, default="configs/default.json",
        help="Please input a config json file.",
    )
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="virtual seconds to simulate")
    parser.add_argument("--frames", type=int, default=None,
                        help="explicit frame count (overrides --seconds)")
    parser.add_argument("--output", type=str, default="./output")
    parser.add_argument("--no-render", action="store_true")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save a checkpoint every N frames (0 = off)")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint .npz to resume from")
    parser.add_argument("--interior-spacing", type=float, default=None,
                        help="Steiner-point spacing for the native tet mesher")
    parser.add_argument("--print-every", type=int, default=60)
    parser.add_argument("--debug", action="store_true",
                        help="NaN-guarded stepping + physics metrics per print")
    parser.add_argument("--trace", type=str, default=None,
                        help="capture a jax.profiler trace into this directory")
    parser.add_argument("--wireframe", action="store_true",
                        help="3D: edges only instead of the lit surface "
                             "(reference scene.mesh show_wireframe look)")
    parser.add_argument("--camera", type=str, default=None,
                        help="3D camera as 'elev,azim' degrees (headless "
                             "replacement for the reference's interactive "
                             "camera keys)")
    parser.add_argument("--color", choices=("energy", "stress"),
                        default="energy",
                        help="2D triangle tint: 'energy' = reference parity "
                             "(V*phi), 'stress' = von Mises normalized to "
                             "the scene max (extension)")
    parser.add_argument("--export-vtu", action="store_true",
                        help="also write VTK .vtu volume snapshots (+ a "
                             ".pvd time-series index) at the OBJ export "
                             "cadence (extension; any dim)")
    parser.add_argument("--sharded", action="store_true",
                        help="compile each body's frame under shard_map "
                             "over ALL jax.devices() (elements "
                             "partitioned, one psum per operator apply) — "
                             "multi-device execution; identical "
                             "trajectories to single-device")
    args = parser.parse_args(argv)

    # Persistent compilation cache: repeat runs of the same config skip the
    # first compile (fem_tpu/utils/runtime.py).
    import jax

    from fem_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from fem_tpu.scene import load_scene, method_banner
    from fem_tpu.sim import element_phi, make_frame_fn
    from fem_tpu.utils import io as fio
    from fem_tpu.utils.config import read_config

    try:
        cfg = read_config(args.config)
    except Exception as e:  # reference exits with code 3 (utils.py:29-32)
        print(e)
        print("Parsing config file error")
        return 3

    scene, obstacles = load_scene(cfg, args.interior_spacing)
    print(method_banner(cfg))

    contact_frame = None
    if cfg.contact == "penalty" and (len(scene) > 1 or cfg.self_contact):
        if args.sharded:
            print("contact='penalty' is not supported with --sharded")
            return 3
        from fem_tpu.contact import make_contact_frame_fn

        contact_frame = make_contact_frame_fn([s.obj for s in scene], cfg)
        frame_fns = [None] * len(scene)
    elif args.sharded:
        from fem_tpu.parallel.sharding import (
            make_element_mesh,
            make_sharded_frame_fn,
        )

        mesh = make_element_mesh()
        print(f"sharded over {mesh.devices.size} devices")
        frame_fns = [make_sharded_frame_fn(s.obj, cfg, mesh) for s in scene]
    else:
        frame_fns = [make_frame_fn(s.obj, cfg) for s in scene]

    frame_time = cfg.frame_time
    n_frames = args.frames
    if n_frames is None:
        n_frames = int(args.seconds / (cfg.sim_count * cfg.delta_time))

    virtual_time = 0.0
    start_frame = 0
    ply_cnt = 0
    vtu_entries = {}
    if args.resume:
        states, start_frame, virtual_time, ply_cnt = fio.load_scene_checkpoint(
            args.resume
        )
        if len(states) != len(scene):
            print(
                f"Checkpoint has {len(states)} bodies but config has "
                f"{len(scene)}"
            )
            return 3
        for s, state in zip(scene, states):
            s.state = state
        print(f"Resumed from {args.resume} at frame {start_frame}")

    renderer = None
    if not args.no_render:
        from fem_tpu.render.raster import HeadlessRenderer

        camera = None
        if args.camera:
            elev, azim = (float(x) for x in args.camera.split(","))
            camera = (elev, azim)
        renderer = HeadlessRenderer(
            cfg.dim, args.output, cfg.output_fps, cfg.is_output_gif,
            camera=camera,
            style="wireframe" if args.wireframe else "shaded",
        )
    os.makedirs(args.output, exist_ok=True)

    centers = np.asarray(obstacles.centers)
    radii = np.asarray(obstacles.radii)
    iter_handles = []  # per-frame solver iterations, fetched after the run
    t_first = None
    t0 = time.perf_counter()

    trace_ctx = None
    if args.trace:
        from fem_tpu.utils.profiling import trace as profiler_trace

        trace_ctx = profiler_trace(args.trace)
        trace_ctx.__enter__()

    for frame in range(start_frame, n_frames):
        per_body_aux = []
        if contact_frame is not None:
            # Coupled stepping (contact="penalty"): every body advances its
            # sim_count substeps jointly with per-substep penalty forces.
            new_states, auxes = contact_frame(
                tuple(s.state for s in scene), obstacles
            )
            for s, st, aux in zip(scene, new_states, auxes):
                s.state = st
                per_body_aux.append(aux)
            # Keep the reference's N×-pacing virtual_time quirk (PARITY.md)
            # so output cadence matches the uncoupled path.
            virtual_time += len(scene) * cfg.sim_count * cfg.delta_time
        else:
            for s, frame_fn in zip(scene, frame_fns):
                s.state, aux = frame_fn(s.state, obstacles)
                per_body_aux.append(aux)
                # Reference quirk, reproduced deliberately: virtual_time
                # advances *inside* the per-object loop (main.py:113), so an
                # N-body scene paces gif capture and OBJ export N× faster.
                # See PARITY.md.
                virtual_time += cfg.sim_count * cfg.delta_time

        iter_handles.append([a.solver_iterations for a in per_body_aux])
        if t_first is None:
            jax.block_until_ready([s.state for s in scene])
            t_first = time.perf_counter() - t0
        if (
            (cfg.is_output_obj or args.export_vtu)
            and (virtual_time / frame_time) > ply_cnt
            and (cfg.dim == 3 or args.export_vtu)
        ):  # reference main.py:117-122
            if cfg.is_output_obj and cfg.dim == 3:
                for s in scene:
                    if "map_index" in s.aux:
                        fio.export_deformed_obj(
                            os.path.join(args.output, f"obj_{ply_cnt:06}.obj"),
                            np.asarray(s.state.pos),
                            s.aux["obj_vertices"],
                            s.aux["obj_faces"],
                            s.aux["map_index"],
                        )
            if args.export_vtu:
                # VTU volume snapshots (extension): full tet/triangle mesh
                # + velocity / von-Mises fields per body, ParaView-ready.
                from fem_tpu.sim import element_von_mises
                from fem_tpu.utils.vtu import write_vtu

                for i, s in enumerate(scene):
                    vtu_path = os.path.join(
                        args.output, f"sim_b{i}_{ply_cnt:06}.vtu"
                    )
                    write_vtu(
                        vtu_path,
                        np.asarray(s.state.pos),
                        np.asarray(s.obj.element_indices),
                        point_data={"velocity": np.asarray(s.state.vel)},
                        cell_data={
                            "von_mises": np.asarray(
                                element_von_mises(s.obj, s.state)
                            ),
                        },
                    )
                    vtu_entries.setdefault(i, []).append(
                        (virtual_time, vtu_path)
                    )
            ply_cnt += 1

        if renderer is not None:
            msgs = []
            if not cfg.is_output_gif:  # overlay parity, main.py:124-127
                msgs = [f"frame_cnt: {frame + 1}", f"time: {virtual_time:.4f}"]
            # Every body in the scene is drawn (reference render2d/render3d
            # loop over objects, render/render.py:66,97).
            all_pos = [np.asarray(s.state.pos) for s in scene]
            all_faces = [np.asarray(s.obj.faces) for s in scene]
            all_phi = None
            if cfg.dim == 2:
                if args.color == "stress":
                    from fem_tpu.sim import element_von_mises

                    vm = [
                        np.asarray(element_von_mises(s.obj, s.state))
                        for s in scene
                    ]
                    peak = max(float(v.max()) for v in vm) or 1.0
                    all_phi = [v / peak for v in vm]
                else:
                    all_phi = [
                        np.asarray(element_phi(s.obj, s.state)) for s in scene
                    ]
            renderer.maybe_capture(
                virtual_time, all_pos, all_faces, all_phi, centers, radii,
                msgs,
            )

        if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
            fio.save_scene_checkpoint(
                os.path.join(args.output, f"ckpt_{frame + 1:06}.npz"),
                [s.state for s in scene], frame + 1, virtual_time, ply_cnt,
            )

        if args.debug:
            from fem_tpu.utils.profiling import check_state

            check_state(scene[0].obj, scene[0].state, (frame + 1) * cfg.sim_count)

        if args.print_every and (frame + 1) % args.print_every == 0:
            elapsed = time.perf_counter() - t0
            steps = (frame + 1 - start_frame) * cfg.sim_count
            msg = (
                f"frame {frame + 1}/{n_frames}  t={virtual_time:.3f}s  "
                f"{steps / elapsed:.1f} steps/s"
            )
            body_iters = [
                int(np.asarray(a.solver_iterations).sum())
                for a in per_body_aux
            ]
            if any(body_iters):
                if len(body_iters) == 1:
                    msg += (
                        "  solver iters/substep: "
                        f"{body_iters[0] / cfg.sim_count:.1f}"
                    )
                else:  # label per body (round-1 review: unlabeled last-body)
                    per = ", ".join(
                        f"obj{i}={it / cfg.sim_count:.1f}"
                        for i, it in enumerate(body_iters)
                    )
                    msg += f"  solver iters/substep: {per}"
            if args.debug:
                from fem_tpu.utils.profiling import frame_metrics

                m = frame_metrics(scene[0].obj, scene[0].state)
                msg += (
                    f"  U={m.elastic_energy:.4g} KE={m.kinetic_energy:.4g}"
                    f" min|F|={m.min_det_f:.3f}"
                )
            print(msg)

    jax.block_until_ready([s.state for s in scene])
    wall = time.perf_counter() - t0
    frames_run = n_frames - start_frame
    if frames_run > 0:
        summary = (
            f"{frames_run} frames in {wall:.2f} s: first frame "
            f"{t_first:.2f} s (includes compilation)"
        )
        if frames_run > 1:
            rate = (frames_run - 1) * cfg.sim_count / (wall - t_first)
            summary += f", then {rate:.1f} steps/s"
        body_iters = np.asarray(
            [[np.asarray(h).sum() for h in frame] for frame in iter_handles]
        ).sum(axis=0)
        if body_iters.any():
            per = ", ".join(
                f"{it / (frames_run * cfg.sim_count):.2f}" for it in body_iters
            )
            summary += f"; solver iters/substep (mean): {per}"
        print(summary)

    if args.export_vtu and vtu_entries:
        from fem_tpu.utils.vtu import write_pvd

        for i, entries in vtu_entries.items():
            write_pvd(os.path.join(args.output, f"sim_b{i}.pvd"), entries)
        print(f"VTU series written ({sum(map(len, vtu_entries.values()))} "
              "snapshots).")

    if trace_ctx is not None:
        trace_ctx.__exit__(None, None, None)
        print(f"Profiler trace written to {args.trace}")

    if renderer is not None and cfg.is_output_gif:
        written = renderer.make_video(gif=True, mp4=True)
        if written:
            print("Make video success.")  # parity: main.py:133
            for w in written:
                print(" ", w)
    return 0


if __name__ == "__main__":
    sys.exit(run())
