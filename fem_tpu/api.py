# coding=utf-8
"""High-level user API: one object wrapping scene + compiled steppers.

The reference's only "API" is its CLI main loop; library users of this
framework get an ergonomic façade over the pure-functional core::

    import fem_tpu
    sim = fem_tpu.Simulation.from_config("configs/default.json")
    sim.run(seconds=1.0)                   # advance the virtual clock
    frame = sim.render()                    # RGB frame of the current state
    sim.save_checkpoint("state.npz")
    metrics = sim.metrics()                 # energies / min det F / NaN guard

Everything remains accessible underneath (``sim.scene[i].obj/.state``,
``fem_tpu.sim.substep`` …) for power users.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from fem_tpu.models.state import Obstacles
from fem_tpu.scene import SceneObject, load_scene, method_banner
from fem_tpu.sim import element_phi, make_frame_fn
from fem_tpu.utils import io as fio
from fem_tpu.utils.config import SimConfig, parse_config, read_config
from fem_tpu.utils.profiling import FrameMetrics, check_state, frame_metrics


class Simulation:
    """A loaded scene plus compiled per-frame steppers and a virtual clock."""

    def __init__(self, cfg: SimConfig, interior_spacing: Optional[float] = None,
                 sharded: bool = False):
        """``sharded=True`` compiles each body's frame function under
        ``shard_map`` over a 1-D device mesh spanning all of
        ``jax.devices()`` (elements partitioned, one psum
        per operator apply — parallel/sharding.py).  Identical results to
        single-device (tests/test_sharding.py); requires >1 device to be
        useful (8 virtual CPU devices via
        ``xla_force_host_platform_device_count`` work for testing)."""
        self.cfg = cfg
        self.scene: List[SceneObject]
        self.scene, self.obstacles = load_scene(cfg, interior_spacing)
        self._contact_frame = None
        if cfg.contact == "penalty" and (
            len(self.scene) > 1 or cfg.self_contact
        ):
            if sharded:
                # Round-5: pair forces compute replicated (particle-space);
                # element work shards per body (parallel/sharding.py).
                from fem_tpu.parallel.sharding import (
                    make_element_mesh,
                    make_sharded_contact_frame_fn,
                )

                self._contact_frame = make_sharded_contact_frame_fn(
                    [s.obj for s in self.scene], cfg, make_element_mesh()
                )
            else:
                from fem_tpu.contact import make_contact_frame_fn

                self._contact_frame = make_contact_frame_fn(
                    [s.obj for s in self.scene], cfg
                )
            self._frame_fns = [None] * len(self.scene)
        elif sharded:
            from fem_tpu.parallel.sharding import (
                make_element_mesh,
                make_sharded_frame_fn,
            )

            mesh = make_element_mesh()
            self._frame_fns = [
                make_sharded_frame_fn(s.obj, cfg, mesh) for s in self.scene
            ]
        else:
            self._frame_fns = [make_frame_fn(s.obj, cfg) for s in self.scene]
        self.virtual_time = 0.0
        self.frame_count = 0
        self.last_aux = None

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_config(cls, path: str, **kw) -> "Simulation":
        return cls(read_config(path), **kw)

    @classmethod
    def from_dict(cls, data: dict, **kw) -> "Simulation":
        return cls(parse_config(data), **kw)

    # -- stepping ---------------------------------------------------------
    def step_frame(self) -> None:
        """Advance one rendered frame (= ``sim_count`` substeps).  With
        ``contact="penalty"`` all bodies advance jointly with per-substep
        penalty coupling (fem_tpu/contact.py)."""
        if self._contact_frame is not None:
            states, auxes = self._contact_frame(
                tuple(s.state for s in self.scene), self.obstacles
            )
            for s, st in zip(self.scene, states):
                s.state = st
            self.last_aux = auxes[-1]
        else:
            for s, fn in zip(self.scene, self._frame_fns):
                s.state, self.last_aux = fn(s.state, self.obstacles)
        self.virtual_time += self.cfg.sim_count * self.cfg.delta_time
        self.frame_count += 1

    def solve_static(self, gravity: bool = True, index: Optional[int] = None,
                     **kw) -> list:
        """Solve each body (or just ``index``) to quasi-static equilibrium
        under gravity (``cfg.g_dir``) and set its state there with zero
        velocity (solvers/static.py — Dirichlet-pinned Newton; extension:
        the reference is dynamics-only).  Returns the ``StaticResult`` list.
        """
        import jax.numpy as jnp

        from fem_tpu.solvers.static import solve_static as _solve

        results = []
        targets = self.scene if index is None else [self.scene[index]]
        for s in targets:
            res = _solve(
                s.obj, s.state.pos,
                g_dir=self.cfg.g_dir if gravity else None, **kw,
            )
            zeros = jnp.zeros_like(s.state.pos)
            s.state = s.state.replace(
                pos=res.pos, vel=zeros, vel_g=zeros, force=zeros,
            )
            results.append(res)
        return results

    def modes(self, k: int = 6, index: int = 0, at_equilibrium: bool = False,
              method: str = "chebyshev", **kw):
        """Modal analysis extension (solvers/modal.py — the reference has no
        eigenanalysis): smallest-``k`` natural frequencies and M-orthonormal
        mode shapes of body ``index`` linearized at its current state (or at
        the static equilibrium first, with ``at_equilibrium=True``; requires
        ``pin_boxes`` for that).  Returns a ``ModalResult``; unpinned bodies
        report the rigid-body motions as the leading ω ≈ 0 modes.

        ``method``: "chebyshev" (default — filtered subspace iteration, no
        inner solves, scales to 68k+ tets and matches the f64 oracle to
        ~1e-6 relative), "shift_invert" (inner-CG LOBPCG; fine on small
        meshes, collapses at scale), or "sparse_f64" (the DIRECT offline
        oracle: exact f64 element Hessians + host sparse ARPACK
        shift-invert — residuals ~1e-12 at 68k, validates the f32 device
        route's ω² to ≤3e-5; solvers/modal.modal_analysis_sparse_f64).

        ``refine_f64=True`` chases the f32 solve with a float64 Chebyshev
        pass on the host CPU (solvers/modal.modal_refine_f64) — scrubs the
        f32 HVP-noise contamination and reports residuals at the true
        subspace accuracy (≤1e-8 on CI meshes).  Offline-verification
        cost, not hot-path."""
        refine = bool(kw.pop("refine_f64", False))
        if at_equilibrium:
            self.solve_static(index=index)
        s = self.scene[index]
        if method == "sparse_f64":
            from fem_tpu.solvers.modal import modal_analysis_sparse_f64

            return modal_analysis_sparse_f64(s.obj, s.state.pos, k=k)
        if method == "chebyshev":
            from fem_tpu.solvers.modal import modal_analysis_chebyshev

            res = modal_analysis_chebyshev(s.obj, s.state.pos, k=k, **kw)
        else:
            from fem_tpu.solvers.modal import modal_analysis

            res = modal_analysis(s.obj, s.state.pos, k=k, **kw)
        if refine:
            from fem_tpu.solvers.modal import modal_refine_f64

            res = modal_refine_f64(s.obj, s.state.pos, result=res, k=k)
        return res

    def buckling(self, k: int = 4, index: int = 0,
                 f_ext: Optional[np.ndarray] = None,
                 gravity: bool = False, **kw):
        """Linearized buckling analysis of body ``index`` (extension —
        solvers/buckling.py; the reference has no stability analysis):
        critical multipliers λ of the applied load (``f_ext`` per-vertex
        + gravity if ``gravity`` + the body's ``load_boxes``) at which
        K₀ + λ·K_g goes singular, plus the buckling mode shapes.
        Requires ``pin_boxes``.  Returns a ``BucklingResult``."""
        import jax.numpy as jnp

        from fem_tpu.solvers.buckling import linear_buckling

        s = self.scene[index]
        return linear_buckling(
            s.obj, s.state.pos,
            f_ext=None if f_ext is None else jnp.asarray(f_ext),
            g_dir=self.cfg.g_dir if gravity else None, k=k, **kw,
        )

    def harmonic(self, f_hat: np.ndarray, freqs_hz: np.ndarray,
                 k: int = 6, index: int = 0, modal=None, **kw):
        """Steady-state frequency response of body ``index`` to the load
        amplitude ``f_hat`` (N, d) over ``freqs_hz`` (extension —
        solvers/harmonic.py; the reference is time-domain only): modal
        superposition on the smallest-``k`` modes (or a precomputed
        ``modal`` result).  Rayleigh damping via ``alpha=``/``beta=``,
        or per-mode ratios via ``zeta=``.  Returns a ``HarmonicResult``."""
        import jax.numpy as jnp

        from fem_tpu.solvers.harmonic import harmonic_response

        if modal is None:
            modal = self.modes(k=k, index=index)
        return harmonic_response(
            modal, jnp.asarray(f_hat), jnp.asarray(freqs_hz), **kw
        )

    def response_spectrum(self, accel: np.ndarray, dt: float,
                          direction, k: int = 6, index: int = 0,
                          zeta: float = 0.05, combination: str = "cqc",
                          modal=None):
        """Response-spectrum analysis of body ``index`` under a rigid base
        excitation along ``direction`` (extension — solvers/spectrum.py;
        the reference is time-domain only): builds the displacement
        spectrum of the ground-acceleration record ``accel`` (sampled at
        ``dt``) with exact-propagator SDOF scans AT the modal frequencies,
        then combines the per-mode peaks Γᵢ·Sd(ωᵢ)·φᵢ by ``combination``
        ("cqc" | "srss" | "abssum").  Requires ``pin_boxes`` (rigid modes
        have no finite spectral displacement).  Returns an ``RSResult``
        (check ``.captured`` ≳ 0.9 for modal-basis adequacy)."""
        import jax.numpy as jnp

        from fem_tpu.solvers.spectrum import (
            response_spectrum as _spectrum,
            response_spectrum_analysis,
        )

        if modal is None:
            modal = self.modes(k=k, index=index)
        omegas = jnp.sqrt(jnp.maximum(jnp.asarray(modal.omega_sq), 0.0))
        sp = _spectrum(jnp.asarray(accel), dt, omegas, zeta=zeta)
        return response_spectrum_analysis(
            modal, self.scene[index].obj.mass, direction,
            spectrum=sp, zeta=zeta, combination=combination,
        )

    def arc_length(self, f_pattern: np.ndarray, index: int = 0, **kw):
        """Arc-length (Riks) continuation of body ``index`` under the load
        λ·``f_pattern`` (extension — solvers/riks.py): traces the
        equilibrium path THROUGH limit points (snap-through), which
        neither dynamics nor load-controlled statics can follow.  Runs in
        float64 on the host with direct sparse tangent factorizations
        (see the module docstring for the two measured facts that force
        both choices).  Requires ``pin_boxes``.  Returns an
        ``ArcLengthResult``; does not modify the simulation state."""
        import jax.numpy as jnp

        from fem_tpu.solvers.riks import arc_length_path

        s = self.scene[index]
        return arc_length_path(
            s.obj, s.state.pos, jnp.asarray(f_pattern), **kw
        )

    def run(self, seconds: Optional[float] = None, frames: Optional[int] = None,
            nan_guard: bool = False) -> None:
        """Advance by virtual ``seconds`` or an explicit ``frames`` count."""
        if frames is None:
            if seconds is None:
                raise ValueError("pass seconds= or frames=")
            frames = int(seconds / (self.cfg.sim_count * self.cfg.delta_time))
        for _ in range(frames):
            self.step_frame()
            if nan_guard:
                check_state(
                    self.scene[0].obj, self.scene[0].state,
                    self.frame_count * self.cfg.sim_count,
                )

    # -- observation ------------------------------------------------------
    def metrics(self, index: int = 0) -> FrameMetrics:
        s = self.scene[index]
        return frame_metrics(s.obj, s.state)

    def positions(self, index: int = 0) -> np.ndarray:
        return np.asarray(self.scene[index].state.pos)

    def stress(self, index: int = 0) -> np.ndarray:
        """Per-element Cauchy stress tensors (E, d, d) at the current state
        (post-processing extension — ops/element.cauchy_stress)."""
        from fem_tpu.ops.element import element_stresses

        s = self.scene[index]
        return np.asarray(
            element_stresses(
                s.state.pos, s.obj.element_indices, s.obj.ref_inv,
                s.obj.mu, s.obj.s_lambda, s.obj.material,
            )
        )

    def von_mises(self, index: int = 0) -> np.ndarray:
        """Per-element von Mises equivalent stress (E,)."""
        from fem_tpu.sim import element_von_mises

        s = self.scene[index]
        return np.asarray(element_von_mises(s.obj, s.state))

    def render(self, msgs: Sequence[str] = (),
               color: str = "energy") -> np.ndarray:
        """RGB frame of the current state, all bodies (640×640 uint8).
        ``color="energy"`` is reference parity (per-triangle V·φ tint);
        ``color="stress"`` tints 2D triangles by von Mises stress normalized
        to the scene maximum (extension)."""
        from fem_tpu.render.raster import render_frame_2d, render_frame_3d

        pos = [np.asarray(s.state.pos) for s in self.scene]
        faces = [np.asarray(s.obj.faces) for s in self.scene]
        if self.cfg.dim == 2:
            if color == "stress":
                vm = [self.von_mises(i) for i in range(len(self.scene))]
                peak = max(float(v.max()) for v in vm) or 1.0
                phi = [v / peak for v in vm]
            else:
                phi = [
                    np.asarray(element_phi(s.obj, s.state))
                    for s in self.scene
                ]
            return render_frame_2d(
                pos, faces, phi,
                np.asarray(self.obstacles.centers),
                np.asarray(self.obstacles.radii),
                msgs,
            )
        return render_frame_3d(pos, faces, msgs)

    # -- persistence ------------------------------------------------------
    def save_checkpoint(self, path: str, index: int = 0) -> None:
        fio.save_checkpoint(
            path, self.scene[index].state, self.frame_count, self.virtual_time
        )

    def load_checkpoint(self, path: str, index: int = 0) -> None:
        state, frame, vt = fio.load_checkpoint(path)
        self.scene[index].state = state
        self.frame_count = frame
        self.virtual_time = vt

    def export_obj(self, path: str, index: int = 0) -> None:
        s = self.scene[index]
        if "map_index" not in s.aux:
            raise ValueError("OBJ export requires a 3D mesh-file object")
        fio.export_deformed_obj(
            path, np.asarray(s.state.pos), s.aux["obj_vertices"],
            s.aux["obj_faces"], s.aux["map_index"],
        )

    def export_vtu(self, path: str, index: int = 0) -> None:
        """Write the body's full volume mesh + fields as a VTK ``.vtu``
        snapshot (extension — fem_tpu/utils/vtu.py; the reference exports
        only the deformed OBJ surface skin, object.py:322-335).  Fields:
        point velocity and mass, per-cell von-Mises stress and det F."""
        from fem_tpu.ops.element import deformation_gradients
        from fem_tpu.utils.vtu import write_vtu

        s = self.scene[index]
        f_def = np.asarray(
            deformation_gradients(
                s.state.pos, s.obj.element_indices, s.obj.ref_inv
            )
        )
        write_vtu(
            path,
            np.asarray(s.state.pos),
            np.asarray(s.obj.element_indices),
            point_data={
                "velocity": np.asarray(s.state.vel),
                "mass": np.asarray(s.obj.mass),
            },
            cell_data={
                "von_mises": self.von_mises(index),
                "det_F": np.linalg.det(f_def.astype(np.float64)).astype(
                    np.float32
                ),
            },
        )

    def __repr__(self) -> str:
        bodies = ", ".join(
            f"{s.obj.particle_cnt}p/{s.obj.element_cnt}e" for s in self.scene
        )
        return (
            f"<Simulation dim={self.cfg.dim} t={self.virtual_time:.4f}s "
            f"bodies=[{bodies}] {method_banner(self.cfg)!r}>"
        )
