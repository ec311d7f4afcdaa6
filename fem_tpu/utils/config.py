# coding=utf-8
"""Immutable configuration for the fem_tpu FEM framework.

JSON schema parity with the reference (Jukgei/Finite-Element-Method:
``README.md:73-110``, parsed at ``utils.py:9-32``).  The reference copies config
values into a *mutable module* (``constants.py``) that every other module reads
at import time; here the same schema is parsed once into frozen dataclasses and
threaded explicitly, with ``dim`` acting as a static (trace-time) argument.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

JACOBI_METHOD = 0  # reference: constants.py:14 (JACOBIN_METHOD)
CONJUGATE_GRADIENT_METHOD = 1  # reference: constants.py:15

OPERATOR_MODES = ("auto", "graph", "mxu")
# Keys of earlier schema versions that chose among execution strategies of
# an accelerator kernel stack that no longer exists.  A config naming one is
# rejected rather than silently run on a different path.
REMOVED_KEYS = ("frame_backend", "element_backend", "cg_fast_math")


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """One soft body (reference: per-object dict, ``object.py:44-93``)."""

    id: int = 0
    rho: float = 500.0
    center: Tuple[float, ...] = (0.5, 0.8)
    E: float = 4e4
    nu: float = 0.2
    damping: float = 14.5
    # Stiffness-proportional Rayleigh damping coefficient β (seconds) —
    # extension; the reference's only dissipation is the exponential
    # velocity decay ``damping`` (solver/kinematic.py:23).  Adds the damping
    # force f_d = β·(∂f/∂x)·v built on the decoupled block Hessian
    # (ops/element.hessian_blocks) on every integration path: explicit /
    # autodiff apply it as an extra force; the semi-implicit solve folds it
    # into the system exactly (backward-Euler on the damping term:
    # A = I − dt·(dt+β)·M⁻¹·G(K)).  Unlike ``damping``, which damps rigid
    # translation too, β damps only *deformation* rates — high-frequency
    # element jitter dies at rate ~β·ω² while rigid modes are untouched.
    # 0.0 = exact reference parity.
    damping_beta: float = 0.0
    # 2D procedural grid (reference: object.py:95-126)
    side_length: float = 0.2
    subdivisions: int = 10
    # 3D mesh file (reference: object.py:128-161)
    obj: Optional[str] = None
    # Material model: "neo_hookean" (reference live path), "stvk" (the
    # reference's latent commented-out variant), "linear", "corotated"
    # (extensions; corotated uses a tie-robust polar decomposition), or
    # "stable_neo_hookean" (inversion-robust polynomial NH of Smith et al.
    # TOG 2018 — finite for inverted elements, recovers; the production
    # alternative where reference NH NaNs), "mooney_rivlin[:beta]"
    # (compressible two-invariant model, ops/element.mooney_params), or
    # "fiber:a1,a2[,a3][:kappa]" (transversely isotropic fiber
    # reinforcement: stable-NH base + kappa·mu/2·(I4−1)² along the unit
    # direction a — ops/element.fiber_params; the anisotropic rung of the
    # ladder).
    # Supported on every path: explicit (autodiff and analytic Piola
    # columns) and implicit — under hessian="reference" each material rides
    # the reference's decoupled one-block-per-element structure with its
    # own analytic DP(F)[R⁻¹] (ops/element.first_piola_dp), so both
    # operators (graph/mxu) apply; hessian="exact_jvp" is the true-Newton
    # alternative for any material.
    material: str = "neo_hookean"
    # Dirichlet boundary conditions (extension — the reference has no
    # kinematic constraints at all; its only boundary handling is the sticky
    # unit-box walls, solver/kinematic.py:25-30).  Each entry is an
    # axis-aligned box ((lo…), (hi…)) in *initial world* coordinates
    # (vertices + center); vertices inside any box are pinned: velocity
    # identically zero, position held.  The implicit system is solved with
    # the standard Dirichlet projection P·A·P + (I−P) (CG paths only).
    # An entry may carry a third element ((lo…), (hi…), (v…)): a PRESCRIBED
    # constant velocity — the pinned vertices translate kinematically
    # (stretch / compression / shear loading); the implicit solve then uses
    # the inhomogeneous projection with particular solution x_pinned = v.
    # --- Inelastic material ladder (extensions, fem_tpu/ops/inelastic.py;
    # the reference is purely hyperelastic).  Both use per-element internal
    # variables (SimState.plastic_inv / viscous_inv) updated once per
    # substep from the end-of-substep positions (explicit treatment of the
    # internal variables — standard operator splitting).
    # Von-Mises multiplicative plasticity on the BASE material: yield when
    # the deviatoric principal Hencky strain ‖dev log Σ(F_e)‖ exceeds
    # plastic_yield; the return map projects back onto the yield surface
    # (perfect plasticity, isochoric flow — det F_p = 1 exactly).  0 = off.
    plastic_yield: float = 0.0
    # One generalized-Maxwell branch: an extra stable-Neo-Hookean stress
    # with shear modulus viscous_mu evaluated on F·F_v⁻¹, where the branch
    # strain relaxes exponentially with time constant viscous_tau
    # (log-space decay exp(−dt/τ) per substep).  Captures rate-dependent
    # stiffness + stress relaxation/creep.  viscous_mu = 0 = off.
    viscous_mu: float = 0.0
    viscous_tau: float = 0.1
    pin_boxes: Tuple[Tuple[Tuple[float, ...], ...], ...] = ()
    # Neumann loads (extension — the reference's only external action is
    # gravity).  Each entry is ((lo…), (hi…), (F…)): a TOTAL force vector F
    # (Newtons) distributed over the vertices whose *initial world* position
    # falls in the axis-aligned box, weighted by lumped mass — so the load
    # is mesh-refinement-independent (a body force over the selected
    # region).  Applied on every integration path and included in
    # solve_static's equilibrium.
    load_boxes: Tuple[
        Tuple[Tuple[float, ...], Tuple[float, ...], Tuple[float, ...]], ...
    ] = ()

    @property
    def mu(self) -> float:
        """First Lamé parameter from (E, nu) — reference object.py:48."""
        return self.E / 2.0 / (1.0 + self.nu)

    @property
    def s_lambda(self) -> float:
        """Second Lamé parameter from (E, nu) — reference object.py:48."""
        return self.E * self.nu / (1.0 + self.nu) / (1.0 - 2.0 * self.nu)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Circular obstacle (reference: circle_blocks.py:6-25)."""

    id: int = 0
    block_center: Tuple[float, ...] = (0.5, 0.5)
    block_radius: float = 0.0


@dataclasses.dataclass(frozen=True)
class ObstacleConfig:
    """Typed rigid obstacle (extension — the reference has only circles,
    circle_blocks.py, plus the sticky unit-box walls, kinematic.py:25-30).
    All types use the reference circles' slide-collision semantics
    generalized to signed distance fields (fem_tpu/obstacles.py).

    * ``halfspace``: infinite wall through ``point`` with outward unit
      ``normal`` (solid side: normal·(x−point) < 0) — any orientation.
    * ``box``: SOLID axis-aligned box [lo, hi].
    * ``sphere``: center/radius — folded into the reference circle arrays
      (their math is dimension-generic).
    * ``mesh``: rigid triangle-mesh obstacle (3D) from ``obj`` (OBJ path),
      scaled by ``scale`` then offset, discretized to a signed-distance
      grid of ``resolution`` cells along the longest axis.
    """

    type: str = "halfspace"
    # halfspace
    point: Tuple[float, ...] = ()
    normal: Tuple[float, ...] = ()
    # box
    lo: Tuple[float, ...] = ()
    hi: Tuple[float, ...] = ()
    # sphere
    center: Tuple[float, ...] = ()
    radius: float = 0.0
    # mesh
    obj: Optional[str] = None
    scale: float = 1.0
    offset: Tuple[float, ...] = (0.0, 0.0, 0.0)
    resolution: int = 48
    # Coulomb friction coefficient μ (extension; 0 = the reference's
    # frictionless slide).  On a slide hit the tangential velocity is
    # reduced by at most μ·|v_n| (the removed normal speed — an impulse-
    # level Coulomb cone), so a body resting on a frictional surface
    # decelerates at μ·g and sticks when μ·|v_n| ≥ |v_t|.  Frictional
    # spheres stay on the SDF extension path (the reference circle arrays
    # carry no per-obstacle friction).
    friction: float = 0.0


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level simulation config (reference: default.json schema)."""

    dim: int = 2
    delta_time: float = 5e-4
    sim_count: int = 10
    # Default False to match parse_config / the reference's absent-key
    # semantics (utils.py:9-21 leaves constants.auto_diff = 0).  auto_diff
    # wins over use_explicit_method in substep dispatch (main.py:104-112
    # parity), so a True default here would silently run the explicit
    # autodiff path for directly-constructed implicit configs.
    auto_diff: bool = False
    use_explicit_method: bool = True
    implicit_method: int = JACOBI_METHOD
    preconditioned: int = 1
    g_dir: Tuple[float, ...] = (0.0, -1.0)
    is_output_gif: bool = True
    is_output_obj: bool = False
    output_fps: int = 60
    objects: Tuple[ObjectConfig, ...] = (ObjectConfig(),)
    blocks: Tuple[BlockConfig, ...] = ()
    # Typed rigid obstacles beyond the reference's circles (extension —
    # ObstacleConfig: halfspace / box / sphere / mesh SDF); empty = parity.
    obstacles: Tuple[ObstacleConfig, ...] = ()
    # Extension beyond the reference schema: implicit solve execution
    # strategy.  "auto"/"matrix_free" run the O(E) matrix-free operator;
    # "dense" materializes the reference's dense system (solvers/dense.py)
    # where it implements the configured semantics
    # (fem_tpu/strategy.uses_dense_solver).
    solver_backend: str = "auto"
    # Clamp determinants in the implicit path's F-inverse/log so degenerate
    # elements stay finite through impacts (the reference guards only the
    # Hessian's logJ, implicit.py:131, and NaNs otherwise). Off by default
    # for exact reference parity.
    robust_inversion: bool = False
    # Implicit linearization: "reference" (the reference's decoupled block
    # Hessian, exact parity) or "exact_jvp" (true Newton operator via
    # jax.jvp of the assembled force; CG only).
    hessian: str = "reference"
    # Implicit time integration (extension, solvers/newton.py).
    # "semi_implicit" (parity default): the reference's ONE linearized solve
    # per substep (implicit.py:201-223) — blows up when κ = dt²‖K‖/m → 1
    # (the dt ~ h wall).  "newton": fully implicit backward
    # Euler on the elastic term — damped Newton with exact material-generic
    # HVPs and a residual line search closes the nonlinear residual
    # r(v) = (v−vₙ) − dt·M⁻¹·f(xₙ+dt·v) each substep, removing the dt ~ h
    # cap (gravity/damping/collisions stay in advection, reference
    # structure).  Inner solve is plain relative-tolerance CG; the
    # `preconditioned` int and `implicit_method` are not consulted.
    integrator: str = "semi_implicit"
    # Newton caps for integrator="newton": max Newton steps per substep and
    # max inner CG iterations per Newton step.
    newton_iters: int = 10
    newton_cg_iters: int = 120
    # Convergence: max |r| ≤ newton_tol (velocity units).
    newton_tol: float = 1e-5
    # Newton Jacobian (solvers/newton.py): "exact" = true quadratic Newton
    # via the exact material HVP (jax.jvp of the assembled force, graph
    # chain); "decoupled" = modified Newton on the reference's decoupled
    # one-block-per-element linearization — each Newton step is one
    # semi-implicit-shaped solve on the graph operator (one element pass
    # yields both the residual force and the operator's K blocks), the fast
    # path at scale.
    newton_hessian: str = "exact"
    # Generalized-trapezoidal θ-scheme on the Newton integrator's elastic
    # term (extension; requires integrator="newton").  The residual becomes
    # r(v) = (v − vₙ) − dt·M⁻¹·f(xₙ + dt·((1−θ)vₙ + θv)) and the position
    # update uses the matching θ-weighted velocity, so θ = 1 is backward
    # Euler (parity with the existing Newton path, numerically dissipative)
    # and θ = 1/2 is the IMPLICIT MIDPOINT RULE: second-order accurate and
    # energy-conserving for free elastic vibration (backward Euler bleeds
    # kinetic+elastic energy at O(dt) per period; midpoint holds it to
    # roundoff — tests/test_midpoint.py pins both properties).  Gravity /
    # damping / collisions keep the reference's splitting structure;
    # gravity's position contribution becomes trapezoidal (exact for a
    # constant field).  θ < 1/2 would be conditionally stable and is
    # rejected.
    newton_theta: float = 1.0
    # Jacobi sweep semantics: "serial" is the parity default — the
    # reference's jacobi_iter_field_once (implicit.py:391-404) executes as a
    # serial in-place Gauss–Seidel-style sweep (Taichi parallelizes only
    # outermost-scope kernel loops; see PARITY.md).  "snapshot" is the
    # deterministic parallel variant (extension): O(E) matrix-free per
    # iteration, typically needing more iterations per solve.
    jacobi_sweep: str = "serial"
    # Body-body contact (extension, fem_tpu/contact.py).  The reference's
    # bodies never interact (main.py:59-61 steps objects independently);
    # "penalty" adds per-substep particle-particle penalty forces between
    # different bodies (Newton's-third-law exact; momentum-conserving).
    # contact_radius 0 = auto (mean rest edge length over the bodies);
    # contact_stiffness 0 = auto (explicit-stability-limited, contact.py).
    contact: str = "none"
    contact_stiffness: float = 0.0
    contact_radius: float = 0.0
    # Viscous contact friction (extension): per active pair, a dashpot on
    # the full relative velocity, f_i −= c·Σ_j w_ij (v_i − v_j) with
    # w_ij = overlap/radius (smooth 0→1 ramp) and
    # c = contact_friction · √(k_contact·m_min) (≈ pair critical damping at
    # contact_friction ~ 1).  Antisymmetric ⇒ momentum-conserving.  0 = off.
    contact_friction: float = 0.0
    # Coulomb pair friction μ (extension).  Regularized cone: tangential
    # dashpot with slope √(k·m_min), capped at μ·|f_n| per pair — a body
    # resting on another decelerates its slide at μ·g.  Works on both
    # broad phases: dense switches from the matmul trick to explicit
    # (ns_a, ns_b, d) pair tensors (the Coulomb projection needs per-pair
    # vectors; still ~10× faster than the gather-bound grid while the
    # tensors fit — "auto" flips to grid past ~1 GiB/tensor).  0 = off.
    contact_mu: float = 0.0
    # Same-body contact (extension): penalty pairs between surface vertices
    # of ONE body whose REST distance exceeds 2.5·radius (so the rest shape
    # exerts exactly zero self-force; deformation that folds distant surface
    # regions together repels).  Requires contact="penalty".
    self_contact: bool = False
    # Restrict contact pairs to surface vertices (faces' vertex set) — the
    # standard FEM contact discretization (constraints live on the
    # boundary); O(surface²) instead of O(N²) pair work.  In 2D every
    # vertex is in the face set, so this only affects 3D.  Matches
    # all-pairs while penetration stays shallower than the first interior
    # vertex layer; turn off to penalize deep overlaps via interior
    # vertices too.
    contact_surface_only: bool = True
    # Contact pair search strategy (fem_tpu/broadphase.py).  "dense"
    # materializes the O(ns²) pair-coefficient matrices — one matrix
    # product per body pair; its memory grows as ns², so it stops fitting
    # past ~10⁵ participating vertices.
    # "grid" is the structural-scaling path: a uniform grid (cell =
    # contact radius) rebuilt each substep via argsort + searchsorted,
    # O(ns·(3^d+1)/2·cap) candidates in static shapes (forward-only
    # stencil — each pair found once); truncated cells soften the
    # penalty but never break momentum.  "auto" picks the grid exactly
    # when dense is structurally out: more than 8 bodies (trace-time
    # O(B²) pair matmuls), a single pair matrix over ~8 GiB, or — with
    # contact_mu, whose dense form needs explicit (ns_a, ns_b, d) pair
    # tensors — over ~1 GiB per tensor.
    contact_broadphase: str = "auto"
    # Max candidates taken per (vertex, neighbor cell) in grid mode.  A
    # cell holds ~(radius/surface-spacing + 1)^d vertices (≈ 2^d at the
    # auto radius), so 8 is generous; raise for crushed configurations.
    contact_cell_cap: int = 8
    # Adaptive-dt κ-guard (extension, solvers/adaptive.py).  The reference
    # integrates at fixed dt with no stability monitor and silently NaNs
    # when κ = dt²·‖K‖/m → 1 (68k tets at dt=5e-4, the reference's own
    # spot.obj at its default dt by t≈5 s of simulated time).
    # When true, each substep measures κ = max‖A_ii − I‖_F and splits into
    # 2/4/8 state-consistent inner steps at dt/n when it crosses
    # ``adaptive_dt_threshold``.  Off by default: guarded trajectories
    # deviate from fixed-dt parity whenever a split triggers.
    adaptive_dt: bool = False
    adaptive_dt_threshold: float = 0.5
    # CG preconditioning strategy (extension).  "reference" (parity
    # default) honors the `preconditioned` int: 1 = the reference's
    # normal-equations CG (AᵀAx = Aᵀb, implicit.py:289-299 — DOUBLES
    # operator applies and squares the condition number).  "none" forces
    # plain CG.
    # "block_jacobi" runs true PCG on A with M⁻¹ = inverted per-particle
    # d×d diagonal blocks (solvers/implicit.preconditioned_conjugate_
    # gradient) — 1 operator apply/iter, same absolute rᵀr tolerance.
    # "two_level" runs PCG with the coarse-space V-cycle preconditioner
    # (solvers/multilevel.py): damped block-Jacobi smoother for the
    # element-scale top of the spectrum + per-aggregate rigid-body coarse
    # space (dense-factored once per substep) for the smooth bottom — the
    # condition number of the implicit system grows as dt², and this is
    # the fix for the extreme-dt and quasi-static regimes where plain CG
    # ramps or stops converging (ladder: 32/51/69 iters vs plain
    # 160/442/500+-diverged at 16/64/256× the reference dt).  Honest cost
    # model: 3 operator applies/iter — it wins wall-clock only where the
    # iteration cut exceeds ~3× (≈64× dt and up, quasi-statics); at
    # moderate dt plain CG needs fewer applies.
    cg_precond: str = "reference"
    # Coulomb friction coefficient of the unit-box domain walls (extension;
    # 0 = the reference's frictionless per-component zeroing).  Same
    # impulse-level Coulomb model as ObstacleConfig.friction: the removed
    # normal speed bounds the tangential speed reduction, so a body
    # resting on the floor decelerates at μ·g and sticks below the cone.
    wall_friction: float = 0.0
    # Matrix-free operator: "auto"/"graph" run the gather / per-element
    # block product / assembly chain, O(E) per apply, on one device or
    # sharded.  "mxu" asks build_object for the dense edge matrix and
    # applies Sᵀ(K∘(Sx)) on one device (fem_tpu/strategy.py).
    operator_mode: str = "auto"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.integrator not in ("semi_implicit", "newton"):
            raise ValueError(
                f"integrator must be 'semi_implicit' or 'newton', "
                f"got {self.integrator!r}"
            )
        if not 0.5 <= self.newton_theta <= 1.0:
            raise ValueError(
                "newton_theta must be in [0.5, 1.0] (0.5 = implicit "
                f"midpoint, 1.0 = backward Euler), got {self.newton_theta}"
            )
        if self.newton_theta != 1.0 and self.integrator != "newton":
            raise ValueError(
                "newton_theta != 1 requires integrator='newton' (the "
                "semi-implicit reference integrator has no θ-scheme)"
            )
        if self.operator_mode not in OPERATOR_MODES:
            raise ValueError(
                f"operator_mode must be one of {OPERATOR_MODES}, "
                f"got {self.operator_mode!r}"
            )
        if len(self.g_dir) != self.dim:
            raise ValueError(
                f"g_dir has {len(self.g_dir)} components for dim={self.dim}"
            )

    @property
    def frame_time(self) -> float:
        return 1.0 / self.output_fps


def _tupled(seq: Sequence[float]) -> Tuple[float, ...]:
    return tuple(float(x) for x in seq)


def parse_config(data: dict) -> SimConfig:
    """Build a :class:`SimConfig` from the reference JSON schema dict."""
    removed = [k for k in REMOVED_KEYS if k in data]
    if removed:
        raise ValueError(
            f"config key(s) {removed} are no longer supported: the execution "
            "strategy is chosen from the input (fem_tpu/strategy.py)"
        )
    objects = tuple(
        ObjectConfig(
            id=int(o.get("id", 0)),
            rho=float(o.get("rho", 500.0)),
            center=_tupled(o.get("center", (0.5, 0.8))),
            E=float(o.get("E", 4e4)),
            nu=float(o.get("nu", 0.2)),
            damping=float(o.get("damping", 14.5)),
            damping_beta=float(o.get("damping_beta", 0.0)),
            side_length=float(o.get("side_length", 0.2)),
            subdivisions=int(o.get("subdivisions", 10)),
            obj=o.get("obj"),
            material=str(o.get("material", "neo_hookean")),
            plastic_yield=float(o.get("plastic_yield", 0.0)),
            viscous_mu=float(o.get("viscous_mu", 0.0)),
            viscous_tau=float(o.get("viscous_tau", 0.1)),
            pin_boxes=tuple(
                tuple(_tupled(part) for part in box)
                for box in o.get("pin_boxes", ())
            ),
            load_boxes=tuple(
                (_tupled(box[0]), _tupled(box[1]), _tupled(box[2]))
                for box in o.get("load_boxes", ())
            ),
        )
        for o in data.get("objects", [{}])
    )
    blocks = tuple(
        BlockConfig(
            id=int(b.get("id", 0)),
            block_center=_tupled(b.get("block_center", (0.5, 0.5))),
            block_radius=float(b.get("block_radius", 0.0)),
        )
        for b in data.get("blocks", [])
    )
    obstacles = tuple(
        ObstacleConfig(
            type=str(o.get("type", "halfspace")),
            point=_tupled(o.get("point", ())),
            normal=_tupled(o.get("normal", ())),
            lo=_tupled(o.get("lo", ())),
            hi=_tupled(o.get("hi", ())),
            center=_tupled(o.get("center", ())),
            radius=float(o.get("radius", 0.0)),
            obj=o.get("obj"),
            scale=float(o.get("scale", 1.0)),
            offset=_tupled(o.get("offset", (0.0, 0.0, 0.0))),
            resolution=int(o.get("resolution", 48)),
            friction=float(o.get("friction", 0.0)),
        )
        for o in data.get("obstacles", [])
    )
    return SimConfig(
        dim=int(data.get("dim", 2)),
        delta_time=float(data.get("delta_time", 5e-4)),
        sim_count=int(data.get("sim_count", 10)),
        auto_diff=bool(data.get("auto_diff", False)),
        use_explicit_method=bool(data.get("use_explicit_method", True)),
        implicit_method=int(data.get("implicit_method", JACOBI_METHOD)),
        preconditioned=int(data.get("preconditioned", 1)),
        g_dir=_tupled(data.get("g_dir", (0.0, -1.0))),
        is_output_gif=bool(data.get("is_output_gif", False)),
        is_output_obj=bool(data.get("is_output_obj", False)),
        output_fps=int(data.get("output_fps", 60)),
        objects=objects,
        blocks=blocks,
        obstacles=obstacles,
        solver_backend=str(data.get("solver_backend", "auto")),
        robust_inversion=bool(data.get("robust_inversion", False)),
        hessian=str(data.get("hessian", "reference")),
        jacobi_sweep=str(data.get("jacobi_sweep", "serial")),
        contact=str(data.get("contact", "none")),
        contact_stiffness=float(data.get("contact_stiffness", 0.0)),
        contact_radius=float(data.get("contact_radius", 0.0)),
        contact_friction=float(data.get("contact_friction", 0.0)),
        contact_mu=float(data.get("contact_mu", 0.0)),
        self_contact=bool(data.get("self_contact", False)),
        contact_surface_only=bool(data.get("contact_surface_only", True)),
        contact_broadphase=str(data.get("contact_broadphase", "auto")),
        contact_cell_cap=int(data.get("contact_cell_cap", 8)),
        adaptive_dt=bool(data.get("adaptive_dt", False)),
        wall_friction=float(data.get("wall_friction", 0.0)),
        adaptive_dt_threshold=float(data.get("adaptive_dt_threshold", 0.5)),
        cg_precond=str(data.get("cg_precond", "reference")),
        operator_mode=str(data.get("operator_mode", "auto")),
        integrator=str(data.get("integrator", "semi_implicit")),
        newton_iters=int(data.get("newton_iters", 10)),
        newton_cg_iters=int(data.get("newton_cg_iters", 120)),
        newton_tol=float(data.get("newton_tol", 1e-5)),
        newton_hessian=str(data.get("newton_hessian", "exact")),
        newton_theta=float(data.get("newton_theta", 1.0)),
    )


def read_config(file_name: str) -> SimConfig:
    """Load + parse a JSON config file (reference: utils.py:24-32).

    Unlike the reference (which ``exit(3)``-s on any error), this raises so
    callers/tests can handle it; the CLI converts it back to exit code 3.
    """
    with open(file_name, "r") as f:
        return parse_config(json.load(f))
