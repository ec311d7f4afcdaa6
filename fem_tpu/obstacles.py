# coding=utf-8
"""SDF obstacle extensions: half-spaces, solid boxes, spheres, mesh SDFs.

The reference's only obstacles are circles (circle_blocks.py:6-25) plus the
sticky unit-box walls (solver/kinematic.py:25-30).  These extensions
generalize the reference's circle *slide* collision semantics
(kinematic.py:36-41: inside and moving inward → remove the radial velocity
component) to arbitrary signed distance fields φ with outward normal
n = ∇φ/|∇φ|:

    hit = (φ(x) < 0) ∧ (v·n < 0);      v ← v − (v·n)·n

Obstacle types (SimConfig.obstacles, ``utils/config.ObstacleConfig``):

* ``halfspace`` — φ(x) = n̂·(x − p); an infinite wall with any orientation
  (the reference box is axis-aligned only).  Solid side: n̂·(x−p) < 0.
* ``box`` — a SOLID axis-aligned box [lo, hi] (the reference's box is the
  hollow *domain boundary*); φ < 0 inside, outward normal = nearest face.
* ``sphere`` — folded directly into the reference circle arrays (the circle
  math is dimension-generic — identical semantics, just named for 3D).
* ``mesh`` — a rigid triangle-mesh obstacle via a precomputed signed
  distance grid (3D): host-side build samples the surface (KD-tree unsigned
  distance) and signs it with the ray-parity inside test
  (models/mesh.points_inside_mesh — the native C++ grid-accelerated kernel
  when built); device-side φ is a trilinear sample and the normal a central
  difference — pure XLA gathers.

Design notes: all obstacle data are small static arrays on the
``Obstacles`` pytree; each obstacle is applied sequentially (the reference's
circle loop semantics — each sees the velocity already modified by the
previous one) with fixed shapes, so the whole collision pass fuses into the
advection kernel under jit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------

def build_mesh_sdf(
    path: str,
    scale: float = 1.0,
    offset: Sequence[float] = (0.0, 0.0, 0.0),
    resolution: int = 48,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Signed-distance grid of a (closed) triangle mesh obstacle.

    Returns ``(grid (nx, ny, nz) float32, origin (3,), spacing)`` with cubic
    cells: ``spacing = max_extent / resolution`` and a 3-cell margin all
    around (margin cells are strictly outside, so clamped samples of
    out-of-grid points read positive φ — no spurious hits).

    Distance accuracy: unsigned distance is the KD-tree distance to a
    surface sampling whose density matches the grid spacing (triangles are
    barycentrically over-sampled until sub-edge < spacing), so the error is
    O(spacing) — the same order as the trilinear reconstruction itself.
    """
    from scipy.spatial import cKDTree

    from fem_tpu.models.mesh import load_obj_file, points_inside_mesh

    v, f = load_obj_file(path)
    v = v * float(scale) + np.asarray(offset, np.float64)[None, :]
    lo, hi = v.min(0), v.max(0)
    spacing = float((hi - lo).max()) / float(resolution)
    margin = 3
    origin = lo - margin * spacing
    counts = np.ceil((hi - lo) / spacing).astype(int) + 2 * margin + 1

    # Surface sampling: subdivide each triangle until sample spacing is
    # below the grid spacing (cap keeps degenerate configs bounded).
    tri = v[f]  # (F, 3, 3)
    edge = np.linalg.norm(
        tri - np.roll(tri, 1, axis=1), axis=-1
    ).max(axis=1)  # (F,) max edge length
    samples = [v]
    # Per-face subdivision count, capped (large faces get the cap — their
    # residual sampling error is bounded by edge/cap, still O(spacing) for
    # sane resolutions since the cap scales the densest bucket).
    cap = 24
    n_sub_f = np.clip(np.ceil(edge / spacing).astype(int), 1, cap)
    for n_sub in range(1, cap + 1):
        sel = n_sub_f == n_sub
        if not sel.any():
            continue
        t = tri[sel]
        ij = [
            (i, j)
            for i in range(n_sub + 1)
            for j in range(n_sub + 1 - i)
        ]
        w = np.array(
            [(i / n_sub, j / n_sub, 1.0 - (i + j) / n_sub) for i, j in ij],
            np.float64,
        )  # (S, 3) barycentric
        samples.append(np.einsum("sk,fkd->fsd", w, t).reshape(-1, 3))
    surf = np.concatenate(samples, axis=0)

    ax = [origin[i] + spacing * np.arange(counts[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    dist, _ = cKDTree(surf).query(pts, workers=-1)
    # The +z ray-parity test resolves points exactly on a projected face
    # edge by a shifted-epsilon rule that can still miss on the shared
    # DIAGONAL of two coplanar triangles; regular grid points over
    # synthetic axis-aligned meshes hit that measure-zero set routinely.
    # A tiny irrational xy jitter of the sign queries (distance is
    # unaffected) breaks the degeneracy at O(1e-4·spacing) cost.
    eps = spacing * np.array([1.37e-4, 2.71e-4, 0.0])
    inside = points_inside_mesh(pts + eps[None, :], v, f)
    phi = np.where(inside, -dist, dist).astype(np.float32)
    return phi.reshape(tuple(counts)), origin.astype(np.float32), spacing


def build_extension_arrays(
    obstacle_cfgs, dim: int
) -> Tuple[dict, list]:
    """Host-side assembly of the SDF extension arrays for ``Obstacles``.

    Returns ``(fields, extra_spheres)``: ``fields`` is a dict of the
    extension fields (``None`` when a type is absent), ``extra_spheres`` a
    list of ``(center, radius)`` to append to the reference circle arrays.
    Spheres with ``friction > 0`` stay on the extension path instead
    (``sph_c``/``sph_r``) — the reference circle arrays carry no
    per-obstacle friction.
    """
    halves_p, halves_n, box_lo, box_hi = [], [], [], []
    grids, origins, spacings = [], [], []
    half_f, box_f, sdf_f, sph_f = [], [], [], []
    sph_c, sph_r = [], []
    spheres = []
    for oc in obstacle_cfgs:
        kind = oc.type
        mu = float(getattr(oc, "friction", 0.0))
        if mu < 0.0:
            raise ValueError("obstacle friction must be >= 0")
        if kind == "sphere":
            if mu > 0.0:
                sph_c.append(np.asarray(oc.center, np.float32))
                sph_r.append(float(oc.radius))
                sph_f.append(mu)
            else:
                spheres.append((tuple(oc.center), float(oc.radius)))
        elif kind == "halfspace":
            n = np.asarray(oc.normal, np.float32)
            norm = float(np.linalg.norm(n))
            if norm == 0.0:
                raise ValueError("halfspace obstacle needs a nonzero normal")
            halves_p.append(np.asarray(oc.point, np.float32))
            halves_n.append(n / norm)
            half_f.append(mu)
        elif kind == "box":
            box_lo.append(np.asarray(oc.lo, np.float32))
            box_hi.append(np.asarray(oc.hi, np.float32))
            box_f.append(mu)
        elif kind == "mesh":
            if dim != 3:
                raise ValueError("mesh obstacles are 3D only")
            g, o, s = build_mesh_sdf(
                oc.obj, oc.scale, oc.offset, oc.resolution
            )
            grids.append(g)
            origins.append(o)
            spacings.append(s)
            sdf_f.append(mu)
        else:
            raise ValueError(f"unknown obstacle type {kind!r}")
    fields = dict(
        half_p=None, half_n=None, box_lo=None, box_hi=None,
        sdf_grid=None, sdf_origin=None, sdf_spacing=None,
        sph_c=None, sph_r=None,
        half_f=tuple(half_f), box_f=tuple(box_f), sdf_f=tuple(sdf_f),
        sph_f=tuple(sph_f),
    )
    if halves_p:
        fields["half_p"] = jnp.asarray(np.stack(halves_p))
        fields["half_n"] = jnp.asarray(np.stack(halves_n))
    if box_lo:
        fields["box_lo"] = jnp.asarray(np.stack(box_lo))
        fields["box_hi"] = jnp.asarray(np.stack(box_hi))
    if sph_c:
        fields["sph_c"] = jnp.asarray(np.stack(sph_c))
        fields["sph_r"] = jnp.asarray(np.asarray(sph_r, np.float32))
    if grids:
        shapes = {g.shape for g in grids}
        if len(shapes) > 1:
            # Stacked storage requires one resolution; re-sample is the
            # caller's job (set the same `resolution` per mesh obstacle).
            raise ValueError(
                f"all mesh obstacles must share one grid shape, got {shapes}"
            )
        fields["sdf_grid"] = jnp.asarray(np.stack(grids))
        fields["sdf_origin"] = jnp.asarray(np.stack(origins))
        fields["sdf_spacing"] = jnp.asarray(
            np.asarray(spacings, np.float32)
        )
    return fields, spheres


# ---------------------------------------------------------------------------
# Device-side signed distance + normals
# ---------------------------------------------------------------------------

def sample_sdf_grid(
    grid: jnp.ndarray,  # (nx, ny, nz)
    origin: jnp.ndarray,  # (3,)
    spacing: jnp.ndarray,  # scalar
    pts: jnp.ndarray,  # (N, 3)
) -> jnp.ndarray:
    """Trilinear sample of one SDF grid at ``pts`` → (N,).  Out-of-grid
    points clamp to the (strictly positive) margin cells."""
    n = jnp.asarray(grid.shape, jnp.float32)
    u = (pts - origin[None, :]) / spacing
    u = jnp.clip(u, 0.0, n[None, :] - 1.001)
    i0 = jnp.floor(u).astype(jnp.int32)  # (N, 3)
    f = u - i0.astype(jnp.float32)
    flat = grid.reshape(-1)
    sy, sz = grid.shape[1] * grid.shape[2], grid.shape[2]

    def corner(dx, dy, dz):
        idx = (
            (i0[:, 0] + dx) * sy + (i0[:, 1] + dy) * sz + (i0[:, 2] + dz)
        )
        return flat[idx]

    w = lambda fc, d: jnp.where(d == 1, fc, 1.0 - fc)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                out = out + (
                    w(f[:, 0], dx) * w(f[:, 1], dy) * w(f[:, 2], dz)
                    * corner(dx, dy, dz)
                )
    return out


def _mesh_phi_normal(
    grid, origin, spacing, pos
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(φ (N,1), outward unit normal (N,d)) of one mesh-SDF obstacle;
    normal from central differences at half-cell offsets."""
    phi = sample_sdf_grid(grid, origin, spacing, pos)[:, None]
    h = 0.5 * spacing
    comps = []
    for ax in range(3):
        e = jnp.zeros((1, 3), jnp.float32).at[0, ax].set(h)
        comps.append(
            sample_sdf_grid(grid, origin, spacing, pos + e)
            - sample_sdf_grid(grid, origin, spacing, pos - e)
        )
    g = jnp.stack(comps, axis=-1)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    return phi, g / jnp.maximum(norm, 1e-20)


def _box_phi_normal(lo, hi, pos) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(φ (N,1), outward unit normal (N,d)) of one SOLID axis-aligned box.
    Only the interior branch matters for the slide test (φ < 0): φ is the
    negated distance to the nearest face, the normal that face's axis."""
    d = pos.shape[1]
    dlo = pos - lo[None, :]  # (N, d) distance above each lo face
    dhi = hi[None, :] - pos  # (N, d) distance below each hi face
    d2 = jnp.concatenate([dlo, dhi], axis=1)  # (N, 2d)
    inside = jnp.all(d2 > 0.0, axis=1, keepdims=True)
    mind = jnp.min(d2, axis=1, keepdims=True)
    phi = jnp.where(inside, -mind, jnp.maximum(-mind, 1e-6))
    face = jnp.argmin(d2, axis=1)  # (N,) nearest face id
    axis = face % d
    sign = jnp.where(face < d, -1.0, 1.0)  # lo faces point −axis
    normal = sign[:, None] * jnp.eye(d, dtype=pos.dtype)[axis]
    return phi, normal


def _slide(v, phi, normal, mu: float = 0.0):
    """Reference circle slide semantics on an SDF (kinematic.py:36-41):
    penetrating and moving inward → remove the normal velocity component.
    Returns (v', hit (N,1), normal, s (N,1) tangential Coulomb scale).

    ``mu`` > 0 (extension — ObstacleConfig.friction) additionally applies
    an impulse-level Coulomb cone: the normal impulse removed the speed
    |v_n|, so the tangential speed drops by min(μ·|v_n|, |v_t|), i.e. the
    tangential velocity scales by s = max(0, 1 − μ·|v_n|/|v_t|).  μ = 0
    compiles to the exact reference slide (s ≡ 1 never materializes)."""
    vn = jnp.sum(v * normal, axis=-1, keepdims=True)
    hit = (phi < 0.0) & (vn < 0.0)
    v_t = v - vn * normal  # tangential part (zero normal component)
    if mu > 0.0:
        t_speed = jnp.sqrt(jnp.sum(v_t * v_t, axis=-1, keepdims=True))
        s = jnp.maximum(0.0, 1.0 - mu * (-vn) / jnp.maximum(t_speed, 1e-20))
        return jnp.where(hit, s * v_t, v), hit, normal, s
    return jnp.where(hit, v_t, v), hit, normal, None


def _iter_obstacles(obstacles, pos):
    """Yield (φ, normal, μ) per extension obstacle, in config order class
    by class: halfspaces, boxes, frictional spheres, mesh SDFs
    (frictionless circles/spheres ride the reference loop in
    solvers/advect.py)."""

    def _mu(fric, k):
        return float(fric[k]) if k < len(fric) else 0.0

    if obstacles.half_p is not None:
        for k in range(int(obstacles.half_p.shape[0])):
            p, n = obstacles.half_p[k], obstacles.half_n[k]
            phi = jnp.sum(
                (pos - p[None, :]) * n[None, :], axis=-1, keepdims=True
            )
            normal = jnp.broadcast_to(n[None, :], pos.shape)
            yield phi, normal, _mu(obstacles.half_f, k)
    if obstacles.box_lo is not None:
        for k in range(int(obstacles.box_lo.shape[0])):
            phi, normal = _box_phi_normal(
                obstacles.box_lo[k], obstacles.box_hi[k], pos
            )
            yield phi, normal, _mu(obstacles.box_f, k)
    if obstacles.sph_c is not None:
        for k in range(int(obstacles.sph_c.shape[0])):
            disp = pos - obstacles.sph_c[k][None, :]
            dist = jnp.sqrt(
                jnp.sum(disp * disp, axis=-1, keepdims=True)
            )
            phi = dist - obstacles.sph_r[k]
            normal = disp / jnp.maximum(dist, 1e-20)
            yield phi, normal, _mu(obstacles.sph_f, k)
    if obstacles.sdf_grid is not None:
        for k in range(int(obstacles.sdf_grid.shape[0])):
            phi, normal = _mesh_phi_normal(
                obstacles.sdf_grid[k], obstacles.sdf_origin[k],
                obstacles.sdf_spacing[k], pos,
            )
            yield phi, normal, _mu(obstacles.sdf_f, k)


def has_extensions(obstacles) -> bool:
    return (
        obstacles.half_p is not None
        or obstacles.box_lo is not None
        or obstacles.sph_c is not None
        or obstacles.sdf_grid is not None
    )


def apply_extensions_explicit(
    pos: jnp.ndarray, v: jnp.ndarray, obstacles
) -> jnp.ndarray:
    """Sequential slide collisions of all extension obstacles (explicit
    advection) — each obstacle sees the velocity already modified by the
    previous one, matching the reference's circle loop."""
    for phi, normal, mu in _iter_obstacles(obstacles, pos):
        v, _, _, _ = _slide(v, phi, normal, mu)
    return v


def apply_extensions_implicit(
    pos: jnp.ndarray,
    v: jnp.ndarray,
    vel: jnp.ndarray,
    vel_g: jnp.ndarray,
    obstacles,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Implicit-advection variant: the hit test runs on the combined
    velocity v = vel + vel_g, and on hit the normal component is removed
    from each channel separately — the exact structure of the reference's
    implicit circle handling (solver/implicit.py:424-436).  With friction
    the per-channel map on hit is u → s·(u − (u·n)n): linear, so the
    channel sum stays consistent with the combined v."""
    for phi, normal, mu in _iter_obstacles(obstacles, pos):
        v, hit, n, s = _slide(v, phi, normal, mu)
        scale = 1.0 if s is None else s

        def chan(u):
            u_t = u - jnp.sum(u * n, axis=-1, keepdims=True) * n
            return jnp.where(hit, scale * u_t, u)

        vel = chan(vel)
        vel_g = chan(vel_g)
    return v, vel, vel_g
