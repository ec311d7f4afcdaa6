# coding=utf-8
"""Mesh construction + element init: volumes, masses, topology (SURVEY §4)."""

import numpy as np
import pytest

from fem_tpu.models.mesh import (
    construct_2d_mesh,
    delaunay_tetrahedralize,
    extract_surface,
    load_stl_file,
    remap_surface,
    winding_number,
)
from fem_tpu.models.state import init_element_data
from fem_tpu.utils.config import ObjectConfig
from tests.utils import make_2d_object, single_tet_object


def test_2d_grid_counts():
    # Reference default: 10 subdivisions -> 121 vertices, 200 triangles
    # (default.json:19-20, object.py:98-111).
    cfg = ObjectConfig(subdivisions=10, side_length=0.2)
    v, f, e = construct_2d_mesh(cfg)
    assert v.shape == (121, 2)
    assert f.shape == (200, 3)
    np.testing.assert_array_equal(f, e)
    assert v.min() == 0.0 and abs(v.max() - 0.2) < 1e-7


def test_2d_grid_total_area_and_mass():
    cfg, obj, state = make_2d_object(subdivisions=5, side_length=0.3)
    vol = np.asarray(obj.volume)
    np.testing.assert_allclose(vol.sum(), 0.3 * 0.3, rtol=1e-5)
    # Lumped mass conserves total mass = rho * area (object.py:358-360).
    np.testing.assert_allclose(
        np.asarray(obj.mass).sum(), cfg.rho * 0.3 * 0.3, rtol=1e-5
    )


def test_single_tet_volume_mass_refinv():
    cfg, obj, state = single_tet_object()
    np.testing.assert_allclose(np.asarray(obj.volume), [1.0 / 6.0], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(obj.mass), np.full(4, cfg.rho / 6.0 / 4.0), rtol=1e-6
    )
    # ref_inv is inverse of rest edge matrix (identity here).
    np.testing.assert_allclose(
        np.asarray(obj.ref_inv)[0], np.eye(3), atol=1e-6
    )


def test_element_init_matches_reference_semantics():
    rng = np.random.default_rng(7)
    verts = rng.normal(size=(4, 3))
    elems = np.array([[0, 1, 2, 3]])
    ref_inv, vol, mass = init_element_data(verts, elems, rho=2.0)
    r = np.stack([verts[i] - verts[0] for i in (1, 2, 3)], axis=1)
    np.testing.assert_allclose(vol[0], abs(np.linalg.det(r)) / 6, rtol=1e-5)
    np.testing.assert_allclose(ref_inv[0], np.linalg.inv(r), rtol=1e-4, atol=1e-5)


def _cube_surface():
    """Unit cube surface (12 triangles) as numpy arrays."""
    v = np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ],
        np.float64,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # bottom z=0 (outward -z)
            [4, 5, 6], [4, 6, 7],  # top z=1
            [0, 1, 5], [0, 5, 4],  # y=0
            [2, 3, 7], [2, 7, 6],  # y=1
            [0, 4, 7], [0, 7, 3],  # x=0
            [1, 2, 6], [1, 6, 5],  # x=1
        ],
        np.int64,
    )
    return v, f


def test_winding_number_cube():
    v, f = _cube_surface()
    inside = np.array([[0.5, 0.5, 0.5], [0.1, 0.9, 0.2]])
    outside = np.array([[1.5, 0.5, 0.5], [-0.2, 0.0, 0.0]])
    assert np.all(winding_number(inside, v, f) > 0.9)
    assert np.all(np.abs(winding_number(outside, v, f)) < 0.1)


def test_ray_parity_inside_matches_winding():
    from fem_tpu.models.mesh import points_inside_mesh

    v, f = _cube_surface()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 1.5, size=(500, 3))
    # Keep points away from the surface (both tests are ill-defined there).
    margin = 0.02
    near = np.any(
        (np.abs(pts) < margin) | (np.abs(pts - 1.0) < margin), axis=1
    )
    pts = pts[~near]
    wn = winding_number(pts, v, f) > 0.5
    rp = points_inside_mesh(pts, v, f)
    np.testing.assert_array_equal(rp, wn)


def test_delaunay_tetrahedralize_cube():
    v, f = _cube_surface()
    nodes, tets = delaunay_tetrahedralize(v, f)
    assert tets.shape[0] >= 5
    p = nodes[tets]
    vol = np.abs(
        np.einsum(
            "ei,ei->e",
            p[:, 1] - p[:, 0],
            np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]),
        )
    ) / 6.0
    # Tetrahedra tile the full cube volume.
    np.testing.assert_allclose(vol.sum(), 1.0, rtol=1e-6)


def test_extract_surface_cube():
    v, f = _cube_surface()
    nodes, tets = delaunay_tetrahedralize(v, f)
    surface, surface_vertex = extract_surface(nodes, tets)
    assert surface.shape[0] == 12  # cube boundary from 8 corner vertices
    assert set(surface_vertex) == set(range(8))
    # Outward orientation: signed volume of the surface is positive.
    p0, p1, p2 = (
        nodes[surface[:, 0]], nodes[surface[:, 1]], nodes[surface[:, 2]],
    )
    signed_vol = np.einsum("ij,ij->i", p0, np.cross(p1, p2)).sum() / 6.0
    np.testing.assert_allclose(signed_vol, 1.0, rtol=1e-6)
    remapped = remap_surface(surface, surface_vertex)
    assert remapped.max() == len(surface_vertex) - 1


def test_collapse_slivers_removes_degenerates():
    from fem_tpu.models.mesh import _tet_volumes, collapse_slivers

    # Two healthy tets + one sliver (4th vertex nearly coplanar).
    pts = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
            [1, 1, 1],
            [0.5, 0.5, 1e-6],  # sliver apex, nearly on the z=0 plane
        ],
        np.float64,
    )
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [0, 1, 2, 5]], np.int64)
    new_pts, new_tets = collapse_slivers(pts, tets)
    from fem_tpu.models.mesh import _tet_quality

    assert _tet_quality(new_pts, new_tets).min() >= 0.01


def test_delaunay_mesh_quality():
    """The native mesher must not emit slivers: minimum shape quality above
    the collapse threshold (raw surface-Delaunay of the blob violates it)."""
    from fem_tpu.models.mesh import _tet_quality, load_obj_file
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "assets", "spot.obj")
    if not os.path.exists(path):
        import subprocess, sys

        subprocess.run(
            [sys.executable, os.path.join(here, "assets", "make_assets.py")],
            check=True,
        )
    v, f = load_obj_file(path)
    nodes, tets = delaunay_tetrahedralize(v, f)
    assert _tet_quality(nodes, tets).min() >= 0.009


def test_mesher_surface_conformity():
    """The tetgen-contract criteria (reference object.py:143): meshed volume
    within 1% of the surface-enclosed volume, every input surface vertex
    present verbatim (first, in input order), element quality at the V/L³
    stability floor AND tetgen's own bounds (mindihedral=10°, radius-edge
    minratio=5.0) — on both the cube and the spot blob."""
    from fem_tpu.models.mesh import (
        _tet_min_dihedral_deg, _tet_quality, _tet_radius_edge_ratio,
        _tet_volumes, enclosed_volume, load_obj_file,
    )
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(here, "assets", "spot.obj")
    if not os.path.exists(path):
        import subprocess, sys

        subprocess.run(
            [sys.executable, os.path.join(here, "assets", "make_assets.py")],
            check=True,
        )
    cases = [_cube_surface(), load_obj_file(path)]
    for v, f in cases:
        nodes, tets = delaunay_tetrahedralize(v, f)
        ev = enclosed_volume(v, f)
        tv = float(_tet_volumes(nodes, tets).sum())
        assert abs(tv - ev) / ev < 0.01, f"volume error {(tv-ev)/ev:.2%}"
        n = v.shape[0]
        assert nodes.shape[0] >= n
        np.testing.assert_array_equal(nodes[:n], np.asarray(v, np.float64))
        assert _tet_quality(nodes, tets).min() >= 0.0099
        assert _tet_min_dihedral_deg(nodes, tets).min() >= 9.99
        assert _tet_radius_edge_ratio(nodes, tets).max() <= 5.01


def test_collapse_slivers_protects_surface_vertices():
    """With protected_count set, protected vertices are never moved or
    merged away; the free sliver apex collapses onto a protected vertex."""
    from fem_tpu.models.mesh import _tet_quality, collapse_slivers

    pts = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
            [1, 1, 1],
            [0.333, 0.333, 1e-6],  # free sliver apex near the z=0 plane
        ],
        np.float64,
    )
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [0, 1, 2, 5]], np.int64)
    new_pts, new_tets = collapse_slivers(pts, tets, protected_count=5)
    np.testing.assert_array_equal(new_pts[:5], pts[:5])  # verbatim
    assert _tet_quality(new_pts, new_tets).min() >= 0.01


def test_remap_surface_unknown_index_raises():
    from fem_tpu.models.mesh import remap_surface

    surface = np.array([[5, 7, 8]], np.int64)
    with pytest.raises((KeyError, IndexError)):
        remap_surface(surface, np.array([5, 7, 9], np.int64))


def test_points_inside_mesh_empty_input():
    from fem_tpu.models.mesh import points_inside_mesh

    v, f = _cube_surface()
    out = points_inside_mesh(np.zeros((0, 3)), v, f)
    assert out.shape == (0,) and out.dtype == bool


def test_obj_loader_welds_uv_seam_duplicates(tmp_path):
    """A textured-style OBJ with duplicated seam vertices must weld into a
    single connected mesh (reference gets this from trimesh processing)."""
    from fem_tpu.models.mesh import find_duplicate_vertex_groups, load_obj_file

    path = tmp_path / "seam.obj"
    path.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "v 1 0 0\nv 0 1 0\nv 1 1 0\n"  # duplicates of v2,v3 (UV seam style)
        "f 1/1 2/2 3/3\nf 4/4 6/6 5/5\n"
    )
    v, f = load_obj_file(str(path))
    assert v.shape[0] == 4  # welded 6 -> 4
    assert f.shape[0] == 2
    assert len(np.unique(f.reshape(-1))) == 4  # both faces share the seam

    v_raw, _ = load_obj_file(str(path), weld=False)
    groups = find_duplicate_vertex_groups(v_raw)
    assert sorted(sorted(g) for g in groups.values()) == [[1, 3], [2, 4]]


def test_stl_roundtrip(tmp_path):
    v, f = _cube_surface()
    # Write a binary STL and read it back.
    tris = v[f].astype(np.float32)
    path = tmp_path / "cube.stl"
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80)
        fh.write(np.uint32(len(f)).tobytes())
        for t in tris:
            fh.write(np.zeros(3, np.float32).tobytes())
            fh.write(t.astype(np.float32).tobytes())
            fh.write(b"\0\0")
    rv, rf = load_stl_file(str(path))
    assert rv.shape == (8, 3)
    assert rf.shape == (12, 3)


def test_construct_3d_grid_mesh():
    """Kuhn 6-tet cells: exact volume tiling, conforming (every interior
    face shared by exactly 2 tets), closed oriented surface."""
    import numpy as np

    from fem_tpu.models.mesh import construct_3d_grid_mesh
    from fem_tpu.utils.config import ObjectConfig

    cfg = ObjectConfig(subdivisions=3, side_length=0.3)
    v, f, t = construct_3d_grid_mesh(cfg)
    assert t.shape == (6 * 27, 4)
    assert v.shape == ((3 + 1) ** 3, 3)
    p = v[t.astype(int)]
    r = np.swapaxes(p[:, 1:, :] - p[:, 0:1, :], -1, -2)
    vol = np.abs(np.linalg.det(r)) / 6.0
    assert vol.min() > 0
    np.testing.assert_allclose(vol.sum(), 0.3 ** 3, rtol=1e-5)
    # Conformity: faces appear exactly once (boundary) or twice (interior).
    local = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    faces = np.sort(t[:, local].reshape(-1, 3), axis=1)
    _, counts = np.unique(faces, axis=0, return_counts=True)
    assert set(counts.tolist()) <= {1, 2}
    # Surface is closed: boundary face count matches extract_surface output.
    assert (counts == 1).sum() == f.shape[0]
