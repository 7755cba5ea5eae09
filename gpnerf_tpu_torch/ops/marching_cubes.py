"""Isosurface extraction (host-side numpy), the port's own copy of
gpnerf_tpu/ops/marching_cubes.py.

Replaces PyMCubes (`mcubes.marching_cubes(cube, th)`, the reference's
BaseRender.py:270 and demo_render.py:372): the mesh paths need neither
PyMCubes nor skimage.

Two extractors:

* `marching_cubes` (default, used by the mesh evaluators): CLASSIC
  marching cubes — one vertex per cut cube edge at the linear-interpolated
  crossing (exactly PyMCubes' vertex placement), triangles from a 256-case
  connectivity table. The table is DERIVED here at import time rather than
  transcribed: each case's surface polygons are traced from a per-face
  marching-squares rule (ambiguous faces — two diagonal corners above —
  always SEPARATE the above corners, i.e. the face center is treated as
  below the isolevel). Because the rule depends only on the face's own
  corner signs, adjacent cells make identical decisions and the mesh is
  watertight by construction — strictly stronger than the classic
  Lorensen–Cline table, whose fixed ambiguity resolutions are known to
  leave cracks. Triangles are consistently oriented (outward from the
  above-isolevel region, positive enclosed volume).

* `marching_tetrahedra`: the round-1..4 extractor (6-tet decomposition,
  ~2x triangles), kept for cross-validation: both tessellate the same
  field and must enclose the same volume.

Vertices are in index coordinates, matching mcubes' convention.
"""

from __future__ import annotations

import numpy as np

# cube corners in (x, y, z) offsets, corner id = x + 2*y + 4*z
_CORNERS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], np.int64
)[:, :]  # (8, 3): id = x + 2y + 4z

# 6-tetrahedra decomposition of the cube around the main diagonal 0-7
# (every tet contains corners 0 and 7; faces between adjacent tets match,
# so the surface is watertight across cells with this uniform split)
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)


def _tet_cases():
    """For each of 16 sign patterns (bit c set = corner c above isolevel),
    the list of triangles as pairs of local corner indices (edges) whose
    crossing points form the triangle, oriented arbitrarily."""
    cases = {}
    for mask in range(16):
        above = [bool(mask >> i & 1) for i in range(4)]
        n_above = sum(above)
        if n_above in (0, 4):
            cases[mask] = []
            continue
        if n_above == 1 or n_above == 3:
            lone = above.index(True) if n_above == 1 else above.index(False)
            others = [i for i in range(4) if i != lone]
            e = [(lone, o) for o in others]
            cases[mask] = [(e[0], e[1], e[2])]
        else:  # 2 above, 2 below -> quad -> 2 triangles
            ab = [i for i in range(4) if above[i]]
            be = [i for i in range(4) if not above[i]]
            e00 = (ab[0], be[0])
            e01 = (ab[0], be[1])
            e10 = (ab[1], be[0])
            e11 = (ab[1], be[1])
            cases[mask] = [(e00, e01, e11), (e00, e11, e10)]
    return cases


_CASES = _tet_cases()


# ----------------------------------------------------------------------
# classic marching cubes: derived 256-case table
# ----------------------------------------------------------------------

# the 12 cube edges as unordered corner-id pairs; edge id = index here
_MC_EDGES = [
    (0, 1), (1, 3), (2, 3), (0, 2),   # z = 0 ring
    (4, 5), (5, 7), (6, 7), (4, 6),   # z = 1 ring
    (0, 4), (1, 5), (3, 7), (2, 6),   # verticals
]
_EDGE_ID = {frozenset(e): i for i, e in enumerate(_MC_EDGES)}


def _mc_faces():
    """The 6 cube faces, each as 4 corner ids in counterclockwise order
    when viewed from OUTSIDE the cube."""
    faces = []
    for axis in range(3):
        for side in (0, 1):
            ids = [c for c in range(8) if _CORNERS[c][axis] == side]
            n_out = np.zeros(3)
            n_out[axis] = -1.0 if side == 0 else 1.0
            # in-plane right-handed basis (u, v, n_out)
            u = np.zeros(3)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n_out, u)
            pos = _CORNERS[ids].astype(np.float64)
            ctr = pos.mean(axis=0)
            ang = np.arctan2((pos - ctr) @ v, (pos - ctr) @ u)
            faces.append([ids[i] for i in np.argsort(ang)])
    return faces


_MC_FACES = _mc_faces()


def _mc_case_triangles(case):
    """Trace the isosurface polygons of one corner-sign configuration.

    Per face, marching squares emits directed segments between the face's
    cut sides — directed so the ABOVE region lies to the left when viewed
    from outside the cube (entering side: below->above walking the face
    CCW). A cut cube edge borders exactly two faces whose CCW orders
    traverse it oppositely, so it is the head of exactly one segment and
    the tail of exactly one other: the segment graph is a union of
    directed cycles. Each cycle, fan-triangulated, is one surface polygon;
    the direction convention makes the triangle normals consistent
    (outward from the above region)."""
    above = [(case >> c) & 1 for c in range(8)]
    out_map = {}
    for fc in _MC_FACES:
        cut = []  # (side index i, tail?) for sides (fc[i], fc[i+1])
        for i in range(4):
            a, b = fc[i], fc[(i + 1) % 4]
            if above[a] != above[b]:
                cut.append(i)
        if not cut:
            continue
        if len(cut) == 2:
            i1, i2 = cut
            a1, b1 = fc[i1], fc[(i1 + 1) % 4]
            e1 = _EDGE_ID[frozenset((a1, b1))]
            a2, b2 = fc[i2], fc[(i2 + 1) % 4]
            e2 = _EDGE_ID[frozenset((a2, b2))]
            if not above[a1] and above[b1]:  # e1 enters the above region
                out_map[e1] = e2
            else:
                out_map[e2] = e1
        else:  # 4 cut sides: signs alternate; separate the above corners
            for i in range(4):
                c = fc[i]
                if above[c]:
                    e_in = _EDGE_ID[frozenset((fc[(i - 1) % 4], c))]
                    e_out = _EDGE_ID[frozenset((c, fc[(i + 1) % 4]))]
                    out_map[e_in] = e_out
    tris = []
    remaining = dict(out_map)
    while remaining:
        start = next(iter(remaining))
        cyc = [start]
        nxt = remaining.pop(start)
        while nxt != start:
            cyc.append(nxt)
            nxt = remaining.pop(nxt)
        for i in range(1, len(cyc) - 1):
            tris.append((cyc[0], cyc[i], cyc[i + 1]))
    return tris


_MC_TABLE = [_mc_case_triangles(case) for case in range(256)]


def _dedup_and_interp(vol, isolevel, ka, kb, shape):
    """Shared tail of both extractors: triangles arrive as (T, 3) pairs of
    global corner keys (ka, kb) per vertex; deduplicate the unordered edge
    keys, linearly interpolate one vertex per unique cut edge
    (t = (iso - va) / (vb - va), PyMCubes' placement), drop degenerates."""
    X, Y, Z = shape
    lo = np.minimum(ka, kb)
    hi = np.maximum(ka, kb)
    nkeys = (X + 1) * (Y + 1) * (Z + 1)
    edge_keys = lo.astype(np.int64) * nkeys + hi.astype(np.int64)

    flat = edge_keys.reshape(-1)
    uniq, inv = np.unique(flat, return_inverse=True)
    triangles = inv.reshape(-1, 3)

    ulo = (uniq // nkeys).astype(np.int64)
    uhi = (uniq % nkeys).astype(np.int64)

    def key_to_pos(k):
        z = k % (Z + 1)
        y = (k // (Z + 1)) % (Y + 1)
        x = k // ((Z + 1) * (Y + 1))
        return np.stack([x, y, z], -1).astype(np.float64)

    pa = key_to_pos(ulo)
    pb = key_to_pos(uhi)
    ia = pa.astype(np.int64)
    ib = pb.astype(np.int64)
    va = vol[ia[:, 0], ia[:, 1], ia[:, 2]]
    vb = vol[ib[:, 0], ib[:, 1], ib[:, 2]]
    denom = vb - va
    tvals = np.where(np.abs(denom) > 1e-30, (isolevel - va) / denom, 0.5)
    tvals = np.clip(tvals, 0.0, 1.0)
    vertices = pa + tvals[:, None] * (pb - pa)

    good = (
        (triangles[:, 0] != triangles[:, 1])
        & (triangles[:, 1] != triangles[:, 2])
        & (triangles[:, 0] != triangles[:, 2])
    )
    return vertices, triangles[good]


def _corner_keys(cells, cids, Y, Z):
    """Global grid-corner key for corner id `cids` of each cell."""
    p = cells + _CORNERS[cids]
    return (p[:, 0] * (Y + 1) + p[:, 1]) * (Z + 1) + p[:, 2]


def _active_cells(vol, isolevel):
    X, Y, Z = vol.shape
    corner_vals = np.empty((X - 1, Y - 1, Z - 1, 8), np.float64)
    for c, (cx, cy, cz) in enumerate(_CORNERS):
        corner_vals[..., c] = vol[cx : cx + X - 1, cy : cy + Y - 1,
                                  cz : cz + Z - 1]
    above8 = corner_vals > isolevel
    active = above8.any(-1) & ~above8.all(-1)
    cells = np.argwhere(active).astype(np.int64)  # (C, 3)
    return cells, above8[active]


def marching_cubes(volume, isolevel):
    """Classic marching cubes. volume: (X, Y, Z) scalar field. Returns
    (vertices (N, 3) float64 in (x, y, z) index coordinates, triangles
    (M, 3) int64) — one vertex per cut grid edge (deduplicated across
    cells), consistently outward-oriented triangles."""
    vol = np.asarray(volume, np.float64)
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    cells, cabove = _active_cells(vol, isolevel)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    case_idx = (cabove.astype(np.int64) << np.arange(8)).sum(axis=1)
    tri_a, tri_b = [], []
    for case in np.unique(case_idx):
        tris = _MC_TABLE[case]
        if not tris:
            continue
        cell_sel = cells[case_idx == case]
        for tri in tris:
            a_ids = np.array([_MC_EDGES[e][0] for e in tri], np.int64)
            b_ids = np.array([_MC_EDGES[e][1] for e in tri], np.int64)
            ka = np.stack([_corner_keys(cell_sel, a, Y, Z) for a in a_ids], -1)
            kb = np.stack([_corner_keys(cell_sel, b, Y, Z) for b in b_ids], -1)
            tri_a.append(ka)
            tri_b.append(kb)
    if not tri_a:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return _dedup_and_interp(
        vol, isolevel, np.concatenate(tri_a), np.concatenate(tri_b),
        (X, Y, Z),
    )


def marching_tetrahedra(volume, isolevel):
    """6-tet decomposition extractor (the round-1..4 `marching_cubes`):
    same interpolated crossings on a finer (tet-edge) set, ~2x triangles,
    arbitrary orientation. Kept for cross-validation and as a fallback."""
    vol = np.asarray(volume, np.float64)
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    cells, cabove = _active_cells(vol, isolevel)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tri_edge_a = []
    tri_edge_b = []  # parallel lists of (T, 3) corner-key pairs
    for t in range(6):
        tet = _TETS[t]
        tmask = np.zeros(len(cells), np.int64)
        for i in range(4):
            tmask |= cabove[:, tet[i]].astype(np.int64) << i
        for mask in range(1, 15):
            m = tmask == mask
            if not m.any():
                continue
            for tri in _CASES[mask]:
                a_ids = np.array([tet[e[0]] for e in tri], np.int64)
                b_ids = np.array([tet[e[1]] for e in tri], np.int64)
                cell_sel = cells[m]
                ka = np.stack(
                    [_corner_keys(cell_sel, a, Y, Z) for a in a_ids], -1
                )
                kb = np.stack(
                    [_corner_keys(cell_sel, b, Y, Z) for b in b_ids], -1
                )
                tri_edge_a.append(ka)
                tri_edge_b.append(kb)

    if not tri_edge_a:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return _dedup_and_interp(
        vol, isolevel, np.concatenate(tri_edge_a),
        np.concatenate(tri_edge_b), (X, Y, Z),
    )
