"""Isosurface extraction (marching tetrahedra) for 3D volume views.

The reference's ``MRIDataset.plot3D`` draws a plotly isosurface
(``src/datatype.py:96-122``); plotly is not in this image and neither is
skimage's marching cubes, so this module implements the capability
natively: a vectorized numpy marching-tetrahedra triangulation (each
grid cube split into 6 tetrahedra around the 0-6 diagonal; per-tet
iso-triangulation has only 16 programmatically-derivable cases — no
256-entry cube tables to transcribe) plus a matplotlib ``plot_trisurf``
wrapper.  Host-side viz only; never on the compute path.
"""

from __future__ import annotations

import numpy as np

# Cube corner offsets, indexed 0..7 (standard MC corner order).
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ]
)

# Six tetrahedra covering the cube, all sharing the 0-6 diagonal.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)

# Tetrahedron edges as (local corner a, local corner b) index pairs.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_cases():
    """case_code (bitmask of inside corners) -> list of triangles, each a
    triple of edge indices into ``_TET_EDGES``.  Derived, not transcribed:
    one inside (or outside) corner cuts a triangle; two cut a quad."""
    edge_of = {e: i for i, e in enumerate(_TET_EDGES)}

    def edge(a, b):
        return edge_of[(a, b)] if (a, b) in edge_of else edge_of[(b, a)]

    cases = {}
    for code in range(16):
        inside = [v for v in range(4) if code & (1 << v)]
        tris = []
        if len(inside) in (1, 3):
            a = inside[0] if len(inside) == 1 else [
                v for v in range(4) if v not in inside
            ][0]
            others = [v for v in range(4) if v != a]
            tris.append(tuple(edge(a, o) for o in others))
        elif len(inside) == 2:
            a, b = inside
            c, d = [v for v in range(4) if v not in inside]
            # quad across edges (a,c),(a,d),(b,d),(b,c) -> two triangles
            tris.append((edge(a, c), edge(a, d), edge(b, d)))
            tris.append((edge(a, c), edge(b, d), edge(b, c)))
        cases[code] = tris
    return cases


_CASES = _tet_cases()


def marching_tetrahedra(volume, level: float, step: int = 1):
    """Extract the ``volume == level`` isosurface.

    Args:
      volume: 3D array.
      level: iso value.
      step: voxel stride (decimation) — a 256^3 volume at step 1 visits
        16.6M cubes; ``step=4`` is plenty for display.
    Returns:
      ``(verts, faces)``: ``(V, 3)`` float vertex coordinates in voxel
      units (x, y, z = axis 0, 1, 2 indices) and ``(F, 3)`` int triangle
      indices.  Empty arrays when the level is outside the data range.
    """
    v = np.asarray(volume, dtype=np.float64)
    if v.ndim != 3:
        raise ValueError(f"need a 3D volume, got shape {v.shape}")
    if step > 1:
        v = v[::step, ::step, ::step]
    d, h, w = v.shape
    if min(d, h, w) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    # corner values for every cube: (8, d-1, h-1, w-1)
    corner_vals = np.stack(
        [
            v[cx : cx + d - 1, cy : cy + h - 1, cz : cz + w - 1]
            for cx, cy, cz in _CORNERS
        ]
    ).reshape(8, -1)
    base = np.stack(
        np.meshgrid(
            np.arange(d - 1), np.arange(h - 1), np.arange(w - 1), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)

    verts_out = []
    for tet in _TETS:
        vals = corner_vals[tet]  # (4, n_cubes)
        code = (
            (vals[0] > level).astype(np.int8)
            | ((vals[1] > level) << 1)
            | ((vals[2] > level) << 2)
            | ((vals[3] > level) << 3)
        )
        for c in range(1, 15):
            tris = _CASES[c]
            if not tris:
                continue
            sel = np.nonzero(code == c)[0]
            if sel.size == 0:
                continue
            for tri in tris:
                tri_pts = []
                for ei in tri:
                    a, b = _TET_EDGES[ei]
                    va, vb = vals[a, sel], vals[b, sel]
                    # linear interpolation along the edge; guarded for
                    # va == vb (can't happen when the edge crosses, but
                    # keeps the math NaN-free)
                    t = np.clip((level - va) / np.where(vb != va, vb - va, 1.0), 0, 1)
                    pa = base[sel] + _CORNERS[tet[a]]
                    pb = base[sel] + _CORNERS[tet[b]]
                    tri_pts.append(pa + t[:, None] * (pb - pa))
                verts_out.append(np.stack(tri_pts, axis=1))  # (n, 3, 3)

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tris = np.concatenate(verts_out)  # (F, 3 verts, 3 coords)
    flat = tris.reshape(-1, 3) * step
    # merge duplicate vertices so the mesh is indexed
    uniq, inverse = np.unique(
        np.round(flat * 1e6).astype(np.int64), axis=0, return_inverse=True
    )
    verts = np.zeros((len(uniq), 3))
    verts[inverse] = flat
    faces = inverse.reshape(-1, 3)
    # drop degenerate triangles (two corners merged)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def plot_volume_isosurface(
    volume, level: float | None = None, step: int | None = None, ax=None, **trisurf_kw
):
    """Matplotlib isosurface view of a volume — capability parity with
    the reference's plotly ``MRIDataset.plot3D`` (``src/datatype.py:96-122``).

    ``level`` defaults to the reference's isosurface band midpoint
    behaviour (halfway between min and max); ``step`` auto-decimates so
    the marching grid stays <= ~96^3.
    """
    import matplotlib.pyplot as plt

    v = np.asarray(volume)
    if level is None:
        level = float(v.min() + 0.5 * (v.max() - v.min()))
    if step is None:
        step = max(1, int(np.ceil(max(v.shape) / 96)))
    verts, faces = marching_tetrahedra(v, level, step=step)
    if ax is None:
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
    if len(faces):
        trisurf_kw.setdefault("cmap", "viridis")
        trisurf_kw.setdefault("linewidth", 0)
        ax.plot_trisurf(
            verts[:, 0], verts[:, 1], faces, verts[:, 2], **trisurf_kw
        )
    ax.set_box_aspect(v.shape)
    ax.set_title(f"isosurface @ {level:.3g}")
    return ax
