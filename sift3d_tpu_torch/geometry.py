"""Icosahedral histogram geometry.

As init_geometry (sift.c:148-259): a regular icosahedron inscribed in the
unit sphere; its 12 vertices are the histogram bins and its 20 faces carry
the barycentric interpolation. A face whose normal points inward has its
vertex POSITIONS v0 and v1 swapped, but not its stored bin indices
(sift.c:237-247 swaps tri->v, never tri->idx), so for swapped faces
barycentric weight j still lands in the bin of the unswapped index j.

The Moller-Trumbore test (cart2bary, sift.c:268-327; icos_hist_bin,
sift.c:1254-1291) is rewritten per gradient g and face f as
    det    = g . (e2 x e1)
    bary_y = g . (e2 x (-v0)) / det
    bary_z = g . ((-v0) x e1) / det
    bary_x = 1 - bary_y - bary_z
    k      = (e2 . ((-v0) x e1)) / det
A face is hit iff |det| >= bary_eps, every bary >= -bary_eps and k >= 0;
the first hit in face order wins (sift.c:1277-1286).
"""

from __future__ import annotations

import numpy as np

_GR = 1.6180339887  # golden ratio (sift.c:48)

_VERTS = np.array([
    [0, 1, _GR], [0, -1, _GR], [0, 1, -_GR], [0, -1, -_GR],
    [1, _GR, 0], [-1, _GR, 0], [1, -_GR, 0], [-1, -_GR, 0],
    [_GR, 0, 1], [-_GR, 0, 1], [_GR, 0, -1], [-_GR, 0, -1],
], dtype=np.float32)

FACE_IDX = np.array([
    [0, 1, 8], [0, 8, 4], [0, 4, 5], [0, 5, 9], [0, 9, 1],
    [1, 6, 8], [8, 6, 10], [8, 10, 4], [4, 10, 2], [4, 2, 5],
    [5, 2, 11], [5, 11, 9], [9, 11, 7], [9, 7, 1], [1, 7, 6],
    [3, 6, 7], [3, 7, 11], [3, 11, 2], [3, 2, 10], [3, 10, 6],
], dtype=np.int32)


def _build():
    # Unit-length vertices in float32 (sift.c:226-228).
    verts = _VERTS / np.sqrt(
        np.sum(_VERTS * _VERTS, axis=1, keepdims=True)).astype(np.float32)
    tri_v = verts[FACE_IDX]  # [20, 3(vertex), 3(xyz)], before the swap
    # Outward-normal check and v0<->v1 swap (sift.c:231-247).
    n = np.cross(tri_v[:, 2] - tri_v[:, 1], tri_v[:, 1] - tri_v[:, 0])
    inward = np.einsum("fi,fi->f", n, tri_v[:, 0]) < 0
    tri_v[inward] = tri_v[inward][:, [1, 0, 2]]
    return verts.astype(np.float32), tri_v.astype(np.float32)


VERTS, TRI_V = _build()

_E1 = TRI_V[:, 1] - TRI_V[:, 0]              # [20, 3]
_E2 = TRI_V[:, 2] - TRI_V[:, 0]
_T = -TRI_V[:, 0]
_Q = np.cross(_T, _E1)
DET_VEC = np.cross(_E2, _E1).astype(np.float32)
Y_VEC = np.cross(_E2, _T).astype(np.float32)
Z_VEC = _Q.astype(np.float32)
# k = K_CONST / det (only the sign of k enters the hit test)
K_CONST = np.einsum("fi,fi->f", _E2, _Q).astype(np.float32)

# [3, 60]: columns f, 20+f, 40+f give det_f, ynum_f, znum_f.
MT_MATRIX = np.concatenate([DET_VEC.T, Y_VEC.T, Z_VEC.T],
                           axis=1).astype(np.float32)
