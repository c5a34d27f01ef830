"""Band / ribbon / hyperstreamline meshing (oriented elliptic tubes).

Counterpart of `linevis_tpu/geometry/bands.py`. Behavioral reference:
`createTriangleEllipticTubesRenderDataCPU`
(`src/Renderers/Tubes/TriangleTubesCPU.cpp:124-216`) and
`createTrianglePrincipalStressTubesRenderDataCPU` (`:220-330`), driven by
`LineDataStress` band render modes RIBBONS / EIGENVALUE_RATIO /
HYPERSTREAMLINES (`src/LineData/LineDataStress.hpp:224-229`,
`LineDataStress.cpp:2654-2692`) and flow ribbons
(`src/LineData/LineDataFlow.hpp:158-161`).

Frame convention (reference TriangleTubesCPU.cpp:252-268): tangent by
central differences, normal = cross(right_vector, tangent), binormal =
cross(tangent, normal); the ellipse's "normal" axis is the thin axis
(radius = band_width/2 * min_band_thickness for ribbons) and the
"binormal" axis the wide axis along the band right vector.

All lines mesh at once from padded [L, P] arrays into the grid-shaped
`TubeMesh` of `geometry/tubes.py` ([3, S, L, P]).
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.geometry.tubes import TubeMesh, _tube_topology, tube_ring_directions

__all__ = [
    "build_band_tube_mesh",
    "build_principal_stress_tube_mesh",
    "central_difference_tangents",
]

# Reference defaults (LineData.cpp:53-54, LineDataStress hyperstreamlines).
MIN_BAND_THICKNESS = 0.15
MIN_HYPERSTREAMLINE_WIDTH = 0.02


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))


def central_difference_tangents(positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[L, P, 3], [L, P] -> [L, P, 3] unit tangents (fwd/central/bwd)."""
    p = positions
    fwd = torch.roll(p, -1, dims=1) - p  # p[i+1] - p[i]
    bwd = p - torch.roll(p, 1, dims=1)
    m_next = torch.roll(mask, -1, dims=1)
    m_next[:, -1] = False
    m_prev = torch.roll(mask, 1, dims=1)
    m_prev[:, 0] = False
    central = torch.where(
        (m_next & m_prev)[..., None], fwd + bwd,
        torch.where(m_next[..., None], fwd, bwd),
    )
    return central / torch.clamp(_norm(central, -1), min=1e-8)


def _oriented_ellipse_grids(positions, mask, attrs, right, r_normal, r_binormal,
                            num_subdivisions: int):
    """The band mesh's grids: positions [L, P, 3], mask and attrs [L, P],
    right vectors [L, P, 3], thin- and wide-axis radii [L, P] -> vertices,
    normals, tangents [3, S, L, P] and attributes [S, L, P]."""
    L, P = positions.shape[0], positions.shape[1]
    S = num_subdivisions
    tangent = central_difference_tangents(positions, mask)
    normal = torch.linalg.cross(right, tangent, dim=-1)
    normal = normal / torch.clamp(_norm(normal, -1), min=1e-8)
    binormal = torch.linalg.cross(tangent, normal, dim=-1)

    def cf(x):  # [L, P, 3] -> [3, 1, L, P]
        return x.reshape(L * P, 3).T.reshape(3, 1, L, P)

    pos_c, n_c, b_c, t_c = cf(positions), cf(normal), cf(binormal), cf(tangent)
    rn = r_normal.reshape(1, 1, L, P)
    rb = r_binormal.reshape(1, 1, L, P)

    ring = torch.tensor(tube_ring_directions(S), device=positions.device)  # [S, 2]
    cosr = ring[:, 0].reshape(1, S, 1, 1)
    sinr = ring[:, 1].reshape(1, S, 1, 1)
    verts = pos_c + (cosr * rn) * n_c + (sinr * rb) * b_c
    # Ellipse surface normal: gradient direction (rb*cos along normal axis,
    # rn*sin along binormal axis) — TriangleTubesCPU.cpp:311-313.
    nrm = (cosr * rb) * n_c + (sinr * rn) * b_c
    vnorm = nrm / torch.clamp(_norm(nrm, 0), min=1e-8)
    vtang = t_c.expand(3, S, L, P).contiguous()
    vattr = attrs[None].expand(S, L, P).contiguous()
    return verts, vnorm, vtang, vattr


def _band_mesh(positions, mask, attrs, right, r_normal, r_binormal, num_subdivisions):
    """The whole band mesh of `_oriented_ellipse_grids`' grids."""
    L, P = int(positions.shape[0]), int(positions.shape[1])
    S = int(num_subdivisions)
    verts, vnorm, vtang, vattr = _oriented_ellipse_grids(
        positions, mask, attrs, right, r_normal, r_binormal, S)
    return _finish_mesh(verts, vnorm, vtang, vattr, mask, L, P, S)


def _finish_mesh(verts, vnorm, vtang, vattr, mask, L, P, S) -> TubeMesh:
    seg_valid = mask[:, :-1] & mask[:, 1:]
    return TubeMesh(
        positions=verts, normals=vnorm, tangents=vtang, attrs=vattr, mask=mask,
        triangles=torch.tensor(_tube_topology(L, P, S), device=mask.device),
        triangle_mask=seg_valid[None, None].expand(S, 2, L, P - 1).reshape(-1),
        num_subdivisions=S,
    )


def _inputs(positions, mask, attrs, right_vectors, device):
    return (_as_tensor(positions, torch.float32, device), _as_tensor(mask, torch.bool, device),
            _as_tensor(attrs, torch.float32, device),
            _as_tensor(right_vectors, torch.float32, device))


def build_band_tube_mesh(
    positions,  # [L, P, 3]
    mask,  # [L, P]
    attrs,  # [L, P]
    right_vectors,  # [L, P, 3]
    band_width: float = 0.005,
    min_band_thickness: float = MIN_BAND_THICKNESS,
    num_subdivisions: int = 8,
    device="cuda",
) -> TubeMesh:
    """RIBBONS band mode / flow ribbons on `device`: constant elliptic
    cross-section, wide axis = band_width/2 along the right vector, thin axis
    scaled by min_band_thickness (LineDataStress.cpp:2656-2670)."""
    pos, m, at, right = _inputs(positions, mask, attrs, right_vectors, device)
    rb = torch.full(m.shape, band_width * 0.5, dtype=torch.float32, device=pos.device)
    rn = rb * float(min_band_thickness)
    return _band_mesh(pos, m, at, right, rn, rb, num_subdivisions)


def build_principal_stress_tube_mesh(
    positions,  # [L, P, 3]
    mask,  # [L, P]
    attrs,  # [L, P]
    right_vectors,  # [L, P, 3]
    ps_index_per_line,  # [L] 0=major, 1=medium, 2=minor
    major,  # [L, P] principal stresses
    medium,
    minor,
    band_width: float = 0.005,
    hyperstreamline: bool = False,
    min_hyperstreamline_width: float = MIN_HYPERSTREAMLINE_WIDTH,
    num_subdivisions: int = 8,
    device="cuda",
) -> TubeMesh:
    """EIGENVALUE_RATIO / HYPERSTREAMLINES band modes on `device`: per-point
    elliptic radii from the two non-propagating principal stresses
    (TriangleTubesCPU.cpp:270-301)."""
    pos, m, at, right = _inputs(positions, mask, attrs, right_vectors, device)
    psi = _as_tensor(ps_index_per_line, torch.int32, pos.device)[:, None]  # [L, 1]
    major, medium, minor = (_as_tensor(x, torch.float32, pos.device)
                            for x in (major, medium, minor))
    stress_x = torch.where(psi == 0, medium, torch.where(psi == 1, minor, medium))
    stress_z = torch.where(psi == 0, minor, torch.where(psi == 1, major, major))
    radius = band_width * 0.5
    if hyperstreamline:
        rn = radius * torch.clamp(torch.abs(stress_x), min=min_hyperstreamline_width)
        rb = radius * torch.clamp(torch.abs(stress_z), min=min_hyperstreamline_width)
    else:
        tiny = torch.tensor(1e-12, dtype=torch.float32, device=pos.device)
        safe_x = torch.where(torch.abs(stress_x) < 1e-12, tiny, stress_x)
        safe_z = torch.where(torch.abs(stress_z) < 1e-12, tiny, stress_z)
        rn = radius * torch.clamp(torch.abs(stress_x / safe_z), 0.0, 1.0)
        rb = radius * torch.clamp(torch.abs(stress_z / safe_x), 0.0, 1.0)
    return _band_mesh(pos, m, at, right, rn, rb, num_subdivisions)
