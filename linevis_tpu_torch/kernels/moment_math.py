"""Power-moment transmittance reconstruction for MBOIT, in plain PyTorch.

Counterpart of `linevis_tpu/kernels/moment_math.py` (the reference's
`MomentMath.glsl` / `MomentOIT.glsl`, the published CC0 code of
Münstermann, Krumpen, Klein, Peters, "Moment-Based Order-Independent
Transparency", i3D 2018): the same branch-free formulation (every
conditional a `torch.where`), the same degree-11 atan polynomial and the
same `_safe_rcp`. `csrc/moment_math.cuh` holds the same functions as
device code for the accumulation kernel, one for one except the
transmittance: the device splits each `transmittance_at_depth_N` into
`moment_setup_N` (the factors of a pixel's moments, once a pixel) and
`transmittance_N` (the reconstruction at one depth), which together take
the same operations in the same order. Each rounds as its device
counterpart does:
- a division by a constant divides by a tensor (`_div`): on the card
  PyTorch turns `x / python_scalar` into a multiply by the reciprocal;
- a square is written `x * x`, never `x ** 2`;
- `torch.sign` gives 0 for 0 and NaN, as the device `sign_` does.

All functions work elementwise on broadcastable float32 tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "atan2_poly", "transmittance_at_depth_4", "transmittance_at_depth_6",
    "transmittance_at_depth_8", "BIAS_VECTOR_4", "BIAS_VECTOR_6", "BIAS_VECTOR_8",
    "UNORM_BIAS_VECTOR", "UNORM_MOMENT_BIAS", "UNORM_MOMENT_BIAS_TRIG",
    "quantize_moments_unorm16", "dequantize_moments_unorm16",
]

# Single-precision bias vectors (MomentOIT.glsl:450,505,547).
BIAS_VECTOR_4 = (0.0, 0.375, 0.0, 0.375)
BIAS_VECTOR_6 = (0.0, 0.48, 0.0, 0.451, 0.0, 0.45)
BIAS_VECTOR_8 = (0.0, 0.75, 0.0, 0.67666666666666664, 0.0, 0.63, 0.0,
                 0.60030303030303034)

_HALF_PI = 1.5707963267948966
_PI = 3.141592653589793
_S3 = 0.8660254037844386  # sqrt(3)/2


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _atan_unit(t):
    """atan(t) for t in [0, 1]: odd minimax polynomial."""
    z = t * t
    return t * (
        0.99997726
        + z * (-0.33262347
               + z * (0.19354346
                      + z * (-0.11643287
                             + z * (0.05265332 + z * (-0.01172120)))))
    )


def atan2_poly(y, x):
    """Branch-free atan2 with octant reduction."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    t = num / torch.clamp(den, min=1e-30)
    r = _atan_unit(t)
    r = torch.where(swap, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


def _mix(a, b, t):
    return a + (b - a) * t


def _safe_rcp(x, eps=1e-12):
    """sign(x) / max(|x|, eps): the reciprocal of 0 is 0."""
    return torch.sign(x) / torch.clamp(torch.abs(x), min=eps)


def _step(cond, like):
    return torch.where(cond, 1.0, 0.0).to(like.dtype)


def _solve_quadratic(ca, cb, cc):
    """Two real roots of ca*x^2 + cb*x + cc (MomentMath.glsl:25-42)."""
    b = cb * 0.5
    tmp = torch.sqrt(torch.clamp(b * b - ca * cc, min=0.0))
    pos = b >= 0.0
    x1 = torch.where(pos, -cc * _safe_rcp(b + tmp), (-b + tmp) * _safe_rcp(ca))
    x2 = torch.where(pos, (-b - tmp) * _safe_rcp(ca), cc * _safe_rcp(-b + tmp))
    return x1, x2


def _solve_cubic(c0, c1, c2, c3):
    """Three real roots of c0 + c1 x + c2 x^2 + c3 x^3: Peters'
    trigonometric method (MomentMath.glsl:48-78)."""
    inv = _safe_rcp(c3)
    a0 = c0 * inv
    a1 = _div(c1 * inv, 3.0)
    a2 = _div(c2 * inv, 3.0)
    dx = -a2 * a2 + a1
    dy = -a1 * a2 + a0
    dz = a2 * a0 - a1 * a1
    disc = 4.0 * dx * dz - dy * dy
    dep_x = -2.0 * a2 * dx + dy
    dep_y = dx
    theta = _div(atan2_poly(torch.sqrt(torch.clamp(disc, min=0.0)), -dep_x), 3.0)
    ct = torch.cos(theta)
    st = torch.sin(theta)
    r0 = ct
    r1 = -0.5 * ct - _S3 * st
    r2 = -0.5 * ct + _S3 * st
    scale = 2.0 * torch.sqrt(torch.clamp(-dep_y, min=0.0))
    return scale * r0 - a2, scale * r1 - a2, scale * r2 - a2


def _solve_cubic_blinn_smallest(c0, c1, c2, c3):
    """Root of least magnitude of a cubic with three real roots
    (MomentMath.glsl:83-99)."""
    inv = _safe_rcp(c3)
    a0 = c0 * inv
    a1 = _div(c1 * inv, 3.0)
    a2 = _div(c2 * inv, 3.0)
    dx = -a2 * a2 + a1
    dy = -a2 * a1 + a0
    dz = a2 * a0 - a1 * a1
    disc = torch.clamp(4.0 * dx * dz - dy * dy, min=0.0)
    dep_x = dz
    dep_y = -a0 * dy + 2.0 * a1 * dz
    theta = _div(torch.abs(atan2_poly(a0 * torch.sqrt(disc), -dep_y)), 3.0)
    st = torch.sin(theta)
    ct = torch.cos(theta)
    tmp = 2.0 * torch.sqrt(torch.clamp(-dep_x, min=0.0))
    xx = tmp * ct
    xy = tmp * (-0.5 * ct - _S3 * st)
    use_x = (xx + xy) < 2.0 * a1
    sy = torch.where(use_x, xx + a1, xy + a1)
    return -a0 * _safe_rcp(sy)


def _solve_quartic_neumark(c0, c1, c2, c3, c4):
    """Four real roots of a quartic (MomentMath.glsl:104-152)."""
    inv = _safe_rcp(c4)
    B = c3 * inv
    C = c2 * inv
    D = c1 * inv
    E = c0 * inv

    P = -2.0 * C
    Q = C * C + B * D - 4.0 * E
    R = D * D + B * B * E - B * C * D
    y = _solve_cubic_blinn_smallest(R, Q, P, torch.ones_like(R))

    BB = B * B
    fy = 4.0 * y
    BB_fy = BB - fy
    Z = C - y
    ZZ = Z * Z
    fE = 4.0 * E
    ZZ_fE = ZZ - fE

    # Herbison-Evans heuristic picks between Neumark's two factorizations.
    use_first = (y < 0.0) | ((ZZ + fE) * BB_fy > ZZ_fE * (BB + fy))

    t1 = torch.sqrt(torch.clamp(BB_fy, min=0.0))
    G1 = (B + t1) * 0.5
    g1 = (B - t1) * 0.5
    tt1 = (B * Z - 2.0 * D) * _safe_rcp(2.0 * t1)
    H1 = Z * 0.5 + tt1
    h1 = Z * 0.5 - tt1

    t2 = torch.sqrt(torch.clamp(ZZ_fE, min=0.0))
    H2 = (Z + t2) * 0.5
    h2 = (Z - t2) * 0.5
    tt2 = (B * Z - 2.0 * D) * _safe_rcp(2.0 * t2)
    G2 = B * 0.5 + tt2
    g2 = B * 0.5 - tt2

    G = torch.where(use_first, G1, G2)
    g = torch.where(use_first, g1, g2)
    H = torch.where(use_first, H1, H2)
    h = torch.where(use_first, h1, h2)

    one = torch.ones_like(G)
    ra, rb = _solve_quadratic(one, G, H)
    rc, rd = _solve_quadratic(one, g, h)
    return ra, rb, rc, rd


def _overestimation(overestimation, z0):
    return torch.broadcast_to(
        torch.as_tensor(overestimation, dtype=z0.dtype, device=z0.device), z0.shape
    )


def transmittance_at_depth_4(b0, b_even, b_odd, depth, bias, overestimation):
    """4 power moments -> transmittance at `depth` (MomentMath.glsl:246-301).
    b_even: (m2, m4); b_odd: (m1, m3), already normalized by b0."""
    bv = BIAS_VECTOR_4
    b1 = _mix(b_odd[0], bv[0], bias)
    b2 = _mix(b_even[0], bv[1], bias)
    b3 = _mix(b_odd[1], bv[2], bias)
    b4 = _mix(b_even[1], bv[3], bias)
    z0 = depth

    L21D11 = -b1 * b2 + b3
    D11 = torch.clamp(-b1 * b1 + b2, min=1e-10)
    InvD11 = 1.0 / D11
    L21 = L21D11 * InvD11
    sq_var = -b2 * b2 + b4
    D22 = torch.clamp(-L21D11 * L21 + sq_var, min=1e-10)

    c0 = torch.ones_like(z0)
    c1 = z0 - b1
    c2 = z0 * z0 - b2 - L21 * c1
    c1 = c1 * InvD11
    c2 = c2 / D22
    c1 = c1 - L21 * c2
    c0 = c0 - c1 * b1 - c2 * b2

    InvC2 = _safe_rcp(c2)
    p = c1 * InvC2
    q = c0 * InvC2
    D = p * p * 0.25 - q
    r = torch.sqrt(torch.clamp(D, min=0.0))
    z1 = -p * 0.5 - r
    z2 = -p * 0.5 + r

    f0 = _overestimation(overestimation, z0)
    f1 = _step(z1 < z0, z0)
    f2 = _step(z2 < z0, z0)
    f01 = (f1 - f0) * _safe_rcp(z1 - z0)
    f12 = (f2 - f1) * _safe_rcp(z2 - z1)
    f012 = (f12 - f01) * _safe_rcp(z2 - z0)
    p0 = f012
    p1 = p0
    p0 = f01 - p0 * z1
    p2 = p1
    p1 = p0 - p1 * z0
    p0 = f0 - p0 * z0
    absorbance = p0 + b1 * p1 + b2 * p2
    return torch.clamp(torch.exp(-b0 * absorbance), 0.0, 1.0)


def transmittance_at_depth_6(b0, b_even, b_odd, depth, bias, overestimation):
    """6 power moments (MomentMath.glsl:305-385)."""
    bv = BIAS_VECTOR_6
    b = [
        _mix(b_odd[0], bv[0], bias),
        _mix(b_even[0], bv[1], bias),
        _mix(b_odd[1], bv[2], bias),
        _mix(b_even[1], bv[3], bias),
        _mix(b_odd[2], bv[4], bias),
        _mix(b_even[2], bv[5], bias),
    ]
    z0 = depth

    InvD11 = 1.0 / torch.clamp(-b[0] * b[0] + b[1], min=1e-10)
    L21D11 = -b[0] * b[1] + b[2]
    L21 = L21D11 * InvD11
    D22 = torch.clamp(-L21D11 * L21 + (-b[1] * b[1] + b[3]), min=1e-10)
    L31D11 = -b[0] * b[2] + b[3]
    L31 = L31D11 * InvD11
    InvD22 = 1.0 / D22
    L32D22 = -L21D11 * L31 + (-b[1] * b[2] + b[4])
    L32 = L32D22 * InvD22
    D33 = torch.clamp(
        (-b[2] * b[2] + b[5]) - (L31D11 * L31 + L32D22 * L32), min=1e-10
    )
    InvD33 = 1.0 / D33

    c0 = torch.ones_like(z0)
    c1 = z0
    c2 = c1 * z0
    c3 = c2 * z0
    c1 = c1 - b[0]
    c2 = c2 - (L21 * c1 + b[1])
    c3 = c3 - b[2] - L31 * c1 - L32 * c2
    c1 = c1 * InvD11
    c2 = c2 * InvD22
    c3 = c3 * InvD33
    c2 = c2 - L32 * c3
    c1 = c1 - (L21 * c2 + L31 * c3)
    c0 = c0 - (b[0] * c1 + b[1] * c2 + b[2] * c3)

    z1, z2, z3 = _solve_cubic(c0, c1, c2, c3)

    f0 = _overestimation(overestimation, z0)
    f1 = 1.0 - _step(z1 > z0, z0)
    f2 = 1.0 - _step(z2 > z0, z0)
    f3 = 1.0 - _step(z3 > z0, z0)
    f01 = (f1 - f0) * _safe_rcp(z1 - z0)
    f12 = (f2 - f1) * _safe_rcp(z2 - z1)
    f23 = (f3 - f2) * _safe_rcp(z3 - z2)
    f012 = (f12 - f01) * _safe_rcp(z2 - z0)
    f123 = (f23 - f12) * _safe_rcp(z3 - z1)
    f0123 = (f123 - f012) * _safe_rcp(z3 - z0)

    p0 = -f0123 * z2 + f012
    p1 = f0123
    p2 = p1
    p1 = p1 * (-z1) + p0
    p0 = p0 * (-z1) + f01
    p3 = p2
    p2 = p2 * (-z0) + p1
    p1 = p1 * (-z0) + p0
    p0 = p0 * (-z0) + f0
    absorbance = p0 + p1 * b[0] + p2 * b[1] + p3 * b[2]
    return torch.clamp(torch.exp(-b0 * absorbance), 0.0, 1.0)


def transmittance_at_depth_8(b0, b_even, b_odd, depth, bias, overestimation):
    """8 power moments (MomentMath.glsl:389-505)."""
    bv = BIAS_VECTOR_8
    b = [
        _mix(b_odd[0], bv[0], bias),
        _mix(b_even[0], bv[1], bias),
        _mix(b_odd[1], bv[2], bias),
        _mix(b_even[1], bv[3], bias),
        _mix(b_odd[2], bv[4], bias),
        _mix(b_even[2], bv[5], bias),
        _mix(b_odd[3], bv[6], bias),
        _mix(b_even[3], bv[7], bias),
    ]
    z0 = depth

    D22 = torch.clamp(-b[0] * b[0] + b[1], min=1e-10)
    InvD22 = 1.0 / D22
    L32D22 = -b[1] * b[0] + b[2]
    L32 = L32D22 * InvD22
    L42D22 = -b[2] * b[0] + b[3]
    L42 = L42D22 * InvD22
    L52D22 = -b[3] * b[0] + b[4]
    L52 = L52D22 * InvD22

    D33 = torch.clamp(-L32 * L32D22 + (-b[1] * b[1] + b[3]), min=1e-10)
    InvD33 = 1.0 / D33
    L43D33 = -L42 * L32D22 + (-b[2] * b[1] + b[4])
    L43 = L43D33 * InvD33
    L53D33 = -L52 * L32D22 + (-b[3] * b[1] + b[5])
    L53 = L53D33 * InvD33

    D44 = torch.clamp(
        (-b[2] * b[2] + b[5]) - (L42 * L42D22 + L43 * L43D33), min=1e-10
    )
    InvD44 = 1.0 / D44
    L54D44 = (-b[3] * b[2] + b[6]) - (L52 * L42D22 + L53 * L43D33)
    L54 = L54D44 * InvD44

    D55 = torch.clamp(
        (-b[3] * b[3] + b[7]) - (L52 * L52D22 + L53 * L53D33 + L54 * L54D44),
        min=1e-10,
    )
    InvD55 = 1.0 / D55

    c0 = torch.ones_like(z0)
    c1 = z0
    c2 = c1 * z0
    c3 = c2 * z0
    c4 = c3 * z0
    c1 = c1 - b[0]
    c2 = c2 - (L32 * c1 + b[1])
    c3 = c3 - b[2] - (L42 * c1 + L43 * c2)
    c4 = c4 - b[3] - (L52 * c1 + L53 * c2 + L54 * c3)
    c1 = c1 * InvD22
    c2 = c2 * InvD33
    c3 = c3 * InvD44
    c4 = c4 * InvD55
    c3 = c3 - L54 * c4
    c2 = c2 - (L53 * c4 + L43 * c3)
    c1 = c1 - (L52 * c4 + L42 * c3 + L32 * c2)
    c0 = c0 - (b[3] * c4 + b[2] * c3 + b[1] * c2 + b[0] * c1)

    z1, z2, z3, z4 = _solve_quartic_neumark(c0, c1, c2, c3, c4)

    f0 = _overestimation(overestimation, z0)
    f1 = _step(z1 <= z0, z0)
    f2 = _step(z2 <= z0, z0)
    f3 = _step(z3 <= z0, z0)
    f4 = _step(z4 <= z0, z0)
    f01 = (f1 - f0) * _safe_rcp(z1 - z0)
    f12 = (f2 - f1) * _safe_rcp(z2 - z1)
    f23 = (f3 - f2) * _safe_rcp(z3 - z2)
    f34 = (f4 - f3) * _safe_rcp(z4 - z3)
    f012 = (f12 - f01) * _safe_rcp(z2 - z0)
    f123 = (f23 - f12) * _safe_rcp(z3 - z1)
    f234 = (f34 - f23) * _safe_rcp(z4 - z2)
    f0123 = (f123 - f012) * _safe_rcp(z3 - z0)
    f1234 = (f234 - f123) * _safe_rcp(z4 - z1)
    f01234 = (f1234 - f0123) * _safe_rcp(z4 - z0)

    P_0 = -f01234 * z3 + f0123
    P1 = f01234
    P2 = P1
    P1 = -P1 * z2 + P_0
    P_0 = -P_0 * z2 + f012
    P3 = P2
    P2 = -P2 * z1 + P1
    P1 = -P1 * z1 + P_0
    P_0 = -P_0 * z1 + f01
    P4 = P3
    P3 = -P3 * z0 + P2
    P2 = -P2 * z0 + P1
    P1 = -P1 * z0 + P_0
    P_0 = -P_0 * z0 + f0
    absorbance = P_0 + P1 * b[0] + P2 * b[1] + P3 * b[2] + P4 * b[3]
    return torch.clamp(torch.exp(-b0 * absorbance), 0.0, 1.0)


# UNORM16 pixel format (MBOIT_PIXEL_FORMAT_UNORM_16): the quantization basis
# change and offsets for 16-bit moment storage (MomentMath.glsl:156-243) and
# the matching UNORM bias vectors (MomentOIT.glsl:459,514,552). The renderer
# applies them once to the accumulated normalized moments and rounds to the
# 65535-step grid between the two kernel passes.

UNORM_BIAS_VECTOR = {
    4: (0.0, 0.628, 0.0, 0.628),
    6: (0.0, 0.5566, 0.0, 0.489, 0.0, 0.47869382),
    8: (0.0, 0.42474916387959866, 0.0, 0.22407802675585284,
        0.0, 0.15369230769230768, 0.0, 0.12900440529089119),
}
# FLOAT_32 -> UNORM_16 moment_bias defaults (MBOITRenderer.cpp:134-161).
UNORM_MOMENT_BIAS = {4: 6e-4, 6: 6e-3, 8: 2.5e-2}
UNORM_MOMENT_BIAS_TRIG = {4: 4e-3, 6: 6.5e-3, 8: 8.5e-3}

# out = A @ v with the rows of A the output index.
_Q_ODD = {
    4: ((1.5, -2.0), (0.8660254037844386, -0.3849001794597505)),
    6: ((2.5, -10.0, 8.0),
        (-1.87499864450, 4.20757543111, -1.83257678661),
        (1.26583039016, -1.47644882902, 0.71061660238)),
    8: ((3.48044635732474, -27.5760737514826, 55.1267384344761,
         -31.5311110403183),
        (1.26797185782836, -0.928755808743913, -2.07520453231032,
         1.23598848322588),
        (-2.1671560004294, 6.17950199592966, -0.276515571579297,
         -4.23583042392097),
        (0.974332879165755, -0.443426830933027, -0.360491648368785,
         0.310149466050223)),
}
_Q_EVEN = {
    4: ((4.0, -4.0), (0.5, 0.5)),
    6: ((4.0, -4.0, 0.0),
        (9.0, -24.0, 16.0),
        (-0.57759806484, 4.61936647543, -3.07953906655)),
    8: ((0.280504133158527, -0.757633844606942, 0.392179589334688,
         -0.887531871812237),
        (-2.01362265883247, 0.221551373038988, -1.06107954265125,
         2.83887201588367),
        (-7.31010494985321, 13.9855979699139, -0.114305766176437,
         -7.4361899359832),
        (-15.8954215629556, 79.6186327084103, -127.457278992502,
         63.7349456687829)),
}
_D_ODD = {
    4: ((-1.0 / 3.0, 1.7320508075688772), (-0.75, 1.299038105676658)),
    6: ((-0.02877789192, 0.47635550422, 1.55242808973),
        (0.09995235706, 0.84532580931, 1.05472570761),
        (0.25893353755, 0.90779616657, 0.83327335647)),
    8: ((-0.00482399708502382, -0.423201508674231, 0.0348312382605129,
         1.67179208266592),
        (-0.0233402218644408, -0.832829097046478, 0.0193406040499625,
         1.21021509068975),
        (-0.010888537031885, -0.926393772997063, -0.11723394414779,
         0.983723301818275),
        (-0.0308713357806732, -0.937989172670245, -0.218033377677099,
         0.845991731322996)),
}
_D_EVEN = {
    4: ((0.125, 1.0), (-0.125, 1.0)),
    6: ((1.253044e-05, 0.16668494186, 0.86602540579),
        (-0.24998746956, 0.16668494186, 0.86602540579),
        (-0.37498825271, 0.21876713299, 0.81189881793)),
    8: ((-0.976220278891035, -0.456139260269401, -0.0504335521016742,
         0.000838800390651085),
        (-1.04828341778299, -0.229726640510149, 0.0259608334616091,
         -0.00133632693205861),
        (-1.03115268628604, -0.077844420809897, 0.00443408851014257,
         -0.0103744938457406),
        (-0.996038443434636, 0.0175438624416783, -0.0361414253243963,
         -0.00317839994022725)),
}
_OFF_EVEN = {
    4: (0.0, 0.0),
    6: (0.0, 0.0, 0.018888946),
    8: (0.972481993925964, 1.0, 0.999179192513328, 0.991778293073131),
}


def _matvec(A, v):
    """A @ v over lists of tensors, summed left to right as the JAX package's
    `sum` does (its start 0 adds exactly)."""
    out = []
    for row in A:
        acc = None
        for a, x in zip(row, v):
            acc = a * x if acc is None else acc + a * x
        out.append(acc)
    return out


def quantize_moments_unorm16(odds, evens, n_mom):
    """Normalized raw power moments -> the [0, 1] UNORM16 representation
    (quantizeMoments + offsetMoments)."""
    oq = _matvec(_Q_ODD[n_mom], list(odds))
    eq = _matvec(_Q_EVEN[n_mom], list(evens))
    oq = [x + 0.5 for x in oq]
    eq = [x + off for x, off in zip(eq, _OFF_EVEN[n_mom])]
    return oq, eq


def dequantize_moments_unorm16(odds_q, evens_q, n_mom):
    """Inverse of quantize_moments_unorm16 (offsetAndDequantizeMoments)."""
    oq = [x - 0.5 for x in odds_q]
    eq = [x - off for x, off in zip(evens_q, _OFF_EVEN[n_mom])]
    return _matvec(_D_ODD[n_mom], oq), _matvec(_D_EVEN[n_mom], eq)
