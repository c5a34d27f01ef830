"""Trigonometric-moment transmittance reconstruction for MBOIT, in plain
PyTorch.

Counterpart of `linevis_tpu/kernels/trig_moment_math.py` (the reference's
`usePowerMoments = false` mode: `TrigonometricMomentMath.glsl`,
`ComplexAlgebra.glsl`, `MomentOIT.glsl:338-355`, `MBOITUtils.cpp:22-54`).
Each fragment accumulates complex powers of a point on the unit circle at
phase `wzp_y * (depth + 1)`; the resolve solves the Hermitian Toeplitz
system (LDL*), finds the roots of the resulting complex polynomial and
weights them by arc position relative to the query depth, with a linear
"wrapping zone" ramp near phase 2*pi. Complex numbers are (re, im) pairs of
float32 tensors; sin/cos are the degree-9 polynomial `sin_poly`, atan2 the
polynomial of `moment_math`. `csrc/trig_moment_math.cuh` holds the same
functions as device code, rounding as these do.
"""

from __future__ import annotations

import math

import torch

from linevis_tpu_torch.kernels.moment_math import _div, atan2_poly

__all__ = [
    "sin_poly", "sincos_poly", "wrapping_zone_parameters", "circle_powers",
    "transmittance_at_depth_trig_2", "transmittance_at_depth_trig_3",
    "transmittance_at_depth_trig_4", "TRIG_BIAS",
]

# Single-precision (FLOAT_32) moment bias per moment count
# (MBOITRenderer.cpp:148-161, trigonometric branch).
TRIG_BIAS = {4: 4e-7, 6: 8e-6, 8: 1.5e-5}

_PI = math.pi
_TWO_PI = 2.0 * math.pi
_HALF_PI = 0.5 * math.pi


def sin_poly(phi):
    """sin(phi), branch-free, any finite phi: fold to [-pi/2, pi/2], then a
    degree-9 odd polynomial."""
    x = phi - _TWO_PI * torch.floor(_div(phi, _TWO_PI) + 0.5)  # -> [-pi, pi]
    x = torch.where(x > _HALF_PI, _PI - x, x)
    x = torch.where(x < -_HALF_PI, -_PI - x, x)  # -> [-pi/2, pi/2]
    z = x * x
    return x * (
        1.0
        + z * (-1.0 / 6.0
               + z * (1.0 / 120.0
                      + z * (-1.0 / 5040.0 + z * (1.0 / 362880.0))))
    )


def sincos_poly(phi):
    return sin_poly(phi), sin_poly(phi + _HALF_PI)


# Complex helpers on (re, im) pairs (ComplexAlgebra.glsl).

def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cconj(a):
    return (a[0], -a[1])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _cscale(a, s):
    return (a[0] * s, a[1] * s)


def _cdot(a, b):
    """GLSL dot() of the vec2 representations (not the Hermitian product)."""
    return a[0] * b[0] + a[1] * b[1]


def _cdiv(num, den, eps=1e-20):
    d = torch.clamp(den[0] * den[0] + den[1] * den[1], min=eps)
    return ((num[0] * den[0] + num[1] * den[1]) / d,
            (-num[0] * den[1] + num[1] * den[0]) / d)


def _crcp(a, eps=1e-20):
    d = torch.clamp(a[0] * a[0] + a[1] * a[1], min=eps)
    return (a[0] / d, -a[1] / d)


def _csq(a):
    return (a[0] * a[0] - a[1] * a[1], 2.0 * a[0] * a[1])


def _csqrt(z, eps=1e-30):
    """One square root (ComplexAlgebra.glsl SquareRoot): the half-angle
    construction on (|re|, im), components swapped for negative re."""
    zp = (torch.abs(z[0]), z[1])
    len_sq = torch.clamp(zp[0] * zp[0] + zp[1] * zp[1], min=eps)
    inv_len = 1.0 / torch.sqrt(len_sq)
    ur = (zp[0] * inv_len + 1.0, zp[1] * inv_len)
    ur_len_sq = torch.clamp(ur[0] * ur[0] + ur[1] * ur[1], min=eps)
    norm = 1.0 / torch.sqrt(ur_len_sq * inv_len)
    root = (ur[0] * norm, ur[1] * norm)
    neg = z[0] < 0.0
    return (torch.where(neg, root[1], root[0]), torch.where(neg, root[0], root[1]))


def _ccbrt(z, eps=1e-30):
    """One cubic root (ComplexAlgebra.glsl CubicRoot)."""
    arg = atan2_poly(z[1], z[0]) * (1.0 / 3.0)
    s, c = sincos_poly(arg)
    len_sq = torch.clamp(z[0] * z[0] + z[1] * z[1], min=eps)
    mag = torch.exp(torch.log(len_sq) * (1.0 / 6.0))
    return (c * mag, s * mag)


# Complex polynomial roots (ComplexAlgebra.glsl).

def _solve_quadratic_c(A, B, C):
    inv_a = _crcp(A)
    B = _cscale(_cmul(B, inv_a), 0.5)
    C = _cmul(C, inv_a)
    disc_root = _csqrt(_csub(_csq(B), C))
    return (_csub(_cscale(B, -1.0), disc_root), _cadd(_cscale(B, -1.0), disc_root))


_W1 = (-0.5, -0.5 * math.sqrt(3.0))  # primitive cube roots of unity
_W2 = (-0.5, 0.5 * math.sqrt(3.0))


def _solve_cubic_blinn_c(A, B, C, D):
    inv_a = _crcp(A)
    B = _cscale(_cmul(B, inv_a), 1.0 / 3.0)
    C = _cscale(_cmul(C, inv_a), 1.0 / 3.0)
    D = _cmul(D, inv_a)
    delta00 = _csub(C, _csq(B))
    delta01 = _csub(D, _cmul(C, B))
    delta11 = _csub(_cmul(B, D), _csq(C))
    disc = _csub(_cscale(_cmul(delta00, delta11), 4.0), _csq(delta01))
    depr_d = _cadd(_cscale(_cmul(B, delta00), -2.0), delta01)
    depr_c = delta00
    disc_root = _csqrt((-disc[0], -disc[1]))
    # faceforward(N, I, Nref) with N = I = disc_root, Nref = depr_d.
    flip = torch.where(_cdot(depr_d, disc_root) < 0.0, 1.0, -1.0).to(B[0].dtype)
    disc_root = _cscale(disc_root, flip)
    cubed = _csub(disc_root, depr_d)
    first = _ccbrt(_cscale(cubed, 0.5))
    inv_first = _crcp(first)
    roots = []
    for w, winv in ((None, None), (_W1, _W2), (_W2, _W1)):
        r = first if w is None else _cmul(w, first)
        rinv = inv_first if winv is None else _cmul(winv, inv_first)
        roots.append(_csub(_csub(r, _cmul(depr_c, rinv)), B))
    return roots


def _solve_quartic_neumark_c(A, B, C, D, E):
    inv_a = _crcp(A)
    B = _cmul(B, inv_a)
    C = _cmul(C, inv_a)
    D = _cmul(D, inv_a)
    E = _cmul(E, inv_a)
    P = _cscale(C, -2.0)
    Q = _csub(_cadd(_csq(C), _cmul(B, D)), _cscale(E, 4.0))
    R = _csub(_cadd(_csq(D), _cmul(_csq(B), E)), _cmul(_cmul(B, C), D))
    one = (torch.ones_like(B[0]), torch.zeros_like(B[0]))
    cr = _solve_cubic_blinn_c(one, P, Q, R)
    take1 = (cr[1][0] * cr[1][0] + cr[1][1] * cr[1][1]) > (
        cr[0][0] * cr[0][0] + cr[0][1] * cr[0][1]
    )
    y = (torch.where(take1, cr[1][0], cr[0][0]), torch.where(take1, cr[1][1], cr[0][1]))
    bb = _csq(B)
    bb_fy = _csub(bb, _cscale(y, 4.0))
    tmp = _csqrt(bb_fy)
    G = _cscale(_cadd(B, tmp), 0.5)
    g = _cscale(_csub(B, tmp), 0.5)
    Z = _csub(C, y)
    tmp = _cdiv(_csub(_cscale(_cmul(B, Z), 0.5), D), tmp)
    H = _cadd(_cscale(Z, 0.5), tmp)
    h = _csub(_cscale(Z, 0.5), tmp)
    r01 = _solve_quadratic_c(one, G, H)
    r23 = _solve_quadratic_c(one, g, h)
    return [r01[0], r01[1], r23[0], r23[1]]


# Wrapping zone (MBOITUtils.cpp, TrigonometricMomentMath.glsl:25-39).

def _circle_to_parameter_np(angle):
    x, y = math.cos(angle), math.sin(angle)
    r = abs(y) - abs(x)
    r = (2.0 - r) if x < 0.0 else r
    r = (6.0 - r) if y < 0.0 else r
    return r + (8.0 if angle >= _TWO_PI else 0.0)


def wrapping_zone_parameters(angle=0.1 * math.pi):
    """Host-side vec4 of wrapping-zone constants (MBOITUtils.cpp:40-54)."""
    y = _PI - 0.5 * angle
    if angle <= 0.0:
        return (angle, y, 0.0, 0.0)
    zone_begin = _circle_to_parameter_np(_TWO_PI - angle)
    zone_end = 7.0  # pOutMaxParameter
    z = 1.0 / (zone_end - zone_begin)
    w = 1.0 - zone_end * z
    return (angle, y, z, w)


def _circle_to_parameter(p):
    """Monotone arc parameter of a unit-circle point (GLSL version)."""
    r = torch.abs(p[1]) - torch.abs(p[0])
    r = torch.where(p[0] < 0.0, 2.0 - r, r)
    return torch.where(p[1] < 0.0, 6.0 - r, r)


def _root_weight_factor(ref_param, root_param, wzp_z, wzp_w):
    binary = torch.where(root_param < ref_param, 1.0, 0.0).to(root_param.dtype)
    linear = torch.clamp(root_param * wzp_z + wzp_w, 0.0, 1.0)
    return binary + linear


# Moment generation (MomentOIT.glsl:338-355).

def circle_powers(depth_w, wzp_y, n_half):
    """[(re_k, im_k)] for k = 1..n_half at phase wzp_y * (depth_w + 1): the
    per-fragment complex factors each fragment's absorbance multiplies."""
    phase = wzp_y * (depth_w + 1.0)
    s, c = sincos_poly(phase)
    powers = [(c, s)]
    for _ in range(n_half - 1):
        powers.append(_cmul(powers[-1], (c, s)))
    return powers


# Transmittance reconstruction (TrigonometricMomentMath.glsl).

def _newton_eval(zs, fs, bs):
    """sum_k Re(b_k * p_k), p the polynomial through (z_i, f_i): Newton
    divided differences with real f_i at complex nodes z_i, expanded to
    monomial coefficients as the GLSL does."""
    n = len(zs)
    table = [list(fs)]
    for j in range(1, n):
        prev = table[-1]
        table.append([_cdiv(_csub(prev[i + 1], prev[i]), _csub(zs[i + j], zs[i]))
                      for i in range(n - j)])
    poly = [table[n - 1][0]]
    for j in range(n - 2, -1, -1):
        z = zs[j]
        new_poly = [None] * (len(poly) + 1)
        new_poly[len(poly)] = poly[-1]
        for i in range(len(poly) - 1, 0, -1):
            new_poly[i] = _csub(poly[i - 1], _cmul(poly[i], z))
        new_poly[0] = _csub(table[j][0], _cmul(poly[0], z))
        poly = new_poly
    ws = None
    for b, p in zip(bs, poly):
        term = b[0] * p[0] - b[1] * p[1]  # Re(b * p)
        ws = term if ws is None else ws + term
    return ws


def _transmittance_trig(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z, wzp_w):
    n = len(trig_b)  # 2, 3 or 4 complex moments
    scale = 1.0 - bias
    one = (torch.ones_like(b0), torch.zeros_like(b0))
    bs = [one] + [_cscale(m, scale) for m in trig_b]

    # LDL* of the Hermitian Toeplitz moment matrix, entry (i, j) = b[i - j].
    D = [None] * (n + 1)
    invD = [None] * (n + 1)
    L = [[None] * (n + 1) for _ in range(n + 1)]
    eps = 1e-12
    D[0] = bs[0][0]
    invD[0] = 1.0 / torch.clamp(D[0], min=eps)
    for i in range(1, n + 1):
        for j in range(i):
            acc = bs[i - j]
            for k in range(j):
                acc = _csub(acc, _cscale(_cmul(L[i][k], _cconj(L[j][k])), D[k]))
            L[i][j] = _cscale(acc, invD[j])
        di = bs[0][0]
        for k in range(i):
            di = di - D[k] * (L[i][k][0] * L[i][k][0] + L[i][k][1] * L[i][k][1])
        D[i] = di
        invD[i] = 1.0 / torch.where(torch.abs(di) > eps, di,
                                    torch.where(di >= 0.0, eps, -eps).to(di.dtype))

    # Solve (LDL*) c = powers of the circle point at the query depth.
    phase = wzp_y * (depth + 1.0)
    s_q, c_q = sincos_poly(phase)
    cp = (c_q, s_q)
    c = [(torch.ones_like(c_q), torch.zeros_like(c_q))]
    for _ in range(n):
        c.append(_cmul(c[-1], cp))
    for i in range(1, n + 1):  # forward substitution
        for j in range(i):
            c[i] = _csub(c[i], _cmul(L[i][j], c[j]))
    for i in range(n + 1):  # diagonal
        c[i] = _cscale(c[i], invD[i])
    for i in range(n - 1, -1, -1):  # backward substitution (conjugates)
        for j in range(i + 1, n + 1):
            c[i] = _csub(c[i], _cmul(_cconj(L[j][i]), c[j]))

    coeffs = [_cconj(ci) for ci in c]
    if n == 2:
        roots = list(_solve_quadratic_c(coeffs[2], coeffs[1], coeffs[0]))
    elif n == 3:
        roots = _solve_cubic_blinn_c(coeffs[3], coeffs[2], coeffs[1], coeffs[0])
    else:
        roots = _solve_quartic_neumark_c(coeffs[4], coeffs[3], coeffs[2], coeffs[1],
                                         coeffs[0])

    depth_param = _circle_to_parameter(cp)
    zero = torch.zeros_like(depth_param)
    fs = [(overestimation * torch.ones_like(depth_param), zero)]
    for r in roots:
        fs.append((_root_weight_factor(depth_param, _circle_to_parameter(r), wzp_z, wzp_w),
                   zero))
    weight_sum = _newton_eval([cp] + roots, fs, bs)
    return torch.exp(-b0 * weight_sum)


def transmittance_at_depth_trig_2(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z,
                                  wzp_w):
    """2 complex moments (NUM_MOMENTS == 4, TRIGONOMETRIC)."""
    assert len(trig_b) == 2
    return _transmittance_trig(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z, wzp_w)


def transmittance_at_depth_trig_3(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z,
                                  wzp_w):
    """3 complex moments (NUM_MOMENTS == 6, TRIGONOMETRIC)."""
    assert len(trig_b) == 3
    return _transmittance_trig(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z, wzp_w)


def transmittance_at_depth_trig_4(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z,
                                  wzp_w):
    """4 complex moments (NUM_MOMENTS == 8, TRIGONOMETRIC)."""
    assert len(trig_b) == 4
    return _transmittance_trig(b0, trig_b, depth, bias, overestimation, wzp_y, wzp_z, wzp_w)
