"""linevis_tpu_torch MBOIT moment math vs the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through
`linevis_tpu/kernels/{moment_math,trig_moment_math}.py` and their ports.
Bars: the polynomial atan2 and sin, the circle powers and the unorm16
(de)quantization within 1e-6 (they are a few float32 operations each); the
transmittance reconstructions, on moments built from random fragment sets,
within 1e-4 absolute (measured: at most 1.7e-5 over these inputs). The
Hankel and Toeplitz solves amplify one ulp of a moment, and XLA:CPU
contracts multiplies into adds where PyTorch does not, so the two do not
agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels import moment_math as jmm
from linevis_tpu.kernels import trig_moment_math as jtm
from linevis_tpu_torch.kernels import moment_math as tmm
from linevis_tpu_torch.kernels import trig_moment_math as ttm

torch.set_num_threads(1)

WZP = jtm.wrapping_zone_parameters()


def _close(t, j, atol):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    assert np.isfinite(t).all() and np.isfinite(j).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=atol)


def test_atan2_poly_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.normal(0, 2, 4096).astype(np.float32)
    x = rng.normal(0, 2, 4096).astype(np.float32)
    x[:8] = 0.0
    y[8:16] = 0.0
    t = tmm.atan2_poly(torch.tensor(y), torch.tensor(x)).numpy()
    _close(t, jmm.atan2_poly(jnp.asarray(y), jnp.asarray(x)), 1e-6)
    assert np.abs(t - np.arctan2(y, x)).max() < 2e-6


def test_sin_poly_and_wrapping_zone_match_jax():
    phi = np.linspace(-20.0, 20.0, 4001, dtype=np.float32)
    s, c = ttm.sincos_poly(torch.tensor(phi))
    js, jc = jtm.sincos_poly(jnp.asarray(phi))
    _close(s.numpy(), js, 1e-6)
    _close(c.numpy(), jc, 1e-6)
    assert np.abs(s.numpy() - np.sin(phi)).max() < 1e-5
    assert ttm.wrapping_zone_parameters() == WZP


def test_circle_powers_match_jax():
    dw = np.linspace(-1.0, 1.0, 513, dtype=np.float32)
    t = ttm.circle_powers(torch.tensor(dw), torch.tensor(np.float32(WZP[1])), 4)
    j = jtm.circle_powers(jnp.asarray(dw), jnp.float32(WZP[1]), 4)
    for (tr, ti), (jr, ji) in zip(t, j):
        _close(tr.numpy(), jr, 1e-6)
        _close(ti.numpy(), ji, 1e-6)


@pytest.mark.parametrize("n_mom", [4, 6, 8])
def test_unorm16_quantization_matches_jax(n_mom):
    rng = np.random.default_rng(n_mom)
    odds = [rng.uniform(-1, 1, 256).astype(np.float32) for _ in range(n_mom // 2)]
    evens = [rng.uniform(0, 1, 256).astype(np.float32) for _ in range(n_mom // 2)]
    tq = tmm.quantize_moments_unorm16([torch.tensor(x) for x in odds],
                                      [torch.tensor(x) for x in evens], n_mom)
    jq = jmm.quantize_moments_unorm16([jnp.asarray(x) for x in odds],
                                      [jnp.asarray(x) for x in evens], n_mom)
    for t, j in zip(tq[0] + tq[1], jq[0] + jq[1]):
        _close(t.numpy(), j, 1e-6 * max(1.0, float(np.abs(np.asarray(j)).max())))
    td = tmm.dequantize_moments_unorm16(*tq, n_mom)
    jd = jmm.dequantize_moments_unorm16(*jq, n_mom)
    for t, j in zip(td[0] + td[1], jd[0] + jd[1]):
        _close(t.numpy(), j, 1e-5)
    assert tmm.UNORM_BIAS_VECTOR == jmm.UNORM_BIAS_VECTOR
    assert tmm.UNORM_MOMENT_BIAS == jmm.UNORM_MOMENT_BIAS
    assert tmm.UNORM_MOMENT_BIAS_TRIG == jmm.UNORM_MOMENT_BIAS_TRIG


def _fragment_sets(seed, n_pix=512, max_frags=8):
    """Per pixel: 1..max_frags fragments with warped depths in [-1, 1] and
    absorbances -log(1 - a), a in [0.05, 0.6]; and query depths."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, max_frags + 1, n_pix)
    dw = rng.uniform(-1, 1, (max_frags, n_pix)).astype(np.float32)
    absorb = -np.log(1 - rng.uniform(0.05, 0.6, (max_frags, n_pix))).astype(np.float32)
    absorb[np.arange(max_frags)[:, None] >= n[None]] = 0.0
    query = rng.uniform(-1, 1, (4, n_pix)).astype(np.float32)
    return dw, absorb, query


def _power_moments(dw, absorb, n_mom):
    b0 = absorb.sum(0, dtype=np.float32)
    odds = [(dw ** (2 * j + 1) * absorb).sum(0, dtype=np.float32) / b0
            for j in range(n_mom // 2)]
    evens = [(dw ** (2 * j + 2) * absorb).sum(0, dtype=np.float32) / b0
             for j in range(n_mom // 2)]
    return b0.astype(np.float32), [o.astype(np.float32) for o in odds], \
        [e.astype(np.float32) for e in evens]


@pytest.mark.parametrize("n_mom", [4, 6, 8])
def test_power_transmittance_matches_jax(n_mom):
    dw, absorb, query = _fragment_sets(100 + n_mom)
    b0, odds, evens = _power_moments(dw, absorb, n_mom)
    bias = {4: 5e-7, 6: 5e-6, 8: 5e-5}[n_mom]
    fn_t = {4: tmm.transmittance_at_depth_4, 6: tmm.transmittance_at_depth_6,
            8: tmm.transmittance_at_depth_8}[n_mom]
    fn_j = {4: jmm.transmittance_at_depth_4, 6: jmm.transmittance_at_depth_6,
            8: jmm.transmittance_at_depth_8}[n_mom]
    T = torch.tensor
    t = fn_t(T(b0), [T(e) for e in evens], [T(o) for o in odds], T(query),
             T(np.float32(bias)), T(np.float32(0.1))).numpy()
    j = np.asarray(fn_j(jnp.asarray(b0), [jnp.asarray(e) for e in evens],
                        [jnp.asarray(o) for o in odds], jnp.asarray(query),
                        jnp.float32(bias), jnp.float32(0.1)))
    _close(t, j, 1e-4)
    assert 0.0 <= t.min() and t.max() <= 1.0 and t.std() > 0.05


@pytest.mark.parametrize("n_mom", [4, 6, 8])
def test_trig_transmittance_matches_jax(n_mom):
    dw, absorb, query = _fragment_sets(200 + n_mom)
    nh = n_mom // 2
    b0 = absorb.sum(0, dtype=np.float32)
    phase = np.float32(WZP[1]) * (dw + np.float32(1.0))
    moms = []
    for k in range(1, nh + 1):
        re = (np.cos(k * phase) * absorb).sum(0, dtype=np.float32) / b0
        im = (np.sin(k * phase) * absorb).sum(0, dtype=np.float32) / b0
        moms.append((re.astype(np.float32), im.astype(np.float32)))
    bias = ttm.TRIG_BIAS[n_mom]
    wz = [np.float32(w) for w in WZP[1:]]
    fn_t = {4: ttm.transmittance_at_depth_trig_2, 6: ttm.transmittance_at_depth_trig_3,
            8: ttm.transmittance_at_depth_trig_4}[n_mom]
    fn_j = {4: jtm.transmittance_at_depth_trig_2, 6: jtm.transmittance_at_depth_trig_3,
            8: jtm.transmittance_at_depth_trig_4}[n_mom]
    T = torch.tensor
    t = fn_t(T(b0), [(T(r), T(i)) for r, i in moms], T(query), T(np.float32(bias)),
             T(np.float32(0.1)), *map(T, wz)).numpy()
    j = np.asarray(fn_j(jnp.asarray(b0), [(jnp.asarray(r), jnp.asarray(i)) for r, i in moms],
                        jnp.asarray(query), jnp.float32(bias), jnp.float32(0.1),
                        *map(jnp.float32, wz)))
    _close(t, j, 1e-4)
    assert t.std() > 0.05


def test_transmittance_at_a_fragments_own_depth():
    """The resolve queries each fragment at its own warped depth, where a
    root of the reconstruction sits: on identical inputs port and JAX agree
    (within 1e-6), but one ulp of the query moves T by up to ~5e-2. This is
    why the kernel-level resolve below is held to looser bars."""
    T = torch.tensor
    dw, absorb, _ = _fragment_sets(304, max_frags=3)
    query = dw[:1].copy()
    b0, odds, evens = _power_moments(dw, absorb, 4)
    args = (np.float32(5e-7), np.float32(0.1))
    t = tmm.transmittance_at_depth_4(T(b0), [T(e) for e in evens], [T(o) for o in odds],
                                     T(query), *map(T, args)).numpy()
    j = np.asarray(jmm.transmittance_at_depth_4(
        jnp.asarray(b0), [jnp.asarray(e) for e in evens], [jnp.asarray(o) for o in odds],
        jnp.asarray(query), *map(jnp.float32, args)))
    _close(t, j, 1e-6)
    ulp = tmm.transmittance_at_depth_4(T(b0), [T(e) for e in evens], [T(o) for o in odds],
                                       T(np.nextafter(query, np.float32(2))), *map(T, args))
    assert np.abs(ulp.numpy() - t).max() > 1e-2


# The MBOIT kernel modes (B2 'mboit_gen' and 'mboit_resolve'), plain version
# vs the JAX kernel on the port's binning, walk scene 96x64, tile 16x8, with
# the params of `prepare_mboit_frame`. Bars, measured on this scene:
# - 'mboit_gen': every moment within 2e-3 of the pixel's b0 (measured at most
#   1.2e-3, trigonometric 8), within 1e-4 on >= 60% of pixels (measured
#   63-100%); b0 itself within 1e-5 of b0. The moments follow the hit depth's
#   f32 noise floor (ROADMAP queue C, B2) through the log warp, and the
#   trigonometric ones through k * pi of phase per unit of warped depth;
# - 'mboit_resolve' on identical moments: the sums of a*T*rgb and a*T within
#   2e-3 on >= 99% (power 4; measured 99.2%) and >= 80% (trigonometric 8;
#   measured 85%) of pixels: T at a fragment's own depth turns on an ulp
#   (test_transmittance_at_a_fragments_own_depth), and the two packages' hit
#   depths differ by ulps.

def _mboit_kernel_frame(n_mom, trig):
    from tests.test_torch_oit_modes import _camera, _settings, _walk
    from linevis_tpu_torch.render import oit as toit
    from linevis_tpu_torch.render import tube_raster as ttr
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings

    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    S = _settings(RasterSettings)
    csr, params, _ = toit.prepare_mboit_frame(
        ts, *ttr.camera_tensors(_camera(Camera), "cpu"), S, n_mom, 0.4, trigonometric=trig
    )
    return csr, params, S


@pytest.mark.parametrize("trig", [False, True], ids=["power", "trigonometric"])
@pytest.mark.parametrize("n_mom", [4, 6, 8])
def test_mboit_gen_matches_jax_kernel(n_mom, trig):
    from tests.test_torch_oit_modes import _jax_kernel, _port_kernel

    csr, params, S = _mboit_kernel_frame(n_mom, trig)
    kw = dict(K=2, store_mode="mboit_gen", n_mom=n_mom, trig=trig)
    jd, jr, ja = _jax_kernel(csr, params, S, **kw)
    td, tr, ta = _port_kernel(csr, params, S, **kw)
    b0 = jd[0]
    live = b0 > 0
    assert live.sum() > 300
    np.testing.assert_allclose(td[0], b0, rtol=1e-5, atol=0)
    err = np.maximum(np.maximum(np.abs(td - jd).max(0), np.abs(tr - jr).max(axis=(0, 1))),
                     np.abs(ta - ja).max(0))
    rel = err[live] / b0[live]
    assert rel.max() <= 2e-3, rel.max()
    assert (rel <= 1e-4).mean() >= 0.6, (rel <= 1e-4).mean()
    assert (err[~live] == 0).all()


@pytest.mark.parametrize("n_mom,trig,share", [(4, False, 0.99), (8, True, 0.8)],
                         ids=["power4", "trigonometric8"])
def test_mboit_resolve_matches_jax_kernel(n_mom, trig, share):
    from tests.test_torch_oit_modes import _jax_kernel, _port_kernel

    csr, params, S = _mboit_kernel_frame(n_mom, trig)
    d, rgb, a = _port_kernel(csr, params, S, K=2, store_mode="mboit_gen", n_mom=n_mom,
                             trig=trig)
    nh = n_mom // 2
    moments = np.stack([d[0], *(rgb[0, 0], rgb[1, 0], rgb[2, 0], a[0])[:nh],
                        *(d[1], rgb[0, 1], rgb[1, 1], rgb[2, 1])[:nh]])
    kw = dict(K=1, store_mode="mboit_resolve", n_mom=n_mom, trig=trig)
    jd, jc, ja = _jax_kernel(csr, params, S, moments=jnp.asarray(moments), **kw)
    td, tc, ta = _port_kernel(csr, params, S, moments=torch.tensor(moments), **kw)
    live = moments[0] > 0
    assert live.sum() > 300 and np.isfinite(tc).all() and np.isfinite(ta).all()
    err = np.maximum(np.abs(tc - jc).max(axis=(0, 1)), np.abs(ta - ja).max(0))
    assert (err[live] <= 2e-3).mean() >= share, (err[live] <= 2e-3).mean()
    assert (err[~live] == 0).all()
