"""The port's sample draws against jax.random on the CPU.

Every draw the JAX package takes from jax.random, the port takes from
`ops/threefry.py` under the same keys:
- RTAO's two uniforms a frame (`linevis_tpu/render/rtao.py:58-64, 159`):
  `render/rtao.py:hemisphere_uniforms`, through kernel R6's wrapper
  (`kernels/threefry_uniform.py`, whose CPU path is the plain version);
  bit for bit.
- The AO bake's key chain (`linevis_tpu/render/ao_bake.py:124-129`): bit
  for bit (the bake without `uniforms=` equals the bake on JAX's uniforms:
  tests/test_torch_denoise_deferred.py::test_bake_matches_jax_bracketed).
- The streamline seeders and the tracer's default seeds
  (`linevis_tpu/trace/streamline.py:63-73, 295, 313`): bit for bit, and a
  default-argument trace equal to JAX's.
- SSAO's `jax.random.normal` directions (`linevis_tpu/render/ssao.py:55-58`):
  `threefry.normal`, whose erf_inv rounds its log1p correctly where XLA's
  does not. Bar: every draw within 3 ulps, >= 98.5% bit for bit (measured
  99.04% and 3 ulps on 400,000 draws of 20 keys).
The RTAO frame with its default draws against JAX is
tests/test_torch_rtao.py::test_render_rtao_matches_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.trace import streamline as jstream
from linevis_tpu.trace.fields import tornado_velocity as jtornado
from linevis_tpu_torch.kernels.threefry_uniform import threefry_uniform
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render import rtao as trtao
from linevis_tpu_torch.trace import streamline as tstream
from linevis_tpu_torch.trace.fields import tornado_velocity as ttornado

torch.set_num_threads(1)


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed,frame", [(0, 0), (7, 3), (123, 31)])
def test_rtao_uniforms_equal_jax(seed, frame):
    shape = (4, 6, 10)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + frame))
    u1, u2 = trtao.hemisphere_uniforms(threefry.prng_key(seed + frame), shape)
    assert u1.shape == u2.shape == shape and u1.dtype == torch.float32
    assert np.array_equal(_bits(u1.numpy()), _bits(jax.random.uniform(k1, shape)))
    assert np.array_equal(_bits(u2.numpy()), _bits(jax.random.uniform(k2, shape)))


def test_threefry_uniform_wrapper_on_the_cpu():
    """R6's wrapper on a CPU key is its plain version; on a device it has no
    kernel for it raises."""
    key = threefry.split(threefry.prng_key(5))[1]
    before = threefry_uniform.launches
    u = threefry_uniform(key, (3, 1000))
    assert threefry_uniform.launches == before  # no launch on the CPU
    assert torch.equal(u, threefry.uniform(key, (3, 1000)))
    ju = jax.random.uniform(jax.random.split(jax.random.PRNGKey(5))[1], (3, 1000))
    assert np.array_equal(_bits(u.numpy()), _bits(ju))
    # split=j draws from split(key)[j], as JAX's split-then-uniform.
    parent = threefry.prng_key(5)
    assert torch.equal(threefry_uniform(parent, (3, 1000), split=1), u)
    assert threefry_uniform.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        threefry_uniform(key.to("meta"), (4,))


def test_bake_frames_draw_jax_samples():
    """The bake's frame keys and uniforms are JAX's (`key, sub = split(key)`
    a frame, `_cosine_hemisphere(sub, ...)`)."""
    shape = (2, 48, 1)
    jkey, tkey = jax.random.PRNGKey(3), threefry.prng_key(3)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = threefry.split(tkey)
        assert np.array_equal(np.asarray(jsub).astype(np.int64), tsub.numpy())
        j1, j2 = jax.random.split(jsub)
        t1, t2 = trtao.hemisphere_uniforms(tsub, shape)
        assert np.array_equal(_bits(t1.numpy()), _bits(jax.random.uniform(j1, shape)))
        assert np.array_equal(_bits(t2.numpy()), _bits(jax.random.uniform(j2, shape)))


def test_seeders_and_default_seeds_equal_jax():
    for s in (0, 42, 1000):
        jv = jstream.seed_points_volume(jax.random.PRNGKey(s), 17)
        tv = tstream.seed_points_volume(threefry.prng_key(s), 17)
        assert np.array_equal(_bits(tv.numpy()), _bits(jv))
        jp = jstream.seed_points_plane(jax.random.PRNGKey(s), 9, axis=1, offset=0.3)
        tp = tstream.seed_points_plane(threefry.prng_key(s), 9, axis=1, offset=0.3)
        assert np.array_equal(_bits(tp.numpy()), _bits(jp))
    kw = dict(num_seeds=6, max_steps=12, dt=1.0 / 64.0)
    j = jstream.trace_streamlines(jtornado, jstream.StreamlineTracingSettings(**kw))
    t = tstream.trace_streamlines(ttornado, tstream.StreamlineTracingSettings(**kw), device="cpu")
    assert np.array_equal(_bits(t.positions[:, 0]), _bits(np.asarray(j.positions)[:, 0]))
    np.testing.assert_array_equal(t.mask, np.asarray(j.mask))
    np.testing.assert_allclose(t.positions, np.asarray(j.positions), rtol=0, atol=1e-6)


def test_normal_within_three_ulps_of_jax():
    n_eq = n_all = 0
    for s in range(20):
        j = _bits(jax.random.normal(jax.random.PRNGKey(s), (20000,))).astype(np.int64)
        t = _bits(threefry.normal(threefry.prng_key(s), (20000,)).numpy()).astype(np.int64)
        ulps = np.abs(t - j)
        assert ulps.max() <= 3, s
        n_eq += int((ulps == 0).sum())
        n_all += ulps.size
    assert n_eq / n_all >= 0.985
    # erf_inv against XLA's on the same inputs, the interval's ends included.
    x = np.concatenate([np.linspace(-1.0, 1.0, 4001, dtype=np.float32),
                        np.float32([np.nextafter(np.float32(-1), np.float32(0)), 0.0])])
    j = _bits(jax.jit(jax.lax.erf_inv)(jnp.asarray(x))).astype(np.int64)
    t = _bits(threefry.erf_inv(torch.as_tensor(x)).numpy()).astype(np.int64)
    finite = np.isfinite(np.abs(x)) & (np.abs(x) < 1)
    assert np.abs(t - j)[finite].max() <= 3
    assert np.array_equal(t[~finite], j[~finite])  # +-inf at +-1
