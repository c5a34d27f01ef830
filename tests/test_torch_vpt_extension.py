"""Kernels R7 (decomposition tracking) and R8 (residual ratio tracking) on
the CPU: their wrappers run the plain versions here, held against the JAX
package on the same inputs.

The port draws jax.random's own stream (ops/threefry.py), so on the same
key it traces the JAX package's paths. Bars:
- R7 (`kernels/vpt_decomposition.py`) and R8 (`kernels/vpt_residual_ratio.py`)
  through `vpt_trace_rays` equal their wrappers called directly, bit for bit,
  and JAX's `vpt_trace_rays` per ray: radiance within 1e-4 on at least 95%
  of rays, first-scatter flags likewise (`test_torch_vpt.py`'s
  `test_modes_equal_jax` bars; R8 on JAX's own super-voxel grid, whose mean
  XLA sums in another order).
- A slice of the rays traced with its offset (`first`) equals that slice of
  the whole trace bit for bit; without the offset it differs.
- R7's events equal a direct count of the event keys its loop draws, and
  its events by kind partition them, the scatters equal to the scatter
  draws ray by ray; R8's
  residual steps equal the draws of `_rr_segments`, its DDA steps with a
  segment the calls of `_rr_segments` on each ray; its bounces lie in
  [1, 11].
- At the caps (512 events; 64 DDA steps; 256 residual steps of one super
  voxel) rays stop there, and the port agrees with JAX within 1e-4 on at
  least 95% (R7) and 99% (`residual_ratio_transmittance`, the bar of
  `test_torch_scattering.py`) of rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.render import super_voxel as jsv
from linevis_tpu.render import vpt as jvpt
from linevis_tpu_torch.convert import super_voxel_grid_from_numpy
from linevis_tpu_torch.kernels import vpt_decomposition as tvd
from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render import super_voxel as tsv
from linevis_tpu_torch.render import vpt as tvpt

SUN = np.float32([0.58, 0.77, 0.27])
SUN_IC = np.float32([2.6, 2.5, 2.3])


def _t(a):
    return torch.as_tensor(np.array(a))


def _cloud(g=20, seed=4):
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    c = np.exp(-4.0 * (xx**2 + yy**2 + zz**2))
    return (c * np.random.default_rng(seed).uniform(0.5, 1.0, c.shape)).astype(np.float32)


def _rays(n, seed=2, spread=0.1):
    rng = np.random.default_rng(seed)
    o = np.tile(np.float32([0.1, 0.2, 1.0]), (n, 1))
    d = -o + rng.normal(0, spread, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[::7] = -d[::7]  # away from the box: misses
    return o, d


def _jax_trace(key, cloud, o, d, ext, alb, mode, **kw):
    out = jvpt.vpt_trace_rays(jax.random.PRNGKey(key), jnp.asarray(cloud), jnp.asarray(o),
                              jnp.asarray(d), jnp.float32(ext), jnp.float32(alb),
                              jnp.asarray(SUN), jnp.asarray(SUN_IC), mode=mode, **kw)
    return [np.asarray(x) for x in out]


def _agree(j, t, share=0.95):
    ok = (np.abs(j[0] - t[0].numpy()) <= 1e-4).all(-1)
    assert ok.mean() >= share, ok.mean()
    assert (j[2] == t[2].numpy()).mean() >= share
    return ok


def _decomposition(cloud, o, d, key, max_events=48, size=8, ext=80.0, alb=0.9, g=0.3,
                   events=None, first=0, kinds=None):
    grid = _t(cloud)
    dmin, dmax = tsv.build_super_voxel_minmax(grid, size)
    p = tvd.decomposition_params(grid.shape, dmin.shape, (ext,) * 3, (alb,) * 3, SUN, SUN_IC, g,
                                 max_events)
    return tvd.vpt_decomposition(grid, dmin, dmax, _t(o), _t(d), key, p, events=events,
                                 first=first, kinds=kinds)


def test_r7_equals_trace_rays_and_jax():
    cloud = _cloud()
    o, d = _rays(160)
    ext, alb = [80.0] * 3, [0.9] * 3
    t = tvpt.vpt_trace_rays(threefry.prng_key(8), _t(cloud), _t(o), _t(d), ext, alb, SUN, SUN_IC,
                            phase_g=0.3, mode="Decomposition Tracking", max_events=48)
    w = _decomposition(cloud, o, d, threefry.prng_key(8))
    for a, b in zip(t, w):
        assert torch.equal(a, b)
    j = _jax_trace(8, cloud, o, d, ext, alb, "Decomposition Tracking", phase_g=0.3,
                   max_events=48)
    _agree(j, t)
    assert not bool(t[2].any()) and bool((t[0][::7] > 0).all())


def _rr_sv(cloud, ext=80.0, size=8):
    """JAX's super-voxel grid of the cloud, carried to the port (its mean is
    summed in XLA's order)."""
    jg = jsv.build_super_voxel_grid(jnp.asarray(cloud), jnp.float32(ext), size)
    return super_voxel_grid_from_numpy({"mu_c": jg.mu_c, "mu_r_bar": jg.mu_r_bar, "size": size},
                                       "cpu")


def test_r8_equals_trace_rays_and_jax():
    cloud = _cloud()
    o, d = _rays(160)
    ext, alb = [80.0] * 3, [0.9] * 3
    t = tvpt.vpt_trace_rays(threefry.prng_key(8), _t(cloud), _t(o), _t(d), ext, alb, SUN, SUN_IC,
                            phase_g=0.3, mode="Residual Ratio Tracking")
    grid = _t(cloud)
    sv = tsv.build_super_voxel_grid(grid, 80.0, 8)
    p = tvr.rr_params(grid.shape, sv.mu_c.shape, ext, alb, SUN, SUN_IC, 0.3)
    w = tvr.vpt_residual_ratio(grid, sv, _t(o), _t(d), threefry.prng_key(8), p)
    for a, b in zip(t, w):
        assert torch.equal(a, b)
    on_jax_sv = tvr.vpt_residual_ratio(grid, _rr_sv(cloud), _t(o), _t(d), threefry.prng_key(8), p)
    j = _jax_trace(8, cloud, o, d, ext, alb, "Residual Ratio Tracking", phase_g=0.3)
    _agree(j, on_jax_sv)
    assert bool(t[2].any())
    with pytest.raises(ValueError, match="steps"):
        tvpt.vpt_trace_rays(threefry.prng_key(8), grid, _t(o), _t(d), ext, alb, SUN, SUN_IC,
                            mode="Residual Ratio Tracking", events=torch.empty(160,
                                                                               dtype=torch.int32))


def test_r7_r8_slices_take_the_frames_ray_keys():
    """Ray i of a call takes `split(kt, .)[first + i]` in R7 and R8: a slice
    traced with its offset equals that slice of the whole trace."""
    cloud = _cloud(seed=6)
    o, d = _rays(120, seed=5)
    a, b = 40, 100
    kt = threefry.split(threefry.prng_key(9), 3)[2]
    whole = _decomposition(cloud, o, d, kt)
    part = _decomposition(cloud, o[a:b], d[a:b], kt, first=a)
    for x, y in zip(whole, part):
        assert torch.equal(x[a:b], y)
    assert not torch.equal(_decomposition(cloud, o[a:b], d[a:b], kt)[0], part[0])
    grid = _t(cloud)
    sv = tsv.build_super_voxel_grid(grid, 80.0, 8)
    p = tvr.rr_params(grid.shape, sv.mu_c.shape, 80.0, 0.9, SUN, SUN_IC, 0.3)
    whole = tvr.vpt_residual_ratio(grid, sv, _t(o), _t(d), kt, p)
    part = tvr.vpt_residual_ratio(grid, sv, _t(o[a:b]), _t(d[a:b]), kt, p, first=a)
    for x, y in zip(whole, part):
        assert torch.equal(x[a:b], y)
    assert bool(whole[2][a:b].any())
    assert not torch.equal(tvr.vpt_residual_ratio(grid, sv, _t(o[a:b]), _t(d[a:b]), kt, p)[0],
                           part[0])


def test_r7_events_equal_a_direct_count(monkeypatch):
    """`events` against the event keys the plain loop draws, ray by ray
    (each live ray draws split(key, .)[j] once an event)."""
    cloud = _cloud()
    o, d = _rays(100)
    n = o.shape[0]
    kt = threefry.prng_key(3)
    ray_keys = threefry.split(kt, n)
    drawn = torch.zeros(n, dtype=torch.int64)
    split_at = threefry.split_at

    def counting(key, i):
        if isinstance(i, int):
            drawn.add_((key[:, None, :] == ray_keys[None]).all(-1).sum(0))
        return split_at(key, i)

    monkeypatch.setattr(tvd.threefry, "split_at", counting)
    ev = torch.full((n,), -1, dtype=torch.int32)
    _decomposition(cloud, o, d, kt, events=ev)
    assert torch.equal(ev.long(), drawn) and int(ev.max()) > 10 and not bool(ev[::7].any())


def test_r7_event_kinds_equal_a_direct_count(monkeypatch):
    """`kinds` partitions each ray's events; its scatters equal the scatter
    draws of the plain loop (split(split(split(key, j), 5)[4], 2), ray by
    ray), its absorbs the rays whose radiance is zero; on an empty cloud
    every event is a skip and makes no collision."""
    cloud = _cloud()
    o, d = _rays(100)
    n, cap = o.shape[0], 48
    kt = threefry.prng_key(3)
    ray_keys = threefry.split(kt, n)
    scatter_keys = torch.stack([threefry.split(threefry.split_at(ray_keys, j), 5)[:, 4]
                                for j in range(cap)], 1)  # [n, cap, 2]
    drawn = torch.zeros(n, dtype=torch.int64)
    split = threefry.split

    def counting(key, n_=2):
        if n_ == 2:
            hits = (key[:, None, None, :] == scatter_keys[None]).all(-1).any(-1)
            drawn.add_(hits.sum(0))
        return split(key, n_)

    monkeypatch.setattr(tvd.threefry, "split", counting)
    ev = torch.empty(n, dtype=torch.int32)
    kinds = torch.full((n, len(tvd.EVENT_KINDS)), -1, dtype=torch.int32)
    rad = _decomposition(cloud, o, d, kt, max_events=cap, events=ev, kinds=kinds)[0]
    k = dict(zip(tvd.EVENT_KINDS, kinds.long().unbind(1)))
    assert torch.equal(kinds[:, :6].sum(1), ev)
    assert torch.equal(k["scatter"], drawn) and int(drawn.sum()) > 0
    assert torch.equal(k["absorb"] == 1, (rad == 0).all(1)) and int(k["absorb"].max()) == 1
    assert bool((k["tested_collision"] <= k["absorb"] + k["scatter"]).all())
    for name in ("enter", "residual", "residual_tested", "tested_collision"):
        assert int(k[name].sum()) > 0, name
    monkeypatch.setattr(tvd.threefry, "split", split)
    _decomposition(np.zeros_like(cloud), o, d, kt, max_events=cap, events=ev, kinds=kinds)
    assert torch.equal(kinds[:, 0], ev) and not bool(kinds[:, 1:].any()) and int(ev.max()) > 1


def test_r8_steps_equal_a_direct_count(monkeypatch):
    """`steps` (DDA steps inside the grid, residual steps) against the
    segment calls and residual draws of the plain tracer: every DDA step of
    these rays has a segment of non-zero length."""
    cloud = _cloud()
    o, d = _rays(100)
    grid = _t(cloud)
    sv = tsv.build_super_voxel_grid(grid, 80.0, 4)
    p = tvr.rr_params(grid.shape, sv.mu_c.shape, 80.0, 0.9, SUN, SUN_IC, 0.3)
    seen = {"segments": 0, "draws": 0}
    segments, split = tsv._rr_segments, tsv.threefry.split

    def counting_segments(keys, *args):
        seen["segments"] += keys.shape[0]
        return segments(keys, *args)

    def counting_split(key, n=2):
        if n == 3:  # the residual step's split(key, 3)
            seen["draws"] += key.shape[0]
        return split(key, n)

    monkeypatch.setattr(tsv, "_rr_segments", counting_segments)
    monkeypatch.setattr(tsv.threefry, "split", counting_split)
    steps = torch.full((o.shape[0], 3), -1, dtype=torch.int32)
    tvr.vpt_residual_ratio(grid, sv, _t(o), _t(d), threefry.prng_key(3), p, steps=steps)
    assert int(steps[:, 1].sum()) == seen["segments"] > 0
    assert int(steps[:, 2].sum()) == seen["draws"] > 0
    assert not bool(steps[::7, 1:].any()) and int(steps[:, 0].min()) >= 1
    assert int(steps[:, 0].max()) > 1  # bounces


def test_r7_at_the_event_cap_equals_jax():
    """A dense cloud at a high extinction: rays run into the 512-event cap,
    whose truncated state is the JAX scan's."""
    cloud = np.full((12, 12, 12), 0.8, np.float32)
    cloud[3:9, 3:9, 3:9] = 1.0
    o, d = _rays(96, spread=0.05)
    ext, alb = [4000.0] * 3, [1.0] * 3
    ev = torch.empty(o.shape[0], dtype=torch.int32)
    t = tvpt.vpt_trace_rays(threefry.prng_key(5), _t(cloud), _t(o), _t(d), ext, alb, SUN, SUN_IC,
                            phase_g=0.5, mode="Decomposition Tracking", max_events=512,
                            events=ev, super_voxel_size=4)
    assert int((ev == 512).sum()) >= 10
    j = _jax_trace(5, cloud, o, d, ext, alb, "Decomposition Tracking", phase_g=0.5,
                   max_events=512, super_voxel_size=4)
    _agree(j, t)


def test_rr_transmittance_at_the_caps_equals_jax():
    """`residual_ratio_transmittance` through R8's route against JAX's: 24
    super voxels a side, so that diagonal rays pass the 64-step DDA cap; one
    super voxel of high extinction, so that rays take all 256 residual
    steps of its segment (an empty cloud with a few voxels at 1: the
    control term does not underflow while the residual steps run out)."""
    rng = np.random.default_rng(1)
    key = threefry.prng_key(2)
    for cloud, size, ext, cap in ((_cloud(48, seed=5), 2, 60.0, 0),
                                  ((rng.uniform(0.0, 1.0, (8, 8, 8)) < 0.03).astype(np.float32),
                                   8, 2000.0, 1)):
        o = np.tile(np.float32([0.6, 0.55, 0.62]), (64, 1)) + rng.normal(0, 0.02, (64, 3))
        d = -o + rng.normal(0, 0.02, (64, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o = o.astype(np.float32)
        jg = jsv.build_super_voxel_grid(jnp.asarray(cloud), jnp.float32(ext), size)
        jT = np.asarray(jsv.residual_ratio_transmittance(jax.random.PRNGKey(2), jnp.asarray(cloud),
                                                         jg, jnp.asarray(o), jnp.asarray(d), ext))
        sv = _rr_sv(cloud, ext, size)
        tT = tsv.residual_ratio_transmittance(key, _t(cloud), sv, _t(o), _t(d), ext)
        assert (np.abs(jT - tT.numpy()) <= 1e-4).mean() >= 0.99
        steps = torch.empty((64, 3), dtype=torch.int32)
        p = tvr.rr_params(cloud.shape, sv.mu_c.shape, ext, 0.0)
        again = tvr.rr_transmittance(_t(cloud), sv, _t(o), _t(d), key, p, steps=steps)
        assert torch.equal(tT, again)
        at_cap = steps[:, 1 + cap] == (64, 256)[cap]
        assert int(at_cap.sum()) >= 8 and bool((steps[:, 0] == 1).all())
