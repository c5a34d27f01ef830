"""linevis_tpu_torch tracer, fields and trajectory helpers vs the JAX package on the CPU.

Seeds come from numpy (jax.random's bits cannot be reproduced) and go to
both. Bars: masks equal; positions within 1e-6; velocity magnitude within
1e-6; vorticity magnitude and helicity within 1e-4, because their central
differences (h = 1e-3) scale the fields' float32 rounding (~6e-8) by 1/(2h).

Grids: the port builds them on the host with torch's sin/cos, JAX with
XLA's, so `make_tornado_grid` / `make_abc_flow_grid` agree within 1e-6 and
the tracer tests hand the JAX grid to both; `sample_grid_trilinear` on the
same grid is bit for bit. On a grid the vorticity's central differences
cross trilinear cell boundaries, so there the derived attributes are held
within 1e-4 relative to their largest magnitude.

Adaptive RKF45 and loop termination turn on single roundings (the step
controller's (tol/err)^0.2, whose float32 pow XLA and torch round
differently, the accept test, the loop test d2 < distance^2), and one
flipped decision changes the rest of a line. On the smooth rotation field
the decisions agree: masks equal, positions within 1e-6. On the tornado
grid (64 seeds, RKF45 at tol 1e-5 with loop termination at 0.01) every line
kept its point count at 20 and at 200 steps (measured), so the test
requires it of 95% of the lines and holds those within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.core import trajectories as jtraj
from linevis_tpu.trace import fields as jfields
from linevis_tpu.trace import streamline as jstream
from linevis_tpu.trace.fields import tornado_velocity as jtornado
from linevis_tpu.trace.streamline import StreamlineTracingSettings as JSettings
from linevis_tpu.trace.streamline import trace_streamlines as jtrace
from linevis_tpu_torch.convert import trajectories_from_numpy
from linevis_tpu_torch.core import trajectories as ttraj
from linevis_tpu_torch.trace import fields as tfields
from linevis_tpu_torch.trace import streamline as tstream
from linevis_tpu_torch.trace.fields import tornado_velocity as ttornado
from linevis_tpu_torch.trace.streamline import StreamlineTracingSettings as TSettings
from linevis_tpu_torch.trace.streamline import trace_streamlines as ttrace

torch.set_num_threads(1)


def test_tornado_velocity_matches_jax():
    p = np.random.default_rng(0).uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    for time in (0.0, 3.5):
        j = np.asarray(jtornado(jnp.asarray(p), time=time))
        t = ttornado(torch.tensor(p), time=time).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def traced():
    seeds = np.random.default_rng(42).uniform(size=(16, 3)).astype(np.float32)
    kw = dict(num_seeds=16, max_steps=50, dt=1.0 / 150.0)
    j = jtrace(jtornado, JSettings(**kw), seeds=jnp.asarray(seeds))
    t = ttrace(ttornado, TSettings(**kw), seeds=torch.tensor(seeds), device="cpu")
    return j, t


def test_rk4_trace_matches_jax(traced):
    j, t = traced
    assert t.positions.shape == j.positions.shape == (16, 51, 3)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.num_points, j.num_points)
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)
    assert t.attribute_names == j.attribute_names
    np.testing.assert_allclose(t.attributes[:, 0], j.attributes[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.attributes[:, 1:], j.attributes[:, 1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("integrator", ["explicit_euler", "heun", "midpoint", "rkf45"])
def test_fixed_step_integrators_match_jax(integrator):
    seeds = np.random.default_rng(3).uniform(0.2, 0.8, (8, 3)).astype(np.float32)
    kw = dict(num_seeds=8, max_steps=20, dt=1.0 / 100.0, integrator=integrator,
              backward=True, forward=False)
    j = jtrace(jtornado, JSettings(**kw), seeds=jnp.asarray(seeds))
    t = ttrace(ttornado, TSettings(**kw), seeds=seeds, device="cpu")
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)


def test_trace_terminates_out_of_bounds():
    """Seeds at the box edge leave it: the mask ends and positions freeze,
    as in the JAX tracer."""
    seeds = np.array([[0.999, 0.5, 0.5], [0.02, 0.02, 0.98], [0.5, 0.5, 0.5]],
                     np.float32)
    kw = dict(num_seeds=3, max_steps=40, dt=1.0 / 50.0)
    j = jtrace(jtornado, JSettings(**kw), seeds=jnp.asarray(seeds))
    t = ttrace(ttornado, TSettings(**kw), seeds=seeds, device="cpu")
    np.testing.assert_array_equal(t.mask, j.mask)
    assert not t.mask.all()
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)


def _rot_t(p):
    return torch.stack([-(p[..., 1] - 0.5), p[..., 0] - 0.5, torch.zeros_like(p[..., 0])], -1)


def _rot_j(p):
    return jnp.stack([-(p[..., 1] - 0.5), p[..., 0] - 0.5, jnp.zeros_like(p[..., 0])], -1)


@pytest.mark.parametrize(
    "change", [{"adaptive": True, "integrator": "rkf45"}, {"termination_distance": 0.01}]
)
def test_unported_options_raise(change):
    """Once unported, now held against JAX: adaptive RKF45 (tests/test_trace.py
    test_rkf45_adaptive_matches_fixed_on_smooth_field's settings) and loop
    termination (test_proximity_loop_termination's) on the rotation field,
    where every decision agrees."""
    seeds = np.array([[0.7, 0.5, 0.5], [0.6, 0.6, 0.5]], np.float32)
    if "adaptive" in change:
        kw = dict(max_steps=256, dt=1.0 / 256.0, tolerance=1e-7, dt_min=1.0 / 1024.0,
                  dt_max=1.0 / 64.0, **change)
    else:
        kw = dict(max_steps=512, dt=1.0 / 32.0, loop_min_gap=16,
                  **dict(change, termination_distance=0.02))
    j = jtrace(_rot_j, JSettings(**kw), seeds=jnp.asarray(seeds))
    t = ttrace(_rot_t, TSettings(**kw), seeds=seeds, device="cpu")
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.num_points, j.num_points)
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.attributes, j.attributes, rtol=0, atol=1e-4)
    m = t.mask  # prefix masks (adaptive: after compaction)
    assert all(m[i, :m[i].sum()].all() for i in range(m.shape[0]))
    if "adaptive" in change:
        assert t.num_points.max() <= 257
    else:
        assert t.num_points[0] < 300  # stopped after about one orbit


def test_fields_and_grids_match_jax():
    p = np.random.default_rng(0).uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    j = np.asarray(jfields.abc_flow_velocity(jnp.asarray(p)))
    np.testing.assert_allclose(tfields.abc_flow_velocity(torch.tensor(p)).numpy(), j,
                               rtol=0, atol=1e-5)
    for make in ("make_tornado_grid", "make_abc_flow_grid"):
        a, b = getattr(tfields, make)(20), getattr(jfields, make)(20)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (20, 20, 20, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 if "abc" in make else 1e-6)


def test_grid_sampling_matches_jax():
    # tests/test_trace.py test_grid_sampling_matches_analytic on the port,
    # and bit for bit against the JAX sampler, out-of-bounds points included.
    grid = jfields.make_tornado_grid(res=48)
    p = np.random.default_rng(1).uniform(-0.2, 1.2, (4096, 3)).astype(np.float32)
    t = tfields.sample_grid_trilinear(torch.tensor(grid), torch.tensor(p)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(jfields.sample_grid_trilinear(jnp.asarray(grid), jnp.asarray(p))))
    inner = np.all((p >= 0.1) & (p <= 0.9), axis=1)
    exact = ttornado(torch.tensor(p[inner])).numpy()
    err = np.linalg.norm(t[inner] - exact, axis=-1)
    assert np.median(err) < 0.15 * np.linalg.norm(exact, axis=-1).mean()


def _attr_close(t, j, tol=1e-4):
    scale = np.abs(j).reshape(j.shape[0], j.shape[1], -1).max(axis=(0, 2))
    err = np.abs(t - j).reshape(j.shape[0], j.shape[1], -1).max(axis=(0, 2))
    assert (err <= tol * np.maximum(scale, 1e-30)).all(), err / scale


def test_grid_tracer_matches_jax():
    # tests/test_trace.py test_grid_tracer_and_attributes on both packages.
    grid = jfields.make_tornado_grid(res=32)
    seeds = tstream.seed_points_plane(torch.Generator().manual_seed(0), 8, axis=2, offset=0.2)
    assert seeds.shape == (8, 3) and bool((seeds[:, 2] == 0.2).all())
    kw = dict(num_seeds=8, max_steps=64, dt=1 / 64)
    j = jstream.trace_streamlines_grid(grid, JSettings(**kw), seeds=jnp.asarray(seeds.numpy()))
    t = tstream.trace_streamlines_grid(grid, TSettings(**kw), seeds=seeds, device="cpu")
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_allclose(t.positions, j.positions, rtol=0, atol=1e-6)
    assert t.attribute_names == j.attribute_names and np.isfinite(t.attributes).all()
    _attr_close(t.attributes, j.attributes)
    assert t.mask.any()
    v = tstream.seed_points_volume(torch.Generator().manual_seed(1), 5)
    assert v.shape == (5, 3) and bool(((v >= 0) & (v < 1)).all())


@pytest.mark.parametrize("steps", [20, 200])
def test_adaptive_loop_trace_on_grid_matches_jax(steps):
    grid = jfields.make_tornado_grid(res=32)
    seeds = np.random.default_rng(42).uniform(size=(64, 3)).astype(np.float32)
    kw = dict(num_seeds=64, max_steps=steps, dt=1.0 / 150.0, integrator="rkf45", adaptive=True,
              tolerance=1e-5, termination_distance=0.01)
    j = jstream.trace_streamlines_grid(grid, JSettings(**kw), seeds=jnp.asarray(seeds))
    t = tstream.trace_streamlines_grid(grid, TSettings(**kw), seeds=seeds, device="cpu")
    same = t.num_points == j.num_points
    assert same.mean() >= 0.95
    np.testing.assert_allclose(t.positions[same], j.positions[same], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.mask[same], j.mask[same])
    assert j.num_points.min() < j.num_points.max()  # lines stop at different steps


def test_streamribbons_match_jax():
    # tests/test_trace.py test_streamribbons_orthogonal_right_vectors on both.
    seeds = np.random.default_rng(42).uniform(size=(4, 3)).astype(np.float32)
    kw = dict(num_seeds=4, max_steps=32, dt=1.0 / 128.0)
    jt, jr = jstream.trace_streamribbons(jtornado, JSettings(**kw), seeds=jnp.asarray(seeds))
    tt, tr = tstream.trace_streamribbons(ttornado, TSettings(**kw), device="cpu")
    np.testing.assert_array_equal(tt.mask, jt.mask)
    assert tr.shape == tt.positions.shape
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=0, atol=1e-5)
    v = ttornado(torch.tensor(tt.positions)).numpy()
    tan = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    assert np.abs(np.sum(tr * tan, axis=-1))[tt.mask].max() < 1e-3
    np.testing.assert_allclose(np.linalg.norm(tr, axis=-1)[tt.mask], 1.0, atol=1e-4)


def test_trajectory_helpers_match_jax(traced):
    j, t = traced
    jt = jtraj.normalize_attributes(jtraj.normalize_trajectories(j))
    conv = trajectories_from_numpy(
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    )
    tt = ttraj.normalize_attributes(ttraj.normalize_trajectories(conv))
    np.testing.assert_array_equal(
        ttraj.compute_trajectories_aabb(conv), jtraj.compute_trajectories_aabb(j)
    )
    np.testing.assert_array_equal(tt.positions, jt.positions)
    np.testing.assert_array_equal(tt.attributes, jt.attributes)
    np.testing.assert_array_equal(tt.segment_mask(), jt.segment_mask())
    assert tt.attribute_names == jt.attribute_names
