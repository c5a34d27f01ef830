"""linevis_tpu_torch tracer and trajectory helpers vs the JAX package on the CPU.

Seeds come from numpy (jax.random's bits cannot be reproduced) and go to
both. Bars: masks equal; positions within 1e-6; velocity magnitude within
1e-6; vorticity magnitude and helicity within 1e-4, because their central
differences (h = 1e-3) scale the fields' float32 rounding (~6e-8) by 1/(2h).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.core import trajectories as jtraj
from linevis_tpu.trace.fields import tornado_velocity as jtornado
from linevis_tpu.trace.streamline import StreamlineTracingSettings as JSettings
from linevis_tpu.trace.streamline import trace_streamlines as jtrace
from linevis_tpu_torch.convert import trajectories_from_numpy
from linevis_tpu_torch.core import trajectories as ttraj
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


@pytest.mark.parametrize(
    "change", [{"adaptive": True, "integrator": "rkf45"}, {"termination_distance": 0.01}]
)
def test_unported_options_raise(change):
    with pytest.raises(NotImplementedError):
        ttrace(ttornado, TSettings(num_seeds=2, max_steps=2, **change), device="cpu")


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
