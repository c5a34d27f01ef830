"""linevis_tpu_torch geometry (frames, tube meshing) vs the JAX package on the CPU.

The same numpy inputs go through `linevis_tpu.geometry` and its port. Bars:
tangents, normals, binormals, ring positions and vertex normals within 1e-5
(float32 round-off of a 64-step Gram-Schmidt recurrence: XLA fuses the
projection's multiply-adds, the port does not); the triangle index lattice
and the triangle mask exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.geometry import frames as jframes
from linevis_tpu.geometry import tubes as jtubes
from linevis_tpu_torch.convert import tube_mesh_from_numpy
from linevis_tpu_torch.geometry import frames as tframes
from linevis_tpu_torch.geometry import tubes as ttubes

torch.set_num_threads(1)

TOL = 1e-5


def _helix(n=64):
    t = np.linspace(0, 4 * np.pi, n).astype(np.float32)
    pos = np.stack([np.cos(t), np.sin(t), 0.1 * t], axis=-1)[None]
    return pos, np.ones((1, n), bool), np.linspace(0, 1, n, dtype=np.float32)[None]


def _golden_walk(seed=11, L=6, P=8, spread=0.06):
    # tests/golden_scenes.py:_line_data's trajectories.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, spread, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, 1, P)).astype(np.float32)[:, 0]
    return pos, np.ones((L, P), bool), attrs


def _padded():
    # A line padded by repeating its last point, and a line along +y whose
    # first normal needs the helper-axis choice.
    pos = np.zeros((2, 8, 3), np.float32)
    pos[0, :, 0] = np.minimum(np.arange(8), 4)
    pos[1, :, 1] = np.arange(8) * 0.5
    pos[1, :, 2] = np.sin(np.arange(8))
    mask = np.ones((2, 8), bool)
    mask[0, 5:] = False
    return pos, mask, np.zeros((2, 8), np.float32)


SCENES = {"helix": _helix, "golden_walk": _golden_walk, "padded": _padded}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_parallel_transport_frames_match_jax(name):
    pos, mask, _ = SCENES[name]()
    j = jframes.parallel_transport_frames(jnp.asarray(pos), jnp.asarray(mask))
    t = tframes.parallel_transport_frames(torch.tensor(pos), torch.tensor(mask))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    tt, tn, tb = (x.numpy() for x in t)
    for v in (tt, tn, tb):
        np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=TOL)
    for u, v in ((tt, tn), (tt, tb), (tn, tb)):
        np.testing.assert_allclose(np.sum(u * v, axis=-1), 0.0, atol=TOL)


def test_compute_tangents_straight_line():
    pos = np.zeros((1, 8, 3), np.float32)
    pos[0, :, 0] = np.arange(8)
    t = tframes.compute_tangents(torch.tensor(pos), torch.ones((1, 8), dtype=torch.bool))
    np.testing.assert_allclose(t.numpy(), np.broadcast_to([1.0, 0, 0], (1, 8, 3)), atol=1e-6)


@pytest.mark.parametrize("subdiv", [4, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_tube_triangle_mesh_matches_jax(name, subdiv):
    pos, mask, attrs = SCENES[name]()
    jm = jtubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.05,
                                         num_subdivisions=subdiv)
    tm = ttubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.05,
                                         num_subdivisions=subdiv, device="cpu")
    assert tm.grid_shape == tuple(jm.grid_shape)
    assert tm.num_triangles == jm.num_triangles and tm.num_vertices == jm.num_vertices
    for f in ("positions", "normals", "tangents", "attrs"):
        a, b = getattr(tm, f), np.asarray(getattr(jm, f))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, f
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL, err_msg=f)
    for f in ("mask", "triangles", "triangle_mask"):
        a, b = getattr(tm, f), np.asarray(getattr(jm, f))
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    # Every ring vertex is `radius` away from its centerline point.
    S, (L, P) = subdiv, pos.shape[:2]
    d = np.linalg.norm(tm.positions.numpy() - pos.transpose(2, 0, 1)[:, None], axis=0)
    np.testing.assert_allclose(d, 0.05, atol=TOL)
    assert tm.vertices.shape == (3, S * L * P)


def test_tube_topology_and_corner_grids_match_jax():
    L, P, S = 3, 5, 6
    np.testing.assert_array_equal(ttubes._tube_topology(L, P, S),
                                  jtubes._tube_topology(L, P, S))
    np.testing.assert_array_equal(ttubes.tube_ring_directions(S),
                                  jtubes.tube_ring_directions(S))
    g = np.random.default_rng(3).normal(size=(2, S, L, P)).astype(np.float32)
    for a, b in zip(ttubes.corner_grids(torch.tensor(g), S),
                    jtubes.corner_grids(jnp.asarray(g), S)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The corner grids are the indexed view's corners.
    flat = g[0].reshape(-1)
    tris = ttubes._tube_topology(L, P, S)
    for k, c in enumerate(ttubes.corner_grids(torch.tensor(g[0]), S)):
        np.testing.assert_array_equal(c.reshape(-1).numpy(), flat[tris[k]])


def test_tube_mesh_masking():
    # tests/test_geometry.py:test_tube_mesh_masking on the port.
    pos = np.zeros((1, 8, 3), np.float32)
    pos[0, :, 0] = np.arange(8)
    mask = np.ones((1, 8), bool)
    mask[0, 5:] = False  # 5 valid points -> 4 valid segments
    mesh = ttubes.build_tube_triangle_mesh(pos, mask, np.zeros((1, 8), np.float32),
                                           num_subdivisions=4, device="cpu")
    tri_mask = mesh.triangle_mask.numpy().reshape(4, 2, 1, 7)
    assert tri_mask[:, :, :, :4].all()
    assert not tri_mask[:, :, :, 4:].any()


def test_tube_mesh_from_numpy_matches_build_tube_triangle_mesh():
    pos, mask, attrs = _golden_walk()
    mask[2, 5:] = False
    jm = jtubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02)
    conv = tube_mesh_from_numpy(
        {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}, device="cpu"
    )
    built = ttubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02, device="cpu")
    for f in dataclasses.fields(built):
        a, b = getattr(conv, f.name), getattr(built, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
        elif a.dtype == torch.float32:
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
