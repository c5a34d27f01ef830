"""The density march's empty-space skipping (R4), on the CPU.

`csrc/density_march.cu` skips each step whose trilinear cell lies in an
empty 8^3 brick (`volume_common.brick_occupancy`) where `skip_allowed`
holds, jumping over such steps only where it has verified that the step it
lands before lies in the same brick. Held here: the occupancy against a
numpy brute force (a field of no whole bricks with NaN, +-0, negative
values and +-inf); the skip rule in plain PyTorch (`density_march_skipping`)
against the unchanged plain version, `density_march_reference`, bit for
bit; the brick of each step monotone in the step, which makes the verified
jumps exact; and the kernel's walk of jumps, replayed in float32, sampling
exactly the steps in occupied bricks. The kernel itself is held against
the plain version on the card (`tests/test_torch_cuda_kernels.py`).
"""

import itertools

import numpy as np
import pytest
import torch

from linevis_tpu_torch.kernels import density_march as dm
from linevis_tpu_torch.kernels.volume_common import (
    BRICK,
    EMPTY_FLOOR,
    brick_occupancy,
    trilinear_cell,
    vdiv,
)
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.transfer_function import TransferFunction
from linevis_tpu_torch.render.tube_raster import _ray_basis, camera_tensors

RAMP = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))  # the renderer's opacity for a flat TF
W, H = 32, 24


def _occupancy_brute(g):
    nb = [-(-n // BRICK) for n in g.shape]
    out = np.zeros(nb, np.uint8)
    for bz, by, bx in itertools.product(*(range(n) for n in nb)):
        blk = g[BRICK * bz:BRICK * bz + BRICK + 1, BRICK * by:BRICK * by + BRICK + 1,
                BRICK * bx:BRICK * bx + BRICK + 1]
        out[bz, by, bx] = not np.all((blk <= 0.0) & (blk >= EMPTY_FLOOR))
    return out


def test_brick_occupancy_matches_brute_force():
    rng = np.random.default_rng(0)
    g = np.zeros((19, 26, 35), np.float32)
    for v in (0.7, np.nan, -0.0, -0.4, np.inf, -np.inf, -1e35, 1e-30):
        idx = tuple(rng.integers(0, n, 3) for n in g.shape)
        g[idx] = v
    g[8, 0, 0] = 0.5  # the first voxel of brick z 1: brick z 0 reads it too
    t = torch.as_tensor(g)
    occ = brick_occupancy(t)
    assert occ.dtype == torch.uint8 and tuple(occ.shape) == (3, 4, 5)
    assert np.array_equal(occ.numpy(), _occupancy_brute(g))
    assert int(occ[0, 0, 0]) == 1 and int(occ[1, 0, 0]) == 1
    assert brick_occupancy(t) is occ  # kept with the field
    t[8, 0, 0] = -0.0
    assert np.array_equal(brick_occupancy(t).numpy(), _occupancy_brute(t.numpy()))


@pytest.mark.parametrize("value,occupied", [
    (0.0, False), (-0.0, False), (-3.0, False), (EMPTY_FLOOR, False), (1e-38, True),
    (float("nan"), True), (float("inf"), True), (float("-inf"), True), (-1e31, True)])
def test_brick_occupancy_of_one_voxel(value, occupied):
    g = torch.zeros((10, 9, 17))
    g[4, 3, 12] = value
    occ = brick_occupancy(g)
    assert int(occ.sum()) == int(occupied) and int(occ[0, 0, 1]) == int(occupied)


def test_skip_allowed():
    c_pts, _ = TransferFunction.standard().as_static_points()
    prm = np.zeros(29, np.float32)
    prm[21], prm[22] = 1e-4, 200.0
    assert dm.skip_allowed(prm, c_pts, RAMP)
    assert dm.skip_allowed(prm, c_pts, ((0.1, 0.0), (1.0, 1.0)))  # 0 before the first point
    assert dm.skip_allowed(prm, c_pts, ((0.0, 0.5), (0.0, 0.0), (1.0, 1.0)))  # the last wins
    assert not dm.skip_allowed(prm, c_pts, ((0.0, 0.2), (1.0, 1.0)))
    assert not dm.skip_allowed(prm, c_pts, ((0.0, 0.0), (0.0, 0.5), (1.0, 1.0)))
    assert not dm.skip_allowed(prm, ((0.0, float("inf"), 0.0, 0.0), (1.0, 1.0, 1.0, 1.0)), RAMP)
    # Opacities that fall but stay >= 0 keep it; one below 0 anywhere, or a
    # negative attenuation, can drive alpha to -inf (below).
    assert dm.skip_allowed(prm, c_pts, ((0.0, 0.0), (0.5, 1.0), (1.0, 0.0)))
    assert not dm.skip_allowed(prm, c_pts, ((0.0, 0.0), (0.5, -1.0), (1.0, 1.0)))
    assert not dm.skip_allowed(prm, c_pts, ((0.0, 0.0), (0.5, 1.0), (1.0, -0.25)))
    assert not dm.skip_allowed(prm, c_pts, ((0.0, 0.0), (0.5, 1.0), (1.0, float("nan"))))
    for i, v in ((22, np.inf), (21, np.nan), (21, 0.0), (22, -200.0)):
        bad = prm.copy()
        bad[i] = v
        assert not dm.skip_allowed(bad, c_pts, RAMP)
    zero_att = prm.copy()
    zero_att[22] = 0.0
    assert dm.skip_allowed(zero_att, c_pts, RAMP)


def _sparse_field(shape=(40, 37, 45), seed=3):
    """Blobs in a few bricks, a negative and a -0 voxel; zero elsewhere."""
    rng = np.random.default_rng(seed)
    f = np.zeros(shape, np.float32)
    f[4:11, 22:30, 6:14] = rng.random((7, 8, 8))
    f[25:28, 5:9, 30:36] = rng.random((3, 4, 6))
    f[20, 20, 20], f[21, 20, 20] = -0.5, -0.0
    return torch.as_tensor(f)


def _prm(field, box, position=(-0.6, -0.45, -0.55)):
    ct = camera_tensors(Camera(position=position, look_at_point=(0.0, 0.0, 0.0), width=W,
                               height=H), "cpu")
    prm, _ = dm.march_params(field.shape, *box, ct[1], _ray_basis(ct[0]), W, H, 200.0,
                             (1.0, 1.0, 1.0, 0.0))
    return prm


CASES = {
    "sparse_pow2_box": (((-0.25,) * 3, (0.25,) * 3), RAMP, True),
    "box_not_pow2": (((-0.2, -0.27, -0.23), (0.17, 0.25, 0.21)), RAMP, True),
    "opacity_at_zero": (((-0.25,) * 3, (0.25,) * 3), ((0.0, 0.2), (1.0, 1.0)), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_rule_equals_plain_version(case):
    box, o_pts, skips = CASES[case]
    field = _sparse_field()
    prm = _prm(field, box)
    c_pts, _ = TransferFunction.standard().as_static_points()
    assert dm.skip_allowed(prm, c_pts, o_pts) == skips
    stats = {}
    got = dm.density_march_skipping(field, prm, W, H, 256, c_pts, o_pts, stats=stats)
    ref = dm.density_march_reference(field, prm, W, H, 256, c_pts, o_pts)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float(ref[..., 3].max()) > 0.5
    if skips:
        assert stats["sampled"] < 0.5 * stats["steps"]
    else:
        assert stats["sampled"] == stats["steps"]


@pytest.mark.parametrize("attenuation,o_pts", [
    (-1e5, RAMP), (1e5, ((0.0, 0.0), (0.05, -1.0), (1.0, -1.0)))])
def test_skip_rule_needs_nonnegative_alpha(monkeypatch, attenuation, o_pts):
    """Why `skip_allowed` asks for opacities and an attenuation >= 0: here
    alpha overflows to -inf in an occupied brick and acc_a with it, so an
    empty step's w = (1 - acc_a) * 0 is NaN. Taking every step in the box
    (the rule off) keeps those NaNs; skipping the empty steps would not."""
    field = torch.zeros((40, 37, 45))
    field[:, :, :BRICK] = 1.0  # x brick 0 occupied, the others empty
    prm = _prm(field, CASES["sparse_pow2_box"][0])
    prm[22] = attenuation
    c_pts, _ = TransferFunction.standard().as_static_points()
    assert not dm.skip_allowed(prm, c_pts, o_pts)
    stats = {}
    every_step = dm.density_march_skipping(field, prm, W, H, 256, c_pts, o_pts, stats=stats)
    assert stats["sampled"] == stats["steps"]
    monkeypatch.setattr(dm, "skip_allowed", lambda *args: True)
    forced = dm.density_march_skipping(field, prm, W, H, 256, c_pts, o_pts, stats=stats)
    assert stats["sampled"] < stats["steps"]
    assert int(torch.isnan(every_step).sum()) > int(torch.isnan(forced).sum())


def _step_bricks(field, prm, n_steps=256):
    """Each ray's steps as the plain version forms them -> (t [R, n], t_far
    [R], hit [R], brick [R, n] of each step's cell, d, t_near)."""
    p = [float(v) for v in prm]
    d, t_near, t_far, hit = dm.march_rays(prm, W, H, "cpu")
    t = torch.stack([dm.step_t(t_near, k, p[21]) for k in range(n_steps)], 1)
    tex = tuple(vdiv(p[9 + c] + t * d[c][:, None] - p[c], p[6 + c]) for c in range(3))
    x0, y0, z0 = (c.long() for c in trilinear_cell(field.shape, tex))
    nz, ny, nx = field.shape
    nyb, nxb = -(-ny // BRICK), -(-nx // BRICK)
    brick = ((z0 // BRICK) * nyb + y0 // BRICK) * nxb + x0 // BRICK
    return t, t_far, hit, brick, d, t_near


@pytest.mark.parametrize("case", ["sparse_pow2_box", "box_not_pow2"])
def test_step_bricks_are_monotone(case):
    """Each brick coordinate of a ray's steps is monotone in the step: two
    steps in one brick hold every step between them in it."""
    field = _sparse_field()
    t, _, hit, brick, _, _ = _step_bricks(field, _prm(field, CASES[case][0]))
    nz, ny, nx = field.shape
    nyb, nxb = -(-ny // BRICK), -(-nx // BRICK)
    for coord in (brick // (nyb * nxb), brick // nxb % nyb, brick % nxb):
        diff = coord[hit][:, 1:] - coord[hit][:, :-1]
        assert bool(((diff >= 0).all(1) | (diff <= 0).all(1)).all())


@pytest.mark.parametrize("case", ["sparse_pow2_box", "box_not_pow2"])
def test_jump_walk_samples_exactly_the_occupied_steps(case):
    """The kernel's walk (`csrc/density_march.cu`: batches of up to 4
    steps, verified jumps), replayed with float32 estimates on the exact
    bricks of each step: it samples every step in an occupied brick before
    t_far once, in order, and no other."""
    f32 = np.float32
    field = _sparse_field()
    prm = _prm(field, CASES[case][0])
    occ = brick_occupancy(field).reshape(-1).numpy()
    t, t_far, hit, brick, d, t_near = _step_bricks(field, prm)
    n_steps = t.shape[1]
    shape = field.shape[::-1]  # x, y, z
    scale = [f32(shape[c] - 1) / f32(prm[6 + c]) for c in range(3)]
    nz, ny, nx = field.shape
    nyb, nxb = -(-ny // BRICK), -(-nx // BRICK)
    jumps = 0
    for r in torch.nonzero(hit).reshape(-1).tolist():
        tr, tf, tn, br = t[r].numpy(), f32(t_far[r]), f32(t_near[r]), brick[r].numpy()
        g = [f32(d[c][r]) * scale[c] for c in range(3)]
        h = [(f32(prm[9 + c]) - f32(prm[c])) * scale[c] for c in range(3)]
        rg = [f32(0.0) if g[c] == 0 else f32(1.0) / g[c] for c in range(3)]
        inv_step = f32(1.0) / f32(prm[21])
        sampled, k = [], 0
        while k < n_steps:
            if not tr[k] < tf:
                break
            b = int(br[k])
            if occ[b]:  # a batch: the next steps before t_far in the same brick
                m = 1
                while m < 4 and k + m < n_steps and tr[k + m] < tf and br[k + m] == b:
                    m += 1
                sampled += range(k, k + m)
                k += m
                continue
            bc = (b % nxb, b // nxb % nyb, b // (nyb * nxb))
            t_exit = min([(f32(BRICK * (bc[c] + 1 if rg[c] > 0 else bc[c])) - h[c]) * rg[c]
                          for c in range(3) if rg[c] != 0] + [f32(np.inf)])
            kf = min(f32((t_exit - tn) * inv_step - f32(0.5)), (tf - tn) * inv_step + f32(0.5))
            kf = min(max(kf, f32(k)), f32(n_steps))
            kc, nxt = int(np.ceil(kf - f32(0.125))) - 1, k + 1
            if kc > k and br[kc] == b:  # steps k..kc all in brick b (or past t_far)
                nxt = kc + 1 if tr[kc] < tf else n_steps
                jumps += 1
            k = nxt
        want = [k for k in range(n_steps) if tr[k] < tf and occ[br[k]]]
        assert sampled == want, r
    assert jumps > 0
