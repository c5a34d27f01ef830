"""linevis_tpu_torch's scattering layer vs the JAX package on the CPU.

Bars:
- The scattering tracer (`dt_path_trace_rays`, `trace_scattering_rays`,
  `LineDataScattering.trace`) on the same threefry key: the path masks
  equal, positions and exit directions within 1e-4 on at least 99% of
  paths (measured: all of them at these sizes; a flipped `t >= d` or `xi <
  p` changes the rest of a path, so the bar leaves room for one such
  rounding).
- The line density field within 1e-5 (a scatter-add sums each voxel in an
  order of its own); its smoothing within 1e-6.
- `SparseGrid.sample` bit for bit against JAX's (same arithmetic).
- The super-voxel statistics: min/max equal, the mean within 1e-6 (block
  sums in another order); residual ratio transmittance within 1e-4 on 99%
  of rays on the same key.
- The Line Density Map and the Spherical Heat Map (plain versions of R4,
  R5) against JAX at SSIM >= 0.999 and mean abs <= 2e-3 (the ROADMAP image
  bars); through the registry too.
- The cloud loader: every format written by the JAX writers (and the
  port's) read to equal arrays; the environment map loader and lookup.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.loaders import cloud_loader as jcl
from linevis_tpu.render import env_map as jenv
from linevis_tpu.render import line_density_map as jldm
from linevis_tpu.render import spherical_heatmap as jshm
from linevis_tpu.render import super_voxel as jsv
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.tube_raster import _ray_basis as j_ray_basis
from linevis_tpu.scene import line_data_scattering as jlds
from linevis_tpu.scene.sparse_grid import SparseGrid as JSparseGrid
from linevis_tpu.trace import scattering as jsc
from linevis_tpu_torch.convert import line_data_scattering_from_numpy, trajectories_from_numpy
from linevis_tpu_torch.loaders import cloud_loader as tcl
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.render import env_map as tenv
from linevis_tpu_torch.render import line_density_map as tldm
from linevis_tpu_torch.render import spherical_heatmap as tshm
from linevis_tpu_torch.render import super_voxel as tsv
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.render.tube_raster import _ray_basis
from linevis_tpu_torch.scene import line_data_scattering as tlds
from linevis_tpu_torch.scene.sparse_grid import SparseGrid
from linevis_tpu_torch.trace import scattering as tsc


def _cloud(g=20, seed=None):
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    c = np.exp(-4.0 * (xx**2 + yy**2 + zz**2))
    if seed is not None:
        c = c * np.random.default_rng(seed).uniform(0.6, 1.0, c.shape)
    return c.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _paths_agree(j, t, share=0.99):
    pj, mj, ej, xj = (np.asarray(a) for a in j)
    pt, mt, et, xt = (np.asarray(a) for a in t)
    same_mask = (mj == mt).all(axis=1)
    close = (np.abs(np.where(mj[..., None], pj - pt, 0.0)) <= 1e-4).all(axis=(1, 2))
    exit_close = (np.abs(ej - et) <= 1e-4).all(axis=1) & (xj == xt)
    ok = same_mask & close & exit_close
    assert ok.mean() >= share, (same_mask.mean(), close.mean(), exit_close.mean())
    return ok.mean()


@pytest.mark.parametrize("g", [0.2, 0.0])
def test_dt_path_trace_rays_equals_jax(g):
    cloud = _cloud(seed=3)
    rng = np.random.default_rng(4)
    n = 200
    origins = np.tile(np.float32([-0.5, -0.5, -0.5]), (n, 1)) + rng.normal(0, 0.02, (n, 3))
    dirs = -origins / np.linalg.norm(origins, axis=1, keepdims=True) + rng.normal(0, 0.05, (n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    origins = origins.astype(np.float32)
    dens = rng.choice([30.0, 60.0, 90.0], n).astype(np.float32)
    alb = rng.choice([0.8, 1.0], n).astype(np.float32)
    j = jsc.dt_path_trace_rays(jax.random.PRNGKey(9), jnp.asarray(cloud), jnp.asarray(origins),
                               jnp.asarray(dirs), jnp.asarray(dens), jnp.asarray(alb), g,
                               max_events=48)
    t = tsc.dt_path_trace_rays(threefry.prng_key(9), _t(cloud), _t(origins), _t(dirs), _t(dens),
                               _t(alb), g, max_events=48)
    assert t[0].shape == (n, 50, 3) and t[1].shape == (n, 50)
    _paths_agree(j, t)


def test_trace_scattering_rays_and_line_data_equal_jax():
    cloud = _cloud()
    s = jsc.ScatteringTracingSettings(res_x=6, res_y=5, samples_per_pixel=4, max_events=40,
                                      extinction=(40.0, 60.0, 80.0))
    ts = tsc.ScatteringTracingSettings(**dataclasses.asdict(s))
    _paths_agree(jsc.trace_scattering_rays(cloud, s),
                 tsc.trace_scattering_rays(cloud, ts, device="cpu"))
    jld = jlds.LineDataScattering.trace(cloud, s)
    tld = tlds.LineDataScattering.trace(cloud, ts, device="cpu")
    jt, tt = jld.trajectories, tld.trajectories
    assert np.array_equal(jt.mask, tt.mask) and np.array_equal(jt.num_points, tt.num_points)
    assert np.abs(jt.positions - tt.positions).max() <= 1e-4
    assert np.abs(jld.exit_directions - tld.exit_directions).max() <= 1e-4
    assert tld.data_set_type == "scattering" and tld.grid_size == cloud.shape


def test_line_density_field_and_smoothing_equal_jax():
    cloud = _cloud()
    s = jsc.ScatteringTracingSettings(res_x=6, res_y=6, samples_per_pixel=4, max_events=48,
                                      extinction=(40.0, 60.0, 80.0))
    jld = jlds.LineDataScattering.trace(cloud, s)
    # The port's scene from JAX's paths, so the field compares the splat alone.
    tld = line_data_scattering_from_numpy({
        "trajectories": dataclasses.asdict(jld.trajectories), "cloud_grid": cloud,
        "exit_directions": jld.exit_directions})
    jf = jld.get_line_density_field()
    tf = tld.get_line_density_field(device="cpu")
    assert tf.shape == jf.shape and float(tf.max()) == 1.0
    assert np.abs(tf.numpy() - jf).max() <= 1e-5
    assert tld.get_line_density_field(device="cpu") is tf
    for radius in (1, 2):
        js = np.asarray(jlds.smooth_density_field(jnp.asarray(jf), radius))
        tsm = tlds.smooth_density_field(_t(jf), radius).numpy()
        assert np.abs(js - tsm).max() <= 1e-6
    # Segments outside the grid add nothing (both).
    pos = np.asarray([[[-2.0, 0.0, 0.0], [-1.5, 0.0, 0.0]], [[-0.1, 0.0, 0.0], [0.1, 0.0, 0.0]]],
                     np.float32)
    m = np.ones((2, 2), bool)
    jf2 = np.asarray(jlds.build_line_density_field(
        jnp.asarray(pos), jnp.asarray(m), jnp.asarray(jld.grid_b_min), jnp.asarray(jld.grid_b_max),
        (8, 8, 8)))
    tf2 = tlds.build_line_density_field(_t(pos), _t(m), jld.grid_b_min, jld.grid_b_max, (8, 8, 8))
    assert np.abs(jf2 - tf2.numpy()).max() <= 1e-6


def test_sparse_grid_samples_equal_jax():
    cloud = _cloud(17, seed=2)
    cloud[cloud < 0.3] = 0.0
    js = JSparseGrid.from_dense(cloud, block=4)
    ts = SparseGrid.from_dense(cloud, block=4, device="cpu")
    assert np.array_equal(np.asarray(js.bricks), ts.bricks.numpy())
    assert np.array_equal(np.asarray(js.table), ts.table.numpy())
    assert ts.n_active == js.n_active and ts.memory_ratio() == js.memory_ratio()
    p = np.random.default_rng(0).uniform(-0.1, 1.1, (4000, 3)).astype(np.float32)
    a = np.asarray(js.sample(jnp.asarray(p)))
    b = ts.sample(_t(p)).numpy()
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
    # JAX's grid carried across (convert), sampled as a tuple of components.
    from linevis_tpu_torch.convert import sparse_grid_from_numpy

    tj = sparse_grid_from_numpy({"bricks": js.bricks, "table": js.table, "shape": js.shape,
                                 "block": js.block}, device="cpu")
    c = tj.sample(tuple(_t(p).unbind(1))).numpy()
    assert np.array_equal(a.view(np.int32), c.view(np.int32))


def test_super_voxel_grid_and_transmittance_equal_jax():
    cloud = _cloud(24, seed=5)
    jmin, jmax = jsv.build_super_voxel_minmax(jnp.asarray(cloud), 8)
    tmin, tmax = tsv.build_super_voxel_minmax(_t(cloud), 8)
    assert np.array_equal(np.asarray(jmin), tmin.numpy())
    assert np.array_equal(np.asarray(jmax), tmax.numpy())
    jg = jsv.build_super_voxel_grid(jnp.asarray(cloud), 60.0, 8)
    tg = tsv.build_super_voxel_grid(_t(cloud), 60.0, 8)
    assert np.abs(np.asarray(jg.mu_c) - tg.mu_c.numpy()).max() <= 60.0 * 1e-6
    assert np.abs(np.asarray(jg.mu_r_bar) - tg.mu_r_bar.numpy()).max() <= 60.0 * 1e-6
    rng = np.random.default_rng(1)
    n = 256
    o = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1)) + rng.normal(0, 0.05, (n, 3))
    d = -o + rng.normal(0, 0.08, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    jT = np.asarray(jsv.residual_ratio_transmittance(jax.random.PRNGKey(2), jnp.asarray(cloud), jg,
                                                     jnp.asarray(o), jnp.asarray(d), 60.0))
    # The port's grid from JAX's statistics, so the rays see the same mu_c.
    from linevis_tpu_torch.convert import super_voxel_grid_from_numpy

    tg2 = super_voxel_grid_from_numpy({"mu_c": jg.mu_c, "mu_r_bar": jg.mu_r_bar, "size": 8}, "cpu")
    tT = tsv.residual_ratio_transmittance(threefry.prng_key(2), _t(cloud), tg2, _t(o), _t(d),
                                          60.0).numpy()
    assert (np.abs(jT - tT) <= 1e-4).mean() >= 0.99
    assert 0.05 < tT.mean() < 0.999


def _cam(w, h, pos=(0.0, 0.1, 0.9)):
    return (JCamera(position=pos, look_at_point=(0, 0, 0), width=w, height=h),
            Camera(position=pos, look_at_point=(0, 0, 0), width=w, height=h))


def _images_agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(b).all()
    assert ssim(a[..., :3], b[..., :3]) >= 0.999
    assert np.abs(a - b).mean() <= 2e-3


def test_line_density_map_equals_jax():
    cloud = _cloud()
    s = jsc.ScatteringTracingSettings(res_x=8, res_y=8, samples_per_pixel=4, max_events=48,
                                      extinction=(40.0, 60.0, 80.0))
    jld = jlds.LineDataScattering.trace(cloud, s)
    field = jld.get_line_density_field()
    jcam, tcam = _cam(48, 36)
    o_pts = ((0.0, 0.0), (0.05, 1.0), (1.0, 1.0))
    from linevis_tpu.render.transfer_function import TransferFunction as JTF

    c_pts, _ = JTF.standard().as_static_points()
    jimg = jldm.render_line_density_map(
        jnp.asarray(field), jnp.asarray(jld.grid_b_min), jnp.asarray(jld.grid_b_max),
        jnp.asarray(np.asarray(jcam.position, np.float32)),
        j_ray_basis(jnp.asarray(jcam.view_projection_matrix())), 48, 36, tf_color=c_pts,
        tf_opacity=o_pts)
    timg = tldm.render_line_density_map(
        _t(field), jld.grid_b_min, jld.grid_b_max, _t(np.asarray(tcam.position, np.float32)),
        _ray_basis(_t(tcam.view_projection_matrix())), 48, 36, tf_color=c_pts, tf_opacity=o_pts)
    assert float(timg[..., 3].max()) > 0.3
    _images_agree(jimg, timg)
    # Through both registries, on the same paths.
    tld = line_data_scattering_from_numpy({
        "trajectories": dataclasses.asdict(jld.trajectories), "cloud_grid": cloud,
        "exit_directions": jld.exit_directions})
    from linevis_tpu.render.renderer import create_renderer as jcreate

    jr = jcreate("Line Density Map Renderer")
    jr.set_line_data(jld)
    tr = create_renderer("Line Density Map Renderer", device="cpu")
    tr.set_line_data(tld)
    _images_agree(jr.render(jcam), tr.render(tcam))


def test_spherical_heatmap_equals_jax():
    rng = np.random.default_rng(6)
    d = rng.normal(size=(600, 3))
    d[:200] = np.array([0.3, 0.8, 0.5]) + 0.05 * rng.normal(size=(200, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jimg = np.asarray(jshm.render_spherical_heatmap(jnp.asarray(d), height=32))
    timg = tshm.render_spherical_heatmap(_t(d), height=32).numpy()
    assert timg.shape == (32, 64, 4)
    _images_agree(jimg, timg)
    # The banded plain version against JAX's whole matrix, value by value.
    pts, _ = tshm.mollweide_points(32, "cpu")
    from linevis_tpu_torch.kernels.spherical_heatmap import heatmap_density_reference

    val = heatmap_density_reference(pts, _t(d))
    jp = jnp.asarray(pts.numpy())
    d2 = jnp.sum((jp[:, None, :] - jnp.asarray(d)[None]) ** 2, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    jval = np.asarray(jnp.sum(jnp.where(dist <= 0.1, jnp.exp(-((3.0 * dist / 0.1) ** 2)), 0.0),
                              axis=1))
    assert np.abs(jval - val.numpy()).max() <= 1e-5 * jval.max()
    # The registry renderer, and an empty scene.
    tld = tlds.LineDataScattering(trajectories_from_numpy({
        "positions": np.zeros((1, 8, 3), np.float32), "attributes": np.zeros((1, 1, 8), np.float32),
        "mask": np.ones((1, 8), bool), "num_points": np.array([8], np.int32)}),
        _cloud(8), exit_directions=d)
    r = create_renderer("Spherical Heat Map Renderer", device="cpu")
    r.set_line_data(tld)
    _, tcam = _cam(64, 32)
    _images_agree(jimg, r.render(tcam))
    tld.exit_directions = None
    assert not r.render(tcam).any()


def test_cloud_loader_formats_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    dens = rng.uniform(0.0, 1.0, (9, 11, 13)).astype(np.float32)
    dens[dens < 0.4] = 0.0
    # .xyz written by each package, read by each.
    for i, writer in enumerate((jcl.write_cloud_xyz, tcl.write_cloud_xyz)):
        p = str(tmp_path / f"c{i}.xyz")
        writer(p, dens * 3.0 - 0.5, voxel_size=(0.5, 0.25, 1.0))
        a, b = jcl.load_cloud_file(p), tcl.load_cloud_file(p)
        for f in ("density", "voxel_size", "box_min", "box_max"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert open(tmp_path / "c0.xyz", "rb").read() == open(tmp_path / "c1.xyz", "rb").read()
    # .dat/.raw in every format, read through either name.
    for fmt, data in (("float", dens), ("uchar", (dens * 255).astype(np.uint8)),
                      ("ushort", (dens * 65535).astype(np.uint16))):
        d = tmp_path / fmt
        d.mkdir()
        data.tofile(str(d / "v.raw"))
        (d / "v.dat").write_text(f"ObjectFileName: v.raw\nResolution: 13 11 9\nFormat: {fmt}\n")
        for name in ("v.dat", "v.raw"):
            a, b = jcl.load_cloud_file(str(d / name)), tcl.load_cloud_file(str(d / name))
            assert np.array_equal(a.density, b.density) and np.array_equal(a.voxel_size,
                                                                           b.voxel_size)
    # .nvdb written by each package, read by each.
    for i, writer in enumerate((jcl.write_nvdb, tcl.write_nvdb)):
        p = str(tmp_path / f"c{i}.nvdb")
        writer(p, dens, voxel_size=(0.5, 0.5, 0.5), background=0.0)
        a, b = jcl.load_cloud_file(p), tcl.load_cloud_file(p)
        assert np.array_equal(a.density, b.density) and np.array_equal(b.density, dens)
    assert open(tmp_path / "c0.nvdb", "rb").read() == open(tmp_path / "c1.nvdb", "rb").read()
    with pytest.raises(ValueError, match="Unknown cloud file extension"):
        tcl.load_cloud_file(str(tmp_path / "x.vdb"))


def test_environment_map_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(10)
    img = (rng.uniform(0, 1, (8, 16, 3)) * 255).astype(np.uint8)
    png = str(tmp_path / "env.png")
    Image.fromarray(img).save(png)
    assert np.array_equal(jenv.load_environment_map(png), tenv.load_environment_map(png))
    # A flat Radiance HDR.
    hdr = str(tmp_path / "env.hdr")
    rgbe = rng.integers(1, 255, (4, 8, 4)).astype(np.uint8)
    rgbe[..., 3] = 128
    with open(hdr, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 8\n")
        f.write(rgbe.tobytes())
    env = tenv.load_environment_map(hdr)
    assert np.array_equal(jenv.load_environment_map(hdr), env)
    w = rng.normal(size=(500, 3))
    w = (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    a = np.asarray(jenv.sample_env_map(jnp.asarray(env), jnp.asarray(w), 1.5))
    b = tenv.sample_env_map(_t(env), _t(w), 1.5).numpy()
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())
