"""How closely R7's and R8's plain versions agree with the JAX package (CPU).

A one-off reading beside `tests/test_torch_vpt_extension.py`, on that
file's scenes and inputs: decomposition tracking (R7) on the Gaussian cloud
(160 rays, 48 events) and at the 512-event cap, residual ratio tracking
(R8) on JAX's own super-voxel grid, and `residual_ratio_transmittance` at
the DDA's and a segment's caps. For each it prints the share of rays whose
radiance (or T) lies within 1e-4 of JAX's in every channel (the tests' bar
asks 95%, 99% for the transmittance) and the largest difference on the
other rays (None where there are none), the largest difference on any ray
and the share of rays equal bit for bit. Run from the repository's root, with JAX on the CPU:

    JAX_PLATFORMS=cpu python3 tools/vpt_jax_agreement.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

__all__ = ["main"]


def _figures(j, t):
    d = np.abs(np.asarray(j, np.float64) - np.asarray(t, np.float64))
    d = d.reshape(d.shape[0], -1).max(1)
    ok = d <= 1e-4
    return {"rays": int(d.shape[0]), "share_within_1e-4": float(ok.mean()),
            "max_abs_diff_other_rays": float(d[~ok].max()) if (~ok).any() else None,
            "max_abs_diff": float(d.max()), "share_equal": float((d == 0).mean())}


def main() -> int:
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    sys.path.insert(0, os.getcwd())
    import jax
    import jax.numpy as jnp
    import test_torch_vpt_extension as tx

    from linevis_tpu.render import super_voxel as jsv
    from linevis_tpu_torch.kernels import vpt_residual_ratio as tvr
    from linevis_tpu_torch.ops import threefry
    from linevis_tpu_torch.render import super_voxel as tsv
    from linevis_tpu_torch.render import vpt as tvpt

    out = {}
    cloud = tx._cloud()
    o, d = tx._rays(160)
    ext, alb = [80.0] * 3, [0.9] * 3
    t = tvpt.vpt_trace_rays(threefry.prng_key(8), tx._t(cloud), tx._t(o), tx._t(d), ext, alb,
                            tx.SUN, tx.SUN_IC, phase_g=0.3, mode="Decomposition Tracking",
                            max_events=48)
    j = tx._jax_trace(8, cloud, o, d, ext, alb, "Decomposition Tracking", phase_g=0.3,
                      max_events=48)
    out["r7_cloud"] = _figures(j[0], t[0].numpy())
    grid, sv = tx._t(cloud), tx._rr_sv(cloud)
    p = tvr.rr_params(grid.shape, sv.mu_c.shape, ext, alb, tx.SUN, tx.SUN_IC, 0.3)
    t = tvr.vpt_residual_ratio(grid, sv, tx._t(o), tx._t(d), threefry.prng_key(8), p)
    j = tx._jax_trace(8, cloud, o, d, ext, alb, "Residual Ratio Tracking", phase_g=0.3)
    out["r8_cloud_on_jax_super_voxels"] = _figures(j[0], t[0].numpy())

    cap = np.full((12, 12, 12), 0.8, np.float32)
    cap[3:9, 3:9, 3:9] = 1.0
    o2, d2 = tx._rays(96, spread=0.05)
    ext2, alb2 = [4000.0] * 3, [1.0] * 3
    t = tvpt.vpt_trace_rays(threefry.prng_key(5), tx._t(cap), tx._t(o2), tx._t(d2), ext2, alb2,
                            tx.SUN, tx.SUN_IC, phase_g=0.5, mode="Decomposition Tracking",
                            max_events=512, super_voxel_size=4)
    j = tx._jax_trace(5, cap, o2, d2, ext2, alb2, "Decomposition Tracking", phase_g=0.5,
                      max_events=512, super_voxel_size=4)
    out["r7_event_cap"] = _figures(j[0], t[0].numpy())

    rng = np.random.default_rng(1)
    key = threefry.prng_key(2)
    for name, c, size, e in (("rr_transmittance_dda_cap", tx._cloud(48, seed=5), 2, 60.0),
                             ("rr_transmittance_segment_cap",
                              (rng.uniform(0.0, 1.0, (8, 8, 8)) < 0.03).astype(np.float32), 8,
                              2000.0)):
        oo = np.tile(np.float32([0.6, 0.55, 0.62]), (64, 1)) + rng.normal(0, 0.02, (64, 3))
        dd = -oo + rng.normal(0, 0.02, (64, 3))
        dd = (dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32)
        oo = oo.astype(np.float32)
        jg = jsv.build_super_voxel_grid(jnp.asarray(c), jnp.float32(e), size)
        jT = np.asarray(jsv.residual_ratio_transmittance(jax.random.PRNGKey(2), jnp.asarray(c), jg,
                                                         jnp.asarray(oo), jnp.asarray(dd), e))
        tT = tsv.residual_ratio_transmittance(key, tx._t(c), tx._rr_sv(c, e, size), tx._t(oo),
                                              tx._t(dd), e)
        out[name] = _figures(jT[:, None], tT.numpy()[:, None])
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
