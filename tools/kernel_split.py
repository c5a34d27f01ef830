"""Where the time of B2's K-buffer kernel and of B5's AO grid trace goes, on one card.

A one-off measurement script beside `chip_smoke.py` and `tools/kernel_ab.py`,
not part of the port's package. Run from the root of a source tree:

    python3 tools/kernel_split.py [--turns N] [--out FILE]

B5 (`csrc/ao_grid.cu`), on the first 1080p batch of rays of `chip_smoke.py`'s
first RTAO frame: the launch as it is; the same launch with every
`seg_chunks` set to 0 (every pair chunk empty); only the active pair chunks;
those without the longest walk; and the longest walk alone. It also prints
the walk lengths (record chunks per active pair chunk).

Then the tree's B5 against its variants (`B5_VARIANTS`, for the redesign),
in turns.

B2 (`csrc/raster_capsule_oit.cu`), on the first orbit camera of the 1080p
tornado (tile 16x8, K=8, opacity 0.3): ablation variants of the tree's own
kernel, each built from a copy of its source with one part taken out or
changed by text substitution, timed in turns with the source as it is. The
variants are those of the tree's design: `FIRST_DESIGN_VARIANTS` where the
source is the first design (per-thread hit arrays rescanned for each tie
window; unpack such a tree with `git archive` and run the script from its
root), `VARIANTS` where it is the redesign (a sorted per-thread list of
the nearest hits); a source that matches neither set stops the script.
The modes timed: the MLAB composite,
the exact peel pass (per-fragment shading behind a peel depth) and the
'gather' at 960x528. A variant that changes the function says so
(`equal_to_base`). Each time is the mean of 40 launches between CUDA events.
The last line holds the card's name and power limit and every figure (also
written to FILE with --out).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["main", "FIRST_DESIGN_VARIANTS", "VARIANTS", "B5_VARIANTS"]

# name -> [(old, new), ...] applied to csrc/raster_capsule_oit.cu: parts
# taken out of the first design.
FIRST_DESIGN_VARIANTS = {
    # The composite epilogue over nodes with alpha only (an empty node adds
    # exactly 0 and multiplies T by 1: the same function).
    "epilogue_filled_only": [(
        "      if (q < K) {\n        const float aN = na[q];",
        "      if (q < K && na[q] != 0.0f) {\n        const float aN = na[q];")],
    # No sweeps: hits found and stored, nothing extracted (the stores die).
    "no_sweeps": [("for (int sw = 0; sw < K; ++sw) {", "for (int sw = 0; sw < 0; ++sw) {")],
    # No tile-wide bound: no reduction, no barrier but the staging one, no
    # T_K (the culls and the rejection never fire on the tornado at K=8).
    "no_tile_bound": [
        ("    float zk = tile_bound();  // synchronises: the staged rows are visible",
         "    __syncthreads();\n    float zk = 2.0f;"),
        ("      if (!first) zk = tile_bound();", "      if (!first) zk = 2.0f;")],
    # Staging without the integer division: rows outer, columns inner.
    "staging_no_division": [(
        "    for (int i = tid; i < NROWS * C; i += P) {\n"
        "      const int r = i / C, j = i - r * C;\n"
        "      if (c0 + j >= lo && c0 + j < hi) s[r][j] = payload[(long long)r * ld + c0 + j];\n"
        "    }",
        "    for (int r = warp; r < NROWS; r += nwarps)\n"
        "      for (int j = lo - c0 + lane; j < hi - c0; j += 32)\n"
        "        s[r][j] = payload[(long long)r * ld + c0 + j];")],
}
# The same for the redesign.
VARIANTS = {
    "slots_4": [("#define SLOTS 6 ", "#define SLOTS 4 ")],
    "slots_8": [("#define SLOTS 6 ", "#define SLOTS 8 ")],
    # The scan and the sorted insertion alone: no window taken (the list is
    # read once, so neither is dead code).
    "fill_only": [("          need_fill = false;\n          fresh = true;\n        }\n",
                   "          need_fill = false;\n          fresh = true;\n        }\n"
                   "        if (Ltw[0] == -1.0f) evaluated = -1;\n        break;\n")],
    # The nodes in registers at every KMAX and tile (no channel in shared
    # memory).
    "nodes_in_registers": [("      launch<8, 5>(", "      launch<8, 0>("),
                           ("      launch<16, 5>(", "      launch<16, 0>("),
                           ("      launch<32, 5>(", "      launch<32, 0>("),
                           ("      launch<32, 3>(", "      launch<32, 0>(")],
    # The redesign's phases timed with clock64() by lane 0 of each warp:
    # the hit scans (fill), the window loop (scans included), the wait at
    # the tile-wide bound's barrier, the epilogue and the whole kernel,
    # summed into `g_phase` (read back and zeroed by `read_phase`).
    "phase_clock": [
        ('#include "capsule_common.cuh"\n',
         '#include "capsule_common.cuh"\n__device__ unsigned long long g_phase[5];\n'
         'extern "C" int read_phase(unsigned long long* h) {\n'
         '  const int e = (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n'
         '  const unsigned long long z[5] = {0, 0, 0, 0, 0};\n'
         '  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  return e;\n}\n'),
        ("  const int K = o.K;\n",
         "  const int K = o.K;\n  long long ph_fill = 0, ph_win = 0, ph_bar = 0;\n"
         "  const long long ph_start = clock64();\n"),
        ("      __syncthreads();\n      float zk = s_red[red][0];\n",
         "      const long long ph_b0 = clock64();\n      __syncthreads();\n"
         "      ph_bar += clock64() - ph_b0;\n      float zk = s_red[red][0];\n"),
        ("      for (int win = 0; win < K;) {\n        if (need_fill) {\n",
         "      const long long ph_w0 = clock64();\n      for (int win = 0; win < K;) {\n"
         "        if (need_fill) {\n          const long long ph_f0 = clock64();\n"),
        ("          need_fill = false;\n          fresh = true;\n        }\n",
         "          need_fill = false;\n          fresh = true;\n"
         "          ph_fill += clock64() - ph_f0;\n        }\n"),
        ("          dirty = true;\n        }\n      }\n    }\n  }\n\n",
         "          dirty = true;\n        }\n      }\n      ph_win += clock64() - ph_w0;\n"
         "    }\n  }\n\n  const long long ph_e0 = clock64();\n"),
        ("  if (work != nullptr && tid == 0) work[tile] = evaluated;",
         "  if (lane == 0) {\n    const long long ph_end = clock64();\n"
         "    atomicAdd(&g_phase[0], (unsigned long long)ph_fill);\n"
         "    atomicAdd(&g_phase[1], (unsigned long long)ph_win);\n"
         "    atomicAdd(&g_phase[2], (unsigned long long)(ph_end - ph_start));\n"
         "    atomicAdd(&g_phase[3], (unsigned long long)ph_bar);\n"
         "    atomicAdd(&g_phase[4], (unsigned long long)(ph_end - ph_e0));\n  }\n"
         "  if (work != nullptr && tid == 0) work[tile] = evaluated;")],
}
# The same for the redesigned csrc/ao_grid.cu (the first design has none):
# block shapes and register budgets (4 slot groups of 32 slots per ray:
# blocks of 512 threads; no minimum of resident blocks per SM, which lets
# the registers exceed 32).
B5_VARIANTS = {
    "min_blocks_1": [("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT)")],
    "split_4_min_blocks_4": [("#define SPLIT 8 ", "#define SPLIT 4 "),
                             ("__launch_bounds__(C * SPLIT, 2)", "__launch_bounds__(C * SPLIT, 4)")],
}


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _timed(fn, n=40):
    fn()
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _build_variants(out_dir: Path, source: str, variant_sets: list):
    """Each variant of csrc/<source>.cu, of the first set in `variant_sets`
    whose every text the source holds once, compiled into its own library,
    all nvcc started together -> {name: (path, ptxas lines, seconds)}."""
    from linevis_tpu_torch.kernels import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    for variants in variant_sets:
        if all(src.count(old) == 1 for subs in variants.values() for old, _ in subs):
            break
    else:
        raise SystemExit(f"{source}.cu matches none of the variant sets")
    jobs = {"base": src}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        jobs[name] = text

    def compile_one(item):
        name, text = item
        cu = out_dir / f"split_{source}_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libsplit_{source}_{name}.so"
        t0 = time.perf_counter()
        p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                            str(lib), str(cu)], capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{p.stdout}{p.stderr}")
        log = p.stdout + p.stderr
        ptx = [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        return name, (lib, ptx, time.perf_counter() - t0)

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(compile_one, jobs.items()))


def _b5(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.entry import tornado_segment_grid
    from linevis_tpu_torch.kernels import ao_grid
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.rtao import RtaoSettings, ray_batches, rtao_gbuffer, rtao_rays
    from linevis_tpu_torch.render.tube_raster import camera_tensors

    rt = RtaoSettings()
    grid = tornado_segment_grid(scene, rt.grid_resolution)
    settings = RasterSettings(width=W, height=H, tile_w=32, tile_h=16)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    gbuf = rtao_gbuffer(scene, *cam, settings)
    gen = torch.Generator(device=dev).manual_seed(rt.seed)
    u1 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    u2 = torch.rand((rt.num_samples, H, W), generator=gen, device=dev)
    o, d, t_max, valid = rtao_rays(gbuf, scene.radius, rt, u1, u2)
    s0, s1 = ray_batches(o.shape[1], rt.rays_per_batch)[0]
    pairs = ao_grid.expand_ray_pairs(o[:, s0:s1], d[:, s0:s1], t_max[s0:s1], valid[s0:s1],
                                     grid, rt.max_ray_cells)
    rec, C = grid.records, grid.chunk
    n_chunks = pairs.seg_chunks.shape[0]
    walked = torch.zeros_like(pairs.seg_chunks)
    tests = torch.zeros_like(pairs.seg_chunks)
    occ = ao_grid.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C,
                              walked=walked, tests=tests)
    active = torch.nonzero(pairs.seg_chunks > 0).flatten()
    n_active = active.numel()
    prefix = bool(n_active == 0 or int(active[-1]) == n_active - 1)
    w_act = walked[active]
    top = torch.sort(w_act, descending=True)
    longest = int(active[top.indices[0]])

    def run(idx, drop=None):
        sc = pairs.seg_chunks[idx].clone()
        if drop is not None:
            sc[drop] = 0
        cols = (idx[:, None] * C + torch.arange(C, device=dev)).reshape(-1)
        rays = torch.cat([pairs.rays[:, cols], torch.zeros((8, C), device=dev)], 1).contiguous()
        sb = pairs.seg_begin[idx].contiguous()
        return lambda: ao_grid.trace_pairs(rays, sb, sc, rec, C)

    zeros = torch.zeros_like(pairs.seg_chunks)
    res["b5"] = {
        "pairs": n_chunks * C, "pair_chunks": n_chunks, "active_pair_chunks": n_active,
        "active_chunks_are_a_prefix": prefix, "occluded": int(occ.sum()),
        "record_chunks_walked": int(walked.sum()), "tests": int(tests.sum()),
        "longest_walk": int(walked.max()), "longest_walk_chunk": longest,
        "walks_top10": top.values[:10].tolist(),
        "assigned_of_longest": int(pairs.seg_chunks[longest]),
        "ms_as_is": _timed(lambda: ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C)),
        "ms_all_empty": _timed(lambda: ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, zeros, rec, C)),
        "ms_active_only": _timed(run(active)),
        "ms_active_without_longest": _timed(run(active, drop=top.indices[0])),
        "ms_longest_alone": _timed(run(active[top.indices[:1]])),
    }
    hist = torch.bincount(w_act.clamp(max=16)).tolist()
    res["b5"]["walk_histogram_to_16"] = hist
    print("b5: " + json.dumps(res["b5"]), flush=True)

    from linevis_tpu_torch.kernels import _build
    libs = _build_variants(_build.BUILD_DIR / "split", "ao_grid", [B5_VARIANTS, {}])
    fig = {name: {"ptxas": libs[name][1][-3:], "ms": []} for name in libs}
    for name in libs:
        _build._loaded["ao_grid"] = ctypes.CDLL(str(libs[name][0]))
        fig[name]["equal_to_base"] = bool(torch.equal(ao_grid.trace_pairs(
            pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C), occ))
    for k in range(turns):
        for name in (list(libs) if k % 2 == 0 else list(libs)[::-1]):
            _build._loaded["ao_grid"] = ctypes.CDLL(str(libs[name][0]))
            fig[name]["ms"].append(_timed(lambda: ao_grid.trace_pairs(
                pairs.rays, pairs.seg_begin, pairs.seg_chunks, rec, C)))
    _build._loaded.pop("ao_grid")
    res["b5_variants"] = fig
    print("b5 variants: " + json.dumps(fig), flush=True)


def _b2(dev, scene, W, H, res, turns):
    from linevis_tpu_torch.kernels import _build
    from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_mlab
    from linevis_tpu_torch.render.camera import Camera
    from linevis_tpu_torch.render.oit import prepare_mlab_frame
    from linevis_tpu_torch.render.pipeline import RasterSettings
    from linevis_tpu_torch.render.tube_raster import camera_tensors, prepare_capsule_frame

    t0 = time.perf_counter()
    libs = _build_variants(_build.BUILD_DIR / "split", "raster_capsule_oit",
                           [FIRST_DESIGN_VARIANTS, VARIANTS])
    res["b2_build_s"] = time.perf_counter() - t0
    s = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    cam = camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
                         .orbit(0.002, 0.1, 1.2), dev)
    csr, params = prepare_mlab_frame(scene, *cam, s, 0.3)
    args = (csr, params, W, H, 16, 8, 8, s.tf_color, s.tf_opacity)
    d1, _, _ = rasterize_capsules_mlab(*args, no_overflow=True)
    peel = torch.where(d1 < 1.5, d1, -1.0).amax(dim=0).contiguous()
    s2 = RasterSettings(width=960, height=528, tile_w=16, tile_h=8)
    csr2, params2, _ = prepare_capsule_frame(scene, *cam, s2)
    modes = {
        "composite": lambda: rasterize_capsules_mlab(
            *args, deferred_shade=True, sub=32, sat=0.999, composite=True),
        "peel_exact": lambda: rasterize_capsules_mlab(*args, peel=peel, no_overflow=True),
        "gather": lambda: rasterize_capsules_mlab(
            csr2, params2, 960, 528, 16, 8, 8, s2.tf_color, s2.tf_opacity, store_mode="gather"),
    }

    def use(name):
        _build._loaded["raster_capsule_oit"] = ctypes.CDLL(str(libs[name][0]))

    def flat(out):
        return out if torch.is_tensor(out) else torch.cat([out[0], out[1].flatten(0, 1), out[2]])

    base_out = {}
    use("base")
    for m, fn in modes.items():
        base_out[m] = flat(fn())
    fig = {name: {"ptxas": libs[name][1][-18:], "nvcc_s": libs[name][2], "ms": {}}
           for name in libs}
    for name in libs:
        use(name)
        fig[name]["equal_to_base"] = {m: bool(torch.equal(flat(fn()), base_out[m]))
                                      for m, fn in modes.items()}
    names = list(libs)
    for k in range(turns):
        for name in (names if k % 2 == 0 else names[::-1]):
            use(name)
            for m, fn in modes.items():
                fig[name]["ms"].setdefault(m, []).append(_timed(fn))
    for name in names:
        lib = ctypes.CDLL(str(libs[name][0]))
        if not hasattr(lib, "read_phase"):
            continue
        _build._loaded["raster_capsule_oit"] = lib
        buf = (ctypes.c_ulonglong * 5)()
        lib.read_phase(buf)  # zero the counters
        fig[name]["phase_share"] = {}
        for m, fn in modes.items():
            fn()
            torch.cuda.synchronize()
            lib.read_phase(buf)
            fill, win, total, bar, epi = (float(x) for x in buf)
            # Warp-cycles: the scans, the windows without their scans, the
            # barrier wait, the epilogue, the rest (set-up, staging, bound).
            fig[name]["phase_share"][m] = {
                "fill": fill / total, "windows": (win - fill) / total, "barrier": bar / total,
                "epilogue": epi / total, "other": (total - win - bar - epi) / total}
    res["b2"] = fig
    for name in names:
        brief = {k: v for k, v in fig[name].items() if k != "ptxas"}
        brief["ptxas"] = [ln.replace("ptxas info    : ", "") for ln in fig[name]["ptxas"]
                          if "Used" in ln][-2:]
        print(f"b2 {name}: " + json.dumps(brief), flush=True)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    turns = int(args[args.index("--turns") + 1]) if "--turns" in args else 2
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from linevis_tpu_torch.entry import tornado_scene, tornado_trajectories

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"gpu: {gpu}", flush=True)
    dev = torch.device("cuda", 0)
    W, H = 1920, 1080
    scene = tornado_scene(dev, traj=tornado_trajectories(dev))
    res = {"gpu": gpu}
    _b5(dev, scene, W, H, res, turns)
    _b2(dev, scene, W, H, res, turns)
    print(json.dumps(res), flush=True)
    if "--out" in args:
        out = Path(args[args.index("--out") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
