"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by nvcc
into `build/lib<name>-<digest>.so` at first use (the digest covers the
sources and the flags, so an edited kernel is rebuilt), then loaded with
ctypes. Nothing here runs at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<digest>.so csrc/<name>.cu

No --use_fast_math: the capsule quadratic needs IEEE sqrt and division.
--fmad=false keeps each kernel's rounding equal to its plain PyTorch
version's, which it is held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "build", "load"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

KERNELS = (
    "raster_capsule", "raster_capsule_oit", "raster_capsule_accum", "raster_prism",
    "raster_triangle", "ao_grid", "bvh_wavefront", "bvh_closest_hit", "bvh_mlat",
    "vpt_tracking", "density_march", "spherical_heatmap", "threefry_uniform",
    "vpt_decomposition", "vpt_residual_ratio",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # renderers may first launch a kernel from worker threads


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        exe = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return exe


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile the named kernels that are not built yet, one nvcc each, all
    started together. Returns {name: {"seconds", "log"}} for those built;
    raises RuntimeError with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib
