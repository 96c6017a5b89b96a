"""nvcc builds of the package's CUDA sources (csrc/*.cu) into shared
libraries with a plain C interface, loaded with ctypes.

Each source is built for sm_90a at first use into the package's _build/
directory (listed in .gitignore), keyed by a hash of the source, the
headers beside it and the flags; concurrent processes serialize on a lock
file and the library is renamed into place only when complete. A failed
build raises NativeBuildError.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from ..errors import NativeBuildError

PKG = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
# --fmad=false: the kernels round as their plain torch versions do
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise NativeBuildError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def build(name: str, defines: tuple = ()):
    """Build csrc/<name>.cu, with -D of each of `defines` (a variant with
    its own library), unless its library exists. Returns (path of the .so,
    build info): info is {"seconds", "log"} (nvcc's output, with ptxas's
    registers, shared memory and spills) when this call built it, else
    None."""
    src = PKG / "csrc" / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    key = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.h")))
    tag = hashlib.sha256(key + " ".join(flags).encode()).hexdigest()[:16]
    variant = "".join(f"_{d.lower()}" for d in defines)
    out = BUILD_DIR / f"{name}{variant}_{tag}.so"
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}{variant}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, None
        t0 = time.perf_counter()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            raise NativeBuildError(f"nvcc failed on {src.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        return out, {"seconds": time.perf_counter() - t0, "log": res.stdout + res.stderr}
