"""Build the hand-written CUDA kernels and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled at first use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

`<hash>` covers the sources (the .cu, every csrc/*.cuh) and the flags, so
an edited source rebuilds and an unchanged one is loaded as built. The
sources compile concurrently, one nvcc each. Nothing here runs at import:
the CPU tests import every module of the port on machines without nvcc.

The launch counters live here too: each kernel wrapper adds one to
`LAUNCHES[<name>]` where it calls into its library, and nowhere else, so a
run can show that its main path went through the kernels. `SLABS` beside
it counts the K slabs v2's two D products issue (`<product>.issued`) and
those a dense walk would issue (`<product>.dense`), products `h@D` and
`do@Dt`: their ratio is how far the slab lists cut the walk. A library
with grid convs also counts the convs it launched in their one-tile form
(csrc/conv3x3_sm90.cuh), which `one_tile_launches` reads.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
KERNELS = ("fused_projection_v2", "fused_projection_v2i",
           "fused_projection_v3", "fused_projection_v4",
           # the experiments' kernels (defensegan_torch/experiments/)
           "fused_projection_v3_variants", "stream64_level", "v3_diag",
           "v3_diag2")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter(
    {name: 0 for name in KERNELS})
SLABS: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Every counter to 0, the kernels' and any other wrapper's, and the
    slab counts."""
    for counter in (LAUNCHES, SLABS):
        for name in counter:
            counter[name] = 0


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _source_hash(name: str, extra_flags: Iterable[str]) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return h.hexdigest()[:16]


def library_path(name: str, extra_flags: Iterable[str] = ()) -> str:
    return os.path.join(BUILD_DIR,
                        f"{name}-{_source_hash(name, extra_flags)}.so")


def build(names: Optional[Iterable[str]] = None,
          extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every stale kernel library, all nvcc processes at once.

    Returns {name: compiler output} for the libraries built by this call
    (with extra_flags=["-Xptxas", "-v"] that is each kernel's registers,
    shared memory and spills). Raises RuntimeError with nvcc's output if a
    build fails.
    """
    names = list(names or KERNELS)
    extra_flags = list(extra_flags)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, extra_flags)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path()] + NVCC_FLAGS + extra_flags + [
            "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        lib.fp_error_string.restype = ctypes.c_char_p
        lib.fp_error_string.argtypes = [ctypes.c_int]
        if hasattr(lib, "fp_one_tile_launches"):
            lib.fp_one_tile_launches.restype = ctypes.c_longlong
        _LIBS[name] = lib
    return lib


def one_tile_launches(lib: ctypes.CDLL) -> int:
    """The grid convs the library has launched in their one-tile form
    (csrc/conv3x3_sm90.cuh takes it where M <= 64); 0 for a library
    without grid convs."""
    if not hasattr(lib, "fp_one_tile_launches"):
        return 0
    return lib.fp_one_tile_launches()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a library call."""
    if code != 0:
        msg = lib.fp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
