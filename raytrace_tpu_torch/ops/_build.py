"""Build and load the CUDA kernels of ``raytrace_tpu_torch/csrc``.

At first use, ``nvcc`` compiles the ``.cu`` launchers (plain ``extern "C"``
interface, no PyTorch headers), one process per source, all started
together, and links the objects into one shared library under
``raytrace_tpu_torch/_build/``, named by a hash of the sources and flags:
a library is rebuilt only when that hash changes, and a file lock keeps
concurrent processes from building it twice.  The library is loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bounce_kernel.cu", "iter_kernel.cu", "bounce_bwd_kernel.cu",
           "nearest_kernel.cu", "shade_kernel.cu", "nearest_flat_kernel.cu",
           "texture_kernel.cu", "image_grad_kernel.cu")
# --fmad=false: no multiply-add contraction, so the kernels round like
# their plain PyTorch versions (ops/*.py); IEEE sqrt and division are
# nvcc's defaults, and --use_fast_math is deliberately absent.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")
ENTRY_POINTS = ("rt_bounce", "rt_iter", "rt_iter_bvh", "rt_bounce_bwd",
                "rt_nearest", "rt_shade", "rt_nearest_flat", "rt_marble",
                "rt_image_grad")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of the kernel library, compiled first if its sources changed.
    The compiler's output (``-Xptxas -v`` register and shared-memory
    report) goes to ``_build/build.log``."""
    lib = BUILD_DIR / f"librt_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_name(lib.name + ".tmp")
        t0 = time.perf_counter()
        objs = [BUILD_DIR / f"{Path(src).stem}_{lib.stem[-16:]}.o"
                for src in SOURCES]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                *map(str, objs)]
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        proc = None if failed else subprocess.run(
            link, capture_output=True, text=True)
        dt = time.perf_counter() - t0
        log = "".join(f"$ {' '.join(c)}\n# exit {p.returncode}\n{out}"
                      for c, p, out in zip(cmds, procs, outs))
        if proc is not None:
            log += (f"$ {' '.join(link)}\n# exit {proc.returncode}\n"
                    f"{proc.stdout}{proc.stderr}")
        (BUILD_DIR / "build.log").write_text(f"# {dt:.1f} s\n{log}")
        if failed or proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log[-6000:]}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, args: ctypes.Structure, device) -> None:
    """Launch entry point ``name`` with its argument struct on the current
    stream of ``device``; raise on a launch error."""
    import torch
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.rt_error_string(err).decode()}")
