"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources under ``kernels/csrc`` are compiled by ``nvcc`` for
``sm_90a`` — one ``nvcc -c`` per ``.cu`` file, all started together — and
linked into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), which ``ctypes`` loads. The library
lands in ``<repo>/build/repro_torch/`` (listed in ``.gitignore``) under a
name keyed on a hash of the sources, headers and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A build writes
to a temporary directory and renames the library into place, so
concurrent first uses do not see a half-written library.

Nothing here runs at import: ``load()`` is called by the kernel wrappers
the first time a CUDA tensor reaches them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernels c, d, e, n, o | a, b | f, g, k | h, i, j | l, m; the headers are
# hashed with them
SOURCES = ("uot_batched.cu", "uot_fused.cu", "uot_resident.cu",
           "uot_geometry.cu", "uot_uv_fused.cu")
HEADERS = ("uot_common.cuh", "uot_stream.cuh", "uot_gibbs.cuh")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of repro_torch cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (if this hash is not built yet); returns the
    library path. ``BUILD_INFO`` records the path, whether it was built in
    this process, and the compiler's report (``-Xptxas -v``: registers and
    shared memory of each kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libuot_kernels_{source_hash()}.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), built=False, log="")
        return lib
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in procs:
            out, err = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", so, *[obj for _, obj, _ in procs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(so, lib)
    BUILD_INFO.update(path=str(lib), built=True, log="\n".join(logs))
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.uot_batched_colsum.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
            lib.uot_batched_colsum.restype = I
            lib.uot_batched_fused_iteration.argtypes = [
                P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P]
            lib.uot_batched_fused_iteration.restype = I
            lib.uot_fused_colsum.argtypes = [P, P, P, I, I, I, I, I, I, P]
            lib.uot_fused_colsum.restype = I
            lib.uot_fused_iteration.argtypes = [
                P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
            lib.uot_fused_iteration.restype = I
            lib.uot_resident_solve.argtypes = [
                P, P, P, P, P, P, I, I, I, I, F, I, I, F, I, P]
            lib.uot_resident_solve.restype = I
            lib.uot_resident_stepped.argtypes = [
                P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, F, I, P]
            lib.uot_resident_stepped.restype = I
            lib.uot_resident_solve_pc.argtypes = [
                P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, I,
                F, I, F, F, I, P]
            lib.uot_resident_solve_pc.restype = I
            lib.uot_pc_materialize.argtypes = [
                P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, P]
            lib.uot_pc_materialize.restype = I
            lib.uot_pc_colsum.argtypes = [
                P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, F, I, P]
            lib.uot_pc_colsum.restype = I
            lib.uot_pc_first_iteration.argtypes = [
                P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                I, I, F, I, F, F, I, P]
            lib.uot_pc_first_iteration.restype = I
            lib.uot_batched_uv_iteration.argtypes = [
                P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P]
            lib.uot_batched_uv_iteration.restype = I
            lib.uot_uv_iteration.argtypes = [
                P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
            lib.uot_uv_iteration.restype = I
            lib.uot_batched_materialize_coupling.argtypes = [
                P, P, P, P, I, I, I, I, I, I, I, P]
            lib.uot_batched_materialize_coupling.restype = I
            lib.uot_materialize_coupling.argtypes = [
                P, P, P, P, I, I, I, I, I, I, P]
            lib.uot_materialize_coupling.restype = I
            lib.uot_resident_smem_bytes.argtypes = [I, I]
            lib.uot_resident_smem_bytes.restype = ctypes.c_longlong
            lib.uot_error_string.argtypes = [I]
            lib.uot_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    """Raise if a launcher returned an error (a CUDA error code, or a
    negative code for arguments the launcher refused)."""
    if code == 0:
        return
    if code < 0:
        raise ValueError(f"{what}: the launcher refused its arguments "
                         f"(code {code})")
    msg = load().uot_error_string(code).decode()
    raise RuntimeError(f"{what}: CUDA error {code} at launch: {msg}")
