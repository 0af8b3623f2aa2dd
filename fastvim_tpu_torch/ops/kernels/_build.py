"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``), one nvcc
process per file and all at once, and linked into one shared library with
a plain C interface, named by a hash of the sources and flags, under
``fastvim_tpu_torch/build/``. A missing ``nvcc`` or a failed build raises;
nothing falls back. The build runs under a file lock: processes that
start together (``torchrun`` ranks) build once, and the others wait for
the library and load it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name → argument types. Each returns a cudaError_t.
SIGNATURES = {
    # u, delta, A, B, C, bias, D, z, out, states, last, batch, L, d, n, ldz,
    # dtype, softplus, reverse, stream
    "fv_selective_scan_fwd": [_P] * 11 + [_I] * 8 + [_P],
    # the same with dsum (the chunks' sums of delta, scratch) after last
    "fv_selective_scan_fwd_chunked": [_P] * 12 + [_I] * 8 + [_P],
    # u, delta, A, B, C, bias, D, g, states, du, ddelta, dbc_part, vec_part,
    # dB, dC, vec, batch, L, d, n, dtype, softplus, reverse, stream
    "fv_selective_scan_bwd": [_P] * 16 + [_I] * 7 + [_P],
    # the same with carry and dsum (scratch of the chunk-parallel form)
    # after vec
    "fv_selective_scan_bwd_chunked": [_P] * 18 + [_I] * 7 + [_P],
    # blocks (one int, out), dtype, n: the chunked form's phase-3 residency
    "fv_selective_scan_bwd_chunked_occupancy": [_P, _I, _I],
    # x, w_x, b_x, w_cf, b_cf, w_ab, b_ab, xc_f, xc_b, pf, pb, batch, H, W,
    # dm, di, transposed, dtype, scaling, stream
    "fv_pass_a_fwd": [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P],
    # x, xc_f, xc_b, yf, yb, w_z, b_z, d_f, d_b, ln_w, ln_b, w_out, b_out,
    # out, batch, H, W, dm, di, transposed, dtype, use_ln, eps, stream
    "fv_pass_b_fwd": [_P] * 14 + [_I] * 8 + [ctypes.c_float, _P],
    # g, x, xc_f, xc_b, yf, yb, w_z, w_z_t, b_z, d_f, d_b, ln_w, ln_b, w_out,
    # w_out_t, dx, dxc_f, dxc_b, dy, mg, dz, vec_part, vec, w_part, dw_out,
    # dw_z, batch, H, W, dm, di, transposed, dtype, use_ln, nsplit, eps, stream
    "fv_pass_b_bwd": [_P] * 26 + [_I] * 9 + [ctypes.c_float, _P],
    # x, dx_b, dxc_f, dxc_b, dpf, dpb, w_x, w_x_t, b_x, w_cf, b_cf, w_ab,
    # b_ab, dx, dxin, c_part, c_vec, w_part, dw_x, batch, H, W, dm, di,
    # transposed, dtype, nsplit, scaling, stream
    "fv_pass_a_bwd": [_P] * 19 + [_I] * 8 + [ctypes.c_float, _P],
    # x, yf, yb, w_x, b_x, w_cf, b_cf, w_ab, b_ab, w_z, b_z, d_f, d_b, ln_w,
    # ln_b, w_out, b_out, out, batch, H, W, dm, di, transposed, dtype,
    # use_ln, eps, stream
    "fv_pass_b_recompute_fwd": [_P] * 18 + [_I] * 8 + [ctypes.c_float, _P],
    # x, w_cf, b_cf, w_ab, b_ab, pf, pb, batch, rows, cols, d, ldx, is_max,
    # dtype, scaling, stream
    "fv_conv_pool_fwd": [_P] * 7 + [_I] * 7 + [ctypes.c_float, _P],
    # x, z, yf, yb, w_cf, b_cf, w_ab, b_ab, d_f, d_b, ln_w, ln_b, out, batch,
    # rows, cols, d, ldx, ldz, dtype, use_ln, tile, threads, smem, eps,
    # stream
    "fv_merge_gate_fwd": [_P] * 13 + [_I] * 11 + [ctypes.c_float, _P],
    # xc_f, xc_b, z, yf, yb, d_f, d_b, ln_w, ln_b, out, batch, H, W, d, ldz,
    # along_w, dtype, use_ln, pieces, team, eps, stream
    "fv_merge_ln_gate_fwd": [_P] * 10 + [_I] * 10 + [ctypes.c_float, _P],
    # u, delta, A, B, C, bias, D, out, states (scratch), batch, L, d, n,
    # dtype, softplus, stream
    "fv_selective_scan_fwd_lanes": [_P] * 9 + [_I] * 6 + [_P],
    # out (32 x uint64 on the host): cycles per phase of K5 / K6 in bf16
    "fv_bwd_phase_cycles": [_P],
    # out (8 x uint64 on the host): the same for their wide forms
    "fv_bwd_wide_phase_cycles": [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or the default toolkit location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "cannot build the fastvim_tpu_torch CUDA kernels: nvcc not found "
        "(looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME / 'bin'}). CUDA tensors need the kernels; "
        "there is no fallback.")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfastvim_kernels_{h.hexdigest()[:16]}.so"


def _fail(proc: subprocess.CompletedProcess) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n"
        f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():  # not built while this process waited
            _compile(nvcc, out)
    return out


def _compile(nvcc: str, out: Path) -> None:
    tag = f"{out.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o"
            for src in sorted(CSRC.glob("*.cu"))}
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in objs.items()]
    done = []
    for p in procs:  # all are running; collect them in turn
        stdout, stderr = p.communicate()
        done.append(subprocess.CompletedProcess(p.args, p.returncode, stdout,
                                                stderr))
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        for proc in done:
            if proc.returncode != 0:
                raise _fail(proc)
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise _fail(link)
        os.replace(tmp, out)
    finally:
        for f in (tmp, *objs.values()):
            f.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fv_error_string.argtypes = [ctypes.c_int]
            lib.fv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = library().fv_error_string(err).decode()
        raise RuntimeError(f"{name} failed: cudaError {err} ({msg})")
