"""Build the native host pipeline's two libraries with g++ at first use.

``augment`` is ``csrc/augment.cpp`` alone and needs no libjpeg: the cell
augment and the per-image RGB augment. ``decode`` is ``csrc/decode.cpp``,
linked with ``-ljpeg``, and needs libjpeg-turbo's ``jpeglib.h``. Each is
compiled with the JAX package's Makefile flags into
``fastvim_tpu_torch/build/``, named by a hash of its sources, the flags and
the host CPU (``-march=native`` code runs only on a CPU like the one that
built it), under a file lock, and renamed into place, so that concurrent
processes build it once. A failed compile or link raises with the
compiler's output. A missing prerequisite (no g++; for ``decode``, no
usable ``jpeglib.h``) is found by :func:`missing`, a probe run before any
build.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
            "-pthread"]
# library → (its source, the headers it includes, the libraries it links)
LIBRARIES: Dict[str, tuple] = {
    "augment": ("augment.cpp", ("common.h",), ()),
    "decode": ("decode.cpp", ("common.h",), ("-ljpeg",)),
}
# compiles only where jpeglib.h is libjpeg-turbo's (decode.cpp calls
# jpeg_skip_scanlines and jpeg_crop_scanline)
JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
              "#ifndef LIBJPEG_TURBO_VERSION\n"
              "#error jpeglib.h is not libjpeg-turbo's\n#endif\n")


def _cpu_id() -> bytes:
    """The host CPU's model and flags, the target of ``-march=native``."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def compiler() -> Optional[str]:
    """The compiler's path, or None where there is none."""
    return shutil.which(CXX)


def missing(name: str) -> Optional[str]:
    """What this machine lacks to build library ``name``, or None."""
    cxx = compiler()
    if cxx is None:
        return f"no C++ compiler ({CXX!r} is not on PATH)"
    if name == "decode":
        probe = subprocess.run([cxx, "-x", "c++", "-fsyntax-only", "-"],
                               input=JPEG_PROBE, capture_output=True,
                               text=True, timeout=60)
        if probe.returncode != 0:
            first = (probe.stderr.strip().splitlines() or ["?"])[0]
            return f"no libjpeg-turbo jpeglib.h for {cxx} ({first})"
    return None


def library_path(name: str) -> Path:
    src, headers, libs = LIBRARIES[name]
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS, *libs]).encode())
    h.update(_cpu_id())
    for f in (src, *headers):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"libfastvim_native_{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless one for these sources exists."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"cannot build the {name} library: "
                           f"{missing(name)}")
    src, _, libs = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it meanwhile
            return out
        tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(CSRC / src), *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the {name} library failed "
                    f"({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
