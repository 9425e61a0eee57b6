"""Build-at-first-use helper for the port's native libraries.

Every native piece of the port — the host packer (``sched/csrc/packer.cc``,
g++) and the CUDA kernels (``kernels/csrc/*.cu``, nvcc) — is compiled from
the sources in the checkout into ``analyzer_tpu_torch/_build/`` the first
time it is needed, and loaded with ctypes (a plain C interface: no PyTorch
headers, so a build takes seconds). The library name carries a hash of the
compiler command, the flags and every source and header, so a changed
source or flag builds afresh and a stale library is never loaded. The
compile writes a temporary file and renames it into place, so concurrent
processes either see the finished library or build it harmlessly twice.
The compiler's messages are kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def library_path(name: str, command: list[str], files: list[str]) -> str:
    """Where the library built by ``command`` from ``files`` lives."""
    h = hashlib.sha256("\0".join(command).encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_and_load(
    name: str, command: list[str], sources: list[str], headers: list[str] = ()
) -> ctypes.CDLL:
    """Compiles ``sources`` with ``command`` (compiler and flags; the output
    and source paths are appended) unless the keyed library exists, then
    loads it. A failed build raises RuntimeError with the compiler's
    output."""
    lib = library_path(name, command, [*sources, *headers])
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [*command, "-o", tmp, *sources],
                capture_output=True, text=True,
            )
            with open(lib[: -len(".so")] + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({command[0]} exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(lib)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH.
    Raises where there is none (a machine without the CUDA toolkit)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (no CUDA_HOME/bin/nvcc and none on PATH); the "
            "CUDA kernels cannot be built"
        )
    return nvcc


def build_log(name: str, command: list[str], files: list[str]) -> str:
    """The compiler's messages from the build of this library ('' if none
    were kept)."""
    path = library_path(name, command, files)[: -len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
