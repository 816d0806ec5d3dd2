"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Counterpart of ``paddle_tpu/utils/native_build.py`` (which builds the
reference's plain C++ runtime). ``csrc/<name>.cu`` compiles on first
use into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/paddle_tpu_torch/lib<name>-<hash>.so

under ``build/paddle_tpu_torch/`` at the checkout root; the compiler's
output (``-Xptxas -v``: each kernel's registers, spills and shared
memory) is kept beside the library as ``lib<name>-<hash>.log``. The
file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is; each build writes a
temporary file and renames it into place, so a concurrent loader never
sees a partial library. ``build(names)`` starts one ``nvcc`` per
missing library at once and waits for each. Nothing is downloaded: the
build uses only the sources in ``csrc/`` and the installed CUDA
toolkit. A failed build raises with that compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNELS", "NVCC_FLAGS", "build",
           "load"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fused_adamw",
           "fused_adamw8", "quantize", "int4_matmul", "batch_norm")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ on first use")


def _library(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared includes
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> List[Path]:
    """Build the libraries of ``names`` that are missing, one ``nvcc``
    per source, all started together; returns their paths."""
    names = list(names)
    sos = [_library(n) for n in names]
    jobs = []
    for name, so in zip(names, sos):
        if so.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"kernel build failed: {name} (nvcc exit "
                          f"{proc.returncode}):\n{output}")
        else:
            so.with_suffix(".log").write_text(output)
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[0]))
    return lib
