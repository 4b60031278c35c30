"""Device selection and the CUDA kernel libraries (counterpart of
``keto_tpu/utils/jaxenv.py``).

Each ``keto_tpu_torch/csrc/<name>.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface and loaded with ``ctypes``: seconds to build, against the
minutes a source that includes PyTorch's headers takes. Libraries land in
``keto_tpu_torch/_build/`` (git-ignored), named by a hash of everything
the build reads (the source, every ``csrc/*.cuh`` header it may include,
and the flags), so an edited source or header is rebuilt and an unchanged
one is reused. Each build's seconds go to ``DEVSTATS.record_compile``
(``/debug/graph``), the counterpart of the reference's jit compilation
events.

Nothing here falls back: a missing GPU, a missing ``nvcc``, a failed build
or a failed load raises.
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
from typing import Optional

import torch

from ..telemetry.devstats import DEVSTATS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


# cudaError_t codes a launch can return, with the runtime's own text, so a
# failed launch raises with words engine/fallback.py classify_device_error
# can type (a sticky context error, a shape the card refuses, memory)
CUDA_ERROR_TEXT = {
    2: "out of memory",
    7: "too many resources requested for launch",
    9: "invalid configuration argument",
    100: "no CUDA-capable device is detected",
    209: "no kernel image is available for execution on the device",
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    710: "device-side assert triggered",
    715: "an illegal instruction was encountered",
    719: "unspecified launch failure",
}


def launch_error(kernel: str, err: int) -> RuntimeError:
    """The error a kernel wrapper raises for a nonzero cudaError_t."""
    text = CUDA_ERROR_TEXT.get(err, "unlisted cudaError_t")
    return RuntimeError(f"{kernel} launch failed: CUDA error {err}: {text}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when CUDA is asked for (or implied) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "keto_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def kernel_names() -> list[str]:
    """Every kernel source in the package, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[list[str]] = None) -> dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took (0.0 for a library already on disk). Raises
    with the compiler's output when a build fails."""
    names = kernel_names() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    secs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: {log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        DEVSTATS.record_compile(secs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
