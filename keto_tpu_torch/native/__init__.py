"""The native host tier: a C extension built from this package's source at
first use (counterpart of ``keto_tpu/native/__init__.py``).

``_hotpath.c`` (a copy of ``keto_tpu/native/_hotpath.c``) is compiled with
gcc into ``keto_tpu_torch/_build/`` the first time ``lib`` (or
``tuple_hash_ok``, ``build_error``) is read, and loaded as a CPython
extension module. Nothing is built when the module is imported. The file
is named by the reference's key (a hash of the source, the Python version,
the machine and the CPU flags, since ``-march=native`` binaries are
ISA-specific) and placed with an atomic ``os.replace``, so processes that
build at once each load a whole file.

The tier is a performance tier, never a correctness dependency: where no
compiler works, or ``KETO_NATIVE`` is not ``1``, ``lib`` is None, the
reason is kept in ``build_error`` and logged once, and every caller takes
its numpy twin, as in the reference. Callers test ``lib is not None``
(and ``tuple_hash_ok`` before ``request_hashes``).

The wrappers validate dtype and contiguity and pass raw addresses, so the
C side needs no numpy headers. Each counts its calls in ``<wrapper>.calls``
(unsynchronized, like the kernels' launch counters), which says which call
sites took the C path.

Why it exists: the host query path is bound by random DRAM loads that
numpy's multi-pass gathers cannot overlap; the C kernels prefetch 16-64
loads ahead (see ``_hotpath.c``).
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("_hotpath.c")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_log = logging.getLogger("keto_tpu_torch")
_lock = threading.Lock()
# the attributes set by the first load; read through __getattr__ until then
_LAZY = ("lib", "tuple_hash_ok", "build_error", "so_path", "build_s")


def _so_path() -> Path:
    src = _SRC.read_bytes()
    # a CPU fingerprint in the key: a -march=native build must never be
    # loaded on an older host (SIGILL instead of the numpy fallback)
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        cpu = ""
    key = hashlib.sha256(
        src + sys.version.encode() + os.uname().machine.encode() + cpu.encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"_hotpath_{key}.so"


def _build_lib(so_path: Path):
    """Compile (when the file is missing) and load the extension."""
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(f"{so_path}.tmp{os.getpid()}")
        base = ["-O3", "-shared", "-fPIC",
                f"-I{sysconfig.get_paths()['include']}", "-o", str(tmp), str(_SRC)]
        errors = []
        try:
            # -march=native where the compiler takes it (better prefetch
            # scheduling); portable flags otherwise
            for cmd in ([cc, *extra, *base] for extra in (["-march=native"], [])
                        for cc in ("gcc", "cc", "g++")):
                try:
                    r = subprocess.run(cmd, capture_output=True, timeout=120)
                except (OSError, subprocess.TimeoutExpired) as e:
                    errors.append(f"{cmd[0]}: {e}")
                    continue
                if r.returncode == 0:
                    os.replace(tmp, so_path)  # atomic for processes building at once
                    break
                errors.append(f"{cmd[0]}: {r.stderr.decode(errors='replace')[-400:]}")
            else:
                raise RuntimeError(
                    "no working C compiler for _hotpath: " + "; ".join(errors)
                )
        finally:
            tmp.unlink(missing_ok=True)
    loader = importlib.machinery.ExtensionFileLoader("_hotpath", str(so_path))
    spec = importlib.util.spec_from_file_location("_hotpath", so_path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _tuple_hash_selftest(lib) -> bool:
    """True when the C tuple-hash combine reproduces this interpreter's hash()
    for tuples, which request_hashes needs before it may feed the vocab index
    (keyed by Python hashes). A 32-bit or future-scheme interpreter fails
    closed: the fast path is skipped, never wrong."""
    if lib is None:
        return False
    probes = [
        ("a", "b", "c"),
        ("", "", ""),
        ("ns", "obj/with/path", "rel"),
        ("u123",),
        (str(0x1234) * 7,),
    ]
    try:
        return all(lib.tuple_hash_check(t) == hash(t) for t in probes)
    except Exception:
        return False


def load():
    """The extension module, built at the first call; None where it cannot
    be built (``build_error`` then says why)."""
    g = globals()
    if "lib" not in g:
        with _lock:
            if "lib" not in g:
                lib, error, so_path, secs = None, "", None, 0.0
                if os.environ.get("KETO_NATIVE", "1") != "1":
                    error = "disabled by KETO_NATIVE"
                else:
                    try:
                        so_path = _so_path()
                        t0 = time.perf_counter()
                        built = not so_path.exists()
                        lib = _build_lib(so_path)
                        secs = time.perf_counter() - t0 if built else 0.0
                        if built:
                            from ..telemetry.devstats import DEVSTATS

                            DEVSTATS.record_compile(secs)
                    except Exception as e:  # a missing compiler, a read-only tree
                        error = f"{type(e).__name__}: {e}"
                if lib is None:
                    _log.warning(
                        "keto_tpu_torch native host tier unavailable (%s); "
                        "falling back to the numpy paths", error,
                    )
                g.update(tuple_hash_ok=_tuple_hash_selftest(lib), build_error=error,
                         so_path=so_path, build_s=secs)
                g["lib"] = lib  # last: its presence marks the load done
    return g["lib"]


def __getattr__(name: str):
    if name in _LAZY:
        load()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def available() -> bool:
    return load() is not None


def _addr(a: np.ndarray) -> int:
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("native kernels take C-contiguous arrays")
    return a.ctypes.data


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"native kernel argument: {what}")


def request_hashes(requests, subject_id_type):
    """(hs int64[n], ht int64[n], is_id bool[n]) straight off RelationTuple
    objects: hs = hash of the (ns, obj, rel) key, ht = hash of the subject's
    node key. One C loop, no key tuples built. Callers must have checked
    tuple_hash_ok."""
    request_hashes.calls += 1
    n = len(requests)
    hs = np.empty(n, dtype=np.int64)
    ht = np.empty(n, dtype=np.int64)
    is_id = np.empty(n, dtype=np.uint8)
    load().request_hashes(
        requests, subject_id_type, _addr(hs), _addr(ht), _addr(is_id)
    )
    return hs, ht, is_id.astype(bool)


def object_hashes(keys) -> np.ndarray:
    """int64[n] of hash(k) for each key: the C loop twin of
    np.fromiter((hash(k) for k in keys), np.int64)."""
    object_hashes.calls += 1
    out = np.empty(len(keys), dtype=np.int64)
    load().object_hashes(keys, _addr(out))
    return out


def probe_index(
    slots: np.ndarray, slot_ids: np.ndarray, mask: int, h: np.ndarray
) -> np.ndarray:
    """Prefetched probe of the vocab's open-addressing index: ids, -1 = miss."""
    probe_index.calls += 1
    _require(slots.dtype == np.int64 and slot_ids.dtype == np.int32
             and h.dtype == np.int64, "probe_index dtypes")
    out = np.empty(len(h), dtype=np.int64)
    load().probe_index(
        _addr(slots), _addr(slot_ids), mask, _addr(h), len(h), _addr(out)
    )
    return out


def closure_check(
    d_host: np.ndarray,
    ig,
    start: np.ndarray,
    target: np.ndarray,
    is_id: np.ndarray,
    depth: np.ndarray,
) -> np.ndarray:
    """Fused exact check over encoded rows (sorted by start for locality).

    Twin of ClosureCheckEngine._check_arrays' gather pipeline, minus the
    width caps: true CSR degrees are walked, so no overflow fallback exists
    on this path. Returns bool[n]."""
    closure_check.calls += 1
    n = len(start)
    _require(d_host.dtype == np.uint8 and d_host.ndim == 2, "D must be uint8[m, m_pad]")
    for name in ("set_out_indptr", "set_out_vals", "id_in_indptr", "id_in_vals",
                 "interior_index"):
        _require(getattr(ig, name).dtype == np.int32, f"{name} must be int32")
    _require(ig.edge_table.dtype == np.int64, "edge_table must be int64")
    m_pad = d_host.shape[1]
    start = np.ascontiguousarray(start, dtype=np.int64)
    target = np.ascontiguousarray(target, dtype=np.int64)
    is_id8 = np.ascontiguousarray(is_id, dtype=np.uint8)
    depth = np.ascontiguousarray(depth, dtype=np.int32)
    budget = np.empty(n, dtype=np.int32)
    out = np.zeros(n, dtype=np.uint8)
    load().closure_check(
        _addr(d_host),
        m_pad,
        _addr(ig.set_out_indptr),
        _addr(ig.set_out_vals),
        _addr(ig.id_in_indptr),
        _addr(ig.id_in_vals),
        _addr(ig.interior_index),
        _addr(ig.edge_table),
        ig.edge_mask,
        ig.padded_nodes,
        _addr(start),
        _addr(target),
        _addr(is_id8),
        _addr(depth),
        n,
        _addr(budget),
        _addr(out),
    )
    return out.astype(bool)


def gather_min_u8(
    d_host: np.ndarray, rows: np.ndarray, cols: np.ndarray
) -> np.ndarray:
    """out[i] = min over D[rows[i, :], cols[i, :]] (uint8, prefetched). As in
    the reference, no module calls it yet."""
    gather_min_u8.calls += 1
    _require(d_host.dtype == np.uint8 and d_host.ndim == 2, "D must be uint8[m, m_pad]")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n = rows.shape[0]
    out = np.empty(n, dtype=np.uint8)
    load().gather_min_u8(
        _addr(d_host),
        d_host.shape[1],
        _addr(rows),
        _addr(cols),
        n,
        rows.shape[1],
        cols.shape[1],
        _addr(out),
    )
    return out


WRAPPERS = (request_hashes, object_hashes, probe_index, closure_check, gather_min_u8)
for _fn in WRAPPERS:
    _fn.calls = 0
del _fn
