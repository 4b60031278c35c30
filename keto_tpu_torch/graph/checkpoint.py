"""Atomic store checkpoints: tmp+rename snapshots of the tuple state
(counterpart of ``keto_tpu/graph/checkpoint.py``; the same file format).

A checkpoint pins the whole store at one version, so recovery is "load the
newest checkpoint, replay the WAL suffix" instead of re-ingesting every
tuple. The writer serializes to ``<name>.tmp.<pid>.<thread>``, fsyncs the
file, renames it onto the final name (``os.replace``) and fsyncs the
directory: a reader sees a complete previous checkpoint or a complete new
one, never a half-written file. Leftover ``.tmp.*`` files from a crash are ignored and
swept by the next successful write.

One ``.npz`` per checkpoint, named by version::

    ckpt-00000000000000042000.npz

Two store kinds (``meta["kind"]``):

- ``memory``   — InMemoryTupleStore: tuples in insertion order + seq;
- ``columnar`` — ColumnarTupleStore: the 11 int32/bool columns (rows
  [0, n), tombstones included), the four string pools, the shared
  NodeVocab, and the live/derived counters. String pools and vocab keys
  serialize as separator-joined blobs (``\x1f`` fields, ``\x1e`` records),
  with a JSON fallback when a string holds a separator.

``meta["sha256"]`` binds every payload array (names, dtypes, shapes,
bytes); a checkpoint whose payload does not hash to it is refused, and
``load_latest`` falls back to an older one. A checkpoint may carry the CSR
arrays of a GraphSnapshot built at the same version, so boot can skip the
first CSR derivation.

Fault site: ``checkpoint.crash_mid_write`` truncates the tmp file and
raises before the rename.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..faults import FAULTS, FaultInjected
from ..store.wal import decode_tuple, encode_tuple

_CKPT_PREFIX = "ckpt-"
_CKPT_SUFFIX = ".npz"
_FIELD_SEP = "\x1f"
_REC_SEP = "\x1e"

#: columnar column names in serialization order (matches
#: ColumnarTupleStore._cols)
_COLUMNS = (
    "ns", "obj", "rel", "sub_is_set", "sub_ns", "sub_obj", "sub_rel",
    "sub_id", "src_node", "dst_node", "alive",
)
_POOLS = ("ns", "obj", "rel", "sid")


class CheckpointError(RuntimeError):
    pass


def _payload_sha256(arrays: dict) -> str:
    """Digest of every payload array (name-sorted, ``meta`` excluded —
    the digest lives inside meta, so meta cannot cover itself). The hash
    binds names, shapes, dtypes, and bytes: a renamed or reshaped array
    is damage, not a collision."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == "meta":
            continue
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode("utf-8"))
        h.update(str(a.dtype).encode("utf-8"))
        h.update(str(a.shape).encode("utf-8"))
        h.update(a.tobytes())
    return h.hexdigest()


def _pack_strings(strings: list[str]) -> tuple[np.ndarray, str]:
    """(uint8 blob, mode). Fast path: one separator join (decode is a
    single ``str.split`` — seconds faster than JSON at 10M+ strings).
    Falls back to JSON when the data could alias the separators."""
    if any(_FIELD_SEP in s or _REC_SEP in s for s in strings):
        blob = json.dumps(strings).encode("utf-8")
        return np.frombuffer(blob, dtype=np.uint8), "json"
    blob = _REC_SEP.join(strings).encode("utf-8")
    return np.frombuffer(blob, dtype=np.uint8), "sep"


def _unpack_strings(blob: np.ndarray, mode: str, count: int) -> list[str]:
    text = blob.tobytes().decode("utf-8")
    if mode == "json":
        out = json.loads(text)
    else:
        out = text.split(_REC_SEP) if count else []
    if len(out) != count:
        raise CheckpointError(
            f"string table decoded to {len(out)} entries, expected {count}"
        )
    return out


def checkpoint_path(directory: str, version: int) -> str:
    return os.path.join(
        directory, f"{_CKPT_PREFIX}{version:020d}{_CKPT_SUFFIX}"
    )


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """[(version, path)] ascending; ignores tmp litter and alien files."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if not (
            name.startswith(_CKPT_PREFIX) and name.endswith(_CKPT_SUFFIX)
        ):
            continue
        try:
            version = int(name[len(_CKPT_PREFIX):-len(_CKPT_SUFFIX)])
        except ValueError:
            continue
        out.append((version, os.path.join(directory, name)))
    out.sort()
    return out


def latest_checkpoint(directory: str) -> Optional[tuple[int, str]]:
    found = list_checkpoints(directory)
    return found[-1] if found else None


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sweep_tmp(directory: str) -> None:
    """Remove tmp litter left by crashed writers (safe: tmp names embed a
    pid and are never the target of a rename once the writer is gone)."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return
    for name in names:
        if ".tmp." in name and name.startswith(_CKPT_PREFIX):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass


# -- serialization --------------------------------------------------------------


def _serialize_memory(store) -> tuple[dict, dict[str, np.ndarray]]:
    with store._lock:
        tuples = list(store._tuples)
        seq = store._seq
        version = store._version
    blob = json.dumps([encode_tuple(t) for t in tuples]).encode("utf-8")
    meta = {"kind": "memory", "version": version, "seq": seq,
            "count": len(tuples)}
    return meta, {"tuples": np.frombuffer(blob, dtype=np.uint8)}


def _serialize_columnar(store) -> tuple[dict, dict[str, np.ndarray]]:
    with store._lock:
        n = store._n
        arrays = {
            f"col_{name}": store._cols[name][:n].copy() for name in _COLUMNS
        }
        pool_lists = {
            name: list(getattr(store, f"_{name}")._strings)
            for name in _POOLS
        }
        vocab_keys = list(store.vocab._key_of)
        meta = {
            "kind": "columnar",
            "version": store._version,
            "n": n,
            "live": store._live,
            "derived_len": store._derived_len,
        }
    pool_meta = {}
    for name, strings in pool_lists.items():
        blob, mode = _pack_strings(strings)
        arrays[f"pool_{name}"] = blob
        pool_meta[name] = {"mode": mode, "count": len(strings)}
    meta["pools"] = pool_meta
    # vocab keys are (id,) or (ns, obj, rel): a kind bit per key plus the
    # flattened component strings
    kinds = np.fromiter(
        (len(k) == 3 for k in vocab_keys), dtype=bool, count=len(vocab_keys)
    )
    flat: list[str] = []
    for k in vocab_keys:
        flat.extend(k)
    vocab_blob, vocab_mode = _pack_strings(flat)
    arrays["vocab_kinds"] = kinds
    arrays["vocab_strs"] = vocab_blob
    meta["vocab"] = {
        "mode": vocab_mode,
        "keys": len(vocab_keys),
        "flat": len(flat),
    }
    return meta, arrays


def write_checkpoint(
    directory: str,
    store,
    *,
    keep: int = 2,
    csr: Optional[tuple[np.ndarray, np.ndarray]] = None,
    csr_version: Optional[int] = None,
) -> str:
    """Serialize ``store`` to an atomic checkpoint file; returns the final
    path. Prunes to the ``keep`` newest checkpoints afterwards. ``csr``
    optionally embeds a derived (indptr, indices) pair built at
    ``csr_version`` so boot can skip the first CSR derivation."""
    kind = type(store).__name__
    if kind == "InMemoryTupleStore":
        meta, arrays = _serialize_memory(store)
    elif kind == "ColumnarTupleStore":
        meta, arrays = _serialize_columnar(store)
    else:
        raise CheckpointError(
            f"cannot checkpoint store type {kind}; expected the memory or "
            "columnar store"
        )
    if csr is not None:
        arrays["csr_indptr"] = np.asarray(csr[0])
        arrays["csr_indices"] = np.asarray(csr[1])
        meta["csr_version"] = (
            int(csr_version) if csr_version is not None else meta["version"]
        )
    meta["sha256"] = _payload_sha256(arrays)
    meta_blob = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    arrays["meta"] = np.frombuffer(meta_blob, dtype=np.uint8)

    os.makedirs(directory, exist_ok=True)
    final = checkpoint_path(directory, meta["version"])
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            if FAULTS.should_fire("checkpoint.crash_mid_write"):
                # die with a half-written tmp file: the rename below never
                # happens, so readers must keep seeing the previous
                # checkpoint untouched
                f.truncate(max(1, f.tell() // 2))
                f.flush()
                os.fsync(f.fileno())
                raise FaultInjected("checkpoint.crash_mid_write")
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        # leave fault-injected litter in place (a real crash would); sweep
        # only the happy path
        raise
    _fsync_dir(directory)
    prune_checkpoints(directory, keep=keep)
    _sweep_tmp(directory)
    return final


def prune_checkpoints(directory: str, *, keep: int = 2) -> int:
    removed = 0
    found = list_checkpoints(directory)
    for _version, path in found[: max(0, len(found) - max(1, keep))]:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    if removed:
        _fsync_dir(directory)
    return removed


# -- load / restore -------------------------------------------------------------


@dataclass
class Checkpoint:
    path: str
    kind: str
    version: int
    meta: dict
    _npz: object
    csr: Optional[tuple[np.ndarray, np.ndarray]] = None
    csr_version: Optional[int] = None

    def close(self) -> None:
        """Release the underlying npz file handle (verify-only readers —
        the scrubber — open many checkpoints and must not
        leak descriptors)."""
        close = getattr(self._npz, "close", None)
        if close is not None:
            close()

    def restore_into(self, store) -> None:
        """Overwrite ``store`` (same kind it was written from) with the
        checkpointed state. Bypasses the mutator surface on purpose:
        restore is raw state transplant, no notifications, no
        validation."""
        if self.kind == "memory":
            self._restore_memory(store)
        elif self.kind == "columnar":
            self._restore_columnar(store)
        else:
            raise CheckpointError(f"unknown checkpoint kind {self.kind!r}")

    def _restore_memory(self, store) -> None:
        if type(store).__name__ != "InMemoryTupleStore":
            raise CheckpointError(
                f"memory checkpoint cannot restore into "
                f"{type(store).__name__}"
            )
        blob = self._npz["tuples"]
        records = json.loads(blob.tobytes().decode("utf-8"))
        if len(records) != self.meta["count"]:
            raise CheckpointError("tuple count mismatch in checkpoint")
        with store._lock:
            store._tuples = {
                decode_tuple(rec): i for i, rec in enumerate(records)
            }
            store._seq = int(self.meta["seq"])
            store._version = self.version

    def _restore_columnar(self, store) -> None:
        if type(store).__name__ != "ColumnarTupleStore":
            raise CheckpointError(
                f"columnar checkpoint cannot restore into "
                f"{type(store).__name__}"
            )
        meta = self.meta
        n = int(meta["n"])
        npz = self._npz
        cols = {}
        for name in _COLUMNS:
            arr = npz[f"col_{name}"]
            if len(arr) != n:
                raise CheckpointError(f"column {name} length mismatch")
            cap = max(1024, n)
            grown = np.empty(cap, arr.dtype)
            grown[:n] = arr
            cols[name] = grown
        pools = {}
        for name in _POOLS:
            pmeta = meta["pools"][name]
            pools[name] = _unpack_strings(
                npz[f"pool_{name}"], pmeta["mode"], pmeta["count"]
            )
        vmeta = meta["vocab"]
        kinds = npz["vocab_kinds"]
        flat = _unpack_strings(npz["vocab_strs"], vmeta["mode"], vmeta["flat"])
        if len(kinds) != vmeta["keys"]:
            raise CheckpointError("vocab kind table length mismatch")
        key_of: list[tuple] = []
        pos = 0
        for is_set in kinds.tolist():
            if is_set:
                key_of.append((flat[pos], flat[pos + 1], flat[pos + 2]))
                pos += 3
            else:
                key_of.append((flat[pos],))
                pos += 1
        if pos != len(flat):
            raise CheckpointError("vocab flat table length mismatch")

        with store._lock:
            store._cols = cols
            store._n = n
            store._live = int(meta["live"])
            store._derived_len = int(meta["derived_len"])
            store._version = self.version
            for name in _POOLS:
                pool = getattr(store, f"_{name}")
                pool._strings = pools[name]
                pool._id_of = {s: i for i, s in enumerate(pools[name])}
            store.vocab._key_of = key_of
            store.vocab._id_of = dict(zip(key_of, range(len(key_of))))
            # lazy node->pool-id arrays rebuild on demand from the vocab
            store._node_cols_len = 0
            store._node_ns = np.empty(0, np.int32)
            store._node_obj = np.empty(0, np.int32)
            store._node_rel = np.empty(0, np.int32)
            store._node_sid = np.empty(0, np.int32)
            # row lookup: one sorted chunk over every restored row (incl.
            # tombstones), keeping the highest row per key — the current
            # owner, exactly what _row_for_key's max() expects
            store._row_of = {}
            if n:
                keys = (
                    cols["src_node"][:n].astype(np.int64) << 32
                ) | cols["dst_node"][:n].astype(np.int64)
                rows = np.arange(n, dtype=np.int64)
                order = np.lexsort((rows, keys))
                keys = keys[order]
                rows = rows[order]
                last = np.append(keys[1:] != keys[:-1], True)
                store._key_chunks = [(keys[last], rows[last])]
            else:
                store._key_chunks = []


def load_checkpoint(path: str) -> Checkpoint:
    """Open and validate one checkpoint file. Raises CheckpointError on any
    damage (a torn tmp never reaches a final name, so damage here means
    bit rot or operator error — refuse it and fall back to an older
    checkpoint or full WAL replay)."""
    try:
        npz = np.load(path, allow_pickle=False)
        meta = json.loads(npz["meta"].tobytes().decode("utf-8"))
    except Exception as e:  # zipfile/json/np errors: one failure surface
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    kind = meta.get("kind")
    if kind not in ("memory", "columnar"):
        raise CheckpointError(f"unknown checkpoint kind in {path}: {kind!r}")
    want = meta.get("sha256")
    if want is not None:
        # pre-sha256 checkpoints (no field) load as before; a checkpoint
        # that CLAIMS a digest must match it — a half-trusted checkpoint
        # never boots silently
        try:
            got = _payload_sha256({n: npz[n] for n in npz.files})
        except Exception as e:
            raise CheckpointError(
                f"unreadable checkpoint payload {path}: {e}"
            ) from e
        if got != want:
            raise CheckpointError(
                f"checkpoint {path} failed sha256 verification: "
                f"meta says {want}, payload hashes to {got}"
            )
    csr = None
    csr_version = None
    if "csr_indptr" in getattr(npz, "files", ()):
        csr = (npz["csr_indptr"], npz["csr_indices"])
        csr_version = meta.get("csr_version")
    return Checkpoint(
        path=path,
        kind=kind,
        version=int(meta["version"]),
        meta=meta,
        _npz=npz,
        csr=csr,
        csr_version=csr_version,
    )


def load_latest(directory: str) -> Optional[Checkpoint]:
    """Newest loadable checkpoint, skipping damaged files (with the skip
    recorded on the returned object's meta for the recovery log)."""
    found = list_checkpoints(directory)
    skipped = []
    for version, path in reversed(found):
        try:
            ckpt = load_checkpoint(path)
        except CheckpointError as e:
            skipped.append(str(e))
            continue
        if skipped:
            ckpt.meta["skipped_damaged"] = skipped
        return ckpt
    return None
