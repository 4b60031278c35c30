"""Shared-memory request ring: wire-worker processes -> ONE batcher
(counterpart of ``keto_tpu/engine/shmring.py``).

The SO_REUSEPORT replica pool (``driver/replicas.py``) multiplies the
accept/parse front, but each replica then answers checks with its own
engine. The id-native wire tier wants the opposite split: N worker
processes doing accept + frame parsing + vocab-epoch gating, all funneling
their encoded batches into the PARENT's single check batcher — one queue,
one engine, no per-process batching. This module is that funnel.

Topology (everything is created in the parent BEFORE forking, so the
children inherit it):

- one ``multiprocessing.shared_memory`` block, partitioned into fixed-size
  slots; each worker endpoint owns a disjoint slot range, so no two
  processes ever write the same slot concurrently;
- per endpoint, one ``socketpair`` doorbell. A child claims a slot from its
  local free list, copies the encoded request frame into it, and sends the
  4-byte slot index; the parent's per-endpoint consumer thread reads the
  frame out of shared memory, runs the batcher, writes the response into
  the SAME slot, and echoes the index back.

The doorbell bytes are the only per-request kernel crossing; the
request/response payloads move through the shared mapping. A response is
``(kind, body, stages)``: ``stages`` is the parent's per-stage
``TimeLedger`` dict for that request (``telemetry/attribution.py``: the
parent's handler runs under a fresh ledger), which ``RingBackend`` merges
into the worker's own request ledger; the ring transit and the parent's
pickup land in ``queue``, so the worker's ledger stays conserved across the
process hop and its ``/debug/attribution`` shows where the parent spent
the request.

Failure contract (drilled by ``tests/test_torch_wire.py``):

- parent gone (EOF on the doorbell): every pending submit fails with the
  typed, retryable :class:`RingError`; nothing hangs, no future is lost;
- child gone: the parent consumer sees EOF and retires that endpoint only —
  in-flight work for that child is simply discarded (its futures died
  with it);
- every local slot leased past the deadline: a retryable 429
  (``ErrResourceExhausted``);
- a submit whose deadline passes mid-flight leaves its slot leased until
  the parent's ack arrives (freeing it early would let a late response
  collide with a re-used slot), then the ack recycles it.
"""

from __future__ import annotations

import logging
import pickle
import queue
import socket
import struct
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Optional

import numpy as np

from ..api import wirecodec
from ..telemetry.attribution import (
    TimeLedger,
    current_ledger,
    reset_current_ledger,
    set_current_ledger,
)
from ..utils.errors import (
    DeadlineExceeded,
    ErrMalformedInput,
    ErrResourceExhausted,
    ErrUnavailable,
    KetoError,
)

_log = logging.getLogger("keto_tpu_torch")
_DOORBELL = struct.Struct("<I")
_SLOT_LEN = struct.Struct("<I")


class RingError(ErrUnavailable):
    """The wire ring is down (the parent batcher process went away, or
    the ring was stopped). Retryable: the supervisor restarts the
    serving topology, or the client re-sends to a sibling worker."""

    def default_message(self) -> str:
        return "the wire-worker ring to the device batcher is down"


def _ship_error(e: BaseException) -> dict:
    """Exception -> picklable wire form. KetoErrors keep their full HTTP/
    gRPC mapping and envelope (details like QoS retry hints included);
    anything else degrades to a 500."""
    if isinstance(e, KetoError):
        d = {
            "message": e.message,
            "status_code": e.status_code,
            "status": e.status,
            "grpc_code": e.grpc_code,
            "envelope": e.envelope(),
        }
        ra = getattr(e, "retry_after_s", None)
        if ra is not None:
            d["retry_after_s"] = ra
        return d
    return {
        "message": f"ring handler failed: {e!r}",
        "status_code": 500,
        "status": "Internal Server Error",
        "grpc_code": "INTERNAL",
    }


class RingRemoteError(KetoError):
    """A parent-side error revived in the worker: same status codes and
    envelope as the original, so REST/gRPC handlers map it identically
    to an in-process failure."""

    def __init__(self, shipped: dict):
        self.shipped = shipped
        self.status_code = int(shipped.get("status_code", 500))
        self.status = str(shipped.get("status", "Internal Server Error"))
        self.grpc_code = str(shipped.get("grpc_code", "INTERNAL"))
        ra = shipped.get("retry_after_s")
        if ra is not None:
            self.retry_after_s = ra
        super().__init__(shipped.get("message"))

    def envelope(self) -> dict:
        return self.shipped.get("envelope") or super().envelope()


class _Endpoint:
    __slots__ = (
        "index",
        "slot_lo",
        "n_slots",
        "parent_sock",
        "child_sock",
    )

    def __init__(self, index, slot_lo, n_slots, parent_sock, child_sock):
        self.index = index
        self.slot_lo = slot_lo
        self.n_slots = n_slots
        self.parent_sock = parent_sock
        self.child_sock = child_sock


class WireRing:
    """The shared plumbing: one shm block + per-endpoint doorbells.

    Built in the parent BEFORE any fork. After forking, exactly one of
    :meth:`child_claim` (in worker ``i``), :meth:`drop_child_ends` (in
    any other inheritor, e.g. the zygote), or :meth:`parent_seal` (in
    the parent) must run — leaving a child's doorbell end open in a
    third process would mask that child's death from the parent.
    """

    def __init__(
        self,
        n_endpoints: int,
        slots_per_endpoint: int = 8,
        slot_bytes: int = 1 << 20,
    ):
        from multiprocessing import shared_memory

        self.slots_per_endpoint = max(1, int(slots_per_endpoint))
        self.slot_bytes = max(4096, int(slot_bytes))
        n_slots = max(1, int(n_endpoints)) * self.slots_per_endpoint
        self.shm = shared_memory.SharedMemory(
            create=True, size=n_slots * self.slot_bytes
        )
        self.endpoints: list[_Endpoint] = []
        for i in range(int(n_endpoints)):
            parent_sock, child_sock = socket.socketpair()
            self.endpoints.append(
                _Endpoint(
                    i,
                    i * self.slots_per_endpoint,
                    self.slots_per_endpoint,
                    parent_sock,
                    child_sock,
                )
            )

    # -- slot IO (either side) -------------------------------------------------

    def _buf(self) -> memoryview:
        buf = self.shm.buf
        if buf is None:  # closed under a handler still finishing its frame
            raise OSError("the wire ring is closed")
        return buf

    def write_slot(self, slot: int, payload: bytes) -> None:
        cap = self.slot_bytes - _SLOT_LEN.size
        if len(payload) > cap:
            raise ErrMalformedInput(
                f"encoded frame ({len(payload)} bytes) exceeds the wire "
                f"ring slot capacity ({cap} bytes); split the batch"
            )
        off = slot * self.slot_bytes
        buf = self._buf()
        _SLOT_LEN.pack_into(buf, off, len(payload))
        buf[off + _SLOT_LEN.size : off + _SLOT_LEN.size + len(payload)] = (
            payload
        )

    def read_slot(self, slot: int) -> bytes:
        off = slot * self.slot_bytes
        buf = self._buf()
        (n,) = _SLOT_LEN.unpack_from(buf, off)
        n = min(n, self.slot_bytes - _SLOT_LEN.size)
        return bytes(buf[off + _SLOT_LEN.size : off + _SLOT_LEN.size + n])

    # -- post-fork role claiming -----------------------------------------------

    def child_claim(self, index: int) -> "RingClient":
        """In forked worker ``index``: keep only this endpoint's child
        end, close everything else inherited from the parent."""
        mine = self.endpoints[index]
        for ep in self.endpoints:
            try:
                ep.parent_sock.close()
            except OSError:
                pass
            if ep is not mine:
                try:
                    ep.child_sock.close()
                except OSError:
                    pass
        return RingClient(self, mine)

    def drop_child_ends(self) -> None:
        """Close every child end so a worker's death still reads as EOF
        in the parent."""
        for ep in self.endpoints:
            try:
                ep.child_sock.close()
            except OSError:
                pass

    def drop_inherited(self) -> None:
        """In a non-worker inheritor (the zygote): close every inherited
        end — BOTH sides — plus this process's shm view, without
        unlinking. A stray copy here would mask a worker's death from
        the parent (or the parent's from a worker) by keeping the
        socketpair open past its owner."""
        for ep in self.endpoints:
            for s in (ep.parent_sock, ep.child_sock):
                try:
                    s.close()
                except OSError:
                    pass
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def parent_seal(self) -> None:
        """In the parent, after all forks: close the child ends (the
        children own them now)."""
        self.drop_child_ends()

    def close(self) -> None:
        for ep in self.endpoints:
            for s in (ep.parent_sock, ep.child_sock):
                try:
                    s.close()
                except OSError:
                    pass
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass
        try:
            self.shm.unlink()
        except (OSError, FileNotFoundError):
            pass


class RingClient:
    """Worker-side submit surface: slot lease -> shm write -> doorbell ->
    future resolved by the reply-reader thread on the parent's ack."""

    def __init__(self, ring: WireRing, endpoint: _Endpoint):
        self.ring = ring
        self.endpoint = endpoint
        self._sock = endpoint.child_sock
        self._send_lock = threading.Lock()
        self._free: queue.Queue[int] = queue.Queue()
        for s in range(endpoint.slot_lo, endpoint.slot_lo + endpoint.n_slots):
            self._free.put(s)
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._broken = False
        self._reader = threading.Thread(
            target=self._read_replies, name="wire-ring-replies", daemon=True
        )
        self._reader.start()

    def _read_replies(self) -> None:
        sock = self._sock
        while True:
            head = b""
            try:
                while len(head) < _DOORBELL.size:
                    chunk = sock.recv(_DOORBELL.size - len(head))
                    if not chunk:
                        self._break()
                        return
                    head += chunk
            except OSError:
                self._break()
                return
            (slot,) = _DOORBELL.unpack(head)
            with self._pending_lock:
                fut = self._pending.pop(slot, None)
            if fut is None:
                continue  # stale ack (should not happen) — drop
            payload = self.ring.read_slot(slot)
            # recycle AFTER the payload copy: the parent will not touch
            # this slot again until we doorbell it next
            self._free.put(slot)
            fut.set_result(payload)

    def _break(self) -> None:
        """Parent EOF/ring teardown: fail every pending future with the
        typed ring error — nothing left hanging."""
        self._broken = True
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        err = RingError()
        for fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def submit(self, frame: bytes, timeout: Optional[float] = None) -> bytes:
        """One round trip: returns the parent's response payload bytes.
        Raises RingError when the ring is down, ErrResourceExhausted when
        every local slot is leased past the deadline, DeadlineExceeded
        when the parent does not answer in time."""
        if self._broken:
            raise RingError()
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        try:
            slot = self._free.get(
                timeout=min(timeout, 5.0) if timeout is not None else 5.0
            )
        except queue.Empty:
            raise ErrResourceExhausted(
                "all wire-ring slots are in flight; retry with backoff"
            )
        fut: Future = Future()
        with self._pending_lock:
            self._pending[slot] = fut
        try:
            self.ring.write_slot(slot, frame)
            with self._send_lock:
                self._sock.sendall(_DOORBELL.pack(slot))
        except BaseException as e:
            with self._pending_lock:
                self._pending.pop(slot, None)
            self._free.put(slot)
            if isinstance(e, OSError):
                self._break()
                raise RingError() from e
            raise
        remaining = (
            None
            if deadline is None
            else max(0.0, deadline - time.monotonic())
        )
        try:
            return fut.result(remaining)
        except _FutureTimeout:
            # the slot stays leased until the parent's ack recycles it —
            # freeing now would let a late response land in a reused slot
            raise DeadlineExceeded(
                "the wire-ring round trip outlived the request deadline"
            )

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._break()


class RingServer:
    """Parent-side consumer: one thread per endpoint draining doorbells,
    each request handled synchronously against the single batcher (the
    batcher itself coalesces concurrent endpoint threads into device
    batches). Each request runs under a fresh attribution ledger whose
    stage seconds ship back with the response."""

    def __init__(self, ring: WireRing, handler: Callable[[bytes], bytes]):
        self.ring = ring
        self.handler = handler
        self._threads: list[threading.Thread] = []
        self._stopping = False

    def start(self) -> None:
        for ep in self.ring.endpoints:
            t = threading.Thread(
                target=self._serve_endpoint,
                args=(ep,),
                name=f"wire-ring-{ep.index}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_endpoint(self, ep: _Endpoint) -> None:
        sock = ep.parent_sock
        while not self._stopping:
            head = b""
            try:
                while len(head) < _DOORBELL.size:
                    chunk = sock.recv(_DOORBELL.size - len(head))
                    if not chunk:
                        self._retire(ep)
                        return
                    head += chunk
            except OSError:
                self._retire(ep)
                return
            (slot,) = _DOORBELL.unpack(head)
            frame = self.ring.read_slot(slot)
            ledger = TimeLedger()
            token = set_current_ledger(ledger)
            try:
                body = self.handler(frame)
                payload = pickle.dumps(
                    ("ok", body, ledger.stages),
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
            except Exception as e:  # shipped typed; the lane keeps serving
                payload = pickle.dumps(
                    ("err", _ship_error(e), ledger.stages),
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
            finally:
                reset_current_ledger(token)
            try:
                self.ring.write_slot(slot, payload)
                sock.sendall(_DOORBELL.pack(slot))
            except (OSError, ErrMalformedInput):
                self._retire(ep)
                return

    def _retire(self, ep: _Endpoint) -> None:
        if self._stopping:
            return
        _log.warning(
            "wire worker endpoint %d closed; retiring its ring lane", ep.index
        )
        try:
            ep.parent_sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stopping = True
        for ep in self.ring.endpoints:
            try:
                ep.parent_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ep.parent_sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()


class RingBackend:
    """The encoded front's backend in a wire worker: ships the (already
    epoch-validated, already clamped) batch over the ring instead of
    running a local engine. Duck-typed against the batcher via the
    ``ring_submit`` hook the front prefers."""

    def __init__(self, client: RingClient):
        self.client = client

    def ring_submit(self, req, start, target, timeout=None):
        frame = wirecodec.encode_check_request(
            np.asarray(start, dtype=np.int32),
            np.asarray(target, dtype=np.int32),
            lineage=req.lineage,
            epoch=req.epoch,
            ns=req.ns,
            depths=req.depths,
            min_version=req.min_version,
            traceparent=req.traceparent,
        )
        led = current_ledger()
        if led is not None:
            led.mark("admission")  # the local parse and gate up to the hop
        t0 = time.perf_counter()
        payload = self.client.submit(frame, timeout=timeout)
        t1 = time.perf_counter()
        kind, body, stages = pickle.loads(payload)  # written by our parent
        if led is not None:
            # the parent's stage seconds, and the ring transit and the
            # parent's pickup as "queue": the ledger stays conserved
            remote = 0.0
            for stage, dt in stages.items():
                led.stages[stage] = led.stages.get(stage, 0.0) + dt
                remote += dt
            residual = max(0.0, (t1 - t0) - remote)
            if residual > 0:
                led.stages["queue"] = led.stages.get("queue", 0.0) + residual
            led.last = time.perf_counter()
        if kind == "err":
            raise RingRemoteError(body)
        allowed, _token = wirecodec.decode_check_response(body)
        return allowed


__all__ = [
    "WireRing",
    "RingClient",
    "RingServer",
    "RingBackend",
    "RingError",
    "RingRemoteError",
]
