"""Version-ordered store notification delivery (counterpart of
``keto_tpu/store/notify.py``).

Mutators *enqueue* ``(version, inserted, deleted)`` while still holding the
store write lock — queue order therefore equals version-assignment order —
and *drain* after releasing it. A dedicated delivery lock serializes drains,
so listeners always observe strictly increasing versions.

- **Read-your-notification:** a mutator does not return until its own delta
  has been delivered, even when a concurrent drainer delivers the entry.
- **Listener re-entrancy:** a mutation from inside a listener re-enters
  drain on the delivering thread; an owner check turns that inner drain
  into a no-op instead of self-deadlocking.

Listener exceptions are logged and swallowed: a drainer frequently delivers
OTHER writers' versions, so propagating would blame an innocent caller.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, Optional

from ..relationtuple.definitions import RelationTuple

DeltaListener = Callable[[int, list[RelationTuple], list[RelationTuple]], None]


class OrderedNotifier:
    """Mixin: version-ordered ``subscribe_deltas`` delivery.

    The host store calls ``_init_notify()`` in ``__init__``,
    ``_enqueue_notification(version, ...)`` while HOLDING its write lock,
    and ``_drain_notifications(upto=version)`` after RELEASING it.
    """

    def _init_notify(self) -> None:
        self._delta_listeners: list[DeltaListener] = []
        self._pending_notifications: deque = deque()
        self._deliver_lock = threading.Lock()
        self._deliver_cv = threading.Condition()
        self._deliver_owner: Optional[int] = None
        self._delivered_upto = 0
        # the newest version whose delta THIS process enqueued: a version
        # past it was written elsewhere (another process on a shared SQL
        # database), and no delta for it will ever be handed over here
        self.enqueued_upto = 0

    def subscribe_deltas(self, fn: DeltaListener) -> None:
        """Register ``fn(version, inserted, deleted)`` — the feed the
        snapshot layer consumes for incremental refresh."""
        self._delta_listeners.append(fn)

    def unsubscribe_deltas(self, fn) -> None:
        try:
            self._delta_listeners.remove(fn)
        except ValueError:
            pass

    def _enqueue_notification(
        self,
        version: int,
        inserted: list[RelationTuple] | None = None,
        deleted: list[RelationTuple] | None = None,
    ) -> None:
        """MUST be called while holding the store write lock: the append
        order of this deque is the delivery order."""
        self._pending_notifications.append(
            (version, inserted or [], deleted or [])
        )
        self.enqueued_upto = max(self.enqueued_upto, version)

    def _drain_notifications(self, upto: Optional[int] = None) -> None:
        """Deliver pending notifications in version order, then — when
        ``upto`` is given — wait until delivery has passed that version."""
        me = threading.get_ident()
        if self._deliver_owner == me:
            return  # re-entrant call from a listener: the outer loop delivers
        while self._pending_notifications:
            with self._deliver_lock:
                try:
                    version, inserted, deleted = (
                        self._pending_notifications.popleft()
                    )
                except IndexError:
                    break  # a concurrent drainer took the remaining entries
                self._deliver_owner = me
                try:
                    for dfn in list(self._delta_listeners):
                        try:
                            dfn(version, inserted, deleted)
                        except Exception:
                            _log_listener_failure(version)
                finally:
                    self._deliver_owner = None
                    with self._deliver_cv:
                        if version > self._delivered_upto:
                            self._delivered_upto = version
                        self._deliver_cv.notify_all()
        if upto is not None:
            with self._deliver_cv:
                while self._delivered_upto < upto:
                    self._deliver_cv.wait(timeout=1.0)


def _log_listener_failure(version: int) -> None:
    logging.getLogger("keto.store").exception(
        "store notification listener failed (version %d)", version
    )
