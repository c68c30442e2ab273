"""Serving over a mesh: the lead rank's engine calls, replayed by the
followers.

A server on a ("data", "model") mesh (``serve/server.py --mesh``) keeps
HTTP, the scheduler and the codec on rank 0, the lead. The lead's engine
and pools are proxies (``Channel.lead``): every call that runs the model
(``MIRRORED``: ``generate``, each ``generate_stream`` segment, the
registration of a voice, the pool's making, admission and splice, its
segments, collects and releases) is first broadcast, in the order the
lead's threads make them, to every other rank, which runs it on its own
engine (``Channel.follow``). So every model group runs the same
collectives; reads of host state (``free_slots``, ``progress``, ...) stay
on the lead.

After each mirrored call every rank reports how it ended (returned, or
raised ValueError / StopIteration with the same message). A follower
that ended otherwise, or died, fails the lead's call with
``MeshFollowerError`` and marks the channel failed: the server then stops
instead of hanging. A follower exits on any other exception, so that a
lead waiting for it inside a collective fails too.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Optional

import torch.distributed as dist

# method -> the kind of the object it returns (mirrored too), or None
MIRRORED = {
    "engine": {"generate": None, "generate_stream": "stream",
               "register_adapter": None, "make_pool": "pool"},
    "pool": {"submit": None, "submit_many": None, "run": None,
             "collect": None, "collect_async": None, "release": None,
             "register_adapter": None},
    "stream": {"__next__": None},
}
EXPECTED = (ValueError, StopIteration)


class MeshFollowerError(RuntimeError):
    """A follower rank ended a mirrored call otherwise than the lead did,
    or is gone."""


class Channel:
    """The lead's ordered broadcast of calls to the follower ranks, over a
    gloo group of every rank (host objects only)."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.calls = 0
        self.failed: Optional[BaseException] = None
        self._lock = threading.RLock()
        self._next_oid = 1

    # -- lead --------------------------------------------------------------

    def lead(self, engine) -> "Mirrored":
        """The lead's proxy of its engine."""
        return Mirrored(self, engine, 0, "engine")

    def call(self, proxy: "Mirrored", method: str, *args, **kwargs):
        with self._lock:
            if self.failed is not None:
                raise MeshFollowerError(
                    f"the mesh failed earlier: {self.failed!r}")
            kind = MIRRORED[proxy._kind][method]
            oid = None
            if kind is not None:
                oid, self._next_oid = self._next_oid, self._next_oid + 1
            self._send(("call", proxy._oid, method, args, kwargs, oid))
            try:
                result, status = getattr(proxy._obj, method)(
                    *args, **kwargs), None
            except EXPECTED as e:
                result, status = e, (type(e).__name__, str(e))
            except BaseException as e:
                # the followers may wait inside a collective of this call:
                # no status exchange, the server stops
                self.failed = e
                raise
            try:
                ends = [None] * self.world
                dist.all_gather_object(ends, status, group=self.group)
            except Exception as e:              # noqa: BLE001
                self.failed = e
                raise MeshFollowerError("a follower rank is gone") from e
            bad = [r for r, s in enumerate(ends) if s != status]
            if bad:
                self.failed = MeshFollowerError(
                    f"{method}: follower {bad[0]} ended {ends[bad[0]]}, "
                    f"the lead {status}")
                raise self.failed
            self.calls += 1
            if status is not None:
                raise result
            return result if kind is None else Mirrored(self, result, oid,
                                                        kind)

    def stop(self) -> None:
        """Release the followers (their ``follow`` returns 0)."""
        with self._lock:
            if self.failed is None:
                self._send(("stop",))

    def _send(self, msg) -> None:
        try:
            dist.broadcast_object_list([msg], src=0, group=self.group)
        except Exception as e:                  # noqa: BLE001
            self.failed = e
            raise MeshFollowerError("a follower rank is gone") from e

    # -- followers ---------------------------------------------------------

    def follow(self, engine) -> int:
        """Replay the lead's calls on ``engine`` until it stops (0). Any
        exception the lead could not have had too exits the process
        (code 1), which fails the lead's next collective."""
        objs = {0: engine}
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            msg = box[0]
            if msg[0] == "stop":
                return 0
            _, oid, method, args, kwargs, new = msg
            try:
                result = getattr(objs[oid], method)(*args, **kwargs)
                status = None
                if new is not None:
                    objs[new] = result
            except EXPECTED as e:
                status = (type(e).__name__, str(e))
                if isinstance(e, StopIteration):
                    objs.pop(oid, None)
            except BaseException:               # noqa: BLE001
                traceback.print_exc()
                sys.stderr.flush()
                os._exit(1)
            dist.all_gather_object([None] * self.world, status,
                                   group=self.group)
            self.calls += 1


class Mirrored:
    """The lead's proxy of an engine, a pool or a stream: the methods in
    ``MIRRORED`` go through ``Channel.call``; everything else is the
    object's own."""

    def __init__(self, channel: Channel, obj, oid: int, kind: str):
        self._channel, self._obj, self._oid, self._kind = (channel, obj,
                                                           oid, kind)

    def __getattr__(self, name):
        if name in MIRRORED[self._kind]:
            return lambda *a, **k: self._channel.call(self, name, *a, **k)
        return getattr(self._obj, name)

    def __iter__(self):
        return self

    def __next__(self):
        return self._channel.call(self, "__next__")
