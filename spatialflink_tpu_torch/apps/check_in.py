"""CheckIn app: room occupancy from in/out sensor events (port of
``spatialflink_tpu.apps.check_in``; the DEIM demo, reference
``apps/CheckIn.java:26-346``).

Events are :class:`Point` records carrying the DEIM fields
(``event_id``/``device_id``/``user_id``; ``Point.java:44-46``); a device id
is ``"<room>-<in|out>"``. Two stages, as in the reference:

1. missing-event insertion (``CheckIn.java:251-317``): per user, two
   consecutive events from the SAME device id (two "in"s or two "out"s)
   imply a lost opposite event, inserted at the midpoint timestamp;
2. occupancy counting (``CheckIn.java:208-250``): per room (the device id's
   prefix), a running count, +1 on "-in" and -1 on "-out", emitted per
   event with the room's capacity and the emission wall clock.

Host-only: the events never reach the card.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.operators.base import (QueryConfiguration,
                                                   QueryType,
                                                   SpatialOperator)


def parse_checkin_csv(line: str, delimiter: str = ",") -> Point:
    """``eventID,deviceID,userID,timestamp,x,y`` -> a DEIM point (the
    constructor ``Point(eventID, deviceID, userID, ts, x, y)``,
    ``Point.java:114-125``)."""
    f = [s.strip() for s in line.strip().split(delimiter)]
    return Point(obj_id=f[2], timestamp=int(f[3]),
                 x=float(f[4]) if len(f) > 4 else 0.0,
                 y=float(f[5]) if len(f) > 5 else 0.0,
                 event_id=f[0], device_id=f[1], user_id=f[2])


def _room(device_id: str) -> str:
    return device_id.split("-", 1)[0]


def _symbol(device_id: str) -> str:
    return device_id.split("-", 1)[1] if "-" in device_id else ""


class CheckIn(SpatialOperator):
    """The occupancy pipeline; grid-free (``grid=None``). Count windows are
    refused: the app has its own fixed pipeline."""

    def __init__(self, conf: QueryConfiguration, grid=None,
                 room_capacities: Optional[Dict[str, int]] = None, *,
                 device="cuda"):
        if conf.query_type is QueryType.CountBased:
            raise NotImplementedError(
                "CountBased queries are not yet supported")
        super().__init__(conf, grid, device=device)
        self.room_capacities = dict(room_capacities or {})

    def insert_missing_events(self, stream: Iterable[Point]
                              ) -> Iterator[Point]:
        """Per user, repair lost in/out events: two consecutive events with
        the same device id get the opposite event at the midpoint timestamp
        (``CheckIn.java:283-307``)."""
        last: Dict[str, Point] = {}
        for p in stream:
            prev = last.get(p.user_id)
            last[p.user_id] = p
            if prev is None:
                yield p
                continue
            if prev.device_id == p.device_id and _symbol(p.device_id):
                mid = (prev.timestamp + p.timestamp) // 2
                sym = _symbol(prev.device_id)
                flipped = _room(prev.device_id) + ("-out" if sym == "in"
                                                   else "-in")
                yield Point(obj_id=p.user_id, timestamp=mid, x=p.x, y=p.y,
                            event_id=p.event_id, device_id=flipped,
                            user_id=p.user_id)
            yield p

    def run(self, stream: Iterable
            ) -> Iterator[Tuple[str, Optional[int], int, int]]:
        """``(room, capacity, occupancy, emit_ms)`` per event after the
        repair; raw CSV lines parse with :func:`parse_checkin_csv`."""
        points = (p if isinstance(p, Point) else parse_checkin_csv(p)
                  for p in stream)
        counters: Dict[str, int] = {}
        for p in self.insert_missing_events(points):
            room = _room(p.device_id)
            delta = {"in": 1, "out": -1}.get(_symbol(p.device_id), 0)
            counters[room] = counters.get(room, 0) + delta
            yield (room, self.room_capacities.get(room), counters[room],
                   int(time.time() * 1000))
