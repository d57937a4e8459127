"""Event/listener hooks: karto's Mapper listener system, array-native; a
copy of ``tpuslam/utils/events.py``, so that the port imports nothing of
the JAX package.

The reference fires typed events through ``MapperListener``
(lesson6/lib/open_karto/include/open_karto/Mapper.h:33-80;
Mapper.cpp:2142-2218 FireLoopClosureCheck / FireBeginLoopClosure /
FireEndLoopClosure), which the ROS node uses for loop-closure logging.
tpuslam keeps the hook as a light observer registry that engines call with
plain dict payloads; the default sink is structured stderr logging.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable

Listener = Callable[[str, dict], None]


class EventBus:
    def __init__(self) -> None:
        self._listeners: list[Listener] = []

    def subscribe(self, fn: Listener) -> Callable[[], None]:
        self._listeners.append(fn)
        return lambda: self._listeners.remove(fn)

    def fire(self, event: str, **payload) -> None:
        for fn in list(self._listeners):
            fn(event, payload)


def stderr_logger(event: str, payload: dict) -> None:
    print(
        json.dumps({"ts": time.time(), "event": event, **payload}),
        file=sys.stderr,
    )


# module-level default bus (engines accept their own; this is the fallback)
default_bus = EventBus()
