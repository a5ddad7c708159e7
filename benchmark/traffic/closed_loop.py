"""Closed loop with one caller: each request is sent when the reply to
the one before it has come back, so a slower system receives less load
and no queue forms. The window is whole requests: it runs from the first
request's send to the return of the request that crosses `seconds`, and
on at least to request `min_requests` (a traced slice must finish inside
it). A request is made (its images and restart draws) before its send
time is taken.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Tuple


def drive(prepare: Callable[[int], Any], send: Callable[[Any], None],
          seconds: float, min_requests: int = 1,
          clock: Callable[[], float] = time.perf_counter
          ) -> List[Tuple[float, float]]:
    """prepare(i) makes request i, send(request) returns once its reply is
    in; returns [(t_send, t_done)] for every request of the window."""
    done: List[Tuple[float, float]] = []
    while True:
        req = prepare(len(done))
        t0 = clock()
        send(req)
        t1 = clock()
        done.append((t0, t1))
        if t1 - done[0][0] >= seconds and len(done) >= min_requests:
            return done
