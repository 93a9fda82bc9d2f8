"""The one general generator of load: closed loops that a traffic file
parameterises.

A ``search`` mix (``request_rows``, ``in_flight``, ``queries_on``,
``rate``) sends requests of consecutive rows of the query pool, wrapping,
from the device (the embed-on-card case) or from host memory, and copies
each reply into pinned host memory. At most ``in_flight`` requests are
outstanding: the client enqueues the next before it waits for the oldest.
Without a ``rate`` the loop is closed: a request is due as soon as one
is free, so the load is the system's capacity. With a ``rate`` (requests
a second) request ``i`` is due ``i / rate`` seconds into the window, the
same schedule for every seed, and its latency runs from when it was due:
a request sent late has waited in the queue. A ``build`` mix rebuilds the
index over the device rows again and again, freeing each index before the
next build.

Every window records per request (due, sent, dispatched, done) host
times and per build (start, done, the program's ``build_stats``); a
window's length is fixed in seconds or in requests (builds). A window
given a ``spans`` list records the benchmark's host spans (dispatch,
fetch, wait, build) into it (:func:`hnswbench.trace.span`).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import random
import time

import torch

from hnswbench.trace import span

now = time.perf_counter


@dataclasses.dataclass
class Window:
    """What one window did. ``records``: per request (due, sent,
    dispatched, done) or per build (start, done, build_stats)."""

    begin: float
    seconds: float  # math.inf when the window is fixed by its count
    rows: int       # query rows a request carries (0 for builds)
    records: list

    def done_at(self, record: tuple) -> float:
        return record[1] if self.rows == 0 else record[3]

    def done_in_window(self) -> list:
        """Records completed before the window's end."""
        end = self.begin + self.seconds
        return [r for r in self.records if self.done_at(r) <= end]


class Reservoir:
    """A uniform sample, drawn from the seed, of a window's replies:
    ``capacity`` request slots, filled by reservoir sampling as replies
    arrive, so that its size does not depend on the window's length."""

    def __init__(self, capacity: int, seed: int):
        self.capacity = max(1, capacity)
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept: dict = {}

    def offer(self, start: int, dist: torch.Tensor, ids: torch.Tensor):
        j = self.seen
        self.seen += 1
        slot = j if j < self.capacity else self.rng.randrange(j + 1)
        if slot < self.capacity:
            self.kept[slot] = (start, dist.clone(), ids.clone())

    def sample(self, pool_rows: int):
        """(pool rows ``[m]``, distances ``[m, k]``, ids ``[m, k]``) of the
        kept replies, on the host."""
        starts, dists, ids = [], [], []
        for start, d, i in self.kept.values():
            starts.append((start + torch.arange(d.shape[0])) % pool_rows)
            dists.append(d)
            ids.append(i)
        return torch.cat(starts), torch.cat(dists), torch.cat(ids)


class _Slot:
    """Pinned host buffers for one outstanding reply, and its event."""

    def __init__(self, dist: torch.Tensor, ids: torch.Tensor):
        cuda = dist.device.type == "cuda"
        self.dist = torch.empty(dist.shape, dtype=dist.dtype,
                                pin_memory=cuda)
        self.ids = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def fetch(self, dist: torch.Tensor, ids: torch.Tensor) -> None:
        self.dist.copy_(dist, non_blocking=True)
        self.ids.copy_(ids, non_blocking=True)
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class SearchClient:
    """The client of a ``search`` mix over one served index: a closed loop,
    or requests due at the mix's fixed ``rate``."""

    def __init__(self, engine, index, pool: torch.Tensor, traffic: dict,
                 k: int, probes: int):
        self.engine, self.index = engine, index
        self.k, self.probes = k, probes
        self.rows = int(traffic["request_rows"])
        self.in_flight = int(traffic["in_flight"])
        self.rate = traffic.get("rate")
        self.pool_rows = pool.shape[0]
        # the pool followed by its first rows again: every request is one
        # contiguous slice
        ext = pool[torch.arange(self.pool_rows + self.rows - 1,
                                device=pool.device) % self.pool_rows]
        where = traffic["queries_on"]
        if where == "host":
            self.source = ext.cpu().numpy()
        elif where == "device":
            self.source = ext
        else:
            raise ValueError(f"queries_on must be host|device, not {where!r}")
        self.next_start = 0
        self.slots: list = []

    def window(self, *, seconds: float = math.inf, requests: int | None = None,
               spans: list | None = None,
               reservoir: Reservoir | None = None
               ) -> Window:
        """Sends requests until ``seconds`` have passed or ``requests`` were
        sent, then waits for the outstanding ones."""
        pending = collections.deque()
        records = []
        begin = now()
        end = begin + seconds
        sent = 0
        while (requests is None or sent < requests) and now() < end:
            due = begin + sent / self.rate if self.rate else now()
            if due >= end:
                break
            while now() < due:
                pass
            start = self.next_start
            self.next_start = (start + self.rows) % self.pool_rows
            q = self.source[start:start + self.rows]
            t0 = now()
            with span("dispatch", spans):
                dist, ids = self.engine.search(self.index, q, self.k,
                                               self.probes)
            t1 = now()
            if not self.slots:
                self.slots = [_Slot(dist, ids) for _ in range(self.in_flight)]
            slot = self.slots[sent % self.in_flight]
            with span("fetch", spans):
                slot.fetch(dist, ids)
            pending.append((start, due, t0, t1, slot))
            sent += 1
            if len(pending) >= self.in_flight:
                records.append(self._complete(pending.popleft(), spans,
                                              reservoir))
        while pending:
            records.append(self._complete(pending.popleft(), spans,
                                          reservoir))
        return Window(begin, seconds, self.rows, records)

    def _complete(self, item, spans, reservoir) -> tuple:
        start, due, t0, t1, slot = item
        with span("wait", spans):
            slot.wait()
        t2 = now()
        if reservoir is not None:
            reservoir.offer(start, slot.dist, slot.ids)
        return (due, t0, t1, t2)


def build_window(engine, config: dict, rows: torch.Tensor, *,
                 seconds: float = math.inf, builds: int | None = None,
                 spans: list | None = None):
    """Builds the index over ``rows`` again and again until ``seconds``
    have passed or ``builds`` were made, freeing each index before the
    next. Returns (the last index, :class:`Window`)."""
    records = []
    index = None
    begin = now()
    end = begin + seconds
    while (builds is None or len(records) < builds) and now() < end:
        index = None
        t0 = now()
        with span("build", spans):
            index = engine.build(config, rows)
        records.append((t0, now(), engine.build_stats(index)))
    return index, Window(begin, seconds, 0, records)


def serve_all(engine, index, pool: torch.Tensor, k: int, probes: int,
              rows: int):
    """Every pool query served by ``index`` in requests of ``rows``:
    (pool rows, distances, ids) on the host."""
    dists, ids = [], []
    for s in range(0, pool.shape[0], rows):
        d, i = engine.search(index, pool[s:s + rows], k, probes)
        dists.append(d.cpu())
        ids.append(i.cpu())
    return torch.arange(pool.shape[0]), torch.cat(dists), torch.cat(ids)
