"""Replay the tier-1 run's xdist schedule from its JUnit XML.

``python tests/port_schedule_replay.py RUN.xml [--workers 6]`` reads every
test's file and seconds from the XML that ``pytest --junitxml`` wrote and
replays pytest-xdist 3.8's ``--dist loadfile`` scheduler on them
(``xdist/scheduler/loadscope.py``): the files are queued by their collected
item count, most first (ties in collection order), each worker starts with
one file, and a worker takes the next file whenever 2 or fewer of its
assigned tests are left. A worker runs its tests in the order it took them.

It prints each file's items and seconds, the replayed wall time (from the
first test; collection and start-up are not in the XML), the file that ends
last, and the worker-seconds of the port's files (``test_torch_*``) that are
handed out before ``tests/test_models.py``.
"""
from __future__ import annotations

import argparse
import heapq
import xml.etree.ElementTree as ET
from collections import OrderedDict, deque


def read_files(path: str) -> "OrderedDict[str, list]":
    """file -> [seconds of each test], in the XML's (collection) order."""
    files: "OrderedDict[str, list]" = OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname", "").split(".")
        # tests.test_x[.Class] -> tests/test_x.py
        mod = [p for p in name if p.startswith("test_")][:1]
        key = "tests/" + (mod[0] if mod else name[-1]) + ".py"
        files.setdefault(key, []).append(float(case.get("time", 0.0)))
    return files


def replay(files: "OrderedDict[str, list]", workers: int = 6):
    """(wall seconds, {file: (worker, start, end)}, order handed out)."""
    queue = deque(sorted(files, key=lambda f: -len(files[f])))  # stable: ties keep order
    order = list(queue)
    pending = {w: deque() for w in range(workers)}   # (file, seconds) not yet started
    left = {w: 0 for w in range(workers)}            # assigned tests not yet complete
    clock = {w: 0.0 for w in range(workers)}
    spans: dict = {}
    events: list = []

    def assign(w):
        f = queue.popleft()
        for i, t in enumerate(files[f]):
            pending[w].append((f, t, i == 0, i == len(files[f]) - 1))
        left[w] += len(files[f])

    def start_next(w):
        if pending[w]:
            f, t, first, last = pending[w].popleft()
            if first:
                spans[f] = [w, clock[w], None]
            heapq.heappush(events, (clock[w] + t, w, f, last))

    for w in range(min(workers, len(queue))):
        assign(w)
        start_next(w)
    wall = 0.0
    while events:
        now, w, f, last = heapq.heappop(events)
        clock[w], wall = now, max(wall, now)
        if last:
            spans[f][2] = now
        left[w] -= 1
        if queue and left[w] <= 2:
            assign(w)
        start_next(w)
    return wall, {f: tuple(v) for f, v in spans.items()}, order


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    files = read_files(args.xml)
    wall, spans, order = replay(files, args.workers)
    for f in order:
        w, t0, t1 = spans[f]
        print(f"{f:55s} {len(files[f]):4d} items {sum(files[f]):8.1f} s  "
              f"worker {w}  {t0:7.1f}-{t1:7.1f}")
    last = max(spans, key=lambda f: spans[f][2])
    print(f"replayed wall {wall:.1f} s (ends with {last}); measured sum of tests "
          f"{sum(sum(v) for v in files.values()):.1f} worker-s")
    gate = "tests/test_models.py"
    if gate in order:
        ahead = order[:order.index(gate)]
        port = [f for f in ahead if f.startswith("tests/test_torch_")]
        print(f"{gate} handed out {order.index(gate) + 1}th, starts at "
              f"{spans[gate][1]:.1f} s; port files ahead of it: {len(port)}, "
              f"{sum(sum(files[f]) for f in port):.1f} worker-s")


if __name__ == "__main__":
    main()
