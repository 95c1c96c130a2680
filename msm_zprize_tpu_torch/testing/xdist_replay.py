"""Replay pytest-xdist's ``--dist load`` schedule to predict a suite's wall time.

    python -m msm_zprize_tpu_torch.testing.xdist_replay JUNIT_XML COLLECTED [--times FILE] [--workers 6] [--noise 40]

JUNIT_XML is the ``--junitxml`` file of an earlier full run (each item's
time); COLLECTED is the output of ``pytest tests/ --collect-only -q`` for
the tree to predict (its item order); ``--times`` gives ``nodeid seconds``
lines for items the junit file lacks (new tests, timed serially). Prints the
predicted wall and each worker's items, and with ``--noise K`` the median,
90th percentile and maximum of K replays with every time scaled by a
uniform factor in [0.8, 1.2].

The model follows ``xdist/scheduler/load.py`` (pytest-xdist 3.8): each
worker first takes ``len(items) // workers // 4`` consecutive items; after
each item it is topped up to ``max(2, pending // workers // 2)`` when it
holds fewer than ``max(2, pending // workers // 4)``, unless that item took
>= 0.1 s and it still holds >= 2; a worker runs an item only while it holds
two or has been told to shut down (pytest needs the next item). Workers
start after 15 s. The N = 16 MSM programs of ``tests/test_msm_sweep.py``
stay out of the persistent compile cache, so the first projective and the
first affine item of that group on each worker pays the compile (270 s and
114 s, read off the junit times of a 928 s run) and later ones do not.
"""

from __future__ import annotations

import argparse
import heapq
import random
import statistics
import xml.etree.ElementTree as ET
from collections import deque

# shared uncached compiles: (group, node id prefixes, seconds)
COMPILES = (
    ("projective", ("tests/test_msm_sweep.py::test_msm_sweep_weierstrass[16-projective]",
                    "tests/test_msm_sweep.py::test_msm_adversarial[projective-"), 270.0),
    ("affine", ("tests/test_msm_sweep.py::test_msm_sweep_weierstrass[16-affine]",
                "tests/test_msm_sweep.py::test_msm_adversarial[affine-"), 114.0),
)
STARTUP_S = 15.0


def junit_times(path: str) -> dict:
    times = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        node = case.get("classname").replace(".", "/") + ".py::" + case.get("name")
        times[node] = float(case.get("time"))
    return times


def _group(item: str):
    for name, prefixes, seconds in COMPILES:
        if item.startswith(prefixes):
            return name, seconds
    return None, 0.0


def replay(items, times, workers: int = 6):
    """Predicted wall (s) and each worker's items, in order."""
    cost = []
    for it in items:
        t = times.get(it, 0.0)
        group, compile_s = _group(it)
        cost.append((max(t - compile_s, 0.0) if t > compile_s else t, group, compile_s))
    pending = deque(range(len(items)))
    held = [deque() for _ in range(workers)]
    chunk = max(len(items) // workers // 4, 2)
    for w in range(workers):
        for _ in range(chunk):
            if pending:
                held[w].append(pending.popleft())
    clock = [STARTUP_S] * workers
    shutdown = [not pending] * workers
    compiled = [set() for _ in range(workers)]
    running, ran, events = [None] * workers, [[] for _ in range(workers)], []

    def start(w):
        if running[w] is None and (len(held[w]) >= 2 or (shutdown[w] and held[w])):
            i = held[w].popleft()
            t, group, compile_s = cost[i]
            if group and group not in compiled[w]:
                compiled[w].add(group)
                t += compile_s
            running[w] = t
            ran[w].append(items[i])
            heapq.heappush(events, (clock[w] + t, w))

    for w in range(workers):
        start(w)
    while events:
        end, w = heapq.heappop(events)
        clock[w], duration, running[w] = end, running[w], None
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            if len(held[w]) < lo and not (duration >= 0.1 and len(held[w]) >= 2):
                for _ in range(hi - len(held[w])):
                    if pending:
                        held[w].append(pending.popleft())
        for v in range(workers):
            if not pending and not shutdown[v]:
                shutdown[v] = True
                if running[v] is None:
                    clock[v] = max(clock[v], end)
            start(v)
    return max(clock), ran


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("collected")
    ap.add_argument("--times", help="lines 'nodeid seconds' for items the junit file lacks")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--noise", type=int, default=0)
    args = ap.parse_args(argv)
    times = junit_times(args.junit)
    if args.times:
        for line in open(args.times):
            if line.strip():
                node, seconds = line.rsplit(None, 1)
                times[node] = float(seconds)
    items = [line.strip() for line in open(args.collected) if "::" in line]
    wall, ran = replay(items, times, args.workers)
    print(f"{len(items)} items, predicted wall {wall:.0f} s")
    for w, group in enumerate(ran):
        print(f"  worker {w}: {sum(times.get(i, 0.0) for i in group):.0f} s of junit time, "
              f"{len(group)} items, the longest {max(group, key=lambda i: times.get(i, 0.0))}")
    if args.noise:
        rnd = random.Random(0)
        walls = sorted(
            replay(items, {k: v * rnd.uniform(0.8, 1.2) for k, v in times.items()}, args.workers)[0]
            for _ in range(args.noise))
        print(f"noise +-20 %, {args.noise} replays: median {statistics.median(walls):.0f} s, "
              f"90th percentile {walls[int(0.9 * len(walls))]:.0f} s, max {walls[-1]:.0f} s")


if __name__ == "__main__":
    main()
