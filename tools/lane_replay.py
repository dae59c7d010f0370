"""Replay a test lane's junit times through pytest-xdist's `--dist loadfile` rule.

    python3 tools/lane_replay.py lane.xml [--workers 6] [--move FILE:TEST[,TEST...]]

xdist (3.8.0, `LoadScopeScheduling`) queues the files by their number of
tests, largest first, hands each worker one file, and hands a worker the
next file whenever it has at most 2 tests left. This script runs that rule
on the per-test times of a junit file (as the tier-1 lane writes it) and
prints the replayed end of the lane and each worker's files, without the
lane's start-up and collection. `--move` replays a split: the named tests of
FILE (a junit classname such as `tests.test_torch_v13`) run as a file of
their own.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path):
    """{file: [(test, seconds)]} in the junit's order."""
    files = collections.OrderedDict()
    for case in ET.parse(path).iter("testcase"):
        files.setdefault(case.get("classname"), []).append(
            (case.get("name"), float(case.get("time"))))
    return files


def replay(files, workers=6):
    """(the replayed end in seconds, {worker: [files]})."""
    queue = collections.deque(sorted(files, key=lambda f: -len(files[f])))
    pending = {w: collections.deque() for w in range(workers)}
    assigned = {w: [] for w in range(workers)}

    def assign(w):
        if queue:
            f = queue.popleft()
            assigned[w].append(f)
            pending[w].extend(t for _, t in files[f])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    clock, end = [(0.0, w) for w in range(workers)], 0.0
    while clock:
        now, w = heapq.heappop(clock)
        if not pending[w]:
            end = max(end, now)
            continue
        done = now + pending[w].popleft()
        if len(pending[w]) <= 2:
            assign(w)
        heapq.heappush(clock, (done, w))
    return end, assigned


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--move", action="append", default=[],
                    help="FILE:TEST[,TEST...]: run these tests as a file of their own")
    args = ap.parse_args()
    files = load(args.junit)
    for spec in args.move:
        src, names = spec.split(":", 1)
        moved = set(names.split(","))
        files[f"{src}_moved"] = [c for c in files[src] if c[0] in moved]
        files[src] = [c for c in files[src] if c[0] not in moved]
    end, assigned = replay(files, args.workers)
    print(f"replayed end: {end:.1f} s")
    for w, names in assigned.items():
        load_s = sum(t for f in names for _, t in files[f])
        print(f"worker {w}: {load_s:.1f} s, last {names[-3:]}")


if __name__ == "__main__":
    main()
