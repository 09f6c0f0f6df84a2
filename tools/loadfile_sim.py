"""Replays pytest-xdist's ``--dist loadfile`` schedule from measured test
durations, to see which worker runs which test file and when it ends.

    python tools/loadfile_sim.py run.xml collected.txt [-n 6] [--drop FILE ...]

``run.xml`` is a junit file of a full run (its per-test times);
``collected.txt`` is ``pytest --collect-only -q`` output (one node id a
line, in collection order).  The replay follows xdist 3's
LoadScopeScheduling: files sorted by their number of tests (largest
first, ties in collection order), one file to each worker, then a worker
takes the next file whenever two or fewer of its tests are left.
``--drop`` leaves files out (what the schedule would be without them).
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def durations(junit: str) -> dict:
    out = {}
    for tc in ET.parse(junit).getroot().iter("testcase"):
        parts = tc.get("classname").split(".")
        nodeid = "::".join(["/".join(parts[:2]) + ".py", *parts[2:],
                            tc.get("name")])
        out[nodeid] = float(tc.get("time"))
    return out


def files_of(collected, times) -> dict:
    files: dict = collections.OrderedDict()
    for nodeid in collected:
        files.setdefault(nodeid.split("::")[0], []).append(
            times.get(nodeid, 0.0))
    return files


def simulate(files: dict, workers: int = 6):
    """(end second of each worker, the files each worker ran)."""
    queue = collections.deque(sorted(files, key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    assigned = [[] for _ in range(workers)]

    def take(w):
        f = queue.popleft()
        assigned[w].append(f)
        pending[w].extend(files[f])

    for w in range(workers):
        take(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            take(w)
    heap = [(pending[w][0], w) for w in range(workers) if pending[w]]
    heapq.heapify(heap)
    ends = [0.0] * workers
    while heap:
        t, w = heapq.heappop(heap)
        pending[w].popleft()
        if queue and len(pending[w]) <= 2:
            take(w)
        if pending[w]:
            heapq.heappush(heap, (t + pending[w][0], w))
        else:
            ends[w] = t
    return ends, assigned


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("junit")
    parser.add_argument("collected")
    parser.add_argument("-n", type=int, default=6)
    parser.add_argument("--drop", nargs="*", default=[])
    args = parser.parse_args(argv)
    with open(args.collected) as f:
        collected = [ln.strip() for ln in f if "::" in ln]
    files = files_of(collected, durations(args.junit))
    for f in args.drop:
        files.pop(f, None)
    ends, assigned = simulate(files, args.n)
    for w, (end, fs) in enumerate(zip(ends, assigned)):
        print(f"worker {w}: ends at {end:.0f} s: "
              + ", ".join(f"{f.split('/')[-1]} ({sum(files[f]):.0f} s)"
                          for f in fs))
    print(f"wall {max(ends):.0f} s")


if __name__ == "__main__":
    main()
