"""Per-test durations of a tier-1 run under pytest-xdist, and their summary.

As a pytest plugin it appends one JSON line per test phase report to the
file named by the `DURLOG` environment variable: the test id, the phase
(setup, call, teardown), its seconds, the outcome, the xdist worker that
ran it (null in a worker's own copy of the report; the controller's copy
names it) and the seconds since the controller started.  Unlike
`--durations`, the log survives a run that the time limit cuts.

    DURLOG=run.jsonl PYTHONPATH=scripts python -m pytest tests/ ... -p tier1_durations
    python scripts/tier1_durations.py run.jsonl [--prefix tests/test_torch_]

The summary prints each worker's busy seconds and the time its last test
ended (a worker holding a chain of long tests shows as the one that ends
last), the setup-plus-call seconds summed over the files whose path starts
with `--prefix`, by file, and the slowest entries.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

_T0 = time.time()


def pytest_runtest_logreport(report):
    node = getattr(report, "node", None)
    with open(os.environ["DURLOG"], "a") as f:
        f.write(json.dumps({"id": report.nodeid, "when": report.when, "dur": report.duration,
                            "outcome": report.outcome,
                            "node": str(node.gateway.id) if node is not None else None,
                            "t": time.time() - _T0}) + "\n")


def load(path: str) -> dict:
    """{(test id, phase): record}, from the controller's records."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["node"] is not None:
                out[(rec["id"], rec["when"])] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log")
    ap.add_argument("--prefix", default="tests/test_torch_")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    recs = load(args.log)
    timed = [r for (_, when), r in recs.items() if when != "teardown"]
    by_node = collections.defaultdict(list)
    for r in timed:
        by_node[r["node"]].append(r)
    for node in sorted(by_node):
        rows = by_node[node]
        print(f"{node}: busy {sum(r['dur'] for r in rows):.1f} s, last test ended at "
              f"{max(r['t'] for r in rows):.1f} s")
    by_file = collections.Counter()
    for r in timed:
        if r["id"].startswith(args.prefix):
            by_file[r["id"].split("::")[0]] += r["dur"]
    print(f"{args.prefix}*: setup + call {sum(by_file.values()):.1f} s")
    for name, dur in by_file.most_common():
        print(f"  {dur:8.1f}  {name}")
    for r in sorted(timed, key=lambda r: -r["dur"])[:args.top]:
        print(f"{r['dur']:8.2f} {r['when']:5s} {r['node']} {r['id']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
