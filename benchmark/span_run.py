"""Run one cell as `run.py` does, with the program's spans recorded over the
traced window, and print the span readings.

    python3 benchmark/span_run.py --workload <cell> --seed <n> --seconds <s> --trace 1

`run.py`'s trace session does not record the program's spans yet, so no
metric of `BENCHMARK.json` reads them.  This runner puts
`core/spans.SpanSession` in its place (the drivers take the session class
from `core/trace` when a cell loads them), then runs `run.py`'s `main`.
Standard output is `run.py`'s, last line included; standard error holds
one line `spans: {...}` before the checks: every span reading of the cell's kind (None
where the program records no spans: a tree before its recorder), and
`unowned`, the traced window's device operations that no span launched
(name: count).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import benchmark.run as run
    from benchmark.core import spans, trace

    trace.TraceSession = spans.SpanSession
    line_of = run.result_line

    def result_line(cell, result, traced, device):
        line = line_of(cell, result, traced, device)
        reading = result["reading"]
        if traced and reading is not None:
            found = spans.index(reading)
            unowned = found.unowned(spans.window(reading, found)) if found else None
            print(f"spans: {json.dumps(dict(spans.readings(reading), unowned=unowned))}",
                  file=sys.stderr)
        return line

    run.result_line = result_line
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
