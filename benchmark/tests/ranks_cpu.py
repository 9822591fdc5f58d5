"""A cell of several ranks at test sizes on the CPU, over gloo: every rank
runs everything of a run but the look for a card; rank 0 prints the
driver's numbers and checks as one JSON line.

    python3 -m benchmark.tests.ranks_cpu <cell> [fault]

`fault` breaks the timed path underneath on every rank: "no_exchange"
leaves out the exchange between the ranks (each rank's loss over its own
rows, its own gradients kept); "no_grad_exchange" leaves out the
gradients' all-reduce alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

RANKS = 4


def rank_main(name: str, fault: str) -> None:
    import torch

    from benchmark.calibrate import no_exchange, no_grad_exchange
    from benchmark.tests.sizes import run_tiny, tiny_cell

    faults = {"none": contextlib.nullcontext, "no_exchange": no_exchange,
              "no_grad_exchange": no_grad_exchange}
    torch.set_num_threads(1)
    with faults[fault]():
        result = run_tiny(tiny_cell(name), seconds=0.3)
    if os.environ["RANK"] == "0":
        print(json.dumps({"numbers": result["numbers"], "checks": result["checks"],
                          "failed": result["failed"], "window": result["window"]}))


def main(argv) -> int:
    name, fault = argv[0], argv[1] if len(argv) > 1 else "none"
    if "RANK" in os.environ:
        rank_main(name, fault)
        return 0
    from benchmark.core.ranks import free_port

    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.tests.ranks_cpu", name, fault],
                              env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                                       WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1",
                                       MASTER_PORT=port, OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL)
             for r in range(RANKS)]
    out = procs[0].communicate(timeout=600)[0]
    codes = [p.wait(timeout=600) for p in procs]
    sys.stdout.write(out.decode())
    return max(codes)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
