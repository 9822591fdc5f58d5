"""A cell on several cards: one rank a card, each a process of `run.py`.

The process started by the command launches the ranks with torchrun's
environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a
free local port) and its own start time, so that rank 0's `setup_s` counts
from the command's start.  It waits for every rank, stops them all if one
fails, and passes rank 0's standard error and its last line on.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List

T_START_ENV = "CLIBD_BENCH_T_START"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_rank() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_env() -> dict:
    """This rank's place: rank, world, the address of rank 0."""
    return {"rank": int(os.environ["RANK"]), "world": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
            "addr": os.environ["MASTER_ADDR"], "port": int(os.environ["MASTER_PORT"])}


def launch(script: str, argv: List[str], chips: int, t_start: float,
           forbidden: Callable[[], list], timeout_s: float = 350.0) -> int:
    """Run `script argv` as `chips` ranks; → 0 with rank 0's result passed
    on, or another code where any rank failed or where `forbidden()` names
    JAX modules loaded in this process, which prints the result; then no
    result is printed."""
    port = free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        for r in range(chips):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(chips),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       **{T_START_ENV: repr(t_start)})
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, script, *argv], env=env,
                                          stdout=out, stderr=err))
        deadline = time.time() + timeout_s
        failed = False
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode not in (None, 0) for p in procs):
                failed = True
                break
            time.sleep(0.5)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        codes = [p.returncode for p in procs]
        failed = failed or any(codes)
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if failed:
        for r, (_, err) in enumerate(texts):
            print(f"--- rank {r} exit {codes[r]}:\n{err[-3000:]}", file=sys.stderr)
        return 1
    found = forbidden()
    if found:
        print(f"benchmark: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    out0, err0 = texts[0]
    sys.stderr.write(err0)
    sys.stderr.flush()
    lines = out0.strip().splitlines()
    if not lines:
        return 1
    print(lines[-1], flush=True)
    return 0
