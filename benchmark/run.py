"""Run one cell of the benchmark of `clibd_tpu_torch` on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, checks and per-layer readers are
found by name from `BENCHMARK.json` and the files under `benchmark/`
(`benchmark/core/cell.py`).  Set-up runs from the start of the process to
the start of the window; the window measures for `--seconds` over whole
steps or batches; then the program's output is compared with the plain
reference.  With `--trace 1` a fixed number of the window's steps or
batches is traced and the per-layer metrics are read from the trace.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit; the same numbers
end standard error.  Without a CUDA card, with fewer cards than the cell
asks for, without the program beside it, or with JAX loaded once the
window has closed, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The wall-clock time this process started, from /proc; now where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "clibd_tpu")


class Context:
    """What a driver is given: the cell, the seed, the window's length,
    whether to trace, the device, the ranks, the process's start, the
    card's peaks and a scratch directory under TMPDIR."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                 peaks, scratch: str, apply_widths: bool = False):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_start, self.peaks, self.scratch = device, t_start, peaks, scratch
        self.apply_widths = apply_widths
        self.rank, self.world, self.group = 0, 1, None
        self.phases = {}

    def mark(self, phase: str) -> None:
        """Note the seconds since the process started at the end of a phase."""
        self.phases[phase] = round(time.time() - self.t_start, 3)

    def program_config(self):
        from benchmark.core.cell import program_config

        return program_config(self.cell.config, self.seed, apply=self.apply_widths)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def card(chips: int) -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    limits = [line.split(",")[-1].strip() for line in smi.stdout.strip().splitlines()]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": limits[:chips]}


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool, device, peaks,
            apply_widths: bool = False) -> dict:
    """Run the cell's driver; → the driver's result with `checks` judged."""
    from benchmark.core.cell import cache_dirs
    from benchmark.core.compare import judge

    from benchmark.core.ranks import T_START_ENV, is_rank, rank_env

    cache_dirs()
    with tempfile.TemporaryDirectory(prefix="bench_") as scratch:
        ctx = Context(cell, seed, seconds, trace, device, T_START, peaks, scratch, apply_widths)
        if is_rank():
            ctx.rank, ctx.world = rank_env()["rank"], rank_env()["world"]
            ctx.t_start = float(os.environ.get(T_START_ENV, T_START))
        result = cell.driver.run(ctx)
        result["phases"] = ctx.phases
    result["checks"] = judge(result["numbers"], cell.checks["limits"])
    return result


def result_line(cell, result: dict, trace: bool, device: dict) -> dict:
    metrics = {}
    if trace:
        reading = result["reading"]
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(reading) if reading is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if reading is not None:
            device = dict(device, busy_s=reading.busy_s, window_s=reading.window_s)
    else:
        for m in cell.end_to_end:
            if m["name"] in result["e2e"]:
                metrics[m["name"]] = {"value": result["e2e"][m["name"]], "unit": m["unit"]}
    line = {"correct": all(c["ok"] for c in result["checks"].values()) and not result["failed"],
            "attempted": result["attempted"], "failed": result["failed"], "metrics": metrics,
            "device": dict(device, memory_peak_bytes=result["memory_peak_bytes"])}
    if trace and result["reading"] is not None:
        line["breakdown"] = result["reading"].breakdown()
    line["checks"] = result["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.core.cell import Cell
    from benchmark.core.peaks import peaks_for
    from benchmark.core.ranks import is_rank, launch, rank_env

    cell = Cell(args.workload)
    import torch

    t_import = time.time() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and not is_rank():
        return launch(os.path.abspath(__file__),
                      list(argv if argv is not None else sys.argv[1:]), cell.chips, T_START,
                      loaded_forbidden)
    rank = rank_env()["local_rank"] if is_rank() else 0
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dev = card(cell.chips)
    result = execute(cell, args.seed % 2 ** 63, args.seconds, bool(args.trace), device,
                     peaks_for(dev["kind"]))
    result["phases"]["torch imported"] = round(t_import, 3)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    if rank:
        return 0
    line = result_line(cell, result, bool(args.trace), dev)
    print(f"window: {json.dumps(result['window'])}", file=sys.stderr)
    print(f"phases (s since start): {json.dumps(result['phases'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
