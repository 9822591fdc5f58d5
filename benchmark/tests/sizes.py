"""A cell of the benchmark cut to test sizes, and a run of it on the CPU."""

from __future__ import annotations

# test sizes: every width cut, the DNA and text lengths as published
TINY = {"image": {"image_size": 32, "patch_size": 16, "hidden_size": 128, "num_layers": 2,
                  "num_heads": 2, "mlp_dim": 256},
        "dna": {"hidden_size": 128, "num_layers": 2, "num_heads": 2, "intermediate_size": 256},
        "language": {"hidden_size": 128, "num_layers": 2, "num_heads": 2,
                     "intermediate_size": 256},
        "output_dim": 64}


def tiny_cell(name: str, batch: int = 8):
    """The cell `name` as BENCHMARK.json has it, at test widths and batch."""
    import torch

    from benchmark.core.cell import Cell

    torch.set_num_threads(2)
    cell = Cell(name)
    w = cell.config["widths"]
    for m in ("image", "dna", "language"):
        w[m].update(TINY[m])
    w["output_dim"] = TINY["output_dim"]
    cell.config["train"]["batch_size"] = batch
    cell.traffic["batch_size"] = batch
    cell.checks["block_rows"] = 4
    return cell


def run_tiny(cell, seed: int = 20240611, seconds: float = 0.5, trace: bool = False) -> dict:
    """Everything of a run but the look for a card, on the CPU: the
    driver's result with its checks judged."""
    import torch

    from benchmark.run import execute

    return execute(cell, seed, seconds, trace, torch.device("cpu"), None, apply_widths=True)
