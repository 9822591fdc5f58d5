"""A cell of the benchmark cut to test sizes, and a run of it on the CPU."""

from __future__ import annotations

# test sizes: every width cut, the DNA and text lengths as published
TINY = {"image": {"image_size": 32, "patch_size": 16, "hidden_size": 128, "num_layers": 2,
                  "num_heads": 2, "mlp_dim": 256},
        "dna": {"hidden_size": 128, "num_layers": 2, "num_heads": 2, "intermediate_size": 256},
        "language": {"hidden_size": 128, "num_layers": 2, "num_heads": 2,
                     "intermediate_size": 256},
        "output_dim": 64}

# a configuration of the open_clip backbone: the reference's OpenCLIP
# ablation with the CLIP towers at the schema's ViT-L/14 widths beside
# flagship's BarcodeBERT, and the recipe's own training settings
OPEN_CLIP_RECIPE = "for_bioscan_1m/ablation_with_open_clip/with_open_clip.yaml"
VIT_L14 = {"image_size": 224, "patch_size": 14, "vision_hidden": 1024, "vision_layers": 24,
           "vision_heads": 16, "vision_mlp": 4096, "vocab_size": 49408, "context_length": 77,
           "text_hidden": 768, "text_layers": 12, "text_heads": 12, "text_mlp": 3072,
           "embed_dim": 768, "activation": "gelu"}
OPEN_CLIP_TRAIN = {"batch_size": 200, "epochs": 15, "loss.fix_temperature": True}
# its test sizes: vision N = (28/14)² + 1 = 5, text N = 8
TINY_CLIP = {"image_size": 28, "patch_size": 14, "vision_hidden": 128, "vision_layers": 2,
             "vision_heads": 2, "vision_mlp": 256, "vocab_size": 1000, "context_length": 8,
             "text_hidden": 128, "text_layers": 2, "text_heads": 2, "text_mlp": 256,
             "embed_dim": 64}


def open_clip_config(clip: dict = VIT_L14, tiny: bool = False) -> dict:
    """A configuration file of the open_clip backbone, built from flagship's:
    `clip` widths in place of `image` and `language`, the recipe's training
    settings; `tiny` cuts BarcodeBERT and the output to test widths."""
    import copy

    from benchmark.core.cell import BENCH, load_json

    config = copy.deepcopy(load_json(BENCH / "configs" / "flagship.json"))
    config.update(name="open_clip", recipe=OPEN_CLIP_RECIPE)
    w = config["widths"]
    del w["image"], w["language"]
    w["clip"] = dict(clip)
    if tiny:
        w["dna"].update(TINY["dna"])
        w["output_dim"] = TINY["output_dim"]
    config["train"].update(OPEN_CLIP_TRAIN)
    return config


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
