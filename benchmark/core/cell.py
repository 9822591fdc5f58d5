"""A cell of the benchmark, found by name from files alone.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration, traffic mix and chips, and which metrics it reports.  The
rest sits in files named after them under `benchmark/`:

- `configs/<config>.json`: the recipe it runs, its widths and training
  settings as run, and the plain reference beside it
  (`reference/<reference>.py`);
- `traffic/<traffic>.json`: the mix's parameters, and the driver that runs
  it (`drivers/<driver>.py`);
- `checks/<cell>.json`: how the cell's output is compared with the
  reference and the limit of each number compared;
- `metrics/<metric>.py`: one reader a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from its file, named after the file (a metric's name may
    hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    def __init__(self, name: str, spec: Optional[dict] = None, bench: Path = BENCH):
        self.spec = spec if spec is not None else load_json(bench.parent / "BENCHMARK.json")
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            names = [w["name"] for w in self.spec["workloads"]]
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {names})")
        w = found[0]
        self.name, self.chips = name, int(w["chips"])
        self.config = load_json(bench / "configs" / f"{w['config']}.json")
        self.traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
        self.checks = load_json(bench / "checks" / f"{name}.json")
        self.reference = load_module(bench / "reference" / f"{self.config['reference']}.py")
        self.driver = load_module(bench / "drivers" / f"{self.traffic['driver']}.py")
        self.end_to_end: List[dict] = [m for m in self.spec["end_to_end"] if _listed(m, name)]
        self.per_layer: List[dict] = [m for m in self.spec["per_layer"] if _listed(m, name)]
        self.readers: Dict[str, ModuleType] = {
            m["name"]: load_module(bench / "metrics" / f"{m['name']}.py") for m in self.per_layer}

    @property
    def widths(self) -> dict:
        return self.config["widths"]


# where the program's config holds each width of a configuration file:
# {group of `widths`: (prefix of the keys listed, their keys, prefix of the
# rest)}.  A file states `image`, `dna` and `language` for the default
# backbone, or `clip` (the names of the program's `CLIPBackboneConfig`) and
# `dna` for the open_clip backbone, whose CLIP towers take the place of the
# image and text towers.
_WIDTH_PATHS = {
    "image": ("image.vit.", (), "image.vit."),
    "dna": ("dna.", ("tokenizer", "kmer", "stride", "max_bp", "readout"), "dna.bert."),
    "language": ("language.", ("max_len",), "language.bert."),
    "clip": ("clip.", (), "clip."),
}
_TRAIN_PATHS = ("batch_size", "epochs", "amp", "remat", "remat_policy", "disable_lora",
                "accum_steps", "fast_math", "loss.bind_to",
                "loss.no_image_text_loss", "loss.fix_temperature", "loss.local_loss",
                "optim.optimizer", "optim.lr_scheduler", "optim.lr_config.max_lr",
                "optim.lr_config.pct_start", "optim.lr_config.div_factor",
                "optim.lr_config.final_div_factor", "optim.weight_decay", "optim.beta1",
                "optim.beta2", "optim.eps", "optim.base_batch_size", "optim.scale_lr_by_batch",
                "optim.grad_clip_norm")


def config_value(obj, path: str):
    """The program config's value at a dotted path."""
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def is_clip(config: dict) -> bool:
    """Whether a configuration file states the open_clip backbone's widths."""
    return "clip" in config["widths"]


def config_pairs(config: dict) -> Dict[str, object]:
    """Every value of a configuration file under the program config's path."""
    widths = config["widths"]
    if is_clip(config):
        both = sorted({"image", "language"} & set(widths))
        if both:
            raise ValueError(f"{config['name']}: widths state `clip` and {both}; the CLIP "
                             "towers are the image and text towers")
        groups = ("clip", "dna")
    else:
        groups = ("image", "dna", "language")
    out = {}
    for group in groups:
        prefix, listed, rest = _WIDTH_PATHS[group]
        for key, value in widths[group].items():
            out[(prefix if key in listed else rest) + key] = value
    out["output_dim"] = widths["output_dim"]
    for path in _TRAIN_PATHS:
        out[path] = config["train"][path]
    return out


def program_config(config: dict, seed: int, apply: bool = False):
    """The program's GlobalConfig for a configuration file: its recipe as
    the program loads it, run with the run's seed and no checkpoints.  Every
    value the file states must be the recipe's; `apply=True` writes them
    into the config instead (for runs at test sizes).  Either way the
    recipe's `backbone` must be open_clip where the file states `clip`
    widths, and anything else where it does not."""
    from clibd_tpu_torch.config import load_config, set_by_path

    gcfg = load_config(experiment=config["recipe"])
    mc = gcfg.model_config
    mc.default_seed = seed
    gcfg.save_ckpt = False
    bad = []
    if (mc.backbone == "open_clip") != is_clip(config):
        bad.append(f"backbone: recipe {mc.backbone!r}, file "
                   f"{'clip' if is_clip(config) else 'image and language'} widths")
    for path, want in config_pairs(config).items():
        if apply:
            set_by_path(mc, path, want)
        elif config_value(mc, path) != want:
            bad.append(f"{path}: recipe {config_value(mc, path)!r}, file {want!r}")
    if bad:
        raise ValueError(f"{config['recipe']} differs from the configuration file: {bad}")
    return gcfg


def cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    os.environ["CLIBD_KERNEL_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
