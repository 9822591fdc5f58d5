# A copy of clibd_tpu/config/loader.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""YAML config loading with dotted CLI overrides.

Replaces the reference's Hydra composition (`@hydra.main(config_path=...,
config_name="global_config")`, scripts/train_cl.py:348) with a small explicit
loader: `load_config(global_yaml, experiment_yaml, overrides)`.

Experiment YAMLs live in clibd_tpu/config/configs/ and merge into
`GlobalConfig.model_config`.  The port reads that YAML tree by path (it is
data, not an import), so both packages resolve the same experiment names.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import yaml

from .schema import GlobalConfig, _merge_into, set_by_path

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "clibd_tpu", "config", "configs")


def _interpolate(data, root):
    """Resolve `${a.b}`-style references against the root dict (subset of
    OmegaConf interpolation used by the reference's global_config.yaml)."""
    if isinstance(data, dict):
        return {k: _interpolate(v, root) for k, v in data.items()}
    if isinstance(data, list):
        return [_interpolate(v, root) for v in data]
    if isinstance(data, str) and "${" in data:
        out = data
        # bounded: a self-referential value (`dir: ${dir}/x`) or a reference
        # chain longer than this is a config error, not an infinite loop
        for _ in range(32):
            if "${" not in out:
                break
            start = out.index("${")
            end = out.find("}", start)
            if end < 0:
                raise ValueError(f"unterminated ${{...}} interpolation in {data!r}")
            path = out[start + 2 : end]
            node = root
            try:
                for part in path.split("."):
                    node = node[part]
            except (KeyError, TypeError) as e:
                raise KeyError(
                    f"interpolation ${{{path}}} in {data!r} references an unknown key"
                ) from e
            out = out[:start] + str(node) + out[end + 1 :]
        else:
            raise ValueError(
                f"interpolation did not converge for {data!r} (self-referential?)")
        return out
    return data


def resolve_config_path(name: str) -> str:
    """Resolve an experiment config by name or path."""
    if os.path.exists(name):
        return name
    for cand in (
        os.path.join(_CONFIG_DIR, name),
        os.path.join(_CONFIG_DIR, name + ".yaml"),
    ):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"Config {name!r} not found (searched {_CONFIG_DIR})")


def available_configs() -> list:
    out = []
    for root, _dirs, files in os.walk(_CONFIG_DIR):
        for f in files:
            if f.endswith(".yaml"):
                out.append(os.path.relpath(os.path.join(root, f), _CONFIG_DIR))
    return sorted(out)


def load_config(
    global_yaml: Optional[str] = None,
    experiment: Optional[str] = None,
    overrides: Sequence[str] = (),
) -> GlobalConfig:
    cfg = GlobalConfig()
    if global_yaml:
        with open(global_yaml) as f:
            data = yaml.safe_load(f) or {}
        data = _interpolate(data, data)
        _merge_into(cfg, data)
    if experiment:
        with open(resolve_config_path(experiment)) as f:
            data = yaml.safe_load(f) or {}
        # experiment values may reference their own keys OR global-config
        # keys (Hydra resolves both); own keys take precedence
        from .schema import to_dict

        root = dict(to_dict(cfg))
        root.update(data)
        data = _interpolate(data, root)
        _merge_into(cfg.model_config, data)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must be key.path=value")
        key, value = ov.split("=", 1)
        try:
            value = yaml.safe_load(value)
        except yaml.YAMLError:
            pass
        set_by_path(cfg, key, value)
    return cfg


def save_config(cfg: GlobalConfig, path: str) -> None:
    from .schema import to_dict

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
