"""Shared CLI plumbing: the port of `clibd_tpu/cli/common.py` (dataset path,
checkpoint resolution chain, extraction of one split), one process or one
rank of a group under torchrun."""

from __future__ import annotations

import os
import time
from typing import List

import torch

from ..config import GlobalConfig, load_config
from ..engine.checkpoint import load_model_any, resolve_checkpoint_path


def _dataset_hdf5_path(cfg: GlobalConfig) -> str:
    name = cfg.model_config.dataset
    if name == "bioscan_5m":
        if cfg.model_config.train_with_small_subset:
            return cfg.bioscan_5m_data.path_to_smaller_hdf5_data
        return cfg.bioscan_5m_data.path_to_hdf5_data
    return cfg.bioscan_data.path_to_hdf5_data


def _load_cfg(args, overrides) -> GlobalConfig:
    return load_config(global_yaml=args.global_config, experiment=args.experiment,
                       overrides=overrides)


def _checkpoint_candidates(cfg: GlobalConfig) -> List[str]:
    """The checkpoint search chain, in order: configured path, where
    training saves, the canonical published tree."""
    mc = cfg.model_config
    candidates = [mc.ckpt_path] if mc.ckpt_path else []
    candidates.append(os.path.join(cfg.model_output_dir, mc.model_output_name))
    candidates.append(os.path.join(cfg.project_root_path, "ckpt", "bioscan_clip", cfg.version,
                                   mc.dataset, mc.model_output_name))
    return candidates


def _resolve_params(cfg: GlobalConfig, device: torch.device):
    """Checkpoint chain (reference simple_clip.py:248-285) → CLIBD module on
    `device`: npz params as the JAX package writes them or a reference torch
    checkpoint (a released `best.pth`), else a fresh init from a generator
    seeded with `default_seed`.  The Hugging Face download of the JAX
    package's chain needs the network and is left out.

    Under a process group every rank resolves the chain on its own disk,
    then takes rank 0's weights (`clibd_tpu/cli/common.py:30-46`): a chain
    that resolves differently on another rank's disk would otherwise have
    the ranks' shards of a split encoded by different weights."""
    from ..parallel.mesh import broadcast_from_main, num_hosts

    model = _resolve_params_local(cfg, device)
    if num_hosts() > 1:
        state = broadcast_from_main(model.state_dict())
        model.load_state_dict(state)
    return model


def _resolve_params_local(cfg: GlobalConfig, device: torch.device):
    from ..models.clibd import init_clibd_model

    mc = cfg.model_config
    if mc.load_ckpt:
        for cand in _checkpoint_candidates(cfg):
            resolved = resolve_checkpoint_path(cand)
            if resolved is None:
                continue
            print(f"Loading checkpoint: {resolved}")
            t0 = time.perf_counter()
            model = load_model_any(resolved, mc, device)
            n = sum(p.numel() for p in model.parameters())
            print(f"Imported {n / 1e6:.1f} M parameters ({n * 4 / 1e9:.3f} GB fp32) "
                  f"onto {device} in {time.perf_counter() - t0:.2f} s")
            return model
    print("No checkpoint found/requested — using fresh init")
    return init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)


def _extract_split_auto(model, mc, cfg, hdf5, split, spec, for_key=False, progress=False):
    """One split through the plain loader; under a group of W > 1 ranks each
    rank encodes its share and every rank gets the whole split's dict
    (`extract_split_multihost`)."""
    from ..data.pipeline import BioscanLoader
    from ..engine.extract import extract_split, extract_split_multihost
    from ..parallel.mesh import create_mesh, num_hosts

    if num_hosts() > 1:
        return extract_split_multihost(
            model, mc, hdf5, split, spec, for_key_set=for_key,
            num_workers=cfg.pipeline.num_workers, use_native=cfg.pipeline.use_native_decoder,
            progress=progress, mesh=create_mesh(device=next(model.parameters()).device))

    loader = BioscanLoader(hdf5, split, spec, num_workers=cfg.pipeline.num_workers,
                           use_native=cfg.pipeline.use_native_decoder)
    try:
        return extract_split(model, mc, loader, for_key_set=for_key, progress=progress)
    finally:
        loader.close()
