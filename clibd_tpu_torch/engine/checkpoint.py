"""Checkpointing: the port of `clibd_tpu/engine/checkpoint.py` (`:48-258`),
best/last semantics (reference train_cl.py:273-319) with the full training
state -- params, optimizer state and step -- for a true resume.

A checkpoint directory holds:

- `params.npz`: every parameter, fp32, under the JAX package's flat pytree
  keys ("image_encoder/blocks/qkv_w"; the port's parameter names with "/"
  for "."), so a checkpoint the port trains loads in either package
  (`clibd_tpu.models.convert.load_params_npz`, `load_model_any`);
- `meta.json`: {"step", "epoch", ...} as the JAX package writes it (the best
  checkpoint adds "overall_acc");
- `opt_state.npz`: the optimizer state in optax's layout, the flat keys
  and dtypes that the JAX package writes (`_flatten_with_paths` of its
  optax state): per trainable parameter its first and second moments,
  "<adam>mu/<key>" and "<adam>nu/<key>" with <key> the parameter's
  params.npz key, and the update count as int32 under each counting
  transform; frozen parameters have no entry, as optax's MaskedNode leaves
  them.  `optax_keys` says where the Adam state sits in each of the two
  optimizers: `build_optimizer`'s multi_transform of AdamW (behind a
  global-norm clip when one is set) and SimCLR's chain.  So a checkpoint
  resumes in either package.  `load_train_state` also reads the port's
  earlier layout ("<key>/exp_avg", "<key>/exp_avg_sq", "<key>/step").

Writes are atomic per file (write, then rename).  `AsyncCheckpointWriter`
copies the state to host memory on the caller's thread and writes it on a
background thread, so the disk leg overlaps the next steps.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import (clibd_params_from_reference_checkpoint, load_params_npz,
                              load_torch_state_dict, model_from_jax, params_from_jax)


def _key(name: str) -> str:
    return name.replace(".", "/")


def _atomic_npz(path: str, arrays: dict) -> None:
    tmp = path + ".tmp.npz"  # np.savez appends .npz to names without it
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _trainable(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """(name, parameter) of every parameter the optimizer updates."""
    ids = {id(p) for g in optimizer.param_groups for p in g["params"]}
    return [(n, p) for n, p in model.named_parameters() if id(p) in ids]


def optax_keys(optimizer: torch.optim.Optimizer) -> Tuple[str, Tuple[str, ...]]:
    """Where optax keeps this optimizer's state: (the prefix of the Adam
    moments' keys, the keys of the update counts).

    - `engine.train.ScheduledAdamW` is `build_optimizer`'s
      multi_transform({"train": adamw, "frozen": set_to_zero}): adamw is
      chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate),
      so (count, mu, nu) sit at inner_state/0 and the schedule's count at
      inner_state/2; a global-norm clip chains in front and moves both
      under inner_state/1 (the clip's own state has no leaves);
    - `engine.train.ScheduledAdam` is SimCLR's chain(add_decayed_weights,
      scale_by_adam, scale_by_learning_rate): (count, mu, nu) at 1, the
      schedule's count at 2.
    """
    if getattr(optimizer, "optax_chain", None) == "simclr":
        return "1/", ("1/count", "2/count")
    base = "inner_states/train/inner_state/" + ("1/" if optimizer.grad_clip_norm > 0 else "")
    return base + "0/", (base + "0/count", base + "2/count")


def opt_state_to_optax(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> Dict[str, np.ndarray]:
    """The optimizer's state as the JAX package's flat `opt_state.npz`:
    the keys and dtypes of `_flatten_with_paths(optimizer.init(params))`
    for the same config, on the host.  A parameter not updated yet has
    zero moments, as optax's init gives them."""
    adam, counts = optax_keys(optimizer)
    flat = {k: np.asarray(optimizer.update_count(), np.int32) for k in counts}
    for n, p in _trainable(model, optimizer):
        state = optimizer.state.get(p) or {}
        for field, slot in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            v = state.get(field)
            flat[f"{adam}{slot}/{_key(n)}"] = (np.zeros(tuple(p.shape), np.float32) if v is None
                                               else v.detach().float().cpu().numpy())
    return flat


def _set_adam_state(optimizer, p, step: float, exp_avg, exp_avg_sq) -> None:
    optimizer.state[p] = {
        "step": torch.tensor(float(step), dtype=torch.float32),
        "exp_avg": torch.from_numpy(np.asarray(exp_avg)).to(p.device, p.dtype),
        "exp_avg_sq": torch.from_numpy(np.asarray(exp_avg_sq)).to(p.device, p.dtype),
    }


def opt_state_from_optax(flat: Dict[str, np.ndarray], model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> None:
    """Set the optimizer's state from a flat optax state (`opt_state_to_optax`'s
    layout, or the JAX package's `opt_state.npz`); any other key set
    raises, as the JAX package's loader does."""
    adam, counts = optax_keys(optimizer)
    named = _trainable(model, optimizer)
    want = set(counts) | {f"{adam}{slot}/{_key(n)}" for n, _ in named for slot in ("mu", "nu")}
    if set(flat) != want:
        raise ValueError("Optimizer state keys do not match the checkpoint")
    step = int(flat[counts[0]])
    for n, p in named:
        _set_adam_state(optimizer, p, step, flat[f"{adam}mu/{_key(n)}"],
                        flat[f"{adam}nu/{_key(n)}"])


def _host_snapshot(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer]
                   ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """Device → host copies of the params and the optimizer state."""
    params = {_key(n): p.detach().float().cpu().numpy() for n, p in model.named_parameters()}
    return params, None if optimizer is None else opt_state_to_optax(model, optimizer)


def _write_host(directory: str, params: dict, opt: Optional[dict], step: int, epoch: int,
                meta: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    _atomic_npz(os.path.join(directory, "params.npz"), params)
    if opt is not None:
        _atomic_npz(os.path.join(directory, "opt_state.npz"), opt)
    info = {"step": int(step), "epoch": int(epoch)}
    info.update(meta or {})
    tmp = os.path.join(directory, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(info, f, indent=2)
    os.replace(tmp, os.path.join(directory, "meta.json"))


def save_train_state(directory: str, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0,
                     epoch: int = 0, meta: Optional[dict] = None) -> None:
    params, opt = _host_snapshot(model, optimizer)
    _write_host(directory, params, opt, step, epoch, meta)


def load_train_state(directory: str, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """Load params.npz into `model` (strict) and, when `optimizer` is given
    and opt_state.npz exists, the Adam state of every trainable parameter,
    from optax's layout or the port's earlier one (told apart by their
    keys); → meta.json's dict (empty when absent)."""
    state = params_from_jax(load_params_npz(os.path.join(directory, "params.npz")))
    model.load_state_dict(state, strict=True)
    meta: dict = {}
    meta_path = os.path.join(directory, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    opt_path = os.path.join(directory, "opt_state.npz")
    if optimizer is not None and os.path.exists(opt_path):
        with np.load(opt_path) as data:
            flat = {k: data[k] for k in data.files}
        named = _trainable(model, optimizer)
        earlier = {f"{_key(n)}/{f}" for n, _ in named for f in ("exp_avg", "exp_avg_sq", "step")}
        if set(flat) == earlier:  # the port's layout before it wrote optax's
            for n, p in named:
                k = _key(n)
                _set_adam_state(optimizer, p, flat[f"{k}/step"], flat[f"{k}/exp_avg"],
                                flat[f"{k}/exp_avg_sq"])
        else:
            opt_state_from_optax(flat, model, optimizer)
    return meta


def resolve_checkpoint_path(base: str) -> Optional[str]:
    """Reference resolution chain (util/util.py:951-963): exact path → best →
    last, for npz directories and torch .pth files."""
    for cand in (base, os.path.join(base, "best"), os.path.join(base, "last"),
                 os.path.join(base, "best.pth"), os.path.join(base, "last.pth")):
        if os.path.isdir(cand) and os.path.exists(os.path.join(cand, "params.npz")):
            return cand
        if os.path.isfile(cand):
            return cand
    return None


def load_params_any(path: str, cfg=None) -> dict:
    """Params from an npz checkpoint directory, an `.npz`, or a reference
    torch checkpoint (`.pth`/`.pt`/`.tar`, a released `best.pth`, which
    needs the ExperimentConfig) → the JAX package's numpy pytree
    (`clibd_tpu/engine/checkpoint.py:202-215`).  A torch file is unpickled:
    trusted files only."""
    if os.path.isdir(path):
        return load_params_npz(os.path.join(path, "params.npz"))
    if path.endswith(".npz"):
        return load_params_npz(path)
    if path.endswith((".pth", ".pt", ".tar")):
        if cfg is None:
            raise ValueError("Loading a torch checkpoint requires the ExperimentConfig")
        sd = load_torch_state_dict(path)
        sd.pop("__meta__", None)
        return clibd_params_from_reference_checkpoint(sd, cfg)
    raise ValueError(f"Unrecognized checkpoint {path!r}")


def load_model_any(path: str, cfg, device: torch.device | str = "cuda"):
    """`load_params_any` → the `CLIBD` module for `cfg` on `device`
    (`models.convert.model_from_jax`)."""
    return model_from_jax(load_params_any(path, cfg), cfg, device)


class AsyncCheckpointWriter:
    """Overlap checkpoint disk writes with training: the device → host copy
    happens on the caller's thread (the next step updates the parameters in
    place), the serialise + write + rename on a background thread.  A new
    submit to a directory joins its previous write first; `wait()` joins
    every write and re-raises any failure, so a lost checkpoint never looks
    like a saved one."""

    def __init__(self):
        self._pending: Dict[str, threading.Thread] = {}
        self._errors: list = []

    def submit(self, directory: str, model, optimizer, step: int, epoch: int,
               meta: Optional[dict] = None) -> None:
        self.wait(directory)
        params, opt = _host_snapshot(model, optimizer)

        def write():
            try:
                _write_host(directory, params, opt, step, epoch, meta)
            except Exception as e:  # surfaced on the next wait()
                self._errors.append((directory, e))

        # not a daemon: the interpreter joins outstanding writes at exit, so
        # an exception in the training loop cannot tear a checkpoint set
        t = threading.Thread(target=write, daemon=False)
        t.start()
        self._pending[directory] = t

    def wait(self, directory: Optional[str] = None) -> None:
        dirs = [directory] if directory is not None else list(self._pending)
        for d in dirs:
            t = self._pending.pop(d, None)
            if t is not None:
                t.join()
        if self._errors:
            errors, self._errors = self._errors, []
            detail = "; ".join(f"{d!r}: {e!r}" for d, e in errors)
            raise RuntimeError(f"async checkpoint write(s) failed: {detail}") from errors[0][1]


class BestLastCheckpointer:
    """best/last checkpoint pair selected by overall_acc
    (train_cl.py:292-319).  async_writes=True overlaps the disk leg with the
    next epoch; call `wait()` before reading the files back."""

    def __init__(self, directory: str, async_writes: bool = False):
        self.directory = directory
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        self._writer = AsyncCheckpointWriter() if async_writes else None

    def _save(self, subdir, model, optimizer, step, epoch, meta):
        path = os.path.join(self.directory, subdir)
        if self._writer is not None:
            self._writer.submit(path, model, optimizer, step, epoch, meta)
        else:
            save_train_state(path, model, optimizer, step, epoch, meta)

    def save_last(self, model, optimizer, step, epoch, meta=None):
        self._save("last", model, optimizer, step, epoch, meta)

    def maybe_save_best(self, metric: float, model, optimizer, step, epoch, meta=None,
                        save: bool = True) -> bool:
        """Track (and optionally persist) the best state; → whether the
        metric improved (the reference's early-stop signal is `not
        improved`, train_cl.py:304-313)."""
        if self.best_metric is None or metric > self.best_metric:
            self.best_metric = metric
            self.best_epoch = epoch
            if save:
                info = dict(meta or {})
                info["overall_acc"] = metric
                self._save("best", model, optimizer, step, epoch, info)
            return True
        return False

    def wait(self):
        if self._writer is not None:
            self._writer.wait()
