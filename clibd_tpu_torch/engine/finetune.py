"""Supervised fine-tuning engine: the port of `clibd_tpu/engine/finetune.py`
(reference epoch/fine_tuning_epoch.py:11-103 + scripts/BZSL/fine_tune_*.py):
species classification by one encoder (image or DNA) of a CLIBD and a linear
classifier head, top-k eval, on one device.

`FinetuneModel` is the JAX step's params pytree as a module: every module of
the CLIBD under its own name and the head under `classifier`, so that
`save_train_state` writes the layout `clibd_tpu.engine.checkpoint.
load_train_state` reads (`classifier/w` [output_dim, C]).  The trained
encoder is a copy, so the CLIBD it came from is left as it was, as the JAX
package's functional update leaves its params.  The logits are computed in
the config's dtype and cast to fp32; the loss is the mean NLL of their
log_softmax.  AdamW is optax.adamw's (weight decay 1e-4), over the head and,
when it trains, the encoder: every other parameter gets no update and no
decay, as under `optax.multi_transform(..., set_to_zero)`.  A frozen encoder
runs under `torch.no_grad()`, as `stop_gradient` cuts it, so it launches no
backward kernel.  The learning rate may be a schedule, a callable of the
update count (`engine/schedules.py`).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..config.schema import ExperimentConfig
from ..models.clibd import CLIBD, encode_dna, encode_image
from ..models.layers import Linear
from .extract import to_device
from .train import ScheduledAdamW

# the CLIBD's modules (None where the config has no such tower)
_TOWERS = ("image_encoder", "clip_vision", "dna_encoder", "language_encoder", "language_proj",
           "clip_text")
WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch.optim.AdamW's is 1e-2)


def init_classifier_head(generator: torch.Generator, feature_dim: int, num_classes: int) -> Linear:
    """torch nn.Linear's default init, U(±1/sqrt(feature_dim)) for w and b,
    drawn from `generator`."""
    head = Linear(feature_dim, num_classes)
    head.reset_parameters(generator)
    return head


def species_to_index(label_dicts: List[dict], unique_species: List[str]) -> np.ndarray:
    """Reference label_batch_to_species_idx (fine_tuning_epoch.py:6-9)."""
    lookup = {s: i for i, s in enumerate(unique_species)}
    return np.asarray([lookup[l["species"]] for l in label_dicts], dtype=np.int32)


class FinetuneModel(nn.Module):
    """The CLIBD's towers (the trained one a copy), its logit_scale, and a
    classifier head over the `modality` encoder's features."""

    def __init__(self, clibd: CLIBD, cfg: ExperimentConfig, head: Linear, modality: str = "image",
                 train_encoder: bool = True):
        super().__init__()
        if modality not in ("image", "dna"):
            raise ValueError(f"modality must be 'image' or 'dna', got {modality!r}")
        for name in _TOWERS:
            setattr(self, name, getattr(clibd, name))
        self.logit_scale = clibd.logit_scale
        self.cfg = cfg
        self.modality = modality
        self.train_encoder = train_encoder
        self.compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
        enc = f"{modality}_encoder"
        if getattr(self, enc) is None:
            raise ValueError(f"the model has no {enc}")
        if train_encoder:
            setattr(self, enc, copy.deepcopy(getattr(clibd, enc)).requires_grad_(True))
        self.classifier = head

    def trainable_parameters(self) -> List[nn.Parameter]:
        """The head's parameters, then the encoder's when it trains."""
        params = list(self.classifier.parameters())
        if self.train_encoder:
            params += list(getattr(self, f"{self.modality}_encoder").parameters())
        return params

    def _features(self, x):
        encode = encode_image if self.modality == "image" else encode_dna
        return encode(self, self.cfg, x, self.compute_dtype)

    def forward(self, x) -> torch.Tensor:
        """The modality's input batch (device tensors) → fp32 logits [B, C]."""
        if self.train_encoder:
            feats = self._features(x)
        else:
            with torch.no_grad():
                feats = self._features(x)
        return self.classifier(feats, self.compute_dtype).float()

    def predict(self, x) -> torch.Tensor:
        """No-grad forward of a host batch (numpy) → fp32 logits on the
        model's device."""
        with torch.inference_mode():
            return self(to_device(x, self.classifier.w.device))


def nll_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the targets under log_softmax."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(logits.shape[0], device=logits.device), target].mean()


def make_finetune_step(model: FinetuneModel, optimizer: torch.optim.Optimizer) -> Callable:
    """→ step(x, target): one update of the trainable parameters on a batch
    of device tensors; returns the batch's loss (a device scalar)."""

    def step(x, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = nll_loss(model(x), target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit_classifier(
    model: CLIBD,
    cfg: ExperimentConfig,
    loader,
    targets: np.ndarray,
    num_classes: int,
    lr: Union[float, Callable[[int], float]],
    epochs: int,
    modality: str = "image",
    train_encoder: bool = True,
    seed: int = 0,
    verbose: bool = False,
    head: Linear = None,
    step_losses: list = None,
):
    """Shared supervised-classification fit used by `cli finetune` (INSECT,
    fine_tune_*.py) and `cli method-nn --linear --probe full`
    (method_linear.py:458-516): a fresh classifier head (drawn from a
    generator seeded with `seed`, or `head`), AdamW over the trained
    parameters only, a per-epoch batch loop over `loader` (the
    `BioscanLoader` interface; a batch's "index" selects its `targets`).
    `step_losses`, when given, receives each step's loss as it is taken.

    → (FinetuneModel, predict(x) → fp32 logits, per-epoch mean losses)."""
    device = next(model.parameters()).device
    if head is None:
        head = init_classifier_head(torch.Generator().manual_seed(seed), cfg.output_dim,
                                    num_classes)
    ft = FinetuneModel(model, cfg, head.to(device), modality, train_encoder)
    schedule = lr if callable(lr) else (lambda i: lr)
    optimizer = ScheduledAdamW(ft.trainable_parameters(), schedule, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=WEIGHT_DECAY)
    step = make_finetune_step(ft, optimizer)
    targets = np.asarray(targets)
    epoch_losses = []
    for epoch in range(epochs):
        losses = []
        for batch in loader.batches(epoch=epoch):
            target = torch.from_numpy(targets[batch["index"]].astype(np.int64)).to(device)
            losses.append(step(to_device(batch[modality], device), target))
            if step_losses is not None:
                step_losses.append(float(losses[-1]))
        epoch_losses.append(float(np.mean([float(v) for v in losses])))
        if verbose:
            print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f}")
    return ft, ft.predict, epoch_losses


def topk_accuracy(logits: np.ndarray, targets: np.ndarray,
                  k_values: Sequence[int] = (1, 3, 5)) -> Dict[int, float]:
    """Reference evaluate_epoch semantics (fine_tuning_epoch.py:39-103)."""
    order = np.argsort(-logits, axis=1)[:, : max(k_values)]
    out = {}
    for k in k_values:
        out[k] = float((order[:, :k] == targets[:, None]).any(axis=1).mean())
    return out
