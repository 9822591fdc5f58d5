"""SimCLR pretraining of the image encoder alone: the port of
`clibd_tpu/engine/simclr.py` (`TwoViewLoader`, `make_simclr_step`,
`SimCLRTrainer`, `:33-229`; reference util/simclr.py:50-168 and
scripts/unimodel/unimodel_training_for_image_encoder.py).

Two views of each image: the host pipeline makes two independent random
crops of one decode (`BatchSpec(two_view=True)`), the device applies the
colour tail (flip, jitter, grayscale, blur; `ops/color.py`), the
full-trainable ViT-B/16 with its `output_dim` head and no LoRA encodes the
stacked [2B] views (so the attention kernels run at batch 2B), and the
NT-Xent loss with in-batch negatives is taken at the given temperature.
No remat, as in the JAX step.  The optimizer is the reference's torch Adam
with L2 weight decay (`engine/train.py::ScheduledAdam`), its learning rate
cosine-annealed per epoch from epoch 2 with T_max the steps of an epoch
(the reference's units quirk).

Data parallel, one rank a card (`make_simclr_step(mesh=)`,
`SimCLRTrainer(mesh=)`, `clibd_tpu/engine/simclr.py:86-107`): each rank
takes the NT-Xent of its own `batch_size` images with local negatives (the
reference never gathers SimCLR features), its augmentation drawn from
`fold_in(generator, rank)`; the gradients are summed over the ranks and the
loss averaged, as the JAX package's `psum` and `pmean` do (DDP would
average the gradients: a deviation of the JAX package that the port keeps,
ROADMAP.md Queue 3).  Only rank 0 writes checkpoints.

Checkpoints: `checkpoint_{epoch:04d}/` every epoch and `model_best/` at the
lowest epoch loss, the ViT's params under the JAX package's keys and the
optimizer state in the SimCLR chain's optax layout (`engine/checkpoint.py`),
which `models.clibd.load_simclr_vit_backbone` reads.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import ExperimentConfig, GlobalConfig
from ..models.clibd import dequantize_image
from ..models.vit import ViT
from ..ops.color import simclr_augment
from ..ops.loss import simclr_loss
from .checkpoint import save_train_state
from ..parallel.mesh import Mesh, all_reduce_grads, all_reduce_mean, create_mesh
from .extract import to_device
from .train import ScheduledAdam, batch_generator, fold_in


class TwoViewLoader:
    """Batches of two independently cropped views of each image, decoded
    once (reference DatasetForSimCLRStyleTraining, util/dataset.py:328-367),
    as (view1, view2, index).  `loader`: a loader already made whose batches
    carry "image" and "image2" (`data.SyntheticSplit(two_view=True)`), in
    place of the HDF5 one."""

    def __init__(self, path: Optional[str], split: str, batch_size: int, num_workers: int = 2,
                 seed: int = 0, use_native: bool = False, loader=None, host_id: int = 0,
                 num_hosts: int = 1):
        if loader is None:
            from ..data.pipeline import BatchSpec, BioscanLoader

            spec = BatchSpec(batch_size=batch_size, train=True, with_dna=False,
                             with_language=False, two_view=True)
            loader = BioscanLoader(path, split, spec, num_workers=num_workers, seed=seed,
                                   use_native=use_native, host_id=host_id,
                                   num_hosts=num_hosts)
        self.a = loader

    def __len__(self):
        return len(self.a)

    def batches(self, epoch: int):
        for batch in self.a.batches(epoch=epoch, shuffle=True):
            yield batch["image"], batch["image2"], batch["index"]

    def close(self):
        self.a.close()


def make_simclr_loss_fn(cfg: ExperimentConfig, model: ViT, temperature: float = 0.07) -> Callable:
    """→ loss_fn(view1, view2, generator): the NT-Xent loss of the two
    augmented views, differentiable in the ViT's parameters."""
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    size = cfg.image.vit.image_size

    def loss_fn(view1: torch.Tensor, view2: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        v1 = simclr_augment(generator, dequantize_image(view1), size=size)
        v2 = simclr_augment(generator, dequantize_image(view2), size=size)
        return simclr_loss(model(torch.cat([v1, v2]), compute_dtype=compute_dtype), temperature)

    return loss_fn


def make_simclr_grad_fn(cfg: ExperimentConfig, model: ViT, temperature: float = 0.07,
                        mesh: Optional[Mesh] = None) -> Callable:
    """→ grad_fn(view1, view2, generator) → the loss, its gradients in the
    parameters' `.grad`.  With a process group: this rank's views, the
    generator folded with the rank, the gradients summed over the ranks
    (`psum`) and the loss averaged (`pmean`); with one rank the plain
    step, as the JAX package's at mesh size 1."""
    loss_fn = make_simclr_loss_fn(cfg, model, temperature)
    if mesh is None or mesh.group is None or mesh.size == 1:
        def grad_fn(view1, view2, generator):
            loss = loss_fn(view1, view2, generator)
            loss.backward()
            return loss.detach()

        return grad_fn
    params = list(model.parameters())

    def sharded_grad_fn(view1, view2, generator):
        loss = loss_fn(view1, view2, fold_in(generator, mesh.rank))
        loss.backward()
        all_reduce_grads(params, "sum", mesh.group)
        return all_reduce_mean(loss, mesh.group)

    return sharded_grad_fn


def make_simclr_step(cfg: ExperimentConfig, model: ViT, optimizer: torch.optim.Optimizer,
                     temperature: float = 0.07, mesh: Optional[Mesh] = None) -> Callable:
    """→ step(view1, view2, generator) → the loss as a device tensor; the
    parameters are updated in place.  mesh: a rank's mesh for the data-
    parallel step (`make_simclr_grad_fn`)."""
    grad_fn = make_simclr_grad_fn(cfg, model, temperature, mesh)

    def step(view1, view2, generator):
        optimizer.zero_grad(set_to_none=True)
        loss = grad_fn(view1, view2, generator)
        optimizer.step()
        return loss

    return step


def epoch_cosine(lr: float, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's schedule: CosineAnnealingLR(T_max=steps per epoch)
    stepped once an epoch from epoch 2, so the i-th update runs at
    lr * (1 + cos(pi * max(epoch - 2, 0) / T_max)) / 2."""
    def schedule(step: int) -> float:
        k = max(step // steps_per_epoch - 2, 0)
        return lr * 0.5 * (1.0 + math.cos(math.pi * k / steps_per_epoch))

    return schedule


class SimCLRTrainer:
    def __init__(
        self,
        global_cfg: GlobalConfig,
        hdf5_path: Optional[str],
        output_dir: str,
        split: str = "no_split_and_seen_train",
        temperature: float = 0.07,
        lr: Optional[float] = None,
        weight_decay: Optional[float] = None,
        num_workers: int = 2,
        model: Optional[ViT] = None,
        log_fn: Optional[Callable] = None,
        loader=None,
        device: torch.device | str = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        """loader: a `TwoViewLoader` (or any loader yielding (view1, view2,
        index)) in place of the HDF5 one; under a process group it yields
        this rank's share.  mesh: default `create_mesh(device=device)`;
        under a group the step is the data-parallel one, `batch_size`
        images a rank."""
        self.gcfg = global_cfg
        self.cfg = cfg = global_cfg.model_config
        self.output_dir = output_dir
        self.mesh = mesh if mesh is not None else create_mesh(device=device)
        if self.mesh.group is None and len(self.mesh.devices) > 1:
            raise ValueError("SimCLR trains on one card a process: start a rank a card "
                             "(torchrun) instead of a list of devices")
        self.device = self.mesh.device
        self.is_main = self.mesh.rank == 0
        self.log_fn = log_fn or (lambda d: None)
        self.loader = loader if loader is not None else TwoViewLoader(
            hdf5_path, split, cfg.batch_size, num_workers=num_workers, seed=cfg.default_seed,
            use_native=global_cfg.pipeline.use_native_decoder, host_id=self.mesh.rank,
            num_hosts=self.mesh.size)
        if model is None:
            # the whole ViT trains: no LoRA, its output_dim head kept as the
            # projection (reference simple_clip.py:64-72)
            model = ViT(cfg.image.vit, output_dim=cfg.output_dim, lora_rank=0)
            model.reset_parameters(torch.Generator().manual_seed(cfg.default_seed))
            model = model.to(self.device)
        self.model = model
        lr = cfg.optim.lr_config.lr if lr is None else lr
        weight_decay = cfg.optim.weight_decay if weight_decay is None else weight_decay
        self.schedule = epoch_cosine(lr, max(len(self.loader), 1))
        self.optimizer = ScheduledAdam(model.parameters(), self.schedule,
                                       weight_decay=weight_decay)
        self.step_fn = make_simclr_step(cfg, model, self.optimizer, temperature, self.mesh)

    def fit(self, progress: bool = False) -> dict:
        best_loss = None
        history = {"loss": []}
        for epoch in range(self.cfg.epochs):
            losses = []
            pending = None  # one-step-delayed loss fetch (the train loop's)
            for i, (view1, view2, _idx) in enumerate(self.loader.batches(epoch)):
                views = to_device({"v1": view1, "v2": view2}, self.device)
                gen = batch_generator(self.device, self.cfg.default_seed, epoch, i)
                loss = self.step_fn(views["v1"], views["v2"], gen)
                if pending is not None:
                    losses.append(float(pending))
                    self.log_fn({"loss": losses[-1], "epoch": epoch})
                pending = loss
            if pending is not None:
                losses.append(float(pending))
                self.log_fn({"loss": losses[-1], "epoch": epoch})
            mean_loss = float(np.mean(losses)) if losses else 0.0
            history["loss"].append(mean_loss)
            if progress:
                print(f"SimCLR epoch {epoch}: loss {mean_loss:.4f}")
            if self.gcfg.save_ckpt and self.is_main:
                step = self.optimizer.update_count()
                save_train_state(os.path.join(self.output_dir, f"checkpoint_{epoch:04d}"),
                                 self.model, self.optimizer, step=step, epoch=epoch)
                if best_loss is None or mean_loss < best_loss:
                    best_loss = mean_loss
                    save_train_state(os.path.join(self.output_dir, "model_best"), self.model,
                                     self.optimizer, step=step, epoch=epoch,
                                     meta={"loss": mean_loss})
        return history

    def close(self):
        self.loader.close()
