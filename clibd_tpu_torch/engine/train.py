"""Contrastive trainer: the port of `clibd_tpu/engine/train.py` (reference
scripts/train_cl.py:145-369, epoch/train_epoch.py:9-81).

One train step: uint8 images → [0, 1] → compute dtype → device-side
augmentation (flips and rotation; the host pipeline decodes, resizes and
crops), the tri-encoder forward in bf16 with the blocks rematerialised as
`cfg.remat` / `cfg.remat_policy` ask, the batch's multi-positive InfoNCE,
the backward (through the attention kernels on the card), and AdamW on the
trainable parameters with the LR schedule stepped per update.  The epoch
loop evaluates every `evaluation_period` epochs through the retrieval grid,
keeps best/last checkpoints by overall_acc, stops early on no improvement,
and resumes from a checkpoint, mid-epoch included.

With `accum_steps` k > 1 a step is the gradient cache
(`make_train_step_accum`): the exact full-batch loss and gradients with the
activations of one microbatch of B/k at a time.  The optimizer state is
checkpointed in optax's layout (`engine/checkpoint.py`), so a run resumes
in either package.  The trainer takes any loader with the `BioscanLoader`
interface, the INSECT one (`data/insect.py`) included.

Data parallel, one rank a card (`parallel/mesh.py`): under a process group
of W ranks, `Trainer(mesh=...)` runs `make_train_step_shard_map`, the
counterpart of the JAX package's shard_map step: each rank encodes its
share of the global batch (`batch_size` rows: the batch size is per device,
as in the reference), `ops.loss.sharded_clip_loss` gathers the features
with gradients, and the parameters' gradients are averaged over the ranks
before the update, which is then that of `make_train_step` on the global
batch.  With `accum_steps` k > 1 the ranks run the gradient cache across
ranks (`make_train_step_accum(mesh=...)`): each rank's k microbatches, the
features gathered for the global batch's loss, the gradients averaged as
above; only `step_impl: shard_map` refuses it, as the JAX package does.
Only rank 0 writes checkpoints; `resume_multihost` loads on rank 0
and broadcasts; the in-training eval shards each split over the ranks
(`engine.extract.extract_split_multihost`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config.schema import ExperimentConfig, GlobalConfig
from ..models.clibd import clibd_apply, dequantize_image, init_clibd_model
from ..ops.augment import train_augment
from ..ops.loss import MODALITY_ORDER, clip_loss, sharded_clip_loss
from ..parallel.mesh import (Mesh, all_hosts_agree, all_reduce_grads, broadcast_from_main,
                             create_mesh, mesh_is_multiprocess)
from ..utils.profiling import StepTimer, loop_units, span
from .checkpoint import (BestLastCheckpointer, load_train_state, opt_state_from_optax,
                         opt_state_to_optax)
from .evaluate import compute_overall_acc, convert_acc_dict_to_wandb_dict, inference_and_eval
from .extract import extract_split, extract_split_multihost, to_device
from .schedules import build_schedule


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: scale every gradient by
    max_norm / ||g|| when the global norm ||g|| exceeds max_norm.  Stays on
    the device (no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float())
                                                 for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class _Scheduled:
    """An Adam whose i-th update (0-based, the count optax keeps) runs at
    `schedule(i)`, after an optional global-norm clip of the gradients.  The
    count is read from Adam's own per-parameter step, so it comes back with
    the optimizer state on resume."""

    def __init__(self, params, schedule: Callable[[int], float], grad_clip_norm: float = 0.0,
                 **adam_kwargs):
        super().__init__(params, lr=float(schedule(0)), **adam_kwargs)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm

    def update_count(self) -> int:
        return max((int(s["step"]) for s in self.state.values() if "step" in s), default=0)

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip_norm > 0:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = float(self.schedule(self.update_count()))
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


class ScheduledAdamW(_Scheduled, torch.optim.AdamW):
    """`build_optimizer`'s optax.adamw (decoupled weight decay)."""

    optax_chain = "adamw"


class ScheduledAdam(_Scheduled, torch.optim.Adam):
    """SimCLR's chain(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate): torch Adam's `weight_decay` adds the decay to
    the gradient before the moments, as add_decayed_weights does."""

    optax_chain = "simclr"


def build_optimizer(cfg: ExperimentConfig, model: torch.nn.Module,
                    schedule: Callable[[int], float]) -> ScheduledAdamW:
    """AdamW over the trainable parameters only (`requires_grad`, set by
    `set_trainable`), as the JAX package's masked optax.adamw: frozen
    parameters get no update, no weight decay and no part in the clip."""
    o = cfg.optim
    return ScheduledAdamW([p for p in model.parameters() if p.requires_grad], schedule,
                          grad_clip_norm=o.grad_clip_norm, betas=(o.beta1, o.beta2), eps=o.eps,
                          weight_decay=o.weight_decay)


def remat_arg(cfg: ExperimentConfig):
    """cfg.remat / cfg.remat_policy → the `remat` argument of clibd_apply:
    False (off), True (blanket recompute) or a policy spec string."""
    if not cfg.remat:
        return False
    return cfg.remat_policy if cfg.remat_policy not in ("", "none") else True


def make_encode_fn(cfg: ExperimentConfig, model: torch.nn.Module) -> Callable:
    """→ encode(batch, generator): `clibd_apply`'s output for one batch of
    device tensors, the images augmented with the generator's draws,
    differentiable in the model's parameters."""
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    remat = remat_arg(cfg)

    def encode(batch: dict, generator: Optional[torch.Generator]) -> dict:
        image_in = batch.get("image")
        if image_in is not None and cfg.image.input_type == "image":
            # flips and rotation only move values, so augmenting in the
            # compute dtype equals casting the augmented fp32 images
            image_in = train_augment(generator, dequantize_image(image_in).to(compute_dtype))
        return clibd_apply(model, cfg, image_input=image_in, dna_input=batch.get("dna"),
                           language_input=batch.get("language"), compute_dtype=compute_dtype,
                           remat=remat)

    return encode


def make_loss_fn(cfg: ExperimentConfig, model: torch.nn.Module) -> Callable:
    """→ loss_fn(batch, generator): the scalar loss of one batch of device
    tensors, differentiable in the model's parameters."""
    encode = make_encode_fn(cfg, model)

    def loss_fn(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        with span("step.forward"):
            out = encode(batch, generator)
        with span("step.loss"):
            # fix_temperature → literal 1/0.07 (reference train_epoch.py:55-56)
            logit_scale = (1.0 / 0.07) if cfg.loss.fix_temperature else out["logit_scale"]
            features = {m: out[m] for m in MODALITY_ORDER}
            return clip_loss(features, batch["label"], logit_scale, cfg.loss)

    return loss_fn


def make_train_step(cfg: ExperimentConfig, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """→ step(batch, generator) → the loss as a device tensor (not fetched);
    the parameters are updated in place."""
    loss_fn = make_loss_fn(cfg, model)

    def step(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, generator)
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def _rows(x, lo: int, hi: int):
    """Rows lo:hi of a tensor, or of each tensor in a (nested) dict."""
    return {k: _rows(v, lo, hi) for k, v in x.items()} if isinstance(x, dict) else x[lo:hi]


def make_accum_grad_fn(cfg: ExperimentConfig, model: torch.nn.Module, accum_steps: int,
                       mesh: Optional[Mesh] = None) -> Callable:
    """→ grad_fn(batch, generator) → the loss of the whole batch, its
    gradients added to the parameters' `.grad`: the gradient cache of
    `clibd_tpu/engine/train.py:122-229` (Gao et al. 2021's GradCache).

    A contrastive loss couples every sample of the batch, so k losses of
    B/k samples are another objective.  Instead, with k microbatches:

    1. no-grad forwards, one microbatch at a time: only the [B, D]
       features are kept;
    2. the full-batch loss on those features, as leaves that require grad:
       d(loss)/d(features), and d(loss)/d(logit_scale) for the logit-scale
       parameter;
    3. per microbatch, the forward again with grad and its backward against
       that microbatch's rows of the cached d(loss)/d(features); the
       parameters' gradients accumulate in `.grad`, the logit scale's is
       added once.

    Passes 1 and 3 draw the same augmentation (`fold_in(generator, i)` for
    microbatch i, made anew for each pass), so they compute the same
    function and the gradients are the monolithic step's, up to the order
    of the sums.  `cfg.remat` applies inside each microbatch.  B must
    divide by k.

    mesh of a process group (W >= 1 ranks; a mesh without one, or None, is
    the one process's batch): batch holds this rank's rows (B a rank,
    global batch B·W), split into k microbatches of its own, and the
    gradient left in every rank's `.grad` is that of the global batch's
    loss, as `make_sharded_grad_fn` leaves it.  Pass 2 is
    `sharded_clip_loss` of the rank's features: its gather puts every
    rank's features in rank order into the global [B·W, D], and its
    backward keeps this rank's rows of the summed cotangents, W dL/df.
    After pass 3 the parameters' gradients, the logit scale's among them,
    are averaged over the ranks (`all_reduce_grads`), which makes them
    dL/dθ.  The augmentation draws from `fold_in(fold_in(generator, rank),
    i)`."""
    encode = make_encode_fn(cfg, model)
    ls_param = model.logit_scale
    multi = mesh is not None and mesh.group is not None
    trainable = [p for p in model.parameters() if p.requires_grad]

    def grad_fn(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        B = batch["label"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} not divisible by accum_steps={accum_steps}")
        b = B // accum_steps
        if multi:
            generator = fold_in(generator, mesh.rank)
        inputs = {k: v for k, v in batch.items() if k != "label"}
        micro = [_rows(inputs, i * b, (i + 1) * b) for i in range(accum_steps)]

        with torch.no_grad():  # pass 1
            feats = [encode(mb, fold_in(generator, i)) for i, mb in enumerate(micro)]
        present = [m for m in MODALITY_ORDER if feats[0][m] is not None]
        leaves = {m: torch.cat([f[m] for f in feats]).requires_grad_() for m in present}
        del feats

        with torch.enable_grad():  # pass 2
            if cfg.loss.fix_temperature:
                logit_scale, scale_leaf = 1.0 / 0.07, None
            else:
                scale_leaf = ls_param.detach().requires_grad_()
                logit_scale = torch.exp(scale_leaf)
            if multi:
                loss = sharded_clip_loss(leaves, batch["label"], logit_scale, cfg.loss,
                                         mesh.group)
            else:
                loss = clip_loss(leaves, batch["label"], logit_scale, cfg.loss)
            wrt = [leaves[m] for m in present] + ([scale_leaf] if scale_leaf is not None else [])
            grads = torch.autograd.grad(loss, wrt)
        cotangents = dict(zip(present, grads))

        for i, mb in enumerate(micro):  # pass 3
            out = encode(mb, fold_in(generator, i))
            # a frozen tower's features carry no graph
            pairs = [(out[m], cotangents[m][i * b:(i + 1) * b]) for m in present
                     if out[m].requires_grad]
            if pairs:
                torch.autograd.backward([o for o, _ in pairs], grad_tensors=[c for _, c in pairs])
        if scale_leaf is not None:
            d_scale = grads[-1]
            ls_param.grad = d_scale.clone() if ls_param.grad is None else ls_param.grad + d_scale
        if multi:
            all_reduce_grads(trainable, "mean", mesh.group)
        return loss.detach()

    return grad_fn


def make_train_step_accum(cfg: ExperimentConfig, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, accum_steps: int,
                          mesh: Optional[Mesh] = None) -> Callable:
    """→ step(batch, generator) with `make_accum_grad_fn`'s gradients and
    one optimizer update (its global-norm clip sees the summed gradients);
    `make_train_step` (`make_train_step_shard_map` across ranks) when
    accum_steps < 2.  mesh: as `make_accum_grad_fn`."""
    if accum_steps < 2:
        if mesh is not None and mesh_is_multiprocess(mesh):
            return make_train_step_shard_map(cfg, model, optimizer, mesh)
        return make_train_step(cfg, model, optimizer)
    grad_fn = make_accum_grad_fn(cfg, model, accum_steps, mesh)

    def step(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = grad_fn(batch, generator)
        optimizer.step()
        return loss

    return step


def make_sharded_grad_fn(cfg: ExperimentConfig, model: torch.nn.Module, mesh: Mesh) -> Callable:
    """→ grad_fn(batch, generator) → the global batch's loss, on one rank of
    `mesh`: batch holds this rank's rows, and the gradient of the global
    batch's loss is left in every rank's `.grad`.

    The augmentation draws from `fold_in(generator, rank)`, so the ranks'
    images get different flips and rotations
    (`clibd_tpu/engine/train.py:259`).  `sharded_clip_loss`'s gather passes
    each rank W times its rows' gradient, so the parameters' gradients are
    averaged over the ranks, not summed: (1/W) sum_r W dL/df_r df_r/dtheta
    is dL/dtheta.  The logit scale's gradient is the whole dL/ds on every
    rank, and the mean leaves it so."""
    encode = make_encode_fn(cfg, model)
    trainable = [p for p in model.parameters() if p.requires_grad]

    def grad_fn(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        out = encode(batch, fold_in(generator, mesh.rank))
        logit_scale = (1.0 / 0.07) if cfg.loss.fix_temperature else out["logit_scale"]
        features = {m: out[m] for m in MODALITY_ORDER}
        loss = sharded_clip_loss(features, batch["label"], logit_scale, cfg.loss, mesh.group)
        loss.backward()
        all_reduce_grads(trainable, "mean", mesh.group)
        return loss.detach()

    return grad_fn


def make_train_step_shard_map(cfg: ExperimentConfig, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, mesh: Mesh) -> Callable:
    """→ step(batch, generator) → the loss: `make_sharded_grad_fn`'s
    gradients and one optimizer update, the same on every rank (the
    counterpart of `clibd_tpu/engine/train.py:232-292`)."""
    grad_fn = make_sharded_grad_fn(cfg, model, mesh)

    def step(batch: dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = grad_fn(batch, generator)
        optimizer.step()
        return loss

    return step


def batch_generator(device: torch.device, seed: int, epoch: int, batch_idx: int) -> torch.Generator:
    """The augmentation generator of one batch, from (seed, epoch, batch
    index) alone -- the counterpart of fold_in(PRNGKey(seed, epoch), i) -- so
    a mid-epoch resume draws what an uninterrupted run would."""
    state = np.random.SeedSequence([seed, epoch, batch_idx]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def fold_in(generator: Optional[torch.Generator], i: int) -> Optional[torch.Generator]:
    """The generator of microbatch i of a batch, seeded from (the batch
    generator's seed, i) alone -- the counterpart of fold_in(rng, i) -- so
    each call for the same (seed, epoch, batch, microbatch) gives the same
    draws.  None stays None."""
    if generator is None:
        return None
    state = np.random.SeedSequence([generator.initial_seed(), i]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(state))


class Trainer:
    """The full training loop: loaders + model + optimizer + eval +
    checkpoints, on one card or on one rank of a process group."""

    def __init__(
        self,
        global_cfg: GlobalConfig,
        hdf5_path: Optional[str],
        output_dir: str,
        train_split: str = "no_split_and_seen_train",
        eval_splits: Optional[dict] = None,  # {"keys": ..., "seen": ..., "unseen": ...}
        model=None,
        log_fn: Optional[Callable[[dict], None]] = None,
        num_workers: Optional[int] = None,
        train_labels: Optional[np.ndarray] = None,
        train_loader=None,
        eval_loader_factory: Optional[Callable[..., object]] = None,
        device: torch.device | str = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        """train_loader / eval_loader_factory take the place of the HDF5
        loaders (a dataset in memory, `data.SyntheticSplit`):
        eval_loader_factory(split_name, train) returns a loader with
        batches()/label_dicts()/ids()/close().

        mesh: default `create_mesh(device=device)`, this rank's mesh in a
        process group, else the card alone.  Under a group of W > 1 ranks
        (or with `step_impl: shard_map`) a step is
        `make_train_step_shard_map`'s, or with accum_steps > 1 the gradient
        cache across the ranks (`make_train_step_accum(mesh=)`; refused
        under `step_impl: shard_map`); `batch_size` is per rank, the HDF5
        loader yields this rank's strided share of the split, and a given
        train_loader must too.  There the eval shards each split over the
        ranks, with eval_loader_factory(split_name, train, host_id,
        num_hosts) making a rank's shard (`SyntheticSplit(host_id=,
        num_hosts=)`)."""
        self.gcfg = global_cfg
        self.cfg = cfg = global_cfg.model_config
        self.hdf5_path = hdf5_path
        self.mesh = mesh if mesh is not None else create_mesh(device=device)
        if self.mesh.group is None and len(self.mesh.devices) > 1:
            raise ValueError("training takes one card a process: start a rank a card "
                             "(torchrun) instead of a list of devices")
        self.device = self.mesh.device
        self.world_size = self.mesh.size
        self.is_main = self.mesh.rank == 0
        if cfg.step_impl == "shard_map" and cfg.accum_steps > 1:
            raise ValueError("accum_steps>1 requires step_impl=global (the gradient cache's "
                             "step is the global batch's)")
        self.log_fn = log_fn or (lambda d: None)
        # async checkpoint writes: the disk leg of last/best saves overlaps
        # the next epoch; fit() and close() join before returning
        self.checkpointer = BestLastCheckpointer(output_dir, async_writes=True)
        self.eval_splits = eval_splits or {"keys": "all_keys", "seen": "val_seen",
                                           "unseen": "val_unseen"}
        self.eval_loader_factory = eval_loader_factory
        if train_loader is not None:
            self.train_loader = train_loader
        else:
            from ..data.pipeline import BatchSpec, BioscanLoader

            spec = BatchSpec(
                batch_size=cfg.batch_size, train=True, transport_uint8=cfg.amp,
                with_image=cfg.image.enable, with_dna=cfg.dna.enable,
                with_language=cfg.language.enable, dna_kmer=cfg.dna.kmer,
                dna_tokenizer=cfg.dna.tokenizer, dna_stride=cfg.dna.stride,
                dna_max_bp=cfg.dna.max_bp,
                image_source="image" if cfg.image.input_type == "image" else "image_features",
                dna_source="sequence" if cfg.dna.input_type == "sequence" else "dna_features",
                clip_tokenizer=BatchSpec.maybe_clip_tokenizer(cfg),
            )
            nw = global_cfg.pipeline.num_workers if num_workers is None else num_workers
            self.train_loader = BioscanLoader(
                hdf5_path, train_split, spec, labels=train_labels, num_workers=nw,
                prefetch=global_cfg.pipeline.prefetch_batches, seed=cfg.default_seed,
                use_native=global_cfg.pipeline.use_native_decoder,
                # DistributedSampler's shards (reference dataset.py:44-51)
                host_id=self.mesh.rank, num_hosts=self.world_size)

        if model is None:
            model = init_clibd_model(cfg, torch.Generator().manual_seed(cfg.default_seed),
                                     self.device)
        self.model = model
        steps_per_epoch = len(self.train_loader)
        total_steps = max(steps_per_epoch * cfg.epochs, 1)
        # LR × (batch × world)/500 (reference util/util.py:753-756)
        self.schedule = build_schedule(cfg.optim, total_steps, cfg.batch_size,
                                       world_size=self.world_size)
        self.optimizer = build_optimizer(cfg, model, self.schedule)
        if cfg.step_impl == "shard_map":
            self.step_fn = make_train_step_shard_map(cfg, model, self.optimizer, self.mesh)
        else:
            self.step_fn = make_train_step_accum(cfg, model, self.optimizer, cfg.accum_steps,
                                                 self.mesh)
        self.global_step = 0
        self.stop_flag = False
        self._resume_start_batch = 0

    # -- epoch loops --------------------------------------------------------

    def train_epoch(self, epoch: int, progress: bool = False, start_batch: int = 0) -> float:
        cfg = self.cfg
        timer = StepTimer(warmup_steps=1, device=self.device)
        epoch_loss, n_steps = 0.0, 0
        t0 = time.time()
        batch_idx = start_batch
        pending = None  # one-step-delayed loss fetch: the host reads step i's
        # loss only after step i+1 has been launched

        def emit(item):
            nonlocal epoch_loss
            loss_dev, step_no, lr = item
            loss_val = float(loss_dev)
            epoch_loss += loss_val
            self.log_fn({"loss": loss_val, "step": step_no, "learning_rate": lr})
            if progress:
                dt = time.time() - t0
                print(f"\rEpoch {epoch}||Step {step_no}||Loss {loss_val:.4f}||LR {lr:.3e}||"
                      f"{n_steps / max(dt, 1e-9):.2f} it/s", end="")

        for batch in loop_units(self.train_loader.batches(epoch=epoch, start_batch=start_batch),
                                "train.next_batch", start_batch):
            gen = batch_generator(self.device, cfg.default_seed, epoch, batch_idx)
            batch_idx += 1
            model_batch = {k: batch[k] for k in ("image", "dna", "language", "label")
                           if k in batch}
            with span("train.to_device"):
                device_batch = to_device(model_batch, self.device)
            with span("train.step"):
                loss = self.step_fn(device_batch, gen)
            self.global_step += 1
            n_steps += 1
            # step-cadence last/ (mid-epoch failure recovery); meta.epoch is
            # the last completed epoch, so resume continues inside this one
            if (cfg.checkpoint_every_steps and self.gcfg.save_ckpt and self.is_main
                    and self.global_step % cfg.checkpoint_every_steps == 0):
                self.checkpointer.save_last(self.model, self.optimizer, self.global_step,
                                            epoch - 1)
            lr = float(self.schedule(self.global_step - 1))
            if pending is not None:
                with span("train.fetch_loss"):
                    emit(pending)
            pending = (loss, self.global_step, lr)
            with span("train.sync"):
                timer.tick()
        if pending is not None:
            emit(pending)
        if progress:
            print()
        if timer.times:
            summary = timer.summary(cfg.batch_size * self.world_size, n_chips=self.world_size)
            self.log_fn({"epoch": epoch, **{f"throughput/{k}": v for k, v in summary.items()}})
        return epoch_loss / max(n_steps, 1)

    def evaluate(self) -> dict:
        """The retrieval grid over the eval splits.  Under a group of W > 1
        each rank encodes a strided 1/W of each split and every rank
        assembles the whole (`extract_split_multihost`); the grid then runs
        on every rank over the same inputs, so the early stop agrees
        everywhere (`clibd_tpu/engine/train.py:486-519`)."""
        cfg = self.cfg
        multiproc = mesh_is_multiprocess(self.mesh)

        def run(split, for_key=False):
            if multiproc:
                from ..data.pipeline import BatchSpec

                make_loader = None
                if self.eval_loader_factory is not None:
                    def make_loader(g, n):
                        return self.eval_loader_factory(split, False, g, n)
                return extract_split_multihost(
                    self.model, cfg, self.hdf5_path, split, BatchSpec.eval_spec(cfg),
                    for_key_set=for_key, num_workers=self.gcfg.pipeline.num_workers,
                    use_native=self.gcfg.pipeline.use_native_decoder, make_loader=make_loader,
                    mesh=self.mesh)
            if self.eval_loader_factory is not None:
                loader = self.eval_loader_factory(split, False)
            else:
                from ..data.pipeline import BatchSpec, BioscanLoader

                # best-checkpoint selection sees the standalone eval's
                # preprocessing: one shared constructor
                loader = BioscanLoader(self.hdf5_path, split, BatchSpec.eval_spec(cfg),
                                       num_workers=self.gcfg.pipeline.num_workers,
                                       use_native=self.gcfg.pipeline.use_native_decoder)
            try:
                return extract_split(self.model, cfg, loader, for_key_set=for_key)
            finally:
                loader.close()

        keys_dict = run(self.eval_splits["keys"], for_key=True)
        seen_dict = run(self.eval_splits["seen"])
        unseen_dict = run(self.eval_splits["unseen"])
        acc_dict, _, _ = inference_and_eval(keys_dict, seen_dict, unseen_dict, with_preds=False,
                                            device=self.device)
        return acc_dict

    def resume(self, directory: str) -> int:
        """Restore params, optimizer state, step and best-metric tracking
        from a checkpoint directory (a true resume: the reference reloads
        params only); → the epoch to continue from, with the batch to start
        at inside it kept for `fit`."""
        meta = load_train_state(directory, self.model, self.optimizer)
        return self._apply_resume_state(int(meta.get("step", 0)), int(meta.get("epoch", -1)),
                                        self._read_best_meta(directory))

    def _apply_resume_state(self, step: int, ckpt_epoch: int, best) -> int:
        self.global_step = step
        # otherwise the first eval after resume always "improves" and may
        # overwrite best/ with a worse model
        if best is not None:
            self.checkpointer.best_metric, self.checkpointer.best_epoch = best
        # the seeded epoch streams make the step count an exact (epoch,
        # batch) position: a checkpoint taken mid-epoch continues inside it
        spe = max(len(self.train_loader), 1)
        self._resume_start_batch = max(self.global_step - (ckpt_epoch + 1) * spe, 0)
        return ckpt_epoch + 1

    def resume_multihost(self, directory: str):
        """Resume a group whose checkpoints only rank 0 writes
        (`clibd_tpu/engine/train.py:543-590`): the ranks agree by a
        collective whether rank 0 has `directory`, rank 0 loads it, and one
        broadcast carries the params, the optimizer state, the step, epoch
        and best metric to every rank.  Another rank's own copy at the same
        path, even a stale one, is never read: matching shapes would let the
        run go on silently diverged.  → the epoch to continue from, or None
        where rank 0 has no checkpoint (a fresh start everywhere).  One
        process: `resume` where the directory exists."""
        local_has = os.path.exists(os.path.join(directory, "params.npz"))
        if not mesh_is_multiprocess(self.mesh):
            return self.resume(directory) if local_has else None
        if not all_hosts_agree(local_has or not self.is_main, self.mesh.group):
            return None  # rank 0 has nothing: a fresh start everywhere
        ints = np.zeros(4, np.int64)  # step, epoch, best epoch, has best
        metric = np.zeros(1, np.float64)
        if self.is_main:
            meta = load_train_state(directory, self.model, self.optimizer)
            best = self._read_best_meta(directory)
            ints[:] = (int(meta.get("step", 0)), int(meta.get("epoch", -1)),
                       best[1] if best else -1, int(best is not None))
            metric[0] = best[0] if best else 0.0
        params = dict(self.model.named_parameters())
        # rank 0's optimizer state as it loaded it; elsewhere zeros of the
        # same keys and shapes, as optax's init gives them
        state = {"params": {n: p.detach() for n, p in params.items()},
                 "opt": opt_state_to_optax(self.model, self.optimizer),
                 "ints": ints, "metric": metric}
        state = broadcast_from_main(state, self.mesh.group)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(state["params"][n])
        opt_state_from_optax(state["opt"], self.model, self.optimizer)
        step, ckpt_epoch, best_epoch, has_best = (int(x) for x in state["ints"])
        best = (float(state["metric"][0]), best_epoch) if has_best else None
        return self._apply_resume_state(step, ckpt_epoch, best)

    def _read_best_meta(self, directory: str):
        """(best_metric, best_epoch) from the sibling best/meta.json, else None."""
        best_meta = os.path.join(os.path.dirname(os.path.abspath(directory)), "best", "meta.json")
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                info = json.load(f)
            if "overall_acc" in info:
                return float(info["overall_acc"]), int(info.get("epoch", -1))
        return None

    def fit(self, progress: bool = False, start_epoch: int = 0) -> dict:
        history = {"loss": [], "overall_acc": [], "best_epoch": None}
        try:
            return self._fit_loop(history, progress, start_epoch)
        finally:
            # join in-flight checkpoint writes on every exit path
            self.checkpointer.wait()

    def _fit_loop(self, history, progress: bool, start_epoch: int) -> dict:
        cfg = self.cfg
        for epoch in range(start_epoch, cfg.epochs):
            if self.stop_flag:
                break
            start_batch = self._resume_start_batch if epoch == start_epoch else 0
            history["loss"].append(self.train_epoch(epoch, progress=progress,
                                                    start_batch=start_batch))
            # last/ every epoch, so a crash always leaves something to resume
            if self.gcfg.save_ckpt and self.is_main:
                self.checkpointer.save_last(self.model, self.optimizer, self.global_step, epoch)
            do_eval = ((epoch % cfg.evaluation_period == 0 or epoch == cfg.epochs - 1)
                       and epoch > cfg.eval_skip_epoch)
            if do_eval:
                acc_dict = self.evaluate()
                overall = compute_overall_acc(acc_dict)
                history["overall_acc"].append((epoch, overall))
                self.log_fn(convert_acc_dict_to_wandb_dict(acc_dict))
                improved = self.checkpointer.maybe_save_best(
                    overall, self.model, self.optimizer, self.global_step, epoch,
                    save=self.gcfg.save_ckpt and self.is_main)
                if improved:
                    history["best_epoch"] = epoch
                elif self.gcfg.enable_early_stopping:
                    self.stop_flag = True
                self.log_fn({"overall_acc": overall, "epoch": epoch})
        return history

    def close(self):
        self.checkpointer.wait()
        self.train_loader.close()
