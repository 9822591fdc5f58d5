"""`train`, `simclr` and `finetune`: the ports of `clibd_tpu/cli/train_cmds.py::
cmd_train` (`:14-112`), contrastive training (reference train_cl.py) on
BIOSCAN or INSECT, `cmd_simclr` (`:115-132`), SimCLR pretraining of the
image encoder (reference scripts/unimodel/), and `cmd_finetune`
(`:135-189`), supervised species classification on INSECT (reference
scripts/BZSL/fine_tune_*.py).  `train` on BIOSCAN and `simclr` also run one
rank a card under torchrun (`torchrun --nproc_per_node=N -m
clibd_tpu_torch.cli train ...`): `batch_size` is per rank, only rank 0
writes, and `--resume` takes rank 0's checkpoint to every rank."""

from __future__ import annotations

import json
import os

import torch

from .common import _dataset_hdf5_path, _load_cfg, _resolve_params


def insect_dataset(cfg, split: str):
    """The `INSECTDataset` of one split of the INSECT files the config names."""
    from ..data.insect import INSECTDataset

    return INSECTDataset(cfg.insect_data.path_to_att_splits_mat,
                         cfg.insect_data.path_to_res_101_mat,
                         cfg.insect_data.path_to_image_hdf5,
                         cfg.insect_data.species_to_other, split=split)


def _insect_loader_factory(cfg, modality: str = None):
    """→ make_loader(split, train): an `INSECTLoader` over one split of the
    INSECT files the config names, at the config's batch size (one device's
    share: the whole batch), with the modalities the config enables, or only
    `modality`."""
    from ..data.insect import INSECTLoader
    from ..data.pipeline import BatchSpec

    mc = cfg.model_config
    with_image = mc.image.enable if modality is None else modality == "image"
    with_dna = mc.dna.enable if modality is None else modality == "dna"

    def make_loader(split, train):
        spec = BatchSpec(batch_size=mc.batch_size, train=train, with_image=with_image,
                         with_dna=with_dna, with_language=False)
        return INSECTLoader(insect_dataset(cfg, split), spec, seed=mc.default_seed)

    return make_loader


def cmd_train(args, overrides) -> int:
    from ..config import save_config
    from ..engine.train import Trainer
    from ..parallel.mesh import is_main_process, num_hosts
    from ..utils.seed import set_seed

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    set_seed(None if mc.random_seed else mc.default_seed)

    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    out_dir = args.output_dir or os.path.join(cfg.model_output_dir, mc.model_output_name)
    train_split = args.train_split
    if train_split == "no_split_and_seen_train" and not mc.using_train_seen_for_pre_train:
        train_split = "no_split"  # reference load_dataloader (dataset.py:699-727)

    logger = None
    log_fn = print if cfg.debug_flag else None
    if cfg.activate_wandb:
        from ..utils.logging import RunLogger

        logger = RunLogger(project=f"CLIBD-{mc.dataset}", name=mc.model_output_name,
                           output_dir="logs")
        log_fn = logger.log

    eval_splits = {"keys": "all_keys", "seen": "val_seen", "unseen": "val_unseen"}
    train_loader = eval_loader_factory = None
    if mc.dataset == "INSECT":
        # contrastive fine-tune on INSECT (reference train_cl.py:166-169)
        if num_hosts() > 1:
            raise SystemExit("the INSECT contrastive fine-tune runs as one process: its "
                             "loaders do not shard over ranks")
        eval_loader_factory = _insect_loader_factory(cfg)
        train_loader = eval_loader_factory("trainval_loc", True)
        eval_splits = {"keys": "trainval_loc", "seen": "test_seen_loc",
                       "unseen": "test_unseen_loc"}

    trainer = Trainer(cfg, hdf5, output_dir=out_dir, train_split=train_split,
                      eval_splits=eval_splits, log_fn=log_fn, train_loader=train_loader,
                      eval_loader_factory=eval_loader_factory, device=args.device)
    if is_main_process():
        save_config(cfg, os.path.join(out_dir, "config.yaml"))
    start_epoch = 0
    if args.resume:
        resume_dir = args.resume if args.resume is not True else os.path.join(out_dir, "last")
        # rank 0's checkpoint, whatever the other ranks' disks hold
        resumed = trainer.resume_multihost(str(resume_dir))
        if resumed is not None:
            start_epoch = resumed
            print(f"Resumed from {resume_dir} at epoch {start_epoch}")
    history = trainer.fit(progress=True, start_epoch=start_epoch)
    trainer.close()
    if logger is not None:
        logger.finish()
    print(json.dumps({"best_epoch": history["best_epoch"],
                      "final_loss": history["loss"][-1] if history["loss"] else None}))
    return 0


def cmd_simclr(args, overrides) -> int:
    """SimCLR pretraining of the image encoder (reference scripts/unimodel/)."""
    from ..engine.simclr import SimCLRTrainer

    cfg = _load_cfg(args, overrides)
    hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
    out_dir = args.output_dir or os.path.join(cfg.project_root_path, "ckpt", "uni_model",
                                              "uni_model", "image",
                                              cfg.model_config.model_output_name)
    trainer = SimCLRTrainer(cfg, hdf5, output_dir=out_dir, split=args.train_split,
                            temperature=args.temperature, num_workers=cfg.pipeline.num_workers,
                            device=args.device)
    hist = trainer.fit(progress=True)
    trainer.close()
    print(json.dumps({"final_loss": hist["loss"][-1] if hist["loss"] else None}))
    return 0


def cmd_finetune(args, overrides) -> int:
    """Supervised species-classification fine-tune of one encoder on INSECT
    (reference scripts/BZSL/fine_tune_*.py + epoch/fine_tuning_epoch.py):
    train on trainval_loc, top-k accuracy on test_seen_loc; --output-dir
    writes the params with the head under classifier/, in the layout the
    JAX package's `load_train_state` reads."""
    import numpy as np

    from ..engine.checkpoint import save_train_state
    from ..engine.finetune import fit_classifier, species_to_index, topk_accuracy

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    model = _resolve_params(cfg, torch.device(args.device))
    make_loader = _insect_loader_factory(cfg, args.modality)
    train_loader = make_loader("trainval_loc", True)
    eval_loader = make_loader("test_seen_loc", False)

    unique_species = sorted({l["species"] for l in train_loader.label_dicts()})
    train_targets = species_to_index(train_loader.label_dicts(), unique_species)
    eval_targets = species_to_index(eval_loader.label_dicts(), unique_species)

    ft_model, predict, _losses = fit_classifier(
        model, mc, train_loader, train_targets, len(unique_species), lr=args.lr,
        epochs=args.epochs, modality=args.modality, train_encoder=not args.freeze_encoder,
        seed=mc.default_seed, verbose=True)

    logits, targets = [], []
    for batch in eval_loader.batches(shuffle=False):
        logits.append(predict(batch[args.modality]).cpu().numpy())
        targets.append(eval_targets[batch["index"]])
    acc = topk_accuracy(np.concatenate(logits), np.concatenate(targets))
    print(json.dumps({"top_k_acc": {str(k): v for k, v in acc.items()},
                      "num_species": len(unique_species)}))
    if args.output_dir:
        save_train_state(args.output_dir, ft_model)
    train_loader.close()
    eval_loader.close()
    return 0
