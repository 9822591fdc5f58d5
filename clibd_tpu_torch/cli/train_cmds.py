"""`train` and `simclr`: the ports of `clibd_tpu/cli/train_cmds.py::cmd_train`
(`:14-112`), contrastive training (reference train_cl.py) on BIOSCAN or
INSECT, and `cmd_simclr` (`:115-132`), SimCLR pretraining of the image
encoder (reference scripts/unimodel/), on one device."""

from __future__ import annotations

import json
import os

from .common import _dataset_hdf5_path, _load_cfg


def _insect_loader_factory(cfg):
    """→ make_loader(split, train): an `INSECTLoader` over one split of the
    INSECT files the config names, at the config's batch size (one device's
    share: the whole batch)."""
    from ..data.insect import INSECTDataset, INSECTLoader
    from ..data.pipeline import BatchSpec

    mc = cfg.model_config

    def make_loader(split, train):
        ds = INSECTDataset(cfg.insect_data.path_to_att_splits_mat,
                           cfg.insect_data.path_to_res_101_mat,
                           cfg.insect_data.path_to_image_hdf5,
                           cfg.insect_data.species_to_other, split=split)
        spec = BatchSpec(batch_size=mc.batch_size, train=train, with_image=mc.image.enable,
                         with_dna=mc.dna.enable, with_language=False)
        return INSECTLoader(ds, spec, seed=mc.default_seed)

    return make_loader


def cmd_train(args, overrides) -> int:
    from ..config import save_config
    from ..engine.train import Trainer
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
        eval_loader_factory = _insect_loader_factory(cfg)
        train_loader = eval_loader_factory("trainval_loc", True)
        eval_splits = {"keys": "trainval_loc", "seen": "test_seen_loc",
                       "unseen": "test_unseen_loc"}

    trainer = Trainer(cfg, hdf5, output_dir=out_dir, train_split=train_split,
                      eval_splits=eval_splits, log_fn=log_fn, train_loader=train_loader,
                      eval_loader_factory=eval_loader_factory, device=args.device)
    save_config(cfg, os.path.join(out_dir, "config.yaml"))
    start_epoch = 0
    if args.resume:
        resume_dir = args.resume if args.resume is not True else os.path.join(out_dir, "last")
        if os.path.exists(os.path.join(resume_dir, "params.npz")):
            start_epoch = trainer.resume(str(resume_dir))
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
