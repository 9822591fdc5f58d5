"""`train`: the port of `clibd_tpu/cli/train_cmds.py::cmd_train` (`:14-112`),
contrastive training (reference train_cl.py) on one device."""

from __future__ import annotations

import json
import os

from .common import _dataset_hdf5_path, _load_cfg


def cmd_train(args, overrides) -> int:
    from ..config import save_config
    from ..engine.train import Trainer
    from ..utils.seed import set_seed

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    if mc.dataset == "INSECT":
        raise NotImplementedError("contrastive fine-tune on INSECT is not ported to "
                                  "clibd_tpu_torch yet (ROADMAP.md Queue 1)")
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

    trainer = Trainer(cfg, hdf5, output_dir=out_dir, train_split=train_split,
                      eval_splits={"keys": "all_keys", "seen": "val_seen", "unseen": "val_unseen"},
                      log_fn=log_fn, device=args.device)
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
