"""Command line of the port (`python -m clibd_tpu_torch.cli`):

  train --experiment <cfg.yaml> [--hdf5 data.hdf5] [--output-dir DIR]
        [--train-split SPLIT] [--resume [DIR]] [--device cuda] [k=v ...]
  eval  --experiment <cfg.yaml> [--hdf5 data.hdf5] [--device cuda] [k=v ...]

the counterparts of `clibd train` and `clibd eval`, the subcommands ported
so far.  Both run on the card; `--device cpu` runs them on the CPU (the
kernels' plain versions), and only when asked.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .eval_cmds import cmd_eval
from .train_cmds import cmd_train


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="clibd_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--experiment", "-e", default=None, help="experiment config name or path")
        p.add_argument("--global-config", "-g", default=None)
        p.add_argument("--hdf5", default=None, help="override dataset HDF5 path")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda; cpu only when asked)")
        p.add_argument("overrides", nargs="*", help="key.path=value overrides")

    p_train = sub.add_parser("train", help="contrastive training (train_cl.py)")
    common(p_train)
    p_train.add_argument("--output-dir", default=None)
    p_train.add_argument("--train-split", default="no_split_and_seen_train")
    p_train.add_argument("--resume", nargs="?", const=True, default=None,
                         help="resume from checkpoint dir (default: <output>/last)")
    p_eval = sub.add_parser("eval", help="extract + retrieval eval (inference_and_eval.py)")
    common(p_eval)
    p_eval.add_argument("--unimodel", default=None, metavar="SIMCLR_CKPT",
                        help="SimCLR image-encoder eval (not ported yet)")
    args = parser.parse_args(argv)
    return {"train": cmd_train, "eval": cmd_eval}[args.command](args, args.overrides)
