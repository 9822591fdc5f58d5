# A copy of clibd_tpu/utils/logging.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Metrics logging (reference §5.5: wandb rank-0 logging, train_cl.py:148-150,
264-265): a wandb-compatible shim that uses the real wandb when importable
and otherwise appends JSONL to disk, so training runs log identically with
or without the dependency."""

from __future__ import annotations

import json
import os
import time

class RunLogger:
    """wandb-like interface: init-once, .log(dict), .finish()."""

    def __init__(
        self,
        project: str,
        name: str,
        output_dir: str = "logs",
        use_wandb: bool = True,
    ):
        self.project = project
        self.name = name
        self._wandb = None
        self._file = None
        if use_wandb:
            try:
                import wandb  # noqa

                self._wandb = wandb
                wandb.init(project=project, name=name)
            except Exception:
                self._wandb = None
        if self._wandb is None:
            os.makedirs(output_dir, exist_ok=True)
            path = os.path.join(output_dir, f"{project}__{name}.jsonl")
            self._file = open(path, "a")
            self.path = path

    def log(self, metrics: dict, commit: bool = True) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, commit=commit)
        elif self._file is not None:
            record = {"_time": time.time(), **metrics}
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
            self._file = None
