"""Extraction soak at scale through the real `eval` and `extract --stream`
commands: the port of the repository's `tools/soak_extract.py`.

    python3 -m clibd_tpu_torch.tools.soak_extract build
    python3 -m clibd_tpu_torch.tools.soak_extract run
    python3 -m clibd_tpu_torch.tools.soak_extract verify
    python3 -m clibd_tpu_torch.tools.soak_extract stream [--kill-at N] [--resume] [--out F]
    python3 -m clibd_tpu_torch.tools.soak_extract stream-compare
    (each takes --workdir DIR, default <tmp>/clibd_soak_extract, and --device cpu)

Drives the main deliverable, test-split extraction into
`extracted_feature_from_test_split.hdf5`, end to end through the port's
`eval` command over a synthetic dataset of unique 256 x 256 JPEGs (the
BIOSCAN image shape; `soak_train.build`): all_keys 25k, test_seen 15k,
test_unseen 10k records.  The
host HDF5 loader, the native JPEG decode where `native/` builds, the eval
transform, the tri-encoder on the card, the cache in the reference's
schema, then the kNN grid, the metrics and the report.

- run: `eval` with CLIBD_EVAL_TIMING=1 (its output also goes to
  <workdir>/eval.log), then the device-only encode of one batch already on
  the card, measured again in the process: sustained samples/s, the
  device's idle share, each split's rate, one JSON line;
- verify: the cache's schema and shapes, its reload through
  `load_extracted_features`, unit-norm rows, and a second `eval` over the
  cached embeddings (load_inference) that must give the same acc_dict;
- stream: `extract --stream` (`AppendableEmbeddingWriter`) over all_keys;
  --kill-at N sends SIGKILL from a watcher thread once the output holds N
  records (a torn append), --resume continues it;
- stream-compare: the killed and resumed output must equal an
  uninterrupted streaming run (`--out <workdir>/stream_oneshot.hdf5`)
  dataset for dataset, bit for bit.

`--device cpu` runs it at a tiny width and size for a rehearsal
(`soak_train.TINY`; `TINY_SIZES`: 120 records in batches of 8).  Needs
h5py.  On the card it prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import sys
import tempfile
import threading
import time

import numpy as np

from .soak_train import TINY, on_cpu

# records over the three splits and the batch (None: the config's): the JAX
# script's on the card, and the CPU rehearsal's
SIZES = (50_000, None)
TINY_SIZES = (120, 8)
SHARES = (("all_keys", 0.5), ("test_seen", 0.3), ("test_unseen", 0.2))


def default_workdir() -> str:
    return os.path.join(tempfile.gettempdir(), "clibd_soak_extract")


def sizes(device) -> tuple:
    """(records, batch) of a run on `device`."""
    return TINY_SIZES if on_cpu(device) else SIZES


class Paths:
    """The soak's files under its working directory."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.data = os.path.join(workdir, "soakx.hdf5")
        self.root = os.path.join(workdir, "out")
        self.log = os.path.join(workdir, "eval.log")
        self.splits = os.path.join(workdir, "splits.json")
        self.oneshot = os.path.join(workdir, "stream_oneshot.hdf5")
        self.killed = os.path.join(workdir, "stream_killed.hdf5")
        self.summary = os.path.join(workdir, "summary.json")

    def split_sizes(self) -> dict:
        with open(self.splits) as f:
            return json.load(f)


def build(p: Paths, device: str = "cuda"):
    from .soak_train import build as build_synth

    records = sizes(device)[0]
    splits = tuple((name, int(records * share)) for name, share in SHARES)
    build_synth(p.data, splits=splits)
    with open(p.splits, "w") as f:
        json.dump(dict(splits), f)


class _Tee:
    """stdout into a log file too, so the phase report and the extraction
    rates can be parsed afterwards."""

    def __init__(self, path):
        self._f = open(path, "w")
        self._out = sys.stdout

    def write(self, s):
        self._out.write(s)
        self._f.write(s)
        self._f.flush()

    def flush(self):
        self._out.flush()
        self._f.flush()

    def close(self):
        self._f.close()


def overrides(p: Paths, device: str) -> list:
    tiny = [*TINY, f"model_config.batch_size={sizes(device)[1]}"] if on_cpu(device) else []
    return tiny + [f"project_root_path={p.root}", "load_inference=false", "save_inference=true",
                   "model_config.language.enable=true"]


def run(p: Paths, device: str = "cuda", card=None) -> dict:
    import torch

    from ..cli import main as cli_main
    from ..cli.common import _resolve_params
    from ..config import load_config
    from ..data.pipeline import BatchSpec, BioscanLoader
    from ..engine.extract import make_encode_step, to_device

    os.environ["CLIBD_EVAL_TIMING"] = "1"
    os.makedirs(p.root, exist_ok=True)
    tee = _Tee(p.log)
    old = sys.stdout
    sys.stdout = tee
    try:
        t0 = time.time()
        rc = cli_main(["eval", "--hdf5", p.data, "--device", device] + overrides(p, device))
        wall = time.time() - t0
    finally:
        sys.stdout = old
        tee.close()
    if rc != 0:
        raise RuntimeError(f"soak_extract: eval rc={rc}")
    with open(p.log) as f:
        text = f.read()
    rates = [float(r) for r in re.findall(r"encoded \d+ samples \(([\d.]+)/s\)", text)]
    m = re.search(r"extraction \(decode\+encode\)\s+([\d.]+)s", text)
    extract_wall = float(m.group(1)) if m else None

    # the device-only encode of one batch already on the device
    cfg = load_config(overrides=overrides(p, device))
    mc = cfg.model_config
    dev = torch.device(device)
    model = _resolve_params(cfg, dev)
    loader = BioscanLoader(p.data, "all_keys", BatchSpec.eval_spec(mc),
                           num_workers=cfg.pipeline.num_workers,
                           use_native=cfg.pipeline.use_native_decoder)
    batch = next(iter(loader.batches(epoch=0, shuffle=False)))
    loader.close()
    step = make_encode_step(mc, model)
    model_batch = to_device({k: batch[k] for k in ("image", "dna", "language") if k in batch},
                            dev)
    step(model_batch)
    dev_s = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        out = step(model_batch)
        out["image"].cpu()  # waits for the device
        dev_s = min(dev_s, time.perf_counter() - t)
    sizes = p.split_sizes()
    n_total = sum(sizes.values())
    bs = mc.batch_size
    device_busy = dev_s * sum(-(-n // bs) for n in sizes.values())
    summary = {"records": n_total, "batch_size": bs, "endtoend_wall_s": round(wall, 1),
               "extraction_wall_s": extract_wall,
               "sustained_samples_per_s": round(n_total / extract_wall, 1)
               if extract_wall else None,
               "per_split_final_rates": rates, "device_ms_per_batch": round(dev_s * 1e3, 1),
               "device_busy_s": round(device_busy, 1),
               "device_idle_frac": round(max(0.0, 1 - device_busy / extract_wall), 3)
               if extract_wall else None, "device": dev.type, "card": card}
    print(json.dumps(summary), flush=True)
    with open(p.summary, "w") as f:
        json.dump(summary, f)
    return summary


def verify(p: Paths, device: str = "cuda") -> dict:
    import h5py

    from ..cli import main as cli_main
    from ..config import load_config
    from ..engine.extract import load_extracted_features

    folder = None
    for dirpath, _dirs, files in os.walk(os.path.join(p.root, "extracted_embedding")):
        if "extracted_feature_from_test_split.hdf5" in files:
            folder = dirpath
    if folder is None:
        raise RuntimeError("soak_extract verify: run the `run` leg first")
    feat = os.path.join(folder, "extracted_feature_from_test_split.hdf5")
    labels = os.path.join(folder, "labels_test.json")
    ids = os.path.join(folder, "processed_id_test.json")
    sizes = p.split_sizes()
    dim = load_config(overrides=overrides(p, device)).model_config.output_dim

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"soak_extract verify: {what}")

    # 1. the reference's group and dataset layout at scale
    with h5py.File(feat) as f:
        need(set(f.keys()) == {"seen", "unseen", "key"}, f"groups {set(f.keys())}")
        for g, n in (("seen", sizes["test_seen"]), ("unseen", sizes["test_unseen"]),
                     ("key", sizes["all_keys"])):
            for t in ("encoded_image_feature", "encoded_dna_feature",
                      "encoded_language_feature", "averaged_feature"):
                need(f[g][t].shape == (n, dim), f"{g}/{t} {f[g][t].shape}")
            need(f[g]["concatenated_feature"].shape == (n, 2 * dim), f"{g}/concatenated_feature")
        need(f["key"]["all_key_features"].shape == (3 * sizes["all_keys"], dim),
             "key/all_key_features")

    # 2. the load_inference path reads it back
    seen, unseen, keys = load_extracted_features(feat, labels, ids)
    need(len(seen["label_list"]) == sizes["test_seen"], "seen labels")
    need(len(unseen["processed_id_list"]) == sizes["test_unseen"], "unseen ids")
    need(len(keys["all_key_features_label"]) == 3 * sizes["all_keys"], "key labels")
    for d in (seen, unseen, keys):
        norms = np.linalg.norm(d["encoded_image_feature"], axis=1)
        need(np.allclose(norms, 1.0, atol=1e-3), "rows not unit-norm")
    need(np.array_equal(keys["all_key_features"][:sizes["all_keys"]],
                        keys["encoded_image_feature"]), "all_key_features' image rows")

    # 3. a second eval over the cached embeddings gives the same acc_dict
    acc_path = os.path.join(folder, "acc_dict_test.json")
    with open(acc_path) as f:
        first = json.load(f)
    shutil.copy(acc_path, acc_path + ".first")
    reload = [o.replace("load_inference=false", "load_inference=true")
              for o in overrides(p, device)]
    rc = cli_main(["eval", "--hdf5", p.data, "--device", device] + reload
                  + ["inference_and_eval_setting.plot_embeddings=false"])
    need(rc == 0, f"the cached-path eval rc={rc}")
    with open(acc_path) as f:
        second = json.load(f)
    need(first == second, "the cached-path acc_dict differs from the extraction path's")
    print(f"VERIFY OK: schema + round-trip + cached-path acc equality ({feat}, "
          f"{os.path.getsize(feat) / 1e9:.2f} GB)", flush=True)
    return {"feature_file": feat, "acc_dict": first}


def stream(p: Paths, kill_at: int = 0, resume: bool = False, out: str = None,
           device: str = "cuda") -> int:
    """`extract --stream` over all_keys, SIGKILLed past `kill_at` records."""
    from ..cli import main as cli_main

    out = out or p.killed
    if kill_at:
        import h5py

        def watch():
            while True:
                time.sleep(0.05)
                try:
                    with h5py.File(out, "r") as f:
                        if "file_name" in f and f["file_name"].shape[0] >= kill_at:
                            print(f"\nSIGKILL at >={kill_at} records", flush=True)
                            os.kill(os.getpid(), signal.SIGKILL)
                except (OSError, KeyError):
                    continue  # not written yet, or mid-append

        threading.Thread(target=watch, daemon=True).start()
    t0 = time.time()
    args = ["extract", "--hdf5", p.data, "--split", "all_keys", "--out", out, "--stream",
            "--device", device] + overrides(p, device)
    if resume:
        args.append("--resume")
    rc = cli_main(args)
    print(f"stream rc={rc} wall={time.time() - t0:.1f}s -> {out}", flush=True)
    return rc


def stream_compare(p: Paths) -> dict:
    import h5py

    with h5py.File(p.oneshot) as fa, h5py.File(p.killed) as fb:
        if set(fa.keys()) != set(fb.keys()):
            raise RuntimeError(f"stream-compare: datasets {set(fa.keys())} != {set(fb.keys())}")
        for k in fa.keys():
            a, b = fa[k][:], fb[k][:]
            if a.shape != b.shape or not np.array_equal(a, b):
                raise RuntimeError(f"stream-compare: {k} differs")
        rows = int(fa["file_name"].shape[0])
    print(f"STREAM RESUME BIT-IDENTICAL: OK ({p.oneshot} == {p.killed})", flush=True)
    return {"rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["build", "run", "verify", "stream", "stream-compare"])
    ap.add_argument("--kill-at", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    p = Paths(a.workdir or default_workdir())
    os.makedirs(p.workdir, exist_ok=True)
    if a.mode == "build":
        return build(p, a.device)
    if a.mode == "stream-compare":
        return stream_compare(p)
    from ..utils.profiling import require_card

    card = require_card("soak_extract", a.device)
    if a.mode == "run":
        return run(p, a.device, card)
    if a.mode == "verify":
        return verify(p, a.device)
    return stream(p, kill_at=a.kill_at, resume=a.resume, out=a.out, device=a.device)


if __name__ == "__main__":
    main()
