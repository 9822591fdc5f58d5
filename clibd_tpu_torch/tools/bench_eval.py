"""End-to-end `clibd eval` at BIOSCAN-1M's eval shapes: the port of the
repository's `tools/bench_eval.py`.

    python3 -m clibd_tpu_torch.tools.bench_eval [--seen 20000 --unseen 20000 --keys 21000]
        [--dim 768] [--species 1300] [--device cpu]

Times the port's real `eval` command (`cli/eval_cmds.py`) on a cached
embedding file: the cache's load, the whole kNN grid (9 query/key modality
pairs x 4 taxonomy levels x micro/macro, on the card), the result tables,
CSVs and JSONs, the embedding plots and the HTML report.  The cache holds
synthetic unit-norm embeddings at the reference's eval scale (DATA.md:
~40k test queries, ~21k keys): seen 20k + unseen 20k queries, 21k keys x 3
modalities, 768 wide, ~1.3k species, written with the port's
`save_extracted_features` / `save_labels_and_ids` under
<tmp>/extracted_embedding/<dataset>/<model_output_name>/ (removed after
the run).  The phases come
from the command's own `PhaseTimer` (CLIBD_EVAL_TIMING=1).  The command
writes `logs/` in the working directory, as `clibd eval` does.

Needs h5py (the cache is an HDF5 file).  On the card it prints the card's
name and power limit; `--device cpu` runs the command on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def synth_split(rng, n, dim, n_species, species_names):
    d = {}
    for t in ("encoded_image_feature", "encoded_dna_feature", "encoded_language_feature"):
        x = rng.standard_normal((n, dim), dtype=np.float32)
        d[t] = x / np.linalg.norm(x, axis=1, keepdims=True)
    sp = rng.integers(0, n_species, n)
    d["label_list"] = [{"order": f"o{m % 15}", "family": f"f{m % 120}",
                        "genus": f"g{m % 400}", "species": species_names[m]} for m in sp]
    d["file_name_list"] = [f"rec_{i}" for i in range(n)]
    return d


def write_cache(root: str, seen: int, unseen: int, keys: int, dim: int, species: int) -> str:
    """The synthetic cache the command loads → its folder."""
    from ..config.schema import GlobalConfig
    from ..engine.extract import save_extracted_features, save_labels_and_ids

    rng = np.random.default_rng(0)
    names = [f"sp{m}" for m in range(species)]
    s = synth_split(rng, seen, dim, species, names)
    u = synth_split(rng, unseen, dim, species, names)
    k = synth_split(rng, keys, dim, species, names)
    # all_key_features exactly as extract_split stacks them (3 modalities)
    k["all_key_features"] = np.concatenate([k["encoded_image_feature"], k["encoded_dna_feature"],
                                            k["encoded_language_feature"]])
    k["all_key_features_label"] = k["label_list"] * 3
    mc = GlobalConfig().model_config
    folder = os.path.join(root, "extracted_embedding", mc.dataset, mc.model_output_name)
    os.makedirs(folder, exist_ok=True)
    save_extracted_features(os.path.join(folder, "extracted_feature_from_test_split.hdf5"),
                            s, u, k)
    save_labels_and_ids(os.path.join(folder, "labels_test.json"),
                        os.path.join(folder, "processed_id_test.json"), s, u, k)
    return folder


def run(seen: int = 20_000, unseen: int = 20_000, keys: int = 21_000, dim: int = 768,
        species: int = 1300, device: str = "cuda") -> dict:
    """Write the cache in a temporary directory, run `eval` on it →
    {rc, wall_s, cache_s, acc_dict}."""
    from ..cli import main as cli_main

    root = tempfile.mkdtemp(prefix="bench_eval_")
    old = os.environ.get("CLIBD_EVAL_TIMING")
    os.environ["CLIBD_EVAL_TIMING"] = "1"
    try:
        t0 = time.time()
        folder = write_cache(root, seen, unseen, keys, dim, species)
        cache_s = time.time() - t0
        print(f"synthetic cache written ({cache_s:.1f}s) -> {folder}", flush=True)
        t0 = time.time()
        rc = cli_main(["eval", "--device", device, f"project_root_path={root}",
                       "load_inference=true", "save_inference=true",
                       "model_config.language.enable=true"])
        wall = time.time() - t0
        with open(os.path.join(folder, "acc_dict_test.json")) as f:
            acc_dict = json.load(f)
    finally:
        if old is None:
            os.environ.pop("CLIBD_EVAL_TIMING", None)
        else:
            os.environ["CLIBD_EVAL_TIMING"] = old
        shutil.rmtree(root, ignore_errors=True)
    print(f"\nclibd eval end-to-end: rc={rc}  wall={wall:.1f}s  ({seen + unseen} queries x "
          f"{keys} keys x 3 modalities, dim {dim})", flush=True)
    return {"rc": rc, "wall_s": wall, "cache_s": cache_s, "acc_dict": acc_dict}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seen", type=int, default=20_000)
    ap.add_argument("--unseen", type=int, default=20_000)
    ap.add_argument("--keys", type=int, default=21_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--species", type=int, default=1300)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..utils.profiling import require_card

    require_card("bench_eval", a.device)
    return run(a.seen, a.unseen, a.keys, a.dim, a.species, a.device)


if __name__ == "__main__":
    main()
