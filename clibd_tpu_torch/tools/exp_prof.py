"""Encoder timing per tower on one card, the flagship bench model: the port of
the repository's `tools/exp_prof.py`.

    python3 -m clibd_tpu_torch.tools.exp_prof [both image dna ...] [--device cpu]

The model of `tools/bench.py` (the flagship's ViT-B/16 and BarcodeBERT, no
text tower, no LoRA, a seeded fresh init) in bf16 at batch 256, on the same
inputs (images [256, 224, 224, 3] in [0, 1) and DNA ids [256, 133] from
`np.random.default_rng(0)`): `clibd_apply` on both towers (`run_bench`,
the body of `cli bench`), on the image tower alone and on the DNA tower
alone, each 3 warm-up calls and then the best of 3 passes of 10 calls,
every pass closed by a device sync; ms a batch and samples/s.  On the
card it prints the card's name and power limit; `--device cpu` runs it on
the CPU, only when asked.
"""

from __future__ import annotations

import argparse

import torch

from .bench import BATCH, ITERS, PASSES, WARMUP, bench_inputs, flagship_config, run_bench

MODES = ("both", "image", "dna")


def run(which=MODES, device: torch.device | str = "cuda", batch: int = BATCH) -> dict:
    """{mode: {"ms", "samples_per_s"}} for each mode in `which`; "both" is
    `run_bench`'s measurement on the same model."""
    from ..models.clibd import clibd_apply, init_clibd_model
    from ..utils import profiling

    device = torch.device(device)
    cfg = flagship_config()
    model = init_clibd_model(cfg, torch.Generator().manual_seed(0), device)
    image, dna = bench_inputs(cfg, batch, device)
    inputs = {"image": {"image_input": image}, "dna": {"dna_input": dna}}
    out = {}
    for mode in which:
        if mode == "both":
            dt = batch / run_bench(cfg, batch, device, model=model)["value"]
        else:
            def call():
                with torch.inference_mode():
                    return clibd_apply(model, cfg, compute_dtype=torch.bfloat16, **inputs[mode])

            dt = profiling.timeit(call, device, WARMUP, ITERS, PASSES)
        unit = "img/s" if mode == "image" else "samples/s"
        label = {"both": "both", "image": "image only", "dna": "dna only"}[mode]
        print(f"{label}: {dt * 1e3:.2f} ms/batch  {batch / dt:.1f} {unit}", flush=True)
        out[mode] = {"ms": dt * 1e3, "samples_per_s": batch / dt}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="*", help=f"any of {', '.join(MODES)} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if set(args.which) - set(MODES):
        ap.error(f"modes are {', '.join(MODES)}, got {args.which}")
    from ..utils.profiling import require_card

    require_card("exp_prof", args.device)
    return run(args.which or MODES, args.device)


if __name__ == "__main__":
    main()
