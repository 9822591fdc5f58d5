"""Serving throughput and latency under concurrency: the port of
`tools/bench_serve.py` (`engine/serve.py`'s micro-batching).

    python3 -m clibd_tpu_torch.tools.bench_serve [clients] [requests_per_client] [--device cpu]

Replays one request load (each request a random 224 x 224 JPEG and a
300-bp barcode through `InferenceService.embed`, `clients` threads of
`requests_per_client` requests each) against the service with coalescing
on (window 8 ms, max batch 32) and off (window 0, max batch 1), and reports
requests/s, the mean requests per device batch and p50/p95 client latency
of each, then the ratio of the two rates.  Each service is warmed
(`pre_warm`, then one request a client) before its timed load.

On the card it serves the flagship recipe
(for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml: ViT-B/16
and BarcodeBERT at full width, bf16) from a seeded fresh init, and prints
the card's name and power limit beside the numbers.  `--device cpu` serves
a tiny model instead, only when asked; its numbers say nothing of a card.
"""

from __future__ import annotations

import argparse
import io
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..engine.serve import InferenceService, ServeStats

FLAGSHIP = "for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml"
MODES = (("coalesced", 8.0, 32), ("unbatched", 0.0, 1))  # (label, window ms, max batch)


def make_jpeg(rng: np.random.Generator, h: int = 224, w: int = 224) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def run(service: InferenceService, jpegs, barcodes, clients: int, per_client: int) -> dict:
    """`clients` x `per_client` concurrent embeds → req/s and the service's
    stats over them."""
    reqs = [(jpegs[i % len(jpegs)], barcodes[i % len(barcodes)])
            for i in range(clients * per_client)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        list(pool.map(lambda r: service.embed(image_bytes=r[0], dna=r[1], timeout=600), reqs))
    dt = time.perf_counter() - t0
    s = service.stats.snapshot()
    return {"requests": len(reqs), "req_per_s": len(reqs) / dt, "mean_batch": s["mean_batch_size"],
            "batches": s["batches"], "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"]}


def bench(model, mc, clients: int = 16, per_client: int = 8,
          device: torch.device | str = "cuda") -> dict:
    """The coalesced and unbatched runs on `model` (the port's `CLIBD`, on
    `device`) → {label: run(...)} and the req/s ratio under "speedup"."""
    image_size = mc.image.vit.image_size
    rng = np.random.default_rng(0)
    jpegs = [make_jpeg(rng, image_size, image_size) for _ in range(8)]
    barcodes = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(8)]
    results = {}
    for label, window_ms, max_batch in MODES:
        svc = InferenceService(model, mc, window_ms=window_ms, max_batch=max_batch,
                               image_size=image_size, resize_to=round(image_size * 256 / 224),
                               device=device)
        try:
            svc.pre_warm()
            run(svc, jpegs, barcodes, clients, 1)  # warm the client path
            svc.stats = ServeStats()
            results[label] = run(svc, jpegs, barcodes, clients, per_client)
        finally:
            svc.close()
    results["speedup"] = results["coalesced"]["req_per_s"] / results["unbatched"]["req_per_s"]
    return results


def tiny_config():
    """A narrow image+DNA model for a run on the CPU."""
    from ..config import BertConfig, ExperimentConfig, ViTConfig

    mc = ExperimentConfig()
    mc.output_dim = 16
    mc.language.enable = False
    mc.image.vit = ViTConfig(image_size=64, patch_size=16, hidden_size=32, num_layers=1,
                             num_heads=4, mlp_dim=64)
    mc.dna.bert = BertConfig(vocab_size=1027, hidden_size=32, num_layers=1, num_heads=4,
                             intermediate_size=64, max_position_embeddings=140,
                             with_mlm_head=True)
    return mc


def main(argv: Optional[List[str]] = None) -> int:
    from ..config import load_config
    from ..models import init_clibd_model
    from ..utils.profiling import card_line

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("clients", type=int, nargs="?", default=16)
    ap.add_argument("per_client", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu serves a tiny model, only when asked)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    mc = tiny_config() if device.type == "cpu" else load_config(experiment=FLAGSHIP).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    where = card_line() if device.type == "cuda" else "CPU, tiny model"
    res = bench(model, mc, args.clients, args.per_client, device)
    for label, _, _ in MODES:
        r = res[label]
        print(f"{label}: {r['req_per_s']:.2f} req/s, mean device batch {r['mean_batch']:.2f}, "
              f"p50 {r['p50_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms "
              f"({r['requests']} requests, {args.clients} clients)  [{where}]", flush=True)
    print(f"micro-batching speedup: {res['speedup']:.2f}x  [{where}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
