"""Embedding: the program's `extract_split` over the pool's batches, host
arrays in and host embeddings out.

Set-up builds the model with the weights drawn from the seed and warms
`extract_split` up on two pool batches.  The window is one
`extract_split` call whose loader cycles the pool until the first batch
asked for `--seconds` after the start; it ends when the call has returned
the split's arrays.  After it, with the model freed, the plain reference
encodes every pool row once and every returned row is compared with its
own.

`embed_samples_per_s` is every row returned over the window's time.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.core import compare, counts, inputs
from benchmark.core.loader import PoolLoader
from benchmark.core.program import build_model, free, to_device_batch
from benchmark.core.trace import Reading, TraceSession
from benchmark.core.weights import draw_weights

MODE = "embed"
FEATURES = {"image": "encoded_image_feature", "dna": "encoded_dna_feature",
            "language": "encoded_language_feature"}


def reference_rows(ctx, pool, precision: str = "fp32") -> dict:
    """The reference's unit embeddings of every pool row: {modality:
    [pool batches, rows, d]}."""
    import torch

    ref = ctx.cell.reference
    ref.no_tf32()
    P = draw_weights(ref.param_shapes(ctx.cell.widths), ref.init_kind, ctx.seed, ctx.device)
    block = ctx.cell.checks["block_rows"]
    out = {m: [] for m in ctx.cell.traffic["modalities"]}
    with torch.no_grad():
        for batch in pool:
            b = to_device_batch(batch, ctx.device)
            B = b["label"].shape[0]
            parts = []
            for lo in range(0, B, block):
                rows = inputs.take_rows(b, lo, min(lo + block, B))
                images = rows["image"].float() / 255.0 if "image" in rows else None
                parts.append(ref.encode(P, ctx.cell.widths, images, rows.get("dna"),
                                        rows.get("language"), precision))
            for m in out:
                out[m].append(torch.cat([p[m] for p in parts]).double().cpu().numpy())
    return {m: np.stack(v) for m, v in out.items()}


def run(ctx) -> dict:
    import torch
    from clibd_tpu_torch.engine.extract import extract_split

    cell, t = ctx.cell, ctx.cell.traffic
    gcfg = ctx.program_config()
    mc = gcfg.model_config
    B = t["batch_size"]
    ref = cell.reference
    pool = inputs.make_pool(cell.widths, ctx.seed, t["pool_batches"], B, t["modalities"])
    ctx.mark("pool")
    weights = draw_weights(ref.param_shapes(cell.widths), ref.init_kind, ctx.seed, ctx.device)
    model = build_model(mc, weights, ctx.device)
    del weights
    ctx.mark("model")
    loader = PoolLoader(pool, t["pool_batches"], B)
    loader.plan(t["warmup_batches"])
    extract_split(model, mc, loader, for_key_set=t["key_set"])
    ctx.sync()
    setup_s = time.time() - ctx.t_start
    ctx.mark("setup")

    session = TraceSession(t["trace_start"], t["trace_units"], ctx.sync) if ctx.trace else None
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.sync()
    t0 = time.perf_counter()
    loader.window(t0, ctx.seconds, session)
    out = extract_split(model, mc, loader, for_key_set=t["key_set"])
    ctx.sync()
    elapsed = time.perf_counter() - t0
    if session is not None:
        session.finish()
    sequence, asked = list(loader.sequence), loader.asked
    rows = len(sequence) * B
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    reading = None
    if session is not None and session.events is not None:
        traced = [sequence[i] for i in session.traced]
        total = None
        for p in traced:
            total = counts.add_counts(total, counts.batch_counts(cell.widths, pool[p], MODE,
                                                                 False, ctx.peaks))
        reading = Reading(MODE, session.events, session.window_s, len(traced), len(traced) * B,
                          total, ctx.peaks, cell.chips)
    returned = {m: out[FEATURES[m]] for m in t["modalities"]}
    del model, out
    free()
    ctx.mark("window and trace")

    ref_rows = reference_rows(ctx, pool)
    idx = np.repeat(np.asarray(sequence), B), np.tile(np.arange(B), len(sequence))
    missing = sum(abs(rows - (0 if v is None else v.shape[0])) for v in returned.values())
    if missing:
        numbers = {f"{m}_gap": float("inf") for m in returned}
    else:
        numbers = compare.row_gaps(returned, {m: ref_rows[m][idx] for m in returned})
    ctx.mark("reference")
    return {"e2e": {"embed_samples_per_s": rows / elapsed, "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": setup_s},
            "attempted": rows, "failed": missing, "numbers": numbers,
            "memory_peak_bytes": peak, "reading": reading,
            "window": {"batches": len(sequence), "seconds": elapsed, "samples": rows,
                       "asked_s": [round(x, 4) for x in asked]}}
