#!/usr/bin/env python3
"""Smoke test of clibd_tpu_torch, the PyTorch and CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: needs `torch.cuda.is_available()`; prints the card's name and
   power limit as nvidia-smi reports them.
2. build: compiles every CUDA kernel of the paths from `clibd_tpu_torch/csrc`
   into `build/kernels/` (one nvcc per source, all started together) and
   prints each build's time and ptxas' register and spill lines.
3. kernels, each against its plain PyTorch version at the three shapes of
   the paths (ViT N=197 H=12, BarcodeBERT N=133 H=12, BERT-small N=20 H=8
   with a random key mask and one fully masked batch row), bf16, at B=64 and
   at the main path's B=500; then kernel, plain version and the closest
   PyTorch library call timed at B=500 with CUDA events (median of 20 runs
   after 3 warm-up runs):
   - `flash_attention_qkv` (forward): max |kernel - plain| <= 2e-2; the
     fully masked row is the mean of V;
   - `flash_attention_qkv_bwd` (backward): max |kernel - plain| <=
     2e-2 * max |plain| for each of dq, dk, dv; and at B=16,
     `torch.autograd.grad` through the attention operator equals the
     backward kernel's own output.
4. eval slice: the flagship tri-modal recipe
   (for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml: ViT-B/16,
   BarcodeBERT, BERT-small, full width, bf16, batch 500, no LoRA), weights
   from a seeded fresh init, over synthetic in-memory splits (all_keys 1100
   rows, test_seen and test_unseen 500 each): extract_split →
   inference_and_eval → format_results.  Checks that every embedding is
   finite and unit-norm, that the grid has entries, that the forward kernel
   ran 28 times per batch (12 ViT + 12 BarcodeBERT + 4 text layers), and
   that on 8 samples the bf16 path agrees with the fp32 path (cosine >= 0.99
   per row).
5. train slice: the same recipe (remat "attn") through the port's
   `Trainer` with epochs=2 and eval_skip_epoch=-1, over a synthetic train
   split of 3000 rows (6 steps per epoch) and all_keys 1100, val_seen 500,
   val_unseen 500, checkpoints in a temporary directory.  Checks: every
   loss finite; after the first step every trainable parameter has a
   finite, nonzero gradient; 28 forward and 28 backward kernel launches per
   step (the "attn" policy does not re-run the forward kernel); both evals
   give a grid; last/ and best/ are written and best/ loads back; 5 steps on
   one fixed batch at a constant LR of 5e-5 lower its loss; and on 16
   samples the bf16 gradients through the kernels agree with those through
   the plain versions on the card (cosine >= 0.99 per parameter tensor).
   Prints train samples/s over the steps after each epoch's first
   (CUDA-synchronised) and the peak device memory.

The last three lines are the kernel summary JSON, the card line, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

KERNEL_TOL = 2e-2      # forward, max |kernel - plain| on unit-scale inputs: ~1 bf16 ulp of P x |V|
BWD_REL_TOL = 2e-2     # backward, per part, relative to the part's max |plain|
COSINE_MIN = 0.99      # bf16 vs fp32 path per embedding row; kernel vs plain gradients per tensor
SHAPES = (("vit", 197, 12, False), ("barcode_bert", 133, 12, False), ("bert_small", 20, 8, True))
EXPERIMENT = "for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml"
SPLIT_ROWS = {"all_keys": 1100, "test_seen": 500, "test_unseen": 500}
TRAIN_ROWS = {"train": 3000, "all_keys": 1100, "val_seen": 500, "val_unseen": 500}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores, published


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms the card could take, what bounds it) from the published
    memory rate and bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def make_qkv(B, N, H, masked, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * 64, generator=g, device="cuda").to(torch.bfloat16)
    mask = None
    if masked:
        keep = torch.rand(B, N, generator=g, device="cuda") > 0.3
        keep[:, 0] = True
        keep[0] = False  # one batch row with every key masked
        mask = (~keep).float() * torch.finfo(torch.float32).min
    return qkv, mask


def library_attention(qkv, H, mask):
    """The closest single PyTorch call, for timing only: scaled dot-product
    attention on head-split views of qkv."""
    import torch.nn.functional as F

    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (t.view(B, N, H, 64).transpose(1, 2) for t in qkv.split(D, dim=-1))
    bias = None if mask is None else mask[:, None, None, :].to(qkv.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def kernel_entry(name, source, replaces, shapes):
    """The summary line's entry: the ViT shape, which carries most of the
    time, gives ms / plain_ms / bound / library_ms; every shape is kept."""
    vit = shapes[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": vit["ms"], "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
            "bound_by": vit["bound_by"], "library_ms": vit["library_ms"], "by_shape": shapes}


def forward_kernel_phase(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.attention import (flash_attention_qkv_cuda,
                                               flash_attention_qkv_reference)
    from clibd_tpu_torch.utils.profiling import cuda_ms

    shapes = []
    for name, N, H, masked in SHAPES:
        err = 0.0
        for B in (64, 500):  # 500: the main path's batch
            qkv, mask = make_qkv(B, N, H, masked, seed=N + B)
            got = flash_attention_qkv_cuda(qkv, H, mask).float()
            want = flash_attention_qkv_reference(qkv, H, mask).float()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"forward kernel output not finite at {name} B={B}")
            err_b = float((got - want).abs().max())
            if masked:  # the fully masked row is the mean of V over every key
                v = qkv[0, :, 2 * H * 64:].float()
                uni = v.mean(0, keepdim=True).expand(N, -1)
                err_uniform = float((got[0] - uni).abs().max())
                if err_uniform > KERNEL_TOL:
                    fail(f"fully masked row not uniform: max|Δ| {err_uniform}")
            print(f"kernel flash_attention_qkv {name} B={B} N={N} H={H} mask={masked}: "
                  f"max|kernel-plain| {err_b:.3e} (tol {KERNEL_TOL})")
            if err_b > KERNEL_TOL:
                fail(f"forward kernel disagrees with its plain version at {name} B={B}: "
                     f"{err_b} > {KERNEL_TOL}")
            err = max(err, err_b)
            del got, want
        ms = cuda_ms(lambda: flash_attention_qkv_cuda(qkv, H, mask))
        plain_ms = cuda_ms(lambda: flash_attention_qkv_reference(qkv, H, mask))
        library_ms = cuda_ms(lambda: library_attention(qkv, H, mask))
        D = H * 64
        flops = 4 * 500 * H * N * N * 64
        nbytes = 500 * N * (3 * D + D) * 2 + (500 * N * 4 if masked else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"time flash_attention_qkv {name} B=500: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"library (sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        shapes.append({"shape": name, "B": 500, "N": N, "H": H, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": err})
        del qkv, mask
    torch.cuda.empty_cache()
    return kernel_entry("flash_attention_qkv", "clibd_tpu_torch/csrc/flash_attention_qkv.cu",
                        "clibd_tpu/ops/pallas/attention.py:143", shapes)


def backward_kernel_phase(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.attention import (
        flash_attention_qkv,
        flash_attention_qkv_bwd_cuda,
        flash_attention_qkv_bwd_reference,
    )
    from clibd_tpu_torch.utils.profiling import cuda_ms

    shapes = []
    for name, N, H, masked in SHAPES:
        D = H * 64
        err = 0.0
        for B in (64, 500):
            qkv, mask = make_qkv(B, N, H, masked, seed=N + B + 1)
            g = torch.Generator(device="cuda").manual_seed(N * B)
            dout = torch.randn(B, N, D, generator=g, device="cuda").to(torch.bfloat16)
            got = flash_attention_qkv_bwd_cuda(qkv, dout, H, mask).float()
            want = flash_attention_qkv_bwd_reference(qkv, dout, H, mask).float()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"backward kernel output not finite at {name} B={B}")
            rel = []
            for i, part in enumerate(("dq", "dk", "dv")):
                a, b = got[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D]
                rel.append(float((a - b).abs().max() / b.abs().max()))
            err = max(err, float((got - want).abs().max()))
            print(f"kernel flash_attention_qkv_bwd {name} B={B} N={N} H={H} mask={masked}: "
                  f"max|kernel-plain|/max|plain| dq {rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} "
                  f"(tol {BWD_REL_TOL})")
            if max(rel) > BWD_REL_TOL:
                fail(f"backward kernel disagrees with its plain version at {name} B={B}: {rel}")
            del got, want
        ms = cuda_ms(lambda: flash_attention_qkv_bwd_cuda(qkv, dout, H, mask))
        plain_ms = cuda_ms(lambda: flash_attention_qkv_bwd_reference(qkv, dout, H, mask))
        leaf = qkv.detach().requires_grad_()
        lib_out = library_attention(leaf, H, mask)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, dout.view(500, N, H, 64)
                                                         .transpose(1, 2), retain_graph=True))
        flops = 10 * 500 * H * N * N * 64  # S, dP, dV, dQ, dK
        nbytes = 500 * N * (3 * D + D + 3 * D) * 2 + (500 * N * 4 if masked else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"time flash_attention_qkv_bwd {name} B=500: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"library (sdpa backward) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
              f"  [{card}]")
        shapes.append({"shape": name, "B": 500, "N": N, "H": H, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": err})
        del qkv, mask, dout, leaf, lib_out
    torch.cuda.empty_cache()

    # autograd through the operator runs the backward kernel (B=16, text shape)
    qkv, mask = make_qkv(16, 20, 8, True, seed=5)
    leaf = qkv.detach().requires_grad_()
    dout = torch.randn(16, 20, 512, device="cuda", dtype=torch.bfloat16)
    (grad,) = torch.autograd.grad(flash_attention_qkv(leaf, 8, mask), leaf, dout)
    if not torch.equal(grad, flash_attention_qkv_bwd_cuda(qkv, dout, 8, mask)):
        fail("autograd through the attention operator differs from the backward kernel")
    print("autograd.grad through the operator equals the backward kernel's output (B=16)")
    return kernel_entry("flash_attention_qkv_bwd",
                        "clibd_tpu_torch/csrc/flash_attention_qkv_bwd.cu",
                        "clibd_tpu/ops/pallas/attention.py:229", shapes)


def eval_slice_phase(card: str, fwd_entry: dict, mc, device, split_rows: dict) -> None:
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.evaluate import format_results, inference_and_eval
    from clibd_tpu_torch.engine.extract import extract_split, make_encode_step, to_device
    from clibd_tpu_torch.models import clibd_apply, init_clibd_model
    from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_bwd

    t0 = time.perf_counter()
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    splits = {name: SyntheticSplit(name, n, mc, seed=i)
              for i, (name, n) in enumerate(split_rows.items())}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"eval slice set-up: {n_params / 1e6:.1f} M params, synthetic splits "
          f"{ {k: len(v.ids()) for k, v in splits.items()} } in {time.perf_counter() - t0:.1f} s")

    # warm-up: 8 samples through the bf16 path (cuBLAS handles, kernel load)
    b = next(splits["test_seen"].batches())
    small = to_device({"image": b["image"][:8], "dna": b["dna"][:8],
                       "language": {k: v[:8] for k, v in b["language"].items()}}, device)
    make_encode_step(mc, model, torch.bfloat16)(small)
    torch.cuda.synchronize()

    flash_attention_qkv.launches = flash_attention_qkv_bwd.launches = 0
    t0 = time.perf_counter()
    keys_dict = extract_split(model, mc, splits["all_keys"], for_key_set=True)
    seen_dict = extract_split(model, mc, splits["test_seen"])
    unseen_dict = extract_split(model, mc, splits["test_unseen"])
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    launches = flash_attention_qkv.launches
    n_batches = sum(len(s) for s in splits.values())
    n_rows = sum(split_rows.values())
    per_batch = (mc.image.vit.num_layers + mc.dna.bert.num_layers
                 + mc.language.bert.num_layers)
    print(f"flash_attention_qkv launches in the eval slice: {launches} "
          f"(expected {per_batch} x {n_batches} batches = {per_batch * n_batches})")
    if launches != per_batch * n_batches or flash_attention_qkv_bwd.launches:
        fail(f"eval path launched the forward kernel {launches} times, expected "
             f"{per_batch * n_batches}, and the backward {flash_attention_qkv_bwd.launches} times")
    fwd_entry["launches"] = launches

    t0 = time.perf_counter()
    acc_dict, _, _ = inference_and_eval(keys_dict, seen_dict, unseen_dict, k_list=[1, 3, 5],
                                        query_chunk=4096, with_preds=False, device=device)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    table, csv_rows, _, _ = format_results(acc_dict, [1, 3, 5], "I,D,T")
    if len(csv_rows) < 2 or not acc_dict:
        fail("the kNN grid is empty")
    lines = table.splitlines()
    print(f"kNN grid: {len(csv_rows) - 1} rows; the table's head:")
    print("\n".join(lines[:6]))

    for name, d in (("all_keys", keys_dict), ("test_seen", seen_dict),
                    ("test_unseen", unseen_dict)):
        for m in ("image", "dna", "language"):
            emb = d[f"encoded_{m}_feature"]
            if emb.shape != (split_rows[name], mc.output_dim) or not np.isfinite(emb).all():
                fail(f"{name} {m} embeddings: shape {emb.shape} or not finite")
            norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
            if norm_err > 1e-3:
                fail(f"{name} {m} embeddings not unit-norm: max |norm-1| {norm_err}")
    if keys_dict["all_key_features"].shape != (3 * split_rows["all_keys"], mc.output_dim):
        fail(f"all_key_features shape {keys_dict['all_key_features'].shape}")

    print(f"extraction: {n_rows} samples in {t_extract:.3f} s = {n_rows / t_extract:.2f} "
          f"samples/s (bf16, batch {mc.batch_size}, tri-modal, {n_batches} batches incl. "
          f"ragged)  [{card}]")
    print(f"kNN grid + metrics: {t_knn:.3f} s  [{card}]")

    # bf16 kernel path against the fp32 path on the 8 warm-up samples
    with torch.inference_mode():
        lo = clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                         compute_dtype=torch.bfloat16)
        hi = clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                         compute_dtype=torch.float32)
    for m in ("image", "dna", "language"):
        cos = (lo[m] * hi[m]).sum(-1) / (lo[m].norm(dim=-1) * hi[m].norm(dim=-1))
        print(f"bf16 vs fp32 path, {m}: min cosine {float(cos.min()):.6f} (need >= {COSINE_MIN})")
        if float(cos.min()) < COSINE_MIN:
            fail(f"bf16 path disagrees with the fp32 path for {m}")


def train_slice_phase(card: str, fwd_entry: dict, bwd_entry: dict, gcfg, device) -> None:
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.train import (
        ScheduledAdamW,
        Trainer,
        batch_generator,
        make_loss_fn,
        make_train_step,
    )
    from clibd_tpu_torch.models import init_clibd_model, load_model_npz
    from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_bwd
    from clibd_tpu_torch.tools.profile_extract import plain_attention

    mc = gcfg.model_config
    t0 = time.perf_counter()
    splits = {name: SyntheticSplit(name, n, mc, seed=10 + i)
              for i, (name, n) in enumerate(TRAIN_ROWS.items())}
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    n_trainable = sum(p.numel() for _, p in trainable)
    print(f"train slice set-up: {len(trainable)} trainable tensors, {n_trainable / 1e6:.1f} M "
          f"params, remat={mc.remat} policy={mc.remat_policy!r}, splits "
          f"{ {k: len(v.ids()) for k, v in splits.items()} } in {time.perf_counter() - t0:.1f} s")

    logs = []
    # checkpoints (last/ and best/, params and AdamW state) go to a temporary
    # directory that is removed with everything in it
    with tempfile.TemporaryDirectory(prefix="clibd_train_") as out_dir:
        trainer = Trainer(gcfg, None, out_dir, train_loader=splits["train"],
                          eval_loader_factory=lambda split, train: splits[split], model=model,
                          log_fn=logs.append, device=device)
        per_step = []  # (forward, backward) kernel launches of each train step
        step_fn = trainer.step_fn

        def counted_step(batch, gen):
            f0, b0 = flash_attention_qkv.launches, flash_attention_qkv_bwd.launches
            loss = step_fn(batch, gen)
            per_step.append((flash_attention_qkv.launches - f0,
                             flash_attention_qkv_bwd.launches - b0))
            if len(per_step) == 1:  # the first step's gradients are still on the parameters
                bad = [n for n, p in trainable
                       if p.grad is None or not bool(torch.isfinite(p.grad).all())
                       or float(p.grad.abs().max()) == 0.0]
                if bad:
                    fail(f"after the first step {len(bad)} trainable tensors have no finite "
                         f"nonzero gradient: {bad[:8]}")
                print(f"first step: all {len(trainable)} trainable tensors have a finite, nonzero "
                      f"gradient")
            return loss

        trainer.step_fn = counted_step
        flash_attention_qkv.launches = flash_attention_qkv_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = trainer.fit()
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer.close()
        n_layers = mc.image.vit.num_layers + mc.dna.bert.num_layers + mc.language.bert.num_layers
        steps = mc.epochs * len(splits["train"])
        print(f"kernel launches per train step (forward, backward): {sorted(set(per_step))} over "
              f"{len(per_step)} steps (expected ({n_layers}, {n_layers}) x {steps})")
        if len(per_step) != steps or set(per_step) != {(n_layers, n_layers)}:
            fail(f"train steps launched {per_step}, expected ({n_layers}, {n_layers}) x {steps}")
        bwd_entry["launches"] = flash_attention_qkv_bwd.launches
        fwd_entry["launches"] += flash_attention_qkv.launches  # train steps and both evals
        losses = [d["loss"] for d in logs if "loss" in d]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"train losses {losses}")
        grids = [d for d in logs if any("||top-" in k for k in d)]
        if len(history["overall_acc"]) != 2 or len(grids) != 2 or not all(grids):
            fail(f"expected two evals with a grid each: {history['overall_acc']}")
        for sub in ("last", "best"):
            if not os.path.exists(os.path.join(out_dir, sub, "params.npz")):
                fail(f"{sub}/ was not written")
        reloaded = load_model_npz(os.path.join(out_dir, "best"), mc, device)
        n_reloaded = sum(p.numel() for p in reloaded.parameters())
        if n_reloaded != sum(p.numel() for p in model.parameters()):
            fail("best/ reloads with another parameter count")
        del reloaded
    rates = [d["throughput/samples_per_sec_per_chip"] for d in logs
             if "throughput/samples_per_sec_per_chip" in d]
    print(f"train losses: {[round(v, 4) for v in losses]}")
    print(f"evals: overall_acc {history['overall_acc']}, best epoch {history['best_epoch']}")
    print(f"train: {steps} steps of batch {mc.batch_size} + 2 evals in {t_fit:.2f} s; samples/s "
          f"over the steps after each epoch's first (CUDA-synchronised): "
          f"{[round(r, 2) for r in rates]}, mean {sum(rates) / len(rates):.2f}; peak device "
          f"memory {peak_gb:.2f} GiB  [{card}]")

    # 5 steps on one fixed batch at a constant LR lower its loss
    fixed = to_device({k: v for k, v in next(splits["train"].batches()).items() if k != "index"},
                      device)
    opt = ScheduledAdamW([p for _, p in trainable], lambda i: 5e-5,
                         betas=(mc.optim.beta1, mc.optim.beta2), eps=mc.optim.eps,
                         weight_decay=mc.optim.weight_decay)
    step = make_train_step(mc, model, opt)
    loss_fn = make_loss_fn(mc, model)
    fixed_losses = [float(step(fixed, batch_generator(device, 0, 0, 0))) for _ in range(5)]
    with torch.no_grad():
        fixed_losses.append(float(loss_fn(fixed, batch_generator(device, 0, 0, 0))))
    print(f"fixed batch, constant LR 5e-5: losses {[round(v, 5) for v in fixed_losses]}")
    if not fixed_losses[-1] < fixed_losses[0]:
        fail("5 steps on a fixed batch did not lower its loss")
    opt.zero_grad(set_to_none=True)

    # kernels against the plain versions on the card: bf16 gradients, 16 samples
    small = to_device({"image": fixed["image"][:16].cpu().numpy(),
                       "dna": fixed["dna"][:16].cpu().numpy(),
                       "language": {k: v[:16].cpu().numpy() for k, v in fixed["language"].items()},
                       "label": fixed["label"][:16].cpu().numpy()}, device)
    params = [p for _, p in trainable]

    def grads():
        loss = loss_fn(small, batch_generator(device, 0, 0, 1))
        return [g.float() for g in torch.autograd.grad(loss, params)]

    with_kernels = grads()
    with plain_attention():
        with_plain = grads()
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(with_kernels, with_plain)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    print(f"bf16 gradients, kernels vs plain versions on the card (16 samples): min cosine "
          f"{cos[worst]:.6f} at {trainable[worst][0]} over {len(cos)} tensors "
          f"(need >= {COSINE_MIN})")
    if not all(c >= COSINE_MIN for c in cos):
        fail("gradients through the kernels disagree with the plain versions")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import clibd_tpu_torch  # noqa: F401  (fails where the repo is absent)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    from clibd_tpu_torch.ops.cuda_build import BUILD_INFO, build_libraries

    t0 = time.perf_counter()
    build_libraries(["flash_attention_qkv", "flash_attention_qkv_bwd"])
    print(f"build: both kernel sources in parallel, {time.perf_counter() - t0:.2f} s wall")
    for name, info in BUILD_INFO.items():
        print(f"build {name}.cu: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    fwd = forward_kernel_phase(card)
    bwd = backward_kernel_phase(card)
    from clibd_tpu_torch.config import load_config

    gcfg = load_config(experiment=EXPERIMENT,
                       overrides=["model_config.epochs=2", "model_config.eval_skip_epoch=-1"])
    mc = gcfg.model_config
    if not (mc.amp and mc.disable_lora and mc.batch_size == 500 and mc.image.enable
            and mc.dna.enable and mc.language.enable and mc.remat and mc.remat_policy == "attn"):
        fail(f"{EXPERIMENT} is not the bf16 tri-modal full fine-tune recipe at batch 500 "
             "with remat 'attn'")
    eval_slice_phase(card, fwd, mc, torch.device("cuda"), SPLIT_ROWS)
    train_slice_phase(card, fwd, bwd, gcfg, torch.device("cuda"))
    if "jax" in sys.modules or any(m == "clibd_tpu" or m.startswith("clibd_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported: the port must run without them")

    print(json.dumps({"kernels": [fwd, bwd]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
