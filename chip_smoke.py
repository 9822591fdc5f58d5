#!/usr/bin/env python3
"""Smoke test of clibd_tpu_torch, the PyTorch and CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: needs `torch.cuda.is_available()`; prints the card's name and
   power limit as nvidia-smi reports them.
2. build: compiles every CUDA kernel of the paths from `clibd_tpu_torch/csrc`
   into `build/kernels/` (one nvcc per source, all started together) and
   prints each build's time and ptxas' register, spill and C75xx lines; the
   forward and the backward kernels of the main path, the three kernels on
   the wgmma attention core (phased, batched, attention_bhnd) and the phased
   backward, all on wgmma, must keep every instance within 216 bytes of
   stack and have no warpgroup.arrive injected (C7519), as before the core
   took its layout policies.
3. kernels, each against its plain PyTorch version at the four shapes of
   the paths (ViT N=197 H=12, BarcodeBERT N=133 H=12, BERT-small N=20 H=8
   and the overlap-tokenizer BarcodeBERT N=657 H=12, the last two with a
   random key mask and one fully masked batch row), bf16, at B=64 and at the
   main path's B=500 (N=657: B=64 only, where the plain version's
   [B, H, N, N] fp32 intermediates take 1.3 GB, not 10); then kernel and
   the closest PyTorch library call timed at B=500, the plain version at
   the batch it was compared at, with CUDA events (median of 20 runs after
   3 warm-up runs):
   - `flash_attention_qkv` (forward): max |kernel - plain| <= 2e-2; the
     fully masked row is the mean of V; N=300, which the kernels refused
     before they streamed the keys, is taken and agrees; so do its edges
     (FWD_EDGES: N = 1, 63, 64, 65, 127, 128, 129, 256, 257 and 657 at
     B = 1, 3, 5 and H = 1, 8, 12, each with and without a mask); its time
     is printed beside the mma.sync design's recorded one (FWD_RECORDED_MS);
   - `flash_attention_qkv_bwd` (backward): max |kernel - plain| <=
     2e-2 * max |plain| for each of dq, dk, dv, at the four shapes and at
     its edges (BWD_EDGES: N = 1, 63, 64, 65, 127, 128, 129, 207, 208, 209,
     256, 257, 300 and 657 at B = 1, 3, 5 and H = 1, 8, 12, each with and
     without a mask, so either side of the whole-row route's 208 keys); two
     launches give the same bits at ViT B=500 and at N=657 B=64; the route
     each shape took, its TFLOP/s and the mma.sync design's recorded time
     (BWD_RECORDED_MS) are printed beside its time; and at B=16,
     `torch.autograd.grad` through the attention operator equals the
     backward kernel's own output;
   - `layernorm` and `layernorm_bwd` (bf16, fast math) at the towers' rows
     at batch 500 (LN_SHAPES: ViT R=500*197 and BarcodeBERT R=500*133 and
     500*657 at D=768, BERT-small R=500*20 at D=512): y, dx, dscale and
     dbias within 1e-2 * max |plain| (LN_REL_TOL), the row statistics to a
     bf16 ulp; two launches of each give the same bits at ViT; kernel,
     plain version, autograd through the plain forward (the backward the
     port ran before the kernel), library (`torch.nn.functional.layer_norm`
     and `aten.native_layer_norm_backward`, timed only) and bound ms
     (4 and 6 bytes an element) for both directions.
4. eval slice: the flagship tri-modal recipe
   (for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml: ViT-B/16,
   BarcodeBERT, BERT-small, full width, bf16, batch 500, no LoRA), weights
   from a seeded fresh init, over synthetic in-memory splits (all_keys 1100
   rows, test_seen and test_unseen 500 each): extract_split →
   inference_and_eval → format_results.  Checks that every embedding is
   finite and unit-norm, that the grid has entries, that the forward kernel
   ran 28 times per batch (12 ViT + 12 BarcodeBERT + 4 text layers), that
   the LayerNorm kernel ran once a LayerNorm module and twice a block a
   batch (60: ViT 25, DNA 26, text 9), and that on 8 samples the bf16 path agrees with the fp32 path (cosine >= 0.99
   per row).  The same, labelled "overlap", for the BIOSCAN-5M new
   BarcodeBERT recipe (for_bioscan_5m/barcodeBERT_trained_with_5m/
   image_dna_text_seed_42_new_barcodeBERT_5M.yaml: the overlap tokenizer,
   k=4 stride 1, so the DNA tower has N=657 with a key mask; same widths,
   bf16, batch 500), after phase 5's flagship run.
5. train slice: the same recipe (remat "attn") through the port's
   `Trainer` with epochs=2 and eval_skip_epoch=-1, over a synthetic train
   split of 3000 rows (6 steps per epoch) and all_keys 1100, val_seen 500,
   val_unseen 500, checkpoints in a temporary directory.  Checks: every
   loss finite; after the first step every trainable parameter has a
   finite, nonzero gradient; 28 forward and 28 backward kernel launches per
   step (the "attn" policy does not re-run the forward kernel); 116 forward
   and 60 backward LayerNorm launches per step (the 60 of a batch and the
   56 inside the blocks again, which the policy recomputes); both evals
   give a grid; last/ and best/ are written and best/ loads back; 5 steps on
   one fixed batch at a constant LR of 5e-5 lower its loss; and on 16
   samples the bf16 gradients through the kernels agree with those through
   the plain versions on the card (cosine >= 0.99 per parameter tensor).
   Prints train samples/s over the steps after each epoch's first
   (CUDA-synchronised) and the peak device memory.  Then the overlap recipe
   through phase 4 and through this phase with epochs=1 over a train split
   of 2000 rows (4 steps, one eval), the same checks (28 forward and 28
   backward launches per step: 12 ViT + 12 DNA at N=657 + 4 text).  Last,
   kNN on the card with every key three times: the indices of equal scores
   in index order for k = 1..8, as jax.lax.top_k gives them.

6. out-projection kernel: `flash_attention_qkv_outproj` (attention with the
   out-projection fused in) against its plain version, with a random W_out
   and bias, first at the bf16 kernel's edges (N = 1, 63, 64, 65; B = 1 and
   odd B; H = 2, 4, 6, 8, 12; a fully masked batch row), then at the same four
   shapes at B=64 and B=500 (N=657: B=64; the fully masked row included):
   max |kernel - plain| <= 2e-2 * max |plain|; two launches at ViT B=500
   bit-identical; kernel and the library yardstick (SDPA, then addmm) timed
   at B=500, the plain version at the batch it was compared at, beside
   TFLOP/s and the kernel's modelled W_out reads from L2; and at B=16
   `torch.autograd.grad` through the operator,
   for qkv, W_out and the bias, equals the composed backward (W_out^T
   product, the backward kernel, the forward kernel's ctx for dW).
7. fused-MLP kernel: `fused_mlp` against its plain version at (R, D, F) =
   (500*197, 768, 3072), (500*133, 768, 3072) and (500*77, 512, 2048) with
   gelu_tanh, at R = 64*197 and the ragged 63*197 with gelu and with
   quick_gelu, and at the edges of the kernel's ring and cluster (R = 1, 37,
   64, 65 and 64*3 at D=768, F=3072; F = 64 and 128; D = 512 and 256):
   max |kernel - plain| <= 2e-2 * max |plain|; two launches at the first
   shape bit-identical; kernel, plain version and the yardstick (addmm, tanh
   GELU, addmm) timed at the first three, beside the kernel's modelled weight
   reads from L2; then the L2's copy rate (scale_copy and torch.mul on 4-16
   MB, the slope of time against bytes).
8. BioCLIP eval: the recipe
   for_bioscan_1m/image_bind_style/with_bioclip_bind_to_image.yaml (CLIP
   ViT-B/16, the 12-layer causal CLIP text tower at D=512, BarcodeBERT, embed
   512, bf16, batch 500) with both opt-in kernels on
   (`CLIBD_ATTN_FUSE_OUTPROJ=1`, `CLIBD_MLP_IMPL=pallas`) over the same
   synthetic splits, through extract_split and the kNN grid.  Checks finite
   unit-norm 512-d embeddings, a non-empty grid, per batch 24 out-projection
   launches (12 ViT + 12 BarcodeBERT), 36 fused-MLP launches (12 per tower)
   and no launch of the plain forward kernel (the causal text attention is
   eager), and on 8 samples the bf16 path against the fp32 path and the
   kernels on against off (cosine >= 0.99 per row).
9. BioCLIP train: 4 steps of batch 500 of the same recipe with the kernels
   on (image and text towers frozen, BarcodeBERT and logit_scale train,
   bind_to image, remat "attn").  Checks finite losses, a finite nonzero
   gradient on every trainable tensor after the first step, per step 24
   out-projection, 48 fused-MLP (36 forward + the 12 BarcodeBERT layers
   recomputed under "attn"), 12 forward-kernel (the out-projection backward
   recomputes ctx) and 12 backward-kernel launches, and on 16 samples the
   bf16 gradients through the kernels against the plain versions (cosine >=
   0.99 per tensor).  Prints samples/s over the steps after the first and
   the peak device memory.

10. probes: the kernels of the chip-probe harnesses, each against its plain
   version, then timed beside the plain version, the closest library call
   and the bound (CUDA events, median of 20):
   - `scale_copy` on a seeded fp32 [8192, 2048] and at its edges (1, 3, 4,
     5 and 1027 elements, one vector past a 16 KB ring slot, and a size
     that wraps every CTA's ring with a ragged end): bit-exact; two
     launches bit-identical; GB/s against 3.35 TB/s; library
     `torch.mul(x, 2.0)` and `y.copy_(x)`;
   - `tiled_matmul` (bf16 in, fp32 accumulator), every tile, fp32 and bf16
     out, at 1024^3, 2048^3, 8192^3, M=4096 N=8192 K=2048 (a tile count no
     multiple of the SMs') and K=64 (one slot): max |kernel - plain| <=
     1e-3 * max |plain| (fp32 out), 1e-2 * max |plain| (bf16 out); two
     launches bit-identical; TFLOP/s against 989 and cuBLAS bf16
     `torch.matmul` at every shape; a shape off the tile raises and launches
     nothing;
   - `attention_bhnd` (separate q, k, v) first at its edges (N = 1, 63, 64,
     65, 197 and 256; B = 1 and odd B; H = 1 and 12), then at B=256 N=197,
     B=64 N=133 and B=64 N=20 (H=12): max |kernel - plain| <= 2e-2; two
     launches bit-identical; SDPA on the same q/k/v.
   Then the probes path: the three harnesses as a user runs them
   (`clibd_tpu_torch.tools.exp_attn` all and extra, `exp_mxu`, `exp_mxu2`
   with every variant), each printing its own lines; each of the three
   kernels must launch in it, the four earlier ones not at all, and every
   GEMM row the harnesses print must be within the tolerances above.
11. flash experiments: the kernels of `tools/exp_flash.py`'s schedules, each
   against its plain version at H=12 on N=197 unmasked and N=133 with a
   random key mask and one fully masked batch row, at B=5 and B=256:
   - `flash_attention_qkv_phased` (its largest head group, all 12 heads)
     and `flash_attention_qkv_batched`, the two schedules of the wgmma
     attention core: max |kernel - plain| <= 2e-2, the fully masked row the
     mean of V, two launches at B=256 bit-identical; first at their edges
     (N = 1, 63, 64, 65, 197 and 256; odd B; H = 2 and 12; a fully masked
     row) and the phased one at every head group G of 1, 2, 3, 4, 6, 12
     at N=197;
   - `flash_attention_qkv_bwd_phased`: max |kernel - plain| <= 2e-2 *
     max |plain| per part (dq, dk, dv), and the same against the backward
     kernel's output, first at its edges (N = 1, 63, 64, 65, 130 and 208;
     odd B; H = 2 and 12, with and without a mask, a fully masked row);
     two launches at B=256 bit-identical;
   then kernel (with its TFLOP/s, and the two forwards' times recorded in
   PERF.md before the core took its layout policies beside it), the production kernel it reschedules
   (`v0`), plain version, SDPA (forward or backward) and bound timed at
   B=256; shapes each wrapper refuses (N=257 for the forwards, a head group
   that does not divide H, fp32, N=250 for the backward) raise and launch
   nothing.  Then
   the flash experiments path: `clibd_tpu_torch.tools.exp_flash` parity,
   bwd_parity, time, bwd_time and fwd_group as a user runs them; each of
   the three kernels must launch, the forward and backward kernels only as
   the harness's `v0` (46 and 48 launches), no other kernel, and every
   parity row must be OK.

12. serve: first `flash_attention_qkv` against its plain version at the
   serving path's batch sizes, B = 1, 3 and 32, for ViT N=197, BarcodeBERT
   N=133 and BERT-small N=20 H=8 masked (max |kernel - plain| <= 2e-2),
   kernel and SDPA timed at B = 1 and 32 beside the CTA count.  Then the
   flagship recipe (full width, bf16, seeded init) served:
   `InferenceService` on the card with `pre_warm()` over the buckets 1-32,
   behind `make_server` on port 0; 64 concurrent /embed requests (JPEGs made
   with PIL and barcodes), 4 text queries (a WordPiece vocabulary the phase
   writes from its taxonomy names), then /search for an image, a barcode,
   an image against the DNA keys and a text, against a 21,118-row gallery
   (the BIOSCAN-1M key gallery's size) built with `KeySet.from_arrays`
   (the card machine has no h5py) with each query's embedding planted.
   Checks finite unit-norm embeddings, coalescing (fewer batches than
   requests), exactly 12 / 12 / 4 forward launches per device call of the
   image / DNA / text tower (counted under the path "serve"), each search's
   top-1 the planted row at score 1 ± 1e-4; then the served rows against a
   direct forward at B=1 (cosine >= 0.999), a row of a bucket bit-identical
   beside zeros and beside other images, the gallery modes (fp32 exact; int8
   with the 4x host re-rank: the exact top-k, scores <= 1e-5 apart; int8
   alone: the planted top-1, its score within 0.02 of exact), each search
   timed at a query batch of 1 and 32, and the `tools/bench_serve` load (16
   clients x 8 requests, coalesced and unbatched: req/s, mean device batch,
   p50/p95).
13. import: the reference's torch checkpoints, written here at the
   flagship's full width independently of the port's importer
   (`draw_port_params` draws the CLIBD module's parameters from a seeded
   generator, `reference_state_dict` lays them out in the reference's names
   and layouts: torch [out, in] weights, BERT's separate q/k/v, the OIHW
   patch conv, the "module." prefix) with `torch.save`: the flagship's
   best.pth, and the LoRA recipe
   for_bioscan_1m/lora_vit_lora_barcode_bert_lora_bert_ssl.yaml's (rank 4,
   B non-zero) under the legacy names, with a padded vocabulary and the MLM
   decoder's bias at cls.predictions.bias.  verify-parity's convert leg
   must be ok on both; both load through `cli.common._resolve_params` with
   model_config.ckpt_path set, onto the card, every parameter the written
   tensor bit for bit (import seconds and the file's GB printed).  Then
   the flagship import's bf16 extraction of the synthetic splits, drawn as
   specimens of 40 species (`SyntheticSplit(species=40)`): exactly 28
   forward launches per batch and 12 / 12 / 4 for one batch per tower
   alone (the path "import_eval"), no other kernel, finite unit-norm
   embeddings, bf16 against fp32 cosine >= 0.99 per row, samples/s printed;
   verify-parity's legs on the kernel trio against the plain versions'
   trio: `compare_embeddings` ok at cosine 0.99, `compare_top1` ok at 0.5%
   for each tower's queries against its own keys (a seeded init aligns no
   modality with another, so the cross-modal cells are chance: the whole
   grid is printed, not held); the LoRA import's fp32 embeddings against
   the plain layout carrying W_qkv with the adapters merged in
   (`models/lora.py::merge_lora_into_qkv`) under the recipe with
   disable_lora, cosine >= 0.9999 per row; last, the flagship with
   `image.input_type: feature` over 512-wide image features (the MLP
   encoder): no launch from the image tower, 12 from the DNA tower and 4
   from the text tower per batch (the path "feature_eval").
14. accum_train: the flagship recipe (full width, bf16, remat "attn", batch
   500) with accum_steps=4 through the port's `Trainer`: one epoch over a
   synthetic train split of 3000 rows (6 steps), then one eval (all_keys
   1100, val_seen and val_unseen 500).  Checks: every loss finite; per step
   224 forward and 112 backward kernel launches (pass 1: 28 forwards per
   microbatch of 125; pass 3: 28 forwards and 28 backwards per microbatch),
   under the path "accum_train", and no other kernel; the eval's grid; last/
   and best/ written.  Then, on one batch with the augmentation replaced by
   the identity for this check only, the k=4 gradient cache against the
   monolithic step from the same weights: |loss difference| <= 1e-2 x
   |loss| and every trainable tensor's gradient at cosine >= 0.99; samples/s
   and peak device memory of both steps over 3 steps after a warm-up, the
   k=4 peak below the monolithic one; rows 1 and 2 at B=125 for the three
   towers against their plain versions, timed beside SDPA and the bound.
15. simclr and unimodel_eval: the unimodel recipe
   (unimodel_training_with_1m/unimodel_image_1m.yaml: ViT-B/16 at full
   width with its 768-d head, bf16, no LoRA) through the port's
   `SimCLRTrainer` over synthetic two-view batches (`SyntheticSplit(
   two_view=True)`), 2 epochs of 3 steps, at the recipe's batch of 500
   images (1000 views) if a step's peak memory, predicted from one step at
   batches 25 and 50, fits 85% of the card, else at the largest multiple
   of 10 that does (printed).  Checks: finite losses; 12 forward and 12
   backward launches per step (the path "simclr"); 5 steps on one fixed
   batch at a constant LR of 5e-5 lower its loss; checkpoint_0000/,
   checkpoint_0001/ and model_best/ written, model_best/ read back through
   `load_simclr_vit_backbone` bit for bit; samples/s over 3 steps and the
   peak memory printed.  Then `eval --unimodel`'s path on model_best/: the
   config's edits (`cli.eval_cmds.unimodel_config`), `_resolve_params`,
   extraction of all_keys / test_seen / test_unseen (1100 / 500 / 500
   synthetic rows) with exactly 12 forward launches per batch (the path
   "unimodel_eval") and no other kernel, finite unit-norm 768-d image
   embeddings, a non-empty grid.  Last, rows 1 and 2 at the SimCLR batch
   (2B views) against their plain versions, timed beside SDPA and the bound.

16. finetune: the INSECT fine-tune recipe
   (for_bioscan_1m/fine_tune_on_INSECT_dataset/image_dna_text_seed_42_on_INSECT_dataset.yaml:
   ViT-B/16, BarcodeBERT, 768-d, bf16, batch 150) through
   `engine.finetune.fit_classifier` (`cli finetune`'s engine) over an
   INSECT-shaped synthetic train split of 3,000 rows of its 1,213 species
   (20 steps) and a 600-row test split: one epoch with the image encoder
   trained, then one with the DNA encoder frozen.  Checks: (12, 12)
   launches per step trained and (12, 0) frozen, 12 per batch of `predict`,
   under the path "finetune", and no other kernel; every trained tensor
   with a finite nonzero gradient; the model's encoder bit-identical after
   the run (the frozen one takes no step, a trained one is a copy); finite
   logits and top-k accuracy; 5 steps on one fixed batch lower its loss;
   on 16 samples the bf16 gradients through the kernels against the plain
   versions (cosine >= 0.99 per tensor); the params `save_train_state`
   writes (the head at classifier/w [768, 1213]) read back bit for bit.
   Prints samples/s over the steps after the first and the peak memory.
17. bzsl_extract: the flagship's image and DNA towers through
   `engine.downstream.bzsl_extract` (`cli bzsl-extract`'s engine) over
   1,000 INSECT-shaped rows at batch 200 into the BZSL CSVs in a temporary
   directory: 24 forward launches per batch and no other kernel, an image
   CSV of one finite 768-d column per record, a DNA CSV whose columns are
   the classes' mean embeddings in class order (against a DNA-only
   extraction), records/s, and on 8 samples the embeddings against the
   plain versions (cosine >= 0.99 per row).
18. method_nn: the flagship (tri-modal, batch 500) through
   `engine.downstream.method_nn_eval` (`cli method-nn`'s engine) over
   synthetic splits of 200 species, the seen ones (val_seen, test_seen 500
   rows, seen_keys 1,100) of species 0-99 and the unseen ones (val_unseen,
   test_unseen, val_unseen_keys, test_unseen_keys 500 rows each) of
   100-199, the threshold searched on val and applied to test, in three
   legs: plain, `--linear` (the frozen probe, 500 steps) and `--linear
   --probe full` (one epoch over seen_keys).  Checks: 28 forward launches
   per batch of extraction, (12, 12) per full-probe step and 12 per batch
   of its logits (the path "method_nn"), no other kernel; the threshold and
   routing accuracies in [0, 1], a finite harmonic mean, the frozen probe's
   loss falling; on 8 samples the embeddings against the plain versions.
   Prints each leg's summary, the full probe's samples/s and peak memory.
19. zeroshot: the BioCLIP recipe's CLIP towers (ViT-B/16, the 12-layer
   causal text tower at D=512, embed 512) loaded by
   `engine.downstream.clip_towers_from_checkpoint` from an open_clip state
   dict the phase writes from seeded weights (`open_clip_state_dict`) and
   a small BPE merges file (`write_bpe_merges`), then
   `engine.downstream.zeroshot_eval` (`cli zeroshot`'s engine) in its
   three modes over synthetic splits of 400 species (test_seen 1,000,
   all_keys 1,100 images) at batch 64: 12 forward launches per image batch
   and none from the text tower (the path "zeroshot"), every accuracy in
   [0, 1], 400 classes; then the 32,000 prompts' prototypes timed alone
   (unit-norm; prompts/s), the images timed alone (images/s), and on 8
   images the features against the plain versions.

20. multi_gpu: the data-parallel paths (`parallel/mesh.py`), the flagship at
   full width in bf16.  The card machine has one card and NCCL refuses two
   ranks on one device, so the phase starts ranks of this script
   (`--multi-gpu-rank`, torchrun's environment, every rank on card 0, each
   group under a 600 s deadline; a rank that fails, hangs or exits
   non-zero fails the phase) after the kernels are built:
   - leg 1, one NCCL rank: 3 `Trainer` steps of batch 500 through the
     multi-rank step (`step_impl: shard_map`) against the single-card
     `Trainer` on the same batches and generators (folded with rank 0):
     losses and params within 1e-6 relative (bit-identity printed); (28,
     28) launches a step; leg 1b, in the same group, the gradient cache
     across ranks (`make_accum_grad_fn(mesh=)`) at k=2 on one batch of 500
     against the single-card k=2 cache on the same batch and generator:
     the loss and every gradient bit for bit, (112, 56) launches;
   - two gloo ranks on the one card, 250 rows a rank (global 500): leg 2,
     one multi-rank gradient step (augmentation the identity) against the
     single-card batch-500 step on the same rows (loss within 1e-2 x
     |loss|, every gradient at cosine >= 0.99), its time, the gradient
     all-reduce's time, each rank's peak memory; leg 2b, the gradient cache
     across the two ranks at k=2 (microbatches of 125) on the same rows
     against the same single-card step, at the same bounds, (112, 56)
     launches on each rank, its time and peak memory; then `Trainer.fit` for one
     epoch (2 steps) and its eval over host-sharded `SyntheticSplit`s, (28,
     28) launches a step on each rank, both ranks' losses and eval equal,
     checkpoints written by rank 0 alone; leg 3, `extract_split_multihost`
     of an all_keys split of 1,101 rows against `extract_split`, row
     cosine >= 0.999 in the same order, labels and ids identical; leg 4,
     `resume_multihost` with rank 1 holding a stale last/ of another seed:
     both ranks hold rank 0's params.npz, opt_state.npz and step bit for
     bit; leg 5, one data-parallel SimCLR step of the unimodel recipe at
     210 images a rank against two single-card losses (one per rank's rows
     and views): the loss their mean within 1e-2, the gradients their sum
     at cosine >= 0.99, (12, 12) launches on each rank; and whether gloo's
     all_gather takes CUDA tensors (the helpers stage gloo's tensors
     through the host either way);
   - leg 6, in this process: `KeySet` over [cuda:0, cuda:0] on a 21,118 x
     768 gallery, fp32 top-16 indices identical to the unsharded KeySet's,
     int8 + re-rank within 1e-5 of it; then the service `serve
     --shard-keys` builds (`InferenceService(keys_mesh=...)` behind
     `make_server`) answers one image + barcode /search with the planted
     rows first.
   The ranks' launches go into the kernels line under the path
   "multi_gpu".

21. cli_tail: the rest of the command line (`cli/{ops,analysis}_cmds.py`),
   the flagship at full width, seeded:
   - leg 1, `bench`: the body of `tools/bench.py` (`cli bench`) on the
     flagship's image and DNA towers, bf16, batch 256, 3 warm-up calls and
     3 passes of 10: its JSON line (samples/s, the card's name and power
     limit); exactly 24 forward launches a call (12 ViT + 12 BarcodeBERT,
     under the path "bench") and no other kernel; finite unit-norm
     embeddings; on 8 rows the kernels against the plain versions (cosine
     >= 0.99 per row);
   - leg 2, the attention-rollout probes of `analysis/attention_maps.py`
     (plain torch, fp32, TF32 off): ViT-B/16 on 8 images (N=197),
     BarcodeBERT at N=133 on 8 rows, and the overlap recipe's DNA tower at
     N=657 with a key mask on 4 rows ([12, 4, 12, 657, 657] fp32 is 0.99 GB;
     8 rows would be 2.0 GB).  Each: the card's probabilities against the
     same function on the CPU on 2 rows (max |d| <= 1e-4), every row summing
     to 1 within 1e-5, masked key columns < 1e-6, the rollout masks card
     against CPU at cosine >= 0.999; each probe timed;
   - leg 3, the device searches of `analysis/failure_cases.find_failures`
     (with and without prepared keys) and `engine/retrieval_grid.
     retrieval_records` (with and without only_failures) over synthetic
     feature dicts, 500 queries against a 21,118 x 768 gallery: the card's
     cases and records identical to the CPU's, each timed;
   - leg 4, `doctor --device cuda --timeout 60 -e <flagship recipe>` in a
     subprocess: rc 0, device status "ok" with the card's name, experiment
     config "ok"; `configs` lists the YAMLs under clibd_tpu/config/configs/
     (read as files), name for name.

22. tools: the ports of the repository's root tools/ harnesses
   (`clibd_tpu_torch/tools/`) as a user runs them, the flagship's widths,
   seeded, the kernels' launches counted under the path "tools":
   - leg 1, `bench_train`: its two default cells (batch 128 image + DNA with
     LoRA rank 4, remat "attn"; batch 500 tri-modal full fine-tune, remat
     "attn"), batch 500 with the "dots", "none" and "attn+mlp" policies,
     batch 128 with no remat ("off"; at 500 it holds 67.79 GiB), and batch
     500 through the gradient cache at k=4, each 1 warm-up step and 2 timed
     (the tool's own default: 2 and 3 passes of 8): ms a step, samples/s,
     the loss, peak memory; launches per step layers x (2 where the policy
     recomputes the attention, else 1) forward and layers backward, at k=4
     layers x 4 x (1 + that) forward and layers x 4 backward; an
     out-of-memory cell fails the phase;
   - leg 2, `rehearse`: the flagship's widths with LoRA over the
     learnable records (128 a split, 8 species) for 8 epochs of batch 32:
     the loss must fall and overall_acc rise (both printed), with the
     decoder it took;
   - leg 3, `exp_bwd_floor`: the floor table (PERF.md's bound, 0.3161 and
     0.2134 ms at B=500) and the backward kernel alone at ViT N=197 and
     BarcodeBERT N=133 (8 keys masked) against its floor and SDPA's
     backward, 16 rows held against its plain version;
   - leg 4, `exp_prof`: the image and the DNA tower alone at batch 256
     (both towers together is phase 21's `bench`);
   - leg 5, `exp_block` and `exp_bert` at their default variants (plain
     PyTorch, no kernel), each variant within 2^-4 of max |base| of its
     base, timed with CUDA events;
   - leg 6, `bench_knn`: the 42 searches of 40,000 seen and 8,000 unseen
     queries against 21,118 keys (x3 for all_key_features) on the card, the
     first 256 queries of each again on the CPU: the scores within 1e-5 and
     the top-5 identical but where two keys' scores lie within 1e-5 (an
     order fp32 sums may flip; the count printed); then the whole
     `inference_and_eval`; both times printed.
   The card machine has no h5py, so the harnesses that read or write HDF5
   (`bench_eval`, `bench_extract`, `bench_pipeline`, the soaks) are held
   only on the CPU (tests/test_torch_tools_{benches,train,soaks}.py).

The INSECT HDF5 loader itself (`data/insect.py`) is held only on the CPU
(tests/test_torch_insect.py): the card machine has no h5py, so phases 16-17
feed the engines INSECT-shaped synthetic splits.  For the same reason (no
h5py, matplotlib, pandas or sklearn there) the data commands (`create-splits`,
`build-hdf5`, `subset-hdf5`, `generate-split-csv`, `fetch-taxonomy`), the
figure writers and the CSV and plot commands (`flatten-csv`,
`plot-embeddings`, `stats-summary`, `compare-experiments`,
`confusion-matrices`, the figures of `attention-maps`, `failure-cases` and
`eval`'s retrieval grids) are held only on the CPU
(tests/test_torch_{data_cmds,analysis_cmds,attention_maps,retrieval_grid}.py).

Phases 3-5 and 12-22 run with both opt-in kernels off, as the flagship
recipe does.
The last three lines are the kernel summary JSON, the card line, and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

KERNEL_TOL = 2e-2      # forward, max |kernel - plain| on unit-scale inputs: ~1 bf16 ulp of P x |V|
BWD_REL_TOL = 2e-2     # backward, per part, relative to the part's max |plain|
COSINE_MIN = 0.99      # bf16 vs fp32 path per embedding row; kernel vs plain gradients per tensor
SHAPES = (("vit", 197, 12, False), ("barcode_bert", 133, 12, False), ("bert_small", 20, 8, True),
          ("barcode_bert_overlap", 657, 12, True))
# the plain versions' [B, H, N, N] fp32 intermediates take 10 GB each at
# B=500 and N=657: past LONG_N they are compared and timed at PLAIN_B_LONG
LONG_N, PLAIN_B_LONG = 256, 64
EXPERIMENT = "for_bioscan_1m/final_experiments/image_dna_text_seed_42.yaml"
OVERLAP = ("for_bioscan_5m/barcodeBERT_trained_with_5m/"
           "image_dna_text_seed_42_new_barcodeBERT_5M.yaml")
BIOCLIP = "for_bioscan_1m/image_bind_style/with_bioclip_bind_to_image.yaml"
REL_TOL = 2e-2         # out-projection and fused MLP: max |kernel - plain| / max |plain|
# LayerNorm (name, R, D, eps): the towers' rows at batch 500, bf16 fast math
LN_SHAPES = (("vit", 500 * 197, 768, 1e-6), ("barcode_bert", 500 * 133, 768, 1e-12),
             ("barcode_bert_overlap", 500 * 657, 768, 1e-12), ("bert_small", 500 * 20, 512, 1e-12))
# LayerNorm kernels against their plain versions, of max |plain|: the same
# rounding points, so a bf16 ulp where an fp32 sum in another order rounds the
# mean, the inverse std or an element the other way (dscale and dbias: fp32
# sums over the rows in another order)
LN_REL_TOL = 1e-2
# fused MLP (name, R, D, F, activation): the BioCLIP towers' shapes at batch 500
MLP_SHAPES = (("vit", 500 * 197, 768, 3072, "gelu_tanh"),
              ("barcode_bert", 500 * 133, 768, 3072, "gelu_tanh"),
              ("clip_text", 500 * 77, 512, 2048, "gelu_tanh"))
# 64*197 rows fill whole 64-row blocks; 63*197 leaves a ragged tail of 59.
# Then the edges of the bf16 kernel's ring and cluster: one row, a partial
# and a whole row block, one past it, an odd count of row blocks (the cluster
# of two gets a CTA with no rows); F = 64 and 128, fewer F chunks than ring
# stages; D = 256 and 512
MLP_EXTRA = (tuple((f"vit R={r} {act}", r, 768, 3072, act)
                   for r in (64 * 197, 63 * 197) for act in ("gelu", "quick_gelu"))
             + tuple((f"edge R={r} D={d} F={f}", r, d, f, "gelu_tanh") for r, d, f in (
                 (1, 768, 3072), (37, 768, 3072), (64, 768, 3072), (65, 768, 3072),
                 (64 * 3, 768, 3072), (37, 768, 64), (65, 768, 128), (64 * 3, 512, 2048),
                 (65, 256, 1024))))
MLP_CLUSTER_ROWS = 128  # rows of a cluster of two fused-MLP CTAs, which share each weight box
# out-projection kernel edges (B, N, H, masked): one key; a query tile one
# row short of 64, full, one row past; one batch element and odd counts;
# every H the bf16 kernel takes (2, 4, 6, 8, 12); batch row 0 fully masked
OUTPROJ_EDGES = ((1, 1, 12, False), (3, 63, 12, True), (1, 64, 8, False), (5, 65, 2, True),
                 (3, 65, 12, False), (1, 20, 8, True), (7, 1, 2, True), (2, 40, 4, True),
                 (3, 70, 6, False))
L2_PROBE_MB = (4, 8, 12, 16)  # copies that fit the L2, for its copy rate
# elements of the scale copy's edges: below one 16-byte vector, one vector,
# one and a scalar, the old 1027-element tail, one vector past a 16 KB ring
# slot, and one that wraps every CTA's ring of 8 slots 2.5 times with a
# ragged end
COPY_EDGES = (1, 3, 4, 5, 1027, 4100, 132 * 4096 * 20 + 4103)
BIOCLIP_TRAIN_STEPS = 4
SPLIT_ROWS = {"all_keys": 1100, "test_seen": 500, "test_unseen": 500}
TRAIN_ROWS = {"train": 3000, "all_keys": 1100, "val_seen": 500, "val_unseen": 500}
# the overlap path: 4 steps of batch 500 and one eval
OVERLAP_TRAIN_ROWS = {"train": 2000, "all_keys": 1100, "val_seen": 500, "val_unseen": 500}
# phase 12, serving: the forward kernel at the service's batch sizes (B=1
# and 32 timed); the buckets; the BIOSCAN-1M key gallery's rows
# (tools/bench_knn.py); the load of the bench_serve runs
SERVE_ROW1_B = (1, 3, 32)
SERVE_ROW1_TIMED_B = (1, 32)
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_WINDOW_MS = 8.0
SERVE_EMBEDS = 64          # concurrent /embed requests, each a JPEG and a barcode
SERVE_TEXTS = ("diptera cecidomyiidae porricondyla", "hymenoptera braconidae aphidius",
               "diptera sciaridae bradysia", "coleoptera staphylinidae atheta")
GALLERY_ROWS = 21118
GALLERY_K = 16             # the KeySet's fixed device width (max_k)
SERVE_LOAD = (16, 8)       # bench_serve clients x requests per client
SERVE_COSINE_MIN = 0.999   # served row against a direct forward at B=1
SEARCH_SCORE_TOL = 1e-4    # a planted row's score against 1
RERANK_SCORE_TOL = 1e-5    # int8 + re-rank against exact fp32
INT8_SCORE_TOL = 0.02      # int8 without re-rank against exact (tests/test_knn.py's bound)
INT8_MARGIN = 0.01         # exact top-1 margin above which int8 must keep the top-1
# phase 13: the LoRA recipe imported beside the flagship; the writer's seed;
# the LoRA import against its merged plain form (fp32, per row); the width of
# the feature-input flagship's image features
IMPORT_LORA = "for_bioscan_1m/lora_vit_lora_barcode_bert_lora_bert_ssl.yaml"
IMPORT_SEED = 13
IMPORT_COSINE_MIN = 0.9999
IMPORT_SPECIES = 40
FEATURE_DIM = 512
ACCUM_STEPS = 4             # phase 14: the gradient cache's microbatches a step
ACCUM_TRAIN_ROWS = {"train": 3000, "all_keys": 1100, "val_seen": 500, "val_unseen": 500}
ACCUM_LOSS_REL_TOL = 1e-2   # k=4 loss against the monolithic step's, bf16, relative
ACCUM_RATE_STEPS = 3        # timed steps of each step kind, after one warm-up step
SIMCLR = "unimodel_training_with_1m/unimodel_image_1m.yaml"
SIMCLR_EPOCHS, SIMCLR_STEPS_PER_EPOCH = 2, 3
SIMCLR_PROBE_B = (25, 50)   # batches of the memory probe that sizes the SimCLR batch
SIMCLR_MEMORY_SHARE = 0.85  # of the card's memory a SimCLR step's predicted peak may take
SIMCLR_RATE_STEPS = 3
INSECT_FT = ("for_bioscan_1m/fine_tune_on_INSECT_dataset/"
             "image_dna_text_seed_42_on_INSECT_dataset.yaml")
INSECT_SPECIES = 1213       # INSECT's species count
FINETUNE_ROWS = {"trainval_loc": 3000, "test_seen_loc": 600}  # 20 train steps at batch 150
FINETUNE_LR = 1e-4          # cli finetune's default
BZSL_ROWS, BZSL_BATCH = 1000, 200
METHOD_NN_ROWS = {"val_seen": 500, "val_unseen": 500, "test_seen": 500, "test_unseen": 500,
                  "seen_keys": 1100, "val_unseen_keys": 500, "test_unseen_keys": 500}
METHOD_NN_SPECIES = 200     # the seen splits draw species 0-99, the unseen ones 100-199
PROBE_STEPS = 500           # the frozen probe's AdamW steps (cli default)
ZEROSHOT_SPECIES = 400      # 32,000 prompts of the 80-template ensemble
ZEROSHOT_ROWS = {"test_seen": 1000, "all_keys": 1100}
ZEROSHOT_BATCH = 64         # cli zeroshot's default
ZEROSHOT_SEED = 19
MULTI_GPU_TRAIN_ROWS = 1000   # leg 2's Trainer at W=2: two steps of 250 a rank (global 500)
MULTI_GPU_EVAL_ROWS = {"all_keys": 1101, "val_seen": 250, "val_unseen": 250}  # 1101: odd
MULTI_GPU_NCCL_STEPS = 3
MULTI_GPU_ACCUM_K = 2          # the gradient cache across ranks: microbatches a rank a step
MULTI_GPU_NCCL_REL_TOL = 1e-6  # NCCL W=1 against the single-card trainer, relative
MULTI_GPU_EXTRACT_COSINE = 0.999
MULTI_GPU_SIMCLR_BATCH = 210   # images a rank: phase 15's 420 over two ranks
MULTI_GPU_TIMEOUT = 600        # seconds a group of ranks may take
DP_LOSS_REL_TOL = ACCUM_LOSS_REL_TOL  # a data-parallel loss against one card's, as phase 14
PROBE_IMAGES = 8            # phase 21: ViT and BarcodeBERT probes, rows on the card
PROBE_OVERLAP_ROWS = 4      # N=657: [12, 4, 12, 657, 657] fp32 = 0.99 GB (8 rows: 2.0 GB)
PROBE_CPU_ROWS = 2          # rows the CPU computes again
PROBE_ATOL = 1e-4           # fp32 probabilities, card against CPU, TF32 off
PROBE_ROW_SUM_TOL = 1e-5
PROBE_MASKED_MAX = 1e-6     # probability on a masked key column
ROLLOUT_COSINE_MIN = 0.999  # rollout masks, card against CPU, per row
SEARCH_QUERIES = 500        # leg 3: queries against the GALLERY_ROWS x 768 gallery


# bench_train's (batch, policy, accum_steps) cells: its two defaults, every
# other remat policy ("off" at 128: at 500 it holds 67.79 GiB), the cache at k=4
TOOLS_TRAIN_CELLS = ((128, None, 1), (500, None, 1), (500, "dots", 1), (500, "none", 1),
                     (500, "attn+mlp", 1), (128, "off", 1), (500, None, 4))
TOOLS_TRAIN_TIMING = {"warmup": 1, "iters": 2, "passes": 1}   # cut from 2 + 3 passes of 8
TOOLS_REHEARSE = (8, 32)       # the rehearsal's epochs and batch (rehearse_tpu.py's)
TOOLS_KNN = (40000, 8000, 21118)  # bench_knn's seen, unseen queries and keys
TOOLS_KNN_CPU_ROWS = 256       # queries of each split the CPU searches again
KNN_TIE_TOL = 1e-5             # scores card against CPU; a swapped pair must be this close
# exp_block / exp_bert: a variant against base, of max |base|: 8 bf16 ulps (2^-7 each); the
# variants change LayerNorm's and GELU's arithmetic in each of 12 layers (4 ulps on the CPU)
ABLATION_REL_TOL = 2 ** -4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores, published
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores, published
PROBE_KERNELS = ("scale_copy", "tiled_gemm", "attention_bhnd")
EXP_FLASH_KERNELS = ("flash_attention_qkv_phased", "flash_attention_qkv_batched",
                     "flash_attention_qkv_bwd_phased")
# (N, masked) at H=12 for the experiment kernels: the JAX script's two towers
EXP_FLASH_SHAPES = ((197, False), (133, True))
# (B, N, H, masked) edges of the two wgmma forward kernels: one key; a whole
# 64-key block and one key past it; the 256 keys a row holds; a query tile
# one row short; odd B, H = 2 and 12, batch row 0 fully masked where masked
EXP_FLASH_EDGES = ((3, 1, 2, False), (5, 64, 12, True), (3, 65, 2, True), (3, 256, 12, True),
                   (1, 63, 12, False), (7, 197, 2, True))
EXP_FLASH_GROUPS = (1, 2, 3, 4, 6, 12)  # the phased kernel's head groups of H=12
# (B, N, H, masked) edges of the phased backward: one key; a query block one
# row short, whole, one row past (a block with one live row); N=130 (a third
# block of two rows); the 208 keys it takes at most; odd B, H = 2 and 12,
# with and without a mask (batch row 0 fully masked where masked)
BWD_PHASED_EDGES = ((3, 1, 2, False), (5, 63, 12, True), (3, 64, 2, True), (1, 65, 12, False),
                    (5, 130, 2, True), (3, 208, 12, True), (7, 208, 2, False))
GEMM_REL_TOL = {"fp32": 1e-3, "bf16": 1e-2}  # max |kernel - plain| / max |plain|, by out dtype
# (M, N, K) of the GEMM checks, every tile, fp32 and bf16 out: the three
# harnesses' squares; a non-square shape whose tile count is no multiple of
# the SMs' (4096 x 8192 is 1024 tiles of 128 x 256, 7.76 waves of 132); K of
# one slot (64)
GEMM_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (8192, 8192, 8192), (4096, 8192, 2048),
               (2048, 2048, 64))
# (B, N) at H=12 for attention_bhnd: the harness's shape, then two smaller ones
BHND_SHAPES = ((256, 197), (64, 133), (64, 20))
# (B, H, N) edges of attention_bhnd: one key; a query tile one row short, a
# whole 64-key block and one key past it; the 256 keys a row holds; B = 1
# and odd B, H = 1 and 12
BHND_EDGES = ((1, 1, 1), (3, 12, 63), (1, 12, 64), (3, 1, 65), (5, 12, 256), (1, 1, 256),
              (7, 12, 197))
# the wgmma attention kernels' ptxas limits (their report before the core
# took its layout policies, at three warpgroups a SM), which the phased
# backward and the main path's forward and backward, all on wgmma, are held
# to as well: stack bytes of any instance; no warpgroup.arrive injected
# (C7519)
WGMMA_ATTENTION_SOURCES = ("flash_attention_qkv", "flash_attention_qkv_phased",
                           "flash_attention_qkv_batched", "attention_bhnd",
                           "flash_attention_qkv_bwd_phased", "flash_attention_qkv_bwd")
WGMMA_MAX_STACK = 216
# the two forward schedules' times that PERF.md §6 records from before the
# core took its layout policies (NVIDIA H100 80GB HBM3, 700 W), B=256 H=12,
# ms: printed beside this run's
RECORDED_MS = {("flash_attention_qkv_phased", 197): 0.2493,
               ("flash_attention_qkv_phased", 133): 0.1455,
               ("flash_attention_qkv_batched", 197): 0.2755,
               ("flash_attention_qkv_batched", 133): 0.1816}
# the forward kernel's times at B=500 before its redesign on wgmma: the
# key-tiled mma.sync + cp.async kernel (NVIDIA H100 80GB HBM3, 700 W, PERF.md
# §6), ms by shape: printed beside this run's
FWD_RECORDED_MS = {"vit": 0.5791, "barcode_bert": 0.3392, "bert_small": 0.0353,
                   "barcode_bert_overlap": 4.0708}
# (B, N, H) edges of the forward kernel, each with and without a key mask
# (batch row 0 fully masked): one key; a 64-key block one short, whole and
# one past, at one, two and four blocks; the overlap tower's N; B = 1 and
# odd B, H = 1, 8 and 12
FWD_EDGES = ((1, 1, 1), (3, 63, 8), (5, 64, 12), (1, 65, 1), (3, 127, 8), (5, 128, 12),
             (1, 129, 1), (3, 256, 8), (5, 257, 12), (1, 657, 12))
# the backward kernel's times at B=500 before its redesign on wgmma: the
# key-tiled mma.sync + cp.async row and column kernels (NVIDIA H100 80GB
# HBM3, 700 W, PERF.md §6), ms by shape: printed beside this run's
BWD_RECORDED_MS = {"vit": 2.2553, "barcode_bert": 1.3087, "bert_small": 0.1128,
                   "barcode_bert_overlap": 16.1308}
# (B, N, H) edges of the backward kernel, each with and without a key mask
# (batch row 0 fully masked): one key; a 64-key block one short, whole and
# one past, at one, two and four blocks; either side of the whole-row
# route's 208 keys (207, 208; 209 key-tiled); N=300 and the overlap tower's
# N; B = 1, 3, 5 and H = 1, 8, 12
BWD_EDGES = ((1, 1, 1), (3, 63, 8), (5, 64, 12), (1, 65, 1), (3, 127, 8), (5, 128, 12),
             (1, 129, 1), (3, 207, 8), (5, 208, 12), (1, 209, 1), (3, 256, 8), (5, 257, 12),
             (1, 300, 12), (3, 657, 8))


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S) -> tuple:
    """(least ms the card could take, what bounds it) from the published
    memory rate and the peak for the operations' type (bf16 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
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


def plain_batch(N: int) -> int:
    """The batch the plain version is compared and timed at for N keys."""
    return PLAIN_B_LONG if N > LONG_N else 500


def head(x, n):
    """The first n rows of an array or tensor, or of each one in a dict."""
    return {k: head(v, n) for k, v in x.items()} if isinstance(x, dict) else x[:n]


def library_attention(qkv, H, mask):
    """The closest single PyTorch call, for timing only: scaled dot-product
    attention on head-split views of qkv (`tools/exp_flash.sdpa`)."""
    from clibd_tpu_torch.tools.exp_flash import sdpa

    return sdpa(qkv, H, mask)


def kernel_entry(name, source, replaces, shapes):
    """The summary line's entry: the ViT shape, which carries most of the
    time, gives ms / plain_ms / bound / library_ms; every shape is kept."""
    vit = shapes[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": vit["ms"], "plain_ms": vit["plain_ms"], "bound_ms": vit["bound_ms"],
            "bound_by": vit["bound_by"], "library_ms": vit["library_ms"], "by_shape": shapes}


def check_forward(qkv, mask, H, what) -> float:
    """The forward kernel against its plain version → max |kernel - plain|,
    failing past KERNEL_TOL; the fully masked row (batch row 0 of a masked
    input) must be the mean of V."""
    import torch

    from clibd_tpu_torch.ops.attention import (flash_attention_qkv_cuda,
                                               flash_attention_qkv_reference)

    N = qkv.shape[1]
    got = flash_attention_qkv_cuda(qkv, H, mask).float()
    want = flash_attention_qkv_reference(qkv, H, mask).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"forward kernel output not finite at {what}")
    err = float((got - want).abs().max())
    if mask is not None:
        v = qkv[0, :, 2 * H * 64:].float()
        err_uniform = float((got[0] - v.mean(0, keepdim=True).expand(N, -1)).abs().max())
        if err_uniform > KERNEL_TOL:
            fail(f"fully masked row not uniform at {what}: max|Δ| {err_uniform}")
    print(f"kernel flash_attention_qkv {what}: max|kernel-plain| {err:.3e} (tol {KERNEL_TOL})")
    if err > KERNEL_TOL:
        fail(f"forward kernel disagrees with its plain version at {what}: {err} > {KERNEL_TOL}")
    return err


def forward_kernel_phase(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.attention import (flash_attention_qkv_cuda,
                                               flash_attention_qkv_reference)
    from clibd_tpu_torch.utils.profiling import cuda_ms

    shapes = []
    for name, N, H, masked in SHAPES:
        err, plain_B = 0.0, plain_batch(N)
        for B in sorted({64, plain_B}):  # 500: the main path's batch
            qkv, mask = make_qkv(B, N, H, masked, seed=N + B)
            err = max(err, check_forward(qkv, mask, H, f"{name} B={B} N={N} H={H} mask={masked}"))
            if B == plain_B:
                plain_ms = cuda_ms(lambda: flash_attention_qkv_reference(qkv, H, mask))
        if plain_B != 500:
            qkv, mask = make_qkv(500, N, H, masked, seed=N + 500)
        ms = cuda_ms(lambda: flash_attention_qkv_cuda(qkv, H, mask))
        library_ms = cuda_ms(lambda: library_attention(qkv, H, mask))
        D = H * 64
        flops = 4 * 500 * H * N * N * 64
        nbytes = 500 * N * (3 * D + D) * 2 + (500 * N * 4 if masked else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"time flash_attention_qkv {name} B=500: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s; mma.sync design, recorded: "
              f"{FWD_RECORDED_MS[name]:.4f} ms), plain {plain_ms:.4f} ms (B={plain_B}), "
              f"library (sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        shapes.append({"shape": name, "B": 500, "N": N, "H": H, "ms": ms, "plain_ms": plain_ms,
                       "plain_B": plain_B, "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err})
        del qkv, mask
    # past the whole-row kernels' 256 keys: the key-tiled kernel takes any N
    qkv, mask = make_qkv(4, 300, 12, True, seed=300)
    check_forward(qkv, mask, 12, "B=4 N=300 H=12 mask=True (taken: any N)")
    for B, N, H in FWD_EDGES:
        for masked in (False, True):
            qkv, mask = make_qkv(B, N, H, masked, seed=7 * N + B)
            check_forward(qkv, mask, H, f"edge B={B} N={N} H={H} mask={masked}")
    torch.cuda.empty_cache()
    return kernel_entry("flash_attention_qkv", "clibd_tpu_torch/csrc/flash_attention_qkv.cu",
                        "clibd_tpu/ops/pallas/attention.py:143", shapes)


def bwd_parts_rel(got, want, D) -> list:
    """max |got - want| / max |want| for each of dq, dk, dv; where a part of
    the plain version is all zeros (dq and dk at N=1, where dS is 0), the
    kernel's max |got| instead, which must be 0 as well."""
    rel = []
    for i in range(3):
        a, b = got[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D]
        top = float(b.abs().max())
        rel.append(float((a - b).abs().max()) / top if top else float(a.abs().max()))
    return rel


def check_backward(qkv, dout, mask, H, what) -> float:
    """The backward kernel against its plain version → max |kernel - plain|,
    failing past BWD_REL_TOL * max |plain| in any of dq, dk, dv."""
    import torch

    from clibd_tpu_torch.ops.attention import (flash_attention_qkv_bwd_cuda,
                                               flash_attention_qkv_bwd_reference)

    got = flash_attention_qkv_bwd_cuda(qkv, dout, H, mask).float()
    want = flash_attention_qkv_bwd_reference(qkv, dout, H, mask).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"backward kernel output not finite at {what}")
    rel = bwd_parts_rel(got, want, H * 64)
    print(f"kernel flash_attention_qkv_bwd {what}: max|kernel-plain|/max|plain| dq {rel[0]:.3e} "
          f"dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {BWD_REL_TOL})")
    if max(rel) > BWD_REL_TOL:
        fail(f"backward kernel disagrees with its plain version at {what}: {rel}")
    return float((got - want).abs().max())


def backward_kernel_phase(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.attention import (
        flash_attention_qkv,
        flash_attention_qkv_bwd_cuda,
        flash_attention_qkv_bwd_reference,
        flash_attention_qkv_bwd_route,
    )
    from clibd_tpu_torch.utils.profiling import cuda_ms

    def inputs(B, N, H, masked, seed):
        qkv, mask = make_qkv(B, N, H, masked, seed=seed)
        g = torch.Generator(device="cuda").manual_seed(N * B)
        return qkv, mask, torch.randn(B, N, H * 64, generator=g, device="cuda").to(torch.bfloat16)

    def same_bits(qkv, mask, dout, H, what):
        first = flash_attention_qkv_bwd_cuda(qkv, dout, H, mask)
        if not torch.equal(first, flash_attention_qkv_bwd_cuda(qkv, dout, H, mask)):
            fail(f"two launches of the backward kernel differ at {what}")
        print(f"two launches of flash_attention_qkv_bwd give the same bits at {what}")

    shapes = []
    for name, N, H, masked in SHAPES:
        D = H * 64
        err, plain_B = 0.0, plain_batch(N)
        route = ("whole row", "key-tiled")[flash_attention_qkv_bwd_route(N)]
        for B in sorted({64, plain_B}):
            qkv, mask, dout = inputs(B, N, H, masked, N + B + 1)
            err = max(err, check_backward(qkv, dout, mask, H,
                                          f"{name} B={B} N={N} H={H} mask={masked} ({route})"))
            if N > LONG_N and B == 64:  # the overlap tower's determinism, where its plain fits
                same_bits(qkv, mask, dout, H, f"{name} B=64")
            if B == plain_B:
                plain_ms = cuda_ms(lambda: flash_attention_qkv_bwd_reference(qkv, dout, H, mask))
        if plain_B != 500:
            qkv, mask, dout = inputs(500, N, H, masked, N + 500 + 1)
        if name == "vit":
            same_bits(qkv, mask, dout, H, f"{name} B=500")
        ms = cuda_ms(lambda: flash_attention_qkv_bwd_cuda(qkv, dout, H, mask))
        leaf = qkv.detach().requires_grad_()
        lib_out = library_attention(leaf, H, mask)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, dout.view(500, N, H, 64)
                                                         .transpose(1, 2), retain_graph=True))
        flops = 10 * 500 * H * N * N * 64  # S, dP, dV, dQ, dK
        nbytes = 500 * N * (3 * D + D + 3 * D) * 2 + (500 * N * 4 if masked else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"time flash_attention_qkv_bwd {name} B=500 ({route}): kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s; mma.sync design, recorded: "
              f"{BWD_RECORDED_MS[name]:.4f} ms), plain {plain_ms:.4f} ms (B={plain_B}), "
              f"library (sdpa backward) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
              f"  [{card}]")
        shapes.append({"shape": name, "B": 500, "N": N, "H": H, "route": route, "ms": ms,
                       "plain_ms": plain_ms, "plain_B": plain_B, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err})
        del qkv, mask, dout, leaf, lib_out
    torch.cuda.empty_cache()
    for B, N, H in BWD_EDGES:
        route = ("whole row", "key-tiled")[flash_attention_qkv_bwd_route(N)]
        for masked in (False, True):
            qkv, mask, dout = inputs(B, N, H, masked, 7 * N + B)
            check_backward(qkv, dout, mask, H, f"edge B={B} N={N} H={H} mask={masked} ({route})")

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


def knn_ties_phase(card: str) -> None:
    """kNN on the card with exact ties: 7 distinct rows, each three times
    (keys i, i + 7, i + 14), and k from 1 to 8, so ties straddle the k-th
    place.  The indices must be jax.lax.top_k's: of equal scores the lower
    key index first, here a stable sort of the card's own scores."""
    import torch

    from clibd_tpu_torch.models.clibd import l2_normalize
    from clibd_tpu_torch.ops.knn import knn_search

    rng = np.random.default_rng(7)
    rows = rng.standard_normal((7, 768)).astype(np.float32)
    keys = torch.from_numpy(np.concatenate([rows, rows, rows])).cuda()
    queries = torch.from_numpy(np.concatenate([rows[[0, 3, 6]],
                                               rng.standard_normal((4, 768)).astype(np.float32)]))
    q = queries.cuda()
    padded = torch.cat([l2_normalize(q), q.new_zeros(1, 768)])  # 8 rows, as knn_search pads
    scores = torch.matmul(padded, l2_normalize(keys).T)[:7].cpu().numpy()
    for k in range(1, 9):
        _, idx = knn_search(q, keys, k=k, query_chunk=8)
        want = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        if not np.array_equal(idx, want):
            fail(f"kNN on the card breaks ties out of index order at k={k}: {idx} against {want}")
        if k == 3 and idx[:3].tolist() != [[0, 7, 14], [3, 10, 17], [6, 13, 20]]:
            fail(f"a query equal to a key does not find its three copies in index order: {idx}")
    print(f"kNN with tied keys on the card: lower index first for k = 1..8  [{card}]")


def eval_slice_phase(card: str, label: str, mc, device, split_rows: dict) -> dict:
    """Extraction of three synthetic splits and the kNN grid through the
    recipe `mc` with the opt-in kernels off → the kernel launches of the
    extraction."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.evaluate import format_results, inference_and_eval
    from clibd_tpu_torch.engine.extract import extract_split, make_encode_step, to_device
    from clibd_tpu_torch.models import clibd_apply, init_clibd_model

    t0 = time.perf_counter()
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    splits = {name: SyntheticSplit(name, n, mc, seed=i)
              for i, (name, n) in enumerate(split_rows.items())}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{label} eval set-up: {n_params / 1e6:.1f} M params, synthetic splits "
          f"{ {k: len(v.ids()) for k, v in splits.items()} } in {time.perf_counter() - t0:.1f} s")

    # warm-up: 8 samples through the bf16 path (cuBLAS handles, kernel load)
    b = next(splits["test_seen"].batches())
    small = to_device({m: head(b[m], 8) for m in ("image", "dna", "language")}, device)
    make_encode_step(mc, model, torch.bfloat16)(small)
    torch.cuda.synchronize()

    reset_counts()
    ln0 = layernorm_counts()
    t0 = time.perf_counter()
    keys_dict = extract_split(model, mc, splits["all_keys"], for_key_set=True)
    seen_dict = extract_split(model, mc, splits["test_seen"])
    unseen_dict = extract_split(model, mc, splits["test_unseen"])
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["flash_attention_qkv"]
    n_batches = sum(len(s) for s in splits.values())
    n_rows = sum(split_rows.values())
    per_batch = (mc.image.vit.num_layers + mc.dna.bert.num_layers
                 + mc.language.bert.num_layers)
    print(f"flash_attention_qkv launches in the {label} eval: {launches} "
          f"(expected {per_batch} x {n_batches} batches = {per_batch * n_batches})")
    others = {k: v for k, v in counts.items() if k != "flash_attention_qkv"}
    if launches != per_batch * n_batches or any(others.values()):
        fail(f"{label} eval launched the forward kernel {launches} times, expected "
             f"{per_batch * n_batches}, and the others {others}")
    ln = {k: n - ln0[k] for k, n in layernorm_counts().items()}
    ln_batch = layernorm_per_batch(model)
    print(f"LayerNorm launches in the {label} eval: {ln} (expected {ln_batch} x {n_batches} "
          f"batches = {ln_batch * n_batches} forward, no backward)")
    if ln != {"layernorm": ln_batch * n_batches, "layernorm_bwd": 0}:
        fail(f"{label} eval launched the LayerNorm kernels {ln}, expected "
             f"{ln_batch * n_batches} forward")
    counts.update(ln)

    t0 = time.perf_counter()
    acc_dict, _, _ = inference_and_eval(keys_dict, seen_dict, unseen_dict, k_list=[1, 3, 5],
                                        query_chunk=4096, with_preds=False, device=device)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    table, csv_rows, _, _ = format_results(acc_dict, [1, 3, 5], "I,D,T")
    if len(csv_rows) < 2 or not acc_dict:
        fail(f"the {label} kNN grid is empty")
    lines = table.splitlines()
    print(f"{label} kNN grid: {len(csv_rows) - 1} rows; the table's head:")
    print("\n".join(lines[:6]))

    for name, d in (("all_keys", keys_dict), ("test_seen", seen_dict),
                    ("test_unseen", unseen_dict)):
        check_embeddings(name, d, split_rows[name], mc.output_dim)
    if keys_dict["all_key_features"].shape != (3 * split_rows["all_keys"], mc.output_dim):
        fail(f"all_key_features shape {keys_dict['all_key_features'].shape}")

    print(f"{label} extraction: {n_rows} samples in {t_extract:.3f} s = "
          f"{n_rows / t_extract:.2f} samples/s (bf16, batch {mc.batch_size}, tri-modal, "
          f"{n_batches} batches incl. ragged)  [{card}]")
    print(f"{label} kNN grid + metrics: {t_knn:.3f} s  [{card}]")

    # bf16 kernel path against the fp32 path on the 8 warm-up samples
    with torch.inference_mode():
        lo = clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                         compute_dtype=torch.bfloat16)
        hi = clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                         compute_dtype=torch.float32)
    for m in ("image", "dna", "language"):
        cos = (lo[m] * hi[m]).sum(-1) / (lo[m].norm(dim=-1) * hi[m].norm(dim=-1))
        print(f"{label} bf16 vs fp32 path, {m}: min cosine {float(cos.min()):.6f} "
              f"(need >= {COSINE_MIN})")
        if float(cos.min()) < COSINE_MIN:
            fail(f"{label}: bf16 path disagrees with the fp32 path for {m}")
    return counts


def train_slice_phase(card: str, label: str, gcfg, device, train_rows: dict) -> dict:
    """The recipe's `Trainer` over synthetic splits with the opt-in kernels
    off, then a fixed-batch descent and the gradients against the plain
    versions → the kernel launches of the fit (steps and evals)."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.checkpoint import load_model_any
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.train import (
        ScheduledAdamW,
        Trainer,
        batch_generator,
        make_loss_fn,
        make_train_step,
        remat_arg,
    )
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.models.layers import TransformerStack
    from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_bwd
    from clibd_tpu_torch.tools.profile_extract import plain_kernels

    mc = gcfg.model_config
    t0 = time.perf_counter()
    splits = {name: SyntheticSplit(name, n, mc, seed=10 + i)
              for i, (name, n) in enumerate(train_rows.items())}
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    n_trainable = sum(p.numel() for _, p in trainable)
    print(f"{label} train set-up: {len(trainable)} trainable tensors, {n_trainable / 1e6:.1f} M "
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
        ln_per_step = []  # and of the LayerNorm kernels
        step_fn = trainer.step_fn

        def counted_step(batch, gen):
            f0, b0 = flash_attention_qkv.launches, flash_attention_qkv_bwd.launches
            ln0 = layernorm_counts()
            loss = step_fn(batch, gen)
            per_step.append((flash_attention_qkv.launches - f0,
                             flash_attention_qkv_bwd.launches - b0))
            ln_per_step.append(tuple(n - ln0[k] for k, n in layernorm_counts().items()))
            if len(per_step) == 1:  # the first step's gradients are still on the parameters
                bad = [n for n, p in trainable
                       if p.grad is None or not bool(torch.isfinite(p.grad).all())
                       or float(p.grad.abs().max()) == 0.0]
                if bad:
                    fail(f"after the first step {len(bad)} trainable tensors have no finite "
                         f"nonzero gradient: {bad[:8]}")
                print(f"{label} first step: all {len(trainable)} trainable tensors have a finite, "
                      f"nonzero gradient")
            return loss

        trainer.step_fn = counted_step
        reset_counts()
        ln_fit0 = layernorm_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = trainer.fit()
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer.close()
        n_layers = mc.image.vit.num_layers + mc.dna.bert.num_layers + mc.language.bert.num_layers
        steps = mc.epochs * len(splits["train"])
        counts = read_counts()  # train steps and evals
        print(f"{label} kernel launches per train step (forward, backward): "
              f"{sorted(set(per_step))} over {len(per_step)} steps (expected ({n_layers}, "
              f"{n_layers}) x {steps})")
        others = {k: n for k, n in counts.items()
                  if k not in ("flash_attention_qkv", "flash_attention_qkv_bwd")}
        if len(per_step) != steps or set(per_step) != {(n_layers, n_layers)} \
                or any(others.values()):
            fail(f"{label} train steps launched {per_step}, expected ({n_layers}, {n_layers}) x "
                 f"{steps}, and the other kernels {others}, expected none")
        # each LayerNorm once forward and once backward, and the blocks' again
        # where the remat policy recomputes them
        ln_batch = layernorm_per_batch(model)
        recomputed = 2 * sum(m.num_layers for m in model.modules()
                             if isinstance(m, TransformerStack)) if remat_arg(mc) else 0
        ln_want = (ln_batch + recomputed, ln_batch)
        print(f"{label} LayerNorm launches per train step (forward, backward): "
              f"{sorted(set(ln_per_step))} over {len(ln_per_step)} steps (expected {ln_want}: "
              f"{ln_batch} a forward, {recomputed} recomputed)")
        if set(ln_per_step) != {ln_want}:
            fail(f"{label} train steps launched the LayerNorm kernels {ln_per_step}, expected "
                 f"{ln_want} each")
        counts.update({k: n - ln_fit0[k] for k, n in layernorm_counts().items()})
        losses = [d["loss"] for d in logs if "loss" in d]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"train losses {losses}")
        grids = [d for d in logs if any("||top-" in k for k in d)]
        if len(history["overall_acc"]) != mc.epochs or len(grids) != mc.epochs or not all(grids):
            fail(f"{label}: expected {mc.epochs} evals with a grid each: "
                 f"{history['overall_acc']}")
        for sub in ("last", "best"):
            if not os.path.exists(os.path.join(out_dir, sub, "params.npz")):
                fail(f"{sub}/ was not written")
        reloaded = load_model_any(os.path.join(out_dir, "best"), mc, device)
        n_reloaded = sum(p.numel() for p in reloaded.parameters())
        if n_reloaded != sum(p.numel() for p in model.parameters()):
            fail("best/ reloads with another parameter count")
        del reloaded
    rates = [d["throughput/samples_per_sec_per_chip"] for d in logs
             if "throughput/samples_per_sec_per_chip" in d]
    print(f"{label} train losses: {[round(v, 4) for v in losses]}")
    print(f"{label} evals: overall_acc {history['overall_acc']}, best epoch "
          f"{history['best_epoch']}")
    print(f"{label} train: {steps} steps of batch {mc.batch_size} + {mc.epochs} evals in "
          f"{t_fit:.2f} s; samples/s "
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
    print(f"{label} fixed batch, constant LR 5e-5: losses {[round(v, 5) for v in fixed_losses]}")
    if not fixed_losses[-1] < fixed_losses[0]:
        fail(f"{label}: 5 steps on a fixed batch did not lower its loss")
    opt.zero_grad(set_to_none=True)

    # kernels against the plain versions on the card: bf16 gradients, 16 samples
    small = {k: head(fixed[k], 16) for k in ("image", "dna", "language", "label")}
    params = [p for _, p in trainable]

    def grads():
        loss = loss_fn(small, batch_generator(device, 0, 0, 1))
        return [g.float() for g in torch.autograd.grad(loss, params)]

    with_kernels = grads()
    with plain_kernels():
        with_plain = grads()
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(with_kernels, with_plain)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    print(f"{label} bf16 gradients, kernels vs plain versions on the card (16 samples): min cosine "
          f"{cos[worst]:.6f} at {trainable[worst][0]} over {len(cos)} tensors "
          f"(need >= {COSINE_MIN})")
    if not all(c >= COSINE_MIN for c in cos):
        fail(f"{label}: gradients through the kernels disagree with the plain versions")
    return counts


def rel_err(got, want) -> float:
    """max |got - want| / max |want|; 0 where both are all zeros (the phased
    backward's dq and dk at N=1)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def kernel_counters():
    from clibd_tpu_torch.ops.attention import (attention_bhnd, flash_attention_qkv,
                                               flash_attention_qkv_batched,
                                               flash_attention_qkv_bwd,
                                               flash_attention_qkv_bwd_phased,
                                               flash_attention_qkv_outproj,
                                               flash_attention_qkv_phased)
    from clibd_tpu_torch.ops.elementwise import scale_copy
    from clibd_tpu_torch.ops.gemm import tiled_matmul
    from clibd_tpu_torch.ops.mlp import fused_mlp

    return {"flash_attention_qkv": flash_attention_qkv,
            "flash_attention_qkv_bwd": flash_attention_qkv_bwd,
            "flash_attention_qkv_outproj": flash_attention_qkv_outproj, "fused_mlp": fused_mlp,
            "scale_copy": scale_copy, "tiled_gemm": tiled_matmul,
            "attention_bhnd": attention_bhnd,
            "flash_attention_qkv_phased": flash_attention_qkv_phased,
            "flash_attention_qkv_batched": flash_attention_qkv_batched,
            "flash_attention_qkv_bwd_phased": flash_attention_qkv_bwd_phased}


def reset_counts() -> None:
    for f in kernel_counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in kernel_counters().items()}


def add_launches(entries: dict, path: str, counts: dict) -> None:
    """Add one main-path run's launches to the summary entries (the kernels
    that have one)."""
    for name, n in counts.items():
        if name not in entries:
            continue
        entries[name]["launches"] = (entries[name]["launches"] or 0) + n
        entries[name].setdefault("launches_by_path", {})[path] = n


def layernorm_kernel_phase(card: str) -> list:
    """The LayerNorm kernels against their plain versions at LN_SHAPES, bf16
    fast math, and timed → the `kernels` line's entries for `layernorm`
    and `layernorm_bwd`."""
    import torch
    import torch.nn.functional as F

    from clibd_tpu_torch.ops.layernorm import (layernorm_bwd_cuda, layernorm_bwd_reference,
                                               layernorm_cuda, layernorm_reference,
                                               layernorm_stats_reference)
    from clibd_tpu_torch.utils.profiling import cuda_ms

    def autograd_plain(x, scale, bias, eps, dy):
        """the backward the port ran before the kernel: autograd through the
        plain forward"""
        xs, ss, bs = (t.detach().requires_grad_(True) for t in (x, scale, bias))
        return torch.autograd.grad(layernorm_reference(xs, ss, bs, eps, True), (xs, ss, bs), dy)

    fwd_shapes, bwd_shapes = [], []
    for i, (name, R, D, eps) in enumerate(LN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = (torch.randn(R, D, generator=g, device="cuda") * 3 + 1).to(torch.bfloat16)
        scale = torch.randn(D, generator=g, device="cuda") * 0.5 + 1
        bias = torch.randn(D, generator=g, device="cuda")
        dy = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
        y, mean, rstd = layernorm_cuda(x, scale, bias, eps, True)
        want = layernorm_stats_reference(x, scale, bias, eps, True)
        grads = layernorm_bwd_cuda(x, dy, scale, mean, rstd, True)
        want_grads = layernorm_bwd_reference(x, dy, scale, mean, rstd, True)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (y, *grads)):
            fail(f"LayerNorm kernel output not finite at {name}")
        rel = {"y": rel_err(y, want[0]), "dx": rel_err(grads[0], want_grads[0]),
               "dscale": rel_err(grads[1], want_grads[1]),
               "dbias": rel_err(grads[2], want_grads[2])}
        stats = max(rel_err(mean, want[1]), rel_err(rstd, want[2]))
        same = float((y == want[0]).float().mean())
        print(f"kernel layernorm {name} R={R} D={D}: max|kernel-plain|/max|plain| "
              f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (tol {LN_REL_TOL}), statistics "
              f"{stats:.3e}, y equal bit for bit {100 * same:.3f}%")
        if max(rel.values()) > LN_REL_TOL or stats > 2 ** -7:
            fail(f"LayerNorm kernels disagree with their plain versions at {name}: {rel}, "
                 f"statistics {stats}")
        if i == 0:
            again = layernorm_cuda(x, scale, bias, eps, True)
            again_grads = layernorm_bwd_cuda(x, dy, scale, mean, rstd, True)
            if not (all(torch.equal(a, b) for a, b in zip((y, mean, rstd), again))
                    and all(torch.equal(a, b) for a, b in zip(grads, again_grads))):
                fail("two launches of a LayerNorm kernel on the same inputs differ")
            print("kernel layernorm vit: two launches of each direction bit-identical "
                  "(y, mean, rstd; dx, dscale, dbias)")
            del again, again_grads
        fwd_err = float((y.float() - want[0].float()).abs().max())
        bwd_err = float((grads[0].float() - want_grads[0].float()).abs().max())
        del y, want, grads, want_grads
        w16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [D], w16, b16, eps)
        times = {
            "fwd": cuda_ms(lambda: layernorm_cuda(x, scale, bias, eps, True)),
            "fwd_plain": cuda_ms(lambda: layernorm_reference(x, scale, bias, eps, True)),
            "fwd_library": cuda_ms(lambda: F.layer_norm(x, (D,), w16, b16, eps)),
            "bwd": cuda_ms(lambda: layernorm_bwd_cuda(x, dy, scale, mean, rstd, True)),
            "bwd_plain": cuda_ms(lambda: layernorm_bwd_reference(x, dy, scale, mean, rstd, True)),
            "bwd_autograd": cuda_ms(lambda: autograd_plain(x, scale, bias, eps, dy)),
            "bwd_library": cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [D], lmean, lrstd, w16, b16, [True, True, True]))}
        fwd_bound, fwd_by = bound(4 * R * D + 8 * R + 8 * D, 0)
        bwd_bound, bwd_by = bound(6 * R * D + 8 * R + 12 * D, 0)
        print(f"time layernorm {name} R={R} D={D}: forward kernel {times['fwd']:.4f} ms "
              f"({4 * R * D / times['fwd'] / 1e9:.2f} TB/s), plain {times['fwd_plain']:.4f}, "
              f"library {times['fwd_library']:.4f}, bound {fwd_bound:.4f}; backward kernel "
              f"{times['bwd']:.4f} ms ({6 * R * D / times['bwd'] / 1e9:.2f} TB/s), plain "
              f"{times['bwd_plain']:.4f}, autograd through the plain forward "
              f"{times['bwd_autograd']:.4f}, library {times['bwd_library']:.4f}, bound "
              f"{bwd_bound:.4f}  [{card}]")
        common = {"shape": name, "R": R, "D": D}
        fwd_shapes.append({**common, "ms": times["fwd"], "plain_ms": times["fwd_plain"],
                           "library_ms": times["fwd_library"], "bound_ms": fwd_bound,
                           "bound_by": fwd_by, "max_abs_err": fwd_err})
        bwd_shapes.append({**common, "ms": times["bwd"], "plain_ms": times["bwd_plain"],
                           "autograd_plain_ms": times["bwd_autograd"],
                           "library_ms": times["bwd_library"], "bound_ms": bwd_bound,
                           "bound_by": bwd_by, "max_abs_err": bwd_err})
        del x, dy, mean, rstd, lmean, lrstd
    torch.cuda.empty_cache()
    replaces = "none: XLA fuses clibd_tpu/models/layers.py::layernorm"
    return [kernel_entry("layernorm", "clibd_tpu_torch/csrc/layernorm.cu", replaces, fwd_shapes),
            kernel_entry("layernorm_bwd", "clibd_tpu_torch/csrc/layernorm.cu", replaces,
                         bwd_shapes)]


def layernorm_counts() -> dict:
    from clibd_tpu_torch.ops.layernorm import layernorm, layernorm_bwd

    return {"layernorm": layernorm.launches, "layernorm_bwd": layernorm_bwd.launches}


def layernorm_per_batch(model) -> int:
    """LayerNorm calls of one forward of `model`: its LayerNorm modules once
    (the ViT's class-row norm, the BERTs' embedding norms, the MLM head's)
    and two in every block of its towers."""
    from clibd_tpu_torch.models.layers import LayerNorm, TransformerStack

    return sum(isinstance(m, LayerNorm) for m in model.modules()) + 2 * sum(
        m.num_layers for m in model.modules() if isinstance(m, TransformerStack))


def outproj_kernel_phase(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.attention import (
        flash_attention_qkv_bwd_cuda,
        flash_attention_qkv_cuda,
        flash_attention_qkv_outproj,
        flash_attention_qkv_outproj_cuda,
        flash_attention_qkv_outproj_reference,
    )
    from clibd_tpu_torch.utils.profiling import cuda_ms

    def weights(D, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        w = (torch.randn(D, D, generator=g, device="cuda") / math.sqrt(D)).to(torch.bfloat16)
        return w, (0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)

    def library(qkv, w, b, H, mask):
        """SDPA, then addmm: the yardstick, for timing only"""
        B, N, three_d = qkv.shape
        ctx = library_attention(qkv, H, mask).transpose(1, 2).reshape(B * N, three_d // 3)
        return torch.addmm(b, ctx, w)

    edge_err = 0.0
    for B, N, H, masked in OUTPROJ_EDGES:
        w, b = weights(H * 64, seed=B + N)
        qkv, mask = make_qkv(B, N, H, masked, seed=B + N + H)
        got = flash_attention_qkv_outproj_cuda(qkv, w, b, H, mask)
        want = flash_attention_qkv_outproj_reference(qkv, w, b, H, mask)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        masked_rel = rel_err(got[0], want[0]) if masked else 0.0
        print(f"kernel flash_attention_qkv_outproj edge B={B} N={N} H={H} mask={masked}: "
              f"max|kernel-plain|/max|plain| {rel:.3e}"
              + (f", fully masked row {masked_rel:.3e}" if masked else "") + f" (tol {REL_TOL})")
        if not torch.isfinite(got).all() or rel > REL_TOL or masked_rel > REL_TOL:
            fail(f"out-projection kernel disagrees with its plain version at B={B} N={N} H={H}")
        edge_err = max(edge_err, float((got.float() - want.float()).abs().max()))

    shapes = []
    for name, N, H, masked in SHAPES:
        D = H * 64
        w, b = weights(D, seed=N)
        err, plain_B = 0.0, plain_batch(N)
        for B in sorted({64, plain_B}):
            qkv, mask = make_qkv(B, N, H, masked, seed=N + B + 2)
            got = flash_attention_qkv_outproj_cuda(qkv, w, b, H, mask)
            want = flash_attention_qkv_outproj_reference(qkv, w, b, H, mask)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"out-projection kernel output not finite at {name} B={B}")
            rel = rel_err(got, want)
            masked_row = f", fully masked row {rel_err(got[0], want[0]):.3e}" if masked else ""
            print(f"kernel flash_attention_qkv_outproj {name} B={B} N={N} H={H} mask={masked}: "
                  f"max|kernel-plain|/max|plain| {rel:.3e}{masked_row} (tol {REL_TOL})")
            if rel > REL_TOL or (masked and rel_err(got[0], want[0]) > REL_TOL):
                fail(f"out-projection kernel disagrees with its plain version at {name} B={B}")
            err = max(err, float((got.float() - want.float()).abs().max()))
            if name == "vit" and B == 500:
                again = flash_attention_qkv_outproj_cuda(qkv, w, b, H, mask)
                if not torch.equal(got, again):
                    fail("two launches of the out-projection kernel on the same inputs differ")
                print("kernel flash_attention_qkv_outproj vit B=500: two launches on the same "
                      "inputs are bit-identical")
                del again
            del got, want
            if B == plain_B:
                plain_ms = cuda_ms(lambda: flash_attention_qkv_outproj_reference(qkv, w, b, H,
                                                                                 mask))
        if plain_B != 500:
            qkv, mask = make_qkv(500, N, H, masked, seed=N + 502)
        ms = cuda_ms(lambda: flash_attention_qkv_outproj_cuda(qkv, w, b, H, mask))
        library_ms = cuda_ms(lambda: library(qkv, w, b, H, mask))
        flops = 4 * 500 * H * N * N * 64 + 2 * 500 * N * D * D
        nbytes = 500 * N * (3 * D + D) * 2 + (D * D + D) * 2 + (500 * N * 4 if masked else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        # modelled, not measured: every CTA (64 query rows) reads all of
        # W_out from L2 once, D*D bf16
        l2_bytes = 500 * -(-N // 64) * D * D * 2
        print(f"time flash_attention_qkv_outproj {name} B=500: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms (B={plain_B}), "
              f"library (sdpa + addmm) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); modelled W_out reads from L2: "
              f"{D * D * 2 / 1e6:.2f} MB a CTA, {l2_bytes / 1e9:.2f} GB a call  [{card}]")
        shapes.append({"shape": name, "B": 500, "N": N, "H": H, "ms": ms, "plain_ms": plain_ms,
                       "plain_B": plain_B, "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err})
        del qkv, mask
    torch.cuda.empty_cache()

    # autograd through the operator equals the composed backward (B=16)
    qkv, mask = make_qkv(16, 20, 8, True, seed=9)
    w, b = weights(512, seed=9)
    leaves = [t.detach().requires_grad_() for t in (qkv, w, b)]
    dout = torch.randn(16, 20, 512, device="cuda", dtype=torch.bfloat16)
    got = torch.autograd.grad(flash_attention_qkv_outproj(leaves[0], leaves[1], leaves[2], 8,
                                                          mask), leaves, dout)
    dctx = torch.matmul(dout, w.t())
    ctx = flash_attention_qkv_cuda(qkv, 8, mask)
    want = (flash_attention_qkv_bwd_cuda(qkv, dctx, 8, mask),
            torch.matmul(ctx.reshape(-1, 512).t(), dout.reshape(-1, 512)),
            dout.float().sum(dim=(0, 1)).to(b.dtype))
    for part, a, e in zip(("qkv", "W_out", "bias"), got, want):
        if not torch.equal(a, e):
            fail(f"autograd through the out-projection operator differs from the composed "
                 f"backward for {part}: max|Δ| {float((a.float() - e.float()).abs().max())}")
    print("autograd.grad through the out-projection operator equals the composed backward "
          "for qkv, W_out and the bias (B=16)")
    shapes[0]["max_abs_err"] = max(shapes[0]["max_abs_err"], edge_err)
    return kernel_entry("flash_attention_qkv_outproj",
                        "clibd_tpu_torch/csrc/flash_attention_qkv_outproj.cu",
                        "clibd_tpu/ops/pallas/attention.py:313", shapes)


def fused_mlp_kernel_phase(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from clibd_tpu_torch.ops.elementwise import scale_copy
    from clibd_tpu_torch.ops.mlp import fused_mlp_cuda, fused_mlp_reference
    from clibd_tpu_torch.utils.profiling import cuda_ms

    def library(x, w1, b1, w2, b2):
        """addmm, tanh GELU, addmm: the yardstick, for timing only"""
        return torch.addmm(b2, F.gelu(torch.addmm(b1, x, w1), approximate="tanh"), w2)

    shapes = []
    for i, (name, R, D, Fd, act) in enumerate(MLP_SHAPES + MLP_EXTRA):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn(R, D, generator=g, device="cuda").to(torch.bfloat16)
        w1 = (torch.randn(D, Fd, generator=g, device="cuda") / math.sqrt(D)).to(torch.bfloat16)
        w2 = (torch.randn(Fd, D, generator=g, device="cuda") / math.sqrt(Fd)).to(torch.bfloat16)
        b1 = (0.1 * torch.randn(Fd, generator=g, device="cuda")).to(torch.bfloat16)
        b2 = (0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)
        got = fused_mlp_cuda(x, w1, b1, w2, b2, act)
        want = fused_mlp_reference(x, w1, b1, w2, b2, act)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"fused-MLP kernel output not finite at {name}")
        rel = rel_err(got, want)
        print(f"kernel fused_mlp {name} R={R} D={D} F={Fd} {act}: max|kernel-plain|/max|plain| "
              f"{rel:.3e} (tol {REL_TOL})")
        if rel > REL_TOL:
            fail(f"fused-MLP kernel disagrees with its plain version at {name}: {rel}")
        err = float((got.float() - want.float()).abs().max())
        if i == 0:
            again = fused_mlp_cuda(x, w1, b1, w2, b2, act)
            if not torch.equal(got, again):
                fail("two launches of the fused-MLP kernel on the same inputs differ")
            print("kernel fused_mlp vit: two launches on the same inputs are bit-identical")
            del again
        del got, want
        if i < len(MLP_SHAPES):
            ms = cuda_ms(lambda: fused_mlp_cuda(x, w1, b1, w2, b2, act))
            plain_ms = cuda_ms(lambda: fused_mlp_reference(x, w1, b1, w2, b2, act))
            library_ms = cuda_ms(lambda: library(x, w1, b1, w2, b2))
            flops = 4 * R * D * Fd
            nbytes = (2 * R * D + 2 * D * Fd + Fd + D) * 2
            bound_ms, bound_by = bound(nbytes, flops)
            # modelled, not measured: each cluster of two CTAs (128 rows)
            # reads both weights from L2 once, each CTA half of every box,
            # multicast into both
            l2_bytes = -(-R // MLP_CLUSTER_ROWS) * 4 * D * Fd
            print(f"time fused_mlp {name} R={R}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), plain {plain_ms:.4f} ms, library (addmm + gelu + addmm) "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); modelled weight "
                  f"reads from L2: {2 * D * Fd / 1e6:.2f} MB a CTA, {l2_bytes / 1e9:.2f} GB a "
                  f"call, over the kernel's ms {l2_bytes / ms / 1e9:.2f} TB/s  [{card}]")
            shapes.append({"shape": name, "R": R, "D": D, "F": Fd, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "max_abs_err": err})
        else:
            shapes[0]["max_abs_err"] = max(shapes[0]["max_abs_err"], err)
        del x, w1, w2, b1, b2
    # The L2's copy rate, read plus write bytes: buffers of 4-16 MB, which
    # fit the 50 MB L2, one launch each; the slope of time against bytes
    # leaves out each launch's fixed cost, which a single 16 MB copy mostly
    # times.  scale_copy streams (evict-first hints), torch.mul does not.
    nbytes = [2 * (mb << 20) for mb in L2_PROBE_MB]
    for label, op in (("scale_copy", scale_copy), ("torch.mul", lambda b: torch.mul(b, 2.0))):
        times = []
        for mb in L2_PROBE_MB:
            buf = torch.randn(mb << 18, generator=g, device="cuda")
            times.append(cuda_ms(lambda: op(buf), warmup=5, iters=50))
            del buf
        slope, fixed = np.polyfit(nbytes, times, 1)
        print(f"time L2 copy, {label}, {L2_PROBE_MB[0]}-{L2_PROBE_MB[-1]} MB fp32: "
              f"{[round(t, 4) for t in times]} ms; slope {1 / slope / 1e9:.2f} TB/s read + write, "
              f"{fixed * 1e3:.2f} us fixed  [{card}]")
    torch.cuda.empty_cache()
    return kernel_entry("fused_mlp", "clibd_tpu_torch/csrc/fused_mlp.cu",
                        "clibd_tpu/ops/pallas/mlp.py:49", shapes)


def recipe_config(experiment: str, epochs: int):
    """A tri-modal full fine-tune recipe (bf16, batch 500, remat "attn"), set
    to `epochs` epochs with an eval after each."""
    from clibd_tpu_torch.config import load_config

    gcfg = load_config(experiment=experiment, overrides=[f"model_config.epochs={epochs}",
                                                         "model_config.eval_skip_epoch=-1"])
    mc = gcfg.model_config
    if not (mc.amp and mc.disable_lora and mc.batch_size == 500 and mc.image.enable
            and mc.dna.enable and mc.language.enable and mc.remat and mc.remat_policy == "attn"):
        fail(f"{experiment} is not a bf16 tri-modal full fine-tune recipe at batch 500 "
             "with remat 'attn'")
    if experiment == OVERLAP and (mc.dna.tokenizer, mc.dna.kmer, mc.dna.stride, mc.dna.max_bp) \
            != ("overlap", 4, 1, 660):
        fail(f"{OVERLAP} is not the overlap tokenizer at k=4, stride 1, 660 bp (N=657)")
    return gcfg


def bioclip_config():
    from clibd_tpu_torch.config import load_config

    gcfg = load_config(experiment=BIOCLIP)
    mc = gcfg.model_config
    c = mc.clip
    if not (mc.backbone == "open_clip" and mc.amp and mc.batch_size == 500 and mc.image.freeze
            and mc.language.freeze and not mc.dna.freeze and mc.loss.bind_to == "image"
            and (c.vision_hidden, c.vision_layers, c.text_hidden, c.text_layers, c.embed_dim)
            == (768, 12, 512, 12, 512) and mc.remat and mc.remat_policy == "attn"):
        fail(f"{BIOCLIP} is not the bf16 BioCLIP recipe at batch 500 with frozen image and "
             "text towers and remat 'attn'")
    return gcfg


def cosine_rows(a, b):
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def bioclip_eval_phase(card: str, entries: dict, device, split_rows: dict) -> None:
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.evaluate import format_results, inference_and_eval
    from clibd_tpu_torch.engine.extract import extract_split, make_encode_step, to_device
    from clibd_tpu_torch.models import clibd_apply, init_clibd_model
    from clibd_tpu_torch.models.layers import kernel_knobs

    mc = bioclip_config().model_config
    t0 = time.perf_counter()
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    splits = {name: SyntheticSplit(name, n, mc, seed=20 + i)
              for i, (name, n) in enumerate(split_rows.items())}
    print(f"BioCLIP eval set-up: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params "
          f"in {time.perf_counter() - t0:.1f} s")
    b = next(splits["test_seen"].batches())
    small = to_device({"image": b["image"][:8], "dna": b["dna"][:8],
                       "language": {k: v[:8] for k, v in b["language"].items()}}, device)
    with kernel_knobs(True, "pallas"):
        make_encode_step(mc, model, torch.bfloat16)(small)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dicts = {"all_keys": extract_split(model, mc, splits["all_keys"], for_key_set=True),
                 "test_seen": extract_split(model, mc, splits["test_seen"]),
                 "test_unseen": extract_split(model, mc, splits["test_unseen"])}
        torch.cuda.synchronize()
        t_extract = time.perf_counter() - t0
        counts = read_counts()
    n_batches = sum(len(s) for s in splits.values())
    n_rows = sum(split_rows.values())
    layers = (mc.clip.vision_layers, mc.dna.bert.num_layers, mc.clip.text_layers)
    expected = {"flash_attention_qkv": 0, "flash_attention_qkv_bwd": 0,
                "flash_attention_qkv_outproj": (layers[0] + layers[1]) * n_batches,
                "fused_mlp": sum(layers) * n_batches,
                **dict.fromkeys(PROBE_KERNELS + EXP_FLASH_KERNELS, 0)}
    print(f"BioCLIP eval launches over {n_batches} batches: {counts} (expected {expected})")
    if counts != expected:
        fail(f"BioCLIP eval launched {counts}, expected {expected}")
    add_launches(entries, "bioclip_eval", counts)

    acc_dict, _, _ = inference_and_eval(dicts["all_keys"], dicts["test_seen"],
                                        dicts["test_unseen"], k_list=[1, 3, 5], query_chunk=4096,
                                        with_preds=False, device=device)
    _, csv_rows, _, _ = format_results(acc_dict, [1, 3, 5], "I,D,T")
    if len(csv_rows) < 2 or not acc_dict:
        fail("the BioCLIP kNN grid is empty")
    for name, d in dicts.items():
        for m in ("image", "dna", "language"):
            emb = d[f"encoded_{m}_feature"]
            if emb.shape != (split_rows[name], mc.output_dim) or not np.isfinite(emb).all():
                fail(f"BioCLIP {name} {m} embeddings: shape {emb.shape} or not finite")
            if float(np.abs(np.linalg.norm(emb, axis=1) - 1).max()) > 1e-3:
                fail(f"BioCLIP {name} {m} embeddings not unit-norm")
    print(f"BioCLIP kNN grid: {len(csv_rows) - 1} rows; embeddings finite, unit-norm, "
          f"{mc.output_dim}-d")
    print(f"BioCLIP extraction, kernels on: {n_rows} samples in {t_extract:.3f} s = "
          f"{n_rows / t_extract:.2f} samples/s (bf16, batch {mc.batch_size}, {n_batches} "
          f"batches incl. ragged)  [{card}]")

    def embed(dtype, fused):
        with torch.inference_mode(), kernel_knobs(fused, "pallas" if fused else "xla"):
            return clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                               compute_dtype=dtype)

    on16, on32, off16 = (embed(torch.bfloat16, True), embed(torch.float32, True),
                         embed(torch.bfloat16, False))
    for m in ("image", "dna", "language"):
        c32 = float(cosine_rows(on16[m], on32[m]).min())
        coff = float(cosine_rows(on16[m], off16[m]).min())
        print(f"BioCLIP {m}: min cosine bf16 vs fp32 (kernels on) {c32:.6f}, kernels on vs off "
              f"(bf16) {coff:.6f} (need >= {COSINE_MIN})")
        if min(c32, coff) < COSINE_MIN:
            fail(f"BioCLIP {m} embeddings disagree across precisions or kernel settings")
    del model


def bioclip_train_phase(card: str, entries: dict, device) -> None:
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.schedules import build_schedule
    from clibd_tpu_torch.engine.train import (batch_generator, build_optimizer, make_loss_fn,
                                              make_train_step)
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.models.layers import kernel_knobs
    from clibd_tpu_torch.tools.profile_extract import plain_kernels

    mc = bioclip_config().model_config
    B = mc.batch_size
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    frozen_towers = [n for n, p in model.named_parameters()
                     if n.startswith(("clip_vision.", "clip_text.")) and p.requires_grad]
    if frozen_towers or not all(n == "logit_scale" or n.startswith("dna_encoder.")
                                for n, _ in trainable):
        fail(f"BioCLIP trainable set is not BarcodeBERT + logit_scale: {frozen_towers[:4]}")
    split = SyntheticSplit("train", BIOCLIP_TRAIN_STEPS * B, mc, seed=30)
    optimizer = build_optimizer(mc, model, build_schedule(mc.optim, BIOCLIP_TRAIN_STEPS, B))
    step = make_train_step(mc, model, optimizer)
    n_l = (mc.clip.vision_layers, mc.dna.bert.num_layers, mc.clip.text_layers)
    expected = {"flash_attention_qkv": n_l[1], "flash_attention_qkv_bwd": n_l[1],
                "flash_attention_qkv_outproj": n_l[0] + n_l[1],
                "fused_mlp": sum(n_l) + n_l[1],
                **dict.fromkeys(PROBE_KERNELS + EXP_FLASH_KERNELS, 0)}
    losses, per_step, times = [], [], []
    with kernel_knobs(True, "pallas"):
        batches = [to_device({k: v for k, v in bt.items() if k != "index"}, device)
                   for bt in split.batches()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for i, batch in enumerate(batches):
            before = read_counts()
            t0 = time.perf_counter()
            losses.append(float(step(batch, batch_generator(device, mc.default_seed, 0, i))))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append({k: v - before[k] for k, v in read_counts().items()})
            if i == 0:
                bad = [n for n, p in trainable
                       if p.grad is None or not bool(torch.isfinite(p.grad).all())
                       or float(p.grad.abs().max()) == 0.0]
                if bad:
                    fail(f"after the first BioCLIP step {len(bad)} trainable tensors have no "
                         f"finite nonzero gradient: {bad[:8]}")
        total = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"BioCLIP train: {len(trainable)} trainable tensors, all with a finite nonzero "
          f"gradient after step 1; launches per step {per_step} (expected {expected} each)")
    if any(c != expected for c in per_step):
        fail(f"BioCLIP train steps launched {per_step}, expected {expected} each")
    add_launches(entries, "bioclip_train", total)
    if not all(math.isfinite(v) for v in losses):
        fail(f"BioCLIP train losses {losses}")
    rate = B * (len(times) - 1) / sum(times[1:])
    print(f"BioCLIP train losses: {[round(v, 5) for v in losses]}; {B / times[0]:.2f} samples/s "
          f"in step 1, {rate:.2f} over steps 2-{len(times)} (CUDA-synchronised); peak device "
          f"memory {peak_gb:.2f} GiB  [{card}]")

    small = {k: ({kk: vv[:16] for kk, vv in v.items()} if isinstance(v, dict) else v[:16])
             for k, v in batches[0].items()}
    loss_fn = make_loss_fn(mc, model)
    params = [p for _, p in trainable]

    def grads():
        loss = loss_fn(small, batch_generator(device, 0, 0, 1))
        return [g.float() for g in torch.autograd.grad(loss, params)]

    optimizer.zero_grad(set_to_none=True)
    with kernel_knobs(True, "pallas"):
        with_kernels = grads()
        with plain_kernels():
            with_plain = grads()
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(with_kernels, with_plain)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    print(f"BioCLIP bf16 gradients, kernels vs plain versions on the card (16 samples): min "
          f"cosine {cos[worst]:.6f} at {trainable[worst][0]} over {len(cos)} tensors "
          f"(need >= {COSINE_MIN})")
    if not all(c >= COSINE_MIN for c in cos):
        fail("BioCLIP gradients through the kernels disagree with the plain versions")
    del model, optimizer


def scale_copy_checks(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.elementwise import scale_copy_cuda, scale_copy_reference
    from clibd_tpu_torch.utils.profiling import cuda_ms

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8192, 2048), dtype=np.float32)).cuda()
    edges = [(f"{n} elements", torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).cuda())
             for n in COPY_EDGES]
    for name, t in [("[8192, 2048]", x)] + edges:
        exact = torch.equal(scale_copy_cuda(t), scale_copy_reference(t))
        print(f"kernel scale_copy {name}: bit-exact against x * 2.0: {exact}")
        if not exact:
            fail(f"scale_copy differs from x * 2.0 on {name}")
    del edges
    if not torch.equal(scale_copy_cuda(x), scale_copy_cuda(x)):
        fail("two launches of scale_copy on [8192, 2048] differ")
    print("kernel scale_copy [8192, 2048]: two launches bit-identical")
    y = torch.empty_like(x)
    ms = cuda_ms(lambda: scale_copy_cuda(x))
    plain_ms = cuda_ms(lambda: scale_copy_reference(x))
    library_ms = cuda_ms(lambda: torch.mul(x, 2.0))
    copy_ms = cuda_ms(lambda: y.copy_(x))
    nbytes = 2 * x.nbytes
    bound_ms, bound_by = bound(nbytes, x.numel(), FP32_FLOPS_PER_S)
    print(f"time scale_copy fp32 [8192, 2048]: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
          f"{bound_ms / ms:.1%} of {HBM_BYTES_PER_S / 1e12} TB/s), plain {plain_ms:.4f} ms, "
          f"library torch.mul {library_ms:.4f} ms ({nbytes / library_ms / 1e6:.1f} GB/s), "
          f"y.copy_(x) {copy_ms:.4f} ms ({nbytes / copy_ms / 1e6:.1f} GB/s), bound "
          f"{bound_ms:.4f} ms ({bound_by})  [{card}]")
    shape = {"shape": "fp32 [8192, 2048]", "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "copy_ms": copy_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "max_abs_err": 0.0}
    return kernel_entry("scale_copy", "clibd_tpu_torch/csrc/scale_copy.cu",
                        "tools/exp_attn.py:35", [shape])


def gemm_checks(card: str) -> dict:
    import torch

    from clibd_tpu_torch.ops.gemm import (TILES, tiled_matmul, tiled_matmul_cuda,
                                          tiled_matmul_reference)
    from clibd_tpu_torch.utils.profiling import cuda_ms

    out_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = []
    for M, N, K in GEMM_SHAPES:
        rng = np.random.default_rng(M + N + K)
        a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", torch.bfloat16)
                for s in ((M, K), (K, N)))
        shape = f"{M}^3" if M == N == K else f"M={M} N={N} K={K}"
        library_ms = cuda_ms(lambda: torch.matmul(a, b))
        flops = 2 * M * N * K
        for out, dtype in out_dtypes.items():
            want = tiled_matmul_reference(a, b, dtype).float()
            plain_ms = cuda_ms(lambda: tiled_matmul_reference(a, b, dtype), iters=5)
            tol = GEMM_REL_TOL[out] * float(want.abs().max())
            nbytes = 2 * (M * K + K * N) + M * N * dtype.itemsize
            bound_ms, bound_by = bound(nbytes, flops)
            for tile in TILES:
                got = tiled_matmul_cuda(a, b, tile, dtype)
                err = float((got.float() - want).abs().max())
                same = torch.equal(got, tiled_matmul_cuda(a, b, tile, dtype))
                del got
                if err > tol or not same:
                    fail(f"tiled_gemm {tile} {out} out at {shape}: max|kernel-plain| {err} "
                         f"(tol {tol}), two launches bit-identical: {same}")
                ms = cuda_ms(lambda: tiled_matmul_cuda(a, b, tile, dtype))
                print(f"kernel tiled_gemm {shape} {tile} {out} out: max|kernel-plain| {err:.3e} "
                      f"(tol {tol:.3e}), twice bit-identical; kernel {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound), plain "
                      f"{plain_ms:.4f} ms, cuBLAS bf16 {library_ms:.4f} ms "
                      f"({flops / library_ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.4f} ms "
                      f"({bound_by})  [{card}]")
                rows.append({"shape": f"{shape} {tile} {out} out", "M": M, "N": N, "K": K,
                             "tile": tile, "out": out, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "max_abs_err": err})
            del want
        del a, b
        torch.cuda.empty_cache()

    # a shape off the tile is refused before any launch
    a = torch.zeros(1000, 1024, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(1024, 1024, device="cuda", dtype=torch.bfloat16)
    before = tiled_matmul.launches
    for what, x, y in (("M=1000", a, b), ("K=1000", b[:, :1000], a)):
        try:
            tiled_matmul_cuda(x.contiguous(), y.contiguous(), "t64x64x64")
        except ValueError as e:
            print(f"tiled_gemm refuses {what} off the 64x64x64 tile: {e}")
        else:
            fail(f"tiled_gemm took {what}, off the 64x64x64 tile")
    if tiled_matmul.launches != before:
        fail("a refused tiled_gemm call launched the kernel")
    # headline: the fastest tile at 8192^3 with an fp32 out first
    best = min((r for r in rows if r["M"] == r["N"] == r["K"] == 8192 and r["out"] == "fp32"),
               key=lambda r: r["ms"])
    rows.remove(best)
    print(f"tiled_gemm's fastest tile at 8192^3, fp32 out: {best['tile']} {best['ms']:.4f} ms, "
          f"cuBLAS {best['library_ms']:.4f} ms  [{card}]")
    entry = kernel_entry("tiled_gemm", "clibd_tpu_torch/csrc/tiled_gemm.cu",
                         "tools/exp_attn.py:61, tools/exp_mxu.py:34, tools/exp_mxu2.py:39",
                         [best] + rows)
    return entry


def attention_bhnd_checks(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from clibd_tpu_torch.ops.attention import attention_bhnd_cuda, attention_bhnd_reference
    from clibd_tpu_torch.utils.profiling import cuda_ms

    def inputs(B, H, N):
        g = torch.Generator(device="cuda").manual_seed(B + H + N)
        return [torch.randn(B, H, N, 64, generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    def check(q, k, v, what):
        got = attention_bhnd_cuda(q, k, v)
        err = float((got.float() - attention_bhnd_reference(q, k, v).float()).abs().max())
        if not torch.isfinite(got).all() or err > KERNEL_TOL:
            fail(f"attention_bhnd disagrees with its plain version at {what}: {err}")
        return got, err

    edge_err = 0.0
    for B, H, N in BHND_EDGES:
        _, err = check(*inputs(B, H, N), f"edge B={B} H={H} N={N}")
        print(f"kernel attention_bhnd edge B={B} H={H} N={N}: max|kernel-plain| {err:.3e} "
              f"(tol {KERNEL_TOL})")
        edge_err = max(edge_err, err)
    shapes = []
    H = 12
    for B, N in BHND_SHAPES:
        q, k, v = inputs(B, H, N)
        got, err = check(q, k, v, f"B={B} N={N}")
        if not torch.equal(got, attention_bhnd_cuda(q, k, v)):
            fail(f"two launches of attention_bhnd at B={B} N={N} differ")
        del got
        ms = cuda_ms(lambda: attention_bhnd_cuda(q, k, v))
        plain_ms = cuda_ms(lambda: attention_bhnd_reference(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        flops = 4 * B * H * N * N * 64
        bound_ms, bound_by = bound(4 * B * H * N * 64 * 2, flops)
        print(f"kernel attention_bhnd B={B} H={H} N={N}: max|kernel-plain| {err:.3e} (tol "
              f"{KERNEL_TOL}), twice bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bound_ms / ms:.1%} of the bound), plain {plain_ms:.4f} ms, library "
              f"(sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        shapes.append({"shape": f"B={B} H={H} N={N}", "B": B, "N": N, "H": H, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": max(err, edge_err)})
        del q, k, v
    torch.cuda.empty_cache()
    return kernel_entry("attention_bhnd", "clibd_tpu_torch/csrc/attention_bhnd.cu",
                        "tools/exp_attn.py:129", shapes)


def check_wgmma_ptxas(build_info: dict) -> None:
    """The wgmma attention kernels' ptxas report no worse than before the
    core took its layout policies: no instance with more than
    WGMMA_MAX_STACK bytes of stack, and no warpgroup.arrive injected before
    a product (C7519)."""
    for name in WGMMA_ATTENTION_SOURCES:
        log = build_info[name]["log"]
        if not log:
            print(f"ptxas {name}.cu: loaded from an earlier build, no report to check")
            continue
        stack = max(int(m) for m in re.findall(r"(\d+) bytes stack frame", log))
        spills = max(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
        regs = max(int(m) for m in re.findall(r"Used (\d+) registers", log))
        injected = log.count("C7519")
        print(f"ptxas {name}.cu: at most {regs} registers, {stack} bytes of stack and {spills} "
              f"bytes of spill stores an instance, {injected} C7519 warnings (limits: "
              f"{WGMMA_MAX_STACK} bytes of stack, none)")
        if stack > WGMMA_MAX_STACK or injected:
            fail(f"ptxas' report of {name}.cu is worse than its recorded limits")


def probe_kernels_phase(card: str) -> dict:
    return {e["name"]: e for e in (scale_copy_checks(card), gemm_checks(card),
                                   attention_bhnd_checks(card))}


def probes_path_phase(card: str, entries: dict) -> None:
    """The chip-probe harnesses as a user runs them: every launch of the
    three probe kernels is counted, and the earlier kernels launch none."""
    import torch

    from clibd_tpu_torch.tools import exp_attn, exp_mxu, exp_mxu2

    t0 = time.perf_counter()
    reset_counts()
    attn = exp_attn.main(["all"])
    exp_attn.main(["extra"])
    gemm_rows = [r for r in exp_mxu.main([]) + exp_mxu2.main([]) if "tile" in r]
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"probes path: launches {counts} in {time.perf_counter() - t0:.1f} s  [{card}]")
    if any(counts[k] == 0 for k in PROBE_KERNELS) or \
            any(n for k, n in counts.items() if k not in PROBE_KERNELS):
        fail(f"the probes path launched {counts}: each probe kernel at least once, no other")
    for r in gemm_rows:
        if r["maxerr"] > GEMM_REL_TOL[r["out"]] * r["max_plain"]:
            fail(f"the harness's {r['name']} is off its plain version: maxerr {r['maxerr']}")
    if not math.isfinite(attn["attention_bhnd_maxerr"]):
        fail("exp_attn's attention_bhnd maxerr is not finite")
    add_launches(entries, "probes", {k: counts[k] for k in PROBE_KERNELS})


def exp_flash_kernels_phase(card: str) -> dict:
    """Phase 11: the three experiment kernels against their plain versions
    (and the phased backward against the backward kernel), timed beside the
    plain version, SDPA and the bound; refused shapes launch nothing."""
    import torch

    from clibd_tpu_torch.ops.attention import (
        flash_attention_qkv_batched_cuda,
        flash_attention_qkv_bwd_cuda,
        flash_attention_qkv_bwd_phased_cuda,
        flash_attention_qkv_bwd_reference,
        flash_attention_qkv_cuda,
        flash_attention_qkv_phased_cuda,
        flash_attention_qkv_reference,
    )
    from clibd_tpu_torch.utils.profiling import cuda_ms

    H, D = 12, 768
    fwd = {"flash_attention_qkv_phased": flash_attention_qkv_phased_cuda,
           "flash_attention_qkv_batched": flash_attention_qkv_batched_cuda}
    shapes = {name: [] for name in EXP_FLASH_KERNELS}
    edge_err = dict.fromkeys(EXP_FLASH_KERNELS, 0.0)

    def check_fwd(name, got, qkv, mask, Hh, what):
        """max |kernel - plain|, failing past KERNEL_TOL; the fully masked
        row (batch row 0 of a masked input) must be the mean of V"""
        want = flash_attention_qkv_reference(qkv, Hh, mask).float()
        got = got.float()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if mask is not None:
            v = qkv[0, :, 2 * Hh * 64:].float().mean(0)
            e = max(e, float((got[0] - v).abs().max()))
        print(f"kernel {name} {what}: max|kernel-plain| {e:.3e} (tol {KERNEL_TOL})")
        if not torch.isfinite(got).all() or e > KERNEL_TOL:
            fail(f"{name} disagrees with its plain version at {what}: {e}")
        return e

    def check_bwd(qkv, dout, mask, Hh, what):
        """the phased backward against its plain version and the backward
        kernel, per part, failing past BWD_REL_TOL → (its output, max
        |kernel - plain|)"""
        Dh = Hh * 64
        got = flash_attention_qkv_bwd_phased_cuda(qkv, dout, Hh, mask)
        plain = flash_attention_qkv_bwd_reference(qkv, dout, Hh, mask)
        v0 = flash_attention_qkv_bwd_cuda(qkv, dout, Hh, mask)
        torch.cuda.synchronize()
        rel = [rel_err(got[..., i * Dh:(i + 1) * Dh], plain[..., i * Dh:(i + 1) * Dh])
               for i in range(3)]
        rel_v0 = [rel_err(got[..., i * Dh:(i + 1) * Dh], v0[..., i * Dh:(i + 1) * Dh])
                  for i in range(3)]
        print(f"kernel flash_attention_qkv_bwd_phased {what}: max|kernel-plain|/max|plain| dq "
              f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e}; against the backward kernel dq "
              f"{rel_v0[0]:.3e} dk {rel_v0[1]:.3e} dv {rel_v0[2]:.3e} (tol {BWD_REL_TOL})")
        if not torch.isfinite(got).all() or max(rel + rel_v0) > BWD_REL_TOL:
            fail(f"the phased backward disagrees at {what}: {rel}, {rel_v0}")
        return got, float((got.float() - plain.float()).abs().max())

    # the wgmma forward kernels' edges, and every head group of the phased one
    for B, N, Hh, masked in EXP_FLASH_EDGES:
        qkv, mask = make_qkv(B, N, Hh, masked, seed=N + B + 11)
        for name, fn in fwd.items():
            edge_err[name] = max(edge_err[name], check_fwd(
                name, fn(qkv, Hh, mask), qkv, mask, Hh, f"edge B={B} N={N} H={Hh} mask={masked}"))
    for B, N, Hh, masked in BWD_PHASED_EDGES:
        qkv, mask = make_qkv(B, N, Hh, masked, seed=N + B + 17)
        g = torch.Generator(device="cuda").manual_seed(N + B + 19)
        dout = torch.randn(B, N, Hh * 64, generator=g, device="cuda").to(torch.bfloat16)
        _, e = check_bwd(qkv, dout, mask, Hh, f"edge B={B} N={N} H={Hh} mask={masked}")
        edge_err["flash_attention_qkv_bwd_phased"] = max(edge_err["flash_attention_qkv_bwd_phased"], e)
    del qkv, mask, dout
    qkv, mask = make_qkv(5, 197, H, True, seed=197 + 5 + 13)
    for G in EXP_FLASH_GROUPS:
        edge_err["flash_attention_qkv_phased"] = max(
            edge_err["flash_attention_qkv_phased"],
            check_fwd("flash_attention_qkv_phased", flash_attention_qkv_phased_cuda(qkv, H, mask, G),
                      qkv, mask, H, f"G={G} B=5 N=197 H={H} mask=True"))
    del qkv, mask
    for N, masked in EXP_FLASH_SHAPES:
        err = dict.fromkeys(EXP_FLASH_KERNELS, 0.0)
        for B in (5, 256):
            qkv, mask = make_qkv(B, N, H, masked, seed=N + B + 3)
            g = torch.Generator(device="cuda").manual_seed(N + B)
            dout = torch.randn(B, N, D, generator=g, device="cuda").to(torch.bfloat16)
            for name, fn in fwd.items():
                got = fn(qkv, H, mask)
                err[name] = max(err[name], check_fwd(name, got, qkv, mask, H,
                                                     f"B={B} N={N} mask={masked}"))
                if B == 256 and not torch.equal(got, fn(qkv, H, mask)):
                    fail(f"two launches of {name} at B={B} N={N} differ")
                del got
            got, e = check_bwd(qkv, dout, mask, H, f"B={B} N={N} mask={masked}")
            err["flash_attention_qkv_bwd_phased"] = max(err["flash_attention_qkv_bwd_phased"], e)
            if B == 256 and not torch.equal(got, flash_attention_qkv_bwd_phased_cuda(qkv, dout, H,
                                                                                     mask)):
                fail(f"two launches of flash_attention_qkv_bwd_phased at B={B} N={N} differ")
            del got
        mask_bytes = B * N * 4 if masked else 0
        fwd_bound = bound(B * N * (3 * D + D) * 2 + mask_bytes, 4 * B * H * N * N * 64)
        bwd_bound = bound(B * N * (3 * D + D + 3 * D) * 2 + mask_bytes, 10 * B * H * N * N * 64)
        leaf = qkv.detach().requires_grad_()
        lib_out = library_attention(leaf, H, mask)
        lib_grad = dout.view(B, N, H, 64).transpose(1, 2)
        # each kernel beside its plain version, the library call and the
        # production kernel it reschedules (v0), on the same inputs
        v0_fwd = cuda_ms(lambda: flash_attention_qkv_cuda(qkv, H, mask))
        v0_bwd = cuda_ms(lambda: flash_attention_qkv_bwd_cuda(qkv, dout, H, mask))
        timed = (
            ("flash_attention_qkv_phased", lambda: flash_attention_qkv_phased_cuda(qkv, H, mask),
             lambda: flash_attention_qkv_reference(qkv, H, mask),
             lambda: library_attention(qkv, H, mask), fwd_bound, "sdpa", v0_fwd),
            ("flash_attention_qkv_batched", lambda: flash_attention_qkv_batched_cuda(qkv, H, mask),
             lambda: flash_attention_qkv_reference(qkv, H, mask),
             lambda: library_attention(qkv, H, mask), fwd_bound, "sdpa", v0_fwd),
            ("flash_attention_qkv_bwd_phased",
             lambda: flash_attention_qkv_bwd_phased_cuda(qkv, dout, H, mask),
             lambda: flash_attention_qkv_bwd_reference(qkv, dout, H, mask),
             lambda: torch.autograd.grad(lib_out, leaf, lib_grad, retain_graph=True), bwd_bound,
             "sdpa backward", v0_bwd))
        for name, kernel, plain_fn, library, (bound_ms, bound_by), lib_name, v0_ms in timed:
            ms, plain_ms, library_ms = cuda_ms(kernel), cuda_ms(plain_fn), cuda_ms(library)
            flops = (10 if "bwd" in name else 4) * B * H * N * N * 64
            recorded = RECORDED_MS.get((name, N))
            recorded = f" (recorded in PERF.md: {recorded} ms)" if recorded else ""
            print(f"time {name} B={B} N={N} mask={masked}: kernel {ms:.4f} ms{recorded} "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), v0 {v0_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library ({lib_name}) {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})  [{card}]")
            shapes[name].append({"shape": f"B={B} H={H} N={N} mask={masked}", "B": B, "N": N,
                                 "H": H, "ms": ms, "v0_ms": v0_ms, "plain_ms": plain_ms,
                                 "library_ms": library_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by,
                                 "max_abs_err": max(err[name], edge_err[name])})
        del qkv, mask, dout, leaf, lib_out, lib_grad
    torch.cuda.empty_cache()

    # shapes the wrappers refuse raise before any launch
    before = read_counts()
    z197 = torch.zeros(2, 197, 3 * D, device="cuda", dtype=torch.bfloat16)
    z250 = torch.zeros(1, 250, 3 * 128, device="cuda", dtype=torch.bfloat16)
    z257 = torch.zeros(1, 257, 3 * D, device="cuda", dtype=torch.bfloat16)
    refusals = (
        ("phased, N=257 (a row holds 256 keys)", ValueError,
         lambda: flash_attention_qkv_phased_cuda(z257, H, None, 3)),
        ("phased, 5 heads per phase", ValueError,
         lambda: flash_attention_qkv_phased_cuda(z197, H, None, 5)),
        ("batched, N=257", ValueError, lambda: flash_attention_qkv_batched_cuda(z257, H)),
        ("batched, fp32", TypeError, lambda: flash_attention_qkv_batched_cuda(z197.float(), H)),
        ("phased backward, N=250", ValueError,
         lambda: flash_attention_qkv_bwd_phased_cuda(z250, z250[..., :128], 2)))
    for what, error, call in refusals:
        try:
            call()
        except error as e:
            print(f"refused: {what}: {e}")
        else:
            fail(f"the wrapper took {what}")
    if read_counts() != before:
        fail("a refused experiment-kernel call launched a kernel")
    return {name: kernel_entry(name, f"clibd_tpu_torch/csrc/{name}.cu", replaces, shapes[name])
            for name, replaces in zip(EXP_FLASH_KERNELS, ("tools/exp_flash.py:51",
                                                          "tools/exp_flash.py:80",
                                                          "tools/exp_flash.py:157"))}


def flash_experiments_path_phase(card: str, entries: dict) -> None:
    """The flash experiments harness as a user runs it, every mode: each
    experiment kernel launches, the forward and backward kernels only as its
    `v0` (23 timed runs at each of the two shapes, and the backward once per
    shape in bwd_parity), no other kernel."""
    import torch

    from clibd_tpu_torch.tools import exp_flash

    t0 = time.perf_counter()
    reset_counts()
    rows = [r for mode in exp_flash.MODES for r in exp_flash.main([mode])]
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"flash experiments path: launches {counts} in {time.perf_counter() - t0:.1f} s  [{card}]")
    v0 = {"flash_attention_qkv": 46, "flash_attention_qkv_bwd": 48}
    if any(counts[k] == 0 for k in EXP_FLASH_KERNELS) or any(
            n != v0.get(k, 0) for k, n in counts.items() if k not in EXP_FLASH_KERNELS):
        fail(f"the flash experiments path launched {counts}: each experiment kernel at least "
             f"once, the forward and backward kernels {v0}, no other")
    if not all(r["ok"] for r in rows if "ok" in r):
        fail("a parity row of the flash experiments harness is not OK")
    add_launches(entries, "exp_flash", {k: counts[k] for k in EXP_FLASH_KERNELS})


def serve_row1_phase(card: str, fwd: dict) -> None:
    """Row 1 at the serving path's batch sizes: against its plain version at
    B = 1, 3 and 32 for ViT N=197, BarcodeBERT N=133 and BERT-small N=20
    (masked), then kernel and SDPA timed at B = 1 and 32; the rows go into
    the forward kernel's entry under "serve_shapes"."""
    import torch

    from clibd_tpu_torch.ops.attention import flash_attention_qkv_cuda
    from clibd_tpu_torch.utils.profiling import cuda_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, N, H, masked in SHAPES[:3]:
        for B in SERVE_ROW1_B:
            qkv, mask = make_qkv(B, N, H, masked, seed=7 * N + B)
            err = check_forward(qkv, mask, H, f"serve {name} B={B} N={N} H={H} mask={masked}")
            if B not in SERVE_ROW1_TIMED_B:
                continue
            ms = cuda_ms(lambda: flash_attention_qkv_cuda(qkv, H, mask))
            library_ms = cuda_ms(lambda: library_attention(qkv, H, mask))
            D = H * 64
            bound_ms, bound_by = bound(B * N * 4 * D * 2 + (B * N * 4 if masked else 0),
                                       4 * B * H * N * N * 64)
            ctas = B * H * math.ceil(N / 64)
            print(f"time flash_attention_qkv serve {name} B={B} N={N}: kernel {ms:.4f} ms, "
                  f"library (sdpa) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                  f"{ctas} CTAs of 64 query rows on {sms} SMs  [{card}]")
            rows.append({"shape": name, "B": B, "N": N, "H": H, "ms": ms,
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "ctas": ctas, "max_abs_err": err})
    fwd["serve_shapes"] = rows
    fwd["max_abs_err"] = max(fwd["max_abs_err"], max(r["max_abs_err"] for r in rows))


def serve_images(rng, n: int) -> list:
    """n JPEGs of 200-400 px a side, each a colour gradient of its own under
    noise, so that their embeddings differ more than those of plain noise."""
    import io

    from PIL import Image

    out = []
    for _ in range(n):
        h, w = (int(x) for x in rng.integers(200, 401, 2))
        lo, hi = rng.integers(0, 256, (2, 3))
        ramp = np.linspace(0.0, 1.0, w)[None, :, None]
        img = lo + (hi - lo) * ramp + rng.normal(0, 24, (h, w, 3))
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG")
        out.append(buf.getvalue())
    return out


def serve_labels(n: int) -> dict:
    """The gallery's taxonomy, row i labelled from SERVE_TEXTS[i % 4] with a
    species of its own → {level: [n names]}."""
    levels = {"order": [], "family": [], "genus": [], "species": []}
    for i in range(n):
        order, family, genus = SERVE_TEXTS[i % len(SERVE_TEXTS)].split()
        for level, name in (("order", order), ("family", family), ("genus", genus),
                            ("species", f"{genus} sp{i}")):
            levels[level].append(name)
    return levels


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def gallery_mode_checks(card: str, image: np.ndarray, device) -> None:
    """The three gallery modes, fp32 exact, int8 with the 4x re-rank and
    int8 alone, on GALLERY_ROWS seeded unit rows searched with served image
    embeddings: first with one of them planted (row 7), then with every one
    planted (row 7 + 311 i), searched 32 at a time; each mode timed at a
    query batch of 1 and 32 on the second (host clock around the whole
    search, which returns host arrays; median of 10 after 2)."""
    import statistics

    from clibd_tpu_torch.engine.serve import KeySet

    key = "encoded_image_feature"
    labels = serve_labels(GALLERY_ROWS)
    base = unit_rows(np.random.default_rng(21118), GALLERY_ROWS, image.shape[1])

    def modes(feats):
        ks = {"fp32 exact": KeySet.from_arrays({key: feats}, labels, max_k=GALLERY_K,
                                               device=device),
              "int8 + re-rank": KeySet.from_arrays({key: feats}, labels, max_k=GALLERY_K,
                                                   dtype="int8", device=device),
              "int8": KeySet.from_arrays({key: feats}, labels, max_k=GALLERY_K, dtype="int8",
                                         rerank_oversample=0, device=device)}
        if (ks["int8 + re-rank"].selector, ks["int8"].selector) != ("approx", "exact"):
            fail("the int8 galleries do not keep the JAX package's selector policy")
        return ks

    # one planted row: every mode finds it, at its scores' limits
    feats = base.copy()
    feats[7] = image[0]
    found = {m: ks.search(image[:1], key, GALLERY_K) for m, ks in modes(feats).items()}
    ex_s = found["fp32 exact"][0]
    errs = {"fp32 exact": abs(float(ex_s[0, 0]) - 1), "int8 + re-rank": float(
        np.abs(found["int8 + re-rank"][0] - ex_s).max()),
        "int8": abs(float(found["int8"][0][0, 0] - ex_s[0, 0]))}
    tols = {"fp32 exact": SEARCH_SCORE_TOL, "int8 + re-rank": RERANK_SCORE_TOL,
            "int8": INT8_SCORE_TOL}
    for m, (s, i) in found.items():
        if i[0, 0] != 7 or errs[m] > tols[m]:
            fail(f"gallery {m}: top-1 {i[0, 0]} (planted 7), score error {errs[m]} > {tols[m]}")
    if not np.array_equal(found["int8 + re-rank"][1], found["fp32 exact"][1]):
        fail("int8 + re-rank top-k differs from exact fp32 with one planted row")
    print(f"gallery {GALLERY_ROWS} x {image.shape[1]}, one served image embedding planted: "
          f"every mode's top-1 the planted row; fp32 exact score 1 ± {errs['fp32 exact']:.2e}, "
          f"int8 + re-rank top-{GALLERY_K} equal to exact, scores {errs['int8 + re-rank']:.2e} "
          f"apart, int8 score {errs['int8']:.2e} from exact")

    # every served embedding planted, searched 32 at a time
    feats = base.copy()
    rows = 7 + 311 * np.arange(len(image))
    feats[rows] = image
    ks = modes(feats)
    queries = image[:max(SERVE_ROW1_TIMED_B)]
    own = rows[:len(queries)]
    found = {m: k.search(queries, key, GALLERY_K) for m, k in ks.items()}
    ex_s, ex_i = found["fp32 exact"]
    same_vector = np.array([np.array_equal(feats[i], feats[o]) for i, o in zip(ex_i[:, 0], own)])
    if not same_vector.all() or np.abs(ex_s[:, 0] - 1).max() > SEARCH_SCORE_TOL:
        fail(f"fp32 exact gallery: top-1 not the planted row or its score not 1 ± "
             f"{SEARCH_SCORE_TOL}: {ex_i[:, 0]} against {own}, scores {ex_s[:, 0]}")
    rr_s, rr_i = found["int8 + re-rank"]
    if np.abs(rr_s - ex_s).max() > RERANK_SCORE_TOL:
        fail(f"int8 + re-rank scores {np.abs(rr_s - ex_s).max()} from exact fp32")
    gaps = np.diff(ex_s, axis=1)
    # places whose exact score is more than the tolerance from both
    # neighbours' (the k-th's next neighbour is not returned: left out)
    apart = np.ones_like(ex_s, bool)
    apart[:, 1:] &= -gaps > RERANK_SCORE_TOL
    apart[:, :-1] &= -gaps > RERANK_SCORE_TOL
    apart[:, -1] = False
    if not np.array_equal(rr_i[apart], ex_i[apart]) or not np.array_equal(rr_i[:, 0], ex_i[:, 0]):
        fail("int8 + re-rank indices differ from exact fp32 top-k")
    q8_s, q8_i = found["int8"]
    clear = ex_s[:, 0] - ex_s[:, 1] > INT8_MARGIN
    score_err = float(np.abs(q8_s[:, 0] - ex_s[:, 0]).max())
    if score_err > INT8_SCORE_TOL or not np.array_equal(q8_i[clear, 0], own[clear]):
        fail(f"int8 gallery: top-1 score {score_err} from exact or top-1 not the planted row "
             f"where the margin exceeds {INT8_MARGIN}")
    off = image @ image.T - 2 * np.eye(len(image), dtype=np.float32)
    print(f"gallery with all {len(image)} served image embeddings planted (largest cosine "
          f"between two of them {off.max():.6f}), {len(queries)} queries: fp32 exact top-1 the "
          f"planted row, scores 1 ± {np.abs(ex_s[:, 0] - 1).max():.2e}; int8 + re-rank scores "
          f"{np.abs(rr_s - ex_s).max():.2e} from exact, indices equal at every top-1 and at "
          f"{int(apart.sum())} of {apart.size} places apart by > {RERANK_SCORE_TOL}; int8 top-1 "
          f"score {score_err:.2e} from exact, the planted row at all {int(clear.sum())} of "
          f"{len(clear)} queries with an exact margin > {INT8_MARGIN}")
    for mode, k in ks.items():
        times = []
        for b in SERVE_ROW1_TIMED_B:
            for _ in range(2):
                k.search(queries[:b], key, GALLERY_K)
            runs = []
            for _ in range(10):
                t0 = time.perf_counter()
                k.search(queries[:b], key, GALLERY_K)
                runs.append((time.perf_counter() - t0) * 1e3)
            times.append(f"{statistics.median(runs):.4f} ms at {b} queries")
        print(f"search {mode}, k={GALLERY_K}: {', '.join(times)}  [{card}]")


def serve_phase(card: str, entries: dict, device) -> None:
    """The flagship recipe served: InferenceService with pre_warm behind
    make_server, SERVE_EMBEDS concurrent /embed requests (a JPEG and a
    barcode each), the text queries, and /search (image, DNA, image against
    the DNA keys, text) against a gallery built with KeySet.from_arrays; the
    forward kernel's launches counted over that drive, per device call of
    each modality.  Then the served rows against a direct forward, row
    isolation in a bucket, the gallery modes, and the bench_serve load."""
    import base64
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.serve import InferenceService, KeySet, make_server
    from clibd_tpu_torch.models import clibd_apply, init_clibd_model
    from clibd_tpu_torch.tools import bench_serve

    mc = load_config(experiment=EXPERIMENT).model_config
    if not (mc.amp and mc.image.enable and mc.dna.enable and mc.language.enable
            and mc.backbone != "open_clip" and mc.output_dim == 768):
        fail(f"{EXPERIMENT} is not the bf16 tri-modal recipe with 768-d embeddings")
    per_call = {"image": mc.image.vit.num_layers, "dna": mc.dna.bert.num_layers,
                "language": mc.language.bert.num_layers}
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    rng = np.random.default_rng(12)
    jpegs = serve_images(rng, SERVE_EMBEDS)
    barcodes = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(400, 660))))
                for _ in range(SERVE_EMBEDS)]
    words = sorted({w for t in SERVE_TEXTS for w in t.split()})
    vocab_words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    if len(vocab_words) > mc.language.bert.vocab_size:
        fail("the phase's vocabulary has ids past the text tower's")
    image_size = mc.image.vit.image_size
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        Path(vocab).write_text("\n".join(vocab_words) + "\n")
        t0 = time.perf_counter()
        service = InferenceService(model, mc, buckets=SERVE_BUCKETS, window_ms=SERVE_WINDOW_MS,
                                   image_size=image_size, resize_to=round(image_size * 256 / 224),
                                   language_vocab=vocab, text_max_len=mc.language.max_len,
                                   device=device)
        service.pre_warm()
        print(f"serve: service up and every bucket {SERVE_BUCKETS} of the three modalities "
              f"warmed in {time.perf_counter() - t0:.2f} s  [{card}]")
        server = make_server(service, host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"

        def post(path, payload):
            req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        def group(what, fn, items, modalities):
            """Concurrent requests → their replies; fails unless the forward
            kernel ran per_call[m] times per device call of each modality m
            (every request of a group carries the same modalities)."""
            b0, l0 = service.stats.batches, read_counts()["flash_attention_qkv"]
            with ThreadPoolExecutor(len(items)) as pool:
                out = list(pool.map(fn, items))
            batches = service.stats.batches - b0
            launches = read_counts()["flash_attention_qkv"] - l0
            want = batches * sum(per_call[m] for m in modalities)
            print(f"serve {what}: {len(items)} requests in {batches} device batches, "
                  f"{launches} forward-kernel launches (expected {want}: "
                  f"{' + '.join(f'{per_call[m]} {m}' for m in modalities)} per batch)")
            if launches != want:
                fail(f"serve {what}: {launches} forward launches, expected {want}")
            return out, batches

        b64 = [base64.b64encode(j).decode() for j in jpegs]
        try:
            reset_counts()
            embeds, batches = group(
                "/embed image+DNA", lambda i: post("/embed", {"image_b64": b64[i],
                                                              "dna": barcodes[i]}),
                range(SERVE_EMBEDS), ("image", "dna"))
            if batches >= SERVE_EMBEDS:
                fail(f"no coalescing: {SERVE_EMBEDS} requests in {batches} batches")
            texts, _ = group("/embed text", lambda t: post("/embed", {"text": t}), SERVE_TEXTS,
                             ("language",))
            emb = {"image": np.asarray([e["image"] for e in embeds], np.float32),
                   "dna": np.asarray([e["dna"] for e in embeds], np.float32),
                   "language": np.asarray([t["language"] for t in texts], np.float32)}
            for m, x in emb.items():
                norm_err = float(np.abs(np.linalg.norm(x, axis=1) - 1).max())
                if x.shape[1] != mc.output_dim or not np.isfinite(x).all() or norm_err > 1e-3:
                    fail(f"served {m} embeddings: shape {x.shape}, finite "
                         f"{np.isfinite(x).all()}, max |norm-1| {norm_err}")
            # the /search gallery: one planted row per query, the rest seeded
            # unit rows (the cross-modal image query planted in the DNA keys)
            g = np.random.default_rng(4)
            feats = {f"encoded_{m}_feature": unit_rows(g, GALLERY_ROWS, mc.output_dim)
                     for m in ("image", "dna", "language")}
            planted = {"image": 1234, "dna": 777, "cross": 4321, "language": 99}
            feats["encoded_image_feature"][planted["image"]] = emb["image"][0]
            feats["encoded_dna_feature"][planted["dna"]] = emb["dna"][1]
            feats["encoded_dna_feature"][planted["cross"]] = emb["image"][2]
            feats["encoded_language_feature"][planted["language"]] = emb["language"][0]
            labels = serve_labels(GALLERY_ROWS)
            service.keys = KeySet.from_arrays(feats, labels, max_k=GALLERY_K, device=device)
            for what, payload, modality, row in (
                    ("image", {"image_b64": b64[0]}, "image", planted["image"]),
                    ("DNA", {"dna": barcodes[1]}, "dna", planted["dna"]),
                    ("image against the DNA keys", {"image_b64": b64[2], "against": "dna"},
                     "image", planted["cross"]),
                    ("text", {"text": SERVE_TEXTS[0]}, "language", planted["language"])):
                (res,), _ = group(f"/search {what}", lambda p: post("/search", {**p, "k": 5}),
                                  [payload], (modality,))
                top, score = res[modality]["predictions"][0], res[modality]["scores"][0]
                if top["species"] != labels["species"][row] or abs(score - 1) > SEARCH_SCORE_TOL:
                    fail(f"/search {what}: top-1 {top} score {score}, expected the planted "
                         f"row {row} ({labels['species'][row]}) at 1 ± {SEARCH_SCORE_TOL}")
                print(f"serve /search {what}: top-1 the planted row {row}, score {score:.7f}")
            counts = read_counts()
            stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=60).read())
            print(f"serve /stats: {stats}")
        finally:
            server.shutdown()
            server.server_close()
            service.close()
    others = {k: v for k, v in counts.items() if k != "flash_attention_qkv" and v}
    if others:
        fail(f"the serve path launched other kernels: {others}")
    add_launches(entries, "serve", {"flash_attention_qkv": counts["flash_attention_qkv"]})

    # served rows against a direct forward at B=1, and one row of a bucket
    # bit-identical whatever its neighbours
    cos = {"image": [], "dna": []}
    with torch.inference_mode():
        for i in range(8):
            x = to_device(service.preprocess_image(jpegs[i])[None], device)
            d = to_device(service.preprocess_dna(barcodes[i])[None], device)
            out = clibd_apply(model, mc, image_input=x, dna_input=d)
            for m in cos:
                a = out[m][0].float().cpu().numpy()
                cos[m].append(float(a @ emb[m][i] / np.linalg.norm(a) / np.linalg.norm(emb[m][i])))
    for m, c in cos.items():
        print(f"serve {m} rows against a direct forward at B=1: min cosine {min(c):.6f} "
              f"(need >= {SERVE_COSINE_MIN})")
        if min(c) < SERVE_COSINE_MIN:
            fail(f"served {m} rows disagree with a direct forward: {c}")
    x0 = service.preprocess_image(jpegs[0])
    x1 = service.preprocess_image(jpegs[1])
    zeros = service._apply["image"](np.stack([x0] + [np.zeros_like(x0)] * 3))
    mixed = service._apply["image"](np.stack([x0] + [x1] * 3))
    if not np.array_equal(zeros[0], mixed[0]):
        fail("a served row depends on its bucket neighbours")
    print("serve: a row of a bucket of 4 is bit-identical beside zeros and beside other images")

    gallery_mode_checks(card, emb["image"], device)

    clients, per_client = SERVE_LOAD
    res = bench_serve.bench(model, mc, clients, per_client, device)
    for label, _, _ in bench_serve.MODES:
        r = res[label]
        print(f"serve load {label}: {r['req_per_s']:.2f} req/s, mean device batch "
              f"{r['mean_batch']:.2f}, p50 {r['p50_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms "
              f"({r['requests']} requests of a JPEG and a barcode, {clients} clients)  [{card}]")
    print(f"serve load: micro-batching speedup {res['speedup']:.2f}x  [{card}]")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the reference's torch checkpoints, written here independently of
# the port's importer and read back through it
# ---------------------------------------------------------------------------


def draw_port_params(mc, generator) -> dict:
    """Every parameter of the `CLIBD` module for `mc`, under the module's
    names and layouts ([in, out] weights, stacked [L, ...] blocks, one fused
    qkv, LoRA adapters where the recipe has them), drawn from `generator`:
    N(0, 0.02) everywhere, plus 1 on LayerNorm scales, so that no two
    tensors of a layout are alike."""
    import torch

    from clibd_tpu_torch.models import CLIBD

    with torch.device("meta"):
        shapes = {n: p.shape for n, p in CLIBD(mc).named_parameters()}
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=generator) * 0.02
        if name.endswith("scale") and name != "logit_scale":
            t += 1.0
        out[name] = t
    out["logit_scale"] = torch.tensor(mc.init_logit_scale, dtype=torch.float32)
    return out


def open_clip_state_dict(vcfg, tcfg, generator) -> dict:
    """An open_clip state dict (visual.*, transformer.*, token_embedding,
    positional_embedding, ln_final, text_projection, logit_scale) at the
    towers' widths, in open_clip's names and layouts ([out, in] weights,
    in_proj as one [3D, D], the OIHW patch conv), drawn from `generator`:
    N(0, 0.02) weights and biases, unit LayerNorms."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    sd = {}

    def resblocks(prefix, n_layers, d, f):
        for i in range(n_layers):
            p = f"{prefix}.resblocks.{i}."
            sd.update({p + "attn.in_proj_weight": randn(3 * d, d),
                       p + "attn.in_proj_bias": randn(3 * d),
                       p + "attn.out_proj.weight": randn(d, d), p + "attn.out_proj.bias": randn(d),
                       p + "mlp.c_fc.weight": randn(f, d), p + "mlp.c_fc.bias": randn(f),
                       p + "mlp.c_proj.weight": randn(d, f), p + "mlp.c_proj.bias": randn(d)})
            for ln in ("ln_1", "ln_2"):
                sd[p + f"{ln}.weight"], sd[p + f"{ln}.bias"] = torch.ones(d), torch.zeros(d)

    d = vcfg.hidden_size
    sd["visual.conv1.weight"] = randn(d, 3, vcfg.patch_size, vcfg.patch_size)
    sd["visual.class_embedding"] = randn(d)
    sd["visual.positional_embedding"] = randn(vcfg.seq_len, d)
    resblocks("visual.transformer", vcfg.num_layers, d, vcfg.mlp_dim)
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = torch.ones(d), torch.zeros(d)
    sd["visual.proj"] = randn(d, vcfg.embed_dim)
    t = tcfg.hidden_size
    sd["token_embedding.weight"] = randn(tcfg.vocab_size, t)
    sd["positional_embedding"] = randn(tcfg.context_length, t)
    resblocks("transformer", tcfg.num_layers, t, tcfg.mlp_dim)
    sd["ln_final.weight"], sd["ln_final.bias"] = torch.ones(t), torch.zeros(t)
    sd["text_projection"] = randn(t, tcfg.embed_dim)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


BPE_MERGES = ("#version: 0.2", "s p", "sp e", "spe c", "spec i", "speci e", "speci es",
              "o r", "or d", "ord e", "orde r", "f a", "fa m", "g e", "ge n")


def write_bpe_merges(path: str) -> str:
    """A small gzipped BPE merges file in CLIP's format: the byte-level
    vocabulary and a few merges of the taxonomy words."""
    import gzip

    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(BPE_MERGES))
    return path


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def vit_state_dict(vit: dict) -> dict:
    """A port ViT's parameters (names below `image_encoder.`) → the timm
    `vit_base_patch16_224` state dict: Linear weights [out, in], the patch
    embedding as an OIHW conv; with LoRA, timm's qkv wrapped as the
    reference's `attn.qkv.qkv` beside `linear_{a,b}_{q,v}`."""
    w = vit["patch_embed.w"]
    D = w.shape[1]
    p = round((w.shape[0] // 3) ** 0.5)
    sd = {"cls_token": vit["cls_token"], "pos_embed": vit["pos_embed"],
          "patch_embed.proj.weight": w.reshape(p, p, 3, D).permute(3, 2, 0, 1),
          "patch_embed.proj.bias": vit["patch_embed.b"],
          "norm.weight": vit["norm.scale"], "norm.bias": vit["norm.bias"],
          "head.weight": vit["head.w"].T, "head.bias": vit["head.b"]}
    lora = "lora.a_q" in vit
    for i in range(vit["blocks.qkv_w"].shape[0]):
        b = {k[len("blocks."):]: v[i] for k, v in vit.items() if k.startswith("blocks.")}
        pre = f"blocks.{i}."
        qkv = pre + ("attn.qkv.qkv." if lora else "attn.qkv.")
        sd[qkv + "weight"], sd[qkv + "bias"] = b["qkv_w"].T, b["qkv_b"]
        if lora:
            for n in ("q", "v"):
                sd[pre + f"attn.qkv.linear_a_{n}.weight"] = vit[f"lora.a_{n}"][i].T
                sd[pre + f"attn.qkv.linear_b_{n}.weight"] = vit[f"lora.b_{n}"][i].T
        for ref, ours in (("attn.proj", "out"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            sd[pre + ref + ".weight"], sd[pre + ref + ".bias"] = b[ours + "_w"].T, b[ours + "_b"]
        for ref, ours in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[pre + ref + ".weight"], sd[pre + ref + ".bias"] = b[ours + "_scale"], b[ours + "_bias"]
    return sd


def bert_state_dict(bert: dict, prefix: str = "", vocab_extra: int = 0,
                    decoder_bias_at: str = "decoder.bias", generator=None) -> dict:
    """A port BERT's parameters → the HF `BertModel` (prefix "") or
    `BertForMaskedLM` (prefix "bert.", MLM head under `cls.predictions.`)
    state dict: separate q/k/v, Linear weights [out, in]; with LoRA the
    reference's `query.w` / `query.w_a` / `query.w_b` (and value).
    `vocab_extra` rows are appended to the word embeddings (a padded
    vocabulary the importer cuts); `decoder_bias_at` is "decoder.bias" or
    "bias" (`cls.predictions.bias`)."""
    import torch

    word = bert["embeddings.word"]
    if vocab_extra:
        word = torch.cat([word, torch.randn(vocab_extra, word.shape[1], generator=generator)])
    sd = {prefix + "embeddings.word_embeddings.weight": word,
          prefix + "embeddings.position_embeddings.weight": bert["embeddings.position"],
          prefix + "embeddings.token_type_embeddings.weight": bert["embeddings.token_type"],
          prefix + "embeddings.LayerNorm.weight": bert["embeddings.ln.scale"],
          prefix + "embeddings.LayerNorm.bias": bert["embeddings.ln.bias"]}
    D = word.shape[1]
    lora = "lora.a_q" in bert
    for i in range(bert["blocks.qkv_w"].shape[0]):
        b = {k[len("blocks."):]: v[i] for k, v in bert.items() if k.startswith("blocks.")}
        pre = f"{prefix}encoder.layer.{i}."
        for j, n in enumerate(("query", "key", "value")):
            wrapped = lora and n != "key"
            name = pre + f"attention.self.{n}" + (".w" if wrapped else "")
            sd[name + ".weight"] = b["qkv_w"][:, j * D:(j + 1) * D].T
            sd[name + ".bias"] = b["qkv_b"][j * D:(j + 1) * D]
            if wrapped:
                sd[pre + f"attention.self.{n}.w_a.weight"] = bert[f"lora.a_{n[0]}"][i].T
                sd[pre + f"attention.self.{n}.w_b.weight"] = bert[f"lora.b_{n[0]}"][i].T
        for ref, ours in (("attention.output.dense", "out"), ("intermediate.dense", "fc1"),
                          ("output.dense", "fc2")):
            sd[pre + ref + ".weight"], sd[pre + ref + ".bias"] = b[ours + "_w"].T, b[ours + "_b"]
        for ref, ours in (("attention.output.LayerNorm", "ln1"), ("output.LayerNorm", "ln2")):
            sd[pre + ref + ".weight"], sd[pre + ref + ".bias"] = b[ours + "_scale"], b[ours + "_bias"]
    if "mlm_head.decoder.w" in bert:
        h = "cls.predictions."
        sd[h + "transform.dense.weight"] = bert["mlm_head.transform.w"].T
        sd[h + "transform.dense.bias"] = bert["mlm_head.transform.b"]
        sd[h + "transform.LayerNorm.weight"] = bert["mlm_head.ln.scale"]
        sd[h + "transform.LayerNorm.bias"] = bert["mlm_head.ln.bias"]
        sd[h + "decoder.weight"] = bert["mlm_head.decoder.w"].T
        sd[h + decoder_bias_at] = bert["mlm_head.decoder.b"]
    return sd


def reference_state_dict(params: dict, legacy: bool = False, vocab_extra: int = 0,
                         decoder_bias_at: str = "decoder.bias", generator=None) -> dict:
    """Port-layout parameters (`draw_port_params`) → the reference's
    SimpleCLIP `best.pth` state dict under DataParallel's "module." prefix;
    `legacy` names the towers as the LoRA releases did (`lora_vit`,
    `lora_barcode_bert`, `lora_bert`).  Every tensor is its own copy."""
    import torch

    towers = {"image": "lora_vit" if legacy else "base_image_encoder",
              "dna": "lora_barcode_bert" if legacy else "base_dna_encoder",
              "language": "lora_bert" if legacy else "base_language_encoder"}
    sd = {"logit_scale": params["logit_scale"]}
    if any(k.startswith("image_encoder.") for k in params):
        for k, v in vit_state_dict(_sub(params, "image_encoder.")).items():
            sd[f"image_encoder.{towers['image']}.{k}"] = v
    if any(k.startswith("dna_encoder.") for k in params):
        for k, v in bert_state_dict(_sub(params, "dna_encoder."), "bert.", vocab_extra,
                                    decoder_bias_at, generator).items():
            sd[f"dna_encoder.{towers['dna']}.{k}"] = v
    if any(k.startswith("language_encoder.") for k in params):
        for k, v in bert_state_dict(_sub(params, "language_encoder."), "", vocab_extra,
                                    generator=generator).items():
            sd[f"language_encoder.{towers['language']}.{k}"] = v
        sd["language_encoder.proj.weight"] = params["language_proj.w"].T
        sd["language_encoder.proj.bias"] = params["language_proj.b"]
    return {"module." + k: v.clone(memory_format=torch.contiguous_format) for k, v in sd.items()}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def import_recipes():
    """(flagship, LoRA recipe) global configs for phase 13, each checked to be
    the tri-modal ViT-B/16 + BarcodeBERT + BERT-small model with 768-d
    embeddings in bf16 at batch 500 (no LoRA, and LoRA rank 4)."""
    from clibd_tpu_torch.config import load_config

    out = []
    for experiment, lora in ((EXPERIMENT, False), (IMPORT_LORA, True)):
        gcfg = load_config(experiment=experiment, overrides=["model_config.load_ckpt=true"])
        mc = gcfg.model_config
        v, d, t = mc.image.vit, mc.dna.bert, mc.language.bert
        if not (mc.amp and mc.batch_size == 500 and mc.output_dim == 768
                and mc.backbone != "open_clip" and mc.image.enable and mc.dna.enable
                and mc.language.enable and mc.disable_lora != lora
                and (not lora or mc.lora_rank == 4)):
            fail(f"{experiment} is not the bf16 tri-modal recipe at batch 500 with 768-d "
                 f"embeddings and {'LoRA rank 4' if lora else 'no LoRA'}")
        out.append(gcfg)
    return out


def modality_launches(model, mc, batch, device) -> dict:
    """Forward-kernel launches of one bf16 batch through each tower alone."""
    from clibd_tpu_torch.engine.extract import make_encode_step, to_device

    step = make_encode_step(mc, model)
    out = {}
    for m in ("image", "dna", "language"):
        x = to_device({m: batch[m]}, device)
        n0 = read_counts()["flash_attention_qkv"]
        step(x)
        sync(device)
        out[m] = read_counts()["flash_attention_qkv"] - n0
    return out


def check_embeddings(what: str, split_dict: dict, rows: int, dim: int,
                     modalities=("image", "dna", "language")) -> None:
    for m in modalities:
        emb = split_dict[f"encoded_{m}_feature"]
        if emb.shape != (rows, dim) or not np.isfinite(emb).all():
            fail(f"{what} {m} embeddings: shape {emb.shape} or not finite")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
        if norm_err > 1e-3:
            fail(f"{what} {m} embeddings not unit-norm: max |norm-1| {norm_err}")


def extract_trio(model, mc, splits) -> tuple:
    from clibd_tpu_torch.engine.extract import extract_split

    keys = extract_split(model, mc, splits["all_keys"], for_key_set=True)
    return (extract_split(model, mc, splits["test_seen"]),
            extract_split(model, mc, splits["test_unseen"]), keys)


def import_phase(card: str, entries: dict, device, split_rows: dict) -> None:
    """Phase 13: the reference's torch checkpoints at the flagship's width,
    written by this script (`draw_port_params` → `reference_state_dict`) and
    imported through `cli.common._resolve_params`; their extraction, the
    LoRA import against its merged plain form, verify-parity's legs, and
    the feature-input flagship."""
    import torch

    from clibd_tpu_torch.cli.common import _resolve_params
    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine import verify_parity
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models import clibd_apply, init_clibd_model, model_from_jax
    from clibd_tpu_torch.models.convert import clibd_params_from_reference_checkpoint
    from clibd_tpu_torch.models.layers import BLOCK_KEYS
    from clibd_tpu_torch.models.lora import merge_lora_into_qkv
    from clibd_tpu_torch.tools.profile_extract import plain_kernels

    flagship, lora_recipe = import_recipes()
    mc, lmc = flagship.model_config, lora_recipe.model_config
    per_call = {"image": mc.image.vit.num_layers, "dna": mc.dna.bert.num_layers,
                "language": mc.language.bert.num_layers}
    gen = torch.Generator().manual_seed(IMPORT_SEED)
    t0 = time.perf_counter()
    plain = draw_port_params(mc, gen)
    adapted = draw_port_params(lmc, gen)  # B non-zero: N(0, 0.02) like every tensor
    print(f"import: drew {sum(v.numel() for v in plain.values()) / 1e6:.1f} M + "
          f"{sum(v.numel() for v in adapted.values()) / 1e6:.1f} M parameters in "
          f"{time.perf_counter() - t0:.2f} s")

    def load(gcfg, path, params, label):
        """`_resolve_params` with ckpt_path = path; every parameter must be
        the writer's tensor bit for bit."""
        gcfg.model_config.ckpt_path = path
        gb = os.path.getsize(path) / 1e9
        t0 = time.perf_counter()
        model = _resolve_params(gcfg, device)
        sync(device)
        dt = time.perf_counter() - t0
        got = dict(model.named_parameters())
        if set(got) != set(params):
            fail(f"{label} import: parameters {sorted(set(got) ^ set(params))[:8]} differ")
        for name, p in got.items():
            if p.device.type != device.type or not torch.equal(p.detach().cpu(), params[name]):
                fail(f"{label} import: {name} is not the written tensor under the inverse layout")
        print(f"import {label}: {path.rsplit('/', 1)[-1]} {gb:.3f} GB, {len(got)} tensors "
              f"bit-exact, imported in {dt:.2f} s ({gb / dt:.2f} GB/s)  [{card}]")
        return model

    with tempfile.TemporaryDirectory() as tmp:
        paths = {"plain": os.path.join(tmp, "best.pth"),
                 "lora": os.path.join(tmp, "lora_best.pth")}
        t0 = time.perf_counter()
        torch.save(reference_state_dict(plain), paths["plain"])
        torch.save(reference_state_dict(adapted, legacy=True, vocab_extra=3,
                                        decoder_bias_at="bias", generator=gen), paths["lora"])
        print(f"import: wrote the flagship's best.pth and the LoRA recipe's (legacy names, "
              f"a padded vocabulary, the decoder bias at cls.predictions.bias) in "
              f"{time.perf_counter() - t0:.2f} s")
        for label, path, gcfg in (("flagship", paths["plain"], flagship),
                                  ("lora", paths["lora"], lora_recipe)):
            _, rep = verify_parity.conversion_report(path, gcfg.model_config)
            print(f"import {label}: verify-parity convert leg ok={rep['ok']}, "
                  f"{rep['n_leaves']} leaves, {rep['n_params']} params, towers {rep['towers']}")
            if not rep["ok"]:
                fail(f"verify-parity's convert leg failed on the {label} file: {rep}")
        model = load(flagship, paths["plain"], plain, "flagship")
        lora_model = load(lora_recipe, paths["lora"], adapted, "lora")
    for name in ("image_encoder", "dna_encoder", "language_encoder"):
        if getattr(lora_model, name).lora is None or getattr(model, name).lora is not None:
            fail(f"{name}: LoRA where the checkpoint has none, or none where it has adapters")

    # the flagship import's extraction, bf16, through the forward kernel,
    # over specimens of IMPORT_SPECIES species (kNN top-1 then has the
    # margins of real data; over label-free noise it is decided by near-ties)
    splits = {name: SyntheticSplit(name, n, mc, seed=i, species=IMPORT_SPECIES)
              for i, (name, n) in enumerate(split_rows.items())}
    b = next(splits["test_seen"].batches())
    small = to_device({m: head(b[m], 8) for m in ("image", "dna", "language")}, device)
    clibd_apply(model, mc, small["image"], small["dna"], small["language"])  # warm-up
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    trio = extract_trio(model, mc, splits)
    sync(device)
    t_extract = time.perf_counter() - t0
    counts = read_counts()
    per_modality = modality_launches(model, mc, b, device)
    counts_all = read_counts()
    n_batches = sum(len(s) for s in splits.values())
    n_rows = sum(split_rows.values())
    want = sum(per_call.values()) * n_batches
    others = {k: v for k, v in counts_all.items() if k != "flash_attention_qkv" and v}
    print(f"import_eval: {counts['flash_attention_qkv']} forward launches over {n_batches} "
          f"batches (expected {want}); one batch per tower alone: {per_modality} (expected "
          f"{per_call})")
    if counts["flash_attention_qkv"] != want or per_modality != per_call or others:
        fail(f"import_eval launched the forward kernel {counts['flash_attention_qkv']} times "
             f"(expected {want}), per tower {per_modality}, and the others {others}")
    add_launches(entries, "import_eval",
                 {"flash_attention_qkv": counts_all["flash_attention_qkv"]})
    for d, name in zip(trio, ("test_seen", "test_unseen", "all_keys")):
        check_embeddings(f"import_eval {name}", d, split_rows[name], mc.output_dim)
    print(f"import_eval extraction: {n_rows} samples in {t_extract:.3f} s = "
          f"{n_rows / t_extract:.2f} samples/s after the import (bf16, batch {mc.batch_size})"
          f"  [{card}]")
    with torch.inference_mode():
        lo = clibd_apply(model, mc, small["image"], small["dna"], small["language"])
        hi = clibd_apply(model, mc, small["image"], small["dna"], small["language"],
                         compute_dtype=torch.float32)
    for m in ("image", "dna", "language"):
        cos = float(cosine_rows(lo[m], hi[m]).min())
        print(f"import_eval bf16 vs fp32, {m}: min cosine {cos:.6f} (need >= {COSINE_MIN})")
        if cos < COSINE_MIN:
            fail(f"import_eval: the bf16 path disagrees with the fp32 path for {m}")

    # verify-parity: the kernel trio against the plain versions' trio.  The
    # top-1 leg is held per modality (query and keys of one tower): a
    # seeded init aligns no modality with another, so its cross-modal cells
    # are chance and their top-1 is decided by near-ties; the whole grid's
    # leg is printed beside
    with plain_kernels():
        plain_trio = extract_trio(model, mc, splits)
    cmp_emb = verify_parity.compare_embeddings(trio, plain_trio)
    worst = min(s["min"] for r in cmp_emb["splits"].values() for s in r["modalities"].values())
    print(f"import verify-parity, kernels against plain versions: embedding_cosine "
          f"ok={cmp_emb['ok']} (min row cosine {worst:.6f}, need mean >= 0.99 per split and "
          f"modality)")
    if not cmp_emb["ok"]:
        fail(f"verify-parity's embedding_cosine leg failed: {cmp_emb}")
    for m in ("image", "dna", "language"):
        keep = {f"encoded_{m}_feature", "label_list", "processed_id_list", "file_name_list"}
        mine, theirs = (tuple({k: v for k, v in d.items() if k in keep} for d in t)
                        for t in (trio, plain_trio))
        rep = verify_parity.compare_top1(mine, theirs, device=device)
        print(f"import verify-parity species_top1, {m} queries against {m} keys: ok={rep['ok']}, "
              f"top-1 {[round(r['ours'], 4) for r in rep['rows']]} (kernels) against "
              f"{[round(r['released'], 4) for r in rep['rows']]} (plain), max |delta| "
              f"{rep['max_abs_delta']:.4f} (threshold {rep['threshold']})")
        if not rep["ok"]:
            fail(f"verify-parity's species_top1 leg failed for {m}: {rep}")
    grid = verify_parity.compare_top1(trio, plain_trio, device=device)
    cross = max((r["delta"] for r in grid["rows"]
                 if r["grid"].split("|")[0] != r["grid"].split("|")[1]), default=0.0)
    print(f"import verify-parity species_top1 over the whole grid ({len(grid['rows'])} cells, "
          f"not held): max |delta| {grid['max_abs_delta']:.4f}, {cross:.4f} in a cross-type "
          f"cell; top-1 {min(r['ours'] for r in grid['rows']):.3f}-"
          f"{max(r['ours'] for r in grid['rows']):.3f}")
    del model, trio, plain_trio

    # the LoRA import against the plain layout carrying W_qkv with the
    # adapters merged in, under the same recipe with disable_lora
    merged = {k: v for k, v in adapted.items() if ".lora." not in k}
    for tower in ("image_encoder", "dna_encoder", "language_encoder"):
        stacked = {k: adapted[f"{tower}.blocks.{k}"] for k in BLOCK_KEYS}
        lora = {k: adapted[f"{tower}.lora.{k}"] for k in ("a_q", "b_q", "a_v", "b_v")}
        merged[f"{tower}.blocks.qkv_w"] = merge_lora_into_qkv(stacked, lora)["qkv_w"]
    merged_cfg = load_config(experiment=IMPORT_LORA,
                             overrides=["model_config.disable_lora=true"]).model_config
    sd = {k: v.numpy() for k, v in reference_state_dict(merged).items()}
    merged_model = model_from_jax(clibd_params_from_reference_checkpoint(sd, merged_cfg),
                                  merged_cfg, device)
    del sd, merged
    with torch.inference_mode():
        a = clibd_apply(lora_model, lmc, small["image"], small["dna"], small["language"],
                        compute_dtype=torch.float32)
        m_out = clibd_apply(merged_model, merged_cfg, small["image"], small["dna"],
                            small["language"], compute_dtype=torch.float32)
    for m in ("image", "dna", "language"):
        cos = float(cosine_rows(a[m], m_out[m]).min())
        print(f"import LoRA against merged, {m}: min cosine {cos:.7f} (fp32, need >= "
              f"{IMPORT_COSINE_MIN})")
        if cos < IMPORT_COSINE_MIN:
            fail(f"the LoRA import disagrees with its merged plain form for {m}")
    del lora_model, merged_model, plain, adapted

    # the feature-input flagship: an MLP over 512-wide image features
    fcfg = load_config_feature()
    fsplits = {name: SyntheticSplit(name, n, fcfg, seed=i)
               for i, (name, n) in enumerate(split_rows.items())}
    fmodel = init_clibd_model(fcfg, torch.Generator().manual_seed(fcfg.default_seed), device)
    fb = next(fsplits["test_seen"].batches())
    if fb["image"].shape[1:] != (FEATURE_DIM,) or fb["image"].dtype != np.float32:
        fail(f"feature batches are {fb['image'].dtype} {fb['image'].shape}, not "
             f"[B, {FEATURE_DIM}] fp32")
    reset_counts()
    t0 = time.perf_counter()
    ftrio = extract_trio(fmodel, fcfg, fsplits)
    sync(device)
    t_feat = time.perf_counter() - t0
    fcounts = read_counts()
    f_per = modality_launches(fmodel, fcfg, fb, device)
    f_all = read_counts()
    f_want = {"image": 0, "dna": per_call["dna"], "language": per_call["language"]}
    print(f"feature_eval: {fcounts['flash_attention_qkv']} forward launches over {n_batches} "
          f"batches (expected {sum(f_want.values()) * n_batches}); per tower {f_per} "
          f"(expected {f_want})")
    if (fcounts["flash_attention_qkv"] != sum(f_want.values()) * n_batches or f_per != f_want
            or any(v for k, v in f_all.items() if k != "flash_attention_qkv")):
        fail(f"feature_eval launches {fcounts} per tower {f_per}, expected {f_want}")
    add_launches(entries, "feature_eval", {"flash_attention_qkv": f_all["flash_attention_qkv"]})
    for d, name in zip(ftrio, ("test_seen", "test_unseen", "all_keys")):
        check_embeddings(f"feature_eval {name}", d, split_rows[name], fcfg.output_dim)
    print(f"feature_eval extraction: {n_rows} samples in {t_feat:.3f} s = "
          f"{n_rows / t_feat:.2f} samples/s (image features {FEATURE_DIM} wide, bf16)  [{card}]")
    del fmodel
    if device.type == "cuda":
        torch.cuda.empty_cache()


def attention_rows_at(card: str, label: str, B: int, towers) -> tuple:
    """Rows 1 and 2 at a path's batch B for each tower (name, N, H, masked):
    each against its plain version (forward max |kernel - plain| <=
    KERNEL_TOL, backward <= BWD_REL_TOL * max |plain| per part), then kernel,
    SDPA (forward, backward) and bound ms → (forward rows, backward rows)."""
    import torch

    from clibd_tpu_torch.ops.attention import (flash_attention_qkv_bwd_cuda,
                                               flash_attention_qkv_bwd_reference,
                                               flash_attention_qkv_cuda)
    from clibd_tpu_torch.utils.profiling import cuda_ms

    fwd_rows, bwd_rows = [], []
    for name, N, H, masked in towers:
        D = H * 64
        what = f"{label} {name} B={B} N={N} H={H} mask={masked}"
        qkv, mask = make_qkv(B, N, H, masked, seed=11 * N + B)
        g = torch.Generator(device="cuda").manual_seed(B + N)
        dout = torch.randn(B, N, D, generator=g, device="cuda").to(torch.bfloat16)
        fwd_err = check_forward(qkv, mask, H, what)
        got = flash_attention_qkv_bwd_cuda(qkv, dout, H, mask).float()
        want = flash_attention_qkv_bwd_reference(qkv, dout, H, mask).float()
        rel = [rel_err(got[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])
               for i in range(3)]
        bwd_err = float((got - want).abs().max())
        del got, want
        print(f"kernel flash_attention_qkv_bwd {what}: max|kernel-plain|/max|plain| dq "
              f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} (tol {BWD_REL_TOL})")
        if max(rel) > BWD_REL_TOL:
            fail(f"backward kernel disagrees with its plain version at {what}: {rel}")
        ms = cuda_ms(lambda: flash_attention_qkv_cuda(qkv, H, mask))
        library_ms = cuda_ms(lambda: library_attention(qkv, H, mask))
        bwd_ms = cuda_ms(lambda: flash_attention_qkv_bwd_cuda(qkv, dout, H, mask))
        leaf = qkv.detach().requires_grad_()
        lib_out = library_attention(leaf, H, mask)
        bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaf, dout.view(B, N, H, 64).transpose(1, 2), retain_graph=True))
        extra = B * N * 4 if masked else 0
        bound_ms, bound_by = bound(B * N * 4 * D * 2 + extra, 4 * B * H * N * N * 64)
        bwd_bound_ms, bwd_bound_by = bound(B * N * 7 * D * 2 + extra, 10 * B * H * N * N * 64)
        print(f"time {label} {name} B={B} N={N}: forward kernel {ms:.4f} ms, library (sdpa) "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); backward kernel "
              f"{bwd_ms:.4f} ms, library (sdpa backward) {bwd_library_ms:.4f} ms, bound "
              f"{bwd_bound_ms:.4f} ms ({bwd_bound_by})  [{card}]")
        common = {"shape": name, "B": B, "N": N, "H": H}
        fwd_rows.append({**common, "ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "max_abs_err": fwd_err})
        bwd_rows.append({**common, "ms": bwd_ms, "library_ms": bwd_library_ms,
                         "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
                         "max_abs_err": bwd_err})
        del qkv, mask, dout, leaf, lib_out
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def add_path_shapes(entries: dict, path: str, rows: tuple) -> None:
    """Rows 1 and 2 at a path's own batch into their entries, under
    "<path>_shapes"."""
    for name, r in zip(("flash_attention_qkv", "flash_attention_qkv_bwd"), rows):
        entries[name][f"{path}_shapes"] = r
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                           max(x["max_abs_err"] for x in r))


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device) -> float:
    """Peak device memory since the last `reset_peak`, GiB (0 on the CPU)."""
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30 if device.type == "cuda" else 0.0


def counted(step_fn, per_step: list):
    """`step_fn` that appends each call's (forward, backward) kernel
    launches to `per_step`."""
    from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_bwd

    def step(*args):
        f0, b0 = flash_attention_qkv.launches, flash_attention_qkv_bwd.launches
        loss = step_fn(*args)
        per_step.append((flash_attention_qkv.launches - f0, flash_attention_qkv_bwd.launches - b0))
        return loss

    return step


def accum_train_phase(card: str, entries: dict, device) -> None:
    """Phase 14: the flagship recipe with accum_steps=4 through the port's
    Trainer (one epoch, one eval), the gradient cache against the
    monolithic step on one batch, samples/s and peak memory of both, and
    rows 1-2 at the microbatch."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine import train as train_mod
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.train import (Trainer, batch_generator, make_accum_grad_fn,
                                              make_loss_fn, make_train_step,
                                              make_train_step_accum)
    from clibd_tpu_torch.models import init_clibd_model

    gcfg = recipe_config(EXPERIMENT, 1)
    mc = gcfg.model_config
    mc.accum_steps = k = ACCUM_STEPS
    B = mc.batch_size
    if B % k:
        fail(f"batch {B} does not divide by accum_steps={k}")
    splits = {name: SyntheticSplit(name, n, mc, seed=20 + i)
              for i, (name, n) in enumerate(ACCUM_TRAIN_ROWS.items())}
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    n_layers = mc.image.vit.num_layers + mc.dna.bert.num_layers + mc.language.bert.num_layers
    # pass 1: a forward per microbatch; pass 3: a forward and a backward per
    # microbatch (the "attn" policy keeps the attention output, so the
    # backward does not run the forward kernel again)
    want = (2 * k * n_layers, k * n_layers)
    steps = len(splits["train"])
    logs, per_step = [], []
    with tempfile.TemporaryDirectory(prefix="clibd_accum_") as out_dir:
        trainer = Trainer(gcfg, None, out_dir, train_loader=splits["train"],
                          eval_loader_factory=lambda split, train: splits[split], model=model,
                          log_fn=logs.append, device=device)
        if "make_train_step_accum" not in trainer.step_fn.__qualname__:
            fail(f"the Trainer did not take the gradient-cache step: {trainer.step_fn}")
        trainer.step_fn = counted(trainer.step_fn, per_step)
        reset_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        history = trainer.fit()
        sync(device)
        t_fit = time.perf_counter() - t0
        fit_peak = peak_gib(device)
        trainer.close()
        counts = read_counts()
        print(f"accum_train kernel launches per train step (forward, backward) at k={k}: "
              f"{sorted(set(per_step))} over {len(per_step)} steps (expected {want} x {steps})")
        others = {n: c for n, c in counts.items()
                  if n not in ("flash_attention_qkv", "flash_attention_qkv_bwd")}
        if len(per_step) != steps or set(per_step) != {want} or any(others.values()):
            fail(f"accum_train steps launched {per_step}, expected {want} x {steps}, and the "
                 f"other kernels {others}, expected none")
        losses = [d["loss"] for d in logs if "loss" in d]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"accum_train losses {losses}")
        grids = [d for d in logs if any("||top-" in key for key in d)]
        if len(history["overall_acc"]) != 1 or len(grids) != 1 or not grids[0]:
            fail(f"accum_train: expected one eval with a grid: {history['overall_acc']}")
        for sub in ("last", "best"):
            if not os.path.exists(os.path.join(out_dir, sub, "opt_state.npz")):
                fail(f"accum_train: {sub}/ was not written")
    add_launches(entries, "accum_train", counts)
    rates = [d["throughput/samples_per_sec_per_chip"] for d in logs
             if "throughput/samples_per_sec_per_chip" in d]
    print(f"accum_train losses: {[round(v, 4) for v in losses]}; eval overall_acc "
          f"{history['overall_acc']}")
    print(f"accum_train: {steps} steps of batch {B} at k={k} + 1 eval in {t_fit:.2f} s; "
          f"samples/s over the steps after the first (CUDA-synchronised) {rates}; peak device "
          f"memory {fit_peak:.2f} GiB  [{card}]")

    # the gradient cache against the monolithic step: samples/s and peak memory
    batch = to_device({key: v for key, v in next(splits["train"].batches()).items()
                       if key != "index"}, device)
    opt = trainer.optimizer
    stats = {}
    for name, step in (("monolithic", make_train_step(mc, model, opt)),
                       (f"k={k}", make_train_step_accum(mc, model, opt, k))):
        step(batch, batch_generator(device, 0, 0, 0))  # warm-up
        sync(device)
        reset_peak(device)
        t0 = time.perf_counter()
        for i in range(ACCUM_RATE_STEPS):
            step(batch, batch_generator(device, 0, 0, i + 1))
        sync(device)
        stats[name] = (ACCUM_RATE_STEPS * B / (time.perf_counter() - t0), peak_gib(device))
        print(f"accum_train {name} step at batch {B}: {stats[name][0]:.2f} samples/s, peak "
              f"device memory {stats[name][1]:.2f} GiB (bf16, remat {mc.remat_policy!r})  "
              f"[{card}]")
    if device.type == "cuda" and not stats[f"k={k}"][1] < stats["monolithic"][1]:
        fail(f"the k={k} step's peak memory is not below the monolithic step's: {stats}")

    # one batch, augmentation replaced by the identity for this check only
    real_augment = train_mod.train_augment
    train_mod.train_augment = lambda generator, images: images
    try:
        opt.zero_grad(set_to_none=True)
        loss_m = make_loss_fn(mc, model)(batch, None)
        loss_m.backward()
        grads_m = [p.grad.float().clone() for _, p in trainable]
        opt.zero_grad(set_to_none=True)
        loss_k = make_accum_grad_fn(mc, model, k)(batch, None)
        grads_k = [p.grad.float() for _, p in trainable]
    finally:
        train_mod.train_augment = real_augment
    loss_m, loss_k = float(loss_m.detach()), float(loss_k)
    cos = [float((a * b).sum() / (a.norm() * b.norm())) for a, b in zip(grads_k, grads_m)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    print(f"accum_train k={k} against the monolithic step, one batch, identity augmentation: "
          f"loss {loss_k:.6f} vs {loss_m:.6f} (|d| {abs(loss_k - loss_m):.3e}, tol "
          f"{ACCUM_LOSS_REL_TOL} x |loss|); gradient min cosine {cos[worst]:.6f} at "
          f"{trainable[worst][0]} over {len(cos)} tensors (need >= {COSINE_MIN})")
    if abs(loss_k - loss_m) > ACCUM_LOSS_REL_TOL * abs(loss_m) or cos[worst] < COSINE_MIN:
        fail("the gradient cache disagrees with the monolithic step")
    opt.zero_grad(set_to_none=True)
    del model, trainer, opt, batch, grads_m, grads_k
    if device.type == "cuda":
        torch.cuda.empty_cache()
        add_path_shapes(entries, "accum_train",
                        attention_rows_at(card, "accum_train microbatch", B // k, SHAPES[:3]))


def simclr_config():
    """The unimodel recipe at SIMCLR_EPOCHS epochs, checked to be the bf16
    ViT-B/16 with its 768-d head, full fine-tune, batch 500."""
    from clibd_tpu_torch.config import load_config

    gcfg = load_config(experiment=SIMCLR, overrides=[f"model_config.epochs={SIMCLR_EPOCHS}"])
    mc, v = gcfg.model_config, gcfg.model_config.image.vit
    if not (mc.amp and mc.disable_lora and mc.batch_size == 500 and mc.output_dim == 768
            and mc.image.enable and not mc.dna.enable and not mc.language.enable
            and (v.image_size, v.patch_size, v.hidden_size, v.num_layers, v.num_heads)
            == (224, 16, 768, 12, 12)):
        fail(f"{SIMCLR} is not the bf16 ViT-B/16 SimCLR recipe at batch 500 with a 768-d head")
    return gcfg


def simclr_batch(card: str, mc, device) -> int:
    """The recipe's batch if its step's peak memory, predicted from one step
    at each of two small batches (the slope per image, both views), fits
    SIMCLR_MEMORY_SHARE of the card; else the largest multiple of 10 that
    does."""
    import torch

    from clibd_tpu_torch.engine.simclr import make_simclr_step
    from clibd_tpu_torch.engine.train import ScheduledAdam, batch_generator
    from clibd_tpu_torch.models.vit import ViT

    model = ViT(mc.image.vit, output_dim=mc.output_dim)
    model.reset_parameters(torch.Generator().manual_seed(1))
    model = model.to(device)
    step = make_simclr_step(mc, model, ScheduledAdam(model.parameters(), lambda i: 0.0))
    S = mc.image.vit.image_size
    peaks = {}
    for b in SIMCLR_PROBE_B:
        views = torch.randint(0, 256, (b, S, S, 3), dtype=torch.uint8, device=device)
        step(views, views, batch_generator(device, 0, 0, 0))  # Adam's state appears here
        sync(device)
        reset_peak(device)
        step(views, views, batch_generator(device, 0, 0, 1))
        sync(device)
        peaks[b] = torch.cuda.max_memory_allocated()
    (b0, p0), (b1, p1) = sorted(peaks.items())
    per = (p1 - p0) / (b1 - b0)
    total = torch.cuda.get_device_properties(0).total_memory
    predicted = p1 + per * (mc.batch_size - b1)
    fits = int((SIMCLR_MEMORY_SHARE * total - p1) / per) + b1
    batch = min(mc.batch_size, fits // 10 * 10)
    print(f"simclr memory probe: step peak {p0 / 2 ** 30:.2f} GiB at batch {b0}, "
          f"{p1 / 2 ** 30:.2f} GiB at {b1} ({per / 2 ** 20:.1f} MiB per image, two views); "
          f"predicted {predicted / 2 ** 30:.2f} GiB at the recipe's {mc.batch_size} of "
          f"{total / 2 ** 30:.2f} GiB; batch {batch}  [{card}]")
    del model, step, views
    torch.cuda.empty_cache()
    return batch


def simclr_phase(card: str, entries: dict, device, split_rows: dict, batch=None) -> None:
    """Phase 15: the unimodel recipe through the port's SimCLRTrainer over
    synthetic two-view batches, a fixed-batch descent, the checkpoints read
    back, then `eval --unimodel`'s path on model_best/, and rows 1-2 at the
    SimCLR batch."""
    import torch

    from clibd_tpu_torch.cli.common import _resolve_params
    from clibd_tpu_torch.cli.eval_cmds import unimodel_config
    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.evaluate import format_results, inference_and_eval
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.simclr import (SimCLRTrainer, TwoViewLoader, make_simclr_loss_fn,
                                               make_simclr_step)
    from clibd_tpu_torch.engine.train import ScheduledAdam, batch_generator
    from clibd_tpu_torch.models.clibd import load_simclr_vit_backbone
    from clibd_tpu_torch.models.vit import ViT

    gcfg = simclr_config()
    mc = gcfg.model_config
    B = simclr_batch(card, mc, device) if batch is None else batch
    mc.batch_size = B
    t0 = time.perf_counter()
    split = SyntheticSplit("train", SIMCLR_STEPS_PER_EPOCH * B, mc, seed=30, two_view=True)
    print(f"simclr set-up: {SIMCLR_STEPS_PER_EPOCH} two-view batches of {B} images in "
          f"{time.perf_counter() - t0:.1f} s")
    n_layers = mc.image.vit.num_layers
    steps = SIMCLR_EPOCHS * SIMCLR_STEPS_PER_EPOCH
    logs, per_step = [], []
    with tempfile.TemporaryDirectory(prefix="clibd_simclr_") as out_dir:
        trainer = SimCLRTrainer(gcfg, None, out_dir, loader=TwoViewLoader(None, "train", B,
                                                                          loader=split),
                                log_fn=logs.append, device=device)
        model = trainer.model
        step_fn = trainer.step_fn
        trainer.step_fn = counted(step_fn, per_step)
        reset_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        history = trainer.fit()
        sync(device)
        t_fit = time.perf_counter() - t0
        fit_peak = peak_gib(device)
        counts = read_counts()
        print(f"simclr kernel launches per step (forward, backward): {sorted(set(per_step))} "
              f"over {len(per_step)} steps (expected ({n_layers}, {n_layers}) x {steps})")
        others = {n: c for n, c in counts.items()
                  if n not in ("flash_attention_qkv", "flash_attention_qkv_bwd")}
        if len(per_step) != steps or set(per_step) != {(n_layers, n_layers)} \
                or any(others.values()):
            fail(f"simclr steps launched {per_step}, expected ({n_layers}, {n_layers}) x "
                 f"{steps}, and the other kernels {others}, expected none")
        add_launches(entries, "simclr", counts)
        losses = [d["loss"] for d in logs if "loss" in d]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"simclr losses {losses}")
        for sub in ("checkpoint_0000", "checkpoint_0001", "model_best"):
            for f in ("params.npz", "opt_state.npz", "meta.json"):
                if not os.path.exists(os.path.join(out_dir, sub, f)):
                    fail(f"simclr: {sub}/{f} was not written")
        best = os.path.join(out_dir, "model_best")
        with open(os.path.join(best, "meta.json")) as f:
            best_meta = json.load(f)
        encoder = ViT(mc.image.vit, output_dim=mc.output_dim).to(device)
        load_simclr_vit_backbone(best, encoder)
        with np.load(os.path.join(best, "params.npz")) as f:
            saved = {key: f[key] for key in f.files}
        live = dict(model.named_parameters()) if best_meta["epoch"] == SIMCLR_EPOCHS - 1 else {}
        n_checked = 0
        for name, p in encoder.named_parameters():
            if name.startswith("head."):
                continue
            got = p.detach().cpu().numpy()
            if not np.array_equal(got, saved[name.replace(".", "/")]) or (
                    live and not torch.equal(p, live[name])):
                fail(f"simclr: model_best/ does not load back bit for bit at {name}")
            n_checked += 1
        print(f"simclr losses {[round(v, 4) for v in losses]}, epoch means "
              f"{[round(v, 4) for v in history['loss']]}; model_best/ (epoch "
              f"{best_meta['epoch']}) loads back through load_simclr_vit_backbone, "
              f"{n_checked} tensors bit for bit{' and equal to the live model' if live else ''}")
        del encoder, saved

        # samples/s over steps on one batch, and a fixed-batch descent
        v1, v2, _ = next(trainer.loader.batches(0))
        views = to_device({"v1": v1, "v2": v2}, device)
        step_fn(views["v1"], views["v2"], batch_generator(device, 0, 0, 0))
        sync(device)
        t0 = time.perf_counter()
        for i in range(SIMCLR_RATE_STEPS):
            step_fn(views["v1"], views["v2"], batch_generator(device, 0, 0, i + 1))
        sync(device)
        rate = SIMCLR_RATE_STEPS * B / (time.perf_counter() - t0)
        print(f"simclr: {steps} steps of batch {B} ({2 * B} views) + checkpoints in "
              f"{t_fit:.2f} s; {rate:.2f} samples/s ({2 * rate:.2f} views/s) over "
              f"{SIMCLR_RATE_STEPS} steps (CUDA-synchronised); peak device memory "
              f"{fit_peak:.2f} GiB  [{card}]")
        opt = ScheduledAdam(model.parameters(), lambda i: 5e-5,
                            weight_decay=mc.optim.weight_decay)
        step = make_simclr_step(mc, model, opt)
        loss_fn = make_simclr_loss_fn(mc, model)
        fixed = [float(step(views["v1"], views["v2"], batch_generator(device, 0, 0, 0)))
                 for _ in range(5)]
        with torch.no_grad():
            fixed.append(float(loss_fn(views["v1"], views["v2"], batch_generator(device, 0, 0, 0))))
        print(f"simclr fixed batch, constant LR 5e-5: losses {[round(v, 5) for v in fixed]}")
        if not fixed[-1] < fixed[0]:
            fail("simclr: 5 steps on a fixed batch did not lower its loss")
        trainer.close()
        del trainer, model, opt, step, views
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # eval --unimodel's path on model_best/: the config's edits, the
        # checkpoint chain, extraction of the three splits, the grid
        ucfg = unimodel_config(load_config(experiment=SIMCLR), best)
        umodel = _resolve_params(ucfg, device)
        umc = ucfg.model_config
        usplits = {name: SyntheticSplit(name, n, umc, seed=40 + i)
                   for i, (name, n) in enumerate(split_rows.items())}
        reset_counts()
        t0 = time.perf_counter()
        seen, unseen, keys = extract_trio(umodel, umc, usplits)
        sync(device)
        t_extract = time.perf_counter() - t0
        ucounts = read_counts()
    n_batches = sum(len(s) for s in usplits.values())
    print(f"unimodel_eval forward launches: {ucounts['flash_attention_qkv']} (expected "
          f"{n_layers} x {n_batches} batches); {sum(split_rows.values())} images in "
          f"{t_extract:.3f} s  [{card}]")
    others = {n: c for n, c in ucounts.items() if n != "flash_attention_qkv"}
    if ucounts["flash_attention_qkv"] != n_layers * n_batches or any(others.values()):
        fail(f"unimodel_eval launched {ucounts}, expected {n_layers * n_batches} forward only")
    add_launches(entries, "unimodel_eval", ucounts)
    for name, d in (("all_keys", keys), ("test_seen", seen), ("test_unseen", unseen)):
        check_embeddings(f"unimodel {name}", d, split_rows[name], umc.output_dim, ("image",))
    acc_dict, _, _ = inference_and_eval(keys, seen, unseen, k_list=[1, 3, 5], query_chunk=4096,
                                        with_preds=False, device=device)
    table, csv_rows, _, _ = format_results(acc_dict, [1, 3, 5], "I")
    if len(csv_rows) < 2 or not acc_dict:
        fail("the unimodel kNN grid is empty")
    print(f"unimodel_eval kNN grid: {len(csv_rows) - 1} rows; the table's head:")
    print("\n".join(table.splitlines()[:6]))
    del umodel
    if device.type == "cuda":
        torch.cuda.empty_cache()
        add_path_shapes(entries, "simclr", attention_rows_at(card, "simclr", 2 * B, SHAPES[:1]))


class StepMarks:
    """A loader whose batches mark the forward and backward kernel launches
    at each batch boundary, so that step i's launches are marks[i + 1] -
    marks[i]; the time after the first step (CUDA-synchronised) and at the
    end, and the batches' sizes, are kept for samples/s."""

    def __init__(self, loader, device):
        self.loader, self.device = loader, device
        self.spec = loader.spec
        self.marks, self.sizes, self.t1, self.t_end = [], [], None, None

    def __len__(self):
        return len(self.loader)

    def label_dicts(self):
        return self.loader.label_dicts()

    def ids(self):
        return self.loader.ids()

    def close(self):
        self.loader.close()

    def _mark(self):
        from clibd_tpu_torch.ops.attention import flash_attention_qkv, flash_attention_qkv_bwd

        self.marks.append((flash_attention_qkv.launches, flash_attention_qkv_bwd.launches))

    def batches(self, epoch: int = 0, shuffle=None, start_batch: int = 0):
        for batch in self.loader.batches(epoch=epoch, start_batch=start_batch):
            self._mark()
            if len(self.marks) == 2:
                sync(self.device)
                self.t1 = time.perf_counter()
            self.sizes.append(len(batch["index"]))
            yield batch
        self._mark()
        sync(self.device)
        self.t_end = time.perf_counter()

    def per_step(self) -> list:
        return [(b[0] - a[0], b[1] - a[1]) for a, b in zip(self.marks, self.marks[1:])]

    def rate(self) -> float:
        """samples/s over the steps after the first."""
        return sum(self.sizes[1:]) / (self.t_end - self.t1)


def synthetic_factory(mc, rows: dict, seed: int, species: int, ranges=None, cover=()):
    """→ make_loader(split, spec): a `SyntheticSplit` of `rows[split]`
    specimens of `species` (drawn from `ranges[split]` of them; each one of
    its range among the rows of a split in `cover`), at the spec's batch
    size with the spec's modalities; one per (split, batch, modalities), so
    that a split comes back as it was."""
    from clibd_tpu_torch.data import SyntheticSplit

    made = {}

    def make_loader(split, spec):
        mods = tuple(m for m, on in (("image", spec.with_image), ("dna", spec.with_dna),
                                     ("language", spec.with_language)) if on)
        key = (split, spec.batch_size, mods)
        if key not in made:
            made[key] = SyntheticSplit(split, rows[split], mc, seed=seed + sorted(rows).index(split),
                                       species=species, species_range=(ranges or {}).get(split),
                                       cover_species=split in cover, batch_size=spec.batch_size,
                                       modalities=mods)
        return made[key]

    return make_loader


def n_batches(rows: int, batch: int) -> int:
    return -(-rows // batch)


def kernel_vs_plain_cosine(label: str, fn, rows: bool = False) -> None:
    """fn() → a list of bf16 outputs, embeddings [samples, D] (`rows`) or
    gradient tensors: through the kernels and through their plain versions
    on the card, cosine >= COSINE_MIN per row or per tensor."""
    from clibd_tpu_torch.tools.profile_extract import plain_kernels

    with_kernels = fn()
    with plain_kernels():
        with_plain = fn()
    cos = []
    for a, b in zip(with_kernels, with_plain):
        a, b = a.float(), b.float()
        if rows:
            cos += [float(c) for c in cosine_rows(a, b)]
        else:
            cos.append(float((a * b).sum() / (a.norm() * b.norm())))
    print(f"{label}, kernels vs plain versions on the card: min cosine {min(cos):.6f} over "
          f"{len(cos)} rows or tensors (need >= {COSINE_MIN})")
    if min(cos) < COSINE_MIN:
        fail(f"{label}: the kernels disagree with the plain versions")


def finetune_config():
    """The INSECT fine-tune recipe, checked to be ViT-B/16 and BarcodeBERT
    with 768-d outputs, bf16, batch 150."""
    from clibd_tpu_torch.config import load_config

    mc = load_config(experiment=INSECT_FT).model_config
    v, d = mc.image.vit, mc.dna.bert
    if not (mc.dataset == "INSECT" and mc.amp and mc.batch_size == 150 and mc.output_dim == 768
            and (v.image_size, v.patch_size, v.hidden_size, v.num_layers, v.num_heads)
            == (224, 16, 768, 12, 12) and (d.hidden_size, d.num_layers) == (768, 12)):
        fail(f"{INSECT_FT} is not the bf16 ViT-B/16 + BarcodeBERT recipe at batch 150 with "
             "768-d outputs")
    return mc


def finetune_phase(card: str, entries: dict, device) -> None:
    """Phase 16: `fit_classifier` over an INSECT-shaped synthetic split,
    the image encoder trained, then the DNA encoder frozen; predict and
    top-k, a fixed-batch descent, the gradients against the plain
    versions, and the saved params read back."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.checkpoint import save_train_state
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.finetune import (WEIGHT_DECAY, fit_classifier,
                                                 make_finetune_step, nll_loss, species_to_index,
                                                 topk_accuracy)
    from clibd_tpu_torch.engine.train import ScheduledAdamW
    from clibd_tpu_torch.models import init_clibd_model

    mc = finetune_config()
    B = mc.batch_size
    t0 = time.perf_counter()
    train, test = (SyntheticSplit(name, n, mc, seed=50 + i, species=INSECT_SPECIES,
                                  cover_species=name == "trainval_loc",
                                  modalities=("image", "dna"))
                   for i, (name, n) in enumerate(FINETUNE_ROWS.items()))
    classes = sorted({lab["species"] for lab in train.label_dicts()})
    if len(classes) != INSECT_SPECIES:
        fail(f"finetune: {len(classes)} training species, expected {INSECT_SPECIES}")
    train_t = species_to_index(train.label_dicts(), classes)
    test_t = species_to_index(test.label_dicts(), classes)
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    print(f"finetune set-up: {INSECT_FT}, {FINETUNE_ROWS} synthetic rows of {INSECT_SPECIES} "
          f"species in {time.perf_counter() - t0:.1f} s")
    total = {}
    for modality, train_encoder in (("image", True), ("dna", False)):
        label = f"finetune {modality}" + ("" if train_encoder else " --freeze-encoder")
        encoder = getattr(model, f"{modality}_encoder")
        n_layers = len(encoder.blocks.qkv_w)
        want = (n_layers, n_layers if train_encoder else 0)
        frozen = [p.detach().clone() for p in encoder.parameters()]
        loader = StepMarks(train, device)
        reset_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        ft, predict, epoch_losses = fit_classifier(
            model, mc, loader, train_t, len(classes), lr=FINETUNE_LR, epochs=1,
            modality=modality, train_encoder=train_encoder, seed=mc.default_seed)
        sync(device)
        t_fit = time.perf_counter() - t0
        peak = peak_gib(device)
        per_step, steps = loader.per_step(), len(train)
        print(f"{label} launches per step (forward, backward): {sorted(set(per_step))} over "
              f"{len(per_step)} steps (expected {want} x {steps})")
        if per_step != [want] * steps:
            fail(f"{label}: steps launched {per_step}, expected {want} x {steps}")
        trained = {id(p) for p in ft.trainable_parameters()}
        named = [(n, p) for n, p in ft.named_parameters() if id(p) in trained]
        bad = [n for n, p in named if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or float(p.grad.abs().max()) == 0.0]
        if bad or not all(n.startswith(("classifier.", f"{modality}_encoder."))
                          for n, _ in named):
            fail(f"{label}: trained tensors without a finite nonzero gradient: {bad[:8]}")
        # the frozen encoder takes no step; a trained one is a copy, and the
        # model the fit started from keeps its weights
        if not all(torch.equal(a, b) for a, b in zip(frozen, encoder.parameters())):
            fail(f"{label}: the {modality} encoder of the model changed")
        del frozen
        print(f"{label}: {steps} steps of batch {B} in {t_fit:.2f} s, {loader.rate():.2f} "
              f"samples/s over the steps after the first; peak device memory {peak:.2f} GiB; "
              f"epoch loss {epoch_losses}; {len(named)} trained tensors with a finite nonzero "
              f"gradient{'; the encoder bit-identical' if not train_encoder else ''}  [{card}]")

        t0 = time.perf_counter()
        logits = [predict(b[modality]).cpu().numpy() for b in test.batches()]
        t_pred = time.perf_counter() - t0
        counts = read_counts()
        want_fwd = steps * want[0] + len(test) * n_layers
        others = {n: c for n, c in counts.items()
                  if n not in ("flash_attention_qkv", "flash_attention_qkv_bwd")}
        if (counts["flash_attention_qkv"], counts["flash_attention_qkv_bwd"]) \
                != (want_fwd, steps * want[1]) or any(others.values()):
            fail(f"{label}: fit and predict launched {counts}, expected {want_fwd} forward and "
                 f"{steps * want[1]} backward")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        logits = np.concatenate(logits)
        acc = topk_accuracy(logits, test_t)
        if logits.shape != (len(test_t), len(classes)) or not np.isfinite(logits).all():
            fail(f"{label}: logits {logits.shape} or not finite")
        print(f"{label} predict: {len(test_t)} rows in {t_pred:.3f} s ({n_layers} forward "
              f"launches a batch), top-k accuracy {acc}  [{card}]")

        fixed = next(train.batches())
        x = to_device(fixed[modality], device)
        y = torch.from_numpy(train_t[fixed["index"]].astype(np.int64)).to(device)
        opt = ScheduledAdamW(ft.trainable_parameters(), lambda i: FINETUNE_LR,
                             weight_decay=WEIGHT_DECAY)
        step = make_finetune_step(ft, opt)
        fixed_losses = [float(step(x, y)) for _ in range(5)]
        with torch.no_grad():
            fixed_losses.append(float(nll_loss(ft(x), y)))
        print(f"{label} fixed batch, constant LR {FINETUNE_LR}: losses "
              f"{[round(v, 5) for v in fixed_losses]}")
        if not fixed_losses[-1] < fixed_losses[0]:
            fail(f"{label}: 5 steps on a fixed batch did not lower its loss")
        opt.zero_grad(set_to_none=True)
        xs, ys = head(x, 16), y[:16]
        params = ft.trainable_parameters()
        kernel_vs_plain_cosine(f"{label} bf16 gradients (16 samples)", lambda: list(
            torch.autograd.grad(nll_loss(ft(xs), ys), params)))

        with tempfile.TemporaryDirectory(prefix="clibd_finetune_") as out_dir:
            t0 = time.perf_counter()
            save_train_state(out_dir, ft)
            with np.load(os.path.join(out_dir, "params.npz")) as f:
                saved = {k: f[k] for k in f.files}
        live = {n.replace(".", "/"): p for n, p in ft.named_parameters()}
        if set(saved) != set(live) or saved["classifier/w"].shape != (mc.output_dim, len(classes)):
            fail(f"{label}: the saved params have other keys or a head of "
                 f"{saved.get('classifier/w', np.zeros(0)).shape}")
        differ = [k for k, p in live.items()
                  if not np.array_equal(saved[k], p.detach().float().cpu().numpy())]
        if differ:
            fail(f"{label}: saved params do not load back bit for bit: {differ[:8]}")
        print(f"{label}: save_train_state wrote {len(saved)} tensors (classifier/w "
              f"{saved['classifier/w'].shape}) that load back bit for bit, "
              f"{time.perf_counter() - t0:.2f} s")
        del ft, predict, opt, step, saved, live
        if device.type == "cuda":
            torch.cuda.empty_cache()
    add_launches(entries, "finetune", total)
    del model


def bzsl_phase(card: str, entries: dict, device) -> None:
    """Phase 17: `engine.downstream.bzsl_extract` of INSECT-shaped rows
    through the flagship's image and DNA towers into the BZSL CSVs."""
    import torch

    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.data.pipeline import BatchSpec
    from clibd_tpu_torch.engine.downstream import bzsl_extract
    from clibd_tpu_torch.engine.extract import extract_split, make_encode_step, to_device
    from clibd_tpu_torch.models import init_clibd_model

    mc = load_config(experiment=EXPERIMENT).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    make_loader = synthetic_factory(mc, {"all": BZSL_ROWS}, 60, INSECT_SPECIES)
    spec = BatchSpec(batch_size=BZSL_BATCH, train=False, with_language=False)
    split = make_loader("all", spec)
    class_labels = np.asarray([int(lab["species"].rsplit("_", 1)[1])
                               for lab in split.label_dicts()])
    n_layers = mc.image.vit.num_layers + mc.dna.bert.num_layers
    reset_counts()
    reset_peak(device)
    with tempfile.TemporaryDirectory(prefix="clibd_bzsl_") as folder:
        t0 = time.perf_counter()
        dna_csv, img_csv = bzsl_extract(model, mc, make_loader, class_labels, folder,
                                        batch_size=BZSL_BATCH)
        sync(device)
        t_run = time.perf_counter() - t0
        counts = read_counts()
        dna = np.loadtxt(dna_csv, delimiter=",", ndmin=2)
        img = np.loadtxt(img_csv, delimiter=",", ndmin=2)
    peak = peak_gib(device)
    batches = n_batches(BZSL_ROWS, BZSL_BATCH)
    others = {n: c for n, c in counts.items() if n != "flash_attention_qkv"}
    print(f"bzsl_extract forward launches: {counts['flash_attention_qkv']} (expected "
          f"{n_layers} x {batches} batches)")
    if counts["flash_attention_qkv"] != n_layers * batches or any(others.values()):
        fail(f"bzsl_extract launched {counts}, expected {n_layers * batches} forward only")
    add_launches(entries, "bzsl_extract", counts)
    classes = np.unique(class_labels)
    if img.shape != (mc.output_dim, BZSL_ROWS) or dna.shape != (mc.output_dim, len(classes)) \
            or not (np.isfinite(img).all() and np.isfinite(dna).all()):
        fail(f"bzsl CSVs: image {img.shape}, DNA {dna.shape}, expected ({mc.output_dim}, "
             f"{BZSL_ROWS}) and ({mc.output_dim}, {len(classes)}), finite")
    # the DNA CSV's columns are the classes' mean embeddings in class order
    dna_only = extract_split(model, mc, make_loader("all", BatchSpec(
        batch_size=BZSL_BATCH, train=False, with_image=False, with_language=False)))
    means = np.stack([dna_only["encoded_dna_feature"][class_labels == c].mean(axis=0)
                      for c in classes])
    err = float(np.abs(dna - means.T).max())
    if err > 1e-6:
        fail(f"bzsl DNA CSV columns are not the class means in class order: max |d| {err}")
    print(f"bzsl_extract: {BZSL_ROWS} records at batch {BZSL_BATCH} in {t_run:.3f} s = "
          f"{BZSL_ROWS / t_run:.2f} records/s (CSV writes included); image CSV {img.shape}, DNA "
          f"CSV {dna.shape} = the means of {len(classes)} classes in order (max |d| {err:.1e}); "
          f"peak device memory {peak:.2f} GiB  [{card}]")
    b = next(split.batches())
    small = to_device({m: head(b[m], 8) for m in ("image", "dna")}, device)
    step = make_encode_step(mc, model)
    kernel_vs_plain_cosine("bzsl_extract bf16 image and DNA embeddings (8 samples)",
                           lambda: list(step(small).values()), rows=True)
    del model


def method_nn_phase(card: str, entries: dict, device) -> None:
    """Phase 18: `engine.downstream.method_nn_eval` of the flagship over
    synthetic splits of disjoint seen and unseen species: plain, the frozen
    linear probe and the full probe."""
    import torch

    from clibd_tpu_torch.engine.downstream import method_nn_eval
    from clibd_tpu_torch.engine.extract import make_encode_step, to_device
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.utils.metrics import harmonic_mean

    mc = recipe_config(EXPERIMENT, 1).model_config
    B = mc.batch_size
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    half = METHOD_NN_SPECIES // 2
    ranges = {s: (0, half) if s in ("val_seen", "test_seen", "seen_keys")
              else (half, METHOD_NN_SPECIES) for s in METHOD_NN_ROWS}
    factory = synthetic_factory(mc, METHOD_NN_ROWS, 70, METHOD_NN_SPECIES, ranges,
                                cover=("seen_keys",))
    probes = []

    def make_loader(split, spec):
        loader = factory(split, spec)
        if spec.train:
            probes.append(StepMarks(loader, device))
            return probes[-1]
        return loader

    unseen_keys = "val_unseen_keys,test_unseen_keys"
    queries = ("val_seen", "val_unseen", "test_seen", "test_unseen")
    image_layers = mc.image.vit.num_layers
    per_batch = image_layers + mc.dna.bert.num_layers + mc.language.bert.num_layers
    total = {}
    for leg, kw in (("plain", {}), ("linear", {"linear": True, "probe_steps": PROBE_STEPS}),
                    ("probe_full", {"linear": True, "probe": "full", "probe_epochs": 1})):
        record = {}
        probes.clear()
        reset_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        summary = method_nn_eval(model, mc, make_loader, eval_on="test",
                                 unseen_keys_split=unseen_keys, record=record, **kw)
        sync(device)
        t_leg = time.perf_counter() - t0
        peak = peak_gib(device)
        counts = read_counts()
        extracted = list(queries) + unseen_keys.split(",")
        if leg != "probe_full":
            extracted.append("seen_keys")
        want_fwd = per_batch * sum(n_batches(METHOD_NN_ROWS[s], B) for s in extracted)
        want_bwd = 0
        if leg == "probe_full":
            per_step = probes[0].per_step()
            steps = len(probes[0])
            print(f"method_nn probe_full launches per step (forward, backward): "
                  f"{sorted(set(per_step))} over {len(per_step)} steps (expected "
                  f"({image_layers}, {image_layers}) x {steps})")
            if per_step != [(image_layers, image_layers)] * steps:
                fail(f"method_nn probe_full steps launched {per_step}")
            want_fwd += image_layers * (steps + sum(n_batches(METHOD_NN_ROWS[q], B)
                                                    for q in queries))
            want_bwd = image_layers * steps
        others = {n: c for n, c in counts.items()
                  if n not in ("flash_attention_qkv", "flash_attention_qkv_bwd")}
        print(f"method_nn {leg} launches: {counts['flash_attention_qkv']} forward, "
              f"{counts['flash_attention_qkv_bwd']} backward (expected {want_fwd}, {want_bwd}: "
              f"{per_batch} a batch of extraction" + (f", {image_layers} a probe step and "
                                                     f"batch of logits" if want_bwd else "")
              + ")")
        if (counts["flash_attention_qkv"], counts["flash_attention_qkv_bwd"]) \
                != (want_fwd, want_bwd) or any(others.values()):
            fail(f"method_nn {leg} launched {counts}, expected ({want_fwd}, {want_bwd})")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        hm = harmonic_mean(summary["seen_species_top1"], summary["unseen_species_top1"])
        in_range = all(0.0 <= summary[k] <= 1.0 for k in
                       ("best_threshold", "seen_routing_top1", "unseen_routing_top1",
                        "seen_species_top1", "unseen_species_top1"))
        if not (in_range and math.isfinite(hm)):
            fail(f"method_nn {leg}: summary {summary}, harmonic mean {hm}")
        line = (f"method_nn {leg}: {json.dumps(summary)}, harmonic mean {hm:.4f}; "
                f"{t_leg:.2f} s")
        if leg == "linear":
            losses = record["frozen_probe_losses"]
            if len(losses) != PROBE_STEPS or not losses[-1] < losses[0]:
                fail(f"method_nn linear: the frozen probe's loss did not fall: "
                     f"{losses[:2]} ... {losses[-2:]} ({len(losses)} steps)")
            line += f"; frozen probe loss {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps"
        if leg == "probe_full":
            losses = record["probe_step_losses"]
            if not all(math.isfinite(v) for v in losses):
                fail(f"method_nn probe_full losses {losses}")
            line += (f"; full probe step losses {[round(v, 4) for v in losses]}, "
                     f"{probes[0].rate():.2f} samples/s over the steps after the first at batch "
                     f"{B} (no remat)")
        print(f"{line}; peak device memory {peak:.2f} GiB  [{card}]")
    add_launches(entries, "method_nn", total)
    from clibd_tpu_torch.data.pipeline import BatchSpec

    b = next(factory("test_seen", BatchSpec(batch_size=B, train=False, with_image=True,
                                            with_dna=True, with_language=True)).batches())
    small = to_device({m: head(b[m], 8) for m in ("image", "dna", "language")}, device)
    step = make_encode_step(mc, model)
    kernel_vs_plain_cosine("method_nn bf16 tri-modal embeddings (8 samples)",
                           lambda: list(step(small).values()), rows=True)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()


def zeroshot_phase(card: str, entries: dict, device) -> None:
    """Phase 19: `engine.downstream.zeroshot_eval` on the BioCLIP recipe's
    CLIP towers, loaded from an open_clip state dict written here, in its
    three modes; the class prototypes timed alone."""
    import torch

    from clibd_tpu_torch.data.pipeline import BatchSpec
    from clibd_tpu_torch.engine.downstream import (clip_encoders, clip_towers_from_checkpoint,
                                                   zeroshot_eval)
    from clibd_tpu_torch.engine.zeroshot import OPENAI_IMAGENET_TEMPLATES, build_class_prototypes
    from clibd_tpu_torch.models.clibd import clip_configs

    mc = bioclip_config().model_config
    vcfg, tcfg = clip_configs(mc)
    if (tcfg.vocab_size, tcfg.context_length) != (49408, 77):
        fail(f"{BIOCLIP}'s text tower is not CLIP's vocabulary of 49408 at 77 tokens")
    with tempfile.TemporaryDirectory(prefix="clibd_zeroshot_") as tmp:
        t0 = time.perf_counter()
        sd = open_clip_state_dict(vcfg, tcfg, torch.Generator().manual_seed(ZEROSHOT_SEED))
        mc.clip.checkpoint = os.path.join(tmp, "open_clip.pt")
        torch.save(sd, mc.clip.checkpoint)
        del sd
        mc.clip.bpe_path = write_bpe_merges(os.path.join(tmp, "bpe_merges.txt.gz"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        vision, text, tokenizer = clip_towers_from_checkpoint(mc, device)
        gb = os.path.getsize(mc.clip.checkpoint) / 1e9
    print(f"zeroshot: wrote a {gb:.3f} GB open_clip state dict in {t_write:.2f} s, loaded the "
          f"towers onto the card in {time.perf_counter() - t0:.2f} s")
    make_loader = synthetic_factory(mc, ZEROSHOT_ROWS, 80, ZEROSHOT_SPECIES,
                                    cover=tuple(ZEROSHOT_ROWS))
    n_layers = vcfg.num_layers
    batch = ZEROSHOT_BATCH
    total = {}
    for mode, kw in (("level", {}), ("four_level", {"four_level": True}),
                     ("image_to_image", {"image_to_image": True})):
        reset_counts()
        t0 = time.perf_counter()
        report = zeroshot_eval(vision, text, tokenizer, make_loader, split="test_seen",
                               keys_split="all_keys", level="species", batch_size=batch, **kw)
        sync(device)
        t_mode = time.perf_counter() - t0
        counts = read_counts()
        image_batches = n_batches(ZEROSHOT_ROWS["test_seen"], batch)
        if mode == "image_to_image":
            image_batches += n_batches(ZEROSHOT_ROWS["all_keys"], batch)
        others = {n: c for n, c in counts.items() if n != "flash_attention_qkv"}
        print(f"zeroshot {mode} forward launches: {counts['flash_attention_qkv']} (expected "
              f"{n_layers} x {image_batches} image batches, none from the causal text tower)")
        if counts["flash_attention_qkv"] != n_layers * image_batches or any(others.values()):
            fail(f"zeroshot {mode} launched {counts}, expected {n_layers * image_batches} "
                 "forward only")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        numbers = [v for acc in report.values() if isinstance(acc, dict)
                   for per in acc.values() for v in (per.values() if isinstance(per, dict)
                                                     else [per])]
        if not numbers or not all(0.0 <= v <= 1.0 for v in numbers) or (
                mode == "level" and report["num_classes"] != ZEROSHOT_SPECIES):
            fail(f"zeroshot {mode}: report {report}")
        print(f"zeroshot {mode}: {json.dumps(report)[:300]}; {t_mode:.2f} s  [{card}]")
    add_launches(entries, "zeroshot", total)

    encode_images, encode_text = clip_encoders(vision, text, tokenizer)
    names = [f"species {i}" for i in range(ZEROSHOT_SPECIES)]
    reset_counts()
    t0 = time.perf_counter()
    protos = build_class_prototypes(names, encode_text)
    t_text = time.perf_counter() - t0
    prompts = len(names) * len(OPENAI_IMAGENET_TEMPLATES)
    norm_err = float(np.abs(np.linalg.norm(protos, axis=1) - 1).max())
    if protos.shape != (ZEROSHOT_SPECIES, tcfg.embed_dim) or norm_err > 1e-5 \
            or read_counts()["flash_attention_qkv"]:
        fail(f"zeroshot prototypes {protos.shape}, max |norm - 1| {norm_err}, or the text "
             "tower launched a kernel")
    query = make_loader("test_seen", BatchSpec(batch_size=batch, train=False, with_dna=False,
                                               with_language=False))
    t0 = time.perf_counter()
    feats = [encode_images(b["image"]) for b in query.batches()]
    t_img = time.perf_counter() - t0
    print(f"zeroshot prototypes: {prompts} prompts at batch 256 in {t_text:.2f} s = "
          f"{prompts / t_text:.1f} prompts/s (host BPE included), unit-norm (max |norm - 1| "
          f"{norm_err:.1e}); images: {ZEROSHOT_ROWS['test_seen']} at batch {batch} in "
          f"{t_img:.3f} s = {ZEROSHOT_ROWS['test_seen'] / t_img:.1f} images/s  [{card}]")
    if not np.isfinite(np.concatenate(feats)).all():
        fail("zeroshot image features are not finite")
    x = torch.from_numpy(next(query.batches())["image"][:8]).to(device)

    def vision_rows():
        from clibd_tpu_torch.models.clip import clip_normalize
        from clibd_tpu_torch.models.clibd import dequantize_image

        with torch.inference_mode():
            return [vision(clip_normalize(dequantize_image(x)), torch.bfloat16)]

    kernel_vs_plain_cosine("zeroshot bf16 CLIP image features (8 samples)", vision_rows,
                           rows=True)
    del vision, text
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank; every rank on card 0."""
    repo = str(Path(__file__).resolve().parent)
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run_rank_group(world: int, payload: dict, work: str) -> list:
    """Start `world` ranks of this script (`--multi-gpu-rank`) on the
    payload, relay their output, and → each rank's results.  A rank that
    exits non-zero or outlives MULTI_GPU_TIMEOUT fails the phase; every rank
    is stopped on the way out."""
    import subprocess

    import torch

    from clibd_tpu_torch.parallel import free_port

    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "payload.pt")
    torch.save(payload, path)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multi-gpu-rank",
                               path, work], env=_rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [None] * world
    deadline = time.monotonic() + MULTI_GPU_TIMEOUT
    try:
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail(f"multi_gpu: a rank of {payload['legs']} ran past {MULTI_GPU_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in (log or "").splitlines():
            if "hostname of the client socket" not in line:
                print(f"[rank {r}/{world}] {line}")
        if p.returncode != 0:
            fail(f"multi_gpu: rank {r} of {world} ({payload['legs']}) exited {p.returncode}")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _grad_cosines(grads: dict, ref: dict) -> tuple:
    """(the smallest cosine over tensors, its name, the number of tensors)."""
    cos = {n: float((g.float() * ref[n].float()).sum() / (g.float().norm() * ref[n].float().norm()))
           for n, g in grads.items()}
    worst = min(cos, key=cos.get)
    return cos[worst], worst, len(cos)


def _params_host(model) -> dict:
    return {n: p.detach().float().cpu() for n, p in model.named_parameters()}


def _nccl_leg(payload: dict, mesh, device) -> dict:
    """Leg 1: the Trainer's multi-rank step in a group of one NCCL rank
    against the single-card Trainer over the same batches and generators."""
    import torch
    import torch.distributed as dist

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.train import Trainer, fold_in
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.parallel import create_mesh

    gcfg = payload["gcfg"]
    mc = gcfg.model_config
    steps = MULTI_GPU_NCCL_STEPS
    split = SyntheticSplit("train", steps * mc.batch_size, mc, seed=50, drop_last=True)
    runs = {}
    for name in ("single card", "multi-rank"):
        mc.step_impl = "shard_map" if name == "multi-rank" else "global"
        logs, per_step = [], []
        model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
        with tempfile.TemporaryDirectory(prefix="clibd_nccl_") as out_dir:
            trainer = Trainer(gcfg, None, out_dir, train_loader=split, model=model,
                              log_fn=logs.append, device=device,
                              mesh=mesh if name == "multi-rank" else create_mesh([device]))
            if name == "single card":
                plain = trainer.step_fn
                # the generators the multi-rank step draws: folded with rank 0
                trainer.step_fn = lambda batch, gen: plain(batch, fold_in(gen, 0))
            elif "make_train_step_shard_map" not in trainer.step_fn.__qualname__:
                fail(f"multi_gpu: the Trainer did not take the multi-rank step")
            trainer.step_fn = counted(trainer.step_fn, per_step)
            reset_counts()
            sync(device)
            t0 = time.perf_counter()
            trainer.train_epoch(0)
            sync(device)
            seconds = time.perf_counter() - t0
            counts = read_counts()
            trainer.close()
        runs[name] = {"losses": [d["loss"] for d in logs if "loss" in d],
                      "params": _params_host(model), "per_step": per_step, "counts": counts,
                      "seconds": seconds,
                      "rates": [d["throughput/samples_per_sec_per_chip"] for d in logs
                                if "throughput/samples_per_sec_per_chip" in d]}
        del trainer, model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    a, b = runs["single card"], runs["multi-rank"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
    param_err = max(float((b["params"][n] - p).abs().max() / p.abs().max().clamp_min(1e-30))
                    for n, p in a["params"].items())
    identical = b["losses"] == a["losses"] and all(torch.equal(b["params"][n], p)
                                                   for n, p in a["params"].items())
    return {"backend": dist.get_backend(mesh.group), "losses": b["losses"],
            "single_losses": a["losses"], "loss_rel_err": loss_err, "param_rel_err": param_err,
            "bit_identical": identical, "per_step": b["per_step"], "counts": b["counts"],
            "seconds": b["seconds"], "single_seconds": a["seconds"], "steps": steps,
            "batch": mc.batch_size, "rates": b["rates"], "single_rates": a["rates"]}


def _nccl_accum_leg(payload: dict, mesh, device) -> dict:
    """Leg 1b: the gradient cache at k=MULTI_GPU_ACCUM_K in the group of one
    NCCL rank (`make_accum_grad_fn(mesh=)`: the gather, the sharded loss
    and the gradient all-reduce) against the single-card cache on the same
    batch and generator (folded with rank 0, as the group's step folds it):
    the loss and every gradient bit for bit."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine import train as train_mod
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models import init_clibd_model

    mc = payload["gcfg"].model_config
    k = MULTI_GPU_ACCUM_K
    batch = next(SyntheticSplit("train", mc.batch_size, mc, seed=52, drop_last=True).batches())
    batch = to_device({key: v for key, v in batch.items() if key != "index"}, device)
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    gen = train_mod.batch_generator(device, mc.default_seed, 0, 0)
    runs = {}
    for name, grad_mesh, g in (("single card", None, train_mod.fold_in(gen, 0)),
                               ("nccl", mesh, gen)):
        model.zero_grad(set_to_none=True)
        grad_fn = train_mod.make_accum_grad_fn(mc, model, k, grad_mesh)
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        loss = grad_fn(batch, g)
        sync(device)
        runs[name] = {"loss": float(loss), "ms": (time.perf_counter() - t0) * 1e3,
                      "counts": read_counts(),
                      "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                if p.grad is not None}}
    a, b = runs["single card"], runs["nccl"]
    identical = a["loss"] == b["loss"] and set(a["grads"]) == set(b["grads"]) and all(
        torch.equal(b["grads"][n], g) for n, g in a["grads"].items())
    out = {"k": k, "loss": b["loss"], "single_loss": a["loss"], "bit_identical": identical,
           "ms": b["ms"], "single_ms": a["ms"], "counts": b["counts"],
           "per_step": (b["counts"]["flash_attention_qkv"],
                        b["counts"]["flash_attention_qkv_bwd"]),
           "tensors": len(a["grads"])}
    del runs, model, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_step_leg(payload: dict, mesh, device) -> dict:
    """Leg 2, the compared step: the multi-rank gradients of the global batch
    (identity augmentation) against the single-card step on the same rows,
    computed on rank 0."""
    import torch
    import torch.distributed as dist

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine import train as train_mod
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.parallel import all_reduce_grads

    mc = payload["gcfg"].model_config
    b = mc.batch_size

    def shard(g):
        batch = next(SyntheticSplit("train", b * mesh.size, mc, seed=51, batch_size=b,
                                    host_id=g, num_hosts=mesh.size, drop_last=True).batches())
        return {k: v for k, v in batch.items() if k != "index"}

    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    real_augment = train_mod.train_augment
    train_mod.train_augment = lambda generator, images: images
    out = {}
    try:
        if mesh.rank == 0:
            whole = [shard(g) for g in range(mesh.size)]
            glob = {k: (np.concatenate([w[k] for w in whole]) if not isinstance(whole[0][k], dict)
                        else {kk: np.concatenate([w[k][kk] for w in whole]) for kk in whole[0][k]})
                    for k in whole[0]}
            loss = train_mod.make_loss_fn(mc, model)(to_device(glob, device), None)
            loss.backward()
            ref = {n: p.grad.float().cpu() for n, p in trainable}
            ref_loss = float(loss.detach())
            model.zero_grad(set_to_none=True)
            del loss, glob, whole
        dist.barrier()
        local = to_device(shard(mesh.rank), device)
        grad_fn = train_mod.make_sharded_grad_fn(mc, model, mesh)
        grad_fn(local, None)  # warm-up
        model.zero_grad(set_to_none=True)
        sync(device)
        reset_peak(device)
        reset_counts()
        t0 = time.perf_counter()
        loss = float(grad_fn(local, None))
        sync(device)
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["peak_gib"] = peak_gib(device)
        counts = read_counts()
        out["per_step"] = (counts["flash_attention_qkv"], counts["flash_attention_qkv_bwd"])
        out["loss"] = loss
        grads = {n: p.grad.float().cpu() for n, p in trainable}
        # the collective alone: the same all-reduce over gradients of these sizes
        dummy = [SimpleNamespace(grad=torch.zeros_like(p)) for _, p in trainable]
        sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        all_reduce_grads(dummy, "mean", mesh.group)
        sync(device)
        out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3
        # the same reduce with the buffer copied to the host and back by hand
        buf = torch.cat([d.grad.reshape(-1) for d in dummy])
        dist.barrier()
        t0 = time.perf_counter()
        host = buf.cpu()
        dist.all_reduce(host, group=mesh.group)
        buf.copy_(host)
        sync(device)
        out["all_reduce_host_ms"] = (time.perf_counter() - t0) * 1e3
        del dummy, buf, host
        out["grad_bytes"] = sum(p.numel() * 4 for _, p in trainable)
        if mesh.rank == 0:
            cos, worst, n = _grad_cosines(grads, ref)
            out.update(ref_loss=ref_loss, min_cosine=cos, worst=worst, tensors=n)
            if abs(loss - ref_loss) > DP_LOSS_REL_TOL * abs(ref_loss) or cos < COSINE_MIN:
                fail(f"multi_gpu W={mesh.size}: loss {loss} against {ref_loss}, min gradient "
                     f"cosine {cos} at {worst}")
        # the gradient cache across the ranks on the same rows, k microbatches a rank
        del grads
        model.zero_grad(set_to_none=True)
        accum_fn = train_mod.make_accum_grad_fn(mc, model, MULTI_GPU_ACCUM_K, mesh)
        dist.barrier()
        sync(device)
        reset_peak(device)
        reset_counts()
        t0 = time.perf_counter()
        aloss = float(accum_fn(local, None))
        sync(device)
        counts = read_counts()
        acc = {"k": MULTI_GPU_ACCUM_K, "loss": aloss, "step_ms": (time.perf_counter() - t0) * 1e3,
               "peak_gib": peak_gib(device), "counts": counts,
               "per_step": (counts["flash_attention_qkv"], counts["flash_attention_qkv_bwd"])}
        if mesh.rank == 0:
            agrads = {n: p.grad.float().cpu() for n, p in trainable}
            cos, worst, n = _grad_cosines(agrads, ref)
            acc.update(ref_loss=ref_loss, min_cosine=cos, worst=worst, tensors=n)
            if abs(aloss - ref_loss) > DP_LOSS_REL_TOL * abs(ref_loss) or cos < COSINE_MIN:
                fail(f"multi_gpu W={mesh.size} accum k={MULTI_GPU_ACCUM_K}: loss {aloss} against "
                     f"{ref_loss}, min gradient cosine {cos} at {worst}")
            del agrads
        out["accum"] = acc
    finally:
        train_mod.train_augment = real_augment
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_trainer_leg(payload: dict, mesh, device, work: str) -> dict:
    """Leg 2, the main path: the Trainer at W ranks over host-sharded
    synthetic splits (each rank its own output directory), one epoch and
    its eval; then leg 3 (extraction row for row) and leg 4 (the resume)."""
    import torch

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.checkpoint import opt_state_to_optax, save_train_state
    from clibd_tpu_torch.engine.extract import extract_split, extract_split_multihost
    from clibd_tpu_torch.engine.train import Trainer
    from clibd_tpu_torch.models import init_clibd_model

    gcfg = payload["gcfg"]
    mc = gcfg.model_config
    mc.checkpoint_every_steps = 1
    rows = payload["eval_rows"]
    n_layers = mc.image.vit.num_layers + mc.dna.bert.num_layers + mc.language.bert.num_layers

    def factory(split, train, host_id=0, num_hosts=1):
        return SyntheticSplit(split, rows[split], mc, seed=60 + sorted(rows).index(split),
                              host_id=host_id, num_hosts=num_hosts)

    train_split = SyntheticSplit("train", payload["train_rows"], mc, seed=59,
                                 host_id=mesh.rank, num_hosts=mesh.size, drop_last=True)
    own = os.path.join(work, f"out{mesh.rank}")
    logs, per_step = [], []
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    trainer = Trainer(gcfg, None, own, train_loader=train_split, eval_loader_factory=factory,
                      model=model, log_fn=logs.append, device=device, mesh=mesh)
    trainer.step_fn = counted(trainer.step_fn, per_step)
    reset_counts()
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    history = trainer.fit()
    sync(device)
    out = {"fit_seconds": time.perf_counter() - t0, "fit_peak_gib": peak_gib(device),
           "counts": read_counts(), "per_step": per_step, "losses": history["loss"],
           "overall_acc": history["overall_acc"], "world_size": trainer.world_size,
           "rates": [d["throughput/samples_per_sec_per_chip"] for d in logs
                     if "throughput/samples_per_sec_per_chip" in d]}
    trainer.close()
    out["written"] = sorted(os.path.relpath(os.path.join(d, f), own)
                            for d, _, fs in os.walk(own) for f in fs) if os.path.exists(own) else []
    want = (n_layers, n_layers)
    if not per_step or set(per_step) != {want}:
        fail(f"multi_gpu rank {mesh.rank}: steps launched {per_step}, expected {want} each")
    if not all(math.isfinite(v) for v in history["loss"]) or len(history["overall_acc"]) != 1:
        fail(f"multi_gpu rank {mesh.rank}: losses {history['loss']}, evals "
             f"{history['overall_acc']}")

    # leg 3: the sharded extraction of an odd split, row for row
    reset_counts()
    sync(device)
    t0 = time.perf_counter()
    got = extract_split_multihost(model, mc, None, "all_keys", None, for_key_set=True,
                                  make_loader=lambda g, w: factory("all_keys", False, g, w),
                                  mesh=mesh)
    sync(device)
    out["extract_seconds"] = time.perf_counter() - t0
    out["extract_counts"] = read_counts()
    if mesh.rank == 0:
        want_d = extract_split(model, mc, factory("all_keys", False), for_key_set=True)
        cos = min(float(cosine_rows(torch.from_numpy(got[k]), torch.from_numpy(want_d[k])).min())
                  for k in ("encoded_image_feature", "encoded_dna_feature",
                            "encoded_language_feature"))
        same = (got["label_list"] == want_d["label_list"]
                and got["file_name_list"] == want_d["file_name_list"])
        out.update(extract_min_cosine=cos, extract_same_labels=same,
                   extract_rows=int(got["encoded_image_feature"].shape[0]))
        if cos < MULTI_GPU_EXTRACT_COSINE or not same:
            fail(f"multi_gpu extract_split_multihost: min row cosine {cos}, labels and ids "
                 f"identical {same}")

    # leg 4: rank 1 holds a stale last/ of another seed at the same path
    del trainer, model
    if mesh.rank != 0:
        stale = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed + 1), device)
        save_train_state(os.path.join(own, "last"), stale, None, step=99, epoch=5)
        del stale
    fresh_model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed + 2),
                                   device)
    fresh = Trainer(gcfg, None, os.path.join(work, f"fresh{mesh.rank}"), train_loader=train_split,
                    model=fresh_model, device=device, mesh=mesh)
    t0 = time.perf_counter()
    epoch = fresh.resume_multihost(os.path.join(own, "last"))
    out["resume_seconds"] = time.perf_counter() - t0
    main_last = os.path.join(work, "out0", "last")
    with np.load(os.path.join(main_last, "params.npz")) as f:
        params_same = all(np.array_equal(p.detach().cpu().numpy(), f[n.replace(".", "/")])
                          for n, p in fresh_model.named_parameters())
    with np.load(os.path.join(main_last, "opt_state.npz")) as f:
        flat = opt_state_to_optax(fresh_model, fresh.optimizer)
        opt_same = set(flat) == set(f.files) and all(np.array_equal(v, f[k])
                                                      for k, v in flat.items())
    with open(os.path.join(main_last, "meta.json")) as f:
        meta = json.load(f)
    out.update(resume_epoch=epoch, resume_step=fresh.global_step, resume_params_same=params_same,
               resume_opt_same=opt_same, saved_step=meta["step"])
    if not (params_same and opt_same and fresh.global_step == meta["step"]):
        fail(f"multi_gpu rank {mesh.rank}: resume_multihost does not hold rank 0's checkpoint "
             f"(params {params_same}, optimizer state {opt_same}, step {fresh.global_step} "
             f"against {meta['step']})")
    fresh.close()
    del fresh, fresh_model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_simclr_leg(payload: dict, mesh, device) -> dict:
    """Leg 5: one data-parallel SimCLR step against two single-card steps,
    one on each rank's rows with its views, computed on rank 0."""
    import torch
    import torch.distributed as dist

    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.engine.simclr import make_simclr_grad_fn, make_simclr_loss_fn
    from clibd_tpu_torch.engine.train import batch_generator, fold_in
    from clibd_tpu_torch.models.vit import ViT

    mc = payload["simclr_gcfg"].model_config
    b = payload["simclr_batch"]

    def views(g):
        batch = next(SyntheticSplit("train", b * mesh.size, mc, seed=70, batch_size=b,
                                    two_view=True, modalities=("image",), host_id=g,
                                    num_hosts=mesh.size).batches())
        return to_device({"v1": batch["image"], "v2": batch["image2"]}, device)

    model = ViT(mc.image.vit, output_dim=mc.output_dim, lora_rank=0)
    model.reset_parameters(torch.Generator().manual_seed(mc.default_seed))
    model = model.to(device)
    gen = batch_generator(device, mc.default_seed, 0, 0)
    out = {}
    if mesh.rank == 0:
        loss_fn = make_simclr_loss_fn(mc, model)
        singles = []
        for g in range(mesh.size):
            v = views(g)
            loss = loss_fn(v["v1"], v["v2"], fold_in(gen, g))
            loss.backward()  # the gradients add up over the ranks' rows
            singles.append(float(loss.detach()))
            del loss, v
        ref = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        out["single_losses"] = singles
    dist.barrier()
    v = views(mesh.rank)
    grad_fn = make_simclr_grad_fn(mc, model, mesh=mesh)
    sync(device)
    reset_peak(device)
    reset_counts()
    t0 = time.perf_counter()
    loss = float(grad_fn(v["v1"], v["v2"], gen))
    sync(device)
    out.update(step_ms=(time.perf_counter() - t0) * 1e3, peak_gib=peak_gib(device), loss=loss,
               counts=read_counts(), batch=b)
    if mesh.rank == 0:
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        cos, worst, n = _grad_cosines(grads, ref)
        mean = sum(out["single_losses"]) / len(out["single_losses"])
        out.update(min_cosine=cos, worst=worst, tensors=n)
        if abs(loss - mean) > DP_LOSS_REL_TOL * abs(mean) or cos < COSINE_MIN:
            fail(f"multi_gpu SimCLR W={mesh.size}: loss {loss} against the mean {mean} of "
                 f"{out['single_losses']}, min gradient cosine {cos} at {worst}")
    del model, v
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _gloo_cuda_probe(mesh, device) -> str:
    """Whether gloo's all_gather and all_reduce take CUDA tensors and give
    the right values (the helpers hand gloo CUDA tensors as they are; legs
    2-5 have run through them before this)."""
    import torch
    import torch.distributed as dist

    if device.type != "cuda":
        return "not asked (CPU run)"
    x = torch.full((4,), float(mesh.rank), device=device)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    dist.all_reduce(x, group=mesh.group)
    ok = all(torch.equal(p, torch.full((4,), float(r), device=device))
             for r, p in enumerate(parts))
    ok &= torch.equal(x, torch.full((4,), float(sum(range(mesh.size))), device=device))
    return "yes" if ok else "no: wrong values"


def multi_gpu_rank_main(payload_path: str, work: str) -> int:
    """One rank of phase 20 (`python3 chip_smoke.py --multi-gpu-rank
    PAYLOAD WORK`, started by `run_rank_group` with torchrun's
    environment): joins the group, runs the payload's legs, writes
    WORK/rank<r>.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from clibd_tpu_torch.models.layers import kernel_knobs
    from clibd_tpu_torch.parallel import create_mesh, maybe_initialize_distributed

    payload = torch.load(payload_path, weights_only=False)
    device = torch.device(payload["device"])
    maybe_initialize_distributed(device, backend=payload["backend"])
    try:
        mesh = create_mesh(device=device)
        device = mesh.device
        out = {"rank": mesh.rank, "backend": dist.get_backend(mesh.group)}
        with kernel_knobs(False, "xla"):
            for leg in payload["legs"]:
                t0 = time.perf_counter()
                if leg == "nccl":
                    out[leg] = _nccl_leg(payload, mesh, device)
                elif leg == "dp_step":
                    out[leg] = _dp_step_leg(payload, mesh, device)
                elif leg == "dp_trainer":
                    out[leg] = _dp_trainer_leg(payload, mesh, device, work)
                elif leg == "nccl_accum":
                    out[leg] = _nccl_accum_leg(payload, mesh, device)
                elif leg == "dp_simclr":
                    out[leg] = _dp_simclr_leg(payload, mesh, device)
                out[leg]["leg_seconds"] = time.perf_counter() - t0
        if mesh.size > 1:
            out["gloo_takes_cuda"] = _gloo_cuda_probe(mesh, device)
        with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def multi_gpu_phase(card: str, entries: dict, device) -> None:
    """Phase 20: one NCCL rank through the torchrun environment, two gloo
    ranks on the one card (train step, Trainer with its eval, extraction,
    resume, SimCLR), then the key-sharded gallery over the card named twice
    and `serve --shard-keys`'s service."""
    import gc

    import torch

    gcfg = recipe_config(EXPERIMENT, 1)
    sgcfg = simclr_config()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"multi_gpu: the parent holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of "
              f"the card before starting ranks")
    n_layers = (gcfg.model_config.image.vit.num_layers + gcfg.model_config.dna.bert.num_layers
                + gcfg.model_config.language.bert.num_layers)
    B = gcfg.model_config.batch_size
    with tempfile.TemporaryDirectory(prefix="clibd_multi_gpu_") as work:
        t0 = time.perf_counter()
        nccl = run_rank_group(1, {"legs": ["nccl", "nccl_accum"], "device": device.type,
                                  "backend": "nccl" if device.type == "cuda" else "gloo",
                                  "gcfg": gcfg}, os.path.join(work, "nccl"))[0]
        t_nccl = time.perf_counter() - t0
        r = nccl["nccl"]
        print(f"multi_gpu leg 1, {r['backend']} W=1 through the torchrun environment: "
              f"{r['steps']} Trainer steps of batch {r['batch']} through the multi-rank step, "
              f"losses {[round(v, 6) for v in r['losses']]} against the single-card Trainer's "
              f"{[round(v, 6) for v in r['single_losses']]}: losses within "
              f"{r['loss_rel_err']:.3e}, params within {r['param_rel_err']:.3e} relative (tol "
              f"{MULTI_GPU_NCCL_REL_TOL}), bit-identical: {r['bit_identical']}; launches per "
              f"step {sorted(set(map(tuple, r['per_step'])))} (expected ({n_layers}, "
              f"{n_layers})); samples/s over the steps after the first {r['rates']} against "
              f"{r['single_rates']} (the single card's run came first, in the same process); "
              f"the leg's process {t_nccl:.1f} s  [{card}]")
        if device.type == "cuda" and r["backend"] != "nccl":
            fail(f"multi_gpu leg 1 ran on {r['backend']}, not nccl")
        if (r["loss_rel_err"] > MULTI_GPU_NCCL_REL_TOL or r["param_rel_err"] > MULTI_GPU_NCCL_REL_TOL
                or {tuple(s) for s in r["per_step"]} != {(n_layers, n_layers)}):
            fail("multi_gpu leg 1: the NCCL multi-rank Trainer differs from the single-card one")
        launches = dict(r["counts"])
        a = nccl["nccl_accum"]
        k = a["k"]
        print(f"multi_gpu leg 1b, the gradient cache at k={k} in the {r['backend']} group of one "
              f"rank (batch {B}): loss {a['loss']:.6f} against the single-card k={k} cache's "
              f"{a['single_loss']:.6f}, every one of {a['tensors']} gradients and the loss bit for "
              f"bit: {a['bit_identical']}; launches {a['per_step']} (expected ({2 * k * n_layers}, "
              f"{k * n_layers})); {a['ms']:.1f} ms against {a['single_ms']:.1f} ms  [{card}]")
        if not a["bit_identical"] or tuple(a["per_step"]) != (2 * k * n_layers, k * n_layers):
            fail("multi_gpu leg 1b: the group's gradient cache differs from the single card's")
        for name, n in a["counts"].items():
            launches[name] = launches.get(name, 0) + n

        t0 = time.perf_counter()
        ranks = run_rank_group(2, {"legs": ["dp_step", "dp_trainer", "dp_simclr"],
                                   "device": device.type, "backend": "gloo", "gcfg": _per_rank(
                                       gcfg, 2), "simclr_gcfg": sgcfg,
                                   "simclr_batch": MULTI_GPU_SIMCLR_BATCH
                                   if device.type == "cuda" else sgcfg.model_config.batch_size,
                                   "train_rows": MULTI_GPU_TRAIN_ROWS,
                                   "eval_rows": MULTI_GPU_EVAL_ROWS},
                               os.path.join(work, "gloo"))
        t_gloo = time.perf_counter() - t0
    _report_gloo(card, ranks, n_layers, B, t_gloo)
    for o in ranks:
        for counts in (o["dp_trainer"]["counts"], o["dp_trainer"]["extract_counts"],
                       o["dp_simclr"]["counts"], o["dp_step"]["accum"]["counts"]):
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
    add_launches(entries, "multi_gpu", launches)
    sharded_gallery_leg(card, device)


def _per_rank(gcfg, world: int):
    """The recipe with its batch split over `world` ranks (batch_size is
    per rank)."""
    import copy

    gcfg = copy.deepcopy(gcfg)
    mc = gcfg.model_config
    if mc.batch_size % world:
        fail(f"batch {mc.batch_size} does not divide over {world} ranks")
    mc.batch_size //= world
    return gcfg


def _report_gloo(card: str, ranks: list, n_layers: int, B: int, seconds: float) -> None:
    main, other = ranks[0], ranks[1]
    s = main["dp_step"]
    print(f"multi_gpu leg 2, gloo W=2 on one card, batch {B // 2} a rank (global {B}), "
          f"identity augmentation: loss {s['loss']:.6f} against the single-card batch-{B} "
          f"step's {s['ref_loss']:.6f} (|d| {abs(s['loss'] - s['ref_loss']):.3e}, tol "
          f"{DP_LOSS_REL_TOL} x |loss|); gradient min cosine {s['min_cosine']:.6f} at "
          f"{s['worst']} over {s['tensors']} tensors (need >= {COSINE_MIN})")
    for r, o in enumerate(ranks):
        d = o["dp_step"]
        print(f"multi_gpu leg 2 rank {r}: one multi-rank gradient step {d['step_ms']:.1f} ms "
              f"(both ranks on one card), of which the gradient all-reduce "
              f"({d['grad_bytes'] / 1e9:.3f} GB fp32, CUDA tensors to gloo) "
              f"{d['all_reduce_ms']:.1f} ms (copied to the host and back by hand: "
              f"{d['all_reduce_host_ms']:.1f} ms); launches {tuple(d['per_step'])}; peak device "
              f"memory {d['peak_gib']:.2f} GiB  [{card}]")
        if tuple(d["per_step"]) != (n_layers, n_layers):
            fail(f"multi_gpu leg 2 rank {r}: the step launched {d['per_step']}")
    a = main["dp_step"]["accum"]
    k = a["k"]
    print(f"multi_gpu leg 2b, the gradient cache across 2 gloo ranks, k={k} microbatches of "
          f"{B // 2 // k} a rank: loss {a['loss']:.6f} against the single-card batch-{B} "
          f"monolithic step's {a['ref_loss']:.6f} (|d| {abs(a['loss'] - a['ref_loss']):.3e}, tol "
          f"{DP_LOSS_REL_TOL} x |loss|); gradient min cosine {a['min_cosine']:.6f} at "
          f"{a['worst']} over {a['tensors']} tensors (need >= {COSINE_MIN})")
    for r, o in enumerate(ranks):
        d = o["dp_step"]["accum"]
        print(f"multi_gpu leg 2b rank {r}: one k={k} step {d['step_ms']:.1f} ms (both ranks on one "
              f"card), launches {tuple(d['per_step'])} (expected ({2 * k * n_layers}, "
              f"{k * n_layers})), peak device memory {d['peak_gib']:.2f} GiB  [{card}]")
        if tuple(d["per_step"]) != (2 * k * n_layers, k * n_layers):
            fail(f"multi_gpu leg 2b rank {r}: the step launched {d['per_step']}")
    t0, t1 = main["dp_trainer"], other["dp_trainer"]
    print(f"multi_gpu leg 2, Trainer at W={t0['world_size']}: losses {t0['losses']} (rank 1 "
          f"{t1['losses']}), eval {t0['overall_acc']}; launches per step "
          f"{sorted(set(map(tuple, t0['per_step'])))} / {sorted(set(map(tuple, t1['per_step'])))};"
          f" samples/s (global) over the steps after the first {t0['rates']}; fit with its eval "
          f"{t0['fit_seconds']:.2f} s, peak {t0['fit_peak_gib']:.2f} / {t1['fit_peak_gib']:.2f} "
          f"GiB; rank 0 wrote {t0['written']}, rank 1 wrote {t1['written']}  [{card}]")
    if t0["losses"] != t1["losses"] or t0["overall_acc"] != t1["overall_acc"]:
        fail("multi_gpu leg 2: the ranks disagree on the losses or the eval")
    if t1["written"] or not {"last/params.npz", "best/params.npz"} <= set(t0["written"]):
        fail("multi_gpu leg 2: checkpoints were not written by rank 0 alone")
    print(f"multi_gpu leg 3, extract_split_multihost of {t0['extract_rows']} rows over 2 ranks: "
          f"min row cosine {t0['extract_min_cosine']:.6f} against extract_split (need >= "
          f"{MULTI_GPU_EXTRACT_COSINE}), labels and ids identical: {t0['extract_same_labels']}; "
          f"{t0['extract_seconds']:.2f} s  [{card}]")
    print(f"multi_gpu leg 4, resume_multihost: rank 0 at step {t0['resume_step']} (epoch "
          f"{t0['resume_epoch']}), rank 1 at step {t1['resume_step']} over its own stale last/ "
          f"of step 99: both hold rank 0's params.npz and opt_state.npz bit for bit "
          f"({t0['resume_params_same'] and t1['resume_params_same']}, "
          f"{t0['resume_opt_same'] and t1['resume_opt_same']}); {t1['resume_seconds']:.2f} s")
    m = main["dp_simclr"]
    print(f"multi_gpu leg 5, SimCLR W=2 x {m['batch']} images: loss {m['loss']:.6f} against the "
          f"mean of the single-card losses {[round(v, 6) for v in m['single_losses']]} (tol "
          f"{DP_LOSS_REL_TOL} x |loss|); gradients against their sum, min cosine "
          f"{m['min_cosine']:.6f} at {m['worst']} over {m['tensors']} tensors; step "
          f"{m['step_ms']:.1f} / {other['dp_simclr']['step_ms']:.1f} ms, peak "
          f"{m['peak_gib']:.2f} / {other['dp_simclr']['peak_gib']:.2f} GiB; launches "
          f"{m['counts']['flash_attention_qkv']} / {m['counts']['flash_attention_qkv_bwd']}"
          f"  [{card}]")
    for o in ranks:
        c = o["dp_simclr"]["counts"]
        if (c["flash_attention_qkv"], c["flash_attention_qkv_bwd"]) != (12, 12):
            fail(f"multi_gpu leg 5 rank {o['rank']}: launches {c}, expected (12, 12)")
    print(f"multi_gpu: gloo's all_gather and all_reduce take CUDA tensors: "
          f"{main['gloo_takes_cuda']}; the two ranks' process {seconds:.1f} s")
    if main["gloo_takes_cuda"] not in ("yes", "not asked (CPU run)"):
        fail("multi_gpu: gloo does not take the CUDA tensors the helpers hand it")


def sharded_gallery_leg(card: str, device) -> None:
    """Leg 6: KeySet over the card named twice on phase 12's gallery size,
    fp32 and int8 + re-rank against the unsharded KeySet, then the service
    `serve --shard-keys` builds answering an image + barcode /search."""
    import base64
    import threading
    import urllib.request

    import torch

    from clibd_tpu_torch.engine.serve import InferenceService, KeySet, make_server
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.ops.knn import ShardedKeys

    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = [device, device]
    key = "encoded_image_feature"
    labels = serve_labels(GALLERY_ROWS)
    rng = np.random.default_rng(21119)
    feats = unit_rows(rng, GALLERY_ROWS, 768)
    queries = feats[rng.integers(0, GALLERY_ROWS, 32)] + 0.02 * rng.standard_normal(
        (32, 768)).astype(np.float32)
    t0 = time.perf_counter()
    for dtype, tol in (("float32", 0.0), ("int8", RERANK_SCORE_TOL)):
        whole = KeySet.from_arrays({key: feats}, labels, max_k=GALLERY_K, dtype=dtype,
                                   device=device)
        sharded = KeySet.from_arrays({key: feats}, labels, max_k=GALLERY_K, dtype=dtype,
                                     device=device, mesh=mesh)
        if not isinstance(sharded.features[key], ShardedKeys):
            fail("multi_gpu leg 6: the KeySet over two devices is not sharded")
        got_s, got_i = sharded.search(queries, key, GALLERY_K)
        want_s, want_i = whole.search(queries, key, GALLERY_K)
        err = float(np.abs(got_s - want_s).max())
        print(f"multi_gpu leg 6, KeySet {dtype}{' + re-rank' if dtype == 'int8' else ''} over "
              f"{[str(d) for d in mesh]}, {GALLERY_ROWS} x 768, 32 queries, top-{GALLERY_K}: "
              f"indices identical {np.array_equal(got_i, want_i)}, scores {err:.2e} apart")
        if (dtype == "float32" and not np.array_equal(got_i, want_i)) or err > max(tol, 1e-6):
            fail(f"multi_gpu leg 6: the sharded {dtype} gallery differs from the unsharded one")
        del whole, sharded
    mc = recipe_config(EXPERIMENT, 1).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(mc.default_seed), device)
    svc = InferenceService(model, mc, keys_mesh=mesh, device=device, buckets=(1,), max_batch=1,
                           window_ms=1.0, image_size=mc.image.vit.image_size,
                           resize_to=round(mc.image.vit.image_size * 256 / 224))
    jpeg = serve_images(np.random.default_rng(5), 1)[0]
    barcode = "".join(np.random.default_rng(6).choice(list("ACGT"), 600))
    emb = svc.embed(image_bytes=jpeg, dna=barcode)
    planted = {"encoded_image_feature": feats.copy(), "encoded_dna_feature": feats[::-1].copy()}
    planted["encoded_image_feature"][7] = emb["image"]
    planted["encoded_dna_feature"][311] = emb["dna"]
    svc.keys = KeySet.from_arrays(planted, labels, max_k=GALLERY_K, device=device, mesh=mesh)
    server = make_server(svc, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/search", method="POST",
            data=json.dumps({"image_b64": base64.b64encode(jpeg).decode(), "dna": barcode,
                             "k": 5}).encode())
        with urllib.request.urlopen(req, timeout=600) as resp:
            answer = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    top = (answer["image"]["predictions"][0]["species"], answer["dna"]["predictions"][0]["species"])
    want_top = (labels["species"][7], labels["species"][311])
    print(f"multi_gpu leg 6, the service with keys_mesh {[str(d) for d in mesh]} (serve "
          f"--shard-keys): one image + barcode /search answered, top-1 {top} (planted "
          f"{want_top}), scores {answer['image']['scores'][0]:.6f}, "
          f"{answer['dna']['scores'][0]:.6f}; the leg {time.perf_counter() - t0:.1f} s  [{card}]")
    if top != want_top:
        fail("multi_gpu leg 6: the sharded service did not find the planted rows")
    del model, svc
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _probe_leg(card: str, device, label: str, fn, rows: int, masked_cols=None) -> None:
    """fn(device, n) → probabilities [L, n, H, N, N] of the first n rows on
    that device: on the card for `rows` rows (timed), on the CPU for
    PROBE_CPU_ROWS; the card's rows sum to 1, masked key columns
    (masked_cols [rows, N] bool) hold nothing, and the first rows and their
    rollout masks agree with the CPU's."""
    import torch

    from clibd_tpu_torch.analysis.attention_maps import attention_rollout

    fn(device, 1)  # warm-up
    sync(device)
    t0 = time.perf_counter()
    probs = fn(device, rows)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = fn(torch.device("cpu"), PROBE_CPU_ROWS)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(probs[:, :PROBE_CPU_ROWS] - ref).max())
    row_err = float(np.abs(probs.sum(-1, dtype=np.float64) - 1.0).max())
    masked = 0.0
    if masked_cols is not None:
        cols = np.broadcast_to(masked_cols[None, :, None, None, :], probs.shape)
        masked = float(probs[cols].max()) if cols.any() else 0.0
    card_masks = attention_rollout(probs[:, :PROBE_CPU_ROWS], layer_range=(1, -6))
    cpu_masks = attention_rollout(ref, layer_range=(1, -6))
    cos = min(float(c) for c in cosine_rows(torch.from_numpy(card_masks).double(),
                                            torch.from_numpy(cpu_masks).double()))
    L, B, H, N, _ = probs.shape
    print(f"cli_tail attention probe {label}: [{L}, {B}, {H}, {N}, {N}] fp32 "
          f"({probs.nbytes / 1e9:.2f} GB) on the card in {t_card * 1e3:.1f} ms (the copy to the "
          f"host included), {PROBE_CPU_ROWS} rows on the CPU in {t_cpu:.2f} s; card vs CPU max "
          f"|d| {err:.2e} (tol {PROBE_ATOL}), rows sum to 1 within {row_err:.1e}, masked key "
          f"columns max {masked:.1e} ({0 if masked_cols is None else int(masked_cols.sum())} "
          f"masked), rollout masks min cosine {cos:.6f}  [{card}]")
    if not (err <= PROBE_ATOL and row_err <= PROBE_ROW_SUM_TOL and masked < PROBE_MASKED_MAX
            and cos >= ROLLOUT_COSINE_MIN):
        fail(f"cli_tail: the {label} attention probe on the card disagrees with the CPU or is "
             "not a probability")


def cli_tail_phase(card: str, entries: dict, device) -> None:
    """Phase 21: `bench`'s body, the attention-rollout probes, the device
    searches of `failure_cases` and `retrieval_grid`, `doctor` and
    `configs`."""
    import contextlib
    import io
    import subprocess

    import torch

    from clibd_tpu_torch.analysis.attention_maps import (bert_attention_probs,
                                                         vit_attention_probs)
    from clibd_tpu_torch.analysis.failure_cases import find_failures
    from clibd_tpu_torch.config import load_config
    from clibd_tpu_torch.data.tokenizers import tokenize_dna_batch_overlapping
    from clibd_tpu_torch.engine.retrieval_grid import retrieval_records
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.models.bert import Bert
    from clibd_tpu_torch.models.clibd import clibd_apply
    from clibd_tpu_torch.ops.knn import prepare_keys
    from clibd_tpu_torch.tools import bench

    t_phase = time.perf_counter()
    # leg 1: bench
    cfg = bench.flagship_config()
    model = init_clibd_model(cfg, torch.Generator().manual_seed(0), device)
    n_layers = cfg.image.vit.num_layers + cfg.dna.bert.num_layers
    calls = bench.WARMUP + bench.PASSES * bench.ITERS
    reset_counts()
    record = bench.run_bench(cfg, bench.BATCH, device, model=model)
    counts = read_counts()
    others = {n: c for n, c in counts.items() if n != "flash_attention_qkv"}
    print(json.dumps(record))
    print(f"cli_tail bench: {record['value']} samples/s (image+DNA, bf16, batch {bench.BATCH}, "
          f"best of {bench.PASSES} passes of {bench.ITERS} calls); forward launches "
          f"{counts['flash_attention_qkv']} (expected {n_layers} x {calls} calls)  [{card}]")
    if counts["flash_attention_qkv"] != n_layers * calls or any(others.values()) \
            or record["card"] != (card if device.type == "cuda" else None) \
            or not record["value"] > 0:
        fail(f"cli_tail bench launched {counts} or printed {record}")
    add_launches(entries, "bench", counts)
    image, dna = bench.bench_inputs(cfg, bench.BATCH, device)
    with torch.inference_mode():
        out = clibd_apply(model, cfg, image_input=image, dna_input=dna)
    for m in ("image", "dna"):
        norms = out[m].norm(dim=-1)
        if out[m].shape != (bench.BATCH, cfg.output_dim) or not torch.isfinite(out[m]).all() \
                or float((norms - 1).abs().max()) > 1e-3:
            fail(f"cli_tail bench: {m} embeddings {tuple(out[m].shape)} not finite unit rows")

    def eight():
        with torch.inference_mode():
            o = clibd_apply(model, cfg, image_input=image[:8], dna_input=dna[:8])
        return [o["image"], o["dna"]]

    kernel_vs_plain_cosine("cli_tail bench bf16 image and DNA embeddings (8 samples)", eight,
                           rows=True)

    # leg 2: the attention-rollout probes, fp32 with TF32 off
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("cli_tail: TF32 is on for fp32 matmuls; the probes are held in fp32")
    rng = np.random.default_rng(2101)
    vit_cfg, bert_cfg = cfg.image.vit, cfg.dna.bert
    images = rng.standard_normal((PROBE_IMAGES, vit_cfg.image_size, vit_cfg.image_size, 3)
                                 ).astype(np.float32)
    _probe_leg(card, device, f"ViT-B/16 N={vit_cfg.seq_len}",
               lambda d, n: vit_attention_probs(model.image_encoder, images[:n], vit_cfg, d),
               PROBE_IMAGES)
    ids = rng.integers(0, bert_cfg.vocab_size, (PROBE_IMAGES, 133)).astype(np.int32)
    _probe_leg(card, device, "BarcodeBERT N=133",
               lambda d, n: bert_attention_probs(model.dna_encoder, ids[:n], None, bert_cfg, d),
               PROBE_IMAGES)
    del model, out, image, dna
    omc = load_config(experiment=OVERLAP).model_config
    overlap = Bert(omc.dna.bert, head_dim=omc.output_dim)
    overlap.reset_parameters(torch.Generator().manual_seed(omc.default_seed))
    overlap.to(device)
    barcodes = ["".join(rng.choice(list("ACGT"), int(n)))
                for n in rng.integers(400, omc.dna.max_bp + 1, PROBE_OVERLAP_ROWS)]
    o_ids, o_att = tokenize_dna_batch_overlapping(barcodes, k=omc.dna.kmer, stride=omc.dna.stride,
                                                  max_bp=omc.dna.max_bp)
    o_att = o_att[:, :o_ids.shape[1]]
    if o_ids.shape[1] != 657:
        fail(f"cli_tail: the overlap tokenizer gave N={o_ids.shape[1]}, expected 657")
    _probe_leg(card, device, "overlap BarcodeBERT N=657 (key mask)",
               lambda d, n: bert_attention_probs(overlap, o_ids[:n], o_att[:n], omc.dna.bert, d),
               PROBE_OVERLAP_ROWS, masked_cols=o_att == 0)
    del overlap
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # leg 3: the device searches over a gallery of BIOSCAN-1M's key count
    dim = cfg.output_dim
    species = [f"species_{i}" for i in rng.integers(0, 400, GALLERY_ROWS)]
    keys = {m: unit_rows(rng, GALLERY_ROWS, dim) for m in ("encoded_image_feature",
                                                            "encoded_dna_feature")}
    keys.update(label_list=[dict.fromkeys(("order", "family", "genus"), "x") | {"species": s}
                            for s in species],
                processed_id_list=[f"key_{i}" for i in range(GALLERY_ROWS)])
    planted = rng.integers(0, GALLERY_ROWS, SEARCH_QUERIES)
    noise = 0.8 * unit_rows(rng, SEARCH_QUERIES, dim)
    queries = {m: (keys[m][planted] + noise).astype(np.float32)
               for m in ("encoded_image_feature", "encoded_dna_feature")}
    q_species = [species[j] if i % 2 else f"species_{(int(j) + 1) % 400}"
                 for i, j in enumerate(planted)]
    queries.update(label_list=[dict.fromkeys(("order", "family", "genus"), "x") | {"species": s}
                               for s in q_species],
                   processed_id_list=[f"query_{i}" for i in range(SEARCH_QUERIES)])
    pairs = [("encoded_image_feature", "encoded_image_feature"),
             ("encoded_image_feature", "encoded_dna_feature"),
             ("encoded_dna_feature", "encoded_dna_feature")]
    cpu = torch.device("cpu")
    timed = {}
    for name, run in (
            ("find_failures", lambda d: find_failures(
                queries, keys, *pairs[0], max_cases=SEARCH_QUERIES, device=d)),
            ("find_failures (prepared keys)", lambda d: find_failures(
                queries, keys, *pairs[2], max_cases=SEARCH_QUERIES,
                keys_prepared=prepare_keys(keys[pairs[2][1]], device=d), device=d)),
            ("retrieval_records", lambda d: retrieval_records(
                queries, keys, pairs, num_queries=SEARCH_QUERIES, max_k=3, device=d)),
            ("retrieval_records only_failures", lambda d: retrieval_records(
                queries, keys, pairs, num_queries=SEARCH_QUERIES, max_k=3, only_failures=True,
                device=d))):
        run(device)
        sync(device)
        t0 = time.perf_counter()
        got = run(device)
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run(cpu)
        timed[name] = (t_card, time.perf_counter() - t0)
        n = len(got) if name.startswith("find") else len(got[1])
        if got != want or not n:
            fail(f"cli_tail: {name} on the card differs from the CPU's (or found nothing)")
        print(f"cli_tail {name}: {SEARCH_QUERIES} queries x {GALLERY_ROWS} x {dim} keys, "
              f"{n} {'cases' if name.startswith('find') else 'records'} identical on the card "
              f"and the CPU; card {t_card * 1e3:.1f} ms, CPU {timed[name][1] * 1e3:.1f} ms  "
              f"[{card}]")

    # leg 4: doctor and configs
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "clibd_tpu_torch.cli", "doctor", "--device",
                           device.type, "--timeout", "60", "-e", EXPERIMENT], cwd=repo,
                          capture_output=True, text=True, timeout=180)
    t_doctor = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout[proc.stdout.index("{"):])
    except ValueError:
        fail(f"cli_tail doctor printed no report (rc {proc.returncode}): "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    dev = report.get("device", {})
    print(f"cli_tail doctor --device {device.type} -e {EXPERIMENT}: rc {proc.returncode}, status "
          f"{report.get('status')}, device {dev.get('status')} {dev.get('device_name')} "
          f"x{dev.get('device_count')}, round trip {dev.get('device_roundtrip_s')} s, native "
          f"decoder {report.get('native_decoder', {}).get('status')}, experiment config "
          f"{report.get('experiment', {}).get('config')}; the process {t_doctor:.1f} s")
    if proc.returncode != 0 or dev.get("status") != "ok" or (
            device.type == "cuda" and dev.get("device_name") != torch.cuda.get_device_name(0)) \
            or report.get("experiment", {}).get("config") != "ok":
        fail(f"cli_tail doctor: {report}")
    from clibd_tpu_torch.cli import main as cli_main

    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        rc = cli_main(["configs"])
    names = listing.getvalue().split()
    yamls = sorted(p.relative_to(repo / "clibd_tpu/config/configs").as_posix()
                   for p in (repo / "clibd_tpu/config/configs").rglob("*.yaml"))
    print(f"cli_tail configs: rc {rc}, {len(names)} names, {len(yamls)} YAML files")
    if rc != 0 or names != yamls:
        fail("cli_tail configs does not list the bundled YAMLs")
    print(f"cli_tail: the phase took {time.perf_counter() - t_phase:.1f} s")


def tools_phase(card: str, entries: dict, device) -> None:
    """Phase 22: the ports of the repository's root tools/ harnesses as a
    user runs them, each leg's kernel launches counted under "tools"."""
    import torch

    from clibd_tpu_torch.tools import (bench_knn, bench_train, exp_bert, exp_block,
                                       exp_bwd_floor, exp_prof, rehearse)

    t_phase = time.perf_counter()
    total = {}
    fwd, bwd = "flash_attention_qkv", "flash_attention_qkv_bwd"

    def take(leg: str, counts: dict, want: tuple) -> None:
        got = (counts[fwd], counts[bwd])
        others = {n: c for n, c in counts.items() if n not in (fwd, bwd) and c}
        print(f"tools launches, {leg}: forward {got[0]}, backward {got[1]} (expected {want})")
        if got != want or others:
            fail(f"tools {leg}: launches {got} and {others}, expected {want} and no other kernel")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c

    # leg 1: bench_train at its two default cells, the other remat policies and k=4
    for batch, policy, accum in TOOLS_TRAIN_CELLS:
        cfg = bench_train.cell_config(batch, policy, accum)
        reset_counts()
        try:
            r = bench_train.bench(cfg, device, **TOOLS_TRAIN_TIMING)
        except torch.cuda.OutOfMemoryError as e:
            fail(f"tools bench_train batch {batch} policy {policy} accum {accum}: FAILED OOM "
                 f"{str(e)[:200]}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"tools {bench_train.format_row(r)} ({r['steps']} steps)  [{card}]")
        if not math.isfinite(r["loss"]):
            fail(f"tools bench_train batch {batch} policy {policy} accum {accum}: loss {r['loss']}")
        per_step = bench_train.attention_launches(cfg)
        take(f"bench_train {r['mode']} batch {batch} ({per_step} a step x {r['steps']} steps)",
             read_counts(), tuple(n * r["steps"] for n in per_step))

    # leg 2: the accuracy rehearsal
    epochs, batch = TOOLS_REHEARSE
    reset_counts()
    res = rehearse.run(epochs, batch, device)
    layers = bench_train.attention_layers(rehearse.rehearsal_config(epochs, batch).model_config)
    steps = epochs * res["steps_per_epoch"]
    eval_batches = 3 * n_batches(rehearse.N_PER_SPLIT, batch)
    evals = 2 + res["fit_evals"]
    print(f"tools rehearse: loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} over {epochs} "
          f"epochs ({res['seconds']:.1f} s), overall_acc {res['acc_before']:.4f} -> "
          f"{res['acc_after']:.4f}; decoder: {res['decoder']}  [{card}]")
    if not (res["losses"][-1] < res["losses"][0] and res["acc_after"] > res["acc_before"]):
        fail("tools rehearse: the rehearsal did not lower the loss and raise overall_acc")
    take(f"rehearse ({layers} layers x ({steps} steps + {evals} evals x {eval_batches} batches))",
         read_counts(), (layers * (steps + evals * eval_batches), layers * steps))

    # leg 3: the backward against its floor
    table = {r["tower"]: r for r in exp_bwd_floor.table()}
    if (round(table["vit"]["floor_ms"], 4), round(table["bert"]["floor_ms"], 4)) != (0.3161,
                                                                                     0.2134):
        fail(f"tools exp_bwd_floor: the floor table is not PERF.md's bound: {table}")
    reset_counts()
    rows = exp_bwd_floor.measure()
    entries[bwd]["tools_floor_rows"] = rows
    take("exp_bwd_floor measure (2 shapes x (1 check + 3 warm-up + 20 timed))", read_counts(),
         (0, 2 * 24))

    # leg 4: encoder timing per tower (both towers together is phase 21's bench)
    reset_counts()
    prof = exp_prof.run(("image", "dna"), device)
    calls = exp_prof.WARMUP + exp_prof.PASSES * exp_prof.ITERS
    pcfg = exp_prof.flagship_config()
    towers = pcfg.image.vit.num_layers + pcfg.dna.bert.num_layers
    print(f"tools exp_prof: {json.dumps(prof)}  [{card}]")
    take(f"exp_prof (image, dna: {towers} layers x {calls} calls)", read_counts(),
         (towers * calls, 0))

    # leg 5: the block and BERT ablations (plain PyTorch: no kernel)
    reset_counts()
    ablations = {}
    for name, tool in (("exp_block", exp_block), ("exp_bert", exp_bert)):
        ablations[name] = tool.main(["--device", device.type])
        for r in ablations[name]:
            if r["max_abs_err_vs_base"] is not None and \
                    r["max_abs_err_vs_base"] > ABLATION_REL_TOL * r["base_max_abs"]:
                fail(f"tools {name} {r['variant']}: {r['max_abs_err_vs_base']} off its base "
                     f"(max {r['base_max_abs']})")
    print(f"tools ablations (ms): " + ", ".join(
        f"{n} {r['variant']} {r['ms']}" for n, rs in ablations.items() for r in rs) + f"  [{card}]")
    take("exp_block and exp_bert", read_counts(), (0, 0))

    # leg 6: the eval grid's kNN at BIOSCAN-1M's shapes, a subset again on the CPU
    seen_n, unseen_n, keys_n = TOOLS_KNN
    keys, seen, unseen = bench_knn.synth_grid(seen_n, unseen_n, keys_n)
    dev = bench_knn.device_leg(keys, seen, unseen, device)
    head, t_cpu = bench_knn.subset_on_cpu(keys, seen, unseen, TOOLS_KNN_CPU_ROWS)
    check = bench_knn.near_tie_check(keys, seen, unseen, dev, head, TOOLS_KNN_CPU_ROWS,
                                     KNN_TIE_TOL)
    acc_dict, t_full = bench_knn.full_leg(keys, seen, unseen, device)
    print(f"tools bench_knn: {dev['searches']} searches of {seen_n} + {unseen_n} queries x "
          f"{keys_n} keys (x3 for all_key_features) x 768: keys {dev['prep_s']:.3f} s, device "
          f"leg {dev['search_s']:.3f} s ({dev['scores'] / 1e9:.2f} G scores), the first "
          f"{TOOLS_KNN_CPU_ROWS} rows of each on the CPU {t_cpu:.3f} s: top-5 rows differing "
          f"{check['rows_differing']} (each a near tie within {KNN_TIE_TOL}: {check['ok']}), "
          f"scores max |d| {check['max_score_diff']:.2e}; inference_and_eval {t_full:.3f} s, "
          f"{sum(len(v) for v in acc_dict.values())} grid cells  [{card}]")
    if not check["ok"] or not acc_dict:
        fail("tools bench_knn: the card's top-5 disagree with the CPU's beyond near ties")
    del keys, seen, unseen, dev, head
    add_launches(entries, "tools", total)
    print(f"tools: the phase {time.perf_counter() - t_phase:.1f} s")


def load_config_feature():
    """The flagship with `image.input_type: feature` over FEATURE_DIM-wide
    image features (the MLP encoder of `models/mlp.py`)."""
    from clibd_tpu_torch.config import load_config

    mc = load_config(experiment=EXPERIMENT, overrides=[
        "model_config.image.input_type=feature", "model_config.image.model=mlp",
        f"model_config.image.input_dim={FEATURE_DIM}"]).model_config
    if mc.output_dim != 768 or mc.dna.input_type != "sequence":
        fail("the feature-input flagship is not the 768-d recipe with a DNA sequence tower")
    return mc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import clibd_tpu_torch  # noqa: F401  (fails where the repo is absent)

    from clibd_tpu_torch.utils.profiling import card_line

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    from clibd_tpu_torch.ops.cuda_build import BUILD_INFO, build_libraries

    t0 = time.perf_counter()
    build_libraries(["flash_attention_qkv", "flash_attention_qkv_bwd",
                     "flash_attention_qkv_outproj", "fused_mlp", "scale_copy", "tiled_gemm",
                     "attention_bhnd", "layernorm", *EXP_FLASH_KERNELS])
    print(f"build: all eleven kernel sources in parallel, {time.perf_counter() - t0:.2f} s wall")
    for name, info in BUILD_INFO.items():
        print(f"build {name}.cu: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "C75")):
                print("  ptxas:", line.strip())
    check_wgmma_ptxas(BUILD_INFO)

    fwd = forward_kernel_phase(card)
    bwd = backward_kernel_phase(card)
    entries = {e["name"]: e for e in (fwd, bwd, *layernorm_kernel_phase(card))}
    from clibd_tpu_torch.models.layers import kernel_knobs

    cuda = torch.device("cuda")
    with kernel_knobs(False, "xla"):
        for label, path, experiment, epochs, train_rows in (
                ("flagship", "flagship_eval_and_train", EXPERIMENT, 2, TRAIN_ROWS),
                ("overlap", "overlap_eval_and_train", OVERLAP, 1, OVERLAP_TRAIN_ROWS)):
            gcfg = recipe_config(experiment, epochs)
            counts = eval_slice_phase(card, label, gcfg.model_config, cuda, SPLIT_ROWS)
            fit = train_slice_phase(card, label, gcfg, cuda, train_rows)
            add_launches(entries, path, {k: counts[k] + fit[k] for k in counts})
    knn_ties_phase(card)
    outproj = outproj_kernel_phase(card)
    mlp = fused_mlp_kernel_phase(card)
    entries.update({e["name"]: e for e in (outproj, mlp)})
    bioclip_eval_phase(card, entries, torch.device("cuda"), SPLIT_ROWS)
    bioclip_train_phase(card, entries, torch.device("cuda"))
    probes = probe_kernels_phase(card)
    entries.update(probes)
    probes_path_phase(card, entries)
    entries.update(exp_flash_kernels_phase(card))
    flash_experiments_path_phase(card, entries)
    serve_row1_phase(card, entries["flash_attention_qkv"])
    with kernel_knobs(False, "xla"):
        serve_phase(card, entries, cuda)
        import_phase(card, entries, cuda, SPLIT_ROWS)
        accum_train_phase(card, entries, cuda)
        simclr_phase(card, entries, cuda, SPLIT_ROWS)
        finetune_phase(card, entries, cuda)
        bzsl_phase(card, entries, cuda)
        method_nn_phase(card, entries, cuda)
        zeroshot_phase(card, entries, cuda)
        multi_gpu_phase(card, entries, cuda)
        cli_tail_phase(card, entries, cuda)
        tools_phase(card, entries, cuda)
    if "jax" in sys.modules or any(m == "clibd_tpu" or m.startswith("clibd_tpu.")
                                   for m in sys.modules):
        fail("jax or the JAX package was imported: the port must run without them")

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-gpu-rank"]:
        sys.exit(multi_gpu_rank_main(*sys.argv[2:4]))
    sys.exit(main())
