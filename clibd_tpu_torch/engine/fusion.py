# The port of clibd_tpu/engine/fusion.py: every function but `train_linear_probe` is a copy
# (numpy over the port's `ops/knn.py` and `utils/metrics.py`); the probe is fp32 torch.  Keep
# the two in step.
"""Seen/unseen fusion baselines (reference scripts/method_nn.py 374 LoC and
scripts/method_linear.py 574 LoC): route each query's k-th prediction to the
seen-key search result when its confidence/similarity exceeds a threshold,
otherwise to the unseen-key search result; the threshold is grid-searched to
maximize the harmonic mean of seen/unseen species top-1 micro-accuracy.

method_nn: side A = image-query-vs-seen-keys similarity;
method_linear: side A = trained linear classifier confidence.
Both reduce to the same fusion + threshold-search core implemented here,
vectorized over [N, k] prediction/score matrices.

The kNN searches and the linear probe run on `device`, the card unless the
caller asks for the CPU; the probe's `x @ w` is an fp32 product with TF32
off, as every fp32 product of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.metrics import LEVELS, top_k_macro_accuracy, top_k_micro_accuracy


def fuse_predictions(
    preds_seen: Dict[str, np.ndarray],
    scores_seen: np.ndarray,
    preds_unseen: Dict[str, np.ndarray],
    threshold: float,
) -> Dict[str, np.ndarray]:
    """Per (query, k): pick the seen-key prediction when score > threshold
    (reference decide_prediction_with_threshold, method_nn.py:66-93).

    The two sides can carry different column counts (knn_search clamps k to
    the gallery size; classifier confidence clamps to num_classes) — fuse
    over the common prefix instead of letting np.where broadcast-crash."""
    kmin = min(scores_seen.shape[1],
               *(preds_unseen[level].shape[1] for level in LEVELS),
               *(preds_seen[level].shape[1] for level in LEVELS))
    take_seen = scores_seen[:, :kmin] > threshold  # [N, kmin]
    return {
        level: np.where(take_seen, preds_seen[level][:, :kmin],
                        preds_unseen[level][:, :kmin]) for level in LEVELS
    }


def harmonic_mean_list(values: Sequence[float]) -> float:
    """Reference harmonic_mean (method_nn.py:128-135): 0 if any item is 0."""
    s = 0.0
    for v in values:
        if v == 0:
            return 0.0
        s += 1.0 / v
    return len(values) / s


def search_threshold(
    split_data: List[dict],
    k_list: Sequence[int] = (1, 3, 5),
    num_intervals: int = 1000,
) -> float:
    """Grid-search thresholds in [0,1] maximizing the harmonic mean of
    per-split species top-1 micro accuracy (method_nn.py:138-164).

    split_data items: {'preds_seen': {level: [N,k]}, 'scores_seen': [N,k],
    'preds_unseen': {level: [N,k]}, 'gt': {level: [N]}}."""
    thresholds = np.linspace(0, 1, num_intervals)
    # the sweep only consumes species top-1 accuracy, which is a pure
    # function of (top-1 score, top-1 seen-hit, top-1 unseen-hit) — sweep
    # all thresholds as one vectorized comparison instead of re-fusing four
    # [N,k] object arrays and the full metric grid 1000× (pure-python
    # minutes at 40k queries, same result bit-for-bit)
    k0 = k_list[0]
    if k0 == 1:  # the shipped configs; k0>1 needs per-column mixing (below)
        per_split_acc = []
        for split in split_data:
            gt = np.asarray(split["gt"]["species"])
            hit_seen = (np.asarray(split["preds_seen"]["species"])[:, 0] == gt).astype(np.float64)
            hit_unseen = (np.asarray(split["preds_unseen"]["species"])[:, 0] == gt).astype(np.float64)
            s0 = np.asarray(split["scores_seen"])[:, 0]
            take = s0[None, :] > thresholds[:, None]  # [T, N]
            acc = np.where(take, hit_seen[None, :], hit_unseen[None, :]).mean(axis=1)
            per_split_acc.append(acc)
        scores = np.array([harmonic_mean_list([a[i] for a in per_split_acc])
                           for i in range(len(thresholds))])
        best_idx = int(np.argmax(scores))  # first max — matches `>` keep-first
        return float(thresholds[best_idx])
    best_threshold = thresholds[0]
    max_score = float("-inf")
    for threshold in thresholds:
        accs = []
        for split in split_data:
            fused = fuse_predictions(
                split["preds_seen"], split["scores_seen"], split["preds_unseen"], threshold
            )
            micro = top_k_micro_accuracy(fused, split["gt"], k_list=k_list)
            accs.append(micro[k_list[0]]["species"])
        score = harmonic_mean_list(accs)
        if score > max_score:
            max_score = score
            best_threshold = float(threshold)
    return best_threshold


def routing_accuracy(
    fused_species: np.ndarray,
    side_species: Sequence[str],
    k_list: Sequence[int] = (1, 3, 5),
) -> Dict[int, float]:
    """Fraction of queries whose fused top-k species contain at least one
    member of `side_species` — i.e. were (at least partly) routed to the
    correct side, since the seen/unseen species pools are disjoint (reference
    check_for_acc_about_correct_predict_seen_or_unseen,
    scripts/BZSL/method_linear_on_INSECT.py:412-425)."""
    member = np.isin(np.asarray(fused_species, dtype=object), list(side_species))
    return {k: float(member[:, :k].any(axis=1).mean()) for k in k_list
            if k <= member.shape[1]}


def evaluate_with_threshold(
    split_data: List[dict],
    threshold: float,
    k_list: Sequence[int] = (1, 3, 5),
) -> List[dict]:
    """→ per split {'micro_acc', 'macro_acc', 'per_class_acc', 'best_threshold'}
    (+ 'routing_acc' when the split carries its correct side's species pool
    as 'side_species')."""
    out = []
    for split in split_data:
        fused = fuse_predictions(
            split["preds_seen"], split["scores_seen"], split["preds_unseen"], threshold
        )
        micro = top_k_micro_accuracy(fused, split["gt"], k_list=k_list)
        macro, per_class = top_k_macro_accuracy(fused, split["gt"], k_list=k_list)
        result = {
            "micro_acc": micro,
            "macro_acc": macro,
            "per_class_acc": per_class,
            "best_threshold": threshold,
        }
        if "side_species" in split:
            result["routing_acc"] = routing_accuracy(
                fused["species"], split["side_species"], k_list=k_list)
        out.append(result)
    return out


def method_nn(
    seen_query_feats: Dict[str, np.ndarray],
    unseen_query_feats: Dict[str, np.ndarray],
    seen_keys_feats: np.ndarray,
    seen_keys_labels: Dict[str, np.ndarray],
    unseen_keys_feats: np.ndarray,
    unseen_keys_labels: Dict[str, np.ndarray],
    seen_gt: Dict[str, np.ndarray],
    unseen_gt: Dict[str, np.ndarray],
    max_k: int = 5,
    threshold: Optional[float] = None,
    k_list: Sequence[int] = (1, 3, 5),
    side_b_query: str = "image",
    device: torch.device | str = "cuda",
) -> dict:
    """Full method_nn pipeline: image-query vs seen IMAGE keys (side A,
    similarity = confidence) + image-query vs unseen DNA keys (side B,
    cross-modal — the shared embedding space is the point; reference
    method_1_inference_and_eval_for_seen_and_unseen runs BOTH sides on the
    image query, method_nn.py:177-203 with key_type='image' then 'dna').
    side_b_query='dna' is this framework's extension for when query
    barcodes are available.

    *_query_feats: {'image': [N,D], 'dna': [N,D]}."""
    from ..ops.knn import knn_search, prepare_keys
    from ..utils.metrics import predictions_to_level_arrays

    # each key matrix serves both query splits — upload + normalize once
    seen_keys_prep = prepare_keys(seen_keys_feats, device=device)
    unseen_keys_prep = prepare_keys(unseen_keys_feats, device=device)

    def side(query, keys, key_labels):
        sims, idx = knn_search(query, keys, k=max_k, keys_normalized=True, device=device)
        return predictions_to_level_arrays(idx, key_labels), sims

    side_pools = (set(seen_keys_labels["species"]), set(unseen_keys_labels["species"]))
    split_data = []
    for (qf, gt), pool in zip(((seen_query_feats, seen_gt), (unseen_query_feats, unseen_gt)), side_pools):
        preds_seen, scores_seen = side(qf["image"], seen_keys_prep, seen_keys_labels)
        preds_unseen, _ = side(qf[side_b_query], unseen_keys_prep, unseen_keys_labels)
        split_data.append(
            {"preds_seen": preds_seen, "scores_seen": scores_seen,
             "preds_unseen": preds_unseen, "gt": gt, "side_species": pool}
        )

    if threshold is None:
        threshold = search_threshold(split_data, k_list=k_list)
    seen_out, unseen_out = evaluate_with_threshold(split_data, threshold, k_list=k_list)
    return {"seen": seen_out, "unseen": unseen_out, "best_threshold": threshold}


# ---------------------------------------------------------------------------
# method_linear: side A = linear classifier over image features, confidence =
# softmax probability of the top-k classes (reference scripts/method_linear.py)
# ---------------------------------------------------------------------------


def init_linear_probe(d: int, num_classes: int, seed: int = 0):
    """The probe's initial (w [D, C], b [C]), fp32 on the CPU: w =
    0.01 * N(0, 1) from a `torch.Generator` seeded with `seed` (the numbers
    differ from jax.random's for the same seed), b zero."""
    g = torch.Generator().manual_seed(seed)
    return 0.01 * torch.randn(d, num_classes, generator=g), torch.zeros(num_classes)


def fit_linear_probe(
    features: np.ndarray,
    class_ids: np.ndarray,
    w0,
    b0,
    steps: int = 500,
    lr: float = 1e-2,
    weight_decay: float = 1e-4,
    device: torch.device | str = "cuda",
    losses: Optional[list] = None,
):
    """Full-batch multinomial logistic regression from (w0, b0), fp32 on
    `device`: `steps` AdamW updates (optax.adamw's betas and eps; the decay
    set explicitly, since torch's default is 1e-2) of the mean NLL of
    log_softmax(x @ w + b); `losses`, when given, receives each step's loss.
    → (w [D, C], b [C]) numpy."""
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(device)
    y = torch.from_numpy(np.asarray(class_ids, np.int64)).to(device)
    w = torch.tensor(np.asarray(w0, np.float32), device=device, requires_grad=True)
    b = torch.tensor(np.asarray(b0, np.float32), device=device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    rows = torch.arange(x.shape[0], device=device)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logp = torch.log_softmax(x @ w + b, dim=-1)
        loss = -logp[rows, y].mean()
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(float(loss.detach()))
    return w.detach().cpu().numpy(), b.detach().cpu().numpy()


def train_linear_probe(
    features: np.ndarray,
    class_ids: np.ndarray,
    num_classes: int,
    steps: int = 500,
    lr: float = 1e-2,
    weight_decay: float = 1e-4,
    seed: int = 0,
    device: torch.device | str = "cuda",
    losses: Optional[list] = None,
):
    """Multinomial logistic regression on (frozen) features with AdamW.
    → (w [D, C], b [C])."""
    w0, b0 = init_linear_probe(features.shape[1], num_classes, seed)
    return fit_linear_probe(features, class_ids, w0, b0, steps=steps, lr=lr,
                            weight_decay=weight_decay, device=device, losses=losses)


def predictions_from_logits(
    logits: np.ndarray,
    class_labels_by_level: Dict[str, np.ndarray],
    max_k: int = 5,
):
    """→ (preds {level: [N, k]}, confidences [N, k]) — softmax probability of
    each of the top-k classes, the method_linear confidence signal."""
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    order = np.argsort(-probs, axis=1)[:, :max_k]
    conf = np.take_along_axis(probs, order, axis=1)
    preds = {level: np.asarray(labels, dtype=object)[order] for level, labels in class_labels_by_level.items()}
    return preds, conf


def classifier_predictions(
    features: np.ndarray,
    w: np.ndarray,
    b: np.ndarray,
    class_labels_by_level: Dict[str, np.ndarray],
    max_k: int = 5,
):
    """Linear-probe variant of predictions_from_logits."""
    return predictions_from_logits(features @ w + b, class_labels_by_level, max_k)


def class_labels_by_level_from_map(
    classes: Sequence[str], species_to_levels: Dict[str, dict]
) -> Dict[str, np.ndarray]:
    """Per-level label array for an ordered class list (classifier column i →
    its taxon labels)."""
    return {
        level: np.asarray([species_to_levels[s][level] for s in classes], dtype=object)
        for level in LEVELS
    }


def method_from_classifier(
    classifier_side_a: Sequence[tuple],
    seen_query_feats: Dict[str, np.ndarray],
    unseen_query_feats: Dict[str, np.ndarray],
    unseen_keys_feats: np.ndarray,
    unseen_keys_labels: Dict[str, np.ndarray],
    seen_gt: Dict[str, np.ndarray],
    unseen_gt: Dict[str, np.ndarray],
    seen_species_pool,
    max_k: int = 5,
    threshold: Optional[float] = None,
    k_list: Sequence[int] = (1, 3, 5),
    side_b_query: str = "image",
    device: torch.device | str = "cuda",
) -> dict:
    """Fusion core shared by the frozen-feature probe and the fine-tuned
    classifier: side A comes in as precomputed per-split (preds, confidence)
    pairs; side B is the query-vs-unseen-DNA-keys search."""
    from ..ops.knn import knn_search
    from ..utils.metrics import predictions_to_level_arrays

    side_pools = (set(seen_species_pool), set(unseen_keys_labels["species"]))
    split_data = []
    for (preds_seen, conf), qf, gt, pool in zip(
        classifier_side_a,
        (seen_query_feats, unseen_query_feats),
        (seen_gt, unseen_gt),
        side_pools,
    ):
        _, idx = knn_search(qf[side_b_query], unseen_keys_feats, k=max_k, device=device)
        preds_unseen = predictions_to_level_arrays(idx, unseen_keys_labels)
        split_data.append(
            {"preds_seen": preds_seen, "scores_seen": conf,
             "preds_unseen": preds_unseen, "gt": gt, "side_species": pool}
        )

    if threshold is None:
        threshold = search_threshold(split_data, k_list=k_list)
    seen_out, unseen_out = evaluate_with_threshold(split_data, threshold, k_list=k_list)
    return {"seen": seen_out, "unseen": unseen_out, "best_threshold": threshold}


def fit_frozen_probe(
    train_features: np.ndarray,
    train_species: np.ndarray,
    probe_steps: int = 500,
    device: torch.device | str = "cuda",
    losses: Optional[list] = None,
) -> tuple:
    """Fit method_linear's frozen-feature probe once → (w, b, sorted classes)."""
    classes = sorted(set(train_species))
    class_index = {s: i for i, s in enumerate(classes)}
    y = np.asarray([class_index[s] for s in train_species])
    w, b = train_linear_probe(train_features, y, len(classes), steps=probe_steps, device=device,
                              losses=losses)
    return w, b, classes


def method_linear(
    train_features: np.ndarray,
    train_species: np.ndarray,
    seen_query_feats: Dict[str, np.ndarray],
    unseen_query_feats: Dict[str, np.ndarray],
    unseen_keys_feats: np.ndarray,
    unseen_keys_labels: Dict[str, np.ndarray],
    seen_gt: Dict[str, np.ndarray],
    unseen_gt: Dict[str, np.ndarray],
    species_to_levels: Dict[str, dict],
    max_k: int = 5,
    threshold: Optional[float] = None,
    k_list: Sequence[int] = (1, 3, 5),
    probe_steps: int = 500,
    side_b_query: str = "image",
    trained_probe: Optional[tuple] = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Full method_linear: linear classifier over seen species (trained on
    image features of the training/key set) routes confident queries; the
    rest fall back to image-query search against unseen DNA keys
    (cross-modal, like method_nn — reference method_linear.py:157-163 feeds
    *_query_image_feature into make_prediction on both sides).
    side_b_query='dna' switches side B to DNA queries.

    The reference fine-tunes the WHOLE image encoder + a new head
    (method_linear.py:458-490); that variant is `cli method-nn --linear
    --probe full`, which trains via engine/finetune and feeds the resulting
    (preds, confidence) into method_from_classifier. This function is the
    cheap frozen-feature probe.

    `trained_probe` short-circuits the probe fit with a precomputed
    (w, b, classes) triple — the threshold-search pass and the eval pass see
    identical training inputs, so callers evaluating two splits should fit
    once via fit_frozen_probe() and pass the result to both calls."""
    if trained_probe is not None:
        w, b, classes = trained_probe
    else:
        w, b, classes = fit_frozen_probe(train_features, train_species,
                                         probe_steps=probe_steps, device=device)

    class_labels_by_level = class_labels_by_level_from_map(classes, species_to_levels)
    side_a = [
        classifier_predictions(qf["image"], w, b, class_labels_by_level, max_k)
        for qf in (seen_query_feats, unseen_query_feats)
    ]
    return method_from_classifier(
        side_a, seen_query_feats, unseen_query_feats,
        unseen_keys_feats, unseen_keys_labels, seen_gt, unseen_gt,
        classes, max_k=max_k, threshold=threshold, k_list=k_list,
        side_b_query=side_b_query, device=device,
    )
