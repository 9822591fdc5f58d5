"""Tri-modal multi-positive InfoNCE and SimCLR's NT-Xent: the port of
`clibd_tpu/ops/loss.py` (`label_equality_matrix`, `soft_target_cross_entropy`,
`_pair_list`, `clip_loss`, `:43-102`, `sharded_clip_loss`, `:105-151`, and
`simclr_info_nce_loss`, `simclr_loss`, `:154-190`; reference
bioscanclip/model/loss_func.py:25-201, util/simclr.py:64-92).

- The target is the label-equality matrix M[i, j] = (l_i == l_j):
  multi-positive soft targets, not row-normalised (torch CrossEntropyLoss
  with probability targets, mean_i(-sum_j M_ij log_softmax(sim_i)_j)).
- Every ordered pair (a, b) of present modalities adds CE(s a.b^T, M) and
  CE(s b.a^T, M); the loss is the mean over all terms.
- `bind_to` keeps only pairs touching one anchor modality and
  `no_image_text_loss` drops image<->text, with the reference's
  filtered-index quirk kept as it is (see `_pair_list`).
- Features are re-normalised inside the loss, and the similarity matmuls run
  in fp32 with TF32 off (set at import by the package), the counterpart of
  `Precision.HIGHEST`.
- `sharded_clip_loss` is the loss of one rank of a process group: its
  features are the rank's rows, and the global batch is gathered with
  gradients (`parallel.all_gather_with_grad`, the reference's
  gather_with_grad, loss_func.py:73-106).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config.schema import LossConfig
from ..models.clibd import l2_normalize
from ..parallel.mesh import all_gather_tensor, all_gather_with_grad, all_reduce_mean

MODALITY_ORDER = ("image", "dna", "language")
_BIND_IDX = {"image": 0, "dna": 1, "text": 2, "language": 2}


def label_equality_matrix(labels_a: torch.Tensor,
                          labels_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if labels_b is None:
        labels_b = labels_a
    return (labels_a[:, None] == labels_b[None, :]).float()


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch nn.CrossEntropyLoss(probability targets, reduction='mean')."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def _pair_list(present: list, cfg: LossConfig) -> list:
    """Ordered modality pairs per the reference's loop (loss_func.py:176-199).

    `present` is the list of modality names with features, in MODALITY_ORDER.
    Indices for bind_to / no_image_text_loss follow the reference exactly,
    quirk included: it compares fixed indices (image=0, dna=1, text=2)
    against positions in the *filtered* feature list, so with a modality
    absent the positions shift (dna+text only: bind_to='text' matches
    nothing, and the loss divides by zero, as the reference does).
    """
    bind_idx = _BIND_IDX.get(cfg.bind_to) if cfg.bind_to else None
    pairs = []
    for ia, a in enumerate(present):
        for ib, b in enumerate(present):
            if ia == ib:
                continue
            if bind_idx is not None and ia != bind_idx and ib != bind_idx:
                continue
            if cfg.no_image_text_loss and {ia, ib} == {0, 2}:
                continue
            pairs.append((a, b))
    return pairs


def clip_loss(features: Dict[str, Optional[torch.Tensor]], labels: torch.Tensor,
              logit_scale, cfg: LossConfig) -> torch.Tensor:
    """Batch loss.  features: {'image', 'dna', 'language'} → [B, D] or None;
    logit_scale: a scalar tensor (exp'd) or a float."""
    present = [m for m in MODALITY_ORDER if features.get(m) is not None]
    if len(present) < 2:
        raise ValueError("Too less element for calculating the contrastive loss.")
    target = label_equality_matrix(labels)
    normed = {m: l2_normalize(features[m].float()) for m in present}
    terms = []
    for a, b in _pair_list(present, cfg):
        sim_ab = logit_scale * torch.matmul(normed[a], normed[b].T)
        terms.append(soft_target_cross_entropy(sim_ab, target))
        terms.append(soft_target_cross_entropy(sim_ab.T, target))
    return sum(terms) / len(terms)


def sharded_clip_loss(features: Dict[str, Optional[torch.Tensor]], labels: torch.Tensor,
                      logit_scale, cfg: LossConfig, group=None) -> torch.Tensor:
    """`clip_loss` of the global batch from one rank: features and labels
    are this rank's rows, and every rank gets the same loss.

    - cfg.local_loss: this rank's rows against the gathered columns, both
      directions; the value is the mean over ranks (`pmean`), the gradient
      that of this rank's term, so that the ranks' gradients average to
      the gradient of the mean;
    - otherwise: `clip_loss` of the gathered batch, the same on every rank.

    The gathered features carry gradients: a rank's features get the sum
    over ranks of their rows' gradients, W times dL/dx (see
    `all_gather_with_grad`), which `all_reduce_grads(op="mean")` of the
    parameters' gradients takes back out."""
    present = [m for m in MODALITY_ORDER if features.get(m) is not None]
    if len(present) < 2:
        raise ValueError("Too less element for calculating the contrastive loss.")
    all_labels = all_gather_tensor(labels, group)
    local_normed = {m: l2_normalize(features[m].float()) for m in present}
    gathered = {m: all_gather_with_grad(local_normed[m], group) for m in present}

    if cfg.local_loss:
        target_rows = label_equality_matrix(labels, all_labels)
        terms = []
        for a, b in _pair_list(present, cfg):
            sim_ab = logit_scale * torch.matmul(local_normed[a], gathered[b].T)
            sim_ba = logit_scale * torch.matmul(local_normed[b], gathered[a].T)
            terms.append(soft_target_cross_entropy(sim_ab, target_rows))
            terms.append(soft_target_cross_entropy(sim_ba, target_rows))
        local = sum(terms) / len(terms)
        # the value of the mean, the gradient of this rank's term
        return local - local.detach() + all_reduce_mean(local, group)

    target = label_equality_matrix(all_labels)
    terms = []
    for a, b in _pair_list(present, cfg):
        sim_ab = logit_scale * torch.matmul(gathered[a], gathered[b].T)
        terms.append(soft_target_cross_entropy(sim_ab, target))
        terms.append(soft_target_cross_entropy(sim_ab.T, target))
    return sum(terms) / len(terms)


def simclr_info_nce_loss(features: torch.Tensor, temperature: float = 0.07) -> tuple:
    """SimCLR InfoNCE (reference util/simclr.py:64-92): features [2B, D] are
    two augmented views stacked [view1 (B); view2 (B)], the positives the
    (i, i+B) pairs, self-similarities left out → (logits [2B, 2B-1], labels
    [2B]), label 0 the positive's column: CE(logits, labels) is the loss."""
    n = features.shape[0]
    b = n // 2
    f = l2_normalize(features.float())
    sim = f @ f.T
    group = torch.arange(n, device=features.device) % b
    same = group[:, None] == group[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=features.device)
    positives = sim[same & ~eye].reshape(n, 1)
    negatives = sim[~same].reshape(n, -1)
    logits = torch.cat([positives, negatives], dim=1) / temperature
    return logits, torch.zeros(n, dtype=torch.int32, device=features.device)


def simclr_loss(features: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent equal to CE(info_nce_loss logits, 0): with the diagonal
    masked at finfo.min, loss_i = logsumexp_{j != i}(s_ij / t) - s_{i,partner} / t,
    in fp32."""
    n = features.shape[0]
    b = n // 2
    f = l2_normalize(features.float())
    sim = (f @ f.T) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=features.device)
    sim = sim.masked_fill(eye, torch.finfo(torch.float32).min)
    rows = torch.arange(n, device=features.device)
    pos = sim[rows, (rows + b) % n]
    return (torch.logsumexp(sim, dim=-1) - pos).mean()
