"""The operation and byte counts against hand numbers."""

import numpy as np
import pytest

from benchmark.core import counts
from benchmark.core.cell import BENCH, load_json
from benchmark.core.inputs import make_pool
from benchmark.core.peaks import peaks_for

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def widths(config):
    return load_json(BENCH / "configs" / f"{config}.json")["widths"]


def image_batch(rows):
    return {"image": np.zeros((rows, 224, 224, 3), np.uint8)}


def test_vit_b16_forward_is_35_1_gflop_a_sample():
    c = counts.batch_counts(widths("flagship"), image_batch(2), "embed", False, None)
    assert c["model"]["flops"] / 2 / 1e9 == pytest.approx(35.13, abs=0.01)


def test_attention_bounds_are_the_kernel_tables():
    """ViT N=197, B=500: the forward bound 0.1807 ms and the backward's
    0.3161 ms (bytes), a layer."""
    c = counts.batch_counts(widths("flagship"), image_batch(500), "train", True, H100)
    assert c["attn_fwd"]["bound_s"] / 12 * 1e3 == pytest.approx(0.1807, abs=1e-4)
    assert c["attn_bwd"]["bound_s"] / 12 * 1e3 == pytest.approx(0.3161, abs=1e-4)
    assert c["attn_fwd"]["calls"] == c["attn_bwd"]["calls"] == 12


def test_overlap_attention_counts_the_unmasked_keys():
    """N=657, B=500: 0.6704 ms of operations a layer with every key; the
    benchmark's masks attend 400..659 bp, so fewer."""
    w = widths("overlap")
    full = {"dna": {"input_ids": np.zeros((500, 657), np.int32),
                    "attention_mask": np.ones((500, 657), np.int32)}}
    c = counts.batch_counts(w, full, "embed", False, H100)
    assert c["attn_fwd"]["bound_s"] / 12 * 1e3 == pytest.approx(0.6704, abs=1e-4)
    masked = make_pool(w, 7, 1, 500, ["dna"])[0]
    keys = masked["dna"]["attention_mask"].sum()
    m = counts.batch_counts(w, masked, "embed", False, H100)
    assert m["attn_fwd"]["flops"] == pytest.approx(c["attn_fwd"]["flops"] * keys / (500 * 657))


def test_train_gemm_runs():
    """A block's GEMM runs 4 times under remat, the patch embedding's twice,
    a head's 3 times; the model's operations are 3 times the forward's."""
    w = widths("flagship")
    batch = make_pool(w, 3, 1, 8, ["image", "dna", "language"])[0]
    fwd = counts.batch_counts(w, batch, "embed", False, None)
    train = counts.batch_counts(w, batch, "train", True, None)
    loss = sum(2.0 * g["M"] * g["K"] * g["N"] * g["count"]
               for g in counts.loss_gemms(w, batch))
    assert train["model"]["flops"] == pytest.approx(3 * (fwd["model"]["flops"] + loss))
    blocks = sum(2.0 * g["M"] * g["K"] * g["N"] * g["count"]
                 for g in counts.gemms(w, batch) if g["where"] == "block")
    patch = sum(2.0 * g["M"] * g["K"] * g["N"] for g in counts.gemms(w, batch)
                if g["where"] == "patch")
    heads = sum(2.0 * g["M"] * g["K"] * g["N"] for g in counts.gemms(w, batch)
                if g["where"] == "head")
    assert train["gemm"]["flops"] == pytest.approx(4 * blocks + 2 * patch + 3 * heads + 3 * loss)


def test_no_peaks_no_bounds():
    c = counts.batch_counts(widths("flagship"), image_batch(2), "train", True, None)
    assert c["gemm"]["bound_s"] is None and c["attn_fwd"]["bound_s"] is None
