"""The plain reference computes what the program computes, at test sizes in
float32 on the CPU: the augmentation bit for bit, the forward, the loss, the
schedule and AdamW to rounding."""

import numpy as np
import pytest
import torch

from benchmark.core import inputs
from benchmark.core.program import build_model, to_device_batch
from benchmark.core.weights import draw_weights
from benchmark.tests.sizes import tiny_cell

CPU = torch.device("cpu")


def setup(name, seed=3):
    cell = tiny_cell(name)
    gcfg = __import__("benchmark.core.cell", fromlist=["x"]).program_config(cell.config, seed,
                                                                            apply=True)
    ref = cell.reference
    weights = draw_weights(ref.param_shapes(cell.widths), ref.init_kind, seed, CPU)
    batch = inputs.make_pool(cell.widths, seed, 1, 8, cell.traffic["modalities"])[0]
    return cell, gcfg.model_config, ref, weights, to_device_batch(batch, CPU)


def test_augmentation_is_the_programs():
    from clibd_tpu_torch.ops.augment import train_augment

    from benchmark.reference import clibd as ref

    images = torch.rand(6, 40, 40, 3)
    for seed in (0, 1, 2):
        seed = ref.batch_generator_seed(seed, 1, 2)
        got = ref.augment(images, torch.Generator().manual_seed(seed))
        want = train_augment(torch.Generator().manual_seed(seed), images)
        assert torch.equal(got, want)


def exact_attention(qkv, num_heads, mask_row=None):
    """Attention from fused q/k/v in float32 throughout: the program's plain
    version rounds P and V to bf16 as its kernel does."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (t.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) / (D // num_heads) ** 0.5
    if mask_row is not None:
        s = s + mask_row[:, None, None, :]
    return torch.matmul(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, N, D)


@pytest.mark.parametrize("name", ["flagship-train", "overlap-train"])
def test_forward_and_loss_are_the_programs(name, monkeypatch):
    from clibd_tpu_torch.models import layers
    from clibd_tpu_torch.models.clibd import clibd_apply
    from clibd_tpu_torch.ops.loss import clip_loss

    monkeypatch.setattr(layers, "flash_attention_qkv", exact_attention)
    cell, mc, ref, weights, b = setup(name)
    model = build_model(mc, weights, CPU)
    images = b["image"].float() / 255.0
    with torch.no_grad():
        got = ref.encode(weights, cell.widths, images, b["dna"], b["language"])
        want = clibd_apply(model, mc, image_input=images, dna_input=b["dna"],
                           language_input=b["language"], compute_dtype=torch.float32)
        for m in ("image", "dna", "language"):
            torch.testing.assert_close(got[m], want[m], rtol=1e-5, atol=1e-6)
        scale = torch.exp(weights["logit_scale"])
        torch.testing.assert_close(ref.contrastive_loss(got, b["label"], scale),
                                   clip_loss(want, b["label"], scale, mc.loss),
                                   rtol=1e-5, atol=1e-6)


def test_blocked_gradients_are_the_whole_batchs():
    cell, mc, ref, weights, b = setup("flagship-train")
    images = b["image"].float() / 255.0
    loss4, g4, f4 = ref.loss_and_grads(weights, cell.widths, images, b["dna"], b["language"],
                                   b["label"], 4)
    loss8, g8, f8 = ref.loss_and_grads(weights, cell.widths, images, b["dna"], b["language"],
                                   b["label"], 8)
    torch.testing.assert_close(loss4, loss8)
    for m in f8:
        torch.testing.assert_close(f4[m], f8[m])
    for n in g8:
        torch.testing.assert_close(g4[n], g8[n], rtol=1e-4, atol=1e-7)


def test_schedule_and_adamw_are_the_programs():
    from clibd_tpu_torch.engine.schedules import build_schedule

    from benchmark.reference import clibd as ref

    cell, mc, _, _, _ = setup("flagship-train")
    mine = ref.one_cycle(5e-5 * 8 / 500, 1000 * mc.epochs, 0.3, 25.0, 1e4)
    theirs = build_schedule(mc.optim, 1000 * mc.epochs, 8)
    for step in (0, 1, 2, 500, 14999, 49999):
        assert mine(step) == pytest.approx(theirs(step), rel=1e-12)
    gen = torch.Generator().manual_seed(0)
    P = {"w": torch.randn(5, 7, generator=gen)}
    p = torch.nn.Parameter(P["w"].clone())
    opt = torch.optim.AdamW([p], lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    state = {}
    for _ in range(3):
        g = torch.randn(5, 7, generator=gen)
        p.grad = g.clone()
        opt.step()
        ref.adamw_update(P, {"w": g}, state, 1e-3, 0.9, 0.999, 1e-8, 0.01)
    torch.testing.assert_close(P["w"], p.detach(), rtol=1e-6, atol=1e-7)


def test_weights_follow_the_seed():
    from benchmark.reference import clibd as ref

    cell = tiny_cell("flagship-train")
    shapes = ref.param_shapes(cell.widths)
    a = draw_weights(shapes, ref.init_kind, 5, CPU)
    b = draw_weights(shapes, ref.init_kind, 5, CPU)
    c = draw_weights(shapes, ref.init_kind, 6, CPU)
    n = "image_encoder.blocks.qkv_w"
    assert torch.equal(a[n], b[n]) and not torch.equal(a[n], c[n])
    assert float(a[n].abs().max()) <= 0.04 and float(a["image_encoder.norm.scale"].min()) == 1.0
    assert np.isclose(float(a["logit_scale"]), np.log(1 / 0.07))
