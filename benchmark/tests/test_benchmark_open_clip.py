"""The harness takes a configuration of the open_clip backbone with new files
alone, and the existing configurations read what they read before.

On the CPU at test widths: the widths checked at `clip.*`, CLIP-form text,
the CLIP towers' counts against hand numbers, the port's `clibd_apply` on a
pool batch, each reference's declared settings, and digests of flagship's
and overlap's pools, config pairs and counts."""

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark.core import counts, inputs
from benchmark.core.cell import BENCH, config_pairs, load_json, program_config
from benchmark.core.peaks import peaks_for
from benchmark.tests.sizes import TINY_CLIP, VIT_L14, open_clip_config, tiny_cell

MODALITIES = ("image", "dna", "language")


# (a) widths at clip.*

def test_vit_l14_widths_under_clip_are_the_recipes():
    mc = program_config(open_clip_config(), 7).model_config
    assert mc.backbone == "open_clip" and mc.clip.vision_layers == 24
    assert mc.clip.context_length == 77 and mc.loss.fix_temperature


def test_a_changed_clip_width_is_refused_with_its_path():
    config = open_clip_config(dict(VIT_L14, vision_layers=12))
    with pytest.raises(ValueError, match=r"clip\.vision_layers: recipe 24, file 12"):
        program_config(config, 7)


def test_tiny_clip_widths_are_applied():
    mc = program_config(open_clip_config(TINY_CLIP, tiny=True), 7, apply=True).model_config
    assert mc.clip.image_size == 28 and mc.clip.text_hidden == 128 and mc.output_dim == 64
    assert mc.dna.bert.hidden_size == 128


def test_vit_l14_widths_under_image_are_refused():
    config = load_json(BENCH / "configs" / "flagship.json")
    config["recipe"] = open_clip_config()["recipe"]
    config["widths"]["image"].update(patch_size=14, hidden_size=1024, num_layers=24,
                                     num_heads=16, mlp_dim=4096)
    with pytest.raises(ValueError, match=r"image\.vit\.patch_size: recipe 16, file 14"):
        program_config(config, 7)


@pytest.mark.parametrize("apply", [False, True])
def test_the_backbone_follows_the_widths(apply):
    flagship = load_json(BENCH / "configs" / "flagship.json")
    clip_on_default = open_clip_config()
    clip_on_default["recipe"] = flagship["recipe"]
    default_on_clip = dict(flagship, recipe=open_clip_config()["recipe"])
    for config in (clip_on_default, default_on_clip):
        with pytest.raises(ValueError, match="backbone: recipe"):
            program_config(config, 7, apply=apply)


@pytest.mark.parametrize("group", ["image", "language"])
def test_clip_beside_image_or_language_is_refused(group):
    config = open_clip_config()
    config["widths"][group] = load_json(BENCH / "configs" / "flagship.json")["widths"][group]
    with pytest.raises(ValueError, match="widths state `clip`"):
        config_pairs(config)


# (b) CLIP-form text

def test_clip_form_text():
    w = open_clip_config(TINY_CLIP, tiny=True)["widths"]
    rows, n, vocab = 12, TINY_CLIP["context_length"], TINY_CLIP["vocab_size"]
    a = inputs.make_pool(w, 2 ** 31 + 17, 2, rows, MODALITIES)
    b = inputs.make_pool(w, 5, 1, rows, MODALITIES)
    assert a[0]["image"].shape == (rows, 28, 28, 3)
    assert set(a[0]["language"]) == {"input_ids"}
    ids = a[0]["language"]["input_ids"]
    assert ids.dtype == np.int32 and ids.shape == (rows, n)
    lengths = (ids > 0).sum(1)
    assert (ids[:, 0] == vocab - 2).all()
    assert (ids[np.arange(rows), lengths - 1] == vocab - 1).all()
    assert (ids.argmax(1) == lengths - 1).all()
    for row, length in zip(ids, lengths):
        assert (row[1:length - 1] >= 1).all() and (row[1:length - 1] <= vocab - 3).all()
        assert not row[length:].any()
    assert sorted(lengths) == sorted(inputs.even_lengths(rows, 3, n + 1))
    assert sorted(lengths) == sorted((b[0]["language"]["input_ids"] > 0).sum(1))
    assert not np.array_equal(ids, a[1]["language"]["input_ids"])


# (c) the CLIP towers' counts

def test_clip_counts_are_hand_numbers():
    """B 4; vision S 28, p 14: N 5, D 128, F 256, L 2, head 128 → 64; text
    N 8 causal: keys 4·9/2 = 18 summed over the rows."""
    w = open_clip_config(TINY_CLIP, tiny=True)["widths"]
    image = {"image": np.zeros((4, 28, 28, 3), np.uint8)}
    text = {"language": {"input_ids": np.zeros((4, 8), np.int32)}}
    block = 2 * (128 * 384 + 128 * 128 + 128 * 256 + 256 * 128)  # a row through a block
    img = counts.batch_counts(w, image, "embed", False, None)
    assert img["model"]["flops"] == (2 * 20 * block            # 2 layers, M = 4·5
                                     + 2 * 16 * 588 * 128      # patches, no bias
                                     + 2 * 4 * 128 * 64        # proj
                                     + 2 * 4 * 5 * 128 * 20)   # attention, keys 4·5
    (tower,) = counts.towers(w, text)
    assert (tower["N"], tower["D"], tower["F"], tower["L"], tower["keys"]) == (8, 128, 256, 2, 18)
    txt = counts.batch_counts(w, text, "train", True, None)
    assert txt["attn_fwd"]["flops"] == 2 * 4 * 8 * 128 * 18 == 2 * 4 * 128 * 4 * 8 * 9 / 2
    assert txt["attn_bwd"]["flops"] == 2 * 10 * 8 * 128 * 18
    assert txt["attn_fwd"]["bytes"] == 2 * 8 * 4 * 8 * 128
    assert txt["attn_bwd"]["bytes"] == 2 * 14 * 4 * 8 * 128
    fwd = 2 * 32 * block + 2 * 4 * 128 * 64 + 2 * 4 * 8 * 128 * 18
    assert txt["model"]["flops"] == 3 * fwd
    both = counts.batch_counts(w, {**image, **text}, "train", True, None)
    loss = 2 * 2 * 4 * 64 * 4                                  # two ordered pairs
    assert both["gemm"]["flops"] == (4 * 2 * (20 + 32) * block + 2 * 2 * 16 * 588 * 128
                                     + 3 * 2 * 2 * 4 * 128 * 64 + 3 * loss)
    assert both["gemm"]["calls"] == 4 * 2 * 4 * 2 + 2 + 3 * 2 + 3 * 2


# (d) the existing configurations draw and count what they did

SEED = 2 ** 31 + 20261018
# sha256 digests of this code's output, recorded from the harness before it
# took `clip` widths
DIGESTS = {
    "flagship": {"pool": "585967af8e22cb3f351de4570e147833cbaff59709ff554eeb234f772e7bafdb",
                 "pool_rank1_of4":
                     "72da0ca6679620f11140f3e5e4632623901469aa0d706885953ff3a73db467a5",
                 "config_pairs":
                     "d085680725383d50578047fc83f0a57bcdf06dd883a9c4af6240697c3f617ed7",
                 "counts": "d37a5cf8eefef03384110fb974dcecc44562b0c44da6a7ea945df72cb2da48cb"},
    "overlap": {"pool": "25797ebcf40f91ef81ae4450c7e81f1cc3e49c4dc41865c6b4d37dbda927c378",
                "pool_rank1_of4":
                    "71f7ff53b6993c4e2bb8cab8423e757401afa5bf9b0e978747b55e274550e820",
                "config_pairs":
                    "4d24456005ee9449d6293b52a97efff2faf92aff7c4df0e43058c808ce7f3f32",
                "counts": "62597c230d5265f7a37b679e0daf55e89055916de9028ac4d88c2894f8ddebc9"},
}


def _feed(h, path, x):
    if isinstance(x, dict):
        for k in sorted(x):
            _feed(h, f"{path}.{k}", x[k])
        return
    h.update(f"{path}:{x.dtype.str}:{x.shape}".encode())
    h.update(np.ascontiguousarray(x).tobytes())


def pool_digest(widths, rank=0, ranks=1):
    h = hashlib.sha256()
    for i, b in enumerate(inputs.make_pool(widths, SEED, 2, 16, MODALITIES, rank, ranks)):
        _feed(h, str(i), b)
    return h.hexdigest()


def json_digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def counts_digest(widths):
    batch = inputs.make_pool(widths, SEED, 1, 16, MODALITIES)[0]
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    return json_digest({"towers": counts.towers(widths, batch),
                        "gemms": counts.gemms(widths, batch),
                        "loss": counts.loss_gemms(widths, batch),
                        "train": counts.batch_counts(widths, batch, "train", True, peaks),
                        "train_no_remat": counts.batch_counts(widths, batch, "train", False, None),
                        "embed": counts.batch_counts(widths, batch, "embed", False, peaks)})


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_existing_configurations_are_unmoved(name):
    config = load_json(BENCH / "configs" / f"{name}.json")
    w = config["widths"]
    assert {"pool": pool_digest(w), "pool_rank1_of4": pool_digest(w, 1, 4),
            "config_pairs": json_digest(config_pairs(config)),
            "counts": counts_digest(w)} == DIGESTS[name]


# (e) a pool batch through the port

def test_a_pool_batch_runs_through_the_port():
    from clibd_tpu_torch.models.clibd import clibd_apply, init_clibd_model

    from benchmark.core.program import to_device_batch

    torch.set_num_threads(2)
    config = open_clip_config(TINY_CLIP, tiny=True)
    mc = program_config(config, 3, apply=True).model_config
    model = init_clibd_model(mc, torch.Generator().manual_seed(3), "cpu")
    b = to_device_batch(inputs.make_pool(config["widths"], 3, 1, 4, MODALITIES)[0],
                        torch.device("cpu"))
    with torch.no_grad():
        out = clibd_apply(model, mc, image_input=b["image"], dna_input=b["dna"],
                          language_input=b["language"])
    for m in MODALITIES:
        assert out[m].shape == (4, 64) and torch.isfinite(out[m]).all()
        torch.testing.assert_close(out[m].norm(dim=-1), torch.ones(4))


# each reference declares the settings it implements

def test_the_clibd_reference_declares_its_settings():
    from benchmark.reference import clibd as ref

    assert ref.SETTINGS == {"loss.bind_to": "", "loss.no_image_text_loss": False,
                            "loss.fix_temperature": False, "loss.local_loss": False,
                            "optim.optimizer": "adamw", "optim.lr_scheduler": "one_cycle",
                            "optim.grad_clip_norm": 0.0, "accum_steps": 1,
                            "disable_lora": True}


def test_the_driver_and_calibration_refuse_other_settings(tmp_path, monkeypatch):
    """A recipe whose settings differ from the reference's declaration is
    refused by the train driver's reference, and calibration goes through
    the same guard."""
    from benchmark import calibrate
    from benchmark.run import Context

    cell = tiny_cell("flagship-train")
    cell.config["train"]["loss.fix_temperature"] = True
    ctx = Context(cell, 11, 0.0, False, torch.device("cpu"), 0.0, None, str(tmp_path),
                  apply_widths=True)
    mc = ctx.program_config().model_config
    message = r"the plain reference does not implement \{'loss.fix_temperature': True\}"
    with pytest.raises(ValueError, match=message):
        cell.driver.reference_readings(ctx, [], mc, 2)

    class Closed:
        def close(self):
            pass

    monkeypatch.setattr(cell.driver, "program_setup", lambda *a: (Closed(), None, {}))
    with pytest.raises(ValueError, match=message):
        calibrate.train_seed(ctx, control=False, fault=False)
