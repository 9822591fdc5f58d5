"""The port's feature-input encoders and the models beside them against
clibd_tpu: the MLP encoder (`models/mlp.py`), `CLIBD` with
`image.input_type: feature` and with `dna.input_type: feature` through
clibd_apply and extract_split, the DNACNN baseline (`models/cnn.py`), the
aux wrappers (`models/wrappers.py`) and the SimCLR backbone loader
(`models/clibd.py::load_simclr_vit_backbone`).

One weight set per test, drawn with jax.random from a seeded key, feeds both
packages (`model_from_jax`); inputs come from numpy generators seeded in the
test.  fp32 throughout, the JAX side at Precision.HIGHEST and its Pallas
attention in interpret mode: the two agree to TOL (float noise; the MLP and
the CNN have no attention).
"""

import os
import shutil
from dataclasses import replace

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.config.schema import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu.data.pipeline import BatchSpec, BioscanLoader
from clibd_tpu.engine import extract as jax_extract
from clibd_tpu.models import clibd as jax_clibd
from clibd_tpu.models import cnn as jax_cnn
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.models import mlp as jax_mlp
from clibd_tpu.models import vit as jax_vit
from clibd_tpu.models import wrappers as jax_wrappers
from clibd_tpu.models.convert import save_params_npz
from clibd_tpu.parallel.mesh import create_mesh
from clibd_tpu_torch.data.pipeline import BatchSpec as PortBatchSpec
from clibd_tpu_torch.data.pipeline import BioscanLoader as PortBioscanLoader
from clibd_tpu_torch.engine import extract as port_extract
from clibd_tpu_torch.models import cnn as port_cnn
from clibd_tpu_torch.models import wrappers as port_wrappers
from clibd_tpu_torch.models.clibd import (clibd_apply, init_clibd_model,
                                          load_simclr_vit_backbone, set_trainable)
from clibd_tpu_torch.models.convert import flatten_pytree, model_from_jax, params_from_jax
from clibd_tpu_torch.models.mlp import MLPEncoder
from clibd_tpu_torch.models.vit import ViT

import chip_smoke

TOL = 1e-5
IMAGE_DIM, DNA_DIM, HIDDEN = 24, 40, 32
SPLITS = (("all_keys", True), ("test_seen", False), ("test_unseen", False))


def tiny_cfg(image_features=False, dna_features=False, lora=False) -> ExperimentConfig:
    cfg = ExperimentConfig()
    cfg.amp = False
    cfg.batch_size = 5
    cfg.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                              num_heads=2, mlp_dim=128)
    cfg.dna.max_bp = 80
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=64, num_layers=2, num_heads=2,
                              intermediate_size=128, max_position_embeddings=40,
                              with_mlm_head=True)
    cfg.language.bert = BertConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
                                   intermediate_size=128, max_position_embeddings=24)
    cfg.output_dim = 48
    cfg.disable_lora = not lora
    if image_features:
        cfg.image.input_type, cfg.image.model = "feature", "mlp"
        cfg.image.input_dim, cfg.image.hidden_dim = IMAGE_DIM, HIDDEN
    if dna_features:
        cfg.dna.input_type, cfg.dna.model = "feature", "mlp"
        cfg.dna.input_dim, cfg.dna.hidden_dim = DNA_DIM, HIDDEN
    return cfg


def jax_tree(cfg, seed: int) -> dict:
    return jax.tree.map(np.asarray, jax_clibd.init_clibd_params(jax.random.PRNGKey(seed), cfg))


def jax_run(fn, *args, **kwargs):
    saved = jax_layers.ATTENTION_IMPL
    jax_layers.ATTENTION_IMPL = "pallas"  # the Pallas kernel in interpret mode
    try:
        return fn(*args, **kwargs)
    finally:
        jax_layers.ATTENTION_IMPL = saved


def assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= tol, err


@pytest.fixture(scope="module")
def features_hdf5(tiny_hdf5, tmp_path_factory):
    """The tiny fixture plus `image_features` and `dna_features` datasets in
    every split, the layout `BioscanLoader` reads for feature inputs."""
    path = str(tmp_path_factory.mktemp("features") / "tiny_features.hdf5")
    shutil.copy(tiny_hdf5, path)
    rng = np.random.default_rng(20)
    with h5py.File(path, "a") as f:
        for split in f:
            n = len(f[split]["barcode"])
            f[split].create_dataset("image_features",
                                    data=rng.standard_normal((n, IMAGE_DIM)).astype(np.float32))
            f[split].create_dataset("dna_features",
                                    data=rng.standard_normal((n, DNA_DIM)).astype(np.float32))
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_encoder_matches_jax(dtype):
    params = jax.tree.map(np.asarray, jax_mlp.init_mlp_encoder_params(
        jax.random.PRNGKey(1), IMAGE_DIM, HIDDEN, 48))
    model = MLPEncoder(IMAGE_DIM, HIDDEN, 48)
    model.load_state_dict(params_from_jax(params), strict=True)
    x = np.random.default_rng(2).standard_normal((7, IMAGE_DIM)).astype(np.float32)
    want = jax_mlp.mlp_encoder_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                     getattr(jnp, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x), getattr(torch, dtype))
    assert got.dtype == torch.float32
    # bf16: the same bf16 roundings in the same order, up to one bf16 ulp
    assert_close(got, want, TOL if dtype == "float32" else 2 ** -8 * float(np.abs(want).max()))


def test_mlp_encoder_init_draws():
    """torch nn.Linear's default: every weight and bias within ±1/sqrt(in)."""
    model = MLPEncoder(IMAGE_DIM, HIDDEN, 48)
    model.reset_parameters(torch.Generator().manual_seed(3))
    for fc, fan_in in ((model.fc1, IMAGE_DIM), (model.fc2, HIDDEN), (model.fc3, HIDDEN)):
        for t in (fc.w, fc.b):
            assert 0 < float(t.detach().abs().max()) <= fan_in ** -0.5


FEATURE_CASES = {"image_features": dict(image_features=True),
                 "dna_features": dict(dna_features=True)}


@pytest.mark.parametrize("case", list(FEATURE_CASES))
def test_feature_input_clibd_apply_matches_jax(case):
    cfg = tiny_cfg(**FEATURE_CASES[case])
    tree = jax_tree(cfg, seed=4)
    model = model_from_jax(tree, cfg, "cpu")
    enc = model.image_encoder if case == "image_features" else model.dna_encoder
    assert isinstance(enc, MLPEncoder)
    rng = np.random.default_rng(5)
    n = 4
    image = (rng.standard_normal((n, IMAGE_DIM)).astype(np.float32) if case == "image_features"
             else rng.random((n, 32, 32, 3), dtype=np.float32))
    dna = (rng.standard_normal((n, DNA_DIM)).astype(np.float32) if case == "dna_features"
           else rng.integers(0, 1027, (n, 17)).astype(np.int32))
    ids = rng.integers(1, 1000, (n, 20)).astype(np.int32)
    lang = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
            "attention_mask": np.ones_like(ids)}
    want = jax_run(jax_clibd.clibd_apply, jax.tree.map(jnp.asarray, tree), cfg,
                   jnp.asarray(image), jnp.asarray(dna),
                   {k: jnp.asarray(v) for k, v in lang.items()}, compute_dtype=jnp.float32)
    with torch.no_grad():
        got = clibd_apply(model, cfg, torch.from_numpy(image), torch.from_numpy(dna),
                          {k: torch.from_numpy(v) for k, v in lang.items()},
                          compute_dtype=torch.float32)
    for m in ("image", "dna", "language"):
        assert_close(got[m], want[m])


@pytest.mark.parametrize("case", list(FEATURE_CASES))
def test_feature_input_extract_split_matches_jax(features_hdf5, case):
    """extract_split over the HDF5's feature datasets, both packages on the
    same params (the JAX package on a one-device mesh).  The DNA-feature
    case leaves the ViT out: on decoded JPEGs a bf16 rounding of P can go
    the other way in one package (tests/test_torch_extract_eval.py holds
    the ViT's extraction to 1e-3 for that), and the MLP tower is the
    subject here."""
    cfg = tiny_cfg(**FEATURE_CASES[case])
    cfg.image.enable = case == "image_features"
    tree = jax_tree(cfg, seed=6)
    model = model_from_jax(tree, cfg, "cpu")
    mesh = create_mesh(jax.devices()[:1])
    for split, for_key in SPLITS:
        # the tiny ViT takes 32-pixel images
        jl = BioscanLoader(features_hdf5, split, replace(BatchSpec.eval_spec(cfg, 5),
                                                         image_size=32, resize_to=36),
                           num_workers=0)
        pl = PortBioscanLoader(features_hdf5, split, replace(PortBatchSpec.eval_spec(cfg, 5),
                                                             image_size=32, resize_to=36),
                               num_workers=0)
        try:
            want = jax_run(jax_extract.extract_split, tree, cfg, jl, for_key_set=for_key,
                           mesh=mesh)
            got = port_extract.extract_split(model, cfg, pl, for_key_set=for_key)
        finally:
            jl.close()
            pl.close()
        for key in ("encoded_image_feature", "encoded_dna_feature",
                    "encoded_language_feature"):
            if not cfg.image.enable and key == "encoded_image_feature":
                assert got[key] is None and want[key] is None
                continue
            assert got[key].shape == want[key].shape == (12, cfg.output_dim), key
            assert_close(got[key], want[key])
        assert got["label_list"] == want["label_list"]


@pytest.mark.parametrize("lora,freeze", [(True, False), (True, True), (False, False)],
                         ids=["lora", "lora_dna_frozen", "full"])
def test_feature_input_trainable_set_matches_mask(lora, freeze):
    """The MLP encoders train whole under LoRA; a modality's freeze flag
    freezes it: `set_trainable` against `trainable_mask`."""
    cfg = tiny_cfg(image_features=True, dna_features=True, lora=lora)
    cfg.dna.freeze = freeze
    tree = jax_tree(cfg, seed=7)
    model = set_trainable(model_from_jax(tree, cfg, "cpu"), cfg)
    mask = flatten_pytree(jax_clibd.trainable_mask(tree, cfg))
    trainable = {n.replace(".", "/") for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == {k for k, v in mask.items() if bool(v)}


def test_feature_input_fresh_init_shapes():
    """`init_clibd_model` builds the MLP encoders of the config's widths."""
    cfg = tiny_cfg(image_features=True, dna_features=True)
    model = init_clibd_model(cfg, torch.Generator().manual_seed(8), "cpu")
    tree = jax_tree(cfg, seed=8)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {k.replace("/", "."): v.shape for k, v in flatten_pytree(tree).items()}
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dnacnn_matches_jax(dtype):
    """DNACNN over one-hot DNA of 66 bases (66 → 21 → 6 → 1 rows after the
    three conv + pool stages, 16 channels x 4 bases = 64 features)."""
    params = jax.tree.map(np.asarray, jax_cnn.init_dnacnn_params(
        jax.random.PRNGKey(9), in_feature=1, dim=64, embedding_dim=24))
    model = port_cnn.DNACNN(in_feature=1, dim=64, embedding_dim=24)
    model.load_state_dict(params_from_jax(params), strict=True)
    tokens = np.random.default_rng(10).integers(0, 5, (3, 66))  # 4 = N: a zero row
    onehot = port_cnn.one_hot_dna(torch.from_numpy(tokens))
    want_onehot = jax_cnn.one_hot_dna(jnp.asarray(tokens))
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(want_onehot))
    want = jax_cnn.dnacnn_apply(jax.tree.map(jnp.asarray, params),
                                want_onehot.astype(getattr(jnp, dtype)))
    with torch.no_grad():
        got = model(onehot.to(getattr(torch, dtype)))
    assert got.shape == (3, 24)
    assert_close(got, want)


def test_dnacnn_init_draws():
    model = port_cnn.DNACNN(in_feature=1, dim=64, embedding_dim=24)
    model.reset_parameters(torch.Generator().manual_seed(11))
    for conv, fan_in in ((model.conv1, 9), (model.conv2, 64 * 9), (model.conv3, 32 * 9)):
        assert conv.w.shape[:2] == (3, 3)
        for t in (conv.w, conv.b):
            assert 0 < float(t.detach().abs().max()) <= fan_in ** -0.5


def test_encoder_with_extra_layer_matches_jax():
    """An MLP encoder under an extra linear head: logits and the pre-head
    features of both packages; the head's init draws torch's defaults."""
    enc = jax.tree.map(np.asarray, jax_mlp.init_mlp_encoder_params(
        jax.random.PRNGKey(12), IMAGE_DIM, HIDDEN, 16))
    head = jax.tree.map(np.asarray, jax_wrappers.init_extra_layer(jax.random.PRNGKey(13), 16, 5))
    port_enc = MLPEncoder(IMAGE_DIM, HIDDEN, 16)
    port_enc.load_state_dict(params_from_jax(enc), strict=True)
    port_head = port_wrappers.init_extra_layer(torch.Generator().manual_seed(13), 16, 5)
    assert float(port_head.w.detach().abs().max()) <= 0.25
    assert float(port_head.b.detach().abs().max()) <= 0.25
    port_head.load_state_dict(params_from_jax(head), strict=True)
    x = np.random.default_rng(14).standard_normal((6, IMAGE_DIM)).astype(np.float32)

    jax_apply = jax_wrappers.encoder_with_extra_layer(
        lambda p, v: jax_mlp.mlp_encoder_apply(p, v, jnp.float32))
    port_apply = port_wrappers.encoder_with_extra_layer(lambda m, v: m(v, torch.float32))
    jp = {"encoder": jax.tree.map(jnp.asarray, enc), "head": jax.tree.map(jnp.asarray, head)}
    pp = {"encoder": port_enc, "head": port_head}
    with torch.no_grad():
        for feats in (False, True):
            assert_close(port_apply(pp, torch.from_numpy(x), torch.float32, return_features=feats),
                         jax_apply(jp, jnp.asarray(x), jnp.float32, return_features=feats))


def test_frozen_backbone_with_mlp_matches_jax():
    """A frozen ViT's features feed a trainable MLP: the output of both
    packages, and gradients reach the MLP and never the backbone."""
    cfg = tiny_cfg()
    vit = jax.tree.map(np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(15), cfg.image.vit,
                                                           output_dim=16))
    mlp = jax.tree.map(np.asarray, jax_mlp.init_mlp_encoder_params(
        jax.random.PRNGKey(16), 16, HIDDEN, 8))
    port_vit = ViT(cfg.image.vit, output_dim=16)
    port_vit.load_state_dict(params_from_jax(vit), strict=True)
    port_mlp = MLPEncoder(16, HIDDEN, 8)
    port_mlp.load_state_dict(params_from_jax(mlp), strict=True)
    x = np.random.default_rng(17).random((3, 32, 32, 3), dtype=np.float32)

    jax_apply = jax_wrappers.frozen_backbone_with_mlp(
        lambda p, v: jax_vit.vit_apply(p, v, cfg.image.vit, compute_dtype=jnp.float32),
        jax_mlp.mlp_encoder_apply)
    port_apply = port_wrappers.frozen_backbone_with_mlp(
        lambda m, v: m(v, compute_dtype=torch.float32), lambda m, v, dt: m(v, dt))
    want = jax_run(jax_apply, {"backbone": jax.tree.map(jnp.asarray, vit),
                               "mlp": jax.tree.map(jnp.asarray, mlp)}, jnp.asarray(x),
                   jnp.float32)
    got = port_apply({"backbone": port_vit, "mlp": port_mlp}, torch.from_numpy(x), torch.float32)
    assert_close(got, want)
    got.sum().backward()
    assert all(p.grad is None for p in port_vit.parameters())
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in port_mlp.parameters())


@pytest.mark.parametrize("source", ["npz", "npz_dir", "timm_pth"])
def test_load_simclr_vit_backbone_matches_jax(tmp_path, source):
    """The SimCLR backbone from an .npz, a checkpoint directory or a timm
    .pth (with "module." and a SimCLR head of another width) replaces the
    backbone and keeps the fresh head and LoRA: against the JAX loader."""
    cfg = tiny_cfg(lora=True)
    donor = jax.tree.map(np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(18),
                                                             cfg.image.vit, output_dim=128))
    if source == "timm_pth":
        gen = torch.Generator().manual_seed(19)
        vit = chip_smoke._sub(chip_smoke.draw_port_params(tiny_cfg(), gen), "image_encoder.")
        path = str(tmp_path / "simclr.pth")
        torch.save({"module." + k: v for k, v in chip_smoke.vit_state_dict(vit).items()}, path)
    else:
        path = str(tmp_path / ("ckpt" if source == "npz_dir" else "simclr.npz"))
        save_params_npz(donor, os.path.join(path, "params.npz") if source == "npz_dir" else path)
    init = jax_tree(cfg, seed=20)["image_encoder"]
    want = jax_clibd.load_simclr_vit_backbone(path, init, cfg)
    model = ViT(cfg.image.vit, output_dim=cfg.output_dim, lora_rank=cfg.lora_rank)
    model.load_state_dict(params_from_jax(init), strict=True)
    load_simclr_vit_backbone(path, model)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    want = {k.replace("/", "."): v for k, v in flatten_pytree(want).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["head.w"], init["head"]["w"])
    np.testing.assert_array_equal(got["lora.a_q"], init["lora"]["a_q"])


def test_simclr_backbone_loaded_at_init(tmp_path):
    """`image.simclr_ckpt_path` set: `init_clibd_model` draws the model, then
    the ViT takes the SimCLR backbone (the JAX package's `init_clibd_params`)."""
    cfg = tiny_cfg(lora=True)
    donor = jax.tree.map(np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(21),
                                                             cfg.image.vit))
    cfg.image.simclr_ckpt_path = str(tmp_path / "simclr.npz")
    save_params_npz(donor, cfg.image.simclr_ckpt_path)
    model = init_clibd_model(cfg, torch.Generator().manual_seed(22), "cpu")
    np.testing.assert_array_equal(model.image_encoder.blocks.qkv_w.detach().numpy(),
                                  donor["blocks"]["qkv_w"])
    np.testing.assert_array_equal(model.image_encoder.patch_embed.w.detach().numpy(),
                                  donor["patch_embed"]["w"])
    assert not np.array_equal(model.image_encoder.head.w.detach().numpy(), donor["head"]["w"])
    with pytest.raises(ValueError, match="SimCLR backbone"):
        cfg.image.vit.hidden_size = 32  # a backbone of another width
        load_simclr_vit_backbone(cfg.image.simclr_ckpt_path,
                                 ViT(cfg.image.vit, output_dim=cfg.output_dim))


def test_synthetic_split_feature_rows_and_species():
    """`SyntheticSplit` yields fp32 feature rows of `input_dim` for a
    feature-input config, and with `species=k` specimens around per-species
    prototypes shared by every split: one species' rows carry its text and
    lie close in pixels, other species' rows lie far."""
    from clibd_tpu_torch.data import SyntheticSplit

    cfg = tiny_cfg(image_features=True, dna_features=True)
    b = next(SyntheticSplit("f", 7, cfg, seed=0).batches())
    assert b["image"].shape == (5, IMAGE_DIM) and b["image"].dtype == np.float32
    assert b["dna"].shape == (5, DNA_DIM) and b["dna"].dtype == np.float32

    cfg = tiny_cfg()
    a, c = (SyntheticSplit(n, 30, cfg, seed=s, species=3) for n, s in (("a", 1), ("c", 2)))
    rows = []
    for split in (a, c):
        species = [int(lab["species"].split("_")[1]) for lab in split.label_dicts()]
        for batch in split.batches():
            for i in range(len(batch["index"])):
                rows.append((species[batch["index"][i]], batch["image"][i].astype(np.int16),
                             batch["language"]["input_ids"][i]))
    assert {s for s, _, _ in rows} == {0, 1, 2}
    for s, img, ids in rows:
        first = next(r for r in rows if r[0] == s)
        other = next(r for r in rows if r[0] != s)
        np.testing.assert_array_equal(ids, first[2])
        assert np.abs(img - first[1]).max() <= 64
        assert np.abs(img - other[1]).mean() > 40
