"""The port's supervised fine-tune (`clibd_tpu_torch/engine/finetune.py`,
`cli finetune`) against clibd_tpu on the CPU: `fit_classifier`'s fp32 steps
on the tiny model from the JAX package's params and head (its attention
through the Pallas kernels in interpret mode), image and DNA, encoder
trained and frozen; `predict`, `species_to_index` and `topk_accuracy`; and
`python -m clibd_tpu_torch.cli finetune --device cpu` on an INSECT fixture,
its `--output-dir` read by the JAX package's `load_train_state`.  Every
input comes from a generator seeded here.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax

from clibd_tpu.engine import checkpoint as jax_checkpoint
from clibd_tpu.engine import finetune as jax_finetune
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.engine import finetune as port_finetune
from clibd_tpu_torch.models import model_from_jax
from clibd_tpu_torch.models.convert import flatten_pytree, params_from_jax
from clibd_tpu_torch.models.layers import Linear
from tests.fixtures import random_jpeg_bytes
from tests.torch_tiny import port_tiny_cfg, tiny_batch, tiny_cfg, tiny_tree

C = 6                  # classes of the tiny fit
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
# predict's logits, relative to the largest: the forward alone, where a P
# entry rounded to bf16 the other way moves a logit of the 5-token image
# tower by ~3e-5 of it (the losses, means over the batch, stay within 1e-5)
LOGIT_REL_TOL = 1e-4
# the head alone trains at 1e-3; with the encoder, at 1e-6: both packages
# round P to bf16 after fp32 maths (tests/test_torch_train_step.py), so a
# gradient entry near zero may take the other sign and AdamW moves it by
# +-lr, which must stay below PARAM_ATOL over the steps
LR = {True: 1e-6, False: 1e-3}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the tiny model's ops gain
    nothing from more, and the suite's workers would oversubscribe the
    cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Batches:
    """One batch of the tiny model per epoch, the epoch's own (the
    `BioscanLoader` interface that `fit_classifier` reads)."""

    def __init__(self, modality):
        self.modality = modality

    def batches(self, epoch=0, shuffle=None):
        b = tiny_batch(seed=10 + epoch)
        yield {self.modality: b[self.modality], "index": np.arange(4) + 4 * epoch}


def _leaves(tree):
    return {k: np.asarray(v) for k, v in flatten_pytree(jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("modality,train_encoder", [("image", True), ("image", False),
                                                    ("dna", True), ("dna", False)])
def test_fit_classifier_matches_jax(monkeypatch, modality, train_encoder):
    """3 fp32 steps (one an epoch) from the JAX params and the JAX head:
    the per-step losses within rel 1e-5, every parameter within 1e-5, the
    frozen encoder and the other towers bit-identical to their start, and
    then equal logits from `predict`."""
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    jcfg, pcfg = tiny_cfg(disable_lora=True), port_tiny_cfg(disable_lora=True)
    tree = tiny_tree()
    targets = np.random.default_rng(1).integers(0, C, 4 * STEPS).astype(np.int32)
    lr = LR[train_encoder]
    jparams, jpredict, jlosses = jax_finetune.fit_classifier(
        tree, jcfg, _Batches(modality), targets, C, optax.adamw(lr), epochs=STEPS,
        modality=modality, train_encoder=train_encoder, seed=3)

    model = model_from_jax(tree, pcfg, "cpu")
    jhead = jax.tree.map(np.asarray, jax_finetune.init_classifier_head(
        jax.random.PRNGKey(3), jcfg.output_dim, C))
    head = Linear(pcfg.output_dim, C)
    head.load_state_dict(params_from_jax(jhead))
    ft, predict, losses = port_finetune.fit_classifier(
        model, pcfg, _Batches(modality), targets, C, lr=lr, epochs=STEPS, modality=modality,
        train_encoder=train_encoder, seed=3, head=head)

    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = _leaves(jparams)
    got = {n.replace(".", "/"): p.detach().numpy() for n, p in ft.named_parameters()}
    start = _leaves(tree)
    assert set(got) == set(want) and want["classifier/w"].shape == (pcfg.output_dim, C)
    trained = ("classifier/",) + ((f"{modality}_encoder/",) if train_encoder else ())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
        if not k.startswith(trained):
            assert np.array_equal(got[k], start[k]), k
    # the model the fit started from is left as it was (the trained encoder is a copy)
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), start[n.replace(".", "/")]), n

    x = tiny_batch(seed=30)[modality]
    got, want = predict(x).numpy(), np.asarray(jpredict(jparams, {modality: x}))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL_TOL * np.abs(want).max())
    assert np.array_equal(got.argmax(1), want.argmax(1))


def test_species_index_and_topk_accuracy_equal_jax():
    rng = np.random.default_rng(2)
    species = [f"sp{i}" for i in range(9)]
    labels = [{"species": species[i]} for i in rng.integers(0, 9, 50)]
    assert np.array_equal(port_finetune.species_to_index(labels, species),
                          jax_finetune.species_to_index(labels, species))
    logits = rng.standard_normal((50, 9)).astype(np.float32)
    targets = rng.integers(0, 9, 50)
    for k_values in ((1, 3, 5), (2,)):
        assert port_finetune.topk_accuracy(logits, targets, k_values) == \
            jax_finetune.topk_accuracy(logits, targets, k_values)
    head = port_finetune.init_classifier_head(torch.Generator().manual_seed(0), 16, 9)
    bound = 1 / 4
    assert head.w.shape == (16, 9) and float(head.w.detach().abs().max()) <= bound
    assert float(head.b.detach().abs().max()) <= bound


FINETUNE_EXP = """
dataset: INSECT
batch_size: 4
output_dim: 8
load_ckpt: false
language: {enable: false}
dna:
  bert: {vocab_size: 1027, hidden_size: 32, num_layers: 1, num_heads: 4, intermediate_size: 64,
         max_position_embeddings: 140, with_mlm_head: true}
image:
  vit: {image_size: 224, patch_size: 56, hidden_size: 32, num_layers: 1, num_heads: 4,
        mlp_dim: 64}
"""


@pytest.fixture(scope="module")
def insect_fixture(tmp_path_factory):
    """The INSECT files of tests/test_subset_zeroshot.py's fine-tune test:
    16 records of 4 species, 12 in trainval and 4 in test_seen."""
    import h5py
    import scipy.io as sio

    root = tmp_path_factory.mktemp("insect_ft")
    rng = np.random.default_rng(16)
    n = 16
    sio.savemat(str(root / "res101.mat"), {
        "ids": np.array([[f"im{i}"] for i in range(n)], dtype=object),
        "nucleotides": np.array([["ACGT" * 40] for _ in range(n)], dtype=object),
        "species": np.array([[f"sp{i % 4}"] for i in range(n)], dtype=object),
        "labels": (np.arange(n) % 4 + 1).reshape(-1, 1),
    })
    sio.savemat(str(root / "att_splits.mat"), {
        "trainval_loc": np.arange(1, 13).reshape(1, -1),
        "test_seen_loc": np.arange(13, 17).reshape(1, -1),
    })
    with h5py.File(str(root / "images.hdf5"), "w") as f:
        g = f.create_group("images")
        for i in range(n):
            g.create_dataset(f"im{i}", data=np.frombuffer(random_jpeg_bytes(rng), dtype=np.uint8))
    (root / "s2o.json").write_text(json.dumps(
        {f"sp{i}": {"order": "o", "family": "f", "genus": "g"} for i in range(4)}))
    (root / "exp.yaml").write_text(FINETUNE_EXP)
    return root


@pytest.mark.parametrize("modality,freeze", [("image", False), ("dna", True)])
def test_cli_finetune_writes_the_jax_layout(insect_fixture, tmp_path, capsys, modality, freeze):
    """`finetune --device cpu` on the INSECT fixture: rc 0, the JSON the JAX
    command prints (top-1/3/5 accuracy and the species count), and an
    --output-dir that the JAX package's load_train_state reads, with the
    head at classifier/w [output_dim, C]."""
    root = insect_fixture
    out = tmp_path / "ft"
    argv = ["finetune", "-e", str(root / "exp.yaml"), "--device", "cpu", "--modality", modality,
            "--epochs", "1", "--lr", "1e-3", "--output-dir", str(out),
            f"project_root_path={tmp_path}",
            f"insect_data.path_to_att_splits_mat={root / 'att_splits.mat'}",
            f"insect_data.path_to_res_101_mat={root / 'res101.mat'}",
            f"insect_data.path_to_image_hdf5={root / 'images.hdf5'}",
            f"insect_data.species_to_other={root / 's2o.json'}"]
    if freeze:
        argv.append("--freeze-encoder")
    assert port_cli.main(argv) == 0
    stdout = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("epoch 0: loss ") for line in stdout)
    result = json.loads(stdout[-1])
    assert set(result) == {"top_k_acc", "num_species"} and result["num_species"] == 4
    assert set(result["top_k_acc"]) == {"1", "3", "5"}
    assert all(0.0 <= v <= 1.0 for v in result["top_k_acc"].values())
    params, opt_state, meta = jax_checkpoint.load_train_state(str(out))
    assert opt_state is None and meta["step"] == 0
    assert params["classifier"]["w"].shape == (8, 4) and params["classifier"]["b"].shape == (4,)
    assert {"image_encoder", "dna_encoder", "logit_scale"} <= set(params)
    assert all(np.isfinite(v).all() for v in flatten_pytree(params).values())
