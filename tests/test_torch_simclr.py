"""SimCLR in the port against clibd_tpu on the CPU: the NT-Xent losses
(`ops/loss.py`), the deterministic colour ops (`ops/color.py`), one SimCLR
step (`engine/simclr.py`, augmentation stubbed), `python -m clibd_tpu_torch.cli
simclr --device cpu` on the HDF5 fixture writing both checkpoint
directories, and `eval --unimodel` on a SimCLR checkpoint the JAX package
wrote.  Every input comes from a generator seeded here.
"""

import argparse
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clibd_tpu.cli.eval_cmds import cmd_eval as jax_cmd_eval
from clibd_tpu.config import load_config as jax_load_config
from clibd_tpu.engine import checkpoint as jax_checkpoint
from clibd_tpu.engine import simclr as jax_simclr
from clibd_tpu.models import layers as jax_layers
from clibd_tpu.models.clibd import init_clibd_params
from clibd_tpu.models.vit import init_vit_params
from clibd_tpu.ops import color as jax_color
from clibd_tpu.ops import loss as jax_loss
from clibd_tpu.ops.pallas import attention as jax_attention
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.cli.eval_cmds import cmd_eval as port_cmd_eval
from clibd_tpu_torch.engine import checkpoint as port_checkpoint
from clibd_tpu_torch.engine import simclr as port_simclr
from clibd_tpu_torch.engine import train as port_train
from clibd_tpu_torch.models import clibd as port_clibd
from clibd_tpu_torch.models import model_from_jax
from clibd_tpu_torch.models.convert import params_from_jax
from clibd_tpu_torch.models.vit import ViT
from clibd_tpu_torch.ops import color as port_color
from clibd_tpu_torch.ops import loss as port_loss
from tests.torch_tiny import port_tiny_cfg, tiny_cfg

LOSS_ATOL = 1e-5        # fp32 losses and deterministic colour ops
HUE_ATOL = 1e-4         # the HSV round trip divides by small chroma
STEP_LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
# gradients of one step, as tests/test_torch_train_step.py holds them: both
# packages round P to bf16 after fp32 maths, and an entry within float
# noise of a bf16 boundary may round the other way
STEP_GRAD_REL_TOL = 2e-2
STEP_GRAD_COS_MIN = 0.9999
EMBED_COS_MIN = 0.9999


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the tiny model's ops gain
    nothing from more, and the suite's workers would oversubscribe the
    cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("B,D", [(4, 16), (7, 32)])
def test_simclr_losses_match_jax(B, D):
    rng = np.random.default_rng(B * D)
    feats = rng.standard_normal((2 * B, D)).astype(np.float32)
    want = float(jax_loss.simclr_loss(jnp.asarray(feats), 0.1))
    got = port_loss.simclr_loss(torch.from_numpy(feats), 0.1)
    assert abs(float(got) - want) <= LOSS_ATOL
    jl, jlab = jax_loss.simclr_info_nce_loss(jnp.asarray(feats), 0.1)
    pl, plab = port_loss.simclr_info_nce_loss(torch.from_numpy(feats), 0.1)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=LOSS_ATOL)
    assert np.array_equal(plab.numpy(), np.asarray(jlab)) and plab.dtype == torch.int32
    # the masked-diagonal form is CE(logits, 0)
    ce = torch.nn.functional.cross_entropy(pl, plab.long())
    assert abs(float(ce) - float(got)) <= LOSS_ATOL


def _images(seed, B=3, S=16):
    rng = np.random.default_rng(seed)
    images = rng.random((B, S, S, 3), dtype=np.float32)
    images[0, :4] = images[0, :4, :, :1]  # gray pixels: zero chroma
    return images, rng.uniform(0.2, 1.8, B).astype(np.float32), \
        rng.uniform(-0.2, 0.2, B).astype(np.float32)


@pytest.mark.parametrize("op", ["brightness", "contrast", "saturation", "hue", "grayscale",
                                "blur5", "blur21"])
def test_deterministic_color_ops_match_jax(op):
    images, factor, delta = _images(len(op))
    ti, tf, td = (torch.from_numpy(x) for x in (images, factor, delta))
    if op == "hue":
        got, want = port_color.adjust_hue(ti, td), jax_color.adjust_hue(images, delta)
    elif op == "grayscale":
        got, want = port_color.rgb_to_grayscale(ti), jax_color.rgb_to_grayscale(images)
    elif op.startswith("blur"):
        k = int(op[4:])
        got = port_color.gaussian_blur(torch.Generator(), ti, k, (0.7, 0.7))
        want = jax_color.gaussian_blur(jax.random.PRNGKey(0), jnp.asarray(images), k, (0.7, 0.7))
    else:
        fn = f"adjust_{op}"
        got, want = getattr(port_color, fn)(ti, tf), getattr(jax_color, fn)(images, factor)
    tol = HUE_ATOL if op == "hue" else LOSS_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_simclr_augment_draws_from_its_generator():
    images = torch.from_numpy(_images(1, B=6, S=32)[0])

    def run(seed):
        return port_color.simclr_augment(torch.Generator().manual_seed(seed), images, size=32)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == images.shape and torch.isfinite(a).all()
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(port_color.random_color_jitter(torch.Generator(), images, p=0.0), images)
    assert torch.equal(port_color.random_grayscale(torch.Generator(), images, p=1.0),
                       port_color.rgb_to_grayscale(images))


def _simclr_cfgs():
    jcfg, pcfg = tiny_cfg(disable_lora=True), port_tiny_cfg(disable_lora=True)
    for cfg in (jcfg, pcfg):
        cfg.dna.enable = cfg.language.enable = False
    return jcfg, pcfg


def test_simclr_step_matches_jax(monkeypatch):
    """One SimCLR step from the same ViT weights and views, augmentation
    stubbed on both sides, JAX's attention through its Pallas kernels in
    interpret mode: the loss and the gradients agree, and so do the params
    after each package's Adam update at the unimodel recipe's LR."""
    monkeypatch.setattr(jax_layers, "ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_attention, "ATTN_BWD_IMPL", "pallas")
    monkeypatch.setattr(jax_simclr, "simclr_augment", lambda key, x, size: x)
    monkeypatch.setattr(port_simclr, "simclr_augment", lambda gen, x, size: x)
    jcfg, pcfg = _simclr_cfgs()
    tree = jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(4), jcfg.image.vit,
                                                     output_dim=64, lora_rank=0))
    rng = np.random.default_rng(11)
    v1, v2 = (rng.random((4, 32, 32, 3), dtype=np.float32) for _ in range(2))
    lr, wd = 1e-6, 1e-4  # unimodel_training_with_1m/unimodel_image_1m.yaml
    jopt = optax.chain(optax.add_decayed_weights(wd), optax.scale_by_adam(),
                       optax.scale_by_learning_rate(lr))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstep = jax_simclr.make_simclr_step(jcfg, jopt, temperature=0.1)
    new_params, _, jloss = jstep(jparams, jopt.init(jparams), jnp.asarray(v1), jnp.asarray(v2),
                                 jax.random.PRNGKey(0))
    capture = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))
    _, jgrads, _ = jax_simclr.make_simclr_step(jcfg, capture, temperature=0.1)(
        jparams, capture.init(jparams), jnp.asarray(v1), jnp.asarray(v2), jax.random.PRNGKey(0))

    model = ViT(pcfg.image.vit, output_dim=64)
    model.load_state_dict(params_from_jax(tree))
    opt = port_train.ScheduledAdam(model.parameters(), lambda i: lr, weight_decay=wd)
    loss_fn = port_simclr.make_simclr_loss_fn(pcfg, model, temperature=0.1)
    loss = loss_fn(torch.from_numpy(v1), torch.from_numpy(v2), None)
    loss.backward()
    opt.step()
    assert abs(float(loss.detach()) - float(jloss)) <= STEP_LOSS_RTOL * abs(float(jloss))
    jg = {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    jp = {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(new_params)}
    for n, p in model.named_parameters():
        key = n.replace(".", "/")
        got, want = p.grad.numpy().ravel().astype(np.float64), jg[key].ravel().astype(np.float64)
        assert np.abs(got - want).max() <= STEP_GRAD_REL_TOL * np.abs(want).max() + 1e-9, n
        if np.abs(want).max() > 0:
            assert got @ want / (np.linalg.norm(got) * np.linalg.norm(want)) >= STEP_GRAD_COS_MIN
        np.testing.assert_allclose(p.detach().numpy(), jp[key], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


TINY_SIMCLR_EXP = """
model_output_name: tiny_simclr
dataset: bioscan_1m
batch_size: 4
epochs: 2
output_dim: 32
disable_lora: true
amp: false
default_seed: 42
dna: {enable: false}
language: {enable: false}
optim:
  lr_config: {lr: 1.0e-4}
  weight_decay: 1.0e-4
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 2, num_heads: 2,
        mlp_dim: 128}
"""


def test_cli_simclr_writes_both_checkpoints(tiny_hdf5, tmp_path):
    """`simclr --device cpu` over the fixture's two-view batches for two
    epochs: checkpoint_0000/, checkpoint_0001/ and model_best/, each with the
    ViT's params under the JAX keys (read back bit for bit by both packages'
    backbone loaders) and the SimCLR chain's optax state."""
    exp = tmp_path / "tiny_simclr.yaml"
    exp.write_text(TINY_SIMCLR_EXP)
    out = tmp_path / "simclr"
    assert port_cli.main(["simclr", "-e", str(exp), "--hdf5", tiny_hdf5, "--device", "cpu",
                          "--output-dir", str(out), "pipeline.num_workers=0",
                          "pipeline.use_native_decoder=false"]) == 0
    for sub in ("checkpoint_0000", "checkpoint_0001", "model_best"):
        assert (out / sub / "params.npz").exists() and (out / sub / "opt_state.npz").exists()
    meta = json.loads((out / "model_best" / "meta.json").read_text())
    steps = [json.loads((out / f"checkpoint_000{e}" / "meta.json").read_text())["step"]
             for e in (0, 1)]
    assert np.isfinite(meta["loss"]) and steps[0] > 0 and steps[1] == 2 * steps[0]
    assert meta["step"] == steps[meta["epoch"]]

    jcfg = jax_load_config(experiment=str(exp)).model_config
    vit = jax.tree.map(np.asarray, init_vit_params(jax.random.PRNGKey(0), jcfg.image.vit,
                                                    output_dim=32, lora_rank=0))
    chain = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(),
                        optax.scale_by_learning_rate(lambda step: 1e-4))
    with np.load(out / "model_best" / "opt_state.npz") as f:
        flat = {k: f[k] for k in f.files}
    assert set(flat) == set(jax_checkpoint._flatten_with_paths(chain.init(vit)))
    assert int(flat["1/count"]) == meta["step"]
    with np.load(out / "model_best" / "params.npz") as f:
        saved = {k: f[k] for k in f.files}
    encoder = ViT(type(port_tiny_cfg().image.vit)(**vars(jcfg.image.vit)), output_dim=32)
    port_clibd.load_simclr_vit_backbone(str(out / "model_best"), encoder)
    for n, p in encoder.named_parameters():
        if not n.startswith("head."):
            assert np.array_equal(p.detach().numpy(), saved[n.replace(".", "/")]), n
    from clibd_tpu.models.clibd import load_simclr_vit_backbone as jax_load_backbone

    loaded = jax_load_backbone(str(out / "model_best"), vit, jcfg)
    assert np.array_equal(np.asarray(loaded["blocks"]["qkv_w"]), saved["blocks/qkv_w"])


TINY_UNIMODEL_EXP = """
model_output_name: tiny_unimodel
dataset: bioscan_1m
batch_size: 5
output_dim: 32
disable_lora: true
amp: false
default_seed: 42
image:
  vit: {image_size: 224, patch_size: 32, hidden_size: 64, num_layers: 2, num_heads: 2,
        mlp_dim: 128}
"""


def test_eval_unimodel_matches_jax(tiny_hdf5, tmp_path, monkeypatch):
    """`eval --unimodel` on a SimCLR checkpoint the JAX package wrote, in
    each package over the fixture: the image embeddings agree (cosine per
    row) and so does the grid.  The fresh head of the image-only model is
    drawn by each package's own generator, so the port's init is given the
    JAX init's weights here; the backbone goes through the port's loader."""
    exp = tmp_path / "tiny_unimodel.yaml"
    exp.write_text(TINY_UNIMODEL_EXP)
    jcfg = jax_load_config(experiment=str(exp)).model_config
    vit = init_vit_params(jax.random.PRNGKey(9), jcfg.image.vit, output_dim=32, lora_rank=0)
    vit = jax.tree.map(lambda x: np.asarray(x) * 3.0, vit)  # away from the fresh init
    chain = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(),
                        optax.scale_by_learning_rate(lambda step: 1e-4))
    ckpt = str(tmp_path / "simclr" / "model_best")
    jax_checkpoint.save_train_state(ckpt, vit, chain.init(vit), epoch=0, meta={"loss": 1.0})

    def fresh_as_jax(mc, generator, device):
        import copy

        jmc = copy.deepcopy(jcfg)
        jmc.dna.enable = jmc.language.enable = False
        tree = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(mc.default_seed),
                                                          jmc))
        model = model_from_jax(tree, mc, device)
        port_clibd.load_simclr_vit_backbone(mc.image.simclr_ckpt_path, model.image_encoder)
        return model

    monkeypatch.setattr(port_clibd, "init_clibd_model", fresh_as_jax)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    folders = {}
    for name, run in (("jax", jax_cmd_eval), ("port", port_cmd_eval)):
        root = tmp_path / name
        args = argparse.Namespace(experiment=str(exp), global_config=None, hdf5=tiny_hdf5,
                                  unimodel=ckpt, device="cpu")
        assert run(args, [f"project_root_path={root}", "pipeline.num_workers=0",
                          "inference_and_eval_setting.plot_embeddings=false"]) == 0
        folders[name] = root / "extracted_embedding" / "bioscan_1m" / "tiny_unimodel_unimodel"
    import h5py

    def read(folder):
        with h5py.File(folder / "extracted_feature_from_test_split.hdf5") as f:
            return {f"{g}/{k}": np.asarray(f[g][k]) for g in f for k in f[g]
                    if f[g][k].dtype.kind == "f"}

    want, got = read(folders["jax"]), read(folders["port"])
    assert set(got) == set(want) and not any("dna" in k or "language" in k for k in got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(np.linalg.norm(got[k], axis=-1), 1.0, atol=1e-5)
        cos = (got[k] * want[k]).sum(-1) / (np.linalg.norm(got[k], axis=-1)
                                            * np.linalg.norm(want[k], axis=-1))
        assert cos.min() >= EMBED_COS_MIN, (k, cos.min())
    grids = [json.loads((folders[n] / "acc_dict_test.json").read_text()) for n in ("jax", "port")]
    assert grids[0] == grids[1] and grids[0]
