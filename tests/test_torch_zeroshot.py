"""`zeroshot` in the port against clibd_tpu on the CPU: the copied prompt
ensemble functions, the class prototypes of both packages' CLIP text towers
in fp32, and both commands in their three modes (per level, --four-level,
--image-to-image) on the HDF5 fixture from one open_clip state dict and one
BPE merges file written here (`chip_smoke.open_clip_state_dict`,
`chip_smoke.write_bpe_merges`), in the commands' bf16.  Every input comes
from a generator seeded here.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from clibd_tpu.cli import main as jax_main
from clibd_tpu.engine import zeroshot as jax_zeroshot
from clibd_tpu.models import clip as jax_clip
from clibd_tpu_torch import cli as port_cli
from clibd_tpu_torch.cli.eval_cmds import cmd_zeroshot
from clibd_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from clibd_tpu_torch.engine import zeroshot as port_zeroshot
from clibd_tpu_torch.models import clip as port_clip
from clibd_tpu_torch.models.convert import params_from_jax

QUERIES = 12    # rows of the fixture's test_seen split
PROTO_ATOL = 1e-5
# the state dict's weights (not its LayerNorms or biases) times this: at
# N(0, 0.02) every fixture image maps to the same direction (pairwise
# cosine > 0.99999) and retrieval is decided by near-ties; at 20x the
# images' pairwise cosines spread over [-0.6, 0.9]
WEIGHT_SCALE = 20.0

VISION = dict(image_size=224, patch_size=32, hidden_size=24, num_layers=1, num_heads=3,
              mlp_dim=48, embed_dim=16)
TEXT = dict(vocab_size=49408, context_length=16, hidden_size=16, num_layers=1, num_heads=2,
            mlp_dim=32, embed_dim=16)

ZEROSHOT_EXP = """
backbone: open_clip
dataset: bioscan_1m
batch_size: 6
load_ckpt: false
clip:
  image_size: 224
  patch_size: 32
  vision_hidden: 24
  vision_layers: 1
  vision_heads: 3
  vision_mlp: 48
  context_length: 16
  text_hidden: 16
  text_layers: 1
  text_heads: 2
  text_mlp: 32
  embed_dim: 16
  checkpoint: {ckpt}
  bpe_path: {bpe}
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the suite's workers would
    oversubscribe the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("zeroshot")
    vcfg, tcfg = port_clip.CLIPVisionConfig(**VISION), port_clip.CLIPTextConfig(**TEXT)
    sd = chip_smoke.open_clip_state_dict(vcfg, tcfg, torch.Generator().manual_seed(4))
    for k, v in sd.items():
        if v.ndim >= 2 or k == "visual.class_embedding":
            sd[k] = v * WEIGHT_SCALE
    torch.save(sd, str(root / "clip.pt"))
    chip_smoke.write_bpe_merges(str(root / "bpe.txt.gz"))
    (root / "exp.yaml").write_text(ZEROSHOT_EXP.format(ckpt=root / "clip.pt",
                                                       bpe=root / "bpe.txt.gz"))
    return root, {k: v.numpy() for k, v in sd.items()}


def test_prompt_ensemble_functions_equal_jax():
    rng = np.random.default_rng(3)
    table = {}

    def encode(prompts):  # a deterministic embedding of each prompt
        return np.stack([table.setdefault(p, rng.standard_normal(8).astype(np.float32))
                         for p in prompts])

    names = [f"species_{i}" for i in range(7)]
    templates = port_zeroshot.OPENAI_IMAGENET_TEMPLATES
    assert templates == jax_zeroshot.OPENAI_IMAGENET_TEMPLATES and len(templates) == 80
    got = port_zeroshot.build_class_prototypes(names, encode, batch_size=33)
    want = jax_zeroshot.build_class_prototypes(names, encode, batch_size=33)
    assert np.array_equal(got, want)
    feats = rng.standard_normal((10, 8)).astype(np.float32)
    for a, b in zip(port_zeroshot.zero_shot_classify(feats, got, names, max_k=3),
                    jax_zeroshot.zero_shot_classify(feats, want, names, max_k=3)):
        assert np.array_equal(a, b)
    label = {"order": "Diptera", "family": "Sciaridae", "genus": "Bradysia", "species": "sp_1"}
    assert port_zeroshot.taxon_prompt(label) == jax_zeroshot.taxon_prompt(label)


def test_prototypes_of_both_text_towers_agree_in_fp32(clip_files):
    root, sd = clip_files
    vcfg, tcfg = jax_clip.CLIPVisionConfig(**VISION), jax_clip.CLIPTextConfig(**TEXT)
    _, jtext, _ = jax_clip.clip_params_from_state_dict(sd, vcfg, tcfg)
    ptcfg = port_clip.CLIPTextConfig(**TEXT)
    _, ttree, _ = port_clip.clip_params_from_state_dict(sd, port_clip.CLIPVisionConfig(**VISION),
                                                        ptcfg)
    ptext = port_clip.CLIPText(ptcfg)
    ptext.load_state_dict(params_from_jax(ttree))
    tok = CLIPTokenizer(str(root / "bpe.txt.gz"), context_length=16)

    def jax_encode(prompts):
        return np.asarray(jax_clip.clip_text_apply(jtext, jnp.asarray(tok(prompts)), tcfg,
                                                   compute_dtype=jnp.float32))

    def port_encode(prompts):
        with torch.inference_mode():
            return ptext(torch.from_numpy(tok(prompts)), torch.float32).numpy()

    names = ["species 1", "order diptera", "family sciaridae genus bradysia", "sp"]
    want = jax_zeroshot.build_class_prototypes(names, jax_encode)
    got = port_zeroshot.build_class_prototypes(names, port_encode)
    assert got.shape == (4, 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROTO_ATOL)


def _close(got, want, what=""):
    """The same JSON: equal strings and keys, numbers within one query's share."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, float):
        assert abs(got - want) <= 1.0 / QUERIES + 1e-9, (what, got, want)
    else:
        assert got == want, what


@pytest.mark.parametrize("mode", [["--level", "genus"], ["--four-level"], ["--image-to-image"]])
def test_cli_zeroshot_matches_jax(clip_files, tiny_hdf5, capsys, mode):
    root = clip_files[0]
    out = {}
    for name, run, extra in (("jax", jax_main, []), ("port", port_cli.main, ["--device", "cpu"])):
        assert run(["zeroshot", "-e", str(root / "exp.yaml"), "--hdf5", tiny_hdf5,
                    "--split", "test_seen", "--keys-split", "all_keys", *mode, *extra,
                    "pipeline.num_workers=0", "pipeline.use_native_decoder=false"]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _close(out["port"], out["jax"])
    if mode[0] == "--level":
        assert out["port"]["num_classes"] == 3 and out["port"]["level"] == "genus"


def test_zeroshot_needs_the_checkpoint_and_the_bpe_file(clip_files):
    root = clip_files[0]
    args = argparse.Namespace(experiment=str(root / "exp.yaml"), global_config=None, hdf5=None,
                              device="cpu", split="test_seen", keys_split="all_keys",
                              level="species", batch_size=64, four_level=False,
                              image_to_image=False)
    for override in ("model_config.clip.bpe_path=", "model_config.clip.checkpoint="):
        with pytest.raises(SystemExit, match="clip.checkpoint and .bpe_path"):
            cmd_zeroshot(args, [override])
