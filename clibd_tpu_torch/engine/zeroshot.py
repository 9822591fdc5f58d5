# A copy of clibd_tpu/engine/zeroshot.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Zero-shot classification with prompt ensembles (reference
scripts/bioclip/inference_and_eval_with_bioclip.py:22+): per class, embed
the class name under the OpenAI 80-template prompt list (or a custom list),
average + L2-normalize the text embeddings, and classify images by cosine
similarity to the class prototypes.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

# The OpenAI CLIP ImageNet prompt-template ensemble used by the reference's
# BioCLIP baseline (inference_and_eval_with_bioclip.py).
OPENAI_IMAGENET_TEMPLATES: tuple = (
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
)


def build_class_prototypes(
    class_names: Sequence[str],
    encode_text_fn: Callable[[List[str]], np.ndarray],
    templates: Sequence[str] = OPENAI_IMAGENET_TEMPLATES,
    batch_size: int = 256,
) -> np.ndarray:
    """→ [num_classes, D] L2-normalized prototypes: mean over the template
    ensemble of normalized per-prompt embeddings.

    Prompts are batched ACROSS classes (one ~80-prompt class per dispatch
    would mean thousands of tiny device calls at species scale)."""
    n_t = len(templates)
    all_prompts = [t.format(name) for name in class_names for t in templates]
    embs = []
    for lo in range(0, len(all_prompts), batch_size):
        embs.append(np.asarray(encode_text_fn(all_prompts[lo : lo + batch_size])))
    embs = np.concatenate(embs, axis=0)
    embs = embs / np.linalg.norm(embs, axis=-1, keepdims=True)
    embs = embs.reshape(len(class_names), n_t, -1)
    protos = embs.mean(axis=1)
    return protos / np.linalg.norm(protos, axis=-1, keepdims=True)


def zero_shot_classify(
    image_features: np.ndarray,
    prototypes: np.ndarray,
    class_names: Sequence[str],
    max_k: int = 5,
):
    """→ (pred_names [N, k], scores [N, k])."""
    feats = image_features / np.linalg.norm(image_features, axis=-1, keepdims=True)
    scores = feats @ prototypes.T
    order = np.argsort(-scores, axis=1)[:, :max_k]
    top_scores = np.take_along_axis(scores, order, axis=1)
    names = np.asarray(class_names, dtype=object)[order]
    return names, top_scores


def taxon_prompt(label: dict, levels: Sequence[str] = ("order", "family", "genus", "species")) -> str:
    """Taxonomy-aware class string variant (the reference's 4-level text-input
    BioCLIP baseline)."""
    return " ".join(label[lv] for lv in levels)
