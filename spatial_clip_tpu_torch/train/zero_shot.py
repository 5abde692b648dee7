"""Zero-shot classification (counterpart of ``spatial_clip_tpu.train.zero_shot``).

:func:`build_zero_shot_classifier` embeds classname x template prompts with
the text tower and averages each class's prompts into one unit column;
:func:`zero_shot_eval` scores image features against the classifier (top-1 /
top-5); :func:`imagenet_zero_shot_eval` does both for the 1000 ImageNet
classes and the OpenAI templates, read in place from the JAX package's
``models/zero_shot_metadata.json``. ``params`` is as in
:mod:`spatial_clip_tpu_torch.train.evaluate`.
"""
from __future__ import annotations

import json
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from spatial_clip_tpu_torch.models.config import REFERENCE_MODELS_DIR
from spatial_clip_tpu_torch.models.transforms import normalize_batch
from spatial_clip_tpu_torch.train.evaluate import run_model

METADATA_PATH = REFERENCE_MODELS_DIR / "zero_shot_metadata.json"

OPENAI_IMAGENET_TEMPLATES = tuple(
    (lambda c, f=fmt: f.format(c)) for fmt in (
        "a bad photo of a {}.", "a photo of many {}.", "a photo of the hard to see {}.",
        "a low resolution photo of the {}.", "a bad photo of the {}.",
        "a cropped photo of the {}.", "a photo of a hard to see {}.",
        "a bright photo of a {}.", "a photo of a clean {}.", "a photo of a dirty {}.",
        "a dark photo of the {}.", "a photo of my {}.", "a photo of the cool {}.",
        "a close-up photo of a {}.", "a black and white photo of the {}.", "a photo of a {}.",
        "a photo of the {}.", "a good photo of the {}.", "a photo of one {}.",
        "a photo of a small {}."))

SIMPLE_TEMPLATES = (lambda c: f"a photo of a {c}.",)


def build_zero_shot_classifier(model, params, tokenizer: Callable, classnames: Sequence[str],
                               templates: Sequence[Callable[[str], str]] = SIMPLE_TEMPLATES,
                               num_classes_per_batch: int = 10) -> np.ndarray:
    """(embed_dim, n_classes) f32: per class, the mean of its prompts'
    normalized text embeddings, normalized again (with a 1e-12 floor),
    ``num_classes_per_batch`` classes' prompts a text batch."""
    device = model.logit_scale.device
    n_t = len(templates)
    cols = []
    for i in range(0, len(classnames), num_classes_per_batch):
        names = classnames[i:i + num_classes_per_batch]
        tokens = torch.from_numpy(tokenizer([t(c) for c in names for t in templates])).to(device)
        emb = run_model(model, params, text=tokens)["text_features"].float().cpu().numpy()
        emb = emb.reshape(len(names), n_t, -1).mean(axis=1)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12
        cols.append(emb)
    return np.concatenate(cols).T


def accuracy(logits: np.ndarray, target: np.ndarray, topk=(1,)) -> List[float]:
    """The share of rows whose target is among the k highest logits
    (``np.argsort`` of the negated logits, as JAX's), for each k."""
    order = np.argsort(-logits, axis=1)
    return [float((order[:, :k] == target[:, None]).any(axis=1).mean()) for k in topk]


def zero_shot_eval(model, params, classifier: np.ndarray, loader: Iterable,
                   logit_scale: Optional[float] = None) -> dict:
    """Top-1 / top-5 over a loader of ``{'images', 'label'}`` batches
    (uint8 images are normalized, OpenAI mean and std); ``logit_scale`` is
    accepted as JAX's is, and changes no ranking."""
    device = model.logit_scale.device
    clf = torch.from_numpy(np.asarray(classifier, dtype=np.float32)).to(device)
    n = top1 = top5 = 0
    for batch in loader:
        images = torch.from_numpy(np.asarray(batch["images"])).to(device)
        if images.dtype == torch.uint8:
            images = normalize_batch(images, dtype=model.dtype)
        feats = run_model(model, params, images=images.to(model.dtype))["image_features"]
        logits = (feats.float() @ clf).cpu().numpy()
        target = np.asarray(batch["label"])
        a1, a5 = accuracy(logits, target, topk=(1, min(5, logits.shape[1])))
        top1 += a1 * len(target)
        top5 += a5 * len(target)
        n += len(target)
    return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}


def load_imagenet_metadata(template_set: str = "openai"):
    """(classnames, templates): the 1000 ImageNet class names and the
    ``openai`` or ``simple`` prompt templates, as callables."""
    data = json.loads(METADATA_PATH.read_text())
    key = {"openai": "openai_imagenet_templates", "simple": "simple_imagenet_templates"}[
        template_set]
    return (tuple(data["imagenet_classnames"]),
            tuple((lambda c, f=fmt: f.format(c)) for fmt in data[key]))


def imagenet_zero_shot_eval(model, params, tokenizer: Callable, loader: Iterable,
                            template_set: str = "openai",
                            classnames: Optional[Sequence[str]] = None) -> dict:
    """The 1000-way classifier from the metadata (or ``classnames``), then
    :func:`zero_shot_eval`: ``imagenet-zeroshot-val-top1`` / ``-top5``."""
    meta_names, templates = load_imagenet_metadata(template_set)
    names = tuple(classnames) if classnames is not None else meta_names
    clf = build_zero_shot_classifier(model, params, tokenizer, names, templates)
    res = zero_shot_eval(model, params, clf, loader)
    return {"imagenet-zeroshot-val-top1": res["top1"],
            "imagenet-zeroshot-val-top5": res["top5"]}
