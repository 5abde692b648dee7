"""The open_clip-shaped import surface (counterpart of
``spatial_clip_tpu.openclip_api``).

The names a user of open_clip imports, over this package's modules, so
that moving from open_clip is an import swap:

    from spatial_clip_tpu_torch import (create_model_and_transforms, get_tokenizer,
                                        tokenize, ClipLoss, list_pretrained, ...)

The losses are :class:`~spatial_clip_tpu_torch.losses.LossFn` callables
built by ``make_loss``, so open_clip's loss classes are factories with the
same keywords. ``spatial_clip_tpu_torch.__version__`` is this package's own
version; ``openclip_compat_version`` names the open_clip release whose
surface this module follows.
"""
from __future__ import annotations

from typing import Optional

from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models.clip import CLIP
from spatial_clip_tpu_torch.models.coca import CoCa
from spatial_clip_tpu_torch.models.config import (
    TextCfg,
    VisionCfg,
    add_model_config,
    list_model_configs,
    load_model_config,
    register_model_config,
)
from spatial_clip_tpu_torch.models.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from spatial_clip_tpu_torch.models.factory import (
    create_loss,
    create_model,
    create_model_and_transforms,
    get_tokenizer,
    list_models,
    load_checkpoint,
)
from spatial_clip_tpu_torch.models.pretrained import (
    get_pretrained_cfg,
    list_pretrained,
    list_pretrained_tags_by_model,
)
from spatial_clip_tpu_torch.models.push_to_hf_hub import push_pretrained_to_hf_hub, push_to_hf_hub
from spatial_clip_tpu_torch.models.tokenizer import SimpleTokenizer
from spatial_clip_tpu_torch.models.transforms import AugmentationCfg, image_transform

# the open_clip release whose public surface this module follows
openclip_compat_version = "3.1.0"

# open_clip's CustomTextCLIP is the one CLIP module here (it builds the text,
# HF and gene towers from the config); its config dataclasses' names
CustomTextCLIP = CLIP
CLIPVisionCfg = VisionCfg
CLIPTextCfg = TextCfg


def get_model_config(model_name: str) -> Optional[dict]:
    """The raw architecture config of ``model_name``, or None if unknown."""
    try:
        return load_model_config(model_name)
    except (ValueError, FileNotFoundError):
        return None


def list_openai_models() -> list:
    """The model names with an ``openai`` pretrained tag."""
    return [m for m, t in list_pretrained() if t == "openai"]


def list_pretrained_models_by_tag(tag: str) -> list:
    """The model names that carry ``tag``."""
    return sorted({m for m, t in list_pretrained() if t == tag})


def load_openai_model(name: str, precision: str = "bf16", **kwargs):
    """``name`` with OpenAI's weights (its ``openai`` tag: the TorchScript
    archive in the local cache); ``kwargs`` go to :func:`create_model`."""
    if get_pretrained_cfg(name, "openai") is None:
        raise RuntimeError(f"{name} has no OpenAI weights; choose from {list_openai_models()}")
    return create_model(name, pretrained="openai", precision=precision, **kwargs)


def create_model_from_pretrained(model_name: str, pretrained: Optional[str] = None,
                                 return_transform: bool = True, require_pretrained: bool = True,
                                 **kwargs):
    """(model, its evaluation transform) for inference, or the model alone.
    With no ``pretrained`` it raises unless ``require_pretrained=False``:
    an inference constructor does not hand back weights drawn from a seed
    unasked."""
    if pretrained is None and require_pretrained:
        raise RuntimeError(
            f"create_model_from_pretrained({model_name!r}) without pretrained= would return "
            "weights drawn from a seed; pass a tag or a path, or require_pretrained=False")
    model, _, preprocess_val = create_model_and_transforms(model_name, pretrained=pretrained,
                                                           **kwargs)
    return (model, preprocess_val) if return_transform else model


# open_clip's loss classes, as factories of the LossFn with their keywords
def ClipLoss(**kwargs):
    return make_loss("clip", **kwargs)


def CoCaLoss(**kwargs):
    return make_loss("coca", **kwargs)


def DistillClipLoss(**kwargs):
    return make_loss("distill", **kwargs)


def SigLipLoss(**kwargs):
    return make_loss("siglip", **kwargs)


def SpatialLoss(**kwargs):
    return make_loss("spatial", **kwargs)


_DEFAULT_TOKENIZER: Optional[SimpleTokenizer] = None


def _default_tokenizer() -> SimpleTokenizer:
    global _DEFAULT_TOKENIZER
    if _DEFAULT_TOKENIZER is None:
        _DEFAULT_TOKENIZER = SimpleTokenizer()
    return _DEFAULT_TOKENIZER


def tokenize(texts, context_length: int = 77):
    """Token ids of ``texts`` with the module's byte-BPE tokenizer."""
    return _default_tokenizer()(texts, context_length=context_length)


def decode(output_ids):
    """The text of a row of token ids (the inverse of :func:`tokenize`)."""
    import numpy as np

    return _default_tokenizer().decode(np.asarray(output_ids).tolist())


def __getattr__(name: str):
    # the ImageNet tables load from the metadata JSON on first access
    if name in ("IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES"):
        from spatial_clip_tpu_torch.train.zero_shot import load_imagenet_metadata

        classnames, openai_t = load_imagenet_metadata("openai")
        if name == "IMAGENET_CLASSNAMES":
            return tuple(classnames)
        if name == "OPENAI_IMAGENET_TEMPLATES":
            return tuple(openai_t)
        return tuple(load_imagenet_metadata("simple")[1])
    if name in ("build_zero_shot_classifier", "build_zero_shot_classifier_legacy"):
        from spatial_clip_tpu_torch.train import zero_shot

        if name.endswith("legacy"):  # one class a text batch
            import functools

            return functools.partial(zero_shot.build_zero_shot_classifier,
                                     num_classes_per_batch=1)
        return zero_shot.build_zero_shot_classifier
    raise AttributeError(name)
