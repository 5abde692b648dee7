"""PyTorch port of spatial_clip_tpu for NVIDIA Hopper GPUs.

The CLIP towers and CoCa (``models``), hand-written CUDA kernels for every TPU kernel
of the JAX package (``ops``), the losses, the trainer with checkpoints
(``train``), the data layer (``data``), the config composition over the
repository's ``configs/`` (``config``), the entry points
``python -m spatial_clip_tpu_torch.train`` / ``.eval``, the HTTP server
(``serve``) and its client (``client``). The package exports the
open_clip-shaped surface (``openclip_api``): the same names as
``spatial_clip_tpu``. The JAX package ``spatial_clip_tpu`` is the reference
this package is tested against; this package imports neither it nor JAX.
"""

__version__ = "0.1.0"

from spatial_clip_tpu_torch.losses import make_loss  # noqa: F401
from spatial_clip_tpu_torch.models.factory import (  # noqa: F401
    create_loss,
    create_model,
    create_model_and_transforms,
    get_tokenizer,
    list_models,
)
from spatial_clip_tpu_torch.openclip_api import (  # noqa: F401
    CLIP,
    AugmentationCfg,
    ClipLoss,
    CLIPTextCfg,
    CLIPVisionCfg,
    CoCa,
    CoCaLoss,
    CustomTextCLIP,
    DistillClipLoss,
    OPENAI_DATASET_MEAN,
    OPENAI_DATASET_STD,
    SigLipLoss,
    SimpleTokenizer,
    SpatialLoss,
    add_model_config,
    create_model_from_pretrained,
    decode,
    get_model_config,
    image_transform,
    list_openai_models,
    list_pretrained,
    list_pretrained_models_by_tag,
    list_pretrained_tags_by_model,
    load_checkpoint,
    load_openai_model,
    push_pretrained_to_hf_hub,
    push_to_hf_hub,
    register_model_config,
    tokenize,
)


def __getattr__(name: str):
    # the ImageNet tables and zero-shot builders, forwarded on first access
    if name in ("IMAGENET_CLASSNAMES", "OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES",
                "build_zero_shot_classifier", "build_zero_shot_classifier_legacy"):
        from spatial_clip_tpu_torch import openclip_api

        return getattr(openclip_api, name)
    raise AttributeError(name)
