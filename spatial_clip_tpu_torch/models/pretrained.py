"""The pretrained-weight registry, resolved from local files only.

The same (model, tag) registry as ``spatial_clip_tpu.models.pretrained``
(open_clip's published checkpoints: the URL of each and its preprocessing
contract, mean / std / interpolation / resize_mode and quick_gelu), kept
here as this package's own copy. A tag resolves to a local file and never
to a download: to its URL where that is a local path or a ``file://`` URL,
else to the JAX package's cache name ``{model}-{tag}-{sha256(url)[:16]}.bin``
under ``$SPATIAL_CLIP_CACHE`` (default ``~/.cache/spatial_clip_tpu``), so
both packages read one cache. Where that file is missing,
:func:`download_pretrained` raises FileNotFoundError naming the file and the
URL to fetch it from; nothing falls back to weights drawn from a seed.
"""
from __future__ import annotations

import copy
import hashlib
import os
from pathlib import Path
from typing import Dict, Optional

from spatial_clip_tpu_torch.models.constants import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    INCEPTION_MEAN,
    INCEPTION_STD,
)

_HF_URL = "https://huggingface.co/{repo}/resolve/main/{filename}"

# the preprocess keys a tag may pin; the rest of a tag's dict says where its
# weights come from. The defaults (OpenAI mean / std, bicubic, shortest) are
# PreprocessCfg's: tags record deviations. No "size": the input size is the
# model config's (vision_cfg.image_size), not the tag's.
PREPROCESS_KEYS = ("mean", "std", "interpolation", "resize_mode", "fill_color")


def _hf(repo: str, filename: str = "open_clip_pytorch_model.bin", **kw) -> Dict:
    return {"url": _HF_URL.format(repo=repo, filename=filename), **kw}


def _openai(name: str) -> Dict:
    """OpenAI's CLIP TorchScript archives (``format: openai``; the factory
    takes the scripted module's state dict). All were trained with
    QuickGELU."""
    return {
        "url": f"https://openaipublic.azureedge.net/clip/models/{name}",
        "format": "openai",
        "quick_gelu": True,
    }


def _gh(name: str, **kw) -> Dict:
    """open_clip's v0.2 release assets."""
    return {
        "url": "https://github.com/mlfoundations/open_clip/releases/download/"
        f"v0.2-weights/{name}",
        **kw,
    }


def _metaclip(name: str, **kw) -> Dict:
    """MetaCLIP checkpoints (quick-gelu unless stated otherwise)."""
    return {
        "url": f"https://dl.fbaipublicfiles.com/MMPT/metaclip/{name}",
        "quick_gelu": kw.pop("quick_gelu", True),
        **kw,
    }


def _siglip(repo: str) -> Dict:
    """SigLIP preprocessing contract: inception norm + squash resize."""
    return _hf(repo, mean=INCEPTION_MEAN, std=INCEPTION_STD,
               interpolation="bicubic", resize_mode="squash")


def _clipa(repo: str) -> Dict:
    """CLIPA contract: imagenet norm + bilinear squash."""
    return _hf(repo, mean=IMAGENET_MEAN, std=IMAGENET_STD,
               interpolation="bilinear", resize_mode="squash")


def _mobileclip(repo: str) -> Dict:
    """MobileCLIP contract: identity norm + bilinear."""
    return _hf(repo, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
               interpolation="bilinear", resize_mode="shortest")


def _pe(repo: str) -> Dict:
    """Perception-Encoder contract: 0.5 norm + bilinear squash."""
    return _hf(repo, mean=INCEPTION_MEAN, std=INCEPTION_STD,
               interpolation="bilinear", resize_mode="squash")


# the tag registry, model name -> tag -> its config: open_clip's published
# checkpoints. Every URL is an open_clip torch state dict unless ``format``
# says otherwise (``openai``: a TorchScript archive).
_PRETRAINED: Dict[str, Dict[str, Dict]] = {
    "RN50": {
        "openai": _openai("afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt"),
        "yfcc15m": _gh("rn50-quickgelu-yfcc15m-455df137.pt", quick_gelu=True),
        "cc12m": _gh("rn50-quickgelu-cc12m-f000538c.pt", quick_gelu=True),
    },
    "RN101": {
        "openai": _openai("8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt"),
        "yfcc15m": _gh("rn101-quickgelu-yfcc15m-3e04b30e.pt", quick_gelu=True),
    },
    "RN50x4": {"openai": _openai("7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt")},
    "RN50x16": {"openai": _openai("52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt")},
    "RN50x64": {"openai": _openai("be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt")},
    "ViT-B-32": {
        "openai": _openai("40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt"),
        "laion400m_e31": _gh("vit_b_32-quickgelu-laion400m_e31-d867053b.pt", quick_gelu=True),
        "laion400m_e32": _gh("vit_b_32-quickgelu-laion400m_e32-46683a32.pt", quick_gelu=True),
        "laion2b_e16": _gh("vit_b_32-laion2b_e16-af8dbd0c.pth"),
        "laion2b_s34b_b79k": _hf("laion/CLIP-ViT-B-32-laion2B-s34B-b79K"),
        "datacomp_xl_s13b_b90k": _hf("laion/CLIP-ViT-B-32-DataComp.XL-s13B-b90K"),
        "datacomp_m_s128m_b4k": _hf("laion/CLIP-ViT-B-32-DataComp.M-s128M-b4K"),
        "commonpool_m_clip_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M.clip-s128M-b4K"),
        "commonpool_m_laion_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M.laion-s128M-b4K"),
        "commonpool_m_image_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M.image-s128M-b4K"),
        "commonpool_m_text_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M.text-s128M-b4K"),
        "commonpool_m_basic_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M.basic-s128M-b4K"),
        "commonpool_m_s128m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.M-s128M-b4K"),
        "datacomp_s_s13m_b4k": _hf("laion/CLIP-ViT-B-32-DataComp.S-s13M-b4K"),
        "commonpool_s_clip_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S.clip-s13M-b4K"),
        "commonpool_s_laion_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S.laion-s13M-b4K"),
        "commonpool_s_image_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S.image-s13M-b4K"),
        "commonpool_s_text_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S.text-s13M-b4K"),
        "commonpool_s_basic_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S.basic-s13M-b4K"),
        "commonpool_s_s13m_b4k": _hf("laion/CLIP-ViT-B-32-CommonPool.S-s13M-b4K"),
        "metaclip_400m": _metaclip("b32_400m.pt"),
        "metaclip_fullcc": _metaclip("b32_fullcc2.5b.pt"),
    },
    "ViT-B-32-256": {
        "datacomp_s34b_b86k": _hf("laion/CLIP-ViT-B-32-256x256-DataComp-s34B-b86K"),
    },
    "ViT-B-16": {
        "openai": _openai("5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt"),
        "laion400m_e31": _gh("vit_b_16-laion400m_e31-00efa78f.pt"),
        "laion400m_e32": _gh("vit_b_16-laion400m_e32-55e67d44.pt"),
        "laion2b_s34b_b88k": _hf("laion/CLIP-ViT-B-16-laion2B-s34B-b88K"),
        "datacomp_xl_s13b_b90k": _hf("laion/CLIP-ViT-B-16-DataComp.XL-s13B-b90K"),
        "datacomp_l_s1b_b8k": _hf("laion/CLIP-ViT-B-16-DataComp.L-s1B-b8K"),
        "commonpool_l_clip_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L.clip-s1B-b8K"),
        "commonpool_l_laion_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L.laion-s1B-b8K"),
        "commonpool_l_image_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L.image-s1B-b8K"),
        "commonpool_l_text_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L.text-s1B-b8K"),
        "commonpool_l_basic_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L.basic-s1B-b8K"),
        "commonpool_l_s1b_b8k": _hf("laion/CLIP-ViT-B-16-CommonPool.L-s1B-b8K"),
        "dfn2b": _hf("apple/DFN2B-CLIP-ViT-B-16", quick_gelu=True),
        "metaclip_400m": _metaclip("b16_400m.pt"),
        "metaclip_fullcc": _metaclip("b16_fullcc2.5b.pt"),
    },
    "ViT-B-16-plus-240": {
        "laion400m_e31": _gh("vit_b_16_plus_240-laion400m_e31-8fb26589.pt"),
        "laion400m_e32": _gh("vit_b_16_plus_240-laion400m_e32-699c4b84.pt"),
    },
    "ViT-L-14": {
        "openai": _openai("b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt"),
        "laion400m_e31": _gh("vit_l_14-laion400m_e31-69988bb6.pt"),
        "laion400m_e32": _gh("vit_l_14-laion400m_e32-3d133497.pt"),
        "laion2b_s32b_b82k": _hf("laion/CLIP-ViT-L-14-laion2B-s32B-b82K",
                                 mean=INCEPTION_MEAN, std=INCEPTION_STD),
        "datacomp_xl_s13b_b90k": _hf("laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90K"),
        "commonpool_xl_clip_s13b_b90k": _hf("laion/CLIP-ViT-L-14-CommonPool.XL.clip-s13B-b90K"),
        "commonpool_xl_laion_s13b_b90k": _hf("laion/CLIP-ViT-L-14-CommonPool.XL.laion-s13B-b90K"),
        "commonpool_xl_s13b_b90k": _hf("laion/CLIP-ViT-L-14-CommonPool.XL-s13B-b90K"),
        "metaclip_400m": _metaclip("l14_400m.pt"),
        "metaclip_fullcc": _metaclip("l14_fullcc2.5b.pt"),
        "dfn2b": _hf("apple/DFN2B-CLIP-ViT-L-14", quick_gelu=True),
        "dfn2b_s39b": _hf("apple/DFN2B-CLIP-ViT-L-14-39B"),
    },
    "ViT-L-14-336": {
        "openai": _openai("3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt"),
    },
    "ViT-H-14": {
        "laion2b_s32b_b79k": _hf("laion/CLIP-ViT-H-14-laion2B-s32B-b79K"),
        "metaclip_fullcc": _metaclip("h14_fullcc2.5b.pt"),
        "metaclip_altogether": _metaclip("h14_v1.2_altogether.pt", quick_gelu=False),
        "dfn5b": _hf("apple/DFN5B-CLIP-ViT-H-14", quick_gelu=True,
                     interpolation="bicubic", resize_mode="squash"),
    },
    "ViT-H-14-378": {
        "dfn5b": _hf("apple/DFN5B-CLIP-ViT-H-14-378", quick_gelu=True,
                     interpolation="bicubic", resize_mode="squash"),
    },
    "ViT-g-14": {
        "laion2b_s12b_b42k": _hf("laion/CLIP-ViT-g-14-laion2B-s12B-b42K"),
        "laion2b_s34b_b88k": _hf("laion/CLIP-ViT-g-14-laion2B-s34B-b88K"),
    },
    "ViT-bigG-14": {
        "laion2b_s39b_b160k": _hf("laion/CLIP-ViT-bigG-14-laion2B-39B-b160k"),
        "metaclip_fullcc": _metaclip("G14_fullcc2.5b.pt"),
    },
    "roberta-ViT-B-32": {
        "laion2b_s12b_b32k": _hf("laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k"),
    },
    "xlm-roberta-base-ViT-B-32": {
        "laion5b_s13b_b90k": _hf("laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k"),
    },
    "xlm-roberta-large-ViT-H-14": {
        "frozen_laion5b_s13b_b90k": _hf("laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k"),
    },
    "convnext_base": {
        "laion400m_s13b_b51k": _hf("laion/CLIP-convnext_base-laion400M-s13B-b51K"),
    },
    "convnext_base_w": {
        "laion2b_s13b_b82k": _hf("laion/CLIP-convnext_base_w-laion2B-s13B-b82K"),
        "laion2b_s13b_b82k_augreg": _hf("laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg"),
        "laion_aesthetic_s13b_b82k": _hf("laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K"),
    },
    "convnext_base_w_320": {
        "laion_aesthetic_s13b_b82k": _hf("laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K"),
        "laion_aesthetic_s13b_b82k_augreg": _hf("laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-augreg"),
    },
    "convnext_large_d": {
        "laion2b_s26b_b102k_augreg": _hf("laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg"),
    },
    "convnext_large_d_320": {
        "laion2b_s29b_b131k_ft": _hf("laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft"),
        "laion2b_s29b_b131k_ft_soup": _hf("laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup"),
    },
    "convnext_xxlarge": {
        "laion2b_s34b_b82k_augreg": _hf("laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg"),
        "laion2b_s34b_b82k_augreg_rewind": _hf("laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind"),
        "laion2b_s34b_b82k_augreg_soup": _hf("laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup"),
    },
    "coca_ViT-B-32": {
        "laion2b_s13b_b90k": _hf("laion/CoCa-ViT-B-32-laion2B-s13B-b90k"),
        "mscoco_finetuned_laion2b_s13b_b90k": _hf("laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k"),
    },
    "coca_ViT-L-14": {
        "laion2b_s13b_b90k": _hf("laion/CoCa-ViT-L-14-laion2B-s13B-b90k"),
        "mscoco_finetuned_laion2b_s13b_b90k": _hf("laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k"),
    },
    "EVA01-g-14": {
        "laion400m_s11b_b41k": _hf("timm/eva_giant_patch14_clip_224.laion400m_s11b_b41k"),
    },
    "EVA01-g-14-plus": {
        "merged2b_s11b_b114k": _hf("timm/eva_giant_patch14_plus_clip_224.merged2b_s11b_b114k"),
    },
    "EVA02-B-16": {"merged2b_s8b_b131k": _hf("timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k")},
    "EVA02-L-14": {"merged2b_s4b_b131k": _hf("timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k")},
    "EVA02-L-14-336": {"merged2b_s6b_b61k": _hf("timm/eva02_large_patch14_clip_336.merged2b_s6b_b61k")},
    "EVA02-E-14": {"laion2b_s4b_b115k": _hf("timm/eva02_enormous_patch14_clip_224.laion2b_s4b_b115k")},
    "EVA02-E-14-plus": {"laion2b_s9b_b144k": _hf("timm/eva02_enormous_patch14_plus_clip_224.laion2b_s9b_b144k")},
    "ViT-B-16-SigLIP": {"webli": _siglip("timm/ViT-B-16-SigLIP")},
    "ViT-B-16-SigLIP-256": {"webli": _siglip("timm/ViT-B-16-SigLIP-256")},
    "ViT-B-16-SigLIP-i18n-256": {"webli": _siglip("timm/ViT-B-16-SigLIP-i18n-256")},
    "ViT-B-16-SigLIP-384": {"webli": _siglip("timm/ViT-B-16-SigLIP-384")},
    "ViT-B-16-SigLIP-512": {"webli": _siglip("timm/ViT-B-16-SigLIP-512")},
    "ViT-L-16-SigLIP-256": {"webli": _siglip("timm/ViT-L-16-SigLIP-256")},
    "ViT-L-16-SigLIP-384": {"webli": _siglip("timm/ViT-L-16-SigLIP-384")},
    "ViT-SO400M-14-SigLIP": {"webli": _siglip("timm/ViT-SO400M-14-SigLIP")},
    "ViT-SO400M-16-SigLIP-i18n-256": {"webli": _siglip("timm/ViT-SO400M-16-SigLIP-i18n-256")},
    # open_clip's 378 tag: the 384 weights at another input size
    "ViT-SO400M-14-SigLIP-378": {"webli": _siglip("timm/ViT-SO400M-14-SigLIP-384")},
    "ViT-SO400M-14-SigLIP-384": {"webli": _siglip("timm/ViT-SO400M-14-SigLIP-384")},
    "ViT-B-32-SigLIP2-256": {"webli": _siglip("timm/ViT-B-32-SigLIP2-256")},
    "ViT-B-16-SigLIP2": {"webli": _siglip("timm/ViT-B-16-SigLIP2")},
    "ViT-B-16-SigLIP2-256": {"webli": _siglip("timm/ViT-B-16-SigLIP2-256")},
    "ViT-B-16-SigLIP2-384": {"webli": _siglip("timm/ViT-B-16-SigLIP2-384")},
    "ViT-B-16-SigLIP2-512": {"webli": _siglip("timm/ViT-B-16-SigLIP2-512")},
    "ViT-L-16-SigLIP2-256": {"webli": _siglip("timm/ViT-L-16-SigLIP2-256")},
    "ViT-L-16-SigLIP2-384": {"webli": _siglip("timm/ViT-L-16-SigLIP2-384")},
    "ViT-L-16-SigLIP2-512": {"webli": _siglip("timm/ViT-L-16-SigLIP2-512")},
    "ViT-SO400M-14-SigLIP2": {"webli": _siglip("timm/ViT-SO400M-14-SigLIP2")},
    "ViT-SO400M-14-SigLIP2-378": {"webli": _siglip("timm/ViT-SO400M-14-SigLIP2-378")},
    "ViT-SO400M-16-SigLIP2-256": {"webli": _siglip("timm/ViT-SO400M-16-SigLIP2-256")},
    "ViT-SO400M-16-SigLIP2-384": {"webli": _siglip("timm/ViT-SO400M-16-SigLIP2-384")},
    "ViT-SO400M-16-SigLIP2-512": {"webli": _siglip("timm/ViT-SO400M-16-SigLIP2-512")},
    "ViT-gopt-16-SigLIP2-256": {"webli": _siglip("timm/ViT-gopt-16-SigLIP2-256")},
    "ViT-gopt-16-SigLIP2-384": {"webli": _siglip("timm/ViT-gopt-16-SigLIP2-384")},
    "ViT-L-14-CLIPA": {"datacomp1b": _clipa("UCSC-VLAA/ViT-L-14-CLIPA-datacomp1B")},
    "ViT-L-14-CLIPA-336": {"datacomp1b": _clipa("UCSC-VLAA/ViT-L-14-CLIPA-336-datacomp1B")},
    "ViT-H-14-CLIPA": {"datacomp1b": _clipa("UCSC-VLAA/ViT-H-14-CLIPA-datacomp1B")},
    "ViT-H-14-CLIPA-336": {
        "laion2b": _clipa("UCSC-VLAA/ViT-H-14-CLIPA-336-laion2B"),
        "datacomp1b": _clipa("UCSC-VLAA/ViT-H-14-CLIPA-336-datacomp1B"),
    },
    "ViT-bigG-14-CLIPA": {"datacomp1b": _clipa("UCSC-VLAA/ViT-bigG-14-CLIPA-datacomp1B")},
    "ViT-bigG-14-CLIPA-336": {"datacomp1b": _clipa("UCSC-VLAA/ViT-bigG-14-CLIPA-336-datacomp1B")},
    "nllb-clip-base": {"v1": _hf("visheratin/nllb-clip-base-oc")},
    "nllb-clip-large": {"v1": _hf("visheratin/nllb-clip-large-oc")},
    "nllb-clip-base-siglip": {
        "v1": _siglip("visheratin/nllb-clip-base-siglip"),
        "mrl": _siglip("visheratin/nllb-siglip-mrl-base"),
    },
    "nllb-clip-large-siglip": {
        "v1": _siglip("visheratin/nllb-clip-large-siglip"),
        "mrl": _siglip("visheratin/nllb-siglip-mrl-large"),
    },
    "MobileCLIP-S1": {"datacompdr": _mobileclip("apple/MobileCLIP-S1-OpenCLIP")},
    "MobileCLIP-S2": {"datacompdr": _mobileclip("apple/MobileCLIP-S2-OpenCLIP")},
    "MobileCLIP-B": {
        "datacompdr": _mobileclip("apple/MobileCLIP-B-OpenCLIP"),
        "datacompdr_lt": _mobileclip("apple/MobileCLIP-B-LT-OpenCLIP"),
    },
    "ViTamin-S": {"datacomp1b": _hf("jienengchen/ViTamin-S", "pytorch_model.bin")},
    "ViTamin-S-LTT": {"datacomp1b": _hf("jienengchen/ViTamin-S-LTT", "pytorch_model.bin")},
    "ViTamin-B": {"datacomp1b": _hf("jienengchen/ViTamin-B", "pytorch_model.bin")},
    "ViTamin-B-LTT": {"datacomp1b": _hf("jienengchen/ViTamin-B-LTT", "pytorch_model.bin")},
    "ViTamin-L": {"datacomp1b": _hf("jienengchen/ViTamin-L-224px", "pytorch_model.bin")},
    "ViTamin-L-256": {"datacomp1b": _hf("jienengchen/ViTamin-L-256px", "pytorch_model.bin")},
    "ViTamin-L-336": {"datacomp1b": _hf("jienengchen/ViTamin-L-336px", "pytorch_model.bin")},
    "ViTamin-L-384": {"datacomp1b": _hf("jienengchen/ViTamin-L-384px", "pytorch_model.bin")},
    "ViTamin-L2": {"datacomp1b": _hf("jienengchen/ViTamin-L2-224px", "pytorch_model.bin")},
    "ViTamin-L2-256": {"datacomp1b": _hf("jienengchen/ViTamin-L2-256px", "pytorch_model.bin")},
    "ViTamin-L2-336": {"datacomp1b": _hf("jienengchen/ViTamin-L2-336px", "pytorch_model.bin")},
    "ViTamin-L2-384": {"datacomp1b": _hf("jienengchen/ViTamin-L2-384px", "pytorch_model.bin")},
    "ViTamin-XL-256": {"datacomp1b": _hf("jienengchen/ViTamin-XL-256px", "pytorch_model.bin")},
    "ViTamin-XL-336": {"datacomp1b": _hf("jienengchen/ViTamin-XL-336px", "pytorch_model.bin")},
    "ViTamin-XL-384": {"datacomp1b": _hf("jienengchen/ViTamin-XL-384px", "pytorch_model.bin")},
    "PE-Core-T-16-384": {"meta": _pe("timm/PE-Core-T-16-384")},
    "PE-Core-S-16-384": {"meta": _pe("timm/PE-Core-S-16-384")},
    "PE-Core-B-16": {"meta": _pe("timm/PE-Core-B-16")},
    "PE-Core-L-14-336": {"meta": _pe("timm/PE-Core-L-14-336")},
    "PE-Core-bigG-14-448": {"meta": _pe("timm/PE-Core-bigG-14-448")},
    "ViT-L-14-worldwide": {
        "metaclip2_worldwide": _hf("timm/vit_large_patch14_clip_224.metaclip2_worldwide",
                                   quick_gelu=True),
    },
    "ViT-H-14-worldwide": {
        "metaclip2_worldwide": _hf("timm/vit_huge_patch14_clip_224.metaclip2_worldwide",
                                   quick_gelu=True),
    },
    "ViT-H-14-worldwide-378": {
        "metaclip2_worldwide": _hf("timm/vit_huge_patch14_clip_378.metaclip2_worldwide",
                                   resize_mode="squash"),
    },
    "ViT-bigG-14-worldwide": {
        "metaclip2_worldwide": _hf("timm/vit_gigantic_patch14_clip_224.metaclip2_worldwide"),
    },
    "ViT-bigG-14-worldwide-378": {
        "metaclip2_worldwide": _hf("timm/vit_gigantic_patch14_clip_378.metaclip2_worldwide",
                                   resize_mode="squash"),
    },
}

# a '<model>-quickgelu' alias for every tag trained with QuickGELU: the alias
# names resolve to the '-quickgelu' model configs (the activation pinned in
# the architecture)
_quickgelu_models: Dict[str, Dict[str, Dict]] = {}
for _model, _tags in _PRETRAINED.items():
    _qg = {t: copy.deepcopy(c) for t, c in _tags.items() if c.get("quick_gelu")}
    if _qg:
        _quickgelu_models[_model + "-quickgelu"] = _qg
_PRETRAINED.update(_quickgelu_models)


def list_pretrained():
    """Every (model, tag) pair."""
    return [(m, t) for m, tags in _PRETRAINED.items() for t in tags]


def register_pretrained(model_name: str, tag: str, url: str, **cfg) -> None:
    """Register a (model, tag) -> weights mapping at run time. ``url`` is a
    local path, a ``file://`` URL, or a remote URL whose file the cache
    must already hold; the keywords become the tag's config (quick_gelu,
    mean / std / interpolation / resize_mode, ...)."""
    _PRETRAINED.setdefault(model_name, {})[tag] = {"url": url, **cfg}


def list_pretrained_tags_by_model(model_name: str):
    return sorted(_PRETRAINED.get(model_name, {}))


def get_pretrained_cfg(model_name: str, tag: str) -> Optional[Dict]:
    return _PRETRAINED.get(model_name, {}).get(tag)


def preprocess_overrides(tag_cfg: Optional[Dict]) -> Dict:
    """The preprocess keys a tag pins (:data:`PREPROCESS_KEYS`), which the
    factory merges into the model's ``PreprocessCfg``."""
    if not tag_cfg:
        return {}
    return {k: tag_cfg[k] for k in PREPROCESS_KEYS if k in tag_cfg}


def default_cache_dir() -> Path:
    """``$SPATIAL_CLIP_CACHE``, default ``~/.cache/spatial_clip_tpu``."""
    return Path(os.environ.get("SPATIAL_CLIP_CACHE", Path.home() / ".cache" / "spatial_clip_tpu"))


def cache_path(model_name: str, tag: str, url: str, cache: Optional[str] = None) -> Path:
    """Where the cache holds a tag's weights: the JAX package's name,
    ``{model}-{tag}-{sha256(url)[:16]}.bin``."""
    digest = hashlib.sha256(url.encode()).hexdigest()[:16]
    return Path(cache or default_cache_dir()) / f"{model_name}-{tag}-{digest}.bin"


def download_pretrained(model_name: str, tag: str, cache_dir: Optional[str] = None) -> str:
    """The local file a registry tag resolves to: its URL where that is a
    local path or a ``file://`` URL that exists, else its file in the cache
    (:func:`cache_path`). Nothing is downloaded: an unknown tag raises
    KeyError, a tag whose file is not there FileNotFoundError naming the
    file and the URL."""
    cfg = get_pretrained_cfg(model_name, tag)
    if cfg is None:
        raise KeyError(f"no pretrained tag {tag!r} for model {model_name!r}; its tags: "
                       f"{list_pretrained_tags_by_model(model_name)}")
    url = cfg["url"]
    local = url[len("file://"):] if url.startswith("file://") else url
    if Path(local).exists():
        return local
    target = cache_path(model_name, tag, url, cache_dir)
    if target.is_file():
        return str(target)
    raise FileNotFoundError(
        f"pretrained {model_name}:{tag}: {target} does not exist, and this package downloads "
        f"nothing; fetch {url} to that path (or set $SPATIAL_CLIP_CACHE to the directory that "
        f"holds it)")
