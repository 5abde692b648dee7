"""Export a model in the Hugging Face hub's open_clip layout
(counterpart of ``spatial_clip_tpu.models.push_to_hf_hub``).

:func:`save_for_hf` writes the layout to a local directory:
``open_clip_config.json`` (``model_cfg`` and ``preprocess_cfg``) and the
weights as ``open_clip_pytorch_model.bin``, which open_clip, the JAX package
and this package (``local-dir:<dir>``, or a snapshot ``hf-hub:`` name)
read. Uploading is left out of this package (ROADMAP Queue 1 item 11):
:func:`push_to_hf_hub` and :func:`push_pretrained_to_hf_hub` keep the JAX
package's names and signatures and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from spatial_clip_tpu_torch.train.checkpoints import export_torch_state_dict

UPLOAD_NOT_PORTED = ("uploading to the Hugging Face hub is left out of spatial_clip_tpu_torch "
                     "(ROADMAP Queue 1 item 11); write the layout with save_for_hf() and upload "
                     "it with the hub's own tools")


def save_for_hf(model, params: Optional[Dict[str, torch.Tensor]], save_directory,
                model_card: Optional[str] = None) -> Path:
    """Write ``model``'s hub layout to ``save_directory``:
    ``open_clip_config.json`` with its architecture as ``model_cfg``
    (``embed_dim``, the tower configs, ``quick_gelu``, and
    ``init_logit_bias``, ``gene_cfg``, ``multimodal_cfg`` where set) and its
    ``preprocess_cfg``; ``params`` (a state dict; None: the model's own) as
    ``open_clip_pytorch_model.bin`` in float32; ``model_card`` as
    ``README.md`` where given. Returns the directory."""
    cfg = model.cfg
    model_cfg = {"embed_dim": cfg.embed_dim, "vision_cfg": dataclasses.asdict(cfg.vision_cfg),
                 "text_cfg": dataclasses.asdict(cfg.text_cfg), "quick_gelu": cfg.quick_gelu}
    if cfg.init_logit_bias is not None:
        model_cfg["init_logit_bias"] = cfg.init_logit_bias
    for key in ("gene_cfg", "multimodal_cfg"):
        if getattr(cfg, key) is not None:
            model_cfg[key] = dataclasses.asdict(getattr(cfg, key))
    pp = dataclasses.asdict(model.preprocess_cfg)
    pp["mean"], pp["std"] = list(pp["mean"]), list(pp["std"])
    d = Path(save_directory)
    d.mkdir(parents=True, exist_ok=True)
    export_torch_state_dict(model.state_dict() if params is None else params,
                            d / "open_clip_pytorch_model.bin")
    (d / "open_clip_config.json").write_text(json.dumps(
        {"model_cfg": model_cfg, "preprocess_cfg": pp}, indent=2, default=str))
    if model_card:
        (d / "README.md").write_text(model_card)
    return d


def push_to_hf_hub(bundle, params, repo_id: str, commit_message: str = "Add model",
                   private: bool = False, token: Optional[str] = None):
    raise NotImplementedError(UPLOAD_NOT_PORTED)


def push_pretrained_to_hf_hub(model_name, pretrained: str, repo_id: str, precision: str = "fp32",
                              commit_message: str = "Add model", token: Optional[str] = None,
                              private: bool = False, **kwargs):
    raise NotImplementedError(UPLOAD_NOT_PORTED)
