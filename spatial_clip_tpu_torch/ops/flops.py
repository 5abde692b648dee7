"""Model cost counts and block-index helpers (counterpart of
``spatial_clip_tpu.ops.flops``).

:func:`profile_model` reports a model's parameters and its GFLOPs per
example, with the JAX package's keys and rounding. The JAX package takes
them from XLA's cost analysis of the compiled function; here they are
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the model's
function, op by op, best on a copy of the model on the ``meta`` device
(shapes only: no memory, no card, every config at full width; the kernel
wrappers run their plain versions there). The count covers the products
(matmuls, convolutions, attention), not the elementwise work XLA also
counts, so it runs a little under XLA's (ViT-B-32: 0.4% / 0.6% for the
image / text tower). It is a count of the model's function, not of the
hand-written kernels, which no dispatch mode sees.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    """The number of parameter elements."""
    return sum(p.numel() for p in model.parameters())


class ByteCounter(TorchDispatchMode):
    """Sums, over every op dispatched inside it (views excepted, which move
    nothing), the bytes of its tensor operands and results: XLA's
    ``bytes accessed`` definition applied to the unfused graph of ops, not
    XLA's number for its fused program, which is smaller."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def example_inputs(model, batch_size: int = 1):
    """Zero images (B, size, size, 3) in the compute dtype and zero text
    ids (B, context_length), or zero gene vectors (B, num_genes), on the
    model's device."""
    cfg = model.cfg
    device = model.logit_scale.device
    size = int(cfg.vision_cfg.size)
    images = torch.zeros((batch_size, size, size, 3), dtype=model.dtype, device=device)
    if cfg.gene_cfg is not None:
        text = torch.zeros((batch_size, cfg.gene_cfg.num_genes), dtype=torch.float32,
                           device=device)
    else:
        text = torch.zeros((batch_size, cfg.text_cfg.context_length), dtype=torch.long,
                           device=device)
    return images, text


def cost(fn, *args) -> Dict[str, float]:
    """``{"flops": ..., "bytes accessed": ...}`` of ``fn(*args)``."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(nbytes.bytes)}


def _train_fwd_bwd(model, images, text):
    """The gradient of the CLIP loss over the model's logits (the JAX
    package's ``train_fwd_bwd``), every parameter taking a gradient."""
    params = list(model.parameters())
    grads = [p.requires_grad for p in params]
    try:
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            out = model(images, text)
            z = out["image_features"] @ out["text_features"].T * out["logit_scale"]
            labels = torch.arange(z.shape[0], device=z.device)
            loss = -torch.log_softmax(z.float(), dim=-1)[labels, labels].mean()
            torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        for p, g in zip(params, grads):
            p.requires_grad_(g)


def profile_model(model, batch_size: int = 1, train: bool = False) -> Dict[str, Any]:
    """GFLOPs and MParams of ``model`` per example, with the JAX package's
    keys and rounding: ``model``, ``image_size``, ``mparams``,
    ``image_gflops`` (``encode_image``), ``text_gflops`` (``encode_text``),
    ``gflops`` (the forward of both), ``bytes_accessed_mb`` (the forward's,
    :class:`ByteCounter`) and, with ``train``, ``train_gflops`` (forward
    and backward of the CLIP loss). Best run on a ``meta`` model."""
    images, text = example_inputs(model, batch_size)
    with torch.no_grad():
        img = cost(model.encode_image, images)
        txt = cost(model.encode_text, text)
        both = cost(model, images, text)
    result = {
        "model": getattr(model, "model_name", ""),
        "image_size": model.cfg.vision_cfg.image_size,
        "mparams": round(count_params(model) / 1e6, 2),
        "image_gflops": round(img["flops"] / batch_size / 1e9, 3),
        "text_gflops": round(txt["flops"] / batch_size / 1e9, 3),
        "gflops": round(both["flops"] / batch_size / 1e9, 3),
        "bytes_accessed_mb": round(both["bytes accessed"] / 1e6, 1),
    }
    if train:
        result["train_gflops"] = round(
            cost(_train_fwd_bwd, model, images, text)["flops"] / batch_size / 1e9, 3)
    return result


def feature_take_indices(num_blocks: int, indices) -> list:
    """The block ids a ``*_indices`` argument names: None every block, an
    int n the last n blocks, a sequence its ids with negatives wrapped."""
    if indices is None:
        return list(range(num_blocks))
    if isinstance(indices, int):
        return list(range(num_blocks - indices, num_blocks))
    return [i if i >= 0 else num_blocks + i for i in indices]
