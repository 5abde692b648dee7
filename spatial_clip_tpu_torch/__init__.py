"""PyTorch port of spatial_clip_tpu for NVIDIA Hopper GPUs.

The CLIP towers and CoCa (``models``), hand-written CUDA kernels for every TPU kernel
of the JAX package (``ops``), the losses, the trainer with checkpoints
(``train``), the data layer (``data``), the config composition over the
repository's ``configs/`` (``config``), the entry points
``python -m spatial_clip_tpu_torch.train`` / ``.eval`` and the HTTP server
(``serve``). The JAX package ``spatial_clip_tpu`` is the reference this
package is tested against; this package imports neither it nor JAX.
"""
from spatial_clip_tpu_torch.models.factory import create_model, get_tokenizer

__all__ = ["create_model", "get_tokenizer"]
