"""PyTorch port of spatial_clip_tpu for NVIDIA Hopper GPUs.

The slice ported so far is the embedding server's path: the CLIP towers'
inference (``models``), the fused attention forward as a hand-written CUDA
kernel (``ops``) and the HTTP server (``serve``). The JAX package
``spatial_clip_tpu`` is the reference this package is tested against; this
package imports neither it nor JAX.
"""
from spatial_clip_tpu_torch.models.factory import create_model, get_tokenizer

__all__ = ["create_model", "get_tokenizer"]
