"""CLIP towers, tokenizers, preprocessing and the model factory."""
