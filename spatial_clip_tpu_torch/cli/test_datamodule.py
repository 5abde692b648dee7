"""Datamodule smoke check (counterpart of
``spatial_clip_tpu.cli.test_datamodule``): builds the datamodule from the
composed training config with a stand-in preprocess and tokenizer, takes
one training batch, checks its shapes, and copies it to the run's device as
the trainer does (pinned memory, then the card).

    python -m spatial_clip_tpu_torch.cli.test_datamodule data=synthetic

The device is the training entry's: the GPU unless ``trainer.platform=cpu``;
with no GPU it raises.
"""
from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    import torch

    from spatial_clip_tpu_torch.config import instantiate
    from spatial_clip_tpu_torch.train.entry import compose_train, resolve_device

    cfg = compose_train(list(argv if argv is not None else sys.argv[1:]))
    device = resolve_device(cfg)
    dm = instantiate(cfg["data"])
    dm.preprocess_fn = lambda img: np.asarray(img, dtype=np.uint8)
    dm.tokenizer = lambda texts: [np.ones(16, dtype=np.int32) for _ in texts]
    dm.prepare_data()
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))
    B, k = dm.batch_size, dm.k_neighbors
    assert batch["images"].shape[0] == B, batch["images"].shape
    assert batch["neighbor_tile_ids"].shape == (B, k)
    assert batch["neighbor_alphas"].shape == (B, k)
    assert batch["image_tile_ids"].shape == (B,)
    on_device = {key: (torch.from_numpy(v).pin_memory() if device.type == "cuda"
                       else torch.from_numpy(v)).to(device)
                 for key, v in batch.items() if isinstance(v, np.ndarray)}
    assert all(torch.equal(t.cpu(), torch.from_numpy(batch[key])) for key, t in on_device.items())
    print(f"datamodule ok: images {batch['images'].shape} texts {batch['texts'].shape} "
          f"neighbors {batch['neighbor_tile_ids'].shape}, on {device}")
    return batch


if __name__ == "__main__":
    main()
