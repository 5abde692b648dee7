"""``python -m spatial_clip_tpu_torch.train experiment=... key=value``: see
:mod:`spatial_clip_tpu_torch.train.entry`."""
from spatial_clip_tpu_torch.train.entry import main

if __name__ == "__main__":
    main()
