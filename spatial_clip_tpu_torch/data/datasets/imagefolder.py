"""Class-folder image dataset for zero-shot classification (counterpart of
``spatial_clip_tpu.data.datasets.imagefolder``).

Layout: ``root/<class_name>/*.{jpg,jpeg,png,bmp,webp}``; labels follow the
sorted class names (numerically when every name is a number, as
ImageNetV2's ``0`` ... ``999``). ``max_per_class`` keeps a seeded subsample
of each class. Batches carry ``images`` and ``label``, which
``train/zero_shot.py`` takes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from spatial_clip_tpu_torch.models.transforms import skip_draws

_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


class ImageFolderDataset:
    def __init__(self, root: Union[str, Path], preprocess_fn: Optional[Callable] = None,
                 max_per_class: Optional[int] = None, seed: int = 0):
        self.root = Path(root)
        self.preprocess_fn = preprocess_fn
        names = [d.name for d in self.root.iterdir() if d.is_dir()]
        self.classes = (sorted(names, key=int) if names and all(n.isdigit() for n in names)
                        else sorted(names))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        rng = np.random.default_rng(seed)
        self.items: List = []
        for c in self.classes:
            files = sorted(p for p in (self.root / c).iterdir() if p.suffix.lower() in _EXTS)
            if max_per_class is not None and len(files) > max_per_class:
                keep = rng.permutation(len(files))[:max_per_class]
                files = [files[i] for i in sorted(keep)]
            self.items.extend((p, self.class_to_idx[c]) for p in files)

    def __len__(self) -> int:
        return len(self.items)

    def skip_item(self, idx: int) -> None:
        """Advances the host transform's random state as ``self[idx]``
        would, reading the image's size from its header only (a rank skips
        the rows of a global batch that other ranks take)."""
        from PIL import Image

        def size():
            with Image.open(self.items[idx][0]) as im:
                return im.size

        skip_draws(self.preprocess_fn, size)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        path, label = self.items[idx]
        img = Image.open(path).convert("RGB")
        image = self.preprocess_fn(img) if self.preprocess_fn else np.asarray(img)
        return {"image": image, "label": int(label)}


def collate_classification(items: List[Dict]) -> Dict[str, np.ndarray]:
    return {
        "images": np.stack([np.asarray(it["image"]) for it in items]),
        "label": np.asarray([it["label"] for it in items], dtype=np.int64),
    }


def get_imagenet_loader(root: Union[str, Path], preprocess_fn: Callable, batch_size: int = 64,
                        max_per_class: Optional[int] = 50, num_workers: int = 0):
    """(loader over every image, 50 a class by default, in order; the class
    names)."""
    from spatial_clip_tpu_torch.data.datamodule import DataLoader

    ds = ImageFolderDataset(root, preprocess_fn, max_per_class=max_per_class)
    loader = DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False,
                        num_workers=num_workers, collate_fn=collate_classification)
    return loader, ds.classes
