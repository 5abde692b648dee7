"""Tar-shard dataset backend (counterpart of
``spatial_clip_tpu.data.datasets.shard_backend``; webdataset-format reader).

Reads the Stage-3 output layout (docs/data_pipeline.md):
``dataset_root/<SAMPLE_ID>/<SAMPLE>_NNNNNN.tar`` containing ``{key}.png`` /
``{key}.txt`` (gene sentence) / ``{key}.json`` (``{sample_id, x, y}``)
triplets. Pillow is imported inside the functions that decode.

Design:
- tars are indexed once (member name -> (tar_path, offset, size)); item reads
  are direct ``pread``-style seeks, safe under the threaded loader.
- the k-NN neighbor graph is built per sample from the (x, y) spot
  coordinates (KD-tree) with inverse-distance alphas normalized so the
  nearest neighbor has alpha=1, and cached as an ``.npz`` keyed by a content
  fingerprint (``cache_dir`` / ``rebuild_cache`` kwargs per the test
  contract).
- tile ids are globally sequential over the (sorted) keys so anchors and
  neighbors share one id space, as the loss requires.
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import tarfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from spatial_clip_tpu_torch.models.transforms import skip_draws

log = logging.getLogger(__name__)


def _index_tar(tar_path: Path):
    """name -> (offset_data, size) for every regular member.

    Uses the C++ indexer (native/tarindex.cpp) when built — ~20x faster
    startup on large shard sets — falling back to Python tarfile."""
    from spatial_clip_tpu_torch.data.datasets._native import index_tar_native

    native = index_tar_native(str(tar_path))
    if native is not None:
        return native
    out = {}
    with tarfile.open(tar_path) as tf:
        for m in tf:
            if m.isfile():
                out[m.name] = (m.offset_data, m.size)
    return out


class ShardedSpatialDataset:
    def __init__(
        self,
        dataset_root: Union[str, Path],
        split: str,
        sample_ids: Sequence[str],
        k_neighbors: int,
        preprocess_fn: Optional[Callable] = None,
        tokenizer: Optional[Callable] = None,
        cache_dir: Optional[Union[str, Path]] = None,
        rebuild_cache: bool = False,
    ):
        self.dataset_root = Path(dataset_root)
        self.split = split
        self.sample_ids = list(sample_ids)
        self.k_neighbors = k_neighbors
        self.preprocess_fn = preprocess_fn
        self.tokenizer = tokenizer
        self.cache_dir = Path(cache_dir) if cache_dir else self.dataset_root / ".neighbor_cache"

        # ---- index all tar members, grouped by key, ordered per sample
        self._entries: List[Dict] = []  # key, sample_id, png/txt/json locators
        tar_list = []
        for sid in self.sample_ids:
            sdir = self.dataset_root / sid
            if not sdir.exists():
                raise FileNotFoundError(f"sample dir not found: {sdir}")
            tar_list.extend(sorted(sdir.glob("*.tar")))
        members: Dict[str, Dict[str, tuple]] = {}
        for tp in tar_list:
            for name, loc in _index_tar(tp).items():
                stem, dot, ext = name.rpartition(".")
                if not dot:
                    continue
                members.setdefault(stem, {})[ext] = (str(tp), *loc)
        for key in sorted(members):
            grp = members[key]
            if ("png" in grp or "npy" in grp) and "txt" in grp:
                self._entries.append({"key": key, **grp})
        if not self._entries:
            raise ValueError(f"no samples found under {self.dataset_root}")

        # global sequential tile ids
        self._tile_ids = np.arange(len(self._entries), dtype=np.int64)
        self._graph = self._load_or_build_graph(rebuild_cache, tar_list)

    # ------------------------------------------------------------------ graph
    def _fingerprint(self, tar_list: List[Path]) -> str:
        h = hashlib.sha256()
        for tp in tar_list:
            st = tp.stat()
            h.update(f"{tp}:{st.st_size}:{int(st.st_mtime)}".encode())
        h.update(f"k={self.k_neighbors}".encode())
        return h.hexdigest()[:16]

    def _read_bytes(self, loc: tuple) -> bytes:
        path, offset, size = loc
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(size)

    def _load_or_build_graph(self, rebuild: bool, tar_list: List[Path]):
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        cache = self.cache_dir / f"knn_{self.split}_{self._fingerprint(tar_list)}.npz"
        if cache.exists() and not rebuild:
            data = np.load(cache)
            return {"ids": data["ids"], "alphas": data["alphas"]}

        # per-sample KD-tree over spot coordinates
        coords = np.zeros((len(self._entries), 2), dtype=np.float64)
        samples = np.empty(len(self._entries), dtype=object)
        for i, e in enumerate(self._entries):
            if "json" in e:
                meta = json.loads(self._read_bytes(e["json"]))
                coords[i] = (float(meta.get("x", 0)), float(meta.get("y", 0)))
                samples[i] = meta.get("sample_id", "")
            else:
                samples[i] = ""
        k = self.k_neighbors
        nbr_ids = np.full((len(self._entries), k), -1, dtype=np.int64)
        nbr_alphas = np.zeros((len(self._entries), k), dtype=np.float32)
        from scipy.spatial import cKDTree

        for sid in set(samples.tolist()):
            mask = samples == sid
            idxs = np.nonzero(mask)[0]
            if len(idxs) < 2:
                continue
            tree = cKDTree(coords[idxs])
            kk = min(k + 1, len(idxs))
            dists, nn = tree.query(coords[idxs], k=kk)
            # drop self (column 0), inverse-distance alphas normalized to the
            # nearest neighbor
            for row, gi in enumerate(idxs):
                d = dists[row, 1:]
                cols = nn[row, 1:]
                valid = np.isfinite(d) & (d > 0)
                d, cols = d[valid], cols[valid]
                if len(d) == 0:
                    continue
                alphas = d.min() / d
                take = min(len(d), k)
                nbr_ids[gi, :take] = self._tile_ids[idxs[cols[:take]]]
                nbr_alphas[gi, :take] = alphas[:take]
        np.savez(cache, ids=nbr_ids, alphas=nbr_alphas)
        log.info("Built k-NN neighbor cache: %s", cache)
        return {"ids": nbr_ids, "alphas": nbr_alphas}

    # ------------------------------------------------------------------ items
    def __len__(self) -> int:
        return len(self._entries)

    def skip_item(self, idx: int) -> None:
        """Advances the host transform's random state as ``self[idx]``
        would, reading the image's size from the raw tile's npy header or
        the encoded image's header only (a rank skips the rows of a global
        batch that other ranks take)."""
        from PIL import Image

        def size():
            e = self._entries[idx]
            if "npy" in e:
                path, offset, _ = e["npy"]
                with open(path, "rb") as f:
                    f.seek(offset)
                    version = np.lib.format.read_magic(f)
                    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                            else np.lib.format.read_array_header_2_0)
                    h, w = read(f)[0][:2]
                return w, h
            with Image.open(io.BytesIO(self._read_bytes(e["png"]))) as im:
                return im.size

        skip_draws(self.preprocess_fn, size)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image

        e = self._entries[idx]
        if "npy" in e:  # raw uint8 tile: no decode cost
            arr = np.load(io.BytesIO(self._read_bytes(e["npy"])), allow_pickle=False)
            img = arr if self.preprocess_fn is None else Image.fromarray(arr)
        else:
            raw = self._read_bytes(e["png"])
            # native libpng/libjpeg decode — engaged ONLY when it replaces
            # the PIL trip entirely (no transform, or a val transform whose
            # ndarray fast path returns target-size RGB8 untouched); the
            # measured A/B shows decode-native-then-wrap-in-PIL is neutral
            # (docs/experiments.md round-5). PIL handles everything else.
            from spatial_clip_tpu_torch.data.native_decode import (
                decode_rgb,
                decode_rgb_into,
            )

            img = None
            if self.preprocess_fn is None:
                img = decode_rgb(raw)
            else:
                fast = getattr(self.preprocess_fn, "ndarray_fast_size", None)
                if fast is not None:
                    out = np.empty((*fast, 3), np.uint8)
                    if decode_rgb_into(raw, out):
                        img = out
            if img is None:
                img = Image.open(io.BytesIO(raw)).convert("RGB")
        image = self.preprocess_fn(img) if self.preprocess_fn else np.asarray(img)
        sentence = self._read_bytes(e["txt"]).decode("utf-8")
        if self.tokenizer is not None:
            text = np.asarray(self.tokenizer([sentence])[0])
        else:
            text = np.zeros(8, dtype=np.int32)
        return {
            "image": image,
            "text": text,
            "raw_text": sentence,
            "anchor_tile_id": int(self._tile_ids[idx]),
            "neighbor_tile_ids": self._graph["ids"][idx].tolist(),
            "neighbor_alphas": self._graph["alphas"][idx].tolist(),
        }
