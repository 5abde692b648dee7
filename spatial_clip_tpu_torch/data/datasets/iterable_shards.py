"""Streaming tar-shard dataset: sequential reads, no index (counterpart of
``spatial_clip_tpu.data.datasets.iterable_shards``).

For datasets larger than local disk or on network storage, as open_clip's
webdataset pipeline streams them:

- the shard list (``{000000..000009}`` brace ranges, or globs) is shuffled
  alike on every rank from ``seed + epoch``, and rank r takes
  ``shards[r::world_size]``;
- each tar is read sequentially, and its members grouped by key;
- samples pass through a bounded shuffle buffer;
- a corrupt member, sample or shard is logged and skipped.

A ``.npy`` image is a decoded array. With a transform it must be an (H, W,
3) uint8 array; any other array raises ValueError naming the sample (the
JAX package wraps it in ``Image.fromarray`` inside its per-sample
isolation, so such a sample is dropped with a warning). Without a
transform the array passes as it is.

The spatial neighbor graph needs random access, so this backend serves
plain CLIP-style training (no neighbors); ShardedSpatialDataset serves the
spatial loss.
"""
from __future__ import annotations

import glob
import io
import json
import logging
import re
import tarfile
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

log = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def braceexpand(s: str) -> List[str]:
    """Numeric brace expansion, ``'{000000..000009}'`` (the subset the
    webdataset shard names use)."""
    m = _BRACE_RE.search(s)
    if not m:
        return [s]
    lo, hi = m.group(1), m.group(2)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(braceexpand(s[: m.start()] + f"{i:0{len(lo)}d}" + s[m.end():]))
    return out


def expand_shard_urls(spec: Union[str, Sequence[str]]) -> List[str]:
    """Brace-expand ``'shard-{000000..000009}.tar'`` specs (space-separated,
    a ``::`` weight suffix ignored); a pattern with ``*`` or ``?`` globs."""
    specs = spec.split("::")[0].split() if isinstance(spec, str) else list(spec)
    out: List[str] = []
    for s in specs:
        expanded = braceexpand(s)
        if len(expanded) == 1 and ("*" in s or "?" in s):
            out.extend(glob.glob(s))
        else:
            out.extend(expanded)
    return out


class _BadSample(ValueError):
    """A sample the transform cannot take: raised, never skipped."""


class IterableTarDataset:
    """Iterates (image, text, meta) samples from tar shards, streaming;
    ``rank`` of ``world_size`` reads its share of the shards."""

    def __init__(self, shards: Union[str, Sequence[str]], preprocess_fn: Optional[Callable] = None,
                 tokenizer: Optional[Callable] = None, shuffle_buffer: int = 0, seed: int = 0,
                 split_by_process: bool = True, k_neighbors: int = 1, rank: int = 0,
                 world_size: int = 1):
        self.shards = sorted(expand_shard_urls(shards))
        if not self.shards:
            raise ValueError("no shards matched")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.preprocess_fn = preprocess_fn
        self.tokenizer = tokenizer
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.split_by_process = split_by_process
        self.k_neighbors = max(k_neighbors, 1)
        self.rank, self.world_size = rank, world_size
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _my_shards(self) -> List[str]:
        shards = list(self.shards)
        np.random.default_rng(self.seed + self._epoch).shuffle(shards)  # alike on every rank
        if self.split_by_process and self.world_size > 1:
            shards = shards[self.rank::self.world_size]
        return shards

    def _iter_raw(self) -> Iterator[dict]:
        counter = 0
        for shard in self._my_shards():
            try:
                with tarfile.open(shard) as tf:
                    group: dict = {}
                    key = None
                    for m in tf:
                        if not m.isfile():
                            continue
                        stem, _, ext = m.name.rpartition(".")
                        if key is not None and stem != key and group:
                            sample = self._build(key, group, counter)
                            if sample is not None:
                                counter += 1
                                yield sample
                            group = {}
                        key = stem
                        try:
                            group[ext] = tf.extractfile(m).read()
                        except Exception as e:  # noqa: BLE001 — log and continue
                            log.warning("skipping member %s: %s", m.name, e)
                    if group and key is not None:
                        sample = self._build(key, group, counter)
                        if sample is not None:
                            counter += 1
                            yield sample
            except _BadSample:
                raise
            except Exception as e:  # noqa: BLE001 — a corrupt shard is skipped, as in JAX
                log.warning("skipping shard %s: %s", shard, e)

    def _image(self, key: str, group: dict):
        if "npy" in group:
            image = np.load(io.BytesIO(group["npy"]), allow_pickle=False)
            if self.preprocess_fn is None:
                return image
            if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
                raise _BadSample(f"sample {key}: a {image.dtype} {image.shape} npy image, where "
                                 "the transform takes (H, W, 3) uint8")
            if getattr(self.preprocess_fn, "accepts_ndarray", False):
                return image
            from PIL import Image

            return Image.fromarray(image)  # user callables keep the PIL contract
        raw = group.get("png") or group.get("jpg") or group.get("jpeg")
        if raw is None:
            return None
        from spatial_clip_tpu_torch.data.native_decode import decode_rgb, decode_rgb_into

        image = None
        if self.preprocess_fn is None:
            image = decode_rgb(raw)
        else:
            fast = getattr(self.preprocess_fn, "ndarray_fast_size", None)
            if fast is not None:
                out = np.empty((*fast, 3), np.uint8)
                if decode_rgb_into(raw, out):
                    image = out
        if image is None:
            from PIL import Image

            image = Image.open(io.BytesIO(raw)).convert("RGB")
        return image

    def _build(self, key: str, group: dict, idx: int) -> Optional[dict]:
        try:
            image = self._image(key, group)
            if image is None:
                return None
            image = (self.preprocess_fn(image) if self.preprocess_fn is not None
                     else np.asarray(image))
            sentence = group.get("txt", b"").decode("utf-8")
            text = (np.asarray(self.tokenizer([sentence])[0]) if self.tokenizer
                    else np.zeros(8, dtype=np.int32))
            meta = json.loads(group["json"]) if "json" in group else {}
        except _BadSample:
            raise
        except Exception as e:  # noqa: BLE001 — one bad sample must not stop the stream
            log.warning("skipping sample %s: %s", key, e)
            return None
        return {
            "image": image,
            "text": text,
            "raw_text": sentence,
            "anchor_tile_id": idx,
            "neighbor_tile_ids": [-1] * self.k_neighbors,
            "neighbor_alphas": [0.0] * self.k_neighbors,
            "meta": meta,
        }

    def __iter__(self) -> Iterator[dict]:
        it = self._iter_raw()
        if self.shuffle_buffer <= 1:
            yield from it
            return
        rng = np.random.default_rng(self.seed * 7919 + self._epoch)
        buf: List[dict] = []
        for sample in it:
            buf.append(sample)
            if len(buf) >= self.shuffle_buffer:
                j = int(rng.integers(len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf


def iter_batches(dataset: IterableTarDataset, batch_size: int, collate_fn=None):
    """Drop-last batches of a streaming dataset."""
    from spatial_clip_tpu_torch.data.datamodule import collate_spatial

    collate = collate_fn or collate_spatial
    buf: List[dict] = []
    for sample in dataset:
        sample.pop("meta", None)
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
