"""The port's pretrained weights by name against the JAX package's.

- The registry: the same 192 (model, tag) pairs, each tag's config and
  preprocess overrides equal to JAX's.
- Resolution is local only (``socket.socket`` patched to raise): a tag's
  file in the JAX package's cache layout, a ``file://`` URL, a plain path;
  where JAX would download, FileNotFoundError naming the file and the URL.
- Weight files: the port's ``save_for_hf`` snapshot read by JAX's
  ``create_model('hf-hub:...')`` and JAX's read by the port's, config,
  preprocess config and ``quick_gelu`` equal field by field and the encodes
  equal; an OpenAI-style TorchScript archive (fp16, with the three integer
  entries) read by the port under an ``openai`` tag, encoding as JAX does on
  the same weights given as a ``.bin``; JAX's loader failing on the archive
  (the reference's fault, pinned); ``resize_pos_embed`` and a checkpoint of
  another image size loaded as JAX loads it; the MobileCLIP key map.
The models are ViT-Test widened to head_dim 64 on the port's seed-0 weights,
fp32 on the CPU; encodes are held at atol and rtol 1e-4, as
``test_torch_port_ckpt.py`` holds them.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import dataclasses
import hashlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.models import constants as jax_constants
from spatial_clip_tpu.models import convert as jax_convert
from spatial_clip_tpu.models import pretrained as jax_pretrained
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.models.factory import create_model as jax_create_model
from spatial_clip_tpu.models.factory import load_checkpoint as jax_load_checkpoint
from spatial_clip_tpu.models.push_to_hf_hub import save_for_hf as jax_save_for_hf
from spatial_clip_tpu.models.transforms import PreprocessCfg as JaxPreprocessCfg
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize_batch
from spatial_clip_tpu_torch.models import convert, pretrained
from spatial_clip_tpu_torch.models.factory import create_model, create_model_and_transforms
from spatial_clip_tpu_torch.models.push_to_hf_hub import save_for_hf
from spatial_clip_tpu_torch.models.transforms import normalize_batch

WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def offline(monkeypatch):
    """Any socket opened inside the test raises."""
    def refuse(*args, **kwargs):
        raise OSError("a socket was opened: resolution must stay local")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Empty SPATIAL_CLIP_CACHE and HF hub caches under ``tmp_path``."""
    monkeypatch.setenv("SPATIAL_CLIP_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.delenv("HUGGINGFACE_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    (tmp_path / "cache").mkdir()
    return tmp_path


def _port_model(**over):
    return create_model("ViT-Test", precision="fp32", device="cpu", **WIDE, **over)


def _jax_bundle(state_dict, **over):
    """JAX's widened ViT-Test (f32) on ``state_dict``'s weights, with no
    flax init."""
    cfg = jax_resolve_clip_cfg("ViT-Test", **{**WIDE, **over})
    return ModelBundle(
        model=JaxCLIP(cfg=cfg, dtype=jnp.float32),
        params=jax.tree.map(jnp.asarray, convert.to_jax_params(state_dict)), cfg=cfg,
        model_name="ViT-Test", preprocess_cfg=JaxPreprocessCfg(
            size=cfg.vision_cfg.image_size, mean=jax_constants.OPENAI_DATASET_MEAN,
            std=jax_constants.OPENAI_DATASET_STD))


def _inputs(size=32):
    rng = np.random.default_rng(11)
    return (rng.integers(0, 256, (3, size, size, 3), dtype=np.uint8),
            rng.integers(0, 512, (3, 16)).astype(np.int32))


def _port_encodes(model, size=32):
    u8, ids = _inputs(size)
    with torch.inference_mode():
        return (model.encode_image(normalize_batch(torch.from_numpy(u8))).numpy(),
                model.encode_text(torch.from_numpy(ids).long()).numpy())


_JITTED: dict = {}


def _jax_encodes(bundle, size=32):
    """JAX's encodes, jitted once per architecture (op by op, each new
    shape of a JAX model compiles its primitives one at a time)."""
    key = repr(bundle.cfg)
    if key not in _JITTED:
        m = bundle.model
        _JITTED[key] = (
            jax.jit(lambda p, x: m.apply({"params": p}, x, method=type(m).encode_image)),
            jax.jit(lambda p, t: m.apply({"params": p}, t, method=type(m).encode_text)))
    image, text = _JITTED[key]
    u8, ids = _inputs(size)
    return (np.asarray(image(bundle.params, jax_normalize_batch(u8))),
            np.asarray(text(bundle.params, jnp.asarray(ids))))


def _assert_same_encodes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _assert_same_cfg(port_cfg, jax_cfg):
    """Every field the two packages' configs share, tower by tower."""
    for part in ("vision_cfg", "text_cfg", None):
        p = getattr(port_cfg, part) if part else port_cfg
        j = getattr(jax_cfg, part) if part else jax_cfg
        shared = {f.name for f in dataclasses.fields(p)} & {f.name for f in dataclasses.fields(j)}
        for name in shared - {"vision_cfg", "text_cfg", "gene_cfg", "multimodal_cfg"}:
            assert getattr(p, name) == getattr(j, name), f"{part}.{name}"


def _assert_same_preprocess(port_pp, jax_pp):
    for f in dataclasses.fields(jax_pp):
        want = getattr(jax_pp, f.name)
        got = getattr(port_pp, f.name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
            (tuple(want) if isinstance(want, (list, tuple)) else want), f.name


def test_registry_equals_jax_pair_for_pair():
    """192 pairs over 111 models, in JAX's order, every tag's config, its
    preprocess overrides and the tags by model equal to JAX's."""
    pairs = pretrained.list_pretrained()
    assert pairs == jax_pretrained.list_pretrained()
    assert len(pairs) == 192 and len({m for m, _ in pairs}) == 111
    assert pretrained.PREPROCESS_KEYS == jax_pretrained.PREPROCESS_KEYS
    for model, tag in pairs:
        cfg = pretrained.get_pretrained_cfg(model, tag)
        assert cfg == jax_pretrained.get_pretrained_cfg(model, tag), (model, tag)
        assert pretrained.preprocess_overrides(cfg) == jax_pretrained.preprocess_overrides(cfg)
    for model in {m for m, _ in pairs}:
        assert (pretrained.list_pretrained_tags_by_model(model)
                == jax_pretrained.list_pretrained_tags_by_model(model))
    assert pretrained.get_pretrained_cfg("ViT-B-32", "no-such-tag") is None
    assert pretrained.preprocess_overrides(None) == {}


def test_145_of_192_registry_pairs_build():
    """The (model, tag) pairs whose model config ``check_ported`` passes:
    145 of 192 (67 of the 111 models), every ``openai`` model among them."""
    from spatial_clip_tpu_torch.models.config import check_ported, resolve_clip_cfg

    built = {}
    for model, _ in pretrained.list_pretrained():
        if model not in built:
            try:
                check_ported(resolve_clip_cfg(model))
                built[model] = True
            except (NotImplementedError, KeyError):
                built[model] = False
    pairs = [(m, t) for m, t in pretrained.list_pretrained() if built[m]]
    assert (len(pairs), sum(built.values())) == (145, 67)
    assert all(built[m] for m, t in pretrained.list_pretrained() if t == "openai")


def test_resolver_finds_the_jax_cache_file_a_file_url_and_a_path(caches, offline, monkeypatch):
    """A tag whose file the JAX package's cache layout holds resolves in
    both packages to that file; ``file://`` URLs and plain paths resolve to
    themselves; nothing opens a socket."""
    url = pretrained.get_pretrained_cfg("ViT-B-32", "openai")["url"]
    name = f"ViT-B-32-openai-{hashlib.sha256(url.encode()).hexdigest()[:16]}.bin"
    cached = caches / "cache" / name
    cached.write_bytes(b"weights")
    assert pretrained.cache_path("ViT-B-32", "openai", url) == cached
    assert pretrained.download_pretrained("ViT-B-32", "openai") == str(cached)
    assert jax_pretrained.download_pretrained("ViT-B-32", "openai") == str(cached)
    local = caches / "local.bin"
    local.write_bytes(b"weights")
    for tag, spec in (("file-url", f"file://{local}"), ("path", str(local))):
        for registry in (pretrained._PRETRAINED, jax_pretrained._PRETRAINED):
            monkeypatch.setitem(registry, "ViT-Test", {tag: {"url": spec}})
        assert pretrained.download_pretrained("ViT-Test", tag) == str(local)
        assert jax_pretrained.download_pretrained("ViT-Test", tag) == str(local)
    other = caches / "elsewhere"
    other.mkdir()
    (other / name).write_bytes(b"weights")
    assert pretrained.download_pretrained("ViT-B-32", "openai", cache_dir=str(other)) == \
        str(other / name)


def test_resolver_raises_where_jax_would_download(caches, offline, monkeypatch):
    """A tag whose file is not in the cache raises FileNotFoundError naming
    the file and the URL; an unknown tag raises KeyError; a model asked for
    either gets no weights drawn from a seed."""
    url = pretrained.get_pretrained_cfg("ViT-B-32", "laion2b_s34b_b79k")["url"]
    want = pretrained.cache_path("ViT-B-32", "laion2b_s34b_b79k", url)
    with pytest.raises(FileNotFoundError) as err:
        pretrained.download_pretrained("ViT-B-32", "laion2b_s34b_b79k")
    assert str(want) in str(err.value) and url in str(err.value)
    with pytest.raises(KeyError, match="no-such-tag"):
        pretrained.download_pretrained("ViT-B-32", "no-such-tag")
    monkeypatch.setitem(pretrained._PRETRAINED, "ViT-Test",
                        {"remote": {"url": "https://example.org/w.bin", "quick_gelu": True}})
    with pytest.raises(FileNotFoundError, match="ViT-Test-remote-"):
        _port_model(pretrained="remote")
    with pytest.raises(FileNotFoundError, match="neither a local file"):
        _port_model(pretrained="no-such-tag")
    with pytest.raises(ValueError, match="no cached snapshot"):
        create_model("hf-hub:org/absent", device="cpu")
    with pytest.raises(ValueError, match="no cached snapshot"):
        _port_model(pretrained="hf-hub:org/absent")


def test_snapshots_read_across_packages_field_by_field(caches, offline):
    """The port's save_for_hf snapshot through JAX's create_model('hf-hub:')
    and JAX's through the port's: the same config, preprocess config and
    quick_gelu, and the same encodes; a snapshot with no weights raises
    rather than return weights drawn from a seed."""
    model = _port_model(quick_gelu=True)
    snap = caches / "hub" / "models--local--vit-test" / "snapshots" / "0"
    save_for_hf(model, None, snap, model_card="ViT-Test")
    assert (snap / "README.md").read_text() == "ViT-Test"
    ours, _, _ = create_model_and_transforms("hf-hub:local/vit-test",
                                                       precision="fp32", device="cpu")
    theirs = jax_create_model("hf-hub:local/vit-test", precision="fp32")
    assert ours.cfg.quick_gelu and theirs.cfg.quick_gelu
    _assert_same_cfg(ours.cfg, theirs.cfg)
    _assert_same_preprocess(ours.preprocess_cfg, theirs.preprocess_cfg)
    _assert_same_encodes(_port_encodes(ours), _jax_encodes(theirs))
    _assert_same_encodes(_port_encodes(ours), _port_encodes(model))

    bundle = _jax_bundle(_port_model(seed=3).state_dict(), quick_gelu=True)
    jax_snap = caches / "hub" / "models--local--jax-vit-test" / "snapshots" / "0"
    jax_save_for_hf(bundle, bundle.params, str(jax_snap))
    ours = create_model("hf-hub:local/jax-vit-test", precision="fp32", device="cpu")
    assert ours.cfg.quick_gelu
    _assert_same_cfg(ours.cfg, bundle.cfg)
    _assert_same_preprocess(ours.preprocess_cfg, bundle.preprocess_cfg)
    _assert_same_encodes(_port_encodes(ours), _jax_encodes(bundle))
    local = create_model(f"local-dir:{jax_snap}", pretrained=str(jax_snap), precision="fp32",
                         device="cpu")
    _assert_same_encodes(_port_encodes(local), _jax_encodes(bundle))

    (jax_snap / "open_clip_pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError, match="drawn from a seed"):
        create_model("hf-hub:local/jax-vit-test", precision="fp32", device="cpu")


def test_openai_archive_loads_under_its_tag_and_encodes_as_jax(caches, offline, monkeypatch,
                                                                caplog):
    """An OpenAI-style TorchScript archive (fp16, with input_resolution,
    context_length and vocab_size) in the cache under an ``openai`` tag:
    the port turns QuickGELU on (with JAX's warning), pins the tag's
    preprocessing over the defaults, drops the integer entries and encodes
    as JAX does on the same fp16-rounded weights given as a .bin."""
    url = "https://example.org/clip/ViT-Test.pt"
    tag = {"url": url, "format": "openai", "quick_gelu": True, "resize_mode": "squash",
           "mean": (0.5, 0.5, 0.5)}
    for registry in (pretrained._PRETRAINED, jax_pretrained._PRETRAINED):
        monkeypatch.setitem(registry, "ViT-Test", {"openai": dict(tag)})
    sd = {k: v.half().float() for k, v in _port_model(seed=5).state_dict().items()}
    archive = pretrained.cache_path("ViT-Test", "openai", url)
    convert.write_openai_archive(sd, archive, image_size=32, context_length=16,
                                 vocab_size=512)
    assert convert.is_torchscript_archive(archive)
    raw = torch.jit.load(str(archive)).state_dict()
    assert {k for k in raw if not raw[k].is_floating_point()} == set(convert.OPENAI_ARCHIVE_INTS)
    read = convert.read_openai_archive(archive)
    assert set(read) == set(sd) and all(v.dtype == torch.float16 for v in read.values())

    with caplog.at_level("WARNING"):
        ours = _port_model(pretrained="openai")
    assert ours.cfg.quick_gelu and "QuickGELU" in caplog.text
    bin_path = caches / "openai.bin"
    torch.save(sd, bin_path)
    theirs = _jax_bundle(_port_model().state_dict(), quick_gelu=True)
    theirs.params = jax_load_checkpoint(theirs.params, str(bin_path))
    _assert_same_encodes(_port_encodes(ours), _jax_encodes(theirs))
    want_pp = {**dataclasses.asdict(ours.preprocess_cfg), "resize_mode": "squash",
               "mean": (0.5, 0.5, 0.5)}
    assert dataclasses.asdict(ours.preprocess_cfg) == want_pp
    # JAX's own pinning of the same tag (its weights from the .bin: its
    # loader cannot read the archive)
    monkeypatch.setitem(jax_pretrained._PRETRAINED, "ViT-Test",
                        {"openai": {**tag, "url": f"file://{bin_path}"}})
    jax_bundle = jax_create_model("ViT-Test", pretrained="openai", precision="fp32", **WIDE)
    assert jax_bundle.cfg.quick_gelu
    _assert_same_preprocess(ours.preprocess_cfg, jax_bundle.preprocess_cfg)
    trained = _port_model(pretrained="openai", training=True)
    assert all(p.dtype == torch.float32 for p in trained.parameters())
    _assert_same_encodes(_port_encodes(trained), _port_encodes(ours))


def test_entry_point_and_cli_trainer_resolve_a_tag(caches, offline, monkeypatch, tmp_path):
    """``.train model.pretrained=<tag>`` (``entry.build_model``) loads the
    tag's cached weights through the factory; ``cli.main_train
    --pretrained <tag>`` resolves it the same way, and a tag with no file
    raises there rather than train from a seed."""
    from spatial_clip_tpu_torch.cli import main_train
    from spatial_clip_tpu_torch.train import entry

    url = "https://example.org/vit-test.bin"
    monkeypatch.setitem(pretrained._PRETRAINED, "ViT-Test",
                        {"local": {"url": url}, "absent": {"url": url + ".absent"}})
    src = create_model("ViT-Test", precision="fp32", device="cpu", seed=9)
    torch.save(src.state_dict(), pretrained.cache_path("ViT-Test", "local", url))
    cfg = entry.compose_train(["experiment=smoke_synthetic", "trainer.platform=cpu",
                               "model.pretrained=local"])
    model = entry.build_model(cfg, device="cpu")[0]
    got = model.state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    argv = ["--device", "cpu", "--model", "ViT-Test", "--precision", "fp32", "--dataset-type",
            "synthetic", "--synthetic-num-samples", "8", "--synthetic-image-size", "32",
            "--batch-size", "8", "--epochs", "1", "--workers", "0", "--logs", str(tmp_path)]
    with pytest.raises(FileNotFoundError, match="ViT-Test-absent-"):
        main_train.main(argv + ["--pretrained", "absent", "--name", "absent"])
    assert all(np.isfinite(v) for v in main_train.main(
        argv + ["--pretrained", "local", "--name", "local"]).values() if isinstance(v, float))


def test_jax_reference_fault_openai_archive_raises_attribute_error(tmp_path):
    """The reference's fault (ROADMAP Queue 3, "Faults already in the
    reference"): JAX's ``load_torch_state_dict`` expects ``torch.load`` to
    raise on a TorchScript archive; with ``weights_only=False`` it returns
    the scripted module, whose ``.items()`` raises AttributeError. The
    port's reader takes the module's state dict."""
    sd = _port_model().state_dict()
    convert.write_openai_archive(sd, tmp_path / "a.pt")
    with pytest.raises(AttributeError, match="items"):
        jax_convert.load_torch_state_dict(tmp_path / "a.pt")
    assert set(convert.read_openai_archive(tmp_path / "a.pt")) == set(sd)


@pytest.mark.parametrize("old,new,prefix", [(7, 8, 1), (7, 5, 1), (16, 24, 1), (14, 7, 0),
                                            (4, 4, 1), (2, 3, 1)])
def test_resize_pos_embed_equals_jax(old, new, prefix):
    pe = np.random.default_rng(old * new).standard_normal((prefix + old * old, 12),
                                                         dtype=np.float32)
    want = jax_convert.resize_pos_embed(pe, prefix + new * new, prefix)
    got = convert.resize_pos_embed(torch.from_numpy(pe), prefix + new * new, prefix)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_checkpoint_of_another_image_size_loads_resized_as_jax(tmp_path):
    """32-px weights (a 2x2 grid) into ViT-Test at 48 px (3x3): the port
    resizes the image tower's positions before its strict load, as JAX's
    converter does, and encodes as JAX's model loaded from the same file."""
    path = tmp_path / "w.bin"
    torch.save(_port_model(seed=7).state_dict(), path)
    big = dict(vision_cfg=dict(WIDE["vision_cfg"], image_size=48))
    ours = create_model("ViT-Test", pretrained=str(path), precision="fp32", device="cpu",
                        **{**WIDE, **big})
    assert ours.visual.positional_embedding.shape[0] == 10
    theirs = _jax_bundle(create_model("ViT-Test", precision="fp32", device="cpu",
                                      **{**WIDE, **big}).state_dict(), **big)
    theirs.params = jax_load_checkpoint(theirs.params, str(path))
    _assert_same_encodes(_port_encodes(ours, 48), _jax_encodes(theirs, 48))


def test_checkpoint_flavor_and_mobileclip_map_equal_jax():
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mobile = {
        "text_encoder.embedding_layer.weight": arr(8, 4),
        "text_encoder.positional_embedding.pos_embed.pos_embed": arr(1, 1, 6, 4),
        "text_encoder.transformer.0.pre_norm_mha.0.weight": arr(4),
        "text_encoder.transformer.0.pre_norm_mha.1.qkv_proj.weight": arr(12, 4),
        "text_encoder.transformer.0.pre_norm_ffn.1.weight": arr(16, 4),
        "text_encoder.transformer.0.pre_norm_ffn.4.bias": arr(4),
        "text_encoder.final_layer_norm.weight": arr(4),
        "text_encoder.projection_layer": arr(4, 4),
        "image_encoder.model.patch_embed.0.rbr_conv.0.conv.weight": arr(3, 3, 1, 1),
        "logit_scale": arr(),
        "ignored": arr(2),
    }
    want = jax_convert.convert_mobileclip_state_dict(mobile)
    got = convert.convert_mobileclip_state_dict({k: torch.from_numpy(v)
                                                 for k, v in mobile.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for sd in (mobile, {"text_encoder.x": 1}, {"visual.transformer.resblocks.0.x": 1},
               {"visual.trunk.stem.0.weight": 1}, {"visual.trunk.patch_embed.proj.weight": 1},
               {"other": 1}):
        assert convert.detect_checkpoint_flavor(sd) == jax_convert.detect_checkpoint_flavor(sd)
