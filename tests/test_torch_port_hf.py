"""The Hugging Face text towers (``spatial_clip_tpu_torch.models.hf_model``,
``m2m_encoder``) against the JAX package's ``HFTextTower`` (transformers'
Flax BERT / RoBERTa / XLM-RoBERTa / T5 / mT5 modules and its own flax M2M100
encoder): each architecture at a small ``hf_config`` under each pooler and
projection with pad tails, the weight map both ways (the M2M tree's dotted
flax names included), a small-RoBERTa CLIP's forward and three Trainer
steps, the full-width trees of the built-in configs, the config resolution
(architecture, pad id, class defaults, refusals), the dropout draws, the
positions JAX hands the BERT family, the tokenizer from local files, and
the text lock.

Parameters come from numpy seeds on JAX's tree from ``jax.eval_shape``.
All in f32 on the CPU, dropout rates 0 where the port is held to JAX (JAX's
masks come from its own generator): features at atol 1e-5 (rtol 1e-4),
losses at rtol 1e-5, parameters at atol 1e-5 after the steps; the unused
BERT pooler takes no gradient and follows JAX by weight decay alone.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_clip_tpu.cli.main_train import _lock_prefixes as jax_lock_prefixes
from spatial_clip_tpu.cli.main_train import parse_args as jax_parse_args
from spatial_clip_tpu.losses import make_loss as jax_make_loss
from spatial_clip_tpu.models import hf_model as jhf
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import TextCfg as JaxTextCfg
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from spatial_clip_tpu.parallel.mesh import make_mesh
from spatial_clip_tpu.train import optim as jax_optim
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from spatial_clip_tpu_torch import create_model, get_tokenizer
from spatial_clip_tpu_torch.cli.main_train import _lock_prefixes
from spatial_clip_tpu_torch.losses import make_loss
from spatial_clip_tpu_torch.models import hf_model as phf
from spatial_clip_tpu_torch.models.config import TextCfg, check_ported, resolve_clip_cfg
from spatial_clip_tpu_torch.models.tokenizer import HFTokenizer
from spatial_clip_tpu_torch.models.convert import (
    _flatten,
    _key_pairs,
    from_jax_params,
    to_jax_params,
)
from spatial_clip_tpu_torch.ops import attention_plain
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig
from spatial_clip_tpu_torch.train.optim import decay_mask, jax_param_paths

EMBED = 24
_BERT_SMALL = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=64, max_position_embeddings=32, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
_T5_SMALL = dict(vocab_size=99, d_model=32, num_layers=2, num_heads=2, d_ff=64, d_kv=16,
                 dropout_rate=0.0)
SMALL = {
    "bert": _BERT_SMALL,
    "roberta": _BERT_SMALL,
    "xlm-roberta": {**_BERT_SMALL, "layer_norm_eps": 1e-5},
    "t5": _T5_SMALL,
    "mt5": _T5_SMALL,  # gated-gelu, its class default
    "m2m_100": dict(vocab_size=99, d_model=32, encoder_layers=2, encoder_attention_heads=4,
                    encoder_ffn_dim=64, max_position_embeddings=64, dropout=0.0,
                    attention_dropout=0.0),
}
PAD = {"bert": 0, "roberta": 1, "xlm-roberta": 1, "t5": 0, "mt5": 0, "m2m_100": 1}
BUILTIN_HF = ["roberta-ViT-B-32", "xlm-roberta-base-ViT-B-32", "mt5-base-ViT-B-32",
              "nllb-clip-base", "nllb-clip-base-siglip", "nllb-clip-large-siglip"]


def _ids(pad, B=4, L=16, vocab=99, seed=0):
    """Ids drawn in [2, vocab) with pad tails of different lengths; row 0
    has no pad."""
    ids = np.random.default_rng(seed).integers(2, vocab, (B, L)).astype(np.int32)
    for row, start in zip(range(1, B), (11, 4, 1)):
        ids[row, start:] = pad
    return ids


def _draw(shapes, seed):
    """numpy draws on a JAX param tree: kernels normal / sqrt(fan_in),
    embeddings normal(0.5), norm gains 1 + normal(0.1), biases normal(0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            return (x / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "embedding":
            return (x * 0.5).astype(np.float32)
        return (x * 0.1 + (1.0 if name in ("scale", "weight") else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _tower_sd(params) -> dict:
    """The port's HFTextTower state dict of a JAX HFTextTower's params
    (the text half of the CLIP key map), keys without ``text.``."""
    flat = _flatten({"text": jax.tree.map(np.asarray, params)})
    out = {}
    for jkey, tkey, transpose in _key_pairs(lambda j, t: j in flat):
        if jkey in flat:
            v = flat.pop(jkey)
            out[tkey[len("text."):]] = torch.from_numpy(
                np.array(v if transpose is None else v.transpose(transpose)))
    assert not flat, sorted(flat)
    return out


def _tower_params(sd) -> dict:
    """The inverse of :func:`_tower_sd`: JAX's nested tower params."""
    sd = {f"text.{k}": v.numpy() for k, v in sd.items()}
    nested: dict = {}
    for jkey, tkey, transpose in _key_pairs(lambda j, t: t in sd):
        if tkey in sd:
            v = sd.pop(tkey)
            node = nested
            *parents, leaf = jkey.split("/")[1:]
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v if transpose is None else v.transpose(np.argsort(transpose))
    assert not sd, sorted(sd)
    return nested


@functools.lru_cache(maxsize=None)
def _jax_params(arch, proj):
    """JAX's tower params for an architecture and projection (the encoder's
    draws shared by the poolers)."""
    jm = jhf.HFTextTower(output_dim=EMBED, arch=arch, hf_config=SMALL[arch], proj_type=proj,
                         pad_id=PAD[arch])
    ids = jnp.asarray(_ids(PAD[arch]))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids))
    return _draw(shapes["params"], len(arch))


@pytest.mark.parametrize("proj", ["linear", "mlp"])
@pytest.mark.parametrize("pooler", ["cls_pooler", "mean_pooler", "max_pooler", "last"])
@pytest.mark.parametrize("arch", list(SMALL))
def test_hf_tower_matches_jax(arch, pooler, proj):
    """Each architecture at a small hf_config, each pooler and projection,
    four rows with pad tails (one without): the features, one
    encoder_attention call a layer, and the weight map both ways."""
    params = _jax_params(arch, proj)
    jm = jhf.HFTextTower(output_dim=EMBED, arch=arch, hf_config=SMALL[arch], pooler_type=pooler,
                         proj_type=proj, pad_id=PAD[arch])
    ids = _ids(PAD[arch])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    pm = phf.HFTextTower(EMBED, arch, SMALL[arch], pooler, proj, PAD[arch])
    sd = _tower_sd(params)
    pm.load_state_dict(sd, strict=True)
    before = attention_plain.encoder_attention.launches
    with torch.no_grad():
        got = pm(torch.from_numpy(ids).long()).numpy()
    layers = SMALL[arch].get("num_hidden_layers") or SMALL[arch].get("num_layers") or \
        SMALL[arch]["encoder_layers"]
    assert attention_plain.encoder_attention.launches == before + layers
    assert got.shape == want.shape == (4, EMBED)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    back = _tower_params(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)  # noqa: E731
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_m2m_names_with_dots_map_one_to_one():
    """The M2M tree's flax names hold dots (``layers.0``,
    ``self_attn.q_proj``): each maps to its own state-dict key and back."""
    model = create_model("ViT-Test", precision="fp32", device="cpu",
                         text_cfg=dict(hf_config=SMALL["m2m_100"], hf_model_arch="m2m_100"))
    sd = model.state_dict()
    assert "text.hf.layers.1.self_attn.q_proj.weight" in sd
    back = to_jax_params(sd)
    assert set(back["text"]["hf"]) == {"embed_tokens", "layers.0", "layers.1", "layer_norm"}
    assert set(back["text"]["hf"]["layers.1"]) == {
        "self_attn_layer_norm", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.out_proj", "final_layer_norm", "fc1", "fc2"}
    again = from_jax_params(back)
    assert again.keys() == sd.keys() and all(torch.equal(again[k], sd[k]) for k in sd)


# ------------------------------------------------------------------ the CLIP

ROBERTA = dict(text_cfg=dict(hf_model_name="roberta-small-test", hf_config=SMALL["roberta"],
                             hf_pooler_type="mean_pooler"))


def _batch(seed, B=8, size=32, k=4):
    rng = np.random.default_rng(seed)
    tile_ids = np.arange(B, dtype=np.int32)
    tile_ids[-1] = tile_ids[0]
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": _ids(1, B=B, seed=seed),
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if k == "texts"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_roberta_clip_forward_and_three_trainer_steps_match_jax():
    """ViT-Test with a small RoBERTa text tower (pad 1, mean pooler): the
    forward, then three steps of the port's Trainer against the JAX Trainer
    (the spatial loss, AdamW with f32 moments, lr 0 at step 0): loss,
    grad_norm and logit_scale at rtol 1e-5, every parameter at atol 1e-5.
    The unused pooler takes a zero gradient: its bias keeps its bits, its
    kernel decays as JAX's."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50, augment=False, seed=0,
                  mu_dtype=None, nu_dtype=None)
    loss_kw = dict(cap_logit_scale=50.0)
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **ROBERTA)
    assert model.cfg.text_cfg.pad_id == 1 and isinstance(model.text, phf.HFTextTower)
    cfg = jax_resolve_clip_cfg("ViT-Test", **ROBERTA)
    params = to_jax_params(model.state_dict())
    jclip = JaxCLIP(cfg=cfg, dtype=jnp.float32)
    batch = _batch(19)
    images = np.random.default_rng(3).normal(size=(8, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jclip.apply)({"params": params}, jnp.asarray(images),
                                jnp.asarray(batch["texts"]))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(batch["texts"]).long())
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-4)

    jb = ModelBundle(model=jclip, params=params, cfg=cfg)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", **loss_kw),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    trainer = Trainer(model, make_loss("spatial", **loss_kw), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    assert trainer.text_dropout_seed(state) is None  # every rate 0
    pooler = {k: state.params[k].detach().clone() for k in
              ("text.hf.pooler.dense.weight", "text.hf.pooler.dense.bias")}
    for i in range(3):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, _torch_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    bias = "text.hf.pooler.dense.bias"
    assert torch.equal(state.params[bias].detach(), pooler[bias]) and torch.equal(
        want[bias], pooler[bias])
    weight = state.params["text.hf.pooler.dense.weight"].detach()
    assert not torch.equal(weight, pooler["text.hf.pooler.dense.weight"])
    ratio = weight / pooler["text.hf.pooler.dense.weight"]
    torch.testing.assert_close(ratio, torch.full_like(ratio, ratio.flatten()[0].item()))


@pytest.mark.parametrize("name", BUILTIN_HF[:5])
def test_builtin_hf_config_tree_maps_one_to_one(name):
    """A built-in HF config at full width (meta device) against JAX's tree
    from jax.eval_shape: every parameter one to one through the key map
    with the same shapes (so the class defaults: RoBERTa's vocab 50265,
    XLM-RoBERTa's 30522, mT5's 512 x 8 layers of 6 heads of 64, M2M100's
    1024 x 12), and JAX's weight-decay mask (the pooler's kernel decays)."""
    cfg = jax_resolve_clip_cfg(name)
    size = cfg.vision_cfg.image_size
    shapes = jax.eval_shape(lambda: JaxCLIP(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.ones((1, 8), jnp.int32)))
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(v.shape)
             for p, v in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    model = create_model(name, device="meta", training=True)
    ours = {k: tuple(p.shape) for k, p in model.named_parameters()}
    pairs = _key_pairs(lambda j, t: j in jflat or t in ours)
    assert sorted(j for j, _, _ in pairs) == sorted(jflat)
    assert sorted(t for _, t, _ in pairs) == sorted(ours)
    for jkey, tkey, transpose in pairs:
        want = jflat[jkey] if transpose is None else tuple(jflat[jkey][i] for i in transpose)
        assert ours[tkey] == want, (jkey, tkey)
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    jdecay = {jax.tree_util.keystr(p, simple=True, separator="/"): bool(v)
              for p, v in jax.tree_util.tree_leaves_with_path(jax_optim.decay_mask(views))}
    paths = jax_param_paths(ours)
    assert {paths[k]: v for k, v in decay_mask(dict(model.named_parameters())).items()} == jdecay
    assert model.cfg.text_cfg.pad_id == cfg.text_cfg.pad_id


# ------------------------------------------------------------------ configs


def test_arch_and_pad_id_resolve_as_jax():
    """TextCfg's architecture (inferred from the hub id, or explicit) and
    pad id (1 for m2m_100 and the RoBERTa family) against JAX's."""
    cases = [dict(hf_model_name=n) for n in (
        "roberta-base", "xlm-roberta-base", "google/mt5-base", "t5-small",
        "facebook/nllb-200-distilled-600M", "bert-base-uncased")]
    cases += [dict(hf_model_name="x", hf_model_arch="roberta"), dict(hf_config={}),
              dict(hf_config={}, hf_model_arch="m2m_100"), dict()]
    for kw in cases:
        ours, theirs = TextCfg(**kw), JaxTextCfg(**kw)
        assert (ours.hf_model_arch, ours.pad_id) == (theirs.hf_model_arch, theirs.pad_id), kw
    for name in BUILTIN_HF:
        ours, theirs = resolve_clip_cfg(name).text_cfg, jax_resolve_clip_cfg(name).text_cfg
        assert (ours.hf_model_arch, ours.pad_id, ours.hf_pooler_type, ours.hf_proj_type) == (
            theirs.hf_model_arch, theirs.pad_id, theirs.hf_pooler_type, theirs.hf_proj_type)


@pytest.mark.parametrize("arch", list(phf.HF_DEFAULTS))
def test_default_table_equals_transformers_config_classes(arch):
    """HF_DEFAULTS against transformers' config class at its defaults, for
    every field the encoders read (the port imports no transformers)."""
    transformers = pytest.importorskip("transformers")
    cls = {"bert": "BertConfig", "roberta": "RobertaConfig", "xlm-roberta": "XLMRobertaConfig",
           "t5": "T5Config", "mt5": "MT5Config", "m2m_100": "M2M100Config"}[arch]
    config = getattr(transformers, cls)()
    for key, value in phf.HF_DEFAULTS[arch].items():
        assert getattr(config, key) == value, (arch, key)


@pytest.mark.parametrize("text_cfg,field", [
    (dict(hf_config={"position_embedding_type": "relative_key"}), "position_embedding_type"),
    (dict(hf_config={"is_decoder": True}), "is_decoder"),
    (dict(hf_config={"add_cross_attention": True}), "add_cross_attention"),
    (dict(hf_config={"hidden_act": "silu"}), "hidden_act"),
    (dict(hf_config={"some_new_key": 1}), "some_new_key"),
    (dict(hf_config={"feed_forward_proj": "gated-silu"}, hf_model_arch="mt5"),
     "feed_forward_proj"),
    (dict(hf_config={"activation_function": "gelu"}, hf_model_arch="m2m_100"),
     "activation_function"),
    (dict(hf_model_name="gpt2", hf_model_arch="gpt2"), "text_cfg.hf_model_arch"),
    (dict(hf_model_name="bert-base", hf_pooler_type="cls_last_hidden_state_pooler"),
     "text_cfg.hf_pooler_type"),
    (dict(hf_model_name="bert-base", hf_proj_type="none"), "text_cfg.hf_proj_type"),
])
def test_what_the_encoders_do_not_build_is_refused(text_cfg, field):
    """An hf_config key or value the port's encoders do not implement, an
    unknown architecture, pooler or projection raise NotImplementedError
    naming it (JAX would take an unknown pooler as the mean, a projection
    other than 'mlp' as linear)."""
    with pytest.raises(NotImplementedError, match=field):
        check_ported(resolve_clip_cfg("ViT-Test", text_cfg=text_cfg))


# ------------------------------------------------------------------ dropout


def test_dropout_draws_are_a_function_of_seed_and_call_order():
    """The same seed gives the same masks call for call; another seed or
    call another mask; the kept share is near 1 - rate; a row offset picks
    the rows of the whole batch's mask."""
    a, b, c = phf.DropoutDraws(5), phf.DropoutDraws(5), phf.DropoutDraws(6)
    m1, m2 = a.keep((64, 77, 32), 0.1, "cpu"), a.keep((64, 77, 32), 0.1, "cpu")
    assert torch.equal(m1, b.keep((64, 77, 32), 0.1, "cpu"))
    assert not torch.equal(m1, m2) and not torch.equal(m1, c.keep((64, 77, 32), 0.1, "cpu"))
    assert abs(m1.float().mean().item() - 0.9) < 0.005
    rows = phf.DropoutDraws(5, row_offset=16).keep((8, 77, 32), 0.1, "cpu")
    assert torch.equal(rows, m1[16:24])
    x = torch.ones(4, 8)
    y = phf.dropout(x, 0.25, phf.DropoutDraws(1))
    assert set(y.unique().tolist()) <= {0.0, torch.tensor(1.0 / 0.75).item()}
    assert torch.equal(phf.dropout(x, 0.25, None), x) and torch.equal(
        phf.dropout(x, 0.0, phf.DropoutDraws(1)), x)


@pytest.mark.parametrize("arch", ["roberta", "mt5", "m2m_100"])
def test_a_training_step_drops_out_as_its_seed_says(arch):
    """At the class defaults' rates (0.1) a Trainer step draws its masks
    from the config's seed and the step: two runs give the same bits, the
    step's loss differs from the same step with every rate 0, and
    evaluation drops nothing."""
    rates = {"roberta": dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1),
             "mt5": dict(dropout_rate=0.1),
             "m2m_100": dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)}[arch]
    runs = []
    for cfg in ({**SMALL[arch], **rates}, {**SMALL[arch], **rates}, SMALL[arch]):
        model = create_model("ViT-Test", precision="fp32", device="cpu", training=True,
                             text_cfg=dict(hf_config=cfg, hf_model_arch=arch))
        trainer = Trainer(model, make_loss("spatial"), TrainerConfig(augment=False, seed=3))
        state = trainer.init_state()
        state, m = trainer.train_step(state, _torch_batch(_batch(4)))
        runs.append((float(m["loss"]), state.flat["params"].clone(),
                     trainer.text_dropout_seed(state)))
        with torch.no_grad():
            ids = torch.from_numpy(_ids(PAD[arch])).long()
            assert torch.equal(model.encode_text(ids), model.encode_text(ids))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0] and runs[0][2] is not None and runs[2][2] is None


# ------------------------------------------------------------------ positions


def test_bert_family_takes_arange_positions_not_roberta_pad_aware_ones():
    """JAX hands the BERT family positions arange(L) (and zero token types);
    transformers' torch RoBERTa counts them from padding_idx + 1, skipping
    pads. On the same weights the port equals torch RoBERTa given
    position_ids = arange(L), and differs from its default positions."""
    transformers = pytest.importorskip("transformers")
    cfg = {**SMALL["roberta"], "max_position_embeddings": 40}
    pm = phf.HFTextTower(EMBED, "roberta", cfg, "mean_pooler", "linear", 1)
    with torch.no_grad():
        for p in pm.parameters():
            p.copy_(0.1 * torch.randn(p.shape,
                                      generator=torch.Generator().manual_seed(p.numel())))
    ref = transformers.RobertaModel(transformers.RobertaConfig(**cfg),
                                    add_pooling_layer=True).eval()
    sd = {k[len("hf."):]: v for k, v in pm.state_dict().items() if k.startswith("hf.")}
    ref.load_state_dict(sd, strict=False)
    ids = torch.from_numpy(_ids(1)).long()
    mask = (ids != 1).long()
    with torch.no_grad():
        ours = pm.hf(ids, mask.int())
        arange = ref(ids, attention_mask=mask,
                     position_ids=torch.arange(16).expand_as(ids)).last_hidden_state
        default = ref(ids, attention_mask=mask).last_hidden_state
    np.testing.assert_allclose(ours.numpy(), arange.numpy(), atol=1e-5, rtol=1e-4)
    assert (ours - default).abs().max() > 1e-2


# ------------------------------------------------------------------ tokenizer and locks


def test_tokenizer_from_local_files_matches_jax(tmp_path):
    """A config naming a local tokenizer directory gets HFTokenizer, with
    JAX's ids; a name with no local files raises, downloading nothing."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<pad>": 0, "<unk>": 1, **{w: i + 2 for i, w in enumerate(
        "a tumor cell in the stroma near vessels".split())}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                                                unk_token="<unk>")
    fast.save_pretrained(tmp_path / "tok")
    raw = {"embed_dim": 32,
           "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 32, "layers": 1},
           "text_cfg": {"context_length": 8, "hf_tokenizer_name": str(tmp_path / "tok")}}
    path = tmp_path / "model.json"
    path.write_text(json.dumps(raw))
    texts = ["a tumor cell", "the stroma near vessels in a cell", "unseen words"]
    ours = get_tokenizer(str(path))
    assert isinstance(ours, HFTokenizer)
    np.testing.assert_array_equal(ours(texts), jax_get_tokenizer(str(path))(texts))
    raw["text_cfg"]["hf_tokenizer_name"] = str(tmp_path / "missing")
    path.write_text(json.dumps(raw))
    with pytest.raises(FileNotFoundError, match="no local files"):
        get_tokenizer(str(path))


@pytest.mark.parametrize("layers", ["0", "1"])
def test_text_lock_under_an_hf_tower(layers):
    """--lock-text-tower locks the whole HF tower, as JAX's prefixes do; with
    --lock-text-unlocked-layers above 0 JAX's prefixes (text/token_embedding,
    text/transformer/resblocks_i) name no parameter of the tower and freeze
    nothing, so the port raises, naming the option."""
    model = create_model("ViT-Test", precision="fp32", device="meta", training=True, **ROBERTA)
    args = jax_parse_args(["--model", "ViT-Test", "--lock-text-tower",
                           "--lock-text-unlocked-layers", layers])
    if layers == "0":
        assert _lock_prefixes(model, args) == jax_lock_prefixes(
            types.SimpleNamespace(cfg=model.cfg), args) == ("text",)
        return
    jax_prefixes = jax_lock_prefixes(types.SimpleNamespace(cfg=model.cfg), args)
    names = [k for k, _ in model.named_parameters()]
    paths = jax_param_paths(names).values()
    assert not any(p.startswith(tuple(q + "/" for q in jax_prefixes)) for p in paths)
    with pytest.raises(NotImplementedError, match="--lock-text-unlocked-layers"):
        _lock_prefixes(model, args)
