"""The port's gene side against the JAX package on the same inputs and weights:
the gene tokenizers, the Gene-MLP tower and a CLIP built with it, the
trainer's steps on both gene paths, the ``params.npz`` bridge of the gene
tower, the zero-shot gene-expression metric and evaluation, the ImageNet-style
zero-shot classifier, ``SyntheticExpressionDataset``, the entry points with
``model.global_hvg_path`` and ``experiment=gene_mlp``, the argmax pool under
the gene vocabulary, and one arm of the gene scaling study.

Two paths carry a gene list:
- the gene-vocabulary text tower (path A): a text transformer whose vocab is
  the ``GeneTokenizer``'s (4 special ids + the genes, padded to 128);
- the Gene-MLP tower (path B, ``gene_cfg``): a rank-weighted gene vector
  through an MLP, in place of the text transformer.

ViT-Test is widened to head_dim 64 (width 128, 2 heads), as the other port
tests widen it, so its towers take the attention kernels' geometry; the gene
towers are small (64-300 genes, width 32-128, 1-2 blocks). Models run in
f32 (bf16 rounds XLA's and PyTorch's elementwise work differently on the
CPU). Tolerances, stated in each test, are f32 summation order only.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import eval as jax_eval_entry  # noqa: E402
import train as jax_train_entry  # noqa: E402
from spatial_clip_tpu.models import constants as jax_constants  # noqa: E402
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg  # noqa: E402
from spatial_clip_tpu.models.factory import ModelBundle  # noqa: E402
from spatial_clip_tpu.models.transforms import PreprocessCfg  # noqa: E402
from spatial_clip_tpu.config import compose as jax_compose  # noqa: E402
from spatial_clip_tpu.data.datasets import synthetic as jax_synthetic  # noqa: E402
from spatial_clip_tpu.losses import make_loss as jax_make_loss  # noqa: E402
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP  # noqa: E402
from spatial_clip_tpu.models.factory import get_tokenizer as jax_get_tokenizer  # noqa: E402
from spatial_clip_tpu.models.tokenizer import GeneTokenizer as JaxGeneTokenizer  # noqa: E402
from spatial_clip_tpu.models.tokenizer import GeneVectorizer as JaxGeneVectorizer  # noqa: E402
from spatial_clip_tpu.models.transformer import text_global_pool as jax_pool  # noqa: E402
from spatial_clip_tpu.models.transforms import normalize_batch as jax_normalize  # noqa: E402
from spatial_clip_tpu.parallel.mesh import make_mesh  # noqa: E402
from spatial_clip_tpu.train import evaluate as jax_evaluate  # noqa: E402
from spatial_clip_tpu.train import metrics as jax_metrics  # noqa: E402
from spatial_clip_tpu.train import zero_shot as jax_zero_shot  # noqa: E402
from spatial_clip_tpu.train.checkpoints import load_params_npz as jax_load_npz  # noqa: E402
from spatial_clip_tpu.train.checkpoints import save_params_npz as jax_save_npz  # noqa: E402
from spatial_clip_tpu.train.loop import Trainer as JaxTrainer  # noqa: E402
from spatial_clip_tpu.train.loop import TrainerConfig as JaxTrainerConfig  # noqa: E402
from spatial_clip_tpu_torch import create_model, get_tokenizer  # noqa: E402
from spatial_clip_tpu_torch import eval as port_eval  # noqa: E402
from spatial_clip_tpu_torch.config import compose  # noqa: E402
from spatial_clip_tpu_torch.data.datasets import synthetic  # noqa: E402
from spatial_clip_tpu_torch.losses import make_loss  # noqa: E402
from spatial_clip_tpu_torch.models.config import GeneCfg, resolve_clip_cfg  # noqa: E402
from spatial_clip_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params,
    from_jax_train_state,
    to_jax_params,
)
from spatial_clip_tpu_torch.models.tokenizer import GeneTokenizer, GeneVectorizer  # noqa: E402
from spatial_clip_tpu_torch.models.transformer import GeneMLPTower, text_global_pool  # noqa: E402
from spatial_clip_tpu_torch.models.transforms import normalize_batch  # noqa: E402
from spatial_clip_tpu_torch.train import evaluate, metrics, zero_shot  # noqa: E402
from spatial_clip_tpu_torch.train import entry  # noqa: E402
from spatial_clip_tpu_torch.train.checkpoints import (  # noqa: E402
    load_params_npz,
    save_params_npz,
)
from spatial_clip_tpu_torch.train.loop import Trainer, TrainerConfig  # noqa: E402

CONFIGS = ROOT / "configs"
WIDE = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
GENES = [f"GENE{i}" for i in range(300)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _gene_vectors(seed, B, G, density=0.2):
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=(B, G)) < density
    return (rng.uniform(0.2, 1.0, (B, G)) * keep).astype(np.float32)


def _sentences(seed, n, genes=GENES, length=12):
    """Gene sentences over ``genes``, with a lower-cased symbol and one
    outside the list in every other sentence."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = [genes[j] for j in rng.permutation(len(genes))[:length]]
        if i % 2:
            words[1] = words[1].lower()
            words.insert(3, "NOTAGENE")
        out.append(" ".join(words))
    return out


def _batch(seed, texts, B=8, size=32, k=4):
    rng = np.random.default_rng(seed)
    tile_ids = np.arange(B, dtype=np.int32)
    return {
        "images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
        "texts": texts,
        "image_tile_ids": tile_ids,
        "text_tile_ids": tile_ids.copy(),
        "neighbor_tile_ids": rng.integers(-1, B, (B, k)).astype(np.int32),
        "neighbor_alphas": rng.uniform(0, 1, (B, k)).astype(np.float32),
    }


_BUNDLES: dict = {}


def _both_models(gene_cfg=None, text_cfg=None, **kw):
    """The JAX bundle and the port's training model (f32) on the same
    weights. The port's model is built first (its weights drawn from seed
    0) and JAX's bundle on its weights (flax's op-by-op init takes ~3.5 s a
    call on this CPU), the numpy weights once per configuration, shared by
    the module's tests."""
    over = dict(WIDE)
    if text_cfg:
        over["text_cfg"] = {**WIDE["text_cfg"], **text_cfg}
    if gene_cfg:
        over["gene_cfg"] = gene_cfg
    model = create_model("ViT-Test", precision="fp32", device="cpu", training=True, **over, **kw)
    key = json.dumps([over, kw], sort_keys=True)
    if key not in _BUNDLES:
        _BUNDLES[key] = (jax_resolve_clip_cfg("ViT-Test", **over, **kw),
                         to_jax_params(model.state_dict()))
    cfg, params = _BUNDLES[key]
    model.load_state_dict(from_jax_params(params))
    # device arrays of its own: a JAX Trainer's step may donate them
    return ModelBundle(
        model=JaxCLIP(cfg=cfg, dtype=jnp.float32), params=jax.tree.map(jnp.asarray, params),
        cfg=cfg, model_name="ViT-Test", preprocess_cfg=PreprocessCfg(
            size=cfg.vision_cfg.image_size, mean=jax_constants.OPENAI_DATASET_MEAN,
            std=jax_constants.OPENAI_DATASET_STD)), model


# ---------------------------------------------------------------- tokenizers

GENE_TEXTS = ["GENE1 GENE7 GENE2", "gene3 Gene4 GENE299", "", "   ", "UNKNOWN GENE5 other",
              "GENE0 " * 30, "&amp;GENE8\tGENE9\nGENE10", "GENE11"]


@pytest.mark.parametrize("ctx", [8, 16, 77])
def test_gene_tokenizer_matches_jax_id_for_id(ctx, tmp_path):
    """Ids (upper-cased lookup, <unk> 3, truncation at the context), vocab
    size (304 -> 384), decode, and a gene file read as the list."""
    path = tmp_path / "hvg.txt"
    path.write_text("\n".join(GENES) + "\n\n")
    for genes in (GENES, str(path)):
        ours, theirs = GeneTokenizer(genes, ctx), JaxGeneTokenizer(genes, ctx)
        assert ours.vocab_size == theirs.vocab_size == 384
        np.testing.assert_array_equal(ours(GENE_TEXTS), theirs(GENE_TEXTS))
        ids = ours.encode(GENE_TEXTS[1])
        assert ids == theirs.encode(GENE_TEXTS[1]) and ours.decode(ids) == theirs.decode(ids)
    assert GeneTokenizer(["A"] * 124).vocab_size == 128
    assert GeneTokenizer(["A"] * 125).vocab_size == 256


@pytest.mark.parametrize("pad", [0, 128])
def test_gene_vectorizer_matches_jax_value_for_value(pad):
    """Rank weights 1 - 0.8 r / n at each gene's index (symbols upper-cased),
    num_genes padded to the multiple; float32 (B, num_genes)."""
    ours, theirs = GeneVectorizer(GENES, pad), JaxGeneVectorizer(GENES, pad)
    assert ours.num_genes == theirs.num_genes == (384 if pad else 300)
    got, want = ours(GENE_TEXTS), theirs(GENE_TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(GENE_TEXTS), ours.num_genes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours("GENE3"), theirs("GENE3"))


def test_get_tokenizer_gene_branches_match_jax(tmp_path, caplog):
    """A gene_cfg model gets the vectorizer (no vocab: ValueError; another
    size warns); a gene vocab gives the GeneTokenizer at the model's context."""
    path = tmp_path / "hvg.txt"
    path.write_text("\n".join(GENES[:100]))
    for get in (get_tokenizer, jax_get_tokenizer):
        vec = get("ViT-B-32-GeneMLP", gene_vocab=str(path))
        assert type(vec).__name__ == "GeneVectorizer" and vec.num_genes == 100
        with pytest.raises(ValueError, match="gene_vocab"):
            get("ViT-B-32-GeneMLP")
        tok = get("ViT-B-32", gene_vocab=str(path))
        assert type(tok).__name__ == "GeneTokenizer" and tok.context_length == 77
        assert tok.vocab_size == 128
    assert "gene vocab size 100 != model num_genes 5000" in caplog.text


# ------------------------------------------------------------- the gene tower

TOWER_CASES = {  # num_genes, width, layers, ln_impl
    "g64_w32_l1_onepass": (64, 32, 1, "onepass"),
    "g300_w64_l2_fp32": (300, 64, 2, "fp32"),
    "g200_w128_l2_pallas": (200, 128, 2, "pallas"),
    "g100_w32_l0_onepass": (100, 32, 0, "onepass"),
}


@pytest.mark.parametrize("case", sorted(TOWER_CASES))
def test_gene_tower_forward_and_gradients_match_jax(case, monkeypatch):
    """CLIP.encode_text through the Gene-MLP tower against JAX's (f32,
    gene_dropout 0, the weights through convert): normalized features at
    atol 1e-5, and the gradients of sum(features * R) for every tower
    parameter at 1e-5 + 1e-4 of each one's largest entry. Under
    ln_impl='pallas' only ln_final goes through fused_ln (the block
    LayerNorms keep JAX's two-pass default), once a forward."""
    from spatial_clip_tpu_torch.ops import fused_ln

    calls = []
    monkeypatch.setattr(fused_ln, "reference_ln_fwd",
                        lambda *a, f=fused_ln.reference_ln_fwd: calls.append(1) or f(*a))
    G, width, layers, ln = TOWER_CASES[case]
    jb, model = _both_models(dict(num_genes=G, width=width, layers=layers), ln_impl=ln)
    assert isinstance(model.text, GeneMLPTower) and model.text.ln_final.stats == ln
    assert all(getattr(model.text, f"ln_{i}").stats == "fp32" for i in range(layers))
    x = _gene_vectors(G, 5, G)
    R = np.random.default_rng(1).normal(size=(5, 32)).astype(np.float32)

    def jloss(p):
        f = jb.model.apply({"params": p}, jnp.asarray(x), True, method=JaxCLIP.encode_text)
        return (f * R).sum(), f

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jb.params)
    feats = model.encode_text(_t(x))
    assert len(calls) == (1 if ln == "pallas" else 0)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want), atol=1e-5)
    (feats * _t(R)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters() if k.startswith("text.")}
    want_g = {k: v for k, v in from_jax_params(want_g).items() if k.startswith("text.")}
    assert set(grads) == set(want_g) and len(grads) == 6 + 6 * layers
    for k, w in want_g.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(), err_msg=k)


def test_clip_with_gene_tower_matches_jax():
    """Both towers' features and the spatial loss's gradients for every
    parameter of a CLIP with a Gene-MLP tower (300 genes, width 64, 2
    blocks) against JAX's on the same weights and batch: features at atol
    1e-5, loss at rtol 1e-5, gradients at 1e-5 + 1e-4 of each one's largest
    entry. The state dict holds no text-transformer key."""
    jb, model = _both_models(dict(num_genes=300, width=64, layers=2))
    assert not any(k.startswith(("transformer.", "token_embedding")) for k in model.state_dict())
    batch = _batch(3, GeneVectorizer(GENES)(_sentences(0, 8)))
    x = np.array(jax_normalize(batch["images"]))
    jl = jax_make_loss("spatial", cap_logit_scale=50.0)

    def jloss(p):
        f = jb.model.apply({"params": p}, x, batch["texts"], True)
        return jl(**{**batch, **f})["contrastive_loss"], f

    (want, feats), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jb.params)
    tb = {k: _t(v) for k, v in batch.items()}
    out = model(_t(x), tb["texts"])
    for k in ("image_features", "text_features", "logit_scale"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(feats[k]), atol=1e-5,
                                   err_msg=k)
    loss = make_loss("spatial", cap_logit_scale=50.0)(**{**tb, **out})["contrastive_loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, w in from_jax_params(want_g).items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(w).max(), err_msg=k)


def test_gene_dropout_zeroes_genes_without_rescaling():
    """draw_keep keeps each gene with probability 1 - p (the share over 2e5
    draws within 0.005 of 0.7); the tower's output with a mask is its output
    on the zeroed vector, not rescaled by 1 / (1 - p) as F.dropout would;
    the trainer draws the mask from the state's generator in a training
    step only (a model without dropout draws none)."""
    tower = GeneMLPTower(200, 32, 1, 16, gene_dropout=0.3)
    for p in tower.parameters():
        torch.nn.init.normal_(p, std=0.2)
    g = torch.Generator().manual_seed(0)
    keep = tower.draw_keep((1000, 200), g)
    assert keep.dtype == torch.bool and abs(keep.float().mean().item() - 0.7) < 0.005
    x = _t(_gene_vectors(0, 1000, 200, density=0.5))
    with torch.no_grad():
        got = tower(x, keep)
        np.testing.assert_array_equal(got.numpy(), tower(torch.where(keep, x, 0)).numpy())
        rescaled = tower(torch.where(keep, x / 0.7, 0))
    assert not torch.allclose(got, rescaled, atol=1e-3)
    # in the trainer: a mask from the state's generator in training only
    _, model = _both_models(dict(num_genes=300, width=32, layers=1, gene_dropout=0.5))
    trainer = Trainer(model, make_loss("clip"), TrainerConfig(augment=False))
    state = trainer.init_state()
    texts = _t(GeneVectorizer(GENES)(_sentences(1, 8)))
    before = state.generator.get_state()
    keep = trainer.draw_gene_keep(state, texts)
    assert keep.shape == texts.shape and not torch.equal(state.generator.get_state(), before)
    state.generator.set_state(before)
    batch = {k: _t(v) for k, v in _batch(4, texts.numpy()).items()}
    loss, _, _ = trainer.forward_backward(state, batch)
    state.generator.set_state(before)
    out = trainer._features(state.params, batch, None, trainer.draw_gene_keep(state, texts))
    want = trainer.loss(**{**batch, **out})["contrastive_loss"]
    plain = trainer.loss(**{**batch, **trainer._features(state.params, batch, None)})
    assert torch.equal(loss, want.detach()) and not torch.equal(loss, plain["contrastive_loss"])
    _, plain_model = _both_models(dict(num_genes=300, width=32, layers=1))
    assert Trainer(plain_model, make_loss("clip")).draw_gene_keep(state, texts) is None


# --------------------------------------------------------------- train steps

def _path_models(path):
    """(JAX bundle, port model, texts maker) for path A or B."""
    if path == "gene_vocab":
        tok = GeneTokenizer(GENES, 16)
        jb, model = _both_models(text_cfg=dict(vocab_size=tok.vocab_size))
    else:
        tok = GeneVectorizer(GENES)
        jb, model = _both_models(dict(num_genes=300, width=64, layers=2))
    return jb, model, lambda seed: tok(_sentences(seed, 8))


@pytest.mark.parametrize("path,accum", [("gene_vocab", 1), ("gene_mlp", 1), ("gene_mlp", 2)])
def test_train_steps_match_jax_trainer(path, accum):
    """Three Trainer steps of each path against the JAX Trainer (CPU,
    augment=False, spatial loss with the STE cap, bf16 moments; the lr is 0
    at step 0; grad_accum=2 cached on the Gene-MLP path): loss, grad norm,
    logit scale and lr at rtol 1e-5, exact R@k, parameters at atol 2e-5
    after the three steps (updates are ~1e-3)."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50, augment=False, seed=0,
                  grad_accum=accum)
    jb, model, texts = _path_models(path)
    jt = JaxTrainer(jb, loss=jax_make_loss("spatial", cap_logit_scale=50.0),
                    config=JaxTrainerConfig(**cfg_kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jstep, jstate = jt.make_train_step(), jt.init_state()
    trainer = Trainer(model, make_loss("spatial", cap_logit_scale=50.0), TrainerConfig(**cfg_kw))
    state = trainer.init_state()
    for i in range(3):
        batch = _batch(10 + i, texts(i))
        jstate, jm = jstep(jstate, jt._device_batch(batch))
        state, m = trainer.train_step(state, trainer._device_batch(batch))
        for k in ("loss", "grad_norm", "logit_scale", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=f"step {i} {k}")
        for k in ("R@1", "R@5", "R@10"):
            assert float(m[k]) == float(jm[k]), (i, k)
    want = from_jax_train_state(jax.tree.map(np.asarray, jstate))
    assert (state.count, state.step) == (want.count, want.step) == (3, 3)
    for k, w in want.params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), w.detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)


def test_params_npz_round_trips_the_gene_tower(tmp_path):
    """The gene tower's keys both ways: a JAX params.npz loads into the port
    (create_model(pretrained=...)) with every value equal; the port's
    params.npz loads in JAX to the same tree, bit for bit; to_jax_params
    inverts from_jax_params; an extra or missing gene key raises."""
    jb, _ = _both_models(dict(num_genes=300, width=64, layers=2))
    jax_save_npz(jb.params, str(tmp_path / "jax.npz"))
    model = create_model("ViT-Test", precision="fp32", device="cpu",
                         pretrained=str(tmp_path / "jax.npz"), **WIDE,
                         gene_cfg=dict(num_genes=300, width=64, layers=2))
    want = from_jax_params(jb.params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    save_params_npz(dict(model.named_parameters()), tmp_path / "port.npz")
    back = jax_load_npz(str(tmp_path / "port.npz"))
    flat = jax.tree_util.tree_leaves_with_path(jb.params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf), err_msg=str(path))
    assert set(load_params_npz(tmp_path / "port.npz")["text"]) == {
        "embed", "ln_0", "fc_0", "proj_0", "ln_1", "fc_1", "proj_1", "ln_final", "head"}
    again = to_jax_params(want)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b),
                                     jb.params, again))
    with pytest.raises(NotImplementedError, match="text.ln_5"):
        to_jax_params({**want, "text.ln_5.weight": torch.zeros(64)})
    bad = dict(want)
    del bad["text.head.bias"]
    with pytest.raises(KeyError):
        to_jax_params(bad)


# ------------------------------------------------------------------- metrics

def test_rank_weighted_vectors_and_pearson_rows_match_jax():
    """Targets value for value (exact symbols: a lower-cased gene adds
    nothing here, where the vectorizer counts it); per-row Pearson at atol
    1e-6, a constant row giving 0 in both."""
    caps = _sentences(2, 6) + ["", "GENE1 GENE1 GENE2"]
    idx = {g: i for i, g in enumerate(GENES)}
    got = metrics.rank_weighted_vectors(caps, idx, 300)
    np.testing.assert_array_equal(got, jax_metrics.rank_weighted_vectors(caps, idx, 300))
    low = "GENE1 gene2"
    assert metrics.rank_weighted_vectors([low], idx, 300)[0, 2] == 0
    assert GeneVectorizer(GENES)(low)[0, 2] == np.float32(0.6)
    preds = np.random.default_rng(0).normal(size=(8, 300)).astype(np.float32)
    preds[3] = 1.5  # constant row
    want = np.asarray(jax_metrics.pearson_rows(jnp.asarray(preds), jnp.asarray(got)))
    ours = metrics.pearson_rows(_t(preds), _t(got)).numpy()
    np.testing.assert_allclose(ours, want, atol=1e-6)
    assert ours[3] == want[3] == 0 and ours[6] == want[6] == 0  # constant preds, empty caption


def test_zero_shot_gene_expression_metric_matches_jax(tmp_path):
    """The accumulator over two batches, and from a gene file: the mean PCC
    at atol 1e-6; an empty gene list gives 0."""
    path = tmp_path / "hvg.txt"
    path.write_text("\n".join(GENES))
    ours, theirs = metrics.ZeroShotGeneExpressionMetric(str(path)), \
        jax_metrics.ZeroShotGeneExpressionMetric(str(path))
    so, st = ours.init(), theirs.init()
    for seed in (0, 1):
        logits = np.random.default_rng(seed).normal(size=(6, 300)).astype(np.float32)
        caps = _sentences(seed, 6)
        so = ours.update(so, _t(logits), caps)
        st = theirs.update(st, jnp.asarray(logits), caps)
    np.testing.assert_allclose(ours.compute(so), theirs.compute(st), atol=1e-6)
    assert float(so["total"]) == 12
    empty = metrics.ZeroShotGeneExpressionMetric(genes=[])
    assert empty.compute(empty.update(empty.init(), _t(logits), caps)) == 0.0


@pytest.mark.parametrize("path", ["gene_vocab", "gene_mlp"])
def test_zero_shot_gene_expression_matches_jax(path, tmp_path):
    """encode_gene_bank (300 genes at batch 128: 84 "PAD" rows, the gene
    tokenizer's UNK or the vectorizer's zero row, dropped) at atol 1e-5 and
    zero_shot_gene_expression's PCC at atol 1e-6, on the same weights, over
    a loader of two batches (uint8 tiles, captions with lower-cased and
    unknown symbols) and one without captions, which both skip; the port
    run at a trainer state's parameters gives the same."""
    jb, model, _ = _path_models(path)
    tok = GeneTokenizer(GENES, 16) if path == "gene_vocab" else GeneVectorizer(GENES)
    hvg = tmp_path / "hvg.txt"
    hvg.write_text("\n".join(GENES))
    want_bank = jax_evaluate.encode_gene_bank(jb, jb.params, tok, GENES, batch_size=128)
    bank = evaluate.encode_gene_bank(model, None, tok, GENES, batch_size=128)
    assert bank.shape == (300, 32) and bank.dtype == np.float32
    np.testing.assert_allclose(bank, want_bank, atol=1e-5)
    loader = [{"images": _batch(s, None)["images"], "raw_text": _sentences(s, 8)}
              for s in (5, 6)] + [{"images": _batch(7, None)["images"]}]
    want = jax_evaluate.zero_shot_gene_expression(jb, jb.params, tok, hvg, loader, 128)
    got = evaluate.zero_shot_gene_expression(model, None, tok, hvg, loader, 128)
    state = Trainer(model, make_loss("clip")).init_state()
    at_state = evaluate.zero_shot_gene_expression(model, state.params, tok, hvg, loader, 128)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert at_state == got and -1 <= got <= 1


def test_zero_shot_classifier_and_eval_match_jax():
    """build_zero_shot_classifier (6 ImageNet classes x the 80 OpenAI
    templates of the metadata, 4 classes a batch) at atol 1e-5,
    zero_shot_eval's top-1 / top-5 exactly, imagenet_zero_shot_eval on those
    classes, and the metadata read in place: 1000 names, the same prompts."""
    jb, model = _both_models()
    tok = get_tokenizer("ViT-Test")
    names, templates = zero_shot.load_imagenet_metadata("openai")
    jnames, jtemplates = jax_zero_shot.load_imagenet_metadata("openai")
    assert names == jnames and len(names) == 1000
    assert [t("cat") for t in templates] == [t("cat") for t in jtemplates]
    assert [t("cat") for t in zero_shot.OPENAI_IMAGENET_TEMPLATES] == \
        [t("cat") for t in jax_zero_shot.OPENAI_IMAGENET_TEMPLATES]
    want = jax_zero_shot.build_zero_shot_classifier(jb, jb.params, tok, names[:6], templates, 4)
    got = zero_shot.build_zero_shot_classifier(model, None, tok, names[:6], templates, 4)
    assert got.shape == (32, 6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    rng = np.random.default_rng(0)
    loader = [{"images": rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
               "label": rng.integers(0, 6, 8)} for _ in range(2)]
    assert zero_shot.zero_shot_eval(model, None, got, loader) == \
        jax_zero_shot.zero_shot_eval(jb, jb.params, want, loader)
    assert zero_shot.imagenet_zero_shot_eval(model, None, tok, loader, classnames=names[:6]) == \
        jax_zero_shot.imagenet_zero_shot_eval(jb, jb.params, tok, loader, classnames=names[:6])


# ------------------------------------------------------------------- dataset

@pytest.mark.parametrize("seed,tokenizer", [(0, None), (3, "vectorizer"), (1, "tokenizer")])
def test_synthetic_expression_dataset_items_are_jax_bits(seed, tokenizer):
    """Items 0, 7 and 48 of a 50-spot SyntheticExpressionDataset (32 px)
    and its latent field, loadings and base: the same bits as JAX's."""
    tok = {None: None, "vectorizer": GeneVectorizer(jax_synthetic.synthetic_gene_list()),
           "tokenizer": GeneTokenizer(jax_synthetic.synthetic_gene_list(), 56)}[tokenizer]
    kw = dict(num_samples=50, image_size=32, k_neighbors=6, tokenizer=tok, seed=seed)
    ours = synthetic.SyntheticExpressionDataset(**kw, world_seed=1234 + seed)
    theirs = jax_synthetic.SyntheticExpressionDataset(**kw, world_seed=1234 + seed)
    for a in ("_z", "_W", "_gene_base", "_render_freq", "_render_angle", "_render_phase"):
        np.testing.assert_array_equal(getattr(ours, a), getattr(theirs, a), err_msg=a)
    for i in (0, 7, 48):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert synthetic.synthetic_gene_list() == jax_synthetic.synthetic_gene_list()


# -------------------------------------------------------------- entry points

@pytest.fixture(scope="module")
def gene_files(tmp_path_factory):
    """The widened ViT-Test JSON both packages read (with a 64-wide,
    two-block Gene-MLP tower for experiment=gene_mlp's paths) and a list of
    300 genes whose first 300 are the synthetic dataset's."""
    root = tmp_path_factory.mktemp("gene")
    raw = json.loads((ROOT / "spatial_clip_tpu/models/model_configs/ViT-Test.json").read_text())
    raw["vision_cfg"].update(width=128, heads=2)
    raw["text_cfg"].update(width=128, heads=2)
    (root / "wide.json").write_text(json.dumps(raw))
    raw["gene_cfg"] = {"num_genes": 5000, "width": 64, "layers": 2}
    (root / "wide_gene.json").write_text(json.dumps(raw))
    (root / "hvg.txt").write_text("\n".join(GENES))
    return root


ENTRY_PATHS = {
    # path A: data=synthetic-style smoke run with a gene list (the text tower's
    # vocab becomes the GeneTokenizer's); path B: experiment=gene_mlp on the
    # synthetic data, one worker so that the host crops are drawn in order
    "gene_vocab": ["experiment=smoke_synthetic", "model.model_name={root}/wide.json"],
    "gene_mlp": ["experiment=gene_mlp", "data.dataset_format=synthetic", "data.batch_size=16",
                 "data.num_workers=0", "+data.dataset_format_kwargs.num_samples=64",
                 "+data.dataset_format_kwargs.image_size=32", "model.precision=fp32",
                 "model.model_name={root}/wide_gene.json"],
}


@pytest.mark.parametrize("path", sorted(ENTRY_PATHS))
def test_entry_paths_and_eval_pcc_match_jax(path, gene_files, tmp_path):
    """train(cfg) of each gene path with model.global_hvg_path from the same
    initial weights (JAX's params.npz), augmentation off, 2 steps with
    validation and test, then each package's eval on its own checkpoint:
    losses at rtol 1e-5, rank metrics exactly, test/zero_shot_pcc at atol
    1e-6; the built model is the path's (the gene vocab's 384 ids, or 300
    genes into the gene tower)."""
    root = gene_files
    base = [a.format(root=root) for a in ENTRY_PATHS[path]]
    hvg = f"model.global_hvg_path={root / 'hvg.txt'}"
    jb = jax_train_entry.build_model(jax_compose(CONFIGS, "train", [*base, hvg]))[0]
    npz = tmp_path / "init.npz"
    jax_save_npz(jb.params, str(npz))
    common = [*base, hvg, "trainer.limit_batches=2", "trainer.epochs=1", "save_ckpt=true",
              "test=true", "trainer.augment=false", f"model.pretrained={npz}",
              "trainer.platform=cpu"]
    port_cfg = entry.compose_train([*common, f"paths.root_dir={tmp_path / 'port'}"])
    jax_cfg = jax_compose(CONFIGS, "train", [*common, f"paths.root_dir={tmp_path / 'jax'}"])
    value, objects = entry.train(port_cfg)
    jvalue, jobjects = jax_train_entry.train(jax_cfg)
    model = objects["model"]
    if path == "gene_vocab":
        assert model.cfg.gene_cfg is None and model.token_embedding.weight.shape[0] == 384
        assert objects["datamodule"].tokenizer.vocab_size == 384
    else:
        assert model.cfg.gene_cfg == GeneCfg(num_genes=300, width=64, layers=2)
        assert objects["datamodule"].tokenizer.num_genes == 300
    got, want = objects["metrics"], jobjects["metrics"]
    assert objects["state"].step == int(jobjects["state"].step) == 2
    timing = {"pairs_per_sec", "pairs_per_sec_per_chip"}
    assert set(got) == set(want)
    for k in sorted(set(got) - timing):
        exact = "R@" in k or "rank" in k or k.endswith(("num_samples", "epoch"))
        np.testing.assert_allclose(got[k], float(want[k]), rtol=0 if exact else 1e-5,
                                   atol=0 if exact else 1e-12, err_msg=k)
    np.testing.assert_allclose(value, float(jvalue), rtol=1e-5)
    eval_args = [*base, hvg, "trainer.platform=cpu"]
    ours = port_eval.main([*eval_args, f"paths.root_dir={tmp_path / 'port'}",
                           f"ckpt_path={Path(port_cfg['paths']['output_dir']) / 'checkpoints'}"])
    theirs = jax_eval_entry.evaluate(jax_compose(CONFIGS, "eval", [
        *eval_args, f"paths.root_dir={tmp_path / 'jax'}",
        f"ckpt_path={Path(jax_cfg['paths']['output_dir']) / 'checkpoints'}"]))
    assert set(ours) == set(theirs) and "test/zero_shot_pcc" in ours
    for k in ours:
        exact = "R@" in k or "rank" in k or k.endswith("num_samples")
        tol = dict(rtol=0, atol=1e-6) if k == "test/zero_shot_pcc" else \
            dict(rtol=0 if exact else 1e-5, atol=0 if exact else 1e-12)
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **tol)
    written = json.loads((Path(compose(CONFIGS, "eval", [
        *eval_args, f"paths.root_dir={tmp_path / 'port'}"])["paths"]["output_dir"])
        / "eval_metrics.json").read_text())
    assert written == ours


def test_gene_cfg_overrides_build_the_tower_as_jax(gene_files, tmp_path):
    """model.gene_cfg with a gene list: the vectorizer's size sets
    num_genes over the user's keys, as JAX's build_model does; a dropped
    gene key (one GeneCfg lacks) raises in the port, where JAX drops it."""
    hvg = f"model.global_hvg_path={gene_files / 'hvg.txt'}"
    wide = f"model.model_name={gene_files / 'wide.json'}"
    cfg = entry.compose_train(["experiment=smoke_synthetic", "trainer.platform=cpu", wide, hvg,
                               "+model.gene_cfg={width: 48, layers: 1, gene_dropout: 0.25}"])
    model, _, _, tok, _ = entry.build_model(cfg, "cpu")
    jcfg = jax_compose(CONFIGS, "train", ["experiment=smoke_synthetic", wide, hvg,
                                          "+model.gene_cfg={width: 48, layers: 1, "
                                          "gene_dropout: 0.25}"])
    jbundle, _, _, jtok, _ = jax_train_entry.build_model(jcfg)
    want = jbundle.cfg.gene_cfg
    assert model.cfg.gene_cfg == GeneCfg(want.num_genes, want.width, want.layers,
                                         want.gene_dropout, want.norm_eps)
    assert model.cfg.gene_cfg.num_genes == tok.num_genes == jtok.num_genes == 300
    assert resolve_clip_cfg("ViT-B-32-GeneMLP", gene_cfg={"num_genes": 7}).gene_cfg == \
        GeneCfg(num_genes=7, width=1024, layers=3)
    bad = entry.compose_train(["experiment=smoke_synthetic", "trainer.platform=cpu", wide, hvg,
                               "+model.gene_cfg={hidden: 8}"])
    with pytest.raises(NotImplementedError, match="gene_cfg.hidden"):
        entry.build_model(bad, "cpu")


# ------------------------------------------------------------- argmax pool

def test_gene_vocab_argmax_pool_takes_the_highest_gene_id():
    """text_global_pool's 'argmax' assumes EOT has the highest id; the
    GeneTokenizer's EOT is 2, so both packages pool the position of the
    highest gene id, not EOT's. Under the causal mask that row does not see
    the genes after it: changing a later gene leaves the feature as it was
    (the reference's behaviour, kept for parity; ROADMAP Queue 3)."""
    tok = GeneTokenizer(GENES, 16)
    ids = tok(["GENE5 GENE200 GENE7 GENE9", "GENE3 GENE1"])
    assert ids[0].tolist()[:6] == [1, 9, 204, 11, 13, 2] and ids[1].tolist()[:4] == [1, 7, 5, 2]
    x = np.random.default_rng(0).normal(size=(2, 16, 8)).astype(np.float32)
    ours = text_global_pool(_t(x), _t(ids).long(), "argmax").numpy()
    theirs = np.asarray(jax_pool(jnp.asarray(x), jnp.asarray(ids), "argmax"))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, x[[0, 1], [2, 1]])  # GENE200 at 2, GENE3 at 1
    _, model = _both_models(text_cfg=dict(vocab_size=tok.vocab_size))
    later = tok(["GENE5 GENE200 GENE8 GENE10", "GENE3 GENE2"])
    with torch.no_grad():
        a = model.encode_text(_t(ids).long()).numpy()
        b = model.encode_text(_t(later).long()).numpy()
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- the study

def test_gene_scaling_study_runs_one_arm():
    """One short arm of the study on the CPU: the Gene-MLP tower (width 32,
    one block) over 64 spots of SyntheticExpressionDataset, batch 32, one
    epoch, then the 512 held-out spots: the JAX script's record keys and
    the device, finite losses and val metrics; the arms' parser."""
    from spatial_clip_tpu_torch import gene_scaling_study as study

    out = study.run_arm("gene", 64, 1, 32, gene_width=32, gene_layers=1, device="cpu",
                        generator="expression")
    assert set(out) == {"tower", "spots", "steps", "epochs", "generator", "gene_width",
                        "gene_layers", "train_loss_curve", "val", "elapsed_sec", "device"}
    assert (out["steps"], out["gene_width"], out["gene_layers"]) == (2, 32, 1)
    assert all(np.isfinite(v) for v in out["train_loss_curve"])
    assert out["val"]["num_samples"] == 512 and np.isfinite(out["val"]["loss"])
    assert study.parse_arms("gene:8192,text:64:512:3") == [
        ("gene", 8192, {}), ("text", 64, {"gene_width": 512, "gene_layers": 3})]
