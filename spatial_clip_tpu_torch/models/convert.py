"""JAX parameter tree -> this package's state dict.

:func:`from_jax_params` takes the flax params of ``spatial_clip_tpu``'s CLIP
(nested dicts of arrays) and returns the open_clip-layout state dict the
port's :class:`~spatial_clip_tpu_torch.models.clip.CLIP` loads. For the keys
``spatial_clip_tpu.models.convert.jax_to_torch_state_dict`` exports, keys and
values are the same; it also maps layer-scale, a biased text projection and
the Gene-MLP tower, which that exporter leaves out: its flax tree
``text/embed``, ``text/ln_i``, ``text/fc_i``, ``text/proj_i``,
``text/ln_final``, ``text/head`` is ``text.embed``, ``text.ln_i``, ... here.
A timm-style image tower (``models/timm_model.py``) keeps the flax names,
``/`` as ``.``: ``visual/trunk/stage0_block0/dwconv/kernel`` is
``visual.trunk.stage0_block0.dwconv.weight`` (HWIO -> OIHW, the depthwise
(k, k, 1, C) -> (C, 1, k, k)), a Dense kernel (in, out) -> (out, in), a
LayerNorm's ``scale`` its ``weight``, and a ``Transformer`` inside a trunk
(``visual/trunk/blocks``, ``.../vit``, ``.../attn_stage``) as the ViT
tower's blocks are mapped. The modified ResNet takes open_clip's names
(``visual/layer1_0/downsample_bn/mean`` is
``visual.layer1.0.downsample.1.running_mean``), a Hugging Face text tower
its flax path under ``text.hf`` (``text/hf/layers.0/self_attn.q_proj/kernel``
is ``text.hf.layers.0.self_attn.q_proj.weight``) and ``text.proj1`` /
``text.proj2``. The ViT's attentional pooler keeps its flax names under
``visual.attn_pool`` (``query``, ``ln_k``, ``ln_q``, ``q_proj`` ...
``out_proj``) and a cls-token text tower's ``text/cls_emb`` is ``cls_emb``.
CoCa's tree (``token_embedding_dec/embedding`` present) holds its text
tower under ``text.`` and its decoder under ``decoder.`` (``resblocks_i``
as ``resblocks.i``, the cross-attention's ``q``, ``kv``, ``out``),
``token_embedding_dec``, ``img_to_text_width`` and
``dec_positional_embedding``. :func:`to_jax_params` is the inverse.

:func:`from_open_clip_timm` reads the visual half of an open_clip state
dict whose image tower is a timm ConvNeXt or ViT (``visual.trunk.*``,
``visual.head.*``) as the JAX package's ``torch_to_jax_params`` does.

:func:`from_jax_train_state` maps a JAX ``TrainState`` (parameters and the
Adam moments, with numpy leaves) to the port's
:class:`~spatial_clip_tpu_torch.train.loop.TrainState`.
"""
from __future__ import annotations

import math
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _to_f32(tree):
    """Nested dicts of arrays (bfloat16 ones included, which torch cannot
    take from numpy) as float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return np.asarray(tree).astype(np.float32)


def _key_pairs(has) -> List[Tuple[str, str, Optional[Tuple[int, ...]]]]:
    """(JAX flat key, state-dict key, transpose from JAX to torch) for every
    parameter of a CLIP; ``has(jax_key, state_dict_key)`` says whether an
    optional parameter is present."""
    pairs = []

    def take(jkey: str, tkey: str, transpose=None):
        pairs.append((jkey, tkey, transpose))

    def take_ln(jprefix: str, tprefix: str):
        take(f"{jprefix}/scale", f"{tprefix}.weight")
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_dense(jprefix: str, tprefix: str, optional_bias: bool = False):
        take(f"{jprefix}/kernel", f"{tprefix}.weight", (1, 0))  # flax (in, out) -> torch (out, in)
        if not optional_bias or has(f"{jprefix}/bias", f"{tprefix}.bias"):
            take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_conv(jprefix: str, tprefix: str):  # HWIO -> OIHW
        take(f"{jprefix}/kernel", f"{tprefix}.weight", (3, 2, 0, 1))
        take(f"{jprefix}/bias", f"{tprefix}.bias")

    def take_blocks(jprefix: str, tprefix: str):
        i = 0
        while has(f"{jprefix}/resblocks_{i}/ln_1/scale", f"{tprefix}.resblocks.{i}.ln_1.weight"):
            j, t = f"{jprefix}/resblocks_{i}", f"{tprefix}.resblocks.{i}"
            take_ln(f"{j}/ln_1", f"{t}.ln_1")
            take_ln(f"{j}/ln_2", f"{t}.ln_2")
            take(f"{j}/attn/qkv/kernel", f"{t}.attn.in_proj_weight", (1, 0))
            take(f"{j}/attn/qkv/bias", f"{t}.attn.in_proj_bias")
            take_dense(f"{j}/attn/out", f"{t}.attn.out_proj")
            take_dense(f"{j}/mlp/c_fc", f"{t}.mlp.c_fc")
            take_dense(f"{j}/mlp/c_proj", f"{t}.mlp.c_proj")
            for ls in ("ls_1", "ls_2"):
                if has(f"{j}/{ls}", f"{t}.{ls}.gamma"):
                    take(f"{j}/{ls}", f"{t}.{ls}.gamma")
            i += 1

    def present(jkey: str, tkey: str) -> bool:  # a timm trunk's parameter
        return has(f"visual/trunk/{jkey}", f"visual.trunk.{tkey}")

    def stages(ds_present, take_ds, block_present, take_block):
        """Stage 0's blocks, then each further stage's downsampling and
        blocks, while the next is present."""
        stage = 0
        while stage == 0 or ds_present(stage):
            if stage > 0:
                take_ds(stage)
            b = 0
            while block_present(stage, b):
                take_block(stage, b)
                b += 1
            stage += 1

    def take_timm():
        J, T = "visual/trunk", "visual.trunk"

        def conv(name):  # a trunk-level module or parameter, by its flax name
            take_conv(f"{J}/{name}", f"{T}.{name}")

        def dense(name):
            take_dense(f"{J}/{name}", f"{T}.{name}")

        def ln(name):
            take_ln(f"{J}/{name}", f"{T}.{name}")

        def param(name):
            take(f"{J}/{name}", f"{T}.{name}")

        def ds(stage):  # ViTamin's and FastViT's downsampling convolutions
            return present(f"ds_{stage}/kernel", f"ds_{stage}.weight")

        if present("stem_conv/kernel", "stem_conv.weight"):  # ConvNeXt
            conv("stem_conv")
            ln("stem_norm")

            def block(s_, b):
                p_ = f"stage{s_}_block{b}"
                take_conv(f"{J}/{p_}/dwconv", f"{T}.{p_}.dwconv")
                take_ln(f"{J}/{p_}/norm", f"{T}.{p_}.norm")
                take_dense(f"{J}/{p_}/pwconv1", f"{T}.{p_}.pwconv1")
                take_dense(f"{J}/{p_}/pwconv2", f"{T}.{p_}.pwconv2")
                take(f"{J}/{p_}/gamma", f"{T}.{p_}.gamma")

            def downsample(s_):
                ln(f"ds_norm_{s_}")
                conv(f"ds_conv_{s_}")

            stages(lambda s_: present(f"ds_conv_{s_}/kernel", f"ds_conv_{s_}.weight"), downsample,
                   lambda s_, b: present(f"stage{s_}_block{b}/gamma", f"stage{s_}_block{b}.gamma"),
                   block)
        elif present("stem_conv1/kernel", "stem_conv1.weight"):  # ViTamin
            conv("stem_conv1")
            conv("stem_conv2")

            def block(s_, b):
                p_ = f"stage{s_}_mbconv{b}"
                take_ln(f"{J}/{p_}/norm", f"{T}.{p_}.norm")
                for name in ("expand", "dw", "project"):
                    take_conv(f"{J}/{p_}/{name}", f"{T}.{p_}.{name}")

            stages(ds, lambda s_: conv(f"ds_{s_}"),
                   lambda s_, b: present(f"stage{s_}_mbconv{b}/norm/scale",
                                         f"stage{s_}_mbconv{b}.norm.weight"), block)
            conv("vit_embed")
            param("pos_embed")
            take_blocks(f"{J}/vit", f"{T}.vit")
            ln("norm")
        elif present("stem1/kernel", "stem1.weight"):  # FastViT
            conv("stem1")
            conv("stem2")

            def block(s_, b):
                p_ = f"stage{s_}_block{b}"
                for name in ("mix_norm", "ffn_norm"):
                    take_ln(f"{J}/{p_}/{name}", f"{T}.{p_}.{name}")
                for name in ("mixer", "ffn_fc", "ffn_proj"):
                    take_conv(f"{J}/{p_}/{name}", f"{T}.{p_}.{name}")

            stages(ds, lambda s_: conv(f"ds_{s_}"),
                   lambda s_, b: present(f"stage{s_}_block{b}/mix_norm/scale",
                                         f"stage{s_}_block{b}.mix_norm.weight"), block)
            take_blocks(f"{J}/attn_stage", f"{T}.attn_stage")
            ln("norm")
        elif present("embed_norm/scale", "embed_norm.weight"):  # Swin
            conv("patch_embed")
            ln("embed_norm")

            def block(s_, b):
                p_ = f"stage{s_}_block{b}"
                for name in ("norm1", "norm2"):
                    take_ln(f"{J}/{p_}/{name}", f"{T}.{p_}.{name}")
                for name in ("qkv", "proj", "mlp_fc", "mlp_proj"):
                    take_dense(f"{J}/{p_}/{name}", f"{T}.{p_}.{name}")
                take(f"{J}/{p_}/rel_bias", f"{T}.{p_}.rel_bias")

            def merge(s_):  # patch merging: a LayerNorm and a bias-free Dense
                ln(f"merge_norm_{s_}")
                take_dense(f"{J}/merge_{s_}", f"{T}.merge_{s_}", True)

            stages(lambda s_: present(f"merge_{s_}/kernel", f"merge_{s_}.weight"), merge,
                   lambda s_, b: present(f"stage{s_}_block{b}/norm1/scale",
                                         f"stage{s_}_block{b}.norm1.weight"), block)
            ln("norm")
        elif present("cls_token", "cls_token"):  # EVA
            conv("patch_embed")
            param("cls_token")
            param("pos_embed")
            i = 0
            while present(f"blocks_{i}_ln1/scale", f"blocks_{i}_ln1.weight"):
                for name in ("ln1", "ln2"):
                    ln(f"blocks_{i}_{name}")
                for name in ("qkv", "proj", "w1", "w2", "w3"):
                    dense(f"blocks_{i}_{name}")
                i += 1
            ln("norm")
        else:  # the plain ViT
            conv("patch_embed")
            if present("cls", "cls"):
                param("cls")
            param("pos_embed")
            take_blocks(f"{J}/blocks", f"{T}.blocks")
            ln("norm")
        if has("visual/attn_pool/probe", "visual.attn_pool.probe"):  # the MAP head
            take("visual/attn_pool/probe", "visual.attn_pool.probe")
            for name in ("q", "k", "v", "out", "mlp_fc", "mlp_proj"):
                take_dense(f"visual/attn_pool/{name}", f"visual.attn_pool.{name}")
            take_ln("visual/attn_pool/ln", "visual.attn_pool.ln")
        elif has("visual/attn_pool/q/kernel", "visual.attn_pool.q.weight"):  # attention pool
            if has("visual/attn_pool/pos_embed", "visual.attn_pool.pos_embed"):
                take("visual/attn_pool/pos_embed", "visual.attn_pool.pos_embed")
            for name in ("q", "k", "v", "proj"):
                take_dense(f"visual/attn_pool/{name}", f"visual.attn_pool.{name}")
        if has("visual/head_norm/scale", "visual.head_norm.weight"):
            take_ln("visual/head_norm", "visual.head_norm")
        for name in ("head_proj", "head_mlp_fc", "head_mlp_proj", "head_fc"):
            if has(f"visual/{name}/kernel", f"visual.{name}.weight"):
                take_dense(f"visual/{name}", f"visual.{name}", True)

    def take_bn(jprefix: str, tprefix: str):  # a frozen BatchNorm: open_clip's names
        for j, t in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
            take(f"{jprefix}/{j}", f"{tprefix}.{t}")

    def take_rn():
        for i in (1, 2, 3):
            take(f"visual/conv{i}/kernel", f"visual.conv{i}.weight", (3, 2, 0, 1))
            take_bn(f"visual/bn{i}", f"visual.bn{i}")
        for stage in (1, 2, 3, 4):
            b = 0
            j, t = f"visual/layer{stage}_{b}", f"visual.layer{stage}.{b}"
            while has(f"{j}/conv1/kernel", f"{t}.conv1.weight"):
                for c in (1, 2, 3):
                    take(f"{j}/conv{c}/kernel", f"{t}.conv{c}.weight", (3, 2, 0, 1))
                    take_bn(f"{j}/bn{c}", f"{t}.bn{c}")
                if has(f"{j}/downsample_conv/kernel", f"{t}.downsample.0.weight"):
                    take(f"{j}/downsample_conv/kernel", f"{t}.downsample.0.weight", (3, 2, 0, 1))
                    take_bn(f"{j}/downsample_bn", f"{t}.downsample.1")
                b += 1
                j, t = f"visual/layer{stage}_{b}", f"visual.layer{stage}.{b}"
        take("visual/attnpool/positional_embedding", "visual.attnpool.positional_embedding")
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            take_dense(f"visual/attnpool/{name}", f"visual.attnpool.{name}")

    def take_hf():
        """A Hugging Face text tower: the flax path with ``/`` as ``.`` (a
        kernel, embedding or scale as ``weight``); the M2M encoder's flax
        names hold dots (``layers.0/self_attn.q_proj``), mapped here one by
        one so that the map goes both ways."""
        J, T = "text/hf", "text.hf"

        def emb(j, t):
            take(f"{J}/{j}/embedding", f"{T}.{t}.weight")

        def dense(j, t, bias=True):
            take(f"{J}/{j}/kernel", f"{T}.{t}.weight", (1, 0))
            if bias:
                take(f"{J}/{j}/bias", f"{T}.{t}.bias")

        def ln(j, t):
            take_ln(f"{J}/{j}", f"{T}.{t}")

        if has(f"{J}/embeddings/word_embeddings/embedding",
               f"{T}.embeddings.word_embeddings.weight"):  # the BERT family
            for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
                emb(f"embeddings/{name}", f"embeddings.{name}")
            ln("embeddings/LayerNorm", "embeddings.LayerNorm")
            i = 0
            while has(f"{J}/encoder/layer/{i}/attention/self/query/kernel",
                      f"{T}.encoder.layer.{i}.attention.self.query.weight"):
                j, t = f"encoder/layer/{i}", f"encoder.layer.{i}"
                for name in ("query", "key", "value"):
                    dense(f"{j}/attention/self/{name}", f"{t}.attention.self.{name}")
                dense(f"{j}/attention/output/dense", f"{t}.attention.output.dense")
                ln(f"{j}/attention/output/LayerNorm", f"{t}.attention.output.LayerNorm")
                dense(f"{j}/intermediate/dense", f"{t}.intermediate.dense")
                dense(f"{j}/output/dense", f"{t}.output.dense")
                ln(f"{j}/output/LayerNorm", f"{t}.output.LayerNorm")
                i += 1
            dense("pooler/dense", "pooler.dense")
        elif has(f"{J}/shared/embedding", f"{T}.shared.weight"):  # the T5 family
            emb("shared", "shared")
            i = 0
            while has(f"{J}/encoder/block/{i}/layer/0/SelfAttention/q/kernel",
                      f"{T}.encoder.block.{i}.layer.0.SelfAttention.q.weight"):
                j, t = f"encoder/block/{i}/layer", f"encoder.block.{i}.layer"
                for name in ("q", "k", "v", "o"):
                    dense(f"{j}/0/SelfAttention/{name}", f"{t}.0.SelfAttention.{name}", False)
                if i == 0:
                    emb(f"{j}/0/SelfAttention/relative_attention_bias",
                        f"{t}.0.SelfAttention.relative_attention_bias")
                take(f"{J}/{j}/0/layer_norm/weight", f"{T}.{t}.0.layer_norm.weight")
                for name in ("wi", "wi_0", "wi_1", "wo"):
                    if has(f"{J}/{j}/1/DenseReluDense/{name}/kernel",
                           f"{T}.{t}.1.DenseReluDense.{name}.weight"):
                        dense(f"{j}/1/DenseReluDense/{name}", f"{t}.1.DenseReluDense.{name}",
                              False)
                take(f"{J}/{j}/1/layer_norm/weight", f"{T}.{t}.1.layer_norm.weight")
                i += 1
            take(f"{J}/encoder/final_layer_norm/weight", f"{T}.encoder.final_layer_norm.weight")
        else:  # the M2M100 encoder
            emb("embed_tokens", "embed_tokens")
            i = 0
            while has(f"{J}/layers.{i}/fc1/kernel", f"{T}.layers.{i}.fc1.weight"):
                j, t = f"layers.{i}", f"layers.{i}"
                for name in ("self_attn_layer_norm", "final_layer_norm"):
                    ln(f"{j}/{name}", f"{t}.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    dense(f"{j}/self_attn.{name}", f"{t}.self_attn.{name}")
                dense(f"{j}/fc1", f"{t}.fc1")
                dense(f"{j}/fc2", f"{t}.fc2")
                i += 1
            ln("layer_norm", "layer_norm")
        take("text/proj1/kernel", "text.proj1.weight", (1, 0))
        if has("text/proj2/kernel", "text.proj2.weight"):
            take("text/proj2/kernel", "text.proj2.weight", (1, 0))

    coca = has("token_embedding_dec/embedding", "token_embedding_dec.weight")
    if has("visual/bn1/scale", "visual.bn1.weight"):  # the modified ResNet
        take_rn()
    elif any(present(j, t) for j, t in (("stem_conv/kernel", "stem_conv.weight"),
                                      ("stem_conv1/kernel", "stem_conv1.weight"),
                                      ("stem1/kernel", "stem1.weight"),
                                      ("patch_embed/kernel", "patch_embed.weight"))):
        take_timm()
    else:
        take_blocks("visual/transformer", "visual.transformer")
        take("visual/conv1/kernel", "visual.conv1.weight", (3, 2, 0, 1))  # HWIO -> OIHW
        take("visual/class_embedding", "visual.class_embedding")
        take("visual/positional_embedding", "visual.positional_embedding")
        if has("visual/ln_pre/scale", "visual.ln_pre.weight"):
            take_ln("visual/ln_pre", "visual.ln_pre")
        if has("visual/attn_pool/query", "visual.attn_pool.query"):  # the attentional pooler
            take("visual/attn_pool/query", "visual.attn_pool.query")
            take_ln("visual/attn_pool/ln_k", "visual.attn_pool.ln_k")
            take_ln("visual/attn_pool/ln_q", "visual.attn_pool.ln_q")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                take_dense(f"visual/attn_pool/{name}", f"visual.attn_pool.{name}")
        take_ln("visual/ln_post", "visual.ln_post")
        take("visual/proj", "visual.proj")

    if has("text/embed/kernel", "text.embed.weight"):  # the Gene-MLP tower
        take_dense("text/embed", "text.embed")
        i = 0
        while has(f"text/ln_{i}/scale", f"text.ln_{i}.weight"):
            take_ln(f"text/ln_{i}", f"text.ln_{i}")
            take_dense(f"text/fc_{i}", f"text.fc_{i}")
            take_dense(f"text/proj_{i}", f"text.proj_{i}")
            i += 1
        take_ln("text/ln_final", "text.ln_final")
        take_dense("text/head", "text.head")
    elif has("text/proj1/kernel", "text.proj1.weight"):  # a Hugging Face text tower
        take_hf()
    else:  # the CLIP text tower: on the model itself, under text. in CoCa
        tt = "text." if coca else ""
        take_blocks("text/transformer", f"{tt}transformer")
        take("text/token_embedding/embedding", f"{tt}token_embedding.weight")
        if has("text/cls_emb", f"{tt}cls_emb"):
            take("text/cls_emb", f"{tt}cls_emb")
        take("text/positional_embedding", f"{tt}positional_embedding")
        take_ln("text/ln_final", f"{tt}ln_final")
        if has("text/text_projection/kernel", f"{tt}text_projection.weight"):
            take_dense("text/text_projection", f"{tt}text_projection")
        else:
            take("text/text_projection", f"{tt}text_projection")

    if coca:  # the decoder, its token embedding and positions
        take("token_embedding_dec/embedding", "token_embedding_dec.weight")
        take_dense("img_to_text_width", "img_to_text_width")
        i = 0
        while has(f"decoder/resblocks_{i}/ln_1/scale", f"decoder.resblocks.{i}.ln_1.weight"):
            j, t = f"decoder/resblocks_{i}", f"decoder.resblocks.{i}"
            for name in ("ln_1", "ln_1_kv", "ln_2"):
                take_ln(f"{j}/{name}", f"{t}.{name}")
            take(f"{j}/attn/qkv/kernel", f"{t}.attn.in_proj_weight", (1, 0))
            take(f"{j}/attn/qkv/bias", f"{t}.attn.in_proj_bias")
            take_dense(f"{j}/attn/out", f"{t}.attn.out_proj")
            for name in ("q", "kv", "out"):
                take_dense(f"{j}/cross_attn/{name}", f"{t}.cross_attn.{name}")
            take_dense(f"{j}/mlp/c_fc", f"{t}.mlp.c_fc")
            take_dense(f"{j}/mlp/c_proj", f"{t}.mlp.c_proj")
            i += 1
        take_ln("decoder/ln_final", "decoder.ln_final")
        take("decoder/to_logits/kernel", "decoder.to_logits.weight", (1, 0))
        take("dec_positional_embedding", "dec_positional_embedding")

    take("logit_scale", "logit_scale")
    if has("logit_bias", "logit_bias"):
        take("logit_bias", "logit_bias")
    return pairs


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    for jkey, tkey, transpose in _key_pairs(lambda jkey, tkey: jkey in flat):
        v = flat.pop(jkey)
        out[tkey] = v if transpose is None else v.transpose(transpose)
    if flat:
        raise NotImplementedError(
            f"JAX params with no counterpart in spatial_clip_tpu_torch: {sorted(flat)}")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}  # own, writable copies


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: this package's state dict as
    the JAX package's nested params (float32 numpy arrays)."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state_dict.items()}
    nested: Dict[str, Any] = {}
    for jkey, tkey, transpose in _key_pairs(lambda jkey, tkey: tkey in sd):
        v = sd.pop(tkey)
        if transpose is not None:
            v = v.transpose(np.argsort(transpose))
        node = nested
        *parents, leaf = jkey.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.array(v, order="C")
    if sd:
        raise NotImplementedError(
            f"state-dict keys with no counterpart in the JAX package: {sorted(sd)}")
    return nested


def from_open_clip_timm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An open_clip state dict whose image tower is a timm ConvNeXt
    (``visual.trunk.stem.0.weight``) or a timm ViT
    (``visual.trunk.patch_embed.proj.weight``, the SigLIP and gap flavors)
    in this package's layout. The visual half goes as the JAX package's
    ``torch_to_jax_params`` (``_convert_convnext_visual``,
    ``_convert_timm_vit_visual``) takes it to the flax tree, then through
    :func:`_key_pairs`: timm's ``kv`` of the MAP pool split into k and v, its
    (1, 1, C) latent and class token reshaped to (1, C) and (C,), ``head.*``
    to the adapter's heads. The text half (top level, or under ``text.``)
    and the logit scale and bias keep their names. A visual key the map
    does not take raises."""
    src = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in sd.items()}
    used = set()
    vis: Dict[str, np.ndarray] = {}

    def get(key):
        used.add(key)
        return src[key]

    def lin(tkey, jkey):
        vis[f"{jkey}/kernel"] = get(f"{tkey}.weight").T
        if f"{tkey}.bias" in src:
            vis[f"{jkey}/bias"] = get(f"{tkey}.bias")

    def ln(tkey, jkey):
        vis[f"{jkey}/scale"] = get(f"{tkey}.weight")
        vis[f"{jkey}/bias"] = get(f"{tkey}.bias")

    def conv(tkey, jkey):  # OIHW -> HWIO
        vis[f"{jkey}/kernel"] = get(f"{tkey}.weight").transpose(2, 3, 1, 0)
        vis[f"{jkey}/bias"] = get(f"{tkey}.bias")

    tr, jt = "visual.trunk", "visual/trunk"
    if f"{tr}.stem.0.weight" in src:  # ConvNeXt
        conv(f"{tr}.stem.0", f"{jt}/stem_conv")
        ln(f"{tr}.stem.1", f"{jt}/stem_norm")
        s_ = 0
        while f"{tr}.stages.{s_}.blocks.0.conv_dw.weight" in src:
            if s_ > 0:
                ln(f"{tr}.stages.{s_}.downsample.0", f"{jt}/ds_norm_{s_}")
                conv(f"{tr}.stages.{s_}.downsample.1", f"{jt}/ds_conv_{s_}")
            b = 0
            while f"{tr}.stages.{s_}.blocks.{b}.conv_dw.weight" in src:
                tb, jb = f"{tr}.stages.{s_}.blocks.{b}", f"{jt}/stage{s_}_block{b}"
                conv(f"{tb}.conv_dw", f"{jb}/dwconv")
                ln(f"{tb}.norm", f"{jb}/norm")
                lin(f"{tb}.mlp.fc1", f"{jb}/pwconv1")
                lin(f"{tb}.mlp.fc2", f"{jb}/pwconv2")
                vis[f"{jb}/gamma"] = get(f"{tb}.gamma")
                b += 1
            s_ += 1
        if f"{tr}.head.norm.weight" in src:
            ln(f"{tr}.head.norm", "visual/head_norm")
    elif f"{tr}.patch_embed.proj.weight" in src:  # the ViT trunks
        conv(f"{tr}.patch_embed.proj", f"{jt}/patch_embed")
        pe = get(f"{tr}.pos_embed")
        vis[f"{jt}/pos_embed"] = pe.reshape(-1, pe.shape[-1])
        if f"{tr}.cls_token" in src:
            vis[f"{jt}/cls"] = get(f"{tr}.cls_token").reshape(-1)
        i = 0
        while f"{tr}.blocks.{i}.norm1.weight" in src:
            tb, jb = f"{tr}.blocks.{i}", f"{jt}/blocks/resblocks_{i}"
            ln(f"{tb}.norm1", f"{jb}/ln_1")
            ln(f"{tb}.norm2", f"{jb}/ln_2")
            lin(f"{tb}.attn.qkv", f"{jb}/attn/qkv")  # rows [q; k; v] -> columns [q|k|v]
            lin(f"{tb}.attn.proj", f"{jb}/attn/out")
            lin(f"{tb}.mlp.fc1", f"{jb}/mlp/c_fc")
            lin(f"{tb}.mlp.fc2", f"{jb}/mlp/c_proj")
            i += 1
        ln(f"{tr}.norm", f"{jt}/norm")
        if f"{tr}.attn_pool.latent" in src:  # timm's AttentionPoolLatent (global_pool='map')
            ap, ja = f"{tr}.attn_pool", "visual/attn_pool"
            D = src[f"{ap}.latent"].shape[-1]
            vis[f"{ja}/probe"] = get(f"{ap}.latent").reshape(1, D)
            lin(f"{ap}.q", f"{ja}/q")
            kv_w, kv_b = get(f"{ap}.kv.weight"), get(f"{ap}.kv.bias")
            vis[f"{ja}/k/kernel"], vis[f"{ja}/k/bias"] = kv_w[:D].T, kv_b[:D]
            vis[f"{ja}/v/kernel"], vis[f"{ja}/v/bias"] = kv_w[D:].T, kv_b[D:]
            lin(f"{ap}.proj", f"{ja}/out")
            ln(f"{ap}.norm", f"{ja}/ln")
            lin(f"{ap}.mlp.fc1", f"{ja}/mlp_fc")
            lin(f"{ap}.mlp.fc2", f"{ja}/mlp_proj")
    else:
        raise ValueError("not an open_clip timm ConvNeXt or ViT state dict")
    if "visual.head.proj.weight" in src:
        lin("visual.head.proj", "visual/head_proj")
    if "visual.head.mlp.fc1.weight" in src:
        lin("visual.head.mlp.fc1", "visual/head_mlp_fc")
        lin("visual.head.mlp.fc2", "visual/head_mlp_proj")
    left = sorted(k for k in src if k.startswith("visual.") and k not in used)
    if left:
        raise NotImplementedError(f"open_clip timm keys with no counterpart here: {left}")
    out = {}
    for jkey, tkey, transpose in _key_pairs(lambda jkey, tkey: jkey in vis):
        if jkey in vis:
            v = vis.pop(jkey)
            v = v if transpose is None else v.transpose(transpose)
            out[tkey] = torch.from_numpy(np.array(v))
    for k, v in sd.items():
        if not k.startswith("visual."):
            out[k[len("text."):] if k.startswith("text.") else k] = v
    return out


# the integer entries an OpenAI TorchScript archive holds beside the weights,
# which open_clip drops when it builds the model
OPENAI_ARCHIVE_INTS = ("input_resolution", "context_length", "vocab_size")


def is_torchscript_archive(path) -> bool:
    """Whether ``path`` is a TorchScript archive (OpenAI's CLIP weights):
    a zip file holding scripted code, which ``torch.load`` with
    ``weights_only=True`` refuses."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any("/code/__torch__" in name for name in z.namelist())


def read_openai_archive(path) -> Dict[str, torch.Tensor]:
    """The state dict of the scripted module in an OpenAI TorchScript
    archive, without its :data:`OPENAI_ARCHIVE_INTS`. Its floats stay in
    the archive's dtype (fp16); loading casts them to the model's."""
    sd = torch.jit.load(str(path), map_location="cpu").state_dict()
    return {k: v for k, v in sd.items() if k not in OPENAI_ARCHIVE_INTS}


class _Holder(nn.Module):
    """A scriptable module holding tensors at dotted paths."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def write_openai_archive(state_dict: Dict[str, torch.Tensor], path, image_size: int = 224,
                         context_length: int = 77, vocab_size: int = 49408) -> None:
    """Write ``state_dict`` as OpenAI ships CLIP's weights: a TorchScript
    archive whose module holds every tensor at its key, the floats in fp16,
    with the three integer entries (:data:`OPENAI_ARCHIVE_INTS`)."""
    root = _Holder()
    ints = dict(zip(OPENAI_ARCHIVE_INTS, (image_size, context_length, vocab_size)))
    for key, t in {**state_dict, **{k: torch.tensor(v) for k, v in ints.items()}}.items():
        *parents, leaf = key.split(".")
        mod = root
        for part in parents:
            if not hasattr(mod, part):
                mod.add_module(part, _Holder())
            mod = getattr(mod, part)
        t = t.detach().cpu()
        if t.is_floating_point():
            mod.register_parameter(leaf, nn.Parameter(t.half(), requires_grad=False))
        else:
            mod.register_buffer(leaf, t)
    torch.jit.script(root).save(str(path))


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of a bilinear resize along one axis, as
    ``jax.image.resize`` forms them (``scale_and_translate``): half-pixel
    sample points, the triangle kernel widened by 1 / scale when it
    shrinks (antialiasing), each column normalized over the input samples
    it reaches."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_pos_embed(pe: torch.Tensor, target_len: int,
                     num_prefix_tokens: int = 1) -> torch.Tensor:
    """A ViT's (L, D) positional embedding bilinearly resized to
    ``target_len`` rows, as the JAX package's ``resize_pos_embed`` does:
    the first ``num_prefix_tokens`` rows kept, the square grid after them
    resized (``jax.image.resize``'s bilinear, antialiased when it shrinks),
    in f32 and returned in ``pe``'s dtype."""
    if pe.shape[0] == target_len:
        return pe
    prefix, grid = pe[:num_prefix_tokens], pe[num_prefix_tokens:].float()
    old = int(math.isqrt(grid.shape[0]))
    new = int(math.isqrt(target_len - num_prefix_tokens))
    w = _resize_weights(old, new)  # the same along both axes
    g = grid.reshape(old, old, -1)
    g = torch.einsum("hwc,hi->iwc", g, w)
    g = torch.einsum("iwc,wj->ijc", g, w)
    return torch.cat([prefix, g.reshape(new * new, -1).to(pe.dtype)], 0)


def fit_positional_embeddings(state_dict: Dict[str, torch.Tensor],
                              model_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every 2-D ``*positional_embedding`` whose length
    differs from the model's resized to it (:func:`resize_pos_embed`; one
    prefix token for the image tower, none for the text tower), as the JAX
    package's ``convert_torch_checkpoint`` does before its shape check."""
    out = dict(state_dict)
    for k, v in state_dict.items():
        ref = model_state.get(k)
        if (k.endswith("positional_embedding") and ref is not None and v.dim() == 2
                and v.shape != ref.shape):
            out[k] = resize_pos_embed(v, ref.shape[0], 1 if "visual" in k else 0)
    return out


def convert_mobileclip_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Apple's MobileCLIP checkpoint keys in open_clip's layout, as the JAX
    package maps them: the text encoder (a CLIP text transformer under
    other names) to the text tower's keys, its positional embedding
    squeezed; the image encoder under ``visual.trunk.*`` as it is (the
    FastViT trunks here are not parameter-compatible, so nothing fits
    them); ``logit_scale`` kept."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("text_encoder."):
            k = k[len("text_encoder."):]
            k = k.replace("projection_layer", "text_projection")
            k = k.replace("embedding_layer", "token_embedding")
            if k.startswith("positional_embedding.pos_embed.pos_embed"):
                k = k.replace("positional_embedding.pos_embed.pos_embed", "positional_embedding")
                v = v.squeeze()
            k = k.replace("final_layer_norm", "ln_final")
            k = k.replace("pre_norm_mha.0", "ln_1")
            k = k.replace("pre_norm_mha.1", "attn")
            k = k.replace("pre_norm_ffn.0", "ln_2")
            k = k.replace("pre_norm_ffn.1", "mlp.c_fc")
            k = k.replace("pre_norm_ffn.4", "mlp.c_proj")
            k = k.replace("qkv_proj.weight", "in_proj_weight")
            k = k.replace("qkv_proj.bias", "in_proj_bias")
            k = k.replace("transformer.", "transformer.resblocks.")
            out["text." + k] = v
        elif k.startswith("image_encoder."):
            out["visual.trunk." + k[len("image_encoder."):]] = v
        elif k == "logit_scale":
            out[k] = v
    return out


def detect_checkpoint_flavor(sd: Dict[str, Any]) -> str:
    """``'mobileclip'``, ``'open_clip'`` or ``'unknown'``, from the keys of
    a state dict, as the JAX package classifies them."""
    if "image_encoder.model.patch_embed.0.rbr_conv.0.conv.weight" in sd or \
            "image_encoder.model.patch_emb.0.block.conv.weight" in sd:
        return "mobileclip"
    if any(k.startswith("visual.transformer.resblocks.") for k in sd):
        return "open_clip"
    if "visual.trunk.stem.0.weight" in sd or "visual.trunk.patch_embed.proj.weight" in sd:
        return "open_clip"  # the timm trunks (ConvNeXt, the ViT flavors)
    if any(k.startswith("text_encoder.") for k in sd):
        return "mobileclip"
    return "unknown"


def find_adam_state(opt_state):
    """The Adam state (``count``, ``mu``, ``nu``) inside an optax chain's
    state, nested tuples included."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for part in opt_state:
            found = find_adam_state(part)
            if found is not None:
                return found
    return None


def from_jax_train_state(state, seed: int = 42, device=None):
    """The port's TrainState from a JAX ``TrainState``: ``params`` and the
    Adam moments ``mu``/``nu`` go through :func:`from_jax_params`'s key map
    and transposes (the moments keep their storage dtype: bfloat16 where
    the JAX state stores bfloat16); Adam's ``count`` and the ``step`` are
    copied. The augmentation generator is seeded with ``seed``: JAX's random
    key has no counterpart."""
    from spatial_clip_tpu_torch.train.loop import TrainState

    adam = find_adam_state(state.opt_state)
    leaf = np.asarray(adam.mu["logit_scale"]).dtype
    mu_dtype = torch.bfloat16 if leaf.name == "bfloat16" else torch.float32
    leaf = np.asarray(adam.nu["logit_scale"]).dtype
    nu_dtype = torch.bfloat16 if leaf.name == "bfloat16" else torch.float32
    return TrainState.create(
        from_jax_params(_to_f32(state.params)), from_jax_params(_to_f32(adam.mu)),
        from_jax_params(_to_f32(adam.nu)), count=int(np.asarray(adam.count)),
        step=int(np.asarray(state.step)), mu_dtype=mu_dtype, nu_dtype=nu_dtype, seed=seed,
        device=device)
