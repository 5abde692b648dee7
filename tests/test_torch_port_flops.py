"""The port's FLOP counts and profiler against the JAX package's.

JAX's ``profile_model`` takes XLA's cost analysis of the compiled forward
(here on abstract parameters from ``jax.eval_shape``: no flax init);
the port's counts the model's products with ``FlopCounterMode`` on a
``meta`` copy. XLA also counts elementwise work, so the port's counts run
a little under XLA's: ViT-B-32 (fp32) image 8.818 against 8.850 (-0.36%),
text 5.960 against 5.994 (-0.57%), both 14.777 against 14.844 (-0.45%),
held at 2%. RN50's image count runs over XLA's (11.586 against 11.321,
+2.34%: its blur pools, average pools as convolutions here, are reduce
windows there, which XLA counts otherwise), text 5.960 against 5.989
(-0.48%), both 17.546 against 17.310 (+1.36%): held at 3%. The parameter
counts are equal exactly. The ``meta`` count equals the CPU count.
"""
from __future__ import annotations

import tests.helpers.torch_threads  # noqa: F401  (xdist workers share the cores)

import csv
import json

import jax
import jax.numpy as jnp
import pytest

from spatial_clip_tpu.cli import profiler as jax_profiler
from spatial_clip_tpu.models.clip import CLIP as JaxCLIP
from spatial_clip_tpu.models.config import resolve_clip_cfg as jax_resolve_clip_cfg
from spatial_clip_tpu.models.factory import ModelBundle
from spatial_clip_tpu.ops import flops as jax_flops
from spatial_clip_tpu_torch.cli import profiler
from spatial_clip_tpu_torch.models.factory import create_model
from spatial_clip_tpu_torch.ops import flops

KEYS = ["model", "image_size", "mparams", "image_gflops", "text_gflops", "gflops",
        "bytes_accessed_mb"]


def _jax_profile(name: str) -> dict:
    """JAX's profile_model of ``name`` in f32, its parameters abstract."""
    cfg = jax_resolve_clip_cfg(name)
    model = JaxCLIP(cfg=cfg, dtype=jnp.float32)
    size = cfg.vision_cfg.image_size
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))["params"]
    return jax_flops.profile_model(ModelBundle(model=model, params=params, cfg=cfg,
                                               model_name=name))


@pytest.mark.parametrize("name,tol", [("ViT-B-32", 0.02), ("RN50", 0.03)])
def test_gflops_within_tolerance_of_xla_and_params_exact(name, tol):
    ours = flops.profile_model(create_model(name, precision="fp32", device="meta"))
    theirs = _jax_profile(name)
    assert list(ours) == KEYS
    assert ours["model"] == theirs["model"] and ours["image_size"] == theirs["image_size"]
    assert ours["mparams"] == theirs["mparams"]
    for key in ("image_gflops", "text_gflops", "gflops"):
        assert abs(ours[key] / theirs[key] - 1) <= tol, (key, ours[key], theirs[key])
    assert ours["bytes_accessed_mb"] > 0


def test_meta_count_equals_cpu_count():
    """The same counts, bytes included, on a meta copy and on the CPU, in
    each precision (fp32 at batch 3 with the train count); the profile
    leaves the model's requires_grad flags as they were."""
    over = dict(vision_cfg=dict(width=128, heads=2), text_cfg=dict(width=128, heads=2))
    for precision, batch, train in (("fp32", 3, True), ("bf16", 1, False)):
        meta = create_model("ViT-Test", precision=precision, device="meta", **over)
        cpu = create_model("ViT-Test", precision=precision, device="cpu", **over)
        assert flops.count_params(meta) == flops.count_params(cpu) == \
            sum(p.numel() for p in cpu.state_dict().values() if p.is_floating_point())
        got = flops.profile_model(meta, batch_size=batch, train=train)
        assert got == flops.profile_model(cpu, batch_size=batch, train=train)
        assert got.get("train_gflops", 3 * got["gflops"]) > 2 * got["gflops"] > 0
        assert not any(p.requires_grad for p in meta.parameters())


def test_wrappers_run_their_plain_version_on_meta():
    """On a meta tensor each wrapper returns its plain version's shapes,
    counting no launch, as on the CPU; ``flops.cost`` counts the same
    products on meta as on the CPU."""
    import torch

    from spatial_clip_tpu_torch.ops import fused_attention as fa
    from spatial_clip_tpu_torch.ops import fused_ln as fl
    from spatial_clip_tpu_torch.ops import fused_ln_dense as fd
    from spatial_clip_tpu_torch.ops import fused_mlp as fm

    qkv = torch.randn(2, 9, 384)
    x, w, b = torch.randn(6, 128), torch.randn(256, 128), torch.randn(256)
    before = (fa.fused_attention.launches, fa.fused_attention_lse.launches,
              fl.fused_ln_fwd.launches, fd.ln_dense_fwd.launches, fm.fused_mlp_fwd.launches)
    calls = (
        (fa.fused_attention, (qkv, None, 2)),
        (fa.fused_attention_lse, (qkv, None, 2)),
        (fl.fused_ln_fwd, (x, torch.ones(128), torch.zeros(128), 1e-5)),
        (fd.ln_dense_fwd, (x, w, b, 1e-5)),
        (fm.fused_mlp_fwd, (x, w, b, w.t().contiguous(), torch.randn(128))),
    )
    for fn, args in calls:
        cpu = fn(*args)
        meta = fn(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in args])
        for c, m in zip(cpu if isinstance(cpu, tuple) else (cpu,),
                        meta if isinstance(meta, tuple) else (meta,)):
            assert m.is_meta and m.shape == c.shape and m.dtype == c.dtype, fn.__name__
        meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
        assert flops.cost(fn, *meta_args) == flops.cost(fn, *args), fn.__name__
    assert before == (fa.fused_attention.launches, fa.fused_attention_lse.launches,
                      fl.fused_ln_fwd.launches, fd.ln_dense_fwd.launches,
                      fm.fused_mlp_fwd.launches)


def test_byte_counter_counts_operands_and_results_not_views():
    import torch

    a, b = torch.ones(4, 8, device="meta"), torch.ones(8, 2, device="meta")
    with flops.ByteCounter() as counter:
        (a @ b).view(-1)
    assert counter.bytes == (32 + 16 + 8) * 4


def test_profiler_cli_rows_and_csv_as_jax(tmp_path, capsys):
    """The CLI's flags, one JSON row a model, the skip line of a model it
    cannot build and JAX's CSV layout."""
    out = tmp_path / "costs.csv"
    rows = profiler.main(["--model", "ViT-Test", "no-such-model", "--train", "--precision",
                          "fp32", "--results-file", str(out)])
    captured = capsys.readouterr()
    assert [json.loads(line) for line in captured.out.splitlines()] == rows
    assert "skip no-such-model" in captured.err
    assert list(rows[0]) == KEYS + ["train_gflops"]
    with open(out, newline="") as f:
        assert list(csv.DictReader(f))[0]["mparams"] == str(rows[0]["mparams"])
    jax_rows = jax_profiler.main(["--model", "ViT-Test", "--precision", "fp32"])
    assert list(jax_rows[0]) == KEYS
    assert rows[0]["mparams"] == jax_rows[0]["mparams"]
    assert flops.feature_take_indices(4, None) == jax_flops.feature_take_indices(4, None)
    assert flops.feature_take_indices(4, [-1, 0]) == jax_flops.feature_take_indices(4, [-1, 0])
