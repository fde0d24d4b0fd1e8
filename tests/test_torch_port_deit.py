"""Port parity: DeiT against the JAX package, on the CPU.

A 2-block C = 128 distilled DeiT with ``VITX_FUSED_MLP=1`` on both sides
(the JAX MLPs through the Pallas fused-MLP kernel in interpret mode, the
port's through the fused MLP's Function on its plain version), weights
carried by ``state_dict_from_jax``: features and every parameter's
gradient; ``deit_test_distilled`` with the flag off; the configs, FLOPs
and default sizes; a Facebook-layout DeiT checkpoint through the port's
loader against ``import_vit`` (two prefix tokens, the position table
interpolated); ``cli.main --arch deit_test_distilled`` and a DeiT bundle.
Inputs come from numpy with a seed; fp32, so the limits cover summation
order (and the TPU kernel's polynomial erf) over two blocks.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_vit
from vit_torch_tpu.checkpoint.torch_import import (
    load_torch_state_dict as jax_load_torch_state_dict)
from vit_torch_tpu.models import deit as jax_deit
from vit_torch_tpu.models.vit import ViTConfig as JaxViTConfig
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import (
    load_backbone_state_dict)
from vit_torch_tpu_torch.cli import export as cli_export
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models import deit, vit
from vit_torch_tpu_torch.models.layers import init_weights
from vit_torch_tpu_torch.models.zoo import Classifier, VisionModelZoo
from vit_torch_tpu_torch.ops import fused_mlp as fm
from vit_torch_tpu_torch.serving import load_bundle


def _pair(cfg, size, seed=0):
    """The JAX distilled backbone (fp32) with its init params and the
    port's with the same weights, and a batch of two images."""
    jmodel = jax_deit.DistilledVisionTransformer(cfg, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  jnp.asarray(x))["params"]
    model = deit.DistilledVisionTransformer(
        vit.ViTConfig(**cfg.__dict__), image_size=size, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, model, x


def test_distilled_deit_matches_jax_under_the_fused_mlp(monkeypatch):
    """``ViTConfig(8, 128, 2, 2)`` at 32 px (N = 16 + 2) with
    ``VITX_FUSED_MLP=1`` on both sides: the JAX ``fits`` holds at T = 36,
    C = 128, hidden 512, so both blocks' MLPs take the Pallas kernel; the
    port's take the fused MLP once per block.  Features within 2e-5; the
    gradient of every parameter (both tokens, the position table) of
    ``sum(features * r)`` within 1e-4 of max |JAX| of that gradient."""
    monkeypatch.setenv("VITX_FUSED_MLP", "1")
    jax_fm = importlib.import_module("vit_torch_tpu.ops.fused_mlp")
    assert jax_fm.fits(2 * 18, 128, 512, 128)
    cfg = JaxViTConfig(8, 128, 2, 2)
    jmodel, params, model, x = _pair(cfg, 32)
    r = np.random.default_rng(4).standard_normal((2, 128)).astype(np.float32)

    def loss(p):
        feats = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(feats * r), feats

    (_, want), wgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    wgrads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads))
    calls = fm.fused_mlp_reference.calls
    got = model(torch.from_numpy(x))
    (got * torch.from_numpy(r)).sum().backward()
    assert fm.fused_mlp_reference.calls == calls + cfg.depth
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(wgrads)
    assert "dist_token" in grads
    for n, w in wgrads.items():
        err = (grads[n] - w).abs().max().item() / w.abs().max().item()
        assert err <= 1e-4, (n, err)


def test_deit_test_distilled_matches_jax_without_the_flag(monkeypatch):
    """``deit_test_distilled`` (C = 64) with the flag off on both sides:
    the same features, and no fused MLP on the port's side."""
    monkeypatch.delenv("VITX_FUSED_MLP", raising=False)
    cfg, distilled = jax_deit.DEIT_CONFIGS["deit_test_distilled"]
    assert distilled
    jmodel, params, model, x = _pair(cfg, 32, seed=1)
    want = jax.jit(lambda p: jmodel.apply({"params": p},
                                          jnp.asarray(x)))(params)
    calls = fm.fused_mlp_reference.calls
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert fm.fused_mlp_reference.calls == calls
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_deit_configs_flops_and_default_sizes_match_jax():
    assert sorted(deit.DEIT_CONFIGS) == sorted(jax_deit.DEIT_CONFIGS)
    for arch, (cfg, distilled) in jax_deit.DEIT_CONFIGS.items():
        pcfg, pdist = deit.DEIT_CONFIGS[arch]
        assert (pcfg.__dict__, pdist) == (cfg.__dict__, distilled), arch
        for size in (224, 384):
            assert deit.deit_flops(arch, size) == \
                jax_deit.deit_flops(arch, size), (arch, size)
        zm = VisionModelZoo.get_model(arch, device="meta")
        assert zm.family == "deit" and zm.patch_size == cfg.patch_size
        assert zm.image_size == (384 if "384" in arch else 224), arch
        backbone = zm.model.backbone
        assert isinstance(backbone, deit.DistilledVisionTransformer) == \
            distilled, arch
        n = (zm.image_size // cfg.patch_size) ** 2
        assert backbone.pos_embed.shape[1] == n + (2 if distilled else 1)
    assert deit.DistilledVisionTransformer.num_prefix_tokens == 2


def _facebook_checkpoint(tmp_path, seed=3):
    """A Facebook-layout distilled DeiT checkpoint of deit_test_distilled
    at 32 px: the port's state dict (its names are timm's) with the
    published files' two heads, wrapped in ``{'model': ...}``."""
    src = deit.DistilledVisionTransformer(
        deit.DEIT_CONFIGS["deit_test_distilled"][0], image_size=32,
        dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(seed))
    sd = dict(src.state_dict())
    for head in ("head", "head_dist"):
        sd[f"{head}.weight"] = torch.zeros(10, 64)
        sd[f"{head}.bias"] = torch.zeros(10)
    path = tmp_path / "deit.pth"
    torch.save({"model": sd}, path)
    return src, path


@pytest.mark.parametrize("size", [32, 48])
def test_facebook_checkpoint_loads_like_import_vit(tmp_path, size):
    """The port's loader and ``import_vit`` on one file give the same
    features at the checkpoint's grid and at a 6 x 6 grid, whose position
    table both interpolate behind the two prefix tokens; the heads are
    left out."""
    src, path = _facebook_checkpoint(tmp_path)
    cfg = jax_deit.DEIT_CONFIGS["deit_test_distilled"][0]
    model = Classifier(deit.DistilledVisionTransformer(
        vit.ViTConfig(**cfg.__dict__), image_size=size, dtype=torch.float32))
    load_backbone_state_dict(str(path), model, size)
    assert model.backbone.pos_embed.shape == (1, (size // 8) ** 2 + 2, 64)
    if size == 32:
        for k, v in src.state_dict().items():
            assert torch.equal(model.backbone.state_dict()[k], v), k
    jmodel = jax_deit.DistilledVisionTransformer(cfg, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    target = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    jparams = import_vit(jax_load_torch_state_dict(str(path)), target)
    want = jax.jit(lambda p: jmodel.apply({"params": p},
                                          jnp.asarray(x)))(jparams)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


CLI_FLAGS = ["--dataset", "synthetic", "--image_size", "32", "--epoch", "1",
             "--bs", "16", "--limit_train", "32", "--limit_test", "16",
             "--scan", "0", "--device", "cpu"]


def test_cli_main_deit_under_the_flag_and_cached(tmp_path, monkeypatch):
    """``cli.main --device cpu`` fine-tunes a C = 128 distilled DeiT (the
    kernel takes C >= 128) with ``VITX_FUSED_MLP=1``: both blocks' MLPs
    through the fused MLP in 2 train and 1 eval steps, finite losses; then
    ``--arch deit_test_distilled`` linear-evaluates on cached features."""
    monkeypatch.setitem(deit.DEIT_CONFIGS, "deit_c128_test",
                        (vit.ViTConfig(8, 128, 2, 2), True))
    fp = str(tmp_path / "stats.json")
    monkeypatch.setenv("VITX_FUSED_MLP", "1")
    calls = fm.fused_mlp_reference.calls
    cli_main.main(CLI_FLAGS + ["--arch", "deit_c128_test", "--stats_fp", fp])
    assert fm.fused_mlp_reference.calls == calls + 2 * (2 + 1)
    d = json.load(open(fp))
    assert d["info"]["arch"] == "deit_c128_test"
    assert d["telem"]["mode"] == "finetune"
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])
    monkeypatch.delenv("VITX_FUSED_MLP")
    cli_main.main(CLI_FLAGS + ["--arch", "deit_test_distilled", "--lineareval",
                               "--cache_features", "--fc", "8", "--stats_fp",
                               fp])
    d = json.load(open(fp))
    assert d["telem"]["mode"] == "lineareval"
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])


def test_deit_bundle_exports_loads_and_predicts(tmp_path):
    """cli.export of a distilled DeiT classifier, loaded onto the CPU,
    predicts the logits of the model it was exported from."""
    out = tmp_path / "bundle"
    cli_export.main(["--arch", "deit_test_distilled", "--classifier", "8,3",
                     "--image_size", "32", "--bs", "1,4", "--dataset",
                     "stl10", "--device", "cpu", "--out", str(out)])
    bundle = load_bundle(str(out), device="cpu")
    assert bundle.manifest["family"] == "deit"
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    logits = bundle.predict(images)
    src = VisionModelZoo.get_model(
        "deit_test_distilled", classifier=[8, 3], image_size=32,
        device="cpu", generator=torch.Generator().manual_seed(0))
    norm = NORM_VALUES["stl10"]
    mean, std = (torch.tensor(norm[k], dtype=torch.bfloat16)
                 for k in ("mean", "std"))
    x = (torch.from_numpy(images).bfloat16() / 255.0 - mean) / std
    with torch.no_grad():
        want = src.model(x).float().numpy()
    np.testing.assert_array_equal(logits, want)
