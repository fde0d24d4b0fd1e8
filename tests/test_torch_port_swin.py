"""Port parity: the Swin slice against the JAX package, on the CPU.

The backbone from the same weights (carried over by ``state_dict_from_jax``)
on both block routes: the whole-block route (B9) on maps the window tiles,
the window-block route (B8) on maps that need padding; the feature-map
modes; the Microsoft-layout checkpoint importer against ``import_swin``;
the ``main_swin`` CLI and a Swin serving bundle.  The JAX side runs its
Pallas kernels in interpret mode through ``VITX_FUSED_FULL=1`` and
``VITX_FUSED_SPATIAL=1``, as ``tests/test_fused_block.py`` does.  Inputs
come from numpy with a seed and everything runs in fp32, so the tolerances
cover summation order over a few blocks of values of order 1.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_swin
from vit_torch_tpu.checkpoint.torch_import import (
    load_torch_state_dict as jax_load_torch_state_dict)
from vit_torch_tpu.cli.main_swin import main as jax_main_swin
from vit_torch_tpu.models import swin as jax_swin
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import (
    load_backbone_state_dict)
from vit_torch_tpu_torch.cli import export as cli_export
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.cli import main_swin as main_swin_mod
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models import swin
from vit_torch_tpu_torch.models.layers import init_weights
from vit_torch_tpu_torch.models.zoo import Classifier, VisionModelZoo
from vit_torch_tpu_torch.ops import window_block as wb
from vit_torch_tpu_torch.serving import load_bundle

# head dim 32, as every published Swin config has, so both routes reach the
# Pallas kernels on the JAX side
D32 = jax_swin.SwinConfig(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                          window_size=4, drop_path_rate=0.0)
ATOL = 2e-4


def _port_config(cfg):
    return swin.SwinConfig(**dataclasses.asdict(cfg))


def _pair(cfg, image_size, monkeypatch, **mode):
    """The JAX backbone (its init params) and the port backbone with the
    same weights, both fp32.  The JAX model is initialised on its XLA path
    (the same parameter tree, without the interpret-mode kernels' cost);
    its later applies take the Pallas kernels."""
    jmodel = jax_swin.SwinTransformer(cfg, dtype=jnp.float32, **mode)
    x = np.random.default_rng(0).standard_normal(
        (2, image_size, image_size, 3)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    monkeypatch.setenv("VITX_FUSED_FULL", "1")
    monkeypatch.setenv("VITX_FUSED_SPATIAL", "1")
    model = swin.SwinTransformer(_port_config(cfg), image_size=image_size,
                                 dtype=torch.float32, **mode).eval()
    model.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, model, x


def _jax_apply(jmodel, params, x):
    """The JAX model's eval forward, jitted (traced with the environment's
    kernel flags)."""
    return jax.jit(lambda p, x: jmodel.apply({"params": p}, x, True))(
        params, jnp.asarray(x))


def _count_routes(monkeypatch):
    """Count the port's calls of the two block functions."""
    counts = {"b8": 0, "b9": 0}
    for key, name in (("b8", "window_block_spatial"),
                      ("b9", "window_block_full_spatial")):
        fn = getattr(wb, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(wb, name, counted)
    return counts


# (config, image size, blocks on the B8 route, on the B9 route): 32 px
# gives 8 x 8 and 4 x 4 maps that window 4 tiles (stage 2: one window, no
# shift); 40 px gives 10 x 10 and 5 x 5 maps, both padded; swin_test3 has
# head dim 8 (JAX takes its plain XLA path there)
MODEL_CASES = [(D32, 32, 0, 4), (D32, 40, 4, 0),
               (jax_swin.SWIN_CONFIGS["swin_test3"], 32, 0, 3)]


@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
def test_swin_backbone_matches_jax(case, monkeypatch):
    cfg, size, n_b8, n_b9 = MODEL_CASES[case]
    jmodel, params, model, x = _pair(cfg, size, monkeypatch)
    want = _jax_apply(jmodel, params, x)
    counts = _count_routes(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert counts == {"b8": n_b8, "b9": n_b9}
    assert got.shape == (2, cfg.feature_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-4)


def test_swin_feature_maps_match_jax(monkeypatch):
    """``multi_features``: every stage's map, the last one normed; and
    ``features_only``: the final normed map."""
    jmodel, params, model, x = _pair(D32, 32, monkeypatch,
                                     multi_features=True)
    want = _jax_apply(jmodel, params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 8, 8, 64), (2, 4, 4, 128)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-4)
    model.multi_features, model.features_only = False, True
    with torch.no_grad():
        final = model(torch.from_numpy(x))
    np.testing.assert_array_equal(final.numpy(), got[-1].numpy())


def test_swin_train_mode_without_drop_path_matches_eval(monkeypatch):
    """Block 0's drop-path rate is 0, so it keeps the B9 route in train
    mode; a model whose rates are all 0 is its eval self in train mode."""
    model = swin.SwinTransformer(_port_config(D32), image_size=32,
                                 dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    counts = _count_routes(monkeypatch)
    with torch.no_grad():
        ref = model.eval()(x)
        got = model.train()(x)
    assert counts == {"b8": 0, "b9": 8}
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    rates = swin.SwinTransformer(
        _port_config(dataclasses.replace(D32, drop_path_rate=0.1)),
        image_size=32)
    blocks = [b for layer in rates.layers for b in layer.blocks]
    assert [b.drop_path.rate for b in blocks] == pytest.approx(
        [0.0, 0.1 / 3, 0.2 / 3, 0.1])
    rates.train()
    assert [b._full_block_route(False) for b in blocks] == [True, False,
                                                            False, False]


def test_swin_flops_match_jax():
    for arch in ("swin_base_patch4_window12_384", "swin_tiny_patch4_window7_224"):
        for size in (224, 384):
            assert swin.swin_flops(swin.SWIN_CONFIGS[arch], size) == \
                jax_swin.swin_flops(jax_swin.SWIN_CONFIGS[arch], size)
    assert sorted(swin.SWIN_CONFIGS) == sorted(jax_swin.SWIN_CONFIGS)


# --------------------------------------------------------------------------
# the Microsoft-layout importer

def _microsoft_checkpoint(tmp_path, seed=3):
    """A Microsoft-layout Swin checkpoint of the D32 config: the port's
    state dict (its names are Microsoft's) plus the buffers and head keys
    the published files carry, wrapped in ``{'model': ...}``."""
    src = swin.SwinTransformer(_port_config(D32), image_size=32,
                               dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(seed))
    sd = dict(src.state_dict())
    for li, layer in enumerate(src.layers):
        for bi, blk in enumerate(layer.blocks):
            pre = f"layers.{li}.blocks.{bi}"
            sd[f"{pre}.attn.relative_position_index"] = \
                blk.attn.relative_position_index
            if blk.attn_mask.numel():
                sd[f"{pre}.attn_mask"] = blk.attn_mask
    sd["head.weight"] = torch.zeros(10, 128)
    sd["head.bias"] = torch.zeros(10)
    path = tmp_path / "swin.pth"
    torch.save({"model": sd}, path)
    return src, sd, path


def test_microsoft_checkpoint_loads_like_import_swin(tmp_path):
    src, sd, path = _microsoft_checkpoint(tmp_path)
    model = Classifier(swin.SwinTransformer(_port_config(D32), image_size=32,
                                            dtype=torch.float32))
    load_backbone_state_dict(str(path), model, 32)
    for k, v in src.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    jparams = import_swin(jax_load_torch_state_dict(str(path)), None)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = _jax_apply(jax_swin.SwinTransformer(D32, dtype=jnp.float32),
                      jparams, x)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-4)


def test_microsoft_checkpoint_mismatch_raises(tmp_path):
    _, sd, path = _microsoft_checkpoint(tmp_path)
    model = Classifier(swin.SwinTransformer(_port_config(D32), image_size=32,
                                            dtype=torch.float32))
    del sd["layers.1.blocks.0.mlp.fc1.weight"]
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="lacks"):
        load_backbone_state_dict(str(path), model, 32)
    sd["layers.1.blocks.0.mlp.fc1.weight"] = torch.zeros(3, 3)
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="shapes"):
        load_backbone_state_dict(str(path), model, 32)


# --------------------------------------------------------------------------
# the CLI and serving

CLI_FLAGS = ["--arch", "swin_test", "--dataset", "synthetic", "--image_size",
             "32", "--epoch", "1", "--bs", "16", "--device", "cpu"]


def _keys(d):
    return {"top": set(d), "info": set(d["info"]), "telem": set(d["telem"]),
            "results": set(d["results"]),
            "rows": {k: set(d[k][0]) for k in ("train", "val")},
            "epochs": {k: len(d[k]) for k in ("train", "val")}}


def test_cli_main_swin_lineareval_has_the_jax_schema(tmp_path, monkeypatch):
    """``main_swin --lineareval`` on the CPU, with ``--pretrained
    --torch_ckpt`` holding a Microsoft-layout checkpoint: the stats JSON has
    the JAX CLI's keys and the frozen backbone ends the run as loaded."""
    src = VisionModelZoo.get_model("swin_test", image_size=32, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    ckpt = tmp_path / "swin.pth"
    torch.save({"model": src.model.backbone.state_dict()}, ckpt)
    seen = []

    class Recording(cli_main.Trainer):
        def __init__(self, zoo_model, **kw):
            seen.append(zoo_model)
            super().__init__(zoo_model, **kw)

    monkeypatch.setattr(cli_main, "Trainer", Recording)
    fp, jfp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    main_swin_mod.main(CLI_FLAGS + ["--lineareval", "--pretrained", "--torch_ckpt",
                           str(ckpt), "--stats_fp", fp])
    jax_main_swin(CLI_FLAGS + ["--lineareval", "--stats_fp", jfp])
    got, want = (json.load(open(p)) for p in (fp, jfp))
    assert _keys(got) == _keys(want)
    assert got["info"]["arch"] == "swin_test"
    assert got["telem"]["mode"] == "lineareval"
    assert all(np.isfinite(r["loss"]) for r in got["train"] + got["val"])
    assert seen[0].family == "swin"
    for k, v in src.model.backbone.state_dict().items():
        assert torch.equal(seen[0].model.backbone.state_dict()[k], v), k


def test_cli_main_swin_finetunes_and_caches_on_the_cpu(tmp_path):
    """On the CPU, Swin fine-tuning runs through the plain versions; the
    cached linear eval runs too."""
    fp = str(tmp_path / "s.json")
    main_swin_mod.main(CLI_FLAGS + ["--stats_fp", fp])
    d = json.load(open(fp))
    assert d["telem"]["mode"] == "finetune"
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])
    main_swin_mod.main(CLI_FLAGS + ["--lineareval", "--cache_features", "--fc", "8",
                           "--stats_fp", fp])
    d = json.load(open(fp))
    assert d["telem"]["mode"] == "lineareval" and len(d["val"]) == 1
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])


def test_cli_main_swin_defaults_to_the_jax_twins_arch(monkeypatch):
    seen = []
    monkeypatch.setattr(main_swin_mod, "_main", seen.append)
    main_swin_mod.main(["--bs", "8"])
    main_swin_mod.main(["--arch", "swin_test"])
    assert seen == [["--arch", "swin_base_patch4_window7_224", "--bs", "8"],
                    ["--arch", "swin_test"]]


def test_swin_bundle_exports_loads_and_predicts(tmp_path):
    """cli.export of a Swin classifier, loaded onto the CPU (built on meta,
    its computed buffers recomputed), predicts the logits of the model it
    was exported from."""
    out = tmp_path / "bundle"
    cli_export.main(["--arch", "swin_test", "--classifier", "8,3",
                     "--image_size", "32", "--bs", "1,4", "--dataset",
                     "stl10", "--device", "cpu", "--out", str(out)])
    bundle = load_bundle(str(out), device="cpu")
    assert bundle.manifest["family"] == "swin"
    assert bundle.manifest["image_size"] == 32
    blk = bundle.model.backbone.layers[0].blocks[0]
    assert torch.equal(blk.attn.relative_position_index,
                       torch.from_numpy(swin.relative_position_index(4)))
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    logits = bundle.predict(images)
    src = VisionModelZoo.get_model(
        "swin_test", classifier=[8, 3], image_size=32, device="cpu",
        generator=torch.Generator().manual_seed(0))
    norm = NORM_VALUES["stl10"]
    mean, std = (torch.tensor(norm[k], dtype=torch.bfloat16)
                 for k in ("mean", "std"))
    x = (torch.from_numpy(images).bfloat16() / 255.0 - mean) / std
    with torch.no_grad():
        want = src.model(x).float().numpy()
    np.testing.assert_array_equal(logits, want)
    assert VisionModelZoo.get_model(
        "swin_base_patch4_window12_384_22k", device="meta").image_size == 384
