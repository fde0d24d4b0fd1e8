"""Port parity: the CaiT slice against the JAX package, on the CPU.

The plain talking-heads version against both Pallas kernels in interpret
mode (``_kernel`` through ``talking_heads_attention``, ``_kernel_v2``
through ``talking_heads_attention_bnc``), forward and every gradient; the
talking-heads and class-attention modules; the backbone with the JAX model
on its fused-kernel route (``VITX_FUSED_TH=1``) and on its XLA route
(``=0``), forward and parameter gradients; a 3-step AdamW fine-tune against
the JAX train step; the Facebook/timm ``.pth`` importer against
``import_cait``; the configs, FLOPs, default sizes and seeded LayerScale;
the CLI and a CaiT serving bundle.  Inputs come from numpy with a seed and
everything runs in fp32, so the tolerances cover summation order.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_cait
from vit_torch_tpu.checkpoint.torch_import import (
    load_torch_state_dict as jax_load_torch_state_dict)
from vit_torch_tpu.cli.main import main as jax_main
from vit_torch_tpu.models import cait as jax_cait
from vit_torch_tpu.models.layers import ClassifierHead as JaxClassifierHead
from vit_torch_tpu.models.zoo import Classifier as JaxClassifier
from vit_torch_tpu.models.zoo import ZooModel as JaxZooModel
from vit_torch_tpu.ops import talking_heads as jax_th
from vit_torch_tpu.train import steps as jax_steps
from vit_torch_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import (
    load_backbone_state_dict)
from vit_torch_tpu_torch.cli import export as cli_export
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models import cait
from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
from vit_torch_tpu_torch.models.zoo import Classifier, VisionModelZoo
from vit_torch_tpu_torch.ops import talking_heads as th
from vit_torch_tpu_torch.serving import load_bundle
from vit_torch_tpu_torch.train import steps
from vit_torch_tpu_torch.train.optimizers import get_optimizer

# head dim 48, as every published CaiT config has (cait_test has 16)
D48 = jax_cait.CaiTConfig(embed_dim=96, num_heads=2, depth=2, patch_size=16)
# (config, image size): 16 tokens each
MODELS = [(jax_cait.CAIT_CONFIGS["cait_test"], 32), (D48, 64)]
GRADS = "q k v wl bl ww bw".split()


def _port_config(cfg):
    return cait.CaiTConfig(**dataclasses.asdict(cfg))


def _th_inputs(shape, seed):
    """q, k, v of std 1 and fp32 tables: mixes of std 0.3 around the
    identity (a trained CaiT's are near it), biases of std 0.1."""
    B, H, N, D = shape
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    eye = np.eye(H, dtype=np.float32)
    tables = [eye + 0.3 * rng.standard_normal((H, H)).astype(np.float32),
              0.1 * rng.standard_normal(H).astype(np.float32),
              eye + 0.3 * rng.standard_normal((H, H)).astype(np.float32),
              0.1 * rng.standard_normal(H).astype(np.float32)]
    return qkv + tables, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 37, 32), (1, 8, 197, 48)],
                         ids=str)
def test_plain_talking_heads_matches_pallas_kernel(shape):
    """The port's entry (the plain version on the CPU, its backward the
    recompute) against the Pallas ``_kernel`` in interpret mode (N padded to
    a multiple of 16 and masked) and ``jax.grad`` through its custom VJP:
    the output and all seven gradients of ``sum(out * r)``."""
    args, r = _th_inputs(shape, seed=shape[2])
    want = jax_th.talking_heads_attention(*map(jnp.asarray, args))
    wgrads = jax.grad(lambda a: jnp.sum(
        jax_th.talking_heads_attention(*a) * r))(tuple(map(jnp.asarray,
                                                           args)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    calls = th.talking_heads_reference.calls, th.talking_heads_bwd.calls
    got = th.talking_heads_attention(*leaves)
    (got * torch.from_numpy(r)).sum().backward()
    assert (th.talking_heads_reference.calls,
            th.talking_heads_bwd.calls) == (calls[0] + 1, calls[1] + 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-5, rtol=1e-4)
    for name, leaf, w in zip(GRADS, leaves, wgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3, err_msg=name)


def test_plain_bnc_matches_pallas_v2_kernel():
    """The (B, N, C) entry and the (B, N, C) plain version against the
    Pallas ``_kernel_v2`` (mix as contraction, bl dropped, bw folded as
    bw * colsum(V)) at a padded N: output and gradients; bl's gradient is
    ~0 on both sides (softmax is shift-invariant)."""
    B, H, N, D = 2, 4, 37, 32
    (q, k, v, *tables), r = _th_inputs((B, H, N, D), seed=5)
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(B, N, H * D)
               for x in (q, k, v))
    r = r.transpose(0, 2, 1, 3).reshape(B, N, H * D)
    args = (q, k, v, *tables)
    want = jax_th.talking_heads_attention_bnc(*map(jnp.asarray, args),
                                              num_heads=H)
    wgrads = jax.grad(lambda a: jnp.sum(jax_th.talking_heads_attention_bnc(
        *a, num_heads=H) * r))(tuple(map(jnp.asarray, args)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = th.talking_heads_attention_bnc(*leaves, num_heads=H)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-5, rtol=1e-4)
    plain = th.talking_heads_bnc_reference(*map(torch.from_numpy, args),
                                           num_heads=H)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)
    for name, leaf, w in zip(GRADS, leaves, wgrads):
        if name == "bl":
            assert leaf.grad.abs().max().item() < 1e-3
            assert float(jnp.max(jnp.abs(w))) < 1e-3
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3, err_msg=name)


def test_talking_heads_bf16_rounds_where_the_reference_does():
    """In bf16 the plain version rounds the mixed weights to bf16 before PV
    and the output after it, as the JAX einsum reference does."""
    args, _ = _th_inputs((1, 4, 19, 16), seed=2)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in args[:3])
    tables = [torch.from_numpy(a) for a in args[3:]]
    got = th.talking_heads_reference(q, k, v, *tables)
    want = jax_th._ref_forward(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                 for x in (q, k, v)),
                               *(jnp.asarray(a) for a in args[3:4]),
                               jnp.asarray(args[4]).reshape(1, 4),
                               jnp.asarray(args[5]),
                               jnp.asarray(args[6]).reshape(1, 4),
                               16 ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def _module_pair(jmod, port_mod, seed):
    x = np.random.default_rng(seed).standard_normal((2, 37, 64)).astype(
        np.float32)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    port_mod.load_state_dict(state_dict_from_jax(params))
    return x, params


@pytest.mark.parametrize("fused", ["1", "0"])
def test_talking_head_attention_module_matches_jax(fused, monkeypatch):
    """The port's module (weights by ``state_dict_from_jax``: the (H, H)
    mixes as ``Linear(H, H)``) against the JAX module on its Pallas route
    and on its XLA route, at a ragged N."""
    monkeypatch.setenv("VITX_FUSED_TH", fused)
    jmod = jax_cait.TalkingHeadAttention(num_heads=4, dtype=jnp.float32)
    mod = cait.TalkingHeadAttention(64, 4)
    x, params = _module_pair(jmod, mod, seed=3)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def test_class_attention_module_matches_jax():
    jmod = jax_cait.ClassAttention(num_heads=4, dtype=jnp.float32)
    mod = cait.ClassAttention(64, 4)
    x, params = _module_pair(jmod, mod, seed=4)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.shape == (2, 1, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-4)


def _pair(cfg, image_size, monkeypatch, fused):
    """The JAX backbone (its init params) and the port backbone with the
    same weights, both fp32; the JAX model takes its Pallas kernel when
    ``fused`` is "1"."""
    jmodel = jax_cait.CaiT(cfg, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, image_size, image_size, 3)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    monkeypatch.setenv("VITX_FUSED_TH", fused)
    model = cait.CaiT(_port_config(cfg), image_size=image_size,
                      dtype=torch.float32).eval()
    model.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, model, x


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("case", range(len(MODELS)))
def test_cait_backbone_and_grads_match_jax(case, fused, monkeypatch):
    """Features and the gradient of every backbone parameter of
    ``sum(features * r)``: the port (the plain talking heads, its backward
    the recompute) against the JAX CaiT with ``jax.grad``; max |port - JAX|
    relative to max |JAX| of each gradient.  The LayerScale gates are set
    to 0.5 so that every block moves the features.  ``proj_l.bias`` and the
    class attention's ``k.bias`` shift whole softmax rows, so their
    gradients are 0 up to rounding on both sides and are held to an
    absolute limit."""
    cfg, size = MODELS[case]
    jmodel, params, model, x = _pair(cfg, size, monkeypatch, fused)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, 0.5) if "gamma" in str(p[-1]) else a,
        params)
    model.load_state_dict(state_dict_from_jax(params))
    r = np.random.default_rng(4).standard_normal(
        (2, cfg.embed_dim)).astype(np.float32)

    def loss(p):
        feats = jmodel.apply({"params": p}, jnp.asarray(x), True)
        return jnp.sum(feats * r), feats

    (_, want), wgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    wgrads = state_dict_from_jax(jax.tree.map(np.asarray, wgrads))
    calls = th.talking_heads_reference.calls
    got = model(torch.from_numpy(x))
    (got * torch.from_numpy(r)).sum().backward()
    assert th.talking_heads_reference.calls == calls + cfg.depth
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-4, rtol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(wgrads)
    assert "blocks.0.attn.proj_l.weight" in grads
    for n, w in wgrads.items():
        if n.endswith(("proj_l.bias", "attn.k.bias")):
            assert max(grads[n].abs().max().item(),
                       w.abs().max().item()) <= 1e-5, n
            continue
        err = (grads[n] - w).abs().max().item() / w.abs().max().item()
        assert err <= 1e-4, (n, err)


def test_adamw_finetune_trajectory_matches_jax_train_step(monkeypatch):
    """Three AdamW fine-tune steps of a cait_test classifier at 32 px from
    the same weights and batches, against the JAX train step through the
    Pallas kernel: the loss of each step and every parameter after the
    last, within fp32 summation order (the ViT trajectory's limits)."""
    cfg = jax_cait.CAIT_CONFIGS["cait_test"]
    lr, head = 1e-4, (16, 10)
    jmodel = JaxClassifier(jax_cait.CaiT(cfg, dtype=jnp.float32,
                                         name="backbone"),
                           JaxClassifierHead(head, dtype=jnp.float32,
                                             name="head"))
    zm_j = JaxZooModel(arch="cait_test", family="cait", model=jmodel,
                       feature_dim=cfg.embed_dim)
    params = jax.jit(lambda rng: zm_j.init(rng, image_size=32))(
        jax.random.PRNGKey(0))["params"]
    monkeypatch.setenv("VITX_FUSED_TH", "1")
    tx = jax_get_optimizer("adamw", lr)
    state = jax_steps.create_train_state(jax.random.PRNGKey(1), params, tx)
    jstep = jax_steps.make_train_step(zm_j.apply, tx, donate=False)

    model = Classifier(cait.CaiT(_port_config(cfg), image_size=32,
                                 dtype=torch.float32),
                       ClassifierHead(cfg.embed_dim, head))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstep = steps.make_train_step(model.train(), get_optimizer(
        "adamw", steps.split_params(model, False), lr))
    bwd = th.talking_heads_bwd.calls
    rng = np.random.default_rng(8)
    for i in range(3):
        images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        labels = rng.integers(0, 10, 4).astype(np.int32)
        mask = np.array([1, 1, 1, float(i < 2)], np.float32)
        state, jm = jstep(state, {"image": jnp.asarray(images),
                                  "label": jnp.asarray(labels),
                                  "mask": jnp.asarray(mask)})
        tm = tstep(*(torch.from_numpy(a) for a in (images, labels, mask)))
        np.testing.assert_allclose((tm["loss_sum"] / tm["count"]).item(),
                                   float(jm["loss_sum"] / jm["count"]),
                                   rtol=1e-5)
    assert th.talking_heads_bwd.calls == bwd + 3 * cfg.depth
    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            state.merged_params()))
    got = model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)
        assert not torch.equal(got[k], before[k]), k


# --------------------------------------------------------------------------
# the Facebook/timm importer, configs, seeded weights


def _facebook_checkpoint(tmp_path, seed=3):
    """A Facebook-layout CaiT checkpoint of cait_test at 32 px: the port's
    state dict (its names are timm's) with the ``module.`` prefix of the
    published files and their head, wrapped in ``{'model': ...}``."""
    src = cait.CaiT(cait.CAIT_CONFIGS["cait_test"], image_size=32,
                    dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(seed))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.head.weight"] = torch.zeros(10, 32)
    sd["module.head.bias"] = torch.zeros(10)
    path = tmp_path / "cait.pth"
    torch.save({"model": sd}, path)
    return src, path


@pytest.mark.parametrize("size", [32, 48])
def test_facebook_checkpoint_loads_like_import_cait(tmp_path, size):
    """The port's loader and ``import_cait`` on one file give the same
    features at the checkpoint's grid and at a 6 x 6 grid, whose position
    table both interpolate with no prefix token."""
    src, path = _facebook_checkpoint(tmp_path)
    cfg = jax_cait.CAIT_CONFIGS["cait_test"]
    model = Classifier(cait.CaiT(_port_config(cfg), image_size=size,
                                 dtype=torch.float32))
    load_backbone_state_dict(str(path), model, size)
    assert model.backbone.pos_embed.shape == (1, (size // 8) ** 2, 32)
    if size == 32:
        for k, v in src.state_dict().items():
            assert torch.equal(model.backbone.state_dict()[k], v), k
    jmodel = jax_cait.CaiT(cfg, dtype=jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    target = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    jparams = import_cait(jax_load_torch_state_dict(str(path)), target)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x),
                                          True))(jparams)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)


def test_cait_configs_flops_sizes_and_layerscale_match_jax():
    assert sorted(cait.CAIT_CONFIGS) == sorted(jax_cait.CAIT_CONFIGS)
    for arch, cfg in jax_cait.CAIT_CONFIGS.items():
        assert dataclasses.asdict(cait.CAIT_CONFIGS[arch]) == \
            dataclasses.asdict(cfg), arch
        for size in {cfg.default_image_size, 224}:
            assert cait.cait_flops(cait.CAIT_CONFIGS[arch], size) == \
                jax_cait.cait_flops(cfg, size), (arch, size)
        assert VisionModelZoo.get_model(arch, device="meta").image_size \
            == cfg.default_image_size, arch
    assert VisionModelZoo.get_model("cait_m48_448",
                                    device="meta").image_size == 448
    zm = VisionModelZoo.get_model("cait_test", device="cpu")
    gammas = {n: p for n, p in zm.model.named_parameters() if "gamma" in n}
    assert len(gammas) == 2 * (2 + 2)
    for p in gammas.values():
        assert torch.equal(p, torch.full_like(p, 1e-5))
    small = cait.CaiT(dataclasses.replace(cait.CAIT_CONFIGS["cait_test"],
                                          init_scale=1e-6), image_size=32)
    init_weights(small, torch.Generator().manual_seed(0))
    assert all(torch.equal(p, torch.full_like(p, 1e-6))
               for n, p in small.named_parameters() if "gamma" in n)


# --------------------------------------------------------------------------
# the CLI and serving

CLI_FLAGS = ["--dataset", "synthetic", "--arch", "cait_test", "--image_size",
             "32", "--epoch", "1", "--bs", "16", "--limit_train", "64",
             "--limit_test", "32", "--device", "cpu"]


def _keys(d):
    return {"top": set(d), "info": set(d["info"]), "telem": set(d["telem"]),
            "results": set(d["results"]),
            "rows": {k: set(d[k][0]) for k in ("train", "val")},
            "epochs": {k: len(d[k]) for k in ("train", "val")}}


def test_cli_main_cait_finetunes_lineareval_caches_with_the_jax_schema(
        tmp_path):
    """``cli.main --arch cait_test --device cpu`` fine-tunes (the stats JSON
    has the JAX CLI's keys), linear-evaluates and caches features."""
    fp, jfp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    cli_main.main(CLI_FLAGS + ["--stats_fp", fp])
    jax_main(CLI_FLAGS + ["--stats_fp", jfp])
    got, want = (json.load(open(p)) for p in (fp, jfp))
    assert _keys(got) == _keys(want)
    assert got["info"]["arch"] == "cait_test"
    assert got["telem"]["mode"] == "finetune"
    assert all(np.isfinite(r["loss"]) for r in got["train"] + got["val"])
    for extra in ([], ["--cache_features"]):
        cli_main.main(CLI_FLAGS + ["--lineareval", *extra, "--fc", "8",
                                   "--stats_fp", fp])
        d = json.load(open(fp))
        assert d["telem"]["mode"] == "lineareval"
        assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])


def test_cait_bundle_exports_loads_and_predicts(tmp_path):
    """cli.export of a CaiT classifier, loaded onto the CPU, predicts the
    logits of the model it was exported from."""
    out = tmp_path / "bundle"
    cli_export.main(["--arch", "cait_test", "--classifier", "8,3",
                     "--image_size", "32", "--bs", "1,4", "--dataset",
                     "stl10", "--device", "cpu", "--out", str(out)])
    bundle = load_bundle(str(out), device="cpu")
    assert bundle.manifest["family"] == "cait"
    assert bundle.manifest["image_size"] == 32
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    logits = bundle.predict(images)
    src = VisionModelZoo.get_model(
        "cait_test", classifier=[8, 3], image_size=32, device="cpu",
        generator=torch.Generator().manual_seed(0))
    norm = NORM_VALUES["stl10"]
    mean, std = (torch.tensor(norm[k], dtype=torch.bfloat16)
                 for k in ("mean", "std"))
    x = (torch.from_numpy(images).bfloat16() / 255.0 - mean) / std
    with torch.no_grad():
        want = src.model(x).float().numpy()
    np.testing.assert_array_equal(logits, want)
