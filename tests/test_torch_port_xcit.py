"""Port parity: the XCiT family against the JAX package, on the CPU in fp32.

Two configs: ``xcit_test`` (patch 8, a 3-conv stem, ``tokens_norm``) and a
patch-16 config at a small width (the 4-conv stem) with ``tokens_norm``
off and one class-attention block.  Seeded weights and ``batch_stats`` in
the JAX model's tree come over through ``state_dict_from_jax``: biases,
BatchNorm scales and statistics drawn away from their init (so that eval
and train mode differ) and the LayerScale gates at 0.5 (so that every
block moves the features).  Each JAX model is traced once (``jax.jit`` of one function giving eval
features, train features, the updated ``batch_stats`` and the parameter
gradients) and every comparison of that config reuses it.

Compared: eval features, train-mode features, the running statistics after
one train-mode forward, every parameter gradient, a 3-step AdamW fine-tune
against the JAX train step (``xcit_test``), ``xca_core`` and
``fourier_pos_encoding`` alone, the configs and FLOPs, a
facebookresearch-layout checkpoint against ``import_xcit``, the linear
eval (plain and cached) through ``cli.main --device cpu`` and through the
trainer (the plain one updates the running statistics, the cached one
reads them), and an XCiT bundle.

Tolerance: fp32 values within 1e-4 of max |JAX| (summation order only).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_xcit
from vit_torch_tpu.models import xcit as jax_xcit
from vit_torch_tpu.models.layers import ClassifierHead as JaxClassifierHead
from vit_torch_tpu.models.zoo import Classifier as JaxClassifier
from vit_torch_tpu.train import steps as jax_steps
from vit_torch_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import (
    load_backbone_state_dict)
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data.augment import (make_eval_transform,
                                              make_train_augment)
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models import xcit
from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
from vit_torch_tpu_torch.models.zoo import Classifier, VisionModelZoo
from vit_torch_tpu_torch.serving import export_classifier, load_bundle
from vit_torch_tpu_torch.serving.export import save_bundle
from vit_torch_tpu_torch.train import steps
from vit_torch_tpu_torch.train.optimizers import get_optimizer
from vit_torch_tpu_torch.train.trainer import Trainer

# fp32 values: max |port - JAX| relative to max |JAX|
RTOL = 1e-4

P16 = jax_xcit.XCiTConfig(patch_size=16, embed_dim=64, depth=1, num_heads=4,
                          tokens_norm=False, cls_attn_layers=1)
# (config, image size): a 4 x 4 token grid each
CASES = {"xcit_test": (jax_xcit.XCIT_CONFIGS["xcit_test"], 32),
         "p16_no_tokens_norm": (P16, 64)}


def _port_config(cfg):
    return xcit.XCiTConfig(**dataclasses.asdict(cfg))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _variables(module, x, rng):
    """Seeded weights and statistics in the JAX model's tree (shapes from
    ``jax.eval_shape`` of its init, so nothing is compiled for them):
    kernels of std 1/sqrt(fan in), biases of std 0.1, LayerNorm and BN
    scales and XCA temperatures in [0.5, 1.5], LayerScale gates 0.5, the
    other leaves of std 0.02; BN running means of std 0.1 and variances in
    [0.5, 1.5], so that eval and train mode differ."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                True))

    def param(path, a):
        name = str(path[-1].key)
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(a.shape[:-1]))
        elif name.startswith("gamma"):
            return jnp.full(a.shape, 0.5, a.dtype)
        elif name in ("scale", "temperature"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        else:
            std = 0.1 if name == "bias" else 0.02
        return jnp.asarray(std * rng.standard_normal(a.shape), a.dtype)

    def stat(path, a):
        if str(path[-1].key) == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]))


def _reference(name):
    """One config: the JAX model's params and statistics, inputs, and its
    eval features, train features, updated statistics and the gradients
    of ``sum(train features * r)``, from one traced function."""
    cfg, size = CASES[name]
    jmodel = jax_xcit.XCiT(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    r = rng.standard_normal((2, cfg.embed_dim)).astype(np.float32)
    params, stats = _variables(jmodel, jnp.asarray(x), rng)

    @jax.jit
    def run(params, stats, x):
        ev = jmodel.apply({"params": params, "batch_stats": stats}, x, True)

        def loss(p):
            feats, new = jmodel.apply({"params": p, "batch_stats": stats}, x,
                                      False, mutable=["batch_stats"])
            return jnp.sum(feats * r), (feats, new["batch_stats"])

        (_, (tr, new)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return ev, tr, new, g

    ev, tr, new, grads = jax.tree.map(np.asarray, run(params, stats,
                                                      jnp.asarray(x)))
    return dict(name=name, cfg=cfg, size=size, x=x, r=r,
                params=params, stats=stats, run=run, eval=ev, train=tr,
                new_stats=new, grads=grads)


def _port(case):
    model = xcit.XCiT(_port_config(case["cfg"]), image_size=case["size"],
                      dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, case["params"]),
        batch_stats=jax.tree.map(np.asarray, case["stats"])))
    return model


@pytest.mark.parametrize("name", list(CASES))
def test_backbone_matches_jax(name, tmp_path):
    """One config against the JAX model, traced once: the carried state
    dict's keys, eval features, train-mode features and running
    statistics, every parameter gradient, and a facebookresearch-layout
    checkpoint against ``import_xcit``.  One test a config, because the
    JAX trace is most of its time and tests of one module that the
    workers share out would each trace it again."""
    case = _reference(name)
    _check_keys(case)
    _check_eval_features(case)
    _check_train_features_and_running_stats(case)
    _check_parameter_gradients(case)
    _check_facebook_checkpoint(case, tmp_path)


def _check_keys(case):
    """The carried state dict has exactly the port's keys and shapes,
    facebookresearch's names, running statistics included."""
    model = xcit.XCiT(_port_config(case["cfg"]), dtype=torch.float32)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, case["params"]),
                             batch_stats=jax.tree.map(np.asarray,
                                                      case["stats"]))
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_stem = 4 if case["cfg"].patch_size == 16 else 3
    for i in range(n_stem):
        assert f"patch_embed.proj.{2 * i}.1.running_var" in sd
    assert sd["pos_embeder.token_projection.weight"].shape == (
        case["cfg"].embed_dim, 64, 1, 1)


def _check_eval_features(case):
    """Eval mode (BN from the running statistics)."""
    with torch.no_grad():
        got = _port(case).eval()(torch.from_numpy(case["x"]))
    assert _rel(got.numpy(), case["eval"]) <= RTOL


def _check_train_features_and_running_stats(case):
    """Train mode (BN from the batch), and the running statistics after
    that one forward against the JAX ``batch_stats`` (momentum 0.1, the
    unbiased variance)."""
    model = _port(case).train()
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"]))
    assert _rel(got.numpy(), case["train"]) <= RTOL
    assert _rel(got.numpy(), case["eval"]) > 1e-2     # the modes differ
    want = state_dict_from_jax({}, batch_stats=case["new_stats"])
    sd = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert sd[k].item() == 1, k
        else:
            assert _rel(sd[k].numpy(), w.numpy()) <= RTOL, k


def _check_parameter_gradients(case):
    """The gradient of every parameter of ``sum(train features * r)``
    against ``jax.grad``, each relative to its max |JAX|."""
    model = _port(case).train()
    got = model(torch.from_numpy(case["x"]))
    (got * torch.from_numpy(case["r"])).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = state_dict_from_jax(case["grads"])
    assert set(grads) == set(want)
    for n, w in want.items():
        assert _rel(grads[n].numpy(), w.numpy()) <= RTOL, n


def _check_facebook_checkpoint(case, tmp_path):
    """A facebookresearch-layout checkpoint (the port's state dict, whose
    names are facebookresearch's, with running statistics away from their
    init and a ``head``) through the port's loader, and through the JAX
    ``import_xcit`` into the traced JAX model: the same eval features."""
    cfg, size = case["cfg"], case["size"]
    src = xcit.XCiT(_port_config(cfg), dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(3))
    src.train()
    with torch.no_grad():                       # move the statistics
        src(torch.from_numpy(case["x"]))
    sd = dict(src.state_dict())
    sd["head.weight"] = torch.zeros(10, cfg.embed_dim)
    sd["head.bias"] = torch.zeros(10)
    path = tmp_path / "xcit.pth"
    torch.save({"model": sd}, path)
    model = Classifier(xcit.XCiT(_port_config(cfg), dtype=torch.float32))
    load_backbone_state_dict(str(path), model, size)
    for k, v in src.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    jvars = import_xcit({k: v.numpy() for k, v in sd.items()}, None)
    want = case["run"](jvars["params"], jvars["batch_stats"],
                       jnp.asarray(case["x"]))[0]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(case["x"]))
    assert _rel(got.numpy(), want) <= RTOL
    del sd["blocks.0.local_mp.bn.running_var"]
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="lacks"):
        load_backbone_state_dict(str(path), model, size)


def test_adamw_finetune_trajectory_matches_jax_train_step():
    """Three AdamW fine-tune steps of an xcit_test classifier at 32 px from
    the same weights, statistics and batches, against the JAX train step
    (``batch_stats`` mutable): the loss of each step, every parameter and
    every running statistic after the last.  The last batch has a padded
    row (mask 0), which counts in BN's batch statistics on both sides."""
    cfg = jax_xcit.XCIT_CONFIGS["xcit_test"]
    lr, head = 1e-3, (16, 10)
    jmodel = JaxClassifier(jax_xcit.XCiT(cfg, dtype=jnp.float32,
                                         name="backbone"),
                           JaxClassifierHead(head, dtype=jnp.float32,
                                             name="head"))
    params, stats = _variables(jmodel, jnp.zeros((1, 32, 32, 3)),
                               np.random.default_rng(1))
    tx = jax_get_optimizer("adamw", lr)
    state = jax_steps.create_train_state(
        jax.random.PRNGKey(1), params, tx,
        model_state={"batch_stats": stats})
    jstep = jax_steps.make_train_step(jmodel.apply, tx, donate=False)

    model = Classifier(xcit.XCiT(_port_config(cfg), image_size=32,
                                 dtype=torch.float32),
                       ClassifierHead(cfg.embed_dim, head))
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params),
        batch_stats=jax.tree.map(np.asarray, stats)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstep = steps.make_train_step(model.train(), get_optimizer(
        "adamw", steps.split_params(model, False), lr))
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
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, state.merged_params()),
        batch_stats=jax.tree.map(np.asarray,
                                 state.model_state["batch_stats"]))
    got = model.state_dict()
    C = cfg.embed_dim
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == 3, k
            continue
        g, w = got[k].numpy(), w.numpy()
        if k.startswith("backbone.cls_attn_blocks.") and k.endswith(
                "qkv.bias"):
            # the class attention's k bias shifts a whole softmax row, so
            # its gradient is 0 up to rounding on both sides, and Adam's
            # normalisation turns that into steps of lr of either sign:
            # it is held to have moved by at most 3 lr
            start = before[k].numpy()[C:2 * C]
            for side in (g, w):
                assert np.abs(side[C:2 * C] - start).max() <= 3.01 * lr, k
            g, w = np.delete(g, np.s_[C:2 * C]), np.delete(w, np.s_[C:2 * C])
        # AdamW's first steps move every weight by about lr, so the
        # parameters are held as the ViT trajectory holds them
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 16, 3 * 32, 2), (1, 49, 3 * 64, 4),
                                   (3, 5, 3 * 48, 8)], ids=str)
def test_xca_core_matches_jax(shape):
    """The transpose-free XCA core alone, fp32, per-head temperatures away
    from 1."""
    B, N, C3, H = shape
    rng = np.random.default_rng(N)
    qkv = rng.standard_normal((B, N, C3)).astype(np.float32)
    temp = rng.uniform(0.5, 2.0, (H, 1, 1)).astype(np.float32)
    want = jax_xcit.xca_core(jnp.asarray(qkv), jnp.asarray(temp), H,
                             jnp.float32)
    got = xcit.xca_core(torch.from_numpy(qkv), torch.from_numpy(temp), H)
    assert got.shape == (B, N, C3 // 3)
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("hw", [(4, 4), (14, 14), (7, 12)], ids=str)
def test_fourier_pos_encoding_matches_jax(hw):
    want = np.asarray(jax_xcit.fourier_pos_encoding(*hw))
    got = xcit.fourier_pos_encoding(*hw)
    assert got.shape == want.shape == (1, *hw, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    enc = xcit.PositionalEncodingFourier(32)
    cached = enc.tokens(hw, torch.device("cpu"))
    assert cached is enc.tokens(hw, torch.device("cpu"))
    assert torch.equal(cached, got.reshape(1, hw[0] * hw[1], 64))


def test_configs_and_flops_match_jax():
    """Every JAX arch with the same fields (the port adds
    ``drop_path_rate``, 0 in every config) and the same FLOPs."""
    assert sorted(xcit.XCIT_CONFIGS) == sorted(jax_xcit.XCIT_CONFIGS)
    for arch, cfg in jax_xcit.XCIT_CONFIGS.items():
        mine = dataclasses.asdict(xcit.XCIT_CONFIGS[arch])
        assert mine.pop("drop_path_rate") == 0.0
        assert mine == dataclasses.asdict(cfg), arch
        for size in (224, 384):
            assert xcit.xcit_flops(xcit.XCIT_CONFIGS[arch], size) == \
                jax_xcit.xcit_flops(cfg, size), (arch, size)
    zm = VisionModelZoo.get_model("xcit_test", device="cpu",
                                  image_size=32)
    gammas = {n: p for n, p in zm.model.named_parameters()
              if ".gamma" in n}
    assert len(gammas) == 3 * 2 + 2 * 2
    assert all(torch.equal(p, torch.ones_like(p)) for p in gammas.values())
    small = VisionModelZoo.get_model("xcit_small_24_p16", device="meta")
    assert small.patch_size == 16 and small.feature_dim == 384


# --------------------------------------------------------------------------
# training through the CLI and the trainer, serving

CLI_FLAGS = ["--dataset", "synthetic", "--arch", "xcit_test", "--image_size",
             "32", "--epoch", "1", "--bs", "16", "--limit_train", "32",
             "--limit_test", "16", "--device", "cpu", "--fc", "8"]


@pytest.mark.parametrize("extra", [[], ["--cache_features"]],
                         ids=["plain", "cached"])
def test_cli_main_lineareval(extra, tmp_path):
    fp = str(tmp_path / "stats.json")
    cli_main.main(CLI_FLAGS + ["--lineareval", *extra, "--stats_fp", fp])
    d = json.load(open(fp))
    assert d["info"]["arch"] == "xcit_test"
    assert d["telem"]["mode"] == "lineareval"
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])


@pytest.mark.parametrize("cached", [False, True], ids=["plain", "cached"])
def test_lineareval_updates_or_reads_the_running_stats(cached):
    """Plain linear eval runs the frozen backbone in train mode, so BN
    folds each batch into its running statistics (one update a train step,
    as the JAX step's mutable ``batch_stats``); the cached linear eval runs
    it in eval mode and leaves them as they were.  The backbone's
    parameters move in neither."""
    zm = VisionModelZoo.get_model("xcit_test", classifier=[8, 10],
                                  image_size=32, device="cpu",
                                  dtype=torch.float32)
    before = {k: v.clone() for k, v in zm.model.backbone.state_dict().items()}
    norm = NORM_VALUES["synthetic"]
    trainer = Trainer(zm, epochs=1, opt="adamw", lr=1e-3, lineareval=True,
                      augment_fn=make_train_augment(**norm,
                                                    dtype=torch.float32),
                      eval_transform=make_eval_transform(
                          **norm, dtype=torch.float32),
                      print_progress=False)
    rng = np.random.default_rng(0)
    sets = {split: (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                    rng.integers(0, 10, n)) for split, n in
            (("train", 24), ("val", 8))}
    fit = trainer.fit_lineareval_cached if cached else trainer.fit_scan
    fit(sets, 8)
    after = zm.model.backbone.state_dict()
    for k, v in before.items():
        if "running" in k or "num_batches" in k:
            if k.endswith("num_batches_tracked"):
                assert after[k].item() == (0 if cached else 3), k
            else:
                assert torch.equal(after[k], v) == cached, k
        else:
            assert torch.equal(after[k], v), k


def test_xcit_bundle_carries_the_running_stats_and_serves_in_eval(tmp_path):
    """A bundle of a model whose statistics moved: ``weights.pt`` holds
    them, and the loaded bundle predicts the model's eval-mode logits."""
    zm = VisionModelZoo.get_model("xcit_test", classifier=[8, 3],
                                  image_size=32, device="cpu")
    zm.model.train()
    with torch.no_grad():
        zm.model(torch.randn(4, 32, 32, 3))
    zm.model.eval()
    norm = NORM_VALUES["stl10"]
    save_bundle(str(tmp_path), export_classifier(zm, batch_sizes=[4],
                                                 norm=norm))
    weights = torch.load(tmp_path / "weights.pt", weights_only=True)
    key = "backbone.blocks.0.local_mp.bn.running_mean"
    assert torch.equal(weights[key], zm.model.state_dict()[key])
    assert weights[key].abs().max() > 0
    bundle = load_bundle(str(tmp_path), device="cpu")
    assert not bundle.model.training
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    mean, std = (torch.tensor(norm[k], dtype=torch.bfloat16)
                 for k in ("mean", "std"))
    x = (torch.from_numpy(images).bfloat16() / 255.0 - mean) / std
    with torch.no_grad():
        want = zm.model(x).float().numpy()
    np.testing.assert_array_equal(bundle.predict(images), want)
