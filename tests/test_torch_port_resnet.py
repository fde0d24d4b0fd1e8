"""Port parity: the ResNeXt/WRN family against the JAX package, on the CPU
in fp32.

Two configs at 32 px: ``resnet_test`` (two stages, no groups) and a
grouped one with G = 4, which the JAX package runs through its
``GroupedConv`` block-diagonal regrouping (``VITX_DENSE_GROUPS``, the same
function; the port calls ``nn.Conv2d(groups=4)``).  Seeded weights and
``batch_stats`` in the JAX model's tree come over through
``state_dict_from_jax``, BatchNorm scales, biases and statistics drawn
away from their init so that eval and train mode differ.  Each JAX model
is traced once a config and every comparison of that config reuses it.

Compared: eval features with the conv+BN fold on and off
(``VITX_FOLD_BN`` on both sides), train-mode features, the running
statistics after one train-mode forward, every parameter gradient, a
3-step AdamW fine-tune against the JAX train step (``resnet_test``), the
``features_only`` maps' shapes, a torchvision-layout checkpoint against
``import_resnet``, the configs and FLOPs, the linear eval (plain and
cached) through ``cli.main --device cpu``, and a ResNet bundle.

Tolerance: values within 1e-4 of max |JAX| (summation order only).  The
port's forwards run in fp32 (the JAX train-mode forward is the fp64 one
of the gradients).  The gradients and the trajectory run in fp64 on
both sides (``jax_enable_x64``, the port's model in float64), as the JAX
package's own ResNeXt trajectory test does: ReLU's derivative jumps at 0,
and a train-mode BN output within fp32 rounding (about 1e-6) of 0 takes
either side in either package.  Every batch of a few images at 32 px has
such values (the smallest |pre-ReLU| over a 3-step run was 2e-8 to 7e-6
over 32 seeds), and one flipped element moves its channel's BN gradients:
in fp32 one input gave 20% of max |grad| between the packages on
``layer2.0.bn2.bias``, where the port agreed with a float64 run of
itself to 8e-7.  In fp64 no value lies that close.
"""

import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint.torch_import import import_resnet
from vit_torch_tpu.models import resnet as jax_resnet
from vit_torch_tpu.models.layers import ClassifierHead as JaxClassifierHead
from vit_torch_tpu.models.layers import dense_regroup_factor
from vit_torch_tpu.models.zoo import Classifier as JaxClassifier
from vit_torch_tpu.train import steps as jax_steps
from vit_torch_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.checkpoint.torch_import import (
    load_backbone_state_dict)
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models import layers, resnet
from vit_torch_tpu_torch.models.layers import ClassifierHead, init_weights
from vit_torch_tpu_torch.models.zoo import Classifier, VisionModelZoo
from vit_torch_tpu_torch.serving import export_classifier, load_bundle
from vit_torch_tpu_torch.serving.export import save_bundle
from vit_torch_tpu_torch.train import steps
from vit_torch_tpu_torch.train.optimizers import get_optimizer

# fp32 values: max |port - JAX| relative to max |JAX|
RTOL = 1e-4
SIZE = 32

GROUPED = jax_resnet.ResNetConfig((1, 1), groups=4, width_per_group=8)
CASES = {"resnet_test": jax_resnet.RESNET_CONFIGS["resnet_test"],
         "grouped_g4": GROUPED}


def _port_config(cfg):
    return resnet.ResNetConfig(**dataclasses.asdict(cfg))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@contextlib.contextmanager
def _fold(value: str):
    """``VITX_FOLD_BN`` set for the block (the JAX model reads it while
    tracing, the port per call)."""
    old = os.environ.get("VITX_FOLD_BN")
    os.environ["VITX_FOLD_BN"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["VITX_FOLD_BN"]
        else:
            os.environ["VITX_FOLD_BN"] = old


def _variables(module, x, rng):
    """Seeded weights and statistics in the JAX model's tree (shapes from
    ``jax.eval_shape`` of its init): kernels of std 1/sqrt(fan in), biases
    of std 0.1, scales in [0.5, 1.5]; BN running means of std 0.1 and
    variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                True))

    def param(path, a):
        name = str(path[-1].key)
        if name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        std = (1 / np.sqrt(np.prod(a.shape[:-1])) if name == "kernel"
               else 0.1)
        return jnp.asarray(std * rng.standard_normal(a.shape), a.dtype)

    def stat(path, a):
        if str(path[-1].key) == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)

    return (jax.tree_util.tree_map_with_path(param, shapes["params"]),
            jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"]))


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _reference(name):
    """One config: the JAX model's weights and statistics, inputs, its
    eval features folded (``eval_fns["1"]``) and unfolded (``"0"``) in
    fp32, and in fp64 its train features, updated statistics and the
    gradients of ``sum(train features * r)`` (the port's fp32 train
    features and statistics are held against these too: a more exact
    reference, one trace fewer)."""
    cfg = CASES[name]
    jmodel = jax_resnet.ResNet(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    r = rng.standard_normal((2, 64 * 2 ** (len(cfg.layers) - 1) * 4)
                            ).astype(np.float32)
    params, stats = _variables(jmodel, jnp.asarray(x), rng)
    eval_fns, evals = {}, {}
    for fold in ("1", "0"):
        with _fold(fold):
            eval_fns[fold] = jax.jit(lambda p, s, x: jmodel.apply(
                {"params": p, "batch_stats": s}, x, True))
            evals[fold] = np.asarray(eval_fns[fold](params, stats,
                                                    jnp.asarray(x)))

    def train(model, params, stats, x):
        def loss(p):
            feats, new = model.apply({"params": p, "batch_stats": stats}, x,
                                     False, mutable=["batch_stats"])
            return jnp.sum(feats * r), (feats, new["batch_stats"])

        (_, (tr, new)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return tr, new, g

    with _x64():
        j64 = jax_resnet.ResNet(cfg, dtype=jnp.float64)
        tr, new, grads = jax.tree.map(np.asarray, jax.jit(
            lambda *a: train(j64, *a))(_f64(params), _f64(stats),
                                       jnp.asarray(x, jnp.float64)))
    return dict(name=name, cfg=cfg, x=x, r=r, params=params,
                stats=stats, eval_fns=eval_fns, evals=evals, train=tr,
                new_stats=new, grads=grads)


def _port(case, dtype=torch.float32, **kw):
    model = resnet.ResNet(_port_config(case["cfg"]), dtype=dtype, **kw)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, case["params"]),
        batch_stats=jax.tree.map(np.asarray, case["stats"])))
    return model.to(dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_backbone_matches_jax(name, tmp_path):
    """One config against the JAX model, traced once: eval features folded
    and unfolded, train-mode features and running statistics, every
    parameter gradient, the ``features_only`` maps, and a
    torchvision-layout checkpoint against ``import_resnet``.  One test a
    config, because the JAX traces are most of its time and tests of one
    module that the workers share out would each trace them again."""
    case = _reference(name)
    for fold in ("1", "0"):
        _check_eval_features(case, fold)
    _check_train_features_and_running_stats(case)
    _check_parameter_gradients(case)
    _check_features_only_maps(case)
    _check_torchvision_checkpoint(case, tmp_path)


def test_the_grouped_case_takes_the_jax_regrouping():
    """The G = 4 case's 3x3 convs (4 and 8 channels a group) go through the
    JAX ``GroupedConv``'s dense regrouping, not XLA's grouped conv."""
    assert dense_regroup_factor(4, 4) == 4
    assert dense_regroup_factor(4, 8) == 4


def _check_eval_features(case, fold):
    """Eval mode with every conv+BN pair folded into one conv, and with
    the BN run after the conv, on both sides."""
    model = _port(case).eval()
    calls = []
    real = layers._fold
    with _fold(fold), torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "_fold", lambda *a: calls.append(1) or real(*a))
        got = model(torch.from_numpy(case["x"]))
    n_pairs = sum(isinstance(m, layers.BatchNorm) for m in model.modules())
    assert len(calls) == (n_pairs if fold == "1" else 0)
    assert _rel(got.numpy(), case["evals"][fold]) <= RTOL


def _check_train_features_and_running_stats(case):
    """Train mode (BN from the batch; the fold never applies), and the
    running statistics after that one forward against the JAX
    ``batch_stats`` (momentum 0.1, the unbiased variance)."""
    model = _port(case).train()
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"]))
    assert _rel(got.numpy(), case["train"]) <= RTOL
    assert _rel(got.numpy(), case["evals"]["0"]) > 1e-2
    want = state_dict_from_jax({}, batch_stats=case["new_stats"])
    sd = model.state_dict()
    n_bn = sum(isinstance(m, layers.BatchNorm) for m in model.modules())
    assert n_bn == 1 + 4 * sum(case["cfg"].layers)
    assert len(want) == 3 * n_bn
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert sd[k].item() == 1, k
        else:
            assert _rel(sd[k].numpy(), w.numpy()) <= RTOL, k


def _check_parameter_gradients(case):
    """The gradient of every parameter of ``sum(train features * r)``
    against ``jax.grad``, each relative to its max |JAX|, in fp64 (see
    the module's docstring)."""
    model = _port(case, torch.float64).train()
    got = model(torch.from_numpy(case["x"]).double())
    (got * torch.from_numpy(case["r"]).double()).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = state_dict_from_jax(case["grads"])
    assert set(grads) == set(want)
    for n, w in want.items():
        assert _rel(grads[n].numpy(), w.numpy()) <= RTOL, n


def _check_features_only_maps(case):
    """``features_only``: the per-stage maps (strides 4 and 8 here) in
    NHWC, the shapes of the JAX model's."""
    jmodel = jax_resnet.ResNet(case["cfg"], dtype=jnp.float32,
                               features_only=True)
    want = jax.eval_shape(lambda: jmodel.apply(
        {"params": case["params"], "batch_stats": case["stats"]},
        jnp.asarray(case["x"]), True))
    with torch.no_grad():
        got = _port(case, features_only=True).eval()(
            torch.from_numpy(case["x"]))
    assert [tuple(m.shape) for m in got] == [w.shape for w in want]
    assert [tuple(m.shape) for m in got] == [(2, 8, 8, 256),
                                             (2, 4, 4, 512)]
    with torch.no_grad():
        pooled = _port(case).eval()(torch.from_numpy(case["x"]))
    torch.testing.assert_close(got[-1].mean(dim=(1, 2)), pooled)


def _check_torchvision_checkpoint(case, tmp_path):
    """A torchvision-layout checkpoint (the port's state dict, whose names
    are torchvision's, statistics moved by a train-mode forward, with an
    ``fc`` head) through the port's loader, and through the JAX
    ``import_resnet`` into the traced JAX model: the same eval features,
    folded."""
    cfg = case["cfg"]
    src = resnet.ResNet(_port_config(cfg), dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(3))
    src.train()
    with torch.no_grad():
        src(torch.from_numpy(case["x"]))
    sd = dict(src.state_dict())
    sd["fc.weight"] = torch.zeros(10, src.feature_dim)
    sd["fc.bias"] = torch.zeros(10)
    path = tmp_path / "resnet.pth"
    torch.save(sd, path)
    model = Classifier(resnet.ResNet(_port_config(cfg), dtype=torch.float32))
    load_backbone_state_dict(str(path), model, SIZE)
    for k, v in src.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    jvars = import_resnet({k: v.numpy() for k, v in sd.items()}, None)
    want = case["eval_fns"]["1"](jvars["params"], jvars["batch_stats"],
                                 jnp.asarray(case["x"]))
    with torch.no_grad(), _fold("1"):
        got = model.eval()(torch.from_numpy(case["x"]))
    assert _rel(got.numpy(), want) <= RTOL
    sd["layer1.0.conv2.weight"] = torch.zeros(3, 3, 3, 3)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="shapes"):
        load_backbone_state_dict(str(path), model, SIZE)


@pytest.fixture
def x64():
    with _x64():
        yield


def test_adamw_finetune_trajectory_matches_jax_train_step(x64):
    """Three AdamW fine-tune steps of a resnet_test classifier at 32 px
    from the same weights, statistics and batches, against the JAX train
    step (``batch_stats`` mutable), in fp64 on both sides (see the
    module's docstring; the loss is fp32 on both, as the steps compute
    it): the loss of each step, every parameter and every running
    statistic after the last.  The last batch has a padded row (mask 0),
    which counts in BN's batch statistics on both sides."""
    cfg = jax_resnet.RESNET_CONFIGS["resnet_test"]
    lr, head = 1e-3, (16, 10)
    jmodel = JaxClassifier(jax_resnet.ResNet(cfg, dtype=jnp.float64,
                                             name="backbone"),
                           JaxClassifierHead(head, dtype=jnp.float64,
                                             name="head"))
    params, stats = map(_f64, _variables(
        jmodel, jnp.zeros((1, SIZE, SIZE, 3)), np.random.default_rng(1)))
    tx = jax_get_optimizer("adamw", lr)
    state = jax_steps.create_train_state(
        jax.random.PRNGKey(1), params, tx,
        model_state={"batch_stats": stats})
    jstep = jax_steps.make_train_step(jmodel.apply, tx, donate=False)

    model = Classifier(resnet.ResNet(_port_config(cfg), dtype=torch.float64),
                       ClassifierHead(512, head))
    model.load_state_dict(state_dict_from_jax(params, batch_stats=stats))
    model.double()
    tstep = steps.make_train_step(model.train(), get_optimizer(
        "adamw", steps.split_params(model, False), lr))
    rng = np.random.default_rng(8)
    for i in range(3):
        images = rng.standard_normal((4, SIZE, SIZE, 3))
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
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == 3, k
            continue
        # AdamW's first steps move every weight by about lr, so the
        # parameters are held as the ViT trajectory holds them
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)


def test_configs_and_flops_match_jax():
    assert sorted(resnet.RESNET_CONFIGS) == sorted(jax_resnet.RESNET_CONFIGS)
    for arch, cfg in jax_resnet.RESNET_CONFIGS.items():
        assert dataclasses.asdict(resnet.RESNET_CONFIGS[arch]) == \
            dataclasses.asdict(cfg), arch
        for size in (224, 384):
            assert resnet.resnet_flops(resnet.RESNET_CONFIGS[arch], size) \
                == jax_resnet.resnet_flops(cfg, size), (arch, size)
        zm = VisionModelZoo.get_model(arch, device="meta")
        assert zm.patch_size is None and zm.family == "resnet"
        assert zm.feature_dim == (512 if arch == "resnet_test" else 2048)


def test_seeded_init_resets_the_running_stats():
    """A seeded model's BN starts at weight 1, bias 0, running mean 0 and
    variance 1, none tracked; its convs have flax's lecun-normal scale."""
    zm = VisionModelZoo.get_model("resnet_test", device="cpu")
    for name, mod in zm.model.named_modules():
        if isinstance(mod, layers.BatchNorm):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
            assert torch.equal(mod.running_var,
                               torch.ones_like(mod.running_var))
            assert not mod.running_mean.any() and not mod.bias.any()
            assert mod.num_batches_tracked.item() == 0, name
    w = zm.model.backbone.layer2[0].conv1.weight
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.1


# --------------------------------------------------------------------------
# training through the CLI, serving

CLI_FLAGS = ["--dataset", "synthetic", "--arch", "resnet_test", "--image_size",
             "32", "--epoch", "1", "--bs", "16", "--limit_train", "32",
             "--limit_test", "16", "--device", "cpu", "--fc", "8"]


@pytest.mark.parametrize("extra", [[], ["--cache_features"]],
                         ids=["plain", "cached"])
def test_cli_main_lineareval(extra, tmp_path):
    fp = str(tmp_path / "stats.json")
    cli_main.main(CLI_FLAGS + ["--lineareval", *extra, "--stats_fp", fp])
    d = json.load(open(fp))
    assert d["info"]["arch"] == "resnet_test"
    assert d["telem"]["mode"] == "lineareval"
    assert all(np.isfinite(r["loss"]) for r in d["train"] + d["val"])


def test_resnet_bundle_carries_the_running_stats_and_serves_in_eval(
        tmp_path):
    """A bundle of a model whose statistics moved: ``weights.pt`` holds
    them, and the loaded bundle predicts the model's eval-mode (folded)
    logits."""
    zm = VisionModelZoo.get_model("resnet_test", classifier=[8, 3],
                                  image_size=32, device="cpu")
    zm.model.train()
    with torch.no_grad():
        zm.model(torch.randn(4, 32, 32, 3))
    zm.model.eval()
    norm = NORM_VALUES["stl10"]
    save_bundle(str(tmp_path), export_classifier(zm, batch_sizes=[4],
                                                 norm=norm))
    weights = torch.load(tmp_path / "weights.pt", weights_only=True)
    key = "backbone.layer1.0.bn2.running_var"
    assert torch.equal(weights[key], zm.model.state_dict()[key])
    assert weights["backbone.bn1.num_batches_tracked"].item() == 1
    bundle = load_bundle(str(tmp_path), device="cpu")
    assert not bundle.model.training
    assert "patch_size" not in bundle.manifest
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               dtype=np.uint8)
    mean, std = (torch.tensor(norm[k], dtype=torch.bfloat16)
                 for k in ("mean", "std"))
    x = (torch.from_numpy(images).bfloat16() / 255.0 - mean) / std
    with torch.no_grad():
        want = zm.model(x).float().numpy()
    np.testing.assert_array_equal(bundle.predict(images), want)
