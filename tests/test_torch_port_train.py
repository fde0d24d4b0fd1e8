"""Port parity: the training slice against the JAX package, on the CPU.

Loss and metrics, the six optimizers, the LR schedules, the augmentation
ops, batching and the synthetic data, drop-path, a 3-step sgd trajectory
of a ``vit_tiny_test`` classifier (finetune and lineareval) from the same
weights, and the training CLI.  Inputs are made with numpy from a seed;
everything runs in fp32, so tolerances cover summation order only unless
stated otherwise.  JAX and torch draw different random numbers from one
seed, so random ops are compared on the offsets, flags and masks the JAX
op drew, fed to the port's deterministic op.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_torch_tpu.cli.main import main as jax_main
from vit_torch_tpu.data import augment as jax_aug
from vit_torch_tpu.data.datasets import _synthetic_arrays as jax_synthetic
from vit_torch_tpu.models import layers as jax_layers
from vit_torch_tpu.models.zoo import VisionModelZoo as JaxZoo
from vit_torch_tpu.train import steps as jax_steps
from vit_torch_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from vit_torch_tpu.train.scan import epoch_indices as jax_epoch_indices
from vit_torch_tpu.train.schedules import get_lr_factor_fn as jax_lr_factor
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.cli.main import main
from vit_torch_tpu_torch.data import augment
from vit_torch_tpu_torch.data.datasets import _synthetic_arrays
from vit_torch_tpu_torch.models.layers import (DropPath, Dropout, drop_path,
                                               set_generator)
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.train import steps
from vit_torch_tpu_torch.train.optimizers import (OPTIMIZERS, get_optimizer,
                                                  set_learning_rate)
from vit_torch_tpu_torch.train.scan import epoch_indices
from vit_torch_tpu_torch.train.schedules import get_lr_factor_fn
from vit_torch_tpu_torch.utils.args import ARGS, classification_config
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# loss and metrics

def test_masked_cross_entropy_and_metrics_match_jax():
    """A padded last batch: the two masked rows count for nothing."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6).astype(np.int32)
    labels[:2] = logits[:2].argmax(-1)            # some correct rows
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    want_loss = jax_steps.cross_entropy_loss(*map(jnp.asarray,
                                                  (logits, labels, mask)))
    want = jax_steps._metrics(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(mask), want_loss)
    loss = steps.cross_entropy_loss(_t(logits), _t(labels), _t(mask))
    got = steps._metrics(_t(logits), _t(labels), _t(mask), loss)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    acc = steps.accumulate_metrics(steps.init_metric_accumulator(), got)
    final = steps.finalize_metrics(steps.accumulate_metrics(acc, got))
    want_final = jax_steps.finalize_metrics(
        jax_steps.accumulate_metrics(
            jax_steps.accumulate_metrics(
                jax_steps.init_metric_accumulator(), want), want))
    for k in ("acc", "loss", "count"):
        np.testing.assert_allclose(final[k], want_final[k], rtol=1e-6)


# --------------------------------------------------------------------------
# optimizers

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_on_fixed_gradients(name):
    """One fixed sequence of gradients fed to both sides (Adam's eps turns
    tiny gradient differences into large updates, so a whole-model
    trajectory would only measure that).  10 steps, the LR halved after
    5: rectified AdaBelief crosses rho_t = 4 at step 5.

    AdaBelief's tolerance is wider: the JAX package evaluates
    rho_t = rho_inf - 2 t b2^t / bc2 in float32, where two terms near 2e3
    cancel to ~5, so its rectification factor r_t is off by ~0.5% at
    t = 5 (0.017217 against 0.017312 in float64); the port evaluates the
    step's scalars in float64, as the reference's adabelief-pytorch
    does."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(10)]
    lr = 0.05
    rtol, atol = (1e-3, 1e-4) if name == "adabelief" else (1e-5, 1e-6)

    tx = jax_get_optimizer(name, lr)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [_t(p.copy()).requires_grad_(True) for p in params]
    opt = get_optimizer(name, tp, lr)
    for i, g in enumerate(grads):
        if i == 5:
            state.hyperparams["learning_rate"] = jnp.asarray(lr / 2)
            set_learning_rate(opt, lr / 2)
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = _t(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name} step {i}")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="not supported"):
        get_optimizer("lamb", [torch.zeros(1, requires_grad=True)])


# --------------------------------------------------------------------------
# schedules

@pytest.mark.parametrize("name", ["none", "step", "exp", "cos", "ca",
                                  "cos_exp"])
def test_schedule_factor_table_matches_jax(name):
    for step, gamma, scale in ((10, 0.5, 0.1), (3, 0.9, 0.25)):
        got = get_lr_factor_fn(name, step, gamma, scale)
        want = jax_lr_factor(name, step, gamma, scale)
        assert [got(e) for e in range(45)] == [want(e) for e in range(45)]


# --------------------------------------------------------------------------
# augmentation

def _images(seed, shape=(8, 16, 16, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_normalize_matches_jax():
    imgs = _images(0)
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    want = np.asarray(jax_aug.normalize(jnp.asarray(imgs), mean, std))
    got = augment.normalize(_t(imgs), mean, std)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert augment.normalize(_t(imgs), mean, std,
                             dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_matches_jax(seed):
    """Pad with 128, crop at the offsets the JAX op drew: bit-equal."""
    imgs, pad, key = _images(seed), 2, jax.random.PRNGKey(seed)
    want = np.asarray(jax_aug.random_crop(key, jnp.asarray(imgs), pad))
    ry, rx = jax.random.split(key)
    offs_y = jax.random.randint(ry, (8,), 0, 2 * pad + 1)
    offs_x = jax.random.randint(rx, (8,), 0, 2 * pad + 1)
    got = augment.crop(_t(imgs), _t(offs_y).long(), _t(offs_x).long(), pad)
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_to_matches_jax():
    imgs, key = _images(2), jax.random.PRNGKey(2)
    want = np.asarray(jax_aug.random_crop_to(key, jnp.asarray(imgs), 11))
    ry, rx = jax.random.split(key)
    offs_y = jax.random.randint(ry, (8,), 0, 16 - 11 + 1)
    offs_x = jax.random.randint(rx, (8,), 0, 16 - 11 + 1)
    got = augment.crop_to(_t(imgs), _t(offs_y).long(), _t(offs_x).long(),
                          11, 11)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", ["h", "v"])
def test_flip_matches_jax(axis):
    imgs, key = _images(3), jax.random.PRNGKey(3)
    jax_fn = jax_aug.random_hflip if axis == "h" else jax_aug.random_vflip
    want = np.asarray(jax_fn(key, jnp.asarray(imgs)))
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (8, 1, 1, 1)))[:, 0, 0, 0]
    assert 0 < flip.sum() < 8                    # both branches run
    port_fn = augment.hflip if axis == "h" else augment.vflip
    got = port_fn(_t(imgs), _t(flip))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cutout_matches_jax():
    """On normalised floats, centres near and at the border."""
    x = np.random.default_rng(4).standard_normal((8, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_aug.cutout(key, jnp.asarray(x), 6))
    ry, rx = jax.random.split(key)
    cy = np.asarray(jax.random.randint(ry, (8, 1, 1), 0, 16)).reshape(8)
    cx = np.asarray(jax.random.randint(rx, (8, 1, 1), 0, 16)).reshape(8)
    got = augment.cutout_at(_t(x), _t(cy).long(), _t(cx).long(), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_augment_is_seeded_and_composed():
    """crop → flip → [AutoAugment] → normalize → cutout from one
    generator: reproducible from a seed; with no crop, flip or cutout it is
    the eval transform; AutoAugment draws after the crop and flip."""
    imgs = _t(_images(5))
    norm = dict(mean=[0.5] * 3, std=[0.25] * 3)
    aug = augment.make_train_augment(**norm, cutout_size=4)
    a, b = (aug(torch.Generator().manual_seed(7), imgs) for _ in range(2))
    assert a.shape == (8, 16, 16, 3) and a.dtype == torch.float32
    assert torch.equal(a, b)
    plain = augment.make_train_augment(**norm, crop_pad=0, hflip=False)
    np.testing.assert_array_equal(
        plain(torch.Generator().manual_seed(0), imgs).numpy(),
        augment.make_eval_transform(**norm)(imgs).numpy())
    auto = augment.make_train_augment(**norm, auto_policy="cifar10")
    c, d = (auto(torch.Generator().manual_seed(7), imgs) for _ in range(2))
    assert c.shape == (8, 16, 16, 3) and torch.equal(c, d)
    plain_aa = augment.make_train_augment(**norm)(
        torch.Generator().manual_seed(7), imgs)
    assert not torch.equal(c, plain_aa)


# --------------------------------------------------------------------------
# batching and data

def test_epoch_indices_match_jax():
    r_port, r_jax = np.random.default_rng(3), np.random.default_rng(3)
    for shuffle in (True, True, False):           # two epochs of one rng
        got = epoch_indices(50, 16, r_port, shuffle)
        want = jax_epoch_indices(50, 16, r_jax, shuffle)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_arrays_bit_identical(split):
    got = _synthetic_arrays(split, n=64, image_size=24, seed=5)
    want = jax_synthetic(split, n=64, image_size=24, seed=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# drop-path and dropout draw from an explicit generator

def test_drop_path_matches_jax_layer(monkeypatch):
    """With the keep mask made by numpy and fed to both sides, the port's
    drop-path is the JAX ``drop_path`` (``where(mask, x / keep, 0)``)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6, 5, 4)).astype(np.float32)
    mask = rng.random((6, 1, 1)) < 0.7
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    want = np.asarray(jax_layers.drop_path(jnp.asarray(x), 0.3, False,
                                           jax.random.PRNGKey(0)))
    got = drop_path(_t(x), 0.3, True, mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("cls", [DropPath, Dropout])
def test_dropout_draws_from_the_set_generator(cls):
    x = torch.ones(16, 3, 4)
    mod = cls(0.5).train()
    with pytest.raises(RuntimeError, match="set_generator"):
        mod(x)                                   # no silent global RNG
    outs = []
    for seed in (11, 11, 12):
        set_generator(mod, torch.Generator().manual_seed(seed))
        outs.append(mod(x))
    assert torch.equal(outs[0], outs[1])         # one seed, one result
    assert not torch.equal(outs[0], outs[2])
    assert set(outs[0].unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(mod.eval()(x), x)


# --------------------------------------------------------------------------
# 3-step trajectory against the JAX train step

def _trajectory_batches():
    rng = np.random.default_rng(8)
    out = []
    for i in range(3):
        mask = np.ones(8, np.float32)
        if i == 2:
            mask[6:] = 0.0                        # padded last batch
        out.append((rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
                    rng.integers(0, 10, 8).astype(np.int32), mask))
    return out


@pytest.mark.parametrize("lineareval", [False, True],
                         ids=["finetune", "lineareval"])
def test_sgd_trajectory_matches_jax_train_step(lineareval):
    zm_j = JaxZoo.get_model("vit_tiny_test", classifier=[16, 10],
                            image_size=32, dtype=jnp.float32)
    params = zm_j.init(jax.random.PRNGKey(0), image_size=32)["params"]
    tx = jax_get_optimizer("sgd", 0.1)
    state = jax_steps.create_train_state(jax.random.PRNGKey(1), params, tx,
                                         lineareval=lineareval)
    jstep = jax_steps.make_train_step(zm_j.apply, tx, donate=False)

    zm = VisionModelZoo.get_model("vit_tiny_test", classifier=[16, 10],
                                  image_size=32, dtype=torch.float32,
                                  device="cpu")
    zm.model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    before = {k: v.clone() for k, v in zm.model.state_dict().items()}
    opt = get_optimizer("sgd", steps.split_params(zm.model, lineareval), 0.1)
    tstep = steps.make_train_step(zm.model, opt, lineareval=lineareval)
    zm.model.train()

    for images, labels, mask in _trajectory_batches():
        state, jm = jstep(state, {"image": jnp.asarray(images),
                                  "label": jnp.asarray(labels),
                                  "mask": jnp.asarray(mask)})
        tm = tstep(_t(images), _t(labels), _t(mask))
        np.testing.assert_allclose(
            (tm["loss_sum"] / tm["count"]).item(),
            float(jm["loss_sum"] / jm["count"]), rtol=1e-5)
        assert tm["correct"].item() == float(jm["correct"])

    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            state.merged_params()))
    got = zm.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
        if lineareval and k.startswith("backbone."):
            assert torch.equal(got[k], before[k]), k   # bit-unchanged
        elif not lineareval:
            assert not torch.equal(got[k], before[k]), k


def test_lineareval_needs_a_head():
    zm = VisionModelZoo.get_model("vit_tiny_test", image_size=32,
                                  device="cpu")
    with pytest.raises(ValueError, match="classifier head"):
        steps.split_params(zm.model, lineareval=True)


# --------------------------------------------------------------------------
# the CLI

CLI_FLAGS = ["--dataset", "synthetic", "--arch", "vit_tiny_test", "--epoch",
             "2", "--bs", "16", "--device", "cpu"]


def _keys(d):
    return {"top": set(d), "info": set(d["info"]), "telem": set(d["telem"]),
            "results": set(d["results"]),
            "rows": {k: set(d[k][0]) for k in ("train", "val")},
            "epochs": {k: len(d[k]) for k in ("train", "val")}}


def test_cli_stats_json_has_the_jax_schema(tmp_path):
    fp, jfp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    main(CLI_FLAGS + ["--stats_fp", fp])
    jax_main(CLI_FLAGS + ["--stats_fp", jfp])
    got, want = (json.load(open(p)) for p in (fp, jfp))
    assert _keys(got) == _keys(want)
    assert got["telem"]["completed"] is True
    assert got["telem"]["hardware"] == "1xcpu"
    assert all(np.isfinite(r["loss"]) for r in got["train"] + got["val"])
    assert got["train"][0]["sample"] == 512        # --scan 1: data.sets


def test_cli_lineareval_cached_and_per_step_paths(tmp_path):
    fp = str(tmp_path / "s.json")
    main(CLI_FLAGS + ["--lineareval", "--cache_features", "--fc", "8",
                      "--stats_fp", fp])
    d = json.load(open(fp))
    assert d["telem"]["mode"] == "lineareval" and len(d["val"]) == 2
    main(CLI_FLAGS + ["--scan", "0", "--limit_train", "40", "--limit_test",
                      "24", "--epoch", "1", "--stats_fp", fp])
    d = json.load(open(fp))
    assert d["train"][0]["sample"] == 40 and d["val"][0]["sample"] == 24


def test_cli_pretrained_loads_the_torch_ckpt(tmp_path, monkeypatch):
    """``--pretrained --torch_ckpt`` loads a DINO-style checkpoint into the
    backbone; under lineareval the backbone ends the run as loaded."""
    src = VisionModelZoo.get_model(
        "vit_tiny_test", image_size=32, device="cpu",
        generator=torch.Generator().manual_seed(7))
    ckpt = tmp_path / "dino.pth"
    torch.save({"teacher": {f"module.backbone.{k}": v for k, v in
                            src.model.backbone.state_dict().items()}}, ckpt)
    seen = []

    class Recording(cli_main.Trainer):
        def __init__(self, zoo_model, **kw):
            seen.append(zoo_model)
            super().__init__(zoo_model, **kw)

    monkeypatch.setattr(cli_main, "Trainer", Recording)
    fp = str(tmp_path / "s.json")
    main(CLI_FLAGS + ["--epoch", "1", "--lineareval", "--pretrained",
                      "--torch_ckpt", str(ckpt), "--stats_fp", fp])
    got = seen[0].model.backbone.state_dict()
    for k, v in src.model.backbone.state_dict().items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="torch_ckpt"):
        main(CLI_FLAGS + ["--pretrained", "--stats_fp", fp])


# the checkpoint, AutoAugment, bundle and tire flags were refused until
# their slice landed, the parallelism flags until theirs did (the CLI runs
# them in tests/test_torch_port_parallel.py); every one is now the
# accepted side of the check: it parses to its value
LANDED_FLAGS = ["aug_auto", "ckpt_dir", "export_bundle", "fsdp", "mesh",
                "pipe_microbatches", "resume", "save_every"]


@pytest.mark.parametrize("flag", sorted(LANDED_FLAGS) + ["dataset"])
def test_cli_refuses_flags_of_later_slices(flag, tmp_path):
    value = {"fsdp": [], "dataset": ["tire"], "save_every": ["2"],
             "pipe_microbatches": ["2"], "aug_auto": ["cifar10"]}.get(
                 flag, ["x"])
    argv = CLI_FLAGS + [f"--{flag}", *value,
                        "--stats_fp", str(tmp_path / "s.json")]
    A = ARGS(classification_config())
    A.set_and_parse_args(argv)
    assert A.args[flag] == {"save_every": 2, "pipe_microbatches": 2,
                            "fsdp": True}.get(flag, (value or [None])[0])


def test_cli_needs_a_gpu_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(CLI_FLAGS[:-2] + ["--stats_fp", str(tmp_path / "s.json")])
