"""Port parity: the data extras on the CPU: AutoAugment, host and device
LBP and the tire dataset, against the JAX package.

Each of the 14 AutoAugment ops runs on the same images, magnitudes and
signs in both packages (the JAX ops traced once for the file); three
against PIL as ``tests/test_autoaugment.py`` does; the grouped batch
apply against a per-sample composition.  The port's host LBP against the
JAX package's ``lbp.py`` and the port's ``lbp_device`` against the port's
host LBP, bit-exact, for every method and the r/g/b/l channels.  The tire
build against ``vit_torch_tpu.data.tire`` on a tiny ImageFolder, and
``cli.main --dataset tire`` on the CPU.  Inputs come from numpy with a
seed.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from vit_torch_tpu.data import autoaugment as jax_aa
from vit_torch_tpu.data import lbp as jax_lbp
from vit_torch_tpu.data.tire import TireDatasets as JaxTire
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data import autoaugment as aa
from vit_torch_tpu_torch.data import lbp, lbp_device
from vit_torch_tpu_torch.data.augment import make_train_augment
from vit_torch_tpu_torch.data.tire import TireDatasets
from vit_torch_tpu_torch.serving.export import load_bundle
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# ops whose outputs are copied or integer levels in both packages
EXACT = {"translateX", "translateY", "rotate", "posterize", "solarize",
         "equalize", "invert", "brightness"}
# the bicubic shears: XLA fuses the 16-tap sum, the port rounds each
# product and sum; the blends: the gray weights' and the mean's sums
# in another order.  Fractions of a level (2.6e-4 and 3e-5 measured).
ATOL = 1e-3

# 6 samples: magnitude indices 0, 3, 6, 9 and 9, 4, both signs
MAG_IDX = [0, 3, 6, 9, 9, 4]
SIGNS = np.array([1, -1, 1, -1, 1, -1], np.float32)


def _images(n=6, h=14, w=18, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3)).astype(np.float32)


def _mags(name):
    if name == "posterize":
        return np.array([8, 7, 6, 5, 4, 4], np.float32)
    return np.array([float(jax_aa._RANGES[name][i]) for i in MAG_IDX],
                    np.float32)


@pytest.fixture(scope="module")
def jax_ops():
    """Every JAX op on the same images, traced once for the file."""
    imgs = _images()
    mags = np.stack([_mags(name) for name in aa.OP_NAMES])

    @jax.jit
    def all_ops(imgs, mags):
        return jnp.stack([jax.vmap(fn)(imgs, mags[k], jnp.asarray(SIGNS))
                          for k, fn in enumerate(jax_aa._OP_FNS)])

    return np.asarray(all_ops(imgs, mags))


@pytest.mark.parametrize("name", aa.OP_NAMES)
def test_autoaugment_op_matches_jax(name, jax_ops):
    k = aa.OP_NAMES.index(name)
    assert jax_aa.OP_NAMES[k] == name
    got = aa.OP_FNS[k](torch.from_numpy(_images()),
                       torch.from_numpy(_mags(name)),
                       torch.from_numpy(SIGNS)).numpy()
    want = jax_ops[k]
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _pil(img):
    return Image.fromarray(img.astype(np.uint8))


@pytest.mark.parametrize("name", ["rotate", "equalize", "shearX"])
def test_autoaugment_matches_pil(name):
    """Rotation (PIL's centre, nearest, fill 128) and equalize exactly;
    the bicubic shear within one level (PIL rounds per tap row)."""
    imgs = _images(3, 16, 16, seed=1)
    x = torch.from_numpy(imgs)
    if name == "rotate":
        mags = [9.0, 30.0, 17.5]
        got = aa._rotate(x, torch.tensor(mags), torch.ones(3)).numpy()
        for img, ang, out in zip(imgs, mags, got):
            rot = _pil(img).convert("RGBA").rotate(ang)
            ref = Image.composite(rot, Image.new("RGBA", rot.size,
                                                 (128,) * 4), rot)
            np.testing.assert_array_equal(out, np.asarray(ref.convert("RGB")))
    elif name == "equalize":
        got = aa._equalize(x, torch.zeros(3), torch.ones(3)).numpy()
        for img, out in zip(imgs, got):
            np.testing.assert_array_equal(
                out, np.asarray(ImageOps.equalize(_pil(img))))
    else:
        mags = torch.tensor([0.1, 0.3, 0.3])
        signs = torch.tensor([1.0, 1.0, -1.0])
        got = aa._shear_x(x, mags, signs).round().numpy()
        for img, m, out in zip(imgs, (mags * signs).tolist(), got):
            ref = _pil(img).transform((16, 16), Image.AFFINE,
                                      (1, m, 0, 0, 1, 0), Image.BICUBIC,
                                      fillcolor=(128, 128, 128))
            np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                       atol=1.0)


@pytest.mark.parametrize("policy", sorted(aa.POLICIES))
def test_grouped_policy_equals_per_sample_composition(policy):
    """The batch grouped by drawn op equals each sample run alone through
    its two ops (rounded to uint8 levels after each), bitwise."""
    gen = torch.Generator().manual_seed(3)
    images = torch.from_numpy(_images(16, 12, 14, seed=2).astype(np.uint8))
    tables = aa.policy_tables(policy)
    idx, u, s = aa.draw(gen, 16, tables["op"].shape[1], "cpu")
    got = aa.apply_policy(images, tables, idx, u, s)
    assert got.dtype == torch.uint8 and got.shape == images.shape
    for i in range(16):
        x = images[i:i + 1].float()
        for k in range(2):
            j = int(idx[i])
            if u[k, i] < tables["p"][k, j]:
                sign = s[k, i:i + 1] if tables["signed"][k, j] else \
                    torch.ones(1)
                op = aa.OP_FNS[int(tables["op"][k, j])]
                x = op(x, tables["mag"][k, j:j + 1], sign)
            x = x.round().clamp(0, 255)
        assert torch.equal(got[i:i + 1], x.to(torch.uint8)), i


def test_autoaugment_draws_from_the_generator():
    images = torch.from_numpy(_images(8, 12, 12).astype(np.uint8))
    augment = aa.make_autoaugment("svhn")
    first = augment(torch.Generator().manual_seed(0), images)
    assert torch.equal(first, augment(torch.Generator().manual_seed(0),
                                      images))
    assert not torch.equal(first, augment(torch.Generator().manual_seed(1),
                                          images))
    train = make_train_augment([0.5] * 3, [0.25] * 3, auto_policy="cifar10")
    out = train(torch.Generator().manual_seed(0), images)
    assert out.shape == (8, 12, 12, 3) and out.dtype == torch.float32


# --------------------------------------------------------------------------
# LBP

METHODS = ("r", "g", "b", "l", "default", "ror", "uniform", "nri_uniform")


def _lbp_images():
    imgs = np.random.default_rng(4).integers(0, 256, (3, 20, 24, 3)).astype(
        np.uint8)
    imgs[0, 4:12, 5:15] = 77                 # a flat patch: every tie
    imgs[1, :, :12] = imgs[1, :, 12:]        # repeats
    imgs[2] = imgs[2] // 64 * 64             # four levels: many ties
    return imgs


@pytest.mark.parametrize("radius", [1, 2])
def test_host_lbp_matches_jax(radius):
    for img in _lbp_images():
        want = jax_lbp.get_lbp_merge(img, radius, 8, METHODS)
        got = lbp.get_lbp_merge(img, radius, 8, METHODS)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1, 2])
def test_device_lbp_equals_host_lbp(radius):
    imgs = _lbp_images()
    got = lbp_device.lbp_merge_device(torch.from_numpy(imgs), radius, 8,
                                      METHODS)
    want = np.stack([lbp.get_lbp_merge(img, radius, 8, METHODS)
                     for img in imgs])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the tire dataset

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Two classes of four PNGs of mixed sizes and aspect ratios."""
    root = tmp_path_factory.mktemp("tire")
    rng = np.random.default_rng(5)
    for c in ("a", "b"):
        os.makedirs(root / c)
        for i, (h, w) in enumerate([(20, 14), (16, 16), (11, 19), (24, 18)]):
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8)).save(root / c / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("settings,aug_auto", [(0, ""), (1, ""),
                                               (3, "imagenet")])
def test_tire_build_matches_jax(folder, settings, aug_auto):
    kw = dict(image_size=16, bs=4, settings=settings, prefetch=False,
              aug_auto=aug_auto)
    want, got = JaxTire(folder, **kw), TireDatasets(folder, **kw)
    assert got.image_channels == want.image_channels == (7 if settings == 0
                                                         else 3)
    assert got.norm_values == want.norm_values
    assert got.info == want.info
    for split in ("train", "test"):
        for a, b in zip(got.sets[split], want.sets[split]):
            np.testing.assert_array_equal(a, b)
    augment = got.make_augment_fn()
    out = augment(torch.Generator().manual_seed(0),
                  torch.from_numpy(got.sets["train"][0]))
    assert out.shape == (6, 16, 16, got.image_channels)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("aug_auto", ["", "imagenet"])
def test_cli_trains_on_tire(folder, tmp_path, aug_auto, monkeypatch):
    """``cli.main --dataset tire`` on the CPU, 7 channels; the exported
    bundle takes the 7-channel stack and gives the trained model's
    logits."""
    seen = []

    class Recording(cli_main.Trainer):
        def __init__(self, zoo_model, **kw):
            super().__init__(zoo_model, **kw)
            seen.append(self)

    monkeypatch.setattr(cli_main, "Trainer", Recording)
    fp, b = str(tmp_path / "s.json"), str(tmp_path / "bundle")
    cli_main.main(["--dataset", "tire", "--data_path", folder, "--arch",
                   "vit_tiny_test", "--image_size", "16", "--tire_settings",
                   "0", "--epoch", "1", "--bs", "4", "--device", "cpu",
                   "--dtype", "float32", "--aug_auto", aug_auto,
                   "--export_bundle", b, "--export_bs", "2",
                   "--stats_fp", fp])
    stats = json.load(open(fp))
    assert stats["train"][0]["sample"] == 6
    assert np.isfinite(stats["val"][0]["loss"])
    bundle = load_bundle(b, device="cpu")
    assert bundle.manifest["image_channels"] == 7
    test_stack = TireDatasets(folder, image_size=16, settings=0,
                              prefetch=False).sets["test"][0]
    model = seen[0].model.eval()
    with torch.no_grad():
        want = model(seen[0].eval_transform(torch.from_numpy(test_stack)))
    np.testing.assert_allclose(bundle.predict(test_stack), want.numpy(),
                               atol=1e-5, rtol=1e-5)
