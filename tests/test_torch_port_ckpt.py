"""Port parity: checkpoints, resume and ``--export_bundle``, on the CPU.

The checkpoint files (``checkpoint/ckpt_io.py``): a bitwise round trip of
a ResNet trainer's state (parameters, BatchNorm buffers, AdamW moments,
step, generator), recency retention, the metrics sidecar and the atomic
write.  The trainer's resume against the JAX trainer's from the same
``vit_tiny_test`` weights (no dropout, no random augmentation, the same
numpy permutations): the start epoch, the seeded best accuracy, the
``best/`` mirror and the final parameters.  A resumed run against an
unbroken one where the batch order cannot matter, the cached linear
eval's checkpoint, and ``cli.main --ckpt_dir/--resume/--export_bundle``.
Inputs come from numpy with a seed; tolerances are stated per test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.checkpoint import orbax_io
from vit_torch_tpu.data.augment import normalize as jax_normalize
from vit_torch_tpu.models.zoo import VisionModelZoo as JaxZoo
from vit_torch_tpu.train.trainer import Trainer as JaxTrainer
from vit_torch_tpu_torch.checkpoint import ckpt_io
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import main as cli_main
from vit_torch_tpu_torch.data.augment import normalize
from vit_torch_tpu_torch.data.datasets import NORM_VALUES, _synthetic_arrays
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.serving.export import load_bundle
from vit_torch_tpu_torch.train.trainer import Trainer
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

NORM = NORM_VALUES["synthetic"]


def _sets(n_train, n_val, size=16):
    return {"train": _synthetic_arrays("train", n=n_train, image_size=size),
            "val": _synthetic_arrays("test", n=n_val, image_size=size)}


def _port_trainer(arch, epochs, state_dict=None, dtype=torch.float32,
                  **kw):
    zm = VisionModelZoo.get_model(arch, classifier=[10], image_size=16,
                                  dtype=dtype, device="cpu")
    if state_dict is not None:
        zm.model.load_state_dict(state_dict)
    zm.model.to(dtype)                      # BatchNorm's fp32 state too
    return Trainer(zm, epochs=epochs, lr=0.05, opt=kw.pop("opt", "sgd"),
                   augment_fn=lambda gen, x: normalize(x, **NORM,
                                                       dtype=dtype),
                   eval_transform=lambda x: normalize(x, **NORM,
                                                      dtype=dtype),
                   print_progress=False, **kw)


# --------------------------------------------------------------------------
# the checkpoint files

def test_roundtrip_is_bitwise(tmp_path):
    """Two AdamW steps of a BatchNorm model, saved and restored into a
    fresh trainer: every tensor bitwise, the step and the generator."""
    tr = _port_trainer("resnet_test", 1, opt="adamw")
    imgs, labels = _sets(8, 8)["train"]
    x = torch.from_numpy(imgs)
    y = torch.from_numpy(labels.astype(np.int64))
    tr.model.train()
    for _ in range(2):
        tr.train_step(x, y, torch.ones(8))
        tr.step += 1
    torch.rand(3, generator=tr.generator)      # move the generator on
    d = str(tmp_path / "ck")
    ckpt_io.save_checkpoint(d, tr.checkpoint_state(0), 0,
                            metrics={"val_acc": 0.25})
    back = _port_trainer("resnet_test", 2, opt="adamw", resume=d)
    assert back.start_epoch == 1 and back.step == 2
    assert back.best_acc == 0.25
    want, got = tr.model.state_dict(), back.model.state_dict()
    assert any("running_var" in k for k in want)
    assert any("num_batches_tracked" in k for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(got["backbone.bn1.num_batches_tracked"]) == 2
    so, go = tr.optimizer.state_dict(), back.optimizer.state_dict()
    assert so["param_groups"] == go["param_groups"]
    assert len(so["state"]) == len(tr.optimizer.param_groups[0]["params"])
    for i, st in so["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(go["state"][i][name], st[name]), (i, name)
    assert torch.equal(back.generator.get_state(), tr.generator.get_state())


def test_retention_metrics_and_atomic_write(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt_io.latest_step(d) is None
    assert ckpt_io.best_saved_metric(d) is None
    os.makedirs(d)
    assert ckpt_io.latest_step(d) is None
    state = {"w": torch.arange(4.0), "epoch": 0}
    for step, acc in enumerate([0.2, 0.9, 0.4, 0.5, 0.3]):
        ckpt_io.save_checkpoint(d, dict(state, epoch=step), step,
                                metrics={"val_acc": acc})
    assert ckpt_io._steps(d) == [2, 3, 4]               # max_to_keep=3
    assert sorted(ckpt_io.saved_metrics(d)) == [0, 1, 2, 3, 4]
    assert ckpt_io.best_saved_metric(d) == 0.9          # step 1, evicted
    # a crash mid-save: a half-written temporary directory and a step
    # directory without its file are never picked
    os.makedirs(os.path.join(d, ".tmp-9-123"))
    open(os.path.join(d, ".tmp-9-123", "state.pt"), "wb").write(b"\0" * 7)
    os.makedirs(os.path.join(d, "8"))
    assert ckpt_io.latest_step(d) == 4
    assert ckpt_io.restore_checkpoint(d)["epoch"] == 4
    # saving a step again replaces it
    ckpt_io.save_checkpoint(d, dict(state, epoch=44), 4)
    assert ckpt_io.restore_checkpoint(d, 4)["epoch"] == 44
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore_checkpoint(str(tmp_path / "empty"))


# --------------------------------------------------------------------------
# the trainer's resume against the JAX trainer's

def _jax_trainer(params, epochs, **kw):
    zm = JaxZoo.get_model("vit_tiny_test", classifier=[10], image_size=16,
                          dtype=jnp.float32)
    return JaxTrainer(zm, epochs=epochs, lr=0.05, opt="sgd", image_size=16,
                      init_params=params,
                      augment_fn=lambda rng, x: jax_normalize(x, **NORM),
                      eval_transform=lambda x: jax_normalize(x, **NORM),
                      print_progress=False, **kw)


def _jax_params():
    """Seeded ``vit_tiny_test`` weights in the JAX tree, shaped by
    ``jax.eval_shape`` (no init compile): LayerNorm scales 1, biases 0."""
    zm = JaxZoo.get_model("vit_tiny_test", classifier=[10], image_size=16,
                          dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: zm.init(jax.random.PRNGKey(0),
                                            image_size=16))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, s):
        fill = {"scale": 1.0, "bias": 0.0}.get(path[-1].key)
        if fill is not None:
            return np.full(s.shape, fill, np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture
def one_jax_program(monkeypatch):
    """The JAX trainers of a test share their first scan programs: the
    same model, loss and optimizer hyperparameters, so one compile."""
    from vit_torch_tpu.train import scan
    for name in ("make_scan_train_fn", "make_scan_eval_fn"):
        make, built = getattr(scan, name), []

        def reuse(*a, _make=make, _built=built, **kw):
            if not _built:
                _built.append(_make(*a, **kw))
            return _built[0]

        monkeypatch.setattr(scan, name, reuse)


def _committed(trainer):
    """The state committed to one device, as a restored state is, so that
    the shared scan programs see the same arguments and do not retrace."""
    trainer.state = jax.device_put(trainer.state, jax.devices()[0])
    return trainer


def test_resume_matches_the_jax_trainer(tmp_path, one_jax_program):
    """Save at epoch 0, resume, run epoch 1 (3 steps an epoch): both
    packages restart the shuffle at epoch 0's permutation and agree on
    the start epoch, the seeded best, the best mirror, every saved step
    and metric and the final parameters, within the trajectory tests'
    fp32 tolerance (atol 2e-5, rtol 1e-4)."""
    sets = _sets(24, 16)
    params = _jax_params()
    sd = state_dict_from_jax(params)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    first = _jax_trainer(params, 1, ckpt_dir=jd)
    _committed(first).fit_scan(sets, 8)
    _port_trainer("vit_tiny_test", 1, sd, ckpt_dir=pd).fit_scan(sets, 8)
    jt = _committed(_jax_trainer(params, 2, ckpt_dir=jd, resume=jd,
                                 save_every=1))
    pt = _port_trainer("vit_tiny_test", 2, sd, ckpt_dir=pd, resume=pd,
                       save_every=1)
    assert pt.start_epoch == jt.start_epoch == 1
    assert pt.best_acc == jt.best_acc > -1.0
    assert pt._seed_val_accs() == jt._seed_val_accs()
    jt.fit_scan(sets, 8)
    pt.fit_scan(sets, 8)
    assert ckpt_io._steps(pd) == [0, 1] and orbax_io.latest_step(jd) == 1
    assert ckpt_io.latest_step(os.path.join(pd, "best")) == \
        orbax_io.latest_step(os.path.join(jd, "best"))
    assert ckpt_io.saved_metrics(pd) == orbax_io.saved_metrics(jd)
    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            jt.state.merged_params()))
    got = pt.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    assert pt.step == 6


def _unbroken_and_resumed(tmp_path, arch, dtype, **kw):
    """One batch an epoch, so the shuffle restart changes only the order
    inside the batch: two epochs unbroken, and one + resume + one."""
    sets = _sets(8, 8)
    whole = _port_trainer(arch, 2, dtype=dtype, **kw)
    whole.fit_scan(sets, 8)
    d = str(tmp_path / arch)
    _port_trainer(arch, 1, dtype=dtype, ckpt_dir=d, **kw).fit_scan(sets, 8)
    resumed = _port_trainer(arch, 2, dtype=dtype, ckpt_dir=d, resume=d,
                            **kw)
    resumed.fit_scan(sets, 8)
    return whole.model.state_dict(), resumed.model.state_dict()


def test_resumed_vit_equals_unbroken_run(tmp_path):
    """fp32 SGD: the batch's rows summed in another order, 1e-5 of 1.
    (Not Adam: the key bias's gradient is 0 in exact arithmetic, softmax
    being shift-invariant, and Adam scales its rounding noise up to lr.)"""
    want, got = _unbroken_and_resumed(tmp_path, "vit_tiny_test",
                                      torch.float32)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   msg=k)


def test_resumed_resnet_carries_batchnorm_statistics(tmp_path):
    """A ResNet SGD fine-tune in float64 (in fp32 a BN output within
    rounding of 0 may take the other side of a ReLU when the rows are
    summed in another order, ROADMAP §C): the parameters, running
    statistics and counts of the resumed run equal the unbroken run's, to
    1e-12 (2e-16 measured)."""
    want, got = _unbroken_and_resumed(tmp_path, "resnet_test",
                                      torch.float64)
    assert int(got["backbone.bn1.num_batches_tracked"]) == 2
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-12, rtol=1e-12,
                                   msg=k)


def test_cached_lineareval_checkpoint_resumes(tmp_path):
    """The cached linear eval saves the whole model with the head
    optimizer's state; on resume the backbone (its BN statistics too)
    comes back bitwise and the head trains on from the saved weights with
    a fresh optimizer, as in the JAX package."""
    sets = _sets(16, 8)
    d = str(tmp_path / "le")
    first = _port_trainer("resnet_test", 1, lineareval=True, ckpt_dir=d,
                          opt="adam")
    first.fit_lineareval_cached(sets, 8)
    saved = ckpt_io.restore_checkpoint(d)
    assert saved["epoch"] == 0 and saved["step"] == 2
    assert len(saved["optimizer"]["state"]) == len(list(
        first.model.head.parameters()))                  # the head's
    assert all(torch.equal(saved["model"][k], v)
               for k, v in first.model.state_dict().items())
    resumed = _port_trainer("resnet_test", 2, lineareval=True, ckpt_dir=d,
                            resume=d, opt="adam")
    assert resumed.start_epoch == 1
    assert resumed.best_acc == ckpt_io.best_saved_metric(d)
    resumed.fit_lineareval_cached(sets, 8)
    after = resumed.model.state_dict()
    for k, v in saved["model"].items():
        same = torch.equal(after[k], v)
        assert same == k.startswith("backbone."), k
    assert resumed.step == 4


# --------------------------------------------------------------------------
# the CLI

CLI_FLAGS = ["--dataset", "synthetic", "--arch", "vit_tiny_test", "--bs",
             "64", "--device", "cpu", "--dtype", "float32", "--scan", "0",
             "--limit_train", "128", "--limit_test", "64"]


def test_cli_checkpoints_resumes_and_exports(tmp_path, monkeypatch):
    seen = []

    class Recording(cli_main.Trainer):
        def __init__(self, zoo_model, **kw):
            super().__init__(zoo_model, **kw)
            seen.append(self)

    monkeypatch.setattr(cli_main, "Trainer", Recording)
    d, b = str(tmp_path / "ck"), str(tmp_path / "bundle")
    fp = str(tmp_path / "s.json")
    cli_main.main(CLI_FLAGS + ["--epoch", "1", "--ckpt_dir", d,
                               "--stats_fp", fp])
    assert ckpt_io.latest_step(d) == 0
    assert ckpt_io.latest_step(os.path.join(d, "best")) == 0
    cli_main.main(CLI_FLAGS + ["--epoch", "2", "--resume", d, "--ckpt_dir",
                               d, "--save_every", "1", "--export_bundle", b,
                               "--export_bs", "1,4", "--stats_fp", fp])
    assert seen[1].start_epoch == 1
    assert ckpt_io.latest_step(d) == 1
    assert len(json.load(open(fp))["train"]) == 1        # epoch 1 only
    bundle = load_bundle(b, device="cpu")
    assert bundle.manifest["batch_sizes"] == [1, 4]
    assert bundle.manifest["norm"] == {k: list(v) for k, v in NORM.items()}
    images = np.random.default_rng(3).integers(0, 256, (5, 32, 32, 3),
                                               dtype=np.uint8)
    model = seen[1].model.eval()
    with torch.no_grad():
        want = model(normalize(torch.from_numpy(images), **NORM)).numpy()
    # the bundle normalises as (x/255 - mean)/std, the eval transform as
    # (x - 255 mean)/(255 std): fp32 rounding apart
    np.testing.assert_allclose(bundle.predict(images), want, atol=1e-5,
                               rtol=1e-5)
