"""Port parity: the parallelism slice (data parallel, FSDP, tensor
parallel, ring attention, the GPipe pipeline, detection data parallelism,
checkpoints across meshes, the CLI) over a real ``torch.distributed``
group, against the JAX package's sharded steps on the same meshes.

One spawned group of four gloo ranks (``tests/torch_parallel_cases.py``)
runs every multi-rank case once per session: the first xdist worker to
need it runs it behind an ``fcntl`` lock in the session's shared base
temp directory and the others read its results.  The ranks import no JAX.
Each test then runs its JAX reference here (8 virtual CPU devices,
``tests/conftest.py``) from the same seeded weights.  The group also runs
the ring and the pipeline with every transfer staged through host
buffers (as gloo needs for CUDA tensors), held bit for bit against the
direct ones.  Tolerances: losses
rtol 2e-4 (``tests/test_parallel.py:111``), parameters atol 1e-5 after 3
fp32 SGD steps, the ring atol 2e-5 / rtol 1e-4
(``tests/test_ring_attention.py:24``), ResNet in float64.
"""

import contextlib
import dataclasses
import fcntl
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from vit_torch_tpu.detection import detr as jax_detr
from vit_torch_tpu.detection import faster_rcnn as jax_frcnn
from vit_torch_tpu.detection.engine import (
    DetectionTrainer as JaxDetectionTrainer)
from vit_torch_tpu.detection.engine import (
    FasterRCNNTrainer as JaxFasterRCNNTrainer)
from vit_torch_tpu.models.resnet import RESNET_CONFIGS as JAX_RESNET_CONFIGS
from vit_torch_tpu.models.resnet import ResNet as JaxResNet
from vit_torch_tpu.models.swin import SWIN_CONFIGS as JAX_SWIN_CONFIGS
from vit_torch_tpu.models.swin import SwinTransformer as JaxSwin
from vit_torch_tpu.models.zoo import VisionModelZoo as JaxZoo
from vit_torch_tpu.ops.ring_attention import ring_attention as jax_ring
from vit_torch_tpu.parallel.api import shard_batch, shard_train_fns
from vit_torch_tpu.parallel.mesh import make_mesh
from vit_torch_tpu.parallel.partition import add_fsdp_axis
from vit_torch_tpu.parallel.pipeline import zoo_pipeline_forms
from vit_torch_tpu.train.optimizers import get_optimizer as jax_optimizer
from vit_torch_tpu.train.steps import create_train_state
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.detection.faster_rcnn import FasterRCNNConfig
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-5


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _seeded(shapes, seed, dtype=np.float32):
    """A tree of ``shapes``' leaves from numpy: matrices N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1), variances 1 + |N(0, 0.1)|, the rest
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if "kernel" in name and len(s.shape) >= 2:
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name:
            x = 1 + 0.1 * x
        elif "var" in name:
            x = 1 + 0.1 * np.abs(x)
        else:
            x = 0.1 * x
        return x.astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_vit():
    zm = JaxZoo.get_model(cases.VIT["arch"],
                          classifier=cases.VIT["classifier"],
                          image_size=cases.VIT["image_size"],
                          dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: zm.init(
        jax.random.PRNGKey(0), image_size=cases.VIT["image_size"]))
    return zm, _seeded(shapes["params"], 0)


def _jax_resnet():
    zm = JaxZoo.get_model("resnet_test", classifier=[10], image_size=32,
                          dtype=jnp.float64)
    with _x64():
        shapes = jax.eval_shape(lambda: zm.init(jax.random.PRNGKey(0),
                                                image_size=32))
    tree = _seeded(shapes, 1, np.float64)
    return zm, tree["params"], tree["batch_stats"]


def _jax_family(arch, size):
    """A TP family's JAX zoo model and seeded parameters."""
    zm = JaxZoo.get_model(arch, classifier=[10], image_size=size,
                          dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: zm.init(jax.random.PRNGKey(0),
                                            image_size=size))
    return zm, _seeded(shapes["params"], 2)


def _jax_detr(num_classes):
    """The JAX DETR over Swin-T-test of the rank group's detection
    config, and seeded parameters."""
    backbone = JaxSwin(JAX_SWIN_CONFIGS["swin_test"], dtype=jnp.float32,
                       features_only=True, name="backbone")
    jmodel = jax_detr.DETR(jax_detr.DETRConfig(
        num_classes=num_classes, **cases.DETR_CFG), backbone,
        dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), True))["params"]
    return jmodel, _seeded(shapes, 6)


def _jax_frcnn(num_classes):
    """The JAX Faster R-CNN over resnet_test of the rank group's detection
    config, and seeded variables (params and BatchNorm statistics)."""
    backbone = JaxResNet(JAX_RESNET_CONFIGS["resnet_test"],
                         dtype=jnp.float32, features_only=True,
                         name="backbone")
    jmodel = jax_frcnn.FasterRCNN(jax_frcnn.FasterRCNNConfig(
        num_classes=num_classes, **cases.FRCNN_CFG), backbone,
        dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        deterministic=True))
    return jmodel, _seeded(shapes, 7)


def _jax_frcnn_draws(jmodel, batch):
    """The JAX trainer's draws in its first step (``engine.py:833``, its
    ``train_step``): the flip, then per image the RPN and the RoI noise
    (``faster_rcnn.py:459`` and ``:140``)."""
    _, step = jax.random.split(jax.random.PRNGKey(0))
    flip_rng, sample_rng = jax.random.split(step)
    keys = [jax.random.split(k) for k in jax.random.split(sample_rng, batch)]
    cfg = jmodel.config
    n_anchors = FasterRCNNConfig(**dataclasses.asdict(cfg)).num_anchors
    return {"flip": torch.from_numpy(np.array(
                jax.random.bernoulli(flip_rng, 0.5, (batch,)))),
            "rpn_noise": torch.from_numpy(np.stack([np.asarray(
                jax.random.uniform(k[0], (n_anchors,))) for k in keys])),
            "roi_noise": torch.from_numpy(np.stack([np.asarray(
                jax.random.uniform(k[1], (cfg.num_proposals,)))
                for k in keys]))}


def _inputs():
    _, vit = _jax_vit()
    _, params, stats = _jax_resnet()
    rng = np.random.default_rng(3)
    families = {arch: state_dict_from_jax(_jax_family(arch, size)[1])
                for arch, size in cases.TP_FAMILIES}
    batches, k = cases.detection_batches()
    frcnn, frcnn_vars = _jax_frcnn(k)
    return {**families, "detr": state_dict_from_jax(_jax_detr(k)[1]),
            "frcnn": state_dict_from_jax(
                frcnn_vars["params"], batch_stats=frcnn_vars["batch_stats"]),
            "frcnn_draws": _jax_frcnn_draws(frcnn, len(batches[0]["image"])),
            "vit_flax": vit, "vit": state_dict_from_jax(vit),
            "resnet_flax": (params, stats),
            "resnet": {k: v.double() for k, v in state_dict_from_jax(
                params, batch_stats=stats).items()},
            "resnet_batch": (rng.normal(0, 1, (8, 32, 32, 3)),
                             rng.integers(0, 10, 8).astype(np.int64),
                             np.float64([1, 1, 1, 1, 1, 1, 1, 0]))}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(rank 0's results, the inputs, the group's directory): the group
    runs once a session, whichever worker gets here first."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent if uid
            else tmp_path_factory.getbasetemp())
    workdir = root / f"torch_parallel_{uid or 'local'}"
    with open(root / f"torch_parallel_{uid or 'local'}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (workdir / "failed.txt").exists():
                pytest.fail((workdir / "failed.txt").read_text())
            if not (workdir / "results.pt").exists():
                workdir.mkdir(exist_ok=True)
                torch.save(_inputs(), workdir / "inputs.pt")
                try:
                    cases.run_group(str(workdir))
                except Exception as e:
                    (workdir / "failed.txt").write_text(repr(e))
                    raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    load = lambda f: torch.load(workdir / f, weights_only=False)  # noqa
    return load("results.pt"), load("inputs.pt"), workdir


def _jax_steps(apply_fn, params, spec, n, batch, *, model_state=None,
               fsdp=False, to_pipe=None, lr=cases.LR):
    """3 sharded JAX steps: (losses, final params, final model state)."""
    mesh = make_mesh(spec, devices=jax.devices()[:n])
    tx = jax_optimizer("sgd", lr)
    if to_pipe is not None:
        to_pipe, from_pipe, apply_fn = to_pipe(mesh)
        params = to_pipe(params)
    state = create_train_state(jax.random.PRNGKey(1), params, tx,
                               model_state=model_state)
    step, _, state = shard_train_fns(apply_fn, tx, state, mesh, fsdp=fsdp,
                                     fsdp_min_size=cases.FSDP_MIN)
    images, labels, mask = batch
    b = shard_batch({"image": images, "label": labels.astype(np.int32),
                     "mask": mask.astype(images.dtype)}, mesh)
    losses = []
    for _ in range(cases.STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    out = jax.tree.map(np.asarray, jax.device_get(state.params))
    if to_pipe is not None:
        out = from_pipe(out)
    return losses, out, jax.device_get(state.model_state)


def _compare(got, want_losses, want_state, loss_rtol=LOSS_RTOL,
             atol=PARAM_ATOL, rtol=0.0):
    losses, state = got
    np.testing.assert_allclose(losses, want_losses, rtol=loss_rtol)
    assert set(want_state) <= set(state)
    for k, w in want_state.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[k].double().numpy(),
                                   w.double().numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


def _ok(results, name):
    r = results[name]
    assert not (isinstance(r, dict) and "error" in r), r
    return r


# --------------------------------------------------------------------------

def test_multihost_utils_and_process_shard(group):
    r = _ok(group[0], "case_utils")
    assert r["gathered"] == [{"rank": i, "sq": i * i} for i in range(4)]
    assert r["saved"] == ["master_r0.txt"]
    assert r["shards"] == [list(range(10))[i::4] for i in range(4)]
    assert r["batch_rows"] == [([2.0 * i, 2.0 * i + 1], [2 * i, 2 * i + 1],
                                "kept") for i in range(4)]


def test_tensor_parallel_keeps_indivisible_heads_replicated(group):
    """model=4 over vit_tiny_test's two heads: the rules shard qkv (192
    rows divide by 4) but the attention keeps its heads whole, so it stays
    replicated with one warning naming it; the MLPs (hidden 256) shard."""
    r = _ok(group[0], "case_utils")
    assert r["tp4_cut"] == [f"backbone.blocks.{i}.mlp.{p}"
                            for i in range(2) for p in
                            ("fc1.bias", "fc1.weight", "fc2.weight")]
    assert len(r["tp4_warnings"]) == 1
    msg = r["tp4_warnings"][0]
    assert "keeps 2 module(s) replicated" in msg
    assert "backbone.blocks.0.attn: 2 heads not divisible by model=4" in msg


def test_ring_attention_matches_jax(group):
    """seq=4 at N = 13 (padded to 16 over four shards): the output and the
    gradients of q, k and v against the JAX ring on a seq=4 mesh."""
    r = _ok(group[0], "case_ring")
    q, k, v, do = (jnp.asarray(a) for a in cases.ring_inputs())
    mesh = make_mesh("seq=4", devices=jax.devices()[:4])

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: jax_ring(q, k, v, mesh), q, k, v)
        return (out, *vjp(do))

    want = dict(zip(("out", "dq", "dk", "dv"), fwd_bwd(q, k, v, do)))
    for name, w in want.items():
        np.testing.assert_allclose(r[name].numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("spec", ["data=4", "data=2,model=2", "data=4 fsdp"])
def test_vit_mesh_matches_jax_sharded_step(group, spec):
    """3 SGD steps of vit_tiny_test against JAX ``shard_train_fns`` on the
    same mesh (FSDP: tensors of at least 1024 values sharded on both
    sides, the same ones)."""
    r = _ok(group[0], "case_vit")
    zm, params = _jax_vit()
    fsdp = spec.endswith("fsdp")
    losses, p, _ = _jax_steps(zm.model.apply, params, spec.split()[0], 4,
                              cases.vit_batch(), fsdp=fsdp)
    _compare(r[spec], losses, state_dict_from_jax(p))
    if fsdp:
        mesh = make_mesh("data=4", devices=jax.devices()[:4])
        from jax.sharding import PartitionSpec as P
        specs = add_fsdp_axis(params, jax.tree.map(lambda _: P(), params),
                              mesh, min_size=cases.FSDP_MIN)
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]
        sharded = {jax.tree_util.keystr(path) for path, s in flat
                   if "data" in s}
        assert len(r["fsdp_sharded"]) == len(sharded) > 0


def test_seq_mesh_matches_jax_data2(group):
    """data=2,seq=2 (ring attention in every block, N = 5 padded to 6)
    against the JAX data=2 step."""
    zm, params = _jax_vit()
    losses, p, _ = _jax_steps(zm.model.apply, params, "data=2", 2,
                              cases.vit_batch())
    _compare(_ok(group[0], "case_seq"), losses, state_dict_from_jax(p))


def test_pipeline_matches_jax_pipeline_step(group):
    """data=2,pipe=2 (two stages of one block, two microbatches a data
    shard) against the JAX GPipe step on the same mesh."""
    zm, params = _jax_vit()
    losses, p, _ = _jax_steps(
        None, params, "data=2,pipe=2", 4, cases.vit_batch(),
        to_pipe=lambda mesh: zoo_pipeline_forms(zm, mesh))
    r = _ok(group[0], "case_pipe")
    _compare(r["trainer_steps"], losses, state_dict_from_jax(p))
    # build_pipeline_classifier: its own AdamW step over the same mesh,
    # four microbatches a data shard, on one batch: the loss falls
    cl = r["classifier_losses"]
    assert np.isfinite(cl).all() and cl[-1] < cl[0]


@pytest.mark.parametrize("case", ["ring", "pipe"])
def test_staged_transfers_equal_direct_ones(group, case):
    """The ring (seq=4) and the pipeline's three steps (data=2,pipe=2) with
    every point-to-point transfer staged through host buffers, as gloo
    needs for CUDA tensors, bit for bit the same as with direct
    transfers."""
    staged = _ok(group[0], "case_staged")[case]
    direct = _ok(group[0], "case_ring" if case == "ring" else "case_pipe")
    if case == "pipe":
        direct = direct["trainer_steps"]
        assert staged[0] == direct[0]
        staged, direct = staged[1], direct[1]
    assert sorted(staged) == sorted(direct)
    for k, v in direct.items():
        assert torch.equal(staged[k], v), k


@pytest.mark.parametrize("spec", ["data=2,model=2", "data=2,pipe=2"])
def test_full_grads_gathers_the_single_process_gradients(group, spec):
    """``api.full_grads`` after one step on a tensor-parallel and a
    pipeline mesh: every parameter's gradient in the single-process
    layout, equal to the single-process step's."""
    got = _ok(group[0], "case_full_grads")[spec]
    zm = cases._zoo(**cases.VIT)
    zm.model.load_state_dict(group[1]["vit"])
    cases.plain_steps(zm, *cases.vit_batch(), steps=1)
    want = {n: p.grad for n, p in zm.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_vit_data_parallel_augmentation_matches_single_process(group):
    """data=4 with the real train augmentation (crop, flip, AutoAugment,
    cutout on uint8 pictures): each rank draws for the global batch and
    augments its four rows, so the three steps equal the single-process
    steps from the same generator (the JAX package draws from its own
    keys, so the port is its own reference here)."""
    zm = cases._zoo(**cases.VIT)
    zm.model.load_state_dict(group[1]["vit"])
    want = cases.plain_steps(zm, *cases.augment_batch(), augment=True)
    _compare(_ok(group[0], "case_vit")["data=4 augment"], *want)


@pytest.mark.parametrize("arch,size", cases.TP_FAMILIES)
def test_tensor_parallel_families_match_jax(group, arch, size):
    """data=2,model=2 on CaiT (class attention and every MLP on local
    heads and columns, the talking heads replicated with a warning) and
    Swin (window attention and its bias table on local heads) against JAX
    ``shard_train_fns`` on the same mesh, and against the port's
    single-process steps from the same weights."""
    r = _ok(group[0], "case_tp_families")
    zm, params = _jax_family(arch, size)
    losses, p, _ = _jax_steps(zm.model.apply, params, "data=2,model=2", 4,
                              cases.tp_family_batch(size))
    _compare(r[arch], losses, state_dict_from_jax(p))
    port = cases._zoo(arch, [10], size)
    port.model.load_state_dict(group[1][arch])
    _compare(r[arch], *cases.plain_steps(port, *cases.tp_family_batch(size)))
    kept = [w for w in r[arch + " warnings"] if "replicated" in w]
    if arch == "cait_test":
        assert len(kept) == 1 and "talking heads" in kept[0]
    else:
        assert not kept


def test_resnet_sync_batchnorm_matches_jax(group):
    """resnet_test at data=4 in float64: BatchNorm's batch statistics over
    the global batch (each rank holds two images) and the running
    statistics, against the JAX data=4 step."""
    zm, params, stats = _jax_resnet()
    with _x64():
        losses, p, ms = _jax_steps(
            zm.model.apply, params, "data=4", 4, group[1]["resnet_batch"],
            model_state={"batch_stats": stats})
    want = {k: v.double() for k, v in state_dict_from_jax(
        p, batch_stats=jax.tree.map(np.asarray, ms["batch_stats"])).items()}
    # the model runs in float64 on both sides; the cross-entropy stays
    # fp32 on both (steps.py), so its rounding bounds the weights
    _compare(_ok(group[0], "case_resnet"), losses, want, atol=1e-7,
             rtol=1e-6)


def test_checkpoint_resumes_across_meshes(group, tmp_path):
    """A checkpoint saved under data=4 with FSDP is the single-process
    layout; resumed under data=2,pipe=2 and under no mesh, the next epoch
    gives the same weights."""
    r = _ok(group[0], "case_ckpt")
    workdir = group[2]
    import shutil
    shutil.copytree(workdir / "ckpt", tmp_path / "ckpt")
    tr, loaders = cases._ckpt_trainer(None, str(tmp_path), epochs=2,
                                      resume=str(tmp_path / "ckpt"))
    assert tr.start_epoch == r["start_epoch"] == 1
    saved = torch.load(tmp_path / "ckpt" / "0" / "state.pt",
                       weights_only=False)
    assert sorted(saved["optimizer"]["state"]) == r["opt_keys"] == list(
        range(len(list(tr.model.parameters()))))
    tr.fit(loaders)
    assert tr.step == r["step"]
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, err_msg=k)


def test_scan_epochs_on_a_data_mesh_equal_the_single_process_ones(group):
    """``fit_scan`` at data=4 with the real train augmentation (each rank
    gathers its rows of every global batch from the replicated split):
    two epochs' losses and accuracies and the weights after them equal the
    run without a mesh."""
    r = _ok(group[0], "case_scan")
    tr = cases.scan_trainer(None)
    rows = cases.scan_rows(tr.fit_scan(cases.scan_sets(), 8))
    assert tr.step == r["step"] == 6
    np.testing.assert_allclose(r["rows"], rows, rtol=LOSS_RTOL)
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["detr", "frcnn"])
def test_detection_data_parallel_matches_single_process(group, kind):
    """Two steps at data=4 (one picture a rank) against the port's
    unsharded trainer on the same global batches: the flip drawn for the
    global batch, global loss denominators, global BatchNorm statistics
    (Faster R-CNN's ResNet), summed logs."""
    logs, state = _ok(group[0], "case_detection")[kind]
    batches, k = cases.detection_batches()
    want_logs, want_state = cases.detection_run(
        cases.detection_trainers(kind, k), batches)
    for got, want in zip(logs, want_logs):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    for key, w in want_state.items():
        if w.is_floating_point():
            np.testing.assert_allclose(state[key].numpy(), w.numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=key)


def test_detr_data_parallel_matches_jax(group):
    """DETR (host matcher, no augmentation) at data=4, two steps, against
    the JAX trainer on the same data=4 mesh: every logged term of each
    step and every parameter after the last."""
    logs, state = _ok(group[0], "case_detection")["detr_jax"]
    batches, k = cases.detection_batches()
    jmodel, params = _jax_detr(k)
    jtr = JaxDetectionTrainer(
        jmodel, params, image_size=32, num_classes=k, lr=cases.DETR_LR,
        augment=False, mesh=make_mesh("data=4", devices=jax.devices()[:4]))
    want_logs = []
    jtr.train_one_epoch(batches, 0, print_freq=1, warmup=False,
                        log_fn=lambda i, n, l: want_logs.append(l))
    assert len(logs) == len(want_logs) == len(batches)
    for got, want in zip(logs, want_logs):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jtr.params))
    for key, w in want.items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=key)


def test_faster_rcnn_data_parallel_matches_jax(group):
    """Faster R-CNN over resnet_test at data=4 (one picture a rank), one
    step with the flip on, against the JAX trainer on the same data=4 mesh:
    the ranks take the JAX key sequence's draws for the global batch (the
    flip and the RPN and RoI sampling noise, which the JAX step draws
    inside itself), global loss denominators and BatchNorm statistics;
    every logged term and every parameter and running statistic after the
    step."""
    logs, state = _ok(group[0], "case_detection")["frcnn_jax"]
    batches, k = cases.detection_batches()
    jmodel, var = _jax_frcnn(k)
    jtr = JaxFasterRCNNTrainer(
        jmodel, var["params"], cfg=jmodel.config, lr=cases.FRCNN_LR,
        augment=True, mesh=make_mesh("data=4", devices=jax.devices()[:4]))
    jtr.model_state = {"batch_stats": var["batch_stats"]}
    want_logs = []
    jtr.train_one_epoch(batches[:1], 0, print_freq=1, warmup=False,
                        log_fn=lambda i, n, l: want_logs.append(l))
    assert len(logs) == len(want_logs) == 1
    got = {("loss" if k == "loss_total" else k): v
           for k, v in logs[0].items()}
    assert sorted(got) == sorted(want_logs[0])
    for key, w in want_logs[0].items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, jtr.params),
        batch_stats=jax.tree.map(np.asarray,
                                 jtr.model_state["batch_stats"]))
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=key)


def test_cli_mesh_writes_one_stats_file(group):
    """``cli.main --mesh data=2,model=2`` on four ranks: one stats file
    (rank 0's), a single-process checkpoint and a bundle that loads in
    one process."""
    from vit_torch_tpu_torch.checkpoint.ckpt_io import restore_checkpoint
    from vit_torch_tpu_torch.serving.export import load_bundle
    files = _ok(group[0], "case_cli")
    workdir = group[2]
    assert files == ["stats_r0.json"]
    with open(workdir / "stats_r0.json") as f:
        stats = json.load(f)
    assert np.isfinite(stats["train"][0]["loss"])
    state = restore_checkpoint(str(workdir / "cli_ckpt"))
    assert state["model"]["backbone.blocks.0.attn.qkv.weight"].shape == (
        192, 64)
    bundle = load_bundle(str(workdir / "cli_bundle"), device="cpu")
    assert bundle.predict(np.zeros((2, 32, 32, 3), np.uint8)).shape == (2, 10)
