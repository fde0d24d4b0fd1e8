"""Port parity: DETR, its losses, the trainer and the COCO CLI against the
JAX package, on the CPU.

A tiny DETR (``swin_test`` backbone at 32 px, hidden 32, 4 heads, 1
encoder and 2 decoder layers, FFN 64, 8 queries, as
``tests/test_detection.py`` builds it) with seeded numpy weights carried
into the port by ``state_dict_from_jax``: logits and boxes of every
decoder layer for sine and learned position embeddings, post-norm and
pre-norm; ``detr_losses`` and the gradients of every parameter under one
assignment; three host-matcher AdamW steps of the trainer without
augmentation against the JAX trainer's losses and parameters;
``postprocess``; the W8A8 forward under ``VITX_W8A8=1``; ``cli.coco
--test --device cpu`` writing the stats JSON that
``test_coco_smoke_end_to_end`` reads; the CLI's refusal of ``--mesh``
(A8); the detection meters.  Everything runs in fp32; each JAX function is traced once.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection import detr as jax_detr
from vit_torch_tpu.detection.engine import (
    DetectionTrainer as JaxDetectionTrainer)
from vit_torch_tpu.models.swin import SWIN_CONFIGS as JAX_SWIN_CONFIGS
from vit_torch_tpu.models.swin import SwinTransformer as JaxSwin
from vit_torch_tpu.utils import stats as jax_stats
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.detection import detr
from vit_torch_tpu_torch.detection.engine import (DetectionTrainer,
                                                  clip_grad_global_norm,
                                                  prep_targets)
from vit_torch_tpu_torch.utils import stats
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

SIZE, K, Q = 32, 3, 8
CFG = dict(num_classes=K, num_queries=Q, hidden_dim=32, num_heads=4,
           enc_layers=1, dec_layers=2, ffn_dim=64)
# fp32 forward of a few layers of values of order 1: summation order
FWD_ATOL = 2e-5
# gradients relative to the largest |grad| of each parameter, or to a
# thousandth of the model's largest where a gradient is zero in exact
# arithmetic (the key bias: softmax ignores a shift shared by all keys)
# and reads as rounding noise
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
# W8A8: both sides round the same fp32 values to int8 codes; a code one
# step apart (the JAX scale's fused multiply-add, see
# tests/test_torch_port_quant.py) moves a logit by about 1e-2 of its
# range, on at most a few of the 2 x 8 x 4 logits
W8A8_ATOL = 5e-2
W8A8_MEDIAN_ATOL = 1e-3


def _jax_model(**kw):
    cfg = jax_detr.DETRConfig(**{**CFG, **kw})
    backbone = JaxSwin(JAX_SWIN_CONFIGS["swin_test"], dtype=jnp.float32,
                       features_only=True, name="backbone")
    return cfg, jax_detr.DETR(cfg, backbone, dtype=jnp.float32)


def _seeded_params(jmodel, seed=0):
    """A parameter tree of the JAX model's shapes (``jax.eval_shape``, no
    init compile) from numpy: matrices N(0, 1/fan_in), LayerNorm scales
    1 + N(0, 0.1), biases and tables N(0, 0.1), the queries N(0, 1)."""
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), True))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "query_embed" in name:
            return rng.standard_normal(s.shape).astype(np.float32)
        if "kernel" in name and len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_model(cfg, params):
    model = detr.build_detr(
        detr.DETRConfig(**dataclasses.asdict(cfg)), "swin_test", SIZE,
        torch.float32)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _images(n=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("position,pre_norm", [
    ("sine", False), ("sine", True), ("learned", False), ("learned", True)])
def test_detr_forward_matches_jax(position, pre_norm):
    cfg, jmodel = _jax_model(position_embedding=position, pre_norm=pre_norm)
    params = _seeded_params(jmodel)
    x = _images()
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, True))(
        params, jnp.asarray(x))
    model = _port_model(cfg, params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got["pred_logits"].shape == (2, Q, K + 1)
    assert len(got["aux_outputs"]) == CFG["dec_layers"] - 1
    for g, w in zip(got["aux_outputs"] + [got],
                    list(want["aux_outputs"]) + [want]):
        for k in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=FWD_ATOL, rtol=0, err_msg=k)


def test_sine_embedding_matches_jax():
    want = np.asarray(jax_detr.sine_position_embedding(5, 7, 32))
    got = detr.sine_position_embedding(5, 7, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _targets(B, seed=2, n=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (B, n, 2))
    wh = rng.uniform(0.1, 0.4, (B, n, 2))
    cxcywh = np.concatenate([xy + wh / 2, wh], -1).astype(np.float32)
    labels = rng.integers(1, K + 1, (B, n)).astype(np.int32)
    box_mask = np.asarray([[1, 1, 0, 1], [0, 1, 0, 0]], np.float32)[:B]
    return {"labels": labels, "boxes_cxcywh": cxcywh, "box_mask": box_mask,
            "mask": np.ones((B,), np.float32)}


def test_detr_losses_and_gradients_match_jax():
    """Every loss term and the gradient of every parameter of the summed
    set losses of both decoder layers, under one fixed assignment (a
    non-prefix gt slot, an unmatched image row, a padded sample)."""
    cfg, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=3)
    x = _images(seed=4)
    tg = _targets(2)
    tg["mask"] = np.asarray([1.0, 0.0], np.float32)
    assign = np.full((2, 2, Q), -1, np.int32)
    assign[:, 0, [1, 4, 6]] = [3, 0, 1]
    assign[:, 1, [0, 2]] = [1, -1]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, x, True)
        layers = out["aux_outputs"] + [out]
        terms = [jax_detr.detr_losses(o, tg, assign[li], K)
                 for li, o in enumerate(layers)]
        return sum(t["loss"] for t in terms), terms[-1]

    (jloss, jterms), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model = _port_model(cfg, params).eval()
    out = model(torch.from_numpy(x))
    layers = out["aux_outputs"] + [out]
    ttg = {k: torch.from_numpy(v) for k, v in tg.items()}
    terms = [detr.detr_losses(o, ttg, torch.from_numpy(assign[li]), K)
             for li, o in enumerate(layers)]
    loss = sum(t["loss"] for t in terms)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in terms[-1].items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    floor = GRAD_FLOOR * max(v.abs().max().item() for v in want.values())
    for n, g in grads.items():
        w = want[n].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_RTOL * max(np.abs(w).max(), floor), err_msg=n)


def _batches(n_steps=3, B=2, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        xy = rng.uniform(0, 20, (B, 4, 2))
        wh = rng.uniform(4, 12, (B, 4, 2))
        out.append({
            "image": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(
                np.uint8),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "labels": rng.integers(1, K + 1, (B, 4)).astype(np.int32),
            "box_mask": (rng.random((B, 4)) < 0.7).astype(np.float32),
            "mask": np.asarray([1.0, float(i < 2)], np.float32)})
    return out


def test_trainer_trajectory_matches_jax():
    """Three host-matcher AdamW steps (epoch 0's warmup ramp, clipping at
    0.1, no augmentation) from the same weights and batches: the logged
    terms of every step and every parameter after the last, within fp32
    summation order."""
    lr = 1e-3
    cfg, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=6)
    batches = _batches()
    jtr = JaxDetectionTrainer(jmodel, params, image_size=SIZE,
                              num_classes=K, lr=lr, augment=False)
    model = _port_model(cfg, params)
    tr = DetectionTrainer(model, image_size=SIZE, num_classes=K, lr=lr,
                          augment=False)
    logs = {"jax": [], "port": []}
    jtr.train_one_epoch(batches, 0, print_freq=1,
                        log_fn=lambda i, n, l: logs["jax"].append(l))
    tr.train_one_epoch(batches, 0, print_freq=1,
                       log_fn=lambda i, n, l: logs["port"].append(l))
    assert len(logs["port"]) == 3 and tr.host_ms["steps"] == 3
    for want, got in zip(logs["jax"], logs["port"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(lr)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jtr.params))
    got = model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)


def test_sgd_and_clip_follow_optax():
    """``--opt sgd`` is momentum SGD with coupled weight decay and no clip;
    the AdamW clip scales by ``max_norm / norm`` only above the norm."""
    p = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    p.grad = torch.tensor([3.0, 4.0])
    norm = clip_grad_global_norm([p], 0.1)
    assert norm.item() == pytest.approx(5.0)
    np.testing.assert_allclose(p.grad.numpy(), [0.06, 0.08], rtol=1e-6)
    p.grad = torch.tensor([0.03, 0.04])
    clip_grad_global_norm([p], 0.1)
    np.testing.assert_array_equal(p.grad.numpy(),
                                  np.float32([0.03, 0.04]))
    cfg, jmodel = _jax_model()
    model = _port_model(cfg, _seeded_params(jmodel))
    tr = DetectionTrainer(model, image_size=SIZE, num_classes=K, lr=0.5,
                          opt="sgd", weight_decay=0.1)
    assert tr.grad_clip is None
    group = tr.optimizer.param_groups[0]
    assert (type(tr.optimizer).__name__, group["momentum"],
            group["weight_decay"]) == ("SGD", 0.9, 0.1)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(7)
    out = {"pred_logits": rng.standard_normal((2, Q, K + 1)).astype(
        np.float32),
        "pred_boxes": rng.uniform(0.1, 0.9, (2, Q, 4)).astype(np.float32)}
    scale = np.asarray([0.5, 2.0], np.float32)
    pad = np.asarray([[0.0, 8.0], [3.0, 0.0]], np.float32)
    want = jax_detr.postprocess({k: jnp.asarray(v) for k, v in out.items()},
                                64, jnp.asarray(scale), jnp.asarray(pad))
    got = detr.postprocess({k: torch.from_numpy(v) for k, v in out.items()},
                           64, torch.from_numpy(scale), torch.from_numpy(pad))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-6, err_msg=k)


def test_w8a8_forward_matches_jax(monkeypatch):
    """Under ``VITX_W8A8=1`` both packages run the eval forward's
    q/k/v/out, FFN and input projections (and the Swin MLPs) through int8;
    training mode never quantises."""
    cfg, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=8)
    x = _images(seed=9)
    model = _port_model(cfg, params).eval()
    with torch.no_grad():
        fp = model(torch.from_numpy(x))["pred_logits"]
    monkeypatch.setenv("VITX_W8A8", "1")
    want = np.asarray(jax.jit(
        lambda p, x: jmodel.apply({"params": p}, x, True))(
        params, jnp.asarray(x))["pred_logits"])
    assert all(m.quantized() for m in (model.input_proj,
                                       model.decoder[0].cross_attn.q,
                                       model.encoder[0].linear2))
    with torch.no_grad():
        got = model(torch.from_numpy(x))["pred_logits"].numpy()
    diff = np.abs(got - want)
    assert diff.max() <= W8A8_ATOL and np.median(diff) <= W8A8_MEDIAN_ATOL
    assert np.abs(got - fp.numpy()).max() > 0          # int8 did run
    assert not model.train().input_proj.quantized()


def test_cli_test_mode_writes_the_stats_json(tmp_path):
    """``--test --device cpu --epochs 1``: what
    ``tests/test_detection.py::test_coco_smoke_end_to_end`` checks of the
    JAX CLI, plus the initial eval and the run's settings."""
    fp = str(tmp_path / "stats.json")
    record = cli_coco.main(["--test", "--device", "cpu", "--epochs", "1",
                            "--stats_fp", fp])
    assert record["telem"]["completed"] is True
    d = json.load(open(fp))
    assert len(d["logs"]) == 1
    assert "ap" in d["logs"][0]["val"]["bbox"]
    assert set(d["logs"][0]["val"]["bbox"]) == set(
        stats_keys := d["initial"]["bbox"]) and len(stats_keys) == 12
    assert np.isfinite(d["logs"][0]["train"]["loss_total"])
    assert (d["info"]["backbone"], d["info"]["hidden_dim"],
            d["info"]["image_size"]) == ("swin_test", 64, 64)
    assert d["telem"]["hardware"] == "1xcpu"


# --mesh was refused until the parallelism slice landed; a mesh with any
# axis but data is refused before any work, with the JAX CLI's message
@pytest.mark.parametrize("argv,item", [
    pytest.param(["--mesh", "data=2,model=2"], "data-parallel meshes only",
                 id="argv0-A8")])
def test_cli_refuses_later_slices_before_any_work(argv, item, tmp_path,
                                                  monkeypatch):
    from vit_torch_tpu_torch.detection import coco_data
    monkeypatch.setattr(coco_data, "make_synthetic_coco", None)
    fp = tmp_path / "s.json"
    with pytest.raises(SystemExit, match=item):
        cli_coco.main(["--test", "--device", "cpu", "--stats_fp", str(fp)]
                      + argv)
    assert not fp.exists()


def test_cli_dtype_on_the_card():
    """bfloat16 is the CUDA default; float32 on CUDA raises; the CPU
    defaults to float32."""
    args = cli_coco.get_args_parser().parse_args([])
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert cli_coco._dtype(args, cuda) == torch.bfloat16
    assert cli_coco._dtype(args, cpu) == torch.float32
    args.dtype = "float32"
    with pytest.raises(ValueError, match="bfloat16"):
        cli_coco._dtype(args, cuda)
    assert cli_coco.get_args_parser().get_default("device") == "cuda"


def test_detection_meters_match_jax():
    values = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]
    meters = []
    for mod in (jax_stats, stats):
        m = mod.SmoothedValue(window_size=4)
        for v in values:
            m.update(v, n=2)
        logger = mod.MetricLogger()
        for v in values:
            logger.update(loss=v, ce=v / 2)
        meters.append((m.median, m.avg, m.global_avg, m.value, str(m),
                       str(logger), logger.loss.global_avg))
    assert meters[1] == meters[0]
    seen = list(stats.MetricLogger().log_every(range(3), 2, "h"))
    assert seen == [0, 1, 2]


def test_prep_targets_normalises_to_cxcywh():
    boxes = torch.tensor([[[8.0, 16.0, 24.0, 32.0]]])
    t = prep_targets(torch.ones((1, 1), dtype=torch.long), boxes,
                     torch.ones((1, 1)), torch.ones((1,)), 32)
    np.testing.assert_allclose(t["boxes_cxcywh"].numpy(),
                               [[[0.5, 0.75, 0.5, 0.5]]])
