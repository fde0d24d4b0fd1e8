"""Port parity: DETR's device matcher in the trainer and the chunked
(``--scan``) detection epochs, on the CPU.

``DetectionTrainer(matcher="device")`` (the auction on the costs'
device, no host read before the loss) against the JAX trainer with
``matcher="device"`` (``train_step_fused``): three AdamW steps of the
tiny ``swin_test`` DETR of ``tests/test_torch_port_detr.py`` (losses rtol
1e-4, parameters 2e-5, as that file's host-matcher trajectory), and one
``masks=True`` step of ``tests/test_torch_port_segm.py``'s DETRSegm.
``train_one_epoch_scan`` (K = 2 over 5 batches: two chunks and a tail)
against the port's own per-step epoch with warmup off, bit for bit, for
both trainers (the JAX package's ``test_detr_scan_matches_per_step`` and
``test_faster_rcnn_scan_epoch_matches_per_step`` hold the same of its
scan programs); the LR each step trained at with warmup on, against the
JAX ``train_one_epoch_scan`` run on stand-in step programs (its rule at
``engine.py:522-527`` and ``:915-920``, no compile); one read of the
device a chunk; the host matcher refusing the chunked epoch, and
``cli.coco --scan 4`` training per step with it.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_torch_tpu.detection import engine as jax_engine
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.detection import detr, faster_rcnn as pf
from vit_torch_tpu_torch.detection.engine import (DetectionTrainer,
                                                  FasterRCNNTrainer)
from vit_torch_tpu_torch.detection.matcher import auction_assign
from test_torch_port_detr import (SIZE, K, _batches, _jax_model,
                                  _port_model, _seeded_params)
import test_torch_port_segm as segm
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

LR = 1e-3


def _check_trajectory(jlogs, logs, jparams, model, n):
    assert len(logs) == len(jlogs) == n
    for want, got in zip(jlogs, logs):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    got = model.state_dict()
    for k, w in state_dict_from_jax(jax.tree.map(np.asarray,
                                                 jparams)).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)


def test_device_matcher_trajectory_matches_jax():
    """Three device-matcher AdamW steps (epoch 0's warmup ramp, clip 0.1,
    no augmentation) from the same weights and batches: the auction's
    assignments equal on both sides, so the logged terms and the
    parameters agree within fp32 summation order.  The host timers stay
    untouched."""
    cfg, jmodel = _jax_model()
    params = _seeded_params(jmodel, seed=6)
    batches = _batches()
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=SIZE,
                                      num_classes=K, lr=LR, augment=False,
                                      matcher="device")
    jtr._train_step_fused = segm._o0(jtr._train_step_fused)
    model = _port_model(cfg, params)
    tr = DetectionTrainer(model, image_size=SIZE, num_classes=K, lr=LR,
                          augment=False, matcher="device")
    logs = {"jax": [], "port": []}
    jtr.train_one_epoch(batches, 0, print_freq=1,
                        log_fn=lambda i, n, l: logs["jax"].append(l))
    launches = auction_assign.launches
    tr.train_one_epoch(batches, 0, print_freq=1,
                       log_fn=lambda i, n, l: logs["port"].append(l))
    assert tr.host_ms["steps"] == 0 and auction_assign.launches == launches
    _check_trajectory(logs["jax"], logs["port"], jtr.params, model, 3)


def test_device_matcher_masks_step_matches_jax():
    """One ``masks=True`` device-matcher step of DETRSegm: the set and
    mask losses on the last layer's auction assignment, and every
    parameter after the update."""
    _, jmodel = segm._jax_model()
    params = segm._seeded_params(jmodel, seed=18)
    batch = segm._mask_batches(n_steps=1)
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=segm.SIZE,
                                      num_classes=segm.K, lr=LR, masks=True,
                                      augment=False, matcher="device")
    jtr._train_step_fused = segm._o0(jtr._train_step_fused)
    model = segm._port_model(params)
    tr = DetectionTrainer(model, image_size=segm.SIZE, num_classes=segm.K,
                          lr=LR, masks=True, augment=False,
                          matcher="device")
    logs = {"jax": [], "port": []}
    jtr.train_one_epoch(batch, 0, log_fn=lambda i, n, l: logs["jax"].append(l))
    tr.train_one_epoch(batch, 0, log_fn=lambda i, n, l: logs["port"].append(l))
    assert "loss_mask" in logs["port"][0] and "loss_dice" in logs["port"][0]
    _check_trajectory(logs["jax"], logs["port"], jtr.params, model, 1)


# -- the chunked epoch ------------------------------------------------------

FRCNN_CFG = pf.FasterRCNNConfig(num_classes=3, image_size=64, strides=(4, 8),
                                anchor_sizes=(8.0, 16.0), num_proposals=32,
                                rpn_pre_nms_topk=64, rpn_batch=32,
                                roi_batch=16, detections=10)


def _detr_trainer(seed=0):
    model = detr.build_detr(detr.DETRConfig(
        num_classes=K, num_queries=8, hidden_dim=32, num_heads=4,
        enc_layers=1, dec_layers=2, ffn_dim=64), "swin_test", SIZE,
        torch.float32, torch.Generator().manual_seed(seed))
    return DetectionTrainer(model, image_size=SIZE, num_classes=K, lr=LR,
                            augment=True, matcher="device", seed=seed)


def _frcnn_trainer(seed=0):
    model = pf.build_faster_rcnn(FRCNN_CFG, "resnet_test", torch.float32,
                                 torch.Generator().manual_seed(seed))
    return FasterRCNNTrainer(model, cfg=FRCNN_CFG, lr=LR, augment=True,
                             seed=seed)


def _frcnn_batches(n, seed=9, B=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        xy = rng.uniform(0, 40, (B, 4, 2))
        wh = rng.uniform(8, 20, (B, 4, 2))
        out.append({
            "image": rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "labels": rng.integers(1, 4, (B, 4)).astype(np.int32),
            "box_mask": (rng.random((B, 4)) < 0.8).astype(np.float32),
            "mask": np.ones(B, np.float32)})
    return out


TRAINERS = {"detr": (_detr_trainer, lambda: _batches(n_steps=5)),
            "faster_rcnn": (_frcnn_trainer, lambda: _frcnn_batches(5))}


@pytest.mark.parametrize("head", sorted(TRAINERS))
def test_scan_epoch_equals_per_step_epoch(head):
    """With warmup off, K = 2 over 5 batches (two chunks and a tail) is
    the per-step epoch bit for bit: the same steps, draws and updates;
    the logged means equal, ``log_fn`` at steps 2, 4 and 5."""
    make, batches = TRAINERS[head]
    a, b = make(), make()
    means_a = a.train_one_epoch(batches(), 0, warmup=False)
    seen = []
    means_b = b.train_one_epoch_scan(
        batches(), 0, steps_per_dispatch=2, warmup=False,
        log_fn=lambda i, n, l: seen.append((i, n)))
    assert means_a == means_b
    assert seen == [(1, 5), (3, 5), (4, 5)]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _jax_scan_lrs(head, n_batches, K):
    """The LR each step of the JAX ``train_one_epoch_scan`` trains at:
    the trainer's real epoch loop over stand-in step and chunk programs
    that record the optimizer state's LR (nothing is compiled)."""
    lrs = []
    params = {"w": jnp.zeros((2,))}

    def lr_of(opt_state):
        return float(opt_state[1 if head == "detr" else 2].hyperparams[
            "learning_rate"])

    if head == "detr":
        jtr = jax_engine.DetectionTrainer(None, params, image_size=SIZE,
                                          num_classes=K, lr=LR,
                                          matcher="device")

        def step(p, s, batch, rng):
            lrs.append(lr_of(s))
            return p, s, {"loss_total": jnp.float32(1.0)}

        def chunk(p, s, batches, rng):
            n = len(batches["image"])
            lrs.extend([lr_of(s)] * n)
            return p, s, {"loss_total": jnp.ones((n,))}, rng
        jtr._train_step_fused, jtr._train_chunk = step, chunk
    else:
        jtr = jax_engine.FasterRCNNTrainer(None, params, cfg=FRCNN_CFG,
                                           lr=LR)

        def step(p, s, batch, rng, ms):
            lrs.append(lr_of(s))
            return p, s, {"loss": jnp.float32(1.0)}, ms

        def chunk(p, s, batches, rng, ms):
            n = len(batches["image"])
            lrs.extend([lr_of(s)] * n)
            return p, s, {"loss": jnp.ones((n,))}, ms, rng
        jtr._train_step, jtr._train_chunk = step, chunk
    jtr.train_one_epoch_scan(
        [{"image": np.zeros((1, 2))} for _ in range(n_batches)], 0,
        steps_per_dispatch=K)
    return lrs


@pytest.mark.parametrize("head", sorted(TRAINERS))
def test_scan_warmup_sets_the_lr_once_a_chunk(head):
    """Epoch 0's warmup in the chunked epoch: every step of a chunk (and
    of the tail) trains at the LR its last buffered batch set, as the JAX
    loop does; the per-step epoch ramps every step."""
    make, batches = TRAINERS[head]
    tr = make()
    lrs = []
    step = tr.train_step

    def recording(batch):
        lrs.append(tr.optimizer.param_groups[0]["lr"])
        return step(batch)

    tr.train_step = recording
    tr.train_one_epoch_scan(batches(), 0, steps_per_dispatch=2)
    want = _jax_scan_lrs(head, 5, 2)
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    np.testing.assert_allclose(lrs, [LR * f for f in (.4, .4, .8, .8, 1.)],
                               rtol=1e-6)


@pytest.mark.parametrize("head", sorted(TRAINERS))
def test_scan_reads_the_device_once_a_chunk(head, monkeypatch):
    """The logs of a chunk are read with one copy: 5 batches at K = 2 are
    two chunk reads and one for the tail (the per-step epoch reads 5).
    Counted: the package's own ``tolist``/``item`` calls (torch's CPU
    optimizer reads its step counters with ``item``, which on the card
    lie on the host)."""
    make, batches = TRAINERS[head]
    scan, per_step = make(), make()
    reads = []
    for name in ("tolist", "item"):
        orig = getattr(torch.Tensor, name)

        def counted(self, _orig=orig, _name=name):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("vit_torch_tpu_torch"):
                reads.append(_name)
            return _orig(self)
        monkeypatch.setattr(torch.Tensor, name, counted)
    scan.train_one_epoch_scan(batches(), 0, steps_per_dispatch=2)
    assert reads == ["tolist"] * 3
    reads.clear()
    per_step.train_one_epoch(batches(), 0)
    assert reads == ["tolist"] * 5


def test_host_matcher_trains_per_step_under_scan(tmp_path, monkeypatch):
    """The host matcher refuses the chunked epoch (a round trip a step),
    and ``cli.coco --scan 4`` with it trains per step, as the JAX CLI
    does (``cli/coco.py:417-428``)."""
    tr = _detr_trainer()
    tr.matcher = "host"
    with pytest.raises(ValueError, match="matcher='device'"):
        tr.train_one_epoch_scan([], 0)
    calls = []
    monkeypatch.setattr(DetectionTrainer, "train_one_epoch_scan",
                        lambda *a, **k: calls.append("scan"))
    per_step = DetectionTrainer.train_one_epoch
    monkeypatch.setattr(DetectionTrainer, "train_one_epoch",
                        lambda self, *a, **k: (calls.append("step"),
                                               per_step(self, *a, **k))[1])
    record = cli_coco.main(["--test", "--device", "cpu", "--scan", "4",
                            "--epochs", "1", "--no_initial_eval",
                            "--stats_fp", str(tmp_path / "s.json")])
    assert calls == ["step"] and len(record["logs"]) == 1
