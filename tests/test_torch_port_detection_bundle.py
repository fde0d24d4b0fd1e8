"""Port parity: detection serving bundles, their HTTP server, and the
detection CLI's checkpoints, resume and export, on the CPU.

``letterbox_images`` bit for bit against the JAX one (five sizes and a
grayscale picture); ``_format_prediction`` equal to the JAX server's on
the same raw outputs (threshold, ``top_k``, keypoints, packed masks);
a DETR, a DETRSegm and a Keypoint R-CNN bundle exported from weights the
JAX models carry, loaded and run through ``predict_tree`` against the
JAX trainer's ``_predict_vars`` on the same letterboxed batch (scores and
boxes within 1e-4 of their largest value, fp32 summation order; the mask
bits equal on at least 99.9% of the pixels, since a mask logit within
rounding of 0 may flip), with a bucket's padding and an oversize batch's
chunks; a W8A8 bundle's manifest and int8 weights; ``BundleServer`` over
HTTP; the JAX package's own detection bundles refused; ``cli.coco --test
--device cpu --matcher device --scan 2`` with ``--ckpt_dir``, then
``--resume`` with ``--export_bundle`` (the resumed run trains epoch 1
only, on the state saved after epoch 0, restored bit for bit), and the
bundle through ``cli.serve``.
"""

import base64
import copy
import http.client
import io
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vit_torch_tpu.detection import engine as jax_engine
from vit_torch_tpu.serving.export import letterbox_images as jax_letterbox
from vit_torch_tpu.serving.server import _format_prediction as jax_format
from vit_torch_tpu_torch.cli import coco as cli_coco
from vit_torch_tpu_torch.cli import serve as cli_serve
from vit_torch_tpu_torch.detection.engine import (DetectionTrainer,
                                                  FasterRCNNTrainer)
from vit_torch_tpu_torch.serving import (BundleServer, export_detector,
                                         letterbox_images, load_bundle,
                                         save_bundle)
from vit_torch_tpu_torch.serving.export import (DETECTION_FORMAT,
                                                DetectionServingModel)
from vit_torch_tpu_torch.serving.server import _format_prediction
import test_torch_port_detr as detr_t
import test_torch_port_faster_rcnn as frcnn_t
import test_torch_port_segm as segm_t
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

# fp32 predictions of a few layers: max |port - JAX| relative to max |JAX|
PRED_RTOL = 1e-4
MASK_AGREE = 0.999


def _pictures(seed, shapes=((40, 30), (17, 64), (64, 64), (25, 9),
                            (80, 120))):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


@pytest.mark.parametrize("size", [32, 64])
def test_letterbox_images_matches_jax(size):
    pics = _pictures(0) + [np.random.default_rng(1).integers(
        0, 256, (30, 50), dtype=np.uint8)]               # grayscale
    got, want = letterbox_images(pics, size), jax_letterbox(pics, size)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("thr,top_k", [(0.5, None), (0.0, 3), (0.9, 1),
                                       (0.3, 0)])
def test_format_prediction_matches_jax(thr, top_k):
    rng = np.random.default_rng(5)
    D = 8
    raw = {"scores": rng.random(D).astype(np.float32),
           "labels": rng.integers(1, 5, D),
           "boxes": rng.uniform(0, 64, (D, 4)).astype(np.float32),
           "keypoints": rng.uniform(0, 64, (D, 5, 3)).astype(np.float32),
           "masks_packed": rng.integers(0, 256, (D, 32, 4), dtype=np.uint8)}
    raw["scores"][3] = raw["scores"][5]                  # a tie
    server = types.SimpleNamespace(is_detection=True, image_size=32)
    assert _format_prediction(server, raw, thr, top_k) == jax_format(
        server, raw, thr, top_k)
    server.is_detection = False
    logits = {"logits": rng.standard_normal(10).astype(np.float32)}
    assert _format_prediction(server, logits, thr, top_k) == jax_format(
        server, logits, thr, top_k)


def _jax_predict(jtr, variables, batch):
    fn = segm_t._jit(lambda v, b: jtr._predict_vars(v, b))
    return jax.tree.map(np.asarray, fn(variables, {
        k: batch[k] for k in ("image", "scale", "pad")}))


def _check_predictions(got, want, masks=False, keypoints=False):
    assert sorted(got) == sorted(want)
    for k in ("scores", "boxes"):
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err < PRED_RTOL, (k, err)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    if keypoints:
        # a keypoint is its heatmap's argmax cell refined by the 3 x 3
        # neighbours' probabilities; at seeded weights the maps are near
        # uniform (each cell's probability near 1 / HM^2), so a logit
        # within rounding of the maximum can move the argmax anywhere in
        # its box: x, y are held within 1e-4 of their largest value on
        # 99% of the keypoints and inside their box on all of them; the
        # scores within 1e-4
        kp, wkp = got["keypoints"], want["keypoints"]
        tol = PRED_RTOL * np.abs(wkp[..., :2]).max()
        close = (np.abs(kp[..., :2] - wkp[..., :2]) <= tol).all(-1)
        assert close.mean() >= 0.99, close.mean()
        lo, hi = want["boxes"][..., None, :2], want["boxes"][..., None, 2:]
        assert ((kp[..., :2] >= lo - tol) & (kp[..., :2] <= hi + tol)).all()
        err = np.abs(kp[..., 2] - wkp[..., 2]).max() / np.abs(
            wkp[..., 2]).max()
        assert err < PRED_RTOL, err
    if masks:
        agree = (np.unpackbits(got["masks_packed"])
                 == np.unpackbits(want["masks_packed"])).mean()
        assert agree >= MASK_AGREE, agree


def _serve(tr, tmp_path, size, buckets=(2, 4)):
    bundle = str(tmp_path / "bundle")
    exported = export_detector(tr, image_size=size, batch_sizes=buckets)
    save_bundle(bundle, exported)
    served = load_bundle(bundle, device="cpu")
    assert isinstance(served, DetectionServingModel)
    assert served.batch_sizes == tuple(buckets)
    return bundle, exported, served


def _detr_pair():
    cfg, jmodel = detr_t._jax_model()
    params = detr_t._seeded_params(jmodel, seed=21)
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=detr_t.SIZE,
                                      num_classes=detr_t.K)
    tr = DetectionTrainer(detr_t._port_model(cfg, params),
                          image_size=detr_t.SIZE, num_classes=detr_t.K)
    return jtr, {"params": params}, tr


def test_detr_bundle_matches_jax_predict(tmp_path):
    """Five pictures through buckets (2, 4): a chunk of 4, then one
    picture padded to 2; the served outputs against the JAX predict of
    the same batch, the manifest's outputs against a bucket-1 predict."""
    jtr, variables, tr = _detr_pair()
    _, exported, served = _serve(tr, tmp_path, detr_t.SIZE)
    man = exported["manifest"]
    assert man["format"] == DETECTION_FORMAT and man["head"] == "detr"
    assert man["backbone"] == "swin_test" and not man["masks"]
    assert {o["name"] for o in man["outputs"]} == {"scores", "labels",
                                                   "boxes"}
    batch = letterbox_images(_pictures(2), detr_t.SIZE)
    got = served.predict_tree(batch)
    assert got["scores"].shape == (5, detr_t.Q)
    _check_predictions(got, _jax_predict(jtr, variables, batch))
    # the trainer's own predict gives the same numbers
    np.testing.assert_array_equal(
        tr.predict({k: v[:4] for k, v in batch.items()})["scores"].numpy(),
        got["scores"][:4])
    with pytest.raises(ValueError, match="uint8"):
        served.predict_tree({**batch, "image": batch["image"] / 255.0})
    with pytest.raises(ValueError, match="letterbox_images"):
        served.predict_tree(letterbox_images(_pictures(2), 16))


def test_detr_segm_bundle_matches_jax_predict(tmp_path):
    _, jmodel = segm_t._jax_model()
    params = segm_t._seeded_params(jmodel, seed=22)
    jtr = jax_engine.DetectionTrainer(jmodel, params, image_size=segm_t.SIZE,
                                      num_classes=segm_t.K, masks=True)
    tr = DetectionTrainer(segm_t._port_model(params), image_size=segm_t.SIZE,
                          num_classes=segm_t.K, masks=True)
    _, exported, served = _serve(tr, tmp_path, segm_t.SIZE, buckets=(4,))
    man = exported["manifest"]
    assert man["masks"] and man["num_mask_heads"] == segm_t.HEADS
    batch = letterbox_images(_pictures(3)[:3], segm_t.SIZE)
    got = served.predict_tree(batch)
    assert got["masks_packed"].shape == (3, segm_t.Q, segm_t.SIZE,
                                         segm_t.SIZE // 8)
    _check_predictions(got, _jax_predict(jtr, {"params": params}, batch),
                       masks=True)


def test_keypoint_rcnn_bundle_matches_jax_predict(tmp_path):
    jm = frcnn_t._jax_model()
    var = frcnn_t._seeded(jm, seed=23)
    jtr = jax_engine.FasterRCNNTrainer(jm, var["params"], cfg=frcnn_t.KP_CFG)
    model = frcnn_t._port(frcnn_t.KP_CFG, var)
    tr = FasterRCNNTrainer(model, cfg=model.config)
    _, exported, served = _serve(tr, tmp_path, frcnn_t.SIZE, buckets=(1, 4))
    man = exported["manifest"]
    assert man["head"] == "faster_rcnn" and man["backbone"] == "resnet_test"
    assert man["config"]["num_keypoints"] == frcnn_t.KP
    batch = letterbox_images(_pictures(4), frcnn_t.SIZE)
    got = served.predict_tree(batch)
    assert got["keypoints"].shape == (5, frcnn_t.KP_CFG.detections,
                                      frcnn_t.KP, 3)
    _check_predictions(got, _jax_predict(jtr, var, batch), keypoints=True)


def test_w8a8_bundle_stores_int8_weights(tmp_path, monkeypatch):
    """Under ``VITX_W8A8=1`` the QLinear weights go in as int8 rows and
    fp32 scales, the manifest says so, and the loaded bundle serves
    through the int8 path whatever the server's environment."""
    _, _, tr = _detr_pair()
    monkeypatch.setenv("VITX_W8A8", "1")
    bundle, exported, _ = _serve(tr, tmp_path, detr_t.SIZE)
    man, state = exported["manifest"], exported["state_dict"]
    assert man["w8a8"] and man["w8a8_prequant"]
    q = [k for k in state if k.endswith(".weight_q")]
    assert q and all(state[k].dtype == torch.int8 for k in q)
    assert all(k[:-len("_q")] not in state for k in q)   # no fp32 weight
    assert any(k.startswith(("encoder.", "decoder.")) for k in q)
    monkeypatch.delenv("VITX_W8A8")
    served = load_bundle(bundle, device="cpu")
    out = served.predict_tree(letterbox_images(_pictures(6)[:2],
                                               detr_t.SIZE))
    assert np.isfinite(out["scores"]).all()


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_bundle_server_over_http(tmp_path):
    """200 with the JAX reply schema, in score order above the
    threshold; 400 on a bad ``score_threshold``; ``/healthz`` with the
    manifest."""
    _, _, tr = _detr_pair()
    bundle, _, served = _serve(tr, tmp_path, detr_t.SIZE)
    server = BundleServer(bundle, port=0, max_wait_ms=20, device="cpu")
    server.start()
    try:
        addr = server.address
        status, health = _request(addr, "GET", "/healthz")
        assert status == 200 and health["manifest"]["head"] == "detr"
        pics = _pictures(7)[:2]
        status, body = _request(addr, "POST", "/v1/predict", {
            "images": [_png_b64(p) for p in pics], "score_threshold": 0.0,
            "top_k": 5})
        assert status == 200
        want = served.predict_tree(letterbox_images(pics, detr_t.SIZE))
        for i, pred in enumerate(body["predictions"]):
            assert sorted(pred) == ["boxes", "labels", "scores"]
            assert len(pred["scores"]) == 5
            assert pred["scores"] == sorted(pred["scores"], reverse=True)
            np.testing.assert_allclose(
                pred["scores"], np.sort(want["scores"][i])[::-1][:5],
                rtol=1e-6)
        status, _ = _request(addr, "POST", "/v1/predict", {
            "images": [_png_b64(pics[0])], "score_threshold": "high"})
        assert status == 400
        assert _request(addr, "GET", "/stats")[1]["errors"] == 1
    finally:
        server.shutdown()


def test_cli_checkpoint_resume_export_and_serve(tmp_path, monkeypatch,
                                                capsys):
    """``cli.coco --test --device cpu --matcher device --scan 2
    --ckpt_dir C`` for one epoch, then ``--resume C --epochs 2
    --export_bundle B``: the resumed run skips the initial evaluation,
    logs epoch 1 only, and starts from the state saved after epoch 0 (the
    model, optimizer and generator restored bit for bit); ``cli.serve``
    loads the bundle and names its kind."""
    ckpt, bundle = str(tmp_path / "ckpt"), str(tmp_path / "bundle")
    base = ["--test", "--device", "cpu", "--matcher", "device", "--scan",
            "2"]
    first = cli_coco.main(base + ["--epochs", "1", "--ckpt_dir", ckpt,
                                  "--stats_fp", str(tmp_path / "a.json")])
    assert [r["epoch"] for r in first["logs"]] == [0] and "initial" in first
    saved = torch.load(f"{ckpt}/0/state.pt", weights_only=True)
    restored = {}
    load = DetectionTrainer.load_checkpoint_state

    def spy(self, state):
        load(self, state)
        # a copy: the state dicts hold the live tensors, which train on
        restored.update(copy.deepcopy(self.checkpoint_state(state["epoch"])))
    monkeypatch.setattr(DetectionTrainer, "load_checkpoint_state", spy)
    second = cli_coco.main(base + ["--epochs", "2", "--resume", ckpt,
                                   "--ckpt_dir", ckpt, "--export_bundle",
                                   bundle, "--stats_fp",
                                   str(tmp_path / "b.json")])
    assert [r["epoch"] for r in second["logs"]] == [1]
    assert "initial" not in second and second["resumed"]["epoch"] == 1
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert torch.equal(restored["generator"], saved["generator"])
    got_opt, want_opt = restored["optimizer"], saved["optimizer"]
    assert got_opt["param_groups"] == want_opt["param_groups"]
    for i, st in want_opt["state"].items():
        for k, v in st.items():
            assert torch.equal(got_opt["state"][i][k], v), (i, k)
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [0, 1]
    assert second["export_bundle"]["format"] == DETECTION_FORMAT
    def interrupted(self):
        raise KeyboardInterrupt      # cli.serve then shuts the server down
    monkeypatch.setattr(BundleServer, "serve_forever", interrupted)
    capsys.readouterr()
    cli_serve.main(["--bundle", bundle, "--port", "0", "--device", "cpu"])
    assert "serving detector bundle" in capsys.readouterr().out
