"""Detection, counterpart of ``vit_torch_tpu/detection/``: DETR over a
Swin feature map with the host Hungarian matcher (ROADMAP.md A10a),
Faster R-CNN and Keypoint R-CNN over a ResNet or Swin FPN (A10b),
DETRSegm's instance masks and the panoptic-PNG dataset (A10c), DETR's
device auction matcher, chunked epochs and detection checkpoints (A10d),
and COCO bbox, segm and keypoint evaluation with panoptic quality."""
