"""Detection, counterpart of ``vit_torch_tpu/detection/``: DETR over a
Swin feature map with the host Hungarian matcher (ROADMAP.md A10a),
Faster R-CNN and Keypoint R-CNN over a ResNet or Swin FPN (A10b),
DETRSegm's instance masks and the panoptic-PNG dataset (A10c), and COCO
bbox, segm and keypoint evaluation with panoptic quality.  The device
matcher, detection bundles and checkpoints (A10d) are a later slice."""
