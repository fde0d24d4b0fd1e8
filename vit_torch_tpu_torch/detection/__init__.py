"""Detection, counterpart of ``vit_torch_tpu/detection/``: DETR over a
Swin feature map with the host Hungarian matcher (ROADMAP.md A10a),
Faster R-CNN and Keypoint R-CNN over a ResNet or Swin FPN (A10b), and
COCO bbox and keypoint evaluation.  Masks and panoptic (A10c), and the
device matcher, detection bundles and checkpoints (A10d) are later
slices."""
