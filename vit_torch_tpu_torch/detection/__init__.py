"""Detection, counterpart of ``vit_torch_tpu/detection/``: DETR over a
Swin feature map with the host Hungarian matcher, and COCO bbox
evaluation (ROADMAP.md A10a).  Faster R-CNN and keypoints (A10b), masks
and panoptic (A10c), and the device matcher, detection bundles and
checkpoints (A10d) are later slices."""
