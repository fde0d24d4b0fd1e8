from vit_torch_tpu_torch.data.datasets import resize_images
from vit_torch_tpu_torch.serving.export import (
    DetectionServingModel, ServingModel, export_classifier, export_detector,
    letterbox_images, load_bundle, save_bundle)
from vit_torch_tpu_torch.serving.server import BundleServer, MicroBatcher

__all__ = ["BundleServer", "DetectionServingModel", "MicroBatcher",
           "ServingModel", "export_classifier", "export_detector",
           "letterbox_images", "load_bundle", "resize_images", "save_bundle"]
