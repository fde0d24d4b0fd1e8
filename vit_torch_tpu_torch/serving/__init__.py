from vit_torch_tpu_torch.data.datasets import resize_images
from vit_torch_tpu_torch.serving.export import (
    ServingModel, export_classifier, load_bundle, save_bundle)
from vit_torch_tpu_torch.serving.server import BundleServer, MicroBatcher

__all__ = ["BundleServer", "MicroBatcher", "ServingModel",
           "export_classifier", "load_bundle", "resize_images", "save_bundle"]
