from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, ViTConfig, VisionTransformer
from vit_torch_tpu_torch.models.zoo import (
    Classifier, VisionModelZoo, ZooModel, arch_family)
