"""See the package docstring."""
from reflecting_reality_tpu_torch.pipelines.brushnet_pipeline import (
    StableDiffusionBrushNetPipeline,
)
from reflecting_reality_tpu_torch.pipelines.brushnet_sdxl_pipeline import (
    StableDiffusionXLBrushNetPipeline,
)
from reflecting_reality_tpu_torch.pipelines.image_processor import ImageProcessor

__all__ = [
    "ImageProcessor", "StableDiffusionBrushNetPipeline",
    "StableDiffusionXLBrushNetPipeline",
]
