"""Pipeline: the data manager and the model together
(counterpart of nerfstudio_thermal_tpu/pipelines/base_pipeline.py).

The train step itself lives in engine/trainer.py. The eval-image metrics
(PSNR, SSIM, LPIPS over whole images) arrive with the eval-surface slice of
the port and raise until then.
"""

from nerfstudio_thermal_torch.data.datamanagers import VanillaDataManager
from nerfstudio_thermal_torch.models.base_model import Model

_EVAL_SLICE = "the eval-image metrics arrive with the eval-surface slice of the port"


class VanillaPipeline:
    def __init__(self, datamanager: VanillaDataManager, model: Model):
        self.datamanager = datamanager
        self.model = model

    def get_eval_image_metrics_and_images(self, step: int):
        raise NotImplementedError(_EVAL_SLICE)

    def get_average_eval_image_metrics(self, step: int):
        raise NotImplementedError(_EVAL_SLICE)
