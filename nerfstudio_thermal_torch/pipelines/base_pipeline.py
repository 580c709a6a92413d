"""Pipeline: the data manager and the model together
(counterpart of nerfstudio_thermal_tpu/pipelines/base_pipeline.py).

The train step itself lives in engine/trainer.py. This class scores eval
images: it renders the next eval camera through the model's
`render_camera_device` (the kernels of the render path, on the card),
computes PSNR, SSIM and LPIPS on the device the image lives on (RGB
metrics on RGB eval images, thermal ones on thermal images, their single
channel repeated to 3 for LPIPS), and takes only the images for the
writer to the host. `get_average_eval_image_metrics` gives the mean and
standard deviation over the eval set of every key an image has, with the
render throughput of each image.
"""

import time
from typing import Dict, Tuple

import numpy as np
import torch

from nerfstudio_thermal_torch.data.datamanagers import VanillaDataManager
from nerfstudio_thermal_torch.models.base_model import Model
from nerfstudio_thermal_torch.utils.colormaps import apply_depth_colormap
from nerfstudio_thermal_torch.utils.lpips import lpips, lpips_available, lpips_metric_name
from nerfstudio_thermal_torch.utils.math import psnr, ssim


class VanillaPipeline:
    def __init__(self, datamanager: VanillaDataManager, model: Model):
        self.datamanager = datamanager
        self.model = model
        self._eval_render_warmed = False

    def render_eval_camera(self, idx: int) -> Dict[str, torch.Tensor]:
        """Eval camera `idx` rendered on the model's device: {name: [H, W, C]}."""
        cameras = self.datamanager.eval_cameras
        h, w = int(cameras.height[idx]), int(cameras.width[idx])
        outputs = self.model.render_camera_device(cameras, idx)
        return {k: v.reshape(h, w, -1) for k, v in outputs.items()}

    def get_eval_image_metrics_and_images(self, step: int) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
        """Render the next eval image and compute its metrics and images."""
        idx, batch = self.datamanager.next_eval_image(step)
        return self.compute_image_metrics(self.render_eval_camera(idx), batch)

    def compute_image_metrics(self, outputs: Dict[str, torch.Tensor], batch) -> Tuple[Dict[str, float], Dict]:
        """outputs: [H, W, C] tensors on the model's device; batch: the eval
        image ([H, W, C] on the host) and its is_thermal flag."""
        device = outputs["rgb"].device
        gt = torch.as_tensor(np.asarray(batch["image"])[..., :3], device=device)
        is_thermal = float(batch.get("is_thermal", 0.0))
        metrics: Dict[str, float] = {}
        pred_rgb = outputs["rgb"].float()
        pred_t = outputs.get("rgb_thermal")
        if is_thermal < 1:
            metrics["psnr_rgb"] = float(psnr(pred_rgb, gt))
            metrics["ssim_rgb"] = float(ssim(pred_rgb, gt))
            if lpips_available():
                metrics[lpips_metric_name("rgb")] = lpips(pred_rgb, gt)
            gt_img = gt
        elif pred_t is not None:
            pred_t = pred_t.float()
            gt_t = gt[..., :1]
            metrics["psnr_thermal"] = float(psnr(pred_t, gt_t))
            metrics["ssim_thermal"] = float(ssim(pred_t, gt_t))
            if lpips_available():
                # LPIPS needs 3 channels; the reference repeats the one
                metrics[lpips_metric_name("thermal")] = lpips(pred_t.repeat(1, 1, 3), gt_t.repeat(1, 1, 3))
            gt_img = gt_t.repeat(1, 1, 3)
        else:
            gt_img = gt

        # GT | pred RGB | pred thermal, and the depth maps (host side)
        host = {k: v.float().cpu().numpy() for k, v in outputs.items()}
        panels = [gt_img.cpu().numpy(), host["rgb"]]
        if "rgb_thermal" in host:
            panels.append(np.repeat(host["rgb_thermal"], 3, -1))
        images = {"img": np.concatenate(panels, axis=1)}
        depth_panels = [apply_depth_colormap(host["depth"], accumulation=host["accumulation"])]
        if "depth_thermal" in host:
            depth_panels.append(apply_depth_colormap(host["depth_thermal"], accumulation=host["accumulation_thermal"]))
        images["depth"] = np.concatenate(depth_panels, axis=1)
        images["accumulation"] = host["accumulation"]
        metrics["_num_rays"] = float(host["rgb"].shape[0] * host["rgb"].shape[1])
        for k in sorted(host):
            if k.startswith("prop_depth_"):
                images[k] = apply_depth_colormap(host[k], accumulation=host["accumulation"])
        return metrics, images

    def get_average_eval_image_metrics(self, step: int = 0) -> Dict[str, float]:
        """Mean and `_std` over the eval set of every metric an image has,
        and each image's render throughput (num_rays_per_sec, fps; the first
        call renders camera 0 once beforehand, untimed)."""
        n = len(self.datamanager.eval_dataset)
        cuda = self.model.device.type == "cuda"
        if not self._eval_render_warmed:
            self.render_eval_camera(0)
            self._eval_render_warmed = True
        all_metrics = []
        for _ in range(n):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, _ = self.get_eval_image_metrics_and_images(step)
            if cuda:
                torch.cuda.synchronize()
            dt = max(time.perf_counter() - t0, 1e-9)
            m["num_rays_per_sec"] = m.pop("_num_rays") / dt
            m["fps"] = 1.0 / dt
            all_metrics.append(m)
        out = {}
        for k in sorted({k for m in all_metrics for k in m}):
            vals = [m[k] for m in all_metrics if k in m]
            out[k] = float(np.mean(vals))
            out[f"{k}_std"] = float(np.std(vals))
        return out
