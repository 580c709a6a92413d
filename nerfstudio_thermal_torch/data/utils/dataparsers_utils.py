"""Train/eval split helpers, including the RGB/thermal-paired split
(counterpart of nerfstudio_thermal_tpu/data/utils/dataparsers_utils.py, a
copy: the port imports nothing of the JAX package). When filenames contain
`images_thermal`, the RGB and thermal splits are paired index for index
(RGB block first, then the thermal block).
"""

import math
from typing import List, Tuple

import numpy as np


def get_train_eval_split_fraction(
    image_filenames: List, train_split_fraction: float
) -> Tuple[np.ndarray, np.ndarray]:
    num_images_total = len(image_filenames)
    num_images = num_images_total

    num_thermal = sum("images_thermal" in str(f) for f in image_filenames)
    num_rgb = num_images - num_thermal
    is_thermal_dataset = num_thermal > 0
    if is_thermal_dataset:
        num_images = min(num_rgb, num_thermal)

    num_train_images = math.ceil(num_images * train_split_fraction)
    i_all = np.arange(num_images)
    i_train = np.linspace(0, num_images - 1, num_train_images, dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)

    if is_thermal_dataset:
        num_remaining = max(num_rgb, num_thermal) - num_images
        num_train_remaining = math.ceil(num_remaining * train_split_fraction)
        i_all_remaining = np.arange(num_remaining)
        i_train_remaining = np.linspace(0, num_remaining - 1, num_train_remaining, dtype=int)
        i_eval_remaining = np.setdiff1d(i_all_remaining, i_train_remaining)
        i_train_remaining = i_train_remaining + num_images
        i_eval_remaining = i_eval_remaining + num_images

        if num_images == num_rgb:
            i_train = np.concatenate((i_train, i_train + num_rgb, i_train_remaining + num_rgb))
            i_eval = np.concatenate((i_eval, i_eval + num_rgb, i_eval_remaining + num_rgb))
        else:
            i_train = np.concatenate((i_train, i_train_remaining, i_train + num_rgb))
            i_eval = np.concatenate((i_eval, i_eval_remaining, i_eval + num_rgb))

    assert num_images_total == len(i_train) + len(i_eval)
    assert len(np.intersect1d(i_train, i_eval)) == 0
    return i_train, i_eval


def get_train_eval_split_interval(image_filenames: List, eval_interval: int):
    """Every `eval_interval`-th image is eval (reference :96-112)."""
    num_images = len(image_filenames)
    all_indices = np.arange(num_images)
    i_eval = all_indices[all_indices % eval_interval == 0]
    i_train = np.setdiff1d(all_indices, i_eval)
    return i_train, i_eval


def get_train_eval_split_all(image_filenames: List):
    """Train == eval == all images (reference :115-126)."""
    idx = np.arange(len(image_filenames))
    return idx, idx


def get_train_eval_split_filename(image_filenames: List):
    """Split by 'train'/'eval'/'test'/'val' substrings in filenames
    (reference :77-93)."""
    num_images = len(image_filenames)
    basenames = [str(f) for f in image_filenames]
    i_train = []
    i_eval = []
    for idx, basename in enumerate(basenames):
        if "train" in basename:
            i_train.append(idx)
        elif any(t in basename for t in ("eval", "test", "val")):
            i_eval.append(idx)
        else:
            raise ValueError("frame should contain train/eval/test/val in its name")
    return np.array(i_train), np.array(i_eval)
