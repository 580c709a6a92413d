"""Common colors, including the fork's RGBT variants
(counterpart of nerfstudio_thermal_tpu/utils/colors.py, copied: it imports
no JAX).

Behavioral spec: reference `nerfstudio/utils/colors.py:22-60` (RGB constants
+ RGBT constants with thermal channel 0).
"""

import numpy as np

WHITE = np.array([1.0, 1.0, 1.0], np.float32)
BLACK = np.array([0.0, 0.0, 0.0], np.float32)
RED = np.array([1.0, 0.0, 0.0], np.float32)
GREEN = np.array([0.0, 1.0, 0.0], np.float32)
BLUE = np.array([0.0, 0.0, 1.0], np.float32)

COLORS_DICT = {
    "white": WHITE, "black": BLACK, "red": RED, "green": GREEN, "blue": BLUE,
}

WHITE_RGBT = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
BLACK_RGBT = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
RED_RGBT = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
GREEN_RGBT = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
BLUE_RGBT = np.array([0.0, 0.0, 1.0, 0.0], np.float32)

COLORS_RGBT_DICT = {
    "white": WHITE_RGBT, "black": BLACK_RGBT, "red": RED_RGBT,
    "green": GREEN_RGBT, "blue": BLUE_RGBT,
}


def get_color(color):
    """Color name or RGB list -> array (reference colors.py:51-60)."""
    if isinstance(color, str):
        color = color.lower()
        if color not in COLORS_DICT:
            raise ValueError(f"{color} is not a valid color")
        return COLORS_DICT[color]
    if isinstance(color, (list, tuple)):
        if len(color) != 3:
            raise ValueError(f"color should be 3 values, got {len(color)}")
        return np.asarray(color, np.float32)
    raise ValueError(f"color should be a string or list, not {type(color)}")
