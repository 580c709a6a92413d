"""Misc utilities
(counterpart of nerfstudio_thermal_tpu/utils/misc.py, copied: it imports
no JAX).

Behavioral spec: reference `nerfstudio/utils/misc.py` (`step_check` cadence
helper and friends).
"""

from typing import Any, Dict


def step_check(step: int, check_every: int, run_at_zero: bool = False) -> bool:
    """True when `step` is on the `check_every` cadence (reference misc.py)."""
    if check_every == 0:
        return False
    return (run_at_zero or step != 0) and step % check_every == 0


def scale_dict(dictionary: Dict[Any, Any], coefficients: Dict[str, float]) -> Dict[Any, Any]:
    """Scale values by the given coefficients (reference misc.py)."""
    for key in dictionary:
        if key in coefficients:
            dictionary[key] = dictionary[key] * coefficients[key]
    return dictionary


def human_format(num: float) -> str:
    """1234567 -> '1.23 M' (reference misc.py)."""
    units = ["", "K", "M", "B", "T", "P"]
    k = 1000.0
    magnitude = 0
    while abs(num) >= k and magnitude < len(units) - 1:
        num /= k
        magnitude += 1
    return f"{num:.2f} {units[magnitude]}"
