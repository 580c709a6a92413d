"""Every listed colormap of matplotlib, carried by the port as a table,
against the JAX package's `apply_float_colormap` (which reads matplotlib):
the same float32 rows, `twilight`'s first 256 of its 510, and an
IndexError wherever JAX's `table[idx]` raises (a qualitative list indexed
past its last row)."""

import matplotlib
import numpy as np
import pytest

from nerfstudio_thermal_tpu.utils.colormaps import apply_float_colormap as jax_apply
from nerfstudio_thermal_torch.utils.colormaps import COLORMAPS, apply_float_colormap

LISTED = [name for name in matplotlib.colormaps if hasattr(matplotlib.colormaps[name], "colors")]


def test_the_port_carries_every_listed_colormap():
    assert len(LISTED) == 46
    assert set(LISTED) <= set(COLORMAPS)
    with pytest.raises(NotImplementedError, match="twilight_shifted_r"):
        apply_float_colormap(np.zeros((2, 1), np.float32), "jet")


@pytest.mark.parametrize("name", LISTED)
def test_colormap_matches_jax(name):
    rows = len(matplotlib.colormaps[name].colors)
    low = np.arange(min(rows, 256), dtype=np.float32)[:, None] / 255  # every row JAX can index
    np.testing.assert_array_equal(apply_float_colormap(low, name), jax_apply(low, name))
    full = np.concatenate([np.linspace(-0.2, 1.2, 301, dtype=np.float32), [np.nan, np.inf, -np.inf]])[:, None]
    try:
        want = jax_apply(full, name)
    except IndexError:
        assert rows < 256
        with pytest.raises(IndexError):
            apply_float_colormap(full, name)
        return
    got = apply_float_colormap(full, name)
    assert got.dtype == want.dtype == np.float32 and got.shape == (304, 3)
    np.testing.assert_array_equal(got, want)
