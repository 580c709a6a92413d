"""FLIR raw extraction: embedded RGB + radiometric thermal from FLIR JPEGs.
(a copy of nerfstudio_thermal_tpu/process_data/flir_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/flir_utils.py` —
exiftool subprocess pulls the embedded visual JPEG and raw thermal PNG
(:76-130), 16-bit endian fix (:137-139), raw sensor counts -> Celsius via the
Planck radiometric model ported from Thermimage R (`raw2temp:157-201`), and
per-scene or per-image normalization to 8-bit PNGs (:281-324).

`raw2temp` here is vectorized numpy (the reference np.vectorize's a scalar
lambda); identical math. exiftool is an external host binary: its absence
raises a clear error only when extraction is actually invoked.
"""

import json
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def exiftool_available(exiftool_path: str = "exiftool") -> bool:
    return shutil.which(exiftool_path) is not None


def extract_float(dirtystr) -> float:
    """Extract the float out of an exiftool value string (reference :205-211)."""
    if isinstance(dirtystr, (int, float)):
        return float(dirtystr)
    digits = re.findall(r"[-+]?\d*\.\d+|\d+", str(dirtystr))
    return float(digits[0])


def raw2temp(
    raw,
    E=1.0,
    OD=1.0,
    RTemp=20.0,
    ATemp=20.0,
    IRWTemp=20.0,
    IRT=1.0,
    RH=50.0,
    PR1=21106.77,
    PB=1501.0,
    PF=1.0,
    PO=-7340.0,
    PR2=0.012545258,
):
    """FLIR raw sensor counts -> temperature in Celsius
    (reference flir_utils.py:157-201; ported from Thermimage R raw2temp)."""
    raw = np.asarray(raw, np.float64)

    ATA1 = 0.006569
    ATA2 = 0.01262
    ATB1 = -0.002276
    ATB2 = -0.00667
    ATX = 1.9

    emiss_wind = 1 - IRT
    refl_wind = 0

    h2o = (RH / 100) * np.exp(
        1.5587 + 0.06939 * ATemp - 0.00027816 * ATemp**2 + 0.00000068455 * ATemp**3
    )
    tau1 = ATX * np.exp(-np.sqrt(OD / 2) * (ATA1 + ATB1 * np.sqrt(h2o))) + (
        1 - ATX
    ) * np.exp(-np.sqrt(OD / 2) * (ATA2 + ATB2 * np.sqrt(h2o)))
    tau2 = tau1

    def planck(temp_c):
        return PR1 / (PR2 * (np.exp(PB / (temp_c + 273.15)) - PF)) - PO

    raw_refl1 = planck(RTemp)
    raw_refl1_attn = (1 - E) / E * raw_refl1
    raw_atm1 = planck(ATemp)
    raw_atm1_attn = (1 - tau1) / E / tau1 * raw_atm1
    raw_wind = planck(IRWTemp)
    raw_wind_attn = emiss_wind / E / tau1 / IRT * raw_wind
    raw_refl2 = planck(RTemp)
    raw_refl2_attn = refl_wind / E / tau1 / IRT * raw_refl2
    raw_atm2 = planck(ATemp)
    raw_atm2_attn = (1 - tau2) / E / tau1 / IRT / tau2 * raw_atm2
    raw_obj = (
        raw / E / tau1 / IRT / tau2
        - raw_atm1_attn
        - raw_atm2_attn
        - raw_wind_attn
        - raw_refl1_attn
        - raw_refl2_attn
    )
    return PB / np.log(PR1 / (PR2 * (raw_obj + PO)) + PF) - 273.15


def fix_endian(thermal: np.ndarray) -> np.ndarray:
    """Byte-swap 16-bit raw thermal PNG values (reference :137-139)."""
    t = thermal.astype(np.uint32)
    return ((t >> 8) + ((t & 0x00FF) << 8)).astype(np.uint16)


class FlirImageExtractor:
    """Pull embedded RGB + raw thermal out of a FLIR JPEG via exiftool
    (reference flir_utils.py:30-155)."""

    def __init__(self, exiftool_path: str = "exiftool", default_distance: float = 1.0):
        self.exiftool_path = exiftool_path
        self.default_distance = default_distance
        self.rgb_np: Optional[np.ndarray] = None
        self.thermal_np: Optional[np.ndarray] = None

    def _run_exiftool(self, args) -> bytes:
        if not exiftool_available(self.exiftool_path):
            raise RuntimeError(
                "exiftool is required for FLIR extraction but was not found on "
                "PATH; install exiftool or provide pre-extracted rgb/thermal "
                "folders."
            )
        return subprocess.check_output([self.exiftool_path, *args])

    def get_metadata(self, flir_img_path) -> dict:
        out = self._run_exiftool(
            [
                str(flir_img_path), "-Emissivity", "-SubjectDistance",
                "-AtmosphericTemperature", "-ReflectedApparentTemperature",
                "-IRWindowTemperature", "-IRWindowTransmission",
                "-RelativeHumidity", "-PlanckR1", "-PlanckB", "-PlanckF",
                "-PlanckO", "-PlanckR2", "-RawThermalImageType", "-j",
            ]
        )
        return json.loads(out)[0]

    def extract_embedded_image(self, flir_img_path) -> np.ndarray:
        """Embedded visual image (reference :96-108)."""
        import io

        from PIL import Image  # host-only: Pillow is not on the card's machine

        data = self._run_exiftool(["-EmbeddedImage", "-b", str(flir_img_path)])
        return np.array(Image.open(io.BytesIO(data)))

    def extract_thermal_image(self, flir_img_path) -> np.ndarray:
        """Raw thermal -> Celsius (reference :110-155)."""
        import io

        from PIL import Image  # host-only: Pillow is not on the card's machine

        meta = self.get_metadata(flir_img_path)
        data = self._run_exiftool(["-RawThermalImage", "-b", str(flir_img_path)])
        thermal_np = np.array(Image.open(io.BytesIO(data)))
        if meta.get("RawThermalImageType", "PNG").upper() == "PNG":
            thermal_np = fix_endian(thermal_np)
        subject_distance = self.default_distance
        if "SubjectDistance" in meta:
            subject_distance = extract_float(meta["SubjectDistance"])
        return raw2temp(
            thermal_np,
            E=extract_float(meta["Emissivity"]),
            OD=subject_distance,
            RTemp=extract_float(meta["ReflectedApparentTemperature"]),
            ATemp=extract_float(meta["AtmosphericTemperature"]),
            IRWTemp=extract_float(meta["IRWindowTemperature"]),
            IRT=extract_float(meta["IRWindowTransmission"]),
            RH=extract_float(meta["RelativeHumidity"]),
            PR1=extract_float(meta["PlanckR1"]),
            PB=extract_float(meta["PlanckB"]),
            PF=extract_float(meta["PlanckF"]),
            PO=extract_float(meta["PlanckO"]),
            PR2=extract_float(meta["PlanckR2"]),
        )

    def process_image(self, flir_img_path):
        self.rgb_np = self.extract_embedded_image(flir_img_path)
        self.thermal_np = self.extract_thermal_image(flir_img_path)
        return self.rgb_np, self.thermal_np


IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".gif")


def extract_raws_from_dir(
    in_path,
    out_path=None,
    upsample_thermal: bool = False,
    normalize_per_image: bool = False,
) -> Tuple[Path, Path]:
    """Extract all FLIR JPEGs in a dir to rgb/ + thermal/ 8-bit PNGs with
    per-scene (default) or per-image temperature normalization
    (reference flir_utils.py:281-324). Returns (rgb_dir, thermal_dir)."""
    from PIL import Image  # host-only: Pillow is not on the card's machine

    in_path = Path(in_path)
    out_path = Path(out_path) if out_path else Path(f"{in_path}_raw")
    rgb_dir = out_path / "rgb"
    thermal_dir = out_path / "thermal"
    rgb_dir.mkdir(parents=True, exist_ok=True)
    thermal_dir.mkdir(parents=True, exist_ok=True)

    img_files = sorted(
        f for f in os.listdir(in_path) if f.lower().endswith(IMAGE_SUFFIXES)
    )
    extractor = FlirImageExtractor()
    rgb_nps, thermal_nps = [], []
    min_temp, max_temp = np.inf, -np.inf
    for f in img_files:
        rgb_np, thermal_np = extractor.process_image(in_path / f)
        min_temp = min(min_temp, float(thermal_np.min()))
        max_temp = max(max_temp, float(thermal_np.max()))
        rgb_nps.append(rgb_np)
        thermal_nps.append(thermal_np)
        Image.fromarray(rgb_np).save(rgb_dir / f"{Path(f).stem}_rgb.png")

    for f, rgb_np, thermal_np in zip(img_files, rgb_nps, thermal_nps):
        if normalize_per_image:
            lo, hi = thermal_np.min(), thermal_np.max()
        else:
            lo, hi = min_temp, max_temp
        normalized = (thermal_np - lo) / max(hi - lo, 1e-12)
        if upsample_thermal:
            h, w = rgb_np.shape[:2]
            normalized = np.array(
                Image.fromarray((normalized * 255).astype(np.uint8)).resize(
                    (w, h), Image.BILINEAR
                )
            ).astype(np.float64) / 255.0
        Image.fromarray((normalized * 255).astype(np.uint8)).save(
            thermal_dir / f"{Path(f).stem}_thermal.png"
        )
    return rgb_dir, thermal_dir
