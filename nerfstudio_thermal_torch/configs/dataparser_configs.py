"""Dataparser registry (counterpart of
nerfstudio_thermal_tpu/configs/dataparser_configs.py): the sixteen parser
configs by their CLI names, and `build_dataparser`, which gives the parser
of a config (the most derived registered class wins). Plugin parsers are
not registered here (ROADMAP A9).
"""

from typing import Dict

from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import DataParserConfig
from nerfstudio_thermal_torch.data.dataparsers.blender_dataparser import (
    Blender,
    BlenderDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.colmap_dataparser import (
    ColmapDataParser,
    ColmapDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.minimal_dataparser import (
    MinimalDataParser,
    MinimalDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.dnerf_dataparser import (
    DNeRF,
    DNeRFDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.instant_ngp_dataparser import (
    InstantNGP,
    InstantNGPDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import (
    Nerfstudio,
    NerfstudioDataParserConfig,
    ThermalNerf,
    ThermalNerfDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.scene_parsers import (
    ARKitScenes,
    ARKitScenesDataParserConfig,
    Dycheck,
    DycheckDataParserConfig,
    NeRFOSR,
    NeRFOSRDataParserConfig,
    NuScenes,
    NuScenesDataParserConfig,
    Phototourism,
    PhototourismDataParserConfig,
    ScanNet,
    ScanNetDataParserConfig,
    ScanNetpp,
    ScanNetppDataParserConfig,
    Sitcoms3D,
    Sitcoms3DDataParserConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.sdfstudio_dataparser import (
    SDFStudio,
    SDFStudioDataParserConfig,
)

dataparser_configs: Dict[str, DataParserConfig] = {
    "nerfstudio-data": NerfstudioDataParserConfig(),
    "thermalnerf-data": ThermalNerfDataParserConfig(),
    "blender-data": BlenderDataParserConfig(),
    "colmap": ColmapDataParserConfig(),
    "minimal-parser": MinimalDataParserConfig(),
    "instant-ngp-data": InstantNGPDataParserConfig(),
    "dnerf-data": DNeRFDataParserConfig(),
    "sdfstudio-data": SDFStudioDataParserConfig(),
    "scannet-data": ScanNetDataParserConfig(),
    "scannetpp-data": ScanNetppDataParserConfig(),
    "arkitscenes-data": ARKitScenesDataParserConfig(),
    "sitcoms3d-data": Sitcoms3DDataParserConfig(),
    "nerfosr-data": NeRFOSRDataParserConfig(),
    "phototourism-data": PhototourismDataParserConfig(),
    "nuscenes-data": NuScenesDataParserConfig(),
    "dycheck-data": DycheckDataParserConfig(),
}

DATAPARSER_CLASSES = {
    NerfstudioDataParserConfig: Nerfstudio,
    ThermalNerfDataParserConfig: ThermalNerf,
    BlenderDataParserConfig: Blender,
    ColmapDataParserConfig: ColmapDataParser,
    MinimalDataParserConfig: MinimalDataParser,
    InstantNGPDataParserConfig: InstantNGP,
    DNeRFDataParserConfig: DNeRF,
    SDFStudioDataParserConfig: SDFStudio,
    ScanNetDataParserConfig: ScanNet,
    ScanNetppDataParserConfig: ScanNetpp,
    ARKitScenesDataParserConfig: ARKitScenes,
    Sitcoms3DDataParserConfig: Sitcoms3D,
    NeRFOSRDataParserConfig: NeRFOSR,
    PhototourismDataParserConfig: Phototourism,
    NuScenesDataParserConfig: NuScenes,
    DycheckDataParserConfig: Dycheck,
}


def build_dataparser(config: DataParserConfig):
    """Instantiate the parser for a config (most-specific class wins)."""
    for cls in type(config).__mro__:
        if cls in DATAPARSER_CLASSES:
            return DATAPARSER_CLASSES[cls](config)
    raise KeyError(f"no dataparser registered for {type(config).__name__}")
