"""ns-process-data: convert raw captures into trainable datasets
(counterpart of nerfstudio_thermal_tpu/scripts/process_data.py).

    ns-process-data-torch rgbt --data FLIR_DIR --output-dir OUT [--calibration-data CAL1,CAL2] [flags]
    ns-process-data-torch images --data IMAGE_DIR --output-dir OUT [flags]
    ns-process-data-torch video --data VIDEO --output-dir OUT [--camera-type equirectangular] [flags]
    ns-process-data-torch polycam|record3d|metashape|realitycapture|odm|skydio --data EXPORT --output-dir OUT [flags]

Every mode of the JAX script, dispatched as it does: `images` (copy and
downscale images, COLMAP, transforms.json), `video` (frames through
OpenCV, then the images pipeline; equirectangular videos are cut into
planar projections first), `rgbt` (the paper's pipeline: FLIR extraction
with exiftool, circle-grid RGB <-> thermal calibration, COLMAP with the
calibrated intrinsics fixed, the metric scale fix, an RGB + thermal
transforms.json) and the vendor exports (polycam, record3d with scipy,
metashape, realitycapture with Pillow, odm, skydio with exiftool). All
run on the host: they need OpenCV, Pillow or scipy in Python and the
exiftool and colmap executables on PATH (hloc where asked for), none of
which the card's machine has. Usage text and return codes are the JAX
script's.
"""

import sys
from pathlib import Path


def _parse_kwargs(args, cls):
    """--flag value pairs -> dataclass kwargs (typed via field types)."""
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    i = 0
    while i < len(args):
        tok = args[i]
        if not tok.startswith("--"):
            print(f"error: unexpected argument {tok}", file=sys.stderr)
            raise SystemExit(2)
        key = tok.lstrip("-").replace("-", "_")
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            val = args[i + 1]
            i += 2
        if key not in hints:
            print(f"error: unknown flag --{key} for {cls.__name__}", file=sys.stderr)
            raise SystemExit(2)
        typ = hints[key]
        origin = typing.get_origin(typ)
        if origin is typing.Union:
            inner = [a for a in typing.get_args(typ) if a is not type(None)]
            typ = inner[0] if inner else str
            origin = typing.get_origin(typ)
        if origin in (list, typing.List):
            kwargs[key] = [Path(v) for v in val.split(",")]
        elif typ is Path:
            kwargs[key] = Path(val)
        elif typ is bool:
            kwargs[key] = val.lower() in ("1", "true", "yes")
        elif typ is int:
            kwargs[key] = int(val)
        elif typ is float:
            kwargs[key] = float(val)
        elif origin is tuple or typ is tuple:
            kwargs[key] = tuple(
                float(v) if "." in v else v for v in val.split(",")
            )
        else:
            kwargs[key] = val
    return kwargs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: ns-process-data MODE --data PATH --output-dir PATH [flags]\n"
            "modes:\n"
            "  images: copy+downscale images, run COLMAP, write transforms.json\n"
            "  video:  extract ~num-frames-target frames, then the images pipeline\n"
            "  rgbt:   FLIR extraction, circle-grid RGB<->thermal calibration,\n"
            "          COLMAP with fixed intrinsics, metric scale fix, RGBT transforms.json\n"
            "  skydio: Skydio drone RGB+IR capture (XMP metadata poses)\n"
            "  polycam | record3d | metashape | realitycapture | odm:\n"
            "          vendor exports -> transforms.json"
        )
        return 0

    mode = argv[0]
    if mode == "images":
        from nerfstudio_thermal_torch.process_data.images_to_nerfstudio_dataset import (
            ImagesToNerfstudioDataset,
        )

        cls = ImagesToNerfstudioDataset
    elif mode == "video":
        from nerfstudio_thermal_torch.process_data.video_to_nerfstudio_dataset import (
            VideoToNerfstudioDataset,
        )

        cls = VideoToNerfstudioDataset
    elif mode == "rgbt":
        from nerfstudio_thermal_torch.process_data.rgbt_to_nerfstudio_dataset import (
            RGBTToNerfstudioDataset,
        )

        cls = RGBTToNerfstudioDataset
    elif mode in ("polycam", "record3d", "metashape", "realitycapture",
                  "odm", "skydio"):
        from nerfstudio_thermal_torch.process_data import device_converters as dc

        cls = {
            "polycam": dc.PolycamToNerfstudioDataset,
            "record3d": dc.Record3DToNerfstudioDataset,
            "metashape": dc.MetashapeToNerfstudioDataset,
            "realitycapture": dc.RealityCaptureToNerfstudioDataset,
            "odm": dc.ODMToNerfstudioDataset,
            "skydio": dc.SkydioToNerfstudioDataset,
        }[mode]
    else:
        print(f"error: unknown subcommand '{mode}'", file=sys.stderr)
        return 2

    kwargs = _parse_kwargs(argv[1:], cls)
    converter = cls(**kwargs)
    converter.main()
    return 0


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
