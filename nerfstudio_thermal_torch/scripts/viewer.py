"""ns-viewer: serve the web viewer on a trained run
(counterpart of nerfstudio_thermal_tpu/scripts/viewer.py).

    python -m nerfstudio_thermal_torch.scripts.viewer --load-config RUN/config.yml [--port 7007]

Reloads the run through `eval_setup` on the card and serves the client
page on http://localhost:PORT and its websocket on PORT + 1
(viewer/server.py); every frame is rendered on the card. The eval cameras
bound the output probe and the exports, the train cameras when the eval
split is empty. Camera paths and exports are written beside config.yml.
"""

import sys
from pathlib import Path
from typing import List, Optional, Tuple, Union

import torch

USAGE = "usage: ns-viewer --load-config CONFIG.yml [--port 7007]"


def _parse(argv: List[str]) -> Tuple[Optional[Path], int]:
    load_config, port = None, 7007
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--load-config") or tok.startswith("--port"):
            val = tok.split("=", 1)[1] if "=" in tok else argv[i + 1]
            i += 1 if "=" in tok else 2
            if tok.startswith("--load-config"):
                load_config = Path(val)
            else:
                port = int(val)
            continue
        i += 1
    return load_config, port


def serve(load_config: Path, port: int = 7007, *, device: Union[str, torch.device] = "cuda"):
    """Reload the run and start its viewer in daemon threads; returns the
    running ViewerServer (`stop()` ends it)."""
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
    from nerfstudio_thermal_torch.viewer.server import (
        ViewerServer,
        make_model_export_fn,
        make_model_render_fn,
        probe_output_names,
    )

    load_config = Path(load_config)
    _, trainer = eval_setup(load_config, device=device)
    model = trainer.model
    cameras = trainer.datamanager.eval_cameras
    if len(cameras) == 0:
        # a split that leaves no eval images still needs a camera for the
        # output probe and the export bounds
        cameras = trainer.datamanager.train_cameras
    server = ViewerServer(
        make_model_render_fn(model),
        output_names=probe_output_names(model, cameras),
        port=port,
        save_dir=load_config.parent,
        export_fn=make_model_export_fn(model, cameras, load_config.parent),
    )
    server.start()
    return server


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu". Serves until
    interrupted."""
    from nerfstudio_thermal_torch.utils.precision import pin_precision

    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-h" in argv or "--help" in argv:
        print(USAGE)
        return 0
    load_config, port = _parse(argv)
    if load_config is None:
        print("error: --load-config is required", file=sys.stderr)
        return 2
    server = serve(load_config, port, device=device)
    try:
        server.wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
