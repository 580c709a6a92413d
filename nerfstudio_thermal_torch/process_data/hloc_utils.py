"""hloc (hierarchical localization) SfM wrapper.
(a copy of nerfstudio_thermal_tpu/process_data/hloc_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/hloc_utils.py:45-153` —
feature extraction + matching + reconstruction via the `hloc` toolbox as an
alternative to COLMAP's SIFT pipeline. The hloc package (and its pycolmap
dependency) is optional: the wrapper mirrors the reference API and raises
a clear error when hloc is not installed; COLMAP
(process_data/colmap_utils.py) is the supported SfM path.
"""

from pathlib import Path
from typing import Literal, Optional


def hloc_available() -> bool:
    try:
        import hloc  # noqa: F401

        return True
    except ImportError:
        return False


def run_hloc(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    verbose: bool = False,
    matching_method: str = "vocab_tree",
    feature_type: str = "superpoint_aachen",
    matcher_type: str = "superglue",
    num_matched: int = 50,
    refine_pixsfm: bool = False,
) -> None:
    """(reference hloc_utils.py:45-153). Runs extraction, pair generation,
    matching and reconstruction, writing a COLMAP-format model under
    colmap_dir/sparse/0."""
    if not hloc_available():
        raise ImportError(
            "hloc is not installed. Use the COLMAP pipeline "
            "(--sfm-tool colmap) or install hloc "
            "(github.com/cvg/Hierarchical-Localization) with pycolmap."
        )
    from hloc import (  # type: ignore
        extract_features,
        match_features,
        pairs_from_exhaustive,
        pairs_from_retrieval,
        reconstruction,
    )

    outputs = Path(colmap_dir)
    sfm_pairs = outputs / "pairs-netvlad.txt"
    sfm_dir = outputs / "sparse" / "0"
    features = outputs / "features.h5"
    matches = outputs / "matches.h5"

    retrieval_conf = extract_features.confs["netvlad"]
    feature_conf = extract_features.confs[feature_type]
    matcher_conf = match_features.confs[matcher_type]

    references = [
        p.relative_to(image_dir).as_posix()
        for p in sorted(Path(image_dir).iterdir())
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    ]
    extract_features.main(
        feature_conf, Path(image_dir), image_list=references,
        feature_path=features,
    )
    if matching_method == "exhaustive":
        pairs_from_exhaustive.main(sfm_pairs, image_list=references)
    else:
        retrieval_path = extract_features.main(
            retrieval_conf, Path(image_dir), outputs
        )
        pairs_from_retrieval.main(
            retrieval_path, sfm_pairs,
            num_matched=min(num_matched, len(references)),
        )
    match_features.main(
        matcher_conf, sfm_pairs, features=features, matches=matches
    )
    import pycolmap  # type: ignore

    reconstruction.main(
        sfm_dir, Path(image_dir), sfm_pairs, features, matches,
        camera_mode=pycolmap.CameraMode.SINGLE,
        image_options=dict(camera_model=camera_model),
        verbose=verbose,
    )
