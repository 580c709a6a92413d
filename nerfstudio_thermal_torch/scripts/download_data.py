"""ns-download-data: dataset download helper.
(a copy of nerfstudio_thermal_tpu/scripts/download_data.py, which imports
no JAX; EyefulTower captures convert through the port's eyeful_utils)

Behavioral spec: reference `nerfstudio/scripts/downloads/download_data.py`
(dataset families: blender, sitcoms3d, nerfstudio, record3d, dnerf,
phototourism, sdfstudio, nerfosr, mill19, eyefultower). The capture-name ->
source registry matches the reference so the same commands fetch the same
data; the download engine here is a single generic path (urllib + stdlib
archives) instead of per-family gdown/curl subprocess code.

Network egress may be unavailable in some environments; every failure mode
explains how to place the data manually.
"""

import shutil
import sys
import tarfile
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

# --------------------------------------------------------------------------
# Registry. Sources are either ("gdrive", file_id) or ("https", url).
# Google Drive's large-file download requires the confirm-token dance that
# the reference delegates to gdown; we construct the same uc?id= URL and
# fall back to printing it when the direct fetch is refused.
# --------------------------------------------------------------------------


def _gdrive(file_id: str):
    return ("gdrive", f"https://drive.google.com/uc?id={file_id}")


def _https(url: str):
    return ("https", url)


NERFSTUDIO_CAPTURES: Dict[str, tuple] = {
    "bww_entrance": _gdrive("1ylkRHtfB3n3IRLf2wplpfxzPTq7nES9I"),
    "campanile": _gdrive("13aOfGJRRH05pOOk9ikYGTwqFc2L1xskU"),
    "desolation": _gdrive("14IzOOQm9KBJ3kPbunQbUTHPnXnmZus-f"),
    "library": _gdrive("1Hjbh_-BuaWETQExn2x2qGD74UwrFugHx"),
    "poster": _gdrive("1dmjWGXlJnUxwosN6MVooCDQe970PkD-1"),
    "redwoods2": _gdrive("1rg-4NoXT8p6vkmbWxMOY6PSG4j3rfcJ8"),
    "storefront": _gdrive("16b792AguPZWDA_YC4igKCwXJqW0Tb21o"),
    "vegetation": _gdrive("1wBhLQ2odycrtU39y2akVurXEAt9SsVI3"),
    "Egypt": _gdrive("1YktD85afw7uitC3nPamusk0vcBdAfjlF"),
    "person": _gdrive("1HsGMwkPu-R7oU7ySMdoo6Eppq8pKhHF3"),
    "kitchen": _gdrive("1IRmNyNZSNFidyj93Tt5DtaEU9h6eJdi1"),
    "plane": _gdrive("1tnv2NC2Iwz4XRYNtziUWvLJjObkZNo2D"),
    "dozer": _gdrive("1jQJPz5PhzTH--LOcCxvfzV_SDLEp1de3"),
    "floating-tree": _gdrive("1mVEHcO2ep13WPx92IPDvdQg66vLQwFSy"),
    "aspen": _gdrive("1X1PQcji_QpxGfMxbETKMeK8aOnWCkuSB"),
    "stump": _gdrive("1yZFAAEvtw2hs4MXrrkvhVAzEliLLXPB7"),
    "sculpture": _gdrive("1CUU_k0Et2gysuBn_R5qenDMfYXEhNsd1"),
    "Giannini-Hall": _gdrive("1UkjWXLN4qybq_a-j81FsTKghiXw39O8E"),
}

# the curated "nerfstudio-dataset" subset (reference download_data.py:92-103)
NERFSTUDIO_DATASET_SUBSET = [
    "Egypt", "person", "kitchen", "plane", "dozer", "floating-tree",
    "aspen", "stump", "sculpture", "Giannini-Hall",
]

PHOTOTOURISM_BASE = "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData"
PHOTOTOURISM_CAPTURES: Dict[str, tuple] = {
    name: _https(f"{PHOTOTOURISM_BASE}/{fname}.tar.gz")
    for name, fname in {
        "brandenburg-gate": "brandenburg_gate",
        "buckingham-palace": "buckingham_palace",
        "colosseum-exterior": "colosseum_exterior",
        "grand-palace-brussels": "grand_place_brussels",
        "notre-dame-facade": "notre_dame_front_facade",
        "westminster-palace": "palace_of_westminster",
        "pantheon-exterior": "pantheon_exterior",
        "taj-mahal": "taj_mahal",
        "temple-nara": "temple_nara_japan",
        "trevi-fountain": "trevi_fountain",
    }.items()
}

SDFSTUDIO_BASE = "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data"
SDFSTUDIO_CAPTURES: Dict[str, tuple] = {
    "sdfstudio-demo-data": _https(f"{SDFSTUDIO_BASE}/sdfstudio-demo-data.tar"),
    "dtu": _https(f"{SDFSTUDIO_BASE}/DTU.tar"),
    "replica": _https(f"{SDFSTUDIO_BASE}/Replica.tar"),
    "scannet": _https(f"{SDFSTUDIO_BASE}/scannet.tar"),
    "tanks-and-temple": _https(f"{SDFSTUDIO_BASE}/tnt_advanced.tar"),
    "tanks-and-temple-highres": _https(f"{SDFSTUDIO_BASE}/highresTNT.tar"),
    "heritage": _https(f"{SDFSTUDIO_BASE}/Heritage-Recon.tar"),
    "neural-rgbd-data": _https(
        "http://kaldir.vc.in.tum.de/neural_rgbd/neural_rgbd_data.zip"
    ),
}

NERFOSR_BASE = "https://nextcloud.mpi-klsb.mpg.de/index.php/s/mGXYKpD8raQ8nMk/download"
NERFOSR_SECRETS = {
    "europa": "0k2r95c1fdej", "lk2": "w8kuvjzmchc", "lwp": "gtnc4vmkcjq",
    "rathaus": "7372aewy6rr", "schloss": "y8t00nqx0h", "st": "kl9ptuxe8v",
    "stjacob": "sntsim6ebvm", "stjohann": "g80ug1fsbmh", "trevi": "ot1483bigjm",
}
NERFOSR_CAPTURES: Dict[str, tuple] = {
    name: _https(
        f"{NERFOSR_BASE}?path=%2FData&files={name}&downloadStartSecret={secret}"
    )
    for name, secret in NERFOSR_SECRETS.items()
}

MILL19_CAPTURES: Dict[str, tuple] = {
    "building": _https(
        "https://storage.cmusatyalab.org/mega-nerf-data/building-pixsfm.tgz"
    ),
    "rubble": _https(
        "https://storage.cmusatyalab.org/mega-nerf-data/rubble-pixsfm.tgz"
    ),
}


@dataclass
class DatasetFamily:
    """One `ns-download-data <name>` subcommand."""

    name: str
    captures: Dict[str, tuple]  # capture name -> (kind, url)
    default_capture: Optional[str] = None  # None: family has no captures
    supports_all: bool = False
    note: str = ""
    # post-extract rename performed by the reference (src dir under save_dir
    # -> family dir), e.g. blender's nerf_synthetic/ -> blender/
    extract_rename: Optional[tuple] = None
    aliases: tuple = ()


FAMILIES: Dict[str, DatasetFamily] = {}


def _register(fam: DatasetFamily):
    FAMILIES[fam.name] = fam
    for alias in fam.aliases:
        FAMILIES[alias] = fam


_register(DatasetFamily(
    name="blender",
    captures={"blender": _gdrive("18JxhpWD-4ZmuFKLzKlAw-w5PpzZxXOcG")},
    extract_rename=("nerf_synthetic", "blender"),
))
_register(DatasetFamily(
    name="sitcoms3d",
    captures={"sitcoms3d": _gdrive("1sgKr0ZO7BQC0FYinAnRSxobIWNucAST5")},
    extract_rename=("friends", "sitcoms3d"),
))
_register(DatasetFamily(
    name="nerfstudio",
    captures=NERFSTUDIO_CAPTURES,
    default_capture="bww_entrance",
    supports_all=True,
))
_register(DatasetFamily(
    name="record3d",
    captures={"bear": _gdrive("1WRZohWMRj0nNlYFIEBwkddDoGPvLTzkR")},
    default_capture="bear",
))
_register(DatasetFamily(
    name="dnerf",
    captures={"dnerf": _https("https://www.dropbox.com/s/raw/0bf6fl0ye2vz3vr/data.zip")},
    extract_rename=("data", "dnerf"),
))
_register(DatasetFamily(
    name="phototourism",
    captures=PHOTOTOURISM_CAPTURES,
    default_capture="brandenburg-gate",
    supports_all=True,
))
_register(DatasetFamily(
    name="sdfstudio",
    captures=SDFSTUDIO_CAPTURES,
    default_capture="sdfstudio-demo-data",
    supports_all=True,
))
_register(DatasetFamily(
    name="nerfosr",
    captures=NERFOSR_CAPTURES,
    default_capture="europa",
    supports_all=True,
))
_register(DatasetFamily(
    name="mill19",
    captures=MILL19_CAPTURES,
    default_capture="building",
    supports_all=True,
    note="after download run `ns-process-data` or use the nerfstudio "
    "dataparser on the generated transforms.json",
))
_register(DatasetFamily(
    name="eyefultower",
    captures={},
    note="AWS-hosted; see --capture-name/--resolution-name",
))


def resolve_source(dataset: str, capture: Optional[str]) -> tuple:
    """(kind, url, capture_name) for one capture of one family."""
    fam = FAMILIES[dataset]
    if not fam.default_capture:
        # single-archive family: the only entry is keyed by the family name
        key = next(iter(fam.captures))
        return (*fam.captures[key], key)
    cap = capture or fam.default_capture
    if cap not in fam.captures:
        raise KeyError(
            f"unknown capture '{cap}' for {fam.name}; "
            f"choices: {', '.join(sorted(fam.captures))}"
        )
    return (*fam.captures[cap], cap)


def _extract_archive(archive: Path, dest_dir: Path) -> None:
    name = archive.name
    if name.endswith(".zip"):
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(dest_dir)
    elif name.endswith((".tar.gz", ".tgz")):
        with tarfile.open(archive, "r:gz") as tf:
            tf.extractall(dest_dir, filter="data")
    elif name.endswith(".tar"):
        with tarfile.open(archive, "r") as tf:
            tf.extractall(dest_dir, filter="data")
    else:
        raise ValueError(f"unknown archive format: {name}")


def _flatten_single_dir(tmp: Path, target: Path) -> None:
    """Move the single extracted top-level folder to target (reference
    behavior for per-capture archives)."""
    inner = [p for p in tmp.iterdir() if not p.name.startswith(".")]
    src = inner[0] if len(inner) == 1 and inner[0].is_dir() else tmp
    if target.exists():
        shutil.rmtree(target)
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(src), str(target))


def _download_url(url: str, dest: Path) -> None:
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    req = urllib.request.Request(url, headers={"User-Agent": "ns-download-data"})
    with urllib.request.urlopen(req) as resp, open(dest, "wb") as f:
        shutil.copyfileobj(resp, f)


def download_capture(dataset: str, capture: Optional[str], save_dir: Path) -> int:
    fam = FAMILIES[dataset]
    try:
        kind, url, cap = resolve_source(dataset, capture)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    suffix = ".zip"
    for s in (".tar.gz", ".tgz", ".tar", ".zip"):
        if url.split("?")[0].endswith(s):
            suffix = s
            break
    archive = save_dir / fam.name / f".download_{cap}{suffix}"
    try:
        print(f"downloading {url} -> {archive}")
        _download_url(url, archive)
    except Exception as e:  # noqa: BLE001 — network/env dependent
        manual = (
            f"gdown '{url}'" if kind == "gdrive" else f"curl -L '{url}' -o data{suffix}"
        )
        print(
            f"download failed ({e}).\n"
            f"If this environment has no network egress (or the source needs "
            f"a browser confirm step), fetch it elsewhere:\n  {manual}\n"
            f"then extract under {save_dir / fam.name}.",
            file=sys.stderr,
        )
        archive.unlink(missing_ok=True)
        return 1

    tmp = save_dir / fam.name / f".tmp_{cap}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True, exist_ok=True)
    if fam.extract_rename is not None:
        # single-archive family extracting into save_dir with a rename
        _extract_archive(archive, save_dir)
        src, dst = fam.extract_rename
        if (save_dir / src).exists():
            if (save_dir / dst).exists():
                shutil.rmtree(save_dir / dst)
            (save_dir / src).rename(save_dir / dst)
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        _extract_archive(archive, tmp)
        _flatten_single_dir(tmp, save_dir / fam.name / cap)
        shutil.rmtree(tmp, ignore_errors=True)
    archive.unlink(missing_ok=True)
    if fam.note:
        print(f"note: {fam.note}")
    print(f"done: {save_dir / fam.name}")
    return 0


def _eyefultower(save_dir: Path, capture: str, resolution: str) -> int:
    """EyefulTower: AWS download (reference scripts/downloads/eyeful_tower.py)
    + cameras.json/splits.json -> transforms.json conversion. The conversion
    runs offline whenever the capture metadata is already on disk."""
    from nerfstudio_thermal_torch.process_data.eyeful_utils import (
        process_eyeful_capture,
    )

    s3 = f"s3://fb-baas-f32eacb9-8abb-11eb-b2b8-4857dd089e15/EyefulTower/{capture}/"
    capture_dir = save_dir / "eyefultower" / capture
    if not (capture_dir / "cameras.json").exists():
        print(
            f"EyefulTower capture metadata not found at {capture_dir}.\n"
            f"Download with: aws s3 sync --no-sign-request {s3} {capture_dir}\n"
            f"then re-run this command to generate transforms.json.",
            file=sys.stderr,
        )
        return 1
    dest = process_eyeful_capture(capture_dir, resolution=resolution)
    print(f"wrote {dest}")
    return 0


def _usage() -> str:
    fams = ", ".join(sorted({f.name for f in FAMILIES.values()}))
    return (
        "usage: ns-download-data-torch DATASET [--save-dir DIR] "
        "[--capture-name NAME] [--resolution-name NAME]\n"
        f"datasets: {fams}\n"
        "capture-name accepts 'all' (families with capture lists) and "
        "'nerfstudio-dataset' (the curated nerfstudio subset)."
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    name = argv[0]
    save_dir = Path("data")
    capture: Optional[str] = None
    resolution = "jpeg_2k"
    i = 1
    while i < len(argv):
        if argv[i].startswith("--save-dir"):
            save_dir = Path(argv[i].split("=", 1)[1] if "=" in argv[i] else argv[i + 1])
            i += 1 if "=" in argv[i] else 2
        elif argv[i].startswith("--capture-name"):
            capture = argv[i].split("=", 1)[1] if "=" in argv[i] else argv[i + 1]
            i += 1 if "=" in argv[i] else 2
        elif argv[i].startswith("--resolution-name"):
            resolution = argv[i].split("=", 1)[1] if "=" in argv[i] else argv[i + 1]
            i += 1 if "=" in argv[i] else 2
        else:
            i += 1
    if name not in FAMILIES:
        print(f"error: unknown dataset '{name}'\n{_usage()}", file=sys.stderr)
        return 2
    fam = FAMILIES[name]
    if fam.name == "eyefultower":
        return _eyefultower(save_dir, capture or "riverview", resolution)
    if capture == "all":
        if not fam.supports_all:
            print(f"error: {fam.name} has a single archive; omit --capture-name",
                  file=sys.stderr)
            return 2
        rc = 0
        for cap in fam.captures:
            rc = max(rc, download_capture(fam.name, cap, save_dir))
        return rc
    if capture == "nerfstudio-dataset" and fam.name == "nerfstudio":
        rc = 0
        for cap in NERFSTUDIO_DATASET_SUBSET:
            rc = max(rc, download_capture(fam.name, cap, save_dir))
        return rc
    return download_capture(fam.name, capture, save_dir)


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
