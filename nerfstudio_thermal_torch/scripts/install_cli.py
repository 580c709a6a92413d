"""ns-install-cli: install bash/zsh tab completion for the ns-*-torch commands
(counterpart of nerfstudio_thermal_tpu/scripts/install_cli.py).

    ns-install-cli-torch [--mode install|uninstall] [--shell bash|zsh]

Writes one completion script for the port's console scripts (`ns-*-torch`,
as pyproject.toml names them) with the JAX script's subcommand words and
the port's method registry, and sources it from the user's rc file inside
a marked block that a re-run replaces (reference
`nerfstudio/scripts/completions/install.py`). The block's header and
footer and the completions directory (~/.nerfstudio_thermal_torch/
completions) are the port's own, so installing or uninstalling one
package's completions never touches the other's.
"""

import sys
from pathlib import Path

HEADER = "# Source nerfstudio-thermal-torch autocompletions."
FOOTER = "# End nerfstudio-thermal-torch autocompletions."

ENTRY_POINTS = {
    "ns-train-torch": "methods",
    "ns-process-data-torch": "images video rgbt polycam record3d metashape realitycapture odm skydio",
    "ns-export-torch": "pointcloud tsdf poisson marching-cubes texture gaussian-splat cameras",
    "ns-eval-torch": "",
    "ns-render-torch": "camera-path interpolated spiral dataset",
    "ns-viewer-torch": "",
    "ns-download-data-torch": "",
}


def _method_names() -> str:
    from nerfstudio_thermal_torch.configs.method_configs import method_names

    return " ".join(sorted(method_names()))


def _bash_script() -> str:
    lines = []
    for cmd, subs in ENTRY_POINTS.items():
        words = _method_names() if subs == "methods" else subs
        fn = cmd.replace("-", "_")
        lines.append(
            f"""
_complete_{fn}() {{
  local cur=${{COMP_WORDS[COMP_CWORD]}}
  if [ $COMP_CWORD -eq 1 ]; then
    COMPREPLY=( $(compgen -W "{words}" -- "$cur") )
  else
    COMPREPLY=( $(compgen -f -- "$cur") )
  fi
}}
complete -F _complete_{fn} {cmd}"""
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "install"
    shells = ["bash", "zsh"]
    i = 0
    while i < len(argv):
        if argv[i] == "--mode":
            mode = argv[i + 1]
            i += 2
        elif argv[i] == "--shell":
            shells = [argv[i + 1]]
            i += 2
        elif argv[i] in ("-h", "--help"):
            print("usage: ns-install-cli-torch [--mode install|uninstall] [--shell bash|zsh]")
            return 0
        else:
            print(f"error: unknown flag {argv[i]}", file=sys.stderr)
            return 2

    comp_dir = Path.home() / ".nerfstudio_thermal_torch" / "completions"
    comp_dir.mkdir(parents=True, exist_ok=True)
    script_path = comp_dir / "setup.bash"

    for shell in shells:
        rc = Path.home() / (".bashrc" if shell == "bash" else ".zshrc")
        text = rc.read_text() if rc.exists() else ""
        # strip any previous block of this package (idempotent, reference install.py:214-246)
        if HEADER in text:
            pre, _, rest = text.partition(HEADER)
            _, _, post = rest.partition(FOOTER)
            text = pre + post.lstrip("\n")
        if mode == "install":
            script_path.write_text(_bash_script())
            text = text.rstrip("\n") + f"\n\n{HEADER}\nsource {script_path}\n{FOOTER}\n"
            print(f"installed completions for {shell} (source {rc})")
        else:
            print(f"removed completions from {rc}")
        rc.write_text(text)
    return 0


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
