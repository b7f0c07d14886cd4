"""Build the port's distribution artifacts: the wheel and ``amr-torch.pyz``.

* The wheel (``pip wheel`` of the repository): both packages, the
  ``amr-torch*`` console scripts, and the port's CUDA sources, C++ source
  and NEURAL codebook as package data. Installed, the kernels build at
  first use beside the package or, where site-packages is read-only, in the
  user cache (``ops/_build.py``).
* ``amr-torch.pyz``: a stdlib ``zipapp`` of the port whose ``__main__``
  runs ``audio_modem_radio_tpu_torch.cli:main``. It runs with any Python
  that has torch, numpy and scipy (``python3 amr-torch.pyz decode-wav
  X.wav``). Its kernels and native library build from the zip's sources at
  first use into ``${XDG_CACHE_HOME:-~/.cache}/audio_modem_radio_tpu_torch/build/``,
  and later runs load them from there.

Usage (from a checkout)::

    python -m audio_modem_radio_tpu_torch.tools.build_dist [--out dist/]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import zipapp

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG_DIR)
PKG = os.path.basename(PKG_DIR)

_MAIN = f"""import sys

from {PKG}.cli import main

sys.exit(main())
"""


def build_wheel(out_dir: str) -> str:
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "-w", out_dir, REPO],
        check=True,
    )
    wheels = [f for f in os.listdir(out_dir) if f.endswith(".whl")]
    return os.path.join(out_dir, sorted(wheels)[-1])


def build_pyz(out_dir: str) -> str:
    target = os.path.join(out_dir, "amr-torch.pyz")
    with tempfile.TemporaryDirectory() as stage:
        shutil.copytree(PKG_DIR, os.path.join(stage, PKG),
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
        with open(os.path.join(stage, "__main__.py"), "w") as f:
            f.write(_MAIN)
        zipapp.create_archive(stage, target, interpreter="/usr/bin/env python3")
    return target


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(REPO, "dist"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(f"wheel: {build_wheel(args.out)}")
    print(f"pyz:   {build_pyz(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
