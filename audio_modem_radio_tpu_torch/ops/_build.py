"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
(no PyTorch headers): one ``nvcc -c`` per source, all started together,
then one link into a shared library that ``ctypes`` binds: every pointer
and the stream travel as ``c_void_p``. ``csrc/*.cuh`` holds code that more
than one source includes.

The library is named by a hash of the sources, the headers and the flags,
read through ``importlib.resources``, so the name is the same whether the
package is a directory, an installed wheel or a zip (``amr-torch.pyz``).
It is looked for, and loaded before any compiler is looked for, in

1. ``build/audio_modem_radio_tpu_torch/`` beside the package (where a tree
   builds it and where ``amr-torch.run`` ships it prebuilt), then
2. ``${XDG_CACHE_HOME:-~/.cache}/audio_modem_radio_tpu_torch/build/``.

Where neither holds it, it is built into the first of the two that is a
writable directory on disk (the cache for a zip or a read-only install),
from a copy of the sources in a work directory there; with no ``nvcc`` the
load raises, naming both places. A source change gives a new name, so the
first use after it rebuilds. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from importlib import resources
from pathlib import Path
from typing import List, Optional, Tuple

_PKG = "audio_modem_radio_tpu_torch"
_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"  # on disk only in a tree (the variant and SASS tools read it)
BUILD_DIR = _PKG_DIR.parent / "build" / _PKG_DIR.name
# ``-Xptxas -v`` changes no code: it reports each kernel's registers,
# shared memory and spills on stderr, which compile_library returns.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C entry points: (argtypes) -> int cudaError_t.
_SIGNATURES = {
    "amr_decide": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "amr_rotation_first": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P),
    "amr_relabel_pack": (_P, _P, _P, _P, _P, _I, _I, _P),
    "amr_bit_select_pack": (_P, _P, _P, _P, _P, _I, _I, _P),
    "amr_sector_first": (_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P),
    "amr_psk8_pack": (_P, _P, _P, _P, _I, _I, _P),
    "amr_fsk_tile": (_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    "amr_fsk_disc": (_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "amr_fsk_quad": (_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "amr_project_diff_batch": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "amr_project_diff": (_P, _I, _P, _P, _P, _I, _I, _P),
    "amr_neural_extract": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "amr_mlse_viterbi": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P),
    "amr_fec_viterbi": (_P, _I, _P, _P, _I, _I, _P),
    "amr_fsk_first": (_P, _I, _I, _U, _I, _P, _P),
    "amr_fsk_pack": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
    "amr_fsk_eq_bits": (_P, _P, _I, _I, _P, _P, _P),
    "amr_psk_pass1": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then PyTorch's idea of CUDA_HOME, then PATH."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dirs() -> Tuple[Path, Path]:
    """Where a built library is looked for, in order: beside the package,
    then ``${XDG_CACHE_HOME:-~/.cache}/audio_modem_radio_tpu_torch/build``."""
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return BUILD_DIR, Path(cache) / _PKG / "build"


def writable_dir(path: Path) -> bool:
    """Whether ``path`` is, or can be made, a directory on disk that this
    user can write: its nearest existing ancestor is a writable directory
    (inside a zip that ancestor is the zip file)."""
    while not path.exists():
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def _sources() -> List[Tuple[str, bytes]]:
    """(name, bytes) of every ``csrc/*.cu`` and ``csrc/*.cuh``, by name, read
    through ``importlib.resources`` (a directory and a zip alike)."""
    csrc = resources.files(_PKG).joinpath("csrc")
    return sorted((p.name, p.read_bytes()) for p in csrc.iterdir()
                  if p.name.endswith((".cu", ".cuh")) and p.is_file())


def library_name() -> str:
    h = hashlib.sha256()
    for name, blob in _sources():
        h.update(name.encode())
        h.update(blob)
    h.update(" ".join(NVCC_FLAGS).encode())
    return f"libamr_torch_{h.hexdigest()[:16]}.so"


def find(name: str) -> Optional[Path]:
    """Library ``name`` in the first of ``build_dirs()`` that holds it."""
    return next((d / name for d in build_dirs() if (d / name).is_file()), None)


def out_dir() -> Optional[Path]:
    """Where a library is built: the first of ``build_dirs()`` that is a
    writable directory on disk, or None."""
    return next((d for d in build_dirs() if writable_dir(d)), None)


def library_path() -> Path:
    """The kernel library found by name, else the path a build would write."""
    name = library_name()
    return find(name) or (out_dir() or BUILD_DIR) / name


def compile_library() -> Tuple[Path, str]:
    """The kernel library: found by name in ``build_dirs()``, else compiled
    there from a copy of the sources: one ``nvcc -c`` process per source,
    all running at once, then the link.

    Returns ``(path, nvcc_stderr)``, the stderr empty when the library was
    found; raises with nvcc's stderr on failure, and when there is no
    library, no writable place or no ``nvcc``.
    """
    name = library_name()
    found = find(name)
    if found is not None:
        return found, ""
    dirs = build_dirs()
    missing = f"no kernel library {name} in {dirs[0]} or in {dirs[1]}"
    where = out_dir()
    if where is None:
        raise RuntimeError(f"{missing}, and neither is a writable directory to build it in")
    try:
        nvcc = find_nvcc()
    except RuntimeError as e:
        raise RuntimeError(f"{missing}, and it cannot be built: {e}") from None
    out = where / name
    where.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=where) as work:
        # The sources written out (a zip's too): the .cuh files sit beside
        # the .cu files that include them.
        for src_name, blob in _sources():
            (Path(work) / src_name).write_bytes(blob)
        objs, procs = [], []
        for src in sorted(Path(work).glob("*.cu")):
            obj = str(src.with_suffix(".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = str(Path(work) / name)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    return out, "".join(logs) + proc.stderr


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = compile_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
