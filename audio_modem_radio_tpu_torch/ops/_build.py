"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
(no PyTorch headers): one ``nvcc -c`` per source, all started together,
then one link into a shared library that ``ctypes`` binds: every pointer
and the stream travel as ``c_void_p``. ``csrc/*.cuh`` holds code that more
than one source includes. The library lands in
``build/audio_modem_radio_tpu_torch/`` beside the package, named by a hash
of the sources, the headers and the flags, so the first use after a source change rebuilds
it and later uses load it. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / _PKG_DIR.name
# ``-Xptxas -v`` changes no code: it reports each kernel's registers,
# shared memory and spills on stderr, which compile_library returns.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
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
    "amr_neural_extract": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
    "amr_mlse_viterbi": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P),
    "amr_fec_viterbi": (_P, _I, _P, _P, _I, _I, _P),
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


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(_sources() + list(SRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libamr_torch_{h.hexdigest()[:16]}.so"


def compile_library() -> Tuple[Path, str]:
    """Compile ``csrc/*.cu`` into the hashed library path if it is missing:
    one ``nvcc -c`` process per source, all running at once, then the link.

    Returns ``(path, nvcc_stderr)``, the stderr empty when the library was
    already built; raises with nvcc's stderr on failure.
    """
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in _sources():
            obj = str(Path(work) / f"{src.stem}.o")
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
        tmp = str(Path(work) / out.name)
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
