"""The port's distribution: ``amr-torch.pyz`` against the JAX package's
``amr-tpu.pyz``, the kernel and native libraries' loaders inside a zip
and under a read-only package parent, and the self-extracting
``amr-torch.run`` (a probe bundle, the staged layout, the library closure).

Everything runs on the CPU: the decodes take ``--device cpu``, and where a
kernel library is needed a stand-in file takes its place (this host has no
``nvcc``); ``chip_smoke.py`` phase 5u builds and runs the real artifacts
on the card."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_modem_radio_tpu_torch import native
from audio_modem_radio_tpu_torch.ops import _build
from audio_modem_radio_tpu_torch.tools import build_dist, build_standalone

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import build_dist as jax_build_dist  # noqa: E402  (the JAX package's amr-tpu.pyz)

PKG = "audio_modem_radio_tpu_torch"
_QPSK = ["--mode", "QPSK", "--symbol-rate", "4800"]

# What the probe interpreter prints from inside a zip: the libraries'
# names and paths as the loaders compute them there.
_ZIP_PROBE = f"""
import json, sys
sys.path.insert(0, sys.argv[1])
import {PKG}
from {PKG} import native
from {PKG}.ops import _build
print(json.dumps({{"package": {PKG}.__file__, "kernel_name": _build.library_name(),
                  "kernel_path": str(_build.library_path()), "native_name": native.library_name(),
                  "native_path": str(native.library_path())}}))
"""

_PROBE_CLI = """\
import sys, zlib
print("AMR_PROBE_OK", sys.version_info[0], sys.version_info[1])
print("PREFIX", sys.prefix)
print("ZLIB", zlib.crc32(b"amr"))
"""


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
    env.update(extra)
    return env


def _run(argv, cwd, env, timeout=300) -> subprocess.CompletedProcess:
    return subprocess.run(argv, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def _saved(proc: subprocess.CompletedProcess, cwd: pathlib.Path) -> list:
    """The bytes of each file a ``decode-wav`` saved (the lines after its count)."""
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines and lines[0].endswith(": 1 file(s)"), proc.stdout
    return [(cwd / p).read_bytes() for p in lines[1:]]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both zipapps, a QPSK@4800 WAV of a seeded 20,000-byte file written by
    the port's zipapp and decoded by both, the loaders' view from inside the
    zip, and the probe ``.run``."""
    root = tmp_path_factory.mktemp("dist")
    out = {"root": root}
    out["pyz"] = pathlib.Path(build_dist.build_pyz(str(root)))
    out["jax_pyz"] = pathlib.Path(jax_build_dist.build_pyz(str(root)))
    xdg = root / "xdg"
    env = _env(XDG_CACHE_HOME=str(xdg))
    out["xdg"] = xdg

    work = root / "work"
    work.mkdir()
    data = np.random.default_rng(19).integers(0, 256, 20000, dtype=np.uint8).tobytes()
    (work / "f.bin").write_bytes(data)
    out["data"] = data
    enc = _run([sys.executable, str(out["pyz"]), "encode-file", "f.bin", *_QPSK], work, env)
    assert enc.returncode == 0, enc.stderr
    wav = enc.stdout.splitlines()[-1]
    assert wav.endswith(".wav")
    port_dir, jax_dir = root / "port_recv", root / "jax_recv"
    port_dir.mkdir()
    jax_dir.mkdir()
    out["port_decode"] = _run([sys.executable, str(out["pyz"]), "decode-wav", str(work / wav), *_QPSK,
                               "--device", "cpu"], port_dir, env)
    out["jax_decode"] = _run([sys.executable, str(out["jax_pyz"]), "decode-wav", str(work / wav), *_QPSK],
                             jax_dir, _env(JAX_PLATFORMS="cpu"))
    out["port_dir"], out["jax_dir"] = port_dir, jax_dir

    zip_view = _run([sys.executable, "-c", _ZIP_PROBE, str(out["pyz"])], root, env)
    assert zip_view.returncode == 0, zip_view.stderr
    out["zip_view"] = json.loads(zip_view.stdout.splitlines()[-1])

    def hook(stage, sp):
        pathlib.Path(sp, "amr_probe_cli.py").write_text(_PROBE_CLI)

    out["run"] = pathlib.Path(build_standalone.build_standalone(
        str(root / "probe.run"), deps=(), entry="amr_probe_cli", include_app=False, stage_hook=hook))
    return out


def test_zipapp_decodes_the_bytes_the_jax_zipapp_decodes(built):
    """The port's ``amr-torch.pyz`` saves the input's bytes from the WAV it
    wrote, as the JAX package's ``amr-tpu.pyz`` does from the same WAV (the
    port's zipapp once saved 0 files: its native loader raised inside the
    zip), and its native library was built into the user cache."""
    port = _saved(built["port_decode"], built["port_dir"])
    jax = _saved(built["jax_decode"], built["jax_dir"])
    assert port == jax == [built["data"]]
    cache = built["xdg"] / PKG / "build"
    assert (cache / native.library_name()).is_file()


def test_library_names_do_not_depend_on_zip_or_directory(built):
    view = built["zip_view"]
    assert view["package"].startswith(str(built["pyz"]) + os.sep)
    assert view["kernel_name"] == _build.library_name() == _build.library_path().name
    assert view["native_name"] == native.library_name() == native.library_path().name


def test_library_paths_inside_a_zip_point_to_the_user_cache(built):
    """``library_path()`` does not raise inside a zip; the zip is no
    directory to build in, so both libraries' places are the user cache."""
    view = built["zip_view"]
    cache = built["xdg"] / PKG / "build"
    assert view["kernel_path"] == str(cache / view["kernel_name"])
    assert view["native_path"] == str(cache / view["native_name"])


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """The two build directories moved under ``tmp_path``: (beside, cache)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "site" / "build" / PKG)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    beside, cache = _build.build_dirs()
    assert cache == tmp_path / "xdg" / PKG / "build"
    return beside, cache


def _no_compiler(*_, **__):
    raise AssertionError("a compiler was looked for")


@pytest.mark.parametrize("where", ["beside", "cache", "both"])
def test_library_found_by_name_is_returned_without_a_compiler(where, dirs, monkeypatch):
    beside, cache = dirs
    tree = REPO / "build" / PKG  # the tree's native library, built with either flag set
    real = next((tree / n for n in map(native.library_name, native._FLAG_SETS) if (tree / n).is_file()), None)
    real = real or native.build_library(tree)
    assert real is not None
    monkeypatch.setattr(_build, "find_nvcc", _no_compiler)
    monkeypatch.setattr(native, "build_library", _no_compiler)
    name = _build.library_name()
    places = {"beside": [beside], "cache": [cache], "both": [beside, cache]}[where]
    for d in places:
        d.mkdir(parents=True)
        (d / name).write_bytes(b"stand-in")
    assert _build.compile_library() == (places[0] / name, "")
    assert _build.library_path() == places[0] / name
    # The native library, found by name, is loaded and bound.
    (places[-1] / real.name).write_bytes(real.read_bytes())
    lib = native._load()
    assert lib and lib._name == str(places[-1] / real.name)
    assert native.crc32_prefix_find(b"abc", 0x352441C2) == 3


def test_native_names_follow_the_flag_set_and_the_cpu(dirs, monkeypatch):
    """Each flag set names its own native library, the ``-march=native`` one
    by this CPU too: the portable library is found under its own name, this
    host's build before it, and a build for another CPU in a shared cache
    is not this host's by name."""
    beside, cache = dirs
    portable, here = native.library_name(native.PORTABLE_FLAGS), native.library_name()
    assert portable != here
    cache.mkdir(parents=True)
    (cache / portable).write_bytes(b"portable")
    assert native.library_path() == cache / portable
    (cache / here).write_bytes(b"this host")
    assert native.library_path() == cache / here
    monkeypatch.setattr(native, "_cpu", lambda: b"model name\t: another CPU")
    assert native.library_name() != here and native.library_name(native.PORTABLE_FLAGS) == portable
    assert native.library_path() == cache / portable


def test_no_library_and_no_compiler_raises_naming_both_places(dirs, monkeypatch):
    beside, cache = dirs

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    for load in (_build.compile_library, _build.load_library):
        with pytest.raises(RuntimeError) as e:
            load()
        assert str(beside) in str(e.value) and str(cache) in str(e.value) and "nvcc not found" in str(e.value)
    assert _build._lib is None


_FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: every '#include "x"' of a source must sit beside it.
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
if [ -n "$src" ]; then
  for inc in $(sed -n 's/^#include "\\(.*\\)"/\\1/p' "$src"); do
    [ -f "$(dirname "$src")/$inc" ] || { echo "missing $inc beside $src" >&2; exit 1; }
  done
fi
echo built > "$out"
"""


def test_read_only_package_parent_builds_in_the_user_cache(dirs, tmp_path, monkeypatch):
    """With the package's parent not writable (the writability check made
    to say so: the tests run as root), the kernel library builds into the
    user cache from a copy of the sources, the ``.cuh`` files beside the
    ``.cu`` files, and the native library too."""
    beside, cache = dirs
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    site = beside.parent.parent
    monkeypatch.setattr(_build, "writable_dir", lambda p: not str(p).startswith(str(site)))
    path, _ = _build.compile_library()
    assert path == cache / _build.library_name() and path.read_text() == "built\n"
    assert sorted(p.name for p in cache.iterdir()) == [path.name]  # the work directory is gone
    assert not site.exists()
    assert native.library_path() == cache / native.library_name()
    assert native.available() and native._lib._name == str(cache / native.library_name())
    assert not site.exists()


def _probe_run(path: pathlib.Path, home: pathlib.Path, **extra) -> subprocess.CompletedProcess:
    env = {"HOME": str(home), "PATH": "/usr/bin:/bin", **extra}  # sh, tar, gzip, awk: no Python
    return subprocess.run([str(path)], capture_output=True, text=True, timeout=300, env=env)


def test_probe_run_runs_without_host_python(built, tmp_path):
    res = _probe_run(built["run"], tmp_path)
    assert res.returncode == 0, res.stderr
    assert f"AMR_PROBE_OK {sys.version_info[0]} {sys.version_info[1]}" in res.stdout
    import zlib

    assert f"ZLIB {zlib.crc32(b'amr')}" in res.stdout
    prefix = [ln for ln in res.stdout.splitlines() if ln.startswith("PREFIX ")][0].split(" ", 1)[1]
    assert prefix.startswith(str(tmp_path / ".cache" / "amr-torch-standalone") + os.sep)


def test_probe_run_reuses_its_prefix_and_honours_amr_torch_home(built, tmp_path):
    first = _probe_run(built["run"], tmp_path)
    assert first.returncode == 0, first.stderr
    cache = tmp_path / ".cache" / "amr-torch-standalone"
    entries = sorted(os.listdir(cache))
    assert len(entries) == 1 and not entries[0].startswith(".extract")
    second = _probe_run(built["run"], tmp_path)
    assert second.returncode == 0 and "AMR_PROBE_OK" in second.stdout
    assert sorted(os.listdir(cache)) == entries  # digest-keyed reuse, no second extraction
    home = tmp_path / "elsewhere"
    third = _probe_run(built["run"], tmp_path, AMR_TORCH_HOME=str(home))
    assert third.returncode == 0 and f"PREFIX {home / entries[0]}" in third.stdout


def test_staged_layout_puts_the_libraries_where_the_loaders_look(tmp_path, monkeypatch):
    """``stage_port``: the sources, the codebook and the native source in the
    staged package; the kernel library (a stand-in here) and the native
    library, built with the portable flags, under the names and in the
    place the loaders compute inside the bundle."""
    stand_in = tmp_path / "libamr_torch_host.so"
    stand_in.write_bytes(b"stand-in kernels")
    monkeypatch.setattr(_build, "compile_library", lambda: (stand_in, ""))
    flags_used = []

    def build_library(out_dir, flag_sets=None):
        flags_used.append(flag_sets)
        out = out_dir / native.library_name(flag_sets[0])
        out.write_bytes(b"stand-in native")
        return out

    monkeypatch.setattr(native, "build_library", build_library)
    sp = tmp_path / "site-packages"
    sp.mkdir()
    kernel_lib, native_lib = build_standalone.stage_port(str(sp))
    assert flags_used == [(native.PORTABLE_FLAGS,)] and "-march=native" not in native.PORTABLE_FLAGS
    assert native_lib.name == native.library_name(native.PORTABLE_FLAGS) != native.library_name()
    pkg = sp / PKG
    tree = sorted(p.name for p in (REPO / PKG / "csrc").iterdir() if p.suffix in (".cu", ".cuh"))
    assert sorted(p.name for p in (pkg / "csrc").iterdir() if p.suffix in (".cu", ".cuh")) == tree
    assert (pkg / "data" / "neural_codebook.npz").read_bytes() == (REPO / PKG / "data" / "neural_codebook.npz").read_bytes()
    assert (pkg / "native" / "amr_native.cpp").is_file() and not list(pkg.rglob("__pycache__"))
    assert sorted(p.name for p in (sp / "build" / PKG).iterdir()) == sorted([kernel_lib.name, native_lib.name])
    assert kernel_lib.read_bytes() == b"stand-in kernels"
    # The staged package's own loaders find both where they were put.
    view = _run([sys.executable, "-c", _ZIP_PROBE, str(sp)], tmp_path, _env(XDG_CACHE_HOME=str(tmp_path / "xdg")))
    assert view.returncode == 0, view.stderr
    got = json.loads(view.stdout.splitlines()[-1])
    assert got["package"].startswith(str(pkg))
    assert (got["kernel_path"], got["native_path"]) == (str(kernel_lib), str(native_lib))


def test_no_kernels_no_artifact(tmp_path, monkeypatch):
    def no_kernels():
        raise RuntimeError("no kernel library, and it cannot be built: nvcc not found")

    monkeypatch.setattr(_build, "compile_library", no_kernels)
    out = tmp_path / "amr-torch.run"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_standalone.build_standalone(str(out), deps=())
    assert list(tmp_path.iterdir()) == []


# ``ldd`` of a kernel-using binary on a CUDA host, as recorded: glibc, the
# driver's libraries, and the libraries the bundle must carry.
_LDD = """\
\tlinux-vdso.so.1 (0x00007ffc3b5f2000)
\tlibcuda.so.1 => /usr/lib/x86_64-linux-gnu/libcuda.so.1 (0x00007f2a1c000000)
\tlibnvidia-ml.so.1 => /usr/lib/x86_64-linux-gnu/libnvidia-ml.so.1 (0x00007f2a1b000000)
\tlibstdc++.so.6 => /lib/x86_64-linux-gnu/libstdc++.so.6 (0x00007f2a1ac00000)
\tlibm.so.6 => /lib/x86_64-linux-gnu/libm.so.6 (0x00007f2a1ab19000)
\tlibgcc_s.so.1 => /lib/x86_64-linux-gnu/libgcc_s.so.1 (0x00007f2a1aaf9000)
\tlibz.so.1 => /lib/x86_64-linux-gnu/libz.so.1 (0x00007f2a1aadd000)
\tlibcudart.so.12 => /home/user/venv/lib/python3.12/site-packages/torch/lib/../../nvidia/cuda_runtime/lib/libcudart.so.12 (0x00007f2a1a800000)
\tlibdl.so.2 => /lib/x86_64-linux-gnu/libdl.so.2 (0x00007f2a1aad8000)
\tlibpthread.so.0 => /lib/x86_64-linux-gnu/libpthread.so.0 (0x00007f2a1aad3000)
\trt.so.1 => not found
\tlibc.so.6 => /lib/x86_64-linux-gnu/libc.so.6 (0x00007f2a1a600000)
\t/lib64/ld-linux-x86-64.so.2 (0x00007f2a1c9a0000)
"""


def test_closure_leaves_out_glibc_and_the_driver():
    got = dict(build_standalone.ldd_libraries(_LDD))
    assert sorted(got) == ["libcudart.so.12", "libgcc_s.so.1", "libstdc++.so.6", "libz.so.1"]
    assert got["libz.so.1"] == "/lib/x86_64-linux-gnu/libz.so.1"


def test_dependency_closure_is_torch_numpy_scipy_and_their_requirements():
    """From ``importlib.metadata``: the roots, their requirements (here
    e.g. sympy and its mpmath), no optional extra, no triton or jax."""
    names = build_standalone.dependency_closure()
    for name in ("torch", "numpy", "scipy", "sympy", "mpmath", "typing_extensions"):
        assert name in names
    for name in ("triton", "jax", "jaxlib", "pytest", "hypothesis"):
        assert name not in names
    with pytest.raises(RuntimeError, match="not installed"):
        build_standalone.dependency_closure(roots=("no-such-distribution-here",))


class _Dist:
    """A stand-in ``importlib.metadata.Distribution``: requirements and a
    ``top_level.txt``."""

    def __init__(self, requires, top_level=None):
        self.requires, self._top, self.files = requires, top_level, ()

    def read_text(self, name):
        return self._top if name == "top_level.txt" else None


def test_requirements_follow_the_extras_asked_for():
    """torch asks ``cuda-toolkit[cublas,...]``: the extras asked of a
    distribution bring their requirements, other extras do not; a
    ``top_level.txt`` line ``nvidia/cusparselt`` is the ``nvidia`` package."""
    dist = _Dist(["a", 'b>=1; extra == "x"', 'c; extra == "y"',
                  'cuda-toolkit[cublas,cudart]==12.8.1; platform_system == "Linux"',
                  'e[q] ; python_version >= "3.9" and extra == "x"'])
    assert build_standalone._requirements(dist) == [("a", ()), ("cuda-toolkit", ("cublas", "cudart"))]
    assert build_standalone._requirements(dist, ("x",)) == [
        ("a", ()), ("b", ()), ("cuda-toolkit", ("cublas", "cudart")), ("e", ("q",))]
    assert build_standalone._top_level(_Dist([], "nvidia/cusparselt\nnvidia\n")) == ["nvidia"]


def test_parts_share_the_stage_by_size_and_leave_out_tests_headers_archives(tmp_path):
    """The archive's parts: every directory in the first, each file once,
    the largest files spread over the parts, links followed, and tests,
    C headers and static libraries left out."""
    stage, elsewhere = tmp_path / "stage", tmp_path / "elsewhere"
    (stage / "lib" / "site").mkdir(parents=True)
    (elsewhere / "tests").mkdir(parents=True)
    (elsewhere / "tests" / "t.py").write_text("x")
    (elsewhere / "api.h").write_text("x")
    (elsewhere / "big.so").write_bytes(b"\0" * 9000)
    (stage / "lib" / "site" / "dep").symlink_to(elsewhere, target_is_directory=True)
    (stage / "lib" / "libz.a").write_bytes(b"x")
    for i in range(12):
        (stage / "lib" / f"f{i}.py").write_bytes(b"\0" * (100 * (i + 1)))
    parts = build_standalone._parts(str(stage))
    assert len(parts) == build_standalone._PARTS
    rel = [[os.path.relpath(p, stage) for p in part] for part in parts]
    dirs = ["lib", os.path.join("lib", "site"), os.path.join("lib", "site", "dep")]
    assert rel[0][:3] == dirs
    files = sorted(p for part in rel for p in part if p not in dirs)
    assert files == sorted([os.path.join("lib", "site", "dep", "big.so")] + [os.path.join("lib", f"f{i}.py") for i in range(12)])
    sizes = sorted(sum(os.path.getsize(p) for p in part if os.path.isfile(p)) for part in parts)
    assert sizes[-1] == 9000 and sizes[0] >= 1000  # the largest file alone; the rest spread out
