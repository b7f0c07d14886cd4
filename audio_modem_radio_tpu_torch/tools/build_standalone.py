"""Build ``amr-torch.run``: the port as one self-extracting executable that
decodes on the card on a host without Python, the CUDA toolkit or a
compiler, taking from the host only the NVIDIA driver and glibc (as new as
the building host's, at least).

The counterpart of the JAX package's ``amr-tpu.run`` builder, with the
port's own copy of its runtime bundling (the ``ldd`` closure, the
interpreter and standard library, the dependency copy, the launcher). The
artifact carries:

* the CPython interpreter, ``libpython`` and the standard library;
* ``torch`` and its import closure, read from ``importlib.metadata``'s
  requirements (optional extras, ``triton`` and ``jax`` left out: the port
  has no Triton kernel), which takes in the CUDA libraries that torch's
  ``$ORIGIN`` rpaths reach (the ``nvidia`` namespace package of a pip
  install); ``numpy`` and ``scipy``; each checked by importing it inside
  the bundle;
* the port's package, with ``csrc/``, ``data/neural_codebook.npz`` and
  ``native/amr_native.cpp``;
* the kernel library, compiled on the building host for ``sm_90a`` by
  ``ops/_build.compile_library()``, and the native library, compiled with
  the portable flags (not ``-march=native``), both in
  ``site-packages/build/audio_modem_radio_tpu_torch/`` under the names
  their loaders compute there, so the target needs no CUDA toolkit and no
  compiler;
* in ``lib/``, the shared libraries that the interpreter, ``lib-dynload``,
  ``torch/lib/*.so`` and both libraries link and the bundle does not
  already hold (``libstdc++``, ``libgcc_s``, ``libz``, ...), less glibc and
  the driver's own libraries (``libcuda.so*``, ``libnvidia-*``): those two
  come from the host.

Mechanics (the makeself pattern): a short ``sh`` launcher, padded to
``_HEADER`` bytes, ends at an ``__ARCHIVE__`` line, and the bytes after it
are ``_PARTS`` whole ``tar.gz`` archives (gzip level ``_LEVEL``) of a
relocatable prefix, its files shared out by size (the launcher lists each
part's offset and length).
The first run extracts them at once, one ``gzip -dc | tar -x`` each (one
gzip inflates some 100 MB/s, and a prefix holds gigabytes), into
``${AMR_TORCH_HOME:-${XDG_CACHE_HOME:-$HOME/.cache}/amr-torch-standalone}/<sha256[:16]>``
through a temporary directory renamed into place, so an interrupted or
concurrent extraction never leaves a partial prefix; later runs reuse it.
The launcher runs the bundled interpreter on ``audio_modem_radio_tpu_torch.cli``
with ``PYTHONHOME`` and ``LD_LIBRARY_PATH`` in the prefix and ``-s`` (a
user site-packages could otherwise shadow the bundled torch).

A host that cannot build the kernel library gets no artifact:
``build_standalone`` raises.

Usage (from a checkout, on a host with torch for CUDA, ``nvcc`` and ``g++``)::

    python -m audio_modem_radio_tpu_torch.tools.build_standalone [--out dist/]
"""

from __future__ import annotations

import argparse
import collections
import fnmatch
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tarfile
import tempfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from importlib import metadata
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
PKG = PKG_DIR.name
ENTRY = f"{PKG}.cli"
# The distributions whose import closure the bundle carries, and those it
# leaves out of it.
ROOTS = ("torch", "numpy", "scipy")
LEFT_OUT = frozenset({"triton", "jax", "jaxlib"})
_SHORT = f"python{sys.version_info[0]}.{sys.version_info[1]}"

# glibc: it must come from the target host (bundling ld-linux and libc is
# where a portable prefix becomes a container).
_GLIBC = (
    "libc.so", "libm.so", "libdl.so", "libpthread.so", "librt.so",
    "libutil.so", "libresolv.so", "libnsl.so", "ld-linux",
    "linux-vdso", "libmvec.so",
)
# The NVIDIA driver's own libraries: they match the host's kernel module,
# so they come from the host as glibc does.
_DRIVER = ("libcuda.so", "libnvidia-")

_LAUNCHER = """#!/bin/sh
# amr-torch standalone executable (self-extracting; built by
# audio_modem_radio_tpu_torch/tools/build_standalone.py). Everything after
# __ARCHIVE__ is tar.gz parts of a prefix with a bundled CPython, torch and
# the port with its prebuilt kernels.
set -e
SUM=%(digest)s
PYBIN=%(pybin)s
ENTRY=%(entry)s
HEADER=%(header)d
PARTS="%(parts)s"
BASE="${AMR_TORCH_HOME:-${XDG_CACHE_HOME:-$HOME/.cache}/amr-torch-standalone}"
DIR="$BASE/$SUM"
if [ ! -x "$DIR/bin/$PYBIN" ]; then
    TMP="$BASE/.extract.$$"
    mkdir -p "$TMP"
    PIDS=""
    for PART in $PARTS; do
        tail -c +$((HEADER + ${PART%%:*} + 1)) "$0" | head -c "${PART#*:}" | gzip -dc | tar -xf - -C "$TMP" &
        PIDS="$PIDS $!"
    done
    for PID in $PIDS; do
        wait "$PID" || { rm -rf "$TMP"; echo "$0: extraction failed" >&2; exit 1; }
    done
    # $DIR only ever appears by rename, so an interrupted or concurrent
    # extraction never leaves a partial prefix (the loser of a race drops
    # its tree; -T: never move it into a $DIR that exists).
    mv -T "$TMP" "$DIR" 2>/dev/null || rm -rf "$TMP"
fi
export PYTHONHOME="$DIR"
export LD_LIBRARY_PATH="$DIR/lib${LD_LIBRARY_PATH:+:$LD_LIBRARY_PATH}"
exec "$DIR/bin/$PYBIN" -s -m "$ENTRY" "$@"
"""
_HEADER = 4096  # bytes of launcher before the first part
_PARTS = 8  # tar.gz parts, extracted at once
# Left out of the archive wherever they occur.
_LEFT_OUT = ("tests", "*.h", "*.pxd", "*.a")
_CHUNK = 32 << 20  # bytes of tar stream per gzip member
_LEVEL = 1  # gzip level: the prefix is gigabytes of CUDA fat binaries


def ldd_libraries(ldd_text: str) -> List[Tuple[str, str]]:
    """(name, path) of each library that ``ldd`` resolved, less glibc and
    the NVIDIA driver's libraries."""
    out = []
    for line in ldd_text.splitlines():
        if "=>" not in line:
            continue
        name, _, rest = line.strip().partition(" => ")
        path = rest.split(" (")[0].strip()
        if not path.startswith("/"):  # "not found"
            continue
        if any(g in name for g in _GLIBC) or name.startswith(_DRIVER):
            continue
        out.append((name, path))
    return out


def _ldd_closure(binaries: Iterable[str], shipped: Sequence[str] = ()) -> Dict[str, str]:
    """Name -> real path of the libraries that ``binaries`` link, less glibc,
    the driver's libraries and those under a ``shipped`` directory (the
    bundle holds them already)."""
    roots = tuple(os.path.join(os.path.realpath(d), "") for d in shipped)
    env = {k: v for k, v in os.environ.items() if k != "LD_LIBRARY_PATH"}
    out: Dict[str, str] = {}
    for b in binaries:
        try:  # resolved as the launcher's process resolves them: no LD_LIBRARY_PATH of this host
            txt = subprocess.run(["ldd", b], capture_output=True, text=True, timeout=60, env=env).stdout
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
        for name, path in ldd_libraries(txt):
            real = os.path.realpath(path)
            if os.path.exists(real) and not real.startswith(roots):
                out.setdefault(os.path.basename(path), real)
    return out


def _run_bundled(stage: str, pyname: str, *args: str) -> subprocess.CompletedProcess:
    """The bundled interpreter, isolated from this environment (``-I``: it
    finds its prefix from its own path, and reads no host site-packages),
    writing no bytecode (``-B``: the stage's dependencies are links to this
    host's)."""
    env = {"PATH": "/usr/bin:/bin", "LD_LIBRARY_PATH": os.path.join(stage, "lib")}
    return subprocess.run([os.path.join(stage, "bin", pyname), "-I", "-B", *args],
                          capture_output=True, text=True, env=env, timeout=600)


def _copy_runtime(stage: str) -> Tuple[str, str]:
    """Bundle the interpreter, the standard library and the libraries they
    link; returns the interpreter's file name and the site-packages
    directory the bundled interpreter reads (``site-packages``, or
    ``dist-packages`` for a Debian Python)."""
    pybin = os.path.realpath(sys.executable)
    pyname = os.path.basename(pybin)
    os.makedirs(os.path.join(stage, "bin"))
    os.makedirs(os.path.join(stage, "lib"))
    shutil.copy2(pybin, os.path.join(stage, "bin", pyname))

    stdlib = sysconfig.get_paths()["stdlib"]  # the base prefix's, not a venv's
    # A system Python may keep packages inside its stdlib directory: the
    # dependencies bring those the bundle needs. The bytecode stays: it is
    # this interpreter's, and spares the first run compiling it.
    shutil.copytree(
        stdlib, os.path.join(stage, "lib", _SHORT),
        ignore=shutil.ignore_patterns("test", "idlelib", "ensurepip", "config-3*", "site-packages", "dist-packages"),
        symlinks=False, ignore_dangling_symlinks=True,
    )
    dynload = os.path.join(stdlib, "lib-dynload")
    ext_sos = [os.path.join(dynload, f) for f in os.listdir(dynload)] if os.path.isdir(dynload) else []
    for name, path in _ldd_closure([pybin] + ext_sos).items():
        shutil.copy2(path, os.path.join(stage, "lib", name))

    proc = _run_bundled(stage, pyname, "-c", "import site; print('\\n'.join(site.getsitepackages()))")
    if proc.returncode != 0:
        raise RuntimeError(f"the bundled interpreter does not start:\n{proc.stderr}")
    inside = [p for p in proc.stdout.split() if p.startswith(os.path.join(stage, ""))]
    if not inside:
        raise RuntimeError(f"the bundled interpreter reads no site-packages in {stage}: {proc.stdout}")
    sp = next((p for p in inside if os.path.dirname(p) == os.path.join(stage, "lib", _SHORT)), inside[0])
    os.makedirs(sp, exist_ok=True)
    return pyname, sp


def _canonical(name: str) -> str:
    return re.sub(r"[-_.]+", "-", name).lower()


def _requirements(dist: metadata.Distribution, extras: Iterable[str] = ()) -> List[Tuple[str, Tuple[str, ...]]]:
    """(name, extras) of each distribution ``dist`` requires: its plain
    requirements and those of the optional ``extras`` asked of it (torch
    asks ``cuda-toolkit[cublas,...]``), no other extra's."""
    out = []
    for req in dist.requires or ():
        spec, _, marker = req.partition(";")
        wanted = re.findall(r"""extra\s*==\s*["']([^"']+)["']""", marker)
        if wanted and not set(wanted) & set(extras):
            continue
        m = re.match(r"\s*([A-Za-z0-9._-]+)\s*(?:\[([^\]]*)\])?", spec)
        out.append((m.group(1), tuple(e.strip() for e in (m.group(2) or "").split(",") if e.strip())))
    return out


def _top_level(dist: metadata.Distribution) -> List[str]:
    """The import names a distribution installs (``nvidia/cublas`` in a
    ``top_level.txt`` is the ``nvidia`` namespace package)."""
    text = dist.read_text("top_level.txt")
    if text:
        tops = [t.strip().split("/")[0] for t in text.split() if t.strip()]
        return list(dict.fromkeys(tops))
    tops: List[str] = []
    for f in dist.files or ():
        first = f.parts[0]
        if first in ("..", "__pycache__") or first.endswith((".dist-info", ".data", ".libs", ".pth")):
            continue
        if len(f.parts) == 1:
            if not first.endswith((".py", ".so")):
                continue
            first = first.split(".")[0]
        if first not in tops:
            tops.append(first)
    return tops


def dependency_closure(roots: Sequence[str] = ROOTS, left_out=LEFT_OUT) -> List[str]:
    """Import names of ``roots`` and of their requirements, recursively,
    from ``importlib.metadata``: other extras than those asked for and
    ``left_out`` are left out, and so is a requirement that is not
    installed here (its marker excludes this host). Raises when a root is
    not installed."""
    left = {_canonical(n) for n in left_out}
    seen, queue, names = set(), [(r, ()) for r in roots], []
    while queue:
        dist_name, extras = queue.pop(0)
        key = (_canonical(dist_name), extras)
        if key in seen or key[0] in left:
            continue
        seen.add(key)
        try:
            dist = metadata.distribution(dist_name)
        except metadata.PackageNotFoundError:
            if dist_name in roots:
                raise RuntimeError(f"{dist_name} is not installed: the bundle needs it") from None
            continue
        names.extend(t for t in _top_level(dist) if t not in names)
        queue.extend(_requirements(dist, extras))
    return names


def _locate(name: str) -> str:
    """Where import name ``name`` lives in this environment."""
    import importlib.util

    spec = importlib.util.find_spec(name)
    if spec is None:
        raise RuntimeError(f"dependency {name!r} is not importable in this environment")
    if spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    return spec.origin  # a single module


def _link_deps(sp: str, deps: Sequence[str]) -> List[str]:
    """Stand each import name of ``deps`` in site-packages ``sp`` as a
    symbolic link to where it lives here, with the ``<name>.libs``
    directory beside it that auditwheel-vendored libraries live in; the
    archive stores the files behind the links. Returns the paths linked."""
    linked = []
    for name in deps:
        src = _locate(name)
        libs = [d for d in (src + ".libs", os.path.join(os.path.dirname(src), name.replace("-", "_") + ".libs"))
                if os.path.isdir(d)]
        for path in [src] + libs[:1]:
            dst = os.path.join(sp, os.path.basename(path))
            if not os.path.lexists(dst):
                os.symlink(path, dst)
                linked.append(path)
    return linked


def stage_port(sp: str) -> Tuple[Path, Path]:
    """Copy the port's package into site-packages ``sp`` and put the kernel
    library and the portable native library where their loaders look
    first in the bundle, under the names they compute:
    ``sp/build/audio_modem_radio_tpu_torch/``. Returns both paths; raises
    when the kernel library cannot be had (no kernels, no artifact)."""
    from .. import native
    from ..ops import _build

    shutil.copytree(PKG_DIR, os.path.join(sp, PKG), ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    dest = Path(sp) / "build" / PKG
    dest.mkdir(parents=True, exist_ok=True)
    kernels, _ = _build.compile_library()
    kernel_lib = dest / _build.library_name()
    shutil.copy2(kernels, kernel_lib)
    native_lib = native.build_library(dest, flag_sets=(native.PORTABLE_FLAGS,))
    if native_lib is None:
        raise RuntimeError("the portable native library did not build (g++ and zlib are needed)")
    return kernel_lib, native_lib


_CHECK = """import ctypes, importlib, sys
for m in filter(None, sys.argv[1].split(",")):
    importlib.import_module(m)
for lib in sys.argv[2:]:
    ctypes.CDLL(lib)
"""


def _gzip_member(block: bytes) -> bytes:
    c = zlib.compressobj(_LEVEL, zlib.DEFLATED, 31)  # wbits 31: a whole gzip member
    return c.compress(block) + c.flush()


class _ParallelGzip:
    """A write-only stream that gzips what it is given as independent gzip
    members of ``_CHUNK`` bytes, compressed on a thread pool (zlib releases
    the interpreter lock), written to ``out`` in order and hashed. ``gzip
    -dc`` reads the members back as one stream."""

    def __init__(self, out, workers: int):
        self.out, self.limit = out, 2 * workers
        self.digest = hashlib.sha256()
        self._pool = ThreadPoolExecutor(workers)
        self._pending: collections.deque = collections.deque()
        self._buf = bytearray()

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) >= _CHUNK:
            self._submit(bytes(self._buf[:_CHUNK]))
            del self._buf[:_CHUNK]
        return len(data)

    def _submit(self, block: bytes) -> None:
        self._pending.append(self._pool.submit(_gzip_member, block))
        while len(self._pending) > self.limit:
            self._write_next()

    def _write_next(self) -> None:
        blob = self._pending.popleft().result()
        self.out.write(blob)
        self.digest.update(blob)

    def flush(self) -> None:
        """Compress what is buffered and write everything out."""
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()
        while self._pending:
            self._write_next()

    def close(self) -> None:
        self._pool.shutdown(cancel_futures=True)


def _left_out(name: str) -> bool:
    return any(fnmatch.fnmatch(name, p) for p in _LEFT_OUT)


def _parts(stage: str) -> List[List[str]]:
    """The stage's paths (links followed, ``_LEFT_OUT`` pruned) in
    ``_PARTS`` lists: every directory in the first, the files shared out
    largest first to the list with the fewest bytes."""
    dirs, files = [], []
    for d, subdirs, names in os.walk(stage, followlinks=True):
        subdirs[:] = sorted(x for x in subdirs if not _left_out(x))
        dirs.append(d)
        for n in sorted(names):
            path = os.path.join(d, n)
            if not _left_out(n) and os.path.isfile(path):  # a dangling link is no file
                files.append((os.path.getsize(path), path))
    parts, loads = [[] for _ in range(_PARTS)], [0] * _PARTS
    for size, path in sorted(files, reverse=True):
        i = loads.index(min(loads))
        parts[i].append(path)
        loads[i] += size
    parts[0] = dirs[1:] + parts[0]
    return [sorted(p) if i else p for i, p in enumerate(parts)]


def _write_run(stage: str, out_path: str, pyname: str, entry: str) -> None:
    """The launcher's room, then each part's tar.gz; the launcher, with the
    parts' offsets and lengths and the digest of the archive (which keys
    the extraction directory), is written into its room last."""
    spans = []
    with open(out_path, "wb") as out:
        out.write(b"\n" * _HEADER)
        gz = _ParallelGzip(out, os.cpu_count() or 1)
        try:
            for members in _parts(stage):
                start = out.tell()
                with tarfile.open(fileobj=gz, mode="w|", dereference=True) as tf:
                    for path in members:
                        tf.add(path, arcname=os.path.relpath(path, stage), recursive=False)
                gz.flush()
                spans.append(f"{start - _HEADER}:{out.tell() - start}")
        finally:
            gz.close()
        launcher = _LAUNCHER % {"digest": gz.digest.hexdigest()[:16], "pybin": pyname, "entry": entry,
                                "header": _HEADER, "parts": " ".join(spans)}
        tail = "__ARCHIVE__\n"
        room = _HEADER - len(launcher.encode()) - len(tail)
        if room < 2:
            raise RuntimeError(f"the launcher takes more than {_HEADER} bytes")
        out.seek(0)
        out.write((launcher + "#" * (room - 1) + "\n" + tail).encode())
    os.chmod(out_path, 0o755)


def build_standalone(
    out_path: str,
    deps: Sequence[str] = None,
    entry: str = ENTRY,
    include_app: bool = True,
    stage_hook=None,
) -> str:
    """Assemble the prefix, check it, and write the self-extracting script.

    ``deps``: import names to bundle (default: ``dependency_closure()``).
    ``stage_hook(stage_dir, site_packages_dir)`` lets tests put a small
    entry module in place of the port.
    """
    deps = dependency_closure() if deps is None else list(deps)
    if include_app:
        from ..ops import _build

        _build.compile_library()  # no kernels, no artifact: fail before the large copies
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(out_path))) as tmp:
        stage = os.path.join(tmp, "prefix")
        pyname, sp = _copy_runtime(stage)
        shipped = _link_deps(sp, deps) + [stage]
        libraries = [str(p) for p in stage_port(sp)] if include_app else []
        binaries = list(libraries)
        if "torch" in deps:
            torch_lib = os.path.join(_locate("torch"), "lib")
            binaries += [os.path.join(torch_lib, f) for f in sorted(os.listdir(torch_lib)) if ".so" in f]
        for name, path in _ldd_closure(binaries, shipped=shipped).items():
            if not os.path.exists(os.path.join(stage, "lib", name)):
                shutil.copy2(path, os.path.join(stage, "lib", name))
        if stage_hook is not None:
            stage_hook(stage, sp)
        modules = [m for m in ROOTS if m in deps] + ([PKG] if include_app else [])
        if modules or libraries:
            proc = _run_bundled(stage, pyname, "-c", _CHECK, ",".join(modules), *libraries)
            if proc.returncode != 0:
                raise RuntimeError(f"the bundle does not import {modules} or load {libraries}:\n{proc.stderr}")
        _write_run(stage, out_path, pyname, entry)
    return out_path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(PKG_DIR.parent, "dist"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    out_path = build_standalone(os.path.join(args.out, "amr-torch.run"))
    print(f"built {out_path} ({os.path.getsize(out_path) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
