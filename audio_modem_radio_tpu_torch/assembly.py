"""Multi-part file assembly and reception statistics (session layer, host-side).

Implements the *intended* behavior of the reference's FileAssembly
(reference decoder.py:20-136): fixed part slots, heuristic per-part
signal quality, quality-scored duplicate replacement (a bad part can be healed
by a better retransmission), size+CRC verification on reassembly, and expiry
of stalled transfers. The reference's multi-part path is unreachable in
practice because ``save_decoded_files`` unpacks 7-tuples while the shipping
parser emits 3-key dicts (decoder.py:249 vs 197-201); here the parser returns
full :class:`~audio_modem_radio_tpu.framing.Frame` headers and the assembly
registry consumes them directly, so reassembly actually works.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from .framing import Frame, crc32

logger = logging.getLogger("audio_modem_radio_tpu_torch")


class FileAssembly:
    """Collects the parts of one multi-part transfer, best-quality-wins."""

    def __init__(self, filename: str, total_parts: int, file_size: int, file_crc: int):
        self.filename = filename
        self.total_parts = total_parts
        self.file_size = file_size
        self.expected_crc = file_crc
        self.parts: List[Optional[bytes]] = [None] * total_parts
        self.parts_quality: List[float] = [0.0] * total_parts
        self.received_parts = 0
        self.creation_time = time.time()
        self.last_update = time.time()

    @staticmethod
    def calculate_signal_quality(data: bytes) -> float:
        """Structure heuristic in [0,1]: penalize zero-runs, low byte
        diversity, and short-period repetition (reference decoder.py:32-54)."""
        if not data:
            return 0.0
        try:
            zero_ratio = data.count(0) / len(data)
            unique_ratio = len(set(data)) / 256
            repetition_penalty = 0.0
            if len(data) > 10:
                period = data[:5]
                reps = len(data) // 5
                if period * reps == data[: reps * 5]:
                    repetition_penalty = 0.5
            q = (1 - zero_ratio) * unique_ratio * (1 - repetition_penalty)
            return max(0.0, min(1.0, q))
        except Exception:
            return 0.5

    def add_part(self, part_number: int, data: bytes, signal_quality: Optional[float] = None) -> bool:
        """Insert or maybe-replace a part; returns True when all parts present."""
        if not (0 <= part_number < self.total_parts):
            return False
        if signal_quality is None:
            signal_quality = self.calculate_signal_quality(data)
        if self.parts[part_number] is not None:
            # A duplicate replaces the held part only when its quality clears
            # the held quality by CONFIG ``modem.duplicate_replacement_threshold``
            # (the reference declares the key but reads it nowhere; the wired
            # default 0.0 preserves its effective replace-on-any-improvement).
            from .config import CONFIG

            margin = float(CONFIG.get("modem.duplicate_replacement_threshold", 0.0))
            if signal_quality > self.parts_quality[part_number] + margin:
                self.parts[part_number] = data
                self.parts_quality[part_number] = signal_quality
                self.last_update = time.time()
        else:
            self.parts[part_number] = data
            self.parts_quality[part_number] = signal_quality
            self.received_parts += 1
            self.last_update = time.time()
        return self.received_parts == self.total_parts

    def get_progress(self) -> float:
        return (self.received_parts / self.total_parts) * 100 if self.total_parts else 0.0

    def get_missing_parts(self) -> List[int]:
        return [i for i, p in enumerate(self.parts) if p is None]

    def assemble_file(self) -> bytes:
        """Concatenate parts; raises if incomplete. Size/CRC mismatches are
        reported via ``integrity_ok`` rather than silently printed."""
        if self.received_parts != self.total_parts:
            raise ValueError(
                f"incomplete transfer {self.received_parts}/{self.total_parts}, "
                f"missing {self.get_missing_parts()}"
            )
        return b"".join(p for p in self.parts if p is not None)

    def integrity_ok(self, data: bytes) -> bool:
        size_ok = (self.file_size == 0) or (len(data) == self.file_size)
        crc_ok = (self.expected_crc == 0) or (crc32(data) == self.expected_crc)
        return size_ok and crc_ok

    def is_expired(self, timeout_seconds: int = 3600) -> bool:
        return (time.time() - self.last_update) > timeout_seconds

    def get_quality_report(self) -> dict:
        qs = self.parts_quality
        return {
            "average_quality": sum(qs) / len(qs) if qs else 0.0,
            "min_quality": min(qs) if qs else 0.0,
            "max_quality": max(qs) if qs else 0.0,
            "completed_parts": self.received_parts,
            "total_parts": self.total_parts,
        }


class AssemblyRegistry:
    """Thread-safe registry of in-flight transfers keyed ``{name}_{file_crc}``.

    Replaces the reference's unsynchronized module-global dicts
    (decoder.py:125-136) — the decode worker and the GUI poll timers touched
    them concurrently there.
    """

    def __init__(
        self, timeout_seconds: Optional[int] = None, journal_dir: Optional[str] = None
    ):
        self._lock = threading.Lock()
        self._assemblies: Dict[str, FileAssembly] = {}
        if timeout_seconds is None:
            from .config import CONFIG

            timeout_seconds = int(CONFIG.get("modem.assembly_timeout", 7200))
        self.timeout_seconds = timeout_seconds
        # Disk journal for restart-safe transfers: every accepted multi-part
        # part is written atomically under <journal_dir>/<transfer>/ and the
        # journal is replayed lazily on first use, so a reception spanning
        # the (default 7200 s) assembly timeout survives a process restart —
        # the reference's FileAssembly dies with the app (SURVEY.md §5
        # "not persisted to disk"). ``journal_dir=None`` defers to CONFIG
        # ``modem.assembly_journal`` (default "recv/.assembly"; empty
        # disables), re-read per use so the knob works on the process-wide
        # default registry too. The path is resolved relative to the cwd
        # like every recv_dir in the decoder.
        self._journal_dir = journal_dir
        self._journal_loaded = False
        self.stats = self._fresh_stats()

    @property
    def journal_dir(self) -> Optional[str]:
        if self._journal_dir is not None:
            return self._journal_dir or None
        from .config import CONFIG

        return str(CONFIG.get("modem.assembly_journal", "recv/.assembly")) or None

    @staticmethod
    def _fresh_stats() -> dict:
        return {
            "total_files": 0,
            "total_bytes": 0,
            "success_rate": 0.0,
            "last_reception": None,
            "average_quality": 0.0,
            "duplicates_rejected": 0,
            "parts_reordered": 0,
            "total_quality": 0.0,
            "quality_samples": 0,
        }

    def key_for(self, frame: Frame) -> str:
        # Key by the *base* filename: parts arrive named "<name>.partN"
        # (encoder.py:149 in the reference) and must land in one assembly.
        # (The reference keys by the part name, so each part would open its
        # own assembly — one more reason its multi-part path never worked.)
        base = frame.name
        if frame.is_multipart and ".part" in base:
            stem, _, suffix = base.rpartition(".part")
            if suffix.isdigit():
                base = stem
        return f"{base}_{frame.file_crc}"

    # --- disk journal (restart-safe transfers) ---------------------------

    def _journal_path(self, key: str, asm: FileAssembly) -> str:
        import re

        safe = re.sub(r"[^A-Za-z0-9._-]", "_", asm.filename)[:40]
        return os.path.join(
            self.journal_dir, f"{crc32(key.encode()) & 0xFFFFFFFF:08x}_{safe}"
        )

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def _journal_part(self, key: str, asm: FileAssembly, part_number: int) -> None:
        """Atomically persist one accepted part + refreshed metadata."""
        import json

        d = self._journal_path(key, asm)
        os.makedirs(d, exist_ok=True)
        part = asm.parts[part_number]
        assert part is not None
        self._atomic_write(os.path.join(d, f"part_{part_number:05d}.bin"), part)
        meta = {
            "key": key,
            "filename": asm.filename,
            "total_parts": asm.total_parts,
            "file_size": asm.file_size,
            "file_crc": asm.expected_crc,
            "creation_time": asm.creation_time,
            "last_update": asm.last_update,
            "qualities": {
                str(i): q
                for i, q in enumerate(asm.parts_quality)
                if asm.parts[i] is not None
            },
        }
        self._atomic_write(
            os.path.join(d, "meta.json"), json.dumps(meta).encode("utf-8")
        )

    def _drop_journal(self, key: str, asm: FileAssembly) -> None:
        import shutil

        d = self._journal_path(key, asm)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    def _load_journal_locked(self) -> int:
        """Replay the journal into memory (expired entries are deleted).
        Called lazily under the lock; returns the number resumed."""
        import glob
        import json
        import shutil

        self._journal_loaded = True
        if not self.journal_dir or not os.path.isdir(self.journal_dir):
            return 0
        resumed = 0
        for d in sorted(glob.glob(os.path.join(self.journal_dir, "*"))):
            mpath = os.path.join(d, "meta.json")
            if not os.path.isfile(mpath):
                continue
            try:
                with open(mpath) as f:
                    meta = json.load(f)
                a = FileAssembly(
                    meta["filename"], meta["total_parts"], meta["file_size"], meta["file_crc"]
                )
                a.creation_time = meta["creation_time"]
                a.last_update = meta["last_update"]
                if a.is_expired(self.timeout_seconds):
                    shutil.rmtree(d, ignore_errors=True)
                    continue
                for i_str, q in meta.get("qualities", {}).items():
                    ppath = os.path.join(d, f"part_{int(i_str):05d}.bin")
                    if os.path.isfile(ppath):
                        with open(ppath, "rb") as pf:
                            a.parts[int(i_str)] = pf.read()
                        a.parts_quality[int(i_str)] = float(q)
                a.received_parts = sum(1 for p in a.parts if p is not None)
                if a.received_parts:
                    self._assemblies[meta["key"]] = a
                    resumed += 1
            except Exception:  # corrupt journal entry: drop, never wedge decode
                shutil.rmtree(d, ignore_errors=True)
        return resumed

    def offer(self, frame: Frame) -> Optional[bytes]:
        """Feed one parsed frame; returns the whole file when it completes."""
        from .framing import MAX_PARTS

        if not (0 < frame.total_parts <= MAX_PARTS):
            # Defense in depth behind the parser's sanity bound: a corrupt
            # ``total`` field must never size an assembly slot list (a single
            # flipped high bit once drove a ~8 GB [None]*total allocation).
            logger.warning(
                "rejecting frame %s with absurd total_parts=%d",
                frame.name, frame.total_parts,
            )
            return None
        with self._lock:
            if self.journal_dir and not self._journal_loaded and frame.is_multipart:
                self._load_journal_locked()
            key = self.key_for(frame)
            asm = self._assemblies.get(key)
            if asm is None:
                asm = FileAssembly(frame.name, frame.total_parts, frame.file_size, frame.file_crc)
                self._assemblies[key] = asm
            quality = FileAssembly.calculate_signal_quality(frame.data)
            had = asm.parts[frame.part_number] is not None
            complete = asm.add_part(frame.part_number, frame.data, quality)
            if had:
                self.stats["duplicates_rejected"] += 1
            self.stats["total_quality"] += quality
            self.stats["quality_samples"] += 1
            if self.journal_dir and frame.is_multipart and not complete:
                # Journal only while in flight; completed transfers drop
                # their journal below. (Single-part frames never journal.)
                try:
                    self._journal_part(key, asm, frame.part_number)
                except OSError:
                    pass  # journaling is best-effort; reception continues
            if not complete:
                return None
            data = asm.assemble_file()
            if not asm.integrity_ok(data):
                # Keep the assembly around: a better retransmission of a bad
                # part can still heal it before expiry.
                if self.journal_dir and frame.is_multipart:
                    try:
                        self._journal_part(key, asm, frame.part_number)
                    except OSError:
                        pass
                return None
            del self._assemblies[key]
            if self.journal_dir:
                self._drop_journal(key, asm)
            self.stats["total_files"] += 1
            self.stats["total_bytes"] += len(data)
            self.stats["last_reception"] = time.time()
            return data

    def purge_expired(self) -> List[str]:
        with self._lock:
            expired = [k for k, a in self._assemblies.items() if a.is_expired(self.timeout_seconds)]
            for k in expired:
                if self.journal_dir:
                    self._drop_journal(k, self._assemblies[k])
                del self._assemblies[k]
            return expired

    def get_status(self) -> List[dict]:
        with self._lock:
            if self.journal_dir and not self._journal_loaded:
                self._load_journal_locked()
            return [
                {
                    "filename": a.filename,
                    "progress": a.get_progress(),
                    "received": a.received_parts,
                    "total": a.total_parts,
                    "missing": a.get_missing_parts(),
                    **a.get_quality_report(),
                }
                for a in self._assemblies.values()
            ]

    def average_quality(self) -> float:
        with self._lock:
            qs = [q for a in self._assemblies.values() for q in a.parts_quality if q > 0]
        return sum(qs) / len(qs) if qs else 0.0

    def get_stats(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        stats["average_quality"] = (
            stats["total_quality"] / stats["quality_samples"] if stats["quality_samples"] else 0.0
        )
        return stats

    def clear_stats(self) -> None:
        with self._lock:
            self.stats = self._fresh_stats()

    def reset(self) -> None:
        with self._lock:
            jd = self.journal_dir
            if jd:
                for key, asm in self._assemblies.items():
                    self._drop_journal(key, asm)
                # Journals written by a PREVIOUS process may not be loaded
                # yet (the replay is lazy): wipe them too, or the next
                # multipart offer() resurrects transfers reset() just
                # cleared.
                if os.path.isdir(jd):
                    import shutil

                    for d in os.listdir(jd):
                        shutil.rmtree(os.path.join(jd, d), ignore_errors=True)
                self._journal_loaded = True
            self._assemblies.clear()
            self.stats = self._fresh_stats()

    # --- checkpoint / resume ---------------------------------------------
    # The reference's in-flight transfers die with the process (SURVEY.md §5:
    # "not persisted to disk, lost on app restart"); these make a multi-part
    # reception survive restarts within the assembly timeout.

    def save_state(self, path: str) -> None:
        """Persist in-flight assemblies + stats to a JSON checkpoint."""
        import base64
        import json

        with self._lock:
            state = {
                "stats": self.stats,
                "timeout_seconds": self.timeout_seconds,
                "assemblies": [
                    {
                        "key": key,
                        "filename": a.filename,
                        "total_parts": a.total_parts,
                        "file_size": a.file_size,
                        "file_crc": a.expected_crc,
                        "creation_time": a.creation_time,
                        "last_update": a.last_update,
                        "parts": [
                            None if p is None else base64.b64encode(p).decode()
                            for p in a.parts
                        ],
                        "qualities": a.parts_quality,
                    }
                    for key, a in self._assemblies.items()
                ],
            }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def load_state(self, path: str) -> int:
        """Restore a checkpoint; returns the number of assemblies resumed.

        Already-expired assemblies are dropped on load.
        """
        import base64
        import json

        if not os.path.exists(path):
            return 0
        with open(path) as f:
            state = json.load(f)
        resumed = 0
        with self._lock:
            self.stats.update(state.get("stats", {}))
            for rec in state.get("assemblies", []):
                a = FileAssembly(
                    rec["filename"], rec["total_parts"], rec["file_size"], rec["file_crc"]
                )
                a.creation_time = rec["creation_time"]
                a.last_update = rec["last_update"]
                a.parts = [
                    None if p is None else base64.b64decode(p) for p in rec["parts"]
                ]
                a.parts_quality = rec["qualities"]
                a.received_parts = sum(1 for p in a.parts if p is not None)
                if not a.is_expired(self.timeout_seconds):
                    self._assemblies[rec["key"]] = a
                    resumed += 1
        return resumed


# Default process-wide registry (the decoder pipeline uses this unless an
# explicit registry is passed).
registry = AssemblyRegistry()
