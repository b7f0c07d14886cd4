"""Instruction statistics of the port's built CUDA kernels, from their SASS.

Builds the kernel library if it is missing (``ops/_build.py``), runs
``cuobjdump -sass`` on it and prints, per kernel whose name holds
``--kernel``: the count of each opcode family (FFMA, shared and uniform
loads, barriers, the rest) in the whole function, and the same for its
longest run of code in which no two FFMA lie more than ``--gap``
instructions apart (an unrolled multiply-add loop), with the share of that
run's instructions that are FFMA and how many of them take their
multiplier from a uniform register or the constant bank. ``--opcodes N``
also lists the whole function's N most frequent opcodes (integer kernels
such as K5 are bound by those, not by FFMA).

Run it on a machine with the CUDA toolkit:

    python3 -m audio_modem_radio_tpu_torch.sass_stats --kernel fsk_quad --kernel fsk_disc
"""

from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter
from pathlib import Path

from .ops import _build

_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", re.M)


def _family(op: str) -> str:
    for name in ("FFMA", "LDS", "STS", "ULDC", "LDC", "LDGSTS", "BAR"):
        if op.startswith(name):
            return name
    return "other"


def _summary(ops) -> str:
    fam = Counter(_family(op) for op, _ in ops)
    n = len(ops)
    ffma_const = sum(1 for op, args in ops if op.startswith("FFMA") and re.search(r"\bUR\d+|c\[0x", args))
    vec = sum(1 for op, _ in ops if op.startswith("LDS") and ".128" in op)
    parts = ", ".join(f"{k} {v}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
    share = fam["FFMA"] / n if n else 0.0
    return (f"{n} instructions: {parts}; LDS.128 {vec}; FFMA share {share:.4f}; "
            f"FFMA with a uniform-register or constant-bank multiplier {ffma_const}")


def kernel_stats(sass: str, wanted, gap: int):
    """Yield ``(function name, whole-function summary, FFMA-run summary,
    [(opcode, operands)])``."""
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        name, body = m.group(1), m.group(2)
        if wanted and not any(w in name for w in wanted):
            continue
        ops = _INSTR.findall(body)
        ffma = [i for i, (op, _) in enumerate(ops) if op.startswith("FFMA")]
        best = (0, 0)
        start = prev = None
        for i in ffma:
            if start is None or i - prev > gap:
                start = i
            prev = i
            if prev - start > best[1] - best[0]:
                best = (start, prev)
        yield name, _summary(ops), _summary(ops[best[0] : best[1] + 1]), ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", default=[], help="substring of the kernel's (mangled) name")
    ap.add_argument("--gap", type=int, default=24, help="most non-FFMA instructions inside one FFMA run")
    ap.add_argument("--opcodes", type=int, default=0, help="also list the N most frequent opcodes")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args()
    lib, _ = _build.compile_library()
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    lines = []
    for name, whole, run, ops in kernel_stats(sass, args.kernel, args.gap):
        lines += [name, f"  whole function: {whole}", f"  longest FFMA run: {run}"]
        if args.opcodes:
            top = Counter(op.split(".")[0] for op, _ in ops).most_common(args.opcodes)
            lines.append("  opcodes: " + ", ".join(f"{op} {n}" for op, n in top))
    report = "\n".join(lines)
    print(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(report + "\n")


if __name__ == "__main__":
    main()
