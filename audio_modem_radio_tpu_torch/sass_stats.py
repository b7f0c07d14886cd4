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

``--chain`` instead reads the Viterbi kernel's (``csrc/mlse_viterbi.cu``)
per-step dependent chains from its SASS: the forward step (the longest
path between two steps' REDUX.MAX instructions in the unrolled loop) and the
traceback's step (between two bits' stores in phase A's unrolled walk),
each in cycles, with the instructions on it (``chain_cycles`` takes other
anchors for ``csrc/fec_viterbi.cu``). A shared-memory load depends on the
store before it. An instruction's
weight is its dependent-issue latency on the card, measured by
``csrc/probe/latency.cu`` (built alone and run here; cycles a probe trip
over the probe's own count of that opcode in its SASS, less the
latency of the other opcode on the chain where a probe has two).

Run it on a machine with the CUDA toolkit:

    python3 -m audio_modem_radio_tpu_torch.sass_stats --kernel fsk_quad --kernel fsk_disc
    python3 -m audio_modem_radio_tpu_torch.sass_stats --chain
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from collections import Counter
from pathlib import Path

from .ops import _build

# One instruction of cuobjdump's listing: its guard predicate, opcode and operands.
_INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T\d]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", re.M)


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


def _functions(sass: str):
    """Yield ``(function name, body)`` of each function in ``sass``."""
    for m in re.finditer(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        yield m.group(1), m.group(2)


def kernel_stats(sass: str, wanted, gap: int):
    """Yield ``(function name, whole-function summary, FFMA-run summary,
    [(opcode, operands)])``."""
    for name, body in _functions(sass):
        if wanted and not any(w in name for w in wanted):
            continue
        ops = [(op, args) for _guard, op, args in _INSTR.findall(body)]
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


def library_sass(lib: Path) -> str:
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout


# --- per-step dependent chains ------------------------------------------------------

_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "ATOM", "BRA", "BRX", "EXIT", "RET", "CALL", "BAR", "WARPSYNC",
            "BSYNC", "BSSY", "NOP", "MEMBAR", "DEPBAR", "YIELD")
_TWO_DEST = ("ISETP", "FSETP", "DSETP", "PLOP3", "SHFL")  # a predicate, then the result
_ENDS_BLOCK = ("BRA", "BRX", "EXIT", "RET", "CALL")
# The cases of csrc/probe/latency.cu: (opcode, the opcode counted in the
# probe's SASS, the opcode whose latency its chain also holds).
_PROBES = (("FADD", "FADD", None), ("FMNMX", "FMNMX", None), ("SHF", "SHF", None), ("LOP3", "LOP3", "SHF"),
           ("SEL", "SEL", None), ("REDUX", "REDUX", None), ("SHFL", "SHFL", None), ("LDS", "LDS", None),
           ("VIADD", "VIADD", "LOP3"), ("ISETP", "ISETP", "SEL"))


def _instructions(body: str):
    """[(opcode, defined registers, used registers)] in program order, and
    the indices where a basic block starts (after a branch, at a label)."""
    out, starts = [], [0]
    for line in body.splitlines():
        if re.match(r"^\s*\.L_\w+:", line):
            starts.append(len(out))
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        guard, op, args = m.group(1) or "", m.group(2), m.group(3)
        base = op.split(".")[0]
        parts = [a.strip() for a in args.split(",")] if args.strip() else []
        n_def = 0 if base in _NO_DEST else 2 if base in _TWO_DEST else 1
        defs = [r for a in parts[:n_def] for r in _REG.findall(a)]
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
        if defs and width > 1 and defs[-1].startswith(("R", "UR")):
            prefix = "UR" if defs[-1].startswith("UR") else "R"
            first = int(defs[-1][len(prefix):])
            defs = defs[:-1] + [f"{prefix}{first + i}" for i in range(width)]
        uses = _REG.findall(guard) + [r for a in parts[n_def:] for r in _REG.findall(a)]
        # A shared-memory load waits for the store before it: where values
        # travel through shared memory (fec_viterbi.cu's exchange), the
        # pseudo-register SMEM puts the store and the load on the chain.
        if base == "STS":
            defs = defs + ["SMEM"]
        elif base == "LDS":
            uses = uses + ["SMEM"]
        out.append((op, defs, uses))
        if base in _ENDS_BLOCK:
            starts.append(len(out))
    return out, sorted(set(starts))


def _longest(block, latency):
    """Finish cycle of each instruction of a straight-line block, every
    value from outside ready at 0, and each one's critical predecessor."""
    finish, crit, last_def = [], [], {}
    for i, (op, defs, uses) in enumerate(block):
        preds = [last_def[r] for r in uses if r in last_def]
        start = max((finish[p] for p in preds), default=0.0)
        crit.append(max(preds, key=lambda p: finish[p]) if preds else None)
        finish.append(start + _weight(block, i, latency))
        for r in defs:
            last_def[r] = i
    return finish, crit


def _weight(block, i, latency) -> float:
    op, _defs, uses = block[i]
    base = op.split(".")[0]
    if base in ("MOV", "IMAD") and uses and all(u.startswith("UR") for u in uses):
        return 0.0  # a uniform register's value into a vector one: the probe's REDUX includes it
    return latency.get(base, latency["LOP3"])


def _path(block, finish, crit, end: int, span: float):
    """The instructions of the critical path that ends at ``end``, back
    over ``span`` cycles (one step)."""
    ops, i = [], end
    while i is not None and finish[end] - finish[i] < span:
        ops.append(block[i][0])
        i = crit[i]
    return list(reversed(ops))


def chain_cycles(sass: str, latency: dict, instance: str = "mlse_viterbi_kernelILi2E",
                 forward: str = "REDUX.MAX", back: str = "STG.U8"):
    """(forward cycles a step, its instructions, traceback cycles a step,
    its instructions) of the Viterbi kernel instantiation whose mangled name
    holds ``instance`` (K = 2: 33-64 states). The forward step is the
    longest path from one step's ``forward`` instruction (REDUX.MAX) to the
    next's in the unrolled loop; the traceback step that from one ``back``
    instruction to the next's in an unrolled 32-step walk (a bit's byte
    store in phase A, each lane its own stages). For ``fec_viterbi.cu``
    (instance ``fec_viterbi_kernel``) the anchors are the step minimum's
    REDUX.MIN and the same bit stores of its phase A."""
    body = next(b for name, b in _functions(sass) if instance in name)
    instrs, starts = _instructions(body)
    blocks = [instrs[a:b] for a, b in zip(starts, starts[1:] + [len(instrs)]) if b > a]

    def per_step(anchor):
        block = max(blocks, key=lambda b: sum(1 for op, _d, _u in b if anchor(op)))
        finish, crit = _longest(block, latency)
        at = [i for i, (op, _d, _u) in enumerate(block) if anchor(op)]
        if len(at) < 2:
            return float("nan"), []
        cycles = (finish[at[-1]] - finish[at[0]]) / (len(at) - 1)
        return cycles, _path(block, finish, crit, at[-1], cycles)

    def anchor(name):
        head, _, tail = name.partition(".")
        return lambda op: op.startswith(head) and (not tail or f".{tail}" in op)

    fwd, fwd_path = per_step(anchor(forward))
    back_cycles, back_path = per_step(anchor(back))
    return fwd, fwd_path, back_cycles, back_path


def probe_latencies(trips: int = 1000) -> dict:
    """{opcode: dependent-issue latency in SM cycles} on the visible
    card, from ``csrc/probe/latency.cu`` (built alone, min of 3 runs)."""
    import torch

    src = _build.SRC_DIR / "probe" / "latency.cu"
    lib = _build.BUILD_DIR / "latency_probe.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).amr_latency_probe
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, dtype=torch.int32, device="cuda")
    bodies = dict(_functions(library_sass(lib)))
    lat = {}
    for case, (base, counted, also) in enumerate(_PROBES):
        runs = []
        for _ in range(3):
            err = fn(case, trips, cycles.data_ptr(), sink.data_ptr())
            if err != 0:
                raise RuntimeError(f"latency probe {base}: cudaError_t {err}")
            torch.cuda.synchronize()
            runs.append(int(cycles.item()))
        body = next(b for name, b in bodies.items() if f"latency_kernelILi{case}E" in name)
        n = sum(1 for o, _d, _u in _instructions(body)[0] if o.split(".")[0] == counted)
        lat[base] = min(runs) / trips / n - (lat[also] if also else 0.0) if n else float("nan")
    lat["IADD3"] = lat["VIADD"]  # ptxas writes the probe's add.s32 as VIADD
    return lat


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", default=[], help="substring of the kernel's (mangled) name")
    ap.add_argument("--gap", type=int, default=24, help="most non-FFMA instructions inside one FFMA run")
    ap.add_argument("--opcodes", type=int, default=0, help="also list the N most frequent opcodes")
    ap.add_argument("--chain", action="store_true", help="the Viterbi kernel's per-step dependent chains")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args()
    lib, _ = _build.compile_library()
    sass = library_sass(lib)
    lines = []
    if args.chain:
        lat = probe_latencies()
        fwd, fwd_path, back, back_path = chain_cycles(sass, lat)
        lines += ["latencies (SM cycles): " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items()),
                  f"forward step: {fwd:.1f} cycles: {' -> '.join(fwd_path)}",
                  f"traceback step: {back:.1f} cycles: {' -> '.join(back_path)}"]
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
