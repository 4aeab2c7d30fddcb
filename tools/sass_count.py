#!/usr/bin/env python3
"""Static SASS counts of the port's CUDA kernels.

    python tools/sass_count.py [--root DIR] [--dump OUT] SOURCE SYMBOL [...]

Builds ``csrc/SOURCE.cu`` of the checkout at DIR (default: this one)
with the package's own flags (``ops/cuda_build``), disassembles it with
``cuobjdump -sass`` and ``-res-usage``, and prints one JSON line for
each kernel whose mangled name contains SYMBOL:

- ``registers``: registers a thread (and spill bytes, if any);
- ``total`` and ``by_class``: the kernel's instructions, by class
  (global loads and stores, shared loads and stores, shuffles, min /
  max, the multi-function unit, float32 add / multiply / fused
  multiply-add, integer, branches and the rest);
- ``loops``: each loop (a backward branch), its body's instructions by
  class;
- for the innermost loop with the most global loads, ``load_batches``:
  walking its body in order,
  the number of global loads issued before the first instruction that
  reads one of their results, for each such wait.  A loop that issues
  its gathers together shows a few large batches; one that waits on
  each gather in turn shows batches of 1-4;
- ``store_gaps``: the instructions between successive 16-byte global
  stores (a kernel that stores one pixel's record a step shows its
  instructions a pixel here).

With ``--dump OUT``, each matched kernel's SASS is also written to
``OUT/SOURCE-SYMBOL.sass``.  Counts are static: an instruction of a loop body runs once an
iteration.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), so it runs
on a machine with a GPU.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

CLASSES = (
    ("global_load", ("LDG",)), ("global_store", ("STG", "RED", "ATOM")),
    ("shared_load", ("LDS",)), ("shared_store", ("STS",)),
    ("shuffle", ("SHFL",)), ("minmax", ("FMNMX",)), ("mufu", ("MUFU",)),
    ("fp32", ("FADD", "FMUL", "FFMA", "FSET", "FSETP", "FSEL", "FCHK",
              "FRND", "F2I", "I2F")),
    ("integer", ("IMAD", "IADD", "LEA", "ISETP", "SHF", "LOP", "IMNMX",
                 "SEL", "IABS", "PRMT", "VOTE", "POPC", "FLO", "MOV")),
    ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC",
                "BAR")),
)
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_REG = re.compile(r"\bR(\d+)\b")


def klass(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "other"


def parse(sass: str) -> dict:
    """{mangled kernel name: [(address, opcode, operand text)]}"""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INS.search(line)
        if m and cur is not None:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            op, _, rest = text.partition(" ")
            cur.append((int(m.group(1), 16), op, rest))
    return out


def tally(ins) -> dict:
    c = {}
    for _, op, _ in ins:
        k = klass(op)
        c[k] = c.get(k, 0) + 1
    return c


def loops(ins):
    """(start, end) index ranges of the loop bodies: a branch to an
    earlier address closes a loop that begins at that address."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    found = []
    for i, (_, op, rest) in enumerate(ins):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if m and int(m.group(1), 16) in at and at[int(m.group(1), 16)] < i:
                found.append((at[int(m.group(1), 16)], i))
    return found


def load_batches(body) -> list:
    """Global loads issued before each first read of a pending result."""
    pending, issued, batches = set(), 0, []
    for _, op, rest in body:
        regs = _REG.findall(rest)
        if op.split(".")[0] == "LDG":
            width = {"64": 2, "128": 4}.get(
                next((p for p in op.split(".") if p in ("64", "128")), ""), 1)
            base = int(regs[0])
            pending |= {base + j for j in range(width)}
            issued += 1
            continue
        dest = re.match(r"R\d+\b", rest.split(",")[0].strip())
        srcs = regs[1:] if dest and not op.startswith(("ST", "RED")) else regs
        if pending and any(int(r) in pending for r in srcs):
            batches.append(issued)
            pending, issued = set(), 0
    return batches


def store_gaps(ins) -> list:
    at = [i for i, (_, op, _) in enumerate(ins)
          if op.split(".")[0] == "STG" and "128" in op.split(".")]
    return [b - a for a, b in zip(at, at[1:])]


def main(argv) -> int:
    opts = {"--root": os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "--dump": None}
    while len(argv) > 2 and argv[1] in opts:
        opts[argv[1]], argv = argv[2], argv[:1] + argv[3:]
    root, dump = opts["--root"], opts["--dump"]
    pairs = argv[1:]
    if not pairs or len(pairs) % 2:
        raise SystemExit(__doc__)
    sys.path.insert(0, os.path.abspath(root))
    from hesaff_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for src, sym in zip(pairs[::2], pairs[1::2]):
        so = cuda_build.library(src)._name
        run = lambda *a: subprocess.run([tool, *a, so], capture_output=True,
                                        text=True, check=True).stdout
        regs, fn = {}, None
        for line in run("-res-usage").splitlines():
            m = re.search(r"Function (\S+?):", line)
            fn = m.group(1) if m else fn
            m = re.search(r"REG:(\d+).*LOCAL:(\d+)", line)
            if m and fn:
                regs[fn] = (int(m.group(1)), int(m.group(2)))
        sass = run("-sass")
        for name, ins in parse(sass).items():
            if sym not in name:
                continue
            if dump:
                os.makedirs(dump, exist_ok=True)
                text = sass[sass.index(f"Function : {name}"):]
                end = text.find("Function : ", 1)
                with open(os.path.join(dump, f"{src}-{name[:60]}.sass"),
                          "w") as fh:
                    fh.write(text if end < 0 else text[:end])
            body = [ins[a:b + 1] for a, b in loops(ins)]
            lds = lambda b: sum(op.split(".")[0] == "LDG" for _, op, _ in b)
            big = min(body, key=lambda b: (-lds(b), len(b))) if body else []
            reg, local = regs.get(name, (None, None))
            print(json.dumps(dict(
                root=root, source=src, kernel=name, registers=reg,
                local_bytes=local, total=len(ins), by_class=tally(ins),
                loops=[dict(length=len(b), by_class=tally(b)) for b in body],
                load_batches=load_batches(big),
                store_gaps=store_gaps(ins))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
