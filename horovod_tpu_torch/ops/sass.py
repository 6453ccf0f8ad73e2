"""Compare the machine code (SASS) of the kernels two builds of the
library hold, function by function, by their sequences of opcodes.

    python -m horovod_tpu_torch.ops.sass OLD.so NEW.so [--match REGEX]
        [--rename REGEX=REPLACEMENT]

Each library is disassembled with the CUDA toolkit's ``cuobjdump -sass``;
a function is named by its mangled name with the per-file anonymous
namespace removed (its hash changes with the source), and compared by its
opcodes alone (registers, addresses and constants left out). Prints, for
each function whose name matches REGEX, the count of opcode lines that
differ (0: the same instructions in the same order), and the functions
only one build has. ``--rename`` rewrites the old build's names first
(``re.sub``), so an instance whose template parameters an edit removed is
compared with its successor. Used to show that an edit of shared device
code left an instance's instructions as they were. Needs the toolkit: run
it on the machine with the card.
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
from pathlib import Path


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path("/usr/local/cuda/bin/cuobjdump"))


def opcodes(lib: str) -> dict:
    """{function name: [opcode, ...]} of every kernel in ``lib``."""
    text = subprocess.run([_cuobjdump(), "-sass", lib], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                          "_GLOBAL__N_", m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    return funcs


def renamed(funcs: dict, rule: str) -> dict:
    """``funcs`` with each name rewritten by ``rule``, "REGEX=REPLACEMENT"
    (``re.sub``)."""
    pat, repl = rule.split("=", 1)
    return {re.sub(pat, repl, name): ops for name, ops in funcs.items()}


def diff(old: dict, new: dict, match: str = "") -> dict:
    """{function: opcode lines that differ} over the functions both have
    whose names match ``match``, and the names only one has."""
    pat = re.compile(match)
    out = {}
    for name in sorted(set(old) & set(new)):
        if pat.search(name):
            d = difflib.unified_diff(old[name], new[name], lineterm="", n=0)
            out[name] = sum(1 for line in d
                            if line[:1] in "+-"
                            and not line.startswith(("+++", "---")))
    only = sorted(n for n in set(old) ^ set(new) if pat.search(n))
    return {"differ": out, "only_in_one": only}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--match", default="", help="a regex on the names")
    ap.add_argument("--rename", default="",
                    help="REGEX=REPLACEMENT applied to the old build's names")
    args = ap.parse_args(argv)
    old = opcodes(args.old)
    if args.rename:
        old = renamed(old, args.rename)
    res = diff(old, opcodes(args.new), args.match)
    for name, n in res["differ"].items():
        print(f"{n:6d}  {name}")
    for name in res["only_in_one"]:
        print(f"  only in one build: {name}")
    changed = sum(1 for n in res["differ"].values() if n)
    print(f"{len(res['differ'])} functions compared, {changed} differ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
