"""Instruction counts of the port's CUDA kernels, read from their SASS.

    python3 tools/sass_counts.py [ROOT ...] [--kernels NAME,NAME] [--dump DIR]
    python3 tools/sass_counts.py OTHER THIS --same "OLD=NEW[;OLD=NEW ...]"

Builds the kernel library of each checkout ROOT (default: this one) in a
process of its own, each into its own build/kernels, then reads the
library with the toolkit's ``cuobjdump -sass`` and ``cuobjdump
-res-usage``. For each kernel named (default: the forward kernels of rows 1
and 4) it prints its registers, stack frame and local memory, its SASS
instruction count, and every loop: each backward branch and its target
span one loop, printed with its offsets, its instructions, its
instructions outside the loops it holds, and the opcodes of its body.
The innermost loops of a forward kernel are its scans, the outermost its
bounce loop; a loop that tests rects (each test compares t with the
self-hit epsilon, 1e-3, once) also prints its rect tests an iteration and
its instructions a test. ``--dump DIR`` also writes each kernel's SASS to
DIR/<root name>.<kernel>.sass. ``--same`` compares, for each pair, kernel
OLD of the first root with kernel NEW of the second (a kernel that became
an instance of a template with another argument has another name): their
registers, stack frames and SASS, instruction by instruction with each
constant-bank address (the kernel's parameters) masked, and prints whether
they are the same but for parameter offsets. Needs nvcc and cuobjdump (the
CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_KERNELS = ("megakernel_nee", "megakernel_cosine",
                   "megakernel_textbook", "megakernel_guided<2>")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+(?:`?\(?\.?L?_?x?_?)?(0x[0-9a-f]+)")
_RES = re.compile(r"Function (\S+):\s*(.*)")
_EPS = "0.0010000000474974513054"  # kSelfHitEps as SASS prints it


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", name), os.X_OK):
            return os.path.join(root, "bin", name)
    raise RuntimeError(f"{name} not found")


def demangle(names: list[str]) -> dict[str, str]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def short(name: str) -> str:
    """`void <unnamed>::megakernel_guided<(int)2>(Params, ...)` ->
    `megakernel_guided<2>`, `megakernel_geom<(int)1, (int)0>` ->
    `megakernel_geom<1,0>` (either demangler's spelling)."""
    name = (name.replace("(anonymous namespace)", "").replace("<unnamed>", "")
            .replace("(int)", "").replace(", ", ","))
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.split()[-1].split("::")[-1]


def build(root: Path) -> Path:
    """Builds the library of the checkout at root in a process of its own."""
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from small_pathtracer_tpu_torch.ops import _build; "
                    "_build.build_kernels()", str(root)], check=True)
    return root / "build" / "kernels" / "libspt_kernels.so"


def functions(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """Kernel (short name) -> [(offset, instruction)] from cuobjdump -sass."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
            continue
        m = _INSTR.search(line)
        if cur is not None and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    names = demangle(list(funcs))
    return {short(names[k]): v for k, v in funcs.items()}


def resources(lib: Path) -> dict[str, str]:
    text = subprocess.run([tool("cuobjdump"), "-res-usage", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lines = text.splitlines()
    found = []
    for i, line in enumerate(lines):
        m = _RES.search(line)
        if m:  # the counts on the same line or the next
            found.append((m.group(1), m.group(2).strip()
                          or (lines[i + 1].strip() if i + 1 < len(lines)
                              else "")))
    names = demangle([k for k, _ in found])
    return {short(names[k]): v.strip() for k, v in found}


def opcode(instr: str) -> str:
    body = re.sub(r"^@!?U?P\w+\s+", "", instr)
    return body.split()[0] if body else ""


def loops(code: list[tuple[int, str]]) -> list[dict]:
    """Every backward branch: its loop [target, branch], innermost first."""
    index = {off: i for i, (off, _) in enumerate(code)}
    found = []
    for i, (off, instr) in enumerate(code):
        m = _BRANCH.search(instr)
        if not m:
            continue
        tgt = int(m.group(1), 16)
        if tgt <= off and tgt in index:
            found.append((index[tgt], i))
    found = sorted(set(found), key=lambda se: se[1] - se[0])
    out = []
    for s, e in found:
        inner = [(a, b) for a, b in found
                 if (a, b) != (s, e) and s <= a and b <= e]
        covered = set()
        for a, b in inner:
            covered.update(range(a, b + 1))
        body = [code[j][1] for j in range(s, e + 1)]
        own = [code[j][1] for j in range(s, e + 1) if j not in covered]
        out.append({"start": code[s][0], "end": code[e][0],
                    "n": len(body), "own": len(own),
                    "inner": len(inner),
                    "tests": sum(_EPS in i for i in own),
                    "ops": collections.Counter(map(opcode, own))})
    return out


def report(label: str, lib: Path, kernels: tuple, dump: Path | None) -> None:
    funcs = functions(lib)
    res = resources(lib)
    for k in kernels:
        if k not in funcs:
            print(f"[{label}] {k}: not in the library "
                  f"(have: {', '.join(sorted(funcs))})")
            continue
        code = funcs[k]
        print(f"[{label}] {k}: {len(code)} instructions; {res.get(k, '?')}")
        for lp in loops(code):
            ops = " ".join(f"{o}:{n}" for o, n in lp["ops"].most_common())
            tests = (f" ({lp['tests']} rect tests, "
                     f"{lp['own'] / lp['tests']:.2f} a test)"
                     if lp["tests"] and not lp["inner"] else "")
            print(f"  loop {lp['start']:#06x}-{lp['end']:#06x}: {lp['n']} "
                  f"instructions, {lp['own']} outside its {lp['inner']} "
                  f"inner loops{tests}; {ops}")
        if dump is not None:
            dump.mkdir(parents=True, exist_ok=True)
            (dump / f"{label}.{k}.sass").write_text(
                "\n".join(f"/*{o:04x}*/ {t} ;" for o, t in code) + "\n")


_CBANK = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")


def same(libs: list[Path], pairs: list[str]) -> None:
    """--same: each OLD=NEW pair's resources and SASS, parameters masked."""
    (f0, r0), (f1, r1) = ((functions(lib), resources(lib)) for lib in libs)
    for pair in pairs:
        old, new = pair.split("=")
        if old not in f0 or new not in f1:
            stem = old.split("<")[0]
            print(f"[same] {old} = {new}: missing ({old in f0}, {new in f1});"
                  " have: " + ", ".join(sorted(
                      k for k in {*f0, *f1} if k.startswith(stem))))
            continue
        a = [_CBANK.sub("c[P]", t) for _, t in f0[old]]
        b = [_CBANK.sub("c[P]", t) for _, t in f1[new]]
        diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        raw = sum(x != y for (_, x), (_, y) in zip(f0[old], f1[new]))
        verdict = ("the same but for parameter offsets" if diff == 0
                   else f"{diff} instructions differ")
        print(f"[same] {old} = {new}: {len(a)} / {len(b)} instructions, "
              f"{raw} differ as printed, {verdict}; resources "
              f"{r0.get(old, '?')} / {r1.get(new, '?')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=[str(ROOT)])
    ap.add_argument("--kernels", default=",".join(DEFAULT_KERNELS))
    ap.add_argument("--dump", default=None)
    ap.add_argument("--same", default=None)
    args = ap.parse_args()
    if args.same:
        same([build(Path(r).resolve()) for r in args.roots[:2]],
             args.same.split(";"))
        return 0
    kernels = tuple(args.kernels.split(","))
    for r in args.roots:
        root = Path(r).resolve()
        label = "this" if root == ROOT else root.name
        report(label, build(root), kernels,
               Path(args.dump) if args.dump else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
