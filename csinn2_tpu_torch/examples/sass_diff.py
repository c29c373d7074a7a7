"""Compare the SASS of every kernel in two builds of the port's CUDA
libraries (a change to a shared header should leave the kernels that do
not use what changed as they were).

    python3 -m csinn2_tpu_torch.examples.sass_diff OLD_DIR NEW_DIR [LIB ...]

OLD_DIR and NEW_DIR hold lib<name>.so files (kernels/_build/<hash>/ of two
trees); LIB names the libraries to compare (default: every one in both).
`cuobjdump -sass` lists each library's functions; the anonymous namespace's
name, which hashes the source path, is dropped from the function names,
and each instruction is compared without its address and encoding.  Each
function prints as "identical", "identical but for parameter offsets" (the
same instructions where only the constant-bank offsets of kernel
parameters, c[0x0][...], differ: a parameter struct that changed shape),
"DIFFERS" (with the first instruction that differs), or as present in
one build only.  Exits where cuobjdump is missing.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_[A-Za-z0-9_]+_cu_[0-9a-f]+")
_CBANK = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise SystemExit("sass_diff: cuobjdump not found")
    return found


def functions(lib: Path) -> Dict[str, List[str]]:
    """Function name → its SASS instructions, without addresses and encodings."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub("", m.group(1))
            funcs[name] = []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins).strip()
        if ins:
            funcs[name].append(ins)
    return funcs


def compare(old: Path, new: Path) -> List[str]:
    a, b = functions(old), functions(new)
    lines = [f"{old.name}: {len(a)} functions before, {len(b)} after"]
    for name in sorted(set(a) | set(b)):
        short = re.sub(r"^_Z\d+", "", name)[:100]
        if name not in a or name not in b:
            lines.append(f"  only {'before' if name in a else 'after'}: {short}")
        elif a[name] == b[name]:
            lines.append(f"  identical ({len(a[name])} instructions): {short}")
        elif [_CBANK.sub("c", x) for x in a[name]] == [_CBANK.sub("c", x) for x in b[name]]:
            lines.append(f"  identical but for parameter offsets ({len(a[name])}): {short}")
        else:
            i = next((i for i, (x, y) in enumerate(zip(a[name], b[name])) if x != y),
                     min(len(a[name]), len(b[name])))
            lines.append(f"  DIFFERS ({len(a[name])} / {len(b[name])} instructions): {short}")
            lines.append(f"    first at {i}: {a[name][i] if i < len(a[name]) else '-'}"
                         f"  |  {b[name][i] if i < len(b[name]) else '-'}")
    return lines


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        print(__doc__)
        return 2
    old_dir, new_dir = Path(args[0]), Path(args[1])
    names = args[2:] or sorted(p.stem[3:] for p in old_dir.glob("lib*.so")
                               if (new_dir / p.name).exists())
    for name in names:
        print("\n".join(compare(old_dir / f"lib{name}.so", new_dir / f"lib{name}.so")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
