"""The SASS of the port's CUDA sources against another tree's, entry by
entry (CUDA only: needs ``nvcc`` and ``cuobjdump``).

    python3 -m fhpe_tpu_torch.tools.sass_diff OTHER_CSRC [SOURCE ...]

Compiles each ``SOURCE`` (default: every ``ops/csrc/*.cu``) of this
package and of ``OTHER_CSRC`` (e.g. a parent commit's
``fhpe_tpu_torch/ops/csrc`` unpacked with ``git archive``) with the
build's flags, disassembles both cubins and prints, per kernel entry, the
instruction and HMMA counts on each side and whether the instruction
streams are identical (else how many lines differ, and how many opcodes
one side has that the other lacks).  Entry names are matched with the
anonymous namespace's per-file hash and the namespace of the conv
``Plan`` struct taken out.  A refactor of a shared header that should
leave a kernel as it was shows here as IDENTICAL.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

from ..ops import _build


def sass(src: Path) -> dict:
    """{entry: [instruction, ...]} of one source compiled to a cubin."""
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = str(Path(tmp) / "kernel.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, str(src)],
                       check=True, capture_output=True, timeout=600)
        text = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass", cubin],
            capture_output=True, text=True, check=True, timeout=600).stdout
    entries, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            name = re.sub(r"N12conv3x3_bf164PlanE|NS_4PlanE", "Plan", name)
            entries[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", ln)
        if name and m:
            entries[name].append(re.sub(r"\s+", " ", m.group(1)))
    return entries


def compare(source: str, other_csrc: Path) -> list:
    """Lines of the comparison of one source with the other tree's."""
    theirs = sass(other_csrc / source)
    ours = sass(_build._CSRC / source)
    lines = [f"{source}: {len(theirs)} entries there, {len(ours)} here"]
    for key in sorted(set(theirs) | set(ours)):
        a, b = theirs.get(key, []), ours.get(key, [])
        hmma = (sum("HMMA" in i for i in a), sum("HMMA" in i for i in b))
        if a == b:
            same = "IDENTICAL"
        else:
            ops_a, ops_b = (Counter(i.split()[0] for i in x) for x in (a, b))
            moved = sum(((ops_a - ops_b) + (ops_b - ops_a)).values())
            same = (f"{sum(x != y for x, y in zip(a, b))} lines differ, "
                    f"{moved} opcodes added or removed")
        lines.append(f"  {key}: instructions {len(a)} -> {len(b)}, HMMA "
                     f"{hmma[0]} -> {hmma[1]}, {same}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args(argv)
    for source in args.sources or [p.name for p in _build._sources()]:
        for ln in compare(source, args.other_csrc):
            print(ln, flush=True)


if __name__ == "__main__":
    main()
