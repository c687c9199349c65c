"""Resource use and instruction mix of each built CUDA kernel.

    python -m msfwsi_tpu_torch.diag.sass_report

Builds the libraries of ``csrc/`` (as ``_build.build_all`` does) and, for
each kernel in them, prints what ``cuobjdump -res-usage`` reports
(registers, stack, shared memory) and the count of each SASS opcode in its
code (``cuobjdump -sass``), the most frequent first. These are static
counts, one per instruction in the code, not per execution. Needs the
CUDA toolkit; no card is used.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from .. import _build

__all__ = ["opcode_counts", "resource_usage", "main"]

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
# "/*0a40*/   @!P0 FFMA R4, R5, R6, R4 ;" -> "FFMA" (modifiers after "." dropped)
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)")


def opcode_counts(sass: str) -> dict[str, collections.Counter]:
    """Kernel (mangled name) -> Counter of opcodes, from ``cuobjdump -sass``
    output."""
    starts = [(m.start(), m.group(1)) for m in _FUNCTION.finditer(sass)]
    out = {}
    for (pos, name), (end, _) in zip(starts, starts[1:] + [(len(sass), "")]):
        out[name] = collections.Counter(_INSTRUCTION.findall(sass[pos:end]))
    return out


def resource_usage(text: str) -> dict[str, str]:
    """Kernel (mangled name) -> its ``REG:.. STACK:.. SHARED:..`` line, from
    ``cuobjdump -res-usage`` output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s+(\S+?):?\s*$", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            out[name] = line.strip()
            name = None
    return out


def _cuobjdump(flag: str, lib: Path) -> str:
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def main() -> int:
    for src, lib in _build.build_all().items():
        usage = resource_usage(_cuobjdump("-res-usage", lib))
        for kernel, ops in opcode_counts(_cuobjdump("-sass", lib)).items():
            mix = ", ".join(f"{op} {n}" for op, n in ops.most_common())
            print(f"{src}: {kernel}\n  {usage.get(kernel, 'no resource line')}\n"
                  f"  {sum(ops.values())} instructions: {mix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
