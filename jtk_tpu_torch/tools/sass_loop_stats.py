#!/usr/bin/env python3
"""Instruction count and static stall cycles of each kernel's row loop.

    cuobjdump -sass jtk_tpu_torch/_build/cuda/libphmm_tables-*.so > t.sass
    python3 -m jtk_tpu_torch.tools.sass_loop_stats t.sass [kernel-substring]
        [anchor]

For every function in the dump, the row loop is taken as the shortest
backward branch that encloses the function's first ``anchor`` instruction
(default ``SHFL.BFLY``, the row scale's reduction in the row wavefronts;
``SHFL.UP`` for K3's row scan, ``SHFL.IDX`` for the counts kernel's row
streams and K3's walk).  For that loop it prints the
instruction count, the sum of the stall counts the compiler encoded in the
control bits (bits 41-44 of the second 64-bit word, the Volta-family
layout), and the number of instructions that wait on a scoreboard.  A
kernel whose warps each have a scheduler to themselves takes about that
many cycles a row, plus the waits.
"""

from __future__ import annotations

import re
import sys

INS = re.compile(r"\s+/\*([0-9a-f]{4})\*/\s+(.*?)\s*;?\s*/\* (0x[0-9a-f]+) \*/")
WORD = re.compile(r"/\* (0x[0-9a-f]+) \*/")


def loop_stats(body: str, anchor: str = "SHFL.BFLY"):
    """(instructions, stall cycles, scoreboard waits) of the row loop, or
    None when the function has no such loop."""
    loop = loop_body(body, anchor)
    if loop is None:
        return None
    stalls = sum(c & 0xF for _, c in loop)
    waits = sum(1 for _, c in loop if (c >> 11) & 0x3F)
    return len(loop), stalls, waits


def loop_body(body: str, anchor: str = "SHFL.BFLY"):
    """The row loop's instructions as (text, control bits), or None."""
    lines = body.split("\n")
    ins = []
    for i, line in enumerate(lines):
        m = INS.match(line)
        if m and i + 1 < len(lines):
            hi = WORD.search(lines[i + 1])
            if hi:
                ins.append((int(m.group(1), 16), m.group(2),
                            int(hi.group(1), 16)))
    hits = [a for a, t, _ in ins if anchor in t]
    if not hits:
        return None
    first = min(hits)
    back = []
    for a, t, _ in ins:
        m = re.search(r"BRA 0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= first < a:
            back.append((a, int(m.group(1), 16)))
    if not back:
        return None
    end, start = min(back, key=lambda x: x[0] - x[1])
    return [(t, h >> 41) for a, t, h in ins if start <= a <= end]


def functions(text: str):
    """(name, body) of each function in a ``cuobjdump -sass`` dump."""
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        yield body.split("\n")[0].strip(), body


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__.strip().split("\n\n")[1], file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        text = f.read()
    pick = sys.argv[2] if len(sys.argv) > 2 else ""
    anchor = sys.argv[3] if len(sys.argv) > 3 else "SHFL.BFLY"
    for name, body in functions(text):
        if pick not in name:
            continue
        st = loop_stats(body, anchor)
        if st:
            print(f"{name[:60]}: {st[0]} instructions, {st[1]} stall "
                  f"cycles, {st[2]} scoreboard waits a row")
    return 0


if __name__ == "__main__":
    sys.exit(main())
