# Copy of vadc_tpu/cli/filter_script.py (standard library only): the port imports nothing
# of vadc_tpu and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Speech-timestamp CSV -> ffmpeg filterscript for cutting silence.

Reads `start,end` lines (the vadc CLI's segment output) on stdin and writes
an ffmpeg audio filtergraph selecting only the speech ranges, byte-compatible
with the reference companion tool (filter_script.c:4-23):

    asetpts=N/SR/TB, aselect='between(t,a,b)+between(t,c,d)+...', asetpts=N/SR/TB

Usage:  vadc input.mp3 | python -m vadc_tpu_torch.cli.filter_script > cut.txt
        ffmpeg -i input.mp3 -af "$(cat cut.txt)" output.mp3
"""

from __future__ import annotations

import sys
from typing import Iterable, TextIO


def build_filterscript(segments: Iterable[tuple[float, float]]) -> str:
    terms = "+".join(f"between(t,{a:f},{b:f})" for a, b in segments)
    return f"asetpts=N/SR/TB, aselect='{terms}', asetpts=N/SR/TB"


def parse_segments(lines: Iterable[str]) -> Iterable[tuple[float, float]]:
    for line in lines:
        line = line.strip()
        if not line:
            continue
        a, b = line.split(",")
        yield float(a), float(b)


def main(stdin: TextIO | None = None, stdout: TextIO | None = None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    stdout.write(build_filterscript(parse_segments(stdin)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
