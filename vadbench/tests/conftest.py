"""The benchmark's own tests (run: python -m pytest vadbench/tests -q -p no:cacheprovider).

Tiny sizes on the CPU, on the port's plain versions; the tests marked
`cuda` need a card and skip without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: traffic parameters that shrink a cell to a CPU dry run
TINY = {
    "corpus": {"files": 3, "file_s": [3.0, 6.0], "sample_streams": 2},
}
