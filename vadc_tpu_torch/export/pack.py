"""Embed a weight archive into an importable Python module (cembed parity).

The counterpart of vadc_tpu/export/pack.py, with the same module layout:
the archive's bytes inline (base85, 96 characters a line) and
`archive_bytes()`. The module's `load(device="cuda")` imports only
vadc_tpu_torch and returns (family, params) with the params on that device,
ready for vadc_tpu_torch.engine.runner.StreamRunner; like every entry point
of the port it runs on the card unless the caller passes device="cpu", and
raises without one.

    python -m vadc_tpu_torch.export.pack weights.testtensor embedded_weights.py
    # then:
    import embedded_weights
    family, params = embedded_weights.load()             # on the card
    family, params = embedded_weights.load(device="cpu")
"""

from __future__ import annotations

import base64
import sys
from pathlib import Path

_TEMPLATE = '''"""Embedded vadc_tpu_torch weight archive ({name}, {size} bytes).
Generated by vadc_tpu_torch.export.pack — do not edit."""

import base64

_DATA = b"""{payload}"""


def archive_bytes() -> bytes:
    return base64.b85decode(_DATA.replace(b"\\n", b""))


def load(device="cuda"):
    """Returns (family, params) on `device`, ready for
    vadc_tpu_torch.engine.runner.StreamRunner."""
    from vadc_tpu_torch.io.testtensor import load_testtensor_bytes
    from vadc_tpu_torch.models.weights import load_params_from_tensors
    from vadc_tpu_torch.runtime import resolve_device

    return load_params_from_tensors(load_testtensor_bytes(archive_bytes()),
                                    device=resolve_device(device))
'''


def pack(archive_path: str | Path, out_path: str | Path) -> None:
    data = Path(archive_path).read_bytes()
    encoded = base64.b85encode(data)
    lines = [encoded[i : i + 96] for i in range(0, len(encoded), 96)]
    payload = b"\n".join(lines).decode("ascii")
    module = _TEMPLATE.format(
        name=Path(archive_path).name, size=len(data), payload=payload
    )
    Path(out_path).write_text(module)


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m vadc_tpu_torch.export.pack <archive.testtensor> <out.py>",
              file=sys.stderr)
        return 2
    pack(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
