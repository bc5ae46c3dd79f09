# Copy of vadc_tpu/io/__init__.py: the port imports nothing of vadc_tpu and keeps its own.
from vadc_tpu_torch.io.resample import PolyphaseResampler
from vadc_tpu_torch.io.testtensor import (
    load_testtensor,
    load_testtensor_bytes,
    save_testtensor,
    save_testtensor_bytes,
)
from vadc_tpu_torch.io.wav import WavSource, read_file_s16, write_wav

__all__ = [
    "PolyphaseResampler",
    "WavSource",
    "load_testtensor",
    "load_testtensor_bytes",
    "read_file_s16",
    "save_testtensor",
    "save_testtensor_bytes",
    "write_wav",
]
