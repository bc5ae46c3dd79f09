"""vadc_tpu_torch — the PyTorch/CUDA port of vadc_tpu.

The same streaming Silero-VAD engine as `vadc_tpu` (raw 16 kHz mono s16le
PCM in, speech-segment timestamps out), written in PyTorch with hand-written
CUDA kernels for an NVIDIA Hopper card (sm_90a). `vadc_tpu` stays the
reference: every module here has the counterpart of the same name there, and
the tests hold the two to each other on the same weights and inputs.

This package imports `torch`, never `jax`, and nothing of `vadc_tpu`: of that
package's numpy-only modules it keeps its own copies at the same relative
paths (`io/*`, `cli/segmenter.py`, `cli/stats.py`, the ONNX readers in
`export/`, and `native.py` over the repository's `native/` sources). The
bundled weight archives under `vadc_tpu/data` are read by path.

Layering (bottom to top):
  runtime   device selection (and the device guard of a launch), TF32 off,
            the precision tiers' names
  tracing   spans and counters (free with the recorder off), torch.profiler traces
  io/       PCM, wav, resampler, ffmpeg source, .testtensor archives
  export/   numpy readers and the numpy executor of the official .onnx
            graphs (v3, fused v4/v5)
  native    ctypes over native/libvadc_native.so (stream pool, host FSM)
  nn/       plain PyTorch ops of the channels-last pipelines, and the four
            precision tiers (nn/precision.py)
  kernels/  CUDA kernels (csrc/*.cu, built with nvcc at first use) and
            their plain PyTorch versions
  models/   weight loading, the Silero v3.1, v4 and v5 forwards (16 kHz,
            and 8 kHz for v4 and v5), synthetic v5 archives
  engine/   stream runner (independent streams, step and slab scan),
            minibatch runner, vectorized segmentation FSM, checkpoints,
            stream sharding over devices (shard.py) and processes
            (distributed.py), the numpy graph-executor runner (--onnx_exec)
  cli/      the vadc-compatible command line and the offline corpus tool
  server    the multi-client serving daemon (TCP in, segment lines out)
"""

__version__ = "0.1.0"
