"""vadc_tpu_torch — the PyTorch/CUDA port of vadc_tpu.

The same streaming Silero-VAD engine as `vadc_tpu` (raw 16 kHz mono s16le
PCM in, speech-segment timestamps out), written in PyTorch with hand-written
CUDA kernels for an NVIDIA Hopper card (sm_90a). `vadc_tpu` stays the
reference: every module here has the counterpart of the same name there, and
the tests hold the two to each other on the same weights and inputs.

This package imports `torch` and never `jax`. From `vadc_tpu` it reuses only
the JAX-free modules: `vadc_tpu.io.*`, `vadc_tpu.cli.segmenter`,
`vadc_tpu.cli.stats`, the numpy ONNX readers in `vadc_tpu.export`, and
`vadc_tpu.native` (the stream pool and segmentation FSM the server drives).

Layering (bottom to top):
  runtime   device selection, TF32 off for the faithful tier
  nn/       plain PyTorch ops of the channels-last pipelines
  kernels/  CUDA kernels (csrc/*.cu, built with nvcc at first use) and
            their plain PyTorch versions
  models/   weight loading, the Silero v3.1, v4 and v5 forwards (16 kHz,
            and 8 kHz for v4 and v5), synthetic v5 archives
  engine/   stream runner (independent streams) and minibatch runner
  cli/      the vadc-compatible command line
  server    the multi-client serving daemon (TCP in, segment lines out)
"""

__version__ = "0.1.0"
