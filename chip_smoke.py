#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vadc_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. the card's name and power limit; build the CUDA kernels from
     vadc_tpu_torch/kernels/csrc/ with nvcc for sm_90a (one nvcc per
     source, in parallel); the kernels whose device code is shared through
     headers (forward_fused2d, dot_magnitude, forward_fused) give the bits
     they gave before that code moved into the headers, and stft_magnitude
     at the four v4/v5 family geometries the bits of its first design
     (PARENT_DIGESTS);
  2. each kernel against its plain PyTorch version on the card:
     - Silero v3.1 (bundled weights) and synthetic speech: dot_magnitude
       and the fused encoder/LSTM/decoder at B=2048 chunks of 1536
       samples, B=1, B=37 (a ragged last block), 512-sample chunks;
     - forward_fused (the whole v3.1 step from raw audio) from a carried
       state at B=2048, 1, 37 x 1536 and B=2048 x 512, 768, 1024, 1280,
       and on a BN-folded copy of the weights; also against
       forward_fused2d(features(audio)), its spectrum bit for bit against
       dot_magnitude's, and its state in place;
     - encode_fused_audio (the step kernel's front-end and encoder alone,
       the slab route's front half) at the same shapes: against its plain
       version, and lstm_decoder_fused(encode_fused_audio(audio)) against
       forward_fused(audio) bit for bit;
     - stft_magnitude at every v4/v5 geometry (v4 16 kHz B=2048/1/37 x
       1536, v4 8 kHz 768 and 256, v5 576, v5 8 kHz 288), and bit for bit
       against dot_magnitude on the reflect-padded unfold;
     - lstm_fused at the v4 shape (L=2, H=64: B=2048 x T=3, B=1 x T=288,
       a ragged B=333 x T=12) and the v5 shape (L=1, H=128: B=2048 x T=1,
       B=1 x T=96, B=333 x T=4) from a carried state: the wrapper's call
       against the plain version, then both variants of the kernel
       (streaming weights, resident weights; the latter also in every
       alternative of its kernel and in several passes) launched explicitly and held
       bit for bit to it; at B=1, the one call over the window against one
       call per chunk's frames with the state in place, bit for bit;
     - lstm_decoder_fused (the LSTM with the v3 decoder folded in, over K
       chunks of each stream in order) on encode_fused's output at B=2048
       x K=1 x T=7, B=37 x K=5 x T=3..7 (a ragged block, every chunk
       size), B=1 x K=96 x T=7, B=333 x K=3 x T=7 and with the chunks cut
       to 1 and 2 frames (B=37 x K=5, B=2048 x K=1): against its plain
       version, in place, its one entry launched explicitly in one pass and
       in several bit for bit, the K-chunk call against K single calls bit
       for bit, its state against lstm_fused's over the same frames bit for
       bit, and (whole chunks) lstm_decoder_fused(encode_fused(feats))
       against forward_fused2d bit for bit; encode_fused against the plain
       encoder stages;
     - fsm_scan (the batch segmenter's FSM, kernels/fsm.py) at the corpus
       cells' shape, 512 streams x 64 columns, over two slabs in turn with
       valid_chunks 0, inside either slab and past both, on probabilities
       at the fp32 thresholds and one ulp either side: its [3, T, B] events
       and state bit for bit those of segment_batch on the card;
  3. the main paths, each with the kernels' launch counts set to 0 just
     before and read just after (each kernel of the path must be > 0):
     - v3.1: StreamRunner.scan over 2048 streams x 8 chunks on the card
       (the slab route: encode_fused_audio, lstm_decoder_fused) against
       the same on the CPU (plain versions) and, bit for bit, against the
       loop of StreamRunner.step on the card (forward_fused), then the vadc
       CLI on a 12 s synthetic file with --device cuda and --device cpu
       (identical segments, raw probabilities within 1e-4;
       encode_fused_audio and lstm_decoder_fused);
     - the offline corpus CLI (vadc_tpu_torch.cli.batch) over 24 seeded
       files of 5 to 40 s (one pure silence, one 44.1 kHz wav) with
       --cut_dir, --device cuda against --device cpu: identical lines and
       cut files, and per file the lines of the streaming CLI (fsm_scan
       > 0 besides the family's scan kernels); the same with the bundled
       v4 archive and a synthetic v5 archive (their slabs the v4 and v5
       scans);
     - v4: StreamRunner.scan 2048 x 8 card vs CPU, and the CLI with the
       bundled v4 16 kHz and 8 kHz archives, cuda vs cpu;
     - v5: StreamRunner.scan 2048 x 8 card vs CPU (the audio context
       carried), and MinibatchRunner (the CLI's runner) over two 96-chunk
       windows for v5 and v5 8 kHz, card vs CPU. The v5 weights are
       synthetic, from vadc_tpu_torch.models.synthetic at a fixed seed;
     - the v4/v5 slab scan (phase_slabs_v45: forward_scan, models/slab.py)
       of v4, v4_8k, v5 and v5_8k at faithful and each bf16 tier on seeded
       speech slabs of 2048 x 8 and 64 x 64: each scan's launches read
       alone (stft_magnitude once a piece of SCAN_PIECE_CHUNKS chunks,
       lstm_fused those of one call over the slab's frames), the scan
       against the loop of StreamRunner.step bit for bit or, where the card
       gives other bits, the context equal, stft_magnitude over a piece
       equal to its chunk columns (the difference enters at the encoder's
       cuBLAS products) and the run within tier_check.shard_bound(family,
       tier) beside a control at another tier that must break it; the
       first 256 streams card vs CPU within TOL_PATH / PATH_MAX;
     - the serving daemon (vadc_tpu_torch.server, bundled v3.1, 64 slots)
       on localhost: 8 clients send 20 s of seeded speech each, unpaced;
       each client's segment lines equal those of the same server on the
       CPU (forward_fused); logs tick_count, catchup_ticks, tick p50/p99;
     - server checkpoints: the same clients cut near their middle; part 1
       into a server, save_checkpoint while it serves once every chunk is
       through (a segment held pending in some slot), stop; a fresh server
       restored from the file takes part 2 from the clients reconnecting in
       the same order: each client's lines those of the uninterrupted run,
       card to card, card to CPU and CPU to card (forward_fused), then card
       to card at --precision fast and with the synthetic v5 archive (the
       audio context in the state; stft_magnitude, lstm_fused);
     - the Python API (vadc_tpu_torch.api) for v3.1, v4, v4_8k, v5 and
       v5_8k on 30 s of seeded speech at each family's rate, card against
       CPU: speech_probabilities within 1e-4 (the synthetic v5 weights
       1e-5), detect_speech_samples and stream_segments the same segments
       on both devices and as each other; detect_speech on a 44.1 kHz wav;
     - the cutter (vadc_tpu_torch.cli.cut) on a seeded wav and on raw
       s16le, --device cuda against --device cpu: identical output bytes;
  3b. the bf16 tiers (balanced, fast, turbo) of the v3.1 path: each tier
     instance (forward_fused, encode_fused_audio, forward_fused2d,
     lstm_decoder_fused, dot_magnitude) against its plain version at the
     tier at B=2048, 1, 37 x 1536 and 2048 x 512, the plain version fed the
     kernel's own spectrum, held to kernels/tier_check.py (the share of
     outputs that differ by more than its tau, and the largest difference),
     and as a control the faithful instance against the same plain version,
     which must fail those limits; the step kernel's spectrum bit for bit
     against dot_magnitude's instance and lstm_decoder_fused on either
     encoder entry's rows bit for bit against the fused kernel; the
     instances' digests (TIER_DIGESTS); the tensor-core spectrum at its
     tiles' edges (phase_spectrum_edges: B=37 x 1536 and x 512, the step
     kernel's, dot_magnitude's and stft_magnitude's spectra bit for bit and
     each held to tier_check; v5 8 kHz's 65 bins at each bf16 mode); per tier, the loop of
     StreamRunner.step against StreamRunner.scan 2048 x 8 bit for bit, and
     the tier against faithful on the speech tracks of seeds 0-11
     (StreamRunner.scan within tier_check's SPEECH_BOUND, the segments as
     tier_on_speech says, the CLI's on seed 0 identical), each counted
     (forward_fused, encode_fused_audio, lstm_decoder_fused > 0); at fast,
     the batch CLI (--fast) over the corpus and the server (--precision
     fast) over its clients, counted, their lines logged beside faithful's;
  3c. the bf16 tiers of v4 and v5: stft_magnitude's instance of each
     products' mode (nn/precision.py: stft_mode) at the four family
     geometries at B=2048 and 37, lstm_fused's instance of each tier at v4
     B=2048 x T=3 and B=1 x T=288, v5 B=2048 x T=1 and B=1 x T=96 (both
     variants and the cluster kernel), each against its plain version at the
     tier by kernels/tier_check.py beside a control (the fp32 or faithful
     instance, which must break the limits at bf16 operands), the spectrum
     bit for bit against dot_magnitude's instance of the same operands and
     the two LSTM variants against each other, their digests in
     TIER_DIGESTS; per tier, counted (stft_magnitude, lstm_fused > 0):
     StreamRunner.scan 256 x 8 of v4, v4_8k, v5 and v5_8k and MinibatchRunner
     of v5 and v5_8k card vs CPU within tier_check's PATH_MAX, each family
     over the 12 speech tracks (12 streams of one scan) within its
     SPEECH_BOUND, and at fast the v4 CLI card vs CPU;
  3d. stream sharding (multi-device): ShardedStreamRunner over two
     shards of the card (["cuda:0", "cuda:0"]) against the unsharded
     runner bit for bit: the v3.1 step at B=2048 x 1536 and the 2048 x 8
     scan, the v4 step at B=2048, and the v5 step and 2048 x 8 scan within
     tier_check's SHARD_BOUND (its encoder's torch products; its spectrum
     kernel by halves bit for bit), beside two controls that must break it
     (half the streams by the plain versions, and by the fast tier); each
     call's launches read alone, the sharded call's n_shards times the
     unsharded call's (forward_fused; encode_fused_audio and
     lstm_decoder_fused; stft_magnitude and lstm_fused); the batch CLI over
     the 24-file corpus on the two shards against one device (identical
     lines and cut files, twice the launches, fsm_scan's as often: the
     segmenter runs on the first card over the gathered slab); the server with its slots
     on the two shards, the 8 clients of the server phase (each client's
     lines those of the unsharded server), its checkpoint resumed sharded
     -> unsharded and back (the uninterrupted run's lines, and the sharded
     save byte for byte the unsharded one), each server's launches those
     of one step per chunk-step of each shard; the v5 server (synthetic
     weights) on the two shards, each client's lines the unsharded v5
     server's; tools/torch_multidevice_dryrun.py
     --device cuda (2 processes x 2 devices over gloo); with two cards or
     more the same over distinct cards and a step on cuda:1 launched under
     cuda:0 against cuda:0's bits (else one line says they were skipped);
     one v3.1 step under tracing.profile, whose trace must name
     forward_fused; then, in turns over 7 repeats (median and spread), ms
     per chunk-step at B=2048 for v3.1 and v4 on 2 shards against
     unsharded, _tick at 2048 slots sharded and unsharded, and the v3.1
     StreamRunner.step (its device guard and zone, no profile) against
     forward_fused alone;
  3e. the tools (phase_tools), their launches counted in that window alone
     (bf16_dot, bf16_dot_wgmma and concat_dot each > 0), under 120 s:
     tools/gpu_check.run_checks on the card, "ok" required (tpu_check's
     checks under its names and bounds, forward_fused, encode_fused_audio
     and stft_magnitude at v4 and v5 beside them, and the two probes of
     tools/tpu_check.py as tensor-core kernels, kernels/probes.py: exact
     6.0 and within 1e-3 of fp32 at the probe's inputs, within 1e-5 of
     their plain versions at seeded shapes, among them shapes whose
     strides TMA cannot take, staged by the kernels' threads, both
     controls broken);
     tools/torch_accuracy_eval at every tier on v3.1 (16 utterances;
     balanced and fast score as faithful, turbo's row logged); the
     degradation matrix at faithful, card against CPU, identical rows; a
     pack of the bundled v3.1 archive (export/pack.py) loaded on the card,
     its step the bundled params' bits; export/torch_export.py on a state
     dict built from the bundled archive, the archive's bytes;
     tools/torch_serve_bench.py (64 clients, 10 s at rtf 4, faults and
     checkpoints; every client's segments, RSS growth after the first tick
     at full occupancy within 64 MB); 10 minutes of audio through
     tools/torch_soak.py; then the probes timed at the probe's shapes and
     at the v4 gate product's (2048 x [64 | 64] x 256), kernel, plain
     version and library call by their device time (torch.profiler; the
     library call of bf16_dot's function torch.mm(x, w,
     out_dtype=torch.float32), bf16 torch.matmul beside it);
  3f. the ported tools (phase_ported_tools), their launches counted in
     that window alone (forward_fused, encode_fused_audio, stft_magnitude
     and lstm_fused each > 0), under 150 s: tools/torch_bench_stages.py at
     B=2048, fast, for v3.1, v4 and v5 at T 8/72 (the full prefix equal to
     forward's output bit for bit; every row logged, wall and device time);
     tools/torch_validate_v5.py on the synthetic v5 graph (onnx_build from
     random_v5_archive(7) and random_v5_8k_archive(8)), PASSED at its
     default atol 1e-5; tools/torch_rss_attrib.py with 8 clients for 6 s
     at rtf 4 (0 client errors, ticks > 0; the three growth figures
     logged); tools/torch_ingest_bench.run_ingest with and without the FSM
     (512 pipes, 2 s each; the realtime-stream equivalents logged); and
     tools/torch_tensor_image.py on the bundled v3.1 archive (a PGM file a
     tensor);
  3g. the live-stream examples (phase_examples), their launches counted in
     that window alone (forward_fused, stft_magnitude and lstm_fused each >
     0), under 240 s: examples/serve_streams_torch.py over 2048 streams and
     examples/serve_pool_torch.py over 256 `cat` producers, each by its
     main(argv) on the card, for v3.1 and v4 at faithful, v3.1 at --fast
     and the synthetic v5 at faithful, on 16 seeded speech files of 8 to 12
     s (a link a stream, so each stream's lines carry its own name; each
     aggregate-realtime line logged beside the card's name and power
     limit); serve_pool_torch's events per file those of serve_streams_torch
     over the same 256 streams while the file lasts, bit for bit; 16 streams
     again with --device cpu, the card's events under compare_events' rule
     (identical, or a boundary moved by one chunk where the CPU's
     probability lies within the path's bound of a threshold, each such
     chunk logged);
  4. timings with CUDA events: each kernel against its plain version
     (stft_magnitude at every family geometry at B=2048 and at the v4 CLI
     window, each with its own bound; beside the two spectrum kernels,
     cuBLAS's fp32 product of the same frames alone as a yardstick),
     forward_fused against features + forward_fused2d, ms per chunk-step
     of the whole step at batch 2048 for v3.1 (and the two-kernel v3.1
     step, features + forward_fused2d), v4
     and v5, the server's _tick and _tick2 at 2048 slots (v3.1, v5);
     StreamRunner.scan by slab against the loop of steps at 2048 x 8 and
     64 x 64, encode_fused_audio, features, encode_fused and
     lstm_decoder_fused alone at those shapes,
     the CLI's window of 96 chunks against 96 launches of forward_fused2d,
     the batch CLI's audio seconds per wall second, torch.nn.LSTM
     (cuDNN) on the LSTM kernels' inputs as the library's time, both
     variants of lstm_fused (and lstm_decoder_fused's one) at B = 1, 64,
     2048 over a range of steps (the crossover behind kernels/lstm.py's
     RESIDENT_MIN_STEPS);
     per tier beside faithful in one call: each tier instance against its
     plain version, forward_fused at B=1, the v3.1 step, the 64 x 64 and
     2048 x 8 slabs, the CLI window, the server's ticks at 2048 slots, and
     cuBLAS's bf16 product of the frames beside the fast spectrum; per tier
     the v4/v5 instances (stft_magnitude at the four geometries, lstm_fused)
     against their plain versions and the v4 and v5 B=2048 steps; cuDNN's
     torch.nn.LSTM in bf16 (weights, inputs and state) beside the tiers'
     lstm_fused and lstm_decoder_fused rows as a yardstick, not the same
     function (its state is bf16); cuFFT
     (torch.stft, torch.fft.rfft) beside the two spectrum kernels, their
     library_ms where the basis is the Hann DFT (v3.1's, v4's, v4_8k's;
     v5's is another); save_checkpoint and
     restore_checkpoint of a 2048-slot v3.1 server (wall time), the ticks'
     p50/p99 while saves run beside them against the ticks no save
     overlaps, and api.speech_probabilities' audio seconds per wall second
     over 60 s of speech for v3.1, v4 and v5 (v4 and v5 beside the loop of
     StreamRunner.step over the same chunks, the API's route before their
     slab scan); the v4/v5 slab scans against the loop of steps at 2048 x 8
     and 64 x 64 at every tier, in turns in one call, and the scan's peak
     device memory at 2048 x 8 and 2048 x 64 (phase_timing_slabs_v45).

Prints a JSON line of per-kernel results, a row per tier instance too
("forward_fused[fast]", ...: its tier's bound, the bf16 tensor-core peak
at the bf16 tiers) (time, plain version's time, the
bound from this run's shapes, the library call's time where there is one
(cuFFT beside the spectrum kernels), and `cublas_product_only_ms` beside
them (the product alone, no library time);
launches 0 for a kernel that no main path runs any more: dot_magnitude and
forward_fused2d stay public functions, checked and timed here; the three
probe kernels at the v4 gate product's shape, by device time, their
launches those of the tools phase, replacing tools/tpu_check.py:54 and
:77), then the card's name and power limit, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX. Needs one card; exits 1 without one.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 16000
B_MAIN = 2048
CHUNK = 1536
SCAN_CHUNKS = 8
SEED = 0
# kernel vs plain on the card: both are fp32; they differ only in the order
# of the sums (tiled FMAs vs cuBLAS) and in expf/tanh implementations
TOL_DOTMAG_REL = 1e-5  # of the largest magnitude
# probs 1e-5. The state passes 14 recurrent cell updates (7 frames x 2
# layers), each an fp32 sum of 128 products: summed in another order, h
# moves by ~1e-5 over 2048 streams (measured on an H100: kernel 1.2e-5; the
# plain version on the card against itself on the CPU, logged beside each
# check, is of the same order), so h and c are held to 5e-5, c relative to
# its largest value (c is an unbounded running sum).
TOL_FUSED = {"probs": 1e-5, "hn": 5e-5, "cn": 5e-5}
# port on the card vs port on the CPU, through the whole model
TOL_PATH = 1e-4
# lstm_fused vs plain on the card: both fp32, the kernel sums each gate's
# 2H products in k order, cuBLAS in its own. The same bound as the fused
# kernel's state (c relative to its largest value): the synthetic v5
# weights drive gate pre-activations to tens, where an fp32 ulp is ~4e-6
TOL_LSTM = 5e-5
# forward_fused (the whole v3.1 step from raw audio) against its plain
# version on the card, and against features + forward_fused2d: the spectra
# are summed in other orders (the kernel's fmaf chains vs cuBLAS's unfold GEMM),
# and the normalization's log1p(2^20 x) amplifies that at near-zero bins
# (ROADMAP Queue 3), so the whole-model bounds of the CPU parity tests
# hold: probs 1e-4, h 3e-4, c 3e-4 of its largest value
TOL_FUSED_AUDIO = {"probs": 1e-4, "hn": 3e-4, "cn": 3e-4}
FUSED_AUDIO_SAMPLES = (512, 768, 1024, 1280, 1536)
# sha256 digests (shared_code_digests, stft_digests) of the kernels whose
# device code moved into headers (silero_v31_body.cuh, stft_tile.cuh), from
# the sources before the move, on an H100 80GB HBM3 (700 W): the move must
# leave their outputs bit for bit
PARENT_DIGESTS = {"forward_fused2d": "6d6e602fd6f5405b", "forward_fused2d_ragged": "32c8579105cb8cbd",
                  "dot_magnitude": "aa1f71c035ea6ba5",
                  # forward_fused, from the sources before the body's LSTM and
                  # decoder became functions that lstm_decoder.cu shares
                  "forward_fused": "e09d095c326b455f", "forward_fused_ragged": "86c6c25c68636077",
                  # stft_magnitude at the four family geometries (stft_digests),
                  # from its first design (the 64 x 32 tile) before the spectrum
                  # was fitted to streams
                  "stft_magnitude_v4": "fe673efd6c1997d2", "stft_magnitude_v4_8k": "3926a382740d2ea4",
                  "stft_magnitude_v5": "b54fae0a7716f353", "stft_magnitude_v5_8k": "2f4f7898f725909c"}
# streams of the recurrent kernels' calls on part of a batch at a tier: 3 a
# block at 132 SMs, the last block ragged; their bits those of the same
# streams in the whole call
RAGGED_STREAMS = 301
# v4 and v5 chunk sizes of the paths below (model samples)
V4_CHUNK, V4_8K_CHUNK, V5_CHUNK, V5_8K_CHUNK = 1536, 768, 512, 256
CLI_WINDOW = 96  # chunks per CLI window (the CLI's --batch default)
# the server phase: slots, clients, seconds of speech per client
SERVER_SLOTS, SERVER_CLIENTS, SERVER_AUDIO_S = 64, 8, 20.0
TICK_SLOTS = 2048  # the slots of the timed server ticks (and the timed checkpoints)
# the server's ticks timed against saves running beside them
OVERLAP_TICKS = 600
# the Python API and the cutter: seconds of seeded speech; the API's card
# against CPU bound on probabilities (TOL_PATH, and the synthetic v5
# weights' own, that of the CPU parity tests), and the kernels each
# family's path must launch
API_SECONDS, API_TIMED_SECONDS, CUT_SECONDS = 30.0, 60.0, 20.0
TOL_API = {"v5": 1e-5, "v5_8k": 1e-5}
API_KERNELS = {"v3": ("encode_fused_audio", "lstm_decoder_fused"),
               **{f: ("stft_magnitude", "lstm_fused") for f in ("v4", "v4_8k", "v5", "v5_8k")}}
# the corpus path: files, their lengths in seconds, the slab
CORPUS_FILES, CORPUS_SECONDS, SLAB_CHUNKS = 24, (5.0, 40.0), 64
# encode_fused against the plain encoder stages: fp32 both, other orders of
# the sums through four stages of products, norms and a softmax; the
# faithful tier's per-op bound, absolute, on activations of up to about 7
# (a first bound of 1e-5 of the largest activation was passed at 1.1e-5)
TOL_ENCODE = 1e-4
# encode_fused_audio against its plain version: the spectra are summed in
# other orders and log1p(2^20 x) amplifies that at near-zero bins before the
# four stages: held at 5e-4 absolute on activations of up to about 7
# (measured on an H100: 2.9e-4 at B=2048 x 1536, the largest of 917,504
# values; 1.0e-5 to 1.5e-4 at the other shapes)
TOL_ENCODE_AUDIO = 5e-4
# the card's published peaks (NVIDIA H100 SXM data sheet): fp32 outside the
# tensor cores, bf16 dense on the tensor cores, and device memory
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12
# the bf16 precision tiers of the v3.1 path (vadc_tpu_torch/nn/precision.py);
# each instance is held to its plain version, and each tier to faithful on
# speech, by the limits of vadc_tpu_torch/kernels/tier_check.py
TIERS = ("balanced", "fast", "turbo")
# streams of the v4/v5 tiers' scans card against CPU (the CPU's plain
# versions at a bf16 tier cost more than at faithful)
TIER_PATH_BATCH = 256
# the speech tracks of the tiers' check against faithful (utterance_track(4,
# seed)): seed 0 is the material of the JAX package's recorded deviations
SPEECH_SEEDS = range(12)
# digests of the tier instances' outputs (tier_digests), recorded on an
# NVIDIA H100 80GB HBM3 (700 W) when the instances were written, again
# when the encoder's products and the bf16_3x spectrum moved to the tensor
# cores (the lstm_fused and the bf16 stft_magnitude entries held), and again
# when the LSTMs' gate sums did (the turbo v3.1 and the stft_magnitude
# entries held): a later change of their device code must keep them, as
# PARENT_DIGESTS holds the faithful instances
TIER_DIGESTS = {
    "forward_fused2d[balanced]": "a03d5c74f33c472c", "forward_fused[balanced]": "71f6ed37e31c4ce4",
    "forward_fused_ragged[balanced]": "0162b6a8312945f7",
    "forward_fused2d[fast]": "2f63a4a6f84384d7", "forward_fused[fast]": "af7af7ada5391b7d",
    "forward_fused_ragged[fast]": "9ea09a8f5dcf965f",
    "forward_fused2d[turbo]": "172a5345453aa290", "forward_fused[turbo]": "bb956bfa433192e8",
    "forward_fused_ragged[turbo]": "8b57c57494b2d5a1",
    # the v4/v5 paths' instances (tier_v45_digests): stft_magnitude by its
    # products' mode, lstm_fused by tier (fast and turbo: one arithmetic)
    "stft_magnitude_v4[bf16]": "278c65b74b78407f", "stft_magnitude_v4[bf16_3x]": "33ccf8c8500137e0",
    "stft_magnitude_v4_8k[bf16]": "b777981eb0ae0d85",
    "stft_magnitude_v4_8k[bf16_3x]": "afd10d17df97b45f",
    "stft_magnitude_v5[bf16]": "d7c20c9597a5a3bf", "stft_magnitude_v5[bf16_3x]": "706cb64b683c039f",
    "stft_magnitude_v5_8k[bf16]": "d7cc916725180655",
    "stft_magnitude_v5_8k[bf16_3x]": "a7ff720c9f70caad",
    "lstm_fused_v4[balanced]": "ac54394b07ccc15f", "lstm_fused_v4_long[balanced]": "c860595818a72fb0",
    "lstm_fused_v4[fast]": "15e5cd1febb26d54", "lstm_fused_v4_long[fast]": "ce23bd494cb0c30b",
    "lstm_fused_v4[turbo]": "15e5cd1febb26d54", "lstm_fused_v4_long[turbo]": "ce23bd494cb0c30b",
    "lstm_fused_v5[balanced]": "c3e5f23aa90c21bb", "lstm_fused_v5_long[balanced]": "e4eb0f7f4a1a2801",
    "lstm_fused_v5[fast]": "f2553cb2e82e9cb7", "lstm_fused_v5_long[fast]": "ef4490b21d777379",
    "lstm_fused_v5[turbo]": "f2553cb2e82e9cb7", "lstm_fused_v5_long[turbo]": "ef4490b21d777379"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def voiced(duration_s: float, f0: float = 120.0, amplitude: float = 0.3,
           breath: float = 0.0, rng: np.random.Generator | None = None) -> np.ndarray:
    """Speech-like signal that Silero v3.1 reads as speech: 24 harmonics of
    f0 under three formant envelopes (~500/1500/2500 Hz), a 3 Hz syllabic
    envelope, and optionally a broadband breath floor (relative to the
    peak) that keeps the bins between harmonics off the rounding floor."""
    t = np.arange(int(duration_s * SR)) / SR
    sig = np.zeros_like(t)
    for k in range(1, 25):
        f = k * f0
        w = (np.exp(-((f - 500) / 400) ** 2) + 0.7 * np.exp(-((f - 1500) / 500) ** 2)
             + 0.3 * np.exp(-((f - 2500) / 700) ** 2))
        sig += w * np.sin(2 * np.pi * f * t + k)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t - np.pi / 2))
    sig = amplitude * sig * env / np.abs(sig * env).max()
    if breath > 0:
        sig += breath * amplitude * env * rng.normal(size=len(t))
    return sig


def speech_chunks(n: int, chunk: int, seed: int = SEED) -> np.ndarray:
    """n chunks of synthetic speech from `seed`: near-silent gaps of
    0.8-2.5 s and voiced spans of 0.6-3.5 s at f0 140-210 Hz, level
    0.25-0.5, with a breath floor of 2e-3."""
    rng = np.random.default_rng(seed)
    need = n * chunk
    pieces, total = [], 0
    while total < need:
        gap = 0.001 * rng.normal(size=int(rng.uniform(0.8, 2.5) * SR))
        span = voiced(rng.uniform(0.6, 3.5), rng.uniform(140, 210), rng.uniform(0.25, 0.5),
                      breath=2e-3, rng=rng)
        pieces += [gap, span]
        total += len(gap) + len(span)
    return np.concatenate(pieces)[:need].reshape(n, chunk).astype(np.float32)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def same_bits(out, got) -> bool:
    import torch

    return all(torch.equal(a, g) for a, g in zip(out, got))


def variant_diffs(variants: dict, got, names) -> str:
    """For each variant that differs from `got`: the largest absolute
    difference of each output."""
    return "; ".join(
        f"{name}: " + ", ".join(f"{n} {max_abs(a, g):.3e}" for n, a, g in zip(names, out, got))
        for name, out in variants.items() if not same_bits(out, got))


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call of fn on the card, from CUDA events around
    `iters` calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_pair(a, b, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Times of a and b taken in turns (a, b, b, a), each the mean of its
    two runs, so a drift of the card's clocks falls on both alike."""
    a1, b1 = cuda_ms(a, iters, warmup), cuda_ms(b, iters, warmup)
    b2, a2 = cuda_ms(b, iters, warmup), cuda_ms(a, iters, warmup)
    return (a1 + a2) / 2, (b1 + b2) / 2


def digest(*tensors) -> str:
    """sha256 (first 16 hex digits) of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def shared_code_digests(params, device) -> dict:
    """Digests of the outputs of the kernels whose device code is shared
    through headers (forward_fused2d through silero_v31_body.cuh,
    dot_magnitude through stft_tile.cuh) on inputs made from a seed alone:
    fused2d at B=2048 x 25 frames (random features, carried state) and at
    a ragged B=37 x 9 frames; dot_magnitude over 2048 chunks of speech;
    forward_fused (both headers) at B=2048 x 1536 and a ragged B=37 x 512
    samples of speech, from a random carried state."""
    import torch

    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, split_basis
    from vadc_tpu_torch.nn import functional as F

    rng = np.random.default_rng(SEED + 7)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    feats = t(2.0 * rng.normal(size=(B_MAIN, 25, 129)))
    h = t(0.5 * rng.normal(size=(2, B_MAIN, 64)))
    c = t(3.0 * rng.normal(size=(2, B_MAIN, 64)))
    full = forward_fused2d(params, feats, h, c)
    ragged = forward_fused2d(params, feats[:37, :9].contiguous(), h[:, :37].contiguous(),
                             c[:, :37].contiguous())
    audio = t(speech_chunks(B_MAIN, CHUNK, seed=SEED + 8))
    wr, wi = split_basis(params["stft_basis"])
    mag = dot_magnitude(F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64), wr, wi)
    out = {"forward_fused2d": digest(*full), "forward_fused2d_ragged": digest(*ragged),
           "dot_magnitude": digest(mag)}
    rng = np.random.default_rng(SEED + 9)
    for name, b, samples in (("forward_fused", B_MAIN, CHUNK), ("forward_fused_ragged", 37, 512)):
        chunks = t(speech_chunks(b, samples, seed=SEED + 10))
        h = t(0.5 * rng.normal(size=(2, b, 64)))
        c = t(3.0 * rng.normal(size=(2, b, 64)))
        out[name] = digest(*forward_fused(params, chunks, h, c))
    return out


def family_models(device) -> tuple[dict, dict]:
    """The v4 and v5 families as the paths run them: (archives, models),
    models: family -> (model module, params on the card); v4 and v4_8k the
    bundled official weights, v5 and v5_8k synthetic weights of the official
    shapes from fixed seeds."""
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.models import silero_v4, silero_v5
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive
    from vadc_tpu_torch.models.weights import load_params, load_params_from_tensors

    archives = {"v4": DEFAULT_WEIGHTS.parent / "silero_v4_16k.testtensor",
                "v4_8k": DEFAULT_WEIGHTS.parent / "silero_v4_8k.testtensor"}
    models = {
        "v4": (silero_v4, load_params(archives["v4"], device=device)[1]),
        "v4_8k": (silero_v4.v4_8k, load_params(archives["v4_8k"], device=device)[1]),
        "v5": (silero_v5, load_params_from_tensors(random_v5_archive(0), device=device)[1]),
        "v5_8k": (silero_v5.v5_8k,
                  load_params_from_tensors(random_v5_8k_archive(1), device=device)[1]),
    }
    return archives, models


def stft_geometry(family: str, module) -> tuple[int, dict]:
    """(samples stft_magnitude sees per chunk, its pads and hop) on the
    main path of a family: v4 pads 96/96, v5 attaches its context and pads
    the right side only."""
    from vadc_tpu_torch.models import silero_v4

    chunk = {"v4": V4_CHUNK, "v4_8k": V4_8K_CHUNK, "v5": V5_CHUNK, "v5_8k": V5_8K_CHUNK}[family]
    if family.startswith("v4"):  # the 8 kHz branch frames as the 16 kHz model does
        return chunk, dict(pad_left=silero_v4.STFT_PAD, pad_right=silero_v4.STFT_PAD,
                           hop=silero_v4.STFT_HOP)
    return module.CONTEXT_SAMPLES + chunk, dict(pad_left=0, pad_right=module.STFT_PAD_RIGHT,
                                                hop=module.STFT_HOP)


def stft_digests(models: dict, device) -> dict:
    """Digests of stft_magnitude at the four family geometries, B=B_MAIN
    chunks of speech from a seed: name -> digest."""
    import torch

    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude

    out = {}
    for family, (module, params) in models.items():
        samples, kw = stft_geometry(family, module)
        audio = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + 11)).to(device)
        out[f"stft_magnitude_{family}"] = digest(stft_magnitude(audio, *split_basis_of(params), **kw))
    return out


def phase_build() -> float:
    from vadc_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    log(f"build: {seconds:.2f} s, nvcc {' '.join(_build.NVCC_FLAGS)}")
    log(f"build: sources {[str(p.relative_to(ROOT)) for p in _build.sources()]}")
    log(f"build: headers {[str(p.relative_to(ROOT)) for p in _build.headers()]}")
    log(f"build: library {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


def phase_shared_code(params, models, device) -> None:
    """The kernels whose device code is shared through headers give the
    bits they gave before that code moved into the headers, and
    stft_magnitude the bits of its first design at every family geometry."""
    got = {**shared_code_digests(params, device), **stft_digests(models, device)}
    log(f"shared device code digests: {json.dumps(got)}")
    log(f"before the header move: {json.dumps(PARENT_DIGESTS)}")
    for name, want in PARENT_DIGESTS.items():
        require(got[name] == want, f"{name}: outputs differ from before the header move ({got[name]} vs {want})")


def check_dot_magnitude(params, audio, label: str) -> float:
    from vadc_tpu_torch.kernels.stft_dotmag import (
        dot_magnitude, dot_magnitude_reference, split_basis,
    )
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    import torch

    frames = F.frame(
        F.reflect_pad_last(audio, silero_v31.STFT_PAD, silero_v31.STFT_PAD), 256, silero_v31.STFT_HOP
    )
    wr, wi = split_basis(params["stft_basis"])
    out = dot_magnitude(frames, wr, wi)
    ref = dot_magnitude_reference(frames, wr, wi)
    torch.cuda.synchronize()
    require(out.shape == ref.shape, f"dot_magnitude shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    require(bool(torch.isfinite(out).all()), "dot_magnitude: non-finite output")
    err = max_abs(out, ref)
    rel = err / float(ref.abs().max().item())
    log(f"dot_magnitude {label}: shape {tuple(out.shape)} max abs err {err:.3e}, "
        f"relative to max magnitude {rel:.3e} (bound {TOL_DOTMAG_REL:g})")
    require(rel <= TOL_DOTMAG_REL, f"dot_magnitude {label}: relative error {rel:.3e}")
    return err


def check_fused(params, audio, label: str) -> float:
    import torch

    from vadc_tpu_torch.engine.runner import params_to
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.models import silero_v31

    b = audio.shape[0]
    feats = silero_v31.features(params, audio)
    # a realistic carried state: one plain step on other audio first
    h0, c0 = silero_v31.init_state(b, audio.device)
    _, h, c = forward_fused2d_reference(params, feats.flip(0).contiguous(), h0, c0)
    probs, hn, cn = forward_fused2d(params, feats, h, c)
    p_ref, h_ref, c_ref = forward_fused2d_reference(params, feats, h, c)
    torch.cuda.synchronize()
    # the rounding floor: the plain version on the CPU against itself on the card
    cpu_params = params_to(params, torch.device("cpu"))
    floor = forward_fused2d_reference(cpu_params, feats.cpu(), h.cpu(), c.cpu())
    errs, bounds, floors = {}, {}, {}
    for i, (name, got, want) in enumerate(
        (("probs", probs, p_ref), ("hn", hn, h_ref), ("cn", cn, c_ref))
    ):
        require(got.shape == want.shape, f"fused {label} {name} shape {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()), f"fused {label} {name}: non-finite output")
        errs[name] = max_abs(got, want)
        floors[name] = max_abs(floor[i], want.cpu())
        # probs lie in [0, 1] and h in [-1, 1]; the cell state c is an
        # unbounded running sum, so its bound scales with its largest value
        bounds[name] = TOL_FUSED[name] * max(1.0, float(want.abs().max().item()))
    log(f"fused encoder/LSTM/decoder {label}: max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e}, plain card vs CPU {floors[k]:.3e})"
                    for k, v in errs.items()))
    for name in errs:
        require(errs[name] <= bounds[name], f"fused {label}: {name} {errs[name]:.3e}")
    return max(errs.values())


def fold_bn(params):
    """The v3.1 params with batch norm folded into each stage's 1x1 conv and
    the bn_* tensors dropped, as the official v3 .onnx extraction has them."""
    import torch

    from vadc_tpu_torch.models.weights import Params
    from vadc_tpu_torch.nn.functional import BATCH_NORM_EPS

    layers = []
    for p in params["layers"]:
        p = dict(p)
        scale = p.pop("bn_w") / torch.sqrt(p.pop("bn_var") + BATCH_NORM_EPS)
        p["conv_b"] = (p["conv_b"] - p.pop("bn_mean")) * scale + p.pop("bn_b")
        p["conv_w"] = p["conv_w"] * scale[:, None]
        layers.append(p)
    return Params({**params, "layers": layers})


def check_forward_fused(params, audio, label: str) -> float:
    """forward_fused from a carried state against its plain version on the
    card (the plain version on the CPU beside it as the floor) and against
    forward_fused2d(features(audio)) (the CLI path's two kernels); its
    spectrum bit for bit against dot_magnitude's on the same frames."""
    import torch

    from vadc_tpu_torch.engine.runner import params_to
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused, forward_fused_reference
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, split_basis
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    b, samples = audio.shape
    h0, c0 = silero_v31.init_state(b, audio.device)
    _, h, c = forward_fused_reference(params, audio.flip(0).contiguous(), h0, c0)
    spect = torch.empty(b, samples // 64 + 1, 129, device=audio.device)
    got = forward_fused(params, audio, h, c, spectrum=spect)
    want = forward_fused_reference(params, audio, h, c)
    via_2d = forward_fused2d(params, silero_v31.features(params, audio), h, c)
    wr, wi = split_basis(params["stft_basis"])
    mag = dot_magnitude(F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64), wr, wi)
    torch.cuda.synchronize()
    floor = forward_fused_reference(params_to(params, torch.device("cpu")), audio.cpu(),
                                    h.cpu(), c.cpu())
    same_spectrum = torch.equal(spect, mag)
    errs, gaps, bounds, floors = {}, {}, {}, {}
    for i, name in enumerate(("probs", "hn", "cn")):
        require(got[i].shape == want[i].shape, f"forward_fused {label} {name} shape")
        require(bool(torch.isfinite(got[i]).all()), f"forward_fused {label} {name}: non-finite")
        errs[name] = max_abs(got[i], want[i])
        gaps[name] = max_abs(got[i], via_2d[i])
        floors[name] = max_abs(floor[i], want[i].cpu())
        # c is an unbounded running sum: its bound scales with its largest value
        scale = float(want[i].abs().max().item()) if name == "cn" else 1.0
        bounds[name] = TOL_FUSED_AUDIO[name] * max(1.0, scale)
    log(f"forward_fused {label}: max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e}, plain card vs CPU {floors[k]:.3e})"
                    for k, v in errs.items())
        + "; vs forward_fused2d(features) "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; spectrum bit-equal to dot_magnitude: {same_spectrum}")
    require(same_spectrum, f"forward_fused {label}: spectrum differs from dot_magnitude's")
    for name in errs:
        require(errs[name] <= bounds[name], f"forward_fused {label}: {name} {errs[name]:.3e}")
        require(gaps[name] <= bounds[name],
                f"forward_fused {label}: {name} {gaps[name]:.3e} from forward_fused2d(features)")
    # the state in place: hn, cn written over h, c give the same bits
    h2, c2 = h.clone(), c.clone()
    forward_fused(params, audio, h2, c2, hn=h2, cn=c2)
    torch.cuda.synchronize()
    require(torch.equal(h2, got[1]) and torch.equal(c2, got[2]),
            f"forward_fused {label}: in place differs")
    return max(errs.values())


def check_encode_fused_audio(params, audio, label: str) -> float:
    """encode_fused_audio against its plain version on the card, and
    lstm_decoder_fused on its rows, from a carried state, against
    forward_fused on the same audio bit for bit: the rows are what the step
    kernel hands its own LSTM."""
    import torch

    from vadc_tpu_torch.kernels.lstm import transposed_weight_of
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference, forward_fused, forward_fused_reference,
    )
    from vadc_tpu_torch.models import silero_v31

    b = audio.shape[0]
    enc = encode_fused_audio(params, audio)
    ref = encode_fused_audio_reference(params, audio)
    torch.cuda.synchronize()
    require(enc.shape == ref.shape, f"encode_fused_audio {label}: shape {tuple(enc.shape)}")
    require(bool(torch.isfinite(enc).all()), f"encode_fused_audio {label}: non-finite output")
    err = max_abs(enc, ref)
    h0, c0 = silero_v31.init_state(b, audio.device)
    _, h, c = forward_fused_reference(params, audio.flip(0).contiguous(), h0, c0)
    step = forward_fused(params, audio, h, c)
    split = lstm_decoder_fused(enc[:, None], h, c, params["lstm_w"], params["lstm_b"],
                               params["dec_w"], params["dec_b"], wt=transposed_weight_of(params))
    torch.cuda.synchronize()
    same = (torch.equal(split[0][:, 0], step[0]) and torch.equal(split[1], step[1])
            and torch.equal(split[2], step[2]))
    log(f"encode_fused_audio {label}: shape {tuple(enc.shape)} max abs err {err:.3e} (bound "
        f"{TOL_ENCODE_AUDIO:g}; largest activation {float(ref.abs().max().item()):.3f}); "
        f"lstm_decoder_fused(encode_fused_audio) bit-equal to forward_fused: {same}")
    require(err <= TOL_ENCODE_AUDIO, f"encode_fused_audio {label}: max abs err {err:.3e}")
    require(same, f"encode_fused_audio {label}: its rows are not those of forward_fused")
    return err


def phase_kernels(params, device) -> dict:
    import torch

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK)).to(device)
    errs = {
        "dot_magnitude": check_dot_magnitude(params, audio, f"B={B_MAIN} x {CHUNK}"),
        "silero_v31_fused": check_fused(params, audio, f"B={B_MAIN} x {CHUNK}"),
        "forward_fused": check_forward_fused(params, audio, f"B={B_MAIN} x {CHUNK}"),
        "encode_fused_audio": check_encode_fused_audio(params, audio, f"B={B_MAIN} x {CHUNK}"),
    }
    for b in (1, 37):
        check_dot_magnitude(params, audio[:b], f"B={b} x {CHUNK}")
        check_fused(params, audio[:b], f"B={b} x {CHUNK}")
        check_forward_fused(params, audio[:b], f"B={b} x {CHUNK}")
        check_encode_fused_audio(params, audio[:b], f"B={b} x {CHUNK}")
    short = audio[:, :512].contiguous()
    check_dot_magnitude(params, short, f"B={B_MAIN} x 512")
    check_fused(params, short, f"B={B_MAIN} x 512")
    for samples in FUSED_AUDIO_SAMPLES[:-1]:
        chunks = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + samples)).to(device)
        check_forward_fused(params, chunks, f"B={B_MAIN} x {samples}")
        check_encode_fused_audio(params, chunks, f"B={B_MAIN} x {samples}")
    # a BN-folded archive: the packed weights give it scale 1 and shift 0
    check_forward_fused(fold_bn(params), audio, f"BN-folded B={B_MAIN} x {CHUNK}")
    return errs


def check_stft_magnitude(params, audio, label: str, *, pad_left: int, pad_right: int,
                         hop: int) -> float:
    """stft_magnitude against its plain version, and bit for bit against
    dot_magnitude on the reflect-padded unfold (the two share one spectrum code,
    so on the same samples they must give the same bits)."""
    import torch

    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude
    from vadc_tpu_torch.kernels.stft_mag import (
        split_basis_of, stft_magnitude, stft_magnitude_reference,
    )
    from vadc_tpu_torch.nn import functional as F

    wr, wi = split_basis_of(params)
    kw = dict(pad_left=pad_left, pad_right=pad_right, hop=hop)
    out = stft_magnitude(audio, wr, wi, **kw)
    ref = stft_magnitude_reference(audio, wr, wi, **kw)
    via_dotmag = dot_magnitude(F.frame(F.reflect_pad_last(audio, pad_left, pad_right),
                                       wr.shape[0], hop), wr, wi)
    torch.cuda.synchronize()
    require(out.shape == ref.shape, f"stft_magnitude shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    require(bool(torch.isfinite(out).all()), "stft_magnitude: non-finite output")
    err = max_abs(out, ref)
    rel = err / float(ref.abs().max().item())
    same_bits = torch.equal(out, via_dotmag)
    log(f"stft_magnitude {label}: shape {tuple(out.shape)} max abs err {err:.3e}, relative "
        f"to max magnitude {rel:.3e} (bound {TOL_DOTMAG_REL:g}); bit-equal to dot_magnitude "
        f"on the padded unfold: {same_bits}")
    require(rel <= TOL_DOTMAG_REL, f"stft_magnitude {label}: relative error {rel:.3e}")
    require(same_bits, f"stft_magnitude {label}: differs from dot_magnitude on the same frames")
    return err


def lstm_variants(x, h, c, wt, b, tier=None) -> dict:
    """lstm_fused's variants (their instances of the tier, default faithful)
    launched explicitly through the wrapper's private launch functions (not
    counted): name -> (y, hn, cn)."""
    import torch

    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.nn.precision import FAITHFUL

    out = {}
    for name, launch in (("streaming", KL._launch_streaming), ("resident", KL._launch_resident)):
        y, hn, cn = torch.empty_like(x), torch.empty_like(h), torch.empty_like(c)
        launch(x, h, c, wt, b, y, hn, cn, tier or FAITHFUL)
        out[name] = (y, hn, cn)
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def small_pre_scratch(nbytes: int):
    """The resident variant's scratch limited to nbytes, so that a call
    walks its frames in several passes."""
    from vadc_tpu_torch.kernels import lstm as KL

    saved, KL.PRE_BYTES_MAX = KL.PRE_BYTES_MAX, nbytes
    try:
        yield
    finally:
        KL.PRE_BYTES_MAX = saved


def check_lstm(params, x, h, c, label: str, chunk_frames: int = 0) -> float:
    """lstm_fused from a carried state (h, c) against its plain version on
    the card, with the plain version on the CPU beside it as the floor: the
    wrapper's call, then each variant launched explicitly, all bit-equal to
    each other, the resident one also in passes. With chunk_frames, one call
    over the whole sequence against one call per chunk_frames frames with the
    state in place, bit for bit."""
    import torch

    from vadc_tpu_torch.kernels.lstm import lstm_fused, lstm_fused_reference, transposed_weight_of

    w, b = params["lstm_w"], params["lstm_b"]
    wt = transposed_weight_of(params)
    got = lstm_fused(x, h, c, w, b, wt=wt)
    want = lstm_fused_reference(x, h, c, w, b)
    torch.cuda.synchronize()
    floor = lstm_fused_reference(x.cpu(), h.cpu(), c.cpu(), w.cpu(), b.cpu())
    errs, bounds, floors = {}, {}, {}
    for i, name in enumerate(("y", "hn", "cn")):
        require(got[i].shape == want[i].shape, f"lstm {label} {name} shape {tuple(got[i].shape)}")
        require(bool(torch.isfinite(got[i]).all()), f"lstm {label} {name}: non-finite output")
        errs[name] = max_abs(got[i], want[i])
        floors[name] = max_abs(floor[i], want[i].cpu())
        # y and h lie in [-1, 1]; c is an unbounded running sum
        scale = float(want[i].abs().max().item()) if name == "cn" else 1.0
        bounds[name] = TOL_LSTM * max(1.0, scale)
    variants = lstm_variants(x, h, c, wt, b)
    with small_pre_scratch(16 * x.shape[2] * x.shape[0] * max(1, x.shape[1] // 3)):
        variants["resident, in passes"] = lstm_variants(x, h, c, wt, b)["resident"]
    same = {name: same_bits(out, got) for name, out in variants.items()}
    log(f"lstm_fused {label} (the wrapper runs {variant_of(*x.shape[:2])}): max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e}, plain card vs CPU {floors[k]:.3e})"
                    for k, v in errs.items())
        + f"; bit-equal to the wrapper's call: {same}")
    if not all(same.values()):
        log(f"lstm_fused {label}: differences from the wrapper's call: "
            + variant_diffs(variants, got, ("y", "hn", "cn")))
    for name in errs:
        require(errs[name] <= bounds[name], f"lstm {label}: {name} {errs[name]:.3e}")
    for name, ok in same.items():
        require(ok, f"lstm {label}: the {name} variant differs from the wrapper's call")
    # the state may be updated in place
    h2, c2 = h.clone(), c.clone()
    lstm_fused(x, h2, c2, w, b, hn=h2, cn=c2, wt=wt)
    torch.cuda.synchronize()
    require(torch.equal(h2, got[1]) and torch.equal(c2, got[2]), f"lstm {label}: in place differs")
    if chunk_frames:
        hk, ck, pieces = h.clone(), c.clone(), []
        for t0 in range(0, x.shape[1], chunk_frames):
            piece = x[:, t0 : t0 + chunk_frames].contiguous()
            pieces.append(lstm_fused(piece, hk, ck, w, b, hn=hk, cn=ck, wt=wt)[0])
        torch.cuda.synchronize()
        same_chunks = (torch.equal(torch.cat(pieces, dim=1), got[0]) and torch.equal(hk, got[1])
                       and torch.equal(ck, got[2]))
        log(f"lstm_fused {label}: {len(pieces)} calls of {chunk_frames} frames, the state in "
            f"place, bit-equal to the one call: {same_chunks}")
        require(same_chunks, f"lstm {label}: the one call differs from the calls chunk by chunk")
    return max(errs.values())


def lstm_inputs(module, params, audio, n_seq: int, device, tier=None):
    """Encoder features of `audio` at the tier (default faithful) reshaped to
    n_seq sequences, and a realistic carried state: one plain forward on
    other audio first."""
    from vadc_tpu_torch.nn.precision import FAITHFUL

    feats = module.encode(params, audio, tier=tier or FAITHFUL)
    x = feats.reshape(n_seq, -1, feats.shape[-1]).contiguous()
    h0, c0 = module.init_state(audio.shape[0], device)
    _, h, c = module.forward_reference(params, audio.flip(0).contiguous(), h0, c0)
    return x, h[:, :n_seq].contiguous(), c[:, :n_seq].contiguous()


def phase_kernels_v45(models: dict, device) -> dict:
    """stft_magnitude and lstm_fused at every shape the v4 and v5 paths give
    them. models: family -> (module, params)."""
    import torch

    def audio(n, chunk, seed):
        return torch.from_numpy(speech_chunks(n, chunk, seed=seed)).to(device)

    v4, p4 = models["v4"]
    v5, p5 = models["v5"]
    errs = {}
    # every family geometry at B_MAIN and a ragged B=37; v4 also at B=1 and
    # v4_8k at 256-sample chunks
    for seed, (family, (module, params)) in enumerate(models.items(), SEED + 300):
        samples, kw = stft_geometry(family, module)
        chunks = audio(B_MAIN, samples, seed)
        err = check_stft_magnitude(params, chunks, f"{family} B={B_MAIN} x {samples}", **kw)
        if family == "v4":
            errs["stft_magnitude"] = err
            a4 = chunks
            check_stft_magnitude(params, chunks[:1], f"v4 B=1 x {samples}", **kw)
        check_stft_magnitude(params, chunks[:37], f"{family} B=37 x {samples}", **kw)
    check_stft_magnitude(models["v4_8k"][1], audio(B_MAIN, 256, SEED + 308),
                         f"v4_8k B={B_MAIN} x 256", **stft_geometry("v4_8k", None)[1])
    a5 = audio(B_MAIN, v5.CONTEXT_SAMPLES + V5_CHUNK, SEED + 302)

    x, h, c = lstm_inputs(v4, p4, a4, B_MAIN, device)
    errs["lstm_fused"] = check_lstm(p4, x, h, c, f"v4 B={B_MAIN} x T={x.shape[1]}")
    window = audio(CLI_WINDOW, V4_CHUNK, SEED + 304)
    check_lstm(p4, *lstm_inputs(v4, p4, window, 1, device), f"v4 B=1 x T={3 * CLI_WINDOW}",
               chunk_frames=3)
    # a ragged block of the resident variant at 4 streams a block
    ragged = audio(333 * 4, V4_CHUNK, SEED + 306)
    check_lstm(p4, *lstm_inputs(v4, p4, ragged, 333, device), "v4 B=333 x T=12")
    x, h, c = lstm_inputs(v5, p5, a5, B_MAIN, device)
    check_lstm(p5, x, h, c, f"v5 B={B_MAIN} x T={x.shape[1]}")
    window = audio(CLI_WINDOW, v5.CONTEXT_SAMPLES + V5_CHUNK, SEED + 305)
    check_lstm(p5, *lstm_inputs(v5, p5, window, 1, device), f"v5 B=1 x T={CLI_WINDOW}",
               chunk_frames=1)
    ragged = audio(333 * 4, v5.CONTEXT_SAMPLES + V5_CHUNK, SEED + 307)
    check_lstm(p5, *lstm_inputs(v5, p5, ragged, 333, device), "v5 B=333 x T=4")
    return errs


def check_lstm_decoder(params, audio, n_streams: int, label: str, frames_kept: int = 0) -> float:
    """encode_fused and lstm_decoder_fused at audio [n_streams * K, S], the
    K chunks of a stream in consecutive rows: encode_fused against the plain
    encoder stages; lstm_decoder_fused on its output (its first frames_kept
    frames a chunk when given), from a carried state, against its plain
    version (the plain version on the CPU beside it as the floor), in place,
    the K-chunk call against K single calls bit for bit, its state bit for
    bit that of lstm_fused over the same frames (the faithful kernels' fmaf
    chains in one order), and unless frames are cut chunk 0 of
    lstm_decoder_fused(encode_fused(feats)) against forward_fused2d(feats)
    bit for bit."""
    import torch

    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.kernels.lstm import lstm_fused, transposed_weight_of
    from vadc_tpu_torch.kernels.lstm_decoder import (
        lstm_decoder_fused, lstm_decoder_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        encode_fused, encode_fused_reference, forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.models import silero_v31

    n_chunks = audio.shape[0] // n_streams
    feats = silero_v31.features(params, audio)
    enc = encode_fused(params, feats)
    enc_ref = encode_fused_reference(params, feats)
    torch.cuda.synchronize()
    require(enc.shape == enc_ref.shape, f"encode_fused {label}: shape {tuple(enc.shape)}")
    require(bool(torch.isfinite(enc).all()), f"encode_fused {label}: non-finite output")
    enc_err = max_abs(enc, enc_ref)
    enc_max = float(enc_ref.abs().max().item())
    frames = frames_kept or enc.shape[1]
    x = enc.reshape(n_streams, n_chunks, enc.shape[1], 64)[:, :, :frames].contiguous()
    # a realistic carried state: one plain step on other audio first
    h0, c0 = silero_v31.init_state(n_streams, audio.device)
    first = feats.reshape(n_streams, n_chunks, *feats.shape[1:])[:, 0].contiguous()
    _, h, c = forward_fused2d_reference(params, first.flip(0).contiguous(), h0, c0)
    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    wt = transposed_weight_of(params)
    got = lstm_decoder_fused(x, h, c, *args, wt=wt)
    want = lstm_decoder_fused_reference(x, h, c, *args)
    torch.cuda.synchronize()
    floor = lstm_decoder_fused_reference(x.cpu(), h.cpu(), c.cpu(), *(a.cpu() for a in args))
    errs, bounds, floors = {}, {}, {}
    for i, name in enumerate(("probs", "hn", "cn")):
        require(got[i].shape == want[i].shape, f"lstm_decoder {label} {name} shape {tuple(got[i].shape)}")
        require(bool(torch.isfinite(got[i]).all()), f"lstm_decoder {label} {name}: non-finite")
        errs[name] = max_abs(got[i], want[i])
        floors[name] = max_abs(floor[i], want[i].cpu())
        bounds[name] = TOL_FUSED[name] * max(1.0, float(want[i].abs().max().item()))
    # K single calls, the state in place, give the K-chunk call's bits
    hk, ck = h.clone(), c.clone()
    singles = []
    for k in range(n_chunks):
        p_k, _, _ = lstm_decoder_fused(x[:, k].contiguous(), hk, ck, *args, hn=hk, cn=ck, wt=wt)
        singles.append(p_k)
    same_singles = (torch.equal(torch.stack(singles, dim=1), got[0])
                    and torch.equal(hk, got[1]) and torch.equal(ck, got[2]))
    # the K-chunk call in place
    h2, c2 = h.clone(), c.clone()
    p2, _, _ = lstm_decoder_fused(x, h2, c2, *args, hn=h2, cn=c2, wt=wt)
    same_in_place = torch.equal(p2, got[0]) and torch.equal(h2, got[1]) and torch.equal(c2, got[2])
    # the entry launched explicitly (not counted), in one pass and in
    # passes over the chunks
    variants = {}
    for name, limit in (("one pass", None),
                        ("in passes", 1024 * n_streams * frames * max(1, n_chunks // 3))):
        out = (torch.empty_like(got[0]), torch.empty_like(h), torch.empty_like(c))
        with small_pre_scratch(limit) if limit else contextlib.nullcontext():
            KD._launch(x, h, c, wt, *args[1:], *out)
        variants[name] = out
    # the same frames through lstm_fused (its streaming kernel below 3
    # steps, its resident ones from 3 on): the same state
    _, h_lf, c_lf = lstm_fused(x.reshape(n_streams, n_chunks * frames, 64), h, c, args[0], args[1],
                               wt=wt)
    torch.cuda.synchronize()
    same_variants = {name: same_bits(out, got) for name, out in variants.items()}
    same_lstm_fused = torch.equal(h_lf, got[1]) and torch.equal(c_lf, got[2])
    # chunk 0 through the fused kernel, which runs the same device code
    same_fused = None
    if not frames_kept:
        fused = forward_fused2d(params, first, h, c)
        split = lstm_decoder_fused(x[:, 0].contiguous(), h, c, *args, wt=wt)
        torch.cuda.synchronize()
        same_fused = all(torch.equal(a, b) for a, b in zip(fused, split))
    log(f"lstm_decoder_fused {label} (x {tuple(x.shape)}): encode_fused max abs err {enc_err:.3e} "
        f"(bound {TOL_ENCODE:g}; largest activation {enc_max:.3f}); max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e}, plain card vs CPU {floors[k]:.3e})"
                    for k, v in errs.items())
        + f"; launched explicitly, bit-equal to the wrapper's call: {same_variants}; "
        f"K single calls bit-equal: {same_singles}; in place bit-equal: {same_in_place}; "
        f"state bit-equal to lstm_fused's: {same_lstm_fused}; "
        f"lstm_decoder_fused(encode_fused) bit-equal to forward_fused2d: {same_fused}")
    if not all(same_variants.values()):
        log(f"lstm_decoder_fused {label}: differences from the wrapper's call: "
            + variant_diffs(variants, got, ("probs", "hn", "cn")))
    require(enc_err <= TOL_ENCODE, f"encode_fused {label}: max abs err {enc_err:.3e}")
    for name in errs:
        require(errs[name] <= bounds[name], f"lstm_decoder {label}: {name} {errs[name]:.3e}")
    for name, ok in same_variants.items():
        require(ok, f"lstm_decoder {label}: the {name} variant differs from the wrapper's call")
    require(same_singles, f"lstm_decoder {label}: the K-chunk call differs from K single calls")
    require(same_in_place, f"lstm_decoder {label}: in place differs")
    require(same_lstm_fused, f"lstm_decoder {label}: its state differs from lstm_fused's")
    require(same_fused is not False,
            f"lstm_decoder {label}: differs from forward_fused2d on the same features")
    return max(errs.values())


def phase_kernels_lstm_decoder(params, device) -> dict:
    import torch

    def audio(n, chunk, seed):
        return torch.from_numpy(speech_chunks(n, chunk, seed=seed)).to(device)

    err = check_lstm_decoder(params, audio(B_MAIN, CHUNK, SEED + 700), B_MAIN,
                             f"B={B_MAIN} x K=1 x {CHUNK}")
    for samples in FUSED_AUDIO_SAMPLES:  # T = 3, 4, 5, 6, 7 frames
        check_lstm_decoder(params, audio(37 * 5, samples, SEED + 701 + samples), 37,
                           f"B=37 x K=5 x {samples}")
    check_lstm_decoder(params, audio(CLI_WINDOW, CHUNK, SEED + 702), 1,
                       f"B=1 x K={CLI_WINDOW} x {CHUNK}")
    # a ragged block of the resident variant at 4 streams a block
    check_lstm_decoder(params, audio(333 * 3, CHUNK, SEED + 703), 333, f"B=333 x K=3 x {CHUNK}")
    # chunks of 1 and 2 frames, which the streaming kernel took until it went
    for kept in (1, 2):
        check_lstm_decoder(params, audio(37 * 5, CHUNK, SEED + 704), 37,
                           f"B=37 x K=5 x T={kept} (frames cut)", kept)
        check_lstm_decoder(params, audio(B_MAIN, CHUNK, SEED + 705), B_MAIN,
                           f"B={B_MAIN} x K=1 x T={kept} (frames cut)", kept)
    return {"lstm_decoder_fused": err}


def synthetic_file(path: Path) -> None:
    """The verify recipe's file: two voiced spans, 12 s, as raw s16le at
    `path` and as a 16 kHz mono wav beside it (path with suffix .wav)."""
    import wave

    def sil(d):
        return 0.001 * np.random.default_rng(1).normal(size=int(d * SR))

    audio = np.concatenate([sil(2), voiced(3), sil(2), voiced(3, 180), sil(2)])
    pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
    pcm.tofile(path)
    with wave.open(str(path.with_suffix(".wav")), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def run_cli(argv: list[str], stdin_path: Path) -> str:
    """The CLI in this process on a file as stdin; logs its wall time per
    second of audio (weight loading and the build included)."""
    from vadc_tpu_torch.cli import main as cli

    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    t0 = time.perf_counter()
    with open(stdin_path, "rb") as f:
        sys.stdin = io.TextIOWrapper(f)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(argv)
        finally:
            sys.stdin = saved
    seconds = time.perf_counter() - t0
    audio_s = stdin_path.stat().st_size / 2 / SR
    require(rc == 0, f"CLI {argv} exited {rc}: {err.getvalue()}")
    log(f"CLI {' '.join(argv)} < {stdin_path.name}: {audio_s:.2f} s of audio in {seconds:.3f} s "
        f"(realtime factor {audio_s / seconds:.1f}x)")
    return out.getvalue()


def cli_card_vs_cpu(extra: list[str], stdin_path: Path) -> None:
    """The CLI with --device cuda and --device cpu: identical segments (the
    file's two voiced spans), raw probabilities within TOL_PATH."""
    seg_gpu = run_cli(["--device", "cuda", *extra], stdin_path)
    raw_gpu = run_cli(["--device", "cuda", "--raw_probabilities", *extra], stdin_path)
    seg_cpu = run_cli(["--device", "cpu", *extra], stdin_path)
    raw_cpu = run_cli(["--device", "cpu", "--raw_probabilities", *extra], stdin_path)
    label = " ".join(extra) or "default model"
    log(f"CLI segments ({label}) --device cuda: {seg_gpu.split()}")
    log(f"CLI segments ({label}) --device cpu:  {seg_cpu.split()}")
    require(seg_gpu == seg_cpu, f"CLI segments ({label}) differ between cuda and cpu")
    require(len(seg_gpu.split()) == 2, f"expected 2 segments ({label}), got {seg_gpu!r}")
    pg = np.array([float(x) for x in raw_gpu.split()])
    pc = np.array([float(x) for x in raw_cpu.split()])
    require(pg.shape == pc.shape and pg.size > 0, f"raw probabilities {pg.shape} vs {pc.shape}")
    raw_err = float(np.abs(pg - pc).max())
    log(f"CLI raw probabilities ({label}): {pg.size} chunks, max abs diff cuda vs cpu "
        f"{raw_err:.3e} (bound {TOL_PATH:g})")
    require(raw_err <= TOL_PATH, f"CLI raw probabilities ({label}) differ by {raw_err}")


def check_close_to_cpu(label: str, got: dict, want: dict) -> None:
    """Card results against the CPU's: probabilities and h within TOL_PATH,
    c within TOL_PATH of its largest value (an unbounded running sum)."""
    errs = {k: max_abs(got[k].cpu(), want[k]) for k in want}
    bounds = {k: TOL_PATH * (max(1.0, float(want[k].abs().max().item())) if k == "c" else 1.0)
              for k in want}
    log(f"{label} card vs CPU: max abs err "
        + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.3e})" for k, v in errs.items()))
    for k in errs:
        require(errs[k] <= bounds[k], f"{label} card vs CPU: {k} {errs[k]:.3e}")


def scan_card_vs_cpu(family: str, params, device, chunk: int, seed: int) -> None:
    """StreamRunner.scan over B_MAIN streams x SCAN_CHUNKS chunks on the
    card, then the same on the CPU (plain versions)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner

    chunks = speech_chunks(B_MAIN * SCAN_CHUNKS, chunk, seed=seed).reshape(B_MAIN, SCAN_CHUNKS, chunk)
    gpu = StreamRunner(family, params, device=device)
    probs_gpu, state = gpu.scan(chunks, gpu.init_state(B_MAIN))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu = StreamRunner(family, params, device="cpu")
    probs_cpu, cstate = cpu.scan(chunks, cpu.init_state(B_MAIN))
    log(f"plain CPU scan {family} {B_MAIN}x{SCAN_CHUNKS}: {time.perf_counter() - t0:.1f} s")
    require(probs_gpu.shape == (B_MAIN, SCAN_CHUNKS), f"scan probs shape {tuple(probs_gpu.shape)}")
    require(bool(torch.isfinite(probs_gpu).all()), f"scan {family}: non-finite probabilities")
    if state.context is not None:
        require(torch.equal(state.context.cpu(), cstate.context), f"scan {family}: context differs")
    check_close_to_cpu(f"scan {family} {B_MAIN}x{SCAN_CHUNKS}",
                       {"probs": probs_gpu, "h": state.h, "c": state.c},
                       {"probs": probs_cpu, "h": cstate.h, "c": cstate.c})
    log(f"scan {family}: speech share p>0.5: {float((probs_gpu > 0.5).float().mean()):.3f}")


def minibatch_card_vs_cpu(family: str, params, device, chunk: int, seed: int) -> None:
    """MinibatchRunner (the CLI's runner, batch CLI_WINDOW) over two windows
    of CLI_WINDOW chunks, card against CPU, the state and the audio context
    carried from window to window."""
    import torch

    from vadc_tpu_torch.engine.runner import MinibatchRunner

    windows = speech_chunks(2 * CLI_WINDOW, chunk, seed=seed).reshape(2, CLI_WINDOW * chunk)
    kw = dict(batch_size=CLI_WINDOW, chunk_samples=chunk)
    gpu = MinibatchRunner(family, params, device=device, **kw)
    cpu = MinibatchRunner(family, params, device="cpu", **kw)
    for w in range(2):
        pg = torch.tensor(gpu.process_window(windows[w]))
        pc = torch.tensor(cpu.process_window(windows[w]))
        require(pg.shape == (CLI_WINDOW,) and bool(torch.isfinite(pg).all()),
                f"minibatch {family}: probabilities {tuple(pg.shape)}")
        check_close_to_cpu(f"MinibatchRunner {family} window {w}",
                           {"probs": pg, "h": gpu.h, "c": gpu.c},
                           {"probs": pc, "h": cpu.h, "c": cpu.c})
    if gpu.context is not None:
        require(torch.equal(gpu.context.cpu(), cpu.context), f"minibatch {family}: context differs")


# the corpus cells' segmenter slab: 512 streams, 64 chunk columns a feed
FSM_STREAMS, FSM_COLS = 512, 64


def fsm_probs(batch: int, n_cols: int, cfg, seed: int) -> np.ndarray:
    """Probabilities that dwell (runs of speech-like, silence-like and
    in-between levels), so segments open, close and get discarded; about
    one entry in eight is exactly cfg's fp32 threshold or neg_threshold,
    or one ulp either side of one."""
    rng = np.random.default_rng(seed)
    run = np.cumsum(rng.random((batch, n_cols)) < 0.1, axis=1)
    levels = rng.choice([0.05, 0.3, 0.42, 0.55, 0.9], size=(batch, n_cols + 1))
    out = np.take_along_axis(levels, run, 1) + 0.08 * rng.normal(size=(batch, n_cols))
    out = np.clip(out, 0, 1).astype(np.float32)
    at = np.float32([cfg.threshold, cfg.neg_threshold])
    edge = np.concatenate([at, np.nextafter(at, np.float32(0)), np.nextafter(at, np.float32(1))])
    mask = rng.random((batch, n_cols)) < 0.125
    out[mask] = rng.choice(edge, size=int(mask.sum()))
    return out


def device_ms(fn, match: str | None = None, iters: int = 20) -> float | None:
    """Device time of one call of fn by torch.profiler: the self time of
    the kernels whose name holds `match` (all of them without it), over
    `iters` calls; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for event in prof.key_averages():
        if match is None or match in event.key:
            total_us += getattr(event, "self_device_time_total",
                                getattr(event, "self_cuda_time_total", 0.0))
    return total_us / iters / 1e3 if total_us > 0 else None


def phase_kernels_fsm(device) -> dict:
    """fsm_scan at the corpus cells' shape (FSM_STREAMS x FSM_COLS) with
    the v5 CLI's segmenter (32 ms chunks), over two slabs in turn, the
    state carried, valid_chunks 0, inside either slab and past both: its
    [3, T, B] events and state bit for bit segment_batch's on the card.
    Then both timed on one slab: CUDA events around calls in a row (the
    host's cost of a call where it exceeds the device's) and device time
    (torch.profiler)."""
    import torch

    from vadc_tpu_torch.cli.segmenter import SegmenterConfig
    from vadc_tpu_torch.kernels import fsm

    cfg = SegmenterConfig.from_ms(chunk_samples=512)
    kw = dict(threshold=cfg.threshold, neg_threshold=cfg.neg_threshold,
              min_silence_chunks=cfg.min_silence_chunks, min_speech_chunks=cfg.min_speech_chunks)
    batch, n_cols = FSM_STREAMS, FSM_COLS
    label = f"fsm_scan B={batch} x T={n_cols}"
    probs = torch.from_numpy(fsm_probs(batch, 2 * n_cols, cfg, seed=SEED + 900)).to(device)
    valid = np.random.default_rng(SEED + 901).integers(0, 2 * n_cols + 2, batch)
    valid[:3] = [0, n_cols, 2 * n_cols + 5]
    valid = torch.from_numpy(valid.astype(np.int32)).to(device)
    ks = ps = fsm.init_fsm_state(batch, device)
    closes = 0
    for k, slab in enumerate((probs[:, :n_cols], probs[:, n_cols:])):
        ks, events = fsm.fsm_scan(slab, ks, **kw, valid_chunks=valid)
        ps, (closed, starts, ends) = fsm.segment_batch(slab, **kw, state=ps, valid_chunks=valid)
        plain = torch.stack([closed.to(torch.int32), starts, ends])
        require(events.dtype == torch.int32 and events.shape == (3, n_cols, batch),
                f"{label}: events {events.dtype} {tuple(events.shape)}")
        require(torch.equal(events, plain), f"{label}, slab {k}: "
                f"{int((events != plain).sum())} entries of the events differ from segment_batch's")
        require(ks.chunk_index == ps.chunk_index == (k + 1) * n_cols,
                f"{label}, slab {k}: chunk index {ks.chunk_index} vs {ps.chunk_index}")
        for field in ("triggered", "speech_start", "temp_end"):
            require(torch.equal(getattr(ks, field), getattr(ps, field)),
                    f"{label}, slab {k}: {field} differs from segment_batch's")
        closes += int(plain[0].sum())
    require(closes > 0, f"{label}: the probabilities closed no segment")
    slab, state = probs[:, :n_cols], fsm.init_fsm_state(batch, device)

    def kernel():
        return fsm.fsm_scan(slab, state, **kw, valid_chunks=valid)

    def plain():
        return fsm.segment_batch(slab, **kw, state=state, valid_chunks=valid)

    ms, plain_ms = cuda_ms_pair(kernel, plain, iters=20)
    dev_ms, plain_dev_ms = device_ms(kernel, "fsm_scan"), device_ms(plain)
    shown = lambda v: "not seen" if v is None else f"{v:.4f} ms"  # noqa: E731
    log(f"{label}: events and state of two slabs bit for bit segment_batch's ({closes} segments "
        f"closed); CUDA events {ms:.4f} ms a call (segment_batch {plain_ms:.4f}), device time "
        f"{shown(dev_ms)} (segment_batch {shown(plain_dev_ms)})")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": plain_dev_ms}


def wrappers() -> dict:
    """name -> the wrapper that counts that kernel's launches."""
    from vadc_tpu_torch.kernels.fsm import fsm_scan
    from vadc_tpu_torch.kernels.lstm import lstm_fused
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
    from vadc_tpu_torch.kernels.probes import bf16_dot, bf16_dot_wgmma, concat_dot
    from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio, forward_fused
    from vadc_tpu_torch.kernels.silero_v31_fused2d import encode_fused, forward_fused2d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude
    from vadc_tpu_torch.kernels.stft_mag import stft_magnitude

    return {"dot_magnitude": dot_magnitude, "forward_fused2d": forward_fused2d,
            "encode_fused": encode_fused, "forward_fused": forward_fused,
            "encode_fused_audio": encode_fused_audio,
            "stft_magnitude": stft_magnitude, "lstm_fused": lstm_fused,
            "lstm_decoder_fused": lstm_decoder_fused, "bf16_dot": bf16_dot,
            "bf16_dot_wgmma": bf16_dot_wgmma, "concat_dot": concat_dot, "fsm_scan": fsm_scan}


def zero_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def counted(fn):
    """fn() with the launch counts set to 0 just before it and read just
    after it: (fn's result, the counts of its launches alone)."""
    zero_launches()
    out = fn()
    return out, launch_counts()


def add_launches(totals: dict, counts: dict) -> None:
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n


def read_launches(label: str, totals: dict, required: tuple, counts: dict | None = None) -> dict:
    """The launch counts since zero_launches (or `counts`), logged, each of
    `required` held > 0, and added into `totals`."""
    counts = launch_counts() if counts is None else counts
    log(f"{label} launches: {nonzero(counts)}")
    for name in required:
        require(counts[name] > 0, f"{name}: no launch on the path: {label}")
    add_launches(totals, counts)
    return counts


def require_scaled(label: str, got: dict, one: dict, n: int, required: tuple,
                   totals: dict, once: tuple = ()) -> None:
    """A run over n shards launched each kernel n times as often as the
    unsharded run of the same work (`one`), which launched every kernel of
    `required` and of `once`; the kernels of `once`, which run on the
    first device over what the shards gathered, as often as it. Both runs'
    launches go into `totals`."""
    for name in (*required, *once):
        require(one[name] > 0, f"{name}: no launch in the unsharded run: {label}")
    require(got == {k: v if k in once else n * v for k, v in one.items()},
            f"{label}: launches {nonzero(got)}, not {n} x the unsharded run's {nonzero(one)}"
            + (f" ({once} as often)" if once else ""))
    log(f"{label} launches: {nonzero(got)}, {n} x the unsharded run's {nonzero(one)}")
    add_launches(totals, got)
    add_launches(totals, one)


V3_SLAB_KERNELS = ("encode_fused_audio", "lstm_decoder_fused")
# public kernels that no main path runs: the slab route went from features
# (dot_magnitude) + encode_fused to encode_fused_audio, the CLI's window from
# forward_fused2d to the slab route
OFF_PATH_KERNELS = ("dot_magnitude", "silero_v31_fused", "silero_v31_fused3d")


def steps_vs_scan(params, device, tier: str = "faithful") -> None:
    """The v3.1 loop of StreamRunner.step (forward_fused) against the slab
    scan on the card at the tier, on the same chunks from the same state:
    bit for bit, since the slab's front half is the step kernel's own
    front-end and encoder and the resident LSTM gives the step kernel's
    bits."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner

    chunks = torch.from_numpy(
        speech_chunks(B_MAIN * SCAN_CHUNKS, CHUNK, seed=SEED + 100)
    ).to(device).reshape(B_MAIN, SCAN_CHUNKS, CHUNK)
    runner = StreamRunner("v3", params, device=device, precision=tier)
    probs_slab, slab = runner.scan(chunks, runner.init_state(B_MAIN))
    state = runner.init_state(B_MAIN)
    probs = torch.stack([runner.step(chunks[:, k], state)[0] for k in range(SCAN_CHUNKS)], dim=1)
    torch.cuda.synchronize()
    errs = {"probs": max_abs(probs, probs_slab), "h": max_abs(state.h, slab.h),
            "c": max_abs(state.c, slab.c)}
    same = (torch.equal(probs, probs_slab) and torch.equal(state.h, slab.h)
            and torch.equal(state.c, slab.c))
    log(f"v3.1 {tier} loop of steps vs slab scan {B_MAIN}x{SCAN_CHUNKS} on the card: bit-equal: {same} "
        f"(max abs diff probs {errs['probs']:.3e}, h {errs['h']:.3e}, c {errs['c']:.3e})")
    require(same, f"{tier} steps vs slab scan: not bit for bit: {errs}")


def phase_main_path_v3(params, device, pcm: Path, totals: dict) -> None:
    """Three v3.1 paths, each counted on its own: StreamRunner.scan (the
    slab route: encode_fused_audio, lstm_decoder_fused), the loop
    of StreamRunner.step (forward_fused alone) and the CLI (MinibatchRunner:
    the slab route at one stream)."""
    zero_launches()
    scan_card_vs_cpu("v3", params, device, CHUNK, SEED + 100)
    read_launches(f"v3.1 StreamRunner.scan {B_MAIN}x{SCAN_CHUNKS}", totals, V3_SLAB_KERNELS)
    zero_launches()
    steps_vs_scan(params, device)
    read_launches(f"v3.1 StreamRunner.step x {SCAN_CHUNKS} (and one slab scan)", totals,
                  ("forward_fused",))
    zero_launches()
    cli_card_vs_cpu([], pcm)
    read_launches("v3.1 CLI", totals, V3_SLAB_KERNELS)


def phase_main_path_v4(params, device, pcm: Path, archives: dict, totals: dict) -> None:
    zero_launches()
    scan_card_vs_cpu("v4", params, device, V4_CHUNK, SEED + 110)
    cli_card_vs_cpu(["--model", str(archives["v4"])], pcm)
    # the 8 kHz model on the same 16 kHz file as a wav: resampled natively
    cli_card_vs_cpu(["--model", str(archives["v4_8k"])], pcm.with_suffix(".wav"))
    read_launches(f"v4 path (scan {B_MAIN}x{SCAN_CHUNKS} + CLI v4, v4_8k)", totals,
                  ("stft_magnitude", "lstm_fused"))


def phase_main_path_v5(models: dict, device, totals: dict) -> None:
    zero_launches()
    scan_card_vs_cpu("v5", models["v5"][1], device, V5_CHUNK, SEED + 120)
    minibatch_card_vs_cpu("v5", models["v5"][1], device, V5_CHUNK, SEED + 121)
    minibatch_card_vs_cpu("v5_8k", models["v5_8k"][1], device, V5_8K_CHUNK, SEED + 122)
    read_launches(f"v5 path (scan {B_MAIN}x{SCAN_CHUNKS} + MinibatchRunner v5, v5_8k)", totals,
                  ("stft_magnitude", "lstm_fused"))


# the v4/v5 slab scans checked against the loop of steps (streams, chunks),
# and the tier of each bound's control: its first half of the streams must
# break the bound
SLABS_V45 = ((B_MAIN, SCAN_CHUNKS), (SLAB_CHUNKS, SLAB_CHUNKS))
CONTROL_TIER = {"faithful": "fast", "balanced": "fast", "fast": "turbo", "turbo": "fast"}


def scan_pieces(family: str, module, params, x, tier: str, want) -> str:
    """Where a v4/v5 slab scan leaves the loop of steps' bits, by pieces:
    stft_magnitude over each piece of the slab (SCAN_PIECE_CHUNKS chunks of
    every stream as one batch) against over each of its chunk columns (B
    rows, the step's batch), required equal (the kernel's arithmetic is per
    row); one lstm_fused call over the steps' own features (the encoder by
    chunk columns) against the loop's state `want` (h, c), required equal;
    then the encoder's torch ops over each piece against its columns."""
    import torch

    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.models import silero_v4, silero_v5, slab
    from vadc_tpu_torch.nn.precision import tier_of

    t = tier_of(tier)
    rows = x
    if hasattr(module, "attach_contexts"):
        rows = module.attach_contexts(x, module.init_context(x.shape[0], x.device))[0]

        def spectrum(a):
            return silero_v5.spectrum(params, a, pad_right=module.STFT_PAD_RIGHT,
                                      hop=module.STFT_HOP, tier=t)
    else:
        def spectrum(a):
            return silero_v4.spectrum(params, a, t)

    def encode(a):
        return module.encode(params, a, tier=t)

    columns, enc_diff = [], 0.0
    for k0 in range(0, x.shape[1], slab.SCAN_PIECE_CHUNKS):
        piece = rows[:, k0 : k0 + slab.SCAN_PIECE_CHUNKS]
        flat = piece.reshape(-1, piece.shape[-1])
        by_cols = [piece[:, j].contiguous() for j in range(piece.shape[1])]
        whole = spectrum(flat)
        require(torch.equal(whole, torch.stack([spectrum(c) for c in by_cols], dim=1).reshape(
            whole.shape)), f"{family} {tier}: stft_magnitude over a piece differs from its columns")
        enc_cols = torch.stack([encode(c) for c in by_cols], dim=1)
        enc_diff = max(enc_diff, max_abs(encode(flat).reshape(enc_cols.shape), enc_cols))
        columns.append(enc_cols)
    feats = torch.cat(columns, dim=1)
    h, c = module.init_state(x.shape[0], x.device)
    _, hn, cn = lstm_fused(feats.reshape(x.shape[0], -1, feats.shape[-1]), h, c, params["lstm_w"],
                           params["lstm_b"], wt=weight_of(params, t), tier=t)
    require(torch.equal(hn.cpu(), want[1]) and torch.equal(cn.cpu(), want[2]),
            f"{family} {tier}: lstm_fused over the steps' features differs from the loop's state")
    return (f"stft_magnitude over each piece of {slab.SCAN_PIECE_CHUNKS} chunks x {x.shape[0]} "
            f"streams: each chunk column's bits; one lstm_fused call over the steps' own features: "
            f"the loop's h and c; the encoder's torch ops (cuBLAS products) over each piece "
            f"against its columns: max abs diff {enc_diff:.3e}")


def check_slab_v45(family: str, module, params, device, tier: str, n_streams: int,
                   n_chunks: int, seed: int, totals: dict) -> None:
    """One v4/v5 slab scan (StreamRunner.scan: forward_scan) at the tier on
    seeded speech: its launches read alone (stft_magnitude once a piece,
    lstm_fused those of one call over the K*F frames of each stream); against
    the loop of StreamRunner.step on the same chunks, bit for bit or, where
    the card gives other bits, the context equal, the difference shown to
    enter at the encoder's torch products (scan_pieces) and held to
    tier_check.shard_bound(family, tier) beside its controls (within_bound);
    then its first TIER_PATH_BATCH streams against the CPU's scan of them,
    within TOL_PATH (faithful) or PATH_MAX (the bf16 tiers)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.models import slab

    chunk = V45_RATES[family][1]
    label = f"slab {family} [{tier}] {n_streams}x{n_chunks}"
    x = torch.from_numpy(speech_chunks(n_streams * n_chunks, chunk, seed=seed)).to(device).reshape(
        n_streams, n_chunks, chunk)
    runner = StreamRunner(family, params, device=device, precision=tier)
    state = runner.init_state(n_streams)
    (probs, _), counts = counted(lambda: runner.scan(x, state))
    # one lstm_fused call over the slab's frames, launched alone
    first = x[:1, :1]
    if hasattr(module, "attach_contexts"):
        first = module.attach_contexts(first, module.init_context(1, device))[0]
    frames = module.encode(params, first[:, 0], tier=tier).shape[1]
    h, c = module.init_state(n_streams, device)
    seq = torch.zeros(n_streams, n_chunks * frames, module.HIDDEN, device=device)
    _, one_call = counted(lambda: lstm_fused(seq, h, c, params["lstm_w"], params["lstm_b"],
                                             wt=weight_of(params, tier), tier=tier))
    pieces = -(-n_chunks // slab.SCAN_PIECE_CHUNKS)
    want_counts = {**{name: 0 for name in counts}, "stft_magnitude": pieces,
                   "lstm_fused": one_call["lstm_fused"]}
    require(counts == want_counts, f"{label}: launches {nonzero(counts)}, not "
            f"{nonzero(want_counts)} ({pieces} pieces of the encoder, one lstm_fused call)")
    log(f"{label} launches: {nonzero(counts)} ({pieces} pieces of up to "
        f"{slab.SCAN_PIECE_CHUNKS} chunks, one lstm_fused call)")
    add_launches(totals, counts)
    loop = runner.init_state(n_streams)
    steps = torch.stack([runner.step(x[:, k], loop)[0] for k in range(n_chunks)], dim=1)
    torch.cuda.synchronize()
    got = [t.cpu() for t in (probs, state.h, state.c)]
    want = [t.cpu() for t in (steps, loop.h, loop.c)]
    bits = same_bits(got, want)
    if state.context is not None:
        require(torch.equal(state.context, loop.context), f"{label}: the context differs")
    if bits:
        log(f"{label}: the loop of steps' bits" + (" (and its context)" if loop.context is not None
                                                    else ""))
    else:
        bound = tier_check.shard_bound(family, tier)
        require(bound is not None, f"{label}: not the loop of steps' bits "
                f"({variant_diffs({'scan': got}, want, ['probs', 'h', 'c'])}) and no bound")
        within_bound(label, module, params, x, device, got, want, bound,
                     scan_pieces(family, module, params, x, tier, want), tier, CONTROL_TIER[tier])
    # the card against the CPU's plain versions, on the first streams
    n = min(n_streams, TIER_PATH_BATCH)
    cpu = StreamRunner(family, params, device="cpu", precision=tier)
    p_cpu, s_cpu = cpu.scan(x[:n].cpu(), cpu.init_state(n))
    card = {"probs": probs[:n], "h": state.h[:, :n], "c": state.c[:, :n]}
    if tier == "faithful":
        check_close_to_cpu(f"{label}, {n} streams", card,
                           {"probs": p_cpu, "h": s_cpu.h, "c": s_cpu.c})
    else:
        errs = {"probs": max_abs(card["probs"].cpu(), p_cpu),
                "h": max_abs(card["h"].cpu(), s_cpu.h),
                "c": max_abs(card["c"].cpu(), s_cpu.c) / max(1.0, float(s_cpu.c.abs().max()))}
        limits = tier_check.PATH_MAX[tier]
        log(f"{label}, {n} streams card vs CPU: "
            + ", ".join(f"{k} {v:.3e} (bound {limits[k]:g})" for k, v in errs.items()))
        for k, v in errs.items():
            require(v <= limits[k], f"{label} card vs CPU: {k} {v:.3e}")
    if s_cpu.context is not None:
        require(torch.equal(state.context[:n].cpu(), s_cpu.context), f"{label}: CPU context")


def phase_slabs_v45(models: dict, device, totals: dict, tier_totals: dict) -> None:
    """The v4/v5 slab scan of each family at each tier on the slabs of
    SLABS_V45 (check_slab_v45), each scan's launches read alone and added
    to the faithful or the tier's totals."""
    t0 = time.perf_counter()
    for i, family in enumerate(V45_RATES):
        module, params = models[family]
        for tier in ("faithful", *TIERS):
            counts = totals if tier == "faithful" else tier_totals.setdefault(tier, {})
            for n_streams, n_chunks in SLABS_V45:
                check_slab_v45(family, module, params, device, tier, n_streams, n_chunks,
                               SEED + 1400 + i, counts)
    log(f"the v4/v5 slab checks took {time.perf_counter() - t0:.1f} s")


def write_corpus(root: Path) -> tuple[list[str], float]:
    """CORPUS_FILES files of unequal length from a seed: synthetic speech as
    raw s16le, file 3 pure digital silence, the last one a 44.1 kHz 16-bit
    wav. Returns (paths, total seconds of audio)."""
    from vadc_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(SEED + 800)
    paths, total = [], 0.0
    for i in range(CORPUS_FILES):
        seconds = float(rng.uniform(*CORPUS_SECONDS))
        total += seconds
        n = int(seconds * SR)
        audio = speech_chunks(n // CHUNK + 1, CHUNK, seed=SEED + 801 + i).ravel()[:n]
        if i == CORPUS_FILES - 1:
            # the same kind of speech at 44.1 kHz (linear interpolation)
            at = np.arange(int(seconds * 44100)) * (SR / 44100)
            audio = np.interp(at, np.arange(n), audio)
            pcm = np.clip(audio * 32768, -32768, 32767).astype("<i2")
            path = root / f"file{i:02d}_44k.wav"
            write_wav(path, pcm, sample_rate=44100)
        else:
            if i == 3:
                audio = np.zeros_like(audio)
            path = root / f"file{i:02d}.s16le"
            np.clip(audio * 32768, -32768, 32767).astype("<i2").tofile(path)
        paths.append(str(path))
    return paths, total


def run_batch_cli(argv: list[str]) -> tuple[str, float]:
    """The batch CLI in this process; returns (stdout, wall seconds)."""
    from vadc_tpu_torch.cli import batch

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = batch.main(argv)
    seconds = time.perf_counter() - t0
    require(rc == 0, f"batch CLI {argv[-6:]} exited {rc}: {err.getvalue()}")
    return out.getvalue(), seconds


# the batch CLI's kernels besides its family's scan: the segmenter's FSM, one
# launch a slab on the first device over every stream's probabilities
BATCH_KERNELS = ("fsm_scan",)


def phase_main_path_batch(device, totals: dict, model: str | None = None,
                          family: str = "v3") -> dict:
    """The offline corpus CLI over the seeded corpus with --cut_dir, on the
    card and on the CPU: identical lines and cut files; per file the lines
    of the port's streaming CLI on the card. `model`: a weight file other
    than the bundled v3.1 archive, of `family` (the v4 and v5 scans: their
    launches stft_magnitude and lstm_fused). With official weights (v3.1,
    v4) the silent file has no segment and every file a line; the synthetic
    v5 weights' lines are logged."""
    from vadc_tpu_torch.cli import main as cli

    extra = [] if model is None else ["--model", model]
    kernels = (*(V3_SLAB_KERNELS if family == "v3" else SCAN_KERNELS[family]), *BATCH_KERNELS)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, audio_s = write_corpus(root)
        argv = [*paths, "--slab_chunks", str(SLAB_CHUNKS), *extra]
        zero_launches()
        out_gpu, first_s = run_batch_cli([*argv, "--device", "cuda", "--cut_dir", str(root / "cut_gpu")])
        read_launches(f"batch CLI {family}, {CORPUS_FILES} files", totals, kernels)
        _, again_s = run_batch_cli([*argv, "--device", "cuda"])
        out_cpu, cpu_s = run_batch_cli([*argv, "--device", "cpu", "--cut_dir", str(root / "cut_cpu")])
        lines = out_gpu.splitlines()
        log(f"batch CLI {family} --device cuda: {CORPUS_FILES} files, {audio_s:.1f} s of audio, "
            f"{len(lines)} segment lines in {first_s:.3f} s (first call, weights and --cut_dir "
            f"included: {audio_s / first_s:.1f} audio s per wall s), {again_s:.3f} s again without "
            f"--cut_dir ({audio_s / again_s:.1f} audio s per wall s); --device cpu {cpu_s:.3f} s")
        require(out_gpu == out_cpu, f"batch CLI {family}: lines differ between cuda and cpu")
        silent = [line for line in lines if line.startswith(paths[3] + "\t")]
        if family.startswith("v5"):
            log(f"batch CLI {family} (synthetic weights): {len(silent)} lines on the silent file")
        else:
            require(len(lines) >= CORPUS_FILES, f"batch CLI {family}: only {len(lines)} lines")
            require(not silent, f"batch CLI {family}: segments in the silent file")
        cut_gpu = {p.name: p.read_bytes() for p in sorted((root / "cut_gpu").iterdir())}
        cut_cpu = {p.name: p.read_bytes() for p in sorted((root / "cut_cpu").iterdir())}
        require(sorted(cut_gpu) == sorted(Path(p).name for p in paths), f"cut files {sorted(cut_gpu)}")
        require(cut_gpu == cut_cpu, f"batch CLI {family}: cut files differ between cuda and cpu")
        log(f"batch CLI {family} cut files: {len(cut_gpu)} written, "
            f"{sum(map(len, cut_gpu.values()))} bytes, identical on cuda and cpu")
        # the streaming CLI, file by file, on the card
        for path in paths:
            out, err = io.StringIO(), io.StringIO()
            saved = sys.stdin
            with open(path, "rb") as f, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                try:
                    if path.endswith(".wav"):
                        rc = cli.main([path, "--device", "cuda", *extra])
                    else:
                        sys.stdin = io.TextIOWrapper(f)
                        rc = cli.main(["--device", "cuda", *extra])
                finally:
                    sys.stdin = saved
            require(rc == 0, f"streaming CLI on {path}: exit {rc}: {err.getvalue()}")
            batch_lines = [ln.split("\t")[1] for ln in lines if ln.startswith(path + "\t")]
            require(batch_lines == out.getvalue().split(),
                    f"{family} {Path(path).name}: batch {batch_lines} vs streaming "
                    f"{out.getvalue().split()}")
        log(f"batch CLI {family}: every file's lines equal the streaming CLI's "
            f"({CORPUS_FILES} files)")
    return {"audio_s": audio_s, "wall_s": again_s}


def phase_main_path_batch_v45(device, archives: dict, totals: dict) -> None:
    """phase_main_path_batch with the bundled v4 archive and a synthetic v5
    archive (random_v5_archive(0)): their slabs are the v4 and v5 scans."""
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive

    with tempfile.TemporaryDirectory() as tmp:
        v5 = Path(tmp) / "v5_synthetic.testtensor"
        save_archive(v5, random_v5_archive(0))
        for family, model in (("v4", archives["v4"]), ("v5", v5)):
            phase_main_path_batch(device, totals, str(model), family)


def client_pcm(index: int) -> bytes:
    """SERVER_AUDIO_S seconds of seeded speech as s16le bytes."""
    n = int(SERVER_AUDIO_S * SR) // CHUNK
    audio = speech_chunks(n, CHUNK, seed=SEED + 500 + index).ravel()
    return np.clip(audio * 32768, -32768, 32767).astype("<i2").tobytes()


def count_shard_steps(srv) -> list:
    """Wraps each shard runner's step_into (one chunk-step of the shard's
    slots) of a server that has not started. Returns the shards' call
    counts, which the wrappers add to."""
    steps = [0] * len(srv._shards)
    for k, sh in enumerate(srv._shards):
        def step_into(*args, k=k, inner=sh.runner.step_into):
            steps[k] += 1
            return inner(*args)

        sh.runner.step_into = step_into
    return steps


def require_server_launches(label: str, srv, counts: dict, totals: dict,
                            required: tuple) -> None:
    """One server's run (`counts`: its launches alone) launched, for each
    chunk-step of each shard (every shard steps at every tick), what one
    unsharded step of the family on a shard's slots launches: every step of
    every shard went through the kernels."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner

    read_launches(label, totals, required, counts)
    steps = srv.shard_steps
    require(len(set(steps)) == 1 and steps[0] > 0, f"{label}: chunk-steps per shard {steps}")
    one, rows = srv.runner.runners[0], srv.n // len(steps)
    probe = StreamRunner(srv.family, one.params, device=one.device, precision=one.precision)
    state = probe.init_state(rows)
    audio = torch.zeros(rows, srv.chunk, device=one.device)
    _, per_step = counted(lambda: probe.step(audio, state))
    require(one.device.type == "cpu" or any(per_step.values()),
            f"{label}: an unsharded step launches nothing")
    require(counts == {k: sum(steps) * v for k, v in per_step.items()},
            f"{label}: launches {nonzero(counts)}, not {sum(steps)} chunk-steps ({steps} by "
            f"shard) x one step's {nonzero(per_step)}")
    log(f"{label}: {steps} chunk-steps by shard, each launching one step's {nonzero(per_step)}")


def require_resume_launches(label: str, saved: dict, totals: dict, required: tuple) -> None:
    """require_server_launches for each of a resume run's two servers."""
    for part, (srv, counts) in zip(("part 1", "part 2"), saved["parts"]):
        on_card = srv.runner.devices[0].type == "cuda"
        require_server_launches(f"{label}, {part} on {srv.runner.devices[0]}", srv, counts,
                                totals, required if on_card else ())


def start_server(device, ckpt: Path | None = None, **server_kw):
    """A VadServer (SERVER_SLOTS slots; the bundled v3.1 archive unless
    `model` names another) on `device`, restored from the checkpoint `ckpt`
    when one is given, serving through serve_forever (its warm-up included)
    on a free localhost port in a thread. Returns (server, stop): stop()
    ends it and raises if it failed."""
    import threading

    from vadc_tpu_torch.server import VadServer

    srv = VadServer(port=0, max_streams=SERVER_SLOTS, device=device, **server_kw)
    srv.shard_steps = count_shard_steps(srv)
    if ckpt is not None:
        srv.restore_checkpoint(ckpt)
    failure = []

    def serve():
        try:
            srv.serve_forever()
        except Exception as e:  # noqa: BLE001 - reported by stop()
            failure.append(e)
            srv.ready.set()

    server_thread = threading.Thread(target=serve, daemon=True)
    server_thread.start()

    def stop():
        srv.stop()
        server_thread.join(timeout=60)
        require(not failure, f"server on {device} failed: {failure}")

    if not srv.ready.wait(timeout=600) or failure:
        stop()
        raise AssertionError(f"server on {device} did not start")
    return srv, stop


def exchange(address, payload: bytes, sock=None) -> bytes:
    """Send the payload on a new connection (or on `sock`), half-close and
    read until the server closes."""
    import socket

    c = sock or socket.create_connection(address, timeout=120)
    try:
        c.sendall(payload)
        c.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := c.recv(4096):
            data += chunk
        return data
    finally:
        c.close()


def in_threads(fn, n: int) -> list:
    """fn(i) for i < n, each in its own thread; the results in order."""
    import threading

    results = [None] * n

    def run(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(all(r is not None for r in results), "a client got no answer")
    return results


def serve_clients(device, payloads: list[bytes], **server_kw):
    """A VadServer (the bundled v3.1 archive, SERVER_SLOTS slots) on
    `device` through serve_forever on a free localhost port; one client
    thread per payload sends it unpaced, half-closes and reads the segment
    lines until the server closes. Returns (lines per client, server)."""
    srv, stop = start_server(device, **server_kw)
    try:
        results = in_threads(lambda i: exchange(srv.address, payloads[i]), len(payloads))
    finally:
        stop()
    return [r.decode().splitlines() for r in results], srv


def phase_server(device, totals: dict) -> list:
    """The serving daemon on the card against itself on the CPU: SERVER_CLIENTS
    clients send seeded speech faster than realtime (so catch-up ticks
    happen); each client's segment lines must be the same on both. Returns
    the lines."""
    payloads = [client_pcm(i) for i in range(SERVER_CLIENTS)]
    zero_launches()
    t0 = time.perf_counter()
    lines_gpu, srv = serve_clients(device, payloads)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    require_server_launches("server", srv, launches, totals, ("forward_fused",))
    ticks_ms = np.array(srv.tick_times) * 1e3
    log(f"server on {device}: {SERVER_CLIENTS} clients x {SERVER_AUDIO_S:g} s in {wall:.2f} s "
        f"(build and warm-up included); launches {launches}; tick_count {srv.tick_count}, "
        f"catchup_ticks {srv.catchup_ticks}, tick ms p50 {np.percentile(ticks_ms, 50):.4f} "
        f"p99 {np.percentile(ticks_ms, 99):.4f} over {ticks_ms.size} ticks with audio")
    t0 = time.perf_counter()
    lines_cpu, srv_cpu = serve_clients("cpu", payloads)
    log(f"server on cpu: {time.perf_counter() - t0:.2f} s, tick_count {srv_cpu.tick_count}, "
        f"catchup_ticks {srv_cpu.catchup_ticks}")
    for i, (g, c) in enumerate(zip(lines_gpu, lines_cpu)):
        log(f"server client {i}: cuda {g}")
        require(g == c, f"server client {i}: segment lines differ: cuda {g} cpu {c}")
        require(len(g) > 0 and not any(line.startswith("error") for line in g),
                f"server client {i}: {g}")
    return lines_gpu


def connect_in_order(srv, n: int) -> list:
    """n client sockets, each connected once the one before it holds its
    slot. A fresh server hands its slots out from the top down, so the i-th
    client of every run lands on slot SERVER_SLOTS - 1 - i: the slot whose
    saved stream a restored server continues."""
    import socket

    socks = []
    for i in range(n):
        socks.append(socket.create_connection(srv.address, timeout=120))
        deadline = time.monotonic() + 60
        while srv.slots[SERVER_SLOTS - 1 - i] is None and time.monotonic() < deadline:
            time.sleep(0.002)
        require(srv.slots[SERVER_SLOTS - 1 - i] is not None, f"client {i} got no slot")
    return socks


def resume_run(payloads: list[bytes], chunk: int, first: dict, second: dict) -> tuple[list, dict]:
    """Each payload cut at the chunk boundary nearest below its middle.
    Part 1 goes into a server made by start_server(**first), each client on
    its own slot with its connection held open; once every chunk is through,
    save_checkpoint runs while the server serves, each client takes what it
    was sent, and the server stops. Part 2 goes into a fresh server made by
    start_server(**second) and restored from the file, the clients
    reconnecting in the same order. Returns each client's lines (part 1's,
    then part 2's) and what the run saw: the segments held pending at the
    save, the save's wall seconds, the file's size and its bytes, and each
    part's server with the launches of its run alone."""
    chunk_bytes = 2 * chunk
    cuts = [len(p) // 2 // chunk_bytes * chunk_bytes for p in payloads]
    slots = [SERVER_SLOTS - 1 - i for i in range(len(payloads))]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "server.ckpt"
        zero_launches()
        srv, stop = start_server(**first)
        socks: list = []
        try:
            socks = connect_in_order(srv, len(payloads))
            for c, p, cut in zip(socks, payloads, cuts):
                c.sendall(p[:cut])
            want = [cut // chunk_bytes for cut in cuts]
            deadline = time.monotonic() + 300
            while (time.monotonic() < deadline
                   and [int(srv.fsm.chunk_index[s]) for s in slots] != want):
                time.sleep(0.005)
            fed = [int(srv.fsm.chunk_index[s]) for s in slots]
            require(fed == want, f"part 1 not through: {fed} of {want} chunks")
            held = [srv.slots[s].pending for s in slots]
            t0 = time.perf_counter()
            srv.save_checkpoint(path)
            save_s = time.perf_counter() - t0
            # all a client was sent before the save is in its receive buffer
            before = []
            for c in socks:
                c.setblocking(False)
                got = b""
                with contextlib.suppress(BlockingIOError):
                    while data := c.recv(4096):
                        got += data
                before.append(got)
        finally:
            stop()
            for c in socks:
                c.close()
        parts = [(srv, launch_counts())]
        saved = {"held": held, "save_s": save_s, "bytes": path.stat().st_size,
                 "data": path.read_bytes(), "part1_lines": sum(b.count(b"\n") for b in before),
                 "parts": parts}
        zero_launches()
        srv2, stop2 = start_server(ckpt=path, **second)
        try:
            socks = connect_in_order(srv2, len(payloads))
            after = in_threads(lambda i: exchange(None, payloads[i][cuts[i]:], socks[i]),
                               len(payloads))
        finally:
            stop2()
        parts.append((srv2, launch_counts()))
    return [(b + a).decode().splitlines() for b, a in zip(before, after)], saved


def check_resumed(label: str, lines: list, saved: dict, want: list, need_held: bool = True) -> None:
    """A resumed run's lines against the uninterrupted run's, client by
    client."""
    n_held = sum(p is not None for p in saved["held"])
    log(f"server checkpoint {label}: {len(want)} clients, {n_held} segments held pending at "
        f"the save, {saved['part1_lines']} lines sent before it; save_checkpoint "
        f"{1e3 * saved['save_s']:.2f} ms while serving, {saved['bytes']} bytes")
    require(n_held > 0 or not need_held, f"server checkpoint {label}: no segment held pending")
    for i, (got, ref) in enumerate(zip(lines, want)):
        require(got == ref, f"server checkpoint {label}, client {i}: {got} vs uninterrupted {ref}")
    log(f"server checkpoint {label}: every client's lines equal the uninterrupted run's")


def phase_server_checkpoint(device, want: list, totals: dict, tier_totals: dict) -> list:
    """Save and resume across a restart of the server (bundled v3.1,
    SERVER_SLOTS slots, SERVER_CLIENTS clients of seeded speech, each cut
    near its middle): card to card, card to CPU and CPU to card, each
    client's lines those of the uninterrupted run (`want`, phase_server's,
    which are the CPU server's too); then card to card at --precision fast
    and with the synthetic v5 archive (the audio context in the state),
    each against its own uninterrupted run on the card. Each server's
    launches are read alone. Returns the v5 server's uninterrupted lines."""
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive

    payloads = [client_pcm(i) for i in range(SERVER_CLIENTS)]
    for label, a, b in (("card -> card", device, device), ("card -> cpu", device, "cpu"),
                        ("cpu -> card", "cpu", device)):
        lines, saved = resume_run(payloads, CHUNK, {"device": a}, {"device": b})
        require_resume_launches(f"server checkpoint {label}", saved, totals, ("forward_fused",))
        check_resumed(label, lines, saved, want)
    fast = {"device": device, "precision": "fast"}
    want_fast, _ = serve_clients(**fast, payloads=payloads)
    lines, saved = resume_run(payloads, CHUNK, fast, fast)
    require_resume_launches("fast: server checkpoint card -> card", saved, tier_totals["fast"],
                            ("forward_fused",))
    check_resumed("card -> card at fast", lines, saved, want_fast)
    with tempfile.TemporaryDirectory() as tmp:
        archive = Path(tmp) / "v5_synthetic.testtensor"
        save_archive(archive, random_v5_archive(0))
        v5 = {"device": device, "model": str(archive)}
        want_v5, _ = serve_clients(**v5, payloads=payloads)
        lines, saved = resume_run(payloads, V5_CHUNK, v5, v5)
        require_resume_launches("v5 server checkpoint card -> card", saved, totals,
                                ("stft_magnitude", "lstm_fused"))
    # the synthetic weights' probabilities hover near the threshold: a held
    # segment is not required of them
    check_resumed("card -> card, v5 (synthetic weights)", lines, saved, want_v5, need_held=False)
    return want_v5


def api_track(sr: int, seconds: float, seed: int) -> np.ndarray:
    """`seconds` of synthetic speech at `sr` with a noise floor: utterance
    tracks of successive seeds, end to end."""
    from vadc_tpu_torch.io.synthaudio import utterance_track

    parts, need, k = [], int(seconds * sr), 0
    while sum(map(len, parts)) < need:
        parts.append(utterance_track(4, sr=sr, seed=seed + k)[0])
        k += 1
    return np.concatenate(parts)[:need].astype(np.float32)


def to_s16(audio: np.ndarray) -> np.ndarray:
    return np.clip(audio * 32768, -32768, 32767).astype("<i2")


def api_models(archives: dict, root: Path) -> dict:
    """family -> the weight file the API takes: the bundled v3.1, v4 and v4
    8 kHz archives, the synthetic v5 ones written under `root`."""
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.models.synthetic import (
        random_v5_8k_archive, random_v5_archive, save_archive,
    )

    save_archive(root / "v5.testtensor", random_v5_archive(0))
    save_archive(root / "v5_8k.testtensor", random_v5_8k_archive(1))
    return {"v3": str(DEFAULT_WEIGHTS), "v4": str(archives["v4"]), "v4_8k": str(archives["v4_8k"]),
            "v5": str(root / "v5.testtensor"), "v5_8k": str(root / "v5_8k.testtensor")}


def phase_api(device, archives: dict, totals: dict) -> None:
    """The Python API (vadc_tpu_torch.api) on the card against the CPU, each
    family counted on its own: speech_probabilities on API_SECONDS of seeded
    speech within TOL_API; detect_speech_samples and stream_segments give
    the same segments on the card as on the CPU and as each other; then
    detect_speech on the v3.1 track as a 44.1 kHz wav."""
    from vadc_tpu_torch import api
    from vadc_tpu_torch.io.wav import write_wav

    with tempfile.TemporaryDirectory() as tmp:
        models = api_models(archives, Path(tmp))
        for family, model in models.items():
            sr = SR // 2 if family.endswith("_8k") else SR
            # s16 round trip: the stream generator reads s16le, the others
            # take the same samples as floats
            pcm = to_s16(api_track(sr, API_SECONDS, SEED + 900))
            track = pcm.astype(np.float32) / 32768.0
            got, seconds = {}, {}
            for dev in ("cuda", "cpu"):
                zero_launches()
                t0 = time.perf_counter()
                got[dev] = (api.speech_probabilities(track, model=model, device=dev),
                            api.detect_speech_samples(track, model=model, device=dev),
                            list(api.stream_segments(io.BytesIO(pcm.tobytes()), model=model,
                                                     device=dev)))
                seconds[dev] = time.perf_counter() - t0
                if dev == "cuda":
                    read_launches(f"api {family}", totals, API_KERNELS[family])
            (pg, seg_g, stream_g), (pc, seg_c, stream_c) = got["cuda"], got["cpu"]
            err = float(np.abs(pg - pc).max())
            bound = TOL_API.get(family, TOL_PATH)
            log(f"api {family}: {API_SECONDS:g} s at {sr} Hz, {pg.size} probabilities, max abs "
                f"diff cuda vs cpu {err:.3e} (bound {bound:g}); {len(seg_g)} segments; the three "
                f"calls {seconds['cuda']:.2f} s on cuda (weights loaded), "
                f"{seconds['cpu']:.2f} s on cpu")
            require(pg.shape == pc.shape and bool(np.isfinite(pg).all()), f"api {family}: probs")
            require(err <= bound, f"api {family}: probabilities differ by {err:.3e}")
            require(seg_g == seg_c, f"api {family}: detect_speech_samples cuda {seg_g} cpu {seg_c}")
            require(stream_g == stream_c, f"api {family}: stream_segments cuda vs cpu")
            require(len(stream_g) == len(seg_g) and all(
                abs(a - b) <= 1e-6 for s, t in zip(stream_g, seg_g) for a, b in zip(s, t)),
                f"api {family}: stream_segments {stream_g} vs detect_speech_samples {seg_g}")
            require(len(seg_g) > 0 or family.startswith("v5"), f"api {family}: no segment")
        # the v3.1 track at 44.1 kHz in a wav: decoded and resampled natively
        audio = api_track(SR, API_SECONDS, SEED + 900)
        at = np.arange(int(API_SECONDS * 44100)) * (SR / 44100)
        wav = Path(tmp) / "speech_44k.wav"
        write_wav(wav, to_s16(np.interp(at, np.arange(audio.size), audio)), sample_rate=44100)
        zero_launches()
        seg_g = api.detect_speech(wav, device="cuda")
        read_launches("api detect_speech (44.1 kHz wav)", totals, V3_SLAB_KERNELS)
        seg_c = api.detect_speech(wav, device="cpu")
        log(f"api detect_speech on a 44.1 kHz wav: cuda {seg_g}")
        require(seg_g == seg_c and len(seg_g) > 0, f"api detect_speech: cuda {seg_g} cpu {seg_c}")


def phase_cutter(device, totals: dict) -> None:
    """vadc-torch-cut --device cuda against --device cpu on a seeded wav and
    on raw s16le: identical output bytes."""
    from vadc_tpu_torch.cli import cut
    from vadc_tpu_torch.io.wav import write_wav

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pcm = to_s16(api_track(SR, CUT_SECONDS, SEED + 950))
        write_wav(root / "in.wav", pcm, sample_rate=SR)
        pcm.tofile(root / "in.s16le")
        for name in ("in.wav", "in.s16le"):
            out = {}
            for dev in ("cuda", "cpu"):
                dst = root / f"out_{dev}_{name}"
                err = io.StringIO()
                zero_launches()
                with contextlib.redirect_stderr(err):
                    rc = cut.main([str(root / name), str(dst), "--device", dev, "--stats"])
                if dev == "cuda":
                    read_launches(f"cutter {name}", totals, V3_SLAB_KERNELS)
                require(rc == 0, f"cutter --device {dev} {name}: exit {rc}: {err.getvalue()}")
                out[dev] = dst.read_bytes()
            log(f"cutter {name}: {err.getvalue().strip()}; {len(out['cuda'])} bytes out of "
                f"{(root / name).stat().st_size}, identical on cuda and cpu: "
                f"{out['cuda'] == out['cpu']}")
            require(out["cuda"] == out["cpu"], f"cutter {name}: outputs differ")
            require(0 < len(out["cuda"]) < (root / name).stat().st_size, f"cutter {name}: size")


MULTI_REPEATS = 7  # repeats of each timing of the multi-device phase


@contextlib.contextmanager
def cards_as(devices: list):
    """Within the block, "every visible card" (engine/shard.py:
    stream_devices(), the device list of the batch CLI's --device cuda) is
    `devices`: two shards of one card stand in for two cards."""
    from vadc_tpu_torch.engine import shard

    resolve = shard.stream_devices
    shard.stream_devices = lambda given=None: resolve(devices if given is None else given)
    try:
        yield
    finally:
        shard.stream_devices = resolve


# which kernels each call of the runners launches, by family: a step; a
# scan, v3.1's slab route, and v4's and v5's forward_scan: stft_magnitude
# once a piece of the encoder (models/slab.py: SCAN_PIECE_CHUNKS chunks of
# every stream, so a shard's scan has the unsharded scan's pieces) and
# lstm_fused once (check_slab_v45 holds those counts)
STEP_KERNELS = {"v3": ("forward_fused",), "v4": ("stft_magnitude", "lstm_fused"),
                "v5": ("stft_magnitude", "lstm_fused")}
SCAN_KERNELS = {"v3": V3_SLAB_KERNELS, "v4": ("stft_magnitude", "lstm_fused"),
                "v5": ("stft_magnitude", "lstm_fused")}


def v5_stages_by_halves(params, x) -> str:
    """Which stage of the v5 step gives other bits on half the streams:
    stft_magnitude on each half against the whole (required equal: the
    kernel's arithmetic is per stream), then the encoder's convs."""
    import torch

    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
    from vadc_tpu_torch.models import silero_v5

    audio = torch.cat([torch.zeros(x.shape[0], silero_v5.CONTEXT_SAMPLES, device=x.device), x],
                      dim=-1)
    wr, wi = split_basis_of(params)

    def spect(a):
        return stft_magnitude(a, wr, wi, pad_left=0, pad_right=silero_v5.STFT_PAD_RIGHT,
                              hop=silero_v5.STFT_HOP)

    half = x.shape[0] // 2
    whole = spect(audio)
    halves = torch.cat([spect(audio[:half]), spect(audio[half:])])
    require(torch.equal(whole, halves), "v5: stft_magnitude on half the streams differs")
    convs = silero_v5._convs(params, whole, silero_v5.FAITHFUL)
    conv_halves = torch.cat([silero_v5._convs(params, whole[:half], silero_v5.FAITHFUL),
                             silero_v5._convs(params, whole[half:], silero_v5.FAITHFUL)])
    return (f"stft_magnitude on each half: the whole's bits; the encoder's convs (torch.matmul) "
            f"on each half: max abs diff {max_abs(convs, conv_halves):.3e}")


def shard_errs(got, want) -> dict:
    """The largest differences of (probs, h, c) from the unsharded run's:
    of the probabilities, and of the state (h and c)."""
    return {"probs": max_abs(got[0], want[0]),
            "state": max(max_abs(got[1], want[1]), max_abs(got[2], want[2]))}


def first_half_by(first, module, params, x, device, tier: str = "faithful") -> tuple:
    """The module's step at the tier and the steps after it over x [B, T,
    chunk] from a zero state (a v5 context carried), the first half of the
    streams through `first` (audio, h, c) -> (probs, hn, cn), the second half
    through the kernels: (probs [B, T], h, c)."""
    import torch

    half = x.shape[0] // 2
    h, c = module.init_state(x.shape[0], device)
    context = module.init_context(x.shape[0], device) if hasattr(module, "init_context") else None
    probs = []
    for t in range(x.shape[1]):
        audio = x[:, t].to(device)
        if context is not None:
            audio, context = module.attach_context(audio, context)
        h0, h1 = h[:, :half].contiguous(), h[:, half:].contiguous()
        c0, c1 = c[:, :half].contiguous(), c[:, half:].contiguous()
        p0, h0, c0 = first(audio[:half], h0, c0)
        p1, h1, c1 = module.forward(params, audio[half:], h1, c1, tier=tier)
        probs.append(torch.cat([p0, p1]))
        h, c = torch.cat([h0, h1], dim=1), torch.cat([c0, c1], dim=1)
    return torch.stack(probs, dim=1), h, c


def within_bound(label: str, module, params, x, device, got: list, want: list, bound: dict,
                 where: str, tier: str = "faithful", control: str = "fast") -> None:
    """A run (`got`: probs [B, T], h, c) that misses the loop of steps'
    bits (`want`, the same T chunks from a zero state at the tier) held to
    `bound` (tier_check.SHARD_BOUND), beside two controls: the first half of
    the streams through the kernels at the `control` tier, which must break
    it, and through the plain versions at the tier, which reads just above
    the sound run and is logged only: the launch counts, not a limit, tell a
    run of plain versions from one of kernels. `where` says where the
    difference enters."""
    sound = shard_errs(got, want)
    controls = {
        f"the {control} tier": lambda a, h, c: module.forward(params, a, h, c, tier=control),
        "the plain versions": lambda a, h, c: module.forward_reference(params, a, h, c, tier=tier),
    }
    readings = {name: shard_errs([t.cpu() for t in first_half_by(first, module, params, x,
                                                                 device, tier)], want)
                for name, first in controls.items()}
    log(f"{label}: largest differences after {x.shape[1]} steps {sound}; bound {bound}; {where}")
    for name, errs in readings.items():
        log(f"{label}: control, the first half's streams by {name}: {errs}")
    errs = readings[f"the {control} tier"]
    require(errs["probs"] > bound["probs"] and errs["state"] > bound["state"],
            f"{label}: the control at the {control} tier ({errs}) does not break {bound}")
    require(sound["probs"] <= bound["probs"] and sound["state"] <= bound["state"],
            f"{label}: {sound} beyond {bound}")


def sharded_vs_unsharded(family: str, params, devices: list, chunk: int, seed: int,
                         totals: dict, scan_chunks: int = 0) -> None:
    """ShardedStreamRunner over `devices` against the unsharded StreamRunner
    on the first, B_MAIN streams: one step, then (scan_chunks > 0) one scan
    of that many chunks. Each call's launches are read alone, and the
    sharded call's are n_shards times the unsharded call's. Probabilities,
    h, c and a v5 context bit for bit, except v5's probabilities and state:
    held to SHARD_BOUND beside its controls (within_bound)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner
    from vadc_tpu_torch.kernels.tier_check import SHARD_BOUND

    n = len(devices)
    x = torch.from_numpy(speech_chunks(B_MAIN * (1 + scan_chunks), chunk, seed=seed)).reshape(
        B_MAIN, 1 + scan_chunks, chunk)
    sharded = ShardedStreamRunner(family, params, devices)
    plain = StreamRunner(family, params, device=devices[0])
    s_state, p_state = sharded.init_state(B_MAIN), plain.init_state(B_MAIN)
    label = (f"{family} sharded over {[str(d) for d in devices]}: step"
             + (f" and scan {B_MAIN}x{scan_chunks}" if scan_chunks else "") + f" at B={B_MAIN}")
    first = x[:, 0].to(devices[0])
    (got_step, _), s_counts = counted(lambda: sharded.step(first, s_state))
    (want_step, _), p_counts = counted(lambda: plain.step(first, p_state))
    require_scaled(f"{label}, the step", s_counts, p_counts, n, STEP_KERNELS[family], totals)
    after_step = shard_errs((got_step, s_state.h, s_state.c), (want_step, p_state.h, p_state.c))
    got, want = [got_step[:, None]], [want_step[:, None]]
    if scan_chunks:
        rest = x[:, 1:].to(devices[0])
        (got_scan, _), s_counts = counted(lambda: sharded.scan(rest, s_state))
        (want_scan, _), p_counts = counted(lambda: plain.scan(rest, p_state))
        require_scaled(f"{label}, the scan", s_counts, p_counts, n, SCAN_KERNELS[family], totals)
        got.append(got_scan)
        want.append(want_scan)
    got = [torch.cat(got, dim=1), s_state.h, s_state.c, s_state.context]
    want = [torch.cat(want, dim=1), p_state.h, p_state.c, p_state.context]
    if want[-1] is None:
        got, want = got[:-1], want[:-1]
    torch.cuda.synchronize()
    got, want = [t.cpu() for t in got], [t.cpu() for t in want]
    if same_bits(got, want):
        log(f"{label}: the unsharded runner's bits")
        return
    diffs = variant_diffs({"sharded": got}, want, ["probs", "h", "c", "context"])
    require(family in SHARD_BOUND, f"{label}: not the unsharded bits ({diffs})")
    require(torch.equal(got[-1], want[-1]), f"{label}: the context differs ({diffs})")
    from vadc_tpu_torch.models import silero_v5

    halves = v5_stages_by_halves(params, x[:, 0].to(devices[0]))
    within_bound(label, silero_v5, params, x, devices[0], got, want, SHARD_BOUND["v5"],
                 f"after the step {after_step}; {halves}")


def batch_cli_sharded(root: Path, paths: list, devices: list | None, totals: dict) -> None:
    """The batch CLI over the corpus with --cut_dir, --device cuda over
    `devices` (None: every visible card) against --device cuda:0 (one
    device): identical lines and cut files, each run's launches read alone
    and the sharded run's n_shards times the one device's, but for the
    segmenter's (BATCH_KERNELS), which runs once over the gathered slab."""
    import torch

    argv = [*paths, "--slab_chunks", str(SLAB_CHUNKS)]
    n = len(devices) if devices else torch.cuda.device_count()
    label = f"batch CLI over {[str(d) for d in devices] if devices else 'every card'}"
    (out_one, _), one = counted(
        lambda: run_batch_cli([*argv, "--device", "cuda:0", "--cut_dir", str(root / "one")]))
    with cards_as(devices) if devices else contextlib.nullcontext():
        (out_sharded, seconds), got = counted(
            lambda: run_batch_cli([*argv, "--device", "cuda", "--cut_dir",
                                   str(root / "sharded")]))
    require_scaled(label, got, one, n, V3_SLAB_KERNELS, totals, once=BATCH_KERNELS)
    cut = [{p.name: p.read_bytes() for p in sorted((root / d).iterdir())}
           for d in ("one", "sharded")]
    require(out_sharded == out_one, f"{label}: lines differ from one device's")
    require(cut[0] == cut[1] and len(cut[0]) == len(paths), f"{label}: cut files differ")
    log(f"{label}: {len(out_one.splitlines())} lines and {len(cut[0])} cut files equal one "
        f"device's ({seconds:.3f} s)")
    for d in ("one", "sharded"):
        for f in (root / d).iterdir():
            f.unlink()


def server_sharded(device, devices: list, want: list, totals: dict) -> None:
    """The server over `devices` (SERVER_SLOTS slots, the SERVER_CLIENTS
    clients of phase_server): each client's lines those of the unsharded
    server (`want`); then resumes sharded -> unsharded and unsharded ->
    sharded, each client's lines the uninterrupted run's, and the sharded
    server's save byte for byte the unsharded one's. Each server's
    launches are read alone."""
    payloads = [client_pcm(i) for i in range(SERVER_CLIENTS)]
    label = f"server over {[str(d) for d in devices]}"
    zero_launches()
    lines, srv = serve_clients(device, payloads, devices=devices)
    require_server_launches(label, srv, launch_counts(), totals, ("forward_fused",))
    require(len(srv._shards) == len(devices), f"{label}: {len(srv._shards)} shards")
    for i, (got, ref) in enumerate(zip(lines, want)):
        require(got == ref, f"{label}, client {i}: {got} vs unsharded {ref}")
    log(f"{label}: every client's lines equal the unsharded server's; tick_count "
        f"{srv.tick_count}, catchup_ticks {srv.catchup_ticks}")
    runs = {}
    for first, second in (("sharded", "unsharded"), ("unsharded", "sharded")):
        kw = {"sharded": {"device": device, "devices": devices}, "unsharded": {"device": device}}
        lines, saved = resume_run(payloads, CHUNK, kw[first], kw[second])
        require_resume_launches(f"{label} checkpoint {first} -> {second}", saved, totals,
                                ("forward_fused",))
        check_resumed(f"{first} -> {second} ({label})", lines, saved, want)
        runs[first] = saved["data"]
    require(runs["sharded"] == runs["unsharded"],
            f"{label}: the sharded save's bytes differ from the unsharded one's")
    log(f"{label}: the sharded save holds the unsharded save's {len(runs['sharded'])} bytes")


def server_sharded_v5(device, devices: list, want: list, totals: dict) -> None:
    """The v5 server (the synthetic archive) over `devices`: each client's
    lines those of the unsharded v5 server (`want`, phase_server_checkpoint's
    uninterrupted run), its launches read alone."""
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive

    payloads = [client_pcm(i) for i in range(SERVER_CLIENTS)]
    label = f"v5 server over {[str(d) for d in devices]}"
    with tempfile.TemporaryDirectory() as tmp:
        archive = Path(tmp) / "v5_synthetic.testtensor"
        save_archive(archive, random_v5_archive(0))
        zero_launches()
        lines, srv = serve_clients(device, payloads, model=str(archive), devices=devices)
        require_server_launches(label, srv, launch_counts(), totals,
                                ("stft_magnitude", "lstm_fused"))
    for i, (got, ref) in enumerate(zip(lines, want)):
        require(got == ref, f"{label}, client {i}: {got} vs unsharded {ref}")
    log(f"{label}: every client's {sum(map(len, lines))} lines in all equal the unsharded "
        f"server's")


def dryrun_on_the_card() -> None:
    """tools/torch_multidevice_dryrun.py --device cuda: 2 processes of 2
    devices over gloo, each bit for bit against an unsharded run."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_multidevice_dryrun.py"),
                           "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    for line in proc.stdout.splitlines():
        log(f"dry run: {line}")
    require(proc.returncode == 0 and proc.stdout.splitlines()[-1:] == ["MULTIDEVICE DRYRUN OK"],
            f"multi-device dry run exited {proc.returncode}: {proc.stderr[-3000:]}")
    log(f"dry run: {time.perf_counter() - t0:.1f} s, processes included")


def trace_names_the_kernel(params, device) -> None:
    """One v3.1 step under tracing.profile: the trace names forward_fused."""
    import torch

    from vadc_tpu_torch import tracing
    from vadc_tpu_torch.engine.runner import StreamRunner

    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(B_MAIN)
    x = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 1100)).to(device)
    runner.step(x, state)
    with tempfile.TemporaryDirectory() as tmp:
        with tracing.profile(tmp):
            runner.step(x, state)
            torch.cuda.synchronize()
        (trace,) = list(Path(tmp).glob("vadc_trace_*.json"))
        events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    require("forward_fused" in names, f"trace names {sorted(n for n in names if n)[:40]}")
    log(f"tracing.profile: a v3.1 step's trace has {len(events)} events, the zone "
        f"forward_fused and the device kernels {kernels}")


def spread(label: str, times: list) -> dict:
    """Median and spread of repeated timings (ms), logged."""
    med, lo, hi = float(np.median(times)), float(min(times)), float(max(times))
    log(f"time {label}: median {med:.4f} ms over {len(times)} repeats (min {lo:.4f}, "
        f"max {hi:.4f})")
    return {"median_ms": med, "min_ms": lo, "max_ms": hi}


def phase_timing_multi_device(params, models: dict, device) -> dict:
    """Repeats, in turns: ms per chunk-step at B_MAIN, 2 shards of the card
    against unsharded, for v3.1 and v4; _tick at TICK_SLOTS slots sharded
    and unsharded; the v3.1 StreamRunner.step (the device guard and the
    `forward_fused` zone, no profile active) against forward_fused called
    alone."""
    import torch

    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.engine.shard import ShardedStreamRunner
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused
    from vadc_tpu_torch.server import VadServer

    out = {}
    two = [device, device]
    for family, p, chunk in (("v3", params, CHUNK), ("v4", models["v4"][1], V4_CHUNK)):
        x = torch.from_numpy(speech_chunks(B_MAIN, chunk, seed=SEED + 1200)).to(device)
        sharded, plain = ShardedStreamRunner(family, p, two), StreamRunner(family, p, device=device)
        s_state, p_state = sharded.init_state(B_MAIN), plain.init_state(B_MAIN)
        times = {"2 shards": [], "unsharded": []}
        for _ in range(MULTI_REPEATS):
            a, b = cuda_ms_pair(lambda: sharded.step(x, s_state), lambda: plain.step(x, p_state),
                                iters=20)
            times["2 shards"].append(a)
            times["unsharded"].append(b)
        for kind, t in times.items():
            out[f"{family} step, {kind}"] = spread(f"{family} step B={B_MAIN}, {kind}", t)
    batch = np.clip(speech_chunks(TICK_SLOTS, CHUNK, seed=SEED + 600) * 32768,
                    -32768, 32767).astype(np.int16)
    on, off = np.ones(TICK_SLOTS, bool), np.zeros(TICK_SLOTS, bool)
    servers = {kind: VadServer(port=0, max_streams=TICK_SLOTS, model=str(DEFAULT_WEIGHTS),
                               devices=devs) for kind, devs in (("2 shards", two),
                                                                 ("unsharded", [device]))}
    try:
        times = {kind: [] for kind in servers}
        for _ in range(MULTI_REPEATS):
            a, b = cuda_ms_pair(lambda: servers["2 shards"]._tick(batch, on, off),
                                lambda: servers["unsharded"]._tick(batch, on, off), iters=20)
            times["2 shards"].append(a)
            times["unsharded"].append(b)
        for kind, t in times.items():
            out[f"_tick, {kind}"] = spread(f"server _tick N={TICK_SLOTS}, {kind}", t)
    finally:
        for srv in servers.values():
            srv.pool.close()
    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(B_MAIN)
    x = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 1300)).to(device)
    times = {"StreamRunner.step": [], "forward_fused alone": []}
    for _ in range(MULTI_REPEATS):
        a, b = cuda_ms_pair(lambda: runner.step(x, state),
                            lambda: forward_fused(params, x, state.h, state.c, hn=state.h,
                                                  cn=state.c), iters=50)
        times["StreamRunner.step"].append(a)
        times["forward_fused alone"].append(b)
    for kind, t in times.items():
        out[f"v3 {kind}"] = spread(f"v3.1 {kind} B={B_MAIN} (zones imported, no profile)", t)
    log(f"multi-device timings on {nvidia_smi()}")
    return out


def phase_multi_device(params, models: dict, device, server_lines: list, v5_lines: list,
                       totals: dict) -> dict:
    """Stream sharding on the card: two shards of it (and distinct cards
    where there are two or more) against the unsharded paths, the dry run
    of 2 processes x 2 devices, a trace, and the phase's timings."""
    import torch

    def runners_on(devices: list) -> None:
        sharded_vs_unsharded("v3", params, devices, CHUNK, SEED + 1000, totals,
                             scan_chunks=SCAN_CHUNKS)
        sharded_vs_unsharded("v4", models["v4"][1], devices, V4_CHUNK, SEED + 1001, totals)
        sharded_vs_unsharded("v5", models["v5"][1], devices, V5_CHUNK, SEED + 1002, totals,
                             scan_chunks=SCAN_CHUNKS)

    two = [device, device]
    runners_on(two)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        paths, _ = write_corpus(root)
        batch_cli_sharded(root, paths, two, totals)
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if len(cards) >= 2:
            batch_cli_sharded(root, paths, None, totals)
    server_sharded(device, two, server_lines, totals)
    server_sharded_v5(device, two, v5_lines, totals)
    dryrun_on_the_card()
    if len(cards) >= 2:
        pair = cards[:2]
        runners_on(pair)
        server_sharded(device, pair, server_lines, totals)
        server_sharded_v5(device, pair, v5_lines, totals)
        on_second_card(params, pair)
    else:
        log(f"multi-device: {len(cards)} card visible; the checks over distinct cards and the "
            "cuda:1 device-guard check were skipped for want of a second card")
    trace_names_the_kernel(params, device)
    return phase_timing_multi_device(params, models, device)


def on_second_card(params, cards: list) -> None:
    """A v3.1 step and scan on cuda:1, launched while cuda:0 is current,
    give the bits of the same on cuda:0 (the runners' device guard)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner

    x = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 1004))
    out = []
    for dev in cards:
        torch.cuda.set_device(cards[0])
        runner = StreamRunner("v3", params, device=dev)
        state = runner.init_state(B_MAIN)
        probs, _ = runner.step(x, state)
        probs2, _ = runner.scan(x.reshape(B_MAIN // 8, 8, CHUNK), runner.init_state(B_MAIN // 8))
        torch.cuda.synchronize(dev)
        out.append([t.cpu() for t in (probs, state.h, state.c, probs2)])
    require(same_bits(*out), "a step on cuda:1 differs from the same step on cuda:0")
    log("device guard: a v3.1 step and scan on cuda:1, launched under cuda:0, give cuda:0's bits")


def percentile_ms(seconds: list, q: float) -> float:
    return float(np.percentile(np.array(seconds) * 1e3, q)) if seconds else float("nan")


def phase_timing_checkpoint(device) -> dict:
    """save_checkpoint and restore_checkpoint of a TICK_SLOTS-slot v3.1
    server on the card, wall time (file I/O to a temporary directory
    included); then OVERLAP_TICKS ticks with every slot active (_process:
    the tick, the FSM feed) while another thread saves checkpoints back to
    back with 20 ms gaps: the p50/p99 of the ticks that overlap a save
    against those that do not."""
    import threading

    import torch

    from vadc_tpu_torch.server import VadServer, _Gathered

    srv = VadServer(port=0, max_streams=TICK_SLOTS, device=device)
    other = VadServer(port=0, max_streams=TICK_SLOTS, device=device)
    try:
        rng = np.random.default_rng(SEED + 700)
        for t in (srv.state.h, srv.state.c):
            t.copy_(torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(np.float32)))
        srv.fsm.chunk_index[:] = rng.integers(1, 10**6, size=TICK_SLOTS)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "server.ckpt"
            saves, restores = [], []
            for _ in range(10):
                t0 = time.perf_counter()
                srv.save_checkpoint(path)
                saves.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                other.restore_checkpoint(path)
                torch.cuda.synchronize()
                restores.append(time.perf_counter() - t0)
            require(torch.equal(other.state.h, srv.state.h)
                    and torch.equal(other.state.c, srv.state.c),
                    "restore at 2048 slots: the state differs")
            nbytes = path.stat().st_size
            batch = to_s16(speech_chunks(TICK_SLOTS, srv.chunk, seed=SEED + 600))
            g = _Gathered(batch, np.ones(TICK_SLOTS, bool), TICK_SLOTS, None, None,
                          np.zeros(TICK_SLOTS, bool))
            for _ in range(10):
                srv._process(g)
            ticks, windows = [], []
            done = threading.Event()

            def saver():
                while not done.is_set():
                    t0 = time.perf_counter()
                    srv.save_checkpoint(path)
                    windows.append((t0, time.perf_counter()))
                    time.sleep(0.02)

            thread = threading.Thread(target=saver, daemon=True)
            thread.start()
            for _ in range(OVERLAP_TICKS):
                t0 = time.perf_counter()
                srv._process(g)
                ticks.append((t0, time.perf_counter()))
            done.set()
            thread.join(timeout=60)
    finally:
        srv.pool.close()
        other.pool.close()
    over = [b - a for a, b in ticks if any(s < b and a < e for s, e in windows)]
    clear = [b - a for a, b in ticks if not any(s < b and a < e for s, e in windows)]
    out = {"save_ms": percentile_ms(saves, 50), "restore_ms": percentile_ms(restores, 50),
           "bytes": nbytes, "tick_p50_overlap_ms": percentile_ms(over, 50),
           "tick_p99_overlap_ms": percentile_ms(over, 99),
           "tick_p50_clear_ms": percentile_ms(clear, 50),
           "tick_p99_clear_ms": percentile_ms(clear, 99), "ticks_overlap": len(over),
           "ticks_clear": len(clear), "saves_beside_ticks": len(windows),
           "save_beside_ticks_ms": percentile_ms([e - s for s, e in windows], 50)}
    log(f"time checkpoint v3.1 {TICK_SLOTS} slots ({nbytes} bytes): save_checkpoint median "
        f"{out['save_ms']:.3f} ms (min {1e3 * min(saves):.3f}, max {1e3 * max(saves):.3f}), "
        f"restore_checkpoint median {out['restore_ms']:.3f} ms (min {1e3 * min(restores):.3f}, max "
        f"{1e3 * max(restores):.3f}), 10 each, wall time, file I/O included")
    log(f"time ticks beside saves, {TICK_SLOTS} slots all active: {len(over)} ticks overlapping "
        f"one of {len(windows)} saves (median save {out['save_beside_ticks_ms']:.3f} ms): p50 "
        f"{out['tick_p50_overlap_ms']:.4f} ms, p99 {out['tick_p99_overlap_ms']:.4f} ms; "
        f"{len(clear)} ticks overlapping none: p50 {out['tick_p50_clear_ms']:.4f} ms, p99 "
        f"{out['tick_p99_clear_ms']:.4f} ms")
    return out


def phase_timing_api(device, archives: dict) -> dict:
    """speech_probabilities on the card over API_TIMED_SECONDS of seeded
    speech, v3.1, v4 and v5: audio seconds per wall second (host clock
    around the call, which ends in the copy of the probabilities to the
    host), the median of 3 calls after one untimed call. For v4 and v5
    beside it the API's route before their slab scan: the loop of
    StreamRunner.step over the same chunks of one stream, the median of 3
    loops after one untimed loop."""
    import torch

    from vadc_tpu_torch import api

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        models = api_models(archives, Path(tmp))
        track = api_track(SR, API_TIMED_SECONDS, SEED + 960)
        for family in ("v3", "v4", "v5"):
            api.speech_probabilities(track, model=models[family], device="cuda")
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                probs = api.speech_probabilities(track, model=models[family], device="cuda")
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            out[family] = API_TIMED_SECONDS / wall
            log(f"time api.speech_probabilities {family} over {API_TIMED_SECONDS:g} s of speech: "
                f"{1e3 * wall:.2f} ms median of 3 (" + ", ".join(f"{1e3 * w:.2f}" for w in walls)
                + f"): {out[family]:.1f} audio s per wall s")
            if family == "v3":
                continue
            runner, window = api._get_runner(models[family], 1536, "faithful", "cuda")
            window = getattr(runner.module, "WINDOW_SAMPLES", window)
            padded = np.zeros(probs.size * window, np.float32)
            padded[: track.size] = track
            chunks = torch.from_numpy(padded.reshape(1, probs.size, window)).to(runner.device)

            def steps():
                state = runner.init_state(1)
                got = [runner.step(chunks[:, k], state)[0] for k in range(chunks.shape[1])]
                return torch.stack(got, dim=1).cpu()

            steps()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                steps()
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            out[f"{family} steps"] = API_TIMED_SECONDS / wall
            log(f"time the loop of StreamRunner.step {family} over the same {probs.size} chunks "
                f"(the API's route before the slab scan): {1e3 * wall:.2f} ms median of 3: "
                f"{out[f'{family} steps']:.1f} audio s per wall s")
    return out


def time_ticks(model: str, device, label: str, precision: str = "faithful") -> tuple[float, float]:
    """_tick and _tick2 of a TICK_SLOTS-slot server, every slot active, on
    seeded speech (CUDA events around host-synchronous calls: the times
    include the staging, the masked merge and the copy of the probs)."""
    from vadc_tpu_torch.server import VadServer

    srv = VadServer(port=0, max_streams=TICK_SLOTS, model=model, device=device,
                    precision=precision)
    try:
        batch = np.clip(speech_chunks(TICK_SLOTS, srv.chunk, seed=SEED + 600) * 32768,
                        -32768, 32767).astype(np.int16)
        on, off = np.ones(TICK_SLOTS, bool), np.zeros(TICK_SLOTS, bool)
        tick = cuda_ms(lambda: srv._tick(batch, on, off), iters=20)
        tick2 = cuda_ms(lambda: srv._tick2(batch, batch, on, on, off), iters=20)
        log(f"time server {label} N={TICK_SLOTS} x {srv.chunk}, all active: _tick {tick:.4f} ms, "
            f"_tick2 {tick2:.4f} ms")
    finally:
        srv.pool.close()
    return tick, tick2


def phase_timing(params, device) -> dict:
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference, forward_fused, forward_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.kernels.stft_dotmag import (
        dot_magnitude, dot_magnitude_reference, split_basis,
    )
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 200)).to(device)
    frames = F.frame(
        F.reflect_pad_last(audio, silero_v31.STFT_PAD, silero_v31.STFT_PAD), 256, silero_v31.STFT_HOP
    )
    wr, wi = split_basis(params["stft_basis"])
    feats = silero_v31.features(params, audio)
    h, c = silero_v31.init_state(B_MAIN, device)
    t = {
        "dot_magnitude": cuda_ms_pair(
            lambda: dot_magnitude(frames, wr, wi),
            lambda: dot_magnitude_reference(frames, wr, wi),
        ),
        "silero_v31_fused": cuda_ms_pair(
            lambda: forward_fused2d(params, feats, h, c),
            lambda: forward_fused2d_reference(params, feats, h, c),
        ),
    }
    t["forward_fused"] = cuda_ms_pair(
        lambda: forward_fused(params, audio, h, c),
        lambda: forward_fused_reference(params, audio, h, c),
    )
    t["encode_fused_audio"] = cuda_ms_pair(
        lambda: encode_fused_audio(params, audio),
        lambda: encode_fused_audio_reference(params, audio),
    )
    for name, (k, p) in t.items():
        log(f"time {name} B={B_MAIN}: kernel {k:.4f} ms, plain {p:.4f} ms")
    t["dot_magnitude_cublas"] = cublas_product_ms(frames, wr, wi)
    log(f"time cuBLAS fp32 product only (frames [{frames.shape[0] * frames.shape[1]}, 256] @ "
        f"[256, 258], no TF32) beside dot_magnitude: {t['dot_magnitude_cublas']:.4f} ms")
    fused_ms, two_kernels_ms = cuda_ms_pair(
        lambda: forward_fused(params, audio, h, c),
        lambda: forward_fused2d(params, silero_v31.features(params, audio), h, c),
    )
    log(f"time forward_fused B={B_MAIN}x{CHUNK}: {fused_ms:.4f} ms; features (dot_magnitude "
        f"and the torch front-end) + forward_fused2d: {two_kernels_ms:.4f} ms")
    front_ms = cuda_ms(lambda: silero_v31.features(params, audio))
    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(B_MAIN)
    hb, cb = silero_v31.init_state(B_MAIN, device)
    step_ms, before_ms = cuda_ms_pair(
        lambda: runner.step(audio, state),
        # the two-kernel step: features, then forward_fused2d, the state in place
        lambda: forward_fused2d(params, silero_v31.features(params, audio), hb, cb, hn=hb, cn=cb),
    )
    _, plain_ms = cuda_ms_pair(
        lambda: runner.step(audio, state),
        lambda: silero_v31.forward_reference(params, audio, h, c),
    )
    log(f"front-end (reflect pad, unfold, dot_magnitude kernel, adaptive norm) "
        f"B={B_MAIN}: {front_ms:.4f} ms")
    log(f"ms per chunk-step v3.1 B={B_MAIN}x{CHUNK}: forward_fused {step_ms:.4f} ms, before "
        f"(features + forward_fused2d) {before_ms:.4f} ms, plain {plain_ms:.4f} ms; realtime "
        f"streams at the kernel rate: {B_MAIN * (CHUNK / SR) / (step_ms / 1000):.0f}")
    return t


def variant_of(batch: int, steps: int) -> str:
    """The variant of the recurrent kernels that the wrappers run at a shape."""
    from vadc_tpu_torch.kernels.lstm import use_resident

    return "resident weights" if use_resident(batch, steps) else "streaming weights"


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations over
    the fp32 peak and the bytes (each input read once, each output written
    once) over the memory rate; and which of the two it is."""
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def spectrum_flops(rows: int, n_fft: int = 256, bins: int = 129) -> float:
    """rows x n_fft frames against the real and the imaginary basis, then
    two squares, a sum and a root per bin."""
    return rows * (2 * 2 * n_fft * bins + 4 * bins)


def cublas_product_ms(frames, wr, wi) -> float:
    """A yardstick of the spectrum's product alone, not of the same
    function: cuBLAS's fp32 torch.matmul of the contiguous frames [rows,
    n_fft] with both bases [n_fft, 2 * cutoff], TF32 off (no magnitude; the
    product is written out). Timed here only; the port never calls it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = frames.reshape(-1, frames.shape[-1]).contiguous()
    both = torch.cat([wr, wi], dim=1)
    return cuda_ms(lambda: torch.matmul(rows, both))


def v31_encoder_flops(seq0: int) -> float:
    """One stream's four encoder stages, 2 flops per multiply-add, from the
    stages' widths and frame counts (the norms and the softmax not counted)."""
    macs, frames = 0, seq0
    for (cin, cout), stride in zip(((129, 16), (16, 32), (32, 32), (32, 64)), (2, 2, 1, 1)):
        out_frames = -(-frames // stride)
        macs += frames * cin * 5 + frames * cin * cout * (2 if cin != cout else 1)  # dw, pw, proj
        macs += frames * cout * 3 * cout + 2 * frames * frames * cout  # qkv, scores, mix
        macs += 3 * frames * cout * cout + out_frames * cout * cout  # out proj, ff, 1x1 conv
        frames = out_frames
    return 2.0 * macs


def lstm_flops(steps: int, layers: int, hidden: int) -> float:
    """steps x layers gate products of [2H] x [2H, 4H], 2 flops a
    multiply-add (the gates' elementwise work not counted)."""
    return 2.0 * steps * layers * 2 * hidden * 4 * hidden


def cudnn_lstm(w, b):
    """torch.nn.LSTM (cuDNN) with the fused [L, 4H, 2H] weight split into
    weight_ih and weight_hh (gate order i, f, g, o in both) and the
    pre-summed bias as bias_ih: the library call that computes the LSTM
    kernels' function. Timed here only; nothing on a path calls it."""
    import torch

    layers, hidden = w.shape[0], w.shape[2] // 2
    lstm = torch.nn.LSTM(hidden, hidden, num_layers=layers, batch_first=True).to(w.device)
    with torch.no_grad():
        for layer in range(layers):
            getattr(lstm, f"weight_ih_l{layer}").copy_(w[layer][:, :hidden])
            getattr(lstm, f"weight_hh_l{layer}").copy_(w[layer][:, hidden:])
            getattr(lstm, f"bias_ih_l{layer}").copy_(b[layer])
            getattr(lstm, f"bias_hh_l{layer}").zero_()
    lstm.flatten_parameters()
    return lstm


def time_cudnn_lstm(label: str, w, b, x, h, c, y_ref, iters: int) -> float:
    """ms of one torch.nn.LSTM call on the kernel's inputs; its output is
    held to the plain version's (1e-3: another order of sums, cuDNN's own
    activations) so the two are the same function."""
    import torch

    lstm = cudnn_lstm(w, b)
    with torch.no_grad():
        y, _ = lstm(x, (h, c))
        torch.cuda.synchronize()
        diff = max_abs(y, y_ref)
        require(diff <= 1e-3, f"torch.nn.LSTM {label}: differs from the plain version by {diff:.3e}")
        ms = cuda_ms(lambda: lstm(x, (h, c)), iters=iters)
    log(f"time torch.nn.LSTM (cuDNN) {label}: {ms:.4f} ms (max abs diff from the plain version "
        f"{diff:.3e})")
    return ms


def cudnn_bf16_lstm_ms(w, b, x, h, c) -> float:
    """ms of one torch.nn.LSTM call (cuDNN) with bf16 weights, inputs and
    state at the shape of x: a yardstick beside the bf16 tiers' LSTMs, not
    the same function (its state and its output are bf16; the tiers keep
    them fp32). Timed here only; nothing on a path calls it."""
    import torch

    lstm = cudnn_lstm(w, b).to(torch.bfloat16)
    xb, hb, cb = (t.to(torch.bfloat16).contiguous() for t in (x, h, c))
    with torch.no_grad():
        return cuda_ms(lambda: lstm(xb, (hb, cb)), iters=20)


def phase_timing_slab(params, device, corpus: dict) -> dict:
    """The slab route: StreamRunner.scan by slab against the loop of steps,
    encode_fused_audio and lstm_decoder_fused alone (kernel, plain,
    torch.nn.LSTM), features and encode_fused (the route's front half until
    encode_fused_audio took it) beside them, the CLI's window against 96
    launches of forward_fused2d."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import transposed_weight_of
    from vadc_tpu_torch.kernels.lstm_decoder import (
        lstm_decoder_fused, lstm_decoder_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        encode_fused, encode_fused_reference, forward_fused2d,
    )
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F

    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    wt = transposed_weight_of(params)
    runner = StreamRunner("v3", params, device=device)
    out = {}
    for n_streams, n_chunks in ((B_MAIN, SCAN_CHUNKS), (SLAB_CHUNKS, SLAB_CHUNKS)):
        shape = f"B={n_streams} x K={n_chunks}"
        iters = 10
        chunks = torch.from_numpy(
            speech_chunks(n_streams * n_chunks, CHUNK, seed=SEED + 900)
        ).to(device).reshape(n_streams, n_chunks, CHUNK)
        state, state2 = runner.init_state(n_streams), runner.init_state(n_streams)

        def steps():
            for k in range(n_chunks):
                runner.step(chunks[:, k], state2)

        slab_ms, steps_ms = cuda_ms_pair(lambda: runner.scan(chunks, state), steps, iters=iters)
        log(f"time StreamRunner.scan v3.1 {shape} x {CHUNK}: by slab {slab_ms:.4f} ms, loop of "
            f"steps {steps_ms:.4f} ms ({slab_ms / n_chunks:.4f} vs {steps_ms / n_chunks:.4f} ms a "
            f"chunk-step)")
        flat = chunks.reshape(n_streams * n_chunks, CHUNK)
        audio_ms, audio_plain_ms = cuda_ms_pair(
            lambda: encode_fused_audio(params, flat),
            lambda: encode_fused_audio_reference(params, flat), iters=iters)
        feats = silero_v31.features(params, flat)
        front_ms = cuda_ms(lambda: silero_v31.features(params, flat), iters=iters)
        enc_ms, enc_plain_ms = cuda_ms_pair(lambda: encode_fused(params, feats),
                                            lambda: encode_fused_reference(params, feats),
                                            iters=iters)
        x = encode_fused(params, feats).reshape(n_streams, n_chunks, -1, 64)
        h, c = state.h.clone(), state.c.clone()
        tail_ms, tail_plain_ms = cuda_ms_pair(
            lambda: lstm_decoder_fused(x, h, c, *args, wt=wt),
            lambda: lstm_decoder_fused_reference(x, h, c, *args), iters=iters)
        seq = x.reshape(n_streams, -1, 64)  # the chunks' frames as one sequence a stream
        y_ref, _, _ = F.lstm(seq, h, c, args[0], args[1])
        lib_ms = time_cudnn_lstm(f"v3.1 {shape} x T={x.shape[2]}", args[0], args[1], seq, h, c,
                                 y_ref, iters)
        counted = lstm_decoder_fused.launches
        lstm_decoder_fused(x, h, c, *args, wt=wt)
        per_call = lstm_decoder_fused.launches - counted
        log(f"time slab parts {shape}: encode_fused_audio {audio_ms:.4f} ms (plain "
            f"{audio_plain_ms:.4f}); off the route: features (dot_magnitude and the torch "
            f"front-end) {front_ms:.4f} ms, encode_fused {enc_ms:.4f} ms (plain "
            f"{enc_plain_ms:.4f}); lstm_decoder_fused {tail_ms:.4f} ms in {per_call} kernels a call (plain "
            f"{tail_plain_ms:.4f}, torch.nn.LSTM {lib_ms:.4f})")
        out[(n_streams, n_chunks)] = {
            "lstm_decoder_fused": (tail_ms, tail_plain_ms, lib_ms, tuple(x.shape), per_call),
            "encode_fused": (enc_ms, enc_plain_ms), "slab_ms": slab_ms, "steps_ms": steps_ms,
            "encode_fused_audio": (audio_ms, audio_plain_ms), "rows": flat.shape[0],
        }
    # the CLI's window: 96 chunks of one stream
    window = torch.from_numpy(speech_chunks(CLI_WINDOW, CHUNK, seed=SEED + 901)).to(device)
    h, c = silero_v31.init_state(1, device)

    def per_chunk():
        feats = silero_v31.features(params, window)
        hn, cn = h.clone(), c.clone()
        for i in range(CLI_WINDOW):
            forward_fused2d(params, feats[i : i + 1], hn, cn, hn=hn, cn=cn)

    new_ms, old_ms = cuda_ms_pair(lambda: silero_v31.forward_minibatched(params, window, h, c),
                                  per_chunk, iters=10)
    x1 = encode_fused(params, silero_v31.features(params, window)).reshape(1, CLI_WINDOW, -1, 64)
    tail1_ms, tail1_plain_ms = cuda_ms_pair(
        lambda: lstm_decoder_fused(x1, h, c, *args, wt=wt),
        lambda: lstm_decoder_fused_reference(x1, h, c, *args), iters=5)
    seq1 = x1.reshape(1, -1, 64)
    lib1_ms = time_cudnn_lstm(f"v3.1 B=1 x T={seq1.shape[1]}", args[0], args[1], seq1, h, c,
                              F.lstm(seq1, h, c, args[0], args[1])[0], 10)
    log(f"time CLI window v3.1 (forward_minibatched, N={CLI_WINDOW} x {CHUNK}): slab route "
        f"{new_ms:.4f} ms, {CLI_WINDOW} launches of forward_fused2d {old_ms:.4f} ms; "
        f"lstm_decoder_fused B=1 x K={CLI_WINDOW} {tail1_ms:.4f} ms (plain {tail1_plain_ms:.4f}, "
        f"torch.nn.LSTM {lib1_ms:.4f})")
    log(f"batch CLI on the card: {corpus['audio_s']:.1f} s of audio in {corpus['wall_s']:.3f} s, "
        f"{corpus['audio_s'] / corpus['wall_s']:.1f} audio seconds per wall second "
        f"({CORPUS_FILES} files, slabs of {SLAB_CHUNKS} chunks)")
    return out


def phase_timing_v45(models: dict, device) -> dict:
    """Each new kernel against its plain version at the main paths' shapes,
    and ms per chunk-step at B_MAIN for v4 and v5, kernels vs plain."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import lstm_fused, lstm_fused_reference, transposed_weight_of
    from vadc_tpu_torch.kernels.stft_mag import (
        split_basis_of, stft_magnitude, stft_magnitude_reference,
    )
    from vadc_tpu_torch.nn import functional as F

    t = {"stft_magnitude_at": {}}
    # stft_magnitude at every family geometry at B_MAIN and at the v4 CLI
    # window, each against its own bound (frames counted from the output)
    for family, (module, params) in models.items():
        samples, pad = stft_geometry(family, module)
        audio = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + 400)).to(device)
        wr, wi = split_basis_of(params)
        cases = [(f"{family} B={B_MAIN} x {samples}", audio)]
        if family == "v4":
            cases.append((f"v4 CLI window {CLI_WINDOW} x {samples}", audio[:CLI_WINDOW]))
        for label, chunks in cases:
            spect = stft_magnitude(chunks, wr, wi, **pad)
            ms, plain_ms = cuda_ms_pair(lambda: stft_magnitude(chunks, wr, wi, **pad),
                                        lambda: stft_magnitude_reference(chunks, wr, wi, **pad))
            n_fft, bins = wr.shape
            rows = spect.shape[0] * spect.shape[1]
            bound, by = bound_ms(spectrum_flops(rows, n_fft, bins),
                                 4 * (chunks.numel() + 2 * n_fft * bins + spect.numel()))
            t["stft_magnitude_at"][label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                             "bound_by": by, "bound_share": bound / ms,
                                             "frames": spect.shape[1]}
            log(f"time stft_magnitude {label} ({spect.shape[1]} frames): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f} %)")
            if label == f"v4 B={B_MAIN} x {samples}":
                t["stft_magnitude"] = (ms, plain_ms)
                t["stft_magnitude_bound"] = (bound, by)
                frames = F.frame(F.reflect_pad_last(chunks, pad["pad_left"], pad["pad_right"]),
                                 n_fft, pad["hop"])
                t["stft_magnitude_cublas"] = cublas_product_ms(frames, wr, wi)
                log(f"time cuBLAS fp32 product only (frames [{rows}, {n_fft}] @ [{n_fft}, "
                    f"{2 * bins}], no TF32) beside stft_magnitude v4: "
                    f"{t['stft_magnitude_cublas']:.4f} ms")

    for family, chunk in (("v4", V4_CHUNK), ("v5", V5_CHUNK)):
        module, params = models[family]
        ctx = getattr(module, "CONTEXT_SAMPLES", 0)
        audio = torch.from_numpy(speech_chunks(B_MAIN, ctx + chunk, seed=SEED + 400)).to(device)
        w, b, wt = params["lstm_w"], params["lstm_b"], transposed_weight_of(params)
        x, h, c = lstm_inputs(module, params, audio, B_MAIN, device)
        lstm = cuda_ms_pair(lambda: lstm_fused(x, h, c, w, b, wt=wt),
                            lambda: lstm_fused_reference(x, h, c, w, b))
        counted = lstm_fused.launches
        lstm_fused(x, h, c, w, b, wt=wt)
        per_call = lstm_fused.launches - counted
        log(f"time lstm_fused {family} B={B_MAIN} x T={x.shape[1]}: kernel {lstm[0]:.4f} ms in "
            f"{per_call} kernels a call, plain {lstm[1]:.4f} ms")
        lstm_lib = time_cudnn_lstm(f"{family} B={B_MAIN} x T={x.shape[1]}", w, b, x, h, c,
                                   lstm_fused_reference(x, h, c, w, b)[0], 50)
        window = torch.from_numpy(speech_chunks(CLI_WINDOW, ctx + chunk, seed=SEED + 401)).to(device)
        x1, h1, c1 = lstm_inputs(module, params, window, 1, device)
        long = cuda_ms_pair(lambda: lstm_fused(x1, h1, c1, w, b, wt=wt),
                            lambda: lstm_fused_reference(x1, h1, c1, w, b), iters=5)
        log(f"time lstm_fused {family} B=1 x T={x1.shape[1]} (one CLI window): kernel "
            f"{long[0]:.4f} ms, plain {long[1]:.4f} ms")
        time_cudnn_lstm(f"{family} B=1 x T={x1.shape[1]}", w, b, x1, h1, c1,
                        lstm_fused_reference(x1, h1, c1, w, b)[0], 10)
        runner = StreamRunner(family, params, device=device)
        state = runner.init_state(B_MAIN)
        steps = audio[:, ctx:].contiguous()
        h0, c0 = module.init_state(B_MAIN, device)
        step_ms, plain_ms = cuda_ms_pair(
            lambda: runner.step(steps, state),
            lambda: module.forward_reference(params, audio, h0, c0),
        )
        log(f"ms per chunk-step {family} B={B_MAIN}x{chunk}: kernels {step_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; realtime streams at the kernel rate: "
            f"{B_MAIN * (chunk / SR) / (step_ms / 1000):.0f}")
        if family == "v4":  # the JSON line's shape: the v4 16 kHz step's
            t["lstm_fused"] = (*lstm, lstm_lib, tuple(x.shape), per_call)
    return t


def phase_timing_slabs_v45(models: dict, device) -> None:
    """StreamRunner.scan of each v4/v5 family against the loop of its
    steps on the slabs of SLABS_V45 at every tier, in turns in one call
    (cuda_ms_pair), and the scan's two stages alone (its encoder's pieces,
    its lstm_fused call); then at faithful the scan's peak device memory over
    B_MAIN streams x SCAN_CHUNKS and x SLAB_CHUNKS chunks
    (torch.cuda.max_memory_allocated, above what was allocated before the
    call: the slab and the state)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.models import slab

    for i, (family, (module, params)) in enumerate(models.items()):
        chunk = V45_RATES[family][1]
        for n_streams, n_chunks in SLABS_V45:
            x = torch.from_numpy(speech_chunks(n_streams * n_chunks, chunk, seed=SEED + 1500 + i))
            x = x.to(device).reshape(n_streams, n_chunks, chunk)
            ctx = (module.init_context(n_streams, device) if hasattr(module, "init_context")
                   else None)
            for tier in ("faithful", *TIERS):
                runner = StreamRunner(family, params, device=device, precision=tier)
                state, loop = runner.init_state(n_streams), runner.init_state(n_streams)

                def steps():
                    for k in range(n_chunks):
                        runner.step(x[:, k], loop)

                iters = 5 if n_chunks <= SCAN_CHUNKS else 2
                scan_ms, steps_ms = cuda_ms_pair(lambda: runner.scan(x, state), steps, iters=iters,
                                                 warmup=1)
                # the scan's two stages alone: the encoder's pieces, one lstm_fused call
                t = runner.tier
                rows = x if ctx is None else module.attach_contexts(x, ctx)[0]
                def encode(a):
                    return module.encode(params, a, tier=t)

                feats = slab.encode_slab(encode, rows)
                enc_ms = cuda_ms(lambda: slab.encode_slab(encode, rows), iters=iters, warmup=1)
                seq = feats.reshape(n_streams, -1, feats.shape[-1])
                h, c = module.init_state(n_streams, device)
                lstm_ms = cuda_ms(lambda: lstm_fused(seq, h, c, params["lstm_w"], params["lstm_b"],
                                                     wt=weight_of(params, t), tier=t),
                                  iters=iters, warmup=1)
                log(f"time slab {family} [{tier}] {n_streams}x{n_chunks} x {chunk}: scan "
                    f"{scan_ms:.4f} ms, loop of steps {steps_ms:.4f} ms "
                    f"({steps_ms / scan_ms:.2f}x; "
                    f"{scan_ms / n_chunks:.4f} vs {steps_ms / n_chunks:.4f} ms a chunk-step); the "
                    f"scan's encoder pieces alone {enc_ms:.4f} ms, its lstm_fused call alone "
                    f"(T={seq.shape[1]}) {lstm_ms:.4f} ms")
        runner = StreamRunner(family, params, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED + 1510 + i)
        for n_chunks in (SCAN_CHUNKS, SLAB_CHUNKS):
            # the memory does not depend on the values: seeded noise on the card
            x = 0.1 * torch.randn(B_MAIN, n_chunks, chunk, generator=gen, device=device)
            state = runner.init_state(B_MAIN)
            runner.scan(x, state)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            runner.scan(x, state)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
            log(f"memory slab {family} {B_MAIN}x{n_chunks} x {chunk}: the scan's peak "
                f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB allocated before it (the "
                f"slab {x.numel() * 4 / 2**20:.1f} MiB)")
    log(f"v4/v5 slab timings on {nvidia_smi()}")


def phase_timing_variants(models: dict, params, device) -> None:
    """The crossover of lstm_fused's two variants: each timed at B = 1, 64,
    2048 over a range of steps on seeded random inputs (the times do not
    depend on the values) at the v4 and v5 shapes, and lstm_decoder_fused
    (its one entry, the resident kernels) at T=7 frames a chunk, with
    torch.nn.LSTM beside them. kernels/lstm.py's RESIDENT_MIN_STEPS is read
    from this."""
    import torch

    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.kernels import lstm_decoder as KD

    gen = torch.Generator(device=device).manual_seed(SEED + 1000)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    def line(label, times, lib_ms, rule):
        log(f"time variants {label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f", torch.nn.LSTM {lib_ms:.4f} ms; the wrapper runs: {rule}")

    for family, steps in (("v4", (1, 3, 6, 12, 24, 96, 288)), ("v5", (1, 2, 3, 4, 8, 16, 96))):
        p = models[family][1]
        w, b, wt = p["lstm_w"], p["lstm_b"], KL.transposed_weight_of(p)
        layers, hidden = w.shape[0], w.shape[2] // 2
        lib = cudnn_lstm(w, b)
        for batch in (1, 64, B_MAIN):
            for seq in steps:
                x, h, c = rand(batch, seq, hidden), rand(layers, batch, hidden, scale=0.3), \
                    rand(layers, batch, hidden)
                y, hn, cn = torch.empty_like(x), torch.empty_like(h), torch.empty_like(c)
                runs = {"streaming": lambda: KL._launch_streaming(x, h, c, wt, b, y, hn, cn),
                        "resident": lambda: KL._launch_resident(x, h, c, wt, b, y, hn, cn)}
                times = {k: cuda_ms(fn, iters=10, warmup=2) for k, fn in runs.items()}
                with torch.no_grad():
                    lib_ms = cuda_ms(lambda: lib(x, (h, c)), iters=10, warmup=2)
                line(f"lstm_fused {family} B={batch} x T={seq}", times, lib_ms,
                     variant_of(batch, seq))
    w, b, dec_w, dec_b = (params[k] for k in ("lstm_w", "lstm_b", "dec_w", "dec_b"))
    wt = KL.transposed_weight_of(params)
    lib = cudnn_lstm(w, b)
    for batch in (1, 64, B_MAIN):
        for chunks in (1, 2, 4, 8, 64):
            if batch * chunks > B_MAIN * 8:
                continue
            x, h, c = rand(batch, chunks, 7, 64), rand(2, batch, 64, scale=0.3), rand(2, batch, 64)
            out = (torch.empty(batch, chunks, device=device), torch.empty_like(h),
                   torch.empty_like(c))
            rest = (wt, b, dec_w, dec_b, *out)
            times = {"resident": cuda_ms(lambda: KD._launch(x, h, c, *rest), iters=10, warmup=2)}
            seq = x.reshape(batch, chunks * 7, 64)
            with torch.no_grad():
                lib_ms = cuda_ms(lambda: lib(seq, (h, c)), iters=10, warmup=2)
            line(f"lstm_decoder_fused B={batch} x K={chunks} x T=7", times, lib_ms,
                 "resident weights (its one kernel)")


# ---- the bf16 tiers (balanced, fast, turbo) of the v3.1 path -----------------


def tier_digests(params, device) -> dict:
    """Digests of the tier instances of forward_fused (B=2048 x 1536 and a
    ragged B=37 x 512 of speech, a random carried state) and forward_fused2d
    (B=2048 x 25 random features): name[tier] -> digest."""
    import torch

    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    out = {}
    for tier in TIERS:
        rng = np.random.default_rng(SEED + 7)
        feats = t(2.0 * rng.normal(size=(B_MAIN, 25, 129)))
        h = t(0.5 * rng.normal(size=(2, B_MAIN, 64)))
        c = t(3.0 * rng.normal(size=(2, B_MAIN, 64)))
        out[f"forward_fused2d[{tier}]"] = digest(*forward_fused2d(params, feats, h, c, tier=tier))
        rng = np.random.default_rng(SEED + 9)
        for name, b, samples in (("forward_fused", B_MAIN, CHUNK), ("forward_fused_ragged", 37, 512)):
            chunks = t(speech_chunks(b, samples, seed=SEED + 10))
            h = t(0.5 * rng.normal(size=(2, b, 64)))
            c = t(3.0 * rng.normal(size=(2, b, 64)))
            out[f"{name}[{tier}]"] = digest(*forward_fused(params, chunks, h, c, tier=tier))
    return out


def check_tier(params, audio, tier: str, label: str) -> dict:
    """Each tier instance of the v3.1 path's kernels against its plain
    version at the tier on the card, from a carried state, held to
    kernels/tier_check.py: forward_fused and encode_fused_audio against
    plain versions fed the step kernel's own spectrum (its rounding drops
    out; the spectrum is held bit for bit to dot_magnitude's instance, and
    that to its plain version), lstm_decoder_fused on encode_fused_audio's
    rows bit for bit against forward_fused, forward_fused2d on features at
    the tier (and encode_fused + lstm_decoder_fused bit for bit against
    it), lstm_decoder_fused over K chunks, dot_magnitude. At B=2048 x 1536,
    the control: the faithful instances against the same plain versions
    must break the limits (tier_check says where no check of the outputs
    can). Returns name -> the largest difference."""
    import torch

    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.lstm_decoder import (
        lstm_decoder_fused, lstm_decoder_fused_reference, weight_of,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference, forward_fused, forward_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import (
        encode_fused, forward_fused2d, forward_fused2d_reference,
    )
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, dot_magnitude_reference, split_basis
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import FAITHFUL, tier_of

    t = tier_of(tier)
    b, samples = audio.shape
    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    wt = weight_of(params, t)
    h0, c0 = silero_v31.init_state(b, audio.device)
    _, h, c = forward_fused_reference(params, audio.flip(0).contiguous(), h0, c0, t)
    spect = torch.empty(b, samples // 64 + 1, 129, device=audio.device)
    wr, wi = split_basis(params["stft_basis"])
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    k = 4 if b % 4 == 0 else 1  # K chunks a stream of b / K streams
    hk, ck = h[:, : b // k].contiguous(), c[:, : b // k].contiguous()
    feats = silero_v31.features(params, audio, t)

    def run(at, wt_at, x=None):
        """The instances of tier `at` on this input (lstm_decoder_fused on
        `x`, else on this encode_fused_audio's rows): kernel -> output."""
        step = forward_fused(params, audio, h, c, spectrum=spect if at is t else None, tier=at)
        enc = encode_fused_audio(params, audio, at)
        x = enc.reshape(b // k, k, enc.shape[1], 64) if x is None else x
        return {"forward_fused": step, "encode_fused_audio": enc,
                "forward_fused2d": forward_fused2d(params, feats, h, c, tier=at),
                "lstm_decoder_fused": lstm_decoder_fused(x, hk, ck, *args, wt=wt_at, tier=at),
                "dot_magnitude": dot_magnitude(frames, wr, wi, at)}

    got = run(t, wt)
    enc = got["encode_fused_audio"]
    x = enc.reshape(b // k, k, enc.shape[1], 64)
    plain = {"forward_fused": forward_fused_reference(params, audio, h, c, t, spectrum=spect),
             "encode_fused_audio": encode_fused_audio_reference(params, audio, t, spectrum=spect),
             "forward_fused2d": forward_fused2d_reference(params, feats, h, c, t),
             "lstm_decoder_fused": lstm_decoder_fused_reference(x, hk, ck, *args, t),
             "dot_magnitude": dot_magnitude_reference(frames, wr, wi, t)}
    split = lstm_decoder_fused(enc[:, None], h, c, *args, wt=wt, tier=t)
    split2d = lstm_decoder_fused(encode_fused(params, feats, t)[:, None], h, c, *args, wt=wt, tier=t)
    n = min(RAGGED_STREAMS, b // k)
    part = lstm_decoder_fused(x[:n].contiguous(), hk[:, :n].contiguous(), ck[:, :n].contiguous(),
                              *args, wt=wt, tier=t)
    torch.cuda.synchronize()
    for name in ("forward_fused", "forward_fused2d", "lstm_decoder_fused"):
        require(bool(torch.isfinite(got[name][0]).all()), f"{tier} {label}: {name} not finite")
    for name in ("encode_fused_audio", "dot_magnitude"):
        require(bool(torch.isfinite(got[name]).all()), f"{tier} {label}: {name} not finite")

    def errs_of(outs):
        out = {name: tier_check.state_errors(outs[name], plain[name], tier)
               for name in ("forward_fused", "forward_fused2d", "lstm_decoder_fused")}
        out["encode_fused_audio"] = {"enc": tier_check.errors(outs["encode_fused_audio"],
                                                              plain["encode_fused_audio"], tier)}
        mag = plain["dot_magnitude"]
        out["dot_magnitude"] = {"mag": tier_check.errors(outs["dot_magnitude"], mag, tier,
                                                         float(mag.abs().max()))}
        return out

    def show(errs):
        return "; ".join(f"{name} " + ", ".join(f"{o} {m:.3e}/{sh:.4f}" for o, (m, sh) in e.items())
                         for name, e in errs.items())

    errs = errs_of(got)
    broken = [msg for name, e in errs.items() for msg in tier_check.breaches(tier, name, b, e)]
    bits = {"spectrum = dot_magnitude": torch.equal(spect, got["dot_magnitude"]),
            "lstm_decoder_fused(encode_fused_audio) = forward_fused": same_bits(
                (split[0][:, 0], split[1], split[2]), got["forward_fused"]),
            "lstm_decoder_fused(encode_fused) = forward_fused2d": same_bits(
                (split2d[0][:, 0], split2d[1], split2d[2]), got["forward_fused2d"]),
            f"lstm_decoder_fused on {n} of the streams = those streams of the whole call": same_bits(
                part, (got["lstm_decoder_fused"][0][:n], got["lstm_decoder_fused"][1][:, :n],
                       got["lstm_decoder_fused"][2][:, :n]))}
    log(f"tier {tier} {label} (largest difference / share above {tier_check.TAU[tier]:g}): "
        + show(errs) + "; " + ", ".join(f"{k}: {v}" for k, v in bits.items()))
    require(not broken, f"{tier} {label}: " + "; ".join(broken))
    for what, ok in bits.items():
        require(ok, f"{tier} {label}: {what} is not bit for bit")
    if b == B_MAIN and samples == CHUNK:
        control = errs_of(run(FAITHFUL, weight_of(params, FAITHFUL), x))
        caught = {name: bool(tier_check.breaches(tier, name, b, e)) for name, e in control.items()}
        log(f"tier {tier} {label} control, the faithful instances against the plain versions "
            f"at {tier}: " + show(control) + f"; breaks the limits: {caught}")
        # the balanced body's bf16_3x products are within 2^-17 of fp32
        # ones, and the bf16_3x spectrum of an fp32 one (tier_check): there
        # the faithful instances differ in the spectrum and log1p alone
        must = (("forward_fused", "encode_fused_audio") if tier == "balanced" else
                ("forward_fused", "encode_fused_audio", "forward_fused2d", "lstm_decoder_fused")
                + (("dot_magnitude",) if t.stft == "bf16" else ()))
        require(all(caught[name] for name in must),
                f"{tier} control: the faithful instances pass the limits of {tier}: {caught}")
    return {name: max(m for m, _ in e.values()) for name, e in errs.items()}


def phase_kernels_tiers(params, device) -> dict:
    """The tier instances against their plain versions at B=2048, 1 and a
    ragged 37 (chunks of 1536 samples), and at B=2048 x 512; their digests
    logged beside TIER_DIGESTS and held to them."""
    import torch

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 300)).to(device)
    errs = {}
    for tier in TIERS:
        errs[tier] = check_tier(params, audio, tier, f"B={B_MAIN} x {CHUNK}")
        for b in (1, 37):
            check_tier(params, audio[:b], tier, f"B={b} x {CHUNK}")
        check_tier(params, audio[:, :512].contiguous(), tier, f"B={B_MAIN} x 512")
    got = tier_digests(params, device)
    log(f"tier digests: {json.dumps(got)}")
    for name, value in got.items():
        want = TIER_DIGESTS.get(name)
        require(value == want, f"{name}: digest {value} differs from {want}")
    return errs


def phase_spectrum_edges(params, models: dict, device) -> None:
    """The tensor-core spectrum at its tiles' edges, per tier: rows that are
    no multiple of 16 (B=37), the shortest v3.1 chunks (512 samples, 9
    frames) and v5 8 kHz's 65 bins (the Nyquist bin on a padded n8 tile).
    At the v3.1 geometry the step kernel's spectrum, dot_magnitude's and
    stft_magnitude's (pads 128/128, the tier's STFT operands) bit for bit,
    each against its plain version by kernels/tier_check.py; v5 8 kHz's
    stft_magnitude at each bf16 mode against its plain version."""
    import torch

    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, split_basis
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude, stft_magnitude_reference
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import tier_of

    wr, wi = split_basis(params["stft_basis"])
    module, p8 = models["v5_8k"]
    samples8, kw8 = stft_geometry("v5_8k", module)
    audio8 = torch.from_numpy(speech_chunks(37, samples8, seed=SEED + 520)).to(device)
    wr8, wi8 = split_basis_of(p8)
    for tier in TIERS:
        t = tier_of(tier)
        line = []
        for samples in (CHUNK, 512):
            audio = torch.from_numpy(speech_chunks(37, samples, seed=SEED + 521)).to(device)
            h = torch.zeros(2, 37, 64, device=device)
            spect = torch.empty(37, samples // 64 + 1, 129, device=device)
            forward_fused(params, audio, h, h.clone(), spectrum=spect, tier=t)
            mag = dot_magnitude(F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64), wr, wi, t)
            kw = dict(pad_left=128, pad_right=128, hop=64)
            got = stft_magnitude(audio, wr, wi, **kw, mode=t.stft)
            want = stft_magnitude_reference(audio, wr, wi, **kw, mode=t.stft)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            errs = {"stft_magnitude": tier_check.errors(got, want, tier, scale),
                    "dot_magnitude": tier_check.errors(mag, want, tier, scale)}
            broken = [m for k, e in errs.items() for m in tier_check.breaches(tier, k, 37, {"mag": e})]
            same = torch.equal(spect, mag) and torch.equal(got, mag)
            line.append(f"B=37 x {samples}: stft_magnitude {errs['stft_magnitude'][0]:.3e}, "
                        f"dot_magnitude {errs['dot_magnitude'][0]:.3e}, the three bit for bit: {same}")
            require(not broken, f"tier {tier} spectrum at B=37 x {samples}: " + "; ".join(broken))
            require(same, f"tier {tier} spectrum at B=37 x {samples}: the step kernel's, "
                    "dot_magnitude's and stft_magnitude's differ")
        for mode in sorted({stft_mode_of("v5_8k", tier), t.stft}):
            got = stft_magnitude(audio8, wr8, wi8, **kw8, mode=mode)
            want = stft_magnitude_reference(audio8, wr8, wi8, **kw8, mode=mode)
            torch.cuda.synchronize()
            err = tier_check.errors(got, want, tier, float(want.abs().max()))
            line.append(f"v5_8k B=37 x {samples8} ({mode}) {err[0]:.3e}")
            broken = tier_check.breaches(tier, "stft_magnitude", 37, {"mag": err})
            require(not broken, f"tier {tier} v5_8k spectrum ({mode}): " + "; ".join(broken))
        log(f"tier {tier} spectrum at the tiles' edges (largest difference of the largest "
            "magnitude): " + "; ".join(line))


def speech_track(seed: int = 0) -> np.ndarray:
    """The whole chunks of the track of four synthetic utterances of `seed`
    (the JAX package's generator; seed 0 is the material of the JAX
    package's recorded deviations), [1, N, CHUNK] fp32."""
    from vadc_tpu_torch.io.synthaudio import utterance_track

    audio, _ = utterance_track(4, seed=seed)
    n = len(audio) // CHUNK
    return audio[: n * CHUNK].reshape(1, n, CHUNK).astype(np.float32)


def speech_file(path: Path) -> None:
    """speech_track() as raw s16le at `path`, for the CLI."""
    np.clip(speech_track().ravel() * 32768, -32768, 32767).astype("<i2").tofile(path)


def speech_segments(probs, chunk: int = CHUNK, sr: int = SR) -> list:
    """The CLI's segmenter over one stream's probabilities."""
    from vadc_tpu_torch.cli.segmenter import Segmenter, SegmenterConfig

    seg = Segmenter(SegmenterConfig.from_ms(chunk_samples=chunk, sample_rate=sr))
    return [e for p in probs.tolist() for e in seg.feed(p)] + list(seg.finish())


def speech_probs(params, device, precision: str) -> list:
    """StreamRunner.scan at `precision` over the speech track of each of
    SPEECH_SEEDS, one stream each (as the JAX package measured its
    deviations: tools/tpu_check.py `speech_*`): [N] fp64 on the host."""
    from vadc_tpu_torch.engine.runner import StreamRunner

    runner = StreamRunner("v3", params, device=device, precision=precision)
    return [runner.scan(track, runner.init_state(1))[0][0].double().cpu()
            for track in map(speech_track, SPEECH_SEEDS)]


def tier_on_speech(params, device, tier: str, speech: Path, faithful: list) -> float:
    """The tier against faithful (`faithful`: speech_probs at faithful) on
    the card over the speech tracks of SPEECH_SEEDS: the largest deviation
    within SPEECH_BOUND["v3"][tier]; the segments identical at balanced and fast,
    and at turbo of the same count with each boundary within one chunk
    (turbo moves one start by one chunk on seeds 1 and 6, as the JAX
    package's own turbo does: tests/test_torch_tiers.py); and the CLI's
    segments on speech_track() as s16le identical. Returns the largest
    deviation."""
    from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND

    chunk_s = CHUNK / SR
    devs, moved = [], []
    for seed, want, got in zip(SPEECH_SEEDS, faithful, speech_probs(params, device, tier)):
        devs.append(float((got - want).abs().max()))
        seg, seg_want = speech_segments(got), speech_segments(want)
        if seg != seg_want:
            moved.append(seed)
            require(tier == "turbo" and len(seg) == len(seg_want) and all(
                abs(a - b) <= chunk_s + 1e-9 for s, w in zip(seg, seg_want) for a, b in zip(s, w)),
                f"tier {tier}: the segments of speech seed {seed} differ: {seg} vs {seg_want}")
    cli = [run_cli(["--device", "cuda", "--precision", p], speech) for p in ("faithful", tier)]
    log(f"tier {tier} on speech, seeds {list(SPEECH_SEEDS)}: max abs deviation from faithful "
        + ", ".join(f"{d:.3e}" for d in devs) + f" (largest {max(devs):.3e}, bound "
        f"{SPEECH_BOUND['v3'][tier]:g}); seeds whose segments moved by a chunk: {moved}; CLI segments "
        f"on seed 0 {cli[1].split()}, the same as faithful's: {cli[1] == cli[0]}")
    require(max(devs) <= SPEECH_BOUND["v3"][tier], f"tier {tier}: deviation {max(devs):.3e} on speech")
    require(cli[1] == cli[0] and len(cli[0].split()) >= 3, f"tier {tier}: CLI segments differ")
    return max(devs)


def phase_main_path_tiers(params, device, speech: Path, totals: dict) -> dict:
    """Each tier's v3.1 paths, counted on their own: the loop of
    StreamRunner.step (forward_fused) against StreamRunner.scan (the slab
    route) bit for bit, then the CLI on speech against faithful. At fast,
    also the batch CLI over the corpus and the server's clients, their
    lines beside faithful's on the card. Returns tier -> the CLI's
    deviation from faithful on speech."""
    deviations = {}
    faithful = speech_probs(params, device, "faithful")
    for tier in TIERS:
        counts = totals.setdefault(tier, {})
        zero_launches()
        steps_vs_scan(params, device, tier)
        read_launches(f"{tier}: v3.1 StreamRunner.step and .scan", counts,
                      ("forward_fused", *V3_SLAB_KERNELS))
        zero_launches()
        deviations[tier] = tier_on_speech(params, device, tier, speech, faithful)
        read_launches(f"{tier}: v3.1 on speech (StreamRunner.scan, the CLI)", counts,
                      V3_SLAB_KERNELS)
    counts = totals["fast"]
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = write_corpus(Path(tmp))
        argv = [*paths, "--slab_chunks", str(SLAB_CHUNKS), "--device", "cuda"]
        want, _ = run_batch_cli(argv)
        zero_launches()
        got, wall = run_batch_cli([*argv, "--fast"])
        read_launches("fast: batch CLI", counts, V3_SLAB_KERNELS)
    differ = sorted({ln.split("\t")[0] for ln in set(got.splitlines()) ^ set(want.splitlines())})
    log(f"batch CLI --fast: {len(got.splitlines())} lines in {wall:.3f} s; files whose lines "
        f"differ from faithful's: {len(differ)} of {CORPUS_FILES}")
    payloads = [client_pcm(i) for i in range(SERVER_CLIENTS)]
    want_lines, _ = serve_clients(device, payloads)
    zero_launches()
    got_lines, srv = serve_clients(device, payloads, precision="fast")
    require_server_launches("fast: server", srv, launch_counts(), counts, ("forward_fused",))
    same = sum(g == w for g, w in zip(got_lines, want_lines))
    log(f"server --precision fast: tick_count {srv.tick_count}; clients whose lines equal "
        f"faithful's: {same} of {SERVER_CLIENTS}")
    require(all(g and not any(x.startswith("error") for x in g) for g in got_lines),
            "server at fast: a client got no segment lines")
    require(got.count("\n") >= CORPUS_FILES, f"batch CLI at fast: {got.count(chr(10))} lines")
    return deviations


def products_bound_ms(nbytes: float, *terms: tuple[float, str]) -> tuple[float, str]:
    """The least time of an instance whose operations are `terms`, (flops,
    the products' operands: "fp32", "bf16_3x" or "bf16"): fp32 FMAs against
    the CUDA cores' peak; bf16 products against the bf16 dense tensor-core
    peak, three times over where they are split (bf16_3x); bytes as at
    fp32 (the activations stay on the chip)."""
    if all(mode == "fp32" for _, mode in terms):
        return bound_ms(sum(flops for flops, _ in terms), nbytes)
    ops = sum(flops * (3 if mode == "bf16_3x" else 1) for flops, mode in terms)
    by_ops, by_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def tier_bound_ms(spectrum: float, body: float, nbytes: float, tier: str) -> tuple[float, str]:
    """products_bound_ms of a v3.1 tier instance: its spectrum at the tier's
    STFT operands, the rest at its products'."""
    from vadc_tpu_torch.nn.precision import tier_of

    t = tier_of(tier)
    return products_bound_ms(nbytes, (spectrum, t.stft), (body, t.products))


def phase_timing_tiers(params, device) -> dict:
    """Each tier in one call beside faithful: the instances against their
    plain versions (forward_fused, encode_fused_audio, dot_magnitude at
    B=2048 x 1536, forward_fused2d at 2048 x 25 frames, lstm_decoder_fused
    at 64 x 64 x 7), forward_fused at B=1, the v3.1 step at 2048, the 64 x
    64 and 2048 x 8 slabs, the CLI window, the server's ticks at 2048
    slots; and cuBLAS's bf16 product of the frames beside the fast
    spectrum. tier -> name -> (kernel ms, plain ms) or ms."""
    import torch

    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm_decoder import (
        lstm_decoder_fused, lstm_decoder_fused_reference, weight_of,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference, forward_fused, forward_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d, forward_fused2d_reference
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, dot_magnitude_reference, split_basis
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import bf16, tier_of

    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 200)).to(device)
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    wr, wi = split_basis(params["stft_basis"])
    h, c = silero_v31.init_state(B_MAIN, device)
    h1, c1 = silero_v31.init_state(1, device)
    slab = torch.from_numpy(speech_chunks(SLAB_CHUNKS * SLAB_CHUNKS, CHUNK, seed=SEED + 900)
                            ).to(device).reshape(SLAB_CHUNKS, SLAB_CHUNKS, CHUNK)
    wide = torch.from_numpy(speech_chunks(B_MAIN * SCAN_CHUNKS, CHUNK, seed=SEED + 900)
                            ).to(device).reshape(B_MAIN, SCAN_CHUNKS, CHUNK)
    window = torch.from_numpy(speech_chunks(CLI_WINDOW, CHUNK, seed=SEED + 901)).to(device)
    args = (params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"])
    hs, cs = silero_v31.init_state(SLAB_CHUNKS, device)
    seq = encode_fused_audio(params, slab.reshape(-1, CHUNK)).reshape(SLAB_CHUNKS, -1, 64)
    yardstick = cudnn_bf16_lstm_ms(args[0], args[1], seq, hs, cs)
    log(f"time torch.nn.LSTM (cuDNN) in bf16, v3.1 B={SLAB_CHUNKS} x T={seq.shape[1]} (a "
        f"yardstick: bf16 state, no decoder): {yardstick:.4f} ms")
    out = {}
    for name in ("faithful", *TIERS):
        tier = tier_of(name)
        feats = silero_v31.features(params, audio, tier)
        x = encode_fused_audio(params, slab.reshape(-1, CHUNK), tier).reshape(
            SLAB_CHUNKS, SLAB_CHUNKS, -1, 64)
        wt = weight_of(params, tier)
        runner = StreamRunner("v3", params, device=device, precision=name)
        state, state_slab, state_wide = (runner.init_state(n) for n in (B_MAIN, SLAB_CHUNKS, B_MAIN))
        t = {
            "forward_fused": cuda_ms_pair(lambda: forward_fused(params, audio, h, c, tier=tier),
                                          lambda: forward_fused_reference(params, audio, h, c, tier)),
            "encode_fused_audio": cuda_ms_pair(
                lambda: encode_fused_audio(params, audio, tier),
                lambda: encode_fused_audio_reference(params, audio, tier)),
            "dot_magnitude": cuda_ms_pair(lambda: dot_magnitude(frames, wr, wi, tier),
                                          lambda: dot_magnitude_reference(frames, wr, wi, tier)),
            "silero_v31_fused": cuda_ms_pair(
                lambda: forward_fused2d(params, feats, h, c, tier=tier),
                lambda: forward_fused2d_reference(params, feats, h, c, tier)),
            "lstm_decoder_fused": cuda_ms_pair(
                lambda: lstm_decoder_fused(x, hs, cs, *args, wt=wt, tier=tier),
                lambda: lstm_decoder_fused_reference(x, hs, cs, *args, tier), iters=3),
            "forward_fused_b1": cuda_ms(lambda: forward_fused(params, audio[:1], h1, c1, tier=tier)),
            "step": cuda_ms(lambda: runner.step(audio, state)),
            "slab_64x64": cuda_ms(lambda: runner.scan(slab, state_slab), iters=10),
            "slab_2048x8": cuda_ms(lambda: runner.scan(wide, state_wide), iters=10),
            "cli_window": cuda_ms(
                lambda: silero_v31.forward_minibatched(params, window, h1, c1, tier), iters=10),
        }
        t["tick"], t["tick2"] = time_ticks(str(DEFAULT_WEIGHTS), device, f"v3.1 {name}", name)
        t["cudnn_bf16_lstm"] = yardstick
        out[name] = t
        log(f"time tier {name}: " + ", ".join(
            f"{k} {v[0]:.4f} ms (plain {v[1]:.4f})" if isinstance(v, tuple) else f"{k} {v:.4f} ms"
            for k, v in t.items() if k != "cudnn_bf16_lstm"))
    a, b = bf16(frames.reshape(-1, 256)).to(torch.bfloat16), bf16(
        torch.cat([wr, wi], dim=1)).to(torch.bfloat16)
    out["fast"]["cublas_bf16"] = cuda_ms(lambda: torch.matmul(a, b))
    log(f"time cuBLAS bf16 product only (frames [{a.shape[0]}, 256] @ [256, 258], bf16 in and "
        f"out) beside the fast spectrum: {out['fast']['cublas_bf16']:.4f} ms")
    return out


# ---- the bf16 tiers of v4 and v5: stft_magnitude and lstm_fused ------------


def stft_mode_of(family: str, tier: str) -> str:
    """The products' operands of stft_magnitude on a family's path at a tier
    (nn/precision.py: stft_mode; v4's spectrum feeds log1p(2^20 x))."""
    from vadc_tpu_torch.nn.precision import stft_mode, tier_of

    return stft_mode(tier_of(tier), log_sensitive=family.startswith("v4"))


def tier_v45_digests(models: dict, device) -> dict:
    """Digests of the v4/v5 tier instances: stft_magnitude at the four family
    geometries (B=B_MAIN chunks of speech, as stft_digests) at each mode a
    tier gives the family, and lstm_fused at each tier on seeded random
    inputs (v4 B=2048 x T=3 and B=1 x T=288, v5 B=2048 x T=1 and B=1 x T=96:
    both variants, the cluster kernel): name[mode or tier] -> digest."""
    import torch

    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
    from vadc_tpu_torch.nn.precision import tier_of

    out = {}
    for family, (module, params) in models.items():
        samples, kw = stft_geometry(family, module)
        audio = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + 11)).to(device)
        for mode in sorted({stft_mode_of(family, tier) for tier in TIERS}):
            out[f"stft_magnitude_{family}[{mode}]"] = digest(
                stft_magnitude(audio, *split_basis_of(params), **kw, mode=mode))
    for family, hidden, layers, shapes in (("v4", 64, 2, ((B_MAIN, 3), (1, 288))),
                                           ("v5", 128, 1, ((B_MAIN, 1), (1, CLI_WINDOW)))):
        params = models[family][1]
        for tier in TIERS:
            t = tier_of(tier)
            for batch, steps in shapes:
                rng = np.random.default_rng(SEED + 12)
                x, h, c = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (
                    rng.normal(size=(batch, steps, hidden)), 0.5 * rng.normal(size=(layers, batch, hidden)),
                    2.0 * rng.normal(size=(layers, batch, hidden))))
                name = f"lstm_fused_{family}" + ("" if batch > 1 else "_long")
                out[f"{name}[{tier}]"] = digest(*lstm_fused(
                    x, h, c, params["lstm_w"], params["lstm_b"],
                    wt=weight_of(params, t), tier=t))
    return out


def check_stft_magnitude_tier(params, audio, family: str, tier: str, label: str, kw: dict,
                              control: bool) -> float:
    """stft_magnitude's instance of the mode the tier gives the family
    against its plain version at that mode, held to kernels/tier_check.py
    (the spectrum's largest difference relative to its largest value); at
    n_fft 256, bit for bit against dot_magnitude's instance of the same
    operands on the reflect-padded unfold. With `control`, the fp32
    instance against the same plain version, which must break the limits
    where the mode is bf16 (bf16_3x and fp32 spectra cannot be told apart:
    tier_check)."""
    import torch

    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude
    from vadc_tpu_torch.kernels.stft_mag import (
        split_basis_of, stft_magnitude, stft_magnitude_reference,
    )
    from vadc_tpu_torch.nn import functional as F

    mode = stft_mode_of(family, tier)
    wr, wi = split_basis_of(params)
    out = stft_magnitude(audio, wr, wi, **kw, mode=mode)
    ref = stft_magnitude_reference(audio, wr, wi, **kw, mode=mode)
    torch.cuda.synchronize()
    require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
            f"stft_magnitude[{mode}] {label}: shape {tuple(out.shape)} or non-finite")
    scale = float(ref.abs().max())
    errs = {"mag": tier_check.errors(out, ref, tier, scale)}
    broken = tier_check.breaches(tier, "stft_magnitude", audio.shape[0], errs)
    same = None
    if wr.shape == (256, 129):
        # dot_magnitude's instance of the same operands: the tier whose STFT they are
        as_tier = {"fp32": "faithful", "bf16_3x": "fast", "bf16": "turbo"}[mode]
        frames = F.frame(F.reflect_pad_last(audio, kw["pad_left"], kw["pad_right"]), 256, kw["hop"])
        same = torch.equal(out, dot_magnitude(frames, wr, wi, as_tier))
    line = (f"tier {tier} stft_magnitude[{mode}] {label}: largest difference "
            f"{errs['mag'][0]:.3e} of the largest magnitude; bit-equal to dot_magnitude[{mode}]: "
            f"{same}")
    if control:
        fp32 = stft_magnitude(audio, wr, wi, **kw)
        caught = bool(tier_check.breaches(tier, "stft_magnitude", audio.shape[0],
                                          {"mag": tier_check.errors(fp32, ref, tier, scale)}))
        line += (f"; control, the fp32 instance: {tier_check.errors(fp32, ref, tier, scale)[0]:.3e}"
                 f", breaks the limits: {caught}")
        require(caught or mode != "bf16", f"stft_magnitude control at {mode}: the fp32 instance "
                "passes the limits")
    log(line)
    require(not broken, f"stft_magnitude[{mode}] {label}: " + "; ".join(broken))
    require(same is not False, f"stft_magnitude[{mode}] {label}: differs from dot_magnitude[{mode}]")
    return errs["mag"][0] * scale


def check_lstm_tier(params, x, h, c, tier: str, label: str, control: bool) -> float:
    """lstm_fused's instance of the tier against its plain version
    (F.lstm at the tier) from a carried state, held to kernels/tier_check.py;
    both variants launched explicitly at the tier, the resident one also in
    passes, bit for bit against the wrapper's call. With `control` (at fast
    and turbo, where bf16 products differ from fp32 ones), the faithful
    instance against the same plain version must break the limits. Returns
    the largest difference."""
    import torch

    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.kernels.lstm import lstm_fused, lstm_fused_reference, weight_of
    from vadc_tpu_torch.nn.precision import FAITHFUL, tier_of

    t = tier_of(tier)
    w, b = params["lstm_w"], params["lstm_b"]
    wt = weight_of(params, t)
    got = lstm_fused(x, h, c, w, b, wt=wt, tier=t)
    want = lstm_fused_reference(x, h, c, w, b, t)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(g).all()) for g in got), f"lstm_fused[{tier}] {label}: not finite")

    def errs_of(out):
        scale = max(1.0, float(want[2].abs().max()))
        return {name: tier_check.errors(g, r, tier, scale if name == "c" else 1.0)
                for name, g, r in zip(("y", "h", "c"), out, want)}

    errs = errs_of(got)
    broken = tier_check.breaches(tier, "lstm_fused", x.shape[0], errs)
    variants = lstm_variants(x, h, c, wt, b, t)
    with small_pre_scratch(16 * x.shape[2] * x.shape[0] * max(1, x.shape[1] // 3)):
        variants["resident, in passes"] = lstm_variants(x, h, c, wt, b, t)["resident"]
    if x.shape[0] > RAGGED_STREAMS:
        # fewer streams a block and a ragged last block: a stream's bits do
        # not depend on the other streams of its block
        n = RAGGED_STREAMS
        part = lstm_fused(x[:n].contiguous(), h[:, :n].contiguous(), c[:, :n].contiguous(), w, b,
                          wt=wt, tier=t)
        variants[f"first {n} streams alone"] = (
            torch.cat([part[0], got[0][n:]]), torch.cat([part[1], got[1][:, n:]], 1),
            torch.cat([part[2], got[2][:, n:]], 1))
        torch.cuda.synchronize()
    same = {name: same_bits(out, got) for name, out in variants.items()}
    line = (f"tier {tier} lstm_fused {label} (the wrapper runs {variant_of(*x.shape[:2])}; largest "
            f"difference / share above {tier_check.TAU[tier]:g}): "
            + ", ".join(f"{k} {m:.3e}/{s:.4f}" for k, (m, s) in errs.items())
            + f"; bit-equal to the wrapper's call: {same}")
    if control:
        faithful = lstm_fused(x, h, c, w, b, wt=weight_of(params), tier=FAITHFUL)
        control_errs = errs_of(faithful)
        caught = bool(tier_check.breaches(tier, "lstm_fused", x.shape[0], control_errs))
        line += ("; control, the faithful instance: "
                 + ", ".join(f"{k} {m:.3e}/{s:.4f}" for k, (m, s) in control_errs.items())
                 + f", breaks the limits: {caught}")
        require(caught, f"lstm_fused control at {tier} {label}: the faithful instance passes")
    log(line)
    if not all(same.values()):
        log(f"lstm_fused[{tier}] {label}: differences from the wrapper's call: "
            + variant_diffs(variants, got, ("y", "hn", "cn")))
    require(not broken, f"lstm_fused[{tier}] {label}: " + "; ".join(broken))
    for name, ok in same.items():
        require(ok, f"lstm_fused[{tier}] {label}: the {name} variant differs from the wrapper's call")
    return max(m for m, _ in errs.values())


def phase_kernels_tiers_v45(models: dict, device) -> dict:
    """The v4/v5 tier instances against their plain versions at the shapes
    the paths give them: stft_magnitude at the four family geometries at
    B=2048 and B=37, lstm_fused at v4 B=2048 x T=3 and B=1 x T=288, v5
    B=2048 x T=1 and B=1 x T=96 (the streaming variant, the wavefront and the
    cluster kernel), each beside the control; the digests held to
    TIER_DIGESTS. tier -> kernel -> the largest difference."""
    import torch

    from vadc_tpu_torch.nn.precision import tier_of

    errs = {}
    for tier in TIERS:
        e = errs.setdefault(tier, {"stft_magnitude": 0.0, "lstm_fused": 0.0})
        for seed, (family, (module, params)) in enumerate(models.items(), SEED + 500):
            samples, kw = stft_geometry(family, module)
            chunks = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=seed)).to(device)
            for b in (B_MAIN, 37):
                err = check_stft_magnitude_tier(params, chunks[:b], family, tier,
                                                f"{family} B={b} x {samples}", kw, b == B_MAIN)
                e["stft_magnitude"] = max(e["stft_magnitude"], err)
        t = tier_of(tier)
        control = t.products == "bf16"
        for family, chunk, n_frames in (("v4", V4_CHUNK, 3), ("v5", V5_CHUNK, 1)):
            module, params = models[family]
            ctx = getattr(module, "CONTEXT_SAMPLES", 0)
            audio = torch.from_numpy(speech_chunks(B_MAIN, ctx + chunk, seed=SEED + 510)).to(device)
            x, h, c = lstm_inputs(module, params, audio, B_MAIN, device, t)
            e["lstm_fused"] = max(e["lstm_fused"], check_lstm_tier(
                params, x, h, c, tier, f"{family} B={B_MAIN} x T={x.shape[1]}", control))
            window = torch.from_numpy(speech_chunks(CLI_WINDOW, ctx + chunk, seed=SEED + 511)
                                      ).to(device)
            x, h, c = lstm_inputs(module, params, window, 1, device, t)
            e["lstm_fused"] = max(e["lstm_fused"], check_lstm_tier(
                params, x, h, c, tier, f"{family} B=1 x T={x.shape[1]}", control))
    got = tier_v45_digests(models, device)
    log(f"v4/v5 tier digests: {json.dumps(got)}")
    for name, value in got.items():
        want = TIER_DIGESTS.get(name)
        require(value == want, f"{name}: digest {value} differs from {want}")
    return errs


def scan_card_vs_cpu_tier(family: str, params, device, chunk: int, seed: int, tier: str) -> None:
    """StreamRunner.scan at the tier over TIER_PATH_BATCH streams x
    SCAN_CHUNKS chunks on the card against the CPU (plain versions), held to
    kernels/tier_check.py's PATH_MAX (the kernels and the plain versions sum
    in other orders, and a bf16 rounding flip carries on through the
    recurrence)."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels import tier_check

    b = TIER_PATH_BATCH
    chunks = speech_chunks(b * SCAN_CHUNKS, chunk, seed=seed).reshape(b, SCAN_CHUNKS, chunk)
    gpu = StreamRunner(family, params, device=device, precision=tier)
    probs_gpu, state = gpu.scan(chunks, gpu.init_state(b))
    torch.cuda.synchronize()
    cpu = StreamRunner(family, params, device="cpu", precision=tier)
    probs_cpu, cstate = cpu.scan(chunks, cpu.init_state(b))
    require(bool(torch.isfinite(probs_gpu).all()), f"scan {family} at {tier}: not finite")
    errs = {"probs": max_abs(probs_gpu.cpu(), probs_cpu), "h": max_abs(state.h.cpu(), cstate.h),
            "c": max_abs(state.c.cpu(), cstate.c) / max(1.0, float(cstate.c.abs().max()))}
    limits = tier_check.PATH_MAX[tier]
    log(f"tier {tier} scan {family} {b}x{SCAN_CHUNKS} card vs CPU: "
        + ", ".join(f"{k} {v:.3e} (bound {limits[k]:g})" for k, v in errs.items())
        + f"; speech share p>0.5: {float((probs_gpu > 0.5).float().mean()):.3f}")
    for k, v in errs.items():
        require(v <= limits[k], f"tier {tier} scan {family} card vs CPU: {k} {v:.3e}")


def minibatch_card_vs_cpu_tier(family: str, params, device, chunk: int, seed: int,
                               tier: str) -> None:
    """MinibatchRunner at the tier over one window of CLI_WINDOW chunks
    (lstm_fused at B=1 over the window's frames: the resident variant; for
    v5 the cluster kernel), card against CPU, held to PATH_MAX."""
    import torch

    from vadc_tpu_torch.engine.runner import MinibatchRunner
    from vadc_tpu_torch.kernels import tier_check

    window = speech_chunks(CLI_WINDOW, chunk, seed=seed).reshape(-1)
    kw = dict(batch_size=CLI_WINDOW, chunk_samples=chunk, precision=tier)
    gpu = MinibatchRunner(family, params, device=device, **kw)
    cpu = MinibatchRunner(family, params, device="cpu", **kw)
    pg, pc = torch.tensor(gpu.process_window(window)), torch.tensor(cpu.process_window(window))
    err = max_abs(pg, pc)
    log(f"tier {tier} MinibatchRunner {family} window of {CLI_WINDOW} card vs CPU: probs {err:.3e} "
        f"(bound {tier_check.PATH_MAX[tier]['probs']:g})")
    require(err <= tier_check.PATH_MAX[tier]["probs"], f"tier {tier} MinibatchRunner {family}: {err}")


def cli_card_vs_cpu_tier(extra: list[str], stdin_path: Path, tier: str) -> str:
    """The CLI at --precision tier with --device cuda and --device cpu: the
    same segments, raw probabilities within PATH_MAX. Returns the card's
    segment lines."""
    from vadc_tpu_torch.kernels import tier_check

    argv = ["--precision", tier, *extra]
    seg_gpu = run_cli(["--device", "cuda", *argv], stdin_path)
    seg_cpu = run_cli(["--device", "cpu", *argv], stdin_path)
    raw_gpu = run_cli(["--device", "cuda", "--raw_probabilities", *argv], stdin_path)
    raw_cpu = run_cli(["--device", "cpu", "--raw_probabilities", *argv], stdin_path)
    pg = np.array([float(x) for x in raw_gpu.split()])
    pc = np.array([float(x) for x in raw_cpu.split()])
    require(pg.shape == pc.shape and pg.size > 0, f"raw probabilities {pg.shape} vs {pc.shape}")
    err = float(np.abs(pg - pc).max())
    log(f"CLI {' '.join(argv)}: segments cuda {seg_gpu.split()}, cpu {seg_cpu.split()}; raw "
        f"probabilities max abs diff {err:.3e} over {pg.size} chunks (bound "
        f"{tier_check.PATH_MAX[tier]['probs']:g})")
    require(seg_gpu == seg_cpu and len(seg_gpu.split()) >= 3, f"CLI {argv}: segments differ")
    require(err <= tier_check.PATH_MAX[tier]["probs"], f"CLI {argv}: raw probabilities differ")
    return seg_gpu


# family -> (sample rate, chunk samples) of the v4/v5 paths on speech
V45_RATES = {"v4": (SR, V4_CHUNK), "v4_8k": (SR // 2, V4_8K_CHUNK), "v5": (SR, V5_CHUNK),
             "v5_8k": (SR // 2, V5_8K_CHUNK)}


def family_tracks(family: str) -> tuple[np.ndarray, list]:
    """The speech tracks of SPEECH_SEEDS at the family's rate and chunk as
    streams of one scan: [12, N, chunk] (each track zero-padded at its end
    to the longest), and each track's chunk count."""
    from vadc_tpu_torch.io.synthaudio import utterance_track

    sr, chunk = V45_RATES[family]
    tracks = []
    for seed in SPEECH_SEEDS:
        audio, _ = utterance_track(4, sr=sr, seed=seed)
        n = len(audio) // chunk
        tracks.append(audio[: n * chunk].reshape(n, chunk))
    lengths = [len(t) for t in tracks]
    out = np.zeros((len(tracks), max(lengths), chunk), np.float32)
    for i, t in enumerate(tracks):
        out[i, : len(t)] = t
    return out, lengths


def family_speech_probs(family: str, params, device, precision: str, tracks) -> "torch.Tensor":
    from vadc_tpu_torch.engine.runner import StreamRunner

    runner = StreamRunner(family, params, device=device, precision=precision)
    return runner.scan(tracks, runner.init_state(tracks.shape[0]))[0].double().cpu()


def tier_on_speech_v45(family: str, params, device, tier: str, faithful, tracks,
                       lengths) -> float:
    """A v4/v5 family at the tier against faithful on the card over the
    speech tracks of SPEECH_SEEDS at its rate, the 12 tracks as 12 streams
    of one StreamRunner.scan (a stream's padding comes after its track, so
    it changes none of the track's chunks): the largest deviation within
    SPEECH_BOUND[family]. v4 and v4_8k (official weights) keep faithful's
    segments as tier_on_speech holds v3.1's: identical at balanced and
    fast, at turbo of the same count with each boundary within one chunk.
    v5 and v5_8k run synthetic weights, whose probabilities hover near the
    threshold: the seeds whose segments moved are logged. Returns the
    largest deviation."""
    from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND

    sr, chunk = V45_RATES[family]
    got_all = family_speech_probs(family, params, device, tier, tracks)
    chunk_s = chunk / sr
    devs, moved = [], []
    for seed, n, want, got in zip(SPEECH_SEEDS, lengths, faithful, got_all):
        want, got = want[:n], got[:n]
        devs.append(float((got - want).abs().max()))
        seg, seg_want = speech_segments(got, chunk, sr), speech_segments(want, chunk, sr)
        if seg != seg_want:
            moved.append(seed)
            require(family.startswith("v5") or tier == "turbo" and len(seg) == len(seg_want) and all(
                abs(a - b) <= chunk_s + 1e-9 for s, w in zip(seg, seg_want) for a, b in zip(s, w)),
                f"{family} tier {tier}: the segments of speech seed {seed} differ: {seg} vs {seg_want}")
    bound = SPEECH_BOUND[family][tier]
    log(f"{family} tier {tier} on speech, seeds {list(SPEECH_SEEDS)} ({len(lengths)} streams of one "
        "scan): max "
        "abs deviation from faithful " + ", ".join(f"{d:.3e}" for d in devs)
        + f" (largest {max(devs):.3e}, bound {bound:g}); seeds whose segments moved: {moved}")
    require(max(devs) <= bound, f"{family} tier {tier}: deviation {max(devs):.3e} on speech")
    return max(devs)


def phase_main_path_tiers_v45(models: dict, archives: dict, device, speech: Path,
                              totals: dict) -> dict:
    """Each tier's v4 and v5 paths, counted on their own (stft_magnitude and
    lstm_fused > 0 per tier): StreamRunner.scan card vs CPU for v4, v4_8k,
    v5 and v5_8k, MinibatchRunner card vs CPU for v5 and v5_8k, each family
    on the 12 speech tracks against faithful; at fast, the v4 CLI card vs
    CPU. Returns tier -> family -> the deviation on speech."""
    speech_runs = {}
    for family in V45_RATES:
        tracks, lengths = family_tracks(family)
        faithful = family_speech_probs(family, models[family][1], device, "faithful", tracks)
        speech_runs[family] = (faithful, tracks, lengths)
    chunks = {family: chunk for family, (_, chunk) in V45_RATES.items()}
    deviations = {}
    for tier in TIERS:
        counts = totals.setdefault(tier, {})
        zero_launches()
        for seed, family in enumerate(("v4", "v4_8k", "v5", "v5_8k"), SEED + 520):
            scan_card_vs_cpu_tier(family, models[family][1], device, chunks[family], seed, tier)
        for seed, family in enumerate(("v5", "v5_8k"), SEED + 530):
            minibatch_card_vs_cpu_tier(family, models[family][1], device, chunks[family], seed, tier)
        deviations[tier] = {family: tier_on_speech_v45(family, models[family][1], device, tier,
                                                       *speech_runs[family])
                            for family in V45_RATES}
        read_launches(f"{tier}: v4/v5 StreamRunner.scan, MinibatchRunner, on speech", counts,
                      ("stft_magnitude", "lstm_fused"))
    zero_launches()
    cli_card_vs_cpu_tier(["--model", str(archives["v4"])], speech, "fast")
    read_launches("fast: v4 CLI", totals["fast"], ("stft_magnitude", "lstm_fused"))
    return deviations


def cufft_stft(audio, n_fft: int, pad_left: int, pad_right: int, hop: int):
    """The spectrum's magnitude by cuFFT: the reflect pad, torch.stft of a
    periodic Hann window without centring, |.|: stft_magnitude's function
    where the basis is the Hann-windowed DFT. [B, bins, frames] (torch's
    layout). A yardstick timed here; the port never calls it."""
    import torch

    from vadc_tpu_torch.nn import functional as F

    window = torch.hann_window(n_fft, periodic=True, device=audio.device)
    return torch.stft(F.reflect_pad_last(audio, pad_left, pad_right), n_fft, hop_length=hop,
                      window=window, center=False, return_complex=True).abs()


def hann_dft_gap(basis) -> float:
    """The largest difference between an STFT basis [2 * bins, n_fft] and the
    periodic-Hann-windowed DFT (cos rows, then -sin rows): where it is at
    the fp32 rounding floor, cuFFT computes the spectrum kernels' function."""
    import torch

    n_fft = basis.shape[1]
    bins = n_fft // 2 + 1
    n = torch.arange(n_fft, dtype=torch.float64, device=basis.device)
    k = torch.arange(bins, dtype=torch.float64, device=basis.device)[:, None]
    hann = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=basis.device)
    angle = 2 * np.pi * k * n / n_fft
    want = torch.cat([torch.cos(angle) * hann, -torch.sin(angle) * hann])
    return float((basis.double() - want).abs().max())


def phase_timing_library(params, models: dict, device) -> dict:
    """The library route beside the two spectrum kernels: cuFFT
    (torch.stft of the reflect-padded audio, and torch.fft.rfft of the
    windowed frames for dot_magnitude) at the shapes the kernels are timed
    at, each against the kernel's output where the basis is the Hann DFT.
    cuFFT rounds otherwise than the fmaf chains, and log1p(2^20 x) would
    amplify that: a yardstick, not a substitute. name -> ms (and the
    geometries' dict for stft_magnitude)."""
    import torch

    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, split_basis
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude
    from vadc_tpu_torch.nn import functional as F

    out = {"stft_magnitude_at": {}}
    for family, (module, fparams) in models.items():
        samples, kw = stft_geometry(family, module)
        audio = torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + 400)).to(device)
        n_fft = fparams["stft_basis"].shape[1]
        gap = hann_dft_gap(fparams["stft_basis"])
        kernel = stft_magnitude(audio, *split_basis_of(fparams), **kw)
        lib = cufft_stft(audio, n_fft, **kw).transpose(1, 2)
        diff = max_abs(lib, kernel) / float(kernel.abs().max())
        ms = cuda_ms(lambda: cufft_stft(audio, n_fft, **kw))
        # cuFFT computes the kernel's function only where the basis is the
        # Hann DFT (v4 and v4_8k; v5's bases are another)
        out["stft_magnitude_at"][f"{family} B={B_MAIN} x {samples}"] = {
            "library_ms": ms if gap < 1e-6 else None, "cufft_ms": ms, "basis_vs_hann_dft": gap,
            "library_vs_kernel_rel": diff}
        log(f"time cuFFT (reflect pad, torch.stft, abs) {family} B={B_MAIN} x {samples}: {ms:.4f} ms; "
            f"the basis against the Hann DFT {gap:.2e}, cuFFT against stft_magnitude {diff:.2e} of "
            "the largest magnitude" + ("" if gap < 1e-6 else " (another basis: not the same function)"))
        if family == "v4":
            out["stft_magnitude"] = ms
    audio = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 200)).to(device)
    frames = F.frame(F.reflect_pad_last(audio, 128, 128), 256, 64)
    wr, wi = split_basis(params["stft_basis"])
    window = torch.hann_window(256, periodic=True, device=device)

    def rfft():
        return torch.fft.rfft(frames * window, dim=-1).abs()

    kernel = dot_magnitude(frames, wr, wi)
    diff = max_abs(rfft(), kernel) / float(kernel.abs().max())
    out["dot_magnitude"] = cuda_ms(rfft)
    log(f"time cuFFT (frames x window, torch.fft.rfft, abs) beside dot_magnitude B={B_MAIN} x "
        f"{CHUNK}: {out['dot_magnitude']:.4f} ms; the v3.1 basis against the Hann DFT "
        f"{hann_dft_gap(params['stft_basis']):.2e}, cuFFT against dot_magnitude {diff:.2e} of the "
        "largest magnitude")
    return out


def phase_timing_tiers_v45(models: dict, device) -> dict:
    """Per tier beside faithful in one call: stft_magnitude's instance at the
    four family geometries at B=2048 against its plain version, lstm_fused at
    v4 B=2048 x T=3 against its plain version, and the v4 and v5 B=2048 step
    (StreamRunner.step). tier -> name -> (kernel ms, plain ms) or ms."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.kernels.lstm import lstm_fused, lstm_fused_reference, weight_of
    from vadc_tpu_torch.kernels.stft_mag import (
        split_basis_of, stft_magnitude, stft_magnitude_reference,
    )
    from vadc_tpu_torch.nn.precision import tier_of

    audio = {}
    for family, (module, params) in models.items():
        samples, kw = stft_geometry(family, module)
        audio[family] = (torch.from_numpy(speech_chunks(B_MAIN, samples, seed=SEED + 400)
                                          ).to(device), kw)
    v4, p4 = models["v4"]
    x, h, c = lstm_inputs(v4, p4, audio["v4"][0], B_MAIN, device)
    yardstick = cudnn_bf16_lstm_ms(p4["lstm_w"], p4["lstm_b"], x, h, c)
    log(f"time torch.nn.LSTM (cuDNN) in bf16, v4 B={B_MAIN} x T={x.shape[1]} (a yardstick: bf16 "
        f"state): {yardstick:.4f} ms")
    out = {}
    for name in ("faithful", *TIERS):
        tier = tier_of(name)
        t = {"stft_magnitude_at": {}, "cudnn_bf16_lstm": yardstick}
        for family, (chunks, kw) in audio.items():
            mode = stft_mode_of(family, name)
            wr, wi = split_basis_of(models[family][1])
            ms, plain_ms = cuda_ms_pair(lambda: stft_magnitude(chunks, wr, wi, **kw, mode=mode),
                                        lambda: stft_magnitude_reference(chunks, wr, wi, **kw,
                                                                         mode=mode))
            spect = stft_magnitude(chunks, wr, wi, **kw, mode=mode)
            n_fft, bins = wr.shape
            bound, by = products_bound_ms(
                4 * (chunks.numel() + 2 * n_fft * bins + spect.numel()),
                (spectrum_flops(spect.shape[0] * spect.shape[1], n_fft, bins), mode))
            t["stft_magnitude_at"][f"{family} B={B_MAIN} x {chunks.shape[1]}"] = {
                "mode": mode, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            if family == "v4":
                t["stft_magnitude"] = (ms, plain_ms)
                t["stft_magnitude_bound"] = (bound, by)
        w, b = p4["lstm_w"], p4["lstm_b"]
        wt = weight_of(p4, tier)
        t["lstm_fused"] = cuda_ms_pair(lambda: lstm_fused(x, h, c, w, b, wt=wt, tier=tier),
                                       lambda: lstm_fused_reference(x, h, c, w, b, tier))
        for family, chunk in (("v4", V4_CHUNK), ("v5", V5_CHUNK)):
            module, params = models[family]
            runner = StreamRunner(family, params, device=device, precision=name)
            state = runner.init_state(B_MAIN)
            steps = torch.from_numpy(speech_chunks(B_MAIN, chunk, seed=SEED + 401)).to(device)
            t[f"step_{family}"] = cuda_ms(lambda: runner.step(steps, state))
        out[name] = t
        log(f"time tier {name} (v4/v5): stft_magnitude "
            + ", ".join(f"{k} [{v['mode']}] {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
                        f"{v['bound_ms']:.4f} by {v['bound_by']})"
                        for k, v in t["stft_magnitude_at"].items())
            + f"; lstm_fused v4 B={B_MAIN} x T={x.shape[1]} {t['lstm_fused'][0]:.4f} ms (plain "
            f"{t['lstm_fused'][1]:.4f}); step v4 B={B_MAIN} {t['step_v4']:.4f} ms, v5 "
            f"{t['step_v5']:.4f} ms")
    return out


# ---- the tools (phase_tools): the regression tier, its two probes, the
# accuracy evaluation, the export modules, the serving bench and the soak

#: the probes' kernels: name -> the Pallas call each replaces
PROBE_KERNELS = {"bf16_dot": "tools/tpu_check.py:54", "bf16_dot_wgmma": "tools/tpu_check.py:54",
                 "concat_dot": "tools/tpu_check.py:77"}
#: the phase's serving bench (clients, seconds, rtf) and soak (minutes of audio)
TOOLS_SERVE = (64, 10.0, 4.0)
TOOLS_SOAK_MINUTES = 10.0
TOOLS_UTTERANCES = 16  # the accuracy evaluation's utterances, v3.1
TOOLS_DEGRADATION_UTTERANCES = 4  # the degradation matrix's (the CPU's rows cost most)
TOOLS_PHASE_LIMIT_S = 120.0


def v31_state_dict_from_archive(archive: dict) -> dict:
    """A plain Silero v3.1 state_dict (`encoder.sequential.{i}` names) that
    export/torch_export.py's v31_archive_from_state_dict maps back onto
    `archive`: the inverse of its mapping. The fused LSTM weight is split
    into its ih and hh halves; the fused bias becomes bias_ih with a bias_hh
    of -0.0, whose sum gives every value back bit for bit."""
    from vadc_tpu_torch.export import torch_export as te

    sd = {"feature_extractor.forward_basis_buffer": archive["forward_basis_buffer"]}
    for i, (base, has_proj) in enumerate(zip(te._V3_STAGE_BASES, te._V3_HAS_PROJ)):
        prefix = f"transformer_l{i + 1}."
        cb = "first_layer." if i == 0 else f"encoder.sequential.{base}."
        for key, sub in te._CONVBLOCK_SUBKEYS.items():
            if has_proj or not key.startswith("proj"):
                sd[cb + sub] = archive[prefix + key]
        tl = base if i == 0 else base + 1
        for key, sub in te._TRANSFORMER_SUBKEYS.items():
            sd[f"encoder.sequential.{tl}.{sub}"] = archive[prefix + key]
        sd[f"encoder.sequential.{tl + 1}.weight"] = archive[prefix + "conv_weights"]
        sd[f"encoder.sequential.{tl + 1}.bias"] = archive[prefix + "conv_biases"]
        for key, sub in te._BN_SUBKEYS.items():
            sd[f"encoder.sequential.{tl + 2}.{sub}"] = archive[prefix + key]
    half = archive["weights"].shape[-1] // 2
    for layer in range(archive["weights"].shape[0]):
        sd[f"lstm.weight_ih_l{layer}"] = archive["weights"][layer][:, :half]
        sd[f"lstm.weight_hh_l{layer}"] = archive["weights"][layer][:, half:]
        sd[f"lstm.bias_ih_l{layer}"] = archive["biases"][layer]
        sd[f"lstm.bias_hh_l{layer}"] = np.full_like(archive["biases"][layer], -0.0)
    sd["decoder.1.weight"] = archive["decoder_weights"]
    sd["decoder.1.bias"] = archive["decoder_biases"]
    return sd


def tools_accuracy(device) -> None:
    """torch_accuracy_eval's evaluate at every tier on v3.1: balanced and
    fast score as faithful; turbo's row is logged."""
    from tools import torch_accuracy_eval as acc

    keys = ("frame_f1", "segment_precision", "segment_recall")
    rows = {tier: acc.evaluate(n_utterances=TOOLS_UTTERANCES, precision=tier, device=device)
            for tier in ("faithful",) + TIERS}
    for tier, row in rows.items():
        log(f"accuracy {tier} ({TOOLS_UTTERANCES} utterances, {row['audio_seconds']} s): "
            + ", ".join(f"{k} {row[k]}" for k in keys)
            + ("" if tier != "turbo" else " (logged, not held)"))
    for tier in ("balanced", "fast"):
        require(all(rows[tier][k] == rows["faithful"][k] for k in keys),
                f"accuracy: {tier} scores {[rows[tier][k] for k in keys]}, faithful "
                f"{[rows['faithful'][k] for k in keys]}")


def tools_degradation(device) -> None:
    """The degradation matrix at faithful on the card against the CPU:
    identical rows."""
    from tools import torch_accuracy_eval as acc

    card = acc.degradation_matrix(n_utterances=TOOLS_DEGRADATION_UTTERANCES, device=device)
    cpu = acc.degradation_matrix(n_utterances=TOOLS_DEGRADATION_UTTERANCES, device="cpu")
    for row in card["rows"]:
        log(f"degradation {row['degradation']}: frame_f1 {row['frame_f1']}, segments "
            f"{row['segments_matched']}/{row['segments_truth']} (detected "
            f"{row['segments_detected']})")
    require(card["rows"] == cpu["rows"], "degradation matrix: the card's rows differ from the CPU's")
    log(f"degradation matrix: {len(card['rows'])} rows, card identical to CPU")


def tools_pack_and_export(device, root: Path) -> None:
    """A pack of the bundled v3.1 archive, imported and loaded on the card:
    its params the bundled ones and its step their bits; then torch_export
    of a state dict built from the archive: the archive's bytes."""
    import importlib.util

    import torch

    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.export.pack import pack
    from vadc_tpu_torch.export.torch_export import v31_archive_from_state_dict
    from vadc_tpu_torch.io.testtensor import load_testtensor, save_testtensor
    from vadc_tpu_torch.models.weights import load_params

    pack(DEFAULT_WEIGHTS, root / "embedded_v31.py")
    spec = importlib.util.spec_from_file_location("embedded_v31", root / "embedded_v31.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    family, packed = module.load(device=device)
    want_family, bundled = load_params(DEFAULT_WEIGHTS, device=device)
    require(family == want_family == "v3", f"pack: family {family}")
    require(packed["lstm_w"].device == device, f"pack: params on {packed['lstm_w'].device}")
    chunks = torch.from_numpy(speech_chunks(B_MAIN, CHUNK, seed=SEED + 1200)).to(device)
    got = []
    for p in (packed, bundled):
        runner = StreamRunner("v3", p, device=device)
        state = runner.init_state(B_MAIN)
        probs, state = runner.step(chunks, state)
        got.append((probs, state.h, state.c))
    if device.type == "cuda":
        torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*got)),
            "pack: the packed params' step differs from the bundled params'")
    log(f"pack: {DEFAULT_WEIGHTS.name} as a module of {(root / 'embedded_v31.py').stat().st_size} "
        f"bytes, loaded on {device}: the v3.1 step at B={B_MAIN} bit for bit the bundled params'")
    sd = v31_state_dict_from_archive(load_testtensor(DEFAULT_WEIGHTS))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    save_testtensor(root / "exported.testtensor", v31_archive_from_state_dict(sd))
    same = (root / "exported.testtensor").read_bytes() == DEFAULT_WEIGHTS.read_bytes()
    require(same, "torch_export: the exported archive's bytes differ from the bundled archive's")
    log(f"torch_export: a state dict of {len(sd)} tensors from the bundled archive exports "
        "its bytes exactly")


def tools_serving(device) -> dict:
    from tools.torch_serve_bench import run_serving_bench

    clients, seconds, rtf = TOOLS_SERVE
    r = run_serving_bench(n_clients=clients, seconds=seconds, rtf=rtf, faults=True,
                          checkpoint=True, device=device)
    log(f"serve bench ({clients} clients, {seconds} s, rtf {rtf}, {r['precision']}, faults and "
        f"checkpoints on): tick p50 {r['tick_p50_ms']} ms, p99 {r['tick_p99_ms']} ms over "
        f"{r['ticks_measured']} ticks (tick_count {r['tick_count']}, catch-up "
        f"{r['catchup_ticks']}), {r['aggregate_realtime_x']} x realtime in all, RSS warm-up "
        f"{r['rss_warmup_mb']} MB, growth after {r['rss_postwarm_growth_mb']} MB; "
        f"delivery exact {r['delivery_exact']}/{clients}, checkpoint saves {r['ckpt_saves']} "
        f"(p50 {r['ckpt_save_p50_ms']} ms)")
    log(f"serve bench result: {json.dumps(r)}")
    require(r["delivery_exact"] == clients and r["client_errors"] == 0,
            f"serve bench: {r['delivery_exact']}/{clients} clients got every segment, "
            f"{r['client_errors']} errors")
    require(r["rss_postwarm_ok"], f"serve bench: RSS grew {r['rss_postwarm_growth_mb']} MB")
    require(r["fault_slowreader_delivery_exact"] and r["post_fault_delivery_exact"]
            and r["fault_malformed_diagnosed"] == r["fault_malformed"],
            "serve bench: a fault client broke delivery")
    return r


def tools_soak(device) -> dict:
    from tools.torch_soak import soak

    r = soak(minutes=TOOLS_SOAK_MINUTES, device=device)
    log(f"soak: {r['audio_seconds'] / 60:.1f} min of audio ({r['family']}, {r['precision']}) in "
        f"{r['wall_seconds']:.2f} s, {r['realtime_x']:.1f} x realtime, {r['segments']} segments, "
        f"RSS {r['rss_warm_mb']:.0f} -> {r['rss_end_mb']:.0f} MB")
    require(r["rss_growth_mb"] <= 64.0, f"soak: RSS grew {r['rss_growth_mb']:.1f} MB")
    return r


def phase_tools(device, totals: dict) -> dict:
    """The regression tier and the tools on the card, their launches counted
    in this window alone (each probe > 0): tools/gpu_check.run_checks (ok
    required; the probes exact at their own inputs, within their limits at
    seeded shapes, both controls broken), the accuracy evaluation at every
    tier, the degradation matrix card against CPU, a pack loaded on the
    card, torch_export's bytes, the serving bench and the soak; then the
    probes timed (outside the counted window). Returns the probes' rows:
    name -> (max_abs_err, timings)."""
    from tools import gpu_check

    t0 = time.perf_counter()
    zero_launches()
    summary = gpu_check.run_checks(device)
    require(summary["ok"], f"gpu_check: failures {summary['failures']}")
    log(f"gpu_check: {json.dumps(summary)}")
    tools_accuracy(device)
    tools_degradation(device)
    with tempfile.TemporaryDirectory() as tmp:
        tools_pack_and_export(device, Path(tmp))
    tools_serving(device)
    tools_soak(device)
    counts = read_launches("tools", totals, tuple(PROBE_KERNELS))
    log(f"elapsed in the tools phase before the probes' timings: {time.perf_counter() - t0:.1f} s")
    timings = gpu_check.probe_timings(device)
    seconds = time.perf_counter() - t0
    log(f"the tools phase took {seconds:.1f} s (limit {TOOLS_PHASE_LIMIT_S:.0f} s)")
    require(seconds < TOOLS_PHASE_LIMIT_S, f"the tools phase took {seconds:.1f} s")
    res = summary["results"]
    errs = {"bf16_dot": res["probe_bf16_dot_seeded"],
            "bf16_dot_wgmma": res["probe_bf16_dot_wgmma_seeded"],
            "concat_dot": res["probe_concat_dot_vs_bf16_3x_seeded"]}
    return {name: (counts[name], errs[name], timings[name]) for name in PROBE_KERNELS}


# ---- the ported tools (phase_ported_tools): per-stage timing, the v5
# validation harness, the RSS attribution, the host-ingest ceiling, the
# tensor image dump

#: torch_bench_stages' loops in this phase (T short, T long; the tool's
#: defaults are 16 and 336), at B=B_MAIN and fast
PORTED_STAGES = (8, 72)
PORTED_RSS = (8, 6.0, 4.0)  # torch_rss_attrib's clients, seconds, rtf
PORTED_INGEST = (512, 2.0)  # run_ingest's pipes and seconds
PORTED_TOOLS_PHASE_LIMIT_S = 150.0
PORTED_KERNELS = ("forward_fused", "encode_fused_audio", "stft_magnitude", "lstm_fused")


def ported_validate_v5() -> None:
    """torch_validate_v5 on the synthetic v5 graph (the JAX tool's test's
    seeds), on the card: PASSED at its default atol."""
    from tools import torch_validate_v5

    from vadc_tpu_torch.export.onnx_build import build_silero_v5_onnx
    from vadc_tpu_torch.models.synthetic import random_v5_8k_archive, random_v5_archive

    with tempfile.TemporaryDirectory() as tmp:
        graph = Path(tmp) / "silero_v5_synthetic.onnx"
        build_silero_v5_onnx(graph, random_v5_archive(7), random_v5_8k_archive(8))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = torch_validate_v5.main([str(graph)])
    for line in out.getvalue().splitlines():
        log(f"validate_v5: {line}")
    require(rc == 0 and "V5 VALIDATION PASSED" in out.getvalue(),
            f"torch_validate_v5 exited {rc} on the synthetic v5 graph")


def ported_tensor_image() -> None:
    """torch_tensor_image on the bundled v3.1 archive: a PGM file a tensor."""
    from tools import torch_tensor_image

    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.io.testtensor import load_testtensor

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = torch_tensor_image.main([str(DEFAULT_WEIGHTS), "", tmp])
        n = len(list(Path(tmp).glob("*.pgm")))
    want = len(load_testtensor(DEFAULT_WEIGHTS))
    require(rc == 0 and n == want, f"tensor_image: {n} images of {want} tensors (exit {rc})")
    log(f"tensor_image: {n} PGM images of {DEFAULT_WEIGHTS.name}'s {want} tensors")


def phase_ported_tools(device, totals: dict) -> None:
    """The five ported tools on the card, their launches counted in this
    window alone (each of PORTED_KERNELS > 0)."""
    from tools import torch_bench_stages, torch_ingest_bench, torch_rss_attrib

    t0 = time.perf_counter()
    zero_launches()
    t_short, t_long = PORTED_STAGES
    for family in ("v3", "v4", "v5"):
        r = torch_bench_stages.run_stages(family, batch=B_MAIN, precision="fast",
                                          t_short=t_short, t_long=t_long, device=device)
        require(r["full_equals_forward"], f"bench_stages {family}: the full prefix is not forward")
        torch_bench_stages.print_rows(r)
    ported_validate_v5()
    clients, seconds, rtf = PORTED_RSS
    rss = torch_rss_attrib.run_rss_attrib(clients, seconds, rtf, precision="turbo", device=device)
    log(f"rss_attrib ({clients} clients, {seconds} s at rtf {rtf}, turbo): post-warm "
        f"{rss['postwarm_s']:.1f} s, {rss['postwarm_ticks']} ticks (tick_count "
        f"{rss['tick_count']}); RSS growth {rss['rss_growth_mb']:.1f} MB "
        f"({rss['rss_growth_mb_per_s']:.2f} MB/s), tracemalloc (Python) "
        f"{rss['python_growth_mb']:.1f} MB, native residual {rss['native_residual_mb']:.1f} MB; "
        f"RSS series {json.dumps(rss['rss_series'])}")
    require(rss["client_errors"] == 0 and rss["postwarm_ticks"] > 0,
            f"rss_attrib: {rss['client_errors']} client errors {rss['errors']}, "
            f"{rss['postwarm_ticks']} ticks after warm-up")
    streams, ingest_s = PORTED_INGEST
    for with_fsm in (False, True):
        r = torch_ingest_bench.run_ingest(streams, ingest_s, with_fsm=with_fsm)
        log(f"ingest {'gather+fsm' if with_fsm else 'gather-only'}: {r['streams']} pipes, "
            f"{r['mb_per_s_s16']} MB/s = {r['realtime_streams_equiv']} realtime streams equiv "
            f"({r['chunks_drained']} chunks / {r['seconds']} s, {r['gathers']} gathers)")
        require(r["chunks_drained"] > 0, "ingest: no chunk drained")
    ported_tensor_image()
    read_launches("ported tools", totals, PORTED_KERNELS)
    seconds = time.perf_counter() - t0
    log(f"the ported tools phase took {seconds:.1f} s (limit {PORTED_TOOLS_PHASE_LIMIT_S:.0f} s)")
    require(seconds < PORTED_TOOLS_PHASE_LIMIT_S, f"the ported tools phase took {seconds:.1f} s")


# ---- the live-stream examples (phase_examples): examples/serve_streams_torch.py
# and examples/serve_pool_torch.py, each by its main(argv) in this process

EXAMPLE_FILES = 16  # distinct seeded speech files of different lengths; the streams repeat them
EXAMPLE_PRODUCERS = 256  # serve_pool_torch's producers (and a serve_streams_torch run beside it)
EXAMPLE_SUBSET = 16  # the streams run again with --device cpu
EXAMPLES_PHASE_LIMIT_S = 240.0
EXAMPLE_KERNELS = ("forward_fused", "stft_magnitude", "lstm_fused")


class FsmRecord:
    """What one run's NativeFsm was fed and gave back: per feed call the
    probabilities [B], the active mask (None: every stream) and the events
    (stream, start, end) in chunks."""

    def __init__(self) -> None:
        self.n = 0
        self.calls: list = []

    def stream_probs(self) -> list:
        """Per stream its probabilities in its own chunk order."""
        if not self.calls:
            return [np.zeros(0, np.float32)] * self.n
        probs = np.stack([p for p, _, _ in self.calls])
        active = np.stack([np.ones(self.n, bool) if a is None else a for _, a, _ in self.calls])
        return [probs[active[:, s], s] for s in range(self.n)]

    def events(self, before: list | None = None) -> list:
        """Per stream its events (start, end) in order; with `before`, only
        those the FSM gave while it was fed one of the stream's first
        before[s] chunks (serve_streams_torch feeds zeros past a file's end,
        serve_pool_torch stops there)."""
        fed = np.zeros(self.n, np.int64)
        out: list = [[] for _ in range(self.n)]
        for _, active, events in self.calls:
            for s, a, b in events:
                if before is None or fed[s] < before[s]:
                    out[s].append((a, b))
            fed += 1 if active is None else active
        return out


@contextlib.contextmanager
def recording_fsm(native_module):
    """native_module.NativeFsm, while the context lasts, a subclass that
    records into the FsmRecord it yields (vadc_tpu_torch.native, or the JAX
    package's native module in the CPU tests: the same API)."""
    record = FsmRecord()
    base = native_module.NativeFsm

    class Recording(base):
        def __init__(self, n_streams, **kw):
            super().__init__(n_streams, **kw)
            record.n = n_streams

        def feed(self, probs, active=None):
            events = super().feed(probs, active)
            record.calls.append((np.array(probs, np.float32)[:, 0],
                                 None if active is None else np.array(active, bool), events))
            return events

    native_module.NativeFsm = Recording
    try:
        yield record
    finally:
        native_module.NativeFsm = base


def lines_by_file(text: str) -> dict:
    """An example's stdout, `<file>\\t<start>,<end>` lines, as file -> its
    segments in order."""
    out: dict = {}
    for line in text.splitlines():
        path, seg = line.split("\t")
        out.setdefault(path, []).append(seg)
    return out


def record_lines(record: FsmRecord, files: list, spc: float, before: list | None = None) -> dict:
    """The lines an example prints for the recorded events, file -> segments."""
    out: dict = {}
    for path, events in zip(files, record.events(before)):
        if events:
            out[path] = [f"{a * spc:.2f},{b * spc:.2f}" for a, b in events]
    return out


def compare_events(label: str, got: dict, want: dict, want_probs: dict, spc: float,
                   bound: float, thresholds: tuple) -> list:
    """got against want (file -> segments, lines_by_file): per file the same
    events in the same order; a boundary may move by one chunk only where the
    reference's probability at the earlier of the two chunks lies within
    `bound` of a threshold (want_probs: file -> the reference run's
    probabilities). Raises otherwise; returns one note per such move."""
    notes = []
    for path in sorted(set(got) | set(want)):
        g, w = got.get(path, []), want.get(path, [])
        require(len(g) == len(w), f"{label}: {path}: {len(g)} events against {len(w)}: {g} vs {w}")
        for gs, ws in zip(g, w):
            for gb, wb in zip(gs.split(","), ws.split(",")):
                gi, wi = round(float(gb) / spc), round(float(wb) / spc)
                if gi == wi:
                    continue
                k = min(gi, wi)
                p = float(want_probs[path][k]) if k < len(want_probs[path]) else float("nan")
                near = min(abs(p - t) for t in thresholds)
                note = (f"{label}: {path}: a boundary at chunk {wi} moved to {gi}; the reference's "
                        f"probability at chunk {k} is {p:.6f}, {near:.2e} from a threshold "
                        f"(bound {bound:g})")
                require(abs(gi - wi) == 1 and near <= bound, f"{note}: {gs} against {ws}")
                notes.append(note)
    return notes


@functools.cache
def example(name: str):
    """examples/<name>.py as a module (loaded once)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(name: str, argv: list) -> tuple:
    """An example's main(argv) in this process, its NativeFsm recorded:
    (stdout, stderr, FsmRecord); raises unless it exits 0."""
    from vadc_tpu_torch import native

    out, err = io.StringIO(), io.StringIO()
    with recording_fsm(native) as record, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = example(name).main(argv)
    require(rc == 0, f"{name} exited {rc}: {err.getvalue()}")
    return out.getvalue(), err.getvalue(), record


def fsm_thresholds() -> tuple:
    """The examples' FSM thresholds (threshold, neg_threshold)."""
    from vadc_tpu_torch.cli.segmenter import SegmenterConfig

    cfg = SegmenterConfig.from_ms(chunk_samples=CHUNK)
    return cfg.threshold, cfg.neg_threshold


def example_inputs(root: Path) -> list:
    """EXAMPLE_FILES seeded speech files (speech_track of seeds 0..15, cut
    to 8 to 11.75 s and a part of a chunk), and B_MAIN stream paths: a link
    each, stream i to file i mod EXAMPLE_FILES, so each stream's lines carry
    a name of their own."""
    src = root / "files"
    src.mkdir()
    files = []
    for i in range(EXAMPLE_FILES):
        audio = speech_track(seed=i).ravel()[: int((8.0 + 0.25 * i) * SR) + 101 * i]
        path = src / f"speech{i:02d}.s16le"
        np.clip(audio * 32768, -32768, 32767).astype("<i2").tofile(path)
        files.append(path)
    streams = root / "streams"
    streams.mkdir()
    paths = []
    for i in range(B_MAIN):
        link = streams / f"s{i:04d}.s16le"
        link.symlink_to(files[i % EXAMPLE_FILES])
        paths.append(str(link))
    return paths


def examples_of_model(label: str, paths: list, extra: list, bound: float, spc: float) -> None:
    """One model and tier through both examples: serve_streams_torch over
    B_MAIN streams and over EXAMPLE_PRODUCERS, serve_pool_torch over
    EXAMPLE_PRODUCERS producers (the same streams: its events per file those
    of serve_streams_torch over them while the file lasts, bit for bit: every
    tick steps all the rows, so cuBLAS sums each row alike), and
    serve_streams_torch over EXAMPLE_SUBSET streams with --device cpu (the
    card's events under compare_events' rule, the CPU the reference)."""
    smi = nvidia_smi()
    out, err, _ = run_example("serve_streams_torch", [*extra, *paths])
    log(f"serve_streams_torch {label}, {len(paths)} streams: {err.strip()} ({smi})")
    card = lines_by_file(out)
    few = paths[:EXAMPLE_PRODUCERS]
    _, _, streams = run_example("serve_streams_torch", [*extra, *few])
    out, err, pool = run_example("serve_pool_torch", [*extra, *few])
    log(f"serve_pool_torch {label}, {len(few)} producers: {err.strip()} ({smi})")
    lengths = [len(p) for p in pool.stream_probs()]
    want = record_lines(streams, few, spc, before=lengths)
    require(lines_by_file(out) == want,
            f"serve_pool_torch {label}: events differ from serve_streams_torch's per file")
    masked = sum(a is not None and not a.all() for _, a, _ in pool.calls)
    diff = max(float(np.abs(p - q[: len(p)]).max()) if len(p) else 0.0
               for p, q in zip(pool.stream_probs(), streams.stream_probs()))
    log(f"serve_pool_torch {label}: {sum(map(len, want.values()))} events equal "
        f"serve_streams_torch's per file; {len(pool.calls)} ticks, {masked} with streams masked "
        f"out; chunk lengths {min(lengths)}-{max(lengths)}; largest probability difference {diff:.3e}")
    subset = paths[:EXAMPLE_SUBSET]
    out, err, cpu = run_example("serve_streams_torch", ["--device", "cpu", *extra, *subset])
    probs = dict(zip(subset, cpu.stream_probs()))
    notes = compare_events(f"serve_streams_torch {label} card vs CPU",
                           {p: card.get(p, []) for p in subset}, lines_by_file(out), probs, spc,
                           bound, fsm_thresholds())
    for note in notes:
        log(note)
    log(f"serve_streams_torch {label}: the card's events on {len(subset)} streams those of "
        f"--device cpu ({len(notes)} moved by a borderline chunk; CPU: {err.strip()})")


def phase_examples(device, archives: dict, totals: dict) -> None:
    """The two live-stream examples on the card at full width, their
    launches counted in this window alone (each of EXAMPLE_KERNELS > 0):
    v3.1 and v4 at faithful, v3.1 at --fast, the synthetic v5 at faithful."""
    from vadc_tpu_torch.kernels import tier_check
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = example_inputs(Path(tmp))
        v5 = Path(tmp) / "v5_synthetic.testtensor"
        save_archive(v5, random_v5_archive(0))
        zero_launches()
        examples_of_model("v3.1", paths, [], TOL_PATH, CHUNK / SR)
        examples_of_model("v3.1 --fast", paths, ["--fast"], tier_check.SPEECH_BOUND["v3"]["fast"],
                          CHUNK / SR)
        examples_of_model("v4", paths, ["--model", str(archives["v4"])], TOL_PATH, V4_CHUNK / SR)
        examples_of_model("v5 (synthetic weights)", paths, ["--model", str(v5)], TOL_PATH,
                          V5_CHUNK / SR)
        read_launches("the live-stream examples", totals, EXAMPLE_KERNELS)
    seconds = time.perf_counter() - t0
    log(f"the examples phase took {seconds:.1f} s (limit {EXAMPLES_PHASE_LIMIT_S:.0f} s)")
    require(seconds < EXAMPLES_PHASE_LIMIT_S, f"the examples phase took {seconds:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.models.synthetic import random_v5_archive, save_archive
    from vadc_tpu_torch.models.weights import load_params
    from vadc_tpu_torch.runtime import require_cuda

    start = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"elapsed after {what}: {time.perf_counter() - start:.1f} s")

    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    device = require_cuda()
    phase_build()
    _, params = load_params(DEFAULT_WEIGHTS, device=device)
    archives, models = family_models(device)

    phase_shared_code(params, models, device)
    errs = phase_kernels(params, device)
    errs.update(phase_kernels_lstm_decoder(params, device))
    errs.update(phase_kernels_v45(models, device))
    tier_errs = phase_kernels_tiers(params, device)
    phase_spectrum_edges(params, models, device)
    tier_errs_v45 = phase_kernels_tiers_v45(models, device)
    fsm_row = phase_kernels_fsm(device)
    elapsed("the kernel checks")
    launches: dict = {}
    tier_launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        pcm = Path(tmp) / "synthetic.s16le"
        synthetic_file(pcm)
        phase_main_path_v3(params, device, pcm, launches)
        phase_main_path_v4(models["v4"][1], device, pcm, archives, launches)
        speech = Path(tmp) / "speech.s16le"
        speech_file(speech)
        phase_main_path_tiers(params, device, speech, tier_launches)
        phase_main_path_tiers_v45(models, archives, device, speech, tier_launches)
    phase_main_path_v5(models, device, launches)
    phase_slabs_v45(models, device, launches, tier_launches)
    elapsed("the v4/v5 slab checks")
    corpus = phase_main_path_batch(device, launches)
    phase_main_path_batch_v45(device, archives, launches)
    elapsed("the batch CLI phases")
    server_lines = phase_server(device, launches)
    elapsed("the server")
    v5_lines = phase_server_checkpoint(device, server_lines, launches, tier_launches)
    elapsed("the server checkpoints")
    phase_api(device, archives, launches)
    phase_cutter(device, launches)
    elapsed("the API and the cutter")
    phase_multi_device(params, models, device, server_lines, v5_lines, launches)
    elapsed("the multi-device phase")
    probe_rows = phase_tools(device, launches)
    elapsed("the tools phase")
    phase_ported_tools(device, launches)
    elapsed("the ported tools phase")
    phase_examples(device, archives, launches)
    elapsed("the examples phase")
    log(f"launches on the main paths, all phases: {launches}; at the bf16 tiers: {tier_launches}")
    elapsed("the main paths")
    timing = phase_timing(params, device)
    timing.update(phase_timing_v45(models, device))
    phase_timing_slabs_v45(models, device)
    slab = phase_timing_slab(params, device, corpus)
    phase_timing_variants(models, params, device)
    tier_timing = phase_timing_tiers(params, device)
    library = phase_timing_library(params, models, device)
    tier_timing_v45 = phase_timing_tiers_v45(models, device)
    with tempfile.TemporaryDirectory() as tmp:
        v5_archive = Path(tmp) / "v5_synthetic.testtensor"
        save_archive(v5_archive, random_v5_archive(0))
        time_ticks(str(DEFAULT_WEIGHTS), device, "v3.1")
        time_ticks(str(v5_archive), device, "v5 (synthetic weights)")
    phase_timing_checkpoint(device)
    phase_timing_api(device, archives)
    elapsed("the timings")

    # The bound of each kernel at the shape it was timed at: bytes are each
    # input read once and each output written once (fp32), operations the
    # multiply-adds of the shapes at 2 flops each.
    state_bytes = 4 * 2 * B_MAIN * 64 * 4  # h, c in and hn, cn out, [2, B, 64]
    v31_weights = 124_632 * 4  # the packed encoder, LSTM and decoder weights
    basis = 2 * 256 * 129 * 4  # the real and the imaginary STFT basis
    lstm_weights = (2 * 256 * 128 + 2 * 256) * 4  # two layers' fused weight and bias
    rows = B_MAIN * 25
    body_flops = B_MAIN * (v31_encoder_flops(25) + lstm_flops(7, 2, 64))
    fused2d_bound = bound_ms(body_flops, rows * 129 * 4 + state_bytes + B_MAIN * 4 + v31_weights)
    lstm_ms, lstm_plain, lstm_lib, lstm_shape, lstm_per_call = timing["lstm_fused"]
    tail_ms, tail_plain, tail_lib, tail_shape, tail_per_call = \
        slab[(SLAB_CHUNKS, SLAB_CHUNKS)]["lstm_decoder_fused"]
    tail_steps = tail_shape[0] * tail_shape[1] * tail_shape[2]
    fused_src = "vadc_tpu_torch/kernels/csrc/silero_v31_fused.cu"
    audio_src = "vadc_tpu_torch/kernels/csrc/silero_v31_fused_audio.cu"
    # forward_fused2d and forward_fused3d are one CUDA kernel; no main path
    # runs it or its encoder entry (encode_fused) since the slab route took
    # the step kernel's own front half (encode_fused_audio)
    fused_launches = launches["forward_fused2d"] + launches["encode_fused"]
    by_entry = {"forward_fused2d": launches["forward_fused2d"],
                "encode_fused": launches["encode_fused"]}
    table = [
        ("dot_magnitude", "vadc_tpu_torch/kernels/csrc/stft_dotmag.cu",
         "vadc_tpu/kernels/stft_dotmag.py:56", launches["dot_magnitude"], errs["dot_magnitude"],
         *timing["dot_magnitude"], library["dot_magnitude"],
         bound_ms(spectrum_flops(rows), B_MAIN * (CHUNK + 256) * 4 + basis + rows * 129 * 4),
         f"B={B_MAIN} x {CHUNK}", {"cublas_product_only_ms": timing["dot_magnitude_cublas"]}),
        ("silero_v31_fused", fused_src, "vadc_tpu/kernels/silero_v31_fused2d.py:232",
         fused_launches, errs["silero_v31_fused"], *timing["silero_v31_fused"], None, fused2d_bound,
         f"B={B_MAIN} x 25 frames", {"launches_by_entry": by_entry}),
        ("silero_v31_fused3d", fused_src, "vadc_tpu/kernels/silero_v31_fused3d.py:178",
         fused_launches, errs["silero_v31_fused"], *timing["silero_v31_fused"], None, fused2d_bound,
         f"B={B_MAIN} x 25 frames",
         {"launches_by_entry": by_entry, "same_kernel_as": "silero_v31_fused"}),
        ("stft_magnitude", "vadc_tpu_torch/kernels/csrc/stft_mag.cu",
         "vadc_tpu/kernels/stft_mag.py:91", launches["stft_magnitude"], errs["stft_magnitude"],
         *timing["stft_magnitude"], library["stft_magnitude"], timing["stft_magnitude_bound"],
         f"v4 B={B_MAIN} x {V4_CHUNK}",
         {"cublas_product_only_ms": timing["stft_magnitude_cublas"],
          "geometries": {label: {**at, **library["stft_magnitude_at"].get(label, {})}
                         for label, at in timing["stft_magnitude_at"].items()}}),
        ("lstm_fused", "vadc_tpu_torch/kernels/csrc/lstm.cu", "vadc_tpu/kernels/lstm.py:181",
         launches["lstm_fused"], errs["lstm_fused"], lstm_ms, lstm_plain, lstm_lib,
         bound_ms(lstm_shape[0] * lstm_flops(lstm_shape[1], 2, 64),
                  2 * lstm_shape[0] * lstm_shape[1] * 64 * 4 + state_bytes + lstm_weights),
         f"v4 B={lstm_shape[0]} x T={lstm_shape[1]}", {"variant": variant_of(*lstm_shape[:2]), "kernels_per_call": lstm_per_call}),
        ("forward_fused", "vadc_tpu_torch/kernels/csrc/silero_v31_fused_audio.cu",
         "vadc_tpu/kernels/silero_v31_fused.py:236", launches["forward_fused"], errs["forward_fused"],
         *timing["forward_fused"], None,
         bound_ms(spectrum_flops(rows) + body_flops,
                  B_MAIN * CHUNK * 4 + state_bytes + B_MAIN * 4 + v31_weights + basis),
         f"B={B_MAIN} x {CHUNK}", {}),
        # the same source's second entry, the slab route's front half: it
        # replaces no Pallas kernel of its own (the JAX package leaves its
        # encoder to XLA) and is listed under the kernel it is cut from
        ("encode_fused_audio", audio_src, "vadc_tpu/kernels/silero_v31_fused.py:236",
         launches["encode_fused_audio"], errs["encode_fused_audio"],
         *timing["encode_fused_audio"], None,
         bound_ms(spectrum_flops(rows) + B_MAIN * v31_encoder_flops(25),
                  B_MAIN * CHUNK * 4 + B_MAIN * 7 * 64 * 4 + v31_weights + basis),
         f"B={B_MAIN} x {CHUNK}", {"entry_of": "forward_fused"}),
        ("lstm_decoder_fused", "vadc_tpu_torch/kernels/csrc/lstm_decoder.cu",
         "vadc_tpu/kernels/lstm.py:132", launches["lstm_decoder_fused"], errs["lstm_decoder_fused"],
         tail_ms, tail_plain, tail_lib,
         bound_ms(lstm_flops(tail_steps, 2, 64),
                  tail_steps * 64 * 4 + 4 * 2 * tail_shape[0] * 64 * 4
                  + tail_shape[0] * tail_shape[1] * 4 + lstm_weights + (2 * 64 + 2) * 4),
         f"B={tail_shape[0]} x K={tail_shape[1]} x T={tail_shape[2]}",
         {"variant": variant_of(tail_shape[0], tail_shape[1] * tail_shape[2]),
          "kernels_per_call": tail_per_call}),
        # no Pallas kernel is its counterpart: the JAX package's FSM is a
        # lax.scan; bytes: probabilities in, [3, T, B] events out, the
        # state (a byte and two int32 a stream) in and out, valid_chunks in
        ("fsm_scan", "vadc_tpu_torch/kernels/csrc/fsm_scan.cu",
         "vadc_tpu/engine/vectorized_segmenter.py:96", launches["fsm_scan"], fsm_row["err"],
         fsm_row["ms"], fsm_row["plain_ms"], None,
         bound_ms(0.0, FSM_STREAMS * FSM_COLS * 4 * (1 + 3) + FSM_STREAMS * (2 * 9 + 4)),
         f"B={FSM_STREAMS} x T={FSM_COLS}",
         {"device_ms": fsm_row["device_ms"], "plain_device_ms": fsm_row["plain_device_ms"],
          "ms_is": "CUDA events around 20 calls in a row (the host's cost of a call where it "
                   "exceeds the device's)"}),
    ]
    # each tier instance of the v3.1 path's kernels, with the tier's bound
    slab_rows = SLAB_CHUNKS * SLAB_CHUNKS
    slab_steps = slab_rows * 7
    tier_table = (
        ("forward_fused", audio_src, "vadc_tpu/kernels/silero_v31_fused.py:236", "forward_fused",
         (spectrum_flops(rows), body_flops,
          B_MAIN * CHUNK * 4 + state_bytes + B_MAIN * 4 + v31_weights + basis), f"B={B_MAIN} x {CHUNK}"),
        ("encode_fused_audio", audio_src, "vadc_tpu/kernels/silero_v31_fused.py:236",
         "encode_fused_audio",
         (spectrum_flops(rows), B_MAIN * v31_encoder_flops(25),
          B_MAIN * CHUNK * 4 + B_MAIN * 7 * 64 * 4 + v31_weights + basis), f"B={B_MAIN} x {CHUNK}"),
        ("silero_v31_fused", fused_src, "vadc_tpu/kernels/silero_v31_fused2d.py:232",
         "forward_fused2d", (0.0, body_flops, rows * 129 * 4 + state_bytes + B_MAIN * 4 + v31_weights),
         f"B={B_MAIN} x 25 frames"),
        ("lstm_decoder_fused", "vadc_tpu_torch/kernels/csrc/lstm_decoder.cu",
         "vadc_tpu/kernels/lstm.py:132", "lstm_decoder_fused",
         (0.0, lstm_flops(slab_steps, 2, 64),
          slab_steps * 64 * 4 + 4 * 2 * SLAB_CHUNKS * 64 * 4 + slab_rows * 4 + lstm_weights
          + (2 * 64 + 2) * 4), f"B={SLAB_CHUNKS} x K={SLAB_CHUNKS} x T=7"),
        ("dot_magnitude", "vadc_tpu_torch/kernels/csrc/stft_dotmag.cu",
         "vadc_tpu/kernels/stft_dotmag.py:56", "dot_magnitude",
         (spectrum_flops(rows), 0.0, B_MAIN * (CHUNK + 256) * 4 + basis + rows * 129 * 4),
         f"B={B_MAIN} x {CHUNK}"),
    )
    for tier in TIERS:
        for name, src, replaces, counter, (spec, body, nbytes), shape in tier_table:
            ms, plain_ms = tier_timing[tier][name]
            extra = {"tier": tier}
            if name == "dot_magnitude" and tier == "fast":
                extra["cublas_bf16_product_only_ms"] = tier_timing["fast"]["cublas_bf16"]
            if name == "lstm_decoder_fused":
                extra["cudnn_bf16_lstm_yardstick_ms"] = tier_timing[tier]["cudnn_bf16_lstm"]
            table.append((f"{name}[{tier}]", src, replaces, tier_launches[tier].get(counter, 0),
                          tier_errs[tier][counter],
                          ms, plain_ms, None, tier_bound_ms(spec, body, nbytes, tier), shape, extra))
    # each tier instance of the v4/v5 paths' kernels (the v4 shapes; every
    # family geometry of stft_magnitude under "geometries")
    lstm_bytes = 2 * lstm_shape[0] * lstm_shape[1] * 64 * 4 + state_bytes + lstm_weights
    for tier in TIERS:
        tv = tier_timing_v45[tier]
        table.append((f"stft_magnitude[{tier}]", "vadc_tpu_torch/kernels/csrc/stft_mag.cu",
                      "vadc_tpu/kernels/stft_mag.py:91", tier_launches[tier].get("stft_magnitude", 0),
                      tier_errs_v45[tier]["stft_magnitude"], *tv["stft_magnitude"], None,
                      tv["stft_magnitude_bound"], f"v4 B={B_MAIN} x {V4_CHUNK}",
                      {"tier": tier, "mode": stft_mode_of("v4", tier),
                       "geometries": tv["stft_magnitude_at"]}))
        table.append((f"lstm_fused[{tier}]", "vadc_tpu_torch/kernels/csrc/lstm.cu",
                      "vadc_tpu/kernels/lstm.py:181", tier_launches[tier].get("lstm_fused", 0),
                      tier_errs_v45[tier]["lstm_fused"], *tv["lstm_fused"], None,
                      tier_bound_ms(0.0, lstm_shape[0] * lstm_flops(lstm_shape[1], 2, 64), lstm_bytes,
                                    tier),
                      f"v4 B={lstm_shape[0]} x T={lstm_shape[1]}",
                      {"tier": tier, "variant": variant_of(*lstm_shape[:2]),
                       "cudnn_bf16_lstm_yardstick_ms": tv["cudnn_bf16_lstm"]}))
    # the two probes of tools/tpu_check.py, at the v4 gate product's shape;
    # every shape they were timed at under "at"
    for name, (n, err, at) in probe_rows.items():
        gate = next(label for label in at if label.startswith("gate"))
        g = at[gate]
        table.append((name, "vadc_tpu_torch/kernels/csrc/probes.cu", PROBE_KERNELS[name], n, err,
                      g["ms"], g["plain_ms"], g["library_ms"], (g["bound_ms"], g["bound_by"]),
                      gate, {"at": at, "ms_is": "device time (torch.profiler)",
                             "library_call": g["library_call"]}))
    kernels = []
    for name, src, replaces, n, err, ms, plain_ms, library_ms, (bound, by), shape, extra in table:
        if name.split("[")[0] in OFF_PATH_KERNELS:
            extra = {**extra, "on_a_main_path": False}
        else:
            require(n > 0, f"{name}: no launch on any main path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
                        "shape": shape, "bound_share": bound / ms, **extra})
        log(f"kernel {name} at {shape}: {ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({100 * bound / ms:.1f} % of the kernel's time), plain {plain_ms:.4f} ms, library "
            + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
            + f", {n} launches on the main paths")
    # encode_fused, the encoder entry of silero_v31_fused.cu, with its own bound
    for shape_key in ((SLAB_CHUNKS, SLAB_CHUNKS), (B_MAIN, SCAN_CHUNKS)):
        part = slab[shape_key]
        n_rows = part["rows"]
        enc_bound, enc_by = bound_ms(n_rows * v31_encoder_flops(25),
                                     n_rows * (25 * 129 + 7 * 64) * 4 + v31_weights)
        audio_bound, audio_by = bound_ms(
            spectrum_flops(n_rows * 25) + n_rows * v31_encoder_flops(25),
            n_rows * (CHUNK + 7 * 64) * 4 + v31_weights + basis)
        log(f"kernel encode_fused at {n_rows} rows x 25 frames: {part['encode_fused'][0]:.4f} ms, "
            f"bound {enc_bound:.4f} ms by {enc_by} ({100 * enc_bound / part['encode_fused'][0]:.1f} "
            f"%), plain {part['encode_fused'][1]:.4f} ms, {launches['encode_fused']} launches on "
            f"the main paths; encode_fused_audio at {n_rows} rows x {CHUNK}: "
            f"{part['encode_fused_audio'][0]:.4f} ms, bound {audio_bound:.4f} ms by {audio_by} "
            f"({100 * audio_bound / part['encode_fused_audio'][0]:.1f} %), plain "
            f"{part['encode_fused_audio'][1]:.4f} ms")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
