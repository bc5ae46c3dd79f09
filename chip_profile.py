#!/usr/bin/env python3
"""Profile one StreamRunner step, one server tick and one slab scan of the
PyTorch/CUDA port on one card.

    python3 chip_profile.py
    python3 chip_profile.py split    # the step kernel's phase split alone
    python3 chip_profile.py probes   # the probes' knock-outs and phases alone

Runs 20 steps of `StreamRunner.step` over 2048 streams of 1536-sample
chunks of synthetic speech (chip_smoke.speech_chunks, seed 300) with the
LSTM state carried, under torch.profiler, after 10 warm-up steps; then 20
`_tick`s of a 2048-slot v3.1 server (vadc_tpu_torch.server, every slot
active, the same audio as s16) the same way; then 20 `StreamRunner.scan`s of
one corpus slab, 64 streams x 64 chunks (the slab route: the front-end,
encode_fused_audio and one lstm_decoder_fused). Prints for each:
  - host wall ms per call with the profiler on, the device's busy ms per
    call (the sum of the CUDA kernel and copy times), device events per
    call, and the idle share 1 - busy / wall;
  - the 30 device events that take the most time, per call;
  - host wall ms per call of the same loop without the profiler.
Then the step kernel's time by phase (`phase_split`), for the instance of
each precision tier: a second library of the same source, built with
-DVADC_PHASE_PROBE, stamps clock64() at every phase boundary in the first
512 blocks; printed per phase as the mean over those blocks, in
microseconds (cycles scaled by each block's own span on the card's
nanosecond timer) and as a share of the block's life, at B=2048 x 1536 (all
blocks resident together with their neighbours) and at B=4 (one block
alone). With the argument `split`, only that, the `ptxas` registers and
spills and `HMMA` counts of every instance, and the bf16 tiers' recurrent
kernels at B=2048 with 1, 2, 4 and 8 streams a block (`lstm_streams`). The
package's own library carries no stamp. Then
stft_magnitude at the v4 step (B=2048), the v4 CLI window (96 chunks) and
the v5_8k step the same way (device time against host time), and
`spectrum_variants`: the standalone spectrum built with other template
constants and with one part knocked out, timed against the shipped build.
With the argument `probes`, only `probe_variants`: the two probes of
tools/tpu_check.py (csrc/probes.cu) at the v4 gate product's shape, built
with one part knocked out and timed against the shipped build, and built
with clock64() stamps at their phase boundaries.
Imports nothing of JAX. Exits 1 without a card.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

BATCH = 2048
CHUNK = 1536
STEPS = 20
SLAB_STREAMS, SLAB_CHUNKS = 64, 64  # one slab of the offline corpus path
TIERS = ("faithful", "balanced", "fast", "turbo")  # the step kernel's instances


def profile_calls(label: str, call, shape: str = f"B={BATCH} x {CHUNK}") -> bool:
    """STEPS calls under torch.profiler, then STEPS without it; prints the
    device time per call by event. False when the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                       False):
            continue  # the CPU-side op rows and the zones' device-side rows
            # would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"chip_profile: the profiler recorded no device time for {label}", file=sys.stderr)
        return False
    print(f"{label} {shape}: wall {wall * 1e3 / STEPS:.4f} ms/call "
          f"(host clock, profiler on), device busy {busy_us / 1e3 / STEPS:.4f} ms/call in "
          f"{sum(r[2] for r in rows) // STEPS} device events, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    for dev_us, key, count in rows[:30]:
        print(f"  {dev_us / STEPS:9.1f} us/call  {count // STEPS:4d}x  {key[:110]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        call()
    torch.cuda.synchronize()
    print(f"{label}: wall without profiler {(time.perf_counter() - t0) * 1e3 / STEPS:.4f} ms/call")
    return True


# The standalone spectrum's alternatives (spectrum_variants): the template
# constants of an instance of stft_mag.cu, (n_fft, bins, BK, BGW, RT,
# STAGES, blocks an SM), the shipped ones first ...
SPECTRUM_CONSTANTS = (
    (256, 129, 32, 8, 6, 2, 2), (256, 129, 32, 8, 7, 2, 2), (256, 129, 32, 8, 4, 2, 2),
    (256, 129, 16, 8, 6, 2, 2), (256, 129, 16, 8, 6, 3, 2), (256, 129, 16, 8, 4, 2, 3),
    (256, 129, 32, 32, 7, 2, 2), (256, 129, 8, 32, 7, 2, 2),
    (128, 65, 32, 8, 6, 2, 2), (128, 65, 32, 8, 3, 2, 2), (128, 65, 32, 8, 4, 2, 2))
# ... and copies of the shipped one with one part knocked out (wrong
# magnitudes; their time says what the part costs): name -> pairs of (text
# of stft_tile.cuh, its replacement)
SPECTRUM_KNOCKOUTS = {
    "no Nyquist bin": (("if (nyq_row >= 0) {", "if (nyq_row >= 0 && G::BINS < 0) {"),),
    "no barrier a slice": (("      cp_async_wait<G::STAGES - 2>();\n      __syncthreads();",
                            "      cp_async_wait<G::STAGES - 2>();"),),
    "no store": (("st(r, col + c, sqrtf(x * x + y * y));",
                  "if (x == 12345.f) st(r, col + c, sqrtf(x * x + y * y));"),
                 ("    store.pass_done(row0, rows);\n", "")),
    "no copy of the bases": (("if (next < total) {\n        load_basis_slice",
                              "if (next < 0) {\n        load_basis_slice"),),
}


def spectrum_variants(models, device) -> None:
    """stft_magnitude at the four family geometries at B=2048 through
    libraries of other builds of csrc/stft_mag.cu: each of SPECTRUM_CONSTANTS and
    SPECTRUM_KNOCKOUTS, compiled in parallel into a temporary directory of
    the build directory, launched with the plan launch_plan makes for its
    rows a pass and shared memory, timed with chip_smoke.cuda_ms (three
    runs of 50 calls), and held bit for bit to the package's kernel. Nothing
    in the package loads these builds."""
    import ctypes
    import re
    import shutil
    import subprocess
    import tempfile

    import torch

    import chip_smoke
    from vadc_tpu_torch.kernels import _build
    from vadc_tpu_torch.kernels import stft_dotmag as KD
    from vadc_tpu_torch.kernels import stft_mag as KS

    # name -> (header edits, instance constants, rows a pass, slice taps, stages, blocks)
    builds = {}
    for n_fft, bins, bk, bgw, rt, stages, blocks in SPECTRUM_CONSTANTS:
        rows_pass = (8 // ((bins - 1) // (4 * bgw))) * (32 // bgw) * rt
        builds[f"{bins} bins BK={bk} BGW={bgw} RT={rt} STAGES={stages} {blocks} blocks/SM"] = (
            None, (n_fft, bins, bk, bgw, rt, stages, blocks), rows_pass, bk, stages, blocks)
    for name, edit in SPECTRUM_KNOCKOUTS.items():
        builds[name] = (edit, None, KD.ROWS_PASS[(256, 129)], KS.SLICE_TAPS, KS.STAGES, 2)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        jobs = {}
        for i, (name, (edit, constants, *_)) in enumerate(builds.items()):
            d = Path(tmp) / str(i)
            d.mkdir()
            for f in ("stft_tile.cuh", "mma.cuh", "tier.cuh", "stft_mag.cu", "errors.cu"):
                shutil.copy(_build.CSRC / f, d / f)
            if edit is not None:
                header = (d / "stft_tile.cuh").read_text()
                for text, replacement in edit:
                    assert text in header, name
                    header = header.replace(text, replacement)
                (d / "stft_tile.cuh").write_text(header)
            if constants is not None:
                n_fft, bins, bk, bgw, rt, stages, blocks = constants
                src = re.sub(rf"Geometry<{n_fft}, {bins}, \d+, \d+, \d+, \d+>",
                             f"Geometry<{n_fft}, {bins}, {bk}, {bgw}, {rt}, {stages}>",
                             (d / "stft_mag.cu").read_text())
                (d / "stft_mag.cu").write_text(
                    src.replace("__launch_bounds__(G::THREADS, 2)",
                                f"__launch_bounds__(G::THREADS, {blocks})"))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.LINK_FLAGS, "-I", str(d),
                   "-o", str(d / "lib.so"), str(d / "stft_mag.cu"), str(d / "errors.cu")]
            jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (d, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"spectrum variant {name}: nvcc failed:\n{log}")
            ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
            print(f"spectrum variant {name}: ptxas " + " | ".join(ptxas), flush=True)
            lib = ctypes.CDLL(str(d / "lib.so"))
            lib.vadc_stft_magnitude.argtypes = _build._SIGNATURES["vadc_stft_magnitude"]
            libs[name] = lib
        for family in ("v4", "v4_8k", "v5", "v5_8k"):
            module, params = models[family]
            samples, kw = chip_smoke.stft_geometry(family, module)
            audio = torch.from_numpy(chip_smoke.speech_chunks(BATCH, samples, seed=302)).to(device)
            wr, wi = KS.split_basis_of(params)
            want = KS.stft_magnitude(audio, wr, wi, **kw)
            basis = KD.packed_basis(wr, wi)
            n_fft, cutoff = wr.shape
            for name, lib in libs.items():
                _, constants, rows_pass, taps, stages, blocks = builds[name]
                if (constants or (256, 129))[:2] != (n_fft, cutoff):
                    continue
                with spectrum_constants((n_fft, cutoff), rows_pass, taps, stages, blocks):
                    streams, _ = KS.launch_plan(BATCH, want.shape[1], kw["hop"], n_fft, cutoff,
                                                KS._sm_count(device))
                out = torch.zeros_like(want)

                def run():
                    status = lib.vadc_stft_magnitude(
                        audio.data_ptr(), BATCH, audio.stride(0), samples, kw["pad_left"],
                        kw["pad_right"], kw["hop"], basis.data_ptr(), n_fft, cutoff, streams,
                        out.data_ptr(), KS.MODES["fp32"], torch.cuda.current_stream(device).cuda_stream)
                    _build.check(status, f"spectrum variant {name}")

                run()
                torch.cuda.synchronize()
                times = [chip_smoke.cuda_ms(run) for _ in range(3)]
                print(f"spectrum variant {name}, stft_magnitude {family} B={BATCH} x {samples} "
                      f"({streams} streams a block): " + " ".join(f"{t:.4f}" for t in times)
                      + f" ms; bit-equal to the package's kernel: {torch.equal(out, want)}",
                      flush=True)


# The two probes of tools/tpu_check.py (csrc/probes.cu, probe_variants):
# copies of the source with one part knocked out (wrong values; their time
# says what the part costs): name -> pairs of (text of probes.cu, its
# replacement) ...
_ROW0 = "const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;"
_STORE = "store_tile(d, so, &out_map, out, M, N, row0, col0, flags);"
_PRODUCTS = ("product_wgmma<4 * PANELS>(d, sa, sb);", "product_mma<4 * PANELS>(d, sa, sb);",
             "product_bf16x3<2 * KS>(d, sa, shi, slo);")
PROBE_KNOCKOUTS = {
    "no loads": ((_ROW0, _ROW0 + " flags &= OUT_TMA;"),
                 ("if (!(flags & X_TMA)) copy_x_bf16", "if (false) copy_x_bf16"),
                 ("if (!(flags & W_TMA)) copy_w_bf16", "if (false) copy_w_bf16"),
                 ("if (!(flags & W_TMA)) copy_w_f32", "if (false) copy_w_f32"),
                 ("if (!(flags & X_TMA)) {\n    copy_a_f32", "if (false) {\n    copy_a_f32"),
                 ("if (!(flags & H_TMA)) copy_a_f32", "if (false) copy_a_f32")),
    "no split of w": (("split_w(shi, slo, sw, L, D, Dh, K, col0, N);", ";"),),
    "no product": tuple((p, ";") for p in _PRODUCTS),
    "no store": ((_STORE, "if (d[0] == 12345.f && d[31] == 54321.f) " + _STORE),),
}
PROBE_KNOCKOUTS["nothing"] = sum(PROBE_KNOCKOUTS.values(), ())
# ... copies with a part done twice (what it costs warm) and without the
# proxy fences (what they cost) ...
_SPLIT = "  split_w(shi, slo, sw, L, D, Dh, K, col0, N);\n"
PROBE_KNOCKOUTS["no proxy fences"] = (("  fence_proxy_async();\n", ""),)
PROBE_KNOCKOUTS["split twice"] = ((_SPLIT, _SPLIT + "  __syncthreads();\n" + _SPLIT),)
PROBE_KNOCKOUTS["wgmma twice"] = tuple((p, p + " " + p) for p in _PRODUCTS
                                  if not p.startswith("product_mma<"))
# ... and a copy whose thread 0 stamps clock64() at the phase boundaries of
# every block (and %globaltimer at the first and the last, for the clock),
# read back by vadc_probe_stamps: the boundary each stamp ends
PROBE_PHASES = ("start", "loads issued", "first barrier", "w split (concat_dot)",
                "A's barrier (concat_dot)", "product", "tile in shared memory", "stored")
_STAMPS = """
__device__ long long probe_stamps[4096][10];
__device__ __forceinline__ void stamp(int i) {
  const int b = blockIdx.x * gridDim.y + blockIdx.y;
  if (threadIdx.x != 0 || b >= 4096) return;
  probe_stamps[b][i] = clock64();
  if (i == 0 || i == 7) {
    unsigned long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    probe_stamps[b][8 + (i == 7)] = static_cast<long long>(g);
  }
}
"""
PROBE_STAMPED = (
    ("using bf16 = __nv_bfloat16;\n", "using bf16 = __nv_bfloat16;\n" + _STAMPS),
    (_ROW0, _ROW0 + " stamp(0);"),
    ("  mbar_wait(&bar, 0);\n", "  stamp(1);\n  mbar_wait(&bar, 0);\n  stamp(2);\n"),
    ("  mbar_wait(&bar[0], 0);\n", "  stamp(1);\n  mbar_wait(&bar[0], 0);\n  stamp(2);\n"),
    ("  mbar_wait(&bar[1], 0);\n", "  stamp(3);\n  mbar_wait(&bar[1], 0);\n  stamp(4);\n"),
    *((p, p + " stamp(5);") for p in _PRODUCTS),
    ("  __syncthreads();\n  if (flags & OUT_TMA) {",
     "  __syncthreads();\n  stamp(6);\n  if (flags & OUT_TMA) {"),
    ("      tma_store_drain();\n", "      tma_store_drain();\n      stamp(7);\n"),
    ("// ---- host ----", """}  // namespace
extern "C" int vadc_probe_stamps(long long* out, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, probe_stamps, blocks * 10 * sizeof(long long)));
}
extern "C" int vadc_probe_stamps_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, probe_stamps);
  return static_cast<int>(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(probe_stamps)));
}
namespace {
// ---- host ----"""),
)


def probe_variants(device) -> None:
    """The three probe entries at the v4 gate product's shape (tools/gpu_check:
    2048 x 128 x 256; concat_dot x [2048, 3, 64], h [2048, 64]) through
    libraries of other builds of csrc/probes.cu: each of PROBE_KNOCKOUTS,
    timed by device time (gpu_check.timed, three runs of 50 calls)
    beside the shipped build, and the stamped copy: the mean over the blocks
    of each phase's end, from the block's start, in cycles and in us (the
    cycles a ns of %globaltimer over the blocks' lives), and the grid's span.
    Nothing in the package loads these builds."""
    import ctypes
    import shutil
    import subprocess
    import tempfile

    import torch

    from tools import gpu_check
    from vadc_tpu_torch.kernels import _build
    from vadc_tpu_torch.kernels import probes as P

    entries = ("vadc_bf16_dot", "vadc_bf16_dot_wgmma", "vadc_concat_dot")
    builds = {"shipped": (), **PROBE_KNOCKOUTS, "stamped": PROBE_STAMPED}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "probes.cu").read_text()
    x, w = gpu_check.seeded_bf16(gpu_check.GATE_ROWS, 2 * gpu_check.GATE_D, gpu_check.GATE_N, 7,
                                 device)
    xc, t, hc, wc = gpu_check.seeded_concat(gpu_check.GATE_ROWS, 2 * gpu_check.GATE_D,
                                            gpu_check.GATE_N, 8, device)
    calls = {"bf16_dot": lambda: P.bf16_dot(x, w), "bf16_dot_wgmma": lambda: P.bf16_dot_wgmma(x, w),
             "concat_dot": lambda: P.concat_dot(xc, t, hc, wc)}
    saved = _build._lib
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        jobs = {}
        for i, (name, edits) in enumerate(builds.items()):
            d = Path(tmp) / str(i)
            d.mkdir()
            for f in ("mma.cuh", "wgmma.cuh", "errors.cu"):
                shutil.copy(_build.CSRC / f, d / f)
            text = source
            for old, new in edits:
                assert old in text, (name, old)
                text = text.replace(old, new)
            (d / "probes.cu").write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.LINK_FLAGS, "-I", str(d),
                   "-o", str(d / "lib.so"), str(d / "probes.cu"), str(d / "errors.cu")]
            jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        libs = {}
        for name, (d, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"probe variant {name}: nvcc failed:\n{log}")
            libs[name] = _build._bind(ctypes.CDLL(str(d / "lib.so")), entries)
        try:
            for name, lib in libs.items():
                if name == "stamped":
                    continue
                _build._lib = lib
                print(f"probe variant {name}: " + "; ".join(
                    f"{entry} " + " ".join(f"{gpu_check.timed(call)['ms']:.4f}" for _ in range(3))
                    + " ms" for entry, call in calls.items()), flush=True)
            lib = _build._lib = libs["stamped"]
            lib.vadc_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for entry, call in calls.items():
                call()
                torch.cuda.synchronize()
                _build.check(lib.vadc_probe_stamps_clear(), "vadc_probe_stamps_clear")
                call()
                torch.cuda.synchronize()
                blocks = (gpu_check.GATE_ROWS // 64) * (gpu_check.GATE_N // 64)
                stamps = np.zeros((blocks, 10), np.int64)
                _build.check(lib.vadc_probe_stamps(stamps.ctypes.data, blocks), "vadc_probe_stamps")
                cycles = stamps[:, :8] - stamps[:, :1]
                ns = stamps[:, 9] - stamps[:, 8]
                per_ns = cycles[:, 7].sum() / max(1, ns.sum())
                phases = ", ".join(
                    f"{label} {cycles[:, i].mean():.0f} cycles ({cycles[:, i].mean() / per_ns / 1e3:.3f} us)"
                    for i, label in enumerate(PROBE_PHASES) if i and stamps[:, i].any())
                print(f"probe phases {entry} at the gate shape, the mean of {blocks} blocks from "
                      f"each block's start ({per_ns:.3f} cycles a ns): {phases}; the grid's span "
                      f"{(stamps[:, 9].max() - stamps[:, 8].min()) / 1e3:.3f} us, the blocks' "
                      f"starts within {(stamps[:, 8].max() - stamps[:, 8].min()) / 1e3:.3f} us",
                      flush=True)
        finally:
            _build._lib = saved


@contextlib.contextmanager
def spectrum_constants(instance: tuple, rows_pass: int, taps: int, stages: int, blocks: int):
    """launch_plan for another build of an instance (n_fft, bins): its rows
    a pass, slice taps, ring stages and blocks an SM."""
    from vadc_tpu_torch.kernels import stft_mag as KS

    saved = dict(KS.ROWS_PASS), KS.SLICE_TAPS, KS.STAGES, KS.SMEM_TWO_BLOCKS
    KS.ROWS_PASS[instance] = rows_pass
    KS.SLICE_TAPS, KS.STAGES, KS.SMEM_TWO_BLOCKS = taps, stages, 233_472 // blocks - 1024
    KS.launch_plan.cache_clear()
    try:
        yield
    finally:
        KS.ROWS_PASS.clear()
        KS.ROWS_PASS.update(saved[0])
        KS.SLICE_TAPS, KS.STAGES, KS.SMEM_TWO_BLOCKS = saved[1:]
        KS.launch_plan.cache_clear()


def phase_split(params, audio, label: str, tier: str = "faithful") -> None:
    """One launch of the stamped step kernel's instance of `tier` over
    `audio` [B, S] from a zero state (tools/torch_bench_stages.py:
    phase_rows); prints the mean time of each phase over the stamped
    blocks."""
    from tools.torch_bench_stages import phase_rows

    split = phase_rows(params, audio, tier)
    rows, total = split["rows"], split["life_us"]
    print(f"phase split of the step kernel [{tier}], {label}: {split['blocks']} blocks stamped, a "
          f"block lives {total:.1f} us (min {split['life_min_us']:.1f}, max "
          f"{split['life_max_us']:.1f}), {split['cycles_per_us']:.0f} cycles a us")
    for stage, name, t in rows:
        print(f"  {f'stage {stage} ' if stage else ''}{name:28s} {t:9.2f} us  {100 * t / total:5.1f} %")
    groups = {"spectrum": ("spectrum",), "normalization": ("log1p", "mean, subtract, state"),
              "products": ("proj", "pw", "qkv", "out_proj", "lin1", "lin2", "conv1x1"),
              "depthwise": ("depthwise",), "attention": ("scores", "softmax", "mix"),
              "layer norms": ("layer_norm 1", "layer_norm 2"),
              "lstm": ("lstm input half", "lstm"), "decoder, stores": ("decoder, stores",)}
    for group, names in groups.items():
        t = sum(us for _, name, us in rows if name in names)
        print(f"  sum {group} ({', '.join(names)}): {t:.2f} us, {100 * t / total:.1f} %")
    for st in range(1, 5):
        t = sum(us for stage, _, us in rows if stage == st)
        print(f"  sum encoder stage {st}: {t:.2f} us, {100 * t / total:.1f} %")


def print_ptxas(log: str) -> None:
    """Registers, spills and stack of every kernel instance, from the nvcc
    -Xptxas -v output `log` of a build of the package's library."""
    unit = ""
    for line in log.splitlines():
        if line.startswith("Compiling "):
            unit = line.split()[1]
        elif "entry function" in line or "registers" in line or "spill" in line:
            print(f"ptxas {unit}: {line.strip()}")


def print_hmma() -> None:
    """The tensor-core instructions of each kernel instance of the package's
    library: `cuobjdump -sass` of it, the HMMA lines counted per function
    (the tier instances of the spectrum and the v3.1 body issue them, the
    faithful instances none)."""
    import subprocess

    from vadc_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    name, counts = "", {}
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line.split(" : ", 1)[1]
            counts[name] = 0
        elif "HMMA" in line and name:
            counts[name] += 1
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                                   text=True).stdout.splitlines()
    except OSError:  # no demangler on the machine: the mangled names
        demangled = list(counts)
    for (mangled, n), pretty in zip(counts.items(), demangled or list(counts)):
        print(f"sass HMMA {n:5d}  {pretty[:150]}")


def lstm_streams(params, device) -> None:
    """The bf16 tiers' recurrent kernels at B=2048 with 1, 2, 4 and 8 streams
    a block (the wrappers take the fewest that leave no more blocks than
    SMs: 8 at this batch), CUDA events: lstm_fused at v4 T=3 and
    lstm_decoder_fused at 8 chunks of 7 frames, on seeded random inputs."""
    import torch

    import chip_smoke
    from vadc_tpu_torch.kernels import lstm as KL
    from vadc_tpu_torch.kernels import lstm_decoder as KD
    from vadc_tpu_torch.models import silero_v4
    from vadc_tpu_torch.nn.precision import tier_of

    gen = torch.Generator(device=device).manual_seed(7)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=device, generator=gen)

    _, models = chip_smoke.family_models(device)
    p4 = models["v4"][1]
    x, h, c = rand(BATCH, 3, silero_v4.HIDDEN), rand(2, BATCH, 64, scale=0.3), rand(2, BATCH, 64)
    xd = rand(BATCH, 8, 7, 64)
    rule = KL.mma_streams
    try:
        for tier in TIERS[1:]:
            t = tier_of(tier)
            w4, wd = KL.weight_of(p4, t), KD.weight_of(params, t)
            times = []
            for nb in (1, 2, 4, 8):
                KL.mma_streams = lambda batch, sms, nb=nb: nb
                a = chip_smoke.cuda_ms(lambda: KL.lstm_fused(x, h, c, p4["lstm_w"], p4["lstm_b"],
                                                             wt=w4, tier=t), iters=50)
                d = chip_smoke.cuda_ms(lambda: KD.lstm_decoder_fused(
                    xd, h, c, params["lstm_w"], params["lstm_b"], params["dec_w"], params["dec_b"],
                    wt=wd, tier=t), iters=10)
                times.append(f"{nb}: lstm_fused {a:.4f} ms, lstm_decoder_fused {d:.4f} ms")
            print(f"streams a block [{tier}], B={BATCH} (v4 T=3; 8 x 7 frames): "
                  + "; ".join(times), flush=True)
    finally:
        KL.mma_streams = rule


def phase_splits(params, audio) -> None:
    """phase_split of each tier's instance at B=2048 and for one block alone."""
    for tier in TIERS:
        phase_split(params, audio, f"B={BATCH} x {CHUNK}", tier)
        phase_split(params, audio[:4], f"B=4 x {CHUNK} (one block alone)", tier)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is visible to PyTorch", file=sys.stderr)
        return 1
    import chip_smoke
    from vadc_tpu_torch.cli.main import DEFAULT_WEIGHTS
    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.models.weights import load_params
    from vadc_tpu_torch.runtime import require_cuda

    print(f"card: {chip_smoke.nvidia_smi()}", flush=True)
    device = require_cuda()
    _, params = load_params(DEFAULT_WEIGHTS, device=device)
    audio = torch.from_numpy(chip_smoke.speech_chunks(BATCH, CHUNK, seed=300)).to(device)
    if sys.argv[1:] == ["probes"]:
        probe_variants(device)
        return 0
    if sys.argv[1:] == ["split"]:
        from vadc_tpu_torch.kernels import _build

        _build.library()
        ptxas = _build.build_info.get("log", "")
        phase_splits(params, audio)
        print_ptxas(ptxas)
        print_hmma()
        lstm_streams(params, device)
        return 0
    runner = StreamRunner("v3", params, device=device)
    state = runner.init_state(BATCH)
    for _ in range(10):
        runner.step(audio, state)
    torch.cuda.synchronize()

    if not profile_calls("StreamRunner.step", lambda: runner.step(audio, state)):
        return 1

    from vadc_tpu_torch.server import VadServer

    server = VadServer(port=0, max_streams=BATCH, device=device)
    try:
        batch = (audio.cpu().numpy() * 32768).clip(-32768, 32767).astype(np.int16)
        on, off = np.ones(BATCH, bool), np.zeros(BATCH, bool)
        for _ in range(10):
            server._tick(batch, on, off)
        if not profile_calls("server _tick", lambda: server._tick(batch, on, off)):
            return 1
    finally:
        server.pool.close()

    slab = torch.from_numpy(
        chip_smoke.speech_chunks(SLAB_STREAMS * SLAB_CHUNKS, CHUNK, seed=301)
    ).to(device).reshape(SLAB_STREAMS, SLAB_CHUNKS, CHUNK)
    slab_state = runner.init_state(SLAB_STREAMS)
    for _ in range(5):
        runner.scan(slab, slab_state)
    if not profile_calls("StreamRunner.scan (one slab)", lambda: runner.scan(slab, slab_state),
                         shape=f"B={SLAB_STREAMS} x K={SLAB_CHUNKS} x {CHUNK}"):
        return 1
    phase_splits(params, audio)

    # the standalone spectrum: device time against host time at the v4 step,
    # the v4 CLI window and the v5_8k step, then its alternatives
    from vadc_tpu_torch.kernels.stft_mag import split_basis_of, stft_magnitude

    _, models = chip_smoke.family_models(device)
    for family, batch in (("v4", BATCH), ("v4", chip_smoke.CLI_WINDOW), ("v5_8k", BATCH)):
        module, fparams = models[family]
        samples, kw = chip_smoke.stft_geometry(family, module)
        chunks = torch.from_numpy(chip_smoke.speech_chunks(batch, samples, seed=303)).to(device)
        wr, wi = split_basis_of(fparams)
        for _ in range(5):
            stft_magnitude(chunks, wr, wi, **kw)
        if not profile_calls(f"stft_magnitude {family}", lambda: stft_magnitude(chunks, wr, wi, **kw),
                             shape=f"B={batch} x {samples}"):
            return 1
    spectrum_variants(models, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
