"""Per-stage timing of the PyTorch/CUDA port's step — prefix method: the
counterpart of tools/bench_stages.py.

Times PREFIX pipelines of one family's step (the spectrum; + the next
stage; ...; + the decoder), each as a loop of T_LONG against T_SHORT
consecutive chunks carrying the LSTM state (and v5's context) from the
same state, and reports the cost per chunk as (t_long - t_short) /
(T_LONG - T_SHORT), the least of 3 repeats, and each stage as the
difference of consecutive prefixes. Differences of prefixes keep every
reading inside the same sustained whole-pipeline regime as the step itself.

The prefixes are built from the functions the port's step runs, at the
tier, so the last prefix is the step: its probabilities and state must
equal `forward`'s bit for bit, or the tool exits 1.
  * v3 (Silero v3.1; the step is one kernel): `encode_fused_audio` (the
    step kernel's spectrum, normalization and encoder), then
    `forward_fused` (the whole step). With --split, also the step kernel's
    time by phase from the clock64()-stamped build
    (kernels/_build.py: probe_library), grouped as the original's stages;
  * v4, v4_8k: `stft_magnitude`; + the adaptive normalization and the
    concat; + conv stages 1..4; + `lstm_fused`; + the decoder;
  * v5, v5_8k: `attach_context` + `stft_magnitude`; + convs 1..4; +
    `lstm_fused`; + the decoder.
Each row gives the wall time per chunk (CUDA events on the card), the
device time per chunk (the CUDA kernels' busy time from torch.profiler over
one T_SHORT loop; on the v4/v5 steps, which the host paces, the wall time
alone cannot tell the two apart) and the launches per chunk of the counted
kernels.

Runs on the card unless `--device cpu` is given (without a card it exits 1
with one line); on the CPU the wall time is the host clock's and the device
time is not measured. Imports nothing of JAX or of vadc_tpu.

Usage:
    python tools/torch_bench_stages.py [--family v3|v4|v4_8k|v5|v5_8k|all]
        [--batch 2048] [--precision fast] [--t_short 16] [--t_long 336]
        [--split] [--device cuda|cpu] [--json]

Importable: run_stages(...) returns one family's rows as a dict.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

T_SHORT, T_LONG = 16, 336
REPEATS = 3
FAMILIES = ("v3", "v4", "v4_8k", "v5", "v5_8k")
#: samples of one chunk of each family (v5's before its context)
CHUNK = {"v3": 1536, "v4": 1536, "v4_8k": 768, "v5": 512, "v5_8k": 256}
#: the kernels the prefixes launch, whose launches each row counts
COUNTED = ("forward_fused", "encode_fused_audio", "stft_magnitude", "lstm_fused")
#: the step kernel's phases (kernels/_build.py: PHASES) grouped as
#: tools/bench_stages.py's stages; the encoder layers are grouped by stage
SPLIT_GROUPS = {"stft": ("spectrum",), "adaptive_norm": ("log1p", "mean, subtract, state"),
                "lstm": ("lstm input half", "lstm"), "decoder": ("decoder, stores",)}


class PrefixMismatch(RuntimeError):
    """The full prefix's output is not `forward`'s."""


def load_model(family: str, device):
    """(model module, params on `device`) of a family: v3, v4 and v4_8k the
    bundled weights, v5 and v5_8k synthetic weights of the official shapes
    from fixed seeds (chip_smoke.py: family_models)."""
    from chip_smoke import family_models

    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_params

    if family == "v3":
        return silero_v31, load_params(DEFAULT_WEIGHTS, device=device)[1]
    return family_models(device)[1][family]


def init_state(family: str, module, batch: int, device) -> tuple:
    """The zero state a prefix carries: (h, c), and for v5 (h, c, context)."""
    h, c = module.init_state(batch, device)
    return (h, c, module.init_context(batch, device)) if family.startswith("v5") else (h, c)


def _mean(x):
    """tools/bench_stages.py's value of a partial prefix: its output's mean
    over the non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def prefixes(family: str, module, params, tier) -> list:
    """[(row name, step)] of the family's prefixes, shortest first; step(audio
    [B, S], state) -> (value [B], state). The last is the whole step."""
    from vadc_tpu_torch.kernels.lstm import lstm_fused, weight_of
    from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio
    from vadc_tpu_torch.models import silero_v4, silero_v5, silero_v31
    from vadc_tpu_torch.models.weights import V4_STRIDES_16K, V4_STRIDES_8K
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import store, tier_of

    tier = tier_of(tier)
    if family == "v3":
        def encoded(audio, state):
            return _mean(encode_fused_audio(params, audio, tier)), state

        def full(audio, state):
            probs, h, c = silero_v31.forward(params, audio, *state, tier=tier)
            return probs, (h, c)

        return [("encode_fused_audio", encoded), ("forward_fused (full)", full)]

    def lstm_and_decoder(x, h, c, decoder: bool):
        x, h, c = lstm_fused(x, h, c, params["lstm_w"], params["lstm_b"],
                             wt=weight_of(params, tier), tier=tier)
        if decoder:
            return F.decoder_v5_nlc(x, params["dec_w"], params["dec_b"], tier), h, c
        return _mean(x), h, c

    if family.startswith("v4"):
        strides = V4_STRIDES_16K if module.SAMPLE_RATE == 16000 else V4_STRIDES_8K
        stages = list(zip(params["stages"], strides))

        def v4_prefix(depth):
            """0 the spectrum, 1 + the encoder's input, 2-5 + conv stages
            1-4, 6 + the LSTM, 7 + the decoder."""
            def step(audio, state):
                x = silero_v4.spectrum(params, audio, tier)
                if depth == 0:
                    return _mean(x), state
                x = silero_v4.encoder_input(x, tier)
                for p, stride in stages[: depth - 1]:
                    x = silero_v4.conv_stage(x, p, stride=stride, tier=tier)
                if depth < 6:
                    return _mean(x), state
                x, h, c = lstm_and_decoder(x, *state, decoder=depth == 7)
                return x, (h, c)

            return step

        names = ["stft_magnitude", "+adaptive_norm+concat"] + [
            f"+conv_stage{i}" for i in range(1, 5)] + ["+lstm_fused", "+decoder (full)"]
        return [(name, v4_prefix(depth)) for depth, name in enumerate(names)]

    layers = list(zip(params["encoder"], silero_v5.ENCODER_STRIDES))

    def v5_prefix(depth):
        """0 the context and the spectrum, 1-4 + convs 1-4, 5 + the LSTM,
        6 + the decoder."""
        def step(audio, state):
            h, c, context = state
            x, context = module.attach_context(audio, context)
            x = silero_v5.spectrum(params, x, pad_right=module.STFT_PAD_RIGHT,
                                   hop=module.STFT_HOP, tier=tier)
            if depth == 0:
                return _mean(x), (h, c, context)
            x = store(x, tier)  # as silero_v5._convs: turbo's encoder starts in bf16
            for p, stride in layers[:depth]:
                x = silero_v5.conv_layer(x, p, stride=stride, tier=tier)
            if depth < 5:
                return _mean(x), (h, c, context)
            x, h, c = lstm_and_decoder(x, h, c, decoder=depth == 6)
            return x, (h, c, context)

        return step

    names = ["attach_context+stft_magnitude"] + [f"+conv{i}" for i in range(1, 5)] + [
        "+lstm_fused", "+decoder (full)"]
    return [(name, v5_prefix(depth)) for depth, name in enumerate(names)]


def forward_step(family: str, module, params, tier):
    """The model's own step with a prefix's signature: `forward` (after
    `attach_context` for v5)."""
    def step(audio, state):
        if family.startswith("v5"):
            h, c, context = state
            x, context = module.attach_context(audio, context)
            probs, h, c = module.forward(params, x, h, c, tier=tier)
            return probs, (h, c, context)
        probs, h, c = module.forward(params, audio, *state, tier=tier)
        return probs, (h, c)

    return step


def run_loop(step, chunks, state):
    """step over the chunks [B, T, S] in order, carrying the state: (the
    values of every chunk, the last state)."""
    values = []
    for t in range(chunks.shape[1]):
        value, state = step(chunks[:, t], state)
        values.append(value)
    return values, state


def _seconds(fn, device) -> float:
    """fn's wall time: CUDA events around it on the card (the queue drained
    first), the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _launches() -> dict:
    from vadc_tpu_torch.kernels.lstm import lstm_fused
    from vadc_tpu_torch.kernels.silero_v31_fused import encode_fused_audio, forward_fused
    from vadc_tpu_torch.kernels.stft_mag import stft_magnitude

    wrappers = {"forward_fused": forward_fused, "encode_fused_audio": encode_fused_audio,
                "stft_magnitude": stft_magnitude, "lstm_fused": lstm_fused}
    return {name: wrappers[name].launches for name in COUNTED}


def same_bits(a: tuple, b: tuple) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_rows(params, audio, tier: str = "faithful") -> dict:
    """One launch of the stamped step kernel's instance of `tier` over
    `audio` [B, S] from a zero state (kernels/_build.py: probe_library, the
    card only), its probabilities held to forward_fused's bit for bit. The
    mean time of each phase over the stamped blocks: {"tier", "blocks",
    "life_us" (a block's mean life), "life_min_us", "life_max_us",
    "cycles_per_us", "rows": [(encoder stage or 0, phase name, us)]}."""
    import ctypes

    import torch

    from vadc_tpu_torch.kernels import _build
    from vadc_tpu_torch.kernels.silero_v31_fused import forward_fused, step_args
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn.precision import tier_of

    lib = _build.probe_library()
    n_blocks, n_slots = ctypes.c_int(), ctypes.c_int()
    lib.vadc_phase_probe_shape(ctypes.byref(n_blocks), ctypes.byref(n_slots))
    n_blocks, n_slots = n_blocks.value, n_slots.value
    batch = audio.shape[0]
    h, c = silero_v31.init_state(batch, audio.device)
    probs = torch.empty(batch, device=audio.device)
    hn, cn = torch.empty_like(h), torch.empty_like(c)
    for _ in range(3):  # the last launch's stamps are read
        args = step_args(params, audio, h, c, probs, hn, cn, tier=tier_of(tier))
        _build.check(lib.vadc_silero_v31_fused_audio(*args), "probe step")
    clocks = np.zeros((n_blocks, n_slots), np.int64)
    ids = np.zeros((n_blocks, n_slots), np.int32)
    counts = np.zeros(n_blocks, np.int32)
    ns = np.zeros((n_blocks, 2), np.uint64)
    status = lib.vadc_phase_probe_read(clocks.ctypes.data, ids.ctypes.data, counts.ctypes.data,
                                       ns.ctypes.data)
    _build.check(status, "probe read")
    if not torch.equal(forward_fused(params, audio, h, c, tier=tier)[0], probs):
        raise AssertionError("the stamped kernel's probabilities differ from the package's")
    blocks = min(n_blocks, -(-batch // 4))  # NB = 4 streams a block
    n = int(counts[0])
    if not all(int(counts[b]) == n and (ids[b, :n] == ids[0, :n]).all() for b in range(blocks)):
        raise AssertionError("blocks stamped different phase sequences")
    span_cycles = (clocks[:blocks, n - 1] - clocks[:blocks, 0]).astype(np.float64)
    span_us = (ns[:blocks, 1] - ns[:blocks, 0]).astype(np.float64) / 1e3
    us = np.diff(clocks[:blocks, :n], axis=1) * (span_us / span_cycles)[:, None]
    total = float(span_us.mean())
    rows, stage = [], 0
    for i, t in enumerate(us.mean(axis=0)):
        name = _build.PHASES[ids[0, i + 1]]
        if name == "proj":
            stage += 1
        elif name.startswith("lstm"):
            stage = 0
        rows.append((stage, name, float(t)))
    return {"tier": tier, "blocks": blocks, "life_us": total, "life_min_us": float(span_us.min()),
            "life_max_us": float(span_us.max()),
            "cycles_per_us": float(span_cycles.mean()) / total, "rows": rows}


def split_stages(split: dict) -> list:
    """phase_rows' phases summed into tools/bench_stages.py's stages: [(name,
    us)] for stft, adaptive_norm, layer1..4, lstm, decoder."""
    rows = split["rows"]
    named = {name: sum(us for _, phase, us in rows if phase in phases)
             for name, phases in SPLIT_GROUPS.items()}
    layers = [(f"layer{s}", sum(us for stage, _, us in rows if stage == s)) for s in range(1, 5)]
    return ([("stft", named["stft"]), ("adaptive_norm", named["adaptive_norm"])] + layers
            + [("lstm", named["lstm"]), ("decoder", named["decoder"])])


def run_stages(family: str = "v3", batch: int = 2048, precision: str = "fast",
               t_short: int = T_SHORT, t_long: int = T_LONG, device="cuda",
               split: bool = False) -> dict:
    """One family's prefix rows: {"family", "batch", "precision", "device",
    "t_short", "t_long", "full_equals_forward", "rows": [{"name",
    "cumulative_us", "stage_us", "device_us" (None off the card),
    "launches" (per chunk, by kernel)}], "split": (v3 with `split` on the
    card) phase_rows' dict and "split_stages"}. Raises PrefixMismatch when
    the full prefix's probabilities or state differ from `forward`'s."""
    import torch

    from tools.gpu_check import device_ms
    from vadc_tpu_torch.nn.precision import tier_of
    from vadc_tpu_torch.runtime import check_precision, on_device, resolve_device

    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r} (one of {', '.join(FAMILIES)})")
    if not 0 < t_short < t_long:
        raise ValueError(f"need 0 < t_short < t_long, got {t_short} and {t_long}")
    check_precision(precision, family)
    device = resolve_device(device)
    if split and (family != "v3" or device.type != "cuda"):
        raise ValueError("--split reads the v3 step kernel's stamped build on the card")
    tier = tier_of(precision)
    with on_device(device), torch.no_grad():
        module, params = load_model(family, device)
        gen = torch.Generator(device=device).manual_seed(0)
        audio = torch.randn((batch, t_long, CHUNK[family]), generator=gen, device=device) * 0.1
        short = audio[:, :t_short]
        state = init_state(family, module, batch, device)
        steps = prefixes(family, module, params, tier)

        got = run_loop(steps[-1][1], short, state)
        want = run_loop(forward_step(family, module, params, tier), short, state)
        if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
            raise PrefixMismatch(f"{family}: the full prefix differs from forward's output")

        for _, step in steps:  # warm-up: every shape built and cached
            for chunks in (short, audio):
                run_loop(step, chunks, state)
        costs = [float("inf")] * len(steps)
        for _ in range(REPEATS):
            for i, (_, step) in enumerate(steps):
                ts = _seconds(lambda: run_loop(step, short, state), device)
                tl = _seconds(lambda: run_loop(step, audio, state), device)
                costs[i] = min(costs[i], (tl - ts) / (t_long - t_short))

        rows, prev = [], 0.0
        for (name, step), cost in zip(steps, costs):
            before = _launches()
            run_loop(step, short, state)
            launches = {k: (v - before[k]) / t_short for k, v in _launches().items()
                        if v > before[k]}
            dev_us = None
            if device.type == "cuda":
                ms = device_ms(lambda: run_loop(step, short, state), iters=1)
                dev_us = None if ms is None else ms * 1e3 / t_short
            rows.append({"name": name, "cumulative_us": cost * 1e6,
                         "stage_us": max(cost - prev, 0.0) * 1e6, "device_us": dev_us,
                         "launches": launches})
            prev = cost
        result = {"family": family, "batch": batch, "precision": precision,
                  "device": str(device), "t_short": t_short, "t_long": t_long,
                  "full_equals_forward": True, "rows": rows, "split": None}
        if split:
            result["split"] = phase_rows(params, audio[:, 0].contiguous(), precision)
            result["split_stages"] = split_stages(result["split"])
    return result


def print_rows(r: dict) -> None:
    print(f"{r['family']}: batch {r['batch']}, precision {r['precision']}, {r['device']}, "
          f"T {r['t_short']}/{r['t_long']}; the full prefix equals forward's output bit for bit:")
    for row in r["rows"]:
        dev = ("device not measured" if row["device_us"] is None
               else f"device {row['device_us']:7.1f} us")
        launches = ", ".join(f"{k} {v:g}" for k, v in row["launches"].items()) or "none"
        print(f"{row['name']:29s} cumulative {row['cumulative_us']:7.1f} us   stage "
              f"{row['stage_us']:7.1f} us   {dev}   launches a chunk: {launches}")
    if r["split"] is not None:
        s = r["split"]
        print(f"in the step kernel [{s['tier']}], chunk 0: {s['blocks']} blocks stamped, a block "
              f"lives {s['life_us']:.1f} us")
        for name, us in r["split_stages"]:
            print(f"{name:29s} in-kernel  {us:7.1f} us   {100 * us / s['life_us']:5.1f} % of a "
                  "block's life")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=FAMILIES + ("all",), default="v3")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--precision", choices=("faithful", "balanced", "fast", "turbo"),
                    default="fast")
    ap.add_argument("--t_short", type=int, default=T_SHORT)
    ap.add_argument("--t_long", type=int, default=T_LONG)
    ap.add_argument("--split", action="store_true",
                    help="v3: also the step kernel's time by phase (the card only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card, or exit 1 without one) or cpu")
    ap.add_argument("--json", action="store_true", help="also print the rows as one JSON line")
    args = ap.parse_args(argv)

    from vadc_tpu_torch.runtime import NoCudaDeviceError

    families = FAMILIES if args.family == "all" else (args.family,)
    results = []
    try:
        for family in families:
            r = run_stages(family, args.batch, args.precision, args.t_short, args.t_long,
                           args.device, split=args.split and family == "v3")
            print_rows(r)
            results.append(r)
    except NoCudaDeviceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except PrefixMismatch as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"families": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
