#!/usr/bin/env python3
"""GPU regression tier of the PyTorch/CUDA port: build every CUDA kernel
and hold it on the card, the counterpart of tools/tpu_check.py.

The checks of tpu_check, under its names and bounds, each kernel against
its plain PyTorch version on the same card:
  * lstm_fused, lstm_decoder_fused                     1e-5
  * stft_dotmag_kernel (dot_magnitude on bf16 frames and bases)   1e-5
  * fused2d_forward_state_carry, fused3d_forward_state_carry (2 steps)  1e-5
  * fast_vs_faithful_probability 2e-2, balanced_vs_faithful_probability 1e-4
  * speech_{balanced,fast,turbo}_vs_faithful: the tier ladder on
    synthaudio speech, held to the port's own
    kernels/tier_check.py SPEECH_BOUND["v3"] (tpu_check's TPU bounds,
    3e-3, 3e-2 and 1e-1, are printed beside them as that package's figures)
  * the golden per-op fixtures (tools/torch_fidelity_report.run_cases)
    where the reference's fixtures exist (torch_fidelity_report.TESTDATA)
and beside them forward_fused, encode_fused_audio and stft_magnitude (v4
and v5 geometries) against their plain versions at 1e-5, and the two
products that tpu_check probes (kernels/probes.py): bf16_dot (mma.sync)
and bf16_dot_wgmma exact at the probe's own inputs, concat_dot within 1e-3
of fp32, all three within 1e-5 of their plain versions at seeded shapes
(among them shapes whose strides TMA cannot take, which the kernels stage
with their threads), and two controls that must break their limits.

tpu_check's Mosaic-lowering canaries and its transfer-leak canary have no
counterpart: the probes are their counterpart here, and unlike tpu_check's
they fail the run when they are wrong.

Run: `python tools/gpu_check.py` (needs a card: exits 2 without one). Prints
the checks as they go and ONE JSON line, {"check": "gpu_kernels", "ok",
"failures", "seconds", "results", "probes"}; exits 0 or 1. Imports nothing
of JAX or of vadc_tpu.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.torch_fidelity_report import TESTDATA  # noqa: E402

#: tpu_check.py's bounds of the speech ladder, recorded on a TPU
#: (tpu_check.py:247-252): printed beside the port's own, never held
TPU_SPEECH_BOUND = {"balanced": 3e-3, "fast": 3e-2, "turbo": 1e-1}
#: the probes' seeded shapes: rows (4096: 64 row tiles), and K -> N (K = 40
#: is no multiple of 16; 48 is the probe's, 128 the v4 gate product's
#: [x | h] = 64 + 64)
PROBE_ROWS = (16, 37, 2048, 4096)
PROBE_N = {40: 24, 48: 16, 128: 256}
#: (K, N) whose strides TMA cannot take, so that the kernels copy those
#: operands with the block's threads (kernels/probes.py: bf16_dot_staging,
#: concat_dot_staging): K = 37 leaves x's rows (and concat_dot's D = 19,
#: Dh = 18) off 16 bytes, N = 13 w's and the output's
PROBE_THREAD_STAGED = ((37, 24), (48, 13))
#: the two timed shapes: the probe's own, and the v4 LSTM gate product's
#: (2048 rows, [x | h] = 64 + 64, N = 4 x 64; x [B, T=3, 64], t = 1)
GATE_ROWS, GATE_D, GATE_N, GATE_T = 2048, 64, 256, 3


class Checks:
    """Named results, each against its bound, and the failures."""

    def __init__(self) -> None:
        self.results: dict[str, float] = {}
        self.failures: list[str] = []

    def __call__(self, name: str, err: float, bound: float, note: str = "") -> None:
        self.results[name] = float(err)
        status = "ok" if err <= bound else "FAIL"
        print(f"{name:40s} {err:9.2e} (bound {bound:.0e}) {status}{note}", flush=True)
        if err > bound:
            self.failures.append(name)

    def control(self, name: str, err: float, bound: float) -> None:
        """A control must BREAK its bound: it shows the check can fail."""
        self.results[name] = float(err)
        status = "ok (breaks)" if err > bound else "FAIL (holds)"
        print(f"{name:40s} {err:9.2e} (must exceed {bound:.0e}) {status}", flush=True)
        if err <= bound:
            self.failures.append(name)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rel_err(got, want) -> float:
    """The largest difference relative to max(1, the largest |want|)."""
    return max_abs(got, want) / max(1.0, float(want.abs().max()))


def probe_inputs(device) -> dict:
    """tpu_check's own probe inputs (tpu_check.py:52-53, 73-76)."""
    import torch

    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 4, 64)).astype(np.float32)
    h = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(128, 32)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"bf16": (torch.full((2, 8, 48), 0.5, dtype=torch.bfloat16, device=device),
                     torch.full((48, 16), 0.25, dtype=torch.bfloat16, device=device)),
            "concat": (t(x), 1, t(h), t(w))}


def seeded_bf16(rows: int, k: int, n: int, seed: int, device):
    """x [rows, k] and w [k, n], bf16, w scaled by 1/sqrt(k); rows = 16 as
    [2, 8, k], the leading dims folded into rows."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    shape = (2, rows // 2, k) if rows == 16 else (rows, k)
    to = lambda a: torch.from_numpy(a).to(device).to(torch.bfloat16)  # noqa: E731
    return to(x.reshape(shape)), to(w)


def seeded_concat(rows: int, k: int, n: int, seed: int, device, seq: int = GATE_T):
    """x [rows, seq, k - k/2], h [rows, k/2] and w [k, n] fp32, each scaled
    by 1/sqrt(k): outputs of about 1/sqrt(k), where what bf16_3x drops (lo
    rounded to 2^-17 of an operand, and lo*lo) stays below 1e-5, so that
    the plain fp32 version, which a CPU run checks, meets the bf16_3x limit
    too."""
    import torch

    rng = np.random.default_rng(seed)
    dh, scale = k // 2, 1.0 / np.sqrt(k)
    x = (rng.normal(size=(rows, seq, k - dh)) * scale).astype(np.float32)
    h = (rng.normal(size=(rows, dh)) * scale).astype(np.float32)
    w = (rng.normal(size=(k, n)) * scale).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(x), 1, to(h), to(w)


def staging_names(flags: int, operands: str) -> str:
    """The operands (in the order of the flags' bits, kernels/probes.py)
    staged by TMA and those copied by the threads, as words."""
    names = operands.split()
    tma = [n for i, n in enumerate(names) if flags >> i & 1]
    threads = [n for i, n in enumerate(names) if not flags >> i & 1]
    return (f"{', '.join(tma) or 'nothing'} by TMA"
            + (f", {', '.join(threads)} by the threads" if threads else ""))


def probe_checks(device, check: Checks) -> dict:
    """The two probes of tpu_check on the port's kernels: at the probe's
    own inputs, at seeded shapes, and two controls. Returns what is
    printed beside the checks (the two bf16 entries against each other,
    the bf16_3x products against fp32)."""
    import torch

    from vadc_tpu_torch.kernels.probes import (
        bf16_dot, bf16_dot_reference, bf16_dot_staging, bf16_dot_wgmma, concat_dot,
        concat_dot_reference, concat_dot_staging,
    )
    from vadc_tpu_torch.nn.precision import matmul_at

    info: dict = {}
    p = probe_inputs(device)
    x, w = p["bf16"]
    for name, fn in (("bf16_dot", bf16_dot), ("bf16_dot_wgmma", bf16_dot_wgmma)):
        out = fn(x, w)
        ok_shape = tuple(out.shape) == (2, 8, 16) and out.dtype == torch.float32
        check(f"probe_{name}_exact_6", float((out - 6.0).abs().max()) if ok_shape else np.inf, 0.0)
    xc, t, hc, wc = p["concat"]
    fp32 = concat_dot_reference(xc, t, hc, wc)
    got = concat_dot(xc, t, hc, wc)
    check("probe_concat_dot_vs_fp32", max_abs(got, fp32) if got.shape == (8, 32) else np.inf, 1e-3)
    info["probe_concat_dot_vs_fp32"] = max_abs(got, fp32)
    # the control: one bf16 pass is not enough for tpu_check's 1e-3
    cat = torch.cat([xc[:, t], hc], -1)
    check.control("control_single_bf16_pass_vs_fp32", max_abs(matmul_at(cat, wc, "bf16"), fp32),
                  1e-3)

    worst = {"bf16_dot": 0.0, "bf16_dot_wgmma": 0.0, "concat_dot_vs_bf16_3x": 0.0,
             "concat_dot_vs_fp32": 0.0}
    between = 0.0
    staged: dict = {}  # (entry, operands by TMA) -> shapes
    shapes = [(r, k, n) for r in PROBE_ROWS for k, n in (*PROBE_N.items(), *PROBE_THREAD_STAGED)]
    for seed, (rows, k, n) in enumerate(shapes):
        xs, ws = seeded_bf16(rows, k, n, seed, device)
        want = bf16_dot_reference(xs, ws)
        a, b = bf16_dot(xs, ws), bf16_dot_wgmma(xs, ws)
        key = ("bf16_dot", staging_names(bf16_dot_staging(xs, ws, a), "x w out"))
        staged[key] = staged.get(key, 0) + 1
        worst["bf16_dot"] = max(worst["bf16_dot"], max_abs(a, want))
        worst["bf16_dot_wgmma"] = max(worst["bf16_dot_wgmma"], max_abs(b, want))
        between = max(between, max_abs(a, b))
        xc, t, hc, wc = seeded_concat(rows, k, n, seed, device)
        got = concat_dot(xc, t, hc, wc)
        key = ("concat_dot", staging_names(concat_dot_staging(xc, t, hc, wc, got), "x w out h"))
        staged[key] = staged.get(key, 0) + 1
        cat = torch.cat([xc[:, t], hc], -1)
        worst["concat_dot_vs_bf16_3x"] = max(worst["concat_dot_vs_bf16_3x"],
                                             max_abs(got, matmul_at(cat, wc, "bf16_3x")))
        worst["concat_dot_vs_fp32"] = max(worst["concat_dot_vs_fp32"],
                                          max_abs(got, concat_dot_reference(xc, t, hc, wc)))
    check("probe_bf16_dot_seeded", worst["bf16_dot"], 1e-5)
    check("probe_bf16_dot_wgmma_seeded", worst["bf16_dot_wgmma"], 1e-5)
    check("probe_concat_dot_vs_bf16_3x_seeded", worst["concat_dot_vs_bf16_3x"], 1e-5)
    check("probe_concat_dot_vs_fp32_seeded", worst["concat_dot_vs_fp32"], 1e-3)
    info["bf16_dot_vs_bf16_dot_wgmma"] = between
    print(f"{'probe bf16_dot against bf16_dot_wgmma':40s} {between:9.2e} (the two entries, "
          "seeded shapes)", flush=True)
    for (entry, names), count in sorted(staged.items()):
        print(f"probe staging {entry}: {names} at {count} of the {len(shapes)} seeded shapes",
              flush=True)
    # the control: K cut to its last multiple of 16 loses the tail's products
    xs, ws = seeded_bf16(PROBE_ROWS[1], 40, PROBE_N[40], 99, device)
    cut = 40 // 16 * 16
    check.control("control_bf16_dot_k_cut_to_32",
                  max_abs(bf16_dot(xs[..., :cut].contiguous(), ws[:cut].contiguous()),
                          bf16_dot_reference(xs, ws)), 1e-5)
    return info


def device_ms(fn, iters: int = 50) -> float | None:
    """Device time of one call of fn: the busy time of every kernel it
    launches, from torch.profiler over `iters` calls after a warm-up; None
    when the profiler records no device time. At the probes' shapes a call
    is shorter than its host side (the wrapper's checks, the allocation,
    the launch), so CUDA events around back-to-back calls time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            busy += e.self_cuda_time_total if us is None else us
    return busy / 1e3 / iters if busy > 0 else None


def timed(fn) -> dict:
    """{"ms": device time (CUDA events where the profiler saw none),
    "event_ms": CUDA events around back-to-back calls (chip_smoke.py's
    timer)}."""
    from chip_smoke import cuda_ms

    event = cuda_ms(fn)
    dev = device_ms(fn)
    return {"ms": event if dev is None else dev, "event_ms": event}


def probe_timings(device) -> dict:
    """The probes timed at the probe's own shapes (launch-bound) and at the
    v4 gate product's: kernel, plain version, library call (each its device
    time, and its CUDA-event time back to back beside it) and bound. name
    -> {shape label -> numbers}. The library call of bf16_dot's function is
    torch.mm(x, w, out_dtype=torch.float32) (bf16 operands, an fp32 result)
    where this torch has it, with bf16 torch.matmul (a bf16 result: not the
    same function) beside it as `library_bf16_matmul`; concat_dot's is
    torch.cat + fp32 torch.matmul. The bound counts each input read once and
    each output written once, and the operations at the bf16 tensor-core
    peak (bf16_3x three times): chip_smoke.py's products_bound_ms."""
    import torch

    from chip_smoke import products_bound_ms

    from vadc_tpu_torch.kernels.probes import (
        bf16_dot, bf16_dot_reference, bf16_dot_wgmma, concat_dot, concat_dot_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    p = probe_inputs(device)
    gate_k = 2 * GATE_D
    out: dict = {"bf16_dot": {}, "bf16_dot_wgmma": {}, "concat_dot": {}}

    def row(kernel, plain, library, bound, library_call, **yardsticks) -> dict:
        k, pl = timed(kernel), timed(plain)
        lib = timed(library) if library is not None else {"ms": None, "event_ms": None}
        r = {"ms": k["ms"], "plain_ms": pl["ms"], "library_ms": lib["ms"],
             "bound_ms": bound[0], "bound_by": bound[1], "event_ms": k["event_ms"],
             "plain_event_ms": pl["event_ms"], "library_event_ms": lib["event_ms"],
             "library_call": library_call}
        for name, call in yardsticks.items():
            y = timed(call)
            r[f"{name}_ms"], r[f"{name}_event_ms"] = y["ms"], y["event_ms"]
        return r

    def mm_fp32(x2d, w):
        """torch.mm with an fp32 output from bf16 operands (aten::mm.dtype),
        the kernels' function in one call; None where this torch lacks it."""
        try:
            torch.mm(x2d, w, out_dtype=torch.float32)
        except (TypeError, RuntimeError, NotImplementedError):
            return None
        return lambda: torch.mm(x2d, w, out_dtype=torch.float32)

    for label, (x, w) in (("probe [2, 8, 48] x [48, 16]", p["bf16"]),
                          (f"gate [{GATE_ROWS}, {gate_k}] x [{gate_k}, {GATE_N}]",
                           seeded_bf16(GATE_ROWS, gate_k, GATE_N, 7, device))):
        m, k = x.numel() // x.shape[-1], x.shape[-1]
        n = w.shape[1]
        bound = products_bound_ms(2 * m * k + 2 * k * n + 4 * m * n, (2.0 * m * k * n, "bf16"))
        library = mm_fp32(x.reshape(m, k), w)
        call = ("torch.mm(x, w, out_dtype=torch.float32)" if library is not None
                else "none: no single call of this torch computes bf16 x bf16 -> fp32")
        for name, fn in (("bf16_dot", bf16_dot), ("bf16_dot_wgmma", bf16_dot_wgmma)):
            out[name][label] = row(lambda: fn(x, w), lambda: bf16_dot_reference(x, w), library,
                                   bound, call, library_bf16_matmul=lambda: torch.matmul(x, w))
    for label, (x, t, h, w) in (("probe x [8, 4, 64], h [8, 64], w [128, 32]", p["concat"]),
                                (f"gate x [{GATE_ROWS}, {GATE_T}, {GATE_D}], h [{GATE_ROWS}, "
                                 f"{GATE_D}], w [{gate_k}, {GATE_N}]",
                                 seeded_concat(GATE_ROWS, gate_k, GATE_N, 8, device))):
        m, d, dh, n = x.shape[0], x.shape[2], h.shape[1], w.shape[1]
        bound = products_bound_ms(4 * (m * d + m * dh + (d + dh) * n + m * n),
                                  (2.0 * m * (d + dh) * n, "bf16_3x"))
        out["concat_dot"][label] = row(
            lambda: concat_dot(x, t, h, w), lambda: concat_dot_reference(x, t, h, w),
            lambda: torch.matmul(torch.cat([x[:, t], h], -1), w), bound,
            "torch.cat + fp32 torch.matmul")
    for name, at in out.items():
        for label, r in at.items():
            library = ("none" if r["library_ms"] is None else
                       f"{r['library_ms']:.4f} ({r['library_event_ms']:.4f})")
            bf16_matmul = ("" if "library_bf16_matmul_ms" not in r else
                           f", bf16 torch.matmul (a bf16 result) {r['library_bf16_matmul_ms']:.4f} "
                           f"({r['library_bf16_matmul_event_ms']:.4f})")
            print(f"time {name} at {label}: {r['ms']:.4f} ms on the device "
                  f"({r['event_ms']:.4f} ms a call back to back), plain {r['plain_ms']:.4f} "
                  f"({r['plain_event_ms']:.4f}), library {r['library_call']} {library}"
                  f"{bf16_matmul}, bound {r['bound_ms']:.6f} ms by "
                  f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.2f} % of the kernel's time)"
                  + (" (launch-bound)" if label.startswith("probe") else ""), flush=True)
    return out


def _v3_checks(params, device, rng, check: Checks) -> None:
    """tpu_check's checks of the v3.1 kernels and tiers (tpu_check.py:128-252),
    and forward_fused, encode_fused_audio beside them."""
    import torch

    from vadc_tpu_torch.engine.runner import StreamRunner
    from vadc_tpu_torch.io.synthaudio import utterance_track
    from vadc_tpu_torch.kernels.lstm import lstm_fused
    from vadc_tpu_torch.kernels.lstm_decoder import lstm_decoder_fused
    from vadc_tpu_torch.kernels.silero_v31_fused import (
        encode_fused_audio, encode_fused_audio_reference, forward_fused, forward_fused_reference,
    )
    from vadc_tpu_torch.kernels.silero_v31_fused2d import forward_fused2d, forward_fused2d_reference
    from vadc_tpu_torch.kernels.silero_v31_fused3d import forward_fused3d
    from vadc_tpu_torch.kernels.stft_dotmag import dot_magnitude, split_basis
    from vadc_tpu_torch.kernels.tier_check import SPEECH_BOUND
    from vadc_tpu_torch.models import silero_v31
    from vadc_tpu_torch.nn import functional as F
    from vadc_tpu_torch.nn.precision import bf16

    def t(shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * np.float32(scale)).to(device)

    # ---- the fused LSTM kernels ----
    x, h0, c0 = t((8, 7, 64)), t((2, 8, 64), 0.1), t((2, 8, 64), 0.1)
    want = F.lstm(x, h0, c0, params["lstm_w"], params["lstm_b"])
    got = lstm_fused(x, h0, c0, params["lstm_w"], params["lstm_b"])
    check("lstm_fused", max(max_abs(a, b) for a, b in zip(got, want)), 1e-5)

    audio = t((8, 1536), 0.1)
    h, c = silero_v31.init_state(8, device)
    probs_ref, _, _ = forward_fused_reference(params, audio, h, c)
    feats = silero_v31.encode_nlc(params, audio)
    probs, _, _ = lstm_decoder_fused(feats, h, c, params["lstm_w"], params["lstm_b"],
                                     params["dec_w"], params["dec_b"])
    check("lstm_decoder_fused", max_abs(probs, probs_ref), 1e-5)

    # ---- dot_magnitude on bf16 frames and bases (the turbo tier's operands) ----
    basis = params["stft_basis"]
    frames = F.frame(F.reflect_pad_last(t((8, 1536), 0.1), 128, 128), 256, 64)
    spec = torch.einsum("bfn,cn->bfc", bf16(frames), bf16(basis))
    mag_ref = torch.sqrt(spec[:, :, :129] ** 2 + spec[:, :, 129:] ** 2)
    wr, wi = split_basis(basis)
    check("stft_dotmag_kernel", max_abs(dot_magnitude(frames, wr, wi, "turbo"), mag_ref), 1e-5)

    # ---- the whole-model fused kernel (2d and 3d entries), state carried ----
    for name, kernel in (("fused2d", forward_fused2d), ("fused3d", forward_fused3d)):
        hf, cf, hr, cr = h, c, h, c
        worst = 0.0
        for _ in range(2):
            feats = silero_v31.features(params, t((8, 1536), 0.1))
            p_ref, hr, cr = forward_fused2d_reference(params, feats, hr, cr)
            p_f, hf, cf = kernel(params, feats, hf, cf)
            worst = max(worst, max_abs(p_f, p_ref))
        check(f"{name}_forward_state_carry", worst, 1e-5)

    # ---- the whole v3.1 step from raw audio, and its encoder entry, each
    # against its plain version fed the kernel's own spectrum ----
    worst_p, worst_state = 0.0, 0.0
    hf, cf = h, c
    for _ in range(2):
        a = t((8, 1536), 0.1)
        # dot_magnitude's spectrum, which the kernel overwrites with its own
        # (the same bits, chip_smoke.py: check_forward_fused)
        spect = dot_magnitude(F.frame(F.reflect_pad_last(a, 128, 128), 256, 64), wr, wi)
        p_f, hn, cn = forward_fused(params, a, hf, cf, spectrum=spect)
        p_r, hn_r, cn_r = forward_fused_reference(params, a, hf, cf, spectrum=spect)
        worst_p = max(worst_p, max_abs(p_f, p_r))
        worst_state = max(worst_state, max_abs(hn, hn_r), rel_err(cn, cn_r))
        hf, cf = hn, cn
    check("forward_fused", worst_p, 1e-5, f" (state {worst_state:.2e})")
    a = t((8, 1536), 0.1)
    mag = dot_magnitude(F.frame(F.reflect_pad_last(a, 128, 128), 256, 64), wr, wi)
    check("encode_fused_audio",
          rel_err(encode_fused_audio(params, a), encode_fused_audio_reference(params, a, spectrum=mag)),
          1e-5, " (relative to the largest activation)")

    # ---- the tiers against faithful on noise ----
    chunks = t((64, 8, 1536), 0.1)
    runners = {tier: StreamRunner("v3", params, device=device, precision=tier)
               for tier in ("faithful", "balanced", "fast", "turbo")}
    scans = {tier: runners[tier].scan(chunks, runners[tier].init_state(64))[0]
             for tier in ("faithful", "fast", "balanced")}
    check("fast_vs_faithful_probability", max_abs(scans["fast"], scans["faithful"]), 2e-2)
    check("balanced_vs_faithful_probability", max_abs(scans["balanced"], scans["faithful"]), 1e-4)

    # ---- the tier ladder on speech-like material ----
    speech, _ = utterance_track(4, seed=0)
    n_sp = len(speech) // 1536
    sp_chunks = torch.from_numpy(speech[: n_sp * 1536].reshape(1, n_sp, 1536)).to(device)
    sp = {tier: r.scan(sp_chunks, r.init_state(1))[0][0] for tier, r in runners.items()}
    for tier in ("balanced", "fast", "turbo"):
        check(f"speech_{tier}_vs_faithful", max_abs(sp[tier], sp["faithful"]),
              SPEECH_BOUND["v3"][tier], f" (tpu_check's TPU bound {TPU_SPEECH_BOUND[tier]:.0e})")


def _stft_checks(device, rng, check: Checks) -> None:
    """stft_magnitude at the v4 and v5 geometries against its plain version,
    relative to the largest magnitude."""
    import torch

    from vadc_tpu_torch.kernels.stft_mag import (
        split_basis_of, stft_magnitude, stft_magnitude_reference,
    )
    from vadc_tpu_torch.models import silero_v4, silero_v5
    from vadc_tpu_torch.models.synthetic import random_v5_archive
    from vadc_tpu_torch.models.weights import DATA_DIR, load_params, load_params_from_tensors

    v4 = load_params(DATA_DIR / "silero_v4_16k.testtensor", device=device)[1]
    v5 = load_params_from_tensors(random_v5_archive(0), device=device)[1]
    for family, fparams, samples, kw in (
        ("v4", v4, 1536, dict(pad_left=silero_v4.STFT_PAD, pad_right=silero_v4.STFT_PAD,
                              hop=silero_v4.STFT_HOP)),
        ("v5", v5, silero_v5.CONTEXT_SAMPLES + 512,
         dict(pad_left=0, pad_right=silero_v5.STFT_PAD_RIGHT, hop=silero_v5.STFT_HOP)),
    ):
        audio = torch.from_numpy(rng.normal(size=(8, samples)).astype(np.float32) * 0.1).to(device)
        wr, wi = split_basis_of(fparams)
        want = stft_magnitude_reference(audio, wr, wi, **kw)
        got = stft_magnitude(audio, wr, wi, **kw)
        check(f"stft_magnitude_{family}", max_abs(got, want) / float(want.abs().max()), 1e-5,
              " (relative to the largest magnitude)")


def golden_checks(device, check: Checks, testdata: Path = TESTDATA) -> None:
    """The per-op golden fixtures through the port's ops
    (tools/torch_fidelity_report.run_cases), where they exist: the worst op
    and the LSTM's accumulation, each within 1e-4 (tpu_check.py:254-273)."""
    if not testdata.is_dir():
        print("golden fixtures unavailable; skipping fidelity tier", file=sys.stderr)
        return
    from tools.torch_fidelity_report import run_cases

    worst_op, worst_err, lstm_err = "", 0.0, 0.0
    for name, err in run_cases(testdata, device):
        if "lstm" in name.lower():
            lstm_err = max(lstm_err, err)
        elif err > worst_err:
            worst_op, worst_err = name, err
    check(f"golden_ops_worst({worst_op})", worst_err, 1e-4)
    check("golden_lstm_accumulation", lstm_err, 1e-4)


def run_checks(device="cuda") -> dict:
    """Every check on `device` ("cuda": the kernels; "cpu": their plain
    versions, for a rehearsal): {"check": "gpu_kernels", "ok", "failures",
    "seconds", "results", "probes"}."""
    import torch

    from vadc_tpu_torch.models.weights import DEFAULT_WEIGHTS, load_params
    from vadc_tpu_torch.runtime import on_device, resolve_device

    device = resolve_device(device)
    t0 = time.time()
    check = Checks()
    with on_device(device), torch.no_grad():
        params = load_params(DEFAULT_WEIGHTS, device=device)[1]
        rng = np.random.default_rng(0)
        _v3_checks(params, device, rng, check)
        _stft_checks(device, rng, check)
        golden_checks(device, check)
        probes = probe_checks(device, check)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return {
        "check": "gpu_kernels",
        "ok": not check.failures,
        "failures": check.failures,
        "seconds": round(time.time() - t0, 1),
        "results": {k: float(f"{v:.3e}") for k, v in check.results.items()},
        "probes": {k: float(f"{v:.3e}") for k, v in probes.items()},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gpu_check: no CUDA device is visible to PyTorch — this tier only means "
              "something on the card", file=sys.stderr)
        return 2
    summary = run_checks("cuda")
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
