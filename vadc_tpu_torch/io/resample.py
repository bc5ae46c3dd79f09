# Copy of vadc_tpu/io/resample.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""Streaming rational resampler (polyphase windowed-sinc).

The reference delegates ALL sample-rate conversion to a spawned ffmpeg
(`-ar 16k`, reference vadc.c:531-608); this module is the native
equivalent for the WAV ingest path (io/wav.py), so `vadc file.wav` needs
no external decoder at any source rate.

Design: classic L/M polyphase. Conceptually the input is upsampled by L
(zero insertion), lowpass-filtered with an ntaps = K*L windowed-sinc
centered FIR, and decimated by M, where L/M = sr_out/sr_in in lowest
terms. Output sample m sits at upsampled index q = m*M + c with
c = (ntaps-1)//2 — the +c cancels the FIR group delay exactly, so the
output is time-aligned with the input (an impulse at input sample n peaks
at output round(n*L/M)). Per output only the K taps of phase q mod L
touch nonzero input, so the work is K MACs per output sample — at K=32
and 16 kHz out that is ~0.5 M MACs/s, noise on the host next to the
device model.

The streaming form keeps the last K-1 input samples as history and tracks
absolute input/output counts, so feeding the signal in arbitrary block
sizes is bit-identical to one-shot processing (asserted in
tests/test_resample.py).
"""

from __future__ import annotations

import math

import numpy as np


class PolyphaseResampler:
    """Convert a float32 stream from sr_in to sr_out.

    Push input blocks with process(); call flush() once at EOF to drain
    the filter tail. Output length over a whole stream is
    ceil(n_in * L / M) — duration-preserving to within one sample.

    taps_per_phase (K) and the Kaiser beta trade quality for filter
    design cost; the defaults give > 60 dB stopband, more than enough
    headroom over the s16 quantization floor the pipeline feeds.
    """

    def __init__(
        self,
        sr_in: int,
        sr_out: int,
        *,
        taps_per_phase: int = 32,
        beta: float = 9.0,
        rolloff: float = 0.945,
    ):
        if sr_in <= 0 or sr_out <= 0:
            raise ValueError("sample rates must be positive")
        self.sr_in = int(sr_in)
        self.sr_out = int(sr_out)
        self.passthrough = self.sr_in == self.sr_out
        if self.passthrough:
            return
        g = math.gcd(self.sr_in, self.sr_out)
        self.L = self.sr_out // g
        self.M = self.sr_in // g
        # Filter sharpness must track the upsampled-domain cutoff 1/max(L,M)
        # — sizing by L alone starves pure decimation (L=1) of taps. The
        # length is forced ODD so the group delay (ntaps-1)/2 is an integer
        # number of upsampled samples; an even length leaves a half-sample
        # misalignment, invisible at L=160 but 0.5 input samples at L=1.
        half = (int(taps_per_phase) * max(self.L, self.M)) // 2
        ntaps = 2 * half + 1
        n = np.arange(ntaps, dtype=np.float64) - half
        # cutoff: the narrower of the two Nyquists, as a fraction of the
        # upsampled-domain Nyquist (sr_in * L / 2)
        fc = rolloff * min(1.0 / self.L, 1.0 / self.M)
        h = fc * np.sinc(fc * n) * np.kaiser(ntaps, beta)
        # pad to a multiple of L for the polyphase reshape (appended zeros
        # never touch data and leave the center at `half`)
        K = -(-ntaps // self.L)
        h = np.concatenate([h, np.zeros(K * self.L - ntaps)])
        # exact DC flatness: each polyphase branch (the K taps any single
        # output uses) must sum to 1, or a constant input picks up a
        # phase-periodic ripple. Normalize per phase.
        phase_sums = h.reshape(K, self.L).sum(axis=0)
        h = (h.reshape(K, self.L) / phase_sums[None, :]).reshape(K * self.L)
        self._h = h.astype(np.float64)
        # per-phase taps, REVERSED so a contiguous input window dots
        # directly: y[m] = h_rev[p] . x[i_hi-K+1 : i_hi+1]
        self._hrev = np.stack(
            [h[p :: self.L][::-1] for p in range(self.L)]
        ).astype(np.float64)
        self._K = K
        self._c = half
        # history carries the K-1 most recent input samples (zeros before
        # the stream starts = the x[i<0]=0 convention)
        self._hist = np.zeros(K - 1, np.float64)
        self._n_in = 0  # absolute input samples consumed
        self._m = 0  # absolute output samples produced
        self._flushed = False

    # -- internals ---------------------------------------------------------

    def _emit(self, buf: np.ndarray, base: int, m_stop: int) -> np.ndarray:
        """Produce outputs [self._m, m_stop) from buf, where buf[j] is
        absolute input sample base + j (base = self._n_in - len(buf) after
        history prepend)."""
        count = m_stop - self._m
        if count <= 0:
            return np.empty(0, np.float32)
        m0, K, L, M = self._m, self._K, self.L, self.M
        # windows[j] = buf[j : j+K]; output m uses the window ending at its
        # newest input sample i_hi = (m*M + c) // L:
        #   y[m] = hrev[(m*M + c) % L] . windows[i_hi - base - (K-1)]
        # Outputs in the same residue class mod L share a phase and their
        # windows advance by exactly M rows, so each class is ONE strided
        # matvec (BLAS) instead of per-output index gathers.
        windows = np.lib.stride_tricks.sliding_window_view(buf, K)
        y = np.empty(count, np.float64)
        for r in range(min(L, count)):
            q = (m0 + r) * M + self._c
            n_r = (count - r + L - 1) // L
            i0 = q // L - base - (K - 1)
            y[r::L] = windows[i0 : i0 + (n_r - 1) * M + 1 : M] @ self._hrev[q % L]
        self._m = m_stop
        return y.astype(np.float32)

    def _push(self, x: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self._hist, x.astype(np.float64)])
        base = self._n_in - self._hist.shape[0]
        self._n_in += x.shape[0]
        # newest usable output: needs i_hi <= n_in - 1, i.e.
        # q <= (n_in * L) - 1  =>  m <= (n_in * L - 1 - c) / M
        m_stop = (self._n_in * self.L - 1 - self._c) // self.M + 1
        y = self._emit(buf, base, max(m_stop, self._m))
        if self._K > 1:
            self._hist = buf[-(self._K - 1):]
        return y

    # -- public API --------------------------------------------------------

    def process(self, x: np.ndarray) -> np.ndarray:
        """Feed a block of input samples; returns the output samples that
        became computable (float32, possibly empty)."""
        if self.passthrough:
            return np.asarray(x, np.float32)
        if self._flushed:
            raise RuntimeError("process() after flush()")
        x = np.asarray(x, np.float64).ravel()
        if x.size == 0:
            return np.empty(0, np.float32)
        return self._push(x)

    def flush(self) -> np.ndarray:
        """Drain the tail: returns the remaining output so the total output
        length is ceil(n_in * L / M)."""
        if self.passthrough:
            return np.empty(0, np.float32)
        if self._flushed:
            return np.empty(0, np.float32)
        self._flushed = True
        m_total = -(-self._n_in * self.L // self.M)  # ceil
        if m_total <= self._m:
            return np.empty(0, np.float32)
        # zero-pad enough virtual input for every remaining output's taps
        pad = self._K + (m_total * self.M + self._c) // self.L - self._n_in + 1
        buf = np.concatenate([self._hist, np.zeros(max(pad, 0), np.float64)])
        base = self._n_in - self._hist.shape[0]
        return self._emit(buf, base, m_total)
