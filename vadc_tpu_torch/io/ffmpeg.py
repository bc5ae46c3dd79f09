# Copy of vadc_tpu/io/ffmpeg.py (numpy only): the port imports nothing of vadc_tpu
# and keeps its own; tests/test_torch_copies.py holds it to the original.
"""ffmpeg subprocess audio source.

Spawns ffmpeg to decode any media file to raw mono 16 kHz s16le on a pipe,
with the same option surface as the reference (vadc.c:531-608): seek offset,
audio-stream index, forced mono/16k/s16le."""

from __future__ import annotations

import subprocess
from typing import BinaryIO


def ffmpeg_command(
    filename: str, *, audio_source: int = 0, start_seconds: float = 0.0,
    sample_rate: int = 16000,
) -> list[str]:
    return [
        "ffmpeg",
        "-hide_banner",
        "-loglevel", "error",
        "-nostats",
        "-ss", f"{start_seconds:f}",
        "-i", filename,
        "-map", f"0:a:{audio_source}",
        "-vn", "-sn", "-dn",
        "-ac", "1",
        # exact Hz, not the reference's "16k" shorthand (vadc.c:543):
        # f"{sr // 1000}k" silently truncates non-multiple-of-1000 rates
        "-ar", str(sample_rate),
        "-f", "s16le",
        "-",
    ]


class FFmpegSource:
    """Context manager yielding a binary stream of decoded s16le PCM."""

    def __init__(
        self,
        filename: str,
        *,
        audio_source: int = 0,
        start_seconds: float = 0.0,
        sample_rate: int = 16000,
    ):
        self._cmd = ffmpeg_command(
            filename,
            audio_source=audio_source,
            start_seconds=start_seconds,
            sample_rate=sample_rate,
        )
        self._proc: subprocess.Popen | None = None

    def __enter__(self) -> BinaryIO:
        self._proc = subprocess.Popen(
            self._cmd, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL
        )
        assert self._proc.stdout is not None
        return self._proc.stdout

    def eof_error_kind(self):
        """Refine the EOF error kind for BufferedStream: a decoder that
        exited nonzero (codec error, unreadable input, killed mid-file)
        latches BS_Error_Error instead of a clean EndOfFile — an ffmpeg
        crash is thereby distinguishable from end of audio (the reference
        cannot tell these apart; SURVEY §5.3)."""
        from vadc_tpu_torch.io.pcm import BSError

        if self._proc is None:
            return None
        rc = self._proc.poll()
        if rc is None:
            try:
                rc = self._proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                return None
        return BSError.Error if rc != 0 else None

    def __exit__(self, *exc) -> None:
        if self._proc is not None:
            if self._proc.stdout:
                self._proc.stdout.close()
            self._proc.wait()
            self._proc = None
