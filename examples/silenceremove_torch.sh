#!/usr/bin/env bash
# Cut silence out of a media file using vadc_tpu_torch + ffmpeg.
# Counterpart of silenceremove.sh on the PyTorch/CUDA port:
#   detect speech segments -> build an aselect filterscript -> re-encode.
# Arguments after input and output go to the detector
# (python -m vadc_tpu_torch.cli.main), e.g. --device cpu or --precision fast;
# its device is the card unless one is given.
#
# For wav or raw PCM input no ffmpeg is needed at all — use the native
# one-step tool instead:  python -m vadc_tpu_torch.cli.cut noisy.wav clean.wav
#
# Usage: ./silenceremove_torch.sh input.mp3 output.mp3 [detector options]
set -euo pipefail

in="$1"
out="$2"
shift 2
script="$(mktemp --suffix=.txt)"
trap 'rm -f "$script"' EXIT

python -m vadc_tpu_torch.cli.main "$@" "$in" | python -m vadc_tpu_torch.cli.filter_script > "$script"
ffmpeg -hide_banner -i "$in" -af "$(cat "$script")" "$out"
