"""Terminal subtitle rendering, SRT/VTT writing (whisper_live/utils.py twin).

The port's copy of whisperlive_tpu/utils/text.py: the client renders the
rolling transcript, the offline CLI and the REST endpoint write subtitles.
"""

from __future__ import annotations

import os
import textwrap
from typing import List


def clear_screen() -> None:
    os.system("cls" if os.name == "nt" else "clear")


def print_transcript(
    text, translated: bool = False, timestamps: bool = False, max_lines: int = 0
) -> None:
    """Wrapped terminal rendering of the rolling transcript (utils.py:10-35).

    timestamps=True renders `[start -> end] text` lines from segment dicts,
    with continuation lines indented under the text column; otherwise
    `text` is a list of plain strings (joined with spaces when translated).
    """
    try:
        cols = os.get_terminal_size().columns
    except OSError:
        cols = 80
    wrap_width = max(cols - 6, 20)
    lines: List[str] = []
    if timestamps:
        for t in text:
            prefix = f'[{t["start"]} -> {t["end"]}] '
            wrapper = textwrap.TextWrapper(
                width=wrap_width, subsequent_indent=" " * len(prefix)
            )
            lines.extend(wrapper.wrap(f'{prefix}{t["text"]}'))
    else:
        joined = " ".join(text) if translated else list(text)
        wrapper = textwrap.TextWrapper(width=wrap_width)
        if translated:
            lines = wrapper.wrap(joined)
        else:
            for t in joined:
                lines.extend(wrapper.wrap(t))
    if max_lines:
        lines = lines[-max_lines:]
    print("\n".join(lines))


def format_time(seconds: float, vtt: bool = False) -> str:
    """SRT `HH:MM:SS,mmm` / VTT `HH:MM:SS.mmm` (utils.py:38-46)."""
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    sep = "." if vtt else ","
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def segments_to_srt(segments: List[dict]) -> str:
    out = []
    for i, seg in enumerate(segments, start=1):
        out.append(str(i))
        out.append(
            f"{format_time(float(seg['start']))} --> {format_time(float(seg['end']))}"
        )
        out.append(seg["text"].strip())
        out.append("")
    return "\n".join(out)


def segments_to_vtt(segments: List[dict]) -> str:
    out = ["WEBVTT", ""]
    for seg in segments:
        out.append(
            f"{format_time(float(seg['start']), vtt=True)} --> "
            f"{format_time(float(seg['end']), vtt=True)}"
        )
        out.append(seg["text"].strip())
        out.append("")
    return "\n".join(out)


def create_srt_file(segments: List[dict], output_path: str) -> None:
    """SRT writer (utils.py:48-59)."""
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(segments_to_srt(segments))
