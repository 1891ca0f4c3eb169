"""SRT/VTT subtitle writing for the offline CLI.

The port's copy of the subtitle half of whisperlive_tpu/utils/text.py
(whisper_live/utils.py twin); the terminal rendering stays with the client.
"""

from __future__ import annotations

from typing import List


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
