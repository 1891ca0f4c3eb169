"""Client CLI — flag parity with the reference's run_client.py:8-58.

    python -m whisperlive_tpu_torch.cli.run_client --server localhost --port 9090 --files a.wav

The port's copy of whisperlive_tpu/cli/run_client.py.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="whisperlive-tpu client")
    parser.add_argument("--server", type=str, default="localhost",
                        help="Server hostname or IP.")
    parser.add_argument("--port", "-p", type=int, default=9090)
    parser.add_argument("--files", nargs="*", default=None,
                        help="Audio files to transcribe (omit for microphone).")
    parser.add_argument("--model", "-m", type=str, default="small")
    parser.add_argument("--lang", "-l", type=str, default=None)
    parser.add_argument("--translate", action="store_true",
                        help="Translate to English instead of transcribe.")
    parser.add_argument("--save_output_recording", action="store_true")
    parser.add_argument("--output_recording_filename", type=str,
                        default="./output_recording.wav")
    parser.add_argument("--enable_translation", action="store_true",
                        help="Enable server-side text translation.")
    parser.add_argument("--target_language", type=str, default=None)
    parser.add_argument("--word_timestamps", action="store_true")
    parser.add_argument("--timestamps", "--enable_timestamps",
                        dest="enable_timestamps", action="store_true",
                        help="Render '[start -> end] text' subtitle lines "
                             "(reference run_client.py --enable_timestamps).")
    parser.add_argument("--n_display_segments", type=int, default=10)
    parser.add_argument("--no_vad", action="store_true")
    parser.add_argument("--output_srt", type=str, default="output.srt")
    parser.add_argument("--api_key", type=str, default=None)
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from whisperlive_tpu_torch.client import TranscriptionClient

    client = TranscriptionClient(
        args.server,
        args.port,
        lang=args.lang,
        translate=args.translate,
        model=args.model,
        use_vad=not args.no_vad,
        save_output_recording=args.save_output_recording,
        output_recording_filename=args.output_recording_filename,
        enable_translation=args.enable_translation,
        target_language=args.target_language,
        word_timestamps=args.word_timestamps,
        enable_timestamps=args.enable_timestamps,
        n_display_segments=args.n_display_segments,
        send_last_n_segments=args.n_display_segments,
        srt_file_path=args.output_srt,
        api_key=args.api_key,
    )
    if args.files:
        for f in args.files:
            text = client(f)
            print(f"\n[{f}] {text}")
    else:
        client()


if __name__ == "__main__":
    main()
