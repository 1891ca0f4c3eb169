"""Real (unpadded) audio seconds of every window batch completed in the
window, over the time from the window's start to the end of the last of
them. Read from any run that recorded completed batches (`done`, each with
its `rows`, `real_s` and `t1`) and the window's start (`t0`), whatever its
traffic kind."""

LAYER = "end to end"
UNIT = "audio_s/s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    done = run.data.get("done")
    if not done or "t0" not in run.data:
        return None
    audio = sum(sum(b["real_s"][: b["rows"]]) for b in done)
    return audio / (max(b["t1"] for b in done) - run.data["t0"])
