"""Real (unpadded) audio seconds of every window batch completed in the
window, over the time from the window's start to the end of the last of
them."""

LAYER = "end to end"
UNIT = "audio_s/s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    if run.kind != "files" or not run.data["done"]:
        return None
    done = run.data["done"]
    audio = sum(sum(b["real_s"][: b["rows"]]) for b in done)
    return audio / (max(b["t1"] for b in done) - run.data["t0"])
