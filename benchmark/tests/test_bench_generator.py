"""The traffic generator: deterministic from the seed, the same sizes on
every seed, no exact zero in the audio."""

import numpy as np

from benchmark import generator


def test_stream_traffic_is_the_seed_s():
    mix = generator.load_mix("stream20")
    a = generator.stream_traffic(mix, 2 ** 33 + 5, 3.0)
    b = generator.stream_traffic(mix, 2 ** 33 + 5, 3.0)
    c = generator.stream_traffic(mix, 2 ** 33 + 6, 3.0)
    assert [s["uid"] for s in a] == [s["uid"] for s in b]
    assert all(np.array_equal(x["audio"], y["audio"]) for x, y in zip(a, b))
    assert not all(np.array_equal(x["audio"], y["audio"]) for x, y in zip(a, c))
    # the same starts and lengths on every seed
    assert sorted((s["start_s"], len(s["audio"])) for s in a) == sorted(
        (s["start_s"], len(s["audio"])) for s in c)
    assert len(a) == mix["streams"]
    starts = sorted(s["start_s"] for s in a)
    assert starts[0] == -(mix["stagger_s"] + mix["settle_s"])
    assert starts[-1] < -mix["settle_s"]


def test_files_have_the_same_durations_on_every_seed():
    mix = generator.load_mix("files16")
    a, b = generator.FileBank(mix, 7), generator.FileBank(mix, 8)
    assert a.durations == b.durations
    lo, hi = mix["duration_s"]
    assert lo < min(a.durations) and max(a.durations) < hi
    la = sorted(len(f) for f in a.call(3))
    assert la == sorted(len(f) for f in b.call(3)) == sorted(len(f) for f in a.call(4))
    assert all(np.array_equal(x, y) for x, y in zip(a.call(3), generator.FileBank(mix, 7).call(3)))
    assert not all(np.array_equal(x, y) for x, y in zip(a.call(3), a.call(4)))


def test_audio_has_no_exact_zero_and_real_length_is_found():
    mix = generator.load_mix("files16")
    x = generator.speech_like(np.random.default_rng(3), 16000 * 5, mix["signal"])
    assert x.dtype == np.float32 and np.all(x != 0)
    row = np.zeros(16000 * 30, np.float32)
    row[: len(x)] = x
    assert generator.real_samples(row) == len(x)
    assert generator.real_samples(np.zeros(10, np.float32)) == 0
