"""The traffic is a function of the seed: the same seed gives the same
bytes, another seed other bytes, and every seed the same amount of work."""

import statistics

import numpy as np
import pytest

from vadbench import harness
from vadbench.kinds import corpus
from vadbench.traffic import audio

LIB = {"voiced_s": [0.5, 4.0], "pause_s": [0.3, 2.0], "voiced_pieces": 6, "pause_pieces": 4,
       "f0_hz": [140.0, 210.0], "gain_min": 0.5, "gain_max": 1.5, "gain_levels": 3}
SEEDS = (7, 2**31 + 5, 3_999_999_937)


def test_same_seed_same_bytes_other_seed_other_bytes():
    def pcm(seed):
        lib = audio.Library(seed, LIB)
        return [audio.stream_bytes(lib, seed, i, 2 * 40 * 1536) for i in range(3)]

    a, b, c = pcm(SEEDS[1]), pcm(SEEDS[1]), pcm(SEEDS[2])
    assert a == b
    assert [len(x) for x in a] == [len(x) for x in c] and a != c
    assert all(x != y for x, y in zip(a, c))


def test_a_stream_is_the_same_however_it_is_taken():
    lib = audio.Library(3, LIB)
    s = audio.Stream(lib, 3, 5)
    pieces = b"".join(s.take(n) for n in [12, 3060] + [3072] * 50 + [7, 100001])
    assert pieces == audio.stream_bytes(lib, 3, 5, len(pieces))


def test_the_corpus_is_seeded_and_every_seed_carries_the_same_audio():
    tr = {**harness.cell("v31.corpus.512").traffic, "files": 4, "file_s": [2.0, 3.0],
          "library": LIB}
    a = corpus.corpus_pcm(SEEDS[0], tr, 16000, 1536)
    assert a.tobytes() == corpus.corpus_pcm(SEEDS[0], tr, 16000, 1536).tobytes()
    assert a.tobytes() != corpus.corpus_pcm(SEEDS[1], tr, 16000, 1536).tobytes()
    lengths = [sorted(corpus.file_lengths(s, harness.cell("v31.corpus.512").traffic, 16000))
               for s in SEEDS]
    assert lengths[0] == lengths[1] == lengths[2]
    assert abs(sum(lengths[0]) / 16000 - 512 * 60) < 1.0


def test_the_corpus_written_is_the_corpus_the_reference_reads(tmp_path):
    tr = {"files": 3, "file_s": [1.0, 2.0], "library": LIB}
    paths = corpus.write_corpus(11, tr, 16000, str(tmp_path))
    pcm = corpus.corpus_pcm(11, tr, 16000, 1536)
    for i, (path, n) in enumerate(zip(paths, corpus.file_lengths(11, tr, 16000))):
        assert np.array_equal(np.fromfile(path, "<i2"), pcm[i, :n])


@pytest.mark.parametrize("seed", SEEDS)
def test_evenly_spaced_lengths_are_as_they_were(seed):
    # the lengths before the log-normal mix came: evenly spaced, permuted
    tr = harness.cell("v31.corpus.512").traffic
    lengths = np.round(np.linspace(45.0, 75.0, 512) * 16000).astype(np.int64)
    was = np.random.default_rng([seed, 4]).permutation(lengths)
    assert np.array_equal(corpus.file_lengths(seed, tr, 16000), was)


def test_log_normal_lengths_are_the_clipped_quantiles_for_every_seed():
    tr = {"files": 200, "file_s": [5.0, 600.0],
          "file_s_lognormal": {"median": 40.0, "sigma": 1.2}}
    normal = statistics.NormalDist()
    want = [round(min(max(40.0 * np.exp(1.2 * normal.inv_cdf((i + 0.5) / 200)), 5.0), 600.0)
                  * 16000) for i in range(200)]
    got = [corpus.file_lengths(seed, tr, 16000) for seed in SEEDS]
    for lengths in got:
        assert sorted(lengths.tolist()) == want
    assert not np.array_equal(got[0], got[1])  # the order is the seed's
    # both clips bite at these figures, and the median is the mix's
    assert want[0] == 5 * 16000 and want[-1] == 600 * 16000
    assert want[99] < 40 * 16000 < want[100]
