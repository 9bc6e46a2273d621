"""The traffic generator: a seed fixes the stream, lengths stay inside
each range, and every seed sends the same sizes in the same order."""
import collections

import numpy as np

from perfbench.tests.conftest import small_mix
from perfbench.traffic import Stream, load_mix, strata, warm_prompts


def test_same_seed_same_stream():
    mix = load_mix("chat-c8")
    a, b = Stream(mix, 2**31 + 5, 1000), Stream(mix, 2**31 + 5, 1000)
    for j in range(150):
        (pa, na), (pb, nb) = a.request(j), b.request(j)
        assert na == nb and np.array_equal(pa, pb)
    c = Stream(mix, 2**31 + 6, 1000)
    assert any(not np.array_equal(a.request(j)[0], c.request(j)[0])
               for j in range(10))


def test_lengths_within_ranges_and_ids_within_vocab():
    for name in ("chat-c8", "longdoc-c8"):
        mix = load_mix(name)
        s = Stream(mix, 123456789012, 153376)
        for j in range(200):
            prompt, new = s.request(j)
            assert mix["prompt_tokens"][0] <= len(prompt) \
                <= mix["prompt_tokens"][1]
            assert mix["new_tokens"][0] <= new <= mix["new_tokens"][1]
            assert prompt.dtype == np.int32
            assert 0 <= prompt.min() and prompt.max() < 153376
            assert len(prompt) <= max(mix["prompt_buckets"])


def test_every_seed_sends_the_same_sizes_in_the_same_order():
    mix = load_mix("chat-c8")
    n = mix["strata"]
    runs = []
    for seed in (1, 2, 3**30):
        s = Stream(mix, seed, 1000)
        sizes = [(len(s.request(j)[0]), s.request(j)[1])
                 for j in range(3 * n)]
        runs.append(sizes)
        # each block of ``strata`` requests takes every step once
        for b in range(3):
            block = sizes[b * n:(b + 1) * n]
            assert collections.Counter(p for p, _ in block) == \
                collections.Counter(strata(*mix["prompt_tokens"], n).tolist())
            assert collections.Counter(m for _, m in block) == \
                collections.Counter(strata(*mix["new_tokens"], n).tolist())
        # in an order that is not the sorted one, and differs by block
        assert sizes[:n] != sorted(sizes[:n]) and sizes[:n] != sizes[n:2 * n]
    assert runs[0] == runs[1] == runs[2]


def test_strata_are_log_uniform():
    s = strata(128, 1024, 64)
    assert s[0] >= 128 and s[-1] <= 1024
    ratios = s[1:] / s[:-1]
    assert np.allclose(ratios, ratios.mean(), rtol=0.02)


def test_warm_prompts_cover_every_group_shape():
    mix = small_mix()
    shapes = {(len(g), len(g[0])) for g in warm_prompts(mix, 7, 256)}
    assert shapes == {(n, b) for b in mix["prompt_buckets"]
                      for n in (1, 2, 4)}
