"""The traffic generator: the same seed gives the same requests, every seed
gives the same work, and seeds far past 32 bits work."""

import collections

import pytest

from portbench import traffic

MIXES = ["gen", "rag"]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = traffic.load_mix(mix)
    a = traffic.make_requests(m, 32000, 2**40 + 17)
    b = traffic.make_requests(m, 32000, 2**40 + 17)
    assert [(s.prompt, s.max_new_tokens, s.temperature) for s in a] == \
        [(s.prompt, s.max_new_tokens, s.temperature) for s in b]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_work(mix):
    """Every seed sends the same lengths in the same order; only the token
    ids move.  Each block holds the same multiset of lengths."""
    m = traffic.load_mix(mix)
    blk = m["block"]
    runs = [traffic.make_requests(m, 102400, s) for s in (1, 2**31 + 5, -3)]
    shapes = [[(len(s.prompt), s.max_new_tokens, s.temperature) for s in r] for r in runs]
    assert shapes[0] == shapes[1] == shapes[2]
    assert runs[0][0].prompt != runs[1][0].prompt
    first = collections.Counter(p for p, _, _ in shapes[0][:blk])
    for b0 in range(blk, m["requests"] - blk + 1, blk):
        assert collections.Counter(p for p, _, _ in shapes[0][b0:b0 + blk]) == first


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_keep_to_the_mix(mix):
    m = traffic.load_mix(mix)
    reqs = traffic.make_requests(m, 32000, 99)
    assert len(reqs) == m["requests"]
    for s in reqs:
        assert m["prompt_len"]["min"] <= len(s.prompt) <= m["prompt_len"]["max"]
        assert 2 <= s.max_new_tokens <= m["output_len"]["max"]
        if m["max_total"] is not None:
            assert len(s.prompt) + s.max_new_tokens <= m["max_total"]
        assert all(0 <= t < 32000 for t in s.prompt)
    greedy = sum(s.temperature == 0 for s in reqs)
    assert greedy == (len(reqs) if m["temperature"] <= 0 else len(reqs) // m["greedy_every"])


def test_stratified_lengths_follow_the_lognormal():
    dist = {"median": 128, "sigma": 0.6, "min": 32, "max": 512}
    v = traffic.stratified_lengths(dist, 32)
    assert v == sorted(v) and v[0] >= 32 and v[-1] <= 512
    assert abs(v[15] - 128) <= 6 and abs(v[16] - 128) <= 6


def test_sub_seed_is_stable_and_63_bits():
    assert traffic.sub_seed(5, "x") == traffic.sub_seed(5, "x")
    assert traffic.sub_seed(5, "x") != traffic.sub_seed(6, "x")
    assert 0 <= traffic.sub_seed(2**70, "layer3") < 2**63
