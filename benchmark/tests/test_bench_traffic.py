"""The decode_turns traffic and the weights come from the seed alone."""

import numpy as np
import torch

from benchmark import weights
from benchmark.common import rng
from benchmark.drivers import decode_turns
from benchmark.tests import tiny

BIG = 2 ** 31 + 12345       # seeds past 32 signed bits


def _traffic(seed):
    wl = tiny.cell()
    V = wl["model"]["vocab_size"]
    ids = rng(seed, 1).integers(0, V, wl["prompt_tokens"])
    firsts = rng(seed, 2)
    turns = [firsts.integers(0, V, wl["batch"]) for _ in range(3)]
    fake = [(t, np.zeros((wl["turn_tokens"], wl["batch"]), np.int32))
            for t in turns]
    return ids, turns, decode_turns.sample(fake, wl, seed)


def test_same_seed_same_traffic():
    a, b = _traffic(BIG), _traffic(BIG)
    assert np.array_equal(a[0], b[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[2] == b[2]


def test_other_seed_other_traffic_same_sizes():
    a, b = _traffic(BIG), _traffic(BIG + 1)
    assert not np.array_equal(a[0], b[0])
    assert a[0].shape == b[0].shape and len(a[2]) == len(b[2])


def test_sample_takes_finished_turns_only():
    wl = tiny.cell()
    B, T = wl["batch"], wl["turn_tokens"]
    turns = [(np.zeros(B), np.zeros((T, B))), (np.zeros(B),
                                              np.zeros((T // 2, B)))]
    picks = decode_turns.sample(turns, wl, 7)
    assert picks and all(i == 0 for i, _ in picks)


def test_weights_from_the_seed():
    m = tiny.cell()["model"]
    a = weights.draw(m, BIG, "cpu")
    b = weights.draw(m, BIG, "cpu")
    c = weights.draw(m, BIG + 1, "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["wq"].shape == (m["num_hidden_layers"],
                                       m["hidden_size"],
                                       m["num_attention_heads"]
                                       * m["head_dim"])
