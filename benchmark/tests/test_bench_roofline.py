"""Operations and bytes of the roofline, against hand-worked shapes."""

import pytest

from benchmark import roofline
from benchmark.common import budget

TOY = dict(hidden_size=8, intermediate_size=16, num_attention_heads=4,
           num_key_value_heads=2, head_dim=2, num_hidden_layers=3,
           vocab_size=10, budget=dict(compress_ratio=0.2, recent_ratio=0.5,
                                      sink=4),
           pq=dict(select_block=4), precision=dict(kv_tail="int8"))


def test_budget_follows_the_port_arithmetic():
    # P 104: n = 100 -> local int(100 * .1) = 10, topk 10, 3 blocks of 4
    b = budget(TOY, 104)
    assert (b["sink"], b["local"], b["topk"], b["blocks"]) == (4, 10, 10, 3)


def test_step_flops():
    # weights a layer: 8*8 + 8*4 + 8*4 + 8*8 + 3 * 8*16 = 576; 3 layers and
    # a head of 8*10: 1808; attended rows 4 + 12 + 10 + 1 = 27
    want = 2 * 1808 * 5 + 3 * 5 * 4 * 4 * 2 * 27
    assert roofline.step_flops(TOY, 5, 104) == want


def test_k1_bytes():
    # B 2, int8 tail: rows 12 + 10 - ring 3 = 19 of 2 * D bytes for 2 * 2
    # folded kv heads; q f32 2 * 4 * 2 * 4; ids 2 * 2 * 3 * 8; out
    # 2 * 4 * (2 + 2) * 4
    want = 2 * 2 * 19 * 4 + 64 + 96 + 128
    assert roofline.k1_bytes(TOY, 2, 104, 3, 1) == want
    # a bf16 tail: twice the rows' bytes, a bf16 query
    assert roofline.k1_bytes(TOY, 2, 104, 3, 2) == \
        2 * 2 * 19 * 4 * 2 + 32 + 96 + 128


def test_w8_step_bytes():
    # a layer: weights 576 + scales 2 * (8+4+4+8+16+16+8) = 128; x in
    # (8 + 8 + 8 + 16) and y out 64 rows of bf16 at B 1; the head 80 + 20
    # + 16 + 40
    layer = 576 + 128 + 2 * (40 + 64)
    assert roofline.w8_step_bytes(TOY, 1) == 3 * layer + 80 + 20 + 16 + 40


def test_peaks_are_the_published_h100_sxm_ones():
    assert roofline.PEAK_BF16 == pytest.approx(989e12)
    assert roofline.PEAK_BYTES == pytest.approx(3.35e12)
