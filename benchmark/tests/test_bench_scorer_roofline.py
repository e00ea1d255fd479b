"""The scorer's roofline reader against hand-worked shapes."""

import pytest

from benchmark.layer_metrics import scorer_roofline

TOY = dict(num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=3,
           budget=dict(sink=4), pq=dict(n_subbits=2, select_block=64))


def test_scorer_bytes():
    # P 1000: 996 candidates -> 1024 -> 16 blocks of 64; C 4. A layer at
    # B 2: counts 2 * 2 * 16 * 16, factors 2 * 4 * 8 * 4, mass 2 * 4 * 16 * 4
    layer = 2 * 2 * 16 * 16 + 2 * 4 * 8 * 4 + 2 * 4 * 16 * 4
    assert scorer_roofline.scorer_bytes(TOY, 2, 1000) == 3 * layer


def test_read_matches_the_kernel_by_name():
    rec = dict(steps=2, batch=2, prompt_tokens=1000, model=TOY, events=[
        ("void (anonymous namespace)::jhist_mass_kernel<16, 4>(...)", "pq",
         1.0), ("block_attn_kernel", "fetch", 5.0),
        ("void (anonymous namespace)::jhist_mass_kernel<16, 4>(...)", "pq",
         1.0)])
    need = 2 * scorer_roofline.scorer_bytes(TOY, 2, 1000)
    assert scorer_roofline.read(rec) == pytest.approx(
        100 * need / 3.35e12 / 2e-6)


def test_read_is_silent_without_the_kernel():
    # the parent's program scores with an f32 copy and a GEMM
    rec = dict(steps=2, batch=2, prompt_tokens=1000, model=TOY, events=[
        ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8", "pq",
         3.0)])
    assert scorer_roofline.read(rec) is None
    assert scorer_roofline.read(None) is None
