"""The benchmark's work counts against hand counts at small shapes."""

import pytest

from dtxbench.harness import flops

C = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
     "num_attention_heads": 4, "num_key_value_heads": 4, "vocab_size": 512}
S = flops.Shapes(C)


def test_shapes():
    assert (S.D, S.F, S.L, S.H, S.KV, S.d, S.V) == (64, 128, 2, 4, 4, 16,
                                                     512)
    assert S.layer_params == 4 * 64 * 64 + 3 * 64 * 128


def test_train_step_by_hand():
    # two documents of 3 and 5 tokens, LoRA r2 on q_proj
    N, P = 8, 4 * 64 * 64 + 3 * 64 * 128
    fwd = 2 * N * P * 2
    dx = 2 * N * (P * 2 - 3 * 64 * 64)  # layer 0's q/k/v need no dx
    head = 2 * 2 * N * 64 * 512
    lora_layer = (2 * N * 64 * 2 + 2 * N * 2 * 64  # x·A, ·B
                  + 2 * N * 2 * 64 + 2 * N * 64 * 2 + 2 * N * 2 * 64)
    lora = 2 * lora_layer + 2 * N * 2 * 64  # dx through A but layer 0
    attn = 12 * 4 * 16 * (3 * 4 // 2 + 5 * 6 // 2) * 2
    got = flops.train_step_flops(S, [3, 5], ["q_proj"], 2)
    assert got == fwd + dx + head + lora + attn == 3528192


def test_train_attention_bytes_by_hand():
    f, b = flops.train_attention(S, [4])
    assert f == 12 * 64 * 10 * 2
    qo = kv = 4 * 64
    per_layer = (2 * (qo + 2 * kv + qo) + 4 * 4 * 4
                 + 2 * (3 * qo + 2 * kv) + 4 * 4 * 4 + 2 * (qo + 2 * kv))
    assert b == per_layer * 2


def test_nf4_by_hand():
    N = 8
    f, least = flops.train_nf4(S, N)
    by = {"q": (64, 64, 3), "k": (64, 64, 3), "v": (64, 64, 3),
          "o": (64, 64, 4), "gate": (64, 128, 4), "up": (64, 128, 4),
          "down": (128, 64, 4)}
    assert f == sum(2 * N * a * b * n for a, b, n in by.values())
    want = sum(n * max(2 * N * a * b / flops.BF16,
                       (a * b * 0.5 + a * b / 64 + 2 * N * (a + b))
                       / flops.HBM) for a, b, n in by.values())
    assert least == pytest.approx(want)


def test_decode_by_hand():
    P = 4 * 64 * 64 + 3 * 64 * 128
    assert flops.decode_token_flops(S, 10) == (2 * P * 2 + 2 * 64 * 512
                                               + 4 * 64 * 10 * 2)
    assert flops.decode_kv_bytes(S, 10) == 2 * 2 * 10 * 64 * 2
    assert flops.decode_attention_flops(S, 10) == 4 * 64 * 10 * 2


def test_prefill_by_hand():
    P = 4 * 64 * 64 + 3 * 64 * 128
    f, af, b = flops.prefill_chunk(S, 4, 6)
    assert af == 4 * 64 * (4 * 6 + 10) * 2
    assert f == 2 * 4 * P * 2 + af
    assert b == 2 * (2 * 4 * 64 + 2 * 10 * 64) * 2


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(flops.BF16, 0) == pytest.approx(1.0)
    assert flops.least_s(0, flops.HBM) == pytest.approx(1.0)
    assert flops.least_s(flops.BF16, 2 * flops.HBM) == pytest.approx(2.0)
