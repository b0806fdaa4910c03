"""The plain reference against the port's CPU path: the same forward
logits from the same weights, the frozen threefry copy's bits, and the
reference's nf4 against the port's quantizer."""

import numpy as np
import pytest
import torch

from dtxbench.harness import weights
from dtxbench.reference import model, nf4, threefry
from dtxbench.tests.small import CONFIG


def test_forward_logits_match_the_port():
    from datatunerx_tpu_torch.models.llama import forward
    from datatunerx_tpu_torch.utils.hf_convert import config_from_hf

    cfg = config_from_hf(CONFIG)
    params = weights.model_params(CONFIG, "small", 9, "cpu",
                                  dtype=torch.float32)
    toks = torch.randint(3, 512, (1, 40), generator=torch.Generator()
                         .manual_seed(0))
    port, _ = forward(params, toks, cfg)
    W = model.Weights(CONFIG, "small", 9, "cpu")
    W.layers = [weights.layer(CONFIG, "small", 9, i, "cpu", torch.float32)
                for i in range(2)]
    W.embed = weights.embedding(CONFIG, "small", 9, "cpu", torch.float32)
    W.head = weights.head(CONFIG, "small", 9, "cpu", torch.float32)
    ref = model.sequence_logits(W, [toks[0].tolist()], [list(range(40))])
    np.testing.assert_allclose(ref[0].numpy(), port[0].detach().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
def test_frozen_threefry_matches_the_twin(seed):
    from datatunerx_tpu_torch.ops import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 0x57E9), 2)
    mine = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(seed),
                                             0x57E9), 2)
    assert np.array_equal(key, mine)
    a = prng.bernoulli(prng.to_device(key, "cpu"), 0.9, (3, 17, 64))
    b = threefry.bernoulli(mine, 0.9, (3, 17, 64), "cpu")
    assert torch.equal(a, b)
    u = prng.uniform(prng.to_device(key, "cpu"), (5, 33), -0.5, 0.5)
    v = threefry.uniform(mine, (5, 33), -0.5, 0.5, "cpu")
    assert torch.equal(u, v)


def test_nf4_matches_the_port():
    from datatunerx_tpu_torch.ops.quant import dequant_nf4, quantize_nf4

    w = torch.randn(128, 96, generator=torch.Generator().manual_seed(1))
    port = dequant_nf4(quantize_nf4(w), (128, 96))
    mine = nf4.dequant(*nf4.quantize(w))
    torch.testing.assert_close(mine, port, rtol=0, atol=1e-6)


def test_fp8_control_rounds():
    x = torch.linspace(-1, 1, 1000)
    y = model._fp8(x)
    assert 0 < float((x - y).abs().max()) < 0.07


@pytest.mark.parametrize("seed", [0, 1437752895, 2 ** 31 - 2])
def test_sampling_uniforms_match_the_engines_key_chain(seed):
    """The uniforms the reference draws a sampled stream's tokens with are
    the serving engine's: PRNGKey(seed), split once a token."""
    from datatunerx_tpu_torch.ops import cuda_sampling, prng

    keys = prng.PRNGKey(seed)[None]
    want = []
    for _ in range(12):
        keys, us = cuda_sampling.row_uniforms(keys)
        want.append(float(us[0]))
    assert threefry.sampling_uniforms(seed, 12).tolist() == want


def test_draw_gap_is_nought_for_the_ports_own_draws():
    """A draw the port's sampler makes from the reference's own logits
    lies in its reference interval; the next token's does not."""
    from datatunerx_tpu_torch.ops import cuda_sampling
    from dtxbench.reference import serve

    W = model.Weights(CONFIG, "small", 4, "cpu")
    prompt = list(range(3, 40))
    temp, seed = 0.8, 1234
    served = []
    us = threefry.sampling_uniforms(seed, 6)
    for j in range(6):
        lg = model.sequence_logits(W, [prompt + served],
                                   [[len(prompt) + j - 1]])[0]
        x, _ = cuda_sampling._prep(lg, torch.tensor([temp]), mode="simple")
        tok = cuda_sampling.kernel_sample(
            x, torch.tensor([temp]), torch.tensor(us[j:j + 1]),
            greedy=False)
        served.append(int(tok[0]))
    gaps = serve.draw_gaps(W, [(prompt, served, seed, temp)])[0]
    assert max(gaps) < 1e-6, gaps
    moved = served[:5] + [(served[5] + 7) % CONFIG["vocab_size"]]
    assert serve.draw_gaps(W, [(prompt, moved, seed, temp)])[0][5] > 1e-4
