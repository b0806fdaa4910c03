"""The reference's judgement of served tokens: one full forward over each
prompt with its served tokens.

Greedy tokens: the widest gap by which a served token's logit lies below
the reference's best at its position. A greedy token the program computed
right is the reference's first, or a near tie of it, so its gap is
rounding; a wrong token lies below by the logits' spread. The control
reads, at the same positions, the gap of the token that the lower
precision puts first.

Sampled tokens: each is an inverse-CDF draw over ``softmax(logits / t)``
in vocabulary order, with a uniform ``u`` from the request's seed
(``threefry.sampling_uniforms``). The reference works out its own CDF and
``u`` and reads how far ``u`` lies outside the served token's interval
``[F(x-1), F(x))``, in probability mass: 0 where the reference would draw
that token, rounding where the program's CDF differs by a little, and a
large share of the mass where the draw went wrong (another temperature,
another uniform, another distribution). The control draws with the same
``u`` from the lower precision's logits and is read the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from dtxbench.reference import model, threefry


def served_gaps(W, requests, prec: str = "f32", chooser: str = "served"):
    """``requests``: [(prompt ids, served ids)]. With ``chooser`` "served"
    the gap of each served token; with "own" the gap of the token this
    precision's forward ranks first, read in float32 logits computed
    alongside (the control). Returns the gaps, one list a request."""
    seqs = [list(p) + list(s[:-1]) for p, s in requests]
    wanted = [list(range(len(p) - 1, len(p) - 1 + len(s)))
              for p, s in requests]
    ref = model.sequence_logits(W, seqs, wanted, "f32")
    if chooser == "own":
        low = model.sequence_logits(W, seqs, wanted, prec)
        picks = [lg.argmax(dim=-1) for lg in low]
    else:
        picks = [torch.tensor(s, device=W.embed.device) for _, s in requests]
    out = []
    for lg, pk in zip(ref, picks):
        best = lg.max(dim=-1).values
        got = torch.gather(lg, -1, pk.long()[:, None])[:, 0]
        out.append((best - got).tolist())
    return out


def _cdf(lg, temperature: float):
    """The float64 CDF over the vocabulary of ``softmax(lg / t)``, row by
    row: ``[n, V]``."""
    return torch.softmax(lg.double() / temperature, dim=-1).cumsum(dim=-1)


def draw_gaps(W, requests, prec: str = "f32", chooser: str = "served"):
    """``requests``: [(prompt ids, served ids, seed, temperature)] of
    sampled streams. With ``chooser`` "served" the distance of each served
    token's reference interval from its uniform; with "own" that of the
    token this precision's forward draws with the same uniform (the
    control). Returns the distances, one list a request."""
    seqs = [list(p) + list(s[:-1]) for p, s, _, _ in requests]
    wanted = [list(range(len(p) - 1, len(p) - 1 + len(s)))
              for p, s, _, _ in requests]
    ref = model.sequence_logits(W, seqs, wanted, "f32")
    low = (model.sequence_logits(W, seqs, wanted, prec)
           if chooser == "own" else None)
    out = []
    for k, (_, served, seed, temp) in enumerate(requests):
        dev = ref[k].device
        u = torch.from_numpy(threefry.sampling_uniforms(seed, len(served)))
        u = u.double().to(dev)
        F = _cdf(ref[k], temp)
        if low is None:
            x = torch.tensor(served, device=dev).long()
        else:
            own = _cdf(low[k], temp)
            x = torch.searchsorted(own, u[:, None], right=True)[:, 0]
            x = x.clamp(max=F.shape[-1] - 1)
        hi = torch.gather(F, -1, x[:, None])[:, 0]
        lo = torch.where(x > 0, torch.gather(F, -1, (x - 1).clamp(min=0)
                                             [:, None])[:, 0],
                         torch.zeros_like(hi))
        gap = torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)
        out.append(gap.tolist())
    return out


def draw_sample(done, seed: int, budget: int) -> list:
    """The requests a run's check takes, drawn from the seed: the longest
    of ``done`` first, then the others in a seeded order, until their
    tokens reach ``budget``. ``done``: [(request dict, served ids)]."""
    if not done:
        return []
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    longest = max(range(len(done)), key=lambda i: len(done[i][1]))
    order = [longest] + [int(i) for i in rng.permutation(len(done))
                         if i != longest]
    pick = []
    for i in order:
        if budget <= 0:
            break
        pick.append(done[i])
        budget -= len(done[i][1])
    return pick
