"""The port's ring attention (``ops/ring_attention.py``) run as sp gloo
processes on the CPU, against the reference's ``ring_flash_attention`` and
``ring_attention`` under ``ring_attention_sharded`` on the virtual CPU
mesh (its flash engine at sp 2, its einsum engine at sp 4; both of the
port's rings against each), at the tolerances of
``tests/test_ring_attention.py``: forward 2e-5, gradients 5e-4 (f32). The
in-process schedule (``ring_schedule``: every rank's steps, the rotation
by indexing), which ``chip_smoke.py`` drives on the card, is held against
the gloo ring, and its launch count against n²."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from datatunerx_tpu.ops.ring_attention import ring_attention_sharded
from datatunerx_tpu.parallel.mesh import make_mesh as jmake_mesh
from datatunerx_tpu_torch.ops import ring_attention as ra
from test_torch_gloo import World
from test_torch_parallel_workers import ring_worker


def _inputs(sp, seed):
    B, T, H, KV, d = 2, 32 * sp, 4, 2, 16
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=s).astype(np.float32) for n, s in (
        ("q", (B, T, H, d)), ("k", (B, T, KV, d)), ("v", (B, T, KV, d)),
        ("do", (B, T, H, d)))}


def _reference(x, sp, impl, monkeypatch):
    monkeypatch.setenv("DTX_RING_IMPL", impl)
    mesh = jmake_mesh((1, 1, 1, sp), devices=jax.devices()[:sp])
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    out, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(q, k, v, mesh),
                       q, k, v)
    dq, dk, dv = vjp(jnp.asarray(x["do"]))
    return {n: np.asarray(a) for n, a in
            zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}


# the reference's engine each ring size is held against (the reference's
# own tests hold its two engines to each other)
REF_IMPL = {2: "flash", 4: "xla"}


@pytest.mark.parametrize("sp", [2, 4])
def test_gloo_ring_matches_the_reference_ring(sp, devices8, monkeypatch):
    x = _inputs(sp, seed=sp)
    world = World(ring_worker, sp, x, timeout=150)
    want = _reference(x, sp, REF_IMPL[sp], monkeypatch)
    ranks = world.result()
    for impl in ("flash", "xla"):
        for name in ("out", "dq", "dk", "dv"):
            got = np.concatenate([r[impl][name] for r in ranks], axis=1)
            tol = 2e-5 if name == "out" else 5e-4
            np.testing.assert_allclose(got, want[name], atol=tol, rtol=tol,
                                       err_msg=f"{impl} {name} sp={sp}")
    # the in-process schedule takes the gloo ring's steps: same numbers
    t = x["q"].shape[1] // sp
    chunks = {n: [torch.from_numpy(x[n][:, r * t:(r + 1) * t].copy())
                  for r in range(sp)] for n in ("q", "k", "v", "do")}
    outs, _, dqs, dks, dvs = ra.ring_schedule(chunks["q"], chunks["k"],
                                              chunks["v"], chunks["do"])
    for r in range(sp):
        for name, got in (("out", outs[r]), ("dq", dqs[r]), ("dk", dks[r]),
                          ("dv", dvs[r])):
            np.testing.assert_allclose(got.numpy(), ranks[r]["flash"][name],
                                       atol=1e-6, rtol=1e-6)


def test_schedule_launches_n_squared_of_each_kernel(monkeypatch):
    """n² K1, K2 and K3 calls: the masked future chunks run, as in the
    reference (counted through the step functions' flash calls)."""
    from datatunerx_tpu_torch.ops import flash_attention as fa

    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for name, key in (("_plain_fwd", "fwd"), ("_plain_bwd_dq", "dq"),
                      ("_plain_bwd_dkv", "dkv")):
        real = getattr(fa, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counted)
    x = _inputs(4, seed=9)
    t = x["q"].shape[1] // 4
    ch = {n: [torch.from_numpy(x[n][:, r * t:(r + 1) * t].copy())
              for r in range(4)] for n in ("q", "k", "v", "do")}
    ra.ring_schedule(ch["q"], ch["k"], ch["v"], ch["do"])
    assert calls == {"fwd": 16, "dq": 16, "dkv": 16}


def test_ring_at_sp1_is_the_biased_attention():
    """``attention(impl="ring")`` without an sp axis above 1 is the plain
    biased attention (ref ``ops/attention.py:319-330``)."""
    from datatunerx_tpu_torch.ops.attention import (
        attention,
        make_causal_bias,
        xla_attention,
    )

    x = _inputs(1, seed=3)
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    pos = torch.arange(q.shape[1])[None].expand(q.shape[0], -1)
    bias = make_causal_bias(pos, pos)
    assert torch.equal(attention(q, k, v, bias, impl="ring"),
                       xla_attention(q, k, v, bias))
