"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes in another order, and lengths stay in their bounds."""

from dtxbench.harness import spec, traffic

CHAT = spec.traffic("chat-poisson")
DOCS = spec.traffic("sft-packed-1024")


def test_documents_deterministic_per_seed():
    a = traffic.packed_docs(DOCS, 2 ** 31 + 7, 151936)
    b = traffic.packed_docs(DOCS, 2 ** 31 + 7, 151936)
    c = traffic.packed_docs(DOCS, 2 ** 31 + 8, 151936)
    assert a == b
    assert a != c
    assert sorted(len(d["input_ids"]) for d in a) == sorted(
        len(d["input_ids"]) for d in c)


def test_documents_in_bounds_and_labelled():
    docs = traffic.packed_docs(DOCS, 3, 1000)
    lens = [len(d["input_ids"]) for d in docs]
    assert min(lens) >= 32 and max(lens) <= 1024
    assert len(docs) == DOCS["documents"]
    for d in docs[:50]:
        assert d["labels"][0] == traffic.IGNORE
        assert d["labels"][1:] == d["input_ids"][1:]
        assert min(d["input_ids"]) >= 3 and max(d["input_ids"]) < 1000


def test_open_loop_deterministic_per_seed():
    a = traffic.open_loop(CHAT, 11, 151936, 30.0)
    b = traffic.open_loop(CHAT, 11, 151936, 30.0)
    c = traffic.open_loop(CHAT, 12, 151936, 30.0)
    assert a == b and a != c
    ts = [r["t"] for r in a]
    assert ts == sorted(ts) and ts[-1] < CHAT["ramp_s"] + 30.0


def _window(reqs):
    return [r for r in reqs if r["t"] >= CHAT["ramp_s"]]


def test_every_window_holds_the_same_requests():
    a = _window(traffic.open_loop(CHAT, 1, 5000, 50.0))
    b = _window(traffic.open_loop(CHAT, 2, 5000, 50.0))
    assert len(a) == len(b) == round(CHAT["rate"] * 50.0)
    assert sorted(len(r["prompt"]) for r in a) == sorted(
        len(r["prompt"]) for r in b)
    assert sorted(r["max_new"] for r in a) == sorted(
        r["max_new"] for r in b)
    assert [r["t"] for r in a] != [r["t"] for r in b]
    greedy = sum(r["temperature"] == 0.0 for r in a)
    assert greedy == round(len(a) * CHAT["greedy_share"])


def test_open_loop_bounds():
    reqs = traffic.open_loop(CHAT, 5, 151936, 40.0)
    assert all(64 <= len(r["prompt"]) <= 2048 for r in reqs)
    assert all(16 <= r["max_new"] <= 1024 for r in reqs)
    assert len(reqs) == round(CHAT["rate"] * CHAT["ramp_s"]) + round(
        CHAT["rate"] * 40.0)


def test_a_tail_leaves_the_window_as_it_was():
    """A traced run's traffic after the window is drawn apart: the ramp
    and the window hold the same requests with or without it."""
    plain = traffic.open_loop(CHAT, 9, 5000, 20.0)
    tailed = traffic.open_loop(CHAT, 9, 5000, 20.0, tail_s=8.0)
    assert tailed[:len(plain)] == plain
    after = tailed[len(plain):]
    assert len(after) == round(CHAT["rate"] * 8.0)
    assert all(CHAT["ramp_s"] + 20.0 <= r["t"] < CHAT["ramp_s"] + 28.0
               for r in after)
