"""The port's native C++ packer (``datatunerx_tpu_torch/native``) against
the reference's (``datatunerx_tpu/native``) and the Python loops of both
packages, for fill and pack, on the reference test's example generator."""

import os

import numpy as np
import pytest

from datatunerx_tpu import native as ref_native
from datatunerx_tpu.data import preprocess as ref_pre
from datatunerx_tpu_torch import native
from datatunerx_tpu_torch.data import preprocess as port_pre
from tests.test_native import _examples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_builds_under_build_dir():
    assert native.available(), "g++ build of the port's native packer failed"
    assert ref_native.available()
    lib = native._library_path()
    assert lib.exists()
    assert lib.parent == native.BUILD_DIR
    assert str(lib).startswith(os.path.join(ROOT, "build", "torch_native"))


@pytest.mark.parametrize("op, block, pad_id, seed, n, max_len", [
    ("pad_to_block", 48, 7, 0, 50, 40),
    ("pack_to_block", 64, 0, 1, 50, 40),
    ("pad_to_block", 128, 0, 2, 2000, 120),
    ("pack_to_block", 128, 3, 2, 500, 120),
])
def test_port_native_equals_reference_native_and_python(op, block, pad_id,
                                                        seed, n, max_len):
    exs = _examples(np.random.default_rng(seed), n=n, max_len=max_len)
    port_fn, ref_fn = getattr(port_pre, op), getattr(ref_pre, op)
    outs = {
        "port_native": port_fn(exs, block, pad_id=pad_id, use_native=True),
        "port_python": port_fn(exs, block, pad_id=pad_id, use_native=False),
        "ref_native": ref_fn(exs, block, pad_id=pad_id, use_native=True),
        "ref_python": ref_fn(exs, block, pad_id=pad_id, use_native=False),
    }
    want = outs["ref_python"]
    for name, got in outs.items():
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name}:{k}")
            assert got[k].dtype == np.int32, (name, k)


def test_mismatched_lengths_take_the_python_loop():
    exs = [{"input_ids": [1, 2, 3], "labels": [1, 2]}]
    assert native.fill_batch_native(exs, 8, 0, -100) is None
    assert native.pack_batch_native(exs, 8, 0, -100) is None
