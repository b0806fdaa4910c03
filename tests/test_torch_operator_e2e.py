"""The port's own control plane end to end on the CPU, with nothing of
the JAX package: ``chip_smoke.py``'s phase 16 at ``preset:debug`` with
``--device cpu``. The port's controller-manager (``python -m
datatunerx_tpu_torch.operator.manager --backend local``, one slice of one
card in ``TPU_SLICE_POOL``, the device health probe on) takes a
FinetuneExperiment of two 2-step FinetuneJobs, registered through
``dtx-torch apply`` over REST, through port trainer and server
subprocesses to Success: the second job waits for the slice while the
first holds it, both get an LLMCheckpoint and a numeric score, the
``bestVersion`` is the job the reference's ``parse_score`` ranks first,
``/metrics`` reads ``dtx_device_healthy 1``, the first job's server
answers the probes with ``"model": "default"`` (its adapter: NLLs off the
base's), and deleting the experiment leaves no trainer or server
process."""

import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_operator", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_controller_manager_runs_an_experiment_on_port_processes(tmp_path):
    smoke = _chip_smoke()
    before = set(sys.modules)
    out = smoke.operator_phase(torch, str(tmp_path), model="preset:debug",
                               device="cpu", timeout=600)
    assert set(out["times"]) == {"opj-a", "opj-b"}
    for rec in out["times"].values():
        assert rec["trained_s"] <= rec["healthy_s"] <= rec["scored_s"]
    assert out["wall_s"] > 0
    # the phase (the manager runs in its own process) loaded nothing of
    # the JAX package here
    assert not any(m == "datatunerx_tpu" or m.startswith("datatunerx_tpu.")
                   for m in set(sys.modules) - before)
