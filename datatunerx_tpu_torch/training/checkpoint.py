"""Checkpointing: periodic saves, resume, the completion manifest and the
merged export (the port of ``datatunerx_tpu/training/checkpoint.py``).

- ``CheckpointManager`` saves the train state with ``torch.save`` under
  ``<directory>/<step>/state.pt`` (written to a temporary directory and
  renamed, so a reader never sees half a checkpoint), keeps the newest
  ``max_to_keep``, and restores the newest (or a given) step. It holds what
  a resume needs: the step, the trainable tree (the adapters for LoRA — the
  frozen base is reloaded from the model source — else the params), the
  optimizer state and the run's threefry key (dropout and NEFTune draw
  from it). Orbax checkpoints of the JAX package are not read; the
  packages cross-load through the export below. The directory may be a
  URI (``utils/storage``). ``checkpoint_steps``/``checkpoint_probe`` list
  a run's steps for the reference experiment loop.
- ``write_manifest``/``read_manifest``: ``<storage_path>/<run>/manifest.json``
  plus the legacy ``checkpoint_path`` file, the reference's keys and paths.
- ``export_merged_model``: the LoRA-merged weights as an HF-layout
  ``model.npz`` plus ``config.json``, which both packages load.
"""

from __future__ import annotations

import dataclasses
import json
import os
import posixpath
import shutil
import time
import warnings
from typing import Optional

import numpy as np
import torch

from datatunerx_tpu_torch.ops import prng
from datatunerx_tpu_torch.utils import storage

MANIFEST_NAME = "manifest.json"
LEGACY_PATH_FILE = "checkpoint_path"  # the reference's path-file contract
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_interval_steps: int = 0,
                 max_to_keep: int = 3):
        storage.makedirs(directory)
        # an object-store directory (gs://…) is kept as given
        self.directory = (directory if storage.is_uri(directory)
                          else os.path.abspath(directory))
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep

    def due(self, step: int, force: bool = False) -> bool:
        """Whether ``maybe_save`` would save at ``step``."""
        return force or (self.save_interval_steps > 0 and step > 0
                         and step % self.save_interval_steps == 0)

    def maybe_save(self, state, step: int, force: bool = False) -> bool:
        if not self.due(step, force):
            return False
        payload = {"step": state.step,
                   "rng": torch.from_numpy(state.rng.astype(np.int64)),
                   "opt_state": state.opt_state}
        if state.lora is not None:
            payload["lora"] = state.lora
        else:
            payload["params"] = state.params
        save_raw_state(self.directory, step, payload)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                storage.remove_tree(storage.join(self.directory, str(old)))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        """Every saved step, ascending."""
        return saved_steps(self.directory)

    def restore(self, state_template, step: Optional[int] = None):
        """(state, step) with the saved tensors on the template's device;
        the frozen base params of a LoRA run come from the template."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        leaf = (state_template.lora if state_template.lora is not None
                else state_template.params)
        device = next(iter(_leaves(leaf))).device
        saved = load_raw_state(self.directory, step, map_location=device)
        if "rng" in saved:
            rng = saved["rng"].cpu().numpy().astype(np.uint32)
        else:
            # written before training drew from the threefry twin: only the
            # run seed was kept, and the key a fresh run builds from it
            # carries on with other dropout masks than the saved run drew
            warnings.warn(
                f"checkpoint step {step} under {self.directory} holds a run "
                "seed, not a threefry key: resuming from PRNGKey(seed), so "
                "the dropout and NEFTune draws differ from those the run "
                "would have made", stacklevel=2)
            rng = prng.PRNGKey(int(saved["seed"]))
        return dataclasses.replace(
            state_template, step=saved["step"], rng=rng,
            opt_state=saved["opt_state"],
            lora=saved.get("lora", state_template.lora),
            params=saved.get("params", state_template.params)), step


def saved_steps(directory: str) -> list:
    """Every step saved under ``directory`` (a local path or a URI),
    ascending ([] when it holds none or does not exist)."""
    if not directory:
        return []
    steps = (posixpath.basename(posixpath.dirname(p)) for p in
             storage.glob(storage.join(directory, "*", STATE_FILE)))
    return sorted(int(n) for n in steps if n.isdigit())


def checkpoint_steps(job) -> list:
    """The saved steps of an experiment job's ``spec["checkpoint_dir"]``
    (ascending; [] with no directory configured or nothing saved): the
    port's listing for the reference experiment loop's
    ``ContinuousScoringWatcher(checkpoints_fn=...)``. ``job`` is
    duck-typed: anything with a ``spec`` dict."""
    return saved_steps(job.spec.get("checkpoint_dir"))


def checkpoint_probe(job) -> Optional[int]:
    """The newest saved step a resumed job fast-forwards to (None: nothing
    saved, it restarts from step 0): the port's probe for the reference
    ``SliceScheduler(checkpoint_probe=...)``."""
    steps = checkpoint_steps(job)
    return steps[-1] if steps else None


def save_raw_state(directory: str, step: int, payload: dict) -> str:
    """Write ``payload`` as ``<directory>/<step>/state.pt``. A local
    directory is written into a temporary directory first, then renamed; a
    URI directory's ``state.pt`` is written under a temporary name beside
    it, then moved into place. Either way a reader (``saved_steps``) never
    lists half a checkpoint. Returns the step directory."""
    if storage.is_uri(directory):
        final = storage.join(directory, str(step))
        storage.makedirs(final)
        tmp = storage.join(final, f"{STATE_FILE}.tmp-{os.getpid()}")
        with storage.open_uri(tmp, "wb") as f:
            torch.save(payload, f)
        storage.move(tmp, storage.join(final, STATE_FILE))
        return final
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_raw_state(directory: str, step: int, map_location="cpu") -> dict:
    """The saved dict of ``<directory>/<step>/state.pt`` (tensors only:
    ``weights_only``)."""
    with storage.open_uri(storage.join(directory, str(step), STATE_FILE),
                          "rb") as f:
        return torch.load(f, map_location=map_location, weights_only=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def write_manifest(storage_path: str, run_name: str, checkpoint_uri: str,
                   metrics: Optional[dict] = None,
                   extra: Optional[dict] = None) -> str:
    """The completion manifest at ``<storage_path>/<run_name>/manifest.json``
    and the legacy path file."""
    run_dir = storage.join(storage_path, run_name)
    storage.makedirs(run_dir)
    manifest = {
        "run": run_name,
        "checkpoint": checkpoint_uri,
        "finished_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "metrics": metrics or {},
    }
    if extra:
        manifest.update(extra)
    path = storage.join(run_dir, MANIFEST_NAME)
    storage.write_text(path, json.dumps(manifest, indent=1, sort_keys=True))
    storage.write_text(storage.join(run_dir, LEGACY_PATH_FILE), checkpoint_uri)
    return path


def read_manifest(storage_path: str, run_name: str) -> Optional[dict]:
    path = storage.join(storage_path, run_name, MANIFEST_NAME)
    if not storage.exists(path):
        return None
    return json.loads(storage.read_text(path))


def export_merged_model(params, cfg, export_dir: str, lora=None,
                        scaling: float = 1.0) -> str:
    """Export (optionally LoRA-merged) weights as an HF-layout ``model.npz``
    (float32) plus ``config.json``."""
    from datatunerx_tpu_torch.models.lora import merge_lora
    from datatunerx_tpu_torch.utils.hf_convert import export_hf_state_dict

    if lora is not None:
        params = merge_lora(params, lora, scaling)
    os.makedirs(export_dir, exist_ok=True)
    sd = export_hf_state_dict(params, cfg)
    if lora is not None and "v_head" in lora:
        # a reward model's value head has no slot in the HF layout: it is
        # exported under its own key, as the reference does
        sd["v_head.weight"] = lora["v_head"].detach().float().cpu().numpy()
    out = os.path.join(export_dir, "model.npz")
    np.savez(out, **sd)
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, default=str)
    return out
