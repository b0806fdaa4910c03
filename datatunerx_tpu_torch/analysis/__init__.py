"""dtxlint for the PyTorch/CUDA port: static analysis of
``datatunerx_tpu_torch``.

The port's copy of ``datatunerx_tpu/analysis``: the same framework, rule
ids, message shapes, baseline and JSON contract, with the rules whose
construct is JAX's retargeted to the PyTorch one (host syncs such as
``.item()``/``.cpu()``/``torch.cuda.synchronize()`` in hot paths,
``torch.compile``/``torch.jit``/CUDA-graph captures built in a loop,
tensor control flow in compiled functions, PRNG key reuse through
``ops/prng``, mesh axis drift against ``parallel/mesh.py``, CUDA work at
import, reads of a CUDA graph's static output after a later replay), plus
the shared ones: lock discipline around the server, gateway, fleet and
operator threads, subprocess and thread leaks, blocking under a lock,
lock order and thread shutdown.

Entry points:

  python -m datatunerx_tpu_torch.analysis [paths...]
  dtx-torch lint [paths...]
  dtxlint-torch [paths...]

Rules are self-contained visitor classes registered in
``datatunerx_tpu_torch.analysis.rules``; per-rule docs live on each class.
Suppress a finding inline with ``# dtxlint: disable=DTX00N`` (comma
list, or ``all``), and carry pre-existing debt in a baseline file
(``--write-baseline``) so CI only blocks NEW findings. The configuration
is ``dtxlint-torch.toml`` at the repository root (``config.py``).
"""

from datatunerx_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    ModuleContext,
    Rule,
    lint_paths,
    lint_source,
)
