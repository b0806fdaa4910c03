"""dtxsan for the port — the runtime sanitizer plane.

dtxlint (``analysis/``) proves concurrency discipline STATICALLY; this
package proves the dynamic half under the real test and chaos-replay
harnesses. Three sanitizers; the lock-order and thread-leak ones are
stdlib-only, the compile one imports torch and the port's build helpers
when it is installed:

  * **SAN001 lock-order** (`lockorder.py`) — wraps ``threading.Lock`` /
    ``RLock`` construction so every unbounded blocking acquisition
    records held→acquired edges in a global lock-order graph keyed by
    the locks' allocation sites; cycles are potential ABBA deadlocks and
    are reported with BOTH acquisition stacks. ``# dtxsan: order(N)`` on
    an allocation line declares a rank (consistent low→high edges are
    justified; a high→low acquisition is an immediate violation).
  * **SAN002 thread-leak** (`threads.py`) — per-test teardown audit of
    threads that outlive the test, each named by the spawn site recorded
    when ``Thread.start`` ran.
  * **SAN003 compile-budget** (`compile.py`) — counts what the port
    builds at run time (the CUDA kernel library, the native packer, any
    ``torch.compile`` frame) and enforces declared budgets:
    ``with compile_budget(0):`` turns "a warmed server builds nothing
    more" into a hard error naming the build sites; module-level budgets
    bound a whole run.

Activation: ``DTX_SAN=1`` (all) or a comma list of ``lock,thread,
compile`` for ``dtx-torch replay`` (the chaos harness), and
``DTX_TORCH_SAN`` for the pytest plugin (`plugin.py`, loaded with ``-p
datatunerx_tpu_torch.analysis.sanitizers.plugin``): the tests' conftest
loads the REFERENCE's plugin whenever DTX_SAN is set, and two planes must
not both wrap ``threading.Lock``. ``dtx-torch san`` (`cli.py`) wraps a
pytest run and applies the dtxlint exit-code /
``--format json`` contract; findings reuse ``analysis.baseline`` (the
policy baseline stays EMPTY) and honor inline
``# dtxsan: disable=SANxxx`` suppressions.
"""

from datatunerx_tpu_torch.analysis.sanitizers.compile import (  # noqa: F401
    CompileBudgetExceeded,
    compile_budget,
    register_module_budget,
)
from datatunerx_tpu_torch.analysis.sanitizers.runtime import (  # noqa: F401
    active_classes,
    install_from_env,
    uninstall,
)

__all__ = [
    "CompileBudgetExceeded",
    "compile_budget",
    "register_module_budget",
    "active_classes",
    "install_from_env",
    "uninstall",
]
