"""dtxlint rule registry. Each rule is a self-contained visitor class;
adding one = write the class, import it here, add a fixture pair to
tests/test_dtxlint.py (see README "Static analysis")."""

from typing import List, Sequence

from datatunerx_tpu_torch.analysis.core import Rule
from datatunerx_tpu_torch.analysis.rules.blocking import BlockingUnderLock
from datatunerx_tpu_torch.analysis.rules.concurrency import LockDiscipline, ResourceLeak
from datatunerx_tpu_torch.analysis.rules.donation import DonatedBufferReuse
from datatunerx_tpu_torch.analysis.rules.host_sync import HostSyncInHotPath
from datatunerx_tpu_torch.analysis.rules.lockorder import LockOrderInversion
from datatunerx_tpu_torch.analysis.rules.prng import PRNGKeyReuse
from datatunerx_tpu_torch.analysis.rules.retrace import JitInLoop, ModuleImportDeviceWork
from datatunerx_tpu_torch.analysis.rules.sharding import MeshAxisDrift
from datatunerx_tpu_torch.analysis.rules.thread_shutdown import ThreadShutdownEvidence
from datatunerx_tpu_torch.analysis.rules.tracer import TracerControlFlow

RULE_CLASSES = (
    HostSyncInHotPath,    # DTX001
    JitInLoop,            # DTX002
    TracerControlFlow,    # DTX003
    PRNGKeyReuse,         # DTX004
    MeshAxisDrift,        # DTX005
    LockDiscipline,       # DTX006
    ResourceLeak,         # DTX007
    ModuleImportDeviceWork,  # DTX008
    BlockingUnderLock,    # DTX009
    DonatedBufferReuse,   # DTX010
    LockOrderInversion,   # DTX011
    ThreadShutdownEvidence,  # DTX012
)


def all_rules() -> List[Rule]:
    return [cls() for cls in RULE_CLASSES]


def rules_by_id(ids: Sequence[str]) -> List[Rule]:
    wanted = set(ids)
    return [cls() for cls in RULE_CLASSES if cls.id in wanted]
