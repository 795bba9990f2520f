"""Test-infrastructure components shipped with the framework (the port
of ``mmlspark_tpu/testing``): the CSV-gated ``Benchmarks``, the fault
injectors, the load drivers (``load``, ``decode_load``) and the frame
generators (``datagen``). The package exports JAX's list.

Parity: the reference packages its test harness as library code under
`core/test/` (TestBase, Benchmarks, datagen) so downstream modules and
users regression-gate their own models the same way.
"""

from mmlspark_tpu_torch.testing.benchmarks import Benchmarks
from mmlspark_tpu_torch.testing.faults import (
    Fault,
    FaultPlan,
    FaultyCheckpointManager,
    FaultyModel,
    FaultySession,
    InjectedFault,
)

__all__ = ["Benchmarks", "Fault", "FaultPlan", "FaultyCheckpointManager",
           "FaultyModel", "FaultySession", "InjectedFault"]
