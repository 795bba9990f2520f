"""Import every stage module so the full registry is populated (the
port's counterpart of ``mmlspark_tpu/all.py``).

The modules are :data:`mmlspark_tpu_torch.core.registry.STAGE_MODULES`,
the one list that ``all_stages()`` imports too; a new stage module goes
there. Used by persistence resolution and the fuzzing sweep.
"""

import importlib

from mmlspark_tpu_torch.core.registry import STAGE_MODULES

for _module in STAGE_MODULES:
    importlib.import_module(_module)
