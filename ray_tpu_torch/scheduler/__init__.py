"""The batch placement scheduler (counterpart: ``ray_tpu/scheduler``).

The reference schedules tasks one at a time in a C++ loop
(reference: ``src/ray/raylet/scheduling_policy.cc:31-134``). Here the whole
pending set is batched into dense tensors and placed by torch passes on the
card (kernel.py); reference.py is the scalar spec implementation that the
passes must match bit-for-bit; dag.py generates benchmark DAGs.
"""

from .kernel import (  # noqa: F401
    BatchScheduler,
    schedule_dag,
    schedule_dag_collapsed,
)
from .reference import schedule_dag_reference  # noqa: F401
from .dag import collapse_chains, random_dag, uniform_cluster  # noqa: F401
from .critical_path import (  # noqa: F401
    longest_path_ref,
    longest_path_vec,
    profile_rows,
)
