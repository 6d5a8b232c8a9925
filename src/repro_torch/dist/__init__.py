from .api import align_shard, read_shard  # noqa: F401
from .run import (JobAbandoned, JobPlan, load_plan, plan_job,  # noqa: F401
                  run_job)
