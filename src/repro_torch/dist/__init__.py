from .api import (active_mesh, align_shard, batch_mesh_axes,  # noqa: F401
                  constrain, current_mesh, get_option, options, read_shard)
from .run import (JobAbandoned, JobPlan, load_plan, plan_job,  # noqa: F401
                  run_job)
