from .checkpoint import CheckpointManager  # noqa: F401
from .straggler import StragglerMonitor  # noqa: F401
from .elastic import (ElasticPlan, ShardPlan, plan_remesh,  # noqa: F401
                      plan_shards)
