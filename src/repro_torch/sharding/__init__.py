from repro_torch.sharding.planner import ShardingPlan, Spec, make_plan  # noqa: F401
from repro_torch.sharding.specs import SHAPES, ShapeCell, input_specs, cell_runnable  # noqa: F401
