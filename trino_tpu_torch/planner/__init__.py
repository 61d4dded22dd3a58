from .logical import LogicalPlanner, PlanningError  # noqa: F401
