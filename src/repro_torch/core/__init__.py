"""Graph store, planner, perf model, schedule and executor."""
