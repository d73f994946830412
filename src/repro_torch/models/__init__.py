"""Model configuration dataclasses (the only part of the model zoo the planner needs)."""
