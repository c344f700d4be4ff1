"""Pipeline, CLI, checkpointing and metrics (host orchestration)."""
