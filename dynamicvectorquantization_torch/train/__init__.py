"""Training: LR schedules and the stage-2 trainer."""
