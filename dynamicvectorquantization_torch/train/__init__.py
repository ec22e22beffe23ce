"""Training: LR schedules, the two stage trainers, the epoch loop and its command line."""
