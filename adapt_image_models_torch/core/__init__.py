"""Training machinery of the port: optimizer, LR schedules, the train step
and checkpoints."""
