"""Training of the port: the optimizer and schedules (`optim`), the step
runner (`step`) and the train state in the checkpoint (`state`)."""
