"""Training substrate of the port: the optimizers and the one-device train,
prefill and decode steps."""
