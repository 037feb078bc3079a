"""Training substrate of the port: the optimizers (the train step comes
with the model slice)."""
