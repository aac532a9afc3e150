"""Training substrate of the port: optimizers, the train-step factory with
the mask discipline, gradient compression, checkpoints, and the CNN
training harness."""
