"""Training of the LM template (port of ``repro/train``): the optimizers,
the train step and the training loop, dense families."""
