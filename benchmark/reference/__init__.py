"""The plain reference: the model, the smoother and the EM fit, in plain
PyTorch, with nothing of the measured program."""
