"""Training: Adam + StepLR (`optim.py`) and the train step, epoch loop,
checkpoints and resume (`trainer.py`)."""
