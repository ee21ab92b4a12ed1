"""Runtime: the train and serve steps, checkpoints, and the training workflow."""
