"""Training: the optimizer, the train step, data, checkpoints and fault
handling (counterpart of ``repro/train``)."""
