"""Training: the model state in checkpoints, the loop and its loggers
(counterpart of ``genre_shapehd_tpu/train``)."""
