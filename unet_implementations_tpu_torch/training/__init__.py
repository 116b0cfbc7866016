"""Training: optimizers and schedules, and the segmentation train and eval steps."""
