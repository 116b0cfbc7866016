"""Plain tensor operations of the port: normalization, resizing, the
segmentation losses and the metrics."""
