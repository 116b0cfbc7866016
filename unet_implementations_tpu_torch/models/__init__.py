"""The segmentation UNet and its weight converters."""
