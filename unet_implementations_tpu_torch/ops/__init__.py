"""Plain tensor operations of the port: normalization and resizing."""
