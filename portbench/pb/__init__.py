"""The harness of the port's benchmark: manifest lookup, inputs from the
seed, the timed windows, the reduction of traces and host spans to metrics,
and the comparison that decides ``correct``. It imports the program under
test (``unet_implementations_tpu_torch``) only inside the drivers."""
