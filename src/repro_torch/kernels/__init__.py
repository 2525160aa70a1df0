"""Hand-written GPU kernels of the port and their dispatch (``ops``)."""
