"""Training data of the port: synthetic token and image batches made on
the device."""
