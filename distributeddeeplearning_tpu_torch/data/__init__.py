"""Training data of the port: synthetic token batches made on the device."""
