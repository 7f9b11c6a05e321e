"""Attention ops: the dense/flash dispatch and the flash forward kernel."""
