"""Host/device staging for the port's batched device paths."""
