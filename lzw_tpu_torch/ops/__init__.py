"""Host-side helpers of the port (no kernels)."""
