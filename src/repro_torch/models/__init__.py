"""Model-level helpers of the port (only the unsharded row gather so far)."""
