"""Per-frame operators of the port, each kernel beside its plain version."""
