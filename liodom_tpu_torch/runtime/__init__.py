"""The host runtime of the port: the native loader, results files,
publisher, channels, PLY export, tracing, checkpoints and the traffic
between the host and the card that the apps drive."""
