"""The multi-sequence layer of the port: batched odometry state."""
