"""The odometry engine of the port: sliding window and per-frame step."""
