"""Engine telemetry of the PyTorch port (flight recorder, metric names)."""
