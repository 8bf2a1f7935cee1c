"""Training on one device: schedule, state, train step and loop."""
