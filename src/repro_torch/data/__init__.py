"""The port's synthetic LM data pipeline (numpy; the trainer moves batches
to the device)."""
