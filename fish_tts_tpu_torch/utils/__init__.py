"""Host utilities: quantization, checkpoints, audio."""
