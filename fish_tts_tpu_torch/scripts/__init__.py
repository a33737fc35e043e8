"""Command-line tools of the port, run as ``python -m fish_tts_tpu_torch.scripts.<name>``."""
