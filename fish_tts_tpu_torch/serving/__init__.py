"""Serving front ends over the port's continuous-batching engine."""

from fish_tts_tpu_torch.serving.http import ServeDriver, make_server

__all__ = ["ServeDriver", "make_server"]
