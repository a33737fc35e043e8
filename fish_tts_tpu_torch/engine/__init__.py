"""Decode engine: prefill, the per-frame kernel path and the generation loop."""
