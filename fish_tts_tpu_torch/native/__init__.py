"""Native (C++) text tokenization."""
