"""Command-line entry points of the port (``python -m fastvideocodec_torch.cli.<name>``)."""
