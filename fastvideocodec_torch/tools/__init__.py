"""Command-line tools of the port (``python -m fastvideocodec_torch.tools.<name>``)."""
