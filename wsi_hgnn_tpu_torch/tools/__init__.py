"""Command-line tools of the port (run as `python -m
wsi_hgnn_tpu_torch.tools.<name>`)."""
