"""Token data pipelines of the port."""
