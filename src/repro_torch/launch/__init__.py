"""Single-request serving steps at world size 1 (``launch.serve``)."""
