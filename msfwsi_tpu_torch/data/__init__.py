"""On-device view construction."""
