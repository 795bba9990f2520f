"""Storage helpers of the port: ``fs`` (local paths and fsspec URLs)
and ``checkpoint`` (the integrity manifests of directory checkpoints)."""
