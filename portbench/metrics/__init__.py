"""The benchmark's per-layer metrics, one reader a file, found by name."""
