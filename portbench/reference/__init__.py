"""The benchmark's plain references, found by a configuration's "reference"."""
