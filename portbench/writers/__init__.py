"""The benchmark's stream writers, found by a configuration's "writer"."""
