"""Plain references of the benchmark's configurations, one file each."""
