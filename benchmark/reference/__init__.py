"""The plain references the benchmark judges the port against."""
