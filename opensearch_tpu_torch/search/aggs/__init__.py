"""Aggregations: request parsing, compile and device eval, host reduce."""
