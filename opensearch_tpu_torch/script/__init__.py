"""Score scripts (painless) for the port."""
