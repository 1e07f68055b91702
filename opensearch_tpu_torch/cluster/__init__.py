"""Cluster-level pieces the port needs: document routing."""
