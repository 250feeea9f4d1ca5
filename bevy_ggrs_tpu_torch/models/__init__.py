"""Example models of the port."""
