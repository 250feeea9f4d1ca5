"""Host-side observability sinks of the port."""
