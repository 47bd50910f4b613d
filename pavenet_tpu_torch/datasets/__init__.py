"""Host-side data pipeline of the port."""
