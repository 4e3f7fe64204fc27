"""Protocol data for the port."""
