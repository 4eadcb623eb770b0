"""Workflows of the port run end to end through its command line."""
