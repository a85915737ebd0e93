"""Launchers: the serve and train entry points, and the host mesh of ranks."""
