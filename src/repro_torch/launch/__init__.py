"""Launchers: the static serve driver."""
