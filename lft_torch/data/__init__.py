"""Synthetic scenes for the smoke run and the tests."""
