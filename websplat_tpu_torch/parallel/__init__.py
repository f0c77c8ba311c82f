"""Rendering several views on one device."""
