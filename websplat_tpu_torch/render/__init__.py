"""The whole-frame renderer."""
