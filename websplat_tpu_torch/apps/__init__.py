"""Command-line entry points of the port: render, measure, video, viewer."""
