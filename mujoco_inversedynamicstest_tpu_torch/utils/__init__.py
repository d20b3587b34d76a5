"""Checkpoints, text dumps, and the walk over nested state they share."""
