"""The port's networks and their blocks, channels-last."""
