"""Sensor models: the pinhole back-projection and the synthetic renderer."""
